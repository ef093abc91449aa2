"""Faults planted underneath the program's timed path, for the tests that must
see ``correct`` come out false: a training step that leaves its state
unchanged; a loss over half of the batch; a sampled code altered where it is
drawn."""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name, value):
    kept = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, kept)


def state_unchanged():
    from posterior_matching_torch.train import optim

    return _patched(optim.Adam, "step", lambda self, grads: None)


@contextlib.contextmanager
def half_batch():
    """Each training loss of the trainer module over the first half of the batch."""
    from posterior_matching_torch.train import trainer

    def halved(loss):
        def fn(model, batch, *args, **kwargs):
            half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            return loss(model, half, *args, **kwargs)
        return fn

    with _patched(trainer, "pm_vqvae_loss", halved(trainer.pm_vqvae_loss)), \
            _patched(trainer, "pm_vdvae_metrics", halved(trainer.pm_vdvae_metrics)):
        yield


def code_altered():
    from posterior_matching_torch.models import pm_vqvae

    sample = pm_vqvae.pixelcnn_sample

    def altered(pixel_cnn, *args, **kwargs):
        out = sample(pixel_cnn, *args, **kwargs)
        first = (0,) * out.dim()
        out[first] = (out[first] + 1) % pixel_cnn.num_indices
        return out

    return _patched(pm_vqvae, "pixelcnn_sample", altered)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "code_altered": code_altered}
# the faults each kind of traffic can have
FAULTS_OF = {"train": ("state_unchanged", "half_batch"), "impute": ("code_altered",)}


def planted(name: str):
    return FAULTS[name]() if name else contextlib.nullcontext()


