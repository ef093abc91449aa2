"""PM-VQVAE stage-2 training as ``train_pm_vqvae`` runs it between validations:
``Trainer.train_step`` on batches from ``ArrayDataset`` (the native gather and
rescale), the CelebA mask mixture in the step's prologue, the stream chain with
``packed_chain`` on the GPU, Adam under the exponential decay. The window and the
check are ``_train.run_training``'s."""
from __future__ import annotations

import numpy as np
import torch

from pmbench.drivers import _pm_vqvae as pmv
from pmbench.drivers._train import Setup, adam_steps, forever, run_training
from pmbench.harness import M32, sub_seed
from pmbench.masks import mask_fn
from pmbench.reference import pm_vqvae as ref
from pmbench.reference import precision
from pmbench.reference.dropout import derive_seed


def setup(cell, seed, dev, stamp) -> Setup:
    """The trainer ``train_pm_vqvae.main`` builds, on the run's weights, fed
    from ``ArrayDataset`` over the seeded split."""
    from posterior_matching_torch.data.datasets import ArrayDataset, _make_batch_transform
    from posterior_matching_torch.masking import get_mask_generator
    from posterior_matching_torch.models.pixelcnn import PackedChainCodec
    from posterior_matching_torch.train.trainer import pm_vqvae_trainer
    from posterior_matching_torch.train_pm_vqvae import use_packed_chain

    cfg = cell.config
    stamp("start and imports")
    state = pmv.draw_weights(cfg, seed, dev)
    stamp("CUDA context and weights")
    model = pmv.program_model(cfg, state, dev)
    mask = get_mask_generator(cfg["data"]["mask_generator"], dev)
    packed = use_packed_chain(cfg.get("packed_chain"), model, dev, cfg["chain_segment"])
    trainer = pm_vqvae_trainer(model, {"lr_schedule": cfg["lr_schedule"]}, seed=seed,
                               mask_fn=mask, device=dev, steps_per_call=cfg["steps_per_call"],
                               param_codec=PackedChainCodec if packed else None)
    trainer.init()
    codec = PackedChainCodec(model) if packed else None
    stamp("model, masks and trainer")

    def canonical(tensors):
        """The packed chain's stacks decoded to the model's names (the
        masked-out taps 0)."""
        if codec is None:
            return dict(tensors)
        head = f"{codec.prefix}.packed."
        out = {n: torch.zeros_like(p) for n, p in model.named_parameters()
               if n in codec.chain_names}
        codec.decode_into(tensors, out)
        return {**{n: t for n, t in tensors.items() if not n.startswith(head)}, **out}

    split = pmv.split(cfg, seed, cfg["train_examples"], 2, dev)
    ds_seed = sub_seed(seed, 3) & M32
    # the CLI's transform (``load_datasets`` with images rescaled to [0, 1]):
    # the native gather rescales the uint8 rows as it gathers them
    transform = _make_batch_transform(cfg["data"]["dataset"], True)
    batches = forever(ArrayDataset({"image": split}, cfg["data"]["train_batch_size"],
                                   shuffle=True, seed=ds_seed, transform=transform))
    initial = {n: t for n, t in state.items() if ref.trainable(n)}
    stamp("split")
    return Setup(trainer, batches, initial, canonical, (split, ds_seed))


def reference(cell, seed, data, steps, dev, tf32=False):
    """The reference's first ``steps`` steps on the same weights, rows (the
    dataset's shuffle), masks (the mixture from the step's prologue seed) and
    dropout masks, Adam under the exponential decay; float32, or TF32 for the
    control."""
    cfg, (split, ds_seed) = cell.config, data
    bsz = cfg["data"]["train_batch_size"]
    model = pmv.reference_model(cfg, seed, dev)
    params = dict(model.named_parameters())
    names = [n for n in params if ref.trainable(n)]
    for n, p in params.items():
        p.requires_grad_(n in names)
    order = np.arange(len(split))
    np.random.RandomState(ds_seed).shuffle(order)
    masks = mask_fn(cfg["data"]["mask_generator"], dev)
    sched = cfg["lr_schedule"]

    def step_loss(step):
        x = pmv.images(split, order[step * bsz:(step + 1) * bsz], dev)
        gen = torch.Generator(device=dev).manual_seed(derive_seed(seed, step, 1))
        b = masks(gen, x.shape).reshape(*x.shape[:-1], 1)
        return -model.log_prob(x, b, True, derive_seed(seed, step, 0)).mean()

    lr_at = lambda c: sched["init_value"] * sched["decay_rate"] ** (c / sched["transition_steps"])  # noqa: E731
    with precision(tf32):
        return adam_steps(params, names, step_loss, steps, lr_at)


def run(cell, *, seed, seconds, trace, device, t_start, control=False):
    return run_training(cell, seed=seed, seconds=seconds, trace=trace, device=device,
                        t_start=t_start, control=control, setup=setup, reference=reference)
