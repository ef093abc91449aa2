"""PM-VDVAE training as ``train_pm_vdvae`` runs it between validations:
``Trainer.train_step`` on batches from ``ArrayDataset`` (the native row gather,
images as float32 in [0, 255]), the MNIST mask mixture in the step's prologue, the
encoders' runs through the block chain and, with ``fused_chain``, the decoder's
runs through the decoder chain; the clipped Adam chain, an EMA, and the step
skipped where the loss or a gradient is not finite. The window and the check are
``_train.run_training``'s."""
from __future__ import annotations

import numpy as np
import torch

from pmbench import weights
from pmbench.drivers._train import Setup, adam_steps, forever, run_training
from pmbench.harness import M32, sub_seed
from pmbench.masks import mask_fn
from pmbench.reference import pm_vdvae as ref
from pmbench.reference import precision
from pmbench.reference.dropout import derive_seed


def draw_weights(cfg, seed, dev):
    meta = ref.build(cfg, "meta")
    rules = ref.init_scales(cfg, meta)
    shapes = {n: (tuple(t.shape), *rules[n]) for n, t in meta.state_dict().items()}
    return weights.draw(shapes, sub_seed(seed, 1), dev)


def split(cfg, seed, dev) -> np.ndarray:
    gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, 2))
    return torch.randint(0, 256, (cfg["train_examples"], *cfg["data"]["image_shape"]),
                         dtype=torch.uint8, generator=gen, device=dev).cpu().numpy()


def setup(cell, seed, dev, stamp) -> Setup:
    """The trainer ``train_pm_vdvae`` builds, on the run's weights, fed from
    ``ArrayDataset`` over the seeded split."""
    from posterior_matching_torch.data.datasets import ArrayDataset, _make_batch_transform
    from posterior_matching_torch.masking import get_mask_generator
    from posterior_matching_torch.models.vdvae import PosteriorMatchingVDVAE
    from posterior_matching_torch.train.trainer import pm_vdvae_trainer

    cfg = cell.config
    stamp("start and imports")
    state = draw_weights(cfg, seed, dev)
    stamp("CUDA context and weights")
    with torch.device(dev):
        model = PosteriorMatchingVDVAE(**cfg["model"], fused_chain=cfg["fused_chain"])
    model.load_state_dict(state, strict=True)
    mask = get_mask_generator(cfg["data"]["mask_generator"], dev)
    trainer = pm_vdvae_trainer(model, cfg, seed=seed, mask_fn=mask, device=dev,
                               steps_per_call=cfg["steps_per_call"])
    trainer.init()
    stamp("model, masks and trainer")
    data = split(cfg, seed, dev)
    ds_seed = sub_seed(seed, 3) & M32
    # the CLI's transform (``load_datasets`` with ``normalize_images=False``):
    # pixels as float32 in [0, 255]
    transform = _make_batch_transform(cfg["data"]["dataset"], False)
    batches = forever(ArrayDataset({"image": data}, cfg["data"]["train_batch_size"],
                                   shuffle=True, seed=ds_seed, transform=transform))
    stamp("split")
    return Setup(trainer, batches, state, dict, (data, ds_seed))


def reference(cell, seed, data, steps, dev, tf32=False):
    """The reference's first ``steps`` steps on the same weights, rows, masks
    and normals (the loss's generator, drawn block by block in decoder order),
    the global-norm clip, Adam at the constant rate and the EMA; float32, or
    TF32 for the control."""
    cfg, (images, ds_seed) = cell.config, data
    bsz = cfg["data"]["train_batch_size"]
    model = ref.build(cfg, dev)
    model.load_state_dict(draw_weights(cfg, seed, dev))
    params = dict(model.named_parameters())
    order = np.arange(len(images))
    np.random.RandomState(ds_seed).shuffle(order)
    masks = mask_fn(cfg["data"]["mask_generator"], dev)

    def step_loss(step):
        rows = order[step * bsz:(step + 1) * bsz]
        x = torch.from_numpy(images[rows]).to(dev).float()
        gen = torch.Generator(device=dev).manual_seed(derive_seed(seed, step, 1))
        b = masks(gen, x.shape).reshape(*x.shape[:-1], 1)
        noise = torch.Generator(device=dev).manual_seed(derive_seed(seed, step, 0))
        return model.loss(x, b, noise)

    with precision(tf32):
        return adam_steps(params, list(params), step_loss, steps, lambda c: cfg["lr"],
                          clip=cfg["gradient_clip"], ema_rate=cfg["ema_rate"])


def run(cell, *, seed, seconds, trace, device, t_start, control=False):
    if cell.config.get("warm_up") or cell.config.get("weight_decay") \
            or cell.config.get("flat_optimizer"):
        raise ValueError("the reference's optimizer has no warm-up, weight decay or groups")
    return run_training(cell, seed=seed, seconds=seconds, trace=trace, device=device,
                        t_start=t_start, control=control, setup=setup, reference=reference)
