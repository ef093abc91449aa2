"""Flagship PM-VQVAE CelebA widths as plain dicts.

Copied from the JAX package's config files, which need ``ml_collections``:

- ``VQVAE_CELEB_A``: ``configs/vqvae_celeb_a.py:15-25`` (the ``model`` block);
- ``PM_VQVAE_CELEB_A``: ``configs/pm_vqvae_celeb_a.py:22-29`` (``pixel_cnn``
  and ``conditional_dim``), with ``num_indices`` 512 as written by the
  training script into
  ``artifacts/pm-vqvae-celeb_a-20260820-142531/config.json``.
"""

VQVAE_CELEB_A = {
    "embedding_dim": 64,
    "num_embeddings": 512,
    "hidden_units": 128,
    "residual_hidden_units": 32,
    "residual_blocks": 2,
    "decay": 0.99,
    "use_ema": True,
    "commitment_cost": 0.25,
    "output_channels": 3,
}

PM_VQVAE_CELEB_A = {
    "conditional_dim": 512,
    "pixel_cnn": {
        "image_shape": (16, 16),
        "num_resnet": 12,
        "num_hierarchies": 1,
        "num_filters": 128,
        "dropout": 0.5,
        "num_indices": 512,
    },
}

# CelebA images are cropped and resized to 64x64x3 (data/datasets.py).
CELEB_A_IMAGE_SHAPE = (64, 64, 3)

# Stage-2 training settings: ``configs/pm_vqvae_celeb_a.py:12-46`` (the
# ``data`` batch size and mask generator, ``steps``, ``validation_freq``,
# ``lr_schedule``; dropout is ``PM_VQVAE_CELEB_A["pixel_cnn"]["dropout"]``)
# and the optimizer of ``train_pm_vqvae.py:170-179``: Adam at optax's
# defaults (the config sets no ``adam``) under the exponential decay,
# everything under ``vqvae`` frozen.
PM_VQVAE_CELEB_A_TRAIN = {
    "train_batch_size": 32,
    "mask_generator": "CelebAMaskGenerator",
    "steps": 150000,
    "validation_freq": 2000,
    "lr_schedule": {
        "init_value": 3e-4,
        "decay_rate": 0.999995,
        "transition_steps": 1,
    },
    "frozen": ("vqvae",),
}
