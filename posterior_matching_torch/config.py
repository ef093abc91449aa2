"""Model and training settings of the ported configurations, as plain dicts.

Copied from the JAX package's config files, which need ``ml_collections``:

- ``VQVAE_CELEB_A``: ``configs/vqvae_celeb_a.py:15-25`` (the ``model`` block);
- ``PM_VQVAE_CELEB_A``: ``configs/pm_vqvae_celeb_a.py:22-29`` (``pixel_cnn``
  and ``conditional_dim``), with ``num_indices`` 512 as written by the
  training script into
  ``artifacts/pm-vqvae-celeb_a-20260820-142531/config.json``;
- ``PM_VDVAE_MNIST``: ``configs/pm_vdvae_mnist.py:24-36`` (the ``model``
  block), ``PM_VDVAE_MNIST_TRAIN`` its training settings (:42-47),
  ``PM_VDVAE_MNIST_DATA`` its ``data`` block (:15-22), and
  :func:`pm_vdvae_mnist` the whole file, as the training CLI reads it;
- :func:`vqvae_mnist` and :func:`pm_vqvae_mnist`: ``configs/vqvae_mnist.py``
  and ``configs/pm_vqvae_mnist.py`` whole, the stage-1 and stage-2 training
  CLIs' configurations; :func:`vqvae_celeb_a`, :func:`pm_vqvae_celeb_a`,
  :func:`vqvae_digits16`, :func:`pm_vqvae_digits16` and
  :func:`pm_vdvae_digits16` the same of their config files;
- the eleven PM-VAE configurations, ``configs/pm_vae_*.py`` whole: the
  five UCI tables and the three real sklearn tables share
  ``configs/_base.py:32-110`` (:func:`_uci_pm_vae`), and the conv family
  (``pm_vae_mnist``, ``pm_vae_mnist16``, ``pm_vae_digits16``) is written
  out. Their ``model`` blocks keep the ``masked_posterior_*`` keys, which
  ``PosteriorMatchingVAE.from_config`` ignores, as the JAX package's does;
- the five VaDE configurations, ``configs/vade_{mnist,digits,digits16}.py``
  and ``configs/pm_vade_{mnist,digits}.py`` whole (the three VaDE ones set
  ``adam.eps`` 1e-4; ``vade_digits`` is the residual MLP with an
  ``IdentityGaussian`` likelihood), and the two lookahead ones,
  ``configs/lookahead_{mnist16,digits}.py`` whole (their ``model.
  num_features`` is set by the CLI from the data's shape).

Each whole-file configuration leaves ``seed`` None (a fresh draw unless
set) and ``compute_dtype`` None (the port computes in float32), and drops
the JAX execution options the port does not take (``steps_per_call``,
``device_resident_data``, ``packed_chain``).
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
}

# PM-VDVAE MNIST: ``configs/pm_vdvae_mnist.py:24-36``. ``compute_dtype`` is
# None there (a placeholder the CLI may set to bfloat16, which the port does
# not run).
PM_VDVAE_MNIST = {
    "image_shape": (28, 28, 1),
    "encoder_blocks": "28x6,28d2,14x4,14d2,7x2,7d2,3x2,3d2,1x2",
    "decoder_blocks": "1x2,3m1,3x2,7m3,7x2,14m7,14x4,28m14,28x6",
    "latent_dim": 16,
    "width": 192,
    "bottleneck_multiple": 0.25,
    "no_bias_above": 64,
    "num_mixtures": 10,
    "custom_width_string": None,
    "compute_dtype": None,
}

# Its training settings: ``configs/pm_vdvae_mnist.py:42-47``
# (``flat_optimizer``, ``ema_rate``, ``gradient_clip``, ``lr``, ``steps``,
# ``validation_freq``). ``train_pm_vdvae.py:161-186`` reads ``warm_up`` and
# ``weight_decay`` with the defaults 0 the config leaves them at, and Adam
# at optax's defaults. No ported config sets either to anything else: their
# other side (the linear warm-up, the decayed weights) is run only by the
# optax parity test.
PM_VDVAE_MNIST_TRAIN = {
    "flat_optimizer": False,
    "ema_rate": 0.999,
    "gradient_clip": 200.0,
    "lr": 0.00015,
    "warm_up": 0,
    "weight_decay": 0.0,
    "steps": 500000,
    "validation_freq": 5000,
}

# Its ``data`` block, ``configs/pm_vdvae_mnist.py:15-22``: the per-device
# batch sizes, the splits (validation on the test split) and the masks.
PM_VDVAE_MNIST_DATA = {
    "dataset": "mnist",
    "train_split": "train",
    "validation_split": "test",
    "train_batch_size": 16,
    "val_batch_size": 16,
    "mask_generator": "MNISTMaskGenerator",
}


def pm_vdvae_mnist() -> dict:
    """``configs/pm_vdvae_mnist.py`` whole, in its nesting (``data``,
    ``model``, then the training keys of :42-47), as a fresh dict that the
    CLI's ``--config.<path>`` flags may change. ``seed`` is None (a fresh
    draw unless set) and ``model.fused_chain`` None (the block chain in the
    encoders, the decoder unfused), the JAX defaults."""
    train = {k: v for k, v in PM_VDVAE_MNIST_TRAIN.items()
             if k not in ("warm_up", "weight_decay")}
    return {"data": dict(PM_VDVAE_MNIST_DATA),
            "model": dict(PM_VDVAE_MNIST, fused_chain=None),
            "seed": None, **train}


def vqvae_mnist() -> dict:
    """``configs/vqvae_mnist.py`` whole (:7-29), as a fresh dict; ``seed``
    None (a fresh draw unless set)."""
    return {
        "data": {"dataset": "mnist", "train_split": "train", "validation_split": "test",
                 "train_batch_size": 32, "val_batch_size": 32},
        "model": {"embedding_dim": 64, "num_embeddings": 256, "hidden_units": 32,
                  "residual_hidden_units": 32, "residual_blocks": 2, "decay": 0.99,
                  "use_ema": True, "commitment_cost": 0.25, "output_channels": 1},
        "steps": 60000,
        "validation_freq": 1000,
        "learning_rate": 3e-4,
        "seed": None,
    }


def pm_vqvae_mnist() -> dict:
    """``configs/pm_vqvae_mnist.py`` whole (:9-38), as a fresh dict: 7x7
    codes, 8 resnet levels of 128 filters; ``compute_dtype`` None (the port
    computes in float32), ``seed`` None. ``pixel_cnn.num_indices`` is set
    from the stage-1 run, as ``train_pm_vqvae.py:105`` does."""
    return {
        "data": {"dataset": "mnist", "train_split": "train", "validation_split": "test",
                 "train_batch_size": 32, "val_batch_size": 32,
                 "mask_generator": "MNISTMaskGenerator"},
        "vqvae_dir": "runs/vqvae-mnist",
        "pixel_cnn": {"image_shape": (7, 7), "num_resnet": 8, "num_hierarchies": 1,
                      "num_filters": 128, "dropout": 0.5},
        "conditional_dim": 512,
        "compute_dtype": None,
        "steps": 120000,
        "validation_freq": 1000,
        "lr_schedule": {"init_value": 3e-4, "decay_rate": 0.999995, "transition_steps": 1},
        "seed": None,
    }


def vqvae_celeb_a() -> dict:
    """``configs/vqvae_celeb_a.py`` whole (:7-29): the model block is
    :data:`VQVAE_CELEB_A`."""
    return {
        "data": {"dataset": "celeb_a", "train_split": "train",
                 "validation_split": "validation", "train_batch_size": 64,
                 "val_batch_size": 64},
        "model": dict(VQVAE_CELEB_A),
        "steps": 100000,
        "validation_freq": 1000,
        "learning_rate": 3e-4,
        "seed": None,
    }


def pm_vqvae_celeb_a() -> dict:
    """``configs/pm_vqvae_celeb_a.py`` whole (:10-47): 16x16 codes, 12
    resnet levels of 128 filters; ``pixel_cnn.num_indices`` is set from
    the stage-1 run."""
    t = PM_VQVAE_CELEB_A_TRAIN
    pixel_cnn = {k: v for k, v in PM_VQVAE_CELEB_A["pixel_cnn"].items()
                 if k != "num_indices"}
    return {
        "data": {"dataset": "celeb_a", "train_split": "train",
                 "validation_split": "validation",
                 "train_batch_size": t["train_batch_size"], "val_batch_size": 32,
                 "mask_generator": t["mask_generator"]},
        "vqvae_dir": "runs/vqvae-celeb_a",
        "pixel_cnn": pixel_cnn,
        "conditional_dim": PM_VQVAE_CELEB_A["conditional_dim"],
        "compute_dtype": None,
        "steps": t["steps"],
        "validation_freq": t["validation_freq"],
        "lr_schedule": dict(t["lr_schedule"]),
        "seed": None,
    }


def _digits16_data(batch_size: int, mask_generator: str = None) -> dict:
    """The digits16 ``data`` block: real sklearn digits at 16x16 from
    ``$PM_TPU_DATA_DIR/digits16/{train,val}.npz`` (no synthetic
    stand-in)."""
    data = {"dataset": "digits16", "train_split": "train", "validation_split": "val",
            "train_batch_size": batch_size, "val_batch_size": batch_size}
    if mask_generator is not None:
        data["mask_generator"] = mask_generator
    return data


def vqvae_digits16() -> dict:
    """``configs/vqvae_digits16.py`` whole (:11-35): a 4x4 code grid."""
    return {
        "data": _digits16_data(32),
        "model": {"embedding_dim": 64, "num_embeddings": 128, "hidden_units": 32,
                  "residual_hidden_units": 32, "residual_blocks": 2, "decay": 0.99,
                  "use_ema": True, "commitment_cost": 0.25, "output_channels": 1},
        "steps": 6000,
        "validation_freq": 1000,
        "learning_rate": 3e-4,
        "seed": None,
    }


def pm_vqvae_digits16() -> dict:
    """``configs/pm_vqvae_digits16.py`` whole (:15-47): 4x4 codes, 6 resnet
    levels of 64 filters, rectangle masks. The chain and sampler kernels
    are built for 128 filters, so this runs on the CPU only."""
    return {
        "data": _digits16_data(32, "RectangleMaskGenerator"),
        "vqvae_dir": "runs/vqvae-digits16",
        "pixel_cnn": {"image_shape": (4, 4), "num_resnet": 6, "num_hierarchies": 1,
                      "num_filters": 64, "dropout": 0.5},
        "conditional_dim": 256,
        "compute_dtype": None,
        "steps": 8000,
        "validation_freq": 1000,
        "lr_schedule": {"init_value": 3e-4, "decay_rate": 0.999995, "transition_steps": 1},
        "seed": None,
    }


def pm_vdvae_digits16() -> dict:
    """``configs/pm_vdvae_digits16.py`` whole (:15-59): the 16/8/4/1
    resolution ladder at width 64; ``model.fused_chain`` None, as
    :func:`pm_vdvae_mnist`."""
    return {
        "data": _digits16_data(16, "RectangleMaskGenerator"),
        "model": {"image_shape": (16, 16, 1),
                  "encoder_blocks": "16x3,16d2,8x3,8d2,4x2,4d4,1x2",
                  "decoder_blocks": "1x2,4m1,4x2,8m4,8x3,16m8,16x3",
                  "latent_dim": 8, "width": 64, "bottleneck_multiple": 0.25,
                  "no_bias_above": 32, "num_mixtures": 5, "custom_width_string": None,
                  "compute_dtype": None, "fused_chain": None},
        "seed": None,
        "flat_optimizer": False,
        "ema_rate": 0.999,
        "gradient_clip": 200.0,
        "lr": 0.0003,
        "steps": 6000,
        "validation_freq": 500,
    }


# ---------------------------------------------------------------------------
# PM-VAE
# ---------------------------------------------------------------------------

# The cyclic KL weight of the UCI configs unless one sets its own
# (``configs/_base.py:94-100``).
_CYCLIC_BETA = {"schedule": "cyclic", "low_value": 0.0, "high_value": 1.0, "period": 50000,
                "delay": 1000}


def _uci_pm_vae(dataset: str, event_size: int, latent_dim: int, *,
                train_batch_size: int = 512, encoder_blocks: int = 2,
                decoder_blocks: int = 2, layer_norm: bool = False, dropout: float = None,
                beta: dict = None, steps: int = 200000,
                lr_transition_steps: int = 5000) -> dict:
    """``configs/_base.py``'s ``uci_pm_vae_config`` (:32-110): residual MLPs
    of 256 units, a TriL posterior, the identity-scale Gaussian likelihood,
    Bernoulli(0.5) masks, training noise 0.001."""
    enc = {"residual_blocks": encoder_blocks, "hidden_units": 256, "layer_norm": layer_norm}
    dec = {"residual_blocks": decoder_blocks, "hidden_units": 256, "layer_norm": layer_norm}
    if dropout is not None:
        enc["dropout"] = dropout
        dec["dropout"] = dropout
    return {
        "data": {"dataset": dataset, "train_split": "train", "validation_split": "val",
                 "train_batch_size": train_batch_size, "val_batch_size": train_batch_size,
                 "training_noise": 0.001, "mask_generator": "BernoulliMaskGenerator"},
        "model": {"latent_dim": latent_dim, "encoder_net": "ResidualMLP",
                  "decoder_net": "ResidualMLP", "decoder_dist": "IdentityGaussian",
                  "posterior_dist": "TriLGaussian",
                  "decoder_dist_config": {"event_size": event_size},
                  "masked_posterior_dist": "AutoregressiveGMM",
                  "masked_posterior_config": {"hidden_units": 256, "residual_blocks": 3},
                  "encoder_net_config": enc, "decoder_net_config": dec,
                  "matching_ll_stop_gradients": True},
        "beta": dict(beta or _CYCLIC_BETA),
        "steps": steps,
        "validation_freq": 1000,
        "save_final_state": True,
        "weight_decay": 0.00001,
        "lr_schedule": {"init_value": 0.001, "decay_rate": 0.9,
                        "transition_steps": lr_transition_steps},
        "seed": None,
    }


def _cyclic(period: int, delay: int) -> dict:
    return dict(_CYCLIC_BETA, period=period, delay=delay)


def _conv_pm_vae(dataset: str, validation_split: str, batch: int, mask_generator: str,
                 model: dict, steps: int, validation_freq: int, transition_steps: int,
                 mask_kwargs: dict = None) -> dict:
    """The conv PM-VAE configs' shape: a conv encoder and decoder, a TriL
    posterior and the Bernoulli likelihood."""
    data = {"dataset": dataset, "train_split": "train", "validation_split": validation_split,
            "train_batch_size": batch, "val_batch_size": batch,
            "mask_generator": mask_generator}
    if mask_kwargs is not None:
        data["mask_generator_kwargs"] = mask_kwargs
    return {
        "data": data,
        "model": {"encoder_net": "ConvEncoder", "decoder_net": "ConvDecoder",
                  "posterior_dist": "TriLGaussian", "decoder_dist": "Bernoulli", **model},
        "steps": steps,
        "validation_freq": validation_freq,
        "lr_schedule": {"init_value": 0.001, "decay_rate": 0.9,
                        "transition_steps": transition_steps},
        "seed": None,
    }


def _pm_vae_16_model() -> dict:
    """``configs/pm_vae_mnist16.py`` and ``configs/pm_vae_digits16.py``'s
    model."""
    return {
        "latent_dim": 10,
        "encoder_net_config": {"conv_layers": [(32, 3, 1), (32, 3, 2), (64, 3, 2), (64, 1, 1)]},
        "decoder_net_config": {"conv_layers": [(64, 8, 1), (64, 5, 2), (32, 5, 1), (32, 5, 1),
                                               (1, 3, 1)]},
    }


def pm_vae_mnist() -> dict:
    """``configs/pm_vae_mnist.py`` whole: five convs to 1x1x128, six
    transposed convs back to 28x28x1, the autoregressive GMM partial
    posterior, MNIST masks."""
    return _conv_pm_vae("mnist", "test", 256, "MNISTMaskGenerator", {
        "latent_dim": 32,
        "partial_posterior_dist": "AutoregressiveGMM",
        "encoder_net_config": {"conv_layers": [(32, 5, 1), (32, 5, 2), (64, 5, 1), (64, 5, 2),
                                               (128, 7, 1)]},
        "decoder_net_config": {"conv_layers": [(64, 7, 1), (64, 5, 2), (32, 5, 1), (32, 5, 2),
                                               (32, 5, 1), (1, 5, 1)]},
    }, steps=80000, validation_freq=1000, transition_steps=5000)


def pm_vae_mnist16() -> dict:
    """``configs/pm_vae_mnist16.py`` whole: a 4x4x64 encoder output, uniform
    masks observing at most about a fifth of the pixels."""
    return _conv_pm_vae("mnist16", "test", 128, "UniformMaskGenerator",
                        _pm_vae_16_model(),
                        steps=200000, validation_freq=10000, transition_steps=5000,
                        mask_kwargs={"bounds": (0.0, 0.2)})


def pm_vae_digits16() -> dict:
    """``configs/pm_vae_digits16.py`` whole: ``pm_vae_mnist16``'s model on
    the real 16x16 digits (files only)."""
    return _conv_pm_vae("digits16", "val", 128, "UniformMaskGenerator",
                        _pm_vae_16_model(),
                        steps=8000, validation_freq=1000, transition_steps=1000,
                        mask_kwargs={"bounds": (0.0, 0.2)})


PM_VAE_CONFIGS = {
    "pm_vae_gas": lambda: _uci_pm_vae("gas", 8, 16),
    "pm_vae_power": lambda: _uci_pm_vae("power", 6, 16),
    "pm_vae_hepmass": lambda: _uci_pm_vae("hepmass", 21, 16),
    "pm_vae_miniboone": lambda: _uci_pm_vae(
        "miniboone", 43, 32, train_batch_size=1024, encoder_blocks=5, layer_norm=True,
        dropout=0.5, beta=_cyclic(5000, 2000), steps=22000, lr_transition_steps=1000),
    "pm_vae_bsds": lambda: _uci_pm_vae(
        "bsds", 63, 64, encoder_blocks=5, decoder_blocks=5, layer_norm=True,
        beta={"schedule": "monotonic", "low_value": 0.0, "high_value": 1.0,
              "transition_steps": 200000, "transition_begin": 30000}),
    "pm_vae_wine": lambda: _uci_pm_vae("wine", 13, 8, train_batch_size=64, steps=2000,
                                       beta=_cyclic(1000, 0)),
    "pm_vae_breast_cancer": lambda: _uci_pm_vae("breast_cancer", 30, 12, train_batch_size=128,
                                                steps=5000, beta=_cyclic(1500, 0)),
    "pm_vae_digits": lambda: _uci_pm_vae("digits_flat", 64, 16, train_batch_size=128,
                                         steps=6000, beta=_cyclic(2000, 0)),
    "pm_vae_mnist": pm_vae_mnist,
    "pm_vae_mnist16": pm_vae_mnist16,
    "pm_vae_digits16": pm_vae_digits16,
}


def _vade_data(dataset: str, validation_split: str, batch: int) -> dict:
    return {"dataset": dataset, "train_split": "train", "validation_split": validation_split,
            "train_batch_size": batch, "val_batch_size": batch}


def _lr(init_value: float, transition_steps: int) -> dict:
    return {"init_value": init_value, "decay_rate": 0.9, "staircase": False,
            "transition_steps": transition_steps}


# The MNIST VaDE's conv stacks (``configs/vade_mnist.py:19-37``) and the
# 16x16 digits' (``configs/vade_digits16.py:27-45``: a 4x4 last kernel).
_VADE_MNIST_CONVS = {
    "encoder_net_config": {"conv_layers": [(32, 5, 1), (32, 5, 2), (64, 5, 1), (64, 5, 2),
                                           (128, 7, 1)]},
    "decoder_net_config": {"conv_layers": [(64, 7, 1), (64, 5, 2), (32, 5, 1), (32, 5, 2),
                                           (32, 5, 1), (1, 5, 1)]},
}
_VADE_DIGITS_MLPS = {
    "encoder_net_config": {"residual_blocks": 2, "hidden_units": 256},
    "decoder_net_config": {"residual_blocks": 2, "hidden_units": 256},
    "decoder_dist_config": {"event_size": 64},
}
_AGMM_PARTIAL = {"partial_posterior_dist": "AutoregressiveGMM",
                 "partial_posterior_dist_config": {"num_components": 10, "residual_blocks": 2,
                                                   "hidden_units": 256}}


def _vade_model(encoder_net: str, decoder_net: str, decoder_dist: str, nets: dict) -> dict:
    return {"encoder_net": encoder_net, "decoder_net": decoder_net,
            "decoder_dist": decoder_dist, "latent_dim": 10, "num_components": 10,
            **{k: dict(v) for k, v in nets.items()}}


def _vade(data: dict, model: dict, pretrain_steps: int, steps: int, validation_freq: int,
          transition_steps: int) -> dict:
    return {"data": data, "model": model, "pretrain_steps": pretrain_steps, "steps": steps,
            "validation_freq": validation_freq, "cluster_pred_num_samples": 50,
            "pretrain_lr": 0.002, "lr_schedule": _lr(0.002, transition_steps),
            "adam": {"eps": 1e-4}, "seed": None}


def vade_mnist() -> dict:
    """``configs/vade_mnist.py`` whole: the conv VaDE with a Bernoulli
    likelihood, 150 epochs of pretraining and 300 of ELBO training."""
    return _vade(_vade_data("mnist", "test", 128),
                 _vade_model("ConvEncoder", "ConvDecoder", "Bernoulli", _VADE_MNIST_CONVS),
                 int(60000 / 128 * 150), int(60000 / 128 * 300), 1000, int(60000 / 128 * 10))


def vade_digits() -> dict:
    """``configs/vade_digits.py`` whole: residual MLPs and an
    ``IdentityGaussian`` likelihood on the flat real digits (files only)."""
    return _vade(_vade_data("digits_flat", "val", 128),
                 _vade_model("ResidualMLP", "ResidualMLP", "IdentityGaussian",
                             _VADE_DIGITS_MLPS), 3000, 6000, 1000, 200)


def vade_digits16() -> dict:
    """``configs/vade_digits16.py`` whole: the conv VaDE on the real 16x16
    digits (files only)."""
    convs = {"encoder_net_config": {"conv_layers": [(32, 5, 1), (32, 5, 2), (64, 5, 1),
                                                    (64, 5, 2), (128, 4, 1)]},
             "decoder_net_config": {"conv_layers": [(64, 4, 1), (64, 5, 2), (32, 5, 1),
                                                    (32, 5, 2), (32, 5, 1), (1, 5, 1)]}}
    return _vade(_vade_data("digits16", "val", 128),
                 _vade_model("ConvEncoder", "ConvDecoder", "Bernoulli", convs),
                 1700, 3400, 200, 110)


def pm_vade_mnist() -> dict:
    """``configs/pm_vade_mnist.py`` whole: the autoregressive GMM partial
    posterior on ``vade_mnist``'s model."""
    return {"data": _vade_data("mnist", "test", 128), "vade_dir": "runs/vade-mnist",
            "model": {**_vade_model("ConvEncoder", "ConvDecoder", "Bernoulli",
                                    _VADE_MNIST_CONVS), **_AGMM_PARTIAL},
            "steps": 160000, "validation_freq": 5000,
            "lr_schedule": _lr(0.001, int(60000 / 128 * 10)), "seed": None}


def pm_vade_digits() -> dict:
    """``configs/pm_vade_digits.py`` whole: ``vade_digits``'s model and the
    autoregressive GMM partial posterior (files only)."""
    return {"data": _vade_data("digits_flat", "val", 128),
            "vade_dir": "runs/vade-digits_flat",
            "model": {**_vade_model("ResidualMLP", "ResidualMLP", "IdentityGaussian",
                                    _VADE_DIGITS_MLPS), **_AGMM_PARTIAL},
            "steps": 8000, "validation_freq": 1000, "cluster_pred_num_samples": 50,
            "lr_schedule": _lr(0.001, 1000), "seed": None}


def _lookahead(dataset: str, validation_split: str, batch: int, pm_vae_dir: str,
               steps: int, validation_freq: int, transition_steps: int) -> dict:
    data = _vade_data(dataset, validation_split, batch)
    data.update(mask_generator="UniformMaskGenerator",
                mask_generator_kwargs={"bounds": (0.0, 0.20)})
    return {"data": data, "pm_vae_dir": pm_vae_dir,
            "model": {"lookahead_subsample": 16, "model_samples": 64},
            "steps": steps, "validation_freq": validation_freq,
            "lr_schedule": {"init_value": 0.001, "decay_rate": 0.9,
                            "transition_steps": transition_steps},
            "seed": None}


def lookahead_mnist16() -> dict:
    """``configs/lookahead_mnist16.py`` whole: 64 partial-posterior samples
    and 16 subsampled features a step, on a ``pm_vae_mnist16`` run."""
    return _lookahead("mnist16", "test", 32, "runs/pm-vae-mnist16", 40000, 5000, 5000)


def lookahead_digits() -> dict:
    """``configs/lookahead_digits.py`` whole: on a ``pm_vae_digits`` run
    (files only)."""
    return _lookahead("digits_flat", "val", 64, "runs/pm-vae-digits_flat", 6000, 1000, 1000)


VADE_CONFIGS = {"vade_mnist": vade_mnist, "vade_digits": vade_digits,
                "vade_digits16": vade_digits16}
PM_VADE_CONFIGS = {"pm_vade_mnist": pm_vade_mnist, "pm_vade_digits": pm_vade_digits}
LOOKAHEAD_CONFIGS = {"lookahead_mnist16": lookahead_mnist16,
                     "lookahead_digits": lookahead_digits}


# The configurations the training CLIs take by name.
CONFIGS = {"pm_vdvae_mnist": pm_vdvae_mnist, "vqvae_mnist": vqvae_mnist,
           "pm_vqvae_mnist": pm_vqvae_mnist, "vqvae_celeb_a": vqvae_celeb_a,
           "pm_vqvae_celeb_a": pm_vqvae_celeb_a, "vqvae_digits16": vqvae_digits16,
           "pm_vqvae_digits16": pm_vqvae_digits16, "pm_vdvae_digits16": pm_vdvae_digits16,
           **PM_VAE_CONFIGS, **VADE_CONFIGS, **PM_VADE_CONFIGS, **LOOKAHEAD_CONFIGS}
