"""The weights bridge between the JAX package's parameter trees and the
port's modules, both ways.

PM-VQVAE. A checkpoint of the JAX package holds two numpy trees: ``params``
(``vqvae``, ``partial_encoder``, ``pixel_cnn``) and ``state``, whose
``vq_ema`` collection holds the VQ codebook and its EMA statistics (the EMA
quantizer updates them in place, so they are not parameters there).
:func:`pm_vqvae_state_dict` maps both onto the port's ``state_dict`` names
and layouts and :func:`pm_vqvae_trees` maps them back, exactly;
:func:`load_pm_vqvae` reads a run directory; :func:`random_pm_vqvae_tree`
makes a tree of the same structure from a seed, standing in for a
checkpoint where none is at hand.

PM-VDVAE. Its ``params`` tree (``encoder``, ``masked_encoder``, ``decoder``
with ``block_i/{posterior,masked_posterior,prior,resnet}/c1..c4``,
``z_proj``, ``x_bias_<r>``, ``gain``, ``bias`` and ``out_net/params_conv``)
keeps flax's names and layouts in the port, so :func:`pm_vdvae_state_dict`
joins each tree path with dots and :func:`pm_vdvae_trees` splits them back;
:func:`load_pm_vdvae` reads a run directory, evaluating the EMA parameters
where the checkpoint has them, as the JAX eval scripts do;
:func:`random_pm_vdvae_tree` draws a tree from a seed.

PM-VAE. Its ``params`` tree (``encoder_net``, ``posterior_dist``,
``decoder_net``, ``decoder_dist``, ``partial_encoder_net``,
``partial_posterior_dist``, each with flax's ``Dense_<i>`` / ``Conv_<i>`` /
``ConvTranspose_<i>``, ``log_scale`` and ``ar_net_*`` leaves) keeps flax's
names and layouts in the port too: :func:`pm_vae_state_dict` and
:func:`pm_vae_trees` join and split the tree paths, :func:`load_pm_vae`
reads a run directory and :func:`init_pm_vae_tree` draws the JAX
package's initialisation from a seed.

VaDE and PM-VaDE. Their ``params`` trees hold the mixture prior's
``logits``, ``mu`` and ``log_scale`` at the top, beside the submodules,
with flax's names: :func:`vade_state_dict`, :func:`vade_trees`,
:func:`vade_from_jax`, :func:`load_vade` and :func:`init_vade_tree` as for
PM-VAE, for both classes (a tree with ``partial_encoder_net`` is a
PM-VaDE's).

The lookahead posterior. Its tree nests the PM-VAE's under ``pm_vae``,
beside ``lookahead_encoder_net`` and ``lookahead_block``:
:func:`lookahead_state_dict`, :func:`lookahead_trees`,
:func:`lookahead_from_jax`, :func:`load_lookahead` (``lookahead_config.
json``, ``pm_vae_config.json`` and ``train_state.pkl``) and
:func:`init_lookahead_tree`.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from posterior_matching_torch.models.lookahead import LookaheadPosterior
from posterior_matching_torch.models.pm_vqvae import PMVQVAE
from posterior_matching_torch.models.vade import VADE, PosteriorMatchingVADE
from posterior_matching_torch.models.vae import PosteriorMatchingVAE
from posterior_matching_torch.models.vdvae import PosteriorMatchingVDVAE
from posterior_matching_torch.models.vqvae import VQVAE
from posterior_matching_torch.runtime import resolve_device
from posterior_matching_torch.train.state import ForeignRecord, foreign_class, load_train_state

Tree = Dict[str, Any]


def _conv(kernel) -> np.ndarray:
    """flax HWIO -> torch ``[O, I, kh, kw]``."""
    return np.ascontiguousarray(np.asarray(kernel).transpose(3, 2, 0, 1))


def _conv_transpose(kernel) -> np.ndarray:
    """flax ``ConvTranspose`` HWIO (``transpose_kernel=False``: a correlation
    with the kernel as stored) -> ``conv_transpose2d``'s ``[I, O, kh, kw]``,
    which correlates with the kernel flipped in space."""
    k = np.asarray(kernel)[::-1, ::-1]
    return np.ascontiguousarray(k.transpose(2, 3, 0, 1))


def _put_conv(out, prefix, sub, transpose=False):
    out[f"{prefix}.weight"] = (_conv_transpose if transpose else _conv)(sub["kernel"])
    out[f"{prefix}.bias"] = np.asarray(sub["bias"])


def _put_stack(out, prefix, stack):
    i = 0
    while f"res3x3_{i}" in stack:
        _put_conv(out, f"{prefix}.res3x3.{i}", stack[f"res3x3_{i}"])
        _put_conv(out, f"{prefix}.res1x1.{i}", stack[f"res1x1_{i}"])
        i += 1


def _put_encoder(out, prefix, enc):
    for name in ("enc_1", "enc_2", "enc_3"):
        _put_conv(out, f"{prefix}.{name}", enc[name])
    _put_stack(out, f"{prefix}.stack", enc["ConvResidualStack_0"])


def vqvae_state_dict(params: Tree, vq_ema: Optional[Tree]) -> Dict[str, np.ndarray]:
    """A JAX ``VQVAE``'s ``params`` and ``vq_ema`` trees -> the port's
    ``VQVAE`` state dict. With ``use_ema=False`` the codebook is
    ``params["vq"]["embeddings"]`` and there is no ``vq_ema`` (None)."""
    out: Dict[str, np.ndarray] = {}
    _put_encoder(out, "encoder", params["encoder"])
    _put_conv(out, "pre_vq_conv", params["pre_vq_conv"])
    dec = params["decoder"]
    _put_conv(out, "decoder.dec_1", dec["dec_1"])
    _put_stack(out, "decoder.stack", dec["ConvResidualStack_0"])
    _put_conv(out, "decoder.dec_2", dec["dec_2"], transpose=True)
    _put_conv(out, "decoder.dec_3", dec["dec_3"], transpose=True)
    out["decoder.log_scale"] = np.asarray(dec["log_scale"])
    if "vq" in params:
        out["vq.embeddings"] = np.asarray(params["vq"]["embeddings"])
        return out
    for name in ("embeddings", "ema_cluster_size", "ema_dw"):
        out[f"vq.{name}"] = np.asarray(vq_ema["vq"][name])
    return out


def partial_encoder_state_dict(params: Tree) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    _put_encoder(out, "encoder", params["ConvResidualEncoder_0"])
    out["dense.kernel"] = np.asarray(params["Dense_0"]["kernel"])
    out["dense.bias"] = np.asarray(params["Dense_0"]["bias"])
    return out


def pixel_cnn_state_dict(params: Tree) -> Dict[str, np.ndarray]:
    """Flax names and layouts are kept (see ``models/pixelcnn.py``)."""
    out: Dict[str, np.ndarray] = {}
    for name, sub in params.items():
        if name == "embed":
            out["embed"] = np.asarray(sub["embedding"])
            continue
        # masked convs nest their params, the transposed ones under their own name
        sub = sub.get("Conv_0", sub.get("ConvTranspose_0", sub))
        out[f"layers.{name}.kernel"] = np.asarray(sub["kernel"])
        out[f"layers.{name}.bias"] = np.asarray(sub["bias"])
    return out


def pm_vqvae_state_dict(params: Tree, state: Tree) -> Dict[str, np.ndarray]:
    """JAX ``params`` / ``state`` trees -> the port's ``PMVQVAE`` state dict
    (numpy arrays). The codebook comes from ``state["vq_ema"]``, or from
    ``params`` where the VQ-VAE learns it by the loss (no ``vq_ema``)."""
    parts = {
        "vqvae": vqvae_state_dict(params["vqvae"], state.get("vq_ema", {}).get("vqvae")),
        "partial_encoder": partial_encoder_state_dict(params["partial_encoder"]),
        "pixel_cnn": pixel_cnn_state_dict(params["pixel_cnn"]),
    }
    return {f"{p}.{k}": v for p, sd in parts.items() for k, v in sd.items()}


# ---------------------------------------------------------------------------
# The port's state dict -> JAX trees
# ---------------------------------------------------------------------------

# PixelCNN layers that are masked convs, whose parameters flax nests under
# ``Conv_0`` (the hierarchies' transposed convs under ``ConvTranspose_0``).
_MASKED_CONVS = ("v_init", "h_init_up", "h_init_left", "down_sample_", "_conv_a", "_conv_b")


def pixel_cnn_tree(state_dict) -> Tree:
    """The port's ``PixelCNN`` state dict (tensors or arrays) -> the JAX
    module's ``params``, the inverse of :func:`pixel_cnn_state_dict`."""
    pc = _numpy(state_dict)
    pixel = {"embed": {"embedding": pc["embed"]}}
    for key in pc:
        if not key.startswith("layers.") or not key.endswith(".kernel"):
            continue
        name = key[len("layers."):-len(".kernel")]
        kb = {"kernel": pc[key], "bias": pc[f"layers.{name}.bias"]}
        if name.startswith("up_sample_"):
            kb = {"ConvTranspose_0": kb}
        elif name.startswith(_MASKED_CONVS[:4]) or name.endswith(_MASKED_CONVS[4:]):
            kb = {"Conv_0": kb}
        pixel[name] = kb
    return pixel


def _get_conv(sd, prefix, transpose=False) -> Tree:
    w = np.asarray(sd[f"{prefix}.weight"])
    # inverses of _conv_transpose and _conv
    kernel = w.transpose(2, 3, 0, 1)[::-1, ::-1] if transpose else w.transpose(2, 3, 1, 0)
    return {"kernel": np.ascontiguousarray(kernel),
            "bias": np.asarray(sd[f"{prefix}.bias"])}


def _get_stack(sd, prefix) -> Tree:
    out, i = {}, 0
    while f"{prefix}.res3x3.{i}.weight" in sd:
        out[f"res3x3_{i}"] = _get_conv(sd, f"{prefix}.res3x3.{i}")
        out[f"res1x1_{i}"] = _get_conv(sd, f"{prefix}.res1x1.{i}")
        i += 1
    return out


def _get_encoder(sd, prefix) -> Tree:
    out = {name: _get_conv(sd, f"{prefix}.{name}") for name in ("enc_1", "enc_2", "enc_3")}
    out["ConvResidualStack_0"] = _get_stack(sd, f"{prefix}.stack")
    return out


def _sub(sd, prefix: str) -> Dict[str, np.ndarray]:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def _numpy(state_dict) -> Dict[str, np.ndarray]:
    return {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
            for k, v in state_dict.items()}


def vqvae_trees(state_dict) -> Tuple[Tree, Tree]:
    """The port's ``VQVAE`` state dict (tensors or arrays) -> a JAX
    ``VQVAE``'s ``(params, {"vq_ema": ...})`` numpy trees, the inverse of
    :func:`vqvae_state_dict`; with ``use_ema=False`` (no EMA statistics)
    the codebook goes to ``params["vq"]`` and the state is ``{}``."""
    vq = _numpy(state_dict)
    decoder = {
        "dec_1": _get_conv(vq, "decoder.dec_1"),
        "ConvResidualStack_0": _get_stack(vq, "decoder.stack"),
        "dec_2": _get_conv(vq, "decoder.dec_2", transpose=True),
        "dec_3": _get_conv(vq, "decoder.dec_3", transpose=True),
        "log_scale": vq["decoder.log_scale"],
    }
    params = {
        "encoder": _get_encoder(vq, "encoder"),
        "pre_vq_conv": _get_conv(vq, "pre_vq_conv"),
        "decoder": decoder,
    }
    if "vq.ema_dw" not in vq:
        params["vq"] = {"embeddings": vq["vq.embeddings"]}
        return params, {}
    state = {"vq_ema": {"vq": {
        name: vq[f"vq.{name}"] for name in ("embeddings", "ema_cluster_size", "ema_dw")
    }}}
    return params, state


def pm_vqvae_trees(state_dict) -> Tuple[Tree, Tree]:
    """The port's ``PMVQVAE`` state dict (tensors or arrays) -> the JAX
    package's ``(params, state)`` numpy trees, the inverse of
    :func:`pm_vqvae_state_dict`."""
    sd = _numpy(state_dict)
    pe, pc = _sub(sd, "partial_encoder"), _sub(sd, "pixel_cnn")
    vq_params, vq_state = vqvae_trees(_sub(sd, "vqvae"))
    pixel = pixel_cnn_tree(pc)
    params = {
        "vqvae": vq_params,
        "partial_encoder": {
            "ConvResidualEncoder_0": _get_encoder(pe, "encoder"),
            "Dense_0": {"kernel": pe["dense.kernel"], "bias": pe["dense.bias"]},
        },
        "pixel_cnn": pixel,
    }
    if "vq_ema" not in vq_state:
        return params, {}
    return params, {"vq_ema": {"vqvae": vq_state["vq_ema"]}}


def to_torch(state_dict: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32))
        for k, v in state_dict.items()
    }


def vqvae_from_jax(params: Tree, state: Tree, config: Dict[str, Any],
                   device: Optional[str] = None) -> VQVAE:
    """Builds a ``VQVAE`` from a ``model_config.json`` dict on ``device``
    (the GPU unless ``"cpu"``) and loads a JAX ``VQVAE``'s ``params`` and
    ``{"vq_ema": ...}`` trees into it."""
    model = VQVAE(**config).to(resolve_device(device))
    model.load_state_dict(to_torch(vqvae_state_dict(params, state.get("vq_ema"))))
    return model


def pm_vqvae_from_jax(
    params: Tree,
    state: Tree,
    conditional_dim: int,
    vqvae_config: Dict[str, Any],
    pixel_cnn_config: Dict[str, Any],
    device: Optional[str] = None,
    chain_segment: Union[str, int] = "stream",
    compute_dtype: Optional[str] = None,
) -> PMVQVAE:
    """Builds a ``PMVQVAE`` on ``device`` (the GPU unless ``"cpu"``) with
    the PixelCNN chain's ``chain_segment`` and the run's ``compute_dtype``
    and loads JAX-layout weights into it; every parameter must be
    covered."""
    model = PMVQVAE.from_config(
        conditional_dim, vqvae_config, pixel_cnn_config, device=device,
        chain_segment=chain_segment, compute_dtype=compute_dtype,
    )
    model.load_state_dict(to_torch(pm_vqvae_state_dict(params, state)))
    return model


def load_pm_vqvae(run_dir: str, device: Optional[str] = None,
                  chain_segment: Union[str, int] = "stream") -> PMVQVAE:
    """Reads a PM-VQVAE run directory (``vqvae_config.json``,
    ``config.json``, ``train_state.pkl``) written by either package, at the
    run's ``compute_dtype`` (``config.json``'s key, as ``eval_pm_vqvae.py:
    80-82`` builds it); ``chain_segment`` is the caller's choice, not the
    run's."""
    resolve_device(device)
    with open(os.path.join(run_dir, "vqvae_config.json")) as fp:
        vqvae_config = json.load(fp)
    with open(os.path.join(run_dir, "config.json")) as fp:
        config = json.load(fp)
    ts = load_train_state(os.path.join(run_dir, "train_state.pkl"))
    return pm_vqvae_from_jax(
        ts.params, ts.state, config["conditional_dim"], vqvae_config,
        config["pixel_cnn"], device=device, chain_segment=chain_segment,
        compute_dtype=config.get("compute_dtype"),
    )


# ---------------------------------------------------------------------------
# A JAX-layout tree from a seed
# ---------------------------------------------------------------------------


def _trunc_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """Truncated normal in [-2, 2] times 1/sqrt(fan_in), the flax init the
    JAX package uses for its conv and dense kernels."""
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2
    fan_in = int(np.prod(shape[:-1]))
    return (x / np.sqrt(fan_in)).astype(np.float32)


def _kb(rng: np.random.Generator, *shape, std=None) -> Tree:
    """A kernel (truncated normal / sqrt(fan_in), or N(0, std^2)) and a zero
    bias."""
    k = (_trunc_normal(rng, shape) if std is None
         else (std * rng.standard_normal(shape)).astype(np.float32))
    return {"kernel": k, "bias": np.zeros(shape[-1], np.float32)}


def _conv_stack(rng, vq) -> Tree:
    hid, rh, out = vq["hidden_units"], vq["residual_hidden_units"], {}
    for i in range(vq["residual_blocks"]):
        out[f"res3x3_{i}"] = _kb(rng, 3, 3, hid, rh)
        out[f"res1x1_{i}"] = _kb(rng, 1, 1, rh, hid)
    return out


def _conv_encoder(rng, vq, cin: int) -> Tree:
    hid = vq["hidden_units"]
    return {
        "enc_1": _kb(rng, 4, 4, cin, hid // 2),
        "enc_2": _kb(rng, 4, 4, hid // 2, hid),
        "enc_3": _kb(rng, 3, 3, hid, hid),
        "ConvResidualStack_0": _conv_stack(rng, vq),
    }


def _vqvae_params(rng, vq) -> Tree:
    hid, cout, d = vq["hidden_units"], vq.get("output_channels", 3), vq["embedding_dim"]
    return {
        "encoder": _conv_encoder(rng, vq, cout),
        "pre_vq_conv": _kb(rng, 1, 1, hid, d),
        "decoder": {
            "dec_1": _kb(rng, 3, 3, d, hid),
            "ConvResidualStack_0": _conv_stack(rng, vq),
            "dec_2": _kb(rng, 4, 4, hid, hid // 2),
            "dec_3": _kb(rng, 4, 4, hid // 2, cout),
            "log_scale": np.zeros((), np.float32),
        },
    }


def _vq_ema(rng, vq) -> Tree:
    """The codebook (uniform with variance 1 / D) and zero EMA statistics."""
    k, d = vq["num_embeddings"], vq["embedding_dim"]
    lim = np.sqrt(3.0 / d)
    return {"vq": {
        "embeddings": rng.uniform(-lim, lim, (k, d)).astype(np.float32),
        "ema_cluster_size": np.zeros(k, np.float32),
        "ema_dw": np.zeros((k, d), np.float32),
    }}


def init_vqvae_tree(config: Dict[str, Any], seed: int) -> Tuple[Tree, Tree]:
    """A JAX ``VQVAE``'s initial ``(params, {"vq_ema": ...})``, equal in
    distribution to its ``init`` (its draws come from ``jax.random``):
    kernels truncated normal / sqrt(fan_in), biases and ``log_scale`` zero,
    the codebook uniform with variance 1 / D, the EMA statistics zero."""
    rng = np.random.default_rng(seed)
    params = _vqvae_params(rng, config)
    return _codebook(params, _vq_ema(rng, config), config)


def _codebook(params: Tree, vq_ema: Tree, config: Dict[str, Any]) -> Tuple[Tree, Tree]:
    """``(params, {"vq_ema": vq_ema})``, or with ``use_ema=False`` the
    codebook moved into ``params["vq"]`` and no state."""
    if config.get("use_ema", True):
        return params, {"vq_ema": vq_ema}
    return {**params, "vq": {"embeddings": vq_ema["vq"]["embeddings"]}}, {}


def random_pm_vqvae_tree(
    conditional_dim: int,
    vqvae_config: Dict[str, Any],
    pixel_cnn_config: Dict[str, Any],
    seed: int,
) -> Tuple[Tree, Tree]:
    """``(params, state)`` with the structure and shapes of the JAX
    package's ``PMVQVAE`` variables, drawn from ``seed`` with the same
    initialiser families (biases zero, conditional projections N(0, 1),
    codebook uniform with variance 1/D)."""
    rng = np.random.default_rng(seed)
    vq, pc = vqvae_config, pixel_cnn_config
    f, ni, n_res = pc["num_filters"], pc["num_indices"], pc["num_resnet"]
    n_hier = pc.get("num_hierarchies", 1)
    rows, cols = pc.get("receptive_field_dims", (3, 3))
    h, w = pc["image_shape"]
    pixel = {
        "embed": {"embedding": (rng.standard_normal((ni, f)) / np.sqrt(f)).astype(np.float32)},
        "v_init": {"Conv_0": _kb(rng, 2 * rows - 1, cols, f, f)},
        "h_init_up": {"Conv_0": _kb(rng, 3, cols, f, f)},
        "h_init_left": {"Conv_0": _kb(rng, 3, cols, f, f)},
        "logits_conv": _kb(rng, 1, 1, f, ni),
    }
    ksize = {"vertical": (2 * rows - 3, cols), "horizontal": (3, cols)}
    aux_in = {("up", "horizontal"): f, ("dn", "vertical"): f, ("dn", "horizontal"): 2 * f}
    for dname in ("up", "dn"):
        for i in range(n_hier):
            for r in range(n_res + (dname == "dn" and i > 0)):
                for st in ("vertical", "horizontal"):
                    tag = f"{dname}_{i}_{r}_{st}"
                    pixel[f"{tag}_conv_a"] = {"Conv_0": _kb(rng, *ksize[st], 2 * f, f)}
                    pixel[f"{tag}_conv_b"] = {"Conv_0": _kb(rng, *ksize[st], 2 * f, 2 * f)}
                    pixel[f"{tag}_cond_proj"] = _kb(rng, conditional_dim, 2 * f, std=1.0)
                    if (dname, st) in aux_in:
                        pixel[f"{tag}_aux"] = _kb(rng, 2 * aux_in[(dname, st)], f)
    # the hierarchies' resampling convs (pixelcnn.py:630-663)
    valid = {"vertical": (rows - 1, cols), "horizontal": (2, cols // 2 + 1)}
    for i in range(n_hier - 1):
        for st in ("vertical", "horizontal"):
            h_, w_ = valid[st]
            down = (2 * h_, w_ + 1) if st == "vertical" else (2 * h_, 2 * w_)
            up = (2 * h_ - 2, w_ + 1) if st == "vertical" else (2 * h_ - 2, 2 * w_ - 2)
            pixel[f"down_sample_{i}_{st}"] = {"Conv_0": _kb(rng, *down, f, f)}
            pixel[f"up_sample_{i}_{st}"] = {"ConvTranspose_0": _kb(rng, *up, f, f)}
    params = {
        "vqvae": _vqvae_params(rng, vq),
        "partial_encoder": {
            "ConvResidualEncoder_0": _conv_encoder(rng, vq, vq.get("output_channels", 3) + 1),
            "Dense_0": _kb(rng, h * w * vq["hidden_units"], conditional_dim),
        },
        "pixel_cnn": pixel,
    }
    params["vqvae"], vq_state = _codebook(params["vqvae"], _vq_ema(rng, vq), vq)
    return params, ({"vq_ema": {"vqvae": vq_state["vq_ema"]}} if vq_state else {})


# ---------------------------------------------------------------------------
# PM-VDVAE
# ---------------------------------------------------------------------------


def _flat_state_dict(params: Tree) -> Dict[str, np.ndarray]:
    """Each leaf of a tree under its path joined by dots."""
    out: Dict[str, np.ndarray] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        else:
            out[prefix] = np.asarray(node)

    walk("", params)
    return out


def _tree(state_dict) -> Tree:
    """A state dict (tensors or arrays) -> the tree whose paths its names
    join, the inverse of :func:`_flat_state_dict`."""
    tree: Tree = {}
    for name, v in state_dict.items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
    return tree


def pm_vdvae_state_dict(params: Tree) -> Dict[str, np.ndarray]:
    """A JAX ``PosteriorMatchingVDVAE`` ``params`` tree -> the port's state
    dict: each leaf under its tree path joined by dots."""
    return _flat_state_dict(params)


def pm_vdvae_trees(state_dict) -> Tree:
    """The port's state dict (tensors or arrays) -> the JAX ``params`` tree,
    the inverse of :func:`pm_vdvae_state_dict`."""
    return _tree(state_dict)


def pm_vdvae_from_jax(params: Tree, config: Dict[str, Any],
                      device: Optional[str] = None) -> PosteriorMatchingVDVAE:
    """Builds a ``PosteriorMatchingVDVAE`` from a ``model_config.json`` dict
    on ``device`` (the GPU unless ``"cpu"``) and loads JAX-layout weights;
    every parameter must be covered."""
    model = PosteriorMatchingVDVAE.from_config(config, device=device)
    model.load_state_dict(to_torch(pm_vdvae_state_dict(params)))
    return model


def load_pm_vdvae(run_dir: str, device: Optional[str] = None,
                  fused_chain: Optional[bool] = None) -> PosteriorMatchingVDVAE:
    """Reads a PM-VDVAE run directory (``model_config.json``,
    ``train_state.pkl``) written by either package, with ``ema_params`` when
    the checkpoint has them (``eval_pm_vdvae_imputation.py:78-83``).
    ``fused_chain`` is the caller's execution option; a run's file does not
    hold it."""
    resolve_device(device)
    with open(os.path.join(run_dir, "model_config.json")) as fp:
        config = json.load(fp)
    if fused_chain is not None:
        config["fused_chain"] = fused_chain
    ts = load_train_state(os.path.join(run_dir, "train_state.pkl"))
    params = ts.ema_params if ts.ema_params is not None else ts.params
    return pm_vdvae_from_jax(params, config, device=device)


def random_pm_vdvae_tree(config: Dict[str, Any], seed: int) -> Tree:
    """A ``params`` tree with the structure and shapes of the JAX package's
    ``PosteriorMatchingVDVAE``, drawn from ``seed`` with no zero anywhere:
    kernels truncated normal / sqrt(fan_in), the encoders' and resnets'
    last convs and ``z_proj`` times sqrt(1 / blocks) as the JAX init scales
    them, the heads' last convs times 0.3 (the prior's is zero at the JAX
    init, which would leave its path untested), biases and the bias inputs
    N(0, 0.02^2), the gain 1 + N(0, 0.02^2)."""
    return _pm_vdvae_tree(config, seed, jax_init=False)


def init_pm_vdvae_tree(config: Dict[str, Any], seed: int) -> Tree:
    """The JAX package's initial ``params`` of ``PosteriorMatchingVDVAE``,
    equal in distribution (its draws come from ``jax.random``): kernels
    truncated normal / sqrt(fan_in), the encoders' and resnets' last convs
    and ``z_proj`` times sqrt(1 / blocks) (``vdvae.py:255, 411-418``), the
    prior's last conv zero (``zero_last``, :403-406), every bias and bias
    input zero, the gain one."""
    return _pm_vdvae_tree(config, seed, jax_init=True)


def _pm_vdvae_tree(config: Dict[str, Any], seed: int, jax_init: bool) -> Tree:
    rng = np.random.default_rng(seed)
    model = PosteriorMatchingVDVAE.from_config(config, device="cpu")
    enc_scale = np.sqrt(1.0 / len(model.encoder.specs))
    dec_scale = np.sqrt(1.0 / model.decoder.n_blocks)
    out: Dict[str, np.ndarray] = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        parts = name.split(".")
        if jax_init:
            small = lambda: np.zeros(shape, np.float32)
        else:
            small = lambda: (0.02 * rng.standard_normal(shape)).astype(np.float32)
        if parts[-1] == "kernel":
            k = _trunc_normal(rng, shape)
            if parts[-2] == "c4" and "encoder" in parts[0]:
                k *= enc_scale
            elif (parts[-2] == "c4" and parts[-3] == "resnet") or parts[-2] == "z_proj":
                k *= dec_scale
            elif parts[-2] == "c4" and parts[-3] == "prior" and jax_init:
                k *= 0.0
            elif parts[-2] == "c4" and not jax_init:
                k *= 0.3
            out[name] = k.astype(np.float32)
        elif parts[-1] == "gain":
            out[name] = (1.0 + small()).astype(np.float32)
        else:
            out[name] = small()
    return pm_vdvae_trees(out)


# ---------------------------------------------------------------------------
# PM-VAE
# ---------------------------------------------------------------------------


def pm_vae_state_dict(params: Tree) -> Dict[str, np.ndarray]:
    """A JAX ``PosteriorMatchingVAE`` ``params`` tree -> the port's state
    dict: each leaf under its tree path joined by dots."""
    return _flat_state_dict(params)


def pm_vae_trees(state_dict) -> Tree:
    """The port's state dict (tensors or arrays) -> the JAX ``params`` tree,
    the inverse of :func:`pm_vae_state_dict`."""
    return _tree(state_dict)


def pm_vae_from_jax(params: Tree, config: Dict[str, Any],
                    device: Optional[str] = None) -> PosteriorMatchingVAE:
    """Builds a ``PosteriorMatchingVAE`` from a ``model_config.json`` dict on
    ``device`` (the GPU unless ``"cpu"``) and loads JAX-layout weights;
    every parameter must be covered."""
    model = PosteriorMatchingVAE.from_config(config, device=device)
    model.load_state_dict(to_torch(pm_vae_state_dict(params)))
    return model


def load_pm_vae(run_dir: str, device: Optional[str] = None) -> PosteriorMatchingVAE:
    """Reads a PM-VAE run directory (``model_config.json``,
    ``train_state.pkl``) written by either package; its ``params``, as
    ``eval_pm_vae_uci.py`` evaluates them."""
    resolve_device(device)
    with open(os.path.join(run_dir, "model_config.json")) as fp:
        config = json.load(fp)
    ts = load_train_state(os.path.join(run_dir, "train_state.pkl"))
    return pm_vae_from_jax(ts.params, config, device=device)


def init_pm_vae_tree(config: Dict[str, Any], seed: int) -> Tree:
    """The JAX package's initial ``params`` of ``PosteriorMatchingVAE``,
    equal in distribution (its draws come from ``jax.random``): every Dense
    and conv kernel and the autoregressive GMM's ``ar_net_*_w`` truncated
    normal / sqrt(fan_in), every bias and ``log_scale`` zero."""
    return _init_tree(PosteriorMatchingVAE.from_config(config, device="cpu"), seed)


def _init_tree(model: torch.nn.Module, seed: int, normal=()) -> Tree:
    """The flax initialisation of ``model``'s parameters as a JAX ``params``
    tree, drawn from ``seed``: every Dense and conv kernel and
    ``ar_net_*_w`` truncated normal / sqrt(fan_in), the names in ``normal``
    N(0, 1), every other leaf (biases, ``log_scale`` of a head, the mixture
    ``logits``) zero."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name in normal:
            out[name] = rng.standard_normal(shape).astype(np.float32)
        elif name.endswith(".kernel") or name.endswith("_w"):
            out[name] = _trunc_normal(rng, shape)
        else:
            out[name] = np.zeros(shape, np.float32)
    return _tree(out)


# ---------------------------------------------------------------------------
# VaDE and PM-VaDE
# ---------------------------------------------------------------------------


def vade_state_dict(params: Tree) -> Dict[str, np.ndarray]:
    """A JAX ``VADE`` / ``PosteriorMatchingVADE`` ``params`` tree -> the
    port's state dict: each leaf under its tree path joined by dots."""
    return _flat_state_dict(params)


def vade_trees(state_dict) -> Tree:
    """The port's state dict (tensors or arrays) -> the JAX ``params`` tree,
    the inverse of :func:`vade_state_dict`."""
    return _tree(state_dict)


def _vade_class(partial: bool):
    return PosteriorMatchingVADE if partial else VADE


def vade_from_jax(params: Tree, config: Dict[str, Any],
                  device: Optional[str] = None) -> VADE:
    """Builds a ``PosteriorMatchingVADE`` when ``params`` holds a
    ``partial_encoder_net``, else a ``VADE``, from a ``model_config.json``
    dict on ``device`` (the GPU unless ``"cpu"``), and loads JAX-layout
    weights; every parameter must be covered."""
    model = _vade_class("partial_encoder_net" in params).from_config(config, device=device)
    model.load_state_dict(to_torch(vade_state_dict(params)))
    return model


def load_vade(run_dir: str, device: Optional[str] = None) -> VADE:
    """Reads a VaDE or PM-VaDE run directory (``model_config.json``,
    ``train_state.pkl``) written by either package."""
    resolve_device(device)
    with open(os.path.join(run_dir, "model_config.json")) as fp:
        config = json.load(fp)
    ts = load_train_state(os.path.join(run_dir, "train_state.pkl"))
    return vade_from_jax(ts.params, config, device=device)


def init_vade_tree(config: Dict[str, Any], seed: int, partial: bool = False) -> Tree:
    """The JAX package's initial ``params`` of ``VADE`` (``partial``:
    ``PosteriorMatchingVADE``), equal in distribution: ``logits`` zero,
    ``mu`` and ``log_scale`` N(0, 1) (``vade.py:59-70``), the networks and
    heads as :func:`init_pm_vae_tree` draws them."""
    model = _vade_class(partial).from_config(config, device="cpu")
    return _init_tree(model, seed, normal=("mu", "log_scale"))


# ---------------------------------------------------------------------------
# The lookahead posterior
# ---------------------------------------------------------------------------


def lookahead_state_dict(params: Tree) -> Dict[str, np.ndarray]:
    """A JAX ``LookaheadPosterior`` ``params`` tree -> the port's state
    dict (the PM-VAE's names under ``pm_vae.``)."""
    return _flat_state_dict(params)


def lookahead_trees(state_dict) -> Tree:
    """The inverse of :func:`lookahead_state_dict`."""
    return _tree(state_dict)


def lookahead_from_jax(params: Tree, config: Dict[str, Any], pm_vae_config: Dict[str, Any],
                       device: Optional[str] = None) -> LookaheadPosterior:
    """Builds a ``LookaheadPosterior`` from its ``lookahead_config.json``
    and ``pm_vae_config.json`` dicts on ``device`` (the GPU unless
    ``"cpu"``) and loads JAX-layout weights; every parameter must be
    covered."""
    model = LookaheadPosterior.from_config(config, pm_vae_config, device=device)
    model.load_state_dict(to_torch(lookahead_state_dict(params)))
    return model


def load_lookahead(run_dir: str, device: Optional[str] = None) -> LookaheadPosterior:
    """Reads a lookahead run directory (``lookahead_config.json``,
    ``pm_vae_config.json``, ``train_state.pkl``) written by either package
    (``eval_greedy_acquisition.py:78-85``)."""
    resolve_device(device)
    configs = []
    for name in ("lookahead_config.json", "pm_vae_config.json"):
        with open(os.path.join(run_dir, name)) as fp:
            configs.append(json.load(fp))
    ts = load_train_state(os.path.join(run_dir, "train_state.pkl"))
    return lookahead_from_jax(ts.params, *configs, device=device)


def init_lookahead_tree(config: Dict[str, Any], pm_vae_config: Dict[str, Any],
                        seed: int) -> Tree:
    """The JAX package's initial ``params`` of ``LookaheadPosterior``, equal
    in distribution: kernels truncated normal / sqrt(fan_in), the rest
    zero, the ``pm_vae`` subtree included."""
    model = LookaheadPosterior.from_config(config, pm_vae_config, device="cpu")
    return _init_tree(model, seed)


# ---------------------------------------------------------------------------
# Optimizer state in optax's layout
# ---------------------------------------------------------------------------

# Where optax 0.2.6 defines the states that the JAX CLIs' chains init to:
# the class paths a checkpoint names them by.
_OPTAX_CLASSES = {
    "ScaleByAdamState": "optax._src.transform",
    "ScaleByScheduleState": "optax._src.transform",
    "EmptyState": "optax._src.base",
    "MaskedState": "optax.transforms._masking",
    "MaskedNode": "optax.transforms._masking",
    "PartitionState": "optax.transforms._combining",
}


# Each state's fields in order: a record read from a checkpoint holds their
# values (``ForeignRecord.args``), and Orbax restores a state as a dict of
# them.
_OPTAX_FIELDS = {
    "ScaleByAdamState": ("count", "mu", "nu"),
    "ScaleByScheduleState": ("count",),
    "EmptyState": (),
    "MaskedState": ("inner_state",),
    "MaskedNode": (),
    "PartitionState": ("inner_states",),
}


def _optax(name: str, *args) -> ForeignRecord:
    return foreign_class(_OPTAX_CLASSES[name], name)(*args)


def orbax_tree(tree: Any) -> Any:
    """``tree`` as Orbax restores a saved tree without a target (the JAX
    package's ``OrbaxCheckpointCallback.restore_latest``,
    ``posterior_matching_tpu/train/callbacks.py:98-103``): each optax state
    a dict of its fields, one with no fields (``EmptyState``,
    ``MaskedNode``) None, tuples and lists lists, tensors and numpy scalars
    numpy arrays; dicts, None and Python scalars as they are. Raises
    ``ValueError`` for a record of any other class."""
    if isinstance(tree, ForeignRecord):
        name = type(tree).__name__
        if name not in _OPTAX_FIELDS or not _is_optax(tree, name) or hasattr(tree, "state"):
            raise ValueError(f"no Orbax form for a {tree.module}.{name} record")
        fields = _OPTAX_FIELDS[name]
        if len(tree.args) != len(fields):
            raise ValueError(f"a {name} record holds {len(tree.args)} values, not {fields}")
        return {f: orbax_tree(v) for f, v in zip(fields, tree.args)} if fields else None
    if isinstance(tree, dict):
        return {k: orbax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [orbax_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, (np.ndarray, np.generic)):
        return np.asarray(tree)
    return tree


_EMPTY = lambda count, mu, nu: _optax("EmptyState")
# The state each transform of a chain inits to, by the name of its optax
# function (``train/optim.py``'s ``chain``), from the count and moments:
# ``add_decayed_weights`` is always given a mask by the JAX CLIs.
_STATES = {
    "scale_by_adam": lambda count, mu, nu: _optax("ScaleByAdamState", count, mu, nu),
    "scale_by_schedule": lambda count, mu, nu: _optax("ScaleByScheduleState", count.copy()),
    "add_decayed_weights": lambda count, mu, nu: _optax("MaskedState", _optax("EmptyState")),
    "clip_by_global_norm": _EMPTY, "scale": _EMPTY, "scale_by_learning_rate": _EMPTY,
}


def _is_optax(node, name: str) -> bool:
    return isinstance(node, ForeignRecord) and type(node) is foreign_class(
        _OPTAX_CLASSES[name], name)


def _map_with_path(fn, tree: Tree, path=()) -> Tree:
    """``fn(path, leaf)`` on each leaf of a tree of dicts."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, (*path, k)) for k, v in tree.items()}
    return fn(path, tree)


def _labels(params: Tree, trainable: Callable[[str, str], bool]) -> Tree:
    """Whether each leaf trains, as the JAX trainer labels a tree
    (``trainer.py:193-205``): ``trainable(module path, leaf name)``, the
    module path the leaf's parents joined by ``/``."""
    return _map_with_path(lambda path, _: bool(trainable("/".join(path[:-1]), path[-1])),
                          params)


def _paths(tree: Tree, path=()) -> Dict[str, Any]:
    """The leaves of a tree of dicts by their paths joined with dots."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _paths(sub, (*path, key)).items()}
    return {".".join(path): tree}


def _group_plan(tree: Tree):
    """``group_by_shape``'s plan of a tree (``optim.shape_groups``)."""
    from posterior_matching_torch.train.optim import shape_groups

    return shape_groups({k: np.shape(v) for k, v in _paths(tree).items()})


def optax_opt_state(chain: Sequence[str], count: int, mu: Tree, nu: Tree,
                    trainable: Optional[Callable[[str, str], bool]] = None,
                    grouped: bool = False):
    """The state that the optax chain ``chain`` (its transforms' names, in
    order) holds after ``count`` updates with moments ``mu`` and ``nu``
    (JAX-layout trees of every parameter; the frozen ones' are dropped), as
    records written under optax's class paths: a tuple of each transform's
    state and, with a ``trainable`` predicate, inside
    ``optax.multi_transform({"trainable": chain, "frozen": set_to_zero()})``
    as the JAX trainer wraps it (``trainer.py:185-209``): a
    ``PartitionState`` of two ``MaskedState``s, ``MaskedNode`` leaves where
    a parameter is frozen. A plain ``pickle.load`` rebuilds optax's own
    states from it. With ``grouped`` the chain runs under ``group_by_shape``
    (``flat_optimizer``, ``posterior_matching_tpu/train/optim.py:71-74``):
    ``(chain's state,)``, every moment a list of the shape groups' stacks."""
    if grouped:
        if trainable is not None:
            raise ValueError("flat_optimizer's layout freezes no parameter")
        plan = _group_plan(mu)
        stack = lambda tree: [np.stack([np.asarray(_paths(tree)[k], np.float32) for k in names])
                              for _, names in plan]
        count = np.asarray(count, np.int32)
        return (tuple(_STATES[t](count, stack(mu), stack(nu)) for t in chain),)
    labels = _labels(mu, trainable or (lambda module, name: True))
    moment = lambda path, v: (np.asarray(v, np.float32) if _leaf(labels, path)
                              else _optax("MaskedNode"))
    mu, nu = (_map_with_path(moment, tree) for tree in (mu, nu))
    count = np.asarray(count, np.int32)
    state = tuple(_STATES[t](count, mu, nu) for t in chain)
    if trainable is None:
        return state
    return _optax("PartitionState", {"frozen": _optax("MaskedState", _optax("EmptyState")),
                                     "trainable": _optax("MaskedState", state)})


def _leaf(tree: Tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _records(node, name: str) -> list:
    """Every optax ``name`` record in a state read from a checkpoint."""
    if _is_optax(node, name):
        return [node]
    if isinstance(node, ForeignRecord):
        node = node.args
    if isinstance(node, dict):
        node = list(node.values())
    if isinstance(node, (list, tuple)):
        return [r for v in node for r in _records(v, name)]
    return []


def optax_moments(opt_state, params: Tree,
                  trainable: Optional[Callable[[str, str], bool]] = None,
                  grouped: bool = False) -> Tuple[int, Tree, Tree]:
    """The update count and the ``mu`` / ``nu`` trees (the structure of the
    canonical ``params``; a frozen parameter's moments zero) of an optax
    chain's state as :func:`~posterior_matching_torch.train.state.
    load_train_state` reads it, written by either package. A state in
    ``PackedChainCodec``'s layout (``packed_chain``, the JAX package's
    default on a TPU) is unpacked to the PixelCNN's levels; with
    ``grouped`` the state is in ``flat_optimizer``'s layout
    (``group_by_shape``: moments stacked by shape group, read back by the
    plan of ``params``). Raises ``ValueError``, naming what is wrong, for
    any other layout: no Adam state, the grouped layout where ``grouped``
    is not set or the other one where it is, frozen parameters other than
    ``trainable``'s, or leaves that differ from ``params``."""
    if isinstance(opt_state, dict) and set(opt_state) == {"count", "mu", "nu"}:
        raise ValueError("the optimizer state is a {count, mu, nu} dict keyed by the port's "
                         "parameter names, which the port wrote before it wrote optax's "
                         "layout: such a checkpoint cannot be resumed")
    adam = _records(opt_state, "ScaleByAdamState")
    if len(adam) != 1:
        raise ValueError(f"the optimizer state holds {len(adam)} scale_by_adam states, not one: "
                         f"{opt_state!r:.300}")
    count, mu, nu = adam[0].args
    if isinstance(mu, dict) == grouped:
        raise ValueError(
            "the optimizer state is in flat_optimizer's layout (group_by_shape: moments "
            "stacked by leaf shape), and this trainer's optimizer is not: only the PM-VDVAE "
            "trainer takes flat_optimizer (ROADMAP.md A7)" if not isinstance(mu, dict) else
            "this trainer's optimizer runs under flat_optimizer (group_by_shape), and the "
            "optimizer state is not in its layout")
    if grouped:
        mu, nu = (_ungroup(m, params) for m in (mu, nu))
    count = int(np.asarray(count))
    others = {int(np.asarray(r.args[0])) for r in _records(opt_state, "ScaleByScheduleState")}
    if others - {count}:
        raise ValueError(f"the optimizer's counts disagree: adam {count}, schedule {others}")
    if trainable is None and _records(opt_state, "PartitionState"):
        raise ValueError("the optimizer state freezes parameters, and this trainer freezes none")
    if trainable is not None and not _records(opt_state, "PartitionState"):
        raise ValueError("the optimizer state freezes no parameter, and this trainer does")
    pc = mu.get("pixel_cnn")
    if isinstance(pc, dict) and "packed" in pc:
        mu, nu = (dict(t, pixel_cnn=_unpack_chain(t["pixel_cnn"], params["pixel_cnn"]))
                  for t in (mu, nu))
    labels = _labels(params, trainable or (lambda module, name: True))

    def moment(tree):
        def leaf(path, p):
            try:
                v = _leaf(tree, path)
            except (KeyError, TypeError):
                raise ValueError(
                    f"the optimizer state has no moment for {'/'.join(path)}") from None
            trains = _leaf(labels, path)
            if _is_optax(v, "MaskedNode") == trains:
                raise ValueError(f"{'/'.join(path)} is {'frozen' if trains else 'trained'} in "
                                 "the optimizer state, and not in this trainer")
            if not trains:
                return np.zeros(np.shape(p), np.float32)
            if np.shape(v) != np.shape(p):
                raise ValueError(f"the moment of {'/'.join(path)} has shape {np.shape(v)}, the "
                                 f"parameter {np.shape(p)}")
            return np.asarray(v, np.float32)
        return _map_with_path(leaf, params)

    return count, moment(mu), moment(nu)


def _ungroup(stacks, params: Tree) -> Tree:
    """A moment in ``group_by_shape``'s layout, its shape groups' stacks,
    back to a tree of ``params``'s structure by the plan of ``params``."""
    plan = _group_plan(params)
    if len(stacks) != len(plan) or any(
            np.shape(s) != (len(names), *key[0]) for s, (key, names) in zip(stacks, plan)):
        raise ValueError(f"the optimizer state's shape groups "
                         f"{[np.shape(s) for s in stacks]} are not those of the parameters "
                         f"{[(len(n), *k[0]) for k, n in plan]}")
    flat = {k: np.asarray(s[j], np.float32) for s, (_, names) in zip(stacks, plan)
            for j, k in enumerate(names)}
    return _map_with_path(lambda path, _: flat[".".join(path)], params)


def _unpack_chain(enc: Tree, pc: Tree) -> Tree:
    """``PackedChainCodec``'s encoded ``pixel_cnn`` subtree of moments
    (``{"packed": {"up": ..., "dn": ...}, "rest": ...}``; ``pixelcnn.py:
    751-927``) -> the canonical subtree of ``pc``'s structure: the packed
    stacks written back into each level's kernels and biases, the taps the
    packed form leaves out zero (their gradient is zero, so are their
    moments). The levels, filters and receptive field come from ``pc``."""
    n = sum(1 for k in pc if k.startswith("up_0_") and k.endswith("_vertical_conv_a"))
    rows, cols, _, f = np.shape(pc["up_0_0_vertical_conv_a"]["Conv_0"]["kernel"])
    slices = {"vertical": ((0, rows - 1), (0, cols)), "horizontal": ((0, 2), (0, cols // 2 + 1))}
    out = _map_with_path(lambda _, v: np.zeros(np.shape(v), np.float32), pc)
    out.update({k: v for k, v in enc["rest"].items()})

    def put_conv(tag, stack, which, k_flat, bias):
        sub = out[f"{tag}_conv_{which}"]["Conv_0"]
        (r0, r1), (c0, c1) = slices[stack]
        sub["kernel"][r0:r1, c0:c1] = np.reshape(k_flat, (r1 - r0, c1 - c0,
                                                          *sub["kernel"].shape[2:]))
        sub["bias"] = np.reshape(bias, -1)

    def put_dense(tag, suffix, kernel, bias):
        out[f"{tag}_{suffix}"] = {"kernel": np.asarray(kernel), "bias": np.reshape(bias, -1)}

    for d in ("up", "dn"):
        pk = enc["packed"][d]
        for p in range(n):
            tv, th = f"{d}_0_{p}_vertical", f"{d}_0_{p}_horizontal"
            put_conv(tv, "vertical", "a", pk["wav"][p], pk["bav"][p])
            put_conv(tv, "vertical", "b", pk["wbv"][p], pk["bbv"][p])
            put_dense(tv, "cond_proj", pk["wcv"][p], pk["bcv"][p])
            put_conv(th, "horizontal", "a", pk["wah"][p], pk["bah"][p])
            put_conv(th, "horizontal", "b", pk["wbh"][p], pk["bbh"][p])
            put_dense(th, "cond_proj", pk["wch"][p], pk["bch"][p])
            if d == "dn":
                put_dense(tv, "aux", pk["wxv"][p], pk["bxv"][p])
                u, s = np.asarray(pk["wxh_u"][p]), np.asarray(pk["wxh_s"][p])
                put_dense(th, "aux", np.concatenate([u[:f], s[:f], u[f:], s[f:]]), pk["bxh"][p])
            else:
                put_dense(th, "aux", pk["wxh_u"][p], pk["bxh"][p])
    return out
