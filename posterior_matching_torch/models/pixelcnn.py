"""Conditional gated PixelCNN: the parameters and their configuration.

Counterpart of ``posterior_matching_tpu/models/pixelcnn.py::PixelCNN``. The
parameters keep their flax names (``v_init``, ``h_init_up``, ``h_init_left``,
``{up,dn}_0_{r}_{vertical,horizontal}_{conv_a,conv_b,aux,cond_proj}``,
``embed``, ``logits_conv``, and with hierarchies ``down_sample_{i}_*`` /
``up_sample_{i}_*`` and ``dn_{i}_*`` for i >= 1) and flax layouts (conv
kernels HWIO, transposed conv kernels ``[kh, kw, in, out]``, dense kernels
``[in, out]``), which are what the sampler's fused weight stacks are cut
from.

:meth:`PixelCNN.forward` and :meth:`PixelCNN.log_prob` take the JAX
module's two paths, chosen as its ``_use_fused_chain`` chooses
(``models/pixelcnn.py:221-250``; :func:`fused_chain_topology`). One
hierarchy, a condition and the (3, 3) receptive field the chain's kernels
are built for take the fused flat path (``models/pixelcnn.py:559-596,
668-685``): the
embedding, the statically sliced ``v_init`` / ``h_init_up`` /
``h_init_left`` convs (``F.conv2d``, which the JAX package leaves to XLA),
then the up and the down pass of the gated chain (:mod:`posterior_matching_
torch.ops.gated_chain`: the hand-written kernels on the GPU) and the float32
1x1 logits head. ``dtype`` (None, "float32" or "bfloat16") is the JAX module's compute
dtype (``pixelcnn.py:202-219``): in bf16 the embedding, the three initial
convs (flax's ``dtype=bfloat16``: input, kernel and bias cast, the output
bf16) and the gated chain compute in bf16 and carry bf16 activations; the
parameters and the logits head stay float32. ``chain_segment`` chooses the
chain's granularity, as
``PM_TPU_CHAIN_SEGMENT`` does in the JAX package (``pixelcnn.py:410-495``):
``"stream"`` (the default) runs each pass as one launch of the stream
kernels, ``1`` each level through the pair kernels, an integer ``L``
segments of ``L`` levels (the last one shorter where ``L`` does not divide
``num_resnet``). All three realise the same dropout masks and, in float32,
the same outputs; in bf16 the same forward, and backwards that keep their
carries as the JAX modes do (``pixelcnn.py:398-406``: the stream's in bf16,
a segment's in float32 within a launch, the pair's rounded at every level
boundary). It is an execution option, never a key of a config file.
A conv kernel's masked-out taps never enter the graph, so their gradients
are exactly zero. Every other topology (more hierarchies, no condition,
another receptive field) takes the unfused path in plain PyTorch
(``pixelcnn.py:497-667``): each gated block from its masked convs and
dense layers, the hierarchies' strided down-sampling convs and transposed
up-sampling convs, every layer at ``dtype`` as flax places it, dropout
from the chain's hash masks (one block id a gated block, in order). JAX's
fused chain does not take these topologies either. Sampling is
:mod:`posterior_matching_torch.ops.sampler_chain` (the row kernels) or
:func:`pixelcnn_sample_naive` (one full forward a pixel).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from posterior_matching_torch.models.networks import _trunc_normal_fan_in
from posterior_matching_torch.ops.gated_block import _concat_elu
from posterior_matching_torch.ops.gated_chain import (
    chain_taps,
    dropout_keep_mask,
    gated_pair,
    gated_segment,
    gated_stream,
    pack_level,
    stack_levels,
)
from posterior_matching_torch.runtime import torch_dtype


def _masked_conv(x: torch.Tensor, layer: "KernelBias", kernel_size,
                 valid_rows, valid_cols, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The JAX ``_MaskedConv``'s stride-1 path on NHWC ``x``: the kernel
    sliced to its valid taps, convolved with the SAME padding shifted by
    the slice (negative padding crops). In bf16 the input and kernel are
    cast, the conv's output is bf16 and the bf16 bias is added to it
    (``pixelcnn.py:138-158``)."""
    kh, kw = kernel_size
    (r0, r1), (c0, c1) = valid_rows, valid_cols
    pads = (kw // 2 - c0, (c1 - 1) - kw // 2, kh // 2 - r0, (r1 - 1) - kh // 2)
    w = layer.kernel[r0:r1, c0:c1].permute(3, 2, 0, 1)
    x = F.pad(x.permute(0, 3, 1, 2), pads)
    if dtype == torch.float32:
        out = F.conv2d(x, w, layer.bias)
    else:
        out = F.conv2d(x.to(dtype), w.to(dtype)) + layer.bias.to(dtype)[:, None, None]
    return out.permute(0, 2, 3, 1)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """lax's SAME padding of one dimension: the output ceil(size / s)."""
    pad = max((-(-size // s) - 1) * s + k - size, 0)
    return pad // 2, pad - pad // 2


def _kernel_mask(kernel: torch.Tensor, valid_rows, valid_cols) -> torch.Tensor:
    """The kernel with the taps outside [rows) x [cols) zeroed, as flax's
    ``mask`` multiplies them (their gradients are zero)."""
    mask = torch.zeros(kernel.shape[:2], dtype=kernel.dtype, device=kernel.device)
    mask[valid_rows[0]:valid_rows[1], valid_cols[0]:valid_cols[1]] = 1.0
    return kernel * mask[:, :, None, None]


def _conv(x: torch.Tensor, layer: "KernelBias", kernel_size, valid_rows, valid_cols,
          dtype: torch.dtype = torch.float32, strides=(1, 1)) -> torch.Tensor:
    """The JAX ``_MaskedConv`` on NHWC ``x`` (``pixelcnn.py:73-158``): the
    sliced stride-1 conv for an odd kernel, else flax's ``nn.Conv`` with the
    masked full kernel, SAME padding and ``strides``; at ``dtype`` as
    flax's ``promote_dtype`` places it (input, kernel and bias cast)."""
    kh, kw = kernel_size
    if tuple(strides) == (1, 1) and kh % 2 and kw % 2:
        return _masked_conv(x, layer, kernel_size, valid_rows, valid_cols, dtype)
    w = _kernel_mask(layer.kernel, valid_rows, valid_cols).permute(3, 2, 0, 1)
    (pt, pb), (pl, pr) = (_same_pads(n, k, s) for n, k, s in
                          zip(x.shape[1:3], kernel_size, strides))
    x = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb)).to(dtype)
    out = F.conv2d(x, w.to(dtype), stride=tuple(strides)) + layer.bias.to(dtype)[:, None, None]
    return out.permute(0, 2, 3, 1)


def _conv_transpose(x: torch.Tensor, layer: "KernelBias", kernel_size, valid_rows,
                    valid_cols, dtype: torch.dtype = torch.float32,
                    strides=(2, 2)) -> torch.Tensor:
    """The JAX ``_MaskedConvTranspose`` (flax's ``nn.ConvTranspose`` with a
    mask, SAME padding, ``transpose_kernel=False``; ``pixelcnn.py:161-184``):
    ``lax.conv_transpose``, i.e. the input dilated by the strides, padded as
    ``_conv_transpose_padding`` says and correlated with the unflipped
    kernel ``[kh, kw, in, out]``."""
    w = _kernel_mask(layer.kernel, valid_rows, valid_cols).permute(3, 2, 0, 1)
    b, h, wd, c = x.shape
    (sh, sw), (kh, kw) = strides, kernel_size
    xd = x.new_zeros(b, c, (h - 1) * sh + 1, (wd - 1) * sw + 1)
    xd[:, :, ::sh, ::sw] = x.permute(0, 3, 1, 2)
    pads = []
    for k, s in ((kw, sw), (kh, sh)):  # F.pad's order: last dimension first
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
        pads += [pad_a, pad_len - pad_a]
    out = F.conv2d(F.pad(xd, pads).to(dtype), w.to(dtype)) + layer.bias.to(dtype)[:, None, None]
    return out.permute(0, 2, 3, 1)


def _dense(x: torch.Tensor, layer: "KernelBias", dtype: torch.dtype) -> torch.Tensor:
    """flax's ``nn.Dense`` at ``dtype``."""
    return x.to(dtype) @ layer.kernel.to(dtype) + layer.bias.to(dtype)


class KernelBias(nn.Module):
    """A flax ``kernel`` / ``bias`` pair."""

    def __init__(self, kernel_shape: Tuple[int, ...], init_std: Optional[float] = None):
        super().__init__()
        if init_std is None:
            kernel = _trunc_normal_fan_in(kernel_shape)
        else:
            kernel = init_std * torch.randn(kernel_shape)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(kernel_shape[-1]))


class PixelCNN(nn.Module):
    def __init__(
        self,
        num_indices: int,
        image_shape: Tuple[int, int],
        dropout: float = 0.5,
        num_resnet: int = 15,
        num_hierarchies: int = 1,
        num_filters: int = 128,
        receptive_field_dims: Tuple[int, int] = (3, 3),
        conditional_dim: Optional[int] = None,
        chain_segment: Union[str, int] = "stream",
        dtype: Optional[str] = None,
    ):
        super().__init__()
        if num_hierarchies < 1:
            raise ValueError(f"num_hierarchies must be >= 1, got {num_hierarchies}")
        self.chain_segment = chain_segment
        # the chain's weights in the stream kernels' stacked layout, where a
        # trainer keeps them so (PackedChainCodec), else None
        self.packed_chain: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self.compute_dtype = torch_dtype(dtype)
        self.num_indices = num_indices
        self.image_shape = tuple(image_shape)
        self.dropout = dropout
        self.num_resnet = num_resnet
        self.num_hierarchies = num_hierarchies
        self.num_filters = num_filters
        self.receptive_field_dims = tuple(receptive_field_dims)
        self.conditional_dim = conditional_dim

        f = num_filters
        rows, cols = self.receptive_field_dims
        ksizes = {"vertical": (2 * rows - 3, cols), "horizontal": (3, cols)}
        self.embed = nn.Parameter(
            torch.randn(num_indices, f) / f ** 0.5
        )
        layers = {
            "v_init": KernelBias((2 * rows - 1, cols, f, f)),
            "h_init_up": KernelBias((3, cols, f, f)),
            "h_init_left": KernelBias((3, cols, f, f)),
            "logits_conv": KernelBias((1, 1, f, num_indices)),
        }
        for d, i, r in self._block_ids():
            for stack in ("vertical", "horizontal"):
                tag = f"{d}_{i}_{r}_{stack}"
                kh, kw = ksizes[stack]
                layers[f"{tag}_conv_a"] = KernelBias((kh, kw, 2 * f, f))
                layers[f"{tag}_conv_b"] = KernelBias((kh, kw, 2 * f, 2 * f))
                if conditional_dim is not None:
                    layers[f"{tag}_cond_proj"] = KernelBias(
                        (conditional_dim, 2 * f), init_std=1.0
                    )
                # aux cue: up horizontal <- new vertical (F);
                # down vertical <- skip (F); down horizontal <- (W, skip)
                aux_in = {
                    ("up", "horizontal"): f,
                    ("dn", "vertical"): f,
                    ("dn", "horizontal"): 2 * f,
                }.get((d, stack))
                if aux_in is not None:
                    layers[f"{tag}_aux"] = KernelBias((2 * aux_in, f))
        for i in range(num_hierarchies - 1):
            for stack in ("vertical", "horizontal"):
                (kh, kw), _ = self._resample(stack, down=True)
                layers[f"down_sample_{i}_{stack}"] = KernelBias((kh, kw, f, f))
                (kh, kw), _ = self._resample(stack, down=False)
                layers[f"up_sample_{i}_{stack}"] = KernelBias((kh, kw, f, f))
        self.layers = nn.ModuleDict(layers)

    def _block_ids(self) -> List[Tuple[str, int, int]]:
        """``(pass, hierarchy, r)`` of every gated block pair in the order
        the unfused forward runs them: the up pass's ``num_resnet`` a
        hierarchy, then the down pass's, one more at hierarchies i >= 1
        (``pixelcnn.py:599-665``)."""
        up = [("up", i, r) for i in range(self.num_hierarchies) for r in range(self.num_resnet)]
        dn = [("dn", i, r) for i in range(self.num_hierarchies)
              for r in range(self.num_resnet + (i > 0))]
        return up + dn

    def _valid(self, stack: str) -> Tuple[int, int]:
        """The causal extent of a stack's convs: rows x columns (``pixelcnn.py:543-546``)."""
        rows, cols = self.receptive_field_dims
        return (rows - 1, cols) if stack == "vertical" else (2, cols // 2 + 1)

    def _resample(self, stack: str, down: bool):
        """The kernel size and valid region of a stack's strided
        down-sampling conv or transposed up-sampling conv
        (``pixelcnn.py:630-663``)."""
        h_, w_ = self._valid(stack)
        if down:
            return (2 * h_, w_ + 1 if stack == "vertical" else 2 * w_), ((0, h_), (0, w_))
        kh = 2 * h_ - 2
        if stack == "vertical":
            return (kh, w_ + 1), ((h_ - 2, kh), (0, w_))
        kw = 2 * w_ - 2
        return (kh, kw), ((h_ - 2, kh), (w_ - 2, kw))

    def forward(
        self,
        indices: torch.Tensor,
        conditional_input: Optional[torch.Tensor] = None,
        training: bool = False,
        seed: int = 0,
    ) -> torch.Tensor:
        """``[B, H, W]`` codes and ``[B, D]`` conditions (or None) ->
        ``[B, H, W, K]`` float32 logits, through the fused chain or the
        unfused path (:func:`fused_chain_topology`). With ``training`` and
        ``dropout > 0`` the dropout masks are the hash masks of ``seed``.
        The head takes the elu of the chain's output (bf16 in bf16) up to
        float32, as the JAX head's float32 parameters promote it
        (``pixelcnn.py:586-596``)."""
        xv, xh = self.init_stacks(indices)
        if fused_chain_topology(self, conditional_input):
            x_final = self._chain(xv, xh, conditional_input.reshape(indices.shape[0], -1),
                                  training, seed)
        else:
            x_final = self._unfused(xv, xh, conditional_input, training, seed)
        lw = self.layers["logits_conv"]
        return (F.elu(x_final).float() @ lw.kernel[0, 0] + lw.bias).float()

    def init_stacks(self, indices: torch.Tensor):
        """The chain's inputs: ``v_init`` and ``h_init_up + h_init_left`` of
        the codes' embedding, ``[B, H, W, F]`` each, at the compute dtype."""
        rows, cols = self.receptive_field_dims
        layers, cd = self.layers, self.compute_dtype
        h0 = self.embed.to(cd)[indices.long()]
        v_init = _conv(h0, layers["v_init"], (2 * rows - 1, cols), (0, rows - 1), (0, cols), cd)
        h_up = _conv(h0, layers["h_init_up"], (3, cols), (0, 1), (0, cols), cd)
        h_left = _conv(h0, layers["h_init_left"], (3, cols), (0, 2), (0, cols // 2), cd)
        return v_init, h_up + h_left

    def _gated_residual(self, tag: str, x, aux, cond, stack: str, keep: float, seed: int,
                        block_id: int):
        """One gated block of the unfused path (``_gated_residual``,
        ``pixelcnn.py:497-536``): conv_a of concat_elu(x) (+ the aux
        layer of concat_elu(aux)), concat_elu, dropout, conv_b (+ the
        conditional projection), then the sigmoid gate's residual."""
        layers, cd = self.layers, self.compute_dtype
        rows, cols = self.receptive_field_dims
        ksize = (2 * rows - 3, cols) if stack == "vertical" else (3, cols)
        h_, w_ = self._valid(stack)
        conv = lambda z, name: _conv(z, layers[f"{tag}_{name}"], ksize, (0, h_), (0, w_), cd)
        a = conv(_concat_elu(x), "conv_a")
        if aux is not None:
            a = a + _dense(_concat_elu(aux), layers[f"{tag}_aux"], cd)
        a = _concat_elu(a)
        if keep < 1.0:
            b, h, w, c2 = a.shape
            mask = dropout_keep_mask(seed, block_id, b, h, w, c2, keep, a.device) != 0
            a = torch.where(mask, a / keep, torch.zeros_like(a))
        out = conv(a, "conv_b")
        if cond is not None:
            proj = _dense(cond.reshape(cond.shape[0], -1), layers[f"{tag}_cond_proj"], cd)
            out = out + proj[:, None, None, :]
        act, gate = out.split(self.num_filters, -1)
        return x + torch.sigmoid(gate) * act

    def _unfused(self, xv, xh, cond, training: bool, seed: int) -> torch.Tensor:
        """The up pass over the hierarchies (each down-sampled by its strided
        convs), then the down pass popping the skips in reverse (the
        horizontal skip concatenated behind the new vertical output), each
        hierarchy but the last up-sampled by its transposed convs
        (``pixelcnn.py:599-665``). Returns the last horizontal output."""
        layers, cd = self.layers, self.compute_dtype
        keep = 1.0 - self.dropout if (training and self.dropout > 0) else 1.0
        stacks = {"vertical": [xv], "horizontal": [xh]}
        block = iter(range(2 * len(self._block_ids())))  # each gated block's dropout id
        for i in range(self.num_hierarchies):
            for r in range(self.num_resnet):
                for stack in ("vertical", "horizontal"):
                    aux = stacks["vertical"][-1] if stack == "horizontal" else None
                    stacks[stack].append(self._gated_residual(
                        f"up_{i}_{r}_{stack}", stacks[stack][-1], aux, cond, stack, keep, seed,
                        next(block)))
            if i < self.num_hierarchies - 1:
                for stack in ("vertical", "horizontal"):
                    ksize, (rv, cv) = self._resample(stack, down=True)
                    stacks[stack].append(_conv(stacks[stack][-1], layers[f"down_sample_{i}_{stack}"],
                                               ksize, rv, cv, cd, strides=(2, 2)))
        down = {k: s.pop() for k, s in stacks.items()}
        for i in range(self.num_hierarchies):
            for r in range(self.num_resnet + (i > 0)):
                for stack in ("vertical", "horizontal"):
                    skip = stacks[stack].pop()
                    if stack == "horizontal":
                        skip = torch.cat([down["vertical"], skip], -1)
                    down[stack] = self._gated_residual(
                        f"dn_{i}_{r}_{stack}", down[stack], skip, cond, stack, keep, seed,
                        next(block))
            if i < self.num_hierarchies - 1:
                for stack in ("vertical", "horizontal"):
                    ksize, (rv, cv) = self._resample(stack, down=False)
                    down[stack] = _conv_transpose(down[stack], layers[f"up_sample_{i}_{stack}"],
                                                  ksize, rv, cv, cd)
        return down["horizontal"]

    @property
    def chain_segment(self) -> Union[str, int]:
        return self._chain_segment

    @chain_segment.setter
    def chain_segment(self, value: Union[str, int]):
        if value != "stream" and not (isinstance(value, int) and value >= 1):
            raise ValueError(f"chain_segment is 'stream' or an integer >= 1, got {value!r}")
        self._chain_segment = value

    def _chain(self, xv, xh, cond, training: bool, seed: int) -> torch.Tensor:
        """The up pass, then the down pass with the up outputs as skips in
        reverse (``pixelcnn.py:386-495``): with ``xs = [init] + up outputs``
        down level p takes ``xs[n - 1 - p]``, so the last up output is the
        down pass's carry and never a skip, and the init stacks are the
        last skip. Returns the last horizontal output. With
        :attr:`packed_chain` the stream kernels take the packed stacks as
        they are, their biases folded (``pixelcnn.py:410-430``): no level
        is packed or stacked in the step."""
        n, f = self.num_resnet, self.num_filters
        rf = self.receptive_field_dims
        keep = 1.0 - self.dropout if (training and self.dropout > 0) else 1.0
        common = dict(seed=seed, keep=keep, taps=chain_taps(rf),
                      compute_dtype=self.compute_dtype)
        packed = self.packed_chain
        if packed is not None and self.chain_segment != "stream":
            raise ValueError("packed_chain requires the stream chain kernels "
                             "(PM_TPU_CHAIN_SEGMENT=stream)")
        if packed is not None:
            stacks = {d: fold_packed_biases(packed[d], d == "dn") for d in ("up", "dn")}
        else:
            levels = {d: [pack_level(self.layers, d, p, f, d == "dn", rf) for p in range(n)]
                      for d in ("up", "dn")}
        if self.chain_segment == "stream":
            if packed is None:
                stacks = {d: stack_levels(levels[d]) for d in ("up", "dn")}
            up_v, up_h = gated_stream(xv, xh, None, cond, stacks["up"],
                                      base_pair=0, **common)
            xs_v, xs_h = [xv, *up_v], [xh, *up_h]
            skips = (
                torch.stack([xs_v[n - 1 - p] for p in range(n)]),
                torch.stack([xs_h[n - 1 - p] for p in range(n)]),
            )
            _, dn_h = gated_stream(up_v[-1], up_h[-1], skips, cond,
                                   stacks["dn"], base_pair=n, **common)
            return dn_h[-1]
        seg = self.chain_segment
        xs_v, xs_h = [xv], [xh]
        for d, base in (("up", 0), ("dn", n)):
            for p in range(0, n, seg):
                ws = levels[d][p: p + seg]
                sk = None
                if d == "dn":
                    sk = [(xs_v[n - 1 - q], xs_h[n - 1 - q]) for q in range(p, p + len(ws))]
                if seg == 1:
                    outs = [gated_pair(xv, xh, sk and sk[0], cond, ws[0],
                                       pair_index=base + p, **common)]
                else:
                    outs = gated_segment(xv, xh, sk, cond, ws, base_pair=base + p, **common)
                if d == "up":
                    xs_v += [o[0] for o in outs]
                    xs_h += [o[1] for o in outs]
                xv, xh = outs[-1]
        return xh

    def log_prob(
        self,
        value: torch.Tensor,
        conditional_input: Optional[torch.Tensor] = None,
        training: bool = False,
        seed: int = 0,
    ) -> torch.Tensor:
        """Teacher-forced log-likelihood of ``value [B, H, W]``, summed over
        the grid: ``[B]``."""
        logits = self(value, conditional_input, training=training, seed=seed)
        logp = torch.log_softmax(logits, dim=-1)
        lls = torch.gather(logp, -1, value.long()[..., None])[..., 0]
        return lls.sum(dim=tuple(range(1, lls.ndim)))


# ---------------------------------------------------------------------------
# The packed chain: the training representation of ``packed_chain``
# ---------------------------------------------------------------------------

# Biases the packed form keeps unfolded (``pixelcnn.py:751``), each [L, 1, C].
_PACKED_BIAS_KEYS = ("bav", "bbv", "bcv", "bxv", "bah", "bbh", "bch", "bxh")


def fold_packed_biases(packed: Dict[str, torch.Tensor], down: bool) -> Dict[str, torch.Tensor]:
    """Packed (unfolded) stacks -> the stream kernels' weights
    (``pixelcnn.py:754-768``): the aux bias folded into conv_a's, the cond
    bias into conv_b's, each bias ``[L, C]``; the weights as they are."""
    w = {k: v for k, v in packed.items() if k not in _PACKED_BIAS_KEYS}
    flat = lambda t: t.reshape(t.shape[0], -1)
    w["bav"] = flat(packed["bav"] + packed["bxv"] if down else packed["bav"])
    w["bah"] = flat(packed["bah"] + packed["bxh"])
    w["bbv"] = flat(packed["bbv"] + packed["bcv"])
    w["bbh"] = flat(packed["bbh"] + packed["bch"])
    return w


def is_chain_layer(tag: str) -> bool:
    """Whether a layer of the PixelCNN belongs to the gated chain that the
    packed form holds (``is_chain_param``, ``pixelcnn.py:779-782``)."""
    return tag.startswith("up_0_") or tag.startswith("dn_0_")


class PackedChainCodec:
    """The port's ``PackedChainCodec`` (``pixelcnn.py:870-940``) for a
    model whose PixelCNN sits at ``prefix``: tensors keyed by the model's
    parameter names (canonical) <-> the training representation, where the
    chain's kernels and biases are replaced by ``{prefix}.packed.{up,dn}.
    {name}`` stacks ``[num_resnet, ...]`` in the stream kernels' layout
    (``pack_chain_params``, :785-866): kernels sliced to their valid taps
    and flattened, ``wxh`` of the down pass split into its ``u`` / ``s`` row
    halves, biases ``[L, 1, C]`` unfolded. :meth:`encode` and
    :meth:`decode_into` are exact rearrangements, so an elementwise
    optimizer's steps on either side are the same numbers; the taps outside
    the valid region keep the canonical tensors' values (their gradient is
    zero on both sides)."""

    def __init__(self, model: nn.Module, prefix: str = "pixel_cnn"):
        pixel_cnn = model.get_submodule(prefix)
        self.prefix = prefix
        self.n, self.f = pixel_cnn.num_resnet, pixel_cnn.num_filters
        rows, cols = pixel_cnn.receptive_field_dims
        self._slices = {"vertical": ((0, rows - 1), (0, cols)),
                        "horizontal": ((0, 2), (0, cols // 2 + 1))}
        head = f"{prefix}.layers."
        self.chain_names = [k for k, _ in model.named_parameters()
                            if k.startswith(head) and is_chain_layer(k[len(head):])]

    def _layer(self, tensors, tag: str, which: str) -> torch.Tensor:
        return tensors[f"{self.prefix}.layers.{tag}.{which}"]

    def _plan(self):
        """``(pass, packed name, layer tag, kernel or bias, stack or None,
        rows of the [4F, F] aux kernel or None)`` of every packed stack, in
        the JAX packed dict's order."""
        f = self.f
        for d in ("up", "dn"):
            for stack, sfx in (("vertical", "v"), ("horizontal", "h")):
                if stack == "horizontal" or d == "dn":
                    aux = "wxh" if stack == "horizontal" else "wxv"
                    if d == "dn" and stack == "horizontal":
                        yield d, "wxh_u", "horizontal_aux", "kernel", None, (0, f, 2 * f, 3 * f)
                        yield d, "wxh_s", "horizontal_aux", "kernel", None, (f, 2 * f, 3 * f, 4 * f)
                    else:
                        yield d, aux if aux == "wxv" else "wxh_u", f"{stack}_aux", "kernel", None, None
                    yield d, f"bx{sfx}", f"{stack}_aux", "bias", None, None
                yield d, f"wa{sfx}", f"{stack}_conv_a", "kernel", stack, None
                yield d, f"ba{sfx}", f"{stack}_conv_a", "bias", None, None
                yield d, f"wb{sfx}", f"{stack}_conv_b", "kernel", stack, None
                yield d, f"bb{sfx}", f"{stack}_conv_b", "bias", None, None
                yield d, f"wc{sfx}", f"{stack}_cond_proj", "kernel", None, None
                yield d, f"bc{sfx}", f"{stack}_cond_proj", "bias", None, None

    def _level(self, t: torch.Tensor, which: str, stack, rows) -> torch.Tensor:
        """One level's canonical tensor in its packed form."""
        if which == "bias":
            return t.reshape(1, -1)
        if stack is not None:
            (r0, r1), (c0, c1) = self._slices[stack]
            t = t[r0:r1, c0:c1]
            return t.reshape(-1, t.shape[-1])
        if rows is not None:
            f = self.f
            return torch.cat([t[rows[0]:rows[0] + f], t[rows[2]:rows[2] + f]])
        return t

    def encode(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Canonical tensors (a parameter dict, or moments keyed alike) ->
        the training representation: every tensor that is not the chain's
        as it is, then the packed stacks."""
        chain = set(self.chain_names)
        out = {k: v for k, v in tensors.items() if k not in chain}
        for d, name, layer, which, stack, rows in self._plan():
            levels = [self._level(self._layer(tensors, f"{d}_0_{p}_{layer}", which), which,
                                  stack, rows) for p in range(self.n)]
            out[f"{self.prefix}.packed.{d}.{name}"] = torch.stack(levels)
        return out

    @torch.no_grad()
    def decode_into(self, encoded: Dict[str, torch.Tensor],
                    canonical: Dict[str, torch.Tensor]) -> None:
        """Writes the packed stacks of ``encoded`` back into the chain's
        tensors of ``canonical`` (keyed by the model's names), in place,
        the inverse of :meth:`encode`; the taps outside the valid region are
        left as they are."""
        f = self.f
        for d, name, layer, which, stack, rows in self._plan():
            packed = encoded[f"{self.prefix}.packed.{d}.{name}"]
            for p in range(self.n):
                t = self._layer(canonical, f"{d}_0_{p}_{layer}", which)
                v = packed[p]
                if which == "bias":
                    t.copy_(v.reshape(-1))
                elif stack is not None:
                    (r0, r1), (c0, c1) = self._slices[stack]
                    t[r0:r1, c0:c1].copy_(v.reshape(r1 - r0, c1 - c0, *t.shape[2:]))
                elif rows is not None:
                    t[rows[0]:rows[0] + f].copy_(v[:f])
                    t[rows[2]:rows[2] + f].copy_(v[f:])
                else:
                    t.copy_(v)

    def attach(self, model: nn.Module, encoded: Dict[str, torch.Tensor]) -> None:
        """Points the model's PixelCNN at the packed stacks of ``encoded``
        (``None`` detaches it: the canonical path again)."""
        pixel_cnn = model.get_submodule(self.prefix)
        if encoded is None:
            pixel_cnn.packed_chain = None
            return
        head = f"{self.prefix}.packed."
        packed = {"up": {}, "dn": {}}
        for k, v in encoded.items():
            if k.startswith(head):
                d, name = k[len(head):].split(".")
                packed[d][name] = v
        pixel_cnn.packed_chain = packed

    def jax_tree(self, params_tree: Dict, encoded: Dict[str, torch.Tensor]) -> Dict:
        """A canonical JAX-layout tree (a ``to_trees`` output) with its
        ``prefix`` subtree encoded as the JAX codec encodes it: ``{"packed":
        {"up": ..., "dn": ...}, "rest": <the PixelCNN's other leaves>}``,
        the packed leaves numpy arrays of ``encoded``."""
        head = f"{self.prefix}.packed."
        packed = {"up": {}, "dn": {}}
        for k, v in encoded.items():
            if k.startswith(head):
                d, name = k[len(head):].split(".")
                packed[d][name] = v.detach().cpu().numpy()
        pc = params_tree[self.prefix]
        out = dict(params_tree)
        out[self.prefix] = {"packed": packed,
                            "rest": {k: v for k, v in pc.items() if not is_chain_layer(k)}}
        return out


def fused_chain_topology(pixel_cnn: PixelCNN, conditional_input) -> bool:
    """Whether the PixelCNN's chain runs through the fused chain (the gated
    chain's kernels on the GPU): one hierarchy, a condition, and the (3, 3)
    receptive field the kernels are built for, as the JAX module's
    ``_use_fused_chain`` asks (``pixelcnn.py:221-250``; its tap plans take
    more fields, the port's kernels (3, 3)). Every other topology takes the
    unfused path."""
    return (pixel_cnn.num_hierarchies == 1 and conditional_input is not None
            and tuple(pixel_cnn.receptive_field_dims) == (3, 3))


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(u))`` with ``u`` in [tiny, 1) as
    ``jax.random.gumbel`` draws it."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@torch.no_grad()
def pixelcnn_sample_naive(
    pixel_cnn: PixelCNN,
    num_samples: int,
    conditional_input: Optional[torch.Tensor] = None,
    *,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Raster-scan sampling with one full forward a pixel, for any topology
    (the JAX ``pixelcnn_sample``, ``pixelcnn.py:944-995``): the logits of
    the whole grid, then ``argmax(logits + gumbel)`` at the pixel, which is
    ``jax.random.categorical``. The Gumbel noise is given, ``noise [H * W,
    n, K]`` in raster order (the JAX sampler's draws, one key split a
    pixel), or drawn from ``generator`` on the model's device one image row
    ``[W, n, K]`` at a time, as :func:`~posterior_matching_torch.ops.
    sampler_chain.pixelcnn_sample` draws it. ``n`` is sample-major.

    Returns ``[S, B, H, W]`` int64 (``[S, H, W]`` when unconditional).
    """
    if (noise is None) == (generator is None):
        raise ValueError("pass exactly one of noise= and generator=")
    device = pixel_cnn.embed.device
    hgt, wid = pixel_cnn.image_shape
    k = pixel_cnn.num_indices
    if conditional_input is not None:
        bsz = conditional_input.shape[0]
        cond = conditional_input[None].expand(num_samples, *conditional_input.shape)
        cond = cond.reshape(num_samples * bsz, -1)
    else:
        bsz, cond = None, None
    n = num_samples * (bsz or 1)
    if noise is not None and tuple(noise.shape) != (hgt * wid, n, k):
        raise ValueError(f"noise must be [H * W, n, K] = {(hgt * wid, n, k)}, got "
                         f"{tuple(noise.shape)}")
    x = torch.zeros(n, hgt, wid, dtype=torch.long, device=device)
    for r in range(hgt):
        if generator is not None:
            row_noise = gumbel_noise((wid, n, k), generator, device)
        for c in range(wid):
            logits = pixel_cnn(x, cond)[:, r, c]
            g = noise[r * wid + c].to(device) if noise is not None else row_noise[c]
            x[:, r, c] = torch.argmax(logits + g, -1)
    if bsz is not None:
        return x.reshape(num_samples, bsz, hgt, wid)
    return x
