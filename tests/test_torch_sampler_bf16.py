"""The port's plain bf16 row sampler against the JAX row-kernel sampler in bf16.

Both get the same weights (the port's seeded initialisation, carried to the
JAX tree by ``convert.pixel_cnn_tree``) and the same numpy-drawn Gumbel
noise ``[H, W, n, K]``; the JAX side is
``pixelcnn_sample_rowkernel(compute_dtype="bfloat16", interpret=True)``, the
branch that ``PM_TPU_SAMPLER=rowkernel`` selects on a TPU. The two round at
the same points (``ops/sampler_chain.py``'s docstring) and differ in the
order of float32 sums, which can move a rounded value by one bf16 ulp; such
a flip may tip a later argmax where two codes nearly tie. So each chain
(one of the ``n`` samples, in raster order) is held to JAX's up to and
including its first differing sample: its logits there within
``LOGITS_TOL`` of their scale, and at that first divergence JAX's top two
of ``logits + noise`` closer than ``TIE_GAP`` (a near-tie). The share of
chains that never diverge is printed (``python tests/test_torch_sampler_bf16.py``).

The cases cover L = 2, 6 and 8 levels, whose rounding cadence ``lpg`` is 2,
3 and 4 (the JAX kernel's levels per grid step), with and without a
condition, 8 filters and one case at 64; one case sets
``PM_TPU_SAMPLER_LPG`` on the JAX side (at a shape of its own, so that no
cached trace ignores it) and passes the same ``lpg`` to the port. Held at
a wrong cadence the logits differ by ~5e-2 of their scale.

The bf16 kernels are held to these plain versions by
``sampler_chain.bf16_gate_ok``, whose share of differing values is taken
before one-ulp flips cascade; ``test_bf16_gate_separates_flips_from_a_wrong_
cadence`` holds the premise at a toy depth: the plain version summed in
float64 passes the gate against itself in float32, a wrong cadence does
not. ``python tests/test_torch_sampler_bf16.py`` prints the gate's numbers
at the flagship's (F 128, L 24, W 16) and digits16's (F 64, L 12, W 4)
depths (~1 min).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posterior_matching_tpu.models.pixelcnn import PixelCNN as JaxPixelCNN
from posterior_matching_tpu.ops.sampler_chain import pixelcnn_sample_rowkernel
from posterior_matching_torch import convert
from posterior_matching_torch.models import pm_vqvae
from posterior_matching_torch.models.pixelcnn import PixelCNN
from posterior_matching_torch.ops import sampler_chain
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOGITS_TOL = 5e-3   # of the logits' scale (max |logit|, at least 1)
TIE_GAP = 2e-2      # a first divergence's top-two gap, in units of that scale
NUM_SAMPLES = 3
SHARES = {}


def _models(num_resnet, num_indices, image_shape, cond_dim, batch, num_filters=8):
    """The JAX PixelCNN, its params, the port's PixelCNN (seeded) and a
    seeded condition (or None)."""
    kw = dict(num_indices=num_indices, image_shape=image_shape, dropout=0.0,
              num_resnet=num_resnet, num_filters=num_filters)
    torch.manual_seed(0)
    port = PixelCNN(**kw, conditional_dim=cond_dim)
    cond = (None if cond_dim is None
            else np.random.RandomState(7).randn(batch, cond_dim).astype(np.float32))
    return JaxPixelCNN(num_hierarchies=1, **kw), convert.pixel_cnn_tree(port.state_dict()), \
        port, cond


def compare_chains(js, jl, ts, tl, noise):
    """Per chain: the first differing sample (or None), the worst logits error
    up to it over the scale, and JAX's top-two gap there. ``js`` / ``ts``
    ``[n, H, W]`` (or ``[S, B, H, W]``), ``jl`` / ``tl`` ``[n, H, W, K]``,
    ``noise [H, W, n, K]``."""
    n, k = jl.shape[0], jl.shape[-1]
    js, ts = js.reshape(n, -1), ts.reshape(n, -1)
    jl, tl = jl.reshape(n, -1, k), tl.reshape(n, -1, k)
    nz = noise.transpose(2, 0, 1, 3).reshape(n, -1, k)
    out = []
    for j in range(n):
        diff = np.nonzero(js[j] != ts[j])[0]
        first = int(diff[0]) if len(diff) else None
        end = js.shape[1] if first is None else first + 1
        scale = max(1.0, float(np.abs(jl[j, :end]).max()))
        err = float(np.abs(jl[j, :end] - tl[j, :end]).max()) / scale
        gap = None
        if first is not None:
            top = np.sort(jl[j, first] + nz[j, first])
            gap = float(top[-1] - top[-2]) / scale
        out.append((first, err, gap))
    return out


def run_case(num_resnet, cond_dim, num_filters, image_shape, batch, num_indices,
             lpg=None):
    jm, params, port, cond = _models(num_resnet, num_indices, image_shape, cond_dim, batch,
                                     num_filters)
    n = NUM_SAMPLES * (batch if cond is not None else 1)
    noise = np.random.RandomState(5).gumbel(
        size=(*image_shape, n, num_indices)).astype(np.float32)
    js, jl = pixelcnn_sample_rowkernel(
        jm, params, jax.random.PRNGKey(0), NUM_SAMPLES,
        conditional_input=None if cond is None else jnp.asarray(cond),
        compute_dtype="bfloat16", interpret=True, noise=jnp.asarray(noise),
        return_logits=True,
    )
    ts, tl = sampler_chain.pixelcnn_sample(
        port, NUM_SAMPLES, None if cond is None else torch.from_numpy(cond),
        noise=torch.from_numpy(noise), return_logits=True, compute_dtype="bfloat16",
        lpg=lpg,
    )
    return compare_chains(np.asarray(js), np.asarray(jl), ts.numpy(), tl.numpy(), noise)


def check(chains, case):
    for j, (first, err, gap) in enumerate(chains):
        assert err <= LOGITS_TOL, (case, j, first, err)
        if first is not None:
            assert gap < TIE_GAP, (case, j, first, gap)
    SHARES[case] = np.mean([first is None for first, _, _ in chains])
    print(f"{case}: {SHARES[case]:.2f} of chains never diverge, worst logits error "
          f"{max(e for _, e, _ in chains):.2e} of scale")


@pytest.mark.parametrize(
    "num_resnet,cond_dim,num_filters,image_shape,batch,num_indices",
    [pytest.param(1, 10, 8, (5, 6), 2, 12, id="L2-lpg2-cond"),
     pytest.param(3, None, 8, (5, 6), 2, 12, id="L6-lpg3-uncond"),
     pytest.param(4, 10, 8, (5, 6), 2, 12, id="L8-lpg4-cond"),
     pytest.param(1, 16, 64, (2, 3), 1, 128, id="L2-f64-cond")],
)
def test_plain_bf16_sampler_follows_jax_bf16_rowkernel(num_resnet, cond_dim, num_filters,
                                                       image_shape, batch, num_indices):
    case = f"L{2 * num_resnet}-F{num_filters}-{'cond' if cond_dim else 'uncond'}"
    check(run_case(num_resnet, cond_dim, num_filters, image_shape, batch, num_indices),
          case)


def test_lpg_from_the_environment_is_followed(monkeypatch):
    """JAX reads ``PM_TPU_SAMPLER_LPG`` when it traces; this shape is used by
    no other case, so the trace is fresh."""
    monkeypatch.setenv("PM_TPU_SAMPLER_LPG", "2")
    assert sampler_chain.levels_per_group(8, 2) == 2
    chains = run_case(4, 10, 8, (4, 5), 1, 12, lpg=2)
    check(chains, "L8-lpg2-env")


def test_levels_per_group_follows_the_jax_rule(monkeypatch):
    monkeypatch.delenv("PM_TPU_SAMPLER_LPG", raising=False)
    assert [sampler_chain.levels_per_group(n) for n in (2, 6, 8, 12, 24)] == [2, 3, 4, 4, 4]
    monkeypatch.setenv("PM_TPU_SAMPLER_LPG", "5")
    assert [sampler_chain.levels_per_group(n) for n in (2, 6, 10, 24)] == [2, 3, 5, 4]
    assert sampler_chain.levels_per_group(24, 6) == 6


def test_sampler_selection_follows_the_environment(monkeypatch):
    port = _models(1, 12, (3, 4), 10, 1)[2]
    monkeypatch.delenv("PM_TPU_SAMPLER", raising=False)
    monkeypatch.delenv("PM_TPU_SAMPLER_DTYPE", raising=False)
    f32, bf16 = torch.float32, torch.bfloat16
    assert pm_vqvae.impute_sampler(port, "cuda") == ("rowkernel", f32)
    monkeypatch.setenv("PM_TPU_SAMPLER", "rowkernel")
    assert pm_vqvae.impute_sampler(port, "cuda") == ("rowkernel", bf16)
    assert pm_vqvae.impute_sampler(port, "cuda:0") == ("rowkernel", bf16)
    assert pm_vqvae.impute_sampler(port, "cpu") == ("rowkernel", f32)
    monkeypatch.setenv("PM_TPU_SAMPLER_DTYPE", "float32")
    assert pm_vqvae.impute_sampler(port, "cuda") == ("rowkernel", f32)
    assert pm_vqvae.impute_sampler(port, "cpu", "bfloat16") == ("rowkernel", bf16)
    monkeypatch.setenv("PM_TPU_SAMPLER_DTYPE", "float16")
    with pytest.raises(ValueError, match="float16"):
        pm_vqvae.impute_sampler(port, "cuda")


def test_wrappers_refuse_a_mixed_dtype_set():
    port = _models(1, 12, (3, 4), 10, 1)[2]
    w = sampler_chain.fuse_sampler_weights(port, "bfloat16")
    assert w.wa.dtype == torch.bfloat16 and w.ba.dtype == torch.float32
    wid, n, f, n_lvl = 4, 2, 8, 2
    z = lambda *s: torch.zeros(*s, dtype=torch.bfloat16)
    args = [z(wid, n, f), z(wid, n, f), z(wid, n, f), z(n_lvl, wid, n, f),
            z(n_lvl, wid, n, 2 * f), z(n_lvl, n, 2 * f), w.viw, w.vib, w.huw, w.hub,
            w.wav, w.bav, w.wbv, w.bbv, w.waux]
    outv = sampler_chain.vrow_bf16(*args)[0]
    assert outv.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="e1 must be torch.bfloat16"):
        sampler_chain.vrow_bf16(*args[:1], args[1].float(), *args[2:])
    with pytest.raises(ValueError, match="e2 must be torch.float32"):
        sampler_chain.vrow(*args)


def float64_sums(fn, *args, **kwargs):
    """``fn`` with every tensor product summed in float64 (and rounded to
    float32): the plain version in another summation order."""
    matmul = torch.Tensor.__matmul__
    torch.Tensor.__matmul__ = lambda a, b: torch.matmul(a.double(), b.double()).float()
    try:
        return fn(*args, **kwargs)
    finally:
        torch.Tensor.__matmul__ = matmul


def gate_reports(f, n_lvl, wid, n, k, lpg=4):
    """The gate's reports at row 1 of a seeded model: the plain vrow and row
    summed in float64 against float32, and the row at lpg 1 against lpg."""
    torch.manual_seed(0)
    pcnn = PixelCNN(num_indices=k, image_shape=(2, wid), dropout=0.0,
                    num_resnet=n_lvl // 2, num_filters=f, conditional_dim=16)
    gen = torch.Generator().manual_seed(0)
    vin, rin = sampler_chain.row1_inputs(pcnn, torch.randn(n, 16, generator=gen), n, gen,
                                         "bfloat16", lpg)
    kw = dict(compute_dtype="bfloat16")
    vrow = sampler_chain.vrow_bf16_report(float64_sums(sampler_chain.vrow_plain, *vin, **kw),
                                          sampler_chain.vrow_plain(*vin, **kw))
    want = sampler_chain.row_plain(*rin, with_logits=True, lpg=lpg, **kw)
    row = sampler_chain.row_bf16_report(
        float64_sums(sampler_chain.row_plain, *rin, with_logits=True, lpg=lpg, **kw),
        want, rin[10], lpg)
    wrong = sampler_chain.row_bf16_report(
        sampler_chain.row_plain(*rin, with_logits=True, lpg=1, **kw), want, rin[10], lpg)
    return vrow, row, wrong


def test_bf16_gate_separates_flips_from_a_wrong_cadence():
    vrow, row, wrong = gate_reports(8, 8, 4, 16, 12)
    assert sampler_chain.bf16_gate_ok(vrow), vrow
    assert sampler_chain.bf16_gate_ok(row), row
    assert not sampler_chain.bf16_gate_ok(wrong), wrong
    assert wrong["share"] > 5 * sampler_chain.BF16_SHARE, wrong


if __name__ == "__main__":
    for shape in ((128, 24, 16, 16, 512), (64, 12, 4, 32, 128)):
        vrow, row, wrong = gate_reports(*shape)
        print(f"F, L, W, n, K = {shape}: float64 sums against float32: vrow {vrow}, "
              f"row {row}; the row at lpg 1 against 4: {wrong}")
    for params in (dict(num_resnet=1, cond_dim=10), dict(num_resnet=3, cond_dim=None),
                   dict(num_resnet=4, cond_dim=10)):
        case = f"L{2 * params['num_resnet']}"
        check(run_case(params["num_resnet"], params["cond_dim"], 8, (5, 6), 2, 12), case)
