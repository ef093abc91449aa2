"""The hand-written sampler kernels against their plain PyTorch versions.

These need an NVIDIA GPU (sm_90a) and ``nvcc``; elsewhere they skip. On the
card: ``python -m pytest tests/test_torch_kernels_gpu.py -q -m cuda``. Shapes
are small but cover what the full-width smoke run does not: widths that do
not divide the vrow kernel's 32 row slots, sample counts that leave a
block's tile ragged, and two logits chunks. Tolerance: 1e-4 relative to the
tensor's scale (float32 sums in another order).
"""
import pytest
import torch

from posterior_matching_torch.ops import sampler_chain as sc

pytestmark = pytest.mark.cuda
F = 128
TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(gen, *shape, scale=1.0):
    return (scale * torch.randn(shape, generator=gen, device=gen.device)).contiguous()


def _close(got, want):
    err = (got - want).abs().max().item()
    return err / max(1.0, want.abs().max().item()) <= TOL


def _vrow_inputs(gen, n_lvl, wid, n):
    s = 0.05
    return (
        _rand(gen, wid, n, F), _rand(gen, wid, n, F), _rand(gen, wid, n, F),
        _rand(gen, n_lvl, wid, n, F), _rand(gen, n_lvl, wid, n, 2 * F),
        _rand(gen, n_lvl, n, 2 * F),
        _rand(gen, 6 * F, F, scale=s), _rand(gen, F, scale=s),
        _rand(gen, 3 * F, F, scale=s), _rand(gen, F, scale=s),
        _rand(gen, n_lvl, 12 * F, F, scale=s), _rand(gen, n_lvl, F, scale=s),
        _rand(gen, n_lvl, 12 * F, 2 * F, scale=s), _rand(gen, n_lvl, 2 * F, scale=s),
        _rand(gen, n_lvl, 2 * F, F, scale=s),
    )


@pytest.mark.parametrize("wid,n", [(16, 5), (7, 33), (1, 3)])
def test_vrow_kernel_matches_plain(dev, wid, n):
    gen = torch.Generator(device=dev).manual_seed(wid * 100 + n)
    args = _vrow_inputs(gen, 4, wid, n)
    before = sc.vrow.launches
    got = sc.vrow(*args)
    torch.cuda.synchronize()
    assert sc.vrow.launches == before + 1
    want = sc.vrow_plain(*args)
    for g, w in zip(got, want):
        assert _close(g, w)


@pytest.mark.parametrize("wid,n,k", [(16, 5, 512), (7, 13, 256)])
def test_row_kernel_matches_plain(dev, wid, n, k):
    gen = torch.Generator(device=dev).manual_seed(wid * 100 + n)
    n_lvl, s = 4, 0.05
    args = (
        _rand(gen, n_lvl, 12 * F, F, scale=s), _rand(gen, n_lvl, F, scale=s),
        _rand(gen, n_lvl, 8 * F, 2 * F, scale=s), _rand(gen, n_lvl, 2 * F, scale=s),
        _rand(gen, n_lvl, n, 2 * F),
        _rand(gen, n_lvl, wid, n, F), _rand(gen, n_lvl, wid, n, 2 * F),
        _rand(gen, n_lvl, wid, n, F), _rand(gen, wid, n, F), _rand(gen, wid, n, F),
        sc.gumbel_noise((wid, n, k), gen, dev),
        _rand(gen, k, F, scale=s), _rand(gen, F, k, scale=s), _rand(gen, k, scale=s),
        _rand(gen, 2 * F, F, scale=s), _rand(gen, F, scale=s),
    )
    before = sc.row.launches
    got = sc.row(*args, with_logits=True)
    torch.cuda.synchronize()
    assert sc.row.launches == before + 1
    want = sc.row_plain(*args, with_logits=True)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)
    for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        assert _close(g, w)


def test_kernel_wrappers_refuse_unsupported_shapes(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    args = list(_vrow_inputs(gen, 4, 16, 5))
    args[0] = args[0][:, :, :64].contiguous()  # e2 narrower than F
    with pytest.raises(ValueError, match="e2"):
        sc.vrow(*args)
    with pytest.raises(ValueError, match="mixed devices"):
        sc.vrow(*[a.cpu() if i == 1 else a for i, a in enumerate(_vrow_inputs(gen, 4, 16, 5))])
