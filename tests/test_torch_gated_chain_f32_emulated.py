"""The gated chain's pair and segment entry points, float32 builds
(``csrc/gated_levels_{fwd,bwd}.cu``), emulated on the CPU whole through the
port's wrappers and autograd Functions, against the plain float32 version
at 1e-4 of scale, the GPU tests' bound.

The emulation, the case and the wrappers' patches are
``test_torch_gated_chain_emulated.py``'s (which holds the bf16 builds'
cases); this file builds only the float32 libraries, so that the suite's
workers (``--dist loadfile``) build and run the two dtypes side by side.
Skips where no C++20 compiler is found.
"""
import pytest
import torch

from test_torch_gated_chain_emulated import (  # noqa: F401 (the fixture)
    L,
    TOL_F32,
    _case,
    _held,
    _run,
    chain_libraries,
    emulated,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def chain_libs(tmp_path_factory):
    return chain_libraries(tmp_path_factory, bf16=False)


@pytest.mark.parametrize("mode", ["segment"])
def test_float32_level_kernels_match_plain(emulated, mode):
    """The float32 build after the move of the carries into their own
    scratch: the segment's down pass against the plain float32 version."""
    case = _case(True, seed=9)
    case = (case[0].detach().float().requires_grad_(True),
            case[1].detach().float().requires_grad_(True),
            [tuple(t.detach().float().requires_grad_(True) for t in p) for p in case[2]],
            case[3], case[4])
    got_o, got_g = _run(mode, False, case, torch.float32, L)
    want_o, want_g = _run(mode, True, case, torch.float32, L)
    _held(got_o, want_o, TOL_F32, TOL_F32, f"{mode} outputs")
    _held(got_g, want_g, TOL_F32, TOL_F32, f"{mode} gradients")
