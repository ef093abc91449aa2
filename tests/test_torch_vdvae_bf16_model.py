"""The port's PM-VDVAE at bf16 against the JAX package's, unfused and fused
(the chains in interpret mode), from one key (split from
``tests/test_torch_vdvae_bf16.py``, whose data it uses, so that the suite's
workers run its JAX compiles beside the rest), at that file's MODEL_TOL.
"""
import jax
import numpy as np
import pytest
import torch

from posterior_matching_torch import convert
from posterior_matching_tpu.distributions import normal as jax_normal
from posterior_matching_tpu.models.vdvae import PosteriorMatchingVDVAE as JaxVDVAE
from test_torch_vdvae_bf16 import (  # noqa: F401 (fixtures)
    KW,
    MODEL_TOL,
    data,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def jax_outputs(data):
    """The JAX model's outputs at bf16, unfused and fused (the chains in
    interpret mode), from one key, and the standard normals of the unfused
    run in call order (recorded by an ordered callback in the replaced
    ``MultivariateNormalDiag.sample``; the fused decoder draws the same bits
    through each block's own key)."""
    tree, x, b = data
    store = []

    def diag_sample(self, key, sample_shape=()):
        eps = jax.random.normal(key, tuple(sample_shape) + self.loc.shape, self.loc.dtype)
        jax.debug.callback(lambda e: store.append(np.asarray(e)), eps, ordered=True)
        return self.loc + self.scale_diag * eps

    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_normal.MultivariateNormalDiag, "sample", diag_sample)
        for fused in (False, True):
            jm = JaxVDVAE(fused_chain="interpret" if fused else False,
                          compute_dtype="bfloat16", **KW)
            outs[fused] = jax.device_get(jax.jit(lambda p: jm.apply(
                {"params": p}, x, b, rngs={"sample": jax.random.PRNGKey(7)}))(tree))
            jax.effects_barrier()
            if not fused:
                eps = [torch.from_numpy(np.array(e)) for e in store]
    return outs, eps


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_model_matches_jax_at_bf16(data, jax_outputs, fused):
    tree, x, b = data
    outs, eps = jax_outputs
    assert len(eps) == 9   # one posterior sample per decoder block
    port = convert.pm_vdvae_from_jax(tree, dict(KW, fused_chain=fused,
                                                compute_dtype="bfloat16"), device="cpu")
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(b), iter(eps))
    for key in ("reconstruction_ll", "kl", "pm_kl"):
        assert out[key].dtype == torch.float32
        np.testing.assert_allclose(out[key].numpy(), np.asarray(outs[fused][key]),
                                   rtol=MODEL_TOL, err_msg=key)
