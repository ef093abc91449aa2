"""The port's plain block chain and encoder against the JAX package's.

The same numpy inputs and weights go through ``block_chain_plain`` and the
JAX ``block_chain(..., interpret=True)`` (the Pallas kernels run in
interpret mode), and through the unfused flax ``Block``s. Tolerances: values
within 1e-5 of the tensor's scale (float32 convolutions summed in another
order); gradients of x0 and of all 8 weight stacks within 2e-4 relative or
1e-5 absolute, the JAX package's own fused-against-unfused tolerance
(``tests/test_block_chain.py:50-77``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posterior_matching_tpu.models.vdvae import Encoder as JaxEncoder
from posterior_matching_tpu.ops.block_chain import block_chain as jax_block_chain
from posterior_matching_torch import convert
from posterior_matching_torch.models.vdvae import Encoder
from posterior_matching_torch.ops import block_chain as bc

ENC_KW = dict(width=16, blocks="8x3,8d2,4x2,4d4,1x2", bottleneck_multiple=0.5)
VALUE_TOL = 1e-5


def _close_to_scale(got, want, tol=VALUE_TOL, what=""):
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale, what


def _case(seed, b, h, L, k, c=16, mid=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, h, c).astype(np.float32)
    w = {n: (rng.randn(L, *s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in bc.weight_shapes(c, mid, k)}
    return x, w


def _jax_chain(x, w, mid, k, cot):
    def f(x, w):
        out = jax_block_chain(x, w, mid=mid, k=k, interpret=True)
        return jnp.sum(out * cot), out
    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), {n: jnp.asarray(v) for n, v in w.items()})
    return np.asarray(out), np.asarray(grads[0]), {n: np.asarray(v) for n, v in grads[1].items()}


def _port_chain(x, w, mid, k, cot):
    leaves = {"x": torch.from_numpy(x).requires_grad_(True),
              **{n: torch.from_numpy(v).requires_grad_(True) for n, v in w.items()}}
    out = bc.block_chain_plain(leaves["x"], {n: leaves[n] for n in w}, mid=mid, k=k)
    grads = torch.autograd.grad(out, list(leaves.values()), torch.from_numpy(cot))
    return out.detach().numpy(), dict(zip(leaves, (g.numpy() for g in grads)))


@pytest.mark.parametrize("b,h,L,k", [(2, 8, 3, 3), (4, 4, 2, 3), (2, 1, 2, 1)])
def test_plain_chain_matches_jax_kernels(b, h, L, k):
    x, w = _case(b * 10 + h, b, h, L, k)
    cot = np.random.RandomState(7).randn(*x.shape).astype(np.float32)
    want, gx, gw = _jax_chain(x, w, 8, k, cot)
    got, grads = _port_chain(x, w, 8, k, cot)
    _close_to_scale(got, want, what="values")
    np.testing.assert_allclose(grads["x"], gx, rtol=2e-4, atol=1e-5, err_msg="dx0")
    for n in bc.NAMES:
        np.testing.assert_allclose(grads[n], gw[n], rtol=2e-4, atol=1e-5, err_msg=n)


def test_weight_shapes_match_jax():
    from posterior_matching_tpu.ops.block_chain import BlockChainConfig, weight_shapes

    for k in (1, 3):
        cfg = BlockChainConfig(h=4, w=4, cin=192, mid=48, k=k)
        assert [(n, tuple(s)) for n, s in weight_shapes(cfg)] == bc.weight_shapes(192, 48, k)


@pytest.fixture(scope="module")
def encoders():
    x = np.random.RandomState(1).randn(4, 8, 8, 1).astype(np.float32)
    jenc = JaxEncoder(fused_chain=False, **ENC_KW)
    params = jax.device_get(jenc.init(jax.random.PRNGKey(0), x)["params"])
    enc = Encoder(1, ENC_KW["width"], ENC_KW["blocks"], ENC_KW["bottleneck_multiple"])
    enc.load_state_dict(convert.to_torch(convert.pm_vdvae_state_dict(params)))
    return jenc, params, enc, x


def test_encoder_matches_unfused_jax_blocks(encoders):
    """The port's encoder sends the runs 8x3, 4x2 and 1x2 through the chain
    (the plain path here) and the downsampling blocks through ``Block``."""
    jenc, params, enc, x = encoders
    want = jenc.apply({"params": params}, x)
    got = enc(torch.from_numpy(x))
    assert set(got) == set(want) == {8, 4, 1}
    for res in want:
        _close_to_scale(got[res].detach().numpy(), np.asarray(want[res]), what=f"res {res}")


def test_encoder_gradients_match_unfused_jax_blocks(encoders):
    jenc, params, enc, x = encoders

    def loss(p, x):
        return sum(jnp.sum(a ** 2) for a in jenc.apply({"params": p}, x).values())

    v_j, (g_p, g_x) = jax.value_and_grad(loss, argnums=(0, 1))(params, x)
    xt = torch.from_numpy(x).requires_grad_(True)
    v_t = sum((a ** 2).sum() for a in enc(xt).values())
    names = [n for n, _ in enc.named_parameters()]
    grads = torch.autograd.grad(v_t, [xt, *enc.parameters()])
    np.testing.assert_allclose(v_t.item(), float(v_j), rtol=1e-5)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(g_x), rtol=2e-4, atol=1e-5)
    want = convert.pm_vdvae_state_dict(jax.device_get(g_p))
    assert set(names) == set(want)
    for name, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=2e-4, atol=1e-5, err_msg=name)
