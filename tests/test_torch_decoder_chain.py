"""The port's decoder chain against the JAX package's.

- ``dec_chain_plain`` against the JAX ``dec_chain(..., interpret=True)``
  (the Pallas kernels in interpret mode) on the same numpy inputs and
  weights, at width 16, mid 8, ld 4: a 3x3 run (res 8, L = 3) and a 1x1 run
  (res 2, L = 2). All four outputs within 1e-5 of their scale (float32
  convolutions summed in another order); the cotangents of x0, acts, macts
  and the 34 weight stacks, under one random cotangent per output, within
  1e-4 of each gradient's scale (sums over the run's rows and levels in
  another order).
- The port's fused ``PosteriorMatchingVDVAE`` against the JAX package's
  ``fused_chain="interpret"`` on ``tests/test_decoder_chain.py``'s
  geometry, with the JAX normals recorded from the unfused JAX run (the
  fused JAX run draws the same bits through each block's own
  ``make_rng("sample")``): values rtol 2e-4 (atol 2e-4), gradients rtol
  5e-3, atol 1e-4, that file's tolerances.
- The port's fused model against its unfused one under one
  ``torch.Generator``, which shows that a fused run draws its normals in
  the unfused order: loss within 1e-6 relative, gradients within 1e-4 of
  each gradient's scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posterior_matching_tpu.distributions import normal as jax_normal
from posterior_matching_tpu.models.vdvae import PosteriorMatchingVDVAE as JaxVDVAE
from posterior_matching_tpu.ops import decoder_chain as jdc
from posterior_matching_torch import convert
from posterior_matching_torch.distributions import tril_size
from posterior_matching_torch.ops import decoder_chain as dc
from posterior_matching_torch.train.trainer import pm_vdvae_loss

WIDTH, MID, LD = 16, 8, 4
VALUE_TOL, GRAD_TOL = 1e-5, 1e-4
# tests/test_decoder_chain.py's KW: runs 4m1,4x2 and 8m4,8x3 fused, 1x2
# (2 rows at batch 2) unfused
KW = dict(
    image_shape=(8, 8, 1),
    encoder_blocks="8x2,8d2,4x2,4d4,1x2",
    decoder_blocks="1x2,4m1,4x2,8m4,8x3",
    latent_dim=4,
    width=16,
    bottleneck_multiple=0.5,
)


def _close_to_scale(got, want, tol, what=""):
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale, what


def _grad_close(got, want, what=""):
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * scale, err_msg=what)


def _case(seed, b, h, L, k):
    rng = np.random.RandomState(seed)
    ins = {n: rng.randn(b, h, h, WIDTH).astype(np.float32) for n in ("x0", "acts", "macts")}
    eps = rng.randn(L, b, h, h, LD).astype(np.float32)
    w = {n: (rng.randn(L, *s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in dc.weight_shapes(WIDTH, WIDTH, MID, LD, k)}
    return ins, eps, w


@pytest.mark.parametrize("b,h,L,k", [(2, 8, 3, 3), (2, 2, 2, 1)])
def test_plain_chain_matches_jax_kernels(b, h, L, k):
    ins, eps, w = _case(b * 10 + h, b, h, L, k)
    cot_rng = np.random.RandomState(7)
    out_shapes = [(b, h, h, WIDTH), (L, b, h, h, 2 * LD), (L, b, h, h, 2 * LD),
                  (L, b, h, h, LD + tril_size(LD))]
    cots = [cot_rng.randn(*s).astype(np.float32) for s in out_shapes]

    def jax_f(x0, acts, macts, w):
        outs = jdc.dec_chain(x0, acts, macts, jnp.asarray(eps), w, mid=MID, ld=LD,
                             tril=tril_size(LD), k=k, interpret=True)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, want), jgrads = jax.value_and_grad(jax_f, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(ins[n]) for n in ("x0", "acts", "macts")),
        {n: jnp.asarray(v) for n, v in w.items()})

    leaves = {n: torch.from_numpy(v).requires_grad_(True) for n, v in {**ins, **w}.items()}
    got = dc.dec_chain_plain(leaves["x0"], leaves["acts"], leaves["macts"],
                             torch.from_numpy(eps), {n: leaves[n] for n in w}, ld=LD, k=k)
    grads = dict(zip(leaves, torch.autograd.grad(got, list(leaves.values()),
                                                 [torch.from_numpy(c) for c in cots])))
    for name, g_, w_ in zip(("x_final", "post", "prior", "masked"), got, want):
        assert g_.shape == w_.shape, name
        _close_to_scale(g_.detach().numpy(), np.asarray(w_), VALUE_TOL, name)
    for i, name in enumerate(("x0", "acts", "macts")):
        _grad_close(grads[name].numpy(), np.asarray(jgrads[i]), name)
    assert set(jgrads[3]) == set(dc.NAMES) and len(dc.NAMES) == 34
    for name in dc.NAMES:
        _grad_close(grads[name].numpy(), np.asarray(jgrads[3][name]), name)


def test_weight_shapes_match_jax():
    for k in (1, 3):
        cfg = jdc.DecChainConfig(h=4, w=4, width=192, awidth=192, mid=48, ld=16,
                                 tril=tril_size(16), k=k)
        assert [(n, tuple(s)) for n, s in jdc.weight_shapes(cfg)] == dc.weight_shapes(
            192, 192, 48, 16, k)


def test_fused_run_split_follows_jax():
    """The port fuses the runs JAX fuses: at batch 2 the 1x2 run has 2 rows
    and stays unfused, the 4- and 8-runs (32 and 128 rows) fuse."""
    model = convert.pm_vdvae_from_jax(convert.random_pm_vdvae_tree(KW, seed=1),
                                      dict(KW, fused_chain=True), device="cpu")
    calls = []
    run = model.decoder._fused_run
    model.decoder._fused_run = lambda idxs, *a: (calls.append(idxs), run(idxs, *a))[1]
    x = torch.zeros(2, 8, 8, 1)
    with torch.no_grad():
        model(x, torch.ones_like(x), torch.Generator().manual_seed(0))
    assert calls == [[2, 3, 4], [5, 6, 7, 8]]
    assert not dc.dec_chain_supported(2, 1, 1) and dc.dec_chain_supported(2, 4, 4)


# ---------------------------------------------------------------------------
# The fused model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    rng = np.random.RandomState(3)
    x = rng.randint(0, 256, (2, 8, 8, 1)).astype(np.float32)
    b = (rng.rand(2, 8, 8, 1) > 0.5).astype(np.float32)
    tree = convert.random_pm_vdvae_tree(KW, seed=2)
    fused = convert.pm_vdvae_from_jax(tree, dict(KW, fused_chain=True), device="cpu")
    unfused = convert.pm_vdvae_from_jax(tree, KW, device="cpu")
    return tree, fused, unfused, x, b


@pytest.fixture
def record(monkeypatch):
    """The JAX side's standard normals in call order (eager ``apply`` of
    the unfused model: one posterior sample per decoder block)."""
    store = []

    def diag_sample(self, key, sample_shape=()):
        eps = jax.random.normal(key, tuple(sample_shape) + self.loc.shape, self.loc.dtype)
        if not isinstance(eps, jax.core.Tracer):
            store.append(np.asarray(eps))
        return self.loc + self.scale_diag * eps

    monkeypatch.setattr(jax_normal.MultivariateNormalDiag, "sample", diag_sample)
    return store


def _jax_loss(model, x, b):
    def f(params):
        out = model.apply({"params": params}, x, b, rngs={"sample": jax.random.PRNGKey(7)})
        return -jnp.mean(out["reconstruction_ll"] - out["kl"]) + jnp.mean(out["pm_kl"]), out
    return f


def test_fused_model_matches_jax_fused(models, record):
    tree, fused, _, x, b = models
    _jax_loss(JaxVDVAE(fused_chain=False, **KW), x, b)(tree)   # records the normals
    assert len(record) == 9
    eps = [torch.from_numpy(np.array(e)) for e in record]
    (loss_j, out_j), grads_j = jax.jit(jax.value_and_grad(
        _jax_loss(JaxVDVAE(fused_chain="interpret", **KW), x, b), has_aux=True))(tree)

    out = fused(torch.from_numpy(x), torch.from_numpy(b), iter(eps))
    for key in ("reconstruction_ll", "kl", "pm_kl"):
        np.testing.assert_allclose(out[key].detach().numpy(), np.asarray(out_j[key]),
                                   rtol=2e-4, atol=2e-4, err_msg=key)
    names, params = zip(*fused.named_parameters())
    loss = pm_vdvae_loss(fused, {"image": torch.from_numpy(x), "mask": torch.from_numpy(b)},
                         iter(eps))
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=2e-4)
    want = convert.pm_vdvae_state_dict(jax.device_get(grads_j))
    assert set(names) == set(want)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=5e-3, atol=1e-4, err_msg=name)


def test_fused_model_matches_unfused_under_one_generator(models):
    _, fused, unfused, x, b = models
    batch = {"image": torch.from_numpy(x), "mask": torch.from_numpy(b)}
    out = {}
    for name, m in (("fused", fused), ("unfused", unfused)):
        names, params = zip(*m.named_parameters())
        loss = pm_vdvae_loss(m, batch, torch.Generator().manual_seed(11))
        out[name] = (loss.item(), dict(zip(names, torch.autograd.grad(loss, params))))
    (lf, gf), (lu, gu) = out["fused"], out["unfused"]
    np.testing.assert_allclose(lf, lu, rtol=1e-6)
    assert set(gf) == set(gu)
    for name in gu:
        _grad_close(gf[name].numpy(), gu[name].numpy(), name)
