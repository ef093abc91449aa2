"""The PM-VQVAE at ``compute_dtype=bfloat16`` against the JAX package, on
the CPU, at toy sizes (the tiny configs of ``tests/test_torch_pm_vqvae.py``,
the PixelCNN at 3 levels so that a segment of 2 has a tail of 1).

- A bf16 run directory (``config.json`` with ``"compute_dtype":
  "bfloat16"``, the seeded JAX-layout tree of ``convert.py`` saved by the
  JAX package) is read by ``convert.load_pm_vqvae`` into the bf16 model:
  its VQ-VAE's, partial encoder's and PixelCNN's convs at bf16, the
  conditional latents and the log-likelihood as JAX's
  ``PMVQVAE.from_config(..., compute_dtype="bfloat16")`` computes them.
- ``compute_dtype`` is placed with JAX's precedence (``pm_vqvae.py:
  50-57``), and any other dtype is refused by name.
- The PixelCNN's log-likelihood at bf16 in the three chain modes against
  JAX's fused chain (the Pallas interpreter) in the same mode, and against
  JAX's unfused path; bf16 against float32.
- The VQ-VAE's codes at bf16 against JAX's.
- ``train_pm_vqvae --config.compute_dtype bfloat16`` for 2 steps: its
  ``config.json`` read back by JAX's ``PMVQVAE.from_config``, its
  checkpoint evaluated by JAX, and a resumed run equal to the straight one.

Tolerances: JAX's bf16 ones (``tests/test_gated_chain.py:321-360``):
rtol 1e-2 on values. The port's chain rounds where JAX's fused chain rounds,
so against it the log-likelihoods agree to float32 rounding (measured
below 1e-6 relative); JAX's unfused path rounds each conv's output on its
own, so against it the bar is the 1e-2.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from posterior_matching_tpu.models.pixelcnn import PixelCNN as JaxPixelCNN
from posterior_matching_tpu.models.pm_vqvae import PMVQVAE as JaxPMVQVAE
from posterior_matching_tpu.train.state import TrainState as JaxTrainState
from posterior_matching_tpu.train.state import save_train_state as jax_save
from posterior_matching_torch import convert, train_pm_vqvae, train_vqvae
from posterior_matching_torch.data import sources
from posterior_matching_torch.models.pixelcnn import PixelCNN
from posterior_matching_torch.models.pm_vqvae import PMVQVAE, model_dtypes
from posterior_matching_torch.train.state import load_train_state
from test_torch_pm_vqvae import COND_DIM, VQ_CONFIG
from test_torch_resume_cli import _run
from test_torch_vqvae_cli import STAGE1, STAGE2
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PC_CONFIG = {"image_shape": [4, 4], "num_resnet": 3, "num_hierarchies": 1,
             "num_filters": 8, "dropout": 0.0, "num_indices": 16}
BF = torch.bfloat16
RTOL = 1e-2


@pytest.fixture(scope="module")
def tree():
    params, state = convert.random_pm_vqvae_tree(COND_DIM, VQ_CONFIG, PC_CONFIG, seed=3)
    rng = np.random.RandomState(2)
    x = rng.rand(3, 16, 16, 3).astype(np.float32)
    b = (rng.rand(3, 16, 16, 1) > 0.5).astype(np.float32)
    return params, state, x, b


def _jax(compute_dtype="bfloat16", fused=None):
    pc = dict(PC_CONFIG)
    if fused is not None:
        pc["fused_chain"] = fused
    return JaxPMVQVAE.from_config(COND_DIM, VQ_CONFIG, pc, compute_dtype=compute_dtype)


def _apply(model, params, state, x, b, **kw):
    return model.apply({"params": params, **state}, jnp.asarray(x), jnp.asarray(b), **kw)


def test_load_pm_vqvae_honours_a_bf16_run(tree, tmp_path):
    """Fault C3: the run's ``compute_dtype`` reaches every conv stack."""
    params, state, x, b = tree
    jax_save(str(tmp_path / "train_state.pkl"), JaxTrainState(
        params=params, state=state, opt_state=optax.adam(1e-3).init(params), step=1))
    (tmp_path / "vqvae_config.json").write_text(json.dumps(VQ_CONFIG))
    (tmp_path / "config.json").write_text(json.dumps(
        {"conditional_dim": COND_DIM, "pixel_cnn": PC_CONFIG, "compute_dtype": "bfloat16"}))
    model = convert.load_pm_vqvae(str(tmp_path), device="cpu")
    assert model.vqvae.encoder.enc_1.dtype == BF and model.vqvae.decoder.dec_1.dtype == BF
    assert model.vqvae.decoder.dec_3.dtype == torch.float32
    assert model.partial_encoder.encoder.enc_3.dtype == BF
    assert model.pixel_cnn.compute_dtype == BF
    xt, bt = torch.from_numpy(x), torch.from_numpy(b)
    with torch.no_grad():
        cond = model.conditional_latents(xt, bt)
        ll = model(xt, bt)
    jm = _jax(fused="interpret")
    want_cond = _apply(jm, params, state, x, b, method=jm.conditional_latents)
    want_ll = _apply(jm, params, state, x, b)
    assert cond.dtype == torch.float32 and ll.dtype == torch.float32
    np.testing.assert_allclose(cond.numpy(), np.asarray(want_cond), rtol=RTOL,
                               atol=RTOL * float(np.abs(want_cond).max()))
    np.testing.assert_allclose(ll.numpy(), np.asarray(want_ll), rtol=RTOL)
    # the float32 model of the same tree is another model
    f32 = convert.pm_vqvae_from_jax(params, state, COND_DIM, VQ_CONFIG, PC_CONFIG, device="cpu")
    with torch.no_grad():
        assert not torch.equal(f32.conditional_latents(xt, bt), cond)


@pytest.mark.parametrize("explicit,vq_key,pc_key,want_vq,want_pc", [
    ("bfloat16", None, None, "bfloat16", "bfloat16"),
    (None, "bfloat16", None, "bfloat16", "bfloat16"),
    ("bfloat16", "float32", "float32", "float32", "float32"),
], ids=["explicit", "vqvae_config", "keys_win"])
def test_compute_dtype_precedence_is_jax_s(explicit, vq_key, pc_key, want_vq, want_pc):
    vq, pc = dict(VQ_CONFIG), dict(PC_CONFIG)
    if vq_key is not None:
        vq["compute_dtype"] = vq_key
    if pc_key is not None:
        pc["dtype"] = pc_key
    jm = JaxPMVQVAE.from_config(COND_DIM, vq, pc, compute_dtype=explicit)
    jvq, jpc = dict(jm.vqvae_kwargs), dict(jm.pixel_cnn_kwargs)
    assert (jvq.get("compute_dtype"), jpc.get("dtype")) == (want_vq, want_pc)
    got_vq, got_pc = model_dtypes(vq, pc, explicit)
    assert (got_vq.get("compute_dtype"), got_pc.get("dtype")) == (want_vq, want_pc)
    model = PMVQVAE(COND_DIM, vq, pc, compute_dtype=explicit)
    dt = {"float32": torch.float32, "bfloat16": BF}
    assert model.vqvae.encoder.enc_1.dtype == dt[want_vq]
    assert model.partial_encoder.encoder.enc_1.dtype == dt[want_vq]
    assert model.pixel_cnn.compute_dtype == dt[want_pc]


@pytest.mark.parametrize("where", ["explicit", "vqvae_config", "pixel_cnn"])
def test_unknown_compute_dtype_is_refused_by_name(where):
    vq, pc = dict(VQ_CONFIG), dict(PC_CONFIG)
    explicit = "float16" if where == "explicit" else None
    if where == "vqvae_config":
        vq["compute_dtype"] = "float16"
    if where == "pixel_cnn":
        pc["dtype"] = "float16"
    with pytest.raises(ValueError, match="float16"):
        PMVQVAE(COND_DIM, vq, pc, compute_dtype=explicit)


@pytest.fixture(scope="module")
def pixel_cnn_case():
    rng = np.random.RandomState(1)
    x = rng.randint(0, 16, (2, 4, 4)).astype(np.int32)
    cond = rng.randn(2, COND_DIM).astype(np.float32)
    kw = {k: (tuple(v) if k == "image_shape" else v) for k, v in PC_CONFIG.items()}
    jm = JaxPixelCNN(fused_chain=False, dtype="bfloat16", **kw)
    # the port's seeded weights carried to JAX (JAX's eager init with a
    # condition takes tens of seconds), its structure JAX's init's
    torch.manual_seed(0)
    seeded = PixelCNN(**kw, conditional_dim=COND_DIM)
    variables = {"params": convert.pixel_cnn_tree(seeded.state_dict())}
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(cond))
    assert (jax.tree.map(lambda a: a.shape, shapes["params"])
            == jax.tree.map(lambda a: a.shape, variables["params"]))
    sd = convert.to_torch(convert.pixel_cnn_state_dict(variables["params"]))
    return kw, variables, sd, x, cond


@pytest.mark.parametrize("segment", ["stream", 1, 2])
def test_pixel_cnn_log_prob_matches_jax_fused_and_unfused(pixel_cnn_case, segment, monkeypatch):
    kw, variables, sd, x, cond = pixel_cnn_case
    port = PixelCNN(**kw, conditional_dim=COND_DIM, chain_segment=segment, dtype="bfloat16")
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port.log_prob(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
    monkeypatch.setenv("PM_TPU_CHAIN_SEGMENT", str(segment))
    fused = JaxPixelCNN(fused_chain="interpret", dtype="bfloat16", **kw)
    unfused = JaxPixelCNN(fused_chain=False, dtype="bfloat16", **kw)
    args = (variables, jnp.asarray(x), jnp.asarray(cond))
    want_fused = np.asarray(fused.apply(*args, method=fused.log_prob))
    want_unfused = np.asarray(unfused.apply(*args, method=unfused.log_prob))
    np.testing.assert_allclose(got, want_fused, rtol=1e-5)
    np.testing.assert_allclose(got, want_unfused, rtol=RTOL)
    # bf16 against float32, within the same bar
    f32 = PixelCNN(**kw, conditional_dim=COND_DIM, chain_segment=segment)
    f32.load_state_dict(sd)
    with torch.no_grad():
        ref = f32.log_prob(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    assert not np.array_equal(got, ref)


def test_vq_codes_at_bf16_match_jax(tree):
    """The bf16 encoder's codes against JAX's: equal but for near ties
    (counted), as many as JAX's own bf16 codes keep of its float32 ones."""
    params, state, x, _ = tree
    model = convert.pm_vqvae_from_jax(params, state, COND_DIM, VQ_CONFIG, PC_CONFIG,
                                      device="cpu", compute_dtype="bfloat16")
    f32 = convert.pm_vqvae_from_jax(params, state, COND_DIM, VQ_CONFIG, PC_CONFIG, device="cpu")
    with torch.no_grad():
        got = model.vqvae.encoding_indices(torch.from_numpy(x)).numpy()
        got32 = f32.vqvae.encoding_indices(torch.from_numpy(x)).numpy()
    codes = {}
    for dt in ("bfloat16", None):
        jm = _jax(dt)
        codes[dt] = np.asarray(jm.apply({"params": params, **state}, jnp.asarray(x),
                                        method=lambda m, x: m.vqvae.encoding_indices(x)))
    agree = (got == codes["bfloat16"]).mean()
    jax_kept = (codes["bfloat16"] == codes[None]).mean()
    np.testing.assert_array_equal(got32, codes[None])
    assert agree >= min(jax_kept, 0.98), (agree, jax_kept, (got == got32).mean())


@pytest.fixture(scope="module")
def mnist_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    (root / "mnist").mkdir()
    for split, n in {"train": 32, "test": 16}.items():
        arrays = sources._synthetic_image("mnist", split)
        np.savez(root / "mnist" / f"{split}.npz", **{k: v[:n] for k, v in arrays.items()})
    return root


def test_train_pm_vqvae_bf16_runs_resumes_and_crosses_to_jax(mnist_dir, tmp_path):
    torch.set_num_threads(1)
    vq = _run(train_vqvae.main, ["--config", "vqvae_mnist", "--device", "cpu",
                                 "--config.steps=1", "--config.validation_freq=1",
                                 "--config.seed=0", *STAGE1], mnist_dir, tmp_path / "vq")
    argv = ["--config", "pm_vqvae_mnist", "--device", "cpu", "--config.validation_freq=2",
            "--config.compute_dtype", "bfloat16", "--config.vqvae_dir", vq, *STAGE2]
    straight = _run(train_pm_vqvae.main, [*argv, "--config.steps=2", "--config.seed=5"],
                    mnist_dir, tmp_path / "straight")
    short = _run(train_pm_vqvae.main, [*argv, "--config.steps=1", "--config.seed=5"],
                 mnist_dir, tmp_path / "short")
    resumed = _run(train_pm_vqvae.main, [*argv, "--config.steps=2", "--resume_dir", short],
                   mnist_dir, tmp_path / "resumed")
    cfg = json.loads(open(os.path.join(straight, "config.json")).read())
    assert cfg["compute_dtype"] == "bfloat16"
    a = load_train_state(os.path.join(straight, "train_state.pkl"))
    r = load_train_state(os.path.join(resumed, "train_state.pkl"))
    flat = lambda t: jax.tree_util.tree_leaves((t.params, t.state))
    assert int(a.step) == int(r.step) == 2
    for u, v in zip(flat(a), flat(r)):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
    # JAX reads the run: its model is the bf16 one, and it scores the
    # checkpoint as the port's loader does
    vqc = json.loads(open(os.path.join(straight, "vqvae_config.json")).read())
    jm = JaxPMVQVAE.from_config(cfg["conditional_dim"], vqc, cfg["pixel_cnn"],
                                compute_dtype=cfg.get("compute_dtype"))
    assert dict(jm.pixel_cnn_kwargs)["dtype"] == "bfloat16"
    assert dict(jm.vqvae_kwargs)["compute_dtype"] == "bfloat16"
    rng = np.random.RandomState(0)
    x = rng.rand(2, 28, 28, 1).astype(np.float32)
    b = (rng.rand(2, 28, 28, 1) > 0.5).astype(np.float32)
    model = convert.load_pm_vqvae(straight, device="cpu")
    assert model.pixel_cnn.compute_dtype == BF
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(b)).numpy()
    want = np.asarray(jm.apply({"params": a.params, **a.state}, jnp.asarray(x), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=RTOL)
