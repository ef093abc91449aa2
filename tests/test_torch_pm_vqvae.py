"""The whole imputation slice: the port's ``pm_vqvae_impute`` against the
unmodified JAX ``pm_vqvae_impute`` on the CPU, and a JAX-written
``train_state.pkl`` evaluated by the port in a process that never imports JAX.

The port gets the Gumbel noise the JAX sampler draws from its key: one
``split`` per pixel in raster order, ``gumbel(sub, (n, K))`` each
(``ops/sampler_chain.py:739-746``; ``jax.random.categorical`` is
``argmax(logits + gumbel)``). Imputations must agree to 1e-4 absolute: the
codes are equal, and the decoder adds float32 rounding of order 1e-6.
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from posterior_matching_tpu.models.pm_vqvae import PMVQVAE as JaxPMVQVAE
from posterior_matching_tpu.models.pm_vqvae import (
    pm_vqvae_impute as jax_pm_vqvae_impute,
)
from posterior_matching_tpu.train.state import TrainState, save_train_state
from posterior_matching_torch import convert
from posterior_matching_torch.models.pm_vqvae import pm_vqvae_impute
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-4
REPO = Path(__file__).resolve().parents[1]
VQ_CONFIG = {
    "output_channels": 3, "embedding_dim": 8, "num_embeddings": 16,
    "hidden_units": 8, "residual_blocks": 1, "residual_hidden_units": 4,
    "decay": 0.99, "use_ema": True, "commitment_cost": 0.25,
}
PC_CONFIG = {
    "image_shape": [4, 4], "num_resnet": 2, "num_hierarchies": 1,
    "num_filters": 8, "dropout": 0.0, "num_indices": 16,
}
COND_DIM = 6
NUM_SAMPLES = 3


def jax_key_noise(key, hgt, wid, n, num_idx):
    """The Gumbel noise the JAX samplers draw from ``key``: [H, W, n, K]."""
    def body(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.gumbel(sub, (n, num_idx), jnp.float32)

    _, noise = jax.lax.scan(body, key, None, length=hgt * wid)
    return np.array(noise).reshape(hgt, wid, n, num_idx)


@pytest.fixture(scope="module")
def slice_case():
    model = JaxPMVQVAE.from_config(COND_DIM, VQ_CONFIG, PC_CONFIG)
    rng = np.random.RandomState(0)
    x = rng.rand(2, 16, 16, 3).astype(np.float32)
    b = (rng.rand(2, 16, 16, 1) > 0.5).astype(np.float32)
    variables = model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(x), jnp.asarray(b),
        method=lambda m, x, b: (
            m(x, b, training=False),
            m.decode_code_samples(jnp.zeros((1, 2, 4, 4), jnp.int32)),
        ),
    )
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax_pm_vqvae_impute(
        model, variables, jnp.asarray(x), jnp.asarray(b), key,
        num_samples=NUM_SAMPLES,
    ))
    noise = jax_key_noise(key, 4, 4, NUM_SAMPLES * 2, 16)
    return variables, x, b, noise, want


def test_impute_matches_jax(slice_case):
    variables, x, b, noise, want = slice_case
    host = jax.tree.map(np.asarray, variables)
    model = convert.pm_vqvae_from_jax(
        host["params"], {"vq_ema": host["vq_ema"]}, COND_DIM, VQ_CONFIG,
        PC_CONFIG, device="cpu",
    )
    got = pm_vqvae_impute(
        model, torch.from_numpy(x), torch.from_numpy(b), NUM_SAMPLES,
        noise=torch.from_numpy(noise),
    )
    assert got.shape == want.shape == (2, NUM_SAMPLES, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_random_tree_has_the_jax_structure(slice_case):
    variables = slice_case[0]
    params, state = convert.random_pm_vqvae_tree(
        COND_DIM, VQ_CONFIG, PC_CONFIG, seed=0
    )
    want = jax.tree_util.tree_map(np.shape, jax.device_get(variables))
    got = jax.tree_util.tree_map(np.shape, {"params": params, **state})
    assert got == want


_PORT_EVAL = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from posterior_matching_torch.convert import load_pm_vqvae
    from posterior_matching_torch.models.pm_vqvae import pm_vqvae_impute
    from posterior_matching_torch.train.state import ForeignRecord, load_train_state

    run_dir = sys.argv[1]
    ts = load_train_state(run_dir + "/train_state.pkl")
    assert isinstance(ts.opt_state[0], ForeignRecord), type(ts.opt_state[0])
    model = load_pm_vqvae(run_dir, device="cpu")
    io = np.load(run_dir + "/io.npz")
    out = pm_vqvae_impute(
        model, torch.from_numpy(io["x"]), torch.from_numpy(io["b"]),
        int(io["num_samples"]), noise=torch.from_numpy(io["noise"]),
    )
    np.save(run_dir + "/port_imputations.npy", out.numpy())
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "optax",
                                           "posterior_matching_tpu"))
    print("LEAKED", leaked)
""")


def test_jax_checkpoint_evaluates_in_the_port_without_jax(slice_case, tmp_path):
    variables, x, b, noise, want = slice_case
    params = variables["params"]
    save_train_state(
        str(tmp_path / "train_state.pkl"),
        TrainState(
            params=params, state={"vq_ema": variables["vq_ema"]},
            opt_state=optax.adam(1e-3).init(params), step=3,
        ),
    )
    (tmp_path / "vqvae_config.json").write_text(json.dumps(VQ_CONFIG))
    (tmp_path / "config.json").write_text(
        json.dumps({"conditional_dim": COND_DIM, "pixel_cnn": PC_CONFIG})
    )
    np.savez(tmp_path / "io.npz", x=x, b=b, noise=noise, num_samples=NUM_SAMPLES)
    proc = subprocess.run(
        [sys.executable, "-c", _PORT_EVAL, str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "LEAKED []" in proc.stdout, proc.stdout
    got = np.load(tmp_path / "port_imputations.npy")
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
