"""Checkpoints cross over between the port and the JAX package, both ways.

A ``train_state.pkl`` written by the port's ``Trainer`` is read by the
unmodified JAX ``load_train_state`` in a process where ``torch`` (and so the
port) cannot be imported, and the JAX ``PMVQVAE`` evaluates it: the
log-likelihood equals the port's within 1e-5 relative (float32 convolutions
summed in another order). And the weights bridge is exact both ways: a JAX
tree sent to the port and back through ``convert.py`` is bit for bit the
tree it was. The same holds for PM-VDVAE: a checkpoint of the port's VDVAE
trainer serves ``vdvae_impute`` in the JAX package without torch, from its
EMA parameters, whose masked-encoder activations equal the port's within
1e-5 relative; a JAX-written run directory loads through
``load_pm_vdvae``, which takes ``ema_params`` when present, as the eval
scripts do (``eval_pm_vdvae_imputation.py:78-83``).
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from posterior_matching_tpu.models.pm_vqvae import PMVQVAE as JaxPMVQVAE
from posterior_matching_torch import convert
from posterior_matching_torch.config import PM_VDVAE_MNIST_TRAIN, PM_VQVAE_CELEB_A_TRAIN
from posterior_matching_torch.train import pm_vdvae_trainer, pm_vqvae_trainer

REPO = Path(__file__).resolve().parents[1]
VQ = {"output_channels": 3, "embedding_dim": 8, "num_embeddings": 16,
      "hidden_units": 8, "residual_blocks": 1, "residual_hidden_units": 4,
      "decay": 0.99, "use_ema": True, "commitment_cost": 0.25}
PC = {"image_shape": [4, 4], "num_resnet": 2, "num_hierarchies": 1,
      "num_filters": 8, "dropout": 0.5, "num_indices": 16}
COND = 6

_JAX_EVAL = textwrap.dedent("""
    import sys
    sys.modules["torch"] = None  # the JAX host has no torch
    import json
    import numpy as np
    import jax.numpy as jnp
    from posterior_matching_tpu.models.pm_vqvae import PMVQVAE
    from posterior_matching_tpu.train.state import TrainState, load_train_state

    run_dir = sys.argv[1]
    ts = load_train_state(run_dir + "/train_state.pkl")
    assert type(ts) is TrainState, type(ts)
    vq = json.load(open(run_dir + "/vqvae_config.json"))
    cfg = json.load(open(run_dir + "/config.json"))
    model = PMVQVAE.from_config(cfg["conditional_dim"], vq, cfg["pixel_cnn"])
    io = np.load(run_dir + "/io.npz")
    ll = model.apply({"params": ts.params, **ts.state}, jnp.asarray(io["x"]),
                     jnp.asarray(io["b"]), training=False)
    np.save(run_dir + "/jax_ll.npy", np.asarray(ll))
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                    ("torch", "posterior_matching_torch") and sys.modules[m] is not None)
    print("STEP", ts.step, "LEAKED", leaked)
""")


def test_port_checkpoint_evaluates_in_jax_without_torch(tmp_path):
    params, state = convert.random_pm_vqvae_tree(COND, VQ, PC, seed=1)
    model = convert.pm_vqvae_from_jax(params, state, COND, VQ, PC, device="cpu")
    trainer = pm_vqvae_trainer(model, PM_VQVAE_CELEB_A_TRAIN, seed=0, device="cpu")
    rng = np.random.RandomState(0)
    x = rng.rand(2, 16, 16, 3).astype(np.float32)
    b = (rng.rand(2, 16, 16, 1) > 0.5).astype(np.float32)
    trainer.train_step({"image": torch.from_numpy(x), "mask": torch.from_numpy(b)})
    trainer.save_checkpoint(str(tmp_path / "train_state.pkl"))
    (tmp_path / "vqvae_config.json").write_text(json.dumps(VQ))
    (tmp_path / "config.json").write_text(json.dumps({"conditional_dim": COND, "pixel_cnn": PC}))
    np.savez(tmp_path / "io.npz", x=x, b=b)
    with torch.no_grad():
        want = model(torch.from_numpy(x), torch.from_numpy(b), training=False).numpy()

    proc = subprocess.run([sys.executable, "-c", _JAX_EVAL, str(tmp_path)],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "STEP 1 LEAKED []" in proc.stdout, proc.stdout
    np.testing.assert_allclose(np.load(tmp_path / "jax_ll.npy"), want, rtol=1e-5)


def test_weights_round_trip_is_exact():
    model = JaxPMVQVAE.from_config(COND, VQ, PC)
    x = jnp.zeros((1, 16, 16, 3))
    variables = jax.device_get(model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        x, x[..., :1],
        method=lambda m, x, b: (m(x, b), m.decode_code_samples(jnp.zeros((1, 1, 4, 4), jnp.int32))),
    ))
    params, state = variables["params"], {"vq_ema": variables["vq_ema"]}
    port = convert.pm_vqvae_from_jax(params, state, COND, VQ, PC, device="cpu")
    params2, state2 = convert.pm_vqvae_trees(port.state_dict())
    flat = jax.tree_util.tree_flatten_with_path((params, state))
    flat2 = jax.tree_util.tree_flatten_with_path((params2, state2))
    assert flat[1] == flat2[1]
    for (path, a), (_, b_) in zip(flat[0], flat2[0]):
        assert a.dtype == b_.dtype and a.shape == b_.shape, path
        np.testing.assert_array_equal(a, b_, err_msg=jax.tree_util.keystr(path))


VDVAE = {"image_shape": [8, 8, 1], "encoder_blocks": "8x2,8d2,4x1,4d4,1x1",
         "decoder_blocks": "1x1,4m1,4x1,8m4,8x2", "latent_dim": 4, "width": 16,
         "bottleneck_multiple": 0.25, "no_bias_above": 64, "num_mixtures": 3}

_JAX_VDVAE_EVAL = textwrap.dedent("""
    import sys
    sys.modules["torch"] = None  # the JAX host has no torch
    import json
    import jax
    import numpy as np
    from posterior_matching_tpu.models.vdvae import PosteriorMatchingVDVAE, vdvae_impute
    from posterior_matching_tpu.train.state import TrainState, load_train_state

    run_dir = sys.argv[1]
    ts = load_train_state(run_dir + "/train_state.pkl")
    assert type(ts) is TrainState, type(ts)
    model = PosteriorMatchingVDVAE.from_config(json.load(open(run_dir + "/model_config.json")))
    params = ts.ema_params if ts.ema_params is not None else ts.params
    io = np.load(run_dir + "/io.npz")
    v = {"params": params}
    acts = model.apply(v, io["x"], io["b"], method=model.encode_masked)
    imp = vdvae_impute(model, v, io["x"], io["b"], jax.random.PRNGKey(0), num_samples=2)
    np.savez(run_dir + "/jax_out.npz", act1=np.asarray(acts[1]), imp=np.asarray(imp))
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in
                    ("torch", "posterior_matching_torch") and sys.modules[m] is not None)
    print("STEP", ts.step, "EMA", ts.ema_params is not None, "LEAKED", leaked)
""")


def test_port_vdvae_checkpoint_imputes_in_jax_without_torch(tmp_path):
    tree = convert.random_pm_vdvae_tree(VDVAE, seed=2)
    model = convert.pm_vdvae_from_jax(tree, VDVAE, device="cpu")
    trainer = pm_vdvae_trainer(model, PM_VDVAE_MNIST_TRAIN, seed=0, device="cpu")
    rng = np.random.RandomState(1)
    x = rng.randint(0, 256, (2, 8, 8, 1)).astype(np.float32)
    b = rng.binomial(1, 0.5, (2, 8, 8, 1)).astype(np.float32)
    trainer.train_step({"image": torch.from_numpy(x), "mask": torch.from_numpy(b)})
    trainer.save_checkpoint(str(tmp_path / "train_state.pkl"))
    (tmp_path / "model_config.json").write_text(json.dumps(VDVAE))
    np.savez(tmp_path / "io.npz", x=x, b=b)

    proc = subprocess.run([sys.executable, "-c", _JAX_VDVAE_EVAL, str(tmp_path)],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "STEP 1 EMA True LEAKED []" in proc.stdout, proc.stdout
    out = np.load(tmp_path / "jax_out.npz")
    assert out["imp"].shape == (2, 2, 8, 8, 1)
    obs = np.broadcast_to(b == 1, x.shape)
    for s in range(2):
        np.testing.assert_array_equal(out["imp"][:, s][obs], x[obs])
    # the EMA weights, not the trained ones, served the request
    ema = convert.load_pm_vdvae(str(tmp_path), device="cpu")
    with torch.no_grad():
        got = ema.encode_masked(torch.from_numpy(x), torch.from_numpy(b))[1].numpy()
    np.testing.assert_allclose(out["act1"], got, rtol=1e-5, atol=1e-6)
    assert not torch.equal(ema.decoder.gain, model.decoder.gain)


def test_jax_vdvae_run_dir_loads_with_ema_preferred(tmp_path):
    from posterior_matching_tpu.train.state import TrainState as JaxTrainState
    from posterior_matching_tpu.train.state import save_train_state as jax_save

    params = convert.random_pm_vdvae_tree(VDVAE, seed=5)
    ema = convert.random_pm_vdvae_tree(VDVAE, seed=6)
    (tmp_path / "model_config.json").write_text(json.dumps(VDVAE))
    for ema_params, want in ((ema, ema), (None, params)):
        jax_save(str(tmp_path / "train_state.pkl"),
                 JaxTrainState(params=params, state={}, ema_params=ema_params, step=3))
        model = convert.load_pm_vdvae(str(tmp_path), device="cpu")
        got = convert.pm_vdvae_trees(model.state_dict())
        flat = jax.tree_util.tree_flatten_with_path(want)
        flat2 = jax.tree_util.tree_flatten_with_path(got)
        assert flat[1] == flat2[1]
        for (path, a), (_, b_) in zip(flat[0], flat2[0]):
            np.testing.assert_array_equal(a, b_, err_msg=jax.tree_util.keystr(path))
