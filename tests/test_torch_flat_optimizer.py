"""``flat_optimizer``: the PM-VDVAE's optimizer under the JAX package's
``group_by_shape`` (``posterior_matching_tpu/train/optim.py``), on the CPU
at toy sizes.

- ``GroupedClippedAdam`` against the per-tensor ``ClippedAdam``: the same
  parameters and moments, bit for bit, over three steps, with and without a
  clip that bites.
- Against the JAX chain under ``group_by_shape`` on a tiny PM-VDVAE's tree
  and the same gradients: the state the port writes has the structure and
  leaf shapes of the JAX package's ``init``, and after three updates the
  parameters and the JAX state's moments, read back by the port's plan,
  equal the port's within 1e-6 relative.
- Checkpoints crossing over in both directions with a JAX ``Trainer`` whose
  optimizer is ``group_by_shape`` of the clipped chain (as
  ``tests/test_torch_resume.py::test_resume_crosses_over`` does for the
  per-leaf layout), on an MLP whose leaves share shapes: within CROSS_TOL
  of scale of the JAX trainer's straight run. A state of the other layout is
  refused, naming it.
- ``train_pm_vdvae --config.model.compute_dtype bfloat16 --config.flat_
  optimizer True`` on the CPU at a tiny width: ``model_config.json`` carries
  ``compute_dtype``, the JAX package reads the checkpoint's optimizer state
  with its ``group_by_shape`` structure, ``--resume_dir`` continues it, and
  both VDVAE evals run on the run; a run the JAX package wrote in that
  layout resumes and evaluates in the port; and the same CLI over two gloo
  ranks writes one run in that layout.

The CLI runs are ``tests/test_torch_flat_optimizer_cli.py``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from torch import nn

from posterior_matching_tpu.data.datasets import ArrayDataset as JaxArrayDataset
from posterior_matching_tpu.train import Trainer as JaxTrainer
from posterior_matching_tpu.train.optim import group_by_shape, stacked_shape_mask
from posterior_matching_tpu.train.state import TrainState as JaxTrainState
from posterior_matching_tpu.train.state import load_train_state as jax_load
from posterior_matching_tpu.train.state import save_train_state as jax_save
from posterior_matching_torch import convert, eval_pm_vdvae_imputation, eval_pm_vdvae_likelihood
from posterior_matching_torch.data.datasets import ArrayDataset
from posterior_matching_torch.train import trainer as tr
from posterior_matching_torch.train.optim import ClippedAdam, GroupedClippedAdam
from posterior_matching_torch.train.state import load_train_state
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TINY_CONFIG = {
    "image_shape": (8, 8, 1),
    "encoder_blocks": "8x2,8d2,4x1,4d4,1x1",
    "decoder_blocks": "1x1,4m1,4x1,8m4,8x2",
    "latent_dim": 4,
    "width": 16,
    "bottleneck_multiple": 0.25,
    "no_bias_above": 64,
    "num_mixtures": 3,
}


def _jax_chain(clip, wd, lr):
    return group_by_shape(optax.chain(
        optax.clip_by_global_norm(clip), optax.scale_by_adam(),
        optax.add_decayed_weights(wd, mask=stacked_shape_mask()),
        optax.scale_by_schedule(lambda count: lr), optax.scale(-1.0)))


@pytest.mark.parametrize("scales", [(1.0, 2.0, 0.5), (1.0, 300.0, 2.0)], ids=["no_clip", "clip"])
def test_grouped_clipped_adam_equals_per_tensor_bit_for_bit(scales):
    rng = np.random.RandomState(5)
    shapes = {"a.kernel": (3, 4), "a.bias": (4,), "b.kernel": (3, 4), "b.bias": (4,),
              "c.kernel": (4, 2), "c.bias": (2,), "d.scale": ()}
    init = {n: np.asarray(rng.randn(*s), np.float32) for n, s in shapes.items()}
    grads = [{n: np.asarray(s * rng.randn(*shapes[n]), np.float32) for n in shapes}
             for s in scales]
    params = [{n: torch.from_numpy(v.copy()) for n, v in init.items()} for _ in range(2)]
    opts = [cls(p, lambda count: 1e-2 * (count + 1), 200.0, 0.1)
            for cls, p in zip((ClippedAdam, GroupedClippedAdam), params)]
    assert [names for _, names in opts[1].groups] == [
        ["d.scale"], ["c.bias"], ["a.kernel", "b.kernel"], ["c.kernel"], ["a.bias", "b.bias"]]
    for g in grads:
        for opt in opts:
            opt.step({n: torch.from_numpy(v) for n, v in g.items()})
    for n in shapes:
        assert torch.equal(params[0][n], params[1][n]), n
        assert torch.equal(opts[0].mu[n], opts[1].mu[n]) and torch.equal(opts[0].nu[n],
                                                                          opts[1].nu[n]), n
    assert opts[0].count == opts[1].count == 3


def test_grouped_state_is_the_jax_layout_and_follows_its_updates(tmp_path):
    tree = convert.random_pm_vdvae_tree(TINY_CONFIG, seed=3)
    tx = _jax_chain(200.0, 0.1, 1e-3)
    jstate = tx.init(tree)
    jparams = tree
    sd = convert.pm_vdvae_state_dict(tree)
    params = {n: torch.from_numpy(np.array(v)) for n, v in sd.items()}
    opt = GroupedClippedAdam(params, lambda count: 1e-3, 200.0, 0.1)
    # the port's plan is group_by_shape's: shape groups in the order of
    # sorted(key=str), leaves in the tree's flattening order
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    names = [".".join(p.key for p in path) for path, _ in leaves]
    assert [n for _, group in opt.groups for n in group] == sorted(
        names, key=lambda n: (str((np.shape(sd[n]), np.dtype("float32"))), names.index(n)))
    rng = np.random.RandomState(2)
    for scale in (1.0, 1e4, 3.0):   # the second step's norm is past the clip
        g = jax.tree.map(lambda v: (scale * rng.randn(*np.shape(v))).astype(np.float32), tree)
        upd, jstate = jax.jit(tx.update)(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.step({n: torch.from_numpy(np.array(v))
                  for n, v in convert.pm_vdvae_state_dict(g).items()})
    path = str(tmp_path / "state.pkl")
    jax_save(path, JaxTrainState(params=jparams, state={}, opt_state=jstate, step=3))
    ts = load_train_state(path)
    count, mu, nu = convert.optax_moments(ts.opt_state, ts.params, grouped=True)
    assert count == 3
    close = lambda got, want: np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    for n, p in convert.pm_vdvae_state_dict(jax.device_get(jparams)).items():
        close(params[n].numpy(), p)
    for mine, theirs in ((opt.mu, mu), (opt.nu, nu)):
        for n, v in convert.pm_vdvae_state_dict(theirs).items():
            close(mine[n].numpy(), v)
    # the state the port writes, read back by the JAX package's own pickle
    like = lambda m: convert.pm_vdvae_trees({k: v.numpy() for k, v in m.items()})
    written = convert.optax_opt_state(opt.chain, opt.count, like(opt.mu), like(opt.nu),
                                      grouped=True)
    tr_path = str(tmp_path / "port.pkl")
    from posterior_matching_torch.train.state import TrainState, save_train_state
    save_train_state(tr_path, TrainState(params=ts.params, state={}, opt_state=written, step=3))
    back = jax_load(tr_path).opt_state
    assert jax.tree.structure(back) == jax.tree.structure(jstate)
    assert [np.shape(a) for a in jax.tree.leaves(back)] == [
        np.shape(a) for a in jax.tree.leaves(jstate)]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Trainers continuing each other's checkpoints
# ---------------------------------------------------------------------------

class JaxMLP(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        h = x
        for _ in range(3):
            h = jax.nn.relu(fnn.Dense(8)(h))
        return fnn.Dense(x.shape[-1])(h)


class Dense(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return x @ self.kernel + self.bias


class TorchMLP(nn.Module):
    """``JaxMLP`` under flax's names: two (8, 8) kernels, three (8,) biases."""

    def __init__(self):
        super().__init__()
        self.Dense_0, self.Dense_1, self.Dense_2 = Dense(4, 8), Dense(8, 8), Dense(8, 8)
        self.Dense_3 = Dense(8, 4)

    def forward(self, x):
        h = x
        for d in (self.Dense_0, self.Dense_1, self.Dense_2):
            h = torch.relu(d(h))
        return self.Dense_3(h)


X = np.random.RandomState(0).randn(64, 4).astype(np.float32)
# the two packages' four-layer products and gradients, summed in other
# orders, and the clip's norm, which JAX sums over the shape groups' stacks,
# drift apart over 20 steps (1.0e-5 of a moment's scale seen)
CROSS_TOL = 1e-4


def _jax_loss(params, state, key, step, batch, is_training):
    pred = JaxMLP().apply({"params": params}, batch["features"])
    return jnp.mean((pred - batch["features"]) ** 2), {}, state


def _jax_init(key, batch):
    return JaxMLP().init(key, batch["features"])["params"], {}


def _torch_loss(model, batch, seed, training):
    return ((model(batch["features"]) - batch["features"]) ** 2).mean()


def _datasets():
    return (JaxArrayDataset({"features": X}, 16, shuffle=True, seed=3),
            ArrayDataset({"features": X}, 16, shuffle=True, seed=3))


def _trainers(grouped=True):
    """The JAX trainer under group_by_shape of the clipped chain (a clip
    that bites) and the port trainer with ``GroupedClippedAdam`` (or the
    per-tensor ``ClippedAdam``)."""
    jt = JaxTrainer(_jax_loss, _jax_init, _jax_chain(0.05, 1e-3, 1e-2), seed=7)
    cls = GroupedClippedAdam if grouped else ClippedAdam
    pt = tr.Trainer(TorchMLP(), _torch_loss, optimizer=lambda p: cls(p, lambda c: 1e-2, 0.05, 1e-3),
                    to_trees=lambda sd: (convert.pm_vae_trees(sd), {}),
                    from_trees=lambda params, state: convert.pm_vae_state_dict(params),
                    device="cpu")
    return jt, pt


def _flat(ts, path):
    """The count, parameters and moments of a port or (through a checkpoint
    at ``path``) a JAX ``TrainState``."""
    if not isinstance(ts, tr.TrainState):
        jax_save(path, ts)
        ts = load_train_state(path)
    count, mu, nu = convert.optax_moments(ts.opt_state, ts.params, grouped=True)
    flat = convert.pm_vae_state_dict
    return count, {k: flat(t) for k, t in (("params", ts.params), ("mu", mu), ("nu", nu))}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_flat_optimizer_checkpoint_crosses_over(direction, tmp_path):
    path = str(tmp_path / "train_state.pkl")
    jt, pt = _trainers()
    jds, pds = _datasets()
    if direction == "jax_to_port":
        jax_save(path, jt.fit(jds, 10, validation_freq=100))
        pt.fit(pds, 20, validation_freq=100, resume_from=load_train_state(path))
        got = pt.train_state()
        start = None
    else:
        start = jax.device_get(jt.fit(_datasets()[0], 0, validation_freq=100).params)
        pt.init(convert.to_torch(convert.pm_vae_state_dict(start)))
        pt.fit(pds, 10, validation_freq=100)
        pt.save_checkpoint(path)
        got = jt.fit(jds, 20, validation_freq=100, resume_from=jax_load(path))
    jt2, _ = _trainers()
    want = jt2.fit(_datasets()[0], 20, validation_freq=100, initial_params=start)
    assert int(got.step) == int(want.step) == 20
    got, want = _flat(got, str(tmp_path / "got.pkl")), _flat(want, str(tmp_path / "want.pkl"))
    assert got[0] == want[0] == 20
    for kind in want[1]:
        for name, w in want[1][kind].items():
            g = got[1][kind][name]
            assert np.abs(g - w).max() <= CROSS_TOL * max(np.abs(w).max(), 1e-30), (kind, name)


def test_a_state_of_the_other_layout_is_refused(tmp_path):
    path = str(tmp_path / "train_state.pkl")
    jt, _ = _trainers()
    jax_save(path, jt.fit(_datasets()[0], 2, validation_freq=100))
    _, per_tensor = _trainers(grouped=False)
    with pytest.raises(ValueError, match="flat_optimizer"):
        per_tensor.fit(_datasets()[1], 3, validation_freq=100,
                       resume_from=load_train_state(path))
    _, grouped = _trainers()
    grouped.fit(_datasets()[1], 2, validation_freq=100)
    ts = grouped.train_state()
    plain = convert.optax_opt_state(grouped.optimizer.chain, 2, *(
        convert.pm_vae_trees({k: v.numpy() for k, v in m.items()})
        for m in (grouped.optimizer.mu, grouped.optimizer.nu)))
    _, again = _trainers()
    with pytest.raises(ValueError, match="group_by_shape"):
        again.fit(_datasets()[1], 3, validation_freq=100,
                  resume_from=tr.TrainState(params=ts.params, state={}, opt_state=plain, step=2))


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

TINY = ["--config.model.width=16", "--config.model.latent_dim=4",
        "--config.model.num_mixtures=2",
        "--config.model.encoder_blocks=28x2,28d4,7x2,7d7,1x2",
        "--config.model.decoder_blocks=1x2,7m1,7x2,28m7,28x2"]
EVALS = (
    (eval_pm_vdvae_imputation.main, ["--num_instances", "4", "--batch_size", "4",
                                     "--num_samples", "2", "--num_trials", "1"],
     "imputation_results"),
    (eval_pm_vdvae_likelihood.main, ["--num_instances", "4", "--batch_size", "4",
                                     "--batch_chunk", "4", "--num_samples", "2",
                                     "--num_trials", "1"], "likelihood_results"),
)
