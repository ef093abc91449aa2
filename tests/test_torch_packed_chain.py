"""``packed_chain``: the PixelCNN chain's weights held in the stream
kernels' stacked layout by the Trainer (``PackedChainCodec``), against the
canonical path and the JAX package's codec, at a toy size (2 levels, 8
filters, 4x4 codes, a 16-wide condition).

- ``encode`` gives JAX's ``pack_chain_params`` of the same weights exactly
  (the same names and shapes), and ``decode_into`` inverts it bit for bit.
- The packed forward (plain path) equals the canonical forward bit for
  bit, dropout on; with another chain mode it is refused with JAX's text.
- Trained packed, the PM-VQVAE trainer's Adam steps equal the canonical
  trainer's bit for bit; ``ClippedAdam`` within 1e-6 of each tensor's scale
  (the global norm sums in another order), the scale floored at 1 as the
  port's tests take it (a bias that starts at 0 has moved 3e-3 in 3 steps,
  and a run has read 7.2e-9 apart in one: 2.4e-6 of that, 7.2e-9 of 1).
- The checkpoint holds canonical weights and the optimizer state in the
  JAX codec's layout: the same tree, keys and shapes as
  ``PackedChainCodec``'s ``multi_transform`` state, which an optax update
  takes as it takes its own; a packed run resumed at step 2 equals the
  straight run bit for bit.
"""
import jax
import numpy as np
import optax
import pytest
import torch

from posterior_matching_tpu.models.pixelcnn import PackedChainCodec as JaxCodec
from posterior_matching_tpu.models.pixelcnn import pack_chain_params
from posterior_matching_tpu.train.state import load_train_state as jax_load_train_state
from posterior_matching_torch import convert
from posterior_matching_torch.data.datasets import ArrayDataset
from posterior_matching_torch.models.pixelcnn import PackedChainCodec
from posterior_matching_torch.train import trainer as tr
from posterior_matching_torch.train.optim import ClippedAdam
from posterior_matching_torch.train.state import load_train_state
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

VQ = {"output_channels": 1, "embedding_dim": 8, "num_embeddings": 16, "hidden_units": 8,
      "residual_blocks": 1, "residual_hidden_units": 4, "decay": 0.99, "use_ema": True,
      "commitment_cost": 0.25}
PC = {"image_shape": [4, 4], "num_resnet": 2, "num_hierarchies": 1, "num_filters": 8,
      "dropout": 0.5, "num_indices": 16}
COND = 16
SCHEDULE = {"init_value": 1e-3, "decay_rate": 0.999, "transition_steps": 1}


def _model(seed=2):
    params, state = convert.random_pm_vqvae_tree(COND, VQ, PC, seed=seed)
    return convert.pm_vqvae_from_jax(params, state, COND, VQ, PC, device="cpu")


def _data(n=16):
    rng = np.random.RandomState(0)
    return {"image": rng.rand(n, 16, 16, 1).astype(np.float32),
            "mask": (rng.rand(n, 16, 16, 1) > 0.5).astype(np.float32)}


def test_encode_is_jax_pack_and_decode_inverts_it():
    model = _model()
    codec = PackedChainCodec(model)
    params = {n: p.detach() for n, p in model.named_parameters()}
    enc = codec.encode(params)
    jax_pc = convert.pixel_cnn_tree({k[len("pixel_cnn."):]: v for k, v in params.items()
                                     if k.startswith("pixel_cnn.")})
    want = jax.device_get(pack_chain_params(jax_pc, num_resnet=2, num_filters=8))
    got = {d: {k.split(".")[-1]: v.numpy() for k, v in enc.items()
               if k.startswith(f"pixel_cnn.packed.{d}.")} for d in ("up", "dn")}
    assert {d: sorted(v) for d, v in got.items()} == {d: sorted(v) for d, v in want.items()}
    for d in want:
        for k in want[d]:
            np.testing.assert_array_equal(got[d][k], np.asarray(want[d][k]), err_msg=f"{d}.{k}")
    assert set(enc) == (set(params) - set(codec.chain_names)) | {
        f"pixel_cnn.packed.{d}.{k}" for d in want for k in want[d]}
    # decode writes the stacks back exactly; the taps outside stay as they are
    out = {n: params[n].clone() for n in codec.chain_names}
    for t in out.values():
        t.add_(1.0)
    codec.decode_into(enc, out)
    for n in codec.chain_names:
        p = params[n]
        changed = out[n] != p
        if "conv" in n and n.endswith(".kernel"):
            assert torch.equal(out[n][changed], p[changed] + 1.0)   # the masked taps only
            assert changed.sum() < p.numel()
        else:
            assert not changed.any(), n


def test_packed_forward_equals_canonical():
    model = _model()
    codec = PackedChainCodec(model)
    x = torch.from_numpy(_data(4)["image"])
    b = torch.from_numpy(_data(4)["mask"])
    want = model(x, b, training=True, seed=7)
    codec.attach(model, codec.encode({n: p.detach().clone()
                                      for n, p in model.named_parameters()}))
    assert torch.equal(model(x, b, training=True, seed=7), want)
    model.pixel_cnn.chain_segment = 1
    with pytest.raises(ValueError, match="packed_chain requires the stream chain kernels"):
        model(x, b)


def _fit(packed, steps, optimizer=None, resume=None):
    """The PM-VQVAE trainer's setup (the VQ-VAE frozen, dropout on) for
    ``steps`` on shuffled batches of 4, Adam under the decay unless
    ``optimizer`` is given."""
    trainer = tr.Trainer(_model(), tr.pm_vqvae_loss, optimizer=optimizer or (
        lambda p: tr.Adam(p, tr.exponential_decay(**SCHEDULE))),
        trainable=lambda module, name: not module.startswith("vqvae"), seed=1,
        to_trees=convert.pm_vqvae_trees, from_trees=convert.pm_vqvae_state_dict,
        device="cpu", param_codec=PackedChainCodec if packed else None)
    trainer.fit(ArrayDataset(_data(), 4, shuffle=True, seed=0), steps, validation_freq=100,
                resume_from=resume)
    return trainer


def _state(trainer):
    trainer.sync_canonical()
    return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}


def test_adam_steps_packed_equal_canonical():
    canonical, packed = _state(_fit(False, 3)), _state(_fit(True, 3))
    for n, p in canonical.items():
        assert torch.equal(packed[n], p), n


def test_clipped_adam_steps_packed_within_1e6():
    opt = lambda p: ClippedAdam(p, tr.exponential_decay(**SCHEDULE), max_norm=1.0)
    canonical, packed = _state(_fit(False, 3, opt)), _state(_fit(True, 3, opt))
    init = {n: p.detach() for n, p in _model().named_parameters()}
    for n, p in canonical.items():
        scale = max(float(p.abs().max()), 1.0)
        assert float((packed[n] - p).abs().max()) <= 1e-6 * scale, n
    assert not torch.equal(canonical["pixel_cnn.layers.up_0_0_vertical_conv_a.kernel"],
                           init["pixel_cnn.layers.up_0_0_vertical_conv_a.kernel"])


def test_checkpoint_has_the_jax_codec_layout_and_resumes(tmp_path):
    straight = _fit(True, 4)
    half = _fit(True, 2)
    path = str(tmp_path / "half.pkl")
    half.save_checkpoint(path)
    ts = load_train_state(path)
    assert "packed" in str(ts.opt_state)
    # canonical weights in the checkpoint, equal to the model's
    sd = convert.pm_vqvae_state_dict(ts.params, ts.state)
    for n, p in _state(half).items():
        np.testing.assert_array_equal(sd[n], p.numpy(), err_msg=n)
    # the JAX codec's optimizer state: the same tree and shapes
    jts = jax_load_train_state(path)
    codec = JaxCodec(jts.params, num_resnet=2, num_filters=8)
    enc = codec.encode(jts.params)
    labels = jax.tree_util.tree_map_with_path(
        lambda path, _: "frozen" if path[0].key == "vqvae" else "trainable", enc)
    tx = optax.multi_transform({"trainable": optax.chain(
        optax.scale_by_adam(), optax.scale_by_schedule(optax.exponential_decay(**SCHEDULE)),
        optax.scale(-1.0)), "frozen": optax.set_to_zero()}, labels)
    want = tx.init(enc)
    assert jax.tree.structure(jts.opt_state) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(jts.opt_state), jax.tree.leaves(want)):
        assert np.shape(a) == np.shape(b)
    grads = jax.tree.map(lambda p: np.ones_like(p), enc)
    updates, _ = tx.update(grads, jts.opt_state, enc)
    assert all(np.isfinite(u).all() for u in jax.tree.leaves(updates))
    # resumed at step 2, the packed run is the straight one bit for bit
    resumed = _fit(True, 4, resume=ts)
    a, b = _state(resumed), _state(straight)
    for n in a:
        assert torch.equal(a[n], b[n]), n
    for k in straight.optimizer.mu:
        assert torch.equal(resumed.optimizer.mu[k], straight.optimizer.mu[k]), k
