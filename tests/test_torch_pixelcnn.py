"""The port's PixelCNN forward and ``log_prob`` against the JAX module.

The JAX side is ``PixelCNN(fused_chain=False)``: the unfused flax path, an
implementation independent of both chains. At dropout 0, on seeded codes
and conditions: logits within 1e-5 (float32 sums in another order over two
passes of two levels), the gradient of ``log_prob`` with respect to every
parameter and to the condition within 1e-4 x the gradient's scale, and the
masked-out taps of every masked conv get exactly zero gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from posterior_matching_tpu.models.pixelcnn import PixelCNN as JaxPixelCNN
from posterior_matching_torch.convert import pixel_cnn_state_dict, to_torch
from posterior_matching_torch.models.pixelcnn import PixelCNN

KW = dict(num_indices=12, image_shape=(4, 4), num_resnet=2, num_hierarchies=1,
          num_filters=8, dropout=0.0)
COND = 16


def _case():
    rng = np.random.RandomState(0)
    x = rng.randint(0, KW["num_indices"], (3, 4, 4)).astype(np.int32)
    cond = rng.randn(3, COND).astype(np.float32)
    jm = JaxPixelCNN(fused_chain=False, **KW)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(cond))
    port = PixelCNN(**KW, conditional_dim=COND)
    port.load_state_dict(to_torch(pixel_cnn_state_dict(jax.device_get(variables["params"]))))
    return jm, variables, port, x, cond


def test_logits_match_jax():
    jm, variables, port, x, cond = _case()
    want = jm.apply(variables, jnp.asarray(x), jnp.asarray(cond), training=False)
    got = port(torch.from_numpy(x), torch.from_numpy(cond))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_log_prob_gradients_match_jax():
    jm, variables, port, x, cond = _case()

    def f(params, c):
        return jnp.sum(jm.apply({"params": params}, jnp.asarray(x), c,
                                method=jm.log_prob) * jnp.arange(1.0, 4.0))

    jp, jc = jax.grad(f, argnums=(0, 1))(variables["params"], jnp.asarray(cond))
    tcond = torch.tensor(cond, requires_grad=True)
    lp = port.log_prob(torch.from_numpy(x), tcond)
    want_lp = jm.apply(variables, jnp.asarray(x), jnp.asarray(cond), method=jm.log_prob)
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(want_lp), rtol=1e-5)
    (lp * torch.arange(1.0, 4.0)).sum().backward()

    want = pixel_cnn_state_dict(jax.device_get(jp))
    grads = dict(port.named_parameters())
    assert set(want) == set(grads)
    for name, w in want.items():
        g = grads[name].grad.numpy()
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * scale, err_msg=name)
    np.testing.assert_allclose(tcond.grad.numpy(), np.asarray(jc), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jc).max()))

    # the taps a masked conv slices away get exactly zero gradient
    valid = {"vertical": (2, 3), "horizontal": (2, 2)}
    layers = port.layers
    for name in layers:
        if not name.endswith(("_conv_a", "_conv_b")):
            continue
        r1, c1 = valid["vertical" if "vertical" in name else "horizontal"]
        g = layers[name].kernel.grad.clone()
        assert g[:r1, :c1].abs().max() > 0, name
        g[:r1, :c1] = 0
        assert torch.count_nonzero(g) == 0, name
    for name, (r1, c1) in {"v_init": (2, 3), "h_init_up": (1, 3), "h_init_left": (2, 1)}.items():
        g = layers[name].kernel.grad.clone()
        g[:r1, :c1] = 0
        assert torch.count_nonzero(g) == 0, name
