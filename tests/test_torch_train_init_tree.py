"""The port's initial PM-VDVAE tree against the JAX package's jitted ``init``
at a tiny hierarchy (split from ``tests/test_torch_train_cli.py``, so that
the suite's workers run its compile beside the CLI runs): the same names
and shapes, zeros where JAX's are, the gains equal.
"""
import jax
import numpy as np

from posterior_matching_torch import convert
from posterior_matching_torch.config import CONFIGS
from posterior_matching_tpu.models.vdvae import PosteriorMatchingVDVAE as JaxVDVAE
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_init_tree_has_the_jax_init_structure():
    config = dict(CONFIGS["pm_vdvae_mnist"]()["model"], image_shape=(8, 8, 1),
                  width=16, latent_dim=4, num_mixtures=2,
                  encoder_blocks="8x2,8d2,4x2,4d4,1x2", decoder_blocks="1x2,4m1,4x2,8m4,8x2")
    x = np.zeros((1, 8, 8, 1), np.float32)
    init = jax.jit(JaxVDVAE.from_config(dict(config, fused_chain=False)).init)
    want = init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, x, x)
    want = convert.pm_vdvae_state_dict(jax.device_get(want["params"]))
    got = convert.pm_vdvae_state_dict(convert.init_pm_vdvae_tree(config, seed=0))
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        assert np.all(got[name] == 0) == np.all(w == 0), name
        if name.endswith("gain"):
            np.testing.assert_array_equal(got[name], w)
