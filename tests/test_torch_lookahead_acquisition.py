"""The port's greedy acquisition against the JAX package's (split from
``tests/test_torch_lookahead.py``, whose recorded draws it uses, so that the
suite's workers run its eager JAX rollouts beside the rest): the
trajectories and one eval step, the JAX side run eagerly one instance at a
time and its draws stacked on axis 1, as that file's docstring says.
"""
import jax
import numpy as np
import pytest

from posterior_matching_torch import acquisition, convert
from posterior_matching_tpu import acquisition as jax_acq
from posterior_matching_tpu.models.lookahead import LookaheadPosterior as JaxLookahead
from test_torch_lookahead import (  # noqa: F401 (fixtures)
    ACQ_SAMPLES,
    EPISODE,
    MODELS,
    data,
    init_shapes,
    lookahead_config,
    record,
)
from test_torch_vae import close, randomize, t
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def acq_model():
    pm_cfg, shape, subsample = MODELS["conv"]
    cfg = lookahead_config(shape, subsample)
    x, b = data(shape, seed=2, n=2)
    jm = JaxLookahead.from_config(cfg, pm_cfg)
    params = randomize(init_shapes(jm, x, b), 8, std=0.4)
    port = convert.lookahead_from_jax(params, cfg, pm_cfg, device="cpu")
    return jm, params, port, x, b


def _stack(per_instance):
    """Per-instance draws ``[S, 1, L]`` -> the batch's ``[S, N, L]``, draw
    by draw."""
    return [t(np.concatenate(ds, axis=1)) for ds in zip(*per_instance)]


def test_trajectories_match_jax(acq_model, record):
    """Both rollouts of ``EPISODE`` steps from nothing observed."""
    jm, params, port, x, b = acq_model
    eval_fn = jax_acq.make_acquisition_eval_fn(jm, {"params": params}, ACQ_SAMPLES)
    collect = jax_acq.make_collect_trajectory_fn(eval_fn, EPISODE)
    want, per_instance = [], []
    with jax.disable_jit():
        for i in range(len(x)):
            record.clear()
            want.append(jax.device_get(collect(x[i], jax.random.PRNGKey(10 + i))))
            per_instance.append(list(record))
    assert all(len(r) == 2 * 2 * EPISODE for r in per_instance)
    got = acquisition.make_collect_trajectory_fn(
        acquisition.make_acquisition_eval_fn(port, ACQ_SAMPLES), EPISODE)(
        t(x), iter(_stack(per_instance)))
    for r, rollout in enumerate(("sampling", "lookahead")):
        g = {k: v.numpy() for k, v in got[r].items()}
        for i in range(len(x)):
            w = want[i][r]
            for k in ("sampling_action", "lookahead_action", "mask"):
                np.testing.assert_array_equal(g[k][i], np.asarray(w[k]), err_msg=f"{rollout} {k}")
            for k in ("rmse", "sampling_probs", "lookahead_probs", "reconstruction"):
                close(g[k][i], w[k], what=f"{rollout} {k}")
            assert g["mask"][i].shape == (EPISODE, *x.shape[1:])
            actions = g[f"{rollout}_action"][i]
            assert len(set(actions.tolist())) == EPISODE    # a new feature each step
            np.testing.assert_array_equal(g["mask"][i][-1].reshape(-1)[actions[:-1]], 1.0)


def test_eval_step_matches_jax(acq_model, record):
    jm, params, port, x, b = acq_model
    eval_fn = jax_acq.make_acquisition_eval_fn(jm, {"params": params}, ACQ_SAMPLES)
    want, per_instance = [], []
    with jax.disable_jit():
        for i in range(len(x)):
            record.clear()
            want.append(eval_fn(x[i] * b[i], b[i], jax.random.PRNGKey(i)))
            per_instance.append(list(record))
    assert all(len(r) == 2 for r in per_instance)
    got = acquisition.make_acquisition_eval_fn(port, ACQ_SAMPLES)(
        t(x * b), t(b), iter(_stack(per_instance)))
    for i in range(len(x)):
        for k in ("sampling_action", "lookahead_action"):
            assert int(got[k][i]) == int(want[i][k]), k
        for k in ("sampling_probs", "lookahead_probs", "reconstruction"):
            close(got[k][i], want[i][k], what=k)
