"""Small helpers (counterpart of ``posterior_matching_tpu/utils.py``)."""
from __future__ import annotations

import math
import os
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from posterior_matching_torch.parallel import mesh


def logmeanexp(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``log(mean(exp(x)))`` along ``dim`` (``utils.py:105-108``)."""
    return torch.logsumexp(x, dim) - math.log(x.shape[dim])


def make_run_dir(path: str = "runs", prefix: Optional[str] = None) -> str:
    """Creates ``runs/<prefix>-<timestamp>/`` (``utils.py:50-57``); under a
    process group only rank 0 may (a run has one directory)."""
    mesh.require_rank0("the run directory")
    run_id = datetime.now().strftime("%Y%m%d-%H%M%S")
    if prefix is not None:
        run_id = prefix + "-" + run_id
    run_dir = os.path.join(path, run_id)
    os.makedirs(run_dir)
    return run_dir


def _concat(outs):
    """A list of like trees (dicts, tuples, tensors, arrays) -> one tree,
    each leaf concatenated on its leading axis in numpy."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _concat([o[k] for o in outs]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_concat(list(xs)) for xs in zip(*outs))
    return np.concatenate([x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
                           for x in outs], axis=0)


@torch.no_grad()
def batch_process(fn, dataset, generator: Optional[torch.Generator] = None,
                  device=None):
    """Applies ``fn`` to every batch of ``dataset`` and concatenates the
    outputs on the leading axis, in numpy (``utils.py:118-144``, without
    the mesh). ``fn(batch) -> tree``, or ``fn(batch, generator) -> tree``
    when ``generator`` is given: each batch gets a fresh generator on its
    device, seeded from a draw of ``generator``. With ``device`` each
    batch's arrays become tensors there first."""
    outs = []
    for batch in dataset:
        if device is not None:
            batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        if generator is None:
            outs.append(fn(batch))
        else:
            seed = int(torch.randint(0, 2**31 - 1, (), generator=generator,
                                     device=generator.device))
            outs.append(fn(batch, torch.Generator(device=generator.device).manual_seed(seed)))
    if not outs:
        raise ValueError("empty dataset")
    return _concat(outs)
