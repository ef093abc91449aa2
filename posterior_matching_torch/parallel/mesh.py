"""Data parallelism across processes, one GPU a rank, over
``torch.distributed``.

Counterpart of ``posterior_matching_tpu/parallel/mesh.py``: where the JAX
package puts a global batch on a 1-D device mesh under ``NamedSharding``
and lets XLA insert the collectives, the port runs one process a GPU,
each holding the whole model, and reduces explicitly:

- :func:`maybe_initialize_distributed` joins the process group that a
  launcher describes in the environment (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, as ``python -m
  torch.distributed.run`` sets them); without them it does nothing, and
  every path runs in one process as before;
- :func:`shard_batch` takes a rank's contiguous rows of a global batch, as
  the mesh's batch sharding places them (rows ``[r B / W, (r + 1) B /
  W)``), and refuses a batch that ``W`` does not divide;
- :func:`all_reduce_mean` / :func:`all_reduce_sum` reduce many tensors in
  one flat buffer and one ``all_reduce``;
- :func:`broadcast_module` and :func:`sync_generator` make the ranks'
  weights and a shared generator rank 0's;
- :func:`gather_rows` puts the ranks' rows back together in global order.

Every collective here is a ``broadcast`` or an ``all_reduce``: the gloo
backend has no other collective for CUDA tensors, and the two-ranks-on-one-
card check runs over gloo.
"""
from __future__ import annotations

import contextlib
import os
from datetime import timedelta
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, TypeVar, Union

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
BACKENDS = ("nccl", "gloo")
# A missing or dead peer fails a collective after this long instead of
# hanging it. Rank 0's validation callbacks, which the other ranks wait
# out at their next collective, take a few seconds at full width; the
# image evals run their embeddings and PRD on every rank, so that no
# collective waits on work that grows with the dataset.
TIMEOUT = timedelta(seconds=120)

Batch = TypeVar("Batch", Mapping, torch.Tensor)


def launched() -> bool:
    """True when the environment describes a process group."""
    return all(k in os.environ for k in LAUNCHER_ENV)


def refuse_ranks(cli: str, reason: str) -> None:
    """Raises, naming ``cli``, when a launcher asks for more than one rank
    (``WORLD_SIZE``, read before any process group exists): the CLIs that
    the JAX package runs on one device (``reason`` cites where) have no
    multi-GPU path in the port either."""
    w = int(os.environ.get("WORLD_SIZE", "1"))
    if w > 1:
        raise RuntimeError(f"{cli} runs on one device, as the JAX CLI does ({reason}); it was "
                           f"launched with WORLD_SIZE={w}: run it as one process")


def maybe_initialize_distributed(device: Optional[Union[str, torch.device]] = None,
                                 backend: Optional[str] = None,
                                 timeout: timedelta = TIMEOUT) -> bool:
    """Joins the launcher's process group; returns whether one is up.

    A no-op returning False without the launcher's environment. ``backend``
    is ``nccl`` for a GPU (``device`` None or CUDA) and ``gloo`` for
    ``device="cpu"`` unless given; ``gloo`` may be asked for on the GPU,
    ``nccl`` is refused on the CPU, and nothing falls back from one to the
    other. On the GPU the rank's current device becomes ``cuda:LOCAL_RANK``
    before the group starts (the kernels launch on the current device), and
    local rank 0 builds the kernels that are not built yet while the other
    ranks wait, so that the ranks do not all compile them at once."""
    if dist.is_initialized():
        return True
    if not launched():
        return False
    cuda = torch.device("cuda" if device is None else device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and not cuda:
        raise ValueError("the nccl backend needs the GPU; the CPU takes gloo")
    local_rank = int(os.environ["LOCAL_RANK"])
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("posterior_matching_torch: no CUDA device is available; pass "
                               "device='cpu' to run on the host")
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method="env://", timeout=timeout,
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    if cuda:
        if local_rank == 0:
            from posterior_matching_torch.ops import _build

            _build.build()
        dist.barrier()
    return True


@contextlib.contextmanager
def process_group(device: Optional[Union[str, torch.device]] = None,
                  backend: Optional[str] = None):
    """:func:`maybe_initialize_distributed` within, and the group it
    started (none where one was up already) destroyed after."""
    started = not distributed() and maybe_initialize_distributed(device, backend)
    try:
        yield
    finally:
        if started:
            dist.destroy_process_group()


def require_rank0(what: str) -> None:
    """Raises unless this is rank 0 (or the only process): ``what`` is
    written once, by rank 0."""
    if rank() != 0:
        raise RuntimeError(f"only rank 0 writes {what}; this is rank {rank()}")


def distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if distributed() else 1


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def shard_rows(n: int) -> Tuple[int, int]:
    """This rank's rows ``[lo, hi)`` of ``n``; raises unless the ranks
    divide ``n``."""
    w = world_size()
    if n % w:
        raise ValueError(f"a global batch of {n} rows does not divide over {w} ranks")
    per = n // w
    return rank() * per, (rank() + 1) * per


def shard_batch(batch: Batch) -> Batch:
    """This rank's contiguous rows of a global batch (a tensor or array, or
    a dict of them, all with the same leading size); the batch itself in
    one process."""
    if world_size() == 1:
        return batch
    if not isinstance(batch, Mapping):
        lo, hi = shard_rows(batch.shape[0])
        return batch[lo:hi]
    sizes = {v.shape[0] for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"the batch's entries have leading sizes {sorted(sizes)}")
    lo, hi = shard_rows(sizes.pop())
    return {k: v[lo:hi] for k, v in batch.items()}


# The bucket's copies in and its views out, each one call into C++ (the
# helpers torch's own DistributedDataParallel buckets with): a Python loop
# over a VDVAE's ~1000 tensors costs the host milliseconds a step.
def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return _flatten_dense_tensors([t.detach() for t in tensors])


def _unflat(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return list(_unflatten_dense_tensors(flat, like))


def _all_reduce(tensors: Sequence[torch.Tensor], mean: bool) -> List[torch.Tensor]:
    if not distributed() or not tensors:
        return list(tensors)
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"one bucket holds one dtype, not {sorted(map(str, dtypes))}")
    flat = _flat(tensors)
    dist.all_reduce(flat)
    if mean:
        flat.div_(world_size())
    return _unflat(flat, tensors)


def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The ranks' mean of each tensor (new tensors; one dtype), through one
    flat buffer and one ``all_reduce``; the tensors themselves in one
    process."""
    return _all_reduce(tensors, True)


def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The ranks' sum of each tensor, as :func:`all_reduce_mean`."""
    return _all_reduce(tensors, False)


def broadcast_module(module: nn.Module, src: int = 0) -> None:
    """Makes every parameter and buffer of ``module`` rank ``src``'s, one
    broadcast a dtype."""
    if not distributed():
        return
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in [*module.parameters(), *module.buffers()]:
        groups.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in groups.values():
            flat = _flat(group)
            dist.broadcast(flat, src)
            for t, v in zip(group, _unflat(flat, group)):
                t.copy_(v)


def sync_generator(generator: torch.Generator, src: int = 0) -> None:
    """Sets ``generator`` to rank ``src``'s state (a draw that only rank
    ``src`` made then counts as made on every rank)."""
    if not distributed():
        return
    state = generator.get_state()
    on = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    buf = state.to(on)
    dist.broadcast(buf, src)
    generator.set_state(buf.cpu())


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The ranks' row blocks of equal size concatenated in rank order: the
    global batch's rows, on every rank (rank 0 is the one that uses them).
    One broadcast from each rank, so the values are the ranks' bit for
    bit."""
    w = world_size()
    if w == 1:
        return t
    t = t.contiguous()
    out = torch.empty((w * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    for src, block in enumerate(out.chunk(w)):
        if src == rank():
            block.copy_(t)
        dist.broadcast(block, src)
    return out
