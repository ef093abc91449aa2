"""The training runtime: one optimizer step at a time, on the GPU.

Counterpart of ``posterior_matching_tpu/train/trainer.py`` (:185-272, the
update step), for a ``torch.nn.Module``:

- parameters that a ``trainable`` predicate on the module path refuses
  (``not path.startswith("vqvae")``: ``train_pm_vqvae.py:177-179``;
  ``"partial_" in path``: ``train_pm_vade.py:98-100``) get no gradient,
  no update and no optimizer state;
- the prologue (mask generation, PM-VAE's training noise) runs on the
  device from an explicit generator, seeded from (run seed, step), and
  validation may run another one (``val_prologue_fn``: PM-VAE's adds no
  noise, ``datasets.py:460-465``); the dropout seed of a step is derived
  from (run seed, step) as well, so a step is a function of the run seed,
  the step and the batch;
- loss, backward, the optimizer's update (:mod:`posterior_matching_torch.
  train.optim`: Adam at a constant rate for the VQ-VAE, under the
  exponential decay for PM-VQVAE, the clipped chain of
  ``train_pm_vdvae.py`` for PM-VDVAE, that chain without the clip for
  PM-VAE) and ``step + 1``, in that
  order; optionally the whole update is skipped when the loss or a raw
  gradient is not finite (the parameters, the optimizer's state and the
  model's buffers, which the forward may have moved, all kept as they
  were: :247-251), and an EMA of the parameters is kept;
- checkpoints are ``train_state.pkl`` files in the JAX package's layout
  (:func:`posterior_matching_torch.train.state.save_train_state`), the
  optimizer's state in the layout its optax chain inits to
  (``convert.optax_opt_state``), which the JAX package evaluates and
  resumes;
- :meth:`Trainer.fit` validates as the JAX trainer does (:612-661),
  calling each callback's ``on_validation_step`` on every validation
  batch (:644-646), and with ``resume_from`` continues a checkpoint of
  either package (:474-559): parameters and buffers, the optimizer's count
  and moments, the EMA parameters and the step restored, the batch stream
  moved on to the step (``ArrayDataset.skip_stream``). The model needs no
  batch to start (the JAX trainer's ``spec_batch`` init): its weights
  come from the checkpoint. With the run's seed, a resumed run draws what
  the straight run draws and equals it.

A loss function returns the scalar loss, or ``(loss, metrics)`` with a
dict of detached scalar metrics to log beside it. With ``pass_step`` it
also takes the step, as the JAX trainer's loss functions do (PM-VAE's KL
weight follows it).

Under a process group (:mod:`posterior_matching_torch.parallel.mesh`; the
JAX trainer's data mesh, :175-177 and :336-354) every rank holds the whole
model and a step computes what one process computes on the global batch:

- :meth:`Trainer.train_step` takes the global batch; its prologue runs on
  all of it from the step's shared seed (so the masks are the one-process
  run's), then the rank keeps its rows (:func:`~posterior_matching_torch.
  parallel.mesh.shard_batch`);
- the loss's own draws (dropout masks; PM-VDVAE's and PM-VAE's normals)
  come from stream 0's seed with the rank folded in (:meth:`Trainer.
  loss_seed`), so that the ranks draw different masks for their rows:
  equal to the one-process run in distribution, not bit for bit;
- the trainable gradients, the loss and the metrics are averaged over the
  ranks in one ``all_reduce`` (every loss is a batch mean, so the mean of
  the ranks' means is the global batch's); the clip of
  :class:`~posterior_matching_torch.train.optim.ClippedAdam` then sees the
  global gradient, as ``optax.clip_by_global_norm`` does under the mesh,
  and the skip of a non-finite step is the same on every rank (a NaN or an
  infinity on any rank reaches the reduced values of all);
- the ranks' parameters, optimizer state and EMA stay equal because each
  applies the same reduced update to the same weights: :meth:`Trainer.init`
  broadcasts rank 0's weights;
- validation shards each batch and averages the metrics over the ranks;
  :meth:`Trainer.fit` calls the ``on_validation_end`` callbacks (the
  checkpoint, the image logs) and prints on rank 0 only.

The JAX trainer's execution options (:134, :140-168, :468-473):

- ``steps_per_call=K``: :meth:`Trainer.fit` takes K optimizer steps a
  call, a chunk's host batches stacked and copied to the device at once, a
  shorter tail chunk where K does not divide the steps, and refuses a
  ``validation_freq`` that K does not divide. The steps keep their seeds,
  so a K-step run is the K=1 run bit for bit;
- a :class:`~posterior_matching_torch.data.datasets.DeviceDataset` for
  ``batches``: each step's indices drawn on the device, uniformly with
  replacement, from a generator seeded by (run seed, step, 6), the batch
  gathered and transformed there; a resume needs no replay;
- ``param_codec``: a factory ``model -> codec`` (:class:`~posterior_matching_
  torch.models.pixelcnn.PackedChainCodec`) of a training representation.
  The optimizer, its moments and the EMA work on the encoded tensors, which
  the model reads in its steps; validation, the callbacks and
  ``train_state.pkl`` see the canonical weights, decoded where they read
  them, and the checkpoint's optimizer state is in the JAX codec's layout.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from posterior_matching_torch.ops.gated_chain import _mix32_int
from posterior_matching_torch.parallel import mesh
from posterior_matching_torch.runtime import resolve_device
from posterior_matching_torch.train.callbacks import Callback
from posterior_matching_torch.train.optim import (
    EPS,
    OPTAX_ADAM,
    Adam,
    ClippedAdam,
    GroupedClippedAdam,
    trainable_names,
)
from posterior_matching_torch.train.schedules import (
    exponential_decay,
    get_beta_schedule,
    linear_schedule,
)
from posterior_matching_torch.train.state import TrainState, save_train_state

Tree = Dict[str, Any]

Batch = Dict[str, torch.Tensor]
# loss_fn(model, batch, seed, training[, step]) -> scalar loss, or (loss, metrics)
LossFn = Callable[..., Any]
# prologue_fn(batch, generator) -> batch, on the device
PrologueFn = Callable[[Batch, torch.Generator], Batch]
# to_trees(state_dict) -> (params, state) in the JAX package's layout
TreesFn = Callable[[Dict[str, torch.Tensor]], Tuple[Any, Any]]
# from_trees(params, state) -> state dict (numpy), the inverse of to_trees
FromTreesFn = Callable[[Tree, Tree], Dict[str, np.ndarray]]
# optimizer(trainable parameters) -> an object with step(grads),
# load_state(count, mu, nu), chain, count, mu, nu and params, as optim.Adam
OptimizerFn = Callable[[Dict[str, torch.Tensor]], Adam]


def derive_seed(seed: int, step: int, stream: int) -> int:
    """A 31-bit seed for ``stream`` (0: dropout, 1: prologue, 2: the
    validation at this step; 3 within a validation: a callback's draws; 4:
    the image callbacks' draws at the end of a validation; 5: a rank's
    share of a draw, ``step`` then the rank) of a step."""
    return _mix32_int(_mix32_int(_mix32_int(seed) ^ stream) ^ step) & 0x7FFFFFFF


@contextlib.contextmanager
def deterministic_convolutions(enabled: bool = True):
    """cuDNN's deterministic algorithms within, where ``enabled``. Its own
    choice includes weight-gradient algorithms whose sums land in another
    order from one call to the next, and Adam turns a last-bit difference in
    a near-zero gradient into a step of the learning rate: a trainer built
    with ``deterministic=True`` asks for them in its step, so that two runs
    of one seed, and a resumed run and the straight one, are the same bit
    for bit on the GPU."""
    kept = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = kept or enabled
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = kept


def _loss_and_metrics(out) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    return out if isinstance(out, tuple) else (out, {})


def _aggregate(metrics: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """Each metric's mean over the list (``trainer.py:665-674``)."""
    if not metrics:
        return {}
    return {k: sum(float(m[k].float().mean()) for m in metrics) / len(metrics)
            for k in metrics[0]}


class Trainer:
    def __init__(
        self,
        model: nn.Module,
        loss_fn: LossFn,
        *,
        optimizer: OptimizerFn,
        trainable: Optional[Callable[[str, str], bool]] = None,
        prologue_fn: Optional[PrologueFn] = None,
        val_prologue_fn: Optional[PrologueFn] = None,
        pass_step: bool = False,
        seed: int = 0,
        skip_nonfinite_updates: bool = False,
        zero_unused_grads: bool = False,
        ema_rate: Optional[float] = None,
        to_trees: Optional[TreesFn] = None,
        from_trees: Optional[FromTreesFn] = None,
        deterministic: bool = False,
        device: Optional[str] = None,
        steps_per_call: int = 1,
        param_codec: Optional[Callable[[nn.Module], Any]] = None,
    ):
        """``optimizer`` builds the optimizer from the trainable parameters;
        with ``ema_rate`` an EMA of the parameters is kept, and validation
        uses it (``use_ema_for_eval`` of the JAX trainer, which its one EMA
        caller sets); ``val_prologue_fn`` prepares validation batches
        (``prologue_fn`` when None); ``device``: the GPU unless ``"cpu"``
        (raises without a GPU); with ``zero_unused_grads`` a trainable
        parameter the loss does not use gets a zero gradient, as in JAX,
        where without it autograd raises; ``trainable`` as
        :func:`~posterior_matching_torch.train.optim.trainable_names` reads
        it; ``to_trees`` and ``from_trees`` map the model's state dict to
        the JAX package's ``(params, state)`` trees and back (the state
        dict as its own tree without them); with ``deterministic`` the step
        runs cuDNN's deterministic algorithms
        (:func:`deterministic_convolutions`); ``steps_per_call`` and
        ``param_codec`` as the module's notes say."""
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.make_optimizer = optimizer
        self.trainable = trainable
        self.prologue_fn = prologue_fn
        self.val_prologue_fn = val_prologue_fn if val_prologue_fn is not None else prologue_fn
        self.pass_step = pass_step
        self.seed = int(seed)
        self.skip_nonfinite = skip_nonfinite_updates
        self.zero_unused_grads = zero_unused_grads
        self.ema_rate = ema_rate
        self.to_trees = to_trees or (lambda sd: (sd, {}))
        self.from_trees = from_trees or (lambda params, state: params)
        self.deterministic = deterministic
        self.world_size, self.rank = mesh.world_size(), mesh.rank()
        self.steps_per_call = int(steps_per_call)
        self.param_codec = param_codec
        self.codec = None
        self.step = 0
        self.optimizer: Optional[Adam] = None
        # the parameters as the optimizer sees them: the model's own, or
        # with a codec the encoded tensors the model reads in its steps
        self.train_params: Dict[str, torch.Tensor] = {}
        self.ema_params: Optional[Dict[str, torch.Tensor]] = None

    def init(self, initial_state_dict: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Loads warm-start weights (a partial state dict overrides the
        model's own), freezes what ``trainable`` refuses and builds the
        optimizer over the rest, at step 0."""
        if initial_state_dict:
            sd = self.model.state_dict()
            unknown = set(initial_state_dict) - set(sd)
            if unknown:
                raise KeyError(f"unknown parameters: {sorted(unknown)[:5]}")
            sd.update(initial_state_dict)
            self.model.load_state_dict(sd)
        if self.world_size > 1:
            mesh.broadcast_module(self.model)
        params = dict(self.model.named_parameters())
        if self.param_codec is not None:
            self.codec = self.param_codec(self.model)
            for name in self.codec.chain_names:
                params[name].requires_grad_(False)
            encoded = self.codec.encode({n: p.detach() for n, p in params.items()})
            params = {n: params[n] if n in params else t.clone() for n, t in encoded.items()}
            self.codec.attach(self.model, params)
        self.train_params = params
        trainable = set(trainable_names(list(params), self.trainable))
        for name, p in params.items():
            p.requires_grad_(name in trainable)
        self.optimizer = self.make_optimizer(
            {n: p for n, p in params.items() if n in trainable}
        )
        if self.ema_rate is not None:
            self.ema_params = {n: p.detach().clone() for n, p in params.items()}
        self.step = 0

    def loss_seed(self, seed: int) -> int:
        """The seed of the loss's draws on this rank: ``seed`` in one
        process (and at one rank), else folded with the rank (stream 5)."""
        return seed if self.world_size == 1 else derive_seed(seed, self.rank, 5)

    def train_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """One update on the global batch; returns the step's metrics
        (device tensors, the ranks' mean)."""
        if self.optimizer is None:
            self.init()
        batch = self._prologue(batch, derive_seed(self.seed, self.step, 1), self.prologue_fn)
        batch = mesh.shard_batch(batch)
        kept = None
        if self.skip_nonfinite:
            kept = {n: b.detach().clone() for n, b in self.model.named_buffers()}
        self.model.train()
        names = list(self.optimizer.params)
        params = [self.optimizer.params[n] for n in names]
        with deterministic_convolutions(self.deterministic):
            loss, aux = _loss_and_metrics(
                self._loss(batch, self.loss_seed(derive_seed(self.seed, self.step, 0)), True))
            grads = torch.autograd.grad(loss, params, allow_unused=self.zero_unused_grads)
        if self.zero_unused_grads:
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        loss = loss.detach()
        if mesh.distributed():
            keys = list(aux)
            scalars = [loss, *(aux[k].to(self.device, torch.float32) for k in keys)]
            reduced = mesh.all_reduce_mean([*grads, *scalars])
            grads, loss = reduced[:len(grads)], reduced[len(grads)]
            aux = dict(zip(keys, reduced[len(grads) + 1:]))
        grads = dict(zip(names, grads))
        metrics = {**aux, "loss": loss}
        ok = True
        if self.skip_nonfinite:
            ok = bool(torch.isfinite(loss)) and all(
                bool(torch.isfinite(g).all()) for g in grads.values()
            )
            metrics["skipped"] = torch.tensor(float(not ok))
        if ok:
            self.optimizer.step(grads)
        elif kept:
            with torch.no_grad():
                for n, b in self.model.named_buffers():
                    b.copy_(kept[n])
        if self.ema_params is not None:
            with torch.no_grad():
                for n, p in self.train_params.items():
                    e = self.ema_params[n]
                    e.copy_(e * self.ema_rate + (1.0 - self.ema_rate) * p)
        self.step += 1
        return metrics

    def _loss(self, batch: Batch, seed: int, training: bool):
        step = (self.step,) if self.pass_step else ()
        return self.loss_fn(self.model, batch, seed, training, *step)

    def _prologue(self, batch: Batch, seed: int, prologue_fn: Optional[PrologueFn]) -> Batch:
        """The batch (tensors or numpy arrays) on the device, through
        ``prologue_fn`` with a generator seeded by ``seed``."""
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        if prologue_fn is None:
            return batch
        return prologue_fn(batch, torch.Generator(device=self.device).manual_seed(seed))

    @torch.no_grad()
    def validate(self, batches: Iterable[Batch],
                 callbacks: Sequence[Callback] = ()) -> Dict[str, float]:
        """The loss function's metrics (and ``loss``) averaged over
        ``batches``, not training, with the EMA parameters where the
        trainer keeps them, each batch through the validation prologue.
        Batch ``i``'s prologue and loss draw from seeds derived from (run
        seed, step, 2) and ``i``. Then each callback's
        ``on_validation_step(model, generator, batch)`` on every batch, on
        the device before the prologue, with the model's own parameters (as
        the JAX trainer hands its callbacks the train state, not the EMA)
        and a generator seeded from (run seed, step, 2), ``i`` and 3. Under
        a process group each batch is global: its prologue runs on all of
        it, the rank's rows go through the loss (with the rank folded into
        the loss's seed) and the means are averaged over the ranks."""
        if self.optimizer is None:
            self.init()
        base, out, seen = derive_seed(self.seed, self.step, 2), [], []
        with self.eval_parameters():
            for i, batch in enumerate(batches):
                batch = self._prologue(batch, 0, None)
                if callbacks:
                    seen.append(batch)
                batch = self._prologue(batch, derive_seed(base, i, 1), self.val_prologue_fn)
                loss, aux = _loss_and_metrics(self._loss(
                    mesh.shard_batch(batch), self.loss_seed(derive_seed(base, i, 0)), False))
                out.append({**aux, "loss": loss})
        for i, batch in enumerate(seen):
            gen = torch.Generator(device=self.device).manual_seed(derive_seed(base, i, 3))
            for cb in callbacks:
                cb.on_validation_step(self.model, gen, batch)
        logs = _aggregate(out)
        if mesh.distributed():
            keys = sorted(logs)
            means = mesh.all_reduce_mean(
                [torch.tensor([logs[k] for k in keys], dtype=torch.float64, device=self.device)])
            logs = dict(zip(keys, means[0].tolist()))
        return logs

    @contextlib.contextmanager
    def eval_parameters(self):
        """The model in eval mode with the parameters that validation uses:
        the EMA parameters where the trainer keeps them, its own restored
        after; with a codec the canonical weights decoded from them."""
        params = self.train_params
        kept = None
        with torch.no_grad():
            if self.ema_params is not None:
                kept = {n: p.detach().clone() for n, p in params.items()}
                for n, p in params.items():
                    p.copy_(self.ema_params[n])
            self.sync_canonical()
            try:
                self.model.eval()
                yield self.model
            finally:
                if kept is not None:
                    for n, p in params.items():
                        p.copy_(kept[n])
                    self.sync_canonical()

    @torch.no_grad()
    def sync_canonical(self) -> None:
        """With a codec, the model's canonical chain weights decoded from
        the encoded tensors (which the steps move); nothing without one."""
        if self.codec is not None:
            self.codec.decode_into(self.train_params, dict(self.model.named_parameters()))

    def fit(
        self,
        batches: Iterable[Batch],
        steps: int,
        callbacks: Sequence[Any] = (),
        val_batches: Optional[Iterable[Batch]] = None,
        validation_freq: int = 1000,
        resume_from: Optional[TrainState] = None,
    ) -> None:
        """Steps until ``self.step == steps``, cycling through ``batches``.
        After each step every plain callable of ``callbacks`` is called as
        ``cb(trainer, metrics)``. Every ``validation_freq`` steps and at the
        last, as the JAX trainer (``trainer.py:612-661``): the step metrics
        since the last validation averaged, ``steps_per_sec``, the ``val_``
        metrics of :meth:`validate` over ``val_batches`` (with the
        callbacks' ``on_validation_step``), each
        :class:`~posterior_matching_torch.train.callbacks.Callback`'s
        ``on_validation_end(train_state, step, logs)``, then prints one line
        ``[step s/S] k=v ...`` of the scalar logs (an image callback adds
        arrays). With ``resume_from`` (a ``TrainState`` of either package)
        the trainer first takes its state (:meth:`restore`) and ``batches``
        (an ``ArrayDataset``) moves on to its step (``skip_stream``). Under
        a process group every rank reads the same global stream and steps;
        the ``on_validation_end`` callbacks run and the line is printed on
        rank 0 only. With ``steps_per_call`` K the steps run in chunks of
        K (the last one shorter where K does not divide ``steps``), each
        chunk's host batches stacked and copied to the device at once;
        ``batches`` may be a :class:`~posterior_matching_torch.data.
        datasets.DeviceDataset`, which draws each step's batch on the
        device."""
        from posterior_matching_torch.data.datasets import DeviceDataset

        spc = self.steps_per_call
        if spc > 1 and validation_freq % spc != 0:
            raise ValueError(f"validation_freq={validation_freq} must be divisible by "
                             f"steps_per_call={spc}")
        if self.optimizer is None:
            self.init()
        device_resident = isinstance(batches, DeviceDataset)
        if resume_from is not None:
            self.restore(resume_from)
            if not device_resident:
                batches.skip_stream(self.step)

        def forever():
            while True:
                empty = True
                for b in batches:
                    empty = False
                    yield b
                if empty:
                    raise ValueError("empty dataset")

        def chunk(k: int) -> List[Batch]:
            """The next ``k`` steps' batches, on the device: a device-resident
            split's drawn from each step's seed."""
            if device_resident:
                return [batches.sample(torch.Generator(device=self.device).manual_seed(
                    derive_seed(self.seed, self.step + j, 6))) for j in range(k)]
            host = [next(it) for _ in range(k)]
            if k == 1:
                return host
            stacked = {key: torch.as_tensor(np.stack([np.asarray(b[key]) for b in host]))
                       .to(self.device) for key in host[0]}
            return [{key: v[j] for key, v in stacked.items()} for j in range(k)]

        per_step = [cb for cb in callbacks if not isinstance(cb, Callback)]
        on_validation = [cb for cb in callbacks if isinstance(cb, Callback)]
        it = None if device_resident else forever()
        pending, since, t_start = [], 0, time.time()
        while self.step < steps:
            for batch in chunk(min(spc, steps - self.step)):
                metrics = self.train_step(batch)
                for cb in per_step:
                    cb(self, metrics)
                pending.append(metrics)
                since += 1
            if self.step % validation_freq and self.step != steps:
                continue
            logs = _aggregate(pending)
            logs["steps_per_sec"] = since / max(time.time() - t_start, 1e-9)
            if val_batches is not None:
                val = self.validate(val_batches, [cb for cb in on_validation
                                                  if cb.has_validation_step()])
                logs.update({f"val_{k}": v for k, v in val.items()})
            if self.rank == 0:
                if on_validation:
                    state = self.train_state()
                    for cb in on_validation:
                        cb.on_validation_end(state, self.step, logs)
                print(f"[step {self.step}/{steps}] " + " ".join(
                    f"{k}={v:.5g}" for k, v in sorted(logs.items()) if np.ndim(v) == 0),
                    flush=True)
            pending, since, t_start = [], 0, time.time()

    def train_state(self) -> TrainState:
        """The state as the JAX package's ``TrainState`` holds it, the
        optimizer's in the layout of its optax chain, wrapped as the JAX
        trainer wraps a chain under a trainable predicate."""
        from posterior_matching_torch.convert import optax_opt_state

        self.sync_canonical()
        sd = self.model.state_dict()
        params, state = self.to_trees(sd)
        like = lambda tensors: self.to_trees({**sd, **tensors})[0]
        moments = like
        if self.codec is not None:
            # the moments in the JAX codec's encoded layout; the EMA canonical
            moments = lambda tensors: self.codec.jax_tree(like(tensors), tensors)
        opt_state = None
        if self.optimizer is not None:
            opt = self.optimizer
            opt_state = optax_opt_state(opt.chain, opt.count, moments(opt.mu),
                                        moments(opt.nu), self.trainable, opt.grouped)
        ema = None if self.ema_params is None else like(self._canonical(self.ema_params))
        return TrainState(params=params, state=state, opt_state=opt_state,
                          ema_params=ema, step=self.step)

    def _canonical(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Tensors keyed as :attr:`train_params` -> keyed by the model's
        parameter names (decoded with a codec)."""
        if self.codec is None:
            return tensors
        params = dict(self.model.named_parameters())
        out = {n: params[n].detach().clone() for n in self.codec.chain_names}
        self.codec.decode_into(tensors, out)
        return {**{n: t for n, t in tensors.items() if n in params}, **out}

    def _encoded(self, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The inverse of :meth:`_canonical`."""
        return tensors if self.codec is None else self.codec.encode(tensors)

    def restore(self, ts: TrainState) -> None:
        """Takes the state of a checkpoint of either package, in this
        order: the parameters and buffers (the VQ-VAE's EMA codebook
        among them), the optimizer's count and moments, the EMA
        parameters, the step. Raises, naming what is wrong, where the
        checkpoint does not fit this trainer: a missing or extra tensor, an
        optimizer state of another layout, no EMA parameters where the
        trainer keeps them."""
        from posterior_matching_torch.convert import optax_moments, to_torch

        if self.optimizer is None:
            self.init()
        self.model.load_state_dict(to_torch(self.from_trees(ts.params, ts.state)))
        if self.codec is not None:
            with torch.no_grad():
                enc = self._encoded({n: p.detach() for n, p in self.model.named_parameters()})
                for n, p in self.train_params.items():
                    p.copy_(enc[n])
        count, mu, nu = optax_moments(ts.opt_state, ts.params, self.trainable,
                                      self.optimizer.grouped)
        names = list(self.optimizer.params)
        moments = [self._encoded(to_torch(self.from_trees(tree, ts.state))) for tree in (mu, nu)]
        self.optimizer.load_state(count, *({k: m[k] for k in names} for m in moments))
        if self.ema_params is not None:
            if ts.ema_params is None:
                raise ValueError("the checkpoint has no ema_params, and this trainer keeps an EMA")
            ema = self._encoded(to_torch(self.from_trees(ts.ema_params, ts.state)))
            with torch.no_grad():
                for n, e in self.ema_params.items():
                    e.copy_(ema[n])
        self.step = int(ts.step)

    def save_checkpoint(self, path: str) -> None:
        save_train_state(path, self.train_state())


def pm_vqvae_loss(model, batch: Batch, seed: int, training: bool) -> torch.Tensor:
    """``-mean log p(codes | cond)`` (``train_pm_vqvae.py:144-159``)."""
    return -model(batch["image"], batch["mask"], training=training, seed=seed).mean()


def pm_vqvae_trainer(model, train_config: Dict[str, Any], *, seed: int = 0,
                     mask_fn=None, device: Optional[str] = None, **kwargs) -> Trainer:
    """The stage-2 trainer of ``train_pm_vqvae.py:144-193``: Adam under the
    exponential decay, the VQ-VAE frozen, masks added on the device by
    ``mask_fn`` (or passed in each batch when None), checkpoints in the JAX
    package's layout; cuDNN's deterministic algorithms, which cost this
    step nothing measurable on an H100 (``tools/step_timing.py``), so that
    a resumed run equals the straight one bit for bit."""
    from posterior_matching_torch.convert import pm_vqvae_state_dict, pm_vqvae_trees
    from posterior_matching_torch.masking import add_mask

    schedule = exponential_decay(**train_config["lr_schedule"])
    prologue = None
    if mask_fn is not None:
        prologue = lambda batch, gen: add_mask(batch, gen, mask_fn)
    return Trainer(
        model, pm_vqvae_loss,
        optimizer=lambda params: Adam(params, schedule),
        trainable=lambda module, name: not module.startswith("vqvae"),
        prologue_fn=prologue, seed=seed, to_trees=pm_vqvae_trees,
        from_trees=pm_vqvae_state_dict, deterministic=True, device=device, **kwargs,
    )


def vqvae_metrics(model, batch: Batch, seed: int, training: bool):
    """Stage 1's loss and the metrics ``perplexity``, ``reconstruction_loss``
    and ``vq_loss`` (``train_vqvae.py:84-98``); the codebook takes its EMA
    step on training batches only."""
    out = model(batch["image"], is_training=training)
    vq_out = out["vq_output"]
    return out["loss"], {"perplexity": vq_out["perplexity"].detach(),
                         "reconstruction_loss": out["reconstruction_loss"].detach(),
                         "vq_loss": vq_out["loss"].detach()}


def vqvae_trainer(model, train_config: Dict[str, Any], *, seed: int = 0,
                  device: Optional[str] = None, **kwargs) -> Trainer:
    """The stage-1 trainer of ``train_vqvae.py:84-112``: plain Adam at the
    constant ``learning_rate``, the codebook's EMA state advanced by the
    training forward and kept by validation, checkpoints in the JAX
    package's layout (``params`` and ``{"vq_ema": ...}``; with
    ``use_ema=False`` the codebook is a parameter Adam trains, and the state
    is empty); cuDNN's
    deterministic algorithms, as in :func:`pm_vqvae_trainer`."""
    from posterior_matching_torch.convert import vqvae_state_dict, vqvae_trees

    lr = train_config["learning_rate"]
    return Trainer(model, vqvae_metrics,
                   optimizer=lambda params: Adam(params, lambda count: lr, chain=OPTAX_ADAM),
                   seed=seed, to_trees=vqvae_trees,
                   from_trees=lambda params, state: vqvae_state_dict(params,
                                                                     state.get("vq_ema")),
                   deterministic=True, device=device, **kwargs)


def pm_vdvae_metrics(model, batch: Batch, noise, training: bool = True):
    """The loss ``-mean(reconstruction_ll - kl) + mean(pm_kl)`` and the
    metrics ``reconstruction_ll``, ``kl``, ``pm_kl`` (batch means) and
    ``bpd`` (``train_pm_vdvae.py:135-150``). ``noise``: an int seeds a
    generator on the model's device; a generator or an iterator of normals
    is used as given."""
    if isinstance(noise, int):
        noise = torch.Generator(device=model.device).manual_seed(noise)
    out = model(batch["image"], batch["mask"], noise)
    elbo = (out["reconstruction_ll"] - out["kl"]).mean()
    loss = -elbo + out["pm_kl"].mean()
    metrics = {k: out[k].detach().mean() for k in ("reconstruction_ll", "kl", "pm_kl")}
    metrics["bpd"] = -elbo.detach() / (math.prod(model.image_shape) * math.log(2))
    return loss, metrics


def pm_vdvae_loss(model, batch: Batch, noise, training: bool = True) -> torch.Tensor:
    """The loss of :func:`pm_vdvae_metrics` alone."""
    return pm_vdvae_metrics(model, batch, noise, training)[0]


def pm_vdvae_trainer(model, train_config: Dict[str, Any], *, seed: int = 0,
                     mask_fn=None, device: Optional[str] = None, **kwargs) -> Trainer:
    """The trainer of ``train_pm_vdvae.py:135-202``: nothing frozen, the
    clipped Adam chain under a constant rate (or a linear warm-up; under
    ``group_by_shape`` with ``flat_optimizer``: :class:`GroupedClippedAdam`,
    its checkpoint in that layout), updates
    skipped when the loss or a raw gradient is not finite, an EMA of the
    parameters, masks added on the device by ``mask_fn`` (or passed in each
    batch when None), the EMA parameters for validation, checkpoints in the
    JAX package's layout; cuDNN's own choice of algorithms, as the
    deterministic ones cost the fused step 5-8% on an H100
    (``tools/step_timing.py``): on the GPU a resumed run equals the
    straight one up to the order of cuDNN's sums."""
    from posterior_matching_torch.convert import pm_vdvae_state_dict, pm_vdvae_trees
    from posterior_matching_torch.masking import add_mask

    cfg = train_config
    warm_up, lr = cfg.get("warm_up", 0), cfg["lr"]
    schedule = linear_schedule(0.0, lr, warm_up) if warm_up > 0 else (lambda count: lr)
    # flat_optimizer: the chain under group_by_shape (train_pm_vdvae.py:167-186)
    adam = GroupedClippedAdam if cfg.get("flat_optimizer", False) else ClippedAdam
    optimizer = lambda params: adam(params, schedule, cfg["gradient_clip"],
                                    cfg.get("weight_decay", 0.0))
    prologue = None
    if mask_fn is not None:
        prologue = lambda batch, gen: add_mask(batch, gen, mask_fn)
    return Trainer(
        model, pm_vdvae_metrics, optimizer=optimizer, prologue_fn=prologue, seed=seed,
        skip_nonfinite_updates=True, ema_rate=cfg.get("ema_rate", 0.999),
        to_trees=lambda sd: (pm_vdvae_trees(sd), {}),
        from_trees=lambda params, state: pm_vdvae_state_dict(params), device=device, **kwargs,
    )


def pm_vae_prologue(data_config: Dict[str, Any], mask_fn, training: bool) -> Optional[PrologueFn]:
    """PM-VAE's batch prologue (``datasets.py:429-465``): in training,
    ``training_noise`` times standard normals added to ``features`` (the
    configuration's, when it has one), then the mask of ``mask_fn`` (when
    not None); the validation prologue adds no noise."""
    from posterior_matching_torch.masking import add_mask

    noise_std = data_config.get("training_noise") if training else None
    if mask_fn is None and noise_std is None:
        return None

    def prologue(batch: Batch, gen: torch.Generator) -> Batch:
        out = dict(batch)
        if noise_std is not None and "features" in out:
            x = out["features"]
            eps = torch.randn(x.shape, generator=gen, device=gen.device, dtype=x.dtype)
            out["features"] = x + noise_std * eps.to(x.device)
        if mask_fn is not None:
            out = add_mask(out, gen, mask_fn)
        return out

    return prologue


def pm_vae_loss_fn(config: Dict[str, Any], data_key: str) -> LossFn:
    """The PM-VAE training loss of ``train_pm_vae.py:49-77``: ``-mean(
    reconstruction_ll - beta kl) + matching_coef * -mean(matching_ll)`` with
    the beta schedule at the step, logged with each output's batch mean and
    ``beta``. Its ``noise``: an int seeds the sample and dropout generators
    on the model's device; a generator or an iterator of normals is used
    for the samples as given (then there is no dropout generator)."""
    beta_schedule = get_beta_schedule(config.get("beta"))
    matching_coef = config.get("matching_coef", 1.0)

    def loss_fn(model, batch: Batch, noise, training: bool, step: int):
        dropout = None
        if isinstance(noise, int):
            dropout = torch.Generator(device=model.device).manual_seed(derive_seed(noise, 0, 3))
            noise = torch.Generator(device=model.device).manual_seed(noise)
        out = model(batch[data_key], batch["mask"], noise, training=training, dropout=dropout)
        beta = beta_schedule(step)
        elbo = (out["reconstruction_ll"] - beta * out["kl"]).mean()
        loss = -elbo + matching_coef * -out["matching_ll"].mean()
        metrics = {k: v.detach().mean() for k, v in out.items()}
        metrics["beta"] = torch.tensor(beta)
        return loss, metrics

    return loss_fn


def adam_eps(config: Dict[str, Any]) -> float:
    """The ``eps`` of a configuration's ``adam`` options (optax's
    ``scale_by_adam`` keywords); any other option is refused."""
    options = dict(config.get("adam") or {})
    eps = options.pop("eps", EPS)
    if options:
        raise NotImplementedError(f"Adam options {sorted(options)} are not ported, only eps")
    return float(eps)


def pm_vae_trainer(model, config: Dict[str, Any], *, seed: int = 0, mask_fn=None,
                   data_key: str = "features", device: Optional[str] = None,
                   **kwargs) -> Trainer:
    """The trainer of ``train_pm_vae.py:80-158``: nothing frozen, Adam with
    the decayed weights of every parameter that is not 1-D under the
    exponential decay and no clip (:class:`~posterior_matching_torch.train.
    optim.ClippedAdam` without ``max_norm``; the configuration's ``adam``
    options may set ``eps``), the loss of :func:`pm_vae_loss_fn` at the step, masks from ``mask_fn`` and the
    training noise added on the device, checkpoints in the JAX package's
    layout."""
    from posterior_matching_torch.convert import pm_vae_state_dict, pm_vae_trees

    eps = adam_eps(config)
    schedule = exponential_decay(**config["lr_schedule"])
    optimizer = lambda params: ClippedAdam(params, schedule, None,
                                           config.get("weight_decay", 0.0), eps)
    data = config.get("data", {})
    return Trainer(
        model, pm_vae_loss_fn(config, data_key), optimizer=optimizer,
        prologue_fn=pm_vae_prologue(data, mask_fn, True),
        val_prologue_fn=pm_vae_prologue(data, mask_fn, False) or (lambda batch, gen: batch),
        pass_step=True,
        seed=seed, to_trees=lambda sd: (pm_vae_trees(sd), {}),
        from_trees=lambda params, state: pm_vae_state_dict(params), device=device, **kwargs,
    )


def _sample_noise(model, noise):
    """``noise`` as the models' ``sample`` takes it: an int seeds a
    generator on the model's device; a generator or an iterator of draws is
    used as given."""
    if isinstance(noise, int):
        return torch.Generator(device=model.device).manual_seed(noise)
    return noise


def vade_pretrain_loss_fn(data_key: str) -> LossFn:
    """The deterministic autoencoder's loss ``pretrain_loss`` (``train_vade.
    py:60-67``)."""
    return lambda model, batch, noise, training: model.pretrain_loss(batch[data_key])


def vade_loss_fn(data_key: str) -> LossFn:
    """``-mean(elbo)`` (``train_vade.py:69-78``)."""
    return lambda model, batch, noise, training: -model.elbo(
        batch[data_key], _sample_noise(model, noise)).mean()


def pm_vade_loss_fn(data_key: str) -> LossFn:
    """``-mean(posterior_matching_ll)`` (``train_pm_vade.py:64-73``)."""
    return lambda model, batch, noise, training: -model.posterior_matching_ll(
        batch[data_key], batch["mask"], _sample_noise(model, noise)).mean()


def lookahead_loss_fn(data_key: str) -> LossFn:
    """``-mean`` of the lookahead posterior's training log-likelihood
    (``train_lookahead_posterior.py:79-88``)."""
    return lambda model, batch, noise, training: -model(
        batch[data_key], batch["mask"], _sample_noise(model, noise)).mean()


def vade_pretrain_trainer(model, config: Dict[str, Any], *, seed: int = 0,
                          data_key: str = "image", device: Optional[str] = None,
                          **kwargs) -> Trainer:
    """Phase 1 of ``train_vade.py`` (:132-139): ``optax.adam(pretrain_lr)``,
    plain Adam at a constant rate with optax's default ``eps``, nothing
    frozen: the prior's ``logits``, ``mu`` and ``log_scale``, which the
    autoencoder's loss does not use, get zero gradients and stay put."""
    lr = config["pretrain_lr"]
    return Trainer(model, vade_pretrain_loss_fn(data_key),
                   optimizer=lambda params: Adam(params, lambda count: lr, chain=OPTAX_ADAM),
                   seed=seed, zero_unused_grads=True, **_vade_trees(), device=device, **kwargs)


def _vade_trees() -> Dict[str, Any]:
    """``to_trees`` and ``from_trees`` of VaDE and PM-VaDE."""
    from posterior_matching_torch.convert import vade_state_dict, vade_trees

    return {"to_trees": lambda sd: (vade_trees(sd), {}),
            "from_trees": lambda params, state: vade_state_dict(params)}


def _decayed_adam(config: Dict[str, Any]) -> OptimizerFn:
    """``optax.chain(scale_by_adam(**adam), scale_by_schedule(exponential_
    decay(**lr_schedule)), scale(-1.0))``, the chain of the VaDE, PM-VaDE
    and lookahead CLIs."""
    eps = adam_eps(config)
    schedule = exponential_decay(**config["lr_schedule"])
    return lambda params: Adam(params, schedule, eps)


def vade_trainer(model, config: Dict[str, Any], *, seed: int = 0, data_key: str = "image",
                 device: Optional[str] = None, **kwargs) -> Trainer:
    """Phase 3 of ``train_vade.py`` (:176-207): ``-mean(elbo)``, Adam with
    the configuration's ``adam`` options under the exponential decay,
    nothing frozen, checkpoints in the JAX package's layout."""
    return Trainer(model, vade_loss_fn(data_key), optimizer=_decayed_adam(config), seed=seed,
                   **_vade_trees(), device=device, **kwargs)


def pm_vade_trainer(model, config: Dict[str, Any], *, seed: int = 0, mask_fn=None,
                    data_key: str = "image", device: Optional[str] = None,
                    **kwargs) -> Trainer:
    """The trainer of ``train_pm_vade.py:64-112``: the matching loss, only
    the modules whose path holds ``partial_`` trainable (so the GMM prior's
    ``logits``, ``mu`` and ``log_scale``, at the top of the tree, are
    frozen), Adam under the exponential decay, masks from ``mask_fn`` (the
    CLI's ``UniformMaskGenerator``) drawn on the device."""
    data = config.get("data", {})
    return Trainer(
        model, pm_vade_loss_fn(data_key), optimizer=_decayed_adam(config),
        trainable=lambda module, name: "partial_" in module,
        prologue_fn=pm_vae_prologue(data, mask_fn, True),
        val_prologue_fn=pm_vae_prologue(data, mask_fn, False),
        seed=seed, **_vade_trees(), device=device, **kwargs,
    )


def lookahead_trainer(model, config: Dict[str, Any], *, seed: int = 0, mask_fn=None,
                      data_key: str = "image", device: Optional[str] = None,
                      **kwargs) -> Trainer:
    """The trainer of ``train_lookahead_posterior.py:79-123``: the lookahead
    log-likelihood, only the modules whose path holds ``lookahead``
    trainable (the PM-VAE under ``pm_vae`` frozen), Adam under the
    exponential decay, masks from ``mask_fn`` drawn on the device."""
    from posterior_matching_torch.convert import lookahead_state_dict, lookahead_trees

    data = config.get("data", {})
    return Trainer(
        model, lookahead_loss_fn(data_key), optimizer=_decayed_adam(config),
        trainable=lambda module, name: "lookahead" in module,
        prologue_fn=pm_vae_prologue(data, mask_fn, True),
        val_prologue_fn=pm_vae_prologue(data, mask_fn, False),
        seed=seed, to_trees=lambda sd: (lookahead_trees(sd), {}),
        from_trees=lambda params, state: lookahead_state_dict(params), device=device, **kwargs,
    )
