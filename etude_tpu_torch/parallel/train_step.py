"""The decoder's training step on one device (JAX counterpart:
etude_tpu/parallel/train_step.py).

One optimizer step: the gradients of each micro-batch along the leading axis
of a [accum, B, T] batch are summed, then averaged, as are the micro-batch
mean losses (not a token-weighted mean over the global batch, JAX :169-170);
every gradient is checked for finiteness on the device; then the update is
applied or skipped, with no host synchronization. The optimizer is optax's
`chain(clip_by_global_norm(c), adamw(schedule, b1, b2, weight_decay=wd))`
(JAX `make_optimizer` :53), written out in foreach operations so that the
skip can be a device-side select. The places where optax's semantics are
kept are marked "optax:".

The auxiliary models' step (`make_aux_optimizer`, `make_aux_train_step`) is
the jitted step of scripts/train_aux_synthetic.py `train_loop` (:69-95): the
same AdamW with its own schedule and b2, one batch, no skip.

Over a mesh (parallel/mesh.py; JAX `make_train_step(mesh=...)` :118 and
`init_sharded_state` :79), every rank runs the same step on its rows of each
micro-batch, and the step calls the collectives that XLA derives in JAX (one
step function serves both: without a process group its collectives are
no-ops):

- The loss is JAX's token-weighted mean over the whole micro-batch: each
  rank divides its token-loss sum by the micro-batch's label count over
  every rank (`n_labels`, counted on the host by `mesh.shard_batch`), and
  the gradients are summed across ranks. (An average of per-rank means,
  DistributedDataParallel's default, differs whenever ranks hold different
  label counts.)
- One reduction per optimizer step: the `accum` micro-batch gradients are
  summed on each rank first.
- The skip and the clip are global: the finiteness test and the norm are
  those of the reduced gradients, the same on every rank.
- Replicated parameters (data parallelism): one all-reduce of the flat
  gradient vector. FSDP (`init_sharded_state(fsdp=True)`): each rank holds
  its shard of a flat partition of the f32 parameters and of both Adam
  moments (`mesh.fsdp_param_sharding`); the parameters are all-gathered for
  the forward and freed after the backward, the gradients reduce-scattered,
  and each rank updates its shard. The numbers are data parallelism's; only
  the memory differs.
- The model axis shards nothing, as in JAX, whose step uses only the data
  axis.

No collective reads a value back to the host, so a step under a mesh is as
free of host synchronization as one without.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.decoder import EtudeDecoder, EtudeDecoderConfig, loss_fn
from .mesh import FlatShard, Mesh, flat_layout, fsdp_param_sharding


@dataclasses.dataclass(frozen=True)
class LRSchedule:
    """Linear warmup from 0 to the peak over `warmup_steps`, then cosine
    decay to 0 over `total_steps - warmup_steps` (JAX `make_lr_schedule`
    :35: optax `join_schedules` of `linear_schedule` and
    `cosine_decay_schedule`), evaluated in f32 as optax does."""

    learning_rate: float
    warmup_steps: int
    decay_steps: int

    def __call__(self, count) -> torch.Tensor:
        """The rate at `count` (an int, or an int tensor on any device)."""
        count = torch.as_tensor(count, dtype=torch.int32)
        # optax linear_schedule: frac = 1 - clip(count, 0, W) / W, then
        # (init - end) * frac + end with init 0.
        frac = 1 - count.clamp(0, self.warmup_steps) / self.warmup_steps
        warm = (0.0 - self.learning_rate) * frac + self.learning_rate
        # optax cosine_decay_schedule at count - W, clipped at decay_steps.
        c = (count - self.warmup_steps).clamp(max=self.decay_steps).float()
        cosine = 0.5 * (1 + torch.cos(math.pi * c / self.decay_steps))
        decayed = self.learning_rate * cosine
        # optax join_schedules: the second schedule from the boundary on.
        return torch.where(count < self.warmup_steps, warm, decayed)


def make_lr_schedule(learning_rate: float, warmup_steps: int,
                     total_steps: int) -> LRSchedule:
    warmup_steps = max(warmup_steps, 1)
    return LRSchedule(learning_rate, warmup_steps,
                      max(total_steps - warmup_steps, 1))


@dataclasses.dataclass
class AdamWState:
    mu: List[torch.Tensor]     # first moments, one per parameter, f32
    nu: List[torch.Tensor]     # second moments
    count: torch.Tensor        # int32: updates applied (skips do not count)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax `chain(clip_by_global_norm(clip_grad_norm), adamw(schedule, b1,
    b2, eps=1e-8, eps_root=0, weight_decay))` on lists of tensors."""

    schedule: LRSchedule
    b1: float = 0.9
    b2: float = 0.98
    weight_decay: float = 0.01
    clip_grad_norm: float = 1.0
    eps: float = 1e-8

    def init(self, params: List[torch.Tensor]) -> AdamWState:
        return AdamWState(
            mu=[torch.zeros_like(p) for p in params],
            nu=[torch.zeros_like(p) for p in params],
            count=torch.zeros((), dtype=torch.int32, device=params[0].device),
        )

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: AdamWState,
               params: List[torch.Tensor], apply: torch.Tensor,
               norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Clip `grads` in place, then update `params` and `state` in place
        where the 0-dim bool tensor `apply` is true; where it is false,
        params and state keep their bits (the count does not advance, so
        neither the schedule nor the bias correction does: JAX
        `skip_update` :181-184). Returns the global norm of `grads` as
        given, before the clip: `norm` when the caller computed it (a rank
        holding a shard of the gradients), else the norm of `grads`."""
        if norm is None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # optax clip_by_global_norm: g * max / |g| only when |g| >= max (no
        # epsilon, unlike torch.nn.utils.clip_grad_norm_).
        scale = torch.where(norm < self.clip_grad_norm, torch.ones_like(norm),
                            self.clip_grad_norm / norm)
        torch._foreach_mul_(grads, scale)

        # optax scale_by_adam: (1 - b) * g**k + b * moment, bias correction
        # with the incremented count, m_hat / (sqrt(v_hat + 0) + eps).
        mu = torch._foreach_mul(grads, 1 - self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(state.mu, self.b1))
        nu = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(nu, 1 - self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(state.nu, self.b2))
        count = state.count + 1
        t = count.float()
        update = torch._foreach_div(mu, 1 - self.b1 ** t)
        den = torch._foreach_div(nu, 1 - self.b2 ** t)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(update, den)
        # optax add_decayed_weights: decoupled wd * p on every leaf (biases,
        # LayerNorm, embeddings and their pad rows), after the Adam scaling.
        torch._foreach_add_(update, torch._foreach_mul(params, self.weight_decay))
        # optax scale_by_learning_rate: the schedule at the count *before*
        # this update (the first update runs at schedule(0) = 0).
        torch._foreach_mul_(update, -self.schedule(state.count))
        new_params = torch._foreach_add(params, update)

        for old, new in ((params, new_params), (state.mu, mu), (state.nu, nu)):
            for o, n in zip(old, new):
                torch.where(apply, n, o, out=o)
        torch.where(apply, count, state.count, out=state.count)
        return norm


def make_optimizer(
    learning_rate: float = 2e-4,
    warmup_steps: int = 100,
    total_steps: int = 10000,
    weight_decay: float = 0.01,
    beta1: float = 0.9,
    beta2: float = 0.98,
    clip_grad_norm: float = 1.0,
):
    """(optimizer, schedule), as the JAX package's `make_optimizer`."""
    schedule = make_lr_schedule(learning_rate, warmup_steps, total_steps)
    tx = AdamW(schedule, b1=beta1, b2=beta2, weight_decay=weight_decay,
               clip_grad_norm=clip_grad_norm)
    return tx, schedule


def make_aux_optimizer(learning_rate: float, steps: int) -> AdamW:
    """The auxiliary models' optimizer (scripts/train_aux_synthetic.py
    :71-84): optax `chain(clip_by_global_norm(1.0), adamw(join_schedules(
    [linear_schedule(0, lr, W), cosine_decay_schedule(lr, max(steps, 2))],
    [W]), weight_decay=0.01))` with W = max(steps // 20, 1). Unlike the
    decoder's (`make_optimizer`): the cosine runs over max(steps, 2) steps
    from the boundary, not total - warmup, and b2 is optax's default 0.999,
    not 0.98. Decay on every leaf; no skip."""
    warmup = max(steps // 20, 1)
    return AdamW(LRSchedule(learning_rate, warmup, max(steps, 2)), b1=0.9, b2=0.999,
                 weight_decay=0.01, clip_grad_norm=1.0)


def make_aux_train_step(tx: AdamW, loss: Callable[[torch.nn.Module, Dict[str, Any]], Any],
                        device: torch.device):
    """`step(model, opt_state, batch)` for a model on `device`: the gradient
    of `loss(model, batch)` (a scalar, or (scalar, metrics)), clipped, then
    one AdamW update of the model's parameters and `opt_state` in place,
    always applied. Returns the metrics, computed before the update, as
    device tensors ({"loss": loss} for a scalar loss), with the gradient
    norm before the clip."""
    apply = torch.ones((), dtype=torch.bool, device=device)

    def step(model: torch.nn.Module, opt_state: AdamWState,
             batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        params = list(model.parameters())
        for p in params:
            p.grad = None
        out = loss(model, batch)
        value, metrics = out if isinstance(out, tuple) else (out, {"loss": out})
        value.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        grad_norm = tx.update(grads, opt_state, params, apply)
        for p in params:
            p.grad = None
        return {**{k: v.detach() for k, v in metrics.items()}, "grad_norm": grad_norm}

    return step


@dataclasses.dataclass
class TrainState:
    model: EtudeDecoder          # f32 master parameters
    opt_state: AdamWState
    step: torch.Tensor           # int32: optimizer steps, skipped ones included
    skipped: torch.Tensor        # int32: non-finite updates skipped

    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())


def init_train_state(model: EtudeDecoder, tx: AdamW) -> TrainState:
    model.train().requires_grad_(True)
    device = next(model.parameters()).device
    return TrainState(
        model=model,
        opt_state=tx.init(list(model.parameters())),
        step=torch.zeros((), dtype=torch.int32, device=device),
        skipped=torch.zeros((), dtype=torch.int32, device=device),
    )


def make_train_step(config: EtudeDecoderConfig, tx: AdamW,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    remat: bool = False, mesh: Optional[Mesh] = None):
    """The step function: `step(state, batch)` takes batch tensors shaped
    [accum_steps, micro_batch, T] on the model's device, updates `state` in
    place and returns device-side metrics (loss, accuracy, grads_finite,
    grad_norm and the label count n_tokens); nothing in it reads a value
    back to the host.

    With a mesh whose group has ranks to reduce over, every rank of its data
    axis calls the step together, with its rows of each micro-batch and
    their `n_labels` (`mesh.shard_batch`), on a state from
    `init_sharded_state`; the metrics are the whole batch's, the same on
    every rank. Without a group (or a mesh) the reductions are no-ops, and a
    batch without `n_labels` takes each micro-batch's own label count."""
    group = None if mesh is None else mesh.group

    def reduce(t: torch.Tensor, op=dist.ReduceOp.SUM) -> None:
        if group is not None:
            dist.all_reduce(t, op=op, group=group)

    def step(state, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        sharded = isinstance(state, ShardedTrainState)
        n_labels = batch.get("n_labels")
        if group is not None and n_labels is None:
            raise ValueError("a step over a process group needs each micro-batch's "
                             "n_labels (mesh.shard_batch)")
        params = state.params()
        for p in params:
            p.grad = None
        accum = batch["input_ids"].shape[0]
        loss_sum = acc_sum = n_tokens = 0
        with state.gathered() if sharded else contextlib.nullcontext():
            for i in range(accum):
                micro = {k: v[i] for k, v in batch.items() if k != "n_labels"}
                loss, metrics = loss_fn(state.model, micro, compute_dtype, remat,
                                        n_labels=None if n_labels is None else n_labels[i])
                loss.backward()   # sums the micro-batch gradients in .grad
                loss_sum = loss_sum + loss.detach()
                acc_sum = acc_sum + metrics["accuracy"]
                n_tokens = n_tokens + metrics["n_tokens"]
        if sharded or group is not None:   # one collective of the flat gradients
            layout = state.layout if sharded else flat_layout(params)
            flat = _flat_grads(params, layout)
            for p in params:
                p.grad = None
            if sharded:
                grads, targets = [_reduce_scatter(flat, state)], [state.shard]
            else:
                reduce(flat)
                grads, targets = flat_views(flat, layout), params
            del flat
        else:
            grads, targets = [p.grad for p in params], params
        torch._foreach_div_(grads, accum)
        finite = torch.stack([g.isfinite().all() for g in grads]).all()
        norm = None
        if sharded:   # a shard's test and norm are this rank's part of them
            finite = finite.int()
            reduce(finite, dist.ReduceOp.MIN)
            finite = finite.bool()
            norm = _sharded_norm(grads[0], state, reduce)
        grad_norm = tx.update(grads, state.opt_state, targets, finite, norm=norm)
        state.step += 1
        state.skipped += (~finite).int()
        for p in params:
            p.grad = None
        means = torch.stack([loss_sum, acc_sum])
        reduce(means)
        means = means / accum
        return {
            "loss": means[0],
            "accuracy": means[1],
            "grads_finite": finite.int(),
            "grad_norm": grad_norm,
            "n_tokens": n_tokens,
        }

    return step


@dataclasses.dataclass
class ShardedTrainState:
    """The FSDP state of one rank: its `layout.shard` elements of the flat
    f32 parameter vector (`shard`) and of both Adam moments
    (`opt_state.mu[0]`, `opt_state.nu[0]`), and the replicated scalars.
    The model's parameters are views of `full`, the whole padded vector,
    whose storage exists only between `gather()` and `release()`: inside
    the step, and inside `gathered()`."""

    model: EtudeDecoder
    opt_state: AdamWState
    step: torch.Tensor
    skipped: torch.Tensor
    mesh: Mesh
    layout: FlatShard
    shard: torch.Tensor
    full: torch.Tensor
    piece_index: torch.Tensor   # int64: the parameter of each piece of the shard

    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())

    def gather(self) -> None:
        """All-gather the shards into the model's parameters (a collective:
        every rank of the data axis calls it)."""
        self.full.untyped_storage().resize_(self.full.numel() * self.full.element_size())
        all_gather(self.full, self.shard, self.mesh)

    def release(self) -> None:
        self.full.untyped_storage().resize_(0)

    @contextlib.contextmanager
    def gathered(self):
        self.gather()
        try:
            yield self
        finally:
            self.release()


def all_gather(out: torch.Tensor, shard: torch.Tensor, mesh: Mesh) -> None:
    """`out` = the data axis's shards in rank order (a copy without a group)."""
    if mesh.group is None:
        out.copy_(shard)
    else:
        # torch 2.13 renames all_gather_into_tensor (the card's 2.11 has it).
        getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
            out, shard, group=mesh.group)


def full_params(state) -> Dict[str, torch.Tensor]:
    """Copies of every parameter under its name; an FSDP state gathers them
    (a collective: every rank of the data axis calls it)."""
    with state.gathered() if isinstance(state, ShardedTrainState) else contextlib.nullcontext():
        return {n: p.detach().clone() for n, p in state.model.named_parameters()}


def init_sharded_state(model: EtudeDecoder, tx: AdamW, mesh: Mesh,
                       fsdp: bool = False):
    """The train state of `model` (f32, on `mesh.device`, the same weights on
    every rank) over `mesh` (JAX `init_sharded_state` :79): replicated, as
    `init_train_state`, or with fsdp=True a `ShardedTrainState` holding this
    rank's flat shard of the parameters and moments."""
    params = list(model.parameters())
    if any(p.device != mesh.device or p.dtype != torch.float32 for p in params):
        raise ValueError(f"the model must hold f32 parameters on {mesh.device}")
    if not fsdp:
        return init_train_state(model, tx)
    model.train().requires_grad_(True)
    layout = fsdp_param_sharding(mesh, params)
    full = torch.zeros(layout.padded, dtype=torch.float32, device=mesh.device)
    with torch.no_grad():
        for p, view in zip(params, flat_views(full, layout)):
            view.copy_(p)
            p.data = view
    shard = full[layout.lo:layout.hi].clone()
    pieces = layout.pieces()
    state = ShardedTrainState(
        model=model, opt_state=tx.init([shard]),
        step=torch.zeros((), dtype=torch.int32, device=mesh.device),
        skipped=torch.zeros((), dtype=torch.int32, device=mesh.device),
        mesh=mesh, layout=layout, shard=shard, full=full,
        piece_index=torch.tensor([j for j, _, _ in pieces], dtype=torch.int64,
                                 device=mesh.device))
    state.release()
    return state


def flat_views(flat: torch.Tensor, layout: FlatShard) -> List[torch.Tensor]:
    """Each parameter's slot of a flat vector laid out by `layout`, shaped
    as the parameter."""
    return [flat[off:off + math.prod(shape)].view(shape)
            for off, shape in zip(layout.offsets, layout.shapes)]


def _flat_grads(params: List[torch.Tensor], layout: FlatShard) -> torch.Tensor:
    """The parameters' gradients in one zeroed flat vector laid out by
    `layout` (all of it, not one shard)."""
    flat = torch.zeros(layout.padded, dtype=torch.float32, device=params[0].device)
    torch._foreach_copy_(flat_views(flat, layout), [p.grad for p in params])
    return flat


def _reduce_scatter(flat: torch.Tensor, state: ShardedTrainState) -> torch.Tensor:
    """This rank's shard of `flat` summed over the data axis (`flat` itself
    without a group)."""
    group = state.mesh.group
    if group is None:
        return flat
    grad = flat.new_empty(state.layout.shard)
    # torch 2.13 renames reduce_scatter_tensor (the card's 2.11 has it).
    getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(grad, flat, group=group)
    return grad


def _sharded_norm(grad: torch.Tensor, state: ShardedTrainState, reduce) -> torch.Tensor:
    """The global norm as the replicated step computes it: the norm of the
    per-parameter norms, each from its pieces' squares summed over ranks (in
    f64, so a parameter held whole comes back to its own f32 norm)."""
    layout = state.layout
    pieces = [grad[a:b] for _, a, b in layout.pieces()]
    squares = torch.zeros(len(layout.shapes), dtype=torch.float64, device=grad.device)
    if pieces:
        squares.index_copy_(0, state.piece_index,
                            torch.stack(torch._foreach_norm(pieces)).double() ** 2)
    reduce(squares)
    return torch.linalg.vector_norm(squares.sqrt().float())


def reshape_for_accum(batch: Dict[str, np.ndarray],
                      accum_steps: int) -> Dict[str, np.ndarray]:
    """[B, T] host batch → [accum, B/accum, T]."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch dim {b} not divisible by accum {accum_steps}")
        out[k] = v.reshape(accum_steps, b // accum_steps, *v.shape[1:])
    return out
