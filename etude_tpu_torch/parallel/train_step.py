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

Multi-device training (the JAX package's data-parallel mesh and
`init_sharded_state` :79, FSDP) is not ported; `train.py` raises on it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ..models.decoder import EtudeDecoder, EtudeDecoderConfig, loss_fn


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
               params: List[torch.Tensor], apply: torch.Tensor) -> torch.Tensor:
        """Clip `grads` in place, then update `params` and `state` in place
        where the 0-dim bool tensor `apply` is true; where it is false,
        params and state keep their bits (the count does not advance, so
        neither the schedule nor the bias correction does: JAX
        `skip_update` :181-184). Returns the global norm of `grads` as
        given, before the clip."""
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
                    remat: bool = False):
    """The step function: `step(state, batch)` takes batch tensors shaped
    [accum_steps, micro_batch, T] on the model's device, updates `state` in
    place and returns device-side metrics (loss, accuracy, grads_finite,
    grad_norm and the label count n_tokens); nothing in it reads a value
    back to the host."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        params = state.params()
        for p in params:
            p.grad = None
        accum = batch["input_ids"].shape[0]
        loss_sum = acc_sum = n_tokens = 0
        for i in range(accum):
            loss, metrics = loss_fn(state.model, {k: v[i] for k, v in batch.items()},
                                    compute_dtype, remat)
            loss.backward()   # sums the micro-batch gradients in .grad
            loss_sum = loss_sum + loss.detach()
            acc_sum = acc_sum + metrics["accuracy"]
            n_tokens = n_tokens + metrics["n_tokens"]
        grads = [p.grad for p in params]
        torch._foreach_div_(grads, accum)
        finite = torch.stack([g.isfinite().all() for g in grads]).all()
        grad_norm = tx.update(grads, state.opt_state, params, finite)
        state.step += 1
        state.skipped += (~finite).int()
        for p in params:
            p.grad = None
        return {
            "loss": loss_sum / accum,
            "accuracy": acc_sum / accum,
            "grads_finite": finite.int(),
            "grad_norm": grad_norm,
            "n_tokens": n_tokens,
        }

    return step


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
