"""Optimizer (port of vitslam_tpu/train/optim.py, which builds it from
optax): wildcard parameter freezing, global-norm gradient clipping, AdamW
with a linear-warmup-then-cosine learning rate, and gradient accumulation.

The arithmetic follows optax step for step, so that the port and the JAX
package update the same parameters by the same amounts:

* ``clip_by_global_norm``: g unchanged when ||g|| < max_norm, else
  g / ||g|| * max_norm;
* ``adamw``: mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2, with bias
  corrections at count + 1, update = mu_hat / (sqrt(nu_hat) + eps) +
  weight_decay * p, scaled by -lr(count) where count is the number of
  updates applied before this one (so the first update uses lr(0));
* ``MultiSteps(every_k_schedule=k)``: gradients averaged over k micro-steps
  (acc += (g - acc) / (i + 1)); the inner update, and the schedule's count,
  advance only on every k-th micro-step; the other micro-steps leave the
  parameters unchanged.

Freezing matches ``fnmatch`` patterns against the '/'-joined parameter path
(``core/aggregator/...``), the flax path of the same parameter, so the
YAML patterns (``"*aggregator*"``) select the same tensors as in JAX.
"""
from __future__ import annotations

import fnmatch
import math
from typing import Iterable, Sequence

import numpy as np
import torch
import torch.distributed as dist


def param_path(name: str) -> str:
    """The '/'-joined path of a parameter named ``a.b.c`` by torch."""
    return name.replace(".", "/")


def match_any(path: str, patterns: Sequence[str]) -> bool:
    return any(fnmatch.fnmatch(path, p) for p in patterns)


def partition_params(model: torch.nn.Module, freeze_patterns: Sequence[str]):
    """Split ``model``'s named parameters into (trainable, frozen) dicts of
    name -> parameter by the wildcard patterns."""
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        (frozen if match_any(param_path(name), freeze_patterns) else trainable)[name] = p
    return trainable, frozen


def freeze_params(model: torch.nn.Module, freeze_patterns: Sequence[str]) -> dict:
    """Set requires_grad to False on every parameter a pattern matches and to
    True on the rest; returns the trainable name -> parameter dict."""
    trainable, frozen = partition_params(model, freeze_patterns)
    for p in frozen.values():
        p.requires_grad_(False)
    for p in trainable.values():
        p.requires_grad_(True)
    return trainable


def warmup_cosine_schedule(max_lr: float, min_lr: float, total_steps: int,
                           warmup_percent: float = 0.05, warmup_type: str = "linear"):
    """step -> learning rate: linear (or squared) warmup from 0 to max_lr over
    max(1, int(total_steps * warmup_percent)) steps, then cosine decay to
    min_lr over the remaining steps (optax.join_schedules of
    linear_schedule and cosine_decay_schedule with alpha = min_lr / max_lr)."""
    warmup_steps = max(1, int(total_steps * warmup_percent))
    decay_steps = max(1, total_steps - warmup_steps)
    alpha = min_lr / max_lr

    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            frac = min(max(step, 0.0), warmup_steps) / warmup_steps
            return max_lr * (frac if warmup_type == "linear" else frac ** 2)
        count = min(step - warmup_steps, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return max_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def global_norm(tensors: Iterable[torch.Tensor], sharded: Iterable[torch.Tensor] = (),
                group=None) -> torch.Tensor:
    """sqrt(sum of squares) over every element of every tensor, in fp32.
    Under tensor parallelism ``sharded`` holds this rank's slices of tensors
    split over ``group`` (the model group): their squares are summed over
    the group, those of the replicated ``tensors`` counted once, so the norm
    is that of the whole gradient on every rank."""
    total = sum((t.float() ** 2).sum() for t in tensors)
    sharded = list(sharded)
    if sharded:
        part = sum((t.float() ** 2).sum() for t in sharded)
        dist.all_reduce(part, group=group)
        total = total + part
    return torch.sqrt(torch.as_tensor(total))


class AdamW:
    """AdamW with global-norm clipping, a learning-rate schedule and
    gradient accumulation over ``accum_steps`` micro-steps, on a dict of
    name -> trainable parameter (see the module docstring for the
    arithmetic). ``step(grads)`` takes name -> gradient; its state dict
    round-trips through ``state_dict`` / ``load_state_dict``. Under tensor
    parallelism (``shards``, from ``parallel.shard_params_model``) the
    parameters, gradients and moments of the sharded names are this rank's
    slices, as optax's moments are under the JAX package's sharding, and
    the clip reads the norm of the whole gradient."""

    def __init__(self, params: dict, schedule, weight_decay: float = 0.05,
                 grad_clip_norm: float = 1.0, accum_steps: int = 1,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, shards=None):
        self.params = dict(params)
        self.shards = shards
        self.schedule = schedule
        self.weight_decay, self.grad_clip_norm = weight_decay, grad_clip_norm
        self.accum_steps = accum_steps
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0       # updates applied
        self.mini_step = 0   # micro-steps accumulated since the last update
        zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                         for n, p in self.params.items()}
        self.mu, self.nu = zeros(), zeros()
        self.acc = zeros() if accum_steps > 1 else None

    @torch.no_grad()
    def step(self, grads: dict) -> bool:
        """One micro-step; returns whether the parameters were updated."""
        if self.acc is not None:
            for n, g in grads.items():
                self.acc[n] += (g.float() - self.acc[n]) / (self.mini_step + 1)
            self.mini_step += 1
            if self.mini_step < self.accum_steps:
                return False
            self.mini_step = 0
            grads = {n: a.clone() for n, a in self.acc.items()}
            for a in self.acc.values():
                a.zero_()
        g_norm = self.grad_norm(grads)
        clip = None if g_norm < self.grad_clip_norm else self.grad_clip_norm / g_norm
        lr = self.schedule(self.count)
        self.count += 1
        # bias corrections in fp32, as optax computes decay ** count
        c1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(self.count))
        c2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(self.count))
        for n, p in self.params.items():
            g = grads[n].float()
            if clip is not None:
                g = g / g_norm * self.grad_clip_norm
            self.mu[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.nu[n].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            update = (self.mu[n] / c1) / (torch.sqrt(self.nu[n] / c2) + self.eps)
            update += self.weight_decay * p.float()
            p.sub_((lr * update).to(p.dtype))
        return True

    def grad_norm(self, grads: dict) -> torch.Tensor:
        """The global norm of the whole gradient (name -> gradient, or this
        rank's slice of it for a sharded name)."""
        if self.shards is None or not self.shards.dims:
            return global_norm(grads.values())
        dims = self.shards.dims
        return global_norm([g for n, g in grads.items() if n not in dims],
                           [g for n, g in grads.items() if n in dims],
                           self.shards.mesh.group("model"))

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step, "mu": self.mu,
                "nu": self.nu, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for mine, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"]),
                             (self.acc, state["acc"])):
            if mine is None:
                continue
            for n, t in theirs.items():
                mine[n].copy_(t)


def build_optimizer(params: dict, max_lr: float = 5e-5, min_lr: float = 1e-8,
                    total_steps: int = 70000, warmup_percent: float = 0.05,
                    weight_decay: float = 0.05, grad_clip_norm: float = 1.0,
                    accum_steps: int = 1, shards=None):
    """(AdamW over ``params``, its schedule), with the reference's defaults;
    ``shards``: the model's tensor-parallel layout, if any."""
    schedule = warmup_cosine_schedule(max_lr, min_lr, total_steps, warmup_percent)
    return AdamW(params, schedule, weight_decay=weight_decay, grad_clip_norm=grad_clip_norm,
                 accum_steps=accum_steps, shards=shards), schedule
