"""AdamW implemented in-repo (torch), with global-norm clipping and a
linear-warmup cosine schedule.

Counterpart of ``repro.train.optimizer``: the same config, state layout
(``AdamWState(step, mu, nu)``, f32 moments shaped like the params) and f32
arithmetic in the same order.  Parameter trees are nested dicts, walked in
JAX's flatten order (keys sorted).  ``apply_updates`` updates the params and
moments in place under ``torch.no_grad()`` (the JAX version returns new
arrays; a copy would double the optimizer's memory traffic) and returns
them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import torch

from ..models.params import tree_leaves


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # gradient compression applied before the cross-replica reduction:
    # "none" | "int8" (per-tensor absmax scale)
    grad_compression: str = "none"


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def compress_grads(grads, method: str):
    """Quantize -> dequantize gradients (simulating a compressed
    all-reduce)."""
    if method == "none":
        return grads

    def q(g):
        gf = g.float()
        scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
        qi = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        return qi.float() * scale

    if method == "int8":
        return tree_map(q, grads)
    raise ValueError(f"unknown grad_compression {method!r}")


class AdamWState(NamedTuple):
    step: torch.Tensor       # i32 scalar
    mu: Any                  # first moment (f32, like params)
    nu: Any                  # second moment (f32)


def init_state(params) -> AdamWState:
    def zeros(a):
        return torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    device = next(leaf for _, leaf in tree_leaves(params)).device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      tree_map(zeros, params), tree_map(zeros, params))


def abstract_state(param_structs) -> AdamWState:
    """Shapes and dtypes of the state, on the ``meta`` device."""
    def z(a):
        return torch.empty(a.shape, dtype=torch.float32, device="meta")
    return AdamWState(torch.empty((), dtype=torch.int32, device="meta"),
                      tree_map(z, param_structs), tree_map(z, param_structs))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    s = step.float()
    warm = s / max(1.0, cfg.warmup_steps)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(1.0, cfg.total_steps - cfg.warmup_steps), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decayed = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.minimum(warm, decayed)


def global_norm(tree) -> torch.Tensor:
    total = 0
    for _, g in tree_leaves(tree):
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, state: AdamWState,
                  cfg: AdamWConfig) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step.  ``params``, ``state.mu`` and ``state.nu`` are updated
    in place and returned; ``grads`` may be in the params' dtype or f32."""
    step = state.step + 1
    grads = compress_grads(grads, cfg.grad_compression)
    gnorm = global_norm(grads)
    scale = torch.minimum(torch.ones_like(gnorm),
                          cfg.grad_clip / torch.clamp(gnorm, min=1e-9))
    lr = schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    leaves = zip(tree_leaves(params), tree_leaves(grads),
                 tree_leaves(state.mu), tree_leaves(state.nu))
    for (path, p), (gpath, g), (_, m), (_, v) in leaves:
        if gpath != path:
            raise ValueError(f"grads tree differs from params at {path}")
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step, state.mu, state.nu), metrics
