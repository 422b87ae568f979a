"""Optimizers of the port: AdamW and Adafactor, the JAX package's update
rules operation for operation (`torch.optim`'s AdamW and Adafactor order
the same maths differently), over the dict tree of tensors that
`init_params` builds.

Where JAX is pure, the port works in place to bound memory: the update runs
leaf by leaf, so only one leaf's float32 temporaries are alive at a time
(OLMoE-1B-7B's largest leaf, the [16,64,2048,1024] expert stack, is 8.6 GB
in float32); the optimizer state is updated in place; `update` writes each
leaf's update into its gradient's storage (it consumes `grads`) and
`apply_updates` adds into the parameters. The train step clips without a
scaled copy of the gradients: `clip_scale` gives the clip's float32 scale
and `update(..., grad_scale=)` applies it inside each leaf's float32
upcast, as the JAX package's `g * scale` promotes bf16 gradients to
float32.

Expert parallelism cuts some leaves over process groups
(`distributed.param_cuts`: for each leaf, {dim: group} of the dims whose
slices other ranks hold). `update(..., cuts=)` and `global_norm(...,
cuts=)` then sum every reduction over a whole leaf (Adafactor's row and
column statistics, its update RMS, the clip's norm) over those groups
too, so each rank computes what one process would on the whole leaf;
AdamW is elementwise and needs nothing."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist


class OptState(NamedTuple):
    step: int
    inner: Any


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    # (grads, state, params, grad_scale=None, cuts=None)
    #   -> (updates, new_state)
    update: Callable


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of a nested dict/list/tuple tree; `rest` are
    trees of the same structure, or deeper (their subtree at each of
    `tree`'s leaves is passed whole)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _f32(x) -> float:
    """A float32 scalar computation's value as a Python float (exact)."""
    return float(x.to(torch.float32))


def _scaled_f32(g, scale):
    """`g` in float32 as a new tensor, times the clip's float32 `scale`
    (None: no clip), as the JAX package's g * scale: the product of a bf16
    leaf is taken in float32. One pass: a 1-element factor, unlike a 0-d
    one, promotes a bf16 `g`."""
    if scale is None:
        return g.to(torch.float32, copy=True)
    return g * scale.reshape(1)


def _mean(x, dim: int, cut, keepdim: bool = False):
    """x.mean(dim) over the whole leaf: where the ranks of `cut[dim]` hold
    the other slices of that dim, the sum is taken over them too."""
    group = cut.get(dim) if cut else None
    if group is None:
        return x.mean(dim, keepdim=keepdim)
    s = x.sum(dim, keepdim=keepdim)
    dist.all_reduce(s, group=group)
    return s / (x.shape[dim] * dist.get_world_size(group))


def _sum_all(x, cut):
    """x.sum() over the whole leaf (summed over the ranks of every group
    in `cut`), and the whole leaf's element count."""
    s, n = x.sum(), x.numel()
    for group in (cut or {}).values():
        dist.all_reduce(s, group=group)
        n *= dist.get_world_size(group)
    return s, n


def _into(g, p, u):
    """Write the float32 update `u` into `g` when it has the parameter's
    type (the gradient is spent), else into a new tensor of that type."""
    out = g if g.dtype == p.dtype else torch.empty_like(p)
    return out.copy_(u)


# --------------------------------------------------------------------- #
# Schedules
# --------------------------------------------------------------------- #

def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1):
    def lr(step):
        step = torch.tensor(float(step), dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return _f32(torch.where(step < warmup, warm, cos))
    return lr


# --------------------------------------------------------------------- #
# AdamW
# --------------------------------------------------------------------- #

def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        def zeros():
            return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                            params)
        return OptState(0, {"m": zeros(), "v": zeros()})

    def update(grads, state, params, grad_scale=None, cuts=None):
        del cuts        # elementwise: a slice updates as the whole leaf
        step = state.step + 1
        lr_t = lr_fn(step)
        t = torch.tensor(float(step), dtype=torch.float32)
        b1t = _f32(1 - torch.tensor(b1, dtype=torch.float32) ** t)
        b2t = _f32(1 - torch.tensor(b2, dtype=torch.float32) ** t)

        def upd(p, g, m, v):
            g32 = _scaled_f32(g, grad_scale)
            m.mul_(b1).add_(g32 * (1 - b1))
            v.mul_(b2).add_(g32 * (1 - b2) * g32)
            u = (m / b1t) / (torch.sqrt(v / b2t) + eps)
            u += weight_decay * p.float()
            return _into(g, p, u.mul_(-lr_t))

        updates = tree_map(upd, params, grads, state.inner["m"],
                           state.inner["v"])
        return updates, OptState(step, state.inner)

    return Optimizer(init, update)


# --------------------------------------------------------------------- #
# Adafactor (Shazeer & Stern '18), factored second moment
# --------------------------------------------------------------------- #

def adafactor(lr, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        def make(p):
            if p.dim() >= 2:      # factored: a row and a column statistic
                shape = tuple(p.shape)
                return {"row": p.new_zeros(shape[:-1], dtype=torch.float32),
                        "col": p.new_zeros(shape[:-2] + shape[-1:],
                                           dtype=torch.float32)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return OptState(0, tree_map(make, params))

    def update(grads, state, params, grad_scale=None, cuts=None):
        step = state.step + 1
        lr_t = lr_fn(step)
        beta = _f32(1.0 - (torch.tensor(float(step), dtype=torch.float32)
                           + 1.0) ** (-decay))

        def upd(p, g, s, cut=None):
            u = _scaled_f32(g, grad_scale)
            nd = u.dim()
            g2 = u * u
            g2 += eps
            if "row" in s:
                s["row"].mul_(beta).add_(_mean(g2, nd - 1, cut) * (1 - beta))
                s["col"].mul_(beta).add_(_mean(g2, nd - 2, cut) * (1 - beta))
                del g2
                # the row statistic's last dim is the leaf's dim nd - 2
                row_mean = _mean(s["row"], nd - 2, cut, keepdim=True)
                r = (s["row"] / torch.clamp(row_mean, min=eps))[..., None]
                denom = r * s["col"][..., None, :]
                u.mul_(denom.clamp_(min=eps).rsqrt_())
                del denom
            else:
                s["v"].mul_(beta).add_(g2 * (1 - beta))
                del g2
                u.mul_(torch.rsqrt(torch.clamp(s["v"], min=eps)))
            # update clipping by the RMS over the whole leaf
            if cut:
                sq, n = _sum_all(u * u, cut)
                rms = torch.sqrt(sq / n + 1e-12)
            else:
                rms = torch.sqrt((u * u).mean() + 1e-12)
            u.div_(torch.clamp(rms / clip_threshold, min=1.0))
            if weight_decay:
                u += weight_decay * p.float()
            return _into(g, p, u.mul_(-lr_t))

        if cuts is None:
            updates = tree_map(upd, params, grads, state.inner)
        else:
            updates = tree_map(upd, params, grads, state.inner, cuts)
        return updates, OptState(step, state.inner)

    return Optimizer(init, update)


def make_optimizer(name: str, lr, **kw) -> Optimizer:
    if name == "adafactor":
        return adafactor(lr, **kw)
    return adamw(lr, **kw)


@torch.no_grad()
def apply_updates(params, updates):
    """p + u, in place. Returns `params`."""
    tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
    return params


def global_norm(tree, cuts=None) -> torch.Tensor:
    """The norm over every leaf; with `cuts`, over the whole leaves the
    ranks hold slices of (each leaf every rank holds whole counted once)."""
    if cuts is None:
        cuts = tree_map(lambda _: None, tree)
    squares = tree_leaves(tree_map(
        lambda l, cut: _sum_all(l.float().square(), cut)[0], tree, cuts))
    return torch.sqrt(sum(squares))


def clip_scale(grads, max_norm: float, cuts=None):
    """The clip's float32 scale min(1, max_norm / norm), and the norm
    (`global_norm`'s, with its `cuts`)."""
    norm = global_norm(grads, cuts)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(g * scale for every leaf, norm), as the JAX package: the product is
    float32 for bf16 leaves. The train step does not build this tree (27.7
    GB in float32 for OLMoE-1B-7B): it passes `clip_scale`'s scale to the
    optimizer's update."""
    scale, norm = clip_scale(grads, max_norm)
    return tree_map(lambda g: _scaled_f32(g, scale), grads), norm
