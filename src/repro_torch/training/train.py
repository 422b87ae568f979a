"""Training substrate of the port: the loss and the train-step builder
(gradients, clip, optimizer update, apply), as the JAX package's
`training/train.py`.

`train_step` differentiates with `torch.autograd` through the port's
training pass: on the card the MoE experts run the grouped-matmul kernel
(`kernels.MoeGmm`, forward and input gradient), attention runs the
prefill kernel writing each row's log-sum-exp (`kernels.FlashAttention`),
cross-attention the decode kernel (`models.attention.CrossAttention`),
and the WKV and RG-LRU recurrences their kernels forward and backward
(`kernels.RwkvScan`, `kernels.LinearScan`).
Parameters and optimizer state are updated in place."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models import transformer as T

from .optimizer import (Optimizer, apply_updates, clip_scale,
                        make_optimizer, tree_leaves, tree_map, warmup_cosine)

LB_LOSS_COEF = 0.01  # MoE load-balance auxiliary loss weight


def cross_entropy(logits, labels, mask=None):
    """logits [B,S,V], labels [B,S] -> scalar mean NLL (over `mask`)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def loss_fn(cfg, params, batch, *, window: int = 0):
    """batch: {"tokens": [B,S], "labels": [B,S], optional "mask", "embeds"
    [B,S,d] (in place of "tokens"), "rope_pos" ([B,S], or [3,B,S] for
    M-RoPE), "enc_out" [B,S_enc,d_enc] (an encoder-decoder stack's encoder
    states; a stack without cross-attention ignores it, as the JAX
    package's)} tensors. Returns (loss, {"ce", "lb"})."""
    logits, aux = T.train_forward(cfg, params, batch.get("tokens"),
                                  embeds=batch.get("embeds"),
                                  rope_pos=batch.get("rope_pos"),
                                  enc_out=batch.get("enc_out"),
                                  window=window)
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
    lb = aux.get("lb_loss", torch.zeros((), dtype=torch.float32,
                                        device=logits.device))
    loss = ce + LB_LOSS_COEF * lb
    return loss, {"ce": ce, "lb": lb}


def _on(batch, device):
    """The batch's arrays (tensors, or anything numpy reads) as tensors on
    `device`."""
    return {k: v.to(device) if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items() if v is not None}


def make_train_step(cfg, optimizer: Optional[Optimizer] = None, *,
                    window: int = 0, max_grad_norm: float = 1.0):
    """Returns (init_state, train_step).

    init_state(generator, device=None) -> (params, opt_state): parameters
    drawn from a `torch.Generator` on `device` (the card by default; the
    generator must live there). train_step(state, batch) -> (state,
    metrics) with metrics "loss", "ce", "lb", "grad_norm" (0-d tensors);
    the batch may hold numpy arrays or tensors."""
    if optimizer is None:
        optimizer = make_optimizer(cfg.optimizer,
                                   warmup_cosine(3e-4, 100, 10_000))

    def init_state(generator: torch.Generator, device=None):
        params = T.init_params(cfg, generator, device=device)
        return params, optimizer.init(params)

    def train_step(state, batch):
        params, opt_state = state
        leaves = tree_leaves(params)
        batch = _on(batch, leaves[0].device)
        with torch.enable_grad():
            live = [p.detach().requires_grad_() for p in leaves]
            it = iter(live)
            loss, parts = loss_fn(cfg, tree_map(lambda _: next(it), params),
                                  batch, window=window)
            flat = torch.autograd.grad(loss, live, allow_unused=True)
        it = iter(g if g is not None else torch.zeros_like(p)
                  for g, p in zip(flat, leaves))
        grads = tree_map(lambda _: next(it), params)
        del flat
        scale, gnorm = clip_scale(grads, max_grad_norm)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, params,
                                                  grad_scale=scale)
            params = apply_updates(params, updates)
        metrics = {"loss": loss.detach(), "ce": parts["ce"].detach(),
                   "lb": parts["lb"].detach(), "grad_norm": gnorm}
        return (params, opt_state), metrics

    return init_state, train_step
