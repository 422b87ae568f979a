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
Parameters and optimizer state are updated in place.

Expert parallelism (`ep=`, the dispatch
`distributed.make_expert_parallel_moe` returns): each rank holds its slice
of the params (`distributed.shard_params`) and its own rows of the batch,
and differentiates its share of the global loss: the NLL of its tokens over
the global token count, plus `LB_LOSS_COEF` times its local load-balance
loss over the data ranks. Summed over the data ranks the shares give the JAX
package's loss under its "ep-a2a" option (whose load-balance loss is the
mean of the data shards' losses), so once `distributed.reduce_gradients` has
summed the gradients of the leaves every data rank holds, each rank holds
its slice of the reference's gradient. The clip's norm and Adafactor's
statistics sum over the ranks that hold slices of a leaf
(`distributed.param_cuts`)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import param_cuts, reduce_gradients, shard_params
from repro_torch.models import transformer as T

from .optimizer import (Optimizer, apply_updates, clip_scale,
                        make_optimizer, tree_leaves, tree_map, warmup_cosine)

LB_LOSS_COEF = 0.01  # MoE load-balance auxiliary loss weight


def _nll(logits, labels):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - gold


def cross_entropy(logits, labels, mask=None):
    """logits [B,S,V], labels [B,S] -> scalar mean NLL (over `mask`)."""
    nll = _nll(logits, labels)
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def loss_fn(cfg, params, batch, *, window: int = 0, ep=None):
    """batch: {"tokens": [B,S], "labels": [B,S], optional "mask", "embeds"
    [B,S,d] (in place of "tokens"), "rope_pos" ([B,S], or [3,B,S] for
    M-RoPE), "enc_out" [B,S_enc,d_enc] (an encoder-decoder stack's encoder
    states; a stack without cross-attention ignores it, as the JAX
    package's)} tensors. Returns (loss, {"ce", "lb"}).

    With `ep` (`params` this rank's slice, `batch` its rows) the loss is
    this rank's share of the global loss (see the module's docstring):
    "ce" its share of the global cross-entropy, "lb" the global
    load-balance loss, detached (the dispatch's reported mean)."""
    logits, aux = T.train_forward(cfg, params, batch.get("tokens"),
                                  embeds=batch.get("embeds"),
                                  rope_pos=batch.get("rope_pos"),
                                  enc_out=batch.get("enc_out"),
                                  window=window, ep=ep)
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    lb = aux.get("lb_loss", zero)
    if ep is None:
        ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
        return ce + LB_LOSS_COEF * lb, {"ce": ce, "lb": lb}
    nll = _nll(logits, batch["labels"])
    mask = batch.get("mask")
    if mask is not None:
        nll, count = nll * mask, mask.sum().float()
    else:
        count = torch.tensor(float(nll.numel()), device=nll.device)
    dist.all_reduce(count, group=ep.data_group)
    ce = nll.sum() / torch.clamp(count, min=1.0)
    lb_share = aux.get("lb_loss_local", zero) / ep.n_data
    return ce + LB_LOSS_COEF * lb_share, {"ce": ce, "lb": lb.detach()}


def _on(batch, device):
    """The batch's arrays (tensors, or anything numpy reads) as tensors on
    `device`."""
    return {k: v.to(device) if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items() if v is not None}


def value_and_grad(cfg, params, batch, *, window: int = 0, ep=None):
    """(loss, {"ce", "lb"}, grads): `loss_fn` and the gradient of every
    leaf of `params` (zeros for a leaf the pass does not read), all
    detached. With `ep` the loss and "ce" are the global ones (the data
    ranks' shares summed) and `grads` this rank's slice of the global
    gradient (`distributed.reduce_gradients` applied)."""
    leaves = tree_leaves(params)
    batch = _on(batch, leaves[0].device)
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in leaves]
        it = iter(live)
        loss, parts = loss_fn(cfg, tree_map(lambda _: next(it), params),
                              batch, window=window, ep=ep)
        flat = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(flat, leaves))
    grads = tree_map(lambda _: next(it), params)
    del flat
    loss, parts = loss.detach(), {k: v.detach() for k, v in parts.items()}
    if ep is not None:
        reduce_gradients(grads, ep)
        shares = torch.stack([loss, parts["ce"]])
        dist.all_reduce(shares, group=ep.data_group)
        loss, parts["ce"] = shares[0], shares[1]
    return loss, parts, grads


def make_train_step(cfg, optimizer: Optional[Optimizer] = None, *,
                    window: int = 0, max_grad_norm: float = 1.0, ep=None):
    """Returns (init_state, train_step).

    init_state(generator, device=None) -> (params, opt_state): parameters
    drawn from a `torch.Generator` on `device` (the card by default; the
    generator must live there). train_step(state, batch) -> (state,
    metrics) with metrics "loss", "ce", "lb", "grad_norm" (0-d tensors);
    the batch may hold numpy arrays or tensors.

    `ep` (the dispatch `distributed.make_expert_parallel_moe` returns) trains
    every MoE layer through the expert-parallel dispatch: init_state then
    returns this rank's slice of the params (`distributed.shard_params`),
    the state a train_step takes is that slice and its optimizer state, the
    batch is this rank's rows, and the metrics are the global ones."""
    if optimizer is None:
        optimizer = make_optimizer(cfg.optimizer,
                                   warmup_cosine(3e-4, 100, 10_000))

    def init_state(generator: torch.Generator, device=None):
        params = T.init_params(cfg, generator, device=device)
        if ep is not None:
            params = shard_params(cfg, params, *ep.ranks)
        return params, optimizer.init(params)

    def train_step(state, batch):
        params, opt_state = state
        loss, parts, grads = value_and_grad(cfg, params, batch,
                                            window=window, ep=ep)
        cuts = None if ep is None else param_cuts(params, ep)
        scale, gnorm = clip_scale(grads, max_grad_norm, cuts)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, params,
                                                  grad_scale=scale,
                                                  cuts=cuts)
            params = apply_updates(params, updates)
        metrics = {"loss": loss, "ce": parts["ce"], "lb": parts["lb"],
                   "grad_norm": gnorm}
        return (params, opt_state), metrics

    return init_state, train_step
