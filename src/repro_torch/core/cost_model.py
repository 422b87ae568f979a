"""Data-movement cost model for MoE speculative verification (paper §2.4):
the part the serving engines and the batch planner price their passes
with. Expert-parallel placement, host-tier residency and wall-clock
calibration are not ported (ROADMAP M4, M5): every function here prices
the flat, single-card deployment.

Single-batch decoding is memory-bandwidth-bound: iteration time is governed
by the bytes fetched from device memory — all attention weights, the
*unique* experts activated by the in-flight tokens, the KV cache read, and
the unembedding. Verifying K+1 tokens multiplies the expert term by the
number of unique experts they collectively activate (bucket-and-balls,
damped by expert affinity), which is exactly why speculation can slow MoEs
down. Under `clock="model"` the engine's times come from here, so they are
deterministic functions of token counts and routing counts."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class Hardware:
    name: str
    hbm_bw: float            # bytes/s
    peak_flops: float        # FLOP/s at serving precision
    ici_bw: float = 0.0      # bytes/s per chip-to-chip link
    weight_bytes: int = 2    # serving precision (bf16/fp16 = 2)
    #: host<->HBM link bandwidth (PCIe/DMA class) — the path an offloaded
    #: (host-tier) expert's weights cross to become HBM-resident
    #: (docs/offload.md). 0 = no offload path: fetch pricing raises.
    host_bw: float = 0.0
    #: HBM capacity in bytes (0 = unspecified). Informational for the
    #: large-config sanity checks; residency caps are set per shard on
    #: `ResidencyState`, not read from here.
    hbm_bytes: float = 0.0


#: NVIDIA H100 SXM (NVIDIA data sheet): 3.35 TB/s HBM3, 989 TFLOP/s dense
#: bf16, 80 GB; host link PCIe Gen5 x16 at about 64 GB/s per direction.
#: The default `hw` of the port's serving engine.
H100_SXM = Hardware("h100-sxm", hbm_bw=3.35e12, peak_flops=989e12,
                    host_bw=64e9, hbm_bytes=80e9)


@dataclass(frozen=True)
class Precision:
    """Bytes-per-param by tensor class — the ONE source of truth for
    serving precision (docs/quantization.md).

    The paper's utility calculus is bytes-moved-per-pass, and quantization
    changes the bytes: int8/fp8 expert weights halve `_expert_read_bytes`,
    shifting the roofline crossover and with it every planner decision
    (break-even floor, grant steering, residency capacity, fetch
    deadlines). A single global `Hardware.weight_bytes` cannot express
    mixed precision — the quantized path keeps dense/attention weights at
    bf16 while experts stream at 1 byte/param — so pricing takes a
    per-tensor-class spec instead. Every bytes function threads this spec;
    the scattered `wb=2` defaults all resolve through `DEFAULT` so a
    precision change cannot silently half-apply.

    `precision=None` everywhere means `Precision.DEFAULT` (all classes at
    2 bytes) and is bit-identical to the pre-quantization stack — the same
    degradation contract as `calibration=None` / `placement=None`, pinned
    by a tier-1 property test."""
    dense: int = 2     # attention / dense-FFN / router / unembedding
    expert: int = 2    # routed expert weights (the quantization target)
    kv: int = 2        # KV-cache rows
    label: str = "bf16"   # telemetry tag; never enters arithmetic

    @classmethod
    def int8_experts(cls) -> "Precision":
        """Weight-only int8 routed experts (per-expert absmax scales,
        dequant-in-kernel); dense/attention/KV stay bf16."""
        return cls(expert=1, label="int8-experts")

    @classmethod
    def fp8_experts(cls) -> "Precision":
        """fp8(e4m3) routed experts — same 1 byte/param pricing as int8;
        the numerics differ (kernels/moe_gmm/quant.py fake-quant on CPU)."""
        return cls(expert=1, label="fp8-experts")

    @property
    def quantized_experts(self) -> bool:
        return self.expert < self.dense


#: module default: bf16 everywhere — what `precision=None` resolves to
Precision.DEFAULT = Precision()


def _resolve_precision(precision: Optional["Precision"],
                       wb: Optional[int] = None) -> "Precision":
    """`precision` if given; else a uniform spec from a legacy `wb` int;
    else the bf16 default. Keeps old `wb=` call sites working while the
    spec stays the single source of truth."""
    if precision is not None:
        return precision
    if wb is not None:
        return Precision(dense=wb, expert=wb, kv=wb, label=f"wb{wb}")
    return Precision.DEFAULT


# --------------------------------------------------------------------- #
# Expert activation statistics (paper §2.4)
# --------------------------------------------------------------------- #

def expected_unique_experts(num_experts: int, top_k: int, n_tokens: int,
                            affinity: float = 0.0) -> float:
    """Expected number of distinct experts activated by `n_tokens` tokens,
    each selecting `top_k` distinct experts.

    affinity=0: uniform-random routing (bucket-and-balls):
        E[unique] = E * (1 - (1 - k/E)^T)
    affinity=1: perfect temporal reuse (all tokens share one expert set).
    The paper observes real tasks fall between the two (§2.4: Mixtral math
    shows 3x instead of the random 3.5x at K=7)."""
    if num_experts == 0:
        return 0.0
    n_tokens = max(int(n_tokens), 1)
    e, k = float(num_experts), float(min(top_k, num_experts))
    rand = e * (1.0 - (1.0 - k / e) ** n_tokens)
    floor = k  # one shared expert set
    return floor + (rand - floor) * (1.0 - affinity)


def expected_unique_experts_batch(num_experts: int, top_k: int,
                                  tokens_per_request, affinity: float = 0.0
                                  ) -> dict:
    """Multi-request extension of `expected_unique_experts`: B requests
    jointly verifying sum(n_i) tokens in one shared pass activate the
    *union* of their expert sets.

    Returns:
        union     — E[unique experts] over all sum(n_i) tokens
        marginal  — per-request marginal contribution,
                    m_i = union(all) - union(all minus request i),
                    the bytes request i adds to the shared verification
                    (it shrinks as the rest of the batch grows, because the
                    batch has already paid for most of i's experts)."""
    ns = [max(int(n), 0) for n in tokens_per_request]
    total = sum(ns)
    if total <= 0:
        return {"union": 0.0, "marginal": [0.0] * len(ns)}
    union = expected_unique_experts(num_experts, top_k, total, affinity)
    marginal = []
    for n in ns:
        if n <= 0:
            marginal.append(0.0)
        elif total - n <= 0:
            marginal.append(union)
        else:
            marginal.append(union - expected_unique_experts(
                num_experts, top_k, total - n, affinity))
    return {"union": union, "marginal": marginal}


# --------------------------------------------------------------------- #
# Per-iteration bytes / flops
# --------------------------------------------------------------------- #

def _per_layer_weight_bytes(cfg, precision: Precision):
    """(attention_bytes, dense_ffn_bytes, one_expert_bytes, shared_bytes).

    Per tensor class: attention/router/dense-FFN price at `precision
    .dense`; routed experts at `precision.expert` (the quantization
    target); shared experts are read every pass like dense FFN and stay at
    dense precision (the quantized path quantizes ROUTED experts only)."""
    attn = cfg._attn_params() * precision.dense
    mult = 3 if cfg.activation == "swiglu" else 2
    if cfg.is_moe:
        expert = mult * cfg.d_model * cfg.moe_d_ff * precision.expert
        shared = (mult * cfg.d_model * cfg.moe_d_ff * cfg.num_shared_experts
                  * precision.dense)
        router = cfg.d_model * cfg.num_experts * precision.dense
        return attn + router, 0, expert, shared
    return attn, mult * cfg.d_model * cfg.d_ff * precision.dense, 0, 0


def kv_bytes_per_token(cfg, wb: int) -> float:
    """KV-cache bytes appended per token per layer (`wb` = the precision
    spec's `kv` class)."""
    if cfg.use_mla:
        return (cfg.kv_lora_rank + cfg.qk_rope_dim) * wb
    if cfg.attention_free:
        return 0.0
    return 2 * cfg.num_kv_heads * cfg.head_dim * wb


def _weight_read_bytes(cfg, precision: Precision) -> float:
    """Dense weight bytes read once per iteration regardless of batch:
    attention + dense/shared FFN + router + unembedding (expert bytes are
    accounted separately — they scale with the activated-expert union)."""
    kinds = cfg.layer_kinds()
    wb = precision.dense
    attn_b, ffn_b, expert_b, shared_b = _per_layer_weight_bytes(cfg,
                                                                precision)
    del expert_b
    weights = 0.0
    for k in kinds:
        if k in ("A", "X"):
            weights += attn_b + ffn_b
            if k == "X":
                weights += attn_b  # cross-attention weights
            if cfg.is_moe:
                weights += shared_b
        elif k == "R":
            weights += cfg._rglru_layer_params() * wb + ffn_b
            if not ffn_b:  # hybrid is dense-ffn
                weights += 3 * cfg.d_model * cfg.d_ff * wb
        elif k == "W":
            weights += cfg._rwkv_layer_params() * wb
    # unembedding is read every iteration; embedding read is per-token rows
    weights += cfg.vocab_size * cfg.d_model * wb
    return weights


def _expert_read_bytes(cfg, unique_experts: float,
                       precision: Precision) -> float:
    """Expert weight bytes for `unique_experts` activated per MoE layer —
    priced at the spec's `expert` class, the term quantization shrinks."""
    if not cfg.is_moe:
        return 0.0
    _, _, expert_b, _ = _per_layer_weight_bytes(cfg, precision)
    n_moe = sum(1 for k in cfg.layer_kinds() if k in ("A", "X"))
    return n_moe * min(unique_experts, cfg.num_experts) * expert_b


def _kv_read_bytes(cfg, context_len: int, window: int,
                   precision: Precision) -> float:
    """Per-request state read: KV cache rows (windowed layers read only the
    window) plus recurrent-state reads."""
    kv_read = 0.0
    for k in cfg.layer_kinds():
        if k in ("A", "X"):
            lw = window
            if cfg.layer_pattern and k == "A":
                lw = cfg.local_window
            ctx = context_len if not lw else min(context_len, lw)
            kv_read += ctx * kv_bytes_per_token(cfg, precision.kv)
        elif k == "W":
            kv_read += cfg.rwkv_num_heads * cfg.rwkv_head_size ** 2 * 4
        elif k == "R":
            kv_read += cfg.d_rnn * 4
    return kv_read


def iteration_bytes(cfg, n_tokens: int, context_len: int,
                    unique_experts: float = None, affinity: float = 0.0,
                    window: int = 0, wb: int = None,
                    precision: Optional[Precision] = None) -> dict:
    """HBM bytes moved by one target-model iteration processing `n_tokens`
    in-flight tokens against a `context_len`-token KV cache. `precision`
    prices each tensor class (`wb` kept as a legacy uniform override)."""
    p = _resolve_precision(precision, wb)
    if cfg.is_moe and unique_experts is None:
        unique_experts = expected_unique_experts(
            cfg.num_experts, cfg.experts_per_token, n_tokens, affinity)

    weights = _weight_read_bytes(cfg, p)
    experts = _expert_read_bytes(cfg, unique_experts or 0.0, p)
    kv_read = _kv_read_bytes(cfg, context_len, window, p)

    return {"weights": weights, "experts": experts, "kv": kv_read,
            "total": weights + experts + kv_read,
            "unique_experts": unique_experts or 0.0}


def iteration_flops(cfg, n_tokens: int, context_len: int,
                    window: int = 0) -> float:
    """Approximate FLOPs of one iteration over n_tokens in-flight tokens."""
    active = cfg.active_param_count()
    flops = 2.0 * active * n_tokens
    # attention over the cache
    kinds = cfg.layer_kinds()
    for k in kinds:
        if k in ("A", "X"):
            lw = cfg.local_window if (cfg.layer_pattern and k == "A") else window
            ctx = context_len if not lw else min(context_len, lw)
            hd = cfg.head_dim if not cfg.use_mla else cfg.kv_lora_rank + cfg.qk_rope_dim
            flops += 4.0 * n_tokens * ctx * cfg.num_heads * hd
    return flops


# --------------------------------------------------------------------- #
# Iteration time
# --------------------------------------------------------------------- #

def iteration_time(cfg, hw: Hardware, n_tokens: int, context_len: int,
                   unique_experts: float = None, affinity: float = 0.0,
                   window: int = 0, fixed_overhead: float = 2e-4,
                   precision: Optional[Precision] = None) -> dict:
    """Seconds for one target iteration. max(memory, compute) + overhead —
    single-batch decode is deep in the memory-bound regime, so the memory
    term dominates everywhere the paper (and we) evaluate."""
    b = iteration_bytes(cfg, n_tokens, context_len, unique_experts,
                        affinity, window, precision=precision)
    f = iteration_flops(cfg, n_tokens, context_len, window)
    t_mem = b["total"] / hw.hbm_bw
    t_compute = f / hw.peak_flops
    t = max(t_mem, t_compute) + fixed_overhead
    return {"t_iter": t, "t_mem": t_mem, "t_compute": t_compute,
            "bytes": b["total"], "expert_bytes": b["experts"],
            "flops": f, "unique_experts": b["unique_experts"]}


# --------------------------------------------------------------------- #
# Shared (batched) verification passes
# --------------------------------------------------------------------- #

def batch_iteration_time(cfg, hw: Hardware, tokens_per_request,
                         context_lens, *, unique_experts: float = None,
                         per_request_unique=None, affinity: float = 0.0,
                         window: int = 0, fixed_overhead: float = 2e-4,
                         prefill_tokens=None,
                         precision: Optional[Precision] = None) -> dict:
    """Seconds for one *shared* verification pass over B requests, request i
    contributing n_i = tokens_per_request[i] in-flight tokens against its own
    context_lens[i]-token KV cache.

    The batch moves: dense weights ONCE (the whole point of batching), the
    *union* of activated expert weights (what the paper's data movement
    scales with, now across requests), and each request's own KV rows. `unique_experts`
    overrides the analytic union with a measured per-layer mean; at B=1 with
    identical inputs this reduces exactly to `iteration_time`.

    Per-request attribution ("marginal-bytes split", consumed by each
    request's Cascade controller so per-request utility stays meaningful
    under shared verification):
      * KV bytes       -> owned outright by the request;
      * expert bytes   -> split in proportion to each request's marginal
                          expert contribution m_i = union(all) -
                          union(all \\ i) (or to measured per-request unique
                          counts when `per_request_unique` is given);
      * dense weights + fixed overhead -> split evenly.
    sum_i(t_attr_i) == t_iter by construction.

    `prefill_tokens` ([B] ints, default all-zero) marks how many of each
    request's in-flight tokens are co-scheduled prompt-chunk tokens: they
    add the chunk's KV writes, its embedding-row reads and causal attention
    over itself, the terms `prefill_time` prices for blocking admission.

    `precision` prices each tensor class separately (quantized experts
    shrink the expert term); None is `Precision.DEFAULT`, bit for bit.

    Returns iteration_time's keys plus `per_request` (list of dicts with
    t_attr / bytes_attr / marginal_experts), `n_requests`, `n_tokens`,
    `precision` (the spec's label) and `expert_bytes_saved` (expert bytes
    this pass did not move against bf16 storage)."""
    p = _resolve_precision(precision)
    ns = [max(int(n), 0) for n in tokens_per_request]
    cls = list(context_lens)
    if len(ns) != len(cls):
        raise ValueError(f"{len(ns)} token counts vs {len(cls)} contexts")
    b_req = len(ns)
    total_tokens = sum(ns)
    ps = ([0] * b_req if prefill_tokens is None else
          [max(int(p), 0) for p in prefill_tokens])
    if len(ps) != b_req:
        raise ValueError(f"{len(ps)} prefill counts vs {b_req} requests")

    est = expected_unique_experts_batch(
        cfg.num_experts, cfg.experts_per_token, ns, affinity) \
        if cfg.is_moe else {"union": 0.0, "marginal": [0.0] * b_req}
    union = est["union"] if unique_experts is None else float(unique_experts)

    weights = _weight_read_bytes(cfg, p)
    experts = _expert_read_bytes(cfg, union, p)
    n_attn = sum(1 for k in cfg.layer_kinds() if k in ("A", "X"))
    prefill_bytes_per_tok = (kv_bytes_per_token(cfg, p.kv) * n_attn
                             + cfg.d_model * p.dense)  # KV write + embed row
    kv_each = [_kv_read_bytes(cfg, c, window, p)
               + pt * prefill_bytes_per_tok if n > 0 else 0.0
               for n, c, pt in zip(ns, cls, ps)]
    total_bytes = weights + experts + sum(kv_each)

    flops = sum(iteration_flops(cfg, n, c + pt, window)
                for n, c, pt in zip(ns, cls, ps) if n > 0)
    t_mem = total_bytes / hw.hbm_bw
    t_compute = flops / hw.peak_flops
    t = max(t_mem, t_compute) + fixed_overhead

    # ---- marginal-bytes attribution -------------------------------------
    # the fixed overhead is split evenly: every live request needs it
    non_bytes = fixed_overhead
    live = [i for i, n in enumerate(ns) if n > 0]
    n_live = max(len(live), 1)
    if per_request_unique is not None:
        mweights = [max(float(u), 0.0) for u in per_request_unique]
    else:
        mweights = est["marginal"]
    msum = sum(mweights[i] for i in live)
    per_request = []
    for i, n in enumerate(ns):
        if n <= 0:
            per_request.append({"t_attr": 0.0, "bytes_attr": 0.0,
                                "marginal_experts": 0.0})
            continue
        if len(live) == 1:
            # sole live request owns the pass outright (bit-exact reduction
            # to iteration_time — no float round-trip through the split)
            per_request.append({"t_attr": t, "bytes_attr": total_bytes,
                                "marginal_experts": est["marginal"][i]})
            continue
        frac_e = (mweights[i] / msum) if msum > 0 else 1.0 / n_live
        bytes_i = weights / n_live + experts * frac_e + kv_each[i]
        t_attr = ((t - non_bytes) * bytes_i / total_bytes
                  if total_bytes > 0 else 0.0) + non_bytes / n_live
        per_request.append({"t_attr": t_attr, "bytes_attr": bytes_i,
                            "marginal_experts": est["marginal"][i]})

    return {"t_iter": t, "t_mem": t_mem, "t_compute": t_compute,
            "bytes": total_bytes, "expert_bytes": experts, "flops": flops,
            "unique_experts": union, "n_requests": b_req,
            "n_tokens": total_tokens, "per_request": per_request,
            "precision": p.label,
            # bytes the expert stream saved vs pricing it at the bf16
            # default (exact: expert bytes are linear in bytes-per-param)
            "expert_bytes_saved": (experts
                                   * (Precision.DEFAULT.expert - p.expert)
                                   / p.expert)}


class BatchCostOracle:
    """Repeated `batch_iteration_time` total-time queries over candidate
    token allocations, with everything except `tokens_per_request` held
    fixed (contexts, prefill chunks, hardware, affinity, precision).

    The batch planner's water-filling evaluates O(B * k_max) candidate
    allocations per engine step, so this caches the allocation-independent
    terms (dense weight read, per-row KV/prefill bytes) at construction.
    `t_batch(ns)` returns exactly `batch_iteration_time(...)["t_iter"]` for
    the same inputs: same expressions, same float-op order."""

    def __init__(self, cfg, hw: Hardware, context_lens, *,
                 affinity: float = 0.0, window: int = 0,
                 fixed_overhead: float = 2e-4, prefill_tokens=None,
                 precision: Optional[Precision] = None):
        p = _resolve_precision(precision)
        self.precision = p
        self.cfg = cfg
        self.hw = hw
        self.affinity = affinity
        self.window = window
        self.fixed_overhead = fixed_overhead
        self.cls = list(context_lens)
        b = len(self.cls)
        self.ps = ([0] * b if prefill_tokens is None else
                   [max(int(p), 0) for p in prefill_tokens])
        if len(self.ps) != b:
            raise ValueError(f"{len(self.ps)} prefill counts vs {b} contexts")
        self._weights = _weight_read_bytes(cfg, p)
        n_attn = sum(1 for k in cfg.layer_kinds() if k in ("A", "X"))
        prefill_bytes_per_tok = (kv_bytes_per_token(cfg, p.kv) * n_attn
                                 + cfg.d_model * p.dense)
        # per-row bytes IF the row is live (n_i > 0); dead rows cost nothing
        self._kv_live = [_kv_read_bytes(cfg, c, window, p)
                         + pt * prefill_bytes_per_tok
                         for c, pt in zip(self.cls, self.ps)]

    def t_batch(self, tokens_per_request) -> float:
        """Seconds for one shared pass at this token allocation (scalar —
        no attribution; use `batch_iteration_time` for the full split)."""
        ns = [max(int(n), 0) for n in tokens_per_request]
        if len(ns) != len(self.cls):
            raise ValueError(f"{len(ns)} token counts vs "
                             f"{len(self.cls)} contexts")
        cfg, hw = self.cfg, self.hw
        total = sum(ns)
        union = (expected_unique_experts(cfg.num_experts,
                                         cfg.experts_per_token, total,
                                         self.affinity)
                 if cfg.is_moe and total > 0 else 0.0)
        experts = _expert_read_bytes(cfg, union, self.precision)
        total_bytes = self._weights + experts + sum(
            kv if n > 0 else 0.0 for n, kv in zip(ns, self._kv_live))
        flops = sum(iteration_flops(cfg, n, c + p, self.window)
                    for n, c, p in zip(ns, self.cls, self.ps) if n > 0)
        t_mem = total_bytes / hw.hbm_bw
        t_compute = flops / hw.peak_flops
        return max(t_mem, t_compute) + self.fixed_overhead


# --------------------------------------------------------------------- #
# Prefill pricing (chunked admission — the compute-bound regime)
# --------------------------------------------------------------------- #

def prefill_chunk_bytes(cfg, n_tokens: int, context_len: int = 0,
                        unique_experts: float = None, affinity: float = 0.0,
                        window: int = 0, wb: int = None,
                        precision: Optional[Precision] = None) -> dict:
    """HBM bytes moved by one prefill chunk of `n_tokens` prompt tokens
    entering a cache that already holds `context_len` tokens.

    Differs from decode `iteration_bytes` in two ways that matter for TTFT:
    the chunk *writes* its own KV rows (decode's single-token append is
    negligible; a 128-token chunk's is not), and the expert union is driven
    by the chunk's full token count, which saturates toward `num_experts`
    far faster than a [1+K] decode span."""
    p = _resolve_precision(precision, wb)
    n_tokens = max(int(n_tokens), 0)
    if cfg.is_moe and unique_experts is None:
        unique_experts = expected_unique_experts(
            cfg.num_experts, cfg.experts_per_token, n_tokens, affinity)
    weights = _weight_read_bytes(cfg, p)
    experts = _expert_read_bytes(cfg, unique_experts or 0.0, p)
    kv_read = _kv_read_bytes(cfg, context_len, window, p)
    n_attn = sum(1 for k in cfg.layer_kinds() if k in ("A", "X"))
    kv_write = n_tokens * kv_bytes_per_token(cfg, p.kv) * n_attn
    embed = n_tokens * cfg.d_model * p.dense  # embedding-row reads per token
    total = weights + experts + kv_read + kv_write + embed
    return {"weights": weights, "experts": experts, "kv": kv_read,
            "kv_write": kv_write, "embed": embed, "total": total,
            "unique_experts": unique_experts or 0.0}


def prefill_time(cfg, hw: Hardware, n_tokens: int, context_len: int = 0,
                 unique_experts: float = None, affinity: float = 0.0,
                 window: int = 0, fixed_overhead: float = 2e-4,
                 precision: Optional[Precision] = None) -> dict:
    """Seconds for one prefill pass/chunk under the model clock. Unlike
    decode, prefill crosses the roofline: FLOPs grow linearly (and the
    attention term quadratically) with the chunk while the dominant weight
    read stays constant, so large chunks are compute-bound — max(memory,
    compute) switches sides, which is exactly why the model clock must price
    prefill separately for TTFT to mean anything."""
    n_tokens = max(int(n_tokens), 1)
    b = prefill_chunk_bytes(cfg, n_tokens, context_len, unique_experts,
                            affinity, window, precision=precision)
    # the chunk attends causally to the cached context plus itself
    f = iteration_flops(cfg, n_tokens, context_len + n_tokens, window)
    t_mem = b["total"] / hw.hbm_bw
    t_compute = f / hw.peak_flops
    t = max(t_mem, t_compute) + fixed_overhead
    return {"t_iter": t, "t_mem": t_mem, "t_compute": t_compute,
            "bytes": b["total"], "expert_bytes": b["experts"],
            "flops": f, "unique_experts": b["unique_experts"],
            "compute_bound": t_compute >= t_mem}


def draft_time(hw: Hardware, k: int, drafter_active_params: int = 0,
               per_token_overhead: float = 2e-5,
               wb: int = None,
               precision: Optional[Precision] = None) -> float:
    """Drafting cost: ~free for n-gram (CPU table lookup), weight-bound for
    model drafters (EAGLE-style). Drafter weights price at the dense class
    of `precision` (docs/quantization.md) — a quantized drafter (e.g.
    `Precision(dense=1, ...)` for int8 drafter storage) halves the model
    term's bytes, shrinking the speculation overhead every utility ratio
    and fetch-hide window is built on. `precision=None` prices at
    `Precision.DEFAULT.dense` (bf16), bit-identical to before; an explicit
    `wb` byte width overrides the precision class, matching the byte
    helpers' precedence."""
    if k <= 0:
        return 0.0
    if wb is None:
        wb = (precision.dense if precision is not None
              else Precision.DEFAULT.dense)
    model = (k * drafter_active_params * wb / hw.hbm_bw
             if drafter_active_params else 0.0)
    return model + k * per_token_overhead


def sample_time(k: int, per_token: float = 1.5e-5) -> float:
    """Rejection-sampling cost, linear in verified tokens (paper: 1-2%)."""
    return (k + 1) * per_token


def expected_emitted(accept_rate: float, k: int) -> float:
    """Expected tokens emitted by a [1+k] speculative span when each draft
    is accepted i.i.d. with probability `accept_rate`: the truncated
    geometric series of the paper's ETR (Def. 4.1; k=0 -> exactly 1)."""
    a = min(max(accept_rate, 0.0), 0.999)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


def expected_emitted_curve(curve, k: int) -> float:
    """`expected_emitted` over a per-position acceptance curve
    (`UtilityAnalyzer.accept_curve`): E[emitted] = 1 + sum over depths j of
    prod_{p<j} curve[p]. Positions past the curve reuse its last value;
    k=0 -> exactly 1."""
    if k <= 0:
        return 1.0
    tot, p = 1.0, 1.0
    for j in range(k):
        c = curve[j] if j < len(curve) else (curve[-1] if curve else 0.0)
        p *= min(max(c, 0.0), 0.999)
        tot += p
    return tot


# --------------------------------------------------------------------- #
# Analytic K prior: warm-start Cascade's hill-climb
# --------------------------------------------------------------------- #

def expected_utility(cfg, hw: Hardware, k: int, accept_rate: float,
                     context_len: int = 1024, affinity: float = 0.3,
                     drafter_params: int = 0) -> float:
    """Analytic Definition-4.1 utility of speculating K tokens when draft
    acceptance is ~accept_rate: ETR from the truncated geometric series,
    cost from the data-movement model."""
    if k <= 0:
        return 1.0
    etr = expected_emitted(accept_rate, k)
    base = iteration_time(cfg, hw, 1, context_len, affinity=affinity)
    spec = iteration_time(cfg, hw, k + 1, context_len, affinity=affinity)
    t_spec = spec["t_iter"] + draft_time(hw, k, drafter_params) + \
        sample_time(k)
    return etr / (t_spec / base["t_iter"])


def suggest_k_start(cfg, hw: Hardware = H100_SXM, *,
                    accept_rate: float = 0.5, k_max: int = 8,
                    context_len: int = 1024, affinity: float = 0.3,
                    drafter_params: int = 0) -> int:
    """Bucket-and-balls prior for Cascade's first trial K: the analytic
    utility-maximizing K for this architecture, so MoEs with steep
    expert-activation curves start conservatively and dense models
    aggressively. The test-and-set loop still measures and adapts."""
    best_k, best_u = 1, -1.0
    for k in range(1, k_max + 1):
        u = expected_utility(cfg, hw, k, accept_rate, context_len, affinity,
                             drafter_params)
        if u > best_u:
            best_k, best_u = k, u
    return best_k
