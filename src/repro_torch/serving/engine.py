"""Serving engines: the vLLM-analogue decode loop with speculative decoding
and Cascade in the loop. Two engines share the verification math.

`ServingEngine` serves one request at a time (the paper's single-batch,
latency-bound setting). Per iteration (paper Fig. 14's spec-decode worker):
    1. controller.next_k() -> K            (Cascade / static policy)
    2. drafter.propose(history, K)         (n-gram)
    3. decode_step over [last_token, d_0..d_{K-1}]   (verification)
    4. greedy verify or rejection sample -> accepted prefix + next token
    5. rollback cache to the accepted length
    6. controller.observe(tokens, t_iter, breakdown)

`BatchedEngine` batches continuously: a slot table of up to `max_batch`
in-flight requests, each with its own Cascade controller, drafter and cache
row. One `step()` drafts per-request K_i under the joint planner, packs the
ragged [1+K_i] spans (and pending prefill chunks) into one padded
verification pass, verifies per row, rolls every row back to its own
accepted length, and attributes the shared cost back to requests through
the cost model's marginal-bytes split. What the batch's cost scales with
is the *union* of experts the B spans activate.

Timing source: 'wall' is the host clock around work that ends in a device
synchronize; 'model' is the deterministic data-movement cost model driven
by the measured unique-expert activations of each pass, priced for
`hw` (`core.cost_model.H100_SXM` by default)."""

from __future__ import annotations

import time
import dataclasses
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core import cost_model as cm
from repro_torch.core.controller import CascadeController
from repro_torch.core.planner import BatchSpecPlanner, PlannerConfig
from repro_torch.core.slo import RequestSLO
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.moe import packed_expert_cap

from .drafter import Drafter, NGramDrafter
from .sampler import greedy_verify, logits_to_probs, rejection_sample, sample_token
from .telemetry import (EngineTelemetry, IterationTelemetry,
                        RequestTelemetry, StepTelemetry)


@dataclass
class GenerationResult:
    tokens: List[int]
    telemetry: RequestTelemetry


def _sample_logits(rng: np.random.Generator, logits: np.ndarray,
                   temperature: float) -> int:
    """Temperature-gated sampling: argmax at temperature <= 0, softmax
    sample otherwise."""
    if temperature <= 0:
        return int(np.argmax(logits))
    probs = logits_to_probs(torch.from_numpy(logits), temperature).numpy()
    return sample_token(rng, probs)


def _spec_room(controller, drafter=None) -> int:
    """Worst-case tokens one speculative iteration may append: 1 (the
    committed token) + the controller's K ceiling. Fallback chain:
    controller config k_max -> static controller k -> drafter proposal cap
    -> 15."""
    cfg = getattr(controller, "config", None)
    k_cap = getattr(cfg, "k_max", None) if cfg is not None else None
    if k_cap is None:
        k_cap = getattr(controller, "k", None)
    if k_cap is None:
        k_cap = getattr(drafter, "max_propose", None)
    if k_cap is None:
        k_cap = 15
    return 1 + int(k_cap)


def _truncate_at_stop(emitted: List[int], stop_token: Optional[int]
                      ) -> tuple:
    """Cut an iteration's emitted tokens at the first stop token
    (inclusive): a stop token accepted mid-draft terminates the request."""
    if stop_token is None or stop_token not in emitted:
        return emitted, False
    return emitted[:emitted.index(stop_token) + 1], True


def _refuse_enc_out(enc_out) -> None:
    """Encoder-decoder requests carry an encoder output; the port serves
    decoder-only models, so only enc_out=None is accepted."""
    if enc_out is not None:
        raise NotImplementedError(
            "enc_out: encoder-decoder (Whisper) cross-attention is not "
            "ported yet (ROADMAP queue 1 item 8)")


def _device_clock(device: torch.device) -> float:
    """Host clock after the device's queued work has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _prefill_clock(cfg, hw, clock: str, n_tokens: int, wall: float, *,
                   affinity: float, window: int, precision=None) -> float:
    """Prefill seconds on the engine's clock: wall seconds under
    clock="wall", cm.prefill_time under the model clock."""
    if clock == "wall":
        return wall
    return cm.prefill_time(cfg, hw, n_tokens, affinity=affinity,
                           window=window, precision=precision)["t_iter"]


class ServingEngine:
    """Single-request-at-a-time serving (the paper's single-batch,
    latency-bound setting). `params` must lie on `device` (the card unless
    the caller passes device="cpu")."""

    def __init__(self, cfg, params, drafter: Drafter, *,
                 controller_factory: Callable = None,
                 clock: str = "model",
                 hw: cm.Hardware = cm.H100_SXM,
                 affinity: float = 0.0,
                 window: int = 0,
                 max_len: int = 2048,
                 temperature: float = 1.0,
                 seed: int = 0,
                 drafter_precision: Optional[cm.Precision] = None,
                 device=None):
        if clock not in ("wall", "model"):
            raise ValueError(f"unknown clock {clock!r}")
        self.device = resolve_device(device)
        p_dev = params["embed"]["embedding"].device
        if p_dev.type != self.device.type:
            raise ValueError(f"params lie on {p_dev}, engine runs on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.drafter = drafter
        #: bytes-per-param pricing for the drafter's weight reads
        self.drafter_precision = drafter_precision
        self.controller_factory = controller_factory or (
            lambda: CascadeController())
        self.clock = clock
        self.hw = hw
        self.affinity = affinity
        self.window = window
        self.max_len = max_len
        self.temperature = temperature
        self.rng = np.random.default_rng(seed)

    # ------------------------------------------------------------------ #

    def _iter_time(self, n_tokens: int, context_len: int,
                   unique_experts: Optional[float], wall: float) -> float:
        """Virtual (cost-model) or wall-clock verification time."""
        if self.clock == "wall":
            return wall
        r = cm.iteration_time(self.cfg, self.hw, n_tokens, context_len,
                              unique_experts=unique_experts,
                              affinity=self.affinity, window=self.window)
        return r["t_iter"]

    def _draft_time(self, k: int) -> float:
        return cm.draft_time(self.hw, k, self.drafter.active_params,
                             precision=self.drafter_precision)

    # ------------------------------------------------------------------ #

    def generate(self, prompt: List[int], max_new: int = 128, *,
                 controller=None, request_id: str = "", task: str = "",
                 stop_token: Optional[int] = None,
                 enc_out=None) -> GenerationResult:
        cfg = self.cfg
        _refuse_enc_out(enc_out)
        if not prompt:
            raise ValueError("empty prompt — nothing to prefill")
        if len(prompt) >= self.max_len:
            raise ValueError(f"prompt of {len(prompt)} tokens cannot fit a "
                             f"max_len={self.max_len} cache")
        controller = controller or self.controller_factory()
        self.drafter.reset()
        tel = RequestTelemetry(request_id=request_id, task=task,
                               prompt_len=len(prompt))

        cache = T.init_cache(cfg, 1, self.max_len, window=self.window,
                             device=self.device)
        toks = torch.tensor([prompt], dtype=torch.int32, device=self.device)
        t0 = _device_clock(self.device)
        logits, cache, _ = T.prefill(cfg, self.params, toks, cache,
                                     window=self.window)
        logits = logits[0, -1].float().cpu().numpy()
        wall_prefill = _device_clock(self.device) - t0
        tel.t_prefill = _prefill_clock(cfg, self.hw, self.clock,
                                       len(prompt), wall_prefill,
                                       affinity=self.affinity,
                                       window=self.window)
        tel.ttft = tel.t_prefill  # serial engine: no admission queue

        history = list(prompt)
        # first output token comes from the prefill logits
        last_tok = self._sample(logits)
        out: List[int] = [last_tok]
        history.append(last_tok)
        if stop_token is not None and last_tok == stop_token:
            return GenerationResult(out[:max_new], tel)

        margin = _spec_room(controller, self.drafter)
        it = 0
        while len(out) < max_new:
            if len(history) + margin > self.max_len:
                break  # next span of up to 1+k_max tokens would overflow
            k_req = controller.next_k()
            t0 = time.perf_counter()
            drafts, draft_probs = self.drafter.propose(history, k_req,
                                                       rng=self.rng)
            wall_draft = time.perf_counter() - t0
            # never let a span write past the cache even if a drafter
            # over-proposes; windowed rings bound spans to their SPEC_PAD
            # spill slots so speculative writes cannot clobber the window
            room = self.max_len - len(history)
            if self.window:
                room = min(room, T.SPEC_PAD - 1)
            if len(drafts) > room:
                drafts = drafts[:max(room, 0)]
                if draft_probs is not None:
                    draft_probs = draft_probs[:len(drafts)]
            k_eff = len(drafts)

            step_toks = torch.tensor([[last_tok] + drafts], dtype=torch.int32,
                                     device=self.device)
            len_before = int(cache["length"])
            t1 = _device_clock(self.device)
            lo, new_cache, aux, staged = T.decode_step(
                cfg, self.params, cache, step_toks, window=self.window)
            lo = lo[0].float().cpu().numpy()             # [K+1, V]
            wall_verify = _device_clock(self.device) - t1

            t2 = time.perf_counter()
            if self.temperature <= 0:
                res = greedy_verify(lo, drafts)
            else:
                probs = logits_to_probs(torch.from_numpy(lo),
                                        self.temperature).numpy()
                res = rejection_sample(self.rng, probs, drafts, draft_probs)
            wall_sample = time.perf_counter() - t2

            n_keep = 1 + res.n_accepted           # last_tok + accepted drafts
            cache = T.rollback_cache(cfg, new_cache, staged, n_keep,
                                     len_before)
            emitted, stopped = _truncate_at_stop(
                res.accepted + [res.next_token], stop_token)
            out.extend(emitted)
            history.extend(emitted)
            last_tok = emitted[-1]

            uniq = None
            if cfg.is_moe:
                uniq = float(np.mean(aux["unique_experts"].cpu().numpy()))
            t_verify = self._iter_time(k_eff + 1, len_before, uniq,
                                       wall_verify)
            t_draft = (wall_draft if self.clock == "wall"
                       else self._draft_time(k_eff))
            t_sample = (wall_sample if self.clock == "wall"
                        else cm.sample_time(k_eff))
            t_iter = t_draft + t_verify + t_sample

            controller.observe(len(emitted), t_iter, t_draft=t_draft,
                               t_verify=t_verify, t_sample=t_sample,
                               k=k_eff if k_req > 0 else 0)
            tel.iterations.append(IterationTelemetry(
                iteration=it, k_requested=k_req, k_drafted=k_eff,
                tokens_emitted=len(emitted), t_iter=t_iter, t_draft=t_draft,
                t_verify=t_verify, t_sample=t_sample,
                unique_experts=uniq or 0.0, context_len=len_before,
                phase=getattr(controller, "phase", ""),
                utility=controller.utility(),
                t_pass=t_iter))  # single-request: the pass IS the request's
            it += 1
            if stopped:
                break
        return GenerationResult(out[:max_new], tel)

    # ------------------------------------------------------------------ #

    def _sample(self, logits: np.ndarray) -> int:
        return _sample_logits(self.rng, logits, self.temperature)


# ===================================================================== #
# Continuous batching
# ===================================================================== #

@dataclass
class _Slot:
    """One in-flight request: its own controller, drafter, rng stream,
    telemetry and token state. The model-side state is row `index` of the
    engine's per-row batched cache. A chunk-admitted slot starts in
    phase="prefill" with its prompt pending; step() feeds it chunk by chunk
    until the prompt is consumed, samples the first output token, and flips
    it to phase="decode"."""
    index: int
    request_id: str
    task: str
    max_new: int
    stop_token: Optional[int]
    controller: object
    drafter: Drafter
    rng: np.random.Generator
    tel: RequestTelemetry
    history: List[int]
    out: List[int]
    last_tok: int
    done: bool = False
    iteration: int = 0
    phase: str = "decode"            # "prefill" -> "decode"
    prompt: Optional[List[int]] = None   # pending prompt (chunked admission)
    prefill_pos: int = 0             # prompt tokens already in the cache
    t_submit: float = 0.0            # engine-clock time of submission
    queue_seen: bool = False         # t_queue recorded yet?
    seq: int = 0                     # admission order (FIFO prefill packing)
    slo: Optional[RequestSLO] = None  # latency objective


class BatchedEngine:
    """Continuous-batching serving engine. `params` must lie on `device`
    (the card unless the caller passes device="cpu").

    API:
        join(prompt, ...) -> slot    admit a request into a free cache row
                                     (raises when full). chunk=0: blocking
                                     prefill here; chunk>0: non-blocking,
                                     prefill runs chunked inside step()
        step() -> {slot: emitted}    one shared pass packing speculative
                                     decode spans AND pending prefill chunks
                                     (budgeted by max_prefill_tokens_per_step)
        retire(slot) -> result       collect a finished request, free the row
        generate(prompt, ...)        drive one request to completion

    Each request keeps its own Cascade controller; the shared verification
    cost is attributed back per request via the cost model's marginal-bytes
    split, so per-request utility stays meaningful under batching. The
    engine clock `now` (virtual under clock="model") prices admission too:
    queue delay, chunked or blocking prefill, and TTFT are on one clock.

    `policy` selects how the per-request asks become per-step draft
    allocations: "joint" (default) runs the `BatchSpecPlanner`'s
    marginal-utility water-filling over the shared pass; "independent"
    grants every ask. At B=1 the two are bit-identical. A supplied
    `planner` (say, one with a wall-clock `Calibration`) replaces the
    engine's own; its policy, precision and drafter precision must agree
    with the engine's.

    `packed=True` verifies on the union-packed MoE path. `precision` prices
    the passes (and `Precision.int8_experts()` is the one to pass when the
    params hold int8 experts); `drafter_precision` prices the drafter's
    weight reads.

    Only the flat deployment is ported: an expert-parallel `placement` of
    more than one shard (ROADMAP M5) and a `residency` with a host tier
    (ROADMAP M4) raise NotImplementedError; a one-shard placement and an
    all-device residency are the flat engine and are accepted."""

    def __init__(self, cfg, params, drafter_factory: Callable = None, *,
                 max_batch: int = 8,
                 controller_factory: Callable = None,
                 clock: str = "model",
                 hw: cm.Hardware = cm.H100_SXM,
                 affinity: float = 0.0,
                 window: int = 0,
                 max_len: int = 2048,
                 temperature: float = 1.0,
                 seed: int = 0,
                 chunk: int = 0,
                 max_prefill_tokens_per_step: Optional[int] = None,
                 policy: Optional[str] = None,
                 planner: Optional[BatchSpecPlanner] = None,
                 placement=None,
                 packed: bool = False,
                 residency=None,
                 precision: Optional[cm.Precision] = None,
                 drafter_precision: Optional[cm.Precision] = None,
                 device=None):
        if clock not in ("wall", "model"):
            raise ValueError(f"unknown clock {clock!r}")
        if placement is not None and getattr(placement, "n_shards", 1) > 1:
            raise NotImplementedError(
                "expert-parallel placements are not ported yet (ROADMAP M5)")
        if residency is not None and getattr(residency, "has_host_tier",
                                             True):
            raise NotImplementedError(
                "host-tier expert residency is not ported yet (ROADMAP M4)")
        self.device = resolve_device(device)
        p_dev = params["embed"]["embedding"].device
        if p_dev.type != self.device.type:
            raise ValueError(f"params lie on {p_dev}, engine runs on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.drafter_factory = drafter_factory or (lambda: NGramDrafter())
        self.controller_factory = controller_factory or (
            lambda: CascadeController())
        self.max_batch = max_batch
        self.clock = clock
        self.hw = hw
        self.affinity = affinity
        self.window = window
        self.max_len = max_len
        self.temperature = temperature
        self.seed = seed
        # chunk=0: blocking prefill inside join(). chunk>0: join() only
        # enqueues; step() co-schedules up to `chunk` prompt tokens per
        # request into the shared verification pass, bounded by the
        # admission budget below.
        self.chunk = int(chunk)
        if max_prefill_tokens_per_step is None:
            max_prefill_tokens_per_step = self.chunk * max_batch
        self.max_prefill_tokens_per_step = int(max_prefill_tokens_per_step)
        # a supplied planner's own config is the source of truth for the
        # policy; an explicit `policy` argument must agree with it
        if planner is not None:
            if policy is not None and policy != planner.config.policy:
                raise ValueError(
                    f"policy={policy!r} contradicts the supplied planner's "
                    f"policy={planner.config.policy!r}")
            policy = planner.config.policy
        policy = policy or "joint"
        if policy not in ("joint", "independent"):
            raise ValueError(f"unknown planner policy {policy!r} "
                             "(expected 'joint' or 'independent')")
        self.policy = policy
        # a supplied planner must price the same bytes as the engine: one
        # fit to bf16 experts would mispredict every int8 step, and the
        # drafter's weights likewise
        if planner is not None:
            for name, ours in (("precision", precision),
                               ("drafter_precision", drafter_precision)):
                theirs = getattr(planner, name)
                if (ours or cm.Precision.DEFAULT) != \
                        (theirs or cm.Precision.DEFAULT):
                    raise ValueError(
                        f"{name}={ours!r} contradicts the supplied "
                        f"planner's {name}={theirs!r}")
        #: bytes-per-param pricing the cost model and planner share; None
        #: prices identically to Precision.DEFAULT (bf16)
        self.precision = precision
        #: bytes-per-param pricing for drafter weight reads; None is bf16
        self.drafter_precision = drafter_precision
        self.planner = planner or BatchSpecPlanner(
            cfg, hw, affinity=affinity, window=window,
            config=PlannerConfig(policy=policy), precision=precision,
            drafter_precision=drafter_precision)
        #: union-packed verification path (models/moe.apply_moe(packed=
        #: True)): the same outputs, union-scaled weight traffic
        self.packed = bool(packed)
        #: engine clock: virtual seconds under clock="model" (cost-model
        #: priced steps + blocking prefills), wall seconds under "wall".
        #: Queue-delay and TTFT telemetry are measured on this clock.
        self.now = 0.0

        self.slots: List[Optional[_Slot]] = [None] * max_batch
        self.cache = T.init_cache(cfg, max_batch, max_len, window=window,
                                  per_row=True, device=self.device)
        self.telemetry = EngineTelemetry()
        self._step_idx = 0
        self._req_counter = 0
        self._joined_since_step = 0

    # -- admission ------------------------------------------------------ #

    @property
    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and not s.done]

    @property
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _lengths(self) -> np.ndarray:
        """The per-row cache lengths [B] as host int32 (a copy)."""
        return self.cache["lengths"].cpu().numpy().copy()

    def predicted_service_time(self, prompt_len: int) -> float:
        """Predicted seconds from joining NOW to this prompt's first output
        token, on the model clock: what `PredictiveTTFTAdmission` adds to a
        queued request's accrued delay. Blocking admission (chunk=0) is one
        full prefill pass, uncalibrated. Chunked admission prices one
        decode-shaped shared pass carrying a `chunk`-token prefill row
        alongside the CURRENT batch state (1 committed token per live
        decode row) via `BatchCostOracle` under the planner's calibration,
        then charges one such pass per chunk of this prompt, or more when
        the prefill backlog already queued ahead of it exceeds the
        admission budget. Reads engine state (the cache lengths, one copy
        off the device), mutates nothing."""
        n = max(int(prompt_len), 1)
        if self.chunk <= 0:
            return cm.prefill_time(self.cfg, self.hw, n,
                                   affinity=self.affinity,
                                   window=self.window,
                                   precision=self.precision)["t_iter"]
        lens = [int(x) for x in self._lengths()]
        chunk = min(self.chunk, n)
        oracle = cm.BatchCostOracle(
            self.cfg, self.hw, lens + [0], affinity=self.affinity,
            window=self.window,
            prefill_tokens=[0] * len(lens) + [chunk],
            calibration=self.planner.calibration,
            precision=self.precision)
        ns = [0] * (len(lens) + 1)
        backlog = 0
        for i in self.active_slots:
            s = self.slots[i]
            if s.phase == "prefill":
                backlog += max(len(s.prompt) - s.prefill_pos, 0)
            else:
                ns[i] = 1
        ns[-1] = chunk
        t_pass = oracle.t_batch(ns)
        budget = max(self.max_prefill_tokens_per_step, chunk)
        n_passes = max(-(-n // chunk), -(-(backlog + n) // budget))
        return n_passes * t_pass

    def join(self, prompt: List[int], max_new: int = 128, *,
             controller=None, request_id: str = "", task: str = "",
             stop_token: Optional[int] = None, enc_out=None,
             submit_time: Optional[float] = None,
             slo: Optional[RequestSLO] = None) -> int:
        """Admit `prompt` into a free cache row; returns the slot index.

        chunk=0: blocking, runs the full prefill here, stalling every
        in-flight decode for its duration. chunk>0: non-blocking, only
        enqueues the prompt; step() feeds it into the shared pass chunk by
        chunk under the admission budget. `submit_time` (engine-clock
        seconds, say recorded by a scheduler at enqueue) anchors the
        request's queue-delay and TTFT telemetry; default is "submitted
        now". `slo` (a `RequestSLO`) rides on the slot into the planner, and
        its TPOT bound is handed to the request's own Cascade config so the
        per-request trial gate enforces the same bound. `enc_out` must be
        None: encoder-decoder models are not ported."""
        _refuse_enc_out(enc_out)
        if not prompt:
            raise ValueError("empty prompt — nothing to prefill")
        if len(prompt) >= self.max_len:
            raise ValueError(f"prompt of {len(prompt)} tokens cannot fit a "
                             f"max_len={self.max_len} cache row")
        free = self.free_slots
        if not free:
            raise RuntimeError("no free slot — retire a request first")
        idx = free[0]
        controller = controller or self.controller_factory()
        if slo is not None and slo.tpot is not None:
            # an explicit CascadeConfig.slo_tpot wins over the request's,
            # and the caller's config object is never mutated (a factory
            # may hand the same config to every controller)
            ccfg = getattr(controller, "config", None)
            if (dataclasses.is_dataclass(ccfg)
                    and getattr(ccfg, "slo_tpot", 0) is None):
                bound_cfg = dataclasses.replace(ccfg, slo_tpot=slo.tpot)
                controller.config = bound_cfg
                mgr = getattr(controller, "manager", None)
                if mgr is not None and getattr(mgr, "cfg", None) is ccfg:
                    mgr.cfg = bound_cfg
        drafter = self.drafter_factory()
        drafter.reset()
        # the first request consumes exactly the single-request engine's
        # rng stream; later requests get their own
        n = self._req_counter
        rng = (np.random.default_rng(self.seed) if n == 0
               else np.random.default_rng([self.seed, n]))
        self._req_counter += 1

        t_submit = self.now if submit_time is None else float(submit_time)
        tel = RequestTelemetry(request_id=request_id, task=task,
                               prompt_len=len(prompt))
        if slo is not None:
            tel.tier = slo.tier
            tel.slo_tpot = slo.tpot
            tel.slo_ttft = slo.ttft

        if self.chunk > 0:
            # non-blocking admission: no forward pass here; the row's cache
            # is empty (lengths[idx] == 0) and fills chunk by chunk
            self.slots[idx] = _Slot(
                index=idx, request_id=request_id, task=task,
                max_new=max_new, stop_token=stop_token,
                controller=controller, drafter=drafter, rng=rng, tel=tel,
                history=list(prompt), out=[], last_tok=-1,
                phase="prefill", prompt=list(prompt),
                t_submit=t_submit, seq=n, slo=slo)
            self._joined_since_step += 1
            return idx

        row = T.init_cache(self.cfg, 1, self.max_len, window=self.window,
                           device=self.device)
        toks = torch.tensor([prompt], dtype=torch.int32, device=self.device)
        t0 = _device_clock(self.device)
        logits, row, _ = T.prefill(self.cfg, self.params, toks, row,
                                   window=self.window)
        logits = logits[0, -1].float().cpu().numpy()
        wall_prefill = _device_clock(self.device) - t0
        tel.t_prefill = _prefill_clock(self.cfg, self.hw, self.clock,
                                       len(prompt), wall_prefill,
                                       affinity=self.affinity,
                                       window=self.window,
                                       precision=self.precision)
        tel.t_queue = max(self.now - t_submit, 0.0)
        tel.ttft = tel.t_queue + tel.t_prefill
        self.now += tel.t_prefill  # blocking: everyone waits out the prefill
        self.cache = T.write_cache_row(self.cache, idx, row)

        first = _sample_logits(rng, logits, self.temperature)
        slot = _Slot(
            index=idx, request_id=request_id, task=task, max_new=max_new,
            stop_token=stop_token, controller=controller, drafter=drafter,
            rng=rng, tel=tel, history=list(prompt) + [first], out=[first],
            last_tok=first, t_submit=t_submit, seq=n, slo=slo)
        self._maybe_finish(slot,
                           stopped=stop_token is not None
                           and first == stop_token)
        self.slots[idx] = slot
        self._joined_since_step += 1
        return idx

    def _attr_share(self, cost: dict, i: int, wall_verify: float,
                    occupancy: int) -> float:
        """Request i's attributed share of the shared pass, on the engine's
        clock: marginal-bytes fraction of the wall time under clock="wall",
        the cost model's t_attr under the model clock. One rule for both
        the decode feedback and the chunked-prefill TTFT clock."""
        attr = cost["per_request"][i]
        if self.clock != "wall":
            return attr["t_attr"]
        frac = (attr["bytes_attr"] / cost["bytes"]
                if cost["bytes"] else 1.0 / occupancy)
        return wall_verify * frac

    def _maybe_finish(self, s: _Slot, *, stopped: bool = False) -> None:
        """The one termination rule, shared by every path that advances a
        request (blocking join, decode feedback, chunked-prefill finish):
        output budget reached, stop token emitted, or no worst-case
        speculative span left before the cache end."""
        if len(s.out) >= s.max_new:
            s.done = True
        if stopped:
            s.done = True
        if len(s.history) + _spec_room(s.controller, s.drafter) \
                > self.max_len:
            s.done = True

    def retire(self, idx: int) -> GenerationResult:
        """Free the slot and return the finished request's result."""
        s = self.slots[idx] if 0 <= idx < self.max_batch else None
        if s is None:
            raise KeyError(f"slot {idx} is empty (table size "
                           f"{self.max_batch})")
        self.cache = T.clear_cache_row(self.cache, idx)
        self.slots[idx] = None
        return GenerationResult(s.out[:s.max_new], s.tel)

    # -- the shared iteration ------------------------------------------- #

    def step(self) -> dict:
        """One continuous-batching iteration over every live request:
        per-request drafting under the joint plan, one padded shared pass
        over speculative decode spans AND co-scheduled prefill chunks,
        per-row verification and rollback, marginal cost attribution.
        Prefill tokens count toward the expert union, so admission pressure
        raises verification cost for every request sharing the pass.
        Returns {slot: emitted tokens}; empty when nothing is live."""
        active = self.active_slots
        if not active:
            return {}
        b = self.max_batch
        slots = self.slots
        lengths_before = self._lengths()
        decode_rows = [i for i in active if slots[i].phase == "decode"]
        prefill_rows = sorted(
            (i for i in active if slots[i].phase == "prefill"),
            key=lambda i: slots[i].seq)

        # EVERY non-done row of the padded pass gets T_max ring-slot writes
        # starting at its own length (padding writes are rolled back, but
        # they land first), so cap this step's span lengths: no row's
        # padded writes may wrap past its cache end, and a windowed ring's
        # write stays inside its SPEC_PAD spill slots. Under chunked
        # admission the cap is floored to a power of two.
        room_min = min(self.max_len - int(lengths_before[i])
                       for i in active)
        if self.window:
            room_min = min(room_min, T.SPEC_PAD)
        if self.chunk > 0 and room_min > 0:
            room_min = 1 << (room_min.bit_length() - 1)

        # 0. admission policy: pack pending prefill chunks FIFO under the
        # per-step token budget. The head-of-queue chunk always runs (no
        # starvation under a tiny budget); later chunks wait their turn.
        chunk_plan: dict = {}
        budget = self.max_prefill_tokens_per_step
        for i in prefill_rows:
            s = slots[i]
            n = min(self.chunk, len(s.prompt) - s.prefill_pos, room_min)
            if n <= 0:
                continue
            if chunk_plan and n > budget:
                break
            chunk_plan[i] = n
            budget -= n
            if not s.queue_seen:
                s.tel.t_queue = max(self.now - s.t_submit, 0.0)
                s.queue_seen = True
        if not decode_rows and not chunk_plan:
            return {}

        # 1. joint speculation planning + per-request drafting: each
        # controller asks, the planner grants {K_i} jointly (grants == asks
        # under policy="independent" and at B=1)
        plan = self.planner.plan(
            {i: slots[i].controller for i in decode_rows},
            [int(n) for n in lengths_before],
            prefill_tokens=chunk_plan,
            slos={i: slots[i].slo for i in decode_rows
                  if slots[i].slo is not None})
        k_req, drafts, draft_probs, wall_draft = {}, {}, {}, {}
        for i in decode_rows:
            s = slots[i]
            k_req[i] = plan.decisions[i].requested
            t0 = time.perf_counter()
            drafts[i], draft_probs[i] = s.drafter.propose(
                s.history, plan.decisions[i].granted, rng=s.rng)
            wall_draft[i] = time.perf_counter() - t0
            if len(drafts[i]) > room_min - 1:  # span = 1 + drafts
                drafts[i] = drafts[i][:max(room_min - 1, 0)]
                if draft_probs[i] is not None:
                    draft_probs[i] = draft_probs[i][:len(drafts[i])]

        # 2. pack ragged [1 + K_i] decode spans and prefill chunks into one
        # padded batch; bucket T to a power of two under chunked admission
        spans = {i: [slots[i].last_tok] + drafts[i] for i in decode_rows}
        for i, n in chunk_plan.items():
            s = slots[i]
            spans[i] = s.prompt[s.prefill_pos:s.prefill_pos + n]
        t_max = max(len(sp) for sp in spans.values())
        if self.chunk > 0:
            t_max = min(T.bucket_length(t_max), room_min)
        toks = np.zeros((b, t_max), np.int32)
        mask = np.zeros((b, t_max), bool)
        for i, span in spans.items():
            toks[i, :len(span)] = span
            mask[i, :len(span)] = True

        # 3. shared verification pass
        t1 = _device_clock(self.device)
        lo, new_cache, aux, staged = T.decode_step(
            self.cfg, self.params, self.cache,
            torch.from_numpy(toks).to(self.device), window=self.window,
            token_mask=torch.from_numpy(mask).to(self.device),
            moe_packed=self.packed)
        lo = lo.float().cpu().numpy()              # [B, T_max, V]
        wall_verify = _device_clock(self.device) - t1

        # 4. per-row verification (decode rows only: prefill chunks commit
        # all their real tokens)
        results, wall_sample = {}, {}
        for i in decode_rows:
            s = slots[i]
            n_i = 1 + len(drafts[i])
            t2 = time.perf_counter()
            if self.temperature <= 0:
                results[i] = greedy_verify(lo[i, :n_i], drafts[i])
            else:
                probs = logits_to_probs(torch.from_numpy(lo[i, :n_i]),
                                        self.temperature).numpy()
                results[i] = rejection_sample(s.rng, probs, drafts[i],
                                              draft_probs[i])
            wall_sample[i] = time.perf_counter() - t2

        # 5. vectorised per-row rollback (idle rows keep their length;
        # prefill rows keep their whole real chunk, dropping the padding)
        n_keep = np.zeros((b,), np.int32)
        for i in decode_rows:
            n_keep[i] = 1 + results[i].n_accepted
        for i, n in chunk_plan.items():
            n_keep[i] = n
        self.cache = T.rollback_cache(
            self.cfg, new_cache, staged, torch.from_numpy(n_keep),
            torch.from_numpy(lengths_before))

        # 6. batch-aware cost accounting + marginal attribution: the mean
        # over layers of the masked per-layer union, and of each row's own
        union = per_row = None
        if self.cfg.is_moe:
            union = float(np.mean(aux["unique_experts"].cpu().numpy()))
            per_row = np.mean(aux["unique_experts_row"].cpu().numpy()
                              .astype(np.float64), axis=0)      # [B]
        tokens_per_row = [int(mask[i].sum()) for i in range(b)]
        cost = cm.batch_iteration_time(
            self.cfg, self.hw, tokens_per_row, list(lengths_before),
            unique_experts=union,
            per_request_unique=(None if per_row is None else
                                [per_row[i] if i in spans else 0.0
                                 for i in range(b)]),
            affinity=self.affinity, window=self.window,
            prefill_tokens=[chunk_plan.get(i, 0) for i in range(b)],
            precision=self.precision)
        t_verify_shared = (wall_verify if self.clock == "wall"
                           else cost["t_iter"])

        # 7. feed back per request; advance token state
        emitted_by_slot = {}
        step_iter_tel = {}   # this step's records, for the t_pass backfill
        occupancy = len(spans)
        n_tokens = sum(tokens_per_row)
        padded = occupancy * t_max - n_tokens
        t_overhead = 0.0
        for i in decode_rows:
            s = slots[i]
            res = results[i]
            k_eff = len(drafts[i])
            emitted, stopped = _truncate_at_stop(
                res.accepted + [res.next_token], s.stop_token)
            s.out.extend(emitted)
            s.history.extend(emitted)
            s.last_tok = emitted[-1]

            t_verify = self._attr_share(cost, i, wall_verify, occupancy)
            t_draft = (wall_draft[i] if self.clock == "wall"
                       else cm.draft_time(self.hw, k_eff,
                                          s.drafter.active_params,
                                          precision=self.drafter_precision))
            t_sample = (wall_sample[i] if self.clock == "wall"
                        else cm.sample_time(k_eff))
            t_iter = t_draft + t_verify + t_sample
            t_overhead = max(t_overhead, t_draft + t_sample)

            s.controller.observe(len(emitted), t_iter, t_draft=t_draft,
                                 t_verify=t_verify, t_sample=t_sample,
                                 k=k_eff if k_req[i] > 0 else 0,
                                 batch=occupancy)
            step_iter_tel[i] = IterationTelemetry(
                iteration=s.iteration, k_requested=k_req[i],
                k_drafted=k_eff, tokens_emitted=len(emitted),
                t_iter=t_iter, t_draft=t_draft, t_verify=t_verify,
                t_sample=t_sample,
                unique_experts=(float(per_row[i]) if per_row is not None
                                else 0.0),
                context_len=int(lengths_before[i]),
                phase=getattr(s.controller, "phase", ""),
                utility=s.controller.utility(),
                batch_occupancy=occupancy,
                union_experts=union or 0.0,
                padding_frac=padded / (n_tokens + padded) if n_tokens else 0.0,
                k_granted=plan.decisions[i].granted,
                plan_held=plan.decisions[i].held,
                slo_capped=plan.decisions[i].slo_capped)
            s.tel.iterations.append(step_iter_tel[i])
            s.iteration += 1
            emitted_by_slot[i] = emitted
            self._maybe_finish(s, stopped=stopped)

        # 8. prefill bookkeeping: attribute this chunk's share of the pass
        # to the request's TTFT clock; on the final chunk, sample the first
        # output token and flip the slot to decode
        finished_prefill = []
        for i, n in chunk_plan.items():
            s = slots[i]
            s.tel.t_prefill += self._attr_share(cost, i, wall_verify,
                                                occupancy)
            s.tel.prefill_chunks += 1
            s.prefill_pos += n
            if s.prefill_pos >= len(s.prompt):
                first = _sample_logits(s.rng, lo[i, n - 1],
                                       self.temperature)
                s.history.append(first)
                s.out = [first]
                s.last_tok = first
                s.phase = "decode"
                finished_prefill.append(i)
                emitted_by_slot[i] = [first]
                self._maybe_finish(s,
                                   stopped=s.stop_token is not None
                                   and first == s.stop_token)

        step_tel = StepTelemetry(
            step=self._step_idx, occupancy=occupancy,
            tokens_in_flight=n_tokens, padded_tokens=padded,
            union_experts=union or 0.0,
            t_step=t_verify_shared, t_overhead=t_overhead,
            joined=self._joined_since_step,
            retired=sum(1 for i in spans if slots[i].done),
            prefill_tokens=sum(chunk_plan.values()),
            decode_tokens=sum(len(spans[i]) for i in decode_rows),
            k_requested=plan.requested_total,
            k_granted=plan.granted_total,
            preempted=plan.preempted,
            held_tests=plan.held,
            t_step_predicted=plan.t_predicted,
            t_base_predicted=plan.t_base,
            tokens_predicted=plan.tokens_predicted,
            planned=plan.priced,
            slo_denied=plan.slo_denied,
            packed_experts=(packed_expert_cap(self.cfg, b * t_max)
                            if self.packed else 0),
            precision=cost["precision"],
            expert_bytes_saved=cost["expert_bytes_saved"])
        self.telemetry.steps.append(step_tel)
        # every decode row experienced the WHOLE pass between its tokens,
        # the latency quantity SLOs bound (vs t_iter's attributed share)
        for it_tel in step_iter_tel.values():
            it_tel.t_pass = step_tel.t_total
        self.now += step_tel.t_total
        for i in finished_prefill:  # first token exists as of end-of-step
            s = slots[i]
            s.tel.ttft = max(self.now - s.t_submit, 0.0)
        self._joined_since_step = 0
        self._step_idx += 1
        return emitted_by_slot

    def generate(self, prompt: List[int], max_new: int = 128, *,
                 controller=None, request_id: str = "", task: str = "",
                 stop_token: Optional[int] = None,
                 enc_out=None) -> GenerationResult:
        """Drive a single request to completion (other live slots advance
        alongside it)."""
        idx = self.join(prompt, max_new, controller=controller,
                        request_id=request_id, task=task,
                        stop_token=stop_token, enc_out=enc_out)
        while not self.slots[idx].done:
            self.step()
        return self.retire(idx)
