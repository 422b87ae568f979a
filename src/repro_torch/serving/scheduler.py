"""Request schedulers of the port (a copy of the JAX package's
`serving/scheduler.py`; numpy and the port's own modules only).

`Scheduler`: a FIFO queue serving requests one at a time (the paper's
single-batch, latency-critical setting). It only needs an object with
`.generate(...)`, so handing it a `BatchedEngine` makes it a thin wrapper
over continuous batching at occupancy 1.

`ContinuousBatchingScheduler`: an admission queue in front of a
`BatchedEngine` slot table. Every engine step, finished requests retire and
queued requests join the freed rows, so the verification batch stays as
full as the workload allows. Mixed workloads (code+math etc.) are
interleaved streams of task-tagged requests, matching the paper's §3
'mixed' workloads, sharing one verification pass whose cost is driven by
the *union* of the experts their drafts activate. `run_trace` replays an
open-loop trace on the engine clock: under `clock="wall"` that clock is
the sum of the measured passes, so an arrival rate is in requests per
second of engine time.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, Iterable, List, Optional, Tuple

from repro_torch.core.planner import DEFER, SHED, AdmissionConstraint
from repro_torch.core.slo import LATENCY, RequestSLO

from .engine import BatchedEngine, GenerationResult, ServingEngine
from .telemetry import RequestTelemetry, percentile, planner_aggregates


@dataclass
class Request:
    request_id: str
    prompt: list
    max_new: int = 128
    task: str = ""
    enc_out: object = None
    stop_token: Optional[int] = None
    #: latency objective: a TPOT/TTFT bound plus tier.
    #: Latency-tier requests are admitted ahead of FIFO when a slot frees,
    #: and their TPOT bound constrains the planner's joint allocation.
    slo: Optional[RequestSLO] = None


@dataclass
class Scheduler:
    engine: ServingEngine
    controller_factory: Optional[Callable] = None
    share_controller_across_requests: bool = False

    _shared_controller: object = None
    results: List[GenerationResult] = field(default_factory=list)

    def run(self, requests: Iterable[Request]) -> List[GenerationResult]:
        for req in requests:
            ctl = None
            if self.controller_factory is not None:
                if self.share_controller_across_requests:
                    if self._shared_controller is None:
                        self._shared_controller = self.controller_factory()
                    ctl = self._shared_controller
                else:
                    ctl = self.controller_factory()
            res = self.engine.generate(req.prompt, req.max_new,
                                       controller=ctl,
                                       request_id=req.request_id,
                                       task=req.task, enc_out=req.enc_out,
                                       stop_token=req.stop_token)
            self.results.append(res)
        return self.results

    # -- aggregate figures of merit (paper §3) -------------------------- #

    def tokens_per_second(self) -> float:
        toks = sum(r.telemetry.output_tokens for r in self.results)
        t = sum(r.telemetry.decode_time for r in self.results)
        return toks / t if t else 0.0

    def mean_tpot(self) -> float:
        tps = self.tokens_per_second()
        return 1.0 / tps if tps else float("inf")


@dataclass
class ContinuousBatchingScheduler:
    """Admission queue + slot table over a `BatchedEngine`.

    `run(requests)` admits requests FIFO into free engine slots, steps the
    engine until everything drains, and retires finished requests as their
    rows free up — the continuous part: a long request never blocks the
    batch, short requests flow through around it."""

    engine: BatchedEngine
    controller_factory: Optional[Callable] = None
    #: join-side admission pipeline: vets each
    #: queued request about to join — ADMIT / DEFER (backpressure) /
    #: SHED (load shedding). None admits everything, bit-identically.
    admission: Optional[AdmissionConstraint] = None
    #: starvation guard (bounded queue-jumps): a waiting non-latency
    #: request may be jumped by latency-tier admissions at most this many
    #: times before it is served next regardless of tier. None disables
    #: the guard (the pre-guard unconditional-jump scheduler, under which
    #: sustained latency traffic starves the throughput tier forever).
    #: Plain FIFO stays byte-identical either way when no latency-tier
    #: request waits.
    max_queue_jumps: Optional[int] = 8

    queue: Deque[Request] = field(default_factory=deque)
    results: List[GenerationResult] = field(default_factory=list)
    #: requests the admission pipeline dropped (empty token streams,
    #: telemetry carrying tier/bounds/queue-wait) — kept OUT of `results`
    #: so served-request figures stay served-request figures, counted by
    #: `tier_stats`/`slo_violations`/the load harness as violations
    shed_results: List[GenerationResult] = field(default_factory=list)
    #: (engine-clock t, queue_depth, occupancy) samples, one per
    #: `run_trace` step — the queue-dynamics time series
    timeline: List[Tuple[float, int, int]] = field(default_factory=list)
    deferred: int = 0          # DEFER verdicts issued (backpressure events)
    _order: List[str] = field(default_factory=list)
    _by_id: Dict[str, GenerationResult] = field(default_factory=dict)
    _slot_req: Dict[int, str] = field(default_factory=dict)
    _submit_time: Dict[str, float] = field(default_factory=dict)
    _jumps: Dict[str, int] = field(default_factory=dict)
    _deferrals: Dict[str, int] = field(default_factory=dict)
    _steps_start: int = 0

    def __post_init__(self):
        # engine may be reused across schedulers: only count steps (and
        # their time) taken after this scheduler attached
        self._steps_start = len(self.engine.telemetry.steps)

    # -- admission / draining ------------------------------------------- #

    def submit(self, req: Request, at: Optional[float] = None) -> None:
        """Enqueue a request. `at` (engine-clock seconds) stamps its
        arrival time for queue-delay/TTFT telemetry — `run_trace` passes
        the trace's arrival stamps so a request that waited out a long
        step before release is charged from when it *arrived*, not from
        when the loop got around to the submit call. Default: arrived
        now (the closed-loop behavior, byte-identical to before)."""
        self.queue.append(req)
        self._order.append(req.request_id)
        self._submit_time[req.request_id] = (
            getattr(self.engine, "now", 0.0) if at is None else float(at))

    def _pop_next(self) -> Request:
        """Tier-aware admission with a starvation guard: the first
        latency-tier request jumps the queue (FIFO within each tier) —
        but only until the waiting queue head has been jumped
        `max_queue_jumps` times, after which the head is served
        regardless of tier, so a sustained latency stream can no longer
        starve throughput-tier requests indefinitely (each one's
        admission is delayed by at most its queue position plus the jump
        bound). With no latency-tier request waiting this is plain FIFO
        — byte-identical to the pre-SLO scheduler."""
        for n, r in enumerate(self.queue):
            if r.slo is not None and r.slo.tier == LATENCY:
                if n > 0 and self.max_queue_jumps is not None:
                    head = self.queue[0]
                    if (self._jumps.get(head.request_id, 0)
                            >= self.max_queue_jumps):
                        return self.queue.popleft()
                    for jumped in list(self.queue)[:n]:
                        rid = jumped.request_id
                        self._jumps[rid] = self._jumps.get(rid, 0) + 1
                del self.queue[n]
                return r
        return self.queue.popleft()

    def _shed(self, req: Request, queue_delay: float) -> None:
        """Record an admission drop as first-class telemetry: an empty
        token stream whose RequestTelemetry carries the tier, the bounds
        (a TTFT bound on a never-served request counts as violated), and
        the queue delay it accrued before the verdict."""
        tel = RequestTelemetry(request_id=req.request_id, task=req.task,
                               prompt_len=len(req.prompt), shed=True)
        tel.t_queue = queue_delay
        if req.slo is not None:
            tel.tier = req.slo.tier
            tel.slo_tpot = req.slo.tpot
            tel.slo_ttft = req.slo.ttft
        self.shed_results.append(GenerationResult(tokens=[], telemetry=tel))

    def _admit(self) -> None:
        while self.queue and self.engine.free_slots:
            req = self._pop_next()
            rid = req.request_id
            self._jumps.pop(rid, None)
            if self.admission is not None:
                delay = max(getattr(self.engine, "now", 0.0)
                            - self._submit_time.get(rid, 0.0), 0.0)
                svc = self.engine.predicted_service_time(len(req.prompt))
                dec = self.admission.decide(
                    req.slo, queue_delay=delay, service_time=svc,
                    deferrals=self._deferrals.get(rid, 0))
                # a DEFER against an idle engine would never resolve (the
                # clock only advances with the batch) — serve it instead
                if dec.action == DEFER and self.engine.active_slots:
                    self._deferrals[rid] = self._deferrals.get(rid, 0) + 1
                    self.deferred += 1
                    self.queue.appendleft(req)   # backpressure: hold the
                    break                        # queue until re-decided
                if dec.action == SHED:
                    self._deferrals.pop(rid, None)
                    self._shed(req, delay)
                    continue
            self._deferrals.pop(rid, None)
            ctl = (self.controller_factory() if self.controller_factory
                   else None)
            idx = self.engine.join(req.prompt, req.max_new, controller=ctl,
                                   request_id=req.request_id, task=req.task,
                                   stop_token=req.stop_token,
                                   enc_out=req.enc_out,
                                   submit_time=self._submit_time.get(
                                       req.request_id),
                                   slo=req.slo)
            self._slot_req[idx] = req.request_id

    def _retire_finished(self) -> None:
        for idx, slot in enumerate(self.engine.slots):
            if slot is not None and slot.done:
                res = self.engine.retire(idx)
                self._by_id[self._slot_req.pop(idx)] = res

    def step(self) -> bool:
        """Admit, run one engine step, retire. False when fully drained."""
        self._admit()
        if not self.engine.active_slots and not self.queue:
            return False
        if not self.engine.active_slots:
            # the whole queue was shed this round — drained, no pass to run
            return bool(self.queue)
        self.engine.step()
        self._retire_finished()
        return bool(self.queue or self.engine.active_slots)

    def run(self, requests: Iterable[Request]) -> List[GenerationResult]:
        """Serve `requests` to completion; results in submission order."""
        for req in requests:
            self.submit(req)
        while self.step():
            pass
        self.results = [self._by_id[rid] for rid in self._order
                        if rid in self._by_id]
        return self.results

    def run_trace(self, trace: Iterable,
                  max_steps: Optional[int] = None
                  ) -> List[GenerationResult]:
        """Open-loop replay: serve `(arrival_time,
        Request)` pairs, holding each request out of the queue until the
        engine clock reaches its arrival — unlike `run`, the scheduler
        cannot pull work forward, so queue depth and TTFT reflect the
        offered load, not the drain rate. An idle engine fast-forwards
        the clock to the next arrival (virtual seconds are free). Samples
        (t, queue_depth, occupancy) into `self.timeline` after every
        step. `max_steps` cuts the replay at a horizon, leaving requests
        in flight — the censored regime `throughput_stats` reports
        honestly. Returns finished results in arrival order."""
        pending = deque(sorted(((float(at), req) for at, req in trace),
                               key=lambda p: p[0]))
        steps = 0
        while pending or self.queue or self.engine.active_slots:
            now = getattr(self.engine, "now", 0.0)
            while pending and pending[0][0] <= now:
                at, req = pending.popleft()
                self.submit(req, at=at)
            if not self.queue and not self.engine.active_slots:
                # idle: nothing live — jump to the next arrival
                self.engine.now = max(now, pending[0][0])
                continue
            if not self.step() and not pending:
                break
            steps += 1
            self.timeline.append((self.engine.now, len(self.queue),
                                  len(self.engine.active_slots)))
            if max_steps is not None and steps >= max_steps:
                break
        self.results = [self._by_id[rid] for rid in self._order
                        if rid in self._by_id]
        return self.results

    # -- aggregate figures of merit ------------------------------------- #

    def _inflight_telemetry(self) -> List[RequestTelemetry]:
        """Telemetry of this scheduler's requests still occupying slots —
        non-empty only when measuring before the run drained (a replay
        horizon), the censored regime `tokens_per_second` must account."""
        return [self.engine.slots[i].tel
                for i, _ in self._slot_req.items()
                if self.engine.slots[i] is not None]

    def tokens_per_second(self) -> float:
        """Decode throughput: emitted tokens over *shared* step wall time
        (not the sum of per-request attributed times — that would count the
        shared verification pass B times). Blocking (chunk=0) prefill runs
        inside join() and never enters the steps, so the chunked prefill
        work co-scheduled *into* steps is subtracted via its attributed
        share — both admission modes then measure the same decode-only
        quantity. Measured at a replay horizon with requests still in
        flight, their emissions (and their prefill share) count too —
        counting all steps' time but only finished requests' tokens would
        censor the figure downward exactly when the batch is fullest. On
        a drained run the in-flight terms are empty and the figure is
        byte-identical to the finished-only accounting."""
        rs = self.results
        toks = sum(r.telemetry.output_tokens for r in rs)
        t = sum(s.t_total
                for s in self.engine.telemetry.steps[self._steps_start:])
        t -= sum(r.telemetry.t_prefill for r in rs
                 if r.telemetry.prefill_chunks)
        inflight = self._inflight_telemetry()
        if inflight:
            toks += sum(tel.output_tokens for tel in inflight)
            t -= sum(tel.t_prefill for tel in inflight
                     if tel.prefill_chunks)
        return toks / t if t > 0 else 0.0

    def throughput_stats(self) -> dict:
        """Drained vs censored decode throughput, explicitly: the drained
        figure counts finished requests only (the pre-horizon quantity —
        correct once the run drained, censored before), the corrected
        figure adds in-flight emissions and their prefill share
        (`tokens_per_second`'s accounting). `censored` says whether the
        two can differ right now."""
        rs = self.results
        fin_toks = sum(r.telemetry.output_tokens for r in rs)
        t = sum(s.t_total
                for s in self.engine.telemetry.steps[self._steps_start:])
        t_fin = t - sum(r.telemetry.t_prefill for r in rs
                        if r.telemetry.prefill_chunks)
        inflight = self._inflight_telemetry()
        in_toks = sum(tel.output_tokens for tel in inflight)
        t_all = t_fin - sum(tel.t_prefill for tel in inflight
                            if tel.prefill_chunks)
        return {
            "finished_tokens": fin_toks,
            "inflight_tokens": in_toks,
            "censored": bool(inflight or self.queue),
            "drained_tokens_per_s": fin_toks / t_fin if t_fin > 0 else 0.0,
            "tokens_per_s": ((fin_toks + in_toks) / t_all
                             if t_all > 0 else 0.0),
        }

    def mean_tpot(self) -> float:
        tps = self.tokens_per_second()
        return 1.0 / tps if tps else float("inf")

    def mean_request_utility(self) -> float:
        rs = self.results
        if not rs:
            return 0.0
        finals = [r.telemetry.iterations[-1].utility
                  for r in rs if r.telemetry.iterations]
        return sum(finals) / len(finals) if finals else 0.0

    def mean_ttft(self) -> float:
        """Mean submit -> first-token latency on the engine clock — the
        admission-side figure of merit chunked prefill exists to improve."""
        rs = self.results
        return sum(r.telemetry.ttft for r in rs) / len(rs) if rs else 0.0

    def mean_queue_delay(self) -> float:
        rs = self.results
        return sum(r.telemetry.t_queue for r in rs) / len(rs) if rs else 0.0

    def planner_stats(self) -> dict:
        """Batch-planner figures over this scheduler's steps (sliced from
        `_steps_start` so a reused engine's earlier runs don't leak in):
        grant ratio (granted/requested drafts — 1.0 under
        policy="independent" by construction), outright preemptions, TEST
        trials postponed by phase staggering, the planner's
        predicted-vs-measured step-time calibration error, row-steps whose
        grants an SLO constraint capped (`slo_denied`), and the
        expert-parallel figures (mean shard imbalance, `hot_shard_frac`),
        which the port's flat engine reports at 1.0 and 0.0."""
        return planner_aggregates(
            self.engine.telemetry.steps[self._steps_start:])

    # -- SLO figures of merit ------------------------------------------- #

    def tier_stats(self) -> Dict[str, dict]:
        """Per-tier latency/throughput figures: request count and emitted
        tokens over finished requests, mean/p95 *experienced* TPOT (the
        pass time a request waits out between token batches — the quantity
        `RequestSLO.tpot` bounds, nearest-rank p95 via the shared
        `telemetry.percentile`), mean TTFT, and how many requests violated
        their own TPOT/TTFT bound. Shed requests count toward their tier's
        `shed` and — when TTFT-bounded — `ttft_violations` (a bounded
        request that never got a first token is a violation, not a
        no-op); they contribute no latency samples (there is nothing to
        sample)."""
        tiers: Dict[str, list] = {}
        for r in self.results:
            tiers.setdefault(r.telemetry.tier, []).append(r.telemetry)
        shed_tiers: Dict[str, list] = {}
        for r in self.shed_results:
            shed_tiers.setdefault(r.telemetry.tier, []).append(r.telemetry)
        out = {}
        for tier in {**tiers, **shed_tiers}:
            tels = tiers.get(tier, [])
            shed = shed_tiers.get(tier, [])
            tpots = sorted(t.experienced_tpot for t in tels
                           if t.output_tokens)
            out[tier] = {
                "n": len(tels),
                "shed": len(shed),
                "tokens": sum(t.output_tokens for t in tels),
                "mean_tpot": sum(tpots) / len(tpots) if tpots else 0.0,
                "p95_tpot": percentile(tpots, 0.95),
                "max_tpot": tpots[-1] if tpots else 0.0,
                "mean_ttft": (sum(t.ttft for t in tels) / len(tels)
                              if tels else 0.0),
                "tpot_violations": sum(t.slo_tpot_violated for t in tels),
                "ttft_violations": sum(t.slo_ttft_violated
                                       for t in tels + shed),
            }
        return out

    def slo_violations(self) -> int:
        """Requests whose experienced TPOT or TTFT exceeded their own
        bound (0 without bounded requests). Shed requests count their
        TTFT bound as violated — never serving a bounded request is the
        one way to miss its deadline with certainty."""
        return (sum(r.telemetry.slo_tpot_violated
                    + r.telemetry.slo_ttft_violated for r in self.results)
                + sum(r.telemetry.slo_ttft_violated
                      for r in self.shed_results))
