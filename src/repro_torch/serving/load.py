"""Open-loop production-shaped load for the batched engine (a copy of the
JAX package's `serving/load.py`; numpy and the port's own modules only).

The closed-loop sweeps submit every request at clock 0 and let the
scheduler pull work as fast as it drains — which can never show an
overload, a queue explosion, or a starved tier, because offered load
always equals service rate by construction. This module replays traffic
the way production sees it: arrivals land on the engine's *model clock*
whether the batch is ready or not (Poisson or diurnally-modulated
processes), prompt and output lengths are long-tailed (lognormal/Pareto,
`data.workloads.sample_length`), task types come from the paper's mixed
workloads, and a configurable fraction carries latency-tier SLOs. The
scheduler side (`ContinuousBatchingScheduler.run_trace`) holds each
request out of the queue until the clock reaches its arrival stamp, so
queue depth and TTFT measure the offered load, not the drain rate. Under
`clock="wall"` the engine clock is the sum of the measured passes, so a
rate is in requests per second of that clock.

`summarize` turns one replay into the report every scale claim gets
measured on: p50/p95/p99 TTFT and experienced TPOT (nearest-rank,
`telemetry.percentile`), goodput under SLO, queue-depth/occupancy time
series, and overload behavior — shed and deferred counts as first-class
telemetry, not silent zeros."""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.slo import LATENCY, RequestSLO
from repro_torch.data.workloads import MIXES, make_sample, sample_length

from .scheduler import ContinuousBatchingScheduler, Request
from .telemetry import percentile


# -- arrival processes --------------------------------------------------- #

def poisson_arrivals(rng: np.random.Generator, rate: float,
                     n: int) -> List[float]:
    """n arrival times of a homogeneous Poisson process at `rate` per
    model-clock second: i.i.d. exponential inter-arrival gaps — the
    memoryless baseline every queueing result assumes, and the default
    shape of aggregate production traffic between diurnal swings."""
    if rate <= 0:
        raise ValueError(f"arrival rate must be positive, got {rate!r}")
    gaps = rng.exponential(1.0 / rate, int(n))
    return [float(t) for t in np.cumsum(gaps)]


def diurnal_arrivals(rng: np.random.Generator, rate: float, n: int, *,
                     amplitude: float = 0.8,
                     period: float = 60.0) -> List[float]:
    """n arrival times of an inhomogeneous Poisson process whose rate
    swings sinusoidally around `rate` — lambda(t) = rate * (1 + amplitude
    * sin(2*pi*t / period)) — by Lewis-Shedler thinning of a homogeneous
    candidate process at the peak rate. The compressed analogue of a
    day/night traffic cycle: the same mean load as `poisson_arrivals`,
    but with sustained bursts that exercise overload behavior a flat
    process only hits by luck."""
    if not 0.0 <= amplitude <= 1.0:
        raise ValueError(f"amplitude must be in [0, 1], got {amplitude!r}")
    if rate <= 0 or period <= 0:
        raise ValueError("rate and period must be positive")
    peak = rate * (1.0 + amplitude)
    out: List[float] = []
    t = 0.0
    while len(out) < n:
        t += float(rng.exponential(1.0 / peak))
        lam = rate * (1.0 + amplitude * math.sin(2.0 * math.pi * t / period))
        if float(rng.random()) * peak <= lam:
            out.append(t)
    return out


# -- trace construction -------------------------------------------------- #

@dataclass(frozen=True)
class LoadSpec:
    """One production-shaped trace, fully determined by its seed.

    `rate` is offered load in requests per model-clock second — calibrate
    it against a measured service rate to place a run below or above
    saturation. `latency_frac` of requests
    ride the latency tier with the given TTFT/TPOT bounds; the rest are
    unbounded throughput tier. Lengths are long-tailed draws clamped to
    [lo, hi] (`data.workloads.sample_length`)."""
    n_requests: int = 200
    arrival: str = "poisson"       # "poisson" | "diurnal"
    rate: float = 10.0             # offered requests / model-clock second
    amplitude: float = 0.8         # diurnal swing (ignored for poisson)
    period: float = 60.0           # diurnal period, model-clock seconds
    mix: str = "all-3"             # task mix (data.workloads.MIXES)
    # prompt length distribution
    prompt_dist: str = "lognormal"
    prompt_median: float = 24.0
    prompt_sigma: float = 0.7
    prompt_alpha: float = 1.5
    prompt_lo: int = 4
    prompt_hi: int = 96
    # output (max_new) length distribution
    out_dist: str = "lognormal"
    out_median: float = 10.0
    out_sigma: float = 0.7
    out_alpha: float = 1.5
    out_lo: int = 2
    out_hi: int = 32
    # SLO mix
    latency_frac: float = 0.5      # fraction carrying latency-tier SLOs
    latency_ttft: Optional[float] = None
    latency_tpot: Optional[float] = None
    vocab: int = 256
    seed: int = 0

    def scaled(self, rate: float) -> "LoadSpec":
        """The same trace shape at a different offered load."""
        return replace(self, rate=rate)


def build_trace(spec: LoadSpec) -> List[Tuple[float, Request]]:
    """Materialize a spec into `(arrival_time, Request)` pairs for
    `ContinuousBatchingScheduler.run_trace`. Deterministic in the spec:
    one rng drives arrivals, lengths, task content, and tier assignment,
    so two runs of the same spec replay byte-identical traffic."""
    rng = np.random.default_rng(spec.seed)
    if spec.arrival == "poisson":
        ats = poisson_arrivals(rng, spec.rate, spec.n_requests)
    elif spec.arrival == "diurnal":
        ats = diurnal_arrivals(rng, spec.rate, spec.n_requests,
                               amplitude=spec.amplitude,
                               period=spec.period)
    else:
        raise ValueError(f"unknown arrival process {spec.arrival!r} "
                         "(expected 'poisson' or 'diurnal')")
    tasks = MIXES[spec.mix]
    trace: List[Tuple[float, Request]] = []
    for i, at in enumerate(ats):
        task = tasks[i % len(tasks)]
        p_len = sample_length(rng, spec.prompt_dist,
                              median=spec.prompt_median,
                              sigma=spec.prompt_sigma,
                              alpha=spec.prompt_alpha,
                              lo=spec.prompt_lo, hi=spec.prompt_hi)
        o_len = sample_length(rng, spec.out_dist, median=spec.out_median,
                              sigma=spec.out_sigma, alpha=spec.out_alpha,
                              lo=spec.out_lo, hi=spec.out_hi)
        sample = make_sample(task, rng, vocab=spec.vocab,
                             prompt_len=p_len, cont_len=o_len)
        slo = None
        if float(rng.random()) < spec.latency_frac:
            slo = RequestSLO(tpot=spec.latency_tpot,
                             ttft=spec.latency_ttft, tier=LATENCY)
        trace.append((at, Request(request_id=f"load-{i}",
                                  prompt=sample.prompt, max_new=o_len,
                                  task=task, slo=slo)))
    return trace


# -- reporting ----------------------------------------------------------- #

def _downsample(timeline: Sequence[Tuple[float, int, int]],
                cap: int = 128) -> List[List[float]]:
    if len(timeline) <= cap:
        return [list(x) for x in timeline]
    stride = math.ceil(len(timeline) / cap)
    return [list(x) for x in timeline[::stride]]


def summarize(sched: ContinuousBatchingScheduler,
              trace: Optional[Sequence[Tuple[float, Request]]] = None
              ) -> dict:
    """The replay report: latency tails over
    *served* requests, goodput under SLO over the replay makespan, queue
    dynamics from the step timeline, and the overload ledger — shed and
    deferred counts plus drained-vs-censored throughput. Shed requests
    contribute violations (and their queue delay), never latency samples;
    a report whose `n_shed` is high and whose `p99_ttft` is low is
    describing an engine that kept its promises by refusing some — both
    numbers are the point."""
    served = sched.results
    shed = sched.shed_results
    ttfts = [r.telemetry.ttft for r in served]
    tpots = [r.telemetry.experienced_tpot for r in served
             if r.telemetry.output_tokens]
    qdel = [r.telemetry.t_queue for r in served + shed]
    tl = sched.timeline
    if trace:
        start = min(at for at, _ in trace)
    else:
        start = tl[0][0] if tl else 0.0
    end = tl[-1][0] if tl else start
    makespan = max(end - start, 0.0)
    tokens = sum(r.telemetry.output_tokens for r in served)
    good = sum(r.telemetry.output_tokens for r in served
               if not r.telemetry.slo_tpot_violated
               and not r.telemetry.slo_ttft_violated)
    depths = [d for _, d, _ in tl]
    occ = [o for _, _, o in tl]
    return {
        "n_offered": len(served) + len(shed) + len(sched.queue),
        "n_served": len(served),
        "n_shed": len(shed),
        "n_deferred": sched.deferred,
        "makespan": makespan,
        # latency tails (served requests; nearest-rank)
        "mean_ttft": sum(ttfts) / len(ttfts) if ttfts else 0.0,
        "p50_ttft": percentile(ttfts, 0.50),
        "p95_ttft": percentile(ttfts, 0.95),
        "p99_ttft": percentile(ttfts, 0.99),
        "p50_tpot": percentile(tpots, 0.50),
        "p95_tpot": percentile(tpots, 0.95),
        "p99_tpot": percentile(tpots, 0.99),
        "p95_queue_delay": percentile(qdel, 0.95),
        "max_queue_delay": max(qdel, default=0.0),
        # goodput under SLO: tokens of requests that met every bound they
        # carried, over the replay makespan (unbounded requests always
        # count — an absent promise cannot be broken)
        "tokens": tokens,
        "goodput_tokens_per_s": good / makespan if makespan > 0 else 0.0,
        "goodput_frac": good / tokens if tokens else 0.0,
        "slo_violations": sched.slo_violations(),
        "tier_stats": sched.tier_stats(),
        # queue dynamics + overload ledger
        "queue_depth_max": max(depths, default=0),
        "queue_depth_mean": sum(depths) / len(depths) if depths else 0.0,
        "occupancy_mean": sum(occ) / len(occ) if occ else 0.0,
        "backpressure_steps": sum(1 for d in depths if d > 0),
        "throughput": sched.throughput_stats(),
        "timeline": _downsample(tl),
    }


def run_load(sched: ContinuousBatchingScheduler, spec: LoadSpec, *,
             max_steps: Optional[int] = None) -> dict:
    """Build the spec's trace, replay it open-loop, and summarize."""
    trace = build_trace(spec)
    sched.run_trace(trace, max_steps=max_steps)
    return summarize(sched, trace)
