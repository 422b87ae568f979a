"""Iteration-level speculation simulator for the paper-scale figures (a
copy of the JAX package's `sim/simulator.py`, numpy only).

Runs the *real* Cascade controller (the identical code the serving engine
uses) against full-size MoE configs, with:
  * acceptance drawn from the per-task AR(1) process (tasks.py),
  * unique-expert activation from the routing simulator (affinity-damped
    bucket-and-balls, §2.4),
  * iteration time from the deterministic data-movement cost model
    (core/cost_model.py), priced for `hw` (`H100_SXM` by default).

The end-to-end real-model path (the engines) runs the same controller with
genuine routing and genuine n-gram acceptance; the simulator extends it to
the paper's model sizes."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core import cost_model as cm
from repro_torch.core.controller import CascadeController, StaticKController

from .tasks import (EAGLE_BOOST, MODEL_AFFINITY, TASK_PROCESSES,
                    AcceptanceProcess, RoutingSimulator,
                    effective_affinity)


@dataclass
class SimIteration:
    k: int
    tokens: int
    t_iter: float
    unique_experts: float
    utility: float
    phase: str


@dataclass
class SimRequest:
    task: str
    iterations: List[SimIteration] = field(default_factory=list)

    @property
    def output_tokens(self):
        return sum(i.tokens for i in self.iterations)

    @property
    def decode_time(self):
        return sum(i.t_iter for i in self.iterations)


class SpeculationSimulator:
    def __init__(self, cfg, *, hw: cm.Hardware = cm.H100_SXM,
                 drafter: str = "ngram", context_len: int = 1024,
                 seed: int = 0):
        self.cfg = cfg
        self.hw = hw
        self.drafter = drafter
        self.context_len = context_len
        self.rng = np.random.default_rng(seed)
        self.affinity = MODEL_AFFINITY.get(cfg.name, 0.3)
        # EAGLE-style drafters fetch their own weights per drafted token
        self.drafter_params = (int(0.01 * cfg.active_param_count())
                               if drafter == "eagle" else 0)

    # ------------------------------------------------------------------ #

    def _baseline_iter_time(self, ctx: int) -> float:
        r = cm.iteration_time(self.cfg, self.hw, 1, ctx,
                              unique_experts=float(
                                  self.cfg.experts_per_token) or None,
                              window=self.cfg.window)
        return r["t_iter"]

    def run_request(self, task: str, n_iters: int = 256,
                    controller=None) -> SimRequest:
        cfg = self.cfg
        controller = controller or CascadeController()
        boost = EAGLE_BOOST.get(task, 0.15) if self.drafter == "eagle" else 0.0
        acc = AcceptanceProcess(TASK_PROCESSES[task], self.rng, boost=boost)
        aff = effective_affinity(cfg.name, task)
        routing = (RoutingSimulator(cfg.num_experts, cfg.experts_per_token,
                                    aff, self.rng)
                   if cfg.is_moe else None)
        req = SimRequest(task=task)
        ctx = self.context_len

        for _ in range(n_iters):
            k = controller.next_k()
            a = acc.step()
            # n-gram drafters sometimes find no match at all; GSM8K-style
            # text usually *matches* (numbers, templates) but continues
            # wrongly — hence the high find rate with low acceptance that
            # produces the paper's -54% math worst case.
            if self.drafter == "ngram" and self.rng.random() > min(
                    1.0, 0.5 + a * 1.2):
                k_eff = 0
            else:
                k_eff = k
            # sequential accept/reject over the k_eff drafts
            n_acc = 0
            for _ in range(k_eff):
                if self.rng.random() < a:
                    n_acc += 1
                else:
                    break
            tokens = n_acc + 1
            n_inflight = k_eff + 1

            uniq = (routing.unique_for(n_inflight) if routing else None)
            r = cm.iteration_time(cfg, self.hw, n_inflight, ctx,
                                  unique_experts=uniq, window=cfg.window)
            t_draft = cm.draft_time(self.hw, k_eff, self.drafter_params)
            t_sample = cm.sample_time(k_eff) if k_eff else 0.0
            t_iter = r["t_iter"] + t_draft + t_sample

            controller.observe(tokens, t_iter, t_draft=t_draft,
                               t_verify=r["t_iter"], t_sample=t_sample,
                               k=k_eff if k > 0 else 0)
            req.iterations.append(SimIteration(
                k=k_eff, tokens=tokens, t_iter=t_iter,
                unique_experts=float(uniq or 0),
                utility=controller.utility(),
                phase=getattr(controller, "phase", "")))
            ctx += tokens
        return req

    # ------------------------------------------------------------------ #

    def run_workload(self, tasks: List[str], *, n_requests: int = 8,
                     iters_per_request: int = 256,
                     controller_factory: Optional[Callable] = None
                     ) -> List[SimRequest]:
        """Round-robin mixed request stream (paper §3)."""
        controller_factory = controller_factory or (lambda: CascadeController())
        out = []
        for i in range(n_requests):
            task = tasks[i % len(tasks)]
            out.append(self.run_request(task, iters_per_request,
                                        controller_factory()))
        return out


def tpot_speedup(requests: List[SimRequest], baseline: List[SimRequest]):
    """Aggregate TPOT improvement vs a no-speculation run (y=1 line)."""
    t = sum(r.decode_time for r in requests)
    n = sum(r.output_tokens for r in requests)
    tb = sum(r.decode_time for r in baseline)
    nb = sum(r.output_tokens for r in baseline)
    return (tb / nb) / (t / n)


def run_point(cfg, task_mix: List[str], k: Optional[int], *,
              drafter="ngram", n_requests=8, iters=256, seed=0,
              cascade_cfg=None) -> Dict:
    """One (model, workload, policy) datapoint. k=None -> Cascade."""
    from repro_torch.core.manager import CascadeConfig
    sim = SpeculationSimulator(cfg, drafter=drafter, seed=seed)
    if k is None:
        cc = cascade_cfg or CascadeConfig()
        factory = lambda: CascadeController(cc)   # noqa: E731
    else:
        factory = lambda: StaticKController(k)    # noqa: E731
    reqs = sim.run_workload(task_mix, n_requests=n_requests,
                            iters_per_request=iters,
                            controller_factory=factory)
    sim_b = SpeculationSimulator(cfg, drafter=drafter, seed=seed)
    base = sim_b.run_workload(task_mix, n_requests=n_requests,
                              iters_per_request=iters,
                              controller_factory=lambda: StaticKController(0))
    toks = sum(r.output_tokens for r in reqs)
    t = sum(r.decode_time for r in reqs)
    etr = toks / sum(len(r.iterations) for r in reqs)
    return {
        "speedup": tpot_speedup(reqs, base),
        "tpot": t / toks,
        "etr": etr,
        "requests": reqs,
        "baseline": base,
    }
