"""Per-task draft-acceptance processes and per-model routing affinity (a
copy of the JAX package's `sim/tasks.py`, numpy only).

The paper's workloads differ in *draftability* (how often n-gram drafts are
accepted) and models differ in *expert affinity* (how much consecutive
tokens reuse experts — §2.4/§7: OLMoE high, Mixtral low). The simulator
models acceptance as a per-request AR(1) latent acceptance rate (Fig. 6/7:
phases with temporal locality) and ETR then *emerges* from sequential
accept/reject draws — it is never assumed.

Acceptance means are anchored to the paper's reported ETRs (Fig. 4: at K=7,
n-gram ETR 1.6x-3.2x across tasks; code highest, math lowest; extraction has
high-copy phases). Affinities anchored to §7's Mixtral-low / OLMoE-high
observations."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class TaskProcess:
    name: str
    accept_mean: float      # long-run mean acceptance prob per draft token
    accept_std: float       # dispersion of the AR(1) latent
    ar_rho: float           # temporal locality (Fig. 6: strong short-term)
    phase_flip_p: float     # prob/iter of a phase shift (Fig. 7 extraction)
    phase_gain: float       # acceptance boost in the high phase


# n-gram draftability per task (anchors: paper Fig. 4 ETR ranges: at K=7
# code ~3.2x, math ~1.6x, extraction ~2x with high-copy phases)
TASK_PROCESSES = {
    "code": TaskProcess("code", accept_mean=0.72, accept_std=0.08,
                        ar_rho=0.92, phase_flip_p=0.01, phase_gain=0.10),
    "math": TaskProcess("math", accept_mean=0.40, accept_std=0.08,
                        ar_rho=0.92, phase_flip_p=0.005, phase_gain=0.08),
    "extract": TaskProcess("extract", accept_mean=0.48, accept_std=0.12,
                           ar_rho=0.95, phase_flip_p=0.02, phase_gain=0.35),
}

# expert-affinity is also task-dependent: repetitive token streams (code,
# extraction spans) reuse experts far more than fresh math tokens — this is
# what reconciles Fig. 4's 2.3x (code) vs 3.0x (math) verification overheads
# at K=7 with the same model.
TASK_AFFINITY = {"code": 0.30, "math": 0.00, "extract": 0.25}

# EAGLE drafts are more accurate (paper §7.3: math ETR 1.7 vs 1.3 at K=1)
EAGLE_BOOST = {"code": 0.12, "math": 0.30, "extract": 0.18}

# base expert-token affinity per model (paper §7: OLMoE high, Mixtral low);
# effective affinity = clip(base + TASK_AFFINITY[task], 0, 0.9)
MODEL_AFFINITY = {
    "mixtral-8x7b": 0.12,
    "phi-3.5-moe": 0.25,
    "olmoe-1b-7b": 0.55,
    "deepseek-moe-16b": 0.35,
    "qwen15-moe-a2.7b": 0.35,
    # assigned-pool MoEs (no paper anchor; moderate affinity)
    "kimi-k2-1t-a32b": 0.30,
    "deepseek-v2-236b": 0.30,
}


def effective_affinity(model_name: str, task: str) -> float:
    base = MODEL_AFFINITY.get(model_name, 0.3)
    return float(min(0.9, max(0.0, base + TASK_AFFINITY.get(task, 0.1))))


class AcceptanceProcess:
    """Per-request latent acceptance-rate process."""

    def __init__(self, task: TaskProcess, rng: np.random.Generator,
                 boost: float = 0.0):
        self.task = task
        self.rng = rng
        self.boost = boost
        self.latent = float(np.clip(
            rng.normal(task.accept_mean, task.accept_std), 0.02, 0.95))
        self.high_phase = bool(rng.random() < 0.3)

    def step(self) -> float:
        t = self.task
        if self.rng.random() < t.phase_flip_p:
            self.high_phase = not self.high_phase
        target = t.accept_mean + (t.phase_gain if self.high_phase else 0.0)
        noise = self.rng.normal(0.0, t.accept_std * np.sqrt(1 - t.ar_rho**2))
        self.latent = t.ar_rho * self.latent + (1 - t.ar_rho) * target + noise
        return float(np.clip(self.latent + self.boost, 0.01, 0.98))


class RoutingSimulator:
    """Expert-activation simulator: per token, with prob `affinity` reuse
    the previous token's expert set, else draw k distinct experts uniformly.
    Returns the number of unique experts across the in-flight tokens."""

    def __init__(self, num_experts: int, top_k: int, affinity: float,
                 rng: np.random.Generator):
        self.e = num_experts
        self.k = top_k
        self.affinity = affinity
        self.rng = rng
        self.prev = self._fresh()

    def _fresh(self):
        return set(self.rng.choice(self.e, self.k, replace=False).tolist())

    def unique_for(self, n_tokens: int) -> int:
        uniq = set()
        for _ in range(n_tokens):
            if self.rng.random() < self.affinity and self.prev:
                sel = self.prev
            else:
                sel = self._fresh()
            self.prev = sel
            uniq |= sel
        return len(uniq)
