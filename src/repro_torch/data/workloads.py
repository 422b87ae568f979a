"""Synthetic task workloads with controllable n-gram structure.

The paper evaluates code (HumanEval), math (GSM8K), and extraction
(MT-Bench) workloads, whose *draftability* differs: extraction outputs copy
long spans from the prompt (n-gram heaven), code repeats idioms, math
produces near-novel token streams (n-gram hostile). These generators build
token-level analogues over a small vocabulary with the same qualitative
structure, so a ~100M target model trained on them exhibits the paper's
task-dependent acceptance rates *for real* (DESIGN.md §4).

A copy of the JAX package's `data/workloads.py` (numpy only): the same seed
gives the same samples, which the tests check."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

TASKS = ("code", "math", "extract")
MIXES: Dict[str, Tuple[str, ...]] = {
    "code": ("code",),
    "math": ("math",),
    "extract": ("extract",),
    "code+math": ("code", "math"),
    "math+extract": ("math", "extract"),
    "code+extract": ("code", "extract"),
    "all-3": ("code", "math", "extract"),
}

# reserved token ids
PAD, BOS, SEP = 0, 1, 2
_BASE = 3


def _code_like(rng: np.random.Generator, vocab: int, length: int) -> List[int]:
    """Loop-ish structure: a handful of 'statement' templates repeated with
    small mutations — mid n-gram copy rate."""
    toks: List[int] = []
    n_templates = rng.integers(2, 5)
    templates = [list(rng.integers(_BASE, vocab, rng.integers(4, 9)))
                 for _ in range(n_templates)]
    while len(toks) < length:
        t = list(templates[rng.integers(0, n_templates)])
        if rng.random() < 0.4:  # mutate one token (variable rename)
            t[rng.integers(0, len(t))] = int(rng.integers(_BASE, vocab))
        toks.extend(t + [SEP])
    return toks[:length]


def _math_like(rng: np.random.Generator, vocab: int, length: int) -> List[int]:
    """Chain-of-arithmetic: mostly fresh 'digits' with rare operator
    repeats — low n-gram copy rate."""
    ops = list(rng.integers(_BASE, _BASE + 6, 4))
    toks: List[int] = []
    while len(toks) < length:
        expr = [int(rng.integers(_BASE + 6, vocab)) for _ in range(rng.integers(2, 5))]
        toks.extend([expr[0], int(rng.choice(ops))] + expr[1:] + [SEP])
    return toks[:length]


def _extract_like(rng: np.random.Generator, vocab: int, length: int,
                  source: List[int]) -> List[int]:
    """Extraction: copy contiguous spans from the prompt `source`, joined by
    separators — high n-gram copy rate (phases of near-1.0 acceptance)."""
    toks: List[int] = []
    while len(toks) < length:
        span_len = int(rng.integers(4, 12))
        start = int(rng.integers(0, max(1, len(source) - span_len)))
        toks.extend(source[start:start + span_len] + [SEP])
    return toks[:length]


@dataclass
class WorkloadSample:
    task: str
    prompt: List[int]
    continuation: List[int]  # ground-truth continuation (training target)


def make_sample(task: str, rng: np.random.Generator, *, vocab: int = 256,
                prompt_len: int = 64, cont_len: int = 128) -> WorkloadSample:
    if task == "code":
        body = _code_like(rng, vocab, prompt_len + cont_len)
    elif task == "math":
        body = _math_like(rng, vocab, prompt_len + cont_len)
    elif task == "extract":
        src = list(rng.integers(_BASE, vocab, prompt_len))
        cont = _extract_like(rng, vocab, cont_len, src)
        return WorkloadSample(task, [BOS] + src, cont)
    else:
        raise ValueError(task)
    return WorkloadSample(task, [BOS] + body[:prompt_len],
                          body[prompt_len:prompt_len + cont_len])


def request_stream(mix: str, n: int, seed: int = 0, **kw):
    """Round-robin stream over the tasks of a mixed workload (paper §3:
    'equal sharing of requests')."""
    rng = np.random.default_rng(seed)
    tasks = MIXES[mix]
    return [make_sample(tasks[i % len(tasks)], rng, **kw) for i in range(n)]


def sample_length(rng: np.random.Generator, dist: str = "lognormal", *,
                  median: float = 32.0, sigma: float = 0.6,
                  alpha: float = 1.5, lo: int = 4, hi: int = 256) -> int:
    """One long-tailed length draw for production-shaped traffic
    (docs/serving_load.md): real prompt/output length distributions are
    right-skewed — most requests short, a heavy tail of huge ones — and
    the tail is what fills cache rows and queues. "lognormal" draws
    exp(N(ln median, sigma²)) (median `median`, tail weight `sigma`);
    "pareto" draws lo·(1+Pareto(alpha)) (the heavier power-law tail,
    infinite variance at alpha <= 2). Clamped to [lo, hi] — hi mirrors
    the serving cap (`max_len` / `max_new`), where real traffic truncates
    too."""
    if dist == "lognormal":
        x = median * float(np.exp(sigma * rng.standard_normal()))
    elif dist == "pareto":
        x = lo * (1.0 + float(rng.pareto(alpha)))
    else:
        raise ValueError(f"unknown length distribution {dist!r} "
                         "(expected 'lognormal' or 'pareto')")
    return int(min(max(round(x), lo), hi))
