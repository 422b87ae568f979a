"""Single-request serving engine: the vLLM-analogue decode loop with
speculative decoding and Cascade in the loop (the paper's single-batch,
latency-bound setting). Per iteration (paper Fig. 14's spec-decode worker):
    1. controller.next_k() -> K            (Cascade / static policy)
    2. drafter.propose(history, K)         (n-gram)
    3. decode_step over [last_token, d_0..d_{K-1}]   (verification)
    4. greedy verify or rejection sample -> accepted prefix + next token
    5. rollback cache to the accepted length
    6. controller.observe(tokens, t_iter, breakdown)

Timing source: 'wall' is the host clock around work that ends in a device
synchronize; 'model' is the deterministic data-movement cost model driven
by the measured unique-expert activations of each pass, priced for
`hw` (`core.cost_model.H100_SXM` by default)."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core import cost_model as cm
from repro_torch.core.controller import CascadeController
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T

from .drafter import Drafter
from .sampler import greedy_verify, logits_to_probs, rejection_sample, sample_token
from .telemetry import IterationTelemetry, RequestTelemetry


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

    def _now(self) -> float:
        """Host clock after the device's queued work has finished."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

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
                 stop_token: Optional[int] = None) -> GenerationResult:
        cfg = self.cfg
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
        t0 = self._now()
        logits, cache, _ = T.prefill(cfg, self.params, toks, cache,
                                     window=self.window)
        logits = logits[0, -1].float().cpu().numpy()
        wall_prefill = self._now() - t0
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
            t1 = self._now()
            lo, new_cache, aux, staged = T.decode_step(
                cfg, self.params, cache, step_toks, window=self.window)
            lo = lo[0].float().cpu().numpy()             # [K+1, V]
            wall_verify = self._now() - t1

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
