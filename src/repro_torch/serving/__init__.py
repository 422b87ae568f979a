"""Serving substrate of the port: the single-request and the
continuous-batching engines, the n-gram and draft-model drafters, the samplers, the
schedulers, open-loop load and the per-request and per-step telemetry."""

from repro_torch.core.slo import RequestSLO

from .drafter import DraftModelDrafter, Drafter, NGramDrafter
from .engine import BatchedEngine, GenerationResult, ServingEngine
from .load import (LoadSpec, build_trace, diurnal_arrivals,
                   poisson_arrivals, run_load, summarize)
from .sampler import greedy_verify, logits_to_probs, rejection_sample
from .scheduler import ContinuousBatchingScheduler, Request, Scheduler
from .telemetry import (EngineTelemetry, IterationTelemetry,
                        RequestTelemetry, StepTelemetry, percentile)
