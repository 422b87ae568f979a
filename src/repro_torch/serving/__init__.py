"""Serving substrate of the port: the single-request and the
continuous-batching engines, the n-gram drafter, the samplers and the
per-request and per-step telemetry."""

from .drafter import Drafter, NGramDrafter
from .engine import BatchedEngine, GenerationResult, ServingEngine
from .sampler import greedy_verify, logits_to_probs, rejection_sample
from .telemetry import (EngineTelemetry, IterationTelemetry,
                        RequestTelemetry, StepTelemetry, percentile)
