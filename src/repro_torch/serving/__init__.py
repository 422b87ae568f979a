"""Serving substrate of the port: the single-request engine, the n-gram
drafter, the samplers and per-request telemetry."""

from .drafter import Drafter, NGramDrafter
from .engine import GenerationResult, ServingEngine
from .sampler import greedy_verify, logits_to_probs, rejection_sample
from .telemetry import IterationTelemetry, RequestTelemetry
