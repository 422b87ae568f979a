"""Cascade on the port: utility analyzer, speculation manager, controllers
and the part of the data-movement cost model the single-request engine
prices its passes with."""

from .controller import CascadeController, StaticKController
from .cost_model import (H100_SXM, Hardware, Precision, draft_time,
                         expected_unique_experts, iteration_bytes,
                         iteration_flops, iteration_time, kv_bytes_per_token,
                         prefill_chunk_bytes, prefill_time, sample_time)
from .manager import BASELINE, TEST, SET, CascadeConfig, SpeculationManager
from .slo import tpot_within, ttft_violated
from .utility import IterationRecord, UtilityAnalyzer

__all__ = [
    "CascadeController", "StaticKController", "CascadeConfig",
    "SpeculationManager", "UtilityAnalyzer", "IterationRecord",
    "Hardware", "Precision", "H100_SXM", "expected_unique_experts",
    "iteration_bytes", "iteration_flops", "iteration_time", "draft_time",
    "sample_time", "kv_bytes_per_token", "prefill_chunk_bytes",
    "prefill_time", "BASELINE", "TEST", "SET", "tpot_within",
    "ttft_violated",
]
