"""Cascade on the port: utility analyzer, speculation manager, controllers,
the data-movement cost model with its wall-clock calibration, its
host-tier fetch terms and its expert-parallel (sharded) pricing, the
tiered expert residency, and the batch planner with its grant, residency
and admission constraints."""

from .controller import CascadeController, StaticKController
from .cost_model import (H100_SXM, BatchCostOracle, Calibration,
                         ExpertPlacement, Hardware, Precision, a2a_bytes,
                         batch_iteration_time, draft_time,
                         expected_unique_experts,
                         expected_unique_experts_sharded,
                         fetch_hide_schedule,
                         fetch_time_layered, iteration_bytes,
                         iteration_flops, iteration_time, kv_bytes_per_token,
                         moe_hide_fracs, prefill_chunk_bytes,
                         prefill_crossover_tokens, prefill_time, sample_time)
from .manager import BASELINE, TEST, SET, CascadeConfig, SpeculationManager
from .planner import (ADMIT, DEFER, SHED, AdmissionConstraint,
                      AdmissionDecision, BatchSpecPlanner,
                      FetchDeadlineConstraint, MemoryCapConstraint,
                      PlannerConfig, PredictiveTTFTAdmission)
from .residency import ResidencyState, expert_hbm_bytes, moe_layer_count
from .slo import LATENCY, THROUGHPUT, RequestSLO, tpot_within, ttft_violated
from .utility import IterationRecord, UtilityAnalyzer

__all__ = [
    "CascadeController", "StaticKController", "CascadeConfig",
    "SpeculationManager", "UtilityAnalyzer", "IterationRecord",
    "Hardware", "Precision", "H100_SXM", "expected_unique_experts",
    "iteration_bytes", "iteration_flops", "iteration_time", "draft_time",
    "sample_time", "kv_bytes_per_token", "prefill_chunk_bytes",
    "prefill_time", "BASELINE", "TEST", "SET", "tpot_within",
    "ttft_violated", "BatchCostOracle", "Calibration",
    "batch_iteration_time", "prefill_crossover_tokens", "BatchSpecPlanner",
    "PlannerConfig", "AdmissionConstraint", "AdmissionDecision",
    "PredictiveTTFTAdmission", "ADMIT", "DEFER", "SHED", "RequestSLO",
    "LATENCY", "THROUGHPUT", "ExpertPlacement", "ResidencyState",
    "expert_hbm_bytes", "moe_layer_count", "moe_hide_fracs",
    "fetch_hide_schedule", "fetch_time_layered", "MemoryCapConstraint",
    "FetchDeadlineConstraint", "expected_unique_experts_sharded",
    "a2a_bytes",
]
