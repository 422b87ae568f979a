"""Iteration-level speculation simulator: the real Cascade controller
against full-size MoE configs, with acceptance and routing drawn from
per-task processes and pass times from the cost model (numpy only)."""

from .simulator import (SimIteration, SimRequest, SpeculationSimulator,
                        run_point, tpot_speedup)
from .tasks import (AcceptanceProcess, RoutingSimulator, TaskProcess,
                    TASK_PROCESSES, effective_affinity)
