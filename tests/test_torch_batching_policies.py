"""`BatchedEngine` beside the greedy full-attention stream, on the CPU
against the JAX package's: chunked admission, the independent policy, the
drafter's precision and TPOT bounds, then sampling, windows that wrap the
rings, a stop token and expert affinity, on `trained_tiny_moe`. The
helpers and the `trained` fixture are `test_torch_batching`'s; the token
streams and every telemetry field are held exactly equal, as there."""

import pytest

from test_torch_batching import _assert_same, _prompts, _run_pair
from test_torch_batching import trained  # noqa: F401  (a shared fixture)
from test_torch_guards import torch_one_thread  # noqa: F401,E402 (autouse)


@pytest.mark.parametrize("case", [
    dict(chunk=16, packed=True, precision="int8"),
    dict(chunk=8, max_prefill_tokens_per_step=12),
    dict(policy="independent", controller="static"),
    dict(drafter_precision="int8", packed=True),
    dict(slo_tpot=1e-4),
    dict(slo_tpot=1e-4, chunk=16),
])
def test_batched_engine_chunked_policies_and_drafter_precision_equal_jax(
        trained, case):
    jeng, jres, teng, tres = _run_pair(trained, max_batch=4, **case)
    _assert_same(jeng, jres, teng, tres)
    if case.get("chunk"):
        assert all(r.telemetry.prefill_chunks > 1 for r in tres.values())
    if case.get("slo_tpot"):   # the bound really constrains the grants
        assert sum(s.slo_denied for s in teng.telemetry.steps) > 0


@pytest.mark.parametrize("case", [
    dict(temperature=0.8),                 # rejection sampling, seeded
    dict(window=16),                       # the rings wrap
    dict(window=16, chunk=8),
    dict(stop_token="p10"),
    dict(affinity=0.3),
])
def test_batched_engine_sampling_windows_stop_and_affinity_equal_jax(
        trained, case):
    """Paths beside the greedy full-attention stream: at temperature 0.8
    both engines draw from the same seeded generator; a 16-token window is
    shorter than every prompt, so the rings wrap; "p10" stops each request
    at the 11th token of the first prompt's pattern."""
    case = dict(case)
    if case.get("stop_token") == "p10":
        case["stop_token"] = _prompts(1)[0][1 + 10]
    jeng, jres, teng, tres = _run_pair(trained, max_batch=4, **case)
    _assert_same(jeng, jres, teng, tres)
    if "stop_token" in case:
        assert any(r.tokens[-1] == case["stop_token"] for r in tres.values())
    if case.get("chunk"):
        assert all(r.telemetry.prefill_chunks > 1 for r in tres.values())
