#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card.

Builds the CUDA kernels from `src/repro_torch/csrc/` (one `nvcc` per
source, all at once), then drives these paths, each through the port's
entry points with random weights from a seed:

1. the whole OLMoE-1B-7B (16 layers, d=2048, 64 experts top-8, bf16)
   through the single-request Cascade `ServingEngine` (kernels K1-K3);
   then expert parallelism on the same model: layer 0's MoE dispatched by
   `repro_torch.distributed.make_expert_parallel_moe` over a one-rank
   NCCL group (K1 as the shard's expert FFN) on the 512-token prefill's
   and a B=4 `[1+4]` pass's MoE inputs, held to `apply_moe`, and
   `BatchedEngine` priced over four shards under four placements
   (contiguous, zipf, hot experts replicated, and the naive planner),
   each pass's per-shard counts held to the host's recount;
2. the whole Mixtral-8x7B (32 layers, d=4096, GQA 32/8, 8 experts top-2,
   F=14336) with int8 routed experts and bf16 everything else, 48.3 GB,
   through the continuous-batching `BatchedEngine` under the joint planner
   (kernels K2-K4); then open-loop serving on the same model: a Poisson
   trace replayed through `ContinuousBatchingScheduler` with predictive
   TTFT admission on the wall clock, closed loop first (its passes fit a
   `Calibration`), then open loop without and with the calibrated planner
   (K2, K4, also held against their plain versions at a chunked pass
   where a 64-token prefill chunk shares the pass with decode rows); then
   a host tier of experts priced on the same model (whole-expert and
   per-layer residency with speculation-guided prefetch, K2-K4); then a
   learned drafter on the same model: a one-layer bf16 decoder at
   Mixtral's widths (0.48 B parameters) as a `DraftModelDrafter` per row
   of the batched engine, its wall cost per step and per drafted token
   beside the cost model's (K2-K4); then the serve launcher
   (`repro_torch.launch.serve`) on the reduced config (K1-K3);
3. training: the whole OLMoE-1B-7B in bf16 for a few Adafactor steps
   through `make_train_step` (K5 on the expert products and their input
   gradients, K3 writing each row's log-sum-exp); the same model and
   batch through the expert-parallel dispatch over a one-rank NCCL group
   (`make_train_step(ep=)`: K5 on the receive buffer, K1 never), and its
   2-layer float32 loss and gradients through the dispatch against the
   CPU's over a one-rank gloo group; one float32 step of a
   2-layer full-width OLMoE held against the CPU, and then the repo's
   serve-cascade target (examples/serve_cascade.py) trained by the port and
   served under no-spec, static K=3 and Cascade; then a one-layer drafter
   trained beside it, both saved with `repro_torch.checkpoint` and
   restored bit for bit, and the restored target served with the restored
   drafter through `DraftModelDrafter` (both engines, greedy and sampled);
4. the whole RWKV-6-3B (32 layers, d=2560, 40 heads of 64, bf16, a
   6.20 GB tree) through `ServingEngine` (Cascade and static K=4) and
   through `BatchedEngine` with chunked admission into recycled rows (K6
   on every prefill and verification pass, staging the per-token states
   that speculative rollback selects from); then trained whole on the same
   params, 3 Adafactor steps on one [1,512] batch (K6 forward and its
   backward K6b);
5. the whole RecurrentGemma-9B (38 layers "RRA": 26 RG-LRU and 12
   local-attention blocks, d = d_rnn = 4096, MQA 16/1 at head_dim 256,
   window 2048, bf16, 20.9 GB) through `ServingEngine` and `BatchedEngine`
   like path 4 (K7 on every RG-LRU block, K2 and K3 at head_dim 256 on
   every local-attention block), after a 3000-token prefill that outgrows
   the window; then trained whole like path 4 (K7 and its backward K7b,
   K3 windowed with lse);
6. the dense configurations StableLM-2 1.6B (head_dim 64), StableLM-2 3B
   (head_dim 80) and Minitron-4B (GQA 24/8 at head_dim 128), each at full
   width cut to its first 8 layers, bf16, one after another, through
   `ServingEngine` (K2, K3);
7. the MoEs not yet served on the card, at full width, one after another:
   DeepSeek-MoE-16B and Qwen1.5-MoE-A2.7B whole in bf16 (K1 at F=1408,
   K2, K3), Phi-3.5-MoE whole with int8 routed experts (K4 at F=6400, K2,
   K3), Kimi-K2 cut to 3 of its 61 layers with int8 experts (K4 at 384
   experts top-8, d=7168; K2, K3 at GQA 64/8) and DeepSeek-V2-236B cut to
   6 of its 60 layers in bf16 (Multi-head Latent Attention: K3 at head_dim
   192 on the prefill, the absorbed decode in plain PyTorch, timed; K1 at
   160 experts top-6, d=5120, F=1536), each through `ServingEngine`
   (Cascade, static K=4) and `BatchedEngine(max_batch=4, packed)` under
   the joint planner; then DeepSeek-V2 trained at 2 of its 60 layers (K3
   at head_dim 192 with lse, K5 over 160 experts);
8. the last three families, each whole in bf16, one after another:
   ChatGLM3-6B (2-D RoPE, GQA 32/2: K2 and K3 at a group of 16),
   Qwen2-VL-7B (M-RoPE, GQA 28/4, a group of 7; its prefill takes 256
   patch embeddings on a 16x16 grid and 256 text tokens by `embeds=`
   under 3-D `rope_pos`) and Whisper-large-v3 (MHA 20/20 at head_dim 64;
   its cross-attention to 1500 encoder states runs through K2 with every
   key visible), each through `ServingEngine` (Cascade, static K=4) and
   `BatchedEngine(max_batch=4)` (Whisper's with chunked admission, which
   its requests' encoder outputs send down the blocking prefill); then
   Whisper trained whole on [2,256] with seeded encoder states (K2 as the
   cross-attention forward, whose backward is plain PyTorch);
9. training checks: a 2-layer float32 copy of each of those four
   families at full width on the card against the CPU, K6b and K7b
   against their plain versions on the training steps' inputs and timed,
   K3's lse at head_dim 192 and 256 windowed, and the train launcher
   (`repro_torch.launch.train`) on five families without `--device`.

On each path every kernel is held against its plain PyTorch version on the
inputs the model pass gave it, and kernel, plain version and a PyTorch
yardstick are timed; launch counts are set to 0 just before each engine
run (and each training run) and read just after. Each phase prints one JSON line; the card's name
and power limit (as nvidia-smi reports them) come on a line of their own;
the last line is `{"ok": true, "device": {...}}`. Any failure raises and
exits non-zero.

    python3 chip_smoke.py [--out results.json]

Needs one CUDA card; without one it exits non-zero and prints no result.
Imports nothing of JAX or of the JAX package."""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import checkpoint  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.core.controller import (CascadeController,  # noqa: E402
                                         StaticKController)
from repro_torch.core.residency import (ResidencyState,  # noqa: E402
                                        expert_hbm_bytes)
from repro_torch.core.planner import (BatchSpecPlanner,  # noqa: E402
                                      PlannerConfig,
                                      PredictiveTTFTAdmission)
from repro_torch.data import batch_iterator, make_sample  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    ops as decode_ops)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    ops as flash_ops)
from repro_torch.kernels.linear_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as moe_ops  # noqa: E402
from repro_torch.kernels.moe_gmm.quant import (  # noqa: E402
    quantize_int8)
from repro_torch.kernels.rwkv_scan import ops as rwkv_ops  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mla as mla_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import rglru as rglru_mod  # noqa: E402
from repro_torch.models import rwkv as rwkv_mod  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import (BatchedEngine,  # noqa: E402
                                 ContinuousBatchingScheduler,
                                 DraftModelDrafter, LoadSpec, NGramDrafter,
                                 ServingEngine, build_trace, summarize)
from repro_torch.training import (Optimizer, adamw,  # noqa: E402
                                  global_norm, loss_fn, make_optimizer,
                                  make_train_step)
from repro_torch.training.optimizer import tree_map  # noqa: E402
from repro_torch.training import train as train_mod  # noqa: E402

ARCH = "olmoe-1b-7b"
SEED = 0
PROMPT_LEN = 512      # the model phase's prefill
SPAN = 5              # 1 + K verification span, K = 4
MAX_LEN = 2048        # ring slots of the KV cache
ENGINE_REQUESTS = 3
ENGINE_PROMPT_LEN = 256
ENGINE_NEW = 64
PERIOD = 32           # periodic-copy prompts, the n-gram drafter's case
BYTES_PER_S = cm.H100_SXM.hbm_bw        # 3.35 TB/s, NVIDIA data sheet
BF16_OPS_PER_S = cm.H100_SXM.peak_flops  # 989 TFLOP/s dense bf16
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores, NVIDIA data sheet
TIMED_ITERS = 50
DEVICE = "cuda"
# the Mixtral path: int8 experts through the continuous-batching engine
MIXTRAL = "mixtral-8x7b"
MIX_BATCH = 4         # rows of the batched engine (and of the B=4 pass)
MIX_PROMPT_LEN = 256  # blocking prefill and engine prompts
MIX_NEW = 64
MIX_CHUNK = 64        # the chunked-admission run
MIX_CHUNK_REQUESTS = 2
# open-loop serving on the same model: a LOAD_REQUESTS-request Poisson
# trace at a multiple of the closed loop's service rate, the first of
# LOAD_RATE_MULTIPLES at which the uncalibrated replay sheds a request.
# Its admission prices a pass at about a tenth of the pass's wall time on
# an H100, so it sheds only a request whose queue delay alone passes the
# bound: 2x and 4x shed nothing there, 8x one request or none, so the
# ladder starts at 8x.
LOAD_REQUESTS = 16
LOAD_RATE_MULTIPLES = (8.0, 16.0, 32.0, 64.0)
# the host tier on the same model: the last four experts offloaded, a cap
# of the four pinned experts plus OFFLOAD_SLOTS whole-expert slots (at 1
# byte per int8 parameter; the same bytes hold 32x as many one-layer
# slices under per-layer residency); prices only, every weight stays on
# the card
OFFLOAD_HOST = (4, 5, 6, 7)
OFFLOAD_SLOTS = 2
OFFLOAD_NEW = 32      # new tokens per request: eleven runs in about a minute
# the B=4 pass: each row at its own cache length, verifying its own
# [1+K_i] span padded to SPAN (a continuous batch's ragged rows)
MIX_ROW_LENGTHS = (256, 211, 150, 97)
MIX_SPAN_LENGTHS = (5, 3, 1, 4)
# the training path: the whole OLMoE-1B-7B, B*S = 2048 tokens per step
TRAIN_BATCH = 4
TRAIN_SEQ = 512
TRAIN_STEPS = 5
TRAIN_LR = 1e-3       # Adafactor: RMS-clipped steps of about lr per weight
WHOLE_LAYERS = 2      # the float32 step held against the CPU
# the serve-cascade target (examples/serve_cascade.py), trained by the port
TARGET_STEPS = 200
TARGET_REQUESTS = 6
TARGET_NEW = 48
# the recurrent paths (RWKV-6, RecurrentGemma): the model phase reuses SPAN
# and the Mixtral path's ragged B=4 rows; the engines ENGINE_* and, batched,
# REC_BATCH rows admitting REC_CHUNK tokens a pass
RWKV = "rwkv6-3b"
RGEMMA = "recurrentgemma-9b"
REC_ACCEPT = 2        # the model phase's rollback: 2 of the span's 5 kept
REC_BATCH = 4
REC_CHUNK = 32        # RWKV-6's staged states: 33 x 21.0 MB x 4 rows = 2.8 GB
REC_REQUESTS = 6      # more requests than rows: rows are recycled
# RecurrentGemma's model phase: a prefill that outgrows the 2048-token window
RG_PROMPT_LEN = 3000
RG_MAX_LEN = 3072     # ring slots: the top-level window is 0, a full cache

#: kernel -> (CUDA source, the TPU kernel it replaces)
KERNEL_SOURCES = {
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:76"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:65"),
    "moe_gmm_fused": ("src/repro_torch/csrc/moe_gmm.cu",
                      "src/repro/kernels/moe_gmm/kernel.py:156"),
    "moe_gmm_fused_quant": ("src/repro_torch/csrc/moe_gmm_quant.cu",
                            "src/repro/kernels/moe_gmm/kernel.py:266"),
    "moe_gmm": ("src/repro_torch/csrc/moe_gmm_grouped.cu",
                "src/repro/kernels/moe_gmm/kernel.py:82"),
    "rwkv_scan": ("src/repro_torch/csrc/rwkv_scan.cu",
                  "src/repro/kernels/rwkv_scan/kernel.py:52"),
    "linear_scan": ("src/repro_torch/csrc/linear_scan.cu",
                    "src/repro/kernels/linear_scan/kernel.py:44"),
    # the backwards the JAX package takes by differentiating these scans
    "rwkv_scan_bwd": ("src/repro_torch/csrc/rwkv_scan.cu",
                      "src/repro/models/rwkv.py:88"),
    "linear_scan_bwd": ("src/repro_torch/csrc/linear_scan.cu",
                        "src/repro/models/rglru.py:59"),
}

#: the kernels with more than one route: library -> {kernel stem: route}
#: (`span_merge` serves both of decode_attention's routes)
ROUTE_KERNELS = {
    "flash_attention": {"flash_wgmma": "wgmma", "flash_fwd": "simt"},
    "moe_gmm_grouped": {"gmm_wgmma": "wgmma", "gmm_bf16": "wmma",
                        "gmm_f32": "simt"},
    "moe_gmm": {"ffn_wgmma": "wgmma", "gate_up": "simt", "down": "simt"},
    "moe_gmm_quant": {"ffn_q8_wgmma": "wgmma", "gate_up_q8": "simt",
                      "down_q8": "simt"},
    "decode_attention": {"span_mma": "mma", "span_partial": "simt",
                         "span_merge": "both"},
}
#: the tensor-core routes, whose kernels must not spill, and the SASS
#: instructions each route library must hold: HGMMA (wgmma), HMMA
#: (mma.sync), UTMALDG (TMA tile loads)
TENSOR_ROUTES = ("wgmma", "mma")
SASS_REQUIRED = {
    "flash_attention": ("HGMMA", "UTMALDG"),
    "moe_gmm_grouped": ("HGMMA", "UTMALDG"),
    "moe_gmm": ("HGMMA", "UTMALDG"),
    "moe_gmm_quant": ("HGMMA", "UTMALDG"),
    "decode_attention": ("HMMA",),
}
#: the bf16 serving paths' routes (OLMoE's engine; Mixtral's runs K4 for
#: its experts, on wgmma too) and the float32 card-vs-CPU phases'
BF16_SERVING = {"flash_attention": "wgmma", "decode_attention": "mma",
                "moe_gmm_fused": "wgmma"}
F32_SERVING = {"flash_attention": "simt", "decode_attention": "simt",
               "moe_gmm_fused": "simt"}

RESULTS: dict = {}


def emit(phase: str, **rec) -> None:
    rec = {"phase": phase, **rec}
    RESULTS[phase] = rec
    print(json.dumps(rec), flush=True)


def _time_ms(fn, iters: int = TIMED_ITERS, warmup: int = 3) -> float:
    """Mean milliseconds of `fn` over `iters` calls, by CUDA events after a
    warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _host_ms(fn, iters: int = TIMED_ITERS) -> float:
    """Mean host milliseconds of one call of `fn` (a wrapper's checks,
    allocations and launch), the device running behind: the part of the
    events time a CUDA graph removes."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * secs / iters


def _kernel_ms(fn, iters: int = 10) -> dict:
    """Device milliseconds per call of each CUDA kernel `fn` launches
    (torch.profiler over `iters` calls after a warm-up), by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if ev.device_type == torch.autograd.DeviceType.CUDA and t > 0:
            out[ev.key[:60]] = out.get(ev.key[:60], 0.0) + t / 1e3 / iters
    return out


def _graph_ms(fn, iters: int = 20, cold: bool = False) -> float:
    """Mean device milliseconds of `fn` from one CUDA graph of `iters`
    calls, replayed and timed by CUDA events: the kernels' own time,
    without the host's time between launches (which CUDA events over
    back-to-back calls measure instead when a wrapper's host work outlasts
    its kernel). Warm: the calls back to back, inputs left in the 50 MB L2
    cache. Cold: a 256 MB write before each call, whose own graph's time
    is subtracted."""
    def replay_ms(body) -> float:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
            for _ in range(iters):
                body()
        torch.cuda.current_stream().wait_stream(side)
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    fn()
    torch.cuda.synchronize()
    if not cold:
        return replay_ms(fn)
    flush = torch.empty(64 << 20, device=DEVICE)

    def flushed():
        flush.zero_()
        fn()
    return replay_ms(flushed) - replay_ms(flush.zero_)


def _bound(n_bytes: float, n_ops: float,
           ops_per_s: float = BF16_OPS_PER_S) -> tuple:
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over the peak rate of their type (bf16 unless
    given). Returns (ms, bound_by)."""
    t_b, t_o = n_bytes / BYTES_PER_S, n_ops / ops_per_s
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")


def _check_routes(phase: str, expected: dict) -> None:
    """Every launch since the last count reset of each kernel named in
    `expected` went through the route it names (bf16 on the tensor cores,
    float32 on the CUDA cores), and at least one did."""
    routes, counts = K.route_counts(), K.launch_counts()
    bad = {n: routes[n] for n, r in expected.items()
           if counts[n] == 0 or routes[n][r] != counts[n]}
    if bad:
        raise AssertionError(f"{phase}: launches off the route {expected} "
                             f"(or none): {bad}")


def _repeat_equal(name, out, again) -> bool:
    """Two calls on the same inputs give the same bits (no atomics, no
    split sums)."""
    same = all(torch.equal(a, b) for a, b in zip(out, again))
    if not same:
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    return same


def _copy_prompt(rng, n: int, vocab: int) -> list:
    p = rng.integers(3, vocab, PERIOD).tolist()
    return ([1] + p * (n // PERIOD + 1))[:n]


class _Recorder:
    """Stand in for a kernel wrapper inside a module for one model pass,
    keeping the first call's arguments (layer 0): the inputs the main path
    hands the kernel. Arguments at `copy` (the KV cache buffers, which
    later passes overwrite in place) are cloned. With `key(args, kw)`, the
    first call of each key is kept in `calls` (say, each orientation of a
    product). With `keep_kw(kw)`, only what it returns of the keywords is
    kept (say, not a view that would hold a pass's output buffer alive)."""

    def __init__(self, module, name: str, copy=(), key=None, keep_kw=None):
        self.module, self.name, self.copy, self.key = module, name, copy, key
        self.keep_kw = dict if keep_kw is None else keep_kw
        self.args = None
        self.calls: dict = {}

    def __enter__(self):
        self.wrapped = getattr(self.module, self.name)
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.wrapped)

    # a wrapper counts its launches on itself, by its module-level name
    @property
    def launches(self):
        return self.wrapped.launches

    @launches.setter
    def launches(self, n):
        self.wrapped.launches = n

    @property
    def launches_by_route(self):
        return self.wrapped.launches_by_route

    def __call__(self, *args, **kw):
        key = None if self.key is None else self.key(args, kw)
        if key not in self.calls:
            self.calls[key] = ([a.clone() if i in self.copy else a
                                for i, a in enumerate(args)],
                               self.keep_kw(kw))
            if self.args is None:
                self.args = self.calls[key]
        return self.wrapped(*args, **kw)


def _cloned(kw) -> dict:
    return {k: v.clone() if torch.is_tensor(v) else v for k, v in kw.items()}


class _MixedPassRecorder:
    """Stand in for `T.decode_step` while an engine serves, keeping the
    layer-0 inputs of K2 and K4 in the engine's first shared pass where a
    full MIX_CHUNK-token prefill chunk sits beside at least one decode row:
    the shapes chunked admission hands the kernels (every row padded to the
    chunk's bucketed length, each row's cache at its own length). Every
    tensor but K4's weights is cloned, since later passes may reuse the
    buffers. Set `eng` before the engine steps."""

    def __init__(self):
        self.eng, self.inputs, self.tokens_per_row = None, {}, None

    def __enter__(self):
        self.step = T.decode_step
        T.decode_step = self
        return self

    def __exit__(self, *exc):
        T.decode_step = self.step

    def __call__(self, cfg, params, cache, toks, **kw):
        mask = kw.get("token_mask")
        if self.inputs or mask is None:
            return self.step(cfg, params, cache, toks, **kw)
        n = mask.sum(1).tolist()
        phases = {s.phase for i, s in enumerate(self.eng.slots)
                  if s is not None and n[i]}
        if not (MIX_CHUNK in n and toks.shape[1] == MIX_CHUNK
                and phases == {"prefill", "decode"}):
            return self.step(cfg, params, cache, toks, **kw)
        with _Recorder(T, "decode_attention", copy=range(5),
                       keep_kw=_cloned) as rec_b, \
                _Recorder(moe_mod, "moe_gmm_fused_quant", copy=(0, 7),
                          keep_kw=_cloned) as rec:
            out = self.step(cfg, params, cache, toks, **kw)
        self.tokens_per_row = n
        self.inputs[f"moe_gmm_fused_quant/chunk{MIX_CHUNK}-packed"] = rec.args
        self.inputs[f"decode_attention/chunk{MIX_CHUNK}"] = rec_b.args
        return out


# --------------------------------------------------------------------- #
# Phases
# --------------------------------------------------------------------- #

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script "
                           "needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    dev = {"kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    emit("device", **dev, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    return dev


def _ptxas_kernels(log: str) -> dict:
    """Each kernel's registers, shared memory and spilled bytes, from a
    `ptxas -v` log, by mangled name."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", ln)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            out[name]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def _demangle(names) -> dict:
    """Mangled kernel names as `kernel<template arguments>` (c++filt)."""
    exe = shutil.which("c++filt")
    if exe is None or not names:
        return {n: n for n in names}
    out = subprocess.run([exe], input="\n".join(names), capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return {n: re.sub(r"^void \(anonymous namespace\)::", "",
                      d).split("(")[0]
            for n, d in zip(names, out.splitlines())}


def _cuobjdump() -> str:
    """The toolkit's cuobjdump, or the copy Triton's package carries."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(exe):
        return exe
    import importlib.util
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin is not None:
        exe = Path(spec.origin).parent / "backends/nvidia/bin/cuobjdump"
        if exe.exists():
            return str(exe)
    raise RuntimeError("cuobjdump not found in the toolkit or in Triton")


def phase_build() -> None:
    """Build every kernel library; report each kernel's ptxas registers,
    shared memory and spills (by route for the kernels with routes) and
    the HGMMA (wgmma), HMMA (mma.sync), UTMALDG (TMA tile load) and UBLKCP
    (bulk copy) instructions in the SASS of those kernels' libraries.
    Fails if an instruction of `SASS_REQUIRED` is missing from its library
    or a tensor-core kernel (wgmma or mma route) spills."""
    secs = K.build()
    ptxas, routes, sass = {}, {}, {}
    for lib, log in K.ptxas_log.items():
        kernels = _ptxas_kernels(log)
        names = _demangle(sorted(kernels))
        ptxas[lib] = {names[n]: info for n, info in kernels.items()}
    for lib, stems in ROUTE_KERNELS.items():
        for name, info in ptxas.pop(lib).items():
            route = next((r for stem, r in stems.items() if stem in name),
                         None)
            routes.setdefault(lib, {}).setdefault(route, {})[name] = info
        dump = subprocess.run(
            [_cuobjdump(), "-sass", str(K.library_path(lib))],
            capture_output=True, text=True, timeout=300, check=True).stdout
        sass[lib] = {op: len(re.findall(rf"\b{op}\b", dump))
                     for op in ("HGMMA", "HMMA", "UTMALDG", "UBLKCP")}
    emit("build", seconds=secs, routes=routes, sass=sass, ptxas=ptxas)
    for lib, ops in SASS_REQUIRED.items():
        if not all(sass[lib][op] for op in ops):
            raise AssertionError(f"{lib}: its SASS lacks one of {ops}: "
                                 f"{sass[lib]}")
    spills = {name: info for lib in routes.values() for r in TENSOR_ROUTES
              for name, info in lib.get(r, {}).items()
              if info.get("spill_bytes", 0)}
    missing = [lib for lib in ROUTE_KERNELS
               if not any(routes.get(lib, {}).get(r) for r in TENSOR_ROUTES)]
    if spills or missing:
        raise AssertionError(f"tensor-core kernels spilling {spills} or "
                             f"missing in {missing}")


def phase_model(cfg, params) -> dict:
    """Prefill a 512-token prompt and verify a 5-token span on both MoE
    branches; record each kernel's layer-0 inputs for the kernel phase."""
    rng = np.random.default_rng(SEED)
    dev = torch.device(DEVICE)
    prompt = torch.tensor([_copy_prompt(rng, PROMPT_LEN, cfg.vocab_size)],
                          dtype=torch.int32, device=dev)
    span = torch.tensor([rng.integers(3, cfg.vocab_size, SPAN).tolist()],
                        dtype=torch.int32, device=dev)
    torch.cuda.reset_peak_memory_stats()
    cache = T.init_cache(cfg, 1, MAX_LEN, device=dev)
    inputs = {}
    with _Recorder(T, "flash_attention") as rec_a, \
            _Recorder(moe_mod, "moe_gmm_fused") as rec_c:
        t0 = time.perf_counter()
        lo_pre, cache, aux_pre = T.prefill(cfg, params, prompt, cache)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
    inputs["flash_attention"] = rec_a.args
    inputs["moe_gmm_fused/prefill-dense"] = rec_c.args

    outs = {}
    for name, t, packed in (("dense", SPAN, False), ("packed", SPAN, True),
                            ("dense-t1", 1, False)):
        # decode_step writes K/V in place: give each pass its own cache
        c = {k: v.clone() for k, v in cache.items()}
        with _Recorder(T, "decode_attention", copy=(1, 2)) as rec_b, \
                _Recorder(moe_mod, "moe_gmm_fused") as rec_c:
            t0 = time.perf_counter()
            lo, _, aux, _ = T.decode_step(cfg, params, c, span[:, :t],
                                          moe_packed=packed)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        outs[name] = (lo.float(), aux, secs)
        inputs[f"moe_gmm_fused/t{t}-{name.split('-')[0]}"] = rec_c.args
        inputs[f"decode_attention/t{t}"] = rec_b.args
    peak = torch.cuda.max_memory_allocated()

    dense, packed = outs["dense"][0], outs["packed"][0]
    finite = bool(torch.isfinite(lo_pre.float()).all()
                  and all(torch.isfinite(o[0]).all() for o in outs.values()))
    # kernel C computes a slot's bits independently of the layout holding
    # it, so the two branches should agree exactly
    diff = float((packed - dense).abs().max())
    scale = float(dense.abs().max())
    uniq = outs["dense"][1]["unique_experts"].tolist()
    uniq_packed = outs["packed"][1]["unique_experts"].tolist()
    emit("model", arch=cfg.name, params=cfg.param_count(),
         dtype=cfg.dtype, prompt_len=PROMPT_LEN, span=SPAN,
         prefill_s=t_prefill, decode_s={k: v[2] for k, v in outs.items()},
         logits_finite=finite, packed_vs_dense_max_abs=diff,
         dense_logit_max_abs=scale,
         packed_bit_identical=bool(torch.equal(packed, dense)),
         unique_experts_per_layer=uniq,
         unique_experts_t1=outs["dense-t1"][1]["unique_experts"].tolist(),
         peak_memory_bytes=peak)
    if not finite:
        raise AssertionError("non-finite logits")
    if uniq != uniq_packed:
        raise AssertionError(f"routing differs: dense {uniq}, packed "
                             f"{uniq_packed}")
    if not torch.allclose(packed, dense, atol=1e-2 * scale, rtol=1e-2):
        raise AssertionError(f"packed logits differ from dense by {diff} "
                             f"(scale {scale})")
    if not all(8 <= u <= 40 for u in uniq):
        raise AssertionError(f"unique experts per layer out of [8, 40]: "
                             f"{uniq}")
    return inputs


def _attn_cost(q, k, pairs) -> tuple:
    """(bytes, ops) of attention: q, the K/V rows read, the output written;
    4*D operations per valid (query head, key) pair."""
    el = q.element_size()
    d = q.shape[-1]
    bytes_ = 2 * q.numel() * el + 2 * pairs["kv_rows"] * k.shape[2] * d * el
    return bytes_ + pairs.get("extra_bytes", 0), 4.0 * d * pairs["qk"]


def _check_attn(name, out, ref) -> dict:
    """Elementwise |out - ref| <= 2e-2 + 2e-2 * |ref|, and each (query,
    head) slice of D values within 1e-2 * max|ref of the slice| + 1e-4: an
    output averaging thousands of keys at one KV head runs small, and the
    elementwise floor alone would not see a fault there."""
    o, r = out.float().flatten(0, -2), ref.float().flatten(0, -2)
    err_sl = (o - r).abs().amax(-1)
    ref_sl = r.abs().amax(-1)
    lim = 1e-2 * ref_sl + 1e-4
    j = int((err_sl / lim).argmax())
    share = float(err_sl[j] / lim[j])
    err = float(err_sl.max())
    if not torch.allclose(o, r, atol=2e-2, rtol=2e-2) or share > 1.0:
        raise AssertionError(f"{name}: kernel differs from plain version, "
                             f"max |err| {err}; worst (query, head) slice "
                             f"{float(err_sl[j])} against its limit "
                             f"{float(lim[j])}")
    return dict(max_abs_err=err, ref_max_abs=float(ref_sl.max()),
                ref_median_abs=float(r.abs().median()),
                worst_slice={"max_abs_err": float(err_sl[j]),
                             "ref_max_abs": float(ref_sl[j]),
                             "limit": float(lim[j])},
                worst_slice_share_of_limit=share,
                tolerance="allclose atol=rtol=2e-2, and per (query, head) "
                          "slice max|err| <= 1e-2*max|ref of the slice| + "
                          "1e-4")


def _check_moe(name, out, ref, atol: float = 1e-3) -> dict:
    """max|err| <= 1e-2 * max|ref| + atol over the whole output, and the
    same within every row of the output (a row of small norm is held to
    its own scale, not to the largest row's)."""
    o, r = out.float().flatten(0, -2), ref.float().flatten(0, -2)
    err_row = (o - r).abs().amax(-1)
    ref_row = r.abs().amax(-1)
    err, ref_max = float(err_row.max()), float(ref_row.max())
    lim = 1e-2 * ref_max + atol
    row_ratio = float((err_row / (1e-2 * ref_row + atol)).max())
    if err > lim or row_ratio > 1.0:
        raise AssertionError(f"{name}: kernel differs from plain version, "
                             f"max |err| {err} (limit {lim}), worst row at "
                             f"{row_ratio} of its limit")
    return dict(max_abs_err=err, ref_max_abs=ref_max, limit=lim,
                worst_row_share_of_limit=row_ratio,
                tolerance=f"max|err| <= 1e-2*max|ref| + {atol:g}, overall "
                          "and per row")


def case_flash(args, kw) -> dict:
    """K3 against its plain version; the bound counts the pairs the causal
    (and window) mask keeps; the library is SDPA, with the window as a
    mask where there is one."""
    q, k, v = args
    b, s, h, d = q.shape
    window = kw.get("window") or 0
    out = K.flash_attention(q, k, v, **kw)
    again = K.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    check = _check_attn("flash_attention", out,
                        K.flash_attention_plain(q, k, v, **kw))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    gqa = {"enable_gqa": True} if kt.shape[1] != qt.shape[1] else {}
    mask = flash_ops._causal_mask(s, window, q.device)
    lib_kw = {"attn_mask": mask} if window else {"is_causal": True}
    pairs = {"qk": b * h * float(mask.sum()), "kv_rows": b * s}
    n_bytes, n_ops = _attn_cost(q, k, pairs)
    bound_ms, bound_by = _bound(n_bytes, n_ops)

    def run():
        return K.flash_attention(q, k, v, **kw)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, **lib_kw, **gqa)
    return dict(
        shape=f"q{list(q.shape)} kv{list(k.shape)} window {window} "
              f"{q.dtype}", route=flash_ops.route(q.dtype), **check,
        repeat_bit_equal=_repeat_equal("flash_attention", [out], [again]),
        ms=_time_ms(run), device_ms=_graph_ms(run),
        device_ms_cold=_graph_ms(run, cold=True), host_ms=_host_ms(run),
        plain_ms=_time_ms(lambda: K.flash_attention_plain(q, k, v, **kw),
                          iters=10 if s > 1024 else TIMED_ITERS),
        library_ms=_time_ms(library), library_device_ms=_graph_ms(library),
        bound_ms=bound_ms, bound_by=bound_by)


def case_decode(args, kw) -> dict:
    """K2 against its plain version; the bound counts the (query, key)
    pairs the causal (and window) mask keeps and the K/V rows some query
    needs; the library is SDPA with that mask. `device_ms` and
    `device_ms_cold` are the kernel's own time, from CUDA graphs."""
    q, kc, vc, cache_pos, q_pos = args
    b, t, h, d = q.shape
    window = kw.get("window") or 0
    out = K.decode_attention(q, kc, vc, cache_pos, q_pos, **kw)
    again = K.decode_attention(q, kc, vc, cache_pos, q_pos, **kw)
    torch.cuda.synchronize()
    check = _check_attn("decode_attention", out, K.decode_attention_plain(
        q, kc, vc, cache_pos, q_pos, **kw))
    valid = ((cache_pos[:, None, :] >= 0)
             & (cache_pos[:, None, :] <= q_pos[:, :, None]))   # [B,T,S]
    if window:
        valid &= cache_pos[:, None, :] > q_pos[:, :, None] - window
    live_slots = int((cache_pos >= 0).sum())
    pairs = {"qk": float(valid.sum()) * h,
             "kv_rows": int(valid.any(1).sum()),
             "extra_bytes": cache_pos.numel() * 4 + q_pos.numel() * 4}
    n_bytes, n_ops = _attn_cost(q, kc, pairs)
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))
    mask = valid[:, None]                                      # [B,1,T,S]
    gqa = {"enable_gqa": True} if kt.shape[1] != qt.shape[1] else {}

    def run():
        return K.decode_attention(q, kc, vc, cache_pos, q_pos, **kw)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              **gqa)
    return dict(
        shape=f"q{list(q.shape)} cache{list(kc.shape)} live slots "
              f"{live_slots} window {window} {q.dtype}",
        route=decode_ops.route(q.dtype), **check,
        repeat_bit_equal=_repeat_equal("decode_attention", [out], [again]),
        q_pos_first=q_pos[:, 0].tolist(),
        ms=_time_ms(run), device_ms=_graph_ms(run),
        device_ms_cold=_graph_ms(run, cold=True), host_ms=_host_ms(run),
        plain_ms=_time_ms(lambda: K.decode_attention_plain(
            q, kc, vc, cache_pos, q_pos, **kw)),
        library_ms=_time_ms(library), library_device_ms=_graph_ms(library),
        bound_ms=bound_ms, bound_by=bound_by)


def case_moe(args, kw, rows=None) -> dict:
    """K1 against its plain version; the bound counts the live experts'
    weights, the live rows' x and the whole y (`rows`, when given, is the
    number of rows the data needs, where the counts cover more: the
    expert-parallel receive buffer's zero rows); the library is a gather
    of the live experts' weights and three `torch.bmm`s (h rounded to
    bf16; the kernel keeps it at float32 precision). `device_ms` and
    `device_ms_cold` are the kernel's own time, from CUDA graphs."""
    x, wg, wu, wd, counts = args
    ids = kw.get("expert_ids")
    out = K.moe_gmm_fused(x, wg, wu, wd, counts, **kw)
    again = K.moe_gmm_fused(x, wg, wu, wd, counts, **kw)
    torch.cuda.synchronize()
    check = _check_moe("moe_gmm_fused", out, K.moe_gmm_fused_plain(
        x, wg, wu, wd, counts, **kw))
    u, c, d = x.shape
    f = wu.shape[2]
    cnt = counts.long()
    live = int((cnt > 0).sum())
    if rows is None:
        rows = int(cnt.clamp(max=c).sum())
    el = x.element_size()
    dead_out = out[counts == 0]
    if dead_out.numel() and dead_out.abs().max() != 0:
        raise AssertionError("moe_gmm_fused: dead slots are not exact zeros")
    n_bytes = (live * 3 * d * f * el + rows * d * el + u * c * d * el
               + counts.numel() * 4 * (1 if ids is None else 2))
    n_ops = 6.0 * d * f * rows
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    live_idx = torch.nonzero(counts > 0).flatten()

    def library():
        # a gather of the live experts' weights plus batched matmuls
        e = live_idx if ids is None else ids[live_idx].long()
        xl = x.index_select(0, live_idx)
        h = F.silu(torch.bmm(xl, wg.index_select(0, e))) * torch.bmm(
            xl, wu.index_select(0, e))
        return torch.bmm(h, wd.index_select(0, e))

    def run():
        return K.moe_gmm_fused(x, wg, wu, wd, counts, **kw)

    return dict(
        shape=f"x{list(x.shape)} live slots {live} rows {rows} {x.dtype}",
        route=moe_ops.fused_route(x.dtype, d, f), **check,
        repeat_bit_equal=_repeat_equal("moe_gmm_fused", [out], [again]),
        ms=_time_ms(run), device_ms=_graph_ms(run),
        device_ms_cold=_graph_ms(run, cold=True), host_ms=_host_ms(run),
        plain_ms=_time_ms(lambda: K.moe_gmm_fused_plain(x, wg, wu, wd, counts,
                                                        **kw)),
        library_ms=_time_ms(library), library_device_ms=_graph_ms(library),
        bound_ms=bound_ms, bound_by=bound_by,
        weight_bytes=live * 3 * d * f * el)


def phase_kernels(inputs) -> dict:
    """Hold each kernel against its plain version on the recorded inputs
    and time both; the first case of each kernel is the engine's shape."""
    cases = {}
    runners = {"flash_attention": case_flash, "decode_attention": case_decode,
               "moe_gmm_fused": case_moe}
    order = ["flash_attention", "decode_attention/t5", "decode_attention/t1",
             "moe_gmm_fused/t5-dense", "moe_gmm_fused/t5-packed",
             "moe_gmm_fused/t1-dense", "moe_gmm_fused/prefill-dense"]
    for key in order:
        args, kw = inputs[key]
        cases[key] = runners[key.split("/")[0]](args, kw)
        emit(f"kernel:{key}", **cases[key])
    return cases


def phase_reference() -> None:
    """The reduced OLMoE (float32, 2 layers, d=256, 4 experts top-2) on the
    card against the same weights on the CPU, where every kernel's plain
    version runs: a prefill and a packed [1+4] pass agree within 1e-3
    (float32 sums in another order), routing is equal, and the engine's
    greedy stream, with real drafts and rollbacks, is equal."""
    cfg = get_config(ARCH).reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(SEED),
                           device="cpu")
    rng = np.random.default_rng(SEED)
    pattern = rng.integers(3, cfg.vocab_size, 16).tolist()
    prompt = [1] + pattern * 3
    outs = []
    for dev in ("cpu", DEVICE):
        K.reset_launch_counts()
        p = _to(params, dev)
        toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
        span = torch.tensor([pattern[:SPAN]], dtype=torch.int32, device=dev)
        cache = T.init_cache(cfg, 1, 128, device=dev)
        lo, cache, _ = T.prefill(cfg, p, toks, cache)
        lo2, _, aux, _ = T.decode_step(cfg, p, cache, span, moe_packed=True)
        eng = ServingEngine(cfg, p, NGramDrafter(),
                            controller_factory=lambda: StaticKController(4),
                            max_len=128, temperature=0.0, device=dev)
        res = eng.generate(prompt, max_new=32)
        outs.append((lo.float().cpu(), lo2.float().cpu(),
                     aux["unique_experts"].cpu(), res))
    (c_lo, c_lo2, c_u, c_res), (g_lo, g_lo2, g_u, g_res) = outs
    err = max(float((g_lo - c_lo).abs().max()),
              float((g_lo2 - c_lo2).abs().max()))
    its = g_res.telemetry.iterations
    drafted = sum(it.k_drafted for it in its)
    accepted = sum(it.tokens_emitted - 1 for it in its)
    emit("reference", arch=cfg.name, dtype=cfg.dtype, logits_max_abs_err=err,
         unique_experts=g_u.tolist(), tokens_equal=g_res.tokens == c_res.tokens,
         iterations=len(its), drafted=drafted, accepted=accepted,
         routes=K.route_counts())
    _check_routes("reference", F32_SERVING)
    for a, b in ((g_lo, c_lo), (g_lo2, c_lo2)):
        if not torch.allclose(a, b, atol=1e-3, rtol=1e-3):
            raise AssertionError(f"card and CPU passes differ by {err}")
    if not torch.equal(g_u, c_u) or g_res.tokens != c_res.tokens:
        raise AssertionError("card and CPU disagree on routing or tokens")
    if drafted == 0:
        raise AssertionError("the reference engine run verified no spans")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, dev) for v in tree)
    return tree.to(dev)


def _engine_workload(cfg, params, n_requests=ENGINE_REQUESTS,
                     prompt_len=ENGINE_PROMPT_LEN) -> tuple:
    """Periodic-copy prompts over one set of PERIOD tokens (a permutation of
    it per request), and the model with its unembedding restricted to that
    set: the other columns are zeroed, so those logits are exactly 0 and the
    greedy token is one of the set. Random weights alone give a greedy
    stream that almost never repeats a token of its history, even after a
    prompt that holds the model's own greedy continuation, so the n-gram
    drafter would propose nothing; here
    every emitted token occurs in the prompt, so the drafter proposes on
    every pass and the engine verifies [1+K] spans at full width. Widths,
    shapes and the work of every pass are unchanged."""
    rng, vocab = _kept_vocab(cfg)
    prompts = [([1] + rng.permutation(vocab).tolist()
                * (prompt_len // PERIOD + 1))[:prompt_len]
               for _ in range(n_requests)]
    return prompts, _restrict_unembed(cfg, params, vocab)


def _kept_vocab(cfg) -> tuple:
    """The PERIOD token ids the restricted unembedding keeps, and the
    generator that drew them (`_engine_workload` draws its prompts next)."""
    rng = np.random.default_rng(SEED + 1)
    return rng, rng.choice(np.arange(3, cfg.vocab_size), PERIOD,
                           replace=False)


def _restrict_unembed(cfg, params, vocab) -> dict:
    """The model with every unembedding column outside `vocab` zeroed."""
    keep = torch.zeros(cfg.vocab_size, dtype=params["embed"]["unembed"].dtype,
                       device=DEVICE)
    keep[torch.as_tensor(vocab, device=DEVICE)] = 1
    embed = dict(params["embed"], unembed=params["embed"]["unembed"] * keep)
    return dict(params, embed=embed)


def phase_engine(cfg, params, phase="engine", max_new=ENGINE_NEW,
                 kernels=BF16_SERVING) -> dict:
    """ServingEngine with the n-gram drafter under Cascade and static K=4,
    ENGINE_REQUESTS prompts of `max_new` new tokens each, wall clock, the
    unembedding restricted so that the drafter proposes. Every launch of
    the kernels named in `kernels` goes through its route and no other
    kernel launches; no plain version runs. Returns the launch counts."""
    t_phase = time.perf_counter()
    prompts, params = _engine_workload(cfg, params)
    K.reset_launch_counts()
    report = {}
    with _no_plain_versions() as plain_calls:
        for name, factory in (("cascade", CascadeController),
                              ("static-k4", lambda: StaticKController(4))):
            eng = ServingEngine(cfg, params, NGramDrafter(),
                                controller_factory=factory, clock="wall",
                                temperature=0.0, max_len=MAX_LEN, seed=SEED,
                                device=DEVICE)
            n_out = n_iter = k_sum = acc_sum = 0
            decode_s = prefill_s = verify_s = 0.0
            utils = []
            t0 = time.perf_counter()
            for i, prompt in enumerate(prompts):
                res = eng.generate(prompt, max_new=max_new,
                                   request_id=str(i))
                tel = res.telemetry
                if len(res.tokens) != max_new or not all(
                        0 <= tok < cfg.vocab_size for tok in res.tokens):
                    raise AssertionError(f"{name}: bad output {res.tokens}")
                n_out += len(res.tokens)
                n_iter += len(tel.iterations)
                k_sum += sum(it.k_drafted for it in tel.iterations)
                acc_sum += sum(it.tokens_emitted - 1 for it in tel.iterations)
                verify_s += sum(it.t_verify for it in tel.iterations)
                decode_s += tel.decode_time
                prefill_s += tel.t_prefill
                utils.append(tel.iterations[-1].utility)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            report[name] = dict(
                tokens=n_out, iterations=n_iter,
                decode_tokens_per_s=(n_out - ENGINE_REQUESTS) / decode_s,
                end_to_end_tokens_per_s=n_out / wall, wall_s=wall,
                prefill_s_mean=prefill_s / ENGINE_REQUESTS,
                pass_wall_s=verify_s / n_iter,
                drafted=k_sum, accepted=acc_sum, mean_k=k_sum / n_iter,
                utility_mean=float(np.mean(utils)))
    launches = K.launch_counts()
    emit(phase, arch=cfg.name, requests=ENGINE_REQUESTS,
         prompt_len=ENGINE_PROMPT_LEN, max_new=max_new, clock="wall",
         temperature=0.0, policies=report, launches=launches,
         routes=K.route_counts(), plain_calls=plain_calls,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         seconds=time.perf_counter() - t_phase)
    _check_routes(phase, kernels)
    if any(plain_calls.values()):
        raise AssertionError(f"plain versions ran on the card: "
                             f"{plain_calls}")
    others = {n: c for n, c in launches.items() if n not in kernels and c}
    if others:
        raise AssertionError(f"{phase}: kernels off the path launched: "
                             f"{others}")
    idle = [n for n, r in report.items() if r["drafted"] == 0]
    if idle:
        raise AssertionError(f"{phase}: engine verified no drafted span: "
                             f"{idle}")
    return launches


def _profile(phase: str, step, steps: int, labels=(), **rec) -> tuple:
    """Run `step` a few times under torch.profiler: device time by kernel,
    the device time of the ranges named in `labels` (record_function
    ranges: the kernels of the operations inside them), and the device's
    idle share of the steps' wall time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    # a range's device time: the kernels that start inside its device-side
    # annotation (kernels run in launch order on the one stream). The
    # host-side tree of ranges is not used: it sometimes links kernels of
    # later operations to a range, up to twice the range's own time
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_label = {}
    for label in labels:
        spans = [(e.time_range.start, e.time_range.end) for e in on_card
                 if e.name == label]
        by_label[label] = sum(
            e.time_range.end - e.time_range.start for e in on_card
            if e.name not in labels
            and any(a <= e.time_range.start < b for a, b in spans)) / 1e3
    by_name = {}
    for ev in prof.key_averages():
        if ev.key in labels:
            continue
        # kernels only: an operator's own row repeats its kernels' time
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        by_name[ev.key[:90]] = by_name.get(ev.key[:90], 0.0) + t / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit(phase, steps=steps, **rec, wall_ms_per_step=1e3 * wall /
         steps, device_busy_ms_per_step=busy / steps if busy else None,
         device_idle_share=(1.0 - busy / (1e3 * wall)) if busy else None,
         top_device_ms_per_step={k: v / steps for k, v in top},
         **({"labelled_device_ms_per_step": {
             k: by_label.get(k, 0.0) / steps for k in labels}}
            if labels else {}))
    return by_name, by_label, busy / steps if busy else None


def phase_profile(cfg, params, steps: int = 5) -> None:
    """Where a verification pass's time goes: device time by kernel over a
    few dense T=5 decode steps (torch.profiler), and the device's idle
    share of their wall time."""
    rng = np.random.default_rng(SEED + 2)
    dev = torch.device(DEVICE)
    prompt = torch.tensor([_copy_prompt(rng, PROMPT_LEN, cfg.vocab_size)],
                          dtype=torch.int32, device=dev)
    span = torch.tensor([rng.integers(3, cfg.vocab_size, SPAN).tolist()],
                        dtype=torch.int32, device=dev)
    cache = T.init_cache(cfg, 1, MAX_LEN, device=dev)
    _, cache, _ = T.prefill(cfg, params, prompt, cache)

    def step():
        # every step writes the same span slots of the same cache
        lo, _, aux, _ = T.decode_step(cfg, params, cache, span)
        return lo[0, -1].float().cpu(), aux["unique_experts"].cpu()

    _profile("profile", step, steps, span=SPAN)


# --------------------------------------------------------------------- #
# Path 1's expert parallelism: the dispatch over a one-rank NCCL group, and
# BatchedEngine priced over four shards
# --------------------------------------------------------------------- #

EP_SHARDS = 4         # the engine's placements: 64 experts over 4 shards
EP_REQUESTS = 4
EP_NEW = 32
EP_HOT = 4            # hottest experts of the probe pass, replicated


def _ep_inputs(cfg, params) -> dict:
    """Layer 0's MoE params and inputs on the main path: the 512-token
    prefill's MoE input, and a B=4 `[1+4]` pass's (four rows prefilled
    with 256-token prompts, each verifying a 5-token span: 20 tokens)."""
    rng = np.random.default_rng(SEED + 3)
    dev = torch.device(DEVICE)
    xs = {}
    prompt = torch.tensor([_copy_prompt(rng, PROMPT_LEN, cfg.vocab_size)],
                          dtype=torch.int32, device=dev)
    cache = T.init_cache(cfg, 1, MAX_LEN, device=dev)
    with _Recorder(moe_mod, "apply_moe") as rec:
        T.prefill(cfg, params, prompt, cache)
    layer0 = rec.args[0][1]
    xs[f"prefill{PROMPT_LEN}"] = rec.args[0][2]
    rows = torch.tensor([_copy_prompt(rng, ENGINE_PROMPT_LEN, cfg.vocab_size)
                         for _ in range(MIX_BATCH)], dtype=torch.int32,
                        device=dev)
    cache = T.init_cache(cfg, MIX_BATCH, MAX_LEN, device=dev)
    _, cache, _ = T.prefill(cfg, params, rows, cache)
    span = torch.tensor(rng.integers(3, cfg.vocab_size, (MIX_BATCH, SPAN)),
                        dtype=torch.int32, device=dev)
    with _Recorder(moe_mod, "apply_moe") as rec:
        T.decode_step(cfg, params, cache, span)
    xs[f"b{MIX_BATCH}x{SPAN}"] = rec.args[0][2]
    del cache
    return {"p": layer0, "x": xs}


def phase_ep_dispatch(cfg, inputs) -> list:
    """`make_expert_parallel_moe` on layer 0's MoE at full width over a
    one-rank NCCL group (an in-process store: no network), on both inputs
    of `_ep_inputs`. At the least capacity factor that drops nothing it
    is held to `apply_moe(capacity_policy="exact")` (bf16: `_check_moe`'s
    tolerance, per row) with the routing equal; at the default 2.0 its
    `dropped` equals the overflow counted on the host from the routing.
    K1's inputs on this path (the receive buffer, every slot at its full
    rows) are held to the plain version and timed. Returns (the
    prefill's routing [T, k], the probe pass that picks the engine
    phase's hot experts; the K1 cases by input)."""
    import torch.distributed as dist
    from repro_torch.distributed import expert_parallel as ep_mod

    t_phase = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        p = ep_mod.shard_moe_params(cfg, inputs["p"], 0, 1)
        e, k = cfg.num_experts, cfg.experts_per_token
        probe, cases = None, {}
        for name, x in inputs["x"].items():
            t = x.shape[0]
            ref, ref_aux = moe_mod.apply_moe(cfg, inputs["p"], x,
                                             capacity_policy="exact")
            idx = ref_aux["expert_idx"]
            probe = idx if probe is None else probe
            hits = moe_mod._hits(idx, e).long()
            max_hits = int(hits.max())
            # the least factor whose quota int(t*k*cf)//E + 1 holds the
            # busiest expert's rows
            cf_exact = ((max_hits - 1) * e + 0.5) / (t * k)
            K.reset_launch_counts()
            with torch.no_grad():
                y, aux = ep_mod.make_expert_parallel_moe(
                    cfg, group, capacity_factor=cf_exact)(p, x)
                with _Recorder(ep_mod, "moe_gmm_fused") as rec:
                    y2, aux2 = ep_mod.make_expert_parallel_moe(cfg, group)(
                        p, x)
            torch.cuda.synchronize()
            launches = K.launch_counts()["moe_gmm_fused"]
            c_src = max(int(t * k * 2.0) // e + 1, 1)
            overflow = int((hits - c_src).clamp(min=0).sum())
            dropped = (int(aux["dropped"].sum()), int(aux2["dropped"].sum()))
            idx_equal = (bool(torch.equal(aux["expert_idx"], idx))
                         and bool(torch.equal(aux2["expert_idx"], idx)))
            check = _check_moe(f"ep-dispatch:{name}", y, ref)
            emit(f"ep-dispatch:{name}", tokens=t, d_model=cfg.d_model,
                 experts=e, top_k=k, moe_d_ff=cfg.moe_d_ff, dtype=cfg.dtype,
                 group="nccl, 1 rank", capacity_factor_exact=cf_exact,
                 c_src_exact=max(int(t * k * cf_exact) // e + 1, 1),
                 max_hits=max_hits, dropped_exact=dropped[0],
                 vs_apply_moe_exact=check,
                 bit_equal=bool(torch.equal(y, ref)),
                 expert_idx_equal=idx_equal, c_src_default=c_src,
                 dropped_default=dropped[1], host_overflow_default=overflow,
                 k1_launches=launches,
                 unique_experts=int(aux["unique_experts"].sum()))
            if dropped[0] != 0 or not idx_equal:
                raise AssertionError(f"ep-dispatch:{name}: dropped "
                                     f"{dropped[0]} at the exact factor, "
                                     f"routing equal {idx_equal}")
            if dropped[1] != overflow:
                raise AssertionError(f"ep-dispatch:{name}: dropped "
                                     f"{dropped[1]} at capacity 2.0, the "
                                     f"routing overflows by {overflow}")
            if launches < 2:
                raise AssertionError(f"ep-dispatch:{name}: K1 launched "
                                     f"{launches} times in two dispatches")
            args, kw = rec.args
            live_rows = int(args[0].ne(0).any(-1).sum())
            cases[name] = case_moe(args, kw, rows=live_rows)
            emit(f"ep-kernel:moe_gmm_fused/{name}", live_rows=live_rows,
                 **cases[name])
            del ref, y, y2, args, rec
        emit("ep-dispatch", seconds=time.perf_counter() - t_phase)
    finally:
        dist.destroy_process_group()
    return probe, cases


class _ShardCounts:
    """Stand in for `T.decode_step` while an expert-parallel engine serves:
    every pass's per-layer routing (each MoE layer's `expert_idx`, kept
    through `moe_mod.apply_moe`) comes to the host, its per-shard and
    per-row-per-shard distinct-expert counts are recounted there under the
    pass's shard map and token mask, and they must equal the counts the
    pass returned on the card."""

    def __enter__(self):
        self.step, self.passes = T.decode_step, 0
        T.decode_step = self
        return self

    def __exit__(self, *exc):
        T.decode_step = self.step

    def __call__(self, cfg, params, cache, toks, **kw):
        idxs, apply = [], moe_mod.apply_moe

        def keep(*a, **k):
            y, aux = apply(*a, **k)
            idxs.append(aux["expert_idx"])
            return y, aux
        moe_mod.apply_moe = keep
        try:
            out = self.step(cfg, params, cache, toks, **kw)
        finally:
            moe_mod.apply_moe = apply
        aux = out[2]
        sid = kw["ep_shard_ids"].cpu().numpy()
        mask = kw["token_mask"].cpu().numpy()
        n_s = kw["ep_n_shards"]
        b, t = toks.shape
        got = (aux["unique_experts_shard"].cpu().numpy(),
               aux["unique_experts_row_shard"].cpu().numpy())
        for lyr, idx in enumerate(idxs):
            idx = idx.cpu().numpy().reshape(b, t, -1)
            rows = [set(idx[r][mask[r]].ravel().tolist()) for r in range(b)]
            per_row = np.zeros((b, n_s), np.int64)
            for r, ex in enumerate(rows):
                for x in ex:
                    per_row[r, sid[x]] += 1
            per_shard = np.zeros(n_s, np.int64)
            for x in set().union(*rows):
                per_shard[sid[x]] += 1
            if not (np.array_equal(per_shard, got[0][lyr])
                    and np.array_equal(per_row, got[1][lyr])):
                raise AssertionError(
                    f"pass {self.passes}, layer {lyr}: the card's per-shard "
                    f"counts {got[0][lyr].tolist()} (rows "
                    f"{got[1][lyr].tolist()}) differ from the host's "
                    f"{per_shard.tolist()} ({per_row.tolist()})")
        self.passes += 1
        return out


def phase_ep_engine(cfg, params, probe) -> dict:
    """BatchedEngine(max_batch=4, packed, joint planner, model clock) over
    the whole model with its 64 experts placed over four shards:
    contiguous; zipf-sized; contiguous with the EP_HOT hottest experts of
    the probe pass replicated on the next shard; and contiguous under the
    naive planner (`shard_aware=False`). EP_REQUESTS prompts of 256
    tokens, EP_NEW new tokens each, the unembedding restricted so that
    the drafter proposes. Every pass's per-shard counts from the card
    equal the host's recount (`_ShardCounts`)."""
    t_phase = time.perf_counter()
    e = cfg.num_experts
    prompts, rparams = _engine_workload(cfg, params, n_requests=EP_REQUESTS)
    hot = torch.argsort(moe_mod._hits(probe, e), descending=True,
                        stable=True)[:EP_HOT].tolist()
    base = cm.ExpertPlacement.contiguous(e, EP_SHARDS)
    runs = {"contiguous": (base, True),
            "zipf": (cm.ExpertPlacement.zipf(e, EP_SHARDS), True),
            "replicated": (base.replicate(
                {x: (base.shard_of[x] + 1) % EP_SHARDS for x in hot}), True),
            "contiguous-naive": (base, False)}
    report = {}
    K.reset_launch_counts()
    with _ShardCounts() as counts:
        for name, (pl, aware) in runs.items():
            planner = BatchSpecPlanner(
                cfg, cm.H100_SXM, placement=pl,
                config=PlannerConfig(shard_aware=aware))
            eng = BatchedEngine(cfg, rparams, max_batch=MIX_BATCH,
                                packed=True, planner=planner, placement=pl,
                                clock="model", temperature=0.0,
                                max_len=MAX_LEN, seed=SEED, device=DEVICE)
            p0 = counts.passes
            results, wall = _serve_batched(eng, prompts, EP_NEW)
            steps, tel = eng.telemetry.steps, eng.telemetry
            its = [it for r in results for it in r.telemetry.iterations]
            tokens = sum(len(r.tokens) for r in results)
            emitted = sum(it.tokens_emitted for it in its)
            report[name] = dict(
                shards=pl.n_shards, counts=list(pl.counts),
                replicated=(sorted(x for x, s in enumerate(pl.shard_of)
                                   if isinstance(s, tuple))),
                shard_aware=aware, passes=len(steps),
                passes_checked=counts.passes - p0, tokens=tokens,
                tokens_per_pass=emitted / len(steps),
                tokens_per_row_pass=emitted / len(its),
                mean_k=sum(it.k_drafted for it in its) / len(its),
                model_tokens_per_s=tokens / eng.now,
                mean_shard_imbalance=tel.mean_shard_imbalance,
                hot_shard_frac=tel.hot_shard_frac,
                replica_moves=eng.replica_moves,
                a2a_share=(sum(s.t_a2a for s in steps)
                           / sum(s.t_step for s in steps)),
                mean_max_shard_experts=float(np.mean(
                    [s.max_shard_experts for s in steps])),
                mean_union_experts=float(np.mean(
                    [s.union_experts for s in steps])),
                wall_s=wall)
            if counts.passes - p0 != len(steps):
                raise AssertionError(f"ep-engine:{name}: {len(steps)} passes,"
                                     f" {counts.passes - p0} checked")
    launches = K.launch_counts()
    emit("ep-engine", arch=cfg.name, requests=EP_REQUESTS,
         prompt_len=ENGINE_PROMPT_LEN, max_new=EP_NEW, clock="model",
         hot_experts=hot, runs=report, launches=launches,
         routes=K.route_counts(), seconds=time.perf_counter() - t_phase)
    if launches["moe_gmm_fused"] == 0:
        raise AssertionError("ep-engine: K1 never launched")
    return report


# --------------------------------------------------------------------- #
# The Mixtral path: int8 experts, continuous batching
# --------------------------------------------------------------------- #

def phase_mixtral_params(cfg) -> dict:
    """The whole Mixtral-8x7B with int8 routed experts, built one layer at
    a time on the card (`_int8_params`): a full-width bf16 tree (93.4 GB)
    never exists."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = _int8_params(cfg)
    by_type = _bytes_by_dtype(params)
    emit("mixtral-params", arch=cfg.name, params=cfg.param_count(),
         bytes=sum(by_type.values()), bytes_by_dtype=by_type,
         seconds=time.perf_counter() - t0,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return params


def phase_mixtral_model(cfg, params) -> dict:
    """One blocking 256-token prefill, one B=4 pass over a per-row cache on
    each MoE branch, and one 1-token packed pass; record the layer-0 inputs
    of K2, K3 and K4 for the kernel phase. The B=4 pass is a continuous
    batch's: its rows sit at different cache lengths (MIX_ROW_LENGTHS, by a
    per-row rollback of the prefilled prompt) and verify ragged [1+K_i]
    spans (MIX_SPAN_LENGTHS) padded to SPAN under a token mask."""
    rng = np.random.default_rng(SEED + 3)
    dev = torch.device(DEVICE)
    prompt = torch.tensor([_copy_prompt(rng, MIX_PROMPT_LEN,
                                        cfg.vocab_size)],
                          dtype=torch.int32, device=dev)
    torch.cuda.reset_peak_memory_stats()
    inputs = {}
    row = T.init_cache(cfg, 1, MAX_LEN, device=dev)
    with _Recorder(T, "flash_attention") as rec_a, \
            _Recorder(moe_mod, "moe_gmm_fused_quant") as rec:
        t0 = time.perf_counter()
        lo_pre, row, _ = T.prefill(cfg, params, prompt, row)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
    inputs["flash_attention/prefill"] = rec_a.args
    inputs["moe_gmm_fused_quant/prefill-dense"] = rec.args

    batch = T.init_cache(cfg, MIX_BATCH, MAX_LEN, device=dev, per_row=True)
    for slot in range(MIX_BATCH):
        batch = T.write_cache_row(batch, slot, row)
    batch = T.rollback_cache(cfg, batch, None, 0, torch.tensor(
        MIX_ROW_LENGTHS, dtype=torch.int32, device=dev))
    span = torch.tensor(rng.integers(3, cfg.vocab_size, (MIX_BATCH, SPAN)),
                        dtype=torch.int32, device=dev)
    mask = (torch.arange(SPAN, device=dev)[None, :]
            < torch.tensor(MIX_SPAN_LENGTHS, device=dev)[:, None])
    outs = {}
    bt = f"b{MIX_BATCH}x{SPAN}"
    for name, packed in (("dense", False), ("packed", True)):
        c = {k: v.clone() for k, v in batch.items()}
        with _Recorder(T, "decode_attention", copy=(1, 2)) as rec_b, \
                _Recorder(moe_mod, "moe_gmm_fused_quant") as rec:
            t0 = time.perf_counter()
            lo, _, aux, _ = T.decode_step(cfg, params, c, span,
                                          token_mask=mask, moe_packed=packed)
            torch.cuda.synchronize()
            outs[name] = (lo.float(), aux, time.perf_counter() - t0)
        inputs[f"moe_gmm_fused_quant/t{MIX_BATCH * SPAN}-{name}"] = rec.args
        inputs.setdefault(f"decode_attention/{bt}", rec_b.args)
    c = {k: v.clone() for k, v in row.items()}
    with _Recorder(T, "decode_attention", copy=(1, 2)) as rec_b, \
            _Recorder(moe_mod, "moe_gmm_fused_quant") as rec:
        t0 = time.perf_counter()
        lo1, _, aux1, _ = T.decode_step(cfg, params, c, span[:1, :1],
                                        moe_packed=True)
        torch.cuda.synchronize()
        t_one = time.perf_counter() - t0
    inputs["moe_gmm_fused_quant/t1-packed"] = rec.args
    inputs["decode_attention/t1"] = rec_b.args
    peak = torch.cuda.max_memory_allocated()
    q_pos = inputs[f"decode_attention/{bt}"][0][4]

    dense, packed = outs["dense"][0], outs["packed"][0]
    finite = bool(torch.isfinite(lo_pre.float()).all()
                  and torch.isfinite(lo1.float()).all()
                  and all(torch.isfinite(o[0]).all() for o in outs.values()))
    uniq = outs["dense"][1]["unique_experts"].tolist()
    uniq1 = aux1["unique_experts"].tolist()
    emit("mixtral-model", arch=cfg.name, dtype=cfg.dtype,
         experts="int8", prompt_len=MIX_PROMPT_LEN, batch=MIX_BATCH,
         span=SPAN, row_lengths=list(MIX_ROW_LENGTHS),
         span_lengths=list(MIX_SPAN_LENGTHS),
         q_pos_first=q_pos[:, 0].tolist(), prefill_s=t_prefill,
         decode_s={**{k: v[2] for k, v in outs.items()}, "t1-packed": t_one},
         logits_finite=finite,
         packed_vs_dense_max_abs=float((packed - dense).abs().max()),
         dense_logit_max_abs=float(dense.abs().max()),
         packed_bit_identical=bool(torch.equal(packed, dense)),
         unique_experts_per_layer=uniq,
         unique_experts_row_layer0=outs["dense"][1][
             "unique_experts_row"][0].tolist(),
         unique_experts_t1=uniq1, peak_memory_bytes=peak)
    if not finite:
        raise AssertionError("non-finite logits")
    if uniq != outs["packed"][1]["unique_experts"].tolist():
        raise AssertionError("routing differs between the MoE branches")
    if not torch.equal(packed, dense):
        raise AssertionError("dense and packed logits are not bit-identical")
    if q_pos[:, 0].tolist() != list(MIX_ROW_LENGTHS):
        raise AssertionError(f"rows start at {q_pos[:, 0].tolist()}, not "
                             f"{list(MIX_ROW_LENGTHS)}")
    if uniq1 != [cfg.experts_per_token] * cfg.num_layers:
        raise AssertionError(f"a 1-token pass routed to {uniq1} experts")
    if not all(cfg.experts_per_token <= u <= cfg.num_experts for u in uniq):
        raise AssertionError(f"unique experts per layer: {uniq}")
    return inputs


def _moe_quant_exact(x, wg, wu, wd, sg, su, sd, counts, *,
                     activation="swiglu", expert_ids=None):
    """K4's function in float64, one live slot at a time, rounded once to
    x's type: the correctly rounded result both the kernel and the plain
    version (float32 sums) are held to in `case_moe_quant`'s report."""
    y = torch.zeros(x.shape, dtype=torch.float64, device=x.device)
    for u in torch.nonzero(counts > 0).flatten().tolist():
        n = min(int(counts[u]), x.shape[1])
        e = u if expert_ids is None else int(expert_ids[u])
        xs = x[u, :n].double()
        up = xs @ (wu[e].double() * float(su[e]))
        h = (F.silu(xs @ (wg[e].double() * float(sg[e]))) * up
             if activation == "swiglu" else F.gelu(up, approximate="tanh"))
        y[u, :n] = h @ (wd[e].double() * float(sd[e]))
    return y.to(x.dtype)


def case_moe_quant(args, kw) -> dict:
    """K4 against its plain version; the bound counts the live experts'
    int8 weights and scales, the live rows' x and the whole y; the library
    is a PyTorch composition (the live slices dequantized to bf16, then
    `torch.bmm`). `device_ms` and `device_ms_cold` are the kernel's own
    time, from CUDA graphs. Kernel and plain version are also held to the
    correctly rounded float64 result: how many outputs each rounds the
    other way, and each one's worst row against it (one bf16 step at a
    row's largest output is up to 0.78 of the limit)."""
    x, wg, wu, wd, sg, su, sd, counts = args
    ids = kw.get("expert_ids")
    out = K.moe_gmm_fused_quant(x, wg, wu, wd, sg, su, sd, counts, **kw)
    again = K.moe_gmm_fused_quant(x, wg, wu, wd, sg, su, sd, counts, **kw)
    torch.cuda.synchronize()
    plain = K.moe_gmm_fused_quant_plain(x, wg, wu, wd, sg, su, sd, counts,
                                        **kw)
    check = _check_moe("moe_gmm_fused_quant", out, plain)
    exact = _moe_quant_exact(x, wg, wu, wd, sg, su, sd, counts, **kw)
    against_exact = {
        name: {"rounded_otherwise": int((t != exact).sum()),
               "worst_row_share_of_limit": _check_moe(
                   name, t, exact)["worst_row_share_of_limit"]}
        for name, t in (("kernel", out), ("plain", plain))}
    del plain, exact
    u, c, d = x.shape
    f = wu.shape[2]
    route = moe_ops.quant_route(x.dtype, d, f, c)
    live = int((counts > 0).sum())
    rows = int(counts.long().clamp(max=c).sum())
    el = x.element_size()
    keep = torch.arange(c, device=x.device)[None, :] < counts[:, None]
    if out[~keep].numel() and out[~keep].abs().max() != 0:
        raise AssertionError("moe_gmm_fused_quant: dead slots or rows past "
                             "the count are not exact zeros")
    weight_bytes = live * 3 * d * f           # int8: one byte per weight
    n_bytes = (weight_bytes + live * 3 * 4 + rows * d * el + u * c * d * el
               + counts.numel() * 4 * (1 if ids is None else 2))
    n_ops = 6.0 * d * f * rows
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    live_idx = torch.nonzero(counts > 0).flatten()
    e = live_idx if ids is None else ids[live_idx].long()

    def library():
        # a PyTorch composition: dequantize the live experts' slices to
        # bf16, then batched matmuls
        def deq(q, s):
            return q.index_select(0, e).to(x.dtype) * s[e].to(
                x.dtype)[:, None, None]
        xl = x.index_select(0, live_idx)
        h = F.silu(torch.bmm(xl, deq(wg, sg))) * torch.bmm(xl, deq(wu, su))
        return torch.bmm(h, deq(wd, sd))

    def run():
        return K.moe_gmm_fused_quant(x, wg, wu, wd, sg, su, sd, counts, **kw)

    return dict(
        shape=f"x{list(x.shape)} live slots {live} rows {rows} {x.dtype}, "
              f"int8 experts", counts=counts.tolist(), route=route, **check,
        against_exact=against_exact, outputs=out.numel(),
        repeat_bit_equal=_repeat_equal("moe_gmm_fused_quant", [out],
                                       [again]),
        ms=_time_ms(run), device_ms=_graph_ms(run),
        device_ms_cold=_graph_ms(run, cold=True), host_ms=_host_ms(run),
        plain_ms=_time_ms(lambda: K.moe_gmm_fused_quant_plain(
            x, wg, wu, wd, sg, su, sd, counts, **kw), iters=10),
        library_ms=_time_ms(library, iters=10),
        library="dequantize live slices to bf16 + torch.bmm (a PyTorch "
                "composition)",
        bound_ms=bound_ms, bound_by=bound_by, weight_bytes=weight_bytes)


def phase_mixtral_kernels(inputs, keys=None) -> dict:
    """Each kernel of the path against its plain version on the recorded
    layer-0 inputs, timed: by default K4 at the three shapes of the path
    (and the B=4 pass's dense layout), K2 at the ragged B=4 pass (GQA 32/8,
    rows at their own lengths) and the 1-token pass, K3 at the 256-token
    GQA prefill; or the cases named in `keys` (the open-loop phase's
    chunked pass)."""
    cases = {}
    runners = {"flash_attention": case_flash, "decode_attention": case_decode,
               "moe_gmm_fused_quant": case_moe_quant}
    t = MIX_BATCH * SPAN
    for key in keys or (f"moe_gmm_fused_quant/t{t}-packed",
                        f"moe_gmm_fused_quant/t{t}-dense",
                        "moe_gmm_fused_quant/t1-packed",
                        "moe_gmm_fused_quant/prefill-dense",
                        f"decode_attention/b{MIX_BATCH}x{SPAN}",
                        "decode_attention/t1", "flash_attention/prefill"):
        args, kw = inputs[key]
        cases[key] = runners[key.split("/")[0]](args, kw)
        emit(f"mixtral-kernel:{key}", **cases[key])
    return cases


@contextlib.contextmanager
def _no_plain_versions():
    """Count calls of every kernel's plain version while the block runs:
    on the card the wrappers must never reach them."""
    mods = {"moe_gmm_fused_plain": moe_ops,
            "moe_gmm_fused_quant_plain": moe_ops,
            "moe_gmm_plain": moe_ops,
            "decode_attention_plain": sys.modules[
                "repro_torch.kernels.decode_attention.ops"],
            # both forms: the serving path's and the training path's lse
            "flash_attention_plain": flash_ops,
            "rwkv_scan_plain": rwkv_ops,
            "linear_scan_plain": scan_ops,
            # the recurrences' backwards (the attention backward is plain
            # PyTorch on the card by design, so it is not counted)
            "rwkv_scan_bwd_plain": rwkv_ops,
            "linear_scan_bwd_plain": scan_ops}
    calls = {n: 0 for n in mods}
    saved = {n: getattr(m, n) for n, m in mods.items()}

    def counting(name):
        def f(*a, **k):
            calls[name] += 1
            return saved[name](*a, **k)
        return f

    for n, m in mods.items():
        setattr(m, n, counting(n))
    try:
        yield calls
    finally:
        for n, m in mods.items():
            setattr(m, n, saved[n])


def _serve_batched(eng, prompts, max_new, on_retire=None,
                   encs=None) -> tuple:
    """Continuous batching: join prompts while a row is free (blocking or
    chunked admission; prompt i with encoder output `encs[i]` when given),
    step, retire what finished (then call `on_retire(slot)`, if given),
    until every prompt is served. The clock starts after the first joins.
    Returns (results in prompt order, wall seconds)."""
    pending, live, done = list(enumerate(prompts)), {}, {}

    def admit():
        while pending and eng.free_slots:
            i, p = pending.pop(0)
            kw = {} if encs is None else {"enc_out": encs[i]}
            live[eng.join(p, max_new, request_id=str(i), **kw)] = i

    admit()
    t0 = time.perf_counter()
    while live:
        eng.step()
        for slot, i in list(live.items()):
            if eng.slots[slot].done:
                done[i] = eng.retire(slot)
                del live[slot]
                if on_retire is not None:
                    on_retire(slot)
        admit()
    torch.cuda.synchronize()
    return [done[i] for i in range(len(prompts))], time.perf_counter() - t0


def phase_mixtral_engine(cfg, params) -> dict:
    """BatchedEngine(max_batch=4, packed, int8 experts, wall clock) on four
    256-token prompts of 64 new tokens under Cascade with the joint planner
    and under static K=4 with independent grants, then a chunked-admission
    run (chunk=64) on two requests."""
    prompts, params = _engine_workload(cfg, params, MIX_BATCH,
                                       MIX_PROMPT_LEN)
    int8 = cm.Precision.int8_experts()
    runs = (("cascade-joint", CascadeController, "joint", 0, MIX_BATCH),
            ("static-k4-independent", lambda: StaticKController(4),
             "independent", 0, MIX_BATCH),
            (f"cascade-joint-chunk{MIX_CHUNK}", CascadeController, "joint",
             MIX_CHUNK, MIX_CHUNK_REQUESTS))
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    report, passes = {}, 0
    with _no_plain_versions() as plain_calls:
        for name, factory, policy, chunk, n_req in runs:
            eng = BatchedEngine(cfg, params, max_batch=MIX_BATCH,
                                controller_factory=factory, policy=policy,
                                packed=True, precision=int8, chunk=chunk,
                                clock="wall", temperature=0.0,
                                max_len=MAX_LEN, seed=SEED, device=DEVICE)
            results, wall = _serve_batched(eng, prompts[:n_req], MIX_NEW)
            tels = [r.telemetry for r in results]
            for r in results:
                if len(r.tokens) != MIX_NEW or not all(
                        0 <= t < cfg.vocab_size for t in r.tokens):
                    raise AssertionError(f"{name}: bad output {r.tokens}")
            steps = eng.telemetry.steps
            n_decode = sum(s.decode_tokens for s in steps)
            its = [it for t in tels for it in t.iterations]
            passes += len(steps) + (0 if chunk else n_req)
            emitted = sum(it.tokens_emitted for it in its)
            report[name] = dict(
                requests=n_req, steps=len(steps),
                output_tokens=sum(len(r.tokens) for r in results),
                # tokens from the shared passes over the wall time of the
                # step loop (the chunked run's loop also runs its prefill)
                decode_tokens_per_s=emitted / wall, wall_s=wall,
                engine_clock_s=sum(s.t_total for s in steps),
                tpot_s=[t.tpot for t in tels],
                experienced_tpot_s=[t.experienced_tpot for t in tels],
                ttft_s=[t.ttft for t in tels],
                drafted=sum(it.k_drafted for it in its),
                accepted=sum(it.tokens_emitted - 1 for it in its),
                mean_k=sum(it.k_drafted for it in its) / len(its),
                k_granted_per_step=sum(s.k_granted for s in steps)
                / len(steps),
                mean_occupancy=eng.telemetry.mean_occupancy,
                mean_union_experts=eng.telemetry.mean_union_experts,
                expert_bytes_saved=eng.telemetry.expert_bytes_saved,
                span_tokens=n_decode,
                prefill_chunks=[t.prefill_chunks for t in tels])
    launches = K.launch_counts()
    emit("mixtral-engine", arch=cfg.name, experts="int8", packed=True,
         max_batch=MIX_BATCH, prompt_len=MIX_PROMPT_LEN, max_new=MIX_NEW,
         clock="wall", temperature=0.0, policies=report,
         launches=launches, routes=K.route_counts(), passes=passes,
         plain_calls=plain_calls,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    _check_routes("mixtral-engine", {"flash_attention": "wgmma",
                                     "decode_attention": "mma",
                                     "moe_gmm_fused_quant": "wgmma"})
    if any(plain_calls.values()):
        raise AssertionError(f"plain versions ran on the card: "
                             f"{plain_calls}")
    for n in ("flash_attention", "decode_attention", "moe_gmm_fused_quant"):
        if launches[n] == 0:
            raise AssertionError(f"{n} never launched on the Mixtral path")
    if launches["moe_gmm_fused_quant"] != cfg.num_layers * passes:
        raise AssertionError(
            f"K4 launched {launches['moe_gmm_fused_quant']} times over "
            f"{passes} passes of {cfg.num_layers} layers")
    idle = [n for n, r in report.items() if r["drafted"] == 0]
    if idle:
        raise AssertionError(f"engine verified no drafted span: {idle}")
    if torch.cuda.max_memory_allocated() >= 80e9:
        raise AssertionError("peak memory over 80 GB")
    return launches


class _GrantReplay(StaticKController):
    """A controller that asks, at its row's n-th pass, for the K that row
    was granted at its n-th pass of a recorded run. Under
    policy="independent" the engine then verifies exactly the recorded
    spans, pass for pass (the n-gram drafter proposes the same drafts from
    the same history), so two runs differ only in what else they do."""

    def __init__(self, grants):
        super().__init__(max(grants, default=0))
        self.k = CascadeController().config.k_max    # the same spec room
        self.grants = iter(grants)

    def next_k(self) -> int:
        return next(self.grants, 0)


def _replay_factory(results):
    """Controller factory for requests joined in `results` order, each
    replaying its recorded grants."""
    pending = [[it.k_granted for it in r.telemetry.iterations]
               for r in results]
    return lambda: _GrantReplay(pending.pop(0))


def _first_difference(streams, ref) -> list:
    """Per request, the index of the first token where `streams` leaves
    `ref` (the shorter length when one is a prefix of the other; None when
    equal)."""
    out = []
    for t, a in zip(streams, ref):
        j = next((j for j, (x, y) in enumerate(zip(t, a)) if x != y),
                 None if t == a else min(len(t), len(a)))
        out.append(j)
    return out


def _tiered_engine(cfg, params, placement, cap, *, clock="model",
                   granularity=None, prefetch=True, policy="joint",
                   controller_factory=CascadeController):
    """The host-tier phase's BatchedEngine over the int8 Mixtral: a fresh
    `ResidencyState` at `granularity` (None: flat) and the given clock,
    policy and controllers. Returns (engine, residency or None)."""
    int8 = cm.Precision.int8_experts()
    rs = None
    if granularity is not None:
        rs = ResidencyState(placement, cfg, cap_bytes=cap, precision=int8,
                            granularity=granularity)
    eng = BatchedEngine(cfg, params, max_batch=MIX_BATCH,
                        controller_factory=controller_factory,
                        policy=policy, packed=True, precision=int8,
                        chunk=0, clock=clock, temperature=0.0,
                        max_len=MAX_LEN, seed=SEED, residency=rs,
                        prefetch=prefetch, double_buffer=True,
                        device=DEVICE)
    return eng, rs


def _grant_schedule(results) -> tuple:
    return tuple(tuple(it.k_granted for it in r.telemetry.iterations)
                 for r in results)


def phase_mixtral_offload(cfg, params) -> dict:
    """A host tier of experts on the whole Mixtral-8x7B with int8 experts:
    BatchedEngine(max_batch=4, packed, chunk=0, greedy, Cascade) on
    `_engine_workload`'s four 256-token prompts, OFFLOAD_NEW new tokens
    each. On the model clock under the joint planner: (a) flat, (b)
    whole-expert residency with speculation-guided prefetch, (c) the same
    without prefetch, (d) per-layer residency with prefetch,
    double-buffered; (f) is (d) under policy "independent", where
    Cascade's asks pass ungated, so drafted spans nominate experts (the
    joint planner's `FetchDeadlineConstraint` denies every draft under
    this tier). Then on the wall clock (e): (a) once, and (d) against a
    flat engine replaying (d)'s grants in turns tiered, replay, replay,
    tiered. The tier is priced, not enacted: every expert stays on the
    card, so the fetch terms are the cost model's prices of a 64 GB/s host
    link, and the one figure the card measures is the wall cost of the
    prefetch stage (probes and bookkeeping): (e)'s tiered turns against
    its replays, which verify the same spans pass for pass.

    The tier never touches weights or tokens, but it changes the grants,
    and in bf16 a token's logits depend on the shape of the pass that
    computes them, so a tiered run's greedy stream is not (a)'s (the first
    differing token of each request is reported). What the tier must not
    change is checked exactly: each distinct grant schedule of the tiered
    runs is replayed through a flat engine (`_GrantReplay`, policy
    "independent"), and every tiered stream must equal its replay's. Fails
    unless they do, a tiered run drafted and was granted tokens (so a
    replay covers K > 0), (b)-(d) fetched and evicted, and each
    residency's snapshot counts the bytes its telemetry does."""
    prompts, params = _engine_workload(cfg, params, MIX_BATCH,
                                       MIX_PROMPT_LEN)
    int8 = cm.Precision.int8_experts()
    unit = expert_hbm_bytes(cfg, precision=int8)
    placement = cm.ExpertPlacement.contiguous(cfg.num_experts, 1).offload(
        OFFLOAD_HOST)
    cap = (cfg.num_experts - len(OFFLOAD_HOST) + OFFLOAD_SLOTS) * unit
    runs = (("a_flat", "model", None, True, "joint"),
            ("b_whole_prefetch", "model", "expert", True, "joint"),
            ("c_whole_no_prefetch", "model", "expert", False, "joint"),
            ("d_layer_prefetch", "model", "layer", True, "joint"),
            ("f_layer_prefetch_independent", "model", "layer", True,
             "independent"),
            ("e_flat_wall", "wall", None, True, "joint"),
            ("e_layer_prefetch_wall_1", "wall", "layer", True, "joint"))
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    report, streams, schedules, passes = {}, {}, {}, 0

    def record(name, eng, rs, results, wall):
        nonlocal passes
        streams[name] = [r.tokens for r in results]
        steps, tel = eng.telemetry.steps, eng.telemetry
        its = [it for r in results for it in r.telemetry.iterations]
        passes += len(steps) + len(prompts)         # + blocking prefills
        rep = dict(
            clock=eng.clock, granularity=getattr(rs, "granularity", None),
            prefetch=eng.prefetch, policy=eng.planner.config.policy,
            passes=len(steps),
            tokens_per_pass=sum(it.tokens_emitted for it in its)
            / len(steps),
            k_granted=sum(it.k_granted for it in its),
            k_drafted=sum(it.k_drafted for it in its),
            mean_k_granted=sum(it.k_granted for it in its) / len(its),
            mean_k_drafted=sum(it.k_drafted for it in its) / len(its),
            prefetch_hit_rate=tel.prefetch_hit_rate,
            prefetch_hits=sum(s.prefetch_hits for s in steps),
            prefetch_misses=sum(s.prefetch_misses for s in steps),
            fetch_bytes=tel.fetch_bytes, evictions=tel.evictions,
            mean_t_fetch_s=sum(s.t_fetch for s in steps) / len(steps),
            tpot_s=float(np.mean([r.telemetry.experienced_tpot
                                  for r in results])),
            attributed_tpot_s=float(np.mean([r.telemetry.tpot
                                             for r in results])),
            engine_clock_s=eng.now, wall_s=wall,
            wall_s_per_pass=wall / len(steps),
            verify_s_per_pass=float(np.mean([s.t_step for s in steps]))
            if eng.clock == "wall" else None)
        if rs is not None:
            schedules.setdefault(_grant_schedule(results),
                                 (results, []))[1].append(name)
            snap = rs.snapshot()
            rep["snapshot"] = snap
            if snap["bytes_fetched"] != tel.fetch_bytes:
                raise AssertionError(
                    f"{name}: the residency fetched "
                    f"{snap['bytes_fetched']} bytes, its telemetry "
                    f"counts {tel.fetch_bytes}")
        report[name] = rep

    def replay(name, results, clock):
        eng, _ = _tiered_engine(cfg, params, placement, cap, clock=clock,
                                policy="independent",
                                controller_factory=_replay_factory(results))
        replayed, wall = _serve_batched(eng, prompts, OFFLOAD_NEW)
        record(name, eng, None, replayed, wall)
        return [r.tokens for r in replayed]

    with _no_plain_versions() as plain_calls:
        for name, clock, granularity, prefetch, policy in runs:
            eng, rs = _tiered_engine(cfg, params, placement, cap,
                                     clock=clock, granularity=granularity,
                                     prefetch=prefetch, policy=policy)
            results, wall = _serve_batched(eng, prompts, OFFLOAD_NEW)
            record(name, eng, rs, results, wall)
            if name == "e_layer_prefetch_wall_1":
                turn1 = results
        # the prefetch stage's wall cost: the tiered wall run against a
        # flat replay of its grants (the same spans), in turns A B B A
        wall_replays = [replay(f"e_replay_wall_{i}", turn1, "wall")
                        for i in (1, 2)]
        eng, rs = _tiered_engine(cfg, params, placement, cap, clock="wall",
                                 granularity="layer")
        turn2, wall = _serve_batched(eng, prompts, OFFLOAD_NEW)
        record("e_layer_prefetch_wall_2", eng, rs, turn2, wall)
        replays = []
        for results, names in schedules.values():
            tokens = replay("_replay", results, "model")
            rep = report.pop("_replay")
            del streams["_replay"]
            replays.append(dict(
                runs=names, passes=rep["passes"],
                k_granted=rep["k_granted"],
                mean_k_granted=rep["mean_k_granted"],
                first_difference=_first_difference(tokens,
                                                   streams[names[0]])))
            failed = [n for n in names if streams[n] != tokens]
            if failed:
                replays[-1]["failed"] = failed
        for i, tokens in enumerate(wall_replays, 1):
            if tokens != streams["e_layer_prefetch_wall_1"]:
                replays.append(dict(runs=[f"e_replay_wall_{i}"],
                                    failed=["e_layer_prefetch_wall_1"]))
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name in streams:
        report[name]["first_difference_from_a"] = _first_difference(
            streams[name], streams["a_flat"])
    tiered = [report[f"e_layer_prefetch_wall_{i}"]["wall_s_per_pass"]
              for i in (1, 2)]
    flat = [report[f"e_replay_wall_{i}"]["wall_s_per_pass"]
            for i in (1, 2)]
    stage = dict(
        turns="tiered, replay, replay, tiered",
        tiered_wall_s_per_pass=tiered, replay_wall_s_per_pass=flat,
        tiered_verify_s_per_pass=[
            report[f"e_layer_prefetch_wall_{i}"]["verify_s_per_pass"]
            for i in (1, 2)],
        replay_verify_s_per_pass=[
            report[f"e_replay_wall_{i}"]["verify_s_per_pass"]
            for i in (1, 2)],
        same_grants=_grant_schedule(turn1) == _grant_schedule(turn2),
        host_cost_s_per_pass=float(np.mean(tiered) - np.mean(flat)),
        spread_s=[min(tiered) - max(flat), max(tiered) - min(flat)])
    emit("mixtral-offload", arch=cfg.name, experts="int8", packed=True,
         max_batch=MIX_BATCH, prompt_len=MIX_PROMPT_LEN,
         max_new=OFFLOAD_NEW, temperature=0.0,
         host_experts=list(OFFLOAD_HOST), cap_bytes=cap, expert_bytes=unit,
         layer_slice_bytes=expert_hbm_bytes(cfg, precision=int8,
                                            per_layer=True),
         host_bw=cm.H100_SXM.host_bw, runs=report, flat_replays=replays,
         prefetch_stage=stage, passes=passes, launches=launches,
         routes=K.route_counts(), plain_calls=plain_calls,
         peak_memory_bytes=peak, seconds=time.perf_counter() - t0)
    _check_routes("mixtral-offload", {"flash_attention": "wgmma",
                                      "decode_attention": "mma",
                                      "moe_gmm_fused_quant": "wgmma"})
    if any(plain_calls.values()):
        raise AssertionError(f"plain versions ran on the card: "
                             f"{plain_calls}")
    if launches["moe_gmm_fused_quant"] != cfg.num_layers * passes:
        raise AssertionError(
            f"K4 launched {launches['moe_gmm_fused_quant']} times over "
            f"{passes} passes of {cfg.num_layers} layers")
    bad = [r for r in replays if "failed" in r]
    if bad or len(replays) < 1:
        raise AssertionError(f"a tiered run's greedy streams differ from a "
                             f"flat engine's over the same spans: {bad}")
    drafted = [n for n, r in report.items()
               if r["granularity"] is not None and r["k_drafted"] > 0
               and r["k_granted"] > 0]
    if not drafted or not any(r.get("k_granted", 0) > 0 for r in replays):
        raise AssertionError("no tiered run drafted and was granted a "
                             "token, so no replay covered K > 0")
    for name in ("b_whole_prefetch", "c_whole_no_prefetch",
                 "d_layer_prefetch"):
        if not (report[name]["fetch_bytes"] > 0
                and report[name]["evictions"] > 0):
            raise AssertionError(f"{name}: no fetch or no eviction "
                                 f"{report[name]}")
    if peak >= 80e9:
        raise AssertionError("peak memory over 80 GB")
    return launches


def _load_trace(vocab, rate: float, ttft=None) -> list:
    """The open-loop trace: `build_trace` of one LoadSpec (the "all-3" task
    mix, lognormal prompts of median 128 tokens in [32, 512] and outputs of
    median 24 in [8, 64], half the requests on the latency tier with TTFT
    bound `ttft`), its token ids (0..31) mapped onto the PERIOD tokens the
    restricted unembedding keeps, so greedy tokens recur in the prompt and
    the n-gram drafter proposes. The rate scales the arrival gaps only: the
    requests are the same at every rate."""
    trace = build_trace(LoadSpec(
        n_requests=LOAD_REQUESTS, arrival="poisson", rate=rate, mix="all-3",
        prompt_median=128, prompt_lo=32, prompt_hi=512, out_median=24,
        out_lo=8, out_hi=64, latency_frac=0.5, latency_ttft=ttft, seed=SEED,
        vocab=PERIOD))
    for _, req in trace:
        req.prompt = [int(vocab[t]) for t in req.prompt]
    return trace


def _load_replay(cfg, params, trace, *, closed=False, admission=None,
                 planner=None, recorder=None) -> tuple:
    """One replay of `trace` through a ContinuousBatchingScheduler over a
    fresh BatchedEngine (4 rows, packed int8 experts, chunk=64, wall
    clock, greedy, the joint planner or the given one), under Cascade:
    closed loop (`run`, every request submitted at time 0) or open loop
    (`run_trace` on the engine clock), inside `recorder` if one is given.
    Checks every served stream and that each request was served or shed.
    Returns (scheduler, record)."""
    eng = BatchedEngine(cfg, params, max_batch=MIX_BATCH,
                        controller_factory=CascadeController, policy="joint",
                        planner=planner, packed=True,
                        precision=cm.Precision.int8_experts(),
                        chunk=MIX_CHUNK, clock="wall", temperature=0.0,
                        max_len=MAX_LEN, seed=SEED, device=DEVICE)
    sched = ContinuousBatchingScheduler(
        eng, controller_factory=CascadeController, admission=admission)
    if recorder is not None:
        recorder.eng = eng
    t0 = time.perf_counter()
    with recorder or contextlib.nullcontext():
        if closed:
            sched.run([req for _, req in trace])
        else:
            sched.run_trace(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    max_new = {req.request_id: req.max_new for _, req in trace}
    for r in sched.results:
        if not r.tokens or len(r.tokens) > max_new[r.telemetry.request_id] \
                or not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"bad output {r.telemetry.request_id}: "
                                 f"{r.tokens}")
    if len(sched.results) + len(sched.shed_results) != len(trace):
        raise AssertionError(f"{len(sched.results)} served + "
                             f"{len(sched.shed_results)} shed of "
                             f"{len(trace)} requests")
    rep = summarize(sched, None if closed else trace)
    del rep["timeline"]
    its = [it for r in sched.results for it in r.telemetry.iterations]
    rep.update(
        plan_time_error=sched.planner_stats()["plan_time_error"],
        passes=len(eng.telemetry.steps), engine_clock_s=eng.now,
        wall_s=wall, mean_request_utility=sched.mean_request_utility(),
        mean_utility=sum(it.utility for it in its) / max(len(its), 1),
        mean_k_drafted=sum(it.k_drafted for it in its) / max(len(its), 1),
        mean_k_granted=sum(it.k_granted for it in its) / max(len(its), 1),
        accepted=sum(it.tokens_emitted - 1 for it in its))
    return sched, rep


def phase_mixtral_load(cfg, params) -> dict:
    """Open-loop serving on the whole Mixtral-8x7B with int8 experts: one
    Poisson trace of LOAD_REQUESTS requests replayed three times through
    ContinuousBatchingScheduler on the wall clock, (a) closed loop, which
    measures the service rate and fits a `Calibration` on its passes'
    (predicted, measured) times; (b) open loop at a multiple of that rate
    under PredictiveTTFTAdmission(on_doomed="shed") with the latency
    tier's TTFT bound at (a)'s median TTFT; (c) the same with the planner
    calibrated. Chunked admission runs every prefill chunk in the shared
    pass (K2 and K4; K3, the blocking prefill's kernel, stays at 0).
    Returns the layer-0 inputs of K2 and K4 in (a)'s first pass where a
    full prefill chunk sits beside a decode row, for the kernel phase."""
    _, vocab = _kept_vocab(cfg)
    params = _restrict_unembed(cfg, params, vocab)
    int8 = cm.Precision.int8_experts()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    passes, report = 0, {}
    mixed = _MixedPassRecorder()
    with _no_plain_versions() as plain_calls:
        closed, report["a_closed"] = _load_replay(
            cfg, params, _load_trace(vocab, 1.0), closed=True,
            recorder=mixed)
        passes += report["a_closed"]["passes"]
        service_rate = len(closed.results) / closed.engine.now
        ttft = report["a_closed"]["p50_ttft"]
        steps = [s for s in closed.engine.telemetry.steps
                 if s.t_step > 0 and s.t_step_predicted]
        cal = cm.Calibration.fit([s.t_step_predicted for s in steps],
                                 [s.t_step for s in steps],
                                 [s.t_a2a for s in steps])
        for multiple in LOAD_RATE_MULTIPLES:
            trace = _load_trace(vocab, multiple * service_rate, ttft)
            _, rep_b = _load_replay(
                cfg, params, trace,
                admission=PredictiveTTFTAdmission(on_doomed="shed"))
            passes += rep_b["passes"]
            report[f"b_open_{multiple:g}x"] = rep_b
            if rep_b["n_shed"]:
                break
        planner = BatchSpecPlanner(
            cfg, cm.H100_SXM, config=PlannerConfig(
                policy="joint", util_floor=cal.adapted_util_floor(1.0)),
            calibration=cal, precision=int8)
        _, rep_c = _load_replay(
            cfg, params, trace, planner=planner,
            admission=PredictiveTTFTAdmission(on_doomed="shed"))
        passes += rep_c["passes"]
        report["c_open_calibrated"] = rep_c
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    emit("mixtral-load", arch=cfg.name, experts="int8", packed=True,
         max_batch=MIX_BATCH, chunk=MIX_CHUNK, clock="wall",
         temperature=0.0, requests=LOAD_REQUESTS,
         service_rate_per_s=service_rate, rate_multiple=multiple,
         rate_per_s=multiple * service_rate, latency_ttft_s=ttft,
         calibration=dataclasses.asdict(cal),
         adapted_util_floor=cal.adapted_util_floor(1.0),
         steps_fitted=len(steps), replays=report, passes=passes,
         mixed_pass_tokens_per_row=mixed.tokens_per_row,
         launches=launches, routes=K.route_counts(),
         plain_calls=plain_calls, peak_memory_bytes=peak,
         seconds=time.perf_counter() - t0)
    _check_routes("mixtral-load", {"decode_attention": "mma",
                                   "moe_gmm_fused_quant": "wgmma"})
    if any(plain_calls.values()):
        raise AssertionError(f"plain versions ran on the card: "
                             f"{plain_calls}")
    if launches["flash_attention"]:
        raise AssertionError("chunked admission ran a blocking prefill "
                             f"({launches['flash_attention']} K3 launches)")
    if launches["moe_gmm_fused_quant"] != cfg.num_layers * passes:
        raise AssertionError(
            f"K4 launched {launches['moe_gmm_fused_quant']} times over "
            f"{passes} passes of {cfg.num_layers} layers")
    if not rep_b["n_shed"]:
        raise AssertionError(f"open loop shed nothing at up to {multiple}x "
                             "the service rate")
    if not rep_c["plan_time_error"] < rep_b["plan_time_error"]:
        raise AssertionError(
            f"calibration did not lower plan_time_error: "
            f"{rep_c['plan_time_error']} vs {rep_b['plan_time_error']}")
    if not mixed.inputs:
        raise AssertionError("no pass of the closed loop held a full "
                             "prefill chunk beside a decode row")
    if peak >= 80e9:
        raise AssertionError("peak memory over 80 GB")
    return mixed.inputs


def phase_serve_launcher() -> None:
    """`python -m repro_torch.launch.serve --arch mixtral-8x7b --requests 3
    --max-new 16`, called as a user would, without --device: the reduced
    Mixtral (float32) on the card through the single-request Scheduler and
    ServingEngine on the model clock (K1-K3 on their CUDA-core routes)."""
    from repro_torch.launch import serve

    argv = ["--arch", MIXTRAL, "--requests", "3", "--max-new", "16"]
    K.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with _no_plain_versions() as plain_calls, \
            contextlib.redirect_stdout(buf):
        rc = serve.main(argv)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    out = buf.getvalue().splitlines()
    # each request's decode tokens: the first token comes from the prefill
    emitted = [int(line.split("out=")[1].split()[0]) for line in out
               if "out=" in line]
    emit("serve-launcher", argv=argv, rc=rc, output=out, emitted=emitted,
         launches=launches, routes=K.route_counts(), plain_calls=plain_calls,
         seconds=time.perf_counter() - t0)
    if rc != 0 or "h100-sxm" not in out[0]:
        raise AssertionError(f"serve launcher: rc {rc}, output {out}")
    if emitted != [16 - 1] * 3:
        raise AssertionError(f"serve launcher emitted {emitted}")
    _check_routes("serve-launcher", F32_SERVING)
    if any(plain_calls.values()):
        raise AssertionError(f"plain versions ran on the card: "
                             f"{plain_calls}")


#: the Mixtral path's learned drafter: 4 prompts x 32 new tokens, and the
#: ring of each row's drafter (prompt + new tokens + the widest span)
MIX_DRAFT_NEW = 32
MIX_DRAFT_MAX_LEN = 512


def _mixtral_drafter_cfg(cfg):
    """The drafter of the paper's Mixtral case study in shape: one dense
    decoder layer at Mixtral's widths and vocabulary (d=4096, GQA 32/8,
    d_ff 14336, vocab 32000), 0.48 B parameters, 0.96 GB in bf16."""
    return dataclasses.replace(cfg, name=f"{cfg.name}-drafter-1l",
                               family="dense", num_layers=1, num_experts=0,
                               experts_per_token=0, moe_d_ff=0)


def _draft_by_k(results, hw, active_params) -> dict:
    """Per drafted K: the iterations, their mean wall drafting seconds
    (the drafter's feed of the committed tokens and its K one-token
    passes) and `cm.draft_time` for the same K."""
    by_k: dict = {}
    for r in results:
        for it in r.telemetry.iterations:
            by_k.setdefault(it.k_drafted, []).append(it.t_draft)
    return {k: {"iterations": len(v), "wall_s_mean": float(np.mean(v)),
                "model_s": cm.draft_time(hw, k, active_params)}
            for k, v in sorted(by_k.items())}


def phase_mixtral_drafter(cfg, params) -> dict:
    """The int8 Mixtral served by BatchedEngine(max_batch=4, packed) with a
    `DraftModelDrafter` per row (the one-layer bf16 drafter of
    `_mixtral_drafter_cfg`, random weights from the seed, its unembedding
    restricted to the target's 32 kept tokens so that its greedy drafts are
    tokens the target emits), 4 prompts x 32 new tokens under static K=4
    and Cascade on the wall clock: the drafter's wall seconds per step and
    per K against `cm.draft_time`, the share of the run spent drafting,
    Cascade's mean K, peak memory. First the drafter's decode_step through
    the kernels against the same with the plain versions bound (the same
    drafts, the feed's logits within 1e-2 * max|logit|), and K2 (at the
    256-token feed and at T=1) and K3 (the drafter's prefill) against
    their plain versions on its layer-0 inputs."""
    t_phase = time.perf_counter()
    dcfg = _mixtral_drafter_cfg(cfg)
    dev = torch.device(DEVICE)
    prompts, tparams = _engine_workload(cfg, params, MIX_BATCH,
                                        MIX_PROMPT_LEN)
    _, vocab = _kept_vocab(cfg)
    dparams = _restrict_unembed(dcfg, T.init_params(
        dcfg, torch.Generator(device=DEVICE).manual_seed(SEED + 5),
        device=DEVICE), vocab)
    torch.cuda.synchronize()
    d_bytes = sum(t.numel() * t.element_size() for t in _leaves(dparams))

    def draft_model():
        return DraftModelDrafter(dcfg, dparams, max_len=MIX_DRAFT_MAX_LEN,
                                 temperature=0.0, device=DEVICE)

    # the drafter's passes through the kernels and through the plain
    # versions; K2's layer-0 inputs by span length, K3's at a prefill
    with _Recorder(T, "decode_attention", copy=(1, 2),
                   key=lambda a, kw: a[0].shape[1]) as rec_b:
        on = draft_model()
        drafts_on, _ = on.propose(prompts[0], 4)
    with _patched(*_plain_bindings(("decode_attention", "flash_attention"))):
        off = draft_model()
        drafts_off, _ = off.propose(prompts[0], 4)
    lo_on, lo_off = (torch.from_numpy(d._last_logits) for d in (on, off))
    scale = float(lo_off.abs().max())
    logit_err = float((lo_on - lo_off).abs().max())
    del on, off
    with _Recorder(T, "flash_attention") as rec_a:
        T.prefill(dcfg, dparams, torch.tensor([prompts[0]], dtype=torch.int32,
                                              device=dev),
                  T.init_cache(dcfg, 1, MIX_DRAFT_MAX_LEN, device=dev))
    inputs = {f"decode_attention/feed{MIX_PROMPT_LEN}":
              rec_b.calls[MIX_PROMPT_LEN],
              "decode_attention/t1": rec_b.calls[1],
              "flash_attention/prefill": rec_a.args}
    cases = {}
    for key, (args, kw) in inputs.items():
        run = case_flash if key.startswith("flash") else case_decode
        cases[key] = run(args, kw)
        emit(f"mixtral-drafter-kernel:{key}", **cases[key])
    del inputs, rec_a, rec_b

    int8 = cm.Precision.int8_experts()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    report, passes = {}, 0
    with _no_plain_versions() as plain_calls:
        for name, factory, policy in (
                ("static-k4-independent", lambda: StaticKController(4),
                 "independent"),
                ("cascade-joint", CascadeController, "joint")):
            eng = BatchedEngine(cfg, tparams, max_batch=MIX_BATCH,
                                drafter_factory=draft_model,
                                controller_factory=factory, policy=policy,
                                packed=True, precision=int8, clock="wall",
                                temperature=0.0, max_len=MAX_LEN, seed=SEED,
                                device=DEVICE)
            results, wall = _serve_batched(eng, prompts, MIX_DRAFT_NEW)
            for r in results:
                if len(r.tokens) != MIX_DRAFT_NEW or not all(
                        0 <= t < cfg.vocab_size for t in r.tokens):
                    raise AssertionError(f"{name}: bad output {r.tokens}")
            steps = eng.telemetry.steps
            passes += len(steps) + len(prompts)
            its = [it for r in results for it in r.telemetry.iterations]
            draft_s = sum(it.t_draft for it in its)
            drafted = sum(it.k_drafted for it in its)
            report[name] = dict(
                steps=len(steps), wall_s=wall,
                decode_tokens_per_s=sum(it.tokens_emitted for it in its)
                / wall,
                drafted=drafted,
                accepted=sum(it.tokens_emitted - 1 for it in its),
                mean_k=drafted / len(its),
                draft_wall_s=draft_s, draft_share_of_wall=draft_s / wall,
                draft_wall_s_per_step=draft_s / len(steps),
                draft_wall_s_per_drafted_token=draft_s / drafted
                if drafted else None,
                draft_by_k=_draft_by_k(results, eng.hw,
                                       dcfg.active_param_count()),
                pass_wall_s=wall / len(steps))
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    emit("mixtral-drafter", arch=cfg.name, experts="int8", packed=True,
         drafter=dcfg.name, drafter_params=dcfg.param_count(),
         drafter_bytes=d_bytes, max_batch=MIX_BATCH,
         prompt_len=MIX_PROMPT_LEN, max_new=MIX_DRAFT_NEW, clock="wall",
         temperature=0.0, drafts_kernels=drafts_on, drafts_plain=drafts_off,
         feed_logits_max_abs_err=logit_err, feed_logits_max_abs=scale,
         cost_model_draft_s_per_token=cm.draft_time(
             cm.H100_SXM, 1, dcfg.active_param_count()),
         policies=report, launches=launches, routes=K.route_counts(),
         passes=passes, plain_calls=plain_calls, peak_memory_bytes=peak,
         seconds=time.perf_counter() - t_phase)
    _check_routes("mixtral-drafter", {"flash_attention": "wgmma",
                                      "decode_attention": "mma",
                                      "moe_gmm_fused_quant": "wgmma"})
    if drafts_on != drafts_off or logit_err > 1e-2 * scale:
        raise AssertionError(f"mixtral-drafter: the drafter's pass differs "
                             f"through the kernels: drafts {drafts_on} / "
                             f"{drafts_off}, logits by {logit_err} of "
                             f"{scale}")
    if any(plain_calls.values()):
        raise AssertionError(f"plain versions ran on the card: "
                             f"{plain_calls}")
    if launches["moe_gmm_fused_quant"] != cfg.num_layers * passes:
        raise AssertionError(
            f"K4 launched {launches['moe_gmm_fused_quant']} times over "
            f"{passes} passes of {cfg.num_layers} layers")
    idle = [n for n, r in report.items() if r["drafted"] == 0]
    if idle:
        raise AssertionError(f"mixtral-drafter: no drafts: {idle}")
    if peak >= 80e9:
        raise AssertionError("peak memory over 80 GB")
    return cases


def phase_mixtral_profile(cfg, params, steps: int = 5) -> None:
    """Where a B=4 [1+4] packed verification pass of the Mixtral path goes:
    device time by kernel (torch.profiler) and the device's idle share of
    the wall time."""
    rng = np.random.default_rng(SEED + 4)
    dev = torch.device(DEVICE)
    batch = T.init_cache(cfg, MIX_BATCH, MAX_LEN, device=dev, per_row=True)
    row = T.init_cache(cfg, 1, MAX_LEN, device=dev)
    prompt = torch.tensor([_copy_prompt(rng, MIX_PROMPT_LEN,
                                        cfg.vocab_size)],
                          dtype=torch.int32, device=dev)
    _, row, _ = T.prefill(cfg, params, prompt, row)
    for slot in range(MIX_BATCH):
        batch = T.write_cache_row(batch, slot, row)
    span = torch.tensor(rng.integers(3, cfg.vocab_size, (MIX_BATCH, SPAN)),
                        dtype=torch.int32, device=dev)
    mask = torch.ones_like(span, dtype=torch.bool)

    def step():
        lo, _, aux, _ = T.decode_step(cfg, params, batch, span,
                                      token_mask=mask, moe_packed=True)
        return lo.float().cpu(), aux["unique_experts"].cpu()

    _profile("mixtral-profile", step, steps, span=f"{MIX_BATCH}x{SPAN}")


# --------------------------------------------------------------------- #
# The training path: OLMoE-1B-7B through make_train_step (K5, K3 + lse)
# --------------------------------------------------------------------- #

def _activation_bytes(cfg, n_tokens: int) -> int:
    """A reckoning of what the training pass keeps for its backward, bf16
    unless noted. Per layer: ~13 residual-width [T,d] tensors (norm inputs
    and outputs, q/k/v and their rotated copies, the attention output, the
    projections), 4 float32 [T,d] norm intermediates, 3 dispatch-sized
    [E,C,d] buffers (dispatch, expert output, padded output), 4 [E,C,F]
    expert intermediates (gate, up, silu, h) and 2 [T*k,d] combine
    tensors; then the logits in bf16 and two float32 copies."""
    el, d, f = 2, cfg.d_model, cfg.moe_d_ff
    e, k = cfg.num_experts, cfg.experts_per_token
    c = moe_mod._capacity(cfg, n_tokens, "train")
    per_layer = (13 * n_tokens * d * el + 4 * n_tokens * d * 4
                 + 3 * e * c * d * el + 4 * e * c * f * el
                 + 2 * n_tokens * k * d * el)
    return cfg.num_layers * per_layer + n_tokens * cfg.vocab_size * (el + 8)


def phase_train_params(cfg) -> tuple:
    """The whole OLMoE-1B-7B in bf16 on the card with Adafactor's state,
    and the expected peak memory reckoned before the first step. (AdamW's
    float32 moments alone would be 55.4 GB: with 13.8 GB of parameters and
    13.8 GB of gradients they do not fit an 80 GB card.)"""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    opt = make_optimizer("adafactor", TRAIN_LR)
    init_state, _ = make_train_step(cfg, optimizer=opt)
    params, opt_state = init_state(
        torch.Generator(device=DEVICE).manual_seed(SEED), device=DEVICE)
    torch.cuda.synchronize()
    leaves = list(_leaves(params))
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(opt_state.inner))
    # the update's float32 gradient copy and its denominator (or g*g)
    temp_bytes = 2 * 4 * max(t.numel() for t in leaves)
    act_bytes = _activation_bytes(cfg, TRAIN_BATCH * TRAIN_SEQ)
    expected = 2 * param_bytes + state_bytes + temp_bytes + act_bytes
    emit("train-params", arch=cfg.name, params=cfg.param_count(),
         dtype=cfg.dtype, optimizer="adafactor", lr=TRAIN_LR,
         param_bytes=param_bytes, grad_bytes=param_bytes,
         optimizer_state_bytes=state_bytes,
         largest_leaf_update_temp_bytes=temp_bytes,
         activation_bytes_reckoned=act_bytes,
         expected_peak_bytes=expected,
         expected_peak_note="the sum of the parts: an upper reckoning, "
                            "since activations are freed before the update",
         seconds=time.perf_counter() - t0,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    if expected >= 80e9:
        raise AssertionError(f"reckoned peak {expected / 1e9:.1f} GB does "
                             "not fit the card")
    return params, opt_state, opt


def _train_batch(cfg) -> dict:
    return next(batch_iterator("all-3", TRAIN_BATCH, TRAIN_SEQ,
                               vocab=cfg.vocab_size, seed=SEED))


def phase_train_step(cfg, params, opt_state, opt) -> tuple:
    """TRAIN_STEPS Adafactor steps on one fixed batch: the loss must be
    finite and fall; K5 and K3 must carry every expert product and
    attention, with no plain version called. Records the first K5 call of
    each orientation and width, and the first K3 call with lse."""
    batch = _train_batch(cfg)
    _, step = make_train_step(cfg, optimizer=opt)
    state = (params, opt_state)
    steps = []
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    with _no_plain_versions() as plain_calls, \
            _Recorder(moe_ops, "moe_gmm", key=lambda a, kw: (
                kw.get("transpose_w", False), a[0].shape[2])) as rec5, \
            _Recorder(flash_ops, "flash_attention",
                      key=lambda a, kw: kw.get("lse", False)) as rec3:
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            steps.append(dict({k: float(v) for k, v in m.items()},
                              seconds=time.perf_counter() - t0))
    launches = K.launch_counts()
    losses = [s["loss"] for s in steps]
    emit("train-step", arch=cfg.name, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         tokens_per_step=TRAIN_BATCH * TRAIN_SEQ, optimizer="adafactor",
         lr=TRAIN_LR, steps=steps, launches=launches,
         routes=K.route_counts(), plain_calls=plain_calls,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    _check_routes("train-step", {"flash_attention": "wgmma",
                                 "moe_gmm": "wgmma"})
    if not all(np.isfinite(v) for s in steps for k, v in s.items()):
        raise AssertionError(f"non-finite training metrics: {steps}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall on a repeated batch: "
                             f"{losses}")
    if any(plain_calls.values()):
        raise AssertionError(f"plain versions ran on the card: "
                             f"{plain_calls}")
    n = cfg.num_layers * TRAIN_STEPS
    if launches["moe_gmm"] != 6 * n or launches["flash_attention"] != n:
        raise AssertionError(f"K5 launched {launches['moe_gmm']} times "
                             f"(expected {6 * n}), K3 "
                             f"{launches['flash_attention']} (expected {n})")
    if torch.cuda.max_memory_allocated() >= 80e9:
        raise AssertionError("peak memory over 80 GB")
    return state, batch, launches, rec5.calls, rec3.calls


def _err_line(name, got, ref, rtol: float = 1e-2,
              atol: float = 1e-6) -> dict:
    """max|err| <= rtol * max|ref| + atol; by default 1e-2 * max|ref| +
    1e-6: bf16 rounds at 2^-9 relative and sums run in another order, and
    every reference it holds (attention outputs, gradients of unit-scale
    output gradients) has max|ref| of order 1 or more (printed as
    ref_max_abs), so the floor is far below a typical value."""
    err = float((got.float() - ref.float()).abs().max())
    ref_max = float(ref.float().abs().max())
    lim = rtol * ref_max + atol
    if not err <= lim:
        raise AssertionError(f"{name}: max |err| {err} over the limit {lim}")
    return dict(max_abs_err=err, ref_max_abs=ref_max, limit=lim)


def _fwd_bwd_ms(fn, inputs, dout) -> float:
    """Milliseconds of one forward and backward of `fn` with output
    gradient `dout`, inputs requiring grad."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    return _time_ms(lambda: torch.autograd.grad(fn(*leaves), leaves, dout),
                    iters=10)


def _unit(x):
    """`x` times the power of two that puts max|x| in [1, 2): exact in
    bf16 and float32, so the product's errors scale with it exactly."""
    top = float(x.float().abs().max())
    return x * 2.0 ** -math.floor(math.log2(top)) if top > 0 else x


def case_gmm(args, kw) -> dict:
    x, w, counts = args
    t = kw.get("transpose_w", False)
    # the input gradients' x is the recorded dy of a 2048-token mean loss
    # (~1e-5): held at unit scale, so the 1e-6 floor bites in every case
    xs = _unit(x)
    out = K.moe_gmm(xs, w, counts, **kw)
    again = K.moe_gmm(xs, w, counts, **kw)
    torch.cuda.synchronize()
    check = _check_moe("moe_gmm", out, K.moe_gmm_plain(xs, w, counts, **kw),
                       atol=1e-6)
    e, c, d = x.shape
    f = w.shape[1] if t else w.shape[2]
    rows = int(counts.long().clamp(max=c).sum())
    live = int((counts > 0).sum())
    el = x.element_size()
    n_bytes = rows * d * el + live * d * f * el + e * c * f * el + 4 * e
    n_ops = 2.0 * rows * d * f
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    wl = w.transpose(1, 2) if t else w

    def run():
        return K.moe_gmm(x, w, counts, **kw)

    def library():
        return torch.bmm(x, wl)
    return dict(
        shape=f"x{list(x.shape)} w{list(w.shape)} transpose_w={t} live "
              f"experts {live} rows {rows} {x.dtype}",
        route=moe_ops.route(x.dtype, d, f), **check,
        repeat_bit_equal=_repeat_equal("moe_gmm", [out], [again]),
        ms=_time_ms(run), device_ms=_graph_ms(run),
        device_ms_cold=_graph_ms(run, cold=True), host_ms=_host_ms(run),
        plain_ms=_time_ms(lambda: K.moe_gmm_plain(x, w, counts, **kw),
                          iters=10),
        library_ms=_time_ms(library), library_device_ms=_graph_ms(library),
        library="torch.bmm over all [E,C,d] rows",
        bound_ms=bound_ms, bound_by=bound_by,
        bound_bytes_ms=1e3 * n_bytes / BYTES_PER_S,
        bound_ops_ms=1e3 * n_ops / BF16_OPS_PER_S)


def case_gmm_grads(args) -> dict:
    """MoeGmm's dx (K5 reading w transposed) and dw (torch.bmm) against
    autograd through the plain version, on the path's gate/up inputs and a
    seeded output gradient; times are one forward and backward."""
    x0, w0, counts = args
    e, c, d = x0.shape
    f = w0.shape[2]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    dy = torch.randn((e, c, f), generator=gen, device=DEVICE).to(x0.dtype)

    def grads(fn):
        x, w = (t.detach().clone().requires_grad_() for t in (x0, w0))
        fn(x, w).backward(dy)
        return x.grad, w.grad

    def kernel(x, w):
        return K.MoeGmm.apply(x, w, counts)

    def plain(x, w):
        return K.moe_gmm_plain(x, w, counts)

    got, ref = grads(kernel), grads(plain)
    torch.cuda.synchronize()
    dx, dw = (_err_line(f"MoeGmm {n}", g, r)
              for n, g, r in zip(("dx", "dw"), got, ref))
    rows = int(counts.long().clamp(max=c).sum())
    live = int((counts > 0).sum())
    el = x0.element_size()
    # forward, dx and dw: x, w, y, dy, dx and dw each moved once
    n_bytes = (2 * rows * d + 2 * live * d * f + 2 * e * c * f
               + e * c * d) * el
    bound_ms, bound_by = _bound(n_bytes, 3 * 2.0 * rows * d * f)
    return dict(
        shape=f"x{list(x0.shape)} w{list(w0.shape)} {x0.dtype}",
        dx=dx, dw=dw, max_abs_err=max(dx["max_abs_err"], dw["max_abs_err"]),
        ms=_fwd_bwd_ms(kernel, (x0, w0), dy),
        plain_ms=_fwd_bwd_ms(plain, (x0, w0), dy),
        library_ms=_fwd_bwd_ms(torch.bmm, (x0, w0), dy),
        library="torch.bmm forward and autograd backward",
        bound_ms=bound_ms, bound_by=bound_by)


def _attn_pairs(b, s, h, window) -> float:
    """(query head, key) pairs of causal attention over 0..S-1."""
    if window and window > 0:
        per = sum(min(i + 1, window) for i in range(s))
    else:
        per = s * (s + 1) / 2
    return float(b * h * per)


def case_flash_lse(args, kw) -> dict:
    q, k, v = args
    b, s, h, d = q.shape
    window = kw.get("window", 0)
    out, lse = K.flash_attention(q, k, v, window=window, lse=True)
    again = K.flash_attention(q, k, v, window=window, lse=True)
    torch.cuda.synchronize()
    ref_out, ref_lse = K.flash_attention_plain(q, k, v, window=window,
                                               lse=True)
    o_chk = _err_line("flash_attention out", out, ref_out)
    l_chk = _err_line("flash_attention lse", lse, ref_lse, rtol=0.0,
                      atol=1e-4)
    el = q.element_size()
    n_bytes = 2 * q.numel() * el + 2 * k.numel() * el + lse.numel() * 4
    bound_ms, bound_by = _bound(n_bytes, 4.0 * d * _attn_pairs(b, s, h,
                                                               window))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    gqa = {"enable_gqa": True} if kt.shape[1] != qt.shape[1] else {}

    def run():
        return K.flash_attention(q, k, v, window=window, lse=True)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              **gqa)
    return dict(
        shape=f"q{list(q.shape)} kv{list(k.shape)} window={window} "
              f"{q.dtype}", route=flash_ops.route(q.dtype), out=o_chk,
        lse=l_chk, max_abs_err=max(o_chk["max_abs_err"],
                                   l_chk["max_abs_err"]),
        repeat_bit_equal=_repeat_equal("flash_attention", (out, lse), again),
        ms=_time_ms(run), device_ms=_graph_ms(run),
        device_ms_cold=_graph_ms(run, cold=True), host_ms=_host_ms(run),
        plain_ms=_time_ms(lambda: K.flash_attention_plain(
            q, k, v, window=window, lse=True), iters=10),
        library_ms=_time_ms(library), library_device_ms=_graph_ms(library),
        library="scaled_dot_product_attention (no lse)",
        bound_ms=bound_ms, bound_by=bound_by)


def case_flash_grads(args, kw) -> dict:
    """FlashAttention's dq, dk, dv (from the kernel's out and lse) against
    autograd through the plain attention, on the path's layer-0 q, k, v
    and a seeded output gradient; times are one forward and backward."""
    q0, k0, v0 = args
    b, s, h, d = q0.shape
    window = kw.get("window", 0)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    do = torch.randn(q0.shape, generator=gen, device=DEVICE).to(q0.dtype)

    def kernel(q, k, v):
        return K.FlashAttention.apply(q, k, v, window)

    def plain(q, k, v):
        return K.flash_attention_plain(q, k, v, window=window)

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_() for t in (q0, k0, v0)]
        fn(*leaves).backward(do)
        return [t.grad for t in leaves]

    got, ref = grads(kernel), grads(plain)
    torch.cuda.synchronize()
    chk = {n: _err_line(f"FlashAttention {n}", g, r)
           for n, g, r in zip(("dq", "dk", "dv"), got, ref)}
    el = q0.element_size()
    # forward then backward: q, k, v, out, lse, dout in; dq, dk, dv out
    n_bytes = (4 * q0.numel() + 4 * k0.numel()) * el + b * h * s * 4 * 2
    bound_ms, bound_by = _bound(n_bytes, 14.0 * d * _attn_pairs(b, s, h,
                                                                window))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q0, k0, v0))
    gqa = {"enable_gqa": True} if kt.shape[1] != qt.shape[1] else {}
    return dict(
        shape=f"q{list(q0.shape)} kv{list(k0.shape)} window={window} "
              f"{q0.dtype}", **chk,
        max_abs_err=max(c["max_abs_err"] for c in chk.values()),
        ms=_fwd_bwd_ms(kernel, (q0, k0, v0), do),
        plain_ms=_fwd_bwd_ms(plain, (q0, k0, v0), do),
        library_ms=_fwd_bwd_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, **gqa), (qt, kt, vt),
            do.transpose(1, 2).contiguous()),
        library="scaled_dot_product_attention forward and backward",
        bound_ms=bound_ms, bound_by=bound_by)


def phase_train_kernels(cfg, calls5, calls3) -> dict:
    """K5 at each product of the step (first call of each orientation and
    width: layer 0's forward and the last layer's input gradients),
    MoeGmm's gradients, K3 with lse and FlashAttention's gradients, each
    against its plain version on the inputs the step gave it."""
    d, f = cfg.d_model, cfg.moe_d_ff
    # detached: the weights are views of parameters the steps updated since
    calls5 = {k: ([a.detach() for a in args], kw)
              for k, (args, kw) in calls5.items()}
    args3, kw3 = calls3[True]
    args3 = [a.detach() for a in args3]
    cases = {}
    for name, key in (("gate-up", (False, d)), ("down", (False, f)),
                      ("down-dx", (True, d)), ("gate-up-dx", (True, f))):
        cases[f"moe_gmm/{name}"] = case_gmm(*calls5[key])
    cases["moe_gmm/grads"] = case_gmm_grads(calls5[(False, d)][0])
    cases["flash_attention/lse"] = case_flash_lse(args3, kw3)
    cases["flash_attention/grads"] = case_flash_grads(args3, kw3)
    for key, rec in cases.items():
        emit(f"train-kernel:{key}", **rec)
    return cases


def _labelled(label, fn):
    """`fn` inside a torch.profiler record_function range named `label`."""
    def wrapped(*a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)
    return wrapped


@contextlib.contextmanager
def _patched(*swaps):
    """Set (module, name, value) attributes for the block, then restore."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, v in swaps:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def phase_train_profile(cfg, state, batch, opt, steps: int = 2) -> None:
    """Where a full-depth training step's device time goes: K5, the dw
    products (torch.bmm), K3, the attention backward's products, the
    clip and the optimizer, and the device's idle share."""
    labels = ("dw-bmm", "attention-backward", "clip", "optimizer")
    profiled = Optimizer(opt.init, _labelled("optimizer", opt.update))
    with _patched(
            (moe_ops, "grouped_weight_grad",
             _labelled("dw-bmm", moe_ops.grouped_weight_grad)),
            (flash_ops, "flash_attention_bwd",
             _labelled("attention-backward", flash_ops.flash_attention_bwd)),
            (train_mod, "clip_scale",
             _labelled("clip", train_mod.clip_scale)),
            (train_mod, "apply_updates",
             _labelled("optimizer", train_mod.apply_updates))):
        _, step = make_train_step(cfg, optimizer=profiled)
        box = [state]

        def run():
            box[0], m = step(box[0], batch)
            return float(m["loss"])

        by_name, by_label, busy = _profile(
            "train-profile", run, steps, labels=labels, arch=cfg.name,
            batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    # the kernels by name, whichever route ran
    ms = {label: sum(v for n, v in by_name.items()
                     if any(stem in n for stem in ROUTE_KERNELS[lib])) / steps
          for label, lib in (("K5 moe_gmm", "moe_gmm_grouped"),
                             ("K3 flash_attention", "flash_attention"))}
    ms.update({k: v / steps for k, v in by_label.items()})
    emit("train-profile-shares", device_busy_ms_per_step=busy,
         ms_per_step=ms,
         share_of_device_time={k: v / busy if busy else None
                               for k, v in ms.items()})


def _loss_and_grads(cfg, params, batch, dev) -> tuple:
    """loss, the gradient of every leaf and the routed experts of every
    layer, through the port's loss_fn and torch.autograd."""
    live = [t.detach().requires_grad_() for t in _leaves(params)]
    it = iter(live)
    tree = tree_map(lambda _: next(it), params)
    routes = []

    def route(*a, **kw):
        out = saved(*a, **kw)
        routes.append(out[1].cpu())
        return out

    saved = moe_mod.route
    with _patched((moe_mod, "route", route)):
        loss, _ = loss_fn(cfg, tree, {k: torch.as_tensor(v, device=dev)
                                      for k, v in batch.items()})
        grads = torch.autograd.grad(loss, live)
    return loss.item(), [g.cpu() for g in grads], routes


EP_TRAIN_STEPS = 3
EP_GRADS_BATCH = (4, 128)   # the float32 card-vs-CPU pass: 512 tokens


@contextlib.contextmanager
def _one_rank_group(backend: str):
    """A one-rank `backend` process group for the block (an in-process
    store: no network); its WORLD group is the dispatch's data group."""
    import torch.distributed as dist

    if backend == "nccl":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _routes_kept():
    """Every `moe_mod.route` call's expert ids [T, k], in call order (layer
    by layer), detached, on the routing's device."""
    route, kept = moe_mod.route, []

    def keep(*a, **kw):
        out = route(*a, **kw)
        kept.append(out[1].detach().clone())
        return out
    with _patched((moe_mod, "route", keep)):
        yield kept


def phase_ep_train(cfg, batch) -> dict:
    """EP_TRAIN_STEPS Adafactor steps of the whole OLMoE-1B-7B in bf16
    through the expert-parallel dispatch (`make_train_step(ep=)`) over a
    one-rank NCCL group (data 1, model 1), from `train-step`'s seeded
    params on its repeated batch: the loss must be finite and fall; layer
    0's routing on the first step must equal the plain forward's exactly
    (everything before it is the same computation); K5 must carry every
    expert product on the receive buffer [E, C_src, d] (forward and input
    gradient, 6 a layer a step), K3 every attention with lse, K1 never
    (it has no gradient), and no plain version may run. Reports the step
    seconds after the first and the peak memory beside `train-step`'s.
    Returns the first K5 call of each orientation and width, detached."""
    from repro_torch.distributed import make_expert_parallel_moe

    t_phase = time.perf_counter()
    e, k, d = cfg.num_experts, cfg.experts_per_token, cfg.d_model
    n_tok = TRAIN_BATCH * TRAIN_SEQ
    c_src = max(int(n_tok * k * 2.0) // e + 1, 1)
    with _one_rank_group("nccl") as group:
        ep = make_expert_parallel_moe(cfg, group)
        opt = make_optimizer("adafactor", TRAIN_LR)
        init_state, step = make_train_step(cfg, optimizer=opt, ep=ep)
        torch.cuda.reset_peak_memory_stats()
        state = init_state(torch.Generator(device=DEVICE).manual_seed(SEED),
                           device=DEVICE)
        with torch.no_grad(), _routes_kept() as plain_routes:
            T.train_forward(cfg, state[0], torch.as_tensor(
                batch["tokens"], device=DEVICE))
        steps = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        with _no_plain_versions() as plain_calls, \
                _routes_kept() as ep_routes, \
                _Recorder(moe_ops, "moe_gmm", key=lambda a, kw: (
                    kw.get("transpose_w", False), a[0].shape[2])) as rec5, \
                _Recorder(flash_ops, "flash_attention",
                          key=lambda a, kw: kw.get("lse", False)) as rec3:
            for _ in range(EP_TRAIN_STEPS):
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                steps.append(dict({n: float(v) for n, v in m.items()},
                                  seconds=time.perf_counter() - t0))
        launches = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        del state
    calls5 = {key: ([a.detach() for a in args], kw)
              for key, (args, kw) in rec5.calls.items()}
    recv_shape = list(calls5[(False, d)][0][0].shape)
    idx_equal = bool(torch.equal(ep_routes[0], plain_routes[0]))
    ts = RESULTS.get("train-step", {})
    losses = [s["loss"] for s in steps]
    n = cfg.num_layers * EP_TRAIN_STEPS
    emit("ep-train", arch=cfg.name, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         tokens_per_step=n_tok, dtype=cfg.dtype,
         group="nccl, 1 rank (data 1, model 1)", optimizer="adafactor",
         lr=TRAIN_LR, capacity_factor=2.0, c_src=c_src,
         receive_buffer=recv_shape, steps=steps,
         step_s_after_first=[s["seconds"] for s in steps[1:]],
         train_step_s_after_first=[s["seconds"]
                                   for s in ts.get("steps", [])[1:]],
         peak_memory_bytes=peak,
         train_step_peak_memory_bytes=ts.get("peak_memory_bytes"),
         layer0_expert_idx_equal_plain_forward=idx_equal,
         launches=launches, routes=K.route_counts(),
         k3_lse_keys=sorted(rec3.calls), plain_calls=plain_calls,
         seconds=time.perf_counter() - t_phase)
    _check_launches("ep-train", launches,
                    {"moe_gmm": 6 * n, "flash_attention": n})
    _check_routes("ep-train", {"flash_attention": "wgmma",
                               "moe_gmm": "wgmma"})
    if not all(np.isfinite(v) for s in steps for v in s.values()):
        raise AssertionError(f"ep-train: non-finite metrics: {steps}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"ep-train: the loss did not fall on a "
                             f"repeated batch: {losses}")
    if any(plain_calls.values()):
        raise AssertionError(f"ep-train: plain versions ran on the card: "
                             f"{plain_calls}")
    if list(rec3.calls) != [True]:
        raise AssertionError(f"ep-train: K3 calls without lse: "
                             f"{list(rec3.calls)}")
    if recv_shape != [e, c_src, d]:
        raise AssertionError(f"ep-train: K5's input {recv_shape} is not the "
                             f"receive buffer {[e, c_src, d]}")
    if not idx_equal:
        raise AssertionError("ep-train: layer 0's routing differs from the "
                             "plain forward's")
    if peak >= 80e9:
        raise AssertionError("ep-train: peak memory over 80 GB")
    return calls5


def phase_ep_train_grads(calls5) -> None:
    """The loss and every gradient of a 2-layer float32 OLMoE at full width
    through the dispatch (`training.value_and_grad(ep=)`) on the card over
    a one-rank NCCL group against the same weights and batch on the CPU
    over a one-rank gloo group (plain versions), within `train-grads`'
    limits: loss 1e-4 relative, grad norm 1e-3 relative, each leaf
    1e-3 * max|g_cpu| + 1e-6. Then K5 at the bf16 step's receive buffer
    (`ep-train`'s first calls: the gate/up product and the down product's
    input gradient) against its plain version, timed beside torch.bmm."""
    from repro_torch.distributed import make_expert_parallel_moe
    from repro_torch.training import value_and_grad

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(ARCH), num_layers=WHOLE_LAYERS,
                              dtype="float32")
    batch = dict(next(batch_iterator("all-3", *EP_GRADS_BATCH,
                                     vocab=cfg.vocab_size, seed=SEED)))
    params = T.init_params(cfg, torch.Generator().manual_seed(SEED),
                           device="cpu")
    runs = {}
    for backend, dev in (("gloo", "cpu"), ("nccl", DEVICE)):
        with _one_rank_group(backend) as group:
            ep = make_expert_parallel_moe(cfg, group)
            p = params if dev == "cpu" else _to(params, dev)
            K.reset_launch_counts()
            t0 = time.perf_counter()
            with _routes_kept() as routes:
                loss, parts, grads = value_and_grad(cfg, p, batch, ep=ep)
            if dev != "cpu":
                torch.cuda.synchronize()
            runs[backend] = dict(
                loss=float(loss), lb=float(parts["lb"]),
                grads=[g.cpu() for g in _leaves(grads)],
                routes=[r.cpu() for r in routes], s=time.perf_counter() - t0,
                launches=K.launch_counts(), kernel_routes=K.route_counts())
            del p, grads
    c, g = runs["gloo"], runs["nccl"]
    c_norm = float(global_norm(c["grads"]))
    g_norm = float(global_norm(g["grads"]))
    ratios = [float((a - b).abs().max()) / (1e-3 * float(b.abs().max())
                                            + 1e-6)
              for a, b in zip(g["grads"], c["grads"])]
    moved = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                for a, b in zip(g["routes"], c["routes"]))
    emit("ep-train-grads", arch=cfg.name, layers=cfg.num_layers,
         dtype=cfg.dtype, batch=list(EP_GRADS_BATCH),
         groups="card: nccl, 1 rank; CPU: gloo, 1 rank",
         loss_cpu=c["loss"], loss_card=g["loss"], lb_cpu=c["lb"],
         lb_card=g["lb"], grad_norm_cpu=c_norm, grad_norm_card=g_norm,
         worst_leaf_share_of_grad_limit=max(ratios),
         max_grad_abs_err=max(float((a - b).abs().max())
                              for a, b in zip(g["grads"], c["grads"])),
         leaves=len(ratios), tokens_routed_to_other_experts=moved,
         launches=g["launches"], routes=g["kernel_routes"],
         cpu_launches=c["launches"], cpu_s=c["s"], card_s=g["s"],
         tolerance="loss 1e-4 rel, grad norm 1e-3 rel, each leaf "
                   "max|dg| <= 1e-3*max|g_cpu| + 1e-6",
         seconds=time.perf_counter() - t_phase)
    n = cfg.num_layers
    _check_launches("ep-train-grads", g["launches"],
                    {"moe_gmm": 6 * n, "flash_attention": n})
    if any(c["launches"].values()):
        raise AssertionError(f"ep-train-grads: the CPU run launched "
                             f"{c['launches']}")
    # the card's run was the last since a reset
    _check_routes("ep-train-grads", {"flash_attention": "simt",
                                     "moe_gmm": "simt"})
    if abs(g["loss"] - c["loss"]) > 1e-4 * abs(c["loss"]):
        raise AssertionError(f"ep-train-grads: loss: card {g['loss']}, CPU "
                             f"{c['loss']}")
    if abs(g_norm - c_norm) > 1e-3 * c_norm:
        raise AssertionError(f"ep-train-grads: grad norm: card {g_norm}, "
                             f"CPU {c_norm}")
    if max(ratios) > 1.0:
        raise AssertionError(f"ep-train-grads: a gradient leaf differs: "
                             f"{max(ratios)} of its limit")
    d = get_config(ARCH).d_model
    for name, key in (("recv-gate-up", (False, d)),
                      ("recv-down-dx", (True, d))):
        emit(f"ep-train-kernel:moe_gmm/{name}", **case_gmm(*calls5[key]))


def phase_train_whole(batch) -> None:
    """One float32 step of a 2-layer OLMoE at full width on the card (K5,
    K3 with lse) against the same weights and batch on the CPU (plain
    versions), as `_train_against_cpu` holds it."""
    cfg = dataclasses.replace(get_config(ARCH), num_layers=WHOLE_LAYERS,
                              dtype="float32")
    _train_against_cpu("train-whole", cfg, batch,
                       {"flash_attention": "simt", "moe_gmm": "simt"})


def _target_cfg():
    """The serve-cascade target of examples/serve_cascade.py."""
    return dataclasses.replace(get_config(MIXTRAL).reduced(), vocab_size=128,
                               num_layers=2)


def _train_serve_cascade(phase, cfg, seed) -> tuple:
    """Train `cfg` with the port as examples/serve_cascade.py trains its
    target: adamw(2e-3), 200 steps of batch_iterator("all-3", 16, 96,
    vocab=128, seed=0, prompt_len=48), init from `seed`. Launch counts are
    set to 0 first. Returns (params, record) after checking the loss fell,
    K3 and K5 ran on their float32 routes and K5 six times per layer and
    step."""
    init_state, step = make_train_step(cfg, optimizer=adamw(2e-3))
    state = init_state(torch.Generator(device=DEVICE).manual_seed(seed),
                       device=DEVICE)
    it = batch_iterator("all-3", 16, 96, vocab=cfg.vocab_size, seed=0,
                        prompt_len=48)
    K.reset_launch_counts()
    log = []
    t0 = time.perf_counter()
    for i in range(TARGET_STEPS):
        state, m = step(state, next(it))
        if i % 25 == 0 or i == TARGET_STEPS - 1:
            log.append({"step": i, **{k: float(v) for k, v in m.items()}})
    torch.cuda.synchronize()
    launches = K.launch_counts()
    rec = dict(arch=cfg.name, layers=cfg.num_layers, vocab=cfg.vocab_size,
               dtype=cfg.dtype, init_seed=seed, steps=TARGET_STEPS,
               optimizer="adamw", lr=2e-3, log=log, launches=launches,
               routes=K.route_counts(), seconds=time.perf_counter() - t0)
    _check_routes(phase, {"flash_attention": "simt", "moe_gmm": "simt"})
    if not log[-1]["loss"] < log[0]["loss"]:
        raise AssertionError(f"{phase}: the loss did not fall: {log}")
    if launches["moe_gmm"] != 6 * cfg.num_layers * TARGET_STEPS:
        raise AssertionError(f"{phase}: K5 launched {launches['moe_gmm']} "
                             f"times")
    return state[0], rec


def phase_target_train() -> tuple:
    """Train the serve-cascade target as the example trains it."""
    cfg = _target_cfg()
    params, rec = _train_serve_cascade("target-train", cfg, SEED)
    emit("target-train", **rec)
    return cfg, params


def _trained_requests(cfg) -> list:
    """The serve-cascade requests: (request id, prompt, task), seed 1."""
    rng = np.random.default_rng(1)
    tasks = ["code", "math", "extract"]
    reqs = []
    for i in range(TARGET_REQUESTS):
        s = make_sample(tasks[i % 3], rng, vocab=cfg.vocab_size,
                        prompt_len=48, cont_len=1)
        reqs.append((f"r{i}", s.prompt, s.task))
    return reqs


#: the serve-cascade example's policies
TRAINED_POLICIES = (("no-spec", lambda: StaticKController(0)),
                    ("static-K3", lambda: StaticKController(3)),
                    ("cascade", CascadeController))


def _serve_requests(eng, reqs) -> tuple:
    """`reqs` one after another through a ServingEngine. Returns (results,
    wall seconds)."""
    t0 = time.perf_counter()
    results = [eng.generate(p, TARGET_NEW, request_id=rid, task=task)
               for rid, p, task in reqs]
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0


def _serving_report(results, wall, reqs=None) -> dict:
    """Tokens per pass, drafts, acceptance, K, utility and the drafter's
    seconds per drafted token (the engine's clock: measured on the wall
    clock, `cm.draft_time` on the model clock); per task where `reqs`
    names the tasks."""
    its = [it for r in results for it in r.telemetry.iterations]
    out = sum(r.telemetry.output_tokens for r in results)
    drafted = sum(it.k_drafted for it in its)
    draft_s = sum(it.t_draft for it in its)
    rec = dict(output_tokens=out, passes=len(its), drafted=drafted,
               accepted=sum(it.tokens_emitted - 1 for it in its),
               tokens_per_pass=out / len(its),
               mean_utility=float(np.mean([it.utility for it in its])),
               mean_k=float(np.mean([it.k_drafted for it in its])),
               tokens_per_s=out / sum(r.telemetry.decode_time
                                      for r in results),
               wall_s=wall, draft_s=draft_s,
               draft_s_per_drafted_token=draft_s / drafted if drafted
               else None)
    if reqs is not None:
        rec["per_task_tokens_per_pass"] = {
            t: sum(r.telemetry.output_tokens for r, q in zip(results, reqs)
                   if q[2] == t)
            / sum(len(r.telemetry.iterations) for r, q in zip(results, reqs)
                  if q[2] == t) for t in sorted({q[2] for q in reqs})}
    return rec


def phase_serve_trained(cfg, params) -> dict:
    """Serve the trained target as examples/serve_cascade.py does: 6
    requests one after another through ServingEngine with NGramDrafter
    and a fresh controller per request, under no-spec, static K=3 and
    Cascade, on the model clock and the wall clock; all greedy streams must
    be identical. Returns the report by policy and clock."""
    reqs = _trained_requests(cfg)
    K.reset_launch_counts()
    report, streams = {}, {}
    for clock in ("model", "wall"):
        for name, factory in TRAINED_POLICIES:
            eng = ServingEngine(cfg, params, NGramDrafter(),
                                controller_factory=factory, max_len=512,
                                temperature=0.0, clock=clock, seed=SEED,
                                device=DEVICE)
            results, wall = _serve_requests(eng, reqs)
            streams[f"{name}/{clock}"] = [r.tokens for r in results]
            report[f"{name}/{clock}"] = _serving_report(results, wall, reqs)
    base = streams["no-spec/model"]
    same = {k: v == base for k, v in streams.items()}
    emit("serve-trained", arch=cfg.name, requests=TARGET_REQUESTS,
         max_new=TARGET_NEW, temperature=0.0, policies=report,
         streams_identical=same, launches=K.launch_counts(),
         routes=K.route_counts(),
         tokens_per_s_note="model clock: the H100_SXM cost model's seconds;"
                           " wall clock: measured")
    _check_routes("serve-trained", F32_SERVING)
    if not all(same.values()):
        raise AssertionError(f"greedy streams differ between policies: "
                             f"{same}")
    if report["static-K3/model"]["drafted"] == 0:
        raise AssertionError("static K=3 drafted nothing")
    return report


#: the kernels a bf16 serving pass of the trained target runs, by expert
#: storage, and the routes each may take (the first at least once): K4
#: runs a one-token pass (C = 1) on the CUDA cores by its rule
TRAINED_BF16_KERNELS = {
    "bf16": {"flash_attention": ("wgmma",), "decode_attention": ("mma",),
             "moe_gmm_fused": ("wgmma",)},
    "int8": {"flash_attention": ("wgmma",), "decode_attention": ("mma",),
             "moe_gmm_fused_quant": ("wgmma", "simt")},
}


def _plain_bindings(names) -> tuple:
    """(module, name, plain version) for each kernel in `names`: the model
    modules' names for the kernels, bound as `_Recorder` binds them."""
    where = {"flash_attention": T, "decode_attention": T,
             "moe_gmm_fused": moe_mod, "moe_gmm_fused_quant": moe_mod}
    return tuple((where[n], n, getattr(K, f"{n}_plain")) for n in names)


def phase_serve_trained_bf16(cfg, params) -> dict:
    """The bf16 routes held end to end: the trained
    target cast to bf16, its requests served greedily under Cascade (model
    clock, so K follows the tokens alone) through the kernels, and again
    with the model modules' kernel names bound to the plain versions, which
    keep h and P in float32; then both with the routed experts quantized to
    int8 (K4 instead of K1). Where a pair's streams differ, one plain
    version at a time is bound, to find the kernel at fault. Fails if a
    pair's greedy streams or accepted drafts differ."""
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    bparams = tree_map(lambda t: t.to(torch.bfloat16)
                       if t.is_floating_point() else t, params)
    trees = {"bf16": bparams,
             "int8": moe_mod.quantize_transformer_experts(bparams)}
    reqs = _trained_requests(cfg)

    def serve(tree, plain=()):
        with _patched(*_plain_bindings(plain)):
            K.reset_launch_counts()
            eng = ServingEngine(bcfg, tree, NGramDrafter(),
                                controller_factory=CascadeController,
                                max_len=512, temperature=0.0, clock="model",
                                seed=SEED, device=DEVICE)
            results = [eng.generate(p, TARGET_NEW, request_id=rid, task=task)
                       for rid, p, task in reqs]
            torch.cuda.synchronize()
        its = [it for r in results for it in r.telemetry.iterations]
        return dict(tokens=[r.tokens for r in results], passes=len(its),
                    drafted=sum(it.k_drafted for it in its),
                    accepted=sum(it.tokens_emitted - 1 for it in its),
                    launches=K.launch_counts(), routes=K.route_counts())

    report, faults = {}, {}
    for experts, tree in trees.items():
        kernels = TRAINED_BF16_KERNELS[experts]
        on, off = serve(tree), serve(tree, tuple(kernels))
        same = on["tokens"] == off["tokens"]
        rec = {"streams_identical": same,
               "accepted": {"kernels": on["accepted"],
                            "plain": off["accepted"]},
               "drafted": {"kernels": on["drafted"],
                           "plain": off["drafted"]},
               "passes": {"kernels": on["passes"], "plain": off["passes"]},
               "launches_kernels": {n: on["launches"][n] for n in kernels},
               "launches_plain": {n: off["launches"][n] for n in kernels},
               "routes_kernels": {n: on["routes"][n] for n in kernels}}
        bad_route = {n: on["routes"][n] for n, r in kernels.items()
                     if on["routes"][n][r[0]] == 0
                     or sum(on["routes"][n][x] for x in r)
                     != on["launches"][n]}
        if bad_route or any(off["launches"][n] for n in kernels):
            emit("serve-trained-bf16", experts=report | {experts: rec})
            raise AssertionError(f"serve-trained-bf16/{experts}: routes "
                                 f"{bad_route}, plain run launched "
                                 f"{rec['launches_plain']}")
        if not same or on["accepted"] != off["accepted"]:
            rec["first_difference"] = next(
                (i, next(j for j, (a, b) in enumerate(zip(x, y)) if a != b))
                for i, (x, y) in enumerate(zip(on["tokens"], off["tokens"]))
                if x != y) if not same else None
            # one plain version at a time: which one makes the kernel run
            # give the plain run's streams
            rec["one_plain_bound"] = {}
            for n in kernels:
                one = serve(tree, (n,))
                rec["one_plain_bound"][n] = {
                    "streams_equal_plain": one["tokens"] == off["tokens"],
                    "streams_equal_kernels": one["tokens"] == on["tokens"],
                    "accepted": one["accepted"]}
            faults[experts] = rec
        report[experts] = rec
    emit("serve-trained-bf16", arch=bcfg.name, dtype=bcfg.dtype,
         requests=TARGET_REQUESTS, max_new=TARGET_NEW, temperature=0.0,
         clock="model", policy="cascade", experts=report)
    if faults:
        raise AssertionError(f"serve-trained-bf16: kernel and plain runs "
                             f"differ: {faults}")
    return report


# --------------------------------------------------------------------- #
# A learned drafter: the serve-cascade target's one-layer drafter, trained
# and checkpointed beside it, served through DraftModelDrafter
# --------------------------------------------------------------------- #

DRAFTER_SEED = SEED + 1   # the drafter's init seed (the target's: SEED)
CKPT_DIR = ROOT / "build" / "checkpoints"
SAMPLED_TEMPERATURE = 0.8
_INT_VIEW = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def _same_bits(a, b) -> bool:
    """Two trees with the same containers and keys, and tensor leaves of
    the same dtype, shape and bits (floats compared as integers)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_same_bits(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_bits(x, y) for x, y in zip(a, b)))
    if not torch.is_tensor(a):
        return a == b
    if not torch.is_tensor(b) or a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = _INT_VIEW.get(a.dtype)
    return (torch.equal(a, b.to(a.device)) if view is None else
            torch.equal(a.view(view), b.to(a.device).view(view)))


def _checkpoint_round_trip(name, tree) -> tuple:
    """`checkpoint.save` the tree under the gitignored build/, `restore` it
    (onto the card: no device given) and require every leaf bit-equal.
    Returns (the restored tree, a record)."""
    path = CKPT_DIR / f"{name}.pt"
    t0 = time.perf_counter()
    checkpoint.save(str(path), tree)
    back = checkpoint.restore(str(path))
    torch.cuda.synchronize()
    leaves = list(_leaves(back))
    rec = dict(file=str(path.relative_to(ROOT)), bytes=path.stat().st_size,
               leaves=len(leaves),
               on_card=all(t.device.type == torch.device(DEVICE).type
                           for t in leaves),
               bit_equal=_same_bits(tree, back),
               seconds=time.perf_counter() - t0)
    if not (rec["bit_equal"] and rec["on_card"]):
        raise AssertionError(f"checkpoint {name}: restored tree differs "
                             f"from the saved one: {rec}")
    return back, rec


def phase_drafter_trained(cfg, params, ngram_report) -> dict:
    """A one-layer drafter of the serve-cascade target (`cfg` with one
    layer), trained as the target was trained from another init seed; the
    target and the drafter saved with `checkpoint.save` under build/ and
    restored onto the card bit for bit (and bf16 casts of both); the
    restored target served through ServingEngine with a
    `DraftModelDrafter(temperature=0.0)` of the restored drafter on the
    six serve-cascade requests under no-spec, static K=3 and Cascade on
    both clocks (greedy streams identical, drafts accepted under static
    K=3), reported beside `ngram_report`, the n-gram drafter's on the same
    requests; then static K=3 at temperature 0.8 with rejection sampling
    against the drafter's `draft_probs`; then BatchedEngine(max_batch=3)
    with a `DraftModelDrafter` per row, whose greedy streams must equal
    ServingEngine's."""
    t_phase = time.perf_counter()
    dcfg = dataclasses.replace(cfg, num_layers=1)
    dparams, train = _train_serve_cascade("drafter-trained", dcfg,
                                          DRAFTER_SEED)
    ckpt = {}
    target, ckpt["target"] = _checkpoint_round_trip("target", params)
    drafter, ckpt["drafter"] = _checkpoint_round_trip("drafter", dparams)
    for name, tree in (("target", params), ("drafter", dparams)):
        _, ckpt[f"{name}-bf16"] = _checkpoint_round_trip(
            f"{name}-bf16", tree_map(lambda t: t.to(torch.bfloat16)
                                     if t.is_floating_point() else t, tree))
    reqs = _trained_requests(cfg)

    def draft_model(temperature):
        return DraftModelDrafter(dcfg, drafter, max_len=512,
                                 temperature=temperature, device=DEVICE)

    K.reset_launch_counts()
    report, streams = {}, {}
    with _no_plain_versions() as plain_calls:
        for clock in ("model", "wall"):
            for name, factory in TRAINED_POLICIES:
                eng = ServingEngine(cfg, target, draft_model(0.0),
                                    controller_factory=factory, max_len=512,
                                    temperature=0.0, clock=clock, seed=SEED,
                                    device=DEVICE)
                results, wall = _serve_requests(eng, reqs)
                streams[f"{name}/{clock}"] = [r.tokens for r in results]
                report[f"{name}/{clock}"] = _serving_report(results, wall,
                                                            reqs)
        eng = ServingEngine(cfg, target, draft_model(SAMPLED_TEMPERATURE),
                            controller_factory=lambda: StaticKController(3),
                            max_len=512, temperature=SAMPLED_TEMPERATURE,
                            clock="model", seed=SEED, device=DEVICE)
        sampled = _serving_report(*_serve_requests(eng, reqs))
        sampled["acceptance"] = sampled["accepted"] / sampled["drafted"]
        beng = BatchedEngine(cfg, target, max_batch=3,
                             drafter_factory=lambda: draft_model(0.0),
                             controller_factory=CascadeController,
                             max_len=512, temperature=0.0, clock="model",
                             seed=SEED, device=DEVICE)
        bres, bwall = _serve_batched(beng, [p for _, p, _ in reqs],
                                     TARGET_NEW)
    launches = K.launch_counts()
    base = streams["no-spec/model"]
    same = {k: v == base for k, v in streams.items()}
    batched = _serving_report(bres, bwall)
    batched["streams_equal_serving_engine"] = [r.tokens for r in bres] == base
    per_token_model = cm.draft_time(cm.H100_SXM, 1, dcfg.active_param_count())
    emit("drafter-trained", target=cfg.name, drafter_layers=dcfg.num_layers,
         drafter_params=dcfg.param_count(),
         drafter_bytes=sum(t.numel() * t.element_size()
                           for t in _leaves(drafter)),
         train=train, checkpoints=ckpt, requests=TARGET_REQUESTS,
         max_new=TARGET_NEW, temperature=0.0, policies=report,
         ngram_policies=ngram_report, streams_identical=same,
         sampled={"temperature": SAMPLED_TEMPERATURE, "policy": "static-K3",
                  **sampled},
         batched={"max_batch": 3, "policy": "cascade", **batched},
         draft_s_per_token={
             "wall_draft_model": report["static-K3/wall"][
                 "draft_s_per_drafted_token"],
             "wall_ngram": ngram_report["static-K3/wall"][
                 "draft_s_per_drafted_token"],
             "cost_model": per_token_model},
         launches=launches, routes=K.route_counts(), plain_calls=plain_calls,
         seconds=time.perf_counter() - t_phase)
    _check_routes("drafter-trained", F32_SERVING)
    if any(plain_calls.values()):
        raise AssertionError(f"plain versions ran on the card: "
                             f"{plain_calls}")
    if not all(same.values()):
        raise AssertionError(f"drafter-trained: greedy streams differ "
                             f"between policies: {same}")
    if report["static-K3/model"]["accepted"] == 0:
        raise AssertionError("drafter-trained: no draft of the draft model "
                             "was accepted under static K=3")
    if sampled["drafted"] == 0:
        raise AssertionError("drafter-trained: the sampled run drafted "
                             "nothing")
    if not batched["streams_equal_serving_engine"]:
        raise AssertionError("drafter-trained: BatchedEngine's greedy "
                             "streams differ from ServingEngine's")
    return report


# --------------------------------------------------------------------- #
# The recurrent paths: RWKV-6 (K6 on every pass) and RecurrentGemma (K7 on
# every RG-LRU block, K2/K3 at head_dim 256 on the local-attention blocks);
# staged states and rollback
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class _RecurrentPath:
    """What the phases shared by the recurrent paths need of a family.
    `tag` prefixes the phase names; `leaves` are the cache's recurrent
    leaves. `scan` is the kernel launched once per recurrent layer per
    pass, as its module, wrapper name and the argument indices a recorder
    clones (the recurrent state, which later passes overwrite in place);
    `recorded` the path's other kernels the model phase records, likewise;
    `kernels` every kernel the engines must launch (no other may).
    `prompt_len` and `ring` size the model phase's prefill and cache, from
    `seed` (the profile's from seed + 1); `reverify_rtol` bounds the logits
    of a re-verifying pass of another length than the span's (its products
    may round otherwise); `chunk_key` is the scan's recorder key of the
    batched engine's chunk pass; `shares` names the kernels whose share of
    the profiled pass is reported, by fragments of their names;
    `seeded()` gives the kernel phase's seeded cases; `reference()`, if
    any, holds a reduced model on the card against the CPU. `routes`, for
    a scan with routes, names the route each model-phase pass must take
    (every layer's launch)."""
    tag: str
    leaves: tuple
    scan: tuple
    recorded: tuple
    kernels: tuple
    prompt_len: int
    ring: int
    seed: int
    reverify_rtol: float
    chunk_key: tuple
    shares: dict
    seeded: object
    reference: object = None
    routes: dict = dataclasses.field(default_factory=dict)


def _rwkv_path(cfg) -> _RecurrentPath:
    return _RecurrentPath(
        tag="rwkv", leaves=T.RWKV_LEAVES, scan=(rwkv_mod, "rwkv_scan", (5,)),
        recorded=(), kernels=("rwkv_scan",), prompt_len=PROMPT_LEN,
        ring=MAX_LEN, seed=SEED + 5, reverify_rtol=1e-2,
        chunk_key=((REC_BATCH, REC_CHUNK, cfg.rwkv_num_heads,
                    cfg.rwkv_head_size), True),
        shares={"k6": ("wkv_scan",)},
        seeded=lambda: {
            "rwkv_scan/seeded-n64-t37": _seeded_scan(2, 37, 40, 64, 1),
            "rwkv_scan/seeded-n32-t13": _seeded_scan(3, 13, 8, 32, 2),
            # the chunked route: more than CHUNK tokens, no staged states
            "rwkv_scan/seeded-n64-t512": _seeded_scan(1, 512, 40, 64, 5,
                                                      states=False),
            "rwkv_scan/seeded-n32-t77": _seeded_scan(3, 77, 8, 32, 6,
                                                     states=False)},
        routes={"prefill": "chunked", f"t{SPAN}": "serial", "t1": "serial",
                f"b{MIX_BATCH}x{SPAN}": "serial"})


def _rgemma_path(cfg) -> _RecurrentPath:
    # the unpadded re-verify read 1.8e-2 of max|ref| on the card (the float32
    # gate products' cuBLAS kernel depends on the row count)
    return _RecurrentPath(
        tag="rgemma", leaves=T.RGLRU_LEAVES,
        scan=(rglru_mod, "linear_scan", (2,)),
        recorded=((T, "decode_attention", (1, 2)), (T, "flash_attention", ())),
        kernels=("linear_scan", "decode_attention", "flash_attention"),
        prompt_len=RG_PROMPT_LEN, ring=RG_MAX_LEN, seed=SEED + 7,
        reverify_rtol=5e-2,
        chunk_key=((REC_BATCH, REC_CHUNK, cfg.d_rnn), False),
        shares={"k7": ("lru_scan",), "k2": ("span_mma", "span_merge")},
        seeded=lambda: {
            "linear_scan/seeded-t37-d1000": _seeded_linear_scan(2, 37, 1000,
                                                                3),
            "linear_scan/seeded-t130-d77": _seeded_linear_scan(3, 130, 77,
                                                               4)},
        reference=phase_rgemma_reference)


def phase_recurrent_params(cfg, path) -> dict:
    """The whole model in bf16 on the card, built one layer at a time by
    init_params; the RG-LRU's `lam` must stay float32."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = T.init_params(cfg, gen, device=DEVICE)
    torch.cuda.synchronize()
    lam = {str(p["rec"]["lam"].dtype) for p in params.get("blocks_list", ())
           if "rec" in p}
    emit(f"{path.tag}-params", arch=cfg.name, params=cfg.param_count(),
         dtype=cfg.dtype, layers="".join(cfg.layer_kinds()),
         bytes=sum(t.numel() * t.element_size() for t in _leaves(params)),
         lam_dtype=sorted(lam), seconds=time.perf_counter() - t0,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    if lam - {"torch.float32"}:
        raise AssertionError(f"lam is {lam}, not float32")
    return params


def _scan_kw(kw) -> dict:
    """What a K6 recorder keeps of a call's keywords: whether it staged
    states (the kernel phase allocates its own; a view of the pass's
    staged buffer would keep all of it alive)."""
    return {"states": kw.get("states") is not None}


def _rel_err(got, ref) -> tuple:
    """(max|got - ref|, max|ref|) in float32."""
    return (float((got.float() - ref.float()).abs().max()),
            float(ref.float().abs().max()))


def phase_recurrent_model(cfg, params, path) -> dict:
    """A `path.prompt_len`-token prefill; a [1+4] span with staged states;
    a rollback to REC_ACCEPT tokens (the selected states must equal the
    staged slot exactly) and the span's remaining tokens verified again
    from there twice: padded to the span's length, where their logits must
    equal the span's bit for bit (products of the same shapes), and alone,
    within `path.reverify_rtol` * max|ref|; a 1-token pass; a B=4 per-row
    pass whose rows sit at MIX_ROW_LENGTHS (each row its own prefilled
    prompt) verifying ragged spans of MIX_SPAN_LENGTHS, with a per-row
    rollback. Records the layer-0 inputs of the path's kernels on each
    pass."""
    rng = np.random.default_rng(path.seed)
    dev = torch.device(DEVICE)
    vocab = cfg.vocab_size
    prompt = torch.tensor([_copy_prompt(rng, path.prompt_len, vocab)],
                          dtype=torch.int32, device=dev)
    span = torch.tensor([rng.integers(3, vocab, SPAN).tolist()],
                        dtype=torch.int32, device=dev)
    torch.cuda.reset_peak_memory_stats()
    inputs, secs, routes = {}, {}, {}
    n_rec = sum(k in "RW" for k in cfg.layer_kinds())

    def run(name, fn):
        module, wrapper, copy = path.scan
        before = K.route_counts().get(wrapper)
        with contextlib.ExitStack() as stack:
            recs = [stack.enter_context(_Recorder(module, wrapper, copy=copy,
                                                  keep_kw=_scan_kw))]
            recs += [stack.enter_context(_Recorder(m, w, copy=c))
                     for m, w, c in path.recorded]
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
        if before is not None:
            routes[name] = {r: n - before[r] for r, n in
                            K.route_counts()[wrapper].items()}
        for rec in recs:
            if rec.args is not None:
                inputs[f"{rec.name}/{name}"] = rec.args
        return out

    cache = T.init_cache(cfg, 1, path.ring, device=dev)
    lo_pre, cache, _ = run("prefill", lambda: T.prefill(cfg, params, prompt,
                                                       cache))
    lo, c_span, _, staged = run(f"t{SPAN}", lambda: T.decode_step(
        cfg, params, cache, span))
    c_back = T.rollback_cache(cfg, c_span, staged, REC_ACCEPT,
                              path.prompt_len)
    exact = {n: bool(torch.equal(c_back[n], staged[n][:, REC_ACCEPT]))
             for n in path.leaves}
    n_re = SPAN - REC_ACCEPT
    padded = torch.cat([span[:, REC_ACCEPT:], span[:, :REC_ACCEPT]], dim=1)
    # a pass leaves the cache it was given as it was: the padded pass's K/V
    # writes past the re-verified tokens stay masked for the unpadded pass
    lo_pad, _, _, _ = T.decode_step(cfg, params, c_back, padded)
    re_exact = bool(torch.equal(lo_pad[:, :n_re], lo[:, REC_ACCEPT:]))
    lo_re, _, _, _ = T.decode_step(cfg, params, c_back,
                                   span[:, REC_ACCEPT:])
    re_err, re_ref = _rel_err(lo_re, lo[:, REC_ACCEPT:])
    staged_bytes = {n: st.numel() * st.element_size()
                    for n, st in staged.items()}
    lo1, _, _, _ = run("t1", lambda: T.decode_step(cfg, params, cache,
                                                   span[:, :1]))
    del staged, c_span, c_back, cache

    # the B=4 pass: each row its own prompt, prefilled alone and copied in
    batch = T.init_cache(cfg, MIX_BATCH, MAX_LEN, device=dev, per_row=True)
    for slot, n in enumerate(MIX_ROW_LENGTHS):
        row = T.init_cache(cfg, 1, MAX_LEN, device=dev)
        p = torch.tensor([_copy_prompt(rng, n, vocab)], dtype=torch.int32,
                         device=dev)
        _, row, _ = T.prefill(cfg, params, p, row)
        batch = T.write_cache_row(batch, slot, row)
    spans = torch.tensor(rng.integers(3, vocab, (MIX_BATCH, SPAN)),
                         dtype=torch.int32, device=dev)
    mask = (torch.arange(SPAN, device=dev)[None, :]
            < torch.tensor(MIX_SPAN_LENGTHS, device=dev)[:, None])
    lo4, c4, _, st4 = run(f"b{MIX_BATCH}x{SPAN}", lambda: T.decode_step(
        cfg, params, batch, spans, token_mask=mask))
    n_keep = torch.tensor([max(1, n - 1) for n in MIX_SPAN_LENGTHS],
                          dtype=torch.int32)
    c4b = T.rollback_cache(cfg, c4, st4, n_keep,
                           torch.tensor(MIX_ROW_LENGTHS, dtype=torch.int32))
    rows_exact = all(
        torch.equal(c4b[n][:, b], st4[n][:, int(j), b])
        for n in path.leaves for b, j in enumerate(n_keep))
    lengths4 = c4b["lengths"].tolist()
    peak = torch.cuda.max_memory_allocated()
    del st4, c4, c4b, batch

    finite = bool(all(torch.isfinite(x.float()).all()
                      for x in (lo_pre, lo, lo_pad, lo_re, lo1, lo4)))
    re_lim = path.reverify_rtol * re_ref
    emit(f"{path.tag}-model", arch=cfg.name, params=cfg.param_count(),
         dtype=cfg.dtype, prompt_len=path.prompt_len,
         local_window=cfg.local_window, ring_slots=path.ring, span=SPAN,
         seconds=secs, logits_finite=finite, staged_bytes=staged_bytes,
         rollback_accept=REC_ACCEPT, rollback_states_exact=exact,
         reverified_padded_bit_exact=re_exact,
         reverified_unpadded_logits_max_abs_err=re_err,
         reverified_unpadded_logits_max_abs=re_ref,
         reverified_unpadded_limit=re_lim,
         reverified_unpadded_tolerance=f"max|err| <= "
                                       f"{path.reverify_rtol:g}*max|ref|",
         row_lengths=list(MIX_ROW_LENGTHS),
         span_lengths=list(MIX_SPAN_LENGTHS), n_keep=n_keep.tolist(),
         lengths_after_rollback=lengths4,
         per_row_rollback_exact=rows_exact, peak_memory_bytes=peak,
         scan_routes=routes)
    if not finite:
        raise AssertionError("non-finite logits")
    if not all(exact.values()) or not rows_exact:
        raise AssertionError(f"rollback did not select the staged states: "
                             f"{exact}, per row {rows_exact}")
    if not re_exact:
        raise AssertionError("the re-verified span's logits, padded to the "
                             "span's length, differ from the span's")
    if re_err > re_lim:
        raise AssertionError(f"re-verified logits, unpadded, differ by "
                             f"{re_err} (limit {re_lim}, max|ref| {re_ref})")
    want = [n + k for n, k in zip(MIX_ROW_LENGTHS, n_keep.tolist())]
    if lengths4 != want:
        raise AssertionError(f"lengths after rollback {lengths4}, not {want}")
    off = {name: got for name, got in routes.items() if name in path.routes
           and got.get(path.routes[name]) != n_rec}
    if off:
        raise AssertionError(f"{path.scan[1]}: passes off their routes "
                             f"{path.routes}: {off}")
    return inputs


def _scan_cost(r, states: bool) -> tuple:
    """(bytes, operations) of the WKV recurrence: r, k, v, w read and y
    written once, u, s0 read and s_last written once, and with staged
    states T+1 states written; ~5*N*N float32 operations per (token, row,
    head) (the N x N dot product for y and the decayed rank-1 update)."""
    b, t, h, n = r.shape
    n_bytes = 4 * (5 * r.numel() + h * n + 2 * b * h * n * n
                   + (t + 1) * b * h * n * n * states)
    return n_bytes, 5.0 * b * t * h * n * n


def _slice_errs(got, ref, rows: int) -> tuple:
    """Per (row, head) slice of `got` and `ref`, viewed as [rows, -1]:
    (max|err|, max|ref|, limit 1e-3 * max|ref| + 1e-6) of the slice whose
    error takes the largest share of its own limit."""
    g = got.float().reshape(rows, -1)
    r = ref.float().reshape(rows, -1)
    err = (g - r).abs().amax(1)
    ref_max = r.abs().amax(1)
    lim = 1e-3 * ref_max + 1e-6
    j = int((err / lim).argmax())
    return float(err[j]), float(ref_max[j]), float(lim[j])


def case_scan(args, kw) -> dict:
    """K6 against its plain version on these inputs: each (row, head)
    slice of y, of s_last and of every staged state within
    1e-3 * max|ref| + 1e-6 of that slice (the main path's activations span
    orders of magnitude across heads and rows, so a limit over the whole
    tensor would hold the small ones to nothing). Times: `ms` and
    `plain_ms` by CUDA events over back-to-back calls, as for the other
    kernels (at span shapes `ms` is the wrapper's host time, which
    outlasts the kernel); `device_ms` and `device_ms_cold` the kernel's
    own, from CUDA graphs; `kernel_device_ms` each CUDA kernel's device ms
    per call (torch.profiler): the chunked route's three steps."""
    r, k, v, w, u, s0 = args
    b, t, h, n = r.shape
    st = (torch.empty((t + 1, b, h, n, n), dtype=torch.float32,
                      device=r.device) if kw["states"] else None)
    ref_st = torch.empty_like(st) if st is not None else None
    route = rwkv_ops.route(t, st is not None)
    by_route = getattr(K.rwkv_scan, "launches_by_route", None)
    before = None if by_route is None else by_route[route]
    y, s_last = K.rwkv_scan(r, k, v, w, u, s0, states=st)
    torch.cuda.synchronize()
    if before is not None and by_route[route] != before + 1:
        raise AssertionError(f"rwkv_scan {list(r.shape)}: not counted on "
                             f"its route {route}: {by_route}")
    ry, rs = K.rwkv_scan_plain(r, k, v, w, u, s0, states=ref_st)
    # y [B,T,H,N] to [B,H,T,N]: a slice is one (row, head)
    pairs = {"y": (y.transpose(1, 2), ry.transpose(1, 2), b * h),
             "s_last": (s_last, rs, b * h)}
    if st is not None:
        pairs["states"] = (st, ref_st, (t + 1) * b * h)
    errs = {}
    for name, (got, ref, rows) in pairs.items():
        err, ref_max, lim = _slice_errs(got, ref, rows)
        errs[name] = (err, ref_max, lim)
        if err > lim:
            raise AssertionError(f"rwkv_scan {name}: a slice's max|err| "
                                 f"{err} over {lim} (its max|ref| "
                                 f"{ref_max})")
    if st is not None and not torch.equal(st[0], s0):
        raise AssertionError("rwkv_scan: staged slot 0 is not s0")
    whole = [_rel_err(got, ref) for got, ref, _ in pairs.values()]
    n_bytes, n_ops = _scan_cost(r, st is not None)
    bound_ms, bound_by = _bound(n_bytes, n_ops, F32_OPS_PER_S)

    def run():
        return K.rwkv_scan(r, k, v, w, u, s0, states=st)
    worst = max(errs, key=lambda k_: errs[k_][0] / errs[k_][2])
    return dict(
        shape=f"[B,T,H,N] {list(r.shape)} staged={st is not None}",
        route=route,
        max_abs_err=max(e for e, _ in whole),
        ref_max_abs=max(m for _, m in whole),
        worst_slice={k_: {"max_abs_err": e[0], "ref_max_abs": e[1],
                          "limit": e[2]} for k_, e in errs.items()},
        worst=worst, worst_share_of_limit=errs[worst][0] / errs[worst][2],
        tolerance="per (row, head) slice of y, s_last and each staged "
                  "state: max|err| <= 1e-3*max|ref of the slice| + 1e-6",
        ms=_time_ms(run),
        device_ms=_graph_ms(run),
        device_ms_cold=_graph_ms(run, cold=True),
        host_ms=_host_ms(run), kernel_device_ms=_kernel_ms(run),
        plain_ms=_time_ms(lambda: K.rwkv_scan_plain(r, k, v, w, u, s0,
                                                    states=ref_st),
                          iters=5 if t > 64 else 20),
        bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes,
        library_ms=None,
        library="none: no single PyTorch call computes this recurrence")


def _seeded_scan(b, t, h, n, seed, states: bool = True) -> tuple:
    """Unit-scale inputs: r, k, v ~ N(0, 1), w = exp(-exp(N(-1, 1))),
    u ~ N(0, 0.25), s0 ~ N(0, 1); staged states or none."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=DEVICE)
    r, k, v = randn(b, t, h, n), randn(b, t, h, n), randn(b, t, h, n)
    w = torch.exp(-torch.exp(randn(b, t, h, n) - 1.0))
    return (r, k, v, w, randn(h, n) * 0.5, randn(b, h, n, n)), \
        {"states": states}


def case_linear_scan(args, kw) -> dict:
    """K7 against its plain version on these inputs: the kernel walks every
    channel in token order with the plain loop's roundings, so y and
    h_last must equal it bit for bit at every T, and every (row, channel)
    lie within 1e-5 * max|ref over T| + 1e-6 (a kernel of another tree
    can be held to bit-exactness up to `kw["exact_max_t"]` tokens only).
    Times: `ms` and `plain_ms` by CUDA events over back-to-back calls (at
    span shapes `ms` is the wrapper's host time); `device_ms` and
    `device_ms_cold` the kernel's own, from CUDA graphs; `host_ms` the
    wrapper's host time per call."""
    a, x, h0 = args
    b, t, d = a.shape
    exact_max_t = kw.get("exact_max_t")   # None: every T
    y, h_last = K.linear_scan(a, x, h0)
    torch.cuda.synchronize()
    ry, rh = K.linear_scan_plain(a, x, h0)
    lim = 1e-5 * ry.abs().amax(1, keepdim=True) + 1e-6       # [B,1,D]
    share = max(float(((y - ry).abs() / lim).max()),
                float(((h_last - rh).abs() / lim[:, 0]).max()))
    exact = bool(torch.equal(y, ry) and torch.equal(h_last, rh))
    err, ref_max = _rel_err(y, ry)
    if share > 1.0:
        raise AssertionError(f"linear_scan {list(a.shape)}: a channel's "
                             f"error at {share} of its limit")
    if not exact and (exact_max_t is None or t <= exact_max_t):
        raise AssertionError(f"linear_scan {list(a.shape)}: not bit-exact "
                             f"(max|err| {err}, {share} of the per-channel "
                             f"limit)")
    n_bytes = 4 * (3 * b * t * d + 2 * b * d)
    bound_ms, bound_by = _bound(n_bytes, 2.0 * b * t * d, F32_OPS_PER_S)

    def run():
        return K.linear_scan(a, x, h0)
    return dict(
        shape=f"[B,T,D] {list(a.shape)}", max_abs_err=err,
        ref_max_abs=ref_max, worst_share_of_limit=share, bit_exact=exact,
        tolerance=("bit-exact at every T" if exact_max_t is None else
                   f"bit-exact at T <= {exact_max_t}, else per (row, "
                   f"channel) 1e-5*max|ref over T| + 1e-6"),
        ms=_time_ms(run), device_ms=_graph_ms(run),
        device_ms_cold=_graph_ms(run, cold=True), host_ms=_host_ms(run),
        plain_ms=_time_ms(lambda: K.linear_scan_plain(a, x, h0),
                          iters=5 if t > 64 else 20),
        bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes,
        library_ms=None,
        library="none: no single PyTorch call computes this recurrence")


def _seeded_linear_scan(b, t, d, seed) -> tuple:
    """a = sigmoid(N(3, 1)) in (0, 1), as the RG-LRU's decay, x and h0 ~
    N(0, 1)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=DEVICE)
    return (torch.sigmoid(randn(b, t, d) + 3.0), randn(b, t, d),
            randn(b, d)), {}


_CASES = {"rwkv_scan": case_scan, "linear_scan": case_linear_scan,
          "decode_attention": case_decode, "flash_attention": case_flash}


def phase_recurrent_kernels(path, inputs) -> dict:
    """Each kernel of the path against its plain version on the recorded
    layer-0 inputs (the model phase's prefill, [1+4] span, 1-token pass
    and B=4 ragged pass; the batched engine's chunk pass) and on the
    path's seeded cases."""
    cases = {}
    for key, (args, kw) in {**inputs, **path.seeded()}.items():
        cases[key] = _CASES[key.split("/")[0]](args, kw)
        emit(f"{path.tag}-kernel:{key}", **cases[key])
    return cases


def _scan_key(args, kw) -> tuple:
    """A scan call's input shape and whether it stages states."""
    return tuple(args[0].shape), kw.get("states") is not None


def phase_recurrent_engine(cfg, params, path) -> tuple:
    """ServingEngine on 3 prompts of 256 tokens, 64 new each, greedy, under
    Cascade and static K=4 (wall clock); then BatchedEngine(max_batch=4,
    chunk=32) on 6 such requests, so that requests are admitted by chunks
    into rows others left: each retired row's recurrent state must read
    zero. No plain version may run; the scan kernel must launch once per
    recurrent layer per pass, each of `path.kernels` at least once and no
    other kernel. Returns the launch counts and the scan's layer-0 inputs
    of the batched engine's first chunk pass (every row prefilling
    REC_CHUNK tokens)."""
    prompts, params = _engine_workload(cfg, params, REC_REQUESTS)
    n_rec = sum(k in "RW" for k in cfg.layer_kinds())
    module, scan, copy = path.scan
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    report, passes, prefills, cleared = {}, 0, 0, []
    with _no_plain_versions() as plain_calls:
        for name, factory in (("cascade", CascadeController),
                              ("static-k4", lambda: StaticKController(4))):
            eng = ServingEngine(cfg, params, NGramDrafter(),
                                controller_factory=factory, clock="wall",
                                temperature=0.0, max_len=MAX_LEN, seed=SEED,
                                device=DEVICE)
            t0 = time.perf_counter()
            results = [eng.generate(p, max_new=ENGINE_NEW, request_id=str(i))
                       for i, p in enumerate(prompts[:ENGINE_REQUESTS])]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            its = [it for r in results for it in r.telemetry.iterations]
            passes += len(its) + len(results)          # + the prefills
            prefills += len(results)
            out = sum(len(r.tokens) for r in results)
            decode_s = sum(r.telemetry.decode_time for r in results)
            report[name] = dict(
                tokens=out, iterations=len(its),
                decode_tokens_per_s=(out - len(results)) / decode_s,
                end_to_end_tokens_per_s=out / wall, wall_s=wall,
                prefill_s_mean=float(np.mean([r.telemetry.t_prefill
                                              for r in results])),
                tokens_per_pass=(out - len(results)) / len(its),
                drafted=sum(it.k_drafted for it in its),
                accepted=sum(it.tokens_emitted - 1 for it in its),
                mean_k=float(np.mean([it.k_drafted for it in its])),
                utility_mean=float(np.mean([it.utility for it in its])))
            for r in results:
                if len(r.tokens) != ENGINE_NEW:
                    raise AssertionError(f"{name}: {len(r.tokens)} tokens")

        eng = BatchedEngine(cfg, params, max_batch=REC_BATCH,
                            chunk=REC_CHUNK, clock="wall", temperature=0.0,
                            max_len=MAX_LEN, seed=SEED, device=DEVICE)

        def on_retire(slot):
            cleared.append(all(not bool(eng.cache[n][:, slot].any())
                               for n in path.leaves))

        with _Recorder(module, scan, copy=copy, key=_scan_key,
                       keep_kw=_scan_kw) as rec:
            results, wall = _serve_batched(eng, prompts, ENGINE_NEW,
                                           on_retire)
        steps = eng.telemetry.steps
        passes += len(steps)
        its = [it for r in results for it in r.telemetry.iterations]
        emitted = sum(it.tokens_emitted for it in its)
        report[f"batched-chunk{REC_CHUNK}"] = dict(
            requests=len(prompts), max_batch=REC_BATCH, chunk=REC_CHUNK,
            steps=len(steps), output_tokens=sum(len(r.tokens)
                                                for r in results),
            aggregate_tokens_per_s=sum(len(r.tokens) for r in results)
            / wall, decode_tokens_per_s=emitted / wall, wall_s=wall,
            tokens_per_step=emitted / len(steps),
            tokens_per_pass=emitted / len(its),
            mean_occupancy=eng.telemetry.mean_occupancy,
            prefill_chunks=[r.telemetry.prefill_chunks for r in results],
            ttft_s=[r.telemetry.ttft for r in results],
            drafted=sum(it.k_drafted for it in its),
            accepted=sum(it.tokens_emitted - 1 for it in its),
            rows_cleared_on_retire=cleared)
        for r in results:
            if len(r.tokens) != ENGINE_NEW or not all(
                    0 <= t < cfg.vocab_size for t in r.tokens):
                raise AssertionError(f"batched: bad output {r.tokens}")
    launches = K.launch_counts()
    emit(f"{path.tag}-engine", arch=cfg.name, prompt_len=ENGINE_PROMPT_LEN,
         max_new=ENGINE_NEW, clock="wall", temperature=0.0,
         policies=report, launches=launches, routes=K.route_counts(),
         passes=passes, plain_calls=plain_calls,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    if "flash_attention" in path.kernels:
        _check_routes(f"{path.tag}-engine", {"flash_attention": "wgmma",
                                             "decode_attention": "mma"})
    if any(plain_calls.values()):
        raise AssertionError(f"plain versions ran on the card: "
                             f"{plain_calls}")
    if launches[scan] != n_rec * passes:
        raise AssertionError(f"{scan} launched {launches[scan]} times over "
                             f"{passes} passes of {n_rec} recurrent layers")
    # the blocking prefills of ENGINE_PROMPT_LEN tokens take the prefill's
    # route, every staged pass (spans, the batched engine's chunks) the
    # other
    want = path.routes.get("prefill")
    if want is not None and K.route_counts()[scan][want] != n_rec * prefills:
        raise AssertionError(f"{scan}: {K.route_counts()[scan]} by route, "
                             f"not {n_rec * prefills} {want} launches for "
                             f"{prefills} prefills")
    idle = [n for n in path.kernels if launches[n] == 0]
    stray = [n for n, c in launches.items() if c and n not in path.kernels]
    if idle or stray:
        raise AssertionError(f"kernels never launched {idle}, launched off "
                             f"the path {stray}")
    if not (len(cleared) == REC_REQUESTS and all(cleared)):
        raise AssertionError(f"retired rows not cleared: {cleared}")
    if min(r.telemetry.prefill_chunks for r in results) < 2:
        raise AssertionError("a request was not admitted by chunks")
    idle = [n for n, r in report.items() if r["drafted"] == 0]
    if idle:
        raise AssertionError(f"engine verified no drafted span: {idle}")
    if path.chunk_key not in rec.calls:
        raise AssertionError(f"no {scan} call of {path.chunk_key} in the "
                             f"batched run: {sorted(rec.calls)}")
    return launches, {f"{scan}/b{REC_BATCH}-chunk{REC_CHUNK}":
                      rec.calls[path.chunk_key]}


def phase_recurrent_profile(cfg, params, path, steps: int = 5) -> None:
    """Where a [1+4] verification pass goes: device time by kernel
    (torch.profiler), the shares of the kernels `path.shares` names, and
    the device's idle share of the wall time."""
    rng = np.random.default_rng(path.seed + 1)
    dev = torch.device(DEVICE)
    prompt = torch.tensor([_copy_prompt(rng, PROMPT_LEN, cfg.vocab_size)],
                          dtype=torch.int32, device=dev)
    span = torch.tensor([rng.integers(3, cfg.vocab_size, SPAN).tolist()],
                        dtype=torch.int32, device=dev)
    cache = T.init_cache(cfg, 1, MAX_LEN, device=dev)
    _, cache, _ = T.prefill(cfg, params, prompt, cache)

    def step():
        # every step writes the same span slots and leaves the recurrent
        # state as it was
        lo, c, _, st = T.decode_step(cfg, params, cache, span)
        T.rollback_cache(cfg, c, st, 1, PROMPT_LEN)
        return lo[0, -1].float().cpu()

    by_name, _, busy = _profile(f"{path.tag}-profile", step, steps,
                                span=SPAN)
    shares = {}
    for label, keys in path.shares.items():
        absent = [k for k in keys
                  if not any(k in n and v > 0 for n, v in by_name.items())]
        if absent:
            raise AssertionError(f"{path.tag}-profile: no device time for "
                                 f"{absent} (kernels: {sorted(by_name)})")
        ms = sum(v for n, v in by_name.items()
                 if any(k in n for k in keys)) / steps
        shares[f"{label}_ms_per_step"] = ms
        shares[f"{label}_share_of_device_time"] = ms / busy if busy else None
    emit(f"{path.tag}-profile-shares", device_busy_ms_per_step=busy,
         **shares)


def phase_rgemma_reference() -> None:
    """A reduced float32 RecurrentGemma ("RRA", d=256) widened to MQA at
    head_dim 256, local window 32, on the card against the same weights on
    the CPU over a 45-token prompt: prefill, a [1+4] span with staged h
    and conv, within 1e-3 of max|ref| (float32 sums in another order)."""
    cfg = dataclasses.replace(get_config(RGEMMA).reduced(), num_kv_heads=1,
                              head_dim=256)
    params = T.init_params(cfg, torch.Generator().manual_seed(SEED),
                           device="cpu")
    toks = torch.tensor(np.random.default_rng(SEED + 8).integers(
        3, cfg.vocab_size, (1, 50)), dtype=torch.int32)
    outs = []
    for dev in ("cpu", DEVICE):
        K.reset_launch_counts()
        p = _to(params, dev)
        cache = T.init_cache(cfg, 1, 64, device=dev)
        lo, cache, _ = T.prefill(cfg, p, toks[:, :45].to(dev), cache)
        lo2, c2, _, st = T.decode_step(cfg, p, cache, toks[:, 45:].to(dev))
        outs.append([t.float().cpu() for t in (lo, lo2, c2["h"], c2["conv"],
                                               st["h"], st["conv"])])
    names = ("prefill_logits", "span_logits", "h", "conv", "staged_h",
             "staged_conv")
    errs = {n: _rel_err(g, c) for n, g, c in zip(names, outs[1], outs[0])}
    emit("rgemma-reference", arch=cfg.name, dtype=cfg.dtype,
         head_dim=cfg.head_dim, kv_heads=cfg.num_kv_heads,
         local_window=cfg.local_window, prompt_len=45,
         max_abs_err={n: e for n, (e, _) in errs.items()},
         ref_max_abs={n: m for n, (_, m) in errs.items()},
         routes=K.route_counts(),
         tolerance="max|err| <= 1e-3*max|ref| per tensor")
    _check_routes("rgemma-reference", {"flash_attention": "simt",
                                       "decode_attention": "simt"})
    bad = {n: e for n, e in errs.items() if e[0] > 1e-3 * e[1]}
    if bad:
        raise AssertionError(f"card and CPU differ: {bad}")


# --------------------------------------------------------------------- #
# The dense configurations: StableLM-2 1.6B (head_dim 64), StableLM-2 3B
# (head_dim 80) and Minitron-4B (GQA 24/8, a group of 3), full width, their
# first DENSE_LAYERS layers, bf16
# --------------------------------------------------------------------- #

DENSE_ARCHS = ("stablelm-1.6b", "stablelm-3b", "minitron-4b")
DENSE_LAYERS = 8      # of 24, 32 and 32: full width, reduced depth
DENSE_NEW = 32
DENSE_SERVING = {"flash_attention": "wgmma", "decode_attention": "mma"}


def phase_dense_model(arch) -> dict:
    """One dense model at full width, cut to its first DENSE_LAYERS
    layers, bf16, random weights from the seed: a 512-token prefill, a `[1+4]` span and a 1-token pass, K3
    (the prefill) and K2 (both passes) held against their plain versions
    on their layer-0 inputs and timed beside SDPA; then `phase_engine`
    with 32 new tokens a prompt (K2 and K3 alone). The model is freed
    before returning. Returns the kernel cases by name."""
    t_phase = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=DENSE_LAYERS)
    tag = full.name
    dev = torch.device(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        SEED), device=DEVICE)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    t_params = time.perf_counter() - t_phase

    rng = np.random.default_rng(SEED)
    prompt = torch.tensor([_copy_prompt(rng, PROMPT_LEN, cfg.vocab_size)],
                          dtype=torch.int32, device=dev)
    span = torch.tensor([rng.integers(3, cfg.vocab_size, SPAN).tolist()],
                        dtype=torch.int32, device=dev)
    cache = T.init_cache(cfg, 1, MAX_LEN, device=dev)
    inputs, secs = {}, {}
    with _Recorder(T, "flash_attention") as rec_a:
        t0 = time.perf_counter()
        lo_pre, cache, _ = T.prefill(cfg, params, prompt, cache)
        torch.cuda.synchronize()
        secs["prefill"] = time.perf_counter() - t0
    inputs["flash_attention/prefill"] = rec_a.args
    finite = bool(torch.isfinite(lo_pre.float()).all())
    for name, t in ((f"t{SPAN}", SPAN), ("t1", 1)):
        c = {k: v.clone() for k, v in cache.items()}
        with _Recorder(T, "decode_attention", copy=(1, 2)) as rec_b:
            t0 = time.perf_counter()
            lo, _, _, _ = T.decode_step(cfg, params, c, span[:, :t])
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
        inputs[f"decode_attention/{name}"] = rec_b.args
        finite = finite and bool(torch.isfinite(lo.float()).all())
        del c
    del cache
    emit(f"dense-model:{tag}", arch=tag, params=cfg.param_count(),
         bytes=n_bytes, dtype=cfg.dtype, layers=cfg.num_layers,
         layers_of=full.num_layers, d_model=cfg.d_model, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
         head_dim=cfg.head_dim, params_s=t_params, pass_s=secs,
         logits_finite=finite,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    if not finite:
        raise AssertionError(f"{tag}: non-finite logits")
    cases = {}
    for key, (args, kw) in inputs.items():
        run = case_flash if key.startswith("flash") else case_decode
        cases[key] = run(args, kw)
        emit(f"dense-kernel:{tag}:{key}", **cases[key])
    del inputs

    phase_engine(cfg, params, phase=f"dense-engine:{tag}",
                 max_new=DENSE_NEW, kernels=DENSE_SERVING)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return cases


# --------------------------------------------------------------------- #
# Path 7: the MoEs not yet served on the card
# --------------------------------------------------------------------- #

#: arch, layers kept (None: the whole model), int8 routed experts
MOE_MODELS = (("deepseek-moe-16b", None, False),
              ("qwen15-moe-a2.7b", None, False),
              ("phi-3.5-moe", None, True),
              ("kimi-k2-1t-a32b", 3, True),       # one layer: 16.9 B experts
              ("deepseek-v2-236b", 6, False))
MOE_NEW = 32                # new tokens a request, both engines
MOE_SERVING_REQUESTS = 2    # ServingEngine, under each policy
MOE_BATCHED_REQUESTS = 4    # BatchedEngine(max_batch=4), one run
EXPERT_CHUNK = 32           # int8 experts drawn and quantized at once


def _int8_experts(cfg, gen, dtype, out: dict) -> None:
    """Draw one layer's routed experts at the whole stack's init scale
    1/sqrt(E), EXPERT_CHUNK experts at a time, and quantize each chunk
    into `out`'s int8 `w_*_q8` [E, ...] and float32 `w_*_s` [E] views of
    the stacked buffers (the scales are per expert, so a chunk gets the
    scales the whole stack would): a layer's bf16 experts never exist at
    once (Kimi-K2's are 33.8 GB, and quantizing makes float32 copies),
    nor does a layer's int8 copy beside the stacks."""
    e = cfg.num_experts
    for name in ("w_gate", "w_up", "w_down"):
        q8, scales = out[name + "_q8"], out[name + "_s"]
        for e0 in range(0, e, EXPERT_CHUNK):
            n = min(EXPERT_CHUNK, e - e0)
            w = L._dense_init(gen, (n,) + tuple(q8.shape[1:]), dtype,
                              DEVICE, scale=1.0 / math.sqrt(e))
            q8[e0:e0 + n], scales[e0:e0 + n] = quantize_int8(w)
            del w


def _int8_params(cfg) -> dict:
    """The model's params on the card from SEED with int8 routed experts
    and everything else in `cfg.dtype`, one layer at a time: each layer's
    experts go straight into their [L, E, ...] stacks (`_int8_experts`),
    its other leaves are copied into theirs. The draws come in
    `T.init_params`' order (a layer's attention, router, experts, shared
    experts), so with E <= EXPERT_CHUNK the codes are those of quantizing
    `T._init_block`'s experts."""
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    n_layers, e = cfg.num_layers, cfg.num_experts
    d, f = cfg.d_model, cfg.moe_d_ff
    stacks = {}
    for name, shape in (("w_gate", (d, f)), ("w_up", (d, f)),
                        ("w_down", (f, d))):
        stacks[name + "_q8"] = torch.empty((n_layers, e) + shape,
                                           dtype=torch.int8, device=DEVICE)
        stacks[name + "_s"] = torch.empty((n_layers, e), dtype=torch.float32,
                                          device=DEVICE)
    params = {"embed": L.init_embed(cfg, gen, dtype, DEVICE)}
    blocks: dict = {}
    for layer in range(n_layers):
        block = {"ln1": L.init_norm(cfg, d, dtype, DEVICE),
                 "attn": attn_mod.init_attention(cfg, gen, dtype, DEVICE),
                 "ln2": L.init_norm(cfg, d, dtype, DEVICE),
                 "moe": {"router": L._dense_init(gen, (d, e), dtype, DEVICE,
                                                 scale=0.02)}}
        _int8_experts(cfg, gen, dtype,
                      {k: v[layer] for k, v in stacks.items()})
        if cfg.num_shared_experts:
            block["moe"]["shared"] = L.init_mlp(
                cfg, gen, d, f * cfg.num_shared_experts, dtype, DEVICE)
        T._stack_into(blocks, block, layer, n_layers)
        del block
    blocks["moe"].update(stacks)
    params["blocks"] = blocks
    params["final_norm"] = L.init_norm(cfg, d, dtype, DEVICE)
    torch.cuda.synchronize()
    return params


def _bytes_by_dtype(tree) -> dict:
    by_type: dict = {}
    for t in _leaves(tree):
        k = str(t.dtype).replace("torch.", "")
        by_type[k] = by_type.get(k, 0) + t.numel() * t.element_size()
    return by_type


def phase_moe_params(cfg, int8: bool, tag: str) -> dict:
    """The model's params on the card from SEED, one layer at a time: bf16
    through `T.init_params`, or with int8 routed experts (`_int8_params`).
    `cfg` is the (cut) config that runs. The peak is this phase's own."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    if int8:
        params = _int8_params(cfg)
    else:
        params = T.init_params(cfg, torch.Generator(
            device=DEVICE).manual_seed(SEED), device=DEVICE)
        torch.cuda.synchronize()
    by_type = _bytes_by_dtype(params)
    emit(f"moe-params:{tag}", arch=cfg.name, layers=cfg.num_layers,
         params=cfg.param_count(), experts="int8" if int8 else "bf16",
         bytes=sum(by_type.values()), bytes_by_dtype=by_type,
         seconds=time.perf_counter() - t0,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    return params


def phase_moe_model(cfg, params, tag: str, int8: bool) -> dict:
    """A PROMPT_LEN-token prefill, a `[1+4]` span on both MoE branches and a
    1-token pass; the mean unique experts per layer at the span and at
    T=1 (their ratio is the span's verification cost in expert reads);
    each kernel's layer-0 inputs recorded: K3 at the prefill (MLA: v
    zero-padded to head_dim 192), K2 at both passes (not under MLA, whose
    decode is the absorbed form, plain PyTorch, whose layer-0 inputs are
    recorded and timed here instead), K1 or K4 at the packed span and
    T=1."""
    moe_name = "moe_gmm_fused_quant" if int8 else "moe_gmm_fused"
    attn_mod_of_k3 = mla_mod if cfg.use_mla else T
    rng = np.random.default_rng(SEED)
    dev = torch.device(DEVICE)
    prompt = torch.tensor([_copy_prompt(rng, PROMPT_LEN, cfg.vocab_size)],
                          dtype=torch.int32, device=dev)
    span = torch.tensor([rng.integers(3, cfg.vocab_size, SPAN).tolist()],
                        dtype=torch.int32, device=dev)
    cache = T.init_cache(cfg, 1, MAX_LEN, device=dev)
    inputs, secs, outs = {}, {}, {}
    with _Recorder(attn_mod_of_k3, "flash_attention") as rec_a:
        t0 = time.perf_counter()
        lo_pre, cache, _ = T.prefill(cfg, params, prompt, cache)
        torch.cuda.synchronize()
        secs["prefill"] = time.perf_counter() - t0
    inputs["flash_attention/prefill"] = rec_a.args
    for name, t, packed in ((f"t{SPAN}-dense", SPAN, False),
                            (f"t{SPAN}-packed", SPAN, True),
                            ("t1-packed", 1, True)):
        c = {k: v.clone() for k, v in cache.items()}
        recs = [_Recorder(moe_mod, moe_name)]
        if cfg.use_mla:   # args: cfg, p, h, pos, ckv, krope, cache_pos
            recs.append(_Recorder(mla_mod, "mla_absorbed", copy=(4, 5)))
        else:
            recs.append(_Recorder(T, "decode_attention", copy=(1, 2)))
        with contextlib.ExitStack() as stack:
            rec_m, rec_d = [stack.enter_context(r) for r in recs]
            t0 = time.perf_counter()
            lo, _, aux, _ = T.decode_step(cfg, params, c, span[:, :t],
                                          moe_packed=packed)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
        outs[name] = (lo.float(), aux)
        if packed:
            inputs[f"{moe_name}/{name}"] = rec_m.args
            inputs[f"{rec_d.name}/t{t}"] = rec_d.args
        del c
    del cache
    dense, packed_lo = outs[f"t{SPAN}-dense"][0], outs[f"t{SPAN}-packed"][0]
    finite = bool(torch.isfinite(lo_pre.float()).all() and all(
        torch.isfinite(o[0]).all() for o in outs.values()))
    uniq = outs[f"t{SPAN}-packed"][1]["unique_experts"].float()
    uniq1 = outs["t1-packed"][1]["unique_experts"].float()
    scale = float(dense.abs().max())
    emit(f"moe-model:{tag}", arch=cfg.name, layers=cfg.num_layers,
         prompt_len=PROMPT_LEN, span=SPAN, pass_s=secs,
         logits_finite=finite,
         packed_vs_dense_max_abs=float((packed_lo - dense).abs().max()),
         dense_logit_max_abs=scale,
         unique_experts_per_layer=uniq.tolist(),
         unique_experts_mean_span=float(uniq.mean()),
         unique_experts_mean_t1=float(uniq1.mean()),
         span_over_t1_expert_reads=float(uniq.mean() / uniq1.mean()),
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    if not finite:
        raise AssertionError(f"{tag}: non-finite logits")
    if uniq.tolist() != outs[f"t{SPAN}-dense"][1][
            "unique_experts"].float().tolist():
        raise AssertionError(f"{tag}: routing differs between the MoE "
                             "branches")
    if not torch.allclose(packed_lo, dense, atol=1e-2 * scale, rtol=1e-2):
        raise AssertionError(f"{tag}: packed logits differ from dense")
    k = cfg.experts_per_token
    if uniq1.tolist() != [k] * cfg.num_layers or not all(
            k <= u <= min(SPAN * k, cfg.num_experts) for u in uniq.tolist()):
        raise AssertionError(f"{tag}: unique experts per layer {uniq} at "
                             f"the span, {uniq1} at T=1")
    return inputs


def case_mla_absorbed(args, kw) -> dict:
    """The absorbed MLA decode of one layer (plain PyTorch, float32, no
    kernel of its own), timed on its recorded inputs: device ms from a
    CUDA graph, and the bound of the work it must do (the latent and RoPE
    caches of the live slots read once, the layer's MLA weights read once
    in bf16, the output written; the float32 products' operations at the
    float32 rate)."""
    cfg, p, h, pos, ckv, krope, cache_pos = args
    b, t, _ = h.shape
    heads, r = cfg.num_heads, cfg.kv_lora_rank
    nope, rope, vdim = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    live = int((cache_pos >= 0).sum())
    w_bytes = sum(v.numel() * v.element_size() for v in p.values())
    n_bytes = (live * (r + rope) * ckv.element_size() + w_bytes
               + 2 * h.numel() * h.element_size())
    q_ops = 2.0 * b * t * (cfg.d_model * cfg.q_lora_rank
                           + cfg.q_lora_rank * heads * (nope + rope)
                           if cfg.q_lora_rank
                           else cfg.d_model * heads * (nope + rope))
    n_ops = (q_ops + 2.0 * b * t * heads * (nope * r            # absorb
                                            + live / b * (r + rope)  # QK
                                            + live / b * r           # PV
                                            + r * vdim)
             + 2.0 * b * t * heads * vdim * cfg.d_model)         # wo
    bound_ms, bound_by = _bound(n_bytes, n_ops, F32_OPS_PER_S)

    def run():
        return mla_mod.mla_absorbed(*args, **kw)
    # device time from torch.profiler (the RoPE angles' host-made theta
    # keeps the plain form out of a CUDA graph)
    by_kernel = _kernel_ms(run)
    return dict(shape=f"h{list(h.shape)} latent cache{list(ckv.shape)} live "
                      f"slots {live} {h.dtype} (float32 inside)",
                ms=_time_ms(run), device_ms=sum(by_kernel.values()),
                device_ms_by_kernel=by_kernel, host_ms=_host_ms(run),
                bound_ms=bound_ms, bound_by=bound_by)


def phase_moe_kernels(tag, inputs) -> dict:
    """Each kernel of the model's path against its plain version on the
    recorded layer-0 inputs, timed with its bound and its library
    yardstick; under MLA, the absorbed decode timed instead of K2."""
    runners = {"flash_attention": case_flash, "decode_attention": case_decode,
               "moe_gmm_fused": case_moe,
               "moe_gmm_fused_quant": case_moe_quant,
               "mla_absorbed": case_mla_absorbed}
    cases = {}
    for key, (args, kw) in inputs.items():
        cases[key] = runners[key.split("/")[0]](args, kw)
        emit(f"moe-kernel:{tag}:{key}", **cases[key])
    return cases


def _engine_run_report(results, wall, launches, routes) -> dict:
    its = [it for r in results for it in r.telemetry.iterations]
    emitted = sum(it.tokens_emitted for it in its)
    return dict(tokens=sum(len(r.tokens) for r in results), passes=len(its),
                wall_s=wall, decode_tokens_per_s=emitted / wall,
                tokens_per_pass=emitted / len(its),
                drafted=sum(it.k_drafted for it in its),
                accepted=emitted - len(its),
                mean_k=sum(it.k_drafted for it in its) / len(its),
                utility_mean=float(np.mean([it.utility for it in its])),
                launches=launches, routes=routes)


def phase_moe_engines(cfg, params, tag: str, int8: bool,
                      kernels: tuple) -> dict:
    """`ServingEngine` under Cascade and static K=4 (MOE_SERVING_REQUESTS
    prompts each), then `BatchedEngine(max_batch=4, packed, joint
    planner)` under Cascade (MOE_BATCHED_REQUESTS prompts), MOE_NEW new
    tokens a prompt, greedy, wall clock, the unembedding restricted so the
    n-gram drafter proposes. Launch counts are set to 0 before each run
    and read after it: every kernel in `kernels` launched, no other, and
    no plain version ran. bf16 launches run on the tensor-core routes;
    int8 K4 takes `simt` only at a one-token pass (a ServingEngine pass
    with no draft). Returns the summed launch counts."""
    t_phase = time.perf_counter()
    prompts, params = _engine_workload(cfg, params, MOE_BATCHED_REQUESTS,
                                       ENGINE_PROMPT_LEN)
    expect = {"flash_attention": "wgmma", "decode_attention": "mma",
              "moe_gmm_fused": "wgmma"}
    report, total = {}, {n: 0 for n in K.KERNELS}
    runs = (("serving-cascade", CascadeController),
            ("serving-static-k4", lambda: StaticKController(4)),
            ("batched-cascade-joint", CascadeController))
    with _no_plain_versions() as plain_calls:
        for name, factory in runs:
            K.reset_launch_counts()
            t0 = time.perf_counter()
            if name.startswith("serving"):
                eng = ServingEngine(cfg, params, NGramDrafter(),
                                    controller_factory=factory,
                                    clock="wall", temperature=0.0,
                                    max_len=MAX_LEN, seed=SEED, device=DEVICE)
                results = [eng.generate(p, max_new=MOE_NEW,
                                        request_id=str(i))
                           for i, p in enumerate(
                               prompts[:MOE_SERVING_REQUESTS])]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            else:
                eng = BatchedEngine(
                    cfg, params, max_batch=MOE_BATCHED_REQUESTS,
                    controller_factory=factory, policy="joint", packed=True,
                    precision=cm.Precision.int8_experts() if int8 else None,
                    clock="wall", temperature=0.0, max_len=MAX_LEN,
                    seed=SEED, device=DEVICE)
                results, wall = _serve_batched(eng, prompts, MOE_NEW)
            launches, routes = K.launch_counts(), K.route_counts()
            for r in results:
                if len(r.tokens) != MOE_NEW or not all(
                        0 <= t < cfg.vocab_size for t in r.tokens):
                    raise AssertionError(f"{tag} {name}: bad output "
                                         f"{r.tokens}")
            report[name] = _engine_run_report(results, wall, launches,
                                              routes)
            missing = [n for n in kernels if launches[n] == 0]
            others = {n: c for n, c in launches.items()
                      if n not in kernels and c}
            off_route = {n: routes[n] for n in kernels if n in expect
                         and routes[n][expect[n]] != launches[n]}
            if int8 and name.startswith("batched"):
                q = "moe_gmm_fused_quant"
                if routes[q]["wgmma"] != launches[q]:
                    off_route[q] = routes[q]
            if missing or others or off_route:
                raise AssertionError(
                    f"{tag} {name}: kernels not launched {missing}, off the "
                    f"path {others}, off their routes {off_route}")
            if report[name]["drafted"] == 0:
                raise AssertionError(f"{tag} {name}: no drafted span")
            for n in total:
                total[n] += launches[n]
    emit(f"moe-engine:{tag}", arch=cfg.name, layers=cfg.num_layers,
         experts="int8" if int8 else "bf16", prompt_len=ENGINE_PROMPT_LEN,
         max_new=MOE_NEW, clock="wall", temperature=0.0, runs=report,
         plain_calls=plain_calls,
         peak_memory_bytes=torch.cuda.max_memory_allocated(),
         seconds=time.perf_counter() - t_phase)
    if any(plain_calls.values()):
        raise AssertionError(f"plain versions ran on the card: "
                             f"{plain_calls}")
    return total


def phase_moe_path() -> dict:
    """Path 7: each MoE of MOE_MODELS at full width, one after another (the
    last two cut in depth), each freed before the next: params, the model
    passes, the kernels against their plain versions, both engines.
    Returns {tag: (kernel cases, engine launches)}."""
    out = {}
    for arch, layers, int8 in MOE_MODELS:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        tag = cfg.name
        secs = {}
        params = phase_moe_params(cfg, int8, tag)
        peak_params = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        secs["params"] = time.perf_counter() - t0
        inputs = phase_moe_model(cfg, params, tag, int8)
        secs["model"] = time.perf_counter() - t0 - sum(secs.values())
        cases = phase_moe_kernels(tag, inputs)
        secs["kernels"] = time.perf_counter() - t0 - sum(secs.values())
        del inputs
        kernels = ("flash_attention",
                   "moe_gmm_fused_quant" if int8 else "moe_gmm_fused")
        if not cfg.use_mla:
            kernels += ("decode_attention",)
        launches = phase_moe_engines(cfg, params, tag, int8, kernels)
        secs["engines"] = time.perf_counter() - t0 - sum(secs.values())
        peak_run = torch.cuda.max_memory_allocated()
        peak = max(peak_params, peak_run)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        emit(f"moe-done:{tag}", arch=cfg.name, layers=cfg.num_layers,
             full_layers=get_config(arch).num_layers, launches=launches,
             peak_memory_bytes=peak, peak_params_bytes=peak_params,
             peak_run_bytes=peak_run, phase_seconds=secs,
             seconds=time.perf_counter() - t0)
        if peak >= 80e9:
            raise AssertionError(f"{tag}: peak memory {peak} over 80 GB")
        out[tag] = (cases, launches)
    return out


# --------------------------------------------------------------------- #
# Path 8: ChatGLM3-6B (2-D RoPE, GQA 32/2), Qwen2-VL-7B (M-RoPE over
# precomputed embeddings, GQA 28/4) and Whisper-large-v3 (cross-attention
# to 1500 encoder states, MHA 20/20 at head_dim 64), whole, bf16
# --------------------------------------------------------------------- #

FAMILY_ARCHS = ("chatglm3-6b", "qwen2-vl-7b", "whisper-large-v3")
FAMILY_NEW = 32             # new tokens a request, both engines
FAMILY_SERVING_REQUESTS = 2  # ServingEngine, under each policy
FAMILY_BATCHED_REQUESTS = 4  # BatchedEngine(max_batch=4), one run
FAMILY_GRID = 16            # Qwen2-VL's patch grid: 16 x 16 patches
WHISPER_CHUNK = 64          # the batched engine's chunk: the blocking fallback


def _family_prompt_len(cfg) -> int:
    """The model phase's prefill: Qwen2-VL's grid and as many text tokens,
    Whisper's ENGINE_PROMPT_LEN tokens, else PROMPT_LEN tokens."""
    if cfg.vision_stub:
        return 2 * FAMILY_GRID ** 2
    return ENGINE_PROMPT_LEN if cfg.is_encoder_decoder else PROMPT_LEN


@contextlib.contextmanager
def _cross_calls():
    """Count the K2 calls of cross-attention while the block runs:
    `attention.cross_attention` looks `decode_attention` up in
    `repro_torch.kernels` at call time, while the transformer's
    self-attention calls its own reference, so a counter put there sees
    the cross-attention calls alone."""
    wrapped = K.decode_attention
    calls = {"n": 0}

    def counting(*a, **kw):
        calls["n"] += 1
        return wrapped(*a, **kw)
    K.decode_attention = counting
    try:
        yield calls
    finally:
        K.decode_attention = wrapped


def _encoder_states(cfg, n: int, seed: int) -> list:
    """`n` encoder outputs [1, encoder_len, encoder_d_model] in the model's
    dtype, unit normal, drawn on the card from `seed`."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    return [torch.randn((1, cfg.encoder_len, cfg.encoder_d_model),
                        generator=gen, device=DEVICE).to(
                            getattr(torch, cfg.dtype)) for _ in range(n)]


def _grid_prefill_inputs(cfg, params, rng) -> tuple:
    """Qwen2-VL's multimodal prompt: FAMILY_GRID^2 random patch embeddings
    (scale 0.02, the token embeddings' init scale) on a grid, t fixed, h
    the row, w the column, then as many embedded text tokens, whose ids
    continue from the grid's largest id plus 1. Returns (embeds [1,T,d],
    rope_pos [3,1,T] int32)."""
    n_img = FAMILY_GRID ** 2
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    patches = (0.02 * torch.randn((1, n_img, cfg.d_model), generator=gen,
                                  device=DEVICE)).to(getattr(torch, cfg.dtype))
    text = torch.tensor([_copy_prompt(rng, n_img, cfg.vocab_size)],
                        dtype=torch.int32, device=DEVICE)
    embeds = torch.cat([patches, L.embed_tokens(params["embed"], text)], 1)
    idx = torch.arange(n_img, dtype=torch.int32, device=DEVICE)
    img = torch.stack([torch.zeros_like(idx), idx // FAMILY_GRID,
                       idx % FAMILY_GRID])
    txt = (FAMILY_GRID + torch.arange(n_img, dtype=torch.int32,
                                      device=DEVICE)).expand(3, n_img)
    return embeds, torch.cat([img, txt], 1)[:, None].contiguous()


def phase_family_model(cfg, params) -> tuple:
    """The model's prefill (ChatGLM: 512 tokens; Qwen2-VL: the 512-long
    grid-and-text prompt by `embeds=` under 3-D `rope_pos`; Whisper: 256
    tokens with its encoder output), then a `[1+4]` span and a 1-token
    pass; logits finite. Layer-0 inputs recorded: K3 at the prefill, K2's
    self-attention at both passes, and on Whisper K2's cross-attention at
    the prefill (T = the prompt) and at both passes, over the 1500
    encoder keys. Qwen2-VL: the 3-D positions must move the logits, and
    [B,T] positions broadcast to 3-D must give the text-only prefill's
    bits. Whisper: the cache's layer-0 encoder K/V must be the bits of
    `encode_cross_kv` of the encoder output, and the passes must leave
    them. Returns (recorded inputs, phase seconds by pass)."""
    tag, dev = cfg.name, torch.device(DEVICE)
    rng = np.random.default_rng(SEED)
    n = _family_prompt_len(cfg)
    kw, checks = {}, {}
    if cfg.vision_stub:
        embeds, rope_pos = _grid_prefill_inputs(cfg, params, rng)
        kw = dict(embeds=embeds, rope_pos=rope_pos)
        prompt = None
    else:
        prompt = torch.tensor([_copy_prompt(rng, n, cfg.vocab_size)],
                              dtype=torch.int32, device=dev)
    if cfg.is_encoder_decoder:
        kw["enc_out"] = _encoder_states(cfg, 1, SEED + 3)[0]
    span = torch.tensor([rng.integers(3, cfg.vocab_size, SPAN).tolist()],
                        dtype=torch.int32, device=dev)
    cache = T.init_cache(cfg, 1, MAX_LEN, device=dev)
    inputs, secs, finite = {}, {}, True
    recs = [_Recorder(T, "flash_attention")]
    if cfg.is_encoder_decoder:
        recs.append(_Recorder(K, "decode_attention", copy=(1, 2)))
    with contextlib.ExitStack() as stack:
        rec_a, *rec_x = [stack.enter_context(r) for r in recs]
        t0 = time.perf_counter()
        lo_pre, cache, _ = T.prefill(cfg, params, prompt, cache, **kw)
        torch.cuda.synchronize()
        secs["prefill"] = time.perf_counter() - t0
    inputs["flash_attention/prefill"] = rec_a.args
    if rec_x:
        inputs[f"decode_attention/cross-t{n}"] = rec_x[0].args
    finite = bool(torch.isfinite(lo_pre.float()).all())
    if cfg.vision_stub:
        # the text-only broadcast: [B,T] positions on t, h and w alike
        seq = torch.arange(n, dtype=torch.int32, device=dev)[None]
        outs = {}
        for name, pos in (("text", None), ("text-3d", seq.expand(3, 1, n))):
            c = T.init_cache(cfg, 1, MAX_LEN, device=dev)
            outs[name] = T.prefill(cfg, params, None, c, embeds=embeds,
                                   rope_pos=pos)[0][0, -1].float()
            del c
        checks["mrope_broadcast_bit_equal"] = bool(torch.equal(
            outs["text"], outs["text-3d"]))
        checks["mrope_moves_logits_max_abs"] = float(
            (outs["text"] - lo_pre[0, -1].float()).abs().max())
        if not checks["mrope_broadcast_bit_equal"] or \
                checks["mrope_moves_logits_max_abs"] == 0.0:
            raise AssertionError(f"{tag}: M-RoPE checks failed {checks}")
    if cfg.is_encoder_decoder:
        xp = {k: v[0] for k, v in params["blocks"]["xattn"].items()}
        enc_k0, enc_v0 = attn_mod.encode_cross_kv(cfg, xp, kw["enc_out"])
        checks["enc_kv_bit_equal"] = bool(
            torch.equal(cache["enc_k"][0, 0], enc_k0[0])
            and torch.equal(cache["enc_v"][0, 0], enc_v0[0]))
        if not checks["enc_kv_bit_equal"]:
            raise AssertionError(f"{tag}: the cache's encoder K/V are not "
                                 "encode_cross_kv's")
        enc_before = cache["enc_k"].clone()
    for name, t in ((f"t{SPAN}", SPAN), ("t1", 1)):
        c = {k: v.clone() for k, v in cache.items()}
        recs = [_Recorder(T, "decode_attention", copy=(1, 2))]
        if cfg.is_encoder_decoder:
            recs.append(_Recorder(K, "decode_attention", copy=(1, 2)))
        with contextlib.ExitStack() as stack:
            rec_b, *rec_x = [stack.enter_context(r) for r in recs]
            t0 = time.perf_counter()
            lo, c, _, _ = T.decode_step(cfg, params, c, span[:, :t])
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
        inputs[f"decode_attention/{name}"] = rec_b.args
        if rec_x:
            inputs[f"decode_attention/cross-{name}"] = rec_x[0].args
            if not torch.equal(c["enc_k"], enc_before):
                raise AssertionError(f"{tag}: a decode pass changed the "
                                     "encoder K/V")
        finite = finite and bool(torch.isfinite(lo.float()).all())
        del c
    del cache
    emit(f"family-model:{tag}", arch=tag, prompt_len=n, span=SPAN,
         rope_variant=cfg.rope_variant, pass_s=secs, logits_finite=finite,
         checks=checks, peak_memory_bytes=torch.cuda.max_memory_allocated())
    if not finite:
        raise AssertionError(f"{tag}: non-finite logits")
    return inputs, secs


def phase_family_engines(cfg, params) -> dict:
    """`ServingEngine` under Cascade and static K=4
    (FAMILY_SERVING_REQUESTS prompts of ENGINE_PROMPT_LEN each), then
    `BatchedEngine(max_batch=4)` under Cascade with the joint planner
    (FAMILY_BATCHED_REQUESTS prompts; Whisper's with chunk=WHISPER_CHUNK,
    where each request's encoder output sends it down the blocking
    prefill), FAMILY_NEW new tokens a prompt, greedy, wall clock, the
    unembedding restricted so the n-gram drafter proposes; Whisper's
    requests each with their own encoder output. Launch counts are set to
    0 before each run and read after it: K2 and K3 launched on their
    tensor-core routes, no other kernel, no plain version; K2's
    cross-attention calls counted apart (on Whisper at least one a pass
    and prefill, elsewhere none). Returns the runs' reports."""
    tag = cfg.name
    prompts, params = _engine_workload(cfg, params, FAMILY_BATCHED_REQUESTS,
                                       ENGINE_PROMPT_LEN)
    encs = (_encoder_states(cfg, len(prompts), SEED + 4)
            if cfg.is_encoder_decoder else None)
    chunk = WHISPER_CHUNK if cfg.is_encoder_decoder else 0
    report = {}
    runs = (("serving-cascade", CascadeController),
            ("serving-static-k4", lambda: StaticKController(4)),
            ("batched-cascade-joint", CascadeController))
    with _no_plain_versions() as plain_calls:
        for name, factory in runs:
            K.reset_launch_counts()
            with _cross_calls() as cross:
                t0 = time.perf_counter()
                if name.startswith("serving"):
                    eng = ServingEngine(cfg, params, NGramDrafter(),
                                        controller_factory=factory,
                                        clock="wall", temperature=0.0,
                                        max_len=MAX_LEN, seed=SEED,
                                        device=DEVICE)
                    results = [eng.generate(
                        p, max_new=FAMILY_NEW, request_id=str(i),
                        enc_out=None if encs is None else encs[i])
                        for i, p in enumerate(
                            prompts[:FAMILY_SERVING_REQUESTS])]
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                else:
                    eng = BatchedEngine(
                        cfg, params, max_batch=FAMILY_BATCHED_REQUESTS,
                        controller_factory=factory, policy="joint",
                        chunk=chunk, clock="wall", temperature=0.0,
                        max_len=MAX_LEN, seed=SEED, device=DEVICE)
                    results, wall = _serve_batched(eng, prompts, FAMILY_NEW,
                                                   encs=encs)
            launches, routes = K.launch_counts(), K.route_counts()
            for r in results:
                if len(r.tokens) != FAMILY_NEW or not all(
                        0 <= t < cfg.vocab_size for t in r.tokens):
                    raise AssertionError(f"{tag} {name}: bad output "
                                         f"{r.tokens}")
            rep = _engine_run_report(results, wall, launches, routes)
            rep["decode_attention_self"] = launches["decode_attention"] - \
                cross["n"]
            rep["decode_attention_cross"] = cross["n"]
            rep["prefill_chunks"] = sum(r.telemetry.prefill_chunks
                                        for r in results)
            report[name] = rep
            want = {"flash_attention": "wgmma", "decode_attention": "mma"}
            missing = [k for k in want if launches[k] == 0]
            others = {k: c for k, c in launches.items()
                      if k not in want and c}
            off_route = {k: routes[k] for k, r in want.items()
                         if routes[k][r] != launches[k]}
            # every pass and every prefill of an "X" stack cross-attends
            # once in each of its layers; no other stack does
            passes = len(results) + (len(eng.telemetry.steps)
                                     if name.startswith("batched")
                                     else rep["passes"])
            cross_ok = cross["n"] == (cfg.num_layers * passes
                                      if cfg.is_encoder_decoder else 0)
            if missing or others or off_route or not cross_ok:
                raise AssertionError(
                    f"{tag} {name}: kernels not launched {missing}, off the "
                    f"path {others}, off their routes {off_route}, "
                    f"cross-attention calls {cross['n']} for {passes} "
                    f"passes and prefills")
            if rep["drafted"] == 0:
                raise AssertionError(f"{tag} {name}: no drafted span")
            if rep["prefill_chunks"]:
                raise AssertionError(f"{tag} {name}: a prefill went by "
                                     "chunks")
    if any(plain_calls.values()):
        raise AssertionError(f"plain versions ran on the card: "
                             f"{plain_calls}")
    return report


def phase_family_path() -> dict:
    """Path 8: ChatGLM3-6B, Qwen2-VL-7B and Whisper-large-v3, each whole in
    bf16 from SEED, one after another, each freed before the next: params,
    the model passes, K2/K3 against their plain versions on the recorded
    inputs (timed beside SDPA), both engines. Returns {tag: (kernel
    cases, engine reports)}."""
    out = {}
    for arch in FAMILY_ARCHS:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        tag = cfg.name
        secs = {}
        torch.cuda.reset_peak_memory_stats()
        params = T.init_params(cfg, torch.Generator(
            device=DEVICE).manual_seed(SEED), device=DEVICE)
        torch.cuda.synchronize()
        n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        peak_params = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        secs["params"] = time.perf_counter() - t0
        emit(f"family-params:{tag}", arch=tag, params=cfg.param_count(),
             bytes=n_bytes, dtype=cfg.dtype, layers=cfg.num_layers,
             d_model=cfg.d_model, heads=cfg.num_heads,
             kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
             seconds=secs["params"], peak_memory_bytes=peak_params)
        inputs, pass_s = phase_family_model(cfg, params)
        secs["model"] = time.perf_counter() - t0 - sum(secs.values())
        cases = {}
        for key, (args, kw) in inputs.items():
            run = case_flash if key.startswith("flash") else case_decode
            cases[key] = run(args, kw)
            emit(f"family-kernel:{tag}:{key}", **cases[key])
        del inputs
        secs["kernels"] = time.perf_counter() - t0 - sum(secs.values())
        engines = phase_family_engines(cfg, params)
        secs["engines"] = time.perf_counter() - t0 - sum(secs.values())
        peak_run = torch.cuda.max_memory_allocated()
        del params
        gc.collect()
        torch.cuda.empty_cache()
        emit(f"family-done:{tag}", arch=tag, layers=cfg.num_layers,
             bytes=n_bytes, pass_s=pass_s, engines=engines,
             peak_params_bytes=peak_params, peak_run_bytes=peak_run,
             phase_seconds=secs, seconds=time.perf_counter() - t0)
        if max(peak_params, peak_run) >= 80e9:
            raise AssertionError(f"{tag}: peak memory over 80 GB")
        out[tag] = (cases, engines)
    return out


# --------------------------------------------------------------------- #
# Training every family the port serves: RWKV-6-3B and RecurrentGemma-9B
# whole (paths 4 and 5, on the serving phases' params), DeepSeek-V2-236B
# at 2 of 60 layers (after path 7) and Whisper-large-v3 whole (after path
# 8); the card against the CPU on 2-layer float32 copies; the two
# recurrences' backward kernels; the train launcher on each family
# --------------------------------------------------------------------- #

FAMILY_TRAIN_STEPS = 3
# Adafactor moves each weight by about lr a step. At path 3's 1e-3 the
# whole RecurrentGemma and Whisper overshoot on their second step; at 1e-4
# the whole Whisper still does, in float32 as in bf16 (its 2-layer
# gradients equal to the CPU's), so it takes 1e-5
FAMILY_TRAIN_LR = {RWKV: 1e-4, RGEMMA: 1e-4, "deepseek-v2-236b": 1e-4,
                   "whisper-large-v3": 1e-5}
#: (batch, tokens) of each family's training phase
FAMILY_TRAIN_SHAPES = {RWKV: (1, 512), RGEMMA: (1, 512),
                       "deepseek-v2-236b": (1, 256),
                       "whisper-large-v3": (2, 256)}
DSV2_TRAIN_LAYERS = 2       # of 60: a layer's 160 experts are 7.5 GB in bf16
GRADS_SEQ = 64
# RecurrentGemma's copy runs past its 2048-token window, with the
# vocabulary cut to 4096: the full unembedding's 2112 x 256000 x 4096
# float32 products would take the CPU most of a minute, and neither
# recurrence nor the window reads it
RG_GRADS_SEQ = 2112
GRADS_VOCAB = 4096
# DeepSeek-V2's copy keeps 16 of its 160 experts (top-6, 2 shared, full
# widths): 160 float32 experts a layer would be 15 GB on the CPU; its
# vocabulary is cut as RecurrentGemma's (the 2 x 102400 x 5120 float32
# embedding parameters, drawn and differentiated on the CPU too, touch
# neither MLA nor the experts)
DSV2_GRADS_EXPERTS = 16
#: the backward kernels' seeded cases, beside the shape the main path gave
BWD_SEEDED = {"rwkv_scan_bwd": (4, 32, 40, 64),
              "linear_scan_bwd": (4, 32, 4096)}


def _family_batch(cfg, b: int, t: int, seed: int) -> dict:
    """One "all-3" batch [b, t] (tokens and labels) on the card, and an
    encoder-decoder config's seeded encoder states [b, 1500, d_enc]."""
    raw = next(batch_iterator("all-3", b, t, vocab=cfg.vocab_size,
                              seed=seed))
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in raw.items()}
    if cfg.is_encoder_decoder:
        batch["enc_out"] = torch.cat(_encoder_states(cfg, b, seed))
    return batch


def _family_kernels(cfg, steps: int) -> dict:
    """Launches a family's training steps must make: kernel -> count (None:
    at least one). Every other kernel must stay at 0."""
    kinds = cfg.layer_kinds()
    n = {k: kinds.count(k) * steps for k in set(kinds)}
    if "W" in n:
        return {"rwkv_scan": n["W"], "rwkv_scan_bwd": n["W"]}
    if "R" in n:
        return {"linear_scan": n["R"], "linear_scan_bwd": n["R"],
                "flash_attention": n["A"]}
    out = {"flash_attention": cfg.num_layers * steps}
    if cfg.is_encoder_decoder:
        out["decode_attention"] = cfg.num_layers * steps
    if cfg.is_moe:
        out["moe_gmm"] = None
    return out


def _check_launches(phase, launches, want) -> None:
    """Each kernel of `want` launched as often as it names (None: at least
    once), every other kernel not at all."""
    bad = {n: c for n, c in launches.items()
           if (n not in want and c) or (n in want and (
               c == 0 if want[n] is None else c != want[n]))}
    if bad:
        raise AssertionError(f"{phase}: launches {bad}, expected {want}")


def phase_train_family(cfg, params, recorders=()) -> dict:
    """FAMILY_TRAIN_STEPS Adafactor steps of `cfg` at full width in bf16 on
    `params` (updated in place) over one repeated batch: the loss must be
    finite and fall, peak memory stay under 80 GB, every kernel the family
    runs launch once per layer per step (the two recurrences' backward
    kernels included), no other launch, and no plain version run (the
    plain attention backward is the card's path). `recorders` (context
    managers) are entered around the steps. Returns the launch counts."""
    t0 = time.perf_counter()
    b, t = FAMILY_TRAIN_SHAPES[cfg.name]
    batch = _family_batch(cfg, b, t, SEED)
    lr = FAMILY_TRAIN_LR[cfg.name]
    opt = make_optimizer("adafactor", lr)
    _, step = make_train_step(cfg, optimizer=opt)
    torch.cuda.reset_peak_memory_stats()
    state = (params, opt.init(params))
    steps = []
    K.reset_launch_counts()
    with contextlib.ExitStack() as stack:
        plain_calls = stack.enter_context(_no_plain_versions())
        for rec in recorders:
            stack.enter_context(rec)
        for _ in range(FAMILY_TRAIN_STEPS):
            t1 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            steps.append(dict({k: float(v) for k, v in m.items()},
                              seconds=time.perf_counter() - t1))
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for rec in recorders:
        # a recorded tensor's autograd graph ends in the parameters' leaf
        # nodes: kept, it would keep every parameter of the model alive
        rec.calls = {key: ([a.detach() if torch.is_tensor(a) else a
                            for a in args],
                           {n: v.detach() if torch.is_tensor(v) else v
                            for n, v in kw.items()})
                     for key, (args, kw) in rec.calls.items()}
        rec.args = next(iter(rec.calls.values()), None)
    want = _family_kernels(cfg, FAMILY_TRAIN_STEPS)
    emit(f"train-family:{cfg.name}", arch=cfg.name, layers=cfg.num_layers,
         full_layers=get_config(cfg.name).num_layers, dtype=cfg.dtype,
         batch=b, seq=t, optimizer="adafactor", lr=lr,
         param_bytes=sum(x.numel() * x.element_size()
                         for x in _leaves(params)),
         steps=steps, launches=launches, routes=K.route_counts(),
         expected_launches=want, plain_calls=plain_calls,
         peak_memory_bytes=peak, seconds=time.perf_counter() - t0)
    losses = [x["loss"] for x in steps]
    if not all(np.isfinite(v) for x in steps for v in x.values()):
        raise AssertionError(f"{cfg.name}: non-finite metrics {steps}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{cfg.name}: the loss did not fall on a "
                             f"repeated batch: {losses}")
    if any(plain_calls.values()):
        raise AssertionError(f"{cfg.name}: plain versions ran on the card: "
                             f"{plain_calls}")
    _check_launches(f"train-family:{cfg.name}", launches, want)
    _check_routes(f"train-family:{cfg.name}", {
        n: r for n, r in (("flash_attention", "wgmma"),
                          ("decode_attention", "mma"),
                          ("moe_gmm", "wgmma")) if n in want})
    if peak >= 80e9:
        raise AssertionError(f"{cfg.name}: peak memory {peak} over 80 GB")
    return launches


def phase_train_dsv2() -> tuple:
    """Path 7's training: DeepSeek-V2-236B at DSV2_TRAIN_LAYERS of its 60
    layers in bf16 (MLA through K3 at head_dim 192 with lse, v zero-padded;
    the 160 experts top-6 through K5), built after the serving runs are
    freed. Returns K3's first call with lse (args, keywords)."""
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"),
                              num_layers=DSV2_TRAIN_LAYERS)
    params = T.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        SEED), device=DEVICE)
    rec = _Recorder(flash_ops, "flash_attention",
                    key=lambda a, kw: kw.get("lse", False))
    phase_train_family(cfg, params, (rec,))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return rec.calls[True]


def phase_train_whisper() -> None:
    """Path 8's training: Whisper-large-v3 whole in bf16 on [2,256] with
    seeded encoder states [2,1500,1280] (cross-attention's forward on K2,
    its backward the plain attention backward)."""
    cfg = get_config("whisper-large-v3")
    params = T.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(
        SEED), device=DEVICE)
    phase_train_family(cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def _grads_cfg(arch):
    """The 2-layer float32 copy of `arch` at full width that the card is
    held to the CPU on (RecurrentGemma's: one "R" and one "A" layer)."""
    kw = dict(num_layers=WHOLE_LAYERS, dtype="float32")
    if arch == RGEMMA:
        kw.update(layer_pattern="RA", vocab_size=GRADS_VOCAB)
    if arch == "deepseek-v2-236b":
        kw.update(num_experts=DSV2_GRADS_EXPERTS, vocab_size=GRADS_VOCAB)
    return dataclasses.replace(get_config(arch), **kw)


def _train_against_cpu(phase, cfg, batch, routes, **rec) -> None:
    """One float32 loss and gradient of `cfg` (random params from SEED) on
    the card (the kernels) against the same weights and batch on the CPU
    (plain versions): loss within 1e-4 relative, grad norm within 1e-3
    relative, every leaf's gradient within 1e-3 * max|g_cpu| + 1e-6; the
    tokens routed to other experts are counted. `routes`: the route each
    named kernel must take."""
    params = T.init_params(cfg, torch.Generator().manual_seed(SEED),
                           device="cpu")
    t0 = time.perf_counter()
    c_loss, c_grads, c_routes = _loss_and_grads(cfg, params, batch, "cpu")
    cpu_s = time.perf_counter() - t0
    K.reset_launch_counts()
    t0 = time.perf_counter()
    g_loss, g_grads, g_routes = _loss_and_grads(cfg, _to(params, DEVICE),
                                                batch, DEVICE)
    card_s = time.perf_counter() - t0
    launches = K.launch_counts()
    c_norm, g_norm = float(global_norm(c_grads)), float(global_norm(g_grads))
    ratios = [float((g - c).abs().max()) / (1e-3 * float(c.abs().max())
                                            + 1e-6)
              for g, c in zip(g_grads, c_grads)]
    # a token's experts as a set: two near-equal probabilities may swap
    # places inside its top-k, which changes no slot and no gradient
    moved = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                for a, b in zip(g_routes, c_routes))
    emit(phase, arch=cfg.name, layers=cfg.num_layers,
         kinds="".join(cfg.layer_kinds()), dtype=cfg.dtype,
         batch=list(batch["tokens"].shape), loss_cpu=c_loss,
         loss_card=g_loss, grad_norm_cpu=c_norm, grad_norm_card=g_norm,
         worst_leaf_share_of_grad_limit=max(ratios),
         max_grad_abs_err=max(float((g - c).abs().max())
                              for g, c in zip(g_grads, c_grads)),
         tokens_routed_to_other_experts=moved,
         tokens_with_reordered_top_k=sum(
             int((a != b).any(-1).sum()) for a, b in zip(g_routes, c_routes)),
         launches=launches, routes=K.route_counts(), cpu_s=cpu_s,
         card_s=card_s,
         tolerance="loss 1e-4 rel, grad norm 1e-3 rel, each leaf "
                   "max|dg| <= 1e-3*max|g_cpu| + 1e-6", **rec)
    _check_launches(phase, launches, _family_kernels(cfg, 1))
    if abs(g_loss - c_loss) > 1e-4 * abs(c_loss):
        raise AssertionError(f"{phase}: loss: card {g_loss}, CPU {c_loss}")
    if abs(g_norm - c_norm) > 1e-3 * c_norm:
        raise AssertionError(f"{phase}: grad norm: card {g_norm}, CPU "
                             f"{c_norm}")
    if max(ratios) > 1.0:
        raise AssertionError(f"{phase}: a gradient leaf differs: "
                             f"{max(ratios)} of its limit")
    _check_routes(phase, routes)


def phase_train_grads() -> None:
    """`train-grads:<arch>`: each family's 2-layer float32 copy at full
    width (`_grads_cfg`) on the card against the CPU, at GRADS_SEQ tokens
    (RecurrentGemma's at RG_GRADS_SEQ, past its window)."""
    for arch in FAMILY_TRAIN_SHAPES:
        cfg = _grads_cfg(arch)
        t = RG_GRADS_SEQ if arch == RGEMMA else GRADS_SEQ
        raw = next(batch_iterator("all-3", 1, t, vocab=cfg.vocab_size,
                                  seed=SEED))
        batch = dict(raw)
        if cfg.is_encoder_decoder:
            batch["enc_out"] = np.random.default_rng(SEED).standard_normal(
                (1, cfg.encoder_len, cfg.encoder_d_model)).astype(np.float32)
        routes = {n: "simt" for n in _family_kernels(cfg, 1)
                  if n in ("flash_attention", "decode_attention", "moe_gmm")}
        _train_against_cpu(f"train-grads:{arch}", cfg, batch, routes,
                           seq=t, vocab=cfg.vocab_size,
                           experts=cfg.num_experts if cfg.is_moe else None)


def case_scan_bwd(args, kw) -> dict:
    """K6b against its plain version: dr, dk, dv, dw, du and ds0 each within
    1e-4 * max|ref| + 1e-6 (float32 sums over N products and T steps in
    another order, fused multiply-adds on the card); dy is scaled by a
    power of two to unit size first (exact; the backward is linear in it).
    Times by CUDA events (`ms`, `plain_ms`) and by CUDA graph
    (`device_ms`); the bound counts r, k, v, w, dy and the chunk
    checkpoints read and the six outputs written once, and ~12 N*N float32
    operations per (token, row, head): the states recomputed, the
    adjoint's update and the four sums."""
    r, k, v, w, u, s0, dy = args[:7]
    ds_last = args[7] if len(args) > 7 else None
    ckpt = kw.get("ckpt")
    if ckpt is None:
        _, _, ckpt = K.rwkv_scan(r, k, v, w, u, s0, checkpoints=True)
    dy = _unit(dy)
    b, t, h, n = r.shape

    def run():
        return K.rwkv_scan_bwd(r, k, v, w, u, s0, dy, ds_last, ckpt=ckpt)
    got, again = run(), run()
    torch.cuda.synchronize()
    ref = K.rwkv_scan_bwd_plain(r, k, v, w, u, s0, dy, ds_last)
    chk = {name: _err_line(f"rwkv_scan_bwd {name}", g, c, rtol=1e-4)
           for name, g, c in zip(("dr", "dk", "dv", "dw", "du", "ds0"),
                                 got, ref)}
    n_bytes = 4 * (9 * r.numel() + ckpt.numel() + h * n
                   + (2 + (ds_last is not None)) * b * h * n * n)
    bound_ms, bound_by = _bound(n_bytes, 12.0 * b * t * h * n * n,
                                F32_OPS_PER_S)
    return dict(
        shape=f"[B,T,H,N] {list(r.shape)}", checkpoints=list(ckpt.shape),
        **chk, max_abs_err=max(c["max_abs_err"] for c in chk.values()),
        repeat_bit_equal=_repeat_equal("rwkv_scan_bwd", got, again),
        tolerance="each output: max|err| <= 1e-4*max|ref| + 1e-6",
        ms=_time_ms(run, iters=10), device_ms=_graph_ms(run, iters=5),
        plain_ms=_time_ms(lambda: K.rwkv_scan_bwd_plain(
            r, k, v, w, u, s0, dy, ds_last), iters=2, warmup=1),
        bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes,
        library_ms=None,
        library="none: no single PyTorch call computes this recurrence")


def case_linear_scan_bwd(args, kw) -> dict:
    """K7b against its plain version: da, dx and dh0 equal bit for bit (each
    step a product, then a sum, in the plain loop's order). Times as
    `case_scan_bwd`; the bound counts a, y, dy read and da, dx written
    once, 3 float32 operations per element."""
    a, y, h0, dy = args[:4]
    dh_last = args[4] if len(args) > 4 else None
    b, t, d = a.shape

    def run():
        return K.linear_scan_bwd(a, y, h0, dy, dh_last)
    got = run()
    torch.cuda.synchronize()
    ref = K.linear_scan_bwd_plain(a, y, h0, dy, dh_last)
    exact = all(torch.equal(g, c) for g, c in zip(got, ref))
    err = max(_rel_err(g, c)[0] for g, c in zip(got, ref))
    if not exact:
        raise AssertionError(f"linear_scan_bwd {list(a.shape)}: not "
                             f"bit-exact (max|err| {err})")
    n_bytes = 4 * (5 * a.numel() + (2 + (dh_last is not None)) * b * d)
    bound_ms, bound_by = _bound(n_bytes, 3.0 * a.numel(), F32_OPS_PER_S)
    return dict(
        shape=f"[B,T,D] {list(a.shape)}", max_abs_err=err, bit_exact=exact,
        tolerance="bit-exact", ms=_time_ms(run), device_ms=_graph_ms(run),
        plain_ms=_time_ms(lambda: K.linear_scan_bwd_plain(
            a, y, h0, dy, dh_last), iters=3, warmup=1),
        bound_ms=bound_ms, bound_by=bound_by, bytes=n_bytes,
        library_ms=None,
        library="none: no single PyTorch call computes this recurrence")


def _seeded_scan_bwd(b, t, h, n, seed) -> tuple:
    """`_seeded_scan`'s inputs with a unit-normal dy and no gradient for
    the last state."""
    (r, k, v, w, u, s0), _ = _seeded_scan(b, t, h, n, seed, states=False)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 100)
    return (r, k, v, w, u, s0, torch.randn(r.shape, generator=g,
                                           device=DEVICE)), {}


def _seeded_linear_scan_bwd(b, t, d, seed) -> tuple:
    """`_seeded_linear_scan`'s inputs run forward for y, a unit-normal dy
    and no gradient for the last state."""
    (a, x, h0), _ = _seeded_linear_scan(b, t, d, seed)
    y, _ = K.linear_scan(a, x, h0)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 100)
    return (a, y, h0, torch.randn(a.shape, generator=g, device=DEVICE)), {}


def phase_train_bwd_kernels(recorded: dict) -> dict:
    """`train-kernel:<kernel>/...`: K6b and K7b against their plain
    versions on the inputs the training steps gave them (the first call,
    the last layer's, of the first step; recorded by `_Recorder`) and on
    seeded inputs at the [4,32] shapes of the batched engine's chunk
    passes. Returns the cases by key, and under each kernel's own name
    its case on the training step's inputs."""
    cases = {}
    run = {"rwkv_scan_bwd": case_scan_bwd,
           "linear_scan_bwd": case_linear_scan_bwd}
    for name, (args, kw) in recorded.items():
        key = f"{name}/train-" + "x".join(map(str, args[0].shape))
        cases[key] = cases[name] = run[name](
            [a.detach() if torch.is_tensor(a) else a for a in args], kw)
        emit(f"train-kernel:{key}", **cases[key])
    for name, shape in BWD_SEEDED.items():
        make = (_seeded_scan_bwd if name == "rwkv_scan_bwd"
                else _seeded_linear_scan_bwd)
        args, kw = make(*shape, SEED + 9)
        key = f"{name}/seeded-" + "x".join(map(str, shape))
        cases[key] = run[name](args, kw)
        emit(f"train-kernel:{key}", **cases[key])
    return cases


TRAIN_LAUNCHER_ARCHS = (RWKV, RGEMMA, "deepseek-v2-236b", "whisper-large-v3",
                        "qwen2-vl-7b")


def phase_train_launcher() -> None:
    """`python -m repro_torch.launch.train --arch <arch> --steps 2`, called
    as a user would, without --device: the reduced config on the card
    (float32, the CUDA-core routes), with its batch built as the JAX
    package's launcher builds it (zero encoder states for Whisper, zero
    patch embeddings for Qwen2-VL). The losses must be finite, every
    kernel the family runs must launch, and no plain version run."""
    from repro_torch.launch import train

    out = {}
    for arch in TRAIN_LAUNCHER_ARCHS:
        argv = ["--arch", arch, "--steps", "2", "--batch", "2", "--seq",
                "64"]
        K.reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with _no_plain_versions() as plain_calls, \
                contextlib.redirect_stdout(buf):
            rc = train.main(argv)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        lines = buf.getvalue().splitlines()
        losses = [float(line.split()[3]) for line in lines
                  if line.startswith("step")]
        want = _family_kernels(get_config(arch).reduced(), 2)
        out[arch] = dict(argv=argv, rc=rc, output=lines, losses=losses,
                         launches=launches, plain_calls=plain_calls,
                         seconds=time.perf_counter() - t0)
        if rc != 0 or len(losses) != 2 or not all(map(np.isfinite, losses)):
            raise AssertionError(f"train launcher {arch}: rc {rc}, output "
                                 f"{lines}")
        if "cuda" not in lines[0] or any(plain_calls.values()):
            raise AssertionError(f"train launcher {arch}: not on the card "
                                 f"through the kernels: {lines[0]}, "
                                 f"{plain_calls}")
        if any(launches[n] == 0 for n in want):
            raise AssertionError(f"train launcher {arch}: launches "
                                 f"{launches}, expected {list(want)}")
    emit("train-launcher", runs=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every phase's record to this JSON file")
    args = ap.parse_args(argv)
    try:
        return _run(args)
    finally:
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(RESULTS, indent=1))


def _run(args) -> int:
    t_start = time.perf_counter()
    laps = {}

    def lap(name):
        """Seconds since the previous lap (the first: since the start)."""
        laps[name] = time.perf_counter() - t_start - sum(laps.values())

    dev = phase_device()
    phase_build()
    lap("device and build")

    # path 1: OLMoE-1B-7B, bf16, the single-request engine (K1-K3)
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = T.init_params(cfg, gen, device=DEVICE)
    torch.cuda.synchronize()
    emit("params", arch=cfg.name, params=cfg.param_count(),
         bytes=sum(t.numel() * t.element_size() for t in _leaves(params)),
         seconds=time.perf_counter() - t0)
    inputs = phase_model(cfg, params)
    cases = phase_kernels(inputs)
    phase_reference()
    launches = phase_engine(cfg, params)
    phase_profile(cfg, params)
    t_ep = time.perf_counter()
    probe, _ = phase_ep_dispatch(cfg, _ep_inputs(cfg, params))
    phase_ep_engine(cfg, params, probe)
    emit("ep-path", seconds=time.perf_counter() - t_ep)
    del params, inputs
    gc.collect()
    torch.cuda.empty_cache()
    lap("path 1")

    # path 2: Mixtral-8x7B, int8 experts, the batched engine (K2-K4)
    mcfg = get_config(MIXTRAL)
    mparams = phase_mixtral_params(mcfg)
    minputs = phase_mixtral_model(mcfg, mparams)
    mcases = phase_mixtral_kernels(minputs)
    del minputs
    mlaunches = phase_mixtral_engine(mcfg, mparams)
    cinputs = phase_mixtral_load(mcfg, mparams)
    mcases.update(phase_mixtral_kernels(cinputs, tuple(cinputs)))
    del cinputs
    phase_mixtral_offload(mcfg, mparams)
    phase_mixtral_profile(mcfg, mparams)
    phase_mixtral_drafter(mcfg, mparams)
    del mparams
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve_launcher()
    lap("path 2")

    # path 3: training OLMoE-1B-7B (K5, K3 with lse), then serving a model
    # the port trained
    params, opt_state, opt = phase_train_params(cfg)
    state, batch, tlaunches, calls5, calls3 = phase_train_step(
        cfg, params, opt_state, opt)
    del params, opt_state
    tcases = phase_train_kernels(cfg, calls5, calls3)
    del calls5, calls3
    phase_train_profile(cfg, state, batch, opt)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    # the same model and batch through the expert-parallel dispatch (K5 on
    # the receive buffer), then its float32 gradients against the CPU's
    ep_calls5 = phase_ep_train(cfg, batch)
    gc.collect()
    torch.cuda.empty_cache()
    phase_ep_train_grads(ep_calls5)
    del ep_calls5
    phase_train_whole(batch)
    tcfg, tparams = phase_target_train()
    ngram = phase_serve_trained(tcfg, tparams)
    phase_serve_trained_bf16(tcfg, tparams)
    phase_drafter_trained(tcfg, tparams, ngram)
    del tparams
    gc.collect()
    torch.cuda.empty_cache()
    lap("path 3")

    # path 4: RWKV-6-3B, bf16, both engines (K6); path 5: RecurrentGemma-9B,
    # bf16, both engines (K7; K2, K3 at head_dim 256)
    scans, bwd_calls, family_launches, lse_calls = {}, {}, {}, {}
    for arch, make_path in ((RWKV, _rwkv_path), (RGEMMA, _rgemma_path)):
        rcfg = get_config(arch)
        path = make_path(rcfg)
        rparams = phase_recurrent_params(rcfg, path)
        rinputs = phase_recurrent_model(rcfg, rparams, path)
        if path.reference is not None:
            path.reference()
        rlaunches, rchunk = phase_recurrent_engine(rcfg, rparams, path)
        rcases = phase_recurrent_kernels(path, {**rinputs, **rchunk})
        del rinputs, rchunk
        phase_recurrent_profile(rcfg, rparams, path)
        # training on the same params: the recurrence's forward and
        # backward kernels, the backward's first call recorded
        bwd = "rwkv_scan_bwd" if arch == RWKV else "linear_scan_bwd"
        rec = _Recorder(rwkv_ops if arch == RWKV else scan_ops, bwd)
        rec3 = _Recorder(flash_ops, "flash_attention",
                         key=lambda a, kw: kw.get("lse", False))
        family_launches[bwd] = phase_train_family(rcfg, rparams, (rec, rec3))
        bwd_calls[bwd] = rec.args
        if True in rec3.calls:      # RecurrentGemma's windowed local layers
            lse_calls["rgemma-window"] = rec3.calls[True]
        del rparams, rec, rec3
        gc.collect()
        torch.cuda.empty_cache()
        scans[path.scan[1]] = (rcases[f"{path.scan[1]}/t{SPAN}"], rlaunches)
    lap("paths 4 and 5")

    # path 6: the dense configurations at full width and 8 layers, one
    # after another (K2, K3 at head_dim 64, 80 and 128)
    for arch in DENSE_ARCHS:
        phase_dense_model(arch)
    lap("path 6")

    # path 7: the MoEs not yet served on the card, at full width (K1-K4;
    # K3 at head_dim 192 for DeepSeek-V2's MLA prefill)
    phase_moe_path()
    lse_calls["mla192"] = phase_train_dsv2()
    lap("path 7")

    # path 8: ChatGLM3-6B, Qwen2-VL-7B and Whisper-large-v3, whole (K2, K3;
    # K2 also as Whisper's cross-attention)
    phase_family_path()
    phase_train_whisper()
    lap("path 8")

    # training every family: the card against the CPU on 2-layer float32
    # copies, the backward kernels against their plain versions, K3's lse
    # at MLA's head_dim 192, the train launcher
    phase_train_grads()
    bcases = phase_train_bwd_kernels(bwd_calls)
    for key, (args3, kw3) in lse_calls.items():
        emit(f"train-kernel:flash_attention/lse-{key}",
             **case_flash_lse([a.detach() for a in args3], kw3))
    del bwd_calls, lse_calls
    phase_train_launcher()
    lap("training checks")
    emit("paths", seconds=laps, total_s=time.perf_counter() - t_start)

    # each kernel's numbers from the path it was written for: launches from
    # that path's engine run (K5: the training steps), times at the shape
    # of its main pass
    main_case = {"flash_attention": (cases["flash_attention"], launches),
                 "decode_attention": (cases["decode_attention/t5"],
                                      launches),
                 "moe_gmm_fused": (cases["moe_gmm_fused/t5-dense"],
                                   launches),
                 "moe_gmm_fused_quant": (
                     mcases[f"moe_gmm_fused_quant/t{MIX_BATCH * SPAN}-packed"],
                     mlaunches),
                 "moe_gmm": (tcases["moe_gmm/gate-up"], tlaunches),
                 **scans,
                 **{name: (bcases[name], family_launches[name])
                    for name in ("rwkv_scan_bwd", "linear_scan_bwd")}}
    line = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        c, counts = main_case[name]
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                     "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                     "bound_by": c["bound_by"],
                     "library_ms": c["library_ms"]})
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": dev["kind"],
                                             "count": dev["count"]}}),
          flush=True)
    return 0


def _leaves(tree):
    for v in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(v, (dict, tuple)):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    sys.exit(main())
