#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card.

Builds the CUDA kernels from `src/repro_torch/csrc/` (one `nvcc` per
source, all at once), then drives these paths, each through the port's
entry points with random weights from a seed:

1. the whole OLMoE-1B-7B (16 layers, d=2048, 64 experts top-8, bf16)
   through the single-request Cascade `ServingEngine` (kernels K1-K3);
2. the whole Mixtral-8x7B (32 layers, d=4096, GQA 32/8, 8 experts top-2,
   F=14336) with int8 routed experts and bf16 everything else, 48.3 GB,
   through the continuous-batching `BatchedEngine` under the joint planner
   (kernels K2-K4); then open-loop serving on the same model: a Poisson
   trace replayed through `ContinuousBatchingScheduler` with predictive
   TTFT admission on the wall clock, closed loop first (its passes fit a
   `Calibration`), then open loop without and with the calibrated planner
   (K2, K4, also held against their plain versions at a chunked pass
   where a 64-token prefill chunk shares the pass with decode rows); then the serve launcher (`repro_torch.launch.serve`) on the
   reduced config (K1-K3);
3. training: the whole OLMoE-1B-7B in bf16 for a few Adafactor steps
   through `make_train_step` (K5 on the expert products and their input
   gradients, K3 writing each row's log-sum-exp), one float32 step of a
   2-layer full-width OLMoE held against the CPU, and then the repo's
   serve-cascade target (examples/serve_cascade.py) trained by the port and
   served under no-spec, static K=3 and Cascade;
4. the whole RWKV-6-3B (32 layers, d=2560, 40 heads of 64, bf16, a
   6.20 GB tree) through `ServingEngine` (Cascade and static K=4) and
   through `BatchedEngine` with chunked admission into recycled rows (K6
   on every prefill and verification pass, staging the per-token states
   that speculative rollback selects from);
5. the whole RecurrentGemma-9B (38 layers "RRA": 26 RG-LRU and 12
   local-attention blocks, d = d_rnn = 4096, MQA 16/1 at head_dim 256,
   window 2048, bf16, 20.9 GB) through `ServingEngine` and `BatchedEngine`
   like path 4 (K7 on every RG-LRU block, K2 and K3 at head_dim 256 on
   every local-attention block), after a 3000-token prefill that outgrows
   the window.

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

from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402
from repro_torch.core.controller import (CascadeController,  # noqa: E402
                                         StaticKController)
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
    quantize_moe_experts)
from repro_torch.kernels.rwkv_scan import ops as rwkv_ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import rglru as rglru_mod  # noqa: E402
from repro_torch.models import rwkv as rwkv_mod  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import (BatchedEngine,  # noqa: E402
                                 ContinuousBatchingScheduler, LoadSpec,
                                 NGramDrafter, ServingEngine, build_trace,
                                 summarize)
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


def case_moe(args, kw) -> dict:
    """K1 against its plain version; the bound counts the live experts'
    weights, the live rows' x and the whole y; the library is a gather of
    the live experts' weights and three `torch.bmm`s (h rounded to bf16;
    the kernel keeps it at float32 precision). `device_ms` and
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


def phase_engine(cfg, params) -> dict:
    prompts, params = _engine_workload(cfg, params)
    K.reset_launch_counts()
    report = {}
    for name, factory in (("cascade", CascadeController),
                          ("static-k4", lambda: StaticKController(4))):
        eng = ServingEngine(cfg, params, NGramDrafter(),
                            controller_factory=factory, clock="wall",
                            temperature=0.0, max_len=MAX_LEN, seed=SEED,
                            device=DEVICE)
        n_out = n_iter = k_sum = acc_sum = 0
        decode_s = prefill_s = 0.0
        utils = []
        t0 = time.perf_counter()
        for i, prompt in enumerate(prompts):
            res = eng.generate(prompt, max_new=ENGINE_NEW, request_id=str(i))
            tel = res.telemetry
            if len(res.tokens) != ENGINE_NEW or not all(
                    0 <= tok < cfg.vocab_size for tok in res.tokens):
                raise AssertionError(f"{name}: bad output {res.tokens}")
            n_out += len(res.tokens)
            n_iter += len(tel.iterations)
            k_sum += sum(it.k_drafted for it in tel.iterations)
            acc_sum += sum(it.tokens_emitted - 1 for it in tel.iterations)
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
            drafted=k_sum, accepted=acc_sum, mean_k=k_sum / n_iter,
            utility_mean=float(np.mean(utils)))
    launches = K.launch_counts()
    emit("engine", arch=cfg.name, requests=ENGINE_REQUESTS,
         prompt_len=ENGINE_PROMPT_LEN, max_new=ENGINE_NEW, clock="wall",
         temperature=0.0, policies=report, launches=launches,
         routes=K.route_counts(),
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    _check_routes("engine", BF16_SERVING)
    missing = [n for n in ("flash_attention", "decode_attention",
                           "moe_gmm_fused") if launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    idle = [n for n, r in report.items() if r["drafted"] == 0]
    if idle:
        raise AssertionError(f"engine verified no drafted span: {idle}")
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
# The Mixtral path: int8 experts, continuous batching
# --------------------------------------------------------------------- #

def phase_mixtral_params(cfg) -> dict:
    """The whole Mixtral-8x7B with int8 routed experts, built one layer at
    a time on the card: a layer's bf16 block from the seed, its experts
    quantized (per-expert absmax scales), then copied into the [L, ...]
    stacks. A full-width bf16 tree (93.4 GB) never exists; the peak is one
    layer's bf16 experts on top of the int8 stacks."""
    t0 = time.perf_counter()
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    params = {"embed": L.init_embed(cfg, gen, dtype, DEVICE)}
    blocks: dict = {}
    for layer in range(cfg.num_layers):
        block = T._init_block(cfg, gen, dtype, DEVICE)
        block["moe"] = quantize_moe_experts(block["moe"])
        T._stack_into(blocks, block, layer, cfg.num_layers)
        del block
    params["blocks"] = blocks
    params["final_norm"] = L.init_norm(cfg, cfg.d_model, dtype, DEVICE)
    torch.cuda.synchronize()
    by_type: dict = {}
    for t in _leaves(params):
        k = str(t.dtype).replace("torch.", "")
        by_type[k] = by_type.get(k, 0) + t.numel() * t.element_size()
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
            "linear_scan_plain": scan_ops}
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


def _serve_batched(eng, prompts, max_new, on_retire=None) -> tuple:
    """Continuous batching: join prompts while a row is free (blocking or
    chunked admission), step, retire what finished (then call
    `on_retire(slot)`, if given), until every prompt is served. The clock
    starts after the first joins. Returns (results in prompt order, wall
    seconds)."""
    pending, live, done = list(enumerate(prompts)), {}, {}

    def admit():
        while pending and eng.free_slots:
            i, p = pending.pop(0)
            live[eng.join(p, max_new, request_id=str(i))] = i

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
    bound_ms, bound_by = _bound(n_bytes, 2.0 * rows * d * f)
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
        bound_ms=bound_ms, bound_by=bound_by)


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
    return float(loss), [g.cpu() for g in grads], routes


def phase_train_whole(batch) -> None:
    """One float32 step of a 2-layer OLMoE at full width on the card (K5,
    K3 with lse) against the same weights and batch on the CPU (plain
    versions): loss within 1e-4 relative, grad norm within 1e-3 relative,
    every leaf's gradient within 1e-3 * max|g_cpu| + 1e-6; the tokens
    routed to other experts are counted."""
    cfg = dataclasses.replace(get_config(ARCH), num_layers=WHOLE_LAYERS,
                              dtype="float32")
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
    emit("train-whole", arch=cfg.name, layers=WHOLE_LAYERS, dtype=cfg.dtype,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, loss_cpu=c_loss, loss_card=g_loss,
         grad_norm_cpu=c_norm, grad_norm_card=g_norm,
         worst_leaf_share_of_grad_limit=max(ratios),
         max_grad_abs_err=max(float((g - c).abs().max())
                              for g, c in zip(g_grads, c_grads)),
         tokens_routed_to_other_experts=moved,
         tokens_with_reordered_top_k=sum(
             int((a != b).any(-1).sum()) for a, b in zip(g_routes, c_routes)),
         launches=launches, routes=K.route_counts(), cpu_s=cpu_s,
         card_s=card_s,
         tolerance="loss 1e-4 rel, grad norm 1e-3 rel, each leaf "
                   "max|dg| <= 1e-3*max|g_cpu| + 1e-6")
    if abs(g_loss - c_loss) > 1e-4 * abs(c_loss):
        raise AssertionError(f"loss: card {g_loss}, CPU {c_loss}")
    if abs(g_norm - c_norm) > 1e-3 * c_norm:
        raise AssertionError(f"grad norm: card {g_norm}, CPU {c_norm}")
    if max(ratios) > 1.0:
        raise AssertionError(f"a gradient leaf differs: {max(ratios)} of "
                             f"its limit")
    _check_routes("train-whole", {"flash_attention": "simt",
                                  "moe_gmm": "simt"})


def _target_cfg():
    """The serve-cascade target of examples/serve_cascade.py."""
    return dataclasses.replace(get_config(MIXTRAL).reduced(), vocab_size=128,
                               num_layers=2)


def phase_target_train() -> tuple:
    """Train the serve-cascade target with the port as the example trains
    it: adamw(2e-3), 200 steps of batch_iterator("all-3", 16, 96, vocab=128,
    seed=0, prompt_len=48)."""
    cfg = _target_cfg()
    opt = adamw(2e-3)
    init_state, step = make_train_step(cfg, optimizer=opt)
    state = init_state(torch.Generator(device=DEVICE).manual_seed(SEED),
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
    emit("target-train", arch=cfg.name, layers=cfg.num_layers,
         vocab=cfg.vocab_size, dtype=cfg.dtype, steps=TARGET_STEPS,
         optimizer="adamw", lr=2e-3, log=log, launches=launches,
         routes=K.route_counts(), seconds=time.perf_counter() - t0)
    _check_routes("target-train", {"flash_attention": "simt",
                                   "moe_gmm": "simt"})
    if not log[-1]["loss"] < log[0]["loss"]:
        raise AssertionError(f"the target's loss did not fall: {log}")
    if launches["moe_gmm"] != 6 * cfg.num_layers * TARGET_STEPS:
        raise AssertionError(f"K5 launched {launches['moe_gmm']} times")
    return cfg, state[0]


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


def phase_serve_trained(cfg, params) -> None:
    """Serve the trained target as examples/serve_cascade.py does: 6
    requests one after another through ServingEngine with NGramDrafter
    and a fresh controller per request, under no-spec, static K=3 and
    Cascade, on the model clock and the wall clock; all greedy streams must
    be identical."""
    tasks = ["code", "math", "extract"]
    reqs = _trained_requests(cfg)
    K.reset_launch_counts()
    report, streams = {}, {}
    for clock in ("model", "wall"):
        for name, factory in (("no-spec", lambda: StaticKController(0)),
                              ("static-K3", lambda: StaticKController(3)),
                              ("cascade", CascadeController)):
            eng = ServingEngine(cfg, params, NGramDrafter(),
                                controller_factory=factory, max_len=512,
                                temperature=0.0, clock=clock, seed=SEED,
                                device=DEVICE)
            t0 = time.perf_counter()
            results = [eng.generate(p, TARGET_NEW, request_id=rid, task=task)
                       for rid, p, task in reqs]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            its = [it for r in results for it in r.telemetry.iterations]
            out = sum(r.telemetry.output_tokens for r in results)
            decode = sum(r.telemetry.decode_time for r in results)
            streams[f"{name}/{clock}"] = [r.tokens for r in results]
            report[f"{name}/{clock}"] = dict(
                output_tokens=out, passes=len(its),
                drafted=sum(it.k_drafted for it in its),
                accepted=sum(it.tokens_emitted - 1 for it in its),
                tokens_per_pass=out / len(its),
                mean_utility=float(np.mean([it.utility for it in its])),
                mean_k=float(np.mean([it.k_drafted for it in its])),
                tokens_per_s=out / decode, wall_s=wall,
                per_task_tokens_per_pass={
                    t: sum(r.telemetry.output_tokens for r, q in
                           zip(results, reqs) if q[2] == t)
                    / sum(len(r.telemetry.iterations) for r, q in
                          zip(results, reqs) if q[2] == t) for t in tasks})
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
    dev = phase_device()
    phase_build()

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
    del params, inputs
    gc.collect()
    torch.cuda.empty_cache()

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
    phase_mixtral_profile(mcfg, mparams)
    del mparams
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve_launcher()

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
    phase_train_whole(batch)
    tcfg, tparams = phase_target_train()
    phase_serve_trained(tcfg, tparams)
    phase_serve_trained_bf16(tcfg, tparams)
    del tparams
    gc.collect()
    torch.cuda.empty_cache()

    # path 4: RWKV-6-3B, bf16, both engines (K6); path 5: RecurrentGemma-9B,
    # bf16, both engines (K7; K2, K3 at head_dim 256)
    scans = {}
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
        del rparams
        gc.collect()
        torch.cuda.empty_cache()
        scans[path.scan[1]] = (rcases[f"{path.scan[1]}/t{SPAN}"], rlaunches)

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
                 **scans}
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
