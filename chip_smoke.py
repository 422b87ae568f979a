#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card.

Builds the CUDA kernels from `src/repro_torch/csrc/`, serves the whole
OLMoE-1B-7B (16 layers, d=2048, 64 experts top-8, random bf16 weights from a
seed) through the port's entry points, holds every kernel against its plain
PyTorch version on the inputs the model pass gave it, times kernel, plain
version and a PyTorch library yardstick, checks a small model on the card
against the CPU, and runs the single-request Cascade engine. Each phase prints one JSON line; the card's name and power limit
(as nvidia-smi reports them) come on a line of their own; the last line is
`{"ok": true, "device": {...}}`. Any failure raises and exits non-zero.

    python3 chip_smoke.py [--out results.json]

Needs one CUDA card; without one it exits non-zero and prints no result.
Imports nothing of JAX or of the JAX package."""

from __future__ import annotations

import argparse
import json
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
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import NGramDrafter, ServingEngine  # noqa: E402

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
TIMED_ITERS = 50
DEVICE = "cuda"

#: kernel -> (CUDA source, the TPU kernel it replaces)
KERNEL_SOURCES = {
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:76"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:65"),
    "moe_gmm_fused": ("src/repro_torch/csrc/moe_gmm.cu",
                      "src/repro/kernels/moe_gmm/kernel.py:156"),
}

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


def _bound(n_bytes: float, n_ops: float) -> tuple:
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over the bf16 peak. Returns (ms, bound_by)."""
    t_b, t_o = n_bytes / BYTES_PER_S, n_ops / BF16_OPS_PER_S
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")


def _copy_prompt(rng, n: int, vocab: int) -> list:
    p = rng.integers(3, vocab, PERIOD).tolist()
    return ([1] + p * (n // PERIOD + 1))[:n]


class _Recorder:
    """Stand in for a kernel wrapper inside a module for one model pass,
    keeping the first call's arguments (layer 0): the inputs the main path
    hands the kernel. Arguments at `copy` (the KV cache buffers, which
    later passes overwrite in place) are cloned."""

    def __init__(self, module, name: str, copy=()):
        self.module, self.name, self.copy = module, name, copy
        self.args = None

    def __enter__(self):
        self.wrapped = getattr(self.module, self.name)
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.wrapped)

    def __call__(self, *args, **kw):
        if self.args is None:
            self.args = ([a.clone() if i in self.copy else a
                          for i, a in enumerate(args)], dict(kw))
        return self.wrapped(*args, **kw)


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


def phase_build() -> None:
    secs = K.build()
    usage = {n: [ln.strip() for ln in log.splitlines()
                 if "Used" in ln or "spill" in ln]
             for n, log in K.ptxas_log.items()}
    emit("build", seconds=secs, ptxas=usage)


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


def _check_attn(name, out, ref) -> float:
    err = float((out.float() - ref.float()).abs().max())
    if not torch.allclose(out.float(), ref.float(), atol=2e-2, rtol=2e-2):
        raise AssertionError(f"{name}: kernel differs from plain version, "
                             f"max |err| {err}")
    return err


def _check_moe(name, out, ref) -> float:
    err = float((out.float() - ref.float()).abs().max())
    lim = 1e-2 * float(ref.float().abs().max()) + 1e-3
    if err > lim:
        raise AssertionError(f"{name}: kernel differs from plain version, "
                             f"max |err| {err} > {lim}")
    return err


def case_flash(args, kw) -> dict:
    q, k, v = args
    b, s, h, d = q.shape
    out = K.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    err = _check_attn("flash_attention", out, K.flash_attention_plain(q, k, v,
                                                                      **kw))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pairs = {"qk": b * h * s * (s + 1) / 2, "kv_rows": b * s}
    n_bytes, n_ops = _attn_cost(q, k, pairs)
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    return dict(
        shape=f"q{list(q.shape)} {q.dtype}", max_abs_err=err,
        ms=_time_ms(lambda: K.flash_attention(q, k, v, **kw)),
        plain_ms=_time_ms(lambda: K.flash_attention_plain(q, k, v, **kw)),
        library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        bound_ms=bound_ms, bound_by=bound_by)


def case_decode(args, kw) -> dict:
    q, kc, vc, cache_pos, q_pos = args
    b, t, h, d = q.shape
    out = K.decode_attention(q, kc, vc, cache_pos, q_pos, **kw)
    torch.cuda.synchronize()
    err = _check_attn("decode_attention", out, K.decode_attention_plain(
        q, kc, vc, cache_pos, q_pos, **kw))
    valid = ((cache_pos[:, None, :] >= 0)
             & (cache_pos[:, None, :] <= q_pos[:, :, None]))   # [B,T,S]
    live_slots = int((cache_pos >= 0).sum())
    pairs = {"qk": float(valid.sum()) * h, "kv_rows": live_slots,
             "extra_bytes": cache_pos.numel() * 4 + q_pos.numel() * 4}
    n_bytes, n_ops = _attn_cost(q, kc, pairs)
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))
    mask = valid[:, None]                                      # [B,1,T,S]
    gqa = {"enable_gqa": True} if kt.shape[1] != qt.shape[1] else {}
    return dict(
        shape=f"q{list(q.shape)} cache{list(kc.shape)} live slots "
              f"{live_slots} {q.dtype}", max_abs_err=err,
        ms=_time_ms(lambda: K.decode_attention(q, kc, vc, cache_pos, q_pos,
                                               **kw)),
        plain_ms=_time_ms(lambda: K.decode_attention_plain(
            q, kc, vc, cache_pos, q_pos, **kw)),
        library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, **gqa)),
        bound_ms=bound_ms, bound_by=bound_by)


def case_moe(args, kw) -> dict:
    x, wg, wu, wd, counts = args
    ids = kw.get("expert_ids")
    out = K.moe_gmm_fused(x, wg, wu, wd, counts, **kw)
    torch.cuda.synchronize()
    err = _check_moe("moe_gmm_fused", out, K.moe_gmm_fused_plain(
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

    return dict(
        shape=f"x{list(x.shape)} live slots {live} rows {rows} {x.dtype}",
        max_abs_err=err,
        ms=_time_ms(lambda: K.moe_gmm_fused(x, wg, wu, wd, counts, **kw)),
        plain_ms=_time_ms(lambda: K.moe_gmm_fused_plain(x, wg, wu, wd, counts,
                                                        **kw)),
        library_ms=_time_ms(library),
        bound_ms=bound_ms, bound_by=bound_by, weight_bytes=live * 3 * d * f * el)


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
         iterations=len(its), drafted=drafted, accepted=accepted)
    for a, b in ((g_lo, c_lo), (g_lo2, c_lo2)):
        if not torch.allclose(a, b, atol=1e-3, rtol=1e-3):
            raise AssertionError(f"card and CPU passes differ by {err}")
    if not torch.equal(g_u, c_u) or g_res.tokens != c_res.tokens:
        raise AssertionError("card and CPU disagree on routing or tokens")
    if drafted == 0:
        raise AssertionError("the reference engine run verified no spans")


def _to(tree, dev):
    return {k: (_to(v, dev) if isinstance(v, dict) else v.to(dev))
            for k, v in tree.items()}


def _engine_workload(cfg, params) -> tuple:
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
    rng = np.random.default_rng(SEED + 1)
    vocab = rng.choice(np.arange(3, cfg.vocab_size), PERIOD, replace=False)
    prompts = [([1] + rng.permutation(vocab).tolist()
                * (ENGINE_PROMPT_LEN // PERIOD + 1))[:ENGINE_PROMPT_LEN]
               for _ in range(ENGINE_REQUESTS)]
    keep = torch.zeros(cfg.vocab_size, dtype=params["embed"]["unembed"].dtype,
                       device=DEVICE)
    keep[torch.as_tensor(vocab, device=DEVICE)] = 1
    embed = dict(params["embed"], unembed=params["embed"]["unembed"] * keep)
    return prompts, dict(params, embed=embed)


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
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    idle = [n for n, r in report.items() if r["drafted"] == 0]
    if idle:
        raise AssertionError(f"engine verified no drafted span: {idle}")
    return launches


def phase_profile(cfg, params, steps: int = 5) -> None:
    """Where a verification pass's time goes: device time by kernel over a
    few dense T=5 decode steps (torch.profiler), and the device's idle
    share of their wall time."""
    from torch.profiler import ProfilerActivity, profile

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
    by_name = {}
    for ev in prof.key_averages():
        # kernels only: an operator's own row repeats its kernels' time
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        by_name[ev.key[:90]] = by_name.get(ev.key[:90], 0.0) + t / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit("profile", steps=steps, span=SPAN, wall_ms_per_step=1e3 * wall /
         steps, device_busy_ms_per_step=busy / steps if busy else None,
         device_idle_share=(1.0 - busy / (1e3 * wall)) if busy else None,
         top_device_ms_per_step={k: v / steps for k, v in top})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every phase's record to this JSON file")
    args = ap.parse_args(argv)

    dev = phase_device()
    phase_build()
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

    main_case = {"flash_attention": "flash_attention",
                 "decode_attention": "decode_attention/t5",
                 "moe_gmm_fused": "moe_gmm_fused/t5-dense"}
    line = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        c = cases[main_case[name]]
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                     "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                     "bound_by": c["bound_by"],
                     "library_ms": c["library_ms"]})
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(RESULTS, indent=1))
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": dev["kind"],
                                             "count": dev["count"]}}),
          flush=True)
    return 0


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    sys.exit(main())
