#!/usr/bin/env python3
"""Time kernels K1 (`moe_gmm_fused`), K2 (`decode_attention`), K3
(`flash_attention`), K4 (`moe_gmm_fused_quant`), K5 (`moe_gmm`), K6
(`rwkv_scan`) and K7 (`linear_scan`) of one or more checkouts of the port
on one CUDA card, at the main path's shapes with seeded inputs:
CUDA-events ms, device ms warm and cold (a CUDA graph's), host ms per
call, and the plain version's and the library call's (a gather plus
`torch.bmm`, SDPA, the live int8 slices dequantized plus `torch.bmm`,
`torch.bmm`; none for K6 and K7) times, each call held against its plain
version by `chip_smoke.py`'s case functions. K6's and K7's cases also
carry a digest of their outputs (`digest`), so that two trees' bits can be
compared.

    python3 bench_kernels.py [--tree DIR ...] [--kernels moe_gmm_fused,...]
                             [--out FILE]

A tree is a checkout holding `src/repro_torch`. Each tree runs in its own
process (it builds its own kernels); with several trees they run in the
order given and then reversed (A B B A), so that two versions are compared
on one card in turns. Without --tree it times this checkout. The last line
is one JSON object: the runs in order, each with its tree and cases."""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
E, C = 64, 321          # OLMoE's experts, rows per expert at capacity 1.25
D_MODEL, D_FF = 2048, 1024
TOP_K = 8
KERNELS = ("moe_gmm_fused", "decode_attention", "flash_attention", "moe_gmm",
           "moe_gmm_fused_quant", "rwkv_scan", "linear_scan")
# Mixtral's int8 experts (K4): experts, top-k, d, F
MIX_E, MIX_TOP, MIX_D, MIX_F = 8, 2, 4096, 14336

# name -> (q shape [B,S,H,D], KV heads, window, lse)
ATTENTION = {
    "olmoe-prefill": ((1, 512, 16, 128), 16, 0, False),
    "mixtral-prefill": ((1, 256, 32, 128), 8, 0, False),
    "training-lse": ((4, 512, 16, 128), 16, 0, True),
    "rgemma-prefill": ((1, 3000, 16, 256), 1, 2048, False),
}
# name -> (inner width d, output width F, transpose_w)
PRODUCTS = {
    "gate-up": (D_MODEL, D_FF, False),
    "down": (D_FF, D_MODEL, False),
    "down-dx": (D_MODEL, D_FF, True),
    "gate-up-dx": (D_FF, D_MODEL, True),
}
# name -> (tokens routed top-8 over OLMoE's 64 experts, packed): the dense
# layout holds all 64 experts with C = T rows each, the packed one the
# min(64, 8T) slots of the live experts first
FUSED = {
    "olmoe-prefill": (512, False),
    "olmoe-t5-dense": (5, False),
    "olmoe-t5-packed": (5, True),
    "olmoe-t1": (1, False),
}
# name -> (tokens routed top-2 over Mixtral's 8 experts, packed, C): the
# shapes of the Mixtral path's B=4 [1+4] pass, 1-token pass and 256-token
# prefill (the packed layout holds min(8, 2T) slots, live experts first),
# a [1+4] span of one row, a 2-token pass, and the 1-token pass with its
# slots padded to C = 2 rows (the work of C = 1 on the route C = 2 takes)
QUANT = {
    "mixtral-t20-packed": (20, True, 20),
    "mixtral-t20-dense": (20, False, 20),
    "mixtral-t5-packed": (5, True, 5),
    "mixtral-t2-packed": (2, True, 2),
    "mixtral-t1-packed": (1, True, 1),
    "mixtral-t1-packed-c2": (1, True, 2),
    "mixtral-prefill-dense": (256, False, 256),
}
# name -> (B, T, H, N, staged, seed): RWKV-6-3B's K6 calls (40 heads of 64):
# the 512-token prefill, the [1+4] span, a 1-token pass, the B=4 span and
# the batched engine's [4,32] chunk
RWKV = {
    "prefill": (1, 512, 40, 64, False, 11),
    "t5": (1, 5, 40, 64, True, 12),
    "t1": (1, 1, 40, 64, True, 13),
    "b4-t5": (4, 5, 40, 64, True, 14),
    "b4-chunk32": (4, 32, 40, 64, True, 15),
}
# name -> (B, T, D, seed): RecurrentGemma-9B's K7 calls (d_rnn = 4096), the
# same passes with its 3000-token prefill
LRU = {
    "prefill": (1, 3000, 4096, 21),
    "t5": (1, 5, 4096, 22),
    "t1": (1, 1, 4096, 23),
    "b4-t5": (4, 5, 4096, 24),
    "b4-chunk32": (4, 32, 4096, 25),
}
# name -> (B, T, H, Hkv, D, ring slots S, live positions a row, window)
DECODE = {
    "olmoe-t1": (1, 1, 16, 16, 128, 2048, (517,), 0),
    "olmoe-t5": (1, 5, 16, 16, 128, 2048, (517,), 0),
    "mixtral-t1": (1, 1, 32, 8, 128, 2048, (257,), 0),
    "mixtral-b4": (4, 5, 32, 8, 128, 2048, (261, 216, 155, 102), 0),
    "rgemma-t1": (1, 1, 16, 1, 256, 3072, (3001,), 2048),
    "rgemma-t5": (1, 5, 16, 1, 256, 3072, (3001,), 2048),
    "rgemma-b4": (4, 5, 16, 1, 256, 3072, (3001,) * 4, 2048),
}


def _fused_args(torch, randn, gen, dev, w, tokens, packed, e=E, top=TOP_K,
                d=D_MODEL):
    """K1's (or K4's) inputs for `tokens` tokens routed top-`top` over `e`
    experts by random scores."""
    scores = torch.rand((tokens, e), generator=gen, device=dev)
    counts = torch.bincount(scores.topk(top, dim=1).indices.flatten(),
                            minlength=e).to(torch.int32)
    x = randn(e, tokens, d)
    x[torch.arange(tokens, device=dev)[None, :] >= counts[:, None]] = 0
    if not packed:
        return (x, *w, counts), {}
    ids = torch.argsort((counts == 0).to(torch.int32), stable=True)
    ids = ids[:min(e, top * tokens)].to(torch.int32)
    return ((x[ids.long()].contiguous(), *w, counts[ids.long()].contiguous()),
            {"expert_ids": ids})


def _decode_args(torch, randn, dev, b, t, h, hkv, d, s, lengths):
    """K2's inputs: row r has written positions 0..lengths[r]-1 into an
    S-slot ring (slot = pos % S); the span is its last T positions."""
    cache_pos = torch.full((b, s), -1, dtype=torch.int32, device=dev)
    q_pos = torch.empty((b, t), dtype=torch.int32, device=dev)
    for r, n in enumerate(lengths):
        pos = torch.arange(max(0, n - s), n, dtype=torch.int32, device=dev)
        cache_pos[r, (pos % s).long()] = pos
        q_pos[r] = torch.arange(n - t, n, dtype=torch.int32, device=dev)
    return (randn(b, t, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d),
            cache_pos, q_pos)


def _digest(tensors) -> str:
    """The first 16 hex digits of a sha256 over the tensors' bytes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def run_one(tree: Path, kernels=KERNELS) -> dict:
    """Time every case with `tree`'s kernels (this process imports its
    `repro_torch` before `chip_smoke`, so every module of the port that
    `chip_smoke` imports comes from `tree`)."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    import repro_torch.kernels  # noqa: F401  (the tree's, first)
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs

    if cs.flash_ops.__file__ != str(tree / "src/repro_torch/kernels/"
                                    "flash_attention/ops.py"):
        raise RuntimeError(f"imported {cs.flash_ops.__file__}, not {tree}")
    # a tree from before the routes: K3 ran on the CUDA cores in every
    # dtype, K5 in bf16 on WMMA, K1 and K2 on the CUDA cores
    if not hasattr(cs.flash_ops, "route"):
        cs.flash_ops.route = lambda dtype: "simt"
    if not hasattr(cs.moe_ops, "route"):
        cs.moe_ops.route = (lambda dtype, d, f: "wmma"
                            if dtype == torch.bfloat16 else "simt")
    if not hasattr(cs.moe_ops, "fused_route"):
        cs.moe_ops.fused_route = lambda dtype, d, f: "simt"
    if not hasattr(cs.decode_ops, "route"):
        cs.decode_ops.route = lambda dtype: "simt"
    if not hasattr(cs.moe_ops, "quant_route"):
        cs.moe_ops.quant_route = lambda dtype, d, f, c: "simt"
    # a tree from before K6's chunked route and K7's one pass: K6 walked
    # every call in series, K7 equalled its plain version only within one
    # 64-token chunk
    old_scans = not hasattr(cs.rwkv_ops, "route")
    if old_scans:
        cs.rwkv_ops.route = lambda t, staged: "serial"
    dev = cs.phase_device()
    secs = cs.K.build()
    gen = torch.Generator(device=cs.DEVICE).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=cs.DEVICE)
                * scale).bfloat16()

    cases = {}
    if "moe_gmm_fused" in kernels:
        w = (randn(E, D_MODEL, D_FF, scale=D_MODEL ** -0.5),
             randn(E, D_MODEL, D_FF, scale=D_MODEL ** -0.5),
             randn(E, D_FF, D_MODEL, scale=D_FF ** -0.5))
        for name, (tokens, packed) in FUSED.items():
            args, kw = _fused_args(torch, randn, gen, cs.DEVICE, w, tokens,
                                   packed)
            cases[f"moe_gmm_fused/{name}"] = cs.case_moe(args, kw)
        del w, args
    if "decode_attention" in kernels:
        for name, (b, t, h, hkv, d, s, lengths, window) in DECODE.items():
            args = _decode_args(torch, randn, cs.DEVICE, b, t, h, hkv, d, s,
                                lengths)
            cases[f"decode_attention/{name}"] = cs.case_decode(
                args, {"window": window})
    if "flash_attention" in kernels:
        for name, (shape, hkv, window, lse) in ATTENTION.items():
            b, s, h, d = shape
            args = (randn(b, s, h, d), randn(b, s, hkv, d),
                    randn(b, s, hkv, d))
            run = cs.case_flash_lse if lse else cs.case_flash
            cases[f"flash_attention/{name}"] = run(args, {"window": window})
    if "moe_gmm_fused_quant" in kernels:
        from repro_torch.kernels.moe_gmm.quant import quantize_int8
        (wg, sg), (wu, su), (wd, sd) = (
            quantize_int8(torch.randn(shape, generator=gen, device=cs.DEVICE)
                          * shape[1] ** -0.5)
            for shape in ((MIX_E, MIX_D, MIX_F), (MIX_E, MIX_D, MIX_F),
                          (MIX_E, MIX_F, MIX_D)))
        for name, (tokens, packed, c) in QUANT.items():
            (x, *_, cnt), kw = _fused_args(torch, randn, gen, cs.DEVICE, (),
                                           tokens, packed, MIX_E, MIX_TOP,
                                           MIX_D)
            if c > tokens:  # rows past every count: zeros, never loaded
                x = torch.cat([x, x.new_zeros(x.shape[0], c - tokens,
                                              MIX_D)], 1)
            cases[f"moe_gmm_fused_quant/{name}"] = cs.case_moe_quant(
                (x, wg, wu, wd, sg, su, sd, cnt), kw)
        del wg, wu, wd
    if "rwkv_scan" in kernels:
        for name, (b, t, h, n, staged, seed) in RWKV.items():
            args, kw = cs._seeded_scan(b, t, h, n, seed, states=staged)
            case = cs.case_scan(args, kw)
            st = (torch.empty((t + 1, b, h, n, n), device=cs.DEVICE)
                  if staged else None)
            out = cs.K.rwkv_scan(*args, states=st)
            case["digest"] = _digest(out + ((st,) if staged else ()))
            cases[f"rwkv_scan/{name}"] = case
            del args, st, out
    if "linear_scan" in kernels:
        for name, (b, t, d, seed) in LRU.items():
            args, kw = cs._seeded_linear_scan(b, t, d, seed)
            case = cs.case_linear_scan(
                args, {"exact_max_t": 64} if old_scans else kw)
            case["digest"] = _digest(cs.K.linear_scan(*args))
            cases[f"linear_scan/{name}"] = case
    counts = torch.randint(192, C + 1, (E,), generator=gen,
                           device=cs.DEVICE, dtype=torch.int32)
    if "moe_gmm" in kernels:
        for name, (d, f, t) in PRODUCTS.items():
            w = randn(*((E, f, d) if t else (E, d, f)), scale=d ** -0.5)
            cases[f"moe_gmm/{name}"] = cs.case_gmm(
                (randn(E, C, d), w, counts), {"transpose_w": t})
    return {"tree": str(tree), "device": dev, "build_s": secs,
            "counts": counts.tolist(), "cases": cases}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, action="append", default=None,
                    help="a checkout to time (repeat to compare)")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help=f"comma-separated, of {', '.join(KERNELS)}")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--one", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(run_one(args.one.resolve(),
                                 args.kernels.split(","))), flush=True)
        return 0
    trees = [t.resolve() for t in (args.tree or [ROOT])]
    order = trees + trees[::-1] if len(trees) > 1 else trees
    runs = []
    for tree in order:
        proc = subprocess.run([sys.executable, __file__, "--one", str(tree),
                               "--kernels", args.kernels],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
            raise RuntimeError(f"{tree}: exit {proc.returncode}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(run)
        for key, c in run["cases"].items():
            print(json.dumps({"tree": str(tree), "case": key,
                              **{k: c.get(k) for k in (
                                  "route", "ms", "device_ms",
                                  "device_ms_cold", "host_ms", "library_ms",
                                  "library_device_ms", "bound_ms",
                                  "max_abs_err", "worst_share_of_limit",
                                  "bit_exact", "digest",
                                  "kernel_device_ms")}}), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(runs, indent=1))
    print(json.dumps({"runs": [{"tree": r["tree"], "cases": {
        k: {m: c.get(m) for m in ("ms", "device_ms", "host_ms", "digest")}
        for k, c in r["cases"].items()}} for r in runs]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
