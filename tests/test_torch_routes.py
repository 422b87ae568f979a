"""The route choice of the kernels with more than one route, on the CPU:
`flash_attention` (bf16 on wgmma fed by TMA, float32 on the CUDA cores),
`moe_gmm` (bf16 on wgmma where d and F are multiples of 8, else WMMA;
float32 on the CUDA cores), `moe_gmm_fused` (bf16 on wgmma where d and F
are multiples of 8; float32, and bf16 at other widths, on the CUDA cores),
`moe_gmm_fused_quant` (bf16 on wgmma, its int8 weight tiles fed by TMA,
except one-token passes; float32 on the CUDA cores) and `decode_attention` (bf16 on mma.sync,
float32 on the CUDA cores, with its split size chosen on the host). The C launchers choose the route and
report it; the wrappers mirror the rule, count each launch by route and
raise if the two disagree. `rwkv_scan`'s route (the tokens in series, or
chunks of CHUNK tokens with the state passed between them) is chosen by
its wrapper from T and whether the call stages states. Nothing here
builds or launches a kernel."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels import _lib
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.moe_gmm import ops as moe_ops
from repro_torch.kernels.rwkv_scan import ops as rwkv_ops
from test_torch_guards import torch_one_thread  # noqa: F401,E402 (autouse)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("dtype,expected", [
    (torch.bfloat16, "wgmma"), (torch.float32, "simt"),
])
def test_flash_attention_route_by_dtype(dtype, expected):
    assert flash_ops.route(dtype) == expected


@pytest.mark.parametrize("dtype,d,f,expected", [
    (torch.bfloat16, 2048, 1024, "wgmma"),   # OLMoE's expert products
    (torch.bfloat16, 1024, 2048, "wgmma"),   # and their input gradients
    (torch.bfloat16, 200, 72, "wgmma"),      # multiples of 8, not of 64
    (torch.bfloat16, 130, 70, "wmma"),       # rows not 16-byte multiples
    (torch.bfloat16, 17, 33, "wmma"),
    (torch.bfloat16, 64, 36, "wmma"),
    (torch.float32, 2048, 1024, "simt"),
    (torch.float32, 17, 33, "simt"),
])
def test_moe_gmm_route_by_dtype_and_widths(dtype, d, f, expected):
    assert moe_ops.route(dtype, d, f) == expected


@pytest.mark.parametrize("dtype,d,f,expected", [
    (torch.bfloat16, 2048, 1024, "wgmma"),   # OLMoE's experts, every C
    (torch.bfloat16, 1024, 2048, "wgmma"),
    (torch.bfloat16, 200, 72, "wgmma"),      # multiples of 8, not of 64
    (torch.bfloat16, 130, 70, "simt"),       # rows not 16-byte multiples
    (torch.bfloat16, 2048, 36, "simt"),
    (torch.bfloat16, 17, 33, "simt"),
    (torch.float32, 2048, 1024, "simt"),
    (torch.float32, 200, 72, "simt"),
])
def test_moe_gmm_fused_route_by_dtype_and_widths(dtype, d, f, expected):
    assert moe_ops.fused_route(dtype, d, f) == expected


@pytest.mark.parametrize("dtype,d,f,c,expected", [
    (torch.bfloat16, 4096, 14336, 20, "wgmma"),  # Mixtral's B=4 pass
    (torch.bfloat16, 4096, 14336, 256, "wgmma"),  # its prefill
    (torch.bfloat16, 4096, 14336, 2, "wgmma"),
    (torch.bfloat16, 4096, 14336, 1, "simt"),    # a one-token pass
    (torch.bfloat16, 14336, 4096, 5, "wgmma"),
    (torch.bfloat16, 144, 80, 5, "wgmma"),       # multiples of 16, not 64
    (torch.bfloat16, 4096, 24, 5, "simt"),       # the card refuses these
    (torch.float32, 4096, 14336, 20, "simt"),
    (torch.float32, 144, 80, 1, "simt"),
])
def test_moe_gmm_fused_quant_route_by_dtype_and_widths(dtype, d, f, c,
                                                       expected):
    assert moe_ops.quant_route(dtype, d, f, c) == expected


@pytest.mark.parametrize("dtype,expected", [
    (torch.bfloat16, "mma"), (torch.float32, "simt"),
])
def test_decode_attention_route_by_dtype(dtype, expected):
    assert decode_ops.route(dtype) == expected


@pytest.mark.parametrize("dtype,b,hkv,s,d,expected", [
    (torch.bfloat16, 1, 16, 2048, 128, 32),    # OLMoE: 1024 CTAs
    (torch.bfloat16, 1, 8, 2048, 128, 32),     # Mixtral, one row
    (torch.bfloat16, 4, 8, 2048, 128, 64),     # Mixtral's B=4 pass
    (torch.bfloat16, 1, 1, 3072, 256, 32),     # RecurrentGemma: 96 CTAs
    (torch.bfloat16, 4, 1, 3072, 256, 64),     # 192: one CTA an SM holds
    (torch.bfloat16, 4, 1, 2048, 256, 32),     # 256
    (torch.bfloat16, 1, 1, 16, 64, 32),        # never below 32
    (torch.bfloat16, 64, 8, 4096, 256, 64),    # capped at head_dim 256
    (torch.bfloat16, 64, 8, 4096, 64, 128),    # capped
    (torch.float32, 1, 1, 3072, 256, 128),     # the CUDA cores' fixed size
    (torch.float32, 1, 16, 2048, 128, 128),
])
def test_decode_attention_split_size(dtype, b, hkv, s, d, expected):
    assert decode_ops.split_size(dtype, b, hkv, s, d, 132) == expected


def test_decode_attention_split_size_never_exceeds_its_cap():
    for d in decode_ops.HEAD_DIMS:
        for s in (1, 16, 17, 2048, 100_000):
            for b in (1, 4, 64):
                split = decode_ops.split_size(torch.bfloat16, b, 8, s, d,
                                              132)
                assert split % 16 == 0
                assert 32 <= split <= (128 if d <= 128 else 64)


def test_route_codes_match_the_c_enum():
    src = (_lib.CSRC / "common.cuh").read_text()
    codes = {name.lower(): int(v) for name, v in
             re.findall(r"RT_ROUTE_(\w+) = (\d+)", src)}
    assert codes == {r: i for i, r in enumerate(_lib.ROUTES)}


def test_launches_by_route_sum_to_launches():
    K.reset_launch_counts()
    code = {r: i for i, r in enumerate(_lib.ROUTES)}
    fa, mg = K.flash_attention, K.moe_gmm
    da, mf = K.decode_attention, K.moe_gmm_fused
    mq = K.moe_gmm_fused_quant
    for route in ("wgmma", "wgmma", "simt"):
        _lib.count_route(fa, "flash_attention", code[route], route)
    for route in ("wgmma", "wmma", "simt", "wgmma"):
        _lib.count_route(mg, "moe_gmm", code[route], route)
    for route in ("mma", "simt", "mma", "mma"):
        _lib.count_route(da, "decode_attention", code[route], route)
    for route in ("wgmma", "simt"):
        _lib.count_route(mf, "moe_gmm_fused", code[route], route)
    for route in ("simt", "wgmma", "wgmma", "wgmma"):
        _lib.count_route(mq, "moe_gmm_quant", code[route], route)
    assert fa.launches_by_route == {"wgmma": 2, "simt": 1}
    assert mg.launches_by_route == {"wgmma": 2, "wmma": 1, "simt": 1}
    assert da.launches_by_route == {"mma": 3, "simt": 1}
    assert mf.launches_by_route == {"wgmma": 1, "simt": 1}
    assert mq.launches_by_route == {"wgmma": 3, "simt": 1}
    counts = K.launch_counts()
    for name, by_route in K.route_counts().items():
        assert sum(by_route.values()) == counts[name]
    K.reset_launch_counts()
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}
    assert all(v == 0 for r in K.route_counts().values() for v in r.values())


def test_a_route_other_than_the_rule_raises_and_counts_nothing():
    K.reset_launch_counts()
    with pytest.raises(RuntimeError, match="took route simt"):
        _lib.count_route(K.flash_attention, "flash_attention", 0, "wgmma")
    with pytest.raises(RuntimeError, match="code 7"):
        _lib.count_route(K.moe_gmm, "moe_gmm", 7, "wgmma")
    with pytest.raises(RuntimeError, match="took route simt"):
        _lib.count_route(K.decode_attention, "decode_attention", 0, "mma")
    with pytest.raises(RuntimeError, match="took route mma"):
        _lib.count_route(K.moe_gmm_fused, "moe_gmm_fused", 3, "wgmma")
    with pytest.raises(RuntimeError, match="took route simt"):
        _lib.count_route(K.moe_gmm_fused_quant, "moe_gmm_quant", 0, "wgmma")
    assert K.launch_counts()["flash_attention"] == 0
    assert K.launch_counts()["moe_gmm"] == 0
    assert K.launch_counts()["decode_attention"] == 0
    assert K.launch_counts()["moe_gmm_fused"] == 0
    assert K.launch_counts()["moe_gmm_fused_quant"] == 0


def test_route_counts_list_every_kernel_with_routes():
    assert K.route_counts().keys() == {"flash_attention", "decode_attention",
                                       "moe_gmm_fused", "moe_gmm_fused_quant",
                                       "moe_gmm", "rwkv_scan"}
    assert set(K.decode_attention.launches_by_route) == {"mma", "simt"}
    assert set(K.moe_gmm_fused.launches_by_route) == {"wgmma", "simt"}
    assert set(K.moe_gmm_fused_quant.launches_by_route) == {"wgmma", "simt"}
    assert set(K.rwkv_scan.launches_by_route) == {"serial", "chunked"}
    # the launchers' routes; rwkv_scan's are its wrapper's own
    assert all(set(r) <= set(_lib.ROUTES)
               for n, r in K.route_counts().items() if n != "rwkv_scan")


@pytest.mark.parametrize("t,staged,expected", [
    (512, False, "chunked"),   # RWKV-6's prefill
    (33, False, "chunked"),    # one token past a chunk
    (32, False, "serial"),     # one chunk
    (1, False, "serial"),
    (5, True, "serial"),       # a [1+4] verification span
    (1, True, "serial"),
    (32, True, "serial"),      # the batched engine's chunk pass
    (512, True, "serial"),     # staged states are written token by token
])
def test_rwkv_scan_route_by_length_and_staging(t, staged, expected):
    assert rwkv_ops.route(t, staged) == expected


def test_rwkv_scan_chunk_matches_the_c_constant():
    src = (_lib.CSRC / "rwkv_scan.cu").read_text()
    assert int(re.search(r"constexpr int CL = (\d+);", src).group(1)) \
        == rwkv_ops.CHUNK


@pytest.mark.parametrize("t,staged", [(40, False), (40, True), (3, False)])
def test_recurrent_wrappers_on_cpu_count_no_route(t, staged):
    """On the CPU both scans take their plain versions, bit for bit, and
    count neither a launch nor a route (a T > CHUNK call without states
    would be chunked on the card)."""
    K.reset_launch_counts()
    gen = torch.Generator().manual_seed(t)
    r, k, v = (torch.randn((2, t, 3, 32), generator=gen) for _ in range(3))
    w = torch.rand((2, t, 3, 32), generator=gen)
    u = torch.randn((3, 32), generator=gen)
    s0 = torch.randn((2, 3, 32, 32), generator=gen)
    st = torch.empty((t + 1, 2, 3, 32, 32)) if staged else None
    ref_st = torch.empty_like(st) if staged else None
    got = K.rwkv_scan(r, k, v, w, u, s0, states=st)
    ref = K.rwkv_scan_plain(r, k, v, w, u, s0, states=ref_st)
    assert all(torch.equal(g, c) for g, c in zip(got, ref))
    if staged:
        assert torch.equal(st, ref_st)
    a, x = torch.rand((2, t, 24), generator=gen), torch.randn((2, t, 24))
    h0 = torch.randn((2, 24), generator=gen)
    assert all(torch.equal(g, c) for g, c in zip(
        K.linear_scan(a, x, h0), K.linear_scan_plain(a, x, h0)))
    assert K.rwkv_scan.launches_by_route == {"serial": 0, "chunked": 0}
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_on_cpu_take_the_plain_version_and_count_no_route(dtype):
    K.reset_launch_counts()
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 9, 2, 64), generator=gen).to(dtype)
    assert torch.equal(K.flash_attention(q, q, q),
                       K.flash_attention_plain(q, q, q))
    x = torch.randn((2, 5, 16), generator=gen).to(dtype)
    w = torch.randn((2, 16, 8), generator=gen).to(dtype)
    counts = torch.tensor([5, 2], dtype=torch.int32)
    assert torch.equal(K.moe_gmm(x, w, counts),
                       K.moe_gmm_plain(x, w, counts))
    wd = torch.randn((2, 8, 16), generator=gen).to(dtype)
    assert torch.equal(K.moe_gmm_fused(x, w, w, wd, counts),
                       K.moe_gmm_fused_plain(x, w, w, wd, counts))
    q8 = torch.randint(-127, 128, (2, 16, 16), generator=gen,
                       dtype=torch.int8)
    scale = torch.tensor([0.01, 0.02])
    assert torch.equal(
        K.moe_gmm_fused_quant(x, q8, q8, q8, scale, scale, scale, counts),
        K.moe_gmm_fused_quant_plain(x, q8, q8, q8, scale, scale, scale,
                                    counts))
    kv = torch.randn((1, 12, 1, 64), generator=gen).to(dtype)
    cache_pos = torch.arange(12, dtype=torch.int32)[None]
    q_pos = torch.tensor([[9, 10, 11]], dtype=torch.int32)
    assert torch.equal(
        K.decode_attention(q[:, :3], kv, kv, cache_pos, q_pos, window=4),
        K.decode_attention_plain(q[:, :3], kv, kv, cache_pos, q_pos,
                                 window=4))
    assert all(v == 0 for r in K.route_counts().values() for v in r.values())
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


@pytest.mark.parametrize("src", ["moe_gmm.cu", "decode_attention.cu",
                                 "moe_gmm_quant.cu"])
def test_redesigned_kernels_include_the_hopper_header(src):
    text = (_lib.CSRC / src).read_text()
    assert '#include "hopper.cuh"' in text
    assert "*route = " in text  # the launcher reports its route


def test_both_kernels_include_the_hopper_header_and_its_hash_covers_it(
        tmp_path, monkeypatch):
    for src in ("flash_attention.cu", "moe_gmm_grouped.cu"):
        assert '#include "hopper.cuh"' in (_lib.CSRC / src).read_text()
    copy = tmp_path / "csrc"
    shutil.copytree(_lib.CSRC, copy)
    monkeypatch.setattr(_lib, "CSRC", copy)
    before = _lib.library_path("moe_gmm_grouped")
    with open(copy / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _lib.library_path("moe_gmm_grouped") != before


_PROBE = r"""
import torch
from repro_torch import kernels as K
from repro_torch.kernels import _lib
q = torch.randn((1, 5, 2, 64)).bfloat16()
K.flash_attention(q, q, q, lse=True)
x = torch.randn((2, 3, 8)).bfloat16()
K.moe_gmm(x, torch.randn((2, 8, 8)).bfloat16(),
          torch.tensor([3, 1], dtype=torch.int32), transpose_w=True)
w = torch.randn((2, 8, 8)).bfloat16()
K.moe_gmm_fused(x, w, w, w, torch.tensor([3, 1], dtype=torch.int32))
q8 = torch.ones((2, 8, 8), dtype=torch.int8)
s = torch.ones(2)
K.moe_gmm_fused_quant(x, q8, q8, q8, s, s, s,
                      torch.tensor([3, 1], dtype=torch.int32))
K.decode_attention(q, q, q, torch.arange(5, dtype=torch.int32)[None],
                   torch.tensor([[0, 1, 2, 3, 4]], dtype=torch.int32))
assert not _lib._libs and not _lib._fns, "a library was built"
print("ok", torch.cuda.is_available())
"""


def test_import_and_cpu_calls_need_no_nvcc_and_no_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PATH=str(tmp_path), CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", "False"]
