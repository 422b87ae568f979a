"""The route choice of the two kernels with more than one route, on the
CPU: `flash_attention` (bf16 on wgmma fed by TMA, float32 on the CUDA
cores) and `moe_gmm` (bf16 on wgmma where d and F are multiples of 8, else
WMMA; float32 on the CUDA cores). The C launchers choose the route and
report it; the wrappers mirror the rule, count each launch by route and
raise if the two disagree. Nothing here builds or launches a kernel."""

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
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.moe_gmm import ops as moe_ops

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


def test_route_codes_match_the_c_enum():
    src = (_lib.CSRC / "common.cuh").read_text()
    codes = {name.lower(): int(v) for name, v in
             re.findall(r"RT_ROUTE_(\w+) = (\d+)", src)}
    assert codes == {r: i for i, r in enumerate(_lib.ROUTES)}


def test_launches_by_route_sum_to_launches():
    K.reset_launch_counts()
    code = {r: i for i, r in enumerate(_lib.ROUTES)}
    fa, mg = K.flash_attention, K.moe_gmm
    for route in ("wgmma", "wgmma", "simt"):
        _lib.count_route(fa, "flash_attention", code[route], route)
    for route in ("wgmma", "wmma", "simt", "wgmma"):
        _lib.count_route(mg, "moe_gmm", code[route], route)
    assert fa.launches_by_route == {"wgmma": 2, "simt": 1}
    assert mg.launches_by_route == {"wgmma": 2, "wmma": 1, "simt": 1}
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
    assert K.launch_counts()["flash_attention"] == 0
    assert K.launch_counts()["moe_gmm"] == 0


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
    assert all(v == 0 for r in K.route_counts().values() for v in r.values())
    assert K.launch_counts() == {n: 0 for n in K.KERNELS}


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
