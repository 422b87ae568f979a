"""Build and load the port's CUDA kernels.

Each source under `csrc/` is compiled by its own `nvcc` for `sm_90a` into a
shared library with a plain C interface, all sources at once, at first use,
into `build/repro_torch/` at the root of the checkout (listed in
`.gitignore`). A library's file name carries a hash of its sources and
flags, so an edited source is rebuilt and a stale one is never loaded.
Nothing here runs at import: `import repro_torch` needs no `nvcc` and no
card."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flash_attention", "decode_attention", "moe_gmm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: dtype codes of the C interfaces (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs: dict = {}
#: ptxas report (registers, shared memory, spills) of each compiled source
ptxas_log: dict = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin;"
                           " the CUDA kernels cannot be built")
    return exe


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (*sorted(CSRC.glob("*.cuh")), CSRC / f"{name}.cu"):
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile every source's library not yet built, one `nvcc` per source
    started together, and load them. Returns the seconds it took."""
    with _lock:
        t0 = time.perf_counter()
        todo = [n for n in SOURCES if n not in _libs]
        procs = []
        for n in todo:
            out = _library_path(n)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs.append((n, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        errors = []
        for n, out, tmp, proc in procs:
            stdout, stderr = proc.communicate()
            ptxas_log[n] = stdout + stderr
            if proc.returncode != 0:
                errors.append(f"{n}.cu (exit {proc.returncode}):\n{stderr}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        for n in todo:
            _libs[n] = ctypes.CDLL(str(_library_path(n)))
            _libs[n].rt_error_string.argtypes = [ctypes.c_int]
            _libs[n].rt_error_string.restype = ctypes.c_char_p
        return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of source `name`; the first call builds them all."""
    if name not in _libs:
        build()
    return _libs[name]


def check(name: str, err: int) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if err != 0:
        msg = library(name).rt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's card, as a C pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors) -> None:
    """A wrapper's common checks: every tensor on one card, contiguous and
    16-byte aligned (the kernels load 16 bytes at a time)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must all lie on one CUDA "
                             f"device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
