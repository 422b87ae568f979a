"""Weights across frameworks: the JAX package's parameter tree, as numpy
arrays, into the port's tree of tensors with the same names and shapes."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: reinterpret bits
        t = torch.from_numpy(np.array(a, copy=True, order="C").view(np.int16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True, order="C"))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device=None, dtype=None):
    """Map a nested dict/list/tuple of numpy arrays (for example
    `jax.device_get(params)`) to the same tree of tensors on `device` (the
    card by default). `dtype` casts floating leaves; None keeps each leaf's
    type, bfloat16 included."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, dev, dtype) for v in tree)
    return _tensor(tree, dev, dtype)
