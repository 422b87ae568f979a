"""Checkpointing of a tree of tensors: `save(path, tree)` and
`restore(path, device=None)`.

Format: `torch.save` of the tree itself (PyTorch's zip archive: one
pickle of the containers and primitive values, one raw record per tensor
storage). `restore` reads it with `torch.load(weights_only=True)`, which
unpickles only containers, tensors and primitive values, so a checkpoint
cannot run code, and needs no package beyond PyTorch. The JAX package
writes msgpack instead, which the port does not need.

Tree semantics are the JAX package's: dicts, lists and tuples stay apart;
python scalars, strings and None are leaves; every tensor leaf keeps its
dtype and bits (bf16, float32, int32 and int8 included) and its shape (a
0-d tensor stays a tensor). A NamedTuple (the optimizers' `OptState`) is
written as the plain tuple of its fields, since the loader rebuilds no
class: `OptState(*restored)` makes it again (the JAX package gives back
a list there). Tensors are copied to the host before they are
written, so a view is saved alone, not with the storage behind it.

The write is atomic: the file goes to `<path>.tmp`, then `os.replace`
puts it in place. `restore` loads onto the card unless the caller passes
`device="cpu"`, as every entry point of the port does."""

from __future__ import annotations

import os
from typing import Any

import torch

from repro_torch.device import resolve_device

_PRIMITIVES = (bool, int, float, str, type(None))


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        kind = tuple if isinstance(tree, tuple) else list
        return kind(_host_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, _PRIMITIVES):
        return tree
    raise TypeError(f"checkpoint: cannot save a leaf of type "
                    f"{type(tree).__name__}; leaves are tensors, python "
                    f"scalars, strings or None")


def save(path: str, tree: Any) -> None:
    """Write `tree` to `path` atomically (the parent directory is made if
    it is missing)."""
    host = _host_tree(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(host, tmp)
    os.replace(tmp, path)  # atomic


def restore(path: str, device=None) -> Any:
    """Read the tree `save` wrote, its tensors on `device` (the card by
    default; a machine without one raises unless device="cpu")."""
    dev = resolve_device(device)
    return torch.load(path, map_location=dev, weights_only=True)
