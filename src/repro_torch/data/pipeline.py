"""Token-stream data pipeline: packs workload samples into fixed-shape
training batches (next-token prediction with loss masked over prompts
optional). Deterministic, seedable, infinite. A copy of the JAX package's
`data/pipeline.py` (numpy only)."""

from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np

from .workloads import MIXES, PAD, make_sample


def pack_batch(samples, seq_len: int, pad: int = PAD) -> Dict[str, np.ndarray]:
    """Concatenate prompt+continuation per sample, truncate/pad to seq_len.
    labels are inputs shifted left; mask excludes padding."""
    b = len(samples)
    tokens = np.full((b, seq_len), pad, np.int32)
    labels = np.full((b, seq_len), pad, np.int32)
    mask = np.zeros((b, seq_len), np.float32)
    for i, s in enumerate(samples):
        seq = (s.prompt + s.continuation)[:seq_len + 1]
        n = min(len(seq) - 1, seq_len)
        tokens[i, :n] = seq[:n]
        labels[i, :n] = seq[1:n + 1]
        mask[i, :n] = 1.0
    return {"tokens": tokens, "labels": labels, "mask": mask}


def batch_iterator(mix: str, batch_size: int, seq_len: int, *,
                   vocab: int = 256, seed: int = 0,
                   prompt_len: int = 64) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    tasks = MIXES[mix]
    i = 0
    while True:
        samples = [make_sample(tasks[(i + j) % len(tasks)], rng,
                               vocab=vocab, prompt_len=prompt_len,
                               cont_len=seq_len - prompt_len)
                   for j in range(batch_size)]
        i += batch_size
        yield pack_batch(samples, seq_len)
