"""Training launcher of the port: runs `make_train_step` for one of the
port's architectures, reduced, on the card (or on the CPU with
`--device cpu`), on the synthetic "all-3" task mix; encoder-decoder and
vision-stub configs get zero encoder states or patch embeddings, as the
JAX package's launcher feeds them (`launch_batch`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \\
        --steps 20 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.data import batch_iterator
from repro_torch.device import resolve_device
from repro_torch.training import adamw, make_train_step


def launch_batch(cfg, raw, batch: int, seq: int, device=None) -> dict:
    """A step's batch from the "all-3" iterator's arrays `raw`, as the JAX
    package's launcher builds it: an encoder-decoder config also gets zero
    encoder states `enc_out` [batch, encoder_len, encoder_d_model], and a
    `vision_stub` config zero patch embeddings `embeds` [batch, seq,
    d_model] in place of its tokens, both in `cfg.dtype` on `device` (the
    card by default)."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    out = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
    if cfg.is_encoder_decoder:
        out["enc_out"] = torch.zeros(
            (batch, cfg.encoder_len, cfg.encoder_d_model), dtype=dtype,
            device=dev)
    if cfg.vision_stub:
        out["embeds"] = torch.zeros((batch, seq, cfg.d_model), dtype=dtype,
                                    device=dev)
        out.pop("tokens")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mixtral-8x7b", choices=ALL_ARCHS)
    # As in the JAX package's launcher, --reduced is a store_true flag that
    # defaults to True, so the reduced config always runs; kept as it is.
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params "
          f"({cfg.active_param_count()/1e6:.1f}M active) on {device}")

    init_state, step = make_train_step(cfg, optimizer=adamw(args.lr))
    state = init_state(torch.Generator(device=device).manual_seed(0),
                       device=device)
    it = batch_iterator("all-3", args.batch, args.seq,
                        vocab=min(cfg.vocab_size, 512))
    t0 = time.time()
    for i in range(args.steps):
        batch = launch_batch(cfg, next(it), args.batch, args.seq,
                             device=device)
        state, m = step(state, batch)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(m['loss']):.4f}  "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
