"""Training launcher of the port: runs `make_train_step` for one of the
port's architectures, reduced, on the card (or on the CPU with
`--device cpu`), on the synthetic "all-3" task mix.

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
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: training an encoder-decoder stack is not ported "
            "(no backward kernel for cross-attention; ROADMAP queue 1, item "
            "8)")
    print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params "
          f"({cfg.active_param_count()/1e6:.1f}M active) on {device}")

    init_state, step = make_train_step(cfg, optimizer=adamw(args.lr))
    state = init_state(torch.Generator(device=device).manual_seed(0),
                       device=device)
    it = batch_iterator("all-3", args.batch, args.seq,
                        vocab=min(cfg.vocab_size, 512))
    t0 = time.time()
    for i in range(args.steps):
        state, m = step(state, next(it))
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(m['loss']):.4f}  "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
