"""Serving launcher of the port: runs the single-request speculative
decoding engine with Cascade (or a static K) for one of the port's
architectures, reduced, on the card (or on the CPU with `--device cpu`),
over a synthetic mixed request stream, priced on the model clock for
`H100_SXM`. An encoder-decoder architecture (Whisper) gets zero encoder
states of its `encoder_len` frames with every request.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \\
        --policy cascade --requests 4 [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core import CascadeController, StaticKController
from repro_torch.data import make_sample
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving import NGramDrafter, Request, Scheduler, ServingEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mixtral-8x7b", choices=ALL_ARCHS)
    ap.add_argument("--policy", default="cascade",
                    choices=["cascade", "k0", "k1", "k2", "k3"])
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    if cfg.attention_free or cfg.layer_pattern:
        print(f"note: {cfg.name} decodes through staged recurrent states")
    params = T.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    enc = None
    if cfg.is_encoder_decoder:   # the encoder is a stub: zero states
        enc = torch.zeros((1, cfg.encoder_len, cfg.encoder_d_model),
                          dtype=getattr(torch, cfg.dtype), device=device)

    factory = (CascadeController if args.policy == "cascade"
               else lambda: StaticKController(int(args.policy[1:])))
    engine = ServingEngine(cfg, params, NGramDrafter(), max_len=512,
                           temperature=0.0, clock="model", device=device)
    sched = Scheduler(engine, controller_factory=factory)
    rng = np.random.default_rng(args.seed)
    tasks = ["code", "math", "extract"]
    reqs = [Request(request_id=f"r{i}",
                    prompt=make_sample(tasks[i % 3], rng,
                                       vocab=cfg.vocab_size,
                                       prompt_len=48, cont_len=1).prompt,
                    max_new=args.max_new, task=tasks[i % 3], enc_out=enc)
            for i in range(args.requests)]
    sched.run(reqs)
    print(f"{cfg.name} policy={args.policy} on {device}: "
          f"{sched.tokens_per_second():.1f} tok/s "
          f"(model clock, {engine.hw.name}), "
          f"TPOT {sched.mean_tpot()*1e3:.3f} ms")
    for r in sched.results:
        t = r.telemetry
        print(f"  {t.request_id} [{t.task:8s}] out={t.output_tokens} "
              f"iters={len(t.iterations)} etr={t.etr:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
