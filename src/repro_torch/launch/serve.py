"""Serving launcher, ported: batched generation with slot-based continuous
batching on a reduced dense decoder with random weights.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --requests 8 --slots 4 --max-new 16 [--device cpu]

Runs on the card (``--device cuda``, the default: prefill attention goes
through the hand-written flash-attention kernel) or on the CPU with the
kernel's plain PyTorch version.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models import init_lm
from repro_torch.serving import Request, Server


def main(argv=None) -> dict[int, list[int]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the hand-written kernel; cpu its plain "
                         "PyTorch version")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    model = init_lm(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(args.seed))
    srv = Server(model, n_slots=args.slots, max_seq=args.max_seq,
                 seed=args.seed)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(prompt=[int(t) for t in rng.integers(
                        1, cfg.vocab, size=rng.integers(3, 12))],
                    max_new_tokens=args.max_new,
                    temperature=args.temperature, rid=i)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    out = srv.generate(reqs)
    dt = time.perf_counter() - t0
    n_tok = sum(len(v) for v in out.values())
    print(f"{len(out)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s on {dev})")
    for rid in sorted(out):
        print(f"  req {rid}: {out[rid][:10]}"
              f"{'…' if len(out[rid]) > 10 else ''}")
    return out


if __name__ == "__main__":
    main()
