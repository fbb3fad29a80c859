"""Serving launcher: continuous batching on the paged KV pool (port of
``repro.launch.serve``; same CLI, same default traffic, plus
``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-moe-1b-a400m

Every arch of the reference is ported (``configs.PORTED``). The
launcher sends text prompts with no request extras, as the reference's
does: internvl2-1b is then served without its frontend, and
seamless-m4t-large-v2, whose prefill needs ``enc_frames``, stops at its
first request (a ``KeyError``, as in the reference). phi3.5-moe's 41.7 B
bf16 parameters do not fit one 80 GB card.

Weights are random, drawn from a ``torch.Generator`` seeded with 0 on the
target device (the reference draws them from ``PRNGKey(0)``); the
prompts come from ``--seed`` exactly as the reference draws them. The
default device is the CUDA card; without one it raises unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.daemon import resolve_device
from repro_torch.models import transformer as TF
from repro_torch.serving.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--block", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = TF.init_model(gen, cfg, dev)
    eng = ServeEngine(cfg, params, max_slots=args.slots, max_seq=256,
                      block=args.block, device=dev)
    rng = np.random.default_rng(args.seed)

    pending = [rng.integers(0, cfg.vocab, size=int(rng.integers(8, 24)))
               .astype(np.int32) for _ in range(args.requests)]
    done = 0
    t0 = time.perf_counter()
    tokens_out = 0
    while done < args.requests:
        # admit while there is room (continuous batching)
        while pending and len(eng.requests) < eng.max_slots:
            eng.add_request(pending.pop(), user_id=done + len(pending))
        eng.decode_round()
        tokens_out += len(eng.requests)
        finished = [s for s, r in eng.requests.items()
                    if len(r.generated) >= args.new_tokens]
        for s in finished:
            n = eng.finish_request(s)  # SQL: DELETE WHERE seq_id = ?
            done += 1
            print(f"request done (slot {s}): freed {n} KV blocks; "
                  f"{eng.live_blocks()} live")
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"served {args.requests} requests, {tokens_out} tokens in "
          f"{dt:.1f}s ({tokens_out/dt:.1f} tok/s); "
          f"{eng.decode_steps} decode rounds on {where}")


if __name__ == "__main__":
    main()
