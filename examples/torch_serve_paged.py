"""End-to-end example for the PyTorch port: serve a small model with
batched requests on the paged-KV engine (the paper's technique on the
serving hot path); the counterpart of ``examples/serve_paged.py``.

Run: PYTHONPATH=src python examples/torch_serve_paged.py [--device cpu]

The default device is the CUDA card (each decode round there is one
captured CUDA graph); ``--device cpu`` runs every kernel's plain version.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.daemon import resolve_device
from repro_torch.models import transformer as TF
from repro_torch.serving.engine import ServeEngine

ARCH = "gemma2-2b"          # reduced same-family config
N_REQUESTS = 6
NEW_TOKENS = 12


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.get_smoke(ARCH)
    params = TF.init_model(torch.Generator(device=dev).manual_seed(0), cfg,
                           dev)
    eng = ServeEngine(cfg, params, max_slots=4, max_seq=128, block=8,
                      device=dev)
    rng = np.random.default_rng(0)

    pending = [rng.integers(0, cfg.vocab, size=int(rng.integers(8, 20)))
               .astype(np.int32) for _ in range(N_REQUESTS)]
    users = list(range(N_REQUESTS))
    done = 0
    t0 = time.perf_counter()
    while done < N_REQUESTS:
        while pending and len(eng.requests) < eng.max_slots:
            eng.add_request(pending.pop(), user_id=users[done + len(pending)])
        eng.decode_round()
        for s in [s for s, r in eng.requests.items()
                  if len(r.generated) >= NEW_TOKENS]:
            r = eng.requests[s]
            n = eng.finish_request(s)   # SQL: DELETE FROM kv WHERE seq_id=?
            done += 1
            print(f"user {r.user_id}: {len(r.generated)} tokens, "
                  f"freed {n} blocks ({eng.live_blocks()} live)")
    print(f"\n{N_REQUESTS} requests in {time.perf_counter() - t0:.1f}s over "
          f"{eng.decode_steps} continuous-batching rounds on {eng.device}")

    # a "content update" invalidates ONE user's sessions mid-flight: the
    # paper's Table 2 operation, not a cache flush
    eng.add_request(rng.integers(0, cfg.vocab, 10).astype(np.int32),
                    user_id=42)
    print("user 42 eviction ->", eng.evict_user(42), "blocks dropped; "
          f"{eng.live_blocks()} live")


if __name__ == "__main__":
    main()
