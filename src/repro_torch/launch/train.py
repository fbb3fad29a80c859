"""Training launcher (port of ``repro.launch.train``; the same flags plus
``--device`` and ``--seed``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
        --smoke --device cpu --steps 50 --batch 8 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
        --batch 1 --seq 8192 --remat full --steps 3

Parameters come from ``init_model`` with a ``torch.Generator`` seeded
with ``--seed`` on the target device (the reference draws them from
``PRNGKey(0)``), batches from the synthetic pipeline seeded the same way.
The default device is the CUDA card; without one it raises unless
``--device cpu`` is given. ``--mesh single|multi`` is parsed and, as in
the reference's launcher, trains exactly as ``--mesh none`` does (the
reference never reads it). Every arch's config trains on the card,
starcoder2-7b's SMOKE config (head dim 4) included: the flash wrappers
zero-pad its heads to the kernels' head dim 8
(``kernels/flash_attention.padded``).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch.core.daemon import resolve_device
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.models import transformer as TF
from repro_torch.optim.adamw import adamw_init
from repro_torch.training.loop import LoopConfig, TrainLoop
from repro_torch.training.step import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=list(TF.REMATS))
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="checkpoints/train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "single", "multi"],
                    help="parsed and unused, as in the reference: every "
                    "value trains on one device")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get_config(args.arch))
    dev = resolve_device(args.device)
    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"active~{cfg.active_param_count()/1e6:.1f}M", flush=True)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = TF.init_model(gen, cfg, dev)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, remat=args.remat,
                              microbatches=args.microbatches,
                              peak_lr=args.lr, warmup=10,
                              total_steps=args.steps)
    data = SyntheticDataset(cfg, args.batch, args.seq, seed=args.seed)
    loop = TrainLoop(step_fn, params, opt, data,
                     LoopConfig(total_steps=args.steps,
                                ckpt_every=args.ckpt_every,
                                ckpt_dir=args.ckpt_dir))
    if args.resume and loop.try_resume():
        print(f"resumed from step {loop.start_step}", flush=True)
    end = loop.run()
    losses = [h["loss"] for h in loop.history]
    if losses:
        print(f"finished at step {end}; loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}", flush=True)
    return loop


if __name__ == "__main__":
    main()
