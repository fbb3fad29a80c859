"""Train a small decoder LM through the PyTorch port with the production
step function (remat, AdamW, async checkpoints), then resume from its
checkpoint as a restarted job would.

Run: PYTHONPATH=src python examples/torch_train_small.py [--steps 200]
     [--device cpu]   (the CUDA card by default)
"""
import argparse
import pathlib
import shutil
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.train import main as train_main  # noqa: E402

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--device", default="cuda")
ap.add_argument("--ckpt-dir", default="checkpoints/torch_example")
args = ap.parse_args()

shutil.rmtree(args.ckpt_dir, ignore_errors=True)
every = max(args.steps // 4, 1)
common = ["--arch", "yi-6b", "--smoke", "--batch", "8", "--seq", "64",
          "--lr", "3e-3", "--ckpt-dir", args.ckpt_dir, "--ckpt-every",
          str(every), "--device", args.device]

# phase 1: train, checkpointing every quarter of the run
loop = train_main(common + ["--steps", str(args.steps)])
losses = [h["loss"] for h in loop.history]
assert losses[-1] < losses[0], "loss should fall"

# phase 2: a restart resumes from the latest checkpoint and trains on
print("\n-- simulated restart (resume from the latest checkpoint) --")
loop2 = train_main(common + ["--steps", str(args.steps + every),
                             "--resume"])
print(f"resumed at step {loop2.start_step}, "
      f"continued to {loop2.history[-1]['step']}")
