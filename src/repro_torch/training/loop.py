"""Fault-tolerant training loop (port of ``repro.training.loop``).

- **checkpoint / restart**: asynchronous checkpoints every
  ``ckpt_every`` steps and on SIGTERM / SIGINT (preemption);
  :meth:`TrainLoop.try_resume` picks the latest complete step and the
  step-indexed data pipeline replays exactly.
- **stragglers**: an EWMA of each host's step time; hosts slower than
  ``straggler_factor`` x the median are flagged (one process here: every
  host sees this process's step time, as in the reference).

Batches are numpy on the host and reach the parameters' device through
pinned, non-blocking copies (plain copies on the CPU). The step function
updates the parameters and moments in place (``training/step.py``).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint.store import (AsyncCheckpointer, latest_step,
                                          restore)
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.optim.adamw import tree_leaves


class StragglerMonitor:
    """EWMA step times per host; flags hosts slower than factor x
    median."""

    def __init__(self, n_hosts: int, alpha: float = 0.2,
                 factor: float = 2.0):
        self.ewma = np.zeros(n_hosts)
        self.alpha = alpha
        self.factor = factor
        self.flagged: set[int] = set()

    def update(self, host_times: np.ndarray) -> set[int]:
        m = self.ewma == 0
        self.ewma = np.where(
            m, host_times, (1 - self.alpha) * self.ewma
            + self.alpha * host_times)
        med = float(np.median(self.ewma))
        slow = {int(i) for i in np.nonzero(
            self.ewma > self.factor * max(med, 1e-9))[0]}
        self.flagged = slow
        return slow


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    log_every: int = 10
    straggler_factor: float = 2.0


def to_device(batch: dict, device: torch.device) -> dict:
    """A numpy batch on ``device``: pinned host buffers and non-blocking
    copies to a card, plain tensors on the CPU."""
    out = {}
    for k, a in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class TrainLoop:
    def __init__(self, step_fn: Callable, params, opt,
                 dataset: SyntheticDataset, cfg: LoopConfig):
        self.step_fn = step_fn
        self.params, self.opt = params, opt
        self.device = tree_leaves(params)[0].device
        self.data = dataset
        self.cfg = cfg
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir)
        self.monitor = StragglerMonitor(
            max(dataset.num_shards, 1), factor=cfg.straggler_factor)
        self.start_step = 0
        self.history: list[dict] = []
        self._preempted = False

    # ------------------------------------------------------------ restart
    def try_resume(self) -> bool:
        s = latest_step(self.cfg.ckpt_dir)
        if s is None:
            return False
        state, _ = restore(self.cfg.ckpt_dir, s,
                           {"params": self.params, "opt": self.opt})
        self.params, self.opt = state["params"], state["opt"]
        self.start_step = s
        return True

    def _sigterm(self, *_):
        self._preempted = True

    def _state(self) -> dict:
        return {"params": self.params, "opt": self.opt}

    # ---------------------------------------------------------------- run
    def run(self) -> int:
        prev = (signal.signal(signal.SIGTERM, self._sigterm),
                signal.signal(signal.SIGINT, self._sigterm))
        try:
            step = self.start_step
            while step < self.cfg.total_steps and not self._preempted:
                batch = to_device(self.data.batch_at(step), self.device)
                t0 = time.perf_counter()
                self.params, self.opt, metrics = self.step_fn(
                    self.params, self.opt, batch, step)
                loss = float(metrics["loss"])   # waits for the step
                dt = time.perf_counter() - t0
                # one process: every host saw this step time
                self.monitor.update(np.full(self.monitor.ewma.shape, dt))
                step += 1
                self.history.append({"step": step, "loss": loss, "dt": dt,
                                     "stragglers":
                                         sorted(self.monitor.flagged)})
                if step % self.cfg.log_every == 0:
                    print(f"step {step:5d} loss {loss:.4f} {dt*1e3:.0f}ms",
                          flush=True)
                if step % self.cfg.ckpt_every == 0:
                    t0 = time.perf_counter()
                    self.ckpt.save_async(step, self._state(), {"loss": loss})
                    # the copy to the host; the write goes on behind
                    self.history[-1]["ckpt_copy_s"] = time.perf_counter() - t0
            if self._preempted:  # the preemption checkpoint
                self.ckpt.wait()
                self.ckpt.save_async(step, self._state(),
                                     {"preempted": True})
            self.ckpt.wait()
            return step
        finally:
            signal.signal(signal.SIGTERM, prev[0])
            signal.signal(signal.SIGINT, prev[1])
