"""The port's examples run end to end on the CPU (``--device cpu``), each
in a fresh interpreter as a user would start it; without the flag they
ask for the CUDA card, which they must not replace by the CPU."""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import configs

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_torch_serve_paged_on_the_cpu():
    """examples/torch_serve_paged.py: gemma2-2b SMOKE, 6 requests of 12
    new tokens through the paged engine, each finish_request freeing its
    blocks, then one user's eviction."""
    out = _run("examples/torch_serve_paged.py", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    done = [ln for ln in lines if ln.startswith("user ") and "tokens" in ln]
    assert len(done) == 6 and all(": 12 tokens" in ln for ln in done)
    assert "(0 live)" in done[-1]
    assert any(ln.startswith("6 requests in") and ln.endswith("on cpu")
               for ln in lines)
    assert lines[-1].startswith("user 42 eviction -> ")
    assert lines[-1].endswith("; 0 live")


def test_torch_serve_paged_defaults_to_the_card():
    out = _run("examples/torch_serve_paged.py")
    if torch.cuda.is_available():
        assert out.returncode == 0, out.stderr
        assert "on cuda" in out.stdout
    else:
        assert out.returncode != 0
        assert "no CUDA device" in out.stderr


def test_torch_train_launcher_on_the_cpu(tmp_path):
    """python -m repro_torch.launch.train --smoke --device cpu: gemma2-2b
    SMOKE (window, softcaps, remat full) for 6 steps with a checkpoint at
    step 3, then 2 more steps resumed from the step-6 checkpoint."""
    common = ["-m", "repro_torch.launch.train", "--arch", "gemma2-2b",
              "--smoke", "--device", "cpu", "--batch", "2", "--seq", "32",
              "--remat", "full", "--ckpt-dir", str(tmp_path),
              "--ckpt-every", "3"]
    out = _run(*common, "--steps", "6")
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0].startswith("arch=gemma2-2b-smoke")
    assert out.stdout.splitlines()[-1].startswith("finished at step 6; loss")
    out = _run(*common, "--steps", "8", "--resume")
    assert out.returncode == 0, out.stderr
    assert "resumed from step 6" in out.stdout
    assert out.stdout.splitlines()[-1].startswith("finished at step 8")


def test_torch_train_launcher_refusals(tmp_path):
    """``--mesh single`` is parsed and trains as ``--mesh none`` does,
    as the reference's launcher (which never reads the flag) does; it
    used to raise NotPorted. zamba2 trains on the card (its Mamba2 layers
    through the scan's backward kernel) as on the CPU."""
    from repro_torch.launch.train import main
    argv = ["--smoke", "--device", "cpu", "--steps", "1", "--batch", "2",
            "--seq", "16"]
    runs = [main(argv + ["--mesh", m, "--ckpt-dir", str(tmp_path / m)])
            for m in ("single", "none")]
    assert [float(h["loss"]) for h in runs[0].history] == \
        [float(h["loss"]) for h in runs[1].history]
    if torch.cuda.is_available():
        loop = main(["--arch", "zamba2-2.7b", "--smoke", "--steps", "1",
                     "--batch", "2", "--seq", "16", "--ckpt-dir",
                     str(tmp_path / "ck")])
        assert len(loop.history) == 1


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_torch_train_launcher_refuses_head_dims_the_card_lacks(arch):
    """On the card the launcher refuses, before it touches the device, a
    config whose attention head dim the flash kernels do not take: only
    starcoder2-7b's SMOKE config (head dim 4). Every full config and every
    other SMOKE config passes the check."""
    from repro_torch.launch.train import main, refuse_on_card
    from repro_torch.models.config import NotPorted
    refuse_on_card(configs.get_config(arch))
    if arch != "starcoder2-7b":
        refuse_on_card(configs.get_smoke(arch))
        return
    with pytest.raises(NotPorted, match="head dim 4"):
        main(["--arch", arch, "--smoke", "--device", "cuda"])


def test_torch_train_small_on_the_cpu(tmp_path):
    """examples/torch_train_small.py at 8 steps: the loss falls, and the
    restart resumes from the step-8 checkpoint and trains to step 10."""
    out = _run("examples/torch_train_small.py", "--steps", "8", "--device",
               "cpu", "--ckpt-dir", str(tmp_path / "ck"))
    assert out.returncode == 0, out.stderr
    assert "resumed from step 8" in out.stdout
    assert out.stdout.splitlines()[-1] == "resumed at step 8, continued to 10"
