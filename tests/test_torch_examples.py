"""The port's examples run end to end on the CPU (``--device cpu``), each
in a fresh interpreter as a user would start it; without the flag they
ask for the CUDA card, which they must not replace by the CPU."""
import os
import pathlib
import subprocess
import sys

import torch

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
