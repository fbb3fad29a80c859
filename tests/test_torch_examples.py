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
    """No config is refused any more: every arch's full and SMOKE config
    that attends does so at a head dim the flash wrappers take on the card
    (starcoder2-7b's SMOKE head dim 4 through the zero-padded route, at
    the kernels' head dim 8), and the launcher no longer carries a
    refusal."""
    import repro_torch.launch.train as LT
    from repro_torch.kernels import flash_attention as FA
    assert not hasattr(LT, "refuse_on_card")
    for cfg in (configs.get_config(arch), configs.get_smoke(arch)):
        if not (cfg.attn_layer_ids or cfg.shared_attn_every > 0
                or cfg.is_encdec):
            continue   # attention-free (falcon-mamba): no flash call
        assert FA.takes_head_dim(cfg.head_dim), (cfg.name, cfg.head_dim)
        assert FA.kernel_head_dim(cfg.head_dim) in FA.HEAD_DIMS
    if arch == "starcoder2-7b":
        assert configs.get_smoke(arch).head_dim in FA.PADDED_HEAD_DIMS


def test_torch_train_small_on_the_cpu(tmp_path):
    """examples/torch_train_small.py at 8 steps: the loss falls, and the
    restart resumes from the step-8 checkpoint and trains to step 10."""
    out = _run("examples/torch_train_small.py", "--steps", "8", "--device",
               "cpu", "--ckpt-dir", str(tmp_path / "ck"))
    assert out.returncode == 0, out.stderr
    assert "resumed from step 8" in out.stdout
    assert out.stdout.splitlines()[-1] == "resumed at step 8, continued to 10"


def test_torch_quickstart_prints_the_references_rows():
    """examples/torch_quickstart.py on the CPU prints the rows, the
    average, the expired counts, the rows left and the payload's shape
    that examples/quickstart.py prints (the payload a torch tensor)."""
    ref = _run("examples/quickstart.py")
    got = _run("examples/torch_quickstart.py", "--device", "cpu")
    assert ref.returncode == 0, ref.stderr
    assert got.returncode == 0, got.stderr
    want, lines = ref.stdout.splitlines(), got.stdout.splitlines()
    assert lines[:-1] == want[:-1]
    assert lines[-1].startswith(want[-1].split(" dtype:")[0] + " dtype: "
                                "torch.float32 device: cpu")


def _reference_cms(requests: int) -> dict:
    """examples/cms_cache_sim.py's two runs at ``requests`` requests
    (its source with ``REQUESTS`` set, its printing loop left out), hits
    and expired entries counted by wrapping its daemon and cache."""
    from repro.core.baseline import MemcachedLike
    from repro.core.daemon import SQLCached
    seen = {"sqlcached": [0, 0], "memcached": [0, 0]}

    class DB(SQLCached):
        def execute(self, sql, params=()):
            r = super().execute(sql, params)
            if sql.startswith("SELECT kind"):
                seen["sqlcached"][0] += r.count > 0
            elif sql.startswith("DELETE"):
                seen["sqlcached"][1] += r.count
            return r

    class MC(MemcachedLike):
        def get(self, key):
            v = super().get(key)
            seen["memcached"][0] += key.endswith(":header") and v is not None
            return v

        def flush_all(self):
            n = super().flush_all()
            seen["memcached"][1] += n
            return n

    src = (ROOT / "examples/cms_cache_sim.py").read_text()
    src = src.replace("REQUESTS = 2000", f"REQUESTS = {requests}")
    body = src.split("\nfor name, fn in (")[0]
    ns = {"__name__": "cms"}
    exec(compile(body, "cms_cache_sim.py", "exec"), ns)
    ns["SQLCached"], ns["MemcachedLike"] = DB, MC
    ns["run_sqlcached"]()
    ns["run_memcached"]()
    return seen


def test_torch_cms_cache_sim_gives_the_references_hits():
    """examples/torch_cms_cache_sim.py --requests 200 on the CPU: each
    cache's hits and expired entries equal the reference example's on the
    same seeded stream."""
    got = _run("examples/torch_cms_cache_sim.py", "--device", "cpu",
               "--requests", "200")
    assert got.returncode == 0, got.stderr
    want = _reference_cms(200)
    for name in ("sqlcached", "memcached"):
        line = next(ln for ln in got.stdout.splitlines()
                    if ln.startswith(name))
        hits, expired = want[name]
        assert f"hits {hits}/200  expired {expired}" in line, (line, want)
