"""The port's training loop and checkpoints on the CPU: the counterparts
of the reference's ``tests/test_checkpoint_loop.py`` (train then resume
exactly, the preemption checkpoint, the straggler monitor, the async
checkpointer's garbage collection), the checkpoint store's NamedTuple
trees (the optimizer's ``AdamWState``: leaves ``opt/.mu/<path>``,
``opt/.nu/<path>``, ``opt/.count`` as the reference spells them), and
training checkpoints that cross between the packages both ways, bf16
leaves included: a checkpoint the reference's loop wrote resumes in the
port's loop (and the reverse) with step losses within 1e-4 of the run
that did not stop."""
import json
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.checkpoint import store as JCK
from repro.data.synthetic import SyntheticDataset as JData
from repro.models import transformer as JTF
from repro.models.params import split
from repro.optim.adamw import AdamWState as JState
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.training.loop import LoopConfig as JLoopConfig
from repro.training.loop import TrainLoop as JTrainLoop
from repro.training.step import make_train_step as j_make_train_step
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.checkpoint import store as TCK
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.optim.adamw import AdamWState, adamw_init, tree_leaves
from repro_torch.training.loop import LoopConfig, StragglerMonitor, TrainLoop
from repro_torch.training.step import make_train_step

STEP_KW = dict(peak_lr=1e-3, warmup=2, total_steps=6)


def _params(arch="yi-6b"):
    cfg = JC.get_smoke(arch)
    return jax.tree.map(np.asarray,
                        split(JTF.init_model(jax.random.PRNGKey(0), cfg))[0])


def _port_loop(tmp_path, steps=6, ckpt_every=2, numpy_params=None):
    cfg = TC.get_smoke("yi-6b")
    params = convert.params_from_numpy(cfg, numpy_params or _params(), "cpu")
    step_fn = make_train_step(cfg, remat="none", **STEP_KW)
    data = SyntheticDataset(cfg, 2, 16, seed=3)
    return TrainLoop(step_fn, params, adamw_init(params), data,
                     LoopConfig(total_steps=steps, ckpt_every=ckpt_every,
                                ckpt_dir=str(tmp_path), log_every=100))


def _ref_loop(tmp_path, steps=6, ckpt_every=2):
    cfg = JC.get_smoke("yi-6b")
    params = jax.tree.map(jnp.asarray, _params())
    step_fn = jax.jit(j_make_train_step(cfg, remat="none", **STEP_KW))
    return JTrainLoop(step_fn, params, j_adamw_init(params),
                      JData(cfg, 2, 16, seed=3),
                      JLoopConfig(total_steps=steps, ckpt_every=ckpt_every,
                                  ckpt_dir=str(tmp_path), log_every=100))


def _opt_tree(rng, dtype=torch.float32):
    params = {"w": torch.from_numpy(rng.standard_normal((3, 4)).astype(
        np.float32)).to(dtype),
        "blk": {"b": torch.from_numpy(rng.standard_normal(5).astype(
            np.float32)).to(dtype)}}
    opt = adamw_init(params)
    opt.mu["w"].normal_()
    opt.nu["blk"]["b"].uniform_()
    return {"params": params,
            "opt": AdamWState(opt.mu, opt.nu, torch.tensor(7,
                                                           dtype=torch.int32))}


def test_namedtuple_tree_round_trip(tmp_path):
    """save -> restore of {"params", "opt": AdamWState} in the port, the
    field names in the files, bf16 kept."""
    tree = _opt_tree(np.random.default_rng(0), torch.bfloat16)
    TCK.save(tmp_path, 3, tree)
    names = json.loads((tmp_path / "step_3" / "meta.json").read_text())
    assert sorted(names["names"]) == [
        "opt/.count", "opt/.mu/blk/b", "opt/.mu/w", "opt/.nu/blk/b",
        "opt/.nu/w", "params/blk/b", "params/w"]
    like = _opt_tree(np.random.default_rng(1), torch.bfloat16)
    got, _ = TCK.restore(tmp_path, 3, like)
    assert isinstance(got["opt"], AdamWState)
    for a, b in zip(tree_leaves(TCK._flatten(tree)),
                    tree_leaves(TCK._flatten(got))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the async writer (through host_copy) takes the same trees
    ck = TCK.AsyncCheckpointer(tmp_path / "async")
    ck.save_async(4, tree)
    ck.wait()
    got, _ = TCK.restore(tmp_path / "async", 4, like)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(TCK._flatten(tree)), tree_leaves(TCK._flatten(got))))


def _ref_tree(tree):
    """The port's {"params", "opt"} tree as the reference's (jnp, with
    its AdamWState)."""
    j = lambda t: jnp.asarray(t.float().numpy(),  # noqa: E731
                              dtype=jnp.bfloat16 if t.dtype == torch.bfloat16
                              else jnp.dtype(str(t.dtype).split(".")[-1]))
    o = tree["opt"]
    conv = lambda d: jax.tree.map(j, d,  # noqa: E731
                                  is_leaf=lambda x: isinstance(x,
                                                               torch.Tensor))
    return {"params": conv(tree["params"]),
            "opt": JState(conv(o.mu), conv(o.nu), j(o.count))}


def _same(jtree, ttree):
    """Leaf for leaf, by the names both stores write."""
    jl, tl = JCK._flatten(jtree), TCK._flatten(ttree)
    assert sorted(jl) == sorted(tl)
    for key, leaf in jl.items():
        t = tl[key]
        np.testing.assert_array_equal(np.asarray(leaf, np.float32),
                                      t.float().numpy())
        assert str(jnp.dtype(leaf.dtype)) == str(t.dtype).split(".")[-1]


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _opt_tree(np.random.default_rng(2), torch.bfloat16)
    JCK.save(tmp_path, 5, _ref_tree(tree))
    got, _ = TCK.restore(tmp_path, 5,
                         _opt_tree(np.random.default_rng(3), torch.bfloat16))
    _same(_ref_tree(tree), got)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _opt_tree(np.random.default_rng(4), torch.bfloat16)
    TCK.save(tmp_path, 6, tree)
    like = _ref_tree(_opt_tree(np.random.default_rng(5), torch.bfloat16))
    got, _ = JCK.restore(tmp_path, 6, like)
    _same(got, tree)


def test_train_then_resume_exact(tmp_path):
    loop = _port_loop(tmp_path)
    assert loop.run() == 6
    full = {h["step"]: h["loss"] for h in loop.history}
    loop2 = _port_loop(tmp_path)
    assert loop2.try_resume() and loop2.start_step == 6
    loop3 = _port_loop(tmp_path)
    state, _ = TCK.restore(tmp_path, 4, {"params": loop3.params,
                                         "opt": loop3.opt})
    loop3.params, loop3.opt = state["params"], state["opt"]
    loop3.start_step = 4
    loop3.run()
    assert [h["step"] for h in loop3.history] == [5, 6]
    for h in loop3.history:
        assert abs(h["loss"] - full[h["step"]]) < 1e-4


def test_reference_run_resumes_in_the_port(tmp_path):
    """The reference trains 6 steps, checkpointing every 2; the port
    resumes its step-4 checkpoint (weights, moments, count) and takes
    steps 5 and 6 with the reference's losses."""
    ref = _ref_loop(tmp_path / "ref")
    ref.run()
    want = {h["step"]: h["loss"] for h in ref.history}
    shutil.rmtree(tmp_path / "ref" / "step_6")   # the port resumes step 4
    loop = _port_loop(tmp_path / "ref")
    assert loop.try_resume() and loop.start_step == 4
    assert int(loop.opt.count) == 4
    loop.run()
    for h in loop.history:
        assert abs(h["loss"] - want[h["step"]]) < 1e-4


def test_port_run_resumes_in_the_reference(tmp_path):
    port = _port_loop(tmp_path / "port")
    port.run()
    want = {h["step"]: h["loss"] for h in port.history}
    shutil.rmtree(tmp_path / "port" / "step_6")
    ref = _ref_loop(tmp_path / "port")
    assert ref.try_resume() and ref.start_step == 4
    ref.run()
    for h in ref.history:
        assert abs(h["loss"] - want[h["step"]]) < 1e-4


def test_preemption_checkpoint(tmp_path):
    loop = _port_loop(tmp_path, steps=500, ckpt_every=1000)

    def preempt():
        time.sleep(1.0)
        loop._preempted = True

    t = threading.Thread(target=preempt)
    t.start()
    end = loop.run()
    t.join()
    assert 0 < end < 500
    assert TCK.latest_step(tmp_path) == end
    info = json.loads((tmp_path / f"step_{end}" / "meta.json").read_text())
    assert info["meta"] == {"preempted": True}


def test_straggler_monitor_flags_slow_host():
    mon = StragglerMonitor(8, factor=2.0)
    for _ in range(20):
        times = np.full(8, 0.1)
        times[3] = 0.5
        flagged = mon.update(times)
    assert flagged == {3}


def test_async_checkpointer_keeps_the_newest(tmp_path):
    ck = TCK.AsyncCheckpointer(tmp_path, keep=2)
    for s in (1, 2, 3):
        ck.save_async(s, {"x": torch.full((64,), float(s))})
    ck.wait()
    assert TCK.latest_step(tmp_path) == 3
    assert sorted(int(p.name.split("_")[1])
                  for p in tmp_path.glob("step_*")) == [2, 3]


def test_opt_state_converts_both_ways():
    rng = np.random.default_rng(6)
    jp = jax.tree.map(jnp.asarray, {"a": rng.standard_normal((2, 3)).astype(
        np.float32), "b": {"c": rng.standard_normal(4).astype(np.float32)}})
    js = j_adamw_init(jp)
    js = JState(jax.tree.map(lambda x: x + 1.5, js.mu),
                jax.tree.map(lambda x: x + 0.25, js.nu), js.count + 9)
    ts = convert.opt_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert int(ts.count) == 9 and ts.count.dtype == torch.int32
    mu, nu, count = convert.opt_to_numpy(ts)
    back = JState(mu, nu, count)
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_restore_refuses_a_missing_leaf(tmp_path):
    TCK.save(tmp_path, 1, {"x": torch.zeros(2)})
    with pytest.raises(KeyError):
        TCK.restore(tmp_path, 1, {"x": torch.zeros(2), "y": torch.zeros(1)})
