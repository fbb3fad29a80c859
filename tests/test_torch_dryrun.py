"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
reference's on the CPU, at SMOKE size.

The reference's ``run_cell`` runs in child processes, one an arch
(``tests/_torch_dryrun.py``), over an Auto (2, 4) mesh of eight host
devices; the port's walks the same cells over ``make_debug_mesh(2, 4)``
on the ``meta`` device. yi-6b, zamba2-2.7b and granite-moe SMOKE; train,
prefill and decode at seq 64, batch 8 (the shapes' names kept):

* each record's status, keys (``fits_hbm`` / ``hbm_bytes`` for the
  reference's ``fits_16g_hbm``), ``model_flops_total`` and microbatches
  equal the reference's, and its argument bytes a device equal the
  reference's ``argument_size_in_bytes`` exactly (a decode cell's less the
  arenas' scratch rows, which the reference's arenas lack); the port's
  FLOPs and collective bytes a device are printed beside the reference's
  HLO figures (not compared: XLA counts elementwise work and combines
  collectives its own way);
* a full-attention arch on ``long_500k`` is skipped with the reference's
  reason and keys;
* the cost walk's ``microbatches`` / ``cost_scale`` under ``REPRO_MB=2``
  equal the reference's.

tests/test_torch_dryrun_walk.py checks the walks themselves.
"""
import pytest

import _torch_dryrun as D
from repro_torch import configs as TC
from repro_torch.configs import shapes as SH
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as TM

CELLS = [(a, k) for a in D.ARCHS for k in D.KINDS]


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    return D.start_reference(str(tmp_path_factory.mktemp("dr") / "r.json"))


@pytest.fixture(scope="module")
def ref(child, port):
    """The reference's records (the child runs while the port walks)."""
    return D.load_reference(child)


@pytest.fixture(scope="module")
def small():
    """The port's shapes and configs as the child sets the reference's."""
    saved = dict(SH.SHAPES), TC.get_config
    for name, (s, b) in D.SHAPES.items():
        SH.SHAPES[name] = SH.ShapeSpec(name, s, b, SH.SHAPES[name].kind)
    TC.get_config = TC.get_smoke
    yield TM.make_debug_mesh(*D.MESH, device="meta")
    SH.SHAPES.clear()
    SH.SHAPES.update(saved[0])
    TC.get_config = saved[1]


@pytest.fixture(scope="module")
def port(child, small, tmp_path_factory):
    out = tmp_path_factory.mktemp("drp")
    recs = {f"{a}/{k}": DR.run_cell(a, k, multi_pod=False, out_dir=out,
                                    unroll=False, mesh=small)
            for a, k in CELLS}
    recs["yi-6b/long_500k"] = DR.run_cell("yi-6b", "long_500k",
                                          multi_pod=False, out_dir=out,
                                          unroll=False, mesh=small)
    return recs


def _keys(rec, fits):
    return set(rec) - {fits, "hbm_bytes", "time"}


@pytest.mark.parametrize("arch,kind", CELLS)
def test_record_matches_the_reference(ref, port, small, arch, kind):
    want, got = ref[f"{arch}/{kind}"], port[f"{arch}/{kind}"]
    assert got["status"] == want["status"] == "ok", got.get("error")
    assert _keys(got, "fits_hbm") == _keys(want, "fits_16g_hbm")
    assert got["model_flops_total"] == want["model_flops_total"]
    assert got.get("microbatches") == want.get("microbatches")
    args = got["argument_size_in_bytes"]
    if kind == "decode_32k":
        cfg = TC.get_smoke(arch)
        walked, _ = DR.lower_decode(cfg, SH.SHAPES[kind], small)
        assert walked.cost["argument_bytes"] == args
        args -= walked.scratch_bytes
    assert args == want["argument_size_in_bytes"]
    assert got["fits_hbm"] and got["hbm_bytes"] == 80e9
    print(f"{arch} {kind}: FLOPs a device {got['hlo_flops_per_device']:.4g}"
          f" (reference HLO {want['hlo_flops_per_device']:.4g}), "
          f"collective bytes {got['collective_bytes_per_device']['total']}"
          f" (reference HLO {want['collective_bytes_per_device']['total']})")


def test_long_500k_skips_a_full_attention_arch(ref, port):
    want, got = ref["yi-6b/long_500k"], port["yi-6b/long_500k"]
    assert got["status"] == want["status"] == "skip"
    assert got["skip_reason"] == want["skip_reason"]
    assert set(got) - {"time"} == set(want) - {"time"}


def test_cost_walk_extra_matches_the_reference(ref, small, monkeypatch):
    """Under ``REPRO_MB=2`` the cost walk takes half the global batch
    (``cost_scale`` 2), as the reference's cost graph does; the cells'
    own microbatch choice is in their records."""
    monkeypatch.setenv("REPRO_MB", "2")
    cfg = TC.get_smoke("yi-6b")
    _, extra = DR.lower_train(cfg, SH.SHAPES["train_4k"], small, True)
    assert extra == ref["extra/mb2"] == {"microbatches": 2,
                                         "cost_scale": 2.0}
