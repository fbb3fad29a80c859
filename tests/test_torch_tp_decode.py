"""The dense ``decode_step`` over placed weights (``decode_step_tp``)
against the JAX reference on the CPU.

yi-6b, zamba2-2.7b and granite-moe-1b-a400m SMOKE, 4 slots of a dense
cache of 16 positions filled from a seeded generator, weights placed by
``SERVE_PARAM_RULES`` and the cache by ``place_cache`` (slots over 'data',
kv heads over 'model' as ``wk``'s, the SSM states as the serving engine
places them) over (2, 2) and (1, 4), 3 rounds: the logits within 1e-5 of
the largest against the reference's ``decode_step`` jitted with the same
shardings over an Auto mesh (``tests/_torch_tp.py ... decode``) and against
the port's mesh-free ``decode_step``; the joined caches equal the
mesh-free step's within 1e-5 (the new tokens' K/V and SSM states written
in place at every coordinate). The placed step reaches no kernel, and a
whole (unplaced) cache is refused.
"""
import math

import numpy as np
import pytest
import torch

import _torch_mesh as M
import _torch_tp as T
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.kernels import _build
from repro_torch.launch import mesh as TM
from repro_torch.models import transformer as TTF
from repro_torch.models.params import param_axes
from repro_torch.parallel import collectives as CO
from repro_torch.parallel import sharding as SH


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return T.run_reference(str(tmp_path_factory.mktemp("tpd") / "r.npz"),
                           part="decode")


def cpu_mesh(shape):
    with TM.force_device_count(math.prod(shape)):
        return TM.make_mesh(shape, ("data", "model"), device="cpu")


def close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    assert err <= bound, f"{what}: {err} > {bound}"


def _case(ref, arch):
    cfg = TC.get_smoke(arch)
    params = convert.params_from_numpy(
        cfg, M.unflatten(ref, f"weights/{arch}"), "cpu")
    c = T.decode_case(arch, cfg)
    cache = TTF.init_cache(cfg, T.SLOTS, T.DECODE_LEN, "cpu")
    for name in cache:
        if name == "ssm":
            for k, a in cache["ssm"].items():
                a.copy_(torch.from_numpy(ref[f"decode/{arch}/cache/ssm/{k}"]))
        else:
            cache[name].copy_(torch.from_numpy(c[f"cache/{name}"]))
    return cfg, params, c, cache


def _copy(cache):
    return {k: ({n: a.clone() for n, a in v.items()} if k == "ssm"
                else v.clone()) for k, v in cache.items()}


def _run(params, cfg, c, cache, log=None):
    lens = torch.from_numpy(c["lengths"]).clone()
    out = []
    for r in range(T.ROUNDS):
        lg, cache = TTF.decode_step(params, cfg,
                                    torch.from_numpy(c["tokens"][r]), cache,
                                    lens)
        out.append(lg[:, :cfg.vocab].clone())
        lens = lens + 1
    return torch.stack(out), cache


@pytest.mark.parametrize("mname", list(T.MESHES))
@pytest.mark.parametrize("arch", T.SERVE_ARCHS)
def test_placed_decode_matches_the_reference_and_the_mesh_free_step(
        ref, arch, mname):
    cfg, params, c, cache = _case(ref, arch)
    mesh = cpu_mesh(T.MESHES[mname])
    pl = SH.place_params(params, param_axes(cfg), SH.SERVE_PARAM_RULES, mesh)
    placed = TTF.place_cache(cfg, _copy(cache), pl)
    _build.reset_launches()
    with CO.recording() as log:
        got, placed = _run(pl, cfg, c, placed)
    assert sum(_build.launches.values()) == 0   # no kernel, as mesh-free
    want_ref = ref[f"decode/{arch}/{mname}/logits"][..., :cfg.vocab]
    close(got, want_ref, 1e-5, f"{arch} {mname} logits vs the reference")
    free, fcache = _run(params, cfg, c, _copy(cache))
    close(got, free, 1e-5, f"{arch} {mname} logits vs mesh-free")
    joined = TTF.join_cache(placed, "cpu")
    for name, t in fcache.items():
        if name == "ssm":
            for k, a in t.items():
                close(joined["ssm"][k], a, 1e-5, f"{arch} ssm {k}")
        else:
            close(joined[name], t, 1e-5, f"{arch} cache {name}")
            close(joined[name], ref[f"decode/{arch}/{mname}/cache/{name}"],
                  1e-5, f"{arch} cache {name} vs the reference")
    kinds = {r.kind for r in log}
    if T.MESHES[mname][1] > 1:
        assert "all-reduce" in kinds   # wo / w_down rows summed


def test_placed_cache_layout_and_refusal(ref):
    """The cache's slots go over 'data' and its kv heads over 'model' where
    they divide (as ``wk``'s heads); a whole cache with placed weights is
    refused."""
    cfg, params, c, cache = _case(ref, "yi-6b")
    pl = SH.place_params(params, param_axes(cfg), SH.SERVE_PARAM_RULES,
                         cpu_mesh((2, 2)))
    specs = TTF.cache_specs(cfg, cache, pl)
    heads = "model" if cfg.n_kv_heads % 2 == 0 else None
    assert specs["k"] == (None, "data", None, heads, None)
    with pytest.raises(TypeError, match="place_cache"):
        TTF.decode_step(pl, cfg, torch.zeros(T.SLOTS, dtype=torch.int32),
                        cache, torch.zeros(T.SLOTS, dtype=torch.int32))
