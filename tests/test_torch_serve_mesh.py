"""The port's serving mesh against the JAX reference's mesh code on the CPU.

* ``plan_geometry`` over a grid of batch / kv-head / q-head counts and
  mesh shapes (the reference's side over a ``jax.sharding.AbstractMesh``,
  which needs no devices): every axis group, ``stripe_total``,
  ``nblk_local`` and spec equal; ``build_blk_start`` equal; the
  reference's ``nblk % stripe_total`` assert raised by both.
* ``serve_state_specs`` / ``serve_input_specs`` with a mesh: shapes and
  specs equal the reference's; ``lower_serve_step`` over the production
  mesh (a ``meta`` plan) reports the reference's geometry and refuses to
  run.
* The paged island in the three layouts (slots over 'data' and heads over
  'model'; 4 stripes over 'model'; one slot striped over 'data', heads
  over 'model') and five variants (fp32, bf16, the int8 arena, a window,
  a softcap), every case with a slot whose pages lie on one stripe (the
  others see nothing) and, with four slots, one without a request:
  each coordinate's q / k / v cut by ``scatter_heads`` and the output
  joined by ``gather_heads``: the output within 1e-5 of the largest
  (fp32; bf16 2e-2) and the joined
  arena (and int8 scales) equal to the reference's; each also within
  1e-5 of the port's mesh-free island on the same global pool.
* The whole serve step of yi-6b (4 slots, and 1 slot striped) and
  zamba2-2.7b (4 slots) SMOKE over ``make_debug_mesh(2, 2)``, the weights
  placed by ``SERVE_PARAM_RULES``: 3 rounds,
  logits within 1e-5 of the largest against the reference's mesh step and
  against the port's mesh-free step, greedy tokens equal, the joined
  arenas equal the reference's within 1e-5.

The reference's side runs in one child process with four forced host
devices (``tests/_torch_mesh.py``); the port's meshes repeat the CPU
under ``force_device_count(4)``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import _torch_mesh as M
from repro import configs as JC
from repro.configs.shapes import ShapeSpec
from repro.serving import engine as JE
from repro.serving import paged as JP
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.launch import mesh as TM
from repro_torch.models.params import param_axes
from repro_torch.parallel import sharding as SH
from repro_torch.serving import engine as TE
from repro_torch.serving import paged as TP

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # of the largest output


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return M.run_reference(str(tmp_path_factory.mktemp("mesh") / "r.npz"))


def port_mesh(shape, axes=("data", "model")):
    with TM.force_device_count(int(np.prod(shape))):
        return TM.make_mesh(shape, axes, device="cpu")


def close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    assert err <= bound, f"{what}: {err} > {bound}"


# ------------------------------------------------------------ geometry
GRID = [(b, kh, h, shape) for b in (1, 2, 4, 6) for kh, h in
        ((4, 8), (2, 4), (8, 8), (1, 7), (4, 36))
        for shape in ((2, 2), (1, 4), (4, 1), (2, 2, 2), (1, 8))]


def _meshes(shape):
    axes = (("pod", "data", "model") if len(shape) == 3
            else ("data", "model"))
    return AbstractMesh(shape, axes), TM.make_mesh(shape, axes,
                                                   device="meta")


@pytest.mark.parametrize("seq_len", [64, 96])
def test_plan_geometry_matches_reference(seq_len):
    checked = 0
    for b, kh, h, shape in GRID:
        jm, tm = _meshes(shape)
        kw = dict(batch=b, seq_len=seq_len, kv_heads=kh, head_dim=16,
                  q_heads=h, block=8)
        try:
            jg = JP.plan_geometry(mesh=jm, **kw)
        except AssertionError:   # nblk does not split over the stripes
            with pytest.raises(AssertionError):
                TP.plan_geometry(mesh=tm, **kw)
            continue
        tg = TP.plan_geometry(mesh=tm, **kw)
        for name in ("block", "nblk", "batch", "batch_axes", "head_axes",
                     "stripe_axes", "stripe_total", "batch_local",
                     "nblk_local", "cap", "kv_heads_local", "manual_axes"):
            assert getattr(tg, name) == getattr(jg, name), (name, kw, shape)
        assert tg.mesh_shape == dict(jg.mesh_shape)
        for spec in ("arena_spec", "arena_slice_spec", "pt_spec", "vec_spec",
                     "wrows_spec", "q_spec"):
            assert getattr(tg, spec)() == tuple(getattr(jg, spec)()), spec
        np.testing.assert_array_equal(TP.build_blk_start(tg),
                                      JP.build_blk_start(jg))
        for pb in range(tg.nblk):
            assert TP.stripe_of_block(tg, pb) == JP.stripe_of_block(jg, pb)
            assert (TP.local_index_of_block(tg, pb)
                    == JP.local_index_of_block(jg, pb))
        checked += 1
    assert checked > len(GRID) // 2


@pytest.mark.parametrize("arch", ["yi-6b", "zamba2-2.7b", "gemma2-2b",
                                  "seamless-m4t-large-v2"])
@pytest.mark.parametrize("shape,batch", [((2, 2), 4), ((1, 4), 4),
                                         ((2, 2), 1), ((2, 2, 2), 8)])
def test_serve_specs_match_reference(arch, shape, batch):
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jm, tm = _meshes(shape)
    kw = dict(batch=batch, seq_len=64, kv_heads=jcfg.n_kv_heads,
              head_dim=jcfg.head_dim, q_heads=jcfg.n_heads, block=8)
    jg = JP.plan_geometry(mesh=jm, **kw)
    tg = TP.plan_geometry(mesh=tm, **kw)
    enc = jcfg.frontend_len if jcfg.is_encdec else 0
    jsds, jspec = JE.serve_state_specs(jcfg, jg, jm, enc_len=enc)
    got = TE.serve_state_specs(tcfg, tg, tm, enc_len=enc)
    assert set(got) == set(jsds)
    for name, sds in jsds.items():
        if name == "ssm":
            for k, leaf in sds.items():
                shape_, _, spec = got[name][k]
                assert shape_ == leaf.shape, (name, k)
                assert spec == tuple(jspec[name][k].spec), (name, k)
            continue
        shape_, _, spec = got[name]
        assert shape_ == sds.shape, name
        assert spec == tuple(jspec[name].spec), name
    jsds, jspec = JE.serve_input_specs(jcfg, jg, jm)
    got = TE.serve_input_specs(tcfg, tg, tm)
    assert set(got) == set(jsds)
    for name, sds in jsds.items():
        assert got[name][0] == sds.shape, name
        assert got[name][2] == tuple(jspec[name].spec), name


@pytest.mark.parametrize("multi_pod", [False, True])
def test_lower_serve_step_on_the_production_plan(multi_pod):
    """The production mesh is a meta plan: the reference's geometry and
    specs, no storage, and a step over it raises."""
    cfg = TC.get_config("yi-6b")
    shape = ShapeSpec("decode", 4096, 256 if multi_pod else 16, "decode")
    mesh = TM.make_production_mesh(multi_pod=multi_pod)
    assert mesh.shape == ({"pod": 2, "data": 16, "model": 16} if multi_pod
                          else {"data": 16, "model": 16})
    step, extra = TE.lower_serve_step(cfg, shape, None, mesh=mesh)
    jm = AbstractMesh(tuple(mesh.shape.values()), mesh.axis_names)
    jg = JP.plan_geometry(batch=shape.global_batch, seq_len=shape.seq_len,
                          kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                          q_heads=cfg.n_heads, mesh=jm)
    assert extra["paged_geom"] == {
        "block": jg.block, "nblk": jg.nblk, "cap": jg.cap,
        "batch_axes": jg.batch_axes, "head_axes": jg.head_axes,
        "stripe_axes": jg.stripe_axes}
    assert step.state is None
    assert step.input_specs["pt"][0] == (shape.global_batch,
                                         jg.stripe_total, jg.nblk_local)
    with pytest.raises(RuntimeError, match="plan"):
        step(np.zeros((3, shape.global_batch), np.int32))
    with pytest.raises(RuntimeError, match="plan"):
        TP.make_paged_island(TP.plan_geometry(
            batch=shape.global_batch, seq_len=4096, kv_heads=4,
            head_dim=128, q_heads=32,
            mesh=mesh), mesh, scale=1.0)


def test_debug_mesh_needs_visible_devices():
    with pytest.raises(RuntimeError, match="force_device_count"):
        TM.make_debug_mesh(2, 2, device="cpu")
    with TM.force_device_count(8):
        mesh = TM.make_debug_mesh(2, 2, pods=2, device="cpu")
    assert mesh.axis_names == ("pod", "data", "model")
    assert mesh.size == 8 and mesh.home == torch.device("cpu")


# --------------------------------------------------------------- island
def _global_pool(geom, c, arena):
    """The mesh-free island's inputs for the same pool: the global arena
    with its scratch row, global page table and write rows."""
    t = torch.from_numpy
    pt = TP.global_page_table(geom, t(c["pt"]))[:, None]
    wr = TP.global_write_rows(geom, t(c["wr"]))
    full = torch.cat([arena, torch.zeros_like(arena[:1])])
    return full, pt, wr


@pytest.mark.parametrize("variant", list(M.VARIANTS))
@pytest.mark.parametrize("layout", list(M.LAYOUTS))
def test_island_matches_reference_mesh(ref, layout, variant):
    mshape, b, kh, h, n_b, st = M.LAYOUTS[layout]
    dt, window, softcap, quant = M.VARIANTS[variant]
    mesh = port_mesh(mshape)
    geom = TP.plan_geometry(batch=b, seq_len=M.NBLK * M.BLOCK, kv_heads=kh,
                            head_dim=M.HD, q_heads=h, mesh=mesh,
                            block=M.BLOCK)
    assert (geom.batch_shards, geom.stripe_total) == (n_b, st)
    c = M.island_case(layout, variant)
    tdt = TDT[dt]
    t = torch.from_numpy
    arena = t(c["arena"]) if quant else t(c["arena"]).to(tdt)
    shards = TP.split_arena(arena[None], geom, mesh)
    q, kn, vn = (t(c[k]).to(tdt) for k in ("q", "kn", "vn"))
    page_in = [t(c[k]) for k in ("pt", "bs", "lengths", "wr", "off")]
    kw = dict(scale=M.HD ** -0.5, softcap=softcap, window=window,
              quant=quant)
    extra = ()
    if quant:
        scales = TP.split_arena(t(c["scales"])[None], geom, mesh)
        extra = (scales.layer(0),)
    out = TP.gather_heads(geom, mesh, TP.make_paged_island(geom, mesh, **kw)(
        *TP.scatter_heads(geom, mesh, q, kn, vn), shards.layer(0), *page_in,
        *extra)[0])
    key = f"island/{layout}/{variant}"
    # a slot without a request gives 0 (the reference's masked softmax
    # leaves a mean of masked rows there, which no caller reads)
    live = (c["wr"] >= 0).any(axis=1)
    close(out.float()[live], ref[key + "/out"][live], TOL[dt], key)
    assert torch.count_nonzero(out[~live]) == 0
    joined = TP.join_arena(shards, geom, mesh)[0]
    np.testing.assert_array_equal(joined.float().numpy(),
                                  ref[key + "/arena"].astype(np.float32))
    if quant:   # XLA's and torch's fp32 division of amax by 127 may
        # round one ulp apart (the int8 values are equal)
        np.testing.assert_allclose(
            TP.join_arena(scales, geom, mesh)[0].numpy(),
            ref[key + "/scales"], rtol=1e-6, atol=0)
    # the port's mesh-free island on the same global pool (whose page
    # table splits back into the mesh's)
    full, pt, wr = _global_pool(geom, c, arena)
    assert torch.equal(TP.mesh_page_table(geom, pt[:, 0]), page_in[0])
    free = TP.plan_geometry(batch=b, seq_len=M.NBLK * M.BLOCK, kv_heads=kh,
                            head_dim=M.HD, q_heads=h, block=M.BLOCK)
    args = (q, kn, vn, full, pt, torch.from_numpy(
        TP.build_blk_start(free)), page_in[2], wr, page_in[4])
    if quant:
        sc = t(c["scales"])
        args += (torch.cat([sc, torch.zeros_like(sc[:1])]),)
    base = TP.make_paged_island(free, None, **kw)(*args)[0]
    close(out.float(), base.float(), TOL[dt], key + " (mesh-free)")
    np.testing.assert_array_equal(full[:-1].float().numpy(),
                                  joined.float().numpy())


def test_island_without_stripes_launches_like_the_mesh_free_island():
    """Case A (no stripes) passes no block starts and asks no lse: each
    coordinate's call is the mesh-free call form."""
    calls = []
    real = TP.paged_attention

    def spy(*a, **kw):
        calls.append((kw.get("blk_start") is None, kw.get("return_lse")))
        return real(*a, **kw)
    for layout, want in (("heads", (True, False)), ("stripes", (False, True))):
        mshape, b, kh, h, _, _ = M.LAYOUTS[layout]
        mesh = port_mesh(mshape)
        geom = TP.plan_geometry(batch=b, seq_len=M.NBLK * M.BLOCK,
                                kv_heads=kh, head_dim=M.HD, q_heads=h,
                                mesh=mesh, block=M.BLOCK)
        c = M.island_case(layout, "fp32")
        t = torch.from_numpy
        shards = TP.split_arena(t(c["arena"])[None], geom, mesh)
        calls.clear()
        TP.paged_attention = spy
        try:
            TP.make_paged_island(geom, mesh, scale=0.25)(
                *TP.scatter_heads(geom, mesh, *(t(c[k]) for k in (
                    "q", "kn", "vn"))), shards.layer(0),
                *(t(c[k]) for k in ("pt", "bs", "lengths", "wr", "off")))
        finally:
            TP.paged_attention = real
        assert calls == [want] * mesh.size, layout


# ----------------------------------------------------------- serve step
def _weights(ref, arch):
    """The child's SMOKE weights (``_torch_mesh.ref_weights``), carried
    across."""
    tcfg = TC.get_smoke(arch)
    return tcfg, convert.params_from_numpy(
        tcfg, M.unflatten(ref, f"weights/{arch}"), "cpu")


@pytest.mark.parametrize("arch,b", M.STEP_ARCHS)
def test_serve_step_matches_reference_mesh(ref, arch, b):
    tcfg, tp = _weights(ref, arch)
    mesh = port_mesh((2, 2))
    geo = dict(batch=b, seq_len=M.STEP_NBLK * M.STEP_BLOCK,
               kv_heads=tcfg.n_kv_heads, head_dim=tcfg.head_dim,
               q_heads=tcfg.n_heads, block=M.STEP_BLOCK)
    geom = TP.plan_geometry(mesh=mesh, **geo)
    free = TP.plan_geometry(**geo)
    n_shared = (tcfg.n_shared_applications() if tcfg.shared_attn_every
                else 0)
    from repro_torch.models import transformer as TTF
    c = M.step_case(arch, b, tcfg.n_kv_heads, tcfg.head_dim,
                    geom.batch_shards, geom.stripe_total,
                    TTF.n_attn_layers(tcfg), n_shared, tcfg.vocab)
    glob = TE.init_serve_state(tcfg, free, free.cap, "cpu")
    arenas = [n for n in ("arena", "shared_arena") if n in glob]
    for name in arenas:
        glob[name][:, :free.cap] = torch.from_numpy(c[name])
    placed = TE.place_state(glob, geom, mesh)
    weights = SH.place_params(tp, param_axes(tcfg), SH.SERVE_PARAM_RULES,
                              mesh)
    mesh_step = TE.make_serve_step(tcfg, geom, mesh)
    free_step = TE.make_serve_step(tcfg, free)
    key = f"step/{arch}/{b}"
    pt = torch.from_numpy(c["pt"])
    active = torch.from_numpy(c["active"])
    lens = torch.from_numpy(c["lengths0"])
    tokens = torch.from_numpy(c["tokens0"])
    for r in range(M.STEP_ROUNDS):
        wr = TP.mesh_write_rows(geom, pt, lens, active)
        np.testing.assert_array_equal(
            wr.numpy(), M.write_rows(c["pt"], lens.numpy(), c["active"],
                                     M.STEP_BLOCK))
        inputs = {"tokens": tokens, "lengths": lens,
                  "write_off": lens % M.STEP_BLOCK, "pt": pt,
                  "blk_start": torch.from_numpy(c["bs"]), "write_rows": wr}
        nxt, _, logits = mesh_step(weights, placed, inputs)
        free_in = dict(inputs, pt=TP.global_page_table(geom, pt)[:, None],
                       blk_start=torch.from_numpy(TP.build_blk_start(free)),
                       write_rows=TP.global_write_rows(geom, wr))
        _, _, base = free_step(tp, glob, free_in)
        lg = logits[:, :tcfg.vocab]
        live = c["active"]   # a slot without a request: see the island
        close(lg[live], ref[key + "/logits"][r][live, :tcfg.vocab], 1e-5,
              f"{key} round {r}")
        close(lg, base[:, :tcfg.vocab], 1e-5, f"{key} round {r} mesh-free")
        np.testing.assert_array_equal(nxt.numpy()[live],
                                      ref[key + "/next"][r][live])
        tokens = torch.from_numpy(np.where(
            live, ref[key + "/next"][r], 0).astype(np.int32))
        lens = lens + active.to(torch.int32)
    joined = TE.join_state(placed, geom, mesh)
    for name in arenas:
        close(joined[name], ref[f"{key}/{name}"], 1e-5, f"{key} {name}")
        close(joined[name], glob[name][:, :free.cap], 1e-5,
              f"{key} {name} mesh-free")


def test_mesh_serve_step_runs_lowered_on_a_debug_mesh(ref):
    """``lower_serve_step`` over a debug mesh: a placed zero state on the
    CPU entries, the reference's input shapes, and a round over idle
    slots (every write to the scratch rows)."""
    tcfg, tp = _weights(ref, "yi-6b")
    shape = ShapeSpec("decode_small", 64, 4, "decode")
    with TM.force_device_count(4):
        mesh = TM.make_debug_mesh(1, 4, device="cpu")
    step, extra = TE.lower_serve_step(tcfg, dataclasses.replace(shape),
                                      tp, mesh=mesh)
    assert extra["paged_geom"]["head_axes"] == ("model",)
    assert isinstance(step.state["arena"], TP.Shards)
    assert len(step.state["arena"]) == 4
    nxt, logits = step(np.zeros((3, 4), np.int32))
    assert nxt.shape == (4,) and bool(torch.isfinite(logits).all())
