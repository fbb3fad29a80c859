"""The port's steps over placed weights against the JAX reference's placed
steps on the CPU.

* The serve step of yi-6b, zamba2-2.7b and granite-moe-1b-a400m SMOKE (4
  slots, pools in the mesh layout of ``_torch_mesh.step_case``) with
  weights placed by ``SERVE_PARAM_RULES`` over (2, 2) and (1, 4): 3
  rounds, the logits within 1e-5 of the largest against the reference's
  placed step (jitted with ``in_shardings``) and against the port's
  mesh-free step, the joined arenas and SSM states equal to the mesh-free
  step's within 1e-5; a repeated run is bit-equal.
* The other seven archs (the encoder-decoder and the vision frontend
  among them) over (1, 4): the port's placed step against its mesh-free
  step from the same weights, pools, SSM states and encoder K/V.
* A placed prefill (yi-6b, zamba2-2.7b over (2, 2)): logits within 1e-5 of
  the reference's prefill and the port's mesh-free one.
* The train step of gemma2-2b and zamba2-2.7b SMOKE at step 1 with weights
  and moments placed by ``TRAIN_PARAM_RULES`` over (2, 2) (remat full):
  the loss within 1e-5 and the grad norm within 1e-5 of the reference's
  placed step, every updated leaf within 1e-4 of its largest entry against
  the reference's and the port's mesh-free step, every gradient leaf
  within 1e-4 of its largest against the mesh-free one; a repeated step
  is bit-equal.
* The collective log of a yi-6b SMOKE serve round against a count derived
  here from the config (the reference's GSPMD bytes of the same step are
  printed beside it, not compared: a compiler places its collectives its
  own way).
* ``compress_psum_pod`` against the reference's under ``jax.vmap(
  axis_name="pod")``, with error feedback over 3 steps, and
  ``make_compressed_grad_fn`` over (pod 2, data 1, model 2) against the
  compression of each pod's mesh-free gradients.
* The placed step's tied-embedding gradient in bf16 against the fp32
  step's (its lookup's scatter-add sums in fp32).

The reference's placed steps run in one child process with four forced
host devices (``tests/_torch_tp.py``).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import _torch_mesh as M
import _torch_tp as T
from repro import configs as JC
from repro.models import transformer as JTF
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.launch import mesh as TM
from repro_torch.models import transformer as TTF
from repro_torch.models.params import param_axes
from repro_torch.optim.adamw import adamw_init, tree_leaves
from repro_torch.parallel import collectives as CO
from repro_torch.parallel import compression as TCOMP
from repro_torch.parallel import sharding as SH
from repro_torch.roofline.analysis import collective_bytes
from repro_torch.serving import engine as TE
from repro_torch.serving import paged as TP
from repro_torch.training.step import make_loss_grad_fn, make_train_step

OTHERS = tuple(a for a in TC.all_archs() if a not in T.SERVE_ARCHS)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return T.run_reference(str(tmp_path_factory.mktemp("tp") / "r.npz"))


def cpu_mesh(shape, axes=("data", "model")):
    with TM.force_device_count(math.prod(shape)):
        return TM.make_mesh(shape, axes, device="cpu")


def close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    bound = tol * max(float(np.abs(want).max()), 1e-30)
    assert err <= bound, f"{what}: {err} > {bound}"


def ref_params(ref, arch):
    cfg = TC.get_smoke(arch)
    return cfg, convert.params_from_numpy(
        cfg, M.unflatten(ref, f"weights/{arch}"), "cpu")


def own_params(arch):
    """Port-drawn SMOKE weights (SSM leaves nonzero, as the reference
    child makes them)."""
    cfg = TC.get_smoke(arch)
    p = TTF.init_model(torch.Generator().manual_seed(9), cfg, "cpu")
    if "layers" in p and "mamba" in p["layers"]:
        g = torch.Generator().manual_seed(10)
        for n in ("A_log", "D", "dt_bias"):
            t = p["layers"]["mamba"][n]
            t.copy_(torch.randn(t.shape, generator=g) * 0.5)
    return cfg, p


# ------------------------------------------------------------ serve step
class ServePair:
    """The placed step and the mesh-free step over the same weights,
    pools and states."""

    def __init__(self, cfg, params, mesh, *, seed=None):
        self.cfg, self.mesh = cfg, mesh
        geo = dict(batch=T.SLOTS, seq_len=M.STEP_NBLK * M.STEP_BLOCK,
                   kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                   q_heads=cfg.n_heads, block=M.STEP_BLOCK)
        self.geom = TP.plan_geometry(mesh=mesh, **geo)
        self.free = TP.plan_geometry(**geo)
        self.case = T.serve_case(_arch_of(cfg), cfg, self.geom)
        glob = TE.init_serve_state(cfg, self.free, self.free.cap, "cpu")
        for name in ("arena", "shared_arena"):
            if name in glob:
                glob[name][:, :self.free.cap] = torch.from_numpy(
                    self.case[name])
        if seed is not None:   # random SSM states and encoder K/V (the
            # reference's cases start them at zero)
            g = torch.Generator().manual_seed(seed)
            for name, t in glob.get("ssm", {}).items():
                t.copy_(torch.randn(t.shape, generator=g).to(t.dtype) * 0.3)
            for name in ("enc_k", "enc_v"):
                if name in glob:
                    glob[name].copy_(torch.randn(glob[name].shape,
                                                 generator=g))
        self.glob = glob
        self.placed = TE.place_state(glob, self.geom, mesh)
        self.params = params
        self.pl = SH.place_params(params, param_axes(cfg),
                                  SH.SERVE_PARAM_RULES, mesh)
        self.step = TE.make_serve_step(cfg, self.geom, mesh)
        self.free_step = TE.make_serve_step(cfg, self.free)

    def inputs(self, tokens, lens):
        c, geom = self.case, self.geom
        pt = torch.from_numpy(c["pt"])
        active = torch.from_numpy(c["active"])
        wr = TP.mesh_write_rows(geom, pt, lens, active)
        inp = {"tokens": tokens, "lengths": lens,
               "write_off": lens % M.STEP_BLOCK, "pt": pt,
               "blk_start": torch.from_numpy(c["bs"]), "write_rows": wr}
        if self.cfg.is_encdec:
            inp["enc_valid"] = torch.full((T.SLOTS,), self.cfg.frontend_len,
                                          dtype=torch.int32)
        free = dict(inp, pt=TP.global_page_table(geom, pt)[:, None],
                    blk_start=torch.from_numpy(TP.build_blk_start(self.free)),
                    write_rows=TP.global_write_rows(geom, wr))
        return inp, free

    def rounds(self, n, tokens_of=None):
        c = self.case
        active = torch.from_numpy(c["active"])
        lens = torch.from_numpy(c["lengths0"])
        tokens = torch.from_numpy(c["tokens0"])
        out = []
        for r in range(n):
            inp, free = self.inputs(tokens, lens)
            with CO.recording() as log:
                nxt, _, lg = self.step(self.pl, self.placed, inp)
            _, _, base = self.free_step(self.params, self.glob, free)
            out.append((lg, base, log))
            want = nxt if tokens_of is None else tokens_of(r)
            tokens = torch.where(active, want, 0).to(torch.int32)
            lens = lens + active.to(torch.int32)
        return out


def _arch_of(cfg):
    return {TC.get_smoke(a).name: a for a in TC.all_archs()}[cfg.name]


@pytest.mark.parametrize("mname", list(T.MESHES))
@pytest.mark.parametrize("arch", T.SERVE_ARCHS)
def test_placed_serve_step_matches_the_reference(ref, arch, mname):
    cfg, params = ref_params(ref, arch)
    pair = ServePair(cfg, params, cpu_mesh(T.MESHES[mname]))
    want = ref[f"serve/{arch}/{mname}/logits"]
    live = pair.case["active"]
    res = pair.rounds(T.ROUNDS, lambda r: torch.from_numpy(
        want[r].argmax(-1).astype(np.int32)))
    for r, (lg, base, _) in enumerate(res):
        v = cfg.vocab
        close(lg[live, :v], want[r][live, :v], 1e-5, f"{arch} {mname} r{r}")
        close(lg[:, :v], base[:, :v], 1e-5, f"{arch} {mname} r{r} free")
    joined = TE.join_state(pair.placed, pair.geom, pair.mesh)
    for name in ("arena", "shared_arena"):
        if name in joined:
            close(joined[name], pair.glob[name][:, :pair.free.cap], 1e-5,
                  name)
    for name, t in joined.get("ssm", {}).items():
        close(t, pair.glob["ssm"][name], 1e-5, name)
    # a repeated run from the same start is bit-equal
    again = ServePair(cfg, params, pair.mesh).rounds(T.ROUNDS, lambda r:
                                                     torch.from_numpy(
        want[r].argmax(-1).astype(np.int32)))
    for (a, _, _), (b, _, _) in zip(res, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", OTHERS)
def test_placed_serve_step_matches_the_mesh_free_step(arch):
    cfg, params = own_params(arch)
    pair = ServePair(cfg, params, cpu_mesh((1, 4)), seed=len(arch))
    for r, (lg, base, _) in enumerate(pair.rounds(2)):
        close(lg[:, :cfg.vocab], base[:, :cfg.vocab], 1e-5, f"{arch} r{r}")
    joined = TE.join_state(pair.placed, pair.geom, pair.mesh)
    for name, t in joined.get("ssm", {}).items():
        close(t, pair.glob["ssm"][name], 1e-5, name)


def test_a_serve_round_issues_the_collectives_the_config_implies(ref):
    """yi-6b SMOKE: per coordinate, the embedding's psum over 'model' and,
    a layer, wo's and w_down's psums ([b_local, 1, d] fp32 each), then the
    logits' all-gather ([b_local, padded_vocab] fp32); no gather of q / k
    / v (the kv heads divide 'model': the island's heads are the
    weights')."""
    cfg, params = ref_params(ref, "yi-6b")
    for mname, (nd, nm) in T.MESHES.items():
        pair = ServePair(cfg, params, cpu_mesh((nd, nm)))
        log = pair.rounds(1)[0][2]
        bl = T.SLOTS // nd
        row = bl * cfg.d_model * 4
        want = {"all-reduce": (1 + 2 * cfg.n_layers) * row,
                "all-gather": bl * cfg.padded_vocab * 4,
                "reduce-scatter": 0, "all-to-all": 0,
                "collective-permute": 0}
        want["total"] = want["all-reduce"] + want["all-gather"]
        assert collective_bytes(log) == want, mname
        assert [r.origin for r in log] == (
            ["embed.lookup"] + [f"layers.{i}.{w}" for i in
                                range(cfg.n_layers)
                                for w in ("attn.wo", "mlp.w_down")]
            + ["logits"])
        hlo = {k.rsplit("/", 1)[1]: int(ref[k]) for k in ref
               if k.startswith(f"serve/yi-6b/{mname}/hlo_bytes/")}
        print(f"yi-6b {mname}: port {collective_bytes(log)}, "
              f"reference GSPMD {hlo}")


# ---------------------------------------------------------------- prefill
@pytest.mark.parametrize("arch", ("yi-6b", "zamba2-2.7b"))
def test_placed_prefill_matches_the_reference(ref, arch):
    import jax.numpy as jnp
    cfg, params = ref_params(ref, arch)
    jp = _jax_tree(M.unflatten(ref, f"weights/{arch}"))
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (4, 24)
                                               ).astype(np.int32)
    jl, _ = JTF.prefill(jp, JC.get_smoke(arch), {"tokens": jnp.asarray(
        tokens)})
    mesh = cpu_mesh((2, 2))
    pl = SH.place_params(params, param_axes(cfg), SH.SERVE_PARAM_RULES, mesh)
    with torch.no_grad():
        lt, cache = TTF.prefill(pl, cfg, {"tokens": torch.from_numpy(tokens)})
        lf, cf = TTF.prefill(params, cfg, {"tokens": torch.from_numpy(
            tokens)})
    v = cfg.vocab
    close(lt[:, :v], np.asarray(jl)[:, :v], 1e-5, arch)
    close(lt[:, :v], lf[:, :v], 1e-5, f"{arch} mesh-free")
    for name, sh in cache.items():
        if isinstance(sh, CO.Shards):
            assert set(sh) == set(SH.coord_keys(mesh)), name


def _jax_tree(tree):
    import jax.numpy as jnp
    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


# ------------------------------------------------------------- train step
def _train_once(cfg, params, batch, mesh=None):
    """One step at T.TRAIN_STEP from fresh moments: (metrics, updated
    params whole on the CPU, gradients whole on the CPU)."""
    params = SH._tree_map(lambda t: t.clone(), params)
    grads = make_loss_grad_fn(cfg, remat="full")
    if mesh is not None:
        params = SH.place_params(params, param_axes(cfg),
                                 SH.TRAIN_PARAM_RULES, mesh)
    (_, _), g = grads(params, batch)
    step = make_train_step(cfg, remat="full")
    _, _, m = step(params, adamw_init(params), batch, T.TRAIN_STEP)
    if mesh is not None:
        params, g = SH.gather_params(params, "cpu"), SH.gather_params(
            g, "cpu")
    return m, params, g


@pytest.mark.parametrize("arch", T.TRAIN_ARCHS)
def test_placed_train_step_matches_the_reference(ref, arch):
    cfg, params = ref_params(ref, arch)
    batch = {k: torch.from_numpy(v) for k, v in
             T.train_batch(arch, cfg.vocab).items()}
    mesh = cpu_mesh((2, 2))
    m, new, grads = _train_once(cfg, params, batch, mesh)
    mf, newf, gradsf = _train_once(cfg, params, batch)
    assert abs(float(m["loss"]) - float(ref[f"train/{arch}/loss"])) <= 1e-5
    assert abs(float(m["grad_norm"]) - float(ref[f"train/{arch}/grad_norm"])
               ) <= 1e-5 * float(ref[f"train/{arch}/grad_norm"])
    want = M.unflatten(ref, f"train/{arch}/params")
    flat_want = convert.params_from_numpy(cfg, want, "cpu")
    for a, b, c in zip(tree_leaves(new), tree_leaves(flat_want),
                       tree_leaves(newf)):
        close(a, b, 1e-4, f"{arch} updated leaf")
        close(a, c, 1e-4, f"{arch} updated leaf, mesh-free")
    for a, b in zip(tree_leaves(grads), tree_leaves(gradsf)):
        close(a, b, 1e-4, f"{arch} gradient leaf")
    m2, new2, _ = _train_once(cfg, params, batch, mesh)
    assert float(m2["loss"]) == float(m["loss"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(new),
                                                 tree_leaves(new2)))


# ------------------------------------------------------------ compression
def test_compress_psum_pod_matches_the_reference(ref):
    mesh = cpu_mesh((T.COMP_PODS, 1, 1), ("pod", "data", "model"))
    keys = [(p, 0, 0) for p in range(T.COMP_PODS)]
    err = CO.Shards({k: torch.zeros(T.COMP_SHAPE) for k in keys})
    for i, g in enumerate(T.comp_grads()):
        gs = CO.Shards({k: torch.from_numpy(g[p]) for p, k in
                        enumerate(keys)})
        with CO.recording() as log:
            g_hat, err = TCOMP.compress_psum_pod(gs, err, mesh,
                                                 n_pods=T.COMP_PODS)
        for p, k in enumerate(keys):
            close(g_hat[k], ref[f"compress/{i}/g_hat"][p], 1e-6, f"g {i}")
            close(err[k], ref[f"compress/{i}/err"][p], 1e-6, f"err {i}")
        assert [(r.kind, r.nbytes) for r in log] == [
            ("all-reduce", 4), ("all-reduce", math.prod(T.COMP_SHAPE))]


def test_compressed_grad_fn_over_pods_and_a_placed_model():
    cfg, params = own_params("yi-6b")
    mesh = cpu_mesh((2, 1, 2), ("pod", "data", "model"))
    batch = {k: torch.from_numpy(v) for k, v in
             T.train_batch("yi-6b", cfg.vocab).items()}
    lg = make_loss_grad_fn(cfg)
    run = TCOMP.make_compressed_grad_fn(lg, mesh)
    pl = SH.place_params(params, param_axes(cfg), SH.TRAIN_PARAM_RULES, mesh)
    err = TCOMP.init_error_state(pl, mesh)
    loss, g_hat, err = run(pl, batch, err)
    # the same from each pod's mesh-free gradients
    half = T.TRAIN_B // 2
    per = [lg(params, {k: v[p * half:(p + 1) * half] for k, v in
                       batch.items()}) for p in range(2)]
    assert abs(float(loss) - sum(float(x[0][0]) for x in per) / 2) <= 1e-5
    whole = SH.gather_params(g_hat, "cpu")
    pods = cpu_mesh((2, 1, 1), ("pod", "data", "model"))
    for leaf, a, b in zip(tree_leaves(whole), tree_leaves(per[0][1]),
                          tree_leaves(per[1][1])):
        gs = CO.Shards({(0, 0, 0): a, (1, 0, 0): b})
        zero = CO.Shards({k: torch.zeros_like(v) for k, v in gs.items()})
        want = TCOMP.compress_psum_pod(gs, zero, pods, n_pods=2)[0][(0, 0, 0)]
        # the placed gradients differ from the mesh-free ones in the last
        # bits, which may move a value across a rounding boundary: by one
        # quantum a pod at most (the sum of the two pods' / 2)
        quantum = max(float(a.abs().max()), float(b.abs().max())) / 63
        assert float((leaf - want).abs().max()) <= quantum * 1.001


def test_placed_embedding_gradient_sums_in_fp32():
    """bf16 gemma2-2b SMOKE on a Zipf batch (one token id 1,075 times in
    8,192): the placed step's ``embed`` gradient within 1e-2 of its
    largest entry against the fp32 step's (its lookup scatter-adds in
    fp32)."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.training.loop import to_device
    cfg = dataclasses.replace(TC.get_smoke("gemma2-2b"), dtype=torch.bfloat16)
    params = TTF.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = to_device(make_batch(cfg, 2, 4096, seed=0), torch.device("cpu"))
    (_, _), g32 = make_loss_grad_fn(dataclasses.replace(
        cfg, dtype=torch.float32))(SH._tree_map(lambda t: t.float(), params),
                                   batch)
    pl = SH.place_params(params, param_axes(cfg), SH.TRAIN_PARAM_RULES,
                         cpu_mesh((2, 2)))
    (_, _), gp = make_loss_grad_fn(cfg)(pl, batch)
    got = SH.join_placed(gp["embed"], "cpu")
    close(got.float(), g32["embed"], 1e-2,
          "placed embed gradient against fp32")
