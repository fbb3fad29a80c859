"""Inputs of tests/test_torch_serve_mesh.py and the reference's side of it.

The reference's mesh code (``repro.serving.paged.make_paged_island`` and
``repro.serving.engine.make_serve_step`` over ``make_debug_mesh(2, 2)`` /
``(1, 4)``) needs four host devices, which jax fixes when it starts. So
the test runs it here, in ONE child process per test file
(``python tests/_torch_mesh.py OUT.npz``, started with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``), outside
``axis_rules`` (inside it jax 0.9 refuses the step's sharding
constraints), and reads the results back from the ``.npz``. Every input
is drawn here from seeded numpy generators, so the parent rebuilds the
same ones.
"""
from __future__ import annotations

import functools
import os
import sys

import numpy as np

# name -> (mesh shape, batch, kv heads, q heads, batch shards, stripes):
# slots over 'data' and heads over 'model' (case A); kv heads 2 that do
# not divide 'model' 4: 4 stripes over 'model' (case B); one slot, which
# does not cover 'data': 2 stripes over 'data', heads over 'model'
LAYOUTS = {
    "heads": ((2, 2), 4, 4, 8, 2, 1),
    "stripes": ((1, 4), 4, 2, 4, 1, 4),
    "cache": ((2, 2), 1, 4, 8, 1, 2),
}
# name -> (dtype, window, softcap, int8 arena)
VARIANTS = {
    "fp32": ("float32", 0, 0.0, False),
    "bf16": ("bfloat16", 0, 0.0, False),
    "int8": ("float32", 0, 0.0, True),
    "window": ("float32", 6, 0.0, False),
    "softcap": ("float32", 0, 30.0, False),
}
HD, BLOCK, NBLK = 16, 8, 8
# each case's pool lengths: slots of several blocks, one whose tokens lie
# on stripe 0 alone (the other stripes see nothing) and one without a
# request (-1); the one-slot layout alternates a long and a short pool
LENGTHS = {"heads": [13, 40, 5, -1], "stripes": [13, 40, 5, -1]}
CACHE_LENGTHS = [45, 5, 45, 7, 60]
STEP_ARCHS = (("yi-6b", 4), ("zamba2-2.7b", 4), ("yi-6b", 1))
STEP_ROUNDS = 3
STEP_BLOCK, STEP_NBLK = 8, 4
STEP_LENGTHS = {4: [13, 7, -1, 22], 1: [9]}


def island_case(layout: str, variant: str) -> dict:
    """One island case: the reference layout's global arena (no scratch
    row; int8 with scales for the int8 arena), the mesh page table of
    local rows [b, stripes, nblk_local], block starts, lengths, write rows
    [b, stripes] and offsets, q / k_new / v_new (fp32 numpy)."""
    _, b, kh, h, n_b, st = LAYOUTS[layout]
    vi = list(VARIANTS).index(variant)
    rng = np.random.default_rng(100 * list(LAYOUTS).index(layout) + vi)
    lengths = (LENGTHS[layout] if layout in LENGTHS
               else [CACHE_LENGTHS[vi]])
    arena, pt, wr, lens = pool(rng, b, kh, HD, BLOCK, NBLK, n_b, st,
                               lengths)
    case = dict(q=rng.standard_normal((b, h, HD)).astype(np.float32),
                kn=rng.standard_normal((b, kh, HD)).astype(np.float32),
                vn=rng.standard_normal((b, kh, HD)).astype(np.float32),
                pt=pt, bs=blk_start(b, st, NBLK // st, BLOCK),
                lengths=lens, wr=wr, off=lens % BLOCK, arena=arena)
    if VARIANTS[variant][3]:
        amax = np.abs(arena).max(axis=-1)
        sc = (np.maximum(amax, 1e-8) / 127.0).astype(np.float32)
        case["arena"] = np.clip(np.round(arena / sc[..., None]), -127,
                                127).astype(np.int8)
        case["scales"] = sc
    return case


def blk_start(b, st, nl, block) -> np.ndarray:
    """The reference's build_blk_start: (j * stripes + stripe) * block."""
    per = (np.arange(nl)[None, :] * st + np.arange(st)[:, None]) * block
    return np.broadcast_to(per[None], (b, st, nl)).astype(np.int32)


def pool(rng, b, kh, hd, block, nblk, n_b, st, lengths, lead=()):
    """A random pool in the mesh's layout: every block of an active slot
    (one with lengths >= 0) up to the block of position ``lengths +
    extra`` gets a local row of its (batch shard, stripe) shard, in a
    random order; ``lead`` dims go before the arena's row dim. Returns
    (arena [*lead, cap, 2, block, kh, hd], pt [b, st, nblk // st],
    write_rows [b, st], lengths with -1 as 0)."""
    cap = b * nblk
    cl = cap // (n_b * st)
    nl = nblk // st
    bl = b // n_b
    arena = (rng.standard_normal(tuple(lead) + (cap, 2, block, kh, hd))
             .astype(np.float32))
    free = [list(rng.permutation(cl)) for _ in range(n_b * st)]
    pt = np.full((b, st, nl), -1, np.int32)
    wr = np.full((b, st), -1, np.int32)
    lens = np.maximum(np.asarray(lengths, np.int32), 0)
    for i, n in enumerate(lengths):
        if n < 0:
            continue
        for j in range(nblk):
            shard = (i // bl) * st + j % st
            pt[i, j % st, j // st] = free[shard].pop()
        j = n // block
        wr[i, j % st] = pt[i, j % st, j // st]
    return arena, pt, wr, lens


def write_rows(pt, lengths, active, block):
    """The owner stripe's row of each active slot's tail block."""
    b, st, _ = pt.shape
    wr = np.full((b, st), -1, np.int32)
    for i in range(b):
        if active[i]:
            j = int(lengths[i]) // block
            wr[i, j % st] = pt[i, j % st, j // st]
    return wr


@functools.lru_cache(maxsize=None)
def ref_weights(arch):
    """SMOKE weights drawn by the reference under one jit (zamba2's A_log,
    D and dt_bias made nonzero, as tests/test_torch_serve_graph.py makes
    them)."""
    import jax
    import jax.numpy as jnp

    from repro import configs as JC
    from repro.models import transformer as JTF
    from repro.models.params import split
    cfg = JC.get_smoke(arch)
    jp = jax.jit(lambda k: split(JTF.init_model(k, cfg))[0])(
        jax.random.PRNGKey(0))
    if "mamba" in jp["layers"]:
        rng = np.random.default_rng(5)
        for name in ("A_log", "D", "dt_bias"):
            leaf = jp["layers"]["mamba"][name]
            jp["layers"]["mamba"][name] = jnp.asarray(
                rng.standard_normal(leaf.shape) * 0.5, jnp.float32)
    return cfg, jp


def flatten(tree, prefix: str) -> dict:
    """A nested dict of arrays -> {prefix/path: numpy array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def unflatten(flat: dict, prefix: str) -> dict:
    """The inverse of :func:`flatten` for the keys under ``prefix``."""
    tree: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def step_case(arch: str, b: int, kh: int, hd: int, n_b: int, st: int,
              n_attn: int, n_shared: int, vocab: int) -> dict:
    """A serve-step case: random arenas (and a shared block's) in the
    mesh layout, the page table, every round's tokens (the first drawn,
    later ones the reference's greedy tokens, fed by the caller) and
    lengths."""
    rng = np.random.default_rng(7 + b + len(arch))
    lengths = STEP_LENGTHS[b]
    case = {}
    arena, pt, wr, lens = pool(rng, b, kh, hd, STEP_BLOCK, STEP_NBLK, n_b,
                               st, lengths, lead=(n_attn,))
    case.update(pt=pt, wr0=wr, lengths0=lens,
                active=np.asarray(lengths) >= 0,
                tokens0=rng.integers(0, vocab, b).astype(np.int32),
                bs=blk_start(b, st, STEP_NBLK // st, STEP_BLOCK))
    case["arena"] = arena * 0.5
    if n_shared:
        case["shared_arena"] = (rng.standard_normal(
            (n_shared,) + arena.shape[1:]) * 0.5).astype(np.float32)
    return case


def _reference(out_path: str) -> None:
    """The child: every island case and serve-step case through the
    reference's mesh code over four forced host devices."""
    import jax
    import jax.numpy as jnp

    from repro.launch.mesh import make_debug_mesh
    from repro.models import transformer as JTF
    from repro.serving import engine as JE
    from repro.serving import paged as JP
    assert jax.device_count() >= 4, jax.devices()
    res = {}
    for layout, (mshape, b, kh, h, _, _) in LAYOUTS.items():
        mesh = make_debug_mesh(*mshape)
        geom = JP.plan_geometry(batch=b, seq_len=NBLK * BLOCK, kv_heads=kh,
                                head_dim=HD, q_heads=h, mesh=mesh,
                                block=BLOCK)
        for variant, (dt, window, softcap, quant) in VARIANTS.items():
            c = island_case(layout, variant)
            cast = (lambda x: jnp.asarray(x, jnp.dtype(dt)))
            island = jax.jit(JP.make_paged_island(
                geom, mesh, scale=HD ** -0.5, softcap=softcap, window=window,
                quant=quant))
            arena = (jnp.asarray(c["arena"]) if quant
                     else cast(c["arena"]))
            args = (cast(c["q"]), cast(c["kn"]), cast(c["vn"]), arena,
                    *map(jnp.asarray, (c["pt"], c["bs"], c["lengths"],
                                       c["wr"], c["off"])))
            if quant:
                args += (jnp.asarray(c["scales"]),)
            outs = island(*args)
            key = f"island/{layout}/{variant}"
            res[key + "/out"] = np.asarray(outs[0], np.float32)
            res[key + "/arena"] = np.asarray(
                outs[1], np.int8 if quant else np.float32)
            if quant:
                res[key + "/scales"] = np.asarray(outs[2])
    mesh = make_debug_mesh(2, 2)
    for arch, b in STEP_ARCHS:
        cfg, jp = ref_weights(arch)
        geom = JP.plan_geometry(batch=b, seq_len=STEP_NBLK * STEP_BLOCK,
                                kv_heads=cfg.n_kv_heads,
                                head_dim=cfg.head_dim, q_heads=cfg.n_heads,
                                mesh=mesh, block=STEP_BLOCK)
        sds, _ = JE.serve_state_specs(cfg, geom, mesh)
        n_shared = (cfg.n_shared_applications() if cfg.shared_attn_every
                    else 0)
        c = step_case(arch, b, cfg.n_kv_heads, cfg.head_dim,
                      b // geom.batch_local,
                      geom.stripe_total, JTF.n_attn_layers(cfg), n_shared,
                      cfg.vocab)
        state = {k: jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), v)
                 for k, v in sds.items()}
        if "arena" in state:
            state["arena"] = jnp.asarray(c["arena"])
        if "shared_arena" in state:
            state["shared_arena"] = jnp.asarray(c["shared_arena"])
        step = jax.jit(JE.make_serve_step(cfg, geom, mesh,
                                          return_logits=True))
        lens, tokens = c["lengths0"].copy(), c["tokens0"]
        key = f"step/{arch}/{b}"
        logits, nxts = [], []
        for _ in range(STEP_ROUNDS):
            wr = write_rows(c["pt"], lens, c["active"], STEP_BLOCK)
            inputs = {"tokens": jnp.asarray(tokens),
                      "lengths": jnp.asarray(lens),
                      "write_off": jnp.asarray(lens % STEP_BLOCK),
                      "pt": jnp.asarray(c["pt"]),
                      "blk_start": jnp.asarray(c["bs"]),
                      "write_rows": jnp.asarray(wr)}
            nxt, state, lg = step(jp, state, inputs)
            logits.append(np.asarray(lg))
            nxts.append(np.asarray(nxt))
            tokens = np.where(c["active"], np.asarray(nxt), 0).astype(
                np.int32)
            lens = lens + c["active"].astype(np.int32)
        res.update(flatten(jp, f"weights/{arch}"))
        res[key + "/logits"] = np.stack(logits)
        res[key + "/next"] = np.stack(nxts)
        for name in ("arena", "shared_arena"):
            if name in state:
                res[f"{key}/{name}"] = np.asarray(state[name])
    np.savez(out_path, **res)


def run_reference(out_path: str, timeout: float = 600.0) -> dict:
    """Start the child (four forced host devices, CPU) and load its
    results."""
    import subprocess
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [src, here, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           out_path], env=env, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"the reference child failed:\n{proc.stderr}")
    with np.load(out_path) as f:
        return dict(f)


if __name__ == "__main__":
    _reference(sys.argv[1])
