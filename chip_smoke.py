#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card and
the CUDA toolkit. Phases (one JSON line each on stdout):

0. device  -- the card's name and power limit (``nvidia-smi``).
1. build   -- compile the seven CUDA kernels from the five sources in
              ``src/repro_torch/csrc`` (one ``nvcc`` per source, in
              parallel) and report registers, shared memory and spills
              per kernel instance, and the tensor-core (HMMA) and cp.async
              (LDGSTS) instructions of the flash library (``cuobjdump``).
   comparable -- right after the build (torch.profiler): the device time
              and launches of whole calls that this tree and its parent
              both offer (``comparable_rows``: the scan with its totals,
              the hash build, the bare probe, the executors' verified
              probe route), and
              kernels, copies, host launch calls, device time, idle share
              and wall p50 per Table 2 DELETE / SELECT statement, plain
              and indexed.
2. kernels -- every relscan / hash-index kernel against its plain PyTorch
              version on the card, exact equality, at the main path's
              shapes and beyond: the scan's mask, block counts and totals
              also at caps off its 8-row and 256-row tiles (1-100,003),
              w 1-33 and columns off 16 bytes, each twice; the hash
              build over Table 2's page_id and user_id columns and at its
              edges (every row in one bucket, buckets of 128 and 129 rows,
              3, 40 and 100 buckets over 128, cap 4,194,304, 12 buckets,
              caps 1 and 100,003, no valid row), each twice on one
              scratch; the verified
              probe at w 1/32/4,096 with 0-4 and 8 residual terms, an
              extra mask and active flags, limits 1/64/200, on a fresh
              and a stale index. Then each kernel's time (CUDA events),
              its plain version's time and its bound: the scan at 1 and 2
              terms (cap 131,072), 4 terms (cap 4,194,304) and w = 32, the
              build as a whole call (both launches) on page_id, user_id
              and at cap 4,194,304, the
              probe bare and verified at w 1 and 32, the compaction also
              at cap 4,194,304. One scan, one probe and one compaction call under
              the profiler must each show one device kernel and no memset
              or copy, one build call its two kernels and nothing else.
              The shard axis of the scan, the compaction, the build and
              the verified probe (sharded tables): equal to the plain
              versions at S 1, 2, 3, 8 and cap_s 1, 25, 16,384, 100,003,
              fan-out and routed ``sid``, w 1 and 32, a shard with no valid
              row and a bucket over 128 in one shard, each call one scan,
              two build or one probe launch whatever S; then each
              shard-axis call's device time at S = 8, cap_s 16,384, its
              bound, and the time of the same work as 8 separate calls.
   kernels_attention -- the flash- and paged-attention kernels against
              their plain versions (fp32 within 1e-5, bf16 within 2e-2)
              at tests/test_kernels.py's shapes, head dims 8-256, both
              serve paths' own shapes (yi-6b at head dim 128, zamba2's
              shared block at 80), the flash kernels' tile edges (lengths
              1-300 around the 16-row warp, 64-row CTA and 64-key tiles,
              each head dim, GQA 8:1, windows, softcap, q_offset), query
              rows that see no key (a window past the last key: the mean
              of V), and the [b, s, h, hd]-transposed views
              attention_prefill passes
              (equal to the contiguous call, no copy), and the paged
              kernel's split edges (lengths on and beside a 64-position
              split, a 1,024-token sequence beside empty and 1-token slots,
              a window that drops whole splits, missing pages inside a
              split; a second call must give the same bits); then their
              times (paged: the device time of the whole call), bounds and,
              for flash attention, the time of the one PyTorch call that
              computes the same function (scaled_dot_product_attention), at
              the serve shapes and at one 2,048-token prompt with yi-6b's
              heads.
   kernels_mamba -- the Mamba2 scan kernel against its plain version
              (y within 1e-4 fp32 / 2e-2 bf16, h_last within 1e-3,
              relative and absolute) at tests/test_kernels.py's shapes,
              ragged lengths 23 and 600, zamba2's prefills (b 1, s 300 and
              24, nh 80, dh 64, st 64) and the chunk-parallel kernel's
              edges (s 1, 63, 64, 65, 129; b 3; st 16, 128, 256; dh 80), x
              in fp32 and bf16, the initial state zero and not; then its
              time at s 300 and s 24 (the device time of the whole call,
              2 launches and 1), bound and plain time (no PyTorch call
              computes this function).
3. table2  -- the paper's Table 2 deployment (100,000 records over 30,000
              pages and 1,000 users, CAPACITY 131072), with and without
              INDEX(page_id), INDEX(user_id), on the card daemon and on a
              CPU daemon: every count, row, row id and value must match,
              and no statement's dispatch may sync with the host.
4. fig1    -- the paper's Fig. 1 KV read (512 TEXT keys, geometric value
              sizes), single and micro-batched (W = 32), against the CPU
              daemon.
5. wire    -- one tagged/untagged socket script against a ThreadedServer
              on the card daemon and one on a CPU daemon: the response
              bytes must match (SHOW STATS's ``device`` and
              ``compile_ms_total`` aside).
   shards  -- sharded tables (core/shards.py): Table 2 in CAPACITY
              131072 SHARDS 8 PARTITION BY user_id, with and without
              INDEX(page_id), on the card daemon and on a CPU daemon: the
              bulk load, per-user statements (one lane), per-page ones
              (fan-out over 8 shards), EXPIRE, REINDEX, SHOW STATS's skew,
              RESHARD 4 and the statements again, a WARMUP of a pruned
              shape (a plan a lane) and a fan-out shape with warm replays,
              four threads of pruned writes through the BatchScheduler,
              FLUSH. Every result and the final state equal the CPU
              daemon's, no dispatch syncs, a warm pruned statement is one
              graph launch and no kernel launch, and a fan-out's scan,
              probe and build launch once a call. Reports the graph pool's
              bytes and wall p50s.
   graphs  -- pre-planned statements (core/execache.py): the Table 2
              indexed table and Fig. 1's read warmed at CREATE and by
              WARMUP; every warm statement must replay with no miss and
              no sync and equal the CPU daemon, a cold shape capture on
              its miss with no sync, a warm statement be one
              cudaGraphLaunch and no kernel launch; a WARMUP of new
              shapes in another thread races replays, an executemany
              grows the compaction's scratch under an older graph, and a
              REINDEX retires every plan, each followed by statements
              that must equal the CPU daemon's. Reports capture ms, the
              Table 2 table's graph-pool bytes and wall p50s.
6. serve   -- the paged-KV serving engine with yi-6b at full width (bf16,
              random weights from a seeded torch.Generator) on the card:
              launch/serve.py's default traffic (6 requests of 8-24
              tokens, 16 new tokens, 4 slots, block 16, max_seq 256), then
              one evict_user and one flush. Logits are checked teacher-
              forced against a dense, kernel-free reference on the card;
              every block count against a CPU daemon's replay of the
              ``kv`` table's statements; block allocation and the round
              (its staging, the capture's prime round, the capture and
              every replay: a decode round is one captured CUDA graph)
              run with sync debugging set to "error". One warm round with
              no block boundary must be one cudaGraphLaunch, one
              host-to-device and one device-to-host copy and no kernel
              launch; reports the capture's ms and the graph pool's bytes.
   serve_zamba2 -- the same engine with zamba2-2.7b at full width (54
              Mamba2 layers, one shared attention+MLP block after every
              6th; bf16, random weights): the launcher's 6 prompts plus
              one of 300 tokens (so the scan carries its state across
              tiles), 16 new tokens each, max_seq 512, then the same
              extra requests, evict_user and flush, with the same checks
              (the dense reference's SSM recurrence uses no scan kernel).
   snapshot -- phase shards's deployment, with and without INDEX(page_id):
              CHECKPOINT (the card's files must equal the CPU daemon's),
              RESTORE into fresh tables of 8, 4 and 1 shards and from 1
              shard back into 8 (RESTORE's re-split runs the hash build),
              then ALTER TABLE ... RETAIN SLOTS of a random half of 64
              (one graph that writes validity in place; the statements
              after it replay plans captured before it). Every count,
              every restored table's statements (no sync) and whole state
              equal the CPU daemon's. Reports the card's wall ms of
              CHECKPOINT, RESTORE and RETAIN (p50 of several).
   cluster -- benchmarks/cluster_bench.py's deployment (its CREATE:
              SHARDS 2, REPLICAS 2) over three in-process daemons on the
              card behind the port's ClusterClient, against the same
              stream through three CPU daemons: 4,096 rows, pruned and
              fan-out reads, the aggregates, writes, add_node of a fourth
              daemon (its bootstrap: CHECKPOINT / RESTORE / RETAIN SLOTS
              on the card), remove_node, SHOW CLUSTER; every result equal.
   cluster_chaos -- the cluster bench's kill window over three daemon
              child processes on the card (``python -m
              repro_torch.core.protocol --port 0``; each SHOW STATS must
              name a cuda device): 200 seed rows, 600 healthy reads, 300
              mixed ops with a SIGKILL of one child a third of the way
              in, 600 reads after it; every acknowledged write is read
              back from every live replica (zero lost), and remove_node
              leaves COUNT(*) equal to the acknowledged writes. Reports
              the healthy and post-kill read p50 / p99 and the kill
              window's max (wall µs).
7. profile -- after the main paths (torch.profiler): per decode round of
              both serve paths (host launch calls, kernels on the card,
              device time by family, idle share), and for zamba2's
              300-token prefill.

Phases 3-6 are eleven main paths (Table 2 plain, Table 2 indexed, Fig.
1, wire, graphs, shards, serve, serve_zamba2, snapshot, cluster,
cluster_chaos; the last three run after the serve paths, whose warm
round check reads the card's copy records, which a longer profiled
process was seen to lose). A statement kernel that runs inside a
captured graph counts once per launch on the card: the plan's prime run,
then each replay's captured launches. The launch counters are zeroed right before
each path and read right after it, and each path must have launched
every kernel it runs: scan and compact on the statement paths, build and
probe on the indexed Table 2 table and in graphs, probe in the wire
script (its table has INDEX(k)), all four in shards, snapshot and
cluster (cluster_chaos's kernels run in child processes, which the
counters cannot see: that path checks results only); flash attention,
paged attention and the relscan scan on
both serve paths, and the Mamba2 scan on zamba2's, each an exact number
of times (per attention layer or shared-block application and prefill or
round, the capture's prime round included; per Mamba2 layer and
prefill). Then comes a ``kernels`` line
(launches summed over the paths), the ``nvidia-smi`` line, and the final
status line.
Any failure raises: the script exits non-zero and prints no status line,
and so it does without a CUDA card or outside a checkout of the repo.
"""
import dataclasses
import json
import pathlib
import re
import socket
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
if not (SRC / "repro_torch" / "csrc").is_dir():
    sys.exit("chip_smoke.py: run it from a checkout of the repository "
             "(src/repro_torch is missing)")
sys.path.insert(0, str(SRC))

import numpy as np  # noqa: E402
import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device is present")

from repro_torch import configs  # noqa: E402
from repro_torch.core import daemon as D  # noqa: E402
from repro_torch.core import protocol as PR  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import hashidx as HX  # noqa: E402
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import relscan as RS  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

HBM_BYTES_S = 3.35e12   # H100 SXM device memory rate (NVIDIA data sheet)
SIMT_OPS_S = 67e12      # H100 SXM non-tensor-core 32-bit rate (data sheet)
BF16_OPS_S = 989e12     # H100 SXM dense bf16 tensor-core rate (data sheet)
TF32_OPS_S = 495e12     # H100 SXM dense TF32 tensor-core rate (data sheet)
ATT_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sync():
    torch.cuda.synchronize()


def time_ms(fn, iters=200, warm=20) -> float:
    """Mean time of one call, from CUDA events around ``iters``
    back-to-back calls (warmed first)."""
    for _ in range(warm):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel_symbol: str, iters=50):
    """Mean device time of one launch of the kernel whose symbol contains
    ``kernel_symbol``, from the profiler's CUDA activity (None when the
    profiler records no device time)."""
    times = [device_us(e) for e in device_events(fn, iters)
             if kernel_symbol in e.name]
    total = sum(times)
    return total / len(times) / 1e3 if times and total > 0 else None


def device_us(event) -> float:
    return (event.self_device_time_total
            if hasattr(event, "self_device_time_total")
            else event.self_cuda_time_total)


def device_events(fn, iters=1, tries=3):
    """The CUDA activities (kernels, memsets, copies) of ``iters`` calls of
    ``fn`` after one warm-up call, from the profiler. Every ``fn`` timed
    here puts work on the card, yet on the H100 the profiler now and then
    returned a window with no CUDA activity at all (cause unknown): such a
    window is profiled again, up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            sync()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if events:
            break
    return events


def call_device_ms(fn, iters=50):
    """Mean device time of one call of ``fn``: every kernel, memset and
    copy it launches (a library call may launch several)."""
    return sum(device_us(e) for e in device_events(fn, iters)) / iters / 1e3


def device_launches(fn, iters=10):
    """Kernels, memsets and copies one call of ``fn`` puts on the card."""
    return len(device_events(fn, iters)) / iters


def bound(nbytes: float, ops: float, ops_rate: float = SIMT_OPS_S):
    t_b, t_o = nbytes / HBM_BYTES_S, ops / ops_rate
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def max_err(pairs) -> int:
    err = 0
    for a, b in pairs:
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype differ: {a.shape} {a.dtype} "
                                 f"vs {b.shape} {b.dtype}")
        err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                           .abs().max()) if a.numel() else 0)
    if err != 0:
        raise AssertionError(f"kernel disagrees with its plain version "
                             f"(max abs err {err})")
    return err


# ------------------------------------------------------------ phase 0, 1

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


KERNEL_NAME = re.compile(r"(ms_state|ms_chunk|build_rows|build_buckets|scan|"
                         r"compact|probe|flash|paged_split)_kernel(_tc)?")


def kernel_key(fn: str) -> str:
    """A readable name for a mangled kernel symbol: the kernel and its
    template arguments (dtype, head dim), e.g. ``flash_kernel_tc<80>``
    (the bf16 tensor-core kernel) or ``paged_split_kernel<bf16,128>``."""
    name = KERNEL_NAME.search(fn)
    if not name:
        return fn
    inst = re.search(r"_kernel(?:_tc)?I((?:f|13__nv_bfloat16|Li\d+E)+)E", fn)
    if not inst:
        return name.group(0)
    args = [t.group(2) or ("bf16" if t.group(1) else "f32") for t in
            re.finditer(r"(13__nv_bfloat16)|Li(\d+)E|f", inst.group(1))]
    return name.group(0) + "<" + ",".join(args) + ">"


def sass_counts(lib: pathlib.Path) -> dict | None:
    """HMMA (tensor-core) and LDGSTS (cp.async) instructions in a built
    library's SASS, from cuobjdump (None where it is missing)."""
    tool = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HMMA", "LDGSTS", "LDSM")}


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t0
    report = {}
    for src, log in logs.items():
        fn, spill = None, None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn, spill = m.group(1), None
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spill = [int(m.group(1)), int(m.group(2))]
            m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem|$)",
                          line)
            if m and fn:
                report[f"{src}.{kernel_key(fn)}"] = {
                    "registers": int(m.group(1)),
                    "smem_bytes": int(m.group(2) or 0),
                    "spill_stores_loads": spill}
    libdir = _build.BUILD_ROOT / _build._digest()
    emit({"phase": "build", "seconds": round(secs, 3), "ptxas": report,
          "flash_sass": sass_counts(libdir / "libflash_attention.so")})


# ---------------------------------------------------------------- phase 2

def table2_data(n=100_000):
    """benchmarks/table2_expiry.py's dataset, seed 0."""
    rng = np.random.default_rng(SEED)
    pages = rng.integers(0, 30_000, n).astype(np.int32)
    users = rng.integers(0, 1_000, n).astype(np.int32)
    payload = rng.integers(0, 1 << 30, n).astype(np.int64)
    return pages, users, payload


def table_column(vals, cap, dev):
    col = np.zeros(cap, np.int32)
    col[: len(vals)] = vals
    valid = np.zeros(cap, bool)
    valid[: len(vals)] = True
    return (torch.from_numpy(col).to(dev), torch.from_numpy(valid).to(dev))


def check_scan_compact(rng, dev):
    """Returns the case count and each kernel's largest difference from
    its plain version (max_err raises on any nonzero one)."""
    cases = 0
    errs = {"relscan_scan": 0, "relscan_compact": 0}
    for cap in (131_072, 4_194_304, 100_003):
        cols = [torch.from_numpy(rng.integers(-100, 100, cap)
                                 .astype(np.int32)).to(dev)
                for _ in range(4)]
        valid = torch.from_numpy(rng.random(cap) < 0.8).to(dev)
        term_sets = [("==",), ("!=", "<"), ("<=", ">", ">="),
                     ("==", "!=", "<", ">="), (">=",), ("<",)]
        for ops in term_sets:
            nt = len(ops)
            vals = torch.from_numpy(rng.integers(-50, 50, (1, nt))
                                    .astype(np.int32)).to(dev)
            if ops == (">=",):
                vals[:] = -100   # every valid row matches
            if ops == ("<",):
                vals[:] = -100   # no row matches
            for w in ((1, 32) if cap != 4_194_304 else (1,)):
                v = vals.expand(w, nt).contiguous() if w > 1 else vals
                if w > 1:
                    v = v + torch.arange(w, dtype=torch.int32,
                                         device=dev)[:, None]
                mask, cnt, tot = RS.scan(cols[:nt], valid, v, ops)
                mask_r, cnt_r, tot_r = RS.scan_ref(cols[:nt], valid, v, ops)
                sync()
                errs["relscan_scan"] = max(
                    errs["relscan_scan"],
                    max_err([(mask, mask_r), (cnt, cnt_r), (tot, tot_r)]))
                for limit in (1, 64, 1000, cap + 5):
                    ids, n = RS.compact(mask, limit)
                    ids_r, n_r = RS.compact_ref(mask_r, limit)
                    sync()
                    errs["relscan_compact"] = max(
                        errs["relscan_compact"],
                        max_err([(ids, ids_r), (n, n_r),
                                 (n, cnt_r.sum(dim=1, dtype=torch.int32))]))
                    cases += 1
    # the scan's edges: caps off its 8 rows a thread and 256 a warp, w
    # beyond one CTA's 8 statements (mask rows off 8 bytes), columns and
    # validity off their 16 bytes (views one row in); twice each, for the
    # accumulator words that must be zero again after a launch
    for cap in (1, 7, 255, 257, 100_003):
        for off in (0, 1):
            base = [torch.from_numpy(rng.integers(-100, 100, cap + off)
                                     .astype(np.int32)).to(dev)
                    for _ in range(4)]
            cols = [c[off:] for c in base]
            valid = torch.from_numpy(rng.random(cap + off) < 0.8).to(dev)[off:]
            for nt in (1, 2, 3, 4):
                ops = tuple(rng.choice(list(RS.OP_CODES), nt))
                for w in (1, 3, 32, 33):
                    v = torch.from_numpy(rng.integers(-60, 60, (w, nt))
                                         .astype(np.int32)).to(dev)
                    want = RS.scan_ref(cols[:nt], valid, v, ops)
                    for _ in range(2):
                        got = RS.scan(cols[:nt], valid, v, ops)
                        sync()
                        errs["relscan_scan"] = max(
                            errs["relscan_scan"],
                            max_err(list(zip(got, want))))
                    cases += 1
    return cases, errs


def build_edge_cases(rng, dev):
    """(label, keys, valid, n_buckets) of the build's edges: every valid
    row in one bucket, buckets of exactly 128 and 129 rows, 3, 40 and 100
    buckets over 128 (a bucket's rows walked in chunks, or whole buckets
    a CTA), 4,194,304 rows in 131,072 buckets, 12 buckets (no power of
    two: 8-11 stay empty), caps 1 and 100,003 (no multiple of a CTA's
    rows or a walk's 4,096-row step), no valid row, negative keys
    throughout."""
    def one_hot(cap, n_hot):
        # n_hot rows of key 7; every other key outside 7's bucket
        nb = HX.n_buckets_for(cap)
        b7 = int(HX.bucket_of(torch.tensor([7], dtype=torch.int32), nb)[0])
        pool = np.arange(-50_000, 50_000, dtype=np.int32)
        pool = pool[HX.bucket_of(torch.from_numpy(pool), nb).numpy() != b7]
        keys = rng.choice(pool, cap).astype(np.int32)
        keys[rng.choice(cap, n_hot, replace=False)] = 7
        return keys

    def rand(cap):
        return rng.integers(-2**31, 2**31 - 1, cap).astype(np.int32)

    def hot(n_hot):
        # keys 0 .. n_hot - 1 on 300 rows each: n_hot buckets over 128
        keys = rand(131_072)
        for h in range(n_hot):
            keys[rng.choice(131_072, 300, replace=False)] = h
        return keys

    cases = [("one bucket, cap 4096", np.full(4096, -3, np.int32), 1.0),
             ("one bucket, cap 131072", np.full(131_072, -3, np.int32), 1.0),
             ("a bucket of 128", one_hot(4096, 128), 1.0),
             ("a bucket of 129", one_hot(4096, 129), 1.0),
             ("3 buckets over 128", hot(3), 0.9),
             ("40 buckets over 128", hot(40), 0.9),
             ("100 buckets over 128", hot(100), 0.9),
             ("cap 4194304", rand(4_194_304), 0.9),
             ("cap 1", rand(1), 1.0), ("cap 100003", rand(100_003), 0.5),
             ("no valid row", rand(131_072), 0.0)]
    for label, keys, frac in cases:
        valid = rng.random(keys.shape[0]) < frac
        yield (label, torch.from_numpy(keys).to(dev),
               torch.from_numpy(valid).to(dev), HX.n_buckets_for(len(keys)))
    keys = rand(300)
    yield ("12 buckets", torch.from_numpy(keys).to(dev),
           torch.from_numpy(rng.random(300) < 0.8).to(dev), 12)


def check_build_probe(dev):
    pages, users, _ = table2_data()
    cap = 131_072
    nb = HX.n_buckets_for(cap)
    overflow = {}
    errs = {"hash_build": 0, "hash_probe": 0}
    # the Table 2 columns, then the edges; builds back to back on one
    # scratch, each twice (its counters must be zero again after a call)
    cases = [(name, *table_column(vals, cap, dev), nb)
             for name, vals in (("page_id", pages), ("user_id", users))]
    for label, keys, valid, n_b in cases + list(
            build_edge_cases(np.random.default_rng(SEED + 2), dev)):
        want = HX.build_ref(keys, valid, n_buckets=n_b)
        for _ in range(2):
            got = HX.build(keys, valid, n_buckets=n_b)
            sync()
            errs["hash_build"] = max(errs["hash_build"],
                                     max_err(list(zip(got, want))))
        overflow[label] = int(got[2])
    if overflow["page_id"] != 0 or overflow["user_id"] == 0 or overflow[
            "a bucket of 129"] != 1 or overflow["a bucket of 128"] != 0:
        raise AssertionError(f"unexpected overflow counts {overflow}")
    keys, valid = table_column(pages, cap, dev)
    rid, key, _ = HX.build(keys, valid, n_buckets=nb)
    rng = np.random.default_rng(SEED + 1)
    hits = 0
    for w in (1, 64, 4096):
        q = rng.integers(-5, 35_000, w).astype(np.int32)
        q[0] = pages[0]
        qk = torch.from_numpy(q).to(dev)
        got = HX.probe(rid, key, qk)
        want = HX.probe_ref(rid, key, qk)
        sync()
        errs["hash_probe"] = max(errs["hash_probe"],
                                 max_err(list(zip(got, want))))
        hits += int(got[1].any(dim=1).sum())
    # the verified probe: the page_id index (fresh), the user_id index
    # (stale: ~100 rows a key, buckets over 128) and the page_id index with
    # its buckets out of row order; some rows dead after the build, 0-4 and
    # 8 residual terms (both instances of the kernel), an extra mask and
    # active flags, limits below and beyond the bucket's 128 lanes
    ucol, _ = table_column(users, cap, dev)
    urid, ukey, _ = HX.build(ucol, valid, n_buckets=nb)
    pcol = keys
    live = valid.clone()
    live[torch.from_numpy(rng.integers(0, 100_000, 3000)).to(dev)] = False
    extra = torch.from_numpy(rng.random(cap) < 0.6).to(dev)
    ops = list(RS.OP_CODES)
    verified = 0
    perm = torch.from_numpy(rng.permutation(HX.BUCKET_CAP)).to(dev)
    for name, (irid, ikey, kcol, src) in {
            "page_id": (rid, key, pcol, pages),
            "user_id": (urid, ukey, ucol, users),
            # every bucket's lanes out of row order, as insertions leave them
            "page_id, lanes permuted": (rid[:, perm].contiguous(),
                                        key[:, perm].contiguous(), pcol,
                                        pages)}.items():
        for w in (1, 32, 4096):
            q = rng.integers(-5, 1_005 if name == "user_id" else 31_000,
                             w).astype(np.int32)
            q[0] = src[0]
            qk = torch.from_numpy(q).to(dev)
            for nres in (0, 1, 2, 3, 4, 8):
                residual = [(pcol if t % 2 else ucol, ops[(t + nres) % 6],
                             torch.from_numpy(rng.integers(
                                 0, 30_000 if t % 2 else 1_000, w)
                                 .astype(np.int32)).to(dev))
                            for t in range(nres)]
                if nres > 3:
                    # each term passes most rows, so matches remain: an
                    # == term compares the key column with the query key
                    residual = [(kcol, op, qk) if op == "==" else
                                (col, op, v if op == "!=" else
                                 (v * 3 // 10 + (hi * 7 // 10
                                                 if op in ("<", "<=") else 0)))
                                for (col, op, v), hi in zip(
                                    residual, [1_000, 30_000] * 4)]
                for limit in (1, 64, 200):
                    for gated in (False, True):
                        kw = dict(valid=live, keycol=kcol, residual=residual,
                                  limit=limit)
                        if gated:
                            act = torch.from_numpy(rng.random(w) < 0.8).to(dev)
                            kw.update(extra_mask=extra, active=act)
                        got = HX.probe_verify(irid, ikey, qk, **kw)
                        want = HX.probe_verify_ref(irid, ikey, qk, **kw)
                        sync()
                        errs["hash_probe"] = max(
                            errs["hash_probe"], max_err(list(zip(got, want))))
                        verified += 1
    return overflow, hits, verified, errs


SHARD_CAPS = (1, 25, 16_384, 100_003)
SHARD_COUNTS = (1, 2, 3, 8)


def shard_stack(rng, n_sh, cap_s, dev, hot=False):
    """[S, cap_s] int32 keys and validity for the shard-axis checks: shard 1
    (of 2 or more) holds no valid row. With ``hot`` the keys spread over
    100,000 values (buckets of ~32 rows at the index's sizing) and shard 0
    holds 300 rows of key 7: one bucket over 128 in one shard only."""
    span = 50_000 if hot else 200
    keys = rng.integers(-span, span, (n_sh, cap_s)).astype(np.int32)
    if hot and cap_s >= 300:
        keys[0, rng.choice(cap_s, 300, replace=False)] = 7
    valid = rng.random((n_sh, cap_s)) < 0.8
    if n_sh > 1:
        valid[1] = False
    return (torch.from_numpy(keys).to(dev), torch.from_numpy(valid).to(dev))


def shard_sids(rng, n_sh, w, fanout, dev):
    """A fan-out's pairs (every shard for each of ``w`` statements, shard
    by shard) or ``w`` statements routed to random shards."""
    if fanout:
        sid = np.repeat(np.arange(n_sh), w)
    else:
        sid = rng.integers(0, n_sh, w)
    return torch.from_numpy(sid.astype(np.int32)).to(dev)


def check_shard_kernels(dev):
    """The shard axis of the scan, the compaction, the build and the
    verified probe, each equal to its plain version on the card, at S 1, 2,
    3 and 8 and cap_s 1, 25, 16,384 and 100,003; fan-out and routed sid,
    w 1 and 32; a shard with no valid row and a bucket over 128 in one
    shard. Each call must be one scan launch, two build launches and one
    probe launch, whatever S. Returns (cases, errs, overflow per shard of
    the hot build)."""
    rng = np.random.default_rng(SEED + 5)
    errs = {"relscan_scan": 0, "relscan_compact": 0, "hash_build": 0,
            "hash_probe": 0}
    cases = 0
    hot_overflow = None
    ops_sets = [("==",), ("!=", "<"), ("<=", ">", ">="),
                ("==", "!=", "<", ">=")]
    for n_sh in SHARD_COUNTS:
        for cap_s in SHARD_CAPS:
            keys, valid = shard_stack(rng, n_sh, cap_s, dev, hot=True)
            cols = [keys] + [shard_stack(rng, n_sh, cap_s, dev)[0]
                             for _ in range(3)]
            for fanout in (True, False):
                for w in (1, 32):
                    sid = shard_sids(rng, n_sh, w, fanout, dev)
                    n = sid.shape[0]
                    for ops in ops_sets:
                        nt = len(ops)
                        vals = torch.from_numpy(rng.integers(
                            -150, 150, (n, nt)).astype(np.int32)).to(dev)
                        want = RS.scan_ref(cols[:nt], valid, vals, ops,
                                           sid=sid)
                        _build.reset_launches()
                        got = RS.scan(cols[:nt], valid, vals, ops, sid=sid,
                                      run=w if fanout else 1)
                        sync()
                        if _build.launches["relscan_scan"] != 1:
                            raise AssertionError("a shard-axis scan was not "
                                                 "one launch")
                        errs["relscan_scan"] = max(
                            errs["relscan_scan"],
                            max_err(list(zip(got, want))))
                        for limit in (1, 64):
                            ids, cnt = RS.compact(got[0], limit)
                            ids_r, cnt_r = RS.compact_ref(want[0], limit)
                            sync()
                            errs["relscan_compact"] = max(
                                errs["relscan_compact"],
                                max_err([(ids, ids_r), (cnt, cnt_r)]))
                        cases += 1
            nb = HX.n_buckets_for(cap_s)
            want = HX.build_ref(keys, valid, n_buckets=nb)
            for _ in range(2):   # twice: the scratch must be zero again
                _build.reset_launches()
                got = HX.build(keys, valid, n_buckets=nb)
                sync()
                if _build.launches["hash_build"] != 1:
                    raise AssertionError("a shard-axis build was not one call")
                errs["hash_build"] = max(errs["hash_build"],
                                         max_err(list(zip(got, want))))
            if cap_s >= 300:
                ov = got[2].cpu().tolist()
                if ov[0] == 0 or any(ov[1:2]):
                    raise AssertionError(f"hot build overflow {ov}")
                hot_overflow = ov
            rid, key, _ = got
            live = valid.clone()
            live[:, ::7] = False    # rows dead after the build
            extra = torch.from_numpy(rng.random((n_sh, cap_s)) < 0.7).to(dev)
            for fanout in (True, False):
                for w in (1, 32):
                    sid = shard_sids(rng, n_sh, w, fanout, dev)
                    n = sid.shape[0]
                    # keys of live rows of the pair's shard (and some misses)
                    kh = keys.cpu().numpy()
                    q = kh[sid.cpu().numpy(), rng.integers(0, cap_s, n)]
                    q[::5] = rng.integers(-50_000, 50_000, len(q[::5]))
                    q[0] = 7
                    qk = torch.from_numpy(q).to(dev)
                    for nres in (0, 2):
                        residual = [(cols[1 + t], ("<", ">=")[t],
                                     torch.from_numpy(rng.integers(
                                         -100, 100, n).astype(np.int32))
                                     .to(dev)) for t in range(nres)]
                        for limit in (0, 64):
                            for gated in (False, True):
                                kw = dict(valid=live, keycol=keys,
                                          residual=residual, limit=limit,
                                          sid=sid)
                                if gated:
                                    kw.update(extra_mask=extra,
                                              active=torch.from_numpy(
                                                  rng.random(n) < 0.8)
                                              .to(dev))
                                want = HX.probe_verify_ref(rid, key, qk, **kw)
                                _build.reset_launches()
                                got = HX.probe_verify(rid, key, qk, **kw)
                                sync()
                                if _build.launches["hash_probe"] != 1:
                                    raise AssertionError(
                                        "a shard-axis probe was not one "
                                        "launch")
                                pairs = [(a, b) for a, b in zip(got, want)
                                         if a is not None]
                                errs["hash_probe"] = max(
                                    errs["hash_probe"], max_err(pairs))
                                cases += 1
    # S = 1 with sid = 0 is the unsharded call: the same outputs
    keys, valid = shard_stack(rng, 1, 16_384, dev)
    v = torch.tensor([[3]], dtype=torch.int32, device=dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    a = RS.scan([keys[0]], valid[0], v, ("<",))
    b = RS.scan([keys], valid, v, ("<",), sid=zero)
    nb = HX.n_buckets_for(16_384)
    c = HX.build(keys[0], valid[0], n_buckets=nb)
    d = HX.build(keys, valid, n_buckets=nb)
    sync()
    max_err(list(zip(a, b)) + [(x[None], y) for x, y in zip(c, d)])
    return cases, errs, hot_overflow


def shard_kernel_timing(dev, card):
    """Device time of each shard-axis call at S = 8, cap_s 16,384 (the
    ``shards`` phase's table: 131,072 rows), its bound and the time of the
    same work as 8 separate S = 1 calls: the fan-out scan (w 1 and 32),
    the compaction of its mask, the stacked build, the fan-out verified
    probe and a routed probe of 32 statements."""
    rng = np.random.default_rng(SEED + 6)
    n_sh, cap_s = 8, 16_384
    pages, users, _ = table2_data()
    valid = torch.zeros((n_sh, cap_s), dtype=torch.bool, device=dev)
    page = torch.zeros((n_sh, cap_s), dtype=torch.int32, device=dev)
    # Table 2's rows spread over 8 shards by user_id, as the daemon does
    from repro_torch.core import shards as SH
    sid_rows = SH.shard_of(torch.from_numpy(users), n_sh).numpy()
    for s in range(n_sh):
        rows = pages[sid_rows == s][:cap_s]
        page[s, : len(rows)] = torch.from_numpy(rows).to(dev)
        valid[s, : len(rows)] = True
    rows_out = []

    def row(label, kernel, run, separate, nbytes, ops, launches):
        names = [e.name for e in device_events(run)]
        if len(names) != launches:
            raise AssertionError(f"{label}: one call ran {names}")
        b_ms, b_by = bound(nbytes, ops)
        rows_out.append({
            "kernel": kernel, "shape": label, "ms": time_ms(run),
            "device_ms": call_device_ms(run),
            "separate_calls_device_ms": call_device_ms(separate),
            "separate_calls_ms": time_ms(separate),
            "plain_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "device_events_one_call": names})

    n = n_sh * cap_s
    for w in (1, 32):
        sid = shard_sids(rng, n_sh, w, True, dev)
        vals = torch.from_numpy(np.tile(pages[2:2 + w], n_sh).reshape(-1, 1)
                                .astype(np.int32)).to(dev)
        run = lambda: RS.scan([page], valid, vals, ("==",),  # noqa: E731
                              sid=sid, run=w)
        views = [(page[s], valid[s], vals[s * w:(s + 1) * w])
                 for s in range(n_sh)]
        sep = lambda: [RS.scan([c], v, x, ("==",)) for c, v, x in views]  # noqa
        nblk = RS.n_blocks(cap_s)
        row(f"fan-out, S = 8, cap_s 16384, w = {w}", "relscan_scan", run, sep,
            (4 + 1) * n + 4 * n_sh * w + w * n + 4 * n_sh * w * nblk
            + 4 * n_sh * w + 4 * n_sh * w, 2 * w * n, 1)
        mask = run()[0]
        views_m = [mask[s * w:(s + 1) * w] for s in range(n_sh)]
        row(f"fan-out mask [8 * {w}, 16384], limit 64", "relscan_compact",
            lambda: RS.compact(mask, 64),
            lambda: [RS.compact(m, 64) for m in views_m],
            w * n + 4 * n_sh * w * 64 + 4 * n_sh * w, w * n, 1)
    nb = HX.n_buckets_for(cap_s)
    run = lambda: HX.build(page, valid, n_buckets=nb)  # noqa: E731
    sep = lambda: [HX.build(page[s], valid[s], n_buckets=nb)  # noqa: E731
                   for s in range(n_sh)]
    row("S = 8, cap_s 16384, 512 buckets a shard", "hash_build", run, sep,
        5 * n + 8 * n_sh * nb * HX.BUCKET_CAP + 4 * n_sh,
        3 * n + n_sh * nb * HX.BUCKET_CAP, 2)
    rid, key, _ = HX.build(page, valid, n_buckets=nb)
    lanes = HX.BUCKET_CAP
    for label, w, fanout in (("fan-out, S = 8, w = 1", 1, True),
                             ("routed, 32 statements on 8 shards", 32, False)):
        sid = shard_sids(rng, n_sh, w, fanout, dev)
        nq = sid.shape[0]
        q = torch.from_numpy(np.resize(pages[2:2 + w], nq).astype(np.int32)
                             ).to(dev)
        kw = dict(valid=valid, keycol=page, limit=64)
        run = lambda: HX.probe_verify(rid, key, q, sid=sid, **kw)  # noqa
        sids = sid.cpu().tolist()
        one = [(q[i:i + 1], s) for i, s in enumerate(sids)]
        sep = lambda: [HX.probe_verify(  # noqa: E731
            rid[s], key[s], qq, valid=valid[s], keycol=page[s], limit=64)
            for qq, s in one]
        n_hit = int(run()[2].sum())
        row(f"verified, {label}, limit 64", "hash_probe", run, sep,
            4 * nq + 4 * nq + 8 * nq * lanes + 5 * n_hit + 5 * nq * lanes
            + 4 * nq + 4 * nq * 64, 2 * nq * lanes, 1)
    for r in rows_out:
        emit({"phase": "kernel_timing_shards", "card": card, **r})
    return rows_out


def phase_kernels(dev, card):
    rng = np.random.default_rng(SEED)
    cases, errs = check_scan_compact(rng, dev)
    overflow, hits, verified, errs_hx = check_build_probe(dev)
    errs.update(errs_hx)
    emit({"phase": "kernels_exact", "scan_compact_cases": cases,
          "build_overflow": overflow, "probe_queries_with_hits": hits,
          "probe_verify_cases": verified, "max_abs_err": errs})
    sh_cases, sh_errs, hot = check_shard_kernels(dev)
    for k, e in sh_errs.items():
        errs[k] = max(errs[k], e)
    emit({"phase": "kernels_exact_shards", "cases": sh_cases,
          "shard_counts": SHARD_COUNTS, "shard_caps": SHARD_CAPS,
          "hot_build_overflow_per_shard": hot, "max_abs_err": sh_errs})

    # timings at the main path's shapes
    pages, users, _ = table2_data()
    cap = 131_072
    page_col, valid = table_column(pages, cap, dev)
    user_col, _ = table_column(users, cap, dev)
    out = {}
    timings = []

    # scan: the Table 2 page delete (1 term), the 2-term select, a 4-term
    # scan of 4M rows, and 32 page deletes in one call (w = 32)
    v1 = torch.tensor([[int(pages[2])]], dtype=torch.int32, device=dev)
    v2 = torch.tensor([[int(users[1]), 15_000]], dtype=torch.int32,
                      device=dev)
    v32 = torch.from_numpy(pages[2:34].reshape(32, 1).copy()).to(dev)
    big = 4_194_304
    bcols = [torch.from_numpy(rng.integers(-100, 100, big).astype(np.int32))
             .to(dev) for _ in range(4)]
    bvalid = torch.from_numpy(rng.random(big) < 0.8).to(dev)
    bv = torch.tensor([[0, 50, -50, 3]], dtype=torch.int32, device=dev)
    bops = ("<=", "<", ">=", "!=")
    events = {}
    for label, cols, vld, vals, ops in (
            ("1 term, cap 131072", [page_col], valid, v1, ("==",)),
            ("2 terms, cap 131072", [user_col, page_col], valid, v2,
             ("==", "<")),
            ("4 terms, cap 4194304", bcols, bvalid, bv, bops),
            ("1 term, w = 32, cap 131072", [page_col], valid, v32, ("==",))):
        n, w, nt = vld.shape[0], vals.shape[0], len(ops)
        run = lambda: RS.scan(cols, vld, vals, ops)  # noqa: E731
        events[label] = [e.name for e in device_events(run)]
        # columns, validity and values read once; mask, block counts and
        # totals written once; a compare per term and row, and the AND
        b_ms, b_by = bound(nt * 4 * n + n + 4 * w * nt + w * n
                           + 4 * w * RS.n_blocks(n) + 4 * w, w * nt * n + w * n)
        row = {"kernel": "relscan_scan", "shape": label,
               "ms": time_ms(run, iters=50 if n == big else 200),
               "device_ms": device_ms(run, "scan_kernel",
                                      iters=20 if n == big else 50),
               "plain_ms": time_ms(lambda: RS.scan_ref(cols, vld, vals, ops),
                                   iters=20 if n == big else 200),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
               "library": "none: no single PyTorch call computes the "
                          "conjunction, its block counts and totals",
               "device_events_one_call": events[label]}
        timings.append(row)
        if "scan" not in out:
            out["scan"] = row
    for label, names in events.items():
        if len(names) != 1 or "scan_kernel" not in names[0]:
            raise AssertionError(f"one scan call ({label}) ran {names} on "
                                 f"the card, not one scan_kernel launch")

    # compact: SELECT * WHERE page_id = ? LIMIT 64 at cap 131072, and a
    # 4-term scan's mask at cap 4194304
    limit = 64
    mask = RS.scan([page_col], valid, v1, ("==",))[0]
    events = [e.name for e in device_events(lambda: RS.compact(mask, limit))]
    if len(events) != 1 or "compact_kernel" not in events[0]:
        raise AssertionError(f"one compact call ran {events} on the card, "
                             f"not one compact_kernel launch")
    big_mask = RS.scan(bcols, bvalid, bv, bops)[0]
    for key, m, label in (("compact", mask, "cap 131072, limit 64"),
                          ("compact_4m", big_mask, "cap 4194304, limit 64")):
        w, n = m.shape
        k_ms = time_ms(lambda: RS.compact(m, limit))
        p_ms = time_ms(lambda: RS.compact_ref(m, limit), iters=50)
        d_ms = device_ms(lambda: RS.compact(m, limit), "compact_kernel")
        # one library call computes the same ids at w = 1 (not the count):
        # the first `limit` set-bit indices in row order, 0-padded
        lib_ms, lib_dev, lib_err, lib_agrees = None, None, None, None
        try:
            lib = torch.nonzero_static(m[0], size=limit, fill_value=0)
            lib_agrees = torch.equal(lib[:, 0].to(torch.int32),
                                     RS.compact(m, limit)[0][0])
            lib_ms = time_ms(lambda: torch.nonzero_static(
                m[0], size=limit, fill_value=0))
            lib_dev = call_device_ms(lambda: torch.nonzero_static(
                m[0], size=limit, fill_value=0))
        except (RuntimeError, NotImplementedError) as e:
            lib_err = f"{type(e).__name__}: {e}"[:300]
        # the count needs every mask byte: read w * cap, write ids + count
        b_ms, b_by = bound(w * n + 4 * w * limit + 4 * w, w * n)
        out[key] = {"kernel": "relscan_compact", "shape": label, "ms": k_ms,
                    "device_ms": d_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": lib_ms,
                    "library_device_ms": lib_dev,
                    "library": "torch.nonzero_static",
                    "library_agrees": lib_agrees, "library_error": lib_err,
                    "device_events_one_call": events}
        timings.append(out[key])
    del bcols, bvalid, big_mask

    # build: the bulk load's index builds (page_id, user_id: 4096 buckets)
    # and 4,194,304 rows in 131,072 buckets; the whole call (both launches)
    big = 4_194_304
    bkeys = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, big)
                             .astype(np.int32)).to(dev)
    bvalid = torch.from_numpy(rng.random(big) < 0.9).to(dev)
    for key, label, col, vld in (
            ("build", "page_id, cap 131072, 4096 buckets", page_col, valid),
            ("build_user", "user_id, cap 131072, 4096 buckets", user_col,
             valid),
            ("build_4m", "cap 4194304, 131072 buckets", bkeys, bvalid)):
        n, n_b = vld.shape[0], HX.n_buckets_for(vld.shape[0])
        run = lambda: HX.build(col, vld, n_buckets=n_b)  # noqa: E731
        names = [e.name for e in device_events(run)]
        if len(names) > 2 or not all("build_" in x for x in names):
            raise AssertionError(f"one build call ({label}) ran {names} on "
                                 f"the card, not its two kernels alone")
        # keys and validity read once, rid / key and the overflow written
        # once; a hash, a compare and a slot per row, a rank per lane
        b_ms, b_by = bound(5 * n + 8 * n_b * HX.BUCKET_CAP + 4,
                           3 * n + n_b * HX.BUCKET_CAP)
        out[key] = {"kernel": "hash_build", "shape": label,
                    "ms": time_ms(run, iters=50),
                    "device_ms": call_device_ms(run, iters=20),
                    "device_launches": device_launches(run),
                    "plain_ms": time_ms(lambda: HX.build_ref(
                        col, vld, n_buckets=n_b), iters=20 if n == big else 50),
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    "library": "none: no single PyTorch call builds the "
                               "bucketed index",
                    "overflow": int(run()[2]),
                    "device_events_one_call": names}
        timings.append(out[key])
    del bkeys, bvalid

    # probe: one key (the singleton IndexProbe) and 32 keys (a batch),
    # bare (the TPU kernel's contract) and verified (the executors'
    # IndexProbe route: the SELECT's limit of 64, no residual term)
    rid, key, _ = HX.build(page_col, valid, n_buckets=HX.n_buckets_for(cap))
    lanes = HX.BUCKET_CAP
    for w in (1, 32):
        q = torch.from_numpy(pages[2:2 + w].copy()).to(dev)
        bare = lambda: HX.probe(rid, key, q)  # noqa: E731
        kw = dict(valid=valid, keycol=page_col, limit=limit)
        verified = lambda: HX.probe_verify(rid, key, q, **kw)  # noqa: E731
        n_hit = int(verified()[2].sum())
        for label, run, plain, nbytes in (
                (f"w = {w}", bare, lambda: HX.probe_ref(rid, key, q),
                 4 * w + 8 * w * lanes + 5 * w * lanes),
                (f"w = {w}, verified, limit {limit}", verified,
                 lambda: HX.probe_verify_ref(rid, key, q, **kw),
                 # keys and bucket lanes read, each match's validity byte
                 # and key read, safe / ok / count / ids written once
                 4 * w + 8 * w * lanes + 5 * n_hit + 5 * w * lanes + 4 * w
                 + 4 * w * limit)):
            names = [e.name for e in device_events(run)]
            if len(names) != 1 or "probe_kernel" not in names[0]:
                raise AssertionError(f"one probe call ({label}) ran {names} "
                                     f"on the card, not one probe_kernel "
                                     f"launch")
            b_ms, b_by = bound(nbytes, 2 * w * lanes)
            timings.append({
                "kernel": "hash_probe", "shape": label, "ms": time_ms(run),
                "device_ms": device_ms(run, "probe_kernel"),
                "plain_ms": time_ms(plain), "bound_ms": b_ms,
                "bound_by": b_by, "matches": n_hit, "library_ms": None,
                "library": "none: no single PyTorch call probes a bucketed "
                           "hash index", "device_events_one_call": names})
            if "probe" not in out:
                out["probe"] = timings[-1]
    for t in timings:
        emit({"phase": "kernel_timing", "card": card, **t})
    out["shard_axis"] = shard_kernel_timing(dev, card)
    return out, errs


# --------------------------------------------------- phase 2b: attention

# (b, h, kh, sq, sk, hd, causal, window, softcap, q_offset)
FLASH_CASES = [
    # tests/test_kernels.py's sweep
    (2, 4, 4, 128, 128, 64, True, 0, 0.0, 0),
    (1, 8, 2, 256, 256, 64, True, 0, 0.0, 0),
    (2, 4, 2, 128, 256, 32, False, 0, 0.0, 0),
    (1, 4, 4, 256, 256, 64, True, 96, 0.0, 0),
    (1, 4, 4, 128, 128, 64, True, 0, 50.0, 0),
    (2, 2, 2, 64, 64, 128, True, 48, 30.0, 0),
    # head dim 256, ragged lengths, q_offset, one token
    (1, 4, 2, 13, 40, 256, True, 7, 20.0, 27),
    (2, 8, 8, 100, 100, 256, True, 0, 0.0, 0),
    (3, 6, 3, 1, 1, 128, True, 0, 0.0, 0),
    (2, 8, 4, 13, 13, 8, True, 0, 0.0, 0),      # yi-6b SMOKE's head dim
    (1, 4, 2, 37, 37, 16, True, 5, 10.0, 0),
] + [(1, 32, 4, n, n, 128, True, 0, 0.0, 0)   # yi-6b's serve prefills
     for n in range(8, 25)] + [
    # zamba2's shared block: head dim 80, 32 kv heads (no GQA)
    (1, 32, 32, 24, 24, 80, True, 0, 0.0, 0),
    (1, 32, 32, 300, 300, 80, True, 0, 0.0, 0),
    (2, 4, 4, 37, 37, 80, True, 9, 15.0, 0),
]
# the flash kernels' tile edges at every compiled head dim: lengths around
# the 16-row warp tile, the 64-row CTA tile and the 64-key (32 at hd 256)
# K/V tile with GQA 8:1; a window across K/V tiles, softcap, q_offset with
# sk > sq, and all of them at once
FLASH_EDGE_CASES = [(1, 8, 1, n, n, hd, True, 0, 0.0, 0)
                    for hd in FA.HEAD_DIMS
                    for n in (1, 15, 16, 17, 63, 64, 65, 300)] + [
    c for hd in FA.HEAD_DIMS for c in (
        (1, 4, 2, 130, 130, hd, True, 70, 0.0, 0),
        (2, 4, 4, 65, 65, hd, True, 0, 30.0, 0),
        (2, 4, 2, 17, 81, hd, True, 0, 0.0, 64),
        (1, 8, 1, 100, 164, hd, True, 40, 20.0, 64))] + [
    # query rows that see no key (q_offset + row >= sk + window - 1): the
    # plain version gives the mean of V over the sk keys there
    c for hd in FA.HEAD_DIMS for c in (
        (1, 4, 2, 16, 16, hd, True, 8, 0.0, 40),
        (1, 4, 2, 16, 16, hd, True, 8, 0.0, 20),
        (1, 4, 2, 16, 16, hd, True, 4, 0.0, 8),
        (2, 8, 2, 100, 16, hd, True, 4, 0.0, 8),
        (1, 4, 4, 30, 20, hd, False, 6, 10.0, 5))]
# (b, h, kh, s, hd) of the strided case: q/k/v as attention_prefill passes
# them, [b, s, heads, hd] projections transposed to [b, heads, s, hd]
FLASH_VIEW_CASES = [(1, 32, 32, 300, 80), (1, 32, 4, 24, 128),
                    (2, 8, 2, 37, 8)]

# (b, h, kh, hd, block, nblk, window, softcap, lengths or None, holes):
# holes are (sequence, page) entries of the page table set to -1
PAGED_CASES = [
    (2, 4, 4, 64, 16, 4, 0, 0.0, None, ()),
    (3, 8, 2, 64, 16, 6, 0, 0.0, None, ()),
    (2, 4, 4, 128, 32, 3, 0, 50.0, None, ()),
    (2, 4, 2, 64, 16, 8, 40, 0.0, None, ()),
    (2, 8, 2, 256, 8, 5, 9, 30.0, None, ()),
    (2, 4, 2, 32, 16, 4, 0, 0.0, None, ()),
    (3, 8, 4, 8, 8, 6, 0, 0.0, None, ()),       # yi-6b SMOKE's head dim
    (2, 4, 4, 16, 16, 3, 7, 5.0, None, ()),
    # the serve path's decode: 4 slots, one without a request
    (4, 32, 4, 128, 16, 16, 0, 0.0, [24, 31, 0, 40], ()),
    (4, 32, 4, 128, 16, 16, 0, 0.0, [9, 17, 33, 256], ()),
    # zamba2's shared block decode: block 16, max_seq 512
    (4, 32, 32, 80, 16, 32, 0, 0.0, [24, 31, 0, 301], ()),
    (4, 32, 32, 80, 16, 32, 0, 0.0, [9, 17, 33, 512], ()),
    # the split kernel's edges (a split is 64 positions: 4 pages of 16, 8
    # of 8, 2 of 32): lengths on a split edge and either side of it
    (4, 32, 4, 128, 16, 16, 0, 0.0, [64, 128, 65, 63], ()),
    (4, 32, 32, 80, 32, 8, 0, 0.0, [64, 192, 129, 1], ()),
    # a 1,024-token sequence beside an empty and a 1-token slot
    (3, 32, 32, 80, 16, 64, 0, 0.0, [1024, 0, 1], ()),
    (3, 32, 4, 128, 16, 64, 0, 0.0, [1, 1024, 0], ()),
    # a window that drops whole early splits
    (2, 8, 2, 64, 16, 20, 40, 0.0, [300, 200], ()),
    (2, 8, 8, 80, 8, 40, 33, 20.0, [310, 64], ()),
    # a missing page in the middle of a split, and a split all missing
    (2, 8, 2, 64, 8, 12, 0, 0.0, [90, 70], ((0, 9), (1, 2))),
    (2, 8, 8, 80, 16, 16, 0, 0.0, [250, 100], ((0, 4), (0, 5), (0, 6),
                                               (0, 7), (1, 2))),
]
SERVE_DECODE_LENGTHS = [24, 31, 17, 40]
ZAMBA_DECODE_LENGTHS = [24, 31, 17, 310]
# (h, kh, hd, nblk, lengths, what) of the two decode timings: yi-6b's and
# zamba2's shared block (4 slots, block 16, bf16)
PAGED_YI = (32, 4, 128, 16, SERVE_DECODE_LENGTHS, "")
PAGED_ZAMBA = (32, 32, 80, 32, ZAMBA_DECODE_LENGTHS, " (zamba2's shared block)")


def att_err(got, want, dtype, what) -> float:
    err = float((got.float() - want.float()).abs().max())
    if not err <= ATT_TOL[dtype]:   # NaN fails too
        raise AssertionError(f"{what}: kernel differs from its plain "
                             f"version by {err} (tolerance "
                             f"{ATT_TOL[dtype]})")
    return err


def flash_inputs(gen, dev, dtype, b, h, kh, sq, sk, hd):
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((b, h, sq, hd), (b, kh, sk, hd),
                               (b, kh, sk, hd)))


def paged_inputs(rng, gen, dev, dtype, b, h, kh, hd, block, nblk, lengths,
                 holes=()):
    """Random arena rows per sequence (tests/test_kernels.py's
    construction); ``lengths`` fixes each sequence's length (0: no
    pages, as a slot without a request); ``holes`` are (sequence, page)
    entries set to -1 (missing)."""
    cap = b * nblk + 4
    pages = np.full((b, nblk), -1, np.int32)
    lens = np.zeros((b,), np.int32)
    perm = rng.permutation(cap)
    pi = 0
    for i in range(b):
        if lengths is None:
            n = int(rng.integers(1, nblk + 1))
            lens[i] = (n - 1) * block + int(rng.integers(1, block + 1))
        else:
            lens[i] = lengths[i]
            n = -(-lengths[i] // block)
        pages[i, :n] = perm[pi:pi + n]
        pi += n
    for i, j in holes:
        pages[i, j] = -1
    q = torch.randn((b, h, hd), generator=gen, device=dev).to(dtype)
    arena = torch.randn((cap, 2, block, kh, hd), generator=gen,
                        device=dev).to(dtype)
    return (q, arena, torch.from_numpy(pages).to(dev),
            torch.from_numpy(lens).to(dev))


def paged_timing(rng, gen, dev, h, kh, hd, nblk, lengths, what):
    """One decode call of paged attention at a serve path's shape: its
    time, the device time of the whole call and its device launches, the
    plain version's time and the bound."""
    q, arena, pages, lens = paged_inputs(rng, gen, dev, torch.bfloat16, 4, h,
                                         kh, hd, 16, nblk, lengths)
    scale = hd ** -0.5
    run = lambda: PA.paged_attention(  # noqa: E731
        q, arena, pages, lens, scale=scale)
    b_ms, b_by = bound(*paged_work(h, kh, hd, nblk, lengths, 2), BF16_OPS_S)
    return {
        "kernel": "paged_attention", "shape": f"b4 h{h}/kh{kh} hd{hd} "
        f"block16 nblk{nblk} lengths {lengths} bf16{what}",
        "ms": time_ms(run), "device_ms": call_device_ms(run),
        "device_launches": device_launches(run),
        "plain_ms": time_ms(lambda: PA.paged_attention_ref(
            q, arena, pages, lens, scale=scale)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "library": "none: no single PyTorch call gathers K/V through a page "
                   "table"}


def flash_work(b, h, kh, sq, sk, hd, elem, causal=True, q_offset=0):
    """(bytes, FLOP) one flash call must move and do: q, k, v read once,
    the output written once; QK^T and PV over the visible (q, k) pairs."""
    nbytes = (2 * b * h * sq * hd + 2 * b * kh * sk * hd) * elem
    pairs = sum(min(sk, q_offset + i + 1) if causal else sk
                for i in range(sq))
    return nbytes, 4 * b * h * pairs * hd


def paged_work(h, kh, hd, nblk, lengths, elem):
    """(bytes, FLOP) of one decode call: q and out once, each visible K/V
    row once, pages and lengths; QK^T and PV over the visible tokens."""
    b = len(lengths)
    tokens = int(sum(lengths))
    nbytes = (2 * b * h * hd + 2 * tokens * kh * hd) * elem \
        + 4 * b * nblk + 4 * b
    return nbytes, 4 * h * hd * tokens


def check_flash_views(gen, dev, dtype, b, h, kh, s, hd, what):
    """Flash on [b, s, heads, hd] projections transposed to [b, heads, s,
    hd], as attention_prefill passes them: equal to the contiguous call,
    the output in q's layout, within tolerance of the plain version, and
    the caching allocator hands out the output's bytes and nothing else
    (no copy). Returns (max abs err, bytes allocated by the call)."""
    q, k, v = (torch.randn((b, s, n, hd), generator=gen, device=dev)
               .to(dtype).transpose(1, 2) for n in (h, kh, kh))
    kw = dict(scale=hd ** -0.5)
    want = FA.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              **kw)
    sync()
    before = torch.cuda.memory_stats(dev)["allocated_bytes.all.allocated"]
    got = FA.flash_attention(q, k, v, **kw)
    sync()
    grown = (torch.cuda.memory_stats(dev)["allocated_bytes.all.allocated"]
             - before)
    if grown != -(-got.numel() * got.element_size() // 512) * 512:
        raise AssertionError(f"{what}: the call allocated {grown} bytes, "
                             f"more than its output")
    if got.stride() != q.stride() or not torch.equal(got, want):
        raise AssertionError(f"{what}: differs from the contiguous call")
    return att_err(got, FA.flash_attention_ref(q, k, v, **kw), dtype,
                   what), grown


def phase_kernels_attention(dev, card):
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    errs = {"flash_attention": 0.0, "paged_attention": 0.0}
    per_case = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for (b, h, kh, sq, sk, hd, causal, window, softcap,
             q_offset) in FLASH_CASES + FLASH_EDGE_CASES:
            q, k, v = flash_inputs(gen, dev, dtype, b, h, kh, sq, sk, hd)
            kw = dict(scale=hd ** -0.5, causal=causal, window=window,
                      softcap=softcap, q_offset=q_offset)
            got = FA.flash_attention(q, k, v, **kw)
            want = FA.flash_attention_ref(q, k, v, **kw)
            sync()
            shape = f"{b}x{h}/{kh}x{sq}x{sk}x{hd} w{window} c{softcap}"
            e = att_err(got, want, dtype, f"flash_attention {shape} {dname}")
            errs["flash_attention"] = max(errs["flash_attention"], e)
            per_case.append(["flash", dname, shape, e])
        for (b, h, kh, hd, block, nblk, window, softcap, lengths,
             holes) in PAGED_CASES:
            q, arena, pages, lens = paged_inputs(rng, gen, dev, dtype, b, h,
                                                 kh, hd, block, nblk, lengths,
                                                 holes)
            kw = dict(scale=hd ** -0.5, softcap=softcap, window=window)
            got = PA.paged_attention(q, arena, pages, lens, **kw)
            want = PA.paged_attention_ref(q, arena, pages, lens, **kw)
            again = PA.paged_attention(q, arena, pages, lens, **kw)
            sync()
            shape = f"{b}x{h}/{kh}x{hd} blk{block}x{nblk} w{window} " \
                    f"c{softcap} lengths {lengths} holes {list(holes)}"
            if not torch.equal(got, again):
                raise AssertionError(f"paged_attention {shape} {dname}: a "
                                     f"second call differs (split counters)")
            e = att_err(got, want, dtype, f"paged_attention {shape} {dname}")
            errs["paged_attention"] = max(errs["paged_attention"], e)
            per_case.append(["paged", dname, shape, e])
        for b, h, kh, s, hd in FLASH_VIEW_CASES:
            shape = f"{b}x{h}/{kh}x{s}x{hd} transposed views"
            e, grown = check_flash_views(gen, dev, dtype, b, h, kh, s, hd,
                                         f"flash_attention {shape} {dname}")
            errs["flash_attention"] = max(errs["flash_attention"], e)
            per_case.append(["flash", dname, shape, e,
                             f"allocated {grown} bytes"])
    emit({"phase": "kernels_attention", "card": card, "cases": len(per_case),
          "tolerance": {"float32": ATT_TOL[torch.float32],
                        "bfloat16": ATT_TOL[torch.bfloat16]},
          "max_abs_err": errs, "per_case": per_case})

    # timings at the serve path's shapes (yi-6b, bf16)
    out = {}
    bf = torch.bfloat16
    b, h, kh, s, hd = 1, 32, 4, 24, 128
    q, k, v = flash_inputs(gen, dev, bf, b, h, kh, s, s, hd)
    scale = hd ** -0.5
    run = lambda: FA.flash_attention(q, k, v, scale=scale)  # noqa: E731
    k_ms = time_ms(run)
    p_ms = time_ms(lambda: FA.flash_attention_ref(q, k, v, scale=scale))
    d_ms = device_ms(run, "flash_kernel")
    b_ms, b_by = bound(*flash_work(b, h, kh, s, s, hd, 2), BF16_OPS_S)
    lib_ms, lib_dev, lib_err, lib_diff = None, None, None, None
    try:
        import torch.nn.functional as F
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=True, scale=scale, enable_gqa=True)
        lib_diff = float((sdpa().float() - run().float()).abs().max())
        if not lib_diff <= ATT_TOL[bf]:
            raise AssertionError(f"scaled_dot_product_attention differs "
                                 f"from the kernel by {lib_diff}")
        lib_ms = time_ms(sdpa)
        lib_dev = call_device_ms(sdpa)
    except (TypeError, RuntimeError) as e:
        lib_err = f"{type(e).__name__}: {e}"[:300]
    # the serve path's layout: [b, s, h, hd] transposed views, read in
    # place, against the same views copied first (what the wrapper did
    # before it read strides)
    qv, kv, vv = (t.transpose(1, 2).contiguous().transpose(1, 2)
                  for t in (q, k, v))
    views_ms = time_ms(lambda: FA.flash_attention(qv, kv, vv, scale=scale))
    copies_ms = time_ms(lambda: FA.flash_attention(
        qv.contiguous(), kv.contiguous(), vv.contiguous(), scale=scale))
    out["flash_attention"] = {
        "kernel": "flash_attention", "shape": "b1 h32/kh4 sq=sk=24 hd128 "
        "bf16 causal (the longest serve prompt)", "ms": k_ms,
        "device_ms": d_ms, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": lib_ms, "library_device_ms": lib_dev,
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "library_max_abs_diff": lib_diff, "library_error": lib_err,
        "ms_transposed_views": views_ms,
        "ms_transposed_views_copied_first": copies_ms}

    out["paged_attention"] = paged_timing(rng, gen, dev, *PAGED_YI)

    # zamba2's shared block (hd 80, kh 32): prefills of 24 and 300 tokens;
    # one 2,048-token prompt with yi-6b's heads (timed for the table only)
    for name, h, kh, s, hd, what in (
            ("flash_attention_hd80_s24", 32, 32, 24, 80,
             "zamba2's shared block"),
            ("flash_attention_hd80_s300", 32, 32, 300, 80,
             "zamba2's shared block"),
            ("flash_attention_s2048", 32, 4, 2048, 128,
             "yi-6b's heads, one long prompt")):
        scale = hd ** -0.5
        q, k, v = flash_inputs(gen, dev, bf, 1, h, kh, s, s, hd)
        run = lambda: FA.flash_attention(q, k, v, scale=scale)  # noqa: E731
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731,E501
            q, k, v, is_causal=True, scale=scale, enable_gqa=kh != h)
        lib_diff = float((sdpa().float() - run().float()).abs().max())
        if not lib_diff <= ATT_TOL[bf]:
            raise AssertionError(f"scaled_dot_product_attention differs "
                                 f"from the kernel by {lib_diff}")
        b_ms, b_by = bound(*flash_work(1, h, kh, s, s, hd, 2), BF16_OPS_S)
        long = s > 300
        out[name] = {
            "kernel": "flash_attention", "shape": f"b1 h{h}/kh{kh} "
            f"sq=sk={s} hd{hd} bf16 causal ({what})", "ms": time_ms(run),
            "device_ms": device_ms(run, "flash_kernel"),
            "plain_ms": time_ms(lambda: FA.flash_attention_ref(
                q, k, v, scale=scale), iters=10 if long else 50,
                warm=2 if long else 20),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(sdpa),
            "library_device_ms": call_device_ms(sdpa),
            "library": "torch.nn.functional.scaled_dot_product_attention",
            "library_max_abs_diff": lib_diff}
    out["paged_attention_hd80"] = paged_timing(rng, gen, dev, *PAGED_ZAMBA)
    for t in out.values():
        emit({"phase": "kernel_timing", "card": card, **t})
    return out, errs


# ------------------------------------------------ phase 2c: Mamba2 scan

# (b, s, nh, dh, st): tests/test_kernels.py's shapes, ragged last tiles,
# zamba2's prefills of 300 and 24 tokens; the chunk-parallel kernel's
# edges: one step, one chunk and a step either side of it, three chunks
# with a ragged one, b 3, st 16, 128 and 256, dh past one 64-row block
MAMBA_CASES = [(2, 64, 2, 16, 8), (1, 128, 4, 32, 16), (2, 96, 1, 8, 4),
               (2, 23, 3, 16, 8), (1, 600, 4, 64, 64), (1, 300, 80, 64, 64),
               (1, 24, 80, 64, 64), (1, 1, 80, 64, 64), (1, 63, 80, 64, 64),
               (1, 64, 80, 64, 64), (1, 65, 80, 64, 64), (1, 129, 80, 64, 64),
               (3, 129, 4, 64, 64), (2, 150, 4, 64, 16), (1, 150, 4, 64, 128),
               (1, 70, 2, 16, 256), (2, 130, 3, 80, 32)]
MAMBA_SERVE = (1, 300, 80, 64, 64)
MAMBA_SHORT = (1, 24, 80, 64, 64)
# |kernel - plain| <= tol * (1 + |plain|): y in fp32 (summation order over
# 64-step tiles), y in bf16 (one rounding of the output), h_last (fp32
# whatever x is; the state sums run over the whole sequence)
MAMBA_TOL = {"y_float32": 1e-4, "y_bfloat16": 2e-2, "h_last": 1e-3}


def mamba_inputs(gen, dev, dtype, b, s, nh, dh, st, h0):
    """tests/test_kernels.py's distributions; ``h0``: a zero state (what
    the prefill passes) or a random one (a carried state)."""
    def n(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    sp = torch.nn.functional.softplus
    x = n(b, s, nh, dh).to(dtype)
    hz = (n(b, nh, dh, st) if h0 else
          torch.zeros((b, nh, dh, st), device=dev))
    return x, sp(n(b, s, nh)), -sp(n(b, s, nh)), n(b, s, st), n(b, s, st), hz


def mamba_err(got, want, tol, what) -> float:
    err = float(((got.float() - want.float()).abs()
                 / (1 + want.float().abs())).max())
    if not err <= tol:   # NaN fails too
        raise AssertionError(f"{what}: kernel differs from its plain "
                             f"version by {err} (tolerance {tol})")
    return err


def mamba_work(b, s, nh, dh, st, elem, chunk=MS.CHUNK):
    """(bytes, FLOP) of one scan: x, dt, dA, B, C and h0 read once, y and
    h_last written once; per tile of n steps the causal C B^T (shared by
    the heads) and W x products (n (n + 1) / 2 pairs), and per step and
    head the two [dh, st] state products (C h^T for y, x B^T for h)."""
    nbytes = (2 * b * s * nh * dh * elem + 4 * (2 * b * s * nh
              + 2 * b * s * st + 2 * b * nh * dh * st))
    pairs = sum(n * (n + 1) // 2 for n in
                [chunk] * (s // chunk) + ([s % chunk] if s % chunk else []))
    flop = 2 * b * pairs * (st + nh * dh) + 2 * 2 * b * s * nh * dh * st
    return nbytes, flop


def phase_kernels_mamba(dev, card):
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rel, err = 0.0, 0.0    # the checked measure; the plain max |difference|
    per_case = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for shape in MAMBA_CASES:
            for h0 in (False, True):
                args = mamba_inputs(gen, dev, dtype, *shape, h0)
                y, h = MS.mamba2_scan(*args)
                y_r, h_r = MS.mamba2_scan_ref(*args)
                sync()
                what = f"mamba2_scan {'x'.join(map(str, shape))} {dname} " \
                       f"h0={'random' if h0 else 'zero'}"
                if y.dtype != dtype or y.shape != y_r.shape:
                    raise AssertionError(f"{what}: y is {y.dtype} "
                                         f"{tuple(y.shape)}")
                e_y = mamba_err(y, y_r, MAMBA_TOL[f"y_{dname}"], what + " y")
                e_h = mamba_err(h, h_r, MAMBA_TOL["h_last"], what + " h_last")
                a_y, a_h = (float((a.float() - b.float()).abs().max())
                            for a, b in ((y, y_r), (h, h_r)))
                rel, err = max(rel, e_y, e_h), max(err, a_y, a_h)
                per_case.append([what, e_y, e_h, a_y, a_h])
    emit({"phase": "kernels_mamba", "card": card, "cases": len(per_case),
          "tolerance": MAMBA_TOL, "max_rel_err": rel, "max_abs_err": err,
          "per_case [what, rel y, rel h_last, abs y, abs h_last]": per_case})

    t = mamba_timing(gen, dev, MAMBA_SERVE, "zamba2's 300-token prefill")
    short = mamba_timing(gen, dev, MAMBA_SHORT,
                         "just above zamba2's serve prompts of 8-23 tokens")
    for row in (t, short):
        emit({"phase": "kernel_timing", "card": card, **row})
    emit({"phase": "kernel_timing_short_prefills", "card": card,
          **mamba_short_prefills(gen, dev)})
    return {"mamba2_scan": t, "mamba2_scan_s24": short}, {"mamba2_scan": err}


def mamba_timing(gen, dev, shape, what):
    """One scan call (fp32 x, zero h0, as the prefill passes): its time,
    the device time of the whole call and its device launches, the plain
    version's time and the bound."""
    args = mamba_inputs(gen, dev, torch.float32, *shape, False)
    run = lambda: MS.mamba2_scan(*args)  # noqa: E731
    b_ms, b_by = bound(*mamba_work(*shape, 4))
    b, s, nh, dh, st = shape
    return {"kernel": "mamba2_scan", "shape": f"b{b} s{s} nh{nh} dh{dh} "
            f"st{st} fp32 x, zero h0 ({what})", "ms": time_ms(run),
            "device_ms": call_device_ms(run),
            "device_launches": device_launches(run),
            "plain_ms": time_ms(lambda: MS.mamba2_scan_ref(*args), iters=20,
                                warm=3),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_tc_ms": mamba_bound_tc(shape), "library_ms": None,
            "library": "none: no single PyTorch call computes the SSD scan"}


def mamba_bound_tc(shape):
    """The scan's bound at the rate its products run at: mma.sync TF32 in
    the 3-term split form (three products each, fp32 accuracy), i.e. a
    third of the TF32 peak. ``bound_ms`` keeps the fp32 SIMT rate, the
    yardstick of the scan's earlier rows."""
    return bound(*mamba_work(*shape, 4), TF32_OPS_S / 3)[0]


def mamba_short_prefills(gen, dev):
    """The device time of one scan call at each length of zamba2's short
    serve prefills (serve_zamba2's prompts but the 300-token one), and
    over all of that path's short-prefill launches (one a Mamba2 layer a
    prefill), beside their bounds."""
    cfg = configs.get_config("zamba2-2.7b")
    lengths = [len(p) for p in serve_prompts(cfg)
               + serve_prompts(cfg, 3, seed=SEED + 1)]
    layers = len(cfg.ssm_layer_ids)
    per = {}
    for s in sorted(set(lengths)):
        shape = (1, s, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
        args = mamba_inputs(gen, dev, torch.float32, *shape, False)
        per[s] = {"device_ms": call_device_ms(lambda: MS.mamba2_scan(*args)),
                  "bound_ms": bound(*mamba_work(*shape, 4))[0],
                  "bound_tc_ms": mamba_bound_tc(shape)}
    total = {k: layers * sum(per[s][k] for s in lengths) for k in
             ("device_ms", "bound_ms", "bound_tc_ms")}
    return {"kernel": "mamba2_scan", "prompt_lens": lengths,
            "mamba2_layers": layers, "launches": layers * len(lengths),
            "per_length": per, "all_launches": total}


# ---------------------------------------------------------------- phase 3

def snap(r):
    if isinstance(r, list):
        return [snap(x) for x in r]
    ids = r.row_ids
    return {"count": r.count, "value": r.value, "rows": r.rows,
            "row_ids": None if ids is None else np.asarray(ids).tolist()}


class Pair:
    """The card daemon and a CPU daemon taking the same statements; every
    result must match exactly."""

    def __init__(self, **kw):
        self.gpu = D.SQLCached(**kw)
        self.cpu = D.SQLCached(device="cpu", **kw)
        self.lat: dict[str, list] = {}

    def run(self, kind, sql, *args, label=None, **kw):
        t0 = time.perf_counter()
        # dispatch must not sync with the host: PyTorch raises on any
        # synchronizing call while this mode is on
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = getattr(self.gpu, kind)(sql, *args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        self.gpu.drain()
        dt = (time.perf_counter() - t0) * 1e6
        got = snap(got)
        want = snap(getattr(self.cpu, kind)(sql, *args, **kw))
        if got != want:
            raise AssertionError(f"card and CPU daemons differ on {sql!r}: "
                                 f"{str(got)[:300]} vs {str(want)[:300]}")
        if label is not None:
            self.lat.setdefault(label, []).append(dt)
        return got


def p50(xs):
    return float(np.percentile(np.asarray(xs), 50))


def phase_table2(card, variant, extra):
    """One Table 2 table (``extra`` adds its indexes) on the card daemon
    and on a CPU daemon; the statements of benchmarks/table2_expiry.py."""
    pages, users, payload = table2_data()
    pr = Pair()
    pr.run("execute", f"CREATE TABLE cache (page_id INT, user_id INT, "
                      f"data BIGINT{extra}) CAPACITY 131072 MAX_SELECT 64")
    t0 = time.perf_counter()
    pr.run("executemany",
           "INSERT INTO cache (page_id, user_id, data) VALUES (?, ?, ?)",
           list(zip(pages.tolist(), users.tolist(), payload.tolist())))
    load_s = time.perf_counter() - t0
    stale = None
    if extra:
        stale = int(pr.gpu.tables["cache"].state["indexes"]["user_id"]
                    ["stale"])
        if stale == 0:
            raise AssertionError("the user_id index should overflow")
    # warm every statement shape once (first use of a PyTorch op on
    # the card loads its module), as benchmarks/table2_expiry.py does
    pr.run("execute", "DELETE FROM cache WHERE page_id = ?", (-1,))
    pr.run("execute", "DELETE FROM cache WHERE user_id = ?", (-1,))
    pr.run("executemany", "DELETE FROM cache WHERE page_id = ?",
           [(-2 - i,) for i in range(64)])
    pr.run("execute", "SELECT * FROM cache WHERE page_id = ? LIMIT 64",
           (-1,))
    pr.run("execute", "SELECT page_id, data FROM cache WHERE "
           "user_id = ? AND page_id < ?", (-1, 15_000))
    pr.run("execute", "UPDATE cache SET data = data + 1 WHERE "
           "page_id = ?", (-1,))
    deleted = 0
    for p in pages[2:66]:
        deleted += pr.run("execute", "DELETE FROM cache WHERE page_id = ?",
                          (int(p),), label="page_delete")["count"]
    n_user = pr.run("execute", "DELETE FROM cache WHERE user_id = ?",
                    (int(users[1]),), label="user_delete")["count"]
    pr.run("executemany", "DELETE FROM cache WHERE page_id = ?",
           [(int(p),) for p in pages[66:130]], label="page_delete_x64")
    for p in pages[130:146]:
        pr.run("execute", "SELECT * FROM cache WHERE page_id = ? LIMIT 64",
               (int(p),), label="page_select")
    for u in users[200:208]:
        pr.run("execute", "SELECT page_id, data FROM cache WHERE "
               "user_id = ? AND page_id < ?", (int(u), 15_000),
               label="two_term_select")
    pr.run("execute", "SELECT COUNT(*) FROM cache", label="count")
    pr.run("execute", "SELECT SUM(data) FROM cache", label="sum")
    pr.run("execute", "UPDATE cache SET data = data + 1 WHERE page_id = ?",
           (int(pages[300]),), label="update")
    pr.run("execute", "SELECT data FROM cache WHERE page_id = ?",
           (int(pages[300]),))
    # fine-grained TTL expiry on a TTL table after the clock advanced
    pr.run("execute", f"CREATE TABLE ttl (page_id INT, user_id INT, "
                      f"data BIGINT{extra}) CAPACITY 131072 TTL 5")
    pr.run("executemany",
           "INSERT INTO ttl (page_id, user_id, data) VALUES (?, ?, ?) "
           "TTL ?", [(int(pages[i]), int(users[i]), int(payload[i]),
                      int(i % 10)) for i in range(20_000)])
    for db in (pr.gpu, pr.cpu):
        db.advance_clock(7, "ttl")
    n_exp = pr.run("execute", "EXPIRE ttl", label="expire")["count"]
    for name in ("cache", "ttl"):
        g = pr.gpu.tables[name].state
        c = pr.cpu.tables[name].state
        for k in ("valid", "clock"):
            if not torch.equal(g[k].cpu(), c[k]):
                raise AssertionError(f"{variant}/{name}: {k} differs")
        for col in g["cols"]:
            if not torch.equal(g["cols"][col].cpu(), c["cols"][col]):
                raise AssertionError(f"{variant}/{name}: column {col} "
                                     f"differs")
    emit({"phase": f"table2_{variant}", "card": card,
          "load_s": round(load_s, 3), "user_index_stale": stale,
          "page_rows_deleted": deleted, "user_rows_deleted": n_user,
          "ttl_rows_expired": n_exp,
          "p50_us": {k: round(p50(v), 1) for k, v in pr.lat.items()},
          "live_rows": pr.gpu.live_rows("cache")})


# ---------------------------------------------------------------- phase 4

def phase_fig1(card):
    sizes = [16, 64, 256, 1024, 4096]
    rng = np.random.default_rng(SEED)
    n_keys, n_reads, W = 512, 512, 32
    idx = np.minimum(rng.geometric(0.5, size=n_keys) - 1, len(sizes) - 1)
    values = {f"k{i}": "x" * sizes[j] for i, j in enumerate(idx)}
    pr = Pair()
    pr.run("execute", f"CREATE TABLE kv (k TEXT, v TEXT) CAPACITY "
                      f"{2 * n_keys} MAX_SELECT 8")
    pr.run("executemany", "INSERT INTO kv (k, v) VALUES (?, ?)",
           list(values.items()))
    keys = [f"k{int(i)}" for i in rng.integers(0, n_keys, n_reads)]
    sql = "SELECT v FROM kv WHERE k = ? LIMIT 1"
    pr.run("execute", sql, ("k0",))            # warm both shapes
    pr.run("executemany", sql, [(k,) for k in keys[:W]])
    for k in keys:
        r = pr.run("execute", sql, (k,), label="single_read")
        if r["rows"] != [{"v": values[k]}]:
            raise AssertionError(f"wrong value for {k}")
    for i in range(0, n_reads, W):
        chunk = [(k,) for k in keys[i:i + W]]
        pr.run("executemany", sql, chunk, label="batch_read")
    emit({"phase": "fig1", "card": card, "reads": n_reads, "W": W,
          "single_read_p50_us": round(p50(pr.lat["single_read"]), 1),
          "batched_read_p50_us_per_read":
              round(p50(pr.lat["batch_read"]) / W, 2)})


# ---------------------------------------------------------------- phase 5

def frame(sql, args=(), tag=None):
    sfx = "" if tag is None else f"#{tag}"
    lines = [f"EXEC{sfx} {sql}"] + [PR._encode_arg(a) for a in args] \
        + [f"GO{sfx}"]
    return ("\r\n".join(lines) + "\r\n").encode()


def exchange(addr, script: bytes) -> bytes:
    with socket.create_connection(addr, timeout=120) as s:
        s.sendall(script + b"PING\r\n")
        buf = b""
        while not buf.endswith(b"PONG\r\n"):
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            buf += chunk
    return buf


def phase_wire(card):
    script = frame("CREATE TABLE w (k INT, u INT, s TEXT, INDEX(k)) "
                   "CAPACITY 4096 MAX_SELECT 16")
    for i in range(100):
        script += frame("INSERT INTO w (k, u, s) VALUES (?, ?, ?)",
                        [i % 37, i % 5, f"s{i}"], tag=f"i{i}")
    for i in range(20):
        script += frame("SELECT k, s FROM w WHERE k = ?", [i], tag=f"q{i}")
    script += frame("SELECT s FROM w WHERE u = ? AND k < ?", [3, 20])
    script += frame("DELETE FROM w WHERE k = ?", [5], tag="d")
    script += frame("DELETE FROM w WHERE u = ?", [4])
    script += frame("SELECT COUNT(*) FROM w", tag="c")
    script += frame("EXPLAIN SELECT s FROM w WHERE k = ?", tag="x")
    script += frame("SHOW STATS w", tag="st")
    script += b"EXEC#bad INSERT INTO w (k, u, s) VALUES (?, ?, ?)\r\n" \
              b"ARG#bad Z 1\r\nARG#bad I 2\r\nGO#bad\r\n"
    script += frame("SELECT COUNT(*) FROM w")
    outs = {}
    # no CREATE-time warm-up here: SHOW STATS's executor counts must not
    # depend on how far a background warm-up got
    for name, db in (("gpu", D.SQLCached(warmup=False)),
                     ("cpu", D.SQLCached(device="cpu", warmup=False))):
        with PR.ThreadedServer(db=db) as srv:
            t0 = time.perf_counter()
            outs[name] = exchange(srv.addr, script)
            outs[name + "_s"] = time.perf_counter() - t0
    mask = lambda b: re.sub(  # noqa: E731
        rb'"(device|compile_ms_total)": [^,}]*', rb'"\1": "-"', b)
    if mask(outs["gpu"]) != mask(outs["cpu"]):
        raise AssertionError("wire responses differ between the card and "
                             "the CPU daemon")
    lines = outs["gpu"].count(b"\r\n")
    if b"ERR#bad" not in outs["gpu"] or b"ROW#q19" not in outs["gpu"]:
        raise AssertionError("wire script did not answer as expected")
    emit({"phase": "wire", "card": card, "response_lines": lines,
          "bytes": len(outs["gpu"]), "gpu_script_s": round(outs["gpu_s"], 3),
          "cpu_script_s": round(outs["cpu_s"], 3)})


# ---------------------------------------------------------------- phase 6

SERVE_LOGIT_ATOL = 0.05   # yi-6b's; zamba2's is measured (teacher_forced)
SERVE_BLOCK = 16
ZAMBA_LONG_PROMPT = 300   # tokens: the scan carries its state over 5 tiles


def serve_prompts(cfg, n=6, seed=SEED):
    """launch/serve.py's default traffic: n prompts of 8-24 tokens."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=int(rng.integers(8, 24)))
            .astype(np.int32) for _ in range(n)]


class KvLog:
    """Records every statement the engine's daemon runs (after its CREATE
    TABLE), for a CPU daemon to replay."""

    def __init__(self, db):
        self.log = []
        execute, executemany = db.execute, db.executemany

        def rec_execute(sql, params=(), payloads=None):
            r = execute(sql, params, payloads)
            self.log.append(("execute", sql, tuple(params), r))
            return r

        def rec_executemany(sql, params_list, *a, **kw):
            r = executemany(sql, params_list, *a, **kw)
            self.log.append(("executemany", sql, list(params_list), r))
            return r

        db.execute, db.executemany = rec_execute, rec_executemany

    def replay(self, cap: int) -> dict:
        """Run the log on a CPU daemon: every INSERT must allocate the same
        rows and every DELETE / FLUSH remove the same count."""
        cpu = D.SQLCached(device="cpu")
        cpu.execute("CREATE TABLE kv (slot INT, seq_id INT, user_id INT, "
                    "pos_block INT, prefix_hash INT) "
                    f"CAPACITY {cap} MAX_SELECT 256")
        counts = {"insert": 0, "delete": 0, "flush": 0}
        for kind, sql, params, got in self.log:
            want = getattr(cpu, kind)(sql, params)
            verb = sql.split()[0].lower()
            counts[verb] += 1
            if verb == "insert":
                same = np.array_equal(np.asarray(got.row_ids),
                                      np.asarray(want.row_ids))
            else:
                same = got.count == want.count
            if not same:
                raise AssertionError(f"card and CPU daemons differ on "
                                     f"{sql!r} {params}")
        return {"statements": counts, "cpu_live_rows": cpu.live_rows("kv")}


def guard(obj, name, timer=None):
    """Wrap ``obj.name`` so that it runs with sync debugging set to
    "error" (PyTorch raises on any call that waits for the card) and,
    given ``timer``, add its host time to ``timer[name]``."""
    fn = getattr(obj, name)

    def guarded(*a, **kw):
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            if timer is not None:
                timer[name] = timer.get(name, 0.0) + time.perf_counter() - t0

    setattr(obj, name, guarded)


def teacher_forced(cfg, params, dev, records, atol=SERVE_LOGIT_ATOL):
    """The kernel path's tokens through a dense, kernel-free reference on
    the card: every prompt and its generated tokens go one token a step
    through ``decode_step`` (dense cache, plain attention, the SSM
    recurrence) in one batch. The reference's logits after token n-1 must
    match the prefill's, and after each generated token the next round's,
    within ``atol``; where the reference's top-2 margin exceeds that
    tolerance the kernel path must have picked the reference's token.

    ``atol=None`` sets the tolerance from bf16's own error: the same
    reference also runs in fp32 (the weights' values cast up), and the
    kernel path may differ from the bf16 reference by at most twice the
    bf16 reference's largest distance from the fp32 run on the checked
    steps (the kernel path then computes no worse than a kernel-free bf16
    evaluation of the same model, within a factor of two)."""
    seqs = [list(r["prompt"]) + r["generated"][:-1] for r in records]
    steps = max(len(x) for x in seqs)
    runs = [(cfg, params)]
    if atol is None:
        runs.append((dataclasses.replace(cfg, dtype=torch.float32),
                     tree_map(lambda t: t.float(), params)))
    caches = [TF.init_cache(c, len(seqs), steps + 1, dev) for c, _ in runs]
    pairs = []   # (request, step, kernel path's logits, reference, fp32 run)
    for t in range(steps):
        toks = torch.tensor([x[t] if t < len(x) else 0 for x in seqs],
                            device=dev)
        lengths = torch.full((len(seqs),), t, device=dev)
        outs = [TF.decode_step(p, c, toks, cache, lengths)[0][:, :cfg.vocab]
                for (c, p), cache in zip(runs, caches)]
        for i, r in enumerate(records):
            j = t - (len(r["prompt"]) - 1)
            if 0 <= j < len(r["logits"]):
                pairs.append((i, j, r["logits"][j][:cfg.vocab],
                              *(o[i] for o in outs)))
    out = {}
    if atol is None:
        floor = max(float((ref - ref32).abs().max())
                    for _, _, _, ref, ref32 in pairs)
        atol = 2 * floor
        out = {"bf16_reference_vs_fp32_max_abs": floor,
               "kernel_path_vs_fp32_max_abs": max(
                   float((got - ref32).abs().max())
                   for _, _, got, _, ref32 in pairs)}
    errs = [float((got - ref).abs().max()) for _, _, got, ref, *_ in pairs]
    margin_ok, flips = 0, 0
    for (i, j, got, ref, *_), err in zip(pairs, errs):
        r = records[i]
        if not err <= atol:
            raise AssertionError(f"request {i}, step {j}: logits differ from "
                                 f"the dense reference by {err} (atol "
                                 f"{atol}; largest {max(errs)}, median "
                                 f"{float(np.median(errs))} over "
                                 f"{len(errs)} steps; {out})")
        top2 = torch.topk(ref, 2).values
        if float(top2[0] - top2[1]) > atol:
            margin_ok += 1
            if int(torch.argmax(ref)) != r["generated"][j]:
                raise AssertionError(f"request {i}, step {j}: token "
                                     f"{r['generated'][j]} where the "
                                     f"reference's clear winner is "
                                     f"{int(torch.argmax(ref))}")
        elif int(torch.argmax(ref)) != r["generated"][j]:
            flips += 1
    refs = torch.stack([ref for _, _, _, ref, *_ in pairs])
    return {"logit_max_abs_err": max(errs),
            "logit_median_abs_err": float(np.median(errs)),
            "steps_checked": len(pairs), "steps_with_clear_winner": margin_ok,
            "near_tie_flips": flips, "atol": atol, **out,
            "ref_logit_std": float(refs.std()),
            "ref_logit_max_abs": float(refs.abs().max())}


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def phase_serve(card, dev, hold, arch="yi-6b", max_seq=256, long_prompt=0,
                name="serve", atol=SERVE_LOGIT_ATOL):
    """``arch`` at full width through ServeEngine, as launch/serve.py
    drives it (plus, with ``long_prompt``, one prompt of that many tokens,
    admitted first), then one evict_user and one flush. ``hold`` keeps
    the engine for the profile phase and the launch counts the path must
    show."""
    cfg = configs.get_config(arch)
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)   # earlier paths' engines
    t0 = time.perf_counter()
    params = TF.init_model(torch.Generator(device=dev).manual_seed(SEED),
                           cfg, dev)
    sync()
    init_s = time.perf_counter() - t0
    eng = ServeEngine(cfg, params, max_slots=4, max_seq=max_seq,
                      block=SERVE_BLOCK, device=dev)
    log = KvLog(eng.daemon)
    graph = eng._step   # the decode round's ServeGraph
    host = {}
    guard(eng, "_insert_blocks", host)
    guard(eng, "_step", host)   # staging, prime, capture and replays

    pending = serve_prompts(cfg)
    if long_prompt:
        pending.append(np.random.default_rng(SEED + 3).integers(
            0, cfg.vocab, size=long_prompt).astype(np.int32))
    records, by_slot = [], {}
    prefill_ms, round_ms, finish_ms, freed = [], [], [], []
    done, tokens_out = 0, 0
    t_serve = time.perf_counter()
    total = len(pending)
    while done < total:
        while pending and len(eng.requests) < eng.max_slots:
            prompt = pending.pop()
            t0 = time.perf_counter()
            slot = eng.add_request(prompt, user_id=done + len(pending))
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
            rec = {"prompt": prompt, "logits": [eng.prefill_logits.clone()]}
            records.append(rec)
            by_slot[slot] = rec
        t0 = time.perf_counter()
        eng.decode_round()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        tokens_out += len(eng.requests)
        for s in eng.requests:
            by_slot[s]["logits"].append(eng.logits[s].clone())
        for s in [s for s, r in eng.requests.items()
                  if len(r.generated) >= 16]:
            by_slot[s]["generated"] = list(eng.requests[s].generated)
            n_tok = int(eng.lengths[s])
            t0 = time.perf_counter()
            n = eng.finish_request(s)
            finish_ms.append((time.perf_counter() - t0) * 1e3)
            if n != -(-n_tok // SERVE_BLOCK):
                raise AssertionError(f"finish_request freed {n} blocks for "
                                     f"{n_tok} tokens")
            freed.append(n)
            done += 1
    serve_s = time.perf_counter() - t_serve
    if eng.live_blocks() != 0:
        raise AssertionError(f"{eng.live_blocks()} blocks live after every "
                             f"request finished")
    for r in records:  # the prefill's logits, then one per round
        if len(r["logits"]) != len(r["generated"]):
            raise AssertionError("a request's logits and tokens disagree")
    # one session eviction and one flush over fresh requests
    extra = serve_prompts(cfg, 3, seed=SEED + 1)
    for i, prompt in enumerate(extra):
        eng.add_request(prompt, user_id=100 + (i % 2))
    for _ in range(3):
        eng.decode_round()
    warm, warm_rounds = warm_round_calls(eng)
    extra_rounds = 3 + warm_rounds
    evicted = eng.evict_user(100)
    flushed = eng.flush()
    if eng.live_blocks() != 0 or eng.requests:
        raise AssertionError("flush left blocks or requests behind")
    replay = log.replay(eng.cap)
    if replay["cpu_live_rows"] != 0:
        raise AssertionError("the CPU replay kept live rows")
    peak_gb = (torch.cuda.max_memory_allocated(dev) - resident) / 1e9
    tf = teacher_forced(cfg, params, dev, records, atol)
    n_rounds = len(round_ms)
    prefills, rounds = len(records) + len(extra), n_rounds + extra_rounds
    attn = TF.n_attn_layers(cfg) + cfg.n_shared_applications()
    # paged attention: every replayed round, and the capture's prime round
    hold.update(eng=eng, cfg=cfg, want={
        "flash_attention": attn * prefills,
        "paged_attention": attn * (rounds + 1),
        "mamba2_scan": len(cfg.ssm_layer_ids) * prefills})
    lens = [len(r["prompt"]) for r in records]
    emit({"phase": name, "card": card, "arch": cfg.name,
          "params_b": cfg.param_count() / 1e9,
          "dtype": str(cfg.dtype).split(".")[-1],
          "init_s": round(init_s, 3), "requests": len(records),
          "prompt_lens": lens,
          "prefill_ms": [round(x, 3) for x in prefill_ms],
          "prefill_ms_mean": float(np.mean(prefill_ms)),
          "decode_rounds": n_rounds,
          "decode_ms_mean": float(np.mean(round_ms)),
          "decode_ms_p50": p50(round_ms),
          "decode_ms_first_round": round_ms[0],
          "tokens": tokens_out, "serve_s": serve_s,
          "tokens_per_s": tokens_out / serve_s,
          "host_ms_in_insert_blocks": host.get("_insert_blocks", 0) * 1e3,
          "host_ms_in_step_dispatch": host.get("_step", 0) * 1e3,
          "graph_capture_ms": graph.capture_ms,
          "graph_pool_bytes": graph_pool_bytes(graph.pool),
          "graph_launches_per_round": graph.launches,
          "warm_round_launch_calls": warm,
          "finish_request_ms": [round(x, 3) for x in finish_ms],
          "freed_blocks": freed, "evict_user_blocks": evicted,
          "flush_blocks": flushed, "kv_replay": replay,
          "peak_memory_gb": peak_gb, "resident_before_gb": resident / 1e9,
          "teacher_forced": tf})


# ------------------------------------------------------------ graphs

# Table 2's single statements with their bound values for round i
GRAPH_STMTS = (
    ("page_delete", "DELETE FROM cache WHERE page_id = ?",
     lambda p, u, i: (p[2 + i],)),
    ("user_delete", "DELETE FROM cache WHERE user_id = ?",
     lambda p, u, i: (u[1 + 3 * i],)),
    ("page_select", "SELECT * FROM cache WHERE page_id = ? LIMIT 64",
     lambda p, u, i: (p[130 + i],)),
    ("two_term_select", "SELECT page_id, data FROM cache WHERE "
     "user_id = ? AND page_id < ?", lambda p, u, i: (u[200 + i], 15_000)),
    ("update", "UPDATE cache SET data = data + 1 WHERE page_id = ?",
     lambda p, u, i: (p[300 + i],)),
    ("count", "SELECT COUNT(*) FROM cache WHERE user_id = ?",
     lambda p, u, i: (u[400 + i],)),
)


def executors(db, table):
    return json.loads(db.execute(f"SHOW STATS {table}").value)["executors"]


def graph_pool_bytes(pool) -> int:
    """Device bytes held in one CUDA-graph memory pool."""
    if pool is None:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory._snapshot()[
        "segments"] if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def pool_bytes(db, table) -> int:
    """Device bytes held in the table's CUDA-graph memory pool."""
    return graph_pool_bytes(db.tables[table].execs._pool)


def launch_calls(fn, n):
    """Host launch calls (kernels, graphs, copies) of ``n`` statements."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    calls = dict.fromkeys(LAUNCH_CALLS, 0)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA and e.name in calls:
            calls[e.name] += 1
    return {k: v / n for k, v in calls.items()}


def round_calls(eng) -> tuple[dict, dict]:
    """One decode round under the profiler: the host's launch calls made
    inside the round, and the copies on the card by direction. A small
    kernel and a sync open the window first: the card's record of the
    first activity in a fresh window is sometimes lost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")
        sync()
        with record_function("decode_round"):
            eng.decode_round()
        sync()
    events = prof.events()
    span = next(e for e in events if e.name == "decode_round"
                and e.device_type != DeviceType.CUDA).time_range
    calls = dict.fromkeys(LAUNCH_CALLS, 0)
    copies = {"HtoD": 0, "DtoH": 0, "DtoD": 0}
    for e in events:
        if e.device_type != DeviceType.CUDA:
            if (e.name in calls
                    and span.start <= e.time_range.start <= span.end):
                calls[e.name] += 1
        elif "Memcpy" in e.name:
            for k in copies:
                copies[k] += k in e.name
    return calls, copies


def warm_round_calls(eng, tries=3) -> tuple[dict, int]:
    """A decode round with no block boundary must be one graph launch,
    one copy in and one copy of the next tokens out, and no kernel
    launch. The host's calls must be exact in every profiled round; a
    round whose two copies did not both show on the card (a lost record)
    is profiled again, up to ``tries`` times. Returns (what the round
    made, rounds run)."""
    want = dict.fromkeys(LAUNCH_CALLS, 0) | {"cudaGraphLaunch": 1,
                                             "cudaMemcpyAsync": 2}
    rounds = 0
    for attempt in range(1, tries + 1):
        while any(eng.lengths[s] % SERVE_BLOCK == 0 for s in eng.requests):
            eng.decode_round()
            rounds += 1
        calls, copies = round_calls(eng)
        rounds += 1
        if calls != want:
            raise AssertionError(f"a warm round made {calls}; expected "
                                 f"{want}")
        if copies["HtoD"] == 1 and copies["DtoH"] == 1:
            return {**calls, "device_copies": copies,
                    "profiled_rounds": attempt}, rounds
    raise AssertionError(f"no profiled warm round showed one HtoD and one "
                         f"DtoH copy in {tries} tries (last: {copies})")


def phase_graphs(card):
    """Pre-planned statements (core/execache.py): the Table 2 indexed
    table and Fig. 1's read, warmed at CREATE and by WARMUP, on the card
    and on a CPU daemon. Every warm statement replays a captured CUDA
    graph with no miss and no sync; a cold shape captures on its miss with
    no sync; a warm statement is one graph launch; WARMUP of new shapes in
    another thread while this one replays, and a graph captured before an
    executemany that grows the compaction's scratch, still equal the CPU
    daemon, and so does REINDEX (an epoch bump) and what follows it.
    Reports each statement's capture time and wall p50, and the graphs'
    pool bytes."""
    pages, users, payload = table2_data()
    p, u = pages.tolist(), users.tolist()
    pr = Pair(warmup=True)
    pr.run("execute", "CREATE TABLE cache (page_id INT, user_id INT, data "
                      "BIGINT, INDEX(page_id), INDEX(user_id)) "
                      "CAPACITY 131072 MAX_SELECT 64")
    for db in (pr.gpu, pr.cpu):
        db.drain_warmup()
    canonical = executors(pr.gpu, "cache")
    if canonical["cached"] != 5 or canonical["misses"] != 0:
        raise AssertionError(f"CREATE-time warm-up: {canonical}")
    pr.run("executemany",
           "INSERT INTO cache (page_id, user_id, data) VALUES (?, ?, ?)",
           list(zip(p, u, payload.tolist())))
    capture_ms = {}
    for label, sql, _ in GRAPH_STMTS:
        ms0 = executors(pr.gpu, "cache")["compile_ms_total"]
        counts = [db.execute(f"WARMUP cache LIKE '{sql}'").count
                  for db in (pr.gpu, pr.cpu)]
        if counts[0] != counts[1]:
            raise AssertionError(f"WARMUP counts differ on {sql!r}: {counts}")
        capture_ms[label] = executors(pr.gpu, "cache")["compile_ms_total"] \
            - ms0
    st0 = executors(pr.gpu, "cache")
    for i in range(20):
        for label, sql, args in GRAPH_STMTS:
            pr.run("execute", sql, args(p, u, i), label=label)
    st1 = executors(pr.gpu, "cache")
    if st1["misses"] != st0["misses"]:
        raise AssertionError(f"warmed shapes missed: {st0} -> {st1}")
    # a cold shape: captured on its miss, no sync (Pair.run checks)
    pr.run("execute", "SELECT data FROM cache WHERE page_id = ? AND "
           "user_id = ?", (p[500], u[500]))
    if executors(pr.gpu, "cache")["misses"] != st1["misses"] + 1:
        raise AssertionError("the cold shape did not miss once")

    # a warm statement is one graph launch (and its two copies); the CPU
    # daemon then takes the same statements, to stay in step
    round_ = [(sql, args(p, u, 20 + i)) for i in range(10)
              for _, sql, args in GRAPH_STMTS[:4]]
    calls = launch_calls(lambda: [pr.gpu.execute(*x) for x in round_],
                         len(round_))
    if calls["cudaGraphLaunch"] != 1 or any(
            calls[k] for k in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                               "cuLaunchKernel")):
        raise AssertionError(f"a warm statement is not one graph: {calls}")
    for x in round_:
        pr.cpu.execute(*x)

    # WARMUP of new shapes in another thread while this one replays
    import threading
    new = ("SELECT data FROM cache WHERE user_id = ? AND data > ?",
           "SELECT MAX(data) FROM cache WHERE page_id < ?",
           "DELETE FROM cache WHERE data = ?",
           "UPDATE cache SET data = data - 1 WHERE user_id = ?")
    errors = []

    def warm_new():
        try:
            for sql in new:
                pr.gpu.execute(f"WARMUP cache LIKE '{sql}'")
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    th = threading.Thread(target=warm_new)
    th.start()
    for i in range(100):
        pr.run("execute", "SELECT * FROM cache WHERE page_id = ? LIMIT 64",
               (p[600 + i],))
        pr.run("execute", "UPDATE cache SET data = data + 1 WHERE "
               "page_id = ?", (p[700 + i],))
    th.join()
    if errors:
        raise errors[0]
    st2 = executors(pr.gpu, "cache")
    for sql, args in zip(new, ((u[9], 500), (2_000,), (77,), (u[10],))):
        pr.run("execute", sql, args)
    if executors(pr.gpu, "cache")["misses"] != st2["misses"]:
        raise AssertionError("shapes warmed in the background missed")

    # a graph captured before a wider executemany grows the scratch
    sql = "SELECT * FROM cache WHERE page_id = ? LIMIT 64"
    pr.run("executemany", sql, [(x,) for x in p[800:1056]])
    for x in p[1100:1140]:
        pr.run("execute", sql, (x,))

    st = executors(pr.gpu, "cache")
    pool_t2 = pool_bytes(pr.gpu, "cache")
    # REINDEX bumps the epoch: every plan goes, the next statements
    # capture again against the rebuilt indexes. (REINDEX itself reads
    # the residual overflow back, an admin statement's sync.)
    epoch = st["epoch"]
    got, want = (snap(db.execute("REINDEX cache")) for db in (pr.gpu, pr.cpu))
    if got != want or executors(pr.gpu, "cache")["epoch"] != epoch + 1:
        raise AssertionError(f"REINDEX: {got} vs {want}, or no epoch bump")
    for i in range(10):
        pr.run("execute", sql, (p[1200 + i],))
        pr.run("execute", "DELETE FROM cache WHERE user_id = ?",
               (u[1300 + i],))
    for k in ("valid", "clock"):
        if not torch.equal(pr.gpu.table_state("cache")[k].cpu(),
                           pr.cpu.table_state("cache")[k]):
            raise AssertionError(f"graphs: {k} differs from the CPU daemon")
    for col, g in pr.gpu.table_state("cache")["cols"].items():
        if not torch.equal(g.cpu(), pr.cpu.table_state("cache")["cols"][col]):
            raise AssertionError(f"graphs: column {col} differs")

    # Fig. 1's read, warmed
    rng = np.random.default_rng(SEED)
    sizes = [16, 64, 256, 1024, 4096]
    idx = np.minimum(rng.geometric(0.5, size=512) - 1, len(sizes) - 1)
    values = {f"k{i}": "x" * sizes[j] for i, j in enumerate(idx)}
    fig = Pair(warmup=True)
    fig.run("execute", "CREATE TABLE kv (k TEXT, v TEXT) CAPACITY 1024 "
                       "MAX_SELECT 8")
    for db in (fig.gpu, fig.cpu):
        db.drain_warmup()
    fig.run("executemany", "INSERT INTO kv (k, v) VALUES (?, ?)",
            list(values.items()))
    read = "SELECT v FROM kv WHERE k = ? LIMIT 1"
    for db in (fig.gpu, fig.cpu):
        db.execute(f"WARMUP kv LIKE '{read}'")
    keys = [f"k{int(i)}" for i in rng.integers(0, 512, 512)]
    fig.run("executemany", read, [(k,) for k in keys[:32]])
    f0 = executors(fig.gpu, "kv")
    for k in keys:
        r = fig.run("execute", read, (k,), label="single_read")
        if r["rows"] != [{"v": values[k]}]:
            raise AssertionError(f"wrong value for {k}")
    for i in range(0, 512, 32):
        fig.run("executemany", read, [(k,) for k in keys[i:i + 32]],
                label="batch_read")
    if executors(fig.gpu, "kv")["misses"] != f0["misses"]:
        raise AssertionError("Fig. 1's warmed reads missed")
    emit({"phase": "graphs", "card": card,
          "executors": st, "executors_fig1": executors(fig.gpu, "kv"),
          "executors_after_reindex": executors(pr.gpu, "cache"),
          "capture_ms": {k: round(v, 3) for k, v in capture_ms.items()},
          "capture_ms_mean": round(st["compile_ms_total"]
                                   / max(st["compiles"], 1), 3),
          "pool_bytes_table2": pool_t2,
          "pool_bytes_fig1": pool_bytes(fig.gpu, "kv"),
          "launch_calls_per_warm_stmt": calls,
          "wall_p50_us": {k: round(p50(v), 1) for k, v in pr.lat.items()},
          "fig1_single_read_p50_us": round(p50(fig.lat["single_read"]), 1),
          "fig1_batched_read_p50_us_per_read":
              round(p50(fig.lat["batch_read"]) / 32, 2)})


# ------------------------------------------------------------- shards

SHARD_DDL = ("CREATE TABLE sh (page_id INT, user_id INT, data BIGINT{extra}) "
             "CAPACITY 131072 MAX_SELECT 64 SHARDS 8 PARTITION BY user_id")
# (label, sql, args(pages, users, i), pruned): Table 2's statements on the
# sharded table; per-user statements prune to one lane, per-page ones fan
# out over every shard
SHARD_STMTS = (
    ("user_select", "SELECT * FROM sh WHERE user_id = ? LIMIT 64",
     lambda p, u, i: (u[20 + i],), True),
    ("user_delete", "DELETE FROM sh WHERE user_id = ? AND page_id < ?",
     lambda p, u, i: (u[40 + i], 10_000), True),
    ("page_select", "SELECT * FROM sh WHERE page_id = ? LIMIT 64",
     lambda p, u, i: (p[130 + i],), False),
    ("page_delete", "DELETE FROM sh WHERE page_id = ?",
     lambda p, u, i: (p[2 + i],), False),
    ("page_count", "SELECT COUNT(*) FROM sh WHERE page_id = ?",
     lambda p, u, i: (p[600 + i],), False),
)


def admin_pair(pr, sql):
    """An admin statement (it reads its result back: a sync by design) on
    both daemons; the results must agree."""
    got, want = (snap(db.execute(sql)) for db in (pr.gpu, pr.cpu))
    if got != want:
        raise AssertionError(f"{sql!r}: card {got} vs CPU {want}")
    return got


def stats_pair(pr, table):
    """SHOW STATS on both daemons: equal but for the executors block and
    the device name."""
    out = []
    for db in (pr.gpu, pr.cpu):
        info = json.loads(db.execute(f"SHOW STATS {table}").value)
        info.pop("executors"), info.pop("device")
        out.append(info)
    if out[0] != out[1]:
        raise AssertionError(f"SHOW STATS {table}: {out[0]} vs {out[1]}")
    return out[0]


def same_state(pr, table, what):
    g = pr.gpu.table_state(table)
    c = pr.cpu.table_state(table)
    for k in ("valid", "clock", "ops"):
        if not torch.equal(g[k].cpu(), c[k]):
            raise AssertionError(f"{what}: {k} differs")
    for col in g["cols"]:
        if not torch.equal(g["cols"][col].cpu(), c["cols"][col]):
            raise AssertionError(f"{what}: column {col} differs")
    for ix in g["indexes"]:
        for k in ("rid", "key", "stale"):
            if not torch.equal(g["indexes"][ix][k].cpu(),
                               c["indexes"][ix][k]):
                raise AssertionError(f"{what}: index {ix} {k} differs")


def shard_statements(pr, p, u, base):
    """Every SHARD_STMTS statement a few times (labels for the p50s)."""
    for i in range(8):
        for label, sql, args, _ in SHARD_STMTS:
            pr.run("execute", sql, args(p, u, base + i), label=label)
    pr.run("executemany", "SELECT * FROM sh WHERE user_id = ? LIMIT 64",
           [(x,) for x in u[300:316]], label="user_select_x16")
    pr.run("executemany", "DELETE FROM sh WHERE page_id = ?",
           [(x,) for x in p[700:764]], label="page_delete_x64")


def scheduler_writes(pr, p, u):
    """Four threads submit pruned writes (per-user UPDATE / DELETE) to a
    BatchScheduler over the card daemon, each on its own users; the CPU
    daemon then takes the same statements one by one. The writes commute,
    so every count and the final state must agree. Dispatch runs with
    sync debugging set to "error"."""
    import asyncio
    import threading
    from repro_torch.core.scheduler import BatchScheduler
    loop = asyncio.new_event_loop()
    th_loop = threading.Thread(target=loop.run_forever, daemon=True)
    th_loop.start()
    sched = BatchScheduler(pr.gpu, concurrency=True)
    asyncio.run_coroutine_threadsafe(sched.start(), loop).result(60)
    # distinct users: each thread's writes touch users no other thread does
    users = list(dict.fromkeys(u[500:]))[:48]
    jobs = [[(sql, args) for i in range(t, 48, 4)
             for sql, args in (
                 ("UPDATE sh SET data = data + 1 WHERE user_id = ?",
                  (users[i],)),
                 ("DELETE FROM sh WHERE user_id = ? AND page_id > ?",
                  (users[i], 25_000)))] for t in range(4)]
    results: dict = {}

    async def one(sql, args):
        return await sched.submit(sql, args)

    def worker(t):
        results[t] = [asyncio.run_coroutine_threadsafe(one(*job), loop)
                      .result(120) for job in jobs[t]]

    torch.cuda.set_sync_debug_mode("error")
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    asyncio.run_coroutine_threadsafe(sched.stop(), loop).result(60)
    stats = dict(sched.stats)
    loop.call_soon_threadsafe(loop.stop)
    th_loop.join(60)
    if len(results) != 4:
        raise AssertionError("a scheduler thread did not finish")
    for t in range(4):
        for (sql, args), r in zip(jobs[t], results[t]):
            want = pr.cpu.execute(sql, args).count
            if r.count != want:
                raise AssertionError(f"scheduled {sql} {args}: {r.count} vs "
                                     f"{want}")
    pr.gpu.drain()
    same_state(pr, "sh", "after the scheduler's writes")
    if not stats.get("lane_dispatches"):
        raise AssertionError(f"no lane lock was taken: {stats}")
    return {k: stats[k] for k in ("lane_dispatches", "lane_splits")
            if k in stats}


def fanout_launches(pr, sql, args):
    """Kernel launches of one warm replay of a fan-out statement (its
    graph's record): the scan and the probe each at most once."""
    pr.run("execute", sql, args)   # planned (captured) by now
    before = dict(_build.launches)   # the path's counts keep running
    pr.gpu.execute(sql, args)
    pr.gpu.drain()
    got = {k: v - before[k] for k, v in _build.launches.items()
           if v != before[k]}
    pr.cpu.execute(sql, args)
    if got.get("relscan_scan", 0) > 1 or got.get("hash_probe", 0) > 1 or \
            got.get("hash_build", 0) > 1:
        raise AssertionError(f"a fan-out of 8 shards launched {got}")
    return got


def phase_shards(card):
    """Table 2 (100,000 records over 30,000 pages and 1,000 users) in
    ``CAPACITY 131072 SHARDS 8 PARTITION BY user_id`` (16,384 rows a
    shard), with and without INDEX(page_id), on the card daemon and on a
    CPU daemon: the bulk load (the device split), per-user statements
    (one lane each) and per-page statements (fan-out over 8 shards),
    EXPIRE, REINDEX, SHOW STATS's skew, RESHARD 4 and the same statements
    again, a WARMUP of a pruned and a fan-out shape and warm replays (a
    warm pruned statement is one graph launch and no kernel launch), four
    threads of pruned writes through the BatchScheduler, and FLUSH. Every
    count, row, row id and value equals the CPU daemon's, every dispatch
    runs with sync debugging set to "error", and a fan-out's scan, probe
    and build each launch once per call. Reports the graph pool's bytes
    and wall p50s of pruned and fan-out statements."""
    pages, users, payload = table2_data()
    p, u = pages.tolist(), users.tolist()
    report = {"phase": "shards", "card": card}
    for variant, extra in (("plain", ""), ("indexed", ", INDEX(page_id)")):
        pr = Pair(warmup=False)
        pr.run("execute", SHARD_DDL.format(extra=extra))
        t0 = time.perf_counter()
        pr.run("executemany",
               "INSERT INTO sh (page_id, user_id, data) VALUES (?, ?, ?)",
               list(zip(p, u, payload.tolist())), label="bulk_load")
        load_s = time.perf_counter() - t0
        skew = stats_pair(pr, "sh")["per_shard"]
        shard_statements(pr, p, u, 0)
        launches = {"page_select": fanout_launches(
            pr, SHARD_STMTS[2][1], (p[140],)),
            "page_delete": fanout_launches(pr, SHARD_STMTS[3][1], (p[12],)),
            "page_count": fanout_launches(pr, SHARD_STMTS[4][1], (p[610],))}
        admin_pair(pr, "EXPIRE sh")
        admin_pair(pr, "REINDEX sh")
        same_state(pr, "sh", f"{variant} before RESHARD")
        admin_pair(pr, "ALTER TABLE sh RESHARD 4")
        skew4 = stats_pair(pr, "sh")["per_shard"]
        same_state(pr, "sh", f"{variant} after RESHARD 4")
        shard_statements(pr, p, u, 20)
        # WARMUP of two new shapes: the pruned one plans every lane (4
        # after the RESHARD), the fan-out one plan; then warm replays
        warm_stmts = (("SELECT data FROM sh WHERE user_id = ?",
                       lambda i: (u[100 + i],), 4),
                      ("SELECT user_id FROM sh WHERE page_id = ?",
                       lambda i: (p[900 + i],), 1))
        for sql, _, want in warm_stmts:
            counts = [db.execute(f"WARMUP sh LIKE '{sql}'").count
                      for db in (pr.gpu, pr.cpu)]
            if counts != [want, want]:
                raise AssertionError(f"WARMUP {sql}: {counts} plans, "
                                     f"expected {want}")
        st0 = executors(pr.gpu, "sh")
        for i in range(20):
            for label, (sql, args, _) in zip(("warm_pruned", "warm_fanout"),
                                             warm_stmts):
                pr.run("execute", sql, args(i), label=label)
        if executors(pr.gpu, "sh")["misses"] != st0["misses"]:
            raise AssertionError("warmed shapes missed")
        rnd = [(warm_stmts[0][0], (u[200 + i],)) for i in range(20)]
        calls = launch_calls(lambda: [pr.gpu.execute(*x) for x in rnd],
                             len(rnd))
        if calls["cudaGraphLaunch"] != 1 or any(
                calls[k] for k in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                   "cuLaunchKernel")):
            raise AssertionError(f"a warm pruned statement: {calls}")
        for x in rnd:
            pr.cpu.execute(*x)
        sched = scheduler_writes(pr, p, u)
        n_flush = admin_pair(pr, "FLUSH sh")["count"]
        same_state(pr, "sh", f"{variant} at the end")
        report[variant] = {
            "load_s": round(load_s, 3), "skew_live_rows_8": [
                x["live_rows"] for x in skew],
            "skew_live_rows_4": [x["live_rows"] for x in skew4],
            "fanout_launches_per_call": launches,
            "executors": executors(pr.gpu, "sh"),
            "pool_bytes": pool_bytes(pr.gpu, "sh"),
            "launch_calls_per_warm_pruned_stmt": calls,
            "scheduler": sched, "flushed_rows": n_flush,
            "wall_p50_us": {k: round(p50(v), 1) for k, v in pr.lat.items()}}
    emit(report)


# ------------------------------------------- snapshots and the cluster

SNAP_DIR = ROOT / "build" / "chip_smoke_snapshots"
SNAP_COLS = "(page_id INT, user_id INT, data BIGINT{extra})"


def snap_statements(pr, table, p, u, base):
    """SHARD_STMTS on ``table``, twice each, and checked like every
    statement (equal to the CPU daemon, no sync on the card)."""
    for i in range(2):
        for label, sql, args, _ in SHARD_STMTS:
            pr.run("execute", sql.replace(" sh ", f" {table} "),
                   args(p, u, base + i), label=label)


def timed(pr, label, sqls):
    """One admin statement a daemon (``sqls``: the card's, the CPU's: they
    differ only in a directory); the card's wall time (drained, its
    result read) goes to ``pr.lat[label]`` in ms; the counts must agree.
    Returns the card's result."""
    t0 = time.perf_counter()
    got = snap(pr.gpu.execute(sqls[0]))
    pr.gpu.drain()
    pr.lat.setdefault(label, []).append((time.perf_counter() - t0) * 1e3)
    want = snap(pr.cpu.execute(sqls[1]))
    if got["count"] != want["count"]:
        raise AssertionError(f"{sqls[0]!r}: card {got} vs CPU {want}")
    return got


def checkpoint_pair(pr, table, name, reps=1):
    """CHECKPOINT ``table`` on both daemons, each into its own directory;
    the two must hold the same meta.json and the same arrays (the card's
    one copy to the host is the statement's sanctioned sync)."""
    dirs = [SNAP_DIR / f"{name}-{tag}" for tag in ("card", "cpu")]
    for _ in range(reps):
        got = timed(pr, "checkpoint_ms", [f"CHECKPOINT {table} TO '{d}'"
                                          for d in dirs])
    metas = [json.loads((d / "step_0" / "meta.json").read_text())
             for d in dirs]
    if metas[0] != metas[1]:
        raise AssertionError(f"{name}: checkpoint metas differ")
    for leaf in metas[0]["names"].values():
        a, b = (np.load(d / "step_0" / leaf) for d in dirs)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"{name}: checkpoint leaf {leaf} differs")
    return dirs, got["count"]


def phase_snapshot(card):
    """Table 2 in SHARDS 8 PARTITION BY user_id (phase ``shards``'s
    deployment), with and without INDEX(page_id), on the card daemon and
    a CPU daemon: the bulk load and the per-user / per-page statements,
    CHECKPOINT (the card's and the CPU's files must be the same), RESTORE
    into fresh tables of 8, 4 and 1 shards, a CHECKPOINT of the 1-shard
    table restored into 8 shards again, and RETAIN SLOTS of a random half
    of 64 on the 8-shard table (its graph's first run and replays; then
    the statements again on plans captured before it). Every count and
    the statements on every restored table equal the CPU daemon's (the
    statements under sync debugging "error"; the admin statements read
    their results back and are exempt, as RESHARD is), and each table's
    whole state too. Reports the card's wall ms of CHECKPOINT, RESTORE
    and RETAIN (p50 of several)."""
    import shutil
    shutil.rmtree(SNAP_DIR, ignore_errors=True)
    pages, users, payload = table2_data()
    p, u = pages.tolist(), users.tolist()
    rng = np.random.default_rng(SEED)
    report = {"phase": "snapshot", "card": card}
    for variant, extra in (("plain", ""), ("indexed", ", INDEX(page_id)")):
        pr = Pair(warmup=False)
        cols = SNAP_COLS.format(extra=extra)
        pr.run("execute", SHARD_DDL.format(extra=extra))
        pr.run("executemany",
               "INSERT INTO sh (page_id, user_id, data) VALUES (?, ?, ?)",
               list(zip(p, u, payload.tolist())))
        snap_statements(pr, "sh", p, u, 0)
        dirs, live = checkpoint_pair(pr, "sh", f"{variant}-sh", reps=3)
        restored = {}
        for n in (8, 4, 1):
            pr.run("execute", f"CREATE TABLE r{n} {cols} CAPACITY 131072 "
                              f"MAX_SELECT 64 SHARDS {n} PARTITION BY user_id")
            for _ in range(3):
                got = timed(pr, f"restore_{n}_ms",
                            [f"RESTORE r{n} FROM '{d}'" for d in dirs])
            restored[n] = got["count"]
            same_state(pr, f"r{n}", f"{variant}: RESTORE into {n} shards")
            snap_statements(pr, f"r{n}", p, u, 10)
        dirs1, _ = checkpoint_pair(pr, "r1", f"{variant}-r1")
        pr.run("execute", f"CREATE TABLE b8 {cols} CAPACITY 131072 "
                          f"MAX_SELECT 64 SHARDS 8 PARTITION BY user_id")
        for _ in range(3):
            got = timed(pr, "restore_1_to_8_ms",
                        [f"RESTORE b8 FROM '{d}'" for d in dirs1])
        restored["1_to_8"] = got["count"]
        same_state(pr, "b8", f"{variant}: RESTORE 1 -> 8 shards")
        snap_statements(pr, "b8", p, u, 20)
        slots = sorted(rng.choice(64, 32, replace=False).tolist())
        sql = (f"ALTER TABLE r8 RETAIN SLOTS {','.join(map(str, slots))} "
               f"OF 64")
        dropped = [timed(pr, "retain_ms", [sql, sql])["count"]
                   for _ in range(5)]
        if dropped[0] <= 0 or any(dropped[1:]):
            raise AssertionError(f"RETAIN dropped {dropped}")
        same_state(pr, "r8", f"{variant}: RETAIN")
        snap_statements(pr, "r8", p, u, 10)   # plans captured before RETAIN
        same_state(pr, "r8", f"{variant}: statements after RETAIN")
        lat = pr.lat
        report[variant] = {
            "live_rows": live, "restored_rows": restored,
            "retain_dropped": dropped[0],
            "checkpoint_ms_p50": round(p50(lat["checkpoint_ms"][:3]), 3),
            **{f"{k}_p50": round(p50(lat[k]), 3) for k in (
                "restore_8_ms", "restore_4_ms", "restore_1_ms",
                "restore_1_to_8_ms")},
            "retain_first_ms": round(lat["retain_ms"][0], 3),
            "retain_replay_ms_p50": round(p50(lat["retain_ms"][1:]), 3)}
    emit(report)


CLUSTER_DDL = ("CREATE TABLE c (id INT, score FLOAT, INDEX (id)) "
               "CAPACITY 8192 MAX_SELECT 4096 SHARDS 2 PARTITION BY id "
               "REPLICAS 2")    # benchmarks/cluster_bench.py's deployment
CLUSTER_ROWS = 4096             # half the capacity: a bootstrap moves data


def cluster_result(res):
    """A cluster result without what ring placement decides (fan-out rows
    without ORDER BY arrive in node order: sorted here)."""
    if isinstance(res, Exception):
        return ("error", type(res).__name__, str(res)[:200])
    rows = res.get("rows") or []
    return {"count": res["count"], "value": res["value"],
            "rows": sorted(rows, key=lambda r: sorted(r.items()))}


def cluster_reads(ids, rng, n):
    """Pruned and fan-out reads and the aggregates of the cluster stream."""
    out = []
    for _ in range(n):
        k = ids[int(rng.integers(0, len(ids)))]
        x = float(rng.random())
        out += [("SELECT * FROM c WHERE id = ?", (k,)),
                ("SELECT id, score FROM c WHERE score >= ? ORDER BY id "
                 "DESC LIMIT 50", (x,)),
                ("SELECT COUNT(*) FROM c WHERE score < ?", (x,))]
    out += [("SELECT * FROM c WHERE score < ?", (0.25,)),
            ("SELECT COUNT(*) FROM c", ()), ("SELECT SUM(id) FROM c", ()),
            ("SELECT MIN(id) FROM c", ()), ("SELECT MAX(score) FROM c", ()),
            ("SELECT AVG(id) FROM c WHERE score >= ?", (0.5,))]
    return out


def phase_cluster(card):
    """benchmarks/cluster_bench.py's deployment (its CREATE: SHARDS 2,
    REPLICAS 2) over three in-process port daemons on the card, each a
    ThreadedServer of its own SQLCached on cuda:0, behind the port's
    ClusterClient; the same stream goes through a cluster of three CPU
    port daemons and every result must be equal (fan-out rows compared as
    sets: placement follows the ports). 4,096 rows (half the capacity),
    pruned and fan-out reads, the aggregates, pruned and fan-out writes,
    add_node of a fourth daemon (CHECKPOINT / RESTORE / RETAIN SLOTS on
    the card), remove_node of a first one, SHOW CLUSTER."""
    from repro_torch.core.cluster import NSLOTS, ClusterClient
    rng = np.random.default_rng(SEED)
    ids = rng.choice(np.arange(-2**20, 2**20), CLUSTER_ROWS,
                     replace=False).tolist()
    scores = rng.random(CLUSTER_ROWS).tolist()
    fleets = {"card": [], "cpu": []}
    ccs = {}
    try:
        for _ in range(4):
            fleets["card"].append(PR.ThreadedServer(db=D.SQLCached()))
            fleets["cpu"].append(PR.ThreadedServer(
                db=D.SQLCached(device="cpu")))
        names = {k: [f"{s.addr[0]}:{s.addr[1]}" for s in f]
                 for k, f in fleets.items()}
        for k in fleets:
            ccs[k] = ClusterClient(names[k][:3], statement_retries=3,
                                   retry_base=0.01, retry_cap=0.05,
                                   checkpoint_dir=str(SNAP_DIR / f"cl-{k}"))

        def both(stmts, what):
            for sql, args in stmts:
                got = {k: cluster_result(cc.execute(sql, args))
                       for k, cc in ccs.items()}
                if got["card"] != got["cpu"]:
                    raise AssertionError(
                        f"cluster {what}: {sql} {args}: card "
                        f"{str(got['card'])[:300]} vs CPU "
                        f"{str(got['cpu'])[:300]}")

        both([(CLUSTER_DDL, ())], "create")
        t0 = time.perf_counter()
        for k, cc in ccs.items():
            with cc.pipeline() as pl:
                for i, s in zip(ids, scores):
                    pl.execute("INSERT INTO c (id, score) VALUES (?, ?)",
                               (i, s))
            if not all(isinstance(r, dict) and r["count"] == 1
                       for r in pl.results):
                raise AssertionError(f"cluster load ({k}) not acknowledged")
            if k == "card":
                load_s = time.perf_counter() - t0
        both(cluster_reads(ids, rng, 40), "reads")
        both([("UPDATE c SET score = ? WHERE id = ?", (0.5, ids[7])),
              ("UPDATE c SET score = 0.75 WHERE score > ?", (0.98,)),
              ("DELETE FROM c WHERE id = ?", (ids[11],)),
              ("DELETE FROM c WHERE score < ?", (0.01,))], "writes")
        walls = {}
        for what, fn in (("add_node", lambda cc, nm: cc.add_node(nm[3])),
                         ("remove_node",
                          lambda cc, nm: cc.remove_node(nm[0]))):
            reports = {}
            for k, cc in ccs.items():
                t0 = time.perf_counter()
                reports[k] = fn(cc, names[k])
                walls.setdefault(f"{what}_s", {})[k] = round(
                    time.perf_counter() - t0, 3)
            if what == "add_node" and not reports["card"]["c"]["moved_rows"]:
                raise AssertionError(f"add_node moved no rows: {reports}")
            both(cluster_reads(ids, rng, 20), f"reads after {what}")
        shown = {k: cc.execute("SHOW CLUSTER")["value"]
                 for k, cc in ccs.items()}
        for k, v in shown.items():
            if [n["status"] for n in v["nodes"]] != ["up"] * 3 or sum(
                    v["tables"]["c"]["primary_of"].values()) != NSLOTS:
                raise AssertionError(f"SHOW CLUSTER ({k}): {v}")
        count = ccs["card"].execute("SELECT COUNT(*) FROM c")["value"]
    finally:
        for cc in ccs.values():
            cc.close()
        for f in fleets.values():
            for s in f:
                s.stop()
    emit({"phase": "cluster", "card": card, "rows_loaded": CLUSTER_ROWS,
          "rows_at_end": count, "load_s": round(load_s, 3), **walls})


def spawn_card_daemons(n, log_dir, boot_timeout=180.0):
    """``n`` daemon child processes on the card (``python -m
    repro_torch.core.protocol --port 0``, the default device), booted in
    parallel; returns [(process, "host:port")]. A child that exits or
    stays silent before its READY line fails the phase."""
    import os
    import select
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for i in range(n):
        with open(log_dir / f"daemon{i}.err", "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.core.protocol",
                 "--host", "127.0.0.1", "--port", "0"],
                stdout=subprocess.PIPE, stderr=err, env=env, cwd=str(ROOT)))
    out = []
    deadline = time.monotonic() + boot_timeout
    try:
        for i, proc in enumerate(procs):
            fd, buf = proc.stdout.fileno(), b""
            while re.search(rb"SQLCACHED READY [^\n]*\n", buf) is None:
                ready, _, _ = select.select(
                    [fd], [], [], max(0.0, deadline - time.monotonic()))
                if not ready:
                    raise AssertionError(f"daemon {i} did not boot in "
                                         f"{boot_timeout} s")
                chunk = os.read(fd, 4096)
                if not chunk:
                    proc.wait(30)
                    tail = (log_dir / f"daemon{i}.err").read_text()[-2000:]
                    raise AssertionError(f"daemon {i} exited before READY "
                                         f"(code {proc.returncode}): {tail}")
                buf += chunk
            line = next(x for x in buf.decode().splitlines()
                        if x.startswith("SQLCACHED READY"))
            _, _, host, port = line.split()
            out.append((proc, f"{host}:{int(port)}"))
    except BaseException:
        for proc in procs:
            proc.kill()
            proc.wait(30)
        raise
    return out


def read_phase(cc, n, rows):
    """cluster_bench's read loop: n pruned reads, each must find its row;
    wall µs each."""
    lat = []
    for i in range(n):
        t0 = time.perf_counter()
        r = cc.execute("SELECT * FROM c WHERE id = ?", (i % rows,))
        lat.append((time.perf_counter() - t0) * 1e6)
        if not r["rows"]:
            raise AssertionError(f"row {i % rows} unreadable")
    return lat


def pcts(us):
    return {"p50_us": float(np.percentile(us, 50)),
            "p99_us": float(np.percentile(us, 99)), "ops": len(us)}


def phase_cluster_chaos(card):
    """benchmarks/cluster_bench.py's kill window on the card: three daemon
    child processes (each takes its own CUDA context on the card; SHOW
    STATS must name a cuda device), its CREATE, 200 seed rows, WARMUP,
    600 healthy pruned reads, 300 mixed ops (a third of them INSERTs)
    with a SIGKILL of one child a third of the way in, 600 reads after
    the kill, then the audit: every acknowledged write read back from
    every live replica of its slot (zero lost), and remove_node of the
    dead child leaves COUNT(*) equal to the acknowledged writes. The
    launch counters cannot see the children: this phase checks results
    only."""
    import signal
    from repro_torch.core.cluster import ClusterClient
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    if "Exclusive_Process" in mode:
        raise AssertionError("the card is in Exclusive_Process compute "
                             "mode: daemon child processes cannot share it")
    log_dir = SNAP_DIR / "daemons"
    log_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fleet = spawn_card_daemons(3, log_dir)
    boot_s = time.perf_counter() - t0
    cc = None
    seed_rows, n_reads, n_kill = 200, 600, 300
    try:
        cc = ClusterClient([name for _, name in fleet], statement_retries=4,
                           retry_base=0.02, retry_cap=0.2,
                           checkpoint_dir=str(SNAP_DIR / "chaos"))
        devices = [cc._exec_on(name, "SHOW STATS")["value"]["device"]
                   for _, name in fleet]
        if not all(str(d).startswith("cuda") for d in devices):
            raise AssertionError(f"child daemons not on the card: {devices}")
        cc.execute(CLUSTER_DDL)
        with cc.pipeline() as pl:
            for i in range(seed_rows):
                pl.execute("INSERT INTO c (id, score) VALUES (?, ?)",
                           (i, float(i)))
        if not all(isinstance(r, dict) and r["count"] == 1
                   for r in pl.results):
            raise AssertionError("seed rows not acknowledged")
        acked = list(range(seed_rows))
        cc.warmup("c")
        read_phase(cc, 24, seed_rows)
        healthy = read_phase(cc, n_reads, seed_rows)
        victim_proc, victim = fleet[0]
        errors, window, next_id = 0, [], seed_rows
        for op in range(n_kill):
            if op == n_kill // 3:
                victim_proc.send_signal(signal.SIGKILL)
                victim_proc.wait(30)
            t1 = time.perf_counter()
            try:
                if op % 3 == 0:
                    r = cc.execute("INSERT INTO c (id, score) VALUES (?, ?)",
                                   (next_id, 1.0))
                    if r["count"] == 1:
                        acked.append(next_id)
                    next_id += 1
                else:
                    cc.execute("SELECT * FROM c WHERE id = ?",
                               (op % seed_rows,))
            except Exception:  # noqa: BLE001 — an unacknowledged op
                errors += 1
                if op % 3 == 0:
                    next_id += 1
            window.append((time.perf_counter() - t1) * 1e6)
        if victim not in cc._down:
            raise AssertionError("the killed daemon was not marked down")
        post = read_phase(cc, n_reads, seed_rows)
        lost, reads_back = [], 0
        groups = cc._tables["c"].groups
        for i in acked:
            for node in cc._live(groups[cc._slot_of(i)]):
                reads_back += 1
                if not cc._exec_on(node, "SELECT * FROM c WHERE id = ?",
                                   (i,))["rows"]:
                    lost.append((i, node))
        if lost:
            raise AssertionError(f"lost acknowledged writes: {lost[:20]}")
        cc.remove_node(victim)
        count = cc.execute("SELECT COUNT(*) FROM c")["value"]
        if count != len(acked):
            raise AssertionError(f"COUNT(*) {count} after remove_node, "
                                 f"{len(acked)} acknowledged")
    finally:
        if cc is not None:
            cc.close()
        for proc, _ in fleet:
            if proc.poll() is None:
                proc.kill()
            proc.wait(30)
    emit({"phase": "cluster_chaos", "card": card, "daemons": 3,
          "devices": devices, "boot_s": round(boot_s, 3),
          "healthy": pcts(healthy),
          "kill_window": dict(pcts(window), errors=errors,
                              max_us=float(max(window))),
          "post_kill": pcts(post), "acked_writes": len(acked),
          "replica_reads": reads_back, "lost_acked_writes": 0,
          "count_after_remove_node": count})


# ------------------------------------------------------------ profile

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def profile_statements(db, sql, params_list):
    """Per statement: host wall time (drained), CUDA kernels and copies on
    the card, the launch calls the host made for them, their device time
    and the card's idle share of the wall, over the first half of
    ``params_list`` under the profiler; then the p50 of each statement's
    own wall time (dispatch, and the Result's copy back) over the second
    half, unprofiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    db.execute(sql, params_list[0])
    db.drain()
    half = len(params_list) // 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for pr in params_list[:half]:
            _ = db.execute(sql, pr).count
        db.drain()
        wall_us = (time.perf_counter() - t0) * 1e6
    walls = []
    for pr in params_list[half:]:
        t1 = time.perf_counter()
        _ = db.execute(sql, pr).count
        walls.append((time.perf_counter() - t1) * 1e6)
    n = half
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    calls = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA and e.name in LAUNCH_CALLS:
            calls[e.name] = calls.get(e.name, 0) + 1
    def t_of(e):
        if hasattr(e, "self_device_time_total"):
            return e.self_device_time_total
        return e.self_cuda_time_total
    copies = [e for e in dev if "emcpy" in e.name or "emset" in e.name]
    kernels = [e for e in dev if e not in copies]
    busy = sum(t_of(e) for e in dev)
    top = {}
    for e in kernels:
        top[e.name[:60]] = top.get(e.name[:60], 0.0) + t_of(e)
    return {"wall_us_per_stmt": round(wall_us / n, 1),
            "wall_us_p50": round(p50(walls), 1),
            "kernels_per_stmt": round(len(kernels) / n, 2),
            "copies_per_stmt": round(len(copies) / n, 2),
            "launch_calls_per_stmt": {k: round(v / n, 2)
                                      for k, v in sorted(calls.items())},
            "device_us_per_stmt": round(busy / n, 2),
            "idle_share": round(1 - busy / wall_us, 4) if wall_us else None,
            "top_kernels_us": {k: round(v / n, 2) for k, v in
                               sorted(top.items(), key=lambda kv: -kv[1])[:6]}}


def device_families(prof, wall_us, n):
    """Device time of a profiled window by kernel family, per unit of
    ``n`` (a round, a prefill): GEMMs, the Mamba2 scan, the attention
    kernels, the kv table's SQL kernels, copies and the rest (PyTorch's
    elementwise and reduction kernels); launches and the idle share."""
    from torch.autograd import DeviceType
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]

    def t_of(e):
        if hasattr(e, "self_device_time_total"):
            return e.self_device_time_total
        return e.self_cuda_time_total

    fam = {"gemm": 0.0, "mamba2_scan": 0.0, "flash_attention": 0.0,
           "paged_attention": 0.0, "sql_kernels": 0.0, "copies": 0.0,
           "other": 0.0}
    top = {}
    for e in dev:
        name, t = e.name, t_of(e)
        if "emcpy" in name or "emset" in name:
            fam["copies"] += t
        elif "ms_state_kernel" in name or "ms_chunk_kernel" in name:
            fam["mamba2_scan"] += t
        elif "paged_split_kernel" in name:
            fam["paged_attention"] += t
        elif "flash_kernel" in name:
            fam["flash_attention"] += t
        elif "scan_kernel" in name or "compact_kernel" in name:
            fam["sql_kernels"] += t
        elif any(w in name.lower() for w in ("gemm", "gemv", "nvjet",
                                              "cutlass", "sm90_xmma")):
            fam["gemm"] += t
        else:
            fam["other"] += t
        top[name[:60]] = top.get(name[:60], 0.0) + t
    busy = sum(fam.values())
    return {"wall_us": wall_us / n, "device_us": busy / n,
            "idle_share": 1 - busy / wall_us, "kernels": len(dev) / n,
            "device_us_by_family": {k: v / n for k, v in fam.items()},
            "top_kernels_us": {k: v / n for k, v in
                               sorted(top.items(), key=lambda kv: -kv[1])[:8]}}


def profile_rounds(eng, cfg, n_rounds=4):
    """Decode rounds of a serve path under the profiler: per round the
    host wall time, the card's busy time and idle share, kernels on the
    card, the host's launch calls, and device time by kernel family."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i, prompt in enumerate(serve_prompts(cfg, 4, seed=SEED + 2)):
        eng.add_request(prompt, user_id=200 + i)
    eng.decode_round()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_rounds):
            eng.decode_round()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    eng.flush()
    calls = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA and e.name in LAUNCH_CALLS:
            calls[e.name] = calls.get(e.name, 0) + 1
    return {"rounds": n_rounds, **device_families(prof, wall_us, n_rounds),
            "launch_calls_per_round": {k: v / n_rounds
                                       for k, v in sorted(calls.items())}}


def profile_prefill(eng, cfg, n_tokens):
    """One prefill of ``n_tokens`` under the profiler (after one unprofiled
    prefill of the same length): wall, device time by family, launches
    and the idle share."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(SEED + 4)
    prompts = [rng.integers(0, cfg.vocab, n_tokens).astype(np.int32)
               for _ in range(2)]
    eng.add_request(prompts[0], user_id=300)
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.add_request(prompts[1], user_id=301)
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    eng.flush()
    return {"tokens": n_tokens, **device_families(prof, wall_us, 1)}


def table2_db(extra):
    """A card daemon holding the Table 2 table (``extra``: its indexes)."""
    pages, users, payload = table2_data()
    db = D.SQLCached()
    db.execute(f"CREATE TABLE cache (page_id INT, user_id INT, data "
               f"BIGINT{extra}) CAPACITY 131072 MAX_SELECT 64")
    db.executemany("INSERT INTO cache (page_id, user_id, data) VALUES "
                   "(?, ?, ?)", list(zip(pages.tolist(), users.tolist(),
                                         payload.tolist())))
    drain_warmup = getattr(db, "drain_warmup", None)   # a parent tree's
    if drain_warmup is not None:                       # daemon has none
        drain_warmup()
    db.drain()
    return db


def comparable_rows(dev):
    """Whole calls that this tree's package and its parent's both offer,
    timed by what they put on the card (every kernel, memset and copy of
    one call): the scan with each statement's total (``relscan`` without
    the compaction), the hash build, the bare probe, the executors'
    verified IndexProbe route (its ids, presence and count from
    core/table.py), and
    per statement on the Table 2 table (plain and indexed) kernels, device
    time and idle share. Run it in a fresh process per tree to compare
    this package with another checkout's, within one call."""
    from repro_torch.core import predicate as P
    from repro_torch.core import table as T
    pages, users, _ = table2_data()
    rng = np.random.default_rng(SEED + 3)
    cap = 131_072
    page_col, valid = table_column(pages, cap, dev)
    user_col, _ = table_column(users, cap, dev)
    rows = {}

    def add(what, fn, iters=50):
        # device time and launches from one profiled window
        events = device_events(fn, iters)
        rows[what] = {
            "device_ms": sum(device_us(e) for e in events) / iters / 1e3,
            "device_launches": len(events) / iters,
            "ms": time_ms(fn, iters=iters)}

    big = 4_194_304
    bcols = [torch.from_numpy(rng.integers(-100, 100, big).astype(np.int32))
             .to(dev) for _ in range(4)]
    bvalid = torch.from_numpy(rng.random(big) < 0.8).to(dev)
    for what, cols, vld, vals, ops in (
            ("1 term, cap 131072", [page_col], valid,
             [[int(pages[2])]], ("==",)),
            ("2 terms, cap 131072", [user_col, page_col], valid,
             [[int(users[1]), 15_000]], ("==", "<")),
            ("4 terms, cap 4194304", bcols, bvalid, [[0, 50, -50, 3]],
             ("<=", "<", ">=", "!=")),
            ("1 term, w = 32, cap 131072", [page_col], valid,
             pages[2:34].reshape(32, 1).tolist(), ("==",))):
        v = torch.tensor(vals, dtype=torch.int32, device=dev)
        add(f"scan + totals, {what}", lambda: RS.relscan(
            cols, vld, v, ops=ops, limit=1, want_ids=False),
            iters=20 if vld.shape[0] == big else 50)
    # the hash build as a call: the Table 2 bulk load's two index builds
    # (user_id overflows) and 4,194,304 full-range keys in 131,072 buckets
    bkeys = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, big)
                             .astype(np.int32)).to(dev)
    for what, col, vld in (("page_id, cap 131072", page_col, valid),
                           ("user_id, cap 131072", user_col, valid),
                           ("cap 4194304", bkeys, bvalid)):
        n_b = HX.n_buckets_for(vld.shape[0])
        add(f"build, {what}", lambda: HX.build(col, vld, n_buckets=n_b),
            iters=20 if vld.shape[0] == big else 50)
    del bcols, bvalid, bkeys

    db = table2_db(", INDEX(page_id)")
    t = db.tables["cache"]
    where = P.BinOp("=", P.Col("page_id"), P.Param(0))
    plan = T.plan_for(t.schema, where)
    idx = t.state["indexes"]["page_id"]
    for w in (1, 32):
        q = torch.from_numpy(pages[2:2 + w].copy()).to(dev)
        add(f"probe, w = {w}", lambda: HX.probe(idx["rid"], idx["key"], q))

        def route():
            _, _, count, ids = T._probe_candidates(
                t.schema, t.state, plan, (q,), w, limit=64)
            return ids, T._present(count, 64), count
        add(f"verified probe route, w = {w}, limit 64", route)

    # per statement: the first 20 under the profiler, 20 more for the
    # wall p50; on a tree that pre-plans statements each is one graph
    # replay after the first call captures it
    for variant, dbx in (("plain", table2_db("")), ("indexed", db)):
        rows[f"{variant}_page_delete"] = profile_statements(
            dbx, "DELETE FROM cache WHERE page_id = ?",
            [(int(p),) for p in pages[400:440]])
        rows[f"{variant}_page_select"] = profile_statements(
            dbx, "SELECT * FROM cache WHERE page_id = ? LIMIT 64",
            [(int(p),) for p in pages[500:540]])
    return rows


def phase_comparable(dev, card):
    emit({"phase": "comparable", "card": card, "rows": comparable_rows(dev)})


def phase_profile(card, serve, zamba):
    out = {"serve_decode_round": profile_rounds(serve["eng"], serve["cfg"])}
    out["zamba2_decode_round"] = profile_rounds(zamba["eng"], zamba["cfg"])
    out["zamba2_prefill_300"] = profile_prefill(zamba["eng"], zamba["cfg"],
                                                ZAMBA_LONG_PROMPT)
    emit({"phase": "profile", "card": card, **out})


# ------------------------------------------------------------------- main

SOURCES = {
    "relscan_scan": ("src/repro_torch/csrc/relscan.cu",
                     "src/repro/kernels/relscan.py:51"),
    "relscan_compact": ("src/repro_torch/csrc/relscan.cu",
                        "src/repro/kernels/relscan.py:62"),
    "hash_build": ("src/repro_torch/csrc/hashidx.cu",
                   "src/repro/kernels/hashidx.py:133"),
    "hash_probe": ("src/repro_torch/csrc/hashidx.cu",
                   "src/repro/kernels/hashidx.py:207"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:28"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:27"),
    "mamba2_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                    "src/repro/kernels/mamba_scan.py:23"),
}


def main():
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = phase_device()
    phase_build()
    # first, in a process that has profiled nothing yet: long runs of
    # profiled windows were seen to lose some kernel records
    phase_comparable(dev, card)
    timing, errs = phase_kernels(dev, card)
    for phase in (phase_kernels_attention, phase_kernels_mamba):
        t, e = phase(dev, card)
        timing.update(t)
        errs.update(e)

    # each main path runs with the launch counts zeroed right before it and
    # read right after it; every kernel that path must run has to show up
    scan_compact = ("relscan_scan", "relscan_compact")
    serve: dict = {}   # each serve path's engine, for the profile phase
    zamba: dict = {}
    # the kv table has no payload, so the serve paths' DELETEs take the
    # mask-only route (the scan, no compaction), as in the reference
    serve_need = ("flash_attention", "paged_attention", "relscan_scan")
    paths = (
        ("table2_plain", lambda: phase_table2(card, "plain", ""),
         scan_compact),
        ("table2_indexed", lambda: phase_table2(
            card, "indexed", ", INDEX(page_id), INDEX(user_id)"),
         scan_compact + ("hash_build", "hash_probe")),
        ("fig1", lambda: phase_fig1(card), scan_compact),
        ("wire", lambda: phase_wire(card), scan_compact + ("hash_probe",)),
        ("graphs", lambda: phase_graphs(card),
         scan_compact + ("hash_build", "hash_probe")),
        ("shards", lambda: phase_shards(card),
         scan_compact + ("hash_build", "hash_probe")),
        ("serve", lambda: phase_serve(card, dev, serve), serve_need),
        ("serve_zamba2", lambda: phase_serve(
            card, dev, zamba, "zamba2-2.7b", max_seq=512,
            long_prompt=ZAMBA_LONG_PROMPT, name="serve_zamba2", atol=None),
         serve_need + ("mamba2_scan",)),
        ("snapshot", lambda: phase_snapshot(card),
         scan_compact + ("hash_build", "hash_probe")),
        ("cluster", lambda: phase_cluster(card),
         scan_compact + ("hash_build", "hash_probe")),
        # the daemons are child processes: no launch of theirs is counted
        ("cluster_chaos", lambda: phase_cluster_chaos(card), ()),
    )
    launches = {k: 0 for k in _build.KERNELS}
    for path, drive, need in paths:
        _build.reset_launches()
        drive()
        got = dict(_build.launches)
        emit({"phase": "launches", "path": path, "launches": got})
        missing = [k for k in need if got[k] == 0]
        if missing:
            raise AssertionError(f"{path}: kernels never launched on this "
                                 f"path: {missing} ({got})")
        held = {"serve": serve, "serve_zamba2": zamba}.get(path)
        if held is not None:  # one launch per layer per prefill / round
            if any(got[k] != n for k, n in held["want"].items()):
                raise AssertionError(f"{path}: launches {got}, expected "
                                     f"{held['want']}")
        for k, n in got.items():
            launches[k] += n
    emit({"phase": "main_path_launches", **launches})
    phase_profile(card, serve, zamba)

    keymap = {"relscan_scan": "scan", "relscan_compact": "compact",
              "hash_build": "build", "hash_probe": "probe"}
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        t = timing[keymap.get(name, name)]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], "ms": t["ms"],
                        "device_ms": t["device_ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t.get("library_ms")})
        # the shard axis (S = 8 shards of 16,384 rows, one call) beside
        # the same work as 8 separate unsharded calls
        rows = [r for r in timing["shard_axis"] if r["kernel"] == name]
        if rows:
            kernels[-1]["shard_axis"] = [
                {k: r[k] for k in ("shape", "device_ms", "bound_ms",
                                   "separate_calls_device_ms")}
                for r in rows]
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start, 1)})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)



if __name__ == "__main__":
    main()
