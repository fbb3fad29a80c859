#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card and
the CUDA toolkit. Phases (one JSON line each on stdout):

0. device  -- the card's name and power limit (``nvidia-smi``).
1. build   -- compile the CUDA kernels from the eight sources in
              ``src/repro_torch/csrc`` (one ``nvcc`` per source, in
              parallel) and report registers, shared memory and spills
              per kernel instance, and the tensor-core (HMMA, HGMMA), copy
              (LDGSTS, UTMALDG) and mbarrier (SYNCS) instructions of the
              flash libraries (``cuobjdump``); the backward library must
              hold HGMMA and its wgmma kernels spill nothing.
   comparable -- right after the build (torch.profiler): the device time
              and launches of whole calls that this tree and its parent
              both offer (``comparable_rows``: the scan with its totals,
              the hash build, the bare probe, the executors' verified
              probe route, the Mamba2 scan with its outputs' SHA-256 and
              its backward, the flash backward at gemma2-2b's and
              zamba2-2.7b's training shapes with its error, each launch
              apart), and
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
              at tests/test_kernels.py's shapes, head dims 8-256, the
              serve paths' own shapes (yi-6b at head dim 128, zamba2's
              shared block at 80, gemma2's hd 256 with softcap 50,
              starcoder2's 36 / 4 heads, gemma3's 1,200-token prompt
              and its 1,024-token window crossed in the decode; granite's
              hd 64 with GQA group 2, phi3.5's 32 / 8 heads, internvl2's
              group 7 over 256 frontend positions + the prompt,
              seamless's group 1, its encoder non-causal over 1,024
              frames and its cross attention of 8-24 queries over them),
              the flash kernels' tile edges (lengths
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
              heads (the non-causal encoder and cross shapes too; paged
              at group 7 and group 1).
              The int8 read path (``kernels_attention`` too): an int8
              arena quantized per token as the serve engine writes it,
              its fp32 scales, q in fp32 and bf16, with and without the
              unquantized self term (a slot at -1 attends nothing, one at
              0 only itself), at the paged cases' shapes (yi-6b's hd 128,
              zamba2's hd 80, hd 8, split edges, windows, softcap), within
              the same tolerances; then its time at both serve shapes
              beside its bound and the bf16 call on the same shape.
              The paged kernel's striped call form (``kernels_attention``
              too: the serving mesh's stripes): every stripe of 1, 2, 4
              and 8 stripes with ``blk_start`` and ``return_lse`` at
              yi-6b's and zamba2's mesh pools (block 256), gemma3's local
              layer (window 1,025, softcap 50) and internvl2's group 7,
              bf16 and fp32 q over arenas of q's dtype and int8 ones (the
              self term at one stripe), slots without a request and ones
              whose later stripes see nothing: out within the tolerances
              above, lse within 1e-4 of max(1, |lse|), the stripes'
              combine within the tolerances of the unstriped plain call, a
              second call bit-equal, ``blk_start=None`` bit-equal to the
              call without it; then one stripe's call timed at yi-6b's
              layout (b) beside its bound (the pages it reads and its
              lse), all eight stripes' and the unstriped call's.
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
   kernels_attention_bwd -- the flash-attention backward
              (``csrc/flash_attention_bwd.cu``: delta, dK/dV, dQ) against
              its plain version on the card, fp32 within 1e-4 and bf16
              within 2e-2 of the largest gradient, from the forward
              kernel's own output and log-sum-exp: kernels_attention's
              flash shapes and tile edges (head dims 8-256, causal and
              not, q_offset, windows crossed, softcap 50, GQA groups 1-9,
              sq != sk, rows that see no key), GQA 7 and 8, cross
              attention, gemma2's window at 4,608 tokens, the wgmma
              kernels' tile edges (sq, sk at 64 and 128 +- 1 at head dims
              32-256, GQA 1, 2, 7, window edges inside a tile, q_offset,
              rows that see no key, rings longer than a CTA's walk) and
              the transposed views (dq in q's layout); a second call
              bit-equal, autograd (FlashAttention) equal to the wrapper,
              the stored lse against the plain one. Then at gemma2-2b's
              training shape (b 1, s 8,192, h 8 / kh 4, hd 256, softcap
              50; window 4,096 and global): each launch's device time,
              the backward call's, the plain version's, the bound (10 ·
              visible pairs · hd FLOP at 989 TFLOP/s for the whole
              backward) and scaled_dot_product_attention's backward
              (without the softcap, the window as a mask); the forward
              with and without its lse store. The same for the backward
              at zamba2-2.7b's training shape (b 1, s 8,192, h 32 / kh
              32, hd 80, causal, no softcap: SDPA's backward computes the
              same function there).
   kernels_mamba_bwd -- the Mamba2 scan's backward
              (``csrc/mamba_scan_bwd.cu``: the walks over segments of
              chunks, the pass over the segments' boundaries, the
              chunk-parallel gradients a group of heads a CTA, the sum
              over the groups) against its plain version
              (``mamba2_scan_bwd_ref``): s 1, 24, 40, 63, 64, 65, 100,
              128, 130, 300, 4,608 and 8,193 (1, 2 and 129 chunks); dh
              16 and 64; st 8, 64 and 256; nh 1-80 (7: groups that do not
              divide it); b 1-2; a zero, a random and no h0; dh_last
              none and random; x fp32 and bf16; in one variant every
              input a strided view; the kernel's own plans at 1-17 walk
              segments and 1-80 head groups (a last group smaller); each
              gradient within 1e-4 of its largest entry (bf16 dx 2e-2), a
              second call bit-equal, autograd (Mamba2Scan) equal to the
              wrapper; one step at nh 7 with no state terms (its gradients
              cancel in C_0 . B_0) against an fp64 closed form, within
              1e-4 of each gradient's largest sum of absolute terms.
              Then at zamba2's training shape (b 1, s 8,192, nh 80, dh
              64, st 64) and its 300-token prefill: the six gradients
              against the plain version's (1e-4 of each one's largest
              entry), the call's device time and each launch's, the
              wrapper's, the plain version's, the bound, the plan and the
              scratch (no PyTorch call computes this function).
   bound_checks -- every model kernel's bound above reads its wrapper's
              reckoning (FA.flash_cost / flash_bwd_cost, PA.paged_cost,
              MS.scan_cost / scan_bwd_cost: the dry run's counts too),
              each held equal to the count this script kept before, the
              striped call's excepted (its fp32 output, counted now).
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
   mesh    -- phase shards's deployment PLACED over lane meshes of 2 and
              4 entries (launch/mesh.py: distinct cards where there are
              that many, else cuda:0 repeated; prints ``distinct_devices``
              on a line of its own), against an unplaced CPU daemon: the
              bulk load, pruned and fan-out statements, SHOW STATS's
              placement, warm replays (a fan-out: one graph launch a block
              plus the merge's, no kernel launch; its scan or probe once a
              block), four scheduler threads, CHECKPOINT, RESTORE into the
              other mesh size, RESHARD 4 and 1. Every result and state
              equal, no dispatch syncs; reports warm p50s.
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
              Table 2 table's graph-pool bytes and wall p50s. Then
              graphs_race: one thread plans 24 fresh statement shapes
              while another builds daemons and yi-6b SMOKE ServeGraphs,
              drops them in unreachable cycles and calls gc.collect():
              zero failed captures, zero uncached plans.
   train   -- training through the port, first of the main paths: (i)
              gemma2-2b at full width with 2 layers (local, global), b 1,
              s 4,608: the loss and every gradient leaf through the
              kernels against the same with the plain attention swapped
              in under autograd (loss within 1e-2 relative, each leaf
              within 5e-2 of its largest entry); (ii) gemma2-2b at its 26
              layers, 3 AdamW steps of launch/train.py (b 1, s 8,192,
              remat full): finite losses, the third below the first,
              step time, tokens/s, peak memory against the 31.4 GB of
              state; (iii) yi-6b, granite-moe-1b, seamless-m4t-v2 and
              internvl2-1b SMOKE (fp32): 3 steps, then a resume from the
              step-2 checkpoint whose step 3 repeats the loss within 1e-4
              relative, now also zamba2, falcon-mamba-7b, gemma3-27b and
              phi3.5-moe, and starcoder2-7b SMOKE (head dim 4, through
              the flash wrappers' zero-padded route at head dim 8);
              (iv') zamba2-2.7b
              at full width, its first scan unit (6 Mamba2 layers and the
              shared block), s 4,608, against the plain scan and plain
              attention as in (i); (v) zamba2-2.7b at its 54 layers, 3
              AdamW steps of launch/train.py (b 1, s 8,192, remat full,
              no checkpoint) and a profiled step, as (ii). (ii) and (v)
              report the model-FLOP share of the card's bf16 peak
              (repro_torch.roofline).
6. serve_gemma3, serve_gemma2, serve_starcoder2, serve_falcon_mamba --
              the paged-KV serving engine with the four other archs it
              serves, each at its published width and depth (bf16, random
              weights from a seeded torch.Generator), run first, one at a
              time (each engine and its weights released after its
              checks; gemma3-27b's weights alone take 54 GB): gemma3-27b
              (62 layers, 5 local : 1 global, q/k and sandwich norms; the
              launcher's prompts plus one of 1,200 tokens, so that the
              local layers' 1,024-token window binds in the flash prefill
              and the paged decode; max_seq 1,536), gemma2-2b (26 layers,
              hd 256, both softcaps), starcoder2-7b (36 / 4 heads) and
              falcon-mamba-7b (64 Mamba1 layers, no arena; plus a
              300-token prompt, so that its scan crosses a 256-step
              chunk), with serve's traffic and checks (below): logits
              within 0.05 of the dense reference, the CPU replay, the warm
              round, exact launch counts (falcon-mamba: no flash or paged
              launch), peak memory.
   serve_granite_moe, serve_phi35_moe, serve_internvl2, serve_seamless --
              the same engine, checks and traffic, one at a time, each
              engine released after its checks: granite-moe-1b (24 layers,
              32 experts top-8), phi3.5-moe at 28 of its 32 layers (16
              experts top-2; 73.1 GB of weights: the card does not hold
              all 32 beside the CUDA context), internvl2-1b with a [256,
              896] frontend (× 0.02, seeded) before every prompt, max_seq
              512, and seamless-m4t-v2 (24 encoder + 24 decoder layers)
              with [1,024, 1,024] encoder frames on every request. Logits
              against the dense reference (its encoder kernel-free, its
              frontend rows fed one a step) within 0.05; an MoE's routing
              compared token by token and layer by layer (flips
              reported); flash launches exact: each
              decoder layer once a prefill, seamless's 72 (24 encoder + 24
              self + 24 cross).
   serve   -- the paged-KV serving engine with yi-6b at full width (bf16,
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
   serve_int8, serve_int8_zamba2 -- both serve paths again on the same
              weights and traffic with the int8 arena (``kv_quant_int8``):
              logits teacher-forced against the dense reference that
              quantizes K/V as the engine does (a prompt's when it is
              installed, each later token's after its own step), yi-6b
              within 0.05 and zamba2 within its bound measured in the same
              call (by serve_zamba2: its fp32 run is not repeated); the
              same CPU replay and warm-round checks; reports
              the arena and scale bytes beside the bf16 engine's, the
              round's p50 and how many greedy tokens agree with it.
   serve_mesh -- the serving mesh (serving/paged.py, serving/engine.py
              over launch/mesh.make_debug_mesh of repeated cuda:0; every
              coordinate checked to be on the card): yi-6b at full width
              over (data 2, model 2) with 4 slots (slots over 'data',
              heads over 'model'), over (data 1, model 8) with 4 slots (8
              stripes, the LSE combine), over (data 2, model 2) with one
              slot of 8,184 tokens (seq 8,192, stripes over 'data'), (b)
              again on the int8 arena, and zamba2-2.7b's shared block over
              (2, 2) with 2 slots, each with its weights placed by
              SERVE_PARAM_RULES. Pools of 24 / 310 / 1,030 / 4,088
              tokens (seq 4,096, block 256), random K/V and SSM states; 8
              rounds each of the placed step, the mesh-free step and the
              mesh-free step in fp32 (weights and pools cast up) from the
              same params and pool, teacher-forced on the mesh-free
              tokens: logits within twice the bf16 mesh-free step's
              largest distance from the fp32 one (bf16's own error, the
              rule serve_zamba2's bound follows), greedy tokens equal
              where the mesh-free top-2 gap exceeds that, the joined bf16
              arenas within 2e-2 of their largest entry, round 1's first
              island within one bf16 ulp of the mesh-free island, round
              1's collective bytes by kind equal to the phase's own
              reckoning from the config (tp_round_collectives), paged
              launches exact (a coordinate a layer a round, plus the two
              mesh-free steps'); reports round p50s beside each other,
              each step's distance from fp32 and peak memory.
   serve_tp -- tensor-parallel weights (parallel/sharding.place_params by
              SERVE_PARAM_RULES, the step over them coordinate by
              coordinate with parallel/collectives.py's collectives),
              each case held as serve_mesh holds its own: yi-6b at full
              width over (2, 2) (heads over 'model') and (1, 8) (4 kv
              heads replicated, 8 stripes, q gathered for the island),
              zamba2-2.7b over (2, 2) (its SSM states placed by the
              reference's spec), granite-moe-1b-a400m over (1, 4)
              (experts over 'model'), 4 slots, the pools above (other
              seeds); and a 300-token yi-6b prefill over (1, 4) (flash a
              coordinate a layer), logits within 0.05; and the dense
              decode_step over placed weights (decode_step_tp: yi-6b over
              (2, 2), the dense cache placed by place_cache, 4 slots, 8
              rounds) against the mesh-free decode_step, logits within
              twice the bf16 mesh-free step's distance from fp32, no
              kernel launched. Reports each coordinate's placed bytes,
              round p50s, the collective bytes and peak memory.
   train_tp -- gemma2-2b at full width (b 2, s 4,096, remat full) with
              weights and moments placed by TRAIN_PARAM_RULES over (2, 2)
              (FSDP 'embed' over 'data', heads / mlp / vocab over
              'model'): loss within 1e-2 relative and every gradient leaf
              within 5e-2 of its largest entry against the mesh-free
              step, the tied embedding's within twice the mesh-free
              step's distance from the same step in fp32 if that is
              larger (both lookups sum their gradient in bf16, as the
              reference's do, the placed one a batch slice at a time);
              then one AdamW update at step 1 and every parameter against
              the mesh-free step's; step seconds, peak memory, collective
              bytes. The placed gradients again under seq -> model
              (REPRO_SEQ_ACT=model: the residual stream cut along the
              sequence over 'model'), held to the same bounds against the
              mesh-free step: no residual all-reduce over 'model' left,
              the all-gather and reduce-scatter bytes over 'model' equal
              to seq_collective_reckoning; peak memory beside the step
              without the rule. Then one yi-6b SMOKE step through
              parallel/compression.make_compressed_grad_fn over (pod 2,
              data 1, model 2) against the same on the CPU.
   dryrun -- the dry run (launch/dryrun.py) against the card: (i)
              train_tp's gemma2-2b step walked on meta over (2, 2) and
              the same step on the card under one cost counter
              (roofline/cost.py): FLOPs, bytes moved, argument bytes (=
              the placed tensors' bytes), kernel calls and every
              coordinate's FLOPs equal, the collective logs equal as
              multisets (their order reported); the walk's peak live
              bytes over the mesh within 0.8-1.25 of the card's
              allocated rise over the step; (ii) the same counts for
              yi-6b's placed serve round (4 slots of 4,096 over (2, 2)),
              its peak ratio reported; (iii) gemma2-2b train_4k over the
              16 x 16 production mesh: its two-point probe's costs,
              roofline terms and wall seconds; (iv) (i) under
              REPRO_SEQ_ACT=model, the same counts and peak bounds, its
              peak temporary bytes beside (i)'s.
   examples -- examples/torch_quickstart.py (its rows and counts, a CUDA
              payload) and examples/torch_cms_cache_sim.py (2,000
              requests: each cache's hits and request p50 / p99, wall
              µs) on the card, the relscan launches counted.
   train_seqpar -- one gemma2-2b training step at full width (b 1, s
              8,192, remat full) with ``attn_seq_shard`` over a 'model'
              axis of 4 entries (cuda:0 repeated) against the same step
              without the mesh: loss within 1e-3 relative, every
              gradient leaf's norm within 1e-2 relative, flash launches
              exactly 4 times the mesh-free step's; step times and peak
              memory.
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
   profiler_edges -- how many of a short profiled window's 10 device
              records the profiler keeps this late in the process.
7. profile -- after the main paths (torch.profiler): per decode round of
              both serve paths (host launch calls, kernels on the card,
              device time by family, idle share), and for zamba2's
              300-token prefill.

Phases 3-6 are twenty-nine main paths (train, serve_gemma3, serve_gemma2,
serve_starcoder2, serve_falcon_mamba, serve_granite_moe, serve_phi35_moe,
serve_internvl2, serve_seamless, serve, serve_zamba2, serve_int8,
serve_int8_zamba2, serve_mesh, train_seqpar, serve_tp, train_tp, dryrun,
examples, Table 2 plain, Table 2
indexed, Fig. 1, wire, graphs,
shards, mesh, snapshot, cluster, cluster_chaos; the twelve serve
paths run first, since their warm round check reads the card's copy
records, which a longer profiled process was seen to lose). A statement kernel that runs inside a
captured graph counts once per launch on the card: the plan's prime run,
then each replay's captured launches. The launch counters are zeroed right before
each path and read right after it, and each path must have launched
every kernel it runs: scan and compact on the statement paths, build and
probe on the indexed Table 2 table and in graphs, probe in the wire
script (its table has INDEX(k)), all four in shards, mesh, snapshot and
cluster (cluster_chaos's kernels run in child processes, which the
counters cannot see: that path checks results only); flash attention,
paged attention and the relscan scan on
the serve paths of attention archs, the forward with its lse store and
the three backward kernels, the Mamba2 scan and its backward on train,
the relscan scan alone on
falcon-mamba's (the DELETEs of its empty kv table), and the Mamba2 scan on
zamba2's two, each an exact number of times (per attention layer or
shared-block application and prefill or round, the capture's prime round
included; per Mamba2 layer and prefill; zero where the arch has none). Then comes a ``kernels`` line
(launches summed over the paths), the ``nvidia-smi`` line, and the final
status line.
Any failure raises: the script exits non-zero and prints no status line,
and so it does without a CUDA card or outside a checkout of the repo.
"""
import contextlib
import dataclasses
import gc
import hashlib
import json
import math
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
from repro_torch.core import execache as EC  # noqa: E402
from repro_torch.core import protocol as PR  # noqa: E402
from repro_torch.core import shards as SH  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import hashidx as HX  # noqa: E402
from repro_torch.kernels import mamba_scan as MS  # noqa: E402
from repro_torch.kernels import paged_attention as PA  # noqa: E402
from repro_torch.kernels import relscan as RS  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402
from repro_torch.models.config import MAMBA2  # noqa: E402
from repro_torch.models.layers import attention as AT  # noqa: E402
from repro_torch.models.layers import moe as MOE  # noqa: E402
from repro_torch.models.layers import ssm as SSM  # noqa: E402
from repro_torch.models.params import param_axes  # noqa: E402
from repro_torch.parallel import collectives as CO  # noqa: E402
from repro_torch.parallel import sharding as SHD  # noqa: E402
from repro_torch.roofline import analysis as RF  # noqa: E402
from repro_torch.serving import paged as PG  # noqa: E402
from repro_torch.serving import engine as SE  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

# the card's figures (repro_torch.roofline's table, by the name the card
# reports; a card not in it raises)
CARD_HW = RF.device_hw(0)
SIMT_OPS_S = CARD_HW.fp32_flops    # 32-bit rate outside the tensor cores
BF16_OPS_S = CARD_HW.peak_flops    # dense bf16 tensor-core rate
TF32_OPS_S = CARD_HW.tf32_flops    # dense TF32 tensor-core rate
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


def device_events(fn, iters=1, tries=8, want=1, windows=None):
    """The CUDA activities (kernels, memsets, copies) of ``iters`` calls of
    ``fn`` after one warm-up call, from the profiler. Every ``fn`` timed
    here puts work on the card, yet on the H100 the profiler now and then
    returned a window with no CUDA activity at all (cause unknown; late in
    a run every other short window came back empty, and once three in a
    row did, early), or with one record of a call's two kernels: a window
    with fewer than ``want`` activities is profiled again, up to ``tries``
    times (the windows it took are appended to ``windows``, where given,
    for the caller to report)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    for n in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            sync()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if len(events) >= want:
            break
    if windows is not None:
        windows.append(n)
    return events


def call_device_ms(fn, iters=50):
    """Mean device time of one call of ``fn``: every kernel, memset and
    copy it launches (a library call may launch several)."""
    return sum(device_us(e) for e in device_events(fn, iters)) / iters / 1e3


def device_launches(fn, iters=10):
    """Kernels, memsets and copies one call of ``fn`` puts on the card."""
    return len(device_events(fn, iters)) / iters


# Every model kernel's bound reads its wrapper's reckoning (``FA.flash_cost``
# and ``flash_bwd_cost``, ``PA.paged_cost``, ``MS.scan_cost`` and
# ``scan_bwd_cost``: the dry run's count too). Each ``*_work`` below also
# gives the count this script kept before (``_legacy``), and ``bound``
# holds the two bounds equal (``BOUND_CHECKS``, the ``bound_checks`` line):
# the one deliberate change is the striped call's fp32 output.
BOUND_CHECKS: list = []
_legacy: list = []


def bound(nbytes: float, ops: float, ops_rate: float = SIMT_OPS_S):
    """(ms, "bytes" or "operations"): ``RF.kernel_bound`` on this card."""
    t, by = RF.kernel_bound(nbytes, ops, ops_rate, CARD_HW)
    if _legacy:
        name, old_bytes, old_ops = _legacy.pop()
        t0, by0 = RF.kernel_bound(old_bytes, old_ops, ops_rate, CARD_HW)
        BOUND_CHECKS.append({"work": name, "bound_ms": t * 1e3,
                             "bound_ms_before": t0 * 1e3, "bound_by": by,
                             "bound_by_before": by0})
    return t * 1e3, by


def reckoned(name, new, old):
    """The reckoning's (bytes, FLOP) of a ``*_work``, with the count it
    replaces noted for the next ``bound``."""
    _legacy.append((name,) + tuple(old))
    return new


def check_bounds() -> None:
    """Every bound read the same before and after the kernels' reckonings
    (within 1e-9 relative), the striped call's excepted."""
    emit({"phase": "bound_checks", "rows": BOUND_CHECKS})
    bad = [r for r in BOUND_CHECKS if r["work"] != "striped" and (
        abs(r["bound_ms"] - r["bound_ms_before"])
        > 1e-9 * r["bound_ms_before"] or r["bound_by"] != r["bound_by_before"])]
    if bad:
        raise AssertionError(f"bounds moved with the reckonings: {bad}")


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


KERNEL_NAME = re.compile(r"(ms_state|ms_chunk|msb_walk|msb_chunk|msb_sum|"
                         r"build_rows|build_buckets|tc_dkdv|tc_dq|bw_dkdv|"
                         r"bw_dq|bw_delta|scan|"
                         r"compact|probe|flash|paged_split)_kernel(_tc)?")


def kernel_key(fn: str) -> str:
    """A readable name for a mangled kernel symbol: the kernel and its
    template arguments (dtype, head dim), e.g. ``flash_kernel_tc<80>``
    (the bf16 tensor-core kernel) or ``paged_split_kernel<bf16,i8,128>``."""
    name = KERNEL_NAME.search(fn)
    if not name:
        return fn
    inst = re.search(r"_kernel(?:_tc)?I((?:f|a|S0_|13__nv_bfloat16|Li\d+E)+)E",
                     fn)
    if not inst:
        return name.group(0)
    # f fp32, a int8, 13__nv_bfloat16 bf16 (S0_: bf16 again), Li<n>E a dim
    args = [t.group(2) or ("i8" if t.group(3) else "bf16" if t.group(1)
                           else "f32") for t in
            re.finditer(r"(13__nv_bfloat16|S0_)|Li(\d+)E|(a)|f",
                        inst.group(1))]
    return name.group(0) + "<" + ",".join(args) + ">"


SASS_OPS = ("HMMA", "LDGSTS", "LDSM", "HGMMA", "UTMALDG", "SYNCS")


def sass_counts(lib: pathlib.Path) -> dict | None:
    """Instructions in a built library's SASS, from cuobjdump (None where
    it is missing): HMMA (mma.sync), LDGSTS (cp.async), LDSM (ldmatrix),
    and Hopper's HGMMA (wgmma), UTMALDG (TMA loads) and SYNCS
    (mbarriers)."""
    tool = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in SASS_OPS}


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
    bwd_sass = sass_counts(libdir / "libflash_attention_bwd.so")
    emit({"phase": "build", "seconds": round(secs, 3), "ptxas": report,
          "flash_sass": sass_counts(libdir / "libflash_attention.so"),
          "flash_bwd_sass": bwd_sass})
    # the backward's wgmma kernels: on the tensor cores' Hopper path, and
    # no register spilled
    if bwd_sass is not None and not bwd_sass["HGMMA"]:
        raise AssertionError("libflash_attention_bwd.so has no HGMMA")
    spilled = {k: v["spill_stores_loads"] for k, v in report.items()
               if re.search(r"\.tc_(dkdv|dq)_kernel", k)
               and v["spill_stores_loads"] not in (None, [0, 0])}
    built = bool(logs.get("flash_attention_bwd"))  # not a cached library
    if spilled or (built and not any(".tc_" in k for k in report)):
        raise AssertionError(f"the backward's wgmma kernels spill or are "
                             f"missing from the build report: {spilled}")


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
        windows = []
        names = [e.name for e in device_events(run, want=launches,
                                               windows=windows)]
        if len(names) != launches:
            raise AssertionError(f"{label}: one call ran {names}")
        b_ms, b_by = bound(nbytes, ops)
        rows_out.append({
            "kernel": kernel, "shape": label, "ms": time_ms(run),
            "device_ms": call_device_ms(run),
            "separate_calls_device_ms": call_device_ms(separate),
            "separate_calls_ms": time_ms(separate),
            "plain_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "device_events_one_call": names,
            "profile_windows": windows[0]})

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
    # gemma2's prefills: hd 256, 8 / 4 heads, softcap 50, window 4096 (and
    # one that binds)
    (1, 8, 4, 23, 23, 256, True, 4096, 50.0, 0),
    (1, 8, 4, 300, 300, 256, True, 100, 50.0, 0),
    # starcoder2's: 36 / 4 heads (GQA group 9)
    (1, 36, 4, 23, 23, 128, True, 0, 0.0, 0),
    (1, 36, 4, 300, 300, 128, True, 0, 0.0, 0),
    # gemma3's 1,200-token prompt: a local layer (window 1,024) and a
    # global one, 32 / 16 heads
    (1, 32, 16, 1200, 1200, 128, True, 1024, 0.0, 0),
    (1, 32, 16, 1200, 1200, 128, True, 0, 0.0, 0),
    # the MoE, vision and encoder-decoder archs' prefills: granite (hd
    # 64, 16 / 8 heads), phi3.5 (32 / 8, hd 128), internvl2 (14 / 2: GQA
    # group 7, 256 frontend positions + 8-24 tokens), seamless's decoder
    # (16 / 16, hd 64), its encoder (non-causal over 1,024 frames) and its
    # cross attention (non-causal, 8-24 queries over the frames' K/V)
    (1, 16, 8, 23, 23, 64, True, 0, 0.0, 0),
    (1, 32, 8, 23, 23, 128, True, 0, 0.0, 0),
    (1, 14, 2, 264, 264, 64, True, 0, 0.0, 0),
    (1, 14, 2, 279, 279, 64, True, 0, 0.0, 0),
    (1, 16, 16, 23, 23, 64, True, 0, 0.0, 0),
    (1, 16, 16, 1024, 1024, 64, False, 0, 0.0, 0),
    (1, 16, 16, 8, 1024, 64, False, 0, 0.0, 0),
    (1, 16, 16, 24, 1024, 64, False, 0, 0.0, 0),
    (2, 16, 16, 24, 1000, 64, False, 0, 0.0, 0),
    # starcoder2-7b's SMOKE head dim 4 (36 / 4 heads): the wrappers' zero-
    # padded route through the kernels at head dim 8, forward and backward
    (4, 36, 4, 32, 32, 4, True, 0, 0.0, 0),
    (1, 4, 2, 70, 70, 4, True, 17, 20.0, 0),
    (2, 4, 4, 13, 40, 4, False, 0, 0.0, 0),
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
                    (2, 8, 2, 37, 8), (1, 36, 4, 23, 128),
                    (1, 8, 4, 23, 256), (1, 32, 16, 1200, 128)]

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
    # the new serve paths' decode (the island passes window + 1): gemma2
    # (hd 256, softcap 50, window 4096; and one that binds), starcoder2
    # (36 / 4 heads), gemma3 (32 / 16 heads, max_seq 1,536, a local
    # layer's window of 1,024 crossed, and a global layer)
    (4, 8, 4, 256, 16, 16, 4097, 50.0, [24, 31, 0, 40], ()),
    (4, 8, 4, 256, 16, 20, 101, 50.0, [300, 31, 100, 102], ()),
    (4, 36, 4, 128, 16, 16, 0, 0.0, [24, 31, 0, 40], ()),
    (4, 36, 4, 128, 16, 16, 0, 0.0, [9, 17, 33, 256], ()),
    (4, 32, 16, 128, 16, 96, 1025, 0.0, [1216, 1025, 17, 0], ()),
    (4, 32, 16, 128, 16, 96, 0, 0.0, [1216, 1025, 17, 0], ()),
    # the MoE, vision and encoder-decoder archs' decode: granite (hd 64,
    # GQA group 2), phi3.5 (32 / 8, hd 128), internvl2 (14 / 2: group 7,
    # 256 frontend positions first, max_seq 512), seamless's decoder
    # (16 / 16: group 1)
    (4, 16, 8, 64, 16, 16, 0, 0.0, [24, 31, 0, 40], ()),
    (4, 32, 8, 128, 16, 16, 0, 0.0, [24, 31, 0, 40], ()),
    (4, 14, 2, 64, 16, 32, 0, 0.0, [280, 287, 0, 296], ()),
    (4, 14, 2, 64, 16, 32, 0, 0.0, [257, 320, 64, 512], ()),
    (4, 16, 16, 64, 16, 16, 0, 0.0, [24, 31, 0, 40], ()),
    (4, 16, 16, 64, 16, 16, 0, 0.0, [9, 17, 33, 256], ()),
]
SERVE_DECODE_LENGTHS = [24, 31, 17, 40]
ZAMBA_DECODE_LENGTHS = [24, 31, 17, 310]
# (h, kh, hd, nblk, lengths, what) of the two decode timings: yi-6b's and
# zamba2's shared block (4 slots, block 16, bf16)
PAGED_YI = (32, 4, 128, 16, SERVE_DECODE_LENGTHS, "")
PAGED_ZAMBA = (32, 32, 80, 32, ZAMBA_DECODE_LENGTHS, " (zamba2's shared block)")
# the new serve paths' decode shapes: gemma2 (hd 256, softcap 50),
# starcoder2 (GQA group 9) and a gemma3 local layer (window 1,024 crossed
# by its 1,200-token prompt)
PAGED_GEMMA2 = (8, 4, 256, 16, SERVE_DECODE_LENGTHS, " (gemma2)", 0, 50.0)
PAGED_STARCODER2 = (36, 4, 128, 16, SERVE_DECODE_LENGTHS, " (starcoder2)")
PAGED_GEMMA3 = (32, 16, 128, 96, [1216, 24, 31, 17],
                " (gemma3, a local layer)", 1025)
# the vision and encoder-decoder archs' decode shapes: internvl2 (GQA
# group 7, its sequences 256 frontend positions longer) and seamless's
# decoder (group 1)
PAGED_INTERNVL2 = (14, 2, 64, 32, [280, 287, 271, 296], " (internvl2)")
PAGED_SEAMLESS = (16, 16, 64, 16, SERVE_DECODE_LENGTHS, " (seamless)")


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


def paged_int8_inputs(rng, gen, dev, dtype, b, h, kh, hd, block, nblk,
                      lengths, holes=(), self_term=True):
    """``paged_inputs``' construction over an int8 arena: random rows
    quantized per (row, k/v, position, kv head) as the serve engine writes
    them (``serving/paged.quantize_kv``), their fp32 scales, and the
    unquantized self term's k / v in q's dtype (or None)."""
    q, arena, pages, lens = paged_inputs(rng, gen, dev, torch.float32, b, h,
                                         kh, hd, block, nblk, lengths, holes)
    arena_q, scales = PG.quantize_kv(arena)
    kv_self = None
    if self_term:
        kv_self = tuple(torch.randn((b, kh, hd), generator=gen,
                                    device=dev).to(dtype) for _ in range(2))
    return q.to(dtype), arena_q, scales, pages, lens, kv_self


def check_paged_int8(rng, gen, dev, per_case):
    """The int8 read path against ``paged_attention_ref`` with scales at
    PAGED_CASES's shapes (yi-6b's hd 128 / kh 4, zamba2's hd 80 / kh 32,
    hd 8, one split and several, windows, softcap, missing pages), q in
    fp32 and bf16, with the self term (lengths as given, plus a slot at
    -1 that attends nothing and one at 0 that sees only its own token)
    and without it. A second call must give the same bits. Returns the
    largest error per q dtype."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        errs[dname] = 0.0
        for (b, h, kh, hd, block, nblk, window, softcap, lengths,
             holes) in PAGED_CASES:
            for self_term in (True, False):
                q, arena, scales, pages, lens, kv_self = paged_int8_inputs(
                    rng, gen, dev, dtype, b, h, kh, hd, block, nblk, lengths,
                    holes, self_term)
                if self_term and b >= 3:   # a slot without a request, and
                    lens[-1] = -1          # one that sees only itself
                    lens[-2] = 0
                kw = dict(scale=hd ** -0.5, softcap=softcap, window=window,
                          scales=scales, kv_self=kv_self)
                got = PA.paged_attention(q, arena, pages, lens, **kw)
                want = PA.paged_attention_ref(q, arena, pages, lens, **kw)
                again = PA.paged_attention(q, arena, pages, lens, **kw)
                sync()
                shape = (f"{b}x{h}/{kh}x{hd} blk{block}x{nblk} w{window} "
                         f"c{softcap} lengths {lens.tolist()} holes "
                         f"{list(holes)} int8 arena, self term {self_term}")
                if not torch.equal(got, again):
                    raise AssertionError(f"paged_attention {shape} {dname}: "
                                         f"a second call differs")
                e = att_err(got, want, dtype,
                            f"paged_attention {shape} {dname}")
                errs[dname] = max(errs[dname], e)
                per_case.append(["paged_int8", dname, shape, e])
    return errs


def paged_int8_work(h, kh, hd, nblk, lengths, q_elem):
    """(bytes, FLOP) of one int8 decode call with the self term: q and out
    once (q's type), each visible K/V row once (1 byte an element) with
    its two fp32 scales, the self term's k / v, pages and lengths."""
    b = len(lengths)
    tokens = int(sum(lengths))
    old = ((2 * b * h * hd + 2 * b * kh * hd) * q_elem
           + 2 * tokens * kh * (hd + 4) + 4 * b * nblk + 4 * b,
           4 * h * hd * (tokens + b))
    flops, nbytes = PA.paged_cost(b, h, kh, hd, 0, nblk, q_elem, 1,
                                  tokens=tokens, self_term=True, scales=True)
    return reckoned("paged_int8", (nbytes, flops), old)


def paged_int8_timing(rng, gen, dev, h, kh, hd, nblk, lengths, what):
    """One int8 decode call (bf16 q, the self term) at a serve path's
    shape beside the bf16 call on the same shape: times, device time,
    launches, plain time and bound."""
    q, arena, scales, pages, lens, kv_self = paged_int8_inputs(
        rng, gen, dev, torch.bfloat16, 4, h, kh, hd, 16, nblk, lengths)
    kw = dict(scale=hd ** -0.5, scales=scales, kv_self=kv_self)
    run = lambda: PA.paged_attention(q, arena, pages, lens, **kw)  # noqa: E731
    arena_bf = (arena.float() * scales[..., None]).to(torch.bfloat16)
    run_bf = lambda: PA.paged_attention(  # noqa: E731
        q, arena_bf, pages, lens, scale=hd ** -0.5)
    b_ms, b_by = bound(*paged_int8_work(h, kh, hd, nblk, lengths, 2),
                       BF16_OPS_S)
    return {
        "kernel": "paged_attention", "shape": f"b4 h{h}/kh{kh} hd{hd} "
        f"block16 nblk{nblk} lengths {lengths} int8 arena, bf16 q, self "
        f"term{what}",
        "ms": time_ms(run), "device_ms": call_device_ms(run),
        "device_launches": device_launches(run),
        "plain_ms": time_ms(lambda: PA.paged_attention_ref(
            q, arena, pages, lens, **kw)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "library": "none: no single PyTorch call gathers K/V through a page "
                   "table",
        "bf16_arena_ms": time_ms(run_bf),
        "bf16_arena_device_ms": call_device_ms(run_bf)}


def paged_timing(rng, gen, dev, h, kh, hd, nblk, lengths, what, window=0,
                 softcap=0.0):
    """One decode call of paged attention at a serve path's shape: its
    time, the device time of the whole call and its device launches, the
    plain version's time and the bound (over the positions the window
    leaves visible)."""
    q, arena, pages, lens = paged_inputs(rng, gen, dev, torch.bfloat16, 4, h,
                                         kh, hd, 16, nblk, lengths)
    kw = dict(scale=hd ** -0.5, window=window, softcap=softcap)
    run = lambda: PA.paged_attention(q, arena, pages, lens, **kw)  # noqa: E731
    seen = [min(n, window - 1) if window else n for n in lengths]
    b_ms, b_by = bound(*paged_work(h, kh, hd, nblk, seen, 2), BF16_OPS_S)
    return {
        "kernel": "paged_attention", "shape": f"b4 h{h}/kh{kh} hd{hd} "
        f"block16 nblk{nblk} lengths {lengths} window {window} softcap "
        f"{softcap} bf16{what}",
        "ms": time_ms(run), "device_ms": call_device_ms(run),
        "device_launches": device_launches(run),
        "plain_ms": time_ms(lambda: PA.paged_attention_ref(
            q, arena, pages, lens, **kw)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "library": "none: no single PyTorch call gathers K/V through a page "
                   "table"}


def flash_work(b, h, kh, sq, sk, hd, elem, causal=True, q_offset=0):
    """(bytes, FLOP) one flash call must move and do: q, k, v read once,
    the output written once; QK^T and PV over the visible (q, k) pairs."""
    pairs = sum(min(sk, q_offset + i + 1) if causal else sk
                for i in range(sq))
    old = ((2 * b * h * sq * hd + 2 * b * kh * sk * hd) * elem,
           4 * b * h * pairs * hd)
    flops, nbytes = FA.flash_cost(b, h, kh, sq, sk, hd, elem, causal=causal,
                                  q_offset=q_offset)
    return reckoned("flash", (nbytes, flops), old)


def paged_work(h, kh, hd, nblk, lengths, elem):
    """(bytes, FLOP) of one decode call: q and out once, each visible K/V
    row once, pages and lengths; QK^T and PV over the visible tokens."""
    b = len(lengths)
    tokens = int(sum(lengths))
    old = ((2 * b * h * hd + 2 * tokens * kh * hd) * elem + 4 * b * nblk
           + 4 * b, 4 * h * hd * tokens)
    flops, nbytes = PA.paged_cost(b, h, kh, hd, 0, nblk, elem,
                                  tokens=tokens)
    return reckoned("paged", (nbytes, flops), old)


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
    errs = {"flash_attention": 0.0, "paged_attention": 0.0,
            "paged_attention_wide": 0.0}
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
    int8_errs = check_paged_int8(rng, gen, dev, per_case)
    errs["paged_attention"] = max(errs["paged_attention"],
                                  *int8_errs.values())
    errs["paged_attention_wide"] = check_paged_wide(rng, gen, dev, per_case)
    errs["paged_attention_lse"], lse_err_max = check_paged_striped(
        rng, gen, dev, per_case, errs)
    emit({"phase": "kernels_attention", "card": card, "cases": len(per_case),
          "tolerance": {"float32": ATT_TOL[torch.float32],
                        "bfloat16": ATT_TOL[torch.bfloat16],
                        "lse_relative": LSE_TOL},
          "max_abs_err": errs, "max_abs_err_int8_arena": int8_errs,
          "max_rel_err_lse": lse_err_max, "per_case": per_case})

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
    # one 2,048-token prompt with yi-6b's heads (timed for the table only);
    # internvl2's prefill (256 + 24 positions, GQA group 7), seamless's
    # encoder (non-causal, 1,024 frames) and cross attention (24 queries,
    # non-causal over the 1,024 frames)
    for name, h, kh, sq, s, hd, causal, what in (
            ("flash_attention_hd80_s24", 32, 32, 24, 24, 80, True,
             "zamba2's shared block"),
            ("flash_attention_hd80_s300", 32, 32, 300, 300, 80, True,
             "zamba2's shared block"),
            ("flash_attention_s2048", 32, 4, 2048, 2048, 128, True,
             "yi-6b's heads, one long prompt"),
            ("flash_attention_g9_s300", 36, 4, 300, 300, 128, True,
             "starcoder2's heads"),
            ("flash_attention_hd256_s300", 8, 4, 300, 300, 256, True,
             "gemma2's heads, no softcap"),
            ("flash_attention_gemma3_s1200", 32, 16, 1200, 1200, 128, True,
             "gemma3's heads, a global layer of its 1,200-token prompt"),
            ("flash_attention_internvl2_s280", 14, 2, 280, 280, 64, True,
             "internvl2's heads, 256 frontend positions + 24 tokens"),
            ("flash_attention_encoder_s1024", 16, 16, 1024, 1024, 64, False,
             "seamless's encoder, non-causal"),
            ("flash_attention_cross_sq24", 16, 16, 24, 1024, 64, False,
             "seamless's cross attention, 24 queries over 1,024 frames")):
        scale = hd ** -0.5
        q, k, v = flash_inputs(gen, dev, bf, 1, h, kh, sq, s, hd)
        run = lambda: FA.flash_attention(q, k, v, scale=scale,  # noqa: E731
                                         causal=causal)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731,E501
            q, k, v, is_causal=causal, scale=scale, enable_gqa=kh != h)
        lib_diff = float((sdpa().float() - run().float()).abs().max())
        if not lib_diff <= ATT_TOL[bf]:
            raise AssertionError(f"scaled_dot_product_attention differs "
                                 f"from the kernel by {lib_diff}")
        b_ms, b_by = bound(*flash_work(1, h, kh, sq, s, hd, 2, causal),
                           BF16_OPS_S)
        long = s > 300
        shape = (f"sq=sk={s}" if sq == s else f"sq={sq} sk={s}")
        out[name] = {
            "kernel": "flash_attention", "shape": f"b1 h{h}/kh{kh} "
            f"{shape} hd{hd} bf16 {'causal' if causal else 'non-causal'} "
            f"({what})", "ms": time_ms(run),
            "device_ms": device_ms(run, "flash_kernel"),
            "plain_ms": time_ms(lambda: FA.flash_attention_ref(
                q, k, v, scale=scale, causal=causal),
                iters=10 if long else 50,
                warm=2 if long else 20),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": time_ms(sdpa),
            "library_device_ms": call_device_ms(sdpa),
            "library": "torch.nn.functional.scaled_dot_product_attention",
            "library_max_abs_diff": lib_diff}
    out["paged_attention_hd80"] = paged_timing(rng, gen, dev, *PAGED_ZAMBA)
    out["paged_attention_hd256"] = paged_timing(rng, gen, dev, *PAGED_GEMMA2)
    out["paged_attention_g9"] = paged_timing(rng, gen, dev,
                                             *PAGED_STARCODER2)
    out["paged_attention_w1024"] = paged_timing(rng, gen, dev, *PAGED_GEMMA3)
    out["paged_attention_g7"] = paged_timing(rng, gen, dev, *PAGED_INTERNVL2)
    out["paged_attention_g1"] = paged_timing(rng, gen, dev, *PAGED_SEAMLESS)
    out["paged_attention_int8"] = paged_int8_timing(rng, gen, dev, *PAGED_YI)
    out["paged_attention_int8_hd80"] = paged_int8_timing(rng, gen, dev,
                                                         *PAGED_ZAMBA)
    out["paged_attention_wide"] = paged_wide_timing(rng, gen, dev)
    out["paged_attention_lse"] = paged_striped_timing(rng, gen, dev)
    for t in out.values():
        emit({"phase": "kernel_timing", "card": card, **t})
    return out, errs


# ------------------------ phase 2b': the paged kernel's block-256 form
# Pages longer than a split (64 positions) whose length is a multiple of
# it are cut into 64-position parts, each a split of its own; with no
# block starts and no lse the call launches paged_wide_kernel with an
# output of q's dtype (``paged_attention_wide``): every mesh-free step of
# serve_mesh and every head-sharded coordinate there. (b, h, kh, hd,
# block, nblk, window, softcap, lengths, holes): yi-6b's mesh-free step
# (serve_mesh (a), (b)), a layout (a) coordinate (2 slots, 16 / 2
# heads), layout (c)'s mesh-free step (8,184 tokens), zamba2's mesh-free
# step and a coordinate of its (2, 2) mesh, lengths either side of a
# part's and a page's edge, gemma2's hd 256 with softcap 50 and a window
# that crosses parts, block 128 (two parts a page), and missing pages.
PA_SPLIT = 64
# the serve_mesh phase's yi-6b pool (its (a), (b) and int8 cases)
YI_MESH_LENGTHS = [24, 310, 1030, 4088]
PAGED_WIDE_CASES = [
    (4, 32, 4, 128, 256, 16, 0, 0.0, YI_MESH_LENGTHS, ()),
    (2, 16, 2, 128, 256, 16, 0, 0.0, [24, 4088], ()),
    (1, 32, 4, 128, 256, 32, 0, 0.0, [8184], ()),
    (2, 32, 32, 80, 256, 16, 0, 0.0, [310, 1030], ()),
    (1, 16, 16, 80, 256, 16, 0, 0.0, [1030], ()),
    (4, 32, 4, 128, 256, 4, 0, 0.0, [64, 256, 257, 63], ()),
    (4, 8, 4, 256, 256, 8, 101, 50.0, [300, 1500, 24, 0], ()),
    (3, 8, 2, 64, 128, 6, 0, 0.0, [700, 128, 1], ()),
    (2, 8, 2, 64, 256, 4, 0, 0.0, [900, 600], ((0, 1), (1, 0))),
]


def check_paged_wide(rng, gen, dev, per_case) -> float:
    """The block-256 form (no block starts, no lse) against
    ``paged_attention_ref`` at PAGED_WIDE_CASES: fp32 and bf16 q over an
    arena of q's dtype and over an int8 one with the self term (the
    mesh-free int8 step's call), within ATT_TOL; a second call bit-equal;
    each call one ``paged_attention_wide`` launch. Returns the largest
    error."""
    err = 0.0
    for (b, h, kh, hd, block, nblk, window, softcap, lengths,
         holes) in PAGED_WIDE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            for int8 in (False, True):
                if int8:
                    q, arena, scales, pages, lens, kv_self = \
                        paged_int8_inputs(rng, gen, dev, dtype, b, h, kh, hd,
                                          block, nblk, lengths, holes)
                else:
                    q, arena, pages, lens = paged_inputs(
                        rng, gen, dev, dtype, b, h, kh, hd, block, nblk,
                        lengths, holes)
                    scales = kv_self = None
                kw = dict(scale=hd ** -0.5, softcap=softcap, window=window,
                          scales=scales, kv_self=kv_self)
                before = _build.launches["paged_attention_wide"]
                got = PA.paged_attention(q, arena, pages, lens, **kw)
                if _build.launches["paged_attention_wide"] != before + 1:
                    raise AssertionError(f"paged_attention_wide {block}: "
                                         f"not counted as its form")
                again = PA.paged_attention(q, arena, pages, lens, **kw)
                want = PA.paged_attention_ref(q, arena, pages, lens, **kw)
                sync()
                shape = (f"{b}x{h}/{kh}x{hd} blk{block}x{nblk} w{window} "
                         f"c{softcap} lengths {lengths} holes {list(holes)} "
                         f"{'int8 arena, self term' if int8 else dname}")
                if not torch.equal(got, again):
                    raise AssertionError(f"paged_attention_wide {shape} "
                                         f"{dname}: a second call differs")
                e = att_err(got, want, dtype,
                            f"paged_attention_wide {shape} {dname}")
                err = max(err, e)
                per_case.append(["paged_wide", dname, shape, e])
    return err


def paged_wide_timing(rng, gen, dev):
    """The block-256 form at yi-6b's mesh-free step in serve_mesh (a) and
    (b): 4 slots of 24 / 310 / 1,030 / 4,088 tokens, 16 pages of 256
    (64 splits of 64 positions a slot), bf16."""
    h, kh, hd, block, nblk = 32, 4, 128, 256, 16
    q, arena, pages, lens = paged_inputs(rng, gen, dev, torch.bfloat16, 4, h,
                                         kh, hd, block, nblk,
                                         YI_MESH_LENGTHS)
    kw = dict(scale=hd ** -0.5)
    run = lambda: PA.paged_attention(q, arena, pages, lens, **kw)  # noqa: E731
    b_ms, b_by = bound(*paged_work(h, kh, hd, nblk, YI_MESH_LENGTHS, 2),
                       BF16_OPS_S)
    return {
        "kernel": "paged_attention_wide", "shape": f"b4 h{h}/kh{kh} hd{hd} "
        f"block{block} nblk{nblk} lengths {YI_MESH_LENGTHS} bf16 (serve_mesh's "
        f"mesh-free yi-6b step)", "ms": time_ms(run),
        "device_ms": call_device_ms(run),
        "device_launches": device_launches(run),
        "plain_ms": time_ms(lambda: PA.paged_attention_ref(
            q, arena, pages, lens, **kw), iters=50),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "library": "none: no single PyTorch call gathers K/V through a page "
                   "table"}


# ----------------------------- phase 2b'': the paged kernel's striped form
# The serving mesh's call form (serving/paged.py over a mesh): each stripe
# holds every S-th block of a sequence, so its pages start at the global
# positions (j * S + stripe) * block (``blk_start``), and it returns the
# rows' log-sum-exp for the combine across stripes. (h, kh, hd, block,
# nblk, lengths, window, softcap, what): the serve paths' shapes with
# yi-6b's and zamba2's mesh pools (block 256), gemma3's local layer (a
# 1,025-token window with softcap 50), internvl2's group 7 (block 16) and
# gemma2's hd 256 with softcap 50 at block 256 (64-position parts of a
# page: a whole page would not fit shared memory); each has a slot
# without a request (0) or a short one whose tokens lie on the first
# stripes only, so that later stripes see nothing.
STRIPE_COUNTS = (1, 2, 4, 8)
STRIPED_SHAPES = [
    (32, 4, 128, 256, 16, [24, 310, 1030, 4088], 0, 0.0, "yi-6b"),
    (32, 32, 80, 256, 16, [24, 310, 0, 1030], 0, 0.0, "zamba2"),
    (32, 16, 128, 16, 96, [1216, 1025, 17, 5], 1025, 50.0,
     "gemma3 local, window 1,025, softcap 50"),
    (14, 2, 64, 16, 32, [280, 287, 0, 296], 0, 0.0, "internvl2, group 7"),
    (8, 4, 256, 256, 8, [300, 24, 0, 1500], 0, 50.0, "gemma2, hd 256"),
]
LSE_TOL = 1e-4   # relative to max(1, |lse|): fp32 sums in either order


def stripe_pages(pages, block, S):
    """A page table [b, nblk] cut into S stripes: stripe s holds blocks
    s, s + S, ... ([b, nblk / S] each) and their global starts."""
    b, nblk = pages.shape
    out = []
    for s in range(S):
        jl = torch.arange(nblk // S, device=pages.device)
        start = ((jl * S + s) * block).to(torch.int32)
        out.append((pages[:, s::S].contiguous(),
                    start.expand(b, -1).contiguous()))
    return out


def combine_stripes(parts):
    """The island's combine of (out, lse) partials: [b, h, hd] fp32."""
    o = torch.stack([p[0].float() for p in parts])
    lse = torch.stack([p[1] for p in parts])
    w = torch.exp(lse - lse.max(dim=0).values)
    return (w[..., None] * o).sum(0) / w.sum(0)[..., None]


def lse_err(got, want, what) -> float:
    """The rows that see nothing are -1e30 in both; the others within
    LSE_TOL of max(1, |lse|)."""
    none_g, none_w = got <= -1e29, want <= -1e29
    if not torch.equal(none_g, none_w):
        raise AssertionError(f"{what}: rows that see nothing differ")
    if bool(none_w.all()):
        return 0.0
    live = ~none_w
    err = float(((got - want).abs() / want.abs().clamp(min=1.0))[live].max())
    if not err <= LSE_TOL:
        raise AssertionError(f"{what}: lse differs from the plain version's "
                             f"by {err} (tolerance {LSE_TOL})")
    return err


def check_paged_striped(rng, gen, dev, per_case, errs):
    """The striped call form against ``paged_attention_ref`` with the same
    ``blk_start`` / ``return_lse``: every stripe of S = 1, 2, 4, 8 at
    STRIPED_SHAPES, bf16 and fp32 q over arenas of q's dtype and int8
    ones (with the self term at S = 1, where its lse counts it), out
    within ATT_TOL and lse within LSE_TOL; the stripes' combine within
    ATT_TOL of the plain unstriped call on the whole sequence; a second
    call bit-equal; the unstriped kernel call (``paged_attention`` at
    block 16, ``paged_attention_wide`` at block 256) and the one with
    ``blk_start`` of j * block (``paged_attention_wide``) each within
    ATT_TOL of that plain call, their errors added to ``errs``;
    ``blk_start=None`` bit-equal to the call without it. Returns the
    largest striped output error and the largest lse error."""
    err, lerr = 0.0, 0.0
    for h, kh, hd, block, nblk, lengths, window, softcap, what in \
            STRIPED_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            for int8 in (False, True):
                if int8:
                    q, arena, scales, pages, lens, kv_self = \
                        paged_int8_inputs(rng, gen, dev, dtype, 4, h, kh, hd,
                                          block, nblk, lengths)
                else:
                    q, arena, pages, lens = paged_inputs(
                        rng, gen, dev, dtype, 4, h, kh, hd, block, nblk,
                        lengths)
                    scales = kv_self = None
                kw = dict(scale=hd ** -0.5, softcap=softcap, window=window,
                          scales=scales)
                whole = PA.paged_attention_ref(q, arena, pages, lens, **kw)
                for S in STRIPE_COUNTS:
                    selfs = (None, kv_self) if int8 and S == 1 else (None,)
                    for ks in selfs:
                        parts = []
                        for s, (pg, bs) in enumerate(stripe_pages(
                                pages, block, S)):
                            kws = dict(kw, kv_self=ks, blk_start=bs,
                                       return_lse=True)
                            got = PA.paged_attention(q, arena, pg, lens,
                                                     **kws)
                            want = PA.paged_attention_ref(q, arena, pg, lens,
                                                          **kws)
                            again = PA.paged_attention(q, arena, pg, lens,
                                                       **kws)
                            sync()
                            shape = (f"{what} {dname} "
                                     f"{'int8' if int8 else dname} arena "
                                     f"S{S} stripe {s} lengths {lengths} "
                                     f"self term {ks is not None}")
                            if not (torch.equal(got[0], again[0])
                                    and torch.equal(got[1], again[1])):
                                raise AssertionError(f"paged_attention_lse "
                                                     f"{shape}: a second "
                                                     f"call differs")
                            e = att_err(got[0], want[0], dtype,
                                        f"paged_attention_lse {shape}")
                            le = lse_err(got[1], want[1],
                                         f"paged_attention_lse {shape}")
                            err, lerr = max(err, e), max(lerr, le)
                            per_case.append(["paged_lse", dname, shape, e,
                                             le])
                            parts.append(got)
                        if ks is None:   # the stripes make the whole
                            att_err(combine_stripes(parts), whole.float(),
                                    dtype, f"paged_attention_lse {what} "
                                    f"{dname} S{S}: the combined stripes")
                # the earlier call form: unchanged by the new arguments
                plain = PA.paged_attention(q, arena, pages, lens, **kw)
                none = PA.paged_attention(q, arena, pages, lens,
                                          blk_start=None, **kw)
                jb = stripe_pages(pages, block, 1)[0][1]
                explicit = PA.paged_attention(q, arena, pages, lens,
                                              blk_start=jb, **kw)
                sync()
                if not torch.equal(plain, none):
                    raise AssertionError(f"paged_attention {what}: "
                                         f"blk_start=None changed the bits")
                form = ("paged_attention_wide" if block > PA_SPLIT
                        else "paged_attention")
                tag = f"{what} {dname} {'int8' if int8 else dname} arena"
                e = att_err(plain, whole, dtype, f"{form} {tag}: unstriped")
                errs[form] = max(errs[form], e)
                ew = att_err(explicit, whole, dtype, f"paged_attention_wide "
                             f"{tag}: blk_start = j * block")
                errs["paged_attention_wide"] = max(
                    errs["paged_attention_wide"], ew)
                per_case.append([form, dname, f"{tag} unstriped", e])
                per_case.append(["paged_wide", dname,
                                 f"{tag} blk_start = j * block", ew])
    return err, lerr


def striped_work(h, kh, hd, block, lengths, stripe, S, nblk_l, elem,
                 kv_elem=None):
    """(bytes, FLOP) of one stripe's call: q read and its fp32 output
    written once, the K/V rows of the positions its pages hold that are
    visible, pages, starts and lengths, and its lse; QK^T and PV over
    those positions (the count before this reckoning took the output at
    q's width)."""
    kv_elem = elem if kv_elem is None else kv_elem
    b = len(lengths)
    seen = sum(max(0, min(block, n - (jl * S + stripe) * block))
               for n in lengths for jl in range(nblk_l))
    old = (2 * b * h * hd * elem + 2 * seen * kh * hd * kv_elem
           + 8 * b * nblk_l + 4 * b + 4 * b * h, 4 * h * hd * seen)
    flops, nbytes = PA.paged_cost(b, h, kh, hd, block, nblk_l, elem, kv_elem,
                                  tokens=seen, starts=True, lse=True)
    return reckoned("striped", (nbytes, flops), old)


def paged_striped_timing(rng, gen, dev):
    """The striped call at yi-6b's mesh layout (b): 4 slots of 24 / 310 /
    1,030 / 4,088 tokens, block 256, 16 blocks over 8 stripes (2 pages a
    stripe), bf16: stripe 0's call (time, device time, launches, plain
    time, bound), all 8 stripes' calls one after another, and the
    unstriped call on the same pool."""
    h, kh, hd, block, nblk, lengths = 32, 4, 128, 256, 16, \
        [24, 310, 1030, 4088]
    S = 8
    q, arena, pages, lens = paged_inputs(rng, gen, dev, torch.bfloat16, 4, h,
                                         kh, hd, block, nblk, lengths)
    cuts = stripe_pages(pages, block, S)
    kw = dict(scale=hd ** -0.5, return_lse=True)
    pg, bs = cuts[0]
    run = lambda: PA.paged_attention(q, arena, pg, lens,  # noqa: E731
                                     blk_start=bs, **kw)

    def run_all():
        for pg_s, bs_s in cuts:
            PA.paged_attention(q, arena, pg_s, lens, blk_start=bs_s, **kw)
    whole = lambda: PA.paged_attention(q, arena, pages, lens,  # noqa: E731
                                       scale=hd ** -0.5)
    b_ms, b_by = bound(*striped_work(h, kh, hd, block, lengths, 0, S,
                                     nblk // S, 2), BF16_OPS_S)
    all_ms = sum(bound(*striped_work(h, kh, hd, block, lengths, s, S,
                                     nblk // S, 2), BF16_OPS_S)[0]
                 for s in range(S))
    return {
        "kernel": "paged_attention_lse", "shape": f"b4 h{h}/kh{kh} hd{hd} "
        f"block{block}, stripe 0 of {S} (2 pages a stripe), lengths "
        f"{lengths}, bf16, blk_start and lse (the serving mesh's layout "
        f"(b))", "ms": time_ms(run), "device_ms": call_device_ms(run),
        "device_launches": device_launches(run),
        "plain_ms": time_ms(lambda: PA.paged_attention_ref(
            q, arena, pg, lens, blk_start=bs, **kw), iters=50),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "library": "none: no single PyTorch call gathers K/V through a page "
                   "table",
        "all_stripes_ms": time_ms(run_all, iters=50),
        "all_stripes_device_ms": call_device_ms(run_all, iters=20),
        "all_stripes_bound_ms": all_ms,
        "unstriped_device_ms": call_device_ms(whole)}


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
    new_flops, new_bytes = MS.scan_cost(b, s, nh, dh, st, elem, h0=True)
    return reckoned("mamba", (new_bytes, new_flops), (nbytes, flop))


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


# --------------------------------------- phase 2c': the Mamba2 backward

# (b, s, nh, dh, st): one step, a short tile, one tile and a step either
# side, zamba2's 300-token prefill, a ragged third tile at st 256, the
# training length of phase train's zamba2 unit (4,608) at zamba2's width;
# dh 16 and 64, st 8 / 64 / 256, nh 1-80, b 1-3; the segmented design's
# edges at the kernel's own plan: one (ragged) chunk and two at nh 7 (7
# groups of one head), 129 chunks (17 walk segments, the last of one
# chunk), 33 chunks at nh 7 (5 segments; 4 groups of 2, 2, 2 and 1
# heads), b 3 at 11 chunks (2 segments, 4 groups); 4,608 runs 8 segments
# and 9 groups of 9, 9, ..., 8 heads
MAMBA_BWD_CASES = [(1, 1, 1, 16, 8), (2, 24, 3, 16, 8), (1, 63, 80, 64, 64),
                   (1, 64, 80, 64, 64), (2, 65, 4, 64, 64),
                   (1, 300, 80, 64, 64), (2, 300, 5, 16, 256),
                   (1, 130, 7, 64, 256), (2, 100, 2, 16, 64),
                   (1, 4608, 80, 64, 64), (1, 40, 7, 64, 64),
                   (2, 128, 7, 64, 64), (1, 8193, 3, 16, 8),
                   (1, 2100, 7, 64, 64), (3, 704, 7, 64, 64)]
# one step, no state terms: every gradient but dh0 scales with C_0 . B_0,
# a sum of st products that cancels (the fp32 plain version rounds it as
# much as the kernel does), so this case is held to an fp64 evaluation,
# each gradient within MAMBA_BWD_TOL of its largest sum of absolute terms
MAMBA_BWD_CANCEL = (1, 1, 7, 64, 64)
# (h0, dh_last, views): a zero state and no gradient of h_last (what the
# model's training passes), both random, h0 absent with dh_last random;
# the views variant reads every input and dy through strides (x and dy
# [b, nh, s, dh] transposed, dt and dA slices of [b, s, 2 nh], B and C the
# two halves of [b, s, 2 st], as mamba2_forward passes them)
MAMBA_BWD_VARIANTS = [("zero", False, False), ("random", True, False),
                      (None, True, True)]
# of each gradient's largest entry: fp32 sums in another order; bf16 dx
# is rounded once (every other gradient is fp32 whatever x is)
MAMBA_BWD_TOL = {"float32": 1e-4, "bfloat16_dx": 2e-2}
MAMBA_TRAIN = (1, 8192, 80, 64, 64)   # zamba2's training shape (phase train)
MAMBA_BWD_NAMES = ("dx", "ddt", "ddA", "dB", "dC", "dh0")


def mamba_bwd_inputs(gen, dev, dtype, shape, h0, dh_last, views):
    b, s, nh, dh, st = shape

    def n(*sh):
        return torch.randn(sh, generator=gen, device=dev)
    sp = torch.nn.functional.softplus
    if views:
        x = n(b, nh, s, dh).to(dtype).transpose(1, 2)
        dy = n(b, nh, s, dh).to(dtype).transpose(1, 2)
        dt = sp(n(b, s, 2 * nh))[..., :nh]
        dA = -sp(n(b, s, 2 * nh))[..., nh:]
        B, C = n(b, s, 2 * st).chunk(2, dim=-1)
    else:
        x, dy = n(b, s, nh, dh).to(dtype), n(b, s, nh, dh).to(dtype)
        dt, dA = sp(n(b, s, nh)), -sp(n(b, s, nh))
        B, C = n(b, s, st), n(b, s, st)
    h = {"zero": torch.zeros((b, nh, dh, st), device=dev),
         "random": n(b, nh, dh, st), None: None}[h0]
    return (x, dt, dA, B, C, h), dy, (n(b, nh, dh, st) if dh_last else None)


def mamba_bwd_case(gen, dev, dtype, shape, h0, dh_last, views):
    """One case: the kernels' six gradients against the plain version's,
    a second call bit-equal, and the same gradients through autograd
    (Mamba2Scan). Returns (the error relative to each gradient's largest
    entry, the largest absolute error)."""
    ins, dy, dhl = mamba_bwd_inputs(gen, dev, dtype, shape, h0, dh_last,
                                    views)
    got = MS.mamba2_scan_bwd(*ins, dy, dhl)
    again = MS.mamba2_scan_bwd(*ins, dy, dhl)
    want = MS.mamba2_scan_bwd_ref(*ins, dy, dhl)
    leaves = [None if t is None else t.detach().clone().requires_grad_()
              for t in ins]
    y, h_last = MS.mamba2_scan(*leaves)
    torch.autograd.backward((y, h_last) if dhl is not None else (y,),
                            (dy, dhl) if dhl is not None else (dy,))
    sync()
    what = (f"mamba2_scan_bwd {'x'.join(map(str, shape))} "
            f"{str(dtype)[6:]} h0={h0} dh_last="
            f"{'random' if dh_last else 'none'}{' views' if views else ''}")
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError(f"{what}: a second call differs")
    for i, t in enumerate(leaves):
        if t is not None and not torch.equal(t.grad, got[i]):
            raise AssertionError(f"{what}: autograd's {MAMBA_BWD_NAMES[i]} "
                                 f"differs from the wrapper's")
    if got[0].dtype != dtype:
        raise AssertionError(f"{what}: dx is {got[0].dtype}")
    rel = []
    for i, (a, w) in enumerate(zip(got, want)):
        top = max(float(w.float().abs().max()), 1e-30)
        e = float((a.float() - w.float()).abs().max()) / top
        tol = (MAMBA_BWD_TOL["bfloat16_dx"]
               if i == 0 and dtype == torch.bfloat16
               else MAMBA_BWD_TOL["float32"])
        if not e <= tol:
            raise AssertionError(f"{what}: {MAMBA_BWD_NAMES[i]} differs "
                                 f"from the plain version by {e} of its "
                                 f"largest entry (tolerance {tol})")
        rel.append(e)
    ab = max(float((a.float() - w.float()).abs().max())
             for a, w in zip(got, want))
    return rel, ab


def mamba_bwd_work(b, s, nh, dh, st, elem, h0=True, dh_last=False,
                   chunk=MS.CHUNK):
    """(bytes, FLOP) of one backward call: x, dy, dt, dA, B, C (and h0,
    dh_last where given) read once, dx, ddt, ddA, dB, dC, dh0 written
    once; per tile of n steps the causal pairs' products (C B^T, shared
    by the heads; dy x^T and P^T dy over dh; Q B and Q^T C over st, a
    head each), and per step and head five [dh, st] products (the states
    walked forward again, the gradients walked back, B G^T, dy H, x G)."""
    nbytes = (3 * b * s * nh * dh * elem + 4 * (4 * b * s * nh
              + 4 * b * s * st + (1 + int(h0) + int(dh_last)) * b * nh * dh
              * st))
    pairs = sum(n * (n + 1) // 2 for n in
                [chunk] * (s // chunk) + ([s % chunk] if s % chunk else []))
    flop = (2 * b * pairs * (st + nh * (2 * dh + 2 * st))
            + 5 * 2 * b * s * nh * dh * st)
    new_flops, new_bytes = MS.scan_bwd_cost(b, s, nh, dh, st, elem, h0=h0,
                                            dh_last=dh_last)
    return reckoned("mamba_bwd", (new_bytes, new_flops), (nbytes, flop))


MSB_KERNELS = ("msb_walk_kernel", "msb_pass_kernel", "msb_chunk_kernel",
               "msb_sum_kernel")


def mamba_bwd_plan(b, s, nh, dh, st) -> dict:
    """The backward's head groups at a shape (``MS.bwd_groups``, the
    library's choice) and its scratch bytes (the library's)."""
    lib = _build.lib("mamba_scan_bwd")
    return {"head_groups": MS.bwd_groups(b, s, nh),
            "scratch_bytes": 4 * lib.mamba2_scan_bwd_scratch(b, s, nh, dh,
                                                             st)}


def mamba_bwd_one_step_exact(x, dt, dA, B, C, dy, absolute=False):
    """The six gradients of one step (s 1, a zero h0, no dh_last) in fp64,
    from their closed forms; ``absolute``: each entry's sum of the
    absolute values of its terms instead (ddA's two cancelling score
    terms included)."""
    f = (lambda v: v.double().abs()) if absolute else (lambda v: v.double())
    x, dy, B, C = f(x[:, 0]), f(dy[:, 0]), f(B[:, 0]), f(C[:, 0])
    dt, dA = dt[:, 0].double(), dA[:, 0].double()     # [b, nh], dt > 0
    cb = (C * B).sum(-1)                                     # [b]
    xdy = (x * dy).sum(-1)                                   # [b, nh]
    q = (dt * xdy).sum(-1)                                   # [b]
    dx = dt[..., None] * cb[:, None, None] * dy
    ddt = cb[:, None] * xdy
    ddA = (2 * dt * cb[:, None] * xdy if absolute
           else torch.zeros_like(dt))
    dB, dC = q[:, None] * C, q[:, None] * B
    dh0 = torch.exp(dA)[..., None, None] * dy[..., None] * C[:, None, None]
    return (dx[:, None], ddt[:, None], ddA[:, None], dB[:, None],
            dC[:, None], dh0)


def mamba_bwd_cancel_case(gen, dev):
    """MAMBA_BWD_CANCEL in fp32: the kernels' gradients and the fp32 plain
    version's, each against the fp64 closed form, measured against each
    gradient's largest sum of absolute terms; the kernels' held to
    MAMBA_BWD_TOL of it. Also a second call bit-equal."""
    ins, dy, _ = mamba_bwd_inputs(gen, dev, torch.float32, MAMBA_BWD_CANCEL,
                                  "zero", False, False)
    got = MS.mamba2_scan_bwd(*ins, dy, None)
    again = MS.mamba2_scan_bwd(*ins, dy, None)
    plain = MS.mamba2_scan_bwd_ref(*ins, dy, None)
    x, dt, dA, B, C, _ = ins
    exact = mamba_bwd_one_step_exact(x, dt, dA, B, C, dy)
    terms = mamba_bwd_one_step_exact(x, dt, dA, B, C, dy, absolute=True)
    sync()
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError("mamba2_scan_bwd one step: a second call differs")
    out = {}
    for k, g, p, e, a in zip(MAMBA_BWD_NAMES, got, plain, exact, terms):
        scale = max(float(a.max()), 1e-30)
        kern = float((g.double() - e).abs().max()) / scale
        out[k] = {"kernel": kern,
                  "plain_fp32": float((p.double() - e).abs().max()) / scale,
                  "kernel_of_largest_entry": float(
                      (g.double() - e).abs().max())
                  / max(float(e.abs().max()), 1e-30),
                  "plain_fp32_of_largest_entry": float(
                      (p.double() - e).abs().max())
                  / max(float(e.abs().max()), 1e-30)}
        if not kern <= MAMBA_BWD_TOL["float32"]:
            raise AssertionError(f"mamba2_scan_bwd one step: {k} is {kern} "
                                 f"of its largest sum of absolute terms "
                                 f"from the fp64 closed form")
    return out


def mamba_bwd_timing(gen, dev, shape, what):
    """One backward call as the model's training makes it (fp32 x, a zero
    h0, no gradient of h_last): its six gradients against the plain
    version's on the same inputs (MAMBA_BWD_TOL of each one's largest
    entry), its time, the device time of the whole call and of each
    launch, the forward's device time on the same inputs, the plain
    version's time and the bound."""
    ins, dy, _ = mamba_bwd_inputs(gen, dev, torch.float32, shape, "zero",
                                  False, False)
    run = lambda: MS.mamba2_scan_bwd(*ins, dy, None)  # noqa: E731
    got, want = run(), MS.mamba2_scan_bwd_ref(*ins, dy, None)
    rel, ab = {}, 0.0
    for k, a, w in zip(MAMBA_BWD_NAMES, got, want):
        d = float((a - w).abs().max())
        rel[k] = d / max(float(w.abs().max()), 1e-30)
        ab = max(ab, d)
        if not rel[k] <= MAMBA_BWD_TOL["float32"]:
            raise AssertionError(f"mamba2_scan_bwd at {what}: {k} differs "
                                 f"from the plain version by {rel[k]} of "
                                 f"its largest entry")
    del got, want
    events = device_events(run, iters=5)
    per = {}
    for sym in MSB_KERNELS:
        t = [device_us(e) for e in events if sym in e.name]
        per[sym] = sum(t) / 5 / 1e3 if t else None
    b_ms, b_by = bound(*mamba_bwd_work(*shape, 4))
    b, s, nh, dh, st = shape
    return {"kernel": "mamba2_scan_bwd", "shape": f"b{b} s{s} nh{nh} dh{dh} "
            f"st{st} fp32 x, zero h0, no dh_last ({what})",
            "plan": mamba_bwd_plan(*shape),
            "ms": time_ms(run, iters=10, warm=2),
            "device_ms": call_device_ms(run, iters=5),
            "device_launches": device_launches(run, iters=5),
            "device_ms_by_launch": per,
            "forward_device_ms": call_device_ms(
                lambda: MS.mamba2_scan(*ins), iters=5),
            "plain_ms": time_ms(lambda: MS.mamba2_scan_bwd_ref(
                *ins, dy, None), iters=2, warm=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_tc_ms": bound(*mamba_bwd_work(*shape, 4),
                                 TF32_OPS_S / 3)[0],
            "library_ms": None,
            "library": "none: no single PyTorch call computes the SSD scan "
                       "or its gradient",
            "max_err_of_largest_entry": rel, "max_abs_err": ab}


def phase_kernels_mamba_bwd(dev, card):
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    rel = dict.fromkeys(MAMBA_BWD_NAMES, 0.0)
    err, n = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in MAMBA_BWD_CASES:
            for h0, dh_last, views in MAMBA_BWD_VARIANTS:
                r, a = mamba_bwd_case(gen, dev, dtype, shape, h0, dh_last,
                                      views)
                for k, e in zip(MAMBA_BWD_NAMES, r):
                    rel[k] = max(rel[k], e)
                err, n = max(err, a), n + 1
    cancel = mamba_bwd_cancel_case(gen, dev)
    emit({"phase": "kernels_mamba_bwd", "card": card, "cases": n + 1,
          "tolerance_of_largest_entry": MAMBA_BWD_TOL,
          "max_err_of_largest_entry": rel, "max_abs_err": err,
          "one_step_against_fp64 (of the largest sum of absolute terms)":
              cancel,
          "repeat_runs": "bit-equal", "autograd": "equal to the wrapper"})
    rows = {"mamba2_scan_bwd_main": mamba_bwd_timing(
                gen, dev, MAMBA_TRAIN, "zamba2's training shape"),
            "mamba2_scan_bwd_alt": dict(mamba_bwd_timing(
                gen, dev, MAMBA_SERVE, "zamba2's 300-token serve prefill"),
                alt="s300")}
    for row in rows.values():
        emit({"phase": "kernel_timing", "card": card, **row})
        err = max(err, row["max_abs_err"])
    torch.cuda.empty_cache()
    return rows, {"mamba2_scan_bwd": err}


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
# the new archs' serve paths at full width (phase_serve's arguments), run
# before the others: gemma3's 1,200-token prompt crosses its local layers'
# 1,024-token window in the flash prefill and the paged decode;
# falcon-mamba's 300-token prompt crosses its Mamba1 scan's 256-step chunk.
# The three attention archs are held to the fixed logit bound;
# falcon-mamba to the bound measured in the same call (as zamba2): the
# fixed 0.05 did not hold there (0.051-0.061 over 112 steps, on the card).
# The MoE, frontend and encoder-decoder archs: granite-moe-1b and
# phi3.5-moe with the launcher's prompts; phi3.5 at 28 of its 32 layers
# (its 41.7 B bf16 parameters, 83.5 GB, do not fit one card beside the
# CUDA context; 28 layers are 73.1 GB); internvl2 with a [256, 896]
# frontend on every request (its prefill attends 256 + 8-24 positions);
# seamless with [1,024, 1,024] encoder frames on every request (its
# prefill runs 24 encoder layers non-causal over 1,024 frames and 24
# cross attentions of 8-24 queries over them). All four are held to the
# fixed logit bound: their first card run measured 0.006-0.017 on the
# three decoder-only paths (bf16 references 0.005-0.019 from fp32), the
# MoE paths with 1.3-2.8 % of (token, layer) routings flipped by bf16
# near-ties; those flips stay reported, not failed.
NEW_SERVE = {
    "serve_gemma3": ("gemma3-27b", dict(max_seq=1536, long_prompt=1200)),
    "serve_gemma2": ("gemma2-2b", dict(max_seq=256)),
    "serve_starcoder2": ("starcoder2-7b", dict(max_seq=256)),
    "serve_falcon_mamba": ("falcon-mamba-7b",
                           dict(max_seq=512, long_prompt=300, atol=None)),
    "serve_granite_moe": ("granite-moe-1b-a400m", dict(max_seq=256)),
    "serve_phi35_moe": ("phi3.5-moe-42b-a6.6b", dict(max_seq=256,
                                                     layers=28)),
    "serve_internvl2": ("internvl2-1b", dict(max_seq=512)),
    "serve_seamless": ("seamless-m4t-large-v2", dict(max_seq=256)),
}
EXTRAS_SCALE = 0.02   # the reference's test_serving_engine.py:58-60


def serve_prompts(cfg, n=6, seed=SEED):
    """launch/serve.py's default traffic: n prompts of 8-24 tokens."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=int(rng.integers(8, 24)))
            .astype(np.int32) for _ in range(n)]


def serve_extras(cfg, n, seed):
    """n requests' extras, drawn as the reference's serving test draws
    them (standard normal × 0.02, fp32): a vision frontend's patch
    embeddings or an encoder-decoder's frames, [frontend_len, d] each;
    None for a text-only arch."""
    if cfg.frontend != "vision" and not cfg.is_encdec:
        return [None] * n
    key = "enc_frames" if cfg.is_encdec else "frontend"
    rng = np.random.default_rng(seed)
    return [{key: (rng.standard_normal((cfg.frontend_len, cfg.d_model))
                   * EXTRAS_SCALE).astype(np.float32)} for _ in range(n)]


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

    guarded.__wrapped__ = fn
    setattr(obj, name, guarded)


class Int8Reference:
    """The int8 engine's arithmetic in the dense, kernel-free reference:
    while active, ``TF.decode_step``'s attention (``attention_decode``)
    attends its own token unquantized (the island's self term) and then
    stores it quantized and dequantized (``serving/paged.quantize_kv``, as
    the island writes it) for the later steps of the sequences in ``on``;
    :meth:`install` quantizes a sequence's prompt positions, as the
    engine's prefill installs them. The dense cache holds fp32, so the
    dequantized values are the kernel's."""

    def __init__(self):
        self.on = None   # [b] bool: sequences past their prompt

    def install(self, cache, seq: int, n: int):
        for k, v in (("k", "v"), ("shared_k", "shared_v")):
            if k in cache:
                kv = torch.stack([cache[k][:, seq, :n], cache[v][:, seq, :n]],
                                 dim=2)
                q, sc = PG.quantize_kv(kv)
                deq = q.float() * sc[..., None]
                cache[k][:, seq, :n] = deq[:, :, 0]
                cache[v][:, seq, :n] = deq[:, :, 1]

    def __enter__(self):
        from repro_torch.models.layers import attention as AT

        def attention_decode(params, cfg, x, cache_k, cache_v, lengths, *,
                             theta, window=0):
            # models/layers/attention.attention_decode over an fp32 cache
            b, L, kh, hd = cache_k.shape
            q, k, v = AT.qkv_project(params, cfg, x, lengths[:, None], theta)
            bi = torch.arange(b, device=x.device)
            kv = torch.stack([k[:, 0], v[:, 0]], 1).float()
            cache_k[bi, lengths] = kv[:, 0]   # its own token, unquantized
            cache_v[bi, lengths] = kv[:, 1]
            g = cfg.n_heads // kh
            qg = q.reshape(b, kh, g, hd).float() * AT._scale(cfg)
            s = AT._softcap(torch.einsum("bkgd,bskd->bkgs", qg, cache_k),
                            cfg.attn_softcap)
            pos = torch.arange(L, device=x.device)
            mask = pos[None, :] <= lengths[:, None]
            if window and window > 0:
                mask &= (lengths[:, None] - pos[None, :]) < window
            p = torch.softmax(torch.where(mask[:, None, None], s, AT.NEG_INF),
                              dim=-1)
            o = torch.einsum("bkgs,bskd->bkgd", p, cache_v)
            o = o.reshape(b, 1, cfg.n_heads, hd).to(x.dtype)
            # later steps read it as the island wrote it
            qz, sc = PG.quantize_kv(kv)
            deq = qz.float() * sc[..., None]
            m = self.on[:, None, None]
            cache_k[bi, lengths] = torch.where(m, deq[:, 0], kv[:, 0])
            cache_v[bi, lengths] = torch.where(m, deq[:, 1], kv[:, 1])
            return AT.out_project(params, o), cache_k, cache_v

        self._orig = TF.attention_decode
        TF.attention_decode = attention_decode
        return self

    def __exit__(self, *exc):
        TF.attention_decode = self._orig


@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name`` set to ``value`` while the block runs."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


class RouteRecorder:
    """While active, keeps the expert ids of every call of the MoE
    router's top-k (``moe.top_k``), in call order (``out``): an eager
    call's ids, or, for a call recorded while a CUDA graph is captured,
    the graph's own tensor, which each replay rewrites (holding it keeps
    the graph from reusing its memory)."""

    def __init__(self):
        self.out = []

    def __enter__(self):
        orig = self._orig = MOE.top_k

        def top_k(probs, k):
            vals, idx = orig(probs, k)
            self.out.append(idx)
            return vals, idx
        MOE.top_k = top_k
        return self

    def __exit__(self, *exc):
        MOE.top_k = self._orig


class DenseStep:
    """``TF.decode_step`` for ``b`` sequences over static token and length
    buffers, captured as one CUDA graph: the same plain PyTorch ops,
    replayed (an eager step of a deep model is bound by the host's
    launches: 127-160 ms a step of gemma3-27b, whose weights take 16 ms to
    read). The warm-up step's writes into ``cache`` are zeroed (the
    cross K/V ``enc_k`` / ``enc_v``, which a step only reads, are kept). A
    call returns the step's logits as a tensor of its own.

    ``frontend``: a vision frontend's embeddings [b, fl, d] on the card;
    a step before position ``fl`` takes its row there instead of its
    token's embedding (the engine's prefill places them first).
    ``routes``: record the MoE router's expert ids of every step
    (:meth:`route_ids`)."""

    def __init__(self, cfg, params, cache, b, dev, frontend=None,
                 routes=False):
        self.toks = torch.zeros(b, dtype=torch.long, device=dev)
        self.lens = torch.zeros(b, dtype=torch.long, device=dev)
        self.frontend = frontend
        self.fe = torch.zeros((b, 1, cfg.d_model), dtype=cfg.dtype,
                              device=dev)
        self.use_fe = torch.zeros((b, 1, 1), dtype=torch.bool, device=dev)
        embed = TF.embed_tokens

        def embed_or_frontend(params, cfg, tokens):
            return torch.where(self.use_fe, self.fe,
                               embed(params, cfg, tokens))
        with contextlib.ExitStack() as stack:
            if frontend is not None:
                stack.enter_context(patched(TF, "embed_tokens",
                                            embed_or_frontend))
            rec = stack.enter_context(RouteRecorder()) if routes else None
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                TF.decode_step(params, cfg, self.toks, cache, self.lens)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.out = TF.decode_step(params, cfg, self.toks, cache,
                                          self.lens)[0]
        # the capture's router calls, one a layer
        self.routes = rec.out[len(rec.out) // 2:] if routes else []
        tree_map(lambda t: t.zero_(), {k: v for k, v in cache.items()
                                       if k not in ("enc_k", "enc_v")})

    def __call__(self, toks, lengths, t):
        self.toks.copy_(toks)
        self.lens.copy_(lengths)
        if self.frontend is not None:
            inside = t < self.frontend.shape[1]
            self.use_fe.fill_(inside)
            if inside:
                self.fe.copy_(self.frontend[:, t:t + 1])
        self.graph.replay()
        return self.out.clone()

    def route_ids(self):
        """The last step's expert ids, [layers, b, k] on the host."""
        return torch.stack([r.reshape(self.toks.shape[0], -1)
                            for r in self.routes]).cpu()


def encoder_kv(cfg, params, records, dev):
    """Each request's cross K/V from the encoder over its ``enc_frames``,
    kernel-free: the encoder's and cross attention's flash calls take the
    kernel's plain version. Returns (k, v) [L, requests, se, kh, hd]."""
    with patched(AT, "flash_attention", FA.flash_attention_ref):
        kv = [TF.encoder_cross_kv(params, cfg, TF.run_encoder(
            params, cfg, torch.from_numpy(r["extras"]["enc_frames"])[None]
            .to(dev))) for r in records]
    return (torch.cat([k for k, _ in kv], dim=1),
            torch.cat([v for _, v in kv], dim=1))


def routing_flips(records, ref_routes):
    """(token, layer) pairs whose top-k expert sets differ between the
    kernel path (``r["routes"]``: position -> [layers, k]) and the dense
    reference (``ref_routes[t]``: [layers, requests, k]). Returns (pairs
    compared, flips as (request, position, layer))."""
    n, flips = 0, []
    for i, r in enumerate(records):
        for t, got in sorted(r["routes"].items()):
            if t >= len(ref_routes):
                continue
            want = ref_routes[t][:, i]
            for layer in range(got.shape[0]):
                n += 1
                if set(got[layer].tolist()) != set(want[layer].tolist()):
                    flips.append((i, t, layer))
    return n, flips


def teacher_forced(cfg, params, dev, records, atol=SERVE_LOGIT_ATOL):
    """The kernel path's tokens through a dense, kernel-free reference on
    the card: every prompt and its generated tokens go one token a step
    through ``decode_step`` (dense cache, plain attention, the SSM
    recurrence) in one batch, each step one replay of a CUDA graph of its
    plain ops (:class:`DenseStep`; eager with ``kv_quant_int8``, whose
    reference changes per step). A vision frontend's embeddings go first,
    one a step; an encoder-decoder's cross K/V come from the encoder run
    kernel-free (:func:`encoder_kv`). The reference's logits after the
    prompt's last position must match the prefill's, and after each
    generated token the next round's, within ``atol``; where the
    reference's top-2 margin exceeds that tolerance the kernel path must
    have picked the reference's token. For an MoE the experts each
    (token, layer) was routed to are compared too (``r["routes"]``):
    the flips are reported, not failed (a near-tie that bf16 rounding tips
    the other way).

    ``atol=None`` sets the tolerance from bf16's own error: the same
    reference also runs in fp32 (the weights' values cast up), and the
    kernel path may differ from the bf16
    reference by at most twice the bf16 reference's largest distance from
    the fp32 run on the checked steps (the kernel path then computes no
    worse than a kernel-free bf16 evaluation of the same model, within a
    factor of two).

    With ``cfg.kv_quant_int8`` both runs quantize K/V as the int8 engine
    does (:class:`Int8Reference`): a prompt's K/V when it ends, each later
    token's after its own step."""
    quant = cfg.kv_quant_int8
    vision = cfg.frontend == "vision"
    prefix = cfg.frontend_len if vision else 0
    seqs = [[0] * prefix + list(r["prompt"]) + r["generated"][:-1]
            for r in records]
    steps = max(len(x) for x in seqs)
    runs = [(cfg, params)]
    if atol is None:
        runs.append((dataclasses.replace(cfg, dtype=torch.float32),
                     tree_map(lambda t: t.float(), params)))
    enc_len = cfg.frontend_len if cfg.is_encdec else 0
    caches = [TF.init_cache(c, len(seqs), steps + 1, dev, enc_len=enc_len)
              for c, _ in runs]
    for (c, p), cache in zip(runs, caches):
        if enc_len:
            cache["enc_k"], cache["enc_v"] = encoder_kv(c, p, records, dev)
    frontend = None
    if vision:
        frontend = torch.stack([torch.from_numpy(r["extras"]["frontend"])
                                for r in records]).to(dev)
    int8 = Int8Reference()
    if quant:   # fp32 caches: the dequantized values are the kernel's
        caches = [{k: (v.float() if k != "ssm" else v) for k, v in c.items()}
                  for c in caches]
    else:
        dense = [DenseStep(c, p, cache, len(seqs), dev,
                           frontend=None if frontend is None
                           else frontend.to(c.dtype),
                           routes=cfg.is_moe and n == 0)
                 for n, ((c, p), cache) in enumerate(zip(runs, caches))]
    ref_routes = []
    pairs = []   # (request, step, kernel path's logits, reference, fp32 run)
    for t in range(steps):
        toks = torch.tensor([x[t] if t < len(x) else 0 for x in seqs],
                            device=dev)
        lengths = torch.full((len(seqs),), t, device=dev)
        if quant:
            for i, r in enumerate(records):
                if t == len(r["prompt"]):   # the prompt was installed
                    for cache in caches:
                        int8.install(cache, i, t)
            int8.on = torch.tensor([t >= len(r["prompt"]) for r in records],
                                   device=dev)
            with int8:
                outs = [TF.decode_step(p, c, toks, cache, lengths)[0][
                    :, :cfg.vocab] for (c, p), cache in zip(runs, caches)]
        else:
            outs = [step(toks, lengths, t)[:, :cfg.vocab] for step in dense]
            if cfg.is_moe:
                ref_routes.append(dense[0].route_ids())
        for i, r in enumerate(records):
            j = t - (prefix + len(r["prompt"]) - 1)
            if 0 <= j < len(r["logits"]):
                pairs.append((i, j, r["logits"][j][:cfg.vocab],
                              *(o[i] for o in outs)))
    out = {}
    if cfg.is_moe:
        n, flips = routing_flips(records, ref_routes)
        out = {"routing_pairs_compared": n, "routing_flips": len(flips),
               "routing_flips_first": flips[:40]}
    if atol is None:
        floor = max(float((ref - ref32).abs().max())
                    for _, _, _, ref, ref32 in pairs)
        atol = 2 * floor
        out |= {"bf16_reference_vs_fp32_max_abs": floor,
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


def release(db) -> None:
    """Drop ``db``'s tables and hand the graphs' pools and the cached
    blocks of everything no longer referenced back to the card."""
    for name in list(db.tables):
        db.execute(f"DROP TABLE {name}")
    sync()
    EC._sweep()
    gc.collect()
    torch.cuda.empty_cache()


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def phase_serve(card, dev, hold, arch="yi-6b", max_seq=256, long_prompt=0,
                name="serve", atol=SERVE_LOGIT_ATOL, bf16=None, keep=True,
                layers=0):
    """``arch`` at full width through ServeEngine, as launch/serve.py
    drives it (plus, with ``long_prompt``, one prompt of that many tokens,
    admitted first), then one evict_user and one flush. ``hold`` keeps
    the engine for the profile phase and the launch counts the path must
    show. ``bf16``: the ``hold`` of the same arch's bf16 path, whose
    weights this path reuses with the int8 arena (``kv_quant_int8``, as
    the reference reaches it), comparing arenas and greedy tokens.
    ``keep=False``: the engine (its decode graph and pool) is dropped
    before the dense reference runs and ``hold`` keeps no engine or
    weights, so that the card's memory holds one large model at a time.
    ``layers``: serve the first ``layers`` layers only (phi3.5-moe's cut
    to fit the card). Requests carry the arch's extras
    (:func:`serve_extras`); an MoE's routing (each token's experts in
    every layer, prefill and rounds) is recorded for the dense reference
    to compare."""
    cfg = configs.get_config(arch)
    published_layers = cfg.n_layers
    if layers:   # a uniform pattern: its first ``layers`` kinds
        cfg = dataclasses.replace(cfg, n_layers=layers,
                                  layer_pattern=cfg.layer_pattern[:layers])
    if bf16 is not None:
        cfg = dataclasses.replace(cfg, kv_quant_int8=True)
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)   # earlier paths' engines
    t0 = time.perf_counter()
    params = (bf16["params"] if bf16 is not None else
              TF.init_model(torch.Generator(device=dev).manual_seed(SEED),
                            cfg, dev))
    sync()
    init_s = time.perf_counter() - t0
    eng = ServeEngine(cfg, params, max_slots=4, max_seq=max_seq,
                      block=SERVE_BLOCK, device=dev)
    log = KvLog(eng.daemon)
    graph = eng._step   # the decode round's ServeGraph
    host = {}
    guard(eng, "_insert_blocks", host)
    guard(eng, "_step", host)   # staging, prime, capture and replays

    pending = list(zip(serve_prompts(cfg), serve_extras(cfg, 6, SEED + 5)))
    if long_prompt:
        pending.append((np.random.default_rng(SEED + 3).integers(
            0, cfg.vocab, size=long_prompt).astype(np.int32),
            serve_extras(cfg, 1, SEED + 6)[0]))
    records, by_slot = [], {}
    prefill_ms, round_ms, finish_ms, freed = [], [], [], []
    done, tokens_out = 0, 0
    routes = RouteRecorder() if cfg.is_moe else contextlib.nullcontext()
    graph_routes = None   # the decode round's router outputs, one a layer
    t_serve = time.perf_counter()
    total = len(pending)
    with routes:
        while done < total:
            while pending and len(eng.requests) < eng.max_slots:
                prompt, extras = pending.pop()
                n0 = len(routes.out) if cfg.is_moe else 0
                t0 = time.perf_counter()
                slot = eng.add_request(prompt, user_id=done + len(pending),
                                       extras=extras)
                prefill_ms.append((time.perf_counter() - t0) * 1e3)
                rec = {"prompt": prompt, "extras": extras,
                       "logits": [eng.prefill_logits.clone()], "routes": {}}
                if cfg.is_moe:   # [layers, positions, k]
                    ids = torch.stack([r.reshape(len(prompt), -1)
                                       for r in routes.out[n0:]]).cpu()
                    rec["routes"] = {t: ids[:, t] for t in range(len(prompt))}
                records.append(rec)
                by_slot[slot] = rec
            n0 = len(routes.out) if cfg.is_moe else 0
            t0 = time.perf_counter()
            eng.decode_round()
            round_ms.append((time.perf_counter() - t0) * 1e3)
            tokens_out += len(eng.requests)
            if cfg.is_moe:
                # a replay records nothing: its ids are in the tensors the
                # capture recorded (the round's last layer-many calls)
                if len(routes.out) > n0:
                    graph_routes = routes.out[-cfg.n_layers:]
                ids = torch.stack([r.reshape(eng.max_slots, -1)
                                   for r in graph_routes]).cpu()
            for s in eng.requests:
                by_slot[s]["logits"].append(eng.logits[s].clone())
                if cfg.is_moe:   # the position this round consumed
                    by_slot[s]["routes"][int(eng.lengths[s]) - 1] = ids[:, s]
            for s in [s for s, r in eng.requests.items()
                      if len(r.generated) >= 16]:
                by_slot[s]["generated"] = list(eng.requests[s].generated)
                n_tok = int(eng.lengths[s])
                t0 = time.perf_counter()
                n = eng.finish_request(s)
                finish_ms.append((time.perf_counter() - t0) * 1e3)
                # an attention-free stack allocates no block (the
                # reference's engine neither)
                if n != (-(-n_tok // SERVE_BLOCK) if eng.attends else 0):
                    raise AssertionError(f"finish_request freed {n} blocks "
                                         f"for {n_tok} tokens")
                freed.append(n)
                done += 1
    if cfg.is_moe:   # hand the decode graph's outputs back with the graph
        graph_routes = None
        routes.out.clear()
    serve_s = time.perf_counter() - t_serve
    if eng.live_blocks() != 0:
        raise AssertionError(f"{eng.live_blocks()} blocks live after every "
                             f"request finished")
    for r in records:  # the prefill's logits, then one per round
        if len(r["logits"]) != len(r["generated"]):
            raise AssertionError("a request's logits and tokens disagree")
    # one session eviction and one flush over fresh requests
    extra = serve_prompts(cfg, 3, seed=SEED + 1)
    for i, (prompt, extras) in enumerate(zip(
            extra, serve_extras(cfg, 3, SEED + 7))):
        eng.add_request(prompt, user_id=100 + (i % 2), extras=extras)
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
    graph_info = {"graph_capture_ms": graph.capture_ms,
                  "graph_pool_bytes": graph_pool_bytes(graph.pool),
                  "graph_launches_per_round": graph.launches}
    daemon = eng.daemon
    if not keep:   # the dense reference runs without the engine beside it
        del eng, graph, log
        release(daemon)
    if atol is None and bf16 is not None:
        # the bound the bf16 path measured in this run on the same weights
        # (twice the bf16 reference's distance from fp32): the fp32 run is
        # not repeated
        atol = bf16["atol"]
    t0 = time.perf_counter()
    tf = teacher_forced(cfg, params, dev, records, atol)
    tf_s = time.perf_counter() - t0
    peak_tf_gb = (torch.cuda.max_memory_allocated(dev) - resident) / 1e9
    n_rounds = len(round_ms)
    prefills, rounds = len(records) + len(extra), n_rounds + extra_rounds
    attn = TF.n_attn_layers(cfg) + cfg.n_shared_applications()
    # flash: every attention layer's prefill, and an encoder-decoder's
    # encoder layers and cross attentions; paged attention: every replayed
    # round, and the capture's prime round
    flash = attn + (cfg.enc_layers + cfg.n_layers if cfg.is_encdec else 0)
    quant = {}
    if bf16 is not None:
        quant = int8_report(eng, bf16, records)
    want = {"flash_attention": flash * prefills,
            "paged_attention": attn * (rounds + 1),
            "mamba2_scan": cfg.layer_pattern.count(MAMBA2) * prefills}
    if keep:
        hold.update(eng=eng, cfg=cfg, params=params, records=records)
    hold.update(atol=tf["atol"], want=want)
    lens = [len(r["prompt"]) for r in records]
    emit({"phase": name, "card": card, "arch": cfg.name,
          "layers": cfg.n_layers, "published_layers": published_layers,
          "extras": sorted(records[0]["extras"] or ()),
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
          **graph_info,
          "warm_round_launch_calls": warm,
          "finish_request_ms": [round(x, 3) for x in finish_ms],
          "freed_blocks": freed, "evict_user_blocks": evicted,
          "flush_blocks": flushed, "kv_replay": replay,
          "peak_memory_gb": peak_gb,
          "peak_memory_gb_with_dense_reference": peak_tf_gb,
          "resident_before_gb": resident / 1e9,
          "launches_expected": want,
          "teacher_forced": tf, "teacher_forced_s": tf_s, **quant})


def int8_report(eng, bf16, records) -> dict:
    """The int8 engine beside the bf16 one of the same weights and
    traffic: arena and scale bytes per token, and how many greedy tokens
    agree (prompt by prompt, position by position)."""
    ref = bf16["eng"]
    cfg = eng.cfg
    out = {"arena_bytes": {}, "arena_bytes_bf16": {}}
    for name in ("arena", "shared_arena"):
        if name in eng.state:
            a, sc = eng.state[name], eng.state[name + "_scale"]
            out["arena_bytes"][name] = a.numel() * a.element_size()
            out["arena_bytes"][name + "_scale"] = (sc.numel()
                                                   * sc.element_size())
            b = ref.state[name]
            out["arena_bytes_bf16"][name] = b.numel() * b.element_size()
    total = sum(out["arena_bytes"].values())
    out["bytes_ratio_to_bf16"] = total / sum(out["arena_bytes_bf16"].values())
    hd = cfg.head_dim
    out["bytes_ratio_formula"] = f"(hd + 4) / (2 hd) = {(hd + 4) / (2 * hd)}"
    want = {tuple(r["prompt"].tolist()): r["generated"]
            for r in bf16["records"]}
    agree = n = 0
    first = []   # each request's first position where the two part
    for r in records:
        other = want[tuple(r["prompt"].tolist())]
        pairs = list(zip(r["generated"], other))
        n += len(pairs)
        agree += sum(a == b for a, b in pairs)
        first.append(next((j for j, (a, b) in enumerate(pairs) if a != b),
                          None))
    out["greedy_tokens_agree_with_bf16"] = [agree, n]
    out["first_disagreement_per_request"] = first
    return out


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
    """Device bytes held in the table's CUDA-graph memory pools (one a
    device its plans run on)."""
    return sum(graph_pool_bytes(p)
               for p in db.tables[table].execs._pools.values())


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


def profiler_edges(n=4) -> dict:
    """How many of a short window's device records the profiler keeps,
    late in the process: ``n`` windows of 5 kernels and 5 host-to-device
    copies (10 records) each. Reported, not checked: it says how far this
    run's short timing windows can be trusted (PERF.md §7)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def window() -> int:
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                torch.zeros(1, device="cuda")
                torch.ones(1).pin_memory().to("cuda", non_blocking=True)
            sync()
        return sum(e.device_type == DeviceType.CUDA for e in prof.events())

    return {"records_a_window": 10, "kept": [window() for _ in range(n)]}


def round_copies(prof, span: str) -> tuple[dict, dict]:
    """The host's launch calls made inside the window's ``span`` (a
    ``record_function`` name), and the card's copies by direction that
    those calls issued, matched by correlation id, not by time: late in a
    long process the profiler dates a window's early device records up
    to milliseconds early (PERF.md §7)."""
    from torch.autograd import DeviceType
    evs = prof.profiler.kineto_results.events()
    s = next(e for e in evs if e.name() == span
             and e.device_type() != DeviceType.CUDA)
    calls = dict.fromkeys(LAUNCH_CALLS, 0)
    issued = set()
    for e in evs:
        if (e.device_type() != DeviceType.CUDA and e.name() in calls
                and s.start_ns() <= e.start_ns() <= s.end_ns()):
            calls[e.name()] += 1
            issued.add(e.correlation_id())
    copies = {"HtoD": 0, "DtoH": 0, "DtoD": 0}
    for e in evs:
        if (e.device_type() == DeviceType.CUDA and "Memcpy" in e.name()
                and e.correlation_id() in issued):
            for k in copies:
                copies[k] += k in e.name()
    return calls, copies


def round_calls(eng) -> tuple[dict, dict]:
    """Two decode rounds under the profiler, the second measured
    (:func:`round_copies`): a record the profiler dates before its
    window's start is dropped, and late in a long process what a window
    does before its first graph launch is dated that early (the int8
    rounds' HtoD; PERF.md §7), so the first round's graph launch opens
    the window."""
    from torch.profiler import ProfilerActivity, profile, record_function
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.decode_round()
        sync()
        with record_function("decode_round"):
            eng.decode_round()
        sync()
    return round_copies(prof, "decode_round")


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
        # neither of round_calls' two rounds may start a block
        while any(eng.lengths[s] % SERVE_BLOCK in (0, SERVE_BLOCK - 1)
                  for s in eng.requests):
            eng.decode_round()
            rounds += 1
        calls, copies = round_calls(eng)
        rounds += 2
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
    release(pr.gpu)
    release(fig.gpu)
    graphs_capture_race(card, torch.device("cuda", 0))


RACE_SHAPES = 24        # fresh statement shapes the capturing thread plans
RACE_ROUNDS = (6, 40)   # the other thread's rounds: at least, at most


def graphs_capture_race(card, dev):
    """Graph destruction against capture: one thread plans RACE_SHAPES
    fresh statement shapes on a card daemon (each a capture on its miss)
    while another builds a card daemon and a yi-6b SMOKE ServeGraph,
    captures in each, drops them in unreachable cycles (freed only by a
    collection) and calls gc.collect(), round after round. Every graph
    destroyed while a capture is open must wait for it
    (``core/execache.capture_guard``): zero failed captures, and every
    shape hits its plan on a second run (no uncached plan). Reports the
    rounds and how many releases were deferred."""
    import threading
    from repro_torch.configs import shapes as SHP
    db = D.SQLCached(warmup=False)
    db.execute("CREATE TABLE race (k INT, v INT) CAPACITY 4096")
    db.executemany("INSERT INTO race (k, v) VALUES (?, ?)",
                   [(i, 2 * i) for i in range(512)])
    db.drain()
    shapes = [f"SELECT v FROM race WHERE k = ? AND v > {i}"
              for i in range(RACE_SHAPES)]
    cfg = configs.get_smoke("yi-6b")
    params = TF.init_model(torch.Generator(device=dev).manual_seed(SEED),
                           cfg, dev)
    shape = SHP.ShapeSpec("race", 64, 4, "decode")
    errors, rounds = [], [0]
    done = threading.Event()
    deferred0 = EC.deferred_total()

    def capture():
        try:
            for i, sql in enumerate(shapes):
                db.execute(sql, (i,)).count
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(("capture", repr(e)))
        finally:
            done.set()

    def churn():
        try:
            while rounds[0] < RACE_ROUNDS[1] and (
                    not done.is_set() or rounds[0] < RACE_ROUNDS[0]):
                d = D.SQLCached(warmup=False)
                d.execute("CREATE TABLE t (k INT, v INT) CAPACITY 256")
                d.execute("INSERT INTO t (k, v) VALUES (?, ?)",
                          (rounds[0], 1))
                d.execute("SELECT v FROM t WHERE k = ?", (rounds[0],)).count
                step, _ = SE.lower_serve_step(cfg, shape, params,
                                              device=dev)
                d.cycle, step.cycle = d, step
                del d, step
                gc.collect()
                rounds[0] += 1
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(("churn", repr(e)))

    threads = [threading.Thread(target=capture),
               threading.Thread(target=churn)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    hung = [t.name for t in threads if t.is_alive()]
    st0 = executors(db, "race")
    for i, sql in enumerate(shapes):
        db.execute(sql, (i,)).count
    st1 = executors(db, "race")
    report = {"phase": "graphs_race", "card": card, "shapes": RACE_SHAPES,
              "churn_rounds": rounds[0], "failed_captures": len(errors),
              "errors": errors[:3], "uncached_plans":
              st1["misses"] - st0["misses"],
              "plans": st1["cached"], "deferred_releases":
              EC.deferred_total() - deferred0}
    emit(report)
    release(db)
    if errors or hung or report["uncached_plans"] or (
            st1["cached"] < RACE_SHAPES):
        raise AssertionError(f"graphs race: {report} (hung: {hung})")


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


# ---------------------------------------------------------------- mesh

# (variant, INDEX, mesh entries, the other mesh size RESTORE goes into)
MESH_VARIANTS = (("plain", "", 2, 4), ("indexed", ", INDEX(page_id)", 4, 2))


def mesh_pair(d):
    """The card daemon with ``d`` devices visible (a SHARDS 8 table is
    placed over a lane mesh of ``d`` entries: distinct cards where there
    are ``d``, else cuda:0 repeated) and an unplaced CPU daemon."""
    pr = Pair.__new__(Pair)
    with MESH.force_device_count(d):
        pr.gpu = D.SQLCached(warmup=False)
    pr.cpu = D.SQLCached(device="cpu", warmup=False, mesh_exec=False)
    pr.lat = {}
    return pr


def mesh_stats_pair(pr, table, d):
    """SHOW STATS on both daemons: equal but for the executors block and
    the placement, which must name the card daemon's mesh."""
    out = []
    for db in (pr.gpu, pr.cpu):
        info = json.loads(db.execute(f"SHOW STATS {table}").value)
        info.pop("executors"), info.pop("device"), info.pop("devices")
        for x in info["per_shard"]:
            x.pop("device")
        out.append(info)
    if out[0] != out[1]:
        raise AssertionError(f"SHOW STATS {table}: {out[0]} vs {out[1]}")
    mesh = pr.gpu.tables[table].mesh
    want = [dv.index or 0 for dv in SH.lane_devices(mesh, 8)]
    stats = json.loads(pr.gpu.execute(f"SHOW STATS {table}").value)
    if stats["devices"] != d or [x["device"] for x in
                                 stats["per_shard"]] != want:
        raise AssertionError(f"SHOW STATS {table}: devices {stats['devices']}"
                             f" / {[x['device'] for x in stats['per_shard']]}"
                             f", mesh {mesh}")
    return out[0]


def mesh_fanout_checks(pr, d, p, u, indexed):
    """A warm fan-out is one graph launch a block plus the merge's, no
    kernel launch, and 2 d + 1 copies (a block's bound values in, its
    packed outputs into the merge's input, the merge's outputs out); its
    replay launches the scan (or the verified probe) once a block and the
    compaction twice a block plus once in the merge. A warm pruned
    statement is one graph launch and two copies."""
    fan = "SELECT * FROM sh WHERE page_id = ? LIMIT 64"
    pruned = "SELECT * FROM sh WHERE user_id = ? LIMIT 64"
    for sql in (fan, pruned):   # the fan-out's blocks and merge, every lane
        for db in (pr.gpu, pr.cpu):
            db.execute(f"WARMUP sh LIKE '{sql}'")
    out = {}
    for label, sql, args, want, copies in (
            ("fanout", fan, [(x,) for x in p[3000:3020]], d + 1, 2 * d + 1),
            ("pruned", pruned, [(x,) for x in u[3000:3020]], 1, 2)):
        pr.run("execute", sql, args[0])       # planned by now
        calls = launch_calls(lambda: [pr.gpu.execute(sql, a) for a in args],
                             len(args))
        for a in args:
            pr.cpu.execute(sql, a)
        if calls["cudaGraphLaunch"] != want or any(
                calls[k] for k in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                   "cuLaunchKernel")) or (
                calls["cudaMemcpyAsync"] != copies):
            raise AssertionError(f"a warm {label} statement over {d} "
                                 f"blocks: {calls}")
        out[f"launch_calls_per_warm_{label}"] = calls
    before = dict(_build.launches)
    pr.gpu.execute(fan, (p[3100],))
    pr.gpu.drain()
    pr.cpu.execute(fan, (p[3100],))
    got = {k: v - before[k] for k, v in _build.launches.items()
           if v != before[k]}
    # the scan (or the probe) once a block; the compaction twice a block
    # (its pairs' candidates, the block's merge) and once in the home merge
    route = "hash_probe" if indexed else "relscan_scan"
    if got.get(route) != d or got.get("relscan_compact", 0) != 2 * d + 1:
        raise AssertionError(f"a fan-out over {d} blocks launched {got}")
    out["kernel_launches_per_fanout"] = got
    return out


def phase_mesh(card):
    """Phase ``shards``'s deployment (Table 2 in SHARDS 8 PARTITION BY
    user_id, without and with INDEX(page_id)) PLACED over lane meshes of
    2 and 4 entries (``launch/mesh.py``; one card: cuda:0 repeated), held
    against an unplaced CPU daemon: the bulk load, per-user (pruned, one
    lane on its block's device) and per-page (fan-out: the stacked
    executors once a block, merged on the home device) statements, SHOW
    STATS's placement, warm replays (a fan-out is one graph launch a
    block plus the merge), four scheduler threads, CHECKPOINT and RESTORE
    into the other mesh size, RESHARD 4 and RESHARD 1. Every result and
    state equals the CPU daemon's and no dispatch syncs. Reports the warm
    p50s of phase ``shards``'s two warmed shapes, pruned and fan-out
    (that phase gives the unplaced table's in the same run)."""
    n_cards = torch.cuda.device_count()
    pages, users, payload = table2_data()
    p, u = pages.tolist(), users.tolist()
    report = {"phase": "mesh", "card": card, "cards": n_cards}
    distinct = 0
    for variant, extra, d, d_other in MESH_VARIANTS:
        pr = mesh_pair(d)
        with MESH.force_device_count(d):
            pr.run("execute", SHARD_DDL.format(extra=extra))
            mesh = pr.gpu.tables["sh"].mesh
            if mesh is None or len(mesh) != d:
                raise AssertionError(f"SHARDS 8 over {d} devices: mesh {mesh}")
            distinct = max(distinct, len(set(mesh)))
            t0 = time.perf_counter()
            pr.run("executemany",
                   "INSERT INTO sh (page_id, user_id, data) VALUES (?, ?, ?)",
                   list(zip(p, u, payload.tolist())), label="bulk_load")
            load_s = time.perf_counter() - t0
            mesh_stats_pair(pr, "sh", d)
            shard_statements(pr, p, u, 0)
            warm = mesh_fanout_checks(pr, d, p, u, bool(extra))
            # warm p50s of phase shards's warmed shapes, as it times them
            warm_stmts = (("warm_pruned", "SELECT data FROM sh WHERE "
                           "user_id = ?", lambda i: (u[100 + i],)),
                          ("warm_fanout", "SELECT user_id FROM sh WHERE "
                           "page_id = ?", lambda i: (p[900 + i],)))
            for _, sql, _ in warm_stmts:
                for db in (pr.gpu, pr.cpu):
                    db.execute(f"WARMUP sh LIKE '{sql}'")
            for i in range(20):
                for label, sql, args in warm_stmts:
                    pr.run("execute", sql, args(i), label=label)
            sched = scheduler_writes(pr, p, u)
            dirs, _ = checkpoint_pair(pr, "sh", f"mesh-{variant}")
            # RESTORE into the other mesh size (a fresh card daemon)
            other = mesh_pair(d_other)
            with MESH.force_device_count(d_other):
                other.run("execute", SHARD_DDL.format(extra=extra)
                          .replace(" sh ", " r8 "))
                if len(other.gpu.tables["r8"].mesh) != d_other:
                    raise AssertionError("RESTORE's table is not placed")
                timed(other, "restore_ms",
                      [f"RESTORE r8 FROM '{dd}'" for dd in dirs])
                same_state(other, "r8", f"mesh {variant}: RESTORE into "
                                        f"{d_other} blocks")
                snap_statements(other, "r8", p, u, 30)
            del other
            admin_pair(pr, "ALTER TABLE sh RESHARD 4")
            if len(pr.gpu.tables["sh"].mesh) != min(d, 4):
                raise AssertionError("RESHARD 4 did not re-place the table")
            same_state(pr, "sh", f"mesh {variant} after RESHARD 4")
            snap_statements(pr, "sh", p, u, 40)
            admin_pair(pr, "ALTER TABLE sh RESHARD 1")
            if pr.gpu.tables["sh"].mesh is not None:
                raise AssertionError("RESHARD 1 left a mesh")
            snap_statements(pr, "sh", p, u, 50)
            same_state(pr, "sh", f"mesh {variant} at the end")
        report[variant] = {
            "mesh": [str(x) for x in mesh], "load_s": round(load_s, 3),
            **warm, "scheduler": sched,
            "executors": executors(pr.gpu, "sh"),
            "wall_p50_us": {k: round(p50(v), 1) for k, v in pr.lat.items()
                            if not k.endswith("_ms")}}
        for db in (pr.gpu, pr.cpu):
            db.execute("DROP TABLE sh")
    report["distinct_devices"] = distinct
    print(f"distinct_devices {distinct}", flush=True)
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

    fam = {"gemm": 0.0, "mamba2_scan": 0.0, "mamba2_scan_bwd": 0.0,
           "flash_attention": 0.0,
           "flash_attention_bwd": 0.0, "paged_attention": 0.0,
           "sql_kernels": 0.0, "copies": 0.0, "other": 0.0}
    top = {}
    for e in dev:
        name, t = e.name, t_of(e)
        if "emcpy" in name or "emset" in name:
            fam["copies"] += t
        elif "ms_state_kernel" in name or "ms_chunk_kernel" in name:
            fam["mamba2_scan"] += t
        elif any(w in name for w in MSB_KERNELS):
            fam["mamba2_scan_bwd"] += t
        elif "paged_split_kernel" in name:
            fam["paged_attention"] += t
        elif "flash_kernel" in name:
            fam["flash_attention"] += t
        elif any(w in name for w in ("dkdv_kernel", "dq_kernel",
                                     "delta_kernel")):
            fam["flash_attention_bwd"] += t
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


def ms_by_launch(events, calls):
    """Device ms a call of each kernel among ``events`` (by its function's
    name; other activities by their own)."""
    out: dict = {}
    for e in events:
        m = re.search(r"\b(\w+_kernel)\b", e.name)
        name = m.group(1) if m else e.name
        out[name] = out.get(name, 0.0) + device_us(e) / calls / 1e3
    return out


def comparable_ssd_rows(dev):
    """The Mamba2 SSD scan and its backward as whole calls (``mamba2_scan``
    and ``mamba2_scan_bwd``, the same wrappers in this tree and its
    parent). The forward at zamba2's 300- and 24-token prefills and its
    training shape (fp32 x, zero h0, seeded inputs): the device time of
    every launch of one call, its launches and the SHA-256 of y and
    h_last, so two trees' outputs can be compared bit for bit. The
    backward at the training shape and the 300-token prefill (fp32 x,
    zero h0, no dh_last): the same times, the call's time from events and
    the bytes the call allocates beyond its outputs (the scratch)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    rows = {}
    for what, shape in (("zamba2 300-token prefill", MAMBA_SERVE),
                        ("zamba2 24-token prefill", MAMBA_SHORT),
                        ("zamba2 training shape", MAMBA_TRAIN)):
        args = mamba_inputs(gen, dev, torch.float32, *shape, False)
        run = lambda: MS.mamba2_scan(*args)  # noqa: E731
        y, h = run()
        digest = hashlib.sha256()
        for out in (y, h):
            digest.update(out.contiguous().cpu().numpy().tobytes())
        events = device_events(run, iters=20)
        rows[f"mamba2_scan, {what}"] = {
            "device_ms": sum(device_us(e) for e in events) / 20 / 1e3,
            "device_launches": len(events) / 20,
            "device_ms_by_launch": ms_by_launch(events, 20),
            "outputs_sha256": digest.hexdigest()}
        del args, y, h
    for what, shape in (("zamba2 training shape", MAMBA_TRAIN),
                        ("zamba2 300-token prefill", MAMBA_SERVE)):
        ins, dy, _ = mamba_bwd_inputs(gen, dev, torch.float32, shape,
                                      "zero", False, False)
        run = lambda: MS.mamba2_scan_bwd(*ins, dy, None)  # noqa: E731
        out = run()
        sync()
        outs = sum(t.numel() * t.element_size() for t in out)
        del out
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        run()
        sync()
        events = device_events(run, iters=10)
        rows[f"mamba2_scan_bwd, {what}"] = {
            "device_ms": sum(device_us(e) for e in events) / 10 / 1e3,
            "device_launches": len(events) / 10,
            "device_ms_by_launch": ms_by_launch(events, 10),
            "ms": time_ms(run, iters=20, warm=3),
            "call_peak_bytes_beyond_outputs":
                torch.cuda.max_memory_allocated(dev) - base - outs}
        del ins, dy
        torch.cuda.empty_cache()
    return rows


def comparable_flash_bwd_rows(dev):
    """The flash backward as a whole call (``flash_attention_bwd``, the
    same wrapper in this tree and its parent) at gemma2-2b's training
    shape (global and window 4,096, softcap 50) and zamba2-2.7b's (b 1,
    h 32 / kh 32, s 8,192, hd 80, no softcap), bf16, seeded inputs, the
    forward kernel's own output and lse: the device time of each launch
    of one call and of the whole call, and the call's error against
    ``flash_attention_bwd_ref`` relative to the largest gradient."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    rows = {}
    for tag, (b, h, kh, s, hd), window, softcap, what in BWD_TIMING:
        q, k, v, do = (torch.randn(sh, generator=gen, device=dev)
                       .to(torch.bfloat16) for sh in (
            (b, h, s, hd), (b, kh, s, hd), (b, kh, s, hd), (b, h, s, hd)))
        kw = dict(scale=hd ** -0.5, causal=True, window=window,
                  softcap=softcap, q_offset=0)
        o, lse = FA._forward(q, k, v, with_lse=True, **kw)
        run = lambda: FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)  # noqa
        got = run()
        want = bwd_ref_chunked(q, k, v, o, lse, do, kw)
        top = max(float(w.abs().max()) for w in want)
        err = max(float((a.float() - w).abs().max())
                  for a, w in zip(got, want)) / top
        del got, want
        events = device_events(run, iters=5)
        rows[f"flash_attention_bwd, {what}, "
             + (f"window {window}" if window else "global")] = {
            "device_ms": sum(device_us(e) for e in events) / 5 / 1e3,
            "device_launches": len(events) / 5,
            "device_ms_by_launch": ms_by_launch(events, 5),
            "err_of_largest_gradient": err}
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return rows


def comparable_rows(dev):
    """Whole calls that this tree's package and its parent's both offer,
    timed by what they put on the card (every kernel, memset and copy of
    one call): the scan with each statement's total (``relscan`` without
    the compaction), the hash build, the bare probe, the executors'
    verified IndexProbe route (its ids, presence and count from
    core/table.py), the Mamba2 SSD backward (``comparable_ssd_rows``), the
    flash backward (``comparable_flash_bwd_rows``), and
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
    del db, dbx
    gc.collect()
    rows.update(comparable_ssd_rows(dev))
    rows.update(comparable_flash_bwd_rows(dev))
    return rows


def comparable_train_rows(dev, archs=("gemma2-2b", "zamba2-2.7b")):
    """Full-width training steps that this tree's package and its parent's
    both run: three steps of ``launch/train.py``'s main for each arch (b 1,
    s 8,192, remat full, seeded, no checkpoint kept), then one more under
    the profiler (``profiled_step``): each step's seconds and loss, the
    peak GB, and the profiled step's device time by kernel family with the
    flash backward's share. Not a phase of the smoke (the ``train`` phase
    runs gemma2-2b's steps with their checks); run it in a fresh process a
    tree, as ``comparable_rows``."""
    import shutil
    import tempfile
    from repro_torch.launch import train as LT
    rows = {}
    for arch in archs:
        ckpt = tempfile.mkdtemp(prefix="comparable_train_")
        torch.cuda.reset_peak_memory_stats(dev)
        loop = LT.main(["--arch", arch, "--batch", "1", "--seq", "8192",
                        "--remat", "full", "--steps", "3", "--ckpt-every",
                        "1000", "--ckpt-dir", ckpt, "--seed", str(SEED)])
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        prof = profiled_step(loop, dev, 3)
        fam = prof["device_us_by_family"]
        rows[f"train, {arch}, b1 s8192 remat full"] = {
            "step_s": [h["dt"] for h in loop.history],
            "losses": [h["loss"] for h in loop.history],
            "peak_gb": peak, "profiled_step": prof,
            "flash_bwd_share_of_device": fam["flash_attention_bwd"]
            / prof["device_us"]}
        del loop
        shutil.rmtree(ckpt, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def phase_comparable(dev, card):
    emit({"phase": "comparable", "card": card, "rows": comparable_rows(dev)})


def phase_profile(card, serve, zamba):
    out = {"serve_decode_round": profile_rounds(serve["eng"], serve["cfg"])}
    out["zamba2_decode_round"] = profile_rounds(zamba["eng"], zamba["cfg"])
    out["zamba2_prefill_300"] = profile_prefill(zamba["eng"], zamba["cfg"],
                                                ZAMBA_LONG_PROMPT)
    emit({"phase": "profile", "card": card, **out})


# ------------------------------------- phase 2d: attention backward

BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # of the largest
# gradient: fp32 sums in another order; in bf16 the output's rounding
# (dq, dk, dv are rounded once to bf16, ~2^-9 of the largest)
# the backward's own cases beside the forward's: GQA groups 1, 2, 7 and 8,
# sq != sk (cross attention), ragged tails
BWD_CASES = FLASH_CASES + FLASH_EDGE_CASES + [
    (1, 14, 2, 40, 40, 64, True, 0, 0.0, 0),      # GQA 7 (internvl2)
    (1, 8, 1, 70, 70, 128, True, 0, 0.0, 0),      # GQA 8
    (1, 16, 16, 24, 1024, 64, False, 0, 0.0, 0),  # cross attention
    (1, 8, 4, 4608, 4608, 256, True, 4096, 50.0, 0),  # gemma2, window crossed
    # the wgmma kernels' edges (64-row tiles; CTAs of 128 keys or rows, 64
    # at hd 256): sq and sk at a tile or a CTA +- 1 at every head dim, GQA
    # groups 1, 2 and 7, window edges inside a tile, q_offset, rows that
    # see no key, CTAs with fewer tiles than their ring has stages
    (1, 4, 2, 127, 129, 32, True, 0, 0.0, 0),
    (1, 2, 2, 129, 63, 32, False, 0, 0.0, 0),
    (1, 2, 1, 65, 63, 64, True, 0, 0.0, 0),
    (1, 4, 4, 128, 129, 64, False, 37, 0.0, 0),
    (1, 7, 1, 127, 128, 80, True, 0, 0.0, 0),
    (1, 2, 2, 129, 129, 80, True, 37, 0.0, 0),
    (1, 2, 2, 130, 130, 80, True, 20, 0.0, 100),
    (1, 2, 2, 129, 127, 128, True, 0, 30.0, 0),
    (1, 4, 2, 63, 65, 128, True, 0, 0.0, 2),
    (1, 4, 2, 63, 65, 256, True, 0, 50.0, 0),
    (1, 2, 1, 65, 64, 256, True, 0, 0.0, 0),
    (1, 2, 2, 64, 64, 256, False, 0, 0.0, 0),
    (1, 14, 2, 129, 129, 256, True, 70, 50.0, 0),
    (1, 4, 2, 70, 50, 64, False, 6, 0.0, 60),
    (1, 2, 1, 100, 80, 256, True, 10, 0.0, 90)]
# (b, h, kh, s, hd): [b, s, heads, hd] views at every wgmma head dim
BWD_VIEW_CASES = FLASH_VIEW_CASES + [
    (1, 4, 2, 129, 32), (2, 4, 4, 65, 64), (1, 6, 2, 200, 80),
    (1, 4, 1, 127, 128), (1, 8, 4, 130, 256)]
GEMMA2_TRAIN = (1, 8, 4, 8192, 256)   # b, h, kh, s, hd at full width
ZAMBA2_TRAIN = (1, 32, 32, 8192, 80)  # zamba2-2.7b's shared attention block
# the backward's timed shapes: tag, (b, h, kh, s, hd), window, softcap, what
BWD_TIMING = (
    ("alt", GEMMA2_TRAIN, 4096, 50.0, "gemma2-2b's training shape"),
    ("main", GEMMA2_TRAIN, 0, 50.0, "gemma2-2b's training shape"),
    ("zamba2", ZAMBA2_TRAIN, 0, 0.0, "zamba2-2.7b's training shape"))


def visible_pairs(b, h, sq, sk, causal, window, q_offset) -> int:
    """(query, key) pairs the mask lets through, over every head."""
    q = q_offset + np.arange(sq)
    hi = np.minimum(sk, q + 1) if causal else np.full(sq, sk)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(sq, int)
    return int(b * h * np.maximum(hi - lo, 0).sum())


def bwd_ref_chunked(q, k, v, o, lse, do, kw, heads=8):
    """``flash_attention_bwd_ref`` over groups of about ``heads`` query
    heads (whole GQA groups), one after another: the same gradients, with
    the plain version's [b, h, sq, sk] fp32 temporaries a group at a
    time."""
    h, kh = q.shape[1], k.shape[1]
    g = h // kh
    step = max(1, heads // g)   # kv heads a group
    parts = [FA.flash_attention_bwd_ref(
        q[:, j * g:(j + step) * g], k[:, j:j + step], v[:, j:j + step],
        o[:, j * g:(j + step) * g], lse[:, j * g:(j + step) * g],
        do[:, j * g:(j + step) * g], **kw) for j in range(0, kh, step)]
    return tuple(torch.cat([p[i] for p in parts], dim=1) for i in range(3))


def bwd_case(gen, dev, dtype, case, views=False):
    """One backward case: the kernels' (dq, dk, dv) from the forward
    kernel's own output and log-sum-exp against the plain version on the
    same tensors, a second call bit-equal, the same gradients through
    autograd (FlashAttention), the stored lse against the plain one, and
    the delta kernel's D on its own against rowsum(dO * O). Returns the
    error relative to the largest gradient, each kernel's absolute error
    (the lse store, delta, dK/dV, dQ) and the delta's error relative to
    its largest row."""
    b, h, kh, sq, sk, hd, causal, window, softcap, q_offset = case
    shapes = ((b, h, sq, hd), (b, kh, sk, hd), (b, kh, sk, hd),
              (b, h, sq, hd))
    if views:   # [b, s, heads, hd] projections, as attention_prefill's
        q, k, v, do = (torch.randn((s[0], s[2], s[1], s[3]), generator=gen,
                                   device=dev).to(dtype).transpose(1, 2)
                       for s in shapes)
    else:
        q, k, v, do = (torch.randn(s, generator=gen, device=dev).to(dtype)
                       for s in shapes)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window,
              softcap=softcap, q_offset=q_offset)
    # (head dim 4 through the zero-padded route, as the wrappers take it)
    o, lse = FA.padded(FA._forward, q, k, v, with_lse=True, **kw)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = FA.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    delta = FA.flash_attention_bwd_delta(o, do)
    delta_ref = (do.float() * o.float()).sum(dim=-1)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    FA.flash_attention(qg, kg, vg, **kw).backward(do)
    lse_ref = FA.attention_lse_ref(q, k, **kw)
    sync()
    what = (f"flash backward {b}x{h}/{kh}x{sq}x{sk}x{hd} c{causal} "
            f"w{window} cap{softcap} off{q_offset} "
            f"{str(dtype)[6:]}{' views' if views else ''}")
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError(f"{what}: a second call differs")
    if not all(torch.equal(a, t.grad) for a, t in zip(got, (qg, kg, vg))):
        raise AssertionError(f"{what}: autograd's gradients differ")
    if views and got[0].stride() != q.stride():
        raise AssertionError(f"{what}: dq is not in q's layout")
    top = max(float(w.abs().max()) for w in want)
    err = max(float((a.float() - w).abs().max())
              for a, w in zip(got, want)) / max(top, 1e-30)
    if not err <= BWD_TOL[dtype]:
        raise AssertionError(f"{what}: kernels differ from the plain "
                             f"version by {err} of the largest gradient")
    seen = lse_ref > -1e29
    lse_err = float((lse - lse_ref).abs()[seen].max()) if seen.any() else 0.0
    if not lse_err <= (1e-4 if dtype == torch.float32 else 2e-2):
        raise AssertionError(f"{what}: stored lse off by {lse_err}")
    d_err = float((delta - delta_ref).abs().max()) if sq else 0.0
    d_rel = d_err / max(float(delta_ref.abs().max()) if sq else 0.0, 1e-30)
    if not d_rel <= BWD_TOL[dtype]:
        raise AssertionError(f"{what}: delta kernel off by {d_rel} of the "
                             f"largest row")
    ab = [float((a.float() - w).abs().max()) for a, w in zip(got, want)]
    return err, {"flash_attention_lse": lse_err,
                 "flash_attention_bwd_delta": d_err,
                 "flash_attention_bwd_dkdv": max(ab[1], ab[2]),
                 "flash_attention_bwd_dq": ab[0]}, d_rel


# starcoder2-7b SMOKE's training call (b, h, kh, s): head dim 4
FLASH_PAD_TIMING = (4, 36, 4, 32)


def flash_pad_timing(gen, dev, card):
    """Head dim 4 through the flash wrappers' zero-padded route at
    starcoder2-7b SMOKE's training call, fp32 and bf16: the forward (no
    gradient: one padded kernel call) and the forward with its lse plus
    the backward, each the whole call's device ms (pads, the kernels at
    head dim 8, slices), beside the same calls at head dim 8 unpadded,
    the plain version's ms and the bound of the head-dim-4 work."""
    b, h, kh, s = FLASH_PAD_TIMING
    rows = []
    for dtype, rate in ((torch.float32, SIMT_OPS_S),
                        (torch.bfloat16, BF16_OPS_S)):
        kw = dict(scale=0.5, causal=True, window=0, softcap=0.0, q_offset=0)
        t = {}
        for hd in (4, 8):
            q, k, v, do = (torch.randn(sh, generator=gen, device=dev).to(
                dtype) for sh in ((b, h, s, hd), (b, kh, s, hd),
                                  (b, kh, s, hd), (b, h, s, hd)))
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]

            def both(leaves=leaves, do=do):
                FA.flash_attention(*leaves, **kw).backward(do)
            t[hd] = {"fwd": call_device_ms(
                lambda q=q, k=k, v=v: FA.flash_attention(q, k, v, **kw)),
                "fwd_bwd": call_device_ms(both)}
            if hd == 4:
                plain = time_ms(lambda q=q, k=k, v=v: FA.flash_attention_ref(
                    q, k, v, **kw), iters=50, warm=5)
        elem = torch.empty((), dtype=dtype).element_size()
        f_ops, f_bytes = FA.flash_cost(b, h, kh, s, s, 4, elem)
        bwd = [FA.flash_bwd_cost(n, b, h, kh, s, s, 4, elem) for n in (
            "flash_attention_bwd_delta", "flash_attention_bwd_dkdv",
            "flash_attention_bwd_dq")]
        fb_ops = f_ops + sum(o for o, _ in bwd)
        fb_bytes = (f_bytes + 4 * b * h * s) + sum(x for _, x in bwd)
        rows.append({"dtype": str(dtype)[6:], "shape": [b, h, kh, s, 4],
                     "fwd_device_ms": t[4]["fwd"],
                     "fwd_device_ms_hd8_unpadded": t[8]["fwd"],
                     "fwd_bwd_device_ms": t[4]["fwd_bwd"],
                     "fwd_bwd_device_ms_hd8_unpadded": t[8]["fwd_bwd"],
                     "plain_fwd_ms": plain,
                     "fwd_bound_ms": bound(f_bytes, f_ops, rate)[0],
                     "fwd_bwd_bound_ms": bound(fb_bytes, fb_ops, rate)[0]})
    emit({"phase": "kernel_timing", "kernel": "flash_attention_head_dim_4",
          "card": card, "rows": rows})


def phase_kernels_attention_bwd(dev, card):
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    errs = {k: 0.0 for k in ("flash_attention_lse",
                             "flash_attention_bwd_delta",
                             "flash_attention_bwd_dkdv",
                             "flash_attention_bwd_dq")}
    rel, delta_rel = 0.0, 0.0
    n = 0
    cases = [(dtype, case, False) for dtype in (torch.float32, torch.bfloat16)
             for case in BWD_CASES] + [
        (dtype, (b, h, kh, s, s, hd, True, 0, 0.0, 0), True)
        for dtype in (torch.float32, torch.bfloat16)
        for b, h, kh, s, hd in BWD_VIEW_CASES]
    for dtype, case, views in cases:
        e, a, d = bwd_case(gen, dev, dtype, case, views=views)
        rel, delta_rel, n = max(rel, e), max(delta_rel, d), n + 1
        for k in errs:
            errs[k] = max(errs[k], a[k])
    flash_pad_timing(gen, dev, card)
    # max_abs_err: each kernel's own output (lse; D; dK and dV; dQ)
    emit({"phase": "kernels_attention_bwd", "card": card, "cases": n,
          "tolerance_of_largest_gradient": {"float32": 1e-4,
                                            "bfloat16": 2e-2},
          "max_err_of_largest_gradient": rel,
          "delta_max_err_of_largest_row": delta_rel, "max_abs_err": errs,
          "repeat_runs": "bit-equal"})

    # gemma2-2b's full training shape, window 4,096 and global, and
    # zamba2-2.7b's (its shared block: no softcap, no window), bf16
    out = {}
    bf = torch.bfloat16
    elem = 2
    for tag, (b, h, kh, s, hd), window, softcap, what in BWD_TIMING:
        if tag != "main":   # the global shape reuses the window's inputs
            q, k, v = flash_inputs(gen, dev, bf, b, h, kh, s, s, hd)
            do = torch.randn((b, h, s, hd), generator=gen, device=dev).to(bf)
        kw = dict(scale=hd ** -0.5, causal=True, window=window,
                  softcap=softcap, q_offset=0)
        pairs = visible_pairs(b, h, s, s, True, window, 0)
        shape = (f"b{b} h{h}/kh{kh} s{s} hd{hd} bf16 causal "
                 + (f"softcap {softcap:g} " if softcap else "no softcap ")
                 + (f"window {window}" if window else "global")
                 + f" ({what})")
        o, lse = FA._forward(q, k, v, with_lse=True, **kw)
        fwd = lambda: FA._forward(q, k, v, with_lse=False, **kw)  # noqa: E731
        fwd_lse = lambda: FA._forward(q, k, v, with_lse=True, **kw)  # noqa
        bwd = lambda: FA.flash_attention_bwd(q, k, v, o, lse, do, **kw)  # noqa
        # the kernels at the main path's own shape, held to the plain
        # version on the same inputs, and a second call bit-equal
        got, again = bwd(), bwd()
        want = bwd_ref_chunked(q, k, v, o, lse, do, kw)
        sync()
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"flash backward, {shape}: a second call "
                                 "differs")
        top = max(float(w.abs().max()) for w in want)
        err = max(float((a.float() - w).abs().max())
                  for a, w in zip(got, want)) / max(top, 1e-30)
        if not err <= BWD_TOL[bf]:
            raise AssertionError(f"flash backward, {shape}: kernels differ "
                                 f"from the plain version by {err} of the "
                                 "largest gradient")
        ab = [float((a.float() - w).abs().max()) for a, w in zip(got, want)]
        del got, again, want
        events = device_events(bwd, iters=3)
        dev_ms = {}
        for name, sym in (("flash_attention_bwd_delta", "delta_kernel"),
                          ("flash_attention_bwd_dkdv", "dkdv_kernel"),
                          ("flash_attention_bwd_dq", "dq_kernel")):
            t = [device_us(e) for e in events if sym in e.name]
            dev_ms[name] = sum(t) / len(t) / 1e3 if t else None
        bwd_ms = time_ms(bwd, iters=3, warm=1)
        plain_ms = time_ms(lambda: bwd_ref_chunked(q, k, v, o, lse, do, kw),
                           iters=2, warm=1)
        # the library's backward: dq, dk, dv of SDPA at the same shape,
        # without the softcap (SDPA has none: the same function at
        # zamba2's shape); the window as a mask
        lib_ms, lib_err = None, None
        try:
            import torch.nn.functional as F
            ql, kl, vl = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            mask = None
            if window:
                pos = torch.arange(s, device=dev)
                mask = ((pos[:, None] >= pos[None, :])
                        & (pos[:, None] - pos[None, :] < window))
            ol = F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=mask, is_causal=mask is None,
                scale=kw["scale"], enable_gqa=True)
            lib_ms = time_ms(lambda: torch.autograd.grad(
                ol, (ql, kl, vl), do, retain_graph=True), iters=3, warm=1)
            del ol, ql, kl, vl
        except (TypeError, RuntimeError) as e:
            lib_err = f"{type(e).__name__}: {e}"[:300]
        fwd_flops = 4 * pairs * hd
        shp = (b, h, kh, s, s, hd, elem)
        fwd_work = FA.flash_cost(*shp, window=window, with_lse=True)

        def bwd_work(name, old, rate=SIMT_OPS_S):
            f, n = FA.flash_bwd_cost(name, *shp, window=window)
            return bound(*reckoned(name, (n, f), old), rate)
        rows = {} if tag == "zamba2" else {   # (the forward: gemma2's)
            "flash_attention_lse": dict(
                ms=time_ms(fwd_lse, iters=5, warm=1),
                device_ms=device_ms(fwd_lse, "flash_kernel", iters=3),
                ms_without_lse=time_ms(fwd, iters=5, warm=1),
                device_ms_without_lse=device_ms(fwd, "flash_kernel",
                                                iters=3),
                plain_ms=time_ms(lambda: FA.flash_attention_ref(
                    q, k, v, **kw), iters=2, warm=1),
                bound=bound(*reckoned(
                    "flash_lse", fwd_work[::-1],
                    ((2 * b * h + 2 * b * kh) * s * hd * elem
                     + 4 * b * h * s, fwd_flops)), BF16_OPS_S),
                library_ms=None,
                library="none at this shape: SDPA has no softcap (the "
                        "forward's library time is in kernels_attention)")}
        rows.update({
            "flash_attention_bwd_delta": dict(bound=bwd_work(
                "flash_attention_bwd_delta",
                (2 * b * h * s * hd * elem + 4 * b * h * s, 0.0))),
            "flash_attention_bwd_dkdv": dict(bound=bwd_work(
                "flash_attention_bwd_dkdv", (0.0, 8 * pairs * hd),
                BF16_OPS_S)),
            "flash_attention_bwd_dq": dict(bound=bwd_work(
                "flash_attention_bwd_dq", (0.0, 6 * pairs * hd),
                BF16_OPS_S)),
        })
        for name, r in rows.items():
            bound_ms, bound_by = r.pop("bound")
            if name != "flash_attention_lse":
                r.update(ms=bwd_ms, device_ms=dev_ms[name],
                         plain_ms=plain_ms, library_ms=lib_ms,
                         library="scaled_dot_product_attention's backward "
                         "(dq, dk, dv together: the three launches' work)"
                         + (", no softcap" if softcap else ": the same "
                            "function"), library_error=lib_err,
                         ms_covers="the whole backward call (3 launches)")
            out[f"{name}_{tag}"] = {"kernel": name, "shape": shape,
                                    "bound_ms": bound_ms,
                                    "bound_by": bound_by, **r}
            if tag != "main":
                out[f"{name}_{tag}"]["alt"] = (f"window_{window}" if window
                                               else "zamba2_training")
        whole, whole_by = bound(0.0, 10 * pairs * hd, BF16_OPS_S)
        emit({"phase": "kernel_timing", "card": card,
              "kernel": "flash_attention backward (all three launches)",
              "shape": shape, "ms": bwd_ms,
              "device_ms": sum(x for x in dev_ms.values() if x),
              "plain_ms": plain_ms, "bound_ms": whole, "bound_by": whole_by,
              "library_ms": lib_ms, "visible_pairs": pairs,
              "err_of_largest_gradient": err,
              "tolerance_of_largest_gradient": BWD_TOL[bf],
              "repeat_runs": "bit-equal"})
        errs["flash_attention_bwd_dkdv"] = max(
            errs["flash_attention_bwd_dkdv"], ab[1], ab[2])
        errs["flash_attention_bwd_dq"] = max(errs["flash_attention_bwd_dq"],
                                             ab[0])
        del o, lse
        torch.cuda.empty_cache()
    del q, k, v, do
    torch.cuda.empty_cache()
    for t in out.values():
        emit({"phase": "kernel_timing", "card": card, **t})
    return out, errs


# ------------------------------------------------------- phase: train

FLASH_TRAIN = ("flash_attention_lse", "flash_attention_bwd_delta",
               "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")
TRAIN_NEED = FLASH_TRAIN + ("mamba2_scan", "mamba2_scan_bwd")
TRAIN_LOSS_TOL = 1e-2    # relative: bf16 weights and activations, the
# plain path rounds P and O at other places
TRAIN_GRAD_TOL = 5e-2    # of each leaf's largest entry: a bf16 gradient
# through two layers of bf16 activations


def state_gb(cfg) -> float:
    """GB of training state: bf16 params and grads, fp32 mu and nu."""
    return cfg.param_count() * 12 / 1e9


def train_launches(cfg, remat: str, steps: int) -> dict:
    """Launches of the training kernels in ``steps`` training steps of
    ``cfg``. Flash: a forward (with its lse) and one of each backward
    kernel for every self-attention (a shared block's too), cross
    attention and encoder layer a step. Mamba2 scan: a forward and a
    backward call for every Mamba2 layer a step. Under remat "full" the
    forwards of the scan units' layers run twice (the backward recomputes
    them; the tail layers and the encoder are not checkpointed)."""
    if remat not in ("none", "full"):
        raise ValueError(f"no launch count for remat {remat!r}")
    gs, ng, _ = TF.scan_layout(cfg)
    att = [(0 if kind in TF.SSM_KINDS else 1 + int(cfg.is_encdec))
           + int(TF.shared_app(cfg, i) >= 0)
           for i, kind in enumerate(cfg.layer_pattern)]
    m2 = [int(kind == MAMBA2) for kind in cfg.layer_pattern]

    def again(per):
        return sum(per[:ng * gs]) if remat == "full" else 0
    att_once = sum(att) + (cfg.enc_layers if cfg.is_encdec else 0)
    out = {k: steps * att_once for k in FLASH_TRAIN[1:]}
    out["flash_attention_lse"] = steps * (att_once + again(att))
    out["mamba2_scan"] = steps * (sum(m2) + again(m2))
    out["mamba2_scan_bwd"] = steps * sum(m2)
    return out


def expect_launches(want: dict, cfg, remat: str, steps: int) -> None:
    """Add ``steps`` training steps of ``cfg`` to the launch counts
    ``want`` of phase train."""
    for k, n in train_launches(cfg, remat, steps).items():
        want[k] += n


def leaf_grads(params, cfg, batch):
    from repro_torch.optim.adamw import tree_leaves
    flat = tree_leaves(params)
    for x in flat:
        x.requires_grad_(True)
    loss, _ = TF.train_loss(params, cfg, batch, remat="none")
    grads = torch.autograd.grad(loss, flat)
    for x in flat:
        x.requires_grad_(False)
    return float(loss), grads


def train_against_plain(card, dev, want, tag, phase, arch, n_layers,
                        shape, plain):
    """A cut of ``arch`` at full width (its first ``n_layers`` layers), b
    1, s 4,608: the loss and every gradient leaf through the kernels
    against the same with the plain versions ``plain`` ((module, name,
    function) triples) swapped in under autograd; the kernels' launches
    exactly those reckoned from the config."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.training.loop import to_device
    full = configs.get_config(arch)
    cfg = dataclasses.replace(full, n_layers=n_layers,
                              layer_pattern=full.layer_pattern[:n_layers])
    params = TF.init_model(torch.Generator(device=dev).manual_seed(SEED),
                           cfg, dev)
    batch = to_device(make_batch(cfg, 1, 4608, seed=SEED), dev)
    before = dict(_build.launches)
    loss_k, g_k = leaf_grads(params, cfg, batch)
    launched = {k: n - before[k] for k, n in _build.launches.items()}
    with contextlib.ExitStack() as stack:
        for obj, name, fn in plain:
            stack.enter_context(patched(obj, name, fn))
        loss_p, g_p = leaf_grads(params, cfg, batch)
    mine = dict.fromkeys(_build.KERNELS, 0)
    expect_launches(mine, cfg, "none", 1)
    if launched != mine:
        raise AssertionError(f"train {tag}: launches {launched}, expected "
                             f"{mine}")
    expect_launches(want, cfg, "none", 1)
    names = list(_flat_names(params))
    errs = {}
    for name, a, c in zip(names, g_k, g_p):
        top = float(c.float().abs().max())
        errs[name] = float((a.float() - c.float()).abs().max()) / max(top,
                                                                      1e-30)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    worst = max(errs.values())
    emit({"phase": phase, "card": card, "shape": shape,
          "loss_kernels": loss_k, "loss_plain": loss_p,
          "loss_rel_diff": loss_rel, "loss_tol": TRAIN_LOSS_TOL,
          "grad_rel_err": errs, "grad_rel_err_max": worst,
          "grad_tol": TRAIN_GRAD_TOL, "launches": launched})
    if not (loss_rel <= TRAIN_LOSS_TOL and worst <= TRAIN_GRAD_TOL):
        raise AssertionError(f"train {tag}: kernels' loss / gradients "
                             f"differ from the plain versions': {loss_rel}, "
                             f"{worst}")
    del params, g_k, g_p
    gc.collect()
    torch.cuda.empty_cache()


def train_two_layers(card, dev, want):
    """(i) gemma2-2b at full width, one local and one global layer, s
    4,608 (its 4,096-token window masks), against the plain attention."""
    train_against_plain(
        card, dev, want, "(i)", "train_two_layers", "gemma2-2b", 2,
        "gemma2-2b full width, layers (local, global), b1 s4608",
        [(AT, "flash_attention", FA.flash_attention_ref)])


def train_zamba2_unit(card, dev, want):
    """(iv') zamba2-2.7b at full width, its first scan unit (6 Mamba2
    layers and the shared attention+MLP block that closes it), s 4,608,
    against the plain scan and the plain attention."""
    train_against_plain(
        card, dev, want, "(iv')", "train_zamba2_unit", "zamba2-2.7b", 6,
        "zamba2-2.7b full width, its first scan unit (6 Mamba2 layers and "
        "the shared block), b1 s4608",
        [(AT, "flash_attention", FA.flash_attention_ref),
         (SSM, "mamba2_scan", MS.mamba2_scan_ref)])


def _flat_names(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_names(v, f"{prefix}{k}/")
        else:
            yield prefix + k


def profiled_step(loop, dev, step):
    """One more step of ``loop`` under the profiler: its device time by
    family and idle share."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training.loop import to_device
    batch = to_device(loop.data.batch_at(step), dev)
    sync()
    t1 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loop.params, loop.opt, m = loop.step_fn(loop.params, loop.opt, batch,
                                                step)
        float(m["loss"])
        sync()
    return device_families(prof, (time.perf_counter() - t1) * 1e6, 1)


def full_width_report(loop, cfg, seq, wall, peak, dts) -> dict:
    """What a full-width run reports beside its checks: step times,
    tokens/s, the model-FLOP share of the card's bf16 peak
    (``RF.model_flops_per_step``), peak memory against the state."""
    from repro_torch.optim.adamw import tree_leaves
    flops = RF.model_flops_per_step(cfg, seq)
    return {"params_b": sum(x.numel() for x in tree_leaves(loop.params))
            / 1e9, "losses": [h["loss"] for h in loop.history],
            "step_s": dts, "tokens_per_s": [seq / d for d in dts],
            "model_flops_per_step": flops,
            "model_flop_share_of_bf16_peak": [
                RF.peak_share(flops, d, CARD_HW) for d in dts],
            "peak_memory_gb": peak, "state_gb": state_gb(cfg),
            "wall_s": wall}


def train_full_width(card, dev, want):
    """(ii) gemma2-2b at its full 26 layers: 3 AdamW steps through
    launch/train.py's main (b 1, s 8,192, remat full), with the step-2
    checkpoint of the whole state (params and moments) written on the
    way, then one step more under the profiler."""
    import shutil
    from repro_torch.launch import train as LT
    from repro_torch.optim.adamw import tree_leaves
    cfg = configs.get_config("gemma2-2b")
    ckpt = ROOT / "build" / "chip_smoke_train" / "gemma2"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    loop = LT.main(["--arch", "gemma2-2b", "--batch", "1", "--seq", "8192",
                    "--remat", "full", "--steps", "3", "--ckpt-every", "2",
                    "--ckpt-dir", str(ckpt), "--seed", str(SEED)])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    losses = [h["loss"] for h in loop.history]
    dts = [h["dt"] for h in loop.history]
    # the checkpoint holds every leaf of the state, and the step it names
    meta = json.loads((ckpt / "step_2" / "meta.json").read_text())
    n_leaves = len(tree_leaves(loop.params)) + len(tree_leaves(loop.opt))
    count = int(np.load(ckpt / "step_2" / meta["names"]["opt/.count"]))
    ckpt_gb = sum(f.stat().st_size for f in (ckpt / "step_2").iterdir()) / 1e9
    shutil.rmtree(ckpt)
    if len(meta["names"]) != n_leaves or count != 2:
        raise AssertionError(f"train (ii): step-2 checkpoint holds "
                             f"{len(meta['names'])} of {n_leaves} leaves, "
                             f"count {count}")
    step_profile = profiled_step(loop, dev, 3)
    emit({"phase": "train_full_width", "card": card,
          "arch": "gemma2-2b", "layers": 26, "batch": 1, "seq": 8192,
          "remat": "full",
          **full_width_report(loop, cfg, 8192, wall, peak, dts),
          "checkpoint_step": 2, "checkpoint_gb": ckpt_gb,
          "checkpoint_host_copy_s": loop.history[1].get("ckpt_copy_s"),
          "profiled_step": step_profile})
    if not (all(np.isfinite(losses)) and losses[2] < losses[0]):
        raise AssertionError(f"train (ii): losses {losses}")
    if not state_gb(cfg) * 0.95 <= peak <= 80:
        raise AssertionError(f"train (ii): peak {peak} GB beside "
                             f"{state_gb(cfg)} GB of state")
    expect_launches(want, cfg, "full", 4)
    del loop
    gc.collect()
    torch.cuda.empty_cache()


def train_zamba2_full(card, dev, want):
    """(v) zamba2-2.7b at its 54 layers: 3 AdamW steps through
    launch/train.py's main (b 1, s 8,192, remat full; no checkpoint:
    gemma2's run writes the full-width one), then one step more under the
    profiler."""
    from repro_torch.launch import train as LT
    cfg = configs.get_config("zamba2-2.7b")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    loop = LT.main(["--arch", "zamba2-2.7b", "--batch", "1", "--seq", "8192",
                    "--remat", "full", "--steps", "3", "--ckpt-every",
                    "1000", "--ckpt-dir",
                    str(ROOT / "build" / "chip_smoke_train" / "zamba2"),
                    "--seed", str(SEED)])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    losses = [h["loss"] for h in loop.history]
    dts = [h["dt"] for h in loop.history]
    step_profile = profiled_step(loop, dev, 3)
    emit({"phase": "train_zamba2_full", "card": card,
          "arch": "zamba2-2.7b", "layers": 54, "batch": 1, "seq": 8192,
          "remat": "full",
          **full_width_report(loop, cfg, 8192, wall, peak, dts),
          "profiled_step": step_profile})
    if not (all(np.isfinite(losses)) and losses[2] < losses[0]):
        raise AssertionError(f"train (v): losses {losses}")
    if not state_gb(cfg) * 0.95 <= peak <= 80:
        raise AssertionError(f"train (v): peak {peak} GB beside "
                             f"{state_gb(cfg)} GB of state")
    expect_launches(want, cfg, "full", 4)
    del loop
    gc.collect()
    torch.cuda.empty_cache()


# the SMOKE archs trained with a resume in (iii): every arch of the port,
# starcoder2-7b's head dim 4 through the flash wrappers' padded route
SMOKE_TRAIN = ("yi-6b", "granite-moe-1b-a400m", "seamless-m4t-large-v2",
               "internvl2-1b", "zamba2-2.7b", "falcon-mamba-7b",
               "gemma3-27b", "phi3.5-moe-42b-a6.6b", "starcoder2-7b")


def train_smoke_resume(card, dev, want):
    """(iii) the SMOKE archs (fp32) through the launcher: 3 steps, then a
    resume from the step-2 checkpoint whose step 3 must repeat the first
    run's loss."""
    import shutil
    from repro_torch.launch import train as LT
    out = {}
    for arch in SMOKE_TRAIN:
        ckpt = ROOT / "build" / "chip_smoke_train" / arch
        shutil.rmtree(ckpt, ignore_errors=True)
        common = ["--arch", arch, "--smoke", "--batch", "4", "--seq", "32",
                  "--ckpt-every", "1", "--ckpt-dir", str(ckpt), "--seed",
                  str(SEED)]
        first = LT.main(common + ["--steps", "3"])
        shutil.rmtree(ckpt / "step_3")
        again = LT.main(common + ["--steps", "3", "--resume"])
        shutil.rmtree(ckpt)
        expect_launches(want, configs.get_smoke(arch), "none", 3 + 1)
        a, c = first.history[-1]["loss"], again.history[-1]["loss"]
        out[arch] = {"losses": [h["loss"] for h in first.history],
                     "resumed_from": again.start_step,
                     "step3_resumed": c,
                     "rel_diff": abs(a - c) / abs(a)}
        if again.start_step != 2 or not out[arch]["rel_diff"] <= 1e-4:
            raise AssertionError(f"train (iii) {arch}: {out[arch]}")
    emit({"phase": "train_smoke_resume", "card": card, **out})


def phase_train(card, dev, held):
    """The training path; ``held["want"]`` gets the launches its runs
    must make."""
    want = held["want"] = dict.fromkeys(_build.KERNELS, 0)
    train_two_layers(card, dev, want)
    train_full_width(card, dev, want)
    train_zamba2_unit(card, dev, want)
    train_zamba2_full(card, dev, want)
    train_smoke_resume(card, dev, want)


# ------------------------------------------------ phase: the serving mesh
# (name, arch, mesh shape, slots, pool lengths, seq, int8 arena): yi-6b's
# three placements over debug meshes of repeated cuda:0 — (a) slots over
# 'data', its 4 kv heads over 'model' 2; (b) kv heads 4 do not divide
# 'model' 8: 8 stripes; (c) one slot does not cover 'data': 2 stripes over
# 'data', heads over 'model' — (b) again on the int8 arena, and zamba2's
# shared block (kh 32) over (2, 2). Each pool fills every block of seq
# positions a slot can reach; the longest slot starts 8 tokens short of
# seq, so that the 8 rounds write its last block to its last position.
MESH_BLOCK = 256
MESH_ROUNDS = 8
MESH_CASES = [
    ("a", "yi-6b", (2, 2), 4, YI_MESH_LENGTHS, 4096, False),
    ("b", "yi-6b", (1, 8), 4, YI_MESH_LENGTHS, 4096, False),
    ("c", "yi-6b", (2, 2), 1, [8184], 8192, False),
    ("b_int8", "yi-6b", (1, 8), 4, YI_MESH_LENGTHS, 4096, True),
    ("zamba2", "zamba2-2.7b", (2, 2), 2, [310, 1030], 4096, False),
]
ARENA_REL_TOL = ATT_TOL[torch.bfloat16]   # of the arena's largest entry:
# a K/V entry written a round later from a hidden state one bf16 rounding
# apart; an absolute bound would be under one ulp of the largest entries
# round 1's first island, mesh against mesh-free on the same inputs: both
# sum in fp32 (in other orders) and round once to bf16, so an entry may
# differ by one bf16 ulp of the larger (2^-7 of it, and ISLAND_ATOL near
# 0, where the fp32 sums' own rounding is what is left); a stripe dropped
# or counted twice moves entries by far more
ISLAND_ULP = 2.0 ** -7
ISLAND_ATOL = 1e-5


def island_round1(cfg, geom, free, mesh, placed, glob, inputs, free_in,
                  int8, dev):
    """The first island of round 1 (layer 0's arena, or zamba2's first
    shared application), the mesh island against the mesh-free one on
    the same seeded q / k / v [b, h | kh, hd] (bf16) and the round's page
    inputs, each on the copy of that layer's arena (and scales) taken
    before round 1, which it writes: the largest difference in units of
    ISLAND_ULP * max(|a|, |b|) + ISLAND_ATOL (<= 1 passes), the largest
    absolute one and the largest entry. Its kernel calls count on no
    path: the launch counts are put back as they were."""
    key = "arena" if "arena" in glob else "shared_arena"
    b, h, kh, hd = geom.batch, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    q, k_new, v_new = (torch.randn((b, n, hd), generator=g, device=dev)
                       .to(cfg.dtype) for n in (h, kh, kh))
    kw = dict(scale=hd ** -0.5, quant=int8)
    args_m = [placed[key].layer(0), inputs["pt"], inputs["blk_start"],
              inputs["lengths"], inputs["write_rows"], inputs["write_off"]]
    args_f = [glob[key][0], free_in["pt"], free_in["blk_start"],
              free_in["lengths"], free_in["write_rows"],
              free_in["write_off"]]
    if int8:
        args_m.append(placed[key + "_scale"].layer(0))
        args_f.append(glob[key + "_scale"][0])
    counts = dict(_build.launches)
    a = PG.gather_heads(geom, mesh, PG.make_paged_island(geom, mesh, **kw)(
        *PG.scatter_heads(geom, mesh, q, k_new, v_new), *args_m)[0])
    c = PG.make_paged_island(free, None, **kw)(q, k_new, v_new, *args_f)[0]
    sync()
    _build.launches.update(counts)   # a comparison: no path's launches
    a, c = a.float(), c.float()
    diff = (a - c).abs()
    ulps = diff / (ISLAND_ULP * torch.maximum(a.abs(), c.abs())
                   + ISLAND_ATOL)
    return float(ulps.max()), float(diff.max()), float(c.abs().max())


def mesh_pool(geom, dev, seed):
    """The mesh's page table [b, stripe_total, nblk_local]: every block of
    every slot gets a row of its (batch shard, stripe) shard, in a seeded
    random order."""
    rng = np.random.default_rng(seed)
    st, cl, bl = geom.stripe_total, geom.cap_local, geom.batch_local
    free = [list(rng.permutation(cl)) for _ in range(geom.cap // cl)]
    pt = np.full((geom.batch, st, geom.nblk_local), -1, np.int32)
    for i in range(geom.batch):
        for j in range(geom.nblk):
            pt[i, j % st, j // st] = free[(i // bl) * st + j % st].pop()
    return torch.from_numpy(pt).to(dev)


def _clone_state(state):
    """A deep copy of a mesh-free serve state."""
    return tree_map(lambda t: t.clone(), state)


def _rounds(step, params, state, inputs_of, rounds, log=False):
    """``rounds`` steps of ``step`` on ``inputs_of(r)``: each round's
    next tokens and logits (on the CPU), its milliseconds, and round 1's
    collective log where ``log``."""
    nxt, logits, ms, first = [], [], [], None
    for r in range(rounds):
        inputs = inputs_of(r)
        sync()
        t0 = time.perf_counter()
        with CO.recording() as rec:
            n, _, lg = step(params, state, inputs)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        if log and first is None:
            first = rec
        nxt.append(n.cpu())
        logits.append(lg.float().cpu())
    return nxt, logits, ms, first


def placed_serve_case(phase, card, dev, params, cfg, name, mshape, b,
                      lengths, seq, int8, want, seeds):
    """One case of ``serve_mesh`` / ``serve_tp``: the weights placed by
    SERVE_PARAM_RULES over the mesh (``cuda:0`` repeated), the placed step
    against the mesh-free step from the same weights, pools and SSM states
    (``seeds``: the pools' and the first tokens'), MESH_ROUNDS rounds
    teacher-forced on the mesh-free step's tokens. The logit bound is
    bf16's own error, measured here as the serve phases measure zamba2's
    (``teacher_forced`` with ``atol=None``): the same mesh-free step in
    fp32 (weights and pools cast up; an int8 arena kept) on the same
    tokens, and the placed step may differ from the bf16 mesh-free step
    by at most twice the latter's largest distance from the fp32 one. Also
    held: no token flip where the mesh-free top-2 gap exceeds that bound;
    the bf16 arenas joined back within ARENA_REL_TOL of their largest
    entry; round 1's first island within one bf16 ulp of the mesh-free
    island on the same inputs (:func:`island_round1`); round 1's
    collectives equal to :func:`tp_round_collectives`; the paged launches
    exactly one a coordinate an attention application a round (the two
    mesh-free steps' one an application). Adds the launches to ``want``."""
    if int8:
        cfg = dataclasses.replace(cfg, kv_quant_int8=True)
    n = int(np.prod(mshape))
    with MESH.force_device_count(n):
        mesh = MESH.make_debug_mesh(*mshape)
    if any(d != dev for d in mesh.devices.flat):
        raise AssertionError(f"{phase} {name}: a coordinate is not on "
                             f"{dev}: {list(mesh.devices.flat)}")
    geo = dict(batch=b, seq_len=seq, kv_heads=cfg.n_kv_heads,
               head_dim=cfg.head_dim, q_heads=cfg.n_heads, block=MESH_BLOCK)
    geom = PG.plan_geometry(mesh=mesh, **geo)
    free = PG.plan_geometry(**geo)
    resident = torch.cuda.memory_allocated(dev)   # weights, held engines
    torch.cuda.reset_peak_memory_stats(dev)
    glob = SE.init_serve_state(cfg, free, free.cap, dev)
    g = torch.Generator(device=dev).manual_seed(seeds[0])
    for key in ("arena", "shared_arena"):
        if key not in glob:
            continue
        kv = torch.randn(glob[key][:, :free.cap].shape, generator=g,
                         device=dev)
        if int8:
            qv, sc = PG.quantize_kv(kv)
            glob[key][:, :free.cap] = qv
            glob[key + "_scale"][:, :free.cap] = sc
        else:
            glob[key][:, :free.cap] = kv.to(glob[key].dtype)
        del kv
    for t in glob.get("ssm", {}).values():
        t.copy_((torch.randn(t.shape, generator=g, device=dev) * 0.1)
                .to(t.dtype))
    start = _clone_state(glob)
    pt = mesh_pool(geom, dev, SEED + len(name))
    pt_free = PG.global_page_table(geom, pt)[:, None]
    bs = torch.from_numpy(PG.build_blk_start(geom)).to(dev)
    bs_free = torch.from_numpy(PG.build_blk_start(free)).to(dev)
    apps = (TF.n_attn_layers(cfg) + (cfg.n_shared_applications()
                                     if cfg.shared_attn_every else 0))
    before = dict(_build.launches)

    # the mesh-free step picks the tokens; every run is fed them
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(seeds[1]).integers(
        0, cfg.vocab, b).astype(np.int32)).to(dev)
    mesh_in, free_in, live = [], [], []
    free_step = SE.make_serve_step(cfg, free)
    nxt_f, lg_f, free_ms = [], [], []
    for _ in range(MESH_ROUNDS):
        active = lens < seq
        wr = PG.mesh_write_rows(geom, pt, lens, active)
        mesh_in.append({"tokens": tokens, "lengths": lens,
                        "write_off": lens % MESH_BLOCK, "pt": pt,
                        "blk_start": bs, "write_rows": wr})
        free_in.append(dict(mesh_in[-1], pt=pt_free, blk_start=bs_free,
                            write_rows=PG.global_write_rows(geom, wr)))
        live.append(active.cpu())
        nx, lg, ms, _ = _rounds(free_step, params, glob,
                                lambda r: free_in[-1], 1)
        nxt_f += nx
        lg_f += lg
        free_ms += ms
        tokens = torch.where(active, nx[0].to(dev), 0).to(torch.int32)
        lens = lens + active.to(torch.int32)

    # the same mesh-free step in fp32 on the same tokens
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = tree_map(lambda t: t.float(), params)
    s32 = SE.init_serve_state(cfg32, free, free.cap, dev)
    for key, t in start.items():
        if key == "ssm":
            for k, v in t.items():
                s32["ssm"][k].copy_(v)
        else:
            s32[key].copy_(t)
    _, lg_32, _, _ = _rounds(SE.make_serve_step(cfg32, free), p32, s32,
                             lambda r: free_in[r], MESH_ROUNDS)
    del p32, s32
    gc.collect()
    torch.cuda.empty_cache()

    # the placed step
    placed = SE.place_state(start, geom, mesh)
    key = "arena" if "arena" in start else "shared_arena"
    keys = (key, key + "_scale") if int8 else (key,)
    first = ({k: PG.Shards({c: t[:1].clone() for c, t in placed[k].items()})
              for k in keys}, {k: start[k][:1].clone() for k in keys})
    del start
    weights = SHD.place_params(params, param_axes(cfg),
                               SHD.SERVE_PARAM_RULES, mesh)
    per_coord = placed_bytes(weights)
    nxt_m, lg_m, mesh_ms, log1 = _rounds(
        SE.make_serve_step(cfg, geom, mesh), weights, placed,
        lambda r: mesh_in[r], MESH_ROUNDS, log=True)
    launched = {k: v - before[k] for k, v in _build.launches.items()
                if v != before[k]}

    def dist(xs, ys):
        return [float((x[:, :cfg.vocab] - y[:, :cfg.vocab]).abs()[lv].max())
                for x, y, lv in zip(xs, ys, live)]
    errs, free_vs_32, placed_vs_32 = (dist(lg_m, lg_f), dist(lg_f, lg_32),
                                      dist(lg_m, lg_32))
    atol = 2 * max(free_vs_32)
    flips = near = 0
    for nm, nf, lf, lv in zip(nxt_m, nxt_f, lg_f, live):
        top2 = lf[:, :cfg.vocab].topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        differ = (nm != nf) & lv
        near += int((differ & (gap <= atol)).sum())
        flips += int((differ & (gap > atol)).sum())
    scale = max(float(lf[lv, :cfg.vocab].std()) for lf, lv in zip(lg_f, live))
    isl_ulps, isl_diff, isl_max = island_round1(
        cfg, geom, free, mesh, first[0], first[1], mesh_in[0], free_in[0],
        int8, dev)
    first = None
    joined = SE.join_state(placed, geom, mesh)
    arena_err = {k: float((joined[k].float() - glob[k][:, :free.cap]
                           .float()).abs().max()) / float(
                               glob[k][:, :free.cap].float().abs().max())
                 for k in ("arena", "shared_arena", "arena_scale",
                           "shared_arena_scale") if k in joined}
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    coords = len(PG.coordinates(geom, mesh))
    # pages of 256 launch paged_wide_kernel: with the lse where stripes
    # are combined, else (head-sharded coordinates, the two mesh-free
    # steps) with an output of q's dtype
    form = ("paged_attention_lse" if geom.stripe_total > 1
            else "paged_attention_wide")
    mine = {}
    if apps:
        mine = {form: MESH_ROUNDS * apps * coords}
        mine["paged_attention_wide"] = (mine.get("paged_attention_wide", 0)
                                        + 2 * MESH_ROUNDS * apps)
    got_cb = RF.collective_bytes(log1)
    want_cb = tp_round_collectives(cfg, geom, mesh)
    from repro_torch.roofline.profile import top_collectives
    rows, _ = top_collectives(log1, 5)
    emit({"phase": phase, "case": name, "card": card, "arch": cfg.name,
          "mesh": mesh.shape, "distinct_devices": len(set(mesh.devices.flat)),
          "slots": b, "pool_lengths": lengths, "seq": seq,
          "block": MESH_BLOCK, "int8_arena": int8,
          "geometry": {"batch_axes": geom.batch_axes,
                       "head_axes": geom.head_axes,
                       "stripe_axes": geom.stripe_axes,
                       "stripe_total": geom.stripe_total,
                       "nblk_local": geom.nblk_local,
                       "cap_local": geom.cap_local},
          "placed_bytes_per_coordinate": per_coord,
          "whole_bytes": sum(t.numel() * t.element_size() for t in
                             _tree_leaves(params)),
          "rounds": MESH_ROUNDS, "round_ms_p50": p50(mesh_ms),
          "mesh_free_round_ms_p50": p50(free_ms), "round_ms": mesh_ms,
          "logit_max_abs_diff": max(errs), "logit_bound": atol,
          "logit_max_abs_diff_by_round": errs,
          "mesh_free_vs_fp32_max_abs": max(free_vs_32),
          "placed_vs_fp32_max_abs": max(placed_vs_32),
          "mesh_free_vs_fp32_by_round": free_vs_32,
          "placed_vs_fp32_by_round": placed_vs_32,
          "mesh_free_logit_std": scale,
          "token_flips_beyond_bound": flips, "token_flips_near_tie": near,
          "round1_island_max_ulps": isl_ulps,
          "round1_island_max_abs_diff": isl_diff,
          "round1_island_max_abs": isl_max,
          "round1_island_bound": {"ulp": ISLAND_ULP, "atol": ISLAND_ATOL},
          "arena_max_rel_diff": arena_err, "arena_rel_tol": ARENA_REL_TOL,
          "collective_bytes_round": got_cb,
          "collective_bytes_reckoned": want_cb,
          "collectives_a_round": len(log1),
          "top_collectives": [list(r) for r in rows],
          "peak_gb": peak, "resident_gb_at_start": resident / 1e9,
          "launches": launched, "launches_expected": mine,
          "paged_launches_per_coordinate_round": apps})
    if launched != mine:
        raise AssertionError(f"{phase} {name}: launches {launched}, "
                             f"expected {mine}")
    if got_cb != want_cb:
        raise AssertionError(f"{phase} {name}: collectives {got_cb}, "
                             f"reckoned {want_cb}")
    if apps and not isl_ulps <= 1.0:
        raise AssertionError(f"{phase} {name}: round 1's first island "
                             f"differs from the mesh-free one by "
                             f"{isl_ulps} bf16 ulps ({isl_diff})")
    if not (max(errs) <= atol and flips == 0):
        raise AssertionError(f"{phase} {name}: logits {max(errs)} (bound "
                             f"{atol}) / {flips} flips against the "
                             f"mesh-free step")
    if not int8 and arena_err and not max(arena_err.values()) <= \
            ARENA_REL_TOL:
        raise AssertionError(f"{phase} {name}: arenas {arena_err}")
    for k, v in mine.items():
        want[k] = want.get(k, 0) + v
    del placed, glob, weights
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_mesh(card, dev, held):
    """The serving mesh at full width (MESH_CASES): yi-6b's weights for
    its four cases, then zamba2-2.7b's; each case placed by
    SERVE_PARAM_RULES against the mesh-free step on the same card
    (:func:`placed_serve_case`)."""
    want = held["want"] = dict.fromkeys(_build.KERNELS, 0)
    params, arch = None, None
    for name, a, mshape, b, lengths, seq, int8 in MESH_CASES:
        if a != arch:
            params = None
            gc.collect()
            torch.cuda.empty_cache()
            cfg = configs.get_config(a)
            params = TF.init_model(
                torch.Generator(device=dev).manual_seed(SEED), cfg, dev)
            arch = a
        placed_serve_case("serve_mesh", card, dev, params, cfg, name, mshape,
                          b, lengths, seq, int8, want, (SEED + 11, SEED + 2))
    del params
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------- phase: sequence-parallel attention
SEQPAR_LOSS_TOL = 1e-3    # relative
SEQPAR_NORM_TOL = 1e-2    # relative, each gradient leaf's norm: the K/V
# gradients are summed over the four query slices' backward calls


def phase_train_seqpar(card, dev, held):
    """gemma2-2b at full width, one training step (b 1, s 8,192, remat
    full) with ``attn_seq_shard`` over a 'model' axis of 4 entries
    (cuda:0 repeated) against the same step without the mesh: the loss
    and each gradient leaf's norm; the step times and peak memory."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel import sharding as SHD
    from repro_torch.training.loop import to_device
    cfg = configs.get_config("gemma2-2b")
    params = TF.init_model(torch.Generator(device=dev).manual_seed(SEED),
                           cfg, dev)
    batch = to_device(make_batch(cfg, 1, 8192, seed=SEED), dev)
    flat = tree_leaves(params)
    names = list(_flat_names(params))
    with MESH.force_device_count(4):
        mesh = MESH.make_mesh((4,), ("model",))
    if any(d != dev for d in mesh.devices.flat):
        raise AssertionError(f"train_seqpar: a coordinate is not on {dev}: "
                             f"{list(mesh.devices.flat)}")

    def step(c, m):
        for x in flat:
            x.requires_grad_(True)
        torch.cuda.reset_peak_memory_stats(dev)
        sync()
        t0 = time.perf_counter()
        with SHD.axis_rules(SHD.DEFAULT_RULES if m is not None else None, m):
            loss, _ = TF.train_loss(params, c, batch, remat="full")
            grads = torch.autograd.grad(loss, flat)
        sync()
        dt = time.perf_counter() - t0
        for x in flat:
            x.requires_grad_(False)
        norms = [float(gr.float().norm()) for gr in grads]
        return float(loss.detach()), norms, dt, torch.cuda.max_memory_allocated(
            dev) / 1e9

    def launched(fn):
        before = dict(_build.launches)
        out = fn()
        return out, {k: v - before[k] for k, v in _build.launches.items()
                     if v != before[k]}
    base, base_launch = launched(lambda: step(cfg, None))
    shard, shard_launch = launched(lambda: step(
        dataclasses.replace(cfg, attn_seq_shard=True), mesh))
    rel = {n: abs(a - b) / max(b, 1e-30)
           for n, a, b in zip(names, shard[1], base[1])}
    loss_rel = abs(shard[0] - base[0]) / abs(base[0])
    emit({"phase": "train_seqpar", "card": card, "arch": "gemma2-2b",
          "layers": cfg.n_layers, "batch": 1, "seq": 8192, "remat": "full",
          "mesh": mesh.shape, "loss_mesh": shard[0], "loss_mesh_free":
          base[0], "loss_rel_diff": loss_rel, "loss_tol": SEQPAR_LOSS_TOL,
          "grad_norm_rel_diff_max": max(rel.values()),
          "grad_norm_tol": SEQPAR_NORM_TOL, "step_s_mesh": shard[2],
          "step_s_mesh_free": base[2], "peak_gb_mesh": shard[3],
          "peak_gb_mesh_free": base[3], "launches_mesh": shard_launch,
          "launches_mesh_free": base_launch})
    # the mesh splits every flash launch of the step (the forward, its
    # recompute under remat and the three backward kernels) into 4
    once = {k: v for k, v in train_launches(cfg, "full", 1).items() if v}
    expect = {k: 4 * v for k, v in once.items()}
    if shard_launch != expect or base_launch != once:
        raise AssertionError(f"train_seqpar: launches {shard_launch} / "
                             f"{base_launch}, expected {expect} / {once}")
    if not (loss_rel <= SEQPAR_LOSS_TOL
            and max(rel.values()) <= SEQPAR_NORM_TOL):
        raise AssertionError(f"train_seqpar: loss {loss_rel}, gradient "
                             f"norms {max(rel.values())}")
    held["want"] = dict(dict.fromkeys(_build.KERNELS, 0),
                        **{k: v + once[k] for k, v in expect.items()})
    del params, batch, flat
    gc.collect()
    torch.cuda.empty_cache()


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
    # the same kernel's block-256 form (paged_wide_kernel, no block
    # starts, no lse): the mesh-free steps and head-sharded coordinates
    # of serve_mesh
    "paged_attention_wide": ("src/repro_torch/csrc/paged_attention.cu",
                             "src/repro/kernels/paged_attention.py:27"),
    # the same kernel's striped call form (block starts and the rows'
    # log-sum-exp): the mesh island's attention over its stripe, whose
    # reference is the island's jnp body and combine
    "paged_attention_lse": ("src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:27 (the "
                            "mesh island's stripes: src/repro/serving/"
                            "paged.py:228-240)"),
    "mamba2_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                    "src/repro/kernels/mamba_scan.py:23"),
}
# the training path's kernels: no Pallas counterpart (the reference takes
# jax.grad of its jnp chunked_attention)
NO_PALLAS = "none: jax.grad of src/repro/models/layers/attention.py:84"
TRAIN_SOURCES = {
    "flash_attention_lse": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:28 "
                            "(the forward; the lse store has none)"),
    "flash_attention_bwd_delta": ("src/repro_torch/csrc/"
                                  "flash_attention_bwd.cu", NO_PALLAS),
    "flash_attention_bwd_dkdv": ("src/repro_torch/csrc/"
                                 "flash_attention_bwd.cu", NO_PALLAS),
    "flash_attention_bwd_dq": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                               NO_PALLAS),
    # the reference takes jax.grad of its jnp SSD
    "mamba2_scan_bwd": ("src/repro_torch/csrc/mamba_scan_bwd.cu",
                        "none: jax.grad of src/repro/models/layers/"
                        "ssm.py:266"),
}



# ------------------------------------ phases: tensor-parallel weights
TP_CASES = [
    # name, arch, mesh (data, model), slots, pool lengths, seq
    ("yi_2x2", "yi-6b", (2, 2), 4, YI_MESH_LENGTHS, 4096),
    ("yi_1x8", "yi-6b", (1, 8), 4, YI_MESH_LENGTHS, 4096),
    ("zamba2_2x2", "zamba2-2.7b", (2, 2), 4, YI_MESH_LENGTHS, 4096),
    ("granite_1x4", "granite-moe-1b-a400m", (1, 4), 4, YI_MESH_LENGTHS,
     4096),
]
TP_PREFILL = ("yi-6b", (1, 4), 300)
# arch, mesh, slots, cache length, rounds, the slots' first lengths
TP_DECODE = ("yi-6b", (2, 2), 4, 64, 8, (13, 7, 0, 22))
TP_TRAIN = ("gemma2-2b", (2, 2), 2, 4096)      # arch, mesh, b, s
TP_COMPRESS = ("yi-6b", (2, 1, 2))              # SMOKE, (pod, data, model)


def tp_round_collectives(cfg, geom, mesh) -> dict:
    """The collectives a placed serve round issues, per participant, by
    kind, reckoned from the config and the paged plan (the rules of
    ``parallel/sharding.place_params`` and the TP step): the embedding's
    fp32 psum and the logits' all-gather where 'model' cuts the
    vocabulary; a layer's fp32 partial sums of wo / w_down / the experts /
    out_proj where 'model' cuts their rows; q gathered over 'model' where
    the island's heads are all of them (striped blocks) but the weights
    cut them; the stripes' lse max and two sums; the MoE router's logits
    gathered and its fractions summed over the batch axes; Mamba2's gated
    norm sum and its conv_bc tail gathered where the state's spec cuts
    it."""
    m = int(mesh.shape["model"])
    bax = [a for a in geom.batch_axes if int(mesh.shape[a]) > 1]
    bl = geom.batch // math.prod(int(mesh.shape[a]) for a in bax)
    d, item = cfg.d_model, torch.finfo(cfg.dtype).bits // 8
    ar = ag = 0
    if cfg.padded_vocab % m == 0:
        ar += bl * d * 4
        ag += bl * cfg.padded_vocab * 4
    h, hd = cfg.n_heads, cfg.head_dim
    hi = h // geom.head_shards                    # the island's heads
    per_attn = ag_q = 0
    if h % m == 0:
        per_attn += bl * d * 4                    # wo
        if m > 1 and "model" not in geom.head_axes:
            ag_q = bl * h * hd * item             # q for the island
    stripe_ar = 0
    if geom.stripe_total > 1:
        stripe_ar = bl * hi * 4 * 2 + bl * hi * hd * 4
    ffn_ar, ffn_ag = 0, 0
    if cfg.is_moe:
        e = cfg.n_experts
        if e % m == 0:
            ffn_ag += bl * e * 4
            ffn_ar += bl * d * 4
        if bax:
            ffn_ar += 2 * e * 4
    elif cfg.d_ff % m == 0:
        ffn_ar += bl * d * 4
    apps = TF.n_attn_layers(cfg) + (cfg.n_shared_applications()
                                    if cfg.shared_attn_every else 0)
    ar += apps * (per_attn + stripe_ar + ffn_ar)
    ag += apps * (ag_q + ffn_ag)
    n_m2 = sum(k == MAMBA2 for k in cfg.layer_pattern)
    if n_m2:
        di, st2 = cfg.d_inner, 2 * cfg.ssm_state
        if di % m == 0:
            ar += n_m2 * (bl * 4 + bl * d * 4)
        if st2 % m == 0:
            ag += n_m2 * bl * (cfg.ssm_conv - 1) * st2 * item
    out = {k: 0 for k in CO.KINDS}
    out["all-reduce"], out["all-gather"] = ar, ag
    out["total"] = ar + ag
    return out


def placed_bytes(tree) -> dict:
    """Bytes each coordinate holds of a placed tree."""
    out: dict = {}
    for leaf in _placed_leaves(tree):
        for key, t in leaf.items():
            out[str(key)] = out.get(str(key), 0) + t.numel() * t.element_size()
    return out


def _placed_leaves(tree):
    if isinstance(tree, SHD.Placed):
        return [tree]
    return [x for v in tree.values() for x in _placed_leaves(v)]


def _tree_leaves(tree):
    from repro_torch.optim.adamw import tree_leaves
    return tree_leaves(tree)


def serve_tp_dense_decode(card, dev, params, cfg):
    """The dense ``decode_step`` over placed weights (``decode_step_tp``):
    yi-6b at full width, weights placed by SERVE_PARAM_RULES and the
    seeded dense cache by ``place_cache`` over (2, 2) (slots over 'data',
    kv heads over 'model'), TP_DECODE's rounds on seeded tokens, against
    the mesh-free ``decode_step`` from the same weights and cache: the
    logits within twice the bf16 mesh-free step's distance from the same
    step in fp32 (the serve rule of :func:`placed_serve_case`), the joined
    cache within ARENA_REL_TOL of its largest entry against the mesh-free
    one's (the arenas' rule there: each coordinate's k / v projections
    round on their own), and no kernel launched (the dense path is plain,
    as the reference's)."""
    arch, mshape, b, length, rounds, lens0 = TP_DECODE
    with MESH.force_device_count(int(np.prod(mshape))):
        mesh = MESH.make_debug_mesh(*mshape)
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    start = TF.init_cache(cfg, b, length, dev)
    for t in start.values():
        t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    tokens = torch.from_numpy(np.random.default_rng(SEED + 32).integers(
        0, cfg.vocab, (rounds, b)).astype(np.int32)).to(dev)

    def run(p, cache):
        out, ms = [], []
        lens = torch.tensor(lens0, dtype=torch.int32, device=dev)
        with torch.no_grad():
            for r in range(rounds):
                sync()
                t0 = time.perf_counter()
                lg, cache = TF.decode_step(p, cfg, tokens[r], cache, lens)
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                out.append(lg[:, :cfg.vocab].float())
                lens = lens + 1
        return out, cache, ms

    before = dict(_build.launches)
    p32 = SHD._tree_map(lambda t: t.float(), params)
    lg_32, _, _ = run(p32, {k: t.float() for k, t in start.items()})
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    lg_f, free, free_ms = run(params, {k: t.clone() for k, t in
                                       start.items()})
    weights = SHD.place_params(params, param_axes(cfg),
                               SHD.SERVE_PARAM_RULES, mesh)
    cache = TF.place_cache(cfg, {k: t.clone() for k, t in start.items()},
                           weights)
    torch.cuda.reset_peak_memory_stats(dev)
    with CO.recording() as log:
        lg_m, cache, tp_ms = run(weights, cache)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    launched = {k: v - before[k] for k, v in _build.launches.items()
                if v != before[k]}
    dist = lambda xs, ys: max(float((x - y).abs().max())  # noqa: E731
                              for x, y in zip(xs, ys))
    atol = 2 * dist(lg_f, lg_32)
    err = dist(lg_m, lg_f)
    joined = TF.join_cache(cache)
    cache_err = max(float((joined[k].float() - free[k].float()).abs().max())
                    / float(free[k].float().abs().max()) for k in free)
    report = {"phase": "serve_tp", "case": "dense_decode", "card": card,
              "arch": cfg.name, "mesh": mesh.shape, "slots": b,
              "cache_len": length, "rounds": rounds,
              "logit_max_abs_diff": err, "logit_bound": atol,
              "mesh_free_vs_fp32": atol / 2, "cache_rel_err": cache_err,
              "round_ms_p50": p50(tp_ms), "mesh_free_round_ms_p50":
              p50(free_ms), "peak_gb": peak,
              "collective_bytes_round": {
                  k: v / rounds for k, v in
                  RF.collective_bytes(log).items()},
              "launches": launched}
    emit(report)
    del weights, cache, joined, free
    gc.collect()
    torch.cuda.empty_cache()
    if launched:
        raise AssertionError(f"serve_tp dense decode launched {launched}")
    if not (err <= atol and cache_err <= ARENA_REL_TOL):
        raise AssertionError(f"serve_tp dense decode: {report}")


def serve_tp_prefill(card, dev, params, cfg, want, atol):
    """yi-6b's 300-token prefill with weights placed over (1, 4): every
    coordinate's heads through the flash kernel (one launch a coordinate
    a layer), logits against the mesh-free prefill within ``atol``."""
    arch, mshape, n_tok = TP_PREFILL
    with MESH.force_device_count(int(np.prod(mshape))):
        mesh = MESH.make_debug_mesh(*mshape)
    weights = SHD.place_params(params, param_axes(cfg),
                               SHD.SERVE_PARAM_RULES, mesh)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 4).integers(
        0, cfg.vocab, (1, n_tok)).astype(np.int32)).to(dev)
    before = dict(_build.launches)
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        with CO.recording() as log:
            lt, _ = TF.prefill(weights, cfg, {"tokens": tokens})
        sync()
        t1 = time.perf_counter()
        lf, _ = TF.prefill(params, cfg, {"tokens": tokens})
        sync()
        t2 = time.perf_counter()
    launched = {k: v - before[k] for k, v in _build.launches.items()
                if v != before[k]}
    la = TF.n_attn_layers(cfg)
    mine = {"flash_attention": la * mesh.size + la}
    err = float((lt[:, :cfg.vocab].float() - lf[:, :cfg.vocab].float())
                .abs().max())
    emit({"phase": "serve_tp", "case": "prefill", "card": card,
          "arch": cfg.name, "mesh": mesh.shape, "tokens": n_tok,
          "prefill_ms": (t1 - t0) * 1e3, "mesh_free_prefill_ms":
          (t2 - t1) * 1e3, "logit_max_abs_diff": err, "logit_bound": atol,
          "collective_bytes": RF.collective_bytes(log), "launches": launched,
          "launches_expected": mine})
    if launched != mine:
        raise AssertionError(f"serve_tp prefill: launches {launched}, "
                             f"expected {mine}")
    if not err <= atol:
        raise AssertionError(f"serve_tp prefill: logits {err} > {atol}")
    for k, v in mine.items():
        want[k] = want.get(k, 0) + v
    del weights
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_tp(card, dev, held):
    """Tensor-parallel weights in the serve step (TP_CASES,
    :func:`placed_serve_case`) and a placed prefill, each against the
    mesh-free step from the same weights on the same card (every
    coordinate cuda:0)."""
    want = held["want"] = dict.fromkeys(_build.KERNELS, 0)
    params, arch = None, None
    for name, a, mshape, b, lengths, seq in TP_CASES:
        if a != arch:
            params = None
            gc.collect()
            torch.cuda.empty_cache()
            cfg = configs.get_config(a)
            params = TF.init_model(
                torch.Generator(device=dev).manual_seed(SEED), cfg, dev)
            arch = a
        placed_serve_case("serve_tp", card, dev, params, cfg, name, mshape,
                          b, lengths, seq, False, want, (SEED + 21, SEED + 3))
        if name == "yi_1x8":
            serve_tp_prefill(card, dev, params, cfg, want, SERVE_LOGIT_ATOL)
            serve_tp_dense_decode(card, dev, params, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()


TP_LOSS_TOL = TRAIN_LOSS_TOL     # relative (phase train's bounds)
TP_GRAD_TOL = TRAIN_GRAD_TOL     # of each leaf's largest entry
# REPRO_SEQ_ACT=model: the residual stream cut along the sequence over
# 'model' (launch/dryrun._act_rules)
SEQ_ACT_RULES = dict(SHD.DEFAULT_RULES, seq=("model",))
RESIDUAL_SUMS = (".wo", ".w_down", ".out_proj", "embed.lookup", ".experts")


def seq_collective_reckoning(cfg, b_local: int, s: int, n: int,
                             remat: str = "full") -> dict:
    """The all-gather and reduce-scatter bytes over 'model' of one
    training step (forward, the remat's recompute and backward) of a
    decoder of attention + MLP blocks (train_tp's gemma2-2b; other forms
    raise) whose residual stream is cut along the sequence into ``n``
    slices, from the config: both sublayers of a layer gather their normed
    input (model dtype, [b_local, s, d]) and reduce-scatter their fp32
    partial output ([b_local, s / n, d]); the lookup reduce-scatters its
    fp32 partials and the final norm's output is gathered once. The remat
    runs a scan unit's forward twice (the tail layers once); the backward
    transposes each forward collective once: a gather's gradient is a
    reduce-scatter in the model dtype, a reduce-scatter's a gather in
    fp32. Bytes are one participant's output, as the log counts them."""
    if (cfg.ssm_layer_ids or cfg.is_moe or cfg.is_encdec
            or cfg.shared_attn_every):
        raise ValueError(f"{cfg.name}: the reckoning takes attention + MLP "
                         f"decoders")
    gs, ng, _ = TF.scan_layout(cfg)
    elem = torch.empty((), dtype=cfg.dtype).element_size()
    d = cfg.d_model
    full, part = b_local * s * d, b_local * (s // n) * d
    ag = rs = 0
    for i in range(cfg.n_layers):
        passes = 2 if remat != "none" and i < ng * gs else 1
        ag += 2 * (passes * full * elem + full * 4)
        rs += 2 * (passes * part * 4 + part * elem)
    ag += full * elem + full * 4     # final norm's gather; lookup's grad
    rs += part * 4 + part * elem     # the lookup; the final gather's grad
    return {"all-gather": ag, "reduce-scatter": rs}


def seq_act_log(log) -> dict:
    """A step's collectives over 'model' by kind (bytes), and whether any
    residual-stream sum (an all-reduce of a sublayer's output or of the
    lookup) is left."""
    out = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    residual = 0
    for r in log:
        if r.axes != ("model",) or r.kind not in out:
            continue
        out[r.kind] += r.nbytes
        residual += r.kind == "all-reduce" and any(
            r.origin.split("/")[0].endswith(o) for o in RESIDUAL_SUMS)
    out["residual_all_reduces"] = residual
    return out


def _leaf_errs(names, got, want) -> dict:
    """Each leaf's largest difference over ``want``'s largest entry
    (``got`` may be a generator: one leaf at a time)."""
    out = {}
    for name, a, c in zip(names, got, want):
        top = float(c.float().abs().max())
        out[name] = float((a.float() - c.float()).abs().max()) / max(top,
                                                                     1e-30)
    return out


def phase_train_tp(card, dev, held):
    """gemma2-2b at full width (b 2, s 4,096, remat full) with weights and
    moments placed by TRAIN_PARAM_RULES over (data 2, model 2) of cuda:0:
    the loss and every gradient leaf against the mesh-free step on the
    same batch, within TP_GRAD_TOL of each leaf's largest entry; the tied
    ``embed``'s bound is at least twice the bf16 mesh-free step's distance
    from the same step in fp32 (weights cast up), the serve phases' rule:
    both steps sum the lookup's gradient in bf16, as the reference does,
    the placed one a batch slice at a time, and so a frequent token's row
    rounds differently; then one AdamW update at step 1 and every
    parameter against the mesh-free step's; the step's seconds, peak
    memory and collective bytes. Then one SMOKE step through
    ``make_compressed_grad_fn`` over (pod 2, data 1, model 2) against the
    same on the CPU."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.optim.schedule import cosine_schedule
    from repro_torch.training.loop import to_device
    from repro_torch.training.step import make_loss_grad_fn, make_train_step
    want = held["want"] = dict.fromkeys(_build.KERNELS, 0)
    arch, mshape, b, s = TP_TRAIN
    cfg = configs.get_config(arch)
    with MESH.force_device_count(int(np.prod(mshape))):
        mesh = MESH.make_debug_mesh(*mshape)
    params = TF.init_model(torch.Generator(device=dev).manual_seed(SEED),
                           cfg, dev)
    batch = to_device(make_batch(cfg, b, s, seed=SEED), dev)
    names = list(_flat_names(params))
    torch.cuda.reset_peak_memory_stats(dev)
    grad_fn = make_loss_grad_fn(cfg, remat="full")
    step_fn = make_train_step(cfg, remat="full")
    p32 = SHD._tree_map(lambda t: t.float(), params)
    embed32 = make_loss_grad_fn(dataclasses.replace(
        cfg, dtype=torch.float32), remat="full")(p32, batch)[1]["embed"]
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    (loss_f, _), g_f = grad_fn(params, batch)
    g_f = _tree_leaves(g_f)
    upd_f = SHD._tree_map(lambda t: t.clone(), params)
    opt = adamw_init(upd_f)
    sync()
    t0 = time.perf_counter()
    _, _, m_f = step_fn(upd_f, opt, batch, 1)
    sync()
    free_s = time.perf_counter() - t0
    del opt
    gc.collect()
    torch.cuda.empty_cache()
    placed = SHD.place_params(params, param_axes(cfg),
                              SHD.TRAIN_PARAM_RULES, mesh)
    del params   # the whole copy (upd_f is the mesh-free step's)
    per_coord = placed_bytes(placed)
    seq = {}   # the placed gradients without the seq rule, then with it
    for tag, rules in (("none", None), ("seq", SEQ_ACT_RULES)):
        gc.collect()
        torch.cuda.empty_cache()
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        with SHD.axis_rules(rules, mesh), CO.recording() as log_g:
            (loss_g, _), g_p = grad_fn(placed, batch)
        sync()
        seq[tag] = {"loss": float(loss_g),
                    "grad_s": time.perf_counter() - t0,
                    "peak_rise_gb": (torch.cuda.max_memory_allocated(dev)
                                     - base) / 1e9,
                    "model_collectives": seq_act_log(log_g),
                    "collective_bytes": RF.collective_bytes(log_g)}
        errs = _leaf_errs(names, (SHD.join_placed(x) for x in
                                  _placed_leaves(g_p)), g_f)
        embed_p = SHD.join_placed(g_p["embed"])
        seq[tag]["errs"] = errs
        seq[tag]["embed_vs_fp32"] = _leaf_errs(["e"], [embed_p],
                                               [embed32])["e"]
        del g_p, embed_p
    loss_p, g_errs = seq["none"]["loss"], seq["none"]["errs"]
    embed_errs = {
        "placed_vs_fp32": seq["none"]["embed_vs_fp32"],
        "seq_act_vs_fp32": seq["seq"]["embed_vs_fp32"],
        "mesh_free_vs_fp32": _leaf_errs(
            ["e"], [g_f[names.index("embed")]], [embed32])["e"]}
    embed_bound = max(TP_GRAD_TOL, 2 * embed_errs["mesh_free_vs_fp32"])
    tp_b = b // int(mesh.shape["data"])
    seq["seq"]["reckoned"] = seq_collective_reckoning(
        cfg, tp_b, s, int(mesh.shape["model"]))
    seq_rep = {"loss": seq["seq"]["loss"],
               "loss_rel_diff": abs(seq["seq"]["loss"] - float(loss_f))
               / abs(float(loss_f)),
               "grad_rel_err_max": max(seq["seq"]["errs"].values()),
               "grad_s": seq["seq"]["grad_s"],
               "grad_s_without_rule": seq["none"]["grad_s"],
               "peak_rise_gb": seq["seq"]["peak_rise_gb"],
               "peak_rise_gb_without_rule": seq["none"]["peak_rise_gb"],
               "model_collectives": seq["seq"]["model_collectives"],
               "model_collectives_without_rule":
                   seq["none"]["model_collectives"],
               "reckoned": seq["seq"]["reckoned"],
               "collective_bytes": seq["seq"]["collective_bytes"]}
    del g_f, embed32
    gc.collect()
    torch.cuda.empty_cache()
    opt_p = adamw_init(placed)
    sync()
    t0 = time.perf_counter()
    with CO.recording() as log:
        _, _, m_p = step_fn(placed, opt_p, batch, 1)
    sync()
    tp_s = time.perf_counter() - t0
    p_errs = _leaf_errs(names, (SHD.join_placed(x) for x in
                                _placed_leaves(placed)),
                        _tree_leaves(upd_f))
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    for _ in range(5):   # the mesh-free grads (fp32, bf16), its step and
        # the first coordinate of the two placed ones
        expect_launches(want, cfg, "full", 1)
    for _ in range(2 * (mesh.size - 1) + mesh.size):   # the placed ones:
        # a coordinate (and the seq -> model gradients' coordinates)
        expect_launches(want, cfg, "full", 1)
    loss_rel = abs(float(loss_p) - float(loss_f)) / abs(float(loss_f))
    step_rel = abs(float(m_p["loss"]) - float(m_f["loss"])) / abs(
        float(m_f["loss"]))
    bounds = {k: embed_bound if k == "embed" else TP_GRAD_TOL
              for k in g_errs}
    report = {"phase": "train_tp", "card": card, "arch": cfg.name,
              "mesh": mesh.shape, "batch": b, "seq": s, "remat": "full",
              "lr_step1": cosine_schedule(1),
              "loss_placed": float(loss_p), "loss_mesh_free": float(loss_f),
              "loss_rel_diff": max(loss_rel, step_rel),
              "loss_tol": TP_LOSS_TOL,
              "grad_norm_placed": float(m_p["grad_norm"]),
              "grad_norm_mesh_free": float(m_f["grad_norm"]),
              "grad_rel_err_max": max(g_errs.values()),
              "grad_rel_err": g_errs,
              "embed_grad_rel_err": embed_errs,
              "embed_grad_tol": embed_bound,
              "param_rel_err_max": max(p_errs.values()),
              "grad_tol": TP_GRAD_TOL, "step_s": tp_s,
              "mesh_free_step_s": free_s, "peak_gb": peak,
              "placed_bytes_per_coordinate": per_coord,
              "collective_bytes_step": RF.collective_bytes(log),
              "collectives_a_step": len(log), "seq_act": seq_rep}
    del placed, opt_p, upd_f
    gc.collect()
    torch.cuda.empty_cache()
    report["compressed"] = compressed_step(dev, want)
    emit(report)
    over = {k: v for k, v in g_errs.items() if v > bounds[k]}
    if not (report["loss_rel_diff"] <= TP_LOSS_TOL and not over
            and report["param_rel_err_max"] <= TP_GRAD_TOL):
        raise AssertionError(f"train_tp: placed step against the mesh-free "
                             f"one: {report['loss_rel_diff']}, {over} "
                             f"(embed bound {embed_bound}, {embed_errs}), "
                             f"{report['param_rel_err_max']}")
    if not report["compressed"]["ok"]:
        raise AssertionError(f"train_tp: the compressed step "
                             f"{report['compressed']}")
    sq, mc = seq["seq"], seq_rep["model_collectives"]
    over = {k: v for k, v in sq["errs"].items() if v > bounds[k]}
    moved = (mc["residual_all_reduces"] == 0
             and seq_rep["model_collectives_without_rule"][
                 "residual_all_reduces"] > 0
             and all(mc[k] == sq["reckoned"][k] for k in sq["reckoned"]))
    if not (seq_rep["loss_rel_diff"] <= TP_LOSS_TOL and not over
            and moved):
        raise AssertionError(f"train_tp seq -> model: {seq_rep}, {over}")


DRY_SERVE = ("yi-6b", (2, 2), 4, 4096)   # arch, mesh, slots, seq
DRY_CELL = ("gemma2-2b", "train_4k")
DRY_PEAK = (0.8, 1.25)   # the walk's peak over the card's, both all-mesh


def _same_walk(what, meta, card_w, args_want) -> dict:
    """The meta walk against the card's walk of the same step: FLOPs,
    bytes moved and argument bytes a device equal, every coordinate's
    FLOPs equal, the collective logs equal record by record, and the
    arguments equal to the placed tensors' bytes (``args_want``)."""
    rec = lambda w: [(r.kind, r.axes, r.nbytes, r.origin)  # noqa: E731
                     for r in w.log]
    out = {"flops": [meta.cost["flops"], card_w.cost["flops"]],
           "bytes": [meta.cost["bytes"], card_w.cost["bytes"]],
           "argument_bytes": [meta.cost["argument_bytes"],
                              card_w.cost["argument_bytes"], args_want],
           "unattributed": [meta.cost["unattributed"],
                            card_w.cost["unattributed"]],
           "collectives": len(meta.log),
           "collective_bytes": RF.collective_bytes(meta.log),
           "kernel_calls": [meta.cost["kernel_calls"],
                            card_w.cost["kernel_calls"]],
           "walk_s": meta.seconds, "card_s": card_w.seconds,
           "flops_spread": meta.cost["spread"]["flops"]}
    bad = [k for k in ("flops", "bytes") if out[k][0] != out[k][1]]
    if len(set(out["argument_bytes"])) != 1:
        bad.append("argument_bytes")
    a, c = rec(meta), rec(card_w)
    out["log_same_order"] = a == c
    if a != c:   # where the two orders part, and whether as many of each
        i = next((i for i, (x, y) in enumerate(zip(a, c)) if x != y),
                 min(len(a), len(c)))
        out["log_first_difference"] = [i, a[i:i + 3], c[i:i + 3]]
    if sorted(a) != sorted(c):
        bad.append("collective log")
    if out["flops_spread"][0] != out["flops_spread"][1]:
        bad.append("coordinates' FLOPs")
    if out["kernel_calls"][0] != out["kernel_calls"][1]:
        bad.append("kernel calls")
    if bad:
        raise AssertionError(f"dryrun {what}: the meta walk and the card "
                             f"step differ in {bad}: {out}")
    return out


def _shard_bytes(sh, key) -> int:
    return sh[key].numel() * sh[key].element_size()


def _dry_train(cfg, mshape, b, s, dev, want, seq_act):
    """Phase dryrun's train step: the walk on meta against the same step
    on the card under one counter, with ``REPRO_SEQ_ACT`` set to
    ``seq_act`` (None: unset) around both. Returns :func:`_same_walk`'s
    record with the peaks."""
    import os
    from repro_torch.configs import shapes as SHP
    from repro_torch.data.synthetic import make_batch
    from repro_torch.launch import dryrun as DR
    from repro_torch.optim.adamw import adamw_init
    if seq_act:
        os.environ["REPRO_SEQ_ACT"] = seq_act
    try:
        shape = SHP.ShapeSpec("dryrun_train", s, b, "train")
        meta = DR._walk_train(cfg, shape, MESH.make_debug_mesh(
            *mshape, device="meta"), 1)
        with MESH.force_device_count(int(np.prod(mshape))):
            mesh = MESH.make_debug_mesh(*mshape)
        placed = SHD.place_params(
            TF.init_model(torch.Generator(device=dev).manual_seed(SEED), cfg,
                          dev), param_axes(cfg), SHD.TRAIN_PARAM_RULES, mesh)
        tp = SHD.TP.for_batch(mesh, b)
        data = make_batch(cfg, b, s, seed=SEED)
        batch = {k: tp.scatter(torch.from_numpy(np.asarray(data[k])).to(
            dev, v.dtype)) for k, v in SHP.train_specs(cfg, shape).items()}
        gc.collect()
        torch.cuda.empty_cache()
        k0 = tp.keys[0]
        # each leaf's slice and its two fp32 moments, the batch slice, the
        # step scalars
        args = (sum(x[k0].numel() * (x[k0].element_size() + 8)
                    for x in _placed_leaves(placed))
                + sum(_shard_bytes(v, k0) for v in batch.values())
                + DR.STEP_SCALARS)
        opt = adamw_init(placed)
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        card_w = DR.train_walk(cfg, placed, batch, mesh, opt=opt)
        sync()
        rise = torch.cuda.max_memory_allocated(dev) - base
    finally:
        os.environ.pop("REPRO_SEQ_ACT", None)
    for _ in range(mesh.size):
        expect_launches(want, cfg, "full", 1)
    r = _same_walk("train" + (" seq_act" if seq_act else ""), meta, card_w,
                   args)
    r["peak_walk_bytes"] = meta.cost["peak_live_bytes_all"]
    r["peak_card_bytes"] = int(rise)
    r["peak_ratio"] = r["peak_walk_bytes"] / max(rise, 1)
    r["peak_temp_bytes_per_coordinate"] = meta.cost["peak_temp_bytes"]
    r["step_s"] = card_w.seconds
    del placed, batch, card_w, opt
    gc.collect()
    torch.cuda.empty_cache()
    return r


def phase_dryrun(card, dev, held):
    """The dry run (``launch/dryrun.py``) against the card. (i) gemma2-2b
    at full width (b 2, s 4,096, remat full, weights and moments placed by
    TRAIN_PARAM_RULES over (data 2, model 2)): the walk on meta and the
    same step on the card under the same cost counter count the same
    FLOPs, bytes moved, argument bytes (the placed tensors' bytes and the
    two step scalars) and collectives; the walk's peak live bytes over the
    whole mesh lie within DRY_PEAK of the card's allocated rise over the
    step. (ii) The same for yi-6b's placed serve round (SERVE_PARAM_RULES,
    4 slots of 4,096 over (2, 2)), its peak ratio reported. (iii) The
    production cell gemma2-2b train_4k over the 16x16 mesh: its two-point
    probe's record (the whole cell's production walk takes minutes on the
    host; PERF.md has its record from a CPU run). (iv) (i) again under
    ``REPRO_SEQ_ACT=model`` (the residual stream cut along the sequence
    over 'model'): the same counts equal, the peak ratio within DRY_PEAK,
    and its peak temporary bytes a coordinate beside (i)'s."""
    from repro_torch.configs import shapes as SHP
    from repro_torch.launch import dryrun as DR
    want = held["want"] = dict.fromkeys(_build.KERNELS, 0)
    report = {"phase": "dryrun", "card": card}

    # (i) the train step, and (iv) the same under REPRO_SEQ_ACT=model
    arch, mshape, b, s = TP_TRAIN
    cfg = configs.get_config(arch)
    for key, seq_act in (("train", None), ("train_seq_act", "model")):
        r = _dry_train(cfg, mshape, b, s, dev, want, seq_act)
        report[key] = {"arch": arch, "mesh": mshape, "batch": b, "seq": s,
                       **r}
        if not DRY_PEAK[0] <= r["peak_ratio"] <= DRY_PEAK[1]:
            raise AssertionError(f"dryrun {key}: the walk's peak {r}")
    report["train_seq_act"]["peak_temp_ratio_to_train"] = (
        report["train_seq_act"]["peak_temp_bytes_per_coordinate"]
        / report["train"]["peak_temp_bytes_per_coordinate"])

    # (ii) the serve round
    arch, mshape, b, s = DRY_SERVE
    cfg = configs.get_config(arch)
    shape = SHP.ShapeSpec("dryrun_decode", s, b, "decode")
    meta, _ = DR.lower_decode(cfg, shape, MESH.make_debug_mesh(
        *mshape, device="meta"))
    with MESH.force_device_count(int(np.prod(mshape))):
        mesh = MESH.make_debug_mesh(*mshape)
    placed = SHD.place_params(
        TF.init_model(torch.Generator(device=dev).manual_seed(SEED), cfg,
                      dev), param_axes(cfg), SHD.SERVE_PARAM_RULES, mesh)
    step, _ = SE.lower_serve_step(cfg, shape, placed, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    sync()
    before = dict(_build.launches)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    card_w, _ = DR.decode_walk(cfg, shape, placed, mesh, step=step)
    sync()
    rise = torch.cuda.max_memory_allocated(dev) - base
    got = {k: _build.launches[k] - before[k] for k in before}
    paged = sum(got[k] for k in PA.FORM_COUNTERS)
    if paged != mesh.size * len(cfg.attn_layer_ids):
        raise AssertionError(f"dryrun serve: {got} paged launches, "
                             f"expected one a layer a coordinate")
    for k in PA.FORM_COUNTERS:
        want[k] += got[k]
    k0 = SHD.coord_keys(mesh)[0]
    r = _same_walk("serve", meta, card_w, card_w.cost["argument_bytes"])
    r["peak_walk_bytes"] = meta.cost["peak_live_bytes_all"]
    r["peak_card_bytes"] = int(rise)
    r["peak_ratio"] = r["peak_walk_bytes"] / max(rise, 1)
    r["placed_weight_bytes_a_coordinate"] = sum(
        _shard_bytes(x, k0) for x in _placed_leaves(placed))
    report["serve"] = {"arch": arch, "mesh": mesh.shape, "slots": b,
                       "seq": s, **r}
    del placed, card_w, step
    gc.collect()
    torch.cuda.empty_cache()

    # (iii) the production cell's two-point probe
    arch, shape_name = DRY_CELL
    cfg = configs.get_config(arch)
    shape = SHP.SHAPES[shape_name]
    prod = MESH.make_production_mesh()
    t0 = time.perf_counter()
    _, ng, _ = TF.scan_layout(cfg)
    tpc = DR.two_point_costs(
        lambda c: DR.lower_train(c, shape, prod, True), cfg, ng)
    probe_s = time.perf_counter() - t0
    terms = RF.roofline_terms(flops=tpc["flops"], nbytes=tpc["bytes"],
                              coll_bytes=tpc["coll"]["total"],
                              chips=prod.size, per_device=True, hw=CARD_HW)
    mf = RF.model_flops_per_step(cfg, shape.global_batch * shape.seq_len)
    report["cell"] = {"arch": arch, "shape": shape_name, "mesh": prod.shape,
                      "status": "ok", "probe_wall_s": probe_s,
                      "hlo_flops_per_device": tpc["flops"],
                      "hlo_bytes_per_device": tpc["bytes"],
                      "collective_bytes_per_device": tpc["coll"],
                      "roofline": terms, "model_flops_total": mf,
                      "useful_flops_ratio": mf / prod.size / tpc["flops"]}
    emit(report)


def phase_examples(card):
    """The port's two examples on the card, as a user starts them
    (``examples/torch_quickstart.py``: its rows, counts and a CUDA
    payload; ``examples/torch_cms_cache_sim.py`` at its 2,000 requests:
    each cache's hits and request latency p50 / p99, wall us on the
    host's clock)."""
    import contextlib as _cl
    import io
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_cms_cache_sim as CMS
    import torch_quickstart as QS
    made = []   # the daemons the simulation makes, released below

    class Kept(D.SQLCached):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)
    buf = io.StringIO()
    with _cl.redirect_stdout(buf), patched(CMS, "SQLCached", Kept):
        db = QS.main([])
        cms = CMS.main([])
    lines = buf.getvalue().splitlines()
    pay = db.execute("SELECT PAYLOAD(emb) FROM fragments WHERE page_id = 1")
    if pay.payloads["emb"].device.type != "cuda":
        raise AssertionError(f"examples: the payload came back on "
                             f"{pay.payloads['emb'].device}")
    # their graphs go now, not when a later phase's collection finds them
    # (a graph reset while another daemon captures breaks that capture)
    for d in [db] + made:
        d.drain_warmup()
        release(d)
    want = ["page 1 fragments: [{'page_id': 1, 'user_id': 10, 'kind': "
            "'header'}, {'page_id': 1, 'user_id': 11, 'kind': 'body'}]",
            "avg weight: 0.5625", "expire page 2   -> 2 rows",
            "expire user 11  -> 1 rows", "rows left: 1"]
    if lines[:5] != want:
        raise AssertionError(f"examples: quickstart printed {lines[:5]}")
    del db, made, pay
    gc.collect()
    emit({"phase": "examples", "card": card, "quickstart": lines[:6],
          "cms": cms, "cms_requests": CMS.REQUESTS})


def compressed_step(dev, want) -> dict:
    """One SMOKE step through ``make_compressed_grad_fn`` over (pod 2,
    data 1, model 2) of cuda:0 against the same on the CPU: the loss
    within 1e-4 (relative) and every gradient within 2/63 of the CPU's
    largest entry of its leaf (a value of either pod may round across an
    int8 boundary: a quantum is 1/63 of the largest there)."""
    from repro_torch.data.synthetic import make_batch
    from repro_torch.parallel import compression as COMP
    from repro_torch.training.loop import to_device
    from repro_torch.training.step import make_loss_grad_fn
    arch, mshape = TP_COMPRESS
    cfg = configs.get_smoke(arch)
    out = {}
    for where in (torch.device("cpu"), dev):
        with MESH.force_device_count(int(np.prod(mshape))):
            mesh = MESH.make_debug_mesh(*mshape[1:], pods=mshape[0],
                                        device=where)
        params = TF.init_model(torch.Generator().manual_seed(SEED), cfg,
                               "cpu")
        params = SHD._tree_map(lambda t: t.to(where), params)
        batch = to_device(make_batch(cfg, 4, 64, seed=SEED), where)
        pl = SHD.place_params(params, param_axes(cfg),
                              SHD.TRAIN_PARAM_RULES, mesh)
        run = COMP.make_compressed_grad_fn(make_loss_grad_fn(cfg), mesh)
        loss, g, _ = run(pl, batch, COMP.init_error_state(pl, mesh))
        out[str(where)] = (float(loss), [SHD.join_placed(x, "cpu") for x in
                                         _placed_leaves(g)])
    if dev.type == "cuda":   # two layers a pod, a coordinate: fwd + bwd
        n = 2 * 2 * cfg.n_layers
        for k in FLASH_TRAIN:
            want[k] += n
    (lc, g_cpu), (ld, gd) = out["cpu"], out[str(dev)]
    worst = 0.0
    for a, c in zip(gd, g_cpu):
        quantum = float(c.abs().max()) * 2 / 63 + 1e-12
        worst = max(worst, float((a - c).abs().max()) / quantum)
    rel = abs(ld - lc) / abs(lc)
    return {"arch": cfg.name, "mesh": dict(zip(("pod", "data", "model"),
                                               mshape)),
            "loss_card": ld, "loss_cpu": lc, "loss_rel_diff": rel,
            "grad_max_diff_in_quanta": worst,
            "ok": rel <= 1e-4 and worst <= 1.0}


def main():
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = phase_device()
    phase_build()
    # first, in a process that has profiled nothing yet: long runs of
    # profiled windows were seen to lose some kernel records
    phase_comparable(dev, card)
    timing, errs = phase_kernels(dev, card)
    for phase in (phase_kernels_attention, phase_kernels_mamba,
                  phase_kernels_attention_bwd, phase_kernels_mamba_bwd):
        t, e = phase(dev, card)
        timing.update(t)
        errs.update(e)
    check_bounds()

    # each main path runs with the launch counts zeroed right before it and
    # read right after it; every kernel that path must run has to show up
    scan_compact = ("relscan_scan", "relscan_compact")
    serve: dict = {}   # each serve path's engine, for the profile phase
    zamba: dict = {}
    int8_yi: dict = {}
    int8_zamba: dict = {}
    mesh_held: dict = {}
    seqpar_held: dict = {}
    tp_held: dict = {}
    train_tp_held: dict = {}
    dryrun_held: dict = {}
    # the kv table has no payload, so the serve paths' DELETEs take the
    # mask-only route (the scan, no compaction), as in the reference
    serve_need = ("flash_attention", "paged_attention", "relscan_scan")
    # the new archs' engines are not held: each path's model takes the
    # card alone (gemma3-27b's weights 54 GB), and ends with its engine
    # and weights released
    new = {name: {} for name in NEW_SERVE}
    trained: dict = {}
    paths = (
        # training first: its gemma2-2b state takes ~45 GB of the card
        ("train", lambda: phase_train(card, dev, trained), TRAIN_NEED),
    ) + tuple(
        (name, lambda name=name: phase_serve(
            card, dev, new[name], NEW_SERVE[name][0], name=name,
            keep=False, **NEW_SERVE[name][1]),
         # falcon-mamba is attention-free: no flash or paged launch (its
         # Mamba1 scan is plain PyTorch, as the reference's is jnp); its
         # requests allocate no block, but finish_request and evict_user
         # still run their DELETEs on the kv table, as the reference's
         # engine does, and each one scans the table (so does the prime
         # run of the DELETE plan that the table's CREATE-time warm-up
         # captures)
         ("relscan_scan",) if name == "serve_falcon_mamba" else serve_need)
        for name in NEW_SERVE) + (
        # the serve paths first: their warm-round check reads the card's
        # copy records, which a longer profiled process was seen to lose
        ("serve", lambda: phase_serve(card, dev, serve), serve_need),
        ("serve_zamba2", lambda: phase_serve(
            card, dev, zamba, "zamba2-2.7b", max_seq=512,
            long_prompt=ZAMBA_LONG_PROMPT, name="serve_zamba2", atol=None),
         serve_need + ("mamba2_scan",)),
        # the int8 arena, on the bf16 paths' weights and traffic
        ("serve_int8", lambda: phase_serve(card, dev, int8_yi,
                                           name="serve_int8", bf16=serve),
         serve_need),
        ("serve_int8_zamba2", lambda: phase_serve(
            card, dev, int8_zamba, "zamba2-2.7b", max_seq=512,
            long_prompt=ZAMBA_LONG_PROMPT, name="serve_int8_zamba2",
            atol=None, bf16=zamba),
         serve_need + ("mamba2_scan",)),
        # the serving mesh over repeated cuda:0, and sequence-parallel
        # attention in a training step
        ("serve_mesh", lambda: phase_serve_mesh(card, dev, mesh_held),
         ("paged_attention_wide", "paged_attention_lse")),
        ("train_seqpar", lambda: phase_train_seqpar(card, dev, seqpar_held),
         FLASH_TRAIN),
        # tensor-parallel weights over repeated cuda:0: the serve step and
        # prefill, then a training step and the compressed gradients
        ("serve_tp", lambda: phase_serve_tp(card, dev, tp_held),
         ("paged_attention_wide", "paged_attention_lse", "flash_attention")),
        ("train_tp", lambda: phase_train_tp(card, dev, train_tp_held),
         FLASH_TRAIN),
        # the dry run's walks against the same steps on the card
        ("dryrun", lambda: phase_dryrun(card, dev, dryrun_held),
         FLASH_TRAIN),
        # the port's two examples, as a user runs them (their daemons
        # released at the end)
        ("examples", lambda: phase_examples(card), scan_compact),
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
        ("mesh", lambda: phase_mesh(card),
         scan_compact + ("hash_build", "hash_probe")),
        ("snapshot", lambda: phase_snapshot(card),
         scan_compact + ("hash_build", "hash_probe")),
        ("cluster", lambda: phase_cluster(card),
         scan_compact + ("hash_build", "hash_probe")),
        # the daemons are child processes: no launch of theirs is counted
        ("cluster_chaos", lambda: phase_cluster_chaos(card), ()),
    )
    launches = {k: 0 for k in _build.KERNELS}
    for path, drive, need in paths:
        t_path = time.perf_counter()
        _build.reset_launches()
        drive()
        got = dict(_build.launches)
        # collect the path's garbage now, so that its tensors and graph
        # pools go back to the card before the next path allocates
        gc.collect()
        emit({"phase": "launches", "path": path, "launches": got,
              "seconds": round(time.perf_counter() - t_path, 1)})
        missing = [k for k in need if got[k] == 0]
        if missing:
            raise AssertionError(f"{path}: kernels never launched on this "
                                 f"path: {missing} ({got})")
        held = {"serve": serve, "serve_zamba2": zamba, "serve_int8": int8_yi,
                "serve_int8_zamba2": int8_zamba, "train": trained,
                "serve_mesh": mesh_held, "train_seqpar": seqpar_held,
                "serve_tp": tp_held, "train_tp": train_tp_held,
                "dryrun": dryrun_held, **new}.get(path)
        if held is not None:  # one launch per layer per prefill / round /
            # training step (and recompute)
            if any(got[k] != n for k, n in held["want"].items()):
                raise AssertionError(f"{path}: launches {got}, expected "
                                     f"{held['want']}")
        for k, n in got.items():
            launches[k] += n
        if path == "serve_int8_zamba2":   # hand the int8 engines back
            int8_yi.clear(), int8_zamba.clear()
            torch.cuda.empty_cache()
        if path in new:   # its weights are garbage now: hand them back
            gc.collect()
            torch.cuda.empty_cache()
    emit({"phase": "main_path_launches", **launches})
    emit({"phase": "profiler_edges", **profiler_edges()})
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
        if name == "paged_attention":   # the int8 read path (serve_int8)
            kernels[-1]["int8_arena"] = {
                "source": "src/repro_torch/csrc/paged_attention_int8.cu",
                **{k: timing["paged_attention_int8"][k]
                   for k in ("shape", "ms", "device_ms", "plain_ms",
                             "bound_ms", "bound_by", "bf16_arena_device_ms")}}
        # the shard axis (S = 8 shards of 16,384 rows, one call) beside
        # the same work as 8 separate unsharded calls
        rows = [r for r in timing["shard_axis"] if r["kernel"] == name]
        if rows:
            kernels[-1]["shard_axis"] = [
                {k: r[k] for k in ("shape", "device_ms", "bound_ms",
                                   "separate_calls_device_ms",
                                   "profile_windows")}
                for r in rows]
    # each training kernel at its training shape, with a second shape (the
    # row's "alt": gemma2's window 4,096; zamba2's 300-token prefill)
    for name, (src, replaces) in TRAIN_SOURCES.items():
        t, alt = timing[f"{name}_main"], timing[f"{name}_alt"]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], "ms": t["ms"],
                        "device_ms": t["device_ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"], "shape": t["shape"],
                        alt["alt"]: {k: alt[k] for k in (
                            "ms", "device_ms", "plain_ms", "bound_ms",
                            "library_ms")}})
        z = timing.get(f"{name}_zamba2")   # the backward's third shape
        if z is not None:
            kernels[-1][z["alt"]] = {k: z[k] for k in (
                "shape", "ms", "device_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")}
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start, 1)})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)



if __name__ == "__main__":
    main()
