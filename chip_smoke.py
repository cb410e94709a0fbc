#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--rows N] [--seed S]

Run from the root of the repository on a machine with a CUDA card and
``nvcc``. It imports nothing of JAX and nothing of the JAX package. Phases,
each of which exits nonzero on failure:

1. Environment: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions, and the ``nvcc`` build of every kernel in
   ``src/repro_torch/csrc`` (time and ``ptxas`` register counts).
2. The main path at full size, with the kernel launch counters set to 0
   just before it and read just after: TPC-H SF10 ``lineitem.l_shipdate``
   (59,986,052 rows, uniform days in [0, 2555) from ``--seed``, as the
   reference generates it) in 50-tuple pages; ``ShardedHippoIndex.create``
   with 4 shards, H=400, D=0.2 on the card; then ``QueryEngine(batch=64)``
   and ``QueryEngine(batch=64, top_k=32)`` each serve 256 seeded predicates
   (one day, 10 days, 100 days). The first batch must fall back and widen
   its slab. Every count and row-id list is checked against a brute-force
   scan on the card, and every kernel must have launched.
   2b. The dense and single-query paths, with the counters set to 0 just
   before and read just after: the Lineitem table of ``--rows`` rows from
   ``storage.tpch.generate_lineitem(rows, seed)`` and the unsharded
   ``HippoIndex`` on its ``l_shipdate`` (``build_shipdate_index``); 24
   seeded ``search`` calls whose tuple masks must equal brute force; TPC-H
   Q6, Q15 and Q20 at ``selectivity_window(0.01)``, equal to the same
   queries over the brute-force mask; then 256 predicates through
   ``QueryEngine(mode="dense")`` on the HippoIndex, and phase 2's 256
   through the routed and the fused (``sharded=False``) dense engines on
   the sharded index: every count equals brute force, and on the sharded
   index every ticket's pages_inspected and entries_matched equal the
   compact engine's. Every kernel of these paths must have launched.
   2c. Maintenance on phase 2's sharded index, with the counters set to 0
   just before and read just after: 64 eager ``insert`` calls, one
   ``insert_batch`` of ``--rows``/1000 rows (new pages of the last shard;
   the table grows past its capacity), then through
   ``QueryEngine(drain_policy="sync")`` 64 ``write``s and one ``delete`` of
   one day, which vacuums every shard; then 8 rounds of one ``write`` and
   one compact batch of 64 predicates, each batch timed with and without a
   write before it (the batch after a write copies the page it changed
   into the table's slab view). Phase 2's 256 predicates then run through
   both compact engines again and every count and row-id list must equal a
   brute-force scan of the mutated table on the card; the bucket probe, the
   filter and the inspection must have launched. A ``maintenance`` JSON
   line carries the insert, write, vacuum and read-after-write times and
   the peak device memory of the mutations and of the whole phase. The
   bucket probe's inputs in the phase (the insert batch's values, each
   vacuum's re-probed tuples, single values) are kept for phase 3.
   2d. The maintenance writer on phase 2's sharded index, with the counters
   set to 0 just before and read just after: ``QueryEngine(batch=64,
   top_k=32)`` with the default drain policy (``between_batches``, one unit
   per batch) stages 59,986 writes (one TPC-H RF1 refresh, 0.1% of SF10)
   of shipdates uniform over the 90 days after the table's last day, one
   compact batch of 64 predicates (a quarter reaching into the new days)
   after every 4,096; the drift trigger must schedule a remap of all 4
   shards at the 256th write, and the batches drain it one unit at a time,
   then the insert queues. Each batch is timed with its drain and again
   through a reader engine on the same writer that never drains. Then
   ``flush``, the ``delete`` of one old day, and 4 batches that drain the
   vacuums. Every count (table plus live staged rows) and row id equals a
   brute-force scan on the card. A ``writer`` JSON line carries the staged
   write times, the drain time per unit kind, the slab patch times, the
   batch times with and without a drain, the mixed stream's q/s, the
   engine's drain and drift counters and the peak device memory.
   2e. Learned summaries, with the counters set to 0 just before and read
   just after: ``ShardedHippoIndex.create(summary="learned")`` (4 shards,
   H=400) over ``l_quantity`` of phase 2b's Lineitem (50 distinct values);
   256 seeded predicates through the compact (``top_k=32``) and routed
   engines, exact against brute force; then 4,096 staged writes and
   ``resummarize()``, which must take one learned refit, and the same
   predicates exact again. A ``learned`` JSON line carries the fit and build
   times, the model's segments and error, the buckets the build sample
   occupies under the learned and the equal-mass bounds, and q/s. The index
   is freed when the phase ends.
   2g. The paper's comparisons (Figures 6 and 7) on ``l_shipdate`` of phase
   2b's Lineitem, with the counters set to 0 just before and read just
   after (run after 2e, before 2f): ``HippoIndex.create`` (H=400, D=0.2,
   4,096 spare pages), the device ``BPlusTree.bulk_load`` (fanout 256) and
   ``MinMaxIndex.build`` at 1 and 128 pages a range, each timed; the
   ``nbytes`` of each (the tree's must be 726,415,704 B at SF10, with
   234,321, 916, 4 and 1 nodes a level) and the device bytes each holds;
   the windows ``selectivity_window(sf)`` for sf in 1e-5 .. 1e-1, each
   timed as a median of 16 through Hippo ``search``, the tree's
   ``count_range`` and ``range_search``, min-max and the full scan, every
   count equal to brute force on the card and every ``range_search`` equal
   to the brute-force tids as a set; then 64 eager Hippo inserts and an
   ``insert_batch`` of the first 8,192 shipdates of a TPC-H RF1 refresh,
   and the same 8,192 through per-key tree inserts (node reads, writes and
   splits beside the cost model's I/Os); 16 windows of the same form exact
   again on both; 4 windows whose lower bound is a key, where every row the
   tree misses must have that key (the reference's descent, reproduced);
   one inserted key in 64 deleted. A ``baselines`` JSON line carries it
   all with the phase's seconds and peak device memory; the bucket probe,
   the single-query filter and the inspection must have launched.
   2h. HippoKV on a decode cache of Llama-3-8B's KV widths (B=1, 32,768
   positions, 8 heads of 128; keys clustered by page from ``--seed``):
   ``build_kv_index`` at the default ``KVIndexConfig`` and at 16 channels,
   32 buckets, 8 kept, each build launching the bucket probe once per
   channel; ``query_page_mask`` at ``min_channels`` 1 and 4 and
   ``hippo_kv_attention`` timed; attention with every page kept equal to
   float64 softmax attention within 1e-5. A ``kv`` JSON line carries the
   times, the pruned share, the kept mass and the index bytes against the
   cache's.
   2i. The model-serving path (run after 2h, before 2f), with the counters
   set to 0 just before and read just after (it runs no Hippo kernel:
   attention, MoE and the recurrences are plain PyTorch, as the reference's
   are plain ``jnp``): ``smollm-360m`` at its published widths and full
   depth (32 layers, d=960, ~409 M parameters) in bfloat16 from a seeded
   generator on the card; the port's ``BatchServer`` serves 16 requests of
   256 prompt tokens at batch 8, 64 tokens each, every token in [0, V). A
   ``serve`` JSON line carries tokens/s, the median prefill ms per request,
   the median decode-step ms and the peak device memory. Then, in float32
   with TF32 off, a batch of 2: prefill of all but the last 3 positions and
   3 decode steps, each step's logits against the teacher-forced forward
   within atol = rtol = 1e-3, for smollm at full depth over 16 positions
   and for one pattern unit of every other block family at its published
   widths (qwen2-moe with capacity factor 8, recurrentgemma over 2,304
   positions so that its 2,048-token rolling buffer wraps, rwkv6, qwen2-vl,
   musicgen, stablelm); a ``serve check`` line carries each max error.
   2j. Placement, with the counters set to 0 before and read after each
   placement: phase 2's sharded index as 2c and 2d left it, placed with
   ``place_sharded`` on ``make_shard_mesh(4)`` (one card: plain tensors, the
   unplaced path) and on a 4-entry mesh of the card (each shard block
   searched where it lives, results summed on the first); phase 2's 256
   predicates in batches of 64 through ``search_many_sharded`` and the
   compact search (top_k=32), every field equal to the unplaced call's and
   the counts and row ids to brute force; one batch timed for each
   placement and unplaced; ``reshard_for_mesh`` of a seeded tree onto
   meshes of 8 and 2 entries, block sums exact and block counts as the
   specs give. A ``placement`` JSON line carries it.
   2k. Training (run after 2j, before 2f), with the counters set to 0 just
   before and read just after: ``synthesize_corpus`` of 65,536 sequences of
   513 tokens (1,024 pages of 64; vocabulary 49,152) from ``--seed`` and
   ``HippoDataPipeline.create`` on the card with quality in [0.5, 1] (the
   bucket probe builds the index, the single-query filter and inspection
   select): the selected sequences equal brute force and fewer than all
   pages are inspected. Then ``smollm-360m`` at its published widths and
   full depth in bfloat16 with float32 moments, remat on, through
   ``make_train_step`` under a one-card mesh: 3 + 30 steps of batch 8 x 512
   tokens from the pipeline (lr 1e-3, warmup max(2, steps // 10)), the
   last 30 timed, each ending in a synchronize; every loss finite and the
   last five's mean below the first five's. The whole state is saved with
   ``CheckpointManager`` in a fresh temporary directory (removed at the end
   of the phase) and restored bit for bit; two steps from the restored
   state give the uninterrupted run's losses within 1e-3 relative, and a
   step at ``accum=2`` on the same batch its loss within 1e-2. Then the
   reduced ``smollm-360m``, ``qwen2-moe-a2.7b``, ``recurrentgemma-9b`` and
   ``rwkv6-3b`` in float32 (TF32 off) take two steps on the same batch on
   the card and on the CPU: loss and grad norm within 1e-4 relative. A
   ``train`` JSON line carries the step times, tokens/s, the step's bound,
   the memory, the losses, the pipeline's build and select times, the
   checkpoint's bytes and times and the card-against-CPU differences.
   2l. The dry run at published widths (run after 2k, before 2f), with the
   counters set to 0 just before and read just after (it runs no kernel):
   ``launch.dryrun.main(["--mesh", "both", "--out", D])`` in a fresh
   temporary directory prices all 64 (arch x shape x mesh) cells against
   the card's memory, exit 0, and every record must carry the reference's
   keys; then the blocks that mesh position (0, 0) holds of every
   parameter, both moments, the step and the batch of the largest cell
   (llama4-maverick-400b-a17b ``train_4k`` single-pod, ~8.80 GiB) are
   allocated on the card with ``torch.empty``: the bytes asked of the
   caching allocator (``requested_bytes``) must equal the record's
   ``argument_bytes_per_device``, and the rise of ``memory_allocated()``
   may exceed them only by the allocator's rounding (512 B a block, up to
   1 MiB of a large block it does not split); the blocks are freed. A
   ``dryrun`` JSON line carries each cell's argument GiB, the card's
   memory, the three byte counts and the tensors, and the phase's seconds.
   2m. The examples (run after 2l, before 2f): the six modules of
   ``repro_torch.examples`` (the README's Quickstart) through their argv
   parsers on the card at the reference examples' sizes, each in a fresh
   temporary directory with the counters set to 0 before and read after.
   ``quickstart``, ``engine_serving``, ``hippo_data_pipeline`` and
   ``hippokv_longcontext`` also run with ``--device cpu``: every line
   equal once the timing fields are masked, and the first three's equal
   to the numbers the reference examples print. ``serve_decode`` keeps its
   asserts; ``train_lm`` takes its 300 steps, its first three losses
   within 1e-4 relative (TF32 off) of the train CLI's on the CPU from the
   same weights. Then ``engine_serving.run`` on phase 2's ``l_shipdate``
   sorted, as a time-ordered append leaves it (``--rows`` rows, 50 a
   page): 200 predicates of 1, 10 and 100 days (a quarter on the last 55
   days and the appended ones), 64 rows of the 90 days past the last and
   a delete of days [639, 664], 1% of the domain; the example's asserts
   hold every engine against the per-query loop and a synchronous twin,
   and every count is held against brute force on the card. An
   ``examples`` JSON line carries each example's seconds, launches and
   masked lines, and the SF10 run's q/s per engine, shard dispatches and
   pruned shards, selected-page ratio, gather occupancy, fallbacks, drain
   ms and peak device memory; every kernel must have launched in both.
   2f. Durability on phase 2's index as 2c and 2d left it, with the counters
   set to 0 just before and read just after, in a fresh temporary
   directory (its filesystem and free bytes are printed; it is removed at
   the end): ``QueryEngine(batch=64, top_k=32, storage_dir=D)`` makes the
   initial full save (collect and write timed apart; ``disk_usage``'s
   table and index bytes, and the index bytes per live tuple); 4 rounds of
   1,024 journaled writes (one fsync a record; the ack latency) and one
   compact batch, whose drain commits a delta; a one-day ``delete`` and
   batches that drain its vacuums (and stage writes when nothing is
   pending) until the chain folds into a new full base; then a crash
   injected at ``drain.pre_swap`` and one at ``truncate.pre`` after a
   commit, each followed by dropping the engine, freeing its memory and
   ``QueryEngine.recover(D)`` (read with the CRC, decode with the upload,
   the journal replay and the new base timed apart), with the table, the
   staged rows and 256 counts equal to the acknowledged state; a
   writer-less ``ShardedHippoIndex.load(D)`` after a flush, exact against
   brute force; and every registered crash site through
   ``resilient_serve`` on an index of ``--rows``/100 rows
   (``background_save`` for ``persist.in_flight``), each firing and
   recovering the counts of the base rows plus every acknowledged write. A
   ``durable`` JSON line carries the times, bytes and the peak device
   memory; the filter, the inspection and the bucket probe must have
   launched. Phase 3 then runs on the recovered index.
3. Each kernel against its plain PyTorch version on the card, exactly, at
   the main paths' shapes and at ragged edges; then the kernel, the plain
   version and (where one exists) the one PyTorch call that computes the
   same function are timed with CUDA events (the bucket probe with its
   ``nan_last`` flag set, as the core calls it, and held against its plain
   version with NaN values with the flag set and clear). For the joint-bucket
   filters,
   the single-query inspection and the bucket probe also the card's own
   streaming of the bytes they must move (fills of their outputs, reads of
   their inputs, a float32 -> int32 copy); for the bucket probe also its
   time at shard 1's view of the build (a base 8 mod 16), at a predicate
   conversion's 128 values and at each input phase 2c gave it (held there
   with ``nan_last`` set and clear, at the input's own offset within 16
   bytes). Phase 3 runs after phases 2c-2f, so the filter, the inspection
   and the bucket probe are held and timed on the mutated, remapped and
   recovered index.
4. The roofline of phase 3's kernels: ``repro_torch.roofline`` measures the
   card's device-to-device copy rate (``cuda_stream``, 1 GiB, best of 5)
   and restates phase 3's times with the reference's cost models at phase
   3's shapes (``batch_filter_cost`` for A and D, ``compact_inspect_cost``
   for B over all S slabs of the launch, ``bucketize_cost``,
   ``page_inspect_cost``, ``bitmap_and_cost``; batched E has no model and
   is left out), as ``report.build_table`` against ``cuda_stream`` and
   against ``h100_sxm``; a ``roofline`` JSON line carries per kernel the
   model's bytes, the bytes phase 3's bound counts once, their ratio and
   both fractions. The models count one re-read of A's, D's and B's
   operands per query, which the kernels do not pay, so those fractions
   exceed 1: they are not bounds.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.

``--baseline-csrc DIR`` also builds the CUDA sources in DIR (an earlier
design of ``src/repro_torch/csrc``, with the same C entry points) and times
its ``batch_filter`` (sharded and unsharded), ``compact_inspect``,
``page_inspect_many``, ``page_inspect`` and ``bucketize`` (shard 0, shard
1's view and 128 values) against the package's at the main paths' shapes,
in turns (baseline, package, package, baseline), after checking that the
two give the same results. An earlier ``bucketize.cu`` without the
``nan_last`` argument is bound at its own signature.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

SF10_ROWS = 59_986_052          # TPC-H SF10 lineitem cardinality
SHIPDATE_DAYS = 7 * 365          # the reference's l_shipdate domain [0, 2555)
PAGE_CARD = 50
NUM_SHARDS = 4
RESOLUTION = 400
DENSITY = 0.2
BATCH = 64
TOP_K = 32
NUM_PREDS = 256
WIDTHS = (0, 9, 99)              # one day, 10 days, 100 days (inclusive)
NUM_SEARCHES = 24                # single-query searches of phase 2b
EAGER_INSERTS = 64               # eager inserts and engine writes of phase 2c
READ_AFTER_WRITE = 8             # phase 2c's rounds of one write + one batch
RF1_ROWS = 59_986                # phase 2d: one TPC-H RF1 refresh at SF10
NEW_DAYS = 90                    # its shipdates: the days after the last
WRITES_PER_BATCH = 4096          # phase 2d's writes between two batches
DRIFT_MIN_OBSERVED = 256         # the engine's default drift trigger
LEARNED_WRITES = 4096            # phase 2e's staged writes before the refit
QUANTITY_WIDTHS = (0, 4, 23)     # phase 2e: one value, 5 values, Q6's range
TPCH_SF = 0.01                   # selectivity of the TPC-H windows
DURABLE_WRITES = 4096            # phase 2f's journaled writes, wal_sync on
DURABLE_ROUNDS = 4               # ... in rounds of writes then one batch
CRASH_WRITES = 512               # staged before each injected crash
SWEEP_ROWS_DIVISOR = 100         # the site sweep's depth: SF10 / 100
SWEEP_WRITES = 36                # acknowledged writes per swept site
QUERY_ITERS = 16                 # phase 2g: each query timed as a median
SELECTIVITIES = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1)   # Fig. 7's windows
MINMAX_PPR = (1, 128)            # pages per min-max range; 128 is BRIN's
BASELINE_SPARE_PAGES = 4096      # as bench_fig6_overhead.py's insert table
BASELINE_INSERTS = 8192          # phase 2g's inserts: RF1's first 8,192
DELETE_EVERY = 64                # then one inserted key in 64 deleted
AFTER_INSERT_QUERIES = 16
FAULT_WINDOWS = 4                # ten-day windows whose lower bound is a key
# The B+-tree at SF10, fanout 256, by the reference's accounting: 234,321
# leaves, then 916, 4 and 1 internal nodes
BTREE_SF10_BYTES = 726_415_704
BTREE_SF10_NODES = (234_321, 916, 4, 1)
KV_SHAPE = (1, 32_768, 8, 128)   # Llama-3-8B's KV heads, 32K positions
# KVIndexConfig at its defaults (= num_channels=8, resolution=16,
# keep_buckets=4) and a finer one
KV_CONFIGS = ({}, {"num_channels": 16, "resolution": 32, "keep_buckets": 8})
KV_ATOL = 1e-5
# Phase 2i: the serving run and the decode-against-forward checks
SERVE_ARCH = "smollm-360m"
SERVE_REQUESTS = 16
SERVE_BATCH = 8
SERVE_PROMPT = 256
SERVE_GEN = 64
CHECK_BATCH = 2
CHECK_POSITIONS = 16
CHECK_TOL = 1e-3
# one pattern unit of every other block family; recurrentgemma's prompt
# (2,301 tokens) is longer than its 2,048 window, so the rolling buffer wraps
FAMILY_CHECKS = (("qwen2-moe-a2.7b", CHECK_POSITIONS),
                 ("recurrentgemma-9b", 2304), ("rwkv6-3b", CHECK_POSITIONS),
                 ("qwen2-vl-7b", CHECK_POSITIONS),
                 ("musicgen-large", CHECK_POSITIONS),
                 ("stablelm-3b", CHECK_POSITIONS))
# Phase 2k: training at full width and depth, the Hippo-indexed corpus, a
# checkpoint of the whole state, and the card against the CPU
TRAIN_ARCH = "smollm-360m"
TRAIN_SEQS = 65_536              # 1,024 pages of 64 sequences
TRAIN_SEQ_LEN = 513              # 512 inputs and their next tokens
TRAIN_PAGE_CARD = 64
TRAIN_QUALITY = (0.5, 1.0)
TRAIN_BATCH = 8                  # 4,096 tokens a step
TRAIN_WARMUP = 3                 # untimed steps before the timed ones
TRAIN_STEPS = 30
TRAIN_LR = 1e-3
ACCUM_TOL = 1e-2                 # accum=2 against accum=1, bfloat16
RESUME_TOL = 1e-3                # a restored state's next losses
CARD_CPU_TOL = 1e-4              # float32, TF32 off
CARD_CPU_ARCHS = ("smollm-360m", "qwen2-moe-a2.7b", "recurrentgemma-9b",
                  "rwkv6-3b")
# Published H100 SXM peak of dense bfloat16 tensor-core products (NVIDIA
# data sheet, 700 W)
BF16_OPS_PER_S = 989e12
# Crash site -> the durable engine whose commit path runs it (the sweep of
# the reference's tests/test_fault_recovery.py)
SITE_CONFIG = {
    "wal.pre_append": {},
    "drain.pre_swap": {},
    "delta.pre_commit": {},
    "snapshot.pre_commit": {"snapshot_mode": "full"},
    "compact.pre_commit": {"compact_every": 2},
    "truncate.pre": {},
    "persist.in_flight": {"background_save": True},
}
# Kernels of the main path (phase 2) and those ported for the dense and
# single-query paths (phase 2b); each kernel's launches are read from the run
# of its path.
MAIN_KERNELS = ("bucketize", "batch_filter", "compact_inspect")
DENSE_KERNELS = ("batch_filter_unsharded", "bitmap_and", "page_inspect",
                 "page_inspect_many")

# Phase 2l: the dry run's grid (10 architectures x their shape cells x 2
# meshes), the keys of the reference's record (dotted for nesting) beside
# the card's own, and the cell whose blocks are allocated on the card.
DRYRUN_CELLS = 64
DRYRUN_KEYS = (
    "arch", "shape", "kind", "mesh", "devices", "grad_accum", "layout",
    "compile_s", "memory.argument_bytes_per_device",
    "memory.output_bytes_per_device", "memory.temp_bytes_per_device",
    "memory.code_bytes", "memory.tpu_total_bytes_est",
    "memory.total_bytes_per_device", "cost_analysis.flops_per_device",
    "cost_analysis.bytes_accessed_per_device", "collectives",
    "fits_hbm_16gib", "hbm_bytes", "arguments_fit_hbm", "no_counterpart")
DRYRUN_HELD = ("llama4-maverick-400b-a17b", "train_4k", False)
# What the caching allocator may count beyond a request: its 512 B
# rounding, and a large block's remainder of up to 1 MiB, which it does not
# split off
ALLOC_SLACK = 2**20 + 512

# Phase 2m: the six examples (the README's Quickstart) at the reference's
# sizes, the four Hippo ones also on the CPU; then engine_serving.run at
# SF10 on phase 2's l_shipdate sorted, as a time-ordered append leaves it.
HIPPO_EXAMPLES = ("quickstart", "engine_serving", "hippo_data_pipeline",
                  "hippokv_longcontext")
# the timing fields of the examples' lines: "19.0 ms", "(10499 q/s)",
# "speedup 14.1x"
TIMING_FIELD = r"\d+(?:\.\d+)?(?= ms\b| q/s\b|x$)"
# the numbers the reference examples print at their sizes
EXAMPLE_LINES = {
    "quickstart": ("pages=2000  hippo entries=1000",
                   "hippo=65,604 B (rle 117,604)",
                   "hippo: 113 rows, inspected 450/2000 pages",
                   "entries 1000 -> 1002; query still exact: 113 rows",
                   "vacuum re-summarized 105/1002 entries",
                   "pages inspected after vacuum: 262 (was 450)"),
    "engine_serving": ("index: 5 entries, 1,924 B",
                       "15 shard dispatches, 1 pruned",
                       "selected-page ratio 96%",
                       "64 dense fallbacks",
                       "drained 64 rows in 3 units"),
    "hippo_data_pipeline": ("11776/20000 seqs, inspected 232/313 pages",
                            "5120/20000 seqs, inspected 113/313 pages",
                            "2014/20000 seqs, inspected 82/313 pages"),
}
TRAIN_LOSS_CHECKS = 3            # train_lm's first losses, card against CPU
CLUSTERED_PREDS = 200            # the reference example's stream length
CLUSTERED_WRITES = 64            # ... and its writes
CLUSTERED_DELETE = (639.0, 664.0)  # 26 of 2,555 days: 1% of the domain


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time on the card: bytes over the H100 SXM's HBM rate or
    float32 operations (outside the tensor cores, where these kernels'
    compares and word ops run) over its peak, the larger (the published
    peaks of ``repro_torch.roofline.H100_SXM``)."""
    from repro_torch.roofline import H100_SXM
    t_bytes = nbytes / H100_SXM.mem_bw * 1e3
    t_ops = ops / H100_SXM.vector_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def exact(torch, name: str, got, want) -> int:
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        diff = (got.long() - want.long()).abs()
        fail(f"{name}: kernel disagrees with its plain version "
             f"(shape {tuple(got.shape)} vs {tuple(want.shape)}, "
             f"{int((diff != 0).sum()) if diff.shape == got.shape else -1} "
             f"elements differ)")
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def make_preds(Predicate, rng, n: int) -> list:
    preds = []
    for i in range(n):
        w = WIDTHS[i % len(WIDTHS)]
        lo = int(rng.integers(0, SHIPDATE_DAYS - w))
        preds.append(Predicate.between(float(lo), float(lo + w)))
    return preds


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=SF10_ROWS,
                    help="l_shipdate rows (default: TPC-H SF10)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline-csrc", type=Path, default=None,
                    help="CUDA sources of an earlier design to time against")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels as K
    from repro_torch.core import bitmap as bm
    from repro_torch.core import index as hix
    from repro_torch.core.partition import ShardedHippoIndex
    from repro_torch.core.predicate import (Predicate, intervals,
                                            to_bucket_bitmap,
                                            to_bucket_bitmaps,
                                            upload_intervals)
    from repro_torch.kernels import _build
    from repro_torch.kernels.batch_filter import ops as bf_ops
    from repro_torch.kernels.bitmap_and import ops as ba_ops
    from repro_torch.kernels.bucketize import ops as bk_ops
    from repro_torch.kernels.compact_inspect import ops as ci_ops
    from repro_torch.kernels.page_inspect import ops as pi_ops
    from repro_torch.roofline import KERNELS as COST
    from repro_torch.runtime.engine import QueryEngine
    from repro_torch.storage.table import PagedTable

    # -- 1. environment ------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.3f} s "
          f"({lib_path.relative_to(ROOT)})")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    # -- 2. the main path ----------------------------------------------------
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    values = rng.integers(0, SHIPDATE_DAYS, args.rows).astype(np.float32)
    table = PagedTable.from_values(values, page_card=PAGE_CARD)
    preds = make_preds(Predicate, rng, NUM_PREDS)
    print(f"data: {args.rows:,} l_shipdate rows, {table.num_pages:,} pages "
          f"({time.perf_counter() - t0:.3f} s)")

    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sidx = ShardedHippoIndex.create(table, num_shards=NUM_SHARDS,
                                    resolution=RESOLUTION, density=DENSITY)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    dev = sidx.device
    # every conversion on the main path must be one launch of C's words entry
    converts = []
    convert = sidx._query_bitmaps
    sidx._query_bitmaps = lambda b: converts.append(len(b)) or convert(b)
    serve, tickets = serve_compact(torch, QueryEngine, sidx, preds)
    del sidx._query_bitmaps
    for top_k, row in serve.items():
        if (row["first_batch_fallbacks"] == 0
                or row["bucket_after_first"] <= 64):
            fail(f"top_k={top_k}: first batch did not fall back and widen "
                 f"(fallbacks {row['first_batch_fallbacks']}, bucket "
                 f"{row['bucket_after_first']})")
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print("main path: " + json.dumps({
        "rows": args.rows, "pages": table.num_pages, "shards": NUM_SHARDS,
        "pages_per_shard": sidx.spec.pages_per_shard,
        "entries": sidx.num_entries, "build_s": build_s,
        "serve": {f"top_k={k}": v for k, v in serve.items()},
        "launches": launches, "conversions": len(converts),
        "max_memory_allocated": peak}))
    for name in MAIN_KERNELS:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the main path")
    if not converts or launches["bucketize_rows_words"] != len(converts):
        fail(f"{len(converts)} conversions on the main path launched C's "
             f"words entry {launches['bucketize_rows_words']} times")
    brute_counts = check_brute_force(torch, table, dev, intervals, preds,
                                     tickets)
    print(f"main path checked: {len(preds)} counts x 2 engines and "
          f"{len(preds)} row-id lists equal brute force")

    # -- 2b. the dense and single-query paths --------------------------------
    dense = dense_paths(torch, args, K, Predicate, intervals, QueryEngine,
                        sidx, preds, brute_counts, tickets[0])
    hidx = dense["hidx"]

    # -- 2c. maintenance on the sharded index ---------------------------------
    probes = maintenance_phase(torch, args, K, intervals, QueryEngine, sidx,
                               preds)

    # -- 2d. the maintenance writer on the sharded index ---------------------
    writer_phase(torch, args, K, intervals, Predicate, QueryEngine, sidx)

    # -- 2e. learned summaries on l_quantity -----------------------------------
    learned_phase(torch, args, K, intervals, Predicate, QueryEngine,
                  PagedTable, ShardedHippoIndex, dense["li"])

    # -- 2g. the paper's comparisons: B+-tree, min-max, full scan -------------
    baselines_phase(torch, args, K, intervals, Predicate, PagedTable,
                    dense["li"])

    # -- 2h. HippoKV on a decode cache ----------------------------------------
    kv_phase(torch, args, K)
    del dense["li"]

    # -- 2i. the model-serving path --------------------------------------------
    serving_phase(torch, args, K)

    # -- 2j. placement of the sharded index on meshes --------------------------
    placement_phase(torch, K, hix, intervals, sidx, preds)

    # -- 2k. training: the Hippo-indexed corpus, steps, a checkpoint ----------
    training_phase(torch, args, K, Predicate)

    # -- 2l. the dry run at published widths ------------------------------------
    dryrun_phase(torch, K)

    # -- 2m. the examples, and engine_serving at SF10 on a clustered column ---
    examples_phase(torch, args, K, intervals, Predicate, values)

    # -- 2f. durability on the mutated sharded index ---------------------------
    # the phase drops the index (a crash) and hands back the recovered one
    held = {"sidx": sidx}
    del sidx, table
    sidx = durable_phase(torch, args, K, intervals, Predicate, QueryEngine,
                         ShardedHippoIndex, PagedTable, held)
    table = sidx.table

    # -- 3. kernels against their plain versions, then timed -----------------
    shards = sidx.state.shards
    keys, valid = sidx._slabs()
    batch = preds[:BATCH]
    qb, blo, bhi = sidx._query_bitmaps(batch)
    live = hix._live_slots(shards)
    match = bf_ops.batch_filter_sharded(qb, shards.bitmaps, live)
    page_mask = hix._expand_page_mask(shards, match, keys.shape[1])
    sel = hix._select_union(page_mask.any(dim=1), sidx.gather_cap)
    s, q, m = keys.shape[0], len(batch), sel.shape[1]
    p = keys.shape[1]
    idx = sel.clamp(max=p - 1).long()[:, None, :].expand(s, q, m)
    sel_mask = (torch.gather(page_mask, 2, idx)
                & (sel < p)[:, None, :]).contiguous()
    n0 = min(sidx.spec.pages_per_shard, table.num_pages)
    bvals = keys[0, :n0].reshape(-1).contiguous()
    bounds = shards.bounds[0].contiguous()

    report = []
    models = {}       # the reference's cost model of each kernel that has one

    # A: batch_filter
    err = exact(torch, "batch_filter",
                bf_ops.batch_filter_sharded(qb, shards.bitmaps, live),
                bf_ops.batch_filter_sharded_ref(qb, shards.bitmaps, live))
    e, w = shards.bitmaps.shape[1], shards.bitmaps.shape[2]
    once = (s * e * w * 4 + s * q * w * 4 + s * e + s * q * e,
            s * q * e * w)
    report.append(("batch_filter", err,
                   lambda: bf_ops.batch_filter_sharded(qb, shards.bitmaps, live),
                   lambda: bf_ops.batch_filter_sharded_ref(qb, shards.bitmaps,
                                                           live),
                   None, once, f"S={s} Q={q} E={e} W={w}"))
    models["batch_filter"] = COST["batch_filter"](q=q, e=e, w=w, s=s)
    # B: compact_inspect
    err_b = exact(torch, "compact_inspect",
                  ci_ops.compact_inspect(keys, valid, sel, sel_mask, blo, bhi),
                  ci_ops.compact_inspect_ref(keys, valid, sel, sel_mask, blo,
                                             bhi))
    c = keys.shape[2]
    pages_read = int((sel < p).sum())
    pairs = int(sel_mask.sum())
    once = (pages_read * c * 5 + s * m * 4 + s * q * m + q * 8
            + s * q * m * 4, pairs * c * 3)
    report.append(("compact_inspect", err_b,
                   lambda: ci_ops.compact_inspect(keys, valid, sel, sel_mask,
                                                  blo, bhi),
                   lambda: ci_ops.compact_inspect_ref(keys, valid, sel,
                                                      sel_mask, blo, bhi),
                   None, once,
                   f"S={s} Q={q} M={m} C={c} pages_read={pages_read} "
                   f"active_pairs={pairs}"))
    # the reference's model has no shard axis: the launch inspects S slabs
    models["compact_inspect"] = COST["compact_inspect"](q=q, m=s * m, c=c)
    # C: bucketize, with nan_last set as the core calls it
    err_c = exact(torch, "bucketize",
                  bk_ops.bucketize_values(bvals, bounds, RESOLUTION, True),
                  bk_ops.bucketize_ref(bvals, bounds, RESOLUTION, True))
    n = bvals.numel()
    once = (n * 8 + bounds.numel() * 4,
            n * math.ceil(math.log2(bounds.numel() + 1)))

    def library_bucketize():
        ids = torch.searchsorted(bounds, bvals, right=True) - 1
        return ids.clamp_(0, RESOLUTION - 1)

    report.append(("bucketize", err_c,
                   lambda: bk_ops.bucketize_values(bvals, bounds, RESOLUTION,
                                                   True),
                   lambda: bk_ops.bucketize_ref(bvals, bounds, RESOLUTION,
                                                True),
                   library_bucketize, once, f"N={n} H={RESOLUTION}"))
    models["bucketize"] = COST["bucketize"](n=n, h=bounds.numel() - 1)
    if not torch.equal(library_bucketize().to(torch.int32),
                       bk_ops.bucketize_values(bvals, bounds, RESOLUTION,
                                               True)):
        fail("bucketize disagrees with torch.searchsorted")
    # C again at shard 1's view of the build (base 8 mod 16) and at one
    # predicate conversion's 2Q endpoints
    n1 = min(sidx.spec.pages_per_shard,
             max(table.num_pages - sidx.spec.page_lo(1), 0))
    bvals1 = keys[1, :n1].reshape(-1)
    ends = torch.cat([blo, bhi]).contiguous()
    bk_cases = {"shard 1's view": bvals1, "128 values": ends}
    for what, vals in bk_cases.items():
        exact(torch, f"bucketize at {what}",
              bk_ops.bucketize_values(vals, bounds, RESOLUTION, True),
              bk_ops.bucketize_ref(vals, bounds, RESOLUTION, True))
        vb, vhow = bound_ms(vals.numel() * 8 + bounds.numel() * 4, 0)
        print(f"bucketize at {what}: " + json.dumps({
            "n": vals.numel(), "base_mod_16": vals.data_ptr() % 16,
            "ms": time_ms(torch, lambda: bk_ops.bucketize_values(
                vals, bounds, RESOLUTION, True), 20),
            "library_ms": time_ms(torch, lambda: torch.searchsorted(
                bounds, vals, right=True).sub_(1).clamp_(0, RESOLUTION - 1),
                20),
            "bound_ms": vb, "bound_by": vhow}))
    # C's rows entry as predicate conversion launches it: the batch's 2Q
    # endpoints under every shard's bounds row in one launch
    rows = shards.bounds.contiguous()
    exact(torch, "bucketize rows at the 2Q endpoints",
          bk_ops.bucketize_rows(ends, rows, RESOLUTION, True),
          bk_ops.bucketize_rows_ref(ends, rows, RESOLUTION, True))
    vb, vhow = bound_ms((rows.shape[0] + 1) * ends.numel() * 4
                        + rows.numel() * 4, 0)
    print("bucketize rows at the 2Q endpoints: " + json.dumps({
        "rows": rows.shape[0], "n": ends.numel(),
        "ms": time_ms(torch, lambda: bk_ops.bucketize_rows(
            ends, rows, RESOLUTION, True), 20),
        "graph_ms": graph_ms(torch, lambda: bk_ops.bucketize_rows(
            ends, rows, RESOLUTION, True), 20),
        "bound_ms": vb, "bound_by": vhow}))
    # C's words entry, predicate conversion's one launch: the batch's
    # (S, Q, W) query bitmaps, against the composition it replaced (the rows
    # entry, then a range mask packed a bit a pass, the empty predicates
    # zeroed: ~110 launches) and against the plain version; then the whole
    # conversion (``_query_bitmaps``) and its upload alone, looped, where the
    # host's enqueue decides the time
    wargs = (*upload_intervals(batch, dev), rows, RESOLUTION, True)
    wq = len(batch)

    def composed():
        ids = bk_ops.bucketize_rows(torch.cat(wargs[:2]), rows, RESOLUTION,
                                    True)
        words = bm.range_mask(RESOLUTION, ids[:, :wq], ids[:, wq:])
        return torch.where(wargs[2][None, :, None], words, 0)

    fused = bk_ops.bucketize_rows_words(*wargs)
    exact(torch, "bucketize rows words at the path shapes", fused,
          bk_ops.bucketize_rows_words_ref(*wargs))
    exact(torch, "bucketize rows words against the composition", fused,
          composed())
    exact(torch, "bucketize rows words against the batch's conversion",
          fused, qb)
    vb, vhow = bound_ms(9 * wq + rows.numel() * 4 + fused.numel() * 4, 0)
    print("bucketize rows words at the path shapes: " + json.dumps({
        "rows": rows.shape[0], "q": wq, "h": RESOLUTION,
        "w": fused.shape[2],
        "ms": time_ms(torch, lambda: bk_ops.bucketize_rows_words(*wargs),
                      20),
        "graph_ms": graph_ms(torch, lambda: bk_ops.bucketize_rows_words(
            *wargs), 20),
        "composed_ms": time_ms(torch, composed, 20),
        "composed_graph_ms": graph_ms(torch, composed, 20),
        "plain_ms": time_ms(torch, lambda: bk_ops.bucketize_rows_words_ref(
            *wargs), 20),
        "convert_ms": time_ms(torch, lambda: sidx._query_bitmaps(batch), 20),
        "upload_ms": time_ms(torch, lambda: upload_intervals(batch, dev), 20),
        "bound_ms": vb, "bound_by": vhow}))
    # C at the inputs phase 2c gave it, at their own offsets within 16 B
    for (n, mod), (vals, pbounds, h) in sorted(probes.items()):
        vals = at_offset(torch, vals, mod // 4)
        for nan_last in (True, False):
            exact(torch, f"bucketize at maintenance N={n} base_mod_16={mod} "
                  f"nan_last={nan_last}",
                  bk_ops.bucketize_values(vals, pbounds, h, nan_last),
                  bk_ops.bucketize_ref(vals, pbounds, h, nan_last))
        vb, vhow = bound_ms(n * 8 + pbounds.numel() * 4, 0)
        print("bucketize at maintenance: " + json.dumps({
            "n": n, "base_mod_16": vals.data_ptr() % 16,
            "ms": time_ms(torch, lambda: bk_ops.bucketize_values(
                vals, pbounds, h), 20),
            "library_ms": time_ms(torch, lambda: torch.searchsorted(
                pbounds, vals, right=True).sub_(1).clamp_(0, h - 1), 20),
            "bound_ms": vb, "bound_by": vhow}))

    # D: batch_filter (unsharded), at the HippoIndex batch's shapes
    hst = hidx.state
    he = hst.bitmaps.shape[0]
    hlive = hix._live_slots(hix._one_shard(hst))[0]
    hqb = to_bucket_bitmaps(batch, hst.histogram)
    err_d = exact(torch, "batch_filter_unsharded",
                  bf_ops.batch_filter(hqb, hst.bitmaps, hlive),
                  bf_ops.batch_filter_ref(hqb, hst.bitmaps, hlive))
    once = (he * w * 4 + q * w * 4 + he + q * he, q * he * w)
    report.append(("batch_filter_unsharded", err_d,
                   lambda: bf_ops.batch_filter(hqb, hst.bitmaps, hlive),
                   lambda: bf_ops.batch_filter_ref(hqb, hst.bitmaps, hlive),
                   None, once, f"Q={q} E={he} W={w}"))
    models["batch_filter_unsharded"] = COST["batch_filter"](q=q, e=he, w=w)
    # F: bitmap_and, one query of the single-query search
    one = batch[2]                         # a 100-day predicate
    qb1 = to_bucket_bitmap(one, hst.histogram).contiguous()
    err_f = exact(torch, "bitmap_and",
                  ba_ops.bitmap_and_any(hst.bitmaps, qb1, hlive),
                  ba_ops.bitmap_and_any_ref(hst.bitmaps, qb1, hlive))
    once = (he * w * 4 + w * 4 + he + he, he * w)
    report.append(("bitmap_and", err_f,
                   lambda: ba_ops.bitmap_and_any(hst.bitmaps, qb1, hlive),
                   lambda: ba_ops.bitmap_and_any_ref(hst.bitmaps, qb1, hlive),
                   None, once, f"E={he} W={w}"))
    models["bitmap_and"] = COST["bitmap_and"](e=he, w=w)
    # E: page_inspect, that query's pages and interval
    hkeys = hidx.table.device_keys(device=dev)
    hvalid = hidx.table.device_valid(device=dev)
    hp, hc = hkeys.shape
    m1 = hidx.search(one).page_mask.contiguous()
    lo1, hi1 = (t[0] for t in intervals([one], dev))
    got = pi_ops.page_inspect(hkeys, hvalid, m1, lo1, hi1)
    want = pi_ops.page_inspect_ref(hkeys, hvalid, m1, lo1, hi1)
    err_e = max(exact(torch, "page_inspect qual", got[0], want[0]),
                exact(torch, "page_inspect counts", got[1], want[1]))
    sel_pages = int(m1.sum())
    once = (sel_pages * hc * 5 + hp + hp * hc + hp * 4 + 8,
            sel_pages * hc * 3)
    report.append(("page_inspect", err_e,
                   lambda: pi_ops.page_inspect(hkeys, hvalid, m1, lo1, hi1),
                   lambda: pi_ops.page_inspect_ref(hkeys, hvalid, m1, lo1,
                                                   hi1),
                   None, once,
                   f"P={hp} C={hc} selected_pages={sel_pages}"))
    models["page_inspect"] = COST["page_inspect"](p=hp, c=hc)
    # E, batched: page_inspect_many over the HippoIndex batch's page masks
    hmatch = bf_ops.batch_filter(hqb, hst.bitmaps, hlive)
    hmask = hix._expand_page_mask(hix._one_shard(hst), hmatch[None],
                                  hp).contiguous()             # (1, Q, P)
    k1, v1 = hkeys[None], hvalid[None]
    err_m = exact(torch, "page_inspect_many",
                  pi_ops.page_inspect_many(k1, v1, hmask, blo, bhi),
                  pi_ops.page_inspect_many_ref(k1, v1, hmask, blo, bhi))
    union_pages = int(hmask[0].any(dim=0).sum())
    active = int(hmask.sum())
    once = (union_pages * hc * 5 + q * hp + q * 4 + q * 8,
            active * hc * 3)
    report.append(("page_inspect_many", err_m,
                   lambda: pi_ops.page_inspect_many(k1, v1, hmask, blo, bhi),
                   lambda: pi_ops.page_inspect_many_ref(k1, v1, hmask, blo,
                                                        bhi),
                   None, once,
                   f"S=1 Q={q} P={hp} C={hc} union_pages={union_pages} "
                   f"active_pairs={active}"))

    ragged_edges(torch, bf_ops, ci_ops, bk_ops, ba_ops, pi_ops, dev)
    print("kernels equal their plain versions at the main paths' shapes and "
          "at ragged edges")
    if args.baseline_csrc is not None:
        # the baseline's hippo_bucketize with or without nan_last (None)
        b_flag = True if nan_flag(args.baseline_csrc) else None
        b_args = (keys, valid, sel, sel_mask, blo, bhi)
        e_args = (k1, v1, hmask, blo, bhi)
        a_args = (qb, shards.bitmaps, live)
        d_args = (hqb, hst.bitmaps, hlive)
        s_args = (hkeys, hvalid, m1, lo1, hi1)
        compare_designs(torch, _build, args.baseline_csrc, {
            "batch_filter": (
                lambda: bf_ops.batch_filter_sharded(*a_args),
                lambda lib: baseline_batch_filter(torch, _build, lib,
                                                  *a_args)),
            "batch_filter_unsharded": (
                lambda: bf_ops.batch_filter(*d_args),
                lambda lib: baseline_batch_filter(torch, _build, lib,
                                                  *d_args)),
            "compact_inspect": (
                lambda: ci_ops.compact_inspect(*b_args),
                lambda lib: baseline_compact_inspect(torch, _build, lib,
                                                     *b_args)),
            "page_inspect_many": (
                lambda: pi_ops.page_inspect_many(*e_args),
                lambda lib: baseline_page_inspect_many(torch, _build, lib,
                                                       *e_args)),
            "page_inspect": (
                lambda: pi_ops.page_inspect(*s_args),
                lambda lib: baseline_page_inspect(torch, _build, lib,
                                                  *s_args)),
            # both designs through the same binding, so that the host path
            # of a 128-value launch is the same for the two; the package's
            # with nan_last set, as the core calls it
            **{f"bucketize {what}": (
                lambda v=v: baseline_bucketize(torch, _build,
                                               _build.library(), v, bounds,
                                               RESOLUTION, True),
                lambda lib, v=v: baseline_bucketize(
                    torch, _build, lib, v, bounds, RESOLUTION, b_flag))
               for what, v in (("shard 0", bvals), *bk_cases.items())}},
            graphed=[f"bucketize {what}" for what in bk_cases])

    # each kernel's launches come from the run of the path it was ported for
    path_launches = {**{n: launches[n] for n in MAIN_KERNELS},
                     **{n: dense["launches"][n] for n in DENSE_KERNELS}}
    kernels = []
    once_bytes = {}
    for (name, err, fk, fp, fl, once, shapes) in report:
        nb, how = bound_ms(*once)
        once_bytes[name] = once[0]
        k = K.KERNELS[name]
        row = {"name": name, "route": "cuda", "source": k.source,
               "replaces": k.replaces, "launches": path_launches[name],
               "max_abs_err": err, "ms": time_ms(torch, fk, 20),
               "plain_ms": time_ms(torch, fp, 2), "bound_ms": nb,
               "bound_by": how,
               "library_ms": time_ms(torch, fl, 20) if fl else None}
        print(f"{name}: {shapes} " + json.dumps(row))
        kernels.append(row)
    filled = {name: torch.empty(shape, dtype=torch.bool, device=dev)
              for name, shape in (("batch_filter", (s, q, e)),
                                  ("batch_filter_unsharded", (q, he)),
                                  ("page_inspect", (hp, hc)))}
    ids = torch.empty_like(bvals, dtype=torch.int32)
    bf_words = shards.bitmaps.reshape(-1)
    hf_words = hst.bitmaps.reshape(-1)
    hvalid_u8 = hvalid.view(torch.uint8)
    stream_yardsticks(torch, {
        "batch_filter": {
            "fill_out_ms": lambda: filled["batch_filter"].fill_(True),
            "read_in_ms": lambda: bf_words.max()},
        "batch_filter_unsharded": {
            "fill_out_ms": lambda: filled["batch_filter_unsharded"].fill_(
                True),
            "read_in_ms": lambda: hf_words.max()},
        "page_inspect": {
            "fill_out_ms": lambda: filled["page_inspect"].fill_(True),
            "read_keys_ms": lambda: hkeys.max(),
            "read_valid_ms": lambda: hvalid_u8.max()},
        "bucketize": {"copy_f32_to_i32_ms": lambda: ids.copy_(bvals)}})

    # -- 4. the roofline of phase 3's kernels -----------------------------------
    roofline_phase(torch, kernels, models, once_bytes)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def serve_compact(torch, QueryEngine, sidx, preds) -> tuple[dict, dict]:
    """``preds`` through ``QueryEngine(batch=64)`` and ``QueryEngine(batch=64,
    top_k=32)`` on ``sidx``: per top_k the serving numbers and the
    tickets."""
    serve, tickets = {}, {}
    for top_k in (0, TOP_K):
        eng = QueryEngine(sidx, batch=BATCH, top_k=top_k)
        tk = [eng.submit(p) for p in preds]
        t0 = time.perf_counter()
        eng.run_batch()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        first = (eng.stats.compact_fallbacks, eng._compact_bucket)
        eng.drain()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rest = time.perf_counter() - t1
        st = eng.stats
        serve[top_k] = {"queries": len(preds), "seconds": dt,
                        "qps": len(preds) / dt,
                        "first_batch_s": t1 - t0,
                        "qps_after_first": (len(preds) - BATCH) / rest,
                        "first_batch_fallbacks": first[0],
                        "bucket_after_first": first[1],
                        "batches": st.batches,
                        "compact_fallbacks": st.compact_fallbacks,
                        "gather_occupancy": st.gather_occupancy,
                        "selected_page_ratio": st.selected_page_ratio}
        tickets[top_k] = tk
    return serve, tickets


def check_brute_force(torch, table, dev, intervals, preds, tickets) -> list:
    """Every ticket's count, and the top_k engine's row ids, against a
    brute-force scan of ``table`` on the card; returns the counts."""
    keys_all = table.device_keys(device=dev).reshape(-1)
    valid_all = table.device_valid(device=dev).reshape(-1)
    los, his = intervals(preds, dev)
    brute_counts = []
    for q, p in enumerate(preds):
        hit = valid_all & (keys_all >= los[q]) & (keys_all <= his[q])
        count = int(hit.sum())
        brute_counts.append(count)
        ids = torch.nonzero(hit)[:TOP_K, 0].cpu().numpy()
        for top_k, tk in tickets.items():
            t = tk[q]
            if not t.done or t.count != count:
                fail(f"top_k={top_k} query {q} {p}: count {t.count} != "
                     f"brute force {count}")
        if not np.array_equal(tickets[TOP_K][q].row_ids, ids):
            fail(f"query {q} {p}: row ids differ from the brute-force "
                 f"first {TOP_K}")
    return brute_counts


def maintenance_phase(torch, args, K, intervals, QueryEngine, sidx,
                      preds) -> dict:
    """Phase 2c: eager inserts, one batch, sync engine writes, a delete
    with its vacuum and rounds of read after write on the sharded index,
    then the compact engines checked against brute force on the mutated
    table. Returns the bucket probe's inputs of the phase, one of each
    (size, base mod 16): {(n, mod): (values, bounds, resolution)}."""
    from repro_torch.core import histogram as hg
    rng = np.random.default_rng(args.seed + 2)
    table = sidx.table
    dev = sidx.device
    probe, probes = hg.bucketize_values, {}

    def recording(values, bounds, resolution, nan_last=True):
        key = (values.numel(), values.data_ptr() % 16)
        if key not in probes:
            probes[key] = (values.clone(), bounds, resolution)
        return probe(values, bounds, resolution, nan_last)

    hg.bucketize_values = recording
    torch.cuda.synchronize()
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    start = dataclasses.asdict(sidx.counters)
    start_entries = sidx.num_entries
    pages0, cap0 = table.num_pages, table.capacity_pages
    lat = []
    for v in rng.integers(0, SHIPDATE_DAYS, EAGER_INSERTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sidx.insert(float(v))
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    batch = rng.integers(0, SHIPDATE_DAYS, max(args.rows // 1000, 1)).astype(
        np.float32)
    first_page = table.append_pages(1)[0]
    t0 = time.perf_counter()
    sidx.insert_batch(batch)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    eng = QueryEngine(sidx, drain_policy="sync")
    t0 = time.perf_counter()
    for v in rng.integers(0, SHIPDATE_DAYS, EAGER_INSERTS):
        eng.write(float(v))
    torch.cuda.synchronize()
    writes_s = time.perf_counter() - t0
    vac = {}
    vacuum = sidx.vacuum

    def timed_vacuum():
        vac["dirty_pages"] = table.num_dirty
        vac["dirty_shards"] = sidx.dirty_shards().tolist()
        torch.cuda.synchronize()
        t = time.perf_counter()
        vac["entries_resummarized"] = vacuum()
        torch.cuda.synchronize()
        vac["seconds"] = time.perf_counter() - t

    sidx.vacuum = timed_vacuum
    day = float(rng.integers(0, SHIPDATE_DAYS))
    t0 = time.perf_counter()
    deleted = eng.delete(day, day)
    torch.cuda.synchronize()
    delete_s = time.perf_counter() - t0
    del sidx.vacuum
    if not vac or table.num_dirty or deleted == 0:
        fail(f"delete of day {day}: {deleted} rows deleted, vacuum ran: "
             f"{bool(vac)}, {table.num_dirty} dirty pages left")
    if (eng.stats.writes, eng.stats.deletes) != (EAGER_INSERTS, deleted):
        fail(f"engine counted {eng.stats.writes} writes and "
             f"{eng.stats.deletes} deletes")
    peak_maintenance = torch.cuda.max_memory_allocated()
    # read after write: one sync write, then one compact batch, then the
    # same batch again with no write before it; the first round (the
    # engine widens its gather bucket) is left out of the medians
    reader = QueryEngine(sidx, batch=BATCH)
    rounds = {"after_write": [], "no_write": []}
    for v in rng.integers(0, SHIPDATE_DAYS, READ_AFTER_WRITE + 1):
        eng.write(float(v))
        for what in rounds:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for p in preds[:BATCH]:
                reader.submit(p)
            reader.run_batch()
            torch.cuda.synchronize()
            rounds[what].append(time.perf_counter() - t)
    hg.bucketize_values = probe
    serve, tickets = serve_compact(torch, QueryEngine, sidx, preds)
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    counters = {k: v - start[k]
                for k, v in dataclasses.asdict(sidx.counters).items()}
    want = 2 * EAGER_INSERTS + READ_AFTER_WRITE + 1 + batch.size
    if counters["inserts"] != want:
        fail(f"maintenance counted {counters['inserts']} inserts, not {want}")
    print("maintenance: " + json.dumps({
        "eager_inserts": EAGER_INSERTS,
        "eager_insert_ms_mean": 1e3 * sum(lat) / len(lat),
        "eager_insert_ms_median": 1e3 * float(np.median(lat)),
        "eager_insert_ms_min": 1e3 * min(lat),
        "batch_rows": int(batch.size), "batch_s": batch_s,
        "batch_rows_per_s": batch.size / batch_s,
        "batch_first_page": int(first_page), "pages_before": pages0,
        "pages_after": table.num_pages, "capacity_pages_before": cap0,
        "capacity_pages_after": table.capacity_pages,
        "engine_writes": EAGER_INSERTS,
        "engine_write_ms_mean": 1e3 * writes_s / EAGER_INSERTS,
        "deleted_day": day, "deleted_rows": deleted, "delete_s": delete_s,
        "vacuum": vac,
        "read_after_write": {
            "rounds": READ_AFTER_WRITE, "batch": BATCH,
            **{f"{k}_ms_median": 1e3 * float(np.median(v[1:]))
               for k, v in rounds.items()},
            **{f"{k}_ms": [1e3 * x for x in v[1:]]
               for k, v in rounds.items()}},
        "entries_before": start_entries,
        "entries_after": sidx.num_entries, "counters": counters,
        "serve": {f"top_k={k}": v for k, v in serve.items()},
        "launches": launches, "memory_allocated_before": held,
        "max_memory_allocated_maintenance": peak_maintenance,
        "max_memory_allocated": peak}))
    for name in MAIN_KERNELS:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched in the maintenance phase")
    check_brute_force(torch, table, dev, intervals, preds, tickets)
    print(f"maintenance checked: {len(preds)} counts x 2 engines and "
          f"{len(preds)} row-id lists equal brute force on the mutated table")
    return probes


def brute_check(torch, table, dev, intervals, preds, tickets, pending,
                what: str) -> None:
    """Each ticket's count against a brute-force scan of ``table`` on the
    card plus the live staged values ``pending`` (host), and its row ids,
    if it has any (staged rows have none yet), against the scan's first
    ``TOP_K``."""
    keys_all = table.device_keys(device=dev).reshape(-1)
    valid_all = table.device_valid(device=dev).reshape(-1)
    los, his = intervals(preds, dev)
    for q, p in enumerate(preds):
        hit = valid_all & (keys_all >= los[q]) & (keys_all <= his[q])
        count = int(hit.sum()) + int(((pending >= p.lo)
                                      & (pending <= p.hi)).sum())
        ids = torch.nonzero(hit)[:TOP_K, 0].cpu().numpy()
        for t in tickets[q]:
            if not t.done or t.count != count:
                fail(f"{what} query {q} {p}: count {t.count} != brute force "
                     f"{count}")
            if t.row_ids is not None and not np.array_equal(t.row_ids, ids):
                fail(f"{what} query {q} {p}: row ids differ from the "
                     f"brute-force first {TOP_K}")


def writer_preds(Predicate, rng, n: int) -> list:
    """``n`` predicates over the shipdate domain, a quarter of them
    starting in the last 55 days of the table or the new days after it."""
    preds = make_preds(Predicate, rng, n - n // 4)
    for i in range(n // 4):
        w = WIDTHS[i % len(WIDTHS)]
        lo = int(rng.integers(SHIPDATE_DAYS - 55, SHIPDATE_DAYS + NEW_DAYS))
        preds.append(Predicate.between(float(lo), float(lo + w)))
    return preds


def writer_phase(torch, args, K, intervals, Predicate, QueryEngine,
                 sidx) -> None:
    """Phase 2d: one RF1 refresh of staged writes, drained between compact
    batches by the default policy, with the drift remap it triggers, then a
    delete and its drained vacuums; every batch exact against brute
    force."""
    rng = np.random.default_rng(args.seed + 3)
    table, dev = sidx.table, sidx.device
    new = rng.integers(SHIPDATE_DAYS, SHIPDATE_DAYS + NEW_DAYS,
                       RF1_ROWS).astype(np.float32)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    eng = QueryEngine(sidx, batch=BATCH, top_k=TOP_K, mode="compact")
    if (eng.drain_policy, eng.drain_units) != ("between_batches", 1):
        fail(f"default drain policy {eng.drain_policy!r} with "
             f"{eng.drain_units} units, not between_batches with 1")
    writer = eng.writer
    reader = QueryEngine(sidx, batch=BATCH, top_k=TOP_K, drain_policy="manual",
                         writer=writer)
    drains = {"resummarize": [], "insert": [], "vacuum": []}
    patches = []
    drain = writer.drain

    def timed_drain(max_units=None):
        before = dataclasses.replace(writer.stats)
        torch.cuda.synchronize()
        t = time.perf_counter()
        rows = drain(max_units)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        after = writer.stats
        kind = ("resummarize" if after.resummarizes > before.resummarizes
                else "vacuum" if after.vacuums > before.vacuums else "insert")
        if after.drains - before.drains == 1:
            drains[kind].append(dt)
        return rows

    sync = table.sync_slab_view

    def timed_sync():
        torch.cuda.synchronize()
        t = time.perf_counter()
        nbytes = sync()
        torch.cuda.synchronize()
        # an insert drain copies the pages it appended, a delete the slabs
        # it hit: 4 B of key and 1 B of valid a tuple
        patches.append((time.perf_counter() - t,
                        f"{nbytes // (table.page_card * 5)} pages", nbytes))
        return nbytes

    writer.drain = timed_drain
    table.sync_slab_view = timed_sync
    served = {"with_drain": [], "no_drain": []}

    def round_(what: str, pending: np.ndarray) -> None:
        preds = writer_preds(Predicate, rng, BATCH)
        tickets = []
        for name, e in (("with_drain", eng), ("no_drain", reader)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            tickets.append([e.submit(p) for p in preds])
            e.run_batch()
            torch.cuda.synchronize()
            served[name].append(time.perf_counter() - t)
        depth = writer.queue_depth
        staged = pending[len(pending) - depth:] if depth else pending[:0]
        if writer.staged_rows != staged.size:
            fail(f"{what}: {writer.staged_rows} rows staged, "
                 f"{staged.size} expected")
        brute_check(torch, table, dev, intervals, preds,
                    list(zip(*tickets)), staged, what)

    round_("warm-up batch", new[:0])            # the pruning "before" window
    served = {k: [] for k in served}
    lat = []
    written = 0
    pages0 = table.num_pages
    pruning_before = None
    while written < RF1_ROWS:
        for v in new[written: written + WRITES_PER_BATCH]:
            t = time.perf_counter()
            eng.write(float(v))
            lat.append(time.perf_counter() - t)
            written += 1
            if written == DRIFT_MIN_OBSERVED - 1 and \
                    writer.pending_resummarize_shards():
                fail("remap scheduled before drift_min_observed writes")
            if written == DRIFT_MIN_OBSERVED:
                if writer.pending_resummarize_shards() != \
                        list(range(NUM_SHARDS)):
                    fail(f"no remap of every shard scheduled after "
                         f"{written} drifting writes")
                pruning_before = eng.stats.pruning_before_resummarize
        round_(f"after {written} writes", new[:written])
    stream_s = sum(lat) + sum(served["with_drain"]) + sum(served["no_drain"])
    rounds = len(served["with_drain"])
    if writer.pending_units:
        fail(f"{writer.pending_units} drain units left after the stream")
    torch.cuda.synchronize()
    t = time.perf_counter()
    flushed = eng.flush()
    torch.cuda.synchronize()
    flush_s = time.perf_counter() - t
    if writer.queue_depth or writer.staged_rows:
        fail(f"flush left {writer.queue_depth} rows staged")
    round_("after the flush", new[:0])
    day = float(rng.integers(0, SHIPDATE_DAYS))
    torch.cuda.synchronize()
    t = time.perf_counter()
    deleted = eng.delete(day, day)
    torch.cuda.synchronize()
    delete_s = time.perf_counter() - t
    vacuum_units = len(writer.pending_vacuum_shards())
    if deleted == 0 or vacuum_units == 0:
        fail(f"delete of day {day}: {deleted} rows, {vacuum_units} dirty "
             f"shards")
    for k in range(vacuum_units):
        round_(f"vacuum batch {k}", new[:0])
    if writer.pending_units or table.num_dirty:
        fail(f"{writer.pending_units} units and {table.num_dirty} dirty "
             f"pages left after the vacuum batches")
    del writer.drain, table.sync_slab_view
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    st = eng.stats
    if st.resummarizes != NUM_SHARDS or st.drained_rows != RF1_ROWS:
        fail(f"{st.resummarizes} remaps and {st.drained_rows} drained rows")
    if not (np.asarray(sidx.bounds_epochs) == 1).all():
        fail(f"bounds epochs {sidx.bounds_epochs.tolist()} after the remap")
    with_drain = served["with_drain"][:rounds]

    def ms(xs):
        return {"median": 1e3 * float(np.median(xs)),
                "mean": 1e3 * float(np.mean(xs)), "n": len(xs),
                "all": [1e3 * x for x in xs]}

    print("writer: " + json.dumps({
        "rf1_rows": RF1_ROWS, "new_days": [SHIPDATE_DAYS,
                                           SHIPDATE_DAYS + NEW_DAYS],
        "rounds": rounds, "batch": BATCH, "top_k": TOP_K,
        "staged_write_us_median": 1e6 * float(np.median(lat)),
        "staged_write_us_mean": 1e6 * float(np.mean(lat)),
        "staged_write_us_max": 1e6 * max(lat),
        "staged_write_us_at_trigger": 1e6 * lat[DRIFT_MIN_OBSERVED - 1],
        "drain_ms": {k: ms(v) for k, v in drains.items()},
        "slab_patch_ms": [1e3 * p[0] for p in patches],
        "slab_patch_extent": [p[1] for p in patches],
        "slab_patched": all(p[2] for p in patches),
        "batch_with_drain_ms": ms(with_drain),
        "batch_with_drain_ms_median_by_kind": {
            "resummarize": 1e3 * float(np.median(with_drain[:NUM_SHARDS])),
            "insert": 1e3 * float(np.median(with_drain[NUM_SHARDS:]))},
        "vacuum_batch_with_drain_ms": ms(served["with_drain"][rounds + 1:]),
        "batch_no_drain_ms": ms(served["no_drain"]),
        "mixed_stream_s": stream_s,
        "mixed_stream_qps": 2 * BATCH * rounds / stream_s,
        "mixed_stream_writes_per_s": RF1_ROWS / stream_s,
        "flush_s": flush_s, "flushed_rows": flushed,
        "deleted_day": day, "deleted_rows": deleted, "delete_s": delete_s,
        "vacuum_units": vacuum_units,
        "engine": {"drains": st.drains, "drained_rows": st.drained_rows,
                   "resummarizes": st.resummarizes,
                   "edge_overflow_ratio": st.edge_overflow_ratio,
                   "pruning_before_resummarize": pruning_before,
                   "pruning_after_resummarize": st.pruning_after_resummarize,
                   "peak_queue_depth": st.peak_queue_depth,
                   "writes": st.writes, "deletes": st.deletes},
        "writer_vacuums": writer.stats.vacuums,
        "bounds_epochs": sidx.bounds_epochs.tolist(),
        "pages_before": pages0, "pages_after": table.num_pages,
        "launches": launches, "memory_allocated_before": held,
        "max_memory_allocated": peak}))
    for name in MAIN_KERNELS:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched in the writer phase")
    print(f"writer checked: {2 * (rounds + 1 + vacuum_units + 1)} batches "
          f"of {BATCH} counts and row-id lists equal brute force (table "
          f"plus staged rows)")


class StepTimes:
    """Wall times of named module functions, recorded by wrapping them in
    place (so callers that look them up at call time are timed) until
    ``restore``."""

    def __init__(self, torch, module, names):
        self.torch, self.module = torch, module
        self.orig = {n: getattr(module, n) for n in names}
        self.times = {n: [] for n in names}
        for n, fn in self.orig.items():
            setattr(module, n, self._wrap(n, fn))

    def _wrap(self, name, fn):
        def timed(*a, **k):
            self.torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.torch.cuda.synchronize()
                self.times[name].append(time.perf_counter() - t)
        return timed

    def take(self) -> dict:
        """The times recorded since the last take, and clear them."""
        out = {n: list(v) for n, v in self.times.items() if v}
        for v in self.times.values():
            v.clear()
        return out

    def restore(self) -> None:
        for n, fn in self.orig.items():
            setattr(self.module, n, fn)


def expected_counts(torch, eng, intervals, preds) -> np.ndarray:
    """Counts of ``preds`` by brute force over the engine's table on its
    device plus its writer's live staged rows: the acknowledged state."""
    table, dev = eng.index.table, eng.index.device
    keys = table.device_keys(device=dev).reshape(-1)
    valid = table.device_valid(device=dev).reshape(-1)
    los, his = intervals(preds, dev)
    w = eng.writer
    staged = np.concatenate([np.asarray(q.values, np.float32)[
        np.asarray(q.live, bool)] for q in w._queues.values()] or
        [np.zeros(0, np.float32)])
    return np.asarray([
        int((valid & (keys >= los[q]) & (keys <= his[q])).sum())
        + int(((staged >= p.lo) & (staged <= p.hi)).sum())
        for q, p in enumerate(preds)], np.int64)


def durable_phase(torch, args, K, intervals, Predicate, QueryEngine,
                  ShardedHippoIndex, PagedTable, held: dict):
    """Phase 2f: durability on phase 2's mutated SF10 index in a fresh
    temporary directory: the initial full save, journaled writes with a
    delta at each drain, a delete and its vacuums up to a compaction fold,
    a crash at ``drain.pre_swap`` and one at ``truncate.pre`` each
    recovered exactly, a writer-less load, then every crash site through
    ``resilient_serve`` at a smaller depth. Takes the index out of
    ``held`` (so the crashed engine's memory can be freed) and returns
    the recovered index."""
    import gc
    import shutil
    import tempfile
    from repro_torch.checkpointing import snapshot as snap
    from repro_torch.runtime import faultinject as fi
    from repro_torch.runtime.fault import resilient_serve

    rng = np.random.default_rng(args.seed + 5)
    root = Path(tempfile.mkdtemp(prefix="hippo-durable-"))
    fs = subprocess.run(["stat", "-f", "-c", "%T", str(root)],
                        capture_output=True, text=True, timeout=60)
    disk = shutil.disk_usage(root)
    print(f"durable: directory {root} on {fs.stdout.strip() or 'unknown'} "
          f"filesystem, {disk.free:,} bytes free")
    steps = StepTimes(torch, snap, (
        "collect_full_sections", "write_full_snapshot",
        "collect_delta_sections", "write_delta_snapshot", "_load_chain",
        "_build_index", "_replay_journal"))
    out = {"filesystem": fs.stdout.strip(), "free_bytes": disk.free}
    kw = dict(batch=BATCH, top_k=TOP_K)
    try:
        sidx = held.pop("sidx")
        dev = sidx.device
        torch.cuda.synchronize()
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        # 1. the initial full save
        t = time.perf_counter()
        eng = QueryEngine(sidx, storage_dir=root, **kw)
        out["initial_save_s"] = time.perf_counter() - t
        out["initial_save_steps_s"] = steps.take()
        base = root / "snap_1"
        use = snap.disk_usage(base)
        tuples = sidx.table.cardinality
        out["full"] = {**use, "live_tuples": tuples,
                       "index_bytes_per_tuple": use["index"] / tuples,
                       "entries": sidx.num_entries}
        # 2. journaled writes (one fsync a record), a delta at each drain
        ack, deltas = [], []
        days = (0, SHIPDATE_DAYS + NEW_DAYS)
        for r in range(DURABLE_ROUNDS):
            for v in rng.integers(*days, DURABLE_WRITES // DURABLE_ROUNDS):
                t = time.perf_counter()
                eng.write(float(v))
                ack.append(time.perf_counter() - t)
            preds = writer_preds(Predicate, rng, BATCH)
            want = expected_counts(torch, eng, intervals, preds)
            persists = eng.stats.persists
            t = time.perf_counter()
            got = eng.run_all(preds)
            torch.cuda.synchronize()
            batch_s = time.perf_counter() - t
            if eng.stats.persists != persists + 1 or eng._delta_seq < 1:
                fail(f"durable round {r}: the batch's drain committed no "
                     f"delta")
            if not np.array_equal(got, want):
                fail(f"durable round {r}: counts differ from brute force")
            d = root / f"delta_{eng._base_epoch}_{eng._delta_seq}"
            deltas.append({"batch_s": batch_s, **steps.take(),
                           **snap.disk_usage(d)})
        out["ack_us_median"] = 1e6 * float(np.median(ack))
        out["ack_us_mean"] = 1e6 * float(np.mean(ack))
        out["ack_us_max"] = 1e6 * max(ack)
        out["deltas"] = deltas
        # 3. a one-day delete (journaled), its vacuum drains, more rounds
        #    of writes and one batch until the chain folds into a new base
        day = float(rng.integers(0, SHIPDATE_DAYS))
        out["deleted_rows"] = eng.delete(day, day)
        commits = []
        epoch0 = eng._base_epoch
        while eng._base_epoch == epoch0:
            if len(commits) > 2 * eng.compact_every:
                fail("no compaction fold after compact_every commits")
            if not eng.writer.pending_units:
                for v in rng.integers(*days, 64):
                    eng.write(float(v))
            preds = writer_preds(Predicate, rng, BATCH)
            want = expected_counts(torch, eng, intervals, preds)
            kind = ("vacuum" if eng.writer.pending_vacuum_shards()
                    else "insert")
            chain = eng._delta_seq
            got = eng.run_all(preds)
            if not np.array_equal(got, want):
                fail(f"durable commit {len(commits)}: counts differ from "
                     f"brute force")
            commits.append({"drained": kind, "chain_before": chain,
                            "folded": eng._base_epoch != epoch0,
                            **steps.take()})
        out["commits_to_fold"] = commits
        # 4. and 5. a crash at each of two sites, each recovered exactly
        for site in ("drain.pre_swap", "truncate.pre"):
            for v in rng.integers(*days, CRASH_WRITES):
                eng.write(float(v))
            preds = writer_preds(Predicate, rng, NUM_PREDS)
            want = expected_counts(torch, eng, intervals, preds)
            tab = eng.index.table
            state = (tab.num_pages, tab.fill, tab.cardinality,
                     eng.writer.staged_rows)
            if site == "truncate.pre" and \
                    eng.writer.queue_depth == 0:
                fail("setup: nothing staged before the truncate crash")
            fi.crash_points.reset()
            fi.crash_points.arm(site)
            try:
                for p in preds[:BATCH]:
                    eng.submit(p)
                try:
                    eng.run_batch()
                except fi.InjectedCrash:
                    pass
                else:
                    fail(f"crash at {site} did not fire")
                fired = fi.crash_points.fired(site)
            finally:
                fi.crash_points.reset()
            crashed_steps = steps.take()
            if site == "truncate.pre":
                # the commit landed, the journal was not truncated: the
                # drained rows sit both in the snapshot and in the journal
                tab = eng.index.table
                state = (tab.num_pages, tab.fill, tab.cardinality,
                         eng.writer.staged_rows)
            # kill -9: the engine and its index are dropped, only the
            # directory survives
            eng.journal.close()
            held_before = torch.cuda.memory_allocated()
            del eng, sidx, tab
            gc.collect()
            torch.cuda.empty_cache()
            freed = held_before - torch.cuda.memory_allocated()
            t = time.perf_counter()
            eng = QueryEngine.recover(root, device=dev, **kw)
            torch.cuda.synchronize()
            rec_s = time.perf_counter() - t
            rec_steps = steps.take()
            sidx = eng.index
            tab = sidx.table
            got_state = (tab.num_pages, tab.fill, tab.cardinality,
                         eng.writer.staged_rows)
            if got_state != state:
                fail(f"recovery after {site}: (pages, fill, live tuples, "
                     f"staged) {got_state} != acknowledged {state}")
            t = time.perf_counter()
            first = eng.run_all(preds[:BATCH])
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t
            first_steps = steps.take()
            rest = eng.run_all(preds[BATCH:])
            if not np.array_equal(np.concatenate([first, rest]), want):
                fail(f"recovery after {site}: counts differ from the "
                     f"acknowledged state")
            out[f"crash {site}"] = {
                "fired": fired, "crashed_batch_steps_s": crashed_steps,
                "freed_device_bytes": freed, "recover_s": rec_s,
                "recover_steps_s": rec_steps,
                "first_batch_s": first_s, "first_batch_steps_s": first_steps,
                "acknowledged_live_tuples": state[2] + state[3]}
            steps.take()
        # 6. a writer-less load of the flushed directory
        eng.flush()
        preds = make_preds(Predicate, rng, NUM_PREDS)
        want = expected_counts(torch, eng, intervals, preds)
        steps.take()
        t = time.perf_counter()
        loaded = ShardedHippoIndex.load(root, device=dev)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t
        out["load_steps_s"] = steps.take()
        reader = QueryEngine(loaded, drain_policy="manual", **kw)
        tickets = [reader.submit(p) for p in preds]
        reader.drain()
        brute_check(torch, loaded.table, dev, intervals, preds,
                    [[tk] for tk in tickets], np.zeros(0, np.float32),
                    "load")
        if not np.array_equal([tk.count for tk in tickets], want):
            fail("the loaded index's counts differ from the engine's")
        del reader, loaded, tickets
        gc.collect()
        launches = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        eng.close()
        out["sites"] = site_sweep(torch, args, rng, root, Predicate,
                                  QueryEngine, ShardedHippoIndex, PagedTable,
                                  dev, fi, resilient_serve)
        out["launches"] = launches
        out["max_memory_allocated"] = peak
        print("durable: " + json.dumps(out))
        for name in MAIN_KERNELS:
            if launches[name] == 0:
                fail(f"kernel {name} was not launched in the durable phase")
        print(f"durable checked: every batch, both recoveries and the load "
              f"equal brute force; {len(fi.SITES)} crash sites recovered "
              f"exact counts")
        return sidx
    finally:
        steps.restore()
        shutil.rmtree(root)


def site_sweep(torch, args, rng, root, Predicate, QueryEngine,
               ShardedHippoIndex, PagedTable, dev, fi, resilient_serve
               ) -> dict:
    """Every registered crash site through ``resilient_serve`` on an index
    of ``--rows`` / 100 rows: a resumption-aware client writes, flushes
    after every 6 writes, and the counts after recovery equal brute force
    over the base rows plus every acknowledged write."""
    if set(SITE_CONFIG) != set(fi.SITES):
        fail(f"crash sites {fi.SITES} differ from the sweep's "
             f"{sorted(SITE_CONFIG)}")
    rows = max(args.rows // SWEEP_ROWS_DIVISOR, 1000)
    base = rng.integers(0, SHIPDATE_DAYS, rows).astype(np.float32)
    preds = make_preds(Predicate, rng, BATCH)
    out = {}
    for site in fi.SITES:
        d = root / f"sweep-{site}"
        sidx = ShardedHippoIndex.create(
            PagedTable.from_values(base, PAGE_CARD, spare_pages=64),
            num_shards=NUM_SHARDS, resolution=RESOLUTION, density=DENSITY,
            device=dev)
        kw = dict(batch=BATCH, drain_policy="manual", auto_resummarize=False,
                  **SITE_CONFIG[site])
        eng = QueryEngine(sidx, storage_dir=d, **kw)
        writes = [float(v) for v in rng.integers(
            SHIPDATE_DAYS, SHIPDATE_DAYS + NEW_DAYS, SWEEP_WRITES)]
        acked = []
        cursor = {"i": 0}

        def workload(e):
            end = min(cursor["i"] + 6, len(writes))
            while cursor["i"] < end:
                e.write(writes[cursor["i"]])      # raises: not acknowledged
                acked.append(writes[cursor["i"]])
                cursor["i"] += 1
            e.flush()
            return cursor["i"] >= len(writes)

        fi.crash_points.reset()
        fi.crash_points.arm(site)
        t = time.perf_counter()
        try:
            eng, stats = resilient_serve(
                d, workload, engine=eng,
                recover_kwargs=dict(kw, device=dev), max_restarts=6,
                backoff_base_s=0.001)
            fired = fi.crash_points.fired(site)
        finally:
            fi.crash_points.reset()
        serve_s = time.perf_counter() - t
        if fired < 1:
            fail(f"crash site {site} never fired")
        if site == "persist.in_flight":
            if stats.restores:
                fail(f"{site}: the poison fallback should heal in place")
            eng.flush_durable()
        elif stats.restores < 1:
            fail(f"{site}: the supervisor never recovered the engine")
        eng.flush()
        vals = np.concatenate([base, np.asarray(acked, np.float32)])
        want = [int(((vals >= p.lo) & (vals <= p.hi)).sum()) for p in preds]
        if eng.run_all(preds).tolist() != want or len(acked) != SWEEP_WRITES:
            fail(f"after a crash at {site}: counts differ from the "
                 f"acknowledged writes")
        eng.close()
        out[site] = {"fired": fired, "crashes": stats.crashes,
                     "restores": stats.restores, "serve_s": serve_s}
        del eng, sidx
    out["rows"] = rows
    return out


def learned_phase(torch, args, K, intervals, Predicate, QueryEngine,
                  PagedTable, ShardedHippoIndex, li) -> None:
    """Phase 2e: a learned 4-shard index over l_quantity, the compact and
    routed engines exact against brute force before and after a learned
    refit of 4,096 staged writes."""
    import gc
    from repro_torch.core import histogram as hg
    from repro_torch.core import learned as ln
    from repro_torch.core.hippo import sample_keys
    rng = np.random.default_rng(args.seed + 4)
    table = PagedTable.from_values(li.quantity, page_card=PAGE_CARD)
    preds = []
    for i in range(NUM_PREDS):
        w = QUANTITY_WIDTHS[i % len(QUANTITY_WIDTHS)]
        lo = int(rng.integers(1, 51 - w))
        preds.append(Predicate.between(float(lo), float(lo + w)))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    lidx = ShardedHippoIndex.create(table, num_shards=NUM_SHARDS,
                                    resolution=RESOLUTION, density=DENSITY,
                                    summary="learned")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    dev = lidx.device
    sample = sample_keys(table)
    t = time.perf_counter()
    hist, model = ln.build_histogram(sample, RESOLUTION, device=dev)
    fit_s = time.perf_counter() - t
    if model is None or not torch.equal(hist.bounds, lidx.state.shards.bounds[0]):
        fail("the learned fit of the build sample differs from the index's "
             "bounds")
    svals = torch.from_numpy(sample).to(dev)
    occupied = {name: int(torch.unique(hg.bucketize(h, svals)).numel())
                for name, h in (("learned", hist),
                                ("equal_mass", hg.build(sample, RESOLUTION,
                                                        device=dev)))}

    def serve(what):
        out = {}
        tickets = []
        for name, kw in (("compact", {"top_k": TOP_K}),
                         ("routed", {"mode": "dense"})):
            eng, tk, qps, first_s = serve_stream(torch, QueryEngine, lidx,
                                                 preds, **kw)
            out[name] = {"qps_after_first": qps, "first_batch_s": first_s}
            tickets.append(tk)
        brute_check(torch, table, dev, intervals, preds,
                    list(zip(*tickets)), np.zeros(0, np.float32),
                    f"learned {what}")
        return out

    before = serve("build")
    eng = QueryEngine(lidx, batch=BATCH, top_k=TOP_K)
    for v in rng.integers(1, 51, LEARNED_WRITES):
        eng.write(float(v))
    if eng.stats.learned_refits != 0 or eng.writer.staged_rows != \
            LEARNED_WRITES:
        fail(f"before resummarize: {eng.stats.learned_refits} refits, "
             f"{eng.writer.staged_rows} staged rows")
    torch.cuda.synchronize()
    t = time.perf_counter()
    remapped = eng.resummarize()
    torch.cuda.synchronize()
    resum_s = time.perf_counter() - t
    if (remapped, eng.stats.learned_refits, eng.writer.queue_depth) != \
            (NUM_SHARDS, 1, 0):
        fail(f"resummarize: {remapped} shards remapped, "
             f"{eng.stats.learned_refits} learned refits, "
             f"{eng.writer.queue_depth} rows left staged")
    after = serve("refit")
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    refit = lidx.summary_models[0]
    print("learned: " + json.dumps({
        "rows": li.card, "pages_after_writes": table.num_pages,
        "distinct_values": int(np.unique(sample).size),
        "shards": NUM_SHARDS, "resolution": RESOLUTION,
        "fit_s": fit_s, "build_s": build_s,
        "used_segments": model.used_segments, "max_error": model.max_error,
        "refit_used_segments": refit.used_segments,
        "refit_max_error": refit.max_error,
        "sample_buckets_occupied": occupied,
        "entries": lidx.num_entries,
        "serve_build": before, "serve_refit": after,
        "staged_writes": LEARNED_WRITES, "resummarize_s": resum_s,
        "learned_refits": eng.stats.learned_refits,
        "learned_fallbacks": eng.stats.learned_fallbacks,
        "bounds_epochs": lidx.bounds_epochs.tolist(),
        "launches": launches, "max_memory_allocated": peak}))
    for name in MAIN_KERNELS:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched in the learned phase")
    print(f"learned checked: {len(preds)} counts x 2 engines and row ids "
          f"equal brute force, before and after the learned refit")
    del lidx, eng, table, svals, hist
    gc.collect()
    torch.cuda.empty_cache()


def median_ms(torch, fn, iters: int = QUERY_ITERS) -> tuple[float, object]:
    """Median wall ms of ``iters`` calls of ``fn``, each ending in
    ``torch.cuda.synchronize()``, and the last call's result."""
    lat = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
    return 1e3 * float(np.median(lat)), out


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def baselines_phase(torch, args, K, intervals, Predicate, PagedTable,
                    li) -> None:
    """Phase 2g: the paper's comparisons (Figures 6 and 7) on l_shipdate of
    phase 2b's Lineitem: Hippo, the device B+-tree, min-max at 1 and 128
    pages a range and the full scan; build, storage, queries at five
    selectivities and inserts, every answer against brute force."""
    import gc
    from repro_torch.core import cost
    from repro_torch.core.baselines import BPlusTree, FullScan, MinMaxIndex
    from repro_torch.core.hippo import HippoIndex
    from repro_torch.storage import tpch
    card = li.card
    torch.cuda.synchronize()
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t_phase = time.perf_counter()

    # -- init (Fig. 6b) and storage (Fig. 6a)
    table = PagedTable.from_values(li.shipdate, page_card=PAGE_CARD,
                                   spare_pages=BASELINE_SPARE_PAGES)
    t = time.perf_counter()
    hidx = HippoIndex.create(table, resolution=RESOLUTION, density=DENSITY)
    torch.cuda.synchronize()
    init_s = {"hippo": time.perf_counter() - t}
    dev = hidx.device
    keys, valid = table.device_keys(device=dev), table.device_valid(device=dev)
    t = time.perf_counter()
    tree = BPlusTree.bulk_load(li.shipdate, PAGE_CARD)
    torch.cuda.synchronize()
    init_s["btree"] = time.perf_counter() - t
    if tree.device != dev:
        fail(f"the B+-tree's pools are on {tree.device}, not on {dev}")
    minmax = {}
    for ppr in MINMAX_PPR:
        t = time.perf_counter()
        minmax[ppr] = MinMaxIndex.build(keys, valid, ppr)
        torch.cuda.synchronize()
        init_s[f"minmax_ppr{ppr}"] = time.perf_counter() - t
    nbytes = {"hippo": hidx.nbytes(), "hippo_rle": hidx.nbytes(compressed=True),
              "btree": tree.nbytes(),
              **{f"minmax_ppr{p}": m.nbytes() for p, m in minmax.items()},
              "fullscan": FullScan.nbytes()}
    if card == SF10_ROWS and (tree.nbytes(), tree.num_nodes()) != \
            (BTREE_SF10_BYTES, BTREE_SF10_NODES):
        fail(f"B+-tree at SF10: {tree.nbytes():,} B, nodes "
             f"{tree.num_nodes()} != {BTREE_SF10_BYTES:,} B, "
             f"{BTREE_SF10_NODES}")
    device_bytes = {
        "table_views": tensor_bytes(keys, valid),
        "hippo_state": tensor_bytes(*hidx.state),
        "btree": tree.device_nbytes(),
        **{f"minmax_ppr{p}": tensor_bytes(m.mins, m.maxs)
           for p, m in minmax.items()}}

    def brute(k, v, lo, hi):
        return v & (k >= lo) & (k <= hi)

    def tids_of(mask):
        page, slot = mask.nonzero(as_tuple=True)
        return (page.to(torch.int64) << 16) | slot

    # -- queries (Fig. 7)
    queries = []
    for sf in SELECTIVITIES:
        wlo, whi = tpch.selectivity_window(sf)
        pred = Predicate.between(wlo, whi)
        lo, hi = (x[0] for x in intervals([pred], dev))
        mask = brute(keys, valid, lo, hi)
        want = int(mask.sum())
        row = {"sf": sf, "window": [wlo, whi], "count": want,
               "model_tuples": cost.query_time_tuples(sf, RESOLUTION,
                                                      DENSITY, card)}
        row["hippo_ms"], res = median_ms(torch, lambda: hidx.search(pred))
        row["hippo_pages"] = int(res.pages_inspected)
        r0 = tree.io.node_reads
        row["btree_count_ms"], got = median_ms(
            torch, lambda: tree.count_range(wlo, whi))
        row["btree_node_reads"] = (tree.io.node_reads - r0) // QUERY_ITERS
        row["btree_search_ms"], tids = median_ms(
            torch, lambda: tree.range_search(wlo, whi))
        row["btree_tids"] = tids.numel()
        counts = {"hippo": int(res.count), "btree": got,
                  "btree_search": tids.numel()}
        if not torch.equal(tids.sort().values, tids_of(mask).sort().values):
            fail(f"B+-tree range_search at sf={sf}: tids differ from brute "
                 f"force")
        for ppr, mm in minmax.items():
            row[f"minmax_ppr{ppr}_ms"], (c, pages) = median_ms(
                torch, lambda mm=mm: mm.search(keys, valid, wlo, whi))
            row[f"minmax_ppr{ppr}_pages"] = int(pages)
            counts[f"minmax_ppr{ppr}"] = int(c)
        row["fullscan_ms"], (c, _) = median_ms(
            torch, lambda: FullScan.search(keys, valid, wlo, whi))
        counts["fullscan"] = int(c)
        bad = {k: v for k, v in counts.items() if v != want}
        if bad:
            fail(f"baselines at sf={sf}: {bad} != brute force {want}")
        queries.append(row)

    # -- maintenance (Fig. 6c)
    new = tpch.generate_lineitem(RF1_ROWS, seed=7).shipdate[:BASELINE_INSERTS]
    lat = []
    for v in new[:EAGER_INSERTS]:
        torch.cuda.synchronize()
        t = time.perf_counter()
        hidx.insert(float(v))
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    t = time.perf_counter()
    hidx.insert_batch(new)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t
    io0 = dataclasses.replace(tree.io)
    rows = card + np.arange(new.size)
    new_tids = (rows // PAGE_CARD) << 16 | rows % PAGE_CARD
    blat = []
    t_all = time.perf_counter()
    for v, tid in zip(new.tolist(), new_tids.tolist()):
        t = time.perf_counter()
        tree.insert(v, tid)
        torch.cuda.synchronize()
        blat.append(time.perf_counter() - t)
    btree_insert_s = time.perf_counter() - t_all
    io1 = tree.io
    d_reads, d_writes, d_splits = (io1.node_reads - io0.node_reads,
                                   io1.node_writes - io0.node_writes,
                                   io1.node_splits - io0.node_splits)

    # 16 queries again, both structures against brute force: the five
    # windows above and more of their form (a half-day lower bound, as
    # selectivity_window gives)
    rng = np.random.default_rng(args.seed + 6)
    windows = [tpch.selectivity_window(sf) for sf in SELECTIVITIES]
    while len(windows) < AFTER_INSERT_QUERIES:
        lo = float(rng.integers(0, SHIPDATE_DAYS)) + 0.5
        windows.append((lo, lo + float(WIDTHS[len(windows) % 3])))
    hkeys = hidx.table.device_keys(device=dev)
    hvalid = hidx.table.device_valid(device=dev)
    new_dev = torch.from_numpy(new).to(dev)
    new_tids_dev = torch.from_numpy(new_tids).to(dev)

    def tree_brute(lo, hi):
        hit = (new_dev >= lo) & (new_dev <= hi)
        return torch.cat([tids_of(brute(keys, valid, lo, hi)),
                          new_tids_dev[hit]]).sort().values

    for wlo, whi in windows:
        pred = Predicate.between(wlo, whi)
        lo, hi = (x[0] for x in intervals([pred], dev))
        want_h = int(brute(hkeys, hvalid, lo, hi).sum())
        want_tids = tree_brute(lo, hi)
        got_h = int(hidx.search(pred).count)
        got_b = tree.count_range(wlo, whi)
        tids = tree.range_search(wlo, whi)
        if (got_h, got_b) != (want_h, want_tids.numel()) or not torch.equal(
                tids.sort().values, want_tids):
            fail(f"after inserts, window [{wlo}, {whi}]: hippo {got_h} vs "
                 f"{want_h}, B+-tree {got_b} ({tids.numel()} tids) vs "
                 f"{want_tids.numel()}")
    # The reference's range_search descends with side="right" on lo, so the
    # copies of a key lo that lie in leaves before the descent's leaf are
    # lost (reproduced for parity, ROADMAP.md queue 3). On windows whose
    # lower bound is a key, every row the tree misses must have key lo.
    lost = []
    for d in rng.integers(0, SHIPDATE_DAYS, FAULT_WINDOWS).tolist():
        wlo, whi = float(d), float(d) + 9.0
        pred = Predicate.between(wlo, whi)
        lo, hi = (x[0] for x in intervals([pred], dev))
        want_tids = tree_brute(lo, hi)
        tids = tree.range_search(wlo, whi).sort().values
        missing = want_tids[~torch.isin(want_tids, tids)]
        at_lo = tree_brute(lo, lo)
        if not bool(torch.isin(tids, want_tids).all()) or not bool(
                torch.isin(missing, at_lo).all()) or \
                int(hidx.search(pred).count) != int(
                    brute(hkeys, hvalid, lo, hi).sum()):
            fail(f"window [{wlo}, {whi}]: the B+-tree's answer is not brute "
                 f"force less copies of lo, or Hippo's count differs")
        lost.append({"window": [wlo, whi], "brute": want_tids.numel(),
                     "btree": tids.numel(), "copies_of_lo": at_lo.numel()})
    deleted = sum(tree.delete(float(v)) for v in new[::DELETE_EVERY])
    launches = K.launch_counts()
    print("baselines: " + json.dumps({
        "rows": card, "page_card": PAGE_CARD, "resolution": RESOLUTION,
        "density": DENSITY, "btree_fanout": tree.fanout,
        "btree_nodes_per_level": tree.num_nodes(),
        "btree_height": tree.height, "hippo_entries": hidx.num_entries,
        "init_s": init_s, "nbytes": nbytes,
        "bytes_per_tuple": {k: v / card for k, v in nbytes.items()},
        "btree_over_hippo": nbytes["btree"] / nbytes["hippo"],
        "btree_over_hippo_rle": nbytes["btree"] / nbytes["hippo_rle"],
        "device_bytes": device_bytes, "queries": queries,
        "inserts": {
            "rows": int(new.size),
            "hippo_eager_ms_median": 1e3 * float(np.median(lat)),
            "hippo_eager": len(lat), "hippo_batch_s": batch_s,
            "hippo_batch_rows_per_s": new.size / batch_s,
            "btree_us_median": 1e6 * float(np.median(blat)),
            "btree_us_mean": 1e6 * btree_insert_s / new.size,
            "btree_node_reads": d_reads, "btree_node_writes": d_writes,
            "btree_node_splits": d_splits,
            "btree_ios_per_insert": (d_reads + d_writes) / new.size,
            "model_hippo_ios_per_insert": cost.insert_time_ios(
                card, RESOLUTION, DENSITY),
            "model_btree_ios_per_insert": cost.btree_insert_time_ios(card)},
        "queries_after_inserts": len(windows),
        "btree_integer_lo_windows": lost,
        "deletes": int(new[::DELETE_EVERY].size), "deleted_true": deleted,
        "btree_device_bytes_after": tree.device_nbytes(),
        "launches": launches, "phase_s": time.perf_counter() - t_phase,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "phase_memory_above_start": torch.cuda.max_memory_allocated()
        - base_mem}))
    for name in ("bucketize", "bitmap_and", "page_inspect"):
        if launches[name] == 0:
            fail(f"kernel {name} was not launched in the baselines phase")
    print(f"baselines checked: {len(SELECTIVITIES)} windows x 6 structures "
          f"and {len(windows)} windows after the inserts equal brute force")
    del hidx, tree, minmax, table, keys, valid, hkeys, hvalid
    gc.collect()
    torch.cuda.empty_cache()


def kv_phase(torch, args, K) -> None:
    """Phase 2h: HippoKV on a decode cache at Llama-3-8B's KV widths."""
    import gc
    from repro_torch.core import kvindex as kv
    from repro_torch.device import resolve_device
    if torch.get_float32_matmul_precision() != "highest":
        fail("float32 matmul precision is not 'highest'")
    t_phase = time.perf_counter()
    b, s, h, hd = KV_SHAPE
    ps = kv.KVIndexConfig().page_size
    rng = np.random.default_rng(args.seed + 7)
    centers = rng.standard_normal((s // ps, 1, h, hd), dtype=np.float32)
    keys = np.repeat(centers, ps, axis=0).reshape(b, s, h, hd)
    keys = keys + np.float32(0.3) * rng.standard_normal((b, s, h, hd),
                                                        dtype=np.float32)
    values = rng.standard_normal((b, s, h, hd), dtype=np.float32)
    q = rng.standard_normal((b, h, hd), dtype=np.float32)
    dev = resolve_device(None)
    dk, dv, dq = (torch.from_numpy(x).to(dev) for x in (keys, values, q))
    cache_bytes = tensor_bytes(dk, dv)
    # exact softmax attention in float64, the check's yardstick
    scores = torch.einsum("bhd,bshd->bhs", dq.double(), dk.double())
    exact = torch.einsum("bhs,bshd->bhd",
                         torch.softmax(scores / math.sqrt(hd), dim=-1),
                         dv.double())
    runs = []
    for cfg in KV_CONFIGS:
        cfg = kv.KVIndexConfig(**cfg)
        kv.build_kv_index(cfg, dk)              # warm-up
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t = time.perf_counter()
        idx = kv.build_kv_index(cfg, dk)
        torch.cuda.synchronize()
        build_ms = 1e3 * (time.perf_counter() - t)
        launches = K.launch_counts()["bucketize"]
        if launches != cfg.num_channels:
            fail(f"kvindex build launched the bucket probe {launches} times, "
                 f"not once per channel ({cfg.num_channels})")
        row = {"config": dataclasses.asdict(cfg), "build_ms": build_ms,
               "bucketize_launches": launches, "index_bytes": idx.nbytes(),
               "index_over_cache": idx.nbytes() / cache_bytes}
        for mc in (1, 4):
            row[f"mask_ms_min{mc}"], mask = median_ms(
                torch, lambda mc=mc: kv.query_page_mask(idx, dq, mc))
            row[f"pruned_share_min{mc}"] = 1.0 - float(mask.float().mean())
            ms, (out, mass) = median_ms(torch, lambda m=mask: kv.
                                        hippo_kv_attention(dq, dk, dv, m, ps))
            row[f"attention_ms_min{mc}"] = ms
            row[f"kept_mass_min{mc}"] = {"mean": float(mass.mean()),
                                         "min": float(mass.min())}
            row[f"rel_err_min{mc}"] = float(
                (out.double() - exact).norm() / exact.norm())
        all_pages = torch.ones_like(mask)
        ms, (out, mass) = median_ms(torch, lambda: kv.hippo_kv_attention(
            dq, dk, dv, all_pages, ps))
        err = float((out.double() - exact).abs().max())
        if err > KV_ATOL or float((mass - 1).abs().max()) > KV_ATOL:
            fail(f"full-keep attention differs from exact attention by "
                 f"{err} (kept mass {float(mass.min())})")
        row["attention_ms_all_pages"] = ms
        row["full_keep_max_abs_err"] = err
        runs.append(row)
    print("kv: " + json.dumps({
        "shape": {"batch": b, "positions": s, "heads": h, "head_dim": hd},
        "cache_bytes": cache_bytes, "runs": runs,
        "phase_s": time.perf_counter() - t_phase,
        "max_memory_allocated": torch.cuda.max_memory_allocated()}))
    print(f"kv checked: full-keep attention equals exact attention "
          f"(atol {KV_ATOL}) for {len(runs)} configurations")
    del dk, dv, dq, exact, scores
    gc.collect()
    torch.cuda.empty_cache()


def decode_check(torch, ms, mt, cfg, positions: int, seed: int) -> float:
    """Prefill of ``positions``-3 tokens, then 3 decode steps, against the
    teacher-forced forward over all of them (the logits of the positions
    checked only), float32 with TF32 off; returns the max abs error."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = mt.init_params(cfg, gen, dev)
    b, s = CHECK_BATCH, positions
    if cfg.frontend == "tokens":
        inputs = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                               device=dev)
    else:
        inputs = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    want = mt.trunk(model, inputs, pos)[:, s - 4:] @ mt.lm_head(model)
    logits, cache = ms.prefill(model, inputs[:, :s - 3], pos[:, :s - 3], s + 4)
    got = [logits]
    for t in range(s - 3, s):
        logits, cache = ms.decode_step(model, cache, inputs[:, t:t + 1], t)
        got.append(logits)
    got = torch.stack(got, dim=1)
    if not torch.isfinite(got).all():
        fail(f"{cfg.name}: non-finite logits")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=CHECK_TOL, atol=CHECK_TOL):
        fail(f"{cfg.name}: decode differs from the forward by {err} "
             f"(atol = rtol = {CHECK_TOL})")
    return err


def serving_phase(torch, args, K) -> None:
    """Phase 2i: ``smollm-360m`` at its published widths and full depth in
    bfloat16 through the port's ``BatchServer``, then the decode-against-
    forward check in float32 for it and one pattern unit of every other
    block family at its published widths."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchServer, Request
    from repro_torch.models import serve as ms
    from repro_torch.models import transformer as mt
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        fail("TF32 is on for float32 matmuls")
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = get_config(SERVE_ARCH)
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = mt.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(args.seed)
    queue = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, SERVE_PROMPT).astype(np.int32))
        for i in range(SERVE_REQUESTS)]
    server = BatchServer(model, SERVE_BATCH,
                         max_seq=SERVE_PROMPT + SERVE_GEN + 1)
    prefill_ms, step_ms, finished = [], [], []
    t0 = time.perf_counter()
    while len(finished) < SERVE_REQUESTS:
        while queue:
            t = time.perf_counter()
            if not server.admit(queue[0]):
                break
            prefill_ms.append(1e3 * (time.perf_counter() - t))
            queue.pop(0)
        t = time.perf_counter()
        server.step()
        step_ms.append(1e3 * (time.perf_counter() - t))
        finished.extend(server.retire(SERVE_GEN))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = [tok for r in finished for tok in r.generated]
    if (len(finished) != SERVE_REQUESTS
            or any(len(r.generated) != SERVE_GEN for r in finished)
            or not all(0 <= tok < cfg.vocab_size for tok in tokens)):
        fail("serving: a request's tokens are missing or out of [0, V)")
    launches = K.launch_counts()
    print("serve: " + json.dumps({
        "arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "params": n_params, "init_s": init_s,
        "requests": SERVE_REQUESTS, "batch": SERVE_BATCH,
        "prompt": SERVE_PROMPT, "generated": SERVE_GEN,
        "tokens": len(tokens), "wall_s": wall, "tokens_per_s":
        len(tokens) / wall, "prefill_ms_median": float(np.median(prefill_ms)),
        "decode_step_ms_median": float(np.median(step_ms)),
        "decode_steps": len(step_ms), "hippo_kernel_launches": launches,
        "resident_before": resident,
        "max_memory_allocated": torch.cuda.max_memory_allocated()}))
    del model, server
    gc.collect()
    torch.cuda.empty_cache()

    errs = {}
    checks = [(dataclasses.replace(cfg, dtype="float32"), CHECK_POSITIONS)]
    for arch, positions in FAMILY_CHECKS:
        c = get_config(arch)
        c = dataclasses.replace(c, num_layers=c.unit_len, dtype="float32")
        if c.num_experts:
            c = dataclasses.replace(c, capacity_factor=8.0)
        checks.append((c, positions))
    for c, positions in checks:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        err = decode_check(torch, ms, mt, c, positions, args.seed)
        torch.cuda.synchronize()
        errs[c.name] = {"layers": c.num_layers, "positions": positions,
                        "max_abs_err": err, "s": time.perf_counter() - t0,
                        "max_memory_allocated":
                        torch.cuda.max_memory_allocated()}
        gc.collect()
        torch.cuda.empty_cache()
    print("serve check: " + json.dumps({
        "batch": CHECK_BATCH, "tol": CHECK_TOL, "archs": errs,
        "phase_s": time.perf_counter() - t_phase}))
    print(f"serve checked: decode equals the forward (atol = rtol = "
          f"{CHECK_TOL}, float32) for {len(errs)} families at published "
          f"widths")


def placement_phase(torch, K, hix, intervals, sidx, preds) -> None:
    """Phase 2j: the sharded index placed on ``make_shard_mesh(4)`` (one
    card: plain tensors) and on a 4-entry mesh of the card (each shard block
    searched where it lives, summed on the first); then ``reshard_for_mesh``
    of a seeded tree onto meshes of 8 and 2 entries."""
    from repro_torch.launch.mesh import make_mesh_compat, make_shard_mesh
    from repro_torch.launch.shardings import P, PlacedTensor, place_sharded
    from repro_torch.runtime.elastic import reshard_for_mesh
    t_phase = time.perf_counter()
    dev = sidx.device
    keys, valid = sidx._slabs()
    batches = [preds[i:i + BATCH] for i in range(0, len(preds), BATCH)]
    args = [sidx._query_bitmaps(b) for b in batches]
    cap = sidx.gather_cap

    def run(st, k, v, a):
        qb, lo, hi = a
        dense = hix.search_many_sharded(st.shards, qb, k, v, lo, hi)
        compact = hix.search_compact_many_sharded(
            st.shards, qb, k, v, lo, hi, max_selected=cap, top_k=TOP_K)
        return [*dense, *compact]

    want = [run(sidx.state, keys, valid, a) for a in args]
    table = sidx.table
    keys_all = table.device_keys(device=dev).reshape(-1)
    valid_all = table.device_valid(device=dev).reshape(-1)
    counts = torch.cat([w[0] for w in want]).cpu().numpy()
    row_ids = torch.cat([w[-1] for w in want]).cpu().numpy()
    los, his = intervals(preds, dev)
    for q, p in enumerate(preds):
        hit = valid_all & (keys_all >= los[q]) & (keys_all <= his[q])
        ids = torch.nonzero(hit)[:TOP_K, 0].cpu().numpy()
        if int(hit.sum()) != counts[q] or not np.array_equal(
                row_ids[q][row_ids[q] >= 0], ids):
            fail(f"placement: the unplaced search of query {q} {p} differs "
                 f"from brute force")
    meshes = {"shard_mesh": make_shard_mesh(NUM_SHARDS),
              "four_entries": make_mesh_compat((NUM_SHARDS,), ("data",),
                                               [dev] * NUM_SHARDS)}
    out = {"queries": len(preds), "meshes": {},
           "unplaced_ms": time_ms(torch, lambda: run(sidx.state, keys, valid,
                                                     args[0]), 8)}
    for name, mesh in meshes.items():
        K.reset_launch_counts()
        st, k, v = place_sharded(mesh, sidx.state, keys, valid)
        got = [run(st, k, v, a) for a in args]
        torch.cuda.synchronize()
        launches = K.launch_counts()
        for b, (g, w) in enumerate(zip(got, want)):
            for gi, wi in zip(g, w):
                if not torch.equal(gi, wi):
                    fail(f"placement on {name}: batch {b} differs from the "
                         f"unplaced search")
        for kname in ("batch_filter", "compact_inspect", "page_inspect_many"):
            if launches[kname] == 0:
                fail(f"placement on {name}: kernel {kname} was not launched")
        out["meshes"][name] = {
            "entries": mesh.size, "placed": isinstance(k, PlacedTensor),
            "blocks": k.num_blocks if isinstance(k, PlacedTensor) else 1,
            "ms": time_ms(torch, lambda: run(st, k, v, args[0]), 8),
            "launches": launches}
    rng = np.random.default_rng(7)
    tree = {"w": rng.integers(0, 1000, (4096, 4096)).astype(np.float32),
            "b": rng.integers(0, 1000, 4096).astype(np.float32)}
    specs = {"w": P("data", "model"), "b": P("model")}
    out["reshard"] = {}
    for shape, blocks in (((4, 2), {"w": 8, "b": 2}),
                          ((2, 1), {"w": 2, "b": 1})):
        mesh = make_mesh_compat(shape, ("data", "model"),
                                [dev] * int(np.prod(shape)))
        placed = reshard_for_mesh(tree, specs, mesh)
        for name, arr in placed.items():
            total = sum(float(arr.block(pos).double().sum())
                        for _, pos in arr.distinct_blocks())
            if total != float(tree[name].astype(np.float64).sum()):
                fail(f"reshard onto {shape}: {name}'s blocks sum to {total}")
            if arr.num_blocks != blocks[name]:
                fail(f"reshard onto {shape}: {name} has {arr.num_blocks} "
                     f"blocks, not {blocks[name]}")
        out["reshard"][str(shape)] = {n: a.num_blocks
                                      for n, a in placed.items()}
    out["phase_s"] = time.perf_counter() - t_phase
    print("placement: " + json.dumps(out))
    print(f"placement checked: {len(preds)} queries on 1- and "
          f"{NUM_SHARDS}-entry meshes equal the unplaced search and brute "
          f"force")


def step_bound_ms(cfg, n_params: int, batch: int, seq: int) -> dict:
    """The least time of one train step on the card, the larger of two
    sums: operations (6 N T dense bfloat16 at the tensor cores' peak, plus
    the attention products, which run in float32 outside them: the scores
    and the PV product, forward and twice in the backward pass, over all
    S^2 positions as the blocked attention computes them) and bytes (the
    parameters read and written, the gradients written and the float32
    moments read and written once). Remat's recomputation is not in it."""
    tokens = batch * seq
    dense = 6 * n_params * tokens
    hd = cfg.resolved_head_dim
    attn = 3 * 4 * batch * seq * seq * cfg.num_heads * hd * cfg.num_layers
    from repro_torch.roofline import H100_SXM
    ops_ms = (dense / BF16_OPS_PER_S + attn / H100_SXM.vector_ops) * 1e3
    nbytes = n_params * (2 + 2 + 2 + 2 * 2 * 4)
    bytes_ms = nbytes / H100_SXM.mem_bw * 1e3
    return {"ms": max(ops_ms, bytes_ms),
            "by": "operations" if ops_ms >= bytes_ms else "bytes",
            "operations_ms": ops_ms, "bytes_ms": bytes_ms,
            "dense_flop": dense, "attention_flop": attn, "bytes": nbytes}


def state_equal(torch, a: dict, b: dict) -> bool:
    """Two train states' parameters and moments equal bit for bit."""
    pa = dict(a["params"].named_parameters())
    pb = dict(b["params"].named_parameters())
    if pa.keys() != pb.keys() or not torch.equal(a["opt"].step,
                                                 b["opt"].step):
        return False
    for n in pa:
        if not torch.equal(pa[n], pb[n]):
            return False
        for ma, mb in ((a["opt"].mu[n], b["opt"].mu[n]),
                       (a["opt"].nu[n], b["opt"].nu[n])):
            if not torch.equal(ma, mb):
                return False
    return True


def card_against_cpu(torch, ts, tt, adamw_init, cfg, seed: int) -> dict:
    """Two train steps of ``cfg`` (float32, TF32 off) on the same batch on
    the card and on the CPU, from the same weights; returns each step's
    loss and grad norm on both and their largest relative difference."""
    batch = {k: torch.from_numpy(v) for k, v in
             train_batch(cfg, 4, 16, seed).items()}
    out = {}
    for where in ("cpu", "cuda"):
        dev = torch.device(where)
        model = tt.init_params(cfg, torch.Generator().manual_seed(seed),
                               "cpu").to(dev)
        opt = adamw_init(model)
        step = ts.make_train_step(cfg, peak_lr=TRAIN_LR, warmup=0, total=10)
        runs = []
        for _ in range(2):
            model, opt, m = step(model, opt,
                                 {k: v.to(dev) for k, v in batch.items()})
            runs.append((float(m["loss"]), float(m["grad_norm"])))
        out[where] = runs
    rel = max(abs(a - b) / abs(b) for ca, cb in zip(out["cuda"], out["cpu"])
              for a, b in zip(ca, cb))
    if not rel <= CARD_CPU_TOL:
        fail(f"train steps of {cfg.name}: card {out['cuda']} against CPU "
             f"{out['cpu']} ({rel} relative, {CARD_CPU_TOL} allowed)")
    return {"card": out["cuda"], "cpu": out["cpu"], "max_rel": rel}


def train_batch(cfg, b: int, s: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"inputs": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int64),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int64),
            "positions": np.broadcast_to(np.arange(s)[None], (b, s)).copy()}


def training_phase(torch, args, K, Predicate) -> None:
    """Phase 2k: the training path. The Hippo-indexed corpus selects its
    sequences on the card (kernels C, F and E), exact against brute force;
    ``smollm-360m`` at full width and depth in bfloat16 with float32
    moments and remat takes 3 + 30 steps of batch 8 x 512 tokens, then a
    checkpoint of the whole state round-trips bit for bit and steps from
    the restored state (at accum 1 and 2) match the uninterrupted run's;
    then four block families' reduced configs take two steps on the card
    and on the CPU."""
    import gc
    import shutil
    import tempfile
    from repro_torch.checkpointing import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import HippoDataPipeline, synthesize_corpus
    from repro_torch.launch import steps as ts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tt
    from repro_torch.optim import adamw_init
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        fail("TF32 is on for float32 matmuls")
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    out = {"arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ_LEN - 1}

    # the corpus and its Hippo selection on the card
    t0 = time.perf_counter()
    corpus = synthesize_corpus(num_seqs=TRAIN_SEQS, seq_len=TRAIN_SEQ_LEN,
                               vocab_size=cfg.vocab_size,
                               page_card=TRAIN_PAGE_CARD, seed=args.seed)
    out["corpus_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipe = HippoDataPipeline.create(corpus, Predicate.between(*TRAIN_QUALITY),
                                    seed=args.seed, device=dev)
    torch.cuda.synchronize()
    create_ms = 1e3 * (time.perf_counter() - t0)
    sel_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        pipe.refresh_selection()
        sel_ms.append(1e3 * (time.perf_counter() - t0))
    q = corpus.quality
    brute = np.flatnonzero((q >= TRAIN_QUALITY[0]) & (q <= TRAIN_QUALITY[1]))
    if not np.array_equal(pipe.selected_ids, brute):
        fail("training data: the Hippo selection differs from brute force")
    pages = corpus.table.num_pages
    if not pipe.pages_inspected < pages:
        fail(f"training data: the index inspected all {pages} pages")
    select_ms = float(np.median(sel_ms))
    out["data"] = {"seqs": corpus.num_seqs, "pages": pages,
                   "token_bytes": corpus.tokens.nbytes,
                   "selected": int(pipe.selected_ids.size),
                   "pages_inspected": pipe.pages_inspected,
                   "build_ms": create_ms - sel_ms[0],
                   "select_ms": select_ms, "select_ms_runs": sel_ms}
    print(f"train data: {pipe.selected_ids.size:,}/{corpus.num_seqs:,} "
          f"sequences selected, exact against brute force (inspected "
          f"{pipe.pages_inspected}/{pages} pages via the Hippo index)")

    # smollm-360m at full width and depth
    mesh = make_host_mesh(data=1, model=1, devices=[dev])
    t0 = time.perf_counter()
    model = tt.init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), dev)
    state = {"params": model, "opt": adamw_init(model)}
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    total = TRAIN_WARMUP + TRAIN_STEPS
    kw = dict(peak_lr=TRAIN_LR, warmup=max(2, total // 10), total=total,
              remat=True)
    step_fn = ts.make_train_step(cfg, accum=1, **kw)

    def batch_of(step):
        return {k: torch.from_numpy(v).to(dev) for k, v in
                pipe.get_batch(step, TRAIN_BATCH).items()}

    def run(st, step, fn=step_fn):
        batch = batch_of(step)
        with mesh:
            m, o, met = fn(st["params"], st["opt"], batch)
        return {"params": m, "opt": o}, float(met["loss"]), float(
            met["grad_norm"])

    losses, gnorms, step_ms = [], [], []
    for step in range(total):
        t0 = time.perf_counter()
        state, loss, gn = run(state, step)
        torch.cuda.synchronize()
        if step >= TRAIN_WARMUP:
            step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
        gnorms.append(gn)
    if not all(math.isfinite(v) for v in losses + gnorms):
        fail(f"training: a loss or grad norm is not finite: {losses}")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        fail(f"training: the loss did not fall: {losses}")
    tokens = TRAIN_BATCH * (TRAIN_SEQ_LEN - 1)
    peak = torch.cuda.max_memory_allocated()
    bound = step_bound_ms(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ_LEN - 1)
    med = float(np.median(step_ms))
    out.update({
        "params": n_params, "steps": total, "timed_steps": TRAIN_STEPS,
        "tokens_per_step": tokens, "step_ms_median": med,
        "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
        "tokens_per_s": tokens / (med / 1e3),
        "tokens_per_s_timed": tokens * TRAIN_STEPS / (sum(step_ms) / 1e3),
        "loss_first": losses[0], "loss_last": losses[-1],
        "loss_first5_mean": float(np.mean(losses[:5])),
        "loss_last5_mean": float(np.mean(losses[-5:])), "losses": losses,
        "grad_norm_first": gnorms[0], "grad_norm_last": gnorms[-1],
        "bound": bound, "x_bound": med / bound["ms"],
        "resident_before": resident, "max_memory_allocated": peak,
        "phase_memory": peak - resident})

    # a checkpoint of the whole state, restored; steps from it
    root = Path(tempfile.mkdtemp(prefix="hippo-train-"))
    try:
        fs = subprocess.run(["stat", "-f", "-c", "%T", str(root)],
                            capture_output=True, text=True, timeout=60)
        mgr = CheckpointManager(root, keep=1)
        t0 = time.perf_counter()
        mgr.save(total, state)
        host_s = time.perf_counter() - t0
        mgr.wait()
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in root.rglob("*.npy"))
        t0 = time.perf_counter()
        step0, restored = mgr.restore_latest(state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if step0 != total or not state_equal(torch, state, restored):
            fail("checkpoint: the restored state differs from the saved one")
        nxt, next_losses = state, []
        for step in (total, total + 1):
            nxt, loss, _ = run(nxt, step)
            next_losses.append(loss)
        res_losses = []
        for step in (total, total + 1):
            restored, loss, _ = run(restored, step)
            res_losses.append(loss)
        rel = max(abs(a - b) / abs(b) for a, b in zip(res_losses,
                                                      next_losses))
        if not rel <= RESUME_TOL:
            fail(f"checkpoint: steps from the restored state lost "
                 f"{res_losses} against {next_losses}")
        _, again = mgr.restore_latest(nxt)
        del restored, nxt, state, model
        gc.collect()
    finally:
        shutil.rmtree(root)
    accum_fn = ts.make_train_step(cfg, accum=2, **kw)
    _, accum_loss, _ = run(again, total, accum_fn)
    accum_rel = abs(accum_loss - next_losses[0]) / abs(next_losses[0])
    if not accum_rel <= ACCUM_TOL:
        fail(f"accum=2 gives loss {accum_loss} against accum=1's "
             f"{next_losses[0]}")
    out["checkpoint"] = {
        "filesystem": fs.stdout.strip(), "bytes": nbytes,
        "host_copy_s": host_s, "save_s": save_s, "restore_s": restore_s,
        "next_losses": next_losses, "restored_losses": res_losses,
        "max_rel": rel}
    out["accum2"] = {"loss": accum_loss, "accum1_loss": next_losses[0],
                     "rel": accum_rel}
    del again, pipe, corpus
    gc.collect()
    torch.cuda.empty_cache()
    launches = K.launch_counts()
    out["hippo_kernel_launches"] = launches
    for name in ("bucketize", "bitmap_and", "page_inspect"):
        if launches[name] == 0:
            fail(f"kernel {name} was not launched in the training phase")

    # the card against the CPU, one config of each block family
    out["card_vs_cpu"] = {}
    for arch in CARD_CPU_ARCHS:
        c = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        if c.num_experts:      # no capacity drops: a near tie may route
            c = dataclasses.replace(c, capacity_factor=8.0)  # either way
        out["card_vs_cpu"][arch] = card_against_cpu(torch, ts, tt, adamw_init,
                                                    c, args.seed)
    out["phase_s"] = time.perf_counter() - t_phase
    print("train: " + json.dumps(out))
    print(f"train checked: {TRAIN_STEPS} timed steps of {cfg.name} "
          f"({n_params:,} parameters, {cfg.num_layers} layers) with finite, "
          f"falling loss; the checkpoint round-trips bit for bit; "
          f"{len(CARD_CPU_ARCHS)} families' steps equal the CPU's within "
          f"{CARD_CPU_TOL}")


def dryrun_phase(torch, K) -> None:
    """Phase 2l: the dry run at published widths. ``launch.dryrun.main``
    prices all 64 (arch x shape x mesh) cells against the card's memory
    (it runs no kernel: the counters are read to show it); every record
    must carry the reference's keys. Then the blocks that mesh position
    (0, 0) holds of the largest cell's arguments (every parameter, the
    optimizer state and the batch of llama4-maverick-400b-a17b ``train_4k``
    single-pod) are allocated on the card: the bytes asked of the
    allocator (its ``requested_bytes``) must equal the record's, and its
    rise of ``memory_allocated()`` exceed them by no more than its
    rounding (512 B a block, and up to 1 MiB of a large block that it
    does not split)."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config, shape_cells
    from repro_torch.launch import dryrun
    t_phase = time.perf_counter()
    hbm = torch.cuda.get_device_properties(0).total_memory
    out_dir = Path(tempfile.mkdtemp(prefix="dryrun-"))
    K.reset_launch_counts()
    try:
        try:
            dryrun.main(["--mesh", "both", "--out", str(out_dir)])
        except SystemExit as e:
            fail(f"the dry run exited with {e.code}")
        records = {p.stem: json.loads(p.read_text())
                   for p in sorted(out_dir.glob("*.json"))}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    launches = K.launch_counts()
    priced_s = time.perf_counter() - t_phase
    if len(records) != DRYRUN_CELLS:
        fail(f"the dry run wrote {len(records)} records, not {DRYRUN_CELLS}")
    for tag, rec in records.items():
        for dotted in DRYRUN_KEYS:
            head, _, tail = dotted.partition(".")
            if head not in rec or (tail and tail not in rec[head]):
                fail(f"dry-run record {tag} lacks {dotted}")
        if rec["hbm_bytes"] != hbm:
            fail(f"dry-run record {tag}: hbm_bytes {rec['hbm_bytes']} is "
                 f"not the card's {hbm}")

    arch, shape_name, multi = DRYRUN_HELD
    held = records[f"{arch}_{shape_name}_{'multi' if multi else 'single'}"]
    want = held["memory"]["argument_bytes_per_device"]
    cfg = get_config(arch)
    shape = next(s for s in shape_cells(cfg) if s.name == shape_name)
    _, blocks, _ = dryrun.cell_blocks(cfg, shape, multi)
    torch.cuda.synchronize()
    base = (torch.cuda.memory_stats()["requested_bytes.all.current"],
            torch.cuda.memory_allocated())
    tensors = [torch.empty(s, dtype=d, device="cuda") for s, d in blocks]
    requested = (torch.cuda.memory_stats()["requested_bytes.all.current"]
                 - base[0])
    rise = torch.cuda.memory_allocated() - base[1]
    del tensors
    torch.cuda.empty_cache()
    slack = ALLOC_SLACK * len(blocks)
    if requested != want or not 0 <= rise - want <= slack:
        fail(f"{arch} {shape_name}: the card's allocator was asked for "
             f"{requested} B and rose by {rise} B for the record's {want} B "
             f"({len(blocks)} tensors)")
    gib = {tag: rec["memory"]["argument_bytes_per_device"] / 2**30
           for tag, rec in records.items()}
    print("dryrun: " + json.dumps({
        "cells": len(records), "hbm_bytes": hbm, "priced_s": priced_s,
        "args_gib_per_device": gib,
        "largest": max(gib, key=gib.get),
        "arguments_fit_hbm": sum(r["arguments_fit_hbm"]
                                 for r in records.values()),
        "held": {"cell": list(DRYRUN_HELD), "record_bytes": want,
                 "requested_bytes": requested, "allocated_bytes": rise,
                 "tensors": len(blocks), "slack_bytes": slack},
        "hippo_kernel_launches": launches,
        "phase_s": time.perf_counter() - t_phase}))
    print(f"dryrun checked: {len(records)} cells priced with every key of "
          f"the reference's record; {arch} {shape_name} single-pod's "
          f"{len(blocks)} blocks asked the card for the record's {want:,} B "
          f"exactly and took {rise:,} B")


def run_example(torch, module, argv: list) -> tuple[str, float]:
    """``module.main(argv)`` in a fresh temporary working directory, its
    standard output captured; returns the output and the wall seconds (to
    a synchronize)."""
    import contextlib
    import io
    import os
    import tempfile
    cwd = os.getcwd()
    buf = io.StringIO()
    with tempfile.TemporaryDirectory(prefix="example-") as d:
        os.chdir(d)
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                module.main([a.replace("{dir}", d) for a in argv])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
    return buf.getvalue(), wall


def masked_lines(text: str) -> list:
    import re
    return [re.sub(TIMING_FIELD, "#", line) for line in text.splitlines()]


def examples_phase(torch, args, K, intervals, Predicate,
                   values: np.ndarray) -> None:
    """Phase 2m: the six examples of ``repro_torch.examples`` through their
    argv parsers on the card, at the reference examples' sizes, each in a
    fresh temporary directory with its counters set to 0 before and read
    after. The four Hippo examples also run with ``--device cpu``: every
    line equal once the timing fields are masked, and the first three's
    equal to the numbers the reference examples print. ``serve_decode``
    keeps its asserts; ``train_lm`` takes its 300 steps, and its first
    three losses equal, within 1e-4 relative (TF32 off), those of the train
    CLI on the CPU from the same weights (drawn on the card) with the
    example's argv and ``--stop-after 3``. Then ``engine_serving.run`` on
    phase 2's ``l_shipdate`` sorted (SF10, 50 tuples a page): 200
    predicates (1-, 10- and 100-day ranges, a quarter on the last 55 days
    and the appended ones), 64 rows of days past the last and a delete of
    1% of the domain; its asserts hold every path against the per-query
    loop and the synchronous twin, and every count is held here against
    brute force on the card."""
    import contextlib
    import io
    import tempfile
    from repro_torch.examples import (engine_serving, hippo_data_pipeline,
                                      hippokv_longcontext, quickstart,
                                      serve_decode, train_lm)
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import adamw_init
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        fail("TF32 is on for float32 matmuls")
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    modules = {"quickstart": quickstart, "engine_serving": engine_serving,
               "hippo_data_pipeline": hippo_data_pipeline,
               "hippokv_longcontext": hippokv_longcontext,
               "serve_decode": serve_decode, "train_lm": train_lm}
    out = {"examples": {}}
    total = dict.fromkeys(K.launch_counts(), 0)

    def on_card(name: str, argv: list) -> str:
        torch.cuda.synchronize()
        K.reset_launch_counts()
        text, wall = run_example(torch, modules[name], argv)
        launches = K.launch_counts()
        for k, n in launches.items():
            total[k] += n
        out["examples"][name] = {"wall_s": wall, "launches": launches}
        return text

    # the four Hippo examples: the card's lines are the CPU's
    for name in HIPPO_EXAMPLES:
        cpu_text, cpu_wall = run_example(torch, modules[name],
                                         ["--device", "cpu"])
        card_text = on_card(name, [])
        got, want = masked_lines(card_text), masked_lines(cpu_text)
        if got != want:
            diff = [(a, b) for a, b in zip(got, want) if a != b]
            fail(f"example {name}: the card's lines differ from the CPU's "
                 f"({len(got)} against {len(want)} lines; first "
                 f"differences {diff[:3]})")
        for line in EXAMPLE_LINES.get(name, ()):
            if line not in card_text:
                fail(f"example {name}: the reference's {line!r} is not "
                     f"printed")
        out["examples"][name].update(cpu_wall_s=cpu_wall, lines=got)

    text = on_card("serve_decode", [])
    served = [ln for ln in text.splitlines() if ln.startswith("served ")]
    if not text.rstrip().endswith("OK: all requests served") or not served:
        fail(f"example serve_decode: {text[-300:]!r}")
    out["examples"]["serve_decode"]["served"] = served[0]

    # train_lm: its losses are what the CLI returns
    losses = []
    cli_main = train_cli.main

    def spy(argv=None):
        losses.append(cli_main(argv))
        return losses[-1]

    train_cli.main = spy
    try:
        text = on_card("train_lm", ["--ckpt-dir", "{dir}/ckpt"])
    finally:
        train_cli.main = cli_main
    card = losses[0]
    if not text.rstrip().endswith(f"over {len(card)} steps") \
            or not all(math.isfinite(x) for x in card):
        fail(f"example train_lm: {text[-300:]!r}")

    build_state = train_cli.build_state

    def card_drawn(cfg, seed, device):
        """The card's initial weights, on ``device``."""
        model = build_state(cfg, seed, dev)["params"].to(device)
        return {"params": model, "opt": adamw_init(model)}

    train_cli.build_state = card_drawn
    try:
        with tempfile.TemporaryDirectory(prefix="example-") as d, \
                contextlib.redirect_stdout(io.StringIO()):
            cpu = cli_main(train_lm.train_argv(len(card), "smollm-360m", d)
                           + ["--device", "cpu", "--stop-after",
                              str(TRAIN_LOSS_CHECKS)])
    finally:
        train_cli.build_state = build_state
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    if len(cpu) != TRAIN_LOSS_CHECKS or not rel <= CARD_CPU_TOL:
        fail(f"example train_lm: the card's first losses "
             f"{card[:TRAIN_LOSS_CHECKS]} against the CPU's {cpu} "
             f"({rel} relative, {CARD_CPU_TOL} allowed)")
    out["examples"]["train_lm"].update(
        steps=len(card), first_loss=card[0], last_loss=card[-1],
        cpu_first_losses=cpu, card_first_losses=card[:TRAIN_LOSS_CHECKS],
        max_rel=rel)

    # ... at SF10 on the clustered column
    t0 = time.perf_counter()
    col = torch.sort(torch.from_numpy(values).to(dev)).values
    host = col.cpu().numpy()
    rng = np.random.default_rng(args.seed + 8)
    preds = writer_preds(Predicate, rng, CLUSTERED_PREDS)
    new_rows = rng.integers(SHIPDATE_DAYS, SHIPDATE_DAYS + NEW_DAYS,
                            CLUSTERED_WRITES).astype(np.float32)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    K.reset_launch_counts()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    print(f"engine_serving on the sorted l_shipdate ({len(host):,} rows, "
          f"{PAGE_CARD} a page):")
    t0 = time.perf_counter()
    res = engine_serving.run(host, preds, new_rows, CLUSTERED_DELETE,
                             page_card=PAGE_CARD, device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = K.launch_counts()
    los, his = intervals(preds, dev)

    def scan(v):
        return np.asarray([int(((v >= los[q]) & (v <= his[q])).sum())
                           for q in range(len(preds))], np.int64)

    base, staged = scan(col), scan(torch.from_numpy(new_rows).to(dev))
    lo, hi = CLUSTERED_DELETE
    want = {"counts": base, "async_counts": base + staged,
            "after_counts": scan(col[(col < lo) | (col > hi)]) + staged}
    for key, w in want.items():
        if not np.array_equal(np.asarray(res[key], np.int64), w):
            fail(f"engine_serving at SF10: {key} differ from brute force "
                 f"in {int((np.asarray(res[key]) != w).sum())} of "
                 f"{len(preds)} queries")
    deleted = int(((col >= lo) & (col <= hi)).sum())
    del col
    sf10 = {k: v for k, v in res.items() if k not in want}
    sf10.update(preds=len(preds), writes=CLUSTERED_WRITES,
                delete=list(CLUSTERED_DELETE), deleted_rows=deleted,
                setup_s=setup_s, run_s=run_s, launches=launches,
                resident_before=resident, max_memory_allocated=peak,
                peak_above_resident=peak - resident)
    out["sf10_clustered"] = sf10
    for what, counts in (("the examples", total), ("the SF10 run", launches)):
        for name, n in counts.items():
            if n == 0:
                fail(f"kernel {name} was not launched by {what}")
    out["phase_s"] = time.perf_counter() - t_phase
    print("examples: " + json.dumps(out))
    print(f"examples checked: six examples ran on the card with their "
          f"asserts; the four Hippo examples' lines equal the CPU's; "
          f"train_lm's first {TRAIN_LOSS_CHECKS} losses equal the CPU's "
          f"within {CARD_CPU_TOL}; engine_serving at SF10 on a clustered "
          f"column equals brute force in {3 * len(preds)} counts")


def roofline_phase(torch, kernels: list, models: dict,
                   once_bytes: dict) -> None:
    """Phase 4: phase 3's kernel times restated with the reference's cost
    models (``repro_torch.roofline``) at phase 3's shapes, against the
    card's measured copy rate (``cuda_stream``) and the H100 SXM's
    published peaks (``h100_sxm``); and per kernel the ratio of the model's
    bytes to the bytes phase 3's bound counts once."""
    from repro_torch.roofline import hardware, report, roofline
    cuda = hardware("cuda_stream")
    if not (math.isfinite(cuda.mem_bw) and cuda.mem_bw > 0):
        fail(f"cuda_stream measured {cuda.mem_bw} B/s")
    rows = [r for r in kernels if r["name"] in models]
    doc = {"suites": {"kernels": [
        {"name": r["name"], "us_per_call": r["ms"] * 1e3,
         "derived": {"bytes": models[r["name"]].bytes_moved,
                     "ops": models[r["name"]].ops}} for r in rows]}}
    print(f"roofline: cuda_stream {cuda.mem_bw:.6g} B/s ({cuda.note})")
    for r in kernels:
        if r["name"] not in models:
            print(f"roofline: {r['name']} has no cost model in the "
                  f"reference; its row is left out")
    tables = {name: report.build_table(doc, name)
              for name in ("cuda_stream", "h100_sxm")}
    for table in tables.values():
        print(table)
        if len(table.splitlines()) != 2 + len(rows):
            fail("the roofline table lacks a kernel row")
    out = {"cuda_stream_bytes_per_s": cuda.mem_bw, "kernels": {}}
    for r in rows:
        cost = models[r["name"]]
        out["kernels"][r["name"]] = {
            "model_bytes": cost.bytes_moved, "model_ops": cost.ops,
            "once_bytes": once_bytes[r["name"]],
            "model_over_once": cost.bytes_moved / once_bytes[r["name"]],
            **{f"roofline_frac_{hw}": roofline(cost, r["ms"] / 1e3, hardware(
                hw))["roofline_frac"] for hw in ("cuda_stream", "h100_sxm")}}
    print("roofline: " + json.dumps(out))


def at_offset(torch, t, off: int):
    """A copy of ``t`` on the card, ``off`` elements past a 16 B aligned
    base (a slice of a larger tensor, as a shard's view is)."""
    big = torch.zeros(t.numel() + off, dtype=t.dtype, device=t.device)
    view = big[off:]
    view.copy_(t)
    return view


def stream_yardsticks(torch, cases: dict) -> None:
    """What the card takes to stream a kernel's bytes without its work: per
    kernel, fills of outputs of its shapes, reads of its inputs (a max over
    them) or a conversion copy, each timed alone."""
    out = {name: {what: time_ms(torch, fn, 20) for what, fn in ops.items()}
           for name, ops in cases.items()}
    print("streaming yardsticks: " + json.dumps(out))


def baseline_batch_filter(torch, _build, lib, queries, entries, live):
    """The baseline library's filter: the sharded entry point for (S, Q, W)
    queries, the unsharded one for (Q, W)."""
    if queries.dim() == 3:
        s, q, w = queries.shape
        out = torch.empty((s, q, entries.shape[1]), dtype=torch.bool,
                          device=queries.device)
        err = lib.hippo_batch_filter_sharded(
            queries.data_ptr(), entries.data_ptr(), live.data_ptr(), s, q,
            entries.shape[1], w, out.data_ptr(), _build.stream_of(queries))
    else:
        q, w = queries.shape
        out = torch.empty((q, entries.shape[0]), dtype=torch.bool,
                          device=queries.device)
        err = lib.hippo_batch_filter(
            queries.data_ptr(), entries.data_ptr(), live.data_ptr(), q,
            entries.shape[0], w, out.data_ptr(), _build.stream_of(queries))
    _build.check(err, "baseline hippo_batch_filter")
    return out


def baseline_compact_inspect(torch, _build, lib, keys, valid, sel, sel_mask,
                             los, his):
    s, p, c = keys.shape
    q, m = sel_mask.shape[1], sel.shape[1]
    out = torch.empty((s, q, m), dtype=torch.int32, device=keys.device)
    _build.check(lib.hippo_compact_inspect(
        keys.data_ptr(), valid.data_ptr(), sel.data_ptr(), sel_mask.data_ptr(),
        los.data_ptr(), his.data_ptr(), s, p, c, m, q, out.data_ptr(),
        _build.stream_of(keys)), "baseline hippo_compact_inspect")
    return out


def baseline_page_inspect_many(torch, _build, lib, keys, valid, page_mask,
                               los, his):
    s, p, c = keys.shape
    q = page_mask.shape[1]
    out = torch.zeros((s, q), dtype=torch.int32, device=keys.device)
    _build.check(lib.hippo_page_inspect_many(
        keys.data_ptr(), valid.data_ptr(), page_mask.data_ptr(),
        los.data_ptr(), his.data_ptr(), s, p, c, q, out.data_ptr(),
        _build.stream_of(keys)), "baseline hippo_page_inspect_many")
    return out


def baseline_page_inspect(torch, _build, lib, keys, valid, mask, lo, hi):
    p, c = keys.shape
    qual = torch.empty((p, c), dtype=torch.bool, device=keys.device)
    counts = torch.empty((p,), dtype=torch.int32, device=keys.device)
    interval = torch.stack([lo, hi])
    _build.check(lib.hippo_page_inspect(
        keys.data_ptr(), valid.data_ptr(), mask.data_ptr(),
        interval.data_ptr(), p, c, qual.data_ptr(), counts.data_ptr(),
        _build.stream_of(keys)), "baseline hippo_page_inspect")
    return qual, counts


def nan_flag(csrc: Path) -> bool:
    """Whether the ``hippo_bucketize`` of the sources in ``csrc`` takes the
    ``nan_last`` argument (the sources before it do not)."""
    return "nan_last" in (csrc / "bucketize.cu").read_text()


def baseline_bucketize(torch, _build, lib, values, bounds, resolution,
                       nan_last):
    """``hippo_bucketize`` of ``lib`` at its own signature: with the
    ``nan_last`` argument, or without it where ``nan_last`` is None."""
    out = torch.empty((values.numel(),), dtype=torch.int32,
                      device=values.device)
    flag = () if nan_last is None else (int(nan_last),)
    _build.check(lib.hippo_bucketize(
        values.data_ptr(), values.numel(), bounds.data_ptr(), bounds.numel(),
        resolution, *flag, out.data_ptr(), _build.stream_of(values)),
        "baseline hippo_bucketize")
    return out


def graph_ms(torch, fn, iters: int) -> float:
    """Device time of ``fn`` with the host out of the way: ``iters`` calls
    captured in one CUDA graph, one replay timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare_designs(torch, _build, csrc: Path, cases: dict,
                    graphed=()) -> None:
    """Build the sources in ``csrc`` and time each case's baseline against
    the package's kernel in turns: baseline, package, package, baseline.
    Cases named in ``graphed`` (launches short enough that the host decides
    a timed loop) are also timed in turns by ``graph_ms``."""
    t0 = time.perf_counter()
    # the entry points the sources in csrc have (a design before the
    # bucket probe's rows entry lacks it)
    text = "".join(p.read_text() for p in _build.sources(csrc))
    signatures = {name: argtypes for name, argtypes
                  in _build.SIGNATURES.items() if f"{name}(" in text}
    if not nan_flag(csrc):
        signatures["hippo_bucketize"] = [
            a for i, a in enumerate(signatures["hippo_bucketize"]) if i != 5]
    lib = _build.load(_build.build(csrc.resolve()), signatures)
    print(f"baseline kernels from {csrc} built in "
          f"{time.perf_counter() - t0:.3f} s")
    out = {}
    for name, (new, old) in cases.items():
        got, want = new(), old(lib)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            exact(torch, f"{name} against the baseline design", g, w)
        turns = [time_ms(torch, lambda: old(lib), 20), time_ms(torch, new, 20),
                 time_ms(torch, new, 20), time_ms(torch, lambda: old(lib), 20)]
        out[name] = {"baseline_ms": [turns[0], turns[3]],
                     "ms": [turns[1], turns[2]],
                     "speedup": (turns[0] + turns[3]) / (turns[1] + turns[2])}
        if name in graphed:
            g = [graph_ms(torch, lambda: old(lib), 20), graph_ms(torch, new, 20),
                 graph_ms(torch, new, 20), graph_ms(torch, lambda: old(lib), 20)]
            out[name].update({"baseline_graph_ms": [g[0], g[3]],
                              "graph_ms": [g[1], g[2]],
                              "graph_speedup": (g[0] + g[3]) / (g[1] + g[2])})
    print("designs in turns: " + json.dumps(out))


def serve_stream(torch, QueryEngine, idx, preds, **kw) -> tuple:
    """Drain ``preds`` through one engine; (engine, tickets, q/s after the
    first batch, seconds of the first batch)."""
    eng = QueryEngine(idx, batch=BATCH, **kw)
    tk = [eng.submit(p) for p in preds]
    t0 = time.perf_counter()
    eng.run_batch()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng.drain()
    torch.cuda.synchronize()
    return eng, tk, (len(preds) - BATCH) / (time.perf_counter() - t1), t1 - t0


def dense_paths(torch, args, K, Predicate, intervals, QueryEngine, sidx,
                preds, brute_counts, compact_tickets) -> dict:
    """Phase 2b: the unsharded HippoIndex of the Lineitem table, single-query
    searches, TPC-H Q6/Q15/Q20, and the three dense engines."""
    from repro_torch.storage import tpch
    t0 = time.perf_counter()
    li = tpch.generate_lineitem(args.rows, args.seed)
    print(f"lineitem: {li.card:,} rows generated "
          f"({time.perf_counter() - t0:.3f} s)")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hidx = tpch.build_shipdate_index(li)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    dev = hidx.device
    keys = hidx.table.device_keys(device=dev)
    valid = hidx.table.device_valid(device=dev)

    # (b) single-query searches: tuple masks equal brute force
    rng = np.random.default_rng(args.seed + 1)
    spreds = make_preds(Predicate, rng, NUM_SEARCHES)
    lat = []
    for p in spreds:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = hidx.search(p)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        lo, hi = intervals([p], dev)
        brute = valid & (keys >= lo[0]) & (keys <= hi[0])
        if not torch.equal(res.qualified, brute):
            fail(f"search {p}: qualified differs from brute force in "
                 f"{int((res.qualified != brute).sum())} tuples")
        if int(res.count) != int(brute.sum()):
            fail(f"search {p}: count {int(res.count)} != {int(brute.sum())}")

    # (c) TPC-H Q6/Q15/Q20 against the same queries over brute force
    wlo, whi = tpch.selectivity_window(TPCH_SF)
    lo, hi = intervals([Predicate.between(wlo, whi)], dev)
    mask = (valid & (keys >= lo[0]) & (keys <= hi[0])).reshape(-1)
    mask = mask[: hidx.table.cardinality].cpu().numpy()
    t0 = time.perf_counter()
    got = (tpch.q6(li, hidx, wlo, whi), tpch.q15(li, hidx, wlo, whi),
           tpch.q20(li, hidx, wlo, whi))
    tpch_s = time.perf_counter() - t0
    want = (tpch.q6_over(li, mask), tpch.q15_over(li, mask),
            tpch.q20_over(li, mask))
    if got != want:
        fail(f"TPC-H at sf={TPCH_SF}: {got} != brute force {want}")

    # (d) the dense engines
    flat_k, flat_v = keys.reshape(-1), valid.reshape(-1)
    los, his = intervals(preds, dev)
    hbrute = [int((flat_v & (flat_k >= los[q]) & (flat_k <= his[q])).sum())
              for q in range(len(preds))]
    engines = {}
    for name, idx, kw, want_counts in (
            ("hippo_dense", hidx, {}, hbrute),
            ("sharded_routed", sidx, {}, brute_counts),
            ("sharded_fused", sidx, {"sharded": False}, brute_counts)):
        eng, tk, qps, first_s = serve_stream(torch, QueryEngine, idx, preds,
                                             mode="dense", **kw)
        for q, t in enumerate(tk):
            if not t.done or t.count != want_counts[q]:
                fail(f"{name} query {q} {preds[q]}: count {t.count} != "
                     f"brute force {want_counts[q]}")
            c = compact_tickets[q]
            if idx is sidx and (t.pages_inspected, t.entries_matched) != \
                    (c.pages_inspected, c.entries_matched):
                fail(f"{name} query {q}: pages/entries "
                     f"{(t.pages_inspected, t.entries_matched)} != compact "
                     f"{(c.pages_inspected, c.entries_matched)}")
        st = eng.stats
        engines[name] = {"qps_after_first": qps, "first_batch_s": first_s,
                         "batches": st.batches,
                         "shard_dispatches": st.shard_dispatches,
                         "shards_pruned": st.shards_pruned,
                         "occupancy": st.occupancy}
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print("dense paths: " + json.dumps({
        "rows": li.card, "pages": hidx.table.num_pages,
        "slots": hidx.cfg.max_slots, "entries": hidx.num_entries,
        "build_s": build_s, "searches": len(spreds),
        "search_ms_mean": 1e3 * sum(lat) / len(lat),
        "search_ms_min": 1e3 * min(lat),
        "tpch": {"sf": TPCH_SF, "window": [wlo, whi], "q6": got[0],
                 "q15": list(got[1]), "q20": got[2], "seconds": tpch_s},
        "engines": engines, "launches": launches,
        "max_memory_allocated": peak}))
    for name in ("bucketize", "batch_filter", *DENSE_KERNELS):
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the dense paths")
    print(f"dense paths checked: {len(spreds)} tuple masks, Q6/Q15/Q20 and "
          f"{len(preds)} counts x 3 dense engines equal brute force")
    return {"hidx": hidx, "launches": launches, "li": li}


EDGE_VALUES = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, -1.0, 1.0, 2.0,
                        3.0, 3.4e38, -3.4e38], np.float32)
# (S, Q, E, W) of the joint-bucket filters at the edges of their tensor-core
# tiling: Q across the 16-query m-tiles and the 64-query pass, W across the
# 8-word k-steps, E off the 256- and 128-entry tiles, E = 1 (the routing
# summary test), and odd E, so output rows and shard views start at every
# alignment.
BATCH_FILTER_EDGES = ((3, 70, 300, 13), (1, 1, 1, 2), (2, 65, 129, 32),
                      (4, 64, 1, 13), (1, 1, 300, 13), (2, 16, 257, 1),
                      (3, 17, 513, 8), (1, 64, 255, 9), (2, 65, 1001, 16),
                      (2, 130, 129, 17), (1, 33, 777, 24), (3, 64, 2049, 13))


def ragged_edges(torch, bf_ops, ci_ops, bk_ops, ba_ops, pi_ops, dev) -> None:
    """Kernel == plain version at shapes off the kernels' tiles: Q across the
    query tile, Q=1 and Q=65, E off the entry tile, C=50 and C=7, M=1 / M
    across the page tile, P off the page tiles, empty intervals, all-zero
    query rows, words with bit 31 set. For the filters also the shapes of
    ``BATCH_FILTER_EDGES``, dead slots, and the unsharded filter on every
    shard's view of a stack. For the two inspections also keys and
    endpoints drawn from ``EDGE_VALUES`` (NaN, +-0, +-inf, many ties, lo ==
    hi and lo > hi), C=1, C above a warp and above one round of 2048 slots,
    pads in ``sel`` and Q above one launch's query limit. For the single
    inspection also C around its 16-tuple runs, keys and valid past an
    aligned base, and all or no pages selected; for the bucket probe N
    around its vectors and its rank table, values past an aligned base,
    tied, equal and infinite bounds, H up to the kernel's limit, and NaN
    values with ``nan_last`` set and clear."""
    rng = np.random.default_rng(1)

    def edge_case(shape, q):
        keys = rng.choice(EDGE_VALUES, shape)
        keys = np.where(rng.random(shape) < 0.3,
                        rng.integers(-2, 5, shape).astype(np.float32), keys)
        lo = rng.choice(EDGE_VALUES, q)
        hi = np.where(rng.random(q) < 0.3, lo, rng.choice(EDGE_VALUES, q))
        return (torch.from_numpy(keys).to(dev),
                torch.from_numpy(rng.random(shape) < 0.85).to(dev),
                torch.from_numpy(lo).to(dev),
                torch.from_numpy(hi.astype(np.float32)).to(dev))

    def words(shape, density):
        bits = rng.random((*shape, 32)) < density
        w = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
        return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)

    for s, q, e, w in BATCH_FILTER_EDGES:
        qb = words((s, q, w), 0.02)
        qb[:, ::7] = 0                                   # all-zero queries
        qb[:, 1::5, -1] |= torch.tensor(np.uint32(1 << 31).view(np.int32),
                                        device=dev)      # bit 31 only
        ent = words((s, e, w), 0.05)
        ent[:, ::3, -1] = torch.tensor(np.uint32(1 << 31).view(np.int32),
                                       device=dev)
        live = torch.from_numpy(rng.random((s, e)) < 0.8).to(dev)
        live[-1, e // 2:] = False                        # past num_slots
        if s > 1:
            live[0] = False                              # a dead shard
        exact(torch, f"batch_filter ragged {(s, q, e, w)}",
              bf_ops.batch_filter_sharded(qb, ent, live),
              bf_ops.batch_filter_sharded_ref(qb, ent, live))
        # D on each shard's view of the stack (4 B aligned only for odd E)
        for k in range(s):
            exact(torch, f"batch_filter_unsharded on shard view {k} of "
                  f"{(s, q, e, w)}",
                  bf_ops.batch_filter(qb[k].contiguous(), ent[k], live[k]),
                  bf_ops.batch_filter_ref(qb[k].contiguous(), ent[k], live[k]))
    for s, p, c, m, q in ((2, 40, 50, 1, 5), (3, 70, 50, 33, 67),
                          (1, 5, 7, 40, 3)):
        keys = torch.from_numpy(
            rng.integers(0, 100, (s, p, c)).astype(np.float32)).to(dev)
        valid = torch.from_numpy(rng.random((s, p, c)) < 0.9).to(dev)
        sel = np.sort(rng.integers(0, p + p // 2, (s, m)), axis=1)
        sel = torch.from_numpy(np.minimum(sel, p).astype(np.int32)).to(dev)
        sel_mask = torch.from_numpy(rng.random((s, q, m)) < 0.7).to(dev)
        lo = rng.integers(0, 100, q).astype(np.float32)
        hi = lo + rng.integers(-5, 30, q).astype(np.float32)   # some empty
        los = torch.from_numpy(lo).to(dev)
        his = torch.from_numpy(hi).to(dev)
        exact(torch, f"compact_inspect ragged {(s, p, c, m, q)}",
              ci_ops.compact_inspect(keys, valid, sel, sel_mask, los, his),
              ci_ops.compact_inspect_ref(keys, valid, sel, sel_mask, los, his))
    for s, p, c, m, q in ((1, 1, 1, 1, 1), (2, 30, 1, 70, 65),
                          (1, 9, 7, 20, 2), (3, 40, 50, 33, 64),
                          (1, 12, 33, 9, 130),
                          (2, 6, 300, 5, 16), (1, 20, 50, 40, 1100),
                          (2, 3, 2100, 4, 9), (1, 4, 300, 6, 600)):
        keys, valid, los, his = edge_case((s, p, c), q)
        sel = np.sort(rng.integers(0, p + 3, (s, m)), axis=1)   # pads >= P
        sel = torch.from_numpy(sel.astype(np.int32)).to(dev)
        sel_mask = torch.from_numpy(rng.random((s, q, m)) < 0.8).to(dev)
        exact(torch, f"compact_inspect edge values {(s, p, c, m, q)}",
              ci_ops.compact_inspect(keys, valid, sel, sel_mask, los, his),
              ci_ops.compact_inspect_ref(keys, valid, sel, sel_mask, los, his))
    for h in (400, 7, 1):
        b = np.cumsum(rng.random(h + 1) + 0.01).astype(np.float32)
        bounds = torch.from_numpy(b).to(dev)
        v = np.concatenate([rng.uniform(b[0] - 5, b[-1] + 5, 1000),
                            b, [3.4e38, -3.4e38]]).astype(np.float32)
        vals = torch.from_numpy(v).to(dev)
        exact(torch, f"bucketize ragged H={h}",
              bk_ops.bucketize_values(vals, bounds, h),
              bk_ops.bucketize_ref(vals, bounds, h))
    for q, e, w in ((70, 300, 13), (1, 1, 2), (65, 257, 32), (64, 129, 13),
                    (16, 1, 1), (17, 513, 8), (64, 255, 9), (130, 1001, 16),
                    (33, 777, 17), (1, 300, 24)):
        qb = words((q, w), 0.02)
        qb[::7] = 0                                      # all-zero queries
        qb[1::5, -1] |= torch.tensor(np.uint32(1 << 31).view(np.int32),
                                     device=dev)         # bit 31 only
        ent = words((e, w), 0.05)
        ent[::3, -1] = torch.tensor(np.uint32(1 << 31).view(np.int32),
                                    device=dev)
        live = torch.from_numpy(rng.random(e) < 0.8).to(dev)
        exact(torch, f"batch_filter_unsharded ragged {(q, e, w)}",
              bf_ops.batch_filter(qb, ent, live),
              bf_ops.batch_filter_ref(qb, ent, live))
        for query in (qb[-1].contiguous(), qb[0].contiguous()):
            exact(torch, f"bitmap_and ragged {(e, w)}",
                  ba_ops.bitmap_and_any(ent, query, live),
                  ba_ops.bitmap_and_any_ref(ent, query, live))
    for p, c in ((1, 50), (63, 50), (65, 7), (130, 50), (3, 1)):
        keys = torch.from_numpy(
            rng.integers(0, 100, (p, c)).astype(np.float32)).to(dev)
        valid = torch.from_numpy(rng.random((p, c)) < 0.9).to(dev)
        mask = torch.from_numpy(rng.random(p) < 0.6).to(dev)
        for lo, hi in ((10.0, 40.0), (50.0, 50.0), (30.0, 20.0)):
            got = pi_ops.page_inspect(keys, valid, mask, lo, hi)
            want = pi_ops.page_inspect_ref(keys, valid, mask, lo, hi)
            exact(torch, f"page_inspect ragged {(p, c, lo, hi)} qual",
                  got[0], want[0])
            exact(torch, f"page_inspect ragged {(p, c, lo, hi)} counts",
                  got[1], want[1])
    # E single at every run width against C, P off the 64-page tile, keys and
    # valid at 1-3 elements past an aligned base (the kernel's narrow path),
    # all and no pages selected, edge keys and intervals
    for c in (1, 7, 15, 16, 17, 50, 300, 2100):
        for p, off in ((1, 0), (65, 0), (130, 3), (64, 2), (67, 1)):
            shape = (p, c)
            keys, valid, los, his = edge_case((p * c + off,), 4)
            keys = keys[off:].view(shape)
            valid = valid[off:].view(shape)
            for mask in (torch.from_numpy(rng.random(p) < 0.6).to(dev),
                         torch.ones(p, dtype=torch.bool, device=dev),
                         torch.zeros(p, dtype=torch.bool, device=dev)):
                for lo, hi in zip(los, his):
                    got = pi_ops.page_inspect(keys, valid, mask, lo, hi)
                    want = pi_ops.page_inspect_ref(keys, valid, mask, lo, hi)
                    for g, w in zip(got, want):
                        exact(torch, f"page_inspect edge values {(p, c, off)}",
                              g, w)
    # C at N around its vector widths, N of the vector launch without the
    # rank table (an insert batch, one vacuum's re-probed pages), values 1-3
    # elements past an aligned base (2: 8 mod 16), edge values, values equal
    # to bounds, tied bounds, all bounds equal, +-inf end bounds, H up to the
    # kernel's limit
    for h in (1, 7, 64, 400, 12287):
        b = np.cumsum(rng.random(h + 1) + 0.01).astype(np.float32)
        tied = np.sort(rng.integers(0, 5, h + 1)).astype(np.float32)
        ends = b.copy()
        ends[0], ends[-1] = -np.inf, np.inf
        for bnd in (b, tied, np.full(h + 1, 2.0, np.float32), ends):
            pool = np.concatenate([EDGE_VALUES, bnd[:50], bnd[-50:]])
            bounds = torch.from_numpy(bnd).to(dev)
            for n in (1, 3, 4, 5, 127, 128, 129, 4096, 59_986, 290_001,
                      4_500_001):
                for off in (0, 1, 2, 3):
                    v = rng.choice(pool, n + off).astype(np.float32)
                    if n > 1000:
                        v[::2] = rng.uniform(b[0] - 5, b[-1] + 5, v[::2].size)
                    vals = torch.from_numpy(v).to(dev)[off:]
                    for nan_last in (False, True):
                        exact(torch, f"bucketize edge values H={h} N={n} "
                              f"offset={off} nan_last={nan_last}",
                              bk_ops.bucketize_values(vals, bounds, h,
                                                      nan_last),
                              bk_ops.bucketize_ref(vals, bounds, h, nan_last))
    for s, p, c, q in ((1, 40, 50, 1), (3, 70, 50, 65), (1, 5, 7, 3),
                       (2, 2049, 7, 64), (4, 130, 1, 9)):
        keys = torch.from_numpy(
            rng.integers(0, 100, (s, p, c)).astype(np.float32)).to(dev)
        valid = torch.from_numpy(rng.random((s, p, c)) < 0.9).to(dev)
        page_mask = torch.from_numpy(rng.random((s, q, p)) < 0.7).to(dev)
        lo = rng.integers(0, 100, q).astype(np.float32)
        hi = lo + rng.integers(-5, 30, q).astype(np.float32)   # some empty
        los = torch.from_numpy(lo).to(dev)
        his = torch.from_numpy(hi).to(dev)
        exact(torch, f"page_inspect_many ragged {(s, p, c, q)}",
              pi_ops.page_inspect_many(keys, valid, page_mask, los, his),
              pi_ops.page_inspect_many_ref(keys, valid, page_mask, los, his))
    for s, p, c, q in ((1, 1, 1, 1), (2, 70, 1, 65), (1, 9, 7, 2),
                       (3, 40, 50, 64), (1, 33, 33, 130), (2, 6, 300, 16),
                       (1, 20, 50, 1100), (2, 3, 2100, 9), (1, 4, 300, 600)):
        keys, valid, los, his = edge_case((s, p, c), q)
        page_mask = torch.from_numpy(rng.random((s, q, p)) < 0.8).to(dev)
        exact(torch, f"page_inspect_many edge values {(s, p, c, q)}",
              pi_ops.page_inspect_many(keys, valid, page_mask, los, his),
              pi_ops.page_inspect_many_ref(keys, valid, page_mask, los, his))


if __name__ == "__main__":
    sys.exit(main())
