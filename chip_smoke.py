#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one CUDA card and check them.

    python3 chip_smoke.py [--n 1000000] [--queries 256] [--seed 0] [--tree-n 50000]
                          [--moving-n 1000000] [--ticks 20] [--prefill 4096]
                          [--kv-len 32768]

Phases (each path is driven with every launch counter set to 0 just before
it and read just after):
  1. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc;
     start a second, independent build of both trees in worker processes;
  2. pyramid path: ``SpatialIndex.build(uniform_squares(n),
     structure="pyramid", build="device")`` on the card, then ``.region /
     .point / .count`` at ``precision="float32"`` and ``"compact"`` (tiling
     pinned to ``block_w=128, autotune="off"``); fails unless every kernel
     of the path launched;
  3. pyramid results: hits and visits equal the plain-PyTorch path on the
     same card (plain build, plain quantizer, plain sweep), compact hits
     equal float32 hits, hits cover a brute-force object-overlap mask (extra
     hits are printed), counts agree, and a small index on the card agrees
     with the numpy oracle on the CPU;
  4. pyramid extras: ``precision="compact8"`` (uint8 upper tiles, int32
     parents; its build must launch ``quantize_cm`` once, both tile forms
     in one pass, and run no plain quantizer), ``per_level_region_search``
     (one ``mbr_scan`` launch per level) and a default-configured backend
     (``autotune="auto"``, whose tuned tiling is printed); hits and visits
     equal the fused float32 path, compact8 visits equal the plain
     hierarchical sweep;
  5. tree path: ``SpatialIndex.build(uniform_squares(tree_n))`` with the
     port's defaults (the paper's mqr-tree) and ``structure="rtree"`` over
     the same data, each answering region, point and count batches at
     float32, compact and compact8 (tree schedules: root visited
     unconditionally, object-MBR gate, uint16 parents); fails unless the
     sweeps, the hierarchical sweep, the quantizer and a uint16-parent
     sweep launched, and unless each compact and compact8 build launched
     the quantizer once and ran no plain quantizer;
  6. tree results: hits and visits equal the plain path at each precision,
     hits equal the host pointer-search oracle (visits too at float32),
     compact hits equal float32 hits, and each tree schedule equals the
     second build's;
  7. flat levels: a tree schedule swept with ``uncond_from = L - 1`` and
     ``1`` by each sweep kernel (the streaming one too) equals its plain
     version;
  8. live pyramid path: a second device-built index of the same n objects,
     at float32 and compact (fixed tiling), goes through three mutation
     steps, each followed by region, point and count batches: (a) insert
     200 squares (the delta buffer, capacity 256), delete 1,000 base ids
     and 50 of the new ids; (b) ``flush()`` (a device rebuild); (c) insert
     a batch larger than the capacity (the merge path).  After each step:
     hits equal a brute-force numpy float32 overlap over the live object
     table and ``alive``, hits and visits (delta columns included) equal
     the plain path on the card, compact hits equal float32 hits, counts
     agree; hits are bit-identical across the flush.  Fails unless the
     build, quantize and both sweep kernels launched;
  9. live trees: the mqr-tree and R-tree of phase 5 extended with the same
     inserts and deletes (no flush), checked as in 8; and a small mqr-tree
     (2,000 objects) through a flush, checked against the port's own mqr
     insertion-rule oracle (``repro_torch.update.oracle``);
 10. stream path: ``stream=True`` backends (fixed tiling) on the pyramid at
     float32 and compact and on both trees at float32 and compact; hits and
     visits equal the resident sweep's, kernel #2's mask equals kernel #1's
     and its plain version's, its skip count equals the plain rule's and is
     above 0 on the pyramid and the mqr-tree; fails unless the streaming
     kernel launched;
 11. edge shapes: kernels #1, #2 and #3 against their plain versions, by
     equality, on device-built pyramids of width 1, 3, 17, 129 and 4,097, the
     two trees of phase 5 (widths 13,534 and 14,237 at the defaults) and
     Hilbert-ordered copies of the wider ones, at Q 1, 9, 33 and 257,
     ``block_w`` 64, 128, 256 and 512, every tile and parent type each
     kernel takes, ``root_unconditional`` both ways and ``uncond_from``
     None, 1 and L - 1, #3 with ``n_real`` None, the schedule's and the
     tight one of the plain mask; #2's skip count against the plain rule;
     fails unless #2 took its prefix-scan path (wide windows) at least once.
     #3 also at 1 and 20 levels, and on the mqr-tree twice back to back, on
     two streams at once and with one query after them; all of #3's calls
     but those through the wrapper with ``n_real`` None write into an
     output filled with 0xFF first, so a byte read before it was stored
     shows.  Kernel #7 at N 1,
     15, 16, 17, 127, 128, 129, 4,097, 13,534 and 14,237 × Q 1, 8, 9, 16,
     17, 33, 64, 255, 256 and 257, both layouts, every ``block_n`` it
     accepts, with +inf, NaN and subnormal rows and queries, by equality.
     Kernel #4 at n 1-100,000 (around 5^l and the shared-memory bound),
     levels 1, 2, default and 20, on uniform, identical, one-point and
     signed-zero boxes, by its bits but for zero signs (C12), and twice
     (deterministic); kernel #6 at every pair of widths 1-4,097, K 1, 3
     and 11, float32 and uint16, symmetric both ways, by equality; kernel
     #5 at L 1, 2, 11 and 20 × W 1-100,000 (7, 9, 13,534 and 14,237
     among them), ``n_real`` None and given (0, 1, W and inside an
     8-element group), uint16 alone and with the uint8 tiles at splits
     0 to L, garbage past ``n_real``, +inf, -inf and ±1e30 inside it,
     bases off alignment and level slices, into outputs filled with 0x00
     and 0xFF, bit for bit;
 12. join path: ``mqr.join(rtree)`` at float32 and with the left side at
     ``precision="compact"``, the symmetric self-join ``mqr.join(mqr)``, a
     device-built pyramid over ``exponential_squares(tree_n, seed=2)``
     joined with the mqr-tree, and the live mqr-tree of phase 9
     (mid-buffer, with tombstones) joined with the R-tree; fails unless the
     float32, uint16 and symmetric instantiations of kernel #6 launched.
     Each join's pairs equal a brute-force float32 overlap of the two live
     object sets (row chunks on the card), each level of kernel #6's mask
     equals ``pair_sweep_torch``, and ``pair_visits`` equals the plain
     version's; the join's time is split into host lowering, sweep and
     epilogue;
 13. k-NN path: k = 10 for the point batches at object centroids on the
     pyramid (n) and on the mqr-tree (tree_n), through expanding-radius
     rounds of kernel #1; ids equal a float64 brute force on the card with
     ties by lowest id (float32 near-ties excepted and counted), dists are
     within 4 float32 ulp of the float64 ones, and the mqr-tree's ids equal
     the host pointer search's; prints rounds and ms per call;
 14. moving-object workload: ``MovingConfig(n_objects=moving_n,
     moves_per_tick=1_000, n_zones=12, query_every=1)`` on a live
     device-built pyramid (capacity 4,096, fixed tiling) for ``--ticks``
     ticks, then 3 ticks of ``rebuild_per_tick=True`` on the same seed;
     every tick's region hits and join pairs equal a brute force over the
     current boxes and global ids (the baseline's pristine pyramid answers
     region queries by its deepest groups, so there the hits must cover the
     brute force), and the baseline's join pairs equal the live path's per
     object slot; prints ticks/s, merges and pair tests;
 15. durability and serving ladder, on the pyramid of phase 2 (n
     objects) in a temporary directory: ``save`` then ``load`` onto the
     card of the float32 index, its compact twin and a live copy
     mid-buffer (200 inserts, 520 deletes): hits and visits equal the
     saved index's, and no ``build_levels`` or ``quantize_cm`` launches
     during a load; snapshot bytes, save and load ms.  The ``serve``
     backend: a Q batch, the same batch again wholly from the LRU, the
     batch on a cache-less server and a pristine compact8 server, each
     equal to the ``cuda`` backend and dispatched on ``cuda`` only with no
     failure; 16-query batches with ``FaultPlan`` failures on ``cuda``
     (the ``torch`` rung answers) and on ``cuda`` and ``torch`` (``host``),
     ``fail_from_launch`` (a degrade mid-run) and ``reset_health``, every
     answer equal to the ``cuda`` rung's and the ledger equal to what was
     injected; each rung's ms; a ``serve`` join mqr ⋈ R-tree healthy and
     with ``cuda`` failing, pairs equal.  Then a compact ``DurableIndex``
     (capacity 4,096) runs 200 ops of ``mutation_workload`` (merges at its
     flush ops), killed post-append, mid-merge and by a torn write, each
     recovered onto the card: the op count, the live ids, the base schedule (bit for bit)
     and the uint16 tiles equal an un-killed run of the same ops, and Q
     hits equal a brute force over the live ids; WAL appends/s with and
     without fsync, recover ms and ops replayed;
 16. serving front end (``repro_torch.serve``), in a temporary directory:
     three pyramid tenants of n objects on the ``serve`` backend, built on
     the card (``maps`` compact, ``fleet`` float32 and durable with a
     delta buffer of 4,096, ``maps8`` compact8), 16-query batches, an
     interactive class (50 ms, shed past 256) and a batch class (2 s,
     queued).  First, while ``fleet`` is pristine, one batch of each
     tenant with the launch-report side channel armed: ``bytes_streamed``
     equals its formula (the card's bytes, ROADMAP C19) and, with the mask
     written, over the sweep's device time stays within 3.35 TB/s x 1.05.
     Then 3 segments of 48 region, count, point and k-NN (k 10) requests
     through the queue, ``fleet`` mutated between them: every answer
     equals the tenant's own index called directly on the ``cuda``
     backend, counts equal ``hits.sum()``, and a repeated ``maps`` query
     comes from its cache at epoch 0; each of 4 batches' host service time
     is at least its CUDA-event device window; every batch so far ran on
     the ``cuda`` rung; 192 requests with a ``FaultPlan`` bound mid-run
     (``cuda`` failing from its third attempt) answer as the direct call
     while every tenant degrades to ``torch``; a new front end over
     ``fleet``'s durable root recovers it and answers 64 queries as before
     the restart; an open-loop sweep (``run_sweep``) on ``maps`` at 1,000,
     4,000 and 16,000 region queries/s, 2 s each, prints offered and
     achieved rates, p50 / p99 / p99.9, shed, SLO violations, the average
     batch and the queue-wait p99; fails unless #4, #5, #1 (both tile
     types) and #3 launched;
 17. mqr-KV and attention kernels, at llama3.2-1B's widths (d_model 2048,
     32 heads, 8 kv heads, head dim 64; mqr block 128, top-K 64, 6 levels),
     random inputs from the seed: ``ops.rmsnorm`` on (prefill, 2048) and
     ``ops.flash_attention`` on (32, prefill, 64), each in float32 and
     bfloat16; a decode step over a (4, kv_len, 8, 64) bfloat16 cache at
     pos = kv_len - 37 (defaults: prefill 4096, kv_len 32768): one
     ``kvindex.build_kv_index`` per (batch, kv head), ``query_region`` per
     query head, ``select_blocks_batched`` per kv head (ids (128, 64)),
     then ``ops.mqr_sparse_attention`` over the kv blocks broadcast to
     (128, kv_len / 128, 128, 64) in bfloat16 and float32; fails unless all
     three kernels launched in both types, unless the outputs are finite
     and of the expected shapes, unless the ids equal ``select_blocks`` on
     the CPU over the same block MBRs, pyramids and regions (the survivor
     masks of the region search too), and unless the region survivors come
     first; random keys leave every block a survivor, so the same checks
     run again on a cache whose scores drift with position, where the
     search must prune for every head; prints the fraction of blocks
     attended and the ms of index build, selection and attention per
     decode step beside the plain dense decode over all blocks;
 18. LLM serving, llama3.2-1B at full width (``repro_torch.models``: 16
     layers, d_model 2048, 32 heads, 8 kv heads, head dim 64, vocab
     128,256, tied, bfloat16), random parameters from the seed on the
     card: ``launch.serve.serve`` at B 4, prompt 32, gen 32, dense and
     ``mqr_sparse=True`` (tokens in range; #10 launched 33 times a step,
     #9 16 times a sparse step, no plain version of #8-#10 called; tok/s);
     one ``decode_step`` over (4, kv_len) caches of every layer filled from
     the seed at pos = kv_len - 37, dense and sparse (64 of kv_len / 128
     blocks), each step's ms and one layer's batched index build (B x 8
     indexes in one pass); the model's ids equal ``select_blocks`` on the
     single-row index of each (batch, kv head); #9 at ``group`` 4 on the
     model's inputs within its bfloat16 limit of the plain version; with
     top-K = every block the sparse step's logits within 0.05 of the
     dense step's on a float32 copy of the model and caches (the bfloat16
     difference printed); a step with ``mqr_incremental=True`` launches #9
     16 times; ``prefill`` of (1, prefill) launches #8 16 times, and a
     256-token prompt's last logits through ``prefill`` lie within 0.25 of
     the same prompt streamed through decode steps; the dry run of the
     decode steps (dense, sparse) and the prefill against one more of each
     on the card (``dryrun_check``: ``launch.dryrun``'s step on ``meta``
     under ``OpCost``, then the same step on the card under it: counted
     FLOPs and bytes equal, the predicted peak within 10 % of
     ``max_memory_allocated``; model FLOPs, the roofline bound, ``mfu``
     and ``roofline_mfu`` printed); ``make_host_mesh()`` on a world-size-1
     NCCL group, every parameter distributed with its ``param_shardings``
     placements (local shards bit-equal), ``reshard_plan`` onto the same
     mesh the identity; ``route_shards`` of 4,096 shard MBRs to 64 hosts
     (``mesh_router_check``); the sharded decode step
     (``sharded_decode_check``): one dense step of B 4 over the long
     caches with parameters, tokens and caches placed as DTensors on a
     1x1 NCCL ``DeviceMesh`` (``launch.steps.place``, no copies), its
     tokens equal to the unsharded step's, #10 through ``local_map`` 33
     times and no plain version; both steps' times;
     LLM families, at full width, one model at a time (the card freed
     between): granite-moe-1b (24 layers, 32 experts top-8), DeepSeek-V3
     cut to its 3 dense layers and first MoE layer (61 do not fit one
     card; MTP, never applied in serving, left out), mamba2-2.7b (64
     layers) and recurrentgemma-9b (36 layers); ``serve`` (granite B 4
     dense and sparse, mamba2 B 4, recurrentgemma B 2), ``prefill`` of
     (1, prefill), decode steps (granite and DeepSeek dense and sparse
     over (4, kv_len) caches filled from the seed), each with #10's,
     #8's and #9's launches counted and no plain version called; one
     traced dense step's idle share; the MoE layer's einsum and scatter
     dispatches within 2e-2 + 2e-2 |b| with equal loads, its load summing
     to the kept choices a token, and, drop-free, all tokens at once
     against one at a time; #10 at every width of the path; a 128-token
     prompt's last logits through ``prefill`` within 1e-2 of the prompt
     streamed through decode steps on a float32 model drawn from the seed
     (DeepSeek's first layer alone), and there MLA's sparse decode with
     top-K = every block within 0.05 of dense; peak device memory; the
     sharded MoE and MLA families (``sharded_family_check``, granite-moe-1b
     and DeepSeek-V3 cut): parameters, tokens and caches placed as
     DTensors on a 1x1 NCCL ``DeviceMesh`` (no copies), a prefill of (1,
     prefill) and a dense decode step of B 4 over (4, kv_len) caches
     against the unsharded steps (logits bit for bit, or within 1e-5 with
     the worst difference printed; tokens equal; #8 and #10 through
     ``local_map`` as counted, no plain version), each step's time once
     warm; then granite-moe-1b's first training on the card, 4 train
     steps of B 8 x S 1024 sharded against 4 unsharded from copies of the
     same state (``sharded_step_check``: bit for bit, #8 48, 8b 24, #10 97
     and 10b 49 launches a step, no collective and equal counted FLOPs
     under ``OpCost``, step ms and ``max_memory_allocated`` of both); the
     same sharded prefill and decode for mamba2-2.7b (heads over ``model``,
     its gated norm's #10 too), recurrentgemma-9b (its decode at a
     position past the 2,048-slot window: the ring wrapped), internvl2-2b
     (1,024 patch embeddings in the prefill) and musicgen-large (4
     codebooks; decode at B 2), the recurrent states restored before each
     compared step; and mamba2-2.7b's first training on the card, 16 of
     its 64 layers, 4 train steps sharded against unsharded (#10 97 and
     10b 49 a step);
     training (``train_phase``, after the card is freed and its peak
     statistics reset): llama3.2-1B at full width, bf16, remat "full", 10
     steps of ``launch.steps.make_train_step`` on ``SyntheticLM`` batches
     of B 8 x S 1024 (finite losses, the last below the first; #8 forward
     32, #8 backward 16, #10 forward 65 and #10 backward 33 launches a
     step; no plain version), step ms, tokens/s and peak memory; a
     ``CheckpointManager`` save at step 5 restored bit for bit into fresh
     parameters and state and steps 5-9 resumed within 1e-5 of the
     uninterrupted losses; one EF-int8 step; a float32 2-layer copy at
     full width stepped on the card and on the CPU from the same
     parameters and batch (loss and grad norm within 1e-4 relative, each
     gradient within the float32 row-scaled limit); then gemma-2b at full
     width, bf16, 3 steps of B 2 x S 1024 (#8's backward at head dim 256,
     18 a step; finite losses, the counted launches, no plain version),
     step ms and peak memory; the dry run of a llama3.2-1B step (after the
     EF-int8 step) and a gemma-2b step against one more on the card, as
     the decode steps' (the five cells' seconds are printed, ~30 s); the
     sharded train step (``sharded_step_check``, after the EF-int8 step):
     copies of the trained parameters and state placed as DTensors on a
     1x1 NCCL ``DeviceMesh``, two sharded steps against two unsharded
     steps from the same state (the loss and every updated parameter bit
     for bit, or within 1e-5 with the leaves named), #8, 8b, #10 and 10b
     through ``local_map`` the counted number of times a step, no plain
     version, a third sharded step under ``OpCost`` (no collective, its
     counted FLOPs and kernel reports equal to one more unsharded
     step's), both steps' times; the group destroyed;
 19. each kernel against its plain version at its path's shapes (exact
     equality: masks, integers and float32 min/max/compare do not round;
     #4's float32 bounds by their bits; #8-#10, floating reductions,
     within ``rtol |plain| + row_rms x RMS of the row``: float32 (1e-4,
     1e-4), rmsnorm (1e-5, 1e-5); bfloat16
     (2e-2, 3e-2); #8 and #9's limits must reject the plain version with
     one block of keys left out; #8 also at D 128, at S 320, 200 and 64,
     and #10 at d 2050 and on a base one element off 16-byte alignment),
     timed on the device (the profiler's kernel time, mean of 7 calls
     after warm-up; one call's CUDA-event window, which also holds the
     host's time to launch, printed beside it; a row's ``timed_by`` says,
     for each of its times, ``"graph"`` where every trace lost activities
     and replays of a CUDA graph of the calls stand in, ``"events"`` where
     the calls could not be captured either and the median event window
     stands in), beside
     the least time the card needs for the same bytes and operations (for
     the streaming sweep, the tile and parent bytes of the tiles it read;
     for #5, the real slots read and every output byte written, with the
     dense bound, every slot read, printed beside it; for #8 the causal
     FLOPs at the tensor-core bf16 peak or the float32 CUDA-core peak)
     and, for #8 and #10, one PyTorch library call on the same inputs
     (``scaled_dot_product_attention``, ``rms_norm``); #5 on the pyramid
     (uint16, and uint16 + uint8 as compact8 builds it) and on the
     mqr-tree; #7 on the pyramid's widest level and #3 on the mqr-tree
     also at the autotuner's 16-query probe shape, and #3's CUDA launches
     a call; beside the rows of #1, #3, #5, #6 and #7, the device time of
     one fill (``zero_()``) of the same output bytes, a practical
     store-rate floor printed as context;
     before #4's row, its device time by level and kernel (the profiler's
     kernels in launch order) and its launches a level; #9 also as the
     model calls it (``group`` 4, the model's ids; its bound counts each
     distinct (kv row, block) once), and #8-#10's launches are those of
     phases 17 and 18; the backward kernels of #8 and #10 against autograd
     of their plain versions (``grad_kernel_checks``: #8 at (256, 1024,
     64) and gemma-2b's (16, 1024, 256), D 128, S 320 and 200 at D 64,
     128 and 256 in both types, its limit rejecting dk and dv with a block
     of keys left out, the forward's log-sum-exp against
     ``torch.logsumexp``, D 96 refused; #10's vector path at (8192, 2048),
     (4097, 256) and (300, 4096), its scalar path at d 2050 and off
     alignment; each twice, bit-equal), timed beside their bounds and the
     backward of SDPA and ``F.rms_norm``, their launches those of the
     training phase;
 20. end-to-end times of builds, region and point batches (first call,
     which includes autotuning, apart from the steady state), peak device
     memory, and a torch.profiler trace of one call per path (region
     batches per path and precision, two joins, a k-NN call, a moving tick,
     an mqr-KV decode step and llama3.2-1B's dense and sparse decode steps:
     device time by kernel, and the device's idle share).

Prints the card's name and power limit, a ``{"kernels": [...]}`` line and,
as the last line, ``{"ok": true, "device": {...}}``.  Exits nonzero, with no
result, when there is no CUDA device, when the port is missing, or when any
phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import itertools
import json
import math
import multiprocessing
import statistics
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# HBM3 bandwidth, and the CUDA-core 32-bit rate used for compares.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
REPEATS = 7
# The edge shapes of kernels #1-#3 (the trees' widths come from the tree path).
EDGE_WIDTHS = (1, 3, 17, 129, 4097)
EDGE_QUERIES = (1, 9, 33, 257)
EDGE_BLOCKS = (64, 128, 256, 512)
# Kernel #2 tests a window wider than this many tiles on its prefix scan
# (WIDE_WINDOW of csrc/level_sweep.cu).
EDGE_WIDE_WINDOW = 8
PRECISIONS = ("float32", "compact", "compact8")
TREES = ("mqr", "rtree")
# The pyramid path of the first slice keeps its fixed tiling, so its times
# stay comparable from run to run.
FIXED = {"block_w": 128, "autotune": "off"}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def second_tree_build(structure: str, n: int, seed: int):
    """Build a tree's level schedule again, in a worker process, through
    the port's host modules; returns (host build seconds, numpy fields)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import datasets, flat, mqrtree, rtree

    data = datasets.uniform_squares(n, seed=seed)
    t = time.perf_counter()
    tree = mqrtree.build(data) if structure == "mqr" else rtree.build(data)
    build_s = time.perf_counter() - t
    sched = flat.level_schedule(flat.flatten(tree))
    return build_s, {f.name: (v.numpy() if isinstance(v, torch.Tensor) else v)
                     for f in dataclasses.fields(sched)
                     for v in [getattr(sched, f.name)]}


def card_device() -> torch.device:
    return torch.device("cuda", 0)


def sync():
    torch.cuda.synchronize()


def time_ms(fn, repeats: int = REPEATS) -> float:
    """Median device time of ``fn()`` in ms (CUDA events), after warm-up."""
    fn()
    sync()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        sync()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


TRACE_ATTEMPTS = 4  # traces of one measurement, until none lost device events


def complete(counts, repeats: int) -> bool:
    """Whether a trace of ``repeats`` calls holds every call's device
    activities: each kernel name a multiple of ``repeats`` times.  The
    profiler sometimes drops activities (seen on the H100 for the port's
    kernels), which would make a mean per call too small."""
    return bool(counts) and all(c % repeats == 0 for c in counts)


def device_timing(fn, repeats: int = REPEATS) -> tuple[float, str]:
    """Mean device time of ``fn()`` in ms, and how it was timed
    (``"profiler"``, ``"graph"`` or ``"events"``): every kernel, copy and fill it
    launched, from the profiler's trace of ``repeats`` calls after a
    warm-up, traced again (up to TRACE_ATTEMPTS times) while the trace
    lost activities.  An event window around one call also holds the
    host's time to reach the launch (the wrapper's checks and allocation),
    which for a kernel of tens of microseconds is as long as the kernel.
    Falls back to :func:`graph_ms` if the profiler lost activities in every
    trace, and to :func:`time_ms` if the profiler sees no device time or
    the calls cannot be captured in a graph."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    for _ in range(TRACE_ATTEMPTS):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(repeats):
                    fn()
                sync()
            events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if complete([e.count for e in events], repeats):
            break
        print("  (the profiler lost device activities; tracing again)", flush=True)
    else:
        ms = graph_ms(fn, repeats)
        if ms is not None:
            print("  (every trace lost device activities; timing replays of a CUDA graph)",
                  flush=True)
            return ms, "graph"
        print("  (every trace lost device activities; timing with CUDA events)", flush=True)
        return time_ms(fn, repeats), "events"
    total_us = 0.0
    for evt in events:
        total_us += (getattr(evt, "self_device_time_total", None)
                     or getattr(evt, "self_cuda_time_total", 0))
    if total_us <= 0:
        print("  (the profiler saw no device time; timing with CUDA events)", flush=True)
        return time_ms(fn, repeats), "events"
    return total_us / repeats / 1e3, "profiler"


def graph_ms(fn, repeats: int = REPEATS):
    """Mean device time of ``fn()`` in ms from CUDA events around replays of
    a CUDA graph that captured ``repeats`` calls: the device's time alone,
    with no host time between the launches (an event window around one
    eager call of a kernel of tens of microseconds is mostly the wrapper's
    host time).  None if the calls cannot be captured."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(repeats):
                fn()
    except Exception as exc:  # a call the graph cannot hold: the caller falls back
        print(f"  (a CUDA graph could not capture the calls: {exc})", flush=True)
        sync()
        return None
    graph.replay()
    sync()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        sync()
        times.append(start.elapsed_time(end) / repeats)
    del graph
    return statistics.median(times)


def device_ms(fn, repeats: int = REPEATS) -> float:
    """The time of :func:`device_timing` alone."""
    return device_timing(fn, repeats)[0]


def kernel_name(name: str) -> str:
    """A profiler kernel name without namespace, template arguments,
    parameters or return type: ``reduce_level``."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0].strip()
    return name.split()[-1].split("::")[-1] if name else name


def kernel_events(fn, repeats: int = REPEATS) -> list[tuple[str, float]]:
    """Every device kernel of ``repeats`` calls of ``fn()`` after a warm-up,
    in launch order, as (short name, device µs) from the profiler (traced
    again while the trace lost activities, as in :func:`device_ms`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    for _ in range(TRACE_ATTEMPTS):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(repeats):
                    fn()
                sync()
        evts = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                      key=lambda e: e.time_range.start)
        names = [kernel_name(e.name) for e in evts]
        if complete([names.count(n) for n in set(names)], repeats):
            break
        print("  (the profiler lost device activities; tracing again)", flush=True)
    return [(kernel_name(e.name), e.time_range.elapsed_us()) for e in evts]


def launches_a_call(fn) -> list[str]:
    """The device activities (kernels, memsets) of one call of ``fn()``, by
    short name in launch order, from the profiler."""
    events = kernel_events(fn)
    return [name for name, _ in events[:len(events) // REPEATS]]


def build_breakdown(fn, levels: int, repeats: int = REPEATS):
    """Kernel #4's device time by level and kernel: ``fn()`` is one
    ``build_levels`` call of ``levels`` levels.  Each level of the build
    ends with its reduction kernel (``reduce_*``), so the launches are
    assigned to levels in launch order.  Returns (rows, names): rows[l]
    maps a kernel name to (mean µs a call, launches a call) at level l."""
    rows = [{} for _ in range(levels)]
    names: list[str] = []
    level = 0
    for name, us in kernel_events(fn, repeats):
        if name not in names:
            names.append(name)
        t, c = rows[level].get(name, (0.0, 0))
        rows[level][name] = (t + us / repeats, c + 1)
        if name.startswith("reduce"):
            level = (level + 1) % levels
    rows = [{k: (t, c // repeats) for k, (t, c) in r.items()} for r in rows]
    return rows, names


def print_breakdown(rows, names, label: str) -> None:
    """Print :func:`build_breakdown`'s table: µs (launches) per level and
    kernel, each level's sum, and the whole call's."""
    print(f"  {label}: device µs (launches) by level and kernel", flush=True)
    print("    level | " + " | ".join(names) + " | level total", flush=True)
    total = launches = 0
    for l, r in enumerate(rows):
        cells = [f"{r[k][0]:.1f} ({r[k][1]})" if k in r else "-" for k in names]
        t, c = sum(v[0] for v in r.values()), sum(v[1] for v in r.values())
        total, launches = total + t, launches + c
        print(f"    {l} | " + " | ".join(cells) + f" | {t:.1f} ({c})", flush=True)
    print(f"    all levels: {total:.1f} µs in {launches} launches", flush=True)


def wall_ms(fn, repeats: int = REPEATS) -> float:
    """Median host time of ``fn()`` ending in a synchronize, in ms."""
    times = []
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float, peak_ops: float = PEAK_OPS_PER_S):
    """Least time for ``nbytes`` moved and ``ops`` done at ``peak_ops`` per
    second: the larger of the two, and which one it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over entries finite in both (0.0 when identical).
    Walks the leading dimension so a multi-GB mask never widens at once."""
    if a.shape != b.shape:
        return float("inf")
    if same(a, b):
        return 0.0
    worst = 0.0
    rows = a.shape[0] if a.dim() else 1
    for x, y in zip(a.reshape(rows, -1), b.reshape(rows, -1)):
        x64, y64 = x.to(torch.float64), y.to(torch.float64)
        both = torch.isfinite(x64) & torch.isfinite(y64)
        if both.any():
            worst = max(worst, float((x64 - y64).abs()[both].max()))
    return worst


def worst_over_limit(got: torch.Tensor, want: torch.Tensor, rtol: float,
                     row_rms: float, floor: float = 0.0) -> float:
    """Largest ``|got - want| / (rtol |want| + row_rms * RMS of want's row)``
    over every entry; a check passes at 1 or below.  The limit follows the
    output's own scale, row by row: attention rows over many keys are small,
    and a fixed absolute limit would be as large as they are.  A row's RMS
    is taken no smaller than ``floor`` x the RMS of all of ``want``: a
    gradient row can cancel to zero (dq of the first query, whose one key
    has p = 1), while its error follows the scale of its terms.  NaN (an
    empty row, or a non-finite entry) fails."""
    got, want = got.float(), want.float()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    if floor:
        rms = rms.clamp(min=floor * float(want.pow(2).mean().sqrt()))
    ratio = (got - want).abs() / (rtol * want.abs() + row_rms * rms)
    return float(ratio.max()) if ratio.isfinite().all() else float("nan")


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Exact equality of two tensors (uint16 compared through int32)."""
    if a.dtype == torch.uint16:
        a = a.to(torch.int32)
    if b.dtype == torch.uint16:
        b = b.to(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Exact equality, float32 arrays by their bits (so -0.0 != +0.0)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return same(a, b)


def zero_sign_only(a: torch.Tensor, b: torch.Tensor) -> int:
    """Entries where two float32 arrays differ only in the sign of a zero,
    or -1 if they differ anywhere else."""
    if not same(a, b):  # value equality: -0.0 == +0.0
        return -1
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def edge_build_data(kind: str, n: int, seed: int) -> np.ndarray:
    """(n, 4) float32 boxes for kernel #4's edge shapes: ``uniform`` squares,
    ``identical`` boxes (every object in one group at every level: the most
    contended atomics), ``points`` at one location, ``signed`` mixed-sign
    coordinates of which ~30 % are +0.0 or -0.0."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        lo = rng.random((n, 2))
        return np.concatenate([lo, lo + rng.random((n, 2)) * 0.01], axis=1).astype(np.float32)
    if kind == "identical":
        return np.tile(np.array([[0.25, 0.25, 0.5, 0.5]], np.float32), (n, 1))
    if kind == "points":
        return np.tile(np.array([[-3.0, 7.5, -3.0, 7.5]], np.float32), (n, 1))
    lo = rng.uniform(-1.0, 1.0, (n, 2))
    d = np.concatenate([lo, lo + rng.random((n, 2)) * 0.5], axis=1).astype(np.float32)
    pick = rng.random((n, 4))
    d[pick < 0.15] = 0.0
    d[(pick >= 0.15) & (pick < 0.3)] = -0.0
    return d


EDGE_BUILD_N = (1, 2, 5, 6, 24, 25, 26, 3125, 3126, 4097, 100_000)
EDGE_BUILD_KINDS = ("uniform", "identical", "points", "signed")


def edge_builds(ops, dev, seed: int):
    """Kernel #4 against its plain version at every edge shape: n around
    5^l and the shared-memory bound, levels 1, 2, default and 20, every
    data kind.  group_of, parent and n_real must be equal and mbr_cm equal
    by its bits, but for zeros whose sign the plain version leaves to the
    order its atomics land in (ROADMAP C12; counted); a second kernel call
    must give the same bits.  Returns (calls, entries differing only in a
    zero's sign, failures)."""
    from repro_torch.core import bulk

    calls, zero_signs, bad = 0, 0, []
    for kind in EDGE_BUILD_KINDS:
        for n in EDGE_BUILD_N:
            obj = torch.from_numpy(edge_build_data(kind, n, seed + n)).to(dev)
            for levels in sorted({1, 2, bulk.default_levels(n), 20}):
                got = ops.build_levels(obj, levels=levels)
                again = ops.build_levels(obj, levels=levels)
                want = ops.build_levels_torch(obj, levels=levels)
                calls += 1
                where = f"{kind}, n {n}, L {levels}"
                if not all(same_bits(a, b) for a, b in zip(got, again)):
                    bad.append(f"#4 not deterministic at {where}")
                ints = all(same(got[i], want[i]) for i in (0, 2, 3))
                zs = zero_sign_only(got[1], want[1])
                if not ints or zs < 0:
                    bad.append(f"#4 at {where}")
                else:
                    zero_signs += zs
    return calls, zero_signs, bad


EDGE_PAIR_W = (1, 15, 16, 17, 127, 128, 129, 4097)
EDGE_PAIR_K = (1, 3, 11)


def edge_pair_side(k_levels: int, width: int, u16: bool, rng):
    """(K, 4, W) tiles and (K, W) int32 parents of a synthetic schedule:
    boxes that shrink with depth, ~10 % empty slots, random parents."""
    c = rng.random((k_levels, 2, width))
    half = rng.random((k_levels, 2, width)) * (0.5 / 2.0 ** np.arange(k_levels))[:, None, None]
    cm = np.concatenate([c - half, c + half], axis=1).astype(np.float32)
    empty = rng.random((k_levels, width)) < 0.1
    cm[:, :2][np.broadcast_to(empty[:, None], (k_levels, 2, width))] = np.inf
    cm[:, 2:][np.broadcast_to(empty[:, None], (k_levels, 2, width))] = -np.inf
    parent = rng.integers(0, width, (k_levels, width), dtype=np.int32)
    if u16:
        cells = np.clip(np.nan_to_num(cm, posinf=1.0, neginf=0.0) * 65535.0, 0, 65535)
        cm = np.rint(cells).astype(np.int32)
    return cm, parent


def edge_pairs(ops, dev, seed: int):
    """Kernel #6 against its plain version, by equality, at every pair of
    edge widths, K 1, 3 and 11, float32 and uint16 tiles; the symmetric
    sweep at every width.  Returns (calls, failures)."""
    rng = np.random.default_rng(seed)
    calls, bad = 0, []

    def put(cm, parent, u16):
        t = torch.from_numpy(cm).to(dev)
        return (t.to(torch.uint16) if u16 else t), torch.from_numpy(parent).to(dev)

    for k_levels in EDGE_PAIR_K:
        for u16 in (False, True):
            sides = {w: put(*edge_pair_side(k_levels, w, u16, rng), u16) for w in EDGE_PAIR_W}
            for wa in EDGE_PAIR_W:
                for wb in EDGE_PAIR_W:
                    for sym in ((False, True) if wa == wb else (False,)):
                        a = sides[wa]
                        b = a if sym else sides[wb]
                        got = ops.pair_sweep(*a, *b, symmetric=sym)
                        want = ops.pair_sweep_torch(*a, *b, symmetric=sym)
                        calls += 1
                        if not same(got, want):
                            bad.append(f"#6 {'u16' if u16 else 'f32'} K {k_levels}, "
                                       f"{wa} x {wb}{', symmetric' if sym else ''}")
    return calls, bad


EDGE_SCAN_N = (1, 15, 16, 17, 127, 128, 129, 4097, 13_534, 14_237)
EDGE_SCAN_Q = (1, 8, 9, 16, 17, 33, 64, 255, 256, 257)  # tiles 1,024, 512 and 256
EDGE_SCAN_BLOCKS = tuple(range(32, 1025, 32))  # every block_n mbr_scan accepts


def edge_scan_data(n: int, nq: int, rng):
    """(n, 4) MBRs and (nq, 4) queries of kernel #7's edge shapes: small
    boxes in the unit square, every 7th MBR the +inf sentinel the
    reference pads with, every 11th with a NaN coordinate, every 13th with
    subnormal corners; queries sized for a few hits, every 5th the whole
    domain, every 6th a point, every 9th of subnormal extent (ROADMAP C1)
    and the 5th (-inf, -inf, inf, inf), which the sentinels overlap."""
    inf = np.float32(np.inf)
    lo = rng.random((n, 2), dtype=np.float32)
    m = np.concatenate([lo, lo + np.float32(0.05) * rng.random((n, 2), dtype=np.float32)],
                       axis=1)
    m[::7] = [inf, inf, -inf, -inf]
    m[5::11, 1] = np.nan
    m[3::13] = np.array([0.0, 0.0, 1e-45, 1e-45], np.float32)
    c = rng.random((nq, 2), dtype=np.float32)
    q = np.concatenate([c - np.float32(0.03), c + np.float32(0.03)], axis=1)
    q[::5] = [-1.0, -1.0, 2.0, 2.0]
    q[2::6] = np.concatenate([c[2::6], c[2::6]], axis=1)
    q[1::9] = np.array([0.0, -1.0, 0.0, -1e-45], np.float32)
    q[4:5] = [-inf, -inf, inf, inf]
    return m, q


def edge_scans(ops, dev, seed: int):
    """Kernel #7 against its plain version, by equality, at every edge
    width and query count, in both layouts (row-major (N, 4), and
    coordinate-major (4, N) read in place) at every accepted ``block_n``,
    and once on a row-major base 4 bytes off 16-byte alignment.  Returns
    (calls, failures)."""
    rng = np.random.default_rng(seed)
    calls, bad = 0, []
    for n in EDGE_SCAN_N:
        for nq in EDGE_SCAN_Q:
            m_np, q_np = edge_scan_data(n, nq, rng)
            m, q = torch.from_numpy(m_np).to(dev), torch.from_numpy(q_np).to(dev)
            cm = m.T.contiguous()
            buf = torch.empty(4 * n + 1, dtype=torch.float32, device=dev)
            buf[1:] = m.reshape(-1)
            want = ops.mbr_scan_torch(m, q)
            runs = [("row-major, base off alignment", 512, ops.mbr_scan(buf[1:].view(n, 4), q))]
            for bn in EDGE_SCAN_BLOCKS:
                runs.append(("row-major", bn, ops.mbr_scan(m, q, block_n=bn)))
                runs.append(("coordinate-major", bn, ops.mbr_scan_cm(cm, q, block_n=bn)))
            for layout, bn, got in runs:
                calls += 1
                if not same(got, want):
                    bad.append(f"#7 {layout}, N {n}, Q {nq}, block_n {bn}")
    return calls, bad


def tight_n_real(act: torch.Tensor) -> torch.Tensor:
    """(L,) int32: one past each level's last slot that is active for any
    query of the (L, Q, W) mask, 0 where none is: the least ``n_real`` that
    kernel #3 may be given for this mask (it stores zero past ``n_real``
    without computing those slots).  Real slots past it can overlap a query
    and be cut by their parent gate, so this tests the edge of the skip
    where a schedule's padding, which never overlaps, would not."""
    width = act.shape[2]
    idx = torch.arange(1, width + 1, dtype=torch.int32, device=act.device)
    return torch.where(act.any(dim=1), idx, 0).amax(dim=1).to(torch.int32)


EDGE_HIER_LEVELS = (1, 20)


def hier_poisoned(q8, q16, mbr8, mbr16, parent, *, split: int, block_w: int = 128,
                  root_unconditional: bool = True, uncond_from=None, n_real=None):
    """Kernel #3 into an output filled with 0xFF before the launch (on the
    current stream): a mask byte the kernel read before storing it (a
    level's ``prev`` read ahead of the item that stores it) or never stored
    then differs from the plain version, where an output recycled from an
    identical call would hide it."""
    from repro_torch.kernels.pyramid_scan import _level_sweep_hier_into

    act = torch.full((split + mbr16.shape[0], q16.shape[0], mbr16.shape[2]), 0xFF,
                     dtype=torch.uint8, device=mbr16.device)
    _level_sweep_hier_into(act, q8, q16, mbr8, mbr16, parent, split=split, block_w=block_w,
                           root_unconditional=root_unconditional, uncond_from=uncond_from,
                           n_real=n_real)
    return act.view(torch.bool)


def edge_hier_levels(ops, dev, seed: int):
    """Kernel #3 against its plain version, by equality, on device-built
    pyramids of 1 level (split 1: uint8 tiles only) and 20 levels (split
    19), widths 17 and 4,097, Q 1, 9 and 257, ``block_w`` 64, 128 and 512,
    ``root_unconditional`` both ways, both parent types, with ``n_real``
    None, the schedule's and the tight one of the plain mask, each into an
    output filled with 0xFF (:func:`hier_poisoned`).  Returns (calls,
    failures)."""
    from repro_torch.core import datasets
    from repro_torch.kernels.pyramid_scan import _quantize_queries

    calls, bad = 0, []
    for width in (17, 4097):
        d = datasets.uniform_squares(width, seed=seed + width)
        q_all = datasets.region_queries(d, 257, seed=seed).astype(np.float32)
        q_all[::7] = np.concatenate([d[:, :2].min(axis=0) - 1.0, d[:, 2:].max(axis=0) + 1.0])
        q_all = torch.from_numpy(q_all).to(dev)
        for levels in EDGE_HIER_LEVELS:
            s = ops.device_schedule(d, levels=levels, device=dev)
            quant = ops.quantize_schedule(s, upper8=True, split=1 if levels == 1 else None)
            sp = quant.split
            for nq in (1, 9, 257):
                q = q_all[:nq]
                hier = (_quantize_queries(q, quant.origin, quant.inv_cell8, quant.cells8),
                        _quantize_queries(q, quant.origin, quant.inv_cell, quant.cells),
                        quant.mbr_q8, quant.mbr_q[sp:])
                for root in (False, True):
                    want = ops.level_sweep_hier_torch(*hier, quant.parent_q, split=sp,
                                                      root_unconditional=root)
                    n_reals = (("None", None), ("the schedule's", s.n_real),
                               ("tight", tight_n_real(want)))
                    for bw in (64, 128, 512):
                        for parent in (quant.parent_q, quant.parent_q.to(torch.int32)):
                            for label, n_real in n_reals:
                                got = hier_poisoned(*hier, parent, split=sp, block_w=bw,
                                                    root_unconditional=root, n_real=n_real)
                                calls += 1
                                if not same(got, want):
                                    bad.append(f"#3 L {levels}, W {width}, Q {nq}, block_w "
                                               f"{bw}, root {root}, {parent.dtype} parents, "
                                               f"n_real {label}")
    return calls, bad


def hier_streams(ops, hier, parent, split: int, n_real, root: bool):
    """Kernel #3's calls must not see each other's flags: two calls back to
    back on one stream, one on a second stream beside one on the first,
    and a one-query call after them, each into an output filled with 0xFF
    (:func:`hier_poisoned`) and against the plain version.  Returns the
    failures."""
    kw = dict(split=split, root_unconditional=root, n_real=n_real)
    want = ops.level_sweep_hier_torch(*hier, parent, split=split, root_unconditional=root)
    got = [("first of two on one stream", hier_poisoned(*hier, parent, **kw)),
           ("second of two on one stream", hier_poisoned(*hier, parent, **kw))]
    first, second = torch.cuda.current_stream(), torch.cuda.Stream()
    second.wait_stream(first)
    with torch.cuda.stream(second):
        beside = hier_poisoned(*hier, parent, **kw)
    got.append(("on the first stream beside one on a second",
                hier_poisoned(*hier, parent, **kw)))
    first.wait_stream(second)
    got.append(("on a second stream", beside))
    one = (hier[0][:1], hier[1][:1], *hier[2:])
    small = hier_poisoned(*one, parent, **kw)
    sync()
    bad = [what for what, g in got if not same(g, want)]
    if not same(small, ops.level_sweep_hier_torch(*one, parent, split=split,
                                                  root_unconditional=root)):
        bad.append("one query after larger calls")
    return bad


EDGE_QUANT_W = (1, 7, 8, 9, 17, 129, 4097, 13_534, 14_237, 99_999, 100_000)
EDGE_QUANT_L = (1, 2, 11, 20)


def edge_quant_grid(levels: int, width: int, rng):
    """Kernel #5's edge inputs: (L, 4, W) float32 tiles of a synthetic
    schedule, its (L,) int32 ``n_real`` and the same tiles with garbage
    past ``n_real``.  Level 0 is full, level 1 empty, level 2 holds one
    slot, the others a random count (boundaries inside 8-element groups).
    Below ``n_real``: small boxes over [-0.2, 1.2] (past the grid on both
    sides), every 17th coordinate -inf, every 19th 1e30, every 23rd -1e30
    and every 13th slot empty (lo +inf, a live deletion); past it
    ``NEVER_MBR``, or NaN, ±inf and finite garbage in the poisoned copy."""
    inf = np.float32(np.inf)
    c = rng.uniform(-0.2, 1.2, (levels, 2, width))
    half = rng.random((levels, 2, width)) * 0.05
    cm = np.concatenate([c - half, c + half], axis=1).astype(np.float32)
    flat = cm.reshape(-1)
    flat[::17], flat[5::19], flat[7::23] = -inf, 1e30, -1e30
    cm[:, :2, ::13] = inf
    n_real = rng.integers(0, width + 1, levels).astype(np.int32)
    n_real[0] = width
    n_real[1:2] = 0
    n_real[2:3] = min(width, 1)
    pad = np.broadcast_to((np.arange(width)[None, :] >= n_real[:, None])[:, None, :], cm.shape)
    garbage = rng.choice(np.array([np.nan, inf, -inf, 0.5, -3.0, 1e30], np.float32), cm.shape)
    never = np.broadcast_to(np.array([inf, inf, -inf, -inf], np.float32)[None, :, None],
                            cm.shape)
    poisoned = cm.copy()
    cm[pad] = never[pad]
    poisoned[pad] = garbage[pad]
    return cm, n_real, poisoned


def quant_poisoned(mbr_cm, origin, inv_cell, *, fill: int, offset: int, n_real, split,
                   inv_cell8):
    """Kernel #5 into outputs filled with the byte ``fill`` before the
    launch, each ``offset`` elements into a larger buffer (1: off
    alignment, the kernel's element-by-element stores).  An element the
    kernel never stored keeps the fill, so of two calls, with fills 0x00
    and 0xFF, one differs from the plain version.  Returns the outputs as
    ``ops.quantize_cm`` does."""
    from repro_torch.core.flat import CELLS
    from repro_torch.kernels.quantize import _quantize_cm_into

    levels, _, width = mbr_cm.shape
    dev, n = mbr_cm.device, mbr_cm.numel()
    raw16 = torch.full((2 * (n + offset),), fill, dtype=torch.uint8, device=dev)
    out16 = raw16.view(torch.uint16)[offset:offset + n].view(levels, 4, width)
    out8 = None
    if split is not None:
        raw8 = torch.full((split * 4 * width + offset,), fill, dtype=torch.uint8, device=dev)
        out8 = raw8[offset:].view(split, 4, width)
    _quantize_cm_into(out16, out8, mbr_cm, origin, inv_cell, cells=CELLS, n_real=n_real,
                      split=split, inv_cell8=inv_cell8)
    return out16 if split is None else (out16, out8)


def edge_quantize(ops, dev, seed: int):
    """Kernel #5 against its plain version, bit for bit, at L 1, 2, 11 and
    20 × W 1-100,000 (:func:`edge_quant_grid`; the widest grids take the
    kernel's 4-groups-a-thread form, the others its 1-group form): without and with
    ``n_real``, uint16 alone and with the uint8 tiles at splits 0, 1, L/2,
    L - 1 and L, the poisoned tiles (garbage past ``n_real`` must not reach
    the output), an input base 4 bytes off 16-byte alignment (the
    element-by-element loads), and the slices ``[:k]`` and ``[L - k:]``
    with their ``n_real``.  Each case three times: through the wrapper,
    and into outputs filled with 0x00 and with 0xFF, the second off
    alignment (:func:`quant_poisoned`).  Returns (calls, failures)."""
    from repro_torch.core.flat import CELLS, CELLS8

    rng = np.random.default_rng(seed)
    origin = torch.tensor([-0.01, 0.02, -0.01, 0.02], dtype=torch.float32, device=dev)
    inv = torch.full((4,), CELLS / 1.03, dtype=torch.float32, device=dev)
    inv8 = torch.full((4,), CELLS8 / 1.03, dtype=torch.float32, device=dev)
    calls, bad = 0, []
    for levels in EDGE_QUANT_L:
        for width in EDGE_QUANT_W:
            cm_np, nr_np, poisoned_np = edge_quant_grid(levels, width, rng)
            cm, poisoned = (torch.from_numpy(x).to(dev) for x in (cm_np, poisoned_np))
            n_real = torch.from_numpy(nr_np).to(dev)
            buf = torch.empty(cm.numel() + 1, dtype=torch.float32, device=dev)
            buf[1:] = cm.reshape(-1)
            shifted = buf[1:].view(levels, 4, width)
            k = max(1, levels // 2)
            last = levels - 1
            cases = [("dense", cm, cm, None, None), ("n_real", cm, cm, n_real, None)]
            cases += [(f"n_real, split {sp}", cm, cm, n_real, sp)
                      for sp in sorted({0, 1, levels // 2, last, levels})]
            cases += [
                ("dense, split L - 1", cm, cm, None, last),
                ("poisoned padding, n_real, split L - 1", poisoned, cm, n_real, last),
                ("input base off alignment, n_real, split L - 1", shifted, cm, n_real, last),
                (f"levels [:{k}], n_real, split {k}", cm[:k], cm[:k], n_real[:k], k),
                (f"levels [{levels - k}:], n_real", cm[levels - k:], cm[levels - k:],
                 n_real[levels - k:], None),
            ]
            for label, x, clean, nr, sp in cases:
                kw = dict(n_real=nr, split=sp, inv_cell8=None if sp is None else inv8)
                want = ops.quantize_cm_torch(clean, origin, inv, **kw)
                want = want if isinstance(want, tuple) else (want,)
                for how, got in (
                        ("wrapper", ops.quantize_cm(x, origin, inv, **kw)),
                        ("outputs filled 0x00", quant_poisoned(x, origin, inv, fill=0x00,
                                                               offset=0, **kw)),
                        ("outputs filled 0xFF, off alignment",
                         quant_poisoned(x, origin, inv, fill=0xFF, offset=1, **kw))):
                    got = got if isinstance(got, tuple) else (got,)
                    calls += 1
                    if not (len(got) == len(want) and all(map(same, got, want))):
                        bad.append(f"#5 L {levels}, W {width}, {label}, {how}")
    return calls, bad


@contextlib.contextmanager
def plain_quantizer_calls():
    """Counts the calls of the plain quantizer (``quantize_cm_torch``,
    looked up through its module, as ``quantize_schedule`` and
    ``quantize_cm`` call it) made while the block runs: yields a list that
    grows by one a call."""
    from repro_torch.kernels import quantize

    calls = []
    plain = quantize.quantize_cm_torch

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    quantize.quantize_cm_torch = counted
    try:
        yield calls
    finally:
        quantize.quantize_cm_torch = plain


# -- the serving front end ------------------------------------------------

FRONT_PRECISION = {"maps": "compact", "fleet": "float32", "maps8": "compact8"}
FRONT_SWEEP_QPS = (1_000.0, 4_000.0, 16_000.0)


def front_config(fleet_root: str, tenants=("maps", "fleet", "maps8")) -> dict:
    """The front end's declarative config: three pyramid tenants on the
    ``serve`` backend, built on the card (``maps`` compact, ``fleet``
    float32 and durable with a delta buffer of 4,096, ``maps8`` compact8
    through ``backend_opts``); 16-query batches; an interactive class
    (50 ms, shed past 256 pending) and a batch class (2 s, queued)."""
    common = {"structure": "pyramid", "backend": "serve", "build": "device"}
    all_tenants = {
        "maps": dict(common, name="maps", precision="compact"),
        "fleet": dict(common, name="fleet", capacity=4_096, durable_root=fleet_root),
        "maps8": dict(common, name="maps8", backend_opts={"precision": "compact8"}),
    }
    return {
        "query_block": 16,
        "classes": [
            {"name": "interactive", "deadline_ms": 50.0, "overload": "shed", "max_queue": 256},
            {"name": "batch", "deadline_ms": 2000.0, "overload": "queue"},
        ],
        "tenants": [all_tenants[t] for t in tenants],
    }


def report_formula(ix, precision: str, block_w: int = 128) -> float:
    """``bytes_streamed`` of one sweep call on ``ix``'s pyramid schedule,
    from its shapes (repro_torch.obs.counters, ROADMAP C19): every tested
    level's lanes (16 B a slot float32, 8 uint16, 4 uint8) and every gated
    level's parents, once; #3 reads a level's tiles up to ``n_real[l]``
    rounded up to ``block_w``."""
    s = ix.schedule
    levels, width = s.levels, s.width
    first = int(s.root_unconditional)
    if precision == "float32":
        lanes, pbytes, read = [16] * levels, s.parent.element_size(), [width] * levels
    elif precision == "compact":
        q = ix.artifacts.quantized
        lanes, pbytes, read = [8] * levels, q.parent_q.element_size(), [width] * levels
    else:
        q = ix.artifacts.quantized8
        lanes = [4 if l < q.split else 8 for l in range(levels)]
        pbytes = q.parent_q.element_size()
        read = [min(width, -(-int(n) // block_w) * block_w) for n in s.n_real.tolist()]
    return float(sum(read[l] * lanes[l] for l in range(first, levels))
                 + sum(read[l] * pbytes for l in range(1, levels)))


def sweep_call(ix, precision: str, q: torch.Tensor):
    """The sweep kernel call of ``ix``'s ``serve`` rung on queries ``q``
    (#1 for float32 and compact, #3 for compact8), for timing."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.pyramid_scan import _quantize_queries

    s = ix.schedule
    root = s.root_unconditional
    if precision == "float32":
        return lambda: ops.level_sweep(q, s.mbr_cm, s.parent, root_unconditional=root)
    qs = ix.artifacts.quantized if precision == "compact" else ix.artifacts.quantized8
    qq = _quantize_queries(q, qs.origin, qs.inv_cell, qs.cells)
    if precision == "compact":
        return lambda: ops.level_sweep(qq, qs.mbr_q, qs.parent_q, root_unconditional=root)
    qq8 = _quantize_queries(q, qs.origin, qs.inv_cell8, qs.cells8)
    sp = qs.split
    return lambda: ops.level_sweep_hier(qq8, qq, qs.mbr_q8, qs.mbr_q[sp:], qs.parent_q,
                                        split=sp, root_unconditional=root, n_real=s.n_real)


class EventTimed:
    """A tenant index whose ``region`` calls are bracketed by CUDA events:
    the device window of each batch the front end launches."""

    def __init__(self, index):
        self.index = index
        self.windows = []

    def __getattr__(self, name):
        return getattr(self.index, name)

    def region(self, queries):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        res = self.index.region(queries)
        end.record()
        self.windows.append((start, end))
        return res


def front_end_phase(args, checks, dev, card, data, queries, points, paths) -> dict:
    """The serving front end on the card (``repro_torch.serve``): three
    tenants of n objects, then parity with mutations, a healthy run, a
    forced degradation, a restart, launch reports and an open-loop sweep."""
    from repro_torch.checkpoint import live_ids
    from repro_torch.core import datasets
    from repro_torch.ft import FaultPlan
    from repro_torch.kernels import _lib
    from repro_torch.obs import counters
    from repro_torch.serve import ServerConfig, ServingFrontEnd, TenantRuntime
    from repro_torch.serve.loadgen import run_sweep

    res_out = {}
    tenants = tuple(FRONT_PRECISION)
    q16 = queries[:16]
    sync()
    _lib.counters.reset()
    t_phase = time.perf_counter()
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    try:
        cfg = front_config(str(tmp / "fleet"))
        t = time.perf_counter()
        front = ServingFrontEnd.build(cfg, {name: data for name in tenants}, device=dev)
        sync()
        res_out["build_s"] = time.perf_counter() - t
        held_out = {}  # launches of the checks' own calls, not the path's

        def reference(fn, *a, **kw):
            """A call that checks the front end: its launches are taken back
            out of the counts of the path."""
            before = _lib.counters.snapshot()
            try:
                return fn(*a, **kw)
            finally:
                for k, v in _lib.counters.snapshot().items():
                    held_out[k] = held_out.get(k, 0) + v - before.get(k, 0)

        # the tenants' own indexes, called directly on the cuda backend
        direct = {name: reference(front.tenants[name].spatial.with_backend, "cuda",
                                  precision=FRONT_PRECISION[name], **FIXED)
                  for name in tenants}
        print(f"  3 tenants of {args.n:,} objects built on the card in "
              f"{res_out['build_s']:.2f} s (fleet durable, snapshot included)", flush=True)

        # 5 (first, while fleet is pristine: live sweeps report nothing).
        # One batch of each path with the side channel armed.
        reports, timing = {}, {}
        q_card = torch.from_numpy(q16).to(dev)
        for name in ("fleet", "maps", "maps8"):
            rt = front.tenants[name]
            before = rt.stats.to_dict()
            counters.collect_launch_reports(True)
            try:
                tickets = [front.submit(name, "region", q) for q in q16]
                front.pump()
            finally:
                counters.collect_launch_reports(False)
            d = rt.stats.diff(before)
            want = report_formula(rt.spatial, FRONT_PRECISION[name])
            checks.expect(all(r.done for r in tickets) and d["launch_reports"] == 1
                          and d["bytes_streamed"] == want,
                          f"launch report, {name} ({FRONT_PRECISION[name]}): one report, "
                          f"bytes_streamed {d['bytes_streamed']:,.0f} == its formula "
                          f"{want:,.0f}; mask bytes {d['mask_bytes']:,.0f}, tiles "
                          f"{d['tiles_fetched']}")
            reports[name] = d
            sch = rt.spatial.schedule
            timing[name] = (reference(sweep_call, rt.spatial, FRONT_PRECISION[name], q_card),
                            sch.levels * len(q16) * sch.width)

        # 1. parity: mixed requests through the queue, fleet mutated between
        # segments; every answer == the tenant's own index called directly
        rng = np.random.default_rng(args.seed + 31)
        kinds = ("region", "count", "point", "knn")
        asked = {}
        n_mut = 0

        def check_segment(tickets):
            ok = True
            for name in tenants:
                rect = [r for r in tickets if r.tenant == name and r.kind != "knn"]
                if rect:
                    r = reference(direct[name].region, np.stack([x.payload for x in rect]))
                    counts = r.hits.sum(dim=1).tolist()
                    for i, req in enumerate(rect):
                        if req.kind == "count":
                            ok &= req.result == counts[i]
                        else:
                            ok &= same(req.result.hits, r.hits[i]) and same(
                                req.result.visits, r.visits_per_level[i])
                nn = [r for r in tickets if r.tenant == name and r.kind == "knn"]
                if nn:
                    r = reference(direct[name].knn, np.stack([x.payload for x in nn]), 10)
                    for i, req in enumerate(nn):
                        ok &= same(req.result[0], r.ids[i]) and same(req.result[1], r.dists[i])
            return ok

        n_checked = 0
        for seg in range(3):
            tickets = []
            for i in range(48):
                name = tenants[i % 3]
                kind = kinds[(i // 3) % 4]
                qi = int(rng.integers(0, len(queries)))
                payload = points[qi] if kind in ("point", "knn") else queries[qi]
                tickets.append(front.submit(name, kind, payload,
                                            k=10 if kind == "knn" else None,
                                            slo="batch" if i % 7 == 6 else None))
                front.pump()
            front.drain()
            ok = all(r.done for r in tickets) and check_segment(tickets)
            n_checked += len(tickets)
            checks.expect(ok, f"parity, segment {seg}: {len(tickets)} region, count, point "
                              f"and k-NN (k 10) answers == each tenant's index called "
                              f"directly (cuda backend); counts == hits.sum()")
            for r in tickets:
                if r.tenant == "maps" and r.kind == "region":
                    asked.setdefault(r.payload.tobytes(), r)
            del tickets
            fleet = front.tenants["fleet"].index
            front.insert("fleet", datasets.uniform_squares(50, seed=args.seed + 40 + seg))
            front.delete("fleet", live_ids(fleet)[:100])
            n_mut += 2
        # maps's cached answers survive fleet's mutations
        server = front.tenants["maps"].spatial._backend.server
        hits_before = server.stats.cache_hits
        old = next(iter(asked.values()))
        again = front.submit("maps", "region", old.payload)
        front.drain()
        checks.expect(front.tenants["fleet"].epoch > 0 and front.tenants["maps"].epoch == 0
                      and server.stats.cache_hits == hits_before + 1
                      and same(again.result.hits, old.result.hits)
                      and same(again.result.visits, old.result.visits),
                      f"isolation: fleet at epoch {front.tenants['fleet'].epoch}, maps at 0; "
                      f"a repeated maps query answered from its cache, unchanged")

        # host service time of a batch >= its device window (CUDA events)
        timed = EventTimed(front.tenants["maps"].index)
        front.tenants["maps"].index = timed
        spans = []
        for b in range(4):
            batch = [front.submit("maps", "region", q) for q in queries[16 * b:16 * b + 16]]
            front.pump()
            spans.append((max(r.t_complete for r in batch) - batch[0].t_launch) * 1e3)
        front.tenants["maps"].index = timed.index
        device = [s.elapsed_time(e) for s, e in timed.windows]
        checks.expect(len(device) == 4 and all(h >= d for h, d in zip(spans, device)),
                      "a batch's host service time >= its CUDA-event device window: "
                      + ", ".join(f"{h:.3f} >= {d:.3f} ms" for h, d in zip(spans, device)))
        res_out["batch_host_ms"], res_out["batch_device_ms"] = spans, device

        # 2. the healthy run: the cuda rung only
        rungs = {name: dict(front.stats(name).rung_dispatches) for name in tenants}
        checks.expect(all(set(r) == {"cuda"} for r in rungs.values())
                      and all(front.stats(name).launch_failures == 0 for name in tenants),
                      f"healthy run: every batch on the cuda rung, no failure ({rungs})")

        # 3. forced degradation mid-run: the cuda rung fails from its third
        # attempt on (two batches of 16 on cuda, then every tenant degrades)
        plan = FaultPlan(fail_launches=10 ** 9, fail_from_launch=2, fail_rungs=("cuda",))
        tickets = []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            for i in range(192):
                if i == 12:
                    front.bind_fault_plan(plan)
                name = tenants[i % 3]
                kind = ("region", "count", "point")[(i // 3) % 3]
                qi = int(rng.integers(0, len(queries)))
                payload = points[qi] if kind == "point" else queries[qi]
                tickets.append(front.submit(name, kind, payload))
                front.pump()
            front.drain()
        front.bind_fault_plan(None)
        deg = {name: (front.stats(name).degraded_batches,
                      dict(front.stats(name).rung_dispatches)) for name in tenants}
        checks.expect(all(r.done for r in tickets) and check_segment(tickets)
                      and plan.launch_failures > 0
                      and all(d > 0 and r.get("torch", 0) > 0 for d, r in deg.values()),
                      f"forced degradation (FaultPlan fail_from_launch=2, cuda): all "
                      f"{len(tickets)} answers == the direct call; {plan.launch_failures} "
                      f"injected failures; degraded batches and rungs {deg}")
        del tickets

        # 4. restart: a new front end over fleet's durable root recovers it
        rects = queries[:64]
        pre = reference(direct["fleet"].region, rects)
        front.tenants["fleet"].index.close()
        t = time.perf_counter()
        front2 = ServingFrontEnd.build(front_config(str(tmp / "fleet"), ("fleet",)), {},
                                       device=dev)
        sync()
        res_out["recover_s"] = time.perf_counter() - t
        rec = front2.tenants["fleet"].index
        tickets = [front2.submit("fleet", "region", q) for q in rects]
        front2.drain()
        checks.expect(rec.ops_total == n_mut and rec.index.backend == "serve"
                      and all(same(r.result.hits, pre.hits[i])
                              and same(r.result.visits, pre.visits_per_level[i])
                              for i, r in enumerate(tickets)),
                      f"restart: fleet recovered in {res_out['recover_s']:.2f} s "
                      f"({rec.ops_total} durable ops, {rec.recovered_ops} replayed); 64 "
                      f"answers through its queue == the "
                      f"pre-restart ones")
        rec.close()
        del tickets, pre, front2, rec

        # 6. the open-loop sweep on maps: fresh telemetry, queues and LRU a level
        maps = front.tenants["maps"].spatial
        sweep_cfg = ServerConfig.from_dict(front_config(str(tmp / "fleet"), ("maps",)))

        def make_front():
            ix = maps.with_backend("serve", precision="compact", query_block=16)
            return ServingFrontEnd(sweep_cfg, {"maps": TenantRuntime(sweep_cfg.tenants[0],
                                                                     ix)}), "maps"

        rows = run_sweep(make_front, FRONT_SWEEP_QPS, duration=2.0, seed=args.seed)
        for row in rows:
            print(f"  sweep qps_offered {row['qps_offered']:.1f} qps_achieved "
                  f"{row['qps_achieved']:.1f} p50 {row['p50_ms']:.3f} ms p99 "
                  f"{row['p99_ms']:.3f} ms p99.9 {row['p999_ms']:.3f} ms shed {row['shed']} "
                  f"slo_violations {row['slo_violations']} avg_batch {row['avg_batch']} "
                  f"queue_wait_p99 {row['queue_wait_p99_ms']:.3f} ms  [{card}]", flush=True)
        checks.expect(len(rows) == len(FRONT_SWEEP_QPS) and all(
            r["completed"] > 0 and r["completed"] + r["shed"] == r["submitted"]
            for r in rows), "open-loop sweep: every level served, completed + shed == "
                            "submitted")
        res_out["sweep"] = rows
        # one full batch through a front end, for the profile phase: each
        # call takes the next 16 queries, so every batch misses the LRU
        prof_ix = maps.with_backend("serve", precision="compact", query_block=16)
        prof_front = ServingFrontEnd(sweep_cfg, {"maps": TenantRuntime(sweep_cfg.tenants[0],
                                                                       prof_ix)})
        calls = itertools.count()

        def one_batch(qs):
            at = 16 * next(calls) % (len(qs) - 15)
            tickets = [prof_front.submit("maps", "region", q) for q in qs[at:at + 16]]
            prof_front.pump()
            return tickets

        res_out["batch"] = one_batch
        del front, direct, maps

        sync()
        paths["serving front end"] = {
            k: v - held_out.get(k, 0) for k, v in _lib.counters.snapshot().items()
            if v > held_out.get(k, 0)}
        checked = {k: v for k, v in held_out.items() if v}
        print(f"  launches {paths['serving front end']} (the checks' direct calls, "
              f"{checked}, not included)", flush=True)
        for name in ("build_levels", "quantize_cm", "level_sweep_f32", "level_sweep_u16",
                     "level_sweep_hier"):
            n = paths["serving front end"].get(name, 0)
            checks.expect(n > 0, f"{name} launched on the serving front end path ({n})")
    finally:
        counters.collect_launch_reports(False)
        tmp_dir.cleanup()

    # 5, continued: each report's bytes (and the mask the sweep writes) over
    # the device time of its sweep on the same queries, after the path's
    # counts were read
    limit = PEAK_BYTES_PER_S * 1.05
    for name, (fn, written) in timing.items():
        ms = device_ms(fn)
        streamed = reports[name]["bytes_streamed"]
        rate = (streamed + written) / (ms * 1e-3)
        reports[name].update(sweep_ms=ms, written=written, rate=rate)
        checks.expect(rate <= limit,
                      f"launch report, {name}: ({streamed:,.0f} streamed + {written:,} mask "
                      f"bytes written) / {ms:.4f} ms device time = {rate / 1e12:.3f} TB/s <= "
                      f"3.35 TB/s x 1.05 (streamed alone {streamed / (ms * 1e-3) / 1e12:.3f} "
                      f"TB/s)  [{card}]")
    del timing
    res_out["reports"] = reports
    res_out["phase_s"] = time.perf_counter() - t_phase
    print(f"  the phase took {res_out['phase_s']:.1f} s", flush=True)
    return res_out


# -- LLM serving: llama3.2-1B at full width through the port's models -------

LLM_ARCH = "llama32_1b"
LLM_SERVE = dict(batch=4, prompt_len=32, gen=32)
LLM_DEC_B = 4            # batch of the long-context decode step
LLM_CHECK_PROMPT = 256   # tokens of the prefill-vs-streamed-decode check
LLM_SPARSE_GATE = 0.05   # |sparse - dense| logits with top-K = nb (the reference's gate)
LLM_PREFILL_GATE = 0.25  # |prefill - streamed decode| logits (the reference's bf16 gate)
PR16_BUILD_MS = 152.93   # 32 unbatched index builds of one decode step (PERF.md §5, PR 16)


@contextlib.contextmanager
def plain_attention_calls():
    """Counts the calls of the plain versions of #8-#10 and of the backward
    kernels of #8 and #10 (looked up through their modules, as their
    wrappers call them) made while the block runs: yields a dict name ->
    calls."""
    from repro_torch.kernels import flash_attention, mqr_sparse_attention, rmsnorm

    calls: dict[str, int] = {}
    saved = []
    for mod, name in ((rmsnorm, "rmsnorm_torch"), (flash_attention, "flash_attention_torch"),
                      (mqr_sparse_attention, "mqr_sparse_attention_torch"),
                      (flash_attention, "flash_attention_lse_torch"),
                      (flash_attention, "flash_attention_bwd_torch"),
                      (rmsnorm, "rmsnorm_bwd_torch")):
        plain = getattr(mod, name)

        def counted(*args, _plain=plain, _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _plain(*args, **kwargs)

        setattr(mod, name, counted)
        saved.append((mod, name, plain))
    try:
        yield calls
    finally:
        for mod, name, plain in saved:
            setattr(mod, name, plain)


@contextlib.contextmanager
def recorded_selection(attn):
    """Records the inputs and ids of every ``attention.sparse_block_ids``
    call made while the block runs (one a layer of a sparse step)."""
    seen = []
    select = attn.sparse_block_ids

    def recording(params, cfg, q, k_cache, pos):
        ids = select(params, cfg, q, k_cache, pos)
        seen.append(dict(probe=params["probe"], q=q, k=k_cache, pos=pos, ids=ids))
        return ids

    attn.sparse_block_ids = recording
    try:
        yield seen
    finally:
        attn.sparse_block_ids = select


def llm_phase(args, checks, dev, card, paths) -> dict:
    """llama3.2-1B at full width on the card through the port's models: the
    serving loop dense and sparse, a long-context decode step, prefill.
    Launch counts of each run land in ``paths``."""
    from repro_torch.configs import registry
    from repro_torch.core import bulk, kvindex
    from repro_torch.kernels import _lib, ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import count_params, tree_cast

    res: dict = {}
    t_phase = time.perf_counter()
    cfg = registry.get_config(LLM_ARCH)
    n_layers, heads, hkv, dh = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    group = heads // hkv
    norms_a_step = 2 * n_layers + 1
    t = time.perf_counter()
    params = T.init_params(args.seed, cfg, device=dev)
    sync()
    res.update(init_s=time.perf_counter() - t, param_count=cfg.param_count(),
               param_elements=count_params(params), param_bytes=T.param_bytes(params))
    print(f"  {LLM_ARCH} at full width: {n_layers} layers, d_model {cfg.d_model}, {heads} "
          f"heads ({hkv} kv, head dim {dh}), d_ff {cfg.d_ff}, vocab {cfg.vocab_size:,} (padded "
          f"{cfg.padded_vocab:,}), {cfg.dtype}, random from seed {args.seed}: param_count() "
          f"{res['param_count']:,}; {res['param_elements']:,} elements, "
          f"{res['param_bytes']:,} bytes on the card; init {res['init_s']:.2f} s  [{card}]",
          flush=True)

    def in_mode(fn):
        with torch.inference_mode():
            return fn()

    # -- serve(): the prompt streamed through decode steps, then greedy ----
    b, plen, gen = LLM_SERVE["batch"], LLM_SERVE["prompt_len"], LLM_SERVE["gen"]
    steps_run = plen + gen - 1
    serve_mod.serve(arch=LLM_ARCH, smoke=False, batch=b, prompt_len=4, gen=2, seed=args.seed,
                    params=params, device=dev)  # warm-up: cuBLAS handles, first launches
    for sparse in (False, True):
        label = "sparse" if sparse else "dense"
        with plain_attention_calls() as plain:
            sync()
            _lib.counters.reset()
            t = time.perf_counter()
            out = serve_mod.serve(arch=LLM_ARCH, smoke=False, mqr_sparse=sparse, seed=args.seed,
                                  params=params, device=dev, **LLM_SERVE)
            wall = time.perf_counter() - t
            sync()
            counts = paths[f"llm serve {label}"] = _lib.counters.snapshot()
        res[f"serve_{label}_tok_s"] = b * (plen + gen) / wall
        res[f"serve_{label}_s"] = wall
        print(f"  serve {label}: B {b}, prompt {plen}, gen {gen}: {steps_run} steps in "
              f"{wall:.3f} s, {res[f'serve_{label}_tok_s']:.1f} tok/s (host clock, the tokens "
              f"read once at the end); launches {counts}  [{card}]", flush=True)
        checks.expect(out.shape == (b, gen) and bool((out >= 0).all())
                      and bool((out < cfg.vocab_size).all()),
                      f"serve {label}: tokens ({b}, {gen}) in [0, {cfg.vocab_size})")
        checks.expect(counts.get("rmsnorm_bf16", 0) == norms_a_step * steps_run,
                      f"serve {label}: #10 ran {norms_a_step} times a step "
                      f"({counts.get('rmsnorm_bf16', 0)} = {norms_a_step} x {steps_run})")
        want9 = n_layers * steps_run if sparse else 0
        checks.expect(counts.get("mqr_sparse_attention_bf16", 0) == want9
                      and counts.get("mqr_sparse_attention", 0) == want9,
                      f"serve {label}: #9 ran {n_layers if sparse else 0} times a step "
                      f"({counts.get('mqr_sparse_attention_bf16', 0)})")
        checks.expect(not plain, f"serve {label}: no plain version of #8-#10 called ({plain})")

    # -- one decode step over a long cache, dense and sparse ---------------
    s_len, bd = args.kv_len, LLM_DEC_B
    pos = s_len - 37
    nb = s_len // cfg.mqr_block
    topk = min(cfg.mqr_topk, nb)
    caches = T.init_caches(cfg, bd, s_len, device=dev)
    gen_ = torch.Generator(device=dev).manual_seed(args.seed + 7)
    for layer in caches["all"]:
        for name in ("k", "v"):
            layer["l0"][name].normal_(generator=gen_)
    tok = torch.randint(0, cfg.vocab_size, (bd, 1), generator=gen_, device=dev)

    def step(sparse, c=None, model=cfg):
        return in_mode(lambda: T.decode_step(params, model, tok, c or caches, pos,
                                             mqr_sparse=sparse)[0])

    for sparse in (False, True):
        label = "sparse" if sparse else "dense"
        with plain_attention_calls() as plain:
            sync()
            _lib.counters.reset()
            logits = step(sparse)
            sync()
            counts = paths[f"llm decode step {label}"] = _lib.counters.snapshot()
        res[f"{label}_logits"] = logits
        checks.expect(tuple(logits.shape) == (bd, 1, cfg.padded_vocab)
                      and bool(logits.float().isfinite().all()),
                      f"decode step {label} at {s_len:,} tokens: finite ({bd}, 1, "
                      f"{cfg.padded_vocab}) logits")
        checks.expect(counts.get("rmsnorm_bf16", 0) == norms_a_step
                      and counts.get("mqr_sparse_attention_bf16", 0) == (n_layers if sparse
                                                                         else 0)
                      and not plain,
                      f"decode step {label}: #10 x {counts.get('rmsnorm_bf16', 0)}, #9 x "
                      f"{counts.get('mqr_sparse_attention_bf16', 0)}, no plain version")
        res[f"{label}_step_ms"] = wall_ms(lambda: step(sparse))
    k0 = caches["all"][0]["l0"]["k"]
    probe_rows = params["blocks"][0]["l0"]["mixer"]["probe"].expand(bd, hkv, dh).reshape(-1, dh)
    res["build_ms"] = wall_ms(lambda: kvindex.build_kv_index(
        k0.reshape(bd * hkv, s_len, dh), probe_rows, cfg.mqr_block, cfg.mqr_levels))
    print(f"  decode step, B {bd}, {s_len:,}-token caches in all {n_layers} layers, pos {pos} "
          f"(median of {REPEATS}, host clock to a synchronize): dense {res['dense_step_ms']:.2f} "
          f"ms, sparse ({topk} of {nb} blocks) {res['sparse_step_ms']:.2f} ms; the batched "
          f"index build of one layer ({bd * hkv} indexes in one pass) {res['build_ms']:.3f} ms, "
          f"beside PR 16's {PR16_BUILD_MS} ms for {bd * hkv} unbatched builds  [{card}]",
          flush=True)
    # the dry run of both steps against one more of each on the card (a
    # tensor pos and int32 tokens, as the dry run's inputs)
    dry_args = (params, tok.to(torch.int32), caches,
                torch.tensor(pos, dtype=torch.int32, device=dev))
    res["dryrun"] = [checks.phase(f"  dry run vs the card: decode {label}", functools.partial(
        dryrun_check, checks, f"{LLM_ARCH} decode B {bd} over {s_len:,} tokens, {label}", cfg,
        "decode_32k", dry_args, res[f"{label}_step_ms"], card, batch=bd, seq=s_len,
        tag=label)) for label in ("dense", "sparse")]

    # the model's ids == select_blocks on each (b, kv head)'s single-row index
    with recorded_selection(attn) as seen:
        step(True)
    sync()
    checks.expect(len(seen) == n_layers, f"sparse step: {len(seen)} batched selections, one "
                                         f"a layer")
    rec = seen[0]
    ids = rec["ids"]
    ok, survivors = True, []
    for bi in range(bd):
        for g in range(hkv):
            single = kvindex.build_kv_index(rec["k"][bi, g], rec["probe"][g], cfg.mqr_block,
                                            cfg.mqr_levels)
            regions = torch.stack([kvindex.query_region(rec["q"][bi, 0, h], rec["probe"][g],
                                                        pos + 1)
                                   for h in range(g * group, (g + 1) * group)])
            want = kvindex.select_blocks(single, regions, topk)
            rows = slice(bi * heads + g * group, bi * heads + (g + 1) * group)
            ok &= same(ids[rows], want)
            survivors += bulk.pyramid_search(single.pyramid, regions).sum(-1).tolist()
    checks.expect(ok, f"the model's ids ({tuple(ids.shape)}, layer 0) == select_blocks on the "
                      f"single-row index of each of the {bd * hkv} (batch, kv head) rows")
    res["survivors_mean"] = sum(survivors) / len(survivors)
    kb = rec["k"].view(bd * hkv, nb, cfg.mqr_block, dh)
    vb = caches["all"][0]["l0"]["v"].view(bd * hkv, nb, cfg.mqr_block, dh)
    qd = rec["q"].reshape(bd * heads, dh).to(kb.dtype)
    got = ops.mqr_sparse_attention(qd, kb, vb, ids, pos, group=group)
    plain = ops.mqr_sparse_attention_torch(qd, kb, vb, ids, pos, group=group)
    worst = worst_over_limit(got, plain, 2e-2, 3e-2)
    checks.expect(worst <= 1.0, f"#9 with group {group} within 2e-2 |plain| + 3e-2 x the row's "
                                f"RMS of its plain version (worst error / limit {worst:.3g})")
    res["g4"] = dict(q=qd, kb=kb, vb=vb, ids=ids, pos=pos, group=group)

    # top-K = nb: the sparse step attends every block and equals dense.  In
    # bfloat16 the roundings of 16 layers alone move the largest of the
    # B x 128,256 logits by a few ulps (printed), so the gate holds a float32
    # copy of the model and caches, where #9 and the dense path differ only
    # in the order of their sums.
    all_cfg = dataclasses.replace(cfg, mqr_topk=nb)
    res["all_blocks_vs_dense_bf16"] = float(
        (step(True, model=all_cfg).float() - res["dense_logits"].float()).abs().max())
    p32 = tree_cast(params, torch.float32)
    c32 = {"all": [{"l0": {n: layer["l0"][n].float() for n in ("k", "v")}}
                   for layer in caches["all"]]}
    cfg32 = dataclasses.replace(cfg, dtype="float32", mqr_topk=nb)
    dense32, sparse32 = (in_mode(lambda s=s: T.decode_step(p32, cfg32, tok, c32, pos,
                                                           mqr_sparse=s)[0])
                         for s in (False, True))
    diff = float((sparse32 - dense32).abs().max())
    res["all_blocks_vs_dense"] = diff
    checks.expect(diff < LLM_SPARSE_GATE,
                  f"sparse step with top-K = nb = {nb}, float32 copy of the model: max |logits "
                  f"- dense| {diff:.2e} < {LLM_SPARSE_GATE} (bfloat16: "
                  f"{res['all_blocks_vs_dense_bf16']:.4f})")
    del p32, c32, dense32, sparse32
    # the incremental index (in the cache) runs and launches #9
    inc_cfg = dataclasses.replace(cfg, mqr_incremental=True)
    inc = T.init_caches(inc_cfg, bd, s_len, device=dev)
    for layer, src in zip(inc["all"], caches["all"]):
        layer["l0"]["k"], layer["l0"]["v"] = src["l0"]["k"], src["l0"]["v"]
    sync()
    _lib.counters.reset()
    inc_logits = step(True, c=inc, model=inc_cfg)
    sync()
    counts = paths["llm decode step incremental"] = _lib.counters.snapshot()
    checks.expect(counts.get("mqr_sparse_attention_bf16", 0) == n_layers
                  and bool(inc_logits.float().isfinite().all()),
                  f"incremental sparse step: finite logits, #9 x "
                  f"{counts.get('mqr_sparse_attention_bf16', 0)}")
    res["incremental_step_ms"] = wall_ms(lambda: step(True, c=inc, model=inc_cfg))
    del inc, inc_logits

    # -- prefill ------------------------------------------------------------
    toks = torch.randint(0, cfg.vocab_size, (1, args.prefill), generator=gen_, device=dev)
    with plain_attention_calls() as plain:
        sync()
        _lib.counters.reset()
        last = in_mode(lambda: T.prefill(params, cfg, {"tokens": toks}))
        sync()
        counts = paths["llm prefill"] = _lib.counters.snapshot()
    checks.expect(counts.get("flash_attention_bf16", 0) == n_layers and not plain
                  and tuple(last.shape) == (1, 1, cfg.padded_vocab)
                  and bool(last.float().isfinite().all()),
                  f"prefill of {args.prefill:,} tokens: finite last-token logits, #8 x "
                  f"{counts.get('flash_attention_bf16', 0)} (one a layer), no plain version")
    res["prefill_ms"] = wall_ms(lambda: in_mode(
        lambda: T.prefill(params, cfg, {"tokens": toks})), 3)
    res["dryrun"].append(checks.phase("  dry run vs the card: prefill", functools.partial(
        dryrun_check, checks, f"{LLM_ARCH} prefill (1, {args.prefill:,})", cfg, "prefill_32k",
        (params, {"tokens": toks.to(torch.int32)}), res["prefill_ms"], card, batch=1,
        seq=args.prefill)))
    # prefill's last logits == the same prompt streamed through decode steps
    short = toks[:, :LLM_CHECK_PROMPT]
    c = T.init_caches(cfg, 1, LLM_CHECK_PROMPT, device=dev)
    for i in range(LLM_CHECK_PROMPT):
        lg = in_mode(lambda: T.decode_step(params, cfg, short[:, i:i + 1], c, i)[0])
    pre = in_mode(lambda: T.prefill(params, cfg, {"tokens": short}))
    diff = float((pre.float() - lg.float()).abs().max())
    res["prefill_vs_decode"] = diff
    checks.expect(diff < LLM_PREFILL_GATE,
                  f"prefill of {LLM_CHECK_PROMPT} tokens vs the prompt streamed through decode "
                  f"steps: max |logits diff| {diff:.4f} < {LLM_PREFILL_GATE}")
    print(f"  prefill B 1 x {args.prefill:,} tokens: {res['prefill_ms']:.2f} ms (median of 3, "
          f"host clock to a synchronize); incremental sparse step "
          f"{res['incremental_step_ms']:.2f} ms; {res['survivors_mean']:.1f} of {nb} blocks "
          f"survive the region search on average; sparse (top-K = nb) vs dense "
          f"{res['all_blocks_vs_dense']:.2e} (float32), {res['all_blocks_vs_dense_bf16']:.4f} "
          f"(bfloat16); prefill vs decode {diff:.4f}  [{card}]",
          flush=True)
    res["mesh"] = checks.phase("  mesh and shard router", lambda: mesh_router_check(
        checks, params, dev, card, args.seed))
    res["sharded"] = checks.phase("  sharded step: llama3.2-1B dense decode on a 1x1 NCCL mesh",
                                  lambda: sharded_decode_check(checks, cfg, params, tok, caches,
                                                               pos, dev, card, paths))
    res["steps"] = {"dense": lambda _: step(False), "sparse": lambda _: step(True)}
    res["caches"] = caches
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"  the phase took {res['phase_s']:.1f} s", flush=True)
    return res


# -- LLM families: the MoE, MLA, Mamba-2 and RG-LRU configs at full width ----

# model, its cut (depth only; widths as published), serve() settings or None,
# decode steps at --kv-len (mqr-KV over a cache) or not, the depth of the
# float32 copy that holds prefill against streamed decode where the cut
# model in float32 would not fit beside what earlier phases hold, and, for
# the families whose steps run sharded on the card's 1x1 mesh
# (``sharded_family_check``), ``sharded``: the depth cut of their sharded
# training, where they train (``train``)
FAMILIES = (
    dict(arch="granite_moe_1b", cut={}, serve=dict(batch=4, prompt_len=32, gen=32),
         long_steps=True, sharded=dict(train={})),
    # 61 layers of bfloat16 (1.34 TB with MTP) do not fit one card: the 3
    # dense layers and the first MoE layer; serving never applies MTP
    dict(arch="deepseek_v3_671b", cut=dict(n_layers=4, mtp_depth=0), serve=None,
         long_steps=True, check_cut=dict(n_layers=1, n_dense_layers=1), sharded={}),
    # trains 16 of its 64 layers: two copies of the state beside the
    # 64-layer model the phase holds
    dict(arch="mamba2_2p7b", cut={}, serve=dict(batch=4, prompt_len=32, gen=32),
         long_steps=False, sharded=dict(train=dict(n_layers=16))),
    dict(arch="recurrentgemma_9b", cut={}, serve=dict(batch=2, prompt_len=32, gen=32),
         long_steps=False, sharded={}),
    # the attention families of the other head dims and groups (#8 and #9 at
    # group 8 / head dim 256, group 2, 4 and 8 at 128, group 1 at 64)
    dict(arch="gemma_2b", cut={}, serve=dict(batch=4, prompt_len=16, gen=16), long_steps=True),
    dict(arch="granite_8b", cut={}, serve=dict(batch=4, prompt_len=16, gen=16),
         long_steps=True),
    dict(arch="internvl2_2b", cut={}, serve=dict(batch=4, prompt_len=16, gen=16),
         long_steps=True, sharded={}),
    # 48 layers of 32 kv heads: 32,768-token caches are 1.07 GB a layer at
    # B 4 (51.5 GB); its steps at B 2
    dict(arch="musicgen_large", cut={}, serve=dict(batch=4, prompt_len=16, gen=16),
         long_steps=True, dec_b=2, sharded={}),
    # 40 layers of bfloat16 (~61 GB with the embedding) and their
    # 32,768-token caches (21 GB) do not fit one card beside what earlier
    # phases hold (~30 GiB): 12 of 40 layers (21.1 GB, caches 6.4 GB; 16
    # peaked at 74.3 GiB of the card's 79.6); its float32 copy 2 layers
    # (14 GB)
    dict(arch="command_r_35b", cut=dict(n_layers=12), serve=dict(batch=4, prompt_len=16, gen=16),
         long_steps=True, check_cut=dict(n_layers=2)),
)
FAMILY_DEC_B = 4            # batch of the long-context decode steps
FAMILY_CHECK_PROMPT = 128   # tokens of the prefill-vs-streamed-decode check
FAMILY_PREFILL_GATE = 1e-2  # |prefill - streamed decode| last logits, float32 copy
MOE_GATE = (2e-2, 2e-2)     # bf16: |a - b| <= atol + rtol |b| (the reference's parity gate)


def fill_state(caches, gen_, pos: int):
    """``caches`` (``init_caches``' tree) as a decode step at ``pos`` finds
    them: every floating tensor drawn from ``gen_`` (kv rings, latents,
    recurrent states), and each local ring's slot positions those of the
    last W tokens before ``pos`` (wrapped once ``pos`` passes W); in
    place, returns ``caches``."""
    from repro_torch.sharding import rules

    for path, t in rules.leaves_with_path(caches):
        if t.is_floating_point():
            t.normal_(generator=gen_)
        elif path.endswith("/pos"):
            w = t.shape[0]
            seen = torch.arange(pos - w, pos, device=t.device)
            t.index_copy_(0, seen % w, seen.clamp(min=-1).to(t.dtype))
    return caches


def busy_share(fn) -> tuple[float, float, list]:
    """One traced call of ``fn()`` after a warm-up: (host window ms, device
    busy ms, the device's kernels as (ms, count, name), largest first); the
    idle share is 1 - busy / window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    fn()
    sync()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        sync()
        window = (time.perf_counter() - t) * 1e3
    rows = []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", None) or getattr(
                evt, "self_cuda_time_total", 0)
            if us > 0:
                rows.append((us / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    return window, sum(r[0] for r in rows), rows


def free_card():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def norms_a_step(cfg) -> int:
    """RMSNorms of one token step (kernel #10's launches): two a layer and
    the final one, plus MLA's q_norm and kv_norm and Mamba-2's gated norm."""
    kinds = list(cfg.block_pattern) * cfg.n_superblocks + list(cfg.tail_pattern)
    return 2 * len(kinds) + 1 + sum(2 if k == "mla" else 1 if k == "mamba2" else 0
                                    for k in kinds)


def family_widths(cfg) -> tuple[int, ...]:
    """The row widths #10 takes on a family's path."""
    widths = {cfg.d_model}
    kinds = set(cfg.block_pattern + cfg.tail_pattern)
    if "mla" in kinds:
        widths |= {cfg.q_lora_rank, cfg.kv_lora_rank}
    if "mamba2" in kinds:
        widths.add(cfg.ssm_expand * cfg.d_model)
    return tuple(sorted(widths))


def token_shape(cfg, b: int, s: int) -> tuple[int, ...]:
    """Token ids of ``b`` sequences of ``s`` steps (codebooks last for audio)."""
    return (b, s, cfg.n_codebooks) if cfg.frontend == "audio_codebooks" else (b, s)


def logits_shape(cfg, b: int) -> tuple[int, ...]:
    """Last-token logits of ``b`` sequences (one head a codebook for audio)."""
    if cfg.frontend == "audio_codebooks":
        return (b, 1, cfg.n_codebooks, cfg.padded_vocab)
    return (b, 1, cfg.padded_vocab)


def prefill_batch(cfg, toks, gen_, patches: int | None = None) -> dict:
    """A prefill batch of the token ids ``toks``: a vision model's stub
    frontend takes ``patches`` patch embeddings drawn from ``gen_`` (its
    published count by default) in front of them, in the token budget."""
    if cfg.frontend != "vision_patches":
        return {"tokens": toks}
    n = cfg.n_patches if patches is None else patches
    vis = torch.randn((toks.shape[0], n, cfg.d_model), generator=gen_, device=toks.device)
    return {"tokens": toks[:, n:], "vision_embeds": vis.to(toks.device)}


def families_phase(args, checks, dev, card, paths, sparse_inputs=None) -> dict:
    """granite-moe-1b, DeepSeek-V3 (cut to 4 layers), mamba2-2.7b,
    recurrentgemma-9b, gemma-2b, granite-8b, internvl2-2b, musicgen-large
    and command-r-35b (cut to 12 layers) at full width on the card through
    the port's models, one model at a time: serve(), prefill, decode
    steps, the MoE and #10 checks,
    prefill against streamed decode on a float32 copy.  Launch counts land
    in ``paths`` under ``llm <arch> ...``; ``sparse_inputs``, where given,
    receives each attention family's #9 inputs of one sparse step's first
    layer (q, k and v blocks read in place, ids, pos, group)."""
    from repro_torch.configs import registry
    from repro_torch.kernels import _lib, ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import attention as attn
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import count_params, rmsnorm_init

    res: dict = {}
    t_phase = time.perf_counter()

    def in_mode(fn):
        with torch.inference_mode():
            return fn()

    def counted(label, fn):
        """Run ``fn`` with the counters at 0 and plain calls counted; the
        counts land in ``paths``."""
        with plain_attention_calls() as plain:
            sync()
            _lib.counters.reset()
            t = time.perf_counter()
            out = fn()
            sync()
            wall = time.perf_counter() - t
            counts = paths[label] = _lib.counters.snapshot()
        return out, counts, dict(plain), wall

    def expect_counts(label, counts, plain, want):
        got = {k: counts.get(k, 0) for k in want}
        checks.expect(got == want and not plain,
                      f"{label}: launches {got} == {want}, no plain version ({plain})")

    for fam in FAMILIES:
        arch = fam["arch"]
        r = res[arch] = {}
        cfg = dataclasses.replace(registry.get_config(arch), **fam["cut"])
        moe_ffn = cfg.ffn_kind == "moe"
        n_attn = sum(k == "attn" for k in cfg.block_pattern) * cfg.n_superblocks
        norms = norms_a_step(cfg)
        cut = (f"cut: {fam['cut']} ({cfg.n_layers} of {registry.get_config(arch).n_layers} "
               f"layers)" if fam["cut"] else "not cut")
        free_card()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        params = T.init_params(args.seed, cfg, device=dev)
        sync()
        r.update(init_s=time.perf_counter() - t, param_count=cfg.param_count(),
                 param_bytes=T.param_bytes(params))
        print(f"  {arch} at full width, {cut}: {cfg.n_layers} layers {cfg.block_pattern}, "
              f"d_model {cfg.d_model}, ffn {cfg.ffn_kind}, vocab {cfg.vocab_size:,}, "
              f"{cfg.dtype}, random from seed {args.seed}: param_count() "
              f"{r['param_count']:,} ({count_params(params):,} elements), "
              f"{r['param_bytes']:,} bytes on the card; init {r['init_s']:.2f} s  [{card}]",
              flush=True)

        # -- serve(): the prompt streamed through decode steps, then greedy
        if fam["serve"]:
            sv = fam["serve"]
            b, steps_run = sv["batch"], sv["prompt_len"] + sv["gen"] - 1
            serve_mod.serve(arch=arch, smoke=False, batch=b, prompt_len=4, gen=2,
                            seed=args.seed, params=params, device=dev, cfg=cfg)  # warm-up
            for sparse in (False, True) if n_attn else (False,):
                label = "sparse" if sparse else "dense"
                out, counts, plain, wall = counted(f"llm {arch} serve {label}", lambda: (
                    serve_mod.serve(arch=arch, smoke=False, mqr_sparse=sparse,
                                    seed=args.seed, params=params, device=dev, cfg=cfg,
                                    **sv)))
                r[f"serve_{label}_tok_s"] = b * (sv["prompt_len"] + sv["gen"]) / wall
                print(f"  {arch} serve {label}: B {b}, prompt {sv['prompt_len']}, gen "
                      f"{sv['gen']}: {steps_run} steps in {wall:.3f} s, "
                      f"{r[f'serve_{label}_tok_s']:.1f} tok/s (host clock)  [{card}]",
                      flush=True)
                want_shape = token_shape(cfg, b, sv["gen"])
                checks.expect(out.shape == want_shape and bool((out >= 0).all())
                              and bool((out < cfg.vocab_size).all()),
                              f"{arch} serve {label}: tokens {want_shape} in the vocab")
                expect_counts(f"{arch} serve {label}", counts, plain, {
                    "rmsnorm_bf16": norms * steps_run, "flash_attention_bf16": 0,
                    "mqr_sparse_attention_bf16": n_attn * steps_run if sparse else 0})

        # -- prefill (1, --prefill) -----------------------------------------
        gen_ = torch.Generator(device=dev).manual_seed(args.seed + 11)
        toks = torch.randint(0, cfg.vocab_size, token_shape(cfg, 1, args.prefill),
                             generator=gen_, device=dev)
        batch = prefill_batch(cfg, toks, gen_)
        last, counts, plain, _ = counted(f"llm {arch} prefill", lambda: in_mode(
            lambda: T.prefill(params, cfg, batch)))
        checks.expect(tuple(last.shape) == logits_shape(cfg, 1)
                      and bool(last.float().isfinite().all()),
                      f"{arch} prefill of {args.prefill:,} tokens: finite last-token logits")
        expect_counts(f"{arch} prefill", counts, plain, {
            "rmsnorm_bf16": norms, "flash_attention_bf16": n_attn,
            "mqr_sparse_attention_bf16": 0})
        r["prefill_ms"] = wall_ms(lambda: in_mode(lambda: T.prefill(params, cfg, batch)), 3)
        print(f"  {arch} prefill (1, {args.prefill:,}): {r['prefill_ms']:.2f} ms (median of "
              f"3, host clock to a synchronize)  [{card}]", flush=True)
        del last, batch

        # -- decode steps: over --kv-len caches (attention, MLA), or at the
        # serving batch from fresh recurrent state
        if fam["long_steps"]:
            bd, s_len = fam.get("dec_b", FAMILY_DEC_B), args.kv_len
            pos = s_len - 37
        else:
            bd, s_len, pos = fam["serve"]["batch"], 128, 0
        caches = T.init_caches(cfg, bd, s_len, device=dev)
        if fam["long_steps"]:
            fill_state(caches, gen_, pos)
        tok = torch.randint(0, cfg.vocab_size, token_shape(cfg, bd, 1), generator=gen_,
                            device=dev)

        def step(sparse):
            return in_mode(lambda: T.decode_step(params, cfg, tok, caches, pos,
                                                 mqr_sparse=sparse)[0])

        for sparse in (False, True) if fam["long_steps"] else (False,):
            label = "sparse" if sparse else "dense"
            logits, counts, plain, _ = counted(f"llm {arch} decode step {label}",
                                               lambda: step(sparse))
            checks.expect(tuple(logits.shape) == logits_shape(cfg, bd)
                          and bool(logits.float().isfinite().all()),
                          f"{arch} decode step {label} (B {bd}, {s_len:,}-token caches): "
                          f"finite logits")
            expect_counts(f"{arch} decode step {label}", counts, plain, {
                "rmsnorm_bf16": norms, "flash_attention_bf16": 0,
                "mqr_sparse_attention_bf16": n_attn if sparse else 0})
            r[f"{label}_step_ms"] = wall_ms(lambda: step(sparse))
        if sparse_inputs is not None and fam["long_steps"] and n_attn:
            # #9's inputs in the first layer of one more sparse step, for the
            # kernel phase (the cache's k and v of that layer, read in place)
            with recorded_selection(attn) as seen:
                step(True)
            rec, hkv, dh = seen[0], cfg.n_kv_heads, cfg.head_dim_
            nb = s_len // cfg.mqr_block
            v0 = caches["all"][0]["l0"]["v"]
            sparse_inputs[arch] = dict(
                q=rec["q"].reshape(bd * cfg.n_heads, dh).to(v0.dtype),
                kb=rec["k"].view(bd * hkv, nb, cfg.mqr_block, dh),
                vb=v0.view(bd * hkv, nb, cfg.mqr_block, dh), ids=rec["ids"], pos=pos,
                group=cfg.n_heads // hkv)
            del seen, rec
        r["dense_window_ms"], r["dense_busy_ms"], _ = busy_share(lambda: step(False))
        r["idle_share"] = max(0.0, 1 - r["dense_busy_ms"] / r["dense_window_ms"])
        print(f"  {arch} decode step, B {bd}, {s_len:,}-token caches, pos {pos} (median of "
              f"{REPEATS}, host clock to a synchronize): dense {r['dense_step_ms']:.2f} ms"
              + (f", sparse {r['sparse_step_ms']:.2f} ms" if "sparse_step_ms" in r else "")
              + f"; one dense step traced: window {r['dense_window_ms']:.3f} ms, device busy "
              f"{r['dense_busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}  [{card}]",
              flush=True)
        del caches

        # -- the MoE FFN on the card: dispatches, loads, prefill vs decode
        if moe_ffn:
            layer = params["blocks"][0]["l0"]["ffn"]
            x = ops.rmsnorm(torch.randn((1, FAMILY_CHECK_PROMPT * 8, cfg.d_model), device=dev,
                                        generator=gen_).to(torch.bfloat16),
                            rmsnorm_init(cfg.d_model, dev))
            ys, loads = {}, {}
            for dispatch in ("einsum", "scatter"):
                mc = dataclasses.replace(cfg, moe_dispatch=dispatch)
                ys[dispatch], aux = in_mode(lambda: moe.moe_ffn(layer, mc, x))
                loads[dispatch] = aux["expert_load"]
            err = float(((ys["einsum"].float() - ys["scatter"].float()).abs()
                         - MOE_GATE[1] * ys["scatter"].float().abs()).max())
            s_tok = x.shape[1]
            top_idx, _ = moe.route(layer, cfg, x)
            cap = moe.capacity_of(cfg, s_tok, cfg.moe_capacity_factor)
            kept = int(moe.queue_slots(top_idx, cfg.n_experts, cap)[1].sum())
            load_sum = float(loads["einsum"].sum())
            checks.expect(err <= MOE_GATE[0] and same(loads["einsum"], loads["scatter"]),
                          f"{arch} MoE layer on {s_tok:,} tokens: einsum vs scatter dispatch "
                          f"|a - b| - {MOE_GATE[1]} |b| = {err:.2e} <= {MOE_GATE[0]}; loads "
                          f"equal")
            checks.expect(abs(load_sum - kept / s_tok) < 1e-4 and load_sum <= cfg.experts_per_tok,
                          f"{arch} MoE expert load sums to the kept top-k fraction: "
                          f"{load_sum:.5f} = {kept} kept choices / {s_tok} tokens "
                          f"(<= k = {cfg.experts_per_tok}; capacity {cap})")
            free = dataclasses.replace(cfg, moe_capacity_factor=cfg.n_experts
                                       / cfg.experts_per_tok)  # capacity = S: drop-free
            xs = x[:, :FAMILY_CHECK_PROMPT]
            y_all, aux = in_mode(lambda: moe.moe_ffn(layer, free, xs))
            y_tok = torch.cat([in_mode(lambda i=i: moe.moe_ffn(layer, free, xs[:, i:i + 1])[0])
                               for i in range(xs.shape[1])], dim=1)
            err_pd = float(((y_all.float() - y_tok.float()).abs()
                            - MOE_GATE[1] * y_tok.float().abs()).max())
            free_sum = float(aux["expert_load"].sum())
            checks.expect(err_pd <= MOE_GATE[0]
                          and abs(free_sum - cfg.experts_per_tok) < 1e-4,
                          f"{arch} MoE layer, drop-free: {xs.shape[1]} tokens at once vs one "
                          f"at a time (decode) |a - b| - {MOE_GATE[1]} |b| = {err_pd:.2e} <= "
                          f"{MOE_GATE[0]}; load sums to k: {free_sum:.5f}")
            r.update(moe_dispatch_err=err, moe_load_sum=load_sum, moe_prefill_vs_decode=err_pd)
            del layer, x, ys, xs, y_all, y_tok

        # -- #10 at every width of the family's path --------------------------
        for d in family_widths(cfg):
            xr = torch.randn((args.prefill, d), device=dev, generator=gen_).to(torch.bfloat16)
            w = 1 + 0.1 * torch.randn((d,), device=dev, generator=gen_)
            worst = worst_over_limit(ops.rmsnorm(xr, w), ops.rmsnorm_torch(xr, w), 2e-2, 3e-2)
            checks.expect(worst <= 1.0, f"{arch}: #10 on ({args.prefill}, {d}) bf16 within "
                                        f"2e-2 |plain| + 3e-2 x the row's RMS (worst error / "
                                        f"limit {worst:.3g})")
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

        # -- the family's steps sharded on a 1x1 NCCL mesh ---------------------
        if "sharded" in fam and T.runs_sharded(cfg):
            r["sharded"] = checks.phase(
                f"  sharded step: {arch} on a 1x1 NCCL mesh",
                lambda: sharded_family_check(checks, arch, cfg, params, dev, card, paths, args,
                                             fam))

        # -- prefill vs the prompt streamed through decode steps, float32 ----
        check_cfg = dataclasses.replace(cfg, dtype="float32")
        if moe_ffn:
            check_cfg = dataclasses.replace(check_cfg, moe_capacity_factor=cfg.n_experts
                                            / cfg.experts_per_tok)
        # float32 weights drawn anew from the seed once the bfloat16 ones are
        # freed (a copy beside them would not fit for recurrentgemma-9b);
        # DeepSeek's 4 layers are 60 GB in float32: its first layer alone
        # (MLA and a dense FFN), with the MoE layer checked above
        del params
        free_card()
        check_cfg = dataclasses.replace(check_cfg, **fam.get("check_cut", {}))
        p32 = T.init_params(args.seed, check_cfg, device=dev)
        short = toks[:, :FAMILY_CHECK_PROMPT]
        c = T.init_caches(check_cfg, 1, FAMILY_CHECK_PROMPT, device=dev)
        for i in range(FAMILY_CHECK_PROMPT):
            lg = in_mode(lambda: T.decode_step(p32, check_cfg, short[:, i:i + 1], c, i)[0])
        # a vision model's prompt without patches: decode steps take tokens only
        pre, *_ = counted(f"llm {arch} float32 prefill", lambda: in_mode(lambda: T.prefill(
            p32, check_cfg, prefill_batch(check_cfg, short, gen_, patches=0))))
        diff = float((pre - lg).abs().max())
        r["prefill_vs_decode_f32"] = diff
        checks.expect(diff < FAMILY_PREFILL_GATE,
                      f"{arch} float32 copy ({check_cfg.n_layers} layers"
                      f"{', drop-free capacity' if moe_ffn else ''}): prefill of "
                      f"{FAMILY_CHECK_PROMPT} tokens vs the prompt streamed through decode "
                      f"steps, max |logits diff| {diff:.2e} < {FAMILY_PREFILL_GATE}")
        del c
        if arch == "deepseek_v3_671b":
            # MLA sparse decode with top-K = nb against dense, float32
            nb = args.kv_len // cfg.mqr_block
            all_cfg = dataclasses.replace(check_cfg, mqr_topk=nb)
            c32 = T.init_caches(all_cfg, FAMILY_DEC_B, args.kv_len, device=dev)
            for stack in c32.values():
                for layer_c in stack:
                    for t_ in layer_c["l0"].values():
                        t_.normal_(generator=gen_)
            pos = args.kv_len - 37
            dense32, sparse32 = (in_mode(lambda s=s: T.decode_step(
                p32, all_cfg, tok, c32, pos, mqr_sparse=s)[0]) for s in (False, True))
            diff = float((sparse32 - dense32).abs().max())
            r["mla_all_blocks_vs_dense_f32"] = diff
            checks.expect(diff < LLM_SPARSE_GATE,
                          f"{arch} float32 copy (1 layer), {args.kv_len:,}-token latent cache: "
                          f"MLA sparse decode with top-K = nb = {nb} vs dense, max |logits "
                          f"diff| {diff:.2e} < {LLM_SPARSE_GATE}")
            del c32, dense32, sparse32
        del p32
        free_card()
        r["peak_gib"] = max(r["peak_gib"], torch.cuda.max_memory_allocated() / 2 ** 30)
        print(f"  {arch}: peak device memory {r['peak_gib']:.2f} GiB (the phase's own "
              f"tensors and what earlier phases hold); prefill vs streamed decode (float32) "
              f"{r['prefill_vs_decode_f32']:.2e}  [{card}]", flush=True)
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"  the phase took {res['phase_s']:.1f} s", flush=True)
    return res


TRAIN_STEPS = 10      # steps of the full-width run
TRAIN_SAVE_AT = 5     # the checkpoint the resume starts from
TRAIN_LR = 1e-3       # launch/train.py's default
TRAIN_RESUME_RTOL = 1e-5
PARITY_LAYERS, PARITY_S = 2, 256  # the float32 card-vs-CPU step


def train_step_counts(cfg) -> dict:
    """Launches of #8 and #10, forward and backward, in one bf16 train step
    under remat="full": the forward runs each superblock twice (once, then
    again in the backward), the final norm once; #8 in each ``attn``
    layer, #10 in each layer's norms (:func:`norms_a_step`: Mamba-2's
    gated norm too)."""
    kinds = list(cfg.block_pattern) * cfg.n_superblocks + list(cfg.tail_pattern)
    attn = sum(k == "attn" for k in kinds)
    norms = norms_a_step(cfg) - 1  # the layers' norms, the final one apart
    return {"flash_attention_bf16": 2 * attn, "flash_attention_bwd_bf16": attn,
            "rmsnorm_bf16": 2 * norms + 1, "rmsnorm_bwd_bf16": norms + 1}


# kernel-name fragments of a train step's device time, by part (the rest
# is elementwise, reductions and copies)
TRAIN_PARTS = (("#8 backward", ("bwd_dq", "bwd_dkdv")), ("#8 forward", ("flash_bf16", "flash_f32")),
               ("#10 backward", ("rmsnorm_bwd",)), ("#10 forward", ("rmsnorm",)),
               ("matrix products", ("gemm", "xmma", "cutlass", "nvjet")))


def profile_train_step(fn) -> dict:
    """One traced train step ``fn()`` (:func:`busy_share`): the host window,
    the device's busy time and idle share, the device time of each part of
    ``TRAIN_PARTS`` and the rest, and the ten largest kernels."""
    window, busy, rows = busy_share(fn)
    parts = {name: 0.0 for name, _ in TRAIN_PARTS}
    parts["elementwise, reductions, copies"] = 0.0
    for ms, _, key in rows:
        part = next((name for name, frags in TRAIN_PARTS if any(f in key for f in frags)),
                    "elementwise, reductions, copies")
        parts[part] += ms
    print(f"  one traced train step: host window {window:.3f} ms, device busy {busy:.3f} ms, "
          f"idle share {max(0.0, 1 - busy / window):.3f}; "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items()), flush=True)
    for ms, count, key in rows[:10]:
        print(f"    {ms:9.3f} ms  x{count:<4d} {key[:90]}", flush=True)
    return dict(window_ms=window, busy_ms=busy, parts_ms=parts)


def train_launches(paths) -> dict:
    """Launch counts summed over the training phase's runs (``train ...``
    paths): the ``launches`` of the backward kernels' rows."""
    out: dict = {}
    for path, counts in paths.items():
        if path.startswith("train "):
            for k, n in counts.items():
                out[k] = out.get(k, 0) + n
    return out


def run_train_steps(checks, paths, step, params, state, batches, want, label, before=None):
    """One call of ``step`` a batch, each timed between syncs with the
    launch counts reset before it and stored in ``paths`` as ``<label> step
    <i>``; each step's loss must be finite and its launches ``want``, and no
    plain version of #8 or #10 may run.  ``before(i, params, state,
    losses)`` runs ahead of step i, untimed.  Returns the parameters, the state, the last metrics,
    the losses and the step times in ms."""
    from repro_torch.kernels import _lib

    losses, times, metrics = [], [], None
    with plain_attention_calls() as plain:
        for i, batch in enumerate(batches):
            if before is not None:
                before(i, params, state, losses)
            sync()
            _lib.counters.reset()
            t = time.perf_counter()
            params, state, metrics = step(params, state, batch)
            loss = float(metrics["loss"])
            sync()
            times.append((time.perf_counter() - t) * 1e3)
            counts = paths[f"{label} step {i}"] = _lib.counters.snapshot()
            losses.append(loss)
            got = {k: counts.get(k, 0) for k in want}
            checks.expect(got == want and math.isfinite(loss),
                          f"{label} step {i}: {times[-1]:.1f} ms, loss {loss:.6f} finite, grad "
                          f"norm {float(metrics['grad_norm']):.4f}, lr {float(metrics['lr']):.3e}; "
                          f"launches {got} (expected {want})")
    checks.expect(not plain, f"no plain version of #8 or #10 called in {label} ({plain})")
    return params, state, metrics, losses, times


# -- the dry run against the card, the mesh and the shard router -------------

DRYRUN_PEAK_RTOL = 0.10  # the dry run's peak within 10 % of the card's
ROUTER_SHARDS, ROUTER_HOSTS = 4096, 64


def dryrun_check(checks, label, cfg, shape, card_args, measured_ms, card, *, batch, seq,
                 tag="") -> dict:
    """One cell of ``launch.dryrun`` against the card: the step of
    ``dryrun.step_fn`` runs once on ``meta`` tensors (the prediction) and
    once more, untimed, on ``card_args`` on the card, each under ``OpCost``.
    Counted FLOPs and bytes must be equal, and the predicted peak within
    ``DRYRUN_PEAK_RTOL`` of ``torch.cuda.max_memory_allocated()`` over the
    card's step (both count the step's arguments and what it allocates;
    what else the card holds is taken off the card's).  Prints model FLOPs,
    counted FLOPs, the roofline bound, the phase's measured step
    ``measured_ms``, ``mfu`` (model FLOPs over 989 TFLOP/s x the measured
    step) and ``roofline_mfu`` (over the bound)."""
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun, roofline

    t = time.perf_counter()
    kind = registry.SHAPES[shape]["kind"]
    fn = dryrun.step_fn(cfg, shape, tag)
    pred, _ = dryrun.run_step(fn, dryrun.cell_args(cfg, shape, batch, seq), kind)
    sync()
    torch.cuda.reset_peak_memory_stats()
    args_bytes = sum(dryrun.storage_set(card_args).values())
    other = torch.cuda.memory_allocated() - args_bytes
    got, out = dryrun.run_step(fn, card_args, kind)
    sync()
    peak = torch.cuda.max_memory_allocated() - other
    del out
    model_flops = dryrun.model_flops(cfg, kind, batch, seq)
    a = roofline.analyze({
        "n_devices": 1, "model_flops": model_flops,
        "cost": {"flops_per_device": pred.flops, "bytes_accessed_per_device": pred.bytes},
        "collectives": {"total_wire_bytes": 0},
        "memory": {"peak_bytes_per_device": pred.peak_bytes}})
    bound_ms = max(a["t_compute_s"], a["t_memory_s"]) * 1e3
    mfu = model_flops / (roofline.PEAK_FLOPS * measured_ms / 1e3)
    rel = abs(pred.peak_bytes - peak) / peak
    row = dict(label=label, model_flops=model_flops, flops=got.flops, bytes=got.bytes,
               predicted_flops=pred.flops, predicted_bytes=pred.bytes,
               predicted_peak_gib=pred.peak_bytes / 2**30, peak_gib=peak / 2**30,
               arguments_gib=args_bytes / 2**30, args_predicted_gib=pred.live_bytes / 2**30,
               peak_rel=rel, bound_ms=bound_ms, bound=a["bound"], measured_ms=measured_ms,
               mfu=mfu, roofline_mfu=a["roofline_mfu"], kernels=got.kernels,
               peak_by_op=[[k, v / 2**30] for k, v in pred.peak_by_op.most_common(6)])
    same_count = got.flops == pred.flops and got.bytes == pred.bytes
    if not same_count:
        want = dict(pred.by_op(10_000)["bytes"])
        have = dict(got.by_op(10_000)["bytes"])
        diff = {k: have.get(k, 0) - want.get(k, 0) for k in set(want) | set(have)
                if have.get(k, 0) != want.get(k, 0)}
        print(f"    counted bytes by op, card - meta: {sorted(diff.items())[:12]}", flush=True)
    checks.expect(same_count, f"dry run {label}: counted FLOPs {got.flops:,} and bytes "
                              f"{got.bytes:,} on the card == the meta prediction "
                              f"({pred.flops:,}, {pred.bytes:,})")
    checks.expect(rel <= DRYRUN_PEAK_RTOL,
                  f"dry run {label}: predicted peak {pred.peak_bytes / 2**30:.3f} GiB within "
                  f"{DRYRUN_PEAK_RTOL:.0%} of the card's {peak / 2**30:.3f} GiB (rel {rel:.2e}; "
                  f"arguments {args_bytes / 2**30:.3f} GiB, predicted "
                  f"{pred.live_bytes / 2**30:.3f})")
    row["seconds"] = time.perf_counter() - t
    print(f"    {label}: model FLOPs {model_flops:.4e}, counted {got.flops:.4e}, bytes "
          f"{got.bytes:.4e}; roofline bound {bound_ms:.3f} ms ({a['bound']}); measured "
          f"step {measured_ms:.3f} ms; mfu {mfu:.4f}, roofline_mfu {a['roofline_mfu']:.4f}; "
          f"peak by what made it (GiB): "
          + ", ".join(f"{k} {v:.3f}" for k, v in row["peak_by_op"])
          + f"; {row['seconds']:.1f} s  [{card}]", flush=True)
    return row


def mesh_router_check(checks, params, dev, card, seed: int) -> dict:
    """``make_host_mesh()`` on a world-size-1 NCCL group; every parameter of
    ``params`` distributed with its ``param_shardings`` placements, each
    local shard bit-equal to the full tensor; ``reshard_plan`` onto the
    same mesh is the identity; the group destroyed.  Then ``route_shards``
    of ``ROUTER_SHARDS`` ``uniform_squares`` MBRs to ``ROUTER_HOSTS`` hosts:
    every shard routed once, each host's mean bounding-box area under half
    the global one (host ms printed)."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.core import datasets
    from repro_torch.core import mbr as M
    from repro_torch.data import route_shards
    from repro_torch.ft import reshard_plan
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import rules

    res: dict = {}
    t = time.perf_counter()
    mesh = make_host_mesh(dev)
    try:
        backend = dist.get_backend()
        placements = rules.leaves_with_path(rules.param_shardings(params, mesh))
        equal, sharded = True, 0
        for (path, p), (_, pl) in zip(rules.leaves_with_path(params), placements):
            local = distribute_tensor(p.detach(), mesh, pl).to_local()
            equal &= local.shape == p.shape and torch.equal(local, p)
            sharded += any(x.is_shard() for x in pl)
            del local
        pairs = rules.leaves_with_path(reshard_plan(params, mesh, mesh))
        identity = all(old == new for _, (old, new) in pairs)
    finally:
        dist.destroy_process_group()
    res["mesh_s"] = time.perf_counter() - t
    checks.expect(backend == "nccl" and equal and identity,
                  f"make_host_mesh(): a 1x1 {backend} DeviceMesh; {len(placements)} llama3.2-1B "
                  f"parameters distributed ({sharded} with a Shard placement), each local shard "
                  f"bit-equal to the full tensor; reshard_plan onto the same mesh is the "
                  f"identity; group destroyed ({res['mesh_s']:.1f} s)")
    mbrs = datasets.uniform_squares(ROUTER_SHARDS, seed=seed)
    t = time.perf_counter()
    routed = route_shards(mbrs, ROUTER_HOSTS)
    res["router_ms"] = (time.perf_counter() - t) * 1e3
    got = sorted(i for ids in routed.values() for i in ids)
    areas = [M.area(M.merge_many(mbrs[ids])) for ids in routed.values() if ids]
    share = float(np.mean(areas) / M.area(M.merge_many(mbrs)))
    res["router_area_share"] = share
    checks.expect(got == list(range(ROUTER_SHARDS)) and share < 0.5,
                  f"route_shards: {ROUTER_SHARDS:,} shard MBRs to {ROUTER_HOSTS} hosts, each "
                  f"routed once; a host's mean bounding-box area {share:.4f} of the global "
                  f"(< 0.5); {res['router_ms']:.1f} ms on the host")
    return res


SHARDED_RTOL = 1e-5  # the fall-back limit of the sharded step (the resume limit)


def _tree_copy(tree):
    from repro_torch.models.modules import tree_map

    return tree_map(lambda t: t.detach().clone(), tree)


def _worst_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| / |b| (0 where a equals b bit for bit)."""
    if torch.equal(a, b):
        return 0.0
    a, b = a.float(), b.float()
    return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())


def sharded_step_check(checks, cfg, opt_cfg, params, state, batch, want, dev, card,
                       paths, n_steps: int = 2, label: str = "train") -> dict:
    """The train step sharded on a 1x1 NCCL ``DeviceMesh``
    (``make_host_mesh()``): copies of ``params`` and ``state`` placed as
    DTensors by ``launch.steps.place`` (``DTensor.from_local``: the mesh
    holds each whole tensor, no second copy), ``batch`` likewise.
    ``n_steps`` sharded steps against as many unsharded steps of ``params``,
    ``state`` from the same state: the losses and every updated parameter
    equal bit for bit, or within ``SHARDED_RTOL`` with the differing leaves
    printed; #8, 8b, #10 and 10b launched ``want`` times a sharded step
    (through ``local_map``) and no plain version.  One more sharded step
    runs under ``OpCost``: no collective may run on the 1x1 mesh, and its
    counted FLOPs and kernel reports must equal those of one more
    unsharded step under ``OpCost`` (the mode counts the local operators
    DTensor runs, not DTensor's own).  Each step is timed (host clock
    between syncs; the steps after the first, the median of them) and its
    ``max_memory_allocated`` read; the difference of the times is
    DTensor's host cost.  Launch counts land in ``paths`` as ``<label>
    sharded step <i>``.  The group is destroyed."""
    import torch.distributed as dist

    from repro_torch.kernels import _lib
    from repro_torch.launch import steps as step_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.models.modules import tree_leaves
    from repro_torch.optim import AdamWState
    from repro_torch.sharding import rules

    res: dict = {}
    t_all = time.perf_counter()
    mesh = make_host_mesh(dev)
    try:
        step = step_lib.make_train_step(cfg, opt_cfg)
        p2 = _tree_copy(params)
        s2 = AdamWState(state.step.clone(), _tree_copy(state.m), _tree_copy(state.v))
        dp = step_lib.place(p2, rules.param_shardings(p2, mesh), mesh)
        ds = step_lib.place_opt_state(s2, p2, mesh)
        db = step_lib.place(batch, rules.batch_shardings(batch, mesh), mesh)
        no_copy = all(d.to_local().data_ptr() == t.data_ptr()
                      for d, t in zip(tree_leaves(dp), tree_leaves(p2)))
        del p2, s2
        losses, ms, worst, differ = [], {"sharded": [], "unsharded": []}, 0.0, set()
        peak = {"sharded": 0.0, "unsharded": 0.0}
        for i in range(n_steps):
            sync()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            params, state, m = step(params, state, batch)
            loss = float(m["loss"])
            sync()
            ms["unsharded"].append((time.perf_counter() - t) * 1e3)
            peak["unsharded"] = max(peak["unsharded"], torch.cuda.max_memory_allocated() / 2**30)
            with plain_attention_calls() as plain:
                sync()
                torch.cuda.reset_peak_memory_stats()
                _lib.counters.reset()
                t = time.perf_counter()
                dp, ds, dm = step(dp, ds, db)
                d_loss = float(dm["loss"].to_local())
                sync()
                ms["sharded"].append((time.perf_counter() - t) * 1e3)
                counts = paths[f"{label} sharded step {i}"] = _lib.counters.snapshot()
            peak["sharded"] = max(peak["sharded"], torch.cuda.max_memory_allocated() / 2**30)
            got = {k: counts.get(k, 0) for k in want}
            checks.expect(got == want and not plain,
                          f"{label}: sharded train step {i}: #8, 8b, #10, 10b launches {got} "
                          f"through local_map (expected {want}), no plain version ({plain})")
            losses.append((loss, d_loss))
            for (path, a), b in zip(rules.leaves_with_path(dp), tree_leaves(params)):
                a = a.to_local()
                if not torch.equal(a, b):
                    differ.add(path)
                    worst = max(worst, _worst_rel(a, b))
            worst = max(worst, abs(d_loss - loss) / abs(loss))
        bits = all(a == b for a, b in losses) and not differ
        checks.expect(bits or worst <= SHARDED_RTOL,
                      f"{label}: sharded train steps == unsharded from the same state: losses "
                      f"{losses}, {'bit for bit' if bits else 'not bit for bit'}; "
                      f"{len(differ)} of {len(tree_leaves(params))} parameters differ "
                      f"({sorted(differ)[:6]}), worst relative difference {worst:.3g} "
                      f"(limit {SHARDED_RTOL:g} where not bit for bit); parameters placed "
                      f"with no copy: {no_copy}")
        with OpCost(live=(dp, ds, db)) as cost:
            dp, ds, dm = step(dp, ds, db)
        with OpCost(live=(params, state, batch)) as base:
            params, state, m = step(params, state, batch)
        sync()
        checks.expect(cost.flops == base.flops and cost.kernels == base.kernels,
                      f"OpCost under DTensor (torch {torch.__version__}) counts what the device "
                      f"runs: the sharded step's counted FLOPs {cost.flops:,} and kernel "
                      f"reports == the unsharded step's ({base.flops:,}); bytes {cost.bytes:,} "
                      f"vs {base.bytes:,}")
        coll = {k: v for k, v in cost.collectives.items() if isinstance(v, dict) and v["count"]}
        checks.expect(not coll, f"{label}: no collective on the 1x1 mesh under OpCost ({coll})")
        warm = {k: statistics.median(v[1:]) if len(v) > 1 else v[0] for k, v in ms.items()}
        res.update(sharded_ms=warm["sharded"], unsharded_ms=warm["unsharded"],
                   sharded_ms_all=ms["sharded"], unsharded_ms_all=ms["unsharded"],
                   first_sharded_ms=ms["sharded"][0], bits=bits, worst_rel=worst,
                   differ=sorted(differ), collectives=cost.collectives, launches=got,
                   flops=cost.flops, bytes=cost.bytes, unsharded_bytes=base.bytes,
                   no_copy=no_copy, peak_gib=peak)
        print(f"    {label}: sharded train step, 1x1 NCCL mesh, B {batch['tokens'].shape[0]} x S "
              f"{batch['tokens'].shape[1]}: {warm['sharded']:.1f} ms (steps "
              f"{', '.join(f'{v:.1f}' for v in ms['sharded'])}) vs unsharded "
              f"{warm['unsharded']:.1f} ms ({', '.join(f'{v:.1f}' for v in ms['unsharded'])}); "
              f"DTensor's host cost {warm['sharded'] - warm['unsharded']:.1f} ms a step "
              f"(median of the steps after the first); max_memory_allocated "
              f"{peak['sharded']:.2f} GiB sharded, {peak['unsharded']:.2f} unsharded; "
              f"collectives counted under OpCost: {coll or 'none'} (total operand bytes "
              f"{cost.collectives['total_operand_bytes']:,}); counted FLOPs {cost.flops:.4e}; "
              f"launches {got}; {time.perf_counter() - t_all:.1f} s  [{card}]", flush=True)
        del dp, ds, dm, db
    finally:
        dist.destroy_process_group()
    return res


def sharded_decode_check(checks, cfg, params, tok, caches, pos, dev, card, paths) -> dict:
    """One dense decode step (``launch.steps.make_serve_step``) with the
    parameters, tokens and caches placed as DTensors on a 1x1 NCCL
    ``DeviceMesh`` (``from_local``, no copies; the caches written in place
    on their local shards) against the unsharded step on the same inputs:
    the greedy tokens equal, #10 through ``local_map`` once a norm, no
    plain version.  Each step's time once warm (median of 3)."""
    import torch.distributed as dist

    from repro_torch.kernels import _lib
    from repro_torch.launch import steps as step_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import rules

    res: dict = {}
    t_all = time.perf_counter()
    serve = step_lib.make_serve_step(cfg)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    with torch.no_grad():
        want = serve(params, tok, caches, pos_t)[0]
        res["unsharded_ms"] = wall_ms(lambda: serve(params, tok, caches, pos_t), 3)
    mesh = make_host_mesh(dev)
    try:
        dp = step_lib.place(params, rules.param_shardings(params, mesh), mesh)
        dc = step_lib.place(caches, rules.cache_shardings(caches, mesh), mesh)
        dt = step_lib.place({"t": tok}, rules.batch_shardings({"t": tok}, mesh), mesh)["t"]
        with torch.no_grad(), plain_attention_calls() as plain:
            serve(dp, dt, dc, pos_t)  # DTensor's sharding propagation, once
            sync()
            _lib.counters.reset()
            got = serve(dp, dt, dc, pos_t)[0].to_local()
            sync()
            counts = paths["llm decode step sharded"] = _lib.counters.snapshot()
            res["sharded_ms"] = wall_ms(lambda: serve(dp, dt, dc, pos_t), 3)
        norms = 2 * cfg.n_layers + 1
        checks.expect(torch.equal(got, want) and counts.get("rmsnorm_bf16", 0) == norms
                      and not plain,
                      f"sharded dense decode step (B {tok.shape[0]}, 1x1 NCCL mesh, caches "
                      f"at pos {pos}): tokens equal the unsharded step's; #10 x "
                      f"{counts.get('rmsnorm_bf16', 0)} through local_map (expected {norms}), "
                      f"no plain version ({plain})")
        del dp, dc, dt
    finally:
        dist.destroy_process_group()
    print(f"    sharded decode step: {res['sharded_ms']:.2f} ms vs unsharded "
          f"{res['unsharded_ms']:.2f} ms (median of 3, host clock to a synchronize); "
          f"{time.perf_counter() - t_all:.1f} s  [{card}]", flush=True)
    return res


# the sharded train checks (granite-moe-1b, mamba2-2.7b): SyntheticLM B x S,
# steps (the first warms up, the median of the rest is the step time)
FAMILY_TRAIN_B, FAMILY_TRAIN_S, FAMILY_TRAIN_STEPS = 8, 1024, 4


def sharded_family_check(checks, arch, cfg, params, dev, card, paths, args, fam) -> dict:
    """A family sharded on a 1x1 NCCL ``DeviceMesh`` (``make_host_mesh()``;
    parameters, batch, tokens and caches placed by ``launch.steps.place``
    with ``from_local``: no second copy) against the same steps unsharded
    on the same tensors: a prefill (1, ``--prefill``) (a vision model's
    patch embeddings among them, codebooks for audio) whose last logits
    equal bit for bit, or within ``SHARDED_RTOL`` with the worst difference
    printed; a dense decode step (B ``FAMILY_DEC_B``, or the family's
    ``dec_b``, at ``--kv-len`` - 37 over caches drawn from the seed by
    :func:`fill_state`, written in place on their local shards; a recurrent
    state restored before each compared step) whose logits likewise and
    whose greedy tokens (``make_serve_step``) are equal.  #8 and #10 launch
    through ``local_map`` as the unsharded steps count them (#10 for every
    block norm, MLA's q_norm and kv_norm and Mamba-2's gated norm), no
    plain version runs.  Each step once warm, median of 3, host clock; the
    difference is DTensor's host cost.  Then, where ``fam["sharded"]`` has
    ``train`` (a depth cut of the model, ``{}`` for none),
    ``FAMILY_TRAIN_STEPS`` train steps (:func:`sharded_step_check`, its own
    mesh) from copies of the same state on ``SyntheticLM`` batches of B
    ``FAMILY_TRAIN_B`` x S ``FAMILY_TRAIN_S``, remat "full", on the cut
    model's layers of ``params``, which those steps update in place.
    Launch counts land in ``paths`` under ``llm <arch> sharded ...`` and
    ``train <arch> sharded step <i>``."""
    import torch.distributed as dist

    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import _lib
    from repro_torch.launch import steps as step_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import to_device
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_leaves
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.sharding import rules

    res: dict = {}
    t_all = time.perf_counter()
    n_attn = sum(k == "attn" for k in cfg.block_pattern) * cfg.n_superblocks
    norms = norms_a_step(cfg)
    gen_ = torch.Generator(device=dev).manual_seed(args.seed + 29)
    toks = torch.randint(0, cfg.vocab_size, token_shape(cfg, 1, args.prefill), generator=gen_,
                         device=dev)
    batch = prefill_batch(cfg, toks, gen_)
    bd, pos = fam.get("dec_b", FAMILY_DEC_B), args.kv_len - 37
    caches = fill_state(T.init_caches(cfg, bd, args.kv_len, device=dev), gen_, pos)
    # a recurrent state moves on each step: the compared steps start from
    # this copy (the kv caches' and rings' writes repeat the same slot)
    recurrent = {"mamba2", "rglru"} & set(cfg.block_pattern + cfg.tail_pattern)
    state0 = _tree_copy(caches) if recurrent else None

    def restore():
        if state0 is not None:
            for t, t0 in zip(tree_leaves(caches), tree_leaves(state0)):
                t.copy_(t0)

    tok = torch.randint(0, cfg.vocab_size, token_shape(cfg, bd, 1), generator=gen_, device=dev)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    prefill = step_lib.make_prefill_step(cfg)
    serve = step_lib.make_serve_step(cfg)
    with torch.inference_mode():
        want_pre = prefill(params, batch)
        restore()
        want_logits = T.decode_step(params, cfg, tok, caches, pos)[0]
        restore()
        want_tok = serve(params, tok, caches, pos_t)[0]
        res["prefill_unsharded_ms"] = wall_ms(lambda: prefill(params, batch), 3)
        res["decode_unsharded_ms"] = wall_ms(lambda: serve(params, tok, caches, pos_t), 3)
    mesh = make_host_mesh(dev)
    try:
        dp = step_lib.place(params, rules.param_shardings(params, mesh), mesh)
        db = step_lib.place(batch, rules.batch_shardings(batch, mesh), mesh)
        dc = step_lib.place(caches, rules.cache_shardings(caches, mesh), mesh)
        dt = step_lib.place({"t": tok}, rules.batch_shardings({"t": tok}, mesh), mesh)["t"]
        with torch.inference_mode(), plain_attention_calls() as plain:
            prefill(dp, db)  # DTensor's sharding propagation, once
            sync()
            _lib.counters.reset()
            got_pre = prefill(dp, db).to_local()
            sync()
            pre_counts = paths[f"llm {arch} sharded prefill"] = _lib.counters.snapshot()
            res["prefill_sharded_ms"] = wall_ms(lambda: prefill(dp, db), 3)
            T.decode_step(dp, cfg, dt, dc, pos)  # propagation, once
            restore()
            sync()
            _lib.counters.reset()
            got_logits = T.decode_step(dp, cfg, dt, dc, pos)[0].to_local()
            sync()
            dec_counts = paths[f"llm {arch} sharded decode step"] = _lib.counters.snapshot()
            restore()
            got_tok = serve(dp, dt, dc, pos_t)[0].to_local()
            res["decode_sharded_ms"] = wall_ms(lambda: serve(dp, dt, dc, pos_t), 3)
        del dp, db, dc, dt
    finally:
        dist.destroy_process_group()
    pre_rel, dec_rel = _worst_rel(got_pre, want_pre), _worst_rel(got_logits, want_logits)
    want_pre_counts = {"rmsnorm_bf16": norms, "flash_attention_bf16": n_attn}
    want_dec_counts = {"rmsnorm_bf16": norms, "flash_attention_bf16": 0}
    pre_got = {k: pre_counts.get(k, 0) for k in want_pre_counts}
    dec_got = {k: dec_counts.get(k, 0) for k in want_dec_counts}
    checks.expect(pre_rel <= SHARDED_RTOL and pre_got == want_pre_counts and not plain,
                  f"{arch} sharded prefill (1, {args.prefill:,}), 1x1 NCCL mesh: last logits "
                  f"{'bit for bit' if pre_rel == 0 else f'worst relative difference {pre_rel:.3g}'}"
                  f" (limit {SHARDED_RTOL:g}); launches {pre_got} through local_map (expected "
                  f"{want_pre_counts}), no plain version ({plain})")
    checks.expect(dec_rel <= SHARDED_RTOL and torch.equal(got_tok, want_tok)
                  and dec_got == want_dec_counts,
                  f"{arch} sharded dense decode step (B {bd}, {args.kv_len:,}-token caches, pos "
                  f"{pos}): logits {'bit for bit' if dec_rel == 0 else f'worst relative difference {dec_rel:.3g}'}"
                  f", tokens {tuple(got_tok.shape)} equal the unsharded step's; launches "
                  f"{dec_got} (expected {want_dec_counts})")
    res.update(prefill_rel=pre_rel, decode_rel=dec_rel, prefill_launches=pre_got,
               decode_launches=dec_got)
    print(f"    {arch} sharded prefill (1, {args.prefill:,}): {res['prefill_sharded_ms']:.2f} ms vs "
          f"unsharded {res['prefill_unsharded_ms']:.2f}; dense decode step (B {bd}, "
          f"{args.kv_len:,}-token caches): {res['decode_sharded_ms']:.2f} ms vs unsharded "
          f"{res['decode_unsharded_ms']:.2f} (median of 3 once warm, host clock to a "
          f"synchronize; the differences are DTensor's host cost)  [{card}]", flush=True)
    del caches, state0, batch, want_pre, want_logits, got_pre, got_logits
    free_card()
    if "train" in fam["sharded"]:
        tcfg = dataclasses.replace(cfg, **fam["sharded"]["train"])
        tparams = dict(params, blocks=params["blocks"][:tcfg.n_superblocks])
        cut = (f", {tcfg.n_layers} of its {cfg.n_layers} layers" if tcfg.n_layers != cfg.n_layers
               else "")
        print(f"    {arch} sharded training: B {FAMILY_TRAIN_B} x S {FAMILY_TRAIN_S}, remat "
              f"{tcfg.remat_policy!r}{cut}", flush=True)
        opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=FAMILY_TRAIN_STEPS)
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=FAMILY_TRAIN_S,
                                      global_batch=FAMILY_TRAIN_B, seed=args.seed))
        tbatch = to_device(data.batch(0), dev)
        state = init_state(tparams, opt_cfg)
        res["train"] = sharded_step_check(checks, tcfg, opt_cfg, tparams, state, tbatch,
                                          train_step_counts(tcfg), dev, card, paths,
                                          n_steps=FAMILY_TRAIN_STEPS, label=f"train {arch}")
        res["train"]["n_layers"] = tcfg.n_layers
        del state, tbatch, tparams
        free_card()
    res["check_s"] = time.perf_counter() - t_all
    return res


def train_phase(args, checks, dev, card, paths) -> dict:
    """llama3.2-1B at full width trains on the card (bf16, remat "full"):
    ``TRAIN_STEPS`` steps of ``launch.steps.make_train_step`` on
    ``SyntheticLM`` batches of B 8 x S 1024 (finite losses, the last below
    the first, #8 and #10 forward and backward launched the counted number
    of times a step, no plain version), a save at step ``TRAIN_SAVE_AT``
    through ``CheckpointManager`` restored bit for bit into fresh
    parameters and state, the steps after it repeated within
    ``TRAIN_RESUME_RTOL``, one EF-int8 step; then one float32 step of a
    2-layer copy at full width on the card and on the CPU from the same
    parameters and batch (loss and grad norm within 1e-4 relative, each
    gradient within the §6 float32 row-scaled limit); then
    ``GEMMA_TRAIN_STEPS`` steps of gemma-2b at full width (bf16, B
    ``GEMMA_TRAIN_B`` x S 1024: #8's backward at head dim 256; finite
    losses, the counted launches, no plain version; step ms and peak
    memory).  Launch counts land in ``paths``."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import _lib
    from repro_torch.launch import steps as step_lib
    from repro_torch.launch.train import to_device
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import count_params, tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, ef_int8_state, init_state

    res: dict = {}
    free_card()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30  # what earlier phases still hold
    cfg = registry.get_config(LLM_ARCH)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=min(20, TRAIN_STEPS // 5 + 1),
                          total_steps=TRAIN_STEPS)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_S,
                                  global_batch=TRAIN_B, seed=args.seed))
    batches = [to_device(data.batch(i), dev) for i in range(TRAIN_STEPS)]
    params = T.init_params(args.seed, cfg, device=dev)
    state = init_state(params, opt_cfg)
    n_params = count_params(params)
    print(f"  {LLM_ARCH}: {n_params:,} parameters ({cfg.dtype}), remat {cfg.remat} "
          f"({cfg.remat_policy}); B {TRAIN_B} x S {TRAIN_S}, AdamW lr {TRAIN_LR}", flush=True)
    step = step_lib.make_train_step(cfg, opt_cfg)
    want_counts = train_step_counts(cfg)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_")
    free_gb = shutil.disk_usage(tmp.name).free / 1e9
    print(f"  checkpoint directory {tmp.name}: {free_gb:.1f} GB free", flush=True)
    mgr = CheckpointManager(tmp.name, keep=1)

    def snapshot(params, state):  # on the host, so the card's peak memory is the training's own
        return [t.detach().to("cpu", copy=True) for t in tree_leaves(params) + [state.step]
                + tree_leaves(state.m) + tree_leaves(state.v)]

    saved = []

    def save_at(i, params, state, losses):
        if i == TRAIN_SAVE_AT:
            saved.extend(snapshot(params, state))
            t = time.perf_counter()
            mgr.save(i, {"params": params, "opt": state}, {"loss": losses[-1]})
            res["save_handoff_s"] = time.perf_counter() - t

    params, state, metrics, losses, times = run_train_steps(
        checks, paths, step, params, state, batches, want_counts, "train", before=save_at)
    t = time.perf_counter()
    mgr.wait()
    res["save_write_s"] = time.perf_counter() - t
    checks.expect(losses[-1] < losses[0],
                  f"the loss falls over {TRAIN_STEPS} steps: {losses[0]:.4f} -> {losses[-1]:.4f}")
    steady = statistics.median(times[1:])
    # the checkpoint is written in the background from step TRAIN_SAVE_AT on,
    # and its host work slows the steps beside it
    before = statistics.median(times[1:TRAIN_SAVE_AT])
    beside = statistics.median(times[TRAIN_SAVE_AT:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    res.update(losses=losses, step_ms=steady, first_step_ms=times[0],
               tokens_per_s=TRAIN_B * TRAIN_S / steady * 1e3, peak_gib=peak - held,
               held_gib=held, params=n_params, step_ms_before_save=before,
               step_ms_beside_save=beside)
    print(f"  train: step {steady:.1f} ms (median of steps 1-{TRAIN_STEPS - 1}; of steps "
          f"1-{TRAIN_SAVE_AT - 1} {before:.1f}, of steps {TRAIN_SAVE_AT}-{TRAIN_STEPS - 1} beside "
          f"the checkpoint's write {beside:.1f}; first {times[0]:.1f} ms), {res['tokens_per_s']:,.0f} tokens/s "
          f"({TRAIN_B * TRAIN_S / before * 1e3:,.0f} before the save), peak {peak - held:.2f} "
          f"GiB above the {held:.2f} GiB earlier phases still hold ({card})", flush=True)

    # -- resume from the checkpoint ---------------------------------------
    del state, metrics, params
    free_card()
    fresh = T.init_params(args.seed + 1, cfg, device=dev)
    t = time.perf_counter()
    back = mgr.restore(TRAIN_SAVE_AT, {"params": fresh, "opt": init_state(fresh, opt_cfg)})
    sync()
    res["restore_s"] = time.perf_counter() - t
    del fresh
    params, state = back["params"], back["opt"]
    del back
    restored = tree_leaves(params) + [state.step] + tree_leaves(state.m) + tree_leaves(state.v)
    same_all = len(restored) == len(saved) and all(
        a.dtype == b.dtype and torch.equal(a.cpu(), b) for a, b in zip(restored, saved))
    checks.expect(same_all, f"checkpoint of step {TRAIN_SAVE_AT}: {len(restored)} restored "
                            f"tensors bit-equal to the saved ones (save handoff "
                            f"{res['save_handoff_s']:.1f} s, write {res['save_write_s']:.1f} s "
                            f"after it, restore {res['restore_s']:.1f} s)")
    del saved, restored
    free_card()
    resumed = []
    with plain_attention_calls() as plain:
        for i in range(TRAIN_SAVE_AT, TRAIN_STEPS):
            sync()
            _lib.counters.reset()
            params, state, metrics = step(params, state, batches[i])
            resumed.append(float(metrics["loss"]))
            paths[f"train resumed step {i}"] = _lib.counters.snapshot()
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, losses[TRAIN_SAVE_AT:]))
    checks.expect(rel <= TRAIN_RESUME_RTOL and not plain,
                  f"steps {TRAIN_SAVE_AT}-{TRAIN_STEPS - 1} resumed from the checkpoint repeat "
                  f"the uninterrupted losses (worst relative difference {rel:.3g}, limit "
                  f"{TRAIN_RESUME_RTOL:g})")
    res["resume_rel"] = rel
    tmp.cleanup()

    # -- one EF-int8 step -------------------------------------------------
    ef = ef_int8_state(params)
    cstep = step_lib.make_train_step(cfg, opt_cfg, grad_compress=True)
    sync()
    _lib.counters.reset()
    t = time.perf_counter()
    params, state, ef, metrics = cstep(params, state, batches[0], ef)
    loss = float(metrics["loss"])
    sync()
    res["compress_step_ms"] = (time.perf_counter() - t) * 1e3
    counts = paths["train step grad_compress"] = _lib.counters.snapshot()
    checks.expect(math.isfinite(loss) and math.isfinite(float(metrics["grad_norm"]))
                  and all(counts.get(k, 0) == n for k, n in want_counts.items()),
                  f"a grad_compress=True (EF-int8) step: loss {loss:.6f}, "
                  f"{res['compress_step_ms']:.1f} ms")
    res["peak_gib_all"] = torch.cuda.max_memory_allocated() / 2**30 - held
    res["dryrun"] = [checks.phase("  dry run vs the card: llama3.2-1B train", lambda: dryrun_check(
        checks, f"{LLM_ARCH} train B {TRAIN_B} x S {TRAIN_S}", cfg, "train_4k",
        (params, state, batches[1]), steady, card, batch=TRAIN_B, seq=TRAIN_S))]
    del ef
    res["profile"] = profile_train_step(lambda: step(params, state, batches[1]))
    res["sharded"] = checks.phase("  sharded step: llama3.2-1B train on a 1x1 NCCL mesh",
                                  lambda: sharded_step_check(checks, cfg, opt_cfg, params, state,
                                                             batches[2], want_counts, dev,
                                                             card, paths))
    del params, state, metrics, batches
    free_card()

    # -- a float32 step on the card against the CPU -----------------------
    pcfg = dataclasses.replace(cfg, n_layers=PARITY_LAYERS, dtype="float32")
    cpu_p = T.init_params(args.seed, pcfg, device="cpu")
    card_p = tree_map(lambda t: t.detach().to(dev, copy=True), cpu_p)
    b_cpu = to_device(SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=PARITY_S,
                                             global_batch=1, seed=args.seed)).batch(0), "cpu")
    b_card = {k: v.to(dev) for k, v in b_cpu.items()}

    def loss_and_grads(p, b):
        leaves = tree_leaves(p)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss, _ = T.loss_and_aux(p, pcfg, b)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)  # the mqr-KV probes: None
        return loss.detach(), [g for g in grads if g is not None]

    _lib.counters.reset()
    with plain_attention_calls() as plain:
        l_card, g_card = loss_and_grads(card_p, b_card)
        sync()
    paths["train parity float32"] = _lib.counters.snapshot()
    t = time.perf_counter()
    l_cpu, g_cpu = loss_and_grads(cpu_p, b_cpu)
    res["parity_cpu_s"] = time.perf_counter() - t
    worst = max(worst_over_limit(a.cpu(), b, *GRAD_TOL[torch.float32], GRAD_FLOOR)
                for a, b in zip(g_card, g_cpu))
    n_card = float(torch.sqrt(sum((g.double().cpu() ** 2).sum() for g in g_card)))
    n_cpu = float(torch.sqrt(sum((g.double() ** 2).sum() for g in g_cpu)))
    l_rel = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    n_rel = abs(n_card - n_cpu) / n_cpu
    checks.expect(l_rel <= 1e-4 and n_rel <= 1e-4 and worst <= 1.0 and not plain,
                  f"float32 {PARITY_LAYERS}-layer step at full width, B 1 x S {PARITY_S}, card "
                  f"vs CPU: loss {float(l_card):.6f} vs {float(l_cpu):.6f} (rel {l_rel:.2g}), "
                  f"grad norm rel {n_rel:.2g}, every gradient within (1e-4, 1e-4) row-scaled "
                  f"(worst error / limit {worst:.3g}), no plain version on the card "
                  f"(CPU side {res['parity_cpu_s']:.1f} s)")
    res.update(parity_loss_rel=l_rel, parity_norm_rel=n_rel, parity_worst=worst)
    del cpu_p, card_p, g_card, g_cpu
    free_card()

    # -- gemma-2b at full width: #8's backward at head dim 256 -------------
    gcfg = registry.get_config(GEMMA_ARCH)
    g_opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=GEMMA_TRAIN_STEPS)
    g_data = SyntheticLM(DataConfig(vocab_size=gcfg.vocab_size, seq_len=TRAIN_S,
                                    global_batch=GEMMA_TRAIN_B, seed=args.seed))
    torch.cuda.reset_peak_memory_stats()
    g_held = torch.cuda.memory_allocated() / 2**30
    params = T.init_params(args.seed, gcfg, device=dev)
    state = init_state(params, g_opt)
    g_step = step_lib.make_train_step(gcfg, g_opt)
    hd = gcfg.head_dim
    want_g = dict(train_step_counts(gcfg), **{f"flash_attention_bwd_bf16_d{hd}": gcfg.n_layers})
    g_batches = [to_device(g_data.batch(i), dev) for i in range(GEMMA_TRAIN_STEPS)]
    params, state, metrics, g_losses, g_times = run_train_steps(
        checks, paths, g_step, params, state, g_batches, want_g, f"train {GEMMA_ARCH}")
    g_peak = torch.cuda.max_memory_allocated() / 2**30 - g_held
    g_ms = statistics.median(g_times[1:]) if len(g_times) > 1 else g_times[0]
    res.update(gemma_losses=g_losses, gemma_step_ms=g_ms, gemma_first_step_ms=g_times[0],
               gemma_tokens_per_s=GEMMA_TRAIN_B * TRAIN_S / g_ms * 1e3, gemma_peak_gib=g_peak,
               gemma_params=count_params(params))
    print(f"  {GEMMA_ARCH}: {res['gemma_params']:,} parameters; step {g_ms:.1f} ms (median of "
          f"steps 1-{GEMMA_TRAIN_STEPS - 1}; first {g_times[0]:.1f} ms), "
          f"{res['gemma_tokens_per_s']:,.0f} tokens/s, peak {g_peak:.2f} GiB above the "
          f"{g_held:.2f} GiB held before it ({card})", flush=True)
    res["dryrun"].append(checks.phase("  dry run vs the card: gemma-2b train", lambda: dryrun_check(
        checks, f"{GEMMA_ARCH} train B {GEMMA_TRAIN_B} x S {TRAIN_S}", gcfg, "train_4k",
        (params, state, g_batches[0]), g_ms, card, batch=GEMMA_TRAIN_B, seq=TRAIN_S)))
    del params, state, metrics, g_batches
    free_card()
    return res


# llama3.2-1B's training shapes: B 8, S 1024, 32 query heads of 64 (#8's
# backward over (256, 1024, 64)), 8,192 rows of 2,048 (#10's backward).
TRAIN_B, TRAIN_S = 8, 1024
# gemma-2b's: B 2, S 1024, 8 query heads of 256 (#8's backward over (16,
# 1024, 256)); a few steps, after llama's run
GEMMA_ARCH, GEMMA_TRAIN_B, GEMMA_TRAIN_STEPS = "gemma_2b", 2, 3
# the row-scaled limits of the forward kernels (PERF.md §6), per dtype; a
# gradient row's RMS is floored at GRAD_FLOOR x its tensor's RMS
GRAD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 3e-2)}
GRAD_FLOOR = 0.1
FLASH_PEAK = {torch.float32: PEAK_OPS_PER_S, torch.bfloat16: 989e12}


def grad_kernel_checks(checks, dev, seed: int, launches=None) -> list[dict]:
    """The backward kernels of #8 and #10 (``ops.FlashAttention``,
    ``ops.RMSNorm``) against autograd of their plain versions on the card,
    each gradient within :func:`worst_over_limit`'s limits (#8's must
    reject dk and dv with one block of keys left out), deterministic (two
    runs bit-equal); #8's forward with its log-sum-exp bit-equal to the
    serving forward and its lse within 1e-4 (1 + |lse|) of
    ``torch.logsumexp``.  Times each backward kernel at llama3.2-1B's
    training shape beside its plain version, its bound and the backward of
    the PyTorch call (SDPA, ``F.rms_norm``) through ``torch.autograd.grad``.
    Returns the kernel rows for the ``{"kernels": [...]}`` line, with
    ``launches`` (name -> count on the training path) filled in."""
    from repro_torch.kernels import ops

    launches = launches or {}
    csrc = "src/repro_torch/kernels/csrc/"
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    rows: list[dict] = []

    def rand(shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    def plain_grads(fn, inputs, dout):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        return torch.autograd.grad(fn(*leaves), leaves, dout)

    def within(label, got, want, tol) -> float:
        worst = max(worst_over_limit(g, w, *tol, GRAD_FLOOR) for g, w in zip(got, want))
        checks.expect(all(g.shape == w.shape and g.dtype == w.dtype for g, w in zip(got, want))
                      and worst <= 1.0,
                      f"{label}: every gradient within {tol[0]} |plain| + {tol[1]} x the row's "
                      f"RMS (floored at {GRAD_FLOOR} x the tensor's) of autograd of the plain "
                      f"version (worst error / limit {worst:.3g})")
        return worst

    def row(name, source, kernel_fn, plain_fn, library_fn, nbytes, ops_count, peak, err,
            counter=None):
        ms, by = device_timing(kernel_fn)
        window = time_ms(kernel_fn)
        plain_ms, plain_by = device_timing(plain_fn)
        lib_ms, lib_by = device_timing(library_fn)
        b_ms, b_by = bound_ms(nbytes, ops_count, peak)
        n = launches.get(counter or name, 0)
        rows.append(dict(name=name, route="cuda", source=source, replaces=(
            "none (the reference trains through jnp under jax.grad); the backward of "
            + ("src/repro/kernels/flash_attention.py:86" if "flash" in name
               else "src/repro/kernels/rmsnorm.py:33")),
            launches=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            timed_by={"ms": by, "plain_ms": plain_by, "library_ms": lib_by}))
        peak_s = f" at {peak / 1e12:g} TFLOP/s" if b_by == "operations" else ""
        print(f"  {name}: {ms:.4f} ms on the device, {window:.4f} ms in one call's event "
              f"window (plain {plain_ms:.4f} ms, library backward {lib_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms by {b_by}{peak_s}, {b_ms / ms:.1%} of it; {n} calls on the "
              f"training path)", flush=True)

    # -- #8: dq, dk, dv --------------------------------------------------
    # the timed rows: llama3.2-1B's training shape (row name without a
    # suffix) and gemma-2b's (``_d256``); launches per head dim
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = [((TRAIN_B * 32, TRAIN_S, 64), ""), ((16, TRAIN_S, 128), None),
             ((3, 320, 64), None), ((2, 200, 64), None), ((2, 200, 128), None),
             ((GEMMA_TRAIN_B * 8, TRAIN_S, 256), "_d256"), ((3, 320, 256), None),
             ((2, 200, 256), None)]
    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        tol = GRAD_TOL[dt]
        for (bh, s_len, hd), timed in cases:
            label = f"flash_attention_bwd_{tag} ({bh}, {s_len}, {hd})"
            q, k, v, do = (rand((bh, s_len, hd), dt) for _ in range(4))
            block = 128 if s_len % 128 == 0 else 8
            out_serve = ops.flash_attention(q, k, v, block_q=block, block_k=block)
            out, lse = ops.flash_attention_lse(q, k, v, block_q=block, block_k=block)
            logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(hd)
            causal = torch.ones((s_len, s_len), dtype=torch.bool, device=dev).tril()
            want_lse = torch.logsumexp(torch.where(causal, logits, -1e30), dim=-1)
            del logits, causal
            lse_err = float(((lse - want_lse).abs() / (1 + want_lse.abs())).max())
            checks.expect(same(out, out_serve) and lse_err <= 1e-4,
                          f"{label}: the forward with lse equals the serving forward bit for "
                          f"bit; lse within 1e-4 (1 + |lse|) of torch.logsumexp ({lse_err:.3g})")
            got = ops.flash_attention_bwd(q, k, v, lse, do)
            again = ops.flash_attention_bwd(q, k, v, lse, do)
            checks.expect(all(same(a, b) for a, b in zip(got, again)),
                          f"{label}: two runs bit-equal")
            # bf16: autograd of the plain version on float32 copies of the
            # same inputs, cast to bf16.  Autograd of the bf16 plain version
            # rounds dO.V^T to bf16 (the backward of its cast of p), an
            # error of |dO.V^T| / 256 that stays in rows whose dS cancels
            # (rows over few keys); the kernel keeps dS in float32.
            want = [g.to(dt) for g in plain_grads(
                ops.flash_attention_torch, (q.float(), k.float(), v.float()), do.float())]
            within(label, got, want, tol)
            cut = (got[0], got[1].clone(), got[2].clone())
            cut[1][:, 64:128] = 0  # dk and dv of the keys 64..127 left out
            cut[2][:, 64:128] = 0
            bad = max(worst_over_limit(g, w, *tol, GRAD_FLOOR) for g, w in zip(cut, want))
            checks.expect(bad > 1.0, f"{label}: that limit rejects dk and dv with the keys "
                                     f"64..127 left out (worst error / limit {bad:.3g})")
            err = max(max_abs_err(g, w) for g, w in zip(got, want))
            del again, cut, want, want_lse
            if timed is not None:
                es = q.element_size()
                q4, k4, v4 = (t[None].detach().clone().requires_grad_() for t in (q, k, v))
                out4 = sdpa(q4, k4, v4, is_causal=True)
                do4 = do[None]
                row(f"flash_attention_bwd_{tag}{timed}", csrc + "flash_attention_bwd.cu",
                    lambda: ops.flash_attention_bwd(q, k, v, lse, do),
                    lambda: ops.flash_attention_bwd_torch(q, k, v, lse, do),
                    lambda: torch.autograd.grad(out4, (q4, k4, v4), do4, retain_graph=True),
                    # q, k, v, dO read and dq, dk, dv written once; lse read
                    nbytes=7 * bh * s_len * hd * es + 4 * bh * s_len,
                    # five causal products of S (S + 1) / 2 pairs of D multiply-adds
                    ops_count=5 * bh * s_len * (s_len + 1) * hd,
                    peak=FLASH_PEAK[dt], err=err, counter=f"flash_attention_bwd_{tag}_d{hd}")
                del q4, k4, v4, out4
            del q, k, v, do, out, lse, got
    # the backward refuses a head dim it is not built for, before any launch
    try:
        x96 = rand((1, 128, 96), torch.bfloat16)
        ops.flash_attention_bwd(x96, x96, x96, torch.zeros((1, 128), device=dev), x96)
        refused = False
    except ValueError:
        refused = True
    checks.expect(refused, "flash_attention_bwd refuses D 96 with ValueError")

    # -- #10: dx, dscale ---------------------------------------------------
    d = 2048
    w_main = 1.0 + 0.1 * torch.randn((d,), generator=gen, device=dev)

    def rms_norm(*a, **kw):  # a float32 weight on bfloat16 rows warns on every call
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return torch.nn.functional.rms_norm(*a, **kw)

    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 3e-2)}[dt]
        buf = rand((4097 * 2050 + 1,), dt)
        w2050 = 1.0 + 0.1 * torch.randn((2050,), generator=gen, device=dev)
        main = (rand((TRAIN_B * TRAIN_S, d), dt), w_main)
        w256 = 1.0 + 0.1 * torch.randn((256,), generator=gen, device=dev)
        w4096 = 1.0 + 0.1 * torch.randn((4096,), generator=gen, device=dev)
        for label, (x, w), timed in (
                (f"rmsnorm_bwd_{tag} ({TRAIN_B * TRAIN_S}, {d})", main, True),
                (f"rmsnorm_bwd_{tag} (4097, 256), several rows a block",
                 (rand((4097, 256), dt), w256), False),
                (f"rmsnorm_bwd_{tag} (300, 4096)", (rand((300, 4096), dt), w4096), False),
                (f"rmsnorm_bwd_{tag} (4097, 2050)", (rand((4097, 2050), dt), w2050), False),
                (f"rmsnorm_bwd_{tag} (1, 2050)", (rand((1, 2050), dt), w2050), False),
                (f"rmsnorm_bwd_{tag} (4097, 2050) on a base one element off 16-byte alignment",
                 (buf[1:].view(4097, 2050), w2050), False)):
            dy = rand(tuple(x.shape), dt)
            got = ops.rmsnorm_bwd(x, w, dy)
            again = ops.rmsnorm_bwd(x, w, dy)
            checks.expect(all(same(a, b) for a, b in zip(got, again)),
                          f"{label}: two runs bit-equal")
            want = plain_grads(lambda a, b: ops.rmsnorm_torch(a, b), (x, w), dy)
            # dscale is a float32 sum over every row of float32 terms in
            # both, in another order: a float32 limit in both types
            within(label + " dx", got[:1], want[:1], tol)
            within(label + " dscale", (got[1][None],), (want[1][None],), (1e-4, 1e-4))
            err = max(max_abs_err(g, wv) for g, wv in zip(got, want))
            if timed:
                rows_, es = x.shape[0], x.element_size()
                xl, wl = x.detach().clone().requires_grad_(), w.detach().clone().requires_grad_()
                yl = rms_norm(xl, (d,), weight=wl, eps=1e-6)
                row(f"rmsnorm_bwd_{tag}", csrc + "rmsnorm_bwd.cu",
                    lambda: ops.rmsnorm_bwd(x, w, dy),
                    lambda: ops.rmsnorm_bwd_torch(x, w, dy),
                    lambda: torch.autograd.grad(yl, (xl, wl), dy, retain_graph=True),
                    # x and dy read, dx written; scale read, dscale written
                    nbytes=3 * rows_ * d * es + 2 * d * 4, ops_count=8 * rows_ * d,
                    peak=PEAK_OPS_PER_S, err=err)
                del xl, wl, yl
            del got, again, want, dy
    return rows


class Checks:
    """Collects failed checks; a phase that raises counts as failed."""

    def __init__(self):
        self.failures: list[str] = []

    def expect(self, ok: bool, what: str) -> None:
        print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
        if not ok:
            self.failures.append(what)

    def phase(self, name: str, fn):
        print(f"== {name}", flush=True)
        try:
            return fn()
        except Exception:  # a failed phase is reported and fails the run
            traceback.print_exc()
            self.failures.append(f"phase {name} raised")
            return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="pyramid objects")
    ap.add_argument("--queries", type=int, default=256, help="queries per batch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tree-n", type=int, default=50_000,
                    help="objects of the mqr-tree and R-tree (host-built)")
    ap.add_argument("--moving-n", type=int, default=1_000_000,
                    help="objects of the moving-object workload")
    ap.add_argument("--ticks", type=int, default=20, help="ticks of the moving workload")
    ap.add_argument("--prefill", type=int, default=4096,
                    help="tokens of the prefill attention and rows of the norm")
    ap.add_argument("--kv-len", type=int, default=32_768,
                    help="decode context of the mqr-KV step (a multiple of 128, >= 8192)")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})", file=sys.stderr)
        return 1

    # The second tree builds run beside the card's work, in processes that
    # never touch the card (spawned, so they inherit no CUDA state).
    pool = ProcessPoolExecutor(max_workers=len(TREES),
                               mp_context=multiprocessing.get_context("spawn"))
    try:
        second = {s: pool.submit(second_tree_build, s, args.tree_n, args.seed)
                  for s in TREES}
        return run(args, second)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def run(args, second) -> int:
    """Every phase after the checks of :func:`main`; ``second`` maps each
    tree structure to the future of its second build."""
    from repro_torch import SpatialIndex
    from repro_torch.core import bulk, datasets
    from repro_torch.core.flat import overlaps
    from repro_torch.kernels import _lib, ops
    from repro_torch.kernels.pyramid_scan import _quantize_queries

    t_run = time.perf_counter()
    dev = card_device()
    card = nvidia_smi_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    checks = Checks()

    t0 = time.perf_counter()
    checks.phase("build kernels", lambda: _lib.load())
    build_s = time.perf_counter() - t0
    print(f"  nvcc build + load: {build_s:.1f} s", flush=True)
    if checks.failures:
        print(f"FAILED: {checks.failures}", flush=True)
        return 1

    def point_queries(d, seed):
        rng = np.random.default_rng(seed + 1)
        pick = d[rng.integers(0, d.shape[0], size=args.queries)]
        return np.stack([(pick[:, 0] + pick[:, 2]) * 0.5,
                         (pick[:, 1] + pick[:, 3]) * 0.5], axis=1).astype(np.float32)

    data = datasets.uniform_squares(args.n, seed=args.seed)
    queries = datasets.region_queries(data, args.queries, seed=args.seed).astype(np.float32)
    points = point_queries(data, args.seed)
    q_dev = torch.from_numpy(queries).to(dev)
    out = {}
    paths = {}  # path name -> launch counts of its run

    def drive(ix, qs, ps):
        """region + point + count on one index; the first call's host time."""
        t = time.perf_counter()
        region = ix.region(qs)
        point = ix.point(ps)
        count = ix.count(qs)
        sync()
        return dict(index=ix, region=region, point=point, count=count,
                    first_ms=(time.perf_counter() - t) * 1e3)

    def expect_launched(path, names):
        for name in names:
            n = paths[path].get(name, 0)
            checks.expect(n > 0, f"{name} launched on the {path} path ({n})")

    # -- 2. pyramid path -----------------------------------------------
    def main_path():
        sync()
        _lib.counters.reset()
        t = time.perf_counter()
        idx = SpatialIndex.build(data, structure="pyramid", build="device", **FIXED)
        sync()
        out["build_ms"] = (time.perf_counter() - t) * 1e3
        for precision in ("float32", "compact"):
            ix = idx if precision == "float32" else idx.with_backend(
                "cuda", precision="compact", **FIXED)
            out[precision] = drive(ix, queries, points)
        sync()
        paths["pyramid"] = out["launches"] = _lib.counters.snapshot()
        out["index"] = idx
        print(f"  levels {idx.schedule.levels}  width {idx.schedule.width}  "
              f"build {out['build_ms']:.1f} ms  launches {out['launches']}", flush=True)
        expect_launched("pyramid", ("build_levels", "quantize_cm", "level_sweep_f32",
                                    "level_sweep_u16"))

    checks.phase("pyramid path", main_path)
    if "index" not in out:
        print(f"FAILED: {checks.failures}", flush=True)
        return 1
    idx = out["index"]
    sched = idx.schedule
    qsched = idx.artifacts.quantized

    # -- 3. pyramid results --------------------------------------------
    def results():
        plain = ops.device_schedule(data, levels=sched.levels, engine="torch", device=dev)
        for f in ("mbr_cm", "parent", "n_real", "obj_mbr", "obj_level", "obj_slot", "obj_id"):
            checks.expect(same_bits(getattr(sched, f), getattr(plain, f)),
                          f"device build == plain build: {f} (by its bits)")
        qplain = ops.quantize_schedule(plain, engine="torch")
        out["qplain"] = qplain
        for f in ("mbr_q", "parent_q", "origin", "inv_cell", "confirm_mbr"):
            checks.expect(same(getattr(qsched, f), getattr(qplain, f)),
                          f"quantized schedule == plain: {f}")
        p_dev = torch.from_numpy(points).to(dev)
        point_q = torch.cat([p_dev, p_dev], dim=1)
        for precision, scan, s in (("float32", ops.pyramid_scan, plain),
                                   ("compact", ops.pyramid_scan_compact, qplain)):
            r = out[precision]
            for what, q, res in (("region", q_dev, r["region"]), ("point", point_q, r["point"])):
                hits, visits = scan(s, q, engine="torch")
                checks.expect(same(res.hits, hits), f"{precision} {what} hits == plain path")
                checks.expect(same(res.visits_per_level, visits),
                              f"{precision} {what} visits == plain path")
            checks.expect(same(r["count"], r["region"].hits.sum(dim=1)),
                          f"{precision} count == region hits per query")
        checks.expect(same(out["compact"]["region"].hits, out["float32"]["region"].hits),
                      "compact hits == float32 hits")
        obj = sched.obj_mbr
        brute = overlaps(obj[None, :, :], q_dev[:, None, :])           # (Q, n)
        hits = out["float32"]["region"].hits
        missing = int((brute & ~hits).sum())
        extra = int((hits & ~brute).sum())
        print(f"  brute-force overlaps {int(brute.sum())}, hits {int(hits.sum())}, "
              f"extra hits {extra}", flush=True)
        checks.expect(missing == 0, f"hits cover the brute-force overlap mask (missing {missing})")
        v32 = out["float32"]["region"].visits_per_level
        vc = out["compact"]["region"].visits_per_level
        print(f"  visits/query float32 {float(v32.sum()) / args.queries:.2f}  "
              f"compact {float(vc.sum()) / args.queries:.2f}", flush=True)
        # a small index on the card against the numpy oracle on the CPU
        small = data[:2000]
        sq = datasets.region_queries(small, 8, seed=args.seed)
        oracle = SpatialIndex.build(small, structure="pyramid", backend="host",
                                    device="cpu").region(sq)
        for precision in ("float32", "compact"):
            for build in ("device", "host"):
                on_card = SpatialIndex.build(small, structure="pyramid", build=build,
                                             precision=precision).region(sq)
                checks.expect(
                    same(on_card.hits.cpu(), oracle.hits)
                    and same(on_card.visits_per_level.cpu(), oracle.visits_per_level),
                    f"n=2000 {precision} build={build} on the card == numpy oracle")

    checks.phase("pyramid results", results)

    # -- 4. pyramid extras: compact8, the per-level plan, autotuning ---
    def pyramid_extras():
        sync()
        _lib.counters.reset()
        t = time.perf_counter()
        with plain_quantizer_calls() as plain_q:
            ix8 = idx.with_backend("cuda", precision="compact8", **FIXED)
        sync()
        out["quantize8_ms"] = (time.perf_counter() - t) * 1e3
        n_q = _lib.counters.snapshot().get("quantize_cm", 0)
        checks.expect(n_q == 1 and not plain_q,
                      f"the compact8 build launched quantize_cm once ({n_q}) and ran no plain "
                      f"quantizer ({len(plain_q)} calls)")
        out["compact8"] = drive(ix8, queries, points)
        t = time.perf_counter()
        hits, visits, n_launches = ops.per_level_region_search(sched, q_dev)
        sync()
        out["per_level"] = dict(hits=hits, visits=visits, launches=n_launches,
                                first_ms=(time.perf_counter() - t) * 1e3)
        auto = idx.with_backend("cuda")  # the reference's defaults: autotune="auto"
        t = time.perf_counter()
        region = auto.region(queries)
        sync()
        out["auto"] = dict(index=auto, region=region,
                           first_ms=(time.perf_counter() - t) * 1e3)
        sync()
        paths["pyramid extras"] = _lib.counters.snapshot()
        print(f"  launches {paths['pyramid extras']}", flush=True)
        print(f"  autotune winners {idx.artifacts.tuned}", flush=True)
        expect_launched("pyramid extras", ("level_sweep_hier", "mbr_scan"))
        q8 = out["compact8"]["index"].artifacts.quantized8
        print(f"  compact8 split {q8.split} of {sched.levels} levels, parents "
              f"{q8.parent_q.dtype}, streamed tile+parent bytes {q8.streamed_bytes} "
              f"(compact {qsched.streamed_bytes})", flush=True)
        f32 = out["float32"]["region"]
        checks.expect(same(hits, f32.hits) and same(visits, f32.visits_per_level),
                      "per-level plan hits and visits == fused float32 path")
        checks.expect(n_launches == sched.levels, f"per-level plan made {n_launches} launches")
        checks.expect(same(region.hits, f32.hits)
                      and same(region.visits_per_level, f32.visits_per_level),
                      "autotuned backend hits and visits == fused float32 path")
        qplain8 = ops.quantize_schedule(sched, engine="torch", upper8=True)
        for f in ("mbr_q8", "mbr_q", "parent_q", "inv_cell8"):
            checks.expect(same(getattr(q8, f), getattr(qplain8, f)),
                          f"compact8 schedule == plain: {f}")
        r8 = out["compact8"]
        h8, v8 = ops.pyramid_scan_compact8(qplain8, q_dev, engine="torch")
        checks.expect(same(r8["region"].hits, f32.hits), "compact8 hits == float32 hits")
        checks.expect(same(r8["region"].hits, h8) and same(r8["region"].visits_per_level, v8),
                      "compact8 hits and visits == plain hierarchical sweep")
        checks.expect(same(r8["count"], r8["region"].hits.sum(dim=1)),
                      "compact8 count == region hits per query")
        print(f"  visits/query compact8 {float(v8.sum()) / args.queries:.2f}", flush=True)

    checks.phase("pyramid extras", pyramid_extras)

    # -- 5. tree path: the paper's mqr-tree and the R-tree -------------
    tree_data = datasets.uniform_squares(args.tree_n, seed=args.seed)
    tree_queries = datasets.region_queries(tree_data, args.queries,
                                           seed=args.seed).astype(np.float32)
    tree_points = point_queries(tree_data, args.seed)
    trees = {}

    def tree_path():
        sync()
        _lib.counters.reset()
        for structure in TREES:
            t = time.perf_counter()
            if structure == "mqr":
                tix = SpatialIndex.build(tree_data)  # the port's defaults
            else:
                tix = SpatialIndex.build(tree_data, structure="rtree")
            host_s = time.perf_counter() - t
            t = time.perf_counter()
            s = tix.schedule
            sync()
            tr = dict(index=tix, host_build_s=host_s,
                      lower_ms=(time.perf_counter() - t) * 1e3)
            for precision in PRECISIONS:
                before = _lib.counters.snapshot().get("quantize_cm", 0)
                with plain_quantizer_calls() as plain_q:
                    ix = tix if precision == "float32" else tix.with_backend(
                        "cuda", precision=precision)
                n_q = _lib.counters.snapshot().get("quantize_cm", 0) - before
                if precision != "float32":
                    checks.expect(n_q == 1 and not plain_q,
                                  f"the {structure} {precision} build launched quantize_cm "
                                  f"once ({n_q}) and ran no plain quantizer "
                                  f"({len(plain_q)} calls)")
                tr[precision] = drive(ix, tree_queries, tree_points)
            trees[structure] = tr
            print(f"  {structure}: host build {host_s:.1f} s, schedule L {s.levels} "
                  f"W {s.width} (lowering {tr['lower_ms']:.0f} ms), first "
                  + ", ".join(f"{p} {tr[p]['first_ms']:.1f} ms" for p in PRECISIONS),
                  flush=True)
            print(f"  {structure} autotune winners {tix.artifacts.tuned}", flush=True)
        sync()
        paths["tree"] = _lib.counters.snapshot()
        print(f"  launches {paths['tree']}", flush=True)
        expect_launched("tree", ("level_sweep_f32", "level_sweep_u16", "level_sweep_hier",
                                 "quantize_cm", "level_sweep_u16p"))

    checks.phase("tree path", tree_path)

    # -- 6. tree results -----------------------------------------------
    def tree_results():
        tq = torch.from_numpy(tree_queries).to(dev)
        tp = torch.from_numpy(tree_points).to(dev)
        tpq = torch.cat([tp, tp], dim=1)
        for structure, tr in trees.items():
            tix = tr["index"]
            s = tix.schedule
            checks.expect(s.root_unconditional and s.test_object_mbr,
                          f"{structure} schedule visits the root unconditionally and "
                          f"gates on object MBRs")
            build_s, fields = second[structure].result()
            tr["second_build_s"] = build_s
            for f, want in fields.items():
                got = getattr(s, f)
                ok = (same(got.cpu(), torch.from_numpy(want))
                      if isinstance(got, torch.Tensor) else got == want)
                checks.expect(ok, f"{structure} schedule == second build: {f}")
            q16 = tix.artifacts.quantized
            q8 = tix.artifacts.quantized8
            checks.expect(q16.parent_q.dtype == torch.uint16
                          and same(q16.parent_q.to(torch.int32), s.parent),
                          f"{structure} uint16 parents == int32 parents")
            qp16 = ops.quantize_schedule(s, engine="torch")
            qp8 = ops.quantize_schedule(s, engine="torch", upper8=True)
            for f in ("mbr_q", "parent_q", "origin", "inv_cell", "confirm_mbr"):
                checks.expect(same(getattr(q16, f), getattr(qp16, f)),
                              f"{structure} quantized schedule == plain: {f}")
            for f in ("mbr_q8", "mbr_q", "inv_cell8"):
                checks.expect(same(getattr(q8, f), getattr(qp8, f)),
                              f"{structure} compact8 schedule == plain: {f}")
            oracle = tix.with_backend("host")
            want = {"region": oracle.region(tree_queries), "point": oracle.point(tree_points)}
            plain = {"float32": lambda q: ops.pyramid_scan(s, q, engine="torch"),
                     "compact": lambda q: ops.pyramid_scan_compact(qp16, q, engine="torch"),
                     "compact8": lambda q: ops.pyramid_scan_compact8(qp8, q, engine="torch")}
            for precision in PRECISIONS:
                r = tr[precision]
                for what, q in (("region", tq), ("point", tpq)):
                    res = r[what]
                    hits, visits = plain[precision](q)
                    checks.expect(same(res.hits, hits) and same(res.visits_per_level, visits),
                                  f"{structure} {precision} {what} hits and visits == "
                                  f"plain path")
                    checks.expect(same(res.hits.cpu(), want[what].hits),
                                  f"{structure} {precision} {what} hits == host pointer search")
                    if precision == "float32":
                        checks.expect(
                            same(res.visits_per_level.cpu(), want[what].visits_per_level),
                            f"{structure} float32 {what} visits == host pointer search")
                if precision != "float32":
                    checks.expect(same(r["region"].hits, tr["float32"]["region"].hits),
                                  f"{structure} {precision} hits == float32 hits")
                checks.expect(same(r["count"], r["region"].hits.sum(dim=1)),
                              f"{structure} {precision} count == region hits per query")
            per_q = {p: float(tr[p]["region"].visits_per_level.sum()) / args.queries
                     for p in PRECISIONS}
            print(f"  {structure}: hits {int(tr['float32']['region'].hits.sum())}, visits/query "
                  + ", ".join(f"{p} {v:.2f}" for p, v in per_q.items())
                  + f"; second host build {build_s:.1f} s", flush=True)

    checks.phase("tree results", tree_results)

    # -- 7. flat levels ------------------------------------------------
    def flat_levels():
        s = trees["mqr"]["index"].schedule
        q16 = trees["mqr"]["index"].artifacts.quantized
        q8 = trees["mqr"]["index"].artifacts.quantized8
        tq = torch.from_numpy(tree_queries).to(dev)
        qq16 = _quantize_queries(tq, q16.origin, q16.inv_cell, q16.cells)
        qq8 = _quantize_queries(tq, q8.origin, q8.inv_cell8, q8.cells8)
        hier = (qq8, qq16, q8.mbr_q8, q8.mbr_q[q8.split:], q8.parent_q)
        for uncond in (s.levels - 1, 1):
            for name, kernel, plain, sweep_args in (
                ("level_sweep f32", ops.level_sweep, ops.level_sweep_torch,
                 (tq, s.mbr_cm, s.parent)),
                ("level_sweep u16 tiles, u16 parents", ops.level_sweep,
                 ops.level_sweep_torch, (qq16, q16.mbr_q, q16.parent_q)),
                ("level_sweep_hier", functools.partial(ops.level_sweep_hier, split=q8.split),
                 functools.partial(ops.level_sweep_hier_torch, split=q8.split), hier),
            ):
                got = kernel(*sweep_args, uncond_from=uncond)
                want = plain(*sweep_args, uncond_from=uncond)
                checks.expect(same(got, want),
                              f"{name} with uncond_from = {uncond} of L = {s.levels} == "
                              f"plain ({int(got[uncond:].sum())} flat-level survivors)")
            # kernel #2 with flat levels: windows made with the same uncond_from
            win_off, win_w = ops.stream_windows(s.parent, s.n_real, block_w=128, device=dev,
                                                uncond_from=uncond)
            for name, sweep_args in (("f32", (tq, s.mbr_cm, s.parent)),
                                     ("u16 tiles, u16 parents",
                                      (qq16, q16.mbr_q, q16.parent_q))):
                act, skipped = ops.level_sweep_stream(*sweep_args, win_off, win_w,
                                                      uncond_from=uncond)
                want, want_skipped = ops.level_sweep_stream_torch(*sweep_args, win_off, win_w,
                                                                  uncond_from=uncond)
                resident = ops.level_sweep(*sweep_args, uncond_from=uncond)
                checks.expect(same(act, want) and same(skipped, want_skipped)
                              and same(act, resident),
                              f"level_sweep_stream {name} with uncond_from = {uncond} == plain "
                              f"and == level_sweep ({int(skipped)} level-tiles skipped)")

    checks.phase("flat levels (uncond_from = L - 1, and 1)", flat_levels)

    # -- 8. live pyramid path ------------------------------------------
    live_out = {}

    def brute_live(log, qs):
        """Live contract: numpy float32 overlap over the live object table
        and ``alive``, chunked over queries -> (Q, id_space) bool."""
        table = log.mbr_table.astype(np.float32)
        want = np.zeros((qs.shape[0], table.shape[0]), bool)
        for i in range(0, qs.shape[0], 32):
            q = qs[i:i + 32, None, :]
            want[i:i + 32] = ((table[None, :, 0] <= q[..., 2]) & (q[..., 0] <= table[None, :, 2])
                              & (table[None, :, 1] <= q[..., 3]) & (q[..., 1] <= table[None, :, 3])
                              & log.alive[None, :])
        return want

    def live_plain(ix, precision, q):
        """The live sweep of ``ix``'s current epoch by the plain versions."""
        precision = "compact" if precision == "compact8" else precision
        aug = ix._updates.augmented(precision)
        fn = ops.fused_search_compact_live if precision == "compact" else ops.fused_search_live
        return fn(q, *aug.arrays, engine="torch", **aug.statics)

    def live_step(ixs, qs, ps):
        """region (first call after the mutation, then steady), point and
        count on every index of ``ixs`` (precision -> index)."""
        res = {}
        for precision, ix in ixs.items():
            sync()
            t = time.perf_counter()
            region = ix.region(qs)
            sync()
            first_ms = (time.perf_counter() - t) * 1e3
            res[precision] = dict(region=region, point=ix.point(ps), count=ix.count(qs),
                                  first_ms=first_ms,
                                  steady_ms=wall_ms(lambda: ix.region(qs), 3))
        return res

    def check_live(label, ixs, res, qs, ps):
        log = next(iter(ixs.values()))._updates
        want = brute_live(log, qs)
        q = torch.from_numpy(qs).to(dev)
        p = torch.from_numpy(ps).to(dev)
        pq = torch.cat([p, p], dim=1)
        for precision, ix in ixs.items():
            r = res[precision]
            checks.expect(np.array_equal(r["region"].hits.cpu().numpy(), want),
                          f"{label} {precision} hits == brute-force live mask")
            for what, qq in (("region", q), ("point", pq)):
                hits, visits = live_plain(ix, precision, qq)
                checks.expect(same(r[what].hits, hits) and same(r[what].visits_per_level, visits),
                              f"{label} {precision} {what} hits and visits (delta columns "
                              f"included) == plain path")
            checks.expect(same(r["count"], r["region"].hits.sum(dim=1)),
                          f"{label} {precision} count == region hits per query")
            if precision != "float32":
                checks.expect(same(r["region"].hits, res["float32"]["region"].hits),
                              f"{label} {precision} hits == float32 hits")
        print(f"  {label}: hits {int(res['float32']['region'].hits.sum())}, delta visits/query "
              f"{float(res['float32']['region'].delta_visits.sum()) / qs.shape[0]:.2f}; "
              + ", ".join(f"{p} first {r['first_ms']:.1f} ms, steady {r['steady_ms']:.2f} ms"
                          for p, r in res.items()), flush=True)

    def live_pyramid():
        sync()
        _lib.counters.reset()
        live = SpatialIndex.build(data, structure="pyramid", build="device", **FIXED)
        ixs = {"float32": live,
               "compact": live.with_backend("cuda", precision="compact", **FIXED)}
        rng = np.random.default_rng(args.seed + 3)
        sync()
        t = time.perf_counter()
        gids = live.insert(datasets.uniform_squares(200, seed=args.seed + 2))
        live.delete(rng.choice(args.n, size=1000, replace=False))
        live.delete(rng.choice(gids, size=50, replace=False))
        live_out["mutate_ms"] = (time.perf_counter() - t) * 1e3
        steps = {"mutate": live_step(ixs, queries, points)}
        check_live("live pyramid, buffered", ixs, steps["mutate"], queries, points)
        before = steps["mutate"]["float32"]["region"].hits
        sync()
        t = time.perf_counter()
        flushed = live.flush()
        sync()
        live_out["flush_ms"] = (time.perf_counter() - t) * 1e3
        checks.expect(flushed and live._updates.n_delta == 0 and live._updates.dead_base == 0,
                      "flush() merged the buffer and the tombstones")
        steps["flush"] = live_step(ixs, queries, points)
        check_live("live pyramid, flushed", ixs, steps["flush"], queries, points)
        after = steps["flush"]["float32"]["region"].hits
        w = before.shape[1]
        checks.expect(same(after[:, :w], before) and not bool(after[:, w:].any()),
                      "live pyramid hits bit-identical across the flush (global ids kept)")
        del before, after
        big = datasets.uniform_squares(live._updates.capacity + 44, seed=args.seed + 4)
        sync()
        t = time.perf_counter()
        live.insert(big)
        sync()
        live_out["merge_insert_ms"] = (time.perf_counter() - t) * 1e3
        checks.expect(live._updates.flushes == 2 and live._updates.n_delta == 0,
                      "an insert larger than the capacity merged directly")
        steps["merge"] = live_step(ixs, queries, points)
        check_live("live pyramid, overflow merge", ixs, steps["merge"], queries, points)
        sync()
        paths["live pyramid"] = _lib.counters.snapshot()
        log = live._updates
        rows = torch.from_numpy(log.mbr_table[log.base_gids].astype(np.float32)).to(dev)
        got = ops.build_levels(rows, levels=log.base.schedule.levels)
        want = ops.build_levels_torch(rows, levels=log.base.schedule.levels)
        checks.expect(all(same_bits(a, b) for a, b in zip(got, want))
                      and same_bits(got[1], log.base.schedule.mbr_cm),
                      f"live pyramid: kernel #4 over the last merge's {rows.shape[0]} rows == "
                      f"plain version by bits and == the live base schedule")
        del got, want, rows
        print(f"  launches {paths['live pyramid']}", flush=True)
        expect_launched("live pyramid", ("build_levels", "quantize_cm", "level_sweep_f32",
                                         "level_sweep_u16"))
        live_out["steps"] = {k: {p: {m: r[m] for m in ("first_ms", "steady_ms")}
                                 for p, r in v.items()} for k, v in steps.items()}
        live_out["index"] = live
        live_out["stats"] = dataclasses.asdict(live.stats)
        print(f"  mutate (200 inserts, 1,050 deletes) {live_out['mutate_ms']:.1f} ms, flush "
              f"{live_out['flush_ms']:.1f} ms, oversized insert (merge) "
              f"{live_out['merge_insert_ms']:.1f} ms; stats {live_out['stats']}", flush=True)

    checks.phase("live pyramid path", live_pyramid)

    # -- 9. live trees ---------------------------------------------------
    live_trees_idx = {}

    def live_trees():
        from repro_torch.update import oracle

        sync()
        _lib.counters.reset()
        rng = np.random.default_rng(args.seed + 5)
        new = datasets.uniform_squares(200, seed=args.seed + 2)
        for structure, tr in trees.items():
            lix = tr["index"].extend(new)  # a new index; the tree path's stays pristine
            gids = np.arange(args.tree_n, args.tree_n + new.shape[0])  # ids are append-only
            lix.delete(rng.choice(args.tree_n, size=min(1000, args.tree_n // 2), replace=False))
            lix.delete(rng.choice(gids, size=50, replace=False))
            ixs = {p: lix if p == "float32" else lix.with_backend("cuda", precision=p)
                   for p in PRECISIONS}
            res = live_step(ixs, tree_queries, tree_points)
            check_live(f"live {structure}", ixs, res, tree_queries, tree_points)
            live_out[structure] = {p: {m: r[m] for m in ("first_ms", "steady_ms")}
                                   for p, r in res.items()}
            live_trees_idx[structure] = lix  # mid-buffer, with tombstones
        small = datasets.uniform_squares(2000, seed=args.seed + 6)
        sq = datasets.region_queries(small, 32, seed=args.seed + 6).astype(np.float32)
        t = time.perf_counter()
        six = SpatialIndex.build(small)
        ixs = {"float32": six, "compact": six.with_backend("cuda", precision="compact")}
        g = six.insert(datasets.uniform_squares(200, seed=args.seed + 7))
        six.delete(rng.choice(2000, size=100, replace=False))
        six.delete(rng.choice(g, size=20, replace=False))
        q = torch.from_numpy(sq).to(dev)
        for stage in ("buffered", "flushed"):
            if stage == "flushed":
                checks.expect(six.flush(), "small mqr-tree flush() merged")
            want = oracle.hits_mask(six, sq, six.id_space)
            for precision, ix in ixs.items():
                r = ix.region(sq)
                hits, visits = live_plain(ix, precision, q)
                checks.expect(np.array_equal(r.hits.cpu().numpy(), want),
                              f"small mqr-tree, {stage}, {precision}: hits == mqr "
                              f"insertion-rule oracle")
                checks.expect(same(r.hits, hits) and same(r.visits_per_level, visits),
                              f"small mqr-tree, {stage}, {precision}: hits and visits == "
                              f"plain path")
        live_out["small_mqr_s"] = time.perf_counter() - t
        sync()
        paths["live trees"] = _lib.counters.snapshot()
        print(f"  small mqr-tree (2,000 objects, build + mutations + flush + two oracle "
              f"trees, host Python) {live_out['small_mqr_s']:.1f} s", flush=True)
        print(f"  launches {paths['live trees']}", flush=True)
        expect_launched("live trees", ("level_sweep_f32", "level_sweep_u16", "level_sweep_u16p"))

    checks.phase("live trees", live_trees)

    # -- 10. stream path ---------------------------------------------------
    stream_out = {}

    def stream_path():
        sync()
        _lib.counters.reset()
        specs = [("pyramid", p, idx, queries, points) for p in ("float32", "compact")]
        specs += [(st, p, tr["index"], tree_queries, tree_points)
                  for st, tr in trees.items() for p in ("float32", "compact")]
        for structure, precision, base, qs, ps in specs:
            ix = base.with_backend("cuda", stream=True, precision=precision, **FIXED)
            sync()
            t = time.perf_counter()
            region = ix.region(qs)
            sync()
            first_ms = (time.perf_counter() - t) * 1e3
            stream_out[structure, precision] = dict(
                index=ix, region=region, skipped=ix.stats.tiles_skipped,
                point=ix.point(ps), count=ix.count(qs), first_ms=first_ms)
        sync()
        paths["stream"] = _lib.counters.snapshot()
        print(f"  launches {paths['stream']}", flush=True)
        expect_launched("stream", ("level_sweep_stream_f32", "level_sweep_stream_u16",
                                   "level_sweep_stream_u16p"))

    checks.phase("stream path", stream_path)

    def stream_inputs(ix, precision, q):
        """(queries, tiles, parents, windows) of ``ix``'s streaming sweep."""
        s = ix.schedule
        win_off, win_w = ix._backend._windows[FIXED["block_w"]]
        if precision == "float32":
            return q, s.mbr_cm, s.parent, win_off, win_w
        qs16 = ix.artifacts.quantized
        qq = _quantize_queries(q, qs16.origin, qs16.inv_cell, qs16.cells)
        return qq, qs16.mbr_q, qs16.parent_q, win_off, win_w

    def stream_results():
        tq = torch.from_numpy(tree_queries).to(dev)
        for (structure, precision), r in stream_out.items():
            ref = out[precision] if structure == "pyramid" else trees[structure][precision]
            for what in ("region", "point"):
                checks.expect(same(r[what].hits, ref[what].hits)
                              and same(r[what].visits_per_level, ref[what].visits_per_level),
                              f"stream {structure} {precision} {what} hits and visits == "
                              f"resident sweep")
            checks.expect(same(r["count"], r["region"].hits.sum(dim=1)),
                          f"stream {structure} {precision} count == region hits per query")
            ix = r["index"]
            root = ix.schedule.root_unconditional
            qq, tiles, parent, win_off, win_w = stream_inputs(
                ix, precision, q_dev if structure == "pyramid" else tq)
            act2, sk2 = ops.level_sweep_stream(qq, tiles, parent, win_off, win_w,
                                               root_unconditional=root)
            act1 = ops.level_sweep(qq, tiles, parent, root_unconditional=root)
            checks.expect(same(act2, act1), f"stream {structure} {precision}: kernel #2 mask "
                          f"== kernel #1 mask")
            del act1
            actp, skp = ops.level_sweep_stream_torch(qq, tiles, parent, win_off, win_w,
                                                     root_unconditional=root)
            checks.expect(same(act2, actp), f"stream {structure} {precision}: kernel #2 mask "
                          f"== plain version")
            del act2, actp
            total = win_off.numel()
            checks.expect(int(sk2) == int(skp) == r["skipped"],
                          f"stream {structure} {precision}: skipped tiles {int(sk2)} == plain "
                          f"rule {int(skp)} == AccessStats.tiles_skipped {r['skipped']} "
                          f"(of {total} level-tiles, win_w {win_w})")
            if structure in ("pyramid", "mqr"):
                checks.expect(int(sk2) > 0, f"stream {structure} {precision} skipped tiles")
            r["total_tiles"], r["win_w"] = total, win_w
        # the fourth instantiation: float32 tiles with uint16 parents
        s = trees["mqr"]["index"].schedule if "mqr" in trees else sched
        q = tq if "mqr" in trees else q_dev
        win_off, win_w = ops.stream_windows(s.parent, s.n_real, block_w=128, device=dev)
        if s.width <= 65535:
            p16 = s.parent.to(torch.uint16)
            got = ops.level_sweep_stream(q, s.mbr_cm, p16, win_off, win_w)
            want = ops.level_sweep_stream_torch(q, s.mbr_cm, p16, win_off, win_w)
            checks.expect(all(same(a, b) for a, b in zip(got, want)),
                          "level_sweep_stream float32 tiles + uint16 parents == plain version")

    checks.phase("stream results", stream_results)

    # -- 11. edge shapes of kernels #1-#3 ----------------------------------
    def edge_queries(d):
        """257 queries over ``d``: region queries sized for ~4 hits, every
        7th a box over the whole domain (every node overlaps it, so every
        parent gate is read) and every 11th from the 4th a point at an
        object's centre."""
        q = datasets.region_queries(d, max(EDGE_QUERIES), seed=args.seed)
        q[::7] = np.concatenate([d[:, :2].min(axis=0) - 1.0, d[:, 2:].max(axis=0) + 1.0])
        pick = d[np.arange(3, q.shape[0], 11) % d.shape[0]]
        c = np.stack([(pick[:, 0] + pick[:, 2]) * 0.5, (pick[:, 1] + pick[:, 3]) * 0.5], axis=1)
        q[3::11] = np.concatenate([c, c], axis=1)
        return torch.from_numpy(q.astype(np.float32)).to(dev)

    def edge_schedule(label, s, d):
        """#1, #2 and #3 against their plain versions, by equality, at every
        query count, block_w, tile and parent type and mode on one schedule;
        #2's skip count against the plain rule.  Returns (calls, calls of #2
        that took the prefix scan, failures)."""
        quant = ops.quantize_schedule(s, upper8=True)
        q_all = edge_queries(d)
        qq16_all = _quantize_queries(q_all, quant.origin, quant.inv_cell, quant.cells)
        qq8_all = _quantize_queries(q_all, quant.origin, quant.inv_cell8, quant.cells8)
        sp, levels = quant.split, s.levels
        p32, p16 = s.parent, quant.parent_q
        p32_16, p16_32 = p32.to(torch.uint16), p16.to(torch.int32)
        windows, calls, wide, bad = {}, 0, 0, []
        for nq in EDGE_QUERIES:
            q, qq16, qq8 = q_all[:nq], qq16_all[:nq], qq8_all[:nq]
            hier = (qq8, qq16, quant.mbr_q8, quant.mbr_q[sp:])
            for root in (False, True):
                for uncond in (None, 1, levels - 1):
                    kw = dict(root_unconditional=root, uncond_from=uncond)
                    want = {"f32": ops.level_sweep_torch(q, s.mbr_cm, p32, **kw),
                            "u16": ops.level_sweep_torch(qq16, quant.mbr_q, p16, **kw),
                            "hier": ops.level_sweep_hier_torch(*hier, p16, split=sp, **kw)}
                    tight = tight_n_real(want["hier"])
                    gated = levels > 1 and (uncond is None or uncond > 1)
                    for bw in EDGE_BLOCKS:
                        where = f"{label}, Q {nq}, block_w {bw}, root {root}, uncond {uncond}"
                        for name, got, key in (
                            ("#1 f32", ops.level_sweep(q, s.mbr_cm, p32, block_w=bw, **kw),
                             "f32"),
                            ("#1 u16 tiles, u16 parents", ops.level_sweep(
                                qq16, quant.mbr_q, p16, block_w=bw, **kw), "u16"),
                            ("#1 u16 tiles, i32 parents", ops.level_sweep(
                                qq16, quant.mbr_q, p16_32, block_w=bw, **kw), "u16"),
                            ("#3 u16 parents", ops.level_sweep_hier(
                                *hier, p16, split=sp, block_w=bw, **kw), "hier"),
                            ("#3 i32 parents, 0xFF output", hier_poisoned(
                                *hier, p16_32, split=sp, block_w=bw, **kw), "hier"),
                            ("#3 u16 parents, the schedule's n_real, 0xFF output",
                             hier_poisoned(*hier, p16, split=sp, block_w=bw, n_real=s.n_real,
                                           **kw), "hier"),
                            ("#3 i32 parents, the schedule's n_real, 0xFF output",
                             hier_poisoned(*hier, p16_32, split=sp, block_w=bw,
                                           n_real=s.n_real, **kw), "hier"),
                            ("#3 u16 parents, the tight n_real, 0xFF output", hier_poisoned(
                                *hier, p16, split=sp, block_w=bw, n_real=tight, **kw), "hier"),
                        ):
                            calls += 1
                            if not same(got, want[key]):
                                bad.append(f"{name} at {where}")
                        if (bw, uncond) not in windows:
                            windows[bw, uncond] = ops.stream_windows(
                                s.parent, s.n_real, block_w=bw, device=dev, uncond_from=uncond)
                        win_off, win_w = windows[bw, uncond]
                        plain = {}
                        for name, sweep_args, key in (
                            ("#2 f32", (q, s.mbr_cm, p32), "f32"),
                            ("#2 f32 tiles, u16 parents", (q, s.mbr_cm, p32_16), "f32"),
                            ("#2 u16 tiles, u16 parents", (qq16, quant.mbr_q, p16), "u16"),
                            ("#2 u16 tiles, i32 parents", (qq16, quant.mbr_q, p16_32), "u16"),
                        ):
                            if key not in plain:
                                plain[key] = ops.level_sweep_stream_torch(
                                    *sweep_args, win_off, win_w, block_w=bw, **kw)
                            act, skipped = ops.level_sweep_stream(
                                *sweep_args, win_off, win_w, block_w=bw, **kw)
                            calls += 1
                            wide += int(gated and win_w > EDGE_WIDE_WINDOW * bw)
                            if not (same(act, plain[key][0])
                                    and int(skipped) == int(plain[key][1])):
                                bad.append(f"{name} at {where} (skipped {int(skipped)}, "
                                           f"plain rule {int(plain[key][1])})")
        return calls, wide, bad

    def edge_shapes():
        from repro_torch.kernels.build import hilbert_permute

        t_phase = time.perf_counter()
        cases = []
        for w in EDGE_WIDTHS:
            d = datasets.uniform_squares(w, seed=args.seed + w)
            s = ops.device_schedule(d, device=dev)
            cases.append((f"pyramid W {w}", s, d))
            if w >= 129:  # scattered parents: wider windows
                cases.append((f"Hilbert-ordered pyramid W {w}", hilbert_permute(s), d))
        for structure, tr in trees.items():
            s = tr["index"].schedule
            cases.append((f"{structure} W {s.width}", s, tree_data))
        if "mqr" in trees:
            s = hilbert_permute(trees["mqr"]["index"].schedule)
            cases.append((f"Hilbert-ordered mqr W {s.width}", s, tree_data))
        total_wide = 0
        for label, s, d in cases:
            t = time.perf_counter()
            calls, wide, bad = edge_schedule(label, s, d)
            total_wide += wide
            for b in bad[:5]:
                print(f"    differs: {b}", flush=True)
            checks.expect(not bad, f"edge shapes, {label} (L {s.levels}): {calls - len(bad)} of "
                                   f"{calls} kernel calls == plain version ({wide} calls of #2 "
                                   f"on the prefix scan; {time.perf_counter() - t:.1f} s)")
        checks.expect(total_wide > 0, f"edge shapes: #2's prefix-scan path ran ({total_wide} "
                                      f"calls)")
        t = time.perf_counter()
        calls, bad = edge_hier_levels(ops, dev, args.seed)
        for b in bad[:5]:
            print(f"    differs: {b}", flush=True)
        checks.expect(not bad, f"edge shapes of #3 at L {EDGE_HIER_LEVELS}: {calls - len(bad)} "
                               f"of {calls} kernel calls == plain version "
                               f"({time.perf_counter() - t:.1f} s)")
        if "mqr" in trees:
            t = time.perf_counter()
            s = trees["mqr"]["index"].schedule
            quant = trees["mqr"]["index"].artifacts.quantized8
            q = edge_queries(tree_data)
            hier = (_quantize_queries(q, quant.origin, quant.inv_cell8, quant.cells8),
                    _quantize_queries(q, quant.origin, quant.inv_cell, quant.cells),
                    quant.mbr_q8, quant.mbr_q[quant.split:])
            bad = []
            for parent in (quant.parent_q, quant.parent_q.to(torch.int32)):
                for n_real in (None, s.n_real):
                    bad += [f"{what} ({parent.dtype} parents, n_real "
                            f"{'None' if n_real is None else 'given'})"
                            for what in hier_streams(ops, hier, parent, quant.split, n_real,
                                                     s.root_unconditional)]
            for b in bad[:5]:
                print(f"    differs: {b}", flush=True)
            checks.expect(not bad, f"#3 on the mqr-tree (Q {q.shape[0]}): calls back to back, "
                                   f"on two streams and one query after them == plain version "
                                   f"({time.perf_counter() - t:.1f} s)")
        t = time.perf_counter()
        calls, bad = edge_scans(ops, dev, args.seed)
        for b in bad[:5]:
            print(f"    differs: {b}", flush=True)
        checks.expect(not bad, f"edge shapes of #7: {calls - len(bad)} of {calls} scans (N in "
                               f"{EDGE_SCAN_N}, Q in {EDGE_SCAN_Q}, both layouts, block_n "
                               f"32-1024; +inf, NaN and subnormal rows) == plain version "
                               f"({time.perf_counter() - t:.1f} s)")
        t = time.perf_counter()
        calls, zero_signs, bad = edge_builds(ops, dev, args.seed)
        for b in bad[:5]:
            print(f"    differs: {b}", flush=True)
        checks.expect(not bad, f"edge shapes of #4: {calls - len(bad)} of {calls} builds (n "
                               f"{min(EDGE_BUILD_N)}-{max(EDGE_BUILD_N)}, L 1, 2, default and "
                               f"20; {', '.join(EDGE_BUILD_KINDS)} boxes) == plain version, "
                               f"float32 by its bits but for {zero_signs} zero bounds whose "
                               f"sign the plain version leaves to its atomics (C12); "
                               f"deterministic ({time.perf_counter() - t:.1f} s)")
        t = time.perf_counter()
        calls, bad = edge_quantize(ops, dev, args.seed)
        for b in bad[:5]:
            print(f"    differs: {b}", flush=True)
        checks.expect(not bad, f"edge shapes of #5: {calls - len(bad)} of {calls} calls (L in "
                               f"{EDGE_QUANT_L}, W in {EDGE_QUANT_W}; n_real None and given, "
                               f"uint8 tiles at splits 0-L, poisoned padding, bases off "
                               f"alignment, level slices; outputs filled 0x00 and 0xFF) == "
                               f"plain version, bit for bit ({time.perf_counter() - t:.1f} s)")
        t = time.perf_counter()
        calls, bad = edge_pairs(ops, dev, args.seed)
        for b in bad[:5]:
            print(f"    differs: {b}", flush=True)
        checks.expect(not bad, f"edge shapes of #6: {calls - len(bad)} of {calls} sweeps (Wa, "
                               f"Wb in {EDGE_PAIR_W}, K {EDGE_PAIR_K}, float32 and uint16, "
                               f"symmetric both ways) == plain version "
                               f"({time.perf_counter() - t:.1f} s)")
        print(f"  edge shapes: {time.perf_counter() - t_phase:.1f} s", flush=True)

    checks.phase("edge shapes of kernels #1-#7", edge_shapes)

    # -- join path: kernel #6 on the trees, a device pyramid, a live side --
    from repro_torch.index.join import lower_join
    from repro_torch.kernels.join_scan import count_true

    join_out = {}

    def join_path():
        mqr, rtree = trees["mqr"]["index"], trees["rtree"]["index"]
        t = time.perf_counter()
        pyr = SpatialIndex.build(datasets.exponential_squares(args.tree_n, seed=2),
                                 structure="pyramid", build="device")
        sync()
        print(f"  pyramid over exponential_squares({args.tree_n}, seed=2): L "
              f"{pyr.schedule.levels} W {pyr.schedule.width}, built in "
              f"{(time.perf_counter() - t) * 1e3:.1f} ms", flush=True)
        specs = [("mqr x rtree float32", mqr, rtree),
                 ("mqr x rtree compact", mqr.with_backend("cuda", precision="compact"), rtree),
                 ("mqr self-join", mqr, mqr),
                 ("pyramid x mqr", pyr, mqr)]
        if "mqr" in live_trees_idx:
            specs.append(("live mqr x rtree", live_trees_idx["mqr"], rtree))
        # counts are read around each join (its own row of the kernels
        # line), and their sum is the join path's
        paths["join"] = {}
        for label, left, right in specs:
            sync()
            _lib.counters.reset()
            t = time.perf_counter()
            res = left.join(right)
            sync()
            launches = _lib.counters.snapshot()
            join_out[label] = dict(left=left, right=right, result=res, launches=launches,
                                   first_ms=(time.perf_counter() - t) * 1e3)
            for name, count in launches.items():
                paths["join"][name] = paths["join"].get(name, 0) + count
        print(f"  launches {paths['join']}", flush=True)
        expect_launched("join", ("pair_sweep_f32", "pair_sweep_u16", "pair_sweep_sym"))

    def brute_pairs(left, right):
        """float32 closed-boundary overlap of the two live object sets,
        tombstones applied, in row chunks on the card."""
        def side(ix):
            log = ix._updates
            if log is None:
                table, alive = ix.artifacts.mbrs, np.ones((ix.artifacts.n_objects,), bool)
            else:
                table, alive = log.mbr_table, log.alive
            return (torch.from_numpy(table.astype(np.float32)).to(dev),
                    torch.from_numpy(alive).to(dev))

        (ta, aa), (tb, ab) = side(left), side(right)
        want = torch.empty((ta.shape[0], tb.shape[0]), dtype=torch.bool, device=dev)
        for i in range(0, ta.shape[0], 4096):
            rows = slice(i, i + 4096)
            want[rows] = (overlaps(ta[rows, None, :], tb[None, :, :])
                          & aa[rows, None] & ab[None, :])
        return want

    def join_results():
        for label, r in join_out.items():
            left, right, res = r["left"], r["right"], r["result"]
            want = brute_pairs(left, right)
            checks.expect(same(res.pairs, want),
                          f"{label}: pairs == brute-force float32 overlap of the live sets "
                          f"({int(count_true(want))} pairs)")
            del want
            jargs, k, sym = lower_join(left, right)
            sweep = (jargs[0], jargs[1], jargs[5], jargs[6])
            act = ops.pair_sweep(*sweep, symmetric=sym)
            plain = ops.pair_sweep_torch(*sweep, symmetric=sym)
            levels_equal = [same(act[l], plain[l]) for l in range(k)]
            err = max_abs_err(act, plain)
            checks.expect(all(levels_equal),
                          f"{label}: each of the {k} levels of kernel #6's mask == "
                          f"pair_sweep_torch (max_abs_err {err})")
            epilogue_args = (*jargs[2:5], *jargs[7:])
            _, plain_visits = ops.join_epilogue(plain, *epilogue_args, symmetric=sym)
            checks.expect(same(res.pair_visits, plain_visits),
                          f"{label}: pair_visits == plain version's")
            del plain
            # where a join's time goes: host lowering, the sweep, the epilogue
            sync()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            join_ms = wall_ms(lambda: left.join(right), 3)
            r["peak_gib"] = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
            r.update(
                k=k, wa=sweep[0].shape[2], wb=sweep[2].shape[2], tiles=str(sweep[0].dtype),
                symmetric=sym, sweep_args=sweep, n_pairs=res.n_pairs,
                pair_visits=res.pair_visits.tolist(),
                lower_ms=wall_ms(lambda: lower_join(left, right), 3),
                sweep_ms=time_ms(lambda: ops.pair_sweep(*sweep, symmetric=sym), 3),
                epilogue_ms=time_ms(lambda: ops.join_epilogue(act, *epilogue_args,
                                                              symmetric=sym), 3),
                join_ms=join_ms)
            del act, res, r["result"]  # a 50k x 50k pair mask each
            print(f"  {label}: K {k}, Wa {r['wa']}, Wb {r['wb']} ({r['tiles']}"
                  f"{', symmetric' if sym else ''}), {r['n_pairs']} pairs, pair tests "
                  f"{sum(r['pair_visits'])}; join {r['join_ms']:.2f} ms (first "
                  f"{r['first_ms']:.1f}): lowering {r['lower_ms']:.2f}, sweep "
                  f"{r['sweep_ms']:.3f}, epilogue {r['epilogue_ms']:.2f} ms; peak device "
                  f"memory over the resident set {r['peak_gib']:.2f} GiB", flush=True)

    checks.phase("join path", join_path)
    checks.phase("join results", join_results)

    # -- k-NN path: expanding-radius rounds through kernel #1 --------------
    knn_out = {}
    knn_k = 10

    def knn_path():
        sync()
        _lib.counters.reset()
        specs = [("pyramid", idx, points, data)]
        if "mqr" in trees:
            specs.append(("mqr", trees["mqr"]["index"], tree_points, tree_data))
        for label, ix, pts, d in specs:
            rounds = ix.stats.knn_rounds
            sync()
            t = time.perf_counter()
            res = ix.knn(pts, knn_k)
            sync()
            knn_out[label] = dict(index=ix, points=pts, data=d, result=res,
                                  first_ms=(time.perf_counter() - t) * 1e3,
                                  rounds=ix.stats.knn_rounds - rounds)
        sync()
        paths["knn"] = _lib.counters.snapshot()
        print(f"  launches {paths['knn']}", flush=True)
        expect_launched("knn", ("level_sweep_f32",))
        if "mqr" in trees:
            t = time.perf_counter()
            res = trees["mqr"]["index"].with_backend("host").knn(tree_points, knn_k)
            knn_out["mqr host"] = dict(result=res, points=tree_points, data=tree_data,
                                       first_ms=(time.perf_counter() - t) * 1e3)

    def mindist64(p, m):
        """float64 Euclidean point-to-MBR distance, broadcasting (..., 2)
        points against (..., 4) MBRs."""
        dx = torch.maximum(m[..., 0] - p[..., 0], p[..., 0] - m[..., 2]).clamp_min(0.0)
        dy = torch.maximum(m[..., 1] - p[..., 1], p[..., 1] - m[..., 3]).clamp_min(0.0)
        return torch.sqrt(dx * dx + dy * dy)

    def near_tie(d_got, d_want):
        """Where two ids at one rank may differ: their float64 distances
        differ, by at most 2.5e-4 (the rounding of float32 distances in a
        1000-unit world).  At an exact tie (distance 0 at a centroid query
        inside several objects, above all) the lowest id must come first."""
        diff = (d_got - d_want).abs()
        return (diff > 0) & (diff <= 2.5e-4)

    def check_knn(label, res, table64, pts):
        """ids equal the float64 brute force on the card (stable sort: ties
        by lowest id), except at a float32 near-tie (:func:`near_tie`);
        dists within 4 float32 ulp of the float64 ones."""
        tbl = torch.from_numpy(table64).to(dev)
        p = torch.from_numpy(np.asarray(pts, np.float64)).to(dev)
        want = torch.cat([torch.sort(mindist64(p[i:i + 32, None, :], tbl[None, :, :]),
                                     dim=1, stable=True).indices[:, :knn_k]
                          for i in range(0, p.shape[0], 32)])
        ids = res.ids.to(dev).long()
        d_got = mindist64(p[:, None, :], tbl[ids])
        d_want = mindist64(p[:, None, :], tbl[want])
        swapped = ids != want
        checks.expect(bool((~swapped | near_tie(d_got, d_want)).all()),
                      f"{label}: ids == float64 brute force, ties by lowest id "
                      f"({int(swapped.sum())} of {ids.numel()} differ, all float32 "
                      f"near-ties)")
        dists = res.dists.to(dev).double()
        checks.expect(bool(((dists - d_got).abs() <= 2.0 ** -21 * d_got).all()),
                      f"{label}: dists == float64 distances of the ids within 4 float32 ulp")
        return ids, d_got

    def knn_results():
        dev_ids = {}
        for label, r in knn_out.items():
            geometry = r["data"] if label == "mqr host" else (
                r["data"].astype(np.float32).astype(np.float64))
            dev_ids[label] = check_knn(label, r["result"], geometry, r["points"])
            if "rounds" in r:
                r["ms"] = wall_ms(lambda: r["index"].knn(r["points"], knn_k), 3)
                print(f"  {label} k-NN (k {knn_k}, {r['points'].shape[0]} points): "
                      f"{r['rounds']} rounds, {r['ms']:.2f} ms per call (first "
                      f"{r['first_ms']:.1f} ms), visits/point "
                      f"{float(r['result'].visits.sum()) / r['points'].shape[0]:.2f}",
                      flush=True)
            else:
                print(f"  {label} (knn_pointer, host Python): {r['first_ms']:.1f} ms",
                      flush=True)
        if "mqr host" in dev_ids:
            (host_ids, host_d), (card_ids, card_d) = dev_ids["mqr host"], dev_ids["mqr"]
            swapped = host_ids != card_ids
            checks.expect(bool((~swapped | near_tie(host_d, card_d)).all()),
                          f"mqr k-NN on the card == host pointer search "
                          f"({int(swapped.sum())} ids differ, all float32 near-ties)")

    checks.phase("k-NN path", knn_path)
    checks.phase("k-NN results", knn_results)

    # -- moving-object workload: a live 1e6-object pyramid, geofence joins --
    moving_out = {}

    def moving_oracle(w, res):
        """Region hits and join pairs a tick must answer: float32 overlap of
        the workload's current boxes, at each object's current global id.
        Returns (region hits == oracle, extra region hits, pairs == oracle)."""
        boxes = torch.from_numpy(w.boxes().astype(np.float32)).to(dev)
        gid = torch.from_numpy(w.gid).to(dev)
        q = torch.from_numpy(w.queries).to(dev)
        zones = torch.from_numpy(w.zone_mbrs.astype(np.float32)).to(dev)
        n_id = w.query_index.id_space
        hits = torch.zeros((q.shape[0], n_id), dtype=torch.bool, device=dev)
        hits[:, gid] = overlaps(boxes[None, :, :], q[:, None, :])
        pairs = torch.zeros((n_id, zones.shape[0]), dtype=torch.bool, device=dev)
        pairs[gid] = overlaps(boxes[:, None, :], zones[None, :, :])
        got = res.region.hits
        covered = not bool((hits & ~got).any())
        return same(got, hits), covered, int((got & ~hits).sum()), same(res.join.pairs, pairs)

    def run_ticks(w, ticks, label, exact_region=True, keep=0):
        """``ticks`` ticks of ``w``, each checked against the brute force:
        join pairs exactly; region hits exactly on a live index, and on a
        pristine pyramid (the rebuild baseline) as a cover, its deepest
        groups being the membership test (phase 3)."""
        seconds, bad, extra, tests, views = [], [], 0, 0, []
        for _ in range(ticks):
            sync()
            t = time.perf_counter()
            res = w.tick()
            sync()
            seconds.append(time.perf_counter() - t)
            exact, covered, n_extra, pairs_ok = moving_oracle(w, res)
            extra += n_extra
            if not pairs_ok or not (exact if exact_region else covered):
                bad.append(res.tick)
            tests += sum(res.join.pair_visits.tolist())
            if len(views) < keep:
                gid = torch.from_numpy(w.gid).to(dev)
                views.append((res.region.hits[:, gid], res.join.pairs[gid]))
        how = "exact" if exact_region else "cover"
        checks.expect(not bad, f"{label}: every tick's join pairs and region hits == brute "
                               f"force over the current boxes ({how}; {extra} extra region "
                               f"hits; bad ticks {bad})")
        return seconds, tests, views, res

    def moving_kernels(w, last):
        """The last live tick's kernels against their plain versions at this
        path's shapes: #6 per level and the join's visits, the live region
        sweep (#1, Q = 4) and the last merge's device build (#4)."""
        jargs, k, sym = lower_join(w.index, w.zones)
        sweep = (jargs[0], jargs[1], jargs[5], jargs[6])
        act = ops.pair_sweep(*sweep, symmetric=sym)
        plain = ops.pair_sweep_torch(*sweep, symmetric=sym)
        err = max_abs_err(act, plain)
        checks.expect(all(same(act[l], plain[l]) for l in range(k)),
                      f"moving, last tick: each of the {k} levels of kernel #6's "
                      f"({sweep[0].shape[2]} x {sweep[2].shape[2]}) mask == pair_sweep_torch "
                      f"(max_abs_err {err})")
        _, plain_visits = ops.join_epilogue(plain, *jargs[2:5], *jargs[7:], symmetric=sym)
        checks.expect(same(last.join.pair_visits, plain_visits),
                      "moving, last tick: pair_visits == join_epilogue on the plain mask")
        del act, plain
        # the narrow-side path at this shape with uint16 tiles, and symmetric
        cargs, _, _ = lower_join(w.index.with_backend("cuda", precision="compact", **FIXED),
                                 w.zones)
        zs = w.zones.artifacts.schedule.to(dev)
        for what, args_, sym_ in (("u16 tiles", (cargs[0], cargs[1], cargs[5], cargs[6]), False),
                                  ("the zones' symmetric self-sweep",
                                   (zs.mbr_cm, zs.parent, zs.mbr_cm, zs.parent), True)):
            got_, want_ = (ops.pair_sweep(*args_, symmetric=sym_),
                           ops.pair_sweep_torch(*args_, symmetric=sym_))
            checks.expect(same(got_, want_), f"moving: kernel #6 with {what} "
                                             f"({args_[0].shape[2]} x {args_[2].shape[2]}) == "
                                             f"pair_sweep_torch (max_abs_err "
                                             f"{max_abs_err(got_, want_)})")
        del cargs, got_, want_
        q = torch.from_numpy(w.queries).to(dev)
        hits, visits = live_plain(w.index, "float32", q)
        checks.expect(same(last.region.hits, hits)
                      and same(last.region.visits_per_level, visits),
                      f"moving, last tick: live region sweep (Q = {q.shape[0]}) hits and "
                      f"visits == plain path")
        log = w.index._updates
        base = log.base.schedule
        rows = torch.from_numpy(log.mbr_table[log.base_gids].astype(np.float32)).to(dev)
        got = ops.build_levels(rows, levels=base.levels)
        want = ops.build_levels_torch(rows, levels=base.levels)
        checks.expect(all(same_bits(a, b) for a, b in zip(got, want))
                      and same_bits(got[1], base.mbr_cm) and same(got[2], base.parent),
                      f"moving: kernel #4 over the last merge's {rows.shape[0]} rows == plain "
                      f"version by bits (max_abs_err "
                      f"{max(max_abs_err(a, b) for a, b in zip(got, want))}) and == the live "
                      f"base schedule")
        return sweep, k, sym

    def moving_path():
        from repro_torch.launch.moving import MovingConfig, MovingWorkload

        cfg = MovingConfig(n_objects=args.moving_n, moves_per_tick=1_000, n_zones=12,
                           query_every=1, seed=args.seed)
        sync()
        _lib.counters.reset()
        t = time.perf_counter()
        w = MovingWorkload(cfg, structure="pyramid", build="device", capacity=4_096, **FIXED)
        sync()
        setup_ms = (time.perf_counter() - t) * 1e3
        seconds, tests, views, last = run_ticks(w, args.ticks, "moving, live", keep=3)
        sync()
        paths["moving"] = _lib.counters.snapshot()
        print(f"  launches {paths['moving']}", flush=True)
        expect_launched("moving", ("build_levels", "level_sweep_f32", "pair_sweep_f32"))
        sweep, k, sym = moving_kernels(w, last)
        del last
        st = w.index.stats
        checks.expect(st.flushes >= 1, f"the moving workload merged ({st.flushes} merges)")
        moving_out.update(
            sweep_args=sweep, k=k, symmetric=sym, workload=w, setup_ms=setup_ms, ticks=args.ticks, tick_ms=[x * 1e3 for x in seconds],
            ticks_per_s=args.ticks / sum(seconds), merges=st.flushes, pair_tests=tests,
            joins=st.joins, inserts=st.inserts, deletes=st.deletes)
        base = MovingWorkload(cfg, structure="pyramid", build="device", rebuild_per_tick=True,
                              **FIXED)
        b_seconds, _, b_views, _ = run_ticks(base, 3, "moving, rebuild_per_tick",
                                             exact_region=False, keep=3)
        checks.expect(len(b_views) == 3 and all(
            same(a[1], b[1]) and not bool((a[0] & ~b[0]).any())
            for a, b in zip(views, b_views)),
            "rebuild_per_tick gives the live path's join pairs per object slot, and "
            "its region hits cover the live path's (3 ticks)")
        moving_out["rebuild_ticks_per_s"] = 3 / sum(b_seconds)
        print(f"  {args.moving_n} objects, {args.ticks} ticks of 1,000 moves: "
              f"{moving_out['ticks_per_s']:.2f} ticks/s (setup {setup_ms:.0f} ms; ticks "
              f"median {statistics.median(moving_out['tick_ms']):.1f} ms, max "
              f"{max(moving_out['tick_ms']):.1f} ms), {st.flushes} merges, {tests} pair "
              f"tests; rebuild_per_tick {moving_out['rebuild_ticks_per_s']:.2f} ticks/s",
              flush=True)

    checks.phase("moving-object workload", moving_path)

    # -- durability and the serving ladder: snapshots, serve, faults, WAL --
    dur_out = {}

    def timed(fn):
        """``fn()`` and its host window ending in a synchronize, in ms."""
        sync()
        t = time.perf_counter()
        r = fn()
        sync()
        return r, (time.perf_counter() - t) * 1e3

    def no_rebuild(launched, what):
        built = {k: launched.get(k, 0) for k in ("build_levels", "quantize_cm")}
        checks.expect(not any(built.values()),
                      f"{what}: load launched no build or quantize kernel ({built})")

    def snapshots(tmp):
        """save + load of a pristine float32, a pristine compact and a live
        (mid-buffer) index of the pyramid path onto the card."""
        rng = np.random.default_rng(args.seed + 11)
        live = idx.extend(datasets.uniform_squares(200, seed=args.seed + 12))
        live.delete(np.concatenate([rng.choice(args.n, 500, replace=False),
                                    np.arange(args.n, args.n + 20)]))
        cases = (("float32", idx, {}, out["float32"]["region"]),
                 ("compact", out["compact"]["index"], {"precision": "compact"},
                  out["compact"]["region"]),
                 ("live float32", live, {}, live.region(q_dev)))
        rows = {}
        for label, ix, opts, ref in cases:
            path = tmp / label.replace(" ", "_")
            _, save_ms = timed(lambda: ix.save(path))
            nbytes = sum(f.stat().st_size for f in path.iterdir())
            _lib.counters.reset()
            back, load_ms = timed(lambda: SpatialIndex.load(path, **FIXED, **opts))
            no_rebuild(_lib.counters.snapshot(), f"snapshot {label}")
            res = back.region(q_dev)
            checks.expect(same(res.hits, ref.hits) and same(res.visits_per_level,
                                                            ref.visits_per_level),
                          f"snapshot {label}: loaded hits and visits == the saved index's")
            checks.expect(back.n_objects == ix.n_objects and back.id_space == ix.id_space,
                          f"snapshot {label}: live objects and id space == the saved index's")
            rows[label] = dict(bytes=nbytes, save_ms=save_ms, load_ms=load_ms)
            print(f"  snapshot {label}: {nbytes:,} bytes, save {save_ms:.1f} ms, load "
                  f"{load_ms:.1f} ms (host time: npz, fsync, copies)  [{card}]", flush=True)
            del back, res
            shutil.rmtree(path)
        dur_out["snapshots"] = rows

    def serve_healthy():
        """The serve backend over the pyramid: a Q batch, the same batch
        from the cache, and a pristine compact8 server."""
        sv = idx.with_backend("serve", cache_size=2 * args.queries)
        server = sv._backend.server
        ref = out["float32"]["region"]
        r1, ms1 = timed(lambda: sv.region(q_dev))
        r2, ms2 = timed(lambda: sv.region(q_dev))
        for what, r in (("first", r1), ("cached", r2)):
            checks.expect(same(r.hits, ref.hits) and same(r.visits_per_level,
                                                          ref.visits_per_level),
                          f"serve {what} batch: hits and visits == the cuda backend's")
        st = sv.stats
        distinct = len({q.tobytes() for q in queries})
        checks.expect(st.rung_dispatches == {"cuda": 1} and server.stats.cache_hits
                      == distinct and st.launch_failures == st.retries
                      == st.degraded_batches == 0,
                      f"serve: one batch on cuda, the second wholly from the cache, no "
                      f"failure ({st.rung_dispatches}, cache hits {server.stats.cache_hits}, "
                      f"failures {st.launch_failures}, retries {st.retries})")
        # the same first batch on a server with no cache: the cache's share
        sv0 = idx.with_backend("serve", cache_size=0)
        r0, ms0 = timed(lambda: sv0.region(q_dev))
        checks.expect(same(r0.hits, ref.hits) and sv0.stats.rung_dispatches == {"cuda": 1},
                      "serve, no cache: hits == the cuda backend's, on cuda")
        del sv0, r0
        sv8 = idx.with_backend("serve", precision="compact8", cache_size=0)
        r8, ms8 = timed(lambda: sv8.region(q_dev))
        ref8 = out["compact8"]["region"]
        checks.expect(same(r8.hits, ref8.hits) and same(r8.visits_per_level,
                                                        ref8.visits_per_level)
                      and sv8.stats.rung_dispatches == {"cuda": 1}
                      and sv8.stats.launch_failures == 0,
                      "serve compact8: hits and visits == the cuda backend's, on cuda")
        dur_out["serve"] = dict(first_ms=ms1, cached_ms=ms2, no_cache_ms=ms0, compact8_ms=ms8,
                                cache_bytes=server.cache_bytes, cache_rows=len(server._cache))
        print(f"  serve Q {args.queries} (host windows): first batch {ms1:.2f} ms, same batch "
              f"from the cache {ms2:.2f} ms, first batch with no cache {ms0:.2f} ms; cache "
              f"{len(server._cache)} rows = {server.cache_bytes:,} bytes on the card; compact8 "
              f"{ms8:.2f} ms  [{card}]", flush=True)
        del sv, sv8, r1, r2, r8

    def serve_forced():
        """16-query batches with injected failures: the torch and host rungs
        answer as the cuda rung, and the ledger counts what was injected."""
        from repro_torch.ft import FaultPlan

        qa, qb = q_dev[:16], q_dev[16:32]
        want = {id(q): idx.region(q) for q in (qa, qb)}

        def served(plan):
            s = idx.with_backend("serve", cache_size=0, backoff=0.0)
            s.bind_fault_plan(plan)
            return s

        def run(s, q):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                r, ms = timed(lambda: s.region(q))
            w = want[id(q)]
            return same(r.hits, w.hits) and same(r.visits_per_level, w.visits_per_level), ms

        rung_ms = {}
        healthy = served(None)
        ok, _ = run(healthy, qa)
        ok2, rung_ms["cuda"] = run(healthy, qb)
        checks.expect(ok and ok2 and healthy.stats.rung_dispatches == {"cuda": 2},
                      "serve, healthy 16-query batches: on cuda, == the cuda backend")
        for rungs, answered, fails in ((("cuda",), "torch", 3), (("cuda", "torch"), "host", 6)):
            plan = FaultPlan(fail_launches=fails, fail_rungs=rungs)
            s = served(plan)
            ok, first_ms = run(s, qa)
            ok2, rung_ms[answered] = run(s, qb)  # the sticky floor: straight to the rung
            st = s.stats
            checks.expect(ok and ok2 and st.rung_dispatches == {answered: 2}
                          and st.launch_failures == plan.launch_failures == fails
                          and st.retries == fails - len(rungs) and st.degraded_batches == 2,
                          f"serve, {rungs} failing: the {answered} rung answers == the cuda "
                          f"rung; failures {st.launch_failures} (injected "
                          f"{plan.launch_failures}), retries {st.retries}, degraded "
                          f"{st.degraded_batches}, {st.rung_dispatches}")
            rung_ms[f"{answered} first"] = first_ms
        plan = FaultPlan(fail_launches=3, fail_rungs=("cuda",), fail_from_launch=2)
        s = served(plan)
        oks = [run(s, q)[0] for q in (qa, qb, qa)]
        mid = dict(s.stats.rung_dispatches)
        s._backend.server.reset_health()
        oks.append(run(s, qb)[0])
        checks.expect(all(oks) and mid == {"cuda": 2, "torch": 1}
                      and s.stats.rung_dispatches == {"cuda": 3, "torch": 1}
                      and s.stats.launch_failures == plan.launch_failures == 3,
                      f"serve, fail_from_launch=2: two batches on cuda, the third degraded "
                      f"to torch ({mid}), reset_health back to cuda "
                      f"({s.stats.rung_dispatches}); every answer == the cuda rung")
        dur_out["rung_ms"] = rung_ms
        print("  serve, 16-query batch by rung (host windows): " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in rung_ms.items())
            + f" (host rung: numpy on the host, its first batch copies the arrays)  [{card}]",
            flush=True)
        mqr, rtree = trees["mqr"]["index"], trees["rtree"]["index"]
        want_pairs = mqr.join(rtree).pairs
        for plan, answered in ((None, "cuda"),
                               (FaultPlan(fail_launches=1, fail_rungs=("cuda",)), "torch")):
            left = mqr.with_backend("serve")
            left.bind_fault_plan(plan)
            res, ms = timed(lambda: left.join(rtree))
            checks.expect(same(res.pairs, want_pairs)
                          and left.stats.rung_dispatches == {answered: 1}
                          and left.stats.launch_failures == (0 if plan is None else 1),
                          f"serve join mqr x rtree on the {answered} rung: pairs == the cuda "
                          f"backend's ({ms:.1f} ms)")
            del res
        del want_pairs

    def run_mutations(d, ops_, upto=None):
        """The workload's ops on a DurableIndex or a SpatialIndex; deletes
        take the lowest live ids."""
        def lowest(k):
            log = getattr(d, "index", d)._updates
            lids = (np.nonzero(log.alive)[0] if log is not None
                    else np.arange(getattr(d, "index", d).n_objects))
            return lids[:min(k, lids.size)]

        merged = []
        for i, (op, arg) in enumerate(ops_[:upto]):
            before = d.stats.flushes
            if op == "insert":
                d.insert(arg)
            elif op == "delete":
                d.delete(lowest(arg))
            else:
                d.flush()
            if d.stats.flushes > before:
                merged.append(i)
        return merged

    def durability(tmp):
        from repro_torch.checkpoint import DurableIndex, mutation_workload
        from repro_torch.ft import FaultPlan, KillPoint
        from repro_torch.update import WriteAheadLog

        n_ops = 200
        base, ops_ = mutation_workload(n_ops, seed=args.seed, base_n=args.n)
        opts = dict(structure="pyramid", build="device", precision="compact",
                    capacity=4_096, **FIXED)
        clean = SpatialIndex.build(base, **opts)
        merged = run_mutations(clean, ops_)
        checks.expect(len(merged) >= 2, f"the workload merged at least twice ({merged})")
        kills = ((n_ops // 3, "post-append", False), (merged[len(merged) // 2], "mid-merge",
                                                       False), (n_ops - 7, "post-append", True))
        recovered = []
        for k, site, torn in kills:
            root = tmp / f"d{k}{site}{int(torn)}"
            plan = FaultPlan(kill_at_op=k, kill_site=site, torn_write=torn)
            d = DurableIndex.create(base, root, fault_plan=plan, **opts)
            try:
                run_mutations(d, ops_)
                killed = False
            except KillPoint:
                killed = True
            d.close()
            del d
            r, rec_ms = timed(lambda: DurableIndex.recover(root))
            expect = k if torn else k + 1
            checks.expect(killed and r.ops_total == expect and r.recovered_ops == expect
                          and r.recovered_torn == torn,
                          f"kill at op {k} ({site}{', torn write' if torn else ''}): recovered "
                          f"{r.ops_total} ops (replayed {r.recovered_ops}, torn "
                          f"{r.recovered_torn}) in {rec_ms:.1f} ms")
            recovered.append((r, expect, rec_ms, f"op {k} {site}{' torn' if torn else ''}"))
        # the clean run's state at each surviving prefix, compared in order
        ref = SpatialIndex.build(base, **opts)
        done = 0
        for r, expect, rec_ms, label in sorted(recovered, key=lambda x: x[1]):
            run_mutations(ref, ops_[done:expect])
            done = expect
            a, b = r.index, ref
            log_a, log_b = a._updates, b._updates
            checks.expect(np.array_equal(log_a.alive, log_b.alive)
                          and np.array_equal(log_a.mbr_table, log_b.mbr_table),
                          f"recovered ({label}): live ids and object table == the un-killed run")
            sa, sb = a.schedule, b.schedule
            checks.expect(all(same_bits(getattr(sa, f), getattr(sb, f)) for f in (
                "mbr_cm", "obj_mbr")) and all(same(getattr(sa, f), getattr(sb, f)) for f in (
                    "parent", "n_real", "obj_level", "obj_slot", "obj_id")),
                f"recovered ({label}): base schedule == the un-killed run's, bit for bit")
            ra, rb = a.region(q_dev), b.region(q_dev)
            checks.expect(same(a.artifacts.quantized.mbr_q, b.artifacts.quantized.mbr_q),
                          f"recovered ({label}): quantized tiles == the un-killed run's")
            checks.expect(np.array_equal(ra.hits.cpu().numpy(), brute_live(log_a, queries))
                          and same(ra.hits, rb.hits)
                          and same(ra.visits_per_level, rb.visits_per_level),
                          f"recovered ({label}): Q {args.queries} hits == brute force over the "
                          f"live ids and == the un-killed run, visits too")
            dur_out.setdefault("recover_ms", {})[label] = rec_ms
            dur_out.setdefault("replayed", {})[label] = r.recovered_ops
            r.close()
        del recovered, ref, clean
        rates = {}
        for sync_, count in ((True, 200), (False, 2_000)):
            rows = datasets.uniform_squares(4, seed=1)
            with WriteAheadLog(tmp / f"bench{int(sync_)}.log", sync=sync_) as w:
                t = time.perf_counter()
                for _ in range(count):
                    w.append("insert", rows)
                rates[sync_] = count / (time.perf_counter() - t)
        dur_out["wal_appends_per_s"] = {"sync": rates[True], "no_sync": rates[False]}
        print(f"  WAL appends/s (host; 4-row inserts): sync=True {rates[True]:.0f}, "
              f"sync=False {rates[False]:.0f}; recover ms "
              f"{ {k: round(v, 1) for k, v in dur_out['recover_ms'].items()} }, ops replayed "
              f"{dur_out['replayed']}  [{card}]", flush=True)

    def durability_path():
        sync()
        t_phase = time.perf_counter()
        _lib.counters.reset()
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            checks.phase("  snapshots", lambda: snapshots(tmp))
            checks.phase("  serve backend, healthy", serve_healthy)
            checks.phase("  serve backend, forced rungs", serve_forced)
            checks.phase("  durability: create, kill, recover", lambda: durability(tmp))
        sync()
        torch.cuda.empty_cache()
        paths["durability"] = _lib.counters.snapshot()
        dur_out["phase_s"] = time.perf_counter() - t_phase
        print(f"  launches {paths['durability']}; the phase took {dur_out['phase_s']:.1f} s",
              flush=True)
        expect_launched("durability", ("build_levels", "quantize_cm", "level_sweep_f32",
                                       "level_sweep_u16", "level_sweep_hier",
                                       "pair_sweep_f32"))

    checks.phase("durability and serving ladder", durability_path)

    # -- the serving front end (repro_torch.serve) over three tenants ----------
    front_out = {}
    checks.phase("serving front end", lambda: front_out.update(
        front_end_phase(args, checks, dev, card, data, queries, points, paths)))

    # -- mqr-KV block selection and the attention and norm kernels (#8-#10) --
    # llama3.2-1B's widths (src/repro/configs/llama32_1b.py) and its mqr-KV
    # settings (src/repro/models/transformer.py: mqr_block, mqr_topk,
    # mqr_levels); random inputs from the seed, no weights.
    D_MODEL, HEADS, KV_HEADS, HEAD_DIM = 2048, 32, 8, 64
    MQR_BLOCK, MQR_TOPK, MQR_LEVELS = 128, 64, 6
    NORM_ROWS = PREFILL = args.prefill
    DEC_B, DEC_S = 4, args.kv_len
    dec_pos = DEC_S - 37  # the last block is partly masked
    attn_out = {}

    def attention_path():
        from repro_torch.core import kvindex

        gen = torch.Generator(device=dev).manual_seed(args.seed)

        def randn(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device=dev) * scale

        group = HEADS // KV_HEADS
        nb = DEC_S // MQR_BLOCK
        x = randn(NORM_ROWS, D_MODEL)
        norm_scale = 1.0 + randn(D_MODEL, scale=0.1)
        # prefill: B 1, kv heads broadcast to the query heads, (BH, S, D)
        pq = randn(HEADS, PREFILL, HEAD_DIM)
        pk, pv = (randn(KV_HEADS, PREFILL, HEAD_DIM).repeat_interleave(group, 0)
                  for _ in range(2))
        # decode: a (B, S, Hkv, Dh) bf16 cache, f32 probes, one query per head
        keys = randn(DEC_B, DEC_S, KV_HEADS, HEAD_DIM).to(torch.bfloat16)
        values = randn(DEC_B, DEC_S, KV_HEADS, HEAD_DIM).to(torch.bfloat16)
        probes = randn(KV_HEADS, HEAD_DIM)
        dq = randn(DEC_B, HEADS, HEAD_DIM)

        def blocks(cache):  # (B, S, Hkv, Dh) -> (B*H, nb, bs, Dh), kv broadcast
            c = cache.permute(0, 2, 1, 3).reshape(DEC_B, KV_HEADS, 1, nb, MQR_BLOCK, HEAD_DIM)
            return c.expand(-1, -1, group, -1, -1, -1).reshape(
                DEC_B * HEADS, nb, MQR_BLOCK, HEAD_DIM)

        kb_bf, vb_bf = blocks(keys), blocks(values)
        kb_f, vb_f = kb_bf.float(), vb_bf.float()
        qd = dq.reshape(DEC_B * HEADS, HEAD_DIM)
        q_bf = qd.to(torch.bfloat16)
        pos_t = torch.full((), dec_pos, dtype=torch.int32, device=dev)

        def build():
            return [[kvindex.build_kv_index(keys[b, :, g], probes[g], MQR_BLOCK, MQR_LEVELS)
                     for g in range(KV_HEADS)] for b in range(DEC_B)]

        def regions():
            return [[kvindex.query_region(dq[b, g * group:(g + 1) * group], probes[g],
                                          pos_t + 1) for g in range(KV_HEADS)]
                    for b in range(DEC_B)]

        def select(index, regs):
            return torch.stack([torch.stack([
                kvindex.select_blocks_batched(index[b][g].block_mbr, index[b][g].pyramid,
                                              regs[b][g], MQR_TOPK)
                for g in range(KV_HEADS)]) for b in range(DEC_B)]).reshape(
                    DEC_B * HEADS, MQR_TOPK)

        sync()
        _lib.counters.reset()
        normed = {dt: ops.rmsnorm(x.to(dt), norm_scale) for dt in (torch.float32, torch.bfloat16)}
        prefill = {dt: ops.flash_attention(pq.to(dt), pk.to(dt), pv.to(dt))
                   for dt in (torch.float32, torch.bfloat16)}
        index = build()
        regs = regions()
        ids = select(index, regs)
        dec = {torch.bfloat16: ops.mqr_sparse_attention(q_bf, kb_bf, vb_bf, ids, pos_t),
               torch.float32: ops.mqr_sparse_attention(qd, kb_f, vb_f, ids, pos_t)}
        sync()
        paths["attention"] = _lib.counters.snapshot()
        print(f"  launches {paths['attention']}", flush=True)
        expect_launched("attention", [f"{k}_{d}" for k in ("rmsnorm", "flash_attention",
                                                            "mqr_sparse_attention")
                                      for d in ("f32", "bf16")])
        for what, outs, shape in (("rmsnorm", normed, (NORM_ROWS, D_MODEL)),
                                  ("flash_attention", prefill, (HEADS, PREFILL, HEAD_DIM)),
                                  ("mqr_sparse_attention", dec, (DEC_B * HEADS, HEAD_DIM))):
            checks.expect(all(o.shape == shape and o.dtype == dt
                              and bool(o.float().isfinite().all()) for dt, o in outs.items()),
                          f"{what}: finite {shape} outputs in float32 and bfloat16")
        def check_selection(label, index, regs, ids):
            """The card's ids == select_blocks on the CPU, and its survivor
            mask == pyramid_search on the CPU, given the same block MBRs,
            pyramids and regions; survivors come first.  Returns the number
            of survivors of each query head."""
            cpu_ids, mask_ok, order_ok, counts = [], True, True, []
            for b in range(DEC_B):
                for g in range(KV_HEADS):
                    ix = index[b][g]
                    cix = kvindex.KVIndex(ix.block_mbr.cpu(), ix.pyramid._replace(
                        group_of=ix.pyramid.group_of.cpu(),
                        group_mbr=ix.pyramid.group_mbr.cpu()))
                    reg = regs[b][g].cpu()
                    cpu_ids.append(kvindex.select_blocks(cix, reg, MQR_TOPK))
                    surv = bulk.pyramid_search(ix.pyramid, regs[b][g])  # (group, nb)
                    mask_ok &= same(surv.cpu(), bulk.pyramid_search(cix.pyramid, reg))
                    got = ids.reshape(DEC_B, KV_HEADS, group, MQR_TOPK)[b, g].long()
                    first = surv.gather(1, got)
                    counts += surv.sum(1).tolist()
                    # once a non-survivor is taken, no survivor follows it
                    order_ok &= bool((first[:, 1:] <= first[:, :-1]).all())
                    order_ok &= bool((first.sum(1) == surv.sum(1).clamp(max=MQR_TOPK)).all())
            cpu_ids = torch.stack(cpu_ids).reshape(DEC_B * HEADS, MQR_TOPK)
            checks.expect(same(ids.cpu(), cpu_ids),
                          f"{label}: ids on the card ({tuple(ids.shape)}) == select_blocks on "
                          f"the CPU over the same block MBRs, pyramids and regions")
            checks.expect(mask_ok, f"{label}: the region search's survivor mask on the card "
                                   f"== pyramid_search on the CPU")
            checks.expect(order_ok, f"{label}: survivors of the region search first")
            return counts

        counts = check_selection("mqr-KV", index, regs, ids)
        mean_surv = sum(counts) / len(counts)
        # Random keys span every block's score band, so there every block
        # survives and selection goes by overlap area alone.  A cache whose
        # scores drift with position (k . probe = 256 t / S plus noise, one
        # unit per block) makes the region search prune, and pads the top K
        # with zero-area ties.
        t_pos = torch.arange(DEC_S, dtype=torch.float32, device=dev)
        unit = probes / probes.pow(2).sum(-1, keepdim=True)  # k . probe = 1
        drift = (randn(DEC_B, DEC_S, KV_HEADS, HEAD_DIM, scale=0.1)
                 + (256.0 * t_pos / DEC_S)[None, :, None, None] * unit).to(torch.bfloat16)
        d_index = [[kvindex.build_kv_index(drift[b, :, g], probes[g], MQR_BLOCK, MQR_LEVELS)
                    for g in range(KV_HEADS)] for b in range(DEC_B)]
        d_counts = check_selection("drifting scores", d_index, regs, select(d_index, regs))
        checks.expect(max(d_counts) < nb,
                      f"drifting scores: the region search prunes for every head "
                      f"({sum(d_counts) / len(d_counts):.1f} of {nb} blocks survive on "
                      f"average, {min(d_counts)} to {max(d_counts)})")
        del drift, d_index

        def step(_):  # one decode step: index build, selection, attention (bf16)
            return ops.mqr_sparse_attention(q_bf, kb_bf, vb_bf,
                                            select(build(), regions()), pos_t)

        attn_out.update(
            step=step, x=x, norm_scale=norm_scale, prefill_in=(pq, pk, pv), qd=qd, ids=ids,
            pos=pos_t, kb=(kb_bf, vb_bf), kbf=(kb_f, vb_f),
            selected_frac=MQR_TOPK / nb, survivor_frac=mean_surv / nb,
            build_ms=wall_ms(build), select_ms=wall_ms(lambda: select(index, regions())))
        all_ids = torch.arange(nb, dtype=torch.int32, device=dev).expand(
            DEC_B * HEADS, nb).contiguous()
        attn_out["attend_ms"] = time_ms(
            lambda: ops.mqr_sparse_attention(q_bf, kb_bf, vb_bf, ids, pos_t))
        attn_out["attend_all_ms"] = time_ms(
            lambda: ops.mqr_sparse_attention(q_bf, kb_bf, vb_bf, all_ids, pos_t))
        attn_out["dense_plain_ms"] = time_ms(
            lambda: ops.mqr_sparse_attention_torch(q_bf, kb_bf, vb_bf, all_ids, pos_t))
        dense = ops.mqr_sparse_attention_torch(qd, kb_f, vb_f, all_ids, pos_t)
        attn_out["sparse_vs_dense"] = float((dec[torch.float32] - dense).abs().max())
        print(f"  decode B {DEC_B}, S {DEC_S} ({nb} blocks of {MQR_BLOCK}), pos {dec_pos}: "
              f"{MQR_TOPK} blocks attended per head ({attn_out['selected_frac']:.3f} of the "
              f"cache), {mean_surv:.1f} region survivors per head on average; per step: "
              f"index build {attn_out['build_ms']:.2f} ms ({DEC_B * KV_HEADS} indexes), "
              f"selection {attn_out['select_ms']:.2f} ms, attention (#9, bf16) "
              f"{attn_out['attend_ms']:.3f} ms; #9 over all {nb} blocks "
              f"{attn_out['attend_all_ms']:.3f} ms; plain dense decode over all {nb} blocks "
              f"{attn_out['dense_plain_ms']:.3f} ms; max |sparse - dense| (f32) "
              f"{attn_out['sparse_vs_dense']:.4f}", flush=True)

    checks.phase("mqr-KV and attention kernels", attention_path)

    # -- LLM serving: llama3.2-1B at full width through the models ---------
    llm_out = {}
    checks.phase("LLM serving (llama3.2-1B, full width)", lambda: llm_out.update(
        llm_phase(args, checks, dev, card, paths)))
    families_out, family_sparse = {}, {}
    checks.phase("LLM families (granite-moe-1b, DeepSeek-V3 cut, mamba2-2.7b, "
                 "recurrentgemma-9b, gemma-2b, granite-8b, internvl2-2b, musicgen-large, "
                 "command-r-35b cut; full width)", lambda: families_out.update(
                     families_phase(args, checks, dev, card, paths, family_sparse)))

    # -- training: llama3.2-1B at full width, #8 and #10 backward ------------
    train_out = {}
    checks.phase("training (llama3.2-1B, full width; checkpoint, resume, EF-int8, "
                 "float32 against the CPU; gemma-2b, full width)", lambda: train_out.update(
                     train_phase(args, checks, dev, card, paths)))
    dry_rows = [r for r in llm_out.get("dryrun", []) + train_out.get("dryrun", []) if r]
    mesh_out = llm_out.get("mesh") or {}
    dry_s = sum(r["seconds"] for r in dry_rows) + mesh_out.get("mesh_s", 0.0) \
        + mesh_out.get("router_ms", 0.0) / 1e3
    print(f"dry run against the card: {len(dry_rows)} cells; with the mesh and the router "
          f"{dry_s:.1f} s in all; "
          + "; ".join(f"{r['label']}: peak {r['predicted_peak_gib']:.3f} predicted, "
                      f"{r['peak_gib']:.3f} GiB measured, mfu {r['mfu']:.4f}, roofline_mfu "
                      f"{r['roofline_mfu']:.4f}" for r in dry_rows) + f"  [{card}]", flush=True)

    # -- 8. kernels against their plain versions -----------------------
    kernels = []

    def kernel_row(name, source, replaces, kernel_fn, plain_fn, nbytes, ops_count,
                   launches, tol=None, mutant=None, peak_ops=PEAK_OPS_PER_S, library_fn=None,
                   fill=False, bits=False):
        """Hold ``kernel_fn()`` against ``plain_fn()`` and time both, beside the
        bound at ``peak_ops`` and ``library_fn``'s time where there is one.
        ``fill`` also prints the device time of one fill of the kernel's
        output (``zero_()``): a practical store-rate floor, context only.
        With ``tol`` None the two must be equal (``bits``: float32 arrays
        by their bits, so -0.0 != +0.0); a floating reduction, which
        cannot be bit-equal, passes ``tol = (rtol, row_rms)`` and must lie
        within :func:`worst_over_limit`'s limit, and ``mutant = (what, fn)``,
        the plain version with one block of keys left out, must not."""
        got, want = kernel_fn(), plain_fn()
        sync()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        if tol is None:
            eq = same_bits if bits else same
            ok = len(got) == len(want) and all(eq(a, b) for a, b in zip(got, want))
            checks.expect(ok, f"{name} kernel == plain version on the card"
                              f"{' by bits' if bits else ''} (max_abs_err {err})")
        else:
            (g,), (w,) = got, want
            worst = worst_over_limit(g, w, *tol)
            checks.expect(g.shape == w.shape and worst <= 1.0,
                          f"{name} kernel within {tol[0]} |plain| + {tol[1]} x the row's RMS "
                          f"of the plain version on the card (max_abs_err {err}, worst "
                          f"error / limit {worst:.3g})")
            if mutant is not None:
                what, mutant_fn = mutant
                bad = worst_over_limit(mutant_fn(), w, *tol)
                checks.expect(bad > 1.0, f"{name}: that limit rejects the plain version "
                                         f"{what} (worst error / limit {bad:.3g})")
        del got, want
        ms, timed_by = device_timing(kernel_fn)
        window_ms = time_ms(kernel_fn)
        plain_ms, plain_by = device_timing(plain_fn)
        timed_by = {"ms": timed_by, "plain_ms": plain_by}
        library_ms = None
        if library_fn is not None:
            library_ms, timed_by["library_ms"] = device_timing(library_fn)
        b_ms, b_by = bound_ms(nbytes, ops_count, peak_ops)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=library_ms, timed_by=timed_by,
        ))
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        peak = f" at {peak_ops / 1e12:g} TFLOP/s" if b_by == "operations" else ""
        print(f"  {name}: {ms:.4f} ms on the device, {window_ms:.4f} ms in one call's event "
              f"window (plain {plain_ms:.4f} ms, library {lib}, bound {b_ms:.4f} ms by "
              f"{b_by}{peak}; {launches} launches on its path)", flush=True)
        if fill:
            outs = kernel_fn()
            outs = outs if isinstance(outs, tuple) else (outs,)
            fill_ms = device_ms(lambda: [o.view(torch.uint8).zero_() for o in outs])
            shapes = ", ".join(str(tuple(o.shape)) for o in outs)
            print(f"  {name}: one fill of the same {shapes} bytes "
                  f"(zero_()) {fill_ms:.4f} ms on the device (context only)", flush=True)
            del outs

    sweep_src = "src/repro_torch/kernels/csrc/level_sweep.cu"

    def sweep_bytes(nq, levels, width, tile_bytes, pbytes, root_only):
        """Queries read, tiles and parents of every tested level read once,
        the (L, Q, W) mask written once."""
        tested = levels - int(root_only)
        return nq * 16 + tested * width * (tile_bytes + pbytes) + levels * nq * width

    def stream_row(name, ix, precision, q):
        """Kernel #2 on ``ix``'s streaming sweep; its bound counts the tile
        and parent bytes of the tiles this run reads (not the skipped ones)
        and the compares of their slots."""
        qq, tiles, parent, win_off, win_w = stream_inputs(ix, precision, q)
        root = ix.schedule.root_unconditional
        levels, _, width = tiles.shape
        nq = qq.shape[0]
        skipped = int(ops.level_sweep_stream(qq, tiles, parent, win_off, win_w,
                                             root_unconditional=root)[1])
        read_slots = (win_off.numel() - skipped) * FIXED["block_w"]
        tile_bytes = 4 * tiles.element_size() + parent.element_size()
        kernel_row(
            name, sweep_src, "src/repro/kernels/pyramid_scan.py:530",
            lambda: ops.level_sweep_stream(qq, tiles, parent, win_off, win_w,
                                           root_unconditional=root),
            lambda: ops.level_sweep_stream_torch(qq, tiles, parent, win_off, win_w,
                                                 root_unconditional=root),
            nbytes=nq * 16 + win_off.numel() * 4 + read_slots * tile_bytes
            + levels * nq * width,
            ops_count=read_slots * nq * 8, launches=paths.get("stream", {}).get(name, 0),
        )
        print(f"  {name}: {skipped} of {win_off.numel()} level-tiles skipped, "
              f"{int((win_off < 0).sum())} of them statically empty (win_w {win_w})",
              flush=True)

    def quant_row(name, s, q, split, launches):
        """Kernel #5 as its path calls it, with the schedule's ``n_real``
        (and with ``split``, the uint8 tiles of the compact8 form): its
        bound counts the real slots read and every output byte written; the
        dense bound, every slot read, is printed beside it."""
        levels, _, width = s.mbr_cm.shape
        kw = dict(n_real=s.n_real)
        if split:
            kw.update(split=split, inv_cell8=q.inv_cell8)
        real = int(s.n_real.sum())
        coarse = int(s.n_real[:split].sum()) if split else 0
        written = levels * 4 * width * 2 + (split or 0) * 4 * width
        kernel_row(
            name, "src/repro_torch/kernels/csrc/quantize.cu",
            "src/repro/kernels/quantize.py:133",
            functools.partial(ops.quantize_cm, s.mbr_cm, q.origin, q.inv_cell, **kw),
            functools.partial(ops.quantize_cm_torch, s.mbr_cm, q.origin, q.inv_cell, **kw),
            nbytes=real * 16 + written + levels * 4 + 48,
            ops_count=(real + coarse) * 4 * 6, launches=launches, fill=True,
        )
        dense_ms, _ = bound_ms(levels * 4 * width * 4 + written, 0)
        print(f"  {name}: (L, 4, W) = ({levels}, 4, {width}), split {split or 0}, "
              f"{real} of {levels * width} slots real; dense bound (every slot read) "
              f"{dense_ms:.4f} ms", flush=True)

    def kernel_phase():
        from repro_torch.kernels.autotune import PROBE_QUERIES

        L, _, W = sched.mbr_cm.shape
        nq = q_dev.shape[0]
        obj = sched.obj_mbr
        pyr = paths.get("pyramid", {})
        extras = paths.get("pyramid extras", {})
        tree = paths.get("tree", {})
        rows, names = build_breakdown(lambda: ops.build_levels(obj, levels=L), L)
        print_breakdown(rows, names, f"build_levels at n {W}, L {L}")
        per_level = [sum(c for _, c in r.values()) for r in rows]
        print(f"  build_levels: {sum(per_level)} launches a call, at most {max(per_level)} a "
              f"level", flush=True)
        kernel_row(
            "build_levels", "src/repro_torch/kernels/csrc/build_levels.cu",
            "src/repro/kernels/build.py:215",
            lambda: ops.build_levels(obj, levels=L),
            lambda: ops.build_levels_torch(obj, levels=L),
            # read the MBRs; write group_of, mbr_cm, parent (24 B/slot) and n_real
            nbytes=obj.numel() * 4 + L * W * (4 + 16 + 4) + L * 4,
            # per level and object: centroids, quadrant, key, 4 min/max, count
            ops_count=L * W * 16, launches=pyr.get("build_levels", 0), bits=True,
        )
        quant_row("quantize_cm", sched, qsched, None, pyr.get("quantize_cm", 0))
        quant_row("quantize_cm_u8", sched, idx.artifacts.quantized8,
                  idx.artifacts.quantized8.split, extras.get("quantize_cm", 0))
        kernel_row(
            "level_sweep_f32", sweep_src, "src/repro/kernels/pyramid_scan.py:498",
            lambda: ops.level_sweep(q_dev, sched.mbr_cm, sched.parent,
                                    root_unconditional=False),
            lambda: ops.level_sweep_torch(q_dev, sched.mbr_cm, sched.parent,
                                          root_unconditional=False),
            nbytes=sweep_bytes(nq, L, W, 16, 4, False),
            ops_count=L * nq * W * 8, launches=pyr.get("level_sweep_f32", 0),
            fill=True,
        )
        qq = _quantize_queries(q_dev, qsched.origin, qsched.inv_cell, qsched.cells)
        pbytes = qsched.parent_q.element_size()
        kernel_row(
            "level_sweep_u16", sweep_src, "src/repro/kernels/pyramid_scan.py:498",
            lambda: ops.level_sweep(qq, qsched.mbr_q, qsched.parent_q,
                                    root_unconditional=False),
            lambda: ops.level_sweep_torch(qq, qsched.mbr_q, qsched.parent_q,
                                          root_unconditional=False),
            nbytes=sweep_bytes(nq, L, W, 8, pbytes, False),
            ops_count=L * nq * W * 8, launches=pyr.get("level_sweep_u16", 0),
            fill=True,
        )
        # #3 at the pyramid's full width: uint8 tiles for L - 1 levels, int32
        # parents, the schedule's n_real (as pyramid_scan_compact8 passes it)
        q8 = idx.artifacts.quantized8
        qq8 = _quantize_queries(q_dev, q8.origin, q8.inv_cell8, q8.cells8)
        sp = q8.split

        def hier_pyramid():
            return ops.level_sweep_hier(qq8, qq, q8.mbr_q8, q8.mbr_q[sp:], q8.parent_q,
                                        split=sp, root_unconditional=False,
                                        n_real=sched.n_real)

        kernel_row(
            "level_sweep_hier", sweep_src, "src/repro/kernels/pyramid_scan.py:617",
            hier_pyramid,
            lambda: ops.level_sweep_hier_torch(qq8, qq, q8.mbr_q8, q8.mbr_q[sp:],
                                               q8.parent_q, split=sp,
                                               root_unconditional=False),
            nbytes=nq * 16 + sweep_bytes(nq, L, W, 0, q8.parent_q.element_size(), False)
            + sp * W * 4 + (L - sp) * W * 8,
            ops_count=L * nq * W * 8, launches=extras.get("level_sweep_hier", 0), fill=True,
        )
        print(f"  level_sweep_hier: CUDA launches a call {launches_a_call(hier_pyramid)}",
              flush=True)
        # #7 on one level of the pyramid (the widest), read in place, at the
        # batch's queries and at the autotuner's probe (PROBE_QUERIES), where
        # most of its launches on the path run (C10)
        lvl = L - 1
        for name, qn in (("mbr_scan", q_dev), ("mbr_scan_probe", q_dev[:PROBE_QUERIES])):
            m = qn.shape[0]
            kernel_row(
                name, "src/repro_torch/kernels/csrc/mbr_scan.cu",
                "src/repro/kernels/mbr_scan.py:60",
                functools.partial(ops.mbr_scan_cm, sched.mbr_cm[lvl], qn),
                functools.partial(ops.mbr_scan_torch, sched.mbr_cm[lvl].T, qn),
                nbytes=m * 16 + W * 16 + m * W,
                ops_count=m * W * 8, launches=extras.get("mbr_scan", 0), fill=True,
            )
        # #2 on the pyramid at float32 and compact, with the windows of its path
        for name, precision in (("level_sweep_stream_f32", "float32"),
                                ("level_sweep_stream_u16", "compact")):
            if ("pyramid", precision) in stream_out:
                stream_row(name, stream_out["pyramid", precision]["index"], precision, q_dev)
        # #6 at each join shape of the join path, and at the moving path's
        def pair_row(name, sweep, sym, launches):
            k, _, wa = sweep[0].shape
            wb = sweep[2].shape[2]
            tested = k * wa * (wa + 1) // 2 if sym else k * wa * wb
            kernel_row(
                name, "src/repro_torch/kernels/csrc/pair_sweep.cu",
                "src/repro/kernels/join_scan.py:236",
                functools.partial(ops.pair_sweep, *sweep, symmetric=sym),
                functools.partial(ops.pair_sweep_torch, *sweep, symmetric=sym),
                # the (K, Wa, Wb) mask written once; tiles and parents read once
                nbytes=k * wa * wb + k * (wa + wb) * (4 * sweep[0].element_size() + 4),
                ops_count=tested * 8, launches=launches, fill=True,
            )

        for name, label in (("pair_sweep_f32", "mqr x rtree float32"),
                            ("pair_sweep_u16", "mqr x rtree compact"),
                            ("pair_sweep_sym", "mqr self-join"),
                            ("pair_sweep_f32_wide", "pyramid x mqr")):
            if "sweep_args" in join_out.get(label, {}):
                r = join_out[label]
                pair_row(name, r["sweep_args"], r["symmetric"],
                         r["launches"].get(name.replace("_wide", ""), 0))
        if "sweep_args" in moving_out:
            pair_row("pair_sweep_f32_moving", moving_out["sweep_args"], moving_out["symmetric"],
                     paths["moving"].get("pair_sweep_f32", 0))
        if "mqr" not in trees:
            return
        if ("mqr", "compact") in stream_out:
            stream_row("level_sweep_stream_u16p", stream_out["mqr", "compact"]["index"],
                       "compact", torch.from_numpy(tree_queries).to(dev))
        # the mqr tree schedule: uint16 parents, root-only level 0, object gate
        ts = trees["mqr"]["index"].schedule
        t16 = trees["mqr"]["index"].artifacts.quantized
        t8 = trees["mqr"]["index"].artifacts.quantized8
        quant_row("quantize_cm_tree", ts, t16, None, tree.get("quantize_cm", 0))
        tl, _, tw = ts.mbr_cm.shape
        tq = torch.from_numpy(tree_queries).to(dev)
        tqq = _quantize_queries(tq, t16.origin, t16.inv_cell, t16.cells)
        tqq8 = _quantize_queries(tq, t8.origin, t8.inv_cell8, t8.cells8)
        kernel_row(
            "level_sweep_u16p", sweep_src, "src/repro/kernels/pyramid_scan.py:498",
            lambda: ops.level_sweep(tqq, t16.mbr_q, t16.parent_q),
            lambda: ops.level_sweep_torch(tqq, t16.mbr_q, t16.parent_q),
            nbytes=sweep_bytes(nq, tl, tw, 8, 2, True),
            ops_count=tl * nq * tw * 8, launches=tree.get("level_sweep_u16p", 0),
            fill=True,
        )
        # #3 on the mqr-tree at the batch's queries and at the autotuner's
        # probe, with the schedule's n_real as the path passes it
        ts8 = t8.split
        for name, m in (("level_sweep_hier_u16p", nq), ("level_sweep_hier_u16p_probe",
                                                        PROBE_QUERIES)):
            hier = (tqq8[:m], tqq[:m], t8.mbr_q8, t8.mbr_q[ts8:], t8.parent_q)
            run_hier = functools.partial(ops.level_sweep_hier, *hier, split=ts8,
                                         n_real=ts.n_real)
            kernel_row(
                name, sweep_src, "src/repro/kernels/pyramid_scan.py:617", run_hier,
                functools.partial(ops.level_sweep_hier_torch, *hier, split=ts8),
                nbytes=m * 16 + sweep_bytes(m, tl, tw, 0, 2, True)
                + (ts8 - 1) * tw * 4 + (tl - ts8) * tw * 8,
                ops_count=tl * m * tw * 8, launches=tree.get("level_sweep_hier_u16p", 0),
                fill=True,
            )
            print(f"  {name}: CUDA launches a call {launches_a_call(run_hier)}", flush=True)

    checks.phase("kernels vs plain versions", kernel_phase)

    def attention_kernel_phase():
        """#8-#10 against their plain versions at the shapes of phase 17, and
        one PyTorch library call each where one computes the same function.
        The limits follow each output's own scale (:func:`worst_over_limit`),
        set from this phase's readings on the card; for #8 and #9 each is
        also shown to reject the plain version with one block of keys left
        out."""
        if "ids" not in attn_out:
            return
        # launches on the kernels' paths: the random-input phase and the model's runs
        launched = {}
        for path, counts in paths.items():
            if path == "attention" or path.startswith("llm "):
                for k, n in counts.items():
                    launched[k] = launched.get(k, 0) + n
        csrc = "src/repro_torch/kernels/csrc/"
        # (rtol, row_rms): bfloat16's rtol covers one bf16 ulp (2^-7 of |v|)
        # at any magnitude, its row term the bf16 rounding of p before P.V
        tol = {"rmsnorm": {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 3e-2)},
               "flash_attention": {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 3e-2)},
               "mqr_sparse_attention": {torch.float32: (1e-4, 1e-4),
                                        torch.bfloat16: (2e-2, 3e-2)}}
        # dense peaks (data sheet, 700 W): bf16 on the tensor cores; the f32
        # kernel runs on the CUDA cores (FFMA, not TF32)
        flash_peak = {torch.float32: PEAK_OPS_PER_S, torch.bfloat16: 989e12}
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def rms_norm(*a, **k):  # a float32 weight on bfloat16 rows warns on every call
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                return torch.nn.functional.rms_norm(*a, **k)
        for dt in (torch.float32, torch.bfloat16):
            tag = "f32" if dt == torch.float32 else "bf16"
            es = torch.empty((), dtype=dt).element_size()
            x, w = attn_out["x"].to(dt), attn_out["norm_scale"]
            rows, d = x.shape
            kernel_row(
                f"rmsnorm_{tag}", csrc + "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:33",
                lambda: ops.rmsnorm(x, w), lambda: ops.rmsnorm_torch(x, w),
                nbytes=2 * rows * d * es + d * 4, ops_count=rows * d * 4,
                launches=launched.get(f"rmsnorm_{tag}", 0), tol=tol["rmsnorm"][dt],
                library_fn=lambda: rms_norm(x, (d,), weight=w, eps=1e-6))
            q, k, v = (t.to(dt) for t in attn_out["prefill_in"])
            bh, s_len, hd = q.shape
            v_cut = v.clone()
            v_cut[:, -64:] = 0  # the last 64-key tile contributes nothing
            kernel_row(
                f"flash_attention_{tag}", csrc + "flash_attention.cu",
                "src/repro/kernels/flash_attention.py:86",
                lambda: ops.flash_attention(q, k, v), lambda: ops.flash_attention_torch(q, k, v),
                nbytes=4 * bh * s_len * hd * es,
                # the causal QK^T and P.V products: S (S + 1) / 2 pairs each
                ops_count=2 * 2 * bh * (s_len * (s_len + 1) // 2) * hd,
                launches=launched.get(f"flash_attention_{tag}", 0),
                tol=tol["flash_attention"][dt], peak_ops=flash_peak[dt],
                mutant=("with the values of the last 64 keys zeroed",
                        lambda: ops.flash_attention_torch(q, k, v_cut)),
                library_fn=lambda: sdpa(q[None], k[None], v[None], is_causal=True))
            del v_cut
            qd = attn_out["qd"].to(dt)
            kb, vb = attn_out["kb"] if dt == torch.bfloat16 else attn_out["kbf"]
            ids, pos = attn_out["ids"], attn_out["pos"]
            (bh_dec, hd_dec), kk, bs = qd.shape, ids.shape[1], kb.shape[2]
            kernel_row(
                f"mqr_sparse_attention_{tag}", csrc + "mqr_sparse_attention.cu",
                "src/repro/kernels/mqr_sparse_attention.py:105",
                lambda: ops.mqr_sparse_attention(qd, kb, vb, ids, pos),
                lambda: ops.mqr_sparse_attention_torch(qd, kb, vb, ids, pos),
                # K*bs*D elements each of k and v per (b, h), plus q, ids and out
                nbytes=bh_dec * (2 * kk * bs * hd_dec * es + 2 * hd_dec * es + kk * 4),
                ops_count=bh_dec * kk * bs * hd_dec * 4,
                launches=launched.get(f"mqr_sparse_attention_{tag}", 0),
                tol=tol["mqr_sparse_attention"][dt],
                mutant=("with the first selected block left out",
                        lambda: ops.mqr_sparse_attention_torch(
                            qd, kb, vb, ids[:, 1:].contiguous(), pos)))
        # #8 at gemma-2b's prefill shape: 8 heads of head dim 256
        for dt in (torch.float32, torch.bfloat16):
            tag = "f32" if dt == torch.float32 else "bf16"
            es = torch.empty((), dtype=dt).element_size()
            g256 = torch.Generator(device=dev).manual_seed(args.seed + 2)
            q, k, v = (torch.randn((8, args.prefill, 256), generator=g256, device=dev).to(dt)
                       for _ in range(3))
            bh, s_len, hd = q.shape
            v_cut = v.clone()
            v_cut[:, -64:] = 0
            kernel_row(
                f"flash_attention_{tag}_d256", csrc + "flash_attention.cu",
                "src/repro/kernels/flash_attention.py:86",
                lambda: ops.flash_attention(q, k, v), lambda: ops.flash_attention_torch(q, k, v),
                nbytes=4 * bh * s_len * hd * es,
                ops_count=2 * 2 * bh * (s_len * (s_len + 1) // 2) * hd,
                launches=sum(c.get(f"flash_attention_{tag}", 0) for p, c in paths.items()
                             if p.startswith("llm gemma_2b ")),
                tol=tol["flash_attention"][dt], peak_ops=flash_peak[dt],
                mutant=("with the values of the last 64 keys zeroed",
                        lambda: ops.flash_attention_torch(q, k, v_cut)),
                library_fn=lambda: sdpa(q[None], k[None], v[None], is_causal=True))
            del q, k, v, v_cut

        # #9 as the models call it: kv rows read in place by `group` query
        # heads each, at the model's ids; bytes count each distinct (kv row,
        # block) the ids select once.  No single PyTorch call computes #9's
        # function (a softmax over blocks chosen per row by an id table, read
        # in place); a gather of the selected blocks and SDPA over them with
        # the causal mask (two calls) is timed beside it as context only.
        def sparse_row(name, inp, launches):
            qd, kb, vb, ids, pos, grp = (inp[k] for k in ("q", "kb", "vb", "ids", "pos",
                                                           "group"))
            (bh_dec, hd_dec), kk, nb_, bs = qd.shape, ids.shape[1], kb.shape[1], kb.shape[2]
            es = qd.element_size()
            kv_rows = torch.arange(bh_dec, device=ids.device)[:, None] // grp
            distinct = int(torch.unique(kv_rows * nb_ + ids.long()).numel())
            rows_ = kv_rows.expand(-1, kk)

            def gather_sdpa():
                kg = kb[rows_, ids.long()].reshape(bh_dec, 1, kk * bs, hd_dec)
                vg = vb[rows_, ids.long()].reshape(bh_dec, 1, kk * bs, hd_dec)
                kpos = ids.long()[:, :, None] * bs + torch.arange(bs, device=ids.device)
                mask = (kpos <= pos).reshape(bh_dec, 1, 1, kk * bs)
                return sdpa(qd[:, None, None, :], kg, vg, attn_mask=mask)

            two_calls = device_ms(gather_sdpa)
            print(f"  {name}: group {grp}, head dim {hd_dec}, {bh_dec} query rows x {kk} ids "
                  f"of {nb_} blocks of {bs}: {distinct} distinct (kv row, block) pairs of "
                  f"{bh_dec * kk} selected; a gather of the selected blocks + SDPA with the "
                  f"causal mask (two calls, context only) {two_calls:.4f} ms on the device",
                  flush=True)
            kernel_row(
                name, csrc + "mqr_sparse_attention.cu",
                "src/repro/kernels/mqr_sparse_attention.py:105",
                lambda: ops.mqr_sparse_attention(qd, kb, vb, ids, pos, group=grp),
                lambda: ops.mqr_sparse_attention_torch(qd, kb, vb, ids, pos, group=grp),
                nbytes=distinct * 2 * bs * hd_dec * es + bh_dec * (2 * hd_dec * es + kk * 4),
                ops_count=bh_dec * kk * bs * hd_dec * 4, launches=launches,
                tol=tol["mqr_sparse_attention"][qd.dtype],
                mutant=("with the first selected block left out",
                        lambda: ops.mqr_sparse_attention_torch(
                            qd, kb, vb, ids[:, 1:].contiguous(), pos, group=grp)))

        def model_launches(arch):
            """#9's bf16 launches on a model's own paths (llama: those of the
            LLM serving phase)."""
            prefixes = tuple(f"llm {f['arch']} " for f in FAMILIES)
            return sum(c.get("mqr_sparse_attention_bf16", 0) for p, c in paths.items()
                       if (p.startswith(f"llm {arch} ") if arch != LLM_ARCH else
                           p.startswith("llm ") and not p.startswith(prefixes)))

        if "g4" in llm_out:
            sparse_row(f"mqr_sparse_attention_bf16_group{llm_out['g4']['group']}",
                       llm_out["g4"], model_launches(LLM_ARCH))
        for arch, inp in family_sparse.items():
            sparse_row(f"mqr_sparse_attention_bf16_{arch}", inp, model_launches(arch))

        # Edge cases, correctness only, within the same limits: #8 at D 128
        # and 256, at S not a multiple of its 128-row tile and at S 64; #9
        # (below); #10 where no
        # row can be read in 16-byte vectors (d 2050; a base one element off
        # 16-byte alignment), at 1 and 4,097 rows.
        gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

        def edge(label, kernel_out, plain_out, limits):
            worst = worst_over_limit(kernel_out, plain_out, *limits)
            checks.expect(kernel_out.shape == plain_out.shape
                          and kernel_out.dtype == plain_out.dtype and worst <= 1.0,
                          f"{label}: kernel within {limits[0]} |plain| + {limits[1]} x the "
                          f"row's RMS of the plain version (worst error / limit {worst:.3g})")

        for dt in (torch.float32, torch.bfloat16):
            tag = "f32" if dt == torch.float32 else "bf16"
            for (bh, s_len, hd), blk in (((4, 512, 128), 128), ((3, 320, 64), 64),
                                         ((2, 200, 64), 8), ((2, 64, 64), 64),
                                         ((2, 200, 256), 8), ((3, 320, 256), 64),
                                         ((2, 64, 256), 64)):
                q, k, v = (torch.randn((bh, s_len, hd), generator=gen, device=dev).to(dt)
                           for _ in range(3))
                edge(f"flash_attention_{tag} ({bh}, {s_len}, {hd}), block_q = block_k = {blk}",
                     ops.flash_attention(q, k, v, block_q=blk, block_k=blk),
                     ops.flash_attention_torch(q, k, v), tol["flash_attention"][dt])
            w = 1.0 + 0.1 * torch.randn((2050,), generator=gen, device=dev)
            for rows in (1, 4097):
                x = torch.randn((rows, 2050), generator=gen, device=dev).to(dt)
                edge(f"rmsnorm_{tag} ({rows}, 2050)", ops.rmsnorm(x, w),
                     ops.rmsnorm_torch(x, w), tol["rmsnorm"][dt])
            rows, d = attn_out["x"].shape
            buf = torch.randn((rows * d + 1,), generator=gen, device=dev).to(dt)
            x = buf[1:1 + rows * d].view(rows, d)
            w = attn_out["norm_scale"]
            edge(f"rmsnorm_{tag} ({rows}, {d}) on a base one element off 16-byte alignment",
                 ops.rmsnorm(x, w), ops.rmsnorm_torch(x, w), tol["rmsnorm"][dt])
            # #9 at group 1 / D 64, 2 / 64, 4 / 128 and 8 / 256, 2 kv rows:
            # ids repeated, out of range (negative and past nb, pos past and
            # before them), a first block wholly past pos, every key masked,
            # K 1, nb 1, a group's heads with identical and with disjoint
            # ids, bs 16 and 64, every one of 256 blocks of 16
            for grp, hd in ((1, 64), (2, 64), (4, 128), (8, 256)):
                bh = 2 * grp

                def blocks_of(nb, bs):
                    return tuple(torch.randn((2, nb, bs, hd), generator=gen, device=dev).to(dt)
                                 for _ in range(2))

                def rows(lists):  # query row r takes lists[r % len(lists)]
                    return torch.tensor([lists[r % len(lists)] for r in range(bh)],
                                        dtype=torch.int32, device=dev)

                q = torch.randn((bh, hd), generator=gen, device=dev).to(dt)
                kv8, kv1 = blocks_of(8, 128), blocks_of(1, 128)
                cases = [
                    ("ids repeated", kv8, rows([[3, 3, 1, 3], [0, 5, 5, 2]]), 8 * 128 - 40),
                    ("ids out of range", kv8, rows([[9, 0, -2], [1, 40, -100]]), 8 * 128 + 100),
                    ("ids out of range, pos before them", kv8,
                     rows([[9, 0, -2], [1, 40, -100]]), 5 * 128),
                    ("first block past pos", kv8, rows([[7, 2, 0], [6, 7, 1]]), 3 * 128 + 5),
                    ("every key masked", kv8, rows([[5, 6], [7, 4]]), 3 * 128),
                    ("K 1", kv8, rows([[3], [6]]), 8 * 128 - 1),
                    ("identical ids in a group", kv8, rows([[1, 4, 6, 2]]), 8 * 128 - 1),
                    ("disjoint ids in a group", kv8,
                     torch.tensor([[(4 * r + j) % 8 for j in range(2)] for r in range(bh)],
                                  dtype=torch.int32, device=dev), 8 * 128 - 1),
                    ("nb 1", kv1, rows([[0, 0]]), 128 - 3),
                    ("bs 16", blocks_of(16, 16), rows([[3, 9, 15, 0], [2, 2, 7, 11]]), 16 * 16 - 7),
                    ("bs 64", blocks_of(16, 64), rows([[3, 9, 15, 0], [2, 2, 7, 11]]), 16 * 64 - 7),
                    ("all 256 blocks of 16", blocks_of(256, 16),
                     torch.arange(256, dtype=torch.int32, device=dev).expand(bh, 256).contiguous(),
                     256 * 16 - 9),
                ]
                for label, (kb, vb), ids, pos in cases:
                    edge(f"mqr_sparse_attention_{tag} group {grp}, D {hd}: {label}",
                         ops.mqr_sparse_attention(q, kb, vb, ids, pos, group=grp),
                         ops.mqr_sparse_attention_torch(q, kb, vb, ids, pos, group=grp),
                         tol["mqr_sparse_attention"][dt])

    checks.phase("attention kernels vs plain versions", attention_kernel_phase)
    checks.phase("backward kernels of #8 and #10 vs autograd of the plain versions",
                 lambda: kernels.extend(grad_kernel_checks(checks, dev, args.seed,
                                                           train_launches(paths))))

    # -- 9. end-to-end timings and profile -----------------------------
    def timings():
        out["build_steady_ms"] = wall_ms(
            lambda: SpatialIndex.build(data, structure="pyramid", build="device", **FIXED), 5)
        for precision in ("float32", "compact", "compact8"):
            ix = out[precision]["index"]
            out[precision]["region_ms"] = wall_ms(lambda: ix.region(queries))
            out[precision]["point_ms"] = wall_ms(lambda: ix.point(points))
        out["per_level"]["region_ms"] = wall_ms(
            lambda: ops.per_level_region_search(sched, q_dev))
        out["auto"]["region_ms"] = wall_ms(lambda: out["auto"]["index"].region(queries))
        for tr in trees.values():
            for precision in PRECISIONS:
                ix = tr[precision]["index"]
                tr[precision]["region_ms"] = wall_ms(lambda: ix.region(tree_queries))
                tr[precision]["point_ms"] = wall_ms(lambda: ix.point(tree_points))
        for (structure, _), r in stream_out.items():
            qs = queries if structure == "pyramid" else tree_queries
            r["region_ms"] = wall_ms(lambda: r["index"].region(qs))
        sync()
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out["compact"]["index"].region(queries)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["batch_peak_gib"] = out["peak_gib"] - live / 2 ** 30
        if "index" in live_out:
            sync()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            live_out["index"].region(queries)
            live_out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            live_out["batch_peak_gib"] = live_out["peak_gib"] - resident / 2 ** 30
            print(f"  peak device memory during one live float32 pyramid region batch: "
                  f"{live_out['peak_gib']:.2f} GiB, of which the batch itself "
                  f"{live_out['batch_peak_gib']:.2f} GiB", flush=True)
        for (structure, precision), r in stream_out.items():
            print(f"  stream {structure} {precision}: region {r['region_ms']:.2f} ms "
                  f"(median of {REPEATS}), first {r['first_ms']:.1f} ms; tiles skipped "
                  f"{r['skipped']} of {r.get('total_tiles')}", flush=True)
        print(f"  build (first) {out['build_ms']:.1f} ms, build (steady, median of 5) "
              f"{out['build_steady_ms']:.1f} ms", flush=True)
        for precision in ("float32", "compact", "compact8"):
            r = out[precision]
            print(f"  pyramid {precision}: region {r['region_ms']:.2f} ms, point "
                  f"{r['point_ms']:.2f} ms per {args.queries}-query batch "
                  f"(median of {REPEATS}); first region+point+count {r['first_ms']:.1f} ms",
                  flush=True)
        print(f"  pyramid per-level plan: region {out['per_level']['region_ms']:.2f} ms "
              f"(first {out['per_level']['first_ms']:.1f} ms)", flush=True)
        print(f"  pyramid autotune='auto': region {out['auto']['region_ms']:.2f} ms steady, "
              f"first call (tuning included) {out['auto']['first_ms']:.1f} ms", flush=True)
        for structure, tr in trees.items():
            for precision in PRECISIONS:
                r = tr[precision]
                print(f"  {structure} {precision}: region {r['region_ms']:.2f} ms, point "
                      f"{r['point_ms']:.2f} ms (median of {REPEATS}); first "
                      f"region+point+count (tuning included) {r['first_ms']:.1f} ms",
                      flush=True)
        print(f"  peak device memory during one compact pyramid region batch: "
              f"{out['peak_gib']:.2f} GiB, of which the batch itself "
              f"{out['batch_peak_gib']:.2f} GiB", flush=True)

    checks.phase("end-to-end timings", timings)

    def profile():
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as trace

        batches = [(f"pyramid {p} region batch", out[p]["index"].region, queries)
                   for p in ("float32", "compact", "compact8")]
        batches += [(f"{s} {p} region batch", trees[s][p]["index"].region, tree_queries)
                    for s in trees for p in ("float32", "compact8")]
        if ("pyramid", "float32") in stream_out:
            batches.append(("pyramid float32 stream=True region batch",
                            stream_out["pyramid", "float32"]["index"].region, queries))
        if "index" in live_out:
            batches.append(("pyramid float32 live (after the merge) region batch",
                            live_out["index"].region, queries))
        for label in ("mqr x rtree float32", "pyramid x mqr"):
            if label in join_out:
                batches.append((f"join {label}", join_out[label]["left"].join,
                                join_out[label]["right"]))
        if "pyramid" in knn_out:
            batches.append((f"pyramid k-NN (k {knn_k})",
                            functools.partial(idx.knn, k=knn_k), points))
        if "step" in attn_out:
            batches.append(("mqr-KV decode step (32 index builds, selection, #9 bf16)",
                            attn_out["step"], None))
        if "steps" in llm_out:
            for label, fn in llm_out["steps"].items():
                batches.append((f"llama3.2-1B {label} decode step (B {LLM_DEC_B}, "
                                f"{args.kv_len:,}-token caches, 16 layers)", fn, None))
        if "batch" in front_out:
            batches.append(("serving front end: one 16-query maps batch (compact, serve, "
                            "an LRU miss)", front_out["batch"], queries))
        if "workload" in moving_out:  # one more tick, after the checked run
            batches.append(("moving tick", lambda _: moving_out["workload"].tick(), None))
        for label, fn, arg in batches:
            if label != "moving tick":
                fn(arg)
            sync()
            with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                fn(arg)
                sync()
                window_us = (time.perf_counter() - t) * 1e6
            rows = []
            for evt in prof.key_averages():
                if evt.device_type != DeviceType.CUDA:
                    continue  # host-side ops; their kernels are listed themselves
                dev_us = getattr(evt, "self_device_time_total", None)
                if dev_us is None:
                    dev_us = getattr(evt, "self_cuda_time_total", 0)
                if dev_us > 0:
                    rows.append((dev_us, evt.count, evt.key))
            rows.sort(reverse=True)
            busy = sum(r[0] for r in rows)
            print(f"  {label}: host window {window_us / 1e3:.3f} ms, "
                  f"device busy {busy / 1e3:.3f} ms, idle share "
                  f"{max(0.0, 1 - busy / window_us):.3f}", flush=True)
            # the ten largest, and the port's own kernels below them
            ours = [r for r in rows[10:] if not r[2].startswith(("void at::", "Memcpy", "Memset"))]
            for dev_us, count, key in rows[:10] + ours[:10]:
                print(f"    {dev_us / 1e3:9.3f} ms  x{count:<4d} {key[:90]}", flush=True)

    checks.phase("profile: device time by kernel, one call per path", profile)

    summary = dict(
        n=args.n, queries=args.queries, seed=args.seed, tree_n=args.tree_n, card=card,
        levels=sched.levels, width=sched.width, nvcc_build_s=build_s,
        build_ms=out.get("build_ms"), build_steady_ms=out.get("build_steady_ms"),
        region_ms={p: out[p].get("region_ms") for p in PRECISIONS if p in out},
        point_ms={p: out[p].get("point_ms") for p in PRECISIONS if p in out},
        per_level_region_ms=out.get("per_level", {}).get("region_ms"),
        auto_region_ms=out.get("auto", {}).get("region_ms"),
        auto_first_ms=out.get("auto", {}).get("first_ms"),
        tuned={str(k): str(v) for k, v in idx.artifacts.tuned.items()},
        peak_gib=out.get("peak_gib"), batch_peak_gib=out.get("batch_peak_gib"),
        trees={s: dict(
            levels=tr["index"].schedule.levels, width=tr["index"].schedule.width,
            host_build_s=tr["host_build_s"], second_build_s=tr.get("second_build_s"),
            region_ms={p: tr[p].get("region_ms") for p in PRECISIONS},
            point_ms={p: tr[p].get("point_ms") for p in PRECISIONS},
            first_ms={p: tr[p]["first_ms"] for p in PRECISIONS},
            tuned={str(k): str(v) for k, v in tr["index"].artifacts.tuned.items()},
        ) for s, tr in trees.items()},
        launches=paths,
        live={k: v for k, v in live_out.items() if k != "index"},
        stream={f"{st} {p}": dict(skipped=r["skipped"], total_tiles=r.get("total_tiles"),
                                  win_w=r.get("win_w"), region_ms=r.get("region_ms"),
                                  first_ms=r["first_ms"])
                for (st, p), r in stream_out.items()},
        join={label: {f: r.get(f) for f in ("k", "wa", "wb", "tiles", "symmetric", "n_pairs",
                                            "pair_visits", "first_ms", "join_ms", "lower_ms",
                                            "sweep_ms", "epilogue_ms", "peak_gib",
                                            "launches")}
              for label, r in join_out.items()},
        knn={label: {f: r.get(f) for f in ("rounds", "first_ms", "ms")}
             for label, r in knn_out.items()},
        moving={f: v for f, v in moving_out.items() if f not in ("workload", "sweep_args")},
        durability=dur_out,
        front_end={f: v for f, v in front_out.items() if f != "batch"},
        attention={f: attn_out.get(f) for f in (
            "selected_frac", "survivor_frac", "build_ms", "select_ms", "attend_ms",
            "attend_all_ms", "dense_plain_ms", "sparse_vs_dense")},
        llm={f: v for f, v in llm_out.items() if isinstance(v, (int, float))},
        families=families_out,
        train={f: v for f, v in train_out.items() if f != "dryrun"},
        dryrun=dry_rows, mesh=mesh_out,
    )
    print("summary " + json.dumps(summary), flush=True)
    print(f"the whole run took {time.perf_counter() - t_run:.1f} s (host clock, from the "
          f"card's first use)  [{card}]", flush=True)
    if checks.failures:
        print(f"FAILED: {checks.failures}", flush=True)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
