#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # on a machine with a CUDA card

Phases, one JSON line each (``{"phase": ..., "seconds": ...}``):

  card       nvidia-smi name and power limit (also printed raw)
  build      nvcc builds every CUDA source of the port (sm_90a), all at once
  graph      graph500 RMAT, scale 20, edge factor 16, seed 0, deduplicated
             and symmetrized, float32 weights from the seed
  partition  partition_2d(p=4, l=16, tile_vb=1024, tile_eb=128,
             build_push=True, push_block=65536) with memory_report()
  kernel     each kernel against its plain PyTorch version on the card:
             gather_reduce_cores on phase 0 of the real partition (static
             counts and a seeded fetch map keeping ~30% of the real tiles)
             and on a small graph in the 32-bit regime; scatter_reduce_cores
             on phase 0 of the real push stream (32-bit regime) and on a
             small partition in the 16-bit push regime, static and fetch.
             min u32 (BFS/WCC), min f32 + weights (SSSP), sum f32 (PageRank,
             gather only). Min must be bit-equal, sum within rtol=1e-5,
             atol=1e-9.
  timing     per variant, each kernel's and its plain version's device time
             per launch over all l phases (CUDA events), with the byte bound
             at 3.35 TB/s; the gather min variants on the static counts, on
             a fetch map of all real tiles (the main path's arm) and on the
             ~30% map; the scatter variants with all real tiles active, with
             the bytes a slot the scatter design moves (word streams once, a
             payload row and an output row read per slot, the output written
             twice) beside the bound's; the oracle backend's time per phase
             (no single PyTorch call computes either function). The one-lane
             gather kernel cuts a row block's listed slots into one range a
             warp, each lane loading 4 slots with 16-B loads, folds runs of
             one row in registers and joins them across the warp with a
             segmented shuffle scan (min and OR: one shared atomic a run;
             sum: a run inside a range added once, pieces across ranges
             joined in warp order). The scatter kernel gives each slot a
             group of threads (one at L = 1, four at L = 16), keeps a
             source's payload row in registers along its run, reads the
             destination row with 16-B loads and sends an atomic only for a
             lane it lowers (float min: a signed min or an unsigned max on
             the bits, by the sign bit)
  main_path  engine.run with the port's default options (dynamic tile skip,
             'auto' direction) for BFS (root 0), WCC, SSSP (root 0) and
             PageRank (twice), with iterations, seconds and MTEPS = E /
             seconds (label init on the host is timed apart as set-up).
             Should 'auto' never pick push for a variant, a forced-push BFS
             or SSSP run is added. The launch counts of both kernels are
             zeroed just before and read just after: together they must
             equal sum(iterations) * l, and every variant must have run.
             Then (static_path_run, not counted) BFS, WCC and SSSP on the
             static schedule, bit-equal to the default runs, for comparison
  schedule   run_frontier_trace for BFS, WCC and SSSP: the direction and the
             skipped-tile fraction of every iteration; labels and iterations
             equal to the main path's runs
  profile    torch.profiler over one iteration: a static iteration per
             problem, and BFS's dense-pull, dynamic-pull and push iterations
             (the last two on the same narrow frontier): device busy time,
             idle share, the kernels' share, the top device events
  oracle     the same runs with backend='oracle' (the static schedule):
             BFS/WCC/SSSP labels and iterations bit-equal, PageRank within
             rtol=1e-5, atol=1e-9 with equal iterations; the two kernel
             PageRank runs bit-equal
  reference  a small graph through the port on the card against the numpy
             oracles of ``repro_torch.core.reference``

The paper's baseline and the multi-channel engine (after the laneless
paths, on the same graph and partition):

  edge_centric  partition_edge_centric(p=4) and BFS, WCC, SSSP and PageRank
             through run_edge_centric on the card (the synchronous
             HitGraph/ThunderGP baseline: an index_select and a per-core
             segment reduce an iteration): labels bit-equal to the oracle
             backend's (PageRank within DIST_PR_TOL); iterations and MTEPS
             beside the GraphScale engine's default runs, 8 B an edge beside
             pg.stream_bytes_per_edge
  distributed  the partition's arrays written once under build/distributed
             (np.save), then 4 spawned ranks (one a graph core, gloo, the
             crossbar staged through the host, all on this card) that
             memory-map them and upload only their core: BFS, WCC, SSSP
             (default and static), PageRank, a K = 16 BFS batch and the
             frontier engine (budget 64), each against engine.run here
             (labels and iterations bit-equal; PageRank within DIST_PR_TOL);
             the GNN aggregate (l = 4) and the GAT loss and gradients (l =
             1) at gat-cora's published width on the Cora shape against the
             one-device model (the aggregate within AGG_REL of its terms'
             magnitudes, the loss and gradients within 1e-5); the crossbar
             lookup of DIN's item table sharded 4 ways against the one-shard
             lookup (rows, the table gradient; at tight queues the dropped
             count and rows). Per rank: kernel launches (#1, #2, #5, counted
             over these paths, the comparisons after), device bytes (a
             quarter of one process's), MTEPS (host-staged: no prediction
             of a four-card run)
  distributed_nccl  the NCCL code path at world size 1: a p = 1 partition
             of RMAT scale 16, BFS, WCC, SSSP, PageRank against engine.run
             on the same card

This slice's paths (multi-query lanes and graph serving, K = 16):

  lanes_kernels  each lane arm against its plain version on phase 0 of the
             partition, counts and a ~30% fetch map: gather 'or' at W=1 and
             W=2 packed words (K=16, K=40), min_f32_add and sum_f32 at L=16,
             min_f32_add at L=64 (two lane chunks at vb=1024); scatter 'or'
             W=1 and min_f32_add L=16 on the real 32-bit push stream. Min and
             OR bit-equal; sum within rtol=1e-5, atol=1e-9 and the same bits
             on a second launch. Device time per launch over the l phases,
             the byte bound with the L-wide payload and output, the bytes a
             slot the design moves (gather: word streams once a lane chunk,
             an L-wide payload row gathered per slot, the output once;
             scatter as in timing) beside the bound's, both as GB/s, and the
             laneless arm's time on the same streams. The lane kernel gives each slot a group of
             threads (4 at L = 16, a quad of lanes each by 16-B loads), walks
             contiguous stretches of the dst-sorted slots and folds each run
             of one row in registers: min and OR write one atomic per run
             and lane, sum stages the runs that cross stretches and adds them
             in stretch order
  lanes_engine   bfs_multi, sssp_multi and ppr_multi (twice, tol 1e-4, the
             router's) at K = 16 with the default options; launches counted
             (forced-push runs added should 'auto' never push a variant):
             they must equal sum(iterations) * l with every lane variant
             run. Then (not counted) columns 0 and 1 against laneless
             bfs/sssp runs, BFS/SSSP bit-equal to the oracle backend's
             K-lane runs, PPR within rtol=1e-5, atol=1e-9 of the oracle over
             the counted run's iteration count (no lane frozen), PPR
             bit-stable, and the schedule of each min/or run
DIN scoring and recommend-for (the embedding-bag kernel), at the published
DIN width (get("din").model: item_vocab 10,000,384, cate_vocab 10,000,
embed 18, seq_len 100, attention MLP 80-40, output MLP 200-80), its
parameters drawn on the card from a seeded generator:

  bag_kernel the embedding-bag kernel against its plain version, sum and
             mean, at four shapes: (a) DIN's profile bag at serve_p99 (B =
             512, L = 32, the 10,000 x 18 cate table, ~30% padding from
             recsys_batch), (b) the same at serve_bulk (B = 262,144), (c) the
             10,000,384 x 18 item table with B = 4096, L = 100 (the
             histories of recsys_batch; 8 id sets in rotation, ~160 MB of
             row sectors, so each launch finds its rows out of L2), (d) B = 1 (the
             retrieval profile) and an all-padding bag. Within rtol=1e-5,
             atol=1e-7, the same bits on a second launch. Device time per
             launch (profiler; the median and spread of readings that
             alternate sum and mean) of the kernel, the plain version (L
             takes added in id order) and the one
             library call (F.embedding_bag with the validity mask as
             per_sample_weights, / max(count, 1) for mean); the byte bound
             at 3.35 TB/s: ids + output + the distinct 32-B sectors of the
             rows the real ids touch. Since the DIN training slice also (e)
             DIN's profile bag at train_batch (B = 65,536, L = 32), and the
             backward kernel at (e) and (a), sum and mean: bit for bit the
             plain version's run on the CPU, the same bits on a second
             launch; ms of the whole backward (stable sort, run starts, the
             kernel) and of the kernel alone, the plain version on the card
             (index_add_), the library call (the CUDA backward of one
             F.embedding_bag on the valid ids), the bound (grad_out + ids +
             the gradient + 24 B a slot of sort traffic at 3.35 TB/s)
  din        pointwise score on recsys_batch(batch=512) and retrieval
             score_candidates on retrieval_batch(n_candidates=4096) in
             chunks of 512, as the reference CLI runs them (the item rows
             by a take): ms per call (host clock, each call synchronized:
             median, min, max), QPS and candidates/s (the rows scored over
             the wall of all timed calls); the
             kernel's launches (counted) equal the calls; the scores within
             rtol=1e-5, atol=1e-6 of a run whose bag is the plain version;
             three profiled calls of each
  din_train  DIN training at the published width on train_batch (B =
             65,536), the item rows by a take: the first step's loss and
             every gradient within DIN_TOL of the same step with the bag's
             forward and backward through both plain versions on the card,
             cate_table's gradient unlike the one with the bag's output
             detached; 10 AdamW steps (lr 1e-3, the trainer CLI's schedule)
             on recsys_batch(0, i): exactly one forward and one backward bag
             launch a step (counted), step 0's batch re-scored after them
             below its first loss; ms a step (median, min, max), steps/s,
             peak device memory, one profiled step's busy and idle share and
             the backward kernel's share
  serve      a GraphService over the built partition at K = 16 with a
             RecommendScorer at the published DIN config (pool 64, top 8,
             the crossbar lookup at one shard): 128 queries of
             mixed_query_workload(seed=0) with the reference's default mix
             (bfs 0.35, sssp 0.2, ppr 0.2, recommend 0.25) and 512 weighted
             insertions from edge_insertion_stream in SERVE_FLUSHES (1)
             batch, flushed mid-stream; QPS, latency percentiles, batches and their walls by
             kind, flushes, and torch.cuda.memory_allocated() around each
             flush (the retired partition's device copies must be freed);
             launches counted as above, one embedding-bag launch per
             recommend query. serve_equivalence: a cold partition_2d of the
             final graph, every answer (recommend-for's vertices and scores
             too, through the same scorer) replayed on both partitions bit
             for bit, then neighbors-of for every distinct root (checked,
             not timed: the default mix sends none), BFS/WCC/SSSP labels
             and iterations equal

The one-bucket gather kernel (after lanes_engine, on the same partition):

  bucket     ops.gather_reduce over every one of the p * l = 64 (core,
             phase) buckets, each tiled from pg.src_gidx/dst_lidx/valid/
             weights as the partition tiles it (its vb, eb, row packing and
             split threshold), in three forms: a BFS-level min on u32, an
             SSSP min-plus with weights, a PageRank sum, one seeded payload
             per phase; launches counted (64 a form). Each bucket's natural
             rows against the fused kernel's (channel_phase_reduce) on the
             same payload, three buckets' packed rows against the plain
             version: min bit-equal, sum within SUM_TOL and the same bits
             again. Device time per launch over the 64 buckets, plain ms, the
             byte bound, and the stream's bytes per edge beside the fused
             kernel's packed 4 B

The out-of-core build (after serve_equivalence, its partitions freed):

  stream_build  (i) partition_2d_streaming(coo_edge_chunks(g)) of the smoke
             graph with CFG: every IDENTITY_FIELDS array's SHA-256 and the
             scalars equal to partition_2d's; build seconds and the peak
             VmRSS rise beside partition_2d's. (ii) a symmetric RMATStream at
             --stream-scale (21: p * sub_size = 131,072, past the 16-bit
             source regime), edge factor 16, seed 0, into np.memmap files
             under build/stream_build with CFG and the push_block of
             STREAM_PUSH_BLOCKS whose stacked push words and coverage
             stream_push_footprint counts least: src_bits 32, E, build
             seconds, peak RSS, device bytes per edge; BFS from 0 on the card
             with the default options (kernel launches counted, = iterations
             x l), the static schedule and the oracle backend (the flat
             bucket arrays, not the packed words), labels and iterations
             bit-equal, MTEPS of each

GAT and the GNN trainer (after serve, whose partitions are freed first),
gat-cora at its published width (get("gat-cora").model: 2 layers, 8
heads x 8), attention vectors seeded non-zero:

  softmax_kernel  the segment-softmax kernel against its plain version at
             (a) GAT layer 1 at the Cora shape (full_graph_sm: 4096 nodes,
             16,384 edge slots, H = 8) and (b) the smoke graph as one GAT
             layout (H = 8): within SOFTMAX_TOL, the same bits again; device
             time, plain time, the byte bound, the bytes a slot the design
             moves (12 H + 10: scores in both sweeps, weights once, dstb and
             valid once a sweep) beside the bound's 8 H + 5, both as GB/s,
             the layout's padding share and host build seconds. The kernel's
             stats sweep is a segmented reduction: each warp walks its own
             range of the block's slots, each thread folding 8 consecutive
             slots in registers and the warp joining them with a 5-step
             shuffle scan; runs inside a warp's range are stored once, and
             only runs that cross ranges are joined by one thread in order
  gnn        train: 50 steps of make_gnn_train_step with AdamW(lr 1e-3) on
             full_graph_sm uncut (symmetrize(rmat(12, 2, seed=0)) padded to
             16,384 masked slots, d_feat 1433, 7 classes): ms per step
             (median, min, max), steps/s over the wall, the softmax kernel's
             launches (counted: 2 a step), the loss falling, and the first
             step's loss and grads against a plain-softmax run within
             GNN_TOL. infer: make_gnn_infer on the smoke graph's COO at
             ogbn-products' widths (d_feat 100, 47 classes; the graph cut from
             2,449,408 / 61,859,328 to 1,048,576 / 31,403,850 by chip time and
             the host build): ms per forward, edges/s, launches (2 a
             forward), device idle share of one profiled forward, peak
             memory, outputs within 1e-4 of a plain-softmax run. Then one
             train step at published width of each other arch on its cell
             (gcn-cora, schnet, meshgraphnet on full_graph_sm; graphsage on
             minibatch_lg's sizes, a seeded graph, loss on 1024 seed nodes;
             gin-tu on molecule): the loss must be finite; graphsage's
             batch is a NeighborSampler batch of the smoke graph (1,024
             seeds, fanouts 15-10, d_feat 602)

Training infrastructure (after gnn, its tensors freed):

  recovery   (a) pagerank(tol=0.0) through make_iteration under
             run_with_recovery (checkpoints every 15 steps) on the smoke
             partition, read back from the distributed phase's files (the
             fields it does not read dropped there): 40 steps, then a run
             stopped at 20 and resumed from 15, labels bit for bit the whole
             run's; #1's launches counted (85 iterations x l); checkpoint
             bytes, save and restore seconds. (b) graphsage at published
             width (minibatch_lg) on NeighborSampler batches of the smoke
             graph through ShardedLoader under run_with_recovery (every 4):
             12 steps with prefetch(depth 2) and one marked failure at step
             2 (retried once, the step's batch reused), then without
             prefetch 6 steps and a resume from 4: the restored state bit
             for bit the saved one, the final params within GNN_TOL of the
             whole run's; ms a step with and without prefetch, the
             sampler's host ms a batch, H2D bytes a batch, sampled edges.
             (c) python -m repro_torch.launch.train --arch smollm-135m
             --steps 40 --ckpt DIR --ckpt-every 10, SIGKILLed once
             step_00000020 exists, rerun past a planted .tmp: it resumes from
             the newest complete step and ends within 1e-5 of an
             uninterrupted run's loss (the bits compared too); #6's float32
             launches from both runs. (d) tests/test_elastic.py's TINY LM in
             gloo ranks sharing the card (spawn_ranks): 3 steps at 2 ranks
             with int8 error-feedback sync and a save, a replicated restore
             at 4 ranks through restore_checkpoint's shardings, 3 more steps;
             int8 and top-k on the card bit for bit the CPU's; the sync's
             wire bytes against float32's

The LM family on the flash-attention kernel (after recovery; gnn's tensors
freed first):

  flash_kernel  the kernel against its plain version (its block schedule,
             float32 inside) and the full-logit oracle run in float32 on the
             same inputs, at (a) smollm-135m's layer at prefill_32k's S =
             32,768 (Hq 9, Hkv 3, D 64, bf16; the oracle on the first 4096
             positions, whose logits fit), (b) llama3-8b's at S = 4096 (Hq
             32, Hkv 8, D 128, bf16), (c) (a)'s widths at S = 4096 in
             float32, (d) the train step's layer, (a)'s widths at B = 4, S =
             4096, bf16: within FLASH_F32_TOL / FLASH_BF16_TOL, the same bits
             again; ms by CUDA events over 20 back-to-back launches and
             TFLOP/s (causal flops over ms), plain ms, the oracle's ms where
             it fits, the library call's ms (F.scaled_dot_product_attention,
             a yardstick), the bound; the HMMA / HGMMA count of each
             kernel's SASS (cuobjdump), none in the bf16 kernel failing
  lm         smollm-135m at published width (30 layers, d 576, bf16), seeded
             weights: prefill at prefill_32k's S = 32,768 (batch cut to 1):
             ms and tokens/s, 30 launches a prefill, logits at S = 4096
             against a plain-attention run; decode: serve_lm's greedy loop
             against decode_32k's 32,768-slot cache, batch cut to 32, 32
             tokens after a 2-token warm run: tokens/s and ms a token, and a
             64-token prompt decoded
             step by step against the forward (bf16 and float32); train: 10
             AdamW steps at train_4k's S = 4096 (batch cut to 4): ms a step,
             2 launches a layer a step, the loss falling, the first step's
             loss and grads against a plain-attention run. Then one prefill
             (B = 1, S = 4096) of granite-moe-1b-a400m, llama3-8b and
             qwen3-14b at published width and qwen3-moe-30b-a3b cut to 12
             of its 48 layers: finite logits, launches = layers
  launch     the launch tooling: (a) ``python -m repro_torch.launch.dryrun``
             on the fake production mesh ``single`` (256 ranks, (data=16,
             model=16)), one process a cell, for LAUNCH_DRY_CELLS (one a
             family, and granite-moe-1b-a400m/train_4k: the grouped MoE
             dispatch and the vocab-parallel loss): each record ``ok``, its
             per-device FLOPs, bytes, collectives, peak memory (by kind, and
             its largest tensors) and roofline terms kept; (b) ``--on-
             card`` for LAUNCH_CARD_CELLS, the cells that fit one card at
             their published shapes (din/serve_p99, a gat-cora train step on
             full_graph_sm, smollm-135m and granite-moe-1b-a400m (the
             ungrouped MoE dispatch) decoding against long_500k's 524,288
             slots): each traced fake on a one-rank mesh, then the same step
             on the card on inputs from the seed; gates: FlopCounterMode's
             count on the card equal to the trace's (and the kernels'
             formula FLOPs), the card's peak (max_memory_allocated after
             reset_peak_memory_stats) at most PEAK_SLACK x predicted + 64
             MiB; the ratio, the step's ms and the roofline's larger term
             printed

stream_build (ii)'s host build (the push footprint, then the scale-21
stream into memmap files) runs in a child process started right after
``build`` (``stream_child``), overlapping the card phases; stream_build
joins it and reopens its partition from the files.

Every kernel's ``ms`` is CUDA-event time around back-to-back launches,
with a spin kernel holding the stream while the host enqueues them; the
profiler's mean of the kernel's events stands beside it with the count of
events it saw of those launched. The profiler drops device events at
random in these runs, torch's own too (``profiler_probe_events``: the events it reports
for a window of one kernel), so busy times and idle shares from it are
floors.

Then a ``{"kernels": [...]}`` line (the laneless variants' launches from
main_path, the lane variants' from lanes_engine, both plus the distributed
ranks' and the NCCL arm's, the embedding bag's from
din, din_train, serve, the distributed ranks' recommend-for and
launch (b), timed at shape (a); the bag backward's from
din_train, timed at shape (e); the bucket kernel's from bucket; the
softmax kernel's from gnn's timed train steps and forwards, the
distributed GAT layers and launch (b)'s GAT steps, timed at shape (a); the flash kernel's from lm's counted prefills and train steps, timed
at shape (a); its float32 launches from recovery's trainer and ranks, timed
at shape (c); the gather kernel's sum_f32 launches include recovery's
PageRank) and, last, ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero; it also exits non-zero, printing no
result, when no CUDA device is present or the port's sources are missing.

``--scale N`` shrinks the graph for a quick run. ``--cpu-rehearsal`` runs
every phase on the CPU through the plain versions at a small scale (DIN, the
five other GNNs and the LMs at their smoke configs, GAT at 64 features, 3
train steps, the LM and kernel sequence lengths cut 64-fold), to check the
script's control flow without a card; it always exits 3.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import itertools
import json
import multiprocessing
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor-core rate, dense
SEED = 0
# push_block=65536 puts each core's whole gathered block (p * sub_size =
# 65,536 sources) in one push source block (B = 1). The push stream pads
# every (core, phase, block) to the fattest one's tile count, so on this
# skewed graph the auto-sized block (32 sources, B = 2048) would stack
# 2048 x 1391 tiles per bucket, about 187 GB of words; at B = 1 the push
# stream is about 5 GB beside the pull stream's 3.8 GB. Frontier skipping
# survives B = 1: edges in a block are sorted by source and each push tile
# has its own coverage words.
CFG = dict(p=4, l=16, tile_vb=1024, tile_eb=128, build_push=True, push_block=65536)
SUM_TOL = dict(rtol=1e-5, atol=1e-9)
GATHER = dict(source="src/repro_torch/csrc/gather_reduce_cores.cu",
              replaces="src/repro/kernels/csr_gather_reduce/kernel.py:221")
SCATTER = dict(source="src/repro_torch/csrc/scatter_reduce_cores.cu",
               replaces="src/repro/kernels/csr_gather_reduce/kernel.py:373")
FETCH_SHARE = 0.3  # share of real tiles a seeded fetch map keeps
INF_F32 = 3.4028234663852886e38  # float32 max, the SSSP identity
LANE_K = 16  # queries per multi-query batch (the serving width)
# lane arm -> (kind, edge_op, identity, payload lanes, payload kind, laneless variant)
LANE_ARMS = {
    "or_w1": ("or", "none", 0.0, 1, "words", "min_u32"),  # K = 16: one reach word
    "or_w2": ("or", "none", 0.0, 2, "words", "min_u32"),  # K = 40: two words
    "min_f32_add_l16": ("min", "add", INF_F32, 16, "dist", "min_f32_add"),
    "sum_f32_l16": ("sum", "none", 0.0, 16, "rank", "sum_f32"),
    "min_f32_add_l64": ("min", "add", INF_F32, 64, "dist", "min_f32_add"),  # lane chunks
}
PUSH_LANE_ARMS = ("or_w1", "min_f32_add_l16")
# lane variants the K = 16 paths launch, by kernel, and the arm that times each
LANE_ENTRIES = {
    "gather": (("or_u32_lanes", "or_w1"), ("min_f32_add_lanes", "min_f32_add_l16"),
               ("sum_f32_lanes", "sum_f32_l16")),
    "scatter": (("or_u32_lanes", "or_w1"), ("min_f32_add_lanes", "min_f32_add_l16")),
}
LANE_VARIANTS = {f"{k}_reduce_cores": tuple(v for v, _ in e) for k, e in LANE_ENTRIES.items()}
PPR_RUN_TOL = 1e-4  # the serving router's PPR tolerance
SERVE_QUERIES = 128
SERVE_INSERTS = 512
# the insertions in one batch, flushed once mid-stream (a second flush
# re-tiles the same ~62 of 64 buckets again: ~50 s more and no new check)
SERVE_FLUSHES = 1
EMBAG = dict(source="src/repro_torch/csrc/embedding_bag.cu",
             replaces="src/repro/kernels/embedding_bag/kernel.py:75")
EMBAG_BWD = dict(source="src/repro_torch/csrc/embedding_bag_backward.cu",
                 replaces="none: no TPU counterpart (the reference differentiates its XLA bag, "
                          "src/repro/models/recsys/din.py:84)")
BUCKET = dict(source="src/repro_torch/csrc/gather_reduce.cu",
              replaces="src/repro/kernels/csr_gather_reduce/kernel.py:159")
SOFTMAX = dict(source="src/repro_torch/csrc/segment_softmax.cu",
               replaces="src/repro/kernels/segment_softmax/kernel.py:66")
FLASH = dict(source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:75")
BAG_TOL = dict(rtol=1e-5, atol=1e-7)  # both sum in id order (in fact the same bits)
DIN_TOL = dict(rtol=1e-5, atol=1e-6)
SOFTMAX_TOL = dict(rtol=1e-5, atol=1e-7)  # online rescaling vs the plain version's final max
GNN_TOL = dict(rtol=1e-5, atol=1e-6)
DIN_BATCH, DIN_CANDIDATES, DIN_CHUNK = 512, 4096, 512  # the reference CLI's sizes
# flash kernel against its plain version and the full-logit oracle: float32
# as tests/test_kernels.py:190; bf16 out, one ulp (2^-7 of the value), as
# both compute the same float32 values up to reassociation (the oracle run in
# float32 on the same bf16 inputs, then rounded)
FLASH_F32_TOL = dict(rtol=2e-5, atol=2e-5)
# flash_phase's float32 shapes: (c) timed, (e) and (f) the shapes recovery's
# trainer and elastic ranks give the kernel
FLASH_F32_SHAPES = ("c_smollm_4k_f32", "e_cli_trainer_f32", "f_elastic_rank_f32")
FLASH_BF16_TOL = dict(rtol=2 ** -7, atol=1e-6)
FLASH_REPS = 20  # back-to-back launches a CUDA-event reading
HOLD_MAX_S = 0.2  # the longest the stream is held while the host enqueues a timed run
# launches enqueued a hold: well inside the launch queue, which on the card
# blocks the host somewhere below 1,280 queued launches (tools/kernel_arm_times.py)
QUEUED_LAUNCHES = 256
SPIN_CYCLES_PER_S = 2e9  # torch.cuda._sleep cycles a second: at most the SM clock
# LM at published width in bf16, relative L2 error ||a - b|| / ||b||: the
# kernel path against a plain-attention run (attention outputs that differ
# by a bf16 ulp here and there, carried through 30 layers), and decode (the
# reference's bf16 decode attention: bf16 logits and weights) against the
# kernel path's forward; float32 decode against float32 forward within the
# reference's atol 2e-3 (tests/test_models.py:35)
LM_KERNEL_REL = 2e-2
LM_DECODE_REL = 1e-1
LM_DECODE_F32_ATOL = 2e-3
LM_PROMPT = 64  # decode-vs-forward prompt
LM_DECODE_TOKENS, LM_DECODE_BATCH = 32, 32  # decode_32k's batch cut from 128
LM_TRAIN_BATCH, LM_TRAIN_STEPS = 4, 10  # train_4k's batch cut from 256
LM_OTHER = (("granite-moe-1b-a400m", None), ("llama3-8b", None), ("qwen3-14b", None),
            ("qwen3-moe-30b-a3b", 12))  # (arch, layers cut to)
BAG_ROUNDS = 2  # bag timing: (sum, mean, mean, sum) this many times per shape
COLD_SETS = 8  # id sets of shape (c) in rotation: ~160 MB of row sectors, past the 50 MB L2
DIN_TRAIN_STEPS = 10
# the sort's traffic a bag-backward id slot: the stable sort writes a key (4 B)
# and a position (8 B), read back once by the run starts and the kernel
SORT_BYTES_PER_ID = 24
# the partition fields whose bytes define streaming == in-memory
IDENTITY_FIELDS = (
    "src_gidx", "dst_lidx", "valid", "weights", "bucket_sizes",
    "tile_word", "tile_word_hi", "tile_counts", "tile_weights",
    "tile_coverage", "tile_row_pos", "tile_row_orig", "tile_split_map",
    "push_word", "push_word_hi", "push_counts", "push_weights",
    "push_coverage",
)
STREAM_PUSH_BLOCKS = (65536, 131072)  # push_block candidates of the scale-21 stream
STREAM_JOIN_TIMEOUT_S = 900  # stream_build waits this long at most for the build child
# the multi-channel engine: one rank a graph core, sharing the one card over
# gloo (the crossbar staged through the host); a spawn's time limit
DIST_TIMEOUT_S = 600
DIST_BUDGET = 64  # the frontier engine's sparse-exchange budget K (the reference's default)
# PageRank, distributed vs single-process: the reference's own tolerance
# (tests/test_distributed_equiv.py)
DIST_PR_TOL = dict(rtol=2e-5, atol=1e-8)
# a sum of rows on the card against another order: 1e-5 of the sum of the
# terms' magnitudes (the float32 reassociation bound), plus a floor
AGG_REL = 1e-5
NCCL_SCALE = 16  # the NCCL arm: world size 1, a p = 1 partition of RMAT scale 16
# recommend-for at the ranks' table shards: DIN configs and queries a config
# "spread": the smoke DIN at 12 items (3 rows a shard) and 4 history slots
# (one id a rank): the smoke graph's 64 hubs spread over the shards, so no
# queue overflows and every answer is held against the one-shard scorer's
REC_CONFIGS = ("published", "spread")
# the launch phase: one dry-run cell a family on the fake single mesh, and the
# cells that fit one card at their published shapes, run on it
# (granite-moe train_4k: the grouped MoE dispatch and the vocab-parallel
# loss; its long_500k on the card: the ungrouped dispatch, 24 layers against
# a 524,288-slot bf16 cache, ~29 GB)
LAUNCH_DRY_CELLS = (("smollm-135m", "long_500k"), ("gat-cora", "full_graph_sm"),
                    ("din", "serve_p99"), ("granite-moe-1b-a400m", "train_4k"))
LAUNCH_CARD_CELLS = ("din/serve_p99", "gat-cora/full_graph_sm", "smollm-135m/long_500k",
                     "granite-moe-1b-a400m/long_500k")
PEAK_SLACK = 1.10  # the card's peak may exceed the prediction by 10% (+ 64 MiB)
LAUNCH_TIMEOUT_S = 600
REC_QUERIES = 8
# recovery: the reference's kill-and-resume schedules (tests/test_fault_tolerance.py),
# GraphSAGE's on minibatch_lg, the trainer CLI's, and the elastic LM's ranks
PR_RESUME = dict(steps=40, every=15, stop=20)
SAGE_RESUME = dict(steps=12, every=4, stop=6, inject_at=2, depth=2)
# the trainer CLI's LM batch and sequence (its defaults, passed explicitly:
# flash_phase checks the kernel at the shapes they give it)
CLI_RESUME = dict(steps=40, every=10, kill_at=20, batch=8, seq=128)
ELASTIC = dict(before=2, after=4, steps=3, seq=32)  # one row of `seq` tokens a rank
# tests/test_elastic.py's TINY LM
ELASTIC_LM = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                  vocab=128, attn_chunk=16)
CLI_LOSS_REL = 1e-5  # the resumed trainer's final loss against an uninterrupted run's
# partition fields a PageRank pull run does not read (the push stream, the weights)
RECOVERY_UNREAD = ("push_word", "push_word_hi", "push_counts", "push_weights", "push_coverage",
                   "tile_weights", "weights", "graph_weights")


def emit(phase: str, t0: float, **kw) -> None:
    print(json.dumps({"phase": phase, "seconds": time.perf_counter() - t0, **kw}), flush=True)


class SmokeFailure(RuntimeError):
    pass


class RssPeak:
    """This process's resident set (VmRSS of /proc/self/status) while a block
    runs, sampled every 5 ms: its value at entry, its peak and the peak's
    rise. A memmap build's written file pages count in it."""

    def __enter__(self):
        self.base = self.peak = self._now()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._watch, daemon=True)
        self.thread.start()
        return self

    @staticmethod
    def _now() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        raise SmokeFailure("/proc/self/status has no VmRSS")

    def _watch(self):
        while not self.stop.wait(0.005):
            self.peak = max(self.peak, self._now())

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self.peak = max(self.peak, self._now())

    def report(self) -> dict:
        return dict(rss_before_bytes=self.base, rss_peak_bytes=self.peak,
                    rss_peak_delta_bytes=self.peak - self.base)


def field_digests(pg) -> dict:
    """SHA-256 of each IDENTITY_FIELDS array's dtype, shape and bytes (None
    where absent), the fields hashed in parallel (hashlib releases the GIL)."""
    import numpy as np

    def digest(name):
        a = getattr(pg, name)
        if a is None:
            return None
        a = np.ascontiguousarray(a)
        h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
        h.update(memoryview(a.reshape(-1).view(np.uint8)))
        return h.hexdigest()

    with ThreadPoolExecutor(8) as pool:
        return dict(zip(IDENTITY_FIELDS, pool.map(digest, IDENTITY_FIELDS)))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def save_partition(pg, g, where: Path) -> int:
    """Write every array field of ``pg`` and the graph's edge arrays as .npy
    files under ``where`` (in parallel), the scalars and the config as JSON,
    so spawned ranks memory-map them instead of unpickling the partition.
    Returns the bytes written."""
    import numpy as np

    shutil.rmtree(where, ignore_errors=True)
    where.mkdir(parents=True)
    arrays, scalars, absent = {}, {}, []
    for f in dataclasses.fields(pg):
        v = getattr(pg, f.name)
        if f.name == "device_cache":
            continue
        if isinstance(v, np.ndarray):
            arrays[f.name] = v
        elif v is None:
            absent.append(f.name)
        elif f.name == "config":
            scalars[f.name] = dataclasses.asdict(v)
        else:
            scalars[f.name] = int(v)
    arrays.update(graph_src=g.src, graph_dst=g.dst)
    if g.weights is not None:
        arrays["graph_weights"] = g.weights
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda kv: np.save(where / f"{kv[0]}.npy", kv[1]), arrays.items()))
    (where / "meta.json").write_text(json.dumps(dict(
        scalars=scalars, absent=absent, arrays=sorted(arrays), graph_vertices=g.num_vertices)))
    return sum(a.nbytes for a in arrays.values())


def load_partition(where: Path):
    """``save_partition``'s partition and graph, their arrays memory-mapped."""
    import numpy as np

    from repro_torch.core.graph import COOGraph
    from repro_torch.core.partition import PartitionedGraph

    meta = json.loads((where / "meta.json").read_text())
    arrs = {n: np.load(where / f"{n}.npy", mmap_mode="r") for n in meta["arrays"]}
    g = COOGraph(src=arrs.pop("graph_src"), dst=arrs.pop("graph_dst"),
                 num_vertices=meta["graph_vertices"], weights=arrs.pop("graph_weights", None))
    pg = PartitionedGraph.from_numpy({**meta["scalars"], **arrs,
                                      **{n: None for n in meta["absent"]}})
    return pg, g


def drop_partition_fields(where: Path, names) -> int:
    """Delete ``save_partition``'s files of the array fields ``names`` (read
    back as absent); returns the bytes freed."""
    meta = json.loads((where / "meta.json").read_text())
    freed = 0
    for n in names:
        if n in meta["arrays"]:
            freed += (where / f"{n}.npy").stat().st_size
            (where / f"{n}.npy").unlink()
            meta["arrays"].remove(n)
            if not n.startswith("graph_"):
                meta["absent"].append(n)
    (where / "meta.json").write_text(json.dumps(meta))
    return freed


def stream_child(spec: dict) -> None:
    """stream_build (ii)'s host work in a child process, started right after
    ``build`` so it overlaps the card phases: the push footprint of each
    candidate push_block (``stream_push_footprint``), then the symmetric
    RMATStream's out-of-core build into memmap files under ``spec["dir"]``.
    Writes ``meta.json`` there: every array field as its memmap file (or a
    small .npy), the scalars, and the build's figures; ``stream_build``
    reopens the partition from it (``load_stream_partition``)."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core.partition import PartitionConfig, partition_2d_streaming
    from repro_torch.data import RMATStream
    from repro_torch.push_footprint import stream_push_footprint

    mdir = Path(spec["dir"])
    shutil.rmtree(mdir, ignore_errors=True)
    mdir.mkdir(parents=True)
    stream = RMATStream(scale=spec["scale"], edge_factor=16, seed=SEED, symmetric=True)
    nv = stream.num_vertices
    t = time.perf_counter()
    foot = stream_push_footprint(stream, nv, PartitionConfig(**CFG), STREAM_PUSH_BLOCKS,
                                 CFG["tile_eb"])
    foot_s = time.perf_counter() - t
    best = min(foot, key=lambda r: r["word_bytes"] + r["coverage_bytes"])
    cfg_ii = {**CFG, "push_block": best["block_sources"]}
    t = time.perf_counter()
    with RssPeak() as rss:
        pm = partition_2d_streaming(stream, nv, PartitionConfig(**cfg_ii),
                                    memmap_dir=str(mdir / "memmap"))
    build_s = time.perf_counter() - t
    arrays, scalars, absent = {}, {}, []
    for f in dataclasses.fields(pm):
        v = getattr(pm, f.name)
        if f.name == "device_cache":
            continue
        if isinstance(v, np.memmap):
            v.flush()
            arrays[f.name] = dict(file=str(v.filename), dtype=v.dtype.str, shape=list(v.shape),
                                  offset=int(v.offset))
        elif isinstance(v, np.ndarray):
            np.save(mdir / f"{f.name}.npy", v)
            arrays[f.name] = dict(npy=f"{f.name}.npy")
        elif v is None:
            absent.append(f.name)
        elif f.name == "config":
            scalars[f.name] = dataclasses.asdict(v)
        else:
            scalars[f.name] = int(v)
    (mdir / "meta.json").write_text(json.dumps(dict(
        arrays=arrays, scalars=scalars, absent=absent, push_footprint=foot,
        push_footprint_seconds=foot_s, best=best, config=cfg_ii, build_seconds=build_s,
        rss=rss.report(), chunk_edges=stream.chunk_edges, stream_edges=stream.num_edges,
        vertices=nv, pid=os.getpid())))


def load_stream_partition(where: Path):
    """``stream_child``'s partition, its large arrays reopened as read-only
    memmaps of the child's files, and the child's record."""
    import numpy as np

    from repro_torch.core.partition import PartitionConfig, PartitionedGraph

    meta = json.loads((where / "meta.json").read_text())
    fields = {"config": PartitionConfig(**meta["scalars"].pop("config"))}
    for name, a in meta["arrays"].items():
        if "npy" in a:
            fields[name] = np.load(where / a["npy"])
        else:
            fields[name] = np.memmap(a["file"], dtype=np.dtype(a["dtype"]), mode="r",
                                     shape=tuple(a["shape"]), offset=a["offset"])
    # the constructor, not from_numpy, which would make the memmaps plain arrays
    pm = PartitionedGraph(**meta["scalars"], **fields, **{n: None for n in meta["absent"]})
    return pm, meta


def label_digest(labels: dict) -> str:
    """SHA-256 over a result's label arrays (key, dtype, shape, bytes)."""
    import numpy as np

    h = hashlib.sha256()
    for k in sorted(labels):
        a = np.ascontiguousarray(labels[k])
        h.update(f"{k}{a.dtype.str}{a.shape}".encode())
        h.update(memoryview(a.reshape(-1).view(np.uint8)))
    return h.hexdigest()


def _cora_shape(d_feat: int, n_classes: int):
    """gat-cora's full_graph_sm graph (symmetrize(rmat(12, 2, seed 0)),
    4096 nodes), its seeded features and labels (CPU)."""
    import repro_torch.core.graph as G
    from repro_torch.data.synthetic import graph_batch_from_coo

    gcora = G.symmetrize(G.rmat(12, 2, seed=SEED))
    b, lab = graph_batch_from_coo(gcora.src, gcora.dst, gcora.num_vertices, d_feat, seed=SEED,
                                  n_classes=n_classes)
    return gcora, b, lab


def distributed_rank(rank: int, group, spec: dict) -> dict:
    """One rank (graph core) of the multi-channel engine on the smoke
    partition, then GNN aggregation, GAT training math and the crossbar
    lookup over the same ranks. The counted paths run first, the kernel
    launch counts are read right after them, and only then the comparisons
    that launch kernels themselves (not counted)."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    import repro_torch.core.graph as G
    from repro_torch.configs.registry import get as get_arch
    from repro_torch.core.distributed import build_distributed_run, run_distributed, transport
    from repro_torch.core.engine import EngineOptions, prepare_labels
    from repro_torch.core.frontier import run_distributed_frontier
    from repro_torch.core.partition import PartitionConfig, partition_2d
    from repro_torch.core.problems import bfs, bfs_multi, pagerank, sssp, wcc
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.dist.embedding import crossbar_lookup_local, make_crossbar_lookup, make_exchange
    from repro_torch.dist.gat_parallel import make_gat_graphscale_loss
    from repro_torch.dist.gnn_parallel import make_graphscale_aggregate, shard_features
    from repro_torch.kernels.csr_gather_reduce import kernel as K
    from repro_torch.kernels.csr_gather_reduce import scatter as S
    from repro_torch.kernels.segment_softmax import kernel as SK
    from repro_torch.models.gnn import archs as gnn_archs
    from repro_torch.models.gnn.common import aggregate
    from repro_torch.train.losses import masked_softmax_xent
    from repro_torch.train.optim import tree_flatten

    dev = torch.device(spec["device"])
    p = spec["ranks"]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    pg, g = load_partition(Path(spec["dir"]))
    static = EngineOptions(dynamic_tile_skip=False)
    runs = [("bfs", bfs(0), EngineOptions()), ("wcc", wcc(), EngineOptions()),
            ("sssp", sssp(0), EngineOptions()), ("pagerank", pagerank(), EngineOptions()),
            ("bfs_static", bfs(0), static), ("wcc_static", wcc(), static),
            ("sssp_static", sssp(0), static),
            ("bfs_multi", bfs_multi(spec["roots"]), EngineOptions(lanes=len(spec["roots"])))]
    device_bytes = {}
    for name, problem, opts in runs:  # this core's stream on the card (set-up)
        device_bytes[name] = build_distributed_run(problem, pg, group, opts, dev).device_bytes
    labels0 = {name: prepare_labels(problem, g, pg, device=dev) for name, problem, _ in runs}
    # the GNN inputs: gat-cora's Cora shape (set-up)
    gat_cfg = get_arch("gat-cora").model
    gcora, cb, clab = _cora_shape(spec["d_feat"], spec["n_classes"])
    pga = partition_2d(gcora, PartitionConfig(p=p, l=4, lane=8))
    pgt = partition_2d(gcora, PartitionConfig(p=p, l=1, lane=8))
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    params = gnn_archs.init(gat_cfg, spec["d_feat"], spec["n_classes"], gen, dev)
    for k in ("l1_asrc", "l1_adst", "l2_asrc", "l2_adst"):
        params[k] = torch.randn(params[k].shape, generator=gen, device=dev) * 0.5
    leaves = [t.requires_grad_() for t in tree_flatten(params)[0]]
    vpc = pgt.vertices_per_core
    tedges = [torch.from_numpy(np.ascontiguousarray(a[rank : rank + 1])).to(dev)
              for a in (pgt.src_gidx, pgt.dst_lidx, pgt.valid)]
    lab_pad = np.zeros(pgt.padded_vertices, np.int32)
    lab_pad[pgt.perm[: gcora.num_vertices] if pgt.perm is not None else slice(0, gcora.num_vertices)] \
        = clab
    mask_pad = np.zeros(pgt.padded_vertices, np.float32)
    mask_pad[pgt.perm[: gcora.num_vertices] if pgt.perm is not None else slice(0, gcora.num_vertices)] \
        = 1.0
    lab_t = torch.from_numpy(lab_pad[rank * vpc : (rank + 1) * vpc]).to(dev)
    mask_t = torch.from_numpy(mask_pad[rank * vpc : (rank + 1) * vpc]).to(dev)
    feat_a = shard_features(cb.node_feat.numpy(), pga, group, dev)
    feat_t = shard_features(cb.node_feat.numpy(), pgt, group, dev)
    # the lookup: DIN's item table at published width, sharded over the ranks
    vocab, dim = spec["item_vocab"], spec["embed_dim"]
    tgen = torch.Generator(device=dev).manual_seed(SEED + 11)
    table = torch.randn(vocab, dim, generator=tgen, device=dev)
    rows = vocab // p
    local = table[rank * rows : (rank + 1) * rows].clone().requires_grad_()
    all_ids = [torch.from_numpy(recsys_batch(SEED, r, spec["batch"], spec["seq_len"], vocab,
                                             spec["cate_vocab"])["hist_items"]).to(dev)
               for r in range(p)]
    sync()
    setup_s = time.perf_counter() - t0

    # -- the counted paths ---------------------------------------------------
    K.reset_launch_counts()
    S.reset_launch_counts()
    SK.reset_launch_counts()
    out = {"runs": {}, "setup_seconds": setup_s}
    for name, problem, opts in runs:
        sync()
        t = time.perf_counter()
        res = run_distributed(problem, g, pg, group, opts, labels=labels0[name], device=dev)
        sync()
        out["runs"][name] = dict(iterations=res.iterations, converged=res.converged,
                                 seconds=time.perf_counter() - t,
                                 digest=label_digest(res.labels),
                                 labels=res.labels if rank == 0 else None)
    sync()
    t = time.perf_counter()
    fres, fstats = run_distributed_frontier(bfs(0), g, pg, group, budget=spec["budget"],
                                            device=dev)
    sync()
    out["frontier"] = dict(iterations=fres.iterations, converged=fres.converged,
                           seconds=time.perf_counter() - t, stats=fstats,
                           digest=label_digest(fres.labels),
                           labels=fres.labels if rank == 0 else None)
    agg = make_graphscale_aggregate(pga, group, dev)(feat_a)
    loss_fn = make_gat_graphscale_loss(group, vpc, gat_cfg.n_heads, gat_cfg.d_hidden)
    sync()
    t = time.perf_counter()
    loss = loss_fn(params, feat_t, *tedges, lab_t, mask_t)
    grads = torch.autograd.grad(loss, leaves)
    sync()
    gat_s = time.perf_counter() - t
    exchange, n_shards = make_exchange(group)
    ids = all_ids[rank].reshape(-1)
    got = make_crossbar_lookup(group, capacity_factor=4.0)(local, ids)
    (g_local,) = torch.autograd.grad((got ** 2).sum(), local)
    # tight queues, the same depth on every rank: half the uniform share of
    # the ids (about half of them padding), so some shards overflow
    cap = max(1, ids.shape[0] // (2 * n_shards))
    small, dropped = crossbar_lookup_local(local.detach(), ids, exchange, n_shards, cap)
    sync()
    out["launches"] = {"gather_reduce_cores": dict(K.LAUNCHES),
                       "scatter_reduce_cores": dict(S.LAUNCHES),
                       "segment_softmax": dict(SK.LAUNCHES)}

    # -- comparisons (not counted) ---------------------------------------------
    # aggregate: the single-device sum over the whole graph, in engine order,
    # within AGG_REL of the sum of the terms' magnitudes
    src_t = torch.from_numpy(gcora.src.astype(np.int64)).to(dev)
    dst_t = torch.from_numpy(gcora.dst.astype(np.int64)).to(dev)
    fx = cb.node_feat.to(dev)
    want = aggregate(fx[src_t], dst_t, gcora.num_vertices)
    scale = aggregate(fx[src_t].abs(), dst_t, gcora.num_vertices)

    def engine_rows(x):
        padded = torch.zeros((pga.padded_vertices, x.shape[1]), dtype=x.dtype, device=dev)
        where = torch.from_numpy(pga.perm[: gcora.num_vertices]).to(dev) if pga.perm is not None \
            else torch.arange(gcora.num_vertices, device=dev)
        padded[where] = x
        return padded.view(p, pga.vertices_per_core, -1)[rank]

    err = (agg[0] - engine_rows(want)).abs()
    out["aggregate"] = dict(max_abs_err=float(err.max()),
                            ok=bool((err <= AGG_REL * engine_rows(scale) + 1e-6).all()))
    # GAT: the port's dense loss and gradients on one device
    batch = cb.to(dev)
    dense = masked_softmax_xent(gnn_archs.apply(params, batch, gat_cfg),
                                torch.from_numpy(clab).to(dev),
                                torch.ones(gcora.num_vertices, device=dev))
    dgrads = torch.autograd.grad(dense, leaves)
    loss, dense = float(loss.detach()), float(dense.detach())
    gat_ok = abs(loss - dense) <= 1e-5 * abs(dense)
    worst = 0.0
    for a, b in zip(grads, dgrads):
        bound = 1e-5 * b.abs() + 1e-5 * float(b.abs().max())
        gat_ok &= bool(((a - b).abs() <= bound).all())
        worst = max(worst, float((a - b).abs().max() / max(float(b.abs().max()), 1e-30)))
    out["gat"] = dict(loss=loss, dense_loss=dense, seconds=gat_s, ok=gat_ok,
                      max_grad_err_over_max=worst)
    # the lookup: the one-shard lookup over the whole table
    one = make_crossbar_lookup()
    want_rows = one(table, ids)
    full = table.detach().clone().requires_grad_()
    (g_full,) = torch.autograd.grad(sum((one(full, i.reshape(-1)) ** 2).sum() for i in all_ids),
                                    full)
    g_want = g_full[rank * rows : (rank + 1) * rows]
    # the capacity run: which ids fit their shard's queue, in id order
    ids_np = ids.cpu().numpy()
    shard = np.where(ids_np >= 0, ids_np // rows, -1)
    served = np.zeros(ids_np.shape, bool)
    taken = np.zeros(n_shards, np.int64)
    for i, s_ in enumerate(shard):
        if s_ >= 0 and taken[s_] < cap:
            served[i], taken[s_] = True, taken[s_] + 1
    want_small = torch.where(torch.from_numpy(served).to(dev)[:, None], want_rows,
                             torch.zeros((), device=dev))
    out["lookup"] = dict(
        rows_equal=bool(torch.equal(got, want_rows)),
        grad_ok=bool(torch.allclose(g_local, g_want, rtol=1e-5, atol=1e-6)),
        grad_max_err=float((g_local - g_want).abs().max()),
        capacity=cap, dropped=int(dropped), dropped_expected=int(((shard >= 0) & ~served).sum()),
        small_rows_equal=bool(torch.equal(small, want_small)), ids=int(ids.shape[0]))
    out["recommend"] = recommend_sharded_rank(spec, pg, g, dev)
    out.update(transport=transport(group), device_bytes=device_bytes,
               cuda_device=torch.cuda.current_device() if dev.type == "cuda" else None)
    return out


def recommend_config(case: str, rehearsal: bool):
    """The DIN config of a REC_CONFIGS case (the rehearsal's "published" is
    the smoke config)."""
    from repro_torch.configs.registry import get as get_arch

    arch = get_arch("din")
    if case == "published":
        return arch.smoke() if rehearsal else arch.model
    return dataclasses.replace(arch.smoke(), item_vocab=12, seq_len=4)


def recommend_params(cfg):
    """recommend-for's DIN weights, drawn on the host from the seed (the
    same on every rank and in the parent)."""
    import torch

    from repro_torch.models.recsys import din

    return din.init(cfg, torch.Generator().manual_seed(SEED + 13), "cpu")


def recommend_sharded_rank(spec: dict, pg, g, dev) -> dict:
    """recommend-for through the router's table-sharded crossbar lookup
    (one item-table shard a rank, the ids split over the ranks) for
    ``spec["rec_roots"]``, per DIN config: on the card (bag launches
    counted), then the same queries on the CPU (not counted)."""
    import torch

    from repro_torch.kernels.embedding_bag import kernel as EB
    from repro_torch.serve import RecommendScorer
    from repro_torch.train.optim import tree_map

    out = {}
    for case in REC_CONFIGS:
        cfg = recommend_config(case, spec["rehearsal"])
        params = recommend_params(cfg)
        got = {}
        for where in (dev, torch.device("cpu")):
            s = RecommendScorer(cfg, pool_size=64, topk=8, device=where,
                                params=tree_map(lambda t: t.to(where), params))
            s.refresh_pool(g)
            EB.reset_launch_counts()
            t = time.perf_counter()
            answers, drops = [], []
            for r in spec["rec_roots"]:
                before = len(s.dropped)
                answers.append(s.recommend_for(pg, r))
                drops.append(sum(s.dropped[before:]))
            got[where.type] = dict(answers=answers, drops=drops, shards=s.table_shards,
                                   seconds=time.perf_counter() - t,
                                   bag_launches=dict(EB.LAUNCHES))
            del s
        out[case] = dict(card=got[dev.type], cpu=got["cpu"])
    return out


def nccl_rank(rank: int, group, spec: dict) -> dict:
    """The NCCL code path at world size 1: a p = 1 partition of RMAT scale
    NCCL_SCALE, BFS, WCC, SSSP and PageRank through the multi-channel engine
    (launches counted) against the single-process engine on the same card."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    import repro_torch.core.graph as G
    from repro_torch.core.distributed import run_distributed, transport
    from repro_torch.core.engine import EngineOptions, run
    from repro_torch.core.partition import PartitionConfig, partition_2d
    from repro_torch.core.problems import bfs, pagerank, sssp, wcc
    from repro_torch.kernels.csr_gather_reduce import kernel as K
    from repro_torch.kernels.csr_gather_reduce import scatter as S

    dev = torch.device(spec["device"])
    g0 = G.symmetrize(G.rmat(spec["scale"], 16, a=0.57, b=0.19, c=0.19, seed=SEED))
    w = np.random.default_rng(SEED).random(g0.num_edges).astype(np.float32)
    g = G.COOGraph(src=g0.src, dst=g0.dst, num_vertices=g0.num_vertices, weights=w)
    pg = partition_2d(g, PartitionConfig(p=1, l=4, tile_vb=1024))
    runs = [("bfs", bfs(0)), ("wcc", wcc()), ("sssp", sssp(0)), ("pagerank", pagerank())]
    K.reset_launch_counts()
    S.reset_launch_counts()
    got = {name: run_distributed(prob, g, pg, group, EngineOptions(), device=dev)
           for name, prob in runs}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = {"gather_reduce_cores": dict(K.LAUNCHES), "scatter_reduce_cores": dict(S.LAUNCHES)}
    agree = {}
    for name, prob in runs:
        want = run(prob, g, pg, EngineOptions(), device=dev)
        a, b = got[name].labels["label"], want.labels["label"]
        same = got[name].iterations == want.iterations
        if name == "pagerank":
            same &= bool(np.allclose(a, b, **DIST_PR_TOL))
        else:
            same &= a.dtype == b.dtype and bool(np.array_equal(a, b))
        agree[name] = dict(iterations=got[name].iterations, equal=same)
    return dict(transport=transport(group), launches=launches, agree=agree,
                edges=g.num_edges, vertices=g.num_vertices)


def recovery_rank(rank: int, group, spec: dict) -> dict:
    """tests/test_elastic.py's TINY LM data-parallel on this card, one row of
    the global batch (= world size) a rank: restore the newest checkpoint
    under spec["dir"] onto this world through ``restore_checkpoint``'s
    shardings (replicated, on a CPU DeviceMesh, then to the card) or start
    from seeded weights; ``spec["steps"]`` steps with the gradients synced
    by int8 error feedback; save from rank 0."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.distributed import _all_reduce_sum, transport
    from repro_torch.data.pipeline import ShardedLoader
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.dist.checkpoint import latest_step, restore_checkpoint, save_checkpoint
    from repro_torch.dist.compression import make_error_feedback, wire_bytes
    from repro_torch.dist.sharding import P, placements
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import transformer as tfm
    from repro_torch.train.optim import AdamWConfig, tree_flatten, tree_map
    from repro_torch.train.steps import init_train_state, make_lm_train_step

    dev = torch.device(spec["device"])
    world = dist.get_world_size(group)
    mesh = DeviceMesh("cpu", list(range(world)), mesh_dim_names=("data",))
    cfg = tfm.LMConfig(**spec["cfg"], dtype=torch.float32)
    ocfg = AdamWConfig(lr=1e-3, total_steps=100)
    state = init_train_state(tfm.init_params(cfg, torch.Generator().manual_seed(SEED), "cpu"),
                             ocfg)
    start, restore_s = 0, None
    if latest_step(spec["dir"]) is not None:
        t = time.perf_counter()
        replicated = tree_map(lambda _: (mesh, placements(P(), mesh)), state)
        state, meta = restore_checkpoint(spec["dir"], state, shardings=replicated)
        state = tree_map(lambda x: x.to_local(), state)
        restore_s = time.perf_counter() - t
        start = meta["next_step"]
    state = tree_map(lambda x: x.to(dev), state)
    ef_init, ef_apply = make_error_feedback("int8")
    ef = [ef_init(state["params"])]

    def sync(grads):
        synced, ef[0] = ef_apply(grads, ef[0], group)
        return synced

    rows = (mesh, placements(P("data", None), mesh))
    loader = ShardedLoader(
        lambda seed, i: lm_batch(seed=seed, step=i, batch=world, seq=spec["seq"],
                                 vocab=cfg.vocab),
        seed=SEED, shardings={"tokens": rows, "labels": rows}, start_step=start, device="cpu")
    step = make_lm_train_step(cfg, ocfg, grad_transform=sync)
    FK.reset_launch_counts()
    losses = []
    for _ in range(spec["steps"]):
        batch = {k: v.to_local().to(dev) for k, v in next(loader).items()}
        state, m = step(state, batch)
        losses.append(float(_all_reduce_sum(m["loss"], group)) / world)
    launches = dict(FK.LAUNCHES)
    end = loader.state()["next_step"]
    if rank == 0:
        save_checkpoint(spec["dir"], end, state, meta={"next_step": end})
    dist.barrier(group)
    n = sum(t.numel() for t in tree_flatten(state["params"])[0])
    return dict(start=start, step=end, losses=losses, restore_seconds=restore_s,
                transport=transport(group), flash_launches=launches,
                sync_wire_bytes=wire_bytes(state["params"], "int8"), sync_fp32_bytes=4 * n)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--stream-scale", type=int, default=21,
                    help="RMAT scale of stream_build's out-of-core build (21: the first past "
                         "the 16-bit source regime at the smoke's config)")
    ap.add_argument("--cpu-rehearsal", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import torch

    rehearsal = args.cpu_rehearsal
    if not rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # tile_vb=1024 must divide the l * sub_size rows per core: scale >= 12
    scale = 12 if rehearsal else args.scale
    if scale < 12:
        ap.error("--scale must be at least 12")
    dev = torch.device("cpu" if rehearsal else "cuda")
    # full float32 matmuls and convolutions (DIN's MLPs; the plain versions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core.graph as G
    from repro_torch.core import frontier_words as F
    from repro_torch.core import reference, u32
    from repro_torch.core.engine import (
        EngineOptions, _edge_constants, channel_phase_reduce, channel_phase_reduce_oracle,
        make_iteration, phase_consts_at, prepare_labels, run, run_frontier_trace,
    )
    from repro_torch.core.edge_centric import EdgeCentricOptions, run_edge_centric
    from repro_torch.core.graph import bytes_per_edge
    from repro_torch.core.partition import (
        PartitionConfig, coo_edge_chunks, partition_2d, partition_2d_streaming,
        partition_edge_centric,
    )
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.core.problems import (
        bfs, bfs_multi, pagerank, ppr_multi, sssp, sssp_multi, wcc,
    )
    from repro_torch.configs.registry import get as get_arch
    from repro_torch.data.synthetic import (
        DEFAULT_QUERY_MIX, edge_insertion_stream, mixed_query_workload, recsys_batch,
        retrieval_batch,
    )
    from repro_torch.kernels.build import build_library, cuda_tool, load_library
    from repro_torch.kernels.csr_gather_reduce import kernel as K
    from repro_torch.kernels.csr_gather_reduce import scatter as S
    from repro_torch.kernels.embedding_bag import (
        embedding_bag, embedding_bag_backward_reference, embedding_bag_reference,
    )
    from repro_torch.kernels.csr_gather_reduce import bucket as B
    from repro_torch.kernels.csr_gather_reduce import ops as BO
    from repro_torch.kernels.embedding_bag import kernel as EB
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.segment_softmax import kernel as SK
    from repro_torch.models.recsys import din

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # -- card -----------------------------------------------------------------
    t0 = time.perf_counter()
    if rehearsal:
        smi, kind, count = "cpu rehearsal", "cpu", 0
    else:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
        kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
        print(smi, flush=True)
    emit("card", t0, nvidia_smi=smi, kind=kind, count=count,
         torch=torch.__version__, cuda=torch.version.cuda)

    # -- build: one nvcc per source, all started together ----------------------
    t0 = time.perf_counter()
    if not rehearsal:
        sources = (K.SOURCE, S.SOURCE, EB.SOURCE, EB.BACKWARD_SOURCE, B.SOURCE, SK.SOURCE,
                   FK.SOURCE)
        with ThreadPoolExecutor(len(sources)) as pool:
            logs = dict(zip(sources, pool.map(lambda s: build_library(s)[1], sources)))
        for s in sources:
            load_library(s)
        ptxas = {s: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
                 for s, log in logs.items()}
        emit("build", t0, sources=[m["source"] for m in (GATHER, SCATTER, EMBAG, EMBAG_BWD, BUCKET,
                                                         SOFTMAX, FLASH)],
             ptxas=ptxas)

    # -- stream_build (ii)'s host build, in a child overlapping the card phases
    st_scale = min(args.stream_scale, 13) if rehearsal else args.stream_scale
    stream_dir = ROOT / "build" / "stream_build"
    stream_started = time.perf_counter()
    stream_proc = multiprocessing.get_context("spawn").Process(
        target=stream_child, args=(dict(dir=str(stream_dir), scale=st_scale),), daemon=True)
    stream_proc.start()  # daemonic: ended with this process however it exits

    # -- graph ----------------------------------------------------------------
    t0 = time.perf_counter()
    g0 = G.symmetrize(G.rmat(scale, 16, a=0.57, b=0.19, c=0.19, seed=SEED))
    w = np.random.default_rng(SEED).random(g0.num_edges).astype(np.float32)
    g = G.COOGraph(src=g0.src, dst=g0.dst, num_vertices=g0.num_vertices, weights=w)
    n_edges = g.num_edges
    emit("graph", t0, scale=scale, edge_factor=16, vertices=g.num_vertices, edges=n_edges)

    # -- partition ------------------------------------------------------------
    t0 = time.perf_counter()
    with RssPeak() as partition_rss:
        pg = partition_2d(g, PartitionConfig(**CFG))
    partition_s = time.perf_counter() - t0
    rep = pg.memory_report()
    t = time.perf_counter()
    pg_digests = field_digests(pg)  # stream_build's identity check, after pg is retired
    pg_scalars = {k: getattr(pg, k) for k in ("p", "l", "sub_size", "num_vertices", "num_edges",
                                              "src_bits", "split_rows", "push_block",
                                              "push_src_bits", "t_max_unsplit")}
    digest_s = time.perf_counter() - t
    emit("partition", t0, config=CFG, build_seconds=partition_s, digest_seconds=digest_s,
         rss=partition_rss.report(), src_bits=pg.src_bits, sub_size=pg.sub_size,
         tile_word_shape=list(pg.tile_word.shape), split_rows=pg.split_rows,
         row_map="split" if pg.tile_split_map is not None else "row_pos",
         skipped_tile_fraction=pg.skipped_tile_fraction,
         tile_padding_ratio=pg.tile_padding_ratio,
         push_word_shape=list(pg.push_word.shape), push_src_bits=pg.push_src_bits,
         push_block=pg.push_block, push_real_tiles=int(pg.push_counts.sum()),
         push_real_share=float(pg.push_counts.sum()) / pg.push_counts.size / pg.push_word.shape[3],
         coverage_shape=list(pg.tile_coverage.shape),
         device_bytes=rep["device"], device_total_bytes=rep["device_total_bytes"],
         device_bytes_per_edge=rep["device_bytes_per_edge"],
         host_flat_total_bytes=rep["host_flat_total_bytes"])

    # -- helpers shared by every path ------------------------------------------
    rng = np.random.default_rng(SEED + 1)
    problems = {"min_u32": bfs(0), "min_f32_add": sssp(0), "sum_f32": pagerank()}
    push_variants = ("min_u32", "min_f32_add")

    def payload_for(variant: str, n: int) -> torch.Tensor:
        if variant == "min_u32":
            v = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
            v[rng.random(n) < 0.1] = u32.U32_MAX
            return u32.to_bits(v).to(dev)
        if variant == "min_f32_add":
            v = (rng.random(n) * 100).astype(np.float32)
            v[rng.random(n) < 0.1] = np.finfo(np.float32).max
            return torch.from_numpy(v).to(dev)
        return torch.from_numpy((rng.random(n) / n).astype(np.float32)).to(dev)

    def seeded_fetch(counts: torch.Tensor, t_tiles: int, share: float) -> torch.Tensor:
        """A fetch map keeping about ``share`` of the real tiles (1.0: all)."""
        real = torch.arange(t_tiles, device=dev).view(1, 1, -1) < counts.unsqueeze(-1)
        keep = torch.from_numpy(rng.random(tuple(real.shape)) < share).to(dev)
        return F.active_fetch_map(real & keep)

    def streams(graph, problem):
        """(pull args per phase, push args per phase, pull kw, push kw)."""
        consts = _edge_constants(problem, graph, EngineOptions(), dev)
        pull = [phase_consts_at(consts, m) for m in range(graph.l)]
        pull = [(cm["word"], cm["counts"], cm["word_hi"], cm["w"]) for cm in pull]
        kw = dict(kind=problem.reduce_kind, edge_op=problem.edge_op, identity=problem.identity)
        gkw = dict(num_rows=graph.packed_rows_per_core, vb=graph.tile_vb,
                   src_bits=graph.src_bits, **kw)
        push, skw = None, None
        if consts["push_word"] is not None:
            push = [phase_consts_at(consts, m) for m in range(graph.l)]
            push = [(cm["push_word"], cm["push_counts"], cm["push_word_hi"], cm["push_w"])
                    for cm in push]
            skw = dict(num_rows=graph.vertices_per_core, src_bits=graph.push_src_bits, **kw)
        return pull, push, gkw, skw

    def agree(got, want, variant, label):
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{label} {variant}: shape/dtype {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
        if variant == "sum_f32":
            ok = torch.allclose(got, want, **SUM_TOL)
            err = float((got - want).abs().max())
        else:
            ok = torch.equal(got, want)
            a = u32.widen(got) if got.dtype == torch.int32 else got.double()
            b = u32.widen(want) if want.dtype == torch.int32 else want.double()
            err = float((a - b).abs().max())
        check(ok, f"{label} {variant}: kernel disagrees with plain version (max err {err})")
        return err

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def event_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    def profiled(fn):
        """Run ``fn`` under the profiler: (wall us, device-side events only,
        i.e. kernels and copies, not the CPU ops that launched them). The
        profiler drops device events at random in these runs, torch's own
        kernels' too (``profiler_probe``): busy times from it are floors."""
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            t = time.perf_counter()
            fn()
            sync()
            wall = (time.perf_counter() - t) * 1e6
        return wall, [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def profiler_probe():
        """Device events the profiler reports for a window that launches one
        elementwise kernel (1 when it sees everything)."""
        if dev.type != "cuda":
            return None
        x = torch.zeros(1 << 16, device=dev)
        sync()
        _, evs = profiled(lambda: x.add_(1.0))
        return sum(e.count for e in evs)

    hold = {}  # whether the last device_ms run's holds outlasted its enqueues

    def device_launches(fn, tries=3):
        """Device launches (kernels, copies, fills) one run of ``fn`` makes:
        the most the profiler sees over ``tries`` runs, as it drops events."""
        fn()
        sync()
        if dev.type != "cuda":
            return None
        return max(sum(e.count for e in profiled(fn)[1]) for _ in range(tries))

    def device_ms(fn, reps, calls=1, launches=None):
        """Device time per call by CUDA events around back-to-back runs of
        ``fn`` (each making ``calls`` calls and ``launches`` device launches,
        ``calls`` where not given), ``reps`` in all. A spin kernel holds the
        stream while the host enqueues them, so host launch gaps are not
        counted, except after a sync inside ``fn`` (a plain version's). The
        host enqueues at most QUEUED_LAUNCHES launches a hold: past the
        launch queue's depth it would block until the device drains it, and
        the device would then wait on the host's refill."""
        fn()
        sync()
        if dev.type != "cuda":
            hold["hold_covered"] = None
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t) * 1e3 / (reps * calls)
        t = time.perf_counter()
        fn()
        sync()
        call_s = time.perf_counter() - t
        per_hold = max(1, QUEUED_LAUNCHES // (launches or calls))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        total_ms, done, covered = 0.0, 0, True
        while done < reps:
            n = min(per_hold, reps - done)
            hold_s = min(HOLD_MAX_S, 1.5 * n * call_s)
            torch.cuda._sleep(int(hold_s * SPIN_CYCLES_PER_S))
            start.record()
            t = time.perf_counter()
            for _ in range(n):
                fn()
            covered &= time.perf_counter() - t < hold_s
            end.record()
            torch.cuda.synchronize()
            total_ms += start.elapsed_time(end)
            done += n
        hold["hold_covered"] = covered
        return total_ms / (reps * calls)

    def kernel_ms(fn, reps, launches_per_call, name, launches=None):
        """Per launch of the kernel named ``name`` over ``reps`` calls of
        ``fn`` (each making ``launches_per_call`` launches of it, and
        ``launches`` device launches in all where that is more): ``ms`` by
        CUDA events (``device_ms``, the whole launch), and beside it the mean
        of the profiler's events of that kernel (one a launch) with the count
        it saw of those expected."""
        ms = device_ms(fn, reps, launches_per_call, launches)
        if dev.type != "cuda":
            return dict(ms=ms, ms_from="host_clock", profiler_ms=None, events_seen=None,
                        events_expected=reps * launches_per_call)
        covered = hold["hold_covered"]
        _, evs = profiled(lambda: [fn() for _ in range(reps)])
        hits = [e for e in evs if name in e.key]
        seen = sum(e.count for e in hits)
        return dict(ms=ms, ms_from="cuda_events", hold_covered=covered,
                    profiler_ms=sum(event_us(e) for e in hits) / seen / 1e3 if seen else None,
                    events_seen=seen, events_expected=reps * launches_per_call)

    def wall_ms(fn, reps):
        """CUDA-event time per run of ``fn``, host launch gaps included."""
        fn()
        sync()
        if dev.type != "cuda":
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t) * 1e3 / reps
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def bound(real_slots, streams_per_slot, extra_bytes, lanes=1):
        """Least time for the work: each real slot's word (+ word_hi, +
        weight where streamed) read once, plus the other inputs read and the
        output written once, over 3.35 TB/s; one op per real slot and lane."""
        nbytes = real_slots * 4 * streams_per_slot + extra_bytes
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = real_slots * lanes / F32_OPS_PER_S * 1e3
        return dict(bound_ms=max(bytes_ms, ops_ms), bound_bytes=nbytes,
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations")

    def scatter_design(p_slots, streams, lanes, row, extra):
        """Bytes a slot of what the scatter design moves, beside the bound's,
        and both as GB/s over row["ms"]: each real slot's word streams once,
        an L-wide payload row and the destination's L-wide output row read
        per slot (L2), and the output written twice (the fill, then the
        lowered rows written back); ``extra``: counts and fetch map."""
        design = (p_slots * 4 * streams + p_slots * lanes * 8
                  + 2 * pg.p * pg.vertices_per_core * lanes * 4 + extra)
        row.update(bytes_per_slot_design=design / p_slots,
                   bytes_per_slot_bound=row["bound_bytes"] / p_slots,
                   gbps_design=design / row["ms"] / 1e6,
                   gbps_bound=row["bound_bytes"] / row["ms"] / 1e6)

    def laneless_paths():
        """The laneless paths of the earlier slices: returns the launch counts
        of their main path, the kernel-vs-plain errors and the timings. Their
        device tensors die with this frame, so that the serving phase can
        see eviction free the partition's device copies."""
        # -- each kernel against its plain version --------------------------------
        t0 = time.perf_counter()
        errs = {("gather", v): 0.0 for v in problems}
        errs.update({("scatter", v): 0.0 for v in push_variants})

        def compare(graph, label, gather=True):
            for variant, problem in problems.items():
                pull, push, gkw, skw = streams(graph, problem)
                payload = payload_for(variant, graph.gathered_size)
                cases = []
                if gather:
                    word, counts, hi, wts = pull[0]
                    fetch = seeded_fetch(counts, word.shape[2], FETCH_SHARE)
                    cases += [("gather", (payload, word, counts, hi, wts), gkw),
                              ("gather", (payload, word, counts, hi, wts, fetch), gkw)]
                if variant in push_variants and push is not None:
                    word, counts, hi, wts = push[0]
                    fetch = seeded_fetch(counts, word.shape[2], FETCH_SHARE)
                    cases += [("scatter", (payload, word, counts, hi, wts), skw),
                              ("scatter", (payload, word, counts, hi, wts, fetch), skw)]
                for kern, args, kw in cases:
                    mod, plain = (K, K.gather_reduce_cores_plain) if kern == "gather" else \
                        (S, S.scatter_reduce_cores_plain)
                    fn = mod.gather_reduce_cores if kern == "gather" else mod.scatter_reduce_cores
                    got = fn(*args, **kw)
                    want = plain(*args, **kw)
                    sync()
                    arm = "fetch" if len(args) == 6 else "static"
                    err = agree(got, want, variant, f"{label} {kern} {arm}")
                    errs[(kern, variant)] = max(errs[(kern, variant)], err)

        compare(pg, "phase 0")
        # the push dst field holds the full row: 32-bit words once Vl > 2^15
        check(pg.push_src_bits == (32 if pg.vertices_per_core > 1 << 15 else 16),
              f"push stream in the {pg.push_src_bits}-bit regime at Vl={pg.vertices_per_core}")
        # unweighted, so SSSP's add runs on unit weights here (the main graph is weighted)
        g32 = G.symmetrize(G.rmat(min(scale, 12), 16, seed=SEED + 2))
        pg32 = partition_2d(g32, PartitionConfig(p=4, l=2, tile_vb=64, pack_src_bits=32,
                                                 build_push=False))
        check(pg32.src_bits == 32, "32-bit regime graph did not pack 32-bit words")
        compare(pg32, "32-bit")
        w16 = np.random.default_rng(SEED + 2).random(g32.num_edges).astype(np.float32)
        g16 = G.COOGraph(src=g32.src, dst=g32.dst, num_vertices=g32.num_vertices, weights=w16)
        pg16 = partition_2d(g16, PartitionConfig(p=4, l=2, tile_vb=64, push_block=256))
        check(pg16.push_src_bits == 16 and pg16.vertices_per_core <= 1 << 15,
              "small push partition is not in the 16-bit regime")
        compare(pg16, "16-bit push", gather=False)
        emit("kernel", t0, max_abs_err={f"{k}[{v}]": e for (k, v), e in errs.items()},
             gather_src_bits_checked=[pg.src_bits, pg32.src_bits],
             push_src_bits_checked=[pg.push_src_bits, pg16.push_src_bits],
             fetch_share=FETCH_SHARE, small_graph_edges=g32.num_edges)

        # -- timing: kernels, plain versions, bounds, oracle per phase ------------
        t0 = time.perf_counter()
        timing = {}
        reps = 3 if rehearsal else 20
        for variant, problem in problems.items():
            pull, push, gkw, skw = streams(pg, problem)
            payload = payload_for(variant, pg.gathered_size)
            has_hi, has_w = pull[0][2] is not None, pull[0][3] is not None

            def launch_all(fn, phase_args, kw, payload=payload):
                # one call = one launch per phase; the 16 phase streams exceed L2
                for a in phase_args:
                    fn(payload, *a, **kw)

            def time_arm(fn, plain, phase_args, kw, name, into, arm):
                k = kernel_ms(lambda: launch_all(fn, phase_args, kw), reps, pg.l, name)
                into.setdefault("profiler", {})[arm] = {
                    key: k[key] for key in ("profiler_ms", "events_seen", "events_expected")}
                p_ms = device_ms(lambda: launch_all(plain, phase_args, kw), max(1, reps // 4), pg.l)
                return k["ms"], p_ms

            out_bytes = pg.p * pg.packed_rows_per_core * 4
            real_slots = float(pg.tile_counts.sum()) * pg.tile_word.shape[4] / pg.l
            common = pg.tile_counts[:, 0].nbytes + pg.gathered_size * 4 + out_bytes
            row = dict(word_hi=has_hi, weights=has_w, real_slots_per_phase=real_slots)
            fn, plain, name = K.gather_reduce_cores, K.gather_reduce_cores_plain, \
                "gather_reduce_cores_kernel"
            row["static_ms"], row["static_plain_ms"] = time_arm(fn, plain, pull, gkw, name,
                                                                row, "static")
            row["launch_wall_ms"] = wall_ms(lambda: launch_all(fn, pull, gkw), reps) / pg.l
            if variant == "sum_f32":  # PageRank stays on the static schedule
                row["ms"], row["plain_ms"] = row["static_ms"], row["static_plain_ms"]
                row.update(bound(real_slots, 1 + has_hi + has_w, common))
            else:  # the main path's arm: the fetch map, also read once
                fetch_bytes = pg.tile_counts[:, 0].size * pg.tile_word.shape[3] * 4
                all_real = [a + (seeded_fetch(a[1], a[0].shape[2], 1.0),) for a in pull]
                part = [a + (seeded_fetch(a[1], a[0].shape[2], FETCH_SHARE),) for a in pull]
                row["ms"], row["plain_ms"] = time_arm(fn, plain, all_real, gkw, name, row, "fetch")
                row.update(bound(real_slots, 1 + has_hi + has_w, common + fetch_bytes))
                row["fetch30_ms"], row["fetch30_plain_ms"] = time_arm(fn, plain, part, gkw, name,
                                                                      row, "fetch30")
                run_slots = float(sum(int((f[-1] == torch.arange(f[0].shape[2], device=dev)).sum())
                                      for f in part)) * pg.tile_word.shape[4] / pg.l
                row["fetch30_bound_ms"] = bound(run_slots, 1 + has_hi + has_w,
                                                common + fetch_bytes)["bound_ms"]
            oracle_consts = _edge_constants(problem, pg, EngineOptions(backend="oracle"), dev)
            o_phases = [phase_consts_at(oracle_consts, m) for m in range(pg.l)]

            def oracle_all(problem=problem, o_phases=o_phases, payload=payload):
                for cm in o_phases:
                    channel_phase_reduce_oracle(problem, pg, payload, cm)

            row["oracle_phase_ms"] = device_ms(oracle_all, max(1, reps // 4), pg.l)
            timing[("gather", variant)] = row
            if variant in push_variants:
                peb = pg.push_word.shape[4]
                p_slots = float(pg.push_counts.sum()) * peb / pg.l
                p_hi, p_w = push[0][2] is not None, push[0][3] is not None
                fetch_bytes = pg.push_counts[:, 0].size * pg.push_word.shape[3] * 4
                common = (pg.push_counts[:, 0].nbytes + pg.gathered_size * 4
                          + pg.p * pg.vertices_per_core * 4)
                fn, plain = S.scatter_reduce_cores, S.scatter_reduce_cores_plain
                srow = dict(word_hi=p_hi, weights=p_w, real_slots_per_phase=p_slots)
                all_real = [a + (seeded_fetch(a[1], a[0].shape[2], 1.0),) for a in push]
                srow["ms"], srow["plain_ms"] = time_arm(fn, plain, all_real, skw,
                                                        "scatter_reduce_cores_kernel",
                                                        srow, "fetch")
                srow.update(bound(p_slots, 1 + p_hi + p_w, common + fetch_bytes))
                scatter_design(p_slots, 1 + p_hi + p_w, 1, srow,
                               pg.push_counts[:, 0].nbytes + fetch_bytes)
                srow["static_ms"], srow["static_plain_ms"] = time_arm(fn, plain, push, skw,
                                                                      "scatter_reduce_cores_kernel",
                                                                      srow,
                                                                      "static")
                srow["launch_wall_ms"] = wall_ms(lambda: launch_all(fn, all_real, skw), reps) / pg.l
                timing[("scatter", variant)] = srow
        emit("timing", t0, per_launch={f"{k}[{v}]": r for (k, v), r in timing.items()},
             note="ms, plain_ms, *_ms: device time per launch by CUDA events around "
                  "back-to-back passes over the l phase streams, the stream held while the host "
                  "enqueues them (profiler: the mean of the kernel's profiler events, with the "
                  "count seen of those expected, per arm); ms is the arm the main "
                  "path takes (the fetch map with every real tile active for the min variants, "
                  "the static counts for sum_f32); fetch30: a seeded map keeping ~30% of real "
                  "tiles, bounded by the slots it runs; launch_wall_ms: CUDA-event time per "
                  "launch with host launch gaps; scatter bytes_per_slot_design: the word "
                  "streams once, a payload row and an output row read per slot (L2), the output "
                  "written twice (fill, write-back), beside the bound's; gbps_*: those bytes "
                  "over ms; no single PyTorch call computes either function (library_ms null)")

        # -- main path: the port's engine, default options -------------------------
        runs = [("bfs", bfs(0)), ("wcc", wcc()), ("sssp", sssp(0)),
                ("pagerank", pagerank()), ("pagerank_repeat", pagerank())]
        for _, problem in runs:  # upload each problem's edge tensors (set-up)
            make_iteration(problem, pg, EngineOptions(), device=dev)
        make_iteration(sssp(0), pg, EngineOptions(direction="push"), device=dev)
        sync()
        K.reset_launch_counts()
        S.reset_launch_counts()
        t0 = time.perf_counter()
        results, run_mteps = {}, {}

        def main_run(name, problem, opts):
            t = time.perf_counter()
            labels = prepare_labels(problem, g, pg, device=dev)  # host init (set-up)
            sync()
            init_sec = time.perf_counter() - t
            t1 = time.perf_counter()
            res = run(problem, g, pg, opts, labels=labels, device=dev)
            sync()
            sec = time.perf_counter() - t1
            results[name] = res
            run_mteps[name] = n_edges / sec / 1e6
            lab = res.labels["label"]
            check(lab.shape == (g.num_vertices,), f"{name}: label shape {lab.shape}")
            check(res.converged, f"{name}: did not converge in {res.iterations} iterations")
            if lab.dtype == np.float32:
                check(bool(np.isfinite(lab).all()), f"{name}: non-finite labels")
            emit("main_path_run", t, problem=name, options=opts.direction,
                 iterations=res.iterations, init_seconds=init_sec, run_seconds=sec,
                 mteps=n_edges / sec / 1e6, edges=n_edges)

        for name, problem in runs:
            main_run(name, problem, EngineOptions())
        # should 'auto' never pick push for a variant, force it, so that every
        # scatter variant still lies on a path this run drives
        forced = [(v, name, prob) for v, name, prob in (("min_u32", "bfs", bfs(0)),
                                                       ("min_f32_add", "sssp", sssp(0)))
                  if S.LAUNCHES.get(v, 0) == 0]
        for _, name, problem in forced:
            main_run(f"{name}_push", problem, EngineOptions(direction="push"))
        launches = {"gather_reduce_cores": dict(K.LAUNCHES), "scatter_reduce_cores": dict(S.LAUNCHES)}
        expect = sum(r.iterations for r in results.values()) * pg.l
        total = sum(K.LAUNCHES.values()) + sum(S.LAUNCHES.values())
        emit("main_path", t0, launches=launches, total_launches=total, expected_launches=expect,
             forced_push=[f"{n}_push" for _, n, _ in forced])
        if not rehearsal:
            check(total == expect, f"kernel launches {launches} != sum(iterations) * l = {expect}")
            for variant in problems:
                check(K.LAUNCHES.get(variant, 0) > 0, f"gather variant {variant} was never launched")
            for variant in push_variants:
                check(S.LAUNCHES.get(variant, 0) > 0, f"scatter variant {variant} was never launched")
        for _, name, _ in forced:  # a forced direction changes the schedule, not the result
            a, b = results[name], results[f"{name}_push"]
            check(a.iterations == b.iterations and np.array_equal(a.labels["label"], b.labels["label"]),
                  f"{name}: forced push differs from the 'auto' run")
        # the static schedule on the same card, for comparison (not counted)
        for name, problem in runs[:3]:
            labels = prepare_labels(problem, g, pg, device=dev)
            sync()
            t = time.perf_counter()
            res = run(problem, g, pg, EngineOptions(dynamic_tile_skip=False), labels=labels,
                      device=dev)
            sync()
            sec = time.perf_counter() - t
            check(res.iterations == results[name].iterations
                  and np.array_equal(res.labels["label"], results[name].labels["label"]),
                  f"{name}: the default run differs from the static schedule")
            emit("static_path_run", t, problem=name, iterations=res.iterations, run_seconds=sec,
                 mteps=n_edges / sec / 1e6)

        # the overlap's cost in this call: the default BFS and PageRank with
        # stream_build's build child running and paused (SIGSTOP), alternately
        # (not counted)
        if stream_proc.is_alive():
            t_ab = time.perf_counter()
            overlap_ab = {}
            for name, problem in (runs[0], runs[3]):
                got = {"child_running": [], "child_paused": []}
                for paused in (False, True, False, True):
                    labels = prepare_labels(problem, g, pg, device=dev)
                    sync()
                    if paused:
                        os.kill(stream_proc.pid, signal.SIGSTOP)
                    try:
                        t = time.perf_counter()
                        res = run(problem, g, pg, EngineOptions(), labels=labels, device=dev)
                        sync()
                        sec = time.perf_counter() - t
                    finally:
                        if paused:
                            os.kill(stream_proc.pid, signal.SIGCONT)
                    check(np.array_equal(res.labels["label"], results[name].labels["label"]),
                          f"{name}: a rerun differs from the main path's labels")
                    got["child_paused" if paused else "child_running"].append(n_edges / sec / 1e6)
                overlap_ab[name] = dict(got, slowdown=max(got["child_paused"])
                                        / max(got["child_running"]) - 1.0)
            # what a launch now pays for the dry run's hooks with none active:
            # recording() and is_fake's type check (host ns a launch)
            from repro_torch.kernels.fake import is_fake, recording
            probe = torch.empty(1, device=dev)
            tg = time.perf_counter()
            for _ in range(100_000):
                recording() or is_fake(probe)
            hook_ns = (time.perf_counter() - tg) * 1e4
            emit("main_path_overlap", t_ab, mteps=overlap_ab, launch_hook_ns=hook_ns,
                 note="default options, the build child of stream_build (ii) running, then "
                      "paused with SIGSTOP, twice; slowdown: the best paused run's MTEPS over "
                      "the best running run's, less 1; launch_hook_ns: host ns a launch spends "
                      "in recording() and is_fake() with no recorder active")

        # -- the schedule of each min problem, iteration by iteration -------------
        t0 = time.perf_counter()
        schedule = {}
        for name, problem in runs[:3]:
            tr = run_frontier_trace(problem, g, pg, device=dev)
            check(tr["iterations"] == results[name].iterations
                  and np.array_equal(tr["labels"]["label"], results[name].labels["label"]),
                  f"{name}: run_frontier_trace differs from run")
            schedule[name] = {k: tr[k] for k in ("iterations", "direction", "push_iterations",
                                                  "dense_iterations", "dynamic_skipped_tile_fraction")}
        emit("schedule", t0, per_problem=schedule,
             static_skipped_tile_fraction=pg.skipped_tile_fraction,
             push_static_skipped_tile_fraction=1.0 - float(pg.push_counts.sum())
             / pg.push_counts.size / pg.push_word.shape[3])

        # -- where one iteration's time goes (after the counts were read) ---------
        t0 = time.perf_counter()

        def breakdown(step):
            step()  # warm
            sync()
            wall_us, evs = profiled(step)
            dev_us = sum(event_us(e) for e in evs)
            kern_us = sum(event_us(e) for e in evs if "reduce_cores" in e.key)
            top = sorted(evs, key=event_us, reverse=True)[:8]
            return dict(
                iteration_wall_us=wall_us, device_busy_us=dev_us, kernel_us=kern_us,
                device_idle_share=1.0 - dev_us / wall_us if wall_us else None,
                device_launches=sum(e.count for e in evs),
                top_device_us={e.key[:80]: [event_us(e), e.count] for e in top},
            )

        static = {}
        for name, problem in runs[:4]:
            labels = prepare_labels(problem, g, pg, device=dev)
            iteration = make_iteration(problem, pg, EngineOptions(dynamic_tile_skip=False),
                                       device=dev)
            static[name] = breakdown(lambda: iteration(labels))
        # BFS under 'auto': keep each iteration's input state; the dense pull is
        # iteration 0, the dynamic pull and the push run on the last nonempty
        # frontier (the narrowest), so their times compare on the same input
        step = make_iteration(bfs(0), pg, EngineOptions(), device=dev)
        labels = prepare_labels(bfs(0), g, pg, device=dev)
        fw = F.full_frontier_words(pg.l, pg.sub_size, lead=(pg.p,), device=dev)
        pop, prev, states = pg.p * pg.l * pg.sub_size, False, []
        while pop > 0:
            states.append((labels, fw, pop))
            labels, fw, prev = step(labels, fw, prev, pop=pop)
            pop = int(F.frontier_popcount(fw))
        by_direction = {}
        for label, state, opts in (
            ("dense_pull", states[0], EngineOptions(direction="pull")),
            ("dynamic_pull", states[-1], EngineOptions(direction="pull", dynamic_skip_density=2.0)),
            ("push", states[-1], EngineOptions(direction="push")),
        ):
            lab, front, pc = state
            it_fn = make_iteration(bfs(0), pg, opts, device=dev, with_stats=True)
            stats = it_fn(lab, front, pop=pc)[-1]
            by_direction[label] = dict(breakdown(lambda: it_fn(lab, front, pop=pc)), popcount=pc,
                                       active_tiles=int(stats["active_tiles"]),
                                       use_dense=stats["use_dense"])
        emit("profile", t0, profiler_probe_events=profiler_probe(), static_iteration=static,
             bfs_by_direction=by_direction,
             bfs_iterations_recorded=len(states),
             note="torch.profiler over one warm iteration (l phases); device events only; "
                  "the profiler's own host overhead inflates iteration_wall_us; kernel_us "
                  "sums both kernels' events")

        # -- oracle backend on the card, kernel PR bit-stability -------------------
        t0 = time.perf_counter()
        agree_o, oracle_results = {}, {}
        for name, problem in runs[:4]:
            labels = prepare_labels(problem, g, pg, device=dev)
            sync()
            t = time.perf_counter()
            ref = run(problem, g, pg, EngineOptions(backend="oracle"), labels=labels, device=dev)
            sync()
            sec = time.perf_counter() - t
            for got_name in [name] + [f"{n}_push" for _, n, _ in forced if n == name]:
                got = results[got_name]
                check(ref.iterations == got.iterations,
                      f"{got_name}: iterations kernel {got.iterations} vs oracle {ref.iterations}")
                a, b = got.labels["label"], ref.labels["label"]
                if problem.reduce_kind == "min":
                    check(a.dtype == b.dtype and np.array_equal(a, b),
                          f"{got_name}: labels differ from oracle")
                    err = 0.0
                else:
                    err = float(np.max(np.abs(a - b)))
                    check(bool(np.allclose(a, b, **SUM_TOL)),
                          f"{got_name}: labels differ from oracle by {err}")
            agree_o[name] = dict(iterations=ref.iterations, oracle_seconds=sec,
                                 oracle_mteps=n_edges / sec / 1e6, max_abs_diff=err)
            oracle_results[name] = ref
        pr_a = results["pagerank"].labels["label"]
        pr_b = results["pagerank_repeat"].labels["label"]
        check(pr_a.tobytes() == pr_b.tobytes(), "pagerank: two kernel runs gave different bits")
        emit("oracle", t0, agree=agree_o, pagerank_bit_stable=True)

        # -- small graph against the numpy oracles --------------------------------
        t0 = time.perf_counter()
        gs0 = G.symmetrize(G.rmat(10, 8, seed=SEED + 3))
        ws = np.random.default_rng(SEED + 3).random(gs0.num_edges).astype(np.float32)
        gs = G.COOGraph(src=gs0.src, dst=gs0.dst, num_vertices=gs0.num_vertices, weights=ws)
        pgs = partition_2d(gs, PartitionConfig(p=2, l=2, lane=8, tile_vb=64))
        for opts in (EngineOptions(), EngineOptions(direction="push")):
            check(np.array_equal(run(bfs(0), gs, pgs, opts, device=dev).labels["label"],
                                 reference.bfs_reference(gs, 0)), "small bfs != numpy oracle")
            check(np.array_equal(run(wcc(), gs, pgs, opts, device=dev).labels["label"],
                                 reference.wcc_reference(gs)), "small wcc != numpy oracle")
            check(np.allclose(run(sssp(0), gs, pgs, opts, device=dev).labels["label"],
                              reference.sssp_reference(gs, 0), rtol=1e-6),
                  "small sssp != numpy oracle")
        check(np.allclose(run(pagerank(), gs, pgs, device=dev).labels["label"],
                          reference.pagerank_reference(gs), atol=1e-4),
              "small pagerank != numpy oracle")
        emit("reference", t0, edges=gs.num_edges)
        return launches, errs, timing, results, run_mteps, oracle_results

    launches, errs, timing, main_results, main_path_mteps, oracle_results = laneless_paths()

    # -- the edge-centric baseline (paper Fig. 1: synchronous, 8 B an edge) ----
    def edge_centric_phase():
        """partition_edge_centric(p) of the smoke graph and BFS, WCC, SSSP and
        PageRank through run_edge_centric on the card, against the oracle
        backend's runs: labels bit-equal (PageRank within DIST_PR_TOL)."""
        t0 = time.perf_counter()
        t = time.perf_counter()
        part = partition_edge_centric(g, pg.p)
        build_s = time.perf_counter() - t
        rows = {}
        for name, problem in (("bfs", bfs(0)), ("wcc", wcc()), ("sssp", sssp(0)),
                              ("pagerank", pagerank())):
            # the first iteration uploads the edge list (set-up, not timed)
            run_edge_centric(problem, g, part, EdgeCentricOptions(max_iters=1), device=dev)
            sync()
            t = time.perf_counter()
            res = run_edge_centric(problem, g, part, device=dev)
            sync()
            sec = time.perf_counter() - t
            check(res.converged, f"edge_centric {name}: did not converge in {res.iterations}")
            a, b = res.labels["label"], oracle_results[name].labels["label"]
            if problem.reduce_kind == "sum":
                err = float(np.max(np.abs(a - b)))
                check(bool(np.allclose(a, b, **DIST_PR_TOL)),
                      f"edge_centric {name}: labels differ from the oracle by {err}")
            else:
                err = 0.0
                check(a.dtype == b.dtype and np.array_equal(a, b),
                      f"edge_centric {name}: labels differ from the oracle backend's")
            rows[name] = dict(iterations=res.iterations,
                              graphscale_iterations=main_results[name].iterations,
                              run_seconds=sec, mteps=n_edges / sec / 1e6,
                              ms_per_iteration=sec * 1e3 / res.iterations,
                              graphscale_mteps=main_path_mteps[name], max_abs_diff=err)
        e_pad = int(part.src_vid.shape[1])
        del part
        gc.collect()
        emit("edge_centric", t0, per_problem=rows, p=pg.p, edge_pad=e_pad,
             partition_seconds=build_s, bytes_per_edge=bytes_per_edge(g, compressed=False),
             csr_bytes_per_edge=bytes_per_edge(g, compressed=True),
             graphscale_stream_bytes_per_edge=pg.stream_bytes_per_edge,
             note="synchronous edge-centric baseline (HitGraph/ThunderGP): one index_select "
                  "of the payload at the (p, E_pad) source ids and a per-core segment reduce an "
                  "iteration, updates applied at its end; mteps = E / run seconds (the edge "
                  "list's upload apart), beside the GraphScale engine's default runs "
                  "(main_path); bytes_per_edge: the uncompressed edge list (8 B), beside the "
                  "compressed stream's index bytes per pull slot, push stream included")
        return rows

    edge_centric_rows = edge_centric_phase()

    # -- the multi-channel engine: one rank a graph core, over torch.distributed --
    def distributed_phase():
        """p ranks sharing the card over gloo on the smoke partition (written
        once, memory-mapped by every rank), each result against the
        single-process engine on this card; then the NCCL code path at world
        size 1. Returns the ranks' kernel launches, summed."""
        t0 = time.perf_counter()
        where = ROOT / "build" / "distributed"
        t = time.perf_counter()
        written = save_partition(pg, g, where)
        save_s = time.perf_counter() - t
        roots = [int(r) for r in np.random.default_rng(SEED + 12).integers(0, g.num_vertices,
                                                                           LANE_K)]
        din_cfg = get_arch("din").model if not rehearsal else get_arch("din").smoke()
        spec = dict(dir=str(where), device=dev.type, ranks=pg.p, roots=roots, budget=DIST_BUDGET,
                    rec_roots=roots[:REC_QUERIES], rehearsal=rehearsal,
                    d_feat=1433 if not rehearsal else 64, n_classes=7,
                    item_vocab=din_cfg.item_vocab, cate_vocab=din_cfg.cate_vocab,
                    embed_dim=din_cfg.embed_dim, seq_len=din_cfg.seq_len, batch=DIN_BATCH)
        t = time.perf_counter()
        outs = spawn_ranks(distributed_rank, pg.p, (spec,), backend="gloo",
                           timeout=DIST_TIMEOUT_S, init_dir=where)
        spawn_s = time.perf_counter() - t
        want_multi = run(bfs_multi(roots), g, pg, EngineOptions(lanes=LANE_K), device=dev)
        wants = dict(bfs=main_results["bfs"], wcc=main_results["wcc"],
                     sssp=main_results["sssp"], pagerank=main_results["pagerank"],
                     bfs_static=main_results["bfs"], wcc_static=main_results["wcc"],
                     sssp_static=main_results["sssp"], bfs_multi=want_multi)
        r0 = outs[0]
        agree = {}
        for name, want in wants.items():
            got = r0["runs"][name]
            check(all(o["runs"][name]["digest"] == got["digest"]
                      and o["runs"][name]["iterations"] == got["iterations"] for o in outs),
                  f"distributed {name}: the ranks returned different results")
            check(got["converged"] and got["iterations"] == want.iterations,
                  f"distributed {name}: {got['iterations']} iterations, single-process "
                  f"{want.iterations}")
            check(set(got["labels"]) == set(want.labels), f"distributed {name}: label fields")
            err = 0.0
            for k, v in want.labels.items():
                a = got["labels"][k]
                if name == "pagerank":
                    err = float(np.max(np.abs(a - v)))
                    check(bool(np.allclose(a, v, **DIST_PR_TOL)),
                          f"distributed pagerank: labels differ by {err}")
                else:
                    check(a.dtype == v.dtype and np.array_equal(a, v),
                          f"distributed {name}: {k} differs from the single-process run")
            agree[name] = dict(iterations=got["iterations"], max_abs_diff=err,
                               seconds_by_rank=[o["runs"][name]["seconds"] for o in outs])
        fr = r0["frontier"]
        check(all(o["frontier"]["digest"] == fr["digest"] for o in outs)
              and fr["converged"]
              and np.array_equal(fr["labels"]["label"], main_results["bfs"].labels["label"]),
              "distributed frontier engine: BFS labels differ from the single-process run")
        for o in outs:
            check(o["aggregate"]["ok"], f"distributed aggregate: off by {o['aggregate']}")
            check(o["gat"]["ok"], f"distributed GAT: loss or gradients off: {o['gat']}")
            lk = o["lookup"]
            check(lk["rows_equal"] and lk["grad_ok"] and lk["small_rows_equal"]
                  and lk["dropped"] == lk["dropped_expected"],
                  f"distributed lookup differs from the one-shard lookup: {lk}")
        check(sum(o["lookup"]["dropped"] for o in outs) > 0,
              "distributed lookup: the tight queues dropped no id")
        # recommend-for at p table shards: every rank the same answers; the
        # card's the CPU's (vertices equal, scores within DIN_TOL); where no id
        # of a query overflowed, the one-shard scorer's on this card
        from repro_torch.serve import RecommendScorer
        from repro_torch.train.optim import tree_map

        rec = {}
        for case in REC_CONFIGS:
            cfg = recommend_config(case, rehearsal)
            one = RecommendScorer(cfg, pool_size=64, topk=8, device=dev,
                                  params=tree_map(lambda t: t.to(dev), recommend_params(cfg)))
            one.refresh_pool(g)
            r0c = r0["recommend"][case]
            card, cpu = r0c["card"], r0c["cpu"]
            check(card["shards"] == pg.p and cpu["shards"] == pg.p,
                  f"recommend {case}: {card['shards']} / {cpu['shards']} table shards")
            check(card["drops"] == cpu["drops"], f"recommend {case}: drops {card['drops']} on "
                  f"the card, {cpu['drops']} on the CPU")
            vs_one, max_err = 0, 0.0
            for i, r in enumerate(spec["rec_roots"]):
                a, b = card["answers"][i], cpu["answers"][i]
                for o in outs[1:]:
                    x = o["recommend"][case]["card"]["answers"][i]
                    check(np.array_equal(x["vertices"], a["vertices"])
                          and np.array_equal(x["scores"], a["scores"]),
                          f"recommend {case}: ranks answered root {r} differently")
                check(np.array_equal(a["vertices"], b["vertices"])
                      and np.allclose(a["scores"], b["scores"], **DIN_TOL),
                      f"recommend {case}: root {r} on the card differs from the CPU's")
                max_err = max(max_err, float(np.max(np.abs(a["scores"] - b["scores"]))))
                if card["drops"][i] == 0:
                    w = one.recommend_for(pg, r)
                    check(np.array_equal(a["vertices"], w["vertices"])
                          and np.allclose(a["scores"], w["scores"], **DIN_TOL),
                          f"recommend {case}: root {r} (no overflow) differs from one shard")
                    vs_one += 1
            rec[case] = dict(item_vocab=cfg.item_vocab, seq_len=cfg.seq_len, shards=card["shards"],
                             queries=len(spec["rec_roots"]), overflowed_ids=card["drops"],
                             queries_compared_with_one_shard=vs_one,
                             max_abs_err_card_vs_cpu=max_err,
                             seconds_by_rank=[o["recommend"][case]["card"]["seconds"]
                                              for o in outs],
                             bag_launches_by_rank=[o["recommend"][case]["card"]["bag_launches"]
                                                   for o in outs])
            print(f"recommend {case}: {card['shards']} shards, overflowed ids a query "
                  f"{card['drops']}", flush=True)
            del one
        single_bytes = sum(t_.numel() * t_.element_size() for t_ in
                           _edge_constants(bfs(0), pg, EngineOptions(), dev).values()
                           if t_ is not None)
        per_rank = []
        for q, o in enumerate(outs):
            ln = o["launches"]
            if not rehearsal:
                check(o["transport"] == "gloo" and o["cuda_device"] == 0,
                      f"rank {q}: transport {o['transport']} on cuda:{o['cuda_device']}")
                check(sum(ln["gather_reduce_cores"].values()) > 0
                      and sum(ln["scatter_reduce_cores"].values()) > 0
                      and ln["segment_softmax"].get("f32", 0) == 2,
                      f"rank {q}: kernel launches {ln}")
            check(o["device_bytes"]["bfs"] * pg.p == single_bytes,
                  f"rank {q}: {o['device_bytes']['bfs']} device bytes, single process "
                  f"{single_bytes}")
            per_rank.append(dict(
                rank=q, transport=o["transport"], launches=ln,
                device_bytes=o["device_bytes"], single_process_device_bytes=single_bytes,
                bfs_mteps=n_edges / o["runs"]["bfs"]["seconds"] / 1e6,
                setup_seconds=o["setup_seconds"], gat=o["gat"], aggregate=o["aggregate"],
                lookup=o["lookup"]))
            if not rehearsal:
                for case in REC_CONFIGS:
                    bl = o["recommend"][case]["card"]["bag_launches"]
                    check(bl == {"sum": REC_QUERIES}, f"rank {q} recommend {case}: bag launches "
                          f"{bl}, not one a query")
        emit("distributed", t0, ranks=pg.p, transport="gloo (host-staged crossbar, the ranks "
             "sharing one card)", agree=agree,
             frontier=dict(iterations=fr["iterations"], seconds=fr["seconds"], **fr["stats"]),
             per_rank=per_rank, partition_bytes_written=written, save_seconds=save_s,
             spawn_seconds=spawn_s, roots=roots, recommend=rec,
             note="every run against engine.run on this card (BFS/WCC/SSSP labels and "
                  "iterations bit-equal, the static schedule too; PageRank within DIST_PR_TOL; "
                  "the K-lane BFS bit-equal); bfs_mteps = E / the rank's BFS seconds through a "
                  "crossbar staged through the host over gloo with 4 ranks on one card: no "
                  "prediction of a four-card NCCL run; launches: each rank's, counted over its "
                  "engine runs, the frontier engine, the aggregate, one GAT loss and gradient "
                  "and the lookups (the comparisons after); recommend: recommend-for through "
                  "the router's table-sharded crossbar (an item-table row shard a rank, the ids "
                  "split over the ranks, the reference's capacity 2.0: an id past its shard's "
                  "queue gets a zero row), REC_QUERIES roots at the published DIN config and "
                  "at 12 items and 4 history slots (spread), on the card (bag launches counted) and on the CPU")
        t1 = time.perf_counter()
        nccl = spawn_ranks(nccl_rank, 1, (dict(device=dev.type, scale=min(scale, NCCL_SCALE)),),
                           backend="gloo" if rehearsal else "nccl", timeout=DIST_TIMEOUT_S,
                           init_dir=where)[0]
        check(all(a["equal"] for a in nccl["agree"].values()),
              f"NCCL arm differs from the single-process engine: {nccl['agree']}")
        if not rehearsal:
            check(nccl["transport"] == "nccl"
                  and sum(nccl["launches"]["gather_reduce_cores"].values()) > 0,
                  f"NCCL arm: transport {nccl['transport']}, launches {nccl['launches']}")
        emit("distributed_nccl", t1, **nccl,
             note="world size 1 over NCCL (device tensors, no host staging) on a p = 1 "
                  "partition; the rehearsal runs it over gloo")
        # recovery's PageRank resume reads the pull stream back from here;
        # what it does not read goes now
        drop_partition_fields(where, RECOVERY_UNREAD)
        total = {"gather_reduce_cores": {}, "scatter_reduce_cores": {}, "segment_softmax": {},
                 "embedding_bag": {}}
        rec_launches = [o["recommend"][case]["card"]["bag_launches"] for o in outs
                        for case in REC_CONFIGS]
        for ln in [o["launches"] for o in outs] + [nccl["launches"]] \
                + [{"embedding_bag": b} for b in rec_launches]:
            for kern, counts in ln.items():
                for v, n in counts.items():
                    total[kern][v] = total[kern].get(v, 0) + n
        return total

    dist_launches = distributed_phase()

    # -- the lane arms of both kernels against their plain versions -----------
    lrng = np.random.default_rng(SEED + 5)

    def lane_kernel_phase():
        """Each lane arm against its plain version on phase 0, and its device
        time over the l phase streams. Returns (timing, errors)."""
        t0 = time.perf_counter()
        reps = 3 if rehearsal else 20

        def lane_payload(pkind: str, n: int, lanes: int) -> torch.Tensor:
            if pkind == "words":  # packed reach words of K = 16 (W=1) or K = 40 (W=2)
                k = 16 if lanes == 1 else 40
                bits = lrng.random((n, 32 * lanes)) < 0.15
                bits[:, k:] = False
                words = (bits.reshape(n, lanes, 32).astype(np.uint64)
                         << np.arange(32, dtype=np.uint64)).sum(axis=-1).astype(np.uint32)
                return u32.to_bits(words).to(dev)
            if pkind == "dist":
                v = (lrng.random((n, lanes)) * 100).astype(np.float32)
                v[lrng.random((n, lanes)) < 0.1] = np.finfo(np.float32).max
                return torch.from_numpy(v).to(dev)
            return torch.from_numpy((lrng.random((n, lanes)) / n).astype(np.float32)).to(dev)

        def lane_agree(got, want, kind, label):
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{label}: shape/dtype {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
            if kind == "sum":
                err = float((got - want).abs().max())
                check(torch.allclose(got, want, **SUM_TOL), f"{label}: kernel disagrees (max err {err})")
                return err
            a = u32.widen(got) if got.dtype == torch.int32 else got.double()
            b = u32.widen(want) if want.dtype == torch.int32 else want.double()
            check(torch.equal(got, want), f"{label}: kernel disagrees with plain version "
                                          f"(max err {float((a - b).abs().max())})")
            return 0.0

        lane_timing, lane_errs = {}, {}
        for arm, (kind, edge_op, identity, lanes, pkind, laneless) in LANE_ARMS.items():
            problem = {"or": bfs(0), "sum": pagerank()}.get(kind, sssp(0))
            pull, push, gkw, skw = streams(pg, problem)
            gkw = dict(gkw, kind=kind, edge_op=edge_op, identity=identity)
            skw = dict(skw, kind=kind, edge_op=edge_op, identity=identity) if skw else None
            payload = lane_payload(pkind, pg.gathered_size, lanes)
            err = 0.0
            word, counts, hi, wts = pull[0]
            for arm_name, extra in (("counts", ()), ("fetch", (seeded_fetch(counts, word.shape[2],
                                                                             FETCH_SHARE),))):
                args = (payload, word, counts, hi, wts) + extra
                got = K.gather_reduce_cores(*args, **gkw)
                want = K.gather_reduce_cores_plain(*args, **gkw)
                sync()
                err = max(err, lane_agree(got, want, kind, f"phase 0 gather {arm} {arm_name}"))
                if kind == "sum":  # lane-ordered, warp-ordered partials: the same bits again
                    again = K.gather_reduce_cores(*args, **gkw)
                    check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
                          f"gather {arm} {arm_name}: two launches gave different bits")
            lane_errs[("gather", arm)] = err
            # timing over the l phase streams: the main path's arm (the fetch map
            # of all real tiles for min/or, the static counts for sum)
            has_hi, has_w = pull[0][2] is not None, pull[0][3] is not None
            real_slots = float(pg.tile_counts.sum()) * pg.tile_word.shape[4] / pg.l
            lane_bytes = pg.gathered_size * lanes * 4 + pg.p * pg.packed_rows_per_core * lanes * 4
            common = pg.tile_counts[:, 0].nbytes + lane_bytes
            if kind == "sum":
                phase_args = pull
            else:
                phase_args = [a + (seeded_fetch(a[1], a[0].shape[2], 1.0),) for a in pull]
                common += pg.tile_counts[:, 0].size * pg.tile_word.shape[3] * 4

            def launch_all(fn, args_list, kw, payload=payload):
                for a in args_list:
                    fn(payload, *a, **kw)

            chunk = None if rehearsal else K.lane_chunk(pg.tile_vb, lanes, kind)
            chunks = -(-lanes // chunk) if chunk else 1
            row = dict(lanes=lanes, lane_chunk=chunk, chunks=chunk and chunks,
                       real_slots_per_phase=real_slots, laneless_variant=laneless,
                       laneless_ms=timing[("gather", laneless)]["ms"])
            row.update(kernel_ms(lambda: launch_all(K.gather_reduce_cores, phase_args, gkw),
                                 reps, pg.l, "gather_reduce_cores"))
            row["plain_ms"] = device_ms(lambda: launch_all(K.gather_reduce_cores_plain, phase_args,
                                                           gkw), max(1, reps // 4), pg.l)
            row.update(bound(real_slots, 1 + has_hi + has_w, common, lanes))
            # what the design moves: each lane chunk's word streams, one L-wide
            # payload row gathered per slot (from L2), the output once
            design = (chunks * real_slots * 4 * (1 + has_hi + has_w) + real_slots * lanes * 4
                      + common - pg.gathered_size * lanes * 4)
            row.update(bytes_per_slot_design=design / real_slots,
                       bytes_per_slot_bound=row["bound_bytes"] / real_slots,
                       gbps_design=design / row["ms"] / 1e6,
                       gbps_bound=row["bound_bytes"] / row["ms"] / 1e6)
            lane_timing[("gather", arm)] = row
            if arm not in PUSH_LANE_ARMS:
                continue
            word, counts, hi, wts = push[0]
            err = 0.0
            for arm_name, extra in (("counts", ()), ("fetch", (seeded_fetch(counts, word.shape[2],
                                                                             FETCH_SHARE),))):
                args = (payload, word, counts, hi, wts) + extra
                got = S.scatter_reduce_cores(*args, **skw)
                want = S.scatter_reduce_cores_plain(*args, **skw)
                sync()
                err = max(err, lane_agree(got, want, kind, f"phase 0 scatter {arm} {arm_name}"))
            lane_errs[("scatter", arm)] = err
            p_hi, p_w = push[0][2] is not None, push[0][3] is not None
            p_slots = float(pg.push_counts.sum()) * pg.push_word.shape[4] / pg.l
            all_real = [a + (seeded_fetch(a[1], a[0].shape[2], 1.0),) for a in push]
            srow = dict(lanes=lanes, real_slots_per_phase=p_slots, laneless_variant=laneless,
                        laneless_ms=timing[("scatter", laneless)]["ms"])
            srow.update(kernel_ms(lambda: launch_all(S.scatter_reduce_cores, all_real, skw),
                                  reps, pg.l, "scatter_reduce_cores_kernel"))
            srow["plain_ms"] = device_ms(lambda: launch_all(S.scatter_reduce_cores_plain, all_real,
                                                            skw), max(1, reps // 4), pg.l)
            s_common = (pg.push_counts[:, 0].nbytes + pg.push_counts[:, 0].size
                        * pg.push_word.shape[3] * 4 + pg.gathered_size * lanes * 4
                        + pg.p * pg.vertices_per_core * lanes * 4)
            srow.update(bound(p_slots, 1 + p_hi + p_w, s_common, lanes))
            scatter_design(p_slots, 1 + p_hi + p_w, lanes, srow,
                           pg.push_counts[:, 0].nbytes
                           + pg.push_counts[:, 0].size * pg.push_word.shape[3] * 4)
            lane_timing[("scatter", arm)] = srow
        emit("lanes_kernels", t0, max_abs_err={f"{k}[{a}]": e for (k, a), e in lane_errs.items()},
             per_launch={f"{k}[{a}]": r for (k, a), r in lane_timing.items()},
             arms={a: dict(kind=v[0], edge_op=v[1], lanes=v[3]) for a, v in LANE_ARMS.items()},
             note="ms, plain_ms: device time per launch by CUDA events around back-to-back "
                  "passes, the stream held while the host enqueues them (profiler_ms: the mean of "
                  "the kernel's profiler events, events_seen of events_expected), "
                  "averaged over the l phase streams, on the arm the main path takes (fetch map of "
                  "all real tiles for min/or, static counts for sum); bound_ms counts each real "
                  "slot's word (+ word_hi, + weight) once plus the L-wide payload and output; "
                  "chunks > 1: each lane chunk re-reads its tiles' words; laneless_ms: the laneless "
                  "arm's ms on the same streams (timing phase); bytes_per_slot_design: the word "
                  "streams once a lane chunk, an L-wide payload row gathered per slot (from L2) "
                  "and the output once, over the real slots (scatter: the word streams once, a "
                  "payload row and an output row read per slot, the output written twice); "
                  "gbps_*: those bytes and the bound's over ms")
        return lane_timing, lane_errs

    lane_timing, lane_errs = lane_kernel_phase()

    # -- main path of this slice: K-lane engine runs, default options ---------
    def lane_engine_phase():
        """bfs_multi, sssp_multi and ppr_multi (twice) at K = LANE_K with the
        default options, launches counted; then the checks against
        independent runs. Returns the launch counts."""
        roots = lrng.integers(0, g.num_vertices, LANE_K)
        lane_runs = [("bfs_multi", bfs_multi(roots)), ("sssp_multi", sssp_multi(roots)),
                     ("ppr_multi", ppr_multi(roots, tol=PPR_RUN_TOL)),
                     ("ppr_multi_repeat", ppr_multi(roots, tol=PPR_RUN_TOL))]
        for _, problem in lane_runs[:3]:  # upload each problem's edge tensors (set-up)
            make_iteration(problem, pg, EngineOptions(), device=dev)
        sync()
        K.reset_launch_counts()
        S.reset_launch_counts()
        t0 = time.perf_counter()
        lane_results = {}

        def lane_run(name, problem, opts):
            labels = prepare_labels(problem, g, pg, device=dev)  # host init (set-up)
            sync()
            t = time.perf_counter()
            res = run(problem, g, pg, opts, labels=labels, device=dev)
            sync()
            sec = time.perf_counter() - t
            lane_results[name] = res
            check(res.converged, f"{name}: did not converge in {res.iterations} iterations")
            for key, v in res.labels.items():
                if v.ndim == 2:  # packed reach words: one per 32 lanes
                    lanes = -(-LANE_K // 32) if key == "reach" else LANE_K
                    check(v.shape == (g.num_vertices, lanes), f"{name}: {key} shape {v.shape}")
                if v.dtype == np.float32:
                    check(bool(np.isfinite(v).all()), f"{name}: non-finite {key}")
            emit("lanes_engine_run", t, problem=name, options=opts.direction, lanes=LANE_K,
                 iterations=res.iterations, run_seconds=sec,
                 query_edges_per_s=LANE_K * n_edges / sec, edges=n_edges)

        for name, problem in lane_runs:
            lane_run(name, problem, EngineOptions(lanes=LANE_K))
        lane_push = [("or_u32_lanes", "bfs_multi", bfs_multi(roots)),
                     ("min_f32_add_lanes", "sssp_multi", sssp_multi(roots))]
        forced = [(n, prob) for v, n, prob in lane_push if S.LAUNCHES.get(v, 0) == 0]
        for name, problem in forced:  # 'auto' never pushed: drive the scatter lane arm anyway
            lane_run(f"{name}_push", problem, EngineOptions(lanes=LANE_K, direction="push"))
        lane_launches = {"gather_reduce_cores": {k: v for k, v in K.LAUNCHES.items()},
                         "scatter_reduce_cores": {k: v for k, v in S.LAUNCHES.items()}}
        expect = sum(r.iterations for r in lane_results.values()) * pg.l
        total = sum(K.LAUNCHES.values()) + sum(S.LAUNCHES.values())
        emit("lanes_engine", t0, launches=lane_launches, total_launches=total,
             expected_launches=expect, forced_push=[f"{n}_push" for n, _ in forced],
             roots=roots.tolist())
        if not rehearsal:
            check(total == expect, f"lane launches {lane_launches} != sum(iterations) * l = {expect}")
            for kern, variants in LANE_VARIANTS.items():
                for v in variants:
                    check(lane_launches[kern].get(v, 0) > 0, f"{kern} lane variant {v} never ran")
        for name, _ in forced:
            a, b = lane_results[name], lane_results[f"{name}_push"]
            check(a.iterations == b.iterations and all(np.array_equal(a.labels[k], b.labels[k])
                                                       for k in a.labels),
                  f"{name}: forced push differs from the 'auto' run")
        a = lane_results["ppr_multi"].labels["label"]
        check(a.tobytes() == lane_results["ppr_multi_repeat"].labels["label"].tobytes(),
              "ppr_multi: two kernel runs gave different bits")
        # checks against independent runs (not counted): laneless columns, the
        # oracle backend's K-lane runs, the schedule of each min/or problem
        t0 = time.perf_counter()
        for k in range(2):
            r = int(roots[k])
            check(np.array_equal(lane_results["bfs_multi"].labels["dist"][:, k],
                                 run(bfs(r), g, pg, device=dev).labels["label"]),
                  f"bfs_multi column {k} != bfs({r})")
            check(np.array_equal(lane_results["sssp_multi"].labels["label"][:, k],
                                 run(sssp(r), g, pg, device=dev).labels["label"]),
                  f"sssp_multi column {k} != sssp({r})")
        oracle = {}
        for name, problem in lane_runs[:2]:
            t = time.perf_counter()
            ref = run(problem, g, pg, EngineOptions(backend="oracle"), device=dev)
            sec = time.perf_counter() - t
            got = lane_results[name]
            check(ref.iterations == got.iterations,
                  f"{name}: iterations kernel {got.iterations} vs oracle {ref.iterations}")
            for key in ref.labels:
                check(np.array_equal(got.labels[key], ref.labels[key]),
                      f"{name}: {key} differs from the oracle backend")
            oracle[name] = dict(iterations=ref.iterations, oracle_seconds=sec)
        # PPR for as many iterations as the counted run took, with no lane
        # frozen (tol=0), so that no convergence threshold can split the two
        # backends; held to the PageRank check's relative tolerance
        n_ppr = lane_results["ppr_multi"].iterations
        fixed = EngineOptions(max_iters=n_ppr)
        pk = run(ppr_multi(roots, tol=0.0), g, pg, fixed, device=dev).labels["label"]
        t = time.perf_counter()
        po = run(ppr_multi(roots, tol=0.0), g, pg, dataclasses.replace(fixed, backend="oracle"),
                 device=dev).labels["label"]
        sec = time.perf_counter() - t
        ppr_err = float(np.max(np.abs(pk - po)))
        ppr_rel = float(np.max(np.abs(pk - po) / np.maximum(np.abs(po), np.finfo(np.float32).tiny)))
        check(bool(np.allclose(pk, po, **SUM_TOL)),
              f"ppr_multi: kernel vs oracle max |diff| {ppr_err}, max relative {ppr_rel}")
        oracle["ppr_multi"] = dict(iterations=n_ppr, oracle_seconds=sec, max_abs_diff=ppr_err,
                                   max_rel_diff=ppr_rel, max_abs_label=float(np.max(np.abs(po))),
                                   tolerance=SUM_TOL)
        schedule = {}
        for name, problem in lane_runs[:2]:
            tr = run_frontier_trace(problem, g, pg, EngineOptions(lanes=LANE_K), device=dev)
            check(tr["iterations"] == lane_results[name].iterations
                  and all(np.array_equal(tr["labels"][k], lane_results[name].labels[k])
                          for k in tr["labels"]), f"{name}: run_frontier_trace differs from run")
            schedule[name] = {k: tr[k] for k in ("iterations", "direction", "push_iterations",
                                                  "dense_iterations", "dynamic_skipped_tile_fraction")}
        emit("lanes_engine_checks", t0, columns_checked=2, oracle=oracle, schedule=schedule,
             ppr_bit_stable=True, ppr_iterations=lane_results["ppr_multi"].iterations,
             ppr_note="ppr iterations have no direction: sum problems stay pull")
        return lane_launches

    lane_launches = lane_engine_phase()

    # -- the one-bucket gather kernel over every (core, phase) bucket ---------
    def bucket_phase():
        """ops.gather_reduce over the 64 buckets of the partition, each tiled
        as the partition tiles it, in three forms (BFS-level min on u32,
        SSSP min-plus with weights, PageRank sum), against the fused kernel
        #1 on the same phase payload (natural rows) and the plain version
        (packed rows). Returns (launches, errors, timing)."""
        t0 = time.perf_counter()
        from repro_torch.core.partition import _bucket_split_threshold

        t = time.perf_counter()
        cfg = PartitionConfig(**CFG)
        vpc, vb, eb = pg.vertices_per_core, pg.tile_vb, pg.tile_word.shape[4]
        host = [[BO.prepare_tiles(
            pg.src_gidx[i, m], pg.dst_lidx[i, m], pg.valid[i, m], num_rows=vpc, vb=vb, eb=eb,
            weights=pg.weights[i, m] if pg.weights is not None else None,
            balance_rows=cfg.degree_aware_tiles,
            split_threshold=_bucket_split_threshold(cfg, int(pg.valid[i, m].sum()), vpc // vb))
            for m in range(pg.l)] for i in range(pg.p)]
        build_s = time.perf_counter() - t
        tiles = [[BO.layout_to(tl, dev) for tl in row] for row in host]
        sync()
        slots = sum(int(tl.valid.size) for row in host for tl in row)
        real = sum(int(tl.valid.sum()) for row in host for tl in row)
        split_buckets = sum(tl.row_orig is not None for row in host for tl in row)
        fused_real_slots = float(pg.tile_counts.sum()) * eb
        forms = {"min_u32": bfs(0), "min_f32_add": sssp(0), "sum_f32": pagerank()}
        payloads = {v: [payload_for(v, pg.gathered_size) for _ in range(pg.l)] for v in forms}
        errs, timing = {}, {}
        sync()
        B.reset_launch_counts()
        outs = {}
        for variant, problem in forms.items():  # the main path: ops.gather_reduce per bucket
            kw = dict(kind=problem.reduce_kind, edge_op=problem.edge_op,
                      identity=problem.identity)
            outs[variant] = [[BO.gather_reduce(payloads[variant][m], tiles[i][m], **kw)
                              for m in range(pg.l)] for i in range(pg.p)]
        sync()
        bucket_launches = dict(B.LAUNCHES)
        if not rehearsal:
            check(bucket_launches == {v: pg.p * pg.l for v in forms},
                  f"bucket launches {bucket_launches} != {pg.p * pg.l} per form")
        reps = 2 if rehearsal else 10
        for variant, problem in forms.items():
            kw = dict(kind=problem.reduce_kind, edge_op=problem.edge_op,
                      identity=problem.identity)
            consts = _edge_constants(problem, pg, EngineOptions(), dev)
            err = 0.0
            for m in range(pg.l):
                fused = channel_phase_reduce(problem, pg, payloads[variant][m],
                                             phase_consts_at(consts, m))
                for i in range(pg.p):
                    err = max(err, agree(outs[variant][i][m], fused[i], variant,
                                         f"bucket ({i}, {m}) vs fused"))
            del consts
            add = problem.edge_op == "add"

            def raw_args(i, m, variant=variant, add=add):
                tl = tiles[i][m]
                return ((payloads[variant][m], tl.src, tl.dstb, tl.valid,
                         tl.weights if add else None),
                        dict(num_rows=tl.src.shape[0] * vb, vb=vb, **kw))

            for i, m in ((0, 0), (pg.p - 1, pg.l - 1), (1, pg.l // 2)):
                a, k2 = raw_args(i, m)
                got = B.gather_reduce_bucket(*a, **k2)
                err = max(err, agree(got, B.gather_reduce_bucket_plain(*a, **k2), variant,
                                     f"bucket ({i}, {m}) kernel vs plain"))
                if variant == "sum_f32":
                    check(torch.equal(got.view(torch.int32),
                                      B.gather_reduce_bucket(*a, **k2).view(torch.int32)),
                          f"bucket ({i}, {m}) sum: two launches gave different bits")
            errs[variant] = err
            every = [raw_args(i, m) for i in range(pg.p) for m in range(pg.l)]
            n = len(every)
            row = dict(launches_per_call=n)
            row.update(kernel_ms(lambda: [B.gather_reduce_bucket(*a, **k2) for a, k2 in every],
                                 reps, n, "gather_reduce_kernel"))
            row["plain_ms"] = device_ms(
                lambda: [B.gather_reduce_bucket_plain(*a, **k2) for a, k2 in every],
                max(1, reps // 5), n)
            # each real slot's src, dstb, valid (and weight) once, plus the
            # payload and the output, per launch
            out_rows = sum(int(tl.src.shape[0]) * vb for row_ in host for tl in row_)
            nbytes = real * (9 + 4 * add) + n * pg.gathered_size * 4 + out_rows * 4
            row.update(bound(0, 0, nbytes / n))
            row["bound_ms"] = max(row["bound_ms"], real / n / F32_OPS_PER_S * 1e3)
            timing[variant] = row
        emit("bucket", t0, buckets=pg.p * pg.l, layout_build_seconds=build_s,
             split_buckets=split_buckets, slots=slots, real_edges=real,
             padding_share=1.0 - real / max(slots, 1), launches=bucket_launches,
             max_abs_err=errs, per_launch=timing,
             stream_bytes_per_edge={
                 "bucket_arrays": slots * 9 / real, "bucket_arrays_weighted": slots * 13 / real,
                 "bucket_read": (slots + 8 * real) / real,
                 "fused_packed_words": fused_real_slots * 4 * (1 + (pg.src_bits == 32)) / real},
             note="ms: device time per launch by CUDA events around 10 back-to-back passes "
                  "of the 64 buckets, the stream held while the host enqueues them "
                  "(profiler_ms: the mean of the kernel's profiler events over as many passes, "
                  "events_seen of events_expected); plain_ms: the same for the plain "
                  "version; bound: each real slot's src, dstb, valid (and weight) "
                  "once plus the phase payload and the output at 3.35 TB/s; bucket_read: the "
                  "valid byte of every slot plus src and dstb of the real ones; "
                  "fused_packed_words: the fused kernel's 4 B word of every slot of its real "
                  "tiles; no single PyTorch call computes the function (library_ms null)")
        del tiles, outs, payloads
        return bucket_launches, errs, timing

    bucket_launches, bucket_errs, bucket_timing = bucket_phase()

    # -- DIN at the published width: parameters drawn on the card from the seed
    din_cfg = get_arch("din").smoke() if rehearsal else get_arch("din").model
    din_train_batch = 1024 if rehearsal else get_arch("din").shape("train_batch").dims["batch"]
    t0 = time.perf_counter()
    din_params = din.init(din_cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    sync()
    din_init_s = time.perf_counter() - t0

    def bag_bound(table, ids):
        """Least time for one launch: every id (4 B) read and the output
        written once, plus the distinct 32-B sectors of the rows the real ids
        touch (a row of the 10,000-row cate table read by many bags counts
        once); one add per real id and column at the float32 rate."""
        d = table.shape[1]
        row_bytes = d * 4
        every = ids[ids >= 0].long()
        # the 32-B sectors of every real id's row, a row read again counted
        # again: what the loads move out of L2 where the table sits there
        sector_bytes = int(((every * row_bytes + row_bytes - 1) // 32
                            - every * row_bytes // 32 + 1).sum()) * 32
        real = every.unique()
        first, last = real * row_bytes // 32, (real * row_bytes + row_bytes - 1) // 32
        span = torch.arange((row_bytes + 31) // 32 + 1, device=ids.device)
        sec = first[:, None] + span[None, :]
        n_sec = int(sec[sec <= last[:, None]].unique().numel())
        nbytes = ids.numel() * 4 + ids.shape[0] * row_bytes + n_sec * 32
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = int((ids >= 0).sum()) * d / F32_OPS_PER_S * 1e3
        return dict(bound_ms=max(bytes_ms, ops_ms), bound_bytes=nbytes,
                    distinct_rows=int(real.numel()), sectors=n_sec,
                    row_sector_bytes_every_id=sector_bytes,
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations")

    def library_call(table, ids, mode):
        """The one PyTorch call computing the same function (timed only)."""
        import torch.nn.functional as Fn

        idc, valid = ids.clamp(min=0), ids >= 0
        w = valid.to(table.dtype)
        cnt = valid.sum(dim=1, keepdim=True).clamp(min=1).to(table.dtype)
        if mode == "sum":
            return lambda: Fn.embedding_bag(idc, table, mode="sum", per_sample_weights=w)
        return lambda: Fn.embedding_bag(idc, table, mode="sum", per_sample_weights=w) / cnt

    def bag_kernel_phase():
        """The embedding-bag kernel against its plain version at the four
        shapes, with times and bounds. Returns ({shape[mode]: row}, {mode:
        max error})."""
        t0 = time.perf_counter()
        reps = 3 if rehearsal else 50
        c = din_cfg

        def recsys(batch, step, key):
            b = recsys_batch(SEED, step, batch, c.seq_len, c.item_vocab, c.cate_vocab,
                             c.profile_bag_len)[key]
            return torch.from_numpy(np.ascontiguousarray(b, dtype=np.int32)).to(dev)

        one = retrieval_batch(SEED, c.seq_len, 1, c.item_vocab, c.cate_vocab, c.profile_bag_len)
        shapes = {
            "a_serve_p99": (din_params["cate_table"], [recsys(DIN_BATCH, 0, "profile_bag")]),
            "b_serve_bulk": (din_params["cate_table"],
                             [recsys(4096 if rehearsal else 262_144, 1, "profile_bag")]),
            "c_cold_items": (din_params["item_table"],
                             [recsys(4096, 2 + k, "hist_items") for k in range(COLD_SETS)]),
            "d_one_bag": (din_params["cate_table"],
                          [torch.from_numpy(one["profile_bag"]).to(dev)]),
            "e_train_batch": (din_params["cate_table"],
                              [recsys(din_train_batch, 10, "profile_bag")]),
        }
        rows, errs = {}, {"sum": 0.0, "mean": 0.0}
        for shape, (table, id_sets) in shapes.items():
            ids0 = id_sets[0]
            for mode in ("sum", "mean"):  # checks; they also warm both modes
                got = embedding_bag(table, ids0, mode)
                want = embedding_bag_reference(table, ids0, mode)
                again = embedding_bag(table, ids0, mode)
                lib = library_call(table, ids0, mode)()
                sync()
                err = float((got - want).abs().max()) if got.numel() else 0.0
                check(got.shape == want.shape == (ids0.shape[0], table.shape[1]),
                      f"bag {shape} {mode}: shape {tuple(got.shape)}")
                check(torch.allclose(got, want, **BAG_TOL),
                      f"bag {shape} {mode}: kernel disagrees with plain version (max err {err})")
                check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                      f"bag {shape} {mode}: not the plain version's bits")
                check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
                      f"bag {shape} {mode}: two launches gave different bits")
                errs[mode] = max(errs[mode], err)
                row = dict(bags=ids0.shape[0], length=ids0.shape[1], table_rows=table.shape[0],
                           d=table.shape[1], id_sets=len(id_sets), max_abs_err=err,
                           plain_bits_equal=True,
                           library_max_abs_err=float((lib - want).abs().max()),
                           padding_share=float((ids0 < 0).float().mean()))
                bounds = [bag_bound(table, ids) for ids in id_sets]
                row.update(bounds[0])
                row["bound_ms"] = float(np.mean([b["bound_ms"] for b in bounds]))
                rows[f"{shape}[{mode}]"] = row
            # readings alternate the modes (sum, mean, mean, sum, ...) so that
            # neither is always timed first; each launch takes the next id
            # set (shape (c): rows out of L2)
            cyc = {m: itertools.cycle(id_sets) for m in ("sum", "mean")}
            libs = {m: itertools.cycle([library_call(table, ids, m) for ids in id_sets])
                    for m in ("sum", "mean")}
            readings = {m: {"ms": [], "plain_ms": [], "library_ms": []} for m in ("sum", "mean")}
            seen = {m: [0, 0] for m in ("sum", "mean")}  # profiler events seen, expected
            for mode in ("sum", "mean", "mean", "sum") * BAG_ROUNDS:
                r = readings[mode]
                kr = kernel_ms(lambda: embedding_bag(table, next(cyc[mode]), mode), reps, 1,
                               "embedding_bag_kernel")
                r["ms"].append(kr["ms"])
                seen[mode] = [a + b for a, b in zip(seen[mode], (kr["events_seen"] or 0,
                                                                 kr["events_expected"]))]
                r["plain_ms"].append(device_ms(
                    lambda: embedding_bag_reference(table, next(cyc[mode]), mode),
                    max(1, reps // 5), 1))
                r["library_ms"].append(device_ms(lambda: next(libs[mode])(), reps, 1))
            for mode, r in readings.items():
                row = rows[f"{shape}[{mode}]"]
                row["events_seen"], row["events_expected"] = seen[mode]
                for key, vals in r.items():
                    row[key] = float(np.median(vals))
                    row[f"{key}_min_max"] = [min(vals), max(vals)]
        pad = torch.full((1, c.profile_bag_len), -1, dtype=torch.int32, device=dev)
        for mode in ("sum", "mean"):
            z = embedding_bag(din_params["cate_table"], pad, mode)
            sync()
            check(not bool(z.any()), f"bag all-padding {mode}: not zero")
        bwd_rows, bwd_errs = bag_backward_rows({k: shapes[k][1][0] for k in ("e_train_batch",
                                                                             "a_serve_p99")},
                                               din_params["cate_table"], reps)
        emit("bag_kernel", t0, per_launch=rows, max_abs_err=errs, tolerance=BAG_TOL,
             all_padding_bag_zero=True,
             note="ms, plain_ms, library_ms: device time per launch by CUDA events around "
                  "back-to-back launches, the stream held while the host enqueues them "
                  "(events_seen: the profiler's events of the kernel over as many launches, of "
                  "events_expected), the median and the min/max of 2 * BAG_ROUNDS readings per mode, "
                  "the modes alternated (sum, mean, mean, sum, ...); each launch on the next of "
                  "id_sets; plain: L takes added in id order (serial); library: F.embedding_bag "
                  "(clamped ids, the validity mask as per_sample_weights), / max(count, 1) for "
                  "mean; bound_ms: ids + output + distinct 32-B row sectors at 3.35 TB/s, "
                  "averaged over the id sets; row_sector_bytes_every_id: the row sectors of "
                  "every real id, reckoned from the shape (what the loads move out of L2 "
                  "where the table sits there); the kernel's bits are the plain version's",
             backward_per_launch=bwd_rows, backward_max_abs_err=bwd_errs,
             backward_note="the table's gradient at (e) and (a) from a seeded grad_out: ms: the "
                           "whole backward (stable sort of the ids, run starts, counts for mean, "
                           "the kernel) by CUDA events, the stream held; kernel_ms: the kernel "
                           "alone on precomputed runs; plain_ms: the plain version on the card "
                           "(index_add_, atomics); library_ms: the CUDA backward of one "
                           "F.embedding_bag on the valid ids with bag offsets (torch.autograd."
                           "grad, the forward done once); launches_per_call: the device "
                           "launches of one call of each (the profiler's count), which sizes "
                           "each hold to at most QUEUED_LAUNCHES launches; *hold_covered: "
                           "whether each hold outlasted its enqueues; bound_ms: the "
                           "function's, grad_out + ids + the gradient at 3.35 TB/s, or one "
                           "add a real id and column (and a division for mean) at the float32 "
                           "rate; bound_ms_with_sort: the same with SORT_BYTES_PER_ID (24 B) a "
                           "slot of the design's sort traffic (sort_bytes) added, a "
                           "diagnostic; plain_cpu_bits_equal: the kernel's "
                           "output bit for bit the plain version's run on the CPU on the same "
                           "inputs; plain_card_bits_equal: the same against the plain version "
                           "on the card, whose order varies")
        return rows, errs, bwd_rows, bwd_errs

    def bag_backward_rows(id_sets, table, reps):
        """The backward kernel against its plain version at the given shapes,
        sum and mean: bits, ms, bound, plain and library ms."""
        import torch.nn.functional as Fn

        n, d = table.shape
        grng = np.random.default_rng(SEED + 9)
        rows, errs = {}, {"sum": 0.0, "mean": 0.0}
        for shape, ids in id_sets.items():
            bsz, length = ids.shape
            g_out = torch.from_numpy(grng.standard_normal((bsz, d)).astype(np.float32)).to(dev)
            valid = ids >= 0
            n_valid = int(valid.sum())
            flat = ids.reshape(-1)
            lib_in = flat[flat >= 0].long()
            lib_off = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                                 valid.sum(dim=1).cumsum(0)[:-1]])
            for mode in ("sum", "mean"):
                if dev.type == "cuda":
                    def backward(mode=mode):
                        return EB.embedding_bag_backward_cuda(g_out, ids, n, mode)
                    order, start = EB.backward_runs(ids, n)
                    counts = valid.sum(dim=1, dtype=torch.int32) if mode == "mean" else None

                    def kernel_only(order=order, start=start, counts=counts, mode=mode):
                        return EB.launch_backward(g_out, order, start, counts, length, mode)
                else:
                    def backward(mode=mode):
                        return embedding_bag_backward_reference(g_out, ids, n, mode)
                    kernel_only = None
                got, again = backward(), backward()
                sync()
                want = embedding_bag_backward_reference(g_out.cpu(), ids.cpu(), n, mode)
                plain_card = embedding_bag_backward_reference(g_out, ids, n, mode)
                sync()
                err = float((got.cpu() - want).abs().max())
                check(got.shape == (n, d) and got.dtype == torch.float32,
                      f"bag backward {shape} {mode}: shape {tuple(got.shape)} {got.dtype}")
                check(torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)),
                      f"bag backward {shape} {mode}: not the bits of the plain version on the "
                      f"CPU (max err {err})")
                check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
                      f"bag backward {shape} {mode}: two launches gave different bits")
                errs[mode] = max(errs[mode], err)
                t = table.detach().clone().requires_grad_(True)
                lib_out = Fn.embedding_bag(lib_in, t, lib_off, mode=mode)

                def library(t=t, lib_out=lib_out):
                    return torch.autograd.grad(lib_out, t, g_out, retain_graph=True)[0]

                lib_err = float((library() - got).abs().max())

                def plain(mode=mode):
                    return embedding_bag_backward_reference(g_out, ids, n, mode)

                launches = {k: device_launches(f) for k, f in (
                    ("whole", backward), ("plain", plain), ("library", library))}
                kr = kernel_ms(backward, reps, 1, "embedding_bag_backward", launches["whole"])
                timed = {}
                for key, f, r in (("kernel", kernel_only, reps),
                                  ("plain", plain, max(1, reps // 5)),
                                  ("library", library, reps)):
                    timed[key] = (device_ms(f, r, 1, launches.get(key)), hold["hold_covered"]) \
                        if f is not None else (None, None)
                nbytes = (g_out.numel() + ids.numel() + n * d) * 4
                sort_bytes = SORT_BYTES_PER_ID * ids.numel()
                ops = n_valid * d * (2 if mode == "mean" else 1)
                bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
                rows[f"{shape}[{mode}]"] = dict(
                    bags=bsz, length=length, table_rows=n, d=d, real_ids=n_valid,
                    max_abs_err=err, plain_cpu_bits_equal=True,
                    plain_card_bits_equal=bool(torch.equal(got.view(torch.int32),
                                                           plain_card.view(torch.int32))),
                    plain_card_max_abs_err=float((got - plain_card).abs().max()),
                    library_max_abs_err=lib_err,
                    ms=kr["ms"], ms_from=kr["ms_from"], hold_covered=kr.get("hold_covered"),
                    launches_per_call=launches,
                    profiler_ms=kr["profiler_ms"], events_seen=kr["events_seen"],
                    events_expected=kr["events_expected"],
                    kernel_ms=timed["kernel"][0], kernel_hold_covered=timed["kernel"][1],
                    plain_ms=timed["plain"][0], plain_hold_covered=timed["plain"][1],
                    library_ms=timed["library"][0], library_hold_covered=timed["library"][1],
                    bound_ms=max(bytes_ms, ops_ms), bound_bytes=nbytes,
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                    sort_bytes=sort_bytes,
                    bound_ms_with_sort=max((nbytes + sort_bytes) / HBM_BYTES_PER_S * 1e3,
                                           ops_ms))
        return rows, errs

    bag_rows, bag_errs, bag_bwd_rows, bag_bwd_errs = bag_kernel_phase()

    def din_phase():
        """DIN pointwise and retrieval scoring at the published width, as the
        reference CLI runs them, with the kernel's launches counted. Returns
        the launch counts."""
        t0 = time.perf_counter()
        c = din_cfg
        host = recsys_batch(SEED, 0, DIN_BATCH, c.seq_len, c.item_vocab, c.cate_vocab,
                            c.profile_bag_len)
        pb = din.batch_to({k: v for k, v in host.items() if k != "labels"}, dev)
        rb = din.batch_to(retrieval_batch(SEED, c.seq_len, DIN_CANDIDATES, c.item_vocab,
                                          c.cate_vocab, c.profile_bag_len), dev)
        calls = {
            "pointwise": lambda: din.score(din_params, pb, c),
            "retrieval": lambda: din.score_candidates(din_params, rb, c, chunk=DIN_CHUNK),
        }
        reps = {"pointwise": 3, "retrieval": 2} if rehearsal else \
            {"pointwise": 50, "retrieval": 20}
        for fn in calls.values():  # warm
            fn()
        sync()
        EB.reset_launch_counts()
        scores, ms = {}, {}
        for name, fn in calls.items():
            lat = []
            t_all = time.perf_counter()
            for _ in range(reps[name]):
                t = time.perf_counter()
                scores[name] = fn()
                sync()
                lat.append((time.perf_counter() - t) * 1e3)
            ms[name] = dict(total_ms=(time.perf_counter() - t_all) * 1e3,
                            median_ms=float(np.median(lat)), min_ms=min(lat), max_ms=max(lat))
        din_launches = dict(EB.LAUNCHES)
        n_calls = sum(reps.values())
        check(scores["pointwise"].shape == (DIN_BATCH,)
              and scores["retrieval"].shape == (DIN_CANDIDATES,), "DIN score shapes")
        for name, s in scores.items():
            check(bool(torch.isfinite(s).all()), f"DIN {name}: non-finite scores")
        if not rehearsal:
            check(din_launches == {"sum": n_calls},
                  f"DIN: embedding-bag launches {din_launches} != {n_calls} calls")
        # the same calls with the profile bag through the plain version
        kernel_bag = din.embedding_bag
        din.embedding_bag = lambda table, ids, mode: embedding_bag_reference(table, ids, mode)
        try:
            plain = {name: fn() for name, fn in calls.items()}
        finally:
            din.embedding_bag = kernel_bag
        diffs = {}
        for name in calls:
            diffs[name] = float((scores[name] - plain[name]).abs().max())
            check(torch.allclose(scores[name], plain[name], **DIN_TOL),
                  f"DIN {name}: scores differ from the plain-bag run by {diffs[name]}")
        prof, n_prof = {}, 3
        for name, fn in calls.items():
            wall_us, evs = profiled(lambda fn=fn: [fn() for _ in range(n_prof)])
            dev_us = sum(event_us(e) for e in evs)
            top = sorted(evs, key=event_us, reverse=True)[:6]
            prof[name] = dict(
                wall_us=wall_us / n_prof, device_busy_us=dev_us / n_prof,
                bag_kernel_us=sum(event_us(e) for e in evs if "embedding_bag" in e.key) / n_prof,
                device_idle_share=1.0 - dev_us / wall_us if wall_us else None,
                device_launches=sum(e.count for e in evs) / n_prof,
                top_device_us={e.key[:80]: [event_us(e) / n_prof, e.count / n_prof] for e in top})
        emit("din", t0, config={k: (str(v) if k == "dtype" else v)
                                for k, v in dataclasses.asdict(c).items() if k != "lookup"},
             lookup="take", init_seconds=din_init_s, batch=DIN_BATCH,
             candidates=DIN_CANDIDATES, chunk=DIN_CHUNK, calls=reps, ms_per_call=ms,
             pointwise_qps=DIN_BATCH * reps["pointwise"] / ms["pointwise"]["total_ms"] * 1e3,
             retrieval_candidates_per_s=DIN_CANDIDATES * reps["retrieval"]
             / ms["retrieval"]["total_ms"] * 1e3,
             launches=din_launches, expected_launches=n_calls,
             max_abs_diff_vs_plain_bag=diffs, tolerance=DIN_TOL, profile=prof,
             note="lookup: the item-table reads are a take, as the reference CLI runs DIN "
                  "(the config's 'crossbar' runs in serve's RecommendScorer); QPS and "
                  "candidates/s: the rows scored over the wall of all timed calls; "
                  "ms_per_call: host clock around one call ending in a synchronize; "
                  "profile: per call over 3 calls under torch.profiler, device events only")
        return din_launches

    din_launches = din_phase()

    def _leaf_names(tree, prefix=()):
        """Leaf paths in ``tree_flatten``'s order (dict keys sorted)."""
        if isinstance(tree, dict):
            return [n for k in sorted(tree) for n in _leaf_names(tree[k], prefix + (k,))]
        if isinstance(tree, (list, tuple)):
            return [n for i, v in enumerate(tree) for n in _leaf_names(v, prefix + (i,))]
        return [prefix]

    class PlainBag(torch.autograd.Function):
        """The bag through both plain versions (forward and backward), on
        the tensors' device."""

        @staticmethod
        def forward(ctx, table, ids, mode):
            ctx.save_for_backward(ids)
            ctx.mode, ctx.n = mode, table.shape[0]
            return embedding_bag_reference(table, ids, mode)

        @staticmethod
        def backward(ctx, g):
            (ids,) = ctx.saved_tensors
            return embedding_bag_backward_reference(g.contiguous(), ids, ctx.n, ctx.mode), \
                None, None

    @contextlib.contextmanager
    def din_bag(swap):
        """DIN's profile bag swapped for ``swap(table, ids, mode)``."""
        kernel_bag = din.embedding_bag
        din.embedding_bag = swap
        try:
            yield
        finally:
            din.embedding_bag = kernel_bag

    def din_train_phase():
        """DIN training at the published width on train_batch: the first
        step's loss and grads against plain bags and against a detached bag,
        DIN_TRAIN_STEPS counted AdamW steps, the held batch's loss falling.
        Returns the bag's launches over the counted steps."""
        from repro_torch.train import steps as train_steps
        from repro_torch.train.optim import AdamWConfig, tree_flatten

        t0 = time.perf_counter()
        c = din_cfg
        n_steps = 3 if rehearsal else DIN_TRAIN_STEPS
        ocfg = AdamWConfig(lr=1e-3, total_steps=n_steps, warmup_steps=min(20, n_steps))
        t = time.perf_counter()
        batches = [din.batch_to(recsys_batch(SEED, i, din_train_batch, c.seq_len, c.item_vocab,
                                             c.cate_vocab, c.profile_bag_len), dev)
                   for i in range(n_steps + 1)]  # the last for the profiled step
        sync()
        batch_s = time.perf_counter() - t
        held = batches[0]
        loss_fn = train_steps.make_din_loss(c)
        # the first step: the kernels' bag against both plain versions, and
        # against a bag whose output is detached (the fault this slice fixed)
        loss_k, grads_k = train_steps.value_and_grad(loss_fn, din_params, held)
        with din_bag(lambda table, ids, mode: PlainBag.apply(table, ids, mode)):
            loss_p, grads_p = train_steps.value_and_grad(loss_fn, din_params, held)
        with din_bag(lambda table, ids, mode: embedding_bag(table, ids, mode).detach()):
            _, grads_d = train_steps.value_and_grad(loss_fn, din_params, held)
        sync()
        names = [".".join(map(str, k)) for k in _leaf_names(grads_k)]
        gk, gp = tree_flatten(grads_k)[0], tree_flatten(grads_p)[0]
        grad_err = {nm: float((a - b).abs().max()) for nm, a, b in zip(names, gk, gp)}
        check(torch.allclose(loss_k, loss_p, **DIN_TOL),
              f"din train first step: loss {float(loss_k)} vs plain bags {float(loss_p)}")
        for nm, a, b in zip(names, gk, gp):
            check(torch.allclose(a, b, **DIN_TOL),
                  f"din train first step: grad {nm} differs from plain bags by {grad_err[nm]}")
        cate_k, cate_d = grads_k["cate_table"], grads_d["cate_table"]
        bag_part = float((cate_k - cate_d).abs().max())
        check(not torch.equal(cate_k, cate_d),
              "din train: cate_table's gradient equals the detached bag's (no bag backward)")
        del grads_k, grads_p, grads_d, gk, gp, cate_k, cate_d
        step = train_steps.make_din_train_step(c, ocfg)
        state = train_steps.init_train_state(din_params, ocfg)
        state, _ = step(state, held)  # warm (not counted)
        state = train_steps.init_train_state(din_params, ocfg)
        sync()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        EB.reset_launch_counts()
        lat, losses = [], []
        t_all = time.perf_counter()
        for i in range(n_steps):
            t = time.perf_counter()
            state, m = step(state, batches[i])
            losses.append(float(m["loss"]))  # waits for the step
            lat.append((time.perf_counter() - t) * 1e3)
        wall = time.perf_counter() - t_all
        launches = dict(EB.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
        with torch.no_grad():
            held_after = float(loss_fn(state["params"], held))
        check(all(np.isfinite(losses)), f"din train: non-finite losses {losses}")
        check(held_after < float(loss_k),
              f"din train: the held batch's loss did not fall ({float(loss_k)} -> {held_after})")
        if not rehearsal:
            check(launches == {"sum": n_steps, "sum_backward": n_steps},
                  f"din train: bag launches {launches} != one forward and one backward a step "
                  f"over {n_steps} steps")
        wall_us, evs = profiled(lambda: step(state, batches[n_steps]))
        dev_us = sum(event_us(e) for e in evs)
        bwd_us = sum(event_us(e) for e in evs if "embedding_bag_backward" in e.key)
        top = sorted(evs, key=event_us, reverse=True)[:8]
        emit("din_train", t0, config={k: (str(v) if k == "dtype" else v)
                                      for k, v in dataclasses.asdict(c).items() if k != "lookup"},
             lookup="take", batch=din_train_batch, steps=n_steps, batch_seconds=batch_s,
             optimizer=dict(lr=ocfg.lr, warmup_steps=ocfg.warmup_steps,
                            total_steps=ocfg.total_steps, weight_decay=ocfg.weight_decay),
             ms_per_step=dict(median=float(np.median(lat)), min=min(lat), max=max(lat)),
             steps_per_s=n_steps / wall, samples_per_s=n_steps * din_train_batch / wall,
             losses=losses, held_batch_loss=[float(loss_k), held_after],
             first_step_loss=[float(loss_k), float(loss_p)], first_step_grad_max_abs_diff=grad_err,
             tolerance=DIN_TOL, cate_grad_bag_part_max_abs=bag_part, launches=launches,
             expected_launches={"sum": n_steps, "sum_backward": n_steps},
             peak_memory_bytes=peak,
             profiled_step=dict(wall_us=wall_us, device_busy_us=dev_us,
                                device_idle_share=1.0 - dev_us / wall_us if wall_us else None,
                                device_events=sum(e.count for e in evs),
                                bag_backward_us=bwd_us,
                                bag_backward_share=bwd_us / dev_us if dev_us else None,
                                top_device_us={e.key[:80]: [event_us(e), e.count] for e in top}),
             note="the first step against a run whose bag runs both plain versions on the card "
                  "(forward: L takes in id order; backward: index_add_) within DIN_TOL, and "
                  "against a detached bag (cate_grad_bag_part_max_abs: the bag's part of "
                  "cate_table's gradient); steps on recsys_batch(0, i) made on the device "
                  "before the timed loop; ms_per_step: host clock around a step ending in the "
                  "loss's read; held_batch_loss: step 0's batch before the steps and "
                  "re-scored after them; profiled_step: one more step under torch.profiler, "
                  "device events only (floors)")
        del state, batches, held
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return launches

    din_train_launches = din_train_phase()

    # -- the serving path: GraphService over the built partition --------------
    t0 = time.perf_counter()
    from repro_torch.launch.serve import _serve_events, check_replay_equivalence
    from repro_torch.serve import GraphService, LoopConfig, RecommendScorer, RequestLoop

    workload = mixed_query_workload(SERVE_QUERIES, g.num_vertices, seed=SEED)  # default mix
    n_recommend = sum(1 for q in workload if q["kind"] == "recommend")
    deltas = edge_insertion_stream(SERVE_INSERTS, g.num_vertices, num_batches=SERVE_FLUSHES,
                                   weighted=True, seed=SEED + 1)
    scorer = RecommendScorer(din_cfg, pool_size=64, topk=8, params=din_params, device=dev)
    service = GraphService(g, pg, lanes=LANE_K, scorer=scorer, device=dev)
    del pg  # the service owns the partition now: a flush retires it
    flush_memory = []
    service_flush = service.flush

    def measured_flush():
        """The service's flush, with the device memory before and after and
        the bytes of the retired partition's device copies."""
        gc.collect()
        sync()
        cached = sum(t.untyped_storage().nbytes() for t in service.pg.device_cache.values()
                     if t is not None and t.device.type == "cuda")
        before = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        rec = service_flush()
        gc.collect()
        sync()
        after = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        flush_memory.append(dict(memory_allocated_before=before, memory_allocated_after=after,
                                 retired_device_cache_bytes=cached, wall_s=rec.wall_s))
        print(f"flush {len(flush_memory)}: torch.cuda.memory_allocated() {before} -> {after} "
              f"(retired device copies {cached} B)", flush=True)
        return rec

    service.flush = measured_flush
    loop = RequestLoop(service, LoopConfig(max_wait_ms=20.0, host_batch=LANE_K))
    sync()
    K.reset_launch_counts()
    S.reset_launch_counts()
    EB.reset_launch_counts()
    completions = loop.run(_serve_events(workload, deltas))
    sync()
    serve_launches = {"gather_reduce_cores": dict(K.LAUNCHES),
                      "scatter_reduce_cores": dict(S.LAUNCHES), "embedding_bag": dict(EB.LAUNCHES)}
    summ = loop.metrics.summary()
    trav = [b for b in loop.metrics.batches if b.iterations > 0]
    expect = sum(b.iterations for b in trav) * service.pg.l
    total = sum(K.LAUNCHES.values()) + sum(S.LAUNCHES.values())
    emit("serve", t0, lanes=LANE_K, queries=summ["queries"], rejected=summ["rejected"],
         wall_s=summ["wall_s"], qps=summ["qps"], latency=summ["latency"],
         per_kind=summ["per_kind"], batches=summ["batches"], cold_batches=summ["cold_batches"],
         steady_batch_ms=summ["steady_batch_ms"], amortized_mteps=summ["amortized_mteps"],
         flushes=summ["flushes"], flush_memory=flush_memory, launches=serve_launches,
         total_launches=total, expected_launches=expect, mix=DEFAULT_QUERY_MIX,
         recommend_queries=n_recommend, inserted_edges=SERVE_INSERTS,
         batch_walls_ms_by_kind={k: [b.wall_s * 1e3 for b in loop.metrics.batches if b.kind == k]
                                 for k in sorted({b.kind for b in loop.metrics.batches})},
         batch_log=[dict(kind=b.kind, served=b.served, wall_ms=b.wall_s * 1e3,
                         iterations=b.iterations, cold=b.cold) for b in loop.metrics.batches])
    check(len(completions) == SERVE_QUERIES, f"{len(completions)} answers for {SERVE_QUERIES}")
    check(len(summ["flushes"]) == SERVE_FLUSHES,
          f"{len(summ['flushes'])} flushes, expected {SERVE_FLUSHES}")
    check(service.g.num_edges == n_edges + SERVE_INSERTS, "the served graph lost insertions")
    if not rehearsal:
        check(total == expect, f"serve launches {serve_launches} != sum(iterations) * l = {expect}")
        for v in LANE_VARIANTS["gather_reduce_cores"]:
            check(serve_launches["gather_reduce_cores"].get(v, 0) > 0,
                  f"serve: gather lane variant {v} never ran")
        check(n_recommend > 0 and serve_launches["embedding_bag"] == {"sum": n_recommend},
              f"serve: embedding-bag launches {serve_launches['embedding_bag']} != "
              f"{n_recommend} recommend queries")
        for rec in flush_memory:
            freed = rec["memory_allocated_before"] - rec["memory_allocated_after"]
            check(rec["retired_device_cache_bytes"] > 0
                  and freed >= rec["retired_device_cache_bytes"],
                  f"evict_from_cache freed {freed} B of {rec['retired_device_cache_bytes']} B")

    # the smoke's equivalence: a cold partition of the final graph, every
    # answer replayed on both partitions, BFS/WCC/SSSP labels and iterations
    t0 = time.perf_counter()
    g_final, pg_res = service.g, service.pg
    del service, loop, completions
    t = time.perf_counter()
    pg_cold = partition_2d(g_final, PartitionConfig(**CFG))
    cold_build_s = time.perf_counter() - t
    replayed = check_replay_equivalence(g_final, pg_res, pg_cold, workload, LANE_K, dev, scorer)
    check(replayed.get("recommend", 0) == n_recommend and replayed.get("neighbors", 0) > 0,
          f"serve_equivalence replayed {replayed}")
    emit("serve_equivalence", t0, cold_build_seconds=cold_build_s, answers_by_kind=replayed,
         labels_checked=["bfs", "wcc", "sssp"], bit_identical=True,
         note="neighbors: one neighbors-of answer per distinct root of the workload, checked "
              "here and not timed (the default mix sends none)")

    del g_final, pg_res, pg_cold, replayed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    def stream_build_phase():
        """(i) the smoke graph through partition_2d_streaming, every field's
        SHA-256 against partition_2d's; (ii) a symmetric RMATStream at
        --stream-scale into memmap files under build/, its push_block sized
        by stream_push_footprint, then BFS on the card with the default
        options, the static schedule and the oracle backend. Returns the
        kernels' launches of (ii)'s default run."""
        from repro_torch.core.engine import evict_from_cache
        from repro_torch.kernels.csr_gather_reduce.ops import SRC16_LIMIT

        t0 = time.perf_counter()
        gc.collect()
        t = time.perf_counter()
        with RssPeak() as rss_i:
            ps = partition_2d_streaming(coo_edge_chunks(g), g.num_vertices, PartitionConfig(**CFG))
        build_i = time.perf_counter() - t
        digests = field_digests(ps)
        differ = [k for k in IDENTITY_FIELDS if digests[k] != pg_digests[k]]
        scalars = {k: getattr(ps, k) for k in pg_scalars}
        check(not differ and scalars == pg_scalars,
              f"stream_build (i): fields {differ} or scalars {scalars} differ from partition_2d's")
        del ps
        gc.collect()
        smoke_graph = dict(scale=scale, edges=n_edges, build_seconds=build_i,
                           partition_2d_build_seconds=partition_s, rss=rss_i.report(),
                           partition_2d_rss=partition_rss.report(), fields_identical=True,
                           sha256={k: v[:16] if v else None for k, v in digests.items()})

        # (ii) the child's build, started after `build`: joined here
        t = time.perf_counter()
        stream_proc.join(STREAM_JOIN_TIMEOUT_S)
        join_wait_s = time.perf_counter() - t
        check(stream_proc.exitcode == 0,
              f"stream_build (ii): the build child exited with {stream_proc.exitcode}")
        pm, meta = load_stream_partition(stream_dir)
        mdir = stream_dir / "memmap"
        foot, foot_s, best = meta["push_footprint"], meta["push_footprint_seconds"], meta["best"]
        cfg_ii, build_ii, nv = meta["config"], meta["build_seconds"], meta["vertices"]
        rep_ii = pm.memory_report()
        gathered = pm.p * pm.sub_size
        check(isinstance(pm.tile_word, np.memmap), "stream_build (ii): not memmap-backed")
        check(pm.num_edges == meta["stream_edges"], f"stream_build (ii): {pm.num_edges} edges")
        check(pm.src_bits == (32 if gathered > SRC16_LIMIT else 16),
              f"stream_build (ii): src_bits {pm.src_bits} at p * sub_size = {gathered}")
        if not rehearsal:
            check(pm.src_bits == 32, f"stream_build (ii): src_bits {pm.src_bits}, not 32")
        push_bytes = sum(rep_ii["device"].get(k, 0) for k in ("push_word", "push_word_hi"))
        check(push_bytes == best["word_bytes"]
              and list(pm.push_word.shape) == best["shape"],
              f"stream_build (ii): push stream {list(pm.push_word.shape)} / {push_bytes} B, "
              f"stream_push_footprint said {best['shape']} / {best['word_bytes']} B")
        g_ii = G.COOGraph(src=np.zeros(0, np.uint32), dst=np.zeros(0, np.uint32),
                          num_vertices=nv)  # BFS's labels need only the vertex count
        runs_ii = {}
        for label, opts in (("default", EngineOptions()),
                            ("static", EngineOptions(dynamic_tile_skip=False)),
                            ("oracle", EngineOptions(backend="oracle"))):
            make_iteration(bfs(0), pm, opts, device=dev)  # upload (set-up)
            labels = prepare_labels(bfs(0), g_ii, pm, device=dev)
            sync()
            K.reset_launch_counts()
            S.reset_launch_counts()
            t = time.perf_counter()
            res = run(bfs(0), g_ii, pm, opts, labels=labels, device=dev)
            sync()
            sec = time.perf_counter() - t
            check(res.converged, f"stream_build (ii) bfs {label}: did not converge")
            runs_ii[label] = (res, dict(iterations=res.iterations, run_seconds=sec,
                                        mteps=pm.num_edges / sec / 1e6,
                                        reached=int((res.labels["label"] != 0xFFFFFFFF).sum()),
                                        launches={"gather_reduce_cores": dict(K.LAUNCHES),
                                                  "scatter_reduce_cores": dict(S.LAUNCHES)}))
        a, b, o = (runs_ii[k][0] for k in ("default", "static", "oracle"))
        check(a.iterations == b.iterations
              and np.array_equal(a.labels["label"], b.labels["label"]),
              "stream_build (ii): the default BFS differs from the static schedule's")
        check(a.iterations == o.iterations
              and np.array_equal(a.labels["label"], o.labels["label"]),
              "stream_build (ii): the default BFS differs from the oracle backend's")
        launches_ii = runs_ii["default"][1]["launches"]
        if not rehearsal:
            check(sum(launches_ii["gather_reduce_cores"].values())
                  + sum(launches_ii["scatter_reduce_cores"].values())
                  == a.iterations * pm.l,
                  f"stream_build (ii): launches {launches_ii} != iterations * l")
        emit("stream_build", t0, smoke_graph=smoke_graph,
             rmat=dict(scale=st_scale, edge_factor=16, seed=SEED, symmetric=True,
                       chunk_edges=meta["chunk_edges"], vertices=nv, edges=pm.num_edges,
                       gathered=gathered, src_bits=pm.src_bits, push_src_bits=pm.push_src_bits,
                       config=cfg_ii, push_footprint=foot, push_footprint_seconds=foot_s,
                       push_stream_bytes=push_bytes, build_seconds=build_ii,
                       rss=meta["rss"], memmap_dir=str(mdir.relative_to(ROOT)),
                       child=dict(started_s_before_join=time.perf_counter() - stream_started,
                                  join_wait_s=join_wait_s, pid=meta["pid"]),
                       device_bytes=rep_ii["device"], device_total_bytes=rep_ii["device_total_bytes"],
                       device_bytes_per_edge=rep_ii["device_bytes_per_edge"],
                       host_flat_total_bytes=rep_ii["host_flat_total_bytes"],
                       tile_word_shape=list(pm.tile_word.shape),
                       push_word_shape=list(pm.push_word.shape), split_rows=pm.split_rows,
                       bfs={k: v[1] for k, v in runs_ii.items()}, labels_bit_equal=True,
                       oracle_labels_bit_equal=True),
             note="smoke_graph: partition_2d_streaming(coo_edge_chunks(g)) in RAM, every "
                  "IDENTITY_FIELDS array's SHA-256 (dtype, shape, bytes) and the scalars equal "
                  "to partition_2d's (sha256: the first 16 hex digits); rss: the process's "
                  "VmRSS (/proc/self/status) sampled every 5 ms, its peak less its value at "
                  "entry (a memmap build's written file pages count); "
                  "rmat: the push_block of STREAM_PUSH_BLOCKS whose stacked words and coverage "
                  "are least, the build into memmap files, BFS from 0 with the default options "
                  "(launches counted), the static schedule and the oracle backend (the flat "
                  "bucket arrays, no packed word), labels and iterations bit-equal; mteps: "
                  "edges over run seconds, label init apart (the oracle's launches are zero)")
        evict_from_cache(pm)
        del pm, runs_ii, a, b, o
        gc.collect()
        shutil.rmtree(stream_dir, ignore_errors=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return launches_ii

    stream_launches = stream_build_phase()

    # -- GAT's segment softmax: the kernel against its plain version ----------
    from repro_torch.data.synthetic import batched_molecules, graph_batch_from_coo
    from repro_torch.models.gnn import archs as gnn_archs
    from repro_torch.models.gnn.common import softmax_tiles
    from repro_torch.train import steps as train_steps
    from repro_torch.train.optim import AdamWConfig, tree_flatten, tree_map

    def cora_batch(d_feat, n_classes):
        """The full_graph_sm cell uncut: 4096 nodes, 16,384 edge slots (the
        seeded graph's edges, the rest masked), d_feat, n_classes."""
        dims = get_arch("gat-cora").shape("full_graph_sm").dims
        n, slots = dims["n_nodes"], dims["n_edges"]
        gc_ = G.symmetrize(G.rmat(12, 2, seed=SEED))
        check(gc_.num_vertices == n and gc_.num_edges <= slots,
              f"Cora-shape graph: {gc_.num_vertices} nodes, {gc_.num_edges} edges")
        pad = slots - gc_.num_edges
        src = np.concatenate([gc_.src, np.zeros(pad, gc_.src.dtype)])
        dst = np.concatenate([gc_.dst, np.zeros(pad, gc_.dst.dtype)])
        b, lab = graph_batch_from_coo(src, dst, n, d_feat, seed=SEED, n_classes=n_classes)
        mask = torch.from_numpy(np.arange(slots) < gc_.num_edges)
        return dataclasses.replace(b, edge_mask=mask).to(dev), lab, gc_.num_edges

    def gat_params(cfg, d_in, d_out, seed):
        """Seeded parameters with non-zero attention vectors (the reference
        starts them at zero, which makes every softmax uniform)."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        p = gnn_archs.init(cfg, d_in, d_out, gen, dev)
        for k in ("l1_asrc", "l1_adst", "l2_asrc", "l2_adst"):
            p[k] = torch.randn(p[k].shape, generator=gen, device=dev) * 0.5
        return p

    @contextlib.contextmanager
    def plain_softmax():
        """Swap the softmax kernel for its plain version (a reference run)."""
        kernel_fn = SK.segment_softmax_tiles
        SK.segment_softmax_tiles = lambda s, d, v, vb: SK.segment_softmax_tiles_plain(
            s, d, v, vb=vb)
        try:
            yield
        finally:
            SK.segment_softmax_tiles = kernel_fn

    gat_cfg = get_arch("gat-cora").model  # published width: 2 layers, 8 heads x 8
    heads = gat_cfg.n_heads
    t0 = time.perf_counter()
    cora, cora_lab, cora_edges = cora_batch(1433 if not rehearsal else 64, 7)
    products = get_arch("gat-cora").shape("ogb_products").dims
    t = time.perf_counter()
    big, _ = graph_batch_from_coo(g.src, g.dst, g.num_vertices, products["d_feat"], seed=SEED,
                                  n_classes=products["n_classes"])
    big = big.to(dev)
    big_gen_s = time.perf_counter() - t
    sm_rows, sm_err = {}, 0.0
    for label, b in (("a_cora_layer1", cora), ("b_smoke_graph", big)):
        dt = softmax_tiles(b)
        host = b.__dict__["_softmax_host"]
        shape = tuple(dt.dstb.shape)
        srng = np.random.default_rng(SEED + 7)
        scores = torch.from_numpy(((srng.random((heads,) + shape, dtype=np.float32) - 0.5)
                                   * 8)).to(dev)
        sync()
        got = SK.segment_softmax_tiles(scores, dt.dstb, dt.valid, vb=dt.vb)
        want = SK.segment_softmax_tiles_plain(scores, dt.dstb, dt.valid, vb=dt.vb)
        again = SK.segment_softmax_tiles(scores, dt.dstb, dt.valid, vb=dt.vb)
        sync()
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, **SOFTMAX_TOL),
              f"softmax {label}: kernel disagrees with plain version (max err {err})")
        check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
              f"softmax {label}: two launches gave different bits")
        sm_err = max(sm_err, err)
        n_slots = int(dt.valid.numel())
        n_valid = int(dt.valid.sum())
        reps = 2 if rehearsal else 20
        row = dict(heads=heads, rows_per_block=dt.vb, r_blocks=shape[0], tiles=shape[1],
                   slots_per_tile=shape[2], slots=n_slots, valid_slots=n_valid,
                   padding_share=host.padding_share, layout_build_seconds=host.build_seconds,
                   max_abs_err=err)
        row.update(kernel_ms(lambda: SK.segment_softmax_tiles(scores, dt.dstb, dt.valid,
                                                              vb=dt.vb),
                             reps, 1, "segment_softmax_kernel"))
        row["plain_ms"] = device_ms(lambda: SK.segment_softmax_tiles_plain(
            scores, dt.dstb, dt.valid, vb=dt.vb), max(1, reps // 5), 1)
        # scores read and weights written once per head, dstb and valid once;
        # 7 float operations per valid slot and head (max, 2 sub, 2 exp, add, div)
        nbytes = heads * n_slots * 8 + n_slots * 5
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 7 * heads * n_valid / F32_OPS_PER_S * 1e3
        row.update(bound_ms=max(bytes_ms, ops_ms), bound_bytes=nbytes,
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations", library_ms=None)
        # the design reads the scores in both sweeps and writes the weights
        # once; dstb and valid once a sweep (the other heads' blocks find them
        # in L2)
        design = n_slots * (12 * heads + 10)
        row.update(bytes_per_slot_design=12 * heads + 10, bytes_per_slot_bound=8 * heads + 5,
                   gbps_design=design / row["ms"] / 1e6, gbps_bound=nbytes / row["ms"] / 1e6)
        sm_rows[label] = row
        del scores, got, want, again
    emit("softmax_kernel", t0, per_launch=sm_rows, max_abs_err=sm_err, tolerance=SOFTMAX_TOL,
         profiler_probe_events=profiler_probe(),
         smoke_graph_generation_seconds=big_gen_s,
         note="(a) GAT layer 1 at the Cora shape (full_graph_sm, 16,384 slots, H = 8); (b) "
              "the smoke graph as one GAT layout, H = 8; seeded scores in (-4, 4); ms: CUDA "
              "events around 20 back-to-back launches, the stream held while the host "
              "enqueues them (profiler_ms: the mean of the kernel's profiler events over as "
              "many launches, events_seen of events_expected); plain_ms: the same for the "
              "plain version, host gaps after its syncs included; bound: "
              "scores read and weights written once per head, dstb and valid read once, at "
              "3.35 TB/s; padding_share: slots no edge fills (the layout has no tile counts, "
              "so the kernel reads them); bytes_per_slot_design: scores read in both sweeps and "
              "weights written once per head, dstb and valid once a sweep (12 H + 10), against "
              "the bound's 8 H + 5; gbps_*: those bytes over ms; no single PyTorch call computes "
              "a segment softmax (library_ms null)")

    # GraphSAGE's neighbor sampler over the smoke graph: gnn's minibatch_lg
    # step and recovery (b)
    from repro_torch.data.neighbor_sampler import NeighborSampler

    sage_dims = get_arch("graphsage").shape("minibatch_lg").dims
    sage_batch_nodes = sage_dims["batch_nodes"] // (64 if rehearsal else 1)
    t = time.perf_counter()
    sampler = NeighborSampler(g, fanouts=(sage_dims["fanout1"], sage_dims["fanout2"]),
                              d_feat=sage_dims["d_feat"])
    sampler_build_s = time.perf_counter() - t

    # -- GNNs at published width: GAT training and inference, one step of each other arch
    def gnn_phase():
        """gat-cora: 50 train steps on the Cora shape, launches counted, and
        inference on the smoke graph at ogbn-products' widths; then one train
        step of each other arch on its cell. Returns the softmax launches."""
        t0 = time.perf_counter()
        n_steps = 3 if rehearsal else 50
        ocfg = AdamWConfig(lr=1e-3, total_steps=n_steps, warmup_steps=min(20, n_steps))
        d_in = cora.node_feat.shape[1]
        params = gat_params(gat_cfg, d_in, 7, SEED)
        labels = torch.from_numpy(cora_lab).to(dev)
        loss_fn = train_steps.make_gnn_loss(gat_cfg, "node_class")
        # the first step's loss and grads against a run with the plain softmax
        loss_k, grads_k = train_steps.value_and_grad(loss_fn, params, cora, labels)
        with plain_softmax():
            loss_p, grads_p = train_steps.value_and_grad(loss_fn, params, cora, labels)
        gk, gp = tree_flatten(grads_k)[0], tree_flatten(grads_p)[0]
        grad_err = max(float((a - b).abs().max()) for a, b in zip(gk, gp))
        check(torch.allclose(loss_k, loss_p, **GNN_TOL)
              and all(torch.allclose(a, b, **GNN_TOL) for a, b in zip(gk, gp)),
              f"gat first step: kernel vs plain softmax loss {float(loss_k)} / "
              f"{float(loss_p)}, max grad diff {grad_err}")
        step = train_steps.make_gnn_train_step(gat_cfg, ocfg, task="node_class")
        state = train_steps.init_train_state(params, ocfg)
        state, _ = step(state, cora, labels)  # warm (not counted)
        state = train_steps.init_train_state(params, ocfg)
        sync()
        SK.reset_launch_counts()
        lat, losses = [], []
        t_all = time.perf_counter()
        for _ in range(n_steps):
            t = time.perf_counter()
            state, m = step(state, cora, labels)
            losses.append(float(m["loss"]))  # waits for the step
            lat.append((time.perf_counter() - t) * 1e3)
        wall = time.perf_counter() - t_all
        train_launches = dict(SK.LAUNCHES)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"gat train: loss did not fall ({losses[0]} -> {losses[-1]})")
        if not rehearsal:
            check(train_launches == {"f32": 2 * n_steps},
                  f"gat train: softmax launches {train_launches} != 2 x {n_steps} steps")
        wall_us, evs = profiled(lambda: step(state, cora, labels))
        dev_us = sum(event_us(e) for e in evs)
        train = dict(steps=n_steps, ms_per_step=dict(median=float(np.median(lat)),
                                                     min=min(lat), max=max(lat)),
                     steps_per_s=n_steps / wall, loss_first=losses[0], loss_last=losses[-1],
                     first_step_loss=[float(loss_k), float(loss_p)],
                     first_step_max_grad_diff=grad_err, launches=train_launches,
                     profiled_step=dict(wall_us=wall_us, device_busy_us=dev_us,
                                        device_idle_share=1.0 - dev_us / wall_us,
                                        device_events=sum(e.count for e in evs),
                                        softmax_events=[sum(e.count for e in evs
                                                            if "segment_softmax" in e.key), 2],
                                        softmax_us=sum(event_us(e) for e in evs
                                                       if "segment_softmax" in e.key)),
                     real_edges=cora_edges, edge_slots=cora.num_edges, d_feat=d_in)
        del state, params, grads_k, grads_p
        # inference on the smoke graph at ogbn-products' widths (d_feat 100, 47 classes)
        infer = train_steps.make_gnn_infer(gat_cfg)
        iparams = gat_params(gat_cfg, products["d_feat"], products["n_classes"], SEED + 1)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        out = infer(iparams, big)
        sync()
        check(out.shape == (big.num_nodes, products["n_classes"])
              and bool(torch.isfinite(out).all()), "gat infer: non-finite or misshapen output")
        with plain_softmax():
            out_p = infer(iparams, big)
        sync()
        infer_err = float((out - out_p).abs().max())
        check(torch.allclose(out, out_p, rtol=1e-4, atol=1e-4),
              f"gat infer: kernel vs plain softmax max diff {infer_err}")
        del out_p
        n_fwd = 2 if rehearsal else 5
        SK.reset_launch_counts()
        lat = []
        for _ in range(n_fwd):
            t = time.perf_counter()
            out = infer(iparams, big)
            sync()
            lat.append((time.perf_counter() - t) * 1e3)
        infer_launches = dict(SK.LAUNCHES)
        if not rehearsal:
            check(infer_launches == {"f32": 2 * n_fwd},
                  f"gat infer: softmax launches {infer_launches} != 2 x {n_fwd} forwards")
        wall_us, evs = profiled(lambda: infer(iparams, big))
        dev_us = sum(event_us(e) for e in evs)
        top = sorted(evs, key=event_us, reverse=True)[:6]
        med = float(np.median(lat))
        inference = dict(
            nodes=big.num_nodes, edges=big.num_edges, d_feat=products["d_feat"],
            classes=products["n_classes"], forwards=n_fwd,
            ms_per_forward=dict(median=med, min=min(lat), max=max(lat)),
            edges_per_s=big.num_edges / med * 1e3, max_abs_diff_vs_plain=infer_err,
            launches=infer_launches,
            peak_memory_bytes=torch.cuda.max_memory_allocated() if dev.type == "cuda" else None,
            profiled_forward=dict(wall_us=wall_us, device_busy_us=dev_us,
                                  device_idle_share=1.0 - dev_us / wall_us,
                                  device_events=sum(e.count for e in evs),
                                  softmax_events=[sum(e.count for e in evs
                                                      if "segment_softmax" in e.key), 2],
                                  softmax_us=sum(event_us(e) for e in evs
                                                 if "segment_softmax" in e.key),
                                  top_device_us={e.key[:80]: [event_us(e), e.count]
                                                 for e in top}))
        del out, iparams
        # one train step at published width for each other arch, on its cell
        others = {}
        for arch_id, cell in (("gcn-cora", "full_graph_sm"), ("graphsage", "minibatch_lg"),
                              ("schnet", "full_graph_sm"), ("meshgraphnet", "full_graph_sm"),
                              ("gin-tu", "molecule")):
            arch = get_arch(arch_id)
            cfg = arch.smoke() if rehearsal else arch.model
            dims = arch.shape(cell).dims
            loss_nodes, task = None, arch.gnn_task
            if cell == "molecule":
                b, lab = batched_molecules(SEED, dims["n_graphs"], dims["nodes_per"],
                                           dims["edges_per"], dims["d_feat"], dims["n_classes"])
                b, task = b.to(dev), "graph_class"
                out_dim = dims["n_classes"]
            elif cell == "minibatch_lg":  # a sampled batch of the smoke graph
                b, lab = sampler.sample(SEED, 0, sage_batch_nodes)
                b, loss_nodes = b.to(dev), sage_batch_nodes
                out_dim = dims["n_classes"]
            else:
                b = cora
                out_dim = dims["n_classes"] if task.endswith("class") else arch.gnn_out_dim
                lab = cora_lab
            if task == "node_reg":
                lab = np.random.default_rng(SEED + 11).standard_normal(
                    (b.num_nodes, out_dim)).astype(np.float32)
            d_in = b.node_feat.shape[1]
            gen = torch.Generator(device=dev).manual_seed(SEED)
            st = train_steps.init_train_state(gnn_archs.init(cfg, d_in, out_dim, gen, dev), ocfg)
            stp = train_steps.make_gnn_train_step(cfg, ocfg, task=task, loss_nodes=loss_nodes)
            lab_t = torch.from_numpy(lab).to(dev)
            sync()
            t = time.perf_counter()
            st, m = stp(st, b, lab_t)
            loss = float(m["loss"])
            ms = (time.perf_counter() - t) * 1e3
            check(np.isfinite(loss), f"{arch_id} on {cell}: loss {loss}")
            others[arch_id] = dict(cell=cell, task=task, loss=loss, first_step_ms=ms,
                                   nodes=b.num_nodes, edges=b.num_edges, d_feat=d_in,
                                   out_dim=out_dim, config=dataclasses.asdict(cfg) | {
                                       "dtype": str(cfg.dtype)})
            del st, stp
        emit("gnn", t0, config=dataclasses.asdict(gat_cfg) | {"dtype": str(gat_cfg.dtype)},
             train=train, infer=inference, other_archs=others, tolerance=GNN_TOL,
             note="train: gat-cora at published width on full_graph_sm uncut (Cora-shape "
                  "graph symmetrize(rmat(12, 2, seed=0)), padded to 16,384 masked slots), "
                  "AdamW lr 1e-3 as the CLI, host clock per step ending in a read of the loss; "
                  "steps_per_s over the wall of all timed steps; infer: the smoke graph's COO "
                  "(ogbn-products cut to 1,048,576 nodes / 31,403,850 edges) at d_feat 100, "
                  "47 classes; profiled_*: one step or forward under torch.profiler, device "
                  "events only (softmax_events: the softmax kernel's events seen, of 2 launched; "
                  "the profiler can miss events late in this run, so busy time is a floor); "
                  "other archs: one step at published width from a fresh state "
                  "(its first step, so it includes first-call costs)")
        return {"f32": train_launches.get("f32", 0) + infer_launches.get("f32", 0)}

    softmax_launches = gnn_phase()

    # the GNN tensors go before the LM phases
    del cora, cora_lab, big
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- training infrastructure: checkpoints, kill-and-resume, elastic restore --
    from repro_torch.core.engine import unpad_labels
    from repro_torch.data.pipeline import ShardedLoader, prefetch
    from repro_torch.dist.checkpoint import latest_step, restore_checkpoint, save_checkpoint
    from repro_torch.dist.compression import int8_compress, topk_sparsify
    from repro_torch.dist.fault_tolerance import CheckpointPolicy, StepMonitor, run_with_recovery

    class InjectedFault(RuntimeError):
        """recovery (b)'s marked transient failure."""

    def dir_bytes(path):
        return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())

    def same_bits(a, b):
        return (a.dtype == b.dtype and a.shape == b.shape
                and bool(torch.equal(a.cpu().reshape(-1).view(torch.uint8),
                                    b.cpu().reshape(-1).view(torch.uint8))))

    def recovery_pagerank(root):
        """(a) PageRank through make_iteration under run_with_recovery on the
        smoke partition (read back from the distributed phase's files): 40
        steps, then a run stopped at 20 and resumed from 15; bit-equal
        labels; checkpoint bytes, save and restore seconds, #1's launches."""
        where = ROOT / "build" / "distributed"
        t = time.perf_counter()
        pg_r, g_r = load_partition(where)
        prob = pagerank(tol=0.0)  # fixed-step power iteration
        iteration = make_iteration(prob, pg_r, EngineOptions(), dev)
        set_up_s = time.perf_counter() - t

        def init():
            return prepare_labels(prob, g_r, pg_r, dev)

        def step_fn(state, i):
            return iteration(state), {}

        n, every, stop = PR_RESUME["steps"], PR_RESUME["every"], PR_RESUME["stop"]
        sync()
        K.reset_launch_counts()
        t = time.perf_counter()
        final_a, _ = run_with_recovery(step_fn, init, n, CheckpointPolicy(str(root / "pr_a"), every))
        sync()
        whole_s = time.perf_counter() - t
        pol_b = CheckpointPolicy(str(root / "pr_b"), every_steps=every)
        run_with_recovery(step_fn, init, stop, pol_b)  # 'preempted' after `stop` steps
        resumed_from = latest_step(pol_b.directory)
        check(resumed_from == every, f"recovery (a): newest checkpoint {resumed_from}, not {every}")
        t = time.perf_counter()
        final_b, _ = run_with_recovery(step_fn, init, n, pol_b)
        sync()
        resume_s = time.perf_counter() - t
        launches = dict(K.LAUNCHES)
        a, b = unpad_labels(final_a, pg_r)["label"], unpad_labels(final_b, pg_r)["label"]
        check(a.tobytes() == b.tobytes(), "recovery (a): resumed PageRank labels differ from "
              f"the uninterrupted run's (max diff {float(np.abs(a - b).max())})")
        want = (n + stop + n - every) * pg_r.l
        if not rehearsal:
            check(launches == {"sum_f32": want}, f"recovery (a): launches {launches} != {want}")
        like = init()
        sync()
        t = time.perf_counter()
        path = save_checkpoint(str(root / "pr_timing"), n, final_b, meta={"next_step": n})
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        restored, _ = restore_checkpoint(str(root / "pr_timing"), like)
        sync()
        restore_s = time.perf_counter() - t
        check(all(same_bits(restored[k], final_b[k]) for k in final_b),
              "recovery (a): restored labels differ from the saved ones")
        out = dict(vertices=g_r.num_vertices, edges=pg_r.num_edges, p=pg_r.p, l=pg_r.l,
                   steps=n, every=every, stopped_at=stop, resumed_from=resumed_from,
                   labels_bit_equal=True, launches=launches, launches_expected=want,
                   set_up_seconds=set_up_s, whole_run_seconds=whole_s,
                   resumed_run_seconds=resume_s, checkpoint_bytes=dir_bytes(path),
                   label_leaves={k: [list(v.shape), str(v.dtype)] for k, v in final_b.items()},
                   save_seconds=save_s, restore_seconds=restore_s,
                   rank_sum=float(a.sum()))
        del pg_r, g_r, iteration, final_a, final_b, restored, like
        shutil.rmtree(where, ignore_errors=True)
        return out

    def recovery_graphsage(root):
        """(b) GraphSAGE at published width on NeighborSampler batches of the
        smoke graph through ShardedLoader (+ prefetch) under
        run_with_recovery: one marked failure injected, retried once; a run
        stopped at 6 and resumed from 4, its restored state bit-equal to the
        saved one and its final params within GNN_TOL of the whole run's."""
        sage = get_arch("graphsage")
        scfg = sage.smoke() if rehearsal else sage.model
        dims, bn = sage_dims, sage_batch_nodes
        n, every = SAGE_RESUME["steps"], SAGE_RESUME["every"]
        ocfg = AdamWConfig(lr=1e-3, total_steps=n, warmup_steps=min(20, n))
        stp = train_steps.make_gnn_train_step(scfg, ocfg, task="node_class", loss_nodes=bn)
        host_ms = []

        def make(seed, i):
            t = time.perf_counter()
            batch = sampler.sample(seed, i, bn)
            host_ms.append((time.perf_counter() - t) * 1e3)
            return batch

        def init_state():
            gen = torch.Generator(device=dev).manual_seed(SEED)
            return train_steps.init_train_state(
                gnn_archs.init(scfg, dims["d_feat"], dims["n_classes"], gen, dev), ocfg)

        def sage_run(directory, total, depth, inject_at=None, keep_step=None):
            start = latest_step(str(directory)) or 0
            loader = ShardedLoader(make, SEED, start_step=start, device=dev)
            batches = prefetch(loader, depth) if depth else loader
            held, attempts, walls, edges, losses, kept = {}, {}, [], [], [], {}

            def step_fn(state, i):
                t = time.perf_counter()
                if held.get("i") != i:  # a retry reuses the step's batch
                    held.update(i=i, batch=next(batches))
                    check(loader.state()["next_step"] == i + 1,
                          f"recovery (b): loader cursor {loader.state()} at step {i}")
                b, lab = held["batch"]
                attempts[i] = attempts.get(i, 0) + 1
                if i == inject_at and attempts[i] == 1:
                    raise InjectedFault(f"injected at step {i}")
                state, m = stp(state, b, lab)
                loss = float(m["loss"])  # waits for the step
                walls.append((time.perf_counter() - t) * 1e3)
                check(np.isfinite(loss), f"recovery (b): loss {loss} at step {i}")
                losses.append(loss)
                edges.append(int(b.edge_mask.sum()))
                if keep_step is not None and i + 1 == keep_step:
                    kept["state"] = tree_map(lambda x: x.clone(), state)
                return state, m

            try:
                state, _ = run_with_recovery(step_fn, init_state, total,
                                             CheckpointPolicy(str(directory), every_steps=every))
            finally:
                if depth:
                    batches.close()
            return state, dict(start=start, attempts=attempts, walls=walls, edges=edges,
                               losses=losses, kept=kept.get("state"))

        state_a, run_a = sage_run(root / "sage_a", n, SAGE_RESUME["depth"],
                                  inject_at=SAGE_RESUME["inject_at"])
        retries = {i: k - 1 for i, k in run_a["attempts"].items() if k > 1}
        check(retries == {SAGE_RESUME["inject_at"]: 1},
              f"recovery (b): retries {retries}, not one at step {SAGE_RESUME['inject_at']}")
        _, run_b1 = sage_run(root / "sage_b", SAGE_RESUME["stop"], 0, keep_step=every)
        resumed_from = latest_step(str(root / "sage_b"))
        check(resumed_from == every, f"recovery (b): newest checkpoint {resumed_from}")
        restored, _ = restore_checkpoint(str(root / "sage_b"), init_state(), step=every)
        flat_r, flat_k = tree_flatten(restored)[0], tree_flatten(run_b1["kept"])[0]
        check(len(flat_r) == len(flat_k) and all(same_bits(x, y) for x, y in zip(flat_r, flat_k)),
              "recovery (b): the restored state differs from the saved one")
        state_b, run_b2 = sage_run(root / "sage_b", n, 0)
        check(run_b2["start"] == every, f"recovery (b): resumed at {run_b2['start']}")
        pa, pb = tree_flatten(state_a["params"])[0], tree_flatten(state_b["params"])[0]
        param_err = max(float((x - y).abs().max()) for x, y in zip(pa, pb))
        check(all(torch.allclose(x, y, **GNN_TOL) for x, y in zip(pa, pb)),
              f"recovery (b): resumed params differ from the whole run's by {param_err}")
        host, host_lab = sampler.sample(SEED, 0, bn)
        h2d = sum(getattr(host, f.name).numel() * getattr(host, f.name).element_size()
                  for f in dataclasses.fields(host)
                  if isinstance(getattr(host, f.name), torch.Tensor)) + host_lab.nbytes
        no_pf = run_b1["walls"][1:] + run_b2["walls"][1:]
        del state_a, state_b, restored, run_b1, flat_r, flat_k
        return dict(config=dataclasses.asdict(scfg) | {"dtype": str(scfg.dtype)},
                    batch_nodes=bn, fanouts=list(sampler.fanouts), d_feat=dims["d_feat"],
                    classes=dims["n_classes"], max_nodes=sampler.max_nodes(bn),
                    max_edges=sampler.max_edges(bn), sampled_edges=run_a["edges"],
                    steps=n, every=every, injected_at=SAGE_RESUME["inject_at"],
                    retries=retries, resumed_from=resumed_from, restored_bit_equal=True,
                    max_param_diff=param_err, losses_whole=run_a["losses"],
                    losses_resumed=run_b2["losses"],
                    ms_per_step_prefetch=dict(median=float(np.median(run_a["walls"][1:])),
                                              min=min(run_a["walls"][1:]),
                                              max=max(run_a["walls"][1:]),
                                              first=run_a["walls"][0]),
                    ms_per_step_no_prefetch=dict(median=float(np.median(no_pf)),
                                                 min=min(no_pf), max=max(no_pf),
                                                 first=run_b2["walls"][0]),
                    prefetch_depth=SAGE_RESUME["depth"],
                    sampler_host_ms=dict(median=float(np.median(host_ms)), min=min(host_ms),
                                         max=max(host_ms), batches=len(host_ms)),
                    sampler_build_seconds=sampler_build_s, h2d_bytes_per_batch=h2d)

    def recovery_cli(root):
        """(c) the trainer CLI (smollm-135m's smoke config, --ckpt) SIGKILLed
        once step 20 is saved, rerun to the end past a planted .tmp, against
        an uninterrupted run (started beside the killed one: the two share
        the card); #6's launches from both runs' final lines."""
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        if rehearsal:  # two trainers at once on the CPU: keep them off each other's cores
            env["OMP_NUM_THREADS"] = "2"
        argv = ["--arch", "smollm-135m", "--steps", str(CLI_RESUME["steps"]),
                "--ckpt-every", str(CLI_RESUME["every"]), "--batch", str(CLI_RESUME["batch"]),
                "--seq", str(CLI_RESUME["seq"])] + (["--device", "cpu"] if rehearsal else [])

        def cmd(d):
            return [sys.executable, "-m", "repro_torch.launch.train", *argv, "--ckpt", str(d)]

        killed_dir = root / "cli"
        mark = killed_dir / f"step_{CLI_RESUME['kill_at']:08d}"
        t = time.perf_counter()
        whole = subprocess.Popen(cmd(root / "cli_whole"), cwd=ROOT, env=env, text=True,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        try:  # the uninterrupted run ends with this part, whatever fails
            with open(root / "cli_killed.log", "w") as log:
                proc = subprocess.Popen(cmd(killed_dir), cwd=ROOT, env=env, stdout=log,
                                        stderr=subprocess.STDOUT)
                try:
                    deadline = time.monotonic() + 600
                    while (not mark.exists() and proc.poll() is None
                           and time.monotonic() < deadline):
                        time.sleep(0.002)
                    if proc.poll() is None:
                        proc.send_signal(signal.SIGKILL)
                finally:
                    if proc.poll() is None:
                        proc.kill()
                    proc.wait(timeout=60)
            killed_s = time.perf_counter() - t
            check(proc.returncode == -signal.SIGKILL,
                  f"recovery (c): the trainer exited {proc.returncode} before the kill: "
                  f"{(root / 'cli_killed.log').read_text()[-2000:]}")
            newest = latest_step(str(killed_dir))
            check(newest is not None and newest >= CLI_RESUME["kill_at"],
                  f"recovery (c): newest checkpoint {newest}")
            left_tmp = sorted(x for x in os.listdir(killed_dir) if x.endswith(".tmp"))
            stale = killed_dir / f"step_{newest + CLI_RESUME['every']:08d}.tmp"
            stale.mkdir(exist_ok=True)  # as a save killed mid-write leaves it
            (stale / "manifest.json").write_text("{")
            t = time.perf_counter()
            rerun = subprocess.run(cmd(killed_dir), cwd=ROOT, env=env, capture_output=True,
                                   text=True, timeout=900)
            rerun_s = time.perf_counter() - t
            w_out, w_err = whole.communicate(timeout=900)
        finally:
            if whole.poll() is None:
                whole.kill()
                whole.wait(timeout=60)
        runs = {}
        for name, code, out_, err_, secs in (
                ("rerun", rerun.returncode, rerun.stdout, rerun.stderr, rerun_s),
                ("whole", whole.returncode, w_out, w_err, None)):
            check(code == 0, f"recovery (c): {name} failed: {err_[-3000:]}")
            last = out_.strip().splitlines()[-1]
            runs[name] = dict(seconds=secs, resume=out_.splitlines()[0],
                              last_loss=last.split("last loss ")[1].split(";")[0],
                              launches=json.loads(last.split("launches ")[1]))
        check(runs["rerun"]["resume"].startswith(f"resume: step {newest} under"),
              f"recovery (c): the rerun says {runs['rerun']['resume']!r}, newest is {newest}")
        check(not any(x.endswith(".tmp") for x in os.listdir(killed_dir)),
              "recovery (c): a .tmp survived the rerun")
        a, b = float(runs["rerun"]["last_loss"]), float(runs["whole"]["last_loss"])
        rel = abs(a - b) / abs(b)
        check(rel <= CLI_LOSS_REL, f"recovery (c): final loss {a} vs {b} (rel {rel})")
        flash = sum(sum(r["launches"].get("flash_attention", {}).values()) for r in runs.values())
        if not rehearsal:
            check(flash > 0, "recovery (c): the trainer launched no flash kernel")
        return dict(steps=CLI_RESUME["steps"], every=CLI_RESUME["every"],
                    killed_after_step_dir=mark.name, killed_seconds=killed_s,
                    newest_at_kill=newest, tmp_left_by_kill=left_tmp, planted_tmp=stale.name,
                    runs=runs, rel_diff=rel, bits_match=a == b and runs["rerun"]["last_loss"]
                    == runs["whole"]["last_loss"], flash_launches=flash)

    def recovery_elastic(root):
        """(d) the TINY LM data-parallel in ranks sharing the card over gloo:
        3 steps at 2 ranks with int8 error-feedback sync and a save, a
        replicated restore at 4 ranks through shardings, 3 more steps; int8
        and top-k on the card bit-equal to the CPU's."""
        spec = dict(dir=str(root / "elastic"), device=dev.type, cfg=ELASTIC_LM,
                    steps=ELASTIC["steps"], seq=ELASTIC["seq"])
        outs = {}
        for phase_, world in (("before", ELASTIC["before"]), ("after", ELASTIC["after"])):
            t = time.perf_counter()
            got = spawn_ranks(recovery_rank, world, (spec,), backend="gloo",
                              timeout=DIST_TIMEOUT_S, init_dir=root)
            outs[phase_] = dict(seconds=time.perf_counter() - t, ranks=got)
            check(all(o["losses"] == got[0]["losses"] for o in got),
                  f"recovery (d): ranks disagree on the loss at {world} ranks")
        before, after = outs["before"]["ranks"][0], outs["after"]["ranks"][0]
        check(before["step"] == ELASTIC["steps"] and after["start"] == ELASTIC["steps"]
              and after["step"] == 2 * ELASTIC["steps"],
              f"recovery (d): steps {before['step']} -> {after['start']}..{after['step']}")
        check(all(np.isfinite(after["losses"])), f"recovery (d): loss {after['losses']}")
        crng = np.random.default_rng(SEED + 13)
        cases = [crng.standard_normal(1 << 20).astype(np.float32),
                 (crng.integers(-40, 40, 4096) / 2.0).astype(np.float32),
                 np.repeat(crng.standard_normal(64).astype(np.float32), 16)]
        for x in cases:
            cpu, on_dev = torch.from_numpy(x), torch.from_numpy(x).to(dev)
            (qc, sc), (qd, sd) = int8_compress(cpu), int8_compress(on_dev)
            check(same_bits(qd, qc) and same_bits(sd, sc), "recovery (d): int8 on the card "
                  "differs from the CPU's")
            for frac in (0.1, 0.01):
                (vc, mc), (vd, md) = topk_sparsify(cpu, frac), topk_sparsify(on_dev, frac)
                check(same_bits(vd, vc) and torch.equal(md.cpu(), mc),
                      f"recovery (d): top-k at {frac} on the card differs from the CPU's")
        flash = sum(sum(o["flash_launches"].values())
                    for v in outs.values() for o in v["ranks"])
        return dict(model=ELASTIC_LM, worlds=[ELASTIC["before"], ELASTIC["after"]],
                    steps_each=ELASTIC["steps"], transport=before["transport"],
                    losses_before=before["losses"], losses_after=after["losses"],
                    restore_seconds=[o["restore_seconds"] for o in outs["after"]["ranks"]],
                    spawn_seconds=[outs["before"]["seconds"], outs["after"]["seconds"]],
                    sync_wire_bytes=before["sync_wire_bytes"],
                    sync_fp32_bytes=before["sync_fp32_bytes"],
                    wire_share=before["sync_wire_bytes"] / before["sync_fp32_bytes"],
                    compression_cuda_bit_equal_to_cpu=True, flash_launches=flash)

    def recovery_phase():
        t0 = time.perf_counter()
        root = ROOT / "build" / "recovery"
        shutil.rmtree(root, ignore_errors=True)
        root.mkdir(parents=True)
        parts = {}

        def part(name, fn):
            t = time.perf_counter()
            parts[name] = fn(root)
            emit(f"recovery_{name}", t, **parts[name])
            parts[name]["seconds"] = time.perf_counter() - t

        for name, fn in (("pagerank", recovery_pagerank), ("graphsage", recovery_graphsage)):
            part(name, fn)
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        # (c) and (d) are processes that mostly start up: they run side by side
        with ThreadPoolExecutor(1) as pool:
            elastic = pool.submit(part, "elastic", recovery_elastic)
            part("trainer_cli", recovery_cli)
            elastic.result()
        shutil.rmtree(root, ignore_errors=True)
        emit("recovery", t0, **parts, tolerance=GNN_TOL, cli_loss_rel=CLI_LOSS_REL,
             note="(a) pagerank(tol=0.0) through make_iteration under run_with_recovery "
                  "(every 15): 40 steps, then 20 and a resume from 15, on the smoke "
                  "partition read back from the distributed phase's .npy files; labels bit "
                  "for bit; save/restore: the label tree once more, timed on the host clock "
                  "(restore synchronized). (b) graphsage at published width on minibatch_lg "
                  "(1,024 seeds, fanouts 15-10, d_feat 602, 41 classes), NeighborSampler "
                  "batches of the smoke graph through ShardedLoader: 12 steps (every 4) "
                  "with prefetch(depth 2) and one InjectedFault at step 2, then without "
                  "prefetch 6 steps and a resume from 4 to 12; ms a step: host clock from "
                  "the step's batch fetch to its loss read, the first step of each run "
                  "apart; the sampler's host ms a batch; H2D bytes: the batch's tensors "
                  "and labels. (c) python -m repro_torch.launch.train --arch smollm-135m "
                  "--steps 40 --ckpt-every 10, SIGKILLed once step_00000020 exists, rerun "
                  "past a planted .tmp, against an uninterrupted run. (d) the TINY LM at 2 "
                  "gloo ranks on this card (int8 error feedback) then 4 ranks restored "
                  "through shardings; wire bytes: what one rank sends a sync (int8 "
                  "payload and scales) against float32 gradients")
        return dict(gather=parts["pagerank"]["launches"],
                    flash_f32=parts["trainer_cli"]["flash_launches"]
                    + parts["elastic"]["flash_launches"])

    recovery_launches = recovery_phase()
    del sampler

    # -- the flash-attention kernel against its plain version and the oracle ---
    import torch.nn.functional as TF

    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels.flash_attention import gqa_attention_reference
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import transformer as tfm

    flash_blocks = tfm.FLASH_BLOCKS

    def sass_tensor_ops():
        """HMMA / HGMMA instructions in each flash kernel's SASS (``cuobjdump
        -sass`` of the built library): the bf16 kernel's products run on the
        tensor cores, the float32 kernel's on the FMA units."""
        if rehearsal:
            return None
        path, _ = build_library(FK.SOURCE)
        sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(path)], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        counts, fn = {}, None
        for ln in sass.splitlines():
            if "Function :" in ln:
                fn = next((t for t in ("bf16", "f32") if f"flash_attention_kernel_{t}" in ln),
                          None)
                if fn:
                    counts.setdefault(fn, dict(functions=0, HMMA=0, HGMMA=0))["functions"] += 1
            elif fn and "HGMMA" in ln:
                counts[fn]["HGMMA"] += 1
            elif fn and "HMMA" in ln:
                counts[fn]["HMMA"] += 1
        bf16 = counts.get("bf16", {})
        check(bf16.get("HMMA", 0) + bf16.get("HGMMA", 0) > 0,
              f"flash: no tensor-core instruction in the bf16 kernel's SASS ({counts})")
        return counts

    def flash_phase():
        """The kernel at six shapes: (a) smollm-135m's layer at prefill_32k's
        S, (b) llama3-8b's at S = 4096, (c) (a)'s widths at S = 4096 in
        float32, (d) the train step's layer (smollm-135m, B = 4, S = 4096);
        in float32 at the shapes recovery's paths gave it: (e) the trainer
        CLI's (smollm-135m's smoke config), (f) an elastic rank's (TINY)."""
        t0 = time.perf_counter()
        smollm = get_arch("smollm-135m")
        # (config, batch, S, input type, S cut in the CPU rehearsal)
        shapes = {"a_smollm_prefill_32k": (smollm.model, 1, 32768, torch.bfloat16, True),
                  "b_llama3_8b_4k": (get_arch("llama3-8b").model, 1, 4096, torch.bfloat16, True),
                  "c_smollm_4k_f32": (smollm.model, 1, 4096, torch.float32, True),
                  "d_smollm_train_4k": (smollm.model, LM_TRAIN_BATCH, 4096, torch.bfloat16,
                                        True),
                  "e_cli_trainer_f32": (smollm.smoke(), CLI_RESUME["batch"], CLI_RESUME["seq"],
                                        torch.float32, False),
                  "f_elastic_rank_f32": (tfm.LMConfig(**ELASTIC_LM, dtype=torch.float32), 1,
                                         ELASTIC["seq"], torch.float32, False)}
        rows, worst = {}, 0.0
        reps = 2 if rehearsal else FLASH_REPS
        for label, (m, bsz, s, dtype, cut) in shapes.items():
            hq, hkv, d = m.n_heads, m.n_kv_heads, m.hd
            if rehearsal and cut:
                s = s // 64
            gen = torch.Generator(device=dev).manual_seed(SEED + 13)
            q, k, v = (torch.randn(bsz, h, s, d, generator=gen, device=dev).to(dtype)
                       for h in (hq, hkv, hkv))
            tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
            blocks = flash_blocks[dtype]

            def kern():
                return FK.flash_attention_tiles(q, k, v, causal=True, **blocks)

            def plain():
                return FK.flash_attention_tiles_plain(q, k, v, causal=True, scale=d ** -0.5,
                                                      **blocks)

            got, again, want = kern(), kern(), plain()
            sync()
            err = float((got.float() - want.float()).abs().max())
            check(torch.allclose(got.float(), want.float(), **tol),
                  f"flash {label}: kernel disagrees with plain version (max err {err})")
            check(torch.equal(got, again), f"flash {label}: two launches gave different bits")
            # the oracle's logits at (a) would take 9 x 32768^2 x 4 B: its first
            # 4096 positions (a causal prefix sees only its own keys)
            n = min(s, 4096)
            ref32 = gqa_attention_reference(q[:, :, :n].float(), k[:, :, :n].float(),
                                            v[:, :, :n].float()).to(dtype)
            oerr = float((got[:, :, :n].float() - ref32.float()).abs().max())
            check(torch.allclose(got[:, :, :n].float(), ref32.float(), **tol),
                  f"flash {label}: kernel disagrees with the oracle (max err {oerr})")
            lib = TF.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
            lerr = float((got.float() - lib.float()).abs().max())
            del want, again, ref32, lib
            oracle_ms = None
            if s <= 4096:  # the reference's function in the input type
                oracle_ms = device_ms(lambda: gqa_attention_reference(q, k, v), max(1, reps // 5))
            nbytes = (2 * hq + 2 * hkv) * bsz * s * d * q.element_size()
            flops = 2 * 2 * bsz * hq * d * s * s / 2  # causal: half the score matrix
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / (BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S) * 1e3
            timed = kernel_ms(kern, reps, 1, "flash_attention_kernel")
            rows[label] = dict(
                arch=m.name, batch=bsz, heads=hq, kv_heads=hkv, seq=s, head_dim=d,
                dtype=str(dtype), block_q=blocks["block_q"], block_k=blocks["block_k"],
                max_abs_err=err, max_abs_err_vs_oracle=oerr, oracle_positions=n,
                max_abs_diff_vs_library=lerr, **timed, tflops=flops / timed["ms"] / 1e9,
                plain_ms=device_ms(plain, max(1, reps // 10)), oracle_ms=oracle_ms,
                library_ms=device_ms(lambda: TF.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True), reps),
                bound_ms=max(bytes_ms, ops_ms), bound_bytes=nbytes, bound_flops=flops,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")
            worst = max(worst, err)
            del q, k, v, got
        emit("flash_kernel", t0, per_launch=rows, max_abs_err=worst,
             tolerance=dict(f32=FLASH_F32_TOL, bf16=FLASH_BF16_TOL),
             sass_tensor_ops=sass_tensor_ops(),
             note="(a) smollm-135m's layer at prefill_32k's S = 32,768, B = 1 (Hq 9, Hkv 3, D "
                  "64, bf16); (b) llama3-8b's at S = 4096 (Hq 32, Hkv 8, D 128, bf16); (c) "
                  "(a)'s widths at S = 4096, float32; (d) the train step's: (a)'s widths at B "
                  "= 4, S = 4096, bf16; float32 at recovery's shapes: (e) the trainer CLI's "
                  "(smollm-135m's smoke config: Hq 3, Hkv 3, D 16; B 8, S 128), (f) an elastic "
                  "rank's (TINY: Hq 4, Hkv 2, D 8; B 1, S 32); q, k, v seeded N(0, 1); the "
                  "model's blocks; tflops: "
                  "the causal flops over ms; sass_tensor_ops: HMMA / HGMMA instructions in "
                  "each kernel's SASS (cuobjdump -sass of the built library); "
                  "ms: CUDA events around back-to-back launches, the stream held while the host "
                  "enqueues them (profiler_ms: the mean of the kernel's profiler events over as "
                  "many launches, events_seen of events_expected); plain_ms: the kernel's plain "
                  "version (its block schedule, float32), CUDA events; oracle_ms: the full-logit "
                  "oracle in the input type where its logits fit (S <= 4096); the oracle check "
                  "runs it in float32 on the same inputs over the first 4096 positions; "
                  "library_ms: F.scaled_dot_product_attention(is_causal, enable_gqa), a "
                  "yardstick the port never calls; bound: q, k, v and out once at 3.35 TB/s "
                  "or the causal flops at 989 (bf16) / 67 (float32) TFLOP/s, the larger")
        return rows

    flash_rows = flash_phase()

    @contextlib.contextmanager
    def plain_attention():
        """Swap the flash kernel for its plain version (a reference run)."""
        kernel_fn = FK.flash_attention_tiles

        def plain(q, k, v, *, causal, scale, block_q, block_k):
            return FK.flash_attention_tiles_plain(
                q, k, v, causal=causal, scale=q.shape[-1] ** -0.5 if scale is None else scale,
                block_q=block_q, block_k=block_k)

        FK.flash_attention_tiles = plain
        try:
            yield
        finally:
            FK.flash_attention_tiles = kernel_fn

    def rel_l2(a, b):
        return float(torch.linalg.vector_norm((a.float() - b.float()).reshape(-1))
                     / torch.linalg.vector_norm(b.float().reshape(-1)))

    def lm_tokens(step, batch, seq, vocab):
        bt = lm_batch(SEED, step, batch, seq, vocab)
        return {k_: torch.from_numpy(v_).to(dev) for k_, v_ in bt.items()}

    # -- LMs at published width: smollm-135m prefill, decode, train; one prefill of the others
    def lm_phase():
        """smollm-135m: prefill at prefill_32k's S, the greedy decode loop at
        decode_32k's cache length, 10 train steps at train_4k's S; then one
        prefill of each other LM arch. Returns the kernel's launches."""
        t0 = time.perf_counter()
        arch = get_arch("smollm-135m")
        cfg = arch.smoke() if rehearsal else arch.model
        mem0 = torch.cuda.memory_allocated() if dev.type == "cuda" else None
        params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
        prefill = train_steps.make_lm_prefill(cfg)
        n_layers = cfg.n_layers
        launches = 0

        # prefill: prefill_32k's seq, batch cut from 32 to 1
        seq = arch.shape("prefill_32k").dims["seq"] // (64 if rehearsal else 1)
        toks = lm_tokens(0, 1, seq, cfg.vocab)["tokens"]
        logits = prefill(params, toks)  # warm (not counted)
        sync()
        check(logits.shape == (1, seq, cfg.vocab) and bool(torch.isfinite(logits).all()),
              "lm prefill: non-finite or misshapen logits")
        del logits
        n_pre = 1 if rehearsal else 3
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        FK.reset_launch_counts()
        lat = []
        for _ in range(n_pre):
            t = time.perf_counter()
            logits = prefill(params, toks)
            sync()
            lat.append((time.perf_counter() - t) * 1e3)
            del logits
        pre_launches = dict(FK.LAUNCHES)
        if not rehearsal:
            check(pre_launches == {"bf16": n_layers * n_pre},
                  f"lm prefill: flash launches {pre_launches} != {n_layers} x {n_pre}")
        launches += sum(pre_launches.values())
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
        wall_us, evs = profiled(lambda: prefill(params, toks))
        dev_us = sum(event_us(e) for e in evs)
        med = float(np.median(lat))
        prefill_row = dict(
            seq=seq, batch=1, prefills=n_pre,
            ms_per_prefill=dict(median=med, min=min(lat), max=max(lat)),
            tokens_per_s=seq / med * 1e3, launches=pre_launches, peak_memory_bytes=peak,
            profiled_prefill=dict(wall_us=wall_us, device_busy_us=dev_us,
                                  device_idle_share=1.0 - dev_us / wall_us,
                                  flash_events=[sum(e.count for e in evs
                                                    if "flash_attention" in e.key), n_layers],
                                  flash_us=sum(event_us(e) for e in evs
                                               if "flash_attention" in e.key)))
        # logits at S = 4096 against a plain-attention run (not counted)
        short = toks[:, :min(seq, 4096)]
        lg_k = prefill(params, short)
        with plain_attention():
            lg_p = prefill(params, short)
        sync()
        prefill_row["vs_plain_attention"] = dict(
            seq=short.shape[1], rel_l2=rel_l2(lg_k, lg_p),
            max_abs_diff=float((lg_k.float() - lg_p.float()).abs().max()))
        check(prefill_row["vs_plain_attention"]["rel_l2"] <= LM_KERNEL_REL,
              f"lm prefill: kernel vs plain attention {prefill_row['vs_plain_attention']}")
        del lg_k, lg_p, toks

        # decode: serve_lm's greedy loop at decode_32k's cache length, batch cut to 32
        max_len = arch.shape("decode_32k").dims["seq"] // (64 if rehearsal else 1)
        n_tok, batch = (4, 2) if rehearsal else (LM_DECODE_TOKENS, LM_DECODE_BATCH)
        serve_lm(arch, 2, batch, dev, cfg=cfg, params=params, max_len=max_len)  # warm
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        out, secs = serve_lm(arch, n_tok, batch, dev, cfg=cfg, params=params, max_len=max_len)
        check(out.shape == (batch, n_tok) and (out >= 0).all() and (out < cfg.vocab).all(),
              f"lm decode: tokens {out.shape}")
        decode_row = dict(tokens=n_tok, batch=batch, max_len=max_len,
                          cache_bytes=2 * n_layers * batch * cfg.n_kv_heads * max_len * cfg.hd
                          * torch.finfo(cfg.dtype).bits // 8,
                          seconds=secs, tokens_per_s=n_tok * batch / secs,
                          ms_per_token=secs / n_tok * 1e3,
                          peak_memory_bytes=torch.cuda.max_memory_allocated()
                          if dev.type == "cuda" else None)
        # a 64-token prompt fed one token at a time against the kernel path's forward
        prompt = lm_tokens(1, 1, LM_PROMPT, cfg.vocab)["tokens"]
        decode = train_steps.make_lm_decode_step(cfg)

        def stepwise(p, c):
            cache = tfm.init_kv_cache(c, 1, LM_PROMPT, device=dev)
            return torch.stack([decode(p, cache, prompt[:, i:i + 1], i)[0]
                                for i in range(LM_PROMPT)], 1)

        fwd, dec = prefill(params, prompt), stepwise(params, cfg)
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        p32 = tree_map(lambda t_: t_.float(), params)
        fwd32 = train_steps.make_lm_prefill(cfg32)(p32, prompt)
        dec32 = train_steps.make_lm_decode_step(cfg32)
        cache32 = tfm.init_kv_cache(cfg32, 1, LM_PROMPT, device=dev)
        dec32 = torch.stack([dec32(p32, cache32, prompt[:, i:i + 1], i)[0]
                             for i in range(LM_PROMPT)], 1)
        sync()
        decode_row["vs_forward"] = dict(
            prompt=LM_PROMPT, rel_l2=rel_l2(dec, fwd),
            max_abs_diff=float((dec.float() - fwd.float()).abs().max()),
            argmax_agree=float((dec.argmax(-1) == fwd.argmax(-1)).float().mean()),
            f32_max_abs_diff=float((dec32 - fwd32).abs().max()))
        check(decode_row["vs_forward"]["rel_l2"] <= LM_DECODE_REL
              and decode_row["vs_forward"]["f32_max_abs_diff"] <= LM_DECODE_F32_ATOL,
              f"lm decode vs forward: {decode_row['vs_forward']}")
        del fwd, dec, fwd32, dec32, p32, cache32

        # train: train_4k's seq, batch cut from 256 to 4, AdamW as the CLI
        tseq = arch.shape("train_4k").dims["seq"] // (64 if rehearsal else 1)
        tbatch, n_steps = (2, 3) if rehearsal else (LM_TRAIN_BATCH, LM_TRAIN_STEPS)
        ocfg = AdamWConfig(lr=1e-3, total_steps=n_steps, warmup_steps=min(20, n_steps))
        loss_fn = train_steps.make_lm_loss(cfg)
        b0 = lm_tokens(0, tbatch, tseq, cfg.vocab)
        loss_k, grads_k = train_steps.value_and_grad(loss_fn, params, b0["tokens"], b0["labels"])
        with plain_attention():
            loss_p, grads_p = train_steps.value_and_grad(loss_fn, params, b0["tokens"],
                                                         b0["labels"])
        gk = torch.cat([x.float().reshape(-1) for x in tree_flatten(grads_k)[0]])
        gp = torch.cat([x.float().reshape(-1) for x in tree_flatten(grads_p)[0]])
        first = dict(loss=[float(loss_k), float(loss_p)], grads_rel_l2=rel_l2(gk, gp),
                     loss_rel=abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)))
        check(first["loss_rel"] <= LM_KERNEL_REL and first["grads_rel_l2"] <= LM_KERNEL_REL,
              f"lm train first step: kernel vs plain attention {first}")
        del grads_k, grads_p, gk, gp
        step = train_steps.make_lm_train_step(cfg, ocfg)
        state = train_steps.init_train_state(params, ocfg)
        batches = [lm_tokens(i, tbatch, tseq, cfg.vocab) for i in range(n_steps)]
        sync()
        FK.reset_launch_counts()
        lat, losses = [], []
        t_all = time.perf_counter()
        for bt in batches:
            t = time.perf_counter()
            state, m_ = step(state, bt)
            losses.append(float(m_["loss"]))  # waits for the step
            lat.append((time.perf_counter() - t) * 1e3)
        wall = time.perf_counter() - t_all
        train_launches = dict(FK.LAUNCHES)
        if not rehearsal:  # forward and the block's recompute in backward: 2 a layer
            check(train_launches == {"bf16": 2 * n_layers * n_steps},
                  f"lm train: flash launches {train_launches} != 2 x {n_layers} x {n_steps}")
        launches += sum(train_launches.values())
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"lm train: loss did not fall ({losses[0]} -> {losses[-1]})")
        wall_us, evs = profiled(lambda: step(state, batches[0]))
        dev_us = sum(event_us(e) for e in evs)
        top = sorted(evs, key=event_us, reverse=True)[:8]
        med = float(np.median(lat))
        train_row = dict(seq=tseq, batch=tbatch, steps=n_steps,
                         profiled_step=dict(wall_us=wall_us, device_busy_us=dev_us,
                                            device_idle_share=1.0 - dev_us / wall_us,
                                            flash_events=[sum(e.count for e in evs
                                                              if "flash_attention" in e.key),
                                                          2 * n_layers],
                                            top_device_us={e.key[:80]: [event_us(e), e.count]
                                                           for e in top}),
                         ms_per_step=dict(median=med, min=min(lat), max=max(lat)),
                         tokens_per_s=tbatch * tseq / med * 1e3, steps_per_s=n_steps / wall,
                         loss_first=losses[0], loss_last=losses[-1], first_step=first,
                         launches=train_launches)

        # the trained state (bf16 params, float32 AdamW moments) through
        # save_checkpoint and restore_checkpoint onto the card, leaf by leaf
        ck_dir = ROOT / "build" / "lm_checkpoint"
        shutil.rmtree(ck_dir, ignore_errors=True)
        sync()
        t = time.perf_counter()
        save_checkpoint(str(ck_dir), n_steps, state, meta={"next_step": n_steps})
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        back, meta = restore_checkpoint(str(ck_dir), state)
        sync()
        restore_s = time.perf_counter() - t
        saved, restored = tree_flatten(state)[0], tree_flatten(back)[0]
        check(len(saved) == len(restored) and meta == {"next_step": n_steps},
              f"lm checkpoint: {len(restored)} leaves of {len(saved)}, meta {meta}")
        for i, (a_, b_) in enumerate(zip(saved, restored)):
            check(same_bits(a_, b_) and a_.device == b_.device if torch.is_tensor(a_)
                  else a_ == b_ and type(a_) is type(b_),
                  f"lm checkpoint: leaf {i} came back changed")
        tensors = [x for x in saved if torch.is_tensor(x)]
        ckpt_row = dict(leaves=len(saved), bytes=dir_bytes(ck_dir),
                        tensor_bytes=sum(x.numel() * x.element_size() for x in tensors),
                        bf16_leaves=sum(x.dtype == torch.bfloat16 for x in tensors),
                        f32_leaves=sum(x.dtype == torch.float32 for x in tensors),
                        save_seconds=save_s, restore_seconds=restore_s, bits_equal=True)
        shutil.rmtree(ck_dir, ignore_errors=True)
        del state, batches, params, back, saved, restored, tensors

        # one prefill of each other LM arch at published width, B = 1, S = 4096
        others = {}
        for arch_id, cut in LM_OTHER:
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            a = get_arch(arch_id)
            c = a.smoke() if rehearsal else a.model
            if cut is not None and not rehearsal:
                c = dataclasses.replace(c, n_layers=cut)
            t = time.perf_counter()
            p_ = tfm.init_params(c, torch.Generator(device=dev).manual_seed(SEED), dev)
            sync()
            init_s = time.perf_counter() - t
            tk = lm_tokens(2, 1, 4096 // (64 if rehearsal else 1), c.vocab)["tokens"]
            pf = train_steps.make_lm_prefill(c)
            FK.reset_launch_counts()
            t = time.perf_counter()
            lg = pf(p_, tk)
            sync()
            ms = (time.perf_counter() - t) * 1e3
            got_l = dict(FK.LAUNCHES)
            check(lg.shape == (1, tk.shape[1], c.vocab) and bool(torch.isfinite(lg).all()),
                  f"{arch_id} prefill: non-finite or misshapen logits")
            if not rehearsal:
                check(got_l == {"bf16": c.n_layers},
                      f"{arch_id} prefill: flash launches {got_l} != {c.n_layers}")
            launches += sum(got_l.values())
            others[arch_id] = dict(layers=c.n_layers, published_layers=a.model.n_layers,
                                   seq=tk.shape[1], first_prefill_ms=ms, init_seconds=init_s,
                                   params=tfm.count_params(c), launches=got_l,
                                   group=c.n_heads // c.n_kv_heads, head_dim=c.hd,
                                   peak_memory_bytes=torch.cuda.max_memory_allocated()
                                   if dev.type == "cuda" else None)
            del p_, lg, tk
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        emit("lm", t0, config=dataclasses.asdict(cfg) | {"dtype": str(cfg.dtype)},
             memory_allocated_at_start=mem0, profiler_probe_events=profiler_probe(),
             prefill=prefill_row, decode=decode_row,
             train=train_row, checkpoint=ckpt_row, other_archs=others,
             tolerance=dict(kernel_rel_l2=LM_KERNEL_REL, decode_rel_l2=LM_DECODE_REL,
                            decode_f32_atol=LM_DECODE_F32_ATOL),
             note="smollm-135m at published width (30 layers, d 576, 9/3 heads, D 64, d_ff "
                  "1536, vocab 49152, bf16), seeded weights. prefill: prefill_32k's S = "
                  "32,768, batch cut from 32 to 1, host clock ending in a synchronize, 3 "
                  "prefills after a warm one; launches counted (30 a prefill); logits at S = "
                  "4096 against a plain-attention run. decode: serve_lm's greedy loop, "
                  "decode_32k's cache of 32,768 with the batch cut from 128 to 32, 32 tokens "
                  "(after a 2-token warm run); profiled_prefill: one prefill under "
                  "torch.profiler (busy time a floor: the profiler drops events); a 64-token "
                  "prompt fed one token at a time "
                  "against the kernel path's forward, bf16 and float32. train: train_4k's S "
                  "= 4096, batch cut from 256 to 4, 10 AdamW steps (lr 1e-3); launches 2 a "
                  "layer a step (forward and the block's recompute); the first step's loss "
                  "and grads against a plain-attention run; profiled_step: one more step under "
                  "torch.profiler (a floor). checkpoint: the trained state (bf16 params, "
                  "float32 AdamW moments and step) saved with save_checkpoint (host clock "
                  "from a synchronized card) and restored onto the card into its own template "
                  "(host clock ending in a synchronize), every leaf bit for bit; bytes: the "
                  "step directory on disk. other archs: one first prefill "
                  "at B = 1, S = 4096; qwen3-moe-30b-a3b cut from 48 to 12 layers (its 48 "
                  "layers' 61 GB of bf16 weights leave too little room)")
        return launches

    flash_launches = lm_phase()

    def launch_phase():
        """The launch tooling on the card. (a) The dry run of one cell per
        family on the fake production mesh `single` (its own process a cell,
        as the fake world must not leak), each record `ok`. (b) The
        prediction held against the card (one process): each of
        LAUNCH_CARD_CELLS built on a mesh of one rank, traced fake, then the
        same step run here on inputs drawn from the seed; gates: the card's
        FlopCounterMode count equal to the fake trace's, and the kernels'
        formula FLOPs too; the card's peak (max_memory_allocated after
        reset_peak_memory_stats) at most PEAK_SLACK x predicted + 64 MiB.
        Returns the kernels' launches of (b) (their LAUNCHES counters), by
        kernel and variant."""
        t0 = time.perf_counter()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out_dir = ROOT / "build" / "launch_dry"
        shutil.rmtree(out_dir, ignore_errors=True)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]] if "PYTHONPATH" in os.environ
                                   else [])))
        dryrun = [sys.executable, "-m", "repro_torch.launch.dryrun"]
        dry = [subprocess.Popen(dryrun + ["--mesh", "single", "--arch", a, "--shape", sh,
                                          "--out", str(out_dir), "--device", dev.type],
                                env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
               for a, sh in LAUNCH_DRY_CELLS]
        cells = LAUNCH_CARD_CELLS if not rehearsal else LAUNCH_CARD_CELLS[:2]
        try:
            card = subprocess.run(dryrun + ["--on-card", ",".join(cells), "--seed", str(SEED),
                                            "--device", dev.type],
                                  env=env, cwd=ROOT, capture_output=True, text=True,
                                  timeout=LAUNCH_TIMEOUT_S)
            logs = [p_.communicate(timeout=LAUNCH_TIMEOUT_S)[0] for p_ in dry]
        finally:
            for p_ in dry:
                if p_.poll() is None:
                    p_.kill()
                    p_.wait()
        dry_rows = {}
        for (a, sh), p_, log in zip(LAUNCH_DRY_CELLS, dry, logs):
            f = out_dir / f"{a}__{sh}__single.json"
            rec = json.loads(f.read_text()) if f.exists() else {}
            check(p_.returncode == 0 and rec.get("status") == "ok",
                  f"launch (a): dry run of {a}/{sh} rc {p_.returncode}: {log[-1500:]}")
            dry_rows[f"{a}/{sh}"] = {k: rec[k] for k in (
                "chips", "flops_per_device", "bytes_per_device", "collective_bytes_per_device",
                "compute_s", "memory_s", "collective_s", "dominant", "peak", "memory",
                "flops_split", "kernel_calls", "replicated", "replicated_flops",
                "useful_ratio")}
            dry_rows[f"{a}/{sh}"]["collective_mix"] = rec["collectives"]["count_by_kind"]
        recs = [json.loads(ln)["on_card"] for ln in card.stdout.splitlines()
                if ln.startswith('{"on_card"')]
        check(card.returncode == 0 and len(recs) == len(cells),
              f"launch (b): rc {card.returncode}: {card.stdout[-1500:]} {card.stderr[-3000:]}")
        launches = {}
        for r in recs:
            # the rehearsal's CPU run takes the kernels' plain versions: aten FLOPs only
            check(r["flops_equal"] if not rehearsal
                  else r["card_aten_flops"] == r["fake_aten_flops"],
                  f"launch (b) {r['key']}: FLOPs on the card "
                  f"{r['card_aten_flops']} + kernels {r['card_kernel_flops']}, the fake trace's "
                  f"{r['fake_aten_flops']} + {r['fake_kernel_flops']}")
            if not rehearsal:
                # predicted: the trace's peak plus the cuBLAS workspaces the
                # step allocated, measured on its first run
                limit = PEAK_SLACK * r["predicted_peak_bytes"] + 64 * 2 ** 20
                check(r["card_peak_bytes"] <= limit,
                      f"launch (b) {r['key']}: peak {r['card_peak_bytes']} B on the card over "
                      f"{limit:.0f} (predicted {r['predicted_peak_bytes']})")
                r["peak_within_slack_alone"] = \
                    r["card_peak_bytes"] <= PEAK_SLACK * r["predicted_peak_bytes"]
                print(f"launch {r['key']}: peak {r['card_peak_bytes']} / predicted "
                      f"{r['predicted_peak_bytes']} (traced {r['traced_peak_bytes']} + cuBLAS "
                      f"workspaces {r['cublas_workspace_bytes']}) = {r['peak_ratio']:.4f}; step "
                      f"{r['ms']:.3f} ms, roofline {r['roofline']['dominant']} "
                      f"{r['roofline']['bound_ms']:.4f} ms; launches {r['launches']}", flush=True)
            for k, by_variant in r["launches"].items():  # the kernels' own counters
                for v, n in by_variant.items():
                    launches.setdefault(k, {})[v] = launches.get(k, {}).get(v, 0) + n
        emit("launch", t0, dry_run=dry_rows, on_card=recs, peak_slack=PEAK_SLACK,
             note="(a) python -m repro_torch.launch.dryrun --mesh single, one process a cell, "
                  "on the fake 256-rank (data=16, model=16) world: per-device FLOPs, bytes, "
                  "collectives and peak memory of one traced step; (b) --on-card: the cell on "
                  "a one-rank mesh traced fake (FLOPs: flop_counter's formulas + the kernels' "
                  "own, peak: MemTracker, plus the cuBLAS workspaces the step allocates, "
                  "measured on a first run), then run here on inputs from the seed: "
                  "FlopCounterMode's count (the kernels apart, by their formulas), "
                  "max_memory_allocated after reset_peak_memory_stats (the inputs resident), "
                  "ms: host clock ending in a synchronize, the median of 3 after the gated run; "
                  "launches: the kernels' LAUNCHES counters over every run of (b)")
        return launches

    launch_launches = launch_phase()

    kernels = [
        dict(name=f"{kern}_reduce_cores[{v}]", route="cuda", **meta,
             launches=launches[f"{kern}_reduce_cores"].get(v, 0)
             + dist_launches[f"{kern}_reduce_cores"].get(v, 0)
             + (recovery_launches["gather"].get(v, 0) if kern == "gather" else 0),
             max_abs_err=errs[(kern, v)],
             ms=timing[(kern, v)]["ms"], plain_ms=timing[(kern, v)]["plain_ms"],
             bound_ms=timing[(kern, v)]["bound_ms"], bound_by=timing[(kern, v)]["bound_by"],
             library_ms=None)
        for kern, meta, variants in (("gather", GATHER, problems), ("scatter", SCATTER, push_variants))
        for v in variants
    ] + [
        dict(name=f"{kern}_reduce_cores[{v}]", route="cuda", **meta,
             launches=lane_launches[f"{kern}_reduce_cores"].get(v, 0)
             + dist_launches[f"{kern}_reduce_cores"].get(v, 0),
             max_abs_err=lane_errs[(kern, arm)], ms=lane_timing[(kern, arm)]["ms"],
             plain_ms=lane_timing[(kern, arm)]["plain_ms"],
             bound_ms=lane_timing[(kern, arm)]["bound_ms"],
             bound_by=lane_timing[(kern, arm)]["bound_by"], library_ms=None)
        for kern, meta in (("gather", GATHER), ("scatter", SCATTER))
        for v, arm in LANE_ENTRIES[kern]
    ] + [
        # the main path's bag: DIN's profile bag at serve_p99, shape (a)
        dict(name="embedding_bag[sum]", route="cuda", **EMBAG,
             launches=din_launches.get("sum", 0) + serve_launches["embedding_bag"].get("sum", 0)
             + din_train_launches.get("sum", 0) + dist_launches["embedding_bag"].get("sum", 0)
             + launch_launches.get("embedding_bag", {}).get("sum", 0),
             max_abs_err=bag_errs["sum"], ms=bag_rows["a_serve_p99[sum]"]["ms"],
             plain_ms=bag_rows["a_serve_p99[sum]"]["plain_ms"],
             bound_ms=bag_rows["a_serve_p99[sum]"]["bound_ms"],
             bound_by=bag_rows["a_serve_p99[sum]"]["bound_by"],
             library_ms=bag_rows["a_serve_p99[sum]"]["library_ms"])
    ] + [
        # the trainer's bag backward: DIN's profile bag at train_batch, shape (e)
        dict(name="embedding_bag_backward[sum]", route="cuda", **EMBAG_BWD,
             launches=din_train_launches.get("sum_backward", 0),
             max_abs_err=bag_bwd_errs["sum"], ms=bag_bwd_rows["e_train_batch[sum]"]["ms"],
             plain_ms=bag_bwd_rows["e_train_batch[sum]"]["plain_ms"],
             bound_ms=bag_bwd_rows["e_train_batch[sum]"]["bound_ms"],
             bound_by=bag_bwd_rows["e_train_batch[sum]"]["bound_by"],
             library_ms=bag_bwd_rows["e_train_batch[sum]"]["library_ms"])
    ] + [
        dict(name=f"gather_reduce[{v}]", route="cuda", **BUCKET,
             launches=bucket_launches.get(v, 0), max_abs_err=bucket_errs[v],
             ms=bucket_timing[v]["ms"], plain_ms=bucket_timing[v]["plain_ms"],
             bound_ms=bucket_timing[v]["bound_ms"], bound_by=bucket_timing[v]["bound_by"],
             library_ms=None)
        for v in ("min_u32", "min_f32_add", "sum_f32")
    ] + [
        # the trainer's shape: GAT layer 1 at the Cora shape, shape (a)
        dict(name="segment_softmax[f32]", route="cuda", **SOFTMAX,
             launches=softmax_launches.get("f32", 0) + dist_launches["segment_softmax"].get("f32", 0)
             + launch_launches.get("segment_softmax", {}).get("f32", 0),
             max_abs_err=sm_err,
             ms=sm_rows["a_cora_layer1"]["ms"], plain_ms=sm_rows["a_cora_layer1"]["plain_ms"],
             bound_ms=sm_rows["a_cora_layer1"]["bound_ms"],
             bound_by=sm_rows["a_cora_layer1"]["bound_by"], library_ms=None)
    ] + [
        # the model's shape: smollm-135m's layer at prefill_32k, shape (a)
        dict(name="flash_attention[bf16]", route="cuda", **FLASH, launches=flash_launches,
             max_abs_err=flash_rows["a_smollm_prefill_32k"]["max_abs_err"],
             ms=flash_rows["a_smollm_prefill_32k"]["ms"],
             plain_ms=flash_rows["a_smollm_prefill_32k"]["plain_ms"],
             bound_ms=flash_rows["a_smollm_prefill_32k"]["bound_ms"],
             bound_by=flash_rows["a_smollm_prefill_32k"]["bound_by"],
             library_ms=flash_rows["a_smollm_prefill_32k"]["library_ms"])
    ] + [
        # float32 on recovery's trainer (smollm-135m's smoke config) and
        # elastic LM: checked at their shapes (e) and (f) and at (c),
        # smollm-135m's layer at S = 4096, where it is timed
        dict(name="flash_attention[f32]", route="cuda", **FLASH,
             launches=recovery_launches["flash_f32"],
             max_abs_err=max(flash_rows[x]["max_abs_err"] for x in FLASH_F32_SHAPES),
             max_abs_err_by_shape={x: flash_rows[x]["max_abs_err"] for x in FLASH_F32_SHAPES},
             ms=flash_rows["c_smollm_4k_f32"]["ms"],
             plain_ms=flash_rows["c_smollm_4k_f32"]["plain_ms"],
             bound_ms=flash_rows["c_smollm_4k_f32"]["bound_ms"],
             bound_by=flash_rows["c_smollm_4k_f32"]["bound_by"],
             library_ms=flash_rows["c_smollm_4k_f32"]["library_ms"])
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    if rehearsal:
        print("chip_smoke: CPU rehearsal finished; not a chip result", file=sys.stderr)
        return 3
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
