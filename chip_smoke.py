#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--rows N] [--change N]

Phases, one line each:
  1. device   — the card (``nvidia-smi`` name and power limit), torch, CUDA
  2. build    — nvcc builds every kernel of ``src/repro_torch/kernels/csrc``
     (and the flash library's SASS must hold Hopper's HGMMA and
                UTMALDG instructions: wgmma and TMA loads)
     lint     — the port's invariant lint (python -m repro_torch.analysis)
                over src/repro_torch: exit 0, no unsuppressed finding, a
                reason on every suppression; a planted tree under build/
                (a bare torch.sort in core/merge.py, a clock in a core
                module, an in-place write to a sealed lane) exits 1 with
                each flagged by its rule; LINT through the statement door
                on a Repo on the card and `datagit lint --format json`
                give the runner's findings
  3. kernels  — each kernel at the main path's shapes against its plain
                PyTorch version on the same inputs (the integer kernels
                EXACTLY equal, flash attention within atol = rtol = 2e-2
                and a relative L2 error of 6e-3 in bf16, with a lost key
                mask shown to exceed the latter), with its CUDA-event
                time, its bound, the plain
                version's time and, where one PyTorch call computes the
                same function, that call's time; flash attention also
                with its profiler device time, TFLOP/s, CTA tile,
                registers and shared memory and SDPA's device time; and at
                every prompt length of the serve phase, with each CTA tile
                (64 and 128 query rows) also forced (flash_serve); the
                flash backward at the training shape and at shapes (b)
                and (c) against its plain version (atol = rtol = 2e-2 and
                a relative L2 error of 6e-3 for dq, dk and dv, each row's
                LSE within 1e-4, a planted mask fault shown to exceed
                the L2 bound, two launches bitwise equal), with its
                event and device time, TFLOP/s, bound and SDPA's
                backward through autograd (flash_bwd); the forward with
                a sliding window at mixtral-8x7b's prefill (8,192 tokens,
                W 4,096), at hd 64 with W off the key tile and at W = Sq
                (bit-equal to the unwindowed kernel), both instances
                (serving's and the LSE one) against the plain version,
                beside SDPA with a boolean band mask, bound by the
                in-window pairs; jamba's attention layer (GQA 64:8, hd
                128) at 2,048 and 1,024 tokens; all pairs at serve_cross's
                shapes (whisper's encoder over 1,500 frames and its cross
                sublayer at 2,048 tokens, llama-vision's cross layers
                over 6,404 patches, the Server's 8 stub frames), SDPA
                beside each; and the backward with the window at
                mixtral's training layer (8,192 tokens, W 4,096; the
                plain version KV head by KV head), at hd 64 with W off
                the tile and at W = Sq (the unwindowed kernel's bits),
                and unwindowed MQA at granite-20b's (4 x 2,048, 48 query
                heads on one KV head; dk and dv, sums over 48 heads, held
                by rel-L2 and the plain bf16 path's error), at the other
                training layers (t1-t3, jamba's j) and at the cross
                configs' (eb-lb: whisper's encoder, cross sublayer and
                decoder in a microbatch of 8, llama-vision's cross and
                attention layers), beside SDPA's backward (with a band
                mask under the window); and both the forward and the
                backward at the shapes one rank of the sharded step runs
                on the 16 x 16 mesh (4 x 2,048: granite-20b's 3 query
                heads and phi3.5-moe's 2 on one KV head), beside SDPA
  4. golden   — the fixed-seed diff, merge, revert and publish workloads
                on the card, compared with the reference package's
                recorded digests (GOLDEN and GOLDEN_APPLY), and
                GOLDEN_APPLY again from an evicted store
     examples — repro_torch.examples.quickstart and
                data_engineering_workflow (100,000 rows each) with
                --device cpu and --device cuda in processes of their own:
                the card's stdout byte-equal to the CPU's, the card run's
                seconds and its launches by kernel (all four VCS kernels
                launched)
  5. mainpath — TPC-H SF1 lineitem (6,001,215 rows), PK and NoPK: load,
                snapshot, clone, a 100,000-row update (change set C4),
                cold and warm SNAPSHOT DIFF, SQL diff and a three-way
                ACCEPT merge, with every kernel's launch count; then
                searchsorted at the main path's own shapes: its launches
                split by query count, and the commonest shape of all, of
                each group, of the largest table and of the zone windows
                held EXACTLY against the plain version (both entries: a
                side for all queries, a side per query) and timed
                (searchsorted_split; the kernels line takes
                searchsorted's times from the first); probe alike
                (probe_split: launches by table rows and queries, each
                checked shape EXACTLY equal to the plain version, with
                event, device and synced host times; the kernels line
                takes probe's times from its commonest shape); segsum
                alike (segsum_split: launches by stream rows and row
                pair, every such shape, the commonest, largest and
                Δ-sized marked, EXACTLY equal to the plain version, with
                event, device and synced host times, the bound, launches
                x ms, and torch.cumsum's time, the scan half only; the
                kernels line takes segsum's times from its commonest
                shape); then
                launch_cost, the host cost of one searchsorted call at
                100,000 x 1 step by step: the stream read, the
                allocation, the checks, the C call that launches, the
                whole wrapper, and torch.searchsorted; and one flash
                forward's (1 x 64, H 2, hd 64) launched directly and
                through the op repro_torch::flash_attention, beside SDPA;
                and a prefill and a train step of qwen1.5-0.5b's first 4
                layers over 512 tokens through the flash ops and with
                the wrappers bound to the launches, in turns
     workflow — after each main path, on its engine: the workflow
                porcelain at SF1 — a branch, a C4 edit on it, then a pull
                request's review diff, CI checks on the merged preview,
                publish, revert of the publish, a Δ-revert of the main
                path's ACCEPT merge, the branch dropped and GC; each step
                timed, with the kernels' launches in that window, the
                spans, GC's counts and device memory around it, and a
                second round under the profiler (busy share, device-to-
                host copies); it fails unless the diff, the publish report,
                the preview's cleanup, the reverts (empty diffs), zero
                rehashing, GC and the launches are as they must be, and
                unless each kernel's launches by shape sum to its count;
                then workflow_split: the window's searchsorted, probe and
                segsum launches by shape, timed at the commonest shapes
                as the main path's are, and every distinct shape of both
                rounds held EXACTLY against the plain version
     doors    — after each workflow phase, on the same engine: (PK) a
                secondary index on l_partkey backfilled over every row,
                64 lookups against a device mask of the table and a C4
                update that maintains it; the workflow through the
                statement door, one timed statement at a time; compaction
                (content unchanged, a diff of 0 groups, fewer objects);
                a materialized clone (0 rows rehashed); ALTER TABLE ADD
                COLUMN (every row's signature rehashed, no blake2b) and a
                restore past it; per_key_conflicts (PK 1.5 x C4 keys,
                NoPK 0); the 16-step script through Repo, statements, the
                CLI and replay on the card, equal to the CPU's; then
                doors_split: every rowhash shape of both windows EXACT
                and timed with its bound, every other shape EXACT
     tiers    — after each doors phase, on the same engine with the
                doors' extra tables dropped (NoPK: on an engine of its
                own of min(--rows, 300,000) rows, started as the main
                path starts its own): every object spilled to DGPK
                packs under build/ and evicted from the card (device
                memory before and after), a cold SNAPSHOT DIFF and the SQL
                diff from the evicted store equal to the resident ones,
                fsck with every layer (rowhash on the card, the replay),
                a push, a shallow clone on the card whose first diff
                faults in only what it reads, a C4 change pushed back and
                pulled (0 rows rehashed, equal digests), two planted
                faults found and repaired; with the CRC32C's own seconds
                and rate on this host and the pack path's split; then
                tiers_split: the windows' most launched rowhash shapes
                EXACT and timed with their bounds, every other shape EXACT
  6. serve    — qwen1.5-0.5b at full width (24 layers, d 1024, vocab
                151,936; random weights from the seed): 8 requests of
                512-2048 prompt tokens and 32 new tokens each through the
                continuous-batching server (batch 4), prefill attention on
                the flash kernel (24 x 8 launches); then prefill-vs-decode
                consistency of the last logits on one 2048-token prompt
     serve_models — deepseek-7b, internlm2-1.8b, granite-20b,
                phi3.5-moe-42b-a6.6b (24 of 32 layers) and mixtral-8x7b
                (20 of 32; MoE and a 4,096-token window) at their
                published widths, each built from the seed, served and
                freed in turn: two requests through the server (flash
                launches = layers x requests; mixtral's first prompt
                8,192 tokens), the consistency check (MoE: the decode
                replays the prefill's routes, each side's own routing
                recorded unheld; mixtral's over a prefill of 8,192
                positions, and its ring fault measured at 6,144),
                parameters, peak and free memory, prefill tokens/s,
                decode ms a token beside its weight-read bound
     serve_ssm — rwkv6-7b (8 of 32 layers: recurrent, no attention) and
                jamba-1.5-large-398b cut to the stack's first 5 layers
                (four mamba layers and the attention layer, two MoE
                FFNs of 16 experts) at their published widths, the cut's
                matrices at the published depth's init scale, served as
                serve_models serves: flash launches = attention layers x
                requests (0 and 2); rwkv6-7b also serves 1,024 and
                32,768 tokens one request at a time, and its state's
                bytes must be equal after both; the consistency check
                at 2,048 + 32 (jamba with the prefill's routes replayed)
                and at the first decoded position, where the recurrent
                state zeroed and the conv/shift state one token stale
                must each exceed the tolerance (recorded at 2,048 + 32
                too, where the state has decayed past them); parameters
                from the state dict beside param_count and the config's
                formula, the state's bytes, decode ms a token beside
                its bound (weights, valid KV and the state read and
                written once)
     serve_cross — whisper-medium whole (24 encoder + 24 decoder layers,
                learned positions) and llama-3.2-vision-90b cut to its
                first 30 layers (6 cross + 24 attention; the cut's
                matrices at the published depth's init scale), served as
                serve_models serves with the Server's stub context (8
                zero frames, 6,404 zero patches): flash launches = 72
                and 30 a prefill (encoder layers, decoder self and
                cross, cross layers) x requests; then with a context of
                real size drawn from the seed (1,500 frames, 6,404
                patches, N(0, 1) in bf16): prefill ms and tok/s at 2,048
                tokens (whisper's encoder apart), decode ms a token
                beside its bound (the cached cross K/V read whole), the
                cross cache's bytes, the consistency check at 2,048 + 32,
                two planted cross faults (a layer's K/V zeroed, every
                layer's from another context) and the change of context
                itself, each above the tolerance at the first decoded
                position
  7. train    —qwen1.5-0.5b at full width (random weights from seed 0):
                a corpus of 4,096 samples x 2,049 tokens in a token table
                on the card engine, pinned; train_loop at 2,048 tokens x
                batch 4 for 12 steps, a checkpoint every 4 steps and a
                fault injected at step 6 that must roll back to step 4
                exactly once; a checkpoint restored bit for bit, the
                changed shards between consecutive tags; the example's
                curation (a review diff of exactly the added samples, the
                old pin unchanged) and 3 more steps on the new pin; one
                full-width step on the card against the same step on the
                CPU's plain path (loss and gradient norm); step ms,
                tokens/s, model-FLOP share, the busy share of a profiled
                step, peak memory, checkpoint seconds, and the launches
                of both attention kernels in the phase's window
     train_models — internlm2-1.8b (all 24 layers), deepseek-7b (16 of
                30), granite-20b (6 of 52; MQA), phi3.5-moe-42b-a6.6b and
                mixtral-8x7b (3 of 32 each; MoE, mixtral's 4,096-token
                window binding at 8,192 tokens) at their published
                widths: each its own pinned corpus on a card engine, 4
                steps of train_step(remat=True) (the backward kernel,
                windowed for mixtral, and AdamW), one profiled step, then
                freed; finite losses, launches (forward twice a layer
                under remat), step ms, tokens/s, model-FLOP share with
                active parameters (lookup tables left out), peak memory;
                then the card-vs-CPU step (1 x 128 tokens) with remat
                for each MoE config at one layer (its matrices at the
                32-layer scale; mixtral's window cut to 64) with
                the card's routes replayed on the CPU, each side's own
                routing recorded unheld. rwkv6-7b (8 of 32) and jamba's
                slots 0, 2, 4 likewise; whisper-medium whole (16 x 1,500
                frames, 448 tokens, two microbatches) and
                llama-3.2-vision-90b's slots 0 and 1 (1 x 2,048 tokens
                over 6,404 patches) through launch.steps.make_train_step,
                a context drawn from the seed each step, their card-vs-CPU
                steps with the queries scaled to unit-deviation scores
     sharded  — the sharded step on a world-size-1 NCCL group's mesh
                (make_mesh_for: data 1 x model 1, DTensor): 2 steps of
                launch.steps.make_train_step over the mesh for
                qwen1.5-0.5b at full width (4 x 2,048 tokens) and one of
                whisper-medium whole (16 x 1,500 frames, two
                microbatches), and 2 of phi3.5-moe-42b-a6.6b and rwkv6-7b
                at their first layer (2 x 256 tokens: the MoE FFN and the
                rwkv mixer on local tensors), each against the one-device
                step from the same init: losses and every parameter and
                moment bit for bit; a 2,048-token prefill and 8 decode steps of qwen
                through make_prefill_step / make_decode_step against
                LM.prefill / decode_step, logits and cache bit for bit;
                step ms with and without the mesh, peak memory and the
                attention kernels' launches in the mesh's windows; the
                mesh's first qwen step under FlopCounterMode
     dryrun   — the dry run (launch.dryrun), traced in a child process
                started after train_models' timed steps, beside its
                card-vs-CPU checks, which are not timed, and joined before
                the sharded phase (fake process groups cannot share one
                with the sharded phase's NCCL group; the trace takes the
                host's CPU): internlm2-1.8b train_4k, mixtral
                decode_32k (its all-gather bytes below the parent's less
                the cache's), rwkv6-7b long_500k, whisper-medium
                prefill_32k, mixtral train_4k (below 5.45 GB a device)
                and phi3.5-moe prefill_32k (useful-FLOP ratio at least
                0.348) on a fake 256-rank 16 x 16 mesh, and internlm2
                train_4k and llama-3.2-vision-90b train_4k (at most 16.24
                GB a device) on a fake 512-rank 2 x 16 x 16 one, at published
                widths with fake CUDA tensors (the reference's keys and
                each cell's trace seconds); no kernel launched and no byte
                allocated on the card during the traces; qwen's 4 x 2,048
                train step traced on a fake 1 x 1 mesh against the
                sharded phase's real step: FLOPs within 1% of
                FlopCounterMode's count, and the tracked peak and the
                roofline's compute time over the real peak and warm step

It exits non-zero (and prints no result) without a CUDA device or
without the repository's sources, and on any failed check. Its last line
is the one-line JSON result; the line before it lists the kernels, with
the launches of every path's window (main path, workflow, doors and
tiers, both modes, and the examples; flash from the three serving
phases, both training phases and the sharded phase, its backward from
both training phases and the sharded phase, with the windowed launches
apart). The full record goes to
``build/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
#: the script's start: each phase line carries its seconds since (at_s)
START = time.perf_counter()
SF1_ROWS = 6_001_215       # TPC-H SF1 lineitem
C4_ROWS = 100_000          # change set C4 of benchmarks/vcs_tables.py
#: the NoPK half of the tiers phase runs on an engine of at most this many
#: rows (with a change of at most TIERS_NOPK_CHANGE): on ``tiers_engine``
#: at SF1 the halves took 136.5 s (NoPK) + 127.1 s (PK) on an H100 80GB
#: HBM3 at 700 W, where the phase has 180 s (PERF.md §4)
TIERS_NOPK_ROWS = 300_000
TIERS_NOPK_CHANGE = 10_000

# H100 SXM peaks (NVIDIA data sheet / Hopper white paper): HBM3 bandwidth,
# and the 32-bit integer operation rate every kernel here computes in. An
# SM issues at most one warp instruction per scheduler per clock, 4 x 32 =
# 128 lane-operations (IMAD runs on the FP32 FMA pipe beside the 64 INT32
# lanes), so 128 x 132 SMs x 1.98 GHz boost bounds any integer mix.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 128 * 132 * 1.98e9
# Dense BF16 tensor-core peak of the H100 SXM (data sheet): 989.4 TFLOP/s.
BF16_FLOPS_PER_S = 989.4e12

# Flash attention shapes: (B, Sq, Sk, H, KV, hd, causal). (a) the serving
# prefill of qwen1.5-0.5b at 2048 tokens; (b) GQA at hd 128 with
# internlm2-1.8b's heads; (c) all-pairs with Sk off the 64-key tile.
FLASH_SHAPES = ((1, 2048, 2048, 16, 16, 64, True),
                (1, 4096, 4096, 16, 8, 128, True),
                (2, 1024, 1500, 16, 16, 64, False))
# jamba-1.5-large-398b's attention layer at serve_ssm's prompts: GQA 64:8
# at hd 128 (no rotary positions, which the kernel never sees)
FLASH_JAMBA_SHAPES = ((1, 2048, 2048, 64, 8, 128, True),
                      (1, 1024, 1024, 64, 8, 128, True))
# the flash kernel all pairs at serve_cross's shapes: (e) whisper's
# encoder over 1,500 frames (a ragged query tile too); (xw) whisper's
# cross sublayer at a 2,048-token prompt; (xv) llama-vision's cross
# layers over 6,404 patches (GQA 64:8, hd 128, the key tail ragged:
# 50 x 128 + 4); (x8) the Server's stub context, 8 frames, whisper's
# encoder over it (every tile ragged) and (x8q) its cross sublayer
FLASH_CROSS_SHAPES = ((1, 1500, 1500, 16, 16, 64, False),
                      (1, 2048, 1500, 16, 16, 64, False),
                      (1, 2048, 6404, 64, 8, 128, False),
                      (1, 8, 8, 16, 16, 64, False),
                      (1, 2048, 8, 16, 16, 64, False))
# the flash kernels at the shapes one rank runs them in the sharded
# train and prefill steps on the 16 x 16 mesh, where each 'model' rank
# takes H / 16 query heads and the KV head they read (B 4 x 2,048, hd
# 128, causal): granite-20b's 48 query heads on one KV head (3 a rank)
# and phi3.5-moe's 32 on 8 (2 a rank, from one KV head)
FLASH_RANK_SHAPES = ((4, 2048, 2048, 3, 1, 128, True),
                     (4, 2048, 2048, 2, 1, 128, True))
FLASH_BLOCK_N = 128         # keys per K/V tile of the kernel
FLASH_TOL = 2e-2            # atol = rtol, bf16 against the plain version
# and ||kernel - plain|| / ||plain|| at most this: two bf16 roundings of the
# output and of p in a different key-tile order give 2-3.5e-3 (plain
# attention at 64- against 256-key blocks, on the CPU), and a lost key mask
# at shape (c) (36 zero keys left in) 1.4e-2, which the phase re-measures.
FLASH_REL_TOL = 6e-3
SERVE_ARCH = "qwen1.5-0.5b"
SERVE_PROMPTS = (512, 1024, 2048, 1536, 768, 2048, 1024, 512)
SERVE_NEW = 32
SERVE_CONSIST = (2048, 32)  # prompt length, positions then decoded
# the flash kernel at every prompt length of the serve phase (qwen1.5-0.5b:
# 16 heads of 64, causal): the serve path's flash time is the sum over
# prompts of layers x the kernel's time at that length
FLASH_SERVE_SHAPES = tuple((1, n, n, 16, 16, 64, True)
                           for n in sorted(set(SERVE_PROMPTS)))
# Prefill (flash kernel) vs decode (plain attention) last logits, bf16:
# ||L1 - L2|| / ||L1|| at most this. On the H100 at full width the bf16
# rounding noise of this randomly initialised model read 0.059-0.105 over
# four weight and prompt seeds, and a decode one position ahead or behind
# 1.31-1.40 (repro_torch.benchmarks.serve_consistency and this check).
SERVE_REL_TOL = 0.3
# Windowed flash rows: (B, Sq, Sk, H, KV, hd, W), all causal. (w1)
# mixtral-8x7b's prefill of 8,192 tokens in its 4,096-token window; (w2)
# hd 64 with W off the 128-key tile; (w3) W = Sq, where the window never
# binds and the kernel must give the unwindowed kernel's bits.
FLASH_WINDOW_SHAPES = ((1, 8192, 8192, 32, 8, 128, 4096),
                       (1, 4096, 4096, 16, 16, 64, 1000),
                       (1, 2048, 2048, 16, 8, 128, 2048))
# The other configs the port serves, at their published widths, each with
# the layers it keeps on one 80 GB card (None: all of them): phi3.5-moe's
# 32 layers need 83.7 GB of bf16 weights and mixtral's 93.4 GB, so they
# keep 24 and 20 (random weights from the seed).
SERVE_MODELS = (("deepseek-7b", None), ("internlm2-1.8b", None),
                ("granite-20b", None), ("phi3.5-moe-42b-a6.6b", 24),
                ("mixtral-8x7b", 20))
# The state-space and hybrid configs, served alike, each with its layer
# matrices at the published depth's init scale: rwkv6-7b cut to its
# first 8 of 32 layers (its host-bound serving took 46 s of the script
# whole; cut to keep the script within its time as the sharded phase
# grew), jamba-1.5-large-398b cut to the stack's first 5 layers (slots
# 0-4: four mamba layers and the attention layer, FFNs mlp/moe/mlp/moe/
# mlp; one published period of 8 holds ~45 B parameters, 90 GB in bf16)
SERVE_SSM_MODELS = (("rwkv6-7b", 8), ("jamba-1.5-large-398b", 5))
# The encoder-decoder and cross-attention configs, served alike, at the
# published depth's init scale: whisper-medium whole (1.15 B parameters
# with its two 65,536-row position tables), llama-3.2-vision-90b cut to
# its first 30 layers, 6 of its 20 periods (27.77 B parameters, 55.5 GB
# in bf16; 35 layers would need 64.1 GB before activations)
SERVE_CROSS_MODELS = (("whisper-medium", None),
                      ("llama-3.2-vision-90b", 30))
# the context of real size each serve_cross config also serves with:
# whisper's encoder length for one 30 s window of audio (1,500 frames,
# arXiv:2212.04356); otherwise the config's cross_len (llama-vision's
# 6,404 patches)
CROSS_CONTEXT = {"whisper-medium": 1500}
# timed calls of the real-context prefill and of the encoder alone
CROSS_TIMED = 3
# a config without attention also serves these prompts one at a time:
# its state is O(1), so its bytes and decode time do not grow with them
SSM_SOLO_PROMPTS = (1024, 32768)
# the first-step check's prompt: 2,016, 2,015 and 2,014 positions (the
# whole prefill, the prefill before the decoded one, the stale fault's)
# run chunks of 63, 31 and 53, where 2,049 would run 683 chunks of 3
FIRST_STEP_PROMPT = 2016
SERVE_MODELS_PROMPTS = (2048, 1024)   # prompt tokens of the requests
SERVE_MODELS_NEW = 8                  # new tokens of each request
# mixtral also serves a prompt longer than its window, and its consistency
# check prefills 8,192 positions (a multiple of W, so the window binds and
# the ring is placed right) before it decodes; RING_OFFSET_PREFILL (not a
# multiple of W) measures the reference's ring fault, kept for parity
# (ROADMAP Queue 3): recorded as ring_offset_gap, not held to a limit
WINDOW_PROMPT = 8192
RING_OFFSET_PREFILL = 6144
# Flash backward shapes: the training step's (qwen1.5-0.5b at B 4 x 2048)
# and the forward table's (b) and (c).
BWD_SHAPES = ((4, 2048, 2048, 16, 16, 64, True),) + FLASH_SHAPES[1:]
# Windowed backward shapes: (B, Sq, Sk, H, KV, hd, W), all causal: (w1)
# mixtral-8x7b's training layer, 8,192 tokens in its 4,096-token window;
# (w2) hd 64 with W off the 128-key tile; (w3) W = Sq, which must give the
# unwindowed kernel's bits. And (m), unwindowed MQA at granite-20b's
# training layer (48 query heads on one KV head).
BWD_WINDOW_SHAPES = ((1, 8192, 8192, 32, 8, 128, 4096),
                     (1, 4096, 4096, 16, 16, 64, 1000),
                     (1, 2048, 2048, 16, 8, 128, 2048))
BWD_MQA_SHAPE = (4, 2048, 2048, 48, 1, 128, True)
# The other training layers of train_models, unwindowed at 4 x 2048, hd
# 128: (t1) internlm2-1.8b's GQA (H 16, KV 8), (t2) deepseek-7b's MHA (H =
# KV = 32), (t3) phi3.5-moe's GQA (H 32, KV 8), (j) jamba-1.5-large's
# GQA 64:8 without rotary positions (a group of 8: 4 x 8 x 16 = 512 CTAs,
# each walking 8 query heads)
BWD_TRAIN_SHAPES = ((4, 2048, 2048, 16, 8, 128, True),
                    (4, 2048, 2048, 32, 32, 128, True),
                    (4, 2048, 2048, 32, 8, 128, True),
                    (4, 2048, 2048, 64, 8, 128, True))
# The encoder-decoder and cross-attention configs' training layers, as
# train_models runs them through launch.steps.make_train_step: whisper-
# medium at 16 x 1,500 frames in two microbatches of 8, its decoder at
# min(448, 1,500) tokens: (eb) the encoder, all pairs, ragged query and key
# tiles (11 x 128 + 92); (xb) the decoder's cross sublayer, 448 x 1,500;
# (db) the decoder's self-attention, causal. llama-3.2-vision-90b's slots
# 0 and 1 at 1 x 2,048 over 6,404 patches, GQA 64:8, hd 128: (vb) the
# cross layer, all pairs, a 4-key tail; (lb) the attention layer
BWD_CROSS_SHAPES = ((8, 1500, 1500, 16, 16, 64, False),
                    (8, 448, 1500, 16, 16, 64, False),
                    (8, 448, 448, 16, 16, 64, True),
                    (1, 2048, 6404, 64, 8, 128, False),
                    (1, 2048, 2048, 64, 8, 128, True))
# every row of the backward's table, (B, Sq, Sk, H, KV, hd, causal[, W]):
# each shape that the train and train_models phases run the backward at
BWD_ROWS = BWD_SHAPES + tuple(s[:6] + (True,) + s[6:]
                              for s in BWD_WINDOW_SHAPES) \
    + (BWD_MQA_SHAPE,) + BWD_TRAIN_SHAPES + BWD_CROSS_SHAPES \
    + FLASH_RANK_SHAPES
BWD_TILE = 128              # keys per CTA tile of the kernel
# dk and dv of a KV head sum the bf16-rounded P and dS of its G query
# heads over every row: their elementwise error grows with G. Up to this
# G they are held elementwise at FLASH_TOL like dq; above it (granite's
# MQA, G = 48: 0.047 and 0.074 at (m) on the H100, while their rel-L2
# read 2.4e-3, as at every other row) by BWD_REL_TOL and by a max error
# no larger than the plain bf16 path's (autograd through ref.attention in
# bf16) against the same float32 backward
BWD_GROUP_ELEMENTWISE = 8
# the plain backward runs KV head by KV head above this many bytes of
# float32 scores: at (w1) it would hold four (B, KV, G, 8192, 8192)
# float32 tensors, 34 GB, at once
PLAIN_BWD_BYTES = 4 << 30
# dq, dk, dv against the plain version (float32 on the same bf16 inputs):
# atol = rtol = FLASH_TOL and ||kernel - plain|| / ||plain|| at most this.
# The kernel rounds P and dS to bf16 before their products and its outputs
# to bf16: 2.3-2.4e-3 at every shape of its first run on the H100 (the
# forward's own error is 2-3.5e-3); a lost mask must read above it.
BWD_REL_TOL = 6e-3
# the kernel's LSE against the plain version's, absolute (float32 values
# of 5-12 here; 1-2e-6 measured)
LSE_TOL = 1e-4
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_SAMPLES, TRAIN_SEQ, TRAIN_BATCH = 4096, 2048, 4
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAULT_AT = 12, 4, 6
TRAIN_MORE_STEPS = 3        # on the new pin, after the curation
TRAIN_CHECK = (1, 256)      # batch, tokens of the card-vs-CPU step
#: and of train_models' checks, each one layer of a config at full
#: width: half TRAIN_CHECK, for the script's time (their CPU steps took
#: 208 s of it at 256 tokens; the loss and gradient norms sat 14x or more
#: inside the tolerances below)
TRAIN_MODELS_CHECK = (1, 128)
# |card - CPU| / CPU for that step's loss and global gradient norm: bf16
# weights and activations, summed in other orders by cuBLAS and the flash
# kernels on the card and by the plain path on the CPU. Each bf16 path
# read 1.3e-2 (card) and 1.7e-2 (CPU) from the same step in float32 for
# the gradient norm, 3.0e-2 apart, and 1.8-2.5e-4 for the loss, 7e-5
# apart, on the H100 (PERF.md, PR 19); the check reports that floor.
TRAIN_LOSS_TOL = 2e-3
TRAIN_GNORM_TOL = 5e-2
#: and leaf by leaf: each bf16 gradient's distance from float32's, the
#: card's at most this many times the CPU's (both bf16 paths round the
#: same weights: the card's and the CPU's read 0.96-1.10 times each
#: other on the 354 leaves of the five configs' checks), with the median
#: leaf's norm within TRAIN_GNORM_TOL of the CPU's. One leaf can carry
#: nearly all of the global norm: rwkv's ``u``, zero at its init
TRAIN_LEAF_ERR_RATIO = 2.0
# The configs serve_models serves, trained at their published widths: (arch,
# layers kept (None: all), batch, tokens). 12 bytes a parameter (bf16
# weights and gradients, float32 AdamW moments) must fit one 80 GB card
# beside remat's activations, AdamW's float32 temporaries of the largest
# leaf and the float32 logits: deepseek-7b keeps 16 of 30 layers (~49 GB
# of state), granite-20b 6 of 52 (~45 GB), phi3.5-moe 3 of 32 (~50 GB)
# and mixtral-8x7b 3 of 32 (~55 GB); mixtral takes one 8,192-token row,
# so its 4,096-token window binds. The state-space and hybrid configs
# (their layer matrices at the published depth's init scale): rwkv6-7b
# keeps 8 of 32 layers (2.75 B parameters, ~33 GB of state; its host-
# bound steps took 43 s of the script at 16 layers), and jamba
# the slots 0, 2 and 4 of its first period (a tuple: slots, not a
# count): mamba, mamba and attention, each with its MLP, its first five
# layers less the two MoE layers, whose 16 experts hold 9.66 B
# parameters (116 GB of state) each (3.85 B, ~46 GB). The configs with a
# context train through launch.steps.make_train_step, their batch and
# tokens a ShapeCfg's (an encoder-decoder config's "tokens" are its
# frames: its decoder takes min(448, frames)): whisper-medium whole
# (1.147 B, 13.8 GB of state) at 16 x 1,500 frames, one 30 s window, and
# 448 tokens, in the reference's two microbatches (pick_microbatches);
# llama-3.2-vision-90b's slots 0 and 1 (its cross layer and an attention
# layer, 3.81 B, ~46 GB) at 1 x 2,048 tokens over its 6,404 patches: at B
# 2 the reference's policy takes two microbatches, whose float32
# accumulator (15.2 GB) and AdamW's float32 temporaries of the 1.05 B-
# parameter lm_head would pass 80 GB.
TRAIN_MODELS = (("internlm2-1.8b", None, 4, 2048),
                ("deepseek-7b", 16, 4, 2048),
                ("granite-20b", 6, 4, 2048),
                ("phi3.5-moe-42b-a6.6b", 3, 4, 2048),
                ("mixtral-8x7b", 3, 1, 8192),
                ("rwkv6-7b", 8, 4, 2048),
                ("jamba-1.5-large-398b", (0, 2, 4), 4, 2048),
                ("whisper-medium", None, 16, 1500),
                ("llama-3.2-vision-90b", (0, 1), 1, 2048))
TRAIN_MODELS_STEPS = 4
# The sharded phase on the world-size-1 mesh: (arch, batch, tokens, steps)
# of the train step against the one-device step (the train phase's
# shape); whisper-medium whole at train_models' 16 x 1,500 frames (448
# tokens), where pick_microbatches takes two microbatches; (arch, batch,
# prompt, new tokens) of the prefill and decode steps
SHARDED_TRAIN = (TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, 2)
SHARDED_CONTEXT = ("whisper-medium", 16, 1500, 2)
SHARDED_SERVE = (TRAIN_ARCH, 1, 2048, 8)
# the sharded mixers, each at its first layer and published widths:
# (arch, layers, batch, tokens, steps) of the train step through the mesh
# (the MoE FFN's experts and the rwkv mixer's heads on local tensors)
# against the one-device step
SHARDED_MIXERS = (("phi3.5-moe-42b-a6.6b", 1, 2, 256, 2),
                  ("rwkv6-7b", 1, 2, 256, 2))
# The dry-run phase: the reference's four test cells, mixtral's train
# cell (its MoE FFN sharded), internlm2's and llama-vision's train cells
# on the two-pod mesh (the microbatch split over both data-parallel
# axes) and phi3.5-moe's prefill cell (8 KV heads on a 16-wide 'model'
# axis), traced at published widths on fake 256- and 512-rank meshes with
# fake CUDA tensors; then the sharded phase's qwen train step (4 x 2,048
# tokens) on a fake 1 x 1 mesh, held against the real step's FLOPs
# (within DRYRUN_FLOPS_TOL), memory and time
DRYRUN_CELLS = (("internlm2-1.8b", "train_4k", False),
                ("mixtral-8x7b", "decode_32k", False),
                ("rwkv6-7b", "long_500k", False),
                ("whisper-medium", "prefill_32k", False),
                ("mixtral-8x7b", "train_4k", False),
                ("internlm2-1.8b", "train_4k", True),
                ("llama-3.2-vision-90b", "train_4k", True),
                ("phi3.5-moe-42b-a6.6b", "prefill_32k", False))
# Each figure a device, from the dry-run table on an H100 80GB HBM3 at
# 700 W (PERF.md): mixtral's train_4k on 16 x 16 read 4.971 GB with its
# experts over 'model' (42.73 with the MoE FFN whole on every rank);
# held at that reading plus 9.6%
DRYRUN_MIXTRAL_TRAIN_GB = 5.45
# llama-vision's train_4k on 2 x 16 x 16, its batch split into
# microbatches by all-to-all, at most its 16 x 16 reading with the
# batch gathered (15.47) plus 5% (it read 44.30 with the gather)
DRYRUN_LLAMA_POD_TRAIN_GB = 16.24
# phi3.5-moe's prefill_32k on 16 x 16, each 'model' rank attending with
# its 2 of 32 query heads: a useful-FLOP ratio at least 4x its 0.087
# with every head on every rank
DRYRUN_PHI_PREFILL_USEFUL = 0.348
# mixtral's decode_32k on 16 x 16: its all-gather bytes (each all-
# gather's operand, one rank's shard) while decode attention gathered
# every layer's K and V cache over 'model' (the dry-run table's reading
# on an H100 80GB HBM3 at 700 W), and the least they must fall now that
# no rank gathers the cache: 32 layers x K and V x (8 rows x 256 slots x
# 8 KV heads x 128 x 2 bytes) = 268,435,456 bytes of cache shards, less
# 7%
DRYRUN_MIXTRAL_DECODE_GATHER = 633_618_432
DRYRUN_MIXTRAL_DECODE_FALL = 250_000_000
DRYRUN_FLOPS_TOL = 0.01
# seconds the parent waits for the dry-run child after its other phases
DRYRUN_WAIT_S = 300
TRAIN_MODELS_SAMPLES = 64   # samples of each config's pinned corpus
# mixtral's window in its card-vs-CPU step, cut so that it binds at
# TRAIN_MODELS_CHECK's 128 tokens
TRAIN_CHECK_WINDOW = 64
# searchsorted launches of the main path, grouped by query count: the
# 1-query zone windows of core/table.py, small, Δ-sized and table-sized
SEARCH_GROUPS = (("1 query", 1, 1), ("2-1023 queries", 2, 1023),
                 ("1024-999,999 queries", 1024, 999_999),
                 (">= 1,000,000 queries", 1_000_000, None))
# probe launches of the main path, grouped by query count: a 32-query tile
# and less, up to a thousand, the per-object share of a Δ-sized probe
# (C4's 100,000 keys over the objects of an SF1 table), and more
PROBE_GROUPS = (("1-32 queries", 1, 32), ("33-1023 queries", 33, 1023),
                ("1024-65,535 queries", 1024, 65_535),
                (">= 65,536 queries", 65_536, None))
# table rows, queries: one query, so the launch is all of a call's cost
LAUNCH_COST_SHAPE = (100_000, 1)
# (B, S, H, hd) of the flash launch-cost call: one query tile per head
FLASH_COST_SHAPE = (1, 64, 2, 64)
# the flash ops' dispatch end to end (flash_path_steps): a prefill and a
# train step of this config's first layers, at its widths
FLASH_STEP_ARCH, FLASH_STEP_LAYERS, FLASH_STEP_TOKENS = \
    "qwen1.5-0.5b", 4, 512
# SQL diff re-runs after the main path, plain and split into steps
SQL_DIFF_REPEATS = 6
# the segsum kernel's name in a profiler trace
SEGSUM_FOCUS = "segsum_scan"
# what segsum_split's scan_half_ms times: no one PyTorch call computes the
# flags and the sums together (its library_ms is None), so it times the
# sums alone, under a key of their own, and says so
SCAN_HALF = ("torch.cumsum(signs, dtype=torch.int32): the scan half only, "
             "not the same function")

# Digests recorded by the reference package on its fixed-seed workloads:
# GOLDEN and GOLDEN_APPLY of tests/test_diff_digest.py.
GOLDEN = {
    True: {"diff": "4953744753d67b10", "sql_diff": "4953744753d67b10",
           "merge": "2000/2000/0", "scan": "8ef72a49adf021ca",
           "pitr": "593ece73c0d631df"},
    False: {"diff": "b265412cf4eb3342", "sql_diff": "b265412cf4eb3342",
            "merge": "2000/2000/0", "scan": "a7500c287b142086",
            "pitr": "7de964732d98a93e"},
}
GOLDEN_APPLY = {
    True: {"merge_fail": "1500/1500/0/1500/0/9175a02fb5212c8b",
           "merge_skip": "1500/1500/750/1500/0/4bed1479eb2d935c",
           "merge_accept": "2250/2250/750/1500/0/3dcc9d6952350aea",
           "merge_cell": "2250/2250/750/1500/750/1a9fce248a60f246",
           "merge_nobase": "3000/3000/3000/0a867bd86d60e5c0",
           "revert": "d7d4eebfa086d68b",
           "publish": "1f0ff3dab3c88b9c",
           "publish_revert": "255d731b902dc7bf"},
    False: {"merge_fail": "1500/1500/0/3000/0/c3ad540e2e7ab79f",
            "merge_skip": "1500/1500/750/3000/0/d8d647613324fefa",
            "merge_accept": "1500/3000/750/3000/0/04a454d7d8aa2a54",
            "merge_nobase": "2250/0/0/f79b73c6652df224",
            "revert": "267ea3643bb54dd8",
            "publish": "6cdb0f2c0762963f",
            "publish_revert": "d6722819d4896927"},
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def phase(phase_name: str, **fields) -> dict:
    print(json.dumps({"phase": phase_name,
                      "at_s": time.perf_counter() - START, **fields},
                     sort_keys=True), flush=True)
    return fields


# ------------------------------------------------------------------ timing

def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around ``iters``
    launches after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(nbytes: float, nops: float, flops: float = 0.0):
    """Least time (ms) for the work, and which resource sets it: bytes at
    the HBM rate, 32-bit integer operations at the issue rate, bf16
    tensor-core FLOPs at their peak."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = max(nops / INT32_OPS_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def touched_rows(n: int, q: int) -> int:
    """Distinct rows of a sorted ``n``-row table that the descents of
    ``q`` sorted queries read: level l of the search tree holds 2**l rows,
    of which the queries reach at most q, over levels 0..ceil(log2 n),
    and never more than the table."""
    depth = max(1, math.ceil(math.log2(n)))
    return min(n, sum(min(1 << lvl, q) for lvl in range(depth + 1)))


def random_words(torch, g, n: int):
    """``n`` uniform int64 words on ``g``'s device."""
    i64 = torch.iinfo(torch.int64)
    return torch.randint(i64.min, i64.max, (n,), generator=g,
                         device=g.device, dtype=torch.int64)


def sorted_pairs(torch, g, n: int, collide_every: int = 0):
    """``n`` random 128-bit keys (lo, hi) sorted by (lo, hi); with
    ``collide_every`` k, every k-th key shares its lo word with the one
    before (lo64 collisions: equal lo, distinct hi)."""
    from repro_torch.kernels import ops
    lo, hi = random_words(torch, g, n), random_words(torch, g, n)
    if collide_every:
        lo[1::collide_every] = lo[::collide_every][:lo[1::collide_every]
                                                   .shape[0]]
    o = ops._sort128(lo, hi)
    return lo[o].contiguous(), hi[o].contiguous()


def probe_inputs(torch, g, n: int, q: int, collide_every: int = 0):
    """A sealed object's ``n`` keys and ``q`` queries, both sorted by (lo,
    hi), as the main path hands them to probe: half the table's keys,
    half keys it does not hold."""
    lo, hi = sorted_pairs(torch, g, n, collide_every)
    return (lo, hi) + probe_queries(torch, g, lo, hi, q)


def probe_queries(torch, g, lo, hi, q: int):
    """``q`` queries sorted by (lo, hi) for the table (lo, hi): half its
    keys, half keys it does not hold."""
    from repro_torch.kernels import ops
    n = lo.shape[0]
    pick = torch.randint(0, n, (q // 2,), generator=g, device=g.device)
    q_lo = torch.cat([lo[pick], random_words(torch, g, q - q // 2)])
    q_hi = torch.cat([hi[pick], random_words(torch, g, q - q // 2)])
    o = ops._sort128(q_lo, q_hi)
    return q_lo[o].contiguous(), q_hi[o].contiguous()


def segsum_inputs(torch, g, n: int, pair: bool = True):
    """A key-sorted signed stream of ``n`` rows as the main path hands it
    to segsum: half the keys repeat the one before (runs of equal keys),
    signs +-1, and with ``pair`` a row-signature pair whose lo word
    repeats the one before half the time (PK; NoPK compares the key
    alone). Returns segsum's arguments (lo, hi, signs[, r_lo, r_hi])."""
    dev = g.device
    k_lo, k_hi = sorted_pairs(torch, g, n)
    dup = torch.rand(n, generator=g, device=dev) < 0.5
    dup[0] = False
    k_lo = torch.where(dup, k_lo.roll(1), k_lo).contiguous()
    k_hi = torch.where(dup, k_hi.roll(1), k_hi).contiguous()
    if pair:
        r_lo, r_hi = random_words(torch, g, n), random_words(torch, g, n)
        r_lo = torch.where(torch.rand(n, generator=g, device=dev) < 0.5,
                           r_lo.roll(1), r_lo).contiguous()
    sg = (torch.randint(0, 2, (n,), generator=g, device=dev,
                        dtype=torch.int32) * 2 - 1)
    return (k_lo, k_hi, sg) + ((r_lo, r_hi) if pair else ())


def segsum_bound(n: int, pair: bool):
    """Bytes and integer operations of one segsum call: the key words (16
    bytes a row, 32 with the row pair), the sign, the flag and the sum
    once each; a few compares and adds a row."""
    return n * (41 if pair else 25), n * (20 if pair else 12)


# ------------------------------------------------------------------ kernels

def kernel_row(torch, name, shape, out_k, out_p, t_k, t_p, t_lib, nbytes,
               nops) -> dict:
    """One kernel measurement: its outputs EXACTLY equal to the plain
    version's (else the run fails), times and bound."""
    err = max(float((a.to(torch.float64) - b.to(torch.float64))
                    .abs().max()) if a.numel() else 0.0
              for a, b in zip(out_k, out_p))
    exact = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
    b_ms, b_by = bound(nbytes, nops)
    check(exact, f"{name} {shape}: kernel differs from plain version")
    return {"shape": shape, "ok": exact, "max_abs_err": err,
            "ms": t_k, "plain_ms": t_p, "library_ms": t_lib,
            "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "int_ops": nops}


def rowhash_row(torch, r: int, c: int, g) -> dict:
    """rowhash on ``r`` rows of ``c`` random lanes: EXACT against the plain
    version, timed by CUDA events (``ms``, the call's host cost included)
    and by the profiler's device time of the kernel alone (``device_ms``,
    with ``device_bound_share``, the bound over it), and bound by each
    lane read once and the four signature words written once."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rowhash import signatures

    lanes = torch.randint(-2**31, 2**31 - 1, (r, c), generator=g,
                          device="cuda", dtype=torch.int32)
    # per lane: one multiply shared by the chains, then per chain one
    # add, xor, fmix32 (2 mul, 3 shift, 3 xor) and one multiply-add
    nops = r * (c * (2 + 4 * 10) + 4 * 9 + 4)
    dev_ms = per_launch_ms(torch, lambda: signatures(lanes),
                           "rowhash_kernel")
    traces = DEVICE_READINGS[-1]["traces"]
    row = kernel_row(torch, "rowhash", [r, c], signatures(lanes),
                     ref.signatures(lanes),
                     cuda_ms(torch, lambda: signatures(lanes), 20),
                     cuda_ms(torch, lambda: ref.signatures(lanes), 3),
                     None, r * c * 4 + r * 16, nops)
    row["device_ms"] = dev_ms
    row["device_traces"] = traces
    row["device_bound_share"] = row["bound_ms"] / dev_ms if dev_ms \
        else None
    return row


def kernel_phase(torch, seed: int) -> dict:
    """Every kernel at the main path's shapes against its plain version."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.probe import probe
    from repro_torch.kernels.searchsorted import searchsorted
    from repro_torch.kernels.segsum_diff import segsum

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def words(n):
        return random_words(torch, g, n)

    results = {}

    def record(name, *args):
        results.setdefault(name, []).append(kernel_row(torch, name, *args))

    # rowhash: the 12-column lineitem row (24 lanes) and its 2-column key
    for c in (24, 4):
        results.setdefault("rowhash", []).append(
            rowhash_row(torch, SF1_ROWS, c, g))

    # probe: one sealed object at capacity, sorted queries (hits + misses)
    n = q = 1 << 18
    t_lo, t_hi, qlo, qhi = probe_inputs(torch, g, n, q, collide_every=97)
    depth = max(1, math.ceil(math.log2(n)))
    record("probe", [n, q], probe(t_lo, t_hi, qlo, qhi),
           ref.probe(t_lo, t_hi, qlo, qhi),
           cuda_ms(torch, lambda: probe(t_lo, t_hi, qlo, qhi), 50),
           cuda_ms(torch, lambda: ref.probe(t_lo, t_hi, qlo, qhi), 5),
           None, touched_rows(n, q) * 16 + q * 32, q * (depth + 1) * 2 * 10)

    # searchsorted: a tombstone-target-sized table, table-sized queries (no
    # main-path launch has as many: searchsorted_split checks and times
    # the kernel at the main path's own shapes)
    n, q = 100_000, SF1_ROWS
    tab = torch.sort(words(n)).values
    tab = ref.flip(tab)      # ascending as uint64 words
    qs = ref.flip(torch.sort(words(q)).values).contiguous()
    depth = max(1, math.ceil(math.log2(n)))
    for side in ("left", "right"):
        lib_tab, lib_q = ref.flip(tab), ref.flip(qs)
        record("searchsorted", [n, q, side],
               (searchsorted(tab, qs, side),),
               (ref.lower_bound(tab, qs, side),),
               cuda_ms(torch, lambda: searchsorted(tab, qs, side), 20),
               cuda_ms(torch, lambda: ref.lower_bound(tab, qs, side), 3),
               cuda_ms(torch, lambda: torch.searchsorted(
                   lib_tab, lib_q, side=side), 20),
               touched_rows(n, q) * 8 + q * 16, q * (depth + 1) * 6)

    # segsum: a Δ-sized stream and a table-sized one, PK-shaped (runs of
    # equal keys whose row signatures differ, signs +-1; segsum_split
    # checks and times the main path's own shapes)
    for n in (200_000, SF1_ROWS):
        args = segsum_inputs(torch, g, n)
        record("segsum_diff", [n], segsum(*args), ref.segsum(*args),
               cuda_ms(torch, lambda: segsum(*args), 20),
               cuda_ms(torch, lambda: ref.segsum(*args), 5),
               None, *segsum_bound(n, True))
        results["segsum_diff"][-1].update(
            launch_times(torch, lambda: segsum(*args), SEGSUM_FOCUS))
        del args
    torch.cuda.synchronize()
    results["flash_attention"] = flash_phase(torch, seed) \
        + flash_window_phase(torch, seed) \
        + flash_phase(torch, seed, FLASH_JAMBA_SHAPES) \
        + flash_phase(torch, seed, FLASH_CROSS_SHAPES) \
        + flash_phase(torch, seed, FLASH_RANK_SHAPES)
    results["flash_attention_bwd"] = bwd_phase(torch, seed)
    return results


def attention_pairs(sq: int, sk: int, causal: bool) -> int:
    """Unmasked (query, key) pairs: top-left causal or all pairs."""
    if not causal:
        return sq * sk
    full = min(sq, sk)              # rows 0..full-1 see i + 1 keys
    return full * (full + 1) // 2 + (sq - full) * sk


def flash_close(torch, got, want):
    """(within FLASH_TOL and FLASH_REL_TOL, max abs error, rel-L2 error)."""
    err = float((got - want).abs().max())
    rel = float((got - want).norm() / want.norm())
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got, want, atol=FLASH_TOL, rtol=FLASH_TOL) and rel <= FLASH_REL_TOL
    return ok, err, rel


def flash_phase(torch, seed: int, shapes=FLASH_SHAPES,
                tiles: bool = False) -> list:
    """The flash kernel against its plain version (bf16, FLASH_TOL) and
    scaled_dot_product_attention (timed only) at ``shapes``: CUDA-event
    time over back-to-back launches (as every kernel here), the device
    time of the kernel and of SDPA from a profiler trace, TFLOP/s, and
    the launch configuration, and the plain version's time; ``tiles``
    also checks and times the kernel with each CTA tile forced
    (64 and 128 query rows), which tests its choice of tile."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import config, flash_attention
    sdpa = torch.nn.functional.scaled_dot_product_attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rows, bad = [], []

    for b, sq, sk, h, kv, hd, causal in shapes:
        q = torch.randn((b, sq, h, hd), generator=g, device=dev).bfloat16()
        k = torch.randn((b, sk, kv, hd), generator=g, device=dev).bfloat16()
        v = torch.randn((b, sk, kv, hd), generator=g, device=dev).bfloat16()
        got = flash_attention(q, k, v, causal=causal).float()
        want = ref.attention(q, k, v, causal=causal, block=256).float()
        ok, err, rel = flash_close(torch, got, want)
        lost_mask = None
        if sk % FLASH_BLOCK_N:  # the zero-filled key tail, left unmasked
            pad = (0, 0, 0, 0, 0, -sk % FLASH_BLOCK_N)
            lost_mask = float((ref.attention(
                q, torch.nn.functional.pad(k, pad),
                torch.nn.functional.pad(v, pad), causal=causal,
                block=256).float() - want).norm() / want.norm())
            check(lost_mask > FLASH_REL_TOL,
                  f"a lost key mask ({lost_mask}) would pass "
                  f"FLASH_REL_TOL at {sk} keys")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_err = float((sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
                         .transpose(1, 2).float() - want).abs().max())
        flops = 4.0 * b * h * hd * attention_pairs(sq, sk, causal)
        nbytes = 2 * (2 * b * sq * h * hd + 2 * b * sk * kv * hd)
        b_ms, b_by = bound(nbytes, 0, flops)

        def run(block_m=None):
            return flash_attention(q, k, v, causal=causal, block_m=block_m)

        def lib():
            return sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
        ms = cuda_ms(torch, run, 20)
        dev_ms = per_launch_ms(torch, run, "flash_fwd")
        # every kernel SDPA launches (the trace holds nothing else)
        lib_dev_ms = per_launch_ms(torch, lib, "")
        by_tile = {}
        for bm in ((64, 128) if tiles else ()):
            t_ok, t_err, t_rel = flash_close(torch, run(bm).float(), want)
            ok = ok and t_ok
            by_tile[str(bm)] = {"ok": t_ok, "max_abs_err": t_err,
                                "rel_l2_err": t_rel,
                                "device_ms": per_launch_ms(
                                    torch, lambda: run(bm), "flash_fwd")}
        rows.append({
            "shape": [b, sq, sk, h, kv, hd, "causal" if causal else "all"],
            "ok": ok, "tol": FLASH_TOL, "rel_tol": FLASH_REL_TOL,
            "max_abs_err": err, "rel_l2_err": rel,
            "lost_mask_rel_l2": lost_mask,
            "library_max_abs_err": lib_err,
            "ms": ms, "tflops": flops / ms / 1e9,
            "device_ms": dev_ms,
            "device_tflops": flops / dev_ms / 1e9 if dev_ms else None,
            "plain_ms": cuda_ms(torch, lambda: ref.attention(
                q, k, v, causal=causal, block=256), 3),
            "library_ms": cuda_ms(torch, lib, 20),
            "library_device_ms": lib_dev_ms,
            "device_vs_library": dev_ms / lib_dev_ms
            if dev_ms and lib_dev_ms else None,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "flops": flops, "config": config(b, sq, h, hd, dev),
            "by_block_m": by_tile})
        if not ok:
            bad.append((rows[-1]["shape"], err, rel))
        del q, k, v, qt, kt, vt, got, want
    check(not bad, f"flash_attention differs from its plain version "
                   f"beyond {FLASH_TOL} abs or {FLASH_REL_TOL} rel-L2 "
                   f"(shape, max abs, rel-L2): {bad}")
    return rows


def window_pairs(sq: int, sk: int, window: int) -> int:
    """Unmasked (query, key) pairs of top-left causal attention in a
    sliding window: query i sees keys max(0, i - W + 1) .. min(i, Sk - 1)."""
    return sum(max(0, min(i, sk - 1) - max(0, i - window + 1) + 1)
               for i in range(sq))


def flash_window_phase(torch, seed: int,
                       shapes=FLASH_WINDOW_SHAPES) -> list:
    """The flash kernel with a sliding window against its plain version
    (``ref.attention(window=)``, bf16, FLASH_TOL and FLASH_REL_TOL), for
    serving's instance and the LSE instance (LSE within LSE_TOL, the
    outputs of both equal); at W >= Sq both must equal the unwindowed
    kernel bit for bit. Each row has the kernel's CUDA-event and device
    time, the unwindowed kernel's device time at the shape, the LSE
    instance's, a bound that counts only the in-window pairs, and
    scaled_dot_product_attention with an explicit boolean band mask (K
    and V repeated to the query heads first, outside the timing) as the
    library call."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import config, flash_attention
    sdpa = torch.nn.functional.scaled_dot_product_attention

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rows, bad = [], []

    for b, sq, sk, h, kv, hd, w in shapes:
        q = torch.randn((b, sq, h, hd), generator=g, device=dev).bfloat16()
        k = torch.randn((b, sk, kv, hd), generator=g, device=dev).bfloat16()
        v = torch.randn((b, sk, kv, hd), generator=g, device=dev).bfloat16()
        got, lse = flash_attention(q, k, v, window=w, return_lse=True)
        want, want_lse = ref.attention_lse(q, k, v, window=w, block=256)
        ok, err, rel = flash_close(torch, got.float(), want.float())
        lse_err = float((lse - want_lse).abs().max())
        same = torch.equal(got, flash_attention(q, k, v, window=w))
        ok = ok and lse_err <= LSE_TOL and same
        bits = None
        if w >= sq:
            bits = torch.equal(got, flash_attention(q, k, v)) and all(
                torch.equal(x, y) for x, y in zip(
                    (got, lse), flash_attention(q, k, v, return_lse=True)))
            ok = ok and bits
        qt = q.transpose(1, 2)
        kt, vt = (x.transpose(1, 2).repeat_interleave(h // kv, dim=1)
                  for x in (k, v))
        i = torch.arange(sq, device=dev)[:, None]
        j = torch.arange(sk, device=dev)[None, :]
        band = (i >= j) & (i - j < w)
        lib_err = float((sdpa(qt, kt, vt, attn_mask=band).transpose(1, 2)
                         .float() - want.float()).abs().max())
        pairs = window_pairs(sq, sk, w)
        flops = 4.0 * b * h * hd * pairs
        # q and o once; the keys and values that some row's window holds
        nbytes = 2 * (2 * b * sq * h * hd + 2 * b * sk * kv * hd)
        b_ms, b_by = bound(nbytes, 0, flops)

        def run():
            return flash_attention(q, k, v, window=w)

        def lib():
            return sdpa(qt, kt, vt, attn_mask=band)
        ms = cuda_ms(torch, run, 20)
        dev_ms = per_launch_ms(torch, run, "flash_fwd")
        lib_dev_ms = per_launch_ms(torch, lib, "")
        rows.append({
            "shape": [b, sq, sk, h, kv, hd, "causal", f"window {w}"],
            "ok": ok, "tol": FLASH_TOL, "rel_tol": FLASH_REL_TOL,
            "max_abs_err": err, "rel_l2_err": rel, "lse_max_abs_err": lse_err,
            "lse_tol": LSE_TOL, "serve_equals_lse_instance": same,
            "bit_equal_unwindowed": bits,
            "library_max_abs_err": lib_err,
            "ms": ms, "tflops": flops / ms / 1e9,
            "device_ms": dev_ms,
            "device_tflops": flops / dev_ms / 1e9 if dev_ms else None,
            "lse_device_ms": per_launch_ms(torch, lambda: flash_attention(
                q, k, v, window=w, return_lse=True), "flash_fwd"),
            "unwindowed_device_ms": per_launch_ms(
                torch, lambda: flash_attention(q, k, v), "flash_fwd"),
            "plain_ms": cuda_ms(torch, lambda: ref.attention(
                q, k, v, window=w, block=256), 3),
            "library_ms": cuda_ms(torch, lib, 20),
            "library_device_ms": lib_dev_ms,
            "library_is": "scaled_dot_product_attention with a boolean "
                          "band mask, K and V repeated to H heads",
            "device_vs_library": dev_ms / lib_dev_ms
            if dev_ms and lib_dev_ms else None,
            "pairs": pairs, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops,
            "config": config(b, sq, h, hd, dev)})
        if not ok:
            bad.append((rows[-1]["shape"], err, rel, lse_err, same, bits))
        del q, k, v, qt, kt, vt, got, want, lse, want_lse, band
    check(not bad, f"windowed flash_attention differs from its plain "
                   f"version (shape, max abs, rel-L2, LSE, serve = LSE "
                   f"instance, bits at W >= Sq): {bad}")
    return rows


def bwd_bytes(b, sq, sk, h, kv, hd) -> int:
    """Bytes the backward must move: q, o, dO and k, v read once (bf16),
    the LSE read once (float32), dq, dk, dv written once (bf16)."""
    return 2 * (4 * b * sq * h * hd + 4 * b * sk * kv * hd) + 4 * b * h * sq


def plain_bwd(torch, q, k, v, o, lse, do, causal, window=None):
    """ref.attention_bwd, KV head by KV head when its float32 scores would
    pass PLAIN_BWD_BYTES (each KV head's query heads, lse rows and key
    columns alone: the heads do not mix)."""
    from repro_torch.kernels import ref
    b, sq, h, _ = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if 4 * b * h * sq * sk <= PLAIN_BWD_BYTES:
        return ref.attention_bwd(q, k, v, o, lse, do, causal=causal,
                                 window=window)
    g = h // kv
    parts = [ref.attention_bwd(
        q[:, :, j * g:(j + 1) * g], k[:, :, j:j + 1], v[:, :, j:j + 1],
        o[:, :, j * g:(j + 1) * g], lse[:, j * g:(j + 1) * g].contiguous(),
        do[:, :, j * g:(j + 1) * g], causal=causal, window=window)
        for j in range(kv)]
    return tuple(torch.cat(x, dim=2) for x in zip(*parts))


def plain_bf16_grads(torch, q, k, v, do, causal=True, window=None):
    """dq, dk, dv of the plain bf16 path: autograd through ref.attention
    on the bf16 inputs (P and each product rounded to bf16 where it
    rounds them)."""
    from repro_torch.kernels import ref
    x = [t.detach().requires_grad_() for t in (q, k, v)]
    out = ref.attention(*x, causal=causal, block=256, window=window)
    return torch.autograd.grad(out, x, do)


def group_close(torch, got, want, causal=True, window=None, q=None, k=None,
                v=None, do=None) -> dict:
    """dk and dv (``got[1:]``) against ``want`` for a group above
    BWD_GROUP_ELEMENTWISE: each within BWD_REL_TOL and no further from
    ``want`` at its worst element than the plain bf16 path is."""
    plain = plain_bf16_grads(torch, q, k, v, do, causal, window)
    out = {}
    for n, x, p, wt in zip(("dk", "dv"), got[1:], plain[1:], want[1:]):
        err = float((x.float() - wt).abs().max())
        p_err = float((p.float() - wt).abs().max())
        rel = float((x.float() - wt).norm() / wt.norm())
        out[n] = {"max_abs_err": err, "plain_bf16_max_abs_err": p_err,
                  "rel_l2_err": rel,
                  "close": err <= p_err and rel <= BWD_REL_TOL}
    return out


def bwd_phase(torch, seed: int, shapes=BWD_ROWS) -> list:
    """The flash backward against its plain version at ``shapes`` (B, Sq,
    Sk, H, KV, hd, causal[, window]): dq, dk and dv within FLASH_TOL and
    BWD_REL_TOL, the forward's LSE within LSE_TOL, two launches bitwise
    equal, a planted mask fault (the causal mask, the window, or the key
    tail lost) shown to exceed BWD_REL_TOL, at W >= Sq the unwindowed
    kernel's bits, the kernel's event and device time, TFLOP/s, its bound
    (2.5 x the forward's tensor FLOPs over the unmasked pairs), the plain
    version's time (KV head by KV head where its scores would not fit:
    ``plain_by_kv_head``), SDPA's backward through autograd on the same
    inputs (under a window with a boolean band mask, K and V repeated to
    H heads), and the launch configuration. ``forward_lse`` times the
    forward that the training step runs before it (the LSE stored)
    beside its bound and SDPA's forward. Above BWD_GROUP_ELEMENTWISE
    query heads a KV head, dk and dv are held by ``group_close``."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_bwd import (config,
                                                         flash_attention_bwd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    rows, bad = [], []

    def rel(got, want):
        return float((got.float() - want).norm() / want.norm())

    for shape in shapes:
        b, sq, sk, h, kv, hd, causal, *win = shape
        w = win[0] if win else None
        q = torch.randn((b, sq, h, hd), generator=g, device=dev).bfloat16()
        k = torch.randn((b, sk, kv, hd), generator=g, device=dev).bfloat16()
        v = torch.randn((b, sk, kv, hd), generator=g, device=dev).bfloat16()
        do = torch.randn((b, sq, h, hd), generator=g, device=dev).bfloat16()
        o, lse = flash_attention(q, k, v, causal=causal, return_lse=True,
                                 window=w)
        lse_err = float((lse - ref.attention_lse(
            q, k, v, causal=causal, block=256, window=w)[1]).abs().max())

        def run():
            return flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                       window=w)
        before = build.LAUNCHES["flash_attention_bwd"]
        got, again = run(), run()
        launched = build.LAUNCHES["flash_attention_bwd"] - before
        want = plain_bwd(torch, q, k, v, o, lse, do, causal, w)
        by_kv_head = 4 * b * h * sq * sk > PLAIN_BWD_BYTES
        torch.cuda.synchronize()
        same_bits = all(torch.equal(x, y) for x, y in zip(got, again))
        bits = None
        if w is not None and w >= sq:
            bits = all(torch.equal(x, y) for x, y in zip(
                got, flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=causal)))
        errs = {n: {"max_abs_err": float((x.float() - wt).abs().max()),
                    "rel_l2_err": rel(x, wt),
                    "close": bool(torch.allclose(x.float(), wt,
                                                 atol=FLASH_TOL,
                                                 rtol=FLASH_TOL))}
                for n, x, wt in zip(("dq", "dk", "dv"), got, want)}
        if h // kv > BWD_GROUP_ELEMENTWISE:
            for n, e in group_close(torch, got, want, causal, w, q, k, v,
                                    do).items():
                errs[n].update(e, elementwise_close=errs[n]["close"])
        # the planted fault: a lost window, a lost causal mask, or (all
        # pairs) the zero-filled key tail of the kernel's last tile left
        # unmasked
        if w is not None and w < sq:
            faulty = plain_bwd(torch, q, k, v, o, lse, do, causal)
            fault = "window lost"
        elif causal:
            faulty = plain_bwd(torch, q, k, v, o, lse, do, False)
            fault = "causal mask lost"
        else:
            pad = (0, 0, 0, 0, 0, -sk % BWD_TILE)
            kp, vp = (torch.nn.functional.pad(x, pad) for x in (k, v))
            op, lp = ref.attention_lse(q, kp, vp, causal=False, block=256)
            faulty = ref.attention_bwd(q, kp, vp, op, lp, do, causal=False)
            fault = f"key mask lost ({-sk % BWD_TILE} zero keys)"
        fault_rel = rel(faulty[0], want[0])
        del faulty
        check(fault_rel > BWD_REL_TOL, f"a planted mask fault ({fault}: "
              f"{fault_rel}) would pass BWD_REL_TOL")
        ok = (same_bits and lse_err <= LSE_TOL and launched == 2
              and bits is not False
              and all(e["close"] and e["rel_l2_err"] <= BWD_REL_TOL
                      for e in errs.values())
              and all(bool(torch.isfinite(x).all()) for x in got))
        pairs = window_pairs(sq, sk, w) if w is not None \
            else attention_pairs(sq, sk, causal)
        flops = 10.0 * b * h * hd * pairs
        nbytes = bwd_bytes(b, sq, sk, h, kv, hd)
        b_ms, b_by = bound(nbytes, 0, flops)
        ms = cuda_ms(torch, run, 20)
        dev_ms = per_launch_ms(torch, run, "attn_bwd", 10)
        # SDPA's backward through autograd on the same inputs: GQA in
        # place, or under a window a boolean band mask with K and V
        # repeated to H heads (SDPA takes no window)
        qt = q.transpose(1, 2).detach().requires_grad_()
        if w is None:
            kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (k, v))
            kw = dict(is_causal=causal, enable_gqa=True)
        else:
            kt, vt = (x.transpose(1, 2).repeat_interleave(h // kv, dim=1)
                      .detach().requires_grad_() for x in (k, v))
            i = torch.arange(sq, device=dev)[:, None]
            j = torch.arange(sk, device=dev)[None, :]
            kw = dict(attn_mask=(i >= j) & (i - j < w))
        out = sdpa(qt, kt, vt, **kw)
        dot = do.transpose(1, 2)

        def lib():
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)
        lib_g = lib()
        if w is not None:       # the repeated heads' gradients, summed
            lib_g = (lib_g[0],) + tuple(
                x.reshape(b, kv, h // kv, sk, hd).sum(2) for x in lib_g[1:])
        lib_err = max(float((x.transpose(1, 2).float() - wt).abs().max())
                      for x, wt in zip(lib_g, want))
        del lib_g

        def fwd():
            return flash_attention(q, k, v, causal=causal, return_lse=True,
                                   window=w)

        def lib_fwd():
            with torch.no_grad():
                return sdpa(qt, kt, vt, **kw)
        # q, k, v read and o written (bf16), the LSE written (float32);
        # S and P.V: 4 FLOPs a pair and hd
        f_ms, f_by = bound(2 * (2 * b * sq * h * hd + 2 * b * sk * kv * hd)
                           + 4 * b * h * sq, 0, 4.0 * b * h * hd * pairs)
        forward_lse = {"ms": cuda_ms(torch, fwd, 20),
                       "device_ms": per_launch_ms(torch, fwd, "flash_fwd",
                                                  10),
                       "plain_ms": cuda_ms(torch, lambda: ref.attention_lse(
                           q, k, v, causal=causal, block=256, window=w), 3),
                       "bound_ms": f_ms, "bound_by": f_by,
                       "library_ms": cuda_ms(torch, lib_fwd, 20),
                       "library_device_ms": per_launch_ms(torch, lib_fwd,
                                                          "", 10)}
        rows.append({
            "shape": [b, sq, sk, h, kv, hd, "causal" if causal else "all"]
            + ([f"window {w}"] if w is not None else []),
            "ok": ok, "tol": FLASH_TOL, "rel_tol": BWD_REL_TOL,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "grads": errs, "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL,
            "bitwise_deterministic": same_bits,
            "bit_equal_unwindowed": bits,
            "planted_fault": fault, "planted_fault_rel_l2": fault_rel,
            "library_max_abs_err": lib_err,
            "library_is": "scaled_dot_product_attention's backward through "
                          "autograd" + ("" if w is None else
                                        ", a boolean band mask, K and V "
                                        "repeated to H heads"),
            "ms": ms, "tflops": flops / ms / 1e9, "device_ms": dev_ms,
            "device_tflops": flops / dev_ms / 1e9 if dev_ms else None,
            "plain_ms": cuda_ms(torch, lambda: plain_bwd(
                torch, q, k, v, o, lse, do, causal, w), 3),
            "plain_by_kv_head": by_kv_head,
            "library_ms": cuda_ms(torch, lib, 20),
            "library_device_ms": per_launch_ms(torch, lib, "", 10),
            "pairs": pairs, "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / dev_ms if dev_ms else None,
            "bytes": nbytes, "flops": flops, "config": config(hd, dev),
            "forward_lse": forward_lse})
        if not ok:
            bad.append((rows[-1]["shape"], errs, lse_err, same_bits, bits))
        del q, k, v, do, o, lse, got, again, want, qt, kt, vt, out
        torch.cuda.empty_cache()
    check(not bad, f"flash_attention_bwd differs from its plain version "
                   f"beyond {FLASH_TOL} abs or {BWD_REL_TOL} rel-L2, or its "
                   f"LSE beyond {LSE_TOL}, or two launches differ, or at "
                   f"W >= Sq it leaves the unwindowed kernel's bits: {bad}")
    return rows


def hopper_sass(build) -> dict:
    """Counts of wgmma (HGMMA), TMA load (UTMALDG) and, in the backward,
    TMA store and reduce (UTMASTG, UTMAREDG) and mma.sync (HMMA)
    instructions in the built attention libraries' SASS (``cuobjdump
    -sass``); fails without wgmma and TMA loads in either, or with an
    mma.sync left in the backward."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    counts = {}
    for name, ops in (("flash_attention", ("HGMMA", "UTMALDG")),
                      ("flash_attention_bwd", ("HGMMA", "UTMALDG", "UTMASTG",
                                               "UTMAREDG", "HMMA"))):
        lib = build._lib_path(name)
        sass = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        counts[name] = {op: len(re.findall(rf"\b{op}\b", sass))
                        for op in ops}
        check(counts[name]["HGMMA"] and counts[name]["UTMALDG"],
              f"{lib.name} lacks Hopper's wgmma or TMA instructions: "
              f"{counts[name]}")
    check(not counts["flash_attention_bwd"]["HMMA"],
          f"the backward still runs mma.sync: {counts}")
    return counts


# ----------------------------------------------------------------- mainpath

def device_profile(torch, fn, focus: str = "flash_fwd") -> dict:
    """Device busy time under ``fn`` from a torch.profiler trace: the sum
    of kernel time on the card over the host wall time of the window
    (one stream, so kernels do not overlap), with the largest kernels and
    the time and count of the kernels whose name holds ``focus`` (None:
    no focus, its fields None). The trace holds the card's activity only:
    tracing the host's operators as well stretched a host-bound window
    (rwkv6-7b's training step from 3.3 to 5.4 s, which lowers its busy
    share) and took ~50 s to assemble its ~450k events."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kern) / 1e6
    top = sorted(kern, key=dev_us, reverse=True)[:8]
    mine = [e for e in kern if focus is not None and focus in e.key]
    copies = [e for e in kern if "DtoH" in e.key]
    return {"wall_s": wall,
            "dtoh_copies": sum(e.count for e in copies),
            "focus": focus,
            "focus_ms": None if focus is None
            else sum(dev_us(e) for e in mine) / 1e3,
            "focus_count": None if focus is None
            else sum(e.count for e in mine),
            "device_busy_s": busy if kern else None,
            "busy_share": busy / wall if kern else None,
            "top_kernels": [{"name": e.key[:80], "ms": dev_us(e) / 1e3,
                             "count": e.count} for e in top]}


#: every per_launch_ms reading: its focus, its calls, the focus kernels'
#: launches in one call, the traces it took and whether one was complete
DEVICE_READINGS = []


def per_launch_ms(torch, fn, focus: str, iters: int = 20):
    """Device ms of one call of ``fn`` from a trace of ``iters`` calls:
    the kernels whose name holds ``focus`` (every kernel for ""). A trace
    counts only when it is complete, holding ``iters`` times the launches
    that a trace of one call holds: late in a long process, most of the
    doors' and tiers' rowhash traces once held none of theirs, and a trace
    that lost some would read too low. Up to three pairs of traces are
    taken; None means that none was complete. Each reading is logged in
    DEVICE_READINGS."""
    reading = {"focus": focus, "iters": iters, "per_call": None,
               "traces": 0, "complete": False}
    DEVICE_READINGS.append(reading)
    for _ in range(3):
        reading["traces"] += 1
        one = device_profile(torch, fn, focus=focus)["focus_count"]
        prof = device_profile(torch, lambda: [fn() for _ in range(iters)],
                              focus=focus)
        reading["per_call"] = one
        if one and prof["focus_count"] == one * iters:
            reading["complete"] = True
            return prof["focus_ms"] / iters
    return None


def span_summary(tracer) -> list:
    """Top-level telemetry spans with their direct children (host wall
    time; the work inside them synchronizes at data-dependent branches)."""
    return [{"span": s.name, "ms": s.dur_s * 1e3,
             "children": [{"span": c.name, "ms": c.dur_s * 1e3}
                          for c in s.children]} for s in tracer.roots]


@contextlib.contextmanager
def kernel_shapes(ops, entry: str, shape_of):
    """Count the launches of the kernel entry ``ops.<entry>`` inside the
    block by ``shape_of(*args)``, None where the wrapper does not launch:
    wraps the entry, which every caller in the package goes through. The
    package's own count, ``build.LAUNCHES``, stays plain."""
    hist = collections.Counter()
    kernel = getattr(ops, entry)

    def counted(*args, **kwargs):
        shape = shape_of(*args)
        if shape is not None:
            hist[shape] += 1
        return kernel(*args, **kwargs)
    setattr(ops, entry, counted)
    try:
        yield hist
    finally:
        setattr(ops, entry, kernel)


def table_queries(q_arg: int):
    """(table rows, queries) of a lookup launch, the table being the
    entry's first argument and the queries its ``q_arg``-th; None unless
    it launches (a CUDA query, neither side empty)."""
    def shape_of(*args):
        tab, q = args[0], args[q_arg]
        if q.device.type == "cuda" and q.shape[0] and tab.shape[0]:
            return int(tab.shape[0]), int(q.shape[0])
        return None
    return shape_of


def searchsorted_shapes(ops):
    """searchsorted's launches by (table rows, queries) through its
    one-side entry: every lower/upper bound and searchsorted128 of the
    package."""
    return kernel_shapes(ops, "_searchsorted_kernel", table_queries(1))


def window_shapes(ops):
    """searchsorted's launches by (table rows, queries) through its
    per-query-side entry: the zone windows of one sorted probe call."""
    return kernel_shapes(ops, "_searchsorted_sides_kernel", table_queries(1))


def probe_shapes(ops):
    """probe's launches by (table rows, queries): every probe128."""
    return kernel_shapes(ops, "_probe_kernel", table_queries(2))


def segsum_shapes(ops):
    """segsum's launches by (stream rows, with the row pair): every scan
    of diff_aggregate and diff_aggregate_rows."""
    def shape_of(lo, hi, signs, r_lo=None, r_hi=None):
        if lo.device.type == "cuda" and lo.shape[0]:
            return int(lo.shape[0]), r_lo is not None
        return None
    return kernel_shapes(ops, "_segsum_kernel", shape_of)


@contextlib.contextmanager
def path_shapes(ops):
    """The four shape recorders of a VCS window at once: searchsorted's
    one-side entry, its zone windows, probe and segsum."""
    with searchsorted_shapes(ops) as shapes, window_shapes(ops) as wshapes, \
            probe_shapes(ops) as pshapes, segsum_shapes(ops) as sshapes:
        yield shapes, wshapes, pshapes, sshapes


def shape_record(launches: dict, shapes, wshapes, pshapes,
                 sshapes) -> dict:
    """A window's launches by shape, as lists of [shape..., launches];
    fails unless each kernel's shapes sum to its ``build.LAUNCHES``."""
    for name, hist in (("searchsorted", shapes + wshapes),
                       ("probe", pshapes), ("segsum_diff", sshapes)):
        check(sum(hist.values()) == launches[name],
              f"{name} shapes count {sum(hist.values())} launches, "
              f"the wrapper {launches[name]}")
    return {"zone_window_launches": sum(wshapes.values()),
            "zone_window_shapes": [[n, q, c] for (n, q), c in
                                   sorted(wshapes.items())],
            "searchsorted_shapes": [[n, q, c] for (n, q), c in
                                    sorted((shapes + wshapes).items())],
            "probe_shapes": [[n, q, c] for (n, q), c in
                             sorted(pshapes.items())],
            "segsum_shapes": [[n, pair, c] for (n, pair), c in
                              sorted(sshapes.items())]}


def shape_hist(recs: list, key: str) -> collections.Counter:
    """Launches by shape summed over records of ``shape_record``."""
    hist = collections.Counter()
    for rec in recs:
        hist.update({tuple(e[:-1]): e[-1] for e in rec[key]})
    return hist


def split_by_queries(hist: collections.Counter, groups=SEARCH_GROUPS):
    """A kernel's main-path launches, a (table rows, queries) -> launches
    count, in ``groups`` by query count: each group's launches, shapes
    and commonest shape; and the shapes at which to hold the kernel
    against its plain version: the commonest of all first, each group's
    commonest, then the largest table's commonest."""
    def commonest(shapes):
        return max(shapes.items(), key=lambda kv: (kv[1], kv[0]))[0]
    split, checks = [], [commonest(hist)] if hist else []
    for name, lo, hi in groups:
        shapes = {k: c for k, c in hist.items()
                  if k[1] >= lo and (hi is None or k[1] <= hi)}
        top = sorted(shapes.items(), key=lambda kv: (kv[1], kv[0]),
                     reverse=True)
        split.append({"group": name, "launches": sum(shapes.values()),
                      "distinct_shapes": len(shapes),
                      "top_shapes": [[n, q, c] for (n, q), c in top[:5]],
                      "timed_shape": list(top[0][0]) if top else None})
        if top:
            checks.append(top[0][0])
    if hist:
        largest = max(n for n, _ in hist)
        checks.append(commonest({k: c for k, c in hist.items()
                                 if k[0] == largest}))
    return split, list(dict.fromkeys(checks))


def launch_times(torch, fn, focus: str) -> dict:
    """The kernel's device time per launch from a profiler trace of 20
    calls (``focus``: the kernel's own name), all device work per call in
    that trace (a memset or a second kernel of the call included), and
    the host time of one call that ends in a synchronize."""
    t0 = time.perf_counter()
    for _ in range(20):
        fn()
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    prof = device_profile(torch, lambda: [fn() for _ in range(20)],
                          focus=focus)
    return {"device_ms": (prof["focus_ms"] / prof["focus_count"]
                          if prof["focus_count"] else None),
            "device_ms_all": (prof["device_busy_s"] * 1e3 / 20
                              if prof["device_busy_s"] else None),
            "host_ms_synced": host_ms}


def time_groups(groups: list, timed: dict) -> list:
    """Each group with its commonest shape's times (``timed``: shape ->
    kernel row) and its launches times them."""
    for grp in groups:
        if grp["timed_shape"] is None:
            continue
        row = timed[tuple(grp["timed_shape"])]
        grp.update({f: row[f] for f in ("ms", "device_ms", "host_ms_synced",
                                        "bound_ms", "bound_by")})
        grp.update({"launches_x_ms": grp["launches"] * row["ms"],
                    "launches_x_host_ms": grp["launches"]
                    * row["host_ms_synced"]})
    return groups


def searchsorted_split(torch, hist: collections.Counter, seed: int,
                       windows: collections.Counter = None):
    """The kernel at the main path's own searchsorted shapes
    (``split_by_queries``): at each, both sides EXACTLY equal to the
    plain version, with CUDA-event times of the kernel, the plain version
    and ``torch.searchsorted``, the bound of that shape (the table words
    its descents can touch, queries and results once), and for the left
    side the kernel's device time from a profiler trace and the host time
    of one launch that ends in a synchronize (what a zone-window launch
    pays before its ``.tolist()``), and the per-query-side entry with the
    first half of the queries left, the rest right, as the zone windows
    call it, with the same device and host times. ``windows``, the zone
    windows' own launches, adds their commonest shape to the checks.
    Returns the groups, each with its commonest shape's times, and the
    kernel rows, commonest shape first."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.searchsorted import (searchsorted,
                                                  searchsorted_sides)

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def words(n):
        w = random_words(torch, g, n)
        return ref.flip(torch.sort(w).values).contiguous()

    groups, checks = split_by_queries(hist)
    if windows:
        top = max(windows.items(), key=lambda kv: (kv[1], kv[0]))[0]
        checks = list(dict.fromkeys(checks + [top]))
    rows, timed = [], {}
    for n, q in checks:
        tab, qs = words(n), words(q)
        lib_tab, lib_q = ref.flip(tab), ref.flip(qs)
        depth = max(1, math.ceil(math.log2(n)))
        for side in ("left", "right"):
            rows.append(kernel_row(
                torch, "searchsorted", [n, q, side],
                (searchsorted(tab, qs, side),),
                (ref.lower_bound(tab, qs, side),),
                cuda_ms(torch, lambda: searchsorted(tab, qs, side), 20),
                cuda_ms(torch, lambda: ref.lower_bound(tab, qs, side), 3),
                cuda_ms(torch, lambda: torch.searchsorted(
                    lib_tab, lib_q, side=side), 20),
                touched_rows(n, q) * 8 + q * 16, q * (depth + 1) * 6))
        rows[-2].update(launch_times(torch, lambda: searchsorted(tab, qs),
                                     "bound_kernel"))
        timed[(n, q)] = rows[-2]
        # the per-query-side entry: the first half left, the rest right
        # (no single library call takes a side per query)
        k = q // 2
        rows.append(kernel_row(
            torch, "searchsorted", [n, q, f"sides {k}/{q - k}"],
            (searchsorted_sides(tab, qs, k),),
            (ref.lower_bound_sides(tab, qs, k),),
            cuda_ms(torch, lambda: searchsorted_sides(tab, qs, k), 20),
            cuda_ms(torch, lambda: ref.lower_bound_sides(tab, qs, k), 3),
            None, touched_rows(n, q) * 8 + q * 16, q * (depth + 1) * 6))
        rows[-1].update(launch_times(
            torch, lambda: searchsorted_sides(tab, qs, k), "bound_kernel"))
        del tab, qs, lib_tab, lib_q
    return time_groups(groups, timed), rows


def probe_split(torch, hist: collections.Counter, seed: int):
    """The probe kernel at the main path's own shapes (``split_by_queries``
    over PROBE_GROUPS): at each, EXACTLY equal to the plain version, with
    CUDA-event times of the kernel and the plain version, its device time
    from a profiler trace, the host time of one launch that ends in a
    synchronize, and the bound of that shape (the table rows its descents
    can touch, queries and results once, 16 bytes each). Returns the
    groups, each with its commonest shape's times, and the kernel rows,
    commonest shape first."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.probe import probe

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    groups, checks = split_by_queries(hist, PROBE_GROUPS)
    rows, timed = [], {}
    for n, q in checks:
        args = probe_inputs(torch, g, n, q)
        depth = max(1, math.ceil(math.log2(n)))
        row = kernel_row(
            torch, "probe", [n, q], probe(*args), ref.probe(*args),
            cuda_ms(torch, lambda: probe(*args), 20),
            cuda_ms(torch, lambda: ref.probe(*args), 3), None,
            touched_rows(n, q) * 16 + q * 32, q * (depth + 1) * 2 * 10)
        row.update(launch_times(torch, lambda: probe(*args), "probe_kernel"))
        rows.append(row)
        timed[(n, q)] = row
        del args
    return time_groups(groups, timed), rows


def segsum_split(torch, hist: collections.Counter, seed: int,
                 change: int) -> list:
    """The segsum kernel at every one of the main path's own shapes
    (``hist``: (stream rows, with the row pair) -> launches), the
    commonest first, each with its roles: the commonest, the largest and
    the Δ-sized one (nearest 2 x ``change`` rows). At each, EXACTLY equal
    to the plain version, with CUDA-event times of the kernel, the plain
    version and, as ``scan_half_ms``, torch.cumsum of the signs
    (SCAN_HALF; no library call computes the same function), the kernel's
    device time and all device work per call from a profiler trace, the
    host time of one call that ends in a synchronize, the bound and the
    launches at that shape times the event time. Returns the kernel rows,
    commonest shape first."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segsum_diff import segsum

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    shapes = sorted(hist, key=lambda s: (hist[s], s), reverse=True)
    roles = {s: [] for s in shapes}
    roles[shapes[0]].append("commonest")
    roles[max(hist)].append("largest")
    roles[min(hist, key=lambda s: (abs(s[0] - 2 * change), s))].append(
        "delta")
    rows = []
    for (n, pair), role in roles.items():
        args = segsum_inputs(torch, g, n, pair)
        sg = args[2]
        row = kernel_row(
            torch, "segsum_diff", [n, "row pair" if pair else "key only"],
            segsum(*args), ref.segsum(*args),
            cuda_ms(torch, lambda: segsum(*args), 20),
            cuda_ms(torch, lambda: ref.segsum(*args), 5),
            None, *segsum_bound(n, pair))
        row.update(launch_times(torch, lambda: segsum(*args), SEGSUM_FOCUS))
        launches = hist[(n, pair)]
        row.update({"roles": role, "scan_half_is": SCAN_HALF,
                    "scan_half_ms": cuda_ms(torch, lambda: torch.cumsum(
                        sg, 0, dtype=torch.int32), 20),
                    "launches": launches,
                    "launches_x_ms": launches * row["ms"]})
        rows.append(row)
        del args, sg
    return rows


def exact_sweep(torch, hists: dict, seed: int,
                device: str = "cuda") -> dict:
    """Every distinct shape of a path's launches held EXACTLY against the
    plain version on random inputs of that shape. ``hists``: kernel ->
    shape -> launches, for "searchsorted" (table rows, queries; both
    sides), "zone_windows" (the per-query-side entry, the first half of
    the queries left), "probe" (table rows, queries) and "segsum_diff"
    (stream rows, with the row pair); a table is drawn once per size.
    Fails at the first difference; returns per kernel the shapes and
    launches covered and the largest error. On the CPU (``device``) the
    wrappers run their plain versions: only the sweep itself is tried."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.probe import probe
    from repro_torch.kernels.searchsorted import (searchsorted,
                                                  searchsorted_sides)
    from repro_torch.kernels.segsum_diff import segsum

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    out = {}

    def held(name, shape, got, want):
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{name} {list(shape)}: kernel differs from plain version")
        e = out.setdefault(name, {"shapes": 0, "launches": 0,
                                  "max_abs_err": 0.0})
        e["max_abs_err"] = max([e["max_abs_err"]] + [
            float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
            for a, b in zip(got, want) if a.numel()])

    def by_table(hist):
        sizes = collections.defaultdict(list)
        for n, q in sorted(hist):
            sizes[n].append(q)
        return sorted(sizes.items())

    def sorted_words(n):
        return ref.flip(torch.sort(random_words(torch, g, n)).values
                        ).contiguous()

    for name in ("searchsorted", "zone_windows"):
        for n, qs in by_table(hists[name]):
            tab = sorted_words(n)
            for q in qs:
                qw = sorted_words(q)
                if name == "searchsorted":
                    for side in ("left", "right"):
                        held(name, (n, q, side),
                             (searchsorted(tab, qw, side),),
                             (ref.lower_bound(tab, qw, side),))
                else:
                    held(name, (n, q, q // 2),
                         (searchsorted_sides(tab, qw, q // 2),),
                         (ref.lower_bound_sides(tab, qw, q // 2),))
            del tab
    for n, qs in by_table(hists["probe"]):
        lo, hi = sorted_pairs(torch, g, n)
        for q in qs:
            args = (lo, hi) + probe_queries(torch, g, lo, hi, q)
            held("probe", (n, q), probe(*args), ref.probe(*args))
        del lo, hi, args
    for n, pair in sorted(hists["segsum_diff"]):
        args = segsum_inputs(torch, g, n, pair)
        held("segsum_diff", (n, pair), segsum(*args), ref.segsum(*args))
        del args
    for name, hist in hists.items():
        e = out.setdefault(name, {"shapes": 0, "launches": 0,
                                  "max_abs_err": 0.0})
        e.update(shapes=len(hist), launches=sum(hist.values()))
    return out


def workflow_split(torch, flows: list, kern: dict, seed: int,
                   change: int) -> dict:
    """The workflow window's kernels at its own shapes: its counted
    launches (both modes' first rounds) by query group, each group's
    commonest shape timed as the main path's are, every segsum shape
    timed; then every distinct shape of both rounds of both modes held
    EXACTLY against the plain version (``exact_sweep``). The timed rows
    go to the end of ``kern``'s lists (the kernels line reads the
    first, a main-path shape, and the largest error of all)."""
    hist = functools.partial(shape_hist, flows)
    s_groups, s_rows = searchsorted_split(
        torch, hist("searchsorted_shapes"), seed, hist("zone_window_shapes"))
    p_groups, p_rows = probe_split(torch, hist("probe_shapes"), seed)
    seg_rows = segsum_split(torch, hist("segsum_shapes"), seed, change)
    kern["searchsorted"] += s_rows
    kern["probe"] += p_rows
    kern["segsum_diff"] += seg_rows
    rounds = flows + [f["second_round"] for f in flows]
    swept = exact_sweep(torch, {
        "searchsorted": shape_hist(rounds, "searchsorted_shapes"),
        "zone_windows": shape_hist(rounds, "zone_window_shapes"),
        "probe": shape_hist(rounds, "probe_shapes"),
        "segsum_diff": shape_hist(rounds, "segsum_shapes")}, seed)

    def rows(rs):
        return [{f: e[f] for f in ("shape", "roles", "ok", "max_abs_err",
                                   "ms", "device_ms", "plain_ms",
                                   "library_ms", "bound_ms", "launches")
                 if f in e} for e in rs]
    return phase("workflow_split", searchsorted_groups=s_groups,
                 probe_groups=p_groups, checked=rows(s_rows + p_rows),
                 segsum=rows(seg_rows), exact=swept)


def launch_cost(torch, seed: int, iters: int = 2000) -> dict:
    """Host cost of one searchsorted call at LAUNCH_COST_SHAPE, step by
    step: each step's host µs per call over ``iters`` back-to-back calls
    (a step that launches a kernel enqueues it; the card keeps up, as a
    launch here takes a few µs of device time), then the whole wrapper
    and torch.searchsorted by CUDA events and with a synchronize each.
    The steps are those the wrapper takes: the stream read, the
    allocation, the two checks and the bound C entry that launches."""
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.searchsorted import _ONE_SIDE, searchsorted

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    n, nq = LAUNCH_COST_SHAPE
    tab = ref.flip(torch.sort(random_words(torch, g, n)).values).contiguous()
    q = tab[n // 3:n // 3 + nq].clone()
    lib_tab, lib_q = ref.flip(tab), ref.flip(q)
    out = torch.empty_like(q)
    di = torch.cuda.current_device()

    def host_us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e6

    def synced_us(fn):
        return host_us(lambda: (fn(), torch.cuda.synchronize()))

    steps = {
        "raw_current_stream": lambda: torch._C._cuda_getCurrentRawStream(di),
        "empty_like": lambda: torch.empty_like(q),
        "check_cuda_x2": lambda: (
            build.check_cuda(tab, torch.int64, 1, "tab"),
            build.check_cuda(q, torch.int64, 1, "q")),
        # the bound C entry as the wrapper calls it: stream read, launch,
        # error check and count
        "launcher_call": lambda: _ONE_SIDE(di, tab.data_ptr(), n,
                                           q.data_ptr(), nq, 0,
                                           out.data_ptr()),
        "wrapper": lambda: searchsorted(tab, q),
        "torch_searchsorted": lambda: torch.searchsorted(lib_tab, lib_q),
    }
    rec = {"shape": [n, nq], "iters": iters,
           "host_us": {k: host_us(f) for k, f in steps.items()},
           "synced_host_us": {
               "wrapper": synced_us(lambda: searchsorted(tab, q)),
               "torch_searchsorted": synced_us(
                   lambda: torch.searchsorted(lib_tab, lib_q))},
           "events_ms": {
               "wrapper": cuda_ms(torch, lambda: searchsorted(tab, q), 200),
               "torch_searchsorted": cuda_ms(torch, lambda: torch.searchsorted(
                   lib_tab, lib_q), 200)}}
    check(torch.equal(searchsorted(tab, q),
                      torch.searchsorted(lib_tab, lib_q)),
          "searchsorted differs from torch.searchsorted at the launch-cost "
          "shape")
    rec["flash"] = flash_launch_cost(torch, seed, iters)
    return rec


def flash_launch_cost(torch, seed: int, iters: int) -> dict:
    """Host cost of one flash forward at FLASH_COST_SHAPE, before and
    after the kernel went behind the op ``repro_torch::flash_attention``:
    ``direct`` is the wrapper's former body (the checks, the outputs and
    the launch: ``flash_attention._launch``, which the op's CUDA
    registration runs), ``op`` the wrapper through the op's dispatch,
    and SDPA's call beside them; host µs per call over ``iters``
    back-to-back calls, and per call with a synchronize each. The two
    paths' outputs must be equal."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    b, sq, h, hd = FLASH_COST_SHAPE
    q, k, v = (torch.randn((b, sq, h, hd), generator=g, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    calls = {
        "direct": lambda: fa._launch(q, k, v, True, None, None, False),
        "op": lambda: fa.flash_attention(q, k, v),
        "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)}

    def host_us(fn, sync=False):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
            if sync:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e6

    rec = {"shape": list(FLASH_COST_SHAPE), "iters": iters,
           "host_us": {k: host_us(f) for k, f in calls.items()},
           "synced_host_us": {k: host_us(f, True) for k, f in calls.items()}}
    rec["op_minus_direct_us"] = rec["host_us"]["op"] \
        - rec["host_us"]["direct"]
    check(torch.equal(calls["direct"]()[0], calls["op"]()),
          "the flash op's output differs from the direct launch's")
    rec["steps"] = flash_path_steps(torch, seed)
    return rec


def flash_path_steps(torch, seed: int, rounds: int = 4,
                     reps: int = 5) -> dict:
    """The flash ops' dispatch end to end: a prefill and a train step
    (the loss's forward and backward, recomputed layers included) of
    FLASH_STEP_ARCH's first FLASH_STEP_LAYERS layers at its widths, over
    FLASH_STEP_TOKENS tokens, each timed through the ops (``op``) and
    with the wrappers bound to the kernels' launches as they were before
    the ops (``direct``), in turns (op, direct, direct, op, ...) over
    ``rounds``: ms per call to a synchronize, the median of ``reps``
    calls each turn. Both paths' logits and gradients must be equal."""
    from repro_torch.configs import first_layers, get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.models import lm
    from repro_torch.models.lm import LM

    cfg = first_layers(get_config(FLASH_STEP_ARCH), FLASH_STEP_LAYERS)
    model = LM(cfg, device="cuda",
               generator=torch.Generator("cuda").manual_seed(seed))
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (1, FLASH_STEP_TOKENS + 1),
                           generator=g, device="cuda")
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    params = list(model.requires_grad_().parameters())
    paths = {
        "op": (fa._flash_op, fab._bwd_op),
        "direct": (lambda q, k, v, causal, window, block, block_m, lse:
                   fa._launch(q, k, v, causal, window, block_m, lse),
                   lambda q, k, v, o, lse, do, causal, window:
                   fab._launch(q, k, v, o, lse, do, causal, window))}
    runs = {
        "prefill": lambda: prefill(batch["tokens"]),
        "train": lambda: torch.autograd.grad(
            lm.loss_fn(model, batch, remat=True), params)}

    def use(path):
        fa._flash_op, fab._bwd_op = paths[path]

    def prefill(tokens):
        with torch.no_grad():
            return model.prefill(tokens, seq_cap=FLASH_STEP_TOKENS)[0]

    def ms(fn):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    rec = {"arch": FLASH_STEP_ARCH, "layers": FLASH_STEP_LAYERS,
           "tokens": FLASH_STEP_TOKENS,
           "ms": {r: {"op": [], "direct": []} for r in runs}}
    try:
        got = {}
        for path in paths:
            use(path)
            got[path] = [runs["prefill"]()] + list(runs["train"]())
        check(all(torch.equal(a, b) for a, b in zip(got["op"],
                                                   got["direct"])),
              "the flash ops' prefill or gradients differ from the direct "
              "launches'")
        for i in range(rounds):
            for path in (("op", "direct") if i % 2 == 0
                         else ("direct", "op")):
                use(path)
                for r, fn in runs.items():
                    rec["ms"][r][path].append(ms(fn))
    finally:
        use("op")
    rec["median_ms"] = {r: {p: statistics.median(v) for p, v in d.items()}
                        for r, d in rec["ms"].items()}
    return rec


def sql_diff_steps(torch, store, a, b, repeats: int) -> dict:
    """SQL diff re-run ``repeats`` times, alternately plain (host clock to
    a synchronize at the end) and split into steps: each step below is
    wrapped to synchronize before and after it, so a step's host time
    holds its device work; "rest" is the remainder of the synchronized
    call (the stream concatenation, the representative choice and the
    gathers). The steps are the functions sql_diff calls by name, so a
    tree of any earlier slice splits the same way."""
    from repro_torch.core import diff as core_diff
    from repro_torch.core.delta import SignedStream
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops

    steps = (("scan", core_diff, "full_scan_stream"),
             ("plan_key_cuts", sharding, "plan_key_cuts"),
             ("merge_by_key", SignedStream, "merge_by_key"),
             ("diff_aggregate_rows", ops, "diff_aggregate_rows"))
    spent = collections.Counter()

    def timed_step(name, fn):
        def step(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return step

    def run_once():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        core_diff.sql_diff(store, a, b)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    plain, split = [], []
    for _ in range(repeats):
        plain.append(run_once() * 1e3)
        kept = [(owner, attr, getattr(owner, attr))
                for _, owner, attr in steps]
        for (name, owner, attr), (_, _, fn) in zip(steps, kept):
            setattr(owner, attr, timed_step(name, fn))
        spent.clear()
        try:
            total = run_once()
        finally:
            for owner, attr, fn in kept:
                setattr(owner, attr, fn)
        row = {name: spent[name] * 1e3 for name, _, _ in steps}
        row["rest"] = total * 1e3 - sum(row.values())
        row["total"] = total * 1e3
        split.append(row)
    return {"plain_ms": plain, "steps_ms": split}


def start_engine(pk: bool, rows: int, change: int, device, timed=None,
                 tracer=None):
    """The main path's start: lineitem loaded (snapshot ``sn1``), cloned
    to ``t``, and ``t`` changed by ``change`` rows of change set C4's draw
    (snapshot ``sn3``). ``timed(name, fn)`` clocks the load and the
    update; ``tracer`` is bound to the engine once it is loaded. Returns
    the engine, the loaded batch, ``sn1`` and ``sn3``."""
    import numpy as np

    from repro_torch.benchmarks.vcs_tables import _mk_engine, _random_update
    timed = timed or (lambda name, fn: fn())
    engine, base = timed("load_s",
                         lambda: _mk_engine(rows, pk, device=device))
    if tracer is not None:
        tracer.bind(engine)
    sn1 = engine.create_snapshot("sn1", "lineitem")
    engine.clone_table("t", sn1)
    rng = np.random.default_rng([change] + list(b"C4"))
    timed("update_s", lambda: _random_update(engine, "t", base, change,
                                             rng, pk))
    sn3 = engine.create_snapshot("sn3", "t")
    return engine, base, sn1, sn3


def mainpath_phase(torch, pk: bool, rows: int, change: int):
    """The main path at SF1; returns its record and what the workflow
    phase continues from: the engine, the loaded batch, and the table's
    snapshots before and after the ACCEPT merge."""
    from repro_torch.core import (ConflictMode, snapshot_diff, sql_diff,
                                  telemetry, three_way_merge)
    from repro_torch.kernels import build, ops

    dev = torch.device("cuda")
    gc.collect()         # an earlier engine: its PRs point back at it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    build.reset_launches()
    with path_shapes(ops) as hists, telemetry.trace() as tracer:
        engine, base, sn1, sn3 = start_engine(pk, rows, change, dev,
                                              timed, tracer)
        cur = engine.current_snapshot("lineitem")
        d_cold = timed("diff_cold_s",
                       lambda: snapshot_diff(engine.store, cur, sn3))
        d_warm = timed("diff_warm_s",
                       lambda: snapshot_diff(engine.store, cur, sn3))
        d_sql = timed("sql_diff_s",
                      lambda: sql_diff(engine.store, cur, sn3))
        rep = timed("merge_s", lambda: three_way_merge(
            engine, "lineitem", sn3, base=sn1, mode=ConflictMode.ACCEPT))
    launches = dict(build.LAUNCHES)
    groups = [d_cold.n_groups, d_warm.n_groups, d_sql.n_groups]
    merge = f"{rep.inserted}/{rep.deleted}/{rep.true_conflicts}"
    rec = {"pk": pk, "rows": rows, "change": change, "n_groups": groups,
           "merge": merge, "times_s": times, "launches": launches,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "table_lane_bytes": engine.lane_nbytes("lineitem"),
           "spans": span_summary(tracer)}
    rec.update(shape_record(launches, *hists))

    rec["sql_diff_steps"] = sql_diff_steps(torch, engine.store, cur, sn3,
                                           SQL_DIFF_REPEATS)

    def requery():
        engine.store.delta_cache.clear()   # re-scan Δ; visibility is warm
        snapshot_diff(engine.store, cur, sn3)
        sql_diff(engine.store, cur, sn3)
    rec["profile_diff_sql"] = device_profile(torch, requery)
    for d in (d_cold, d_warm, d_sql):
        for f in ("diff_cnt", "key_lo", "row_lo", "rowid"):
            check(getattr(d, f).device.type == "cuda", "result off the card")
        check(bool((d.diff_cnt != 0).all()), "a cancelled group survived")
    check(groups == [2 * change] * 3, f"n_groups {groups} != {2 * change}")
    check(merge == f"{change}/{change}/0", f"merge report {merge}")
    check(all(launches[k] > 0 for k in build.VCS_SOURCES),
          f"a kernel was not launched on the main path: {launches}")
    post = engine.current_snapshot("lineitem")
    return rec, (engine, base, cur, post)


# ----------------------------------------------------------------- workflow

def on_card(*tensors) -> bool:
    return all(t.device.type == "cuda" for t in tensors)


def workflow_round(torch, pk: bool, engine, base, change: int, seed: int,
                   merged=None) -> dict:
    """One round of the workflow porcelain on the loaded SF1 engine:
    branch, a ``change``-row edit on the branch, then (the window, with
    the launch counts set to 0 just before it) open a PR, review diff,
    CI checks on the merged preview, publish, revert the publish, revert
    the main path's ACCEPT merge (``merged``: its before and after
    snapshots) by its inverse Δ, drop the branch and GC. Each step
    is host-clocked to a ``torch.cuda.synchronize()``; every check fails
    the run."""
    import numpy as np

    from repro_torch.benchmarks.vcs_tables import _random_update
    from repro_torch.core import snapshot_diff, telemetry
    from repro_torch.kernels import build, ops

    store, stats, table = engine.store, engine.commit_stats, "lineitem"
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    def empty_diff(a, what):
        d = snapshot_diff(store, a, engine.current_snapshot(table))
        check(on_card(d.diff_cnt, d.rowid), f"{what}: diff off the card")
        check(d.is_empty(), f"{what}: {d.n_groups} groups differ")

    timed("branch_s", lambda: engine.create_branch("dev", [table]))
    rng = np.random.default_rng([seed, change] + list(b"WF"))
    timed("edit_s", lambda: _random_update(engine, f"dev/{table}", base,
                                           change, rng, pk, tag=7))
    hashed = (stats.rows_rehashed, stats.lob_rows_hashed)
    build.reset_launches()
    with path_shapes(ops) as hists, telemetry.trace(engine) as tracer:
        pr = timed("open_pr_s", lambda: engine.open_pr("main", "dev"))
        diffs = timed("pr_diff_s", pr.diff)
        d = diffs[table]
        check(d.n_groups == 2 * change,
              f"PR diff: {d.n_groups} groups, not {2 * change}")
        check(on_card(d.diff_cnt, d.key_lo, d.row_lo, d.rowid),
              "PR diff off the card")
        pin = pr.base_pins[table]
        # a Δ-sized CI check: the merged preview differs from the pinned
        # base by exactly the PR's groups
        pr.add_check(lambda ctx: snapshot_diff(
            ctx.engine.store, pin, ctx.engine.current_snapshot(table)
        ).n_groups == 2 * change, "preview-groups")
        state = (set(store.oids()), store._next_oid)
        results = timed("checks_s", pr.run_checks)
        check(all(r.ok for r in results), f"CI checks failed: {results}")
        check((set(store.oids()), store._next_oid) == state,
              "the CI preview left objects or moved the oid counter")
        pre_publish = engine.current_snapshot(table)
        reports = timed("publish_s", pr.publish)
        rep = reports[table]
        got = f"{rep.inserted}/{rep.deleted}/{rep.true_conflicts}"
        check(got == f"{change}/{change}/0", f"publish report {got}")
        timed("revert_publish_s", pr.revert_publish)
        empty_diff(pre_publish, "after revert_publish")
        if merged is not None:
            timed("revert_s", lambda: engine.revert(table, *merged))
            empty_diff(merged[0], "after reverting the ACCEPT merge")
        check((stats.rows_rehashed, stats.lob_rows_hashed) == hashed,
              "publish or revert rehashed rows: "
              f"{hashed} -> {(stats.rows_rehashed, stats.lob_rows_hashed)}")
        newest = store.get(engine.table(table).directory.data_oids[-1])
        check(on_card(newest.row_lo, newest.key_lo, newest.commit_ts),
              "sealed lanes off the card")
        # a reverted PR is final and holds no pins (close() refuses it,
        # in the reference too): the branch drops as it stands
        check(pr.status == "reverted", f"PR status {pr.status}")
        engine.drop_branch("dev")
        mem_before = torch.cuda.memory_allocated()
        swept = timed("gc_s", engine.gc)
        mem_after = torch.cuda.memory_allocated()
    launches = dict(build.LAUNCHES)
    check(swept.objects_freed > 0,
          "gc freed nothing after the branch dropped")
    check(all(launches[k] > 0
              for k in ("searchsorted", "probe", "segsum_diff")),
          f"a VCS kernel was not launched in the workflow window: "
          f"{launches}")
    return {"times_s": times, "launches": launches,
            "publish": got, "pr_diff_groups": d.n_groups,
            "gc": vars(swept), "memory_allocated_before_gc": mem_before,
            "memory_allocated_after_gc": mem_after,
            "spans": span_summary(tracer),
            **shape_record(launches, *hists)}


def workflow_phase(torch, pk: bool, engine, base, merged, change: int,
                   seed: int) -> dict:
    """The workflow porcelain at SF1 on the main path's engine: a timed
    round, then a second round (without the merge revert, which the first
    round already applied) under the profiler for the device's busy share
    and its device-to-host copies, with its launches by shape as
    ``second_round``."""
    rec = {"pk": pk, "change": change}
    rec.update(workflow_round(torch, pk, engine, base, change, seed,
                              merged))
    second = []
    rec["profile_round"] = device_profile(
        torch, lambda: second.append(workflow_round(
            torch, pk, engine, base, change, seed + 1)), focus="segsum")
    rec["second_round"] = {k: v for k, v in second[0].items()
                           if k == "launches" or k.endswith("_shapes")}
    return rec


# -------------------------------------------------------------------- doors

#: each statement of the doors phase -> the Python door's step of the same
#: verb in the workflow phase of the same run (its ``times_s``)
PYTHON_DOOR = {"branch": "branch_s", "diff": "pr_diff_s",
               "open_pr": "open_pr_s", "check": "checks_s",
               "publish": "publish_s", "revert_pr": "revert_publish_s",
               "gc": "gc_s"}


def door_steps(cli):
    """The 16-step workflow of ``tests/test_statements_cli.py:32-77``
    (500-row ``orders``, seed 0): each step as (Python call on a Repo,
    statement or None, CLI argv); the DML steps ride ``cli``'s
    deterministic seed/mutate helpers on every door."""
    return [
        (lambda r: cli.seed_table(r, "orders", 500, 0),
         None, ["seed", "orders", "--rows", "500", "--seed", "0"]),
        (lambda r: r.tag("night", "orders"),
         "CREATE SNAPSHOT night FOR TABLE orders",
         ["snapshot", "night", "orders"]),
        (lambda r: r.branch("dev", ["orders"]),
         "CREATE BRANCH dev FOR (orders)",
         ["branch", "dev", "-t", "orders"]),
        (lambda r: cli.mutate_table(r, "dev/orders", 40, 7),
         None, ["mutate", "dev/orders", "--rows", "40", "--seed", "7"]),
        (lambda r: r.diff("branch:dev", "HEAD", table="orders"),
         "DIFF 'branch:dev' AGAINST 'HEAD' FOR TABLE orders",
         ["diff", "branch:dev", "HEAD", "--table", "orders"]),
        (lambda r: r.open_pr("dev"),
         "OPEN PR FROM dev INTO main",
         ["pr", "open", "dev", "--into", "main"]),
        (lambda r: r.check(1), "CHECK PR 1", ["pr", "check", "1"]),
        (lambda r: r.publish(1), "PUBLISH PR 1", ["publish", "1"]),
        (lambda r: r.log("orders"), "LOG TABLE orders", ["log", "orders"]),
        (lambda r: r.revert_pr(1), "REVERT PR 1", ["revert-pr", "1"]),
        (lambda r: cli.mutate_table(r, "dev/orders", 10, 11),
         None, ["mutate", "dev/orders", "--rows", "10", "--seed", "11"]),
        (lambda r: r.merge("branch:dev", "branch:main", mode="theirs"),
         "MERGE BRANCH dev INTO main MODE theirs",
         ["merge", "dev", "main", "--mode", "theirs"]),
        (lambda r: r.clone("orders_night", "snap:night"),
         "CLONE TABLE orders_night FROM 'snap:night'",
         ["clone", "orders_night", "snap:night"]),
        (lambda r: r.revert("orders", "orders~1", "HEAD"),
         "REVERT TABLE orders FROM 'orders~1' TO 'HEAD'",
         ["revert", "orders", "orders~1", "HEAD"]),
        (lambda r: r.gc(), "GC", ["gc"]),
        (lambda r: r.status(), "STATUS", ["status"]),
    ]


def content_digest(engine, table, directory=None) -> str:
    """Order-independent sha256 over a table's full-row signatures (the
    reference's ``conftest.content_digest``)."""
    import hashlib

    import numpy as np

    from repro_torch.interop import to_numpy
    _, _, lo, hi = engine.table(table).scan(directory, with_sigs=True)
    lo, hi = to_numpy(lo, u64=True), to_numpy(hi, u64=True)
    order = np.lexsort((hi, lo))
    h = hashlib.sha256(lo[order].tobytes())
    h.update(hi[order].tobytes())
    return h.hexdigest()


def door_fingerprint(repo) -> dict:
    """What the three doors must agree on: ts, every table's digest, the
    commit log, branches, snapshots and PRs."""
    e = repo.engine
    return {"ts": e.ts,
            "tables": {n: content_digest(e, n) for n in sorted(e.tables)},
            "log": [(r.ts, r.table, r.kind, r.inserted, r.deleted)
                    for r in e.commit_log],
            "branches": repo.branches(), "snapshots": repo.snapshots(),
            "prs": [(i, p.base_name, p.head_name, p.status)
                    for i, p in sorted(e.prs.items())]}


def drive_doors(device, store_dir: Path):
    """The 16-step script through every door on ``device``: ``Repo``,
    statement strings, the CLI in process (``vcs_cli.main(["--device",
    ...])`` on a fresh store under ``store_dir``), and the replay of the
    statement session's serialized WAL. Returns each door's fingerprint
    and seconds (the CLI's printing swallowed)."""
    import io

    from repro_torch import vcs_cli
    from repro_torch.core import WAL, Engine, Repo, execute

    steps = door_steps(vcs_cli)
    prints, fps, secs = [], {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out, \
                contextlib.redirect_stderr(io.StringIO()):
            fps[name] = door_fingerprint(fn())
        prints.append(out.getvalue())
        secs[name] = time.perf_counter() - t0

    def python():
        r = Repo(device=device)
        for py, _, _ in steps:
            py(r)
        return r

    def statements():
        r = Repo(device=device)
        for py, stmt, _ in steps:
            if stmt is None:
                py(r)
            else:
                execute(r, stmt)
        return r

    def cli():
        store = store_dir / f"doors-{device}.wal"
        for f in (store, Path(f"{store}.corrupt")):
            f.unlink(missing_ok=True)
        argv0 = ["--device", str(device), "--store", str(store)]
        check(vcs_cli.main(argv0 + ["init"]) == 0, "datagit init failed")
        for _, _, argv in steps:
            check(vcs_cli.main(argv0 + argv) == 0, f"datagit {argv} failed")
        return vcs_cli.load_repo(str(store), device)

    timed("python", python)
    session = []
    timed("statements", lambda: session.append(statements()) or session[0])
    timed("replay", lambda: Repo(Engine.replay(WAL.deserialize(
        session[0].engine.wal.serialize()), device=device)))
    timed("cli", cli)
    return fps, secs


def rowhash_shapes(ops):
    """rowhash's launches by (rows, lanes): every signatures_from_lanes."""
    def shape_of(lanes):
        if lanes.device.type == "cuda" and lanes.shape[0]:
            return int(lanes.shape[0]), int(lanes.shape[1])
        return None
    return kernel_shapes(ops, "_rowhash_kernel", shape_of)


def sorted_sigs(torch, engine, table, directory=None):
    """A table's row signatures in (lo, hi) order, on the card: equal
    tensors mean equal content (the device twin of ``content_digest``)."""
    from repro_torch.kernels import ops
    _, _, lo, hi = engine.table(table).scan(directory, with_sigs=True)
    o = ops._sort128(lo, hi)
    return torch.stack([lo[o], hi[o]])


def by_pk(torch, batch, names):
    """A scanned batch's columns ``names`` in (l_orderkey, l_linenumber)
    order (unique in lineitem, with or without a declared PK)."""
    import numpy as np
    key = batch["l_orderkey"] * 8 + batch["l_linenumber"].to(torch.int64)
    o = torch.sort(key).indices
    oh = o.cpu().numpy()
    return {n: (batch[n][oh] if isinstance(batch[n], np.ndarray)
                else batch[n][o]) for n in names}


def doors_phase(torch, pk: bool, engine, base, flow: dict, change: int,
                seed: int) -> dict:
    """The port's user surface on the SF1 engine after its workflow phase:
    (PK only) a secondary index on ``l_partkey`` backfilled over every
    row, 64 ``lookup_eq`` held against a device mask of the base table,
    and a C4 update through ``Repo`` that maintains it, then its drop (so
    both doors' workflows commit to the same table); the workflow through
    the statement door, one timed statement at a time (snapshot,
    branch, diff, PR, check, publish, log, revert, drop, GC, STATUS,
    EXPLAIN); compaction; a materialized clone; ALTER TABLE ADD COLUMN
    and a restore past it; ``per_key_conflicts``; then the 16-step script
    through the three doors and replay on the card against the CPU. Each
    step is host-clocked to a ``torch.cuda.synchronize()`` with its
    launches by kernel and shape, rows rehashed and peak memory; every
    check fails the run."""
    import numpy as np

    from repro_torch.benchmarks.vcs_tables import _random_update
    from repro_torch.core import (Column, CType, Repo, compact_table,
                                  create_index, drop_index, execute,
                                  lookup_eq, snapshot_diff, statements)
    from repro_torch.core.wal import CRC32C_IMPL
    from repro_torch.kernels import build, ops

    table, store = "lineitem", engine.store
    repo = Repo(engine)
    steps, texts, steps_parse = {}, {}, {}
    t_phase = time.perf_counter()
    build.reset_launches()
    with path_shapes(ops) as hists, rowhash_shapes(ops) as rshapes:
        recorders = dict(zip(("searchsorted", "zone_windows", "probe",
                              "segsum_diff", "rowhash"), hists + (rshapes,)))

        def step(name, fn):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            l0 = dict(build.LAUNCHES)
            h0 = {k: collections.Counter(h) for k, h in recorders.items()}
            st = engine.commit_stats
            r0, b0 = st.rows_rehashed, st.lob_rows_hashed
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            st = engine.commit_stats
            steps[name] = {
                "s": time.perf_counter() - t0,
                "launches": {k: build.LAUNCHES[k] - l0[k]
                             for k in build.VCS_SOURCES
                             if build.LAUNCHES[k] - l0[k]},
                "shapes": {k: [list(s) + [c] for s, c in
                               sorted((h - h0[k]).items())]
                           for k, h in recorders.items() if h - h0[k]},
                "rows_rehashed": st.rows_rehashed - r0,
                "lob_rows_hashed": st.lob_rows_hashed - b0,
                "max_memory_allocated": torch.cuda.max_memory_allocated()}
            return out

        def stmt(name, text):
            texts[name] = text
            t0 = time.perf_counter()
            for _ in range(200):
                statements._P(text)
            steps_parse[name] = (time.perf_counter() - t0) / 200 * 1e6
            return step(name, lambda: execute(repo, text)).data

        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        rng = np.random.default_rng([seed, change] + list(b"DOORS"))
        n_rows = engine.table(table).count()

        # 1-2. a secondary index, backfilled, looked up, maintained
        if pk:
            spec = step("create_index", lambda: create_index(
                engine, table, "by_part", ["l_partkey"]))
            aux = engine.table(spec.aux_table)
            check(aux.count() == n_rows,
                  f"index: {aux.count()} aux rows for {n_rows}")
            batch, _ = engine.table(table).scan()
            pick = torch.randint(0, n_rows, (64,), generator=g,
                                 device="cuda")
            vals = batch["l_partkey"][pick].tolist()

            def pairs(ok, ln):
                return torch.sort(ok * 8 + ln.to(torch.int64)).values

            hits = step("lookup_eq_64", lambda: [lookup_eq(
                engine, table, "by_part", {"l_partkey": v}) for v in vals])
            for v, h in zip(vals, hits):
                m = batch["l_partkey"] == v
                check(torch.equal(
                    pairs(h["l_orderkey"], h["l_linenumber"]),
                    pairs(batch["l_orderkey"][m], batch["l_linenumber"][m])),
                    f"lookup_eq l_partkey={v} differs from the base mask")
            del batch
            idx = rng.choice(base["l_orderkey"].shape[0], size=change,
                             replace=False)
            upd = {k: v[idx].copy() for k, v in base.items()}
            upd["l_partkey"] = upd["l_partkey"] + 200_000   # new values
            upd["l_comment"] = np.array([b"ix-%d" % i for i in
                                         range(change)], dtype=object)
            step("update_indexed", lambda: repo.update_by_keys(table, upd))
            check(aux.count() == n_rows, "index: aux count moved")
            for i in idx[:8]:
                key = int(base["l_orderkey"][i]) * 8 + int(
                    base["l_linenumber"][i])
                new = lookup_eq(engine, table, "by_part",
                                {"l_partkey": int(base["l_partkey"][i])
                                 + 200_000})
                old = lookup_eq(engine, table, "by_part",
                                {"l_partkey": int(base["l_partkey"][i])})
                check(key in pairs(new["l_orderkey"],
                                   new["l_linenumber"]).tolist(),
                      "an updated row is missing under its new value")
                check(key not in pairs(old["l_orderkey"],
                                       old["l_linenumber"]).tolist(),
                      "an updated row is still found under its old value")
            # the statement workflow below is set beside the Python
            # door's, which ran with no index: drop it so both doors
            # commit to the same table without an auxiliary one
            step("drop_index", lambda: drop_index(engine, table, "by_part"))
            check(spec.aux_table not in engine.tables
                  and not engine.indices.get(table),
                  "drop_index left the index behind")

        # 3. the workflow through the statement door
        stmt("snapshot", "CREATE SNAPSHOT s17 FOR TABLE lineitem")
        stmt("branch", "CREATE BRANCH sdev FOR (lineitem)")
        step("edit", lambda: _random_update(
            engine, "sdev/lineitem", base, change, rng, pk, tag=17))
        d_branch = stmt("diff",
                        "DIFF 'branch:sdev' AGAINST 'HEAD' FOR TABLE "
                        "lineitem")
        check(d_branch.n_groups == 2 * change,
              f"DIFF: {d_branch.n_groups} groups, not {2 * change}")
        pr = stmt("open_pr", "OPEN PR FROM sdev INTO main")
        results = stmt("check", f"CHECK PR {pr.id}")
        check(all(r.ok for r in results), f"CHECK PR: {results}")
        stmt("snapshot_pre_publish",
             "CREATE SNAPSHOT pre_pub FOR TABLE lineitem")
        rep = stmt("publish", f"PUBLISH PR {pr.id}")["lineitem"]
        got = f"{rep.inserted}/{rep.deleted}/{rep.true_conflicts}"
        check(got == f"{change}/{change}/0", f"PUBLISH PR: {got}")
        log = stmt("log", "LOG TABLE lineitem LIMIT 5")
        check(log[0].kind == "publish", f"LOG: {log[0]}")
        stmt("revert_pr", f"REVERT PR {pr.id}")
        d0 = stmt("diff_pre_publish", "DIFF 'snap:pre_pub' AGAINST 'HEAD' "
                  "FOR TABLE lineitem")
        check(d0.n_groups == 0, f"after REVERT PR: {d0.n_groups} groups")
        stmt("drop_branch", "DROP BRANCH sdev")
        stmt("gc", "GC")
        stmt("status", "STATUS")
        explained = stmt("explain", "EXPLAIN DIFF TABLE lineitem AGAINST "
                         "'snap:s17'")
        check([s.name for s in explained["spans"]] == ["diff"],
              "EXPLAIN: no diff span")

        # 4. compaction
        engine.create_snapshot("pre_compact", table)
        objs = len(engine.table(table).directory.data_oids)
        before = sorted_sigs(torch, engine, table)
        written = step("compact_table", lambda: compact_table(engine,
                                                              table))
        after_objs = len(engine.table(table).directory.data_oids)
        check(written > 0 and after_objs < objs,
              f"compaction: {objs} -> {after_objs} data objects")
        check(torch.equal(sorted_sigs(torch, engine, table), before),
              "compaction changed the table's content")
        del before
        dc = stmt("diff_pre_compact", "DIFF 'snap:pre_compact' AGAINST "
                  "'HEAD' FOR TABLE lineitem")
        check(dc.n_groups == 0, f"after compaction: {dc.n_groups} groups")

        # 5. a materialized clone
        stmt("clone_materialize",
             "CLONE TABLE li_copy FROM 'snap:s17' MATERIALIZE")
        check(steps["clone_materialize"]["rows_rehashed"] == 0
              and steps["clone_materialize"]["lob_rows_hashed"] == 0,
              "materialize rehashed rows")
        snap_sigs = sorted_sigs(torch, engine, table,
                                engine.snapshots["s17"].directory)
        check(torch.equal(sorted_sigs(torch, engine, "li_copy"), snap_sigs),
              "the materialized clone differs from its snapshot")
        n_copy = engine.table("li_copy").count()

        # 6. ALTER TABLE ADD COLUMN, then a restore past it
        engine.create_snapshot("pre_alter", "li_copy")
        old_cols = engine.table("li_copy").schema.names
        old, _ = engine.table("li_copy").scan()
        old = by_pk(torch, old, old_cols)
        step("alter_add_column", lambda: engine.alter_table_add_column(
            "li_copy", Column("l_flag17", CType.I64), 0))
        a = steps["alter_add_column"]
        check(a["rows_rehashed"] == n_copy and a["lob_rows_hashed"] == 0,
              f"ALTER rehashed {a['rows_rehashed']} rows of {n_copy}, "
              f"blake2b on {a['lob_rows_hashed']}")
        new, _ = engine.table("li_copy").scan()
        check(bool((new["l_flag17"] == 0).all()), "ALTER: wrong fill")
        new = by_pk(torch, new, old_cols)
        for c in old_cols:
            same = (np.array_equal(old[c], new[c])
                    if isinstance(old[c], np.ndarray)
                    else torch.equal(old[c], new[c]))
            check(same, f"ALTER changed column {c}")
        del old, new
        stmt("restore_pre_alter",
             "RESTORE TABLE li_copy TO 'snap:pre_alter'")
        check(torch.equal(sorted_sigs(torch, engine, "li_copy"), snap_sigs),
              "RESTORE past the ALTER did not give the pre-ALTER content")
        del snap_sigs

        # 7. per-key conflicts
        if pk:
            engine.clone_table("pk_a", "s17")
            engine.clone_table("pk_b", "s17")
            perm = rng.permutation(base["l_orderkey"].shape[0])
            half = change // 2
            for name, rows, tag in (("pk_a", perm[:change], 21),
                                    ("pk_b", perm[half:half + change], 22)):
                upd = {k: v[rows].copy() for k, v in base.items()}
                upd["l_quantity"] = upd["l_quantity"] + tag
                upd["l_comment"] = np.array([b"pk-%d-%d" % (tag, i)
                                             for i in range(change)],
                                            dtype=object)
                step(f"update_{name}",
                     lambda: engine.update_by_keys(name, upd))
            d_ab = step("diff_a_b", lambda: snapshot_diff(
                store, engine.current_snapshot("pk_a"),
                engine.current_snapshot("pk_b")))
            want = change + half
        else:
            d_ab, want = d_branch, 0
        groups = step("per_key_conflicts", d_ab.per_key_conflicts)
        check(len(groups) == want,
              f"per_key_conflicts: {len(groups)} groups, not {want}")

        # 8. the three doors and replay, on the card and on the CPU
        fps, door_s = {}, {}
        for dev in (torch.device("cuda", torch.cuda.current_device()),
                    torch.device("cpu")):
            fp, secs = step(f"doors_{dev.type}", lambda: drive_doors(
                dev, ROOT / "build"))
            fps[dev.type], door_s[dev.type] = fp, secs
        want_fp = fps["cpu"]["python"]
        for dev, fp in fps.items():
            for door, got in fp.items():
                check(got == want_fp, f"{door} door on {dev} differs from "
                      "the CPU Repo's fingerprint")
    launches = dict(build.LAUNCHES)
    shapes = shape_record(launches, *hists)
    check(sum(rshapes.values()) == launches["rowhash"],
          "rowhash shapes do not sum to its launches")
    check(all(launches[k] > 0 for k in build.VCS_SOURCES),
          f"a VCS kernel was not launched in the doors window: {launches}")
    py = flow["times_s"]
    return {"pk": pk, "change": change, "rows": n_rows,
            "seconds": time.perf_counter() - t_phase,
            "crc32c": CRC32C_IMPL, "steps": steps, "launches": launches,
            "statements": {k: {"text": t, "s": steps[k]["s"],
                               "parse_us": steps_parse[k],
                               "python_door_s": py.get(PYTHON_DOOR.get(k))}
                           for k, t in texts.items()},
            "compaction": {"objects_before": objs,
                           "objects_after": after_objs,
                           "written": written},
            "per_key_conflicts": len(groups),
            "doors_s": door_s, "doors_equal": True,
            "rowhash_shapes": [[n, c, k] for (n, c), k in
                               sorted(rshapes.items())],
            **shapes}


def doors_split(torch, doors: list, kern: dict, seed: int) -> dict:
    """The doors windows' kernels at their own shapes: every distinct
    rowhash shape (rows, lanes) EXACTLY equal to the plain version and
    timed with its bound (``rowhash_row``), and every distinct searchsorted, zone-window, probe
    and segsum shape held EXACT (``exact_sweep``). The rowhash rows go to
    the end of ``kern["rowhash"]``."""
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    hist = shape_hist(doors, "rowhash_shapes")
    rows = []
    for (r, c), launches in sorted(hist.items(), reverse=True):
        row = rowhash_row(torch, r, c, g)
        row["launches"] = launches
        rows.append(row)
    kern["rowhash"] += rows
    swept = exact_sweep(torch, {
        "searchsorted": shape_hist(doors, "searchsorted_shapes"),
        "zone_windows": shape_hist(doors, "zone_window_shapes"),
        "probe": shape_hist(doors, "probe_shapes"),
        "segsum_diff": shape_hist(doors, "segsum_shapes")}, seed)
    return phase("doors_split", rowhash=[
        {f: e[f] for f in ("shape", "ok", "max_abs_err", "ms", "device_ms",
                           "plain_ms", "bound_ms", "launches")}
        for e in rows],
        exact=swept, seconds=time.perf_counter() - t0)


# -------------------------------------------------------------------- tiers

#: pack-path functions whose own seconds the tiers phase splits out, by
#: (module, attribute): patched for the phase, every caller goes through
#: the module attribute
TIER_TIMERS = (("wal", "crc32c"), ("packs", "crc32c"),
               ("packs", "encode_object"), ("remote", "encode_object"),
               ("packs", "decode_object"), ("packs", "_decode_num_lane"),
               ("packs", "_decode_lob_lane"), ("packs", "_read"),
               ("remote", "_read"), ("packs", "_atomic_write"),
               ("remote", "_atomic_write"), ("packs", "blob_digest"),
               ("remote", "blob_digest"))


@contextlib.contextmanager
def tier_timers():
    """Host seconds and bytes of the pack path's parts while the block
    runs: ``crc32c`` (with its bytes), encode, decode, the upload of the
    numeric lanes, the LOB lanes' decode, file reads and atomic writes,
    sha256. Nested calls count in each (encode holds its CRC)."""
    from repro_torch.core import wal
    from repro_torch.store import packs, remote
    mods = {"wal": wal, "packs": packs, "remote": remote}
    acc = collections.defaultdict(float)
    saved = []

    def wrap(name, fn):
        @functools.wraps(fn)
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc[name] += time.perf_counter() - t0
                if name == "crc32c":
                    acc["crc32c_bytes"] += len(a[0])
        return timed
    for m, attr in TIER_TIMERS:
        fn = getattr(mods[m], attr)
        saved.append((mods[m], attr, fn))
        setattr(mods[m], attr, wrap(attr.strip("_"), fn))
    try:
        yield acc
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def tiers_engine(pk: bool, rows: int, change: int, device="cuda"):
    """A smaller engine for the tiers phase, started as the main path
    starts its own (``start_engine``), then one more change on lineitem:
    history that the main path's diffs never read. Returns the engine, the
    loaded batch and lineitem's snapshot before that change."""
    import numpy as np

    from repro_torch.benchmarks.vcs_tables import _random_update
    engine, base, _, _ = start_engine(pk, rows, change, device)
    pre = engine.current_snapshot("lineitem")
    rng = np.random.default_rng([change] + list(b"C9"))
    _random_update(engine, "lineitem", base, change, rng, pk, tag=9)
    return engine, base, pre


def traced_fsck(engine, **kw):
    """fsck under an armed tracer: its report, and its host seconds by
    layer read from the fsck layer spans."""
    from repro_torch.core import telemetry
    from repro_torch.core.fsck import fsck, layer_seconds
    with telemetry.trace(engine) as tracer:
        report = fsck(engine, **kw)
    return report, layer_seconds(tracer)


def tiers_phase(torch, pk: bool, engine, base, pre, change: int,
                seed: int, device="cuda", root=None) -> dict:
    """The durability-and-tiers slice on the SF1 engine after its doors
    phase: the doors' extra tables dropped and GC run, so the tier holds
    lineitem's and the main path's clone ``t``'s live objects and their
    history. Spill every object to DGPK packs under ``build/``, evict
    every one from the card (device memory before and after), read the
    main path's two snapshots back through a cold SNAPSHOT DIFF and the
    SQL diff (faults, launches, groups and digests equal to the resident
    reading), ``fsck(sample=1.0, check_replay=True)`` by layer, a push to
    a remote directory, a shallow clone on the card whose first diff
    faults in only what it reads, a C4 change pushed from the clone and
    pulled back (0 rows rehashed, equal digests), then two planted faults
    (a flipped bit in one object's lane, one in another's pack file) that
    ``fsck(repair=True)`` must report and quarantine. Every check fails
    the run. Packs, the remote and the clone go under ``root``
    (``build/tiers/<mode>``). ``device="cpu"`` drives the same steps
    without the card (the tests do, at a small size)."""
    import shutil

    import numpy as np

    from repro_torch.benchmarks.digests import diff_digest
    from repro_torch.benchmarks.vcs_tables import _random_update
    from repro_torch.core import snapshot_diff, sql_diff
    from repro_torch.core.faults import corrupt_object_bit, flip_bit
    from repro_torch.core.objects import lane_nbytes
    from repro_torch.core.wal import CRC32C_IMPL
    from repro_torch.kernels import build, ops
    from repro_torch.store import attach_packs, clone, pull, push
    from repro_torch.vcs_cli import load_repo

    t_phase = time.perf_counter()
    on_gpu = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_gpu else (lambda: None)
    allocated = torch.cuda.memory_allocated if on_gpu else (lambda: 0)
    root = Path(root or ROOT / "build" / "tiers" / ("pk" if pk else "nopk"))
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    steps = {}

    def step(name, fn, eng=None):
        st = (eng or engine).store
        sync()
        l0, m0 = dict(build.LAUNCHES), dict(st.metrics.counters)
        t0 = time.perf_counter()
        out = fn()
        sync()
        m1 = st.metrics.counters
        steps[name] = {
            "s": time.perf_counter() - t0,
            "launches": {k: build.LAUNCHES[k] - l0[k]
                         for k in build.VCS_SOURCES
                         if build.LAUNCHES[k] - l0[k]},
            **{k.split(".")[1]: m1.get(k, 0) - m0.get(k, 0)
               for k in ("store.faults", "store.objects_pulled")
               if m1.get(k, 0) - m0.get(k, 0)}}
        return out

    # the doors' extra tables go, and GC frees what only they held
    keep = ("lineitem", "t")
    for name in [n for n in engine.tables if n not in keep]:
        engine.drop_table(name)
    for name in [n for n, sn in engine.snapshots.items()
                 if sn.table not in keep]:
        engine.drop_snapshot(name)
    gc_stats = engine.gc()
    sn3 = engine.snapshots["sn3"]
    store = engine.store
    engine.store.delta_cache = None
    d_res = snapshot_diff(store, pre, sn3)
    s_res = sql_diff(store, pre, sn3)
    resident = {"diff": (d_res.n_groups, diff_digest(d_res)),
                "sql_diff": (s_res.n_groups, diff_digest(s_res))}
    del d_res, s_res
    check(resident["diff"][0] == resident["sql_diff"][0] == 2 * change,
          f"resident diffs: {resident}")

    build.reset_launches()
    with tier_timers() as parts, path_shapes(ops) as hists, \
            rowhash_shapes(ops) as rshapes:
        # 1. spill and evict
        attach_packs(store, str(root / "packs"))
        n_obj = len(store._objects)
        lanes = sum(lane_nbytes(store.get(o)) for o in list(store._objects))
        logical = store.live_bytes()
        spilled = step("spill_all", store.spill_all)
        check(spilled == n_obj, f"spilled {spilled} of {n_obj} objects")
        gc.collect()
        sync()
        mem_before = allocated()
        evicted = step("evict_all", store.evict_all)
        gc.collect()
        sync()
        mem_after = allocated()
        check(evicted == n_obj and not store._objects,
              f"evicted {evicted} of {n_obj}")
        check(not on_gpu or mem_before - mem_after >= 0.9 * lanes,
              f"eviction freed {mem_before - mem_after} bytes of "
              f"{lanes} lane bytes")

        # 2. reads from the evicted store
        reads = {}
        for name, fn in (("diff", snapshot_diff), ("sql_diff", sql_diff)):
            d = step(f"{name}_evicted",
                     lambda fn=fn: fn(store, pre, sn3))
            reads[name] = (d.n_groups, diff_digest(d))
            check(reads[name] == resident[name],
                  f"{name} from the evicted store: {reads[name]} != "
                  f"{resident[name]}")
            del d

        # 3. fsck, every layer
        rep, rep_s = step("fsck", lambda: traced_fsck(
            engine, sample=1.0, check_replay=True))
        check(rep.ok, f"fsck: {[str(i) for i in rep.issues][:4]}")
        check(not on_gpu or steps["fsck"]["launches"].get("rowhash", 0),
              "fsck launched no rowhash")
        fsck_rec = {"ok": rep.ok, "objects": rep.objects_checked,
                    "rows_verified": rep.rows_verified,
                    "packs": rep.packs_checked,
                    "replay_checked": rep.replay_checked,
                    "seconds": rep_s}

        # 4. remotes: push, shallow clone on the card, a C4 change pushed
        # from the clone and pulled back
        remote = str(root / "remote")
        pushed = step("push", lambda: push(engine, remote))
        check(pushed["objects_pushed"] == len(store._packed),
              f"push moved {pushed['objects_pushed']} objects")
        dest = str(root / "b.wal")
        cl = step("clone_shallow", lambda: clone(remote, dest,
                                                 shallow=True))
        repo_b = step("clone_load", lambda: load_repo(dest, device))
        eng_b = repo_b.engine
        check(not eng_b.store._objects and cl["objects_fetched"] == 0,
              "the shallow clone holds objects before its first read")
        d_b = step("clone_first_diff", lambda: snapshot_diff(
            eng_b.store, pre, eng_b.snapshots["sn3"]), eng_b)
        first = (d_b.n_groups, diff_digest(d_b))
        del d_b
        faulted = len(eng_b.store._objects)
        check(first == resident["diff"], f"clone's diff {first}")
        check(0 < faulted < len(eng_b.store._packed),
              f"the clone's first diff faulted {faulted} of "
              f"{len(eng_b.store._packed)} objects")
        rng = np.random.default_rng([seed, change] + list(b"TIERS"))
        step("clone_edit", lambda: _random_update(
            eng_b, "lineitem", base, change, rng, pk, tag=18), eng_b)
        back = step("clone_push", lambda: push(eng_b, remote), eng_b)
        engine2, pulled = step("pull", lambda: pull(engine, remote))
        m2 = engine2.store.metrics.counters
        check(engine2.commit_stats.rows_rehashed == 0,
              "the pull rehashed rows")
        dig_a = content_digest(engine2, "lineitem")
        dig_b = content_digest(eng_b, "lineitem")
        check(dig_a == dig_b, "pulled lineitem differs from the clone's")
        remotes = {"objects_pushed": pushed["objects_pushed"],
                   "bytes_pushed": pushed["bytes_pushed"],
                   "records_pushed": pushed["records_pushed"],
                   "clone_faulted": faulted,
                   "clone_objects": len(eng_b.store._packed),
                   "clone_pushed": back["objects_pushed"],
                   "objects_pulled": pulled["objects_pulled"],
                   "records_pulled": pulled["records_pulled"],
                   "rows_rehashed": engine2.commit_stats.rows_rehashed,
                   "store_objects_pulled": m2.get("store.objects_pulled", 0),
                   "digests_equal": dig_a == dig_b}
        del repo_b, eng_b

        # 5. planted faults on the pulled engine: a bit in one object's
        # lane, a bit in another's pack file (both resident)
        st2 = engine2.store
        data = list(engine2.table("lineitem").directory.data_oids)
        x, y = data[0], data[-1]
        corrupt_object_bit(st2.get(x), row=0, bit=5)
        st2.get(y)
        flip_bit(st2.packs.path(st2.digest_of(y)), 200)
        bad, bad_s = step("fsck_repair", lambda: traced_fsck(
            engine2, repair=True, check_replay=False), engine2)
        got = sorted((i.kind, i.oid) for i in bad.issues)
        check(got == sorted([("signature_mismatch", x),
                             ("pack_corrupt", y)]),
              f"planted faults reported as {got}")
        check(bad.quarantined == [x] and not st2.has(x),
              f"repair quarantined {bad.quarantined}")
        planted = {"issues": [list(g) for g in got],
                   "quarantined": bad.quarantined,
                   "refs_unreachable": len(bad.refs_unreachable),
                   "seconds": bad_s}
        del engine2
    launches = dict(build.LAUNCHES)
    shapes = shape_record(launches, *hists)
    check(sum(rshapes.values()) == launches["rowhash"],
          "rowhash shapes do not sum to its launches")
    crc_s, crc_b = parts.get("crc32c", 0.0), parts.get("crc32c_bytes", 0)
    return {"pk": pk, "change": change, "gc_freed": gc_stats.objects_freed,
            "objects": n_obj, "lane_bytes": lanes, "logical_bytes": logical,
            "bytes_packed": store.metrics.counters.get("store.bytes_packed",
                                                       0),
            "memory_allocated": {"before_evict": mem_before,
                                 "after_evict": mem_after,
                                 "freed": mem_before - mem_after},
            "resident": resident, "evicted": reads, "fsck": fsck_rec,
            "remotes": remotes, "planted": planted, "steps": steps,
            "crc32c": {"impl": CRC32C_IMPL, "s": crc_s, "bytes": crc_b,
                       "mb_per_s": crc_b / crc_s / 1e6 if crc_s else None},
            "parts_s": {k: v for k, v in parts.items()
                        if k != "crc32c_bytes"},
            "launches": launches,
            "rowhash_shapes": [[n, c, k] for (n, c), k in
                               sorted(rshapes.items())],
            **shapes,
            "seconds": time.perf_counter() - t_phase}


def tiers_split(torch, tiers: list, kern: dict, seed: int) -> dict:
    """The tiers windows' kernels at their own shapes: the rowhash shapes
    that fsck's signature recompute and the clone's edit launched (the
    most launched first, up to four) EXACT and timed with their bounds,
    and every distinct searchsorted, zone-window, probe and segsum shape
    held EXACT (``exact_sweep``). The rowhash rows go to the end of
    ``kern["rowhash"]``."""
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    hist = shape_hist(tiers, "rowhash_shapes")
    rows = []
    for (r, c), launches in sorted(hist.items(),
                                   key=lambda kv: (-kv[1], kv[0]))[:4]:
        row = rowhash_row(torch, r, c, g)
        row["launches"] = launches
        rows.append(row)
    kern["rowhash"] += rows
    swept = exact_sweep(torch, {
        "searchsorted": shape_hist(tiers, "searchsorted_shapes"),
        "zone_windows": shape_hist(tiers, "zone_window_shapes"),
        "probe": shape_hist(tiers, "probe_shapes"),
        "segsum_diff": shape_hist(tiers, "segsum_shapes")}, seed)
    return phase("tiers_split", rowhash=[
        {f: e[f] for f in ("shape", "ok", "max_abs_err", "ms", "device_ms",
                           "plain_ms", "bound_ms", "bound_by",
                           "device_bound_share", "launches")}
        for e in rows], rowhash_shapes=len(hist), exact=swept,
        seconds=time.perf_counter() - t0)


# -------------------------------------------------------------------- serve

def host_cost(torch, model, prompt) -> dict:
    """What bounds eager decode: aten operations dispatched for one decode
    token (a dispatch-mode count) and the host's cost of one small CUDA op
    (host clock over 2,000 in-place adds on one element, then a sync)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    cache = model.init_cache(1, prompt.shape[1])
    with Count():
        model.decode_step(prompt[:, :1], cache)
    x = torch.zeros(1, device=model.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        x.add_(1)
    torch.cuda.synchronize()
    return {"aten_ops_per_decode_token": Count.n,
            "host_us_per_small_op": (time.perf_counter() - t0) / 2000 * 1e6}


def serve_phase(torch, seed: int) -> dict:
    """The serving path at full width: continuous batching over
    SERVE_PROMPTS, then the prefill-vs-decode consistency check."""
    import numpy as np

    from repro_torch.benchmarks.serve_consistency import (
        prefill_decode_logits, rel_gap)
    from repro_torch.kernels import build
    from repro_torch.launch.serve import Request, Server

    gc.collect()                  # earlier phases' engines hold the card
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    srv = Server(SERVE_ARCH, reduced=False, batch=4, seq_cap=4096,
                 seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg, model = srv.cfg, srv.model
    check((cfg.n_layers, cfg.d_model, cfg.vocab) == (24, 1024, 151936),
          f"not the full-width config: {cfg}")
    check(model.device.type == "cuda", "the model is off the card")
    check(all(n % srv.attn_block == 0 for n in SERVE_PROMPTS),
          "a prompt would take the pad path")
    rng = np.random.default_rng(seed)
    reqs = [Request(i, rng.integers(2, cfg.vocab, size=n).astype(np.int32),
                    SERVE_NEW) for i, n in enumerate(SERVE_PROMPTS)]

    build.reset_launches()
    done, dt, steps = srv.run(reqs)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    n_new = sum(len(r.out) for r in done)
    pre = [x * 1e3 for x in srv.timings["prefill_s"]]
    dec = [x * 1e3 for x in srv.timings["decode_step_s"]]
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab, "batch": srv.batch,
           "seq_cap": srv.seq_cap, "prompts": list(SERVE_PROMPTS),
           "max_new": SERVE_NEW, "init_s": init_s, "run_s": dt,
           "decode_steps": steps, "generated": n_new,
           "tok_per_s": n_new / dt,
           "prefill_ms": pre, "prefill_tok_per_s": sum(SERVE_PROMPTS)
           / (sum(pre) / 1e3),
           "decode_step_ms": {"mean": sum(dec) / len(dec),
                              "median": sorted(dec)[len(dec) // 2],
                              "max": max(dec)},
           # lockstep steps decode up to `batch` slots, one token each
           "decode_ms_per_token": sum(dec) / (n_new - len(reqs)),
           "flash_launches": launches["flash_attention"],
           "launches": launches,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "allocated_at_start": start_bytes,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in model.parameters())}
    want = cfg.n_layers * len(reqs)
    check(rec["flash_launches"] == want,
          f"flash_attention launched {rec['flash_launches']} times on the "
          f"serve path, not {want} (layers x requests)")
    check(all(len(r.out) == SERVE_NEW and all(0 <= t < cfg.vocab
                                              for t in r.out) for r in done),
          "a generated token is out of range or a request is short")

    # Prefill-vs-decode consistency: the last logits of one prompt from
    # the flash kernel (L1) and from plain decode attention (L2).
    n, tail = SERVE_CONSIST
    prompt = torch.as_tensor(rng.integers(2, cfg.vocab, size=n),
                             device=model.device)[None]
    l1, l2 = prefill_decode_logits(model, prompt, tail, srv.attn_block)
    finite = bool(torch.isfinite(l1).all() and torch.isfinite(l2).all())
    rel = rel_gap(l1, l2)
    rec["consistency"] = {
        "prompt": n, "decoded": tail, "finite": finite,
        "max_abs_diff": float((l1 - l2).abs().max()),
        "logit_abs_max": float(l1.abs().max()),
        "logit_std": float(l1.std()),
        "rel_l2_diff": rel, "rel_l2_tol": SERVE_REL_TOL,
        "argmax_equal": int(l1.argmax()) == int(l2.argmax())}
    check(finite, "non-finite logits")
    check(rel <= SERVE_REL_TOL, f"prefill and decode logits differ: "
                                f"{rec['consistency']}")

    rec["profile_prefill_2048"] = device_profile(
        torch, lambda: model.prefill(prompt, seq_cap=n,
                                     attn_block=srv.attn_block))

    def decode16():
        c = model.init_cache(1, n)
        c["len"] = n - tail       # a full-length cache, as in the check
        for i in range(16):
            _, c = model.decode_step(prompt[:, i:i + 1], c)
    rec["profile_decode_16"] = device_profile(torch, decode16)
    rec.update(host_cost(torch, model, prompt))
    return rec


def param_count(cfg) -> int:
    """Parameters of ``cfg``, leaf by leaf as the reference's
    ``init_params`` makes them: per layer two norms, the mixer's leaves
    (attention's Q/K/V/O and QKV biases; mamba's w_in, w_bcdt, w_out,
    conv, a_log, dt_bias and d_skip; rwkv's five mu, six d x d matrices,
    dec_bias, u and ln_x; a cross slot's Q/K/V/O; an encoder-decoder
    config's cross sublayer, ln_x and xq..xo) and the FFN's (the gated
    MLP, or the router and E gated experts); then embed, head and the
    final norm, the learned position table, and an encoder's layers (two
    norms, Q/K/V/O and the gated MLP each), its norm and its position
    table. The config's ``n_params()`` is the reference's approximation:
    it leaves out the norms, biases and routers, rwkv's w_dec, the cross
    sublayer and the position tables, and counts mamba's w_bcdt as di
    (2 ds + 2)."""
    d, hd, H, KV = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    qkvo = 2 * d * H * hd + 2 * d * KV * hd
    mixer = {"attn": qkvo + (H * hd + 2 * KV * hd if cfg.qkv_bias else 0)}
    mixer["cross"] = mixer["attn"]
    if cfg.is_encdec:       # the decoder's cross sublayer: ln_x, xq..xo
        mixer["attn"] += d + qkvo
    if cfg.ssm is not None:
        s = cfg.ssm
        di = s.expand * d
        nh = di // s.head_dim
        mixer["mamba"] = 3 * d * di + d * (2 * s.d_state + nh) \
            + s.d_conv * di + 3 * nh
        # mu_*, the six matrices, then dec_bias, u (H x hd) and ln_x
        mixer["rwkv"] = 5 * d + 6 * d * d + 3 * d
    ffn = {"mlp": 3 * d * cfg.d_ff}
    if cfg.moe is not None:
        ffn["moe"] = d * cfg.moe.n_experts \
            + 3 * cfg.moe.n_experts * d * cfg.d_ff
    per_period = sum(2 * d + mixer[k] + ffn[f]
                     for k, f in zip(cfg.slot_kinds(), cfg.ffn_kinds()))
    total = per_period * cfg.n_periods + 2 * cfg.vocab * d + d
    if cfg.learned_pos:
        total += cfg.max_seq * d                    # pos
    if cfg.is_encdec:       # per layer two norms, Q/K/V/O, the MLP; then
        total += cfg.encoder_layers * (2 * d + qkvo + ffn["mlp"]) \
            + d + cfg.max_seq * d                   # enc_norm, enc_pos
    return total


def cross_bytes(cache) -> int:
    """Bytes of a decode cache's cross K/V (``models.lm.CROSS_KV``), which
    every decode step reads whole."""
    from repro_torch.models.lm import CROSS_KV

    names = {name for pair in CROSS_KV for name in pair}
    return sum(t.numel() * t.element_size()
               for key, entry in cache.items()
               if key.startswith("slot") and isinstance(entry, dict)
               for name, t in entry.items() if name in names)


def decode_weight_bytes(model) -> int:
    """Bytes of the weights a decode step at B = 1 reads: every parameter
    but the embedding and the learned position table (one row of each)
    and the encoder's (it runs in the prefill only)."""
    return sum(p.numel() * p.element_size()
               for name, p in model.named_parameters()
               if name not in ("embed", "pos", "enc_pos", "enc_norm")
               and not name.startswith("encoder."))


def cache_bytes(cache, ssm_only: bool = False) -> int:
    """Bytes of a decode cache's tensors: every slot's, or with
    ``ssm_only`` those of the state-space slots (a tuple of states)."""
    total = 0
    for key, entry in cache.items():
        if not key.startswith("slot"):
            continue
        if ssm_only and not isinstance(entry, tuple):
            continue
        parts = entry.values() if isinstance(entry, dict) else entry
        total += sum(t.numel() * t.element_size() for t in parts)
    return total


def serve_model(torch, arch: str, layers, seed: int,
                published_scale: bool = False) -> dict:
    """One config at its published widths (depth cut to the stack's first
    ``layers`` where given; ``published_scale``: the cut's layer matrices
    at the published depth's init scale) through the serving path: built
    from the seed, two requests through ``Server`` (prefill on the flash
    kernel for its attention layers, a few decode steps), then the
    prefill-vs-decode consistency check. A config with an encoder or
    cross slots serves the Server's stub context and then, in the check
    and in ``cross_context``, a context of real size drawn from the seed
    (CROSS_CONTEXT). A config with state-space slots
    also serves SSM_SOLO_PROMPTS one request at a time (their decode ms
    a token and the state's bytes after each prefill, equal whatever the
    prompt length for a config without attention), and holds the check
    at the first decoded position too, with ``ssm_faults`` planted there
    (each must exceed the tolerance) and at TAIL (recorded). Returns its
    record; the caller frees the model."""
    import numpy as np

    from repro_torch.benchmarks.serve_consistency import (
        TAIL, prefill_decode_logits, rel_gap, ssm_faults)
    from repro_torch.configs import first_layers, get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import Request, Server

    full = get_config(arch)
    cfg = full if layers is None else first_layers(full, layers)
    W = cfg.sliding_window
    kinds = cfg.slot_kinds()
    n_attn = self_attention_layers(cfg)
    has_ssm = bool(set(kinds) & {"mamba", "rwkv"})
    solo = SSM_SOLO_PROMPTS if has_ssm and not n_attn else ()
    prompts = SERVE_MODELS_PROMPTS if not W else \
        (WINDOW_PROMPT,) + SERVE_MODELS_PROMPTS[1:]
    t_all = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = Server(cfg, reduced=False, batch=2,
                 seq_cap=max(prompts + solo) + 64, seed=seed)
    if published_scale:
        published_init_scale(torch, srv.model)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model = srv.model
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    check(n_params == param_count(cfg), f"{arch}: {n_params} parameters, "
          f"not the config's {param_count(cfg)}")
    check(all(n % srv.attn_block == 0 for n in prompts + solo),
          "a prompt would take the pad path")
    ctx = None
    if model.needs_context:     # N(0, 1) frame or patch embeddings
        ctx = torch.randn(
            (1, CROSS_CONTEXT.get(arch, cfg.cross_len), cfg.d_model),
            generator=torch.Generator(device=model.device).manual_seed(
                seed), device=model.device).bfloat16()
    rng = np.random.default_rng(seed)
    reqs = [Request(i, rng.integers(2, cfg.vocab, size=n).astype(np.int32),
                    SERVE_MODELS_NEW) for i, n in enumerate(prompts)]
    # the bytes of each prefill's cache, and of its recurrent states
    prefill_one, cached = srv._prefill_one, []

    def prefill_recorded(req):
        logits, cache = prefill_one(req)
        cached.append((len(req.prompt), cache_bytes(cache),
                       cache_bytes(cache, ssm_only=True),
                       cross_bytes(cache)))
        return logits, cache
    srv._prefill_one = prefill_recorded
    build.reset_launches()
    done, dt, steps = srv.run(reqs)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    flash = launches.get("flash_attention", 0)
    want = attention_layers(cfg) * len(reqs)
    check(flash == want,
          f"{arch}: flash_attention launched {flash} times on the serve "
          f"path, not {want} (attention launches a prefill x requests)")
    check(all(len(r.out) == SERVE_MODELS_NEW and all(
        0 <= t < cfg.vocab for t in r.out) for r in done),
        f"{arch}: a generated token is out of range or a request is short")
    pre = srv.timings["prefill_s"]
    dec = srv.timings["decode_step_s"]
    n_dec = sum(len(r.out) for r in done) - len(reqs)
    # a decode step at B = 1 reads every decoder weight (the MoE runs
    # every expert over its capacity slots, as the reference does), the
    # cache's valid keys and values and its cross K/V whole, and reads
    # and writes the recurrent state
    kv_row = 2 * n_attn * cfg.n_kv_heads * cfg.hd * 2
    cached_pos = min(prompts[0], W) if W else prompts[0]
    state_bytes = cached[0][2]
    read = decode_weight_bytes(model) + kv_row * cached_pos \
        + 2 * state_bytes + cached[0][3]
    rec = {"arch": arch, "n_layers": cfg.n_layers,
           "published_layers": full.n_layers,
           "cut": None if layers is None else
           f"n_layers {full.n_layers} -> {layers}"
           + (f", period {full.period} -> {cfg.period} (slots "
              f"{list(kinds)}, ffn {list(cfg.ffn_kinds())})"
              if cfg.period != full.period else ""),
           "init_scale_periods": full.n_periods if published_scale
           else cfg.n_periods,
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "hd": cfg.hd, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "moe": None if not cfg.moe else [cfg.moe.n_experts,
                                            cfg.moe.top_k],
           "ssm": None if not has_ssm else {
               "slots": sorted(set(kinds) - {"attn"}),
               "d_state": cfg.ssm.d_state, "head_dim": cfg.ssm.head_dim,
               "d_conv": cfg.ssm.d_conv, "expand": cfg.ssm.expand},
           "cross": None if ctx is None else {
               "encoder_layers": cfg.encoder_layers,
               "cross_layers": kinds.count("cross") * cfg.n_periods,
               "learned_pos": cfg.learned_pos,
               "server_context": cfg.cross_len or 8,
               "context": ctx.shape[1]},
           "attention_layers": n_attn,
           "flash_per_prefill": attention_layers(cfg),
           "window": W, "params": n_params,
           "param_count": param_count(cfg),
           "n_params_formula": int(cfg.n_params()),
           "param_bytes": param_bytes,
           "init_s": init_s, "prompts": list(prompts),
           "max_new": SERVE_MODELS_NEW, "run_s": dt, "decode_steps": steps,
           "flash_launches": flash,
           "launches": launches,
           "prefill_ms": [x * 1e3 for x in pre],
           "prefill_tok_per_s": sum(prompts) / sum(pre),
           "decode_ms_per_token": sum(dec) / n_dec * 1e3,
           "state_bytes": state_bytes,
           "cache_bytes": cached[0][1], "cross_bytes": cached[0][3],
           "decode_read_bytes": read,
           "decode_bound_ms": read / HBM_BYTES_PER_S * 1e3}

    # one request at a time: decode ms a token after a short and a long
    # prefill, and the state's bytes after each
    solo_rec = []
    for n in solo:
        cached.clear()
        req = Request(len(solo_rec), rng.integers(
            2, cfg.vocab, size=n).astype(np.int32), SERVE_MODELS_NEW)
        build.reset_launches()
        srv.run([req])
        torch.cuda.synchronize()
        dec = srv.timings["decode_step_s"]
        solo_rec.append({
            "prompt": n, "prefill_ms": srv.timings["prefill_s"][0] * 1e3,
            "prefill_tok_per_s": n / srv.timings["prefill_s"][0],
            "decode_ms_per_token": sum(dec) / len(dec) * 1e3,
            "decode_step_ms": [x * 1e3 for x in dec],
            "decode_ms_median": sorted(dec)[len(dec) // 2] * 1e3,
            "cache_bytes": cached[0][1], "state_bytes": cached[0][2],
            "launches": dict(build.LAUNCHES),
            "max_memory_allocated": torch.cuda.max_memory_allocated()})
        check(len(req.out) == SERVE_MODELS_NEW,
              f"{arch}: the {n}-token request is short")
    if solo:
        rec["solo"] = solo_rec
        check(len({e["cache_bytes"] for e in solo_rec}) == 1,
              f"{arch}: the state's bytes depend on the prompt's length: "
              f"{solo_rec}")

    # MoE: the decode side replays the whole prefill's routes, so both
    # sides compute one function (serve_consistency's docstring); the gap
    # with each side routing for itself is recorded beside it, unheld
    fixed = cfg.moe is not None
    n = (WINDOW_PROMPT if W else SERVE_MODELS_PROMPTS[0]) + TAIL
    prompt = torch.as_tensor(rng.integers(2, cfg.vocab, size=n),
                             device=model.device)[None]

    def gap(tail, plant=None, own=False, length=n):
        l1, l2 = prefill_decode_logits(model, prompt[:, :length], tail,
                                       srv.attn_block, plant=plant,
                                       fixed_routes=fixed and not own,
                                       ctx=ctx)
        return l1, l2, rel_gap(l1, l2)
    l1, l2, rel = gap(TAIL)
    finite = bool(torch.isfinite(l1).all() and torch.isfinite(l2).all())
    rec["consistency"] = {
        "prompt": n, "prefilled": n - TAIL, "decoded": TAIL,
        "fixed_routes": fixed,
        "context": None if ctx is None else list(ctx.shape),
        "finite": finite, "max_abs_diff": float((l1 - l2).abs().max()),
        "logit_abs_max": float(l1.abs().max()), "rel_l2_diff": rel,
        "rel_l2_tol": SERVE_REL_TOL,
        "argmax_equal": int(l1.argmax()) == int(l2.argmax())}
    if fixed:
        rec["consistency"]["own_routes_rel_l2_diff"] = gap(TAIL,
                                                           own=True)[2]
    check(finite, f"{arch}: non-finite logits")
    check(rel <= SERVE_REL_TOL, f"{arch}: prefill and decode logits "
                                f"differ: {rec['consistency']}")
    if has_ssm:
        # where the time goes: a prefill of the first prompt's length and
        # 8 decode steps after it, under the profiler
        n0 = SERVE_MODELS_PROMPTS[0]
        rec["profile_prefill"] = device_profile(
            torch, lambda: model.prefill(prompt[:, :n0], seq_cap=n,
                                         attn_block=srv.attn_block))
        cache = model.prefill(prompt[:, :n0], seq_cap=n,
                              attn_block=srv.attn_block)[1]

        def decode8():
            c = cache
            for i in range(n0, n0 + 8):
                _, c = model.decode_step(prompt[:, i:i + 1], c)
        rec["profile_decode_8"] = device_profile(torch, decode8)
        del cache
        # a recurrent state forgets a fault as it decays, so the faults
        # are held where the decode starts: one position decoded
        m = FIRST_STEP_PROMPT
        first = gap(1, length=m)[2]
        faults = {"first_step": {}, "at_tail": {}}
        for tail, key, length in ((1, "first_step", m),
                                  (TAIL, "at_tail", n)):
            for name, plant in ssm_faults(model, prompt, length - tail,
                                          srv.attn_block).items():
                faults[key][name] = gap(tail, plant, length=length)[2]
        rec["consistency"].update(
            first_step_prompt=m, first_step_rel_l2_diff=first,
            ssm_faults=faults,
            ssm_faults_held="first_step > tol; at_tail recorded, unheld")
        check(first <= SERVE_REL_TOL, f"{arch}: prefill and decode logits "
              f"differ at the first decoded position: {first}")
        check(all(g > SERVE_REL_TOL for g in faults["first_step"].values()),
              f"{arch}: a planted state fault stays within the "
              f"tolerance: {faults}")
    if W:
        check(n - TAIL > W and (n - TAIL) % W == 0,
              f"{arch}: the check's prefill does not bind the window")
        m = RING_OFFSET_PREFILL + TAIL
        r1, r2 = prefill_decode_logits(model, prompt[:, :m], TAIL,
                                       srv.attn_block, fixed_routes=fixed)
        rec["ring_offset_gap"] = {
            "prefilled": RING_OFFSET_PREFILL, "decoded": TAIL,
            "rel_l2_diff": rel_gap(r1, r2),
            "is": "the reference's ring-buffer fault, kept for parity "
                  "(ROADMAP Queue 3): a prefill of S > W positions, S % W "
                  "!= 0, then decode; recorded, not held to a limit"}
    if ctx is not None:
        rec["real_context"] = cross_context(torch, model, prompt, ctx, l1,
                                            seed, srv.attn_block)
    torch.cuda.synchronize()
    total = torch.cuda.get_device_properties(0).total_memory
    rec.update(max_memory_allocated=torch.cuda.max_memory_allocated(),
               max_memory_reserved=torch.cuda.max_memory_reserved(),
               free_at_peak=total - torch.cuda.max_memory_reserved(),
               seconds=time.perf_counter() - t_all)
    return rec


def cross_context(torch, model, prompt, ctx, l1, seed: int,
                  attn_block: int) -> dict:
    """A config with an encoder or cross slots served with a context of
    real size, ``ctx``: the prefill of the first SERVE_MODELS_PROMPTS
    length (ms a call over CROSS_TIMED, whisper's encoder alone apart),
    8 decode steps after it (ms each, beside the bound:
    the decoder's weights, the valid KV and the cached cross K/V read
    once), the cross cache's bytes, both under the profiler; then, at the
    first decoded position, the clean gap and ``cross_faults`` (each
    must exceed SERVE_REL_TOL), and the gap between ``l1``, the last
    logits of ``prompt`` with ``ctx``, and those with another context
    drawn from the seed, which must exceed it too."""
    from repro_torch.benchmarks.serve_consistency import (
        cross_faults, prefill_decode_logits, rel_gap)

    cfg = model.cfg
    n0 = SERVE_MODELS_PROMPTS[0]
    cap = n0 + 8
    other = torch.randn(ctx.shape, generator=torch.Generator(
        device=model.device).manual_seed(seed + 1),
        device=model.device).bfloat16()

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CROSS_TIMED):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / CROSS_TIMED * 1e3, out

    def prefill():
        return model.prefill(prompt[:, :n0], ctx, seq_cap=cap,
                             attn_block=attn_block)
    torch.cuda.reset_peak_memory_stats()
    pre_ms, (_, cache) = timed(prefill)
    enc_ms = timed(lambda: model.encode(ctx))[0] if cfg.is_encdec \
        else None
    cross = cross_bytes(cache)

    def decode8(ms=None):       # rewrites the same 8 positions each time
        c = cache
        for i in range(n0, n0 + 8):
            t0 = time.perf_counter()
            _, c = model.decode_step(prompt[:, i:i + 1], c)
            if ms is not None:
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
    dec_ms = []
    decode8(dec_ms)
    peak = torch.cuda.max_memory_allocated()
    kv_row = 2 * self_attention_layers(cfg) * cfg.n_kv_heads * cfg.hd * 2
    read = decode_weight_bytes(model) + kv_row * n0 + cross
    rec = {"context": list(ctx.shape), "prompt": n0,
           "prefill_ms": pre_ms, "prefill_tok_per_s": n0 / pre_ms * 1e3,
           "encoder_ms": enc_ms,
           "decode_step_ms": dec_ms,
           "decode_ms_per_token": sum(dec_ms) / len(dec_ms),
           "decode_ms_median": sorted(dec_ms)[len(dec_ms) // 2],
           "decode_read_bytes": read,
           "decode_bound_ms": read / HBM_BYTES_PER_S * 1e3,
           "cross_bytes": cross, "max_memory_allocated": peak,
           "profile_prefill": device_profile(torch, prefill),
           "profile_decode_8": device_profile(torch, decode8)}
    del cache

    m = n0 + 1                  # the first decoded position
    first = rel_gap(*prefill_decode_logits(model, prompt[:, :m], 1,
                                           attn_block, ctx=ctx))
    faults = {name: rel_gap(*prefill_decode_logits(
        model, prompt[:, :m], 1, attn_block, plant=plant, ctx=ctx))
        for name, plant in cross_faults(model, prompt[:, :m], m - 1, other,
                                        attn_block).items()}
    l_other = model.prefill(prompt, other, seq_cap=prompt.shape[1],
                            attn_block=attn_block)[0].float()
    rec.update(first_step_prompt=m, first_step_rel_l2_diff=first,
               cross_faults=faults, context_change_rel_l2_diff=rel_gap(
                   l1, l_other), rel_l2_tol=SERVE_REL_TOL)
    name = cfg.name
    check(first <= SERVE_REL_TOL, f"{name}: prefill and decode logits "
          f"differ at the first decoded position: {first}")
    check(all(g > SERVE_REL_TOL for g in faults.values()),
          f"{name}: a planted cross fault stays within the tolerance: "
          f"{faults}")
    check(rec["context_change_rel_l2_diff"] > SERVE_REL_TOL,
          f"{name}: another context moves the logits by "
          f"{rec['context_change_rel_l2_diff']} only")
    return rec


def serve_models_phase(torch, seed: int, models=SERVE_MODELS,
                       published_scale: bool = False,
                       name: str = "serve_model") -> dict:
    """Every config of ``models`` through ``serve_model``, each built,
    served, measured and freed before the next."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recs = []
    for arch, layers in models:
        recs.append(serve_model(torch, arch, layers, seed,
                                published_scale))
        phase(name, **recs[-1])
        gc.collect()
        torch.cuda.empty_cache()
    return {"models": recs, "seconds": time.perf_counter() - t0,
            "flash_launches": sum(r["flash_launches"] for r in recs)}


# -------------------------------------------------------------------- train

def attention_layers(cfg) -> int:
    """Flash launches of one forward (a prefill) of ``cfg``: one per
    attention layer, two in an encoder-decoder config's decoder layers
    (self and cross), one per cross layer and one per encoder layer: 0
    for rwkv6, 1 in jamba's training cut, 72 for whisper-medium and 30
    for llama-3.2-vision-90b's first 30 layers."""
    kinds = cfg.slot_kinds()
    per_period = kinds.count("attn") * (2 if cfg.is_encdec else 1) \
        + kinds.count("cross")
    return per_period * cfg.n_periods + cfg.encoder_layers


def self_attention_layers(cfg) -> int:
    """Layers of ``cfg`` with causal self-attention (its attention slots
    times its periods)."""
    return cfg.slot_kinds().count("attn") * cfg.n_periods


def train_flops(n_params: int, cfg, batch: int, seq: int,
                ctx_len: int = 0) -> float:
    """Model FLOPs of one training step of ``batch`` rows of ``seq``
    tokens over a context of ``ctx_len`` positions (frames or patches):
    6 N T for the dense work, N the parameters a token meets (an MoE's
    active ones) and T the tokens; an encoder's parameters
    (``n_params_encoder``) over the frames instead. The lookup tables,
    whose rows are read and not multiplied, are left out: the token
    embedding (never tied to ``lm_head``, which is a product and counts)
    and the learned position tables.
    Plus attention's over its unmasked pairs, 3.5 x its forward (the
    backward is 2.5 x): the tokens' causal pairs (under a sliding window,
    those inside it) on each self-attention layer, the frames' S^2 on
    each encoder layer, and S x L on each cross layer or cross sublayer.
    A remat step's recomputed forward is not model work and is not
    counted. The state-space mixers' own terms (the intra-chunk products
    and the state's updates, beyond their weights' 6 N T) are left out:
    at the published widths they are under 0.5% of 6 N T (jamba's mamba
    about 3 MFLOP a token and layer against 2 GFLOP, rwkv6 about 2
    against 0.55)."""
    W = cfg.sliding_window
    pairs = window_pairs(seq, seq, W) if W else \
        attention_pairs(seq, seq, True)
    n_enc = int(cfg.n_params_encoder())
    n_lookup = cfg.vocab * cfg.d_model + cfg.max_seq * cfg.d_model * (
        int(cfg.learned_pos) + int(cfg.is_encdec))
    cross = attention_layers(cfg) - self_attention_layers(cfg) \
        - cfg.encoder_layers
    pairs_all = pairs * self_attention_layers(cfg) \
        + ctx_len * ctx_len * cfg.encoder_layers + seq * ctx_len * cross
    return 6.0 * (n_params - n_enc - n_lookup) * batch * seq \
        + 6.0 * n_enc * batch * ctx_len \
        + 3.5 * 4.0 * batch * cfg.n_heads * cfg.hd * pairs_all


def train_launches(cfg, steps: int, n_micro: int = 1) -> dict:
    """The attention kernels' launches that ``steps`` remat steps of
    ``cfg`` in ``n_micro`` microbatches make: the forward twice a decoder
    attention (remat runs it again in the backward) and once an encoder
    layer (the encoder is not rematerialised, as in the reference), the
    backward once each."""
    n = attention_layers(cfg) * steps * n_micro
    enc = cfg.encoder_layers * steps * n_micro
    return {"flash_attention": 2 * n - enc, "flash_attention_bwd": n}


#: layer matrices whose init scale is fixed, not 1/sqrt(periods)
FIXED_SCALE = (".router", ".conv", ".w_dec")


def published_init_scale(torch, model) -> None:
    """Take a depth-cut model's layer matrices to the published depth's
    init scale, in place: ``LM`` draws them at 1/sqrt(the cut's periods),
    the published model's first layers are drawn at 1/sqrt(its own)
    (a one-layer cut would draw them at 1); an encoder's matrices alike,
    at 1/sqrt(its layers). The matrices with a fixed scale
    (``FIXED_SCALE``) keep it. Each is scaled in float32 and rounded to
    bf16, in slices, so that a 9.7 B-parameter expert stack needs no
    float32 copy of its own."""
    from repro_torch.configs import get_config

    cfg = model.cfg
    published = get_config(cfg.name)
    rescale = {"layers": math.sqrt(cfg.n_periods / published.n_periods)}
    if cfg.is_encdec:
        rescale["encoder"] = math.sqrt(cfg.encoder_layers
                                       / published.encoder_layers)
    with torch.no_grad():
        for name, p in model.named_parameters():
            factor = rescale.get(name.split(".")[0], 1.0)
            if (factor != 1.0 and p.dim() >= 2
                    and not name.endswith(FIXED_SCALE)):
                for part in p.view(-1).split(1 << 26):
                    part.copy_((part.float() * factor).bfloat16())


def leaf_gaps(torch, card: dict, cpu: dict, f32: dict) -> dict:
    """The card's gradients leaf by leaf (name -> gradient) against the
    CPU's bf16 ones and float32's. For every leaf that float32 gives a
    gradient: the norms' relative gap card vs CPU (``rel_diff``), each
    bf16 side's distance from float32 over float32's norm (``card_err``,
    ``cpu_err``) and their ratio (``err_ratio``). Returns the median and
    the worst leaf by gap, the worst by ratio, the leaves that float32
    gives exactly none (``zero_on_both``: none on either bf16 side too),
    the leaf with the largest share of the float32 norm's square, and
    ``by_leaf``, [card, cpu, cpu_f32, card_err, cpu_err] norms. Each
    leaf is moved once to the card's gradients' device and summed there
    in float64, in slices."""
    dev = next(iter(card.values())).device
    rows = {}
    for n, g in f32.items():
        flat = [(torch.zeros_like(g) if t is None else t).to(dev).reshape(-1)
                for t in (card[n], cpu[n], g)]
        sums = [0.0] * 5
        for i in range(0, g.numel(), 1 << 24):
            c, p, f = (t[i:i + (1 << 24)].double() for t in flat)
            # squares of card, cpu, float32, card - float32, cpu - float32
            for j, t in enumerate((c, p, f, c - f, p - f)):
                sums[j] += float(torch.sum(torch.square(t)))
        c, p, f, ce, pe = (math.sqrt(x) for x in sums)
        rows[n] = [c, p, f, ce / f, pe / f] if f else [c, p, f, None, None]

    def leaf(n):
        c, p, f, ce, pe = rows[n]
        return {"leaf": n, "card": c, "cpu": p, "cpu_f32": f,
                "rel_diff": abs(c - p) / p if p else math.inf,
                "card_err": ce, "cpu_err": pe,
                "err_ratio": 0.0 if ce == 0 else ce / pe if pe
                else math.inf}
    live = sorted((leaf(n) for n in rows if rows[n][2] > 0),
                  key=lambda e: e["rel_diff"])
    zero = sorted(n for n in rows if rows[n][2] == 0)
    top = max(live, key=lambda e: e["cpu_f32"])
    return {"leaves": len(rows), "median_gap": live[len(live) // 2],
            "worst_gap": live[-1],
            "worst_err_ratio": max(live, key=lambda e: e["err_ratio"]),
            "zero_in_f32": zero,
            "zero_on_both": all(rows[n][0] == rows[n][1] == 0 for n in zero),
            "largest": dict(top, share=top["cpu_f32"] ** 2
                            / sum(r[2] ** 2 for r in rows.values())),
            "by_leaf": rows}


def unit_scores(torch, model) -> dict:
    """Scale each attention's query matrix (``wq``, and the cross
    sublayer's ``xq``) of a model at the published init scale, in place,
    so that its attention scores have a standard deviation near one. At
    that init a layer matrix is N(0, 1/P), P the published periods (an
    encoder's: its layers), and its input has unit RMS (a norm's output,
    or a context of unit variance), so each query and key element has a
    variance of d / P and each score (q.k / sqrt(hd)) a standard
    deviation of d / P: 42.7 for whisper-medium, 409.6 for llama-3.2-
    vision-90b. Attention there is an argmax that one bf16 rounding
    flips, and two bf16 paths then part by the flips, not by their
    kernels. Scaling the queries by P / d keeps every weight, kernel and
    shape of the step and takes the scores to one standard deviation,
    where bf16 against float32 measures the kernels' rounding. Returns
    the factor of each stack."""
    from repro_torch.configs import get_config

    cfg = model.cfg
    published = get_config(cfg.name)
    factor = {"layers": published.n_periods / cfg.d_model}
    if cfg.is_encdec:
        factor["encoder"] = published.encoder_layers / cfg.d_model
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith((".wq", ".xq")):
                p.copy_((p.float() * factor[name.split(".")[0]]).bfloat16())
    return factor


def card_vs_cpu_step(torch, cfg, seed: int, remat: bool = False,
                     ctx_len: int = 0, check_batch=TRAIN_CHECK) -> dict:
    """One full-width loss and gradient (``loss_fn(..., remat=remat)`` and
    its backward, the work of ``train_step`` before AdamW) on the card and
    on the CPU's plain path, from the same bf16 weights and a batch of
    ``check_batch`` (rows, tokens): the loss and the global gradient norm, each
    within its tolerance, and leaf by leaf (``leaf_gaps``): the median
    leaf's norm within the same tolerance, each leaf's distance from the
    float32 gradient within TRAIN_LEAF_ERR_RATIO times the CPU's, and
    where float32 has no gradient, none. The same step on the CPU in
    float32 (the same weights, upcast) gives the bf16 noise floor the
    tolerance is read against. An MoE config's card step records its
    routes and the CPU steps replay them (``models.routes``), so both
    sides compute one function; the CPU's bf16 step with its own routing
    is recorded beside it (``own_routes``), unheld, and so are the
    choices that the card's remat recompute routed differently from its
    forward (``recompute_flips``, 0 expected). The weights are drawn
    once, on the card from a generator of one seed, and copied to the
    CPU's model and loaded into the float32 one, made on the card in a
    fraction of a second (a full-width draw on the CPU took 7-38 s of
    host time, llama-vision's cross layer and its 1.05 B-parameter
    embedding and head the longest). A
    config cut in depth keeps the published depth's init scale: the layer
    matrices are taken to 1/sqrt(published periods), as the published
    model's first layers are drawn (a one-layer cut would draw them at 1,
    where bf16 rounding moved phi3.5-moe's gradient norm by a third
    against float32). A config with a context takes one of ``ctx_len``
    positions, drawn on the CPU from the seed in bf16, and has its query
    matrices scaled by ``unit_scores`` (recorded as ``query_scale``)."""
    import contextlib
    import copy
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import routes
    from repro_torch.models.lm import LM, loss_fn
    from repro_torch.optim import global_norm

    b, n = check_batch
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, cfg.vocab, size=(b, n + 1))
    batch = {"tokens": torch.as_tensor(toks[:, :-1]),
             "targets": torch.as_tensor(toks[:, 1:])}
    if ctx_len:
        batch["ctx"] = torch.randn(
            (b, ctx_len, cfg.d_model),
            generator=torch.Generator().manual_seed(seed + 5)).bfloat16()
    log = routes.RouteLog(n)
    moe = cfg.moe is not None
    published = get_config(cfg.name).n_periods

    t_draw = time.perf_counter()
    # weights drawn on the card in float32, rounded to bf16, and copied
    card = LM(dataclasses.replace(cfg, dtype="bfloat16"), device="cuda",
              generator=torch.Generator("cuda").manual_seed(seed + 7))
    published_init_scale(torch, card)
    query_scale = unit_scores(torch, card) if ctx_len else None
    cpu = copy.deepcopy(card).to("cpu")

    def model(dtype, device):
        # made (and drawn) on the card, then given the CPU's weights,
        # held in dtype (the float32 leaves stay float32)
        m = LM(dataclasses.replace(cfg, dtype=dtype), device="cuda",
               generator=torch.Generator("cuda").manual_seed(seed))
        m.load_state_dict(cpu.state_dict())
        return m.to(device)
    draw_s = time.perf_counter() - t_draw
    out, grads = {}, {}
    for name, ctx in (("card", routes.recorded(log)),
                      ("cpu", routes.replayed(log)),
                      ("cpu_f32", routes.replayed(log)),
                      ("own_routes", contextlib.nullcontext())):
        if name == "own_routes" and not moe:
            continue
        m = {"card": card, "cpu": cpu, "own_routes": cpu}.get(name)
        if m is None:
            t_draw = time.perf_counter()
            m = model("float32", "cpu")
            draw_s += time.perf_counter() - t_draw
        for p in m.parameters():
            p.grad = None
        m.requires_grad_()
        build.reset_launches()
        t0 = time.perf_counter()
        with ctx if moe else contextlib.nullcontext():
            loss = loss_fn(m, {k: v.to(m.device) for k, v in batch.items()},
                           remat=remat)
            loss.backward()
        gnorm = global_norm(p.grad for p in m.parameters())
        out[name] = {"loss": loss.item(), "grad_norm": gnorm.item(),
                     "seconds": time.perf_counter() - t0}
        if name != "own_routes":
            grads[name] = {n: p.grad for n, p in m.named_parameters()}
        if name == "card":
            out["launches"] = dict(build.LAUNCHES)
        if name == "cpu_f32":
            out["leaves"] = leaf_gaps(torch, grads["card"], grads["cpu"],
                                      grads["cpu_f32"])
            grads.clear()
            del m
            gc.collect()
    del card, cpu
    gc.collect()
    torch.cuda.empty_cache()

    def rel(x, y, key):
        return abs(x[key] - y[key]) / abs(y[key])
    a, c, f = out["card"], out["cpu"], out["cpu_f32"]
    out["loss_rel_diff"] = rel(a, c, "loss")
    out["grad_norm_rel_diff"] = rel(a, c, "grad_norm")
    out["bf16_floor"] = {k: {"card_vs_f32": rel(a, f, k),
                             "cpu_bf16_vs_f32": rel(c, f, k)}
                         for k in ("loss", "grad_norm")}
    if moe:
        own = out["own_routes"]
        out["own_routes"].update(
            loss_rel_diff=rel(a, own, "loss"),
            grad_norm_rel_diff=rel(a, own, "grad_norm"),
            held=False)
        out["replayed_chunks"] = len(log.choices)
        out["recompute_flips"] = log.recompute_flips if remat else None
    out.update(batch=b, tokens=n, context=ctx_len, query_scale=query_scale,
               remat=remat, routes_replayed=moe,
               draw_seconds=draw_s,
               init_scale_periods=published,
               loss_tol=TRAIN_LOSS_TOL, grad_norm_tol=TRAIN_GNORM_TOL)
    check(all(math.isfinite(x[k]) for x in (a, c)
              for k in ("loss", "grad_norm")), f"non-finite check: {out}")
    check(out["loss_rel_diff"] <= TRAIN_LOSS_TOL
          and out["grad_norm_rel_diff"] <= TRAIN_GNORM_TOL
          and out["leaves"]["median_gap"]["rel_diff"] <= TRAIN_GNORM_TOL
          and out["leaves"]["worst_err_ratio"]["err_ratio"]
          <= TRAIN_LEAF_ERR_RATIO and out["leaves"]["zero_on_both"],
          f"the card's step differs from the CPU's: {out}")
    check(not moe or not remat or log.recompute_flips == 0,
          f"the card's remat recompute routed differently: {out}")
    return out


def train_phase(torch, seed: int) -> dict:
    """The training path at full width: versioned corpus, pinned snapshot,
    train_loop with one injected fault and its rollback, versioned
    checkpoints (restore bit for bit, changed shards), the example's
    curation and more steps on the new pin, and the card-vs-CPU step."""
    import contextlib
    import io

    from repro_torch.checkpoint import VcsCheckpointer
    from repro_torch.configs import get_config
    from repro_torch.core import Engine, snapshot_diff
    from repro_torch.data import (BatchPipeline, PinnedDataset, PipelineCfg,
                                  create_token_table, synth_corpus)
    from repro_torch.examples.train_versioned import curate
    from repro_torch.kernels import build
    from repro_torch.launch import train
    from repro_torch.optim import AdamWCfg

    gc.collect()                  # earlier phases' engines hold the card
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.vocab) == (24, 1024, 151936),
          f"not the full-width config: {cfg}")
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab,
           "samples": TRAIN_SAMPLES, "seq_len": TRAIN_SEQ,
           "global_batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
           "ckpt_every": TRAIN_CKPT_EVERY, "fault_at": TRAIN_FAULT_AT}
    t0 = time.perf_counter()
    engine = Engine(device="cuda")
    create_token_table(engine, "corpus")
    synth_corpus(engine, "corpus", n_samples=TRAIN_SAMPLES,
                 sample_len=TRAIN_SEQ + 1, vocab=cfg.vocab, seed=seed)
    rec["ingest_s"] = time.perf_counter() - t0
    rec["corpus_lob_bytes"] = TRAIN_SAMPLES * (TRAIN_SEQ + 1) * 4

    def run(**kw):
        """train_loop with its log kept (and echoed), its timings, and a
        repeated fault turned into a failed check."""
        times, buf = {}, io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                state, losses, _ = train.train_loop(
                    cfg, reduced=False, seq_len=TRAIN_SEQ,
                    global_batch=TRAIN_BATCH, engine=engine, device="cuda",
                    attn_block=TRAIN_SEQ, timings=times, **kw)
        except RuntimeError as err:
            raise SmokeFailure(f"train_loop: {err}") from err
        finally:
            print(buf.getvalue(), end="", flush=True)
        return state, losses, times, buf.getvalue().splitlines()

    build.reset_launches()
    t0 = time.perf_counter()
    state, losses, times, log = run(
        steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
        inject_fault_at=TRAIN_FAULT_AT, log_every=TRAIN_CKPT_EVERY)
    torch.cuda.synchronize()
    rec["run_s"] = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    rolled = [ln for ln in log if "rolled back" in ln]
    tags = sorted((t for t in engine.snapshots if "-step-" in t),
                  key=lambda t: int(t.rsplit("-", 1)[1]))
    # steps 1 .. fault - 1, then from the tag's step + 1 to the end
    n_steps = TRAIN_STEPS + TRAIN_FAULT_AT - 1 - TRAIN_CKPT_EVERY
    step_ms = [x * 1e3 for x in times["step_s"]]
    steady = sorted(step_ms[1:])
    median_ms = steady[len(steady) // 2]
    n_params = sum(p.numel() for p in state["params"].values())
    flops = train_flops(n_params, cfg, TRAIN_BATCH, TRAIN_SEQ)
    rec.update({
        "losses": losses, "rolled_back": rolled, "tags": tags,
        "step_ms": step_ms, "step_ms_median": median_ms,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (median_ms / 1e3),
        "n_params": n_params, "model_flops": flops,
        "model_flop_share": flops / (median_ms / 1e3) / BF16_FLOPS_PER_S,
        "save_s": times["save_s"], "restore_s": times["restore_s"],
        "launches": launches})
    check(len(rolled) == 1 and rolled[0].endswith(
        f"-step-{TRAIN_CKPT_EVERY}"), f"not one rollback to step "
        f"{TRAIN_CKPT_EVERY}: {rolled}")
    check(len(losses) == n_steps and all(math.isfinite(x) for x in losses),
          f"{len(losses)} losses (want {n_steps}), or one is not finite")
    want = cfg.n_layers * (n_steps + 1)       # the faulted step ran too
    check(launches["flash_attention"] == want
          and launches["flash_attention_bwd"] == want,
          f"attention kernels launched {launches}, not {want} each "
          f"(layers x steps run)")

    # the last tag holds the final state: restored bit for bit
    ck = VcsCheckpointer(engine, "ckpt")
    saved = train.ckpt_state(cfg, state["params"], state["opt"])
    t0 = time.perf_counter()
    back = ck.restore(tags[-1], saved)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    from repro_torch.checkpoint.vcs_ckpt import _flatten_state
    pairs = list(zip(_flatten_state(saved), _flatten_state(back)))
    check(all(torch.equal(a, b) for (_, a), (_, b) in pairs),
          f"{tags[-1]} does not restore bit for bit")
    ckpt_bytes = sum(a.numel() * a.element_size() for (_, a), _ in pairs)
    shards = engine.table("ckpt").count()
    del back, saved, pairs
    t0 = time.perf_counter()
    changed = {f"{a} -> {b}": ck.changed_shards(a, b)
               for a, b in zip(tags, tags[1:])}
    rec["checkpoint"] = {
        "bytes": ckpt_bytes, "shards": shards, "tags_kept": tags,
        "save_s": times["save_s"], "restore_in_loop_s": times["restore_s"],
        "restore_s": restore_s, "changed_shards": changed,
        "changed_shards_s": time.perf_counter() - t0,
        "restored_bit_for_bit": True}

    # one profiled step, then the state is dropped
    model, opt = state["model"], state["opt"]
    decay = train.decay_names(state["params"])
    pin = engine.snapshots[sorted(t for t in engine.snapshots
                                  if t.startswith("train-pin"))[0]]
    pipe = BatchPipeline(PinnedDataset(engine, pin),
                         PipelineCfg(seq_len=TRAIN_SEQ,
                                     global_batch=TRAIN_BATCH))
    batch = pipe.tensors_at(TRAIN_STEPS + 1, "cuda")
    opt_cfg = AdamWCfg(warmup_steps=2, decay_steps=TRAIN_STEPS)
    rec["profile_step"] = device_profile(
        torch, lambda: train.train_step(model, batch, opt, opt_cfg, decay,
                                        TRAIN_SEQ), focus="attn_bwd")
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    del state, model, opt, batch
    gc.collect()
    torch.cuda.empty_cache()

    # the example's phase 2, then more steps on the new pin
    old_pin = pin
    t0 = time.perf_counter()
    n_diff, rep_m = curate(engine, n_new=64, sample_len=TRAIN_SEQ + 1,
                           vocab=cfg.vocab, seed=seed + 1,
                           first_id=TRAIN_SAMPLES)
    rec["curate"] = {
        "review_diff_groups": n_diff, "merged": rep_m.inserted,
        "seconds": time.perf_counter() - t0,
        "old_pin_self_diff_groups": snapshot_diff(
            engine.store, old_pin, old_pin).n_groups,
        "old_pin_samples": PinnedDataset(engine, old_pin).n}
    check(n_diff == 64 and rep_m.inserted == 64,
          f"the curated review diff is not the 64 added samples: "
          f"{rec['curate']}")
    check(rec["curate"]["old_pin_self_diff_groups"] == 0
          and rec["curate"]["old_pin_samples"] == TRAIN_SAMPLES,
          f"the old pin moved: {rec['curate']}")
    build.reset_launches()
    state, losses2, times2, _ = run(steps=TRAIN_MORE_STEPS,
                                    ckpt_every=TRAIN_MORE_STEPS + 1,
                                    log_every=1)
    launches2 = dict(build.LAUNCHES)
    new_pin = sorted((t for t in engine.snapshots
                      if t.startswith("train-pin")),
                     key=lambda t: int(t.rsplit("-", 1)[1]))[-1]
    rec["more_steps"] = {
        "pin": new_pin, "losses": losses2,
        "pin_samples": PinnedDataset(engine,
                                     engine.snapshots[new_pin]).n,
        "step_ms": [x * 1e3 for x in times2["step_s"]],
        "save_s": times2["save_s"], "launches": launches2}
    check(len(losses2) == TRAIN_MORE_STEPS
          and all(math.isfinite(x) for x in losses2)
          and rec["more_steps"]["pin_samples"] == TRAIN_SAMPLES + 64,
          f"more steps on the new pin: {rec['more_steps']}")
    rec["launches"] = {k: launches[k] + launches2[k] for k in launches}
    del state, engine
    gc.collect()
    torch.cuda.empty_cache()
    rec["card_vs_cpu"] = card_vs_cpu_step(torch, cfg, seed)
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec


def train_cut(full, layers):
    """``full`` cut as a TRAIN_MODELS row says: None keeps it whole, a
    count keeps the stack's first layers (``configs.first_layers``), a
    tuple keeps those slots of its first period
    (``configs.period_slots``)."""
    from repro_torch.configs import first_layers, period_slots
    if layers is None:
        return full
    if isinstance(layers, tuple):
        return period_slots(full, layers)
    return first_layers(full, layers)


def cut_note(full, cfg, layers):
    """How ``cfg`` was cut from ``full``, for the record (None: whole)."""
    if layers is None:
        return None
    note = f"n_layers {full.n_layers} -> {cfg.n_layers}"
    if isinstance(layers, tuple):
        note += (f": slots {list(layers)} of the first period of "
                 f"{full.period} ({', '.join(cfg.slot_kinds())}; ffn "
                 f"{', '.join(cfg.ffn_kinds())})")
    return note


def train_model(torch, arch: str, layers, batch: int, seq: int,
                seed: int) -> dict:
    """One config at its published widths (depth cut to ``layers`` where
    given) through the training path: its own versioned token corpus,
    pinned, batches from the pipeline on the card, TRAIN_MODELS_STEPS
    steps of ``train.train_step(..., remat=True)`` (loss, backward through
    the flash kernels, AdamW), then one profiled step. A config with a
    context (an encoder or cross slots) trains through the reference's
    entry point instead, ``launch.steps.make_train_step`` for
    ``ShapeCfg(seq, batch)``: its tokens and context are what
    ``input_specs`` shapes (an encoder-decoder config's ``seq`` is its
    frames, its decoder min(448, frames) tokens), its microbatches
    ``pick_microbatches``', and the context of each step (frame or patch
    embeddings from the stub frontend) is drawn in bf16 from a CUDA
    generator of the seed. A depth cut draws its layer matrices at the
    published depth's init scale (``published_init_scale``). Returns its
    record; the caller frees the card."""
    from repro_torch.configs import ShapeCfg, get_config
    from repro_torch.core import Engine
    from repro_torch.data import (BatchPipeline, PinnedDataset, PipelineCfg,
                                  create_token_table, synth_corpus)
    from repro_torch.kernels import build
    from repro_torch.launch import steps, train
    from repro_torch.models.lm import LM
    from repro_torch.optim import AdamWCfg

    full = get_config(arch)
    cfg = train_cut(full, layers)
    shape = ShapeCfg(f"train_models_{arch}", seq, batch, "train")
    specs = steps.input_specs(cfg, shape)["batch"]
    tokens = specs["tokens"].shape[1]
    ctx_shape = tuple(specs["ctx"].shape) if "ctx" in specs else None
    n_micro = steps.pick_microbatches(cfg, shape) if ctx_shape else 1
    t_all = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = Engine(device="cuda")
    create_token_table(engine, "corpus")
    synth_corpus(engine, "corpus", n_samples=TRAIN_MODELS_SAMPLES,
                 sample_len=tokens + 1, vocab=cfg.vocab, seed=seed)
    pin = engine.create_snapshot("train-pin", "corpus")
    pipe = BatchPipeline(PinnedDataset(engine, pin),
                         PipelineCfg(seq_len=tokens, global_batch=batch))
    corpus_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = LM(cfg, device="cuda",
               generator=torch.Generator("cuda").manual_seed(seed))
    published_init_scale(torch, model)
    opt_cfg = AdamWCfg(warmup_steps=2, decay_steps=TRAIN_MODELS_STEPS)
    state = steps.init_state(model, opt_cfg)
    live = state["params"]
    decay = train.decay_names(live)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in live.values())
    check(n_params == param_count(cfg), f"{arch}: {n_params} parameters, "
          f"not the config's {param_count(cfg)}")
    # the parameters a token meets: an MoE's experts count top_k of E
    n_active = n_params - int(cfg.n_params() - cfg.n_params_active())
    ctx_gen = torch.Generator("cuda").manual_seed(seed + 3)

    def batch_at(step: int) -> dict:
        data = pipe.tensors_at(step, "cuda")
        if ctx_shape:
            data["ctx"] = torch.randn(ctx_shape, generator=ctx_gen,
                                      device="cuda").bfloat16()
        return data

    if ctx_shape:
        step_fn = steps.make_train_step(cfg, shape, opt_cfg=opt_cfg,
                                        n_micro=n_micro, device="cuda")

        def run(data) -> dict:
            new, metrics = step_fn(state, data)
            state.update(new)
            return metrics
    else:
        def run(data) -> dict:
            state["opt"], metrics = train.train_step(
                model, data, state["opt"], opt_cfg, decay, seq, remat=True)
            return metrics
    build.reset_launches()
    losses, step_ms, gnorms = [], [], []
    for step in range(1, TRAIN_MODELS_STEPS + 1):
        t0 = time.perf_counter()
        metrics = run(batch_at(step))
        losses.append(float(metrics["loss"]))      # syncs the step's work
        step_ms.append((time.perf_counter() - t0) * 1e3)
        gnorms.append(float(metrics["grad_norm"]))
    launches = dict(build.LAUNCHES)
    steady = sorted(step_ms[1:])
    median_ms = steady[len(steady) // 2]
    ctx_len = ctx_shape[1] if ctx_shape else 0
    flops = train_flops(n_active, cfg, batch, tokens, ctx_len)
    want = train_launches(cfg, TRAIN_MODELS_STEPS, n_micro)
    check(all(launches.get(k, 0) == n for k, n in want.items()),
          f"{arch}: attention kernels launched {launches}, not {want} "
          f"(remat runs each decoder forward twice)")
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"{arch}: a loss or gradient norm is not finite: {losses} "
          f"{gnorms}")
    peak = torch.cuda.max_memory_allocated()
    data = batch_at(TRAIN_MODELS_STEPS + 1)
    # without attention there is no backward kernel to focus on: the
    # record keeps the step's leading kernels alone
    prof = device_profile(torch, lambda: run(data),
                          focus="attn_bwd" if attention_layers(cfg) else None)
    W = cfg.sliding_window
    rec = {"arch": arch, "n_layers": cfg.n_layers,
           "published_layers": full.n_layers,
           "encoder_layers": cfg.encoder_layers,
           "cut": cut_note(full, cfg, layers),
           "slots": list(cfg.slot_kinds()),
           "ffn_slots": list(cfg.ffn_kinds()),
           "attention_layers": attention_layers(cfg),
           "init_scale_periods": full.n_periods,
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
           "hd": cfg.hd, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "moe": None if not cfg.moe else [cfg.moe.n_experts,
                                            cfg.moe.top_k],
           "window": W, "batch": batch, "seq_len": tokens,
           "window_binds": bool(W and W < tokens),
           "entry": "launch.steps.make_train_step" if ctx_shape
           else "launch.train.train_step",
           "n_micro": n_micro,
           "context": None if not ctx_shape else {
               "shape": list(ctx_shape), "dtype": "bfloat16",
               "bytes": math.prod(ctx_shape) * 2,
               "is": ("frame" if cfg.is_encdec else "patch")
               + " embeddings of the stub frontend, torch.randn on a CUDA "
                 "generator of seed + 3, one a step"},
           "corpus_samples": TRAIN_MODELS_SAMPLES, "pin": "train-pin",
           "corpus_s": corpus_s, "init_s": init_s,
           "params": n_params, "active_params": n_active,
           "state_bytes": sum(p.numel() * (p.element_size() + 8)
                              for p in live.values()),
           "steps": TRAIN_MODELS_STEPS, "remat": True, "losses": losses,
           "grad_norms": gnorms, "step_ms": step_ms,
           "step_ms_median": median_ms,
           "tokens_per_s": batch * tokens / (median_ms / 1e3),
           "context_per_s": batch * ctx_len / (median_ms / 1e3),
           "model_flops": flops,
           "model_flop_share": flops / (median_ms / 1e3) / BF16_FLOPS_PER_S,
           "launches": launches,
           "window_bwd_launches": launches.get("flash_attention_bwd", 0)
           if W and W < tokens else 0,
           "max_memory_allocated": peak,
           "max_memory_reserved": torch.cuda.max_memory_reserved(),
           "profile_step": prof}
    del model, live, state, data, pipe, engine
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_all
    return rec


def train_models_phase(torch, seed: int, before_checks=None) -> dict:
    """Every config of TRAIN_MODELS through ``train_model``, each trained
    and freed before the next; then the card-vs-CPU step with remat for
    each MoE config at one layer, the card's routes replayed on the CPU
    (mixtral's window cut to TRAIN_CHECK_WINDOW so that it binds at
    TRAIN_MODELS_CHECK tokens), and for each state-space config at its first
    trained slot: rwkv6's one rwkv layer, jamba's slot 0 (mamba with its
    MLP); and for each config with a context, over a context of its
    row's length: whisper-medium at one encoder and one decoder layer,
    llama-3.2-vision-90b at its cross layer (slot 0), their queries
    scaled by ``unit_scores``. ``before_checks`` (a callable, or None)
    runs between the timed training and the checks."""
    import dataclasses

    from repro_torch.configs import get_config, period_slots
    from repro_torch.launch.steps import context_sizes

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recs, checks = [], {}
    for arch, layers, batch, seq in TRAIN_MODELS:
        recs.append(train_model(torch, arch, layers, batch, seq, seed))
        phase("train_model", **{k: v for k, v in recs[-1].items()
                                if k != "profile_step"},
              profile_step={k: v for k, v in recs[-1]["profile_step"].items()
                            if k != "top_kernels"},
              top_kernels=recs[-1]["profile_step"]["top_kernels"][:5])
    if before_checks is not None:
        before_checks()
    for arch, layers, _, seq in TRAIN_MODELS:
        cfg = get_config(arch)
        if cfg.is_encdec:
            cut = {"n_layers": 1, "encoder_layers": 1}
            checks[arch] = card_vs_cpu_step(
                torch, dataclasses.replace(cfg, **cut), seed, remat=True,
                ctx_len=context_sizes(cfg, seq)[0],
                check_batch=TRAIN_MODELS_CHECK)
            checks[arch]["cut"] = {k: [getattr(cfg, k), v]
                                   for k, v in cut.items()}
        elif "cross" in cfg.slot_kinds():
            one = period_slots(cfg, (0,))
            checks[arch] = card_vs_cpu_step(
                torch, one, seed, remat=True,
                ctx_len=context_sizes(cfg, seq)[0],
                check_batch=TRAIN_MODELS_CHECK)
            checks[arch]["cut"] = cut_note(cfg, one, (0,))
        elif cfg.ssm is not None:
            first = (layers[0],) if isinstance(layers, tuple) else (0,)
            one = period_slots(cfg, first)
            checks[arch] = card_vs_cpu_step(
                torch, one, seed, remat=True,
                check_batch=TRAIN_MODELS_CHECK)
            checks[arch]["cut"] = cut_note(cfg, one, first)
        elif cfg.moe is not None:
            cut = {"n_layers": 1}
            if cfg.sliding_window:
                cut["sliding_window"] = TRAIN_CHECK_WINDOW
            checks[arch] = card_vs_cpu_step(
                torch, dataclasses.replace(cfg, **cut), seed, remat=True,
                check_batch=TRAIN_MODELS_CHECK)
            checks[arch]["cut"] = {k: [getattr(cfg, k), v]
                                   for k, v in cut.items()}
        else:
            continue
        phase("train_model_check", arch=arch, **checks[arch])
    return {"models": recs, "card_vs_cpu": checks,
            "seconds": time.perf_counter() - t0,
            "flash_launches": sum(r["launches"]["flash_attention"]
                                  for r in recs),
            "bwd_launches": sum(r["launches"]["flash_attention_bwd"]
                                for r in recs),
            "window_bwd_launches": sum(r["window_bwd_launches"]
                                       for r in recs)}


# --------------------------------------------------------------------- main

# ------------------------------------------------------------------ lint

#: the lint phase's planted tree: one module for each of three rules, each
#: holding one finding that rule must flag
LINT_PLANTED = {
    "src/repro_torch/core/merge.py": (
        "hidden-sort",
        "import torch\n\n\ndef order(x):\n    return torch.sort(x).indices\n"),
    "src/repro_torch/core/clocky.py": (
        "wal-hygiene",
        "import time\n\n\ndef stamp():\n    return time.perf_counter()\n"),
    "src/repro_torch/core/rot.py": (
        "sealed-write",
        "def rot(obj):\n    obj.key_lo.view(-1).add_(1)\n"),
}


# ------------------------------------------------------------ sharded

@contextlib.contextmanager
def process_group(torch, backend: str = "nccl", store=None):
    """A process group of world size 1 (this process, rank 0) through a
    ``file://`` store (default under build/), destroyed on the way
    out."""
    import torch.distributed as dist
    store = Path(store or ROOT / "build" / "sharded_store")
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def local(t):
    """A DTensor's local tensor (on a 1 x 1 mesh, the whole tensor)."""
    return t.to_local() if hasattr(t, "to_local") else t


def unequal_leaves(torch, got: dict, want: dict) -> list:
    """The leaves of ``got`` whose bits differ from ``want``'s, each with
    its largest difference over the leaf's largest magnitude."""
    out = []
    for name, w in want.items():
        g = local(got[name]).detach()
        if not torch.equal(g, w.detach()):
            d = (g.float() - w.float()).abs().max().item()
            out.append({"leaf": name,
                        "rel": d / max(w.float().abs().max().item(), 1e-30)})
    return out


def sharded_train(torch, mesh, cfg, batch: int, seq: int, n_steps: int,
                  seed: int, device: str = "cuda",
                  n_micro: Optional[int] = None,
                  count_flops: bool = False) -> dict:
    """``n_steps`` of ``launch.steps.make_train_step`` over ``mesh`` and
    the same steps of its one-device form, each from ``LM(cfg)``'s own
    init on the card, at ``pick_microbatches``' factor on the mesh (or
    ``n_micro``), on
    the same batches (tokens, and a context for a config with one, drawn
    from ``seed``): the losses, and every parameter and AdamW moment after
    the last step, bit for bit; each side's step ms (the median after the
    first), the attention kernels' launches and peak memory (above what
    was allocated when the run began). ``device`` "cpu" runs both on the CPU (the tests).
    ``count_flops``: the mesh's first step runs under ``FlopCounterMode``
    (its FLOPs in ``flops``; its time is not among the medians')."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.distributed.sharding import place_tree
    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.models.lm import LM

    shape = ShapeCfg("t", seq, batch, "train")
    n_micro = n_micro or steps.pick_microbatches(cfg, shape, mesh)
    specs = steps.input_specs(cfg, shape)["batch"]
    g = torch.Generator().manual_seed(seed)
    batches = []
    for _ in range(n_steps):
        toks = torch.randint(0, cfg.vocab, tuple(specs["tokens"].shape),
                             generator=g)
        b = {"tokens": toks, "targets": toks.roll(-1, dims=1)}
        if "ctx" in specs:
            b["ctx"] = torch.randn(tuple(specs["ctx"].shape), generator=g,
                                   dtype=torch.bfloat16)
        batches.append({k: v.to(device) for k, v in b.items()})
    card = device == "cuda"
    sync = torch.cuda.synchronize if card else (lambda: None)

    def run(on_mesh: bool):
        gc.collect()
        if card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        # the other run's leaves are held for the comparison: count this
        # run's own memory
        base = torch.cuda.memory_allocated() if card else 0
        state = steps.init_state(LM(cfg, device=device))
        if on_mesh:
            step, st_specs, b_specs = steps.make_train_step(
                cfg, shape, mesh, n_micro=n_micro)
            state, _ = steps.place_inputs(state, None, st_specs, b_specs,
                                          mesh)
        else:
            step = steps.make_train_step(cfg, shape, n_micro=n_micro,
                                         device=device)
        build.reset_launches()
        losses, ms, flops = [], [], None
        for i, b in enumerate(batches):
            if on_mesh:
                b = place_tree(b, b_specs, mesh)
            sync()
            t0 = time.perf_counter()
            if on_mesh and count_flops and i == 0:
                from torch.utils.flop_counter import FlopCounterMode
                with FlopCounterMode(display=False) as fc:
                    state, m = step(state, b)
                flops = float(fc.get_total_flops())
            else:
                state, m = step(state, b)
            losses.append(local(m["loss"]).item())
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = {k: build.LAUNCHES[k] for k in
                    ("flash_attention", "flash_attention_bwd")}
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9 if card \
            else None
        leaves = {f"params/{n}": local(p) for n, p in state["params"].items()}
        for part in ("mu", "nu"):
            leaves.update({f"{part}/{n}": local(t) for n, t in
                           getattr(state["opt"], part).items()})
        del state, step
        return losses, ms, launches, peak, leaves, flops

    losses, ms, launches, peak, got, flops = run(True)
    p_losses, p_ms, p_launches, p_peak, want, _ = run(False)
    check(all(math.isfinite(x) for x in losses), f"sharded losses {losses}")
    unequal = unequal_leaves(torch, got, want)
    rec = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "batch": batch, "seq_len": seq, "n_micro": n_micro,
           "steps": n_steps, "losses": losses, "plain_losses": p_losses,
           "losses_equal": losses == p_losses,
           "leaves": len(want), "unequal_leaves": unequal,
           "step_ms": ms, "plain_step_ms": p_ms,
           "step_ms_median": statistics.median(ms[1:] or ms),
           "plain_step_ms_median": statistics.median(p_ms[1:] or p_ms),
           "launches": launches, "plain_launches": p_launches,
           "peak_gb": peak, "plain_peak_gb": p_peak, "flops": flops}
    rec["dtensor_host_ms"] = rec["step_ms_median"] \
        - rec["plain_step_ms_median"]
    del got, want
    return rec


def sharded_serve(torch, mesh, cfg, batch: int, prompt: int, new: int,
                  seed: int, device: str = "cuda") -> dict:
    """``launch.steps.make_prefill_step`` and ``make_decode_step`` over
    ``mesh`` against ``LM.prefill`` and ``LM.decode_step`` on the same
    weights: a ``prompt``-token prefill (the last logits and every cache
    leaf), then ``new`` greedy tokens (each step's logits), bit for bit;
    the flash launches of the mesh's first prefill and both sides' ms
    (the prefill's first call and a warm one). ``device`` as
    :func:`sharded_train`'s."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.models.lm import LM

    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (batch, prompt),
                         generator=g).to(device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    pshape = ShapeCfg("p", prompt, batch, "prefill")
    dshape = ShapeCfg("d", prompt, batch, "decode")
    pre, pspecs, _ = steps.make_prefill_step(cfg, pshape, mesh)
    dec = steps.make_decode_step(cfg, dshape, mesh)[0]
    model = steps.place_params(LM(cfg, device=device), pspecs, mesh)
    ref = LM(cfg, device=device)
    rec = {"arch": cfg.name, "batch": batch, "prompt": prompt, "new": new}
    with torch.no_grad():
        build.reset_launches()
        sync()
        t0 = time.perf_counter()
        logits, cache = pre(model, toks)
        sync()
        rec["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        rec["flash_launches"] = build.LAUNCHES["flash_attention"]
        t0 = time.perf_counter()
        r_logits, r_cache = ref.prefill(toks, seq_cap=prompt + 128)
        sync()
        rec["plain_prefill_ms"] = (time.perf_counter() - t0) * 1e3
        rec["prefill_equal"] = torch.equal(local(logits), r_logits)
        rec["cache_equal"] = all(
            torch.equal(local(a), b)
            for k in r_cache if k != "len"
            for a, b in zip(*(list(c[k].values()) if isinstance(c[k], dict)
                              else list(c[k]) for c in (cache, r_cache))))
        # once more each, warm: the mesh's first call pays DTensor's
        # sharding propagation
        for key, fn in (("prefill_ms_warm", lambda: pre(model, toks)),
                        ("plain_prefill_ms_warm", lambda: ref.prefill(
                            toks, seq_cap=prompt + 128))):
            t0 = time.perf_counter()
            fn()
            sync()
            rec[key] = (time.perf_counter() - t0) * 1e3
        tok = r_logits.argmax(-1)[:, None]
        equal, ms, p_ms = [], [], []
        for _ in range(new):
            t0 = time.perf_counter()
            logits, cache = dec(model, tok, cache)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            r_logits, r_cache = ref.decode_step(tok, r_cache)
            sync()
            p_ms.append((time.perf_counter() - t0) * 1e3)
            equal.append(torch.equal(local(logits), r_logits))
            tok = r_logits.argmax(-1)[:, None]
    rec.update({"decode_equal": equal, "decode_ms": ms,
                "plain_decode_ms": p_ms,
                "decode_ms_median": statistics.median(ms[1:] or ms),
                "plain_decode_ms_median": statistics.median(p_ms[1:]
                                                            or p_ms),
                "len": [cache["len"], r_cache["len"]]})
    del model, ref, cache, r_cache
    return rec


def sharded_phase(torch, seed: int) -> dict:
    """The sharded path on a world-size-1 NCCL group's mesh
    (``make_mesh_for(device_count)``: data 1 x model 1): SHARDED_TRAIN's
    steps, SHARDED_CONTEXT's and SHARDED_MIXERS' through the mesh against
    the one-device step, and SHARDED_SERVE's prefill and decode against
    ``LM``'s, each bit for bit (``sharded_train``, ``sharded_serve``)."""
    from repro_torch.configs import first_layers, get_config
    from repro_torch.distributed.elastic import make_mesh_for

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    rec = {}
    with process_group(torch):
        mesh = make_mesh_for(torch.cuda.device_count())
        rec["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
        arch, b, s, n = SHARDED_TRAIN
        rec["train"] = sharded_train(torch, mesh, get_config(arch), b, s, n,
                                     seed, count_flops=True)
        arch, b, s, n = SHARDED_CONTEXT
        rec["context"] = sharded_train(torch, mesh, get_config(arch), b, s,
                                       n, seed + 1)
        rec["mixers"] = [sharded_train(torch, mesh,
                                       first_layers(get_config(arch), n_l),
                                       b, s, n, seed + 3 + i)
                         for i, (arch, n_l, b, s, n)
                         in enumerate(SHARDED_MIXERS)]
        arch, b, s, n = SHARDED_SERVE
        rec["serve"] = sharded_serve(torch, mesh, get_config(arch), b, s, n,
                                     seed + 2)
    rec["seconds"] = time.perf_counter() - t_phase
    rows = [(k, rec[k]) for k in ("train", "context")] \
        + [(t["arch"], t) for t in rec["mixers"]]
    for key, t in rows:
        check(t["losses_equal"] and not t["unequal_leaves"],
              f"sharded {key} step differs from the one-device step: "
              f"losses {t['losses']} / {t['plain_losses']}, leaves "
              f"{t['unequal_leaves'][:8]}")
        # rwkv has no attention layer
        attn = "attn" in get_config(t["arch"]).slot_kinds()
        check(t["launches"] == t["plain_launches"]
              and (t["launches"]["flash_attention_bwd"] > 0) == attn,
              f"sharded {key} launches {t['launches']} / "
              f"{t['plain_launches']}")
    sv = rec["serve"]
    check(sv["prefill_equal"] and sv["cache_equal"]
          and all(sv["decode_equal"]) and sv["flash_launches"] > 0,
          f"sharded serve differs: {sv}")
    rec["flash_launches"] = sum(t["launches"]["flash_attention"]
                                for _, t in rows) + sv["flash_launches"]
    rec["bwd_launches"] = sum(t["launches"]["flash_attention_bwd"]
                              for _, t in rows)
    return rec


# ------------------------------------------------------------ dry run

def dryrun_child(out: str) -> int:
    """The dry-run phase's trace, in a process of its own (a fake group
    cannot share one with the sharded phase's NCCL group): DRYRUN_CELLS
    through ``launch.dryrun.analyze_cell`` on the production meshes of
    fake 256- and 512-rank groups, then qwen's 4 x 2,048-token train step
    on a fake 1 x 1 mesh, all with fake CUDA tensors; the kernel launches
    and the bytes allocated on the card across the traces. Writes its
    record to ``out``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.configs import ShapeCfg
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    before = dict(build.LAUNCHES)
    cuda_before = torch.cuda.is_initialized()
    rec = {"cells": []}
    t_all = time.perf_counter()
    for mp in (False, True):
        with dryrun.fake_group(512 if mp else 256):
            mesh = make_production_mesh(multi_pod=mp)
            for arch, shape, m in DRYRUN_CELLS:
                if m != mp:
                    continue
                t0 = time.perf_counter()
                at = {}
                r = dryrun.analyze_cell(arch, shape, multi_pod=mp, mesh=mesh,
                                        at_peak=at)
                r["seconds"] = time.perf_counter() - t0
                r["at_peak"] = at
                rec["cells"].append(r)
    arch, b, s, _ = SHARDED_TRAIN
    with dryrun.fake_group(1):
        mesh = DeviceMesh("cuda", torch.arange(1).reshape(1, 1),
                          mesh_dim_names=("data", "model"))
        t0 = time.perf_counter()
        rec["qwen"] = dryrun.analyze_cell(
            arch, ShapeCfg(f"train_{b}x{s}", s, b, "train"), multi_pod=False,
            mesh=mesh)
        rec["qwen"]["seconds"] = time.perf_counter() - t0
    rec["seconds"] = time.perf_counter() - t_all
    rec["launches"] = {k: build.LAUNCHES[k] - before[k] for k in before}
    rec["cuda_initialized_before"] = cuda_before
    rec["cuda_initialized_after_traces"] = torch.cuda.is_initialized()
    rec["memory_allocated"] = torch.cuda.memory_allocated()
    Path(out).write_text(json.dumps(rec, indent=1))
    return 0


def start_dryrun():
    """Start :func:`dryrun_child` (it uses the host's CPU alone):
    (process, its record's path, its log's path)."""
    out = ROOT / "build" / "dryrun_child.json"
    log = ROOT / "build" / "dryrun_child.log"
    out.parent.mkdir(exist_ok=True)
    out.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-child",
             str(out)], cwd=ROOT, env=env, stdout=f,
            stderr=subprocess.STDOUT)
    return proc, out, log


def join_dryrun(child) -> float:
    """Wait for the dry-run child, at most DRYRUN_WAIT_S (it is killed
    past that): the seconds waited."""
    t0 = time.perf_counter()
    try:
        child[0].wait(timeout=DRYRUN_WAIT_S)
    except subprocess.TimeoutExpired:
        child[0].kill()
        child[0].wait()
    return time.perf_counter() - t0


def dryrun_phase(child, waited: float, sharded: dict) -> dict:
    """Hold the joined dry-run child's record (``waited``: the seconds
    :func:`join_dryrun` waited): every cell traced (the reference's keys,
    its trace seconds), no launch and no byte allocated on the card
    during the traces, and qwen's fake step against the sharded phase's
    real one on the real 1 x 1 mesh: FLOPs within DRYRUN_FLOPS_TOL (the
    same program under the same conventions), the tracked peak over the
    real peak above the run's start, and the roofline's compute time
    over the measured warm step."""
    proc, out, log = child
    rc = proc.returncode
    check(rc == 0 and out.exists(),
          f"dry-run child exit {rc}: {log.read_text()[-3000:]}")
    rec = json.loads(out.read_text())
    rec["waited_s"] = waited
    check(not any(rec["launches"].values()) and rec["memory_allocated"] == 0,
          f"the dry run touched the card: launches {rec['launches']}, "
          f"{rec['memory_allocated']} bytes")
    real = sharded["train"]
    q = rec["qwen"]
    rec["flops_ratio"] = q["hlo_flops"] / real["flops"]
    rec["memory_ratio"] = q["per_device_bytes"] / (real["peak_gb"] * 1e9)
    rec["time_ratio"] = q["t_compute_s"] / (real["step_ms_median"] / 1e3)
    check(abs(rec["flops_ratio"] - 1) <= DRYRUN_FLOPS_TOL,
          f"dry-run FLOPs {q['hlo_flops']} against the real step's "
          f"{real['flops']}")
    check(len(rec["cells"]) == len(DRYRUN_CELLS)
          and all(c["hlo_flops"] > 0 and c["per_device_bytes"] > 0
                  for c in rec["cells"]), "a dry-run cell counted nothing")
    # each cell's peak a device and the phase of the step that sets it
    rec["peaks"] = [{"cell": f"{c['arch']} {c['shape']} {c['mesh']}",
                     "gb": c["per_device_bytes"] / 1e9,
                     "phase": c["at_peak"]["phase"]} for c in rec["cells"]]

    def cell(arch, shape, mesh):
        return [c for c in rec["cells"] if c["arch"] == arch
                and c["shape"] == shape and c["mesh"] == mesh][0]
    rec["mixtral_train_gb"] = cell("mixtral-8x7b", "train_4k",
                                   "16x16")["per_device_bytes"] / 1e9
    check(rec["mixtral_train_gb"] < DRYRUN_MIXTRAL_TRAIN_GB,
          f"mixtral's train_4k holds {rec['mixtral_train_gb']} GB a device "
          f"(its experts over 'model' read 4.971: "
          f"{DRYRUN_MIXTRAL_TRAIN_GB})")
    rec["llama_pod_train_gb"] = cell("llama-3.2-vision-90b", "train_4k",
                                     "2x16x16")["per_device_bytes"] / 1e9
    check(rec["llama_pod_train_gb"] <= DRYRUN_LLAMA_POD_TRAIN_GB,
          f"llama-vision's train_4k on 2 x 16 x 16 holds "
          f"{rec['llama_pod_train_gb']} GB a device (its batch gathered "
          f"before the microbatch split: 44.30; "
          f"{DRYRUN_LLAMA_POD_TRAIN_GB})")
    rec["phi_prefill_useful"] = cell("phi3.5-moe-42b-a6.6b", "prefill_32k",
                                     "16x16")["useful_flops_ratio"]
    check(rec["phi_prefill_useful"] >= DRYRUN_PHI_PREFILL_USEFUL,
          f"phi3.5-moe's prefill_32k useful-FLOP ratio "
          f"{rec['phi_prefill_useful']} (every head on every 'model' "
          f"rank: 0.087; {DRYRUN_PHI_PREFILL_USEFUL})")
    rec["mixtral_decode_gather"] = cell(
        "mixtral-8x7b", "decode_32k", "16x16")["collectives"].get(
            "all-gather", 0.0)
    check(rec["mixtral_decode_gather"] < DRYRUN_MIXTRAL_DECODE_GATHER
          - DRYRUN_MIXTRAL_DECODE_FALL,
          f"mixtral's decode_32k all-gathers {rec['mixtral_decode_gather']}"
          f" bytes a device (every layer's cache gathered: "
          f"{DRYRUN_MIXTRAL_DECODE_GATHER})")
    return rec


def run_src(argv, **kw):
    """Run ``argv`` from the checkout's root with ``src`` on the path."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, **kw)


def finish(proc, what: str, timeout: float = 600):
    """Wait for ``proc``; its (returncode, stdout, stderr) as text."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SmokeFailure(f"{what} did not finish in {timeout} s")
    return proc.returncode, out.decode(), err.decode()


def lint_phase(device="cuda", root=None) -> dict:
    """The port's invariant lint on the host: ``python -m
    repro_torch.analysis`` over ``src/repro_torch`` must exit 0 with 0
    unsuppressed findings and a reason on every suppression; a planted
    tree (under ``root``, ``build/lint_planted``) must exit 1 with each of
    its modules flagged by its rule; ``LINT`` through the statement door
    on a ``Repo`` on ``device`` and ``datagit lint --format json`` must
    give the runner's findings."""
    from repro_torch.analysis import (default_paths, discover_count,
                                      repo_root, run_analysis, to_json)
    from repro_torch.core import Repo, execute

    t0 = time.perf_counter()
    rc, out, err = finish(run_src(
        [sys.executable, "-m", "repro_torch.analysis", "--format", "json"]),
        "python -m repro_torch.analysis")
    seconds = time.perf_counter() - t0
    check(rc == 0, f"python -m repro_torch.analysis exited {rc}: "
          f"{out[-2000:]}{err[-2000:]}")
    doc = json.loads(out)
    check(doc["counts"]["findings"] == 0,
          f"{doc['counts']['findings']} unsuppressed lint finding(s)")
    check(all(f["reason"] for f in doc["findings"] if f["suppressed"]),
          "a lint suppression has no reason")
    by_rule = collections.Counter(f["rule"] for f in doc["findings"]
                                  if f["suppressed"])

    planted = Path(root or ROOT / "build" / "lint_planted")
    shutil.rmtree(planted, ignore_errors=True)
    for rel, (_, src) in LINT_PLANTED.items():
        (planted / rel).parent.mkdir(parents=True, exist_ok=True)
        (planted / rel).write_text(src)
    t0 = time.perf_counter()
    rc_bad, out, err = finish(run_src(
        [sys.executable, "-m", "repro_torch.analysis", str(planted),
         "--format", "json"]), "the planted lint")
    planted_s = time.perf_counter() - t0
    check(rc_bad == 1, f"the planted tree's lint exited {rc_bad}: "
          f"{err[-2000:]}")
    # paths from the checkout's root when build/ lies inside it: compare
    # them from their src/ directory on
    flagged = sorted((f["path"][f["path"].rindex("src/"):], f["rule"])
                     for f in json.loads(out)["findings"]
                     if not f["suppressed"])
    want = sorted((rel, rule) for rel, (rule, _) in LINT_PLANTED.items())
    check(flagged == want, f"the planted tree flagged {flagged}")

    root_ = repo_root()
    paths = default_paths(root_)
    t0 = time.perf_counter()
    findings = run_analysis(paths, root=root_)
    in_process_s = time.perf_counter() - t0
    res = execute(Repo(device=device), "LINT")
    check(res.kind == "lint" and res.data == findings,
          "LINT through the statement door differs from the runner")
    rc_cli, out, err = finish(run_src(
        [sys.executable, "-m", "repro_torch.vcs_cli", "lint", "--format",
         "json"]), "datagit lint")
    check(rc_cli == 0 and json.loads(out) == to_json(
        findings, discover_count(paths)),
        f"datagit lint (exit {rc_cli}) differs from the runner: "
        f"{err[-2000:]}")
    return {"files": doc["counts"]["files"],
            "findings": doc["counts"]["findings"],
            "suppressed": doc["counts"]["suppressed"],
            "suppressed_by_rule": dict(sorted(by_rule.items())),
            "seconds": seconds, "in_process_s": in_process_s,
            "planted": {"exit": rc_bad, "flagged": flagged,
                        "seconds": planted_s},
            "statement_door": "equal", "datagit_lint": "equal"}


# -------------------------------------------------------------- examples

#: the port's VCS examples (``repro_torch.examples.<name>``)
EXAMPLES = ("quickstart", "data_engineering_workflow")
#: runs one example in a process of its own: its stdout is the example's
#: alone, and the last line of its stderr holds the seconds of ``main``
#: (to a sync on the card) and the kernels' launches in that window
EXAMPLE_RUNNER = """
import importlib, json, sys, time
import torch
from repro_torch.kernels import build
name, device = sys.argv[1:3]
mod = importlib.import_module("repro_torch.examples." + name)
build.reset_launches()
t0 = time.perf_counter()
mod.main(["--device", device])
if device == "cuda":
    torch.cuda.synchronize()
s = time.perf_counter() - t0
sys.stdout.flush()
print(json.dumps({"s": s, "launches": dict(build.LAUNCHES)}),
      file=sys.stderr)
"""


def run_example(name: str, device: str):
    return run_src([sys.executable, "-c", EXAMPLE_RUNNER, name, device])


def examples_phase(device="cuda") -> dict:
    """Each VCS example with ``--device cpu`` (both started together) and
    then with ``--device <device>`` (one after another, so the host is
    the card run's alone): the card's stdout must equal the CPU's byte
    for byte, and on the card every VCS kernel must be launched (both
    examples reach all four on the plain path). Records each card run's
    wall seconds (the process, and ``main`` to a sync), its launches by
    kernel, and the CPU run's ``main`` seconds (which ran beside the
    other CPU run)."""
    from repro_torch.kernels import build

    plain, plain_s = {}, {}
    for name, proc in [(n, run_example(n, "cpu")) for n in EXAMPLES]:
        rc, out, err = finish(proc, f"{name} --device cpu")
        check(rc == 0, f"{name} --device cpu exited {rc}: {err[-2000:]}")
        plain[name] = out
        plain_s[name] = json.loads(err.strip().splitlines()[-1])["s"]
    rec = {}
    for name in EXAMPLES:
        t0 = time.perf_counter()
        rc, out, err = finish(run_example(name, device),
                              f"{name} --device {device}")
        wall = time.perf_counter() - t0
        check(rc == 0, f"{name} --device {device} exited {rc}: "
              f"{err[-2000:]}")
        check(out == plain[name], f"{name}: the stdout with --device "
              f"{device} differs from the CPU's")
        run = json.loads(err.strip().splitlines()[-1])
        launches = run["launches"]
        if device == "cuda":
            check(all(launches[k] > 0 for k in build.VCS_SOURCES),
                  f"{name} left a VCS kernel unlaunched: {launches}")
        rec[name] = {"stdout_equal": True, "lines": out.count("\n"),
                     "wall_s": wall, "main_s": run["s"],
                     "cpu_main_s": plain_s[name], "launches": launches}
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=SF1_ROWS,
                    help="lineitem rows of the main-path phase "
                         "(default: TPC-H SF1)")
    ap.add_argument("--change", type=int, default=C4_ROWS,
                    help="updated rows (default: change set C4)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dryrun-child", metavar="OUT", default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the GPU",
              file=sys.stderr)
        return 3
    if args.dryrun_child:
        return dryrun_child(args.dryrun_child)
    from repro_torch.kernels import build
    from repro_torch.benchmarks import digests

    record = {}
    started = []    # the dry-run child, once train_models starts it
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        record["device"] = phase(
            "device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
            count=torch.cuda.device_count(), torch=torch.__version__,
            cuda=torch.version.cuda, python=sys.version.split()[0])

        t0 = time.perf_counter()
        build.build_all()
        seconds = time.perf_counter() - t0
        record["build"] = phase("build", seconds=seconds,
                                sources=list(build.SOURCES),
                                flash_sass=hopper_sass(build))
        record["lint"] = phase("lint", **lint_phase())

        kern = kernel_phase(torch, args.seed)
        record["kernels"] = kern
        flash_extra = ("tflops", "device_ms", "device_tflops",
                       "library_device_ms", "device_vs_library", "config")
        phase("kernels", **{k: [{f: e[f] for f in ("shape", "ok",
                                                   "max_abs_err", "ms",
                                                   "bound_ms", "plain_ms",
                                                   "library_ms")}
                                | {f: e[f] for f in flash_extra if f in e}
                                for e in v] for k, v in kern.items()})
        flash_serve = flash_phase(torch, args.seed, FLASH_SERVE_SHAPES,
                                  tiles=True)
        record["flash_serve"] = phase("flash_serve", rows=[
            {f: e[f] for f in ("shape", "ok", "rel_l2_err", "ms", "tflops",
                               "device_ms", "device_tflops", "plain_ms",
                               "library_ms", "library_device_ms",
                               "bound_ms")}
            | {"block_m": e["config"]["block_m"],
               "device_ms_by_block_m": {bm: t["device_ms"] for bm, t in
                                        e["by_block_m"].items()}}
            for e in flash_serve])

        gold = {}
        for pk in (True, False):
            got = digests.run_workload(pk, device="cuda")
            got.update(digests.run_apply_workload(pk, device="cuda"))
            want = {**GOLDEN[pk], **GOLDEN_APPLY[pk]}
            bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
            check(not bad, f"golden digests differ (pk={pk}): {bad}")
            gold["pk" if pk else "nopk"] = "match"
            # the apply path again over an evicted store: every engine
            # spilled to packs and evicted from the card around each apply
            packs = ROOT / "build" / "golden_packs" / str(pk)
            shutil.rmtree(packs, ignore_errors=True)
            got = digests.run_apply_workload(pk, device="cuda",
                                             pack_root=packs)
            bad = {k: (got[k], v) for k, v in GOLDEN_APPLY[pk].items()
                   if got[k] != v}
            check(not bad, f"evicted-store golden digests differ "
                  f"(pk={pk}): {bad}")
            gold[("pk" if pk else "nopk") + "_evicted"] = "match"
        record["golden"] = phase("golden", **gold)
        examples = examples_phase()
        record["examples"] = phase("examples", **examples)

        runs, flows, doors, tiers = [], [], [], []
        for pk in (True, False):
            rec, (engine, base, pre, post) = mainpath_phase(
                torch, pk, args.rows, args.change)
            runs.append(rec)
            phase("mainpath", **{k: v for k, v in rec.items()
                                 if not k.endswith("_shapes")})
            flow = workflow_phase(torch, pk, engine, base, (pre, post),
                                  args.change, args.seed)
            flows.append(flow)
            phase("workflow", **{k: v for k, v in flow.items()
                                 if k != "second_round"
                                 and not k.endswith("_shapes")})
            door = doors_phase(torch, pk, engine, base, flow, args.change,
                               args.seed)
            doors.append(door)
            phase("doors", **{k: v for k, v in door.items()
                              if k != "steps" and not k.endswith("_shapes")},
                  steps={k: {f: v for f, v in e.items() if f != "shapes"}
                         for k, e in door["steps"].items()})
            rows, change = args.rows, args.change
            if not pk:
                # the NoPK half runs on a smaller engine of its own
                del engine, base, pre, post
                gc.collect()
                rows = min(rows, TIERS_NOPK_ROWS)
                change = min(change, TIERS_NOPK_CHANGE)
                engine, base, pre = tiers_engine(False, rows, change)
                post = None
            tier = tiers_phase(torch, pk, engine, base, pre, change,
                               args.seed)
            tier["rows"] = rows
            tiers.append(tier)
            phase("tiers", **{k: v for k, v in tier.items()
                              if not k.endswith("_shapes")})
            del engine, base, pre, post
        record["mainpath"] = runs
        record["workflow"] = flows
        record["doors"] = doors
        record["tiers"] = tiers
        launched = {k: sum(t["launches"][k] for t in tiers)
                    for k in build.VCS_SOURCES}
        check(all(launched.values()),
              f"a VCS kernel was not launched in the tiers windows: "
              f"{launched}")

        main_hist = functools.partial(shape_hist, runs)
        groups, search_rows = searchsorted_split(
            torch, main_hist("searchsorted_shapes"), args.seed,
            main_hist("zone_window_shapes"))
        record["searchsorted_split"] = phase(
            "searchsorted_split", groups=groups, checked=[
                {f: e.get(f) for f in ("shape", "ok", "max_abs_err", "ms",
                                       "device_ms", "plain_ms", "library_ms",
                                       "bound_ms")}
                for e in search_rows])
        # the kernels line reads the first row: the main path's commonest
        # shape, not the kernels phase's table-sized one
        kern["searchsorted"] = search_rows + kern["searchsorted"]
        groups, probe_rows = probe_split(torch, main_hist("probe_shapes"),
                                         args.seed)
        record["probe_split"] = phase(
            "probe_split", groups=groups, checked=[
                {f: e[f] for f in ("shape", "ok", "max_abs_err", "ms",
                                   "device_ms", "host_ms_synced", "plain_ms",
                                   "bound_ms")}
                for e in probe_rows])
        kern["probe"] = probe_rows + kern["probe"]
        segsum_rows = segsum_split(torch, main_hist("segsum_shapes"),
                                   args.seed, args.change)
        record["segsum_split"] = phase(
            "segsum_split", checked=[
                {f: e[f] for f in ("shape", "roles", "ok", "max_abs_err",
                                   "ms", "device_ms", "device_ms_all",
                                   "host_ms_synced", "plain_ms", "bound_ms",
                                   "launches", "launches_x_ms",
                                   "scan_half_ms", "scan_half_is")}
                for e in segsum_rows])
        kern["segsum_diff"] = segsum_rows + kern["segsum_diff"]
        record["workflow_split"] = workflow_split(torch, flows, kern,
                                                  args.seed, args.change)
        record["doors_split"] = doors_split(torch, doors, kern, args.seed)
        record["tiers_split"] = tiers_split(torch, tiers, kern, args.seed)
        record["launch_cost"] = phase("launch_cost",
                                      **launch_cost(torch, args.seed))

        serve = serve_phase(torch, args.seed)
        by_len = {e["shape"][1]: e["device_ms"] for e in flash_serve}
        if all(by_len.values()):
            serve["flash_ms_from_kernel_times"] = sum(
                serve["n_layers"] * by_len[n] for n in SERVE_PROMPTS)
        record["serve"] = serve
        phase("serve", **{k: v for k, v in serve.items()
                          if not k.startswith("profile")})
        phase("serve_profile", **{k: v for k, v in serve.items()
                                  if k.startswith("profile")})
        models = serve_models_phase(torch, args.seed)
        record["serve_models"] = models
        phase("serve_models", seconds=models["seconds"],
              flash_launches=models["flash_launches"],
              archs=[m["arch"] for m in models["models"]])
        ssm = serve_models_phase(torch, args.seed, SERVE_SSM_MODELS,
                                 published_scale=True,
                                 name="serve_ssm_model")
        record["serve_ssm"] = ssm
        phase("serve_ssm", seconds=ssm["seconds"],
              flash_launches=ssm["flash_launches"],
              archs=[m["arch"] for m in ssm["models"]])
        cross = serve_models_phase(torch, args.seed, SERVE_CROSS_MODELS,
                                   published_scale=True,
                                   name="serve_cross_model")
        record["serve_cross"] = cross
        phase("serve_cross", seconds=cross["seconds"],
              flash_launches=cross["flash_launches"],
              archs=[m["arch"] for m in cross["models"]])
        trained = train_phase(torch, args.seed)
        record["train"] = trained
        phase("train", **{k: v for k, v in trained.items()
                          if k != "profile_step"})
        phase("train_profile", profile_step=trained["profile_step"])
        # the dry-run child traces on the host's CPU beside train_models'
        # card-vs-CPU checks, which are not timed, and is joined before
        # the sharded phase: no timed phase shares the host with it
        models_trained = train_models_phase(
            torch, args.seed,
            before_checks=lambda: started.append(start_dryrun()))
        child = started[0]
        waited = join_dryrun(child)
        record["train_models"] = models_trained
        phase("train_models", **{k: v for k, v in models_trained.items()
                                 if k not in ("models", "card_vs_cpu")},
              archs=[m["arch"] for m in models_trained["models"]])
        sharded = sharded_phase(torch, args.seed)
        record["sharded"] = sharded
        phase("sharded", **sharded)
        dry = dryrun_phase(child, waited, sharded)
        record["dryrun"] = dry
        phase("dryrun", **dry)
        record["device_readings"] = phase(
            "device_readings", readings=len(DEVICE_READINGS),
            complete=sum(r["complete"] for r in DEVICE_READINGS),
            by_traces=dict(collections.Counter(
                r["traces"] for r in DEVICE_READINGS)),
            retried=[r for r in DEVICE_READINGS if r["traces"] > 1])
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr)
        return 1
    finally:
        for proc, _, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    # every path's window: the main path's, the workflow's, the doors' and
    # the tiers', both modes, and both examples'
    launches = {k: sum(r["launches"][k] for r in runs + flows + doors
                       + tiers + list(examples.values()))
                for k in build.VCS_SOURCES}
    # attention: the serve windows' (jamba's attention layer, whisper's
    # encoder and cross sublayers, llama-vision's cross layers among them)
    # and the train windows'
    launches["flash_attention"] = serve["flash_launches"] \
        + models["flash_launches"] + ssm["flash_launches"] \
        + cross["flash_launches"] \
        + trained["launches"]["flash_attention"] \
        + models_trained["flash_launches"] + sharded["flash_launches"]
    launches["flash_attention_bwd"] = trained["launches"][
        "flash_attention_bwd"] + models_trained["bwd_launches"] \
        + sharded["bwd_launches"]
    replaces = {
        "rowhash": "src/repro/kernels/rowhash.py:43",
        "searchsorted": "src/repro/kernels/searchsorted.py:48",
        "segsum_diff": "src/repro/kernels/segsum_diff.py:42",
        "probe": "src/repro/kernels/probe.py:70",
        "flash_attention": "src/repro/kernels/flash_attention.py:84",
        # no Pallas entry: the reference differentiates its XLA attention
        "flash_attention_bwd": "src/repro/models/layers.py:64",
    }
    line = []
    for name in build.SOURCES:
        e = kern[name][0]   # the first (a main-path) shape
        line.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": max(x["max_abs_err"] for x in kern[name]),
            "ms": e["ms"], "plain_ms": e["plain_ms"],
            "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
            "library_ms": e["library_ms"]})
        if name == "flash_attention_bwd":
            # of those, the launches with a sliding window that binds
            line[-1]["window_launches"] = models_trained[
                "window_bwd_launches"]
    record["kernel_line"] = line
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1,
                                                    sort_keys=True))
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
