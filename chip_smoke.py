#!/usr/bin/env python3
"""Drive freud_tpu_torch's main paths once on one CUDA card, and check them.

The first path is activation collection at Whisper-tiny width (d 384, 6
heads, 4 layers, random weights from a seed): WAV → decode → CUDA log-mel
kernel → encoder up to block 2 (fused q/k/v attention kernel) → store; then
SAE training on that store at tiny_topk / tiny_l1 width (d_in 384, n_dict
6144, k 32; 50 files × 1500 frames = 75,000 rows a step): store → train
step (TopK: fused forward kernel; multi_topk: thresholds kernel) →
checkpoint; then collection with the trained SAE attached. The second path
is the same at Whisper-large width (d 1280, 20 heads, 32 layers, random
weights): collection to block 16 with the blocked attention kernel, for
large-v1 (80 mel bands, batch 32) and large-v3 (128 bands, batch 16), then
the large_v1_audioset TopK recipe (d_in 1280, n_dict 20480, k 32, k_aux
640; 48,000 rows a step) and the large_v3_l1 recipe on those stores.

  0. the card (nvidia-smi name and power limit), torch and CUDA versions,
     whether TensorBoard imports;
  1. build every kernel source from csrc/ with nvcc for sm_90a, in
     parallel;
  2. each kernel against its plain PyTorch version on the card, at the
     main paths' shapes (and edge rows for the TopK kernels, kernel #4 also
     at large_v1_audioset's geometry, its select launch timed alone by its
     profiler name; kernel #3 also in f32 and at the selection core's edges:
     widths not a multiple of 8, n_dict 20,480 and 2^15 + 8, one row, rows
     all -inf; kernel #1 at 80 and 128 bands, with
     mostly silent clips, and also against its recipe with exact sums;
     kernel #2 also against its plain version rounded where the contract
     rounds; the TopK backward's masked pair and route,
     ``csrc/topk_backward.cu``, bit-equal to their plain versions, db_enc
     within its f32 rounding bound, in bf16 and f32 at tiny_topk's shape,
     with none and every latent dead, at large_v1_audioset's and at one
     rank's columns of its dictionary split in two; the 3xTF32 product,
     ``csrc/gemm_f32x3.cu``, at large collection's three encoder linears
     and both collect cells' SAE encode products, over every row against
     float64 within 2× cuBLAS f32's error and 30× under one TF32
     product's, timed beside cuBLAS f32), with its stated
     tolerance, and both timed
     (median CUDA-event time after warm-up), beside the kernel's bound
     (freud_tpu_torch.flops, from this run's inputs; every time must be at
     or above it) and the PyTorch calls that compute the same function where
     there are (scaled_dot_product_attention for #5; for #2 F.linear + SDPA
     on #2's own inputs, packing and casts inside the timed call; a
     yardstick only, the port never calls it);
  3. the collection CLI (``python -m freud_tpu_torch.scripts.collect_activations
     --config ...``, run in-process) over 48 30-s WAVs, 3 shorter ones and
     an undecodable one at batch 32 (a ragged tail batch): store shape, finiteness, metadata and
     the kernels' launch counts in that run; files/s and RTFx;
  4. the same collection of 2 files on the CPU plain path against the card;
  5. the train CLI (``python -m freud_tpu_torch.scripts.train_sae``, run
     in-process) on that store from configs/train/tiny_topk.json: 30 steps
     with AuxK active from step 2, checkpoints that load with
     weights_only=True, kernel #4's launches and one of each backward pass
     a step; then 4 steps with multi_topk (kernel #3's launches, no
     backward pass) and 4 steps of tiny_l1.json; steps/s each;
 5b. the train CLI through the device cache (``device_cache_files`` 24 of
     the 51 files, refresh on, ``fused_steps`` 10, ``save_every`` and
     ``val_every`` 30): tiny_topk with an f32 and a bf16 window (AuxK from
     step 2), 10 multi_topk steps and tiny_l1 at batch 50; each chunk a
     CUDA graph replay: steps, checkpoints and the one validation on their
     cadence, kernel #4 and the backward passes (#3 under multi_topk) once
     a replayed step (and once for the capture's warm-up), finite losses, the window's bytes against
     its shape and dtype, the resident validation set on; then a chunk of 5
     tiny_topk steps (batch 50, kernel #4 inside, AuxK active) and one of 5
     tiny_l1 steps (batch 100) replayed as a graph against the same steps
     run eagerly from the same state on the same window rows: parameters,
     moments, count, counters and metrics bit-equal (else within 1e-6 of
     max), and a second replay equal to the first;
  6. one TopK batch (2 files) at full width on the card and on the CPU from
     the same weights: losses and parameter gradients;
  7. collection with the trained TopK checkpoint as sae_model: the indexed
     store;
  8. the collection CLI at large width from the repo's large feature
     configs (only the model, data and output folders replaced):
     random:large-v1 at batch 32 over 34 30-s WAVs and a shorter one,
     random:large-v3 at batch 16 over 17 30-s WAVs; stores (n, 1500, 1280),
     the blocked attention kernel launched 17 times a batch and the fused
     one never, the 3xTF32 product six times a block; RTFx;
  9. test:large-v3 (2 layers at full width, 128 bands) on the card against
     the CPU plain path, 2 files at block 1;
 10. the train CLI from configs/train/large_v1_audioset.json on the
     large-v1 store, 10 steps with AuxK active (kernel #4 at d_in 1280,
     n_dict 20480), and from large_v3_l1.json on the large-v3 store, 4
     steps; steps/s, median step and peak device memory;
 11. one TopK batch (1 file) at large width on the card and on the CPU;
 12. the transcribe CLI (``python -m freud_tpu_torch.scripts.transcribe``,
     run in-process) with random:tiny at batch 8 over 8 30-s WAVs, 3 short
     ones and an undecodable one (a padded tail batch): greedy f32 twice
     (token-equal), greedy bf16, beam 5, the fallback ladder; one transcript
     a file ("<decode-failed>" for the broken one), kernel #1 once a batch
     and #2 four times a batch in each run, and whisper's rules on every
     decoded row (EOT padding, non-decreasing paired timestamps, the first
     sampled token a timestamp ≤ ts0 + 50); files/s, RTFx, tokens a clip,
     ms a step and peak memory; phase 5's run also decodes its validation
     transcripts (4 files a validation, their TensorBoard tags read back);
 12b. one encoded batch (2 clips) from the CPU on the card: teacher-forced
     logits and the KV-cached step's rows within 1e-4 of max of the CPU's,
     greedy and beam-5 tokens equal to the CPU's up to the first step whose
     CPU post-rules top-two margin is under 1e-3;
 13. the transcribe CLI with random:large-v3 (128 bands) over 8 30-s WAVs:
     greedy at batch 8 in f32 and bf16, beam 5 at batch 2; kernel #5 32
     times a batch, #2 never; ms a step, RTFx, peak memory;
 14. (after phase 7) decoder-layer collection: the collection CLI on
     random:tiny ``decoder.blocks.2`` over phase 3's WAVs at batch 32 (the
     whole encoder, a 224-token greedy decode, one teacher-forced captured
     pass a batch): store (51, 227, 384), n_frames the decode's valid
     positions in [4, 227], kernel #1 once and #2 four times a batch; then
     ``.mlp.1`` over 8 files (width 1536) and phase 5's TopK checkpoint
     attached over 8 files (an indexed store); RTFx, ms a decode step;
 15. the train CLI on that store: tiny_topk 10 steps, val_every 5, the
     validation transcripts steered online by the live SAE (TensorBoard
     tags read back), kernel #4 once a step; the same through a 24-file
     device cache in CUDA-graph chunks of 5 (#4: 6, 5); 4 tiny_l1 steps (an
     L1 tap); 3 fly-mode steps at batch 8 from the WAVs (#1 once and #2
     four times in each captured batch);
 16. 2 clips on the card against the CPU (the encoder's attention on its
     f32 path on both): ``decode_capture`` activations within 1e-4 of max,
     tokens and greedy tokens steered by phase 5's TopK SAE (factor 1 and
     8) equal up to the first CPU post-rules margin under 1e-3 (the
     steered margins those of the substituted teacher-forced oracle), and
     the tapped KV-cached step against that oracle on the card;
 17. (after phase 13) random:large-v3 ``decoder.blocks.16`` over phase 13's
     8 30-s WAVs at batch 8: store (8, 227, 1280), #5 32 times a batch, ms
     a decode step and peak memory; a raw-channel tap at factor 1 gives
     the unsteered decode's tokens.
 18. (after phase 16) the feature-major index and search: the index CLI
     (``python -m freud_tpu_torch.scripts.index_activations``, in-process)
     over phase 3's dense store and phase 7's indexed one (MB/s), and
     ``top_activations`` on both for 3 features, plain and abs-magnitude:
     the fast path equals the scan and the CPU's answer bit for bit (ms a
     query each path); then a collection with ``build_index`` over the
     first batch of files and a resumed one over the rest: the index grows
     a segment and stays current;
 19. the GUI server (``freud_tpu_torch.server.app``) on the card in this
     process on port 0, random:tiny: from disk over phase 3's store (no
     SAE), over phase 7's store with phase 5's TopK checkpoint, fly mode
     over the WAVs with the tiny_l1 checkpoint, and from disk over phase
     14's ``decoder.blocks.2`` store. Requests: /status, /top_files (scan,
     and the fast path where indexed), /audio with a Range (206, the
     file's bytes), /top_features, /manipulate_feature (factor 8; factor 1
     too without an SAE, giving three equal texts), /transcribe; each
     timed (median of 3, of 2 for the decode-bound ones) with its
     launches: #1 once an upload, #2 three times a capture to block 2 (4
     before a decoder capture) and 4 times a decode's encoder; a fly
     search #1 once and #2 three times a batch; one profiled request of
     each endpoint (device-busy share). Card against CPU on 2 clips
     (``files_to_search`` 2): /top_files bodies identical, /top_features
     traces within CARD_VS_CPU_TOL. In each setup an out-of-range index
     answers 400 and the next request 200;
 20. (after phase 17) large width: the index CLI and search over phase 8's
     random:large-v1 store (35 × 1500 × 1280), then the server from disk
     over it with phase 10's large_v1_audioset checkpoint: /status,
     /top_files on both paths (equal bodies), /top_features and
     /manipulate_feature at factor 8 (median of 2), #5 17 times a capture
     and 32 times a decode's encoder. The server's decode budget is cut
     to LARGE_SERVER_MAX_NEW (64) tokens a transcript to stay within the
     time limit.
 21. (after phase 20) long-form transcription: the transcribe CLI with
     ``--long --word_timestamps --output_format srt`` and the full
     temperature ladder, random:tiny (decode budget 48 a window) over a 75-s
     and a 45-s clip: every decoded row under whisper's rules, segments
     timed inside each recording, an srt with cues a file, kernel #1 never
     (``full_log_mel`` is plain torch: its floor is global) and #2 four
     times a window; windows, rungs a window, ms a decode step, ms an
     alignment pass, RTFx;
 22. random:tiny long-form on the card against the CPU over the 45-s clip
     at t = 0 with word timestamps: ``full_log_mel`` within the log-mel gate
     (and its ms a minute of audio), each window's tokens equal up to the
     first CPU post-rules margin under 1e-3, the words equal on the windows
     whose tokens are equal; one profiled window: the device-busy share;
 23. random:large-v3 long-form in bf16 (decode budget 24; the alignment
     pass on its f32 decoder) over the 45-s clip through the CLI as in 21:
     #5 32 times a window, #1 and #2 never;
 24. the GUI server (random:tiny from disk, decode budget 48) on port 0:
     ``/transcribe?long=1&word_timestamps=1&format=srt`` and the 45-s upload
     without ``long``, twice each, timed, #1 never and #2 four times a
     window.
 25. (after phase 24) Whisper small (``random:small``, d 768, 12 heads):
     kernel #2 at (16, 1500, 768), its widest width, against its plain
     versions and timed beside its bound and library yardstick; then the
     collection CLI with a list of four layers (blocks 2, 5, 8 and 11, one
     encoder pass a batch) over 36 30-s WAVs and an undecodable one at
     batch 16 (a ragged tail), ``build_index`` on: #1 once and #2 12 times
     a batch (the wrappers' counts, and by kernel name in a profiled
     one-batch run), stores (36, 1500, 768) without the broken file, blocks
     11 and 2 equal to their single-layer collections (1e-6 of max) and
     within CARD_VS_CPU_TOL of the CPU on 2 files; RTFx and ms a batch;
 26. kernel #4 at the sweeps' step shape, (12,000, 768) → 12,288, at k 32
     and at the grid's k 16, and kernel #3 at the multi_topk sweep's
     (12,000, 12,288) in f32 and bf16 (k 32, k_aux 384, k_multi 128, bit-equal),
     each against its plain version and timed beside its bound; then the sweep CLI
     (``python -m freud_tpu_torch.scripts.sweep``, in-process) per layer
     over phase 25's four stores: TopK 20 steps at batch 8 (#4 four times
     a step, AuxK active), L1 10 steps, a 2-step multi_topk sweep (#3 four
     times a step); the ``<layer>.pth`` checkpoints load; members 0 and 3
     equal solo trainers with their seeds after 5 steps (1e-5 of max); the
     synchronised sweep step against a solo step, peak memory;
 27. the grid sweep CLI (k × auxk_alpha × lr, 8 members in 2 k-groups) on
     the block-11 store through a 24-file device cache, 25 steps: 2 chunks
     of 10 as CUDA graphs and a 5-step tail, every k-group on the same
     index tensor of each chunk and the same tail batch, #4 once a member
     a step (and the captures' warm-ups), 8 checkpoints with JAX's tags;
     one k-group's replayed chunk against the same steps run eagerly.
 28. (after phase 27) two ranks on one card. First two processes ask
     NCCL for a group on cuda:0 and report whether it takes them, with
     NCCL's own words (``NCCL_DEBUG=WARN``). Then ONE spawned pair of this
     script (``--pod-rank``), gloo named, both on cuda:0, reporting to the
     parent as JSON. tiny_topk at
     full width, global batch 50 (25 files a rank, ``host_bounds``), 10
     steps with AuxK from step 2: each step against one process from the
     pod's state on rank 0 (metrics within 1e-4 relative, dead counters
     equal, step-1 parameters within 1e-6 of max), the ranks' counters
     equal, kernel #4 once a step a rank; a free-running one-process run
     beside it (its drift reported); 5 more steps timed without the
     comparison (two ranks SHARING one card: not a scaling number); the
     rank-0 checkpoint loads with weights_only=True into a one-card
     trainer; 2 multi_topk steps (kernel #3 once a step a rank) and 4
     tiny_l1 steps through ``train(mesh=)`` (artifacts on rank 0 only);
     the pod cache (``process_shard=(rank, 2)`` over 24 files) and one
     ``train_chunk_pod`` of 5 (eager under gloo) bit-equal to the same
     steps run one by one; ``top_activations(mesh=)`` over phase 3's store,
     3 features, index and scan, bit-equal to the one-rank answer; a
     2-member sweep step over two of phase 25's stores within 1e-6 of max
     of one process.
 29. NCCL at world size 1 in this process: ``train(mesh=)`` 10 steps,
     checkpoint tensors bit-equal to ``train()`` without a process group;
     one pod chunk of 5 captured with its NCCL collectives and replayed as
     a CUDA graph against its eager steps.
 30. (the pair of 28) ``data_parallel`` collection over phase 3's WAVs and
     the broken one at batch 32: ``shard0``/``shard1`` merged by
     ``merge_stores`` equal phase 3's store within 1e-6 of max, file order
     and metadata identical, kernel #1 once and #2 three times a batch a
     rank; a two-layer collection of 8 files (blocks 1 and 2) merged
     against the one-rank stores.
 31. the model axis (``shard_dict``). (a) In this process, the selection
     across dictionary shards (``csrc/topk_sharded.cu``: a candidates
     launch a shard, the gather as a stack, a combine launch a shard) at
     large_v1_audioset's (48,000 × 20,480), bf16 (exact path) and f32
     (float path), P = 2 and 4, a third dead, fewer dead than k_aux, a
     first shard with none, none: thresholds bit-equal to kernel #3 on the
     whole latent and to the plain version on every shard, the fired bits
     each shard's columns; both launches timed beside their bounds, their
     plain versions and ``torch.topk(acts_s, k)``. Kernel #4's encode and
     decode launches (``csrc/topk_fused.cu``), which a split dictionary's
     bf16 step runs around that selection, at the shard (48,000 × 1280) →
     10,240 of a dictionary split in two: acts bit-equal to the whole
     forward's columns and within one ulp of the plain encode, the
     thresholds across the shards the whole forward's, each decode within
     1e-3 of max of its plain version and the shards' sum within 1e-3 of
     max of the whole forward's; both timed beside their bounds, their
     plain versions and the bf16 ``torch.mm`` alone. (b) One spawned pair of
     this script (``--model-axis-rank``), gloo named, both on cuda:0, as a
     data 1 × model 2 mesh: ``SAETrainer(shard_dict=True)`` at
     large_v1_audioset's width (batch 16, seeded rows around a fixed
     mean), 3 steps with AuxK from step 2, each held on rank 0 against the
     one-process step from the sharded state (metrics within 1e-5
     relative, counters equal, no row's thresholds differing from kernel
     #4's, the parameter gap reported), its selection bit-equal to kernel
     #3 on the ranks' latents gathered, and one launch each of kernel #4's
     encode and decode, the candidates and the combine a rank a step; 2
     steps timed (two ranks SHARING one card: not a scaling number); one
     large_v3_l1 step against one process (metrics within 1e-2: x̂ is
     rounded to bf16 after the sum over the ranks) and 2 timed. (c) NCCL at world size 1:
     ``shard_dict`` on a model axis of one bit-equal to the unsharded
     trainer for 3 steps, and its pod chunk of 5 replayed as a CUDA graph
     bit-equal to its eager steps.

Every phase asserts; any failure exits nonzero. The last three lines of
standard output are the card's name and power limit, the kernels' JSON
record (per kernel: ms, plain_ms, bound_ms and what bounds it,
library_ms or null with the reason, launches in the main path's run and
per collection batch or train step; #1, #2 and #5 also their launches in
the transcription runs, #3 and #4 in the cache runs, every kernel in the
decoder runs of phases 14–17, #1, #2 and #5 in the server phases 19–20
and in the long-form phases 21–24, #4 the graph-against-eager difference)
and the device JSON (#1, #2 and #5 also their launches in phase 25, #3
and #4 in phases 26–27, #2, #3 and #4 their records at phases 25–26's
shapes, every kernel its launches in phases 28–30 as ``launches_pod``;
#3 and #4 also ``launches_model_axis`` and the ``model_axis`` record of
phase 31's launches). The TopK backward's two passes have a record each
too: launches in phase 5 (one a step), the cache runs, phases 26–27, 28–30
and 31, and the time at each shape of phase 2 beside its plain version and
bytes bound. Before them, one JSON line records phase 31
(``{"model_axis": …}``).
Before that, one JSON line records phases 28–30 (``{"pod": …}``): the
comparisons, the ms a step, the chunk, the sweep, the merged stores and the
launches by rank; before that, one phases 25–27: the collection's RTFx, ms
a batch, launches, the store differences and the profiled batch; the
sweeps' launches, steps, the member differences, the sweep step against a
solo step, the grid's chunk times and its graph against eager. Before
that, one JSON line records phases 18–20:
index-build MB/s, ms a query on each search path, ms a request an endpoint
with its launches, device-busy shares; and one phases 21–24: windows,
rungs a window, ms a decode step, alignment ms a window, RTFx,
``full_log_mel`` ms a minute, the card-vs-CPU windows, the profiled call's
device-busy share and the server's ms a request.

``--bench`` measures instead of checking: after the build it times the
five kernels through their wrappers at the main paths' shapes (kernel #1
at both band counts; kernel #3 in bf16 and f32; kernels #2 and #4 also by
launch, from torch.profiler kernel names, #4's select launch picked out;
kernel #2's library yardstick), the numbers of PERF.md's table of kernels.
Collection, SAE training and the GUI's /top_features are the benchmark's
cells (``portbench/``) and are not timed here. Then one batch of 8 30-s
clips transcribed greedily at the full 224-token budget (early exit off)
with random:tiny in f32 and bf16 and random:large-v3 in bf16: RTFx, ms a
token, device-busy share and device time by kernel and by decode part
(null on a tree without transcription); then random:tiny
``decoder.blocks.2`` collection's steady RTFx (64 and 32 30-s files after
an untimed run, batch 32) and ms a decode step of 8 30-s clips at the full
budget unsteered and steered by a TopK SAE at tiny_topk width (null on a
tree without decoder capture). It prints one JSON line. It reaches the
package only through the wrappers, the CLIs and the runtime, whose
interfaces are those of every checkout that holds all five kernels, so a
copy of this script placed in an older checkout times that checkout's
kernels with the same code: run parent, change, change, parent in one
call to compare two trees.

``--pod-only`` runs phases 28–30 alone (after the build) on the stores
they read, made first: phase 3's collection and its index, and 12 files
of Whisper small's blocks 2 and 5. ``--model-axis-only`` runs phase 31
alone (after the build; it makes its own rows and store), ``--topk-only``
phase 2's kernel #3 and #4 checks. ``--knockouts`` times the sharded
selection's two launches against copies of their sources with one part
taken out, built into a temporary directory (``KNOCKOUTS``: the copies
whose marks the checkout's sources hold, so a copy of this script in an
older checkout knocks out that checkout's design).

Phase 2 also holds Uni-MoE-2.0-Omni's MoE kernels (``csrc/moe.cu``) against
their plain versions at the omni cell's shapes, skewed routing and a
ragged token count, then captures ``lm.layers.20`` of the benchmark's
Uni-MoE-2.0-Omni at its published widths (weights drawn on the card) once
under ``set_sync_debug_mode("error")``, asserting 21 launches of each MoE
wrapper; then LongCat-Flash-Omni's: the top-k route, plan, the grouped
products over the held experts and combine with the identity range against
their plain versions at the LongCat cell's shapes (13,024 tokens, 768 router
entries, top 12, 16 held experts, tied logits, held ranges with no rows or
every token), the route and the products timed beside their bounds, and one
capture at ``lm.layers.3`` of the benchmark's LongCat-Flash-Omni at its
published widths under the same sync check, asserting one launch of each
wrapper a double layer (``--moe-only`` runs these four checks alone).

Usage: python3 chip_smoke.py [--bench | --pod-only | --model-axis-only | --moe-only |
--topk-only | --knockouts] (needs one CUDA card)
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import runpy
import statistics
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SEED = 0
N_LONG, N_SHORT_S = 48, (0.5, 7.3, 12.5)  # 48 × 30 s + 3 shorter clips
BATCH = 32
LAYER = "encoder.blocks.2"
# bf16 attention products in blocks 0-2 against the f32 CPU path, relative
# to the CPU store's max |value|
CARD_VS_CPU_TOL = 5e-2
# TopK training at tiny_topk width
D_IN, N_DICT, K, K_AUX = 384, 6144, 32, 192
M_ROWS = 50 * 1500  # one step's rows
TRAIN_STEPS = 30
CACHE_FILES = 24  # the device cache's window in the smoke (of a 51-file store)
# the large path: Whisper large (d 1280, 20 heads) to block 16
LARGE_LAYER = "encoder.blocks.16"
LARGE_D, LARGE_N_DICT, LARGE_K_AUX = 1280, 20480, 640
LARGE_M_ROWS = 32 * 1500  # one large_v1_audioset step's rows
LARGE_TRAIN_STEPS = 10
# --bench: 30-s files of large-v1 collection, large_v1_audioset steps
# transcription: tiny's batch, its file mix (30-s clips, shorter ones and an
# undecodable one: a padded tail) and large-v3's beam batch
TRANSCRIBE_BATCH, TRANSCRIBE_LONG, BEAM_BATCH = 8, 8, 2
DECODE_CLOSE_CALL = 1e-3  # a post-rules top-two margin below this may flip
# decoder-layer capture: tiny's block 2 and large-v3's block 16; a store's
# rows are the multilingual SOT sequence (3) and the decode's 224 tokens
DEC_LAYER, LARGE_DEC_LAYER, DEC_FRAMES = "decoder.blocks.2", "decoder.blocks.16", 3 + 224
STEER_FACTOR = 8.0
# the large server's decode budget a transcript (three a /manipulate_feature)
LARGE_SERVER_MAX_NEW = 64
# long-form: the clips (s) of the tiny CLI run, the decode budgets a window
# (random weights never emit EOT: every decode runs its budget) and the
# tiny card-vs-CPU run's
LONG_CLIPS_S = (75.0, 45.0)
LONG_MAX_NEW_TINY, LONG_MAX_NEW_LARGE, LONG_CV_MAX_NEW = 48, 24, 32
WORD_PROB_REL = 2e-3  # word probabilities card against CPU, relative (|logit| ≤ 10)
# phases 25-27: Whisper small (d 768, 12 heads): four layers from one encoder
# pass over 36 30-s clips at batch 16, then sweeps at tiny_topk's dictionary
# (expansion 16: n_dict 12,288) and batch 8 files (12,000 rows a step)
SMALL_LAYERS = ["encoder.blocks.2", "encoder.blocks.5", "encoder.blocks.8",
                "encoder.blocks.11"]
SMALL_D, SMALL_HEADS, SMALL_BATCH, SMALL_FILES = 768, 12, 16, 36
SMALL_N_DICT = 16 * SMALL_D
SWEEP_BATCH = 8
SWEEP_ROWS = SWEEP_BATCH * 1500
SWEEP_TOPK_STEPS, SWEEP_L1_STEPS = 20, 10
GRID_LAYER = "encoder.blocks.11"
GRID = {"k": [16, 32], "auxk_alpha": [0.03125, 0.0625], "lr": [1e-4, 4e-4]}
GRID_STEPS, GRID_CHUNK, GRID_CACHE_FILES = 25, 10, 24
# phases 28-30: two gloo ranks on one card, then NCCL at world size 1:
# tiny_topk's global batch (25 files a rank), its steps, the pod cache's
# files and chunk, and the two-layer data_parallel collection
POD_BATCH, POD_STEPS, POD_CACHE_FILES, POD_CHUNK = 50, 10, 24, 5
POD_LAYERS, POD_ML_BATCH, POD_ML_FILES = ["encoder.blocks.1", "encoder.blocks.2"], 4, 8
POD_TIMED_STEPS, POD_TIMEOUT_S = 5, 420
# the TopK backward's pass wrappers (ops/topk_backward), one of each a step
BACKWARD_PASSES = ("topk_masked_pair", "topk_route")
# phase 31: large_v1_audioset over a data 1 × model 2 mesh of two gloo ranks
# on one card (the batch cut from the recipe's 32 files: see PERF.md §4)
MODEL_AXIS_BATCH, MODEL_AXIS_STEPS, MODEL_AXIS_TIMED_STEPS = 16, 3, 2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def yardsticks(bound, library_ms=None, library: str | None = None) -> dict:
    """A kernel record's bound (and what bounds it) and library call."""
    return dict(bound_ms=bound.bound_ms, bound_by=bound.bound_by,
                library_ms=library_ms, library=library)


def check_mel(torch, device, card):
    """Kernel #1 at both band counts against its plain version (the gate of
    tests/test_mel_pallas.py) and against its recipe with exact sums
    (log_mel_spectrogram_recipe, within the recipe gate of
    freud_tpu_torch/ops/mel.py), on noise clips
    and with clip 1 silent after 1000 samples (the floor clamps most of its
    bins); two launches bit-equal. With all 32 clips silent after 1000
    samples it is held to the recipe only: on clip 15 the recipe itself is
    2.4e-3 off the f64 log-mel, above the plain path's 2e-3 gate
    (tests/test_torch_mel.py pins that reading)."""
    from freud_tpu_torch import flops
    from freud_tpu_torch.audio.mel import log_mel_spectrogram
    from freud_tpu_torch.ops.mel import (
        RECIPE_MAX,
        RECIPE_SHARE,
        log_mel_spectrogram_cuda,
        log_mel_spectrogram_recipe,
        recipe_gap,
    )

    gen = torch.Generator().manual_seed(SEED)
    audio = (torch.randn((BATCH, 480000), generator=gen) * 0.1).to(device)
    silent = audio.clone()
    silent[1, 1000:] = 0.0
    all_silent = audio.clone()
    all_silent[:, 1000:] = 0.0
    record = {}
    for n_mels in (80, 128):
        for name, clips in (("noise", audio), ("clip 1 silent after 1000 samples", silent),
                            ("all clips silent after 1000 samples", all_silent)):
            got = log_mel_spectrogram_cuda(clips, n_mels)
            again = log_mel_spectrogram_cuda(clips, n_mels)
            want = log_mel_spectrogram(clips, n_mels)
            recipe = log_mel_spectrogram_recipe(clips, n_mels)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            max_err = diff.max().item()
            loose = (diff > 3e-4).float().mean().item()
            recipe_err, recipe_share = recipe_gap(got, recipe)
            recipe_plain = (recipe - want).abs().max().item()
            print(f"mel n_mels={n_mels} B={BATCH} ({name}): against the plain path max|Δ| "
                  f"{max_err:.3e} (bound 2e-3; the recipe's own {recipe_plain:.3e}), share "
                  f"|Δ|>3e-4 {loose:.2e} (bound 1e-5); against the recipe, log10 units: "
                  f"max|Δ| {recipe_err:.3e} (bound {RECIPE_MAX}), share |Δ|>1e-5 "
                  f"{recipe_share:.2e} (bound {RECIPE_SHARE}); two launches bit-equal")
            assert got.shape == (BATCH, n_mels, 3000)
            assert torch.equal(got, again)
            assert recipe_err < RECIPE_MAX and recipe_share < RECIPE_SHARE, (
                recipe_err, recipe_share)
            if name.startswith("all"):
                continue
            assert max_err < 2e-3 and loose < 1e-5, (max_err, loose)
            if name == "noise":
                noise_err = max_err
        ms = cuda_ms(lambda: log_mel_spectrogram_cuda(audio, n_mels))
        plain_ms = cuda_ms(lambda: log_mel_spectrogram(audio, n_mels))
        bound = flops.log_mel_bound(BATCH, n_mels)
        print(f"mel n_mels={n_mels} B={BATCH}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound.bound_ms:.4f} ms ({bound.bound_by}) on {card}")
        if n_mels == 80:  # Whisper tiny's bank: the main path's shape
            record.update(max_abs_err=noise_err, ms=ms, plain_ms=plain_ms, **yardsticks(
                bound, None,
                "none: torch.stft gives the spectrum only; the mel projection, "
                "log and clamp are further calls"))
        else:  # large-v3's bank
            record.update(ms_128=ms, plain_ms_128=plain_ms, bound_ms_128=bound.bound_ms)
    return record


def fused_library_call(torch, x, w, bq, bv, heads):
    """The one PyTorch call sequence that computes kernel #2's function from
    its own inputs: pack [Wq | Wk | Wv] and [bq | 0 | bv] to bf16, cast x,
    one F.linear, SDPA at 64^-½, heads merged back to x's dtype. A
    yardstick only: the port never calls it."""
    import torch.nn.functional as F

    b, s, d = x.shape
    wp = torch.cat([w[0].t(), w[1].t(), w[2].t()]).to(torch.bfloat16)
    bias = torch.cat([bq, torch.zeros_like(bq), bv]).to(torch.bfloat16)
    qkv = F.linear(x.to(torch.bfloat16), wp, bias).view(b, s, 3, heads, 64)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], scale=64 ** -0.5)
    return o.transpose(1, 2).reshape(b, s, d).to(x.dtype)


def fused_library_core(torch, x, w, heads):
    """The yardstick's core alone, two calls: bf16 x and the packed weight
    prepared outside the timed call, no biases, bf16 heads out."""
    import torch.nn.functional as F

    b, s, _ = x.shape
    xb = x.to(torch.bfloat16)
    w_qkv = torch.cat(w, dim=1).T.contiguous().to(torch.bfloat16)

    def core():
        qkv = F.linear(xb, w_qkv).view(b, s, 3, heads, 64).permute(2, 0, 3, 1, 4)
        return F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], scale=64 ** -0.5)

    return core


def check_attention(torch, device, card):
    """Kernel #2 against its f32 plain version (2e-2 of max) and against the
    plain version rounded where the contract rounds (ATTN_BF16_GATE), for
    f32 and bf16 x, with the weights as the model passes them (transposed
    nn.Linear weights) and as (d_in, d_out) tensors; two launches
    bit-equal."""
    from freud_tpu_torch import flops
    from freud_tpu_torch.ops.attention import (
        ATTN_BF16_GATE,
        fused_qkv_attention,
        fused_qkv_attention_plain,
    )

    gen = torch.Generator().manual_seed(SEED + 1)
    d, heads = 384, 6
    w = [(torch.randn((d, d), generator=gen) * d ** -0.5).to(device)
         for _ in range(3)]
    w_model = [t.T.contiguous().T for t in w]  # nn.Linear (out, in) weights, transposed
    bq, bv = ((torch.randn((d,), generator=gen) * 0.1).to(device) for _ in range(2))
    record = None
    for b, s, dtype in ((BATCH, 1500, torch.float32), (8, 1500, torch.bfloat16),
                        (8, 777, torch.float32), (3, 1, torch.bfloat16)):
        x = torch.randn((b, s, d), generator=gen).to(device, dtype)
        name = str(dtype)[6:]
        for layout, ws in (("(d_in, d_out)", w), ("model", w_model)):
            args = (x, ws[0], bq, ws[1], ws[2], bv, heads)
            got = fused_qkv_attention(*args)
            again = fused_qkv_attention(*args)
            want = fused_qkv_attention_plain(x.float(), *args[1:])
            want_bf16 = fused_qkv_attention_plain(x.float(), *args[1:],
                                                  matmul_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            max_err = (got.float() - want).abs().max().item()
            rel = max_err / want.abs().max().item()
            rel_bf16 = ((got.float() - want_bf16).abs().max() / want_bf16.abs().max()).item()
            print(f"attention b={b} s={s} d={d} h={heads} {name} x, {layout} weights: "
                  f"max|Δ|/max|ref| {rel:.3e} (bound 2e-2), against the bf16-rounded "
                  f"plain {rel_bf16:.3e} (bound {ATTN_BF16_GATE[dtype]}), two launches "
                  "bit-equal")
            assert got.shape == x.shape and got.dtype == dtype and torch.isfinite(got).all()
            assert torch.equal(got, again)
            assert rel < 2e-2, rel
            assert rel_bf16 < ATTN_BF16_GATE[dtype], rel_bf16
        if b == BATCH:  # the main path's shape, weights as the model passes them
            args = (x, w_model[0], bq, w_model[1], w_model[2], bv, heads)
            ms = cuda_ms(lambda: fused_qkv_attention(*args))
            plain_ms = cuda_ms(lambda: fused_qkv_attention_plain(*args))
            lib_ms = cuda_ms(lambda: fused_library_call(torch, x, w, bq, bv, heads))
            core_ms = cuda_ms(fused_library_core(torch, x, w, heads))
            bound = flops.fused_qkv_attention_bound(b, s, d, heads)
            print(f"attention b={b} s={s}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"library {lib_ms:.4f} ms (its core alone {core_ms:.4f}), bound "
                  f"{bound.bound_ms:.4f} ms ({bound.bound_by}) on {card}")
            record = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                          max_rel_err_bf16_plain=rel_bf16, library_core_ms=core_ms,
                          **yardsticks(bound, lib_ms, "F.linear (packed bf16 weight, "
                                       "[bq | 0 | bv]) + scaled_dot_product_attention on "
                                       "kernel #2's own f32 inputs, packing and casts "
                                       "inside the call"))
    return record


def check_whisper_attention(torch, device, card):
    """Kernel #5 against its plain version on (b, h, s, 64) head views of
    (b, s, h·64) projections, as the encoder passes them."""
    import torch.nn.functional as F

    from freud_tpu_torch import flops
    from freud_tpu_torch.ops.attention import whisper_attention, whisper_attention_plain

    gen = torch.Generator().manual_seed(SEED + 5)
    heads = 20
    record = None
    # (b, s, dtype, stable): the large-v1 batch (the record) and the large-v3
    # one; a ragged s; s = 129 (one row past a 128-row tile); stable=False
    # on the same unit-normal inputs (scores of std 1)
    cases = [(32, 1500, torch.float32, True), (16, 1500, torch.float32, True),
             (16, 1500, torch.bfloat16, True), (4, 777, torch.float32, True),
             (4, 129, torch.bfloat16, True), (4, 777, torch.float32, False)]
    for b, s, dtype, stable in cases:
        q, k, v = (torch.randn((b, s, heads * 64), generator=gen)
                   .to(device, dtype).view(b, s, heads, 64).transpose(1, 2)
                   for _ in range(3))
        got = whisper_attention(q, k, v, stable=stable)
        want = whisper_attention_plain(q.float(), k.float(), v.float())
        torch.cuda.synchronize()
        max_err = (got.float() - want).abs().max().item()
        rel = max_err / want.abs().max().item()
        print(f"whisper_attention b={b} h={heads} s={s} {str(dtype)[6:]} "
              f"stable={stable}: max|Δ| {max_err:.3e}, max|Δ|/max|ref| {rel:.3e} "
              "(bound 2e-2)")
        assert got.shape == (b, heads, s, 64) and got.dtype == dtype
        assert torch.isfinite(got).all()
        assert rel < 2e-2, rel
        if s == 1500:
            ms = cuda_ms(lambda: whisper_attention(q, k, v))
            plain_ms = cuda_ms(lambda: whisper_attention_plain(q, k, v),
                               warmup=1, reps=5)
            # the library yardstick on contiguous (b, h, s, 64), bf16 and f32
            lib = {}
            for lib_dtype in (torch.bfloat16, torch.float32):
                qc, kc, vc = (t.to(lib_dtype).contiguous() for t in (q, k, v))
                lib[lib_dtype] = cuda_ms(lambda: F.scaled_dot_product_attention(
                    qc, kc, vc, scale=64 ** -0.5))
                del qc, kc, vc
            bound = flops.whisper_attention_bound(b, heads, s, in_bytes=q.element_size())
            print(f"whisper_attention b={b} h={heads} s={s} {str(dtype)[6:]}: "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA bf16 "
                  f"{lib[torch.bfloat16]:.4f} / f32 {lib[torch.float32]:.4f} ms, bound "
                  f"{bound.bound_ms:.4f} ms ({bound.bound_by}) on {card}")
            if b == 32:  # the large-v1 collection's batch and dtype
                record = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                              **yardsticks(bound, lib[torch.bfloat16],
                                           "scaled_dot_product_attention on "
                                           "contiguous bf16 (b, h, s, 64), default "
                                           "dispatch"),
                              library_f32_ms=lib[torch.float32])
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return record


def _acts_agreement(got, want, x, w_enc, b_dec):
    """Share of acts that differ, and the largest difference in units of
    one bf16 ulp of the pre-activation bf16((x − b_dec)·W_encᵀ) plus one of
    the act: the card's f32 sums may round that product the other way, and
    after the bias and ReLU one ulp there can be a zero against a small
    positive value."""
    import torch

    bf16 = torch.bfloat16
    z = (x - b_dec).to(bf16).float() @ w_enc.to(bf16).float().T

    def ulp(v):
        _, e = torch.frexp(v.to(bf16).float())
        return torch.where(v == 0, 0.0, torch.ldexp(torch.ones_like(v), e - 8))

    diff = (got.float() - want.float()).abs()
    units = diff / (ulp(z) + ulp(want.float())).clamp_min(1e-38)
    return (diff > 0).float().mean().item(), units.max().item()


def _acts_sum_bound(got, want, x, w_enc, b_dec) -> dict:
    """Kernel #4's acts against the plain encode's under the bound that two
    f32 summation orders of the same bf16 products obey: each order is
    within γ_d·Σ|products| of the exact sum (γ_d = d·u / (1 − d·u), u =
    2⁻²⁴), so the pre-activations differ by at most 2·γ_d·Σ|products|, and
    the two bf16 roundings after the sum (of z, then of z + b_enc) add at
    most one ulp each. → the largest |Δ| over that bound (≤ 1 holds) and,
    at the entry farthest in ``_acts_agreement``'s ulp units, z, Σ|products|
    and both acts (a cancelling sum shows as Σ|products| ≫ |z|)."""
    import torch

    bf16 = torch.bfloat16
    xs = (x - b_dec).to(bf16).float()
    w = w_enc.to(bf16).float()
    z = xs @ w.T
    mag = xs.abs() @ w.abs().T
    d = x.shape[1]
    gamma = d * 2.0 ** -24 / (1 - d * 2.0 ** -24)
    dz = 2 * gamma * mag

    def ulp(v):
        _, e = torch.frexp(v.abs().to(bf16).float())
        return torch.where(v == 0, 0.0, torch.ldexp(torch.ones_like(v), e - 8))

    g, wa = got.float(), want.float()
    diff = (g - wa).abs()
    bound = dz + ulp(z.abs() + dz) + ulp(torch.maximum(g.abs(), wa.abs()))
    ratio = (diff / bound.clamp_min(1e-38)).max().item()
    units = diff / (ulp(z) + ulp(wa)).clamp_min(1e-38)
    i = int(units.argmax())
    r, c = divmod(i, z.shape[1])
    return {"sum_bound_ratio": ratio, "worst": {
        "z": z[r, c].item(), "sum_abs_products": mag[r, c].item(),
        "got": g[r, c].item(), "want": wa[r, c].item()}}


def _topk_inputs(torch, device, m, gen, d_in=D_IN, n_dict=N_DICT):
    x = torch.randn((m, d_in), generator=gen)
    w_enc = (torch.rand((n_dict, d_in), generator=gen) * 2 - 1) * d_in ** -0.5
    b_enc = -(torch.rand((n_dict,), generator=gen) * 0.1)  # <= 0: silent rows exist
    b_dec = torch.randn((d_in,), generator=gen) * 0.1
    w_dec = w_enc / w_enc.norm(dim=1, keepdim=True)
    x[7] = b_dec  # silent rows: x − b_dec = 0, so every act is relu(b_enc) = 0
    x[m - 1] = b_dec
    return [t.to(device) for t in (x, w_enc, b_enc, b_dec, w_dec)]


def _selected(acts, t_main, t_aux, dead) -> int:
    """Positive entries the two decodes take: the work the data needs."""
    pos = acts > 0
    return int(((acts >= t_main) & pos).sum() + ((acts >= t_aux) & pos & dead).sum())


def check_topk_fused(torch, device, card):
    """Kernel #4 against its plain version; selection and decodes are held
    against the plain selection run on the kernel's own acts, at tiny_topk's
    geometry and at large_v1_audioset's (d_in 1280, n_dict 20480, k_aux 640,
    94% of latents dead); two launches must agree bit for bit."""
    from freud_tpu_torch import flops
    from freud_tpu_torch.ops.topk_fused import topk_sae_forward, topk_sae_forward_plain
    from freud_tpu_torch.ops.topk_threshold import topk_thresholds_fired_plain

    gen = torch.Generator().manual_seed(SEED + 2)
    record = None
    for m, d_in, n_dict, k_aux in ((M_ROWS, D_IN, N_DICT, K_AUX), (77, D_IN, N_DICT, K_AUX),
                                   (3000, LARGE_D, LARGE_N_DICT, LARGE_K_AUX)):
        x, w_enc, b_enc, b_dec, w_dec = _topk_inputs(torch, device, m, gen, d_in, n_dict)
        third = (torch.rand((n_dict,), generator=gen) < 1 / 3).to(device)
        few = torch.zeros((n_dict,), dtype=torch.bool, device=device)
        few[:100] = True  # fewer dead than k_aux: select all dead
        if m == M_ROWS:
            cases = {"a third dead": third, "none dead": torch.zeros_like(third),
                     "100 dead": few}
        elif d_in == LARGE_D:
            cases = {"94% dead": (torch.rand((n_dict,), generator=gen) < 0.94).to(device)}
        else:
            cases = {"a third dead": third}
        for name, dead in cases.items():
            dead_f = dead.float()
            args = (x, w_enc.T, b_enc, b_dec, w_dec, dead_f, K, k_aux)
            got = topk_sae_forward(*args)
            again = topk_sae_forward(*args)
            want = topk_sae_forward_plain(*args)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, again)), name  # bit for bit
            acts = got[0]
            share, max_ulp = _acts_agreement(acts, want[0], x, w_enc, b_dec)
            # selection on the kernel's own acts: bit-equal
            tm, ta, _, fired = topk_thresholds_fired_plain(acts, dead, K, k_aux)
            assert torch.equal(got[3], tm) and torch.equal(got[4], ta), name
            assert torch.equal(got[5], fired), name
            af = acts.float()
            w = w_dec.to(torch.bfloat16).float()
            y_main = torch.where(af >= tm, af, 0.0) @ w
            y_aux = torch.where((af >= ta) & dead, af, 0.0) @ w
            abs_err = max((got[1] - y_main).abs().max().item(),
                          (got[2] - y_aux).abs().max().item())
            err = abs_err / max(y_main.abs().max().item(), y_aux.abs().max().item())
            print(f"topk_sae_forward m={m} d_in={d_in} n_dict={n_dict} ({name}): acts "
                  f"differ on {share:.2e} (bound 1e-3), by at most {max_ulp:.3f} ulp "
                  "(bound 1), thresholds/fired bit-equal, two launches bit-equal, "
                  f"decode max|Δ|/max|plain| {err:.3e} (bound 1e-3)")
            assert max_ulp <= 1 and share < 1e-3, (share, max_ulp)
            assert err < 1e-3, err
            assert torch.isinf(got[4]).all() if name == "none dead" else True
            assert (got[3][7] == 0).all() and not got[1][7].any()  # silent row
            # bf16 rounding makes ties at the k-th value common: rows with
            # a positive threshold that select more than k latents
            ties = (((af >= tm).sum(dim=1) > K) & (tm[:, 0] > 0)).sum().item()
            print(f"  rows with a tie at t_main: {ties} of {m}")
            assert m < 3000 or ties > 0
            if name in ("a third dead", "94% dead") and m >= 3000:
                selected = _selected(af, tm, ta, dead)
        if m == M_ROWS:
            args = (x, w_enc.T, b_enc, b_dec, w_dec, third.float(), K, K_AUX)
            ms = cuda_ms(lambda: topk_sae_forward(*args), reps=10)
            plain_ms = cuda_ms(lambda: topk_sae_forward_plain(*args), warmup=1, reps=5)
            bound = flops.topk_sae_forward_bound(m, d_in, n_dict, K, K_AUX, selected)
            print(f"topk_sae_forward m={m} d_in={d_in} n_dict={n_dict}: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound.bound_ms:.4f} ms "
                  f"({bound.bound_by}; {selected} selected entries) on {card}")
            record = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, **yardsticks(
                bound, None, "none: no one PyTorch call encodes, selects per row "
                "and decodes both masks"))
            # the select launch alone, by its profiler name
            sel_ms = profiled_ms(torch, lambda: topk_sae_forward(*args), "select_rows")
            sel_bound = flops.topk_select_bound(m, n_dict)
            assert sel_ms >= sel_bound.bound_ms, (sel_ms, sel_bound.bound_ms)
            record.update(select_ms=sel_ms, select_bound_ms=sel_bound.bound_ms)
            print(f"topk_sae_forward m={m} n_dict={n_dict}: select launch {sel_ms:.4f} ms, "
                  f"bound {sel_bound.bound_ms:.4f} ms on {card}")
        if d_in == LARGE_D:  # time large_v1_audioset's step shape, 48,000 rows
            x = torch.cat([x] * (LARGE_M_ROWS // m))
            largs = (x, w_enc.T, b_enc, b_dec, w_dec, dead_f, K, k_aux)
            large_ms = cuda_ms(lambda: topk_sae_forward(*largs), warmup=2, reps=5)
            bound = flops.topk_sae_forward_bound(LARGE_M_ROWS, d_in, n_dict, K, k_aux,
                                                 selected * (LARGE_M_ROWS // m))
            print(f"topk_sae_forward m={LARGE_M_ROWS} d_in={d_in} n_dict={n_dict}: "
                  f"kernel {large_ms:.4f} ms, bound {bound.bound_ms:.4f} ms "
                  f"({bound.bound_by}) on {card}")
            record.update(large_ms=large_ms, large_bound_ms=bound.bound_ms)
            sel_ms = profiled_ms(torch, lambda: topk_sae_forward(*largs), "select_rows")
            sel_bound = flops.topk_select_bound(LARGE_M_ROWS, n_dict)
            assert sel_ms >= sel_bound.bound_ms, (sel_ms, sel_bound.bound_ms)
            # what the launch computes, in plain PyTorch, on the kernel's acts;
            # torch.topk(acts, k) gives t_main only
            acts = topk_sae_forward(*largs)[0]
            sel_plain_ms = cuda_ms(lambda: topk_thresholds_fired_plain(acts, dead, K, k_aux),
                                   warmup=1, reps=3)
            sel_partial_ms = cuda_ms(lambda: torch.topk(acts, K, dim=1), reps=5)
            record.update(select_large_ms=sel_ms, select_large_bound_ms=sel_bound.bound_ms,
                          select_large_plain_ms=sel_plain_ms,
                          select_large_library_partial_ms=sel_partial_ms)
            print(f"topk_sae_forward m={LARGE_M_ROWS} n_dict={n_dict}: select launch "
                  f"{sel_ms:.4f} ms, plain selection {sel_plain_ms:.4f} ms, torch.topk(k) "
                  f"{sel_partial_ms:.4f} ms (t_main only), bound {sel_bound.bound_ms:.4f} ms "
                  f"on {card}")
            del x, largs
        del got, again, want, acts, af
    torch.cuda.empty_cache()
    return record


def _threshold_err(got, want) -> float:
    """Largest |Δ| over the finite thresholds and the fired mask."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        if w is not None:
            g, w = g.float(), w.float()
            fin = torch.isfinite(w)
            err = max(err, (g - w).abs()[fin].max().item() if fin.any() else 0.0)
    return err


def profiled_ms(torch, fn, name: str, reps: int = 3) -> float:
    """Device ms a call of the kernels whose profiler name holds ``name``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if name in e.key) / 1e3 / reps


def _threshold_edges(torch, device, gen, a, dead):
    """Kernel #3's edge cases for the selection core: (name, acts, dead,
    keyword arguments)."""
    inf_rows = a[:3000].clone()
    inf_rows[4:8] = float("-inf")
    inf_rows[8, 5:] = float("-inf")
    wide = torch.relu(torch.randn((3000, LARGE_N_DICT), generator=gen)).to(device)
    widest = torch.relu(torch.randn((500, 2 ** 15 + 8), generator=gen)).to(device)
    none = torch.zeros_like(dead)
    kw = dict(k_multi=4 * K)
    return [
        ("bf16 n 6143 (not a multiple of 8: rows load without the ring)",
         a[:3000, :6143].to(torch.bfloat16).contiguous(), dead[:6143], kw),
        ("f32 n 6141", a[:3000, :6141].contiguous(), dead[:6141], kw),
        ("bf16 n 20480 (exact path at large_v1_audioset's width, 94% dead)",
         wide.to(torch.bfloat16),
         (torch.rand((LARGE_N_DICT,), generator=gen) < 0.94).to(device), kw),
        ("bf16 n 32776 (float path: n_dict >= 2^15)", widest.to(torch.bfloat16),
         (torch.rand((2 ** 15 + 8,), generator=gen) < 1 / 3).to(device), kw),
        ("bf16 M 1", a[:1].to(torch.bfloat16), dead, kw),
        ("f32 M 1", a[:1].contiguous(), dead, kw),
        ("f32 M 1237 (not a multiple of the grid)", a[:1237].contiguous(), dead, kw),
        ("f32 rows all -inf, none dead", inf_rows, none, kw),
        ("bf16 signed rows all -inf, none dead", inf_rows.to(torch.bfloat16), none,
         dict(kw, signed=True)),
    ]


def check_topk_threshold(torch, device, card):
    """Kernel #3 against its plain version: thresholds and fired bit-equal,
    two launches bit-equal, bf16 (exact path, k_multi 128) and f32 / signed
    (float path) at the main shape, then the selection core's edges: widths
    that are not a multiple of 8, n_dict 20,480 on the exact path and
    2^15 + 8 on the float path, one row, a row count that is not a multiple
    of the grid, rows all -inf with no dead column. Timed in bf16 and in
    f32, each beside its bound; torch.topk(acts, k_multi) is timed as a
    partial yardstick (it gives t_main and t_multi, not t_aux or fired)."""
    from freud_tpu_torch import flops
    from freud_tpu_torch.ops.topk_threshold import (
        topk_thresholds_fired,
        topk_thresholds_fired_plain,
    )

    gen = torch.Generator().manual_seed(SEED + 3)
    a = torch.relu(torch.randn((M_ROWS, N_DICT), generator=gen)).to(device)
    a[5] = 0.0  # silent row
    a[6] = 0.5  # one tie across the row
    dead = (torch.rand((N_DICT,), generator=gen) < 1 / 3).to(device)
    record = {}
    cases = [("bf16", a.to(torch.bfloat16), dict(k_multi=4 * K)),
             ("f32", a, dict(k_multi=4 * K)),
             ("bf16 signed", (a - 0.5).to(torch.bfloat16), dict(signed=True))]
    checks = [(f"{name} ({dname})", acts, dm, kw)
              for name, acts, kw in cases
              for dname, dm in (("a third dead", dead), ("none dead", torch.zeros_like(dead)))]
    checks += _threshold_edges(torch, device, gen, a, dead)
    err = 0.0
    for name, acts, dm, kw in checks:
        got = topk_thresholds_fired(acts, dm, K, K_AUX, **kw)
        again = topk_thresholds_fired(acts, dm, K, K_AUX, **kw)
        want = topk_thresholds_fired_plain(acts, dm, K, K_AUX, **kw)
        torch.cuda.synchronize()
        for g, g2, w in zip(got, again, want):
            assert (g is None and w is None) or (torch.equal(g, w) and torch.equal(g, g2)), name
        if acts.shape == (M_ROWS, N_DICT):
            err = max(err, _threshold_err(got, want))
        print(f"topk_thresholds_fired {name} {tuple(acts.shape)}: thresholds and fired "
              "bit-equal to plain, two launches bit-equal")
    bf16, kw = cases[0][1], cases[0][2]
    ms = cuda_ms(lambda: topk_thresholds_fired(bf16, dead, K, K_AUX, **kw), reps=10)
    plain_ms = cuda_ms(lambda: topk_thresholds_fired_plain(bf16, dead, K, K_AUX, **kw),
                       warmup=1, reps=5)
    partial_ms = cuda_ms(lambda: torch.topk(bf16, 4 * K, dim=1), reps=10)
    bound = flops.topk_thresholds_bound(M_ROWS, N_DICT)
    record.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, **yardsticks(
        bound, None, "none: torch.topk gives t_main and t_multi only; t_aux and "
        "fired are further calls"), library_partial_ms=partial_ms,
        library_partial="torch.topk(acts, k_multi) on the bf16 acts: t_main and "
        "t_multi only, not the function")
    print(f"topk_thresholds_fired bf16 m={M_ROWS} n_dict={N_DICT}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.topk(k_multi) {partial_ms:.4f} ms "
          f"(partial), bound {bound.bound_ms:.4f} ms ({bound.bound_by}) on {card}")
    f32_ms = cuda_ms(lambda: topk_thresholds_fired(a, dead, K, K_AUX, **kw), reps=10)
    f32_plain_ms = cuda_ms(lambda: topk_thresholds_fired_plain(a, dead, K, K_AUX, **kw),
                           warmup=1, reps=3)
    f32_bound = flops.topk_thresholds_bound(M_ROWS, N_DICT, in_bytes=4)
    assert f32_ms >= f32_bound.bound_ms, (f32_ms, f32_bound.bound_ms)
    record.update(f32_ms=f32_ms, f32_plain_ms=f32_plain_ms, f32_bound_ms=f32_bound.bound_ms)
    print(f"topk_thresholds_fired f32 m={M_ROWS} n_dict={N_DICT}: kernel {f32_ms:.4f} ms, "
          f"plain {f32_plain_ms:.4f} ms, bound {f32_bound.bound_ms:.4f} ms "
          f"({f32_bound.bound_by}) on {card}")
    del a, cases, checks
    torch.cuda.empty_cache()
    return record


# the TopK backward's passes: (label, rows, width, dtype, dead share, k_aux,
# timed); the label prefixes the record's keys ("" the main shape)
BACKWARD_SHAPES = (
    ("", M_ROWS, N_DICT, "bfloat16", 1 / 3, K_AUX, True),
    ("none_dead_", 3001, N_DICT, "bfloat16", 0.0, K_AUX, False),
    ("all_dead_", 3001, N_DICT, "bfloat16", 1.0, K_AUX, False),
    ("f32_", M_ROWS, N_DICT, "float32", 1 / 3, K_AUX, True),
    ("large_", LARGE_M_ROWS, LARGE_N_DICT, "bfloat16", 0.94, LARGE_K_AUX, True),
    # a large_v1_audioset dictionary split in two: one rank's columns
    ("shard_", LARGE_M_ROWS, LARGE_N_DICT // 2, "bfloat16", 0.94, LARGE_K_AUX, True),
    ("shard_f32_", 5000, LARGE_N_DICT // 2, "float32", 0.94, LARGE_K_AUX, False),
)


def _backward_operands(torch, device, gen, m, n, dtype, dead_share, k_aux):
    """acts, t_main, t_aux, dead_f and [d1; d2] as the TopK backward sees
    them: relu'd normal acts with a silent row (t_main 0) and a row tied
    across (ties kept), kernel #3's thresholds at k and ``k_aux`` (a row
    without a dead latent: t_aux +inf), [d1; d2] normal with negative
    zeros."""
    from freud_tpu_torch.ops.topk_threshold import topk_thresholds_fired

    acts = torch.relu(torch.randn((m, n), generator=gen, device=device)).to(dtype)
    acts[1] = 0.0
    acts[2] = 0.25
    dead = torch.rand((n,), generator=gen, device=device) < dead_share
    t_main, t_aux = topk_thresholds_fired(acts, dead, K, k_aux)[:2]
    d = torch.randn((2 * m, n), generator=gen, device=device).to(dtype)
    d[::3, ::5] = -0.0
    return acts, t_main, t_aux, dead.float(), d


def check_topk_backward(torch, device, card) -> dict:
    """The TopK backward's two passes (``csrc/topk_backward.cu``) against
    their plain versions at the training paths' shapes: tiny_topk's (75,000
    × 6,144) in bf16 and f32 (the f32 route), none and every latent dead,
    large_v1_audioset's (48,000 × 20,480, 94% dead) and one rank's columns
    of its dictionary split in two (10,240) in bf16 and f32. The masked
    pair and d_acts bit for bit, two launches bit-equal; db_enc within the
    f32 rounding bound of its two-level sum (each row group's sum, then the
    groups in order) of the exact column sum. Each timed beside its bytes
    bound and its plain version. → {wrapper: record}."""
    from freud_tpu_torch import flops
    from freud_tpu_torch.ops.topk_backward import (
        GROUP_ROWS,
        topk_masked_pair,
        topk_masked_pair_plain,
        topk_route,
        topk_route_plain,
    )

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    gen = torch.Generator(device).manual_seed(SEED + 19)
    none = "none: the plain version's compares, wheres and {} are the PyTorch calls"
    recs = {"topk_masked_pair": dict(max_abs_err=0.0, **yardsticks(
                flops.topk_bwd_pair_bound(M_ROWS, N_DICT), None, none.format("cat"))),
            "topk_route": dict(max_abs_err=0.0, **yardsticks(
                flops.topk_bwd_route_bound(M_ROWS, N_DICT), None, none.format("sum")))}
    for label, m, n, dname, dead_share, k_aux, timed in BACKWARD_SHAPES:
        dtype = getattr(torch, dname)
        acts, t_main, t_aux, dead_f, d = _backward_operands(
            torch, device, gen, m, n, dtype, dead_share, k_aux)
        masks = (acts, t_main, t_aux, dead_f)
        pair, again = topk_masked_pair(*masks), topk_masked_pair(*masks)
        want = topk_masked_pair_plain(*masks)
        torch.cuda.synchronize()
        assert torch.equal(bits(pair), bits(want)), label
        assert torch.equal(bits(again), bits(pair)), label
        assert bool(pair[m:].any()) == (dead_share > 0), label
        del pair, again, want
        (d_acts, db), (d_again, db_again) = topk_route(d, *masks), topk_route(d, *masks)
        want, want_db = topk_route_plain(d, *masks)
        torch.cuda.synchronize()
        assert torch.equal(bits(d_acts), bits(want)), label
        assert torch.equal(bits(d_again), bits(d_acts)), label
        assert torch.equal(bits(db_again), bits(db)), label
        exact = torch.sum(want, dim=0, dtype=torch.float64)
        bound = ((GROUP_ROWS + -(-m // GROUP_ROWS)) * 2.0 ** -24
                 * torch.sum(want.abs(), dim=0, dtype=torch.float64))
        ratio = float(((db.double() - exact).abs() / bound.clamp(min=1e-300)).max())
        assert ratio <= 1.0 and d_acts.any(), (label, ratio)
        recs["topk_route"][f"{label}db_enc_bound_ratio"] = ratio
        print(f"topk backward {label or 'main_'}({m}, {n}) {dname}, {dead_share:.2f} dead: "
              f"masked pair and d_acts bit-equal to plain, two launches bit-equal; db_enc "
              f"{ratio:.3f} of its f32 rounding bound (plain sum "
              f"{float((want_db.double() - exact).abs().max()):.3e} from exact)")
        del d_acts, d_again, want, want_db, exact, bound
        if timed:
            in_bytes = torch.finfo(dtype).bits // 8
            for name, fn, plain, bound in (
                    ("topk_masked_pair", lambda: topk_masked_pair(*masks),
                     lambda: topk_masked_pair_plain(*masks),
                     flops.topk_bwd_pair_bound(m, n, in_bytes)),
                    ("topk_route", lambda: topk_route(d, *masks),
                     lambda: topk_route_plain(d, *masks),
                     flops.topk_bwd_route_bound(m, n, in_bytes))):
                ms = cuda_ms(fn, reps=10)
                plain_ms = cuda_ms(plain, warmup=1, reps=3)
                assert ms >= bound.bound_ms, (name, label, ms, bound.bound_ms)
                recs[name].update({f"{label}ms": ms, f"{label}plain_ms": plain_ms,
                                   f"{label}bound_ms": bound.bound_ms})
                print(f"{name} ({m}, {n}) {dname}: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, bound {bound.bound_ms:.4f} ms ({bound.bound_by}; "
                      f"{bound.bytes / 1e9:.2f} GB) on {card}")
        del acts, t_main, t_aux, dead_f, d, masks
        torch.cuda.empty_cache()
    return recs


# the SAE encode's indexed top-k at the main path's f32 shapes, each with
# the encode's fused bias: (label, rows, columns) — one /top_features
# request, a large_v1_audioset collection batch, a uni_moe_omni batch (two
# column segments and a merge)
INDEXED_SHAPES = (("serve_", 1500, 20480), ("", 32 * 1500, 20480), ("omni_", 6400, 57344))


def check_topk_indexed(torch, device, card) -> dict:
    """The SAE encode's selection (``ops/topk_indexed``) at
    ``INDEXED_SHAPES``: bit for bit the sort it replaced (``pre_acts``'s add
    and ReLU, then a stable descending ``torch.sort`` cut to k) on products
    with zero-padded tail rows, silent rows, -0.0 and a row of exact ties,
    one launch a call; timed beside that chain and its bytes bound."""
    from freud_tpu_torch import flops
    from freud_tpu_torch.ops.topk_indexed import topk_indexed, topk_indexed_plain

    gen = torch.Generator(device).manual_seed(SEED + 23)
    rec = {"library": "the replaced chain: add, relu, torch.sort (stable), [..., :k]"}
    for label, m, n in INDEXED_SHAPES:
        z = torch.randn((m, n), generator=gen, device=device) * 0.3 - 0.2
        b = torch.randn((n,), generator=gen, device=device) * 0.05
        z[-7:] = 0.0  # zero-padded tail rows: the bias alone, fewer than k positive
        z[0] = -10.0  # silent: every latent 0
        z[1] = -0.0
        z[2] = 0.5 - b  # every latent tied at 0.5 (up to rounding)
        before = topk_indexed.launches
        got = topk_indexed(z, K, bias=b)
        want = topk_indexed_plain(z, K, bias=b)
        torch.cuda.synchronize()
        assert topk_indexed.launches == before + 1, label
        assert torch.equal(got[1], want[1]), label
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)), label
        bound = flops.topk_indexed_bound(m, n, K, bias=True)
        ms = cuda_ms(lambda: topk_indexed(z, K, bias=b), reps=10)
        chain_ms = cuda_ms(lambda: topk_indexed_plain(z, K, bias=b), warmup=1, reps=3)
        assert ms >= bound.bound_ms, (label, ms, bound.bound_ms)
        rec.update({f"{label}ms": ms, f"{label}plain_ms": chain_ms, f"{label}library_ms": chain_ms,
                    f"{label}bound_ms": bound.bound_ms})
        print(f"topk_indexed ({m}, {n}) f32, k {K}, fused bias: bit-equal to the sort; kernel "
              f"{ms:.4f} ms, add+relu+sort {chain_ms:.4f} ms, bound {bound.bound_ms:.4f} ms "
              f"({bound.bound_by}; {bound.bytes / 1e9:.2f} GB) on {card}")
        del z, b, got, want
        torch.cuda.empty_cache()
    rec["bound_by"] = "bytes"
    return rec


# the collect cells' f32 products: (label, M, K, N, bias) of large
# collection's q/k/v/out, mlp.0 and mlp.2 at batch 32, its SAE encode
# (n_dict 20,480), and the omni cell's SAE encode (32 × 200 positions of
# d 3,584, n_dict 57,344)
GEMM_SHAPES = (("", 32 * 1500, 1280, 1280, True), ("mlp0_", 32 * 1500, 1280, 5120, True),
               ("mlp2_", 32 * 1500, 5120, 1280, True),
               ("sae_", 32 * 1500, 1280, 20480, False),
               ("omni_sae_", 32 * 200, 3584, 57344, False))
GEMM_REF_ROWS = 4096  # rows of the float64 reference built at a time


def gemm_errors(torch, x, w, b, outs) -> list:
    """Each of ``outs``' largest error against the float64 product of
    x · wᵀ (+ b), over every row, divided by the product's RMS; the
    reference is built ``GEMM_REF_ROWS`` rows at a time."""
    wd = w.double()
    bd = b.double() if b is not None else 0.0
    worst, sq = [0.0] * len(outs), 0.0
    for r0 in range(0, x.shape[0], GEMM_REF_ROWS):
        rows = slice(r0, r0 + GEMM_REF_ROWS)
        ref = x[rows].double() @ wd.T + bd
        sq += ref.pow(2).sum().item()
        for i, y in enumerate(outs):
            worst[i] = max(worst[i], (y[rows].double() - ref).abs().max().item())
        del ref
    rms = (sq / (x.shape[0] * w.shape[0])) ** 0.5
    return [v / rms for v in worst]


def check_gemm_f32x3(torch, device, card) -> dict:
    """The 3xTF32 product (``ops/gemm_f32x3``) at ``GEMM_SHAPES``: its
    largest error over every row against a float64 product, over the
    output's RMS, at most 2× cuBLAS f32's (TF32 off) and 30× under one TF32
    product's; two launches bit-equal, one launch a call; timed beside
    cuBLAS f32 (``F.linear``, the library call it replaces) and its bound.
    The plain recipe's error is read on the first ``GEMM_REF_ROWS`` rows."""
    from freud_tpu_torch import flops
    from freud_tpu_torch.ops.gemm_f32x3 import gemm_f32x3, gemm_f32x3_plain

    F = torch.nn.functional
    gen = torch.Generator(device).manual_seed(SEED + 29)
    rec = {"library": "F.linear in f32, TF32 off (cuBLAS)"}

    for label, m, k, n, bias in GEMM_SHAPES:
        x = torch.randn((m, k), generator=gen, device=device)
        w = (torch.rand((n, k), generator=gen, device=device) * 2 - 1) / k ** 0.5
        b = torch.randn((n,), generator=gen, device=device) * 0.1 if bias else None
        with torch.no_grad():
            before = gemm_f32x3.launches
            got = gemm_f32x3(x, w, b)
            again = gemm_f32x3(x, w, b)
            torch.cuda.synchronize()
            assert gemm_f32x3.launches == before + 2, label
            assert torch.equal(got, again), label
            del again
            lib = F.linear(x, w, b)
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = F.linear(x, w, b)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            e_kernel, e_cublas, e_tf32 = gemm_errors(torch, x, w, b, [got, lib, tf32])
            del lib, tf32
            xs = x[:GEMM_REF_ROWS]
            e_plain = gemm_errors(torch, xs, w, b, [gemm_f32x3_plain(xs, w, b)])[0]
            assert e_kernel <= 2 * e_cublas and 30 * e_kernel <= e_tf32, (
                label, e_kernel, e_cublas, e_tf32)
            bound = flops.gemm_f32x3_bound(m, k, n, bias=bias)
            ms = cuda_ms(lambda: gemm_f32x3(x, w, b), reps=10)
            lib_ms = cuda_ms(lambda: F.linear(x, w, b), warmup=1, reps=5)
        assert ms >= bound.bound_ms, (label, ms, bound.bound_ms)
        rec.update({f"{label}ms": ms, f"{label}library_ms": lib_ms,
                    f"{label}bound_ms": bound.bound_ms, f"{label}err": e_kernel,
                    f"{label}cublas_err": e_cublas, f"{label}tf32_err": e_tf32,
                    f"{label}plain_err": e_plain})
        print(f"gemm_f32x3 ({m}, {k}) x ({n}, {k})ᵀ f32: err/rms over every row {e_kernel:.3g} "
              f"(cuBLAS f32 {e_cublas:.3g}, TF32 {e_tf32:.3g}; the plain recipe on the first "
              f"{GEMM_REF_ROWS} rows {e_plain:.3g}); kernel {ms:.4f} ms, cuBLAS f32 "
              f"{lib_ms:.4f} ms, bound {bound.bound_ms:.4f} ms ({bound.bound_by}) on {card}")
        del x, w, b, got
        torch.cuda.empty_cache()
    rec["plain_ms"] = None  # the plain recipe repeats the products in f32: no yardstick
    rec["bound_by"] = "operations"
    return rec


# Uni-MoE-2.0-Omni's MoE at the collection cell's shapes: 32 clips of 232
# positions, d 3584, 4 dynamic experts of width 18,944 and a null one, top 2
MOE_TOKENS, MOE_D, MOE_WIDTH, MOE_DYN, MOE_TOP_K = 32 * 232, 3584, 18944, 4, 2
MOE_RAGGED_TOKENS = 1037


def check_moe(torch, device, card) -> dict:
    """The MoE's kernels (``csrc/moe.cu``) against their plain versions at
    the omni cell's shapes, at routing drawn as the benchmark draws it,
    skewed (every token on expert 0 alone; every token on experts 0 and 1,
    none on 2 and 3) and at a ragged token count: the router's probabilities
    within 1e-5, its selection equal away from the decisions, plan, permute
    and combine bit for bit, the grouped products within 1e-2 of the plain
    products' largest value. Each timed at the drawn routing beside its
    bound. → {kernel: record}."""
    from freud_tpu_torch import flops
    from freud_tpu_torch.ops import moe

    gen = torch.Generator(device).manual_seed(SEED + 29)

    def uniform(*shape, fan):
        return ((torch.rand(shape, generator=gen, device=device) * 2 - 1)
                / fan ** 0.5).bfloat16()

    w_gate = uniform(MOE_DYN, MOE_WIDTH, MOE_D, fan=MOE_D)
    w_up = uniform(MOE_DYN, MOE_WIDTH, MOE_D, fan=MOE_D)
    w_down = uniform(MOE_DYN, MOE_D, MOE_WIDTH, fan=MOE_WIDTH)
    w_router = torch.randn(MOE_DYN + 1, MOE_D, generator=gen, device=device) * 1.5 / MOE_D ** 0.5
    recs = {}
    for label, tokens, skew in (("", MOE_TOKENS, None), ("one_", MOE_TOKENS, "one"),
                                ("pair_", MOE_TOKENS, "pair"),
                                ("ragged_", MOE_RAGGED_TOKENS, None)):
        u = torch.randn(tokens, MOE_D, generator=gen, device=device).bfloat16()
        probs, sel, wsel = moe.route(u, w_router, 0.7, MOE_TOP_K)
        p_probs, p_sel, p_wsel = moe.route_plain(u, w_router, 0.7, MOE_TOP_K)
        ps = torch.sort(p_probs, dim=-1, descending=True).values
        clear = ((ps[:, :-1] - ps[:, 1:]).min(1).values > 1e-5) & ((ps[:, 0] - 0.7).abs() > 1e-5)
        route_err = float((probs - p_probs).abs().max())
        assert route_err <= 1e-5 and torch.equal(sel[clear], p_sel[clear]), (label, route_err)
        if skew == "one":
            sel = torch.tensor([0, -1], dtype=torch.int32, device=device).repeat(tokens, 1)
        elif skew == "pair":
            sel = torch.tensor([1, 0], dtype=torch.int32, device=device).repeat(tokens, 1)
        counts = torch.zeros(MOE_DYN + 1, dtype=torch.int32, device=device)
        p_counts = counts.clone()
        offsets, pos = moe.plan(sel, MOE_DYN, counts)
        p_offsets, p_pos = moe.plan_plain(sel, MOE_DYN, p_counts)
        assert torch.equal(counts, p_counts) and torch.equal(offsets, p_offsets), label
        assert torch.equal(pos, p_pos), label
        routed = int(counts[:MOE_DYN].sum())
        rows_max = tokens * MOE_TOP_K
        a = moe.permute(u, pos, rows_max)
        assert torch.equal(a[:routed], moe.permute_plain(u, pos, rows_max)[:routed]), label
        h = moe.gateup(a, counts, offsets, w_gate, w_up)
        p_h = moe.gateup_plain(a, counts, offsets, w_gate, w_up)
        gateup_err = float((h[:routed].float() - p_h[:routed].float()).abs().max()
                           / p_h[:routed].float().abs().max())
        y = moe.down(p_h, counts, offsets, w_down)
        p_y = moe.down_plain(p_h, counts, offsets, w_down)
        down_err = float((y[:routed].float() - p_y[:routed].float()).abs().max()
                         / p_y[:routed].float().abs().max())
        fixed = torch.randn(tokens, MOE_D, generator=gen, device=device).bfloat16()
        out = moe.combine(u, fixed, p_y, pos, wsel)
        combine_eq = torch.equal(out.view(torch.int16),
                                 moe.combine_plain(u, fixed, p_y, pos, wsel).view(torch.int16))
        print(f"moe {label or 'drawn_'}({tokens} tokens, {routed} rows, counts "
              f"{counts.tolist()}): route {route_err:.2e} from plain, plan and permute "
              f"bit-equal, gate/up {gateup_err:.2e} and down {down_err:.2e} of max from "
              f"plain, combine bit-equal {combine_eq}")
        assert gateup_err <= 1e-2 and down_err <= 1e-2 and combine_eq, label
        recs[f"{label}errors"] = {"route": route_err, "gateup": gateup_err, "down": down_err,
                                  "rows": routed, "counts": counts.tolist()}
        if label == "":
            bounds = {"moe_gateup": flops.moe_gateup_bound(routed, MOE_D, MOE_WIDTH, MOE_DYN),
                      "moe_down": flops.moe_down_bound(routed, MOE_D, MOE_WIDTH, MOE_DYN),
                      "moe_route+plan+permute+combine": flops.moe_route_bound(
                          tokens, MOE_D, MOE_DYN + 1, MOE_TOP_K, routed)}
            timed = {
                "moe_gateup": (lambda: moe.gateup(a, counts, offsets, w_gate, w_up),
                               lambda: moe.gateup_plain(a, counts, offsets, w_gate, w_up)),
                "moe_down": (lambda: moe.down(p_h, counts, offsets, w_down),
                             lambda: moe.down_plain(p_h, counts, offsets, w_down)),
                "moe_route+plan+permute+combine": (
                    lambda: (moe.route(u, w_router, 0.7, MOE_TOP_K),
                             moe.plan(sel, MOE_DYN, counts),
                             moe.permute(u, pos, rows_max),
                             moe.combine(u, fixed, p_y, pos, wsel)),
                    lambda: (moe.route_plain(u, w_router, 0.7, MOE_TOP_K),
                             moe.plan_plain(sel, MOE_DYN, p_counts),
                             moe.permute_plain(u, pos, rows_max),
                             moe.combine_plain(u, fixed, p_y, pos, wsel)))}
            for name, (fn, plain) in timed.items():
                ms, plain_ms = cuda_ms(fn, reps=10), cuda_ms(plain, warmup=1, reps=3)
                b = bounds[name]
                recs[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b.bound_ms,
                              "bound_by": b.bound_by, "roofline_pct": 100 * b.bound_ms / ms}
                print(f"{name} ({routed} rows): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                      f"bound {b.bound_ms:.4f} ms ({b.bound_by}), "
                      f"{100 * b.bound_ms / ms:.1f}% of it on {card}")
        del u, a, h, p_h, y, p_y, fixed, out
        torch.cuda.empty_cache()
    return recs


OMNI_CONFIG = REPO / "portbench" / "configs" / "uni_moe_omni.json"
OMNI_TAP, OMNI_CLIPS = "lm.layers.20", 2


def check_omni_forward(torch, device, card) -> dict:
    """One capture at ``lm.layers.20`` of the benchmark's Uni-MoE-2.0-Omni
    (its published widths, 21 LM layers, weights drawn on the card by the
    benchmark's seed rule with plain random routers) through
    ``OmniRuntime``, after a warm one: each MoE wrapper launches its kernel
    once a layer (21), none falls back to its plain version, and nothing
    synchronises with the host; every layer's router takes each token once
    or twice. → {"launches": {wrapper: n}, "ms": the capture's wall}."""
    import math
    import zlib

    from freud_tpu_torch.models.omni import OmniRuntime
    from freud_tpu_torch.ops import moe
    from portbench import omni_data

    cfg = json.loads(OMNI_CONFIG.read_text())
    hf = omni_data.hf_config(cfg, omni_data.prompt_ids(SEED, cfg["vocab_size"], 24, 8))
    n_router = cfg["mlp_dynamic_expert_num"] + cfg["mlp_dynamic_null_expert_num"]
    gen = torch.Generator().manual_seed(SEED + 31)
    routers = [torch.randn(n_router, cfg["hidden_size"], generator=gen)
               * cfg["init"]["router_scale"] / math.sqrt(cfg["hidden_size"])
               for _ in range(cfg["num_hidden_layers"])]
    sd = omni_data.state_dict(lambda *parts: zlib.crc32(repr(parts).encode()), hf, device,
                              routers)
    rt = OmniRuntime("uni-moe-2.0-omni", OMNI_TAP, torch.bfloat16, device, weights=(hf, sd))
    del sd
    mels = torch.randn(OMNI_CLIPS, cfg["audio_tower"]["n_mels"], 3000, generator=gen).to(device)
    wrappers = (moe.route, moe.plan, moe.permute, moe.gateup, moe.down, moe.combine)
    rt.activations_with_lengths(mels)  # warm: cuBLAS and SDPA pick their kernels
    torch.cuda.synchronize()
    for fn in wrappers:
        fn.launches = 0
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        acts, _ = rt.activations_with_lengths(mels)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    layers = rt.counters().shape[0]
    tokens = OMNI_CLIPS * rt.cfg.seq_len
    taken = rt.counters().sum(1)
    print(f"omni forward ({OMNI_CLIPS} clips to {OMNI_TAP}, {layers} LM layers): launches "
          f"{launches}, router takes {taken.tolist()} of {tokens} tokens, {ms:.1f} ms "
          f"on {card}")
    assert all(n == layers == 21 for n in launches.values()), launches
    assert bool(((taken >= tokens) & (taken <= 2 * tokens)).all()), taken
    assert acts.shape == (OMNI_CLIPS, rt.cfg.query_tokens, cfg["hidden_size"])
    assert bool(torch.isfinite(acts.float()).all())
    del rt, acts
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": ms}


# LongCat-Flash-Omni's MoE at the collection cell's shapes: 32 clips of 407
# positions, d 6,144, a router of 512 routed experts and 256 identity entries,
# top 12 weighted ×6, this card's 16 held experts of width 2,048
LC_TOKENS, LC_D, LC_WIDTH, LC_TOP_K, LC_SCALE = 32 * 407, 6144, 2048, 12, 6.0
LC_ROUTED, LC_ROUTER, LC_HELD, LC_IDENT = 512, 768, (0, 16), (512, 768)
LC_RAGGED_TOKENS = 1037


def check_longcat_moe(torch, device, card) -> dict:
    """LongCat-Flash-Omni's MoE kernels (``csrc/moe.cu``: the biased top-k
    route, plan and the grouped products over a held range, combine with the
    identity range) against their plain versions at the LongCat cell's
    shapes: logits drawn at the router's scale (~200 rows a held expert),
    rows of tied logits, the held experts never chosen, twelve of them taking
    every token, the share [496, 512) and a ragged token count. The route's
    probabilities within 2e-7 of the plain version's, each relative to its
    value, and its selection, weights and classes bit-equal to the plain rule
    on the kernel's own probabilities (ties to the lower index); plan,
    permute and combine bit for bit; the grouped products within 1e-2 of the
    plain products' largest value. At the drawn routing each kernel is timed
    beside its plain version, the route and the products beside their bounds.
    → {kernel: record}."""
    from freud_tpu_torch import flops
    from freud_tpu_torch.ops import moe

    gen = torch.Generator(device).manual_seed(SEED + 37)

    def uniform(*shape, fan):
        return ((torch.rand(shape, generator=gen, device=device) * 2 - 1)
                / fan ** 0.5).bfloat16()

    n_held = LC_HELD[1] - LC_HELD[0]
    w_gate = uniform(n_held, LC_WIDTH, LC_D, fan=LC_D)
    w_up = uniform(n_held, LC_WIDTH, LC_D, fan=LC_D)
    w_down = uniform(n_held, LC_D, LC_WIDTH, fan=LC_WIDTH)
    recs = {}
    for label, tokens, case in (("", LC_TOKENS, None), ("ties_", LC_TOKENS, "ties"),
                                ("none_held_", LC_TOKENS, "none"),
                                ("twelve_", LC_TOKENS, "twelve"),
                                ("share_", LC_TOKENS, "share"),
                                ("ragged_", LC_RAGGED_TOKENS, None)):
        logits = torch.randn(tokens, LC_ROUTER, generator=gen, device=device) * 2.25
        bias = torch.randn(LC_ROUTER, generator=gen, device=device) * 1e-3
        held = (496, 512) if case == "share" else LC_HELD
        if case == "ties":  # equal logits in blocks of 4 entries, no bias
            logits = logits[:, ::4].repeat_interleave(4, dim=1).contiguous()
            bias = torch.zeros_like(bias)
        elif case == "none":
            bias[:n_held] = -1.0
        elif case == "twelve":
            bias[:LC_TOP_K] = 1.0
        probs, sel, wsel, cls = moe.route_topk(logits, bias, LC_TOP_K, LC_SCALE, held, LC_IDENT)
        p_probs, p_sel, _, _ = moe.route_topk_plain(logits, bias, LC_TOP_K, LC_SCALE, held,
                                                    LC_IDENT)
        route_err = float(((probs - p_probs).abs() / p_probs).max())
        rule = moe.select_topk(probs, bias, LC_TOP_K, LC_SCALE, held, LC_IDENT)
        rule_eq = all(torch.equal(g, w) for g, w in zip((sel, wsel, cls), rule))
        sel_diff = int((sel != p_sel).any(1).sum())
        assert route_err <= 2e-7 and rule_eq, (label, route_err, rule_eq)
        if case == "ties":  # a tie inside the top 12 went to the lower index
            assert bool((sel[:, 1:] > sel[:, :-1]).any()), label
        counts = torch.zeros(LC_ROUTER, dtype=torch.int32, device=device)
        p_counts = counts.clone()
        offsets, pos = moe.plan(sel, n_held, counts, held[0])
        p_offsets, p_pos = moe.plan_plain(sel, n_held, p_counts, held[0])
        assert torch.equal(counts, p_counts) and torch.equal(offsets, p_offsets), label
        assert torch.equal(pos, p_pos) and int(counts.sum()) == tokens * LC_TOP_K, label
        hc = counts[held[0]:held[1]]
        rows = int(hc.sum())
        active = int((hc > 0).sum())
        if case == "none":
            assert rows == 0, label
        elif case == "twelve":
            assert hc[:LC_TOP_K].tolist() == [tokens] * LC_TOP_K and rows == tokens * LC_TOP_K
        u = (torch.randn(tokens, LC_D, generator=gen, device=device) * 0.5).bfloat16()
        rows_max = tokens * LC_TOP_K
        a = moe.permute(u, pos, rows_max)
        assert torch.equal(a[:rows], moe.permute_plain(u, pos, rows_max)[:rows]), label
        h = moe.gateup(a, counts, offsets, w_gate, w_up, held[0])
        p_h = moe.gateup_plain(a, counts, offsets, w_gate, w_up, held[0])
        y = moe.down(p_h, counts, offsets, w_down, held[0])
        p_y = moe.down_plain(p_h, counts, offsets, w_down, held[0])
        gateup_err = down_err = 0.0
        if rows:
            gateup_err = float((h[:rows].float() - p_h[:rows].float()).abs().max()
                               / p_h[:rows].float().abs().max())
            down_err = float((y[:rows].float() - p_y[:rows].float()).abs().max()
                             / p_y[:rows].float().abs().max())
        x, fixed = u.flip(0).contiguous(), (u * 0.25).contiguous()
        out = moe.combine(x, fixed, p_y, pos, wsel, u, sel, LC_IDENT)
        combine_eq = torch.equal(out.view(torch.int16), moe.combine_plain(
            x, fixed, p_y, pos, wsel, u, sel, LC_IDENT).view(torch.int16))
        print(f"longcat moe {label or 'drawn_'}({tokens} tokens, held {held}, {rows} held rows "
              f"on {active} experts, {int(counts[LC_IDENT[0]:].sum())} identity slots): route "
              f"{route_err:.2e} of each p from plain, its rule bit-equal, {sel_diff} rows "
              f"select otherwise than the plain route; plan and permute bit-equal, gate/up "
              f"{gateup_err:.2e} and down {down_err:.2e} of max from plain, combine bit-equal "
              f"{combine_eq}")
        assert gateup_err <= 1e-2 and down_err <= 1e-2 and combine_eq, label
        recs[f"lc_{label}errors"] = {"route": route_err, "select_rows_otherwise": sel_diff,
                                     "gateup": gateup_err, "down": down_err, "rows": rows,
                                     "active": active}
        if label == "":
            gateup_b, down_b = flops.moe_held_bounds(rows, active, LC_D, LC_WIDTH)
            timed = {
                "moe_route_topk": (
                    lambda: moe.route_topk(logits, bias, LC_TOP_K, LC_SCALE, held, LC_IDENT),
                    lambda: moe.route_topk_plain(logits, bias, LC_TOP_K, LC_SCALE, held,
                                                 LC_IDENT),
                    flops.moe_route_topk_bound(tokens, LC_ROUTER, LC_TOP_K)),
                "moe_gateup_held": (
                    lambda: moe.gateup(a, counts, offsets, w_gate, w_up, held[0]),
                    lambda: moe.gateup_plain(a, counts, offsets, w_gate, w_up, held[0]),
                    gateup_b),
                "moe_down_held": (
                    lambda: moe.down(p_h, counts, offsets, w_down, held[0]),
                    lambda: moe.down_plain(p_h, counts, offsets, w_down, held[0]), down_b),
                "moe_plan+permute+combine_identity": (
                    lambda: (moe.plan(sel, n_held, counts, held[0]),
                             moe.permute(u, pos, rows_max),
                             moe.combine(x, fixed, p_y, pos, wsel, u, sel, LC_IDENT)),
                    lambda: (moe.plan_plain(sel, n_held, p_counts, held[0]),
                             moe.permute_plain(u, pos, rows_max),
                             moe.combine_plain(x, fixed, p_y, pos, wsel, u, sel, LC_IDENT)),
                    None)}
            for name, (fn, plain, b) in timed.items():
                ms, plain_ms = cuda_ms(fn, reps=10), cuda_ms(plain, warmup=1, reps=3)
                recs[name] = {"ms": ms, "plain_ms": plain_ms, "rows": rows}
                line = f"{name} ({tokens} tokens, {rows} held rows): kernel {ms:.4f} ms, " \
                       f"plain {plain_ms:.4f} ms"
                if b is not None:
                    recs[name].update(bound_ms=b.bound_ms, bound_by=b.bound_by,
                                      roofline_pct=100 * b.bound_ms / ms)
                    line += f", bound {b.bound_ms:.4f} ms ({b.bound_by}), " \
                            f"{100 * b.bound_ms / ms:.1f}% of it"
                print(f"{line} on {card}")
        del logits, probs, p_probs, u, a, h, p_h, y, p_y, x, fixed, out
        torch.cuda.empty_cache()
    return recs


LONGCAT_CONFIG = REPO / "portbench" / "configs" / "longcat_flash_omni.json"
LONGCAT_TAP, LONGCAT_CLIPS = "lm.layers.3", 2


def check_longcat_forward(torch, device, card) -> dict:
    """One capture at ``lm.layers.3`` of the benchmark's LongCat-Flash-Omni
    (its published widths and share, 4 double layers, weights drawn on the
    card by the benchmark's seed rule with plain random routers and no
    selection bias) through ``LongCatRuntime``, after a warm one, with the
    launch counts set to 0 just before it: the router's 3xTF32 product and
    each held-share MoE wrapper launch once a layer, Uni-MoE's route never,
    none falls back to its plain version, and nothing synchronises with the
    host; every layer's routes count 12 slots a token. → {"launches":
    {wrapper: n}, "held_rows": [a layer], "ms": the capture's wall}."""
    import math
    import zlib

    from freud_tpu_torch.models.longcat import LongCatRuntime
    from freud_tpu_torch.ops import gemm_f32x3, moe
    from portbench import longcat_data, omni_data

    cfg = json.loads(LONGCAT_CONFIG.read_text())
    hf = omni_data.hf_config(cfg, omni_data.prompt_ids(SEED, cfg["vocab_size"], 24, 8))
    layers = int(LONGCAT_TAP.split(".")[2]) + 1
    d = cfg["hidden_size"]
    n_router = cfg["deployment"]["n_routed_experts"] + cfg["zero_expert_num"]
    gen = torch.Generator().manual_seed(SEED + 41)
    routers = [(torch.randn(n_router, d, generator=gen) * cfg["init"]["router_scale"]
                / math.sqrt(d), torch.zeros(n_router)) for _ in range(layers)]
    sd = longcat_data.state_dict(lambda *parts: zlib.crc32(repr(parts).encode()),
                                 {**hf, "num_layers": layers}, device, routers)
    rt = LongCatRuntime("longcat-flash-omni", LONGCAT_TAP, torch.bfloat16, device,
                        weights=(hf, sd))
    del sd
    mels = torch.randn(LONGCAT_CLIPS, cfg["audio_tower"]["n_mels"], 3000,
                       generator=gen).to(device)
    wrappers = (gemm_f32x3.gemm_f32x3, moe.route_topk, moe.plan, moe.permute, moe.gateup,
                moe.down, moe.combine, moe.route)
    rt.activations_with_lengths(mels)  # warm: cuBLAS and SDPA pick their kernels
    torch.cuda.synchronize()
    for fn in wrappers:
        fn.launches = 0
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        acts, _ = rt.activations_with_lengths(mels)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    routes = rt.counters()
    tokens = LONGCAT_CLIPS * rt.cfg.seq_len
    lo, hi = rt.cfg.held
    held_rows = routes[:, lo:hi].sum(1).tolist()
    print(f"longcat forward ({LONGCAT_CLIPS} clips to {LONGCAT_TAP}, {routes.shape[0]} double "
          f"layers): launches {launches}, slots {routes.sum(1).tolist()} of {tokens} tokens, "
          f"held rows {held_rows}, {ms:.1f} ms on {card}")
    assert routes.shape == (layers, n_router), tuple(routes.shape)
    assert launches.pop("route") == 0, launches
    assert all(n == layers for n in launches.values()), launches
    assert routes.sum(1).tolist() == [tokens * cfg["moe_topk"]] * layers
    assert acts.shape == (LONGCAT_CLIPS, rt.cfg.query_tokens, d)
    assert bool(torch.isfinite(acts.float()).all())
    del rt, acts
    torch.cuda.empty_cache()
    return {"launches": launches, "held_rows": held_rows, "ms": ms}


def write_wavs(folder: Path, lengths: list[int], broken: bool = False,
               seed: int = SEED) -> list[tuple[str, int]]:
    """Seeded noise clips of ``lengths`` samples as 16-bit PCM WAV, plus
    one undecodable file when ``broken``; → [(path, n_samples)] of the
    decodable ones."""
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(lengths):
        audio = np.clip(rng.standard_normal(n) * 0.1, -1, 1)
        path = folder / f"clip{i:03d}.wav"
        with wave.open(str(path), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes((audio * 32767).astype(np.int16).tobytes())
        out.append((str(path), n))
    if broken:
        # one undecodable file: collection skips it (decode-degrade policy)
        (folder / "clip_broken.wav").write_bytes(b"RIFF, but not a wav file")
    return out


def run_cli(module: str, config: dict, cfg_path: Path) -> dict:
    """``python -m <module> --config <cfg_path>``, in this process (so the
    launch counters are readable). → the JSON stats of its last line."""
    from freud_tpu_torch import profiling

    profiling.reset()  # one stage table per run
    cfg_path.write_text(json.dumps(config))
    argv = sys.argv
    buf = io.StringIO()
    sys.argv = [module.rsplit(".", 1)[-1], "--config", str(cfg_path)]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_module(module, run_name="__main__", alter_sys=True)
    finally:
        sys.argv = argv
    lines = buf.getvalue().strip().splitlines()
    print("\n".join("  | " + ln.split("\r")[-1] for ln in lines[-12:]))
    return json.loads(lines[-1])


def collect(config: dict, cfg_path: Path) -> dict:
    return run_cli("freud_tpu_torch.scripts.collect_activations", config, cfg_path)


# the device cache and resident validation set the last train() run built
RUN_OBJECTS: dict = {}


def backward_counters() -> dict:
    """The TopK backward passes' wrappers by name; none on a tree without
    them."""
    try:
        from freud_tpu_torch.ops.topk_backward import topk_masked_pair, topk_route
    except ImportError:
        return {}
    return {"topk_masked_pair": topk_masked_pair, "topk_route": topk_route}


def train(config: dict, cfg_path: Path) -> tuple[dict, list[dict]]:
    """The train CLI in this process; → (its stats, every step's metrics as
    floats, with the TopK kernels' launches in that step). A fused chunk's
    steps come from its metric stack, each with the chunk's number and its
    launches (kernel launches counted by the wrappers under replay). The
    cache and validation set the run built land in ``RUN_OBJECTS``. Trees
    without ``train_chunk`` (before the device cache) run the same per-step
    path."""
    from freud_tpu_torch.ops.topk_fused import topk_sae_forward
    from freud_tpu_torch.ops.topk_threshold import topk_thresholds_fired
    from freud_tpu_torch.train import trainer as trainer_mod

    SAETrainer = trainer_mod.SAETrainer
    seen: list[dict] = []
    chunks: list[dict] = []
    RUN_OBJECTS.clear()
    counters = {"topk_sae_forward": topk_sae_forward,
                "topk_thresholds_fired": topk_thresholds_fired, **backward_counters()}

    def counts() -> dict:
        return {k: fn.launches for k, fn in counters.items()}

    def launched(before: dict) -> dict:
        after = counts()
        return {f"launches_{k}": after[k] - before[k] for k in counters}

    step = SAETrainer.train_step

    def spy(self, batch):
        before = counts()
        metrics = step(self, batch)
        seen.append({**{k: float(v) for k, v in metrics.items()}, **launched(before)})
        return metrics

    chunk = getattr(SAETrainer, "train_chunk", None)

    def chunk_spy(self, cache, batch_size, n_steps, indices=None):
        before = counts()
        metrics = chunk(self, cache, batch_size, n_steps, indices)
        chunks.append({"steps": n_steps, **launched(before)})
        stack = {k: v.tolist() for k, v in metrics.items()}
        for i in range(n_steps):
            seen.append({**{k: v[i] for k, v in stack.items()}, "chunk": len(chunks) - 1,
                         **{k: v / n_steps for k, v in chunks[-1].items()
                            if k.startswith("launches")}})
        return metrics

    made = {}
    for name in ("DeviceShuffleCache", "DeviceValSet"):
        cls = getattr(trainer_mod, name, None)
        if cls is not None:
            def record(*a, _cls=cls, _name=name, **k):
                RUN_OBJECTS[_name] = _cls(*a, **k)
                return RUN_OBJECTS[_name]
            made[name] = cls
            setattr(trainer_mod, name, record)
    SAETrainer.train_step = spy
    if chunk is not None:
        SAETrainer.train_chunk = chunk_spy
    try:
        stats = run_cli("freud_tpu_torch.scripts.train_sae", config, cfg_path)
    finally:
        SAETrainer.train_step = step
        if chunk is not None:
            SAETrainer.train_chunk = chunk
        for name, cls in made.items():
            setattr(trainer_mod, name, cls)
    RUN_OBJECTS["chunks"] = chunks
    return stats, seen


def device_ms_by_kernel(prof, units: int, top: int = 14) -> tuple[dict, float, float]:
    """A torch.profiler trace's device ms a unit (call, batch or step) by
    kernel name, largest first; and the kernels' and the copies' totals a
    unit."""
    times: dict[str, float] = {}
    copies = 0.0
    for e in prof.key_averages():
        if e.device_time_total <= 0:
            continue
        ms = e.device_time_total / 1e3 / units
        if e.key.startswith(("Memcpy", "Memset")):
            copies += ms
            continue
        # "void ns::(anonymous namespace)::name<T>(args)" → "name"
        name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
        name = name.split("<")[0].split("::")[-1].removeprefix("void ")[:60]
        times[name] = times.get(name, 0.0) + ms
    ranked = dict(sorted(times.items(), key=lambda kv: -kv[1])[:top])
    return ranked, sum(times.values()), copies


def bench(torch, device, card) -> dict:
    """``--bench``: the five kernels timed through their wrappers at the main
    paths' shapes (kernel #1 at both band counts; kernel #2 beside its
    library yardstick and split by launch, kernel #4 split by launch), then
    transcription and decoder-layer collection. It uses nothing but the
    wrappers, the CLIs and the runtime, so a copy of this script beside an
    older freud_tpu_torch times that package with the same code."""
    from torch.profiler import ProfilerActivity, profile

    from freud_tpu_torch.ops.attention import fused_qkv_attention, whisper_attention
    from freud_tpu_torch.ops.mel import log_mel_spectrogram_cuda
    from freud_tpu_torch.ops.topk_fused import topk_sae_forward
    from freud_tpu_torch.ops.topk_threshold import topk_thresholds_fired

    gen = torch.Generator().manual_seed(SEED)
    kernels: dict[str, float] = {}
    rec = {"card": card, "package": str(REPO / "freud_tpu_torch"), "kernels_ms": kernels}
    audio = (torch.randn((BATCH, 480000), generator=gen) * 0.1).to(device)
    for n_mels in (80, 128):
        kernels[f"log_mel (32, 480000) {n_mels} bands"] = cuda_ms(
            lambda: log_mel_spectrogram_cuda(audio, n_mels))
    d, heads = 384, 6
    x = torch.randn((BATCH, 1500, d), generator=gen).to(device)
    w = [(torch.randn((d, d), generator=gen) * d ** -0.5).to(device) for _ in range(3)]
    w_model = [t.T.contiguous().T for t in w]  # as the model passes nn.Linear weights
    bq, bv = ((torch.randn((d,), generator=gen) * 0.1).to(device) for _ in range(2))
    args = (x, w_model[0], bq, w_model[1], w_model[2], bv, heads)
    kernels["fused_qkv_attention (32, 1500, 384) f32"] = cuda_ms(
        lambda: fused_qkv_attention(*args))
    kernels["fused_qkv_attention library: F.linear + SDPA on its inputs"] = cuda_ms(
        lambda: fused_library_call(torch, x, w, bq, bv, heads))
    kernels["fused_qkv_attention library core: bf16 x and weight prepared"] = cuda_ms(
        fused_library_core(torch, x, w, heads))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fused_qkv_attention(*args)
        torch.cuda.synchronize()
    rec["fused_qkv_attention_by_kernel_ms"] = device_ms_by_kernel(prof, 3)[0]
    del audio, x, args, prof
    for b, dtype in ((16, torch.float32), (16, torch.bfloat16), (32, torch.float32),
                     (32, torch.bfloat16)):
        q, k, v = (torch.randn((b, 1500, 20 * 64), generator=gen).to(device, dtype)
                   .view(b, 1500, 20, 64).transpose(1, 2) for _ in range(3))
        kernels[f"whisper_attention ({b}, 20, 1500, 64) {str(dtype)[6:]}"] = cuda_ms(
            lambda: whisper_attention(q, k, v))
        del q, k, v
    torch.cuda.empty_cache()

    rec["topk_sae_forward_by_kernel_ms"] = split = {}
    for name, m, d_in, n_dict, k_aux, dead_share in (
            ("large_v1_audioset", LARGE_M_ROWS, LARGE_D, LARGE_N_DICT, LARGE_K_AUX, 0.94),
            ("tiny_topk", M_ROWS, D_IN, N_DICT, K_AUX, 1 / 3)):
        x, w_enc, b_enc, b_dec, w_dec = _topk_inputs(torch, device, m, gen, d_in, n_dict)
        dead = (torch.rand((n_dict,), generator=gen) < dead_share).float().to(device)
        args = (x, w_enc.T, b_enc, b_dec, w_dec, dead, K, k_aux)
        kernels[f"topk_sae_forward {name} ({m}, {d_in}) -> {n_dict}"] = cuda_ms(
            lambda: topk_sae_forward(*args), reps=10)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                topk_sae_forward(*args)
            torch.cuda.synchronize()
        split[name] = device_ms_by_kernel(prof, 3)[0]
        del x, w_enc, b_enc, b_dec, w_dec, dead, args, prof
        torch.cuda.empty_cache()
    acts = torch.relu(torch.randn((M_ROWS, N_DICT), generator=gen)).to(device, torch.bfloat16)
    dead = (torch.rand((N_DICT,), generator=gen) < 1 / 3).to(device)
    kernels["topk_thresholds_fired bf16 (75000, 6144) k_multi 128"] = cuda_ms(
        lambda: topk_thresholds_fired(acts, dead, K, K_AUX, k_multi=4 * K), reps=10)
    acts = acts.float()
    kernels["topk_thresholds_fired f32 (75000, 6144) k_multi 128"] = cuda_ms(
        lambda: topk_thresholds_fired(acts, dead, K, K_AUX, k_multi=4 * K), reps=5)
    del acts
    # kernel #4's select launch by its profiler name (select_kernel before
    # the shared selection core, select_rows since)
    rec["topk_select_launch_ms"] = {
        name: sum(ms for k, ms in by.items() if k.startswith("select"))
        for name, by in split.items()}
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_bench_") as tmp:
        tmp = Path(tmp)
        wavs = tmp / "audio"
        wavs.mkdir()
        write_wavs(wavs, [480000] * 2 * BATCH)
        rec["transcription"] = bench_transcription(torch, tmp, device)
        rec["decoder"] = bench_decoder(torch, tmp, wavs, device)
    return rec


# --bench transcription rows: (name, model, compute dtype)
TRANSCRIBE_BENCH = (("tiny f32", "random:tiny", "float32"),
                    ("tiny bf16", "random:tiny", "bfloat16"),
                    ("large-v3 bf16", "random:large-v3", "bfloat16"))
DECODE_LABELS = ("self_attention", "cross_attention", "rules")


def bench_transcription(torch, tmp: Path, device) -> dict | None:
    """--bench: one batch of 8 30-s clips transcribed greedily at the full
    224-token budget (early exit off: random weights rarely emit EOT, so
    the budget is the stable yardstick) for each TRANSCRIBE_BENCH row: RTFx
    (240 s of audio over the median of 3 warm ``transcribe`` calls, encode
    and decode), ms a token (the synchronised ``decode`` span ÷ steps), and
    one profiled call: device time by kernel name, by decode part (the
    self- and cross-attention and the rules, labelled with
    ``record_function``; the rest of the step is projections, MLP and the
    vocabulary product), the device-busy share (kernel time over the
    unprofiled call's wall) and the host gaps (wall − kernel time). A tree
    without transcription gives null."""
    from freud_tpu_torch.models.whisper import runtime as rt_mod

    if not hasattr(rt_mod.WhisperRuntime, "transcribe"):
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from freud_tpu_torch import profiling
    from freud_tpu_torch.data.audio_dataset import AudioBatchPipeline
    from freud_tpu_torch.models.whisper import decoding

    wav_dir = tmp / "audio_transcribe_bench"
    wav_dir.mkdir()
    write_wavs(wav_dir, [480000] * TRANSCRIBE_BATCH, seed=SEED + 9)
    real = {name: getattr(decoding, name) for name in ("attend", "_apply_rules")}

    def labelled(name, fn, pick=None):
        def wrapper(*a, **k):
            with record_function(pick(*a) if pick else name):
                return fn(*a, **k)
        return wrapper

    rows = {}
    for name, model, dtype in TRANSCRIBE_BENCH:
        rt = rt_mod.WhisperRuntime(model, compute_dtype=getattr(torch, dtype),
                                   device=device, early_exit=False)
        rt.decoder
        mels = next(iter(AudioBatchPipeline(str(wav_dir), TRANSCRIBE_BATCH, rt.dims.n_mels,
                                            device=device)))[0]
        rt.transcribe(mels)  # warm-up
        profiling.reset()
        walls = []
        steps = decoding.sample_decode.steps
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rt.transcribe(mels)  # ends with the tokens on the host
            walls.append(time.perf_counter() - t0)
        steps = (decoding.sample_decode.steps - steps) / 3
        wall = statistics.median(walls)
        decode_s = profiling.calls("decode")
        decoding.attend = labelled("attention", real["attend"],
                                   lambda q, k, *a: "cross_attention" if k.shape[-2] == 1500
                                   else "self_attention")
        decoding._apply_rules = labelled("rules", real["_apply_rules"])
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                rt.transcribe(mels)
                torch.cuda.synchronize()
        finally:
            for k, fn in real.items():
                setattr(decoding, k, fn)
        # the labels show twice: as CPU ranges, whose device time is their
        # kernels', and as device-timeline annotations, spanning first to
        # last kernel with the gaps between them
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA
                   and e.device_time_total > 0 and e.key not in DECODE_LABELS]
        kernel_ms = sum(e.device_time_total for e in kernels) / 1e3
        by_name: dict[str, float] = {}
        by_kind = dict.fromkeys(("gemm", "softmax", "layer_norm", "reduce",
                                 "elementwise and other"), 0.0)
        for e in kernels:
            short = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            short = short.split("<")[0].split("::")[-1].removeprefix("void ")[:60]
            by_name[short] = by_name.get(short, 0.0) + e.device_time_total / 1e3
            low = e.key.lower()
            kind = ("gemm" if any(t in low for t in ("gemm", "gemv", "nvjet", "xmma"))
                    else next((k for k in ("softmax", "layer_norm", "reduce") if k in low),
                              "elementwise and other"))
            by_kind[kind] += e.device_time_total / 1e3
        parts = {k: sum(e.device_time_total for e in events
                        if e.key == k and e.device_type == DeviceType.CPU) / 1e3
                 for k in DECODE_LABELS}
        spans = {k: sum(e.device_time_total for e in events
                        if e.key == k and e.device_type == DeviceType.CUDA) / 1e3
                 for k in DECODE_LABELS}
        rows[name] = {
            "model": model, "dtype": dtype, "batch": TRANSCRIBE_BATCH,
            "max_new_tokens": rt.max_new_tokens, "early_exit": False,
            "wall_ms": 1e3 * wall, "walls_ms": [1e3 * w for w in walls],
            "rtfx": TRANSCRIBE_BATCH * 30.0 / wall, "steps": steps,
            "decode_ms": [1e3 * t for t in decode_s],
            "ms_per_token": 1e3 * statistics.median(decode_s) / steps,
            "kernel_ms": kernel_ms, "device_busy": kernel_ms / (1e3 * wall),
            "host_gap_ms": 1e3 * wall - kernel_ms,
            "decode_parts_kernel_ms": parts, "decode_parts_device_span_ms": spans,
            "by_kind_ms": by_kind,
            "by_kernel_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:16])}
        print(f"transcription bench {name}: {json.dumps(rows[name])}")
        del rt, mels, prof
        free_device_memory(torch)
    return rows


def bench_decoder(torch, tmp: Path, wavs64: Path, device) -> dict | None:
    """--bench: decoder-layer capture and steering at tiny width.
    Collection of random:tiny decoder block 2 at batch 32 (each batch the
    whole encoder, a 224-token greedy decode and a teacher-forced capture):
    an untimed run over 32 files, then 64 files and 32 files; the steady
    time a batch is their difference. Then one batch of 8 30-s clips
    greedily decoded at the full budget (early exit off), unsteered and
    steered by a TopK SAE roundtrip at tiny_topk width (d 384, n_dict 6144,
    k 32, the validation transcripts' tap): after a warm-up pair, 10
    pairs, their order alternating, each decode timed on the host's clock (synchronised)
    and between CUDA events, → ms a step, each side's median, min and max;
    then one decode of each under the profiler, → its kernels' device ms a
    step, which host jitter does not reach. A tree without decoder capture
    gives null."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from freud_tpu_torch.models.whisper import runtime as rt_mod

    if not hasattr(rt_mod.WhisperRuntime, "activations_with_decode"):
        return None
    from freud_tpu_torch.analysis.features import sae_roundtrip_tap_params, sae_steer_fn
    from freud_tpu_torch.data.audio_dataset import AudioBatchPipeline
    from freud_tpu_torch.models.sae import topk as topk_mod
    from freud_tpu_torch.models.sae.config import TopKAutoEncoderConfig
    from freud_tpu_torch.models.whisper import decoding

    wavs32 = tmp / "audio_dec32"
    wavs32.mkdir()
    write_wavs(wavs32, [480000] * BATCH, seed=SEED + 12)
    base = json.loads((REPO / "configs/features/tiny_block_2_test.json").read_text())
    runs = []
    for folder in (wavs32, wavs64, wavs32):
        cfg = {**base, "whisper_model": "random:tiny", "layer_name": DEC_LAYER,
               "batch_size": BATCH, "data_path": str(folder),
               "out_folder": str(tmp / f"dec_bench{len(runs)}")}
        runs.append(collect(cfg, tmp / "dec_bench.json"))
        free_device_memory(torch)
    steady_s = runs[1]["elapsed_s"] - runs[2]["elapsed_s"]
    rec = {"collection": {
        "model": "random:tiny", "layer": DEC_LAYER, "batch": BATCH,
        "elapsed_s_64_32": [runs[1]["elapsed_s"], runs[2]["elapsed_s"]],
        "rtfx_64_32": [runs[1]["rtfx"], runs[2]["rtfx"]],
        "steady_batch_ms": 1e3 * steady_s, "steady_rtfx": BATCH * 30.0 / steady_s}}
    print(f"decoder bench collection: {json.dumps(rec['collection'])}", flush=True)

    rt = rt_mod.WhisperRuntime("random:tiny", DEC_LAYER, device=device, early_exit=False)
    mels = next(iter(AudioBatchPipeline(str(wavs32), TRANSCRIBE_BATCH, rt.dims.n_mels,
                                        device=device)))[0]
    encoded = rt.encode(mels)
    prompt, n_prompt = rt._prompt(encoded)
    cfg = TopKAutoEncoderConfig(expansion_factor=16, k=K)
    sae = topk_mod.init_topk(D_IN, cfg, seed=SEED, device=device)
    tap = (2, sae_steer_fn("topk", cfg), sae_roundtrip_tap_params("topk", sae))

    def decode(steered: bool, timing: dict | None = None) -> None:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        steps, t0 = decoding.sample_decode.steps, time.perf_counter()
        start.record()
        rt._decode(encoded, prompt, n_prompt, decoder_tap=tap if steered else None)
        end.record()
        torch.cuda.synchronize()
        n = decoding.sample_decode.steps - steps
        if timing is not None:
            timing["wall"].append(1e3 * (time.perf_counter() - t0) / n)
            timing["events"].append(start.elapsed_time(end) / n)

    sides = ("unsteered", "steered")
    ms = {k: {"wall": [], "events": []} for k in sides}
    for steered in (False, True):  # the warm-up pair
        decode(steered)
    for i in range(10):  # each pair in the other order than the last
        for k in sides[::-1] if i % 2 else sides:
            decode(k == "steered", ms[k])
    kernel_ms = {}
    for k in sides:
        steps = decoding.sample_decode.steps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            decode(k == "steered")
        kernel_ms[k] = sum(e.device_time_total for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA) / 1e3 / (
                               decoding.sample_decode.steps - steps)

    def spread(v: list) -> dict:
        return {"median": statistics.median(v), "min": min(v), "max": max(v)}

    rec["steering"] = {"batch": TRANSCRIBE_BATCH, "dtype": "float32",
                       "sae": "topk d_in 384 n_dict 6144 k 32", "pairs": 10,
                       "ms_a_step": ms,
                       "wall_ms_a_step": {k: spread(ms[k]["wall"]) for k in sides},
                       "event_ms_a_step": {k: spread(ms[k]["events"]) for k in sides},
                       "kernel_ms_a_step": kernel_ms}
    print(f"decoder bench steering: {json.dumps(rec['steering'])}", flush=True)
    del rt, mels, encoded, sae
    free_device_memory(torch)
    return rec


def free_device_memory(torch) -> None:
    """Drop what the last run left (its model, its SAE) from the card."""
    gc.collect()
    torch.cuda.empty_cache()


def check_checkpoints(torch, ckpt_dir: Path, names: list[str]) -> None:
    for name in names:
        ck = torch.load(ckpt_dir / name, map_location="cpu", weights_only=True)
        assert {"model", "optimizer", "step", "hparams",
                "num_frames_since_fired"} <= set(ck), (name, sorted(ck))
        assert all(torch.isfinite(v).all() for v in ck["model"].values()), name


def card_vs_cpu_batch(torch, device, store, d_in: int = D_IN, n_dict: int = N_DICT,
                      n_files: int = 2) -> float:
    """One TopK step's losses and parameter gradients at full width
    (``n_files`` files), on the card (kernel #4) and on the CPU (plain),
    from the same numpy weights. → the largest gradient error relative to
    its max."""
    from freud_tpu_torch.models.sae import params_from_jax
    from freud_tpu_torch.models.sae import topk as topk_mod
    from freud_tpu_torch.models.sae.config import TopKAutoEncoderConfig

    rng = np.random.default_rng(SEED + 4)
    bound = d_in ** -0.5
    w = rng.uniform(-bound, bound, (n_dict, d_in)).astype(np.float32)
    np_params = {"encoder_weight": w, "W_dec": w / np.linalg.norm(w, axis=1, keepdims=True),
                 "encoder_bias": (rng.standard_normal(n_dict) * 0.01).astype(np.float32),
                 "b_dec": (rng.standard_normal(d_in) * 0.01).astype(np.float32)}
    x = torch.from_numpy(np.array(store[:n_files], np.float32))
    dead = torch.from_numpy(rng.random(n_dict) < 1 / 3)
    cfg = TopKAutoEncoderConfig(expansion_factor=16, k=K, auxk_alpha=1 / 32)
    out = {}
    for dev in (device, torch.device("cpu")):
        params = params_from_jax("topk", np_params, dev)
        terms, _ = topk_mod.training_losses(params, x.to(dev), cfg, dead.to(dev),
                                            matmul_dtype=torch.bfloat16)
        loss = terms["fvu"] + terms["auxk_loss"]
        loss.backward()
        out[dev.type] = ({k: float(v) for k, v in terms.items()},
                         {n: p.grad.cpu() for n, p in params.named_parameters()})
    (card_terms, card_g), (cpu_terms, cpu_g) = out["cuda"], out["cpu"]
    for k in ("fvu", "auxk_loss"):
        rel = abs(card_terms[k] - cpu_terms[k]) / abs(cpu_terms[k])
        print(f"card vs CPU, one batch (d_in {d_in}, n_dict {n_dict}): {k} "
              f"{card_terms[k]:.6f} vs {cpu_terms[k]:.6f} "
              f"(rel {rel:.2e}, bound 1e-2)")
        assert rel < 1e-2, (k, rel)
    worst = 0.0
    for n, g in cpu_g.items():
        err = ((card_g[n] - g).abs().max() / g.abs().max()).item()
        print(f"card vs CPU, one batch (d_in {d_in}): grad {n} max|Δ|/max|cpu| "
              f"{err:.3e} (bound 3e-2)")
        assert err < 3e-2, (n, err)
        worst = max(worst, err)
    return worst


def graph_against_eager(torch, store_dir: str, variant: str, batch: int,
                        n_steps: int = 5) -> dict:
    """A chunk of ``n_steps`` train steps at full width (tiny_topk: kernel
    #4 inside, AuxK active; tiny_l1) replayed as a CUDA graph, against the
    same steps run eagerly from the same state on the same injected
    (n_steps, batch) window rows: parameters, moments, update count,
    dead-feature counters and the metric stack. A second replay from the
    same state must repeat the first, and launch kernel #4 once a step.
    → the largest difference relative to its max, and the launches."""
    from freud_tpu_torch.data.device_cache import DeviceShuffleCache, sample_rows
    from freud_tpu_torch.ops.topk_fused import topk_sae_forward
    from freud_tpu_torch.train.trainer import SAETrainer

    base = json.loads((REPO / f"configs/train/tiny_{variant}.json").read_text())
    ae = dict(base["autoencoder_config"])
    if variant == "topk":  # below one step's frames: AuxK from the chunk's first step
        ae["dead_feature_threshold"] = batch * 1500 // 2
    trainer = SAETrainer(variant, ae, D_IN, optimizer=base["optimizer"],
                         scheduler=base["scheduler"], scheduler_params={"num_warmup_steps": 2},
                         lr=1e-3, steps=100, seed=SEED, device="cuda")
    cache = DeviceShuffleCache(store_dir, LAYER, 10 ** 6, refresh_files=0, seed=SEED,
                               device="cuda")
    try:
        trainer.train_step(cache.next_batch(batch))  # latents that did not fire are dead
        gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
        idx = torch.randint(0, cache.capacity, (n_steps, batch), generator=gen, device="cuda")
        start = [t.clone() for t in trainer._state()]

        def restore():
            with torch.no_grad():
                for t, s in zip(trainer._state(), start):
                    t.copy_(s)

        runs = []
        for _ in range(2):  # the first call captures (after its warm-up step)
            restore()
            before = topk_sae_forward.launches
            m = trainer.train_chunk(cache, batch, n_steps, indices=idx)
            torch.cuda.synchronize()
            runs.append(([t.clone() for t in trainer._state()], m,
                         topk_sae_forward.launches - before))
        restore()
        eager = [trainer._step(sample_rows(cache.cache, idx[i])) for i in range(n_steps)]
        eager_m = {k: torch.stack([e[k] for e in eager]) for k in eager[0]}
        eager_state = [t.clone() for t in trainer._state()]
    finally:
        cache.close()
    (g_state, g_m, _), (r_state, r_m, replay_launches) = runs

    def rel(a, b) -> float:
        a, b = a.detach().double(), b.detach().double()
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    names = ([n for n, _ in trainer.params.named_parameters()]
             + ["mu"] * len(trainer.opt.mu) + ["nu"] * len(trainer.opt.nu)
             + ["count", "num_frames_since_fired"])
    diffs = {}
    for name, g, e, r in zip(names, g_state, eager_state, r_state):
        assert torch.equal(g, r), f"{variant}: two replays differ in {name}"
        diffs[name] = max(diffs.get(name, 0.0), rel(g, e))
    for k in eager_m:
        assert torch.equal(g_m[k], r_m[k]), f"{variant}: two replays differ in {k}"
        diffs[f"metric {k}"] = rel(g_m[k], eager_m[k])
    worst = max(diffs.values())
    bit_equal = worst == 0.0
    print(f"graph vs eager, tiny_{variant} chunk of {n_steps} at batch {batch}: "
          f"{'bit-equal' if bit_equal else f'max|Δ|/max {worst:.3e} (bound 1e-6)'} "
          f"{ {k: v for k, v in diffs.items() if v} }; kernel #4 launches a replay "
          f"{replay_launches}")
    assert worst <= 1e-6, diffs
    if variant == "topk":
        assert float(g_m["auxk_loss"][0]) > 0, "AuxK did not run in the chunk"
        assert replay_launches == n_steps, replay_launches
    return {"bit_equal": bit_equal, "max_rel_diff": worst, "replay_launches": replay_launches}


def run_transcribe(torch, args: list[str], out: Path, warm_align: bool = False) -> dict:
    """``python -m freud_tpu_torch.scripts.transcribe <args> --out <out>``,
    in this process (so the launch counters are readable). → {"result": the
    JSON it wrote, "decodes": each decode's token rows, steps and
    synchronised seconds (the runtime's ``_decode`` returns host arrays),
    "seconds": the run's wall after the runtime was built (its model init
    excluded; with ``warm_align`` the alignment pass's decoder too)}."""
    from freud_tpu_torch.models.whisper import decoding, runtime

    cls = runtime.WhisperRuntime
    real_init, real_decode = cls.__init__, cls._decode
    rec: dict = {"decodes": []}

    def init_spy(self, *a, **k):
        real_init(self, *a, **k)
        self.decoder  # build the decoder here too, outside the timed run
        if warm_align:
            self.align_decoder
        torch.cuda.synchronize()
        rec["ready"], rec["n_vocab"] = time.perf_counter(), self.dims.n_vocab

    def decode_spy(self, encoded, prompt, n_prompt, **kw):
        steps = decoding.sample_decode.steps + decoding.beam_decode.steps
        t0 = time.perf_counter()
        got = real_decode(self, encoded, prompt, n_prompt, **kw)
        rec["decodes"].append({
            "tokens": got[0], "n_prompt": n_prompt, "seconds": time.perf_counter() - t0,
            "steps": decoding.sample_decode.steps + decoding.beam_decode.steps - steps})
        return got

    argv = sys.argv
    sys.argv = ["transcribe", *args, "--out", str(out)]
    cls.__init__, cls._decode = init_spy, decode_spy
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            runpy.run_module("freud_tpu_torch.scripts.transcribe", run_name="__main__",
                             alter_sys=True)
        torch.cuda.synchronize()
    finally:
        sys.argv = argv
        cls.__init__, cls._decode = real_init, real_decode
    rec["seconds"] = time.perf_counter() - rec.pop("ready")
    rec["result"] = json.loads(out.read_text())
    return rec


def check_token_rows(tokens: np.ndarray, n_prompt: int, st) -> int:
    """Whisper's rules on decoded rows: the first sampled token a timestamp
    ≤ ts0 + 50, EOT padding after the first EOT, timestamps non-decreasing,
    a pair of timestamps followed by text, no special token. → the rows'
    generated non-EOT tokens."""
    ts0, n_text = st.timestamp_begin, 0
    for row in tokens:
        gen = [int(t) for t in row[n_prompt:]]
        assert ts0 <= gen[0] <= ts0 + 50, gen[:4]
        if st.eot in gen:
            cut = gen.index(st.eot)
            assert all(t == st.eot for t in gen[cut:]), gen
            gen = gen[:cut]
        n_text += len(gen)
        stamps = [t for t in gen if t >= ts0]
        assert stamps == sorted(stamps), stamps
        for i in range(2, len(gen)):
            assert not (gen[i - 2] >= ts0 and gen[i - 1] >= ts0 and gen[i] >= ts0), gen
        banned = {st.sot, st.sot_prev, st.no_speech, st.no_timestamps, st.transcribe,
                  st.translate}
        assert not banned & set(gen), gen
    return n_text


def transcribe_runs(torch, tmp: Path, card: str, runs, n_batches: int, audio_s: float,
                    counters: dict, expect: dict) -> dict:
    """Each (name, CLI args) of ``runs`` once through ``run_transcribe``,
    the kernel counters in ``counters`` ({name: wrapper}) set to 0 just
    before and read just after; ``expect`` gives each counter's launches a
    batch. → {name: the run's record with its launches}."""
    from freud_tpu_torch.models.whisper import special_tokens

    out = {}
    for name, args in runs:
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        rec = run_transcribe(torch, args, tmp / "transcribe.json")
        rec["launches"] = {k: fn.launches for k, fn in counters.items()}
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        for k, per_batch in expect.items():
            assert rec["launches"][k] == per_batch * n_batches, (name, rec["launches"])
        st = special_tokens(rec["n_vocab"])
        n_text = sum(check_token_rows(d["tokens"], d["n_prompt"], st)
                     for d in rec["decodes"])
        n_rows = sum(len(d["tokens"]) for d in rec["decodes"])
        ms_token = statistics.median(1e3 * d["seconds"] / d["steps"] for d in rec["decodes"])
        n_files = len(rec["result"])
        print(f"transcribe {name}: {n_files} files in {rec['seconds']:.3f} s after model "
              f"init ({n_files / rec['seconds']:.2f} files/s, RTFx "
              f"{audio_s / rec['seconds']:.1f} of the clips' {audio_s:.1f} s), "
              f"{len(rec['decodes'])} decodes, {n_text / n_rows:.1f} tokens a clip, median "
              f"{ms_token:.3f} ms a step (synchronised decode ÷ steps), steps "
              f"{[d['steps'] for d in rec['decodes']]}, peak device memory "
              f"{rec['peak_gib']:.3f} GiB, launches {rec['launches']} on {card}")
        rec.update(rtfx=audio_s / rec["seconds"], ms_per_token=ms_token)
        out[name] = rec
        free_device_memory(torch)
    return out


def decode_card_vs_cpu(torch, device, wavs: list[str], card: str) -> None:
    """One encoded batch (2 clips) computed on the CPU and moved to the
    card; from the same random:tiny decoder weights: teacher-forced logits
    and the KV-cached step's rows on the card within 1e-4 of max of the
    CPU's (f32, TF32 off), then greedy and beam-5 tokens on the card equal
    to the CPU's up to the first step whose CPU post-rules top-two margin is
    under DECODE_CLOSE_CALL."""
    from freud_tpu_torch.audio.decode import load_audio
    from freud_tpu_torch.audio.mel import mels_from_array
    from freud_tpu_torch.models.whisper import (
        decoder_forward, encoder_forward, load_decoder, load_model, special_tokens)
    from freud_tpu_torch.models.whisper import decoding

    enc, dims = load_model("random:tiny")
    dec_cpu, _ = load_decoder("random:tiny")
    dec_card, _ = load_decoder("random:tiny", device=device)
    with torch.inference_mode():
        mels = torch.stack([mels_from_array(load_audio(f), 80) for f in wavs])
        encoded, _ = encoder_forward(enc, dims, mels)
    st = special_tokens(dims.n_vocab)
    prompt = torch.tensor([st.sot_sequence(0)] * len(wavs))
    greedy = decoding.sample_decode(dec_cpu, dims, encoded, prompt, 3)
    enc_card = encoded.to(device)
    with torch.inference_mode():
        want, _ = decoder_forward(dec_cpu, dims, greedy[0], encoded)
        got, _ = decoder_forward(dec_card, dims, greedy[0].to(device), enc_card)
        rel_tf = float((got.cpu() - want).abs().max() / want.abs().max())
        cross = decoding._cross_kv_stacks(dec_card, dims, enc_card)
        sk, sv = decoding._self_kv(dims, len(wavs), greedy[0].shape[1], torch.float32, device)
        pos = torch.zeros((), dtype=torch.int64, device=device)
        rows = []
        for p in range(greedy[0].shape[1]):
            rows.append(decoding._decode_step(dec_card, dims, greedy[0][:, p].to(device),
                                              pos, sk, sv, cross))
            pos += 1
        rel_kv = float((torch.stack(rows, 1) - got).abs().max() / got.abs().max())
    print(f"decoder card vs CPU, 2 clips: teacher-forced logits max|Δ|/max {rel_tf:.3e}, "
          f"KV-cached step rows vs teacher-forced on the card {rel_kv:.3e} (bound 1e-4)")
    assert rel_tf < 1e-4 and rel_kv < 1e-4, (rel_tf, rel_kv)
    for name, fn, kw in (("greedy", decoding.sample_decode, {}),
                         ("beam 5", decoding.beam_decode, {"beam_size": 5})):
        want = greedy if name == "greedy" else fn(dec_cpu, dims, encoded, prompt, 3, **kw)
        got = fn(dec_card, dims, enc_card, prompt.to(device), 3, **kw)
        margins = decoding.decision_margins(dec_cpu, dims, encoded, want[0], 3)
        close = [int(np.argmax(m < DECODE_CLOSE_CALL)) if (m < DECODE_CLOSE_CALL).any()
                 else None for m in margins]
        for r, c in enumerate(close):
            upto = want[0].shape[1] if c is None else c
            assert torch.equal(got[0][r, :upto].cpu(), want[0][r, :upto]), (name, r, upto)
        same = bool(torch.equal(got[0].cpu(), want[0]))
        print(f"{name} card vs CPU: tokens equal up to the first CPU close call "
              f"(margin < {DECODE_CLOSE_CALL}) at step {close if any(c is not None for c in close) else 'none'}"
              f"; whole rows equal: {same} on {card}")


def check_transcript_tags(run_dir: Path) -> None:
    """The trainer logged val/transcripts/reconstructed_i and base_i for the
    4 transcript slots (read back when tensorboard imports)."""
    try:
        from tensorboard.backend.event_processing.event_accumulator import EventAccumulator
    except ImportError:
        print("tensorboard missing: transcript tags not read back")
        return
    acc = EventAccumulator(str(run_dir))
    acc.Reload()
    tags = acc.Tags().get("tensors", [])
    for i in range(4):
        for kind in ("reconstructed", "base"):
            assert any(t.startswith(f"val/transcripts/{kind}_{i}") for t in tags), tags


# ------------------------------------------------- decoder capture, steering


@contextlib.contextmanager
def count_batches(loader_cls, counters: dict):
    """Record each batch a fly loader computes — its rows and the launches
    of ``counters`` ({name: wrapper}) since the previous batch was done,
    its log-mel included (the loader's thread runs the mel, then
    ``_compute``) — by wrapping ``loader_cls._compute`` while the block
    runs: the fly trainer's prefetch thread computes batches ahead, so
    totals read after a run would race it. Yields the growing list."""
    real = loader_cls._compute
    seen: list[dict] = []
    last = {k: fn.launches for k, fn in counters.items()}

    def spy(self, mels, n, **kw):
        out = real(self, mels, n, **kw)
        now = {k: fn.launches for k, fn in counters.items()}
        seen.append({"rows": n, **{k: now[k] - last[k] for k in now}})
        last.update(now)
        return out

    loader_cls._compute = spy
    try:
        yield seen
    finally:
        loader_cls._compute = real


@contextlib.contextmanager
def timed_decodes(torch):
    """Synchronise and time every ``sample_decode`` the runtime calls
    (decode_capture and transcription) while the block runs. Yields a
    record whose "seconds" and "steps" grow a call."""
    from freud_tpu_torch.models.whisper import decoding
    from freud_tpu_torch.models.whisper import runtime as rt_mod

    real = rt_mod.sample_decode
    rec: dict = {"seconds": [], "steps": []}

    def spy(*a, **k):
        torch.cuda.synchronize()
        steps, t0 = decoding.sample_decode.steps, time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        rec["seconds"].append(time.perf_counter() - t0)
        rec["steps"].append(decoding.sample_decode.steps - steps)
        return out

    rt_mod.sample_decode = spy
    try:
        yield rec
    finally:
        rt_mod.sample_decode = real


def ms_a_step(rec: dict) -> float:
    return 1e3 * sum(rec["seconds"]) / max(sum(rec["steps"]), 1)


def check_decoder_store(folder: Path, layer: str, n_files: int, width: int,
                        filenames: list[str]) -> tuple[dict, np.ndarray]:
    """A decoder-layer store: (n, DEC_FRAMES, width) finite rows, metadata
    of the decode's buffer, n_frames the decode's valid positions."""
    meta, rows = read_store(folder, layer)
    assert rows.shape == (n_files, DEC_FRAMES, width), rows.shape
    assert np.isfinite(rows).all()
    assert meta["tensor_shape"] == meta["activation_shape"] == [DEC_FRAMES, width]
    assert meta["filenames"] == filenames
    assert all(4 <= n <= DEC_FRAMES for n in meta["n_frames"]), meta["n_frames"]
    return meta, rows


def decoder_collections(torch, tmp: Path, config: dict, clips, ckpt: Path, card: str,
                        counters: dict) -> dict:
    """Phase 14: the collection CLI on decoder block 2 of random:tiny over
    phase 3's WAVs at batch 32 (each batch: kernel #1 once, #2 four times —
    the whole encoder — then a greedy decode of 224 tokens and one
    teacher-forced captured pass); then ``.mlp.1`` over 8 files (width
    1536) and phase 5's TopK checkpoint attached over 8 files (an indexed
    store). → the launches, RTFx and ms a decode step."""
    from freud_tpu_torch.data.loaders import FlyActivationLoader

    names = [p for p, _ in clips]
    runs = {}
    n_all = -(-(len(clips) + 1) // BATCH)  # the broken file takes a slot
    for name, over, n_files, n_batches, width in (
            ("decoder.blocks.2", {}, len(clips), n_all, D_IN),
            ("decoder.blocks.2.mlp.1", {"layer_name": f"{DEC_LAYER}.mlp.1",
                                        "collect_max": 8}, 8, 1, 4 * D_IN),
            ("decoder.blocks.2 + TopK SAE", {"sae_model": str(ckpt), "collect_max": 8},
             8, 1, None)):
        cfg = {**config, "layer_name": DEC_LAYER, **over,
               "out_folder": str(tmp / f"dec_{len(runs)}")}
        for fn in counters.values():
            fn.launches = 0
        with count_batches(FlyActivationLoader, counters) as batches, \
                timed_decodes(torch) as decodes:
            stats = collect(cfg, tmp / "dec.json")
            torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in counters.items()}
        print(f"decoder collection {name}: {stats['n_files']} files in "
              f"{stats['elapsed_s']:.3f} s (after model init), RTFx {stats['rtfx']:.1f}, "
              f"{len(batches)} batches, decode {ms_a_step(decodes):.3f} ms a step "
              f"(synchronised, steps {decodes['steps']}), launches {got} on {card}")
        assert len(batches) == n_batches, (len(batches), n_batches)
        assert got == {"log_mel": n_batches, "fused_qkv_attention": 4 * n_batches,
                       "whisper_attention": 0, "topk_thresholds_fired": 0}, got
        assert stats["n_files"] == n_files
        out = Path(cfg["out_folder"])
        if width is not None:
            meta, _ = check_decoder_store(out, cfg["layer_name"], n_files, width,
                                          names[:n_files])
        else:
            meta = json.loads((out / f"{DEC_LAYER}_metadata.json").read_text())
            vals = np.load(out / f"{DEC_LAYER}_activation_values.npy", mmap_mode="r")
            idx = np.load(out / f"{DEC_LAYER}_feature_indices.npy", mmap_mode="r")
            assert vals.shape == idx.shape == (n_files, DEC_FRAMES * K), vals.shape
            assert meta["activation_shape"] == [DEC_FRAMES, N_DICT]
            assert np.isfinite(vals).all() and (np.asarray(vals) >= 0).all()
            assert idx.min() >= 0 and idx.max() < N_DICT
        runs[name] = {"rtfx": stats["rtfx"], "elapsed_s": stats["elapsed_s"],
                      "launches": got, "batches": len(batches),
                      "decode_ms_a_step": ms_a_step(decodes),
                      "n_frames": meta["n_frames"][:4]}
        free_device_memory(torch)
    return runs


def decoder_training(torch, tmp: Path, store_dir: str, audio_dir: Path, card: str) -> dict:
    """Phase 15: the train CLI on the decoder store (51 files × 227 rows):
    tiny_topk 10 steps with the validation transcripts steered online by
    the live SAE (val_every 5), kernel #4 once a step; the same through a
    24-file device cache in chunks of 5 (CUDA graphs: the transcriber reads
    the parameters the replays update in place); 4 tiny_l1 steps (an L1
    tap); 3 fly-mode steps at batch 8 from the WAVs (each batch a decoder
    capture: #1 once, #2 four times). Kernel #3 is counted in every run
    and launches in none: neither recipe sets ``multi_topk``. → launches
    and steps/s."""
    from freud_tpu_torch import profiling
    from freud_tpu_torch.data.loaders import FlyActivationLoader
    from freud_tpu_torch.ops.attention import fused_qkv_attention
    from freud_tpu_torch.ops.mel import log_mel_spectrogram_cuda
    from freud_tpu_torch.ops.topk_fused import topk_sae_forward
    from freud_tpu_torch.ops.topk_threshold import topk_thresholds_fired

    tbase = json.loads((REPO / "configs/train/tiny_topk.json").read_text())
    lbase = json.loads((REPO / "configs/train/tiny_l1.json").read_text())
    rows = 50 * DEC_FRAMES
    common = {"train_folder": store_dir, "val_folder": store_dir, "steps": 10,
              "save_every": 5, "val_every": 5, "log_tb_every": 5,
              "whisper_config": {"model": "random:tiny", "layer_name": DEC_LAYER}}
    tcfg = {**tbase, **common, "lr": 1e-3, "scheduler_params": {"num_warmup_steps": 2},
            # below one step's rows: AuxK runs from step 2
            "autoencoder_config": {**tbase["autoencoder_config"],
                                   "dead_feature_threshold": rows // 2}}
    out = {}
    for name, cfg, n_val, chunked in (
            ("tiny_topk", tcfg, 2, False),
            ("tiny_topk through the cache", {**tcfg, "device_cache_files": CACHE_FILES,
                                             "fused_steps": 5}, 2, True),
            ("tiny_l1 (batch 50)", {**lbase, **common, "steps": 4, "save_every": 4,
                                    "val_every": 4, "batch_size": 50}, 1, False)):
        run_dir = tmp / f"run_dec_{len(out)}"
        topk_sae_forward.launches = topk_thresholds_fired.launches = 0
        stats, steps = train({**cfg, "run_dir": str(run_dir)}, tmp / "dec_train.json")
        launches = topk_sae_forward.launches
        thresholds = topk_thresholds_fired.launches
        val_s = profiling.calls("val_transcripts")
        print(f"decoder store {name}: {stats['steps']} steps, steps_per_sec "
              f"{stats['steps_per_sec']:.3f} (incl. validations with steered transcripts "
              f"{[round(t, 3) for t in val_s]} s), kernel #4 launches {launches}, #3 "
              f"{thresholds}; loss "
              f"{steps[0]['loss']:.4f} → {steps[-1]['loss']:.4f} on {card}")
        assert stats["steps"] == cfg["steps"] == len(steps)
        assert all(np.isfinite([v for k, v in m.items() if k != "chunk"]).all()
                   for m in steps)
        assert len(val_s) == n_val, val_s  # one batched steered decode a validation
        assert thresholds == 0 and not cfg.get("multi_topk"), thresholds
        check_transcript_tags(run_dir)
        if "topk" in name:
            assert max(m["auxk_loss"] for m in steps[1:]) > 0
            chunks = RUN_OBJECTS["chunks"]
            if chunked:  # the capture's warm-up step, then one a replayed step
                assert [c["launches_topk_sae_forward"] for c in chunks] == [6, 5], chunks
                assert RUN_OBJECTS["DeviceValSet"].ok
            else:
                assert [m["launches_topk_sae_forward"] for m in steps] == [1] * 10
            assert launches == 10 + chunked, launches
        out[name] = {"steps_per_sec": stats["steps_per_sec"], "launches": launches,
                     "launches_thresholds": thresholds, "val_transcripts_s": val_s}
        free_device_memory(torch)
    # fly mode: each step's batch is a decoder capture of 8 WAVs (the
    # loader's prefetch computes a batch or two ahead)
    capture = {"log_mel": log_mel_spectrogram_cuda, "fused_qkv_attention": fused_qkv_attention}
    for fn in (*capture.values(), topk_sae_forward, topk_thresholds_fired):
        fn.launches = 0
    with count_batches(FlyActivationLoader, capture) as batches:
        stats, steps = train({**tcfg, "train_folder": str(audio_dir),
                              "val_folder": str(audio_dir), "from_disk": False,
                              "batch_size": 8, "steps": 3, "save_every": 100,
                              "val_every": 100, "log_tb_every": 1,
                              "enable_transcripts": False,
                              "run_dir": str(tmp / "run_dec_fly")}, tmp / "dec_fly.json")
    done = list(batches)  # the batches computed by now, each with its launches
    got = {"log_mel": sum(b["log_mel"] for b in done),
           "fused_qkv_attention": sum(b["fused_qkv_attention"] for b in done),
           "topk_sae_forward": topk_sae_forward.launches,
           "topk_thresholds_fired": topk_thresholds_fired.launches}
    print(f"decoder fly-mode tiny_topk at batch 8: {stats['steps']} steps, steps_per_sec "
          f"{stats['steps_per_sec']:.3f}, {len(done)} batches captured, launches {got} "
          f"on {card}")
    assert stats["steps"] == 3 and len(done) >= 3
    assert all(b == {"rows": 8, "log_mel": 1, "fused_qkv_attention": 4} for b in done), done
    assert got["topk_sae_forward"] == 3 and got["topk_thresholds_fired"] == 0, got
    out["fly"] = {"steps_per_sec": stats["steps_per_sec"], "launches": got,
                  "batches": len(done)}
    free_device_memory(torch)
    return out


def decoder_card_vs_cpu(torch, device, wavs: list[str], ckpt: Path, card: str) -> dict:
    """Phase 16: 2 clips, random:tiny decoder block 2, the card against the
    CPU (f32, TF32 off; the encoder's attention on the plain f32 path on
    the card too, as kernel #2's bf16 products alone move the encoding by
    more than the bound): ``decode_capture`` activations within 1e-4 of max
    and tokens equal up to the first CPU post-rules margin under
    DECODE_CLOSE_CALL; greedy tokens steered by phase 5's TopK SAE at
    factor 1 and STEER_FACTOR likewise (the encoding the CPU's on both);
    and the tapped step's logits on the card against the teacher-forced
    oracle with the tapped block output substituted (2e-3)."""
    from freud_tpu_torch.analysis.features import sae_steer_fn
    from freud_tpu_torch.audio.decode import load_audio
    from freud_tpu_torch.audio.mel import mels_from_array
    from freud_tpu_torch.data.loaders import load_sae
    from freud_tpu_torch.models.whisper import WhisperRuntime, decoder_forward, special_tokens
    from freud_tpu_torch.models.whisper import decoding
    from freud_tpu_torch.models.whisper import model as model_mod
    from freud_tpu_torch.models.sae import topk as topk_mod

    mels = torch.stack([mels_from_array(load_audio(f), 80) for f in wavs])
    rts = {}
    impl = model_mod.ATTENTION_IMPL
    model_mod.ATTENTION_IMPL = "einsum"
    try:
        for dev in ("cpu", device):
            rts[str(dev)] = rt = WhisperRuntime("random:tiny", DEC_LAYER, device=dev)
            rts[f"{dev} capture"] = rt.activations_with_decode(mels.to(dev))
    finally:
        model_mod.ATTENTION_IMPL = impl
    cpu_rt, card_rt = rts["cpu"], rts[str(device)]
    (w_acts, w_n, w_tok), (g_acts, g_n, g_tok) = rts["cpu capture"], rts[f"{device} capture"]
    with torch.inference_mode():
        encoded = cpu_rt.encode(mels)
    margins = decoding.decision_margins(cpu_rt.decoder, cpu_rt.dims, encoded, w_tok, 3)
    rec = {"capture_rel": [], "close_calls": []}
    for r in range(len(wavs)):
        close = margins[r] < DECODE_CLOSE_CALL
        upto = int(np.argmax(close)) if close.any() else DEC_FRAMES
        assert torch.equal(g_tok[r, :upto].cpu(), w_tok[r, :upto]), (r, upto)
        rel = float((g_acts[r, :upto].cpu() - w_acts[r, :upto]).abs().max()
                    / w_acts.abs().max())
        assert rel < 1e-4, (r, rel)
        if upto == DEC_FRAMES:
            assert int(g_n[r]) == int(w_n[r])
        rec["capture_rel"].append(rel)
        rec["close_calls"].append(None if upto == DEC_FRAMES else upto)
    print(f"decode_capture card vs CPU, 2 clips: activations max|Δ|/max "
          f"{rec['capture_rel']} (bound 1e-4), tokens equal up to the first close call "
          f"{rec['close_calls']}, n_valid {w_n.tolist()} on {card}")

    st = special_tokens(cpu_rt.dims.n_vocab)
    prompt = torch.tensor([st.sot_sequence(0)] * len(wavs))
    variant, cfg, _, sae_cpu = load_sae(str(ckpt))
    _, _, _, sae_card = load_sae(str(ckpt), device)
    fn = sae_steer_fn(variant, cfg)
    with torch.inference_mode():  # the feature most often on top in the capture
        top = topk_mod.pre_acts(sae_cpu, w_acts).argmax(-1)
    feat = int(torch.bincount(top.flatten()).argmax())
    enc_card = encoded.to(device)
    rec["steered"] = {}
    for factor in (1.0, STEER_FACTOR):
        taps = {}
        for dev, sae in (("cpu", sae_cpu), (str(device), sae_card)):
            taps[dev] = (2, fn, (sae, torch.tensor(feat, device=dev),
                                 torch.tensor(factor, device=dev)))
        want = decoding.sample_decode(cpu_rt.decoder, cpu_rt.dims, encoded, prompt, 3,
                                      decoder_tap=taps["cpu"])[0]
        got = decoding.sample_decode(card_rt.decoder, card_rt.dims, enc_card,
                                     prompt.to(device), 3, decoder_tap=taps[str(device)])[0]
        m = decoding.decision_margins(cpu_rt.decoder, cpu_rt.dims, encoded, want, 3,
                                      decoder_tap=taps["cpu"])
        close = [int(np.argmax(r < DECODE_CLOSE_CALL)) if (r < DECODE_CLOSE_CALL).any()
                 else None for r in m]
        for r, c in enumerate(close):
            upto = want.shape[1] if c is None else c
            assert torch.equal(got[r, :upto].cpu(), want[r, :upto]), (factor, r, upto)
        rec["steered"][factor] = {"close_calls": close,
                                  "whole_rows_equal": bool(torch.equal(got.cpu(), want))}
        print(f"TopK-steered greedy (feature {feat}, factor {factor}) card vs CPU: tokens "
              f"equal up to the first close call {close}; whole rows equal "
              f"{rec['steered'][factor]['whole_rows_equal']} on {card}")

    # the tapped step against the substituted oracle, on the card
    tokens = w_tok[:, :12].to(device)
    t = tokens.shape[1]
    tp = (torch.tensor(0.9, device=device), torch.tensor(0.03, device=device))

    def affine(p, x):
        return x * p[0] + p[1]

    dec, dims = card_rt.decoder, card_rt.dims
    with torch.inference_mode():
        cross = decoding._cross_kv_stacks(dec, dims, enc_card)
        sk, sv = decoding._self_kv(dims, len(wavs), t, torch.float32, device)
        pos = torch.zeros((), dtype=torch.int64, device=device)
        rows = []
        for p in range(t):
            rows.append(decoding._decode_step(dec, dims, tokens[:, p], pos, sk, sv, cross,
                                              tap_layer=2, tap_fn=affine, tap_params=tp))
            pos += 1
        got = torch.stack(rows, 1)
        args = (dec, dims, tokens, enc_card)
        _, caps = decoder_forward(*args, capture=(DEC_LAYER,))
        oracle, _ = decoder_forward(*args, substitute={DEC_LAYER: affine(tp, caps[DEC_LAYER])})
    err = float(((got - oracle).abs() / (2e-3 + 2e-3 * oracle.abs())).max())
    rel = float((got - oracle).abs().max() / oracle.abs().max())
    print(f"tapped step vs substituted oracle on the card: max|Δ|/max {rel:.3e}, "
          f"worst |Δ| / (2e-3 + 2e-3|oracle|) {err:.3e} (bound 1) on {card}")
    assert err <= 1.0, err
    rec["tapped_step_rel"] = rel
    return rec


def large_decoder(torch, tmp: Path, wav_dir: Path, card: str, counters: dict) -> dict:
    """Phase 17: random:large-v3 (32 + 32 layers, 128 bands) decoder block
    16 over 8 30-s WAVs at batch 8 through the collection CLI (kernel #5
    32 times a batch: the whole encoder); ms a decode step (synchronised)
    and peak device memory; then a raw-channel tap at factor 1 on that
    batch gives tokens equal to the unsteered decode's."""
    from freud_tpu_torch.analysis.features import _raw_steer_tap
    from freud_tpu_torch.data.audio_dataset import AudioBatchPipeline
    from freud_tpu_torch.models.whisper import WhisperRuntime

    base = json.loads((REPO / "configs/features/large_v3_block_16_dev.json").read_text())
    cfg = {**base, "whisper_model": "random:large-v3", "layer_name": LARGE_DEC_LAYER,
           "batch_size": TRANSCRIBE_BATCH, "data_path": str(wav_dir),
           "out_folder": str(tmp / "dec_large")}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with timed_decodes(torch) as decodes:
        stats = collect(cfg, tmp / "dec_large.json")
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got = {k: fn.launches for k, fn in counters.items()}
    n_files = TRANSCRIBE_LONG
    print(f"random:large-v3 {LARGE_DEC_LAYER} collection, batch {TRANSCRIBE_BATCH}: "
          f"{n_files} files in {stats['elapsed_s']:.3f} s (after model init), RTFx "
          f"{stats['rtfx']:.1f}, decode {ms_a_step(decodes):.3f} ms a step (synchronised, "
          f"steps {decodes['steps']}), peak device memory {peak:.3f} GiB, launches {got} "
          f"on {card}")
    assert got == {"log_mel": 1, "fused_qkv_attention": 0, "whisper_attention": 32}, got
    names = sorted(str(p) for p in wav_dir.glob("*.wav"))
    check_decoder_store(Path(cfg["out_folder"]), LARGE_DEC_LAYER, n_files, LARGE_D, names)
    free_device_memory(torch)

    rt = WhisperRuntime("random:large-v3", LARGE_DEC_LAYER, device="cuda")
    mels = next(iter(AudioBatchPipeline(str(wav_dir), TRANSCRIBE_BATCH, rt.dims.n_mels,
                                        device="cuda")))[0]
    encoded = rt.encode(mels)
    prompt, n_prompt = rt._prompt(encoded)
    plain = rt._decode(encoded, prompt, n_prompt)[0]
    tap = (16, _raw_steer_tap, (torch.tensor(7, device="cuda"),
                                torch.tensor(1.0, device="cuda")))
    steered = rt._decode(encoded, prompt, n_prompt, decoder_tap=tap)[0]
    print(f"random:large-v3 raw-channel tap at factor 1 on block 16: tokens equal to the "
          f"unsteered decode: {np.array_equal(plain, steered)} ({plain.shape})")
    assert np.array_equal(plain, steered)
    del rt, mels, encoded
    free_device_memory(torch)
    return {"rtfx": stats["rtfx"], "elapsed_s": stats["elapsed_s"],
            "decode_ms_a_step": ms_a_step(decodes), "peak_gib": peak, "launches": got}


# ------------------------------------------------------ analytics and serving


def run_index_cli(tmp: Path, folder: Path, layer: str) -> float:
    """``python -m freud_tpu_torch.scripts.index_activations --config ...``
    in this process over ``folder``'s ``layer`` store → its seconds."""
    from freud_tpu_torch.scripts import index_activations

    cfg_path = tmp / f"index_{folder.name}.json"
    cfg_path.write_text(json.dumps({"out_folder": str(folder), "layer_name": layer}))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        index_activations.main(["--config", str(cfg_path)])
    return time.perf_counter() - t0


def store_mb(folder: Path, layer: str) -> float:
    """The store's array bytes (dense rows, or values and indices), in MB."""
    names = (f"{layer}_tensors.npy", f"{layer}_activation_values.npy",
             f"{layer}_feature_indices.npy")
    return sum((folder / n).stat().st_size for n in names if (folder / n).exists()) / 1e6


@contextlib.contextmanager
def hidden_index(folder: Path, layer: str):
    """Move ``layer``'s feature-major index out of ``folder`` while the block
    runs, so search scans the store."""
    away = folder.parent / f"{folder.name}_index_away"
    away.mkdir(exist_ok=True)
    moved = list(folder.glob(f"{layer}_feature_major*"))
    for p in moved:
        p.rename(away / p.name)
    try:
        yield
    finally:
        for p in moved:
            (away / p.name).rename(p)


def same_search(a, b) -> None:
    """Two ``top_activations`` results: the same files in the same order,
    equal values and times, bit-equal traces and per-file maxima."""
    assert [(f, v, t) for f, _, v, t in a[0]] == [(f, v, t) for f, _, v, t in b[0]]
    for (_, x, _, _), (_, y, _, _) in zip(a[0], b[0]):
        assert np.array_equal(x, y)
    assert a[1] == b[1]


def timed(torch, fn, repeats: int) -> tuple[float, list[float], object]:
    """Median ms of ``repeats`` synchronised calls, every ms, the last result."""
    walls = []
    out = None
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(walls), walls, out


def search_store(torch, tmp: Path, folder: Path, layer: str, feats: list[int], card: str,
                 cpu_check: bool = True) -> dict:
    """Index ``folder``'s store with the index CLI (MB/s), then search it
    for each of ``feats`` (top 10, plain and abs-magnitude) on the card's
    fast path and scan, and the fast path on the CPU: all equal. → ms a
    query for each path (median of 3) and the build's MB/s."""
    from freud_tpu_torch.analysis.search import top_activations
    from freud_tpu_torch.data.loaders import MemoryMappedActivationLoader

    secs = run_index_cli(tmp, folder, layer)
    mb = store_mb(folder, layer)
    loader = MemoryMappedActivationLoader(str(folder), layer, batch_size=BATCH)
    for feat in feats:
        for absolute in (False, True):
            fast = top_activations(loader, feat, 10, absolute_magnitude=absolute)
            with hidden_index(folder, layer):
                scan = top_activations(loader, feat, 10, absolute_magnitude=absolute)
            same_search(fast, scan)
            if cpu_check:
                same_search(fast, top_activations(loader, feat, 10, device="cpu",
                                                  absolute_magnitude=absolute))
    fast_ms, fast_all, _ = timed(torch, lambda: top_activations(loader, feats[0], 10), 3)
    with hidden_index(folder, layer):
        scan_ms, scan_all, _ = timed(torch, lambda: top_activations(loader, feats[0], 10), 3)
    rec = {"files": len(loader.reader), "store_mb": mb, "index_build_s": secs,
           "index_build_mb_per_s": mb / secs, "fast_ms": fast_ms, "scan_ms": scan_ms,
           "fast_ms_all": fast_all, "scan_ms_all": scan_all}
    print(f"search over {folder.name} ({layer}, {rec['files']} files, {mb:.1f} MB): index "
          f"build {secs:.3f} s ({rec['index_build_mb_per_s']:.1f} MB/s); /top_files fast "
          f"path {fast_ms:.3f} ms, scan {scan_ms:.3f} ms a query on {card}; fast == scan "
          f"== CPU for features {feats}")
    return rec


def index_and_search(torch, tmp: Path, config: dict, card: str) -> dict:
    """Phase 18: the index CLI over phase 3's dense store and phase 7's
    indexed one, searched on the fast path and by scan on the card and on
    the CPU (equal); then a collection with ``build_index`` over one batch
    of files and a resumed one over all of them: the second adds a segment,
    and search stays on the fast path."""
    from freud_tpu_torch.analysis.search import top_activations
    from freud_tpu_torch.data import feature_store as fs
    from freud_tpu_torch.data.loaders import MemoryMappedActivationLoader

    recs = {"dense": search_store(torch, tmp, tmp / "card", LAYER, [0, 7, 383], card),
            "indexed": search_store(torch, tmp, tmp / "sae", LAYER, [0, 11, 6143], card)}
    grow = tmp / "grow"
    first = config["batch_size"]
    gcfg = {**config, "out_folder": str(grow), "collect_max": first, "build_index": True}
    collect(gcfg, tmp / "grow.json")
    assert len(fs.segment_paths(grow, LAYER)) == 1 and fs.index_is_current(grow, LAYER, first)
    stats = collect({**gcfg, "collect_max": None, "build_index": False, "resume": True},
                    tmp / "grow.json")
    n = first + stats["n_files"]
    assert len(fs.segment_paths(grow, LAYER)) == 2 and fs.index_is_current(grow, LAYER, n)
    loader = MemoryMappedActivationLoader(str(grow), LAYER, batch_size=BATCH)
    fast = top_activations(loader, 5, 10)
    with hidden_index(grow, LAYER):
        same_search(fast, top_activations(loader, 5, 10))
    print(f"collection with build_index over {first} files, then resumed to {n}: the index "
          f"grew a segment and search stays on its fast path")
    return recs


def start_server(config: dict, from_disk: bool, **kw):
    """The port's GUI server in this process on port 0 → (server, state)."""
    import threading

    from freud_tpu_torch.server.app import GuiState, create_server

    state = GuiState(config, from_disk=from_disk, **kw)
    server = create_server(state, host="127.0.0.1", port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, state


def stop_server(server) -> None:
    server.shutdown()
    server.server_close()


def http_request(server, method: str, path: str, body: bytes | None = None,
         headers: dict | None = None) -> tuple[int, dict, bytes]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=600)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        conn.close()


def multipart(data: bytes) -> tuple[bytes, dict]:
    body = (b'--b42\r\nContent-Disposition: form-data; name="audio"; filename="u.wav"\r\n'
            b"Content-Type: audio/wav\r\n\r\n" + data + b"\r\n--b42--\r\n")
    return body, {"Content-Type": "multipart/form-data; boundary=b42"}


def serve_requests(torch, server, requests: list[tuple], counters: dict, repeats: int,
                   card: str, label: str) -> dict:
    """Each (name, method, path, upload bytes or None, headers) request
    ``repeats`` times on the host's clock (the answer is on the host when
    it returns): its status, median ms and each kernel's launches in its
    first run. → {name: record}, bodies under "body"."""
    out = {}
    for name, method, path, data, headers in requests:
        body, hdrs = (multipart(data) if data is not None else (None, {}))
        walls, launches, last = [], None, None
        for _ in range(repeats):
            before = {k: fn.launches for k, fn in counters.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last = http_request(server, method, path, body, {**hdrs, **(headers or {})})
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            if launches is None:
                launches = {k: fn.launches - before[k] for k, fn in counters.items()}
        assert last[0] in (200, 206), (label, name, last[0], last[2][:300])
        out[name] = {"status": last[0], "ms": statistics.median(walls), "ms_all": walls,
                     "launches": launches, "body": last[2]}
        print(f"  {label} {name}: {last[0]}, {out[name]['ms']:.3f} ms a request "
              f"(median of {repeats}: {[round(w, 3) for w in walls]}) on {card}; "
              f"launches {launches}")
    return out


def device_share(torch, server, method: str, path: str, data: bytes | None) -> dict:
    """One request under torch.profiler (its CUDA activity holds every
    thread's kernels, the server's included): the kernels' ms, the wall
    and the device-busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    body, hdrs = multipart(data) if data is not None else (None, {})
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        http_request(server, method, path, body, hdrs)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kernel_ms = sum(e.device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA) / 1e3
    return {"wall_ms": wall, "kernel_ms": kernel_ms, "device_busy": kernel_ms / wall}


def check_out_of_range(server, n_features: int, upload: bytes) -> None:
    """Out-of-range indices answer 400 before any device work (a
    device-side assert would poison the CUDA context), and the next
    request still answers 200."""
    for bad in (f"/top_files?feature_idx={n_features}",):
        assert http_request(server, "GET", bad)[0] == 400, bad
        assert http_request(server, "GET", "/top_files?feature_idx=1&n_files=1")[0] == 200
    for bad in (f"/manipulate_feature?feat_idx={n_features}",
                f"/top_features?top_n={n_features + 1}"):
        assert http_request(server, "POST", bad, *multipart(upload))[0] == 400, bad
        assert http_request(server, "POST", "/top_features?top_n=2", *multipart(upload))[0] == 200


def serving_tiny(torch, tmp: Path, config: dict, clips, audio_dir: Path, counters: dict,
                 card: str) -> dict:
    """Phase 19: the port's GUI server on the card, in this process on port
    0, at random:tiny width: from disk over phase 3's store (no SAE), over
    phase 7's indexed store with phase 5's TopK checkpoint, in fly mode over
    the WAVs with the tiny_l1 checkpoint, and from disk over phase 14's
    decoder.blocks.2 store. Each request timed (median of 3) with its
    kernel launches; one profiled request an endpoint; no SAE at factor 1
    gives three equal texts; card against CPU on 2 clips; an out-of-range
    request answers 400 and the next one 200."""
    upload = Path(clips[0][0]).read_bytes()  # a 30-s clip
    audio_path = "/audio" + clips[1][0]
    topk_ckpt = tmp / "run_topk" / "checkpoints" / "bestval.pth"
    l1_ckpt = tmp / "run_l1" / "checkpoints" / "step4.pth"
    setups = [
        ("disk", {**config, "out_folder": str(tmp / "card")}, True, ["scan", "indexed"]),
        ("disk_topk", {**config, "out_folder": str(tmp / "sae"),
                       "sae_model": str(topk_ckpt)}, True, ["scan", "indexed"]),
        ("fly_l1", {**config, "sae_model": str(l1_ckpt)}, False, ["scan"]),
        ("disk_decoder", {**config, "layer_name": DEC_LAYER,
                          "out_folder": str(tmp / "dec_0")}, True, ["scan"]),
    ]
    recs = {}
    for label, cfg, from_disk, searches in setups:
        t0 = time.perf_counter()
        server, state = start_server(cfg, from_disk)
        state.runtime.decoder  # built at first use: with the server, not in a request
        init_s = time.perf_counter() - t0
        assert state.device.type == "cuda" and state.runtime.device.type == "cuda"
        n = state.n_features
        feat = 5
        # decode-bound requests twice, the rest three times; factor 1 (the
        # three-equal-texts check) and /transcribe on the first setup only
        requests = [("status", "GET", "/status", None, None, 3)]
        for kind in searches:
            requests.append((f"top_files_{kind}", "GET",
                             f"/top_files?feature_idx={feat}&n_files=10", None, None, 3))
        if label == "disk":
            requests.append(("audio_range", "GET", audio_path, None,
                             {"Range": "bytes=0-65535"}, 3))
        requests.append(("top_features", "POST", "/top_features?top_n=32", upload, None, 3))
        for factor in ((1, 8) if label == "disk" else (8,)):
            requests.append((f"manipulate_x{factor}", "POST",
                             f"/manipulate_feature?feat_idx={feat}&manipulation_factor={factor}",
                             upload, None, 2))
        if label == "disk":
            requests.append(("transcribe", "POST", "/transcribe", upload, None, 2))
        rec = {}
        for name, method, path, data, headers, repeats in requests:
            ctx = (hidden_index(Path(cfg["out_folder"]), cfg["layer_name"])
                   if name == "top_files_scan" and from_disk else contextlib.nullcontext())
            with ctx:
                rec.update(serve_requests(torch, server, [(name, method, path, data, headers)],
                                          counters, repeats, card, label))
        status = json.loads(rec["status"]["body"])
        assert status["n_features"] == n and status["layer_name"] == cfg["layer_name"]
        if "top_files_indexed" in rec:
            assert rec["top_files_indexed"]["body"] == rec["top_files_scan"]["body"]
        if label == "disk":
            assert rec["audio_range"]["status"] == 206
            assert rec["audio_range"]["body"] == Path(clips[1][0]).read_bytes()[:65536]
            texts = json.loads(rec["manipulate_x1"]["body"])
            three = {texts[k] for k in ("baseline_text", "manipulated_text", "standard_text")}
            print(f"  disk, no SAE, factor 1: three equal texts: {len(three) == 1}")
            assert len(three) == 1, three
        # the upload's log-mel is kernel #1 on the card, once a request; #2
        # runs 3 times a capture to block 2 (the whole encoder, 4, before a
        # decoder capture) and 4 times a decode's encoder, substituted or not
        decoder = label == "disk_decoder"
        capture = 4 if decoder else 3
        want = {"top_features": capture, "transcribe": 4,
                "manipulate_x1": capture + 4 * (2 if decoder else 3)}
        want["manipulate_x8"] = want["manipulate_x1"]
        for name, n_attn in want.items():
            if name in rec:
                got = rec[name]["launches"]
                assert got == {"log_mel": 1, "fused_qkv_attention": n_attn,
                               "whisper_attention": 0}, (label, name, got)
        if label == "fly_l1":
            n_batches = -(-len(clips) // cfg["batch_size"])
            got = rec["top_files_scan"]["launches"]
            assert got["log_mel"] == n_batches and \
                got["fused_qkv_attention"] == 3 * n_batches, got
        shares = {}
        if label == "disk":
            with hidden_index(Path(cfg["out_folder"]), cfg["layer_name"]):
                shares = {name: device_share(torch, server, method, path, data)
                          for name, method, path, data, _, _ in requests
                          if name in ("top_files_scan", "top_features", "manipulate_x8",
                                      "transcribe")}
            print(f"  {label} device busy a request: "
                  f"{ {k: round(v['device_busy'], 4) for k, v in shares.items()} }")
        check_out_of_range(server, n, upload)
        stop_server(server)
        recs[label] = {"init_s": init_s, "device_share": shares,
                       **{k: {kk: vv for kk, vv in v.items() if kk != "body"}
                          for k, v in rec.items()}}
        del state
        free_device_memory(torch)

    # card against CPU on 2 clips: /top_files payloads identical (the
    # store's values), /top_features traces within the store gate
    cmp = {}
    for dev in ("cuda", "cpu"):
        server, _ = start_server({**config, "out_folder": str(tmp / "card"), "device": dev},
                                 True, files_to_search=2)
        files = http_request(server, "GET", "/top_files?feature_idx=7&n_files=2")
        feats = [json.loads(http_request(server, "POST", "/top_features?top_n=32",
                                 *multipart(Path(p).read_bytes()))[2]) for p, _ in clips[:2]]
        cmp[dev] = (files, feats)
        stop_server(server)
    assert cmp["cuda"][0][0] == cmp["cpu"][0][0] == 200
    assert cmp["cuda"][0][2] == cmp["cpu"][0][2], "card and CPU /top_files differ"
    worst = 0.0
    for got, want in zip(cmp["cuda"][1], cmp["cpu"][1]):
        scale = max(np.abs(np.asarray(want["top_activations"])).max(), 1e-30)
        common = [i for i in got["top_indices"] if i in want["top_indices"]]
        assert len(common) >= 16, (got["top_indices"], want["top_indices"])
        for i in common:
            a = np.asarray(got["top_activations"][got["top_indices"].index(i)])
            b = np.asarray(want["top_activations"][want["top_indices"].index(i)])
            worst = max(worst, float(np.abs(a - b).max() / scale))
    print(f"server card vs CPU, 2 clips: /top_files identical; /top_features traces "
          f"max|Δ|/max|cpu| {worst:.3e} (bound {CARD_VS_CPU_TOL})")
    assert worst < CARD_VS_CPU_TOL, worst
    recs["card_vs_cpu_top_features_rel"] = worst
    free_device_memory(torch)
    return recs


def serving_large(torch, tmp: Path, store: Path, wav_dir: Path, ckpt: Path,
                  counters: dict, card: str, model: str = "random:large-v1") -> dict:
    """Phase 20: the index CLI and search over phase 8's random:large-v1
    store (block 16), then the GUI server from disk over it with phase 10's
    large_v1_audioset TopK checkpoint: /status, /top_files on both paths,
    one /top_features and one /manipulate_feature (median of 2), kernel #5
    launched 17 times a capture and 32 times a decode's encoder, the SAE
    encode's selection once a request. The
    server's decode budget is cut to LARGE_SERVER_MAX_NEW tokens to stay
    within the time limit."""
    width = json.loads((store / f"{LARGE_LAYER}_metadata.json").read_text())[
        "activation_shape"][-1]
    feat = width // 2
    search = search_store(torch, tmp, store, LARGE_LAYER, [0, feat, width - 1], card,
                          cpu_check=False)
    cfg = {**json.loads((REPO / "configs/features/large_v1_block_16_audioset_train.json")
                        .read_text()),
           "whisper_model": model, "layer_name": LARGE_LAYER, "out_folder": str(store),
           "sae_model": str(ckpt)}
    t0 = time.perf_counter()
    server, state = start_server(cfg, True)
    state.runtime.decoder  # built at first use: with the server, not in a request
    init_s = time.perf_counter() - t0
    state.runtime.max_new_tokens = LARGE_SERVER_MAX_NEW
    from freud_tpu_torch.ops.topk_indexed import topk_indexed

    upload = (wav_dir / "clip000.wav").read_bytes()
    counters = {**counters, "topk_indexed": topk_indexed}  # the SAE encode's selection
    rec = serve_requests(torch, server, [("status", "GET", "/status", None, None),
                                         ("top_files_indexed", "GET",
                                          f"/top_files?feature_idx={feat}&n_files=10", None, None)],
                         counters, 3, card, "large")
    with hidden_index(store, LARGE_LAYER):
        rec.update(serve_requests(torch, server, [
            ("top_files_scan", "GET", f"/top_files?feature_idx={feat}&n_files=10", None, None)],
            counters, 3, card, "large"))
    assert rec["top_files_scan"]["body"] == rec["top_files_indexed"]["body"]
    rec.update(serve_requests(torch, server, [
        ("top_features", "POST", "/top_features?top_n=32", upload, None),
        ("manipulate_x8", "POST", f"/manipulate_feature?feat_idx={feat}&manipulation_factor=8",
         upload, None)], counters, 2, card, "large"))
    # #5 once a block: to block 16 for a capture, all 32 for a decode's encoder
    capture = int(LARGE_LAYER.rsplit(".", 1)[-1]) + 1
    whole = state.runtime.dims.n_audio_layer
    assert rec["top_features"]["launches"] == {
        "log_mel": 1, "fused_qkv_attention": 0, "whisper_attention": capture,
        "topk_indexed": 1}, rec
    assert rec["manipulate_x8"]["launches"] == {
        "log_mel": 1, "fused_qkv_attention": 0, "whisper_attention": capture + 3 * whole,
        "topk_indexed": 1}, rec
    feats = json.loads(rec["top_features"]["body"])
    assert len(feats["top_indices"]) == 32
    assert all(np.isfinite(t).all() and len(t) == 1500 for t in feats["top_activations"])
    m = json.loads(rec["manipulate_x8"]["body"])
    assert np.allclose(np.asarray(m["manipulated_activations"]),
                       8 * np.asarray(m["standard_activations"]), rtol=1e-6)
    shares = {"manipulate_x8": device_share(torch, server, "POST",
                                            f"/manipulate_feature?feat_idx={feat}&"
                                            "manipulation_factor=8", upload),
              "top_features": device_share(torch, server, "POST", "/top_features?top_n=32",
                                           upload)}
    print(f"  large device busy a request: "
          f"{ {k: round(v['device_busy'], 4) for k, v in shares.items()} }")
    stop_server(server)
    del state
    free_device_memory(torch)
    return {"search": search, "init_s": init_s, "max_new_tokens": LARGE_SERVER_MAX_NEW,
            "device_share": shares,
            **{k: {kk: vv for kk, vv in v.items() if kk != "body"} for k, v in rec.items()}}


# ---------------------------------------------------------------- long form


def mel_gate(got, want) -> tuple[float, float]:
    """The log-mel gate: max |Δ| < 2e-3 and fewer than 1e-5 of the bins off
    by more than 3e-4. → (max |Δ|, share of bins off by more than 3e-4)."""
    d = np.abs(got - want)
    worst, share = float(d.max()), float((d > 3e-4).mean())
    assert worst < 2e-3 and share < 1e-5, (worst, share)
    return worst, share


def long_form_record(torch, rec: dict, stats: dict, launches: dict, audio_s: float,
                     expect: dict, name: str, card: str) -> dict:
    """One long-form CLI run's numbers: windows (``window_encode`` spans),
    rungs a window (decodes ÷ windows), ms a decode step, ms an alignment
    pass, RTFx after model init; the launches asserted against ``expect``
    ({counter: launches a window}); whisper's rules on every decoded row;
    every file's segments timed inside the recording and its 30-s tail."""
    from freud_tpu_torch.models.whisper import special_tokens

    windows = stats["window_encode"]["count"]
    decodes = rec["decodes"]
    assert windows > 0 and len(decodes) == stats["decode"]["count"] >= windows
    for k, per_window in expect.items():
        assert launches[k] == per_window * windows, (name, k, launches, windows)
    st = special_tokens(rec["n_vocab"])
    for d in decodes:
        check_token_rows(d["tokens"], d["n_prompt"], st)
    n_segments = n_words = 0
    for f, res in rec["result"].items():
        assert isinstance(res, dict) and set(res) == {"text", "segments", "language"}, f
        for seg in res["segments"]:
            assert 0.0 <= seg["start"] <= seg["end"] <= audio_s + 30.0, seg
            n_words += len(seg.get("words", []))
        n_segments += len(res["segments"])
    assert n_segments > 0, name
    out = {"windows": windows, "rungs_per_window": len(decodes) / windows,
           "ms_per_step": statistics.median(1e3 * d["seconds"] / d["steps"] for d in decodes),
           "steps_per_decode": statistics.median(d["steps"] for d in decodes),
           "align_ms_per_window": stats.get("align", {}).get("mean_ms"),
           "rtfx": audio_s / rec["seconds"], "seconds": rec["seconds"], "audio_s": audio_s,
           "segments": n_segments, "words": n_words, "launches": launches,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"long-form {name}: {audio_s:.1f} s of audio in {rec['seconds']:.3f} s after model "
          f"init (RTFx {out['rtfx']:.2f}), {windows} windows, "
          f"{out['rungs_per_window']:.2f} rungs a window, median {out['ms_per_step']:.3f} ms "
          f"a decode step ({out['steps_per_decode']} steps a decode), alignment "
          f"{out['align_ms_per_window']} ms a window, {n_segments} segments, {n_words} "
          f"words, launches {launches}, peak {out['peak_gib']:.3f} GiB on {card}")
    return out


def long_form_cli(torch, tmp: Path, wav_dir: Path, audio_s: float, model: str, extra: list,
                  counters: dict, expect: dict, name: str, card: str) -> dict:
    """The transcribe CLI's ``--long --word_timestamps --output_format srt``
    over ``wav_dir`` with the full temperature ladder, the counters set to 0
    just before and read just after; every file's srt written and holding
    cues."""
    from freud_tpu_torch import profiling

    srt_dir = tmp / f"srt_{name.replace(' ', '_')}"
    args = ["--data_path", str(wav_dir), "--model", model, "--long", "--word_timestamps",
            "--output_format", "srt", "--output_dir", str(srt_dir), *extra]
    for fn in counters.values():
        fn.launches = 0
    profiling.reset()
    torch.cuda.reset_peak_memory_stats()
    rec = run_transcribe(torch, args, tmp / "long.json", warm_align=True)
    launches = {k: fn.launches for k, fn in counters.items()}
    out = long_form_record(torch, rec, profiling.stats(), launches, audio_s, expect, name, card)
    for f in rec["result"]:
        assert "-->" in (srt_dir / (Path(f).stem + ".srt")).read_text(encoding="utf-8"), f
    free_device_memory(torch)
    return out


def long_form_card_vs_cpu(torch, device, wav: str, card: str) -> dict:
    """Phase 22: random:tiny on the card and on the CPU over one 45-s clip
    at t = 0 with word timestamps, conditioned on the previous windows'
    text (the left-padded prompt with ``start``): ``full_log_mel`` within
    the log-mel gate; each window's prompt equal and its tokens equal up to
    the first CPU post-rules top-two margin under DECODE_CLOSE_CALL (the
    left-padded row cut at ``start``, which decodes as the unpadded prompt);
    the word lists equal on the windows whose tokens are wholly equal (times
    exactly, probabilities within WORD_PROB_REL relative). Then one window's
    work on the card under torch.profiler: the device-busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from freud_tpu_torch.audio.decode import load_audio
    from freud_tpu_torch.models.whisper import WhisperRuntime, decoding
    from freud_tpu_torch.models.whisper import long_audio as la

    audio = load_audio(wav)
    t0 = time.perf_counter()
    mel_card = la.full_log_mel(audio, 80, device)
    torch.cuda.synchronize()
    mel_s = time.perf_counter() - t0
    worst, share = mel_gate(mel_card.cpu().numpy(), la.full_log_mel(audio, 80, "cpu").numpy())
    mel_ms = cuda_ms(lambda: la.full_log_mel(audio, 80, device), warmup=2, reps=10)
    minutes = len(audio) / 16000 / 60
    print(f"full_log_mel card vs CPU, {len(audio) / 16000:.1f} s: max|Δ| {worst:.3e}, "
          f"share over 3e-4 {share:.3e} (gate 2e-3, 1e-5); {mel_ms:.3f} ms "
          f"({mel_ms / minutes:.3f} ms a minute of audio; first call {1e3 * mel_s:.1f} ms "
          f"with the host's framing) on {card}")

    rts = {dev: WhisperRuntime("random:tiny", max_new_tokens=LONG_CV_MAX_NEW, device=dev)
           for dev in (device, torch.device("cpu"))}
    windows = {dev: [] for dev in rts}
    real = la._decode_window_with_fallback

    def spy(runtime, encoded, prompt, n_prompt, start, *a, key_base, **k):
        out = real(runtime, encoded, prompt, n_prompt, start, *a, key_base=key_base, **k)
        windows[runtime.device].append({
            "seek": key_base, "encoded": encoded.cpu(), "n_prompt": n_prompt,
            "start": 0 if start is None else int(start[0]), "tokens": out[0][0]})
        return out

    kw = dict(temperatures=(0.0,), word_timestamps=True)
    la._decode_window_with_fallback = spy
    try:
        res = {dev: rt.transcribe_long(audio, **kw) for dev, rt in rts.items()}
    finally:
        la._decode_window_with_fallback = real
    cpu_dev = torch.device("cpu")
    got_w, want_w = windows[device], windows[cpu_dev]
    equal_seeks, close_at = set(), None
    for i, (g, w) in enumerate(zip(got_w, want_w)):
        if (g["seek"], g["n_prompt"], g["start"]) != (w["seek"], w["n_prompt"], w["start"]):
            break  # an earlier window's close call moved this one
        assert np.array_equal(g["tokens"][:w["n_prompt"]], w["tokens"][:w["n_prompt"]]), i
        row = torch.from_numpy(w["tokens"][w["start"]:])[None]
        margins = decoding.decision_margins(rts[cpu_dev].decoder, rts[cpu_dev].dims,
                                            w["encoded"], row, w["n_prompt"] - w["start"])[0]
        close = np.flatnonzero(margins < DECODE_CLOSE_CALL)
        upto = w["start"] + (int(close[0]) if len(close) else row.shape[1])
        assert np.array_equal(g["tokens"][:upto], w["tokens"][:upto]), (i, upto)
        if not np.array_equal(g["tokens"], w["tokens"]):
            close_at = (i, upto)
            break
        equal_seeks.add(w["seek"])
    n_words, prob_rel = 0, 0.0
    for g, w in zip(res[device]["segments"], res[cpu_dev]["segments"]):
        if w["seek"] not in equal_seeks:
            continue
        assert (g["seek"], g["start"], g["end"], g["tokens"]) == \
            (w["seek"], w["start"], w["end"], w["tokens"])
        assert [(x["word"], x["start"], x["end"]) for x in g["words"]] == \
            [(x["word"], x["start"], x["end"]) for x in w["words"]], w["seek"]
        for x, y in zip(g["words"], w["words"]):
            prob_rel = max(prob_rel, abs(x["probability"] / y["probability"] - 1))
        n_words += len(w["words"])
    # a word's probability is the mean of softmax probabilities of the f32
    # teacher-forced logits, which the card holds within 1e-4 of max |logit|
    # of the CPU's (phase 12b): a log-probability moves by up to twice that
    assert prob_rel < WORD_PROB_REL, prob_rel
    assert equal_seeks or close_at, "no window compared"
    print(f"long-form card vs CPU, 45 s at t = 0: {len(want_w)} windows on the CPU, "
          f"{len(got_w)} on the card, {len(equal_seeks)} wholly equal (their {n_words} words "
          f"equal, probabilities within {prob_rel:.3e} relative, bound {WORD_PROB_REL}), "
          f"first close call (margin < {DECODE_CLOSE_CALL}) at "
          f"{close_at if close_at else 'none'} on {card}")

    rt = rts[device]
    st = rt._st

    def one_window():
        """The first window's work as ``transcribe_long`` does it: encode,
        prompt, the ladder's t = 0 rung, the alignment pass."""
        encoded = rt.encode(mel_card[None, :, :3000])
        prompt, n_prompt = rt._prompt(encoded)
        tokens = la._decode_window_with_fallback(
            rt, encoded, prompt, n_prompt, None, (0.0,), None, 2.4, -1.0, 0.6, st,
            key_base=0)[0]
        rt.align_words(encoded, [int(t) for t in tokens[0, n_prompt:] if t < st.eot],
                       num_frames=1500)

    one_window()  # warm
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_window()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kernel_ms = sum(e.device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA) / 1e3
    share = {"wall_ms": wall, "kernel_ms": kernel_ms, "device_busy": kernel_ms / wall}
    print(f"long-form profiled window (t = 0, word timestamps): {wall:.3f} ms wall, "
          f"{kernel_ms:.3f} ms of kernels, device busy {100 * kernel_ms / wall:.1f}% "
          f"on {card}")
    del rts
    free_device_memory(torch)
    return {"full_log_mel_ms": mel_ms, "full_log_mel_ms_per_minute": mel_ms / minutes,
            "mel_max_abs_diff": worst, "windows_cpu": len(want_w), "windows_card": len(got_w),
            "windows_equal": len(equal_seeks), "close_call": close_at,
            "words_equal": n_words, "word_prob_max_rel_diff": prob_rel,
            "profiled_window": share}


def serving_long(torch, tmp: Path, config: dict, upload: bytes, counters: dict,
                 card: str) -> dict:
    """Phase 24: the GUI server on the card (random:tiny from disk over
    phase 3's store, decode budget LONG_MAX_NEW_TINY) on port 0:
    ``/transcribe?long=1&word_timestamps=1&format=srt`` and the same 45-s
    upload without ``long`` (routed to the seek loop by its length), twice
    each: status 200, an srt body and a JSON body with timed segments,
    launches #1 0 and #2 four a window."""
    from freud_tpu_torch import profiling

    server, state = start_server({**config, "out_folder": str(tmp / "card")}, True)
    try:
        state.runtime.max_new_tokens = LONG_MAX_NEW_TINY
        state.runtime.decoder
        body, hdrs = multipart(upload)
        out = {}
        for name, path in (("long_srt", "/transcribe?long=1&word_timestamps=1&format=srt"),
                           ("over_30s", "/transcribe")):
            walls = []
            for fn in counters.values():
                fn.launches = 0
            profiling.reset()
            for _ in range(2):
                t0 = time.perf_counter()
                code, headers, answer = http_request(server, "POST", path, body, hdrs)
                walls.append(1e3 * (time.perf_counter() - t0))
                assert code == 200, (name, code, answer[:300])
            windows = profiling.stats()["window_encode"]["count"]
            launches = {k: fn.launches for k, fn in counters.items()}
            assert launches == {"log_mel": 0, "fused_qkv_attention": 4 * windows,
                                "whisper_attention": 0}, (name, launches, windows)
            if name == "long_srt":
                assert headers["Content-Type"].startswith("text/plain")
                assert "-->" in answer.decode("utf-8")
            else:
                res = json.loads(answer)
                assert set(res) == {"text", "segments", "language"} and res["segments"]
            out[name] = {"ms": statistics.median(walls), "ms_all": walls,
                         "windows_per_request": windows / 2, "launches": launches}
            print(f"  server long-form {name}: 200, {out[name]['ms']:.3f} ms a request "
                  f"({[round(w, 3) for w in walls]}), {windows / 2:g} windows a request, "
                  f"launches {launches} on {card}")
    finally:
        stop_server(server)
    free_device_memory(torch)
    return out


# ---------------------------------------------------------------------------
# phases 25-27: Whisper small, four layers from one encoder pass, sweeps


def check_attention_small(torch, device, card) -> dict:
    """Kernel #2 at Whisper small's width, its widest (d 768, 12 heads) and
    the multi-layer collection's batch (16, 1500): against its f32 plain
    version (2e-2 of max) and the bf16-rounded one (ATTN_BF16_GATE), two
    launches bit-equal, timed beside its bound and library yardstick."""
    from freud_tpu_torch import flops
    from freud_tpu_torch.ops.attention import (
        ATTN_BF16_GATE,
        fused_qkv_attention,
        fused_qkv_attention_plain,
    )

    gen = torch.Generator().manual_seed(SEED + 13)
    d, heads, b, s = SMALL_D, SMALL_HEADS, SMALL_BATCH, 1500
    w = [(torch.randn((d, d), generator=gen) * d ** -0.5).to(device) for _ in range(3)]
    w_model = [t.T.contiguous().T for t in w]
    bq, bv = ((torch.randn((d,), generator=gen) * 0.1).to(device) for _ in range(2))
    x = torch.randn((b, s, d), generator=gen).to(device)
    args = (x, w_model[0], bq, w_model[1], w_model[2], bv, heads)
    got = fused_qkv_attention(*args)
    again = fused_qkv_attention(*args)
    want = fused_qkv_attention_plain(*args)
    want_bf16 = fused_qkv_attention_plain(*args, matmul_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    max_err = (got - want).abs().max().item()
    rel = max_err / want.abs().max().item()
    rel_bf16 = ((got - want_bf16).abs().max() / want_bf16.abs().max()).item()
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert rel < 2e-2 and rel_bf16 < ATTN_BF16_GATE[torch.float32], (rel, rel_bf16)
    del got, again, want, want_bf16
    ms = cuda_ms(lambda: fused_qkv_attention(*args))
    plain_ms = cuda_ms(lambda: fused_qkv_attention_plain(*args), warmup=1, reps=5)
    lib_ms = cuda_ms(lambda: fused_library_call(torch, x, w, bq, bv, heads))
    core_ms = cuda_ms(fused_library_core(torch, x, w, heads))
    bound = flops.fused_qkv_attention_bound(b, s, d, heads)
    print(f"attention b={b} s={s} d={d} h={heads} f32 x: max|Δ|/max|ref| {rel:.3e} (bound "
          f"2e-2), against the bf16-rounded plain {rel_bf16:.3e} (bound "
          f"{ATTN_BF16_GATE[torch.float32]}), two launches bit-equal; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms (its core alone {core_ms:.4f}), "
          f"bound {bound.bound_ms:.4f} ms ({bound.bound_by}) on {card}")
    assert ms >= bound.bound_ms, (ms, bound.bound_ms)
    torch.cuda.empty_cache()
    return dict(shape=[b, s, d, heads], max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                max_rel_err_bf16_plain=rel_bf16, library_core_ms=core_ms,
                **yardsticks(bound, lib_ms, "F.linear + scaled_dot_product_attention on "
                             "kernel #2's own f32 inputs, as at tiny width"))


def check_topk_fused_small(torch, device, card, k: int = K) -> dict:
    """Kernel #4 at the sweep's step shape, d_in 768 → n_dict 12,288 over
    12,000 rows (8 files), a third of the latents dead, at ``k`` (32 in the
    per-layer sweeps; the grid also runs 16): acts within one
    bf16 ulp on < 1e-3 of entries, thresholds and ``fired`` bit-equal to
    the plain selection on the kernel's own acts, decodes within 1e-3 of
    max, two launches bit-equal; timed beside its bound."""
    from freud_tpu_torch import flops
    from freud_tpu_torch.ops.topk_fused import topk_sae_forward, topk_sae_forward_plain
    from freud_tpu_torch.ops.topk_threshold import topk_thresholds_fired_plain

    gen = torch.Generator().manual_seed(SEED + 14)
    m, d_in, n_dict, k_aux = SWEEP_ROWS, SMALL_D, SMALL_N_DICT, SMALL_D // 2
    x, w_enc, b_enc, b_dec, w_dec = _topk_inputs(torch, device, m, gen, d_in, n_dict)
    dead = (torch.rand((n_dict,), generator=gen) < 1 / 3).to(device)
    args = (x, w_enc.T, b_enc, b_dec, w_dec, dead.float(), k, k_aux)
    got = topk_sae_forward(*args)
    again = topk_sae_forward(*args)
    want = topk_sae_forward_plain(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    share, max_ulp = _acts_agreement(got[0], want[0], x, w_enc, b_dec)
    tm, ta, _, fired = topk_thresholds_fired_plain(got[0], dead, k, k_aux)
    assert torch.equal(got[3], tm) and torch.equal(got[4], ta) and torch.equal(got[5], fired)
    af = got[0].float()
    wb = w_dec.to(torch.bfloat16).float()
    y_main = torch.where(af >= tm, af, 0.0) @ wb
    y_aux = torch.where((af >= ta) & dead, af, 0.0) @ wb
    abs_err = max((got[1] - y_main).abs().max().item(), (got[2] - y_aux).abs().max().item())
    err = abs_err / max(y_main.abs().max().item(), y_aux.abs().max().item())
    selected = _selected(af, tm, ta, dead)
    assert max_ulp <= 1 and share < 1e-3, (share, max_ulp)
    assert err < 1e-3, err
    del got, again, want, af, y_main, y_aux
    ms = cuda_ms(lambda: topk_sae_forward(*args), reps=10)
    plain_ms = cuda_ms(lambda: topk_sae_forward_plain(*args), warmup=1, reps=5)
    bound = flops.topk_sae_forward_bound(m, d_in, n_dict, k, k_aux, selected)
    print(f"topk_sae_forward m={m} d_in={d_in} n_dict={n_dict} k={k}: acts differ on "
          f"{share:.2e} (bound 1e-3) by at most {max_ulp:.3f} ulp (bound 1), thresholds/fired "
          f"bit-equal, two launches bit-equal, decode max|Δ|/max|plain| {err:.3e} (bound "
          f"1e-3); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound.bound_ms:.4f} "
          f"ms ({bound.bound_by}; {selected} selected entries) on {card}")
    assert ms >= bound.bound_ms, (ms, bound.bound_ms)
    torch.cuda.empty_cache()
    return dict(shape=[m, d_in, n_dict, k, k_aux], max_abs_err=abs_err, ms=ms,
                plain_ms=plain_ms, **yardsticks(bound, None, "none: no one PyTorch call "
                                                "encodes, selects per row and decodes"))


def check_topk_threshold_small(torch, device, card) -> dict:
    """Kernel #3 at the multi_topk sweep's step shape: (12,000, 12,288)
    acts in f32 (the sweep's route) and bf16, a third of the latents dead
    and none dead, k 32, k_aux 384, k_multi 128. Thresholds and ``fired``
    bit-equal to the plain selection, two launches bit-equal; each dtype
    timed beside its plain version and its bound."""
    from freud_tpu_torch import flops
    from freud_tpu_torch.ops.topk_threshold import (
        topk_thresholds_fired,
        topk_thresholds_fired_plain,
    )

    gen = torch.Generator().manual_seed(SEED + 16)
    m, n_dict, k_aux = SWEEP_ROWS, SMALL_N_DICT, SMALL_D // 2
    kw = dict(k_multi=4 * K)
    a = torch.relu(torch.randn((m, n_dict), generator=gen)).to(device)
    a[5] = 0.0  # silent row
    a[6] = 0.5  # one tie across the row
    dead = (torch.rand((n_dict,), generator=gen) < 1 / 3).to(device)
    record: dict = {"shape": [m, n_dict, K, k_aux, 4 * K]}
    err = 0.0
    for name, acts in (("f32", a), ("bf16", a.to(torch.bfloat16))):
        for dname, dm in (("a third dead", dead), ("none dead", torch.zeros_like(dead))):
            got = topk_thresholds_fired(acts, dm, K, k_aux, **kw)
            again = topk_thresholds_fired(acts, dm, K, k_aux, **kw)
            want = topk_thresholds_fired_plain(acts, dm, K, k_aux, **kw)
            torch.cuda.synchronize()
            for g, g2, w in zip(got, again, want):
                assert torch.equal(g, w) and torch.equal(g, g2), (name, dname)
            err = max(err, _threshold_err(got, want))
            del got, again, want
        ms = cuda_ms(lambda: topk_thresholds_fired(acts, dead, K, k_aux, **kw), reps=10)
        plain_ms = cuda_ms(lambda: topk_thresholds_fired_plain(acts, dead, K, k_aux, **kw),
                           warmup=1, reps=3)
        bound = flops.topk_thresholds_bound(m, n_dict, in_bytes=acts.element_size())
        assert ms >= bound.bound_ms, (name, ms, bound.bound_ms)
        record[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound.bound_ms,
                            bound_by=bound.bound_by)
        print(f"topk_thresholds_fired {name} m={m} n_dict={n_dict} k={K} k_aux={k_aux} "
              f"k_multi={4 * K} (a third dead / none dead): thresholds and fired bit-equal "
              f"to plain, two launches bit-equal; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound.bound_ms:.4f} ms ({bound.bound_by}) on {card}")
    record.update(max_abs_err=err, **record["f32"], library_ms=None,
                  library="none: torch.topk gives t_main and t_multi only; t_aux and "
                  "fired are further calls")
    del a
    torch.cuda.empty_cache()
    return record


def rel_diff(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max())


def multilayer_collection(torch, tmp: Path, card: str, counters: dict) -> dict:
    """Phase 25: the collection CLI with four ``random:small`` layers (one
    encoder pass a batch: kernel #1 once, #2 12 times) over 36 30-s WAVs and
    an undecodable one at batch 16, ``build_index`` on. Each store against
    single-layer collections of blocks 11 and 2 on the card (1e-6 of max)
    and against the CPU on 2 files (CARD_VS_CPU_TOL); the launches counted
    by the wrappers and, in a profiled one-batch run, by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    from freud_tpu_torch.data import multilayer
    from freud_tpu_torch.data.feature_store import FeatureMajorReader

    wav_dir = tmp / "audio_small"
    wav_dir.mkdir()
    clips = write_wavs(wav_dir, [480000] * SMALL_FILES, broken=True, seed=SEED + 12)
    n_batches = -(-(len(clips) + 1) // SMALL_BATCH)
    out = tmp / "small_multi"
    config = {"whisper_model": "random:small", "layer_name": SMALL_LAYERS,
              "batch_size": SMALL_BATCH, "data_path": str(wav_dir), "out_folder": str(out),
              "build_index": True}
    cls = multilayer.MultiLayerActivationLoader
    real_init, real_index = cls.__init__, multilayer.extend_feature_major_index
    marks: dict[str, float] = {}

    def init_spy(self, *a, **k):  # the collection's clock starts after model init
        real_init(self, *a, **k)
        torch.cuda.synchronize()
        marks["ready"] = time.perf_counter()

    def index_spy(*a, **k):  # ... and stops at the index build
        marks.setdefault("index", time.perf_counter())
        return real_index(*a, **k)

    for fn in counters.values():
        fn.launches = 0
    cls.__init__, multilayer.extend_feature_major_index = init_spy, index_spy
    try:
        stats = collect(config, tmp / "small_multi.json")
        torch.cuda.synchronize()
        end = time.perf_counter()
    finally:
        cls.__init__, multilayer.extend_feature_major_index = real_init, real_index
    launches = {k: fn.launches for k, fn in counters.items()}
    seconds = marks["index"] - marks["ready"]
    rec = {"n_files": stats["n_files"], "batches": n_batches, "seconds": seconds,
           "ms_per_batch": 1e3 * seconds / n_batches, "rtfx": SMALL_FILES * 30.0 / seconds,
           "index_s": end - marks["index"], "launches": launches}
    print(f"multi-layer collection, random:small {SMALL_LAYERS} at batch {SMALL_BATCH}: "
          f"{stats['n_files']} files × 4 layers in {seconds:.3f} s after model init "
          f"({rec['ms_per_batch']:.1f} ms a batch, RTFx {rec['rtfx']:.1f}), then the 4 "
          f"indexes in {rec['index_s']:.3f} s; launches {launches} ({n_batches} "
          f"batches) on {card}")
    assert stats == {"n_files": SMALL_FILES, "layers": SMALL_LAYERS}, stats
    assert launches == {"log_mel": n_batches, "fused_qkv_attention": 12 * n_batches,
                        "whisper_attention": 0}, launches
    stores = {}
    for layer in SMALL_LAYERS:
        meta, rows = read_store(out, layer)
        assert rows.shape == (SMALL_FILES, 1500, SMALL_D), (layer, rows.shape)
        assert np.isfinite(rows).all(), layer
        assert meta["filenames"] == [p for p, _ in clips], layer  # the broken file absent
        assert meta["n_frames"] == [1500] * SMALL_FILES
        assert FeatureMajorReader.exists(out, layer), layer
        stores[layer] = rows
    # each layer against a single-layer collection of it on the card
    rec["single_layer_rel_diff"] = {}
    for layer in ("encoder.blocks.11", "encoder.blocks.2"):
        single = tmp / f"small_single_{layer}"
        collect({**config, "layer_name": layer, "out_folder": str(single),
                 "build_index": False}, tmp / "small_single.json")
        smeta, srows = read_store(single, layer)
        assert smeta["filenames"] == [p for p, _ in clips]
        diff = rel_diff(stores[layer], srows)
        rec["single_layer_rel_diff"][layer] = diff
        print(f"multi-layer {layer} against its single-layer collection: max|Δ|/max "
              f"{diff:.3e} (bound 1e-6)")
        assert diff <= 1e-6, (layer, diff)
        del srows
        free_device_memory(torch)
    # the card against the CPU plain path, 2 files
    cpu_layers = ["encoder.blocks.2", "encoder.blocks.11"]
    collect({**config, "layer_name": cpu_layers, "device": "cpu", "collect_max": 2,
             "out_folder": str(tmp / "small_cpu"), "build_index": False},
            tmp / "small_cpu.json")
    rec["card_vs_cpu"] = {}
    for layer in cpu_layers:
        cmeta, crows = read_store(tmp / "small_cpu", layer)
        assert cmeta["filenames"] == [p for p, _ in clips[:2]]
        diff = rel_diff(stores[layer][:2], crows)
        rec["card_vs_cpu"][layer] = diff
        print(f"card vs CPU plain path, random:small {layer}, 2 files: max|Δ|/max|cpu| "
              f"{diff:.3e} (bound {CARD_VS_CPU_TOL})")
        assert diff < CARD_VS_CPU_TOL, (layer, diff)
    # one batch under the profiler: the launches by kernel name, device ms
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        collect({**config, "collect_max": SMALL_BATCH, "out_folder": str(tmp / "small_prof"),
                 "build_index": False}, tmp / "small_prof.json")
        torch.cuda.synchronize()
    by_name = {name: sum(e.count for e in prof.key_averages() if name in e.key
                         and e.device_time_total > 0)
               for name in ("log10_mel_kernel", "qkv_projection_kernel")}
    kernels, busy, copies = device_ms_by_kernel(prof, 1)
    rec.update(profiled_launches=by_name, device_ms_per_batch=busy, copy_ms_per_batch=copies,
               device_ms_by_kernel=kernels)
    print(f"profiled one-batch run: launches by kernel name {by_name}; device {busy:.3f} ms "
          f"a batch of {SMALL_BATCH} (copies {copies:.3f} ms), top kernels "
          f"{ {k: round(v, 3) for k, v in list(kernels.items())[:5]} } on {card}")
    assert by_name == {"log10_mel_kernel": 1, "qkv_projection_kernel": 12}, by_name
    del stores
    free_device_memory(torch)
    return rec


def sweep_config(store_dir: str, out_dir: Path, **over) -> dict:
    """The sweeps' TopK recipe (tiny_topk's dictionary and k at Whisper
    small's width), AuxK active from step 2."""
    return {"data_path": store_dir, "variant": "topk",
            "autoencoder_config": {"expansion_factor": 16, "k": K, "auxk_alpha": 0.03125,
                                   "dead_feature_threshold": SWEEP_ROWS // 2},
            "batch_size": SWEEP_BATCH, "out_dir": str(out_dir), "lr": 1e-4,
            "optimizer": "adam", "scheduler": "linear",
            "scheduler_params": {"num_warmup_steps": 2}, "verbose": False, **over}


def sweep_cli(torch, tmp: Path, config: dict, name: str, counters: dict) -> tuple[dict, dict]:
    """The sweep CLI in this process; → (its stats, the kernels' launches
    in the run)."""
    for fn in counters.values():
        fn.launches = 0
    stats = run_cli("freud_tpu_torch.scripts.sweep", config, tmp / f"{name}.json")
    torch.cuda.synchronize()
    return stats, {k: fn.launches for k, fn in counters.items()}


def sweep_per_layer(torch, device, tmp: Path, store_dir: str, card: str,
                    counters: dict) -> dict:
    """Phase 26: per-layer sweeps over phase 25's four stores through the
    sweep CLI (TopK 20 steps: kernel #4 four times a step; L1 10 steps; a
    2-step multi_topk sweep: kernel #3 four times a step); the checkpoints;
    members 0 and 3 against solo trainers with their seeds on the same
    batches; the synchronised sweep step against a solo step."""
    from freud_tpu_torch.models.sae import sae_from_checkpoint
    from freud_tpu_torch.train.sweep import SAESweepTrainer
    from freud_tpu_torch.train.trainer import SAETrainer

    rec: dict = {}
    out = tmp / "sweep_topk"
    cfg = sweep_config(store_dir, out, layer_names=SMALL_LAYERS, steps=SWEEP_TOPK_STEPS)
    t0 = time.perf_counter()
    stats, launches = sweep_cli(torch, tmp, cfg, "sweep_topk", counters)
    rec["topk"] = {"steps": stats["steps"], "seconds": time.perf_counter() - t0,
                   "final_loss": stats["final"]["loss"], "launches": launches}
    print(f"per-layer TopK sweep, 4 members at d_in {SMALL_D} → {SMALL_N_DICT}, batch "
          f"{SWEEP_BATCH} files: {stats['steps']} steps in {rec['topk']['seconds']:.3f} s "
          f"(CLI, incl. init and checkpoints), final losses {stats['final']['loss']}; "
          f"launches {launches} on {card}")
    assert stats["steps"] == SWEEP_TOPK_STEPS and np.isfinite(stats["final"]["loss"]).all()
    assert launches["topk_sae_forward"] == 4 * SWEEP_TOPK_STEPS, launches
    assert launches["topk_thresholds_fired"] == 0, launches
    backward = [k for k in BACKWARD_PASSES if k in counters]
    assert all(launches[k] == 4 * SWEEP_TOPK_STEPS for k in backward), launches
    for layer in SMALL_LAYERS:
        variant, cfg_, act, params = sae_from_checkpoint(str(out / f"{layer}.pth"), "cpu")
        assert variant == "topk" and act == SMALL_D and cfg_.k == K, layer
        assert tuple(params.encoder_weight.shape) == (SMALL_N_DICT, SMALL_D)
        assert all(torch.isfinite(p).all() for p in params.parameters()), layer
    free_device_memory(torch)

    lbase = json.loads((REPO / "configs/train/tiny_l1.json").read_text())
    cfg = {**sweep_config(store_dir, tmp / "sweep_l1", layer_names=SMALL_LAYERS,
                          steps=SWEEP_L1_STEPS),
           "variant": "l1", "autoencoder_config": lbase["autoencoder_config"],
           "optimizer": lbase["optimizer"], "scheduler": lbase["scheduler"],
           "lr": lbase["lr"], "scheduler_params": {}}
    stats, launches = sweep_cli(torch, tmp, cfg, "sweep_l1", counters)
    rec["l1"] = {"steps": stats["steps"], "final_loss": stats["final"]["loss"],
                 "launches": launches}
    print(f"per-layer L1 sweep ({lbase['autoencoder_config']}): {stats['steps']} steps, "
          f"final losses {stats['final']['loss']}; launches {launches}")
    assert stats["steps"] == SWEEP_L1_STEPS and np.isfinite(stats["final"]["loss"]).all()
    assert all(launches[k] == 0 for k in backward), launches
    free_device_memory(torch)

    cfg = sweep_config(store_dir, tmp / "sweep_multi", layer_names=SMALL_LAYERS, steps=2)
    cfg["autoencoder_config"]["multi_topk"] = True
    stats, launches = sweep_cli(torch, tmp, cfg, "sweep_multi", counters)
    rec["multi_topk"] = {"steps": stats["steps"], "launches": launches}
    print(f"per-layer multi_topk sweep: {stats['steps']} steps; launches {launches}")
    assert stats["steps"] == 2 and np.isfinite(stats["final"]["loss"]).all()
    assert launches["topk_thresholds_fired"] == 4 * 2, launches
    assert all(launches[k] == 0 for k in backward), launches  # the autograd route
    free_device_memory(torch)

    # members against solo trainers on the same batches, then the step's time
    ae = sweep_config(store_dir, out)["autoencoder_config"]
    kw = dict(optimizer="adam", scheduler="linear", scheduler_params={"num_warmup_steps": 2},
              lr=1e-4, steps=100)
    rows = [read_store(Path(store_dir), layer)[1] for layer in SMALL_LAYERS]
    batches = [torch.from_numpy(np.stack([np.asarray(r[j * SWEEP_BATCH:(j + 1) * SWEEP_BATCH])
                                          for r in rows])).to(device)
               for j in range(SMALL_FILES // SWEEP_BATCH)]
    del rows
    sweep = SAESweepTrainer("topk", ae, SMALL_D, 4, seed=SEED, device="cuda", **kw)
    for s in range(5):
        sweep.train_step(batches[s % len(batches)])
    diffs = {}
    for i in (0, 3):
        solo = SAETrainer("topk", ae, SMALL_D, seed=SEED + i, device="cuda", **kw)
        for s in range(5):
            solo.train_step(batches[s % len(batches)][i])
        diffs[i] = max(float((a.detach().double() - b.detach().double()).abs().max()
                             / b.detach().double().abs().max().clamp(min=1e-30))
                       for a, b in zip(sweep.members[i]._state(), solo._state()))
    print(f"sweep members 0 and 3 against solo trainers after 5 steps: max|Δ|/max {diffs} "
          "(bound 1e-5; bit-equal expected)")
    assert max(diffs.values()) <= 1e-5, diffs
    rec["member_vs_solo_max_rel_diff"] = diffs

    def timed_steps(step, n: int = 8) -> float:
        times = []
        for s in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(s)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
        return statistics.median(times)

    torch.cuda.reset_peak_memory_stats()
    sweep_ms = timed_steps(lambda s: sweep.train_step(batches[s % len(batches)]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    solo_ms = timed_steps(lambda s: solo.train_step(batches[s % len(batches)][3]))
    rec.update(sweep_step_ms=sweep_ms, solo_step_ms=solo_ms, sweep_over_4_solo=sweep_ms /
               (4 * solo_ms), peak_gib=peak)
    print(f"per-layer TopK sweep step (4 members, synchronised, median of 8): "
          f"{sweep_ms:.3f} ms against a solo step {solo_ms:.3f} ms (ratio to 4 solo "
          f"steps {rec['sweep_over_4_solo']:.3f}), peak device memory {peak:.3f} GiB on {card}")
    del sweep, solo, batches
    free_device_memory(torch)
    return rec


def grid_graph_against_eager(torch, store_dir: str, hps: list, n_steps: int = 5) -> dict:
    """One k-group of the grid (its members' own lr and auxk_alpha) as a
    CUDA-graph chunk of ``n_steps`` against the same steps run eagerly from
    the same state on the same window rows: every member's parameters,
    moments, count, counters and the last step's metrics. A second replay
    repeats the first and launches kernel #4 once a member a step."""
    from freud_tpu_torch.data.device_cache import DeviceShuffleCache, sample_rows
    from freud_tpu_torch.ops.topk_fused import topk_sae_forward
    from freud_tpu_torch.train.sweep import SAESweepTrainer

    ae = sweep_config(store_dir, Path("."))["autoencoder_config"]
    tr = SAESweepTrainer("topk", ae, SMALL_D, len(hps), optimizer="adam", scheduler="linear",
                         scheduler_params={"num_warmup_steps": 2}, lr=1e-4, steps=100,
                         seed=SEED, model_hparams=hps, device="cuda")
    cache = DeviceShuffleCache(store_dir, GRID_LAYER, 10 ** 6, refresh_files=0, seed=SEED,
                               device="cuda")
    try:
        tr.train_step_shared(cache.next_batch(SWEEP_BATCH))  # dead latents: AuxK runs
        gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
        idx = torch.randint(0, cache.capacity, (n_steps, SWEEP_BATCH), generator=gen,
                            device="cuda")
        start = [t.clone() for t in tr._state()]

        def restore():
            with torch.no_grad():
                for t, s in zip(tr._state(), start):
                    t.copy_(s)

        runs = []
        for _ in range(2):  # the first call captures (after its warm-up step)
            restore()
            before = topk_sae_forward.launches
            m = tr.train_chunk_shared(cache.sample_state()[0], idx)
            torch.cuda.synchronize()
            runs.append(([t.clone() for t in tr._state()], m,
                         topk_sae_forward.launches - before))
        restore()
        for i in range(n_steps):
            eager_m = tr._step_all(sample_rows(cache.cache, idx[i]), shared=True)
        eager_state = [t.clone() for t in tr._state()]
    finally:
        cache.close()
    (g_state, g_m, _), (r_state, r_m, replay_launches) = runs
    worst = 0.0
    for g, r, e in zip(g_state, r_state, eager_state):
        assert torch.equal(g, r), "two replays differ"
        g, e = g.detach().double(), e.detach().double()
        worst = max(worst, float((g - e).abs().max() / e.abs().max().clamp(min=1e-30)))
    for k in eager_m:
        assert torch.equal(g_m[k], r_m[k]), k
        worst = max(worst, float((g_m[k].double() - eager_m[k].double()).abs().max()
                                 / eager_m[k].double().abs().max().clamp(min=1e-30)))
    print(f"grid group k={hps[0]['k']} ({len(hps)} members) chunk of {n_steps} at batch "
          f"{SWEEP_BATCH}: graph vs eager {'bit-equal' if worst == 0 else f'{worst:.3e}'} "
          f"(bound 1e-6); kernel #4 launches a replay {replay_launches}")
    assert worst <= 1e-6, worst
    assert replay_launches == len(hps) * n_steps, replay_launches
    del tr
    return {"bit_equal": worst == 0.0, "max_rel_diff": worst, "replay_launches": replay_launches}


def sweep_grid(torch, tmp: Path, store_dir: str, card: str, counters: dict) -> dict:
    """Phase 27: the grid sweep CLI on the ``encoder.blocks.11`` store
    through a 24-file device cache: 2 k-groups of 4 members, 2 chunks of 10
    (CUDA graphs) and a 5-step tail; both groups read the identical index
    tensor of each chunk and the same tail batch; 8 checkpoints with JAX's
    tags; one group's chunk against eager steps."""
    from freud_tpu_torch.models.sae import sae_from_checkpoint
    from freud_tpu_torch.train import sweep as sweep_mod

    cls = sweep_mod.SAESweepTrainer
    real_chunk, real_step = cls.train_chunk_shared, cls.train_step_shared
    calls: dict = {"chunk": [], "step": []}

    def chunk_spy(self, window, indices):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = real_chunk(self, window, indices)
        torch.cuda.synchronize()
        calls["chunk"].append((self.cfg.k, indices,
                               1e3 * (time.perf_counter() - t) / indices.shape[0]))
        return got

    def step_spy(self, batch):
        calls["step"].append((self.cfg.k, batch))
        return real_step(self, batch)

    out = tmp / "sweep_grid"
    cfg = sweep_config(store_dir, out, layer_name=GRID_LAYER, grid=GRID, steps=GRID_STEPS,
                       device_cache_files=GRID_CACHE_FILES, fused_steps=GRID_CHUNK)
    cls.train_chunk_shared, cls.train_step_shared = chunk_spy, step_spy
    try:
        stats, launches = sweep_cli(torch, tmp, cfg, "sweep_grid", counters)
    finally:
        cls.train_chunk_shared, cls.train_step_shared = real_chunk, real_step
    hps = sweep_mod.expand_grid(GRID)
    ks = sorted({hp["k"] for hp in hps})
    n_chunks, tail = GRID_STEPS // GRID_CHUNK, GRID_STEPS % GRID_CHUNK
    per_group = len(hps) // len(ks)
    ms_chunk_step = {k: [round(ms, 3) for kk, _, ms in calls["chunk"] if kk == k] for k in ks}
    rec = {"steps": stats["steps"], "models": stats["models"], "launches": launches,
           "ms_per_chunk_step": ms_chunk_step}
    print(f"grid sweep {GRID} through a {GRID_CACHE_FILES}-file cache: {stats['steps']} "
          f"steps; ms a step in each chunk (synchronised; the first captures) by k "
          f"{ms_chunk_step}; launches {launches} on {card}")
    assert stats["steps"] == GRID_STEPS and len(stats["models"]) == len(hps)
    assert all(np.isfinite(m["final_loss"]) for m in stats["models"])
    assert [k for k, _, _ in calls["chunk"]] == ks * n_chunks, calls["chunk"]
    for c in range(n_chunks):  # one index tensor a chunk, read by every group
        group = calls["chunk"][c * len(ks):(c + 1) * len(ks)]
        assert all(idx is group[0][1] for _, idx, _ in group[1:])
    assert [k for k, _ in calls["step"]] == ks * tail
    for s in range(tail):
        group = calls["step"][s * len(ks):(s + 1) * len(ks)]
        assert all(b is group[0][1] for _, b in group[1:])
    # a capture's warm-up step, then one a member a replayed or tail step
    assert launches["topk_sae_forward"] == len(ks) * per_group * (1 + GRID_STEPS), launches
    assert all(launches[k] == launches["topk_sae_forward"]
               for k in BACKWARD_PASSES if k in counters), launches
    tags = sorted(f"{sweep_mod._hp_tag(hp)}.pth" for hp in hps)
    assert sorted(p.name for p in out.glob("*.pth")) == tags
    for m in stats["models"]:
        ck = torch.load(out / f"{m['tag']}.pth", map_location="cpu", weights_only=True)
        assert ck["hparams"]["lr"] == m["lr"] and ck["step"] == GRID_STEPS
        variant, cfg_, act, _ = sae_from_checkpoint(str(out / f"{m['tag']}.pth"), "cpu")
        assert (variant, act, cfg_.k, cfg_.auxk_alpha) == ("topk", SMALL_D, m["k"],
                                                           m["auxk_alpha"]), m
    free_device_memory(torch)
    rec["graph_vs_eager"] = grid_graph_against_eager(
        torch, store_dir, [hp for hp in hps if hp["k"] == K])
    free_device_memory(torch)
    return rec


# ---------------------------------------------------------------------------
# phases 28-30: more than one rank. The card machine has one H100, so two
# gloo ranks share cuda:0 (NCCL refuses two ranks on one card) and NCCL runs
# at world size 1: the pod code paths with the real kernels, not a scaling
# measurement.


def pod_spawn(torch, spec: dict, timeout_s: int = POD_TIMEOUT_S, flag: str = "--pod-rank",
              report: str = "rank{}.json") -> list[dict]:
    """Phases 28 and 30's two ranks: ONE spawned pair of this script
    (``--pod-rank``; phase 31's ``--model-axis-rank``) that runs every
    two-rank check and reports as JSON. → each rank's report; a rank that
    fails or hangs fails the smoke."""
    out = Path(spec["out"])
    out.mkdir(parents=True, exist_ok=True)
    spec_path = out / "spec.json"
    spec_path.write_text(json.dumps(spec))
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), flag, str(r),
         "--pod-port", str(port), "--pod-spec", str(spec_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        print("\n".join(f"  [rank {r}] {ln}" for ln in o.strip().splitlines()[-25:]))
        assert p.returncode == 0, f"pod rank {r} exited {p.returncode}"
    return [json.loads((out / report.format(r)).read_text()) for r in range(2)]


def nccl_probe_worker(rank: int, port: int) -> int:
    """One of two ranks asking NCCL for a group on cuda:0 (trap 4). →
    0 when NCCL takes both ranks (and one all-reduce sums), 3 when it
    refuses them, with its message printed."""
    import torch

    from freud_tpu_torch.parallel import distributed as dist_lib

    try:
        dist_lib.initialize(f"127.0.0.1:{port}", 2, rank, device="cuda:0", timeout_s=60)
    except Exception as e:  # the refusal under test
        print(f"NCCL refused: {type(e).__name__}: {e}", flush=True)
        return 3
    t = torch.ones(1, device="cuda:0")
    torch.distributed.all_reduce(t)
    print(f"NCCL accepted two ranks on one card; all-reduce {float(t)}", flush=True)
    dist_lib.shutdown()
    return 0


def nccl_two_ranks(timeout_s: int = 180) -> dict:
    """Whether NCCL takes two ranks on the one card, and NCCL's own words
    (``NCCL_DEBUG=WARN``). The pod phases use gloo, named, either way."""
    port = free_port()
    env = {**os.environ, "NCCL_DEBUG": "WARN"}
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--nccl-probe-rank", str(r),
         "--pod-port", str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    assert set(codes) <= {0, 3}, (codes, outs)
    words = sorted({ln.strip() for o in outs for ln in o.splitlines()
                    if "NCCL WARN" in ln or "Duplicate GPU" in ln or "ncclInvalidUsage" in ln
                    or ln.startswith(("NCCL refused", "NCCL accepted"))})
    rec = {"refused": codes == [3, 3], "returncodes": codes, "nccl_said": words}
    print(f"NCCL with two ranks on one card: "
          f"{'refused' if rec['refused'] else 'accepted'}; NCCL said {words}")
    return rec


def pod_topk_setup(variant: str = "topk", **over) -> tuple[dict, dict]:
    """tiny_topk's (or tiny_l1's) autoencoder config and trainer keywords,
    as phase 5 runs them (AuxK from step 2)."""
    base = json.loads((REPO / f"configs/train/tiny_{variant}.json").read_text())
    ae = dict(base["autoencoder_config"])
    if variant == "topk":
        ae["dead_feature_threshold"] = M_ROWS // 2
    kw = dict(optimizer=base["optimizer"], scheduler=base["scheduler"],
              scheduler_params={"num_warmup_steps": 2}, lr=1e-3, steps=POD_STEPS,
              seed=SEED, **over)
    return ae, kw


def cycle_batches(loader):
    while True:
        for b in loader:
            yield np.asarray(b[0], np.float32)


def pod_worker(rank: int, port: int, spec_path: str) -> int:
    """One rank of phases 28 and 30 (gloo by name, on cuda:0)."""
    import pickle

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = json.loads(Path(spec_path).read_text())
    out = Path(spec["out"])
    from freud_tpu_torch.analysis.search import top_activations
    from freud_tpu_torch.data.device_cache import DeviceShuffleCache, sample_rows
    from freud_tpu_torch.data.loaders import MemoryMappedActivationLoader
    from freud_tpu_torch.data.multilayer import collect_multilayer
    from freud_tpu_torch.ops.attention import fused_qkv_attention
    from freud_tpu_torch.ops.mel import log_mel_spectrogram_cuda
    from freud_tpu_torch.ops.topk_backward import topk_masked_pair, topk_route
    from freud_tpu_torch.ops.topk_fused import topk_sae_forward
    from freud_tpu_torch.ops.topk_threshold import topk_thresholds_fired
    from freud_tpu_torch.parallel import distributed as dist_lib
    from freud_tpu_torch.parallel import mesh as mesh_lib
    from freud_tpu_torch.scripts.collect_activations import get_activations
    from freud_tpu_torch.train.sweep import SAESweepTrainer
    from freud_tpu_torch.train.trainer import SAETrainer, train as train_fn

    dist_lib.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo", device="cuda:0",
                        timeout_s=POD_TIMEOUT_S)
    mesh = mesh_lib.make_mesh()
    assert (mesh.backend, mesh.size, mesh.rank) == ("gloo", 2, rank), mesh
    assert mesh.device == torch.device("cuda:0")
    rec: dict = {"rank": rank}
    kernels = (log_mel_spectrogram_cuda, fused_qkv_attention, topk_sae_forward,
               topk_thresholds_fired, topk_masked_pair, topk_route)

    def zero():
        for fn in kernels:
            fn.launches = 0

    def read() -> dict:
        torch.cuda.synchronize()
        return {fn.__name__: fn.launches for fn in kernels}

    def host_state(tr) -> dict:
        return {n: p.detach().cpu().clone() for n, p in tr.params.named_parameters()}

    # 28a: tiny_topk at full width, this rank's 25 files of every 50
    ae, kw = pod_topk_setup()
    lo, hi = mesh_lib.host_shard_bounds(POD_BATCH, mesh)
    rec["bounds"] = [lo, hi]
    loader = MemoryMappedActivationLoader(spec["store"], LAYER, POD_BATCH, shuffle=True,
                                          drop_last=True, seed=SEED, host_bounds=(lo, hi))
    batches = cycle_batches(loader)
    tr = SAETrainer("topk", ae, D_IN, mesh=mesh, **kw)
    # rank 0 also runs each step in one process on the whole global batch
    # from the pod's state before the step (a teacher-forced comparison: a
    # free-running one-process run drifts from the pod's, phase 28's record)
    shadow = gbatches = None
    if rank == 0:
        shadow = SAETrainer("topk", ae, D_IN, device="cuda:0", **kw)
        gbatches = cycle_batches(MemoryMappedActivationLoader(
            spec["store"], LAYER, POD_BATCH, shuffle=True, drop_last=True, seed=SEED))
    metrics, counters, walls, forced = [], [], [], []
    zero()
    shadow_launches = dict.fromkeys(read(), 0)
    for i in range(POD_STEPS):
        x = next(batches)
        assert x.shape == (POD_BATCH // 2, 1500, D_IN), x.shape
        if shadow is not None:
            with torch.no_grad():
                for d, src in zip(shadow._state(), tr._state()):
                    d.copy_(src)
        m = tr.train_step(x, host_local=True)
        metrics.append({k: float(v) for k, v in m.items()})
        counters.append(tr.num_frames_since_fired.cpu().clone())
        if shadow is not None:
            before = read()
            sm = shadow.train_step(next(gbatches))
            for k, v in read().items():
                shadow_launches[k] += v - before[k]
            forced.append({
                "metric_rel": max(abs(float(sm[k]) - v) / max(abs(float(sm[k])), 1e-30)
                                  for k, v in metrics[-1].items()),
                "param_rel": model_rel(host_state(tr), host_state(shadow)),
                "counters_equal": bool(torch.equal(counters[-1],
                                                   shadow.num_frames_since_fired.cpu()))})
        if i == 0:
            torch.save(host_state(tr), out / f"topk_step1_rank{rank}.pt")
    torch.save({"params": host_state(tr), "counters": counters},
               out / f"topk_step{POD_STEPS}_rank{rank}.pt")
    if rank == 0:
        tr.save(str(out / "pod_topk.pth"), tr.hparams())
    # ms a step: more pod steps, without rank 0's one-process shadow
    for _ in range(POD_TIMED_STEPS):
        x = next(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(x, host_local=True)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    launches = {k: v - shadow_launches[k] for k, v in read().items()}
    rec["topk"] = {"metrics": metrics, "launches": launches, "step_ms": walls,
                   "forced": forced}
    del shadow, tr
    # 28b: 2 multi_topk steps (kernel #3) and 4 tiny_l1 steps through train()
    tr = SAETrainer("topk", {**ae, "multi_topk": True}, D_IN, mesh=mesh, **kw)
    zero()
    rec["multi_topk"] = {"metrics": [
        {k: float(v) for k, v in tr.train_step(next(batches), host_local=True).items()}
        for _ in range(2)]}
    rec["multi_topk"]["launches"] = read()
    del tr
    lbase = json.loads((REPO / "configs/train/tiny_l1.json").read_text())
    run_dir = out / f"l1_rank{rank}"
    stats = train_fn(**{**pod_l1_config(lbase, spec["store"], run_dir), "mesh": mesh})
    rec["l1"] = {"steps": stats["steps"], "files": sorted(
        str(p.relative_to(run_dir)) for p in run_dir.rglob("*") if p.is_file())}
    # 28c: the pod cache (a 12-file stratum of 24) and one chunk of 5,
    # against the same steps run one by one on the same rows
    caches = [DeviceShuffleCache(spec["store"], LAYER, POD_CACHE_FILES, refresh_files=0,
                                 seed=SEED, subset_size=POD_CACHE_FILES,
                                 process_shard=(rank, 2), mesh=mesh) for _ in range(2)]
    rec["stratum"] = caches[0]._files.tolist()
    warm = caches[0].draw(1, POD_BATCH // 2)[0]
    idx = caches[0].draw(POD_CHUNK, POD_BATCH // 2)
    runs = []
    for chunked, cache in zip((True, False), caches):
        tr = SAETrainer("topk", ae, D_IN, mesh=mesh, **kw)
        tr.train_step(sample_rows(cache.cache, warm), host_local=True)  # AuxK live
        zero()
        if chunked:
            assert not tr.chunk_is_graph(cache.cache), "a gloo chunk must not be captured"
            ms = tr.train_chunk_pod(cache, POD_BATCH // 2, POD_CHUNK, indices=idx)
            last = {k: v[-1] for k, v in ms.items()}
        else:
            for i in range(POD_CHUNK):
                last = tr.train_step(sample_rows(cache.cache, idx[i]), host_local=True)
        runs.append(([t.detach().clone() for t in tr._state()],
                     {k: v.clone() for k, v in last.items()}, read()))
        cache.close()
        del tr
    (c_state, c_m, c_launch), (s_state, s_m, _) = runs
    diffs = [float((a.double() - b.double()).abs().max()) for a, b in zip(c_state, s_state)]
    diffs += [float((c_m[k].double() - s_m[k].double()).abs().max()) for k in s_m]
    rec["chunk"] = {"max_abs_diff": max(diffs), "launches": c_launch,
                    "auxk_loss": float(c_m["auxk_loss"]), "graph": False}
    assert max(diffs) == 0.0, diffs
    # 28d: search over the ranks (the index's fast path and the scan)
    found = {}
    for where, folder in spec["search"].items():
        sloader = MemoryMappedActivationLoader(folder, LAYER, batch_size=BATCH)
        found[where] = [top_activations(sloader, f, 10, absolute_magnitude=a, mesh=mesh)
                        for f in spec["feats"] for a in (False, True)]
    (out / f"search_rank{rank}.pkl").write_bytes(pickle.dumps(found))
    # 28e: a 2-member per-layer sweep step, each member's batch split
    sae, skw = pod_sweep_setup()
    sw = SAESweepTrainer("topk", sae, SMALL_D, 2, mesh=mesh, **skw)
    zero()
    sw.train_step(pod_sweep_batch(spec["small_store"]))
    rec["sweep"] = {"launches": read()}
    torch.save([host_state(m) for m in sw.members], out / f"sweep_rank{rank}.pt")
    del sw
    # 30: data_parallel collection, one layer then two
    zero()
    get_activations(data_path=spec["audio"], layer_name=LAYER, whisper_model="random:tiny",
                    sae_model=None, batch_size=BATCH, out_folder=str(out / "dp"),
                    verbose=False, data_parallel=True, device="cuda:0")
    rec["collection"] = {"launches": read()}
    zero()
    collect_multilayer(spec["audio"], POD_LAYERS, "random:tiny", POD_ML_BATCH,
                       str(out / "dpm"), collect_max=POD_ML_FILES, verbose=False,
                       data_parallel=True, device="cuda:0")
    rec["multilayer"] = {"launches": read()}
    dist_lib.barrier()
    dist_lib.shutdown()
    (out / f"rank{rank}.json").write_text(json.dumps(rec))
    return 0


def pod_l1_config(lbase: dict, store: str, run_dir: Path) -> dict:
    """4 tiny_l1 steps at batch 50 (phase 5's), validation at the end."""
    return {**lbase, "train_folder": store, "val_folder": store, "run_dir": str(run_dir),
            "steps": 4, "save_every": 4, "val_every": 4, "log_tb_every": 2,
            "batch_size": POD_BATCH, "enable_transcripts": False, "verbose": False}


def pod_sweep_setup() -> tuple[dict, dict]:
    """The sweep check's recipe: phase 26's TopK dictionary at Whisper
    small's width, under RAdam and a cosine schedule, whose first update
    moves the parameters (by lr · g), so one step is a real check."""
    cfg = sweep_config("", Path("."))
    return cfg["autoencoder_config"], dict(optimizer="radam", scheduler="cosine", lr=1e-3,
                                           steps=10, seed=SEED)


def pod_sweep_batch(small_store: str) -> np.ndarray:
    """(2, 8, 1500, 768): the first shuffled batch of blocks 2 and 5."""
    from freud_tpu_torch.data.loaders import MemoryMappedActivationLoader

    return np.stack([next(cycle_batches(MemoryMappedActivationLoader(
        small_store, layer, SWEEP_BATCH, shuffle=True, drop_last=True, seed=SEED)))
        for layer in SMALL_LAYERS[:2]])


def model_rel(a: dict, b: dict) -> float:
    """max |a − b| over a parameter set, relative to b's max |param|."""
    top = max(float(v.abs().max()) for v in b.values())
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in b) / top


def pod_phases(torch, device, tmp: Path, clips, card: str) -> dict:
    """Phases 28-30: two gloo ranks on cuda:0, then NCCL at world size 1.
    → the record, with each kernel's launches in these runs."""
    import pickle

    from freud_tpu_torch.analysis.search import top_activations
    from freud_tpu_torch.data.device_cache import DeviceShuffleCache, sample_rows
    from freud_tpu_torch.data.loaders import MemoryMappedActivationLoader
    from freud_tpu_torch.data.multilayer import collect_multilayer
    from freud_tpu_torch.ops.topk_backward import topk_masked_pair, topk_route
    from freud_tpu_torch.ops.topk_fused import topk_sae_forward
    from freud_tpu_torch.parallel import distributed as dist_lib
    from freud_tpu_torch.parallel import mesh as mesh_lib
    from freud_tpu_torch.scripts.merge_stores import merge_shards
    from freud_tpu_torch.train.sweep import SAESweepTrainer
    from freud_tpu_torch.train.trainer import SAETrainer, train as train_fn

    free_device_memory(torch)
    t_start = time.perf_counter()
    store = str(tmp / "card")
    pod = tmp / "pod"
    scan = tmp / "card_scan"  # phase 3's store without its index: search scans
    scan.mkdir()
    for suffix in ("_metadata.json", "_tensors.npy"):
        (scan / f"{LAYER}{suffix}").symlink_to(tmp / "card" / f"{LAYER}{suffix}")
    feats = [0, 7, D_IN - 1]
    spec = {"out": str(pod), "store": store, "audio": str(tmp / "audio"),
            "small_store": str(tmp / "small_multi"), "feats": feats,
            "search": {"fast": store, "scan": str(scan)}}
    # trap 4 first: NCCL and two ranks on one card
    nccl = nccl_two_ranks()
    # the one-rank answers first, while the card is this process's alone
    sloader = MemoryMappedActivationLoader(store, LAYER, batch_size=BATCH)
    one_search = [top_activations(sloader, f, 10, absolute_magnitude=a, device=device)
                  for f in feats for a in (False, True)]
    t0 = time.perf_counter()
    ranks = pod_spawn(torch, spec)
    pair_s = time.perf_counter() - t0
    rec: dict = {"nccl_two_ranks_one_card": nccl, "pair_seconds": pair_s}

    # 28a against one process on the same global batches
    ae, kw = pod_topk_setup()
    loader = MemoryMappedActivationLoader(store, LAYER, POD_BATCH, shuffle=True,
                                          drop_last=True, seed=SEED)
    batches = cycle_batches(loader)
    tr = SAETrainer("topk", ae, D_IN, device=device, **kw)
    one_metrics, one_counters, one_walls = [], [], []
    for i in range(POD_STEPS + POD_TIMED_STEPS):
        x = next(batches)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = tr.train_step(x)
        torch.cuda.synchronize()
        one_walls.append(1e3 * (time.perf_counter() - t1))
        if i >= POD_STEPS:
            continue
        one_metrics.append({k: float(v) for k, v in m.items()})
        one_counters.append(tr.num_frames_since_fired.cpu().clone())
        if i == 0:
            step1 = {n: p.detach().cpu().clone() for n, p in tr.params.named_parameters()}
        if i == POD_STEPS - 1:
            one_final = {n: p.detach().cpu().clone() for n, p in tr.params.named_parameters()}
    step1_rel = max(model_rel(torch.load(pod / f"topk_step1_rank{r}.pt"), step1)
                    for r in range(2))
    finals = [torch.load(pod / f"topk_step{POD_STEPS}_rank{r}.pt") for r in range(2)]
    for a, b in zip(finals[0]["counters"], finals[1]["counters"]):
        assert torch.equal(a, b), "the ranks' dead counters differ"
    assert all(torch.equal(a, b) for a, b in zip(finals[0]["params"].values(),
                                                  finals[1]["params"].values()))
    counters_equal = [bool(torch.equal(a, b)) for a, b in zip(finals[0]["counters"],
                                                              one_counters)]
    assert counters_equal[0], "the step-1 dead counters differ from one process's"
    drift = [max(abs(r["topk"]["metrics"][i][k] - v) / max(abs(v), 1e-30)
                 for r in ranks for k, v in m.items()) for i, m in enumerate(one_metrics)]
    forced = ranks[0]["topk"]["forced"]
    metric_rel = max(f["metric_rel"] for f in forced)
    aux = [m["auxk_loss"] for m in ranks[0]["topk"]["metrics"]]
    final_rel = model_rel(finals[0]["params"], one_final)
    step_ms = [statistics.median(r["topk"]["step_ms"]) for r in ranks]  # the timed steps
    rec["topk"] = {"step1_param_rel": step1_rel, "forced": forced,
                   "forced_metrics_max_rel": metric_rel,
                   "free_running_metric_rel_by_step": drift,
                   "free_running_step10_param_rel": final_rel,
                   "free_running_counters_equal": counters_equal,
                   "ms_a_step_two_ranks_sharing_one_card": step_ms,
                   "ms_a_step_one_process": statistics.median(one_walls[POD_STEPS:]),
                   "launches": [r["topk"]["launches"] for r in ranks]}
    print(f"pod tiny_topk, 2 gloo ranks on one card, global batch {POD_BATCH} "
          f"({POD_BATCH // 2 * 1500} rows a rank), {POD_STEPS} steps: step-1 parameters "
          f"{step1_rel:.3e} of max from one process (bound 1e-6; the linear warmup's first "
          f"lr is 0); each step against one process from the pod's state: metrics "
          f"{metric_rel:.3e} relative (bound 1e-4), parameters after it "
          f"{[round(f['param_rel'], 9) for f in forced]} of max (reported), dead counters "
          f"equal {[f['counters_equal'] for f in forced]}; free-running against one process: "
          f"metrics {[float(f'{d:.2e}') for d in drift]} relative by step, step "
          f"{POD_STEPS} parameters {final_rel:.3e} of max, counters equal {counters_equal} "
          f"(reported); the ranks' counters equal every step; AuxK {aux[1]:.3e} at step 2; "
          f"median ms a step {step_ms} (two ranks SHARING one card: not a scaling number) "
          f"against {rec['topk']['ms_a_step_one_process']:.3f} ms for one process on "
          f"{card}; launches {rec['topk']['launches']}")
    assert step1_rel <= 1e-6 and forced[0]["param_rel"] <= 1e-6, (step1_rel, forced[0])
    assert metric_rel <= 1e-4, forced
    assert all(f["counters_equal"] for f in forced), forced
    assert max(aux[1:]) > 0, aux
    for r in ranks:
        pod_steps = POD_STEPS + POD_TIMED_STEPS
        for k in ("topk_sae_forward", *BACKWARD_PASSES):
            assert r["topk"]["launches"][k] == pod_steps, (k, r["topk"]["launches"])
    rank0 = torch.load(pod / "pod_topk.pth", map_location="cpu", weights_only=True)
    single = SAETrainer("topk", ae, D_IN, device=device, **kw)
    single.load(str(pod / "pod_topk.pth"))
    assert single.step == POD_STEPS and rank0["step"] == POD_STEPS
    assert model_rel({n: p.detach().cpu().clone() for n, p in single.params.named_parameters()},
                     finals[0]["params"]) == 0.0
    del tr, single
    # 28b: multi_topk and tiny_l1 against one process
    tr = SAETrainer("topk", {**ae, "multi_topk": True}, D_IN, device=device, **kw)
    one_multi = [{k: float(v) for k, v in tr.train_step(next(batches)).items()}
                 for _ in range(2)]
    multi_rel = max(abs(r["multi_topk"]["metrics"][i][k] - v) / max(abs(v), 1e-30)
                    for r in ranks for i, m in enumerate(one_multi) for k, v in m.items())
    del tr
    lbase = json.loads((REPO / "configs/train/tiny_l1.json").read_text())
    train_fn(**{**pod_l1_config(lbase, store, tmp / "l1_one"), "device": str(device)})
    l1_pod = torch.load(pod / "l1_rank0" / "checkpoints" / "step4.pth", weights_only=True)
    l1_one = torch.load(tmp / "l1_one" / "checkpoints" / "step4.pth", weights_only=True)
    l1_rel = model_rel(l1_pod["model"], l1_one["model"])
    rec["multi_topk"] = {"metrics_max_rel": multi_rel,
                         "launches": [r["multi_topk"]["launches"] for r in ranks]}
    rec["l1"] = {"param_rel": l1_rel, "files": [r["l1"]["files"] for r in ranks]}
    print(f"pod multi_topk, 2 steps: metrics {multi_rel:.3e} relative to one process "
          f"(bound 1e-4), launches {rec['multi_topk']['launches']}; pod tiny_l1 through "
          f"train(mesh=), 4 steps: rank-0 checkpoint {l1_rel:.3e} of max from one process's "
          f"(bound 1e-3: bf16 products round each rank's partial gradient); rank 0 wrote "
          f"{len(ranks[0]['l1']['files'])} files, rank 1 {len(ranks[1]['l1']['files'])}")
    assert multi_rel <= 1e-4 and l1_rel <= 1e-3, (multi_rel, l1_rel)
    for r in ranks:
        assert r["multi_topk"]["launches"]["topk_thresholds_fired"] == 2, r["multi_topk"]
        assert all(r["multi_topk"]["launches"][k] == 0 for k in BACKWARD_PASSES), r["multi_topk"]
        assert r["l1"]["steps"] == 4
    assert {"checkpoints/step4.pth", "checkpoints/bestval.pth"} <= set(ranks[0]["l1"]["files"])
    assert ranks[1]["l1"]["files"] == []
    # 28c: the strata and the chunk
    strata = [r["stratum"] for r in ranks]
    assert sorted(strata[0] + strata[1]) == list(range(POD_CACHE_FILES))
    assert not set(strata[0]) & set(strata[1])
    rec["chunk"] = [r["chunk"] for r in ranks]
    print(f"pod cache: strata {strata[0][:3]}… / {strata[1][:3]}… cover the {POD_CACHE_FILES} "
          f"files once; a gloo chunk of {POD_CHUNK} (eager: gloo cannot be captured) equals "
          f"its steps bit for bit, launches {[c['launches'] for c in rec['chunk']]}")
    for c in rec["chunk"]:
        assert c["launches"]["topk_sae_forward"] == POD_CHUNK and c["auxk_loss"] > 0, c
        assert all(c["launches"][k] == POD_CHUNK for k in BACKWARD_PASSES), c
    # 28d: search bit-equal to the one-rank answer
    for r in range(2):
        found = pickle.loads((pod / f"search_rank{r}.pkl").read_bytes())
        for where in ("fast", "scan"):
            for got, want in zip(found[where], one_search):
                same_search(got, want)
    print(f"top_activations(mesh=) on both ranks, fast path and scan, features {feats}: "
          "bit-equal to the one-rank answer")
    # 28e: the sweep step against one process
    sae, skw = pod_sweep_setup()
    sw = SAESweepTrainer("topk", sae, SMALL_D, 2, device=device, **skw)
    sw.train_step(pod_sweep_batch(str(tmp / "small_multi")))
    one_sw = [{n: p.detach().cpu().clone() for n, p in m.params.named_parameters()}
              for m in sw.members]
    sweep_rel = max(model_rel(got, want) for r in range(2) for got, want in
                    zip(torch.load(pod / f"sweep_rank{r}.pt"), one_sw))
    rec["sweep"] = {"param_rel": sweep_rel, "launches": [r["sweep"]["launches"] for r in ranks]}
    print(f"pod sweep step, 2 members over {SMALL_LAYERS[:2]} at d {SMALL_D}, batch "
          f"{SWEEP_BATCH} split over 2 ranks: {sweep_rel:.3e} of max from one process "
          f"(bound 1e-6), launches {rec['sweep']['launches']}")
    assert sweep_rel <= 1e-6, sweep_rel
    for r in ranks:
        assert r["sweep"]["launches"]["topk_sae_forward"] == 2, r["sweep"]
        assert all(r["sweep"]["launches"][k] == 2 for k in BACKWARD_PASSES), r["sweep"]
    del sw
    free_device_memory(torch)

    # 30: the ranks' shards merged against phase 3's store
    for r in range(2):
        assert (pod / "dp" / f"shard{r}").is_dir()
    merge_shards(str(pod / "dp"), LAYER, verbose=False)
    meta, got = read_store(pod / "dp")
    meta3, want = read_store(tmp / "card")
    dp_rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert meta == meta3, "merged metadata differs from phase 3's"
    assert meta["filenames"] == [p for p, _ in clips]
    n_batches = [-(-len(clips[r::2]) // BATCH) for r in range(2)]
    coll = [r["collection"]["launches"] for r in ranks]
    ml_one = tmp / "ml_one"
    collect_multilayer(str(tmp / "audio"), POD_LAYERS, "random:tiny", POD_ML_BATCH,
                       str(ml_one), collect_max=POD_ML_FILES, verbose=False, device=device)
    ml_rel = 0.0
    for layer in POD_LAYERS:
        merge_shards(str(pod / "dpm"), layer, verbose=False)
        mmeta, mgot = read_store(pod / "dpm", layer)
        ometa, owant = read_store(ml_one, layer)
        assert mmeta == ometa, layer
        ml_rel = max(ml_rel, float(np.abs(mgot - owant).max() / np.abs(owant).max()))
    mlaunch = [r["multilayer"]["launches"] for r in ranks]
    rec["collection"] = {"merged_rel": dp_rel, "launches": coll, "multilayer_rel": ml_rel,
                         "multilayer_launches": mlaunch}
    print(f"data_parallel collection on 2 ranks (random:tiny to block 2, batch {BATCH}): "
          f"shard0 and shard1 merged equal phase 3's store within {dp_rel:.3e} of max "
          f"(bound 1e-6), file order and metadata identical; launches {coll} "
          f"({n_batches} batches); two-layer collection of {POD_ML_FILES} files (blocks 1 "
          f"and 2) merged within {ml_rel:.3e} of the one-rank stores, launches {mlaunch}")
    assert dp_rel <= 1e-6 and ml_rel <= 1e-6, (dp_rel, ml_rel)
    for r, n in enumerate(n_batches):
        assert coll[r]["log_mel_spectrogram_cuda"] == n, coll
        assert coll[r]["fused_qkv_attention"] == 3 * n, coll
        assert mlaunch[r]["log_mel_spectrogram_cuda"] == 1, mlaunch
        assert mlaunch[r]["fused_qkv_attention"] == 3, mlaunch

    # 29: NCCL at world size 1 — train(mesh=) bit-equal to train() without a
    # process group, and one pod chunk replayed as a CUDA graph against its
    # eager steps
    tbase = json.loads((REPO / "configs/train/tiny_topk.json").read_text())
    tcfg = {**tbase, "train_folder": store, "val_folder": store, "steps": POD_STEPS,
            "batch_size": POD_BATCH,
            "save_every": POD_STEPS, "val_every": POD_STEPS, "log_tb_every": POD_STEPS,
            "lr": 1e-3, "scheduler_params": {"num_warmup_steps": 2},
            "autoencoder_config": ae, "enable_transcripts": False, "verbose": False}
    train_fn(**{**tcfg, "run_dir": str(tmp / "nopg"), "device": str(device)})
    dist_lib.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cuda:0")
    try:
        mesh = mesh_lib.make_mesh()
        assert (mesh.backend, mesh.size) == ("nccl", 1), mesh
        step_fns = {"topk_sae_forward": topk_sae_forward, "topk_masked_pair": topk_masked_pair,
                    "topk_route": topk_route}
        for fn in step_fns.values():
            fn.launches = 0
        train_fn(**{**tcfg, "run_dir": str(tmp / "nccl1"), "mesh": mesh})
        torch.cuda.synchronize()
        nccl_train = {k: fn.launches for k, fn in step_fns.items()}
        nccl_train_launches = nccl_train["topk_sae_forward"]
        a = torch.load(tmp / "nopg" / "checkpoints" / f"step{POD_STEPS}.pth", weights_only=True)
        b = torch.load(tmp / "nccl1" / "checkpoints" / f"step{POD_STEPS}.pth",
                       weights_only=True)
        for k in ("model", "optimizer"):
            for (ka, va), (kb, vb) in zip(sorted(flat_tensors(a[k])), sorted(flat_tensors(b[k]))):
                assert ka == kb and torch.equal(va, vb), (k, ka)
        assert torch.equal(a["num_frames_since_fired"], b["num_frames_since_fired"])
        tr = SAETrainer("topk", ae, D_IN, mesh=mesh, **kw)
        cache = DeviceShuffleCache(store, LAYER, POD_CACHE_FILES, refresh_files=0, seed=SEED,
                                   subset_size=POD_CACHE_FILES, mesh=mesh)
        try:
            tr.train_step(cache.next_batch(POD_BATCH), host_local=True)  # AuxK live
            assert tr.chunk_is_graph(cache.cache)
            gen = torch.Generator(device=device).manual_seed(SEED + 7)
            idx = torch.randint(0, cache.capacity, (POD_CHUNK, POD_BATCH), generator=gen,
                                device=device)
            start = [t.detach().clone() for t in tr._state()]
            for fn in step_fns.values():
                fn.launches = 0
            gm = tr.train_chunk_pod(cache, POD_BATCH, POD_CHUNK, indices=idx)
            torch.cuda.synchronize()
            graph = {k: fn.launches for k, fn in step_fns.items()}
            graph_launches = graph["topk_sae_forward"]
            g_state = [t.detach().clone() for t in tr._state()]
            with torch.no_grad():
                for t, s in zip(tr._state(), start):
                    t.copy_(s)
            eager = [tr._step(sample_rows(cache.cache, idx[i]), mesh) for i in range(POD_CHUNK)]
            e_state = [t.detach().clone() for t in tr._state()]
        finally:
            cache.close()
        graph_rel = max(float((g.double() - e.double()).abs().max()
                              / e.double().abs().max().clamp(min=1e-30))
                        for g, e in zip(g_state, e_state))
        graph_rel = max([graph_rel] + [
            float((gm[k].double() - torch.stack([e[k] for e in eager]).double()).abs().max())
            for k in gm])
    finally:
        dist_lib.shutdown()
    rec["nccl_world1"] = {"train_bit_equal": True, "train_launches": nccl_train_launches,
                          "graph_vs_eager_max_rel": graph_rel,
                          "graph_launches": graph_launches,
                          "train_launches_by_kernel": nccl_train,
                          "graph_launches_by_kernel": graph}
    print(f"NCCL at world size 1: train(mesh=) {POD_STEPS} steps, checkpoint tensors "
          f"bit-equal to train() without a process group (kernel #4 launches "
          f"{nccl_train_launches}); a pod chunk of {POD_CHUNK} captured with its NCCL "
          f"collectives and replayed as a CUDA graph: "
          f"{'bit-equal to' if graph_rel == 0 else f'{graph_rel:.3e} of max from'} its eager "
          f"steps; kernel #4 launches {graph_launches} (the capture's warm-up step and "
          f"{POD_CHUNK} replayed)")
    assert graph_rel <= 1e-6, graph_rel
    assert nccl_train == dict.fromkeys(step_fns, POD_STEPS), nccl_train
    assert graph == dict.fromkeys(step_fns, POD_CHUNK + 1), graph
    del tr
    free_device_memory(torch)
    rec["seconds"] = time.perf_counter() - t_start
    rec["launches"] = {
        "log_mel": sum(c["log_mel_spectrogram_cuda"] for c in coll + mlaunch),
        "fused_qkv_attention": sum(c["fused_qkv_attention"] for c in coll + mlaunch),
        "whisper_attention": 0,
        "topk_sae_forward": (sum(r["topk"]["launches"]["topk_sae_forward"]
                                 + r["chunk"]["launches"]["topk_sae_forward"]
                                 + r["sweep"]["launches"]["topk_sae_forward"] for r in ranks)
                             + nccl_train_launches + graph_launches),
        "topk_thresholds_fired": sum(r["multi_topk"]["launches"]["topk_thresholds_fired"]
                                     for r in ranks),
        **{k: (sum(r["topk"]["launches"][k] + r["chunk"]["launches"][k]
                   + r["sweep"]["launches"][k] for r in ranks)
               + nccl_train[k] + graph[k]) for k in BACKWARD_PASSES}}
    print(f"phases 28-30 in {rec['seconds']:.1f} s (the pair {pair_s:.1f} s) on {card}; "
          f"launches {rec['launches']}")
    return rec


def pod_only(torch, device, card: str) -> dict:
    """Phases 28-30 on the stores they read, made here: phase 3's
    collection and index, and 12 files of Whisper small's blocks 2 and 5
    (phase 25's layers)."""
    from freud_tpu_torch.data.multilayer import collect_multilayer

    with tempfile.TemporaryDirectory(prefix="chip_smoke_pod_") as tmp:
        tmp = Path(tmp)
        (tmp / "audio").mkdir()
        clips = write_wavs(tmp / "audio", [480000] * N_LONG
                           + [int(16000 * t) for t in N_SHORT_S], broken=True)
        base = json.loads((REPO / "configs/features/tiny_block_2_test.json").read_text())
        collect({**base, "whisper_model": "random:tiny", "batch_size": BATCH,
                 "data_path": str(tmp / "audio"), "out_folder": str(tmp / "card")},
                tmp / "card.json")
        run_index_cli(tmp, tmp / "card", LAYER)
        (tmp / "audio_small").mkdir()
        write_wavs(tmp / "audio_small", [480000] * 12, seed=SEED + 13)
        collect_multilayer(str(tmp / "audio_small"), SMALL_LAYERS[:2], "random:small", 12,
                           str(tmp / "small_multi"), verbose=False, device=str(device))
        free_device_memory(torch)
        return pod_phases(torch, device, tmp, clips, card)


# ------------------------------------------------------------ phase 31


def check_topk_sharded(torch, device, card) -> dict:
    """Phase 31a: kernel #3's selection across dictionary shards, in this
    process, for each key kind: the bf16 (exact path) and f32 (float path)
    latents of a large_v1_audioset batch (48,000 rows × 20,480) and a bf16
    one of 48,000 × 40,960 (the bf16 float path: n_dict >= 2^15), each
    split into P = 2 and 4 column shards; each shard's candidates launch,
    the gather done here (a stack), each shard's combine launch. The
    thresholds bit-equal on every shard to kernel #3 on the whole latent and
    to the plain version, the fired bits each shard's columns of the whole
    mask, the candidates equal to the plain version's as key multisets with
    the header exact; in four dead cases (a third dead, fewer dead latents
    than k_aux in the whole row, one shard without any, none dead). Edge
    rows in every latent: a silent row, a tie across the shard boundaries,
    a row of one value throughout (ties fill both regions) and, on the
    float kinds, a row of negative values and -inf. Edge widths: shards of
    1,001 columns (not a multiple of 16 bytes) in every kind, shards
    narrower than k_sel (every key sent), and an f32 shard of 52,379
    columns at 300 rows, held to kernel #3's plain version (kernel #3
    takes at most 49,152 f32 columns). Both launches timed at P = 2 and 4,
    at k_multi 128 and at the recipe's own selection (large_v1_audioset
    has no multi_topk: k_sel 32), beside their bounds, with the plain
    versions and torch.topk(acts_s, k) on the same shard as the library
    yardstick."""
    from freud_tpu_torch import flops
    from freud_tpu_torch.ops import topk_sharded as ts
    from freud_tpu_torch.ops.topk_threshold import (topk_thresholds_fired,
                                                    topk_thresholds_fired_plain)

    gen = torch.Generator().manual_seed(SEED + 31)
    m, n, k, k_aux, k_multi = LARGE_M_ROWS, LARGE_N_DICT, K, LARGE_K_AUX, 4 * K
    record: dict = {"route": "cuda", "replaces": "freud_tpu/ops/topk_threshold.py:225",
                    "shape": [m, n], "k": k, "k_aux": k_aux, "k_multi": k_multi,
                    "max_abs_err": 0.0}

    def edge_rows(acts, kind):
        """The edge rows, in place: silent, a tie across the P = 2 and 4
        boundaries, one value throughout; on the float kinds a row of
        negative values with -inf in every seventh column."""
        w = acts.shape[1]
        acts[5] = 0.0
        acts[6, w // 2 - 40:w // 2 + 40] = 3.5
        acts[7] = 1.25
        if kind != ts.EXACT:
            acts[8] = -acts[8].abs() - 0.25
            acts[8, ::7] = float("-inf")
        return acts

    def dead_cases(w, p):
        third = (torch.rand((w,), generator=gen) < 1 / 3).to(device)
        few = torch.zeros_like(third)
        few[torch.randperm(w, generator=gen)[:k_aux // 2].to(device)] = True
        first_alive = third.clone()
        first_alive[: w // p] = False
        return (("a third dead", third), ("fewer dead than k_aux", few),
                ("first shard none dead", first_alive),
                ("none dead", torch.zeros_like(third)))

    def same_candidates(got, want) -> int:
        """Candidate rows hold a multiset of keys each (the kernel's order
        within a region is its own): → the largest key difference after
        sorting each row's regions, the header as it is."""
        c_main = got.shape[1] - k_aux - ts.HEADER
        err = 0
        for lo, hi in ((0, c_main), (c_main, c_main + k_aux)):
            g = torch.sort(got[:, lo:hi].to(torch.int64) & 0xFFFFFFFF, dim=1).values
            w = torch.sort(want[:, lo:hi].to(torch.int64) & 0xFFFFFFFF, dim=1).values
            err = max(err, int((g - w).abs().max()))
        return max(err, int((got[:, -ts.HEADER:].to(torch.int64)
                             - want[:, -ts.HEADER:].to(torch.int64)).abs().max()))

    def shards(acts, p):
        s = acts.shape[1] // p
        return [acts[:, i * s:(i + 1) * s].contiguous() for i in range(p)]

    def run(acts_s, dead_s, kind, w, km, plain=False):
        cand = ts.shard_candidates_plain if plain else ts.shard_candidates
        comb = ts.combine_shard_thresholds_plain if plain else ts.combine_shard_thresholds
        g = torch.stack([cand(x, d, max(k, km), k_aux, kind) for x, d in zip(acts_s, dead_s)])
        return [comb(g, x, w, k, k_aux, km, kind) for x in acts_s]

    def check(name, acts, kind, p, signed=False, km=k_multi, whole_plain=False):
        """Every dead case at P = p: candidates against the plain version's,
        thresholds and fired against kernel #3 on the whole latent (its
        plain version where ``whole_plain``) and the plain versions."""
        w = acts.shape[1]
        assert ts.key_kind(acts, w, signed) == kind, (name, kind)
        acts_s = shards(acts, p)
        whole = topk_thresholds_fired_plain if whole_plain else topk_thresholds_fired
        ref = "'s plain version" if whole_plain else ""
        for dname, dead in dead_cases(w, p):
            dead_s = list(dead.view(p, -1).unbind(0))
            cand_err = max(same_candidates(
                ts.shard_candidates(x, d, max(k, km), k_aux, kind),
                ts.shard_candidates_plain(x, d, max(k, km), k_aux, kind))
                for x, d in zip(acts_s, dead_s))
            assert cand_err == 0, (name, p, dname, cand_err)
            want = whole(acts, dead, k, k_aux, k_multi=km, signed=signed)
            got = run(acts_s, dead_s, kind, w, km)
            plain = run(acts_s, dead_s, kind, w, km, plain=True)
            torch.cuda.synchronize()
            for g, pl in zip(got, plain):
                for i in range(3):
                    assert (g[i] is None and want[i] is None) or torch.equal(g[i], want[i]), (
                        name, p, dname, i)
                    assert (pl[i] is None and want[i] is None) or torch.equal(pl[i], want[i]), (
                        name, p, dname, i, "plain")
            assert torch.equal(torch.cat([g[3] for g in got]), want[3]), (name, p, dname)
            assert torch.equal(torch.cat([g[3] for g in plain]), want[3]), (name, p, dname)
            err = max(_threshold_err(g, pl) for g, pl in zip(got, plain))
            record["max_abs_err"] = max(record["max_abs_err"], err)
            print(f"sharded selection {name} P={p} ({dname}) {tuple(acts.shape)}: candidates "
                  "equal to the plain version's (as key multisets, header exact), thresholds "
                  f"and fired bit-equal to kernel #3{ref} on the whole latent and to the "
                  "plain version on every shard")

    def timed(name, acts, kind, p, km):
        """Both launches on shard 0 (a third dead) beside their bounds."""
        w = acts.shape[1]
        s = w // p
        acts_s = shards(acts, p)
        dead_s = list(dead_cases(w, p)[0][1].view(p, -1).unbind(0))
        k_sel = max(k, km)
        width = ts.candidate_width(s, k_sel, k_aux)
        g = torch.stack([ts.shard_candidates(x, d, k_sel, k_aux, kind)
                         for x, d in zip(acts_s, dead_s)])
        cand_ms = cuda_ms(lambda: ts.shard_candidates(acts_s[0], dead_s[0], k_sel, k_aux,
                                                      kind), reps=10)
        comb_ms = cuda_ms(lambda: ts.combine_shard_thresholds(
            g, acts_s[0], w, k, k_aux, km, kind), reps=10)
        cand_plain = cuda_ms(lambda: ts.shard_candidates_plain(
            acts_s[0], dead_s[0], k_sel, k_aux, kind), warmup=1, reps=3)
        comb_plain = cuda_ms(lambda: ts.combine_shard_thresholds_plain(
            g, acts_s[0], w, k, k_aux, km, kind), warmup=1, reps=3)
        lib_ms = cuda_ms(lambda: torch.topk(acts_s[0], k, dim=1), reps=10)
        in_bytes = acts.element_size()
        cb = flops.topk_shard_candidates_bound(m, s, width, in_bytes)
        mb = flops.topk_shard_combine_bound(m, s, width, p, in_bytes, 3 if km else 2)
        assert cand_ms >= cb.bound_ms and comb_ms >= mb.bound_ms, (name, p, km)
        print(f"sharded selection {name} P={p} k_sel {k_sel} shard {m}×{s}: candidates "
              f"{cand_ms:.4f} ms (bound {cb.bound_ms:.4f}, plain {cand_plain:.4f}, torch.topk(k) "
              f"{lib_ms:.4f}), combine {comb_ms:.4f} ms (bound {mb.bound_ms:.4f}, plain "
              f"{comb_plain:.4f}) on {card}")
        return {
            "shard": [m, s], "width": width, "k_sel": k_sel,
            "candidates": dict(name="shard_candidates", max_abs_err=0.0, ms=cand_ms,
                               plain_ms=cand_plain, **yardsticks(
                cb, lib_ms, "torch.topk(acts_s, k): the shard's top k values only")),
            "combine": dict(name="combine_shard_thresholds",
                            max_abs_err=record["max_abs_err"], ms=comb_ms,
                            plain_ms=comb_plain, **yardsticks(
                mb, None, "none: no library call merges candidates by kernel #3's rules"))}

    a = torch.relu(torch.randn((m, n), generator=gen)).to(device)
    gd = torch.Generator(device).manual_seed(SEED + 33)
    latents = (("bf16", ts.EXACT, lambda: a.to(torch.bfloat16)),
               ("f32", ts.F32, lambda: a.clone()),
               ("bf16_float", ts.BF16, lambda: torch.relu_(torch.randn(
                   (m, 2 * n), generator=gd, device=device)).to(torch.bfloat16)))
    for name, kind, make in latents:
        acts = edge_rows(make(), kind)
        for p in (2, 4):
            check(name, acts, kind, p)
            record[f"{name}_p{p}"] = timed(name, acts, kind, p, k_multi)
            record[f"{name}_p{p}_k{k}"] = timed(name, acts, kind, p, 0)
        del acts
        torch.cuda.empty_cache()
    del a
    # edge widths, at 3,000 rows (300 for the widest f32 shard)
    small = torch.relu(torch.randn((3000, 4 * 1001), generator=gen)).to(device)
    for name, kind, dtype, signed in (("bf16", ts.EXACT, torch.bfloat16, False),
                                      ("bf16 signed", ts.BF16, torch.bfloat16, True),
                                      ("f32", ts.F32, torch.float32, False)):
        for p in (2, 4):
            unaligned = edge_rows(small[:, :1001 * p].to(dtype), kind)
            check(f"{name} shards of 1,001 columns", unaligned, kind, p, signed)
            narrow = edge_rows(small[:, :100 * p].to(dtype), kind)
            check(f"{name} shards of 100 columns (< k_sel)", narrow, kind, p, signed)
    wide = edge_rows(torch.relu(torch.randn((300, 2 * 52379), generator=gen)).to(device),
                     ts.F32)
    check("f32 shards of 52,379 columns", wide, ts.F32, 2, whole_plain=True)
    record["edges"] = {"unaligned_shard": 1001, "narrow_shard": 100,
                       "f32_widest_shard": [300, 52379]}
    del small, wide
    torch.cuda.empty_cache()
    return record


def check_topk_sharded_fused(torch, device, card) -> dict:
    """Phase 31a, kernel #4 on a split dictionary: its encode and decode
    launches at large_v1_audioset's shard of a dictionary split in two
    ((48,000 × 1280) → 10,240), in this process. Each shard's acts bit-equal
    to the whole forward's columns and within one ulp of the plain encode
    (on fewer than 1e-3 of entries); the selection across both shards (the
    gather a stack) gives the whole forward's thresholds; each shard's
    decode within 1e-3 of max of the plain decode of its own acts under
    them, and the shards' decodes summed within 1e-3 of max of the whole
    forward's; two launches of each bit-equal. Both timed beside their
    bounds and plain versions, with the bf16 product alone (torch.mm) as
    the library's core."""
    from freud_tpu_torch import flops
    from freud_tpu_torch.ops import topk_sharded as ts
    from freud_tpu_torch.ops.topk_fused import (topk_sae_decode, topk_sae_decode_plain,
                                                topk_sae_encode, topk_sae_encode_plain,
                                                topk_sae_forward)

    gen = torch.Generator().manual_seed(SEED + 32)
    m, n, d, k_aux, p = LARGE_M_ROWS, LARGE_N_DICT, LARGE_D, LARGE_K_AUX, 2
    x, w_enc, b_enc, b_dec, w_dec = _topk_inputs(torch, device, m, gen, d, n)
    dead = (torch.rand((n,), generator=gen) < 1 / 3).to(device)
    dead_f = dead.float()
    s = n // p
    cols = [slice(i * s, (i + 1) * s) for i in range(p)]
    whole = topk_sae_forward(x, w_enc.T, b_enc, b_dec, w_dec, dead_f, K, k_aux)

    def encode(c):
        return topk_sae_encode(x, w_enc[c].T, b_enc[c], b_dec)

    acts_s = [encode(c) for c in cols]
    kind = ts.key_kind(acts_s[0], n)
    g = torch.stack([ts.shard_candidates(a, dead[c], K, k_aux, kind)
                     for a, c in zip(acts_s, cols)])
    sel = [ts.combine_shard_thresholds(g, a, n, K, k_aux, 0, kind) for a in acts_s]
    parts = [topk_sae_decode(a, w_dec[c], dead_f[c], t[0], t[1])
             for a, c, t in zip(acts_s, cols, sel)]
    torch.cuda.synchronize()
    enc_err = dec_err = 0.0
    agreement = []
    for a, c, t, part in zip(acts_s, cols, sel, parts):
        assert torch.equal(a, whole[0][:, c]), "a shard's acts differ from the whole forward's"
        assert torch.equal(a, encode(c)), "two encode launches differ"
        assert torch.equal(t[0], whole[3]) and torch.equal(t[1], whole[4])
        plain = topk_sae_encode_plain(x, w_enc[c].T, b_enc[c], b_dec)
        share, max_ulp = _acts_agreement(a, plain, x, w_enc[c], b_dec)
        bound = _acts_sum_bound(a, plain, x, w_enc[c], b_dec)
        agreement.append(dict(share=share, max_ulp=max_ulp, **bound))
        # over 48,000 rows a cancelling sum can put the two orders' z more
        # than one of its ulps apart (phase 2's 3,000 rows stay within
        # one), so the entries hold to the summation bound
        assert share < 1e-3 and bound["sum_bound_ratio"] <= 1, agreement[-1]
        enc_err = max(enc_err, (a.float() - plain.float()).abs().max().item())
        del plain
        want = topk_sae_decode_plain(a, w_dec[c], dead_f[c], t[0], t[1])
        again = topk_sae_decode(a, w_dec[c], dead_f[c], t[0], t[1])
        for got, w, a2 in zip(part, want, again):
            assert torch.equal(got, a2), "two decode launches differ"
            err = (got - w).abs().max().item()
            assert err <= 1e-3 * max(w.abs().max().item(), 1e-30), err
            dec_err = max(dec_err, err)
    sum_rel = max(((parts[0][i] + parts[1][i] - whole[1 + i]).abs().max()
                   / whole[1 + i].abs().max().clamp_min(1e-30)).item() for i in (0, 1))
    assert sum_rel < 1e-3, sum_rel
    # timing on shard 0
    c0, a0, (t_main, t_aux, _, _) = cols[0], acts_s[0], sel[0]
    selected = _selected(a0.float(), t_main, t_aux, dead[c0])
    enc_ms = cuda_ms(lambda: encode(c0), reps=10)
    enc_plain = cuda_ms(lambda: topk_sae_encode_plain(x, w_enc[c0].T, b_enc[c0], b_dec),
                        warmup=1, reps=3)
    xs = (x - b_dec).to(torch.bfloat16)
    wt = w_enc[c0].to(torch.bfloat16).T
    enc_core = cuda_ms(lambda: torch.mm(xs, wt), reps=10)
    dec_args = (a0, w_dec[c0], dead_f[c0], t_main, t_aux)
    dec_ms = cuda_ms(lambda: topk_sae_decode(*dec_args), reps=10)
    dec_plain = cuda_ms(lambda: topk_sae_decode_plain(*dec_args), warmup=1, reps=3)
    wd = w_dec[c0].to(torch.bfloat16)
    dec_core = cuda_ms(lambda: torch.mm(a0, wd), reps=10)
    eb = flops.topk_sae_encode_bound(m, d, s)
    db = flops.topk_sae_decode_bound(m, d, s, selected)
    assert enc_ms >= eb.bound_ms and dec_ms >= db.bound_ms, (enc_ms, dec_ms)
    print(f"kernel #4 on a split dictionary, shard {m}×{d}→{s} of {n}: acts bit-equal to the "
          f"whole forward's columns, against the plain encode {agreement} (share differing "
          f"< 1e-3, |Δ| within the f32 summation bound), thresholds across the shards equal "
          f"to its own, the "
          f"shards' decodes summed within {sum_rel:.2e} of max of its decodes; encode "
          f"{enc_ms:.4f} ms (bound {eb.bound_ms:.4f}, plain {enc_plain:.4f}, torch.mm alone "
          f"{enc_core:.4f}), decode {dec_ms:.4f} ms (bound {db.bound_ms:.4f}, {selected} "
          f"selected entries; plain {dec_plain:.4f}, torch.mm alone {dec_core:.4f}) on {card}")
    record = {
        "shape": [m, d, s], "shards": p, "whole_n_dict": n, "summed_decode_rel": sum_rel,
        "acts_vs_plain": agreement,
        "encode": dict(name="topk_sae_encode", max_abs_err=enc_err, ms=enc_ms,
                       plain_ms=enc_plain, library_core_ms=enc_core, **yardsticks(
            eb, None, "none: no one PyTorch call rounds the product to bf16, adds the "
            "bf16 bias and applies the ReLU; library_core_ms is torch.mm of the bf16 "
            "operands alone")),
        "decode": dict(name="topk_sae_decode", max_abs_err=dec_err, ms=dec_ms,
                       plain_ms=dec_plain, library_core_ms=dec_core, selected=selected,
                       **yardsticks(db, None, "none: no one PyTorch call decodes under two "
                                    "per-row masks; library_core_ms is the dense bf16 "
                                    "product acts · W_dec alone")),
    }
    del x, w_enc, w_dec, whole, acts_s, g, parts, xs, wt, wd
    torch.cuda.empty_cache()
    return record


def model_axis_setup(variant: str, rows: int) -> tuple[dict, dict]:
    """large_v1_audioset's (or large_v3_l1's) autoencoder config and trainer
    keywords for phase 31 (AuxK from step 2; 2 warm-up steps so the first
    updates move the parameters)."""
    name = "large_v1_audioset" if variant == "topk" else "large_v3_l1"
    base = json.loads((REPO / f"configs/train/{name}.json").read_text())
    ae = dict(base["autoencoder_config"])
    if variant == "topk":
        ae["dead_feature_threshold"] = rows // 2
    kw = dict(optimizer=base["optimizer"], scheduler=base["scheduler"],
              scheduler_params={"num_warmup_steps": 2}, lr=base["lr"], steps=100,
              clip_thresh=base["clip_thresh"], seed=SEED)
    return ae, kw


def model_axis_batch(i: int) -> np.ndarray:
    """Step i's global batch: seeded normal rows at d_in 1280 around a fixed
    mean of ±3 an entry, as a layer's activations sit off the origin (with
    isotropic rows every latent fires and AuxK never starts)."""
    mean = 3.0 * np.sign(np.random.default_rng(SEED + 309).standard_normal(LARGE_D))
    rng = np.random.default_rng(SEED + 310 + i)
    x = rng.standard_normal((MODEL_AXIS_BATCH, 1500, LARGE_D), dtype=np.float32)
    return x + mean.astype(np.float32)


def model_axis_worker(rank: int, port: int, spec_path: str) -> int:
    """One rank of phase 31b: a data 1 × model 2 mesh over two gloo ranks on
    cuda:0, the dictionary split in two."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = json.loads(Path(spec_path).read_text())
    from freud_tpu_torch.models.sae import topk as topk_mod
    from freud_tpu_torch.ops import topk_sharded as ts
    from freud_tpu_torch.ops.topk_backward import topk_masked_pair, topk_route
    from freud_tpu_torch.ops.topk_fused import (topk_sae_decode, topk_sae_encode,
                                                topk_sae_forward)
    from freud_tpu_torch.ops.topk_threshold import topk_thresholds_fired
    from freud_tpu_torch.parallel import distributed as dist_lib
    from freud_tpu_torch.parallel import mesh as mesh_lib
    from freud_tpu_torch.train.trainer import SAETrainer, _param_list

    dist_lib.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo", device="cuda:0",
                        timeout_s=POD_TIMEOUT_S)
    mesh = mesh_lib.make_mesh(model_parallel=2)
    assert mesh.shape == {"data": 1, "model": 2} and mesh.backend == "gloo", mesh
    kernels = (topk_sae_forward, topk_sae_encode, topk_sae_decode, topk_thresholds_fired,
               ts.shard_candidates, ts.combine_shard_thresholds, topk_masked_pair, topk_route)
    rows = MODEL_AXIS_BATCH * 1500

    def zero():
        for fn in kernels:
            fn.launches = 0

    def read() -> dict:
        torch.cuda.synchronize()
        return {fn.__name__: fn.launches for fn in kernels}

    # the selection inside the sharded step, and kernel #4's in the shadow's
    seen: dict = {}
    sharded_fn, fused_fn = topk_mod.sharded_thresholds_fired, topk_mod.topk_sae_forward

    def sharded_spy(acts, dead, *a, **kw):
        out = sharded_fn(acts, dead, *a, **kw)
        seen["sharded"] = (acts, dead, out)
        return out

    def fused_spy(*a, **kw):
        out = fused_fn(*a, **kw)
        seen["fused"] = out
        return out

    topk_mod.sharded_thresholds_fired = sharded_spy
    topk_mod.topk_sae_forward = fused_spy

    def load_into(shadow, full):
        params, leaves, counter = full
        with torch.no_grad():
            for d, src in zip(_param_list(shadow.variant, shadow.params),
                              _param_list(shadow.variant, params)):
                d.copy_(src)
        shadow.opt.load_state_leaves(leaves)
        shadow.num_frames_since_fired.copy_(counter)

    def rel(a, b) -> float:
        return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp(
            min=1e-30))

    rec: dict = {"rank": rank, "rows": rows}
    launches = {fn.__name__: 0 for fn in kernels}
    for variant, n_steps in (("topk", MODEL_AXIS_STEPS), ("l1", 1)):
        ae, kw = model_axis_setup(variant, rows)
        t0 = time.perf_counter()
        tr = SAETrainer(variant, ae, LARGE_D, mesh=mesh, shard_dict=True, **kw)
        init_s = time.perf_counter() - t0
        shadow = SAETrainer(variant, ae, LARGE_D, device="cuda:0", **kw) if rank == 0 else None
        steps = []
        for i in range(n_steps):
            x = model_axis_batch(i)
            full = tr._full_state()  # the state before the step, gathered
            dead_full = full[2] > tr.dead_feature_threshold
            zero()
            m = tr.train_step(x)
            metrics = {k: float(v) for k, v in m.items()}
            got = read()
            for key in launches:
                launches[key] += got[key]
            step: dict = {"metrics": metrics, "launches": got}
            if variant == "topk":
                acts_s, dead_s, (t_main, t_aux, _, fired_s) = seen["sharded"]
                assert torch.equal(dead_s, dead_full[tr.dict_lo:tr.dict_hi])
                # kernel #3 on the whole latent: the shards' latents gathered
                whole = mesh_lib.gather_dict(mesh, acts_s.contiguous(), 1)
                fired = mesh_lib.gather_dict(mesh, fired_s, 0)
                w = topk_thresholds_fired(whole, dead_full, ae["k"], LARGE_D // 2)
                torch.cuda.synchronize()
                assert torch.equal(t_main, w[0]) and torch.equal(t_aux, w[1]), i
                assert torch.equal(fired, w[3]), i
                step["dead"] = int(dead_full.sum())
                step["selection_bit_equal_to_kernel3"] = True
                del whole, acts_s
                seen.pop("sharded")
            if shadow is not None:
                load_into(shadow, full)
                sm = {k: float(v) for k, v in shadow.train_step(x).items()}
                step["metric_rel"] = {k: abs(sm[k] - v) / max(abs(sm[k]), 1e-30)
                                      for k, v in metrics.items()}
                if variant == "topk":
                    f_main, f_aux = seen.pop("fused")[3:5]
                    step["rows_t_main_differ"] = int((f_main != t_main).sum())
                    step["rows_t_aux_differ"] = int((f_aux != t_aux).sum())
            after = tr._full_state()
            if shadow is not None:
                step["param_rel"] = max(rel(a, b) for a, b in zip(
                    _param_list(variant, after[0]), _param_list(variant, shadow.params)))
                step["counters_equal"] = bool(torch.equal(after[2],
                                                          shadow.num_frames_since_fired))
            steps.append(step)
            del full, after
        walls = []  # ms a step: more sharded steps, no shadow
        zero()
        for i in range(MODEL_AXIS_TIMED_STEPS):
            x = model_axis_batch(n_steps + i)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            tr.train_step(x)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t1))
        launches_timed = read()
        for key in launches:
            launches[key] += launches_timed[key]
        rec[variant] = {"steps": steps, "step_ms": walls, "init_s": init_s,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del tr, shadow
        torch.cuda.empty_cache()
    rec["launches"] = launches
    dist_lib.barrier()
    dist_lib.shutdown()
    Path(spec["out"], f"model_axis_rank{rank}.json").write_text(json.dumps(rec))
    return 0


def model_axis_nccl_world1(torch, device, tmp: Path) -> dict:
    """Phase 31c: NCCL at world size 1 in this process, large_v1_audioset at
    batch 8: ``SAETrainer(shard_dict=True)`` on ``make_mesh(model_parallel=1)``
    bit-equal to the unsharded trainer for 3 steps, and one pod chunk of 5
    captured with its NCCL collectives and replayed as a CUDA graph, bit-equal
    to its steps run eagerly."""
    from freud_tpu_torch.data.device_cache import DeviceShuffleCache, sample_rows
    from freud_tpu_torch.data.store import ActivationStoreWriter
    from freud_tpu_torch.ops.topk_fused import topk_sae_forward
    from freud_tpu_torch.parallel import distributed as dist_lib
    from freud_tpu_torch.parallel import mesh as mesh_lib
    from freud_tpu_torch.train.trainer import SAETrainer

    batch, rows = 8, 8 * 1500
    store = tmp / "model_axis_store"
    rng = np.random.default_rng(SEED + 313)
    w = ActivationStoreWriter(store, LARGE_LAYER, (1500, LARGE_D), (1500, LARGE_D))
    w.append_batch([f"f{j:02d}.wav" for j in range(2 * batch)],
                   rng.standard_normal((2 * batch, 1500, LARGE_D), dtype=np.float32),
                   n_frames=[1500] * (2 * batch))
    w.close()
    ae, kw = model_axis_setup("topk", rows)
    dist_lib.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cuda:0")
    try:
        mesh = mesh_lib.make_mesh(model_parallel=1)
        assert (mesh.backend, mesh.size, mesh.shape["model"]) == ("nccl", 1, 1), mesh
        sharded = SAETrainer("topk", ae, LARGE_D, mesh=mesh, shard_dict=True, **kw)
        whole = SAETrainer("topk", ae, LARGE_D, device=device, **kw)
        for a, b in zip(sharded._state(), whole._state()):
            assert torch.equal(a, b), "the sharded trainer's start differs"
        cache = DeviceShuffleCache(str(store), LARGE_LAYER, 2 * batch, refresh_files=0,
                                   seed=SEED, mesh=mesh)
        try:
            for i in range(3):
                x = cache.next_batch(batch)
                sharded.train_step(x, host_local=True)
                whole.train_step(x)
            for a, b in zip(sharded._state(), whole._state()):
                assert torch.equal(a, b), "shard_dict at P = 1 differs from the unsharded trainer"
            assert sharded.chunk_is_graph(cache.cache)
            gen = torch.Generator(device=device).manual_seed(SEED + 17)
            idx = torch.randint(0, cache.capacity, (POD_CHUNK, batch), generator=gen,
                                device=device)
            start = [t.detach().clone() for t in sharded._state()]
            topk_sae_forward.launches = 0
            gm = sharded.train_chunk_pod(cache, batch, POD_CHUNK, indices=idx)
            torch.cuda.synchronize()
            graph_launches = topk_sae_forward.launches
            g_state = [t.detach().clone() for t in sharded._state()]
            with torch.no_grad():
                for t, s in zip(sharded._state(), start):
                    t.copy_(s)
            eager = [sharded._step(sample_rows(cache.cache, idx[i]), mesh)
                     for i in range(POD_CHUNK)]
            e_state = [t.detach().clone() for t in sharded._state()]
        finally:
            cache.close()
        bit_equal = all(torch.equal(g, e) for g, e in zip(g_state, e_state)) and all(
            torch.equal(gm[k], torch.stack([e[k] for e in eager])) for k in gm)
    finally:
        dist_lib.shutdown()
    print(f"NCCL at world size 1, shard_dict on a model axis of 1 at d_in {LARGE_D}: 3 steps "
          "bit-equal to the unsharded trainer; a pod chunk of "
          f"{POD_CHUNK} replayed as a CUDA graph {'bit-equal to' if bit_equal else 'DIFFERS from'}"
          f" its eager steps (kernel #4 launches {graph_launches})")
    assert bit_equal
    assert graph_launches == POD_CHUNK + 1, graph_launches
    return {"steps_bit_equal": True, "graph_bit_equal": bit_equal,
            "graph_launches": graph_launches, "batch": batch}


def model_axis_phases(torch, device, tmp: Path, card: str) -> dict:
    """Phase 31: the model axis. (a) the selection across shards and kernel
    #4's encode and decode launches on a shard, in this process; (b) two gloo ranks on cuda:0 as a data 1 × model 2 mesh
    training large_v1_audioset (3 steps against one process from the
    sharded state, 2 timed) and one large_v3_l1 step; (c) NCCL at world
    size 1 with shard_dict on a model axis of 1. → the record, with the
    sharded launches of (b)."""
    free_device_memory(torch)
    t_start = time.perf_counter()
    rec: dict = {"selection": check_topk_sharded(torch, device, card),
                 "kernel4": check_topk_sharded_fused(torch, device, card)}
    out = tmp / "model_axis"
    out.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    ranks = pod_spawn(torch, {"out": str(out)}, flag="--model-axis-rank",
                      report="model_axis_rank{}.json")
    rec["pair_seconds"] = time.perf_counter() - t0
    for r in ranks:
        for variant in ("topk", "l1"):
            for st in r[variant]["steps"]:
                # kernel #4's encode and decode around the selection across
                # shards, never the whole forward (its thresholds would be
                # one shard's)
                assert st["launches"]["topk_sae_forward"] == 0, st
                one = int(variant == "topk")
                for key in ("topk_sae_encode", "topk_sae_decode", "shard_candidates",
                            "combine_shard_thresholds", *BACKWARD_PASSES):
                    assert st["launches"][key] == one, (key, st)
                if variant == "topk":
                    assert st["selection_bit_equal_to_kernel3"]
    shadow = ranks[0]
    for st in shadow["topk"]["steps"]:
        assert max(st["metric_rel"].values()) < 1e-5, st["metric_rel"]
        # the shards' acts are kernel #4's own columns: the same thresholds
        assert st["rows_t_main_differ"] == 0 and st["rows_t_aux_differ"] == 0, st
        assert st["counters_equal"], st
    assert shadow["topk"]["steps"][-1]["dead"] > 0, "AuxK never ran"
    l1 = shadow["l1"]["steps"][0]
    assert max(l1["metric_rel"].values()) < 1e-2, l1["metric_rel"]
    rec["ranks"] = ranks
    rec["nccl_world1"] = model_axis_nccl_world1(torch, device, tmp)
    free_device_memory(torch)
    rec["launches"] = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    for key in ("topk_sae_encode", "topk_sae_decode", "shard_candidates",
                "combine_shard_thresholds", *BACKWARD_PASSES):
        assert rec["launches"][key] > 0, rec["launches"]
    rec["seconds"] = time.perf_counter() - t_start
    ms = statistics.median(shadow["topk"]["step_ms"])
    l1_ms = statistics.median(shadow["l1"]["step_ms"])
    print(f"phase 31 in {rec['seconds']:.1f} s (the pair {rec['pair_seconds']:.1f} s): "
          f"large_v1_audioset sharded over 2 gloo ranks SHARING one card, batch "
          f"{MODEL_AXIS_BATCH}: {ms:.1f} ms a step (not a scaling number); per step "
          f"vs one process: metrics {[max(s['metric_rel'].values()) for s in shadow['topk']['steps']]}"
          f" relative, params {[s['param_rel'] for s in shadow['topk']['steps']]} of max, rows "
          f"whose t_main differs from kernel #4's {[s['rows_t_main_differ'] for s in shadow['topk']['steps']]}"
          f"; large_v3_l1 step: {l1_ms:.1f} ms a step (the same two ranks), metrics "
          f"{max(l1['metric_rel'].values()):.2e}, params {l1['param_rel']:.2e}; launches "
          f"{rec['launches']} on {card}")
    return rec


def model_axis_only(torch, device, card: str) -> dict:
    """Phase 31 alone (after the build)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_model_axis_") as tmp:
        return model_axis_phases(torch, device, Path(tmp), card)


def topk_only(torch, device, card: str) -> dict:
    """Phase 2's TopK checks alone (after the build): kernels #3 and #4, the
    selection core's other two callers, to time beside the sharded
    launches, the TopK backward's passes and the SAE encode's indexed
    selection."""
    return {"topk_sae_forward": check_topk_fused(torch, device, card),
            "topk_thresholds_fired": check_topk_threshold(torch, device, card),
            **check_topk_backward(torch, device, card),
            "topk_indexed": check_topk_indexed(torch, device, card)}


# --knockouts: copies of the sharded selection's sources, each with one part
# taken out; (file, start, stop, text) replaces [start, stop) by text, or
# start itself when stop is None. A copy is built where all its marks are
# in the tree's sources: the first five in PR 14's design, the rest in the
# redesign on the selection core. Their results are wrong; only the time
# is read.
_FIRED_KEY = "    const uint32_t fk = Row::kBits == 16 ? 0xC000u : 0xC0000000u;  // 2.0\n"
KNOCKOUTS = {
    "cand_no_emit": [("topk_sharded.cu",
                      "    for (int j = tid; j < n; j += kNT) {\n      const uint32_t key = keys[j];",
                      "    if (tid < 4) o[c_main + k_aux + tid] = red[tid];", "")],
    "cand_16B_loads": [("topk_sharded.cu",
                        "    for (int j = tid; j < n; j += kNT) {\n      const uint32_t key = "
                        "load_key<Row>(acts, row, n, j);",
                        "    lo_a = __reduce_min_sync(kFull, lo_a);", """\
    for (int c = tid; c < (n >> 3); c += kNT) {
      const uint4 v = reinterpret_cast<const uint4*>(acts)[(static_cast<size_t>(row) * n >> 3) + c];
      const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = c * 8 + e;
        const uint32_t key = Row::key((wd[e >> 1] >> (16 * (e & 1))) & 0xFFFFu);
        keys[j] = key;
        const uint32_t km = finite_key<Row>(key) ? key : kNone;
        lo_a = min(lo_a, km);
        hi_a = max(hi_a, key);
        if ((dead[j >> 5] >> (j & 31)) & 1u) {
          lo_d = min(lo_d, km);
          hi_d = max(hi_d, key);
        }
      }
    }
""")],
    "comb_no_fired": [("topk_sharded.cu",
                       "    // this shard's fired columns: a warp tests 32 consecutive columns",
                       "    __syncthreads();  // the candidates are reused by the next row", "")],
    "comb_fired_only": [("topk_sharded.cu",
                         "    // the headers: global range, dead count, each shard's aux count",
                         "    // this shard's fired columns: a warp tests 32 consecutive columns",
                         _FIRED_KEY)],
    "cand_emit_held": [("topk_select.cuh", "  if (from_stage && radix[0]) {", None,
                        "  if (false) {")],
    "cand_key_range": [("topk_select.cuh",
                        "    if constexpr (kCand && Row::kBits == 16) {\n      packed_range", None,
                        "    if constexpr (false) {\n      packed_range")],
    "cand_stage_eighth": [("topk_select.cuh", "  if constexpr (kCand) {\n    const size_t want",
                           None, "  if constexpr (false) {\n    const size_t want")],
    "cand_dead_unstaged": [("topk_select.cuh", "        if (use && !radix[kAux]) cut_dead = 0u;",
                            None, "        if (false) cut_dead = 0u;"),
                           ("topk_select.cuh", "  if (from_stage && radix[0]) {", None,
                            "  if (from_stage && radix[0] && radix[kAux]) {")],
    "comb_no_select": [("topk_sharded.cu", "    kth[0] = sel[0] ?", None,
                        "    for (int i = 0; i < topk::kMaxSel; ++i) sel[i] = false;\n"
                        "    kth[0] = sel[0] ?")],
    "comb_no_cut": [("topk_sharded.cu", "    if (Bits == 32 && keep && b == 15)", None,
                     "    if (false)")],
    "comb_no_fired_stream": [("topk_sharded.cu", "    // this shard's fired columns\n",
                              "  }\n  __syncthreads();\n  for (int w = tid; w < nwords; "
                              "w += blockDim.x)", "")],
    "comb_fired_stream_only": [("topk_sharded.cu",
                                "    // the headers: global range and dead count",
                                "    // this shard's fired columns\n", _FIRED_KEY)],
}


def knockouts(torch, device, card: str) -> dict:
    """The sharded selection's launches against copies with one part taken
    out (KNOCKOUTS; those whose marks this tree's sources hold), each
    built by nvcc into a temporary directory and called through the
    wrappers with its library swapped in, two rounds, at large_v1_audioset's
    latent split in 2 and 4 (bf16 exact path and f32, k_multi 128, a third
    dead; candidates also with none dead), beside kernel #3 on the same
    shard. → medians in ms."""
    import ctypes

    from freud_tpu_torch import _native
    from freud_tpu_torch.ops import topk_sharded as ts
    from freud_tpu_torch.ops.topk_threshold import topk_thresholds_fired

    csrc = REPO / "freud_tpu_torch" / "csrc"
    sources = {f.name: f.read_text() for f in csrc.iterdir()}
    copies = {"base": dict(sources)}
    for name, edits in KNOCKOUTS.items():
        text = dict(sources)
        if not all(e[1] in text[e[0]] and (e[2] is None or e[2] in text[e[0]]) for e in edits):
            continue
        for f, start, stop, new in edits:
            i = text[f].index(start)
            j = i + len(start) if stop is None else text[f].index(stop, i)
            text[f] = text[f][:i] + new + text[f][j:]
        copies[name] = text
    libs: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ko_") as tmp:
        procs = {}
        for name, text in copies.items():
            d = Path(tmp) / name
            d.mkdir()
            for f, body in text.items():
                (d / f).write_text(body)
            procs[name] = subprocess.Popen(
                [_native._nvcc(), *_native.NVCC_FLAGS, "-o", str(d / "lib.so"),
                 str(d / "topk_sharded.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, proc in procs.items():
            log = proc.communicate()[0]
            assert proc.returncode == 0, f"knock-out {name} did not build:\n{log}"
            libs[name] = ctypes.CDLL(str(Path(tmp) / name / "lib.so"))
    print(f"knock-outs built: {list(libs)}")
    real = _native.swap_library("topk_sharded", libs["base"])

    def use(name):
        _native.swap_library("topk_sharded", libs[name])

    gen = torch.Generator().manual_seed(SEED + 34)
    m, n, k, k_aux, k_multi = LARGE_M_ROWS, LARGE_N_DICT, K, LARGE_K_AUX, 4 * K
    a = torch.relu(torch.randn((m, n), generator=gen)).to(device)
    dead = (torch.rand((n,), generator=gen) < 1 / 3).to(device)
    rec: dict = {"card": card}
    try:
        for label, dtype, kind, p in (("bf16_p2", torch.bfloat16, ts.EXACT, 2),
                                      ("bf16_p4", torch.bfloat16, ts.EXACT, 4),
                                      ("f32_p2", torch.float32, ts.F32, 2),
                                      ("f32_p4", torch.float32, ts.F32, 4)):
            acts = a.to(dtype)
            s = n // p
            shard = [acts[:, i * s:(i + 1) * s].contiguous() for i in range(p)]
            dead_s = list(dead.view(p, -1).unbind(0))
            none = torch.zeros_like(dead_s[0])
            row = {"kernel3_on_the_shard": cuda_ms(lambda: topk_thresholds_fired(
                shard[0], dead_s[0], k, k_aux, k_multi=k_multi), reps=10)}
            use("base")
            g = torch.stack([ts.shard_candidates(x, d, k_multi, k_aux, kind)
                             for x, d in zip(shard, dead_s)])
            for _ in range(2):
                for name in libs:
                    use(name)
                    row.setdefault(name, []).append({
                        "candidates": cuda_ms(lambda: ts.shard_candidates(
                            shard[0], dead_s[0], k_multi, k_aux, kind), reps=10),
                        "candidates_none_dead": cuda_ms(lambda: ts.shard_candidates(
                            shard[0], none, k_multi, k_aux, kind), reps=10),
                        "combine": cuda_ms(lambda: ts.combine_shard_thresholds(
                            g, shard[0], n, k, k_aux, k_multi, kind), reps=10)})
            rec[label] = row
            print(f"knock-outs {label}: {json.dumps(row)}")
            del acts, shard, g
            torch.cuda.empty_cache()
    finally:
        _native.swap_library("topk_sharded", real)
    return rec


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def flat_tensors(tree, prefix: str = ""):
    """(path, tensor) pairs of a checkpoint's nested dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_tensors(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat_tensors(v, f"{prefix}/{i}")
    elif hasattr(tree, "shape"):
        yield prefix, tree


def read_store(folder: Path, layer: str = LAYER):
    meta = json.loads((folder / f"{layer}_metadata.json").read_text())
    rows = np.load(folder / f"{layer}_tensors.npy", mmap_mode="r")
    return meta, rows.reshape(rows.shape[0], *meta["tensor_shape"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bench", action="store_true",
                    help="time the kernels and the large paths instead of the smoke")
    ap.add_argument("--pod-only", action="store_true",
                    help="phases 28-30 alone, on stores made here (a quick card check)")
    ap.add_argument("--model-axis-only", action="store_true",
                    help="phase 31 (the model axis) alone (a quick card check)")
    ap.add_argument("--topk-only", action="store_true",
                    help="phase 2's TopK checks alone (kernels #3, #4, the backward's passes)")
    ap.add_argument("--moe-only", action="store_true",
                    help="the MoE kernels of Uni-MoE-2.0-Omni alone (a quick card check)")
    ap.add_argument("--knockouts", action="store_true",
                    help="time the sharded selection's launches against copies with one "
                         "part taken out")
    ap.add_argument("--pod-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--model-axis-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--nccl-probe-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--pod-port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--pod-spec", type=str, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 1
    if args.pod_rank is not None:  # one rank of phases 28 and 30 (pod_spawn)
        return pod_worker(args.pod_rank, args.pod_port, args.pod_spec)
    if args.nccl_probe_rank is not None:  # one rank of nccl_two_ranks
        return nccl_probe_worker(args.nccl_probe_rank, args.pod_port)
    if args.model_axis_rank is not None:  # one rank of phase 31b
        return model_axis_worker(args.model_axis_rank, args.pod_port, args.pod_spec)
    from freud_tpu_torch import _native, profiling
    from freud_tpu_torch.analysis.features import activation_length_from_samples
    from freud_tpu_torch.ops.attention import fused_qkv_attention, whisper_attention
    from freud_tpu_torch.ops.gemm_f32x3 import gemm_f32x3
    from freud_tpu_torch.ops.mel import log_mel_spectrogram_cuda
    from freud_tpu_torch.ops.topk_backward import topk_masked_pair, topk_route
    from freud_tpu_torch.ops.topk_fused import topk_sae_forward
    from freud_tpu_torch.ops.topk_indexed import topk_indexed
    from freud_tpu_torch.ops.topk_threshold import topk_thresholds_fired

    # phase 0 — the card
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} × {torch.cuda.device_count()}")
    try:
        import tensorboard  # noqa: F401 — host-side logging only
        print("tensorboard: imports; the trainer logs through torch.utils.tensorboard")
    except ImportError:
        print("tensorboard: missing; the trainer runs with TensorBoard logging off")
    device = torch.device("cuda:0")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # phase 1 — build, one nvcc per source, all at once
    t0 = time.perf_counter()
    _native.cuda_libraries(*_native.SIGNATURES)
    print(f"built kernels in {time.perf_counter() - t0:.2f} s "
          f"({ {k: round(v, 2) for k, v in _native.build_seconds.items()} })")
    for name, log in _native.build_logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  ptxas[{name}] {ln.strip()}")
    if args.bench:
        print(json.dumps(bench(torch, device, card)))
        return 0
    if args.pod_only:
        print(json.dumps({"pod": {**pod_only(torch, device, card), "card": card}}))
        return 0
    if args.model_axis_only:
        print(json.dumps({"model_axis": {**model_axis_only(torch, device, card),
                                         "card": card}}))
        return 0
    if args.topk_only:
        print(json.dumps({"topk": {**topk_only(torch, device, card), "card": card}}))
        return 0
    if args.knockouts:
        print(json.dumps({"knockouts": knockouts(torch, device, card)}))
        return 0
    if args.moe_only:
        print(json.dumps({"moe": {**check_moe(torch, device, card),
                                  "omni_forward": check_omni_forward(torch, device, card),
                                  **check_longcat_moe(torch, device, card),
                                  "longcat_forward": check_longcat_forward(torch, device, card),
                                  "card": card}}))
        return 0
    from freud_tpu_torch import flops

    assert flops.device_peaks() is not None, "the card is not in flops' peak table"

    # phase 2 — kernels against their plain versions
    mel_rec = check_mel(torch, device, card)
    attn_rec = check_attention(torch, device, card)
    wattn_rec = check_whisper_attention(torch, device, card)
    fused_rec = check_topk_fused(torch, device, card)
    thresh_rec = check_topk_threshold(torch, device, card)
    backward_recs = check_topk_backward(torch, device, card)
    indexed_rec = check_topk_indexed(torch, device, card)
    gemm_rec = check_gemm_f32x3(torch, device, card)
    moe_recs = check_moe(torch, device, card)
    omni_rec = check_omni_forward(torch, device, card)
    lc_moe_recs = check_longcat_moe(torch, device, card)
    lc_rec = check_longcat_forward(torch, device, card)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        audio_dir = tmp / "audio"
        audio_dir.mkdir()
        clips = write_wavs(
            audio_dir, [480000] * N_LONG + [int(16000 * t) for t in N_SHORT_S],
            broken=True)
        n_files = len(clips)
        n_batches = -(-n_files // BATCH)
        base = json.loads(
            (REPO / "configs/features/tiny_block_2_test.json").read_text())
        config = {**base, "whisper_model": "random:tiny", "batch_size": BATCH,
                  "data_path": str(audio_dir), "out_folder": str(tmp / "card")}
        assert config["layer_name"] == LAYER and config["device"] == "tpu"

        # phase 3 — the slice at full width, counting kernel launches
        log_mel_spectrogram_cuda.launches = 0
        fused_qkv_attention.launches = 0
        t0 = time.perf_counter()
        stats = collect(config, tmp / "card.json")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"log_mel": log_mel_spectrogram_cuda.launches,
                    "fused_qkv_attention": fused_qkv_attention.launches}
        print(f"launches in the collection run: {launches} "
              f"({n_batches} batches)")
        assert launches["log_mel"] >= n_batches, launches
        assert launches["fused_qkv_attention"] >= 3 * n_batches, launches
        per_unit = {k: (v / n_batches, "collection batch") for k, v in launches.items()}

        meta, store = read_store(tmp / "card")
        assert store.shape == (n_files, 1500, 384), store.shape
        assert np.isfinite(store).all()
        assert meta["filenames"] == [p for p, _ in clips]
        assert meta["tensor_shape"] == [1500, 384]
        assert meta["activation_shape"] == [1500, 384]
        assert meta["n_frames"] == [activation_length_from_samples(n)
                                    for _, n in clips]
        assert stats["n_files"] == n_files
        print(f"collection (cold, incl. model init): {n_files} files in "
              f"{wall:.3f} s wall; CLI rtfx {stats['rtfx']:.1f} on {card}")
        warm = collect({**config, "out_folder": str(tmp / "warm")},
                       tmp / "warm.json")
        print(f"collection (warm): {warm['n_files'] / warm['elapsed_s']:.2f} "
              f"files/s, RTFx {warm['rtfx']:.1f} on {card}")

        # phase 4 — the card against the CPU plain path on 2 files
        cpu = collect({**config, "device": "cpu", "collect_max": 2,
                       "out_folder": str(tmp / "cpu")}, tmp / "cpu.json")
        assert cpu["n_files"] == 2
        cmeta, cstore = read_store(tmp / "cpu")
        assert cmeta["filenames"] == meta["filenames"][:2]
        rel = float(np.abs(store[:2] - cstore).max() / np.abs(cstore).max())
        print(f"card vs CPU plain path, 2 files: max|Δ|/max|cpu| {rel:.3e} "
              f"(bound {CARD_VS_CPU_TOL})")
        assert rel < CARD_VS_CPU_TOL, rel

        # phase 5 — SAE training on the card's store, counting launches
        store_dir = str(tmp / "card")
        tbase = json.loads((REPO / "configs/train/tiny_topk.json").read_text())
        assert tbase["batch_size"] == 50 and tbase["device"] == "tpu"
        assert tbase["whisper_config"]["layer_name"] == LAYER
        tcfg = {**tbase, "train_folder": store_dir, "val_folder": store_dir,
                "run_dir": str(tmp / "run_topk"), "steps": TRAIN_STEPS,
                "lr": 1e-3, "scheduler_params": {"num_warmup_steps": 2},
                "save_every": 10, "val_every": 10, "log_tb_every": 10,
                # the store's model: the validation transcripts decode with it
                "whisper_config": {**tbase["whisper_config"], "model": "random:tiny"},
                # below one step's 75,000 frames: latents that did not fire
                # in step 1 are dead from step 2, so AuxK runs
                "autoencoder_config": {**tbase["autoencoder_config"],
                                       "dead_feature_threshold": M_ROWS // 2}}
        backward = {"topk_masked_pair": topk_masked_pair, "topk_route": topk_route}
        for fn in (topk_sae_forward, topk_thresholds_fired, *backward.values()):
            fn.launches = 0
        tstats, steps = train(tcfg, tmp / "topk.json")
        launches["topk_sae_forward"] = topk_sae_forward.launches
        per_unit["topk_sae_forward"] = (statistics.median(
            m["launches_topk_sae_forward"] for m in steps), "train step")
        for k, fn in backward.items():  # one of each in every step's backward
            launches[k] = fn.launches
            per_unit[k] = (statistics.median(m[f"launches_{k}"] for m in steps), "train step")
            assert [m[f"launches_{k}"] for m in steps] == [1] * TRAIN_STEPS, (k, steps)
        span_ms = 1e3 * statistics.median(profiling.calls("train_step"))
        dead = [m["dead_pct"] for m in steps]
        aux = [m["auxk_loss"] for m in steps]
        print(f"tiny_topk: {tstats['steps']} steps, steps_per_sec "
              f"{tstats['steps_per_sec']:.3f} (incl. 3 validations and checkpoint "
              f"writes), median train_step {span_ms:.3f} ms on {card}; dead_pct "
              f"step 2 {dead[1]:.4f}, last {dead[-1]:.4f}; auxk_loss step 2 "
              f"{aux[1]:.4e}; loss {steps[0]['loss']:.4f} → {steps[-1]['loss']:.4f}; "
              f"kernel #4 launches {launches['topk_sae_forward']}, backward passes "
              f"{ {k: launches[k] for k in backward} }")
        assert len(steps) == TRAIN_STEPS and tstats["steps"] == TRAIN_STEPS
        assert all(np.isfinite(list(m.values())).all() for m in steps)
        assert max(dead[1:]) > 0 and max(aux[1:]) > 0, (dead, aux)
        assert launches["topk_sae_forward"] >= TRAIN_STEPS, launches
        assert topk_thresholds_fired.launches == 0
        ckpts = tmp / "run_topk" / "checkpoints"
        check_checkpoints(torch, ckpts, ["step10.pth", "step20.pth",
                                         "step30.pth", "bestval.pth"])
        n_val = len(profiling.calls("val_transcripts"))
        print(f"validation transcripts: {n_val} batched decodes of 4 files, "
              f"{[round(t, 3) for t in profiling.calls('val_transcripts')]} s")
        assert n_val == 3, n_val  # one a validation (the base ones in it once)
        check_transcript_tags(tmp / "run_topk")

        topk_thresholds_fired.launches = 0
        mstats, msteps = train(
            {**tcfg, "run_dir": str(tmp / "run_multi"), "steps": 4,
             "save_every": 4, "val_every": 4,
             "autoencoder_config": {**tcfg["autoencoder_config"], "multi_topk": True}},
            tmp / "multi.json")
        launches["topk_thresholds_fired"] = topk_thresholds_fired.launches
        per_unit["topk_thresholds_fired"] = (statistics.median(
            m["launches_topk_thresholds_fired"] for m in msteps), "multi_topk train step")
        print(f"tiny_topk multi_topk: steps_per_sec {mstats['steps_per_sec']:.3f}, "
              f"multi_topk_fvu {msteps[-1]['multi_topk_fvu']:.4f}; kernel #3 "
              f"launches {launches['topk_thresholds_fired']}")
        assert launches["topk_thresholds_fired"] >= 4, launches
        assert all(m[f"launches_{k}"] == 0 for m in msteps for k in backward), msteps
        assert all(np.isfinite(list(m.values())).all() for m in msteps)

        lbase = json.loads((REPO / "configs/train/tiny_l1.json").read_text())
        lstats, lsteps = train(
            {**lbase, "train_folder": store_dir, "val_folder": store_dir,
             "run_dir": str(tmp / "run_l1"), "steps": 4, "save_every": 4,
             "val_every": 4, "log_tb_every": 2,
             # the 51-file store holds no batch of tiny_l1's 100 files
             "batch_size": 50}, tmp / "l1.json")
        print(f"tiny_l1 (batch 50): steps_per_sec {lstats['steps_per_sec']:.3f} on "
              f"{card}; loss {lsteps[0]['loss']:.4f} → {lsteps[-1]['loss']:.4f}")
        assert all(np.isfinite(list(m.values())).all() for m in lsteps)
        check_checkpoints(torch, tmp / "run_l1" / "checkpoints", ["step4.pth"])

        # phase 5b — the train CLI through the device cache (a 24-file window
        # of the 51-file store, refresh on), chunks of 10 as CUDA graphs
        for fn in (topk_sae_forward, topk_thresholds_fired, *backward.values()):
            fn.launches = 0
        cache_runs = [
            ("tiny_topk, f32 window", tcfg, 30),
            ("tiny_topk, bf16 window", {**tcfg, "device_cache_dtype": "bfloat16"}, 30),
            ("tiny_topk multi_topk", {**tcfg, "autoencoder_config": {
                **tcfg["autoencoder_config"], "multi_topk": True}}, 10),
            ("tiny_l1 (batch 50)", {**lbase, "batch_size": 50, "log_tb_every": 10}, 30)]
        for name, cfg, n in cache_runs:
            cstats, csteps = train(
                {**cfg, "train_folder": store_dir, "val_folder": store_dir,
                 "run_dir": str(tmp / "run_cache"), "steps": n, "save_every": n,
                 "val_every": n, "device_cache_files": CACHE_FILES, "fused_steps": 10,
                 # the validation transcripts are phase 5's
                 "enable_transcripts": False},
                tmp / "cache.json")
            cache, vset = RUN_OBJECTS["DeviceShuffleCache"], RUN_OBJECTS["DeviceValSet"]
            chunks = RUN_OBJECTS["chunks"]
            wait_ms = [1e3 * t / 10 for t in profiling.calls("train_chunk_wait")]
            print(f"{name} through the cache: steps_per_sec {cstats['steps_per_sec']:.3f} "
                  f"(incl. capture, 1 validation, checkpoint writes), train_chunk_wait a "
                  f"step {[round(t, 3) for t in wait_ms]} ms on {card}; window "
                  f"{tuple(cache.cache.shape)} {cache.cache.dtype} "
                  f"({cache.window_bytes / 2**30:.3f} GiB), refresh {cache.refresh_files} "
                  f"files; launches a chunk {chunks}; loss {csteps[0]['loss']:.4f} → "
                  f"{csteps[-1]['loss']:.4f}")
            assert cstats["steps"] == n and len(csteps) == n, (cstats, len(csteps))
            assert [c["steps"] for c in chunks] == [10] * (n // 10), chunks
            assert all(np.isfinite([v for k, v in m.items() if k != "chunk"]).all()
                       for m in csteps)
            itemsize = 2 if cfg.get("device_cache_dtype") == "bfloat16" else 4
            assert cache.capacity == CACHE_FILES and cache.refresh_files > 0
            assert cache.window_bytes == CACHE_FILES * 1500 * 384 * itemsize == (
                cache.cache.numel() * cache.cache.element_size()), cache.window_bytes
            assert vset.ok, "the resident validation set is not on"
            assert len(profiling.calls("validate")) == 1
            check_checkpoints(torch, tmp / "run_cache" / "checkpoints",
                              [f"step{n}.pth", "bestval.pth"])
            kernel = ("launches_topk_thresholds_fired" if "multi" in name
                      else "launches_topk_sae_forward" if "topk" in name else None)
            if kernel:  # the capture's warm-up step, then one a replayed step
                assert [c[kernel] for c in chunks] == [11] + [10] * (n // 10 - 1), chunks
            for k in backward:  # TopK's backward alone runs the passes
                want = [11] + [10] * (n // 10 - 1) if kernel == "launches_topk_sae_forward" \
                    else [0] * (n // 10)
                assert [c[f"launches_{k}"] for c in chunks] == want, (k, chunks)
            if "topk" in name and "multi" not in name:
                assert max(m["auxk_loss"] for m in csteps[1:]) > 0
            free_device_memory(torch)
        launches["cache_topk_sae_forward"] = topk_sae_forward.launches
        launches["cache_topk_thresholds_fired"] = topk_thresholds_fired.launches
        for k, fn in backward.items():
            launches[f"cache_{k}"] = fn.launches
            assert fn.launches == 2 * (30 + 1), (k, fn.launches)
        print(f"launches in the cache runs: kernel #4 {topk_sae_forward.launches}, "
              f"kernel #3 {topk_thresholds_fired.launches}")
        assert topk_sae_forward.launches == 2 * (30 + 1)
        assert topk_thresholds_fired.launches == 10 + 1
        graph_recs = {"topk": graph_against_eager(torch, store_dir, "topk", 50),
                      "l1": graph_against_eager(torch, store_dir, "l1", 100)}
        free_device_memory(torch)

        # phase 6 — one TopK batch at full width, card against CPU
        card_vs_cpu_batch(torch, device, store)

        # phase 7 — collection with the trained TopK SAE attached: the
        # encode's selection and its f32 product once a batch, beside the
        # out, mlp.0 and mlp.2 products of each block
        topk_indexed.launches = log_mel_spectrogram_cuda.launches = 0
        fused_qkv_attention.launches = gemm_f32x3.launches = 0
        sstats = collect({**config, "sae_model": str(ckpts / "bestval.pth"),
                          "out_folder": str(tmp / "sae")}, tmp / "sae.json")
        torch.cuda.synchronize()
        sae_batches = log_mel_spectrogram_cuda.launches  # one a batch
        launches["topk_indexed"] = topk_indexed.launches
        per_unit["topk_indexed"] = (topk_indexed.launches / sae_batches, "SAE collection batch")
        sae_gemm = gemm_f32x3.launches - 3 * fused_qkv_attention.launches
        print(f"SAE encode's selection: {topk_indexed.launches} launches in {sae_batches} "
              f"batches; gemm_f32x3 {gemm_f32x3.launches} launches beside "
              f"{fused_qkv_attention.launches} blocks' attention: {sae_gemm} SAE encodes")
        assert topk_indexed.launches == sae_batches >= n_batches, (topk_indexed.launches,
                                                                   sae_batches)
        assert sae_gemm == sae_batches, (gemm_f32x3.launches, fused_qkv_attention.launches,
                                         sae_batches)
        smeta = json.loads((tmp / "sae" / f"{LAYER}_metadata.json").read_text())
        vals = np.load(tmp / "sae" / f"{LAYER}_activation_values.npy", mmap_mode="r")
        idx = np.load(tmp / "sae" / f"{LAYER}_feature_indices.npy", mmap_mode="r")
        vals = vals.reshape(vals.shape[0], *smeta["tensor_shape"])
        idx = idx.reshape(idx.shape[0], *smeta["tensor_shape"])
        print(f"SAE-attached collection: values {vals.shape}, indices {idx.shape}, "
              f"RTFx {sstats['rtfx']:.1f} on {card}")
        assert vals.shape == idx.shape == (n_files, 1500, K), (vals.shape, idx.shape)
        assert smeta["activation_shape"] == [1500, N_DICT]
        assert np.isfinite(vals).all() and (vals >= 0).all()
        assert idx.min() >= 0 and idx.max() < N_DICT

        # phase 14 — decoder-layer collection at tiny width (the whole
        # encoder, a 224-token greedy decode and a teacher-forced capture a
        # batch), .mlp.1, and with phase 5's TopK SAE attached
        tiny_counters = {"log_mel": log_mel_spectrogram_cuda,
                         "fused_qkv_attention": fused_qkv_attention,
                         "whisper_attention": whisper_attention,
                         "topk_thresholds_fired": topk_thresholds_fired}
        dec_runs = decoder_collections(torch, tmp, config, clips, ckpts / "bestval.pth",
                                       card, tiny_counters)
        dec_store = str(tmp / "dec_0")

        # phase 15 — training on the decoder store, its validation
        # transcripts steered online; through the cache; L1; fly mode
        dec_train = decoder_training(torch, tmp, dec_store, audio_dir, card)

        # phase 16 — decoder capture and steering on the card against the CPU
        decoder_card_vs_cpu(torch, device, [p for p, _ in clips[:2]],
                            ckpts / "bestval.pth", card)
        free_device_memory(torch)
        launches["decoder_log_mel"] = (sum(r["launches"]["log_mel"] for r in dec_runs.values())
                                       + dec_train["fly"]["launches"]["log_mel"])
        launches["decoder_fused_qkv_attention"] = (
            sum(r["launches"]["fused_qkv_attention"] for r in dec_runs.values())
            + dec_train["fly"]["launches"]["fused_qkv_attention"])
        launches["decoder_topk_sae_forward"] = (
            sum(r["launches"] for k, r in dec_train.items() if k != "fly")
            + dec_train["fly"]["launches"]["topk_sae_forward"])
        launches["decoder_topk_thresholds_fired"] = (
            sum(r["launches"]["topk_thresholds_fired"] for r in dec_runs.values())
            + sum(r["launches_thresholds"] for k, r in dec_train.items() if k != "fly")
            + dec_train["fly"]["launches"]["topk_thresholds_fired"])

        # phase 18 — the feature-major index and search at tiny width
        search_recs = index_and_search(torch, tmp, config, card)
        free_device_memory(torch)

        # phase 19 — the GUI server on the card at tiny width: from disk
        # (no SAE, TopK), fly mode (L1), a decoder-layer store
        server_counters = {"log_mel": log_mel_spectrogram_cuda,
                           "fused_qkv_attention": fused_qkv_attention,
                           "whisper_attention": whisper_attention}
        for fn in server_counters.values():
            fn.launches = 0
        server_tiny = serving_tiny(torch, tmp, config, clips, audio_dir, server_counters, card)
        for k, fn in server_counters.items():
            launches[f"server_{k}"] = fn.launches

        # phase 8 — collection at large width, from the repo's large configs
        large_launches = {"log_mel": 0, "whisper_attention": 0, "gemm_f32x3": 0}
        large_batches = 0
        large_stores = {}
        for name, cfg_file, batch, n_long, short in (
                ("large-v1", "large_v1_block_16_audioset_train.json", 32, 34, (9.1,)),
                ("large-v3", "large_v3_block_16_dev.json", 16, 17, ())):
            lbase = json.loads((REPO / "configs/features" / cfg_file).read_text())
            assert (lbase["whisper_model"], lbase["layer_name"], lbase["batch_size"]) == (
                name, LARGE_LAYER, batch)
            ldir = tmp / f"audio_{name}"
            ldir.mkdir()
            lclips = write_wavs(ldir, [480000] * n_long + [int(16000 * t) for t in short],
                                seed=SEED + 6)
            n_lfiles = len(lclips)
            n_lbatches = -(-n_lfiles // batch)
            lcfg = {**lbase, "whisper_model": f"random:{name}", "data_path": str(ldir),
                    "out_folder": str(tmp / f"store_{name}")}
            log_mel_spectrogram_cuda.launches = 0
            whisper_attention.launches = 0
            fused_qkv_attention.launches = 0
            gemm_f32x3.launches = 0
            lstats = collect(lcfg, tmp / f"collect_{name}.json")
            torch.cuda.synchronize()
            got = {"log_mel": log_mel_spectrogram_cuda.launches,
                   "whisper_attention": whisper_attention.launches,
                   "fused_qkv_attention": fused_qkv_attention.launches,
                   "gemm_f32x3": gemm_f32x3.launches}
            print(f"launches in the random:{name} collection: {got} "
                  f"({n_lbatches} batches of {batch})")
            assert got["log_mel"] >= n_lbatches, got
            assert got["whisper_attention"] >= 17 * n_lbatches, got
            assert got["fused_qkv_attention"] == 0, got
            # q, k, v, out, mlp.0 and mlp.2 of each f32 block: six a block
            assert got["gemm_f32x3"] == 6 * got["whisper_attention"], got
            for k in large_launches:
                large_launches[k] += got[k]
            large_batches += n_lbatches
            lmeta, lstore = read_store(tmp / f"store_{name}", LARGE_LAYER)
            assert lstore.shape == (n_lfiles, 1500, LARGE_D), lstore.shape
            assert np.isfinite(lstore).all()
            assert lmeta["filenames"] == [p for p, _ in lclips]
            assert lmeta["tensor_shape"] == lmeta["activation_shape"] == [1500, LARGE_D]
            assert lmeta["n_frames"] == [activation_length_from_samples(n)
                                         for _, n in lclips]
            assert sorted(lmeta) == sorted(meta), (sorted(lmeta), sorted(meta))
            assert lstats["n_files"] == n_lfiles
            print(f"random:{name} collection to {LARGE_LAYER}, batch {batch}: "
                  f"{n_lfiles} files in {lstats['elapsed_s']:.3f} s (the CLI's clock, "
                  f"after model init), RTFx {lstats['rtfx']:.1f} on {card}")
            large_stores[name] = (tmp / f"store_{name}", lstore, ldir)
            free_device_memory(torch)

        per_unit["whisper_attention"] = (
            large_launches["whisper_attention"] / large_batches, "large collection batch")
        per_unit["gemm_f32x3"] = (
            large_launches["gemm_f32x3"] / large_batches, "large collection batch")

        # phase 9 — test:large-v3 (2 layers at full width) card against CPU
        gcfg = {**json.loads((REPO / "configs/features/large_v3_block_16_dev.json").read_text()),
                "whisper_model": "test:large-v3", "layer_name": "encoder.blocks.1",
                "data_path": str(large_stores["large-v3"][2]), "collect_max": 2}
        collect({**gcfg, "out_folder": str(tmp / "g_card")}, tmp / "g_card.json")
        collect({**gcfg, "device": "cpu", "out_folder": str(tmp / "g_cpu")},
                tmp / "g_cpu.json")
        _, gcard = read_store(tmp / "g_card", "encoder.blocks.1")
        _, gcpu = read_store(tmp / "g_cpu", "encoder.blocks.1")
        assert gcard.shape == gcpu.shape == (2, 1500, LARGE_D)
        rel = float(np.abs(gcard - gcpu).max() / np.abs(gcpu).max())
        print(f"card vs CPU plain path, test:large-v3 block 1, 2 files: "
              f"max|Δ|/max|cpu| {rel:.3e} (bound {CARD_VS_CPU_TOL})")
        assert rel < CARD_VS_CPU_TOL, rel

        # phase 10 — the large recipes on the large stores
        v1_dir = str(large_stores["large-v1"][0])
        tlarge = json.loads((REPO / "configs/train/large_v1_audioset.json").read_text())
        assert tlarge["batch_size"] == 32 and tlarge["autoencoder_variant"] == "topk"
        assert tlarge["whisper_config"]["layer_name"] == LARGE_LAYER
        tlcfg = {**tlarge, "train_folder": v1_dir, "val_folder": v1_dir,
                 "run_dir": str(tmp / "run_large_topk"), "steps": LARGE_TRAIN_STEPS,
                 "save_every": 5, "val_every": 5, "log_tb_every": 5,
                 # the large decoder's transcripts are phase 13's
                 "enable_transcripts": False,
                 # below one step's 48,000 frames: AuxK runs from step 2
                 "autoencoder_config": {**tlarge["autoencoder_config"],
                                        "dead_feature_threshold": LARGE_M_ROWS // 2}}
        topk_sae_forward.launches = 0
        torch.cuda.reset_peak_memory_stats()
        ltstats, ltsteps = train(tlcfg, tmp / "large_topk.json")
        large_topk_launches = topk_sae_forward.launches
        peak = torch.cuda.max_memory_allocated()
        span_ms = 1e3 * statistics.median(profiling.calls("train_step"))
        # train (32-file) and validation (8-file) gathers share the span
        mmap_ms = sorted(round(1e3 * t, 1) for t in profiling.calls("mmap_batch"))
        dead = [m["dead_pct"] for m in ltsteps]
        aux = [m["auxk_loss"] for m in ltsteps]
        print(f"large_v1_audioset: {ltstats['steps']} steps, steps_per_sec "
              f"{ltstats['steps_per_sec']:.3f} (incl. 2 validations and checkpoint "
              f"writes), median train_step {span_ms:.3f} ms, mmap_batch ms "
              f"{mmap_ms}, peak device memory {peak / 2**30:.3f} GiB on "
              f"{card}; dead_pct step 2 {dead[1]:.4f}; auxk_loss step 2 {aux[1]:.4e}; "
              f"loss {ltsteps[0]['loss']:.4f} → {ltsteps[-1]['loss']:.4f}; kernel #4 "
              f"launches {large_topk_launches}")
        assert len(ltsteps) == LARGE_TRAIN_STEPS == ltstats["steps"]
        assert all(np.isfinite(list(m.values())).all() for m in ltsteps)
        assert max(dead[1:]) > 0 and max(aux[1:]) > 0, (dead, aux)
        assert large_topk_launches >= LARGE_TRAIN_STEPS, large_topk_launches
        assert statistics.median(m["launches_topk_sae_forward"] for m in ltsteps) == 1
        for k in backward:
            assert [m[f"launches_{k}"] for m in ltsteps] == [1] * LARGE_TRAIN_STEPS, k
        check_checkpoints(torch, tmp / "run_large_topk" / "checkpoints",
                          ["step5.pth", "step10.pth", "bestval.pth"])
        free_device_memory(torch)

        v3_dir = str(large_stores["large-v3"][0])
        l1large = json.loads((REPO / "configs/train/large_v3_l1.json").read_text())
        assert l1large["batch_size"] == 16 and l1large["autoencoder_variant"] == "l1"
        torch.cuda.reset_peak_memory_stats()
        l1stats, l1steps = train(
            {**l1large, "train_folder": v3_dir, "val_folder": v3_dir,
             "run_dir": str(tmp / "run_large_l1"), "steps": 4, "save_every": 4,
             "val_every": 4, "log_tb_every": 2, "enable_transcripts": False},
            tmp / "large_l1.json")
        span_ms = 1e3 * statistics.median(profiling.calls("train_step"))
        print(f"large_v3_l1 (batch 16): steps_per_sec {l1stats['steps_per_sec']:.3f}, "
              f"median train_step {span_ms:.3f} ms, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB on {card}; loss "
              f"{l1steps[0]['loss']:.4f} → {l1steps[-1]['loss']:.4f}")
        assert len(l1steps) == 4 and all(np.isfinite(list(m.values())).all() for m in l1steps)
        check_checkpoints(torch, tmp / "run_large_l1" / "checkpoints", ["step4.pth"])
        free_device_memory(torch)

        # phase 11 — one TopK batch (1 file) at large width, card against CPU
        card_vs_cpu_batch(torch, device, large_stores["large-v1"][1],
                          d_in=LARGE_D, n_dict=LARGE_N_DICT, n_files=1)
        free_device_memory(torch)

        # phase 12 — the transcribe CLI at tiny width: 8 30-s clips, 3 short
        # ones and the broken one at batch 8 (a padded tail batch)
        tdir = tmp / "audio_transcribe"
        tdir.mkdir()
        tclips = write_wavs(tdir, [480000] * TRANSCRIBE_LONG
                            + [int(16000 * t) for t in N_SHORT_S], broken=True, seed=SEED + 7)
        t_batches = -(-(len(tclips) + 1) // TRANSCRIBE_BATCH)
        t_audio_s = sum(n for _, n in tclips) / 16000
        base_args = ["--data_path", str(tdir), "--model", "random:tiny",
                     "--batch_size", str(TRANSCRIBE_BATCH)]
        tiny_runs = transcribe_runs(
            torch, tmp, card,
            [("tiny greedy f32", base_args), ("tiny greedy f32 again", base_args),
             ("tiny greedy bf16", base_args + ["--precision", "bfloat16"]),
             ("tiny beam 5", base_args + ["--beam_size", "5"]),
             ("tiny fallback", base_args + ["--fallback"])],
            t_batches, t_audio_s,
            {"log_mel": log_mel_spectrogram_cuda, "fused_qkv_attention": fused_qkv_attention,
             "whisper_attention": whisper_attention},
            {"log_mel": 1, "fused_qkv_attention": 4, "whisper_attention": 0})
        for name, rec in tiny_runs.items():
            res = rec["result"]
            assert sorted(res) == sorted([p for p, _ in tclips]
                                         + [str(tdir / "clip_broken.wav")]), name
            assert res[str(tdir / "clip_broken.wav")] == "<decode-failed>", name
            assert all(t != "<decode-failed>" for f, t in res.items()
                       if not f.endswith("broken.wav")), name
        first, again = (np.concatenate([d["tokens"] for d in tiny_runs[k]["decodes"]])
                        for k in ("tiny greedy f32", "tiny greedy f32 again"))
        assert np.array_equal(first, again), "two greedy runs differ"
        for k in ("log_mel", "fused_qkv_attention"):
            launches[f"transcribe_{k}"] = sum(r["launches"][k] for r in tiny_runs.values())

        # phase 12b — the decoder on the card against the CPU, 2 clips
        decode_card_vs_cpu(torch, device, [p for p, _ in tclips[:2]], card)
        free_device_memory(torch)

        # phase 13 — the transcribe CLI at large-v3 width (128 bands): 8 30-s
        # clips greedy at batch 8 in f32 and bf16, then beam 5 at batch 2
        ldir = tmp / "audio_transcribe_large"
        ldir.mkdir()
        write_wavs(ldir, [480000] * TRANSCRIBE_LONG, seed=SEED + 8)
        largs = ["--data_path", str(ldir), "--model", "random:large-v3"]
        large_counters = {"log_mel": log_mel_spectrogram_cuda,
                          "fused_qkv_attention": fused_qkv_attention,
                          "whisper_attention": whisper_attention}
        large_expect = {"log_mel": 1, "fused_qkv_attention": 0, "whisper_attention": 32}
        large_runs = transcribe_runs(
            torch, tmp, card,
            [("large-v3 greedy f32", largs + ["--batch_size", str(TRANSCRIBE_BATCH)]),
             ("large-v3 greedy bf16", largs + ["--batch_size", str(TRANSCRIBE_BATCH),
                                                "--precision", "bfloat16"])],
            TRANSCRIBE_LONG // TRANSCRIBE_BATCH, TRANSCRIBE_LONG * 30.0,
            large_counters, large_expect)
        large_runs.update(transcribe_runs(
            torch, tmp, card,
            [("large-v3 beam 5", largs + ["--batch_size", str(BEAM_BATCH),
                                          "--beam_size", "5"])],
            TRANSCRIBE_LONG // BEAM_BATCH, TRANSCRIBE_LONG * 30.0,
            large_counters, large_expect))
        launches["transcribe_whisper_attention"] = sum(
            r["launches"]["whisper_attention"] for r in large_runs.values())
        for rec in large_runs.values():
            assert len(rec["result"]) == TRANSCRIBE_LONG

        # phase 17 — decoder-layer collection at large-v3 width over phase
        # 13's 8 clips, and a raw-channel tap at factor 1
        large_dec = large_decoder(torch, tmp, ldir, card, large_counters)
        launches["decoder_log_mel"] += large_dec["launches"]["log_mel"]
        launches["decoder_whisper_attention"] = large_dec["launches"]["whisper_attention"]

        # phase 20 — index, search and the GUI server at large-v1 width
        for fn in server_counters.values():
            fn.launches = 0
        server_large = serving_large(
            torch, tmp, large_stores["large-v1"][0], large_stores["large-v1"][2],
            tmp / "run_large_topk" / "checkpoints" / "bestval.pth", server_counters, card)
        for k, fn in server_counters.items():
            launches[f"server_{k}"] += fn.launches
        print(f"launches in the server phases 19-20: "
              f"{ {k: launches[f'server_{k}'] for k in server_counters} }")
        assert all(launches[f"server_{k}"] > 0 for k in server_counters), launches
        print(json.dumps({"serving": {"search_tiny": search_recs, "tiny": server_tiny,
                                      "large": server_large, "card": card}}))

        # phase 21 — long-form transcription at tiny width: the CLI's --long
        # --word_timestamps --output_format srt over a 75-s and a 45-s clip
        # with the full temperature ladder
        long_dir = tmp / "audio_long"
        long_dir.mkdir()
        long_wavs = write_wavs(long_dir, [int(16000 * t) for t in LONG_CLIPS_S],
                               seed=SEED + 11)
        long_counters = {"log_mel": log_mel_spectrogram_cuda,
                         "fused_qkv_attention": fused_qkv_attention,
                         "whisper_attention": whisper_attention}
        long_recs = {"tiny": long_form_cli(
            torch, tmp, long_dir, sum(LONG_CLIPS_S), "random:tiny",
            ["--max_new_tokens", str(LONG_MAX_NEW_TINY)], long_counters,
            {"log_mel": 0, "fused_qkv_attention": 4, "whisper_attention": 0}, "tiny", card)}
        launches_long = dict(long_recs["tiny"]["launches"])

        # phase 22 — tiny long-form on the card against the CPU, 45 s at t = 0
        long_recs["tiny_card_vs_cpu"] = long_form_card_vs_cpu(
            torch, device, long_wavs[1][0], card)

        # phase 23 — random:large-v3 long-form in bf16 over the 45-s clip
        large_long_dir = tmp / "audio_long_large"
        large_long_dir.mkdir()
        (large_long_dir / "clip45.wav").write_bytes(Path(long_wavs[1][0]).read_bytes())
        long_recs["large_v3_bf16"] = long_form_cli(
            torch, tmp, large_long_dir, LONG_CLIPS_S[1], "random:large-v3",
            ["--max_new_tokens", str(LONG_MAX_NEW_LARGE), "--precision", "bfloat16"],
            long_counters, {"log_mel": 0, "fused_qkv_attention": 0, "whisper_attention": 32},
            "large-v3 bf16", card)
        for k, v in long_recs["large_v3_bf16"]["launches"].items():
            launches_long[k] += v

        # phase 24 — the GUI server's long /transcribe forms at tiny width
        long_recs["server"] = serving_long(
            torch, tmp, config, Path(long_wavs[1][0]).read_bytes(), long_counters, card)
        for rec in long_recs["server"].values():
            for k, v in rec["launches"].items():
                launches_long[k] += v
        print(f"launches in the long-form phases 21-24: {launches_long}")
        assert launches_long["log_mel"] == 0, launches_long
        assert launches_long["fused_qkv_attention"] > 0, launches_long
        assert launches_long["whisper_attention"] > 0, launches_long
        print(json.dumps({"long_form": {**long_recs, "card": card}}))

        # phase 25 — multi-layer collection at Whisper small width: kernel #2
        # at d 768, then four layers from one encoder pass a batch
        small_recs = {"attention_d768": check_attention_small(torch, device, card)}
        small_recs["collection"] = multilayer_collection(
            torch, tmp, card, {"log_mel": log_mel_spectrogram_cuda,
                               "fused_qkv_attention": fused_qkv_attention,
                               "whisper_attention": whisper_attention})

        # phase 26 — per-layer sweeps over phase 25's four stores
        sweep_counters = {"topk_sae_forward": topk_sae_forward,
                          "topk_thresholds_fired": topk_thresholds_fired, **backward}
        small_recs["topk_sae_forward_d768"] = check_topk_fused_small(torch, device, card)
        small_recs["topk_sae_forward_d768_k16"] = check_topk_fused_small(torch, device, card,
                                                                         k=16)
        small_recs["topk_thresholds_fired_d768"] = check_topk_threshold_small(
            torch, device, card)
        small_store = str(tmp / "small_multi")
        small_recs["per_layer"] = sweep_per_layer(torch, device, tmp, small_store, card,
                                                  sweep_counters)

        # phase 27 — the grid sweep through the device cache
        small_recs["grid"] = sweep_grid(torch, tmp, small_store, card, sweep_counters)
        launches_sweep = {k: sum(small_recs["per_layer"][run]["launches"][k]
                                 for run in ("topk", "l1", "multi_topk"))
                          + small_recs["grid"]["launches"][k] for k in sweep_counters}
        print(f"launches in the sweep phases 26-27: {launches_sweep}")
        print(json.dumps({"multilayer_sweeps": {**small_recs, "card": card}}))

        # phases 28-30 — two gloo ranks on the card (pod training, the pod
        # cache and chunk, search, a sweep step, data_parallel collection
        # merged), then NCCL at world size 1
        pod_rec = pod_phases(torch, device, tmp, clips, card)
        print(json.dumps({"pod": {**pod_rec, "card": card}}))

        # phase 31 — the model axis: the selection across shards, two gloo
        # ranks with the dictionary split in two, NCCL at world size 1
        axis_rec = model_axis_phases(torch, device, tmp, card)
        print(json.dumps({"model_axis": {**axis_rec, "card": card}}))

    def unit(name: str) -> dict:
        count, what = per_unit[name]
        return dict(launches_per_unit=count, unit=what)

    kernels = [
        {"name": "log_mel", "route": "cuda",
         "source": "freud_tpu_torch/csrc/mel.cu",
         "replaces": "freud_tpu/ops/mel_pallas.py:162",
         "launches": launches["log_mel"], **unit("log_mel"),
         "launches_transcribe": launches["transcribe_log_mel"],
         "launches_decoder": launches["decoder_log_mel"],
         "launches_server": launches["server_log_mel"],
         "launches_long": launches_long["log_mel"],
         "launches_multilayer": small_recs["collection"]["launches"]["log_mel"],
         "launches_pod": pod_rec["launches"]["log_mel"], **mel_rec},
        {"name": "fused_qkv_attention", "route": "cuda",
         "source": "freud_tpu_torch/csrc/attention.cu",
         "replaces": "freud_tpu/ops/attention.py:267",
         "launches": launches["fused_qkv_attention"], **unit("fused_qkv_attention"),
         "launches_transcribe": launches["transcribe_fused_qkv_attention"],
         "launches_decoder": launches["decoder_fused_qkv_attention"],
         "launches_server": launches["server_fused_qkv_attention"],
         "launches_long": launches_long["fused_qkv_attention"],
         "launches_multilayer": small_recs["collection"]["launches"]["fused_qkv_attention"],
         "launches_pod": pod_rec["launches"]["fused_qkv_attention"],
         "d768": small_recs["attention_d768"], **attn_rec},
        {"name": "whisper_attention", "route": "cuda",
         "source": "freud_tpu_torch/csrc/attention.cu",
         "replaces": "freud_tpu/ops/attention.py:144",
         "launches": large_launches["whisper_attention"], **unit("whisper_attention"),
         "launches_transcribe": launches["transcribe_whisper_attention"],
         "launches_decoder": launches["decoder_whisper_attention"],
         "launches_server": launches["server_whisper_attention"],
         "launches_long": launches_long["whisper_attention"],
         "launches_multilayer": small_recs["collection"]["launches"]["whisper_attention"],
         "launches_pod": pod_rec["launches"]["whisper_attention"], **wattn_rec},
        {"name": "topk_sae_forward", "route": "cuda",
         "source": "freud_tpu_torch/csrc/topk_fused.cu",
         "replaces": "freud_tpu/ops/topk_fused.py:455",
         "launches": launches["topk_sae_forward"], **unit("topk_sae_forward"),
         "launches_cache_path": launches["cache_topk_sae_forward"],
         "launches_decoder": launches["decoder_topk_sae_forward"],
         "graph_vs_eager_max_rel_diff": graph_recs["topk"]["max_rel_diff"],
         "launches_sweep": launches_sweep["topk_sae_forward"],
         "launches_pod": pod_rec["launches"]["topk_sae_forward"],
         "launches_model_axis": {k: axis_rec["launches"][k]
                                 for k in ("topk_sae_encode", "topk_sae_decode")},
         "model_axis": {
             "source": "freud_tpu_torch/csrc/topk_fused.cu",
             "launches": {k: axis_rec["launches"][k]
                          for k in ("topk_sae_encode", "topk_sae_decode")},
             **axis_rec["kernel4"]},
         "d768": small_recs["topk_sae_forward_d768"],
         "d768_k16": small_recs["topk_sae_forward_d768_k16"], **fused_rec},
        {"name": "topk_thresholds_fired", "route": "cuda",
         "source": "freud_tpu_torch/csrc/topk_threshold.cu",
         "replaces": "freud_tpu/ops/topk_threshold.py:225",
         "launches": launches["topk_thresholds_fired"], **unit("topk_thresholds_fired"),
         "launches_cache_path": launches["cache_topk_thresholds_fired"],
         "launches_decoder": launches["decoder_topk_thresholds_fired"],
         "launches_sweep": launches_sweep["topk_thresholds_fired"],
         "launches_pod": pod_rec["launches"]["topk_thresholds_fired"],
         "d768": small_recs["topk_thresholds_fired_d768"],
         "launches_model_axis": {
             "shard_candidates": axis_rec["launches"]["shard_candidates"],
             "combine_shard_thresholds": axis_rec["launches"]["combine_shard_thresholds"]},
         "model_axis": {
             "source": "freud_tpu_torch/csrc/topk_sharded.cu",
             "launches": {k: axis_rec["launches"][k]
                          for k in ("shard_candidates", "combine_shard_thresholds")},
             **axis_rec["selection"]}, **thresh_rec},
    ]
    # the TopK backward's passes: no TPU kernel's port (JAX leaves the masks
    # to XLA's fusions); every route's TopK backward runs them on the card
    kernels += [
        {"name": name, "route": "cuda",
         "source": "freud_tpu_torch/csrc/topk_backward.cu",
         "replaces": "the backward's ATen mask, where, add and column-sum passes "
                     "(freud_tpu/models/sae/topk.py:409-470 leaves them to XLA)",
         "launches": launches[name], **unit(name),
         "launches_cache_path": launches[f"cache_{name}"],
         "launches_sweep": launches_sweep[name],
         "launches_pod": pod_rec["launches"][name],
         "launches_model_axis": axis_rec["launches"][name], **backward_recs[name]}
        for name in BACKWARD_PASSES]
    # the SAE encode's top-k: no TPU kernel's port (the JAX package leaves
    # lax.top_k to XLA); its plain version is the stable sort it replaced
    kernels.append(
        {"name": "topk_indexed", "route": "cuda", "source": "freud_tpu_torch/csrc/topk_indexed.cu",
         "replaces": "select_topk's stable torch.sort over every latent (freud_tpu/models/sae/"
                     "topk.py select_topk leaves lax.top_k to XLA)",
         "launches": launches["topk_indexed"], **unit("topk_indexed"),
         "launches_server_large": server_large["top_features"]["launches"]["topk_indexed"],
         **indexed_rec})
    # the 3xTF32 product: no TPU kernel's port (the JAX package leaves the
    # encoder's linears and the SAE encode's product to XLA)
    kernels.append(
        {"name": "gemm_f32x3", "route": "cuda", "source": "freud_tpu_torch/csrc/gemm_f32x3.cu",
         "replaces": "cuBLAS's f32 SIMT product for the f32 encoder linears and the SAE "
                     "encode (freud_tpu leaves them to XLA)",
         "launches": large_launches["gemm_f32x3"], **unit("gemm_f32x3"), **gemm_rec})
    # Uni-MoE-2.0-Omni's MoE: no TPU kernel's port (the JAX package has no
    # such model); its plain versions are ops/moe.py's
    kernels += [
        {"name": name, "route": "cuda", "source": "freud_tpu_torch/csrc/moe.cu",
         "replaces": "none (ops/moe.py's plain versions)", **moe_recs[name],
         "launches_omni_forward": {n: omni_rec["launches"][n] for n in name[4:].split("+")}}
        for name in ("moe_gateup", "moe_down", "moe_route+plan+permute+combine")]
    # LongCat-Flash-Omni's held-share MoE: the same source, its own route
    kernels += [
        {"name": name, "route": "cuda", "source": "freud_tpu_torch/csrc/moe.cu",
         "replaces": "none (ops/moe.py's plain versions)", **lc_moe_recs[name],
         "launches_longcat_forward": lc_rec["launches"][wrapper]}
        for name, wrapper in (("moe_route_topk", "route_topk"), ("moe_gateup_held", "gateup"),
                              ("moe_down_held", "down"))]
    for k in kernels:  # a time under its bound would mean a wrong bound
        assert k["ms"] >= k["bound_ms"], (k["name"], k["ms"], k["bound_ms"])
        print(f"{k['name']}: {k['ms']:.4f} ms, {100 * k['bound_ms'] / k['ms']:.1f}% of "
              f"its bound {k['bound_ms']:.4f} ms ({k['bound_by']})")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
