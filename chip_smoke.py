"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py [--phases name,...]

With no argument every phase runs (the device and build phases always
run); `--phases` names the ones to run (PHASES below: kernel_check,
attention_check, probe_check, probes, fused_check, consistency, generate,
generate_batch, stream_generate, first_chunk, conditioning, long_text, engine,
worker, mesh, int8, train, train_mesh), and the kernel line then lists the
kernels whose check and main path ran. Phases, one or more lines each, then the result line:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; TF32 switched off for matmuls and convolutions.
  2. build: compiles every kernel of the port from the sources in the
     checkout (nvcc, sm_90a), one nvcc process per source, all started
     together, and prints each build's seconds.
  3. kernel checks: each kernel against its plain PyTorch version on the
     card, in fp32 and bf16, at the shapes the main paths give it, with the
     stated error limits; both versions' device time per call
     (torch.profiler) and per-call time of back-to-back calls (CUDA events)
     at the main paths' shapes.
       K1 flash_decode     T3 decode attention: B=2 (one utterance) and B=16
                           (8 utterances, a different hole per row), Lc 512
                           and 1280; among the cases a walk of one slot,
                           fewer live slots than splits and a live range
                           that starts inside a row's hole (splits empty at
                           both ends); timed beside the library's call at
                           both capacities; a start read from the device
                           (the first chunk's graphs) equal to the int
                           start's launch bit for bit, -1 read as 0 (so
                           also K1s and K4)
       K1 with per-row spans (the continuous engine's step): 16 slots (32
                           rows, Lc 1292) and 4 slots (Lc 420); rows
                           unwrapped, wrapped, with an empty hole, a full
                           ring, free rows (their output exactly 0),
                           one-slot spans and a random mix; the 16-slot
                           call timed beside SDPA with a boolean mask
       K1s flash_decode_deferred
                           its deferred-insert entry (the stacked cache with a
                           layer index, the current row folded in): B=2 and
                           16, with and without holes, Lc 512 and 1280
       K2 rel_attention    conformer rel-pos attention: B 4/8/16, T 406/812
                           and 2348, ragged masks with an all-valid row, a
                           single-valid-key row and a row with none
       K3 flash_attention  CFM estimator self-attention: B 8/16/32, T 812 and
                           2348, ragged masks with an all-valid row and a
                           single-valid-key row
       K3b flash_attention_bwd
                           K3's backward, K3b-dq then K3b-dkv: B=4 fp32 and
                           B=16 bf16, T=812, ragged (a row with no valid key
                           gets zero gradients) and all-valid; through
                           autograd K3's output equals its no-grad launch
                           and the gradients equal the direct call; each
                           kernel timed beside its plain pass, and the pair
                           beside the plain backward and the backward of
                           scaled_dot_product_attention
                           K2 and K3 run fp32 on their SIMT kernel and bf16 on
                           their tensor-core kernel, the latter also on
                           one-hot rows, on masks with dead 64-key tiles (at
                           the start, in the middle, one valid key a tile)
                           and at T = 40, 64, 65; both are timed beside the
                           library's call on the ragged mask and on an
                           all-valid one
       K4 fused_decode     the whole T3 token step at full width (30 layers,
                           d=1024, B=2 CFG rows), a 16-step teacher-forced
                           chain near the top of Lc 512 and 1280, start > 0;
                           planted faults that the 30-layer bf16 check must
                           catch; a chain at the lowest positions (most walk
                           splits empty); the 4-, 8- and 16-row templates;
                           its time at pos 44, 260 and 507 (the walk's cost
                           per slot, the wall's GB/s)
       K5 weight_stream    the weight-stream probe: every (slab, nbuf) of its
                           sweep on a 64 MB wall, on random walls of the
                           probe's sizes (1 GB bf16, 0.5 GB int8) and on the
                           probe's own 1 GB wall
       K6 decode_anatomy   the decode-walk probe: full / load_only /
                           compute_only at pos 44 and 379, fp32 and bf16
     Each kernel's entry of the JSON line also carries the least time the
     card could take for the timed call (bytes over 3.35 TB/s, or operations
     over the peak of their type, whichever is larger) and, where one
     PyTorch call computes the same function, that call's device time
     (scaled_dot_product_attention for K1, K2, K3 and K6, an einsum for
     K5); the port calls it nowhere else.
     Then the two probes' entry points run in-process at full size (a 1 GB
     wall; the 16 x 16 x 64, 1024-slot cache) and print one `probe` line per
     configuration.
  4. full-width fp32 consistency: decode through K1, and through K1s with
     the deferred insert, against one plain causal forward; the conformer
     on 8 ragged rows (through K2) against each row alone (1 row, factored
     branch); the CFM estimator on 16 CFG rows (through K3) against each
     cond/uncond pair alone (2 rows, written-out attention).
  5. generate: ChatterboxTTS.generate at the full ChatterboxConfig() width
     with random bf16 weights, twice (warm-up, then timed), through K1, then
     under CHATTERBOX_FUSED_STEP=1 (K4, one launch a step), and once under
     CHATTERBOX_DEFER_KV=1 (K1s, 30 a step); checks each wav and that the
     launch counts are those of the path.
  6. generate_batch: 8 texts in one lock-step batch, one voice twice
     (warm-up, then timed), then two voices once; checks every wav and that
     the launch counts of K1, K2 and K3 are those of the path.
  7. stream_generate: one utterance streamed in 25-token blocks, with the
     fused step (twice) and without it (once), through the first-chunk
     graph (the first pass of each step captures it); checks the chunks
     (finite, joining to the whole wav), the launch counts (the graph's
     replays counted), and records the time to the first chunk.
  8. first_chunk: the stream's first chunk as one CUDA graph per text
     bucket (streaming.first_chunk), on the default step, with K4 and
     under CHATTERBOX_DEFER_KV=1: the phase-7 stream at 50 tokens on the
     per-block route (CHATTERBOX_FUSED_FIRST_CHUNK=0; K1 30 x decode
     steps, K4 once a step, K1s 30 x steps), then through a new graph
     (captured by the first request; on the default step and with K4
     replayed by the second), each with the per-block route's tokens and
     its chunks within rtol 1e-4 / atol 1e-5 and the same launch counts,
     the graph's 25 steps counted at each replay (750 K1 / K1s or 25 K4
     launches a replay); the replay's time, the kernels the profiler sees
     in it and the bytes its capture reserved; two first chunks of each
     route timed in turns. With K4: a 62-token text of the same 96-token
     bucket asked with other sampling values replays the graph (no
     capture) and equals its per-block route; two streams advanced in
     turns equal each run alone; a host read planted in a capture fails
     the request.
  9. conditioning: a 10 s reference voice (24 kHz) and a 6 s source (16 kHz)
     are synthesised from numpy seeds and written as wav files; the voice is
     prepared from the audio (cold, then warm, timed by part), checked for
     shapes and finiteness, and used by generate; a saved voice profile
     gives the same conditionals and hits the conditional cache;
     ChatterboxVC converts the source; and the card's conditionals are held
     against the port's own CPU run on the same wavs and weights.
 10. long_text: two synthetic voices saved as `.npy` profiles; warmup()
     with no voice prepared (kernels built, K4's wall, a throwaway voice,
     generate, generate_batch of 4, S3Gen at 256 tokens, a stream's first
     chunk), its stage seconds, the conditional state restored; (a) one
     story of 4 chunks with a story break through generate_long_text:
     one pooled generate_batch, every chunk accepted at its first take,
     each segment 2 * tokens * 480 samples, the stitched wav finite within
     [-1, 1], the watermark's score printed, K1 30 x steps, K2 10 x
     dispatches, K3 dispatches x (56 fresh + 8 reused CFM steps), K4 0;
     (b) two stories with two voices through generate_long_text_batch:
     one pooled generate_batch of 8 rows, the same checks per job; (c) the
     8 texts of phase 6 under CHATTERBOX_ALIGNMENT=1 with
     CHATTERBOX_FUSED_STEP=1 asked for: K1 29 x steps (the spy layer runs
     plain attention), K4 0, each wav 2 * tokens * 480 samples, and the
     rows the guard stopped before the cap printed. rtf and audio_ratio
     of each job.
 11. engine: a ContinuousServer of 4 slots (block 32, bucket 128, 256
     tokens a slot) serves 10 requests with limits of 24-200 tokens, two
     voices, one streamed; checks K1 30 x engine steps, K4 0, every wav
     finite and 2 * tokens * 480 samples, the streamed chunks joining to
     its wav, and two requests re-run alone in a new engine of the same
     geometry giving equal tokens; prints steps a second, occupancy and the
     refill, decode and vocode seconds, then the lock-step generate_batch's
     seconds on the same requests.
 12. worker: three story jobs with two voices (base64 .npy profiles)
     through RedisWorker.run_continuous on the in-memory streams and the
     local storage emulation (a temporary CHATTERBOX_LOCAL_STORAGE,
     WORKER_MAX_NEW_TOKENS 150); checks every job done, the DLQ empty, the
     audio stored, the metadata `continuous`, K1 30 x engine steps; then
     clone_voice through a ChatterboxVC on the same weights into the same
     storage (its sample through the fused step).
 13. mesh: serving on a mesh (parallel/) at full width. (a) A world of 1
     over NCCL: tts.enable_mesh(), T3's tokens for 4 texts equal the plain
     path's, and tts.generate_batch of the 4 runs over the mesh (K1 30 x
     steps; K2 and K3 in the leader's S3Gen). (b) Two ranks sharing the
     card over gloo (NCCL refuses two ranks on one card), tp = 2 on a fp32
     T3: prefill logits within atol = rtol = 2e-4 of one process's, one
     generate to its 48-token cap with K1 30 x 48 on each rank, the step's
     ms beside one process's, the weight broadcast's seconds. (c) The same
     ranks at dp = 2: generate_batch of the 4 texts equals one process
     token for token. (d) The engine at dp = 2 (4 slots, 6 requests): equal
     tokens and steps, K1 30 x steps on each rank.
 14. int8 (ROADMAP item 22), at full width, bf16 compute: (a) K1's and K1s's
     int8 entry against their plain version on the same int8 cache
     (fp32 1e-5, bf16 2e-2): B 2 and 16 (and a tp = 2 rank's 8 heads), Lc
     512 and 1280, with holes; K1s on a 4-layer stacked cache; the engine's
     16- and 4-slot spans; a planted fault (the scale planes one slot off)
     must read above the limit; timed (K1 at B=16, Lc 512 and 1280; K1s at
     B=2; the spans) beside bf16 K1 on the same shape and beside
     "dequantise + SDPA" (two calls, so no library time), with the int8
     instance's registers and resident blocks an SM; (b)
     quantize_t3 of the backbone: prefill logits against bf16 (cos > 0.995,
     rel < 0.1), then generate of 250 tokens under CHATTERBOX_FUSED_STEP=1
     (an int8 backbone never takes K4: K1 30 x steps, K4 0), its ms a step
     beside the bf16 default step's, and the trees' bytes; (c)
     quantize_s3gen: one 8-row flow_to_mel against fp (cos > 0.99, rel <
     0.15), K2 and K3 as in the batch; (d) CHATTERBOX_INT8_KV=1: prefill
     logits against the bf16 cache (cos > 0.995, rel < 0.1), generate_batch
     of the 8 texts x 250 tokens with K1's int8 entry 30 x steps and bf16
     K1 0, the cache's bytes against bf16's, max_decode_utterances; then a
     one-utterance generate under CHATTERBOX_DEFER_KV=1 too (K1s's int8
     entry 30 x steps); (e) the engine at kv_int8=True: 4 slots, 6 requests,
     K1's int8 entry 30 x steps, one request alone giving equal tokens.
 15. train: at full width in fp32 with random weights, T3 (30 layers) takes
     3 AdamW steps with remat on a batch of 2 (150 prompt tokens, text 64
     and 48, speech 256 and 200): losses finite and falling, ms a step and
     peak memory; the flow estimator takes 3 steps on 4 rows of 812, 812,
     700 and 560 frames, each with 56 launches of K3, K3b-dq and K3b-dkv;
     then one step's loss and gradients at 256 frames on the card against
     the CPU (written-out attention) on the same params, batch and draws.
 16. train_mesh: the last two parallel axes and training on a mesh, at full
     width in fp32, two ranks sharing the card over gloo, each part held to
     one process on the card: (a) sp = 2: sp_generate_mel of one
     utterance of 812 frames (CFG, 10 Euler steps) within 1e-4; (b) dp = 2:
     the flow step on 8 rows (4 a rank), its loss within 1e-4 relative and
     every gradient leaf within 1e-3 of its norm, K3, K3b-dq and K3b-dkv 56
     launches a step on each rank; (c) the T3 step (remat) at tp = 2 and
     at dp = 2 on the train phase's batch: the loss within 1e-4 relative,
     the replicated leaves bit-equal across the ranks after the steps; (d)
     pp = 2 (15 layers a stage, 2 microbatches): one step's loss within
     1e-4 relative, every leaf's gradient within 1e-3 of its norm and its
     updated values within 1e-5 of one process's step wherever that
     step's |g| >= 1e-6 (below, AdamW's eps makes the first step's update
     follow rounding); ms a step of each, ms a hop, and the backend line's
     hop collective.
 17. a JSON line describing each kernel, then the last line
     {"ok": true, "device": {...}}.

Any failure raises and the script exits non-zero with no result line. It
needs CUDA: without a card it fails at once.
"""
from __future__ import annotations

import base64
import contextlib
import gc
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

# main-path shapes of the flash-decode kernel: the CFG rows of the 16x64-head
# T3 Llama, B=2 for one utterance and B=16 for a batch of 8; cache capacity
# 512 at the smoke's 96-token text bucket and 250 new tokens, 1280 at the
# default max_new_tokens=1000; and each rank's 8 heads of one utterance on
# the mesh phase's tp = 2 (B * H = 16 gets a split plan of its own)
KERNEL_B, KERNEL_H, KERNEL_D = 2, 16, 64
KERNEL_B_BATCH = 16
KERNEL_LC = (512, 1280)
KERNEL_BH = ((KERNEL_B, KERNEL_H), (KERNEL_B, KERNEL_H // 2), (KERNEL_B_BATCH, KERNEL_H))
# fp32: kernel and plain version differ only in summation order over a few
# hundred unit-variance terms; 1e-5 is ~100x the fp32 rounding of outputs
# of size ~0.1. bf16: both round the fp32 result to bf16 once, so they may
# differ by one bf16 step of the output (2^-7 relative, <= 0.0156 for
# |out| < 4); 2e-2 covers that.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# K2 and K3 (8 heads of 64): unit-variance q and k give scaled logits of std
# ~3 over 576 terms (K2) and ~1 over 64 (K3); fp32 sums in another order
# differ at ~1e-6, so 1e-4 leaves ~100x room. bf16: one output step, as for
# K1 (the plain versions also round p to bf16 for p.v, ~2^-9 relative).
# The sharp K2 softmax puts outputs near single values of v, some above 4,
# where a bf16 step is 2^-5; so in bf16 the error is divided by
# max(1, |ref|) before it is held to 2e-2 (2^-7 = 0.0078 relative per step).
ATT_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ATT_H, ATT_D, REL_DA = 8, 64, 576
REL_SHAPES = [(b, t) for b in (4, 8, 16) for t in (406, 812)] + [(8, 2348)]
REL_TIMED = ((8, 812), (8, 406))
FLASH_SHAPES = [(b, t) for b in (8, 16, 32) for t in (812, 2348)]
FLASH_TIMED = ((16, 812),)
# bf16 only: masks with dead 64-key tiles (at the start, in the middle, one
# valid key a tile, random), among them one key tile alone (T = 40)
ATT_SMALL_T = 40
ATT_DEAD_SHAPES = ((8, 812), (8, 406), (8, ATT_SMALL_T), (8, 64), (8, 65))
# K3b (K3's backward: K3b-dq, then K3b-dkv) at the flow train step's
# shapes: B=4 in fp32 (the step's dtype) and B=16 in bf16, T=812, on a ragged
# mask (an all-valid row, a single-valid-key row, a row with no valid key,
# which must get zero gradients) and on an all-valid one. Kernel and plain
# backward read the same inputs and sum in fp32 in another order. fp32: the
# terms of each sum are O(1) (unit-normal q, k, v, dO), so each error is
# divided by max(1, |ref|) and held to ATT_TOL. bf16: both versions round
# P and dS to bf16 as product operands (as the stock TPU op does) and the
# same fp32 sums to bf16, so they differ by about one step (2^-7 relative
# at most; tests/test_torch_attention_bwd.py holds that rounding to the
# stock op's own backward, and each bf16 case also prints its error against
# the exact, unrounded backward); the gradients are ~0.05 typical, so each
# error is divided by max(|ref|, rms(ref)) and held to two steps,
# BWD_TOL_BF16 (a fault of a few percent, such as a dropped di term, is
# ~10x over it). The bf16 masks
# with dead key tiles (ATT_DEAD_SHAPES) are checked at the same limit.
BWD_CASES = ((4, 812, torch.float32), (16, 812, torch.bfloat16))
BWD_TOL_BF16 = 2 * 2.0 ** -7
# fp32 batch against solo at full width: the outputs are unit-scale
# (after the conformer's final LayerNorm; the estimator's velocity); the
# two runs differ in summation order only (kernel against factored or
# written-out attention) through 10 conformer blocks or 56 transformer
# blocks, so 1e-3 leaves ~10^3 fp32 epsilons of room.
BATCH_TOL = 1e-3
TEXT = ("The quick brown fox jumps over the lazy dog while the band plays "
        "a slow song by the river.")
# generate_batch: 8 texts of 40-90 characters (42-92 tokens with SOT/EOT,
# all in the 96-token bucket), so the K1 holes are ragged
TEXTS = [
    "The quick brown fox jumps over the lazy dog.",
    "She sells sea shells by the sea shore every summer.",
    "A slow song plays while the band packs up for the night.",
    "Rain fell on the old tin roof as the children slept soundly.",
    "The river bends twice before it meets the sea at the harbour.",
    "He wrote a letter to his brother and walked it to the post office.",
    "Every morning the baker opens the shop before the first bus arrives.",
    "The quick brown fox jumps over the lazy dog while the band plays a song.",
]
TEMPERATURES = [0.6, 0.63, 0.66, 0.69, 0.71, 0.74, 0.77, 0.8]
BATCH_KW = dict(max_new_tokens=250, cfg_weight=0.5, seed=0, temperature=TEMPERATURES)
BATCH_SUB = 8          # expected utterances per S3Gen dispatch
BATCH_STRIDE = 2       # expected CFM DeepCache stride at 8 live rows
# K1s: a stacked cache of this many layers (the layer offset is what the
# entry adds to K1; the walk does not depend on the layer count)
DEFER_LAYERS = 4
# K4: a teacher-forced chain of this many steps from `FUSED_START`, ending
# near the top of each cache capacity. fp32: kernel and plain version differ
# in summation order only, through 30 layers, and the outputs are unit-scale
# (after the final RMSNorm; the k/v rows are projections of RMS-normed
# states): 1e-3 leaves ~10^4 fp32 epsilons. bf16: both round to bf16 at the
# same places, so a sum that lands on the other side of a rounding step
# moves one output by one bf16 step (2^-7 relative) and the layers after
# carry it; through the first layer 2e-2 after dividing by max(1, |ref|)
# covers a step or two. Deeper, the steps compound (4 layers measured
# 0.0254 on an NVIDIA H100 80GB HBM3 at 700 W), so the 30-layer bf16 chain
# is held to the fp32 plain version instead (phase_fused_check).
FUSED_STEPS, FUSED_START = 16, 4
FUSED_TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
FUSED_BF16_LAYERS = 1
# the 30-layer bf16 chain against the fp32 plain version, divided by
# max(1, |ref|). On an NVIDIA H100 80GB HBM3 at 700 W, over three input
# seeds, sound runs read 0.090-0.121 (kernel) and 0.089-0.120 (the bf16
# plain version); the same seed reads the same in every run. Planted faults
# read: every layer's ln2 one bf16 step up 0.185-0.191, the start one slot
# early 3.4-3.7; one step on every weight of layer 15 reads 0.110-0.117, a
# fault this check cannot see. The limit lies between the sound runs and
# the smaller planted fault, and each of FUSED_CONTROLS must read above it.
FUSED_BF16_DEEP_LIMIT = 0.15
FUSED_CONTROLS = ("ln2-step", "start-1")     # _fused_fault kinds
FUSED_ROW_STEPS = 4    # steps of the 4-, 8- and 16-row checks
# a chain at the lowest positions (start FUSED_START, pos FUSED_START + 1 ...
# + FUSED_LOW_STEPS): the walk covers 1-4 slots, so most of its splits are
# empty; and the positions K4 is timed at (Lc 512), for the walk's cost per
# attended slot and the wall's rate
FUSED_LOW_STEPS = 4
FUSED_TIMED_POS = (44, 260, 507)
FUSED_TIMED_ROWS = (4, 8, 16)     # also timed, at the top position
# generate, by decode path: the environment that selects it
GEN_PATHS = {"default": {}, "fused": {"CHATTERBOX_FUSED_STEP": "1"},
             "defer": {"CHATTERBOX_DEFER_KV": "1"}}
STREAM_KW = dict(block_tokens=25, max_new_tokens=250, cfg_weight=0.5, temperature=0.7, seed=0)
# first_chunk: a token cap that keeps STREAM_KW's cache of 512 slots (any
# cap up to 256 does), so that a request at it replays STREAM_KW's graph
# (the routes are held to each other at that cap, two blocks; the first
# chunks are timed at STREAM_KW's); a second text of TEXT's 96-token bucket
# (62 tokens against 92), asked with other sampling values
# (FIRST_CHUNK_SAMPLING2), which the graph takes as inputs; the graph route
# held to the per-block route at the JAX package's
# test_stream_fused_equals_unfused tolerance
FIRST_CHUNK_TEXT2 = TEXTS[3]
FIRST_CHUNK_TOKENS = 50
FIRST_CHUNK_SAMPLING2 = dict(temperature=0.8, cfg_weight=0.4, repetition_penalty=1.3, min_p=0.1)
FIRST_CHUNK_RUNS = 2
ROUTE_TOL = dict(rtol=1e-4, atol=1e-5)
# (a start the kernel reads from the device, the int start it equals)
DEVICE_STARTS = ((-1, 0), (0, 0), (3, 3), (130, 130))
# bounds: the card's published rates (H100 SXM data sheet): device memory
# 3.35 TB/s; dense tensor-core peaks 989 TFLOP/s in bf16 and 1,979 TOP/s in
# int8; 67 TFLOP/s in fp32 outside the tensor cores. The serving kernels'
# timed calls run on bf16 (K5 also on int8) inputs, so their operations are
# held to the tensor-core peak of that type; K3b's main-path call is fp32
# (the train step's dtype), held to the fp32 peak.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16_tensor": 989e12, "int8_tensor": 1979e12, "fp32": 67e12}
# K5 on a 64 MB wall against its plain version in fp32: each of the 8 x 128
# sums adds n = 262,144 products (256 rows x 1024) of a unit-normal bf16
# activation and a weight uniform in [-1, 1), rms ~0.6. The products are
# exact in fp32; kernel and plain version add them in another order, and a
# running fp32 sum of n such terms drifts by about 2^-24 * n * rms. The
# limit is twice that: 2^-23 * n * 0.6 = 0.019 on sums of ~300 rms. On a
# random 1 GB wall n = 4,194,304 and the same formula gives 0.30 on sums of
# ~1200 rms. The int8 walls accumulate exact integers: the limit is 0.
# The probe's own 1 GB wall repeats every 256 rows, so a lane of the kernel
# adds the same few products again and again: its running sum grows in step
# with the walk, and the rounding of each addition (2^-24 of the sum) has
# one sign instead of averaging out. A lane adds 4 products a slab, so the
# kernel is held to 2^-24 * 4 * n_chunks of the largest sum, against a plain
# fp64 result.
WSTREAM_CHECK_MB = 64
WSTREAM_RMS = 0.6
WSTREAM_CHAIN = 2.0 ** -24
# conditioning: seconds of the reference voice and of the VC source, the new
# tokens of its two generate calls, and the limits of the card against the
# port's CPU run (fp32, TF32 off, the same wavs and weights). The two runs
# differ in summation order only. The prompt mel is a log of a clamped mel
# (values -11.5..~3): 1e-3. The x-vector comes out of ~50 convolutions and
# batch norms and is unit-scale with random weights: 1e-3 after dividing by
# max(1, |ref|). The voice-encoder embedding is a unit vector: 1e-4. Speech
# tokens round tanh(z) * 0.999 at +-0.5: they must be equal wherever every
# pre-rounding value of the frame is farther than COND_TOKEN_MARGIN from a
# boundary (fp32 sums in another order move z, of unit scale, by ~1e-4 and
# less), and at most COND_UNSAFE_SHARE of the frames may lie nearer (8
# values a frame, each within the margin with a probability of ~1 %).
COND_REF_S, COND_SRC_S, COND_NEW_TOKENS = 10, 6, 120
COND_TOL = {"prompt_feat": 1e-3, "embedding": 1e-3, "speaker_emb": 1e-4}
COND_TOKEN_MARGIN, COND_UNSAFE_SHARE = 5e-3, 0.10
# long text: two stories of 4 chunks each at target 120 / max 180 characters
# (79-166 characters a chunk, one story break in each), so one story is one
# S3Gen dispatch of 4 rows (K2's and K3's gates hold) and the pair one of 8.
# Random weights emit no EOS: each chunk decodes LONG_NEW_TOKENS steps.
LONG_STORIES = [
    "The knight rode out of the castle at dawn, past the sleeping village and the mill. "
    "He crossed the cold river and climbed the hills until the sun stood high above him. "
    "His horse was tired, so they rested by a stream and ate the last of the bread. "
    "\u2042 In a cave beyond the pass a green dragon lay asleep on a bed of old gold coins. "
    "It woke when the knight came near, looked at him for a long time, and then smiled. "
    "They talked until the stars came out, and the knight forgot why he had come.",
    "The harbour was quiet before the fishing boats came home with the morning tide. "
    "Gulls circled the masts while the old keeper lit the lamp one last time that year. "
    "Nobody on the pier remembered a morning as calm as this one had been. "
    "\u2042 By noon the market was full of voices, baskets of silver fish and the smell of "
    "bread. Children ran between the stalls and the dogs chased them down to the water. "
    "Nobody noticed the small ship with red sails tied up at the end of the pier.",
]
LONG_CHUNKS = 4
LONG_NEW_TOKENS = 150
LONG_KW = dict(target_chars=120, max_chars=180, max_new_tokens=LONG_NEW_TOKENS, seed=0)
# K1 with per-row spans (the continuous engine's step): (slots, text
# bucket, ring R). The worker's default engine: 16 slots = 32 CFG rows,
# bucket 256, cond width 34, p_len 292, R 1000, Lc 1292; and the engine
# phase's: 4 slots, bucket 128, p_len 164, R 256, Lc 420. The limits are
# K1's (TOL): the span changes which keys a row walks, not the arithmetic.
SPAN_GEOMETRIES = ((16, 256, 1000), (4, 128, 256))
SPAN_COND_W = 34
# the continuous engine at full width: a ContinuousServer of 4 slots,
# 32-step blocks, bucket 128, 256 tokens a slot; 10 requests (the batch's 8
# texts and two more), two voices, limits skewed from 24 to 200 tokens
# (random weights emit no EOS: the limits set the lengths), the third one
# streamed. Two requests run again alone in an engine of the same geometry
# and must give the same tokens (bf16: the same GEMM shapes, each row's own
# K1 range). The same requests then go through the lock-step
# generate_batch at the largest limit, for its seconds only.
ENGINE_GEO = dict(slots=4, text_bucket=128, max_new_tokens=256, block=32, vocode_batch=4)
ENGINE_TEXTS = TEXTS + [TEXT, "The harbour was quiet before the fishing boats came home "
                              "with the morning tide."]
ENGINE_LIMITS = [24, 200, 40, 160, 60, 120, 30, 180, 80, 100]
ENGINE_STREAMED = 2
ENGINE_ALONE = (0, 5)
# the Redis worker at full width: three story jobs (one or two chunks of
# under 250 characters each, inside the engine's 256-token bucket), two
# voices as base64 `.npy` profiles, through run_continuous on the in-memory
# stream backend and the local storage emulation; WORKER_MAX_NEW_TOKENS 150
# so that random weights end. Then one voice clone into the same storage.
WORKER_STORIES = [
    "The knight rode out of the castle at dawn, past the sleeping village and the mill. "
    "\u2042 In a cave beyond the pass a green dragon lay asleep on a bed of old gold.",
    "The harbour was quiet before the fishing boats came home with the morning tide.",
    "By noon the market was full of voices and baskets of silver fish. \u2042 "
    "Nobody noticed the small ship with red sails tied up at the end of the pier.",
]
WORKER_NEW_TOKENS = 150
# train: T3 at full width (ChatterboxConfig().t3, fp32) on a batch of 2 with
# 150 prompt tokens, text 64 and 48, speech 256 and 200; the flow estimator
# at full width (FlowDecoderConfig(), fp32) on 4 rows (K3's gate) of these
# frames; TRAIN_STEPS AdamW steps each (lr 1e-4)
TRAIN_T3_TEXT = (64, 48)
TRAIN_T3_SPEECH = (256, 200)
TRAIN_FLOW_FRAMES = (812, 812, 700, 560)
TRAIN_STEPS = 3
# one flow step's loss and gradients on the card (K3 and K3b) against the
# CPU (written-out attention under autograd) on the same params, batch and
# draws, fp32, TF32 off: the two differ in summation order through 56
# transformer blocks and 16 resnets forward and back. The loss within 1e-4
# relative; each leaf's max |g_card - g_cpu| within 1e-3 of the CPU leaf's
# norm (plus 1e-7 for leaves whose gradient is rounding noise): ten times
# the CPU tests' 1e-4 between packages on a 2-block estimator.
TRAIN_CHECK_FRAMES = (256, 256, 220, 180)
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3

# the mesh phase: 4 utterances of TEXTS, 48 tokens each; the tp prefill
# logits held to one process's as tests/test_parallel.py holds the JAX
# package's (fp32, atol and rtol 2e-4: the tp sums reassociate the o/down
# products); the engine's 4 slots over dp = 2 with 6 requests
MESH_TEXTS = 4
MESH_NEW_TOKENS = 48
MESH_LOGIT_TOL = 2e-4
# tp = 2 decode steps (K1 on 8 heads a rank, the o/down sums) teacher-forced
# on one process's tokens, each step's logits held to MESH_LOGIT_TOL
MESH_FORCED_STEPS = 16
MESH_ENGINE = dict(slots=4, text_bucket=128, max_new_tokens=64, block=16)
MESH_ENGINE_LIMITS = (40, 12, 28, 20, 36, 16)

# train_mesh: two ranks sharing the card over gloo, full width, fp32, each
# part held to one process on the card. (a) sp = 2 on one utterance of
# TRAIN_MESH_SP_FRAMES frames: the halo and the K/V gathers move values
# exactly, so the limit leaves room only for the shards' own rounding
# (~1e-6 expected); (b) the flow step at dp = 2 on the train phase's rows
# twice over (4 a rank: K3's gate) at the train phase's limits; (c) the T3
# step at tp = 2 and dp = 2 on the train phase's batch; (d) pp = 2 with
# TRAIN_MESH_MICRO microbatches, its updated stages within
# TRAIN_MESH_PARAM_TOL of one process's step (a tenth of one AdamW step at
# lr 1e-4, the CPU tests' bound)
TRAIN_MESH_SP_FRAMES = 812
TRAIN_MESH_SP_TOL = 1e-4
TRAIN_MESH_MICRO = 2
TRAIN_MESH_PARAM_TOL = 1e-5
# AdamW's first step moves an element by lr * g / (|g| + eps), eps 1e-8:
# where |g| is near eps, a rounding difference of the gradient moves the
# update by up to lr, so the parameter limit holds where one process's
# |g| >= TRAIN_MESH_GRAD_FLOOR (there a gradient difference d moves the
# update by at most lr * eps * d / g^2 = d); the gradients themselves are
# held to TRAIN_GRAD_TOL of each leaf's norm everywhere
TRAIN_MESH_GRAD_FLOOR = 1e-6

# int8 (ROADMAP item 22). (a) K1's and K1s's int8 entry against the plain
# version on the same int8 cache, at K1's limits (TOL: the scales multiply
# each score and probability once, in fp32 on both sides). In bf16 the
# plain version also rounds w * vs to bf16 before its product, as the JAX
# package's mode-1 read does, so where one key dominates the two round
# vs * vq twice and once: they differ by one bf16 step of the output, and
# a value row of the int8 cache reaches past 4, where that step is 2^-5
# (0.03125, read on the card at first). So in bf16 each error is
# divided by max(1, |ref|) before it is held to 2e-2, as K2's and K3's are
# (one step is 2^-7 of the output); fp32 stays absolute. The (start,
# cache_pos) cases of K1's check less the duplicates of one split.
# (b)-(d) the quality bounds of tests/test_int8.py (logits cos > 0.995
# and rel < 0.1; mel cos > 0.99 and rel < 0.15) on the full-width
# random weights; (e) the engine phase's geometry with half the cap and 6
# of its requests (the phase's time), one of them again alone. The deferred
# entry is checked at T3's 16 heads only (INT8_DEFER_BH): the mesh runs K1
# (KERNEL_BH has a tp = 2 rank's 8 heads), never K1s.
INT8_DEFER_BH = ((KERNEL_B, KERNEL_H), (KERNEL_B_BATCH, KERNEL_H))
INT8_CASES = ((0, 0), (3, 40), (63, 64), (64, 300), (5, -1), (300, 300), (72, 205))
INT8_LOGIT_COS, INT8_LOGIT_REL = 0.995, 0.1
INT8_MEL_COS, INT8_MEL_REL = 0.99, 0.15
INT8_NEW_TOKENS = 250
INT8_MEL_ROWS, INT8_MEL_TOKENS = 8, 250
INT8_DEFER_TOKENS = 32
INT8_ENGINE_GEO = dict(slots=4, text_bucket=128, max_new_tokens=128, block=32, vocode_batch=4,
                       kv_int8=True)
INT8_ENGINE_LIMITS = [24, 100, 40, 80, 60, 30]
INT8_ENGINE_ALONE = 3


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from chatterbox_embed_tpu_torch.probes import timing
    card = timing.card_line()       # nvidia-smi's name and power limit
    print(card, flush=True)
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
        matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_tf32=torch.backends.cudnn.allow_tf32)
    return card


def _kernels() -> dict:
    """name -> (kernel module, the wrapper that counts its launches, the
    counter's attribute, its C entry). K1 and K1s, and their int8 entries,
    are four entries of one kernel source with a counter each, and K3b-dq
    and K3b-dkv two of another."""
    from chatterbox_embed_tpu_torch.kernels import decode_anatomy as da
    from chatterbox_embed_tpu_torch.kernels import flash_attention as fa
    from chatterbox_embed_tpu_torch.kernels import flash_attention_bwd as fb
    from chatterbox_embed_tpu_torch.kernels import flash_decode as fd
    from chatterbox_embed_tpu_torch.kernels import fused_decode as fu
    from chatterbox_embed_tpu_torch.kernels import rel_attention as ra
    from chatterbox_embed_tpu_torch.kernels import weight_stream as ws
    return {"flash_decode": (fd, fd.decode_attention, "launches", "cbx_flash_decode"),
            "flash_decode_deferred": (fd, fd.decode_attention, "launches_deferred",
                                      "cbx_flash_decode"),
            "rel_attention": (ra, ra.rel_attention, "launches", "cbx_rel_attention"),
            "flash_attention": (fa, fa.flash_attention, "launches", "cbx_flash_attention"),
            "flash_attention_bwd_dq": (fb, fb.flash_attention_backward, "launches_dq",
                                       "cbx_flash_attention_bwd_dq"),
            "flash_attention_bwd_dkv": (fb, fb.flash_attention_backward, "launches_dkv",
                                        "cbx_flash_attention_bwd_dkv"),
            "flash_decode_int8": (fd, fd.decode_attention, "launches_int8", "cbx_flash_decode"),
            "flash_decode_int8_deferred": (fd, fd.decode_attention, "launches_int8_deferred",
                                           "cbx_flash_decode"),
            "fused_decode": (fu, fu.fused_decode_step, "launches", "cbx_fused_decode"),
            "weight_stream": (ws, ws.stream_once, "launches", "cbx_weight_stream"),
            "decode_anatomy": (da, da.attn, "launches", "cbx_decode_anatomy")}


def phase_build() -> None:
    from chatterbox_embed_tpu_torch.kernels import _build
    kernels = _kernels()
    built = _build.build_all(sorted({m.SOURCE for m, _, _, _ in kernels.values()}))
    for name, (m, _, _, entry) in kernels.items():
        path, seconds = built[m.SOURCE]
        _build.load(m.SOURCE, entry, m._ARGTYPES)    # a bad library fails here
        log("build", kernel=name, seconds=f"{seconds:.2f}",
            library=path.relative_to(_build.PKG.parent))


def _time_ms(fn, iters: int = 200) -> float:
    """Per-call time of back-to-back calls from CUDA events (the package's
    probes/timing.py, which the probes use too)."""
    from chatterbox_embed_tpu_torch.probes import timing
    return timing.time_ms(fn, iters)


def _device_ms(fn, iters: int = 50, tries: int = 3) -> float:
    """Device time per call from torch.profiler (probes/timing.py)."""
    from chatterbox_embed_tpu_torch.probes import timing
    return timing.device_ms(fn, iters, tries)


def _clocks() -> str:
    """The card's SM and memory clocks, power draw and temperature now, as
    nvidia-smi prints them (logged beside K4's times, which vary by machine
    and run while these read the same: PERF.md)."""
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
                          "temperature.gpu", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "n/a"


def _bound(nbytes: float, ops: float, peak: str = "bf16_tensor") -> dict:
    """The least time the card could take for a call that must move
    `nbytes` (each input read once, each output written once) and do `ops`
    operations of the type whose peak is named: the larger of the two."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S[peak] * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes": int(nbytes), "bound_ops": int(ops), "bound_peak": peak}


def _library(name: str, fn, card: str, iters: int = 20, dtype: str = "bfloat16",
             **shape) -> float:
    """Device time per call of the one PyTorch call `fn` that computes a
    kernel's function, and the device kernel it spent most time in (which
    tells the backend that ran). Measured only: no path of the port calls
    it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ms = _device_ms(fn, iters)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    top = max(events, key=lambda e: e.self_device_time_total).key if events else "none"
    log("library_time", name=name, **shape, dtype=dtype, device_ms=f"{ms:.5f}",
        top_kernel=repr(top[:100]), card=repr(card))
    return ms


def _decode_work(b: int, h: int, d: int, start: int, pos: int, hole, deferred: bool,
                 itemsize: int = 2):
    """(bytes, operations) that one decode-attention call needs on these
    inputs: the live k and v rows of each batch row (its walk minus its
    hole, plus the current row with the deferred entry), q and out; a
    multiply-add for q.k and one for p.v per live key element."""
    walk_end = pos - 1 if deferred else pos
    holes = None if hole is None else hole.tolist()
    keys = 0
    for r in range(b):
        n = walk_end - start + 1
        if holes is not None:
            lo, hi = holes[r]
            n -= max(0, min(hi, walk_end + 1) - max(lo, start))
        keys += n + (1 if deferred else 0)
    return itemsize * h * d * (2 * keys + 2 * b), 4 * keys * h * d


def _timing(kernel, plain, iters: int = 50, plain_iters=None) -> dict:
    """Both versions' device time and back-to-back call time; `plain_iters`
    gives the plain version fewer calls (a 30-layer plain step is ~1500
    launches, and the profiler takes seconds to sum them)."""
    p_iters = plain_iters or iters
    return {"ms": _device_ms(kernel, iters), "plain_ms": _device_ms(plain, p_iters),
            "call_ms": _time_ms(kernel, 4 * iters), "plain_call_ms": _time_ms(plain, 4 * p_iters)}


def _log_time(name: str, timing: dict, card: str, **shape) -> None:
    log("kernel_time", name=name, **shape, dtype="bfloat16",
        device_ms=f"{timing['ms']:.5f}", plain_device_ms=f"{timing['plain_ms']:.5f}",
        call_ms=f"{timing['call_ms']:.5f}",
        plain_call_ms=f"{timing['plain_call_ms']:.5f}", card=repr(card))


def _check_err(name: str, out, ref, limit: float, relative: bool = False,
               rms_floor: bool = False, **case) -> float:
    """max |out - ref| against `limit`; with `relative`, each element's
    error is first divided by max(1, |ref|) (one bf16 step grows with the
    output's magnitude), with `rms_floor` by max(|ref|, rms(ref)) instead.
    Returns the max absolute error."""
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    floor = ref.float().pow(2).mean().sqrt().item() if rms_floor else 1.0
    relative = relative or rms_floor
    bound = (diff / ref.float().abs().clamp_min(floor)).max().item() if relative else err
    if not np.isfinite(err) or bound > limit:
        raise AssertionError(f"{name} {case}: max|err|={err} (checked {bound}) > {limit}")
    checked = ({"max_err_over_max_rms_ref": f"{bound:.3e}", "rms_ref": f"{floor:.3e}"}
               if rms_floor else {"max_err_over_max1_ref": f"{bound:.3e}"} if relative else {})
    log("kernel", name=name, **case, max_abs_err=f"{err:.3e}", **checked, limit=limit)
    return err


def _batch_holes(b: int) -> torch.Tensor:
    """A different dead range [lo, hi) per row, some empty, as ragged text
    gives (the CFG rows repeat the utterance rows' holes). The holes lie in
    [70, 124), so every (start, cache_pos) case keeps a live slot in every
    row, as the path does (the plain version's softmax of a row with no
    live slot is NaN; the kernel gives 0)."""
    u = b // 2
    lo = [70 + 3 * r for r in range(u)]
    hi = [lo[r] + (0 if r % 3 == 0 else 4 * r + 5) for r in range(u)]
    holes = [[l, h] for l, h in zip(lo, hi)] * 2
    return torch.tensor(holes, dtype=torch.int32, device="cuda")


def _check_device_starts(card: str, name: str, call) -> None:
    """call(start) -> the kernel's output. A start read from the device
    (the first chunk's CUDA graphs pass it so) gives the same launch's
    output as the int start, bit for bit, and -1 reads as 0 (the kernels
    clamp it, as a span's start)."""
    for dev_start, start in DEVICE_STARTS:
        got = call(torch.tensor([dev_start], dtype=torch.int32, device="cuda"))
        want = call(start)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: device start {dev_start} differs from the int start "
                                 f"{start} by {float((got.float() - want.float()).abs().max())}")
    log("device_start", kernel=name, starts=",".join(str(c[0]) for c in DEVICE_STARTS),
        equal=True, card=repr(card))


def phase_kernel_check(card: str, deferred: bool = False) -> dict:
    """K1 against decode_attention_reference on the card, or with
    `deferred` its deferred-insert entry K1s: a DEFER_LAYERS-layer stacked
    cache with a layer index and the current row folded in. Each (B, H) of
    KERNEL_BH at each Lc of KERNEL_LC: T3's 16 heads and a tp = 2 rank's 8."""
    from chatterbox_embed_tpu_torch.kernels import flash_decode as fd
    name = "flash_decode_deferred" if deferred else "flash_decode"
    g = torch.Generator(device="cuda").manual_seed(4242 if deferred else 1234)
    d = KERNEL_D
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    timing = {}
    for b, h in KERNEL_BH:
        for lc in KERNEL_LC:
            # (start, cache_pos) pairs: inside one split, across split edges,
            # a start on an edge, the last slot, and the smoke's decode range;
            # a walk of one slot (K1s: of none, the current row alone); fewer
            # live slots than splits (the last splits empty); and a live range
            # that starts inside a row's hole (B=2: row 1 dead over [70, 200),
            # so its first splits read nothing and its last is empty)
            cases = [(0, 0), (3, 40), (10, 63), (63, 64), (64, 300), (130, 381),
                     (5, lc - 1), (300, 300), (300, 305), (72, 205)]
            for dtype in (torch.float32, torch.bfloat16):
                q, kc, vc = (torch.randn((b, h, d), generator=g, device="cuda").to(dtype)
                             for _ in range(3))
                shape = ((DEFER_LAYERS,) if deferred else ()) + (lc, b, h, d)
                k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                        for _ in range(2))
                holes = [None, torch.tensor([[0, 0], [70, 200]], dtype=torch.int32,
                                            device="cuda") if b == KERNEL_B else _batch_holes(b)]

                def args(start, pos, hole, layer):
                    extra = dict(layer=layer, k_cur=kc, v_cur=vc) if deferred else {}
                    return (q, k, v, pos, start, hole), extra

                for hole in holes:
                    for start, pos in cases:
                        layer = (start + pos) % DEFER_LAYERS
                        a, kw = args(start, pos, hole, layer)
                        out = fd.decode_attention(*a, **kw)
                        ref = fd.decode_attention_reference(*a, **kw)
                        err = _check_err(name, out, ref, TOL[dtype], b=b, h=h, lc=lc,
                                         dtype=str(dtype)[6:], start=start, pos=pos,
                                         hole=hole is not None,
                                         **({"layer": layer} if deferred else {}))
                        worst[dtype] = max(worst[dtype], err)
                if dtype == torch.bfloat16 and h == KERNEL_H:
                    # time at the decode step's shape: the live range the main
                    # path reaches mid-generation
                    start, pos, hole = 4, min(lc - 1, 4 + (lc - 4) * 3 // 4), holes[-1]
                    a, kw = args(start, pos, hole, DEFER_LAYERS - 1)
                    t = _timing(lambda: fd.decode_attention(*a, **kw),
                                lambda: fd.decode_attention_reference(*a, **kw))
                    t.update(_bound(*_decode_work(b, h, d, start, pos, hole, deferred)))
                    t["library_ms"] = None
                    if not deferred:
                        # the library's call for the same function: one query
                        # row per (row, head) over the cache as (B, H, Lc, D)
                        # views, a boolean mask for [start, pos] minus the hole
                        idx = torch.arange(lc, device="cuda")[None, :]
                        live = (idx >= start) & (idx <= pos) & ~(
                            (idx >= hole[:, :1]) & (idx < hole[:, 1:2]))
                        sq, sk, sv = q[:, :, None, :], k.permute(1, 2, 0, 3), v.permute(1, 2, 0, 3)
                        smask = live[:, None, None, :]

                        def sdpa():
                            return torch.nn.functional.scaled_dot_product_attention(
                                sq, sk, sv, attn_mask=smask)
                        _check_err(name + "_library", sdpa()[:, :, 0], fd.decode_attention(*a),
                                   TOL[dtype], b=b, lc=lc, call="sdpa")
                        t["library_ms"] = _library(name, sdpa, card, b=b, lc=lc, call="sdpa")
                    timing[(b, lc)] = t
                    _log_time(name, t, card, b=b, lc=lc, start=start, pos=pos,
                              hole=hole is not None)
    q, kc, vc = (torch.randn((KERNEL_B, KERNEL_H, d), generator=g, device="cuda")
                 for _ in range(3))
    k, v = (torch.randn(((DEFER_LAYERS,) if deferred else ()) + (KERNEL_LC[0], KERNEL_B,
                                                                   KERNEL_H, d),
                        generator=g, device="cuda") for _ in range(2))
    extra = dict(layer=DEFER_LAYERS - 1, k_cur=kc, v_cur=vc) if deferred else {}
    _check_device_starts(card, name, lambda st: fd.decode_attention(q, k, v, 381, st, **extra))
    # the JSON line reports each path's shape at Lc 512: K1 on the batched
    # path (8 utterances), K1s on the deferred one-utterance path; K1 also
    # its per-row span cases, timed at the worker's engine
    out = {"max_abs_err": worst[torch.bfloat16], "max_abs_err_fp32": worst[torch.float32],
           "timing": timing[(KERNEL_B if deferred else KERNEL_B_BATCH, KERNEL_LC[0])]}
    if not deferred:
        span = phase_span_check(card)
        out["timing"].update(ms_span=span["timing"]["ms"],
                             plain_ms_span=span["timing"]["plain_ms"],
                             bound_ms_span=span["timing"]["bound_ms"],
                             library_ms_span=span["timing"]["library_ms"])
        out.update(max_abs_err_span=span["max_abs_err"],
                   max_abs_err_span_fp32=span["max_abs_err_fp32"])
        log("flash_decode_span_beside_scalar", span_ms=f"{span['timing']['ms']:.5f}",
            scalar_ms=f"{out['timing']['ms']:.5f}", scalar_b=KERNEL_B_BATCH,
            scalar_lc=KERNEL_LC[0], card=repr(card))
    return out


def _span_case(slots: int, p_len: int, ring: int, g: int, ages, pads, dead):
    """K1's span and hole for `slots` engine slots at step g (the engine's
    own engine_spans): each slot joined `ages` steps ago (g - gs)."""
    from chatterbox_embed_tpu_torch.models.t3_engine import engine_spans

    def cuda(x, dt=torch.int64):
        return torch.tensor(np.asarray(x), dtype=dt, device="cuda")
    return engine_spans(cuda(pads), cuda(g - np.asarray(ages)), cuda(dead, torch.bool), g,
                        p_len, ring)


def _span_keys(span, hole) -> int:
    """Live keys over the rows of (span, hole): each span minus its hole."""
    n = 0
    for (lo, hi), (hlo, hhi) in zip(span.tolist(), hole.tolist()):
        if hi >= lo:
            n += hi - lo + 1 - max(0, min(hhi, hi + 1) - max(hlo, lo))
    return n


def _span_cases(rng, slots: int, bucket: int, ring: int):
    """One SPAN_GEOMETRIES geometry's K1 cases, drawn from `rng`: (p_len,
    Lc, rows, ring column c, {case: (span, hole)}, the timed (span, hole),
    every slot live at a random depth)."""
    p_len = bucket + SPAN_COND_W + 2
    lc, b = p_len + ring, 2 * slots
    step = 3 * ring + 7                      # the ring has wrapped three times
    c = step % ring
    pads = rng.integers(0, bucket, slots)
    live = np.zeros(slots, bool)
    cases = {
        "no_wrap": _span_case(slots, p_len, ring, step, rng.integers(0, c + 1, slots),
                              pads, live),
        "wrap": _span_case(slots, p_len, ring, step, rng.integers(c + 1, ring, slots),
                           pads, live),
        "empty_hole": _span_case(slots, p_len, ring, step, np.full(slots, c), pads, live),
        "full_ring": _span_case(slots, p_len, ring, step, np.full(slots, ring - 1), pads,
                                live),
        "free_rows": _span_case(slots, p_len, ring, step, rng.integers(0, ring, slots),
                                pads, np.arange(slots) % 2 == 1),
        "mixed": _span_case(slots, p_len, ring, step, rng.integers(0, ring, slots), pads,
                            rng.random(slots) < 0.25),
    }
    one = torch.tensor(rng.integers(0, lc, b), dtype=torch.int32, device="cuda")
    cases["one_slot"] = (torch.stack([one, one], 1).contiguous(),
                         torch.zeros((b, 2), dtype=torch.int32, device="cuda"))
    timed = _span_case(slots, p_len, ring, step, rng.integers(0, ring, slots), pads, live)
    return p_len, lc, b, c, cases, timed


def phase_span_check(card: str, int8: bool = False) -> dict:
    """K1 with per-row spans against its plain version at SPAN_GEOMETRIES:
    rows unwrapped, wrapped, with an empty hole (a = 0), a full ring, free
    rows (whose output must be exactly 0), one-slot spans and a random mix;
    fp32 and bf16. The worker's geometry is timed in bf16 with every slot
    live at random depths, beside SDPA with a boolean mask over the same
    keys; the bound is the live rows' bytes. `int8`: K1's int8 entry on an
    int8 cache (the engine's kv_int8), timed without a library call."""
    from chatterbox_embed_tpu_torch.kernels import flash_decode as fd
    name = "flash_decode_span" + ("_int8" if int8 else "")
    rng = np.random.default_rng(77)
    g = torch.Generator(device="cuda").manual_seed(77)
    h, d = KERNEL_H, KERNEL_D
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    timing = None
    for slots, bucket, ring in SPAN_GEOMETRIES:
        p_len, lc, b, c, cases, timed = _span_cases(rng, slots, bucket, ring)
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, h, d), generator=g, device="cuda").to(dtype)
            sc = {}
            if int8:
                (k, ks), (v, vs) = (_quantized((lc, b, h, d), g) for _ in range(2))
                sc = dict(k_scale=ks, v_scale=vs)
            else:
                k, v = (torch.randn((lc, b, h, d), generator=g, device="cuda").to(dtype)
                        for _ in range(2))
            for case, (span, hole) in cases.items():
                out = fd.decode_attention(q, k, v, p_len + c, span=span, hole=hole, **sc)
                ref = fd.decode_attention_reference(q, k, v, p_len + c, span=span, hole=hole,
                                                    **sc)
                err = _check_err(name, out, ref, TOL[dtype],
                                 relative=int8 and dtype == torch.bfloat16, slots=slots,
                                 lc=lc, dtype=str(dtype)[6:], case=case)
                empty = (span[:, 0] > span[:, 1]).nonzero().flatten()
                if empty.numel() and out[empty].abs().max().item() != 0.0:
                    raise AssertionError(f"{name} {case}: a free row is not 0")
                worst[dtype] = max(worst[dtype], err)
            if dtype == torch.bfloat16 and slots == SPAN_GEOMETRIES[0][0]:
                span, hole = timed
                t = _timing(lambda: fd.decode_attention(q, k, v, p_len + c, span=span,
                                                        hole=hole, **sc),
                            lambda: fd.decode_attention_reference(q, k, v, p_len + c, span=span,
                                                                  hole=hole, **sc))
                keys = _span_keys(span, hole)
                # int8: each live key's two int8 rows and two fp32 scales a head
                t.update(_bound((h * (2 * d + 8) * keys + 2 * 2 * b * h * d) if int8
                                else 2 * h * d * (2 * keys + 2 * b), 4 * keys * h * d))
                if int8:
                    t["library_ms"] = None
                    timing = t
                    _log_time(name, t, card, slots=slots, rows=b, lc=lc, live_keys=keys,
                              bound_ms=f"{t['bound_ms']:.5f}")
                    continue
                idx = torch.arange(lc, device="cuda")[None, :]
                mask = ((idx >= span[:, :1]) & (idx <= span[:, 1:])
                        & ~((idx >= hole[:, :1]) & (idx < hole[:, 1:])))
                sq, sk, sv = q[:, :, None, :], k.permute(1, 2, 0, 3), v.permute(1, 2, 0, 3)
                smask = mask[:, None, None, :]

                def sdpa():
                    return torch.nn.functional.scaled_dot_product_attention(
                        sq, sk, sv, attn_mask=smask)
                _check_err("flash_decode_span_library", sdpa()[:, :, 0],
                           fd.decode_attention(q, k, v, p_len + c, span=span, hole=hole),
                           TOL[dtype], slots=slots, lc=lc, call="sdpa")
                t["library_ms"] = _library("flash_decode_span", sdpa, card, slots=slots,
                                           lc=lc, call="sdpa_bool_mask")
                timing = t
                _log_time("flash_decode_span", t, card, slots=slots, rows=b, lc=lc,
                          live_keys=keys, bound_ms=f"{t['bound_ms']:.5f}")
    return {"max_abs_err": worst[torch.bfloat16], "max_abs_err_fp32": worst[torch.float32],
            "timing": timing}


def _fused_chain(fused, cfg, lc: int, dtype, g, fused32=None, b: int = KERNEL_B,
                 steps: int = FUSED_STEPS, fault: dict | None = None,
                 pos0: int | None = None) -> dict:
    """`steps` teacher-forced steps of K4 for `b` rows in `dtype` on a random
    cache, from position `pos0` (default: ending 4 slots below the top of
    Lc): before each step the plain version (and, with `fused32`, the
    plain version in fp32 on the same values) starts from a copy of the
    kernel's cache. `fault` plants a fault in the kernel's run only: its
    "fused" weights or its "start". Returns {version: (h (steps, B, d), new
    k/v rows)} in fp32, and the last step's arguments for timing."""
    from chatterbox_embed_tpu_torch.kernels import fused_decode as fu
    start = FUSED_START
    fault = fault or {}
    n_layers = fused["wall"].shape[0]
    pos0 = lc - steps - 4 if pos0 is None else pos0
    shape = (n_layers, lc, b, cfg.num_heads, cfg.head_dim)
    ck, cv = (torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(2))
    rk, rv = torch.empty_like(ck), torch.empty_like(cv)
    out = {v: ([], []) for v in ("kernel", "plain") + (("plain32",) if fused32 else ())}
    for i in range(steps):
        pos = pos0 + i
        x = torch.randn((b, cfg.hidden_size), generator=g, device="cuda").to(dtype)
        runs = [("plain", fused, rk, rv, x, fu.fused_decode_step_reference, dtype)]
        if fused32:
            runs.append(("plain32", fused32, ck.float(), cv.float(), x.float(),
                         fu.fused_decode_step_reference, torch.float32))
        rk.copy_(ck)
        rv.copy_(cv)
        runs.insert(0, ("kernel", fault.get("fused", fused), ck, cv, x, fu.fused_decode_step,
                        dtype))
        for name, fz, k, v, xi, fn, dt in runs:
            st = fault.get("start", start) if name == "kernel" else start
            h, k, v = fn(fz, xi, k, v, pos, st, cfg, dt)
            out[name][0].append(h.float())
            out[name][1].append(torch.stack([k[:, pos], v[:, pos]]).float())
    res = {name: (torch.stack(hs), torch.stack(rows)) for name, (hs, rows) in out.items()}
    return res, (x, ck, cv, rk, rv, pos0 + steps - 1, start)


def _fused_fault(kind: str, fused16) -> dict:
    """A fault to plant in K4's run (_fused_chain's `fault`): "start-1"
    starts the walk and the RoPE positions one slot early; "wall-step-L"
    moves every weight of layer L one bf16 step up; "ln2-step" moves every
    layer's post-attention norm weights one bf16 step up."""
    if kind == "start-1":
        return {"start": FUSED_START - 1}
    up = 1.0 + 2.0 ** -7
    if kind.startswith("wall-step-"):
        layer = int(kind.rsplit("-", 1)[1])
        wall = fused16["wall"].clone()
        wall[layer] = (wall[layer].float() * up).to(wall.dtype)
        return {"fused": dict(fused16, wall=wall)}
    if kind == "ln2-step":
        return {"fused": dict(fused16, ln2=(fused16["ln2"].float() * up).to(
            fused16["ln2"].dtype))}
    raise ValueError(f"unknown fault {kind!r}")


def _deep_check(res, run: str, **case) -> float:
    """A bf16 chain against the fp32 plain version on the same values: for
    h and the k/v rows, the kernel's and the bf16 plain version's worst
    error divided by max(1, |ref|). Logs them; returns the kernel's worst
    (inf if any is not finite)."""
    worst = 0.0
    for t_i, tensor in enumerate(("h", "kv_rows")):
        truth = res["plain32"][t_i]
        errs = {v: ((res[v][t_i] - truth).abs() / truth.abs().clamp_min(1.0)).max().item()
                for v in ("kernel", "plain")}
        direct = (res["kernel"][t_i] - res["plain"][t_i]).abs().max().item()
        worst = max(worst, errs["kernel"] if np.isfinite(errs["kernel"]) else float("inf"))
        log("kernel", name="fused_decode", run=run, tensor=tensor, dtype="bfloat16",
            against="fp32_plain", **case, kernel_err_over_max1_ref=f"{errs['kernel']:.3e}",
            plain_err_over_max1_ref=f"{errs['plain']:.3e}",
            max_abs_kernel_minus_plain=f"{direct:.3e}", limit=FUSED_BF16_DEEP_LIMIT)
    return worst


def fused_times(fused16, cfg, card: str, build: str = "shipped") -> dict:
    """K4's bf16 time by CUDA events over steps queued behind a spin kernel
    (probes/timing.fused_step_ms), Lc 512: at B=KERNEL_B at each of
    FUSED_TIMED_POS (what the walk adds per attended slot, the rate of the
    wall), and at 4, 8 and 16 rows at the top position. (b, pos) -> ms."""
    from chatterbox_embed_tpu_torch.probes import timing
    lc = KERNEL_LC[0]
    at = timing.fused_step_ms(fused16, cfg, KERNEL_B, FUSED_TIMED_POS, lc, FUSED_START)
    wall_gb = fused16["wall"].numel() * fused16["wall"].element_size() / 1e9
    lo_pos, hi_pos = FUSED_TIMED_POS[0], FUSED_TIMED_POS[-1]
    log("fused_decode_positions", build=build, b=KERNEL_B, lc=lc, start=FUSED_START,
        dtype="bfloat16", **{f"queued_ms_pos{pos}": f"{ms:.5f}" for pos, ms in at.items()},
        slope_us_per_slot=f"{(at[hi_pos] - at[lo_pos]) * 1e3 / (hi_pos - lo_pos):.4f}",
        **{f"wall_gb_per_s_pos{pos}": f"{wall_gb / (ms / 1e3):.1f}" for pos, ms in at.items()},
        clocks_after=repr(_clocks()), card=repr(card))
    times = {(KERNEL_B, pos): ms for pos, ms in at.items()}
    for b in FUSED_TIMED_ROWS:
        ms = timing.fused_step_ms(fused16, cfg, b, (hi_pos,), lc, FUSED_START)[hi_pos]
        times[(b, hi_pos)] = ms
        log("fused_decode_rows", build=build, b=b, lc=lc, start=FUSED_START, pos=hi_pos,
            layers=cfg.num_layers, dtype="bfloat16", queued_ms=f"{ms:.5f}", card=repr(card))
    return times


def phase_fused_check(card: str, tts) -> dict:
    """K4 against its plain version at full width (d=1024, B=2, start
    FUSED_START, FUSED_STEPS teacher-forced steps ending near the top of
    each cache capacity), on h and every layer's new k/v row:
      fp32, 30 layers: <= FUSED_TOL (kernel and plain differ in summation
        order only);
      bf16, the first FUSED_BF16_LAYERS layers: <= FUSED_TOL after dividing
        by max(1, |ref|);
      bf16, 30 layers: a sum that rounds the other way moves one value by a
        bf16 step, and the layers after carry and compound it (the fp32
        check's 1e-7 summation differences end near 5e-6), so the kernel's
        and the plain version's bf16 runs drift apart by several steps. The
        kernel is held to the fp32 plain version on the same values instead:
        <= FUSED_BF16_DEEP_LIMIT after dividing by max(1, |ref|). At Lc 512
        the same inputs go through the kernel with each fault of
        FUSED_CONTROLS planted, which must read above the limit.
    Then the 4-, 8- and 16-row templates over FUSED_ROW_STEPS steps: 4 and 8
    rows in fp32 through 30 layers, 16 rows in bf16 through one; and each
    template's kernel time at 30 layers in bf16 (fused_times)."""
    from chatterbox_embed_tpu_torch.kernels import fused_decode as fu
    from chatterbox_embed_tpu_torch.weights import place
    cfg = tts.cfg.t3.llama
    g = torch.Generator(device="cuda").manual_seed(99)
    fused32 = fu.stack_for_fused(place(tts.t3_params["llama"], "cuda", torch.float32), cfg,
                                 torch.float32)
    fused16 = fu.stack_for_fused(tts.t3_params["llama"], cfg, torch.bfloat16)
    nb = FUSED_BF16_LAYERS
    cut16 = {"wall": fused16["wall"][:nb], "ln1": fused16["ln1"][:nb],
             "ln2": fused16["ln2"][:nb], "fnorm": fused16["fnorm"]}
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    timing = None

    def check(out, ref, kind, **case):
        rel = kind == torch.bfloat16
        return max(_check_err("fused_decode", out[0], ref[0], FUSED_TOL[kind], rel,
                              tensor="h", **case),
                   _check_err("fused_decode", out[1], ref[1], FUSED_TOL[kind], rel,
                              tensor="kv_rows", **case))

    for lc in KERNEL_LC:
        base = dict(b=KERNEL_B, lc=lc, d=cfg.hidden_size, steps=FUSED_STEPS, start=FUSED_START)
        res, _ = _fused_chain(fused32, cfg, lc, torch.float32, g)
        worst[torch.float32] = max(worst[torch.float32], check(
            res["kernel"], res["plain"], torch.float32, layers=cfg.num_layers,
            dtype="float32", **base))
        res, _ = _fused_chain(cut16, cfg, lc, torch.bfloat16, g)
        worst[torch.bfloat16] = max(worst[torch.bfloat16], check(
            res["kernel"], res["plain"], torch.bfloat16, layers=nb, dtype="bfloat16", **base))
        g_state = g.get_state()
        res, last = _fused_chain(fused16, cfg, lc, torch.bfloat16, g, fused32)
        err = _deep_check(res, "sound", layers=cfg.num_layers, **base)
        if not err <= FUSED_BF16_DEEP_LIMIT:
            raise AssertionError(f"fused_decode bf16, {cfg.num_layers} layers, lc={lc}: error "
                                 f"against fp32 {err} > {FUSED_BF16_DEEP_LIMIT}")
        for kind in FUSED_CONTROLS if lc == KERNEL_LC[0] else ():
            g_ctl = torch.Generator(device="cuda")
            g_ctl.set_state(g_state)         # the sound run's inputs
            ctl, _ = _fused_chain(fused16, cfg, lc, torch.bfloat16, g_ctl, fused32,
                                  fault=_fused_fault(kind, fused16))
            ctl_err = _deep_check(ctl, kind, layers=cfg.num_layers, **base)
            if not ctl_err > FUSED_BF16_DEEP_LIMIT:
                raise AssertionError(f"fused_decode bf16: the planted fault {kind} read "
                                     f"{ctl_err} <= {FUSED_BF16_DEEP_LIMIT}; the check "
                                     f"cannot see it")
            del ctl
        if lc == KERNEL_LC[0]:
            x, ck, cv, rk, rv, pos, start = last
            _check_device_starts(card, "fused_decode", lambda st: fu.fused_decode_step(
                fused16, x, ck.clone(), cv.clone(), pos, st, cfg, torch.bfloat16)[0])
            timing = _timing(
                lambda: fu.fused_decode_step(fused16, x, ck, cv, pos, start, cfg, torch.bfloat16),
                lambda: fu.fused_decode_step_reference(fused16, x, rk, rv, pos, start, cfg,
                                                       torch.bfloat16), iters=10, plain_iters=3)
            wall_gb = fused16["wall"].numel() * fused16["wall"].element_size() / 1e9
            # K4 reads the wall, the norm weights and every layer's live
            # cache rows [start, pos - 1], writes one row a layer, and does
            # a multiply-add per weight and row and two per live key element
            row = KERNEL_B * cfg.num_heads * cfg.head_dim * 2
            nbytes = (sum(fused16[n].numel() * fused16[n].element_size()
                          for n in ("wall", "ln1", "ln2", "fnorm"))
                      + 2 * cfg.num_layers * (pos - start + 1) * row
                      + 2 * KERNEL_B * cfg.hidden_size * 2)
            ops = (2 * KERNEL_B * fused16["wall"].numel()
                   + 4 * cfg.num_layers * (pos - start + 1) * row // 2)
            timing.update(_bound(nbytes, ops), library_ms=None)
            _log_time("fused_decode", timing, card, b=KERNEL_B, lc=lc, start=start, pos=pos,
                      layers=cfg.num_layers)
            log("fused_decode_rate", clocks_after=repr(_clocks()), wall_gb=f"{wall_gb:.4f}",
                wall_gb_per_s=f"{wall_gb / (timing['ms'] / 1e3):.1f}",
                share_of_3350_gb_per_s=f"{wall_gb / (timing['ms'] / 1e3) / 3350:.4f}",
                card=repr(card))
        del res, last
        torch.cuda.empty_cache()
    # the lowest positions, Lc 512: fp32 through 30 layers, bf16 through one
    lc = KERNEL_LC[0]
    low = dict(b=KERNEL_B, lc=lc, d=cfg.hidden_size, steps=FUSED_LOW_STEPS, start=FUSED_START,
               pos0=FUSED_START + 1)
    for fz, dtype, layers in ((fused32, torch.float32, cfg.num_layers),
                              (cut16, torch.bfloat16, nb)):
        res, _ = _fused_chain(fz, cfg, lc, dtype, g, steps=FUSED_LOW_STEPS, pos0=FUSED_START + 1)
        worst[dtype] = max(worst[dtype], check(res["kernel"], res["plain"], dtype, layers=layers,
                                               dtype=str(dtype)[6:], **low))
        del res
    # the wider row templates (4, 8 and 16 rows; CHATTERBOX_FUSED_MAX_UTT
    # admits them above one utterance), a short chain at Lc 512
    for b, fz, dtype, layers in ((4, fused32, torch.float32, cfg.num_layers),
                                 (8, fused32, torch.float32, cfg.num_layers),
                                 (16, cut16, torch.bfloat16, nb)):
        res, last = _fused_chain(fz, cfg, KERNEL_LC[0], dtype, g, b=b, steps=FUSED_ROW_STEPS)
        worst[dtype] = max(worst[dtype], check(
            res["kernel"], res["plain"], dtype, layers=layers, dtype=str(dtype)[6:], b=b,
            lc=KERNEL_LC[0], d=cfg.hidden_size, steps=FUSED_ROW_STEPS, start=FUSED_START))
        del res, last
    del fused32, cut16
    torch.cuda.empty_cache()
    fused_times(fused16, cfg, card)
    del fused16
    torch.cuda.empty_cache()
    return {"max_abs_err": worst[torch.bfloat16], "max_abs_err_fp32": worst[torch.float32],
            "timing": timing}


def _ragged_valid(b: int, t: int, g, empty_row: bool) -> torch.Tensor:
    """Key masks: row 0 all valid, row 1 a single valid key, row 2 none
    (when `empty_row`), the rest random valid lengths."""
    lens = torch.randint(1, t + 1, (b,), generator=g, device="cuda")
    lens[0], lens[1] = t, 1
    if empty_row:
        lens[2] = 0
    return torch.arange(t, device="cuda")[None] < lens[:, None]


def _dead_tile_valid(b: int, t: int, g, empty_row: bool) -> torch.Tensor:
    """Key masks that are not prefixes, in the 64-key tiles the bf16 kernel
    walks (b >= 8): row 0 all valid, row 1 its first tiles dead, row 2 none
    (when `empty_row`; else only the last key), row 3 one valid key in every
    tile, row 4 its middle tiles dead, the rest random tiles dead and 70 %
    of the live tiles' keys valid. Every row but the empty one has a valid
    key."""
    n = -(-t // 64)
    pos = torch.arange(t, device="cuda")
    tile = pos // 64
    live = torch.rand((b, n), generator=g, device="cuda") < 0.5
    valid = (torch.rand((b, t), generator=g, device="cuda") < 0.7) & live[:, tile]
    valid[:, t - 1] |= ~valid.any(dim=1)
    valid[0] = True
    valid[1] = tile >= min(2, n - 1)
    valid[2] = False if empty_row else pos == t - 1
    valid[3] = pos % 64 == (7 * tile + 3) % 64
    valid[3, t - 1] |= ~valid[3].any()
    valid[4] = (tile < 1) | (tile >= n - 1)
    return valid


def _onehot_case(b: int, t: int, da: int, g):
    """q and k rows with a single 4 at column (5 t + 3 h) % da, v random: the
    scores are 16 where the columns meet and 0 elsewhere, so a shared-memory
    layout that disagrees with the products' descriptors moves whole keys
    (random data would only blur)."""
    pos = torch.arange(t, device="cuda")[None, :, None]
    head = torch.arange(ATT_H, device="cuda")[None, None, :]
    col = ((5 * pos + 3 * head) % da).expand(b, t, ATT_H)
    q = torch.zeros((b, t, ATT_H, da), device="cuda")
    q.scatter_(3, col[..., None], 4.0)
    k = q.roll(1, dims=1).contiguous()
    v = torch.randn((b, t, ATT_H, ATT_D), generator=g, device="cuda")
    return (x.to(torch.bfloat16) for x in (q, k, v))


def _sdpa(q, k, v, valid, scale):
    """The one PyTorch call for K2's and K3's function (timed only)."""
    sq, sk, sv = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    smask = valid[:, None, None, :]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=smask, scale=scale)


def phase_attention_check(card: str) -> dict:
    """K2 and K3 against their plain versions on the card: fp32 (the SIMT
    kernel) and bf16 (the tensor-core kernel) on ragged prefix masks, bf16 on masks with dead 64-key tiles, at T = 40 and
    on one-hot rows; then the times of the kernel and of the library's call
    on the ragged mask and on an all-valid one. Then K3b, K3's backward
    (`_attention_bwd_check`)."""
    from chatterbox_embed_tpu_torch.kernels import flash_attention as fa
    from chatterbox_embed_tpu_torch.kernels import masked_attention as ma
    from chatterbox_embed_tpu_torch.kernels import rel_attention as ra
    g = torch.Generator(device="cuda").manual_seed(4321)
    result = {}
    scale = 1.0 / ATT_D ** 0.5
    specs = [
        ("rel_attention", REL_SHAPES, REL_TIMED, REL_DA, True,
         lambda q, k, v, m: ra.rel_attention(q, k, v, m, scale),
         lambda q, k, v, m: ra.rel_attention_reference(q, k, v, m, scale)),
        ("flash_attention", FLASH_SHAPES, FLASH_TIMED, ATT_D, False,
         fa.flash_attention, fa.flash_attention_reference),
    ]
    bf16 = torch.bfloat16

    def rand(b, t, da, dtype):
        return (torch.randn((b, t, ATT_H, w), generator=g, device="cuda").to(dtype)
                for w in (da, da, ATT_D))

    for name, shapes, timed, da, empty_row, kernel, plain in specs:
        worst = {torch.float32: 0.0, bf16: 0.0}
        timing = {}

        def check(q, k, v, valid, dtype, **case):
            """The kernel against the plain version; a failure also says how
            far the plain walk of the kernel's algorithm is, to tell the
            algorithm from the kernel's layouts."""
            ref = plain(q, k, v, valid)
            out = kernel(q, k, v, valid)
            try:
                err = _check_err(name, out, ref, ATT_TOL[dtype], dtype == bf16,
                                 h=ATT_H, da=da, dtype=str(dtype)[6:], **case)
            except AssertionError as e:
                walk = ma.tiled_reference(q, k, v, valid, scale)
                raise AssertionError(
                    f"{e}; the plain tile walk is "
                    f"{(walk.float() - ref.float()).abs().max().item():.3e} from the "
                    f"plain version") from None
            worst[dtype] = max(worst[dtype], err)
            if empty_row:
                zero = out[2].float().abs().max().item()
                if zero != 0.0:
                    raise AssertionError(f"{name}: the row without a valid key "
                                         f"gave max|out|={zero}, not 0")
            return out

        # layouts first: one-hot rows, then one valid key a tile (row 3 below)
        for b, t in ((8, 128), (8, ATT_SMALL_T)):
            q, k, v = _onehot_case(b, t, da, g)
            check(q, k, v, _dead_tile_valid(b, t, g, empty_row), bf16, b=b, t=t,
                  case="onehot")
        for b, t in ATT_DEAD_SHAPES:
            q, k, v = rand(b, t, da, bf16)
            check(q, k, v, _dead_tile_valid(b, t, g, empty_row), bf16, b=b, t=t,
                  case="dead_tiles")
        for b, t in shapes:
            valid = _ragged_valid(b, t, g, empty_row)
            for dtype in (torch.float32, bf16):
                q, k, v = rand(b, t, da, dtype)
                out = check(q, k, v, valid, dtype, b=b, t=t, case="ragged")
                if dtype == bf16 and (b, t) in timed:
                    tm = _timing(lambda: kernel(q, k, v, valid), lambda: plain(q, k, v, valid),
                                 iters=20)
                    # every query row of every head against the row's valid
                    # keys: a multiply-add per q.k element and per p.v element
                    nbytes = 2 * (q.numel() + k.numel() + 2 * v.numel()) + valid.numel()
                    ops = 2 * ATT_H * t * int(valid.sum()) * (da + ATT_D)
                    tm.update(_bound(nbytes, ops))
                    sdpa = _sdpa(q, k, v, valid, scale)
                    # the all-valid row 0 (a row without a valid key is NaN there)
                    _check_err(name + "_library", sdpa()[0].permute(1, 0, 2), out[0],
                               ATT_TOL[dtype], True, b=b, t=t, call="sdpa")
                    tm["library_ms"] = _library(name, sdpa, card, b=b, t=t, da=da, call="sdpa")
                    # the same on an all-valid mask, where no tile is skipped;
                    # the fp32 kernel once
                    full = torch.ones_like(valid)
                    ops_full = 2 * ATT_H * t * b * t * (da + ATT_D)
                    tm["ms_all_valid"] = _device_ms(lambda: kernel(q, k, v, full), 20)
                    tm["library_ms_all_valid"] = _library(
                        name, _sdpa(q, k, v, full, scale), card, b=b, t=t, da=da,
                        call="sdpa_all_valid")
                    tm["bound_ms_all_valid"] = _bound(nbytes, ops_full)["bound_ms"]
                    q32, k32, v32 = (x.float() for x in (q, k, v))
                    tm["ms_fp32"] = _device_ms(lambda: kernel(q32, k32, v32, valid), 5)
                    del q32, k32, v32
                    plan = ma.plan(t, da, bf16)
                    log("attention_time", name=name, b=b, t=t, da=da, rows=plan.rows,
                        smem_bytes=plan.smem_bytes,
                        tflops=f"{ops / tm['ms'] / 1e9:.1f}",
                        tflops_all_valid=f"{ops_full / tm['ms_all_valid'] / 1e9:.1f}",
                        **{key: f"{val:.5f}" for key, val in tm.items()
                           if key.startswith(("ms_", "library_ms", "bound_ms"))},
                        card=repr(card))
                    timing[(b, t)] = tm
                    _log_time(name, tm, card, b=b, t=t, h=ATT_H, da=da)
                del q, k, v, out
        torch.cuda.empty_cache()
        result[name] = {"max_abs_err": worst[bf16],
                        "max_abs_err_fp32": worst[torch.float32],
                        "timing": timing[timed[0]]}
    result.update(_attention_bwd_check(card))
    return result


def _bwd_work(q, valid, dtype) -> dict:
    """Bounds of K3b on these inputs: (query, key) pairs with work are every
    query row of a head against its row's valid keys, and k and v are read
    at the valid keys only (an invalid key adds nothing, and its dk, dv are
    written as zeros). K3b-dq reads q, O, dO, the valid k, v and writes dq
    (and lse, di: 8 bytes a query row and head), three products a pair
    (q.k, dO.v, dS.k); K3b-dkv reads q, dO, lse, di, the valid k, v and
    writes dk, dv, four products (q.k, dO.v, P.dO, dS.q); the pair as one
    function reads q, O, dO, the valid k, v, writes dq, dk, dv, and does
    five: 10 B H T^2 D operations on an all-valid mask."""
    b, t, h, d = q.shape
    pairs = h * t * int(valid.sum())
    one = q.numel() * q.element_size()
    kv = 2 * one * valid.float().mean().item()
    scratch = 8 * b * h * t
    peak = "fp32" if dtype == torch.float32 else "bf16_tensor"
    return {"dq": _bound(4 * one + kv + scratch, 2 * 3 * pairs * d, peak),
            "dkv": _bound(4 * one + kv + scratch, 2 * 4 * pairs * d, peak),
            "pair": _bound(6 * one + kv, 2 * 5 * pairs * d, peak)}


def _lse_check(q, k, v, valid, **case):
    """K3's lse (with its output) against the plain lse: ATT_TOL, relative
    to max(1, |lse|) in bf16; +inf exactly at the rows without a valid key.
    Returns (out, lse) of the kernel."""
    from chatterbox_embed_tpu_torch.kernels import flash_attention as fa
    out, lse = fa.flash_attention_with_lse(q, k, v, valid)
    ref = fa.lse_reference(q, k, valid)
    torch.cuda.synchronize()
    empty = torch.isposinf(ref)
    if not torch.equal(torch.isposinf(lse), empty):
        raise AssertionError(f"K3 lse {case}: +inf at other rows than the plain lse's")
    _check_err("flash_attention_lse", lse[~empty], ref[~empty], ATT_TOL[q.dtype],
               q.dtype == torch.bfloat16, **case)
    return out, lse


def _bwd_case(q, k, v, valid, dout, worst: dict, **case):
    """K3b's direct call (with K3's lse) against the plain backward (with
    the plain lse) at BWD_TOL_BF16 / ATT_TOL; the gradients of a row without
    a valid key exactly 0. In bf16 also each gradient's error against the
    exact backward (the plain one in fp32 on the same bf16 values, P and dS
    not rounded), over max(|ref|, rms(ref)): a reading, held to no limit,
    kept in `worst` under "exact_<grad>". Returns (out, lse, the gradients,
    the plain ones)."""
    from chatterbox_embed_tpu_torch.kernels import flash_attention_bwd as fb
    dtype = q.dtype
    out, lse = _lse_check(q, k, v, valid, **case)
    ref = fb.flash_attention_backward_reference(q, k, v, valid, out, dout)
    got = fb.flash_attention_backward(q, k, v, valid, out, dout, lse)
    empty = ~valid.any(dim=1)
    for grad, x, r in zip(("dq", "dk", "dv"), got, ref):
        if dtype == torch.bfloat16:
            err = _check_err("flash_attention_bwd", x, r, BWD_TOL_BF16, rms_floor=True,
                             grad=grad, **case)
        else:
            err = _check_err("flash_attention_bwd", x, r, ATT_TOL[dtype], True,
                             grad=grad, **case)
        worst[dtype] = max(worst[dtype], err)
        if empty.any() and x[empty].abs().max().item() != 0.0:
            raise AssertionError(f"K3b {grad} {case}: the row without a valid key "
                                 f"has a non-zero gradient")
    if dtype == torch.bfloat16:
        exact = fb.flash_attention_backward_reference(
            *(x.float() for x in (q, k, v)), valid, out.float(), dout.float())
        for grad, x, r in zip(("dq", "dk", "dv"), got, exact):
            rms = r.pow(2).mean().sqrt().item()
            err = ((x.float() - r).abs() / r.abs().clamp_min(rms)).max().item()
            worst[f"exact_{grad}"] = max(worst.get(f"exact_{grad}", 0.0), err)
            log("kernel", name="flash_attention_bwd_vs_exact", grad=grad, **case,
                max_err_over_max_rms_ref=f"{err:.3e}", rms_ref=f"{rms:.3e}")
        del exact
    return out, lse, got, ref


def _attention_bwd_check(card: str) -> dict:
    """K3's lse against the plain lse at FLASH_SHAPES (fp32 and bf16, ragged
    masks). K3b against its plain backward on the card: bf16 on masks with
    dead 64-key tiles (ATT_DEAD_SHAPES, a row without a valid key: zero
    gradients), then at BWD_CASES, ragged (a row without a valid key) and
    all-valid; through autograd, K3's forward output equals its no-grad
    launch and the gradients equal K3b's direct call; then each kernel's
    device time and its plain version's (`reference_dq`, `reference_dkv`),
    and the pair's beside the whole plain backward's and the library's (the
    backward alone of scaled_dot_product_attention with a boolean key mask,
    which gives dq, dk and dv in one call: no PyTorch call gives one
    kernel's part alone, so each kernel's own `library_ms` is null)."""
    from chatterbox_embed_tpu_torch.kernels import flash_attention as fa
    from chatterbox_embed_tpu_torch.kernels import flash_attention_bwd as fb
    from chatterbox_embed_tpu_torch.probes import timing as tmg
    g = torch.Generator(device="cuda").manual_seed(8765)
    scale = 1.0 / ATT_D ** 0.5
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    times = {"dq": {}, "dkv": {}}
    for b, t in FLASH_SHAPES:
        valid = _ragged_valid(b, t, g, empty_row=True)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn((b, t, ATT_H, ATT_D), generator=g, device="cuda").to(dtype)
                       for _ in range(3))
            _lse_check(q, k, v, valid, b=b, t=t, dtype=str(dtype)[6:], mask="ragged")
            del q, k, v
    for b, t in ATT_DEAD_SHAPES:
        q, k, v, dout = (torch.randn((b, t, ATT_H, ATT_D), generator=g, device="cuda")
                         .to(torch.bfloat16) for _ in range(4))
        _bwd_case(q, k, v, _dead_tile_valid(b, t, g, empty_row=True), dout, worst, b=b, t=t,
                  dtype="bfloat16", mask="dead_tiles")
    for b, t, dtype in BWD_CASES:
        ragged = _ragged_valid(b, t, g, empty_row=True)
        for mask, valid in (("ragged", ragged), ("all_valid", torch.ones_like(ragged))):
            q, k, v, dout = (torch.randn((b, t, ATT_H, ATT_D), generator=g, device="cuda")
                             .to(dtype) for _ in range(4))
            case = dict(b=b, t=t, dtype=str(dtype)[6:], mask=mask)
            out, lse, got, ref = _bwd_case(q, k, v, valid, dout, worst, **case)
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            out_g = fa.flash_attention(*leaves, valid)
            if not torch.equal(out_g.detach(), out):
                raise AssertionError(f"K3 {case}: the forward under autograd differs from "
                                     f"its no-grad launch")
            out_g.backward(dout)
            for grad, x, leaf in zip(("dq", "dk", "dv"), got, leaves):
                if not torch.equal(x, leaf.grad):
                    raise AssertionError(f"K3b {grad} {case}: autograd's gradient differs "
                                         f"from the direct call")
            log("kernel", name="flash_attention_autograd", **case, forward_equal=True,
                backward_equal=True)

            def kernels():
                return fb.flash_attention_backward(q, k, v, valid, out, dout, lse)

            def plain():
                return fb.flash_attention_backward_reference(q, k, v, valid, out, dout, lse)

            di = fb.reference_dq(q, k, v, valid, out, dout, lse)[1]
            plains = {"dq": lambda: fb.reference_dq(q, k, v, valid, out, dout, lse),
                      "dkv": lambda: fb.reference_dkv(q, k, v, valid, dout, lse, di)}
            sq, sk, sv = (x.detach().permute(0, 2, 1, 3).requires_grad_(True)
                          for x in (q, k, v))
            sout = torch.nn.functional.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=valid[:, None, None, :], scale=scale)
            sgrad = dout.permute(0, 2, 1, 3)
            work = _bwd_work(q, valid, dtype)
            key = "" if (b, dtype, mask) == (4, torch.float32, "ragged") else \
                f"_{str(dtype)[6:]}_b{b}_{mask}"
            plain_ms_pair = _device_ms(plain, 5)
            library_ms = _library("flash_attention_bwd", lambda: torch.autograd.grad(
                sout, (sq, sk, sv), sgrad, retain_graph=True), card, iters=10,
                dtype=str(dtype)[6:], b=b, t=t, mask=mask, call="sdpa_backward")
            call_ms = _time_ms(kernels, 20)
            names = {"dq": "attention_bwd_dq", "dkv": "attention_bwd_dkv"}
            ms = {part: tmg.device_ms(kernels, 10, only=(name,)) for part, name in names.items()}
            ms_pair = ms["dq"] + ms["dkv"]
            for part in names:
                plain_ms = _device_ms(plains[part], 5)
                tm = times[part]
                tm["ms" + key] = ms[part]
                tm["plain_ms" + key] = plain_ms
                tm["bound_ms" + key] = work[part]["bound_ms"]
                tm["ms_pair" + key] = ms_pair
                tm["plain_ms_pair" + key] = plain_ms_pair
                tm["library_ms_pair" + key] = library_ms
                tm["bound_ms_pair" + key] = work["pair"]["bound_ms"]
                if not key:
                    tm.update({k_: v_ for k_, v_ in work[part].items() if k_ != "bound_ms"})
                    tm.update(library_ms=None, call_ms=call_ms,
                              plain_call_ms=_time_ms(plains[part], 5))
                log("attention_bwd_time", kernel=part, **case, device_ms=f"{ms[part]:.5f}",
                    plain_device_ms=f"{plain_ms:.5f}",
                    bound_ms=f"{work[part]['bound_ms']:.5f}",
                    bound_by=work[part]["bound_by"], device_ms_pair=f"{ms_pair:.5f}",
                    bound_ms_pair=f"{work['pair']['bound_ms']:.5f}",
                    bound_by_pair=work["pair"]["bound_by"],
                    plain_device_ms_pair=f"{plain_ms_pair:.5f}",
                    library_ms_pair=f"{library_ms:.5f}", call_ms_pair=f"{call_ms:.5f}",
                    tflops=f"{work[part]['bound_ops'] / ms[part] / 1e9:.2f}", card=repr(card))
            del q, k, v, dout, out, ref, got, leaves, out_g, sq, sk, sv, sout, lse, di
            torch.cuda.empty_cache()
    grads = {"dq": ("dq",), "dkv": ("dk", "dv")}
    return {f"flash_attention_bwd_{part}": {
        "max_abs_err": worst[torch.bfloat16], "max_abs_err_fp32": worst[torch.float32],
        **{f"err_vs_exact_bf16_{gr}": worst[f"exact_{gr}"] for gr in grads[part]},
        "timing": times[part]} for part in ("dq", "dkv")}


def phase_probe_check(card: str) -> dict:
    """K5 and K6 against their plain versions on the card, then their time
    at the probes' full size with bound and library time."""
    from chatterbox_embed_tpu_torch.kernels import decode_anatomy as da
    from chatterbox_embed_tpu_torch.kernels import weight_stream as ws
    from chatterbox_embed_tpu_torch.probes import decode_anatomy as pda
    from chatterbox_embed_tpu_torch.probes import weight_stream as pws
    g = torch.Generator(device="cuda").manual_seed(77)
    result = {}

    # K5: every (slab, nbuf) of the sweep on a 64 MB wall from the probe's
    # formula, then at the probe's own sizes (1 GB bf16, 0.5 GB int8), where
    # a fault of the ring that shows only on a long walk would show. The
    # group sums do not depend on how the wall is cut into slabs, so one
    # plain result serves a whole sweep. The formula repeats every 256 rows,
    # so all its slabs are equal (a stale stage would read the right values)
    # and its sums grow in step: at full size the wall is therefore random
    # (weights uniform in [-1, 1) in steps of 1/128, or in [-128, 128)), held
    # to WSTREAM_RMS's formula, and the formula's wall is held to a plain
    # fp64 result, relative to the largest sum (WSTREAM_CHAIN).
    x = torch.randn((ws.ROWS_X, ws.D), generator=g, device="cuda").to(torch.bfloat16)
    worst = {"bf16": 0.0, "int8": 0.0}

    def sweep_check(tag, sweep, flat, ref, limit, wall, relative_to=None):
        item = flat.element_size()
        for slab_mb, nbuf in sweep:
            w = flat.reshape(-1, (slab_mb << 20) // (ws.D * item), ws.D)
            out = ws.stream_once(x, w, nbuf)
            again = ws.stream_once(x, w, nbuf)
            case = dict(dtype=tag, wall=wall, wall_mb=flat.numel() * item >> 20, slab_mb=slab_mb,
                        nbuf=nbuf, products_per_sum=flat.shape[1] // ws.GROUPS * ws.D)
            if relative_to is None:
                err = _check_err("weight_stream", out, ref, limit, **case)
                worst[tag] = max(worst[tag], err)
            else:
                _check_err("weight_stream", out.double() / relative_to, ref / relative_to,
                           limit * 4 * w.shape[0], **case, largest_sum=f"{relative_to:.1f}")
            if not torch.equal(out, again):
                raise AssertionError(f"weight_stream {case}: two launches on the same inputs "
                                     f"differ")

    for dtype, tag, sweep in ((torch.bfloat16, "bf16", pws.BF16_SWEEP),
                              (torch.int8, "int8", pws.INT8_SWEEP)):
        item = 2 if tag == "bf16" else 1
        full_rows = (pws.TOTAL_MB << 20) // (ws.D * 2)        # 1 GB bf16, 0.5 GB int8
        walls = [("formula", ws.make_wall(1, (WSTREAM_CHECK_MB << 20) // (ws.D * item), dtype,
                                          "cuda"))]
        ints = torch.randint(-128, 128, (1, full_rows, ws.D), generator=g, device="cuda",
                             dtype=torch.int8)
        walls.append(("random", ints if tag == "int8" else (ints.float() / 128.0).to(dtype)))
        del ints
        for wall, flat in walls:
            n_products = flat.shape[1] // ws.GROUPS * ws.D
            limit = 2.0 ** -23 * n_products * WSTREAM_RMS if tag == "bf16" else 0.0
            sweep_check(tag, sweep, flat, ws.stream_once_reference(x, flat), limit, wall)
        del walls, flat
        torch.cuda.empty_cache()
    flat = ws.make_wall(1, (pws.TOTAL_MB << 20) // (ws.D * 2), torch.bfloat16, "cuda")
    ref = (x.double() @ flat[0].double().T).reshape(ws.ROWS_X, -1, ws.GROUPS).sum(dim=1)
    sweep_check("bf16", pws.BF16_SWEEP, flat, ref, WSTREAM_CHAIN, "formula",
                relative_to=ref.abs().max().item())
    del flat, ref
    torch.cuda.empty_cache()
    # its time on the probe's 1 GB bf16 wall at the sweep's last configuration,
    # beside the plain version and the bound (the probe phase sweeps the rest)
    slab_mb, nbuf = pws.BF16_SWEEP[-1]
    w = ws.make_wall(1, (pws.TOTAL_MB << 20) // (ws.D * 2), torch.bfloat16, "cuda").reshape(
        -1, (slab_mb << 20) // (ws.D * 2), ws.D)
    tm = _timing(lambda: ws.stream_once(x, w, nbuf), lambda: ws.stream_once_reference(x, w),
                 iters=10)
    tm.update(_bound(w.numel() * 2 + x.numel() * 2 + 4 * ws.ROWS_X * ws.GROUPS,
                     2 * ws.ROWS_X * w.numel()))
    # the library's one call for the same function: an einsum that contracts
    # the columns and sums wall row g * 128 + c into group c. It returns bf16
    # (each sum rounded once, 2^-9 relative) and may add the wall's rows in
    # another order, so it is held to 2^-6 of the largest sum.
    wg = w.view(-1, ws.GROUPS, ws.D)

    def einsum():
        return torch.einsum("ik,gck->ic", x, wg)
    out = ws.stream_once(x, w, nbuf)
    top = out.abs().max()
    _check_err("weight_stream_library", einsum().float() / top, out / top, 2.0 ** -6,
               wall_mb=pws.TOTAL_MB, call="einsum", largest_sum=f"{top.item():.1f}")
    tm["library_ms"] = _library("weight_stream", einsum, card, iters=5, wall_mb=pws.TOTAL_MB,
                                call="einsum")
    _log_time("weight_stream", tm, card, wall_mb=pws.TOTAL_MB, slab_mb=slab_mb, nbuf=nbuf)
    # the library's matmul over the same wall without the group sums (not
    # the same function: logged as the rate a library stream reaches)
    wf = w.reshape(-1, ws.D)
    _library("weight_stream_matmul_only", lambda: torch.matmul(x, wf.T), card, iters=5,
             wall_mb=pws.TOTAL_MB, call="matmul")
    del w, wf, wg, out
    torch.cuda.empty_cache()
    result["weight_stream"] = {"max_abs_err": worst["bf16"], "max_abs_err_int8": worst["int8"],
                               "timing": tm}

    # K6: three modes at pos 44 and 379 (and the chunk edges), K1's tolerances
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                   for shape in ((1, pda.F), (pda.TOTAL, pda.F), (pda.TOTAL, pda.F)))
        for mode in da.MODES:
            for pos in (0, 44, 63, 64, 379, pda.TOTAL - 1):
                ref = da.attn_reference(q, k, v, pos, mode)
                # load_only adds up to 16 rows of k + v: its sums reach ~20, where
                # one bf16 step is 2^-3, so the error is taken relative to the sum
                err = _check_err("decode_anatomy", da.attn(q, k, v, pos, mode), ref,
                                 TOL[dtype], mode == "load_only", mode=mode, pos=pos,
                                 dtype=str(dtype)[6:])
                worst[dtype] = max(worst[dtype], err)
    pos = pda.POSITIONS[-1][0]
    tm = _timing(lambda: da.attn(q, k, v, pos, "full"),
                 lambda: da.attn_reference(q, k, v, pos, "full"))
    groups = pda.F // da.HEAD_DIM
    tm.update(_bound(*_decode_work(groups, 1, da.HEAD_DIM, 0, pos, None, False)))
    sq = q.reshape(groups, 1, da.HEAD_DIM)[None]
    sk, sv = (x.reshape(pda.TOTAL, groups, da.HEAD_DIM).permute(1, 0, 2)[None] for x in (k, v))
    smask = (torch.arange(pda.TOTAL, device="cuda") <= pos)[None, None, None, :]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(sq, sk, sv, attn_mask=smask)
    _check_err("decode_anatomy_library", sdpa().reshape(1, pda.F), da.attn(q, k, v, pos, "full"),
               TOL[torch.bfloat16], pos=pos, call="sdpa")
    tm["library_ms"] = _library("decode_anatomy", sdpa, card, mode="full", pos=pos, call="sdpa")
    _log_time("decode_anatomy", tm, card, mode="full", pos=pos, groups=groups, lc=pda.TOTAL)
    result["decode_anatomy"] = {"max_abs_err": worst[torch.bfloat16],
                                "max_abs_err_fp32": worst[torch.float32], "timing": tm}
    return result


def phase_probes(card: str) -> dict:
    """The probes' own entry points, in-process at full size: the launch
    counts are set to 0 just before and read just after. One `probe` line
    per configuration."""
    from chatterbox_embed_tpu_torch.probes import decode_anatomy as pda
    from chatterbox_embed_tpu_torch.probes import weight_stream as pws
    launches = {}
    _reset_counts()
    res = pws.run(iters=10)
    launches["probe_weight_stream"] = _counts()
    for key, r in res.items():
        if isinstance(r, dict):
            log("probe", kernel="weight_stream", config=key, ms_per_pass=f"{r['ms_per_pass']:.5f}",
                gb_per_s=f"{r['GBps']:.1f}", share_of_3350_gb_per_s=f"{r['GBps'] / 3350:.4f}",
                call_ms=f"{r['call_ms']:.5f}", card=repr(card))
    best = max((r["GBps"], k) for k, r in res.items() if k.startswith("bf16"))
    log("probe", kernel="weight_stream", best_bf16=best[1], gb_per_s=f"{best[0]:.1f}",
        card=repr(card))
    _reset_counts()
    res = pda.run(steps=(1024,), device_iters=30)
    launches["probe_decode_anatomy"] = _counts()
    for mode, key in pda.SCRIPT_KEY.items():
        for _, tag in pda.POSITIONS:
            log("probe", kernel="decode_anatomy", mode=mode, script_key=f"{key}_{tag}",
                chain_us=f"{res[f'{key}_{tag}_s1024_us']:.3f}",
                device_us=f"{res[f'{key}_{tag}_device_us']:.3f}",
                cold_device_us=f"{res[f'{key}_{tag}_cold_device_us']:.3f}", card=repr(card))
    for name, path in (("weight_stream", "probe_weight_stream"),
                       ("decode_anatomy", "probe_decode_anatomy")):
        if launches[path] != _want(**{name: launches[path][name]}) or not launches[path][name]:
            raise AssertionError(f"{path}: launches {launches[path]}")
    return launches


def _random_conds(cfg, device, n_s3gen_prompt=None, seed=0):
    """Conditionals shaped like a prepared 10 s voice: speaker embedding,
    150 prompt speech tokens, 300 prompt mel frames, x-vector.
    n_s3gen_prompt shortens the S3Gen prompt (tokens and mel frames)."""
    from chatterbox_embed_tpu_torch.conditionals import Conditionals
    from chatterbox_embed_tpu_torch.models.t3 import T3Cond
    rng = np.random.default_rng(seed)
    n_prompt = cfg.t3.speech_cond_prompt_len
    n_gen = n_s3gen_prompt or n_prompt
    t3c = T3Cond(
        speaker_emb=torch.tensor(rng.standard_normal((1, cfg.t3.speaker_embed_size)),
                                 dtype=torch.float32),
        cond_prompt_speech_tokens=torch.tensor(rng.integers(0, 6561, (1, n_prompt)),
                                               dtype=torch.int32),
        emotion_adv=0.5)
    gen = dict(prompt_token=rng.integers(0, 6561, (1, n_gen)).astype(np.int64),
               prompt_token_len=np.array([n_gen], np.int64),
               prompt_feat=rng.standard_normal((1, 2 * n_gen, cfg.s3gen.mel_num)
                                               ).astype(np.float32),
               prompt_feat_len=None,
               embedding=rng.standard_normal((1, cfg.s3gen.flow.spk_embed_dim)
                                             ).astype(np.float32))
    return Conditionals(t3c, gen).to(device)


# fp32 teacher-forcing check of the decode path at full width: after the
# final RMSNorm the hidden state has unit RMS; kernel-path decode and the
# plain causal forward differ only by fp32 summation order through 30
# layers, so 1e-3 leaves ~10^4 fp32 epsilons of room.
DECODE_TOL = 1e-3


def phase_decode_consistency(tts) -> dict:
    """T3's Llama at full width in fp32: prefill a context, run decode steps
    (each attends through the flash-decode kernel against the in-place
    cache), and compare every step's hidden state with one plain causal
    forward over the same sequence (written-out attention, no cache)."""
    from chatterbox_embed_tpu_torch.models import llama
    from chatterbox_embed_tpu_torch.weights import place
    cfg = tts.cfg.t3.llama
    params = place(tts.t3_params["llama"], "cuda", torch.float32)
    g = torch.Generator(device="cuda").manual_seed(7)
    b, p_len, steps, pad = 2, 132, 8, 4
    x = torch.randn((b, p_len + steps, cfg.hidden_size), generator=g, device="cuda")
    pos = (torch.arange(p_len + steps, device="cuda") - pad).clamp_min(0)[None].expand(b, -1)
    total = 512
    with torch.no_grad():
        t = p_len + steps
        full_mask = ((torch.arange(t, device="cuda")[None] <= torch.arange(t, device="cuda")[:, None])
                     & (torch.arange(t, device="cuda")[None] >= pad))[None]
        ref, _ = llama.forward(params, x, pos, full_mask, cfg=cfg, dtype=torch.float32)
    errs = {}
    for path, kernel in (("insert_first", "flash_decode"), ("defer", "flash_decode_deferred")):
        with _env({"CHATTERBOX_DEFER_KV": "1" if path == "defer" else "0"}), torch.no_grad():
            idx = torch.arange(p_len, device="cuda")
            kidx = torch.arange(total, device="cuda")
            mask = ((kidx[None] <= idx[:, None]) & (kidx[None] >= pad))[None]
            cache = llama.init_cache(cfg, b, total, torch.float32, "cuda")
            _, cache = llama.forward(params, x[:, :p_len], pos[:, :p_len], mask, cache,
                                     0, cfg, torch.float32)
            _reset_counts()
            dec = []
            for i in range(steps):
                hh, cache = llama.forward(params, x[:, p_len + i:p_len + i + 1],
                                          pos[:, p_len + i:p_len + i + 1], cache=cache,
                                          cache_pos=p_len + i, cfg=cfg, dtype=torch.float32,
                                          flash_start=pad)
                dec.append(hh)
            if _counts() != _want(**{kernel: cfg.num_layers * steps}):
                raise AssertionError(f"{path} decode launched {_counts()}")
        torch.cuda.synchronize()
        err = (torch.cat(dec, dim=1) - ref[:, p_len:]).abs().max().item()
        if not np.isfinite(err) or err > DECODE_TOL:
            raise AssertionError(f"{path} decode through {kernel} vs plain forward: "
                                 f"max|err|={err} > {DECODE_TOL}")
        log("decode_check", path=path, kernel=kernel, layers=cfg.num_layers,
            width=cfg.hidden_size, steps=steps, dtype="float32", max_abs_err=f"{err:.3e}",
            limit=DECODE_TOL)
        errs[path] = err
    return errs


def phase_batch_consistency(tts) -> None:
    """Full width, fp32: the conformer on 8 ragged rows (through K2) against
    each row alone (1 row, factored branch), and the CFM estimator on 16 CFG
    rows (through K3) against each cond/uncond pair alone (2 rows, written-
    out attention), at valid positions."""
    from chatterbox_embed_tpu_torch.kernels import flash_attention as fa
    from chatterbox_embed_tpu_torch.kernels import rel_attention as ra
    from chatterbox_embed_tpu_torch.models import conformer, flow_decoder
    from chatterbox_embed_tpu_torch.weights import place
    flow_cfg = tts.cfg.s3gen.flow
    flow = place(tts.s3gen_params["flow"], "cuda", torch.float32)
    g = torch.Generator(device="cuda").manual_seed(11)
    u, t_tok = 8, 406
    lens = torch.tensor([406, 380, 300, 271, 250, 200, 161, 150], device="cuda")
    x = torch.randn((u, t_tok, flow_cfg.encoder.input_size), generator=g, device="cuda")
    with torch.no_grad():
        launches = ra.rel_attention.launches
        batch = conformer.forward(flow["encoder"], x, lens, flow_cfg.encoder, torch.float32)
        if ra.rel_attention.launches - launches != 10:
            raise AssertionError("the 8-row conformer did not run its 10 blocks through K2")
        err = 0.0
        for i in range(u):
            n = 2 * int(lens[i])
            solo = conformer.forward(flow["encoder"], x[i:i + 1], lens[i:i + 1],
                                     flow_cfg.encoder, torch.float32)
            err = max(err, (batch[i, :n] - solo[0, :n]).abs().max().item())
    torch.cuda.synchronize()
    if not np.isfinite(err) or err > BATCH_TOL:
        raise AssertionError(f"conformer batch vs solo: max|err|={err} > {BATCH_TOL}")
    log("batch_check", module="conformer", rows=u, t_tokens=t_tok, dtype="float32",
        max_abs_err=f"{err:.3e}", limit=BATCH_TOL)

    dec_cfg = flow_cfg.decoder
    t_mel = 2 * t_tok
    mel_lens = 2 * lens
    mask = (torch.arange(t_mel, device="cuda")[None, :, None] < mel_lens[:, None, None]).float()
    xs = torch.randn((u, t_mel, 80), generator=g, device="cuda")
    mu = torch.randn((u, t_mel, 80), generator=g, device="cuda")
    cond = torch.randn((u, t_mel, 80), generator=g, device="cuda") * mask
    spks = torch.randn((u, 80), generator=g, device="cuda")
    tt = torch.rand((u,), generator=g, device="cuda")
    zeros = torch.zeros_like

    def pair(sl):
        # rows [cond; uncond] as cfm.solve_euler lays them out
        return (torch.cat([xs[sl], xs[sl]]), torch.cat([mu[sl], zeros(mu[sl])]),
                torch.cat([tt[sl], tt[sl]]), torch.cat([spks[sl], zeros(spks[sl])]),
                torch.cat([cond[sl], zeros(cond[sl])]), torch.cat([mask[sl], mask[sl]]))

    with torch.no_grad():
        launches = fa.flash_attention.launches
        batch = flow_decoder.forward(flow["decoder"], *pair(slice(0, u)), dec_cfg, torch.float32)
        n_tblocks = (2 + dec_cfg.num_mid_blocks) * dec_cfg.n_blocks
        if fa.flash_attention.launches - launches != n_tblocks:
            raise AssertionError(f"the 16-row estimator did not run its {n_tblocks} "
                                 f"transformer blocks through K3")
        err, scale = 0.0, batch.abs().max().item()
        for i in range(u):
            solo = flow_decoder.forward(flow["decoder"], *pair(slice(i, i + 1)), dec_cfg,
                                        torch.float32)
            n = int(mel_lens[i])
            for r, s in ((i, 0), (u + i, 1)):
                err = max(err, (batch[r, :n] - solo[s, :n]).abs().max().item())
    torch.cuda.synchronize()
    if not np.isfinite(err) or err > BATCH_TOL:
        raise AssertionError(f"estimator batch vs solo: max|err|={err} > {BATCH_TOL}")
    log("batch_check", module="flow_decoder", rows=2 * u, t_mel=t_mel, dtype="float32",
        max_abs_err=f"{err:.3e}", max_abs_out=f"{scale:.3f}", limit=BATCH_TOL)
    del flow
    torch.cuda.empty_cache()


def _reset_counts() -> None:
    for _, wrapper, attr, _ in _kernels().values():
        setattr(wrapper, attr, 0)


def _counts() -> dict:
    return {name: getattr(wrapper, attr) for name, (_, wrapper, attr, _) in _kernels().items()}


def _want(**nonzero) -> dict:
    """Every kernel's expected launches: 0 except those named."""
    return {name: nonzero.get(name, 0) for name in _kernels()}


@contextlib.contextmanager
def _env(values: dict):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_generate(card: str, tts, path: str = "default", runs=("warmup", "timed")):
    """generate through the decode path `path` (GEN_PATHS): K1 on every
    layer of every step (default), K4 once a step (fused) or K1s on every
    layer of every step (defer), once per entry of `runs`. Returns
    (launches, the last run's perf)."""
    cfg = tts.cfg
    n_layers = cfg.t3.llama.num_layers
    with _env(GEN_PATHS[path]):
        for run in runs:
            _reset_counts()
            wav = tts.generate(TEXT, max_new_tokens=250, cfg_weight=0.5,
                               temperature=0.7, seed=0)
            counts = _counts()
            perf = dict(tts.perf)
            n_tok = perf["speech_tokens"]
            steps = perf["decode_steps"]
            if wav.ndim != 2 or wav.shape[0] != 1 or wav.shape[1] != 2 * n_tok * 480:
                raise AssertionError(f"wav shape {wav.shape}, want (1, {2 * n_tok * 480})")
            if not np.isfinite(wav).all():
                raise AssertionError("wav has non-finite samples")
            want = {"default": _want(flash_decode=n_layers * steps),
                    "fused": _want(fused_decode=steps),
                    "defer": _want(flash_decode_deferred=n_layers * steps)}[path]
            if counts != want or steps == 0:
                raise AssertionError(f"generate ({path}): launches {counts}, want {want}")
            if perf["use_fused"] != (path == "fused"):
                raise AssertionError(f"generate ({path}): use_fused {perf['use_fused']}")
            log("generate", path=path, run=run, tokens=n_tok, decode_steps=steps,
                launches=json.dumps({k: v for k, v in counts.items() if v}).replace(" ", ""),
                wav_samples=wav.shape[1], peak_abs=f"{float(np.abs(wav).max()):.4f}",
                t3_s=f"{perf['t3_s']:.4f}", ms_per_step=f"{1e3 * perf['t3_s'] / steps:.3f}",
                s3gen_s=f"{perf['s3gen_s']:.4f}", tokens_per_s=f"{perf['tokens_per_s']:.2f}",
                rtf=f"{perf['rtf']:.4f}", card=repr(card))
    return counts, perf


def phase_stream(card: str, tts, fused_step: bool, runs=("warmup", "timed")):
    """stream_generate of one utterance in 25-token blocks, with the fused
    step (K4 once a step) or without it (K1 on every layer of every step),
    once per entry of `runs`. Checks that the chunks are finite and join
    to 2 * tokens * 480 samples, and the launch counts. Returns (launches,
    timed perf with first_chunk_s)."""
    n_layers = tts.cfg.t3.llama.num_layers
    label = "fused_step" if fused_step else "default_step"
    with _env({"CHATTERBOX_FUSED_STEP": "1" if fused_step else "0"}):
        for run in runs:
            _reset_counts()
            chunks = list(tts.stream_generate(TEXT, **STREAM_KW))
            counts = _counts()
            perf = dict(tts.perf)
            n_tok, steps = perf["speech_tokens"], perf["decode_steps"]
            total = sum(c.size for c in chunks)
            if not chunks or total != 2 * n_tok * 480 or n_tok == 0:
                raise AssertionError(f"stream ({label}): {len(chunks)} chunks, {total} "
                                     f"samples for {n_tok} tokens")
            if not all(np.isfinite(c).all() for c in chunks):
                raise AssertionError(f"stream ({label}): non-finite samples")
            want = (_want(fused_decode=steps) if fused_step
                    else _want(flash_decode=n_layers * steps))
            if counts != want or steps == 0 or perf["use_fused"] != fused_step:
                raise AssertionError(f"stream ({label}): launches {counts}, want {want}, "
                                     f"use_fused {perf['use_fused']}")
            log("stream_generate", step=label, run=run, tokens=n_tok, decode_steps=steps,
                chunks=len(chunks), first_chunk_samples=chunks[0].size,
                launches=json.dumps({k: v for k, v in counts.items() if v}).replace(" ", ""),
                first_chunk_s=f"{perf['first_chunk_s']:.4f}", total_s=f"{perf['total_s']:.4f}",
                audio_s=f"{perf['audio_s']:.3f}", rtf=f"{perf['total_s'] / perf['audio_s']:.4f}",
                card=repr(card))
    return counts, perf


@contextlib.contextmanager
def _patched(obj, name: str, value):
    """obj.name = value for the block, then the old value again."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _stream_run(tts, text: str, **kw):
    """One stream_generate with the counts set to 0 just before it: (chunks,
    the speech tokens in the order the windowed loop took them (those the
    first chunk seeded it with first), perf, launches)."""
    from chatterbox_embed_tpu_torch import streaming
    got = []
    feed, seed = streaming.WindowedSynth.feed, streaming.WindowedSynth.seed_from_fused

    def feed_spy(self, block):
        b = np.asarray(block).reshape(-1)
        got.append(b[b < 6561])
        return feed(self, block)

    def seed_spy(self, valid, *a):
        got.append(np.asarray(valid))
        return seed(self, valid, *a)

    with _patched(streaming.WindowedSynth, "feed", feed_spy), \
            _patched(streaming.WindowedSynth, "seed_from_fused", seed_spy):
        _reset_counts()
        chunks = list(tts.stream_generate(text, **kw))
        counts = _counts()
    return chunks, np.concatenate(got), dict(tts.perf), counts


def _same_stream(label: str, want, got) -> float:
    """Two streams' (chunks, tokens): the tokens equal (unless both are
    None), the chunks of equal lengths within ROUTE_TOL. Returns the
    largest chunk difference."""
    (wc, wt), (gc, gt) = want, got
    if wt is not None and not np.array_equal(wt, gt):
        raise AssertionError(f"{label}: tokens differ ({wt.size} against {gt.size})")
    if [c.shape for c in wc] != [c.shape for c in gc]:
        raise AssertionError(f"{label}: chunks {[c.shape for c in gc]}, want "
                             f"{[c.shape for c in wc]}")
    for a, b in zip(gc, wc):
        np.testing.assert_allclose(a, b, err_msg=label, **ROUTE_TOL)
    return max(float(np.abs(a - b).max()) for a, b in zip(gc, wc))


def _first_chunk_s(tts, text: str, **kw) -> float:
    """Seconds from asking a stream for its first chunk to that chunk in host
    memory (the generator is then closed)."""
    t0 = time.time()
    it = tts.stream_generate(text, **kw)
    first = next(it)
    seconds = time.time() - t0
    it.close()
    if first.size == 0 or not np.isfinite(first).all():
        raise AssertionError("first chunk empty or not finite")
    return seconds


def _graph_facts(entry, card: str, label: str) -> dict:
    """A captured first-chunk graph: the launches a replay counts, the
    bytes its capture reserved, one replay's time (CUDA events, its inputs
    in place) and the device records of one replay under torch.profiler
    (kernels, and memsets / copies), which the profiler may not see inside
    a graph: then "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from chatterbox_embed_tpu_torch.probes import timing
    replay_ms = timing.time_ms(entry.graph.replay, iters=10, warmup=2)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        entry.graph.replay()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [n for n in names if not n.startswith(("Memset", "Memcpy", "Memory"))]
    facts = {"launches_a_replay": {f"{fn.__name__}.{attr}": n
                                   for (fn, attr), n in entry.launches.items()},
             "pool_bytes": entry.pool_bytes, "replay_ms": replay_ms,
             "kernels": len(kernels) if names else "not measured",
             "memsets_copies": len(names) - len(kernels) if names else "not measured"}
    log("first_chunk_graph", step=label, replay_ms=f"{replay_ms:.3f}",
        kernels=facts["kernels"], memsets_copies=facts["memsets_copies"],
        pool_bytes=entry.pool_bytes,
        launches=json.dumps(facts["launches_a_replay"]).replace(" ", ""), card=repr(card))
    return facts


def phase_first_chunk(card: str, tts) -> dict:
    """The stream's first chunk as one CUDA graph per text bucket
    (streaming.first_chunk), on the default step, with K4 and under
    CHATTERBOX_DEFER_KV=1 (K1s): the smoke's stream (TEXT, STREAM_KW at
    FIRST_CHUNK_TOKENS tokens) on the per-block route
    (CHATTERBOX_FUSED_FIRST_CHUNK=0), then on the graph route from a new
    graph cache (the first request captures; on the default step and with
    K4 a second replays), each route counting 30 K1 (K1s) launches a
    decode step (K4: one), the graph's 25 steps included, and the graph
    route holding the per-block route's tokens and chunks (ROUTE_TOL). On
    the default step and with K4: the graph's replay time, kernels and
    pool bytes, and FIRST_CHUNK_RUNS first chunks of each route at
    STREAM_KW timed in turns. With K4: a request of another length in the
    bucket and other sampling values (FIRST_CHUNK_TEXT2,
    FIRST_CHUNK_SAMPLING2) replays the graph, captures nothing and equals
    its per-block route; two streams advanced in turns equal each run
    alone. Last, a host read planted in a capture must fail the request.
    Returns {path: launches}."""
    from chatterbox_embed_tpu_torch import streaming
    n_layers = tts.cfg.t3.llama.num_layers
    streaming.GRAPHS.clear()
    torch.cuda.empty_cache()
    launches, alone, graphs = {}, {}, {}
    kw = dict(STREAM_KW, max_new_tokens=FIRST_CHUNK_TOKENS)
    kw2 = dict(kw, seed=1, **FIRST_CHUNK_SAMPLING2)
    block = STREAM_KW["block_tokens"]
    # (label, settings, the kernel and its launches a decode step, runs)
    steps_of = (("default_step", {"CHATTERBOX_FUSED_STEP": "0"}, "flash_decode", n_layers,
                 ("capture", "replay")),
                ("fused_step", {"CHATTERBOX_FUSED_STEP": "1"}, "fused_decode", 1,
                 ("capture", "replay")),
                ("deferred", {"CHATTERBOX_FUSED_STEP": "0", "CHATTERBOX_DEFER_KV": "1"},
                 "flash_decode_deferred", n_layers, ("capture",)))
    for label, env, kernel, per_step, graph_runs in steps_of:
        with _env(env):
            with _env({"CHATTERBOX_FUSED_FIRST_CHUNK": "0"}):
                plain = _stream_run(tts, TEXT, **kw)
            want = _want(**{kernel: per_step * plain[2]["decode_steps"]})
            if (plain[3] != want or plain[2]["first_chunk_graph"] is not None
                    or plain[2]["decode_steps"] == 0):
                raise AssertionError(f"first_chunk ({label}, per-block route): launches "
                                     f"{plain[3]}, want {want}, route "
                                     f"{plain[2]['first_chunk_graph']}")
            runs = []
            for run in graph_runs:
                n_graphs = len(streaming.GRAPHS)
                chunks, tokens, perf, counts = _stream_run(tts, TEXT, **kw)
                steps = perf["decode_steps"]
                want = _want(**{kernel: per_step * steps})
                route = {"capture": "captured", "replay": "replayed"}[run]
                if (perf["first_chunk_graph"] != route or counts != want
                        or len(streaming.GRAPHS) != n_graphs + (run == "capture")):
                    raise AssertionError(f"first_chunk ({label}, {run}): route "
                                         f"{perf['first_chunk_graph']}, launches {counts}, "
                                         f"want {want}, graphs {len(streaming.GRAPHS)}")
                diff = _same_stream(f"first_chunk ({label}, {run})", plain[:2],
                                    (chunks, tokens))
                runs.append(perf)
                log("first_chunk", step=label, run=run, tokens=perf["speech_tokens"],
                    decode_steps=steps, chunks=len(chunks), max_chunk_diff=f"{diff:.3e}",
                    launches=json.dumps({k: v for k, v in counts.items() if v}).replace(" ", ""),
                    first_chunk_s=f"{perf['first_chunk_s']:.4f}", total_s=f"{perf['total_s']:.4f}",
                    per_block_first_chunk_s=f"{plain[2]['first_chunk_s']:.4f}",
                    per_block_launches=json.dumps(
                        {k: v for k, v in plain[3].items() if v}).replace(" ", ""),
                    card=repr(card))
            alone[label] = (chunks, tokens)
            launches[f"first_chunk_{label}"] = counts
            entry = graphs[label] = list(streaming.GRAPHS.values())[-1]
            _, wrapper, attr, _ = _kernels()[kernel]
            if entry.launches != {(wrapper, attr): per_step * block}:
                raise AssertionError(f"first_chunk ({label}): the graph holds {entry.launches}")
            if label == "deferred":
                continue
            _graph_facts(entry, card, label)
            # first chunks in turns: per-block, graph, graph, per-block, ...
            times = {"per_block": [], "graph": []}
            for r in range(FIRST_CHUNK_RUNS):
                for route in (("per_block", "graph") if r % 2 == 0 else ("graph", "per_block")):
                    with _env({"CHATTERBOX_FUSED_FIRST_CHUNK": "0" if route == "per_block"
                               else "1"}):
                        times[route].append(_first_chunk_s(tts, TEXT, **STREAM_KW))
            log("first_chunk_time", step=label,
                graph_s=",".join(f"{t:.4f}" for t in times["graph"]),
                per_block_s=",".join(f"{t:.4f}" for t in times["per_block"]),
                capture_request_s=f"{runs[0]['first_chunk_s']:.4f}", card=repr(card))

    with _env({"CHATTERBOX_FUSED_STEP": "1"}):
        # another text length of the bucket and other sampling values: no
        # capture, one replay
        with _env({"CHATTERBOX_FUSED_FIRST_CHUNK": "0"}):
            plain2 = _stream_run(tts, FIRST_CHUNK_TEXT2, **kw2)
        entry = graphs["fused_step"]
        n_graphs, replays = len(streaming.GRAPHS), entry.replays
        chunks2, tokens2, perf2, _ = _stream_run(tts, FIRST_CHUNK_TEXT2, **kw2)
        if (perf2["first_chunk_graph"] != "replayed" or len(streaming.GRAPHS) != n_graphs
                or entry.replays != replays + 1):
            raise AssertionError(f"first_chunk (second length): route "
                                 f"{perf2['first_chunk_graph']}, graphs "
                                 f"{len(streaming.GRAPHS)} (was {n_graphs}), replays "
                                 f"{entry.replays} (was {replays})")
        diff2 = _same_stream("first_chunk (second length)", plain2[:2], (chunks2, tokens2))
        # two streams of the bucket advanced in turns, each against itself alone
        live = {"a": tts.stream_generate(TEXT, **kw),
                "b": tts.stream_generate(FIRST_CHUNK_TEXT2, **kw2)}
        got = {"a": [], "b": []}
        while live:
            for name in list(live):
                c = next(live[name], None)
                if c is None:
                    del live[name]
                else:
                    got[name].append(c)
        diffs = [_same_stream(f"first_chunk (interleaved {name})", (want, None), (got[name], None))
                 for name, want in (("a", alone["fused_step"][0]), ("b", chunks2))]
        log("first_chunk_bucket", text_tokens=len(tts.tokenizer.text_to_tokens(
            FIRST_CHUNK_TEXT2)[0]) + 2, sampling=json.dumps(FIRST_CHUNK_SAMPLING2).replace(" ", ""),
            tokens=perf2["speech_tokens"], graphs=len(streaming.GRAPHS),
            replays=entry.replays, max_chunk_diff=f"{diff2:.3e}",
            interleaved_max_diff=f"{max(diffs):.3e}", card=repr(card))
        _planted_capture_fault(tts)
    return launches


def _planted_capture_fault(tts) -> None:
    """A host read planted in the first-chunk body while it is being
    captured (the capture refuses it) must fail the request: no route
    carries on eagerly. The request asks for a new key (block 20), so the
    graphs above stay."""
    from chatterbox_embed_tpu_torch import streaming
    body = streaming._first_chunk_body

    def faulty(*a, **k):
        out = body(*a, **k)
        if torch.cuda.is_current_stream_capturing():
            int(out.n_new)
        return out

    n_graphs = len(streaming.GRAPHS)
    with _patched(streaming, "_first_chunk_body", faulty):
        try:
            next(iter(tts.stream_generate(TEXT, **dict(STREAM_KW, block_tokens=20))))
        except RuntimeError as e:
            caught = f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"
        else:
            raise AssertionError("the planted capture fault did not fail the first chunk")
    torch.cuda.synchronize()
    if len(streaming.GRAPHS) != n_graphs:
        raise AssertionError("a failed capture left a graph behind")
    log("first_chunk_fault", planted="host read inside the capture", raised=repr(caught))


def phase_generate_batch(card: str, tts, conds, label: str, runs=("warmup", "timed")) -> dict:
    """generate_batch on the 8 texts with `conds` (one voice or a list), once
    per entry of `runs`; checks each wav and the launch counts of the path."""
    cfg = tts.cfg
    n_layers = cfg.t3.llama.num_layers
    for run in runs:
        _reset_counts()
        wavs = tts.generate_batch(TEXTS, conds=conds, **BATCH_KW)
        counts = _counts()
        perf = dict(tts.perf)
        if len(wavs) != len(TEXTS):
            raise AssertionError(f"{len(wavs)} wavs for {len(TEXTS)} texts")
        for i, (w, n) in enumerate(zip(wavs, perf["row_tokens"])):
            if w.ndim != 1 or w.shape[0] != 2 * n * 480 or n == 0:
                raise AssertionError(f"row {i}: wav shape {w.shape}, want ({2 * n * 480},)")
            if not np.isfinite(w).all():
                raise AssertionError(f"row {i}: wav has non-finite samples")
        steps, dispatches = perf["decode_steps"], perf["s3gen_dispatches"]
        fresh, reused = _cfm_steps(cfg, perf["cfm_cache_every"])
        want = _want(flash_decode=n_layers * steps, **_s3gen_launches(cfg, perf))
        if counts != want or steps == 0:
            raise AssertionError(f"{label}: launches {counts}, want {want}")
        if perf["s3gen_sub_batch"] != BATCH_SUB or perf["cfm_cache_every"] != BATCH_STRIDE:
            raise AssertionError(f"{label}: sub-batch {perf['s3gen_sub_batch']}, stride "
                                 f"{perf['cfm_cache_every']}; want {BATCH_SUB}, {BATCH_STRIDE}")
        log("generate_batch", voices=label, run=run, utterances=len(wavs),
            tokens=perf["speech_tokens"], row_tokens=",".join(map(str, perf["row_tokens"])),
            decode_steps=steps, decode_sub_batches=perf["decode_sub_batches"],
            s3gen_sub_batch=perf["s3gen_sub_batch"], s3gen_dispatches=dispatches,
            cfm_stride=perf["cfm_cache_every"], cfm_fresh_steps=fresh,
            cfm_reused_steps=reused, launches=json.dumps(counts).replace(" ", ""),
            t3_s=f"{perf['t3_s']:.4f}", s3gen_s=f"{perf['s3gen_s']:.4f}",
            tokens_per_s=f"{perf['tokens_per_s']:.2f}", audio_s=f"{perf['audio_s']:.3f}",
            batch_rtf=f"{perf['rtf']:.4f}", card=repr(card))
    return counts


def _voice(seed: int, seconds: float, sr: int) -> np.ndarray:
    """A synthetic voice from a numpy seed: six harmonics of a drifting
    pitch under a syllable-rate amplitude envelope with quiet edges, plus
    low noise, so that the silence trim and the mels have something to work
    on."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = 110.0 + 30.0 * rng.random() + 12.0 * np.sin(2 * np.pi * 0.6 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(k * phase + rng.random() * 6.28) / k for k in range(1, 7))
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 2.3 * t)
    env[: n // 25] *= 0.002
    env[-n // 30:] *= 0.002
    return (0.18 * x * env + 0.003 * rng.standard_normal(n)).astype(np.float32)


def _token_margins(tts, wav16: np.ndarray, max_len=None) -> np.ndarray:
    """(T,) distance of each token frame's nearest pre-rounding value from
    a rounding boundary (+-0.5), computed on the card."""
    from chatterbox_embed_tpu_torch.models import s3tokenizer as tok
    from chatterbox_embed_tpu_torch.ops import mel as mel_ops
    cfg = tts.cfg.s3gen.tokenizer
    wavp = torch.from_numpy(tok.pad_to_token_multiple(wav16)[None]).to(tts.device)
    mels = mel_ops.log_mel_s3tokenizer(wavp, n_fft=cfg.n_fft, hop=cfg.hop, n_mels=cfg.n_mels)
    if max_len is not None:
        mels = mels[..., : 4 * max_len]
    lens = torch.tensor([mels.shape[-1]], device=tts.device)
    h, _ = tok.encode(tts.s3gen_params["tokenizer"], mels, lens, cfg)
    pre = tok.fsq_pre_round(tts.s3gen_params["tokenizer"], h)
    return (pre.abs() - 0.5).abs().amin(dim=-1)[0].cpu().numpy()


def _assert_tokens_match(name: str, card_tok, cpu_tok, margins: np.ndarray) -> None:
    card_tok, cpu_tok = (np.asarray(a).reshape(-1) for a in (card_tok, cpu_tok))
    n = card_tok.size
    if cpu_tok.size != n or margins.size < n:
        raise AssertionError(f"{name}: {n} tokens on the card, {cpu_tok.size} on the CPU")
    unsafe = margins[:n] <= COND_TOKEN_MARGIN
    differ = card_tok != cpu_tok
    if (differ & ~unsafe).any() or unsafe.mean() > COND_UNSAFE_SHARE:
        raise AssertionError(f"{name}: {int((differ & ~unsafe).sum())} tokens differ away from "
                             f"a rounding boundary; {int(unsafe.sum())} of {n} frames lie "
                             f"within {COND_TOKEN_MARGIN} of one")
    log("conditioning_check", tensor=name, tokens=n, differ=int(differ.sum()),
        frames_near_boundary=int(unsafe.sum()), margin=COND_TOKEN_MARGIN,
        min_margin=f"{float(margins[:n].min()):.3e}")


def phase_conditioning(card: str, tts) -> dict:
    """Voice conditioning from reference audio at full width, then
    generate, the voice-profile route, the conditional cache, ChatterboxVC,
    and the card's conditionals against the port's CPU run (see the module
    docstring). Returns the K1 launches of the audio-prompt generate."""
    from chatterbox_embed_tpu_torch.tts import ChatterboxTTS
    from chatterbox_embed_tpu_torch.utils import audio_io
    from chatterbox_embed_tpu_torch.vc import ChatterboxVC
    cfg = tts.cfg
    n_layers = cfg.t3.llama.num_layers
    tmp = tempfile.mkdtemp(prefix="cbx_smoke_")
    try:
        ref, src, prof = (os.path.join(tmp, n) for n in ("ref.wav", "src.wav", "voice.npy"))
        audio_io.write_wav(ref, _voice(1, COND_REF_S, 24_000), 24_000)
        audio_io.write_wav(src, _voice(2, COND_SRC_S, 16_000), 16_000)

        # prepare from audio: cold (first use of every encoder), then warm
        for run in ("cold", "warm"):
            tts.conds = None
            torch.cuda.synchronize()
            t0 = time.time()
            parts = {}
            tts.prepare_conditionals_with_audio_prompt(ref, exaggeration=0.5, timings=parts)
            torch.cuda.synchronize()
            log("conditioning", run=run, prompt_s=COND_REF_S, total_s=f"{time.time() - t0:.4f}",
                **{k: f"{v:.4f}" for k, v in sorted(parts.items())}, card=repr(card))
        audio = tts.conds
        n_tok = COND_REF_S * 25
        plen = cfg.t3.speech_cond_prompt_len
        want = {"embedding": (1, cfg.s3gen.flow.spk_embed_dim), "prompt_token": (1, n_tok),
                "prompt_token_len": (1,), "prompt_feat": (1, 2 * n_tok, cfg.s3gen.mel_num)}
        for k, shape in want.items():
            a = np.asarray(audio.gen[k])
            if a.shape != shape or not np.isfinite(a).all():
                raise AssertionError(f"conditioning: {k} {a.shape}, want {shape}, all finite")
        if audio.gen["prompt_feat_len"] is not None or int(audio.gen["prompt_token_len"][0]) != n_tok:
            raise AssertionError("conditioning: prompt_feat_len / prompt_token_len")
        spk, ptok = audio.t3.speaker_emb, audio.t3.cond_prompt_speech_tokens
        if (tuple(spk.shape) != (1, cfg.t3.speaker_embed_size) or tuple(ptok.shape) != (1, plen)
                or not bool(torch.isfinite(spk).all()) or int(ptok.max()) >= 6561
                or int(ptok.min()) < 0 or abs(float(spk.norm()) - 1.0) > 1e-3):
            raise AssertionError(f"conditioning: T3 cond {tuple(spk.shape)} {tuple(ptok.shape)}")
        log("conditioning_shapes", embedding=want["embedding"], prompt_feat=want["prompt_feat"],
            prompt_token=want["prompt_token"], speaker_emb=tuple(spk.shape),
            t3_prompt_tokens=tuple(ptok.shape), distinct_tokens=len(np.unique(audio.gen["prompt_token"])))

        def generate(**voice):
            tts.conds = None
            _reset_counts()
            wav = tts.generate(TEXT, max_new_tokens=COND_NEW_TOKENS, cfg_weight=0.5,
                               temperature=0.7, seed=0, **voice)
            counts, perf = _counts(), dict(tts.perf)
            n, steps = perf["speech_tokens"], perf["decode_steps"]
            if wav.shape != (1, 2 * n * 480) or n == 0 or not np.isfinite(wav).all():
                raise AssertionError(f"conditioning generate {list(voice)}: wav {wav.shape}, "
                                     f"{n} tokens")
            if counts != _want(flash_decode=n_layers * steps) or steps == 0:
                raise AssertionError(f"conditioning generate {list(voice)}: launches {counts}")
            log("conditioning_generate", voice=",".join(voice), tokens=n, decode_steps=steps,
                launches=json.dumps({k: v for k, v in counts.items() if v}).replace(" ", ""),
                wav_samples=wav.shape[1], t3_s=f"{perf['t3_s']:.4f}",
                s3gen_s=f"{perf['s3gen_s']:.4f}", card=repr(card))
            return counts

        counts = generate(audio_prompt_path=ref, exaggeration=0.5)
        from_audio = tts.conds

        # the voice-profile route gives the same voice: the S3Gen reference
        # and the speaker embedding are equal arrays. Its T3 prompt tokens are
        # the first `plen` of the 10 s prompt's tokens, where the audio route
        # tokenizes the first 6 s on their own (as in the JAX package), so
        # those are compared with the reference dict, not across routes.
        tts.save_voice_profile(ref, prof)
        tts.clear_conditional_cache()
        generate(voice_profile_path=prof, exaggeration=0.5)
        from_profile = tts.conds
        for k in ("embedding", "prompt_token", "prompt_token_len", "prompt_feat"):
            if not np.array_equal(np.asarray(from_profile.gen[k]), np.asarray(from_audio.gen[k])):
                raise AssertionError(f"conditioning: the profile route's {k} differs from the "
                                     f"audio route's")
        if not torch.equal(from_profile.t3.speaker_emb, from_audio.t3.speaker_emb):
            raise AssertionError("conditioning: the profile route's speaker_emb differs")
        if not np.array_equal(from_profile.t3.cond_prompt_speech_tokens.cpu().numpy(),
                              np.asarray(from_audio.gen["prompt_token"])[:, :plen]):
            raise AssertionError("conditioning: the profile route's T3 prompt tokens")
        same = int((from_profile.t3.cond_prompt_speech_tokens
                    == from_audio.t3.cond_prompt_speech_tokens).sum())
        tts.clear_conditional_cache()
        before = tts.get_conditional_cache_stats()
        first = tts._get_or_prepare_conditionals(voice_profile_path=prof)
        second = tts._get_or_prepare_conditionals(voice_profile_path=prof)
        stats = tts.get_conditional_cache_stats()
        if (second is not first or stats["hits"] != before["hits"] + 1
                or stats["misses"] != before["misses"] + 1 or stats["cache_size"] != 1):
            raise AssertionError(f"conditioning: cache stats {before} -> {stats}")
        log("conditioning_profile", gen_equal=True, speaker_emb_equal=True,
            t3_prompt_tokens_equal_across_routes=f"{same}/{plen}", cache_hits=stats["hits"],
            cache_misses=stats["misses"], profile_bytes=os.path.getsize(prof))

        # voice conversion of the 6 s source into the reference voice
        vc = ChatterboxVC(tts.s3gen_params, tts.t3_params, tts.ve_params, tts.tokenizer,
                          config=cfg, dtype=tts.dtype, device=tts.device)
        vc.set_target_voice(ref)
        for run in ("warmup", "timed"):
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            wav = vc.generate(src, seed=0)
            vc_s = time.time() - t0
            n_src = COND_SRC_S * 25
            if wav.shape != (1, 2 * n_src * 480) or not np.isfinite(wav).all():
                raise AssertionError(f"vc: wav {wav.shape}, want (1, {2 * n_src * 480})")
            if _counts() != _want():
                raise AssertionError(f"vc: launches {_counts()} (one row stays below the "
                                     f"K2 / K3 gates)")
            log("vc", run=run, source_s=COND_SRC_S, tokens=n_src, wav_samples=wav.shape[1],
                seconds=f"{vc_s:.4f}", seconds_per_source_second=f"{vc_s / COND_SRC_S:.4f}",
                peak_abs=f"{float(np.abs(wav).max()):.4f}", card=repr(card))

        # the card against the port's CPU run: the same wavs, the same
        # conditioning weights, fp32, asked for with device="cpu"
        cpu = ChatterboxTTS(
            {}, {"flow": {"input_embedding": tts.s3gen_params["flow"]["input_embedding"]},
                 "speaker_encoder": tts.s3gen_params["speaker_encoder"],
                 "tokenizer": tts.s3gen_params["tokenizer"]},
            tts.tokenizer, config=cfg, dtype=torch.float32, device="cpu", ve_params=tts.ve_params)
        t0 = time.time()
        cpu_gen = cpu._build_ref_dict(ref)
        cpu_t3 = cpu._build_t3_cond(ref, 0.5)
        cpu_s = time.time() - t0
        for k in ("prompt_feat", "embedding"):
            _check_err("conditioning_vs_cpu", torch.from_numpy(np.asarray(from_audio.gen[k])),
                       torch.from_numpy(cpu_gen[k]), COND_TOL[k], k == "embedding", tensor=k)
        _check_err("conditioning_vs_cpu", from_audio.t3.speaker_emb.cpu(), cpu_t3.speaker_emb,
                   COND_TOL["speaker_emb"], tensor="speaker_emb")
        wav16, _ = audio_io.load_audio(ref, sr=16_000, device=tts.device)
        _assert_tokens_match("prompt_token", from_audio.gen["prompt_token"],
                             cpu_gen["prompt_token"], _token_margins(tts, wav16))
        _assert_tokens_match("t3_prompt_tokens", from_audio.t3.cond_prompt_speech_tokens.cpu(),
                             cpu_t3.cond_prompt_speech_tokens,
                             _token_margins(tts, wav16[: tts.ENC_COND_LEN], plen))
        log("conditioning_cpu", seconds=f"{cpu_s:.2f}", threads=torch.get_num_threads())
        del vc, cpu
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tts.conds = None
    tts.clear_conditional_cache()
    torch.cuda.empty_cache()
    return counts


def _cfm_steps(cfg, stride: int):
    """(fresh, reused) Euler steps of the CFM solver at DeepCache stride
    `stride` (cfm.solve_euler's rule: no reuse below a stride of 2)."""
    from chatterbox_embed_tpu_torch.models.cfm import reuse_flags
    n_steps = cfg.s3gen.flow.cfm.n_timesteps
    flags = (reuse_flags(n_steps, stride) if stride >= 2 and n_steps > 2
             else [False] * n_steps)
    return n_steps - sum(flags), sum(flags)


def _s3gen_launches(cfg, perf: dict) -> dict:
    """K2's and K3's launches of the S3Gen dispatches that `perf` (a
    generate_batch's) records: every conformer block once a dispatch, and
    every CFM transformer block once a fresh Euler step and the two outer
    ones once a reused step."""
    n_blocks = cfg.s3gen.flow.encoder.num_blocks + cfg.s3gen.flow.encoder.num_up_blocks
    dec = cfg.s3gen.flow.decoder
    fresh, reused = _cfm_steps(cfg, perf["cfm_cache_every"])
    dispatches = perf["s3gen_dispatches"]
    return dict(rel_attention=n_blocks * dispatches,
                flash_attention=dispatches * ((2 + dec.num_mid_blocks) * dec.n_blocks * fresh
                                              + 2 * dec.n_blocks * reused))


def _long_perf(meta: dict) -> dict:
    perf = meta["perf"]
    return dict(t3_s=f"{perf['t3_s']:.4f}", s3gen_s=f"{perf['s3gen_s']:.4f}",
                audio_s=f"{perf['audio_s']:.3f}", rtf=f"{perf['rtf']:.4f}",
                generation_time_s=f"{meta['generation_time_s']:.4f}",
                audio_ratio=f"{meta['audio_ratio']:.4f}")


def _check_story(label: str, wav, meta: dict, row_tokens) -> None:
    """Every chunk accepted at its pooled take, each segment 2 * tokens *
    480 samples (no chunk filled with silence), the stitched wav finite
    and within [-1, 1]."""
    stats = meta["chunk_stats"]
    attempts = [c["attempts"] for c in stats["chunks"]]
    samples = [c["samples"] for c in stats["chunks"]]
    if (not stats["batched_first_pass"] or set(attempts) != {1} or stats["regenerations"]
            or meta["num_chunks"] != LONG_CHUNKS):
        raise AssertionError(f"{label}: {meta['num_chunks']} chunks, batched "
                             f"{stats['batched_first_pass']}, attempts {attempts}")
    if samples != [2 * n * 480 for n in row_tokens] or 0 in row_tokens:
        raise AssertionError(f"{label}: segment samples {samples} for tokens {row_tokens}")
    if wav.ndim != 2 or wav.shape[0] != 1 or not np.isfinite(wav).all() \
            or float(np.abs(wav).max()) > 1.0:
        raise AssertionError(f"{label}: stitched wav {wav.shape}, finite "
                             f"{bool(np.isfinite(wav).all())}, peak {np.abs(wav).max()}")


def phase_long_text(card: str, tts) -> dict:
    """Long text at full width (see the module docstring): warmup, (a) one
    story through generate_long_text, (b) two stories with two voices
    through one pooled generate_long_text_batch, (c) the 8 texts under the
    alignment guard. Returns the launches of (a), (b) and (c)."""
    from chatterbox_embed_tpu_torch.utils import audio_io
    from chatterbox_embed_tpu_torch.utils.watermark import ImplicitWatermarker
    cfg = tts.cfg
    n_layers = cfg.t3.llama.num_layers
    launches = {}
    tmp = tempfile.mkdtemp(prefix="cbx_smoke_long_")
    try:
        profiles = []
        for seed in (1, 3):
            ref, prof = (os.path.join(tmp, f"{n}{seed}.{ext}")
                         for n, ext in (("ref", "wav"), ("voice", "npy")))
            audio_io.write_wav(ref, _voice(seed, COND_REF_S, 24_000), 24_000)
            tts.save_voice_profile(ref, prof)
            profiles.append(prof)

        tts.conds = None
        tts.clear_conditional_cache()
        with _env({"CHATTERBOX_FUSED_STEP": "1"}):
            stages = tts.warmup(batch_sizes=(1, LONG_CHUNKS), max_new_tokens=20,
                                token_buckets=(256,), stream=True)
        if tts.conds is not None or set(stages) != {
                "kernels_s", "fused_wall_s", "conditionals_s", "batch1_s",
                f"batch{LONG_CHUNKS}_s", "tokens256_s", "stream_first_chunk_s"}:
            raise AssertionError(f"warmup: stages {sorted(stages)}, conds {tts.conds}")
        log("warmup", **{k: f"{v:.4f}" for k, v in stages.items()}, card=repr(card))

        # (a) one story, one voice
        _reset_counts()
        wav, meta = tts.generate_long_text(LONG_STORIES[0], voice_profile_path=profiles[0],
                                           **LONG_KW)
        counts, perf = _counts(), dict(tts.perf)      # perf: the pooled generate_batch's
        _check_story("long_text", wav, meta, perf["row_tokens"])
        want = _want(flash_decode=n_layers * perf["decode_steps"], **_s3gen_launches(cfg, perf))
        if counts != want or perf["s3gen_dispatches"] != 1:
            raise AssertionError(f"long_text: launches {counts}, want {want}")
        log("long_text", chunks=meta["num_chunks"], row_tokens=",".join(
            map(str, perf["row_tokens"])), decode_steps=perf["decode_steps"],
            s3gen_dispatches=perf["s3gen_dispatches"], duration_s=f"{meta['duration_s']:.3f}",
            peak_abs=f"{float(np.abs(wav).max()):.4f}",
            watermark=f"{ImplicitWatermarker().get_watermark(wav[0], tts.sr):.4f}",
            launches=json.dumps({k: v for k, v in counts.items() if v}).replace(" ", ""),
            **_long_perf(meta), card=repr(card))
        launches["long_text"] = counts

        # (b) two stories, two voices, one pooled decode
        calls = []
        pooled = tts.generate_batch
        tts.generate_batch = lambda texts, **kw: calls.append(len(texts)) or pooled(texts, **kw)
        try:
            _reset_counts()
            res = tts.generate_long_text_batch(LONG_STORIES, voice_profile_paths=profiles,
                                               pause_scales=[1.0, 1.4], **LONG_KW)
            counts, perf = _counts(), dict(tts.perf)
        finally:
            del tts.generate_batch
        if calls != [2 * LONG_CHUNKS]:
            raise AssertionError(f"long_text_batch: generate_batch calls {calls}")
        for j, (wav, meta) in enumerate(res):
            if wav is None:
                raise AssertionError(f"long_text_batch: job {j} failed: {meta}")
            if meta["chunk_stats"]["pooled_jobs"] != 2 or meta["batched_jobs"] != 2:
                raise AssertionError(f"long_text_batch: job {j} pooled "
                                     f"{meta['chunk_stats']['pooled_jobs']}")
            _check_story(f"long_text_batch job {j}", wav, meta,
                         perf["row_tokens"][j * LONG_CHUNKS:(j + 1) * LONG_CHUNKS])
        want = _want(flash_decode=n_layers * perf["decode_steps"], **_s3gen_launches(cfg, perf))
        if counts != want:
            raise AssertionError(f"long_text_batch: launches {counts}, want {want}")
        for j, (wav, meta) in enumerate(res):
            log("long_text_batch", job=j, chunks=meta["num_chunks"],
                duration_s=f"{meta['duration_s']:.3f}", rows=perf["batch"],
                decode_steps=perf["decode_steps"], s3gen_dispatches=perf["s3gen_dispatches"],
                cfm_stride=perf["cfm_cache_every"],
                launches=json.dumps({k: v for k, v in counts.items() if v}).replace(" ", ""),
                **_long_perf(meta), card=repr(card))
        launches["long_text_batch"] = counts

        # (c) the alignment guard on the 8 texts; the fused step is asked
        # for and must stay off
        conds = _random_conds(cfg, "cuda")
        with _env({"CHATTERBOX_ALIGNMENT": "1", "CHATTERBOX_FUSED_STEP": "1"}):
            _reset_counts()
            wavs = tts.generate_batch(TEXTS, conds=conds, **BATCH_KW)
            counts, perf = _counts(), dict(tts.perf)
        cap = BATCH_KW["max_new_tokens"]
        for i, (w, n) in enumerate(zip(wavs, perf["row_tokens"])):
            if w.shape != (2 * n * 480,) or n == 0 or not np.isfinite(w).all():
                raise AssertionError(f"alignment row {i}: wav {w.shape} for {n} tokens")
        want = _want(flash_decode=(n_layers - 1) * perf["decode_steps"],
                     **_s3gen_launches(cfg, perf))
        if counts != want or perf["decode_steps"] == 0:
            raise AssertionError(f"alignment: launches {counts}, want {want} (K1 on every "
                                 f"layer but the spy layer, no fused step)")
        log("alignment", rows=len(wavs), row_tokens=",".join(map(str, perf["row_tokens"])),
            stopped_before_cap=sum(n < cap for n in perf["row_tokens"]), cap=cap,
            decode_steps=perf["decode_steps"],
            launches=json.dumps({k: v for k, v in counts.items() if v}).replace(" ", ""),
            t3_s=f"{perf['t3_s']:.4f}", ms_per_step=f"{1e3 * perf['t3_s'] / perf['decode_steps']:.3f}",
            s3gen_s=f"{perf['s3gen_s']:.4f}", audio_s=f"{perf['audio_s']:.3f}",
            batch_rtf=f"{perf['rtf']:.4f}", card=repr(card))
        launches["alignment"] = counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tts.conds = None
    tts.clear_conditional_cache()
    torch.cuda.empty_cache()
    return launches


def _serve_engine(tts, requests, geo: dict, start_step: int = 0) -> dict:
    """Run `requests` (dicts of ContinuousServer.submit's arguments, the
    text under "text") through a new ContinuousServer of geometry `geo`
    until it idles, its step counter starting at `start_step`. Returns the
    engine's completions (rid: tokens), each request's join step and slot,
    the wavs,
    the streamed chunks by rid, the decoder and the seconds: the wall, the
    vocode flushes' and the refills' (the program's spans)."""
    from chatterbox_embed_tpu_torch.serving.continuous import ContinuousServer
    from chatterbox_embed_tpu_torch.utils import profiling
    srv = ContinuousServer(tts, **geo)
    srv.decoder.state.g = start_step
    completions, joined = {}, {}
    step = srv.decoder.step

    def recording_step():
        out = step()
        completions.update(out)
        return out

    refill = srv.decoder._refill

    def recording_refill():
        refill()
        for i, sl in enumerate(srv.decoder._slots):
            if sl.rid is not None:
                joined.setdefault(sl.rid, (srv.decoder.state.g_start_host[i], i))

    srv.decoder.step = recording_step
    srv.decoder._refill = recording_refill
    profiling.reset()
    profiling.enable()
    try:
        t0 = time.time()
        rids = [srv.submit(**r) for r in requests]
        streamed = [rid for rid, r in zip(rids, requests) if r.get("stream")]
        # a consumer that takes its stream from the start keeps its chunks
        wavs, chunks = {}, {rid: srv.take_stream(rid) for rid in streamed}
        while not srv.idle:
            wavs.update(srv.pump())
            for rid in streamed:
                chunks[rid].extend(srv.take_stream(rid))
        for rid in streamed:
            chunks[rid].extend(srv.take_stream(rid))
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        profiling.disable()
    if srv.failed:
        raise AssertionError(f"engine: failed requests {srv.failed}")
    seconds = {k: v["ns"] / 1e9 for k, v in profiling.totals()["spans"].items()}
    return dict(rids=rids, completions=completions, joined=joined, wavs=wavs, chunks=chunks,
                decoder=srv.decoder, wall_s=wall, vocode_s=seconds.get("server.vocode", 0.0),
                refill_s=seconds.get("engine.refill", 0.0))


def phase_engine(card: str, tts) -> dict:
    """The continuous engine at full width (ENGINE_GEO): 10 requests with
    skewed limits through 4 slots, refills mid-decode, two voices, one
    streamed. Checks K1 = 30 x steps and K4 = 0, every wav finite and 2 *
    tokens * 480 samples, each request's tokens within its limit, the
    streamed chunks joining to its wav, and two requests alone in a new
    engine of the same geometry giving the same tokens. Prints steps a
    second, occupancy (live slot-steps over slots x steps), and the refill,
    decode and vocode seconds; then the lock-step generate_batch's seconds
    on the same requests. Returns the launches."""
    from chatterbox_embed_tpu_torch.config import SPEECH_VOCAB_SIZE
    cfg = tts.cfg
    n_layers = cfg.t3.llama.num_layers
    voices = [_random_conds(cfg, "cuda", n, seed) for n, seed in ((150, 5), (110, 6))]
    requests = [dict(text=t, conds=voices[i % 2], seed=i, temperature=0.8, cfg_weight=0.5,
                     max_new_tokens=lim, stream=i == ENGINE_STREAMED)
                for i, (t, lim) in enumerate(zip(ENGINE_TEXTS, ENGINE_LIMITS))]
    _reset_counts()
    run = _serve_engine(tts, requests, ENGINE_GEO)
    counts = _counts()
    dec = run["decoder"]
    steps = dec.steps_run
    want = dict(counts, flash_decode=n_layers * steps, flash_decode_deferred=0, fused_decode=0,
                weight_stream=0, decode_anatomy=0)
    if counts != want or steps == 0:
        raise AssertionError(f"engine: launches {counts}, want K1 {n_layers} x {steps}, no K4")
    tokens = {}
    for rid, req in zip(run["rids"], requests):
        toks = run["completions"][rid]
        n = int((toks < SPEECH_VOCAB_SIZE).sum())
        w = run["wavs"][rid]
        if (len(toks) > req["max_new_tokens"] or n == 0 or w.shape != (2 * n * 480,)
                or not np.isfinite(w).all()):
            raise AssertionError(f"engine request {rid}: {len(toks)} tokens (limit "
                                 f"{req['max_new_tokens']}), wav {w.shape}")
        tokens[rid] = toks
    srid = run["rids"][ENGINE_STREAMED]
    if not np.array_equal(np.concatenate(run["chunks"][srid]), run["wavs"][srid]):
        raise AssertionError("engine: the streamed chunks do not join to the streamed wav")
    live = sum(len(t) for t in tokens.values())
    occupancy = live / (dec.slots * steps)
    log("engine", requests=len(requests), slots=dec.slots, block=dec.block, steps=steps,
        blocks=dec.blocks_run, live_slot_steps=live, occupancy=f"{occupancy:.4f}",
        steps_per_s=f"{steps / dec.t_decode:.2f}", ms_per_step=f"{1e3 * dec.t_decode / steps:.3f}",
        refill_s=f"{run['refill_s']:.4f}", decode_s=f"{dec.t_decode:.4f}",
        vocode_s=f"{run['vocode_s']:.4f}", wall_s=f"{run['wall_s']:.4f}",
        tokens=",".join(str(len(tokens[r])) for r in run["rids"]),
        stream_chunks=len(run["chunks"][srid]),
        launches=json.dumps({k: v for k, v in counts.items() if v}).replace(" ", ""),
        card=repr(card))
    for i in ENGINE_ALONE:
        # alone in slot 0, joining at the step it joined in traffic: K1 cuts
        # a row's span, its ring hole included, into splits, so the split
        # edges (and the fp32 sums' order) follow where the ring range starts
        rid = run["rids"][i]
        step0, slot = run["joined"][rid]
        alone = _serve_engine(tts, [requests[i]], ENGINE_GEO, start_step=step0)
        got, want = alone["completions"][alone["rids"][0]], tokens[rid]
        if not np.array_equal(got, want):
            n = min(len(got), len(want))
            first = int(np.nonzero(got[:n] != want[:n])[0][0]) if (got[:n] != want[:n]).any() \
                else n
            raise AssertionError(f"engine: request {i} alone gives other tokens from token "
                                 f"{first} ({len(got)} against {len(want)} tokens)")
        log("engine_isolation", request=i, tokens=len(got), joined_at=step0,
            slot_in_traffic=slot, slot_alone=0, equal=True, dtype="bfloat16")
    t0 = time.time()
    wavs = tts.generate_batch(ENGINE_TEXTS, conds=[voices[i % 2] for i in range(len(requests))],
                              max_new_tokens=max(ENGINE_LIMITS), temperature=0.8,
                              cfg_weight=0.5, seed=0)
    perf = dict(tts.perf)
    log("engine_lockstep", requests=len(wavs), max_new_tokens=max(ENGINE_LIMITS),
        decode_steps=perf["decode_steps"], t3_s=f"{perf['t3_s']:.4f}",
        s3gen_s=f"{perf['s3gen_s']:.4f}", wall_s=f"{time.time() - t0:.4f}",
        engine_wall_s=f"{run['wall_s']:.4f}", card=repr(card))
    return counts


def phase_worker(card: str, tts) -> dict:
    """The Redis worker at full width (WORKER_STORIES): run_continuous on
    the in-memory streams and the local storage emulation. Checks every
    job `done`, the DLQ empty, each job's audio stored and its metadata
    `continuous`, the engine's steps > 0 and K1 = 30 x steps, K4 = 0. Then
    clone_voice through a ChatterboxVC on the same weights (its sample's
    1000 tokens through the fused step) into the same storage. Returns
    the worker's launches."""
    from chatterbox_embed_tpu_torch.serving.worker import (DLQ_STREAM, STREAM_TTS,
                                                           InMemoryStreams, RedisWorker)
    from chatterbox_embed_tpu_torch.utils import audio_io
    from chatterbox_embed_tpu_torch.vc import ChatterboxVC, clone_voice
    cfg = tts.cfg
    n_layers = cfg.t3.llama.num_layers
    tmp = tempfile.mkdtemp(prefix="cbx_smoke_worker_")
    try:
        store = os.path.join(tmp, "store")
        b64 = []
        for seed in (7, 8):
            ref, prof = (os.path.join(tmp, f"{n}{seed}.{ext}")
                         for n, ext in (("ref", "wav"), ("voice", "npy")))
            audio_io.write_wav(ref, _voice(seed, COND_REF_S, 24_000), 24_000)
            tts.save_voice_profile(ref, prof)
            with open(prof, "rb") as f:
                b64.append(base64.b64encode(f.read()).decode())
        env = {"CHATTERBOX_LOCAL_STORAGE": store, "WORKER_CONTINUOUS": "1",
               "WORKER_MAX_NEW_TOKENS": str(WORKER_NEW_TOKENS)}
        with _env(env):
            client = InMemoryStreams()
            worker = RedisWorker(mode="tts", client=client, tts_factory=lambda: tts)
            for i, text in enumerate(WORKER_STORIES):
                client.xadd(STREAM_TTS, {"payload": json.dumps({
                    "job_id": f"job{i}", "type": "tts", "story_id": f"story{i}",
                    "user_id": "smoke", "text": text, "voice_profile_b64": b64[i % 2]})})
            _reset_counts()
            t0 = time.time()
            handled = worker.run_continuous(stop_when_drained=True)
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts = _counts()
            steps, audio_s = 0, 0.0
            for i in range(len(WORKER_STORIES)):
                status = client.hgetall(f"runpod:job:job{i}")
                if status.get("status") != "done":
                    raise AssertionError(f"worker job{i}: {status}")
                result = json.loads(status["result"])
                meta = result["metadata"]
                if (not os.path.exists(result["storage_url"]) or result["duration"] <= 0
                        or meta["chunk_stats"].get("continuous") is not True):
                    raise AssertionError(f"worker job{i}: {result['storage_url']}, "
                                         f"duration {result['duration']}")
                steps = max(steps, meta["engine"]["steps_run"])
                audio_s += result["duration"]
            if handled != len(WORKER_STORIES) or client.streams.get(DLQ_STREAM):
                raise AssertionError(f"worker: handled {handled}, DLQ "
                                     f"{client.streams.get(DLQ_STREAM)}")
            if steps == 0 or counts["flash_decode"] != n_layers * steps or \
                    counts["fused_decode"] or counts["flash_decode_deferred"]:
                raise AssertionError(f"worker: launches {counts}, want K1 {n_layers} x {steps}")
            log("worker", jobs=handled, engine_steps=steps, audio_s=f"{audio_s:.3f}",
                wall_s=f"{wall:.4f}", audio_ratio=f"{audio_s / wall:.4f}",
                launches=json.dumps({k: v for k, v in counts.items() if v}).replace(" ", ""),
                card=repr(card))

            vc = ChatterboxVC(tts.s3gen_params, tts.t3_params, tts.ve_params, tts.tokenizer,
                              config=cfg, dtype=tts.dtype, device=tts.device)
            with open(os.path.join(tmp, "ref7.wav"), "rb") as f:
                audio = base64.b64encode(f.read()).decode()
            t0 = time.time()
            with _env({"CHATTERBOX_FUSED_STEP": "1"}):
                res = clone_voice(vc, voice_id="smoke_voice", voice_name="Smoke Voice",
                                  user_id="smoke", audio_b64=audio)
            doc = os.path.join(store, "firestore", "voice_profiles", "smoke_voice.json")
            if (res.get("status") != "success" or not os.path.exists(res["profile_url"])
                    or not os.path.exists(res["sample_url"]) or not os.path.exists(doc)):
                raise AssertionError(f"clone_voice: {res}")
            log("clone_voice", seconds=f"{time.time() - t0:.4f}",
                profile_bytes=os.path.getsize(res["profile_url"]),
                sample_bytes=os.path.getsize(res["sample_url"]), card=repr(card))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tts.conds = None
    tts.clear_conditional_cache()
    torch.cuda.empty_cache()
    return counts


def _text_rows(tts, texts):
    """generate_batch's T3 rows for `texts`: (U, T) int32 wrapped in
    SOT/EOT and right-padded with EOT, and each row's length."""
    sot, eot = tts.cfg.t3.start_text_token, tts.cfg.t3.stop_text_token
    rows = [np.concatenate([[sot], tts.tokenizer.text_to_tokens(t)[0], [eot]]) for t in texts]
    tt = np.full((len(rows), max(len(r) for r in rows)), eot, np.int32)
    for i, r in enumerate(rows):
        tt[i, :len(r)] = r
    return tt, np.asarray([len(r) for r in rows], np.int32)


def _same_tokens(label: str, want, got) -> None:
    for i, (a, b) in enumerate(zip(want, got, strict=True)):
        if not np.array_equal(a, b):
            n = min(len(a), len(b))
            first = int(np.argmax(a[:n] != b[:n])) if (a[:n] != b[:n]).any() else n
            raise AssertionError(f"{label}: row {i} differs from one process's at token "
                                 f"{first} (lengths {len(a)}, {len(b)})")


def _tp_sum_ms(mesh, width: int, iters: int = 200) -> float:
    """Host ms of one tp sum (the all-reduce after a row-parallel product)
    of a (2, 1, width) fp32 tensor on this rank's device, over `iters`."""
    x = torch.zeros((2, 1, width), device=mesh.device)
    for _ in range(10):
        mesh.sum_tp(x)
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(iters):
        mesh.sum_tp(x)
    torch.cuda.synchronize()
    return 1e3 * (time.time() - t0) / iters


class _ForcedDraws:
    """Draws that pick given tokens: step i's Gumbel tensor is 0 at
    forced[i] and -inf elsewhere, so sampling returns forced[i] from any
    logits finite there (min_p 0 and top_p 1 mask no valid id)."""

    def __init__(self, forced):
        self.forced = [int(x) for x in forced]

    def gumbel(self, step: int, shape) -> torch.Tensor:
        g = torch.full(shape, -float("inf"))
        g[:, self.forced[step]] = 0.0
        return g


def _forced_logits(params, cond, tt, forced, cfg, mesh=None, device=None) -> torch.Tensor:
    """(1 + steps, rows, V) fp32: the speech head's logits of every CFG row
    after prefill and after each decode step fed `forced` (teacher forcing),
    one decode_block of one step at a time; on `mesh` (called on each rank
    through Mesh.call) or alone. Raises if a step took another token."""
    from chatterbox_embed_tpu_torch.models import t3
    from chatterbox_embed_tpu_torch.ops import sampling
    n = len(forced)
    state, ginfo = t3.start_generation(params, cond, tt, cfg_weight=0.5, max_new_tokens=n,
                                       cfg=cfg, mesh=mesh, device=device)
    sp = sampling.SamplingParams(1.0, 0.5, 1.2, 0.0, 1.0)
    draws = _ForcedDraws(forced)
    out = [state.logits.clone()]
    for i in range(n):
        state, toks, k = t3.decode_block(params, state, ginfo, sp, draws, block=1, limit=n,
                                         use_top_p=False, stop_on_eos=False, cfg=cfg,
                                         dtype=torch.float32, mesh=mesh)
        if k != 1 or int(toks[0, 0]) != draws.forced[i]:
            raise AssertionError(f"forced step {i}: took {toks[:k, 0]}, want {draws.forced[i]}")
        out.append(state.logits.clone())
    return torch.stack(out)


def _logits_close(label: str, got, want) -> float:
    """Max |got - want|; raises past atol = rtol = MESH_LOGIT_TOL."""
    err = (got - want).abs()
    if not bool((err <= MESH_LOGIT_TOL + MESH_LOGIT_TOL * want.abs()).all()):
        raise AssertionError(f"{label}: max err {err.max().item():.3e} over atol = rtol = "
                             f"{MESH_LOGIT_TOL}")
    return err.max().item()


def phase_mesh(card: str, tts) -> dict:
    """Serving on a mesh at full width (parallel/, tts.enable_mesh).
    (a) A world of 1 over NCCL: enable_mesh(), T3's tokens for 4 utterances
    equal the plain path's, and tts.generate_batch runs over the mesh (K1
    30 x steps, K2 and K3 in the leader's S3Gen). (b) Two ranks sharing the
    card over gloo, tp = 2 (8 heads a rank), on a fp32 T3: prefill logits
    within MESH_LOGIT_TOL of one process's, and so the logits of
    MESH_FORCED_STEPS decode steps teacher-forced on one process's tokens
    (K1 on 8 heads, the o/down sums); one generate to its cap with K1
    30 x steps on each rank; the step's ms beside one process's, the ms of
    one tp sum on each rank and the weight broadcast's seconds. (c) The same two ranks at dp = 2:
    generate_batch of 4 utterances equals one process token for token. (d)
    The engine at dp = 2 (4 slots, 6 requests) equals the one-process
    engine, with K1 30 x steps on each rank. Returns each path's
    launches."""
    from chatterbox_embed_tpu_torch import parallel
    from chatterbox_embed_tpu_torch.models import layers as L
    from chatterbox_embed_tpu_torch.models import t3, t3_engine
    cfg = tts.cfg
    n_layers = cfg.t3.llama.num_layers
    texts = TEXTS[:MESH_TEXTS]
    tt, lens = _text_rows(tts, texts)
    conds = _random_conds(cfg, "cuda")       # the phases before may leave none prepared
    cond = conds.t3
    kw = dict(max_new_tokens=MESH_NEW_TOKENS, cfg_weight=0.5, seed=0,
              temperature=TEMPERATURES[:MESH_TEXTS], text_lens=lens, cfg=cfg.t3)
    launches = {}

    # (a) a world of 1 over NCCL, the bf16 pipeline
    t0 = time.time()
    plain = t3.generate_batch(tts.t3_params, cond, tt, dtype=tts.dtype, **kw)
    mesh = tts.enable_mesh()
    try:
        backend = mesh._world.backend
        if mesh.shape != {"dp": 1, "tp": 1} or "cuda:nccl" not in backend:
            raise AssertionError(f"world of 1: mesh {mesh.shape}, backend {backend}")
        _same_tokens("world of 1", plain, t3.generate_batch(
            tts.t3_params, cond, tt, dtype=tts.dtype, mesh=mesh, **kw))
        _reset_counts()
        wavs = tts.generate_batch(texts, max_new_tokens=MESH_NEW_TOKENS, cfg_weight=0.5, seed=0,
                                  temperature=TEMPERATURES[:MESH_TEXTS], conds=conds)
        counts, perf = _counts(), dict(tts.perf)
        if t3.LAST_GENERATION_INFO["mesh"] != {"dp": 1, "tp": 1}:
            raise AssertionError(f"world of 1: {t3.LAST_GENERATION_INFO}")
        for i, (w, n) in enumerate(zip(wavs, perf["row_tokens"])):
            if w.shape != (2 * n * 480,) or n == 0 or not np.isfinite(w).all():
                raise AssertionError(f"world of 1: row {i} wav {w.shape}, {n} tokens")
        want = _want(flash_decode=n_layers * perf["decode_steps"], **_s3gen_launches(cfg, perf))
        if counts != want:
            raise AssertionError(f"world of 1: launches {counts}, want {want}")
        launches["mesh_world1_batch"] = counts
    finally:
        tts.mesh, tts.t3_params = None, tts._t3_params_single
        parallel.shutdown()
    log("mesh_world1", backend=backend, utterances=len(wavs), tokens_equal_plain=True,
        decode_steps=perf["decode_steps"], launches=json.dumps(
            {k: v for k, v in counts.items() if v}).replace(" ", ""),
        t3_s=f"{perf['t3_s']:.4f}", s3gen_s=f"{perf['s3gen_s']:.4f}",
        seconds=f"{time.time() - t0:.2f}", card=repr(card))

    # (b)-(d): two ranks on this card over gloo, a fp32 T3 from seed 1
    dev = torch.device("cuda", torch.cuda.current_device())
    params = t3.init(L.Init(1, dev), cfg.t3)
    try:
        t0 = time.time()
        mesh_tp = parallel.Mesh(np.asarray([[dev, dev]], dtype=object))
        world_s = time.time() - t0
        t0 = time.time()
        sv_tp = parallel.shard_t3_for_decode(mesh_tp, params)
        torch.cuda.synchronize()
        bcast_tp_s = time.time() - t0
        one, _ = t3.start_generation(params, cond, tt[:1], cfg_weight=0.5,
                                     max_new_tokens=MESH_NEW_TOKENS, cfg=cfg.t3)
        two, _ = t3.start_generation(sv_tp, cond, tt[:1], cfg_weight=0.5,
                                     max_new_tokens=MESH_NEW_TOKENS, cfg=cfg.t3, mesh=mesh_tp)
        err = _logits_close("tp = 2 prefill logits", two.logits, one.logits)
        gkw = dict(max_new_tokens=MESH_NEW_TOKENS, cfg_weight=0.5, temperature=0.7, seed=0,
                   stop_on_eos=False, cfg=cfg.t3)
        forced = t3.generate(params, cond, tt[:1], **gkw)[:MESH_FORCED_STEPS]   # warms too
        t0 = time.time()
        want_steps = _forced_logits(params, cond, tt[:1], forced, cfg.t3)
        got_steps = mesh_tp.call(_forced_logits, sv_tp, cond, tt[:1], forced, cfg.t3,
                                 mesh=mesh_tp)
        step_errs = [_logits_close(f"tp = 2 decode step {i} logits (teacher-forced)", g, w)
                     for i, (g, w) in enumerate(zip(got_steps[1:], want_steps[1:]))]
        forced_s = time.time() - t0
        torch.cuda.synchronize()
        t0 = time.time()
        info1: dict = {}
        t3.generate(params, cond, tt[:1], info=info1, **gkw)
        torch.cuda.synchronize()
        one_s = time.time() - t0
        mesh_tp.call_all(_reset_counts)
        t0 = time.time()
        info2: dict = {}
        toks = t3.generate(sv_tp, cond, tt[:1], mesh=mesh_tp, info=info2, **gkw)
        torch.cuda.synchronize()
        tp_s = time.time() - t0
        steps = info2["decode_steps"]
        ranks = mesh_tp.call_all(_counts)
        for r, c in enumerate(ranks):
            if c != _want(flash_decode=n_layers * steps) or steps != MESH_NEW_TOKENS:
                raise AssertionError(f"tp = 2 rank {r}: launches {c} for {steps} steps")
            launches[f"mesh_tp2_rank{r}"] = c
        if (toks.shape != (MESH_NEW_TOKENS,)
                or not ((toks >= 0) & (toks < cfg.t3.speech_tokens_dict_size)).all()):
            raise AssertionError(f"tp = 2 tokens {toks.shape}")
        sum_ms = mesh_tp.call_all(_tp_sum_ms, mesh_tp, cfg.t3.llama.hidden_size)
        log("mesh_tp2", ranks=2, heads_a_rank=cfg.t3.llama.num_heads // 2, backend=
            mesh_tp._world.backend, world_start_s=f"{world_s:.2f}",
            weight_broadcast_s=f"{bcast_tp_s:.3f}",
            logits_max_abs_err=f"{err:.3e}", logits_atol_rtol=MESH_LOGIT_TOL,
            forced_steps=len(step_errs), forced_logits_max_abs_err=f"{max(step_errs):.3e}",
            forced_step_errs=",".join(f"{e:.3e}" for e in step_errs),
            forced_s=f"{forced_s:.2f}",
            steps=steps, k1_a_rank=n_layers * steps,
            tp2_ms_per_step=f"{1e3 * tp_s / steps:.3f}",
            tp_sum_ms=",".join(f"{m:.4f}" for m in sum_ms),
            tp_sums_a_step=2 * n_layers,
            one_process_ms_per_step=f"{1e3 * one_s / info1['decode_steps']:.3f}",
            note="two ranks sharing one card over gloo, not a multi-card figure",
            card=repr(card))

        # (c) dp = 2 on the same world
        mesh_dp = parallel.Mesh(np.asarray([[dev], [dev]], dtype=object))
        t0 = time.time()
        sv_dp = parallel.shard_t3_for_serving(mesh_dp, params)
        torch.cuda.synchronize()
        bcast_dp_s = time.time() - t0
        t0 = time.time()
        want = t3.generate_batch(params, cond, tt, **kw)
        one_s = time.time() - t0
        t0 = time.time()
        got = t3.generate_batch(sv_dp, cond, tt, mesh=mesh_dp, **kw)
        dp_s = time.time() - t0
        _same_tokens("dp = 2", want, got)
        log("mesh_dp2", utterances=len(got), cfg_rows_a_rank=len(got), tokens_equal=True,
            tokens=",".join(str(len(g)) for g in got), weight_broadcast_s=f"{bcast_dp_s:.3f}",
            dp2_s=f"{dp_s:.3f}", one_process_s=f"{one_s:.3f}", card=repr(card))

        # (d) the engine at dp = 2
        def engine(p, m):
            dec = t3_engine.ContinuousDecoder(p, cfg.t3, mesh=m, **MESH_ENGINE)
            rids = [dec.submit(tt[i % len(tt)][None, :lens[i % len(tt)]], cond,
                               temperature=0.7, cfg_weight=0.5, seed=10 + i, max_new_tokens=lim)
                    for i, lim in enumerate(MESH_ENGINE_LIMITS)]
            res = dec.drain()
            return [res[r] for r in rids], dec.steps_run
        want, steps_one = engine(params, None)
        mesh_dp.call_all(_reset_counts)
        got, steps = engine(sv_dp, mesh_dp)
        ranks = mesh_dp.call_all(_counts)
        _same_tokens("engine dp = 2", want, got)
        for r, c in enumerate(ranks):
            if c != _want(flash_decode=n_layers * steps) or steps != steps_one:
                raise AssertionError(f"engine dp = 2 rank {r}: launches {c}, {steps} steps "
                                     f"({steps_one} in one process)")
            launches[f"mesh_engine_dp2_rank{r}"] = c
        log("mesh_engine_dp2", slots=MESH_ENGINE["slots"], slots_a_rank=MESH_ENGINE["slots"] // 2,
            requests=len(got), tokens=",".join(str(len(g)) for g in got), steps=steps,
            tokens_equal=True, card=repr(card))
    finally:
        parallel.shutdown()
        del params
        torch.cuda.empty_cache()
    return launches


def _flow_train_batch(frames, dec, seed: int, device) -> dict:
    """A flow training batch of len(frames) rows, max(frames) frames: target
    mel, encoder output and a speaker embedding from the seed, a prompt
    conditioning over each row's first quarter, the mask of each row's
    frames."""
    rng = np.random.default_rng(seed)
    b, t, n = len(frames), max(frames), dec.out_channels
    mask = (np.arange(t)[None, :, None] < np.asarray(frames)[:, None, None]).astype(np.float32)
    cond = rng.standard_normal((b, t, n)).astype(np.float32)
    cond *= (np.arange(t)[None, :, None] < np.asarray(frames)[:, None, None] // 4)
    batch = {"mel": rng.standard_normal((b, t, n)).astype(np.float32) * mask,
             "mu": rng.standard_normal((b, t, n)).astype(np.float32),
             "spks": rng.standard_normal((b, n)).astype(np.float32),
             "cond": cond, "mask": mask}
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _t3_train_batch(cfg) -> dict:
    """The train phase's T3 batch of 2 (numpy): a speaker embedding, the
    full prompt, text of TRAIN_T3_TEXT and speech of TRAIN_T3_SPEECH tokens."""
    rng = np.random.default_rng(0)
    b, lt, ls = len(TRAIN_T3_TEXT), max(TRAIN_T3_TEXT), max(TRAIN_T3_SPEECH)
    return {"speaker_emb": rng.standard_normal((b, cfg.speaker_embed_size)).astype(np.float32),
            "cond_prompt_tokens": rng.integers(0, 6561, (b, cfg.speech_cond_prompt_len)
                                               ).astype(np.int32),
            "emotion_adv": np.full((b, 1, 1), 0.5, np.float32),
            "text_tokens": rng.integers(0, cfg.text_tokens_dict_size, (b, lt)).astype(np.int32),
            "text_lens": np.asarray(TRAIN_T3_TEXT, np.int32),
            "speech_tokens": rng.integers(0, 6561, (b, ls)).astype(np.int32),
            "speech_lens": np.asarray(TRAIN_T3_SPEECH, np.int32)}


def _worst_grad(label: str, got: dict, want: dict) -> tuple:
    """(worst ratio, its leaf) of max |got - want| over the norm of `want`
    (plus 1e-7 / TRAIN_GRAD_TOL for leaves whose gradient is rounding
    noise) across the leaves; raises past TRAIN_GRAD_TOL."""
    worst, worst_path = 0.0, ""
    for path, gw in want.items():
        ratio = (got[path].to(gw.device) - gw).abs().max().item() / (
            gw.norm().item() + 1e-7 / TRAIN_GRAD_TOL)
        if not np.isfinite(ratio) or ratio > TRAIN_GRAD_TOL:
            raise AssertionError(f"{label}: gradient {path} max|diff| / ||g|| = {ratio:.3e} "
                                 f"> {TRAIN_GRAD_TOL}")
        if ratio > worst:
            worst, worst_path = ratio, path
    return worst, worst_path


class _FixedDraws:
    """One flow training step's draws, made once and handed to both
    devices (cfm.compute_loss moves them to the batch's device)."""

    def __init__(self, draws):
        self.draws = draws

    def flow_train(self, rows, shape):
        return self.draws


@contextlib.contextmanager
def _written_out_attention():
    """The estimator's attention written out (layers.mha under autograd) at
    every row count, for the CPU side of the card-against-CPU step."""
    from chatterbox_embed_tpu_torch.models import layers as L
    gate = L.use_flash_attention
    L.use_flash_attention = lambda rows: False
    try:
        yield
    finally:
        L.use_flash_attention = gate


def _train_log(name: str, losses, seconds, base: int, card: str, **extra) -> None:
    """The run's losses and times; its peak memory is what it allocated
    above `base`, the bytes allocated before its state was made (earlier
    phases may leave some behind)."""
    log(name, losses=",".join(f"{x:.6f}" for x in losses),
        ms_per_step_after_first=f"{1e3 * float(np.mean(seconds[1:])):.3f}",
        first_step_ms=f"{1e3 * seconds[0]:.3f}",
        peak_memory_gb=f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.3f}",
        max_memory_allocated_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}",
        **extra, card=repr(card))


def _step_profile(name: str, fn, parts: dict, card: str) -> None:
    """One profiled call of `fn`: the device's kernel time against the
    wall, and the kernel time of each part (kernel names containing one of
    its strings). The profiler slows the host, so the busy share is a lower
    bound of the unprofiled step's; a capture may lose kernel records
    (probes/timing.device_ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.time() - t0)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    shares = {}
    for label, keys in parts.items():
        us = sum(e.self_device_time_total for e in events if any(k in e.key for k in keys))
        shares[f"{label}_ms"] = f"{us / 1e3:.3f}"
    log("train_profile", name=name, device_ms=f"{device_ms:.3f}",
        profiled_wall_ms=f"{wall_ms:.3f}", busy_share=f"{device_ms / wall_ms:.3f}",
        kernels=sum(e.count for e in events), **shares, card=repr(card))


def phase_train(card: str) -> dict:
    """Training at full width on the card (fp32, random weights from a seed):
    T3 (ChatterboxConfig().t3, 30 layers) takes TRAIN_STEPS AdamW steps with
    remat on one batch, and its losses must be finite and fall; the flow
    estimator (FlowDecoderConfig(), 56 transformer blocks) takes TRAIN_STEPS
    steps on 4 rows, each through K3 forward and K3b-dq / K3b-dkv 56 times
    (written-out attention nowhere), then two steps computing in bf16 (the
    same launches); then one flow step's loss and every gradient leaf on the
    card against the CPU on the same params, batch and draws at 256 frames.
    Returns the launches of each run."""
    from chatterbox_embed_tpu_torch import training
    from chatterbox_embed_tpu_torch.config import CFMConfig, ChatterboxConfig, FlowDecoderConfig
    from chatterbox_embed_tpu_torch.models import flow_decoder, t3
    from chatterbox_embed_tpu_torch.models import layers as L
    from chatterbox_embed_tpu_torch.ops.sampling import Draws
    from chatterbox_embed_tpu_torch.weights import _leaves
    launches = {}
    cfg = ChatterboxConfig().t3
    batch = _t3_train_batch(cfg)
    b = len(TRAIN_T3_TEXT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = training.init_t3_train_state(t3.init(L.Init(0), cfg))       # the card
    step = training.make_t3_train_step(None, cfg, remat=True)
    losses, seconds = [], []
    _reset_counts()
    for _ in range(TRAIN_STEPS):
        t0 = time.time()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
        losses.append(float(metrics["loss"]))
    launches["train_t3"] = _counts()
    _step_profile("train_t3", lambda: step(state, batch), {}, card)
    _train_log("train_t3", losses, seconds, base, card, layers=cfg.llama.num_layers,
               d=cfg.llama.hidden_size, rows=b, prompt=cfg.speech_cond_prompt_len,
               text=TRAIN_T3_TEXT, speech=TRAIN_T3_SPEECH, remat=True, dtype="float32",
               steps=state.step)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"T3 training: losses {losses} are not finite and falling")
    if launches["train_t3"] != _want():
        raise AssertionError(f"T3 training launched kernels: {launches['train_t3']}")
    del state, step
    torch.cuda.empty_cache()

    dec, cfm = FlowDecoderConfig(), CFMConfig()
    n_tblocks = (2 + dec.num_mid_blocks) * dec.n_blocks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = training.init_flow_train_state(flow_decoder.init(L.Init(1), dec))
    step = training.make_flow_train_step(None, cfm, dec)
    fbatch = _flow_train_batch(TRAIN_FLOW_FRAMES, dec, 0, "cuda")
    losses, seconds = [], []
    _reset_counts()
    before = _counts()
    for i in range(TRAIN_STEPS):
        t0 = time.time()
        state, metrics = step(state, Draws(i), fbatch)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
        losses.append(float(metrics["loss"]))
        now = _counts()
        delta = {k: now[k] - before[k] for k in now}
        want = _want(flash_attention=n_tblocks, flash_attention_bwd_dq=n_tblocks,
                     flash_attention_bwd_dkv=n_tblocks)
        if delta != want:
            raise AssertionError(f"flow step {i}: launches {delta}, want {want}")
        before = now
    launches["train_flow"] = _counts()
    _step_profile("train_flow", lambda: step(state, Draws(TRAIN_STEPS), fbatch),
                  {"k3": ("masked_attention",), "k3b_dq": ("attention_bwd_dq",),
                   "k3b_dkv": ("attention_bwd_dkv",)}, card)
    _train_log("train_flow", losses, seconds, base, card, rows=len(TRAIN_FLOW_FRAMES),
               frames=TRAIN_FLOW_FRAMES, channels=dec.channels, tblocks=n_tblocks,
               dtype="float32", steps=state.step,
               launches_per_step=f"K3 {n_tblocks}, K3b-dq {n_tblocks}, K3b-dkv {n_tblocks}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"flow training: losses {losses} are not finite")

    # the same estimator computing in bf16 (fp32 master weights): one warm
    # step and one timed; the profile's kernel names tell K3 / K3b's dtype
    # (masked_attention_tc, attention_bwd_*_tc: bf16 on the tensor cores)
    step16 = training.make_flow_train_step(None, cfm, dec, dtype=torch.bfloat16)
    losses, seconds = [], []
    _reset_counts()
    before = _counts()
    for i in range(2):
        t0 = time.time()
        state, metrics = step16(state, Draws(10 + i), fbatch)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
        losses.append(float(metrics["loss"]))
        now = _counts()
        delta = {k: now[k] - before[k] for k in now}
        if delta != want:
            raise AssertionError(f"bf16 flow step {i}: launches {delta}, want {want}")
        before = now
    launches["train_flow_bf16"] = _counts()
    _step_profile("train_flow_bf16", lambda: step16(state, Draws(12), fbatch),
                  {"k3": ("masked_attention",), "k3_tc": ("masked_attention_tc",),
                   "k3b_dq": ("attention_bwd_dq",), "k3b_dkv": ("attention_bwd_dkv",),
                   "k3b_tc": ("attention_bwd_dq_tc", "attention_bwd_dkv_tc")}, card)
    _train_log("train_flow_bf16", losses, seconds, base, card, rows=len(TRAIN_FLOW_FRAMES),
               frames=TRAIN_FLOW_FRAMES, dtype="bfloat16", steps=state.step,
               launches_per_step=f"K3 {n_tblocks}, K3b-dq {n_tblocks}, K3b-dkv {n_tblocks}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"bf16 flow training: losses {losses} are not finite")
    del state, step, step16, fbatch
    torch.cuda.empty_cache()

    # one step's loss and gradients, card (K3 + K3b) against CPU (autograd
    # through the written-out attention): same params, batch and draws
    from chatterbox_embed_tpu_torch.training.train_step import flow_loss_fn
    params0 = flow_decoder.init(L.Init(2, device="cpu"), dec)
    rows, frames = len(TRAIN_CHECK_FRAMES), max(TRAIN_CHECK_FRAMES)
    draws = _FixedDraws(Draws(5, "cpu").flow_train(rows, (rows, frames, dec.out_channels)))
    result = {}
    for device in ("cuda", "cpu"):
        params = training.init_flow_train_state(params0, device=device).params
        sbatch = _flow_train_batch(TRAIN_CHECK_FRAMES, dec, 1, device)
        t0 = time.time()
        _reset_counts()
        with _written_out_attention() if device == "cpu" else contextlib.nullcontext():
            loss, _ = flow_loss_fn(params, draws, sbatch, cfm, dec, torch.float32)
            loss.backward()
        result[device] = (loss.item(), {path: x.grad.cpu() for path, x in _leaves(params)})
        counts = _counts()
        want = _want(flash_attention=n_tblocks, flash_attention_bwd_dq=n_tblocks,
                     flash_attention_bwd_dkv=n_tblocks) if device == "cuda" else _want()
        if counts != want:
            raise AssertionError(f"flow step on {device}: launches {counts}, want {want}")
        log("train_flow_step", device=device, frames=TRAIN_CHECK_FRAMES, loss=f"{loss.item():.8f}",
            seconds=f"{time.time() - t0:.2f}")
    (loss_gpu, g_gpu), (loss_cpu, g_cpu) = result["cuda"], result["cpu"]
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    worst, worst_path = _worst_grad("flow step, card against CPU", g_gpu, g_cpu)
    if not loss_err <= TRAIN_LOSS_TOL:
        raise AssertionError(f"flow step loss: card {loss_gpu} against CPU {loss_cpu}")
    log("train_flow_check", frames=TRAIN_CHECK_FRAMES, loss_rel_err=f"{loss_err:.3e}",
        loss_limit=TRAIN_LOSS_TOL, leaves=len(g_cpu), worst_grad_err_over_norm=f"{worst:.3e}",
        worst_leaf=worst_path, grad_limit=TRAIN_GRAD_TOL, matmul_tf32=False, cudnn_tf32=False)
    torch.cuda.empty_cache()
    return launches


def _rank_free() -> None:
    """Free the card memory that a rank's dropped objects held (the caching
    allocator's blocks)."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _leaf_checksums(params, paths) -> list:
    """A position-weighted sum of the bits of each leaf of `paths` (int64,
    on the leaf's device): two copies that differ in one element always
    give two sums."""
    from chatterbox_embed_tpu_torch.weights import _leaves
    flat = dict(_leaves(params))
    out = []
    for path in paths:
        bits = flat[path].detach().contiguous().view(-1).view(torch.int32).to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device, dtype=torch.int64) % 65521 + 1
        out.append(int((bits * w).sum()))
    return out


def _pp_check(params, ref, ref_grads) -> dict:
    """This pp rank's leaves (its stages and aux) after the step against
    one process's after its step (`ref`, `ref_grads`: one process's tree
    and gradients laid out as this rank's, shard_pp_params): the worst
    gradient max |diff| over the leaf's norm, the worst parameter |diff|
    where one process's |g| >= TRAIN_MESH_GRAD_FLOOR, and the elements
    below the floor with their worst |diff|."""
    from chatterbox_embed_tpu_torch.weights import _leaves
    got, want, wgrad = (dict(_leaves(t)) for t in (params, ref, ref_grads))
    out = {"grad_ratio": 0.0, "grad_leaf": "", "param_diff": 0.0, "param_leaf": "",
           "below_floor": 0, "below_floor_diff": 0.0}
    for path, x in got.items():
        g, gw = x.grad, wgrad[path]
        ratio = (g - gw).abs().max().item() / (gw.norm().item() + 1e-7 / TRAIN_GRAD_TOL)
        if not ratio <= out["grad_ratio"]:
            out["grad_ratio"], out["grad_leaf"] = ratio, path
        diff = (x.detach() - want[path]).abs()
        above = gw.abs() >= TRAIN_MESH_GRAD_FLOOR
        worst = diff[above].max().item() if above.any() else 0.0
        if not worst <= out["param_diff"]:
            out["param_diff"], out["param_leaf"] = worst, path
        if not above.all():
            out["below_floor"] += int((~above).sum())
            out["below_floor_diff"] = max(out["below_floor_diff"], diff[~above].max().item())
    return out


def _hop_ms(mesh, shape, iters: int = 50) -> float:
    """Host ms of one pp hop (`Mesh.shift`) of an fp32 tensor of `shape` on
    this rank's device, over `iters`."""
    x = torch.zeros(shape, device=mesh.device)
    for _ in range(5):
        mesh.shift(x, "pp", 1)
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(iters):
        mesh.shift(x, "pp", 1)
    torch.cuda.synchronize()
    return 1e3 * (time.time() - t0) / iters


def _ms(seconds) -> str:
    return ",".join(f"{1e3 * x:.3f}" for x in seconds)


def phase_train_mesh(card: str) -> dict:
    """Training on a mesh and the sp and pp axes at full width (fp32,
    random weights from seeds), on two ranks sharing the card over gloo;
    each part held to one process on the card. (a) sp = 2: sp_generate_mel
    of one utterance of TRAIN_MESH_SP_FRAMES frames (CFG, the default 10
    Euler steps) against cfm.generate_mel within TRAIN_MESH_SP_TOL. (b)
    dp = 2: two flow steps on the train phase's rows twice over (4 a
    rank), the first one's loss and every gradient leaf against one
    process's first step at the train phase's limits; K3, K3b-dq and
    K3b-dkv 56 times a step on each rank. (c) The T3 step (remat) at tp = 2
    and at dp = 2 on the train phase's batch, two steps each: the first
    one's loss against one process's, the replicated leaves bit-equal
    across the ranks after both. (d) pp = 2, 15 layers a stage,
    TRAIN_MESH_MICRO microbatches, one step: its loss against one
    process's first step, and on each rank its leaves (stages and aux)
    against that step's (`_pp_check`: gradients within TRAIN_GRAD_TOL of
    their norm, values within TRAIN_MESH_PARAM_TOL above
    TRAIN_MESH_GRAD_FLOOR). Every part prints its ms beside
    one process's; the times are two ranks on one card, not several cards.
    Returns the flow step's launches on each rank."""
    from chatterbox_embed_tpu_torch import parallel, training
    from chatterbox_embed_tpu_torch.config import CFMConfig, ChatterboxConfig, FlowDecoderConfig
    from chatterbox_embed_tpu_torch.models import cfm, flow_decoder, t3
    from chatterbox_embed_tpu_torch.models import layers as L
    from chatterbox_embed_tpu_torch.ops.sampling import Draws
    from chatterbox_embed_tpu_torch.parallel import mesh as mesh_lib
    from chatterbox_embed_tpu_torch.parallel import pipeline
    from chatterbox_embed_tpu_torch.weights import _leaves
    note = "two ranks sharing one card over gloo, not a multi-card figure"
    launches = {}
    dev = torch.device("cuda", torch.cuda.current_device())
    dec, cfm_cfg = FlowDecoderConfig(), CFMConfig()
    n_tblocks = (2 + dec.num_mid_blocks) * dec.n_blocks
    nf = dec.out_channels
    try:
        # (a) sp = 2: one utterance's mel over two ranks
        t_part = time.time()
        flow = flow_decoder.init(L.Init(3, dev), dec)
        rng = np.random.default_rng(3)
        tl = TRAIN_MESH_SP_FRAMES
        mu = torch.as_tensor(rng.standard_normal((1, tl, nf)).astype(np.float32), device=dev)
        spks = torch.as_tensor(rng.standard_normal((1, nf)).astype(np.float32), device=dev)
        cond = torch.zeros((1, tl, nf), device=dev)
        cond[:, :tl // 4] = torch.as_tensor(
            rng.standard_normal((1, tl // 4, nf)).astype(np.float32), device=dev)
        one_s = []
        for _ in range(2):
            t0 = time.time()
            with torch.no_grad():
                one = cfm.generate_mel(flow, mu, spks, cond, None, cfm_cfg, dec)
            torch.cuda.synchronize()
            one_s.append(time.time() - t0)
        t0 = time.time()
        mesh_sp = parallel.make_sp_mesh(2, device=dev)
        world_s = time.time() - t0
        flow_sp = parallel.replicate(mesh_sp, flow)
        mesh_sp.call_all(_reset_counts)
        sp_s = []
        for _ in range(2):
            t0 = time.time()
            out = parallel.sp_generate_mel(mesh_sp, flow_sp, mu, spks, cond, None,
                                           cfm_cfg=cfm_cfg, dec_cfg=dec)
            torch.cuda.synchronize()
            sp_s.append(time.time() - t0)
        for r, c in enumerate(mesh_sp.call_all(_counts)):
            if c != _want():
                raise AssertionError(f"sp = 2 rank {r} launched kernels: {c}")
        err = (out - one).abs().max().item()
        if out.shape != one.shape or not torch.isfinite(out).all() or not err <= TRAIN_MESH_SP_TOL:
            raise AssertionError(f"sp = 2 mel {tuple(out.shape)}: max |err| {err:.3e} against "
                                 f"one process ({TRAIN_MESH_SP_TOL})")
        log("train_mesh_sp2", frames=tl, frames_a_rank=tl // 2, euler_steps=cfm_cfg.n_timesteps,
            cfg_rows=2, max_abs_err=f"{err:.3e}", limit=TRAIN_MESH_SP_TOL,
            max_abs_out=f"{one.abs().max().item():.3f}", sp2_s=",".join(f"{x:.3f}" for x in sp_s),
            one_process_s=",".join(f"{x:.3f}" for x in one_s), world_start_s=f"{world_s:.2f}",
            backend=mesh_sp._world.backend, hop=mesh_lib.HOP,
            part_s=f"{time.time() - t_part:.1f}", note=note, card=repr(card))
        del flow, flow_sp, out, one

        # (b) the flow step at dp = 2, 4 rows a rank
        t_part = time.time()
        frames = TRAIN_FLOW_FRAMES * 2
        rows = len(frames)
        flow0 = flow_decoder.init(L.Init(4, dev), dec)
        fbatch = _flow_train_batch(frames, dec, 0, "cuda")
        draws = [_FixedDraws(Draws(20 + i, "cpu").flow_train(rows, (rows, max(frames), nf)))
                 for i in range(2)]
        one = training.init_flow_train_state(flow0)
        step1 = training.make_flow_train_step(None, cfm_cfg, dec)
        one_s = []
        for i in range(2):
            t0 = time.time()
            one, m1 = step1(one, draws[i], fbatch)
            torch.cuda.synchronize()
            one_s.append(time.time() - t0)
            if i == 0:
                loss_one = float(m1["loss"])
                g_one = {path: x.grad.clone() for path, x in _leaves(one.params)}
        del one, step1
        mesh_dp = parallel.make_dp_mesh(2, device=dev)
        t0 = time.time()
        st = training.shard_flow_state(training.init_flow_train_state(flow0), mesh_dp)
        torch.cuda.synchronize()
        place_s = time.time() - t0
        step = training.make_flow_train_step(mesh_dp, cfm_cfg, dec)
        want = _want(flash_attention=n_tblocks, flash_attention_bwd_dq=n_tblocks,
                     flash_attention_bwd_dkv=n_tblocks)
        dp_s = []
        for i in range(2):
            mesh_dp.call_all(_reset_counts)
            t0 = time.time()
            st, m = step(st, draws[i], fbatch)
            torch.cuda.synchronize()
            dp_s.append(time.time() - t0)
            for r, c in enumerate(mesh_dp.call_all(_counts)):
                if c != want:
                    raise AssertionError(f"flow dp = 2 step {i} rank {r}: launches {c}, "
                                         f"want {want}")
                launches[f"train_mesh_flow_dp2_rank{r}"] = c
            if i == 0:
                loss_dp = float(m["loss"])
                worst, worst_path = _worst_grad("flow dp = 2 against one process", {
                    path: x.grad for path, x in _leaves(st.params)}, g_one)
        loss_err = abs(loss_dp - loss_one) / abs(loss_one)
        if not (np.isfinite(loss_dp) and loss_err <= TRAIN_LOSS_TOL):
            raise AssertionError(f"flow dp = 2 loss {loss_dp} against one process {loss_one}")
        log("train_mesh_flow_dp2", rows=rows, rows_a_rank=rows // 2, frames=frames,
            loss=f"{loss_dp:.8f}", loss_rel_err=f"{loss_err:.3e}", loss_limit=TRAIN_LOSS_TOL,
            worst_grad_err_over_norm=f"{worst:.3e}", worst_leaf=worst_path,
            grad_limit=TRAIN_GRAD_TOL, launches_a_step_a_rank=f"K3 {n_tblocks}, K3b-dq "
            f"{n_tblocks}, K3b-dkv {n_tblocks}", dp2_ms=_ms(dp_s), one_process_ms=_ms(one_s),
            state_placement_s=f"{place_s:.3f}", part_s=f"{time.time() - t_part:.1f}", note=note,
            card=repr(card))
        del st, step, g_one, flow0, fbatch
        mesh_dp.call_all(_rank_free)

        # (c) the T3 step at tp = 2 and at dp = 2
        t_part = time.time()
        cfg = ChatterboxConfig().t3
        batch = _t3_train_batch(cfg)
        params0 = t3.init(L.Init(0), cfg)               # on the card
        one = training.init_t3_train_state(params0)
        step1 = training.make_t3_train_step(None, cfg, remat=True)
        one_s = []
        for i in range(2):
            t0 = time.time()
            one, m1 = step1(one, batch)
            torch.cuda.synchronize()
            one_s.append(time.time() - t0)
            if i == 0:
                loss_one = float(m1["loss"])
                ref_tree = mesh_lib._tree_map(lambda x: x.detach().clone(), one.params)
                ref_grads = mesh_lib._tree_map(lambda x: x.grad.clone(), one.params)
        del one, step1
        _rank_free()
        spec = parallel.t3_param_spec(params0)
        split = {path for path, tp in _leaves(mesh_lib._tree_map(lambda s: "tp" in s, spec)) if tp}
        for name, mesh in (("tp2", parallel.make_tp_mesh(2, device=dev)),
                           ("dp2", parallel.make_dp_mesh(2, device=dev))):
            t0 = time.time()
            st = training.shard_t3_state(training.init_t3_train_state(params0), mesh)
            torch.cuda.synchronize()
            place_s = time.time() - t0
            step = training.make_t3_train_step(mesh, cfg, remat=True)
            mesh.call_all(_reset_counts)
            ms = []
            for i in range(2):
                t0 = time.time()
                st, m = step(st, batch)
                torch.cuda.synchronize()
                ms.append(time.time() - t0)
                if i == 0:
                    loss = float(m["loss"])
            for r, c in enumerate(mesh.call_all(_counts)):
                if c != _want():
                    raise AssertionError(f"T3 {name} rank {r} launched kernels: {c}")
            loss_err = abs(loss - loss_one) / abs(loss_one)
            if not (np.isfinite(loss) and loss_err <= TRAIN_LOSS_TOL):
                raise AssertionError(f"T3 {name} loss {loss} against one process {loss_one}")
            paths = [path for path, _ in _leaves(st.params) if path not in split or name == "dp2"]
            sums = mesh.call_all(_leaf_checksums, st.params, paths)
            differ = [p for p, a, b in zip(paths, sums[0], sums[1]) if a != b]
            if differ:
                raise AssertionError(f"T3 {name}: replicated leaves differ across ranks: {differ}")
            log(f"train_mesh_t3_{name}", rows=len(TRAIN_T3_TEXT), remat=True, loss=f"{loss:.8f}",
                loss_rel_err=f"{loss_err:.3e}", loss_limit=TRAIN_LOSS_TOL,
                replicated_leaves_bit_equal=len(paths), ms=_ms(ms), one_process_ms=_ms(one_s),
                state_placement_s=f"{place_s:.3f}", part_s=f"{time.time() - t_part:.1f}",
                note=note, card=repr(card))
            t_part = time.time()
            del st, step
            mesh.call_all(_rank_free)

        # (d) pp = 2: 15 layers a stage, TRAIN_MESH_MICRO microbatches; one
        # process's step laid out as the ranks' trees, to check on each rank
        t_part = time.time()
        mesh_pp = pipeline.make_pp_mesh(2, device=dev)
        ref = pipeline.shard_pp_params(pipeline.stack_t3_for_pipeline(ref_tree, 2), mesh_pp)
        ref_g = pipeline.shard_pp_params(pipeline.stack_t3_for_pipeline(ref_grads, 2), mesh_pp)
        del ref_tree, ref_grads
        t0 = time.time()
        sharded = pipeline.shard_pp_params(pipeline.stack_t3_for_pipeline(params0, 2), mesh_pp)
        step, init_state = pipeline.make_pp_train_step(mesh_pp, TRAIN_MESH_MICRO, cfg)
        st = init_state(sharded)
        torch.cuda.synchronize()
        place_s = time.time() - t0
        del sharded, params0
        mesh_pp.call_all(_reset_counts)
        t0 = time.time()
        st, m = step(st, batch)
        torch.cuda.synchronize()
        pp_s = time.time() - t0
        for r, c in enumerate(mesh_pp.call_all(_counts)):
            if c != _want():
                raise AssertionError(f"T3 pp = 2 rank {r} launched kernels: {c}")
        loss = float(m["loss"])
        loss_err = abs(loss - loss_one) / abs(loss_one)
        if not (np.isfinite(loss) and loss_err <= TRAIN_LOSS_TOL):
            raise AssertionError(f"T3 pp = 2 loss {loss} against one process {loss_one}")
        checks = mesh_pp.call_all(_pp_check, st.params, ref, ref_g)
        for r, c in enumerate(checks):
            if not (c["grad_ratio"] <= TRAIN_GRAD_TOL and c["param_diff"] <= TRAIN_MESH_PARAM_TOL):
                raise AssertionError(f"T3 pp = 2 rank {r} against one process's step: {c}")
        t_len = 2 + cfg.perceiver_num_queries + max(TRAIN_T3_TEXT) + max(TRAIN_T3_SPEECH)
        hop_shape = (len(TRAIN_T3_TEXT) // TRAIN_MESH_MICRO, t_len, cfg.llama.hidden_size)
        hop = mesh_pp.call_all(_hop_ms, mesh_pp, hop_shape)
        log("train_mesh_t3_pp2", stages=2, layers_a_stage=cfg.llama.num_layers // 2,
            microbatches=TRAIN_MESH_MICRO, loss=f"{loss:.8f}", loss_rel_err=f"{loss_err:.3e}",
            loss_limit=TRAIN_LOSS_TOL,
            worst_grad_err_over_norm=",".join(f"{c['grad_ratio']:.3e}" for c in checks),
            worst_grad_leaf=",".join(c["grad_leaf"] for c in checks), grad_limit=TRAIN_GRAD_TOL,
            param_max_abs_diff=",".join(f"{c['param_diff']:.3e}" for c in checks),
            param_limit=TRAIN_MESH_PARAM_TOL, grad_floor=TRAIN_MESH_GRAD_FLOOR,
            elements_below_floor=",".join(str(c["below_floor"]) for c in checks),
            their_max_abs_diff=",".join(f"{c['below_floor_diff']:.3e}" for c in checks),
            ms=f"{1e3 * pp_s:.3f}", one_process_ms=_ms(one_s),
            hop_ms=",".join(f"{x:.4f}" for x in hop), hop_shape=hop_shape,
            hops_a_step=2 * TRAIN_MESH_MICRO, state_placement_s=f"{place_s:.3f}",
            part_s=f"{time.time() - t_part:.1f}", note=note, card=repr(card))
        del st, step, ref, ref_g
        mesh_pp.call_all(_rank_free)
    finally:
        parallel.shutdown()
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# int8 (ROADMAP item 22)
# ---------------------------------------------------------------------------

def _quantized(shape, g):
    """An int8 cache's slabs and fp32 scales, quantised as the model writes
    them (models/llama.quantize_kv) from normal rows, each row times a
    factor in [0.5, 1.5) so that a scale in the wrong slot shows."""
    from chatterbox_embed_tpu_torch.models.llama import quantize_kv
    x = torch.randn(shape, generator=g, device="cuda")
    x = x * (0.5 + torch.rand(shape[:-1] + (1,), generator=g, device="cuda"))
    return quantize_kv(x)


def _int8_work(b: int, h: int, d: int, start: int, pos: int, hole, deferred: bool):
    """(bytes, operations) of one int8-entry call on these inputs: each live
    cache key's int8 k and v rows and their two fp32 scales a head, q and
    out in bf16, and with the deferred entry the current row's bf16 k and
    v; the operations as K1's."""
    _, ops = _decode_work(b, h, d, start, pos, hole, deferred)
    keys = ops // (4 * h * d)
    cur = b if deferred else 0
    return (keys - cur) * h * (2 * d + 8) + 2 * (2 * b * h * d) + cur * 2 * 2 * h * d, ops


def phase_int8_kernel_check(card: str, deferred: bool = False) -> dict:
    """K1's int8 entry (with `deferred`, K1s's: a DEFER_LAYERS-layer stacked
    cache, a layer index and the current bf16/fp32 row folded in) against
    decode_attention_reference on the same int8 cache and scales, at each
    (B, H) of KERNEL_BH (K1s: INT8_DEFER_BH) and Lc of KERNEL_LC, INT8_CASES
    with and without holes, fp32 and bf16 q; a planted fault (both scale
    planes rolled by one slot) on the reported shape must read above the
    limit. Timed in bf16 at the decode step's shape beside bf16 K1 (K1s)
    on the same shape and, for K1, beside "dequantise + SDPA" (two calls,
    so no library time): K1s at B=2, Lc 512; K1 at B=16, Lc 512 (the
    batch) and Lc 1280 (where its bytes bind), and with the engine's spans
    (phase_span_check(int8=True)). The timing line carries the int8
    instance's registers and resident blocks an SM."""
    from chatterbox_embed_tpu_torch.kernels import flash_decode as fd
    name = "flash_decode_int8" + ("_deferred" if deferred else "")
    g = torch.Generator(device="cuda").manual_seed(5151 if deferred else 5150)
    d = KERNEL_D
    report = (KERNEL_B if deferred else KERNEL_B_BATCH, KERNEL_LC[0])
    timed = [report] if deferred else [(KERNEL_B_BATCH, lc) for lc in KERNEL_LC]
    occupancy = fd.kernel_info(torch.bfloat16, int8=True)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    faults, timing = {}, {}
    for b, h in (INT8_DEFER_BH if deferred else KERNEL_BH):
        for lc in KERNEL_LC:
            lead = (DEFER_LAYERS,) if deferred else ()
            (k, ks), (v, vs) = (_quantized(lead + (lc, b, h, d), g) for _ in range(2))
            holes = [None, torch.tensor([[0, 0], [70, 200]], dtype=torch.int32, device="cuda")
                     if b == KERNEL_B else _batch_holes(b)]
            for dtype in (torch.float32, torch.bfloat16):
                q, kc, vc = (torch.randn((b, h, d), generator=g, device="cuda").to(dtype)
                             for _ in range(3))

                def call(fn, start, pos, hole, k_scale=ks, v_scale=vs, kk=k, vv=v):
                    layer = (start + pos) % DEFER_LAYERS
                    extra = dict(layer=layer, k_cur=kc, v_cur=vc) if deferred else {}
                    sc = {} if k_scale is None else dict(k_scale=k_scale, v_scale=v_scale)
                    return fn(q, kk, vv, pos, start, hole, **extra, **sc)

                for hole in holes:
                    for start, pos in INT8_CASES:
                        pos = lc - 1 if pos < 0 else pos
                        out = call(fd.decode_attention, start, pos, hole)
                        ref = call(fd.decode_attention_reference, start, pos, hole)
                        err = _check_err(name, out, ref, TOL[dtype],
                                         relative=dtype == torch.bfloat16, b=b, h=h, lc=lc,
                                         dtype=str(dtype)[6:], start=start, pos=pos,
                                         hole=hole is not None)
                        worst[dtype] = max(worst[dtype], err)
                if (b, lc) not in timed or h != KERNEL_H:
                    continue
                start, pos, hole = 4, min(lc - 1, 4 + (lc - 4) * 3 // 4), holes[-1]
                if (b, lc) == report:
                    rolled = [torch.roll(x, 1, dims=-3).contiguous() for x in (ks, vs)]
                    bad = call(fd.decode_attention, start, pos, hole, *rolled)
                    ref = call(fd.decode_attention_reference, start, pos, hole)
                    torch.cuda.synchronize()
                    floor = (ref.float().abs().clamp_min(1.0) if dtype == torch.bfloat16
                             else 1.0)
                    faults[dtype] = ((bad.float() - ref.float()).abs() / floor).max().item()
                    log("kernel_fault", name=name, fault="scale_planes_one_slot_off", b=b,
                        lc=lc, dtype=str(dtype)[6:], checked_err=f"{faults[dtype]:.3e}",
                        limit=TOL[dtype], caught=faults[dtype] > TOL[dtype])
                    if not faults[dtype] > TOL[dtype]:
                        raise AssertionError(f"{name}: a planted fault reads {faults[dtype]} "
                                             f"<= {TOL[dtype]}")
                if dtype != torch.bfloat16:
                    continue
                t = _timing(lambda: call(fd.decode_attention, start, pos, hole),
                            lambda: call(fd.decode_attention_reference, start, pos, hole))
                t.update(_bound(*_int8_work(b, h, d, start, pos, hole, deferred)))
                t["library_ms"] = None
                # bf16 K1 (K1s) on the same shape: the cache dequantised to bf16
                kb, vb = ((x.float() * s[..., None]).to(torch.bfloat16) for x, s in
                          ((k, ks), (v, vs)))
                t["ms_bf16_cache"] = _device_ms(
                    lambda: call(fd.decode_attention, start, pos, hole, None, None, kb, vb))
                t["bound_ms_bf16_cache"] = _bound(
                    *_decode_work(b, h, d, start, pos, hole, deferred))["bound_ms"]
                if not deferred:
                    idx = torch.arange(lc, device="cuda")[None, :]
                    live = (idx >= start) & (idx <= pos) & ~(
                        (idx >= hole[:, :1]) & (idx < hole[:, 1:2]))
                    smask, sq = live[:, None, None, :], q[:, :, None, :]

                    def dequant_sdpa():
                        kd = (k.to(torch.bfloat16) * ks[..., None].to(torch.bfloat16))
                        vd = (v.to(torch.bfloat16) * vs[..., None].to(torch.bfloat16))
                        return torch.nn.functional.scaled_dot_product_attention(
                            sq, kd.permute(1, 2, 0, 3), vd.permute(1, 2, 0, 3),
                            attn_mask=smask)
                    _check_err(name + "_dequant_sdpa", dequant_sdpa()[:, :, 0],
                               call(fd.decode_attention, start, pos, hole), TOL[dtype],
                               relative=True, b=b, lc=lc, call="dequantise_then_sdpa")
                    t["ms_dequant_sdpa"] = _device_ms(dequant_sdpa)
                timing[(b, lc)] = t
                _log_time(name, t, card, b=b, lc=lc, start=start, pos=pos, hole=True)
                log("kernel_time_int8", name=name, b=b, lc=lc,
                    int8_ms=f"{t['ms']:.5f}", bf16_cache_ms=f"{t['ms_bf16_cache']:.5f}",
                    bound_ms=f"{t['bound_ms']:.5f}", bound_mb=f"{t['bound_bytes'] / 1e6:.2f}",
                    bf16_bound_ms=f"{t['bound_ms_bf16_cache']:.5f}",
                    dequant_sdpa_ms=(f"{t['ms_dequant_sdpa']:.5f}" if "ms_dequant_sdpa" in t
                                     else "none"), registers=occupancy["registers"],
                    local_bytes=occupancy["local_bytes"],
                    blocks_per_sm=occupancy["blocks_per_sm"], card=repr(card))
    out = {"max_abs_err": worst[torch.bfloat16], "max_abs_err_fp32": worst[torch.float32],
           "fault_err_bf16": faults[torch.bfloat16], "fault_err_fp32": faults[torch.float32],
           "timing": timing[report]}
    for b, lc in timed:
        if (b, lc) != report:
            out["timing"].update({f"{key}_lc{lc}": timing[(b, lc)][key] for key in
                                  ("ms", "bound_ms", "ms_bf16_cache", "bound_ms_bf16_cache")})
    if not deferred:
        span = phase_span_check(card, int8=True)
        out["timing"].update(ms_span=span["timing"]["ms"],
                             plain_ms_span=span["timing"]["plain_ms"],
                             bound_ms_span=span["timing"]["bound_ms"])
        out.update(max_abs_err_span=span["max_abs_err"],
                   max_abs_err_span_fp32=span["max_abs_err_fp32"])
    return out


@contextlib.contextmanager
def _params(tts, t3=None, s3gen=None, conds=None):
    """The pipeline with other T3 / S3Gen trees and conditionals for the
    block, then its own again."""
    old = tts.t3_params, tts.s3gen_params, tts.conds
    tts.t3_params = old[0] if t3 is None else t3
    tts.s3gen_params = old[1] if s3gen is None else s3gen
    tts.conds = old[2] if conds is None else conds
    try:
        yield
    finally:
        tts.t3_params, tts.s3gen_params, tts.conds = old


def _tree_bytes(tree) -> int:
    from chatterbox_embed_tpu_torch.weights import _leaves
    return sum(x.numel() * x.element_size() for _, x in _leaves(tree))


def _close(label: str, got, want, min_cos: float, max_rel: float, **case) -> tuple:
    a, b = want.double().flatten(), got.double().flatten()
    cos = float((a @ b) / (a.norm() * b.norm()))
    rel = float((a - b).norm() / a.norm())
    log("int8_close", what=label, cos=f"{cos:.6f}", rel=f"{rel:.5f}", min_cos=min_cos,
        max_rel=max_rel, **case)
    if not (cos > min_cos and rel < max_rel):
        raise AssertionError(f"{label}: cos {cos}, rel {rel}; want > {min_cos}, < {max_rel}")
    return cos, rel


def _int8_generate(tts, n_layers: int, label: str, env: dict, counter: str,
                   max_new_tokens: int = INT8_NEW_TOKENS) -> tuple:
    """tts.generate of TEXT under `env`, its wav checked and its launches
    held to `counter` = 30 x steps and nothing else of T3's. Returns
    (launches, perf)."""
    with _env(env):
        _reset_counts()
        wav = tts.generate(TEXT, max_new_tokens=max_new_tokens, cfg_weight=0.5,
                           temperature=0.7, seed=0)
        counts, perf = _counts(), dict(tts.perf)
    n_tok, steps = perf["speech_tokens"], perf["decode_steps"]
    if wav.shape != (1, 2 * n_tok * 480) or not np.isfinite(wav).all() or steps == 0:
        raise AssertionError(f"{label}: wav {wav.shape} for {n_tok} tokens")
    if counts != _want(**{counter: n_layers * steps}) or perf["use_fused"]:
        raise AssertionError(f"{label}: launches {counts}, want {counter} = {n_layers} x "
                             f"{steps}, no K4")
    return counts, perf


def phase_int8(card: str, tts) -> dict:
    """(b)-(e) of the int8 phase (module docstring) at full width with the
    pipeline's random bf16 weights and a voice made from a seed. Returns
    each path's launches."""
    from chatterbox_embed_tpu_torch import tts as tts_mod
    from chatterbox_embed_tpu_torch.models import s3gen as s3gen_mod
    from chatterbox_embed_tpu_torch.models import t3
    from chatterbox_embed_tpu_torch.utils.quantize import quantize_s3gen, quantize_t3
    cfg = tts.cfg
    n_layers = cfg.t3.llama.num_layers
    conds = _random_conds(cfg, "cuda", seed=3)
    cond = conds.t3
    launches = {}

    # (b) int8 T3 weights
    t0 = time.time()
    qt3 = quantize_t3(tts.t3_params)
    torch.cuda.synchronize()
    quant_s = time.time() - t0
    tt, lens = _text_rows(tts, [TEXT])
    kw = dict(cfg_weight=0.5, max_new_tokens=INT8_NEW_TOKENS, cfg=cfg.t3, dtype=tts.dtype,
              device=tts.device)
    fp_state, _ = t3.start_generation(tts.t3_params, cond, tt, **kw)
    q8_state, _ = t3.start_generation(qt3, cond, tt, **kw)
    _close("int8_weights_prefill_logits", q8_state.logits, fp_state.logits, INT8_LOGIT_COS,
           INT8_LOGIT_REL)
    del fp_state, q8_state
    llama_bytes = {"bf16": _tree_bytes(tts.t3_params["llama"]),
                   "int8": _tree_bytes(qt3["llama"])}
    with _params(tts, conds=conds):
        for label, params, env in (("warmup_int8", qt3, {"CHATTERBOX_FUSED_STEP": "1"}),
                                   ("bf16", None, {}),
                                   ("int8_weights", qt3, {"CHATTERBOX_FUSED_STEP": "1"})):
            with _params(tts, t3=params):
                counts, perf = _int8_generate(tts, n_layers, label, env, "flash_decode",
                                              32 if label.startswith("warmup")
                                              else INT8_NEW_TOKENS)
            if label == "bf16":
                bf16_ms = 1e3 * perf["t3_s"] / perf["decode_steps"]
        launches["int8_weights"] = counts
    ms = 1e3 * perf["t3_s"] / perf["decode_steps"]
    log("int8_weights", tokens=perf["speech_tokens"], decode_steps=perf["decode_steps"],
        fused_step_asked=True, use_fused=perf["use_fused"],
        launches=json.dumps({k: v for k, v in counts.items() if v}).replace(" ", ""),
        ms_per_step=f"{ms:.3f}", bf16_ms_per_step=f"{bf16_ms:.3f}",
        t3_s=f"{perf['t3_s']:.4f}", quantize_s=f"{quant_s:.3f}",
        llama_bytes_bf16=llama_bytes["bf16"], llama_bytes_int8=llama_bytes["int8"],
        card=repr(card))
    del qt3
    torch.cuda.empty_cache()

    # (c) int8 S3Gen: one 8-row flow_to_mel against fp
    qs3 = quantize_s3gen(tts.s3gen_params)
    rng = np.random.default_rng(8)
    u, n_tok = INT8_MEL_ROWS, INT8_MEL_TOKENS
    gen = conds.gen
    n_prompt = int(np.asarray(gen["prompt_token_len"]).reshape(-1)[0])
    toks = torch.tensor(rng.integers(0, 6561, (u, n_tok)), dtype=torch.int64, device="cuda")
    tok_len = torch.tensor(n_prompt + n_tok - 10 * np.arange(u), dtype=torch.int64,
                           device="cuda")
    prompt = (torch.as_tensor(np.asarray(gen["prompt_token"]), device="cuda").expand(u, -1),
              torch.as_tensor(np.asarray(gen["prompt_feat"]), dtype=torch.float32,
                              device="cuda").expand(u, -1, -1),
              torch.as_tensor(np.asarray(gen["embedding"]), dtype=torch.float32,
                              device="cuda").expand(u, -1))
    stride, cfg_steps = tts_mod._derive_cfm_cache(u), tts_mod._derive_cfm_cfg_steps()
    mels = {}
    for label, params in (("fp", tts.s3gen_params), ("int8", qs3)):
        _reset_counts()
        t0 = time.time()
        with torch.no_grad():
            mels[label] = s3gen_mod.flow_to_mel(
                params, toks, tok_len, *prompt, cfg=cfg.s3gen, dtype=tts.dtype,
                cache_every=stride, cfg_steps=cfg_steps).float()
        torch.cuda.synchronize()
        secs = time.time() - t0
    counts = _counts()
    want = _want(**_s3gen_launches(cfg, dict(cfm_cache_every=stride, s3gen_dispatches=1)))
    if counts != want or not torch.isfinite(mels["int8"]).all():
        raise AssertionError(f"int8 S3Gen: launches {counts}, want {want}")
    launches["int8_s3gen"] = counts
    _close("int8_s3gen_mel", mels["int8"], mels["fp"], INT8_MEL_COS, INT8_MEL_REL, rows=u,
           tokens=n_tok)
    log("int8_s3gen", rows=u, tokens=n_tok, cfm_stride=stride, flow_s=f"{secs:.4f}",
        launches=json.dumps({k: v for k, v in counts.items() if v}).replace(" ", ""),
        flow_bytes_fp=_tree_bytes(tts.s3gen_params["flow"]),
        flow_bytes_int8=_tree_bytes(qs3["flow"]), card=repr(card))
    del qs3, mels
    torch.cuda.empty_cache()

    # (d) the int8 KV cache: generate_batch of the 8 texts, then the deferred insert
    tt, lens = _text_rows(tts, TEXTS)
    kw = dict(cfg_weight=0.5, max_new_tokens=BATCH_KW["max_new_tokens"], text_lens=lens,
              cfg=cfg.t3, dtype=tts.dtype, device=tts.device)
    states = {}
    for mode in ("0", "1"):
        with _env({"CHATTERBOX_INT8_KV": mode}):
            states[mode], info = t3.start_generation(tts.t3_params, cond, tt, **kw)
    _close("int8_cache_prefill_logits", states["1"].logits, states["0"].logits,
           INT8_LOGIT_COS, INT8_LOGIT_REL)
    cache_bytes = {m: sum(x.numel() * x.element_size() for x in st.cache if x is not None)
                   for m, st in states.items()}
    total = info["cache_total"]
    del states
    per_row = t3.kv_bytes_per_token_row(cfg.t3, kv_int8=True)
    free = t3.free_device_bytes("cuda")
    cap_utt = t3.max_decode_utterances(total, cfg=cfg.t3, free_bytes=free, kv_int8=True)
    with _env({"CHATTERBOX_INT8_KV": "1"}):
        _reset_counts()
        wavs = tts.generate_batch(TEXTS, conds=conds, **BATCH_KW)
        counts, perf = _counts(), dict(tts.perf)
        info = dict(t3.LAST_GENERATION_INFO)
    steps = perf["decode_steps"]
    for i, (w, n) in enumerate(zip(wavs, perf["row_tokens"])):
        if w.shape != (2 * n * 480,) or n == 0 or not np.isfinite(w).all():
            raise AssertionError(f"int8 cache: row {i} wav {w.shape}, {n} tokens")
    want = _want(flash_decode_int8=n_layers * steps, **_s3gen_launches(cfg, perf))
    if counts != want or not info["kv_int8"] or steps == 0:
        raise AssertionError(f"int8 cache: launches {counts}, want {want}, info {info}")
    launches["int8_cache"] = counts
    log("int8_cache", utterances=len(wavs), decode_steps=steps, kv_int8=info["kv_int8"],
        phase_totals=info["phase_totals"],
        launches=json.dumps({k: v for k, v in counts.items() if v}).replace(" ", ""),
        t3_s=f"{perf['t3_s']:.4f}", ms_per_step=f"{1e3 * perf['t3_s'] / steps:.3f}",
        s3gen_s=f"{perf['s3gen_s']:.4f}", cache_bytes_int8=cache_bytes["1"],
        cache_bytes_bf16=cache_bytes["0"], cache_total=total,
        bytes_per_token_row_int8=per_row,
        bytes_per_token_row_bf16=t3.kv_bytes_per_token_row(cfg.t3, tts.dtype),
        max_decode_utterances_int8=t3.max_decode_utterances(kv_int8=True),
        fence_utterances_at_capacity=cap_utt, free_bytes=free,
        fence_bytes=int(free * t3.KV_FENCE_FRACTION), card=repr(card))
    with _params(tts, conds=conds):
        counts, perf = _int8_generate(
            tts, n_layers, "int8_cache_defer",
            {"CHATTERBOX_INT8_KV": "1", "CHATTERBOX_DEFER_KV": "1"},
            "flash_decode_int8_deferred", INT8_DEFER_TOKENS)
    launches["int8_defer"] = counts
    log("int8_cache_defer", tokens=perf["speech_tokens"], decode_steps=perf["decode_steps"],
        launches=json.dumps({k: v for k, v in counts.items() if v}).replace(" ", ""),
        ms_per_step=f"{1e3 * perf['t3_s'] / perf['decode_steps']:.3f}", card=repr(card))

    # (e) the engine at kv_int8=True
    from chatterbox_embed_tpu_torch.config import SPEECH_VOCAB_SIZE
    requests = [dict(text=t, conds=conds, seed=i, temperature=0.8, cfg_weight=0.5,
                     max_new_tokens=lim)
                for i, (t, lim) in enumerate(zip(ENGINE_TEXTS, INT8_ENGINE_LIMITS))]
    _reset_counts()
    run = _serve_engine(tts, requests, INT8_ENGINE_GEO)
    counts, dec = _counts(), run["decoder"]
    steps = dec.steps_run
    if (counts != _want(flash_decode_int8=n_layers * steps, **{
            k: counts[k] for k in ("rel_attention", "flash_attention")})
            or steps == 0 or dec.state.cache.k.dtype != torch.int8):
        raise AssertionError(f"int8 engine: launches {counts}, {steps} steps")
    for rid, req in zip(run["rids"], requests):
        toks, w = run["completions"][rid], run["wavs"][rid]
        n = int((toks < SPEECH_VOCAB_SIZE).sum())
        if len(toks) > req["max_new_tokens"] or n == 0 or w.shape != (2 * n * 480,) \
                or not np.isfinite(w).all():
            raise AssertionError(f"int8 engine request {rid}: {len(toks)} tokens, wav {w.shape}")
    rid = run["rids"][INT8_ENGINE_ALONE]
    step0, slot = run["joined"][rid]
    alone = _serve_engine(tts, [requests[INT8_ENGINE_ALONE]], INT8_ENGINE_GEO,
                          start_step=step0)
    got, want_toks = alone["completions"][alone["rids"][0]], run["completions"][rid]
    if not np.array_equal(got, want_toks):
        raise AssertionError(f"int8 engine: request {INT8_ENGINE_ALONE} alone gives other "
                             f"tokens ({len(got)} against {len(want_toks)})")
    launches["int8_engine"] = counts
    log("int8_engine", requests=len(requests), slots=dec.slots, steps=steps,
        ms_per_step=f"{1e3 * dec.t_decode / steps:.3f}", wall_s=f"{run['wall_s']:.4f}",
        alone_request=INT8_ENGINE_ALONE, joined_at=step0, slot_in_traffic=slot,
        alone_equal=True,
        launches=json.dumps({k: v for k, v in counts.items() if v}).replace(" ", ""),
        card=repr(card))
    torch.cuda.empty_cache()
    return launches


# the path whose launch count each kernel's JSON entry reports: the
# streamed request for K1 and K4, the paths that run the others, and for the
# two probe kernels their probe's entry point
MAIN_PATH = {"flash_decode": "stream_generate", "flash_decode_deferred": "generate_defer",
             "rel_attention": "generate_batch", "flash_attention": "generate_batch",
             "flash_attention_bwd_dq": "train_flow", "flash_attention_bwd_dkv": "train_flow",
             "fused_decode": "stream_generate_fused_step",
             "flash_decode_int8": "int8_cache", "flash_decode_int8_deferred": "int8_defer",
             "weight_stream": "probe_weight_stream", "decode_anatomy": "probe_decode_anatomy"}
REPLACES = {"flash_decode": "chatterbox_embed_tpu/kernels/flash_decode.py:85",
            "flash_decode_deferred": "chatterbox_embed_tpu/kernels/flash_decode.py:169",
            "rel_attention": "chatterbox_embed_tpu/kernels/rel_attention.py:45",
            "flash_attention": "chatterbox_embed_tpu/models/layers.py:395",
            # the stock op's backward, jax 0.9.0 (site-packages)
            "flash_attention_bwd_dq": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287",
            "flash_attention_bwd_dkv": "jax/experimental/pallas/ops/tpu/flash_attention.py:941",
            "fused_decode": "chatterbox_embed_tpu/kernels/fused_decode.py:111",
            # no TPU kernel: the JAX package reads its int8 cache in XLA
            # (mode 1, the scales factored out of both dots)
            "flash_decode_int8": "chatterbox_embed_tpu/models/llama.py:416",
            "flash_decode_int8_deferred": "chatterbox_embed_tpu/models/llama.py:416",
            "weight_stream": "scripts/microbench_weight_stream.py:39",
            "decode_anatomy": "scripts/microbench_decode_anatomy.py:40"}


# the phases `--phases` selects among, in the order they run (the device
# and build phases always run; every phase runs when none is named)
PHASES = ("kernel_check", "attention_check", "probe_check", "probes", "fused_check",
          "consistency", "generate", "generate_batch", "stream_generate", "first_chunk",
          "conditioning", "long_text", "engine", "worker", "mesh", "int8", "train",
          "train_mesh")
MODEL_PHASES = ("fused_check", "consistency", "generate", "generate_batch",
                "stream_generate", "first_chunk", "conditioning", "long_text", "engine",
                "worker", "mesh", "int8")


def _selected(argv) -> set:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one card.")
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run (default: all): " + ",".join(PHASES))
    args = ap.parse_args(argv)
    if args.phases is None:
        return set(PHASES)
    chosen = {p.strip() for p in args.phases.split(",") if p.strip()}
    unknown = sorted(chosen - set(PHASES))
    if unknown or not chosen:
        ap.error(f"unknown phases {unknown}; choose from {','.join(PHASES)}")
    return chosen


def main(argv=None) -> None:
    import sys
    selected = _selected(sys.argv[1:] if argv is None else argv)
    started = [time.time(), time.time()]

    def phase_done(name: str) -> None:
        """One line with the seconds the phase took and the seconds so far."""
        torch.cuda.synchronize()
        now = time.time()
        log("phase_time", name=name, seconds=f"{now - started[1]:.1f}",
            since_start=f"{now - started[0]:.1f}")
        started[1] = now

    card = phase_device()
    phase_build()
    phase_done("build")
    check, launches = {}, {}
    if "kernel_check" in selected:
        check = {"flash_decode": phase_kernel_check(card),
                 "flash_decode_deferred": phase_kernel_check(card, deferred=True)}
        phase_done("kernel_check_k1_k1s")
    if "attention_check" in selected:
        check.update(phase_attention_check(card))
        phase_done("kernel_check_k2_k3_k3b")
    if "probe_check" in selected:
        check.update(phase_probe_check(card))
        phase_done("kernel_check_k5_k6")
    if "probes" in selected:
        launches.update(phase_probes(card))
        phase_done("probes")

    if selected & set(MODEL_PHASES):
        from chatterbox_embed_tpu_torch.config import ChatterboxConfig
        from chatterbox_embed_tpu_torch.tts import ChatterboxTTS
        cfg = ChatterboxConfig()
        t0 = time.time()
        tts = ChatterboxTTS.from_random(seed=0, config=cfg, dtype=torch.bfloat16)   # the card
        if tts.device.type != "cuda":
            raise AssertionError(f"from_random without a device landed on {tts.device}")
        tts.conds = _random_conds(cfg, "cuda")
        torch.cuda.synchronize()
        log("model", config="ChatterboxConfig()", dtype="bfloat16",
            t3_layers=cfg.t3.llama.num_layers, d=cfg.t3.llama.hidden_size,
            init_s=f"{time.time() - t0:.2f}", text_chars=len(TEXT))
        if "fused_check" in selected:
            check["fused_decode"] = phase_fused_check(card, tts)
        phase_done("model_and_kernel_check_k4")
    if "consistency" in selected:
        phase_decode_consistency(tts)
        phase_batch_consistency(tts)
        phase_done("consistency")
    if "generate" in selected:
        perfs = {}
        for path in GEN_PATHS:
            # the deferred insert runs one pass (no warm-up): its step is the
            # default path's, host-bound, and the pass is there for its launches
            launches[f"generate_{path}"], perfs[path] = phase_generate(
                card, tts, path, ("timed",) if path == "defer" else ("warmup", "timed"))
        log("decode_step", card=repr(card), **{
            f"{path}_ms_per_step": f"{1e3 * p['t3_s'] / p['decode_steps']:.3f}"
            for path, p in perfs.items()})
        phase_done("generate")
    if "generate_batch" in selected:
        launches["generate_batch"] = phase_generate_batch(card, tts, None, "one")
        voices = [_random_conds(cfg, "cuda", n, seed) for n, seed in ((150, 1), (110, 2))]
        launches["generate_batch_multi_voice"] = phase_generate_batch(
            card, tts, [voices[i % 2] for i in range(len(TEXTS))], "two", ("timed",))
        phase_done("generate_batch")
    if "stream_generate" in selected:
        launches["stream_generate_fused_step"], _ = phase_stream(card, tts, True)
        # the default step streams one pass: the fused passes before it warmed
        # the flow windows and the vocoder, and generate warmed the K1 step
        launches["stream_generate"], _ = phase_stream(card, tts, False, ("timed",))
        phase_done("stream_generate")
    if "first_chunk" in selected:
        launches.update(phase_first_chunk(card, tts))
        phase_done("first_chunk")
    if "conditioning" in selected:
        launches["generate_audio_prompt"] = phase_conditioning(card, tts)
        phase_done("conditioning")
    if "long_text" in selected:
        launches.update(phase_long_text(card, tts))
        phase_done("long_text")
    if "engine" in selected:
        launches["engine"] = phase_engine(card, tts)
        phase_done("engine")
    if "worker" in selected:
        launches["worker"] = phase_worker(card, tts)
        phase_done("worker")
    if "mesh" in selected:
        launches.update(phase_mesh(card, tts))
        phase_done("mesh")
    if "int8" in selected:
        check["flash_decode_int8"] = phase_int8_kernel_check(card)
        check["flash_decode_int8_deferred"] = phase_int8_kernel_check(card, deferred=True)
        phase_done("int8_kernel_check")
        launches.update(phase_int8(card, tts))
        phase_done("int8")
    if selected & set(MODEL_PHASES):
        from chatterbox_embed_tpu_torch import streaming
        # each first-chunk graph holds its model and its pool: they go with
        # the pipeline
        del tts
        gc.collect()
        if len(streaming.GRAPHS):
            raise AssertionError(f"{len(streaming.GRAPHS)} first-chunk graphs outlived their "
                                 "pipeline")
        torch.cuda.empty_cache()
    if "train" in selected:
        launches.update(phase_train(card))
        phase_done("train")
    if "train_mesh" in selected:
        launches.update(phase_train_mesh(card))
        phase_done("train_mesh")
    for name, path in MAIN_PATH.items():
        if path in launches and launches[path][name] == 0:
            raise AssertionError(f"{name} was not launched on its path {path}")

    # every kernel whose check and main path ran (all of them without --phases)
    from chatterbox_embed_tpu_torch.kernels import _build
    reported = [name for name in _kernels() if name in check and MAIN_PATH[name] in launches]
    if selected == set(PHASES) and len(reported) != len(_kernels()):
        raise AssertionError(f"kernels without a check or a main-path run: "
                             f"{sorted(set(_kernels()) - set(reported))}")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": str(_kernels()[name][0].SOURCE.relative_to(_build.PKG.parent)),
        "replaces": REPLACES[name],
        "launches": launches[MAIN_PATH[name]][name],
        "launches_by_path": {p: c[name] for p, c in launches.items()},
        "max_abs_err": check[name]["max_abs_err"],
        "max_abs_err_fp32": check[name].get("max_abs_err_fp32"),
        **{key: val for key, val in check[name].items()
           if key.startswith(("max_abs_err_span", "err_vs_exact", "fault_err"))},
        "ms": check[name]["timing"]["ms"], "plain_ms": check[name]["timing"]["plain_ms"],
        "bound_ms": check[name]["timing"]["bound_ms"],
        "bound_by": check[name]["timing"]["bound_by"],
        "library_ms": check[name]["timing"]["library_ms"],
        "bound_bytes": check[name]["timing"]["bound_bytes"],
        "bound_ops": check[name]["timing"]["bound_ops"],
        "bound_peak": check[name]["timing"]["bound_peak"],
        "call_ms": check[name]["timing"]["call_ms"],
        "plain_call_ms": check[name]["timing"]["plain_call_ms"],
        # K2, K3 and K3b: the all-valid mask, both block heights or dtypes,
        # the fp32 kernel
        **{key: val for key, val in check[name]["timing"].items()
           if key.startswith(("ms_", "plain_ms_", "library_ms_", "bound_ms_"))}}
        for name in reported]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
