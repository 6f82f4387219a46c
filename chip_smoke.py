#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (long_vita_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
  1. build the seven CUDA sources from this checkout (one nvcc each, in
     parallel) and print nvcc's register/spill lines, ptxas's performance
     notes and the Hopper forward's and backward's shared memory;
  2. hold each kernel against its plain PyTorch version on the card at the
     shapes the serving and training paths give it, with stated tolerances,
     and time both with CUDA events beside the kernel's bound and the one
     PyTorch call that computes the same function: K1 the flash forward
     (also on the trainable tower's D = 64 shape and with NaN in the cache
     rows past kv_valid_len), K2 the int8 flash forward, K3 the ViT's short
     attention, K4 the one-pass
     flash backward, K5 the two-pass flash backward (its dkv and dq entry
     points; both also timed at T2's and T1's packed segment layouts beside
     their bounds), K6 the w4a16 product (five 14B shapes, 1 to 512 rows; one 14B
     matrix quantised on the card against numpy's quantisation, bit for bit);
     K2 is timed beside K1 over a bf16 cache of the same shape, K6 at 1 and
     512 rows beside torch.matmul on its dequantised weight;
  2a. context parallelism's kernels (phase_cp_kernels): K1 on a ring's
     diagonal and full chunk pairs and K4/K5 on the pair backward given the
     lse and delta, at the decoder's 40/8 heads and C = 8192 (64K tokens
     over cp 4), without and with T1's packed segments; K1 and K2 on the cp
     cache's partials against 16384-slot shards, one valid to mid-shard and
     one with no valid slot; each against its plain version;
  2b. ring (plain and window 2), Ulysses and hybrid attention over 4
     thread-ranks on the card (phase_cp_attention; parallel/comm.ThreadComm,
     the ranks threads of this process sharing the card), forward and
     backward at op level on 64K tokens, without and with T1's segments,
     each against K1 and K4/K5 over the whole unpermuted sequence (o, lse,
     dq, dk, dv);
  3. text serving: the full-width, full-depth Qwen2.5-14B decoder (random
     bf16 weights from a seeded generator; the phases after it through the
     recipe phase take its first MAIN_LAYERS (12) layers, for the run's
     time) through InferenceEngine: greedy
     generate twice, a ragged generate_batch and a sampled request, counting
     K1's launches; then the prefill's last-row logits against two plain
     references;
  4. quantized serving of the same decoder: weight_quant="int4" (greedy x2,
     the ragged batch, speculative_k=4, an exact repeat through the prefix
     cache; K6, its dequantise route and K1 counted exactly; logits against
     the same flow on K6's plain version) and weight_quant="int8" (greedy
     x2); the bf16 weights must keep their bits;
  5. multimodal serving: the same decoder with a random InternViT-300M tower
     and projector: a 64-frame video into an int8 cache, twice; a ragged
     batch of a 7-tile image and a 16-frame video into an int8 cache; the
     video into a bf16 cache; the video in pieces of 16 frames encoded up
     front and interleaved with the prefill chunks (same tokens). Launch
     counts of K1, K2 and K3 are checked against the layers and chunks the
     requests need; the video's last-row logits and its encoded features are
     held against the same flow on the plain versions;
  5b. cp serving (phase_cp_serve): the same decoder, cut to its first
     SERVE_PREFIX (2) layers since the 2-D tp geometry joined (8 since the
     pp training phase, 24 before), in an
     InferenceEngine
     over a cp mesh of 4 thread-ranks (a 65536-slot cache, 16384 a rank,
     chunk 2048): a 60000-id prompt and 16 greedy tokens with a bf16 cache,
     again with an int8 cache (K2), and a 16-frame video through the
     tile-sharded encode (K3 on each rank's 4 tiles), each against a
     one-device engine on the same weights fed the cp engine's tokens
     (every step's logits; each cp pick the one-device argmax up to a
     rounding tie);
  5c. the cp server (phase_cp_server): the same decoder, cut to its first
     SERVE_PREFIX (2) layers (8 since the pp training phase joined, 24 since
     the tp training phase), with a random tower
     behind the port's server on cp rank 0 of 4 thread-ranks, ranks 1-3 in
     follower_serve replaying its actions (the lockstep channel,
     inference/multihost.py), a 32768-slot cache (8192 a rank), chunk 2048:
     in continuous mode (4 slots, tick 4) text prompts of ~7000, 3000 and
     1500 ids, a 4-tile image and a streamed request, then a sampled one; in
     window mode a 2-row batch and a beam request. Gates: every follower's
     replay equals rank 0's results bit for bit; the HTTP answers equal an
     in-process cp pool fed the server's admissions (text and logprob
     bits); the longest prompt against the one-device engine (as 5b); K1
     and K3 launch counts exact. TTFT over HTTP, ms a decode step and the
     peak memory are printed (4 thread-ranks on one card);
  5d. tp serving (phase_tp_serve): K6 on one row into the tp-4 column
     shards (out 1280, 256, 3456, 38016) and K1 / K2 on a 2048-row chunk
     at 10/2 heads against their plain versions; then the same decoder,
     cut to its first SERVE_PREFIX (2) layers (8 since the pp training
     phase joined, 24 since the FSDP phase), over tp 4
     thread-ranks (each rank's shard a view of the
     weights, parallel/sharding.shard_params): a 5000-id prompt and 8
     greedy tokens, int8 weights (quantised once, whole) into an int8 cache
     and int4 weights, 4 tokens each, and a 4-tile image, each held step
     by step to the one-device engine fed the tp tokens (§2's gate; every
     rank the same bits); the lockstep server on the 4 ranks (3 concurrent
     requests; gates (a) and (b) as 5c); cp 2 x tp 2 on the decoder's
     first layers with a 7000-id prompt. K1, K2, K3, K6 and K6's
     dequantise route counted exactly; the phase's seconds and peak memory
     printed;
  6. the port's serving entry points on a checkpoint it writes and reads:
     the decoder with a random InternViT-300M and projector exported as a
     *_HF safetensors directory (save_hf_checkpoint) with the committed
     Qwen2 tokenizer fixture padded to Qwen2.5's ids (tokenizer_dir),
     freed, and the engine built as a user builds it,
     long_vita_tpu_torch.build_engine(dir): every tensor's bits held to its
     fingerprint, the port's own BPE reading the tokenizer files (its rate
     on a 1 MB document printed beside the nvidia-smi line); then PUT /api
     in continuous mode on a thread: a 5000-id greedy
     request equal to the in-process generate, three concurrent requests
     equal to their solo answers, a stream whose deltas concatenate, a
     beam request and a malformed one; and a 16-frame uint8 video in
     process through the native feedworker, K3 and K1. The loaded decoder
     serves the training phases; the directory stays on disk (~31 GB) for
     the recipe phase and is deleted at the end;
  7. T1, stage-1 alignment at 32K (configs/stage1_alignment.yaml's regime):
     the same decoder and a random tower and projector, text and vision
     frozen, the projector trained at lr 1e-3, full remat, through
     Trainer.train for 2 steps on one packed row of a 64-frame video, a
     16-frame video, a 7-tile image and text; the backward takes K5. The
     loss must fall, the projector move and the frozen weights stay
     bit-identical; launch counts are checked per step;
  8. T2, a trainable tower at 16K: text frozen, the tower (lr x 0.1) and
     projector trained, 2 steps on a 16-frame video, a 7-tile image and
     text; the backward takes K4 in the decoder and the tower. Then the
     trainable gradients of one step at 4096 tokens through the kernels are
     held against the same step on the plain attention, and the same gate
     must reject the step with a fault planted in the decoder's K4;
  9. the training entry point, once T1's and T2's parameters are freed:
     a corpus (text, 448-px PNG images, chats; three sources) and a YAML
     recipe (the exported directory, LoRA r 16 on q/k/v/o with lora_only, a
     frozen tower, 16K packs, logit budget 4096, remat "flash", an
     output_dir with the profiler over step 1) through
     train.build_from_recipe and Trainer.train for 3 steps, the tokenizer
     read from the exported directory. The loss of
     the first batch must fall, the base weights keep their bits, K1, K3
     and K4/K5 launch exactly as counted, the output files and the trace
     (naming K1's and K4's kernels) exist; then remat True vs "flash" and
     "dots" vs True on that batch, "vit" vs True on T2's geometry (same
     loss bits, gradients at cosine >= 0.999, K1 launches, peak memory),
     merge_lora under the logit gate, and save_lora -> load_lora bit for
     bit.
  9a. training over tp and 2-D tp (phase_tp_train), once the card is free
     (the main process holds nothing on it from here on; the phase ran
     after the tp serving phase until the 2-D tp geometry joined): K1
     forward and K4 and K5 backward at a tp-8 rank's heads ([1, 16384,
     5/1, 128], T2's packed row) against their plain versions; then the
     14B VLM at full width, the decoder cut to 4 layers, the 24-layer
     tower, written as a *_HF checkpoint directory, and
     configs/stage2_16k.yaml's settings (everything trainable, the tower
     at lr x 0.1, remat, 16384 tokens; logit budget cut to 4096) on one
     packed row with a 7-tile image, through train.build_from_recipe and
     Trainer.train: one step (the warm-up's lr-0 step; two until the 2-D
     tp geometry joined) at tp 1 (in this process), then at tp 2 in two
     gloo processes sharing this card on a row of 16383 tokens, which
     does not split over tp (rank 1's slice ends in a pad row; against a
     tp-1 reference at 16383)
     (parallel/comm.init_process_group(..., staged_device="cuda"): each
     collective's operands staged through pinned host memory), then at tp
     2 x tq 2 (the recipe's mesh {dp: 4, tp: 8} cut to {tp: 2, tq: 2}:
     every decoder weight cut over both matrix dims) in four such
     processes from the same directory on 16384 tokens (against a tp-1
     reference at 16384), each rank reading only its slices
     of the checkpoint. Gates, for each
     geometry: losses and grad_norm
     against tp 1, every rank's loss bits, the first step's gradients
     gathered from the shards against tp 1's by leaf group, a planted
     fault (the norms' tp sum removed; over tq their tq sum) that must
     fail that gate, the warm-up's lr-0 step leaving every bit, K1/K3/
     K4/K5 launches exact; bytes read, step times, the staged copies'
     share and each process's peak memory printed;
  9b. FSDP from the recipe entry (phase_fsdp_train), after the tp training
     phase: K1, K4 and K5 at the 72B's 64/8 heads on T2's packed row against
     their plain versions; then the 72B VLM (long_vita_72b()) at full width,
     the decoder cut to 2 layers, the 24-layer tower, written as a *_HF
     directory, and configs/stage2_72b_tp8fsdp8.yaml's settings (all
     trainable, the tower at lr x 0.1 with layer decay 0.9, remat, 16384
     tokens; logit budget cut to 4096) on two packed rows with a 7-tile
     image each: one step (the lr-0 step; two until the 2-D tp geometry
     joined the run) without FSDP (in this process), then dp 2
     with FSDP in two gloo processes sharing this card (host-staged
     collectives), a row a rank, each reading only its pieces. Gates:
     losses and grad_norm against the reference, every rank's loss bits,
     the first step's gradients by leaf group from the shards, two planted
     faults that must fail (grad_norm without its dp sum; the
     reduce-scatter replaced by the rank's own slice), the lr-0 step, the
     resident parameter / gradient / moment bytes and the bytes read
     against the shard arithmetic, K1/K3/K4/K5 launches exact; peak memory,
     step time and the staged bytes and seconds a step printed.
  9c. pipeline stages from the recipe entry (phase_pp_train), after the
     FSDP phase (K1, K4 and K5 at the 72B's 64/8 heads on T2's packed row
     against their plain versions: the FSDP phase's check, run once); the
     72B VLM at full width, the
     decoder cut to 4 layers, written as a *_HF directory, and
     configs/stage1_72b_tp8pp8.yaml's settings (the projector alone
     trains, remat, single-tile images; 16384 tokens, logit budget cut to
     2048 a row) on PP_ROWS rows (2; 4 until the 2-D tp geometry joined):
     2 steps without pp (in this process),
     then pp 2 in two gloo processes sharing this card (host-staged
     shifts), GPipe and then the interleaved schedule (virtual_pp 2) in the
     same processes, each stage reading its layers. Gates for each
     schedule: losses and grad_norm against the reference, every rank's
     loss bits, the first step's projector gradient, every shared leaf's
     bits equal on both stages after each step, the lr-0 step, nothing
     but the projector moving, each rank's resident and read bytes its
     stage's share, K1/K3/K4/K5 launches exact; three planted faults that
     must fail (the shift's backward sending zeros upstream; grad_norm
     without its pp sum; the shared leaves' gradients summed within a
     stage); ticks, bubble share, the bytes shifted and staged a step, the
     step times and peaks printed.

  2c. the eleventh slice, after the cp attention phases: K7 (phase_fwd_lab:
     every variant of the forward-kernel lab against its plain version at
     [1, 4096, 40/8, 128], then the lab's main path at 16K, K1 and each
     variant held to the plain version there and timed beside the library
     call and the bound, with K4 and K5 forward + backward, one backward of
     each held to the plain backward); the generic towers (phase_generic_vit:
     CLIP ViT-L/14 at 448 and SigLIP so400m at 384 written as HF
     safetensors and loaded with the port's loaders, EVA-4B at 448 from
     init_generic_vit_params, 8 tiles through K1 at D 64 and at D 72 and
     112 padded to 128 against the plain attention (EVA: its first 24
     layers so, all 63 against an f32 tower), and SigLIP's backward
     through K4/K5 against the plain one); MoE (phase_moe: the 14B's widths
     with 8 experts, top-2, cut to 4 layers: a 2048-id prompt and 8 greedy
     tokens through the engine under the logit gate, then the same decoder
     over tp 2 thread-ranks against one device, teacher-forced, routed as
     the tp engine routed; its training is phase_ep_train's);
  9d. expert parallelism (phase_ep_train), after the pp phase: the MoE VLM
     at the 14B's widths (8 experts, top-2, capacity factor E / k so that
     nothing drops), the decoder cut to 2 layers, the tower, embedding and
     head frozen, two 8192-token rows with a 7-tile image each, two steps
     (the lr-0 step, then one at lr 1e-5) through the Trainer at dp 1 (the
     reference, in this process), then at dp 2 with the experts cut over
     dp in two gloo processes sharing this card (host-staged), a row a
     rank, routed as the reference routed that row. Gates: no drop, losses
     and grad_norm against the reference, every rank's loss bits, the
     gradients by group (experts and routers included), the EP aux against
     the rows' own Switch losses and its term in the reported loss, three
     planted faults (the experts summed over dp as if replicated; grad_norm
     counting them once over dp; the aux summed over dp, not averaged), the
     lr-0 step leaving every bit and the second moving every expert stack
     and router, each rank's share of the expert bytes, K1/K3/K4 launches
     exact.
  9e. the JAX package's orbax stores (phase_orbax), after the recipe phase:
     the 14B VLM at full width, the decoder cut to ORBAX_LAYERS (2) layers,
     fully fine-tuned in bf16 (the tower frozen) from the recipe entry with
     save_interval 1 over 2 steps, each save an orbax store; a second
     build_from_recipe resumes step 1's store, every parameter, mu, nu and
     the count bit for bit against step 1's on the card, and its step-2
     loss the uninterrupted run's bits; restore_params_only
     into tp rank 0's tree reads exactly its slices; the JAX-written fixture
     (tests/data/orbax_jax_tiny: OCDBT, zstd) decodes to its arrays; the
     write and read rates in GB/s beside the nvidia-smi line; K1, K3 and
     K4/K5 launches exact.
  The multi-process training phases run their world-1 reference in this
  process (_reference; a process of its own in the CPU rehearsals);
  10. cp over NCCL (phase_cp_nccl), only where torch.cuda.device_count() >=
     2: two processes, a GPU each: ring attention forward and backward
     through autograd at 64K tokens against K1 and K4/K5 on the whole
     sequence (each rank's o and merged lse through cp_forward_check, as
     phase_cp_attention holds them), and two Trainer steps at cp 2 (full
     width, the decoder cut to 4 layers) against cp 1, the lockstep server
     at cp 2 and at tp 2 on that model (gates (a), (b)), a 16000-id
     TTFT at tp 2 over the two cards against one card, phase_tp_train
     at tp 2 over NCCL (a card a rank; on four cards also tp 2 x tq 2)
     against tp 1 under its gates, and
     phase_fsdp_train at dp 2 over NCCL (and, on four cards, at dp 2 x tp
     2), and phase_pp_train at pp 2 (on four cards also pp 2 x tp 2). On
     one GPU it prints {"phase": "cp_nccl",
     "ran": false, "devices": 1} and does nothing else. ``python3
     chip_smoke.py --nccl-only`` builds the kernels and runs this phase
     alone.

Thread-ranks share one card: their times are no multi-GPU scaling, and
autograd runs all CUDA backward work of a device on one thread, so the
cp backward runs at op level there and training over cp runs only over
NCCL processes. phase_autograd_probe, after the training phases, shows it:
two thread-ranks whose backward passes meet complete on the CPU and time
out on the card.

The card's nvidia-smi line is the first line of stdout and is repeated
before the last two, which are the kernel report and {"ok": true, "device":
{...}}. Without a CUDA device the script exits 1 and prints no result.
"""
from __future__ import annotations

import contextlib
import gc
import io
import itertools
import json
import logging
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

from long_vita_tpu_torch.benchmarks.timing import cuda_ms, queued

SEED = 0
# bf16 kernel vs the plain version: both compute logits and softmax
# statistics in f32; they differ in where p is rounded to bf16 (the kernel
# rounds exp(s - running max), the plain version exp(s - final max)) and in
# summation order, then both round o to bf16 (2^-8 relative). Two bf16
# roundings bound the output error well inside 1e-2 abs + 1e-2 rel; the f32
# lse never sees a bf16 rounding, so it gets 1e-3 absolute.
O_ATOL, O_RTOL, LSE_ATOL = 1e-2, 1e-2, 1e-3
# f32 kernel: only summation order and exp differ.
F32_ATOL = 1e-4
# solo-prefill last-row logits, kernel path vs the plain attention: 48 bf16
# layers of random weights amplify any rounding difference. On an H100 the
# plain attention alone, chunked against a cache vs one 5000-row pass, lands
# at cosine 0.9985 and a max logit move of 3.1% of the spread; the bounds
# leave room for that floor and catch a kernel that is wrong. (At 24
# layers: the kernel path at 0.9994-0.9995 against both.)
LOGIT_COS, LOGIT_SPREAD_FRAC = 0.995, 0.05
# ViT features through K3 vs through the plain attention, 24 bf16 layers of
# random weights then the projector: the two round p to bf16 at different
# points (running vs final max), which each layer carries forward; the
# bound on the relative Frobenius error and the worst row's cosine leaves
# room for that and catches a kernel that is wrong.
FEAT_REL_ERR, FEAT_ROW_COS = 0.05, 0.99
# EVA-4B's 63 post-norm layers carry that rounding further: on an H100 the
# plain bf16 path itself lands 6.3e-2 from an f32 tower (1.9e-2 at 24
# layers, 3.5e-2 at 40), and K1's path as far (6.2e-2), so the two bf16
# paths differ by 7.6e-2. EVA is held to the f32 tower: the kernel path's
# relative error at most EVA_F32_RATIO x the plain path's, worst-row cosine
# FEAT_ROW_COS (measured ratios 0.98-0.99 at 24, 40 and 63 layers).
EVA_F32_RATIO = 1.1
# EVA's widths are also held to §2's gate itself (K1 vs plain, the padded
# D 112), on the tower's first EVA_GATE_LAYERS layers, where the two bf16
# paths land 1.8e-2 from the f32 tower each on the H100.
EVA_GATE_LAYERS = 24
# bf16 backward kernel vs the plain backward: both round p and dS to bf16 at
# the same points but from f32 logits summed in another order, so a rounding
# can flip; each gradient sums thousands of such products. Held elementwise
# to GRAD_TOL x max|ref| absolute + GRAD_TOL relative (measured on the H100
# at 0.1-0.3% of max|ref|).
GRAD_TOL = 1e-2
# T2: the trainable gradients of one step through the kernels vs the same
# step on the plain attention, 48 bf16 layers of random weights: cosine of
# the flattened gradients and the relative loss difference (at the run's 12
# layers, MAIN_LAYERS, on an H100: 0.9991 sound, 0.9584 with the planted
# fault below; 0.9983 and 0.9430 at 24). Measured on an H100 at 48: sound runs 0.9948-0.9961; each
# bf16 path lands at 0.9963 against
# the same step in f32, so the gap is bf16 rounding at different points,
# amplified by 72 random layers (K4's dQ atomics in another order alone give
# 0.9998). Dropping one kv tile's dQ, or its dK and dV, in the decoder's K4
# reads 0.915-0.960, and the gate sits between. A fault in the tower's
# backward moves nothing this can see (random ViT weights give near-uniform
# attention, so dS is small); the kernel phase's elementwise check is the
# tower's guard.
TRAIN_GRAD_COS, TRAIN_LOSS_REL = 0.99, 1e-2
# phase_recipe: the trainable gradients of one step under two remat levels.
# The forward is the same computation, so the loss keeps its bits; the
# backward's K4 adds dQ by TMA reduce-adds in an order that varies between
# runs, so the gradients agree to rounding only.
REMAT_GRAD_COS = 0.999
# K6 vs its plain version: both take each int4 x bf16 product exactly and sum
# in f32 (in other orders), then round once: bf16 out within 1e-2 x max|ref|
# (a bf16 rounding is 2^-8 relative), f32 out within 1e-4 x max|ref|.
W4_BF16_TOL, W4_F32_TOL = 1e-2, 1e-4
# the 14B shapes K6 is given (in, out) and the row counts it is held at
W4_SHAPES = {
    "q_proj/o_proj": (5120, 5120), "k_proj/v_proj": (5120, 1024),
    "gate_proj/up_proj": (5120, 13824), "down_proj": (13824, 5120), "lm_head": (5120, 152064),
}
W4_ROWS = (1, 4, 64, 512)
# the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W)
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12
# entry point -> (source, the Pallas kernel it replaces)
SOURCES = {
    "flash_fwd": ("long_vita_tpu_torch/ops/csrc/flash_fwd.cu",
                  "long_vita_tpu/ops/flash_attention.py:144"),
    "flash_fwd_quant": ("long_vita_tpu_torch/ops/csrc/flash_fwd_quant.cu",
                        "long_vita_tpu/ops/flash_attention.py:261"),
    "short_attn": ("long_vita_tpu_torch/ops/csrc/short_attn.cu",
                   "long_vita_tpu/ops/flash_attention.py:1192"),
    "flash_bwd": ("long_vita_tpu_torch/ops/csrc/flash_bwd.cu",
                  "long_vita_tpu/ops/flash_attention.py:588"),
    "flash_bwd_dkv": ("long_vita_tpu_torch/ops/csrc/flash_bwd_2pass.cu",
                      "long_vita_tpu/ops/flash_attention.py:454"),
    "flash_bwd_dq": ("long_vita_tpu_torch/ops/csrc/flash_bwd_2pass.cu",
                     "long_vita_tpu/ops/flash_attention.py:530"),
    "w4_matmul": ("long_vita_tpu_torch/ops/csrc/w4_matmul.cu",
                  "long_vita_tpu/ops/quant_matmul.py:132"),
    "fwd_lab": ("long_vita_tpu_torch/ops/csrc/fwd_kernel_lab.cu",
                "benchmarks/fwd_kernel_lab.py:44"),
}


def _nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def _bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    HBM_BYTES_PER_S and the operations over BF16_FLOPS."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _counters():
    """The kernels' wrappers, whose ``launches`` count kernel launches."""
    from long_vita_tpu_torch.benchmarks import fwd_kernel_lab as lab
    from long_vita_tpu_torch.ops import flash_attention as fa
    from long_vita_tpu_torch.ops import quant_matmul as qm

    return {
        "flash_fwd": fa.flash_attention,
        "flash_fwd_quant": fa.flash_attention_quant,
        "short_attn": fa.short_attention,
        "flash_bwd": fa.flash_bwd_fused,
        "flash_bwd_dkv": fa.flash_bwd_dkv,
        "flash_bwd_dq": fa.flash_bwd_dq,
        "w4_matmul": qm.w4_matmul,
        "fwd_lab": lab.variant_flash,
    }


def _reset_counts() -> None:
    from long_vita_tpu_torch.ops import quant_matmul as qm

    for fn in _counters().values():
        fn.launches = 0
    qm.w4_matmul_dequant.calls = 0


def _read_counts() -> dict:
    """Launches of every kernel, and "w4_dequant": the calls of K6's
    dequantise route (JAX's prefill route, a torch.matmul, no kernel)."""
    from long_vita_tpu_torch.ops import quant_matmul as qm

    counts = {name: fn.launches for name, fn in _counters().items()}
    counts["w4_dequant"] = qm.w4_matmul_dequant.calls
    return counts


def phase_build() -> None:
    from long_vita_tpu_torch.benchmarks import fwd_kernel_lab  # noqa: F401  (registers K7)
    from long_vita_tpu_torch.ops import _build
    from long_vita_tpu_torch.ops import flash_attention  # noqa: F401  (registers K1-K5)
    from long_vita_tpu_torch.ops import quant_matmul  # noqa: F401  (registers K6)

    t0 = time.perf_counter()
    _build.build_registered()
    sources = _build.registered_sources()
    print(f"[build] {', '.join(sources)} built (in parallel) and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in sources:
        for line in _build.build_log(name).splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "error", "warning",
                                       "Performance Loss", "C75")):
                print(f"[build] {name}: {line.strip()}")
    for d in (128, 64):
        print(f"[build] flash_fwd_sm90.cuh: the D={d} forward (K1 bf16, and K3 at D=64) takes "
              f"{_build.load('flash_fwd').lvt_flash_fwd_smem_bytes(d)} bytes of dynamic shared "
              f"memory a block, its int8 instance (K2) "
              f"{_build.load('flash_fwd_quant').lvt_flash_fwd_quant_smem_bytes(d)}")
        bwd, dq = _build.load("flash_bwd"), _build.load("flash_bwd_2pass")
        print(f"[build] flash_bwd_sm90.cuh: at D={d} a kv-major block takes "
              f"{bwd.lvt_flash_bwd_smem_bytes(d, 1)} bytes of dynamic shared memory in K4 and "
              f"{bwd.lvt_flash_bwd_smem_bytes(d, 0)} in K5's dkv pass, a dq block "
              f"{dq.lvt_flash_bwd_dq_smem_bytes(d)}")
    lab = _build.load("fwd_kernel_lab")
    print("[build] fwd_kernel_lab.cu (K7, LabPolicy of flash_fwd_sm90.cuh): a block takes " +
          ", ".join(f"{lab.lvt_fwd_lab_smem_bytes(d, bk)} bytes at D={d}, kv tile {bk}"
                    for d, bk in ((128, 128), (128, 64), (64, 128))) +
          " of dynamic shared memory")
    w4 = _build.load("w4_matmul")
    print("[build] w4_matmul.cu: a block takes " + ", ".join(
        f"{w4.lvt_w4_matmul_smem_bytes(n)} bytes at N={n}" for n in (8, 16, 32, 64, 128))
        + " of dynamic shared memory")


def _kernel_case(name, q, k, v, *, f32=False, ref=None, **kw) -> float:
    """Run the kernel and the plain version on the same inputs (``ref``: the
    plain version's (o, lse), computed by the caller); -> max |o err|."""
    import torch

    from long_vita_tpu_torch.ops import flash_attention as fa

    before = fa.flash_attention.launches
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    if fa.flash_attention.launches != before + 1:
        raise AssertionError(f"[{name}] kernel launch count did not rise by 1")
    ref_kw = {x: kw[x] for x in kw if x not in ("q_positions", "kv_positions")}
    ro, rlse = ref if ref is not None else fa.flash_attention_reference(q, k, v, **ref_kw)
    err_o = (o.float() - ro.float()).abs()
    err_lse = (lse - rlse).abs().max().item()
    atol, rtol, latol = (F32_ATOL, F32_ATOL, F32_ATOL) if f32 else (O_ATOL, O_RTOL, LSE_ATOL)
    bound = atol + rtol * ro.float().abs()
    ok = bool((err_o <= bound).all()) and err_lse <= latol
    ok = ok and bool(torch.isfinite(o.float()).all())
    print(
        f"[kernel] {name}: max|o-ref| {err_o.max().item():.3e} "
        f"max|lse-ref| {err_lse:.3e} (tol o {atol}+{rtol}*|ref|, lse {latol}) "
        f"{'ok' if ok else 'FAIL'}"
    )
    if not ok:
        raise AssertionError(f"[{name}] kernel disagrees with the plain version")
    return err_o.max().item()


def phase_kernels() -> dict:
    import torch

    from long_vita_tpu_torch.ops import flash_attention as fa
    from long_vita_tpu_torch.ops.flash_attention import NEG_INF

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    errs = []
    # (a) the main-path shape: a 2048-row prefill chunk at offset 4096
    # against a whole 16K cache of which 6144 slots are valid
    qa = rnd(1, 2048, 40, 128)
    ka, va = rnd(1, 16384, 8, 128), rnd(1, 16384, 8, 128)
    kw_a = dict(causal=True, q_offset=4096, kv_offset=0, kv_valid_len=6144)
    errs.append(_kernel_case("(a) chunk 2048 @4096 vs cache 16384 len 6144", qa, ka, va, **kw_a))
    # (b) causal self-attention with packed segments
    qb, kb, vb = rnd(2, 4096, 40, 128), rnd(2, 4096, 8, 128), rnd(2, 4096, 8, 128)
    seg = torch.zeros(2, 4096, dtype=torch.int32, device=dev)
    seg[0, 1000:] = 1
    seg[1, 300:] = 1
    seg[1, 2500:] = 2
    errs.append(_kernel_case(
        "(b) causal 2x4096 40/8 heads, segment ids", qb, kb, vb,
        causal=True, q_segment_ids=seg, kv_segment_ids=seg,
    ))
    # (c) non-causal, D = 64, unaligned length (the ViT shape)
    qc, kc, vc = rnd(2, 1025, 16, 64), rnd(2, 1025, 16, 64), rnd(2, 1025, 16, 64)
    errs.append(_kernel_case("(c) non-causal 2x1025 16 heads D64", qc, kc, vc, causal=False))
    # (d) kv_valid_len = 0: every row is empty
    before = fa.flash_attention.launches
    od, lsed = fa.flash_attention(
        qa[:, :256], ka[:, :1024], va[:, :1024], causal=True, kv_valid_len=0,
        return_lse=True,
    )
    torch.cuda.synchronize()
    if fa.flash_attention.launches != before + 1:
        raise AssertionError("[(d)] kernel launch count did not rise by 1")
    if not (bool((od == 0).all()) and bool((lsed == NEG_INF).all())):
        raise AssertionError("[(d)] kv_valid_len=0 must give o = 0, lse = -2^30")
    print("[kernel] (d) kv_valid_len=0: o == 0 and lse == -2^30 ok")
    # (f) the trainable tower's shape: non-causal, D = 64, q/k/v strided views
    # of one [16, 1025, 3, 16, 64] qkv projection
    qf, kf, vf = rnd(16, 1025, 3, 16, 64).unbind(2)
    errs.append(_kernel_case("(f) non-causal [16, 1025, 16, 64] qkv views", qf, kf, vf,
                             causal=False))
    # (g) NaN in every cache row past kv_valid_len (TMA loads rows inside the
    # tensor as they are): none may reach o
    kg, vg = ka[:, :8192].clone(), va[:, :8192].clone()
    kg[:, 6100:] = float("nan")
    vg[:, 6100:] = float("nan")
    errs.append(_kernel_case("(g) chunk 2048 @4096, cache rows past len 6100 hold NaN",
                             qa, kg, vg, causal=True, q_offset=4096, kv_valid_len=6100))
    del kg, vg
    # (e) the float32 kernel at a small chunk-against-cache shape
    qe, ke, ve = (rnd(1, 300, 8, 128, dtype=torch.float32),
                  rnd(1, 1024, 2, 128, dtype=torch.float32),
                  rnd(1, 1024, 2, 128, dtype=torch.float32))
    _kernel_case("(e) f32 chunk 300 @500 vs cache 1024 len 800", qe, ke, ve, f32=True,
                 causal=True, q_offset=500, kv_valid_len=800)

    # device time, the calls queued behind a sleep: at a sub-millisecond
    # kernel the wrapper's host work (checks, tensor maps, the meta scalars)
    # would show in events around each call
    kern_ms, host_ms = queued([lambda: fa.flash_attention(qa, ka, va, **kw_a)], reps=20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_reference(qa, ka, va, **kw_a), reps=5)
    pairs = sum(i + 1 for i in range(4096, 4096 + 2048))  # unmasked (q, k) pairs
    tflops = 4 * 40 * 128 * pairs / (kern_ms * 1e-3) / 1e12
    # bytes: q and o, the 6144 valid rows of k and v, lse
    bound = _bound(2 * 2 * qa.numel() + 2 * 2 * 6144 * 8 * 128 + 4 * 2048 * 40,
                   4 * 40 * 128 * pairs)
    lib_ms = _sdpa_ms(qa, ka[:, :6144], va[:, :6144], lower_right=True)
    print(
        f"[kernel] (a) timing: kernel {kern_ms:.3f} ms (queued) "
        f"({tflops:.1f} TFLOP/s on unmasked pairs), the wrapper's host time "
        f"{host_ms * 1e3:.1f} us a call, plain {plain_ms:.3f} ms, bound "
        f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}), F.scaled_dot_product_attention "
        f"(lower-right causal, kv repeated to 40 heads) {lib_ms:.3f} ms"
    )
    return {"max_abs_err": max(errs), "ms": kern_ms, "plain_ms": plain_ms, **bound,
            "library_ms": lib_ms}


def _sdpa_ms(q, k, v, *, lower_right=False, mask=None, do=None, reps=20) -> float:
    """F.scaled_dot_product_attention's time on the same q, k, v (model
    layout [B, S, H, D]; k and v repeated to q's heads outside the timing):
    non-causal, causal aligned at the bottom right (a chunk against a
    longer cache), or with a boolean mask; with ``do``, forward and backward
    (median of CUDA events), else the forward queued as the kernels are."""
    import torch
    import torch.nn.functional as F

    g = q.shape[2] // k.shape[2]

    def heads_first(x, rep=1):
        x = x.repeat_interleave(rep, dim=2) if rep > 1 else x
        return x.transpose(1, 2).contiguous()

    qt, kt, vt = heads_first(q), heads_first(k, g), heads_first(v, g)
    if lower_right:
        from torch.nn.attention.bias import causal_lower_right

        mask = causal_lower_right(q.shape[1], k.shape[1])
    if do is None:
        return queued([lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)],
                          reps=reps)[0]
    leaves = [x.requires_grad_() for x in (qt, kt, vt)]
    dot = heads_first(do)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
        torch.autograd.grad(out, leaves, dot)

    return cuda_ms(fwd_bwd, reps=reps)


def _pair_case(name, kernel, plain, n_counter, *, lse_atol=LSE_ATOL) -> float:
    """Run a kernel (which must launch once) and its plain version on the
    same inputs; hold o to O_ATOL + O_RTOL * |plain| and lse to lse_atol.
    -> max |o err|."""
    import torch

    before = n_counter.launches
    o, lse = kernel()
    torch.cuda.synchronize()
    if n_counter.launches != before + 1:
        raise AssertionError(f"[{name}] kernel launch count did not rise by 1")
    ro, rlse = plain()
    err_o = (o.float() - ro.float()).abs()
    err_lse = (lse - rlse).abs().max().item() if lse.numel() else 0.0
    ok = bool((err_o <= O_ATOL + O_RTOL * ro.float().abs()).all()) and err_lse <= lse_atol
    ok = ok and bool(torch.isfinite(o.float()).all())
    print(f"[kernel] {name}: max|o-ref| {err_o.max().item():.3e} max|lse-ref| {err_lse:.3e} "
          f"(tol o {O_ATOL}+{O_RTOL}*|ref|, lse {lse_atol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{name}] kernel disagrees with the plain version")
    return err_o.max().item()


def phase_kernels_quant() -> dict:
    """K2 at the serving shape: a 2048-row chunk at offset 14336 against an
    int8 cache [1, 32768, 8, 128] with 16384 valid slots, codes and scales
    from quantize_kv of seeded bf16 values; with NaN in the scale rows past
    kv_valid_len; and kv_valid_len = 0. Timed beside K1 on the same shape
    over a bf16 cache (the widening's cost; not the same function)."""
    import torch

    from long_vita_tpu_torch.models.qwen2 import quantize_kv
    from long_vita_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q = rnd(1, 2048, 40, 128)
    k, ks = quantize_kv(rnd(1, 32768, 8, 128))
    v, vs = quantize_kv(rnd(1, 32768, 8, 128))
    kw = dict(q_offset=14336, kv_valid_len=16384)
    err = _pair_case(
        "K2 chunk 2048 @14336 vs int8 cache 32768 len 16384",
        lambda: fa.flash_attention_quant(q, k, ks, v, vs, return_lse=True, **kw),
        lambda: fa.flash_attention_quant_reference(q, k, ks, v, vs, **kw),
        fa.flash_attention_quant,
    )
    # NaN in every scale row past kv_valid_len: the kernel gives those rows
    # scale 0, so none may reach o
    ksn, vsn = ks[:, :20480].clone(), vs[:, :20480].clone()
    ksn[:, 16300:] = float("nan")
    vsn[:, 16300:] = float("nan")
    kw_n = dict(q_offset=14336, kv_valid_len=16300)
    err = max(err, _pair_case(
        "K2 chunk 2048 @14336, scale rows past len 16300 hold NaN",
        lambda: fa.flash_attention_quant(q, k[:, :20480], ksn, v[:, :20480], vsn, return_lse=True,
                                         **kw_n),
        lambda: fa.flash_attention_quant_reference(q, k[:, :20480], ksn, v[:, :20480], vsn, **kw_n),
        fa.flash_attention_quant,
    ))
    del ksn, vsn
    before = fa.flash_attention_quant.launches
    o0, lse0 = fa.flash_attention_quant(
        q[:, :256], k, ks, v, vs, q_offset=14336, kv_valid_len=0, return_lse=True
    )
    torch.cuda.synchronize()
    if fa.flash_attention_quant.launches != before + 1:
        raise AssertionError("[K2 kv_valid_len=0] kernel launch count did not rise by 1")
    if not (bool((o0 == 0).all()) and bool((lse0 == fa.NEG_INF).all())):
        raise AssertionError("[K2 kv_valid_len=0] must give o = 0, lse = -2^30")
    print("[kernel] K2 kv_valid_len=0: o == 0 and lse == -2^30 ok")
    # device time, the calls queued behind a sleep (as K1's)
    kern_ms = queued([lambda: fa.flash_attention_quant(q, k, ks, v, vs, **kw)], reps=20)[0]
    plain_ms = cuda_ms(lambda: fa.flash_attention_quant_reference(q, k, ks, v, vs, **kw), reps=5)
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)  # the codes as a bf16 cache
    k1_ms = queued([lambda: fa.flash_attention(q, kb, vb, causal=True, **kw)], reps=20)[0]
    del kb, vb
    pairs = 2048 * 14336 + 2048 * 2049 // 2  # unmasked (q, k) pairs
    tflops = 4 * 40 * 128 * pairs / (kern_ms * 1e-3) / 1e12
    # bytes: q and o, the 16384 valid rows of the int8 codes and their f32 scales, lse
    bound = _bound(2 * 2 * q.numel() + 2 * 16384 * 8 * (128 + 4) + 4 * 2048 * 40,
                   4 * 40 * 128 * pairs)
    print(f"[kernel] K2 timing (queued): kernel {kern_ms:.3f} ms ({tflops:.1f} TFLOP/s on "
          f"unmasked pairs), plain {plain_ms:.3f} ms, bound {bound['bound_ms']:.3f} ms "
          f"({bound['bound_by']}); K1 on the same shape over a bf16 cache {k1_ms:.3f} ms (the "
          f"widening's cost; not the same function); no PyTorch call attends over an int8 cache")
    return {"max_abs_err": err, "ms": kern_ms, "plain_ms": plain_ms, **bound, "library_ms": None,
            "k1_bf16_cache_ms": k1_ms}


def phase_kernels_short() -> dict:
    """K3 at the encode shape, q/k/v as the ViT hands them over (strided
    views of one [64, 1025, 3, 16, 64] qkv projection), and one short
    unaligned case."""
    import torch

    from long_vita_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    errs = []
    for n, s in ((64, 1025), (3, 257)):
        qkv = torch.randn((n, s, 3, 16, 64), generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = qkv.unbind(2)
        errs.append(_pair_case(
            f"K3 [{n}, {s}, 16, 64]",
            lambda: fa.short_attention(q, k, v, return_lse=True),
            lambda: fa.short_attention_reference(q, k, v),
            fa.short_attention,
        ))
        if n == 64:
            kern_ms = queued([lambda: fa.short_attention(q, k, v)], reps=20)[0]
            plain_ms = cuda_ms(lambda: fa.short_attention_reference(q, k, v), reps=5)
            lib_ms = _sdpa_ms(q, k, v)
            bound = _bound(4 * 2 * q.numel() + 4 * 64 * 16 * 1025, 4 * 64 * 16 * 1025 * 1025 * 64)
    tflops = 4 * 64 * 16 * 1025 * 1025 * 64 / (kern_ms * 1e-3) / 1e12
    print(f"[kernel] K3 timing at [64, 1025, 16, 64]: kernel {kern_ms:.3f} ms (queued; "
          f"{tflops:.1f} TFLOP/s), plain {plain_ms:.3f} ms, bound "
          f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}), F.scaled_dot_product_attention "
          f"{lib_ms:.3f} ms")
    return {"max_abs_err": max(errs), "ms": kern_ms, "plain_ms": plain_ms, **bound,
            "library_ms": lib_ms}


def _segments(b, s, cuts, dev):
    import torch

    seg = torch.zeros(b, s, dtype=torch.int32, device=dev)
    for c in cuts:
        seg[:, c:] += 1
    return seg


def _grad_errs(name, got, ref) -> list:
    """Hold each gradient to GRAD_TOL x max|ref| + GRAD_TOL x |ref|;
    -> [max |err| of dq, dk, dv]."""
    import torch

    errs, ok = [], True
    for g, r in zip(got, ref):
        err = (g.float() - r.float()).abs()
        scale = r.float().abs().max().item()
        ok = ok and bool((err <= GRAD_TOL * scale + GRAD_TOL * r.float().abs()).all())
        ok = ok and bool(torch.isfinite(g.float()).all()) and g.shape == r.shape
        errs.append(err.max().item())
    print(f"[kernel] {name}: max|d-ref| dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} "
          f"(tol {GRAD_TOL} x max|ref| + {GRAD_TOL} x |ref|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{name}] backward kernel disagrees with the plain backward")
    return errs


def _train_segments(s, videos, grid, dev, text_segments=4):
    """The segment ids [1, s] of phase_train's packed row (_train_pack's
    layout: a sample per video and image, then text samples)."""
    import numpy as np
    import torch

    from long_vita_tpu_torch.config import long_vita_14b

    pack = _train_pack(long_vita_14b(), s, [np.zeros((f, 1, 1, 3), np.float32) for f in videos],
                       [(np.zeros((1 + grid[0] * grid[1], 1, 1, 3), np.float32), grid)],
                       np.random.default_rng(SEED), text_segments=text_segments)
    return torch.from_numpy(pack.segment_ids).to(dev)[None]


def _plain_bwd_by_segment(q, k, v, o, lse, do, seg) -> tuple:
    """The plain backward of one causal row [1, S] of contiguous segments
    (each id one run of positions), a segment and a kv head's GQA group at a
    time: no pair across segments is unmasked, so each piece is the whole
    row's plain backward restricted to it, and the logits of a 16.7K-token
    segment and 5 q heads (5.6 GB in f32) fit on the card where the whole
    row's would not. -> (dq, dk, dv) as flash_attention_bwd_reference."""
    import torch

    from long_vita_tpu_torch.ops import flash_attention as fa

    ids, lens = torch.unique_consecutive(seg[0], return_counts=True)
    if q.shape[0] != 1 or len(torch.unique(ids)) != len(ids):
        raise ValueError("one batch row of contiguous segments")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    a = 0
    for n in lens.tolist():
        r = slice(a, a + n)
        dq[:, r], dk[:, r], dv[:, r] = fa.flash_attention_bwd_reference_by_group(
            q[:, r], k[:, r], v[:, r], o[:, r], lse[:, :, r], do[:, r])
        a += n
    return dq, dk, dv


def _plain_fwd_by_segment(q, k, v, seg) -> tuple:
    """The plain forward of one causal row [1, S] of contiguous segments, a
    segment and a kv head's GQA group at a time (as _plain_bwd_by_segment:
    the whole row's logits at the 72B's 64 heads would take 64 GiB). ->
    (o [1, S, Hq, D] f32, lse [1, Hq, S]) as flash_attention_reference."""
    import torch

    from long_vita_tpu_torch.ops import flash_attention as fa

    ids, lens = torch.unique_consecutive(seg[0], return_counts=True)
    if q.shape[0] != 1 or len(torch.unique(ids)) != len(ids):
        raise ValueError("one batch row of contiguous segments")
    hq, hkv = q.shape[2], k.shape[2]
    grp = hq // hkv
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((1, hq, q.shape[1]), dtype=torch.float32, device=q.device)
    a = 0
    for n in lens.tolist():
        r = slice(a, a + n)
        for g in range(hkv):
            hs = slice(g * grp, (g + 1) * grp)
            ro, rl = fa.flash_attention_reference(q[:, r, hs], k[:, r, g:g + 1],
                                                  v[:, r, g:g + 1], causal=True)
            o[:, r, hs], lse[:, hs, r] = ro.float(), rl
        a += n
    return o, lse


def _bwd_bounds(q, k, seg) -> dict:
    """The backward's bounds on one causal self-attention row with
    contiguous segments: S, dP, dV, dK and dQ are 2 x D operations a (q, k)
    pair inside a segment and q head (K5's dkv pass does 4 of the 5, its dq
    pass 3); bytes: q, k, v, do, lse, delta and the ids read once, dq, dk,
    dv written once (K4's dq as f32 sums). -> (unmasked pairs, {entry: bound})."""
    import torch

    hq, d = q.shape[2], q.shape[3]
    lens = torch.unique_consecutive(seg[0], return_counts=True)[1].tolist()
    pairs = sum(n * (n + 1) // 2 for n in lens)
    ins = 2 * (2 * q.numel() + 2 * k.numel()) + 2 * 4 * q.numel() // d + 2 * 4 * seg.numel()
    dkv_bytes = 2 * 2 * k.numel()
    op = 2 * hq * d * pairs
    return pairs, {
        "flash_bwd": _bound(ins + 4 * q.numel() + dkv_bytes, 5 * op),
        "flash_bwd_dkv": _bound(ins + dkv_bytes, 4 * op),
        "flash_bwd_dq": _bound(ins + 2 * q.numel(), 3 * op),
    }


def phase_kernels_bwd() -> dict:
    """K4 and K5 against the plain backward: the decoder's training shape at
    4096 tokens ([1, 4096, 40/8, 128], causal, 3 segments; K5 called
    directly, since JAX's rule picks K4 there) and K4 at the ViT's [16, 1025,
    16, 64] non-causal. Each entry point and the plain backward timed with
    CUDA events, then K4 at 16K and K5 at 32K alone, the shapes T2 and T1
    give them, with 3 segments and with the segments of T2's and T1's packed
    rows, each beside its bound; on the packed rows the kernel is also held
    to the plain backward, computed a segment at a time."""
    import torch

    from long_vita_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    def operands(s):
        q, k, v, do = rnd(1, s, 40, 128), rnd(1, s, 8, 128), rnd(1, s, 8, 128), rnd(1, s, 40, 128)
        seg = _segments(1, s, (s // 4, 5 * s // 8), dev)
        kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        return q, k, v, o, lse, do, kw

    def run(fused, counter, entries, q, k, v, o, lse, do, **kw):
        """K4 (fused) or K5, forced whatever JAX's rule picks at the shape."""
        before = [e.launches for e in entries]
        got = fa._flash_bwd_cuda(q, k, v, o, lse, do, kw["causal"], 0, 0, k.shape[1],
                                 kw.get("q_segment_ids"), kw.get("kv_segment_ids"), fused)
        torch.cuda.synchronize()
        if [e.launches for e in entries] != [n + 1 for n in before]:
            raise AssertionError(f"[{counter}] kernel launch count did not rise by 1")
        return got

    q, k, v, o, lse, do, kw = operands(4096)
    if not fa.bwd_uses_fused(1, 4096, 4096, 40, 128, 2):
        raise AssertionError("JAX's rule takes the one-pass backward at 4096 tokens")
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
    k4 = _grad_errs("K4 [1, 4096, 40/8, 128] causal, 3 segments",
                    run(True, "K4", [fa.flash_bwd_fused], q, k, v, o, lse, do, **kw), ref)
    k5 = _grad_errs("K5 [1, 4096, 40/8, 128] causal, 3 segments",
                    run(False, "K5", [fa.flash_bwd_dkv, fa.flash_bwd_dq], q, k, v, o, lse, do, **kw),
                    ref)
    del ref
    a4 = fa.bwd_operands(q, k, v, o, lse, do, True, 0, 0, 4096, kw["q_segment_ids"],
                         kw["kv_segment_ids"], True)
    a5 = fa.bwd_operands(q, k, v, o, lse, do, True, 0, 0, 4096, kw["q_segment_ids"],
                         kw["kv_segment_ids"], False)
    k4_ms = cuda_ms(lambda: fa.flash_bwd_fused(a4), reps=10)
    dkv_ms = cuda_ms(lambda: fa.flash_bwd_dkv(a5), reps=10)
    dq_ms = cuda_ms(lambda: fa.flash_bwd_dq(a5), reps=10)
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, o, lse, do, **kw), reps=3)
    flops = 2.5 * 4 * 40 * 128 * 4096 * 4096 / 2  # fwd-equivalent x 2.5, causal half
    # the bounds count the (q, k) pairs inside the 3 segments
    seg = kw["q_segment_ids"][0]
    pairs, bounds = _bwd_bounds(q, k, kw["q_segment_ids"])
    mask = (seg[:, None] == seg[None, :]) & torch.ones(4096, 4096, dtype=torch.bool, device=dev).tril()
    lib_ms = _sdpa_ms(q, k, v, mask=mask, do=do, reps=5)
    print(f"[kernel] backward timing at [1, 4096, 40/8, 128], median of CUDA events: K4 "
          f"{k4_ms:.3f} ms ({flops / k4_ms / 1e9:.1f} TFLOP/s on the causal half), K5 dkv "
          f"{dkv_ms:.3f} + dq {dq_ms:.3f} ms, plain backward {plain_ms:.3f} ms; bounds "
          f"(operations on {pairs} unmasked pairs) K4 {bounds['flash_bwd']['bound_ms']:.3f}, dkv "
          f"{bounds['flash_bwd_dkv']['bound_ms']:.3f}, dq {bounds['flash_bwd_dq']['bound_ms']:.3f} "
          f"ms; F.scaled_dot_product_attention forward + backward (block-causal boolean mask, "
          f"kv repeated to 40 heads) {lib_ms:.3f} ms")
    del q, k, v, o, lse, do, a4, a5, mask

    qkv = rnd(16, 1025, 3, 16, 64)
    qv, kv_, vv = qkv.unbind(2)
    dov = rnd(16, 1025, 16, 64)
    ov, lsev = fa.short_attention(qv, kv_, vv, return_lse=True)
    if not fa.bwd_uses_fused(16, 1025, 1025, 16, 64, 2):
        raise AssertionError("JAX's rule takes the one-pass backward for the ViT")
    refv = fa.flash_attention_bwd_reference(qv, kv_, vv, ov, lsev, dov, causal=False)
    vit = _grad_errs("K4 [16, 1025, 16, 64] non-causal (the ViT)",
                     run(True, "K4", [fa.flash_bwd_fused], qv, kv_, vv, ov, lsev, dov,
                         causal=False), refv)
    del qkv, refv

    packed = {}  # K4 at T2's row, K5 at T1's: [max |err| of dq, dk, dv]
    for s, fused, videos in ((16384, True, (16,)), (32768, False, (64, 16))):
        if fa.bwd_uses_fused(1, s, s, 40, 128, 2) is not fused:
            raise AssertionError(f"JAX's rule at {s} tokens is not {'K4' if fused else 'K5'}")
        name, row = ("K4", "T2") if fused else ("K5", "T1")
        entries = ["flash_bwd"] if fused else ["flash_bwd_dkv", "flash_bwd_dq"]
        q, k, v, o, lse, do, kw = operands(s)
        for layout in ("3 segments", f"{row}'s packed row"):
            if layout != "3 segments":  # the same tensors, the row's segments
                seg = _train_segments(s, videos, (2, 3), dev)
                kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
                o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
                wrappers = ([fa.flash_bwd_fused] if fused
                            else [fa.flash_bwd_dkv, fa.flash_bwd_dq])
                got = run(fused, name, wrappers, q, k, v, o, lse, do, **kw)
                packed[name] = _grad_errs(f"{name} at [1, {s}, 40/8, 128] causal, {layout}", got,
                                          _plain_bwd_by_segment(q, k, v, o, lse, do, seg))
                del got
                meta = fa._device_meta(dev, 0, 0, s)
                prep_ms = cuda_ms(lambda: fa.bwd_tile_order(fa.bwd_seg_ranges(seg, seg), s, meta),
                                   reps=10)
                print(f"[kernel] {layout}: the tile ranges and grid order (bwd_seg_ranges, "
                      f"bwd_tile_order) {prep_ms:.3f} ms a backward call")
            ms = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw), reps=3)
            fwd_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, **kw), reps=3)
            pairs_s, bnd = _bwd_bounds(q, k, kw["q_segment_ids"])
            bound_ms = sum(bnd[e]["bound_ms"] for e in entries)
            by = "/".join(sorted({bnd[e]["bound_by"] for e in entries}))
            flops = 10 * 40 * 128 * pairs_s
            causal_ms = _sdpa_ms(q, k, v, mask=torch.ones(s, s, dtype=torch.bool, device=dev).tril(),
                                 do=do, reps=3) if s == 16384 and layout == "3 segments" else None
            n_seg = len(torch.unique_consecutive(kw["q_segment_ids"][0]))
            print(f"[kernel] {name} alone at [1, {s}, 40/8, 128] causal, {layout} ({n_seg} "
                  f"segments, {pairs_s} unmasked pairs): {ms:.3f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s on them), bound {bound_ms:.3f} ms ({by}); "
                  f"K1 forward {fwd_ms:.2f} ms"
                  + (f"; F.scaled_dot_product_attention forward + backward, causal without "
                     f"segments: {causal_ms:.2f} ms" if causal_ms else ""))
        del q, k, v, o, lse, do
    torch.cuda.empty_cache()
    return {
        "flash_bwd": {"max_abs_err": max(k4 + vit + packed["K4"]), "ms": k4_ms,
                      "plain_ms": plain_ms, **bounds["flash_bwd"], "library_ms": lib_ms},
        "flash_bwd_dkv": {"max_abs_err": max(k5[1:] + packed["K5"][1:]), "ms": dkv_ms,
                          "plain_ms": plain_ms, **bounds["flash_bwd_dkv"], "library_ms": lib_ms},
        "flash_bwd_dq": {"max_abs_err": max(k5[0], packed["K5"][0]), "ms": dq_ms,
                         "plain_ms": plain_ms,
                         **bounds["flash_bwd_dq"], "library_ms": lib_ms},
    }


def phase_kernels_w4() -> dict:
    """K6 against its plain version at the five 14B shapes and rows 1, 4,
    64 and 512 (bf16 out for the projections, f32 for the head), timed at 1
    and 512 rows with the plain version, torch.matmul on the dequantised
    bf16 weight (the nearest library call: JAX's route above 512 rows and
    what bf16 serving runs) and the bound. Before that, one 14B matrix
    quantised on the card must equal numpy's host quantisation bit for bit.
    -> the report entry, timed at q_proj's shape and one row, with the same
    numbers at 512 rows under "at_512_rows"."""
    import numpy as np
    import torch

    from long_vita_tpu_torch.models.quantize import quantize_kernel, quantize_kernel_int4
    from long_vita_tpu_torch.ops import quant_matmul as qm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    # the card's quantisation against numpy's, on gate_proj's matrix
    w = rnd(13824, 5120, scale=0.02)  # nn.Linear orientation [out, in]
    packed, scales = quantize_kernel_int4(w)
    q8, s8 = quantize_kernel(w)
    host = w.float().cpu().numpy()
    hp, hs = qm.quantize_int4_grouped(host.T)
    a = np.max(np.abs(host), axis=-1)
    h_scale = np.where(a > 0, a / np.float32(127.0), np.float32(1.0))
    h_q8 = np.rint(host / h_scale[:, None]).astype(np.int8)
    diff = {name: int((got.cpu().numpy() != want).sum()) for name, got, want in (
        ("int4 codes", packed, hp), ("int4 scales", scales, hs),
        ("int8 codes", q8, h_q8), ("int8 scales", s8, h_scale))}
    same = not any(diff.values())
    print(f"[w4] gate_proj [13824, 5120] bf16 quantised on the card, int4 (packed "
          f"{tuple(packed.shape)}, scales {tuple(scales.shape)}) and int8: "
          f"{'bit for bit equal to' if same else 'DIFFERS from'} numpy's host quantisation "
          f"(elements that differ: {diff})")
    if not same:
        raise AssertionError("quantisation on the card differs from the host's")
    del w, packed, scales, q8, s8, host

    errs, report = [], {}
    for name, (n_in, n_out) in W4_SHAPES.items():
        out_dtype = torch.float32 if name == "lm_head" else bf
        tol = W4_F32_TOL if out_dtype == torch.float32 else W4_BF16_TOL
        packed, scales = quantize_kernel_int4(rnd(n_out, n_in, scale=0.02))
        for rows in W4_ROWS:
            x = rnd(rows, n_in)
            before = qm.w4_matmul.launches
            got = qm.w4_matmul(x, packed, scales, out_dtype)
            torch.cuda.synchronize()
            if qm.w4_matmul.launches != before + 1:
                raise AssertionError(f"[w4 {name} rows {rows}] the kernel did not launch once")
            ref = qm.w4_matmul_reference(x, packed, scales, out_dtype)
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            again = qm.w4_matmul(x, packed, scales, out_dtype)
            ok = err <= tol * scale and bool(torch.isfinite(got).all()) and torch.equal(again, got)
            errs.append(err)
            print(f"[w4] {name} [{rows}, {n_in}] x [{n_in}, {n_out}] -> {str(out_dtype)[6:]}: "
                  f"max|k-ref| {err:.3e} (<= {tol} x max|ref| {scale:.3f}), a second call "
                  f"{'has the same bits' if torch.equal(again, got) else 'DIFFERS'} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"[w4 {name} rows {rows}] K6 disagrees with its plain version")
            if rows not in (1, 512):
                continue
            # timings: enough weight copies to keep the working set over L2
            n_bytes = packed.numel() + 4 * scales.numel()
            copies = [(packed, scales)] + [
                (packed.clone(), scales.clone()) for _ in range(-(-120_000_000 // n_bytes) - 1)
            ]
            kern_ms = queued([lambda p=p, s=s: qm.w4_matmul(x, p, s, out_dtype)
                                  for p, s in copies], reps=60)[0]
            del copies
            plain_ms = cuda_ms(lambda: qm.w4_matmul_reference(x, packed, scales, out_dtype), reps=3)
            w_deq = (qm.unpack_int4_torch(packed).reshape(n_in // 128, 128, n_out).float()
                     * scales[:, None]).reshape(n_in, n_out).to(bf)
            deqs = [w_deq] + [w_deq.clone() for _ in range(-(-120_000_000 // w_deq.nbytes) - 1)]
            if out_dtype == torch.float32:
                lib_ms = queued([lambda w=w: torch.mm(x, w, out_dtype=torch.float32)
                                     for w in deqs], reps=60)[0]
            else:
                lib_ms = queued([lambda w=w: torch.matmul(x, w) for w in deqs], reps=60)[0]
            del deqs, w_deq
            bound = _bound(2 * x.numel() + n_bytes + got.element_size() * got.numel(),
                           2 * rows * n_in * n_out)
            print(f"[w4] {name} at {rows} row(s), device time per call (queued, cold L2): "
                  f"K6 {kern_ms * 1e3:.1f} us, bound {bound['bound_ms'] * 1e3:.1f} us "
                  f"({bound['bound_by']}; {bound['bound_ms'] / kern_ms:.1%} of it), torch.matmul "
                  f"on the dequantised bf16 weight {lib_ms * 1e3:.1f} us (a reference, not the "
                  f"same function), plain version {plain_ms:.3f} ms")
            if name == "q_proj/o_proj":
                report[rows] = {"ms": kern_ms, "plain_ms": plain_ms, **bound, "library_ms": lib_ms}
        del packed, scales
    torch.cuda.empty_cache()
    return {"max_abs_err": max(errs), **report[1], "at_512_rows": report[512]}


class _Tok:
    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(int(t)) for t in ids)


# stand-in ids of the tokens the expansion inserts (<img>, <vid>, their
# context tokens, ...): any ids of the vocabulary do for random weights; 198
# is Qwen2's "\n". The <image>/<video> tags are replaced by the expansion and
# lie past the vocabulary, so no random text id is taken for one.
(IMG_START, IMG_END, IMG_CTX, VID_START, VID_END, VID_CTX, PATCH_START,
 PATCH_END, PATCH_CTX) = range(151670, 151679)
NL = 198
IMG_TAG, VID_TAG = 1_000_000, 1_000_001


class _StubMM:
    """The multimodal tokenizer's interface (expand / tokenizer.decode)
    without tokenizer files, PIL or JAX: token ids in, token ids out, and
    the tag expansion of long_vita_tpu/data/multimodal.py (_block,
    _expand_image, _expand_video) on pre-made tiles. An image is (tiles
    [1 + rows * cols, 448, 448, 3], (rows, cols)), the thumbnail first: a
    thumbnail block, then per grid row a newline and per tile a patch block.
    A video is frames [F, 448, 448, 3]: a vid_start, T context ids and a
    vid_end per frame."""

    tokenizer = _Tok()

    def __init__(self, t: int = 256):
        self.t = t

    def _block(self, ids, start, ctx, end, indices):
        import numpy as np

        ids.append(start)
        seq = np.arange(len(ids), len(ids) + self.t, dtype=np.int64)
        indices.append(np.stack([np.zeros(self.t, np.int64), seq]))
        ids.extend([ctx] * self.t)
        ids.append(end)

    def expand(self, input_ids, images=(), videos=(), max_num_frame=None):
        import types

        import numpy as np

        images, videos = list(images), list(videos)
        ids, stacks, indices = [], [], []
        for tok in input_ids:
            if tok == IMG_TAG:
                tiles, (rows, cols) = images.pop(0)
                stacks.append(tiles)
                self._block(ids, IMG_START, IMG_CTX, IMG_END, indices)
                for _ in range(rows if len(tiles) > 1 else 0):
                    ids.append(NL)
                    for _ in range(cols):
                        self._block(ids, PATCH_START, PATCH_CTX, PATCH_END, indices)
            elif tok == VID_TAG:
                frames = videos.pop(0)
                stacks.append(frames)
                for _ in range(len(frames)):
                    self._block(ids, VID_START, VID_CTX, VID_END, indices)
            else:
                ids.append(int(tok))
        if not stacks:
            return types.SimpleNamespace(input_ids=ids, images=None, image_indices=None)
        return types.SimpleNamespace(
            input_ids=ids, images=np.concatenate(stacks), image_indices=np.stack(indices, 1)
        )


def _plain_chunked_last_row(text, tc, ids, chunk, max_seq, *, feats=None,
                            indices=None, quantize=False):
    """engine.prefill's flow (chunks against a cache, then, unless the
    prompt fills its last chunk, the last row decode-style) with attention
    forced to the plain versions. With feats,
    the tile features are merged into the embeddings first, where the
    engine's per-chunk scatter puts them; quantize: an int8 cache."""
    import dataclasses

    import torch

    from long_vita_tpu_torch.models import qwen2
    from long_vita_tpu_torch.models.long_vita import merge_image_embeddings

    dev = text.embed.device
    n = len(ids)
    padded = -(-n // chunk) * chunk
    ids_t = torch.zeros((1, padded), dtype=torch.long, device=dev)
    ids_t[0, :n] = torch.as_tensor(ids, device=dev)
    embeds = qwen2.embed_tokens(text, ids_t)
    if feats is not None:
        embeds = merge_image_embeddings(embeds, feats, torch.as_tensor(indices, device=dev))
    cache = qwen2.KVCache.zeros(
        tc, 1, -(-max_seq // chunk) * chunk, device=dev, quantize=quantize
    )
    for start in range(0, padded, chunk):
        pos = start + torch.arange(chunk, device=dev)[None]
        hidden, cache = qwen2.qwen2_decoder(
            text, embeds[:, start : start + chunk], pos, tc, kv_cache=cache, attn_impl="xla"
        )
    if padded == n:
        return hidden[:, -1]
    hidden, _ = qwen2.qwen2_decoder(
        text, qwen2.embed_tokens(text, ids_t[:, n - 1 : n]),
        torch.full((1, 1), n - 1, device=dev), tc,
        kv_cache=dataclasses.replace(cache, length=n - 1), attn_impl="xla",
    )
    return hidden[:, -1]


def _text_params(cfg, dev):
    """The full Qwen2.5-14B decoder with random bf16 weights (seed SEED)."""
    import torch

    from long_vita_tpu_torch.models import qwen2

    tc = cfg.text
    t0 = time.perf_counter()
    params = qwen2.init_qwen2_params(
        torch.Generator(device=dev).manual_seed(SEED), tc, dtype=torch.bfloat16, device=dev
    )
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(
        f"[serve] Qwen2.5-14B decoder: {tc.num_hidden_layers} layers, hidden "
        f"{tc.hidden_size}, {tc.num_attention_heads}/{tc.num_key_value_heads} heads, "
        f"vocab {tc.vocab_size}; {n_params / 1e9:.3f} B random bf16 params "
        f"(seed {SEED}) built in {time.perf_counter() - t0:.1f} s"
    )
    return params


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _decode_profile(engine, prompt, tag: str, steps: int = 16) -> None:
    """Where a decode step's time goes: ``steps`` greedy decode steps after
    a prefill of ``prompt``, under torch.profiler. Prints the host's wall
    time a step, the device's busy time a step (the sum of the kernels'
    durations) and its share, kernels a step, and K6's share of the busy
    time. The profiler's own overhead inflates the wall time; the busy time
    is the device's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from long_vita_tpu_torch.inference.sampler import SamplingParams
    from long_vita_tpu_torch.models import qwen2

    cache, hidden, n = engine.prefill(prompt)
    token = qwen2.lm_head(engine.text, hidden).argmax(-1)[:, None]
    dev = token.device
    args = (torch.full((1,), n, device=dev), cache, torch.Generator(device=dev).manual_seed(0),
            SamplingParams(max_new_tokens=steps + 1), steps, torch.zeros(1, dtype=torch.bool, device=dev))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        engine._decode_run(token, *args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / steps
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6 / steps
    k6 = sum(e.time_range.elapsed_us() for e in kernels if "w4_" in e.name) / 1e6 / steps
    print(f"[{tag}] decode profile, {steps} steps: wall {wall * 1e3:.2f} ms a step under the "
          f"profiler, device busy {busy * 1e3:.2f} ms ({busy / wall:.1%}; idle "
          f"{1 - busy / wall:.1%}), {len(kernels) / steps:.0f} kernels a step, K6 "
          f"{k6 * 1e3:.2f} ms of the busy time")
    del cache


def _ttft_decode(engine, prompt, t_generate: float, n_tokens: int) -> tuple:
    """A warm prefill of ``prompt`` and its head, timed: -> (TTFT s, prefill
    s, last-row logits, decode ms/token of a generate of ``n_tokens`` tokens
    that took ``t_generate`` s)."""
    from long_vita_tpu_torch.models import qwen2

    (cache, hidden, _), t_prefill = _timed(lambda: engine.prefill(prompt))
    del cache
    logits, t_head = _timed(lambda: qwen2.lm_head(engine.text, hidden))
    ttft = t_prefill + t_head
    return ttft, t_prefill, logits, (t_generate - ttft) / (n_tokens - 1) * 1e3


def _check_launches(counts: dict, expected: dict) -> None:
    """Kernels missing from ``expected`` must not have launched."""
    expected = {**dict.fromkeys(counts, 0), **expected}
    print(f"[counts] launches {counts}, expected {expected}")
    if counts != expected:
        raise AssertionError(
            "the main path did not launch each kernel once per layer and chunk "
            "(or encode batch) it needs"
        )


def _logit_check(tag, name, logits, ref) -> bool:
    import torch.nn.functional as F

    cos = F.cosine_similarity(logits, ref, dim=-1).item()
    max_abs = (logits - ref).abs().max().item()
    spread = (ref.max() - ref.min()).item()
    good = cos >= LOGIT_COS and max_abs <= LOGIT_SPREAD_FRAC * spread
    print(f"[{tag}] last-row logits, {name}: cosine {cos:.6f} (>= {LOGIT_COS}), "
          f"max|diff| {max_abs:.4f} (<= {LOGIT_SPREAD_FRAC} x spread {spread:.3f}) "
          f"{'ok' if good else 'FAIL'}")
    return good


def phase_serving(params) -> tuple:
    """Text serving. -> (K1 launches made by the serving requests, the
    kernel path's last-row logits of the 5000-id prompt)."""
    import dataclasses

    import numpy as np
    import torch

    from long_vita_tpu_torch.config import long_vita_14b
    from long_vita_tpu_torch.inference.engine import InferenceEngine
    from long_vita_tpu_torch.inference.sampler import SamplingParams
    from long_vita_tpu_torch.models import qwen2

    base = long_vita_14b()  # at the depth of ``params``
    cfg = dataclasses.replace(base, text=dataclasses.replace(
        base.text, num_hidden_layers=len(params.layers)))
    tc = cfg.text
    dev = torch.device("cuda")
    chunk, max_seq = 2048, 16384
    engine = InferenceEngine(params, cfg, _StubMM(), max_seq_len=max_seq, chunk=chunk)
    rng = np.random.default_rng(SEED)
    vocab = tc.vocab_size
    prompt = rng.integers(0, vocab, 5000).tolist()  # not a chunk multiple
    batch = [{"input_ids": rng.integers(0, vocab, n).tolist()} for n in (700, 2100, 4000)]
    sampled_prompt = rng.integers(0, vocab, 1500).tolist()
    greedy = SamplingParams(max_new_tokens=32)

    def chunks(n):
        return -(-n // chunk)

    # ---- the main path: requests through the engine's public entry points
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    first, t_first = _timed(lambda: engine.generate(input_ids=prompt, sampling=greedy))
    again, t_again = _timed(lambda: engine.generate(input_ids=prompt, sampling=greedy))
    batched, t_batch = _timed(lambda: engine.generate_batch(
        batch, sampling=SamplingParams(max_new_tokens=16)
    ))
    sampled, _ = _timed(lambda: engine.generate(
        input_ids=sampled_prompt, seed=1,
        sampling=SamplingParams(greedy=False, temperature=0.7, top_p=0.9, max_new_tokens=16),
    ))
    counts = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_chunks = 2 * chunks(len(prompt)) + chunks(4000) + chunks(len(sampled_prompt))
    print(f"[serve] expected flash_fwd launches: {tc.num_hidden_layers} layers x "
          f"{n_chunks} prefill chunks")
    _check_launches(counts, {
        "flash_fwd": tc.num_hidden_layers * n_chunks, "flash_fwd_quant": 0, "short_attn": 0,
    })
    launches = counts["flash_fwd"]
    if first.token_ids != again.token_ids:
        raise AssertionError(f"repeat greedy generate differs: {first.token_ids} vs {again.token_ids}")
    outs = [first, again, *batched, sampled]
    if not all(r.token_ids and all(0 <= t < vocab for t in r.token_ids) for r in outs):
        raise AssertionError("empty output or token id outside [0, vocab)")
    print(f"[serve] greedy x2 identical ({len(first.token_ids)} tokens): {first.token_ids[:8]} ...")
    print(f"[serve] generate_batch 700/2100/4000 ids -> {[len(r.token_ids) for r in batched]} "
          f"tokens in {t_batch:.2f} s; sampled (T 0.7, top-p 0.9) -> {sampled.token_ids[:8]} ...")

    # ---- timings of the solo request (warm): TTFT = prefill + first token
    ttft, t_prefill, logits, decode_ms = _ttft_decode(engine, prompt, t_again, len(again.token_ids))
    print(
        f"[serve] solo 5000-id prompt, 32 greedy tokens: TTFT {ttft * 1e3:.1f} ms "
        f"(prefill {len(prompt) / t_prefill:.0f} prompt tokens/s over "
        f"{chunks(len(prompt))} chunks of {chunk}), generate {t_again:.2f} s "
        f"(first call {t_first:.2f} s), decode {decode_ms:.2f} ms/token; "
        f"peak allocated {peak_gb:.2f} GB"
    )

    # ---- the kernel path's last-row logits (engine.prefill: flash chunks,
    # then the decode-style last row) against (i) a no-cache forward of the
    # same 5000 ids through the plain attention and (ii) the same chunked
    # flow with the plain attention, which isolates the kernel
    ids = torch.as_tensor([prompt], device=dev)
    ref_hidden, _ = qwen2.qwen2_decoder(
        params, qwen2.embed_tokens(params, ids), torch.arange(len(prompt), device=dev)[None],
        tc, attn_impl="xla",
    )
    nocache = qwen2.lm_head(params, ref_hidden[:, -1])
    del ref_hidden
    chunked = qwen2.lm_head(params, _plain_chunked_last_row(params, tc, prompt, chunk, max_seq))
    ok = bool(torch.isfinite(logits).all()) and logits.shape == (1, vocab)
    for name, ref in (("plain no-cache forward", nocache), ("plain chunked prefill", chunked)):
        ok = _logit_check("serve", f"kernel path vs {name}", logits, ref) and ok
    if not ok:
        raise AssertionError("kernel-path logits disagree with the plain forward")
    _decode_profile(engine, prompt, "serve")
    return launches, logits


def _prefill_logits(params, cfg):
    """The kernel path's last-row logits of the text-serving phase's
    5000-id prompt (engine.prefill and the head, as phase_serving takes
    them) on ``params``: the bf16 logits the quantised phases are held
    to at that depth."""
    import numpy as np
    import torch

    from long_vita_tpu_torch.inference.engine import InferenceEngine
    from long_vita_tpu_torch.models import qwen2

    engine = InferenceEngine(params, cfg, _StubMM(), max_seq_len=16384, chunk=2048)
    prompt = np.random.default_rng(SEED).integers(0, cfg.text.vocab_size, 5000).tolist()
    with torch.no_grad():
        _, hidden, _ = engine.prefill(prompt)
        return qwen2.lm_head(engine.text, hidden)


def _decode_steps(results, max_new: int, budget: int, segment: int = 64) -> int:
    """Decode steps engine._decode_run takes for one generate or
    generate_batch of greedy ``results``: segments of ``segment`` steps
    (smaller powers of two for a small rest) until ``budget`` tokens, or
    until the segment in which every row has emitted a stop token (a row
    shorter than max_new stopped at its length)."""
    stops = [len(r.token_ids) - 1 if len(r.token_ids) < max_new else None for r in results]
    if budget <= 0 or all(x is not None and x < 0 for x in stops):
        return 0
    stop_at = None if any(x is None for x in stops) else max(stops)
    steps = 0
    while budget > 0:
        n = segment
        while n // 2 >= budget:
            n //= 2
        steps += n
        budget -= n
        if stop_at is not None and stop_at < steps:
            break
    return steps


def phase_int4(params, cfg, dev, bf16_logits) -> dict:
    """int4 serving (w4a16) of the text-serving decoder through
    InferenceEngine(weight_quant="int4"): the solo 5000-id prompt with 32
    greedy tokens twice, the 700 / 2100 / 4000 ragged batch,
    speculative_k=4 on a prompt that repeats a 64-id pattern, and an exact
    repeat through prefix_cache_entries=2. Launch counts of K6, its
    dequantise route and K1 are checked exactly; the last-row logits are
    held against the same flow with K6's launcher swapped for its plain
    version. -> the launch counts of the run."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from long_vita_tpu_torch.inference.engine import InferenceEngine
    from long_vita_tpu_torch.inference.prefix_cache import copy_cache
    from long_vita_tpu_torch.inference.sampler import SamplingParams
    from long_vita_tpu_torch.inference.speculative import draft_tokens
    from long_vita_tpu_torch.models import qwen2
    from long_vita_tpu_torch.ops import quant_matmul as qm

    tc = cfg.text
    chunk, max_seq, k = 2048, 16384, 4
    kw = dict(max_seq_len=max_seq, chunk=chunk)
    eng, t_quant = _timed(lambda: InferenceEngine(params, cfg, _StubMM(), weight_quant="int4", **kw))
    q_bytes = sum(m.packed.nbytes + m.scales.nbytes for m in eng.text.modules()
                  if isinstance(m, qwen2.QuantDense4))
    eng_spec = InferenceEngine(eng.params, cfg, _StubMM(), speculative_k=k, **kw)
    eng_pc = InferenceEngine(eng.params, cfg, _StubMM(), prefix_cache_entries=2, **kw)
    print(f"[int4] the decoder's 7 x {tc.num_hidden_layers} projections and head quantised on "
          f"the card in {t_quant:.1f} s: {q_bytes / 1e9:.3f} GB of packed codes and scales "
          f"(a decode step's K6 reads)")
    rng = np.random.default_rng(SEED)  # the text-serving phase's prompts
    vocab = tc.vocab_size
    prompt = rng.integers(0, vocab, 5000).tolist()
    batch = [{"input_ids": rng.integers(0, vocab, n).tolist()} for n in (700, 2100, 4000)]
    spec_prompt = rng.integers(0, vocab, 64).tolist() * 30  # 1920 ids
    greedy = SamplingParams(max_new_tokens=32)

    def chunks(n):
        return -(-n // chunk)

    # ---- the main path: requests through the engine's public entry points
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    first, t_first = _timed(lambda: eng.generate(input_ids=prompt, sampling=greedy))
    again, t_again = _timed(lambda: eng.generate(input_ids=prompt, sampling=greedy))
    batched, t_batch = _timed(lambda: eng.generate_batch(batch, sampling=SamplingParams(max_new_tokens=16)))
    spec, t_spec = _timed(lambda: eng_spec.generate(input_ids=spec_prompt, sampling=greedy))
    pc_first, _ = _timed(lambda: eng_pc.generate(input_ids=prompt, sampling=greedy))
    pc_again, t_pc = _timed(lambda: eng_pc.generate(input_ids=prompt, sampling=greedy))
    counts = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    pc = eng_pc.prefix_cache
    resumed = pc.tokens_saved  # the repeat resumes at the last chunk boundary below 4999
    n_chunks = 3 * chunks(len(prompt)) + chunks(4000) + chunks(len(spec_prompt)) + chunks(len(prompt) - resumed)
    solo_budget = min(31, max_seq - 1 - len(prompt))
    steps = (sum(_decode_steps([r], 32, solo_budget) for r in (first, again, pc_first, pc_again))
             + _decode_steps(batched, 16, min(15, max_seq - 1 - 700)))
    per_pass = 7 * tc.num_hidden_layers
    # K6: each prefill's last-row pass and its first head, each decode step
    # and each verify step (a pass and its head); the prefill chunks take
    # the dequantise route
    print(f"[int4] expected: K1 {tc.num_hidden_layers} x {n_chunks} prefill chunks (the "
          f"repeat resumed at {resumed}); the dequantise route {per_pass} x {n_chunks}; K6 "
          f"({per_pass} + 1) x (6 last rows + {steps} decode steps + {eng_spec._spec_steps} "
          f"verify steps)")
    _check_launches(counts, {
        "flash_fwd": tc.num_hidden_layers * n_chunks,
        "w4_dequant": per_pass * n_chunks,
        "w4_matmul": (per_pass + 1) * (6 + steps + eng_spec._spec_steps),
    })
    if pc.hits != 1 or resumed != 4096:
        raise AssertionError(f"the repeat did not resume at 4096 (hits {pc.hits}, saved {resumed})")
    if not (first.token_ids == again.token_ids == pc_first.token_ids == pc_again.token_ids):
        raise AssertionError(f"int4 greedy runs differ: {first.token_ids} / {again.token_ids} / "
                             f"{pc_first.token_ids} / {pc_again.token_ids}")
    outs = [first, again, *batched, spec, pc_first, pc_again]
    if not all(r.token_ids and all(0 <= t < vocab for t in r.token_ids) for r in outs):
        raise AssertionError("empty output or token id outside [0, vocab)")
    print(f"[int4] greedy x2 identical ({len(first.token_ids)} tokens): {first.token_ids[:8]} ...; "
          f"the prefix-cache repeat (resumed at {resumed}) gives the same tokens; generate_batch "
          f"700/2100/4000 -> {[len(r.token_ids) for r in batched]} tokens in {t_batch:.2f} s; "
          f"peak allocated {peak_gb:.2f} GB")

    # ---- timings (warm): TTFT, decode, the prefix hit's TTFT, speculation
    ttft, t_prefill, logits, decode_ms = _ttft_decode(eng, prompt, t_again, len(again.token_ids))
    (cache, _, _), t_hit = _timed(lambda: eng_pc.prefill(prompt))
    del cache
    print(f"[int4] solo 5000-id prompt, 32 greedy tokens: TTFT {ttft * 1e3:.1f} ms, generate "
          f"{t_again:.2f} s (first call {t_first:.2f} s), decode {decode_ms:.2f} ms/token; the "
          f"prefix-cache hit's prefill {t_hit * 1e3:.1f} ms (one chunk) against {t_prefill * 1e3:.1f} ms")

    # ---- the K6 path's last-row logits against the same flow with K6's
    # launcher swapped for its plain version (nothing else changes)
    kernel = qm._w4_cuda
    qm._w4_cuda = lambda x, p, s_, od: qm.w4_matmul_reference(x, p, s_, od)
    try:
        cache, hid_plain, _ = eng.prefill(prompt)
        plain_logits = qwen2.lm_head(eng.text, hid_plain)
    finally:
        qm._w4_cuda = kernel
    del cache
    ok = bool(torch.isfinite(logits).all()) and logits.shape == (1, vocab)
    ok = _logit_check("int4", "K6 path vs the same flow on K6's plain version", logits,
                      plain_logits) and ok
    cos_bf16 = F.cosine_similarity(logits, bf16_logits, dim=-1).item()
    print(f"[int4] (for the record, random weights) last-row logits, int4 vs bf16 weights: "
          f"cosine {cos_bf16:.6f}")

    # ---- speculation: acceptance, the first divergence from plain greedy,
    # and the verify step's row 0 against the one-row decode at its position
    emitted = len(spec.token_ids) - 1  # after the first token, which the head samples
    plain_spec = eng.generate(input_ids=spec_prompt, sampling=greedy)
    div = next((i for i, (a, b) in enumerate(zip(spec.token_ids, plain_spec.token_ids)) if a != b), None)
    print(f"[int4] speculative_k={k} on a 64-id pattern x 30: {eng_spec._spec_steps} verify steps "
          f"for {emitted} tokens ({emitted / max(eng_spec._spec_steps, 1):.2f} a step, "
          f"{emitted - eng_spec._spec_steps} drafts accepted) in {t_spec:.2f} s; against plain "
          f"greedy: {'identical' if div is None else f'first divergence at token {div}'}")
    cache, hidden, n = eng.prefill(spec_prompt)
    t0 = int(qwen2.lm_head(eng.text, hidden).argmax(-1))
    drafts = draft_tokens(np.asarray(spec_prompt + [t0]), k - 1)
    step = torch.zeros((1, k), dtype=torch.long, device=dev)
    step[0, 0] = t0
    step[0, 1:1 + len(drafts)] = torch.as_tensor(drafts, device=dev)
    verify_cache = copy_cache(cache)
    h1, _ = qwen2.qwen2_decoder(eng.text, qwen2.embed_tokens(eng.text, step[:, :1]),
                                torch.full((1, 1), n, device=dev), tc, kv_cache=cache)
    hk, _ = qwen2.qwen2_decoder(eng.text, qwen2.embed_tokens(eng.text, step),
                                n + torch.arange(k, device=dev)[None], tc, kv_cache=verify_cache)
    del cache, verify_cache
    ok = _logit_check("int4", f"the {k}-row verify step's row 0 vs the one-row decode",
                      qwen2.lm_head(eng.text, hk)[:, 0], qwen2.lm_head(eng.text, h1[:, -1])) and ok
    if not ok:
        raise AssertionError("the int4 path's logits disagree")
    _decode_profile(eng, prompt, "int4")
    del eng, eng_spec, eng_pc
    torch.cuda.empty_cache()
    return counts


def phase_int8(params, cfg, dev, bf16_logits) -> dict:
    """One weight_quant="int8" generate of the 5000-id prompt, greedy x2
    identical, with TTFT and decode ms/token. w8a16 has no kernel of its
    own (the JAX package leaves it to XLA): each product casts the int8
    codes to bf16 first. -> the launch counts of the run."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from long_vita_tpu_torch.inference.engine import InferenceEngine
    from long_vita_tpu_torch.inference.sampler import SamplingParams

    tc = cfg.text
    eng, t_quant = _timed(lambda: InferenceEngine(
        params, cfg, _StubMM(), max_seq_len=16384, chunk=2048, weight_quant="int8"))
    prompt = np.random.default_rng(SEED).integers(0, tc.vocab_size, 5000).tolist()
    greedy = SamplingParams(max_new_tokens=32)
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    first, _ = _timed(lambda: eng.generate(input_ids=prompt, sampling=greedy))
    again, t_again = _timed(lambda: eng.generate(input_ids=prompt, sampling=greedy))
    counts = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _check_launches(counts, {"flash_fwd": tc.num_hidden_layers * 2 * 3})
    if first.token_ids != again.token_ids:
        raise AssertionError(f"int8 greedy runs differ: {first.token_ids} / {again.token_ids}")
    ttft, _, logits, decode_ms = _ttft_decode(eng, prompt, t_again, len(again.token_ids))
    cos = F.cosine_similarity(logits, bf16_logits, dim=-1).item()
    print(f"[int8] weights quantised on the card in {t_quant:.1f} s; greedy x2 identical "
          f"({len(first.token_ids)} tokens): {first.token_ids[:8]} ...; TTFT {ttft * 1e3:.1f} ms, "
          f"decode {decode_ms:.2f} ms/token; peak allocated {peak_gb:.2f} GB; (for the record) "
          f"last-row logits vs bf16 weights: cosine {cos:.6f}")
    _decode_profile(eng, prompt, "int8")
    del eng
    torch.cuda.empty_cache()
    return counts


def _vlm_params(text_params, cfg, dev, seed, probe_tiles):
    """The decoder with a random InternViT-300M and projector (bf16, from
    ``seed``). A trained projector maps into the embedding space; the random
    one's rows come out ~20x the embedding table's scale, and 16K such rows
    swamp the prompt. Its second matrix is scaled so that the features of the
    probe tiles have the table's standard deviation. -> (params, scale)."""
    import torch

    from long_vita_tpu_torch.models.intern_vit import init_vit_params
    from long_vita_tpu_torch.models.long_vita import LongVITAParams, encode_images
    from long_vita_tpu_torch.models.projector import init_projector_params

    gen = torch.Generator(device=dev).manual_seed(seed)
    lv = LongVITAParams(
        text=text_params,
        vision=init_vit_params(gen, cfg.vision, torch.bfloat16, dev),
        projector=init_projector_params(gen, cfg, torch.bfloat16, dev),
    )
    with torch.no_grad():
        probe = encode_images(lv, torch.from_numpy(probe_tiles).to(dev, torch.bfloat16), cfg)
        ratio = (text_params.embed.float().std() / probe.float().std()).item()
        lv.projector.fc2.weight.mul_(ratio)
    return lv, ratio


def _encode_batches(n: int, transfer_chunk: int, vision_chunk: int) -> int:
    """ViT batches the engine's encode of n tiles runs (pieces of
    transfer_chunk tiles, padded, when n exceeds one piece)."""
    if n <= transfer_chunk:
        return -(-n // vision_chunk)
    return -(-n // transfer_chunk) * -(-transfer_chunk // vision_chunk)


def phase_multimodal(
    text_params, cfg, dev, *, n_frames=64, batch_frames=16, grid=(2, 3),
    chunk=2048, max_seq=32768, vision_chunk=64, new_tokens=16,
) -> dict:
    """Image and video serving at full width. -> launch counts of the run."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from long_vita_tpu_torch.inference.engine import InferenceEngine
    from long_vita_tpu_torch.inference.sampler import SamplingParams
    from long_vita_tpu_torch.models import qwen2
    from long_vita_tpu_torch.models.long_vita import encode_images

    vc, tc = cfg.vision, cfg.text
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)

    def tiles(n):
        return rng.standard_normal((n, vc.image_size, vc.image_size, 3), dtype=np.float32)

    lv, ratio = _vlm_params(text_params, cfg, dev, SEED + 1, tiles(2))
    n_vis = sum(p.numel() for p in lv.vision.parameters())
    n_proj = sum(p.numel() for p in lv.projector.parameters())

    def text(n):
        return rng.integers(0, 151643, n).tolist()

    video, short_video = tiles(n_frames), tiles(batch_frames)
    image = (tiles(1 + grid[0] * grid[1]), grid)
    print(f"[mm] InternViT-300M ({vc.num_hidden_layers} layers, hidden {vc.hidden_size}, "
          f"{vc.num_attention_heads} heads, {vc.seq_len} tokens a tile) {n_vis / 1e6:.1f} M and "
          f"projector {n_proj / 1e6:.1f} M random bf16 params (seed {SEED + 1}; projector "
          f"output scaled by {ratio:.4f} to the embedding table's std), seeded f32 pixels: "
          f"built in {time.perf_counter() - t0:.1f} s")

    mm = _StubMM(cfg.image_token_length)
    req_i = [*text(20), VID_TAG, *text(20)]
    reqs_ii = [
        {"input_ids": [*text(20), IMG_TAG, *text(20)], "images": [image]},
        {"input_ids": [*text(20), VID_TAG, *text(20)], "videos": [short_video]},
    ]
    x = mm.expand(req_i, videos=[video])
    n_i = len(x.input_ids)
    lens_ii = [
        len(mm.expand(r["input_ids"], r.get("images", ()), r.get("videos", ())).input_ids)
        for r in reqs_ii
    ]
    kw = dict(max_seq_len=max_seq, chunk=chunk, vision_chunk=vision_chunk)
    eng_q = InferenceEngine(lv, cfg, mm, kv_quant=True, **kw)
    eng_b = InferenceEngine(lv, cfg, mm, **kw)
    # (iv) the video again in transfer pieces of 16 frames, encoded up front
    # and interleaved with the prefill chunks
    eng_up = InferenceEngine(lv, cfg, mm, kv_quant=True, transfer_chunk=16, **kw)
    eng_il = InferenceEngine(lv, cfg, mm, kv_quant=True, transfer_chunk=16,
                             interleave_encode=True, **kw)
    greedy = SamplingParams(max_new_tokens=new_tokens)

    # ---- the main path: requests through the engine's public entry points
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    first, t_first = _timed(lambda: eng_q.generate(input_ids=req_i, videos=[video], sampling=greedy))
    again, t_again = _timed(lambda: eng_q.generate(input_ids=req_i, videos=[video], sampling=greedy))
    batched, t_batch = _timed(lambda: eng_q.generate_batch(reqs_ii, sampling=greedy))
    bf16, t_bf16 = _timed(lambda: eng_b.generate(input_ids=req_i, videos=[video], sampling=greedy))
    upfront, t_up = _timed(lambda: eng_up.generate(input_ids=req_i, videos=[video], sampling=greedy))
    interleaved, t_il = _timed(lambda: eng_il.generate(input_ids=req_i, videos=[video], sampling=greedy))
    counts = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_layers, n_vit = tc.num_hidden_layers, vc.num_hidden_layers
    tc_tiles = eng_q.transfer_chunk

    def chunks(n):
        return -(-n // chunk)

    enc_i = _encode_batches(n_frames, tc_tiles, vision_chunk)
    enc_ii = _encode_batches(1 + grid[0] * grid[1] + batch_frames, tc_tiles, vision_chunk)
    enc_iv = _encode_batches(n_frames, 16, vision_chunk)
    print(f"[mm] (i) {n_frames}-frame video, {n_i} tokens ({chunks(n_i)} chunks of {chunk}); "
          f"(ii) batch of a {1 + grid[0] * grid[1]}-tile image and a {batch_frames}-frame "
          f"video, {lens_ii} tokens ({chunks(max(lens_ii))} chunks); (iii) = (i), bf16 cache")
    _check_launches(counts, {
        "flash_fwd": n_layers * chunks(n_i),
        "flash_fwd_quant": n_layers * (4 * chunks(n_i) + chunks(max(lens_ii))),
        "short_attn": n_vit * (3 * enc_i + enc_ii + 2 * enc_iv),
    })
    if interleaved.token_ids != upfront.token_ids:
        raise AssertionError(f"interleaved encode differs from the up-front encode: "
                             f"{interleaved.token_ids} vs {upfront.token_ids}")
    print(f"[mm] (iv) pieces of 16 frames ({enc_iv} encode batches each way): interleaved encode "
          f"gives the up-front encode's tokens ({t_il:.2f} s vs {t_up:.2f} s); against (i), one "
          f"piece of {n_frames}: {'identical' if upfront.token_ids == first.token_ids else 'differs'} "
          f"(for the record: other ViT batch sizes may round differently)")
    if first.token_ids != again.token_ids:
        raise AssertionError(f"repeat greedy generate differs: {first.token_ids} vs {again.token_ids}")
    outs = [first, again, *batched, bf16, upfront, interleaved]
    if not all(r.token_ids and all(0 <= t < tc.vocab_size for t in r.token_ids) for r in outs):
        raise AssertionError("empty output or token id outside [0, vocab)")
    if [r.prompt_tokens for r in outs] != [n_i, n_i, *lens_ii, n_i, n_i, n_i]:
        raise AssertionError("prompt lengths differ from the expansion's")
    print(f"[mm] (i) int8 cache, greedy x2 identical ({len(first.token_ids)} tokens, "
          f"{len(set(first.token_ids))} distinct): "
          f"{first.token_ids[:8]} ... in {t_first:.2f} / {t_again:.2f} s; (ii) -> "
          f"{[len(r.token_ids) for r in batched]} tokens in {t_batch:.2f} s; (iii) bf16 cache "
          f"-> {bf16.token_ids[:8]} ... in {t_bf16:.2f} s; peak allocated {peak_gb:.2f} GB")

    # ---- timings (warm): encode, TTFT = prefill (encode included) + head
    feats, t_enc = _timed(lambda: eng_q._encode_images_host(x.images))
    (cache, hid_q, _), t_pre_q = _timed(lambda: eng_q.prefill(x.input_ids, x.images, x.image_indices))
    del cache
    logits_q, t_head_q = _timed(lambda: qwen2.lm_head(text_params, hid_q))
    (cache, hid_b, _), t_pre_b = _timed(lambda: eng_b.prefill(x.input_ids, x.images, x.image_indices))
    del cache
    logits_b, t_head_b = _timed(lambda: qwen2.lm_head(text_params, hid_b))
    ttft_q, ttft_b = t_pre_q + t_head_q, t_pre_b + t_head_b
    decode_ms = (t_again - ttft_q) / (len(again.token_ids) - 1) * 1e3
    print(f"[mm] ViT encode of {n_frames} frames (host cast + copy + {enc_i} batch(es) of "
          f"{vision_chunk}): {t_enc * 1e3:.1f} ms = {n_frames / t_enc:.1f} frames/s; TTFT (i) "
          f"int8 cache {ttft_q * 1e3:.1f} ms ({n_i / t_pre_q:.0f} prompt tokens/s), (iii) bf16 "
          f"cache {ttft_b * 1e3:.1f} ms; decode with the int8 cache {decode_ms:.2f} ms/token")

    # ---- the kernel path against the same flow on the plain versions
    pixels = torch.from_numpy(x.images).to(torch.bfloat16).to(dev)
    plain_feats = encode_images(lv, pixels, cfg, chunk=vision_chunk, attn_impl="xla")
    del pixels
    diff = (feats.float() - plain_feats.float()).reshape(-1, feats.shape[-1])
    ref = plain_feats.float().reshape(-1, feats.shape[-1])
    rel = (diff.norm() / ref.norm()).item()
    row_cos = F.cosine_similarity(feats.float().reshape(-1, feats.shape[-1]), ref, dim=-1).min().item()
    good_feats = rel <= FEAT_REL_ERR and row_cos >= FEAT_ROW_COS
    print(f"[mm] encoded features, K3 vs the plain ViT attention: relative error {rel:.3e} "
          f"(<= {FEAT_REL_ERR}), worst row cosine {row_cos:.6f} (>= {FEAT_ROW_COS}) "
          f"{'ok' if good_feats else 'FAIL'}")
    del feats
    plain_hidden = _plain_chunked_last_row(
        text_params, tc, x.input_ids, chunk, max_seq, feats=plain_feats,
        indices=x.image_indices, quantize=True,
    )
    plain_logits = qwen2.lm_head(text_params, plain_hidden)
    ok = bool(torch.isfinite(logits_q).all()) and logits_q.shape == (1, tc.vocab_size)
    ok = _logit_check("mm", "K3 + K2 path vs the plain ViT attention + plain int8 prefill",
                      logits_q, plain_logits) and ok
    cos_qb = F.cosine_similarity(logits_q, logits_b, dim=-1).item()
    print(f"[mm] (for the record) last-row logits, int8 cache (i) vs bf16 cache (iii): "
          f"cosine {cos_qb:.6f}")
    if not (ok and good_feats):
        raise AssertionError("the kernel path disagrees with the plain versions")
    return counts


def _put(url: str, payload: dict, timeout: float = 600.0) -> tuple:
    """PUT a JSON payload. -> (status, body text, seconds)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="PUT",
    )
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode(), time.perf_counter() - t
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), time.perf_counter() - t


def _stream(url: str, payload: dict, timeout: float = 600.0) -> tuple:
    """A "stream": true PUT. -> (NDJSON events, seconds to the first delta,
    seconds to the end)."""
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps({**payload, "stream": True}).encode(),
        headers={"Content-Type": "application/json"}, method="PUT",
    )
    t = time.perf_counter()
    events, first = [], None
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        for line in resp:
            events.append(json.loads(line))
            if first is None and "delta" in events[-1]:
                first = time.perf_counter() - t
    return events, first, time.perf_counter() - t


def _random_text(rng, n: int) -> str:
    """n characters of lowercase words: n tokens of the byte-level tokenizer."""
    return "".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz    "), n))


TOKENIZER_FIXTURE = os.path.join("tests", "data", "qwen2_tokenizer_tiny")  # tools/make_tokenizer_fixture.py
QWEN25_FIRST_ADDED = 151643  # <|endoftext|>'s id in Qwen2.5; its 22 added tokens follow


def tokenizer_dir(dst, first_special: int = QWEN25_FIRST_ADDED) -> str:
    """Write the committed Qwen2 tokenizer fixture into ``dst`` with its BPE
    vocabulary cut or padded to ``first_special`` entries, so that its 22
    added tokens (Qwen2.5's, in its order) take ids first_special.. and the
    17 multimodal tokens that load_tokenizer adds follow them: at Qwen2.5's
    151643.. and 151665.. by default. A cut keeps the merges whose results
    it keeps (a prefix of them: each merge's result takes the next id); the
    padding entries (``<|pad_N|>``) are unreachable, as no merge makes
    them. -> dst."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), TOKENIZER_FIXTURE)
    with open(os.path.join(src, "tokenizer.json"), encoding="utf-8") as f:
        tj = json.load(f)
    with open(os.path.join(src, "tokenizer_config.json"), encoding="utf-8") as f:
        config = json.load(f)
    model = tj["model"]
    vocab = {t: i for t, i in model["vocab"].items() if i < first_special}
    model["merges"] = [m for m in model["merges"] if "".join(m) in vocab]
    vocab.update((f"<|pad_{i}|>", i) for i in range(len(vocab), first_special))
    model["vocab"] = vocab
    for k, t in enumerate(sorted(tj["added_tokens"], key=lambda t: t["id"])):
        t["id"] = first_special + k
    config["added_tokens_decoder"] = {
        str(first_special + k): d for k, (_, d) in enumerate(
            sorted(config["added_tokens_decoder"].items(), key=lambda kv: int(kv[0])))}
    os.makedirs(dst, exist_ok=True)
    for name, obj in (("tokenizer.json", tj), ("tokenizer_config.json", config)):
        with open(os.path.join(dst, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, ensure_ascii=False)
    return dst


def _tokenizer_rate(ckpt, n_chars: int) -> bool:
    """The port's tokenizer on a document of n_chars characters of the
    text the fixture was trained on (the JAX package's Python sources,
    read as text): a fresh load of ``ckpt``'s files encodes it cold (every
    word through the merges) and again warm (every word from its cache),
    and decodes it; the rates in characters and ids a second, on this
    machine's host CPU, beside the card's nvidia-smi line, and the split
    pattern's one-time build. -> whether the ids decode to the document's
    NFC text."""
    import pathlib
    import unicodedata

    from long_vita_tpu_torch import tokenizer as port_tokenizer

    sources = pathlib.Path(__file__).resolve().parent / "long_vita_tpu"
    text = "".join(p.read_text(encoding="utf-8") for p in sorted(sources.rglob("*.py")))
    doc = (text * (n_chars // len(text) + 1))[:n_chars]
    _, t_pattern = _timed(port_tokenizer._split_pattern.__wrapped__)
    tok, t_load = _timed(lambda: port_tokenizer.load_tokenizer(ckpt))
    ids, t_cold = _timed(lambda: tok(doc).input_ids)
    again, t_warm = _timed(lambda: tok(doc).input_ids)
    back, t_decode = _timed(lambda: tok.decode(ids))
    smi = _nvidia_smi() if shutil.which("nvidia-smi") else "no nvidia-smi"
    print(f"[tokenizer] {smi}: a {len(doc)}-character document of the JAX package's sources "
          f"-> {len(ids)} ids; load {t_load:.3f} s, the split pattern's one-time build "
          f"{t_pattern:.3f} s; encode cold {t_cold:.3f} s = {len(doc) / t_cold:.0f} chars/s = "
          f"{len(ids) / t_cold:.0f} ids/s, warm {t_warm:.3f} s = {len(doc) / t_warm:.0f} "
          f"chars/s = {len(ids) / t_warm:.0f} ids/s; decode {t_decode:.3f} s = "
          f"{len(ids) / t_decode:.0f} ids/s (host CPU, one thread)")
    return again == ids and back == unicodedata.normalize("NFC", doc)


def _id_text(tok, rng, n: int) -> str:
    """Random text of exactly n ids of ``tok``: n draws of the vocabulary's
    single-id words (a space then letters), which the split keeps apart."""
    words = getattr(tok, "_one_id_words", None)
    if words is None:
        words = sorted(w for w in (tok.decode([i]) for i in range(len(tok)))
                       if len(w) > 1 and w[0] == " " and w[1:].isascii() and w[1:].isalpha()
                       and len(tok(w).input_ids) == 1)
        tok._one_id_words = words
    text = "".join(rng.choice(words, n))
    assert len(tok(text).input_ids) == n, n
    return text


def phase_server(
    holder, cfg, dev, ckpt, *, chunk=2048, max_seq=8192, prompt_ids=5000,
    batch_ids=(700, 2100, 4000), new_tokens=32, tick=8, n_frames=16,
    frame_hw=(360, 640), vision_chunk=64, first_special=QWEN25_FIRST_ADDED,
    doc_chars=1_000_000,
) -> tuple:
    """The port's own serving entry points at full width, on a checkpoint it
    writes and reads back: export the decoder in ``holder`` (which the phase
    empties, so the card never holds two copies), a random InternViT-300M
    and projector as a *_HF directory into ``ckpt`` (save_hf_checkpoint; the
    caller deletes it, after phase_recipe has trained from it) with the
    Qwen2 tokenizer fixture (tokenizer_dir: its added tokens at
    first_special, Qwen2.5's 151643 by default), free them, and build the
    engine as a user does, long_vita_tpu_torch.build_engine(ckpt): the
    safetensors reader (every tensor's bits held to its fingerprint), the
    port's own BPE reading the tokenizer files, MultimodalTokenizer and
    InferenceEngine. The tokenizer's rate on a doc_chars document of the
    fixture's training text, cold and warm. Serve
    PUT /api in continuous mode (4 slots, ticks of ``tick`` tokens, so a
    request stays in the pool for several ticks) on a thread and send a
    prompt_ids-id greedy request, three concurrent ones, a streamed one,
    a beam request and a malformed one over urllib; then a 16-frame video
    in process through MultimodalTokenizer.expand (the native feedworker,
    K3, K1). -> (launch counts of the run, the loaded decoder)."""
    import os
    import threading

    import numpy as np
    import torch

    import long_vita_tpu_torch
    from long_vita_tpu_torch.inference.continuous import ContinuousEngine
    from long_vita_tpu_torch.inference.sampler import SamplingParams
    from long_vita_tpu_torch.inference.server import _validate, make_server
    from long_vita_tpu_torch.models import qwen2
    from long_vita_tpu_torch.utils.export_hf import save_hf_checkpoint

    vc, tc = cfg.vision, cfg.text
    rng = np.random.default_rng(SEED + 8)
    failures = []

    def check(ok: bool, what: str) -> None:
        print(f"[server] {what}: {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(what)

    # ---- export, free, load ------------------------------------------------
    probe = rng.standard_normal((2, vc.image_size, vc.image_size, 3), dtype=np.float32)
    lv, _ = _vlm_params(holder.pop(), cfg, dev, SEED + 7, probe)
    dtype = lv.text.embed.dtype
    prints = {name: _fingerprint(p) for name, p in lv.named_parameters()}
    _, t_export = _timed(lambda: save_hf_checkpoint(lv, cfg, ckpt))
    n_bytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
    tokenizer_dir(ckpt, first_special)
    shards = sorted(f for f in os.listdir(ckpt) if f.endswith(".safetensors"))
    print(f"[server] exported {len(prints)} tensors, {n_bytes / 1e9:.3f} GB in {len(shards)} "
          f"shards ({shards[0]} .. {shards[-1]}) in {t_export:.2f} s "
          f"({n_bytes / 1e9 / t_export:.2f} GB/s)")
    held = torch.cuda.memory_allocated()
    del lv
    torch.cuda.empty_cache()
    print(f"[server] freed the in-memory VLM: allocated {held / 1e9:.2f} -> "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    dtype_name = {torch.bfloat16: "bfloat16", torch.float32: "float32"}[dtype]
    engine, t_load = _timed(lambda: long_vita_tpu_torch.build_engine(
        ckpt, max_seq_len=max_seq, chunk=chunk, dtype_name=dtype_name, device=dev))
    loaded, mm = engine.params, engine.mm
    tok = mm.tokenizer
    print(f"[server] long_vita_tpu_torch.build_engine({ckpt}) in {t_load:.2f} s "
          f"({n_bytes / 1e9 / t_load:.2f} GB/s with the tokenizer's files): {type(tok).__name__}, "
          f"{len(tok)} ids, <|endoftext|> {tok.pad_token_id}, <img> "
          f"{tok.convert_tokens_to_ids('<img>')}")
    got = {name: _fingerprint(p) for name, p in loaded.named_parameters()}
    differ = [n for n in prints if got.get(n) != prints[n]]
    check(got.keys() == prints.keys() and not differ and engine.cfg.text == tc
          and engine.cfg.vision == vc and engine.vision_chunk == vision_chunk
          and mm.image_token_length == cfg.image_token_length
          and mm.processor.image_size == vc.image_size,
          f"{len(got)} loaded tensors hold their exported bits ({len(differ)} differ), "
          f"config.json gives the configuration, the front end its geometry")
    check(type(tok).__name__ == "Qwen2Tokenizer"
          and tok.convert_tokens_to_ids(["<|endoftext|>", "<|im_end|>", "<img>"])
          == [first_special, first_special + 2, first_special + 22]
          and tok.convert_tokens_to_ids("<|im_end|>") == tc.eos_token_id,
          "the port's Qwen2 BPE read the directory's tokenizer: the added tokens from "
          f"{first_special}, the multimodal ones after them, <|im_end|> the configuration's eos")
    check(_tokenizer_rate(ckpt, doc_chars), "the document decodes back to its NFC text")

    # ---- the server ------------------------------------------------------------
    server = make_server(engine, "127.0.0.1", 0, continuous=True, max_batch=4, tick=tick)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/api"

    def n_ids(text):
        return len(mm.encode_chat([{"role": "user", "content": text}]))

    frame = n_ids("")  # the chat template's ids around the user's text

    def prompt_of(n):  # a user text whose chat prompt is n ids
        text = _id_text(tok, rng, n - frame)
        assert n_ids(text) == n, (n, n_ids(text))
        return text

    prompt = prompt_of(prompt_ids)
    others = [prompt_of(n) for n in batch_ids]
    beam_prompt = prompt_of(300)
    frames = list(rng.integers(0, 256, (n_frames, *frame_hw, 3), dtype=np.uint8))
    vid_ids = mm.encode_chat([{"role": "user", "content": "<video>\nDescribe the video."}])
    greedy = {"tokens_to_generate": new_tokens, "logprobs": True}

    # ---- the main path ------------------------------------------------------
    prefills = []  # the length of every prefill the run makes (K1 chunks)
    _reset_counts()
    try:
        code, body, t_http = _put(url, {"prompts": [prompt], **greedy})
        prefills.append(n_ids(prompt))
        check(code == 200, f"solo {n_ids(prompt)}-id request over HTTP answered {code}")
        http = json.loads(body) if code == 200 else {"text": [""], "logprobs": [[]]}
        sp = SamplingParams(max_new_tokens=new_tokens, return_logprobs=True)
        prompt_ids = mm.encode_chat([{"role": "user", "content": prompt}])
        ce = ContinuousEngine(engine, sp, max_slots=4, tick=tick)

        def in_pool():
            ce.add_request(prompt_ids)
            return ce.run_to_completion()[0][1]

        pool, t_pool = _timed(in_pool)
        del ce
        inproc, t_gen = _timed(lambda: engine.generate(input_ids=prompt_ids, sampling=sp))
        prefills += [len(prompt_ids)] * 2
        print(f"[server] solo request, {len(pool.token_ids)} tokens {pool.token_ids[:8]} ...: "
              f"HTTP {t_http:.3f} s, the same request on an in-process ContinuousEngine of the "
              f"server's geometry {t_pool:.3f} s (the server's overhead {t_http - t_pool:+.3f} s), "
              f"in-process generate {t_gen:.3f} s")
        check(http["text"] == [pool.text] and http["logprobs"] == [pool.logprobs],
              "HTTP greedy answer equals the in-process ContinuousEngine of the server's "
              "geometry (4 slots): the text and each token's logprob to the bit")
        # generate decodes one row a step, the pool four: cuBLAS rounds the two
        # GEMM shapes apart, and random weights leave near-ties that flip
        div = next((i for i, (a, b) in enumerate(zip(pool.token_ids, inproc.token_ids))
                    if a != b), None)
        if div is None:
            check(pool.token_ids == inproc.token_ids,
                  "the pool's greedy tokens equal the in-process engine.generate's")
        else:
            _, hid, _ = engine.prefill(prompt_ids + pool.token_ids[:div])
            prefills.append(len(prompt_ids) + div)
            logits = qwen2.lm_head(engine.text, hid)[0]
            a, b = inproc.token_ids[div], pool.token_ids[div]
            gap = abs(logits[a] - logits[b]).item()
            spread = (logits.max() - logits.min()).item()
            check(gap <= LOGIT_SPREAD_FRAC * spread,
                  f"the pool's greedy tokens equal engine.generate's up to token {div}, where "
                  f"the two picks ({b} and {a}) lie {gap:.4f} apart in the logits of a one-row "
                  f"pass (<= {LOGIT_SPREAD_FRAC} x spread {spread:.3f}): a rounding tie")

        solos = [json.loads(_put(url, {"prompts": [p], **greedy})[1]) for p in others]
        out = {}

        def worker(i):
            out[i] = _put(url, {"prompts": [others[i]], **greedy})

        server.batcher.batch_sizes.clear()
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(others))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        t_batch = time.perf_counter() - t0
        together = [json.loads(out[i][1]) for i in range(len(others))]
        n_gen = sum(len(r["logprobs"][0]) for r in together)
        print(f"[server] {len(others)} concurrent requests ({[n_ids(p) for p in others]} ids): "
              f"{n_gen} tokens in {t_batch:.3f} s = {n_gen / t_batch:.1f} tokens/s; rows in flight "
              f"a tick {server.batcher.batch_sizes}")
        check(together == solos and max(server.batcher.batch_sizes) > 1,
              "each concurrent request equals its solo answer, and they shared the pool")

        events, t_first, t_stream = _stream(url, {"prompts": [prompt], **greedy})
        deltas = [e["delta"] for e in events if "delta" in e]
        print(f"[server] streamed the solo prompt: first delta after {t_first:.3f} s (TTFT over "
              f"HTTP), {len(deltas)} deltas in {t_stream:.3f} s")
        check(events[-1].get("done") is True and "".join(deltas) == events[-1]["text"][0]
              == http["text"][0], "stream deltas concatenate to the non-streamed text")

        code, body, t_beam = _put(url, {"prompts": [beam_prompt], "tokens_to_generate": 8,
                                        "beam_width": 2})
        beam = json.loads(body) if code == 200 else {}
        check(code == 200 and len(beam["text"]) == 2 and len(beam["segments"]) == 2
              and beam["scores"] == sorted(beam["scores"], reverse=True)
              and all(len(s) <= 8 for s in beam["segments"]),
              f"beam_width 2 gives two hypotheses best first (scores {beam.get('scores')}, "
              f"{t_beam:.2f} s)")
        bad = {"prompts": ["x"], "top_k": 5, "top_p": 0.5}
        code, body, _ = _put(url, bad)
        check(code == 400 and body == _validate(bad), f"malformed request: {code} {body!r}")

        expanded, t_expand = _timed(lambda: mm.expand(vid_ids, videos=[frames]))
        media, t_media = _timed(lambda: engine.generate(
            input_ids=vid_ids, videos=[frames], sampling=SamplingParams(max_new_tokens=16)
        ))
        counts = _read_counts()
    finally:
        server.shutdown()
        thread.join(timeout=600)
        server.batcher.stop(timeout=600)
        server.server_close()
    n_vid = len(vid_ids) - 1 + n_frames * (cfg.image_token_length + 2)
    print(f"[server] {n_frames} frames of {frame_hw[1]}x{frame_hw[0]} (uint8) through "
          f"MultimodalTokenizer.expand (native feedworker) in {t_expand * 1e3:.1f} ms -> "
          f"{len(expanded.input_ids)} ids, tiles {tuple(expanded.images.shape)}; in-process "
          f"generate {t_media:.2f} s -> {media.token_ids[:8]} ...")
    check(media.prompt_tokens == len(expanded.input_ids) == n_vid
          and expanded.images.shape == (n_frames, vc.image_size, vc.image_size, 3)
          and bool(media.token_ids) and all(0 <= t < tc.vocab_size for t in media.token_ids),
          "the video request's prompt and tokens")

    def chunks(n):
        return -(-n // chunk)

    prefills += [n_ids(prompt)] + [n_ids(p) for p in others] * 2 + [n_ids(beam_prompt), n_vid]
    _check_launches(counts, {
        "flash_fwd": tc.num_hidden_layers * sum(chunks(n) for n in prefills),
        "short_attn": vc.num_hidden_layers * _encode_batches(n_frames, 256, vision_chunk),
    })
    if failures:
        raise AssertionError(f"phase_server: {failures}")
    return counts, loaded.text


def _train_pack(cfg, seq_len, videos, images, rng, *, text_segments, answer=300,
                text_sup=700):
    """One packed training row of seq_len tokens, as the data pipeline packs
    samples: a sample per video (frames [F, 448, 448, 3]) and per image
    ((tiles, (rows, cols))), each a 30-token prompt around the media and a
    supervised answer of ``answer`` tokens, then ``text_segments`` text-only
    samples filling the row with their last ``text_sup`` tokens supervised.
    Positions restart per sample; tiles are concatenated in order."""
    import numpy as np

    from long_vita_tpu_torch.training.loss import IGNORE_INDEX, Pack

    mm = _StubMM(cfg.image_token_length)

    def text(n):  # ids below Qwen2's first special token
        return rng.integers(0, min(151643, cfg.text.vocab_size), n).tolist()

    samples = []  # (ids, labels, tiles, image_indices)
    for tag, media in [(VID_TAG, v) for v in videos] + [(IMG_TAG, i) for i in images]:
        x = mm.expand([*text(15), tag, *text(15)],
                      images=[media] if tag == IMG_TAG else (),
                      videos=[media] if tag == VID_TAG else ())
        ans = text(answer)
        samples.append((x.input_ids + ans, [IGNORE_INDEX] * len(x.input_ids) + ans,
                        x.images, x.image_indices))
    rest = seq_len - sum(len(smp[0]) for smp in samples)
    sizes = [rest // text_segments] * text_segments
    sizes[-1] += rest - sum(sizes)
    for n in sizes:
        ids = text(n)
        samples.append((ids, [IGNORE_INDEX] * (n - text_sup) + ids[n - text_sup:], None, None))
    tokens, labels, pos, seg, tiles, indices = [], [], [], [], [], []
    for i, (ids, lab, t, idx) in enumerate(samples):
        if t is not None:
            idx = idx.copy()
            idx[1] += len(tokens)
            tiles.append(t)
            indices.append(idx)
        tokens += ids
        labels += lab
        pos += range(len(ids))
        seg += [i] * len(ids)
    as32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    return Pack(as32(tokens), as32(labels), as32(pos), as32(seg),
                np.concatenate(tiles), np.concatenate(indices, axis=1))


def _fingerprint(p) -> int:
    """A position-weighted int64 sum of a tensor's raw bits (1 + index mod
    65521 as weights, in chunks to bound the temporaries): any change of its
    bits changes it, short of a collision."""
    import torch

    bits = p.detach().reshape(-1).view(torch.int16 if p.element_size() == 2 else torch.int32)
    total, step = 0, 1 << 26
    for i in range(0, bits.numel(), step):
        chunk = bits[i:i + step].to(torch.int64)
        w = (torch.arange(i, i + chunk.numel(), device=p.device) % 65521) + 1
        total += int((chunk * w).sum())
    return total


def _snapshot(module, trained) -> dict:
    """Copies of the trained parameters, fingerprints of the others."""
    return {n: (p.detach().clone() if n in trained else _fingerprint(p))
            for n, p in module.named_parameters()}


def _moved(module, snap) -> set:
    import torch

    return {n for n, p in module.named_parameters()
            if (not torch.equal(p.detach(), snap[n]) if torch.is_tensor(snap[n])
                else _fingerprint(p) != snap[n])}


def phase_train(text_params, cfg, dev, *, tag, seq_len, videos, grid, freeze_vision,
                vit_lr_mult=1.0, text_segments=4, answer=300, text_sup=700, steps=2,
                budget=4096, vision_chunk=64, seed) -> tuple:
    """Train the VLM for ``steps`` steps on one packed row through
    Trainer.train: text frozen, the tower frozen or trained, the projector
    trained, full remat, stage 1's schedule (configs/stage1_alignment.yaml:
    lr 1e-3, 30 warmup steps of 1000, so step 0 moves nothing and step 1
    takes lr / 30: Adam's first step moves every weight by about its lr,
    and at 1e-3 that is larger than the scaled projector's weights). Checks
    the launch counts, that the loss after the steps (a no-grad pass over
    the same row on the same path) is below the first step's, that the projector's
    matrices moved and every frozen parameter kept its bits.
    -> (launch counts, the VLM params)."""
    import numpy as np
    import torch

    from long_vita_tpu_torch.ops import flash_attention as fa
    from long_vita_tpu_torch.training.loss import collate_packs, to_device
    from long_vita_tpu_torch.training.optimizer import OptimizerConfig
    from long_vita_tpu_torch.training.train_step import loss_fn
    from long_vita_tpu_torch.training.trainer import Trainer, TrainerConfig

    vc, tc = cfg.vision, cfg.text
    rng = np.random.default_rng(seed)

    def tiles(n):
        return rng.standard_normal((n, vc.image_size, vc.image_size, 3), dtype=np.float32)

    t0 = time.perf_counter()
    lv, ratio = _vlm_params(text_params, cfg, dev, seed, tiles(2))
    pack = _train_pack(cfg, seq_len, [tiles(f) for f in videos],
                       [(tiles(1 + grid[0] * grid[1]), grid)], rng, text_segments=text_segments,
                       answer=answer, text_sup=text_sup)
    batch = collate_packs([pack], budget)
    n_tiles = len(pack.images)
    optim = OptimizerConfig(lr=1e-3, warmup_steps=30, total_steps=1000, freeze_text=True,
                            freeze_vision=freeze_vision, vit_lr_mult=vit_lr_mult)
    trainer = Trainer(lv, cfg, TrainerConfig(
        seq_len=seq_len, logit_budget=budget, steps=steps, remat=True,
        vision_chunk=vision_chunk, optim=optim,
    ))
    trained = {n for n, p in lv.named_parameters() if p.requires_grad}
    print(f"[{tag}] pack of {seq_len} tokens: {len(set(pack.segment_ids.tolist()))} samples, "
          f"videos of {list(videos)} frames and a {1 + grid[0] * grid[1]}-tile image "
          f"({n_tiles} tiles), {int((batch['labels'] != -100).sum())} supervised rows in a "
          f"budget of {budget}; trained: {len(trained)} tensors "
          f"({sum(p.numel() for n, p in lv.named_parameters() if n in trained) / 1e6:.1f} M, "
          f"{'projector' if freeze_vision else f'tower at lr x {vit_lr_mult} and projector'}); "
          f"projector output scaled by {ratio:.4f}; set up in {time.perf_counter() - t0:.1f} s")
    before = _snapshot(lv, trained)
    stamps = []

    def batches():
        for _ in range(steps):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            yield batch

    # ---- the main path: Trainer.train
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses = trainer.train(batches())["losses"]
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    counts = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]

    n_layers, n_vit = tc.num_hidden_layers, vc.num_hidden_layers
    vit_batches = [min(vision_chunk, n_tiles - i) for i in range(0, n_tiles, vision_chunk)]
    dec_fused = fa.bwd_uses_fused(1, seq_len, seq_len, tc.num_attention_heads, tc.head_dim, 2)
    expected = dict.fromkeys(counts, 0)
    bwd = "flash_bwd" if dec_fused else None
    if freeze_vision:
        expected["flash_fwd"] = 2 * n_layers * steps
        expected["short_attn"] = n_vit * len(vit_batches) * steps
    else:
        expected["flash_fwd"] = 2 * (n_layers + n_vit * len(vit_batches)) * steps
        for b in vit_batches:
            if not fa.bwd_uses_fused(b, vc.seq_len, vc.seq_len, vc.num_attention_heads,
                                     vc.head_dim, 2):
                raise AssertionError("this phase expects the one-pass backward in the tower")
            expected["flash_bwd"] += n_vit * steps
    if bwd:
        expected["flash_bwd"] += n_layers * steps
    else:
        expected["flash_bwd_dkv"] = expected["flash_bwd_dq"] = n_layers * steps
    print(f"[{tag}] decoder backward: {'K4 (one pass)' if dec_fused else 'K5 (two pass)'}; "
          f"{len(vit_batches)} ViT batch(es) of {vit_batches} tiles a step")
    _check_launches(counts, expected)

    # bf16 weights take the Adam update rounded to bf16 (no master copy, as
    # in the JAX package): an update below half an ulp leaves a weight as it
    # is (a norm scale at 1.0 has an ulp of 2^-7; the tower's weights do not
    # move at lr 1e-3 x 0.1 / 30). The projector's matrices are held to
    # moving; the rest of what trains is reported.
    moved = _moved(lv, before)
    del before
    must = {n for n, p in lv.projector.named_parameters(prefix="projector") if p.dim() >= 2}
    stuck = sorted(must - moved)
    wrong = sorted(moved - trained)
    with torch.no_grad():  # the same row and path as the steps, no remat
        after = loss_fn(lv, to_device(batch, dev), cfg, False, vision_chunk,
                        freeze_vision)[0].item()
    print(f"[{tag}] losses of the steps {losses}, after them {after}; steps "
          f"{[round(t, 2) for t in step_s]} s = {[round(seq_len / t) for t in step_s]} "
          f"tokens/s; peak allocated {peak_gb:.2f} GB; trained tensors that moved: "
          f"{len(moved & trained)} of {len(trained)}; frozen ones that did: {len(wrong)}")
    if len(losses) != steps or not all(np.isfinite(losses + [after])) or not after < losses[0]:
        raise AssertionError(f"[{tag}] the loss did not fall: {losses}, after {after}")
    if stuck or wrong:
        raise AssertionError(f"[{tag}] trained but unchanged {stuck[:5]}; frozen but changed "
                             f"{wrong[:5]}")
    del trainer
    return counts, lv


def phase_train_grads(lv, cfg, dev, *, seq_len=4096, grid=(2, 3), vision_chunk=64,
                      answer=300, text_sup=700) -> None:
    """The trainable gradients (tower and projector, text frozen) of one
    step on a seq_len-token pack with a 7-tile image, through the kernels
    and through the plain attention (attn_impl "xla": xla_attention in the
    decoder and the tower). Then the control: the same step with a fault
    planted in the decoder's K4 (dK and dV of kv tile 0 dropped), which the
    gate must reject."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from long_vita_tpu_torch.ops import flash_attention as fa
    from long_vita_tpu_torch.training.loss import collate_packs, to_device
    from long_vita_tpu_torch.training.train_step import gradients, loss_fn
    from long_vita_tpu_torch.utils.convert import set_requires_grad

    rng = np.random.default_rng(SEED + 7)
    size = cfg.vision.image_size
    tiles = rng.standard_normal((1 + grid[0] * grid[1], size, size, 3), dtype=np.float32)
    pack = _train_pack(cfg, seq_len, [], [(tiles, grid)], rng, text_segments=2,
                       answer=answer, text_sup=text_sup)
    batch = to_device(collate_packs([pack], seq_len), dev)
    set_requires_grad(lv, freeze_text=True)

    def step(impl):
        lv.zero_grad(set_to_none=True)
        loss, _ = loss_fn(lv, batch, cfg, True, vision_chunk, False, attn_impl=impl)
        loss.backward()
        grads = {n: g.float().flatten() for n, g in gradients(lv).items()}
        lv.zero_grad(set_to_none=True)
        return loss.item(), grads

    def gate(name, run, ref) -> bool:
        (lk, gk), (lp, gp) = run, ref
        loss_rel = abs(lk - lp) / abs(lp)
        cos = {}
        for group in ("vision.", "projector.", ""):
            names = [n for n in gk if n.startswith(group)]
            a, b = torch.cat([gk[n] for n in names]), torch.cat([gp[n] for n in names])
            cos[group or "all"] = F.cosine_similarity(a, b, dim=0).item()
        worst = min(F.cosine_similarity(gk[n], gp[n], dim=0).item() for n in gk)
        passes = cos["all"] >= TRAIN_GRAD_COS and loss_rel <= TRAIN_LOSS_REL
        print(f"[T2] one step at {seq_len} tokens, {name} vs plain attention: loss {lk:.6f} vs "
              f"{lp:.6f} (rel {loss_rel:.2e} <= {TRAIN_LOSS_REL}); gradient cosine all "
              f"{cos['all']:.6f} (>= {TRAIN_GRAD_COS}), tower {cos['vision.']:.6f}, projector "
              f"{cos['projector.']:.6f}, worst tensor {worst:.6f}: "
              f"{'passes' if passes else 'fails'} the gate")
        return passes

    plain = step("xla")
    good = gate("kernels", step("auto"), plain)
    kernel = fa.flash_bwd_fused

    def planted(a):
        kernel(a)
        if a["q"].shape[-1] == 128:  # the decoder's
            a["dk"][:, :64].zero_()
            a["dv"][:, :64].zero_()

    planted.launches = 0
    fa.flash_bwd_fused = planted
    try:
        caught = not gate("kernels with a planted fault (decoder K4 loses dK, dV of kv tile 0)",
                          step("auto"), plain)
    finally:
        fa.flash_bwd_fused = kernel
    if not good:
        raise AssertionError("the kernel path's gradients disagree with the plain attention's")
    if not caught:
        raise AssertionError("the T2 gate did not reject the planted fault")


def _recipe_inputs(root, tok, *, image_px, n_docs, doc_ids, n_captions, n_chat, chat_ids,
                   seed) -> str:
    """A corpus for the recipe phase under ``root``: "docs", long text
    inputs of doc_ids ids of ``tok`` with short answers (ratio 1);
    "captions", a 448-px PNG each (ratio 0.5); "chat", short two-turn
    chats (ratio 1.5, a num cap). Answers come from a few templates, so
    that every pack teaches the same thing and one pack's loss falls with
    steps on the others. -> the corpus YAML's path."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)

    def words(n):
        return _id_text(tok, rng, n)

    def answer():
        k = int(rng.integers(1, 9))
        return ["The answer is %d." % k, "It shows %d things." % k, "I count %d of them." % k][k % 3]

    images = []
    for i in range(4):
        path = os.path.join(root, f"img{i}.png")
        Image.fromarray(rng.integers(0, 256, (image_px, image_px, 3), dtype=np.uint8)).save(path)
        images.append(path)
    docs = [{"messages": [{"role": "user", "content": words(doc_ids) + "\nHow many?"},
                          {"role": "assistant", "content": answer()}]} for _ in range(n_docs)]
    captions = [{"messages": [{"role": "user", "content": "<image>\nHow many things are there?"},
                              {"role": "assistant", "content": answer()}],
                 "images": [images[i % len(images)]]} for i in range(n_captions)]
    chat = [{"conversations": [{"role": "human", "content": words(chat_ids) + "?"},
                               {"role": "gpt", "content": answer()},
                               {"role": "human", "content": words(chat_ids // 2) + "?"},
                               {"role": "gpt", "content": answer()}]} for _ in range(n_chat)]
    for name, rows in (("docs", docs), ("captions", captions), ("chat", chat)):
        with open(os.path.join(root, f"{name}.jsonl"), "w") as f:
            f.write("\n".join(json.dumps(r) for r in rows))
    path = os.path.join(root, "corpus.yaml")
    with open(path, "w") as f:  # YAML's flow style is JSON
        json.dump({"dataset": {
            "docs": {"ratio": 1, "data_paths": [os.path.join(root, "docs.jsonl")]},
            "captions": {"ratio": 0.5, "data_paths": [os.path.join(root, "captions.jsonl")]},
            "chat": {"ratio": 1.5, "num": n_chat, "data_paths": [os.path.join(root, "chat.jsonl")]},
        }}, f)
    return path


def _head_batch(batch, n):
    """The first n tokens of a collated one-row batch: the supervised rows
    whose target lies inside, the tiles whose rows all do."""
    import numpy as np

    from long_vita_tpu_torch.training.loss import IGNORE_INDEX

    out = {k: batch[k][:, :n] for k in ("tokens", "positions", "segment_ids")}
    keep = batch["logit_positions"] < n - 1
    out["logit_positions"] = np.where(keep, batch["logit_positions"], 0).astype(np.int32)
    out["labels"] = np.where(keep, batch["labels"], IGNORE_INDEX).astype(batch["labels"].dtype)
    out["images"] = out["image_indices"] = None
    if batch["images"] is not None:
        inside = (batch["image_indices"][1] < n).all(-1)
        if inside.any():
            out["images"] = batch["images"][inside]
            out["image_indices"] = batch["image_indices"][:, inside]
    return out


def _trace_kernels(path) -> set:
    """The names of the device kernels in a torch.profiler Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "kernel"}


def phase_recipe(ckpt, root, cfg, dev, *, seq_len=16384, budget=4096, steps=3,
                 dots_len=4096, vit_len=4096, merge_len=2048, vision_chunk=64, n_docs=14,
                 doc_ids=4000, n_captions=24, n_chat=12, chat_ids=300, answer=300,
                 text_sup=700) -> dict:
    """The training entry point as a user runs it, at full width: a corpus
    and a recipe written into the new directory ``root`` (the model: the
    *_HF directory ``ckpt`` that phase_server exported; LoRA r 16, alpha 32 on q/k/v/o, lora_only; a
    frozen tower; seq_len tokens a pack, cross_dataset_joint, the logit
    budget; remat "flash"; an output_dir with the profiler over step 1), then
    train.build_from_recipe and Trainer.train as train.main runs them, the
    tokenizer read from ``ckpt`` (the port's own BPE on the Qwen2 fixture
    at Qwen2.5's ids, which phase_server wrote there). Gates: finite losses; the first batch's loss
    (Trainer.evaluate) lower after the steps; every base weight keeps its
    bits and every B adapter moved; K1, K3 and K4/K5 launched exactly as
    the layers, steps and encode batches need; metrics.jsonl,
    print_batch.log, data_report.json (counting every sample of the
    corpus) and the trace, which names K1's and K4/K5's kernels. Then the
    remat levels on the first batch through train_step._backward: True vs
    "flash" at seq_len and "dots" vs True on its first dots_len tokens (the
    same loss bits, B gradients at cosine >= REMAT_GRAD_COS, K1 launches),
    "vit" vs True on T2's geometry at vit_len tokens (tower gradients);
    merge_lora's last-row logits against the adapted model's under the
    logit gate; save_lora -> load_lora bit for bit. -> the launch counts of
    the Trainer.train run."""
    import itertools

    import numpy as np
    import torch
    import torch.nn.functional as F

    from long_vita_tpu_torch.data.dataset import load_corpus
    from long_vita_tpu_torch.models.long_vita import long_vita_forward
    from long_vita_tpu_torch.ops import flash_attention as fa
    from long_vita_tpu_torch.training import train as ttrain
    from long_vita_tpu_torch.training.loss import collate_packs, to_device
    from long_vita_tpu_torch.training.lora import (
        LoraConfig,
        load_lora,
        lora_subtree,
        merge_lora,
        save_lora,
    )
    from long_vita_tpu_torch.tokenizer import load_tokenizer
    from long_vita_tpu_torch.training.train_step import _backward

    vc, tc = cfg.vision, cfg.text
    failures = []

    def check(ok: bool, what: str) -> None:
        print(f"[recipe] {what}: {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(what)

    os.makedirs(root)
    out_dir = os.path.join(root, "out")
    tok = load_tokenizer(ckpt)
    corpus = _recipe_inputs(root, tok, image_px=vc.image_size, n_docs=n_docs, doc_ids=doc_ids,
                            n_captions=n_captions, n_chat=n_chat, chat_ids=chat_ids,
                            seed=SEED + 9)
    lcfg = LoraConfig(r=16, alpha=32, targets=("q_proj", "k_proj", "v_proj", "o_proj"))
    recipe = {
        "model": {"checkpoint": ckpt, "dtype": "bfloat16",
                  "lora": {"r": lcfg.r, "alpha": lcfg.alpha, "targets": list(lcfg.targets),
                           "lora_only": True}},
        "data": {"corpus": corpus, "seq_len": seq_len, "logit_budget": budget,
                 "vision_chunk": vision_chunk, "cross_dataset_joint": True},
        "optim": {"lr": 1.0e-3, "total_steps": 1000, "freeze_vision": True},
        "run": {"steps": steps, "remat": "flash", "seed": SEED, "output_dir": out_dir,
                "profile_steps": [1, 2]},
    }
    with open(os.path.join(root, "recipe.yaml"), "w") as f:  # YAML's flow style is JSON
        json.dump(recipe, f)
    print(f"[recipe] the tokenizer from {ckpt}: {len(tok)} ids, <|endoftext|> at "
          f"{tok.pad_token_id}; corpus and recipe (documents of {doc_ids} ids) in {root}; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before the load")

    # ---- train.main's path: build_from_recipe, then Trainer.train -----------
    t0 = time.perf_counter()
    trainer, batches, tokenizer = ttrain.build_from_recipe(
        ttrain.load_recipe(os.path.join(root, "recipe.yaml")), device=dev)
    lv, lcfg_text = trainer.state.params, trainer.cfg.text
    adapters = {n for n, _ in lv.named_parameters() if ".lora." in n}
    n_adapter = sum(p.numel() for n, p in lv.named_parameters() if n in adapters)
    print(f"[recipe] build_from_recipe in {time.perf_counter() - t0:.2f} s: {len(adapters)} "
          f"adapter tensors ({n_adapter / 1e6:.2f} M), lora_only "
          f"{trainer.tcfg.optim.lora_only}, {len(trainer.tx.frozen)} mask-frozen tensors "
          f"(folded into the norm), moments for {len(trainer.state.opt_state.mu)}")
    before = _snapshot(lv, adapters)
    first = next(batches)
    loss_before = trainer.evaluate([first])["loss"]
    seen, stamps = [], []

    def stream():
        for batch in itertools.chain([first], batches):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            seen.append(batch)
            yield batch

    # ---- the main path: Trainer.train
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses = trainer.train(stream(), tokenizer=tokenizer)["losses"]
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    counts = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    rest = sum(1 for _ in batches)  # the pipeline's report is written when it ends
    loss_after = trainer.evaluate([first])["loss"]
    tiles = [0 if b["images"] is None else len(b["images"]) for b in seen]
    sup = [int((b["labels"] != -100).sum()) for b in seen]
    print(f"[recipe] {len(seen)} packs of {seq_len} tokens ({rest} more in the stream): tiles "
          f"{tiles}, supervised rows {sup} (budget {budget}); losses {losses}; first batch "
          f"{loss_before:.6f} -> {loss_after:.6f}; steps {[round(t, 3) for t in step_s]} s "
          f"(step 1 under the profiler) = {[round(seq_len / t) for t in step_s]} tokens/s; "
          f"peak allocated {peak_gb:.2f} GB")
    check(len(losses) == steps and all(np.isfinite(losses)), "every step's loss is finite")
    check(loss_after < loss_before, "the first batch's loss fell over the steps")
    moved = _moved(lv, before)
    del before
    b_names = {n for n in adapters if n.endswith(".lora.b")}
    check(not moved - adapters and b_names <= moved,
          f"base weights keep their bits ({len(moved - adapters)} changed), the B adapters "
          f"moved ({len(b_names & moved)} of {len(b_names)})")
    n_layers, n_vit = tc.num_hidden_layers, vc.num_hidden_layers
    fused = fa.bwd_uses_fused(1, seq_len, seq_len, tc.num_attention_heads, tc.head_dim, 2)
    expected = {"flash_fwd": n_layers * steps,
                "short_attn": n_vit * sum(-(-t // vision_chunk) for t in tiles)}
    if fused:
        expected["flash_bwd"] = n_layers * steps
    else:
        expected["flash_bwd_dkv"] = expected["flash_bwd_dq"] = n_layers * steps
    _check_launches(counts, expected)

    records = [json.loads(line) for line in open(os.path.join(out_dir, "metrics.jsonl"))]
    keys = {"step", "wall_s", "loss", "grad_norm", "supervised_tokens", "step_time_s"}
    check(len(records) == steps and all(set(r) == keys for r in records),
          f"metrics.jsonl: {len(records)} records with {sorted(keys)}")
    print(f"[recipe] grad_norm {[r['grad_norm'] for r in records]}")
    report = json.load(open(os.path.join(out_dir, "data_report.json")))
    samples = load_corpus(corpus, seed=trainer.tcfg.seed)
    check(os.path.getsize(os.path.join(out_dir, "print_batch.log")) > 0
          and sum(s["samples"] for s in report.values()) == len(samples)
          and sum(s["images"] for s in report.values()) == sum(len(s.get("images", []))
                                                               for s in samples),
          f"print_batch.log and data_report.json ({report}) count the corpus's "
          f"{len(samples)} samples")
    names = _trace_kernels(os.path.join(out_dir, "trace_1_2.json"))
    k1 = sorted(n for n in names if "fwd90::fwd_kernel" in n)
    bwd = sorted(n for n in names if "bwd90::dkv_kernel" in n or "bwd90::dq_kernel" in n)
    check(bool(k1) and bool(bwd),
          f"the profiler's trace of step 1 names K1 {k1[:1]} and K4/K5 {bwd[:1]} "
          f"({len(names)} kernel names)")

    # ---- the remat levels on the first batch ---------------------------------
    def run_level(batch, level, freeze_vision, freeze_text, keep):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t = time.perf_counter()
        grads, loss, _, _ = _backward(
            lv, batch, trainer.cfg, level, vision_chunk, freeze_vision, freeze_text,
            fold=trainer.tx.frozen if not freeze_text else frozenset(),
        )
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        kept = torch.cat([g.float().flatten() for n, g in sorted(grads.items()) if keep(n)])
        del grads
        return loss, kept, _read_counts()["flash_fwd"], torch.cuda.max_memory_allocated() / 1e9, dt

    def compare(tag, batch, levels, freeze_vision, freeze_text, keep, k1_want=None):
        (la, ga, ka, pa, ta), (lb, gb, kb, pb, tb) = (
            run_level(batch, lv_, freeze_vision, freeze_text, keep) for lv_ in levels)
        cos = F.cosine_similarity(ga, gb, dim=0).item()
        print(f"[recipe] remat {levels[0]!r} vs {levels[1]!r}, {tag}: loss {la.item():.6f} vs "
              f"{lb.item():.6f}; gradient cosine {cos:.6f} (>= {REMAT_GRAD_COS}); K1 launches "
              f"{ka} vs {kb}; peak allocated {pa:.2f} vs {pb:.2f} GB; {ta:.2f} vs {tb:.2f} s")
        check(torch.equal(la, lb) and cos >= REMAT_GRAD_COS
              and (k1_want is None or (ka, kb) == k1_want),
              f"remat {levels[0]!r} vs {levels[1]!r} ({tag}): the same loss bits and gradients"
              + (f", K1 launches {k1_want}" if k1_want else ""))

    is_b = lambda n: n.endswith(".lora.b")  # noqa: E731
    batch = to_device(first, dev)
    compare(f"{seq_len} tokens, B adapters", batch, (True, "flash"), True, False, is_b,
            (2 * n_layers, n_layers))
    head = to_device(_head_batch(first, dots_len), dev)
    compare(f"the first {dots_len} tokens, B adapters", head, ("dots", True), True, False, is_b,
            (2 * n_layers, 2 * n_layers))
    rng = np.random.default_rng(SEED + 7)
    grid = (2, 3)
    t2_tiles = rng.standard_normal((1 + grid[0] * grid[1], vc.image_size, vc.image_size, 3),
                                   dtype=np.float32)
    pack = _train_pack(cfg, vit_len, [], [(t2_tiles, grid)], rng, text_segments=2,
                       answer=answer, text_sup=text_sup)
    compare(f"T2's geometry at {vit_len} tokens (trainable tower), tower gradients",
            to_device(collate_packs([pack], vit_len), dev), ("vit", True), False, True,
            lambda n: n.startswith("vision."))
    del batch, head

    # ---- merge_lora and the adapters' files ----------------------------------
    tail = to_device(_head_batch(first, merge_len), dev)
    last = torch.full((1, 1), merge_len - 1, dtype=torch.int32, device=dev)

    def last_row(params):
        with torch.no_grad():
            return long_vita_forward(
                params, tail["tokens"], tail["positions"], trainer.cfg, images=tail["images"],
                image_indices=tail["image_indices"], segment_ids=tail["segment_ids"],
                logit_positions=last, vision_chunk=vision_chunk)[0][0, -1]

    adapted = last_row(lv)
    merged = merge_lora(lv, lcfg_text)
    check(_logit_check("recipe", "merge_lora vs the adapted model", last_row(merged), adapted),
          "merge_lora passes the logit gate")
    del merged
    saved = {t: {k: v.clone() for k, v in ab.items()} for t, ab in lora_subtree(lv).items()}
    lora_dir = os.path.join(root, "lora")
    save_lora(lora_dir, lv, lcfg_text, lcfg)
    dtype = next(iter(saved.values()))["a"].dtype
    load_lora(lora_dir, lv, lcfg_text, dtype=dtype)
    back = lora_subtree(lv)
    check(back.keys() == saved.keys() and all(
        torch.equal(back[t][k], saved[t][k]) for t in saved for k in ("a", "b")),
        f"save_lora -> load_lora round-trips {len(saved)} targets' adapters bit for bit "
        f"({sorted(os.listdir(lora_dir))})")
    del trainer, lv, saved, back
    if failures:
        raise AssertionError(f"phase_recipe: {failures}")
    return counts


# ---------------------------------------------------------------------------
# the twentieth slice: the JAX package's orbax stores from the training entry
# ---------------------------------------------------------------------------

ORBAX_LAYERS = 2  # the decoder's depth in phase_orbax (Qwen2.5-14B's widths)
ORBAX_FIXTURE = os.path.join("tests", "data", "orbax_jax_tiny")  # tools/make_orbax_fixture.py


def _store_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _fixture_check(root) -> tuple:
    """The JAX-written fixture (OCDBT, zarr v2, zstd; written by the JAX
    package with tools/make_orbax_fixture.py) decoded by the port against
    the arrays saved beside it. -> (arrays that match bit for bit, arrays,
    whether the store holds the same names)."""
    import numpy as np

    from long_vita_tpu_torch.utils import orbax_store

    want = np.load(os.path.join(root, "leaves.npz"))
    step = os.path.join(root, "store", "3")
    got = {}
    for item in ("params", "opt_state"):
        got.update({f"{item}.{k}": v for k, v in
                    orbax_store.Item(os.path.join(step, item)).arrays().items()})
    names = set(want.files) - {"bfloat16"}
    same = [n for n in sorted(names) if n in got and got[n].dtype == want[n].dtype
            and got[n].shape == want[n].shape and np.array_equal(got[n], want[n])]
    ok_step = orbax_store.read_step_item(os.path.join(step, "step")) == 3
    return len(same) + ok_step, len(names) + 1, set(got) == names


def phase_orbax(*, layers=ORBAX_LAYERS, seq_len=4096, budget=2048, steps=2, device="cuda",
                cfg=None, first_special=QWEN25_FIRST_ADDED, vision_chunk=64, n_docs=4,
                doc_ids=1200, n_captions=8, n_chat=8, chat_ids=300) -> dict:
    """The JAX package's orbax stores from the training entry point, at full
    width: the Qwen2.5-14B VLM (h 5120, 40/8 heads, ffn 13824, vocab
    152064) with the decoder cut to ``layers`` layers and a random
    InternViT-300M tower, written as a *_HF directory with the Qwen2
    tokenizer fixture (tokenizer_dir, its added tokens at first_special);
    a recipe that
    fine-tunes the whole decoder in bf16 (the tower frozen; optax keeps the
    moments in the parameters' dtype), seq_len tokens a pack with images,
    remat "flash", run.save_dir with save_interval 1, ``steps`` steps,
    through train.build_from_recipe and Trainer.train as train.main runs
    them (each reading the tokenizer from the directory). Every save
    writes an orbax store (training/checkpoint.py) and is timed. Step 1's
    store is then handed to a second save_dir, and a second
    build_from_recipe resumes from it. Gates: every parameter, mu, nu and
    the count it restores equal what step 1 held, bit for bit, on the
    card; its step-2 loss equals the uninterrupted run's, bit for bit;
    restore_params_only into a tp-2 shard's layout (rank 0's
    tree, made on one process) reads exactly the shard's bytes (the tower
    and projector whole, the decoder's slices: about half of it) and gets
    the step-1 slices bit for bit; the JAX-written fixture decodes to the
    arrays saved beside it; K1, K3 and K4/K5 launched as the first run's
    layers, steps and tiles need. The write and read rates are printed in
    GB/s beside the card's nvidia-smi line. -> the first run's launches."""
    import dataclasses

    import numpy as np
    import torch

    from long_vita_tpu_torch.config import long_vita_14b
    from long_vita_tpu_torch.models import qwen2
    from long_vita_tpu_torch.ops import flash_attention as fa
    from long_vita_tpu_torch.parallel.comm import ThreadComm
    from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from long_vita_tpu_torch.parallel.sharding import leaf_layout, shard_params, slice_leaf
    from long_vita_tpu_torch.tokenizer import load_tokenizer
    from long_vita_tpu_torch.training import checkpoint as ckpt
    from long_vita_tpu_torch.training import train as ttrain
    from long_vita_tpu_torch.utils import orbax_store
    from long_vita_tpu_torch.utils.export_hf import save_hf_checkpoint

    t_phase = time.perf_counter()
    cpu = device == "cpu"
    dev = torch.device(device)
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    base = cfg or long_vita_14b()
    cfg = dataclasses.replace(base, text=dataclasses.replace(base.text,
                                                             num_hidden_layers=layers))
    failures = []

    def check(ok: bool, what: str) -> None:
        print(f"[orbax] {what}: {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(what)

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_orbax_", dir=build)
    real_save, real_load = ckpt.save_checkpoint, ckpt.load_checkpoint
    saves, loads, held = [], [], {}

    def save_spy(directory, state, step=None, **kw):
        step = state.step if step is None else step
        if step == 1 and not held:  # what step 1 holds, kept on the card
            opt = state.opt_state
            held.update(params={n: p.detach().clone() for n, p in
                                state.params.named_parameters()},
                        mu={n: t.clone() for n, t in opt.mu.items()},
                        nu={n: t.clone() for n, t in opt.nu.items()}, count=opt.count)
        before = orbax_store.steps(directory)
        sync()
        t = time.perf_counter()
        real_save(directory, state, step, **kw)
        sync()
        dt = time.perf_counter() - t
        wrote = step not in before and step in orbax_store.steps(directory)
        saves.append((step, dt, _store_bytes(os.path.join(directory, str(step))) if wrote
                      else 0))

    def load_spy(directory, state, **kw):
        sync()
        t = time.perf_counter()
        out = real_load(directory, state, **kw)
        sync()
        loads.append((time.perf_counter() - t, _store_bytes(os.path.join(
            directory, str(ckpt.latest_step(directory))))))
        return out

    try:
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(SEED + 90)
        rng = np.random.default_rng(SEED + 91)
        px = cfg.vision.image_size
        probe = rng.standard_normal((2, px, px, 3), dtype=np.float32)
        lv, _ = _vlm_params(qwen2.init_qwen2_params(gen, cfg.text, torch.bfloat16, dev), cfg,
                            dev, SEED + 90, probe)
        model_dir = os.path.join(work, "ckpt")
        save_hf_checkpoint(lv, cfg, model_dir)
        tokenizer_dir(model_dir, first_special)
        text_gb = sum(p.nbytes for p in lv.text.parameters()) / 1e9
        whole_gb = sum(p.nbytes for p in lv.parameters()) / 1e9
        del lv
        corpus = _recipe_inputs(work, load_tokenizer(model_dir), image_px=px, n_docs=n_docs,
                                doc_ids=doc_ids, n_captions=n_captions, n_chat=n_chat,
                                chat_ids=chat_ids, seed=SEED + 92)
        first, second = os.path.join(work, "run"), os.path.join(work, "resumed")

        def recipe(save_dir):
            path = os.path.join(work, f"{os.path.basename(save_dir)}.yaml")
            with open(path, "w") as f:  # YAML's flow style is JSON
                json.dump({
                    "model": {"checkpoint": model_dir, "dtype": "bfloat16"},
                    "data": {"corpus": corpus, "seq_len": seq_len, "logit_budget": budget,
                             "vision_chunk": vision_chunk, "cross_dataset_joint": True},
                    "optim": {"lr": 1.0e-4, "warmup_steps": 0, "total_steps": 1000,
                              "freeze_vision": True},
                    "run": {"steps": steps, "remat": "flash", "seed": SEED,
                            "save_dir": save_dir, "save_interval": 1},
                }, f)
            return ttrain.load_recipe(path)

        ckpt.save_checkpoint, ckpt.load_checkpoint = save_spy, load_spy
        try:
            trainer, batches, _ = ttrain.build_from_recipe(recipe(first), device=dev)
            print(f"[orbax] the {layers}-layer VLM at full width ({whole_gb:.2f} GB, the "
                  f"decoder {text_gb:.2f} GB) written as a checkpoint directory and built "
                  f"from the recipe in {time.perf_counter() - t0:.1f} s; moments for "
                  f"{len(trainer.state.opt_state.mu)} tensors")
            seen = []

            def stream():
                for batch in batches:
                    seen.append(batch)
                    yield batch

            _reset_counts()
            t0 = time.perf_counter()
            losses = trainer.train(stream())["losses"]
            sync()
            counts = _read_counts()
            tiles = [0 if b["images"] is None else len(b["images"]) for b in seen]
            print(f"[orbax] the uninterrupted run: losses {losses} in "
                  f"{time.perf_counter() - t0:.1f} s, saves included; tiles a pack {tiles}")
            check(len(losses) == steps and all(np.isfinite(losses)) and any(tiles),
                  "every step's loss is finite and the packs hold images (K3 runs)")
            del trainer, batches
            gc.collect()
            if not cpu:
                torch.cuda.empty_cache()
            # step 1's store into a save_dir of its own; step 2's stays behind
            os.makedirs(second)
            os.rename(os.path.join(first, "1"), os.path.join(second, "1"))
            shutil.copy(os.path.join(first, orbax_store.LAYOUT), second)
            shutil.rmtree(first)
            t0 = time.perf_counter()
            resumed, again, _ = ttrain.build_from_recipe(recipe(second), device=dev)
            print(f"[orbax] the second build_from_recipe resumed step {resumed.start_step} in "
                  f"{time.perf_counter() - t0:.1f} s")
            state = resumed.state
            same = {kind: [n for n, t in held[kind].items()
                           if n in got and got[n].dtype == t.dtype and torch.equal(got[n], t)]
                    for kind, got in (("params", {n: p.detach() for n, p in
                                                  state.params.named_parameters()}),
                                      ("mu", state.opt_state.mu), ("nu", state.opt_state.nu))}
            check(resumed.start_step == 1 and state.step == 1 and state.opt_state.count
                  == held["count"] == 1
                  and all(len(same[k]) == len(held[k]) for k in same)
                  and state.opt_state.mu.keys() == held["mu"].keys(),
                  f"the resumed state equals step 1's bit for bit on the {dev.type}: "
                  f"{len(same['params'])}/{len(held['params'])} parameters, "
                  f"{len(same['mu'])}/{len(held['mu'])} mu, {len(same['nu'])}/"
                  f"{len(held['nu'])} nu, count {state.opt_state.count}")
            tail = resumed.train(itertools.islice(again, 1, None))["losses"]
            print(f"[orbax] step 2's loss: resumed {tail} vs uninterrupted {losses[1:]} "
                  f"(the same bits: {tail == losses[1:]})")
            check(len(tail) == steps - 1 and tail == losses[1:],
                  "the resumed run's step-2 loss equals the uninterrupted run's bits")
        finally:
            ckpt.save_checkpoint, ckpt.load_checkpoint = real_save, real_load
        whole = resumed.state.params
        del resumed, again, state
        gc.collect()
        # restore_params_only into tp rank 0's tree of tp 2, made on one process
        mesh = make_mesh(MeshConfig(tp=2), ThreadComm.group(2)[0])
        shard = shard_params(whole, mesh, cfg, own=True)
        del whole
        layout = leaf_layout(shard, cfg, 0, 2)
        stats = {}
        sync()
        t0 = time.perf_counter()
        ckpt.restore_params_only(second, shard, step=1, layout=layout, stats=stats)
        sync()
        t_shard = time.perf_counter() - t0
        wanted = {n: slice_leaf(held["params"][n], layout[n]) for n, _ in
                  shard.named_parameters()}
        exact = sum(torch.equal(p, wanted[n]) for n, p in shard.named_parameters())
        text_bytes = sum(t.nbytes for n, t in held["params"].items() if n.startswith("text."))
        text_read = sum(wanted[n].nbytes for n in wanted if n.startswith("text."))
        print(f"[orbax] restore_params_only at tp 2 (rank 0): read {stats['bytes_read'] / 1e9:.3f}"
              f" GB in {t_shard:.2f} s, of it the decoder's slices {text_read / 1e9:.3f} of its "
              f"{text_bytes / 1e9:.3f} GB ({text_read / text_bytes:.3f})")
        check(exact == len(wanted) and stats["bytes_read"] == sum(t.nbytes for t in
                                                                    wanted.values()),
              f"the tp-2 shard holds step 1's slices bit for bit ({exact}/{len(wanted)}) and "
              f"read exactly their bytes")
        del shard, wanted, held
        leaves, total, names = _fixture_check(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), ORBAX_FIXTURE))
        check(names and leaves == total,
              f"the JAX-written fixture (OCDBT, zstd) decodes bit for bit: {leaves}/{total} "
              "arrays")
        written = [(s, dt, b) for s, dt, b in saves if b]
        for s, dt, b in written:
            print(f"[orbax] save of step {s}: {b / 1e9:.3f} GB in {dt:.2f} s = "
                  f"{b / 1e9 / dt:.3f} GB/s")
        for dt, b in loads:
            print(f"[orbax] resume (load_checkpoint): {b / 1e9:.3f} GB in {dt:.2f} s = "
                  f"{b / 1e9 / dt:.3f} GB/s")
        check(len(written) == steps + 1 and len(loads) == 1,
              f"{len(written)} stores written ({len(saves) - len(written)} saves of a step "
              "already held skipped), one resume")
        if not cpu:
            print(f"[orbax] {_nvidia_smi()}: write "
                  f"{[round(b / 1e9 / dt, 3) for _, dt, b in written]} GB/s, read "
                  f"{[round(b / 1e9 / dt, 3) for dt, b in loads]} GB/s (warm page cache)")
            n_vit = cfg.vision.num_hidden_layers
            expected = {"flash_fwd": layers * steps,
                        "short_attn": n_vit * sum(-(-t // vision_chunk) for t in tiles)}
            if fa.bwd_uses_fused(1, seq_len, seq_len, cfg.text.num_attention_heads,
                                 cfg.text.head_dim, 2):
                expected["flash_bwd"] = layers * steps
            else:
                expected["flash_bwd_dkv"] = expected["flash_bwd_dq"] = layers * steps
            _check_launches(counts, expected)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[orbax] the phase took {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError(f"phase_orbax: {failures}")
    return counts


# ---------------------------------------------------------------------------
# the eleventh slice: the forward-kernel lab (K7), the generic towers, MoE
# ---------------------------------------------------------------------------

LAB_REPS = 10  # timed calls of each lab contender


def phase_fwd_lab(*, s_check=4096, s_lab=16384, heads=(40, 8), d=128, dev=None) -> tuple:
    """K7, the forward-kernel lab's variants of the Hopper forward. First
    each variant against variant_flash_reference at [1, s_check, heads, d]
    (the plain version a kv head's group at a time), o to O_ATOL + O_RTOL x
    |ref| and the lse to LSE_ATOL; these launches are not counted. Then the
    lab's main path (benchmarks/fwd_kernel_lab.run_lab at s_lab, the lab's
    16K 40/8 shape): K1, every variant and the library call timed, K1 and
    each variant held to the plain version's 16K output at the same
    tolerances, K4 and K5 forward + backward timed beside the library's and
    one backward of each held to the plain backward (GRAD_TOL); the launch
    counts of that run exact. -> (the kernels report's K7 entry, the run's
    launch counts)."""
    import torch

    from long_vita_tpu_torch.benchmarks import fwd_kernel_lab as lab

    dev = dev or torch.device("cuda")
    hq, hkv = heads
    rnd = _cp_rand(dev, SEED + 60)
    q, k, v = rnd(1, hq, s_check, d), rnd(1, hkv, s_check, d), rnd(1, hkv, s_check, d)
    ro, rlse = lab.variant_flash_reference(q, k, v)
    errs = []
    for kw in lab.variants():
        before = lab.variant_flash.launches
        o, lse = lab.variant_flash(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        err = (o.float() - ro.float()).abs()
        lse_err = (lse - rlse).abs().max().item()
        ok = (lab.variant_flash.launches == before + 1
              and bool((err <= O_ATOL + O_RTOL * ro.float().abs()).all())
              and lse_err <= LSE_ATOL and bool(torch.isfinite(o.float()).all()))
        errs.append(err.max().item())
        print(f"[lab] {lab.variant_name(kw)} at [1, {s_check}, {hq}/{hkv}, {d}] vs the plain "
              f"version: max|o-ref| {errs[-1]:.3e}, max|lse-ref| {lse_err:.3e} (tol o "
              f"{O_ATOL}+{O_RTOL}*|ref|, lse {LSE_ATOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[{lab.variant_name(kw)}] K7 disagrees with its plain version")
    del q, k, v, ro, rlse, o, lse

    _reset_counts()
    res = lab.run_lab(s=s_lab, heads=heads, d=d, reps=LAB_REPS, seed=SEED + 61,
                      log=lambda line: print(line), device=dev)
    counts = _read_counts()
    if not res["ok"]:
        raise AssertionError(f"at {s_lab} these kernels disagree with their plain versions: "
                             f"{res['failed']}")
    n_var, rb = len(lab.variants()), max(LAB_REPS // 2, 3)
    _check_launches(counts, {
        "fwd_lab": n_var * (LAB_REPS + 3), "flash_fwd": LAB_REPS + 25 + 2 * (2 + rb),
        "flash_bwd": 3 + rb, "flash_bwd_dkv": 3 + rb, "flash_bwd_dq": 3 + rb,
    })
    # the variant with K1's own switches stands for K7 in the report
    own = res["forward"][lab.variant_name(dict(block_kv=128, fastpath=True, cheap_mask=True,
                                               wide_ml=False))]
    sdpa = res["forward"]["SDPA (library, kv repeated)"]
    print(f"[lab] {json.dumps(res)}")
    errs += [r["plain_err"] for n, r in res["forward"].items() if n.startswith("K7")]
    return {"max_abs_err": max(errs), "ms": own["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": "operations",
            "library_ms": sdpa["ms"]}, counts


def _hf_vit_checkpoint(path, cfg, family, gen, dev):
    """Random weights of a CLIP or SigLIP vision tower under HF's names (bf16,
    normal x 0.02, norms near 1, small biases), written as one safetensors
    file with its config.json."""
    import torch

    from long_vita_tpu_torch.utils.checkpoint_io import save_safetensors

    h, i, p = cfg.hidden_size, cfg.intermediate_size, cfg.patch_size

    def r(*shape, scale=0.02, mean=0.0):
        return (mean + scale * torch.randn(shape, generator=gen, device=dev)).to(torch.bfloat16)

    pre = "vision_model."
    sd = {pre + "embeddings.patch_embedding.weight": r(h, 3, p, p),
          pre + "embeddings.position_embedding.weight": r(cfg.seq_len, h)}
    if family == "clip":
        sd[pre + "embeddings.class_embedding"] = r(h)
        sd[pre + "pre_layrnorm.weight"], sd[pre + "pre_layrnorm.bias"] = r(h, mean=1.0), r(h)
    else:
        sd[pre + "embeddings.patch_embedding.bias"] = r(h)
    for layer in range(cfg.num_hidden_layers):
        q = f"{pre}encoder.layers.{layer}."
        for name, shape in (("self_attn.q_proj", (h, h)), ("self_attn.k_proj", (h, h)),
                            ("self_attn.v_proj", (h, h)), ("self_attn.out_proj", (h, h)),
                            ("mlp.fc1", (i, h)), ("mlp.fc2", (h, i))):
            sd[q + name + ".weight"], sd[q + name + ".bias"] = r(*shape), r(shape[0])
        for name in ("layer_norm1", "layer_norm2"):
            sd[q + name + ".weight"], sd[q + name + ".bias"] = r(h, mean=1.0), r(h)
    os.makedirs(path, exist_ok=True)
    save_safetensors(sd, os.path.join(path, "model.safetensors"))
    act = "quick_gelu" if family == "clip" else "gelu_pytorch_tanh"
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"hidden_size": h, "intermediate_size": i, "num_hidden_layers":
                   cfg.num_hidden_layers, "num_attention_heads": cfg.num_attention_heads,
                   "image_size": cfg.image_size, "patch_size": p, "hidden_act": act,
                   "layer_norm_eps": cfg.layer_norm_eps}, f)
    return sum(t.numel() * 2 for t in sd.values())


def _feature_gate(tag, feats, ref) -> None:
    """§2's ViT-feature gate: relative Frobenius error and the worst row's
    cosine, kernels against the plain attention."""
    rel, row_cos = _rel_err(feats, ref)
    ok = rel <= FEAT_REL_ERR and row_cos >= FEAT_ROW_COS
    print(f"[vit] {tag}: relative error {rel:.3e} (<= {FEAT_REL_ERR}), worst row cosine "
          f"{row_cos:.6f} (>= {FEAT_ROW_COS}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] the tower's features through the kernels disagree")


def _rel_err(a, b) -> tuple:
    """(relative Frobenius error, worst row's cosine) of a against b."""
    import torch.nn.functional as F

    a = a.float().reshape(-1, a.shape[-1])
    b = b.float().reshape(-1, b.shape[-1])
    return ((a - b).norm() / b.norm()).item(), F.cosine_similarity(a, b, dim=-1).min().item()


def phase_generic_vit(work, *, n_tiles=8, configs=None, dev=None) -> dict:
    """The alternative vision towers at their published widths, random
    weights from the seed: CLIP ViT-L/14 at 448 (1025 tokens, D 64) and
    SigLIP so400m at 384 (729 tokens, D 72, padded to 128 for the kernels)
    written as HF safetensors under ``work`` and loaded with the port's
    loaders, EVA-4B at 448 (D 112) from init_generic_vit_params; n_tiles
    tiles through K1 ("auto") against the plain attention under §2's
    ViT-feature gate (EVA: its first EVA_GATE_LAYERS layers so, then all 63
    with both paths against an f32 tower, EVA_F32_RATIO). Then SigLIP
    trainable: one backward through K4 or K5
    (JAX's rule) at the padded D against the plain attention's, the tower's
    gradients at cosine >= TRAIN_GRAD_COS. Launches exact. configs: {"clip",
    "siglip", "eva"} -> GenericViTConfig in place of the published ones (the
    CPU rehearsal's tiny towers). -> the counts."""
    import copy
    import dataclasses

    import torch
    import torch.nn.functional as F

    from long_vita_tpu_torch.models import generic_vit as gv
    from long_vita_tpu_torch.ops import flash_attention as fa
    from long_vita_tpu_torch.utils import vision_loaders as vl

    dev = dev or torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 70)
    total = dict.fromkeys(SOURCES, 0)
    configs = configs or {"clip": gv.clip_vit_300m(448), "siglip": gv.siglip_so400m(384),
                          "eva": gv.eva_4b(448)}

    def run(tag, params, cfg, f32_anchor=False):
        side = cfg.grid * cfg.patch_size  # SigLIP's 384 px: its conv drops the last 6
        px = torch.randn(n_tiles, side, side, 3, generator=gen, device=dev).to(torch.bfloat16)
        _reset_counts()
        feats, t = _timed(lambda: gv.generic_vit(params, px, cfg))
        counts = _read_counts()
        _check_launches(counts, {"flash_fwd": cfg.num_hidden_layers})
        for key in total:
            total[key] += counts[key]
        fps = n_tiles / t
        _, t2 = _timed(lambda: gv.generic_vit(params, px, cfg))
        _reset_counts()
        ref = gv.generic_vit(params, px, cfg, attn_impl="xla")
        print(f"[vit] {tag}: {cfg.num_hidden_layers} layers, {cfg.hidden_size} wide, "
              f"{cfg.num_attention_heads} heads of {cfg.head_dim}, {cfg.seq_len} tokens a tile; "
              f"{n_tiles} tiles through K1 in {t2 * 1e3:.1f} ms = {n_tiles / t2:.1f} frames/s "
              f"(first call {fps:.1f})")
        if not f32_anchor:
            _feature_gate(f"{tag}, K1 vs the plain attention", feats, ref)
            return px
        with torch.no_grad():
            truth = gv.generic_vit(copy.deepcopy(params).float(), px.float(), cfg,
                                   attn_impl="xla")
        (k_rel, k_cos), (p_rel, _) = _rel_err(feats, truth), _rel_err(ref, truth)
        gap, gap_cos = _rel_err(feats, ref)
        ok = k_rel <= EVA_F32_RATIO * p_rel and k_cos >= FEAT_ROW_COS
        print(f"[vit] {tag} vs an f32 tower: K1's path relative error {k_rel:.3e}, the plain "
              f"path's {p_rel:.3e} (K1 <= {EVA_F32_RATIO} x plain), K1's worst row cosine "
              f"{k_cos:.6f} (>= {FEAT_ROW_COS}); K1 vs plain {gap:.3e} / {gap_cos:.6f} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[{tag}] K1's path is farther from an f32 tower than the plain")
        return px

    for family, load in (("clip", vl.load_clip_vit_params),
                         ("siglip", vl.load_siglip_vit_params)):
        cfg = configs[family]
        path = os.path.join(work, family)
        (n_bytes, t_w) = _timed(lambda: _hf_vit_checkpoint(path, cfg, family, gen, dev))
        hf_cfg = vl.vit_config_from_hf(path, family)
        if dataclasses.asdict(hf_cfg) != dataclasses.asdict(cfg):
            raise AssertionError(f"vit_config_from_hf({family}) gave {hf_cfg}, not {cfg}")
        params, t_l = _timed(lambda: load(path, cfg, dtype=torch.bfloat16, device=dev))
        print(f"[vit] {family}: wrote {n_bytes / 1e9:.3f} GB of HF safetensors in {t_w:.2f} s, "
              f"loaded in {t_l:.2f} s")
        px = run(f"{family} ({'CLIP ViT-L/14 @448' if family == 'clip' else 'SigLIP so400m @384'})",
                 params, cfg)
        if family == "siglip":
            siglip, siglip_px = params, px
        else:
            del params, px
        shutil.rmtree(path, ignore_errors=True)

    cfg = configs["eva"]
    eva, t_i = _timed(lambda: gv.init_generic_vit_params(gen, cfg, torch.bfloat16, dev))
    n = sum(p.numel() for p in eva.parameters())
    print(f"[vit] eva_4b: {n / 1e9:.3f} B random bf16 params ({2 * n / 1e9:.2f} GB) built in "
          f"{t_i:.1f} s")
    del px
    cut = min(EVA_GATE_LAYERS, cfg.num_hidden_layers)
    eva_cut = gv.GenericViTParams(
        patch_embed=eva.patch_embed, pos_embed=eva.pos_embed, layers=list(eva.layers)[:cut],
        cls_token=eva.cls_token, pre_norm=eva.pre_norm, final_norm=eva.final_norm)
    run(f"EVA-4B @448, its first {cut} layers", eva_cut,
        dataclasses.replace(cfg, num_hidden_layers=cut))
    del eva_cut
    run("EVA-4B @448", eva, cfg, f32_anchor=True)
    del eva
    torch.cuda.empty_cache()

    # SigLIP trainable: one backward through K4/K5 at the padded head dim
    cfg = configs["siglip"]
    fused = fa.bwd_uses_fused(n_tiles, cfg.seq_len, cfg.seq_len, cfg.num_attention_heads, 128, 2)
    g = torch.randn(n_tiles, cfg.seq_len, cfg.hidden_size, generator=gen, device=dev)
    g = g.to(torch.bfloat16)
    leaves = list(siglip.parameters())

    def grads(impl):
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        out = gv.generic_vit(siglip, siglip_px, cfg, attn_impl=impl)
        (out.float() * g.float()).sum().backward()
        flat = torch.cat([p.grad.float().reshape(-1) for p in leaves])
        for p in leaves:
            p.grad = None
        return flat

    _reset_counts()
    got, t_b = _timed(lambda: grads("auto"))
    counts = _read_counts()
    layers = cfg.num_hidden_layers
    _check_launches(counts, {"flash_fwd": layers,
                             **({"flash_bwd": layers} if fused else
                                {"flash_bwd_dkv": layers, "flash_bwd_dq": layers})})
    for key in total:
        total[key] += counts[key]
    _reset_counts()
    ref = grads("xla")
    cos = F.cosine_similarity(got, ref, dim=0).item()
    ok = cos >= TRAIN_GRAD_COS and bool(torch.isfinite(got).all())
    print(f"[vit] SigLIP so400m trainable, {n_tiles} tiles: forward + backward through K1 and "
          f"{'K4' if fused else 'K5'} at the padded D 128 in {t_b * 1e3:.1f} ms; the tower's "
          f"{got.numel() / 1e6:.1f} M gradients vs the plain attention's: cosine {cos:.6f} "
          f"(>= {TRAIN_GRAD_COS}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("SigLIP's gradients through K4/K5 disagree with the plain attention")
    del siglip, leaves, got, ref
    return total


@contextlib.contextmanager
def _routing_tap(forced=None, part=None, per_thread=True):
    """Within the block, ops.moe.route records the expert ids of each call,
    in order, in a list per thread (thread-ranks route at once; with
    per_thread False one list for the process, whose backward recomputes
    layers on autograd's device thread); with ``forced`` (a list of id
    tensors) the i-th call of a list routes to forced[i] instead (with
    ``part`` (i, n), the i-th of n equal row blocks of it: an
    expert-parallel rank's share of a call that routed n ranks' rows), its
    gates the call's own probabilities at those ids (teacher forcing of the
    routes). -> {thread id, or None: [recorded ids]}."""
    import threading

    from long_vita_tpu_torch.ops import moe

    orig, seen = moe.route, {}

    def tap(router, xe, top_k):
        calls = seen.setdefault(threading.get_ident() if per_thread else None, [])
        probs, gates, ids = orig(router, xe, top_k)
        if forced is not None:
            want = forced[len(calls)].to(ids.device)
            if part is not None:
                want = want.chunk(part[1])[part[0]]
            if want.shape != ids.shape:
                raise AssertionError("the forced routes do not match the calls' tokens")
            ids = want
            gates = probs.gather(-1, ids)
        calls.append(ids)
        return probs, gates, ids

    moe.route = tap
    try:
        yield seen
    finally:
        moe.route = orig


def phase_moe(*, layers=4, experts=8, n_prompt=2048, n_new=8, chunk=2048, tp_layers=4,
              base=None, dev=None) -> dict:
    """A MoE decoder at the 14B's widths (h 5120, ffn 13824 an expert, 40/8
    heads) with ``experts`` experts, top-2, capacity 1.25, cut to ``layers``
    layers (~3.4 GB of experts a layer), random bf16 weights. Serving: an
    n_prompt-id prompt and n_new greedy tokens through InferenceEngine
    (chunked prefill, each chunk and decode step routed with its own
    capacity), K1 launches exact, the last-row logits against the plain
    attention's chunked flow under §2's logit gate, that flow routed as the
    kernel path routed (_routing_tap): with random routers a token's top-2
    margin is of the order of bf16 rounding, a few tokens a layer change
    experts between the two paths, and each such token's hidden state (and
    the capacity's token-major slots after it) changes wholesale. Then the
    decoder's first ``tp_layers`` layers over tp 2 thread-ranks (each rank
    its heads and the experts' ffn columns, their partial output summed over
    tp) against the one-device engine on the same weights
    (_cp_against_one_device, routed: the one-device engine fed the tp
    engine's tokens and routes), K1 launches exact. Training this model
    (one device, and expert parallelism over dp 2) is phase_ep_train's.
    base: the config whose widths are taken (long_vita_14b(); the CPU
    rehearsal's tiny one).
    -> launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from long_vita_tpu_torch.config import long_vita_14b
    from long_vita_tpu_torch.inference.engine import InferenceEngine
    from long_vita_tpu_torch.inference.sampler import SamplingParams
    from long_vita_tpu_torch.models import qwen2
    from long_vita_tpu_torch.parallel.mesh import MeshConfig

    t_phase = time.perf_counter()
    dev = dev or torch.device("cuda")
    base = base or long_vita_14b()
    cfg = dataclasses.replace(base, text=dataclasses.replace(
        base.text, num_hidden_layers=layers, num_experts=experts))
    tc = cfg.text
    gen = torch.Generator(device=dev).manual_seed(SEED + 80)
    text, t_i = _timed(lambda: qwen2.init_qwen2_params(gen, tc, torch.bfloat16, dev))
    n = sum(p.numel() for p in text.parameters())
    print(f"[moe] decoder: {layers} layers at the 14B's widths, {experts} experts of ffn "
          f"{tc.intermediate_size}, top-{tc.moe_top_k}, capacity {tc.moe_capacity_factor}; "
          f"{n / 1e9:.3f} B random bf16 params built in {t_i:.1f} s")
    total = dict.fromkeys(SOURCES, 0)

    engine = InferenceEngine(text, cfg, _StubMM(), max_seq_len=2 * chunk, chunk=chunk,
                             cache_dtype=torch.bfloat16)
    prompt = np.random.default_rng(SEED + 81).integers(0, tc.vocab_size, n_prompt).tolist()
    sp = SamplingParams(max_new_tokens=n_new)
    _reset_counts()
    first, t_first = _timed(lambda: engine.generate(input_ids=prompt, sampling=sp))
    again, t_again = _timed(lambda: engine.generate(input_ids=prompt, sampling=sp))
    counts = _read_counts()
    chunks = -(-n_prompt // chunk)
    _check_launches(counts, {"flash_fwd": 2 * layers * chunks})
    for key in total:
        total[key] += counts[key]
    if first.token_ids != again.token_ids or len(first.token_ids) != n_new:
        raise AssertionError(f"MoE greedy generate: {first.token_ids} vs {again.token_ids}")
    with _routing_tap() as tapped:
        ttft, _, logits, decode_ms = _ttft_decode(engine, prompt, t_again, n_new)
    routes = next(iter(tapped.values()))
    print(f"[moe] {n_prompt}-id prompt, {n_new} greedy tokens x2 identical {first.token_ids}; "
          f"TTFT {ttft * 1e3:.1f} ms, decode {decode_ms:.2f} ms/token (first generate "
          f"{t_first:.2f} s)")
    _reset_counts()
    with _routing_tap() as tapped:
        _plain_chunked_last_row(text, tc, prompt, chunk, 2 * chunk)
    free = next(iter(tapped.values()))
    moved = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                for a, b in zip(routes, free))
    with _routing_tap(forced=routes):
        plain = qwen2.lm_head(text, _plain_chunked_last_row(text, tc, prompt, chunk, 2 * chunk))
    print(f"[moe] the plain flow left to route itself sends {moved} of "
          f"{sum(r.shape[0] for r in routes)} token-layers to other experts than the kernel "
          f"path; the gate below routes it as the kernel path did")
    if not _logit_check("moe", "kernel path vs plain chunked prefill", logits, plain):
        raise AssertionError("the MoE decoder's logits disagree with the plain attention's")
    del engine, logits, plain
    # the decoder's first tp_layers layers over tp 2 thread-ranks
    text_tp, cfg_tp = _decoder_prefix(text, cfg, tp_layers)
    counts = _cp_against_one_device(
        "moe tp", text_tp, cfg_tp, prompt, seq=2 * chunk, chunk=chunk, vision_chunk=64,
        expected=lambda n: {"flash_fwd": 2 * tp_layers * -(-n // chunk)}, tokens=n_new,
        mesh_cfg=MeshConfig(tp=2), routed=True)
    for key in total:
        total[key] += counts[key]
    del text, text_tp
    print(f"[moe] phase {time.perf_counter() - t_phase:.1f} s")
    return total


# ---------------------------------------------------------------------------
# context parallelism: thread-ranks on one card (parallel/comm.ThreadComm)
# ---------------------------------------------------------------------------

CP = 4  # thread-ranks of the cp phases (one card: they share it)
# the decoder's depth in the cp and tp serving phases of the full run (24
# until the pp training phase joined, 8 until the 2-D tp geometry did)
SERVE_PREFIX = 2
# the 14B decoder's depth in the quantised and multimodal serving, server,
# T1 / T2 and recipe phases (48 until the expert-parallel phase joined the
# run, 24 until the pp x FSDP phase did), for the run's time; phase_serving
# runs all 48
MAIN_LAYERS = 12
CP_SEQ = 65536  # tokens of the cp attention phases: zigzag chunks of 8192
CP_TIMEOUT = 900.0  # seconds any one wait of a thread-rank may take
THREADS_NOTE = "4 thread-ranks on one card, not a multi-GPU time"
# cp attention vs K1 over the whole sequence. With N(0, 1) q, k, v a row
# that attends n keys has |o| ~ sqrt(e / n), about 0.01 over most of a 64K
# causal sequence, where O_ATOL alone would pass an output that is wrong: o
# is held to CP_O_RMS_FRAC x RMS(ref) absolute + O_RTOL x |ref|, and the
# merged f32 lse to LSE_ATOL.
CP_O_RMS_FRAC = 0.1


def cp_forward_check(o, ref_o, lse, ref_lse, rms=None) -> dict:
    """A cp attention's forward against K1 over the whole sequence: o held
    elementwise to CP_O_RMS_FRAC x RMS(ref) absolute + O_RTOL x |ref| (rms:
    RMS(ref) of the whole reference, when o and ref_o are one rank's shard
    of it), the merged f32 lse to LSE_ATOL. -> {"err": max|o - ref|,
    "worst": the largest err / tol (<= 1 passes), "atol", "lse_err",
    "ok"}."""
    import torch

    ro = ref_o.float()
    if rms is None:
        rms = ro.square().mean().sqrt().item()
    atol = CP_O_RMS_FRAC * rms
    err = (o.float() - ro).abs()
    worst = (err / (atol + O_RTOL * ro.abs())).max().item()
    lse_err = (lse.float() - ref_lse.float()).abs().max().item()
    ok = worst <= 1 and lse_err <= LSE_ATOL and bool(torch.isfinite(o.float()).all())
    return {"err": err.max().item(), "worst": worst, "atol": atol, "lse_err": lse_err, "ok": ok}


def _cp_rand(dev, seed):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    return rnd


def _by_head(fn, q, kvs, hkv, **kw):
    """A plain attention function one kv head's GQA group at a time (the f32
    logits of an 8192 x 8192 pair would not fit for 40 heads at once): fn(q
    of the group, *each of kvs at the kv head) -> (o, lse) of the whole."""
    import torch

    g = q.shape[2] // hkv
    o = torch.empty_like(q)
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32, device=q.device)
    for h in range(hkv):
        hq = slice(h * g, (h + 1) * g)
        o[:, :, hq], lse[:, hq] = fn(q[:, :, hq], *(t[:, :, h:h + 1] for t in kvs), **kw)
    return o, lse


def _plain_pair_bwd(q, k, v, do, lse, delta, hkv, **kw):
    """The plain backward given lse and delta, a kv head's group at a time."""
    import torch

    from long_vita_tpu_torch.ops import flash_attention as fa

    g = q.shape[2] // hkv
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for h in range(hkv):
        hq, hk = slice(h * g, (h + 1) * g), slice(h, h + 1)
        dq[:, :, hq], dk[:, :, hk], dv[:, :, hk] = fa.flash_attention_bwd_reference(
            q[:, :, hq], k[:, :, hk], v[:, :, hk], None, lse[:, hq], do[:, :, hq],
            delta=delta[:, hq], **kw)
    return dq, dk, dv


def phase_cp_kernels(*, c=CP_SEQ // (2 * CP), shard=16384, q_rows=2048, heads=(40, 8),
                     d=128, dev=None, seg=None) -> dict:
    """K1, K2, K4 and K5 at the shapes context parallelism gives them, each
    against its plain version (a kv head's group at a time):
      - a ring's pairs at C = 8192 (64K tokens over cp 4), the decoder's
        40/8 heads: K1 on the causal diagonal pair and on a full pair
        (ops/attention_pair.pair_attn_fwd), K4 on the pair backward given
        the lse and delta (pair_attn_bwd: K4 by JAX's rule at this shape)
        and K5 forced on the same; without segments and with T1's packed
        segments at 64K zigzagged over cp 4 (rank 1's chunks 1 and 6: the
        full pair's q chunk shares no segment with its kv chunk, so every
        row is the merge identity, o = 0 and lse = -2^30, and no tile runs);
      - the cp cache's partials (ops/cp_cache_attention.local_partial) of a
        2048-row chunk at position 30000 against shards of 16384 slots: rank
        1's (valid to 15664, mid-shard) and rank 2's (no valid slot: o = 0,
        lse = -2^30, no NaN), K1 on a bf16 shard and K2 on an int8 shard.
    Timed: K1 on the diagonal pair and K4 on its backward, and the host time
    of the backward's tile plans (bwd_seg_ranges, bwd_tile_order) on a
    segmented pair. -> {kernel: max |err|}."""
    import numpy as np
    import torch

    from long_vita_tpu_torch.models.qwen2 import quantize_kv
    from long_vita_tpu_torch.ops import attention_pair as ap
    from long_vita_tpu_torch.ops import cp_cache_attention as cc
    from long_vita_tpu_torch.ops import flash_attention as fa
    from long_vita_tpu_torch.ops.flash_attention import NEG_INF
    from long_vita_tpu_torch.parallel.zigzag import zigzag_permute

    dev = dev or torch.device("cuda")
    hq, hkv = heads
    rnd = _cp_rand(dev, SEED + 20)
    q, k, v, do = rnd(1, 2 * c, hq, d), rnd(1, 2 * c, hkv, d), rnd(1, 2 * c, hkv, d), rnd(1, 2 * c, hq, d)
    if seg is None:  # T1's packed layout
        seg = _train_segments(2 * CP * c, (64, 16), (2, 3), dev)
    seg = zigzag_permute(seg, CP)[:, 2 * c:4 * c]  # rank 1: chunks 1 and 2cp - 2
    errs = {"flash_fwd": [], "flash_fwd_quant": [], "flash_bwd": [], "flash_bwd_dkv": []}
    q_a, q_b, k_a, v_a = q[:, :c], q[:, c:], k[:, :c], v[:, :c]
    g_a, g_b = do[:, :c], do[:, c:]
    for segs in (False, True):
        s_a, s_b = (seg[:, :c], seg[:, c:]) if segs else (None, None)
        tag = "T1 segments" if segs else "no segments"
        for name, qx, gx, qs, causal in (("diagonal", q_a, g_a, s_a, True),
                                         ("full", q_b, g_b, s_b, False)):
            kw = dict(causal=causal, q_segment_ids=qs, kv_segment_ids=s_a)
            holder = {}

            def kernel():
                holder["o"], holder["lse"] = ap.pair_attn_fwd(qx, k_a, v_a, **kw)
                return holder["o"], holder["lse"]

            errs["flash_fwd"].append(_pair_case(
                f"cp pair K1 {name} C={c} {hq}/{hkv} heads, {tag}", kernel,
                lambda: _by_head(fa.flash_attention_reference, qx, (k_a, v_a), hkv, **kw),
                fa.flash_attention))
            o, lse = holder["o"], holder["lse"]
            empty = int((lse == NEG_INF).sum().item())
            if segs and name == "full":
                print(f"[cp-kernel] full pair with T1 segments: {empty} of {lse.numel()} "
                      f"(row, head) entries see no key (the merge identity)")
                if not bool((o == 0).all()):
                    raise AssertionError("a pair whose segments do not meet must give o = 0")
            delta = (gx.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
            ref = _plain_pair_bwd(qx, k_a, v_a, gx, lse, delta, hkv, **kw)
            for entry, fused in (("flash_bwd", True), ("flash_bwd_dkv", False)):
                counter = fa.flash_bwd_fused if fused else fa.flash_bwd_dkv
                before = counter.launches
                if fused:
                    got = ap.pair_attn_bwd(qx, k_a, v_a, gx, lse, delta, **kw)
                    if not fa.bwd_uses_fused(1, c, c, hq, d, 2):
                        raise AssertionError("JAX's rule was expected to pick K4 at this pair")
                else:
                    got = fa._flash_bwd_cuda(qx, k_a, v_a, None, lse, gx, causal, 0, 0, c,
                                             qs, s_a, False, delta=delta)
                torch.cuda.synchronize()
                if counter.launches != before + 1:
                    raise AssertionError(f"[{entry}] launch count did not rise by 1")
                errs[entry].append(max(_grad_errs(
                    f"cp pair {'K4 (pair_attn_bwd)' if fused else 'K5 (forced)'} {name} "
                    f"given lse/delta, {tag}", got, ref)))
            del ref
    # timings: K1 on the diagonal pair, K4 on its backward, the tile plans
    kw = dict(causal=True, q_segment_ids=seg[:, :c], kv_segment_ids=seg[:, :c])
    o, lse = ap.pair_attn_fwd(q_a, k_a, v_a, **kw)
    delta = (g_a.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    fwd_ms = queued([lambda: ap.pair_attn_fwd(q_a, k_a, v_a, causal=True)], reps=10)[0]
    bwd_ms = cuda_ms(lambda: ap.pair_attn_bwd(q_a, k_a, v_a, g_a, lse, delta, causal=True), reps=5)
    fa.bwd_operands(q_a, k_a, v_a, None, lse, g_a, True, 0, 0, c, kw["q_segment_ids"],
                    kw["kv_segment_ids"], True, delta=delta)
    torch.cuda.synchronize()
    host = []
    for _ in range(20):
        t = time.perf_counter()
        fa.bwd_operands(q_a, k_a, v_a, None, lse, g_a, True, 0, 0, c, kw["q_segment_ids"],
                        kw["kv_segment_ids"], True, delta=delta)
        host.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    plan_ms = statistics.median(host)
    pairs = c * (c + 1) // 2  # the diagonal pair's unmasked (q, k) pairs
    fwd_bound = _bound(2 * 2 * (2 * q_a.numel() + 2 * k_a.numel()) + 4 * c * hq,
                       4 * hq * d * pairs)
    bwd_bound = _bound(2 * 2 * (3 * q_a.numel() + 4 * k_a.numel()) + 8 * c * hq,
                       10 * hq * d * pairs)
    print(f"[cp-kernel] C={c} pair: K1 diagonal {fwd_ms:.3f} ms (queued; bound "
          f"{fwd_bound['bound_ms']:.3f} ms, {fwd_bound['bound_by']}), K4 pair backward "
          f"{bwd_ms:.3f} ms (CUDA events; bound {bwd_bound['bound_ms']:.3f} ms, "
          f"{bwd_bound['bound_by']}); the backward's operands with segments (tile ranges, "
          f"the heaviest-first kv tile order, the padded ids) take {plan_ms:.3f} ms of host time "
          f"a pair call, and a ring of cp {CP} makes 2 x cp + 1 = {2 * CP + 1} pair calls a "
          f"layer a rank in each direction")

    # ---- cp-cache partials: a chunk of q_rows at position 30000 (at a
    # small rehearsal size: the last shard's start minus half a chunk)
    qo = 30000 if shard == 16384 else shard + shard // 2
    qc = rnd(1, q_rows, hq, d)
    ck, cv = rnd(1, shard, hkv, d), rnd(1, shard, hkv, d)
    kq, ks = quantize_kv(ck)
    vq, vs = quantize_kv(cv)
    for rank in (1, 2):
        start = rank * shard
        valid = min(max(qo + q_rows - start, 0), shard)
        kw = dict(q_offset=qo, kv_offset=start, kv_valid_len=valid)
        name = f"rank {rank} shard [{start}, {start + shard}) valid {valid}"
        errs["flash_fwd"].append(_pair_case(
            f"cp cache K1 partial, chunk {q_rows} @{qo}, {name}",
            lambda: cc.local_partial(qc, ck, cv, qo, start, valid),
            lambda: _by_head(fa.flash_attention_reference, qc, (ck, cv), hkv, causal=True, **kw),
            fa.flash_attention))
        errs["flash_fwd_quant"].append(_pair_case(
            f"cp cache K2 partial (int8 shard), chunk {q_rows} @{qo}, {name}",
            lambda: cc.local_partial(qc, kq, vq, qo, start, valid, ks, vs),
            lambda: _by_head(fa.flash_attention_quant_reference, qc, (kq, ks, vq, vs), hkv, **kw),
            fa.flash_attention_quant))
        if valid == 0:
            for quant in (False, True):
                o, lse = cc.local_partial(qc, kq if quant else ck, vq if quant else cv, qo,
                                          start, 0, *((ks, vs) if quant else ()))
                if not (bool((o == 0).all()) and bool((lse == NEG_INF).all())):
                    raise AssertionError("a shard with no valid slot must give o = 0, lse = -2^30")
            print(f"[cp-kernel] {name}: K1 and K2 give o == 0 and lse == -2^30 (no NaN) ok")
    return {name: max(v) for name, v in errs.items()}


def _cp_layout(algo: str, inner: int) -> int:
    """The zigzag factor of a cp layout: cp (ring), 1 (Ulysses), the ring
    groups (hybrid)."""
    return {"ring": CP, "ulysses": 1, "hybrid": CP // inner}[algo]


def _cp_global_lse(algo: str, inner: int, parts: list):
    """The lse [B, Hq, S] of the whole unpermuted sequence from each rank's:
    the ring's [B, Hq, S/cp] of its zigzag shard; Ulysses' [B, Hq/cp, S] of
    its head group; hybrid's [B, Hq/inner, S/groups] of its lane's head
    group over its ring group's zigzag shard."""
    import torch

    from long_vita_tpu_torch.parallel.zigzag import zigzag_unpermute

    if algo == "ulysses":
        return torch.cat(parts, 1)
    if algo == "hybrid":
        parts = [torch.cat(parts[g:g + inner], 1) for g in range(0, CP, inner)]
    return zigzag_unpermute(torch.cat(parts, 2), _cp_layout(algo, inner), axis=2)


def _cp_expected(algo, inner, s, hq, d) -> dict:
    """Launches of one op-level forward and backward over CP ranks: a ring of
    n ranks makes 2n + 1 pair calls a rank each way (K4 or K5 by JAX's rule
    at the pair's shape); Ulysses one whole-sequence call a rank."""
    from long_vita_tpu_torch.ops import flash_attention as fa

    if algo == "ulysses":
        calls, sq, heads = 1, s, hq // CP
    else:
        ring = CP if algo == "ring" else CP // inner
        calls, sq, heads = 2 * ring + 1, s // (2 * ring), hq // (CP // ring)
    fused = fa.bwd_uses_fused(1, sq, sq, heads, d, 2)
    n = CP * calls
    return {"flash_fwd": n, "flash_bwd": n if fused else 0,
            "flash_bwd_dkv": 0 if fused else n, "flash_bwd_dq": 0 if fused else n}


def phase_cp_attention(*, s=CP_SEQ, heads=(40, 8), d=128, dev=None, seg=None) -> dict:
    """Ring (plain, and the double ring at window 2), Ulysses and hybrid
    (inner 2) attention over CP thread-ranks on the card, forward and
    backward at op level (ring_fwd / ring_bwd, ulysses_fwd / _bwd,
    hybrid_fwd / _bwd, called directly on each thread-rank: autograd's one
    CUDA device thread would deadlock ranks whose backward passes wait for
    each other), on a 64K-token sequence zigzagged for the layout, without
    and with T1's packed segments. Each is held to K1 and K4/K5 over the
    whole unpermuted sequence: o to CP_O_RMS_FRAC x RMS(ref) + O_RTOL x
    |ref| (the ring merges o in bf16, as JAX merges in q's dtype), the lse
    (the ring's merged one; Ulysses' and hybrid's of their head groups) to
    LSE_ATOL, dq, dk, dv to GRAD_TOL.
    -> launch counts of the cp runs (the whole-sequence references excluded)."""
    import torch

    from long_vita_tpu_torch.ops import flash_attention as fa
    from long_vita_tpu_torch.ops.hybrid_cp import hybrid_bwd, hybrid_fwd
    from long_vita_tpu_torch.ops.ring_attention import ring_bwd, ring_fwd
    from long_vita_tpu_torch.ops.ulysses import ulysses_bwd, ulysses_fwd
    from long_vita_tpu_torch.parallel.comm import run_thread_ranks
    from long_vita_tpu_torch.parallel.zigzag import zigzag_permute, zigzag_unpermute

    dev = dev or torch.device("cuda")
    hq, hkv = heads
    rnd = _cp_rand(dev, SEED + 21)
    q, k, v, do = rnd(1, s, hq, d), rnd(1, s, hkv, d), rnd(1, s, hkv, d), rnd(1, s, hq, d)
    if seg is None:  # T1's packed layout
        seg = _train_segments(s, (64, 16), (2, 3), dev)
    refs = {}
    for segs in (False, True):
        kw = dict(causal=True, q_segment_ids=seg if segs else None,
                  kv_segment_ids=seg if segs else None)
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        refs[segs] = (o, *fa.flash_attention_bwd(q, k, v, o, lse, do, **kw), lse)
    total = dict.fromkeys(SOURCES, 0)
    n = s // CP
    configs = (("ring", "ring", 0, 1), ("ring window 2", "ring", 2, 1),
               ("ulysses", "ulysses", 0, 1), ("hybrid inner 2", "hybrid", 0, 2))
    for name, algo, window, inner in configs:
        z = _cp_layout(algo, inner)
        for segs in (False, True):
            qz, kz, vz, dz = (zigzag_permute(x, z) for x in (q, k, v, do))
            sz = zigzag_permute(seg, z) if segs else None

            def rank(comm):
                sl = slice(comm.rank * n, (comm.rank + 1) * n)
                ql, kl, vl, dl = qz[:, sl], kz[:, sl], vz[:, sl], dz[:, sl]
                sg = sz[:, sl] if segs else None
                comm.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if algo == "ring":
                    o, lse = ring_fwd(ql, kl, vl, comm, sg, sg, window)
                elif algo == "ulysses":
                    o, res = ulysses_fwd(ql, kl, vl, comm, sg, sg)
                    lse = res[4]
                else:
                    o, res = hybrid_fwd(ql, kl, vl, comm, inner, sg, sg, window)
                    lse = res[4]
                torch.cuda.synchronize()
                comm.barrier()
                t1 = time.perf_counter()
                if algo == "ring":
                    grads = ring_bwd(ql, kl, vl, o, lse, dl, comm, sg, sg, window)
                elif algo == "ulysses":
                    grads = ulysses_bwd(res, dl, comm)
                else:
                    grads = hybrid_bwd(res, dl, comm, inner, window)
                torch.cuda.synchronize()
                comm.barrier()
                return (o, *grads, lse, t1 - t0, time.perf_counter() - t1)

            _reset_counts()
            res = run_thread_ranks(rank, CP, timeout=CP_TIMEOUT)
            counts = _read_counts()
            for key in total:
                total[key] += counts[key]
            got = [zigzag_unpermute(torch.cat([r[i] for r in res], 1), z) for i in range(4)]
            got.append(_cp_global_lse(algo, inner, [r[4] for r in res]))
            t_fwd, t_bwd = max(r[5] for r in res), max(r[6] for r in res)
            del res[:]
            ref = refs[segs]
            tag = f"cp attention {name}, cp {CP}, {s} tokens, {'T1 segments' if segs else 'no segments'}"
            c = cp_forward_check(got[0], ref[0], got[4], ref[4])
            ok = c["ok"]
            print(f"[cp-attn] {tag}: max|o-ref| {c['err']:.3e}, worst err / tol {c['worst']:.3f} "
                  f"(tol {c['atol']:.3e} = {CP_O_RMS_FRAC} x RMS(ref) + {O_RTOL} x |ref|), "
                  f"max|lse-ref| {c['lse_err']:.3e} (tol {LSE_ATOL}), vs K1 over the whole "
                  f"sequence {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"[{tag}] forward disagrees with K1 over the whole sequence")
            _grad_errs(f"{tag} (vs K4/K5 over the whole sequence)", got[1:4], ref[1:4])
            print(f"[cp-attn] {tag}: forward {t_fwd * 1e3:.1f} ms, backward {t_bwd * 1e3:.1f} ms "
                  f"(wall, {THREADS_NOTE})")
            _check_launches(counts, _cp_expected(algo, inner, s, hq, d))
            del got
    return total


@contextlib.contextmanager
def _sampling_tap(forced=None):
    """Within the block, inference.engine's sample records each call's f32
    logits (row 0) and the token it returns, in a list per thread; with
    ``forced`` (a list of token tensors) the i-th call of a thread returns
    forced[i] instead (teacher forcing). -> {thread id: [(logits, token)]}."""
    import threading

    from long_vita_tpu_torch.inference import engine as engine_mod

    real, seen = engine_mod.sample, {}

    def tap(logits, gen, sp):
        steps = seen.setdefault(threading.get_ident(), [])
        tok = real(logits, gen, sp)
        if forced is not None:
            if len(steps) >= len(forced):
                raise AssertionError("the forced run samples more steps than the mesh run")
            tok = forced[len(steps)].clone()
        steps.append((logits[0].float().clone(), tok.clone()))
        return tok

    engine_mod.sample = tap
    try:
        yield seen
    finally:
        engine_mod.sample = real


def _forced_steps_check(tag, got, want) -> None:
    """A mesh engine's steps ``got`` against the one-device engine's ``want``
    when it is fed the mesh engine's tokens (each a list of (logits, token)).
    Every step's f32 logits pass the logit gate (LOGIT_COS; max |diff| <=
    LOGIT_SPREAD_FRAC x spread), and each mesh pick is the one-device logits'
    argmax or lies within LOGIT_SPREAD_FRAC x spread of it there (a rounding
    tie: the two paths round their products apart, and random weights leave
    near-ties)."""
    import torch.nn.functional as F

    if len(got) != len(want):
        raise AssertionError(f"[{tag}] {len(got)} mesh steps vs {len(want)} forced steps")
    worst_cos, worst_diff, worst_gap, ties, ok = 1.0, 0.0, 0.0, [], True
    for i, ((g, pick), (w, _)) in enumerate(zip(got, want)):
        spread = (w.max() - w.min()).item()
        cos = F.cosine_similarity(g, w, dim=-1).item()
        diff = (g - w).abs().max().item() / spread
        mine, pick = int(w.argmax()), int(pick[0])
        gap = (w[mine] - w[pick]).item() / spread
        if mine != pick:
            ties.append((i, round(gap, 5)))
        worst_cos, worst_diff, worst_gap = min(worst_cos, cos), max(worst_diff, diff), max(
            worst_gap, gap)
        ok = ok and cos >= LOGIT_COS and diff <= LOGIT_SPREAD_FRAC and gap <= LOGIT_SPREAD_FRAC
    print(f"[{tag}] {len(got)} steps, the one-device engine fed the mesh engine's tokens: worst "
          f"cosine {worst_cos:.6f} (>= {LOGIT_COS}), worst max|diff| {worst_diff:.4f} x spread "
          f"(<= {LOGIT_SPREAD_FRAC}); steps whose mesh pick is not the one-device argmax (step, "
          f"gap / spread): {ties} (<= {LOGIT_SPREAD_FRAC}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"[{tag}] a decode step of the mesh engine disagrees with the "
                             "one-device engine fed the same tokens")


def _timed_generate(eng, prompt, videos, sp, images=()):
    """eng.generate -> (result, TTFT s, decode ms/token); TTFT ends when the
    engine has sampled the first token."""
    import torch

    head, seen = eng._head_sample, {}

    def timed(hidden, gen, sampling):
        out = head(hidden, gen, sampling)
        if "t" not in seen:
            torch.cuda.synchronize()
            seen["t"] = time.perf_counter()
        return out

    eng._head_sample = timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(input_ids=prompt, videos=videos, images=images, sampling=sp)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    n = len(out.token_ids)
    return out, seen["t"] - t0, (t1 - seen["t"]) / max(n - 1, 1) * 1e3


def _cp_against_one_device(tag, model, cfg, prompt, *, seq, chunk, vision_chunk, expected,
                           tokens, kv_quant=False, videos=(), images=(), mm=None,
                           mesh_cfg=None, routed=False, times=None) -> dict:
    """``prompt`` (token ids) served by an InferenceEngine over a mesh of
    thread-ranks (``mesh_cfg``, a cp mesh of CP by default: each rank holds
    seq // cp slots and Hkv // tp kv heads) and greedy-decoded for
    ``tokens`` tokens, then by a one-device engine on the same weights, run
    after it and fed the mesh engine's tokens (teacher forcing, so that a
    near-tie does not end the check): every step's f32 logits under the
    logit gate and each mesh pick against the one-device argmax (up to a
    rounding tie). routed (a MoE decoder): the one-device engine routes as
    the mesh engine did too (_routing_tap: random routers put a token's
    top-2 margin at the order of bf16 rounding), and every rank's routes
    must be the same. The mesh run's launches must equal expected(prompt
    ids). times: a dict that takes the mesh run's TTFT (s) and decode
    ms/token. -> those launch counts."""
    import torch

    from long_vita_tpu_torch.inference.engine import InferenceEngine
    from long_vita_tpu_torch.inference.sampler import SamplingParams
    from long_vita_tpu_torch.parallel.comm import run_thread_ranks
    from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    mm = mm or _StubMM()
    mesh_cfg = mesh_cfg or MeshConfig(cp=CP)
    label = " x ".join(f"{a} {n}" for a, n in (("cp", mesh_cfg.cp), ("tp", mesh_cfg.tp),
                                                ("tq", mesh_cfg.tq)) if n > 1)
    sp = SamplingParams(max_new_tokens=tokens)
    kw = dict(max_seq_len=seq, chunk=chunk, kv_quant=kv_quant, vision_chunk=vision_chunk)
    one = InferenceEngine(model, cfg, mm, **kw)
    n_ids = len(mm.expand(prompt, videos=videos, images=images).input_ids)
    hkv = cfg.text.num_key_value_heads // min(mesh_cfg.tp, cfg.text.num_key_value_heads)

    def rank(comm):
        eng = InferenceEngine(model, cfg, mm, mesh=make_mesh(mesh_cfg, comm), **kw)
        shape = eng._make_cache(1, seq).k.shape
        if shape[2] != seq // mesh_cfg.cp or shape[3] != hkv:
            raise AssertionError(f"a rank must hold slots // cp cache slots of its Hkv // tp "
                                 f"kv heads, not {tuple(shape)}")
        comm.barrier()
        if comm.rank == 0:
            _reset_counts()
        comm.barrier()
        out, ttft, ms = _timed_generate(eng, prompt, videos, sp, images)
        comm.barrier()
        counts = _read_counts() if comm.rank == 0 else None
        return seen[threading.get_ident()], out.token_ids, ttft, ms, counts

    with contextlib.ExitStack() as stack:
        seen = stack.enter_context(_sampling_tap())
        routes = stack.enter_context(_routing_tap()) if routed else None
        res = run_thread_ranks(rank, mesh_cfg.size, timeout=CP_TIMEOUT)
    steps, got, ttft, ms, counts = res[0]
    forced_routes = None
    if routed:
        per_rank = list(routes.values())
        forced_routes = per_rank[0]
        if len(per_rank) != mesh_cfg.size or any(
                len(r) != len(forced_routes) or not all(torch.equal(a, b) for a, b in
                                                        zip(r, forced_routes))
                for r in per_rank):
            raise AssertionError(f"[{tag}] the thread-ranks routed their tokens differently")
    if any(r[1] != got or len(r[0]) != len(steps) or not all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(r[0], steps))
           for r in res):
        raise AssertionError(f"[{tag}] the thread-ranks sampled different tokens or logits")
    del res
    # teacher forcing: the one-device engine fed the mesh engine's picks
    with contextlib.ExitStack() as stack:
        seen_one = stack.enter_context(_sampling_tap(forced=[t for _, t in steps]))
        if routed:
            stack.enter_context(_routing_tap(forced=forced_routes))
        ref_out, ttft1, ms1 = _timed_generate(one, prompt, videos, sp, images)
    ref_steps = next(iter(seen_one.values()))
    ok = all(bool(torch.isfinite(g).all()) for g, _ in steps) and _logit_check(
        tag, f"{label} engine vs the one-device engine", steps[0][0], ref_steps[0][0])
    if not ok or ref_out.token_ids != got:
        raise AssertionError(f"[{tag}] {label} engine logits disagree with the one-device engine")
    _forced_steps_check(tag, steps, ref_steps)
    print(f"[{tag}] {n_ids} prompt tokens, {len(got)} greedy tokens {got[:8]} ...: {label} "
          f"TTFT {ttft:.3f} s, decode {ms:.1f} ms/token ({mesh_cfg.size} thread-ranks on one "
          f"card, not a multi-GPU time); the one-device engine (fed the mesh tokens, after the "
          f"mesh run) TTFT {ttft1:.3f} s, decode {ms1:.1f} ms/token")
    _check_launches(counts, expected(n_ids))
    if times is not None:
        times.update(ttft=ttft, ms=ms)
    return counts


def _decoder_prefix(params, cfg, layers: int) -> tuple:
    """The decoder cut to its first ``layers`` layers (the same tensors, no
    copy) and the configuration cut to match."""
    import dataclasses

    from long_vita_tpu_torch.models import qwen2

    text = qwen2.Qwen2Params(embed=params.embed, layers=list(params.layers[:layers]),
                             final_norm=params.final_norm, lm_head=params.lm_head)
    return text, dataclasses.replace(cfg, text=dataclasses.replace(
        cfg.text, num_hidden_layers=layers))


def phase_cp_serve(params, cfg, dev, *, max_seq=65536, chunk=2048, n_prompt=60000,
                   new_tokens=16, short_tokens=4, n_frames=16, video_max_seq=16384,
                   vision_chunk=64, layers=24) -> dict:
    """The 14B at full width (the serving phases' random bf16 weights,
    shared by the thread-ranks; the decoder cut to its first ``layers``
    layers, to keep the run inside its time limit) served by an
    InferenceEngine over a cp mesh of CP thread-ranks, each rank holding
    max_seq // CP cache slots:
    a 60000-id prompt (its last chunk partial) and 16 greedy tokens with a
    bf16 cache, then with an int8 cache (K2), then a 16-frame video through
    the tile-sharded encode (each rank's 4 tiles through K3); the last two
    decode 4 tokens (short_tokens: every thread-rank runs the whole decode
    step, 1.7-2.6 s a token on one card). Each against a one-device engine
    on the same weights (_cp_against_one_device). Launch counts of the cp
    runs are checked (K1 or K2: a launch per rank, layer and chunk; K3 a
    launch per rank and tower layer). TTFT and ms/token are 4 thread-ranks
    on one card. -> launch counts of the cp generate calls."""
    import numpy as np

    params, cfg = _decoder_prefix(params, cfg, layers)
    print(f"[cp-serve] the decoder's first {layers} layers at full width")
    tc = cfg.text
    rng = np.random.default_rng(SEED + 30)
    vocab = min(tc.vocab_size, 151643)
    total = dict.fromkeys(SOURCES, 0)

    def serve(tag, model, prompt, *, seq=max_seq, tokens=new_tokens, **kw):
        counts = _cp_against_one_device(tag, model, cfg, prompt, seq=seq, chunk=chunk,
                                        vision_chunk=vision_chunk, tokens=tokens, **kw)
        for key in total:
            total[key] += counts[key]

    chunks = lambda n: -(-n // chunk)  # noqa: E731
    layers = tc.num_hidden_layers
    prompt = rng.integers(0, vocab, n_prompt).tolist()
    serve("cp-serve bf16 cache", params, prompt,
          expected=lambda n: {"flash_fwd": CP * layers * chunks(n)})
    _collect("after the bf16 cp engines")
    serve("cp-serve int8 cache", params, prompt, kv_quant=True, tokens=short_tokens,
          expected=lambda n: {"flash_fwd_quant": CP * layers * chunks(n)})
    _collect("after the int8 cp engines")
    vc = cfg.vision

    def tiles(n):
        return rng.standard_normal((n, vc.image_size, vc.image_size, 3), dtype=np.float32)

    lv, _ = _vlm_params(params, cfg, dev, SEED + 1, tiles(2))
    video = tiles(n_frames)
    per_rank = -(-n_frames // CP)
    serve("cp-serve video", lv, [*rng.integers(0, vocab, 20).tolist(), VID_TAG,
                                 *rng.integers(0, vocab, 20).tolist()],
          seq=video_max_seq, videos=[video], mm=_StubMM(cfg.image_token_length),
          tokens=short_tokens,
          expected=lambda n: {"flash_fwd": CP * layers * chunks(n),
                              "short_attn": CP * vc.num_hidden_layers * -(-per_rank // vision_chunk)})
    del lv
    return total


def _png_b64(rng, width: int, height: int) -> str:
    """A random RGB PNG, base64 (an image_list entry of PUT /api)."""
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (height, width, 3), dtype="uint8")).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _lockstep_http(eng, *, continuous, slots, tick, first=(), together=(), last=(),
                   window_s=0.05) -> dict:
    """Rank 0's side of a lockstep server (inference/server.make_server on
    an engine over a mesh; the other ranks run follower_serve): send
    ``first`` one at a time, then ``together`` concurrently (``first``'s
    admissions come before theirs), then ``last`` one at a time, over
    HTTP; a request with "stream": true is streamed. Then shut the server
    down (close_server: SHUTDOWN is the channel's last message). In
    continuous mode every admission is recorded (rid, prompt, sampling, the
    ids and the cast tiles it admitted) for the in-process replay.
    -> {"answers": payload dicts in request order, "codes", "seconds",
    "stream": (TTFT over HTTP, seconds), "finished": rank 0's pool results,
    "admitted", "trace", "seconds_all"}."""
    from long_vita_tpu_torch.inference.server import close_server, make_server

    server = make_server(eng, "127.0.0.1", 0, continuous=continuous, max_batch=slots,
                         tick=tick, batch_window_s=window_s)
    admitted, pending = [], []
    if continuous:
        b = server.batcher
        real_start, real_admit = b._start_next_locked, b.ce.start_admission

        def start_admission(ids, images=None, image_indices=None):
            pending.append((list(ids), images, image_indices, b.ce.sampling))
            return real_admit(ids, images, image_indices)

        def start_next():
            before = set(b._inflight)
            did = real_start()
            for rid in set(b._inflight) - before:
                box, row = b._inflight[rid]
                ids, imgs, idx, sp = pending[-1]
                admitted.append(dict(rid=rid, prompt=box["req"]["prompts"][row], ids=ids,
                                     images=imgs, indices=idx, sampling=sp))
            pending.clear()
            return did

        b.ce.start_admission = start_admission
        b._start_next_locked = start_next
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/api"
    reqs = [*first, *together, *last]
    out: dict = {}

    def send(i):
        req = dict(reqs[i])
        if req.pop("stream", False):
            events, t_first, t_all = _stream(url, req)
            payload = dict(events[-1])
            deltas = "".join(e["delta"] for e in events if "delta" in e)
            ok = payload.pop("done", False) is True and deltas == payload["text"][0]
            out[i] = (200 if ok else 500, payload, t_all)
            out["stream"] = (t_first, t_all)
        else:
            code, body, t = _put(url, req)
            out[i] = (code, json.loads(body) if code == 200 else body, t)

    t0 = time.perf_counter()
    try:
        for i in range(len(first)):
            send(i)
        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(len(first), len(first) + len(together))]
        for t in threads:
            t.start()
            time.sleep(0.05)  # the order of the queue: the order of the list
        for t in threads:
            t.join(timeout=CP_TIMEOUT)
        for i in range(len(first) + len(together), len(reqs)):
            send(i)
    finally:
        server.shutdown()
        thread.join(timeout=CP_TIMEOUT)
        close_server(server, timeout=CP_TIMEOUT)
    seconds_all = time.perf_counter() - t0
    return {
        "answers": [out[i][1] for i in range(len(reqs))],
        "codes": [out[i][0] for i in range(len(reqs))],
        "seconds": [out[i][2] for i in range(len(reqs))],
        "stream": out.get("stream"), "seconds_all": seconds_all,
        "finished": dict(getattr(server.batcher, "finished", {})), "admitted": admitted,
        "trace": list(getattr(server.batcher, "trace", [])),
    }


def _follower(eng, *, continuous, slots, tick) -> dict:
    """A follower rank's side: follower_serve until SHUTDOWN; -> what it
    replayed (its pool freed)."""
    from long_vita_tpu_torch.inference.server import follower_serve

    fol = follower_serve(eng, continuous=continuous, max_batch=slots, tick=tick)
    out = {"finished": dict(fol.finished), "payloads": list(fol.payloads), "trace": fol.trace}
    fol.ce = None
    return out


def _replay_admissions(eng, admitted, *, slots, tick) -> tuple:
    """The admissions rank 0's pool made, in its order, through an in-process
    ContinuousEngine of the server's geometry on the same ranks (a row
    joins as soon as a slot is free; a change of sampling waits until the
    pool is drained, as the server's scheduler does). -> ({rid: result},
    seconds of each decode tick)."""
    import torch

    from long_vita_tpu_torch.inference.continuous import ContinuousEngine
    from long_vita_tpu_torch.inference.sampler import SamplingParams

    ce = ContinuousEngine(eng, SamplingParams(), max_slots=slots, tick=tick)
    out, ticks = {}, []
    sync = torch.cuda.synchronize if eng.device.type == "cuda" else (lambda: None)

    def step():
        sync()
        t = time.perf_counter()
        out.update(ce.step())
        sync()
        ticks.append(time.perf_counter() - t)

    for a in admitted:
        if a["sampling"] != ce.sampling:
            while ce.active:
                step()
            ce.set_sampling(a["sampling"])
        while ce.free_slots <= 0:
            step()
        rid = ce.add_request(a["ids"], a["images"], a["indices"])
        if rid != a["rid"]:
            raise AssertionError(f"replayed admission {rid} != the server's {a['rid']}")
    while ce.active:
        step()
    return out, ticks


def _lockstep_gates(tag, http, followers, replay, check) -> None:
    """(a) every follower's replay equals rank 0's results (token ids and
    logprob bits; in window mode the payloads it answered); (b) in
    continuous mode, each HTTP answer equals the in-process pool's row of
    the same admission (text and logprob bits)."""
    def bits(res):
        return res.token_ids, res.logprobs

    ok_codes = all(c == 200 for c in http["codes"])
    check(ok_codes, f"[{tag}] every request answered 200 ({http['codes']})")
    if http["admitted"]:
        fin = {rid: bits(r) for rid, r in http["finished"].items()}
        check(bool(fin) and all({rid: bits(r) for rid, r in f["finished"].items()} == fin
                                for f in followers),
              f"[{tag}] (a) lockstep: each of {len(followers)} followers replayed rank 0's "
              f"{len(fin)} pool rows, token ids and logprob bits, through "
              f"{followers[0]['trace'].count('tick') if followers else 0} ticks")
        by_prompt = {}
        for req, ans in zip(http["requests"], http["answers"]):
            by_prompt[req["prompts"][0]] = ans
        same = []
        for a in http["admitted"]:
            ans, res = by_prompt[a["prompt"]], replay[a["rid"]]
            same.append(isinstance(ans, dict) and ans["text"] == [res.text]
                        and ans.get("logprobs", [None])[0] == res.logprobs)
        check(all(same) and len(same) == len(http["answers"]),
              f"[{tag}] (b) each HTTP answer equals the in-process pool's row of the same "
              f"admission (text and logprob bits): {sum(same)} of {len(same)}")
    else:
        check(all(f["payloads"] == http["answers"] for f in followers),
              f"[{tag}] (a) lockstep: each follower answered rank 0's "
              f"{len(http['answers'])} payloads ({followers[0]['trace'] if followers else []})")


def phase_cp_server(params, cfg, dev, *, max_seq=32768, chunk=2048, slots=4, tick=4,
                    text_chars=(7000, 3000, 1500), new_tokens=8, image_wh=(1344, 448),
                    stream_chars=600, sampled_chars=400, batch_chars=(900, 500),
                    beam_chars=300, beam_tokens=4, vision_chunk=64, tokenizer=None) -> dict:
    """Serving a cp group from its entry points: the 14B (full width, the
    decoder at the depth given: main passes its first SERVE_PREFIX; the serving
    phases' random bf16 weights with a random tower and projector, shared by
    the thread-ranks) behind the port's server on cp
    rank 0 of CP thread-ranks, ranks 1.. in follower_serve (the lockstep,
    inference/multihost.py over ThreadComm), the ByteTokenizer in the real
    MultimodalTokenizer. A 32768-slot cache, 8192 a rank, chunk 2048.
    Continuous mode (4 slots, tick 4): the longest text prompt, then
    concurrently two more, a 4-tile image and a streamed request, then a
    sampled request (its own sampling key: a drained pool, then the
    switch); window mode: a 2-row batch, then a beam request. Gates: (a)
    each follower's replay equals rank 0's results bit for bit; (b) the
    HTTP answers equal an in-process cp pool of the server's geometry on the
    same ranks, fed the server's admissions in order (run after the
    server's pool is freed); (c) the longest prompt on the cp engine
    against the one-device engine, teacher-forced, under the logit gate;
    (d) exact launch counts: K1 CP x layers x the chunks of every prefill, K3
    CP x 24 x a rank's encode batches. Times are THREADS_NOTE. Its sizes
    (and ``tokenizer``: a ByteTokenizer at Qwen2.5's ids by default) are
    arguments, so that it rehearses on the CPU at a tiny size.
    -> the launch counts of the phase."""
    import numpy as np
    import torch

    from long_vita_tpu_torch.data.image_processor import ImageProcessor
    from long_vita_tpu_torch.data.multimodal import MultimodalTokenizer
    from long_vita_tpu_torch.inference.engine import InferenceEngine
    from long_vita_tpu_torch.parallel.comm import run_thread_ranks
    from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from long_vita_tpu_torch.tokenizer import ByteTokenizer

    vc, tc = cfg.vision, cfg.text
    layers = tc.num_hidden_layers
    rng = np.random.default_rng(SEED + 50)
    failures = []

    def check(ok: bool, what: str) -> None:
        print(f"{what}: {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(what)

    probe = rng.standard_normal((2, vc.image_size, vc.image_size, 3), dtype=np.float32)
    lv, _ = _vlm_params(params, cfg, dev, SEED + 51, probe)
    mm = MultimodalTokenizer(tokenizer or ByteTokenizer(), image_processor=ImageProcessor(
        image_size=vc.image_size), image_token_length=cfg.image_token_length)
    greedy = {"tokens_to_generate": new_tokens, "logprobs": True}
    texts = [_random_text(rng, n) for n in text_chars]
    first = [{"prompts": [texts[0]], **greedy}]
    together = [{"prompts": [texts[1]], **greedy}, {"prompts": [texts[2]], **greedy},
                {"prompts": ["<image>\n" + _random_text(rng, 100)],
                 "image_list": [_png_b64(rng, *image_wh)], **greedy},
                {"prompts": [_random_text(rng, stream_chars)], "stream": True, **greedy}]
    last = [{"prompts": [_random_text(rng, sampled_chars)], "tokens_to_generate": new_tokens,
             "logprobs": True, "top_k": 20, "temperature": 0.8, "random_seed": 11}]
    window = [{"prompts": [_random_text(rng, n) for n in batch_chars], **greedy},
              {"prompts": [_random_text(rng, beam_chars)], "tokens_to_generate": beam_tokens,
               "beam_width": 2}]
    kw = dict(max_seq_len=max_seq, chunk=chunk, vision_chunk=vision_chunk)
    chunks = lambda n: -(-n // chunk)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()

    def serve(comm):
        eng = InferenceEngine(lv, cfg, mm, mesh=make_mesh(MeshConfig(cp=CP), comm), **kw)
        if eng._make_cache(1, max_seq).k.shape[2] != max_seq // CP:
            raise AssertionError("a rank must hold slots // cp cache slots")
        out = {}
        for mode, plan in (("continuous", dict(first=first, together=together, last=last)),
                           ("window", dict(last=window))):
            comm.barrier()
            if comm.rank == 0:
                if mode == "continuous":
                    _reset_counts()
                out[mode] = _lockstep_http(eng, continuous=mode == "continuous", slots=slots,
                                           tick=tick, **plan)
                out[mode]["requests"] = [*plan.get("first", ()), *plan.get("together", ()),
                                         *plan["last"]]
                out[mode]["peak"] = torch.cuda.max_memory_allocated()
            else:
                out[mode] = _follower(eng, continuous=mode == "continuous", slots=slots,
                                      tick=tick)
            comm.barrier()
            if comm.rank == 0:
                gc.collect()
                torch.cuda.empty_cache()
            comm.barrier()
        return out

    res = run_thread_ranks(serve, CP, timeout=CP_TIMEOUT)
    http, fols = res[0], res[1:]
    cont, win = http["continuous"], http["window"]
    n_ids = [len(a["ids"]) for a in cont["admitted"]]
    t_first, t_stream = cont["stream"]
    gen = sum(len(a["logprobs"][0]) for a in cont["answers"] if isinstance(a, dict))
    print(f"[cp-server] continuous mode over {CP} thread-ranks ({THREADS_NOTE}): admissions "
          f"of {n_ids} ids ({slots} slots, tick {tick}, a {max_seq}-slot cache, "
          f"{max_seq // CP} a rank); {gen} tokens in {cont['seconds_all']:.3f} s; request "
          f"times {[round(t, 3) for t in cont['seconds']]} s; the streamed request's TTFT over "
          f"HTTP {t_first:.3f} s (all {t_stream:.3f} s); peak memory "
          f"{cont['peak'] / 1e9:.2f} GB (max_memory_allocated)")
    print(f"[cp-server] window mode: the 2-row batch and the beam request in "
          f"{[round(t, 3) for t in win['seconds']]} s; peak memory {win['peak'] / 1e9:.2f} GB")
    beam = win["answers"][1] if isinstance(win["answers"][1], dict) else {}
    check(len(beam.get("text", [])) == 2 and beam["scores"] == sorted(beam["scores"],
                                                                      reverse=True),
          f"[cp-server] beam_width 2 gives two hypotheses best first ({beam.get('scores')})")
    del res

    # ---- (b): the in-process pool on the same ranks, the server's pool freed
    admitted = cont["admitted"]

    def replay(comm):
        eng = InferenceEngine(lv, cfg, mm, mesh=make_mesh(MeshConfig(cp=CP), comm), **kw)
        got, ticks = _replay_admissions(eng, admitted, slots=slots, tick=tick)
        comm.barrier()
        return got, ticks, (_read_counts() if comm.rank == 0 else None)

    rep = run_thread_ranks(replay, CP, timeout=CP_TIMEOUT)
    replayed, ticks, counts = rep[0]
    check(all({r: (x.token_ids, x.logprobs) for r, x in g.items()}
              == {r: (x.token_ids, x.logprobs) for r, x in replayed.items()} for g, _, _ in rep),
          "[cp-server] the in-process pool: every rank the same rows")
    print(f"[cp-server] the in-process pool ({THREADS_NOTE}): {len(ticks)} ticks, "
          f"{statistics.median(ticks) / tick * 1e3:.1f} ms a decode step (median tick / {tick})")
    _lockstep_gates("cp-server continuous", cont, [f["continuous"] for f in fols], replayed,
                    check)
    _lockstep_gates("cp-server window", win, [f["window"] for f in fols], None, check)
    del rep

    # ---- (d): launches of the server, its followers and the replay
    n_batch = max(len(mm.encode_chat([{"role": "user", "content": p}]))
                  for p in window[0]["prompts"])
    n_beam = len(mm.encode_chat([{"role": "user", "content": window[1]["prompts"][0]}]))
    tiles = [a["images"].shape[0] for a in admitted if a["images"] is not None]
    per_rank = [-(-n // CP) for n in tiles]
    _check_launches(counts, {
        "flash_fwd": CP * layers * (2 * sum(chunks(n) for n in n_ids) + chunks(n_batch)
                                    + chunks(n_beam)),
        "short_attn": 2 * CP * vc.num_hidden_layers * sum(-(-n // vision_chunk) for n in per_rank),
    })
    total = dict(counts)
    _collect("after the cp server and its replay")

    # ---- (c): the longest prompt on the cp engine vs one device
    longest = max(admitted, key=lambda a: len(a["ids"]))["ids"]
    c = _cp_against_one_device(
        "cp-server longest prompt", lv, cfg, longest, seq=max_seq, chunk=chunk,
        vision_chunk=vision_chunk, tokens=new_tokens, mm=mm,
        expected=lambda n: {"flash_fwd": CP * layers * chunks(n)})
    for key in total:
        total[key] += c[key]
    print(f"[cp-server] peak memory of the phase {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"({THREADS_NOTE})")
    del lv
    if failures:
        raise AssertionError(f"phase_cp_server: {failures}")
    return total


TP = 4  # thread-ranks of the tp phase (one card: they share it)
# K6's column shards at tp 4 of the 14B: q_proj, k_proj / v_proj,
# gate_proj / up_proj and the vocab-sharded head (in 5120, one row, f32 out)
TP_W4_OUTS = {"q_proj": 1280, "k_proj/v_proj": 256, "gate_proj/up_proj": 3456,
              "lm_head": 38016}


def phase_tp_kernels(*, hq=40 // TP, hkv=8 // TP, rows=2048, q_offset=4096, valid=6144,
                     slots=8192) -> float:
    """The kernels of tensor-parallel serving at a tp-4 rank's shapes, each
    against its plain version at the tolerances of phase_kernels*: K6 on one
    row into the column shards (TP_W4_OUTS, f32 out: W4_F32_TOL), K1 and K2
    on a 2048-row chunk at offset 4096 against a cache of 6144 valid slots
    with a rank's 10 q / 2 kv heads (o O_ATOL + O_RTOL |ref|, lse
    LSE_ATOL). -> the largest error (these launches are not the main
    path's)."""
    import torch

    from long_vita_tpu_torch.models.qwen2 import quantize_kv
    from long_vita_tpu_torch.models.quantize import quantize_kernel_int4
    from long_vita_tpu_torch.ops import flash_attention as fa
    from long_vita_tpu_torch.ops import quant_matmul as qm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    bf = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    errs = []
    x = rnd(1, 5120)
    for name, n_out in TP_W4_OUTS.items():
        packed, scales = quantize_kernel_int4(rnd(n_out, 5120, scale=0.02))
        before = qm.w4_matmul.launches
        got = qm.w4_matmul(x, packed, scales, torch.float32)
        torch.cuda.synchronize()
        if qm.w4_matmul.launches != before + 1:
            raise AssertionError(f"[tp kernels] K6 {name} shard did not launch once")
        ref = qm.w4_matmul_reference(x, packed, scales, torch.float32)
        err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
        ok = err <= W4_F32_TOL * scale and bool(torch.isfinite(got).all())
        errs.append(err)
        print(f"[tp kernels] K6 {name} tp-{TP} column shard [1, 5120] x [5120, {n_out}] -> f32: "
              f"max|k-ref| {err:.3e} (<= {W4_F32_TOL} x max|ref| {scale:.3f}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"[tp kernels] K6 at the {name} shard disagrees")
    q = rnd(1, rows, hq, 128)
    k, v = rnd(1, slots, hkv, 128), rnd(1, slots, hkv, 128)
    kw = dict(causal=True, q_offset=q_offset, kv_valid_len=valid)
    errs.append(_kernel_case(f"tp-{TP} rank: K1 chunk {rows} @{q_offset} vs cache {slots} len "
                             f"{valid}, {hq}/{hkv} heads", q, k, v, **kw))
    (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
    kw8 = dict(q_offset=q_offset, kv_valid_len=valid)
    errs.append(_pair_case(
        f"tp-{TP} rank: K2 chunk {rows} @{q_offset} vs int8 cache {slots} len {valid}, "
        f"{hq}/{hkv} heads",
        lambda: fa.flash_attention_quant(q, k8, ks, v8, vs, return_lse=True, **kw8),
        lambda: fa.flash_attention_quant_reference(q, k8, ks, v8, vs, **kw8),
        fa.flash_attention_quant,
    ))
    return max(errs)


def phase_tp_serve(params, cfg, dev, *, chunk=2048, n_prompt=5000, seq=8192, new_tokens=8,
                   short_tokens=4, image_grid=(1, 3), vision_chunk=64, server_chars=(3000, 1500),
                   server_image=(1344, 448), server_tokens=8, slots=4, tick=4,
                   cpxtp_layers=24, cpxtp_prompt=7000, cpxtp_seq=16384, tokenizer=None) -> dict:
    """Tensor-parallel serving of the 14B at full width (the serving phases'
    random bf16 weights, shared by the thread-ranks; each rank's shard is a
    view of them, K6's int4 column shards copies): phase_tp_kernels first,
    then the main path over TP thread-ranks (parallel/comm.ThreadComm, one
    card) at the depth of ``params`` (main(): the first SERVE_PREFIX), each
    against the one-device engine on the same
    weights (_cp_against_one_device: teacher-forced, §2's logit gate at
    every step, each pick the one-device argmax up to a tie; every rank's
    tokens and logit bits equal): a 5000-id prompt and 8 greedy tokens;
    int8 weights (quantised once, whole, then sharded by each rank) into an
    int8 cache (K2), and int4 weights (K6 on the column shards and on the
    gathered input of the replicated row projections, the dequantise route
    for the prefill chunks), 4 tokens each; a 4-tile image (K3: the tiles
    1/TP a rank). Then the lockstep server on the TP ranks (make_server on
    rank 0, follower_serve on the others; 3 continuous requests, a 4-tile
    image among them): gate (a) each follower's replay equals rank 0's
    bits, gate (b) each HTTP answer equals an in-process pool fed the same
    admissions. Last, cp 2 x tp 2 (the decoder's first ``cpxtp_layers``
    layers) on a ~7000-id prompt. Launch counts exact: K1 = ranks x layers
    x chunks, K2 likewise, K3 = TP x 24 x a rank's encode batches, K6 and
    its dequantise route per pass. Before the server, 2-D tp: tp 2 x tq 2
    on four thread-ranks (the weights cut over tp and tq, the cache's Hkv /
    tp heads on every tq rank) on the same prompt (K1; tp 2 too, for the
    time), int8 weights into an int8 cache (K2), int4 weights (K6 on the
    column cuts over tp and the row cuts over tq), the 4-tile image (K3,
    the tiles 1/4 a rank), then cp 2 x tq 2 on the prompt; RMSNorm without
    its tq sum of squares (a planted fault) must fail the logit gate. Times
    are thread-ranks on one card. Its sizes are arguments, so that it
    rehearses on the CPU at a tiny size. -> the launch counts of the
    phase."""
    import types

    import numpy as np
    import torch

    from long_vita_tpu_torch.data.image_processor import ImageProcessor
    from long_vita_tpu_torch.data.multimodal import MultimodalTokenizer
    from long_vita_tpu_torch.inference.engine import InferenceEngine
    from long_vita_tpu_torch.models import qwen2
    from long_vita_tpu_torch.models.quantize import quantize_weights_int4, quantize_weights_int8
    from long_vita_tpu_torch.parallel.comm import run_thread_ranks
    from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from long_vita_tpu_torch.tokenizer import ByteTokenizer

    t_phase = time.perf_counter()
    if dev.type == "cuda":
        phase_tp_kernels()
    tc, vc = cfg.text, cfg.vision
    layers = tc.num_hidden_layers
    rng = np.random.default_rng(SEED + 61)
    vocab = min(tc.vocab_size, 151643)
    chunks = lambda n: -(-n // chunk)  # noqa: E731
    tp_cfg = MeshConfig(tp=TP)
    total = dict.fromkeys(SOURCES, 0)
    total["w4_dequant"] = 0
    failures = []

    def check(ok: bool, what: str) -> None:
        print(f"{what}: {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(what)

    def serve(tag, model, prompt, *, mesh_cfg=tp_cfg, tokens=new_tokens, **kw):
        kw = {"seq": seq, "chunk": chunk, "vision_chunk": vision_chunk, **kw}
        counts = _cp_against_one_device(tag, model, cfg, prompt, tokens=tokens,
                                        mesh_cfg=mesh_cfg, **kw)
        for key in total:
            total[key] += counts[key]

    torch.cuda.reset_peak_memory_stats()
    print(f"[tp-serve] the decoder's {layers} layers at full width over tp {TP} thread-ranks "
          f"({TP} x {tc.num_attention_heads // TP}/{max(tc.num_key_value_heads // TP, 1)} heads "
          f"a rank)")
    prompt = rng.integers(0, vocab, n_prompt).tolist()
    serve("tp-serve bf16", params, prompt,
          expected=lambda n: {"flash_fwd": TP * layers * chunks(n)})
    q8 = quantize_weights_int8(params)  # the whole tree, once; each rank shards it
    serve("tp-serve int8 weights, int8 cache", q8, prompt, kv_quant=True, tokens=short_tokens,
          expected=lambda n: {"flash_fwd_quant": TP * layers * chunks(n)})
    del q8
    _collect("after the tp int8 engines")
    q4 = quantize_weights_int4(params)
    per_pass = 7 * layers  # int4 projections a decoder pass (the row ones replicated)
    # a run of short_tokens greedy tokens (no stop: random weights)
    steps = _decode_steps([types.SimpleNamespace(token_ids=[0] * short_tokens)], short_tokens,
                          short_tokens - 1)
    serve("tp-serve int4 weights", q4, prompt, tokens=short_tokens,
          expected=lambda n: {"flash_fwd": TP * layers * chunks(n),
                              "w4_dequant": TP * per_pass * chunks(n),
                              "w4_matmul": TP * (per_pass + 1) * (1 + steps)})
    del q4
    _collect("after the tp int4 engines")

    # ---- a 4-tile image through the tile-sharded encode (K3)
    rows_, cols_ = image_grid
    n_tiles = 1 + rows_ * cols_

    def tiles(n):
        return rng.standard_normal((n, vc.image_size, vc.image_size, 3), dtype=np.float32)

    lv, _ = _vlm_params(params, cfg, dev, SEED + 62, tiles(2))
    per_rank = -(-n_tiles // TP)
    serve("tp-serve image", lv, [*rng.integers(0, vocab, 20).tolist(), IMG_TAG,
                                 *rng.integers(0, vocab, 20).tolist()],
          images=[(tiles(n_tiles), image_grid)], mm=_StubMM(cfg.image_token_length),
          tokens=short_tokens,
          expected=lambda n: {"flash_fwd": TP * layers * chunks(n),
                              "short_attn": TP * vc.num_hidden_layers
                              * -(-per_rank // vision_chunk)})

    # ---- 2-D tp (the tq axis): tp 2 x tq 2 on four thread-ranks, each
    # holding its [out/tp, in/tq] or [out/tq, in/tp] block of every weight
    # and the cache's Hkv / tp heads; tp 2 on the same prompt for its time
    tq_cfg, n_tq = MeshConfig(tp=2, tq=2), 4
    print(f"[tq-serve] the decoder's {layers} layers at full width over tp 2 x tq 2 "
          f"thread-ranks (each rank {tc.num_attention_heads // 2}/"
          f"{max(tc.num_key_value_heads // 2, 1)} heads, a half of the hidden dim)")
    t_tp2, t_tq = {}, {}
    serve("tq-serve tp 2 (for the time)", params, prompt, mesh_cfg=MeshConfig(tp=2),
          times=t_tp2, expected=lambda n: {"flash_fwd": 2 * layers * chunks(n)})
    serve("tq-serve tp 2 x tq 2 bf16", params, prompt, mesh_cfg=tq_cfg, times=t_tq,
          expected=lambda n: {"flash_fwd": n_tq * layers * chunks(n)})
    print(f"[tq-serve] {len(prompt)}-id prompt: tp 2 x tq 2 TTFT {t_tq['ttft']:.3f} s, decode "
          f"{t_tq['ms']:.1f} ms/token against tp 2's {t_tp2['ttft']:.3f} s, "
          f"{t_tp2['ms']:.1f} ms/token (thread-ranks on one card, not a multi-GPU time)")
    q8 = quantize_weights_int8(params)
    serve("tq-serve tp 2 x tq 2 int8 weights, int8 cache", q8, prompt, mesh_cfg=tq_cfg,
          kv_quant=True, tokens=short_tokens,
          expected=lambda n: {"flash_fwd_quant": n_tq * layers * chunks(n)})
    del q8
    _collect("after the tq int8 engines")
    q4 = quantize_weights_int4(params)
    # every int4 projection through K6 or its dequantise route: a column one
    # on the input gathered over tq (its output over tp), a row one on the
    # input gathered over tp (its output over tq)
    serve("tq-serve tp 2 x tq 2 int4 weights", q4, prompt, mesh_cfg=tq_cfg, tokens=short_tokens,
          expected=lambda n: {"flash_fwd": n_tq * layers * chunks(n),
                              "w4_dequant": n_tq * per_pass * chunks(n),
                              "w4_matmul": n_tq * (per_pass + 1) * (1 + steps)})
    del q4
    _collect("after the tq int4 engines")
    tq_per_rank = -(-n_tiles // n_tq)
    serve("tq-serve tp 2 x tq 2 image", lv, [*rng.integers(0, vocab, 20).tolist(), IMG_TAG,
                                             *rng.integers(0, vocab, 20).tolist()],
          mesh_cfg=tq_cfg, images=[(tiles(n_tiles), image_grid)],
          mm=_StubMM(cfg.image_token_length), tokens=short_tokens,
          expected=lambda n: {"flash_fwd": n_tq * layers * chunks(n),
                              "short_attn": n_tq * vc.num_hidden_layers
                              * -(-tq_per_rank // vision_chunk)})
    serve("tq-serve cp 2 x tq 2", params, prompt, mesh_cfg=MeshConfig(cp=2, tq=2),
          expected=lambda n: {"flash_fwd": n_tq * layers * chunks(n)})
    # the planted fault: RMSNorm without its tq sum of squares must fail the
    # logit gate (the gate's own lines are kept out of the log: they read FAIL)
    qwen2._RMS_UNSUMMED_OVER_TQ = True
    gate_log = io.StringIO()
    try:
        with contextlib.redirect_stdout(gate_log):
            serve("tq-serve tp 2 x tq 2, RMSNorm's tq sum removed", params, prompt[:chunk],
                  mesh_cfg=tq_cfg, tokens=2,
                  expected=lambda n: {"flash_fwd": n_tq * layers * chunks(n)})
        caught = "nothing"
    except AssertionError as e:
        caught = str(e)
    finally:
        qwen2._RMS_UNSUMMED_OVER_TQ = False
    worst = re.search(r"cosine (\S+)", gate_log.getvalue())
    check("disagree" in caught, "[tq-serve] the logit gate with RMSNorm's tq sum of squares "
          f"removed (a planted fault) must fail: the first step's logit cosine "
          f"{worst[1] if worst else '?'}; {caught[:120]}")

    # ---- the lockstep server on the TP ranks, then gate (b)'s replay
    mm = MultimodalTokenizer(tokenizer or ByteTokenizer(), image_processor=ImageProcessor(
        image_size=vc.image_size), image_token_length=cfg.image_token_length)
    greedy = {"tokens_to_generate": server_tokens, "logprobs": True}
    reqs = [{"prompts": [_random_text(rng, n)], **greedy} for n in server_chars]
    reqs.append({"prompts": ["<image>\n" + _random_text(rng, 100)],
                 "image_list": [_png_b64(rng, *server_image)], **greedy})
    kw = dict(max_seq_len=seq, chunk=chunk, vision_chunk=vision_chunk)

    def server(comm):
        eng = InferenceEngine(lv, cfg, mm, mesh=make_mesh(tp_cfg, comm), **kw)
        comm.barrier()
        if comm.rank == 0:
            _reset_counts()
            out = _lockstep_http(eng, continuous=True, slots=slots, tick=tick, together=reqs)
            out["requests"] = reqs
        else:
            out = _follower(eng, continuous=True, slots=slots, tick=tick)
        comm.barrier()
        return out

    res = run_thread_ranks(server, TP, timeout=CP_TIMEOUT)
    http, fols = res[0], res[1:]
    admitted = http["admitted"]
    print(f"[tp-server] {len(reqs)} concurrent requests over HTTP from rank 0 of {TP} "
          f"thread-ranks (admissions of {[len(a['ids']) for a in admitted]} ids, {slots} slots, "
          f"tick {tick}): {[round(t, 3) for t in http['seconds']]} s, all in "
          f"{http['seconds_all']:.3f} s ({TP} thread-ranks on one card, not a multi-GPU time)")
    del res

    def replay(comm):
        eng = InferenceEngine(lv, cfg, mm, mesh=make_mesh(tp_cfg, comm), **kw)
        got, ticks = _replay_admissions(eng, admitted, slots=slots, tick=tick)
        comm.barrier()
        return got, ticks, (_read_counts() if comm.rank == 0 else None)

    rep = run_thread_ranks(replay, TP, timeout=CP_TIMEOUT)
    replayed, ticks, counts = rep[0]
    check(all({r: (x.token_ids, x.logprobs) for r, x in g.items()}
              == {r: (x.token_ids, x.logprobs) for r, x in replayed.items()} for g, _, _ in rep),
          "[tp-server] the in-process pool: every rank the same rows")
    print(f"[tp-server] the in-process pool: {len(ticks)} ticks, "
          f"{statistics.median(ticks) / tick * 1e3:.1f} ms a decode step (median tick / {tick}; "
          f"{TP} thread-ranks on one card)")
    _lockstep_gates("tp-server", http, fols, replayed, check)
    del rep
    rank_tiles = [-(-a["images"].shape[0] // TP) for a in admitted if a["images"] is not None]
    _check_launches(counts, {  # the server's pool and the replay's
        "flash_fwd": 2 * TP * layers * sum(chunks(len(a["ids"])) for a in admitted),
        "short_attn": 2 * TP * vc.num_hidden_layers * sum(
            -(-n // vision_chunk) for n in rank_tiles),
    })
    for key in total:
        total[key] += counts[key]
    del lv
    _collect("after the tp server")

    # ---- cp 2 x tp 2: the cp-sharded cache on each rank's kv heads
    text, cut = _decoder_prefix(params, cfg, cpxtp_layers)
    print(f"[tp-serve cp x tp] cp 2 x tp 2 thread-ranks on the decoder's first {cpxtp_layers} "
          f"layers at full width")
    counts = _cp_against_one_device(
        "tp-serve cp 2 x tp 2", text, cut, rng.integers(0, vocab, cpxtp_prompt).tolist(),
        seq=cpxtp_seq, chunk=chunk, vision_chunk=vision_chunk, tokens=new_tokens,
        mesh_cfg=MeshConfig(cp=2, tp=2),
        expected=lambda n: {"flash_fwd": 4 * cpxtp_layers * chunks(n)})
    for key in total:
        total[key] += counts[key]
    print(f"[tp-serve] peak memory of the phase {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"(max_memory_allocated; the one-device weights and every rank's shard views); the "
          f"phase took {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError(f"phase_tp_serve: {failures}")
    return total


# ---- training over tp (phase_tp_train) -------------------------------------------

TP_TRAIN_LAYERS = 4  # the decoder's depth in phase_tp_train (full width)
TP_TRAIN_TIMEOUT = 600.0  # seconds any one wait of a phase_tp_train process may take
STAGED_NOTE = ("two processes sharing one card, their collectives staged through host "
               "memory over gloo: no multi-GPU time")
# the training phases over a mesh take one step in the full run (the
# warm-up's lr-0 step, which every gate reads), for the run's time
MESH_TRAIN_STEPS = 1
# the gradient gate's leaf groups: each norm, each projection, the embedding,
# the head, the tower and the projector
GRAD_GROUPS = ("input_norm", "post_attn_norm", "final_norm", "q_proj", "k_proj", "v_proj",
               "o_proj", "gate_proj", "up_proj", "down_proj", "embed", "lm_head")


# a MoE layer's groups (phase_ep_train)
MOE_GRAD_GROUPS = ("router", "experts")


def _grad_group(name: str) -> str:
    if name.startswith(("vision.", "projector.")):
        return name.split(".")[0]
    return next(g for g in GRAD_GROUPS + MOE_GRAD_GROUPS if f".{g}" in name)


def phase_tp_train_kernels(*, s=16384, heads=(40 // 8, 8 // 8), d=128, dev=None,
                           label="tp-8 rank", tag="tp train kernels") -> float:
    """K1 forward and K4 and K5 backward at a tp-8 rank's heads of the 14B
    ([1, s, 5/1, 128]; or ``heads`` named by ``label``) on T2's packed row
    (a 16-frame video, a 7-tile image, 4 text samples), each against its
    plain version: the forward at O_ATOL + O_RTOL |ref| and LSE_ATOL, the
    backward by segment (_plain_bwd_by_segment) at GRAD_TOL. -> the largest
    error (these launches are not the main path's)."""
    import torch

    from long_vita_tpu_torch.ops import flash_attention as fa

    dev = dev or torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 70)
    hq, hkv = heads

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v, do = rnd(1, s, hq, d), rnd(1, s, hkv, d), rnd(1, s, hkv, d), rnd(1, s, hq, d)
    seg = _train_segments(s, (16,), (2, 3), dev)
    kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    errs = [_kernel_case(f"{label}: K1 [1, {s}, {hq}/{hkv}, {d}] causal, T2's packed row",
                         q, k, v, ref=_plain_fwd_by_segment(q, k, v, seg), **kw)]
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    ref = _plain_bwd_by_segment(q, k, v, o, lse, do, seg)
    for fused, name, wrappers in ((True, "K4", [fa.flash_bwd_fused]),
                                  (False, "K5", [fa.flash_bwd_dkv, fa.flash_bwd_dq])):
        before = [w.launches for w in wrappers]
        got = fa._flash_bwd_cuda(q, k, v, o, lse, do, True, 0, 0, s, seg, seg, fused)
        torch.cuda.synchronize()
        if [w.launches for w in wrappers] != [n + 1 for n in before]:
            raise AssertionError(f"[{tag}] {name} did not launch once")
        errs += _grad_errs(f"{label}: {name} [1, {s}, {hq}/{hkv}, {d}] causal, T2's packed "
                           "row", got, ref)
    return max(errs)


def _tp_train_recipe(work, ckpt, sizes) -> dict:
    """The recipe of phase_tp_train: configs/stage2_16k.yaml's settings (lr
    1e-5 after 100 warmup steps of 7000, the tower at lr x 0.1, everything
    trainable, remat) on sizes["mesh"] ({} for the reference, {"tp": 2},
    or {"tp": 2, "tq": 2}), the logit budget cut to sizes["budget"]."""
    return {
        "model": {"checkpoint": ckpt, "dtype": "bfloat16"},
        "data": {"corpus": os.path.join(work, "corpus.yaml"), "seq_len": sizes["seq"],
                 "logit_budget": sizes["budget"], "vision_chunk": 64},
        "mesh": sizes["mesh"],
        "optim": {"lr": 1.0e-5, "warmup_steps": 100, "total_steps": 7000, "vit_lr_mult": 0.1},
        "run": {"steps": sizes["steps"], "global_batch": 1, "remat": True, "seed": SEED},
    }


def _tp_train_worker(rank, world, init, out, sizes):
    """One process of phase_tp_train: ``world`` 1 is the tp-1 reference (a
    process of its own), else rank ``rank`` of the sizes["mesh"] mesh (tp
    2, or tp 2 x tq 2) over gloo with CUDA operands staged through host
    memory (sizes["backend"] "staged"; every rank on card 0), NCCL (one
    card a rank) or plain gloo on the CPU (the rehearsal). Builds the
    Trainer through train.build_from_recipe (each rank reads its slices of
    the checkpoint), takes the first step's gradients through
    train_step._backward with the norms' tp sum removed (over tq: their tq
    sum; the planted fault), then trains sizes["steps"] steps through
    Trainer.train on the one packed row. Puts (rank, results or the error)
    on ``out``; the tp-1 process writes its gradients to the work
    directory, mesh rank 0 reads them for the gate."""
    import dataclasses

    import numpy as np
    import torch

    try:
        from long_vita_tpu_torch.models import qwen2
        from long_vita_tpu_torch.parallel.comm import init_process_group
        from long_vita_tpu_torch.parallel.sharding import rank_layout
        from long_vita_tpu_torch.training import train as ttrain
        from long_vita_tpu_torch.training import train_step as tts
        from long_vita_tpu_torch.training.loss import collate_packs

        cpu = sizes["device"] == "cpu"
        if cpu:
            torch.set_num_threads(1)
        backend = sizes["backend"]
        comm = None
        if world > 1:
            comm = init_process_group(
                rank, world, init, backend="nccl" if backend == "nccl" else "gloo",
                timeout=TP_TRAIN_TIMEOUT, staged_device="cuda" if backend == "staged" else None)
        dev = torch.device("cpu") if cpu else torch.device("cuda", torch.cuda.current_device())
        sync = (lambda: None) if cpu else torch.cuda.synchronize
        res = {"rank": rank}
        t0 = time.perf_counter()
        trainer, stream, _ = ttrain.build_from_recipe(
            _tp_train_recipe(sizes["work"], sizes["ckpt"], sizes), device=dev, comm=comm)
        del stream  # the phase trains on its own packed row
        sync()
        res["build_s"] = time.perf_counter() - t0
        res["bytes_read"] = trainer.checkpoint_bytes
        cfg, params = trainer.cfg, trainer.state.params
        rng = np.random.default_rng(SEED + 71)
        vc = cfg.vision
        tiles = rng.standard_normal((7, vc.image_size, vc.image_size, 3)).astype(np.float32)
        # a tile's token run as the tower and projector make it (build_from_recipe's rule)
        per_tile = int((vc.grid * cfg.vision_downsample_ratio) ** 2)

        def row(seq, budget):
            # the text samples' supervised tails scale with the row
            pack = _train_pack(dataclasses.replace(cfg, image_token_length=per_tile), seq, [],
                               [(tiles, (2, 3))], np.random.default_rng(SEED + 74),
                               text_segments=4, answer=sizes["answer"],
                               text_sup=sizes["text_sup"] * seq // sizes["seq"])
            b = collate_packs([pack], budget)
            # the media markers are Qwen2.5's ids, inside the 14B's
            # vocabulary; past a smaller one (the rehearsal's) the
            # vocab-parallel lookup gives zeros where the plain one clamps
            # (JAX's two paths), so the rehearsal clamps them first
            b["tokens"] = np.minimum(b["tokens"], cfg.text.vocab_size - 1)
            return b

        batch = row(sizes["seq"], sizes["budget"])
        res["supervised"] = int((batch["labels"] != -100).sum())
        mesh = trainer.mesh
        layout = rank_layout(params, cfg, mesh) if world > 1 else None
        tq_comm = mesh.tq_comm if world > 1 else None

        # ---- the planted fault, before the steps, on a shorter row: the
        # norms' gradients with their tp sum removed (tp 2; over tq their tq
        # sum) against the same row's summed ones (tp 1)
        fault_path = os.path.join(sizes["work"], "norm_grads_tp1.pt")
        fault_len = sizes["fault_seq"]
        fault = "_UNSUMMED_OVER_TQ" if sizes["mesh"].get("tq", 1) > 1 else "_UNSUMMED_OVER_TP"
        if world > 1:
            setattr(tts, fault, ("norm",))
        try:
            g, _, _, _ = tts._backward(
                params, trainer._device_batch(row(fault_len, fault_len)), cfg,
                trainer.tcfg.remat, trainer.tcfg.vision_chunk, trainer.freeze["freeze_vision"],
                trainer.freeze["freeze_text"], mesh=mesh, parallel=tts.make_parallel_config(mesh))
        finally:
            setattr(tts, fault, ())
        norms = {n: t for n, t in g.items() if _grad_group(n).endswith("norm")}
        del g
        if world == 1:
            torch.save({n: t.cpu() for n, t in norms.items()}, fault_path)
        else:
            res["cos_fault"] = _group_cosines(norms, fault_path, layout, mesh.tp_comm, dev,
                                              tq_comm=tq_comm)
        del norms
        if not cpu:
            torch.cuda.empty_cache()

        # ---- the main path: Trainer.train, 2 steps on the packed row; the
        # first step's gradients are kept for the gradient gate
        first = {}
        backward = tts._backward

        def keep_first(*a, **k):
            out = backward(*a, **k)
            first.setdefault("grads", out[0])
            return out

        tts._backward = keep_first
        before = {n: _fingerprint(p) for n, p in params.named_parameters()}
        step_fn, kept = trainer.step_fn, []
        norms_log = []

        def logged(state, b):
            state, m = step_fn(state, b)
            norms_log.append(float(m["grad_norm"]))
            if not kept:  # the warm-up's first step runs at lr 0
                kept.append(sorted(n for n, p in state.params.named_parameters()
                                   if _fingerprint(p) != before[n]))
            return state, m

        trainer.step_fn = logged
        stamps, staged = [], []
        stats = getattr(comm, "stats", None)

        def batches():
            for _ in range(sizes["steps"]):
                sync()
                stamps.append(time.perf_counter())
                staged.append(stats["seconds"] if stats else 0.0)
                yield batch

        _reset_counts()
        if not cpu:
            torch.cuda.reset_peak_memory_stats()
        try:
            res["losses"] = trainer.train(batches())["losses"]
        finally:
            tts._backward = backward
        sync()
        stamps.append(time.perf_counter())
        staged.append(stats["seconds"] if stats else 0.0)
        res["peak_gb"] = 0.0 if cpu else torch.cuda.max_memory_allocated() / 1e9
        path = os.path.join(sizes["work"], "grads_tp1.pt")
        if world == 1:
            torch.save({n: t.cpu() for n, t in first.pop("grads").items()}, path)
        else:
            res["cos"] = _group_cosines(first.pop("grads"), path, layout, mesh.tp_comm, dev,
                                        tq_comm=tq_comm)
        res["counts"] = _read_counts()
        res["norms"] = norms_log
        res["step_s"] = [b - a for a, b in zip(stamps, stamps[1:])]
        res["staged_s"] = [b - a for a, b in zip(staged, staged[1:])]
        res["staged_gb"] = stats["bytes"] / 1e9 if stats else 0.0
        res["moved_at_lr0"] = kept[0] if kept else None
        res["heads"] = (qwen2.out_features(params.text.layers[0].q_proj) // cfg.text.head_dim,
                        qwen2.kv_heads(params.text, cfg.text))
        out.put((rank, res))
        if comm is not None:
            comm.barrier()
            torch.distributed.destroy_process_group()
    except Exception as e:  # noqa: BLE001 (reported to the parent)
        import traceback

        out.put((rank, f"raised {type(e).__name__}: {e}\n{traceback.format_exc()[-2500:]}"))


def _group_cosines(grads: dict, ref_path: str, layout, tp_comm, dev, dp_comm=None,
                   tq_comm=None, pp_comm=None) -> dict:
    """Cosine of each leaf group's whole gradient (GRAD_GROUPS, the tower,
    the projector) against the reference process's, from this rank's
    shards: each rank takes the dot products of its slices with the same
    slices of the reference's gradients (read from the memory-mapped file),
    a slice several ranks hold and a replicated leaf counted once, and the
    sums are added over tp (and under FSDP or expert parallelism over
    ``dp_comm``: an FSDP piece or an expert stack's on every dp rank, any
    other leaf on dp rank 0; under 2-D tp over
    ``tq_comm``: a piece cut over tq on every tq rank, any other leaf on tq
    rank 0; over pp, ``pp_comm``: a stage's layer on its stage, under its
    global name in the file, any other leaf on the first stage), which
    gives the gathered vectors' cosines without moving them. Every rank of
    those groups calls it; only the groups of ``grads`` that the file holds
    are compared. -> {group: cosine}."""
    import torch

    from long_vita_tpu_torch.parallel.sharding import renamed, slice_leaf

    def source(n):
        leaf = layout[n]
        return renamed(n, leaf.pp_layer) if leaf.staged else n

    ref = torch.load(ref_path, map_location="cpu", weights_only=True, mmap=True)
    grads = {n: g for n, g in grads.items() if source(n) in ref}
    groups = sorted({_grad_group(n) for n in grads})
    acc = torch.zeros(len(groups), 3, dtype=torch.float64, device=dev)
    dp_rank = dp_comm.rank if dp_comm is not None else 0
    tq_rank = tq_comm.rank if tq_comm is not None else 0
    pp_rank = pp_comm.rank if pp_comm is not None else 0
    for n, g in grads.items():
        leaf = layout[n]
        if tp_comm.rank % leaf.share if leaf.sharded else tp_comm.rank:
            continue
        if (dp_rank and not (leaf.fsdp or leaf.expert)) or (tq_rank and not leaf.cut_tq):
            continue
        if pp_rank and not leaf.staged:
            continue
        a = g.to(dev).float().flatten()
        b = slice_leaf(ref[source(n)], leaf).to(dev).float().flatten()
        acc[groups.index(_grad_group(n))] += torch.stack([a @ b, a @ a, b @ b]).double()
    acc = tp_comm.all_reduce_sum(acc)
    if dp_comm is not None:
        acc = dp_comm.all_reduce_sum(acc)
    if tq_comm is not None:
        acc = tq_comm.all_reduce_sum(acc)
    if pp_comm is not None:
        acc = pp_comm.all_reduce_sum(acc)
    return {k: dot / max((aa * bb) ** 0.5, 1e-30)
            for k, (dot, aa, bb) in zip(groups, acc.tolist())}


def _spawn(target, world, sizes, timeout) -> dict:
    """Run target(rank, world, init, queue, sizes) in ``world`` spawned
    processes on a free localhost port; -> {rank: what it put}. Every
    process is stopped before this returns."""
    import queue as queue_mod
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, world, f"tcp://127.0.0.1:{port}", out, sizes))
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world and time.monotonic() < deadline:
            try:
                rank, res = out.get(timeout=5)
                results[rank] = res
            except queue_mod.Empty:
                if not any(p.is_alive() for p in procs):
                    break
        for p in procs:
            p.join(max(1.0, min(60.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    bad = {r: res for r, res in results.items() if isinstance(res, str)}
    if len(results) < world or bad:
        raise AssertionError(f"processes failed or did not report: {bad or sorted(results)}")
    return results


def _reference(target, sizes, timeout) -> dict:
    """The world-1 reference of a multi-process training phase:
    target(0, 1, None, queue, sizes) in this process on the card (a spawned
    process takes ~8-10 s to reach it), its memory freed after; in a process
    of its own on the CPU (the rehearsals: the workers set process-wide state,
    the thread count and the tokenizer loader). -> what it put."""
    if sizes["device"] == "cpu":
        return _spawn(target, 1, sizes, timeout)[0]
    import queue as queue_mod

    import torch

    out = queue_mod.SimpleQueue()
    target(0, 1, None, out, sizes)
    _, res = out.get()
    gc.collect()
    torch.cuda.empty_cache()
    if isinstance(res, str):
        raise AssertionError(f"the reference failed: {res}")
    return res


def phase_tp_train(*, backend="staged", device="cuda", cfg=None, layers=TP_TRAIN_LAYERS,
                   seq=16384, budget=4096, fault_seq=4096, steps=2, answer=300, text_sup=900,
                   first_special=QWEN25_FIRST_ADDED, kernels=True, tq=1) -> dict:
    """Training over tp from the recipe entry: the 14B VLM at full width, the
    decoder cut to ``layers`` layers, the InternViT-300M tower at 24,
    written as a *_HF checkpoint directory; configs/stage2_16k.yaml's
    settings (the tower trainable at lr x 0.1, remat, 16384 tokens), the
    logit budget cut to 4096; one packed row with a 7-tile image: of
    ``seq - 1`` tokens for tp 2 (a row that does not split over tp: rank
    1's slice ends in a pad row), of ``seq`` for tp 2 x tq (the even
    path). First the tp-1 reference of each length
    (_reference: in this process on the card), then tp 2 in two processes
    (backend "staged": gloo sharing this card with host-staged collectives;
    "nccl": a card each, from phase_cp_nccl; "gloo" with device "cpu": the
    rehearsal), each rank loading only its slices; with tq > 1, then 2-D tp
    (tp 2 x tq, the stage-2 recipe's mesh {dp: 4, tp: 8} cut to {tp: 2,
    tq: tq}) in 2 x tq processes from the same directory, held to the same
    tp-1 reference. Gates,
    for each geometry: each step's loss within TRAIN_LOSS_REL of tp 1's and
    grad_norm within 3x that; every rank the same loss bits; the first
    step's gradients against tp 1's at cosine >= TRAIN_GRAD_COS for every
    leaf group (the whole vectors' cosines, from each rank's shards:
    _group_cosines), and the same gate failing with the norms' tp sum (over
    tq: their tq sum) removed (on a fault_seq-token row of the same layout,
    before the steps); the warm-up's lr-0 first step leaving every leaf's
    bits (stage 2 freezes none); K1, K3, K4 and K5 launches exact for the
    layers, steps and remat. kernels: first K1, K4 and K5 at a tp-8 rank's
    heads. -> {"counts": every process's launches but the reference's
    summed, "err": the kernels' largest error}."""
    import dataclasses

    import numpy as np
    import torch

    from long_vita_tpu_torch.config import long_vita_14b
    from long_vita_tpu_torch.models import qwen2
    from long_vita_tpu_torch.utils.export_hf import save_hf_checkpoint

    t_phase = time.perf_counter()
    cpu = device == "cpu"
    dev = torch.device(device)
    err = phase_tp_train_kernels(dev=dev) if kernels else 0.0
    base = cfg or long_vita_14b()
    cfg = dataclasses.replace(base, text=dataclasses.replace(base.text, num_hidden_layers=layers))
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_tp_train_", dir=build)
    runs, ones = {}, {}
    try:
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(SEED + 72)
        rng = np.random.default_rng(SEED + 73)
        probe = rng.standard_normal((2, cfg.vision.image_size, cfg.vision.image_size, 3),
                                    dtype=np.float32)
        lv, _ = _vlm_params(qwen2.init_qwen2_params(gen, cfg.text, torch.bfloat16, dev), cfg,
                            dev, SEED + 72, probe)
        ckpt = os.path.join(work, "ckpt")
        save_hf_checkpoint(lv, cfg, ckpt)
        tokenizer_dir(ckpt, first_special)
        whole_gb = sum(p.nbytes for p in lv.parameters()) / 1e9
        text_gb = sum(p.nbytes for p in lv.text.parameters()) / 1e9
        del lv
        if not cpu:
            torch.cuda.empty_cache()
        with open(os.path.join(work, "corpus.yaml"), "w") as f:  # the recipe names one
            json.dump({"dataset": {"chat": {"ratio": 1, "data_paths": [
                os.path.join(work, "chat.jsonl")]}}}, f)
        with open(os.path.join(work, "chat.jsonl"), "w") as f:
            f.write(json.dumps({"messages": [{"role": "user", "content": "hi"},
                                             {"role": "assistant", "content": "hello"}]}))
        print(f"[tp train] the {layers}-layer VLM at full width ({whole_gb:.2f} GB, the decoder "
              f"{text_gb:.2f} GB) written as a checkpoint directory in "
              f"{time.perf_counter() - t0:.1f} s")
        sizes = dict(device=device, backend=backend, work=work, ckpt=ckpt, budget=budget,
                     fault_seq=fault_seq, steps=steps, answer=answer, text_sup=text_sup)
        geometries = [("tp 2", {"tp": 2}, seq - 1)]
        if tq > 1:
            geometries.append((f"tp 2 x tq {tq}", {"tp": 2, "tq": tq}, seq))
        for geom, mesh, n in geometries:
            if n not in ones:  # the tp-1 reference of the row's length
                t0 = time.perf_counter()
                ones[n] = _reference(_tp_train_worker,
                                     {**sizes, "seq": n, "backend": "gloo", "mesh": {}},
                                     2 * TP_TRAIN_TIMEOUT)
                print(f"[tp train] the tp-1 reference at {n} tokens "
                      f"{time.perf_counter() - t0:.1f} s (start-up, loading, the gradient "
                      "gate's passes, the steps)")
            t0 = time.perf_counter()
            world = int(np.prod(list(mesh.values())))
            runs[geom] = _spawn(_tp_train_worker, world, {**sizes, "seq": n, "mesh": mesh},
                                2 * TP_TRAIN_TIMEOUT)
            print(f"[tp train] the {geom} processes {time.perf_counter() - t0:.1f} s (start-up, "
                  "loading, the gradient gate's passes, the steps)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    failures = []
    where = {"staged": "{n} processes sharing one card, their collectives staged through "
                       "host memory over gloo: no multi-GPU time",
             "nccl": "{n} cards over NCCL", "gloo": "{n} gloo processes on the CPU"}[backend]
    for n, one in ones.items():
        print(f"[tp train] tp 1 (the reference) at {n} tokens: read "
              f"{one['bytes_read'] / 1e6:.3f} MB; steps {[round(t, 3) for t in one['step_s']]} "
              f"s; peak allocated {one['peak_gb']:.2f} GB; losses {one['losses']} grad_norm "
              f"{one['norms']}; {one['supervised']} supervised rows")
    for geom, mesh, n in geometries:
        ranks = runs[geom]
        print(f"[tp train] {geom} at {n} tokens, against tp 1 at {n}")
        _tp_train_gates(geom, ranks, ones[n], cfg, n, fault_seq, whole_gb,
                        where.format(n=len(ranks)), cpu, failures)
    print(f"[tp train] phase {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError(f"[tp train] {failures}")
    counts = dict.fromkeys(next(iter(ones.values()))["counts"], 0)
    for ranks in runs.values():
        for r in ranks.values():
            for k in counts:
                counts[k] += r["counts"][k]
    return {"counts": counts, "err": err}


def _tp_train_gates(geom, ranks, one, cfg, seq, fault_seq, whole_gb, where, cpu,
                    failures) -> None:
    """phase_tp_train's gates for one geometry (``ranks``: rank -> the
    worker's results) against the tp-1 reference ``one``; a failed gate is
    appended to ``failures``."""
    from long_vita_tpu_torch.ops import flash_attention as fa

    def check(good: bool, what: str) -> None:
        print(f"[tp train] {what}: {'ok' if good else 'FAIL'}")
        if not good:
            failures.append(what)

    r0 = ranks[0]
    steps = len(one["step_s"])
    for r in ranks.values():
        print(f"[tp train] {geom} rank {r['rank']} ({r['heads'][0]}/{r['heads'][1]} heads): built "
              f"through train.build_from_recipe in {r['build_s']:.1f} s, read "
              f"{r['bytes_read'] / 1e6:.3f} MB of the checkpoint's {whole_gb * 1e3:.3f} MB; steps "
              f"{[round(t, 3) for t in r['step_s']]} s ({where}), staged copies "
              f"{[round(t, 3) for t in r['staged_s']]} s of them "
              f"({r['staged_gb']:.2f} GB copied in the run); peak allocated "
              f"{r['peak_gb']:.2f} GB; losses {r['losses']} grad_norm {r['norms']}")
    same = ("both tp ranks report" if len(ranks) == 2 else
            f"all {len(ranks)} ranks of {geom} report")
    check(all(r["losses"] == r0["losses"] for r in ranks.values()), f"{same} the same loss bits")
    ref_losses, ref_norms = one["losses"], one["norms"]
    check(len(r0["losses"]) == steps and all(
        abs(a - b) <= TRAIN_LOSS_REL * abs(b) for a, b in zip(r0["losses"], ref_losses)),
        f"{geom} losses {r0['losses']} within {TRAIN_LOSS_REL} (relative) of tp 1's "
        f"{ref_losses}")
    check(all(abs(a - b) <= 3 * TRAIN_LOSS_REL * abs(b) for a, b in zip(r0["norms"], ref_norms)),
          f"{geom} grad_norm {r0['norms']} within {3 * TRAIN_LOSS_REL} of tp 1's {ref_norms}")
    cos, fault = r0["cos"], r0["cos_fault"]
    check(min(cos.values()) >= TRAIN_GRAD_COS and set(cos) == set(GRAD_GROUPS) | {
        "vision", "projector"},
        f"the first step's gradients of the {geom} shards vs tp 1's, cosine by group "
        f"(>= {TRAIN_GRAD_COS}): " + ", ".join(f"{k} {v:.6f}" for k, v in cos.items()))
    summed = "tq" if "tq" in geom else "tp"
    check(min(fault.values()) < TRAIN_GRAD_COS,
          f"the same gate with the norms' {summed} sum removed (a planted fault; a "
          f"{fault_seq}-token row) must fail: "
          + ", ".join(f"{k} {v:.6f}" for k, v in fault.items()))
    check(all(r["moved_at_lr0"] == [] for r in [*ranks.values(), one]),
          "the warm-up's first step (lr 0) leaves every leaf's bits on every rank "
          "(stage 2 freezes no leaf)")
    # the launches of the main path on each rank: the decoder's K1 twice a
    # layer a step (remat's recompute), the tower's on every rank (it
    # encodes every tile, trainable); the backward by JAX's rule at the
    # rank's heads (the same on every tq rank of a tp index)
    tc, vc = cfg.text, cfg.vision
    for r in [*ranks.values(), one]:
        hq, _ = r["heads"]
        fused = fa.bwd_uses_fused(1, seq, seq, hq, tc.head_dim, 2)
        vit_fused = fa.bwd_uses_fused(7, vc.seq_len, vc.seq_len, vc.num_attention_heads,
                                      vc.head_dim, 2)
        want = dict.fromkeys(r["counts"], 0)
        want["flash_fwd"] = 2 * (tc.num_hidden_layers + vc.num_hidden_layers) * steps
        for n_layers, uses in ((tc.num_hidden_layers, fused), (vc.num_hidden_layers, vit_fused)):
            if uses:
                want["flash_bwd"] += n_layers * steps
            else:
                want["flash_bwd_dkv"] += n_layers * steps
                want["flash_bwd_dq"] += n_layers * steps
        if not cpu:
            check(r["counts"] == want,
                  f"launches of {'tp 1' if r is one else f'{geom} rank {r['rank']}'}: "
                  f"{r['counts']} (expected {want})")
        elif r is not one:
            print(f"[tp train] launches (the CPU runs the plain versions): {r['counts']}")
    step = min(r0["step_s"])
    share = [s / t for s, t in zip(r0["staged_s"], r0["step_s"])]
    peaks = [round(r["peak_gb"], 2) for r in ranks.values()]
    print(f"[tp train] a {geom} step {step:.3f} s against a tp-1 step {min(one['step_s']):.3f} "
          f"s ({where}); the staged copies' share of a {geom} step "
          f"{[round(x, 3) for x in share]}; each process's peak allocated {peaks} GB, "
          f"{sum(peaks):.2f} GB together")


# ---- FSDP: ZeRO-3 weight streaming over dp (phase_fsdp_train) --------------------

# the 72B decoder's depth in phase_fsdp_train (full width; 2 until the pp x
# FSDP phase joined the run, for the run's time)
FSDP_TRAIN_LAYERS = 1
# the planted reduce-scatter fault's gradient groups (final_norm, no FSDP leaf, a control)
FSDP_FAULT_GROUPS = ("input_norm", "post_attn_norm", "final_norm", "q_proj", "k_proj", "v_proj",
                     "o_proj")


def _fsdp_train_recipe(work, ckpt, sizes, dp, tp) -> dict:
    """The recipe of phase_fsdp_train: configs/stage2_72b_tp8fsdp8.yaml's
    settings (lr 1e-5 after 210 warmup steps of 7000, min lr 1e-7, the
    tower at lr x 0.1 with layer decay 0.9, everything trainable, remat,
    FSDP) at dp x tp, two packed rows a step (global_batch 2), the logit
    budget cut to sizes["budget"]; dp 1: the reference, without FSDP."""
    mesh = {"dp": dp, "tp": tp} if dp * tp > 1 else {}
    return {
        "model": {"checkpoint": ckpt, "dtype": "bfloat16"},
        "data": {"corpus": os.path.join(work, "corpus.yaml"), "seq_len": sizes["seq"],
                 "logit_budget": sizes["budget"], "vision_chunk": 64},
        "mesh": mesh,
        "optim": {"lr": 1.0e-5, "min_lr_ratio": 0.01, "warmup_steps": 210, "total_steps": 7000,
                  "vit_lr_mult": 0.1, "vit_layer_decay": 0.9},
        "run": {"steps": sizes["steps"], "global_batch": 2, "remat": True, "seed": SEED,
                "fsdp": dp > 1},
    }


def _fsdp_train_worker(rank, world, init, out, sizes):
    """One process of phase_fsdp_train: ``world`` 1 is the reference (FSDP
    off, both rows, a process of its own), else rank ``rank`` of dp 2 x
    sizes["tp"] with FSDP, over gloo with CUDA operands staged through host
    memory (sizes["backend"] "staged"; every rank on card 0), NCCL (a card
    a rank) or plain gloo on the CPU (the rehearsal). Builds the Trainer
    through train.build_from_recipe (an FSDP rank reads its pieces of the
    checkpoint), takes two 4096-token passes for the planted faults (the
    norm without its dp sum of squares; the reduce-scatter replaced by the
    rank's own slice), then trains sizes["steps"] steps through
    Trainer.train on two packed rows (one a dp rank). Puts (rank, results
    or the error) on ``out``; the reference writes its gradients to the
    work directory, the FSDP ranks read them for the gates."""
    import dataclasses

    import numpy as np
    import torch

    # two ranks share the card: the allocator grows its segments in place
    # rather than keeping freed blocks of one size (read at the card's first use)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    try:
        from long_vita_tpu_torch.models import qwen2
        from long_vita_tpu_torch.parallel import fsdp as fsdp_mod
        from long_vita_tpu_torch.parallel.comm import init_process_group
        from long_vita_tpu_torch.training import train as ttrain
        from long_vita_tpu_torch.training import train_step as tts
        from long_vita_tpu_torch.training.loss import collate_packs
        from long_vita_tpu_torch.training.optimizer import global_norm

        cpu = sizes["device"] == "cpu"
        if cpu:
            torch.set_num_threads(1)
        backend = sizes["backend"]
        comm = None
        if world > 1:
            comm = init_process_group(
                rank, world, init, backend="nccl" if backend == "nccl" else "gloo",
                timeout=TP_TRAIN_TIMEOUT, staged_device="cuda" if backend == "staged" else None)
        dev = torch.device("cpu") if cpu else torch.device("cuda", torch.cuda.current_device())
        sync = (lambda: None) if cpu else torch.cuda.synchronize
        res = {"rank": rank}
        dp, tp = (2, sizes["tp"]) if world > 1 else (1, 1)
        t0 = time.perf_counter()
        trainer, stream, _ = ttrain.build_from_recipe(
            _fsdp_train_recipe(sizes["work"], sizes["ckpt"], sizes, dp, tp), device=dev,
            comm=comm)
        del stream  # the phase trains on its own packed rows
        sync()
        res["build_s"] = time.perf_counter() - t0
        res["bytes_read"] = trainer.checkpoint_bytes
        cfg, params, mesh = trainer.cfg, trainer.state.params, trainer.mesh
        fs = params.text.fsdp
        res["coords"] = (mesh.dp_index, mesh.tp_index) if mesh is not None else (0, 0)
        res["param_bytes"] = sum(p.nbytes for p in params.parameters())
        opt = trainer.state.opt_state
        res["moment_bytes"] = sum(t.nbytes for t in list(opt.mu.values()) + list(opt.nu.values()))
        layout = trainer._layout()
        vc = cfg.vision
        per_tile = int((vc.grid * cfg.vision_downsample_ratio) ** 2)
        tiles = [np.random.default_rng(SEED + 81 + i).standard_normal(
            (7, vc.image_size, vc.image_size, 3)).astype(np.float32) for i in range(2)]

        def rows(seq, budget):
            # two packed rows, each with a 7-tile image; a dp rank keeps its own
            packs = [_train_pack(dataclasses.replace(cfg, image_token_length=per_tile), seq, [],
                                 [(tiles[i], (2, 3))], np.random.default_rng(SEED + 84 + i),
                                 text_segments=4, answer=sizes["answer"],
                                 text_sup=sizes["text_sup"] * seq // sizes["seq"])
                     for i in range(2)]
            b = collate_packs(packs, budget)
            b["tokens"] = np.minimum(b["tokens"], cfg.text.vocab_size - 1)  # see _tp_train_worker
            return b

        batch = rows(sizes["seq"], sizes["budget"])
        res["supervised"] = int((batch["labels"] != -100).sum())
        flags = (trainer.tcfg.remat, trainer.tcfg.vision_chunk, trainer.freeze["freeze_vision"],
                 trainer.freeze["freeze_text"])
        parallel = tts.make_parallel_config(mesh)

        def backward(b):
            return tts._backward(params, b, cfg, *flags, mesh=mesh, parallel=parallel)[0]

        # ---- the planted faults, before the steps, on 4096-token rows
        fault_path = os.path.join(sizes["work"], "fault_grads_ref.pt")
        fault_batch = trainer._device_batch(rows(sizes["fault_seq"], sizes["fault_seq"]))
        g = backward(fault_batch)
        # grad_norm, and the decoder's part of it (the tower's random
        # gradients outweigh the decoder's, which FSDP cuts)
        text = {n: t for n, t in g.items() if n.startswith("text.")}
        if world == 1:
            res["fault_norm"] = [float(global_norm(x.values())) for x in (g, text)]
            torch.save({n: t.cpu() for n, t in g.items()
                        if _grad_group(n) in FSDP_FAULT_GROUPS}, fault_path)
        else:
            red = tts._Reduction(params, cfg, mesh)
            res["fault_norm"] = [float(red.norm(x)) for x in (g, text)]
            tts._NORM_UNSUMMED_OVER_DP = True
            try:
                res["fault_norm_unsummed"] = [float(red.norm(x)) for x in (g, text)]
            finally:
                tts._NORM_UNSUMMED_OVER_DP = False
        del g, text
        if world > 1:
            fsdp_mod._LOCAL_SLICE_NOT_SCATTERED = True
            try:
                g = backward(fault_batch)
            finally:
                fsdp_mod._LOCAL_SLICE_NOT_SCATTERED = False
            res["cos_fault"] = _group_cosines(g, fault_path, layout, mesh.tp_comm, dev,
                                              mesh.dp_comm)
            del g
        del fault_batch
        if not cpu:
            torch.cuda.empty_cache()

        # ---- the main path: Trainer.train, the steps on the two rows; the
        # first step's gradients kept on the host for the gradient gate
        first = {}
        step_backward = tts._backward

        def keep_first(*a, **k):
            out = step_backward(*a, **k)
            if "grads" not in first:
                first["grads"] = {n: t.to("cpu") for n, t in out[0].items()}
            return out

        tts._backward = keep_first
        before = {n: _fingerprint(p) for n, p in params.named_parameters()}
        step_fn, kept, norms_log = trainer.step_fn, [], []

        def logged(state, b):
            state, m = step_fn(state, b)
            norms_log.append(float(m["grad_norm"]))
            if not kept:  # the warm-up's first step runs at lr 0
                kept.append(sorted(n for n, p in state.params.named_parameters()
                                   if _fingerprint(p) != before[n]))
            return state, m

        trainer.step_fn = logged
        stamps, staged, moved = [], [], []
        stats = getattr(comm, "stats", None)

        def batches():
            for _ in range(sizes["steps"]):
                sync()
                stamps.append(time.perf_counter())
                staged.append(stats["seconds"] if stats else 0.0)
                moved.append(stats["bytes"] if stats else 0)
                yield batch

        _reset_counts()
        if fs is not None:
            fs.reset_stats()
        if not cpu:
            res["peak_before_gb"] = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
        try:
            res["losses"] = trainer.train(batches())["losses"]
        finally:
            tts._backward = step_backward
        sync()
        stamps.append(time.perf_counter())
        staged.append(stats["seconds"] if stats else 0.0)
        moved.append(stats["bytes"] if stats else 0)
        res["peak_gb"] = 0.0 if cpu else torch.cuda.max_memory_allocated() / 1e9
        res["counts"] = _read_counts()
        res["fsdp_stats"] = dict(fs.stats) if fs is not None else None
        grads = first.pop("grads")
        res["grad_bytes"] = sum(t.nbytes for t in grads.values())
        path = os.path.join(sizes["work"], "grads_ref.pt")
        if world == 1:
            torch.save(grads, path)
        else:
            res["cos"] = _group_cosines(grads, path, layout, mesh.tp_comm, dev, mesh.dp_comm)
        del grads
        res["norms"] = norms_log
        res["step_s"] = [b - a for a, b in zip(stamps, stamps[1:])]
        res["staged_s"] = [b - a for a, b in zip(staged, staged[1:])]
        res["staged_gb"] = [(b - a) / 1e9 for a, b in zip(moved, moved[1:])]
        res["moved_at_lr0"] = kept[0] if kept else None
        res["heads"] = (qwen2.out_features(params.text.layers[0].q_proj) // cfg.text.head_dim,
                        qwen2.kv_heads(params.text, cfg.text))
        out.put((rank, res))
        if comm is not None:
            comm.barrier()
            torch.distributed.destroy_process_group()
    except Exception as e:  # noqa: BLE001 (reported to the parent)
        import traceback

        out.put((rank, f"raised {type(e).__name__}: {e}\n{traceback.format_exc()[-2500:]}"))


def _shard_bytes(shapes: dict, specs: dict, hkv: int, d: int, dp: int, t: int, tp: int,
                 text_only: bool = False) -> int:
    """The bytes of the tensors rank (d, t) holds of a tree of ``shapes``
    (name -> (shape, dtype)) cut over tp and, with dp > 1, by FSDP: the
    shard arithmetic, on meta tensors."""
    import torch

    from long_vita_tpu_torch.parallel.sharding import fsdp_dim, leaf_rule, slice_leaf

    total = 0
    for n, (shape, dtype) in shapes.items():
        if text_only and not n.startswith("text."):
            continue
        leaf = leaf_rule(n, specs[n], t, tp, hkv, fsdp_dim(n), d, dp)
        total += slice_leaf(torch.empty(shape, dtype=dtype, device="meta"), leaf).nbytes
    return total


def phase_fsdp_train(*, backend="staged", device="cuda", cfg=None, layers=FSDP_TRAIN_LAYERS,
                     tp=1, seq=16384, budget=4096, fault_seq=4096, steps=2, answer=300,
                     text_sup=900, first_special=QWEN25_FIRST_ADDED, kernels=True) -> dict:
    """FSDP from the recipe entry: the 72B VLM (long_vita_72b(): h 8192, ffn
    29568, 64/8 heads, vocab 152064) at full width, the decoder cut to
    ``layers`` layers, the InternViT-300M tower at 24, written as a *_HF
    checkpoint directory; configs/stage2_72b_tp8fsdp8.yaml's settings
    (everything trainable, the tower at lr x 0.1 with layer decay 0.9,
    remat, 16384 tokens), the logit budget cut to 4096; two packed rows,
    each with a 7-tile image. First the reference (FSDP off, dp 1, both
    rows) in a process of its own, then dp 2 x ``tp`` with FSDP, a row a dp
    rank (backend "staged": two gloo processes sharing this card with
    host-staged collectives; "nccl": a card a rank, from phase_cp_nccl;
    "gloo" with device "cpu": the rehearsal), each rank reading only its
    pieces. Gates: each step's loss within TRAIN_LOSS_REL of the
    reference's and grad_norm within 3x that; every rank the same loss
    bits; the first step's gradients against the reference's at cosine >=
    TRAIN_GRAD_COS for every leaf group (from the shards); two planted
    faults on 4096-token rows that must fail: grad_norm without its dp sum
    of squares (against the reference's norm of those rows, which the sound
    norm meets), and the reduce-scatter replaced by the rank's own slice
    (the cosine gate); the warm-up's lr-0 step leaving every bit; each
    rank's resident parameter, gradient and moment bytes the shard
    arithmetic exactly, and the bytes it read those of its pieces plus the
    tower and projector whole; K1, K3, K4 and K5 launches exact. kernels:
    first K1, K4 and K5 at a rank's heads on T2's packed row. -> {"counts":
    every FSDP rank's launches summed, "err": the kernels' largest error}."""
    import dataclasses

    import numpy as np
    import torch

    from long_vita_tpu_torch.config import long_vita_72b
    from long_vita_tpu_torch.models import qwen2
    from long_vita_tpu_torch.ops import flash_attention as fa
    from long_vita_tpu_torch.parallel.sharding import long_vita_param_specs
    from long_vita_tpu_torch.utils.export_hf import save_hf_checkpoint

    t_phase = time.perf_counter()
    cpu = device == "cpu"
    dev = torch.device(device)
    base = cfg or long_vita_72b()
    heads = (base.text.num_attention_heads // tp, max(base.text.num_key_value_heads // tp, 1))
    err = phase_tp_train_kernels(heads=heads, dev=dev, label="a 72B FSDP rank",
                                 tag="fsdp train kernels") if kernels else 0.0
    cfg = dataclasses.replace(base, text=dataclasses.replace(base.text, num_hidden_layers=layers))
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_fsdp_train_", dir=build)
    try:
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(SEED + 82)
        rng = np.random.default_rng(SEED + 83)
        probe = rng.standard_normal((2, cfg.vision.image_size, cfg.vision.image_size, 3),
                                    dtype=np.float32)
        lv, _ = _vlm_params(qwen2.init_qwen2_params(gen, cfg.text, torch.bfloat16, dev), cfg,
                            dev, SEED + 82, probe)
        ckpt = os.path.join(work, "ckpt")
        save_hf_checkpoint(lv, cfg, ckpt)
        tokenizer_dir(ckpt, first_special)
        shapes = {n: (tuple(p.shape), p.dtype) for n, p in lv.named_parameters()}
        specs = long_vita_param_specs(lv)
        whole_b = sum(p.nbytes for p in lv.parameters())
        text_b = sum(p.nbytes for p in lv.text.parameters())
        del lv
        if not cpu:
            torch.cuda.empty_cache()
        with open(os.path.join(work, "corpus.yaml"), "w") as f:  # the recipe names one
            json.dump({"dataset": {"chat": {"ratio": 1, "data_paths": [
                os.path.join(work, "chat.jsonl")]}}}, f)
        with open(os.path.join(work, "chat.jsonl"), "w") as f:
            f.write(json.dumps({"messages": [{"role": "user", "content": "hi"},
                                             {"role": "assistant", "content": "hello"}]}))
        tc = cfg.text
        print(f"[fsdp train] the VLM at full width (h {tc.hidden_size}, ffn "
              f"{tc.intermediate_size}, {tc.num_attention_heads}/{tc.num_key_value_heads} heads, "
              f"vocab {tc.vocab_size}; {layers} decoder layers; {whole_b / 1e9:.3f} GB, the "
              f"decoder {text_b / 1e9:.3f} GB) written as a checkpoint directory in "
              f"{time.perf_counter() - t0:.1f} s")
        sizes = dict(device=device, backend=backend, work=work, ckpt=ckpt, seq=seq, tp=tp,
                     budget=budget, fault_seq=fault_seq, steps=steps, answer=answer,
                     text_sup=text_sup)
        t0 = time.perf_counter()
        one = _reference(_fsdp_train_worker, {**sizes, "backend": "gloo"},
                         2 * TP_TRAIN_TIMEOUT)
        t1 = time.perf_counter()
        world = 2 * tp
        ranks = [r for _, r in sorted(_spawn(_fsdp_train_worker, world, sizes,
                                             2 * TP_TRAIN_TIMEOUT).items())]
        print(f"[fsdp train] the reference {t1 - t0:.1f} s, the {world} FSDP processes "
              f"{time.perf_counter() - t1:.1f} s (start-up, loading, the faults' passes, the "
              "steps)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    failures = []

    def check(good: bool, what: str) -> None:
        print(f"[fsdp train] {what}: {'ok' if good else 'FAIL'}")
        if not good:
            failures.append(what)

    where = {"staged": STAGED_NOTE, "nccl": f"{world} cards over NCCL",
             "gloo": f"{world} gloo processes on the CPU"}[backend]
    geom = f"dp 2 x tp {tp}" if tp > 1 else "dp 2"
    hkv = cfg.text.num_key_value_heads
    r0 = ranks[0]
    for r in ranks:
        st = r["fsdp_stats"]
        print(f"[fsdp train] rank (dp {r['coords'][0]}, tp {r['coords'][1]}) of {geom} "
              f"({r['heads'][0]}/{r['heads'][1]} heads): built through train.build_from_recipe "
              f"in {r['build_s']:.1f} s, read {r['bytes_read'] / 1e6:.3f} MB of the checkpoint's "
              f"{whole_b / 1e6:.3f} MB; holds {r['param_bytes'] / 1e9:.3f} GB of parameters, "
              f"{r['moment_bytes'] / 1e9:.3f} GB of moments, {r['grad_bytes'] / 1e9:.3f} GB of "
              f"gradients; steps {[round(t, 3) for t in r['step_s']]} s ({where}), staged copies "
              f"{[round(t, 3) for t in r['staged_s']]} s of them, "
              f"{[round(b, 3) for b in r['staged_gb']]} GB staged a step; the main path's "
              f"gathers {st['gathers']}, regathers {st['regathers']}, reduce-scatters "
              f"{st['scatters']}, {st['gathered_bytes'] / 1e9:.3f} GB gathered, at most "
              f"{st['peak_live']} unit(s) of whole weights alive; peak allocated "
              f"{r['peak_gb']:.2f} GB in the steps ({r.get('peak_before_gb', 0.0):.2f} GB "
              f"before them); losses {r['losses']} grad_norm {r['norms']}")
    print(f"[fsdp train] the reference (FSDP off, one process, both rows): read "
          f"{one['bytes_read'] / 1e6:.3f} MB; holds {one['param_bytes'] / 1e9:.3f} GB of "
          f"parameters, {one['moment_bytes'] / 1e9:.3f} GB of moments; steps "
          f"{[round(t, 3) for t in one['step_s']]} s; peak allocated {one['peak_gb']:.2f} GB "
          f"({one.get('peak_before_gb', 0.0):.2f} GB before the steps); losses {one['losses']} "
          f"grad_norm {one['norms']}; {one['supervised']} supervised rows")
    if not cpu:
        both = sum(max(r["peak_gb"], r.get("peak_before_gb", 0.0)) for r in ranks)
        print(f"[fsdp train] the FSDP ranks' peaks together {both:.2f} GB")
    check(all(r["losses"] == r0["losses"] for r in ranks), "every rank reports the same loss bits")
    check(len(r0["losses"]) == steps and all(
        abs(a - b) <= TRAIN_LOSS_REL * abs(b) for a, b in zip(r0["losses"], one["losses"])),
        f"{geom} FSDP losses {r0['losses']} within {TRAIN_LOSS_REL} (relative) of the "
        f"reference's {one['losses']}")
    check(all(abs(a - b) <= 3 * TRAIN_LOSS_REL * abs(b) for a, b in zip(r0["norms"], one["norms"])),
          f"{geom} FSDP grad_norm {r0['norms']} within {3 * TRAIN_LOSS_REL} of the reference's "
          f"{one['norms']}")
    cos = r0["cos"]
    check(min(cos.values()) >= TRAIN_GRAD_COS and set(cos) == set(GRAD_GROUPS) | {
        "vision", "projector"},
        "the first step's gradients of the FSDP shards vs the reference's, cosine by group "
        f"(>= {TRAIN_GRAD_COS}): " + ", ".join(f"{k} {v:.6f}" for k, v in cos.items()))
    def rel(x, i):
        return abs(x - one["fault_norm"][i]) / one["fault_norm"][i]

    for i, what in enumerate(("grad_norm", "grad_norm of the decoder's leaves")):
        check(rel(r0["fault_norm"][i], i) <= 3 * TRAIN_LOSS_REL,
              f"{what} on the {fault_seq}-token rows, {r0['fault_norm'][i]:.6f}, within "
              f"{3 * TRAIN_LOSS_REL} of the reference's {one['fault_norm'][i]:.6f}")
    print(f"[fsdp train] grad_norm with the norm's dp sum of squares removed: "
          f"{[round(r['fault_norm_unsummed'][0], 6) for r in ranks]}")
    check(all(rel(r["fault_norm_unsummed"][1], 1) > 3 * TRAIN_LOSS_REL for r in ranks),
          "the decoder's grad_norm gate with the norm's dp sum of squares removed (a planted "
          f"fault) must fail: {[round(r['fault_norm_unsummed'][1], 6) for r in ranks]}")
    fault = r0["cos_fault"]
    check(min(fault.values()) < TRAIN_GRAD_COS,
          "the cosine gate with the reduce-scatter replaced by each rank's slice of its own "
          f"gradient (a planted fault; {fault_seq}-token rows) must fail: "
          + ", ".join(f"{k} {v:.6f}" for k, v in fault.items()))
    check(all(r["moved_at_lr0"] == [] for r in ranks + [one]),
          "the warm-up's first step (lr 0) leaves every leaf's bits on every rank "
          "(stage 2 freezes no leaf)")
    whole_shapes = _shard_bytes(shapes, specs, hkv, 0, 1, 0, 1)
    resident = [r["param_bytes"] == r["grad_bytes"] == r["moment_bytes"] // 2
                == _shard_bytes(shapes, specs, hkv, r["coords"][0], 2, r["coords"][1], tp)
                for r in ranks]
    check(all(resident) and one["param_bytes"] == whole_shapes == one["moment_bytes"] // 2,
          "each rank's resident parameters, gradients and Adam moments are its shards' bytes "
          f"exactly ({[round(r['param_bytes'] / 1e9, 3) for r in ranks]} GB of parameters "
          f"against the reference's {one['param_bytes'] / 1e9:.3f})")
    reads = [r["bytes_read"] == one["bytes_read"] - text_b + _shard_bytes(
        shapes, specs, hkv, r["coords"][0], 2, r["coords"][1], tp, text_only=True)
        for r in ranks]
    check(all(reads), "each rank read its pieces of the decoder and the tower and projector "
          f"whole: {[round(r['bytes_read'] / 1e6, 3) for r in ranks]} MB of the reference's "
          f"{one['bytes_read'] / 1e6:.3f}")
    # the launches of the main path on each rank: the decoder's K1 twice a
    # layer a step (remat's recompute), the tower's on every rank (it
    # encodes its rows' tiles, trainable); the backward by JAX's rule at the
    # rank's heads and rows
    tc, vc = cfg.text, cfg.vision
    for r, n_rows in [(r, 1) for r in ranks] + [(one, 2)]:
        hq, _ = r["heads"]
        fused = fa.bwd_uses_fused(n_rows, seq, seq, hq, tc.head_dim, 2)
        vit_fused = fa.bwd_uses_fused(7 * n_rows, vc.seq_len, vc.seq_len, vc.num_attention_heads,
                                      vc.head_dim, 2)
        want = dict.fromkeys(r["counts"], 0)
        want["flash_fwd"] = 2 * (tc.num_hidden_layers + vc.num_hidden_layers) * steps
        for n_layers, uses in ((tc.num_hidden_layers, fused), (vc.num_hidden_layers, vit_fused)):
            if uses:
                want["flash_bwd"] += n_layers * steps
            else:
                want["flash_bwd_dkv"] += n_layers * steps
                want["flash_bwd_dq"] += n_layers * steps
        who = "the reference" if r is one else f"rank {r['rank']}"
        if not cpu:
            check(r["counts"] == want, f"launches of {who}: {r['counts']} (expected {want})")
        else:
            print(f"[fsdp train] launches of {who} (the CPU runs the plain versions): "
                  f"{r['counts']}")
    step = min(r0["step_s"])
    share = [s / t for s, t in zip(r0["staged_s"], r0["step_s"])]
    print(f"[fsdp train] a {geom} FSDP step {step:.3f} s against the reference's "
          f"{min(one['step_s']):.3f} s ({where}); the staged copies' share of a step "
          f"{[round(x, 3) for x in share]}")
    print(f"[fsdp train] phase {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError(f"[fsdp train] {failures}")
    counts = {k: sum(r["counts"][k] for r in ranks) for k in r0["counts"]}
    return {"counts": counts, "err": err}


PP_TRAIN_LAYERS = 4  # the 72B decoder's depth in phase_pp_train (pp 2 x v 2 needs L % 4 == 0)
# rows a step in phase_pp_train, one single-tile image each (4 until the
# 2-D tp geometry joined the run, for its time)
PP_ROWS = 2


def _pp_train_recipe(work, ckpt, sizes, pp, tp, virtual) -> dict:
    """The recipe of phase_pp_train: configs/stage1_72b_tp8pp8.yaml's
    settings (the projector alone trains, both towers frozen; lr 1e-3 after
    30 warm-up steps of 1000, min lr 1e-5; remat; single-tile images) over
    pp x tp with run.virtual_pp ``virtual``, PP_ROWS rows a step (pp
    microbatches), the logit budget cut to sizes["budget"]; pp 1: the
    reference."""
    mesh = {"pp": pp, "tp": tp} if pp * tp > 1 else {}
    return {
        "model": {"checkpoint": ckpt, "dtype": "bfloat16"},
        "data": {"corpus": os.path.join(work, "corpus.yaml"), "seq_len": sizes["seq"],
                 "logit_budget": sizes["budget"], "vision_chunk": 64, "max_patch_grid": 1},
        "mesh": mesh,
        "optim": {"lr": 1.0e-3, "min_lr_ratio": 0.01, "warmup_steps": 30, "total_steps": 1000,
                  "freeze_vision": True, "freeze_text": True},
        "run": {"steps": sizes["steps"], "global_batch": PP_ROWS, "remat": True, "seed": SEED,
                "virtual_pp": virtual},
    }


def _pp_train_worker(rank, world, init, out, sizes):
    """One process of phase_pp_train: ``world`` 1 is the reference (pp off,
    the PP_ROWS rows in one process), else rank ``rank`` of pp 2 x sizes["tp"]
    over gloo with CUDA operands staged through host memory
    (sizes["backend"] "staged"; every rank on card 0), NCCL (a card a rank)
    or plain gloo on the CPU (the rehearsal). For each schedule (GPipe, then
    the interleaved one at virtual_pp 2, in the same processes) it builds
    the Trainer through train.build_from_recipe (a stage reads its layers
    of the checkpoint), takes the planted faults' passes on 4096-token rows
    (the shift's backward sending zeros upstream; under GPipe grad_norm
    without its pp sum of squares, with the decoder's layers trainable so
    that they carry the norm), then trains sizes["steps"] steps through
    Trainer.train, fingerprinting every leaf the stages share after each
    step; after the interleaved run, one more step with the shared leaves'
    gradients summed within a stage only (the third fault). Puts (rank,
    results or the error) on ``out``; the reference writes its gradients to
    the work directory for the stages' cosine gates."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    try:
        from long_vita_tpu_torch.parallel import pipeline as pl
        from long_vita_tpu_torch.parallel.comm import init_process_group
        from long_vita_tpu_torch.training import train as ttrain
        from long_vita_tpu_torch.training import train_step as tts
        from long_vita_tpu_torch.training.loss import collate_packs
        from long_vita_tpu_torch.training.optimizer import global_norm

        cpu = sizes["device"] == "cpu"
        if cpu:
            torch.set_num_threads(1)
        backend = sizes["backend"]
        comm = None
        if world > 1:
            comm = init_process_group(
                rank, world, init, backend="nccl" if backend == "nccl" else "gloo",
                timeout=TP_TRAIN_TIMEOUT, staged_device="cuda" if backend == "staged" else None)
        dev = torch.device("cpu") if cpu else torch.device("cuda", torch.cuda.current_device())
        sync = (lambda: None) if cpu else torch.cuda.synchronize
        stats = getattr(comm, "stats", None)
        res = {"rank": rank, "runs": {}}
        pp, tp = (2, sizes["tp"]) if world > 1 else (1, 1)
        work = sizes["work"]
        for virtual in ((1, 2) if world > 1 else (1,)):
            run = {}
            t0 = time.perf_counter()
            trainer, stream, _ = ttrain.build_from_recipe(
                _pp_train_recipe(work, sizes["ckpt"], sizes, pp, tp, virtual), device=dev,
                comm=comm)
            del stream  # the phase trains on its own packed rows
            sync()
            run["build_s"] = time.perf_counter() - t0
            run["bytes_read"] = trainer.checkpoint_bytes
            cfg, params, mesh = trainer.cfg, trainer.state.params, trainer.mesh
            stage = params.text.pp
            res["coords"] = (mesh.pp_index, mesh.tp_index) if mesh is not None else (0, 0)
            run["layers"] = stage.layers() if stage is not None else list(
                range(cfg.text.num_hidden_layers))
            run["param_bytes"] = sum(p.nbytes for p in params.parameters())
            layout = trainer._layout()
            shared = [n for n, _ in params.named_parameters()
                      if layout is None or not layout[n].staged]
            vc = cfg.vision
            per_tile = int((vc.grid * cfg.vision_downsample_ratio) ** 2)
            tiles = [np.random.default_rng(SEED + 91 + i).standard_normal(
                (1, vc.image_size, vc.image_size, 3)).astype(np.float32)
                for i in range(PP_ROWS)]

            def rows(seq, budget):
                # packed rows, each with a single-tile image (stage 1's data)
                packs = [_train_pack(dataclasses.replace(cfg, image_token_length=per_tile), seq,
                                     [], [(tiles[i], (1, 1))],
                                     np.random.default_rng(SEED + 94 + i), text_segments=4,
                                     answer=sizes["answer"],
                                     text_sup=sizes["text_sup"] * seq // sizes["seq"])
                         for i in range(PP_ROWS)]
                b = collate_packs(packs, budget)
                b["tokens"] = np.minimum(b["tokens"], cfg.text.vocab_size - 1)
                return b

            batch = rows(sizes["seq"], sizes["budget"])
            run["supervised"] = int((batch["labels"] != -100).sum())
            remat, chunk = trainer.tcfg.remat, trainer.tcfg.vision_chunk
            parallel = tts.make_parallel_config(mesh)

            def backward(b, freeze_text=True):
                return tts._backward(params, b, cfg, remat, chunk, True, freeze_text, mesh=mesh,
                                     parallel=parallel)[0]

            # ---- the planted faults' passes, on 4096-token rows (the main
            # path's logit budget: the last stage holds the rows' f32
            # logits and their gradient)
            fault_batch = trainer._device_batch(rows(sizes["fault_seq"], sizes["budget"]))
            proj_path = os.path.join(work, "fault_projector_ref.pt")
            g = backward(fault_batch)
            if world == 1:
                torch.save({n: t.cpu() for n, t in g.items()}, proj_path)
            else:
                run["cos_fault_sound"] = _group_cosines(g, proj_path, layout, mesh.tp_comm, dev)
                pl._SHIFT_BACKWARD_DROPPED = True
                try:
                    g = backward(fault_batch)
                finally:
                    pl._SHIFT_BACKWARD_DROPPED = False
                run["cos_fault"] = _group_cosines(g, proj_path, layout, mesh.tp_comm, dev)
            del g
            if virtual == 1:
                # the decoder's layers trainable: they carry the norm's squares
                g = backward(fault_batch, freeze_text=False)
                layers_g = {n: t for n, t in g.items() if ".layers." in n}
                if world == 1:
                    res["fault_norm"] = [float(global_norm(x.values())) for x in (g, layers_g)]
                else:
                    red = tts._Reduction(params, cfg, mesh)
                    res["fault_norm"] = [float(red.norm(x)) for x in (g, layers_g)]
                    tts._NORM_UNSUMMED_OVER_PP = True
                    try:
                        res["fault_norm_unsummed"] = [float(red.norm(x)) for x in (g, layers_g)]
                    finally:
                        tts._NORM_UNSUMMED_OVER_PP = False
                del g, layers_g
            for p in params.parameters():  # back to stage 1's freezes
                p.grad = None
            gc.collect()
            if not cpu:
                torch.cuda.empty_cache()

            # ---- the main path: Trainer.train, the steps on the rows
            first = {}
            step_backward = tts._backward

            def keep_first(*a, **k):
                out_ = step_backward(*a, **k)
                if "grads" not in first:
                    first["grads"] = {n: t.to("cpu") for n, t in out_[0].items()}
                return out_

            tts._backward = keep_first
            before = {n: _fingerprint(p) for n, p in params.named_parameters()}
            step_fn, kept, norms_log, prints = trainer.step_fn, [], [], []

            def logged(state, b):
                state, m = step_fn(state, b)
                norms_log.append(float(m["grad_norm"]))
                named = dict(state.params.named_parameters())
                prints.append([_fingerprint(named[n]) for n in shared])
                if not kept:  # the warm-up's first step runs at lr 0
                    kept.append(sorted(n for n, p in named.items()
                                       if _fingerprint(p) != before[n]))
                return state, m

            trainer.step_fn = logged
            stamps, staged, moved = [], [], []

            def batches():
                for _ in range(sizes["steps"]):
                    sync()
                    stamps.append(time.perf_counter())
                    staged.append(stats["seconds"] if stats else 0.0)
                    moved.append(stats["bytes"] if stats else 0)
                    yield batch

            _reset_counts()
            if stage is not None:
                stage.reset_stats()
            if not cpu:
                run["peak_before_gb"] = torch.cuda.max_memory_allocated() / 1e9
                torch.cuda.reset_peak_memory_stats()
            try:
                run["losses"] = trainer.train(batches())["losses"]
            finally:
                tts._backward = step_backward
            sync()
            stamps.append(time.perf_counter())
            staged.append(stats["seconds"] if stats else 0.0)
            moved.append(stats["bytes"] if stats else 0)
            run["peak_gb"] = 0.0 if cpu else torch.cuda.max_memory_allocated() / 1e9
            run["counts"] = _read_counts()
            run["stage_stats"] = dict(stage.stats) if stage is not None else None
            run["norms"] = list(norms_log)
            run["prints"] = list(prints)
            run["moved_at_lr0"] = kept[0] if kept else None
            run["moved"] = sorted(n for n, p in params.named_parameters()
                                  if _fingerprint(p) != before[n])
            run["step_s"] = [b - a for a, b in zip(stamps, stamps[1:])]
            run["staged_s"] = [b - a for a, b in zip(staged, staged[1:])]
            run["staged_gb"] = [(b - a) / 1e9 for a, b in zip(moved, moved[1:])]
            grads = first.pop("grads")
            path = os.path.join(work, "grads_ref.pt")
            if world == 1:
                torch.save(grads, path)
            else:
                run["cos"] = _group_cosines(grads, path, layout, mesh.tp_comm, dev)
            del grads
            if world > 1 and virtual == 2:
                # the third fault: the shared leaves summed within a stage only
                tts._UNSUMMED_OVER_PP = True
                try:
                    trainer.step_fn(trainer.state, fault_batch)
                finally:
                    tts._UNSUMMED_OVER_PP = False
                res["prints_unsummed"] = prints[-1]
            res["runs"][virtual] = run
            trainer.step_fn = step_fn
            del trainer, params, fault_batch
            gc.collect()
            if not cpu:
                torch.cuda.empty_cache()
        out.put((rank, res))
        if comm is not None:
            comm.barrier()
            torch.distributed.destroy_process_group()
    except Exception as e:  # noqa: BLE001 (reported to the parent)
        import traceback

        out.put((rank, f"raised {type(e).__name__}: {e}\n{traceback.format_exc()[-2500:]}"))


def phase_pp_train(*, backend="staged", device="cuda", cfg=None, layers=PP_TRAIN_LAYERS, tp=1,
                   seq=16384, budget=2048, fault_seq=4096, steps=2, answer=300, text_sup=430,
                   first_special=QWEN25_FIRST_ADDED, kernels=True) -> dict:
    """Pipeline stages from the recipe entry: the 72B VLM (long_vita_72b(): h
    8192, ffn 29568, 64/8 heads, vocab 152064) at full width, the decoder
    cut to ``layers`` layers, the InternViT-300M tower at 24, written as a
    *_HF checkpoint directory; configs/stage1_72b_tp8pp8.yaml's settings
    (the projector alone trains, remat, single-tile images) at ``seq``
    tokens, the logit budget cut to ``budget`` a row; PP_ROWS rows a step,
    each with a single-tile image. First the reference (pp off, the rows
    in one process), then pp 2 x ``tp`` (backend "staged": two gloo
    processes sharing this card with host-staged collectives; "nccl": a
    card a rank, from phase_cp_nccl; "gloo" with device "cpu": the
    rehearsal), GPipe and then the interleaved schedule (virtual_pp 2) in
    the same processes, each stage reading its layers. Gates, for each
    schedule: each step's loss within TRAIN_LOSS_REL of the reference's and
    grad_norm within 3x that; every rank the same loss bits; the first
    step's projector gradient against the reference's at cosine >=
    TRAIN_GRAD_COS; after every step, every leaf the stages share the same
    bits on every rank; the warm-up's lr-0 step leaving every bit, and
    nothing but the projector moving; each rank's resident parameters and
    the bytes it read its stage's share exactly; K1, K3, K4 and K5
    launches exact. Three planted faults must fail: the shift's backward
    sending zeros upstream (the projector's cosine, on 4096-token rows,
    both schedules), grad_norm without its pp sum of squares (against the
    reference's norm of the 4096-token rows with the decoder's layers
    trainable), and the shared leaves' gradients summed within a stage
    only (the same-bits gate, a step after the interleaved run). kernels:
    first K1, K4 and K5 at a stage's heads on T2's packed row. -> {"counts":
    every pp rank's launches over both schedules, "err": the kernels'
    largest error}."""
    import dataclasses

    import numpy as np
    import torch

    from long_vita_tpu_torch.config import long_vita_72b
    from long_vita_tpu_torch.models import qwen2
    from long_vita_tpu_torch.ops import flash_attention as fa
    from long_vita_tpu_torch.parallel import pipeline as pl
    from long_vita_tpu_torch.parallel.sharding import long_vita_param_specs
    from long_vita_tpu_torch.utils.export_hf import save_hf_checkpoint

    t_phase = time.perf_counter()
    cpu = device == "cpu"
    dev = torch.device(device)
    base = cfg or long_vita_72b()
    heads = (base.text.num_attention_heads // tp, max(base.text.num_key_value_heads // tp, 1))
    err = phase_tp_train_kernels(heads=heads, dev=dev, label="a 72B pp stage",
                                 tag="pp train kernels") if kernels else 0.0
    cfg = dataclasses.replace(base, text=dataclasses.replace(base.text, num_hidden_layers=layers))
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_pp_train_", dir=build)
    try:
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(SEED + 92)
        rng = np.random.default_rng(SEED + 93)
        probe = rng.standard_normal((2, cfg.vision.image_size, cfg.vision.image_size, 3),
                                    dtype=np.float32)
        lv, _ = _vlm_params(qwen2.init_qwen2_params(gen, cfg.text, torch.bfloat16, dev), cfg,
                            dev, SEED + 92, probe)
        ckpt = os.path.join(work, "ckpt")
        save_hf_checkpoint(lv, cfg, ckpt)
        tokenizer_dir(ckpt, first_special)
        shapes = {n: (tuple(p.shape), p.dtype) for n, p in lv.named_parameters()}
        specs = long_vita_param_specs(lv)
        whole_b = sum(p.nbytes for p in lv.parameters())
        layer_b = [sum(p.nbytes for p in layer.parameters()) for layer in lv.text.layers]
        del lv
        if not cpu:
            torch.cuda.empty_cache()
        with open(os.path.join(work, "corpus.yaml"), "w") as f:  # the recipe names one
            json.dump({"dataset": {"chat": {"ratio": 1, "data_paths": [
                os.path.join(work, "chat.jsonl")]}}}, f)
        with open(os.path.join(work, "chat.jsonl"), "w") as f:
            f.write(json.dumps({"messages": [{"role": "user", "content": "hi"},
                                             {"role": "assistant", "content": "hello"}]}))
        tc = cfg.text
        print(f"[pp train] the VLM at full width (h {tc.hidden_size}, ffn "
              f"{tc.intermediate_size}, {tc.num_attention_heads}/{tc.num_key_value_heads} heads, "
              f"vocab {tc.vocab_size}; {layers} decoder layers of {layer_b[0] / 1e9:.3f} GB; "
              f"{whole_b / 1e9:.3f} GB) written as a checkpoint directory in "
              f"{time.perf_counter() - t0:.1f} s")
        sizes = dict(device=device, backend=backend, work=work, ckpt=ckpt, seq=seq, tp=tp,
                     budget=budget, fault_seq=fault_seq, steps=steps, answer=answer,
                     text_sup=text_sup)
        t0 = time.perf_counter()
        one = _reference(_pp_train_worker, {**sizes, "backend": "gloo"},
                         2 * TP_TRAIN_TIMEOUT)
        t1 = time.perf_counter()
        world = 2 * tp
        ranks = [r for _, r in sorted(_spawn(_pp_train_worker, world, sizes,
                                             4 * TP_TRAIN_TIMEOUT).items())]
        print(f"[pp train] the reference {t1 - t0:.1f} s, the {world} pp processes "
              f"{time.perf_counter() - t1:.1f} s (start-up, loading twice, the faults' passes, "
              "the steps of both schedules)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    failures = []

    def check(good: bool, what: str) -> None:
        print(f"[pp train] {what}: {'ok' if good else 'FAIL'}")
        if not good:
            failures.append(what)

    where = {"staged": STAGED_NOTE, "nccl": f"{world} cards over NCCL",
             "gloo": f"{world} gloo processes on the CPU"}[backend]
    geom = f"pp 2 x tp {tp}" if tp > 1 else "pp 2"
    ref = one["runs"][1]
    hkv = cfg.text.num_key_value_heads
    m = 2  # microbatches: pp (JAX's default, ParallelConfig.microbatches 0)
    print(f"[pp train] the reference (pp off, one process, the {PP_ROWS} rows): read "
          f"{ref['bytes_read'] / 1e6:.3f} MB; holds {ref['param_bytes'] / 1e9:.3f} GB of "
          f"parameters; steps {[round(t, 3) for t in ref['step_s']]} s; peak allocated "
          f"{ref['peak_gb']:.2f} GB ({ref.get('peak_before_gb', 0.0):.2f} GB before the steps); "
          f"losses {ref['losses']} grad_norm {ref['norms']}; {ref['supervised']} supervised rows")
    counts = None
    for virtual, name in ((1, "GPipe"), (2, "interleaved (virtual_pp 2)")):
        runs = [r["runs"][virtual] for r in ranks]
        r0 = runs[0]
        for r, run in zip(ranks, runs):
            st = run["stage_stats"]
            print(f"[pp train] {name}, rank (pp {r['coords'][0]}, tp {r['coords'][1]}) of {geom}: "
                  f"layers {run['layers']}; built through train.build_from_recipe in "
                  f"{run['build_s']:.1f} s, read {run['bytes_read'] / 1e6:.3f} MB of the "
                  f"checkpoint's {whole_b / 1e6:.3f} MB; holds {run['param_bytes'] / 1e9:.3f} GB "
                  f"of parameters; steps {[round(t, 3) for t in run['step_s']]} s ({where}), "
                  f"staged copies {[round(t, 3) for t in run['staged_s']]} s of them, "
                  f"{[round(b, 3) for b in run['staged_gb']]} GB staged a step; the schedule: "
                  f"{st['ticks'] // steps} ticks a step, {st['busy'] // steps} busy (bubble "
                  f"share {1 - st['busy'] / max(st['ticks'], 1):.3f}, "
                  f"{pl.bubble_share(m, 2, virtual):.3f} by the formula), shifts "
                  f"{st['sent_bytes'] / steps / 1e9:.3f} GB sent and "
                  f"{st['received_bytes'] / steps / 1e9:.3f} GB received a step; peak allocated "
                  f"{run['peak_gb']:.2f} GB in the steps ({run.get('peak_before_gb', 0.0):.2f} GB "
                  f"before them); losses {run['losses']} grad_norm {run['norms']}")
        if not cpu:
            both = sum(max(x["peak_gb"], x.get("peak_before_gb", 0.0)) for x in runs)
            print(f"[pp train] {name}: the pp ranks' peaks together {both:.2f} GB")
        check(all(x["losses"] == r0["losses"] and x["norms"] == r0["norms"] for x in runs),
              f"{name}: every rank reports the same loss and grad_norm bits")
        check(len(r0["losses"]) == steps and all(
            abs(a - b) <= TRAIN_LOSS_REL * abs(b) for a, b in zip(r0["losses"], ref["losses"])),
            f"{name} {geom} losses {r0['losses']} within {TRAIN_LOSS_REL} (relative) of the "
            f"reference's {ref['losses']}")
        check(all(abs(a - b) <= 3 * TRAIN_LOSS_REL * abs(b)
                  for a, b in zip(r0["norms"], ref["norms"])),
              f"{name} {geom} grad_norm {r0['norms']} within {3 * TRAIN_LOSS_REL} of the "
              f"reference's {ref['norms']}")
        cos = r0["cos"]
        check(set(cos) == {"projector"} and cos["projector"] >= TRAIN_GRAD_COS,
              f"{name}: the first step's projector gradient vs the reference's, cosine "
              f"(>= {TRAIN_GRAD_COS}): {cos}")
        check(all(x["prints"] == y["prints"] for (r, x), (q, y) in
                  itertools.product(zip(ranks, runs), repeat=2)
                  if r["coords"][1] == q["coords"][1]) and len(r0["prints"]) == steps,
              f"{name}: after every step every leaf the stages share (the embedding, the head, "
              f"final_norm, the tower, the projector) holds the same bits on every stage (of a "
              f"tp index: its tp slice)")
        check(all(x["moved_at_lr0"] == [] for x in runs + [ref]),
              f"{name}: the warm-up's first step (lr 0) leaves every leaf's bits on every rank")
        check(all(x["moved"] and all(n.startswith("projector.") for n in x["moved"])
                  for x in runs + [ref]),
              f"{name}: after the steps the projector alone moved, every frozen leaf keeps its "
              f"bits ({len(r0['moved'])} projector leaves moved)")
        check(all(x["cos_fault_sound"]["projector"] >= TRAIN_GRAD_COS for x in runs),
              f"{name}: the projector gradient on the {fault_seq}-token rows vs the "
              f"reference's: {[round(x['cos_fault_sound']['projector'], 6) for x in runs]}")
        check(all(x["cos_fault"].get("projector", 0.0) < TRAIN_GRAD_COS for x in runs),
              f"{name}: the cosine gate with the shift's backward sending zeros upstream (a "
              f"planted fault; {fault_seq}-token rows) must fail: "
              f"{[round(x['cos_fault'].get('projector', 0.0), 6) for x in runs]}")
        # resident bytes and the bytes read: the stage's layers (its tp
        # slices) plus every leaf the stages share, whole
        for r, run in zip(ranks, runs):
            t = r["coords"][1]
            mine = sum(_shard_bytes({n: s for n, s in shapes.items()
                                     if n.startswith(f"text.layers.{g}.")}, specs, hkv, 0, 1,
                                    t, tp)
                       for g in run["layers"])
            rest = _shard_bytes({n: s for n, s in shapes.items()
                                 if not n.startswith("text.layers.")}, specs, hkv, 0, 1, t, tp)
            # the loader reads the tower's tensors in the files' layout (the
            # reference's read against its resident bytes gives the difference)
            check(run["param_bytes"] == mine + rest
                  and run["bytes_read"] == ref["bytes_read"] - whole_b + mine + rest,
                  f"{name}: rank (pp {r['coords'][0]}, tp {t}) holds and read its stage's share "
                  f"exactly: {run['param_bytes'] / 1e9:.3f} GB held, "
                  f"{run['bytes_read'] / 1e6:.3f} MB read; its {len(run['layers'])} layers "
                  f"{mine / 1e9:.3f} GB, the shared leaves {rest / 1e9:.3f} GB (the reference "
                  f"{ref['param_bytes'] / 1e9:.3f} GB)")
        # the launches: the decoder's K1 twice a layer a microbatch a step
        # (remat's recompute) on each stage, K4 or K5 once; the frozen
        # tower's K3 a layer a step on the first stage alone
        tc, vc = cfg.text, cfg.vision
        for r, run in zip(ranks, runs):
            p_idx = r["coords"][0]
            hq = tc.num_attention_heads // tp
            n_layers = len(run["layers"])
            fused = fa.bwd_uses_fused(PP_ROWS // m, seq, seq, hq, tc.head_dim, 2)
            want = dict.fromkeys(run["counts"], 0)
            want["flash_fwd"] = 2 * n_layers * m * steps
            if fused:
                want["flash_bwd"] = n_layers * m * steps
            else:
                want["flash_bwd_dkv"] = want["flash_bwd_dq"] = n_layers * m * steps
            if p_idx == 0:
                want["short_attn"] = vc.num_hidden_layers * steps
            if not cpu:
                check(run["counts"] == want, f"{name}: launches of rank {r['rank']}: "
                      f"{run['counts']} (expected {want})")
            else:
                print(f"[pp train] {name}: launches of rank {r['rank']} (the CPU runs the plain "
                      f"versions): {run['counts']}")
        step = min(r0["step_s"])
        share = [s / t for s, t in zip(r0["staged_s"], r0["step_s"])]
        print(f"[pp train] a {geom} {name} step {step:.3f} s against the reference's "
              f"{min(ref['step_s']):.3f} s ({where}); the staged copies' share of a step "
              f"{[round(x, 3) for x in share]}")
        c = {k: sum(run["counts"][k] for run in runs) for k in r0["counts"]}
        counts = c if counts is None else {k: counts[k] + c[k] for k in c}
    # the reference's launches: every layer on the rows at once
    tc, vc = cfg.text, cfg.vision
    fused = fa.bwd_uses_fused(PP_ROWS, seq, seq, tc.num_attention_heads, tc.head_dim, 2)
    want = dict.fromkeys(ref["counts"], 0)
    want["flash_fwd"] = 2 * tc.num_hidden_layers * steps
    want["short_attn"] = vc.num_hidden_layers * steps
    for k in (["flash_bwd"] if fused else ["flash_bwd_dkv", "flash_bwd_dq"]):
        want[k] = tc.num_hidden_layers * steps
    if not cpu:
        check(ref["counts"] == want, f"launches of the reference: {ref['counts']} (expected "
              f"{want})")
    # the norm's pp sum of squares (GPipe, the decoder's layers trainable),
    # read on every rank: without the sum each stage sees its own layers,
    # and the first layers' gradients can hold nearly all the squares
    # (the first stage then reads close to the whole), so the gate holds
    # every rank's reading

    def rel(x, i):
        return abs(x - one["fault_norm"][i]) / one["fault_norm"][i]

    for i, what in enumerate(("grad_norm", "grad_norm of the decoder's layers")):
        check(all(rel(r["fault_norm"][i], i) <= 3 * TRAIN_LOSS_REL for r in ranks),
              f"{what} on the {fault_seq}-token rows with the layers trainable, every rank's "
              f"{[round(r['fault_norm'][i], 6) for r in ranks]}, within {3 * TRAIN_LOSS_REL} of "
              f"the reference's {one['fault_norm'][i]:.6f}")
    print(f"[pp train] grad_norm with the norm's pp sum of squares removed: "
          f"{[round(r['fault_norm_unsummed'][0], 6) for r in ranks]}")
    check(any(rel(r["fault_norm_unsummed"][1], 1) > 3 * TRAIN_LOSS_REL for r in ranks),
          "the decoder's grad_norm gate with the norm's pp sum of squares removed (a planted "
          f"fault) must fail: {[round(r['fault_norm_unsummed'][1], 6) for r in ranks]}")
    check(any(r["prints_unsummed"] != q["prints_unsummed"]
              for r, q in itertools.product(ranks, repeat=2) if r["coords"][1] == q["coords"][1]),
          "the same-bits gate after a step with the shared leaves' gradients summed within a "
          "stage only (a planted fault) must fail")
    print(f"[pp train] phase {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError(f"[pp train] {failures}")
    return {"counts": counts, "err": err}


# ---- FSDP inside pipeline stages (phase_pp_fsdp_train) ----------------------------

# rows a step in phase_pp_fsdp_train, one single-tile image each: dp 2 x M 2
# microbatches of one row
PP_FSDP_ROWS = 4


def _pp_fsdp_train_recipe(work, ckpt, sizes, mesh: bool, virtual) -> dict:
    """The recipe of phase_pp_fsdp_train: configs/stage2_72b_tp8fsdp8.yaml's
    settings (lr 1e-5 after 210 warm-up steps of 7000, min lr 1e-7, the
    decoder trainable, remat, FSDP) over dp 2 x pp 2 with run.virtual_pp
    ``virtual``, PP_FSDP_ROWS rows a step, the logit budget cut to
    sizes["budget"] a row; to fit four processes on one card the embedding
    and the head are mask-frozen (freeze_embed: their gradients still count
    in grad_norm) and the tower frozen (freeze_vision, stage 1's); mesh
    False: the reference, without pp or FSDP."""
    return {
        "model": {"checkpoint": ckpt, "dtype": "bfloat16"},
        "data": {"corpus": os.path.join(work, "corpus.yaml"), "seq_len": sizes["seq"],
                 "logit_budget": sizes["budget"], "vision_chunk": 64, "max_patch_grid": 1},
        "mesh": {"dp": 2, "pp": 2} if mesh else {},
        "optim": {"lr": 1.0e-5, "min_lr_ratio": 0.01, "warmup_steps": 210, "total_steps": 7000,
                  "vit_lr_mult": 0.1, "vit_layer_decay": 0.9, "freeze_embed": True,
                  "freeze_vision": True},
        "run": {"steps": sizes["steps"], "global_batch": PP_FSDP_ROWS, "remat": True,
                "seed": SEED, "virtual_pp": virtual, "fsdp": mesh},
    }


def _pp_fsdp_train_worker(rank, world, init, out, sizes):
    """One process of phase_pp_fsdp_train: ``world`` 1 is the reference (pp
    and FSDP off, the PP_FSDP_ROWS rows in one process), else rank
    ``rank`` of dp 2 x pp 2 with FSDP over gloo with CUDA operands staged
    through host memory (sizes["backend"] "staged"; every rank on card 0),
    NCCL (a card a rank) or plain gloo on the CPU (the rehearsal). For each
    schedule (GPipe, then the interleaved one at virtual_pp 2, in the same
    processes) it builds the Trainer through train.build_from_recipe (a
    rank reads its stage's layers, and of them its dp pieces); under GPipe
    it first takes the reduce-scatter fault's pass (the rank's own slice
    kept) on the rows, then trains sizes["steps"] steps through
    Trainer.train, fingerprinting every leaf the stages share after each
    step, and reads grad_norm of the decoder's layers on the first step's
    gradients with and without its dp sum. Puts (rank, results or the error) on
    ``out``; the reference writes its gradients to the work directory for
    the ranks' cosine gates."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    try:
        from long_vita_tpu_torch.parallel import fsdp as fsdp_mod
        from long_vita_tpu_torch.parallel.comm import init_process_group
        from long_vita_tpu_torch.training import train as ttrain
        from long_vita_tpu_torch.training import train_step as tts
        from long_vita_tpu_torch.training.loss import collate_packs
        from long_vita_tpu_torch.training.optimizer import global_norm

        cpu = sizes["device"] == "cpu"
        if cpu:
            torch.set_num_threads(1)
        backend = sizes["backend"]
        comm = None
        if world > 1:
            comm = init_process_group(
                rank, world, init, backend="nccl" if backend == "nccl" else "gloo",
                timeout=TP_TRAIN_TIMEOUT, staged_device="cuda" if backend == "staged" else None)
        dev = torch.device("cpu") if cpu else torch.device("cuda", torch.cuda.current_device())
        sync = (lambda: None) if cpu else torch.cuda.synchronize
        stats = getattr(comm, "stats", None)
        res = {"rank": rank, "runs": {}}
        work = sizes["work"]
        for virtual in ((1, 2) if world > 1 else (1,)):
            run = {}
            t0 = time.perf_counter()
            trainer, stream, _ = ttrain.build_from_recipe(
                _pp_fsdp_train_recipe(work, sizes["ckpt"], sizes, world > 1, virtual),
                device=dev, comm=comm)
            del stream  # the phase trains on its own packed rows
            sync()
            run["build_s"] = time.perf_counter() - t0
            run["bytes_read"] = trainer.checkpoint_bytes
            cfg, params, mesh = trainer.cfg, trainer.state.params, trainer.mesh
            stage, fs = params.text.pp, params.text.fsdp
            res["coords"] = (mesh.dp_index, mesh.pp_index) if mesh is not None else (0, 0)
            run["layers"] = stage.layers() if stage is not None else list(
                range(cfg.text.num_hidden_layers))
            run["param_bytes"] = sum(p.nbytes for p in params.parameters())
            opt = trainer.state.opt_state
            run["moment_bytes"] = sum(t.nbytes for t in list(opt.mu.values())
                                      + list(opt.nu.values()))
            layout = trainer._layout()
            shared = [n for n, _ in params.named_parameters()
                      if layout is None or not layout[n].staged]
            run["shared_fsdp"] = [n for n in shared if layout is not None and layout[n].fsdp]
            vc = cfg.vision
            per_tile = int((vc.grid * cfg.vision_downsample_ratio) ** 2)
            tiles = [np.random.default_rng(SEED + 121 + i).standard_normal(
                (1, vc.image_size, vc.image_size, 3)).astype(np.float32)
                for i in range(PP_FSDP_ROWS)]

            def rows(seq, budget):
                # packed rows, each with a single-tile image; a dp rank keeps its own
                packs = [_train_pack(dataclasses.replace(cfg, image_token_length=per_tile), seq,
                                     [], [(tiles[i], (1, 1))],
                                     np.random.default_rng(SEED + 125 + i), text_segments=4,
                                     answer=sizes["answer"],
                                     text_sup=sizes["text_sup"] * seq // sizes["seq"])
                         for i in range(PP_FSDP_ROWS)]
                b = collate_packs(packs, budget)
                b["tokens"] = np.minimum(b["tokens"], cfg.text.vocab_size - 1)
                return b

            batch = rows(sizes["seq"], sizes["budget"])
            run["supervised"] = int((batch["labels"] != -100).sum())
            flags = (trainer.tcfg.remat, trainer.tcfg.vision_chunk,
                     trainer.freeze["freeze_vision"], trainer.freeze["freeze_text"])
            parallel = tts.make_parallel_config(mesh)

            def backward(b):
                return tts._backward(params, b, cfg, *flags, mesh=mesh, parallel=parallel)[0]

            cos_kw = {} if mesh is None else dict(dp_comm=mesh.dp_comm, pp_comm=mesh.pp_comm)
            path = os.path.join(work, "grads_ref.pt")  # the reference's first-step gradients
            if virtual == 1 and world > 1:
                # ---- the reduce-scatter fault's pass, before the steps, on the
                # main path's rows: its gradients against the reference's first
                # step's (the sound counterpart is the first step's own gate)
                fsdp_mod._LOCAL_SLICE_NOT_SCATTERED = True
                try:
                    g = backward(trainer._device_batch(batch))
                finally:
                    fsdp_mod._LOCAL_SLICE_NOT_SCATTERED = False
                res["cos_fault"] = _group_cosines(g, path, layout, mesh.tp_comm, dev, **cos_kw)
                del g
                for p in params.parameters():
                    p.grad = None
                gc.collect()
                if not cpu:
                    torch.cuda.empty_cache()

            # ---- the main path: Trainer.train, the steps on the rows; the
            # first step's gradients kept on the host for the gradient gate
            first = {}
            step_backward = tts._backward

            def keep_first(*a, **k):
                out_ = step_backward(*a, **k)
                if "grads" not in first:
                    first["grads"] = {n: t.to("cpu") for n, t in out_[0].items()}
                return out_

            tts._backward = keep_first
            before = {n: _fingerprint(p) for n, p in params.named_parameters()}
            step_fn, kept, norms_log, prints = trainer.step_fn, [], [], []

            def logged(state, b):
                state, m = step_fn(state, b)
                norms_log.append(float(m["grad_norm"]))
                named = dict(state.params.named_parameters())
                prints.append({n: _fingerprint(named[n]) for n in shared})
                if not kept:  # the warm-up's first step runs at lr 0
                    kept.append(sorted(n for n, p in named.items()
                                       if _fingerprint(p) != before[n]))
                return state, m

            trainer.step_fn = logged
            stamps, staged, moved = [], [], []

            def batches():
                for _ in range(sizes["steps"]):
                    sync()
                    stamps.append(time.perf_counter())
                    staged.append(stats["seconds"] if stats else 0.0)
                    moved.append(stats["bytes"] if stats else 0)
                    yield batch

            _reset_counts()
            if fs is not None:
                fs.reset_stats()
            if not cpu:
                run["peak_before_gb"] = torch.cuda.max_memory_allocated() / 1e9
                torch.cuda.reset_peak_memory_stats()
            try:
                run["losses"] = trainer.train(batches())["losses"]
            finally:
                tts._backward = step_backward
            sync()
            stamps.append(time.perf_counter())
            staged.append(stats["seconds"] if stats else 0.0)
            moved.append(stats["bytes"] if stats else 0)
            run["peak_gb"] = 0.0 if cpu else torch.cuda.max_memory_allocated() / 1e9
            run["counts"] = _read_counts()
            run["fsdp_stats"] = dict(fs.stats) if fs is not None else None
            run["norms"] = list(norms_log)
            run["prints"] = list(prints)
            run["moved_at_lr0"] = kept[0] if kept else None
            run["step_s"] = [b - a for a, b in zip(stamps, stamps[1:])]
            run["staged_s"] = [b - a for a, b in zip(staged, staged[1:])]
            run["staged_gb"] = [(b - a) / 1e9 for a, b in zip(moved, moved[1:])]
            grads = first.pop("grads")
            run["grad_bytes"] = sum(t.nbytes for t in grads.values())
            # grad_norm of the decoder's layers, and (the planted fault) without
            # its dp sum of squares: the first step's gradients, read on every rank
            # on the card: an f32 sum of squares on the host over a whole
            # layer's 242 M elements loses low bits (0.5% of this norm)
            layers_g = {n: t.to(dev) for n, t in grads.items() if ".layers." in n}
            if world == 1:
                torch.save(grads, path)
                run["layers_norm"] = float(global_norm(layers_g.values()))
            else:
                run["cos"] = _group_cosines(grads, path, layout, mesh.tp_comm, dev, **cos_kw)
                red = tts._Reduction(params, cfg, mesh)
                run["layers_norm"] = float(red.norm(layers_g))
                tts._NORM_UNSUMMED_OVER_DP = True
                try:
                    run["layers_norm_unsummed"] = float(red.norm(layers_g))
                finally:
                    tts._NORM_UNSUMMED_OVER_DP = False
            del grads, layers_g
            res["runs"][virtual] = run
            trainer.step_fn = step_fn
            del trainer, params, opt
            gc.collect()
            if not cpu:
                torch.cuda.empty_cache()
        out.put((rank, res))
        if comm is not None:
            comm.barrier()
            torch.distributed.destroy_process_group()
    except Exception as e:  # noqa: BLE001 (reported to the parent)
        import traceback

        mem = "" if sizes["device"] == "cpu" else (
            f" (this process: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB)")
        out.put((rank, f"raised {type(e).__name__}{mem}: {e}\n"
                       f"{traceback.format_exc()[-2500:]}"))


def phase_pp_fsdp_train(*, backend="staged", device="cuda", cfg=None, layers=PP_TRAIN_LAYERS,
                        seq=4096, budget=512, steps=MESH_TRAIN_STEPS, answer=100,
                        text_sup=100, first_special=QWEN25_FIRST_ADDED) -> dict:
    """FSDP inside pipeline stages from the recipe entry: the 72B VLM
    (long_vita_72b(): h 8192, ffn 29568, 64/8 heads, vocab 152064) at full
    width, the decoder cut to ``layers`` layers (two a stage), the
    InternViT-300M tower at 24, written as a *_HF checkpoint directory;
    configs/stage2_72b_tp8fsdp8.yaml's settings (the decoder trains, so
    that the reduce-scatter carries its gradients; remat) at ``seq``
    tokens, the logit budget cut to ``budget`` a row; PP_FSDP_ROWS rows a
    step, each with a single-tile image. First the reference (pp and FSDP
    off, the rows in one process), then dp 2 x pp 2 with run.fsdp (backend
    "staged": four gloo processes sharing this card with host-staged
    collectives; "nccl": a card a rank, from phase_cp_nccl; "gloo" with
    device "cpu": the rehearsal), GPipe and then the interleaved schedule
    (virtual_pp 2) in the same processes, each rank reading its stage's
    layers and of them its dp pieces. Gates, for each schedule: each step's
    loss within TRAIN_LOSS_REL of the reference's and grad_norm within 3x
    that; every rank the same loss and grad_norm bits; the first step's
    decoder gradients (by group) and the projector's against the
    reference's at cosine >= TRAIN_GRAD_COS; after every step every leaf
    the stages share the same bits on every rank that holds it; the
    warm-up's lr-0 step leaving every bit; each rank's resident parameters
    and the bytes it read its stage's 1/dp share exactly; Fsdp.stats'
    gathers, regathers and scatters parallel/fsdp.step_counts' of its stage
    exactly, at most one unit of whole weights alive; K1, K3, K4 and K5
    launches exact. Two planted faults (GPipe, the same rows) must fail:
    the reduce-scatter replaced by each rank's own slice (a backward pass
    before the steps, under the cosine gate of the decoder's groups) and
    grad_norm of the decoder's layers without its dp sum of squares (the
    first step's gradients, every rank's reading, against the
    reference's, which the sound norm meets).
    -> {"counts": every rank's launches over both schedules, "gathered_gb":
    the bytes a rank gathers a step, "step_s": {schedule: a step's time}}."""
    import dataclasses

    import numpy as np
    import torch

    from long_vita_tpu_torch.config import long_vita_72b
    from long_vita_tpu_torch.models import qwen2
    from long_vita_tpu_torch.ops import flash_attention as fa
    from long_vita_tpu_torch.parallel import fsdp as fsdp_mod
    from long_vita_tpu_torch.parallel.sharding import long_vita_param_specs
    from long_vita_tpu_torch.utils.export_hf import save_hf_checkpoint

    t_phase = time.perf_counter()
    cpu = device == "cpu"
    dev = torch.device(device)
    base = cfg or long_vita_72b()
    cfg = dataclasses.replace(base, text=dataclasses.replace(base.text, num_hidden_layers=layers))
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_pp_fsdp_train_", dir=build)
    try:
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(SEED + 122)
        rng = np.random.default_rng(SEED + 123)
        probe = rng.standard_normal((2, cfg.vision.image_size, cfg.vision.image_size, 3),
                                    dtype=np.float32)
        lv, _ = _vlm_params(qwen2.init_qwen2_params(gen, cfg.text, torch.bfloat16, dev), cfg,
                            dev, SEED + 122, probe)
        ckpt = os.path.join(work, "ckpt")
        save_hf_checkpoint(lv, cfg, ckpt)
        tokenizer_dir(ckpt, first_special)
        shapes = {n: (tuple(p.shape), p.dtype) for n, p in lv.named_parameters()}
        specs = long_vita_param_specs(lv)
        whole_b = sum(p.nbytes for p in lv.parameters())
        layer_b = sum(p.nbytes for p in lv.text.layers[0].parameters())
        del lv
        if not cpu:
            torch.cuda.empty_cache()
        with open(os.path.join(work, "corpus.yaml"), "w") as f:  # the recipe names one
            json.dump({"dataset": {"chat": {"ratio": 1, "data_paths": [
                os.path.join(work, "chat.jsonl")]}}}, f)
        with open(os.path.join(work, "chat.jsonl"), "w") as f:
            f.write(json.dumps({"messages": [{"role": "user", "content": "hi"},
                                             {"role": "assistant", "content": "hello"}]}))
        tc = cfg.text
        print(f"[pp fsdp train] the VLM at full width (h {tc.hidden_size}, ffn "
              f"{tc.intermediate_size}, {tc.num_attention_heads}/{tc.num_key_value_heads} heads, "
              f"vocab {tc.vocab_size}; {layers} decoder layers of {layer_b / 1e9:.3f} GB; "
              f"{whole_b / 1e9:.3f} GB) written as a checkpoint directory in "
              f"{time.perf_counter() - t0:.1f} s")
        sizes = dict(device=device, backend=backend, work=work, ckpt=ckpt, seq=seq,
                     budget=budget, steps=steps, answer=answer, text_sup=text_sup)
        t0 = time.perf_counter()
        one = _reference(_pp_fsdp_train_worker, {**sizes, "backend": "gloo"},
                         2 * TP_TRAIN_TIMEOUT)
        t1 = time.perf_counter()
        world = 4
        ranks = [r for _, r in sorted(_spawn(_pp_fsdp_train_worker, world, sizes,
                                             4 * TP_TRAIN_TIMEOUT).items())]
        print(f"[pp fsdp train] the reference {t1 - t0:.1f} s, the {world} dp x pp processes "
              f"{time.perf_counter() - t1:.1f} s (start-up, loading twice, the faults' passes, "
              "the steps of both schedules)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    failures = []

    def check(good: bool, what: str) -> None:
        print(f"[pp fsdp train] {what}: {'ok' if good else 'FAIL'}")
        if not good:
            failures.append(what)

    where = {"staged": STAGED_NOTE.replace("two processes", "four processes"),
             "nccl": f"{world} cards over NCCL",
             "gloo": f"{world} gloo processes on the CPU"}[backend]
    geom = "dp 2 x pp 2 FSDP"
    ref = one["runs"][1]
    hkv = cfg.text.num_key_value_heads
    m = 2  # microbatches: pp (JAX's default), a row each on a dp rank's two rows
    print(f"[pp fsdp train] the reference (pp and FSDP off, one process, the {PP_FSDP_ROWS} "
          f"rows): read {ref['bytes_read'] / 1e6:.3f} MB; holds {ref['param_bytes'] / 1e9:.3f} GB "
          f"of parameters, {ref['moment_bytes'] / 1e9:.3f} GB of moments; steps "
          f"{[round(t, 3) for t in ref['step_s']]} s; peak allocated {ref['peak_gb']:.2f} GB "
          f"({ref.get('peak_before_gb', 0.0):.2f} GB before the steps); losses {ref['losses']} "
          f"grad_norm {ref['norms']}; {ref['supervised']} supervised rows")
    counts, gathered, step_s = None, None, {}
    for virtual, name in ((1, "GPipe"), (2, "interleaved (virtual_pp 2)")):
        runs = [r["runs"][virtual] for r in ranks]
        r0 = runs[0]
        for r, run in zip(ranks, runs):
            st = run["fsdp_stats"]
            print(f"[pp fsdp train] {name}, rank (dp {r['coords'][0]}, pp {r['coords'][1]}): "
                  f"layers {run['layers']}; built through train.build_from_recipe in "
                  f"{run['build_s']:.1f} s, read {run['bytes_read'] / 1e6:.3f} MB of the "
                  f"checkpoint's {whole_b / 1e6:.3f} MB; holds {run['param_bytes'] / 1e9:.3f} GB "
                  f"of parameters, {run['moment_bytes'] / 1e9:.3f} GB of moments, "
                  f"{run['grad_bytes'] / 1e9:.3f} GB of gradients; steps "
                  f"{[round(t, 3) for t in run['step_s']]} s ({where}), staged copies "
                  f"{[round(t, 3) for t in run['staged_s']]} s of them, "
                  f"{[round(b, 3) for b in run['staged_gb']]} GB staged a step; gathers "
                  f"{st['gathers']}, regathers {st['regathers']}, reduce-scatters "
                  f"{st['scatters']}, {st['gathered_bytes'] / steps / 1e9:.3f} GB gathered a "
                  f"step, at most {st['peak_live']} unit(s) of whole weights alive; peak "
                  f"allocated {run['peak_gb']:.2f} GB in the steps "
                  f"({run.get('peak_before_gb', 0.0):.2f} GB before them); losses "
                  f"{run['losses']} grad_norm {run['norms']}")
        if not cpu:
            both = sum(max(x["peak_gb"], x.get("peak_before_gb", 0.0)) for x in runs)
            print(f"[pp fsdp train] {name}: the four ranks' peaks together {both:.2f} GB")
        check(all(x["losses"] == r0["losses"] and x["norms"] == r0["norms"] for x in runs),
              f"{name}: every rank reports the same loss and grad_norm bits")
        check(len(r0["losses"]) == steps and all(
            abs(a - b) <= TRAIN_LOSS_REL * abs(b) for a, b in zip(r0["losses"], ref["losses"])),
            f"{name} {geom} losses {r0['losses']} within {TRAIN_LOSS_REL} (relative) of the "
            f"reference's {ref['losses']}")
        check(all(abs(a - b) <= 3 * TRAIN_LOSS_REL * abs(b)
                  for a, b in zip(r0["norms"], ref["norms"])),
              f"{name} {geom} grad_norm {r0['norms']} within {3 * TRAIN_LOSS_REL} of the "
              f"reference's {ref['norms']}")
        cos = r0["cos"]
        # the embedding's and the head's gradients (mask-frozen) are folded
        # into the norm and never held
        check(set(cos) == set(GRAD_GROUPS) - {"embed", "lm_head"} | {"projector"}
              and min(cos.values()) >= TRAIN_GRAD_COS,
              f"{name}: the first step's gradients of the stages' dp shards vs the reference's, "
              f"cosine by group (>= {TRAIN_GRAD_COS}): "
              + ", ".join(f"{k} {v:.6f}" for k, v in cos.items()))
        same = True
        for (r, x), (q, y) in itertools.product(zip(ranks, runs), repeat=2):
            for a, b in zip(x["prints"], y["prints"]):
                for n, fp in a.items():
                    fsdp_leaf = n in x["shared_fsdp"]
                    if (not fsdp_leaf or r["coords"][0] == q["coords"][0]) and b[n] != fp:
                        same = False
        check(same and len(r0["prints"]) == steps,
              f"{name}: after every step every leaf the stages share holds the same bits on "
              f"every rank that holds it (final_norm, the tower, the projector on all four; the "
              f"embedding's and the head's dp pieces on both stages)")
        check(all(x["moved_at_lr0"] == [] for x in runs + [ref]),
              f"{name}: the warm-up's first step (lr 0) leaves every leaf's bits on every rank")
        for r, run in zip(ranks, runs):
            d = r["coords"][0]
            mine = sum(_shard_bytes({n: s for n, s in shapes.items()
                                     if n.startswith(f"text.layers.{g}.")}, specs, hkv, d, 2,
                                    0, 1) for g in run["layers"])
            rest = _shard_bytes({n: s for n, s in shapes.items()
                                 if not n.startswith("text.layers.")}, specs, hkv, d, 2, 0, 1)
            check(run["param_bytes"] == mine + rest
                  and run["bytes_read"] == ref["bytes_read"] - whole_b + mine + rest,
                  f"{name}: rank (dp {d}, pp {r['coords'][1]}) holds and read its stage's 1/dp "
                  f"share exactly: {run['param_bytes'] / 1e9:.3f} GB held, "
                  f"{run['bytes_read'] / 1e6:.3f} MB read; its {len(run['layers'])} layers' "
                  f"pieces {mine / 1e9:.3f} GB, the shared leaves {rest / 1e9:.3f} GB (the "
                  f"reference {ref['param_bytes'] / 1e9:.3f} GB)")
        for r, run in zip(ranks, runs):
            p_idx = r["coords"][1]
            # the head's f32 product saves its gathered bf16 weight on the card
            # (one GEMM into f32); the CPU widens it to an f32 copy first
            want = fsdp_mod.step_counts(len(run["layers"]), m, p_idx == 0, p_idx == 1, True,
                                        head_saved=not cpu)
            got = {k: run["fsdp_stats"][k] // steps for k in want}
            check(got == want and all(run["fsdp_stats"][k] == steps * want[k] for k in want)
                  and run["fsdp_stats"]["peak_live"] == 1,
                  f"{name}: rank (dp {r['coords'][0]}, pp {p_idx}) gathers, regathers and "
                  f"reduce-scatters a step {got} (step_counts: {want}), at most "
                  f"{run['fsdp_stats']['peak_live']} unit of whole weights alive")
        # the launches: the decoder's K1 twice a layer a microbatch a step
        # (remat's recompute) on each stage, K4 or K5 once; the frozen
        # tower's K3 a layer a step on the first stage alone
        tc, vc = cfg.text, cfg.vision
        for r, run in zip(ranks, runs):
            n_layers = len(run["layers"])
            fused = fa.bwd_uses_fused(PP_FSDP_ROWS // (2 * m), seq, seq, tc.num_attention_heads,
                                      tc.head_dim, 2)
            want = dict.fromkeys(run["counts"], 0)
            want["flash_fwd"] = 2 * n_layers * m * steps
            if fused:
                want["flash_bwd"] = n_layers * m * steps
            else:
                want["flash_bwd_dkv"] = want["flash_bwd_dq"] = n_layers * m * steps
            if r["coords"][1] == 0:
                want["short_attn"] = vc.num_hidden_layers * steps
            if not cpu:
                check(run["counts"] == want, f"{name}: launches of rank {r['rank']}: "
                      f"{run['counts']} (expected {want})")
            else:
                print(f"[pp fsdp train] {name}: launches of rank {r['rank']} (the CPU runs the "
                      f"plain versions): {run['counts']}")
        step_s[name] = min(r0["step_s"])
        share = [s / t for s, t in zip(r0["staged_s"], r0["step_s"])]
        gathered = r0["fsdp_stats"]["gathered_bytes"] / steps / 1e9
        print(f"[pp fsdp train] a {geom} {name} step {step_s[name]:.3f} s against the "
              f"reference's {min(ref['step_s']):.3f} s ({where}); a rank gathers "
              f"{gathered:.3f} GB a step; the staged copies' share of a step "
              f"{[round(x, 3) for x in share]}")
        c = {k: sum(run["counts"][k] for run in runs) for k in r0["counts"]}
        counts = c if counts is None else {k: counts[k] + c[k] for k in c}
    tc, vc = cfg.text, cfg.vision
    fused = fa.bwd_uses_fused(PP_FSDP_ROWS, seq, seq, tc.num_attention_heads, tc.head_dim, 2)
    want = dict.fromkeys(ref["counts"], 0)
    want["flash_fwd"] = 2 * tc.num_hidden_layers * steps
    want["short_attn"] = vc.num_hidden_layers * steps
    for k in (["flash_bwd"] if fused else ["flash_bwd_dkv", "flash_bwd_dq"]):
        want[k] = tc.num_hidden_layers * steps
    if not cpu:
        check(ref["counts"] == want, f"launches of the reference: {ref['counts']} (expected "
              f"{want})")
    # the planted faults (GPipe, the main rows, before the step and on the
    # first step's gradients)
    fault = ranks[0]["cos_fault"]
    check(min(fault.values()) < TRAIN_GRAD_COS,
          "the cosine gate with the reduce-scatter replaced by each rank's slice of its own "
          "gradient inside a stage (a planted fault) must fail: "
          + ", ".join(f"{k} {v:.6f}" for k, v in fault.items()))
    want_norm = ref["layers_norm"]
    gpipe = [r["runs"][1] for r in ranks]

    def rel(x):
        return abs(x - want_norm) / want_norm

    check(all(rel(x["layers_norm"]) <= 3 * TRAIN_LOSS_REL for x in gpipe),
          f"grad_norm of the decoder's layers (GPipe's first step), every rank's "
          f"{[round(x['layers_norm'], 6) for x in gpipe]}, within {3 * TRAIN_LOSS_REL} of the "
          f"reference's {want_norm:.6f}")
    check(all(rel(x["layers_norm_unsummed"]) > 3 * TRAIN_LOSS_REL for x in gpipe),
          "the same gate with the norm's dp sum of squares removed (a planted fault) must fail "
          f"on every rank: {[round(x['layers_norm_unsummed'], 6) for x in gpipe]}")
    print(f"[pp fsdp train] phase {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError(f"[pp fsdp train] {failures}")
    return {"counts": counts, "gathered_gb": gathered, "step_s": step_s,
            "ref_step_s": min(ref["step_s"])}


def autograd_thread_probe(device, timeout: float = 20.0) -> dict:
    """Whether two thread-ranks can run backward passes that wait for each
    other on ``device``. Each thread builds a graph through a Function whose
    backward meets the other rank in an all_reduce_sum, then calls
    backward. On the CPU the engine runs a backward on the calling thread;
    on CUDA it runs every device's backward work on one worker thread per
    device, so the second rank's backward would queue behind the first
    one's wait (until the wait's timeout breaks it).
    -> {"completed": bool, "seconds": wall time, "error": str or None}."""
    import torch

    from long_vita_tpu_torch.parallel.comm import run_thread_ranks

    class _Meet(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, comm):
            ctx.comm = comm
            return x * 2

        @staticmethod
        def backward(ctx, g):
            return ctx.comm.all_reduce_sum(g), None

    def rank_fn(comm):
        x = torch.ones(4, device=device, requires_grad=True)
        _Meet.apply(x, comm).sum().backward()
        return x.grad.sum().item()

    t0 = time.perf_counter()
    try:
        done, err = run_thread_ranks(rank_fn, 2, timeout=timeout,
                                     join_timeout=3 * timeout) == [8.0, 8.0], None
    except (TimeoutError, RuntimeError) as e:  # a broken wait, raised inside a backward
        done, err = False, repr(e)
    return {"completed": done, "seconds": time.perf_counter() - t0, "error": err}


# ---- expert parallelism: MoE over dp (phase_ep_train) ----------------------------

EP_TRAIN_LAYERS = 2  # the MoE decoder's depth in phase_ep_train (the 14B's widths)
EP_TRAIN_STEPS = 2  # the warm-up's lr-0 step, then one at lr 1e-5
EP_EXPERTS = 8
EP_AUX_REL = 1e-3  # the EP aux against the mean of the rows' own Switch losses
# the aux term of the EP step's reported loss (its loss less the reference's
# cross-entropy) against coef x the rows' own mean, relative to that term
EP_AUX_TERM_REL = 0.1
EP_NORM_REL = 3e-2  # grad_norm against the reference's


def _ep_train_worker(rank, world, init, out, sizes):
    """One process of phase_ep_train: ``world`` 1 is the dp-1 reference
    (both rows one routing batch; _reference), else rank ``rank``
    of dp 2 (x sizes["tp"]) with the experts cut over dp (expert
    parallelism), over gloo with CUDA operands staged through host memory
    (sizes["backend"] "staged"; every rank on card 0), NCCL (a card a rank)
    or plain gloo on the CPU (the rehearsal). Builds the MoE VLM from the
    seed (every process the same whole tree) and hands it to the Trainer,
    which cuts the rank's shard. The reference trains sizes["steps"] steps
    on the two rows through Trainer.train and records its routes, its first
    step's gradients (to the work directory) and, after that lr-0 step,
    each row's own aux (a forward of that row alone, routed as in its
    step); an EP rank takes the same steps, routed as the reference routed
    its row (_routing_tap's part), and on its first step's gradients and
    loss terms runs the three planted faults: the reduction summing the
    expert stacks over dp as if replicated, grad_norm counting them as if
    replicated over dp, and the reported loss summing the aux over dp.
    After the last step every process lists the leaves that moved. Puts
    (rank, results or the error) on ``out``."""
    import dataclasses

    import numpy as np
    import torch

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    try:
        from long_vita_tpu_torch.models import qwen2
        from long_vita_tpu_torch.models.intern_vit import init_vit_params
        from long_vita_tpu_torch.models.long_vita import LongVITAParams
        from long_vita_tpu_torch.models.projector import init_projector_params
        from long_vita_tpu_torch.ops import moe
        from long_vita_tpu_torch.parallel.comm import init_process_group
        from long_vita_tpu_torch.parallel.mesh import MeshConfig
        from long_vita_tpu_torch.parallel.sharding import slice_leaf
        from long_vita_tpu_torch.training import train_step as tts
        from long_vita_tpu_torch.training.loss import collate_packs
        from long_vita_tpu_torch.training.optimizer import OptimizerConfig, global_norm
        from long_vita_tpu_torch.training.trainer import Trainer, TrainerConfig

        cpu = sizes["device"] == "cpu"
        if cpu:
            torch.set_num_threads(1)
        backend = sizes["backend"]
        comm = None
        if world > 1:
            comm = init_process_group(
                rank, world, init, backend="nccl" if backend == "nccl" else "gloo",
                timeout=TP_TRAIN_TIMEOUT, staged_device="cuda" if backend == "staged" else None)
        dev = torch.device("cpu") if cpu else torch.device("cuda", torch.cuda.current_device())
        sync = (lambda: None) if cpu else torch.cuda.synchronize
        cfg, work, steps = sizes["cfg"], sizes["work"], sizes["steps"]
        tp = sizes["tp"] if world > 1 else 1
        mesh_cfg = MeshConfig(dp=world // tp, tp=tp) if world > 1 else MeshConfig()
        res = {"rank": rank}
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(SEED + 90)
        lv = LongVITAParams(
            text=qwen2.init_qwen2_params(gen, cfg.text, torch.bfloat16, dev),
            vision=init_vit_params(gen, cfg.vision, torch.bfloat16, dev),
            projector=init_projector_params(gen, cfg, torch.bfloat16, dev))
        whole = {n: p.detach() for n, p in lv.named_parameters() if ".experts." in n}
        res["expert_bytes_whole"] = sum(p.nbytes for p in whole.values())
        tcfg = TrainerConfig(
            seq_len=sizes["seq"], logit_budget=sizes["budget"], global_batch=2, steps=steps,
            mesh=mesh_cfg, remat=True, vision_chunk=64,
            optim=OptimizerConfig(lr=1e-5, warmup_steps=1, total_steps=1000, freeze_vision=True,
                                  freeze_embed=True, moment_dtype="bfloat16"))
        trainer = Trainer(lv, cfg, tcfg, comm=comm)
        params, mesh = trainer.state.params, trainer.mesh
        layout = trainer._layout()
        own = {n: p.detach() for n, p in params.named_parameters() if ".experts." in n}
        opt = trainer.state.opt_state
        res["expert_bytes"] = sum(p.nbytes for p in own.values())
        res["expert_moment_bytes"] = sum(opt.mu[n].nbytes + opt.nu[n].nbytes for n in own)
        res["expert_pieces_exact"] = all(
            torch.equal(p, slice_leaf(whole[n], layout[n]) if layout is not None else whole[n])
            for n, p in own.items())
        res["trained"] = sorted({_grad_group(n) for n in opt.mu})
        trained = set(opt.mu)
        res["coords"] = (mesh.dp_index, mesh.tp_index) if mesh is not None else (0, 0)
        del lv, whole, own
        if not cpu:
            torch.cuda.empty_cache()
        sync()
        res["build_s"] = time.perf_counter() - t0

        vc = cfg.vision
        per_tile = int((vc.grid * cfg.vision_downsample_ratio) ** 2)
        pcfg = dataclasses.replace(cfg, image_token_length=per_tile)
        packs = [_train_pack(pcfg, sizes["seq"], [], [(np.random.default_rng(SEED + 91 + i)
                                                       .standard_normal((7, vc.image_size,
                                                                         vc.image_size, 3))
                                                       .astype(np.float32), (2, 3))],
                             np.random.default_rng(SEED + 93 + i), text_segments=4,
                             answer=sizes["answer"], text_sup=sizes["text_sup"])
                 for i in range(2)]

        def collated(rows):
            b = collate_packs(rows, sizes["budget"])
            b["tokens"] = np.minimum(b["tokens"], cfg.text.vocab_size - 1)
            return b

        batch = collated(packs)
        res["supervised"] = [int((collated([p])["labels"] != -100).sum()) for p in packs]
        routes_path = os.path.join(work, "routes.pt")
        grads_path = os.path.join(work, "grads_ref.pt")
        part = (mesh.dp_index, mesh.shape["dp"]) if mesh is not None else None
        forced = torch.load(routes_path) if world > 1 else None

        # ---- the main path: Trainer.train, the steps on the two rows
        first, auxes, terms = {}, [], []
        step_backward, step_terms = tts._backward, tts.loss_terms

        def keep_first(*a, **k):
            out_ = step_backward(*a, **k)
            if "grads" not in first:
                first["grads"] = {n: t.to("cpu") for n, t in out_[0].items()}
                # the experts' part of grad_norm (the frozen embedding's and
                # head's folded squares outweigh it), and on an EP rank the
                # same with the planted norm fault
                experts = {n: g for n, g in out_[0].items() if ".experts." in n}
                if mesh is None:
                    first["expert_norm"] = float(global_norm(experts.values()))
                else:
                    red = tts._Reduction(params, cfg, mesh)
                    first["expert_norm"] = float(red.norm(experts))
                    tts._NORM_EXPERTS_ONCE_OVER_DP = True
                    try:
                        first["fault_norm"] = float(red.norm(experts))
                    finally:
                        tts._NORM_EXPERTS_ONCE_OVER_DP = False
            return out_

        def aux_tap(*a, **k):
            out_ = step_terms(*a, **k)
            auxes.append(float(out_[2].detach()))
            if not terms:  # the first step's loss terms, for the aux fault
                terms.append(tuple(t.detach() for t in out_))
            return out_

        tts._backward, tts.loss_terms = keep_first, aux_tap
        before = {n: _fingerprint(p) for n, p in params.named_parameters()}
        step_fn, kept, norms_log = trainer.step_fn, [], []

        def logged(state, b):
            state, m = step_fn(state, b)
            norms_log.append(float(m["grad_norm"]))
            if not kept:  # the warm-up's first step runs at lr 0
                kept.append(sorted(n for n, p in state.params.named_parameters()
                                   if _fingerprint(p) != before[n]))
            return state, m

        routes = {}  # the main path's recorded calls (the reference's)

        def row_aux():
            """Each row's own Switch loss: a forward of that row alone,
            routed as the step's forward routed it (its first calls), at the
            step's weights (the lr-0 step moved none); the calls the main
            path's tap records meanwhile are dropped."""
            calls = routes["tapped"][None]
            n, out_ = len(calls), []
            before_ = _read_counts()
            for i in range(2):
                with torch.no_grad(), _routing_tap(forced=calls[:n], part=(i, 2),
                                                   per_thread=False):
                    out_.append(float(tts.loss_terms(
                        params, trainer._device_batch(collated([packs[i]])), cfg, False,
                        trainer.tcfg.vision_chunk, freeze_vision=True)[2]))
            del calls[n:]
            # the rows' forwards are not the main path's launches
            res["row_aux_counts"] = {k: v - before_[k] for k, v in _read_counts().items()}
            return out_

        def logged_ref(state, b):
            state, m = logged(state, b)
            if "row_aux" not in res:
                res["row_aux"] = row_aux()
            return state, m

        trainer.step_fn = logged if world > 1 else logged_ref
        stamps, staged = [], []
        stats = getattr(comm, "stats", None)

        def batches():
            for _ in range(steps):
                sync()
                stamps.append(time.perf_counter())
                staged.append(stats["seconds"] if stats else 0.0)
                yield batch

        _reset_counts()
        moe.reset_stats()
        if not cpu:
            torch.cuda.reset_peak_memory_stats()
        try:
            with _routing_tap(forced=forced, part=part, per_thread=False) as tapped:
                routes["tapped"] = tapped
                res["losses"] = trainer.train(batches())["losses"]
        finally:
            tts._backward, tts.loss_terms = step_backward, step_terms
        sync()
        stamps.append(time.perf_counter())
        staged.append(stats["seconds"] if stats else 0.0)
        res["counts"] = {k: v - res.get("row_aux_counts", {}).get(k, 0)
                         for k, v in _read_counts().items()}
        res["moe"] = moe.stats()
        res["peak_gb"] = 0.0 if cpu else torch.cuda.max_memory_allocated() / 1e9
        res["norms"], res["aux"] = norms_log, auxes[:1]
        res["fault_norm"], res["expert_norm"] = first.get("fault_norm"), first["expert_norm"]
        res["moved_at_lr0"] = kept[0] if kept else None
        moved = {n for n, p in params.named_parameters() if _fingerprint(p) != before[n]}
        moe_leaves = [n for n, _ in params.named_parameters()
                      if ".experts." in n or ".router." in n]
        res["moe_moved"] = (sum(n in moved for n in moe_leaves), len(moe_leaves))
        res["moved_untrained"] = sorted(moved - trained)
        res["step_s"] = [b - a for a, b in zip(stamps, stamps[1:])]
        res["staged_s"] = [b - a for a, b in zip(staged, staged[1:])]
        grads = first.pop("grads")
        if world == 1:
            torch.save(tapped[None], routes_path)
            torch.save(grads, grads_path)
        else:
            res["cos"] = _group_cosines(grads, grads_path, layout, mesh.tp_comm, dev,
                                        mesh.dp_comm)
            # the planted reduction fault on the step's own gradients (layer
            # 0's gate stack, for the run's time): summed over dp x cp as if
            # replicated (at cp 1 the sound sum over cp left them as they are)
            leaf = next(n for n in grads if n.endswith(".experts.gate"))
            tts._EXPERTS_SUMMED_OVER_DP = True
            try:
                faulty = tts._all_reduce_grads({leaf: grads[leaf].to(dev)},
                                               tts._Reduction(params, cfg, mesh).comm)
            finally:
                tts._EXPERTS_SUMMED_OVER_DP = False
            res["cos_fault"] = _group_cosines(faulty, grads_path, layout, mesh.tp_comm, dev,
                                              mesh.dp_comm)
            del faulty
            # the aux fault on the first step's own loss terms: the reported
            # loss with the aux summed over dp, not averaged
            tts._AUX_SUMMED_OVER_DP = True
            try:
                res["loss_aux_fault"] = float(tts.mesh_loss(*terms[0], cfg, mesh)[1])
            finally:
                tts._AUX_SUMMED_OVER_DP = False
        del grads
        out.put((rank, res))
        if comm is not None:
            comm.barrier()
            torch.distributed.destroy_process_group()
    except Exception as e:  # noqa: BLE001 (reported to the parent)
        import traceback

        out.put((rank, f"raised {type(e).__name__}: {e}\n{traceback.format_exc()[-2500:]}"))


def _ep_capacity(tc, routes_path: str, seq: int) -> tuple:
    """The EP ranks' capacity factor: the least multiple of 1/8 (at most
    E / k) whose capacity holds, in every call the reference recorded, the
    copies one expert took from one row (a row an EP rank's routing batch),
    so that nothing drops there either; a smaller buffer than E / k's, whose
    every slot crosses the exchange. -> (the factor, the slots needed)."""
    import torch

    from long_vita_tpu_torch.ops.moe import moe_capacity

    e, k = tc.num_experts, tc.moe_top_k
    calls = torch.load(routes_path)
    need = max(int(torch.bincount(row.reshape(-1), minlength=e).max())
               for ids in calls for row in ids.reshape(-1, seq * k))
    cf = 1 / 8
    while cf < e / k and moe_capacity(seq, e, k, cf) < need:
        cf += 1 / 8
    return cf, need


def phase_ep_train(*, backend="staged", device="cuda", base=None, layers=EP_TRAIN_LAYERS,
                   experts=EP_EXPERTS, tp=1, seq=8192, budget=2048, steps=EP_TRAIN_STEPS,
                   answer=200, text_sup=400) -> dict:
    """Expert parallelism from the Trainer: the MoE VLM at the 14B's widths
    (h 5120, 40/8 heads, ``experts`` experts of ffn 13824, top-2,
    moe_aux_loss_coef 0.01), the decoder cut to ``layers`` layers, the
    InternViT-300M tower frozen, the embedding and the head frozen (the
    optimizer's mask: their gradients count in grad_norm), Adam's first
    moments in bf16; random weights from the seed; two packed rows of
    ``seq`` tokens, each with a 7-tile image, the logit budget ``budget``
    a row; the capacity factor E / k in the reference and, on the EP
    ranks, the least that the reference's routes of their rows need
    (_ep_capacity: nothing drops, with a smaller buffer); ``steps`` steps (the
    warm-up's lr-0 step, then lr 1e-5). First the dp-1 reference
    (both rows one routing batch; _reference: in this process on the
    card), then dp 2 (x ``tp``) with the experts cut over dp, a row a dp
    rank (backend "staged": two gloo processes sharing this card,
    host-staged; "nccl": a card a rank; "gloo" with device "cpu": the
    rehearsal). Every EP call routes as the reference routed its row
    (_routing_tap: random routers put a token's top-2 margin at the order
    of bf16 rounding). Gates: no copy dropped; each step's loss within
    TRAIN_LOSS_REL of the reference's, grad_norm within EP_NORM_REL; every
    rank the same loss bits; the first step's gradients against the
    reference's at cosine >= TRAIN_GRAD_COS for every group (experts and
    routers included); the EP aux (the mean of the ranks' own) within
    EP_AUX_REL of the mean of the rows' own Switch losses, recomputed by
    the reference from each row alone; the aux term of the EP first step's
    reported loss (less the reference's cross-entropy) within
    EP_AUX_TERM_REL of coef x that mean; three planted faults that must
    fail: the expert gradients summed over dp as if replicated (the cosine
    gate), grad_norm counting them as if replicated over dp (the experts'
    part of grad_norm, within EP_NORM_REL of the reference's without the
    fault), the aux summed over dp in the reported loss (the aux-term
    gate); the lr-0 step leaving every bit, the second step moving every
    expert stack and router on every rank and no leaf the optimizer does
    not train; each rank holding exactly its
    share of the expert bytes (its pieces the whole tree's slices, bit for
    bit, and their moments); K1, K3 and K4 or K5 launches exact. ->
    {"counts": every EP rank's launches summed}."""
    import dataclasses

    from long_vita_tpu_torch.config import long_vita_14b
    from long_vita_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    cpu = device == "cpu"
    base = base or long_vita_14b()
    # a capacity factor of E / k gives each expert a slot for every token of
    # its routing batch: nothing drops, so dp 1 (both rows one call) and EP (a
    # row a call, at the factor the reference's routes need) route alike
    # (under drops they should differ; tests/test_torch_ep_*.py hold the drop
    # semantics to JAX's)
    cfg = dataclasses.replace(base, text=dataclasses.replace(
        base.text, num_hidden_layers=layers, num_experts=experts,
        moe_capacity_factor=experts / base.text.moe_top_k))
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_ep_train_", dir=build)
    sizes = dict(device=device, backend=backend, work=work, cfg=cfg, seq=seq, budget=budget,
                 steps=steps, tp=tp, answer=answer, text_sup=text_sup)
    try:
        t0 = time.perf_counter()
        one = _reference(_ep_train_worker, {**sizes, "backend": "gloo"}, 2 * TP_TRAIN_TIMEOUT)
        t1 = time.perf_counter()
        cf_ep, need = _ep_capacity(cfg.text, os.path.join(work, "routes.pt"), seq)
        ep_cfg = dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, moe_capacity_factor=cf_ep))
        world = 2 * tp
        ranks = [r for _, r in sorted(_spawn(_ep_train_worker, world, {**sizes, "cfg": ep_cfg},
                                             2 * TP_TRAIN_TIMEOUT).items())]
        print(f"[ep train] the reference {t1 - t0:.1f} s, the {world} EP processes "
              f"{time.perf_counter() - t1:.1f} s (start-up, building, the steps, the "
              "faults on the first step's gradients)")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    failures = []

    def check(good: bool, what: str) -> None:
        print(f"[ep train] {what}: {'ok' if good else 'FAIL'}")
        if not good:
            failures.append(what)

    where = {"staged": STAGED_NOTE, "nccl": f"{world} cards over NCCL",
             "gloo": f"{world} gloo processes on the CPU"}[backend]
    geom = f"EP dp 2 x tp {tp}" if tp > 1 else "EP dp 2"
    tc, vc = cfg.text, cfg.vision
    r0 = ranks[0]
    print(f"[ep train] the MoE VLM at the 14B's widths (h {tc.hidden_size}, {experts} experts of "
          f"ffn {tc.intermediate_size}, top-{tc.moe_top_k}, capacity factor "
          f"{tc.moe_capacity_factor}, aux coefficient {tc.moe_aux_loss_coef}), {layers} layers, "
          f"two {seq}-token rows ({one['supervised']} supervised), trained leaves "
          f"{r0['trained']}")
    for r in ranks + [one]:
        who = "the reference" if r is one else f"rank (dp {r['coords'][0]}, tp {r['coords'][1]})"
        print(f"[ep train] {who}: built in {r['build_s']:.1f} s; holds "
              f"{r['expert_bytes'] / 1e9:.3f} GB of the {r['expert_bytes_whole'] / 1e9:.3f} GB of "
              f"experts, {r['expert_moment_bytes'] / 1e9:.3f} GB of their moments; steps "
              f"{[round(t, 3) for t in r['step_s']]} s ({where if r is not one else 'one process'}"
              f"), staged copies {[round(t, 3) for t in r['staged_s']]} s of them; peak allocated "
              f"{r['peak_gb']:.2f} GB; losses {r['losses']} grad_norm {r['norms']}; routed "
              f"{r['moe']}")
    check(all(r["moe"]["dropped"] == 0 and r["moe"]["copies"] > 0 for r in ranks + [one]),
          f"no copy dropped (capacity factor E / k in the reference; {cf_ep} on the EP ranks, "
          f"whose rows' routes need {need} slots of an expert) in the reference or on any EP "
          "rank")
    check(all(r["losses"] == r0["losses"] for r in ranks), "every EP rank reports the same loss "
          "bits")
    check(len(r0["losses"]) == steps and all(
        abs(a - b) <= TRAIN_LOSS_REL * abs(b) for a, b in zip(r0["losses"], one["losses"])),
        f"{geom} losses {r0['losses']} within {TRAIN_LOSS_REL} (relative) of the dp-1 "
        f"reference's {one['losses']}")
    check(all(abs(a - b) <= EP_NORM_REL * abs(b) for a, b in zip(r0["norms"], one["norms"])),
          f"{geom} grad_norm {r0['norms']} within {EP_NORM_REL} of the reference's "
          f"{one['norms']}")
    cos = r0["cos"]
    want_groups = {"experts", "router", "input_norm", "post_attn_norm", "final_norm", "q_proj",
                   "k_proj", "v_proj", "o_proj", "projector"}
    check(min(cos.values()) >= TRAIN_GRAD_COS and set(cos) == want_groups,
          "the first step's gradients of the EP shards vs the reference's, cosine by group "
          f"(>= {TRAIN_GRAD_COS}): " + ", ".join(f"{k} {v:.6f}" for k, v in cos.items()))
    fault = r0["cos_fault"]
    check(fault["experts"] < TRAIN_GRAD_COS,
          "the cosine gate with the expert gradients summed over dp as if replicated (a planted "
          f"fault; layer 0's gate stack) must fail: experts {fault['experts']:.6f}")
    def rel(x):
        return abs(x - one["expert_norm"]) / one["expert_norm"]

    check(all(rel(r["expert_norm"]) <= EP_NORM_REL for r in ranks),
          f"the experts' part of grad_norm {[round(r['expert_norm'], 6) for r in ranks]} within "
          f"{EP_NORM_REL} of the reference's {one['expert_norm']:.6f}")
    check(all(rel(r["fault_norm"]) > EP_NORM_REL for r in ranks),
          "that gate with the experts counted as if replicated over dp (a planted fault) must "
          f"fail: {[round(r['fault_norm'], 6) for r in ranks]}")
    ep_aux = sum(r["aux"][0] for r in ranks if r["coords"][1] == 0) / 2
    rows_aux = sum(one["row_aux"]) / 2
    check(abs(ep_aux - rows_aux) <= EP_AUX_REL * abs(rows_aux),
          f"the EP aux {ep_aux:.6f} (the mean over dp of each rank's row's) within {EP_AUX_REL} "
          f"of the mean of the rows' own Switch losses {rows_aux:.6f} ({one['row_aux']}; the "
          f"reference's two-row call: {one['aux'][0]:.6f})")
    coef = tc.moe_aux_loss_coef
    term = coef * rows_aux
    want = one["losses"][0] - coef * one["aux"][0] + term  # the reference's CE + the EP term

    def term_check(loss):
        return abs(loss - want) <= EP_AUX_TERM_REL * term

    check(term_check(r0["losses"][0]),
          f"the aux term of the EP loss, {r0['losses'][0] - want + term:.6f} (its first loss "
          f"{r0['losses'][0]:.6f} less the reference's cross-entropy), within {EP_AUX_TERM_REL} "
          f"(relative) of {coef} x the rows' own mean, {term:.6f}")
    check(all(not term_check(r["loss_aux_fault"]) for r in ranks),
          "that gate with the aux summed over dp, not averaged (a planted fault) must fail: "
          f"losses {[round(r['loss_aux_fault'], 6) for r in ranks]} against {want:.6f}")
    check(all(r["moved_at_lr0"] == [] for r in ranks + [one]),
          "the warm-up's first step (lr 0) leaves every leaf's bits on every rank")
    check(steps < 2 or all(r["moe_moved"][0] == r["moe_moved"][1] > 0
                           and not r["moved_untrained"] for r in ranks + [one]),
          f"after the step at lr > 0 every expert stack and router moved on every rank "
          f"({[r['moe_moved'] for r in ranks + [one]]} (moved, of)) and no leaf the optimizer "
          f"does not train ({[r['moved_untrained'][:3] for r in ranks + [one]]})")
    check(all(r["expert_pieces_exact"] and r["expert_bytes"] * 2 * tp == r["expert_bytes_whole"]
              and r["expert_moment_bytes"] * 2 * tp == one["expert_moment_bytes"]
              for r in ranks) and one["expert_pieces_exact"],
          "each rank holds exactly its share of the expert bytes (its pieces the whole tree's "
          "slices bit for bit, 1 / (dp x tp) of the bytes and of their moments)")
    for r, n_rows in [(r, 1) for r in ranks] + [(one, 2)]:
        fused = fa.bwd_uses_fused(n_rows, seq, seq, tc.num_attention_heads // (
            1 if r is one else tp), tc.head_dim, 2)
        want = dict.fromkeys(r["counts"], 0)
        want["flash_fwd"] = 2 * layers * steps
        want["short_attn"] = vc.num_hidden_layers * steps
        if fused:
            want["flash_bwd"] = layers * steps
        else:
            want["flash_bwd_dkv"] = want["flash_bwd_dq"] = layers * steps
        who = "the reference" if r is one else f"rank {r['rank']}"
        if not cpu:
            check(r["counts"] == want, f"launches of {who}: {r['counts']} (expected {want})")
        else:
            print(f"[ep train] launches of {who} (the CPU runs the plain versions): "
                  f"{r['counts']}")
    print(f"[ep train] an {geom} step {min(r0['step_s']):.3f} s against the reference's "
          f"{min(one['step_s']):.3f} s ({where}); phase {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError(f"[ep train] {failures}")
    return {"counts": {k: sum(r["counts"][k] for r in ranks) for k in r0["counts"]}}


def phase_autograd_probe(timeout: float = 5.0) -> None:
    """Why the cp backward runs at op level on thread-ranks: two thread-
    ranks whose backward passes wait for each other (autograd_thread_probe)
    on the CPU and on the card. Run last, after every training phase: on
    the card the probe's waits time out inside autograd's device thread."""
    for device in ("cpu", "cuda"):
        res = autograd_thread_probe(device, timeout=timeout)
        print(f"[autograd] two thread-ranks whose backward passes meet, on {device}: "
              f"{'completed' if res['completed'] else 'did not complete'} in "
              f"{res['seconds']:.2f} s (wait timeout {timeout} s; {res['error']})")


def _cp_nccl_worker(rank, world, init, out, sizes):
    """One NCCL process (a GPU each) of phase_cp_nccl; gloo on the CPU when
    sizes["device"] is "cpu" (the rehearsal). Puts (rank, results or the
    error) on ``out``."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    try:
        from long_vita_tpu_torch.config import long_vita_14b, tiny_test_config
        from long_vita_tpu_torch.models.long_vita import init_long_vita_params
        from long_vita_tpu_torch.ops import flash_attention as fa
        from long_vita_tpu_torch.ops.ring_attention import ring_attention, ring_fwd
        from long_vita_tpu_torch.parallel.comm import init_process_group
        from long_vita_tpu_torch.parallel.zigzag import zigzag_permute, zigzag_unpermute
        from long_vita_tpu_torch.training.loss import collate_packs
        from long_vita_tpu_torch.training.optimizer import OptimizerConfig
        from long_vita_tpu_torch.training.trainer import MeshConfig, Trainer, TrainerConfig

        cpu = sizes["device"] == "cpu"
        comm = init_process_group(rank, world, init, backend="gloo" if cpu else "nccl",
                                  timeout=CP_TIMEOUT)
        dev = torch.device("cpu") if cpu else torch.device("cuda", rank)
        res = {}
        # ---- ring attention, forward and backward through autograd (each
        # process has its own device thread) vs K1 + K4/K5 on the whole
        s, (hq, hkv), d = sizes["seq"], sizes["heads"], sizes["d"]
        rnd = _cp_rand(dev, SEED + 40)
        q, k, v, do = rnd(1, s, hq, d), rnd(1, s, hkv, d), rnd(1, s, hkv, d), rnd(1, s, hq, d)
        if cpu:
            q, k, v, do = (x.float() for x in (q, k, v, do))
        n = s // world
        qz, kz, vz, dz = (zigzag_permute(x, world)[:, rank * n:(rank + 1) * n].clone()
                          for x in (q, k, v, do))
        leaves = [x.requires_grad_() for x in (qz, kz, vz)]
        for _ in range(2):  # the first call also sets up the NCCL communicators
            for x in leaves:
                x.grad = None
            comm.barrier()
            t0 = time.perf_counter()
            o = ring_attention(*leaves, comm)
            o.backward(dz)
            if not cpu:
                torch.cuda.synchronize()
            res["ring_s"] = time.perf_counter() - t0
        got = [comm.all_gather(x.detach().contiguous(), 1) for x in (o, *(x.grad for x in leaves))]
        got = [zigzag_unpermute(x, world) for x in got]
        ro, rlse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        ref = (ro, *fa.flash_attention_bwd(q, k, v, ro, rlse, do, causal=True))
        # the forward on this rank's shard: o and the ring's merged lse
        # against the reference's rows of the shard (the lse permuted as the
        # sequence is), o's tolerance from the whole reference's RMS
        o_s, lse_s = ring_fwd(*(x.detach() for x in leaves), comm)
        shard = slice(rank * n, (rank + 1) * n)
        ref_lse = zigzag_permute(rlse, world, axis=2)[:, :, shard]
        res["ring_fwd"] = cp_forward_check(o_s, zigzag_permute(ro, world)[:, shard], lse_s,
                                           ref_lse, rms=ro.float().square().mean().sqrt().item())
        res["ring_err"] = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, ref)]
        res["ring_scale"] = [b.float().abs().max().item() for b in ref]
        del q, k, v, do, got, ref, leaves, o, o_s, lse_s
        # ---- two Trainer steps at cp 2 vs cp 1, the decoder cut to
        # sizes["layers"] layers at full width, a frozen random tower
        cfg = long_vita_14b() if not cpu else tiny_test_config()
        cfg = dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, num_hidden_layers=sizes["layers"]))
        dtype = torch.float32 if cpu else torch.bfloat16
        base = init_long_vita_params(torch.Generator(device=dev).manual_seed(SEED + 41), cfg,
                                     dtype, dev)
        rng = np.random.default_rng(SEED + 42)
        vc = cfg.vision
        tiles = rng.standard_normal((7, vc.image_size, vc.image_size, 3)).astype(np.float32)
        pack = _train_pack(cfg, sizes["train_seq"], [], [(tiles, (2, 3))], rng,
                           text_segments=4, answer=sizes["answer"], text_sup=sizes["answer"])
        optim = OptimizerConfig(lr=1e-5, warmup_steps=0, total_steps=10, freeze_vision=True)

        def train(cp, comm_):
            tr = Trainer(copy.deepcopy(base), cfg, TrainerConfig(
                seq_len=sizes["train_seq"], logit_budget=sizes["budget"], steps=2,
                remat=True, vision_chunk=64, optim=optim, mesh=MeshConfig(cp=cp)), comm=comm_)
            norms, step_fn = [], tr.step_fn

            def logged(state, batch):
                state, m = step_fn(state, batch)
                norms.append(float(m["grad_norm"]))
                return state, m

            tr.step_fn = logged
            from long_vita_tpu_torch.training.trainer import batch_iterator

            t = time.perf_counter()
            losses = tr.train(batch_iterator(iter([pack, pack]), 1, sizes["budget"], cp))["losses"]
            return losses, norms, time.perf_counter() - t

        res["cp2"] = train(world, comm)
        if rank == 0:
            res["cp1"] = train(1, None)
        comm.barrier()
        res["server"] = _nccl_server(comm, base, cfg, sizes)
        comm.barrier()
        res["tp_server"] = _nccl_server(comm, base, cfg, sizes, axis="tp")
        comm.barrier()
        res["tp_ttft"] = _nccl_tp_ttft(comm, base, cfg, sizes, dev)
        comm.barrier()
        out.put((rank, res))
        torch.distributed.destroy_process_group()
    except Exception as e:  # noqa: BLE001 (reported to the parent)
        import traceback

        out.put((rank, f"raised {type(e).__name__}: {e}\n{traceback.format_exc()[-2000:]}"))


def _nccl_server(comm, model, cfg, sizes, axis: str = "cp") -> dict:
    """The lockstep server over a process group (phase_cp_nccl's last parts),
    the engine over a mesh of the group's ranks on ``axis`` (cp, or tp: the
    weights and the cache's kv heads sharded): rank 0 serves sizes' requests
    over HTTP on localhost (continuous mode, 2 slots, tick 4: text prompts
    and a 4-tile image, concurrently), rank 1 follows; then every rank
    replays rank 0's admissions, broadcast to it over the lockstep channel,
    in an in-process pool (gate (b)).
    -> rank 0: {"http", "replay"}; rank 1: {"follower", "replay"}."""
    import numpy as np

    from long_vita_tpu_torch.data.image_processor import ImageProcessor
    from long_vita_tpu_torch.data.multimodal import MultimodalTokenizer
    from long_vita_tpu_torch.inference import multihost
    from long_vita_tpu_torch.inference.engine import InferenceEngine
    from long_vita_tpu_torch.inference.sampler import SamplingParams
    from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from long_vita_tpu_torch.tokenizer import ByteTokenizer

    rng = np.random.default_rng(SEED + 43)
    vc = cfg.vision
    mm = MultimodalTokenizer(ByteTokenizer(**sizes["server_tok"]), image_processor=ImageProcessor(
        image_size=vc.image_size), image_token_length=cfg.image_token_length)
    eng = InferenceEngine(model, cfg, mm, mesh=make_mesh(MeshConfig(**{axis: comm.size}), comm),
                          max_seq_len=sizes["server_seq"], chunk=sizes["server_chunk"])
    greedy = {"tokens_to_generate": sizes["server_tokens"], "logprobs": True}
    reqs = [{"prompts": [_random_text(rng, n)], **greedy} for n in sizes["server_chars"]]
    reqs.append({"prompts": ["<image>\n" + _random_text(rng, 50)],
                 "image_list": [_png_b64(rng, *sizes["server_image"])], **greedy})
    slots, tick = 2, 4
    out = {}
    if comm.rank == 0:
        out["http"] = _lockstep_http(eng, continuous=True, slots=slots, tick=tick, together=reqs)
        out["http"]["requests"] = reqs
        admitted = out["http"]["admitted"]
    else:
        out["follower"] = _follower(eng, continuous=True, slots=slots, tick=tick)
        admitted = None
    # rank 0's admissions to every rank, over the lockstep channel itself
    chan = comm.host_comm()
    n = multihost.publish(chan, len(admitted) if comm.rank == 0 else None)
    got = []
    for i in range(n):
        a = admitted[i] if comm.rank == 0 else None
        meta = None if a is None else {
            "rid": a["rid"], "prompt": a["prompt"], "has_images": a["images"] is not None,
            "sampling": {k: getattr(a["sampling"], k) for k in a["sampling"].__dataclass_fields__}}
        arrays = () if a is None else [np.asarray(a["ids"], np.int32)] + (
            [a["images"], np.asarray(a["indices"])] if a["images"] is not None else [])
        meta, arrays = multihost.publish_blob(chan, meta, arrays)
        sp = meta["sampling"]
        got.append(dict(rid=meta["rid"], prompt=meta["prompt"], ids=arrays[0].tolist(),
                        images=arrays[1] if meta["has_images"] else None,
                        indices=arrays[2].numpy() if meta["has_images"] else None,
                        sampling=SamplingParams(**{**sp, "stop_token_ids": tuple(
                            sp["stop_token_ids"])})))
    out["replay"], _ = _replay_admissions(eng, got, slots=slots, tick=tick)
    for a in out.get("http", {}).get("admitted", ()):
        a["images"] = a["indices"] = None  # no tensors through the result queue
    return out


def _nccl_tp_ttft(comm, model, cfg, sizes, dev) -> dict:
    """tp over the process group: a prompt of sizes["ttft_prompt"] ids and
    2 greedy tokens through an engine over MeshConfig(tp=ranks), timed
    twice (the second call's TTFT counts), then on rank 0 the same through
    a one-device engine, whose first step's logits hold the tp engine's
    under §2's gate. -> {"ttft", "ttft_one", "tokens", "logits_ok"}."""
    import numpy as np
    import torch

    from long_vita_tpu_torch.inference.engine import InferenceEngine
    from long_vita_tpu_torch.inference.sampler import SamplingParams
    from long_vita_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rng = np.random.default_rng(SEED + 44)
    vocab = min(cfg.text.vocab_size, 151643)
    prompt = rng.integers(0, vocab, sizes["ttft_prompt"]).tolist()
    sp = SamplingParams(max_new_tokens=2)
    kw = dict(max_seq_len=sizes["ttft_seq"], chunk=sizes["server_chunk"])

    def ttft(eng, meet=True):
        seen = {}
        with _sampling_tap() as taps:
            for _ in range(2):  # the first call warms the communicators up
                if meet:
                    comm.barrier()
                sync()
                t0 = time.perf_counter()
                cache, hidden, _ = eng.prefill(prompt)
                eng._head_sample(hidden, torch.Generator(device=dev).manual_seed(0), sp)
                sync()
                seen["t"] = time.perf_counter() - t0
                del cache
            out = eng.generate(input_ids=prompt, sampling=sp)
        steps = next(iter(taps.values()))
        return seen["t"], out.token_ids, steps[0][0].cpu()

    eng = InferenceEngine(model, cfg, _StubMM(), mesh=make_mesh(MeshConfig(tp=comm.size), comm),
                          **kw)
    t_tp, tokens, logits = ttft(eng)
    del eng
    res = {"ttft": t_tp, "tokens": tokens}
    if comm.rank == 0:
        one = InferenceEngine(model, cfg, _StubMM(), **kw)
        res["ttft_one"], _, ref = ttft(one, meet=False)
        res["logits_ok"] = _logit_check("tp-nccl", f"tp {comm.size} over the process group vs "
                                        "one device, the first step", logits, ref)
        del one
    return res


def phase_cp_nccl(*, force=False, device="cuda", seq=CP_SEQ, heads=(40, 8), d=128, layers=4,
                  train_seq=16384, budget=4096, answer=300, server_seq=16384,
                  server_chunk=2048, server_chars=(3000, 1500), server_image=(1344, 448),
                  server_tokens=8, server_tok=None, ttft_prompt=16000, ttft_seq=16384) -> None:
    """cp 2 over NCCL, one process a GPU, where the machine has two or more
    GPUs: ring attention forward and backward (through autograd) at 64K
    tokens against K1 and K4/K5 over the whole sequence, two Trainer
    steps at cp 2 (full width, the decoder cut to 4 layers, a frozen random
    tower; one packed row of 16384 tokens with a 7-tile image) against the
    same steps at cp 1, the lockstep server at cp 2 and then at tp 2 on that
    model (rank 0 answers HTTP, rank 1 follows: gates (a) and (b) of
    phase_cp_server), and a ttft_prompt-id TTFT at tp 2 against one card.
    On one GPU it prints that it did not run. force and device="cpu": the
    rehearsal over gloo at the sizes given (server_tok: the ByteTokenizer's
    ids, Qwen2.5's by default)."""
    import queue as queue_mod
    import socket

    import torch
    import torch.multiprocessing as mp

    n_dev = torch.cuda.device_count() if device == "cuda" else 0
    if device == "cuda" and n_dev < 2 and not force:
        print(json.dumps({"phase": "cp_nccl", "ran": False, "devices": n_dev}))
        return
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    sizes = dict(device=device, seq=seq, heads=heads, d=d, layers=layers, train_seq=train_seq,
                 budget=budget, answer=answer, server_seq=server_seq, server_chunk=server_chunk,
                 server_chars=server_chars, server_image=server_image,
                 server_tokens=server_tokens, server_tok=server_tok or {},
                 ttft_prompt=ttft_prompt, ttft_seq=ttft_seq)
    procs = [ctx.Process(target=_cp_nccl_worker,
                         args=(r, 2, f"tcp://127.0.0.1:{port}", out, sizes)) for r in range(2)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + 2 * CP_TIMEOUT
    try:
        while len(results) < 2 and time.monotonic() < deadline:
            try:
                rank, res = out.get(timeout=10)
                results[rank] = res
            except queue_mod.Empty:
                if not any(p.is_alive() for p in procs):
                    break
        for p in procs:
            p.join(30)
    finally:
        for p in procs:  # stop every process the phase started
            if p.is_alive():
                p.kill()
                p.join(10)
    bad = {r: res for r, res in results.items() if isinstance(res, str)}
    if len(results) < 2 or bad:
        raise AssertionError(f"[cp-nccl] workers failed or did not report: {bad or results}")
    for rank, res in sorted(results.items()):
        errs, scales, f = res["ring_err"], res["ring_scale"], res["ring_fwd"]
        ok = f["ok"] and all(e <= 2 * GRAD_TOL * sc for e, sc in zip(errs[1:], scales[1:]))
        print(f"[cp-nccl] rank {rank}: ring cp 2 over NCCL at {seq} tokens, forward + backward "
              f"{res['ring_s']:.3f} s (wall, second call); vs K1/K4-5 on the whole: this rank's "
              f"o max|err| {f['err']:.3e}, worst err / tol {f['worst']:.3f} (tol {f['atol']:.3e} = "
              f"{CP_O_RMS_FRAC} x RMS(ref) + {O_RTOL} x |ref|), merged lse max|err| "
              f"{f['lse_err']:.3e} (tol {LSE_ATOL}); max|err| dq {errs[1]:.3e}, dk {errs[2]:.3e}, "
              f"dv {errs[3]:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("[cp-nccl] ring attention over NCCL disagrees")
    l2, n2, t2 = results[0]["cp2"]
    l1, n1, t1 = results[0]["cp1"]
    if results[1]["cp2"][0] != l2:
        raise AssertionError("[cp-nccl] the two ranks report different losses")
    ok = all(abs(a - b) <= TRAIN_LOSS_REL * abs(b) for a, b in zip(l2, l1)) and all(
        abs(a - b) <= 3 * TRAIN_LOSS_REL * abs(b) for a, b in zip(n2, n1))
    print(f"[cp-nccl] Trainer, {layers} layers at full width, 2 steps: cp 2 losses {l2} "
          f"grad_norm {n2} ({t2:.1f} s) vs cp 1 losses {l1} grad_norm {n1} ({t1:.1f} s) "
          f"(loss within {TRAIN_LOSS_REL}, grad_norm within {3 * TRAIN_LOSS_REL}, relative) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[cp-nccl] cp 2 training disagrees with cp 1")
    srv0, srv1 = results[0]["server"], results[1]["server"]
    http, failures = srv0["http"], []

    def check(good: bool, what: str) -> None:
        print(f"{what}: {'ok' if good else 'FAIL'}")
        if not good:
            failures.append(what)

    print(f"[cp-nccl server] {len(http['requests'])} concurrent requests (admissions of "
          f"{[len(a['ids']) for a in http['admitted']]} ids) over HTTP from rank 0, rank 1 "
          f"following: {[round(t, 3) for t in http['seconds']]} s")
    _lockstep_gates("cp-nccl server", http, [srv1["follower"]], srv0["replay"], check)
    check(srv1["replay"] == srv0["replay"], "[cp-nccl server] both ranks' in-process pools "
          "give the same rows")
    # the same server with the engine over tp 2: the weights and the cache's
    # kv heads sharded over the two cards, the collectives over NCCL
    srv0, srv1 = results[0]["tp_server"], results[1]["tp_server"]
    http = srv0["http"]
    print(f"[tp-nccl server] {len(http['requests'])} concurrent requests (admissions of "
          f"{[len(a['ids']) for a in http['admitted']]} ids) over HTTP from rank 0 of tp 2, rank "
          f"1 following: {[round(t, 3) for t in http['seconds']]} s")
    _lockstep_gates("tp-nccl server", http, [srv1["follower"]], srv0["replay"], check)
    check(srv1["replay"] == srv0["replay"], "[tp-nccl server] both ranks' in-process pools "
          "give the same rows")
    t0, t1 = results[0]["tp_ttft"], results[1]["tp_ttft"]
    check(t0["tokens"] == t1["tokens"] and t0["logits_ok"],
          f"[tp-nccl] {ttft_prompt}-id prompt on the {layers}-layer model at full width: TTFT tp "
          f"2 over two cards {t0['ttft']:.3f} s (rank 1 {t1['ttft']:.3f} s) against one card "
          f"{t0['ttft_one']:.3f} s; both ranks the same tokens {t0['tokens']}")
    if failures:
        raise AssertionError(f"[cp-nccl] the lockstep server: {failures}")
    # the Trainer at tp 2 over NCCL, a card a rank, against tp 1, under
    # phase_tp_train's gates (the planted fault included)
    if device == "cuda":
        # on four cards also tp 2 x tq 2 (2-D tp, a card a rank)
        phase_tp_train(backend="nccl", kernels=False, tq=2 if n_dev >= 4 else 1)
        # FSDP over NCCL: dp 2 on two cards; on four, dp 2 x tp 2 (the tp8 x
        # fsdp8 recipes' layout in miniature)
        phase_fsdp_train(backend="nccl", kernels=False)
        if n_dev >= 4:
            phase_fsdp_train(backend="nccl", tp=2, kernels=False)
        # pipeline stages over NCCL: pp 2 on two cards; on four, pp 2 x tp 2
        # (the tp8 x pp8 recipe's layout in miniature)
        phase_pp_train(backend="nccl", kernels=False)
        if n_dev >= 4:
            phase_pp_train(backend="nccl", tp=2, kernels=False)
        # FSDP inside pipeline stages over NCCL: dp 2 x pp 2 on four cards
        if n_dev >= 4:
            phase_pp_fsdp_train(backend="nccl")
        # expert parallelism over NCCL: dp 2 on two cards; on four, dp 2 x tp 2
        phase_ep_train(backend="nccl")
        if n_dev >= 4:
            phase_ep_train(backend="nccl", tp=2)
    print(json.dumps({"phase": "cp_nccl", "ran": True, "devices": n_dev}))


_STARTED = time.monotonic()  # the run's time budget: _collect prints the time spent


def _collect(when: str) -> None:
    """Free what the finished phases left: their engines, servers and
    trainers sit in reference cycles that hold card memory (tens of GB)
    until the garbage collector runs, which would otherwise come at a
    different point in every run."""
    import torch

    held = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[main] {when}: allocated {held / 1e9:.2f} GB, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB after a garbage collection; "
          f"{time.monotonic() - _STARTED:.1f} s since the script started")


def main() -> int:
    import dataclasses

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _nvidia_smi()
    print(smi)
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    from long_vita_tpu_torch.config import long_vita_14b

    phase_build()
    if "--nccl-only" in sys.argv[1:]:
        phase_cp_nccl()
        return 0
    # FSDP inside the pipeline's stages first, while this process holds
    # nothing on the card: its four processes' peaks together come within a
    # few GB of the card's 80 (PERF.md §4)
    pp_fsdp_counts = phase_pp_fsdp_train()["counts"]
    _collect("after the pp x FSDP training phase")
    kern = {
        "flash_fwd": phase_kernels(),
        "flash_fwd_quant": phase_kernels_quant(),
        "short_attn": phase_kernels_short(),
        **phase_kernels_bwd(),
        "w4_matmul": phase_kernels_w4(),
    }
    launches = dict.fromkeys(SOURCES, 0)

    def add(counts):
        for name in SOURCES:
            launches[name] += counts[name]

    add(pp_fsdp_counts)

    kern["fwd_lab"], counts = phase_fwd_lab()
    add(counts)
    phase_cp_kernels()
    add(phase_cp_attention())
    _collect("after the cp attention phases")
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    vit_work = tempfile.mkdtemp(prefix="chip_smoke_vit_", dir=build)
    try:
        add(phase_generic_vit(vit_work))
    finally:
        shutil.rmtree(vit_work, ignore_errors=True)
    _collect("after the generic towers")
    add(phase_moe())
    _collect("after the MoE phase")
    dev = torch.device("cuda")
    whole = _text_params(long_vita_14b(), dev)
    k1, _ = phase_serving(whole)
    launches["flash_fwd"] += k1
    # the phases after it take the decoder's first MAIN_LAYERS layers, for the
    # run's time; its bf16 last-row logits at that depth are theirs to hold to
    params, cfg = _decoder_prefix(whole, long_vita_14b(), MAIN_LAYERS)
    del whole
    bf16_logits = _prefill_logits(params, cfg)
    bits = _snapshot(params, set())
    add(phase_int4(params, cfg, dev, bf16_logits))
    add(phase_int8(params, cfg, dev, bf16_logits))
    changed = _moved(params, bits)
    print(f"[serve] the bf16 decoder after quantising it twice: {len(changed)} of "
          f"{len(bits)} tensors changed a bit")
    if changed:
        raise AssertionError(f"quantisation changed the bf16 weights: {sorted(changed)[:5]}")
    del bits
    add(phase_multimodal(params, cfg, dev))
    _collect("after the multimodal phase")  # the serving engines and their caches are gone
    # the cp and tp serving phases on the decoder's first SERVE_PREFIX
    # layers, so that the run keeps inside its time
    add(phase_cp_serve(params, cfg, dev, layers=SERVE_PREFIX))
    _collect("after the cp serving phase")
    add(phase_cp_server(*_decoder_prefix(params, cfg, SERVE_PREFIX), dev))
    _collect("after the cp server phase")
    add(phase_tp_serve(*_decoder_prefix(params, cfg, SERVE_PREFIX), dev,
                       cpxtp_layers=SERVE_PREFIX))
    _collect("after the tp serving phase")
    # the decoder is exported, freed and loaded back; the loaded one trains,
    # and the exported directory (~31 GB) serves the recipe phase last
    holder = [params]
    del params
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=build)
    ckpt = os.path.join(work, "ckpt")
    os.makedirs(ckpt)
    try:
        counts, params = phase_server(holder, cfg, dev, ckpt)
        add(counts)
        _collect("after the server phase")
        log = logging.getLogger("long_vita_tpu_torch.training.trainer")  # a line per step
        log.setLevel(logging.INFO)
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("[trainer] %(message)s"))
        log.addHandler(handler)
        counts, lv = phase_train(params, cfg, dev, tag="T1", seq_len=32768, videos=(64, 16),
                                 grid=(2, 3), freeze_vision=True, seed=SEED + 5)
        del lv
        add(counts)
        torch.cuda.empty_cache()
        counts, lv = phase_train(params, cfg, dev, tag="T2", seq_len=16384, videos=(16,),
                                 grid=(2, 3), freeze_vision=False, vit_lr_mult=0.1,
                                 seed=SEED + 6)
        add(counts)
        torch.cuda.empty_cache()
        phase_train_grads(lv, cfg, dev)
        del lv, params  # the loaded model: phase_recipe loads the directory again
        _collect("before the recipe phase")
        add(phase_recipe(ckpt, os.path.join(work, "recipe"), cfg, dev))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # the orbax stores from the training entry point, once the recipe phase's
    # directory is gone (the phase writes ~40 GB of stores)
    _collect("before the orbax phase")
    add(phase_orbax())
    # the training phases over a mesh, once the main process holds nothing on
    # the card (the tq geometry's four processes share it)
    _collect("before the tp training phase")
    tp_train = phase_tp_train(tq=2, steps=MESH_TRAIN_STEPS)
    add(tp_train["counts"])
    _collect("after the tp training phase")
    fsdp_train = phase_fsdp_train(steps=MESH_TRAIN_STEPS)
    add(fsdp_train["counts"])
    _collect("after the FSDP training phase")
    # its K1/K4/K5 check at the 72B's 64/8 heads is the FSDP phase's, on the
    # same inputs: run once
    pp_train = phase_pp_train(kernels=False)
    add(pp_train["counts"])
    _collect("after the pp training phase")
    add(phase_ep_train()["counts"])
    _collect("after the expert-parallel training phase")
    phase_autograd_probe()
    phase_cp_nccl()
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], **kern[name]}
        for name, (src, replaces) in SOURCES.items()
    ]}
    print(smi)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
