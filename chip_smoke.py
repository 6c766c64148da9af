#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device: require CUDA, turn TF32 off for matmuls and cuDNN, print the
   card's name and power limit as ``nvidia-smi`` reports them;
2. build: compile the three CUDA kernels from ``src/repro_torch/csrc``
   (one ``nvcc`` each, in parallel) and print the seconds and ptxas's
   report; count the int8 ``wgmma`` instructions (``IGMMA``) in the W8A8
   library's SASS and the TF32 ones (``HGMMA`` ... ``TF32``) in the flash
   library's with ``cuobjdump``, and fail if either has none;
3. kernels: find every shape the Stable Diffusion v1.4 UNet hands each
   kernel at batch = the engine's slot count and at batch = a phase 12
   shard's ``MESH_SPD`` slots (one w8a8 forward with and one without
   context each), then at each shape hold the kernel against its
   plain PyTorch version (w8a8 exactly; GroupNorm+swish within
   ``GN_ATOL``) and time kernel, plain version and PyTorch yardstick
   (``time_ms``; for our two kernels also the device time alone, replayed
   from a CUDA graph, ``graph_ms``, and for GroupNorm a plain copy of the
   same bytes), beside the card's bound for the same work, with the
   GroupNorm kernel's cluster plan (and how many of its clusters the card
   holds at once) and the W8A8 kernel's tile plan at each shape, and the
   W8A8 weight quantization with and without the K-major copy the kernel
   reads (glue on the dynamic path); likewise
   the flash-attention kernel at the InternLM2-1.8B prefill shape and
   the Granite-MoE prefill shape (head dim 64) and the reference kernel
   test's shapes (``FLASH_SHAPES``; bound at the TF32 peak times the
   kernel's passes, beside the float32 CUDA-core bound of the earlier
   CUDA-core kernel), and its grouped entry ``flash_attention_bshd`` at
   each prefill's own layout (InternLM2: q (4, 1000, 16, 128) against a
   slice of a (4, 1001, 8, 128) cache; Granite-MoE: (4, 1000, 16, 64)
   against (4, 1001, 16, 64); Whisper-base's decoder: (4, 1000, 8, 64)
   against (4, 1032, 8, 64); Qwen2-VL-7B, a GQA group of 7: (4, 1000,
   28, 128) against (4, 1032, 4, 128)), and the W8A8 kernel, bit-exact,
   at every (K, N) of the w8a8 forward of InternLM2, Granite-MoE,
   DeepSeek-V2-Lite, Mamba2 and Qwen2-VL at M = 4000 and M = 4
   (``torch._int_mm``
   refuses M <= 16, so at the decode step it is timed on M padded to 32
   rows);
   3b. prng: the threefry generator (``core/prng``) on the card against
   the CPU: bits equal bit for bit at an odd 1-D shape and at 1360 x
   1360, normals within its stated tolerance; the time of one 1360 x
   1360 normal draw;
4. small width: serve a guided fp32, an unguided fp32 and a w8a8 request
   of a tiny SD-shaped model through the engine on the card and on the
   CPU from the same seeds, and compare the images; 4b. the same for a
   w8a8+noise request (identical noise keys on both), a DeepCache request
   (cadence ``CACHE_INTERVAL``) and an early-exit request, with the same
   eval tallies, exits and energies; 4c. the serving CLI's function,
   ``launch/serve.py::serve_diffusion``, on its 16-px toy model with 4
   w8a8 requests all arriving at t=0, on the card with decode overlap
   (a second CUDA stream) and on the CPU in order: the same images within
   ``W8A8_ATOL``, tallies and energies;
5. full width: serve 8 requests (fp32 and w8a8, guided at 7.5 and not,
   10 DDIM steps) of SD v1.4 + the 512x512 VAE with random weights from
   seed 0 through the engine on 4 slots, check every image, and check
   with the kernels' launch counters that the diffusion path ran through
   its two kernels, as many times as its UNet evaluations require;
   5b. the serving features at full width: 8 more requests through an
   engine with DeepCache (``CACHE_INTERVAL``) and early exit
   (``EXIT_TOL``): fp32, w8a8 and w8a8+noise, cached and opted out,
   guided and not.  It checks every image, every energy against
   ``PhotonicAccountant.energy_evals`` of the request's own tallies, that
   a request exits early, that every step call launched each kernel as
   its plan requires (per evaluation of its kind, measured on the same
   model) and that skip steps launch no W8A8 kernel; it prints wall,
   req/s, p50, peak memory, PSNR by kind against the fp32 probe, the
   walls of a w8a8, a noisy, a refresh and a skip step over 4 slots, and
   the share of the noisy step its noise draws take;
6. LM small width: the smoke InternLM2 (head dim 16, GQA rep 2),
   Granite-MoE, DeepSeek-V2-Lite (MLA + MoE), Mamba2, Jamba (one
   hybrid unit), Whisper-base (encoder-decoder) and Qwen2-VL (M-RoPE)
   from one seed on the card and on the CPU, a prefill and 8 decode
   steps at fp32 and at w8a8, logits compared step by step; then one
   ``lm_apply`` of the smoke Qwen2-VL with ``inputs_embeds`` and (B, S,
   3) positions whose three streams differ;
7. LM full width: InternLM2-1.8B with random weights from seed 0 on the
   card.  First the check: the prefill's last-token logits (flash
   kernel) against ``lm_apply``'s at the last position (``gqa_core``) on
   the same 4 x 1000 prompt tokens, with 24 flash launches per prefill,
   all through ``flash_attention_bshd`` on the cache where it lies, and
   none per decode step.  Then the LM path: ``serve_lm`` (batch 4,
   a 1000-token prompt, 32 new tokens, float32) at fp32 and at w8a8,
   with the launch counters checked (24 flash launches per prefill, 120
   W8A8 launches per w8a8 forward), tokens in the vocabulary, and the
   prefill seconds, decode tokens/s and peak memory printed;
8. serve: the serving CLI's path at full width, ``serve_diffusion`` on
   SD v1.4 + VAE 512 (4 slots, w8a8, unguided over a random 77 x 768
   context, no quality probe), a Poisson trace replayed on the wall
   clock: (i) 8 requests at 4.0 req/s, 10 steps; (ii) the same with
   decode overlap; (iii) run (ii) traced, writing the Chrome trace, the
   JSONL log and the Prometheus text under ``build/serve-smoke`` (the
   trace must reconcile with the metrics); (iv) 16 requests at 4 steps
   offered at 5x the measured capacity against a queue of 2 x slots.
   It prints req/s, p50, p95, makespan, energy per request, decodes
   overlapped and peak memory for each run, and the traced rate beside
   the untraced one; it checks only counts: every request of (i)-(iii)
   completed with a finite 512x512x3 image, decodes overlapped in (ii)
   and (iii), the images of (ii) within ``W8A8_ATOL`` of (i)'s, the
   trace files agree with the run, completed + shed == offered in (iv)
   with the queue within its bound and at least one shed, and 45
   GroupNorm+swish launches per UNet evaluation and 128 W8A8 launches
   per conditional w8a8 one (64 unconditional).  Last, the walls of one
   w8a8 evaluation, one 512-px decode, the two in turn, and the decode
   on a second stream beside the evaluation: what overlap can hide;
12. mesh (run right after phase 8, on its pipeline): the slot-sharded
   engine, SD v1.4 + VAE 512 at w8a8, unguided over the shared context,
   over two logical shards on cuda:0 with ``MESH_SPD`` slots each (the
   counterpart of the reference's simulated devices: every line of the
   sharded path on the card, no scaling measured).  (i) 8 requests at 10
   steps, all at t=0, against an unsharded 4-slot engine: images within
   ``W8A8_ATOL``, UNet evaluations == shards x ticks and launches == the
   evaluations x the plan (45 and 128), every kernel shape the run
   gives among those phase 3 checked at its batch, decodes overlapped;
   req/s, p50, peak memory (one parameter replica for both shards) and
   the median wall of one full tick of each (of 7); (ii) the same 8
   through a 2 -> 1 resize after two ticks (2 slots, 2 parked) and a
   1 -> 2 grow serving 4 more: every image within ``W8A8_ATOL`` of
   (i)'s, 2 resizes; (iii) 3 w8a8 requests and a w8a8+noise one on
   slot 3 (shard 1, whose noise is
   rows 2-3 of the 4-slot draw), sharded against unsharded within
   ``W8A8_ATOL``, at the paper's noise model and at one thirty times as
   loud (``LOUD_NOISE``, ``LOUD_STEPS``); at each level also with the
   fault of shards drawing their noise at their own shape, whose gap is
   printed and, at 30x, must exceed ``WRONG_DRAW_MARGIN`` x
   ``W8A8_ATOL`` (the paper's level alone cannot tell the two apart);
   (iv) ``serve_diffusion(devices=1)``, 4 requests of a
   Poisson trace on a mesh of one, all completed; with two or more
   cards, (i) again over cuda:0 and cuda:1 (skipped, and said so, on
   one);
13. DDPM (run right after phase 12, before phase 9), on a float
   pipeline of its own (``DiffusionPipeline.init(0, SD_V1_4, VAE_512,
   timesteps=DDPM_TIMESTEPS)`` and a ``VAEEncoder(VAE_512)`` from seed
   0; phase 8's pipeline may hold pre-quantized weights, which take no
   gradient).  (a) phase 4's tiny model on the card against the CPU
   from one seed: ``generate(sampler='ddpm')`` at T = 16, fp32 guided
   and w8a8 unguided, within ``FP32_ATOL`` / ``W8A8_ATOL``;
   ``generate_deepcache`` at interval 1 against ``generate`` (within
   ``DEEPCACHE_EQ_ATOL``) and at interval 2 card against CPU;
   ``image_batch`` (``IMAGE_ATOL``), ``vae_encode`` mean and with a key,
   and ``ddpm_loss`` with the gradient of every UNet parameter (17
   GroupNorm+swish launches under the gradient, none zero); (b) the
   GroupNorm+swish kernel's gradient at every GroupNorm shape of the SD
   v1.4 UNet at batch 4 (phase 3's): ``GNSwish`` (kernel forward, plain
   backward) against autograd through ``gn_swish_plain`` within
   ``GN_GRAD_RTOL`` of the largest, and the time of forward plus
   backward of each per evaluation; (c) DDPM sampling of SD v1.4 + VAE
   512 at batch ``DDPM_BATCH`` over the ``DDPM_TIMESTEPS`` steps, fp32
   guided at 7.5 over a random 77 x 768 context and w8a8 unconditional:
   finite 512 x 512 x 3 images in [-1, 1], 45 GroupNorm+swish launches
   per evaluation and under w8a8 64 W8A8 per unconditional one (128 per
   conditional), wall, seconds a step and peak memory; (d) one
   latent-diffusion gradient step at full width: ``image_batch(512, 3,
   DDPM_TRAIN_BATCH)`` -> ``vae_encode`` with a key -> latents (4, 64,
   64, 4) -> ``ddpm_loss`` of the fp32 UNet over a random (4, 77, 768)
   context with ``launch.steps.train_params`` -> one step ``p - DDPM_LR
   * g``: every gradient finite and non-zero, the GroupNorm scales and
   biases included, the step lowering the loss at the same key on the
   same batch, 45 GroupNorm+swish launches per loss forward and no W8A8
   or flash launch; forward, backward and step seconds and peak memory.
   The phase's model is freed before phase 9 (the allocated memory
   printed);
9. LM families: every earlier model freed (the allocated memory printed
   first), Granite-MoE-1B-A400M, DeepSeek-V2-Lite-16B and Mamba2-2.7B in
   turn at full width and depth, each with phase 7's check (w8a8: within
   the run's quantization noise) and ``serve_lm`` runs at fp32 and w8a8:
   launches held to ``FAMILY_PLAN`` (Granite 24 flash per prefill and 48
   W8A8 per w8a8 forward; DeepSeek 0 and 189; Mamba2 0 and 256) and the
   W8A8 shapes of a prefill to phase 3's list; tokens, prefill s, decode
   tok/s and peak memory printed;
10. encoder-decoder and VLM: every earlier model freed, Whisper-base and
   Qwen2-VL-7B in turn at full width and depth, with phase 9's check
   (Whisper: the prefill against ``decode_train``, at fp32 only, since
   its steps ignore ``quant`` as the reference's do) and ``serve_lm``
   runs at fp32 and w8a8 (1000 stub frames for Whisper's encoder):
   launches held to ``ENCDEC_VLM_PLAN`` (Whisper 6 flash per prefill and
   0 W8A8, its w8a8 tokens equal to its fp32 tokens; Qwen2-VL 28 flash
   and 140 W8A8 per w8a8 forward);
11. train: every earlier model freed (the allocated memory printed
   first).  (a) the smoke InternLM2, Granite-MoE, DeepSeek-V2-Lite and
   Mamba2, 3 ``build_train_step`` steps at float32 on the card and on the
   CPU from the same parameters and ``token_batch`` batches, losses and
   grad norms within ``TRAIN_SMALL_RTOL``; then a ``Trainer`` on the
   card, 4 steps against 2, a checkpoint under ``build/train-smoke``, a
   new ``Trainer`` that restores it and 2 more (losses and parameters
   within ``TRAIN_RESUME_TOL``); (b) InternLM2-1.8B at full width and
   depth through ``Trainer.run``, remat 'full', 6 steps of 4 x 1024
   tokens, no checkpoint: finite losses and grad norms, the first loss
   within ``TRAIN_LOSS0_ATOL`` of ln V + 0.02^2 d / 2, and one more step
   on step 0's batch from the initial state lowering that batch's loss.
   It prints the parameter count, the first and the steady step's
   seconds, tokens/s, model FLOPs a step and their share of the float32
   peak, and the peak memory.  LM training runs no kernel of
   ``kernels/`` (the reference's loss takes the float projections and
   ``gqa_core``; the W8A8 and flash wrappers refuse a gradient, which
   they have no backward for): the counters must stay 0 across every
   train step;
14. sharded training on a ``DeviceMesh`` (``torch.distributed``), right
   after phase 11, launching no kernel (the counters must stay 0).  (a)
   InternLM2-1.8B at phase 11's full width, depth and traffic on a (1,
   1) mesh: one rank, ``nccl``, parameters and moments DTensors on
   cuda:0; losses and grad norms within ``MESH_ONE_RTOL`` of phase 11's
   single-device run, first and steady step seconds, tokens/s and peak
   memory beside phase 11's.  (b) ``MESH_RANKS`` ranks started with
   ``torch.multiprocessing`` (spawn), all on cuda:0 under ``gloo`` (the
   card's one GPU; NCCL refuses two ranks on one card), on a (2, 2)
   mesh: InternLM2-1.8B at full width cut to ``MESH_LAYERS`` layers,
   ``MESH_STEPS`` steps of ``MESH_BATCH`` x ``MESH_SEQ`` tokens; losses
   within ``MESH_RTOL`` of a single-device ``Trainer`` of the same
   config on the card; every rank's local shards on cuda; a checkpoint
   saved on (2, 2) under ``build/mesh-train`` restored onto (4, 1) and
   (1, 1) equal to the saved arrays bit for bit; the step seconds and
   each rank's peak memory.  First each rank runs every collective the
   phase uses on CUDA tensors under gloo (``GLOO_COLLECTIVES``) and
   the phase fails if one is missing.  (c) one train step of each smoke
   config of ``TRAIN_SMALL_ARCHS`` on that (2, 2) card mesh against the
   single-device step on the card, within ``MESH_RTOL``.  A rank that
   fails fails the phase.

Every phase prints its seconds (``[time]``).

Before the last line it prints one JSON object ``{"kernels": [...]}``.
For ``fused_gn_swish`` and ``w8a8_matmul``, ``ms`` / ``plain_ms`` /
``library_ms`` / ``bound_ms`` are the times of one UNet evaluation's
worth of that kernel's calls at batch 4 (the per-shape median times of
phase 3, weighted by launches per evaluation), ``max_abs_err`` the
largest over the batch-4 and the batch-``MESH_SPD`` shapes; for
``flash_attention`` they are one prefill's worth (24 launches at the
path shape), with ``passes`` (TF32 products per float32 product) and
``bound_f32_ms`` (the float32 CUDA-core bound) beside them.
``launches`` is each kernel's count over the runs of phases 5, 5b, 7, 8,
12, 13, 9 and 10 (phase 12's sharded runs only: a tick over two shards
launches each kernel's plan twice; phase 13's sampling runs (c) and its
gradient step (d), the loss before and after the step), each read from
counters set to 0 just before its run (phase 11's runs launch none,
which it checks).
The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, and the run then exits non-zero with no result; so does a run
without CUDA or without the repository beside this file.
"""
from __future__ import annotations

import collections
import copy
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

SLOTS = 4
STEPS = 10
GUIDANCE = 7.5
# GroupNorm+swish: kernel and plain version sum the slab in different
# orders; the mean and rstd then differ in the last float32 bits, which
# moves outputs of order 1-10 by a few 1e-6.
GN_ATOL = 1e-5
# card vs CPU: cuDNN and the CPU sum convolutions in different orders
# (float32 rounding, ~1e-6 per evaluation, carried over the steps); under
# w8a8 such a difference can move one int8 rounding at a tie, worth about
# one LSB of an activation
FP32_ATOL = 1e-4
W8A8_ATOL = 1e-3
# flash attention, float32 out: the reference kernel test's tolerance
# (tiles of 64 keys against the plain version's blocks of 128);
# bf16 out: both round a float32 result, so one bf16 ulp of each element
# (2^-7 |ref|) plus that float32 difference
FLASH_ATOL = 2e-5
# LM, small width, card against CPU: fp32 as for the diffusion model; under
# w8a8 a ~1e-7 difference can move an int8 rounding at a tie, and the
# moved activation changes the per-row scales of every later product, so
# the gap cascades (on the CPU, flash against gqa_core in 24 such layers
# at d_model 64 moved logits by 4.5e-3; this model has 2)
LM_SMALL_FP32_ATOL = 1e-4
LM_SMALL_W8A8_ATOL = 1e-2
# LM, full width, prefill (flash kernel) against lm_apply (gqa_core) on
# the card.  fp32: attention summed in another order moves each attention
# output by ~1e-7 relative, which 24 layers carry to ~1e-5 on logits of
# order 1 (the same comparison on the CPU: 1.3e-6 at d_model 512 with 24
# layers, 3.2e-6 at d_model 2048 with 4).  w8a8: the cascade above; on the
# CPU the same comparison measured 1.1% (d_model 512, 24 layers, 500
# tokens) and 1.8% (d_model 2048, 4 layers) of the largest logit, so the
# bound is relative to that logit
LM_FULL_FP32_ATOL = 1e-3
LM_FULL_W8A8_RTOL = 0.1
# ... and for every LM under w8a8, the gap may not exceed the quantization
# noise itself: the distance of lm_apply's w8a8 logits from its fp32 ones
# in the same run, in max abs and in relative L2.  The cascade grows with
# depth to that level and no further (``scripts/torch_lm_gap.py``: on the
# card, DeepSeek-V2-Lite at full width, 1 / 3 / 9 / 27 layers, gap
# relative L2 1.3e-6 / 1.6e-2 / 9.7e-2 / 6.7e-2 against a distance of
# 2.3e-2 / 0.166 / 0.163 / 0.121); its 27-layer gap is 10.4% of the
# largest logit, beyond the dense LM's 10%, which phase 9 does not apply

# serving features at full width: the shared DeepCache cadence and the
# engine's early-exit tolerance (one request asks for a looser one, so at
# least one exit happens whatever the random weights' x0 movement is)
CACHE_INTERVAL = 3
EXIT_TOL = 0.05
LOOSE_EXIT_TOL = 10.0
# the small serving-features check: DeepCache and early exit on the card
# and the CPU take the same decisions (exact tallies); the noisy request's
# draws agree to prng's normal tolerance, the rest as the W8A8 check
FEATURES_SEEDS = (20, 21, 22)

# the serving CLI's path (``serve_diffusion``), phase 8: SD v1.4 at w8a8,
# unguided, 10 steps on 4 slots, at 4.0 req/s, about 1.2x the 3.3 req/s
# that a 121 ms w8a8 step over 4 slots serves, so the slots stay full;
# then 5x the measured capacity at 4 steps against a queue of 2x slots
SERVE_REQUESTS, SERVE_RATE = 8, 4.0
OVERLOAD, OVERLOAD_REQUESTS, OVERLOAD_STEPS = 5.0, 16, 4
SERVE_OUT = ROOT / 'build' / 'serve-smoke'
# phase 12, the slot-sharded engine: two logical shards on cuda:0 with 2
# slots each (SLOTS in all); the CLI's mesh of one replays 4 requests
MESH_SPD = 2
MESH_CLI_REQUESTS = 4
# phase 12 (iii)'s negative control: the paper's noise model thirty times
# as loud (crosstalk 30 dB up), as the CPU engine tests use it, at 2
# steps; shards drawing their noise at their own shape must miss
# W8A8_ATOL by WRONG_DRAW_MARGIN there
LOUD_NOISE = dict(sigma_w_lsb=9.0, sigma_x_lsb=6.0, sigma_pd_lsb=15.0,
                  crosstalk_db_per_channel=2.0)
LOUD_STEPS = 2
WRONG_DRAW_MARGIN = 5

# phase 13, DDPM.  (a) card against CPU on phase 4's tiny model:
# generate_deepcache at interval 1 is generate (every step a refresh, the
# full pass: the reference test's 1e-5); image_batch's bicubic weights
# and two contractions in float32, summed in another order (the CPU
# against the reference: 7.7e-7 at 17 px)
DEEPCACHE_EQ_ATOL = 1e-5
IMAGE_ATOL = 2e-6
# (b) GNSwish's gradient (kernel forward, plain backward) against
# autograd through gn_swish_plain: float32 sums over up to 69,632
# elements a group and 16,384 positions a channel in other orders, from
# forwards ~3e-6 apart; relative to the largest gradient
GN_GRAD_RTOL = 1e-4
# (c) full-width DDPM sampling: the reference's DiffusionPipeline.init
# with timesteps=100 (1000 would take 10x the time for the same per-step
# work), batch 2; (d) the gradient step at batch 4, one plain step
# p - lr * g.  lr: a narrow SD-shaped UNet (base_ch 32 / 64, 16 px) on
# the CPU lowered its loss at 1e-3 within 1e-5 of the first-order
# prediction; the gradient's square norm grows with width (1.4, 3.2)
DDPM_TIMESTEPS = 100
DDPM_BATCH = 2
DDPM_TRAIN_BATCH = 4
DDPM_LR = 1e-3

LM_ARCH = 'internlm2-1.8b'
LM_BATCH, LM_PROMPT, LM_TOKENS = 4, 1000, 32
SMALL_LM_STEPS = 8
# phase 9: the MoE, MLA and SSM families at full width, phase 7's traffic;
# per family the plan: flash launches per prefill, W8A8 launches per
# w8a8 forward (Granite: wq, wo x 24; DeepSeek: MLA wq, w_dkv, w_kpe, wo
# and the shared experts' gate, up, down x 27; Mamba2: in_z, in_xbc,
# in_dt, out_proj x 64; routers and experts stay float)
FAMILY_PLAN = {'granite-moe-1b-a400m': (24, 48),
               'deepseek-v2-lite-16b': (0, 189),
               'mamba2-2.7b': (0, 256)}
# phase 10, the same for the encoder-decoder and the VLM: Whisper's 6
# decoder self-attention layers (its encoder and cross-attention run
# gqa_core, as the reference's) and no W8A8 (its steps ignore quant, as
# the reference's); Qwen2-VL: wq, wo, gate, up, down x 28
ENCDEC_VLM_PLAN = {'whisper-base': (6, 0), 'qwen2-vl-7b': (28, 140)}
# small width, card against CPU (phase 6): the dense LM and the smoke
# configs of every other family; Jamba runs only here (398.6 B
# parameters, 1485 GiB in float32, fit no card)
SMALL_LM_ARCHS = (LM_ARCH, 'granite-moe-1b-a400m', 'deepseek-v2-lite-16b',
                  'mamba2-2.7b', 'jamba-1.5-large-398b', 'whisper-base',
                  'qwen2-vl-7b')
# phase 11, training.  (a) the smoke configs of these families, 3 train
# steps at float32 on the card and on the CPU from one set of parameters:
# losses and grad norms within 1e-4 relative (float32 sums in another
# order, ~1e-6, which Adam's first step can turn into +-lr on a parameter
# whose gradient is ~1e-9 from zero); then a Trainer on the card, 4 steps
# against 2, a checkpoint under build/train-smoke, a restore and 2 more:
# the same kernels on the same values, only the atomic adds of the
# embedding's gradient in another order, so losses within 1e-6 relative
# and parameters within 1e-6
TRAIN_SMALL_ARCHS = (LM_ARCH, 'granite-moe-1b-a400m', 'deepseek-v2-lite-16b',
                     'mamba2-2.7b')
TRAIN_SMALL_STEPS = 3
TRAIN_SMALL_RTOL = 1e-4
TRAIN_RESUME_TOL = 1e-6
TRAIN_OUT = ROOT / 'build' / 'train-smoke'
# (b) InternLM2-1.8B at full width and depth, float32, remat 'full':
# serving's batch 4 at about its 1000-token prompt, 4096 tokens a step, 6
# steps.  The first loss: the hidden state leaves the final RMSNorm with
# unit RMS and the head is drawn with stddev 0.02, so the logits are ~N(0,
# 0.02^2 d_model) and the expected cross-entropy is ln V + 0.02^2 d / 2 =
# 11.845 (ln V = 11.435); 0.2 covers the draw (a 2-layer cut of the model
# on the CPU: 11.812)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 6
TRAIN_LOSS0_ATOL = 0.2
# phase 14, sharded training.  (a) phase 11 (b)'s run on a (1, 1) mesh:
# the same float32 operations on DTensors whose placements are all
# Replicate; only the grad norm's sum runs in another order (per leaf,
# then over the mesh), so losses and grad norms within 1e-5 relative.
# (b), (c) four gloo ranks on cuda:0 on a (2, 2) mesh: the matmuls reduce
# over shards, float32 sums in another order, so losses and grad norms
# within 1e-4 relative, as phase 11 (a)'s card against the CPU
MESH_ONE_RTOL = 1e-5
MESH_RANKS, MESH_SHAPE = 4, (2, 2)
MESH_LAYERS, MESH_BATCH, MESH_SEQ, MESH_STEPS = 2, 4, 256, 3
MESH_RTOL = 1e-4
MESH_OUT = ROOT / 'build' / 'mesh-train'
MESH_TIMEOUT_S = 600
# (BH, S, T, d, causal, q dtype, k/v dtype): the InternLM2-1.8B prefill
# (4 x 16 heads, 1000 tokens, not a multiple of the 64-row tile) in the
# path's float32, all-bf16, and float32 q over a bf16 cache; the
# Granite-MoE prefill (4 x 16 heads of 64); then the reference kernel
# test's shapes at B x H = 2 x 3
FLASH_SHAPES = [
    (64, 1000, 1000, 128, True, 'float32', 'float32'),
    (64, 1000, 1000, 128, True, 'bfloat16', 'bfloat16'),
    (64, 1000, 1000, 128, True, 'float32', 'bfloat16'),
    (64, 1000, 1000, 64, True, 'float32', 'float32'),
    (6, 128, 128, 64, False, 'float32', 'float32'),
    (6, 128, 128, 64, True, 'float32', 'float32'),
    (6, 256, 256, 32, True, 'float32', 'float32'),
    (6, 128, 384, 64, False, 'float32', 'float32'),
    (6, 100, 100, 64, True, 'float32', 'float32'),
]

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12           # dense int8 tensor-core peak
F32_OPS_PER_S = 67e12              # float32 outside the tensor cores
TF32_OPS_PER_S = 495e12            # dense TF32 tensor-core peak
TPU_KERNELS = {
    'fused_gn_swish': ('src/repro_torch/csrc/fused_gn_swish.cu',
                       'src/repro/kernels/fused_gn_swish.py:31'),
    'w8a8_matmul': ('src/repro_torch/csrc/w8a8_matmul.cu',
                    'src/repro/kernels/w8a8_matmul.py:52'),
    'flash_attention': ('src/repro_torch/csrc/flash_attention.cu',
                        'src/repro/kernels/flash_attention.py:75'),
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(torch, fn, reps: int = 20, calls: int = 10) -> float:
    """Device time of one call: CUDA events around ``calls`` back-to-back
    calls, divided by ``calls``; the median of ``reps`` such runs, after a
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def graph_ms(torch, fn, calls: int = 20) -> float:
    """Device time of one call without the host: ``calls`` calls captured
    once in a CUDA graph, the replay timed by ``time_ms``.  Beside
    ``time_ms`` of the same call it shows how much of a small kernel's
    time is the wrapper's host work."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(torch, graph.replay, reps=10, calls=3) / calls


def record_shapes(ops, fn):
    """Run ``fn`` with the kernel wrappers recording the shapes they are
    called with; returns {kernel: Counter(shape key)}."""
    seen = {'fused_gn_swish': collections.Counter(),
            'w8a8_matmul': collections.Counter()}
    gn, mm = ops.fused_gn_swish, ops.w8a8_matmul

    def gn_rec(x, scale, bias, *, groups=32):
        C = x.shape[-1]
        g = min(groups, C)
        while C % g:
            g -= 1
        seen['fused_gn_swish'][tuple(x.shape) + (g,)] += 1
        return gn(x, scale, bias, groups=groups)

    def mm_rec(x, w):
        seen['w8a8_matmul'][(x.numel() // x.shape[-1], x.shape[-1],
                             w.shape[-1])] += 1
        return mm(x, w)

    ops.fused_gn_swish, ops.w8a8_matmul = gn_rec, mm_rec
    try:
        fn()
    finally:
        ops.fused_gn_swish, ops.w8a8_matmul = gn, mm
    return seen


def find_cuobjdump():
    """The toolkit's ``cuobjdump``, or the copy in Triton's package."""
    found = shutil.which('cuobjdump')
    home = Path(os.environ.get('CUDA_HOME', '/usr/local/cuda'))
    if not found and (home / 'bin' / 'cuobjdump').exists():
        found = str(home / 'bin' / 'cuobjdump')
    if not found:
        try:
            import triton
        except ImportError:
            return None
        path = Path(triton.__file__).parent / 'backends/nvidia/bin/cuobjdump'
        found = str(path) if path.exists() else None
    return found


def count_igmma(lib: Path) -> int:
    """Int8 ``wgmma`` instructions (SASS ``IGMMA``) in a built library."""
    tool = find_cuobjdump()
    check(tool is not None, 'cuobjdump not found (CUDA toolkit or Triton)')
    sass = subprocess.run([tool, '-sass', str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    return sum('IGMMA' in line for line in sass.splitlines())


def count_hgmma_tf32(lib: Path) -> int:
    """TF32 ``wgmma`` instructions (SASS ``HGMMA`` with ``TF32``)."""
    tool = find_cuobjdump()
    check(tool is not None, 'cuobjdump not found (CUDA toolkit or Triton)')
    sass = subprocess.run([tool, '-sass', str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    return sum('HGMMA' in line and 'TF32' in line
               for line in sass.splitlines())


def w8a8_row(torch, gen, M: int, K: int, N: int):
    """The W8A8 kernel at (M, K) x (K, N) on random operands, K-major and
    K-padded as the wrapper hands them over: held bit-exact against the
    plain version on the unpadded (K, N) operands, then kernel, plain and
    ``torch._int_mm`` timed beside the bound, and the weight's quantization
    with and without the K-major copy.  Returns (row, max abs err)."""
    from repro_torch.core.quantization import quantize, quantize_per_channel
    from repro_torch.kernels import w8a8_matmul as mmk
    xm = torch.randn((M, K), device='cuda', generator=gen)
    wm = torch.randn((K, N), device='cuda', generator=gen)
    xq, wq = quantize(xm, axis=(1,)), quantize_per_channel(wm)
    ws = wq.scale.reshape(1, N).contiguous()
    xp, wt = mmk.pad_k(xq.q), mmk.kmajor_weight(wq.q)
    out = mmk.w8a8_matmul_kernel(xp, xq.scale, wt, ws)
    ref = mmk.w8a8_matmul_plain(xq.q, xq.scale, wq.q, ws)
    err = (out - ref).abs().max().item()
    check(torch.equal(out, ref), f'w8a8_matmul {(M, K, N)}: not bit-exact, '
          f'max abs err {err}')
    row = {
        'ms': time_ms(torch, lambda: mmk.w8a8_matmul_kernel(
            xp, xq.scale, wt, ws)),
        'device_ms': graph_ms(torch, lambda: mmk.w8a8_matmul_kernel(
            xp, xq.scale, wt, ws)),
        'plain_ms': time_ms(torch, lambda: mmk.w8a8_matmul_plain(
            xq.q, xq.scale, wq.q, ws)),
        'wquant_ms': time_ms(torch, lambda: quantize_per_channel(wm)),
        'wquant_kmajor_ms': time_ms(
            torch, lambda: mmk.quantize_weight_kmajor(wm)),
    }
    # yardstick only, the port never calls it; it refuses M <= 16, so
    # there it runs on the rows padded with zeros to 32
    xl = xq.q
    if M <= 16:
        xl = torch.cat([xq.q, xq.q.new_zeros((32 - M, K))])
    row['library_rows'] = xl.shape[0]
    try:
        row['library_ms'] = time_ms(torch, lambda: torch._int_mm(xl, wq.q))
    except RuntimeError as e:
        print(f'[kernels] torch._int_mm {(xl.shape[0], K, N)}: {e}')
        row['library_ms'] = None
    plan = mmk.w8a8_plan(M, N, K)
    row['plan'] = {'swap': plan.swap, 'bn': plan.bn, 'split': plan.split,
                   'blocks': plan.blocks,
                   'device_launches': plan.device_launches}
    nbytes = M * K + K * N + 4 * M + 4 * N + 4 * M * N
    b_bytes = nbytes / HBM_BYTES_PER_S
    b_ops = 2 * M * N * K / INT8_OPS_PER_S
    row['bound_ms'] = max(b_bytes, b_ops) * 1e3
    row['bound_by'] = 'bytes' if b_bytes >= b_ops else 'operations'
    return row, err


def phase_kernels(torch, ops, pipe, context):
    """Phase 3: every path shape, kernel vs plain, with times: the UNet's
    at batch ``SLOTS`` (an unsharded engine) and at batch ``MESH_SPD``
    (a shard of phase 12).  Returns the batch-``SLOTS`` summary (its
    ``max_abs_err`` over both batches), the launches per evaluation and
    the shapes checked, {rows: {kernel: set}}."""
    import ctypes

    from repro_torch.kernels import build
    occupancy = build.load('fused_gn_swish').fused_gn_swish_max_clusters
    occupancy.argtypes = [ctypes.c_int] * 3
    occupancy.restype = ctypes.c_int
    cfg = pipe.unet_cfg

    def shapes_at(rows):
        x = torch.randn((rows, cfg.img_size, cfg.img_size, cfg.in_ch),
                        device='cuda')
        t = torch.full((rows,), 500, device='cuda')
        with torch.no_grad():
            cond = record_shapes(ops, lambda: pipe.unet(
                x, t, context[:rows], 'w8a8'))
            unc = record_shapes(ops, lambda: pipe.unet(x, t, None, 'w8a8'))
        return cond, unc

    cond, unc = shapes_at(SLOTS)
    per_eval = {k: sum(v.values()) for k, v in cond.items()}
    per_eval['w8a8_matmul_uncond'] = sum(unc['w8a8_matmul'].values())
    print(f'[kernels] launches per UNet evaluation: {per_eval}')
    gen = torch.Generator(device='cuda').manual_seed(0)
    summary = sd_kernel_rows(torch, gen, occupancy, cond,
                             f'per UNet evaluation at batch {SLOTS}')
    # a shard's evaluation: the same plan at MESH_SPD rows; shapes the
    # unconditional pass alone gives are checked too (per_eval 0 there)
    s_cond, s_unc = shapes_at(MESH_SPD)
    check({k: sum(v.values()) for k, v in s_cond.items()}
          == {k: per_eval[k] for k in s_cond}
          and sum(s_unc['w8a8_matmul'].values())
          == per_eval['w8a8_matmul_uncond'],
          f'batch {MESH_SPD}: launches per evaluation differ from batch '
          f'{SLOTS}\'s')
    shard = sd_kernel_rows(
        torch, gen, occupancy,
        {k: collections.Counter({**dict.fromkeys(s_unc[k], 0), **s_cond[k]})
         for k in s_cond},
        f'per shard evaluation at batch {MESH_SPD} (phase 12)')
    checked = {SLOTS: {}, MESH_SPD: {}}
    for name in summary:
        summary[name]['max_abs_err'] = max(summary[name]['max_abs_err'],
                                           shard[name]['max_abs_err'])
        checked[SLOTS][name] = set(cond[name])
        checked[MESH_SPD][name] = set(s_cond[name]) | set(s_unc[name])
    return summary, per_eval, checked


def sd_kernel_rows(torch, gen, occupancy, shapes, label):
    """Phase 3's rows for the UNet's kernels at ``shapes`` ({kernel:
    Counter(shape) of launches per evaluation}): each shape held against
    the plain version and timed beside its bound; returns per kernel the
    launch-weighted totals, the largest error and what bounds them."""
    import torch.nn.functional as F
    from repro_torch.kernels import fused_gn_swish as gnk
    summary = {}
    for name in ('fused_gn_swish', 'w8a8_matmul'):
        tot = {'ms': 0.0, 'device_ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0,
               'library_ms': 0.0}
        tot.update(dict.fromkeys(('wquant_ms', 'wquant_kmajor_ms')
                                 if name == 'w8a8_matmul' else ('copy_ms',),
                                 0.0))
        errs, bound_by = [], set()
        for shape, count in sorted(shapes[name].items()):
            if name == 'fused_gn_swish':
                N, H, W, C, g = shape
                xg = torch.randn((N, H, W, C), device='cuda', generator=gen)
                sc = torch.randn(C, device='cuda', generator=gen)
                bi = torch.randn(C, device='cuda', generator=gen)
                out = gnk.fused_gn_swish_kernel(xg, sc, bi, g)
                ref = gnk.gn_swish_plain(xg, sc, bi, g)
                err = (out - ref).abs().max().item()
                check(err <= GN_ATOL, f'fused_gn_swish {shape}: max abs err '
                      f'{err} > {GN_ATOL}')
                xc = xg.permute(0, 3, 1, 2)
                row = {
                    'ms': time_ms(torch, lambda: gnk.fused_gn_swish_kernel(
                        xg, sc, bi, g)),
                    'device_ms': graph_ms(torch, lambda: gnk.
                                          fused_gn_swish_kernel(xg, sc, bi,
                                                                g)),
                    'plain_ms': time_ms(torch, lambda: gnk.gn_swish_plain(
                        xg, sc, bi, g)),
                    'library_ms': time_ms(torch, lambda: F.silu(
                        F.group_norm(xc, g, sc, bi, 1e-5))),
                    # the same bytes read and written once by a plain copy
                    'copy_ms': time_ms(torch, xg.clone),
                }
                nbytes = 2 * N * H * W * C * 4 + 2 * C * 4
                b_bytes = nbytes / HBM_BYTES_PER_S
                # ~10 float operations per element: two sums, normalise,
                # affine, exp, add, divide
                b_ops = 10 * N * H * W * C / F32_OPS_PER_S
                row['bound_ms'] = max(b_bytes, b_ops) * 1e3
                row['bound_by'] = ('bytes' if b_bytes >= b_ops
                                   else 'operations')
                plan = gnk.gn_plan(H * W, C // g)
                # clusters the card holds at once: how many waves the grid
                # of N * g clusters takes
                resident = occupancy(C // g, plan.cluster, plan.smem)
                check(resident > 0, f'fused_gn_swish {shape}: occupancy '
                      f'query failed ({resident})')
                row['plan'] = {'cluster': plan.cluster, 'chunk': plan.chunk,
                               'resident': plan.resident,
                               'smem': plan.smem,
                               'blocks': N * g * plan.cluster,
                               'clusters_at_once': resident,
                               'waves': N * g / resident}
            else:
                row, err = w8a8_row(torch, gen, *shape)
            bound_by.add(row['bound_by'])
            errs.append(err)
            print('[kernels] shape ' + json.dumps(
                {'kernel': name, 'shape': list(shape), 'per_eval': count,
                 'max_abs_err': err, 'kernel_ms': row['ms'],
                 'device_ms': row['device_ms'],
                 'plain_ms': row['plain_ms'], 'library_ms': row['library_ms'],
                 'bound_ms': row['bound_ms'], 'bound_by': row['bound_by'],
                 'plan': row['plan'],
                 **{k: row[k] for k in ('wquant_ms', 'wquant_kmajor_ms',
                                        'copy_ms') if k in row}}))
            for k in tot:
                if tot[k] is None or row[k] is None:
                    tot[k] = None
                else:
                    tot[k] += count * row[k]
        summary[name] = dict(tot, max_abs_err=max(errs),
                             bound_by='bytes' if bound_by == {'bytes'}
                             else 'operations')
        print(f'[kernels] {name}: {label}: ' + json.dumps(summary[name]))
    return summary


def flash_ops(BH: int, S: int, T: int, d: int, causal: bool) -> int:
    """Float operations of attention on these shapes: 2 d per score and 2 d
    per probability-value product, over the (q, k) pairs the mask keeps
    (k <= q under ``causal``)."""
    pairs = sum(min(i + 1, T) for i in range(S)) if causal else S * T
    return 4 * BH * d * pairs


def flash_bound(fak, q, k, v, heads: int, S: int, T: int,
                causal: bool) -> dict:
    """The card's bound for attention on these operands: bytes (each
    operand read once, the output written once) or operations, the
    larger; the operations at the TF32 peak times the kernel's passes
    (``bound_ms``), and at the float32 CUDA-core peak (``bound_f32_ms``,
    the bound of the earlier CUDA-core kernel)."""
    ops = flash_ops(heads, S, T, q.shape[-1], causal)
    passes = fak.PASSES[k.dtype]
    b_bytes = (2 * q.numel() * q.element_size()
               + k.numel() * k.element_size()
               + v.numel() * v.element_size()) / HBM_BYTES_PER_S
    b_ops = passes * ops / TF32_OPS_PER_S
    return {'bound_ms': max(b_bytes, b_ops) * 1e3,
            'bound_by': 'bytes' if b_bytes >= b_ops else 'operations',
            'passes': passes,
            'bound_f32_ms': max(b_bytes, ops / F32_OPS_PER_S) * 1e3}


def check_flash(what: str, out, ref, q_dtype) -> float:
    """float32 out within ``FLASH_ATOL`` of the plain version; bf16 out
    within one bf16 ulp plus that.  Returns the max abs error."""
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    if q_dtype == 'float32':
        check(err <= FLASH_ATOL, f'{what}: max abs err {err} > {FLASH_ATOL}')
    else:
        over = (diff - 2.0 ** -7 * ref.float().abs()).max().item()
        check(over <= FLASH_ATOL, f'{what}: {over} beyond one bf16 ulp')
    return err


def phase_flash(torch, n_layers: int, lm_cfgs):
    """Phase 3, flash attention: kernel vs plain at ``FLASH_SHAPES``, with
    times; then the grouped entry at each LM's prefill layout
    (``lm_cfgs``: (config, cache rows) of InternLM2-1.8B, Granite-MoE,
    Whisper-base, Qwen2-VL-7B).  Returns the InternLM2 per-prefill
    summary (``n_layers`` launches at the path shape, the first
    entry)."""
    import ctypes

    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fak
    smem = build.load('flash_attention').flash_attention_smem
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    print('[kernels] flash_attention dynamic shared memory per block: '
          + json.dumps({d: smem(d) for d in fak.HEAD_DIMS}))
    gen = torch.Generator(device='cuda').manual_seed(1)
    rows = []
    for BH, S, T, d, causal, qt, kvt in FLASH_SHAPES:
        q = torch.randn((BH, S, d), device='cuda', generator=gen)
        k = torch.randn((BH, T, d), device='cuda', generator=gen)
        v = torch.randn((BH, T, d), device='cuda', generator=gen)
        q = q.to(getattr(torch, qt))
        k, v = k.to(getattr(torch, kvt)), v.to(getattr(torch, kvt))
        out = fak.flash_attention_kernel(q, k, v, causal=causal)
        ref = fak.flash_attention_plain(q, k, v, causal=causal)
        err = check_flash(f'flash_attention {(BH, S, T, d)} causal={causal} '
                          f'{qt}/{kvt}', out, ref, qt)
        row = {
            'ms': time_ms(torch, lambda: fak.flash_attention_kernel(
                q, k, v, causal=causal)),
            'device_ms': graph_ms(torch, lambda: fak.flash_attention_kernel(
                q, k, v, causal=causal)),
            'plain_ms': time_ms(torch, lambda: fak.flash_attention_plain(
                q, k, v, causal=causal)),
            # yardstick only: the port never calls it; it takes one dtype
            'library_ms': time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal)) if qt == kvt else None,
            **flash_bound(fak, q, k, v, BH, S, T, causal),
        }
        row['max_abs_err'] = err
        rows.append(row)
        print('[kernels] shape ' + json.dumps(
            {'kernel': 'flash_attention', 'shape': [BH, S, T, d],
             'causal': causal, 'dtypes': [qt, kvt], 'max_abs_err': err,
             'kernel_ms': row['ms'], 'device_ms': row['device_ms'],
             'plain_ms': row['plain_ms'], 'library_ms': row['library_ms'],
             'bound_ms': row['bound_ms'], 'bound_by': row['bound_by'],
             'passes': row['passes'], 'bound_f32_ms': row['bound_f32_ms']}))
    path = rows[0]
    summary = {k: n_layers * path[k]
               for k in ('ms', 'device_ms', 'plain_ms', 'bound_ms',
                         'bound_f32_ms', 'library_ms')}
    summary['bound_by'] = path['bound_by']
    summary['passes'] = path['passes']
    summary['max_abs_err'] = max(r['max_abs_err'] for r, sh in
                                 zip(rows, FLASH_SHAPES) if sh[5:] ==
                                 ('float32', 'float32'))
    print(f'[kernels] flash_attention: per prefill ({n_layers} launches at '
          f'{FLASH_SHAPES[0][:4]}): ' + json.dumps(summary))

    # the grouped entry at each prefill's layout: q (B, S, H, d) against
    # the rows just written into a (B, rows, G, d) float32 cache, as they
    # lie
    for lm_cfg, rows in lm_cfgs:
        err = flash_bshd_row(torch, fak, F, gen, lm_cfg, rows)
        summary['max_abs_err'] = max(summary['max_abs_err'], err)
    return summary


def flash_bshd_row(torch, fak, F, gen, lm_cfg, rows: int) -> float:
    """``flash_attention_bshd`` at ``lm_cfg``'s prefill layout against the
    first S of a cache of ``rows`` rows, kernel vs plain, with times and
    the per-prefill total; returns the error."""
    B, S = LM_BATCH, LM_PROMPT
    H, G, d = (lm_cfg.n_heads, lm_cfg.n_kv_heads * lm_cfg.kv_repeat,
               lm_cfg.hd)
    per_prefill = attention_layers(lm_cfg)
    q = torch.randn((B, S, H, d), device='cuda', generator=gen)
    ck, cv = (torch.randn((B, rows, G, d), device='cuda', generator=gen)
              for _ in range(2))
    k, v = ck[:, :S], cv[:, :S]
    out = fak.flash_attention_bshd_kernel(q, k, v, causal=True)
    ref = fak.flash_attention_bshd_plain(q, k, v, causal=True)
    err = check_flash(f'flash_attention_bshd {lm_cfg.name} '
                      f'{(B, S, H, G, d)}', out, ref, 'float32')
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:                # yardstick only: the port never calls it
        library = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
    except (RuntimeError, TypeError) as e:
        print(f'[kernels] SDPA with enable_gqa: {e}')
        library = None
    row = {'ms': time_ms(torch, lambda: fak.flash_attention_bshd_kernel(
               q, k, v, causal=True)),
           'device_ms': graph_ms(torch, lambda: fak.
                                 flash_attention_bshd_kernel(
                                     q, k, v, causal=True)),
           'plain_ms': time_ms(torch, lambda: fak.flash_attention_bshd_plain(
               q, k, v, causal=True)),
           'library_ms': library,
           **flash_bound(fak, q, k, v, B * H, S, S, True)}
    print('[kernels] shape ' + json.dumps(
        {'kernel': 'flash_attention_bshd', 'lm': lm_cfg.name,
         'shape': [B, S, H, G, d], 'cache_rows': rows, 'causal': True,
         'dtypes': ['float32', 'float32'], 'max_abs_err': err,
         'kernel_ms': row['ms'], 'device_ms': row['device_ms'],
         'plain_ms': row['plain_ms'], 'library_ms': row['library_ms'],
         'bound_ms': row['bound_ms'], 'bound_by': row['bound_by'],
         'passes': row['passes'], 'bound_f32_ms': row['bound_f32_ms'],
         'per_prefill_launches': per_prefill,
         **{f'per_prefill_{k}': None if row[k] is None
            else per_prefill * row[k]
            for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms')}}))
    return err


def lm_w8a8_shapes(cfg) -> collections.Counter:
    """(K, N) -> W8A8 launches per forward of ``cfg`` under ``--w8a8``:
    attention wq, wo; MLA wq, w_dkv, w_kpe, wo (``w_uk``/``w_uv`` stay
    float); Mamba in_z, in_xbc, in_dt, out_proj; a dense MLP's or the
    shared experts' up, gate, down (routers and experts stay float).
    None for the encoder-decoder, whose steps ignore ``quant`` as the
    reference's do."""
    from repro_torch.models.transformer import _block_kinds, n_scan_steps
    if cfg.family == 'encdec':
        return collections.Counter()
    d = cfg.d_model
    per_unit = collections.Counter()
    for mixer, ffn in _block_kinds(cfg):
        if mixer == 'A':
            dq = cfg.n_heads * cfg.hd
            per_unit.update([(d, dq), (dq, d)])
        elif mixer == 'L':
            m, H = cfg.mla, cfg.n_heads
            per_unit.update([
                (d, H * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
                (d, m.kv_lora_rank), (d, m.qk_rope_head_dim),
                (H * m.v_head_dim, d)])
        else:
            s = cfg.ssm
            di = s.expand * d
            per_unit.update([(d, di), (d, di + 2 * s.n_groups * s.d_state),
                             (d, di // s.headdim), (di, d)])
        ff = 0
        if ffn == 'D':
            ff = cfg.d_ff
        elif ffn == 'E':
            ff = cfg.moe.n_shared * cfg.moe.d_ff_expert
        if ff:
            per_unit.update([(d, ff), (d, ff), (ff, d)])
    return collections.Counter({k: n * n_scan_steps(cfg)
                                for k, n in per_unit.items()})


def phase_w8a8_lm(torch, cfgs):
    """Phase 3, the W8A8 kernel at every (K, N) of each LM's w8a8 forward
    (``lm_w8a8_shapes``), at the prefill (M = batch x prompt) and a decode
    step (M = batch), bit-exact against the plain version, with
    per-forward totals; a shape two LMs share is timed once."""
    gen = torch.Generator(device='cuda').manual_seed(2)
    rows = {}
    for cfg in cfgs:
        per_forward = lm_w8a8_shapes(cfg)
        for label, M in (('prefill', LM_BATCH * LM_PROMPT),
                         ('decode', LM_BATCH)):
            tot = {'ms': 0.0, 'device_ms': 0.0, 'plain_ms': 0.0,
                   'bound_ms': 0.0, 'library_ms': 0.0, 'wquant_ms': 0.0,
                   'wquant_kmajor_ms': 0.0}
            for (K, N), n in sorted(per_forward.items()):
                if (M, K, N) not in rows:
                    rows[M, K, N] = w8a8_row(torch, gen, M, K, N)
                row, err = rows[M, K, N]
                print('[kernels] shape ' + json.dumps(
                    {'kernel': 'w8a8_matmul', 'lm': cfg.name,
                     'shape': [M, K, N], 'per_forward': n,
                     'max_abs_err': err, 'kernel_ms': row['ms'],
                     'device_ms': row['device_ms'],
                     'plain_ms': row['plain_ms'],
                     'library_ms': row['library_ms'],
                     'library_shape': [row['library_rows'], K, N],
                     'bound_ms': row['bound_ms'],
                     'bound_by': row['bound_by'], 'plan': row['plan'],
                     'wquant_ms': row['wquant_ms'],
                     'wquant_kmajor_ms': row['wquant_kmajor_ms']}))
                for k in tot:
                    tot[k] = (None if tot[k] is None or row[k] is None
                              else tot[k] + n * row[k])
            print(f'[kernels] w8a8_matmul: per {cfg.name} {label} forward '
                  f'({sum(per_forward.values())} launches at M = {M}): '
                  + json.dumps(tot))


def serve(engine, reqs):
    """Submit every request at once and drive the engine to idle."""
    for r in reqs:
        check(engine.submit(r), f'request {r.request_id} rejected')
    return {r.request_id: r for r in engine.run_until_idle()}


def phase_small(torch, numpy):
    """Phase 4: the same tiny requests on the card and on the CPU."""
    from repro_torch.diffusion.pipeline import DiffusionPipeline
    from repro_torch.serving import ContinuousBatchingEngine, GenerationRequest
    cfg, vae = tiny_sd()
    cpu = DiffusionPipeline.init(1, cfg, vae, device='cpu')
    ctx = torch.randn((1, 5, 16), generator=torch.Generator().manual_seed(2))
    ctx = ctx.repeat(3, 1, 1)
    reqs = [GenerationRequest(0, seed=10, steps=4, guidance=GUIDANCE),
            GenerationRequest(1, seed=11, steps=4),
            GenerationRequest(2, seed=12, steps=4, precision='w8a8')]
    out = {}
    for dev, pipe in (('cuda', cpu.to('cuda')), ('cpu', cpu)):
        out[dev] = serve(ContinuousBatchingEngine(pipe, slots=3, context=ctx,
                                                  quality_probe=0), reqs)
    for r in reqs:
        a, b = out['cuda'][r.request_id].image, out['cpu'][r.request_id].image
        check(a.shape == (16, 16, 3) and numpy.isfinite(a).all(),
              f'small request {r.request_id}: bad image {a.shape}')
        err = float(numpy.abs(a - b).max())
        tol = W8A8_ATOL if r.precision == 'w8a8' else FP32_ATOL
        print(f'[small] request {r.request_id} {r.precision} guidance '
              f'{r.guidance}: card vs CPU max abs err {err:.3e} (tol {tol})')
        check(err <= tol, f'small request {r.request_id}: card vs CPU '
              f'{err} > {tol}')


def phase_full(torch, numpy, ops, pipe, context, per_eval, card):
    """Phase 5: 8 full-width requests through the engine."""
    from repro_torch.serving import ContinuousBatchingEngine, GenerationRequest
    engine = ContinuousBatchingEngine(pipe, slots=SLOTS, context=context,
                                      quality_probe=1)
    warm = engine.warmup(precisions=('fp32', 'w8a8'))
    print(f'[full] warmup {warm:.2f} s (kernels loaded, every step variant '
          'run once)')
    mix = [('fp32', GUIDANCE), ('w8a8', 0.0), ('fp32', 0.0),
           ('w8a8', GUIDANCE), ('w8a8', GUIDANCE), ('fp32', 0.0),
           ('w8a8', 0.0), ('fp32', GUIDANCE)]
    reqs = [GenerationRequest(i, seed=100 + i, steps=STEPS, guidance=g,
                              precision=p) for i, (p, g) in enumerate(mix)]
    evals = collections.Counter()

    def count_eval(module, args, kwargs):
        x, t, ctx, pol = (list(args) + [None, None])[:4]
        evals[(str(getattr(pol, 'name', pol)), ctx is None)] += 1

    hook = pipe.unet.register_forward_pre_hook(count_eval, with_kwargs=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                  # the main path's run starts here
    t0 = time.perf_counter()
    try:
        results = serve(engine, reqs)
    finally:
        hook.remove()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()        # ... and ends here
    check(sorted(results) == list(range(len(reqs))),
          f'completed {sorted(results)} of {len(reqs)} requests')
    for r in reqs:
        img = results[r.request_id].image
        check(img.shape == (512, 512, 3) and numpy.isfinite(img).all(),
              f'request {r.request_id}: image {img.shape} not a finite '
              '512x512x3')
    n_evals = sum(evals.values())
    want_gn = per_eval['fused_gn_swish'] * n_evals
    want_mm = (per_eval['w8a8_matmul'] * evals[('w8a8', False)]
               + per_eval['w8a8_matmul_uncond'] * evals[('w8a8', True)])
    print(f'[full] UNet evaluations by (policy, unconditional): '
          f'{dict(evals)}; kernel launches {launches}, expected '
          f'fused_gn_swish {want_gn}, w8a8_matmul {want_mm}')
    check(launches['fused_gn_swish'] == want_gn > 0,
          'fused_gn_swish launches do not match the UNet evaluations')
    check(launches['w8a8_matmul'] == want_mm > 0,
          'w8a8_matmul launches do not match the w8a8 UNet evaluations')
    snap = engine.metrics.snapshot()
    psnr = {r.request_id: results[r.request_id].quality_psnr_db
            for r in reqs if r.precision == 'w8a8'}
    check(all(p is not None and p > 0 for p in psnr.values()),
          f'w8a8 quality probe missing: {psnr}')
    print(f'[full] {card}: {len(reqs)} requests SD v1.4 + VAE 512 at '
          f'{STEPS} steps on {SLOTS} slots: wall {wall:.3f} s, '
          f'{snap.requests_per_s:.4f} req/s, p50 latency '
          f'{snap.p50_latency_s:.3f} s, p95 {snap.p95_latency_s:.3f} s, '
          f'{snap.ticks} ticks, peak memory '
          f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    print(f'[full] {card}: w8a8 PSNR vs fp32 probe (dB): '
          + ', '.join(f'req {k}: {v:.2f}' for k, v in psnr.items()))
    return launches


def phase_prng(torch):
    """Phase 3b: ``core/prng`` on the card against the CPU: bits equal
    bit for bit at an odd 1-D shape and at the largest projection weight
    (1360 x 1360), normals within ``prng``'s stated tolerance; and the
    time of one 1360 x 1360 normal draw."""
    from repro_torch.core import prng
    key = prng.fold_in(prng.fold_in(prng.PRNGKey(5), 17), 981)
    shape = (1360, 1360)
    for sh in ((100_003,), shape):
        a = prng.random_bits(key, sh, device='cuda').cpu()
        b = prng.random_bits(key, sh, device='cpu')
        check(torch.equal(a, b), f'prng bits {sh}: card != CPU')
        na = prng.normal(key, sh, device='cuda').cpu()
        nb = prng.normal(key, sh, device='cpu')
        over = ((na - nb).abs() - prng.NORMAL_RTOL * nb.abs()).max().item()
        exact = (na == nb).float().mean().item()
        print(f'[prng] {sh}: bits card == CPU; normals max abs err '
              f'{(na - nb).abs().max().item():.3e}, {exact:.4f} bit-equal')
        check(over <= prng.NORMAL_ATOL, f'prng normals {sh}: card vs CPU '
              f'beyond rtol {prng.NORMAL_RTOL} + atol {prng.NORMAL_ATOL}')
    n = shape[0] * shape[1]
    bits_ms = time_ms(torch,
                      lambda: prng.random_bits(key, shape, device='cuda'),
                      reps=5, calls=5)
    normal_ms = time_ms(torch,
                        lambda: prng.normal(key, shape, device='cuda'),
                        reps=5, calls=5)
    print(f'[prng] one {shape} draw on the card: bits {bits_ms:.3f} ms, '
          f'normal {normal_ms:.3f} ms ({n / normal_ms / 1e6:.2f} G draws/s)')
    return normal_ms


def phase_small_features(torch, numpy):
    """Phase 4b: a w8a8+noise request, a DeepCache request (the engine's
    cadence ``CACHE_INTERVAL``) and an early-exit request of the tiny model
    through one engine on the card and on the CPU, with the same images,
    eval tallies, exits and energies."""
    from repro_torch.diffusion.pipeline import DiffusionPipeline
    from repro_torch.models.autoencoder import VAEConfig
    from repro_torch.models.unet import UNetConfig
    from repro_torch.serving import ContinuousBatchingEngine, GenerationRequest
    cfg = UNetConfig('tiny-sd', img_size=8, in_ch=4, base_ch=32,
                     ch_mults=(1, 2), n_res_blocks=1, attn_resolutions=(8, 4),
                     n_heads=4, context_dim=16, timesteps=16, latent=True)
    vae = VAEConfig(img_size=16, in_ch=3, z_ch=4, base_ch=16,
                    ch_mults=(1, 2), groups=8)
    cpu = DiffusionPipeline.init(1, cfg, vae, device='cpu')
    ctx = torch.randn((1, 5, 16), generator=torch.Generator().manual_seed(2))
    ctx = ctx.repeat(3, 1, 1)
    s0, s1, s2 = FEATURES_SEEDS
    reqs = [GenerationRequest(0, seed=s0, steps=6, precision='w8a8+noise',
                              cache_interval=1),
            GenerationRequest(1, seed=s1, steps=6, guidance=GUIDANCE),
            GenerationRequest(2, seed=s2, steps=6, cache_interval=1,
                              exit_tol=LOOSE_EXIT_TOL)]
    out = {}
    for dev, pipe in (('cuda', cpu.to('cuda')), ('cpu', cpu)):
        out[dev] = serve(ContinuousBatchingEngine(
            pipe, slots=3, context=ctx, cache_interval=CACHE_INTERVAL,
            noise_seed=7, quality_probe=0), reqs)
    for r in reqs:
        a, b = out['cuda'][r.request_id], out['cpu'][r.request_id]
        tally = (a.steps_executed, a.full_evals, a.cached_evals, a.early_exit)
        check(tally == (b.steps_executed, b.full_evals, b.cached_evals,
                        b.early_exit),
              f'features request {r.request_id}: card tallies {tally} != CPU')
        check(a.energy_j == b.energy_j > 0, f'features request '
              f'{r.request_id}: energy {a.energy_j} vs {b.energy_j}')
        check(a.image.shape == (16, 16, 3) and numpy.isfinite(a.image).all(),
              f'features request {r.request_id}: bad image')
        err = float(numpy.abs(a.image - b.image).max())
        tol = W8A8_ATOL if r.precision != 'fp32' else FP32_ATOL
        print(f'[small] features request {r.request_id} {r.precision} '
              f'cache_interval {r.cache_interval} exit_tol {r.exit_tol}: '
              f'steps {a.steps_executed}/{r.steps} (full {a.full_evals}, '
              f'cached {a.cached_evals}, early exit {a.early_exit}), energy '
              f'{a.energy_j:.6e} J; card vs CPU max abs err {err:.3e} '
              f'(tol {tol})')
        check(err <= tol, f'features request {r.request_id}: card vs CPU '
              f'{err} > {tol}')
    check(out['cpu'][1].cached_evals > 0 and out['cpu'][2].early_exit,
          'small features: no cached tick or no early exit')


def phase_serve_small(torch, numpy):
    """Phase 4c: ``serve_diffusion`` on the toy model (16 px) with 4 w8a8
    requests all arriving at t=0, on the card with decode overlap and on
    the CPU in order: the same images within ``W8A8_ATOL``, tallies and
    energies."""
    from repro_torch.launch import serve as tserve
    out = {}
    for dev in ('cuda', 'cpu'):
        results, summary = tserve.serve_diffusion(
            16, 4, 4, math.inf, 2, precision='w8a8', quality_probe=0,
            overlap_decode=dev == 'cuda', model='toy', device=dev)
        out[dev] = {r.request_id: r for r in results}, summary
    (card, cs), (cpu, ps) = out['cuda'], out['cpu']
    check(sorted(card) == sorted(cpu) == [0, 1, 2, 3],
          f'serve-small: completed {sorted(card)} / {sorted(cpu)}')
    check(cs['overlapped_decodes'] >= 1 and ps['overlapped_decodes'] == 0,
          f'serve-small: overlapped decodes {cs["overlapped_decodes"]} '
          f'on the card, {ps["overlapped_decodes"]} on the CPU')
    for rid, a in card.items():
        b = cpu[rid]
        check((a.steps_executed, a.full_evals, a.energy_j)
              == (b.steps_executed, b.full_evals, b.energy_j) and
              a.energy_j > 0, f'serve-small request {rid}: tallies or '
              'energy differ')
        check(a.image.shape == (16, 16, 3) and numpy.isfinite(a.image).all(),
              f'serve-small request {rid}: bad image')
        err = float(numpy.abs(a.image - b.image).max())
        print(f'[serve-small] request {rid} w8a8: card (decode overlap) vs '
              f'CPU max abs err {err:.3e} (tol {W8A8_ATOL}), energy '
              f'{a.energy_j:.6e} J')
        check(err <= W8A8_ATOL, f'serve-small request {rid}: card vs CPU '
              f'{err} > {W8A8_ATOL}')
    print(f'[serve-small] {int(cs["overlapped_decodes"])} decodes '
          'overlapped on the card')


def pass_launches(ops, pipe, context):
    """Launches of each path kernel per UNet evaluation of every kind the
    serving-features engine runs: {(kind, conditional): {kernel: n}} for
    kind 'full' (also a DeepCache refresh) and 'skip', under w8a8 (a noisy
    or fp32 evaluation launches no W8A8 kernel)."""
    import torch
    from repro_torch.diffusion.deepcache import unet_apply_cached
    cfg = pipe.unet_cfg
    x = torch.randn((SLOTS, cfg.img_size, cfg.img_size, cfg.in_ch),
                    device='cuda')
    t = torch.full((SLOTS,), 500, device='cuda')
    out = {}
    with torch.no_grad():
        _, cache = unet_apply_cached(pipe.unet, cfg, x, t, None, True,
                                     context, 'w8a8')
        for kind in ('full', 'skip'):
            for cond in (True, False):
                seen = record_shapes(ops, lambda: unet_apply_cached(
                    pipe.unet, cfg, x, t, cache, kind == 'full',
                    context if cond else None, 'w8a8'))
                out[(kind, cond)] = {k: sum(v.values())
                                     for k, v in seen.items()}
    return out


def time_wall(torch, fn, reps: int = 3) -> float:
    """Median host wall (ms) of ``fn`` between two device syncs."""
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def phase_full_features(torch, numpy, ops, pipe, context, card, normal_ms):
    """Phase 5b: the serving features at full width: 8 requests through an
    engine with DeepCache (``CACHE_INTERVAL``) and early exit
    (``EXIT_TOL``) on 4 slots; fp32, w8a8 and w8a8+noise, cached and opted
    out, guided and not.  Returns the run's launch counts."""
    from repro_torch.core import prng
    from repro_torch.serving import ContinuousBatchingEngine, GenerationRequest
    per_pass = pass_launches(ops, pipe, context)
    print(f'[features] launches per UNet evaluation under w8a8 by (kind, '
          f'conditional): {per_pass}')
    check(per_pass[('skip', True)]['w8a8_matmul'] == 0
          and per_pass[('skip', False)]['w8a8_matmul'] == 0,
          'an SD v1.4 skip pass should launch no W8A8 kernel (no attention '
          'at the full resolution)')
    engine = ContinuousBatchingEngine(
        pipe, slots=SLOTS, context=context, cache_interval=CACHE_INTERVAL,
        exit_tol=EXIT_TOL, quality_probe=1)
    warm = engine.warmup(precisions=('w8a8+noise',))
    print(f'[features] warmup {warm:.2f} s (noisy refresh and skip steps)')
    # (precision, cache_interval, guidance, exit_tol): fp32, w8a8 and
    # w8a8+noise; cached (engine cadence) and opted out (1); guided and
    # not; early exit at the engine's tolerance, off (0) or loose
    mix = [('fp32', None, GUIDANCE, 0.0), ('w8a8', None, 0.0, None),
           ('w8a8+noise', 1, 0.0, 0.0), ('fp32', 1, 0.0, LOOSE_EXIT_TOL),
           ('w8a8+noise', None, GUIDANCE, 0.0), ('w8a8', 1, GUIDANCE, None),
           ('fp32', None, 0.0, None), ('w8a8+noise', None, 0.0, None)]
    reqs = [GenerationRequest(i, seed=200 + i, steps=STEPS, guidance=g,
                              precision=p, cache_interval=c, exit_tol=e)
            for i, (p, c, g, e) in enumerate(mix)]
    calls = []

    def recorded(fn, refresh_of):
        def wrapped(sh, pol, guided, *args):
            before = ops.launch_counts()
            out = fn(sh, pol, guided, *args)
            after = ops.launch_counts()
            calls.append((pol.name, guided, refresh_of(args),
                          {k: after[k] - before[k] for k in after}))
            return out
        return wrapped

    engine._step = recorded(engine._step, lambda a: True)
    engine._cached_step = recorded(engine._cached_step, lambda a: a[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                  # the features run starts here
    t0 = time.perf_counter()
    results = serve(engine, reqs)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()        # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 2**30
    del engine._step, engine._cached_step
    check(sorted(results) == list(range(len(reqs))),
          f'completed {sorted(results)} of {len(reqs)} requests')
    acc = engine.photonic
    for r in reqs:
        res = results[r.request_id]
        check(res.image.shape == (512, 512, 3)
              and numpy.isfinite(res.image).all(),
              f'request {r.request_id}: image not a finite 512x512x3')
        want = acc.energy_evals(res.full_evals, res.cached_evals,
                                r.guidance > 0, precision=r.precision)
        check(res.energy_j > 0 and (res.energy_j, res.epb_pj) == want,
              f'request {r.request_id}: energy {res.energy_j} J, want '
              f'{want[0]} from the accountant')
        check(res.steps_executed == res.full_evals + res.cached_evals,
              f'request {r.request_id}: tallies do not add up')
    check(any(res.early_exit and res.steps_executed < res.steps
              for res in results.values()), 'no request exited early')
    check(any(res.cached_evals > 0 for res in results.values()),
          'no request took a DeepCache skip step')
    # the plan's launches: per step call, per evaluation of its kind
    want_total = collections.Counter()
    for pname, guided, refresh, got in calls:
        kind = 'full' if refresh else 'skip'
        want = collections.Counter()
        for cond in ((True, False) if guided else (True,)):
            n = per_pass[(kind, cond)]
            want['fused_gn_swish'] += n['fused_gn_swish']
            if pname == 'w8a8':
                want['w8a8_matmul'] += n['w8a8_matmul']
        check(got['w8a8_matmul'] == want['w8a8_matmul']
              and got['fused_gn_swish'] == want['fused_gn_swish'],
              f'{pname} {kind} guided={guided}: launches {got}, plan '
              f'{dict(want)}')
        if not refresh:
            check(got['w8a8_matmul'] == 0, 'a skip step launched W8A8')
        want_total.update(want)
    kinds = collections.Counter((p, g, 'refresh' if r else 'skip')
                                for p, g, r, _ in calls)
    print(f'[features] step calls by (precision, guided, kind): '
          f'{dict(kinds)}; launches in the steps {dict(want_total)} as '
          f'planned; the whole run (fp32 probes included) {launches}')
    check(launches['fused_gn_swish'] >= want_total['fused_gn_swish'] > 0
          and launches['w8a8_matmul'] == want_total['w8a8_matmul'] > 0,
          'the features run did not go through both path kernels as planned')
    snap = engine.metrics.snapshot()
    print(f'[features] {card}: {len(reqs)} requests SD v1.4 + VAE 512 at '
          f'{STEPS} steps on {SLOTS} slots, cache_interval {CACHE_INTERVAL}, '
          f'exit_tol {EXIT_TOL}: wall {wall:.3f} s, '
          f'{snap.requests_per_s:.4f} req/s, p50 latency '
          f'{snap.p50_latency_s:.3f} s, {snap.ticks} ticks (cache hit rate '
          f'{snap.cache_hit_rate:.3f}, mixed ticks {snap.mixed_ticks}, early '
          f'exits {snap.early_exits}, steps saved {snap.steps_saved}), peak '
          f'memory {peak:.2f} GiB')
    by_kind = collections.defaultdict(list)
    for r in reqs:
        res = results[r.request_id]
        print(f'[features] request {r.request_id} {r.precision} guidance '
              f'{r.guidance} cache_interval {r.cache_interval} exit_tol '
              f'{r.exit_tol}: steps {res.steps_executed}/{res.steps} (full '
              f'{res.full_evals}, cached {res.cached_evals}, early exit '
              f'{res.early_exit}), energy {res.energy_j:.6e} J, EPB '
              f'{res.epb_pj:.6f} pJ, PSNR vs fp32 probe {res.quality_psnr_db}')
        kind = (r.precision + (' cached' if res.cached_evals else '')
                + (' early-exit' if res.early_exit else ''))
        if res.quality_psnr_db is not None:
            by_kind[kind].append(round(res.quality_psnr_db, 2))
    print(f'[features] {card}: PSNR (dB) vs the fp32 full-step probe by '
          f'kind: {dict(by_kind)}')

    # the walls of one step of each kind over all 4 slots (the one shard),
    # unguided: a noisy full step against a w8a8 one, a DeepCache refresh
    # against a skip; and the share of the noisy step its noise draws take
    sh = engine._shards[0]
    sh.x = torch.randn(sh.x.shape, device='cuda')
    sh.x0 = torch.randn(sh.x.shape, device='cuda')
    ts = engine._trajectory(STEPS)
    t_d = torch.full((SLOTS,), int(ts[1]), device='cuda')
    tp_d = torch.full((SLOTS,), int(ts[2]), device='cuda')
    m_d = torch.ones(SLOTS, dtype=torch.bool, device='cuda')
    g_d = torch.zeros(SLOTS, device='cuda')
    pw = engine._policy_for('w8a8')
    pn = engine._policy_for('w8a8+noise')
    key = engine._tick_key(pn, 0)
    t0_ = int(ts[1])
    walls = {
        'w8a8 full': time_wall(torch, lambda: engine._step(
            sh, pw, False, t_d, tp_d, m_d, g_d, None, t0_)),
        'w8a8+noise full': time_wall(torch, lambda: engine._step(
            sh, pn, False, t_d, tp_d, m_d, g_d, key, t0_)),
        'w8a8 refresh': time_wall(torch, lambda: engine._cached_step(
            sh, pw, False, True, t_d, tp_d, m_d, g_d, None)),
        'w8a8 skip': time_wall(torch, lambda: engine._cached_step(
            sh, pw, False, False, t_d, tp_d, m_d, g_d, None)),
        'w8a8+noise skip': time_wall(torch, lambda: engine._cached_step(
            sh, pn, False, False, t_d, tp_d, m_d, g_d, key)),
        'fp32 full': time_wall(torch, lambda: engine._step(
            sh, engine._policy_for('fp32'), False, t_d, tp_d, m_d, g_d,
            None, t0_)),
    }
    draws = []
    normal = prng.normal

    def rec(k, shape, *, device, offset=0):
        draws.append(tuple(shape))
        return normal(k, shape, device=device, offset=offset)

    prng.normal = rec
    try:
        with torch.no_grad():
            engine._step(sh, pn, False, t_d, tp_d, m_d, g_d, key, t0_)
    finally:
        prng.normal = normal
    n_draw = sum(math.prod(s) for s in draws)
    draw_ms = time_wall(torch, lambda: [normal(key, s, device='cuda')
                                        for s in draws])
    print(f'[features] {card}: step walls over {SLOTS} slots, unguided '
          '(ms): ' + json.dumps({k: round(v, 3) for k, v in walls.items()}))
    print(f'[features] {card}: one noisy evaluation draws {len(draws)} '
          f'normal tensors, {n_draw:,} values, in {draw_ms:.3f} ms alone: '
          f'{draw_ms / walls["w8a8+noise full"]:.1%} of the noisy step '
          f'(one 1360x1360 draw {normal_ms:.3f} ms)')
    check(walls['w8a8 skip'] < walls['w8a8 refresh'],
          'a skip step is not cheaper than a refresh step')
    return launches


def attention_layers(cfg) -> int:
    """GQA sub-layers of the LM, or decoder layers of the encoder-decoder
    (one dense ``A``/``D`` unit per layer in ``_block_kinds``): its flash
    launches per prefill."""
    from repro_torch.models.transformer import _block_kinds, n_scan_steps
    return n_scan_steps(cfg) * sum(mixer == 'A'
                                   for mixer, _ in _block_kinds(cfg))


def phase_lm_small(torch, numpy, ops):
    """Phase 6: the smoke configs of ``SMALL_LM_ARCHS`` (InternLM2, and
    the MoE, MLA, SSM, hybrid, encoder-decoder and VLM families) on the
    card and on the CPU from one seed, a prefill and ``SMALL_LM_STEPS``
    decode steps, both fed the CPU's greedy tokens; logits compared at
    every step, and the flash launches per prefill counted; then the
    VLM's ``lm_apply`` with ``inputs_embeds`` and M-RoPE streams."""
    for arch in SMALL_LM_ARCHS:
        lm_small(torch, numpy, ops, arch)
    vlm_small(torch, numpy)


def lm_calls(torch, cfg, frames=None):
    """``(init_state, prefill, decode, forward)`` of ``cfg`` in float32:
    ``init_state(B, rows, device)``, ``prefill(model, tokens, state,
    quant) -> (last-token logits, state)``, ``decode(model, token, state,
    pos, quant) -> (logits, state)`` and the no-cache ``forward(model,
    tokens, quant) -> logits``.  For the encoder-decoder, ``frames`` feed
    the encoder, the state is (cache, memory), the forward is
    ``decode_train``, and ``quant`` is ignored, as the reference's steps
    ignore it."""
    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as T
    f32 = torch.float32
    if cfg.family != 'encdec':
        return (lambda B, rows, dev: T.init_lm_cache(cfg, B, rows, f32, dev),
                lambda m, tokens, cache, quant: T.lm_prefill(
                    m, cfg, tokens, cache, dtype=f32, quant=quant),
                lambda m, token, cache, pos, quant: T.lm_decode(
                    m, cfg, token, cache, pos, dtype=f32, quant=quant),
                lambda m, tokens, quant: T.lm_apply(m, cfg, tokens,
                                                    quant=quant))

    def prefill(m, tokens, state, quant):
        logits, cache, memory = ED.encdec_prefill(
            m, cfg, frames.to(tokens.device), tokens, state[0], dtype=f32)
        return logits, (cache, memory)

    def decode(m, token, state, pos, quant):
        logits, cache = ED.encdec_decode(m, cfg, token, state[0], pos,
                                         state[1], dtype=f32)
        return logits, (cache, state[1])

    return (lambda B, rows, dev: (ED.init_dec_cache(cfg, B, rows, f32, dev),
                                  None),
            prefill, decode,
            lambda m, tokens, quant: ED.decode_train(
                m, cfg, frames.to(tokens.device), tokens))


def lm_small(torch, numpy, ops, arch):
    import copy
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.steps import init_params
    cfg = smoke_config(arch)
    lms = {'cpu': init_params(torch.Generator().manual_seed(0), cfg, 'cpu')}
    lms['cuda'] = copy.deepcopy(lms['cpu']).to('cuda')
    B, S = 2, 40              # S is not a multiple of the 64-row tile
    n_attn = attention_layers(cfg)
    rng = numpy.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))
    frames = torch.from_numpy(rng.normal(size=(B, S, cfg.d_model))).float()
    init_state, prefill, decode, _ = lm_calls(torch, cfg, frames)
    for quant, tol in ((False, LM_SMALL_FP32_ATOL),
                       (True, LM_SMALL_W8A8_ATOL)):
        states = {dev: init_state(B, S + SMALL_LM_STEPS, dev) for dev in lms}
        errs, sure = [], 0
        flash0 = ops.launch_counts()['flash_attention']
        with torch.no_grad():
            logits = {}
            for dev in lms:
                logits[dev], states[dev] = prefill(lms[dev], tokens.to(dev),
                                                   states[dev], quant)
            flash = ops.launch_counts()['flash_attention'] - flash0
            check(flash == n_attn, f'small {arch} prefill: flash launches '
                  f'{flash} != {n_attn}')
            for step in range(SMALL_LM_STEPS + 1):
                a, b = logits['cuda'].cpu(), logits['cpu']
                errs.append((a - b).abs().max().item())
                top2 = b.topk(2, dim=-1).values
                clear = (top2[..., 0] - top2[..., 1]) > tol
                sure += int(clear.sum())
                check(bool((a.argmax(-1) == b.argmax(-1))[clear].all()),
                      f'small {arch} step {step}: card and CPU pick '
                      'different tokens where the top-2 margin exceeds the '
                      'tolerance')
                if step == SMALL_LM_STEPS:
                    break
                nxt = b.argmax(-1).to(torch.int32)
                for dev in lms:
                    logits[dev], states[dev] = decode(
                        lms[dev], nxt.to(dev), states[dev], S + step, quant)
        err = max(errs)
        print(f'[lm-small] {cfg.name} {"w8a8" if quant else "fp32"}: prefill '
              f'{B}x{S} + {SMALL_LM_STEPS} decode steps, card vs CPU max abs '
              f'logit err {err:.3e} (tol {tol}); tokens agree at all {sure} '
              f'positions with a top-2 margin above it; {flash} flash '
              'launches per prefill')
        check(err <= tol, f'small {arch}: card vs CPU {err} > {tol}')


def vlm_small(torch, numpy):
    """The smoke Qwen2-VL's ``lm_apply`` on the card and the CPU with
    ``inputs_embeds`` (the vision stub's output) and (B, S, 3) positions
    whose t, h and w streams differ, at fp32 and w8a8."""
    import copy
    from repro_torch.configs.registry import smoke_config
    from repro_torch.launch.steps import init_params
    from repro_torch.models import transformer as T
    cfg = smoke_config('qwen2-vl-7b')
    lms = {'cpu': init_params(torch.Generator().manual_seed(0), cfg, 'cpu')}
    lms['cuda'] = copy.deepcopy(lms['cpu']).to('cuda')
    B, S = 2, 40
    rng = numpy.random.default_rng(4)
    embeds = torch.from_numpy(rng.normal(size=(B, S, cfg.d_model))).float()
    t = numpy.arange(S)[None, :] + rng.integers(0, 30, (B, 1))
    pos3 = torch.from_numpy(numpy.stack(
        [t, rng.integers(0, 20, (B, S)), rng.integers(0, 20, (B, S))], -1))
    check(bool((pos3[..., 0] != pos3[..., 1]).any()
               and (pos3[..., 1] != pos3[..., 2]).any()),
          'the three M-RoPE streams must differ')
    for quant, tol in ((False, LM_SMALL_FP32_ATOL),
                       (True, LM_SMALL_W8A8_ATOL)):
        with torch.no_grad():
            out = {dev: T.lm_apply(lms[dev], cfg, None, pos=pos3.to(dev),
                                   inputs_embeds=embeds.to(dev),
                                   quant=quant).cpu() for dev in lms}
        err = (out['cuda'] - out['cpu']).abs().max().item()
        print(f'[lm-small] {cfg.name} {"w8a8" if quant else "fp32"} '
              f'lm_apply with inputs_embeds {B}x{S} and 3 distinct M-RoPE '
              f'streams: card vs CPU max abs logit err {err:.3e} (tol '
              f'{tol})')
        check(out['cuda'].shape == (B, S, cfg.vocab) and err <= tol,
              f'small {cfg.name} inputs_embeds: card vs CPU {err} > {tol}')


def record_flash_entries(fak, fn):
    """Run ``fn`` counting the calls of the flash kernel's two entries:
    ``bshd`` (and how many of those read k/v that are views of a larger
    tensor, i.e. the cache where it lies) and ``flat``.  The result of
    ``fn`` comes back under ``result``."""
    seen = collections.Counter(bshd=0, bshd_on_cache=0, flat=0)
    bshd, flat = fak.flash_attention_bshd_kernel, fak.flash_attention_kernel

    def bshd_rec(q, k, v, **kw):
        seen['bshd'] += 1
        seen['bshd_on_cache'] += int(
            k._base is not None and v._base is not None
            and k.untyped_storage().nbytes() > k.numel() * k.element_size())
        return bshd(q, k, v, **kw)

    def flat_rec(*args, **kw):
        seen['flat'] += 1
        return flat(*args, **kw)

    fak.flash_attention_bshd_kernel = bshd_rec
    fak.flash_attention_kernel = flat_rec
    try:
        result = fn()
    finally:
        fak.flash_attention_bshd_kernel = bshd
        fak.flash_attention_kernel = flat
    return dict(seen, result=result)


def phase_lm_full(torch, numpy, ops, card):
    """Phase 7: InternLM2-1.8B at full width; the prefill-vs-lm_apply
    check (w8a8 also within ``LM_FULL_W8A8_RTOL`` of the largest logit),
    then ``serve_lm`` at fp32 and w8a8 with launch counts.  Returns the
    launch counts of the serving runs."""
    from repro_torch.configs.registry import get
    return lm_full(torch, numpy, ops, card, get(LM_ARCH), 'lm-full',
                   w8a8_rtol=LM_FULL_W8A8_RTOL)


def phase_lm_families(torch, numpy, ops, card, plan, tag):
    """Phases 9 and 10: the families of ``plan`` (9: ``FAMILY_PLAN``, the
    MoE, MLA and SSM families; 10: ``ENCDEC_VLM_PLAN``, the
    encoder-decoder and the VLM) at full width and depth, each alone on
    the card (DeepSeek's 16.21 B float32 parameters, 60.4 GiB, fit an 80
    GB card once every earlier model is freed): phase 7's check and
    ``serve_lm`` runs, with the launches held to the plan.  Returns the
    launch counts of the serving runs."""
    from repro_torch.configs.registry import get
    launches = collections.Counter()
    for arch, (flash, mm) in plan.items():
        cfg = get(arch)
        planned = (attention_layers(cfg), sum(lm_w8a8_shapes(cfg).values()))
        check(planned == (flash, mm),
              f'{arch}: launches per prefill / w8a8 forward {planned}, '
              f'plan {(flash, mm)}')
        gc.collect()          # phase 8's pipeline sits in reference cycles
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() / 2**30
        print(f'[{tag}] {arch}: {held:.2f} GiB allocated on the card '
              'before it is built')
        t0 = time.perf_counter()
        launches.update(lm_full(torch, numpy, ops, card, cfg, tag))
        print(f'[{tag}] {arch}: {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()
    return launches


def lm_full(torch, numpy, ops, card, cfg, tag, w8a8_rtol=None):
    """``cfg`` at full width with random weights from seed 0 drawn on the
    card.  First the check, at fp32 and w8a8: the prefill's last-token
    logits (the flash kernel on the cache for GQA, the absorbed path for
    MLA, the chunked SSD for Mamba) against the no-cache forward's at the
    last position (``lm_apply``; ``decode_train`` for the encoder-decoder,
    checked at fp32 only, since its steps ignore ``quant``) (fp32 within
    ``LM_FULL_FP32_ATOL``; w8a8 within the
    quantization noise of the run, and ``w8a8_rtol`` of the largest logit
    where given), with the launches of one prefill and one decode step held
    to the plan (flash: one per GQA layer per prefill, all through
    ``flash_attention_bshd`` on the cache, none per decode step; W8A8:
    ``lm_w8a8_shapes`` per w8a8 forward, the shapes the prefill hands the
    kernel equal to it).  Then ``serve_lm`` (batch 4, a 1000-token
    prompt, 32 new tokens, float32; the encoder-decoder also encodes 1000
    stub frames) at fp32 and at w8a8, with the launches checked, tokens
    in the vocabulary (the encoder-decoder's w8a8 tokens equal to its
    fp32 ones), and the prefill seconds, decode tokens/s and peak memory
    printed.  Returns the launch counts of the serving runs."""
    from repro_torch.launch.serve import serve_lm
    from repro_torch.launch.steps import init_params
    from repro_torch.kernels import flash_attention as fak
    t0 = time.perf_counter()
    lm = init_params(torch.Generator(device='cuda').manual_seed(0), cfg,
                     'cuda')
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    print(f'[{tag}] {cfg.name}: {n_params:,} parameters '
          f'({4 * n_params / 2**30:.1f} GiB) drawn on the card from seed 0 '
          f'in {time.perf_counter() - t0:.1f} s; {cfg.n_layers} layers')
    rng = numpy.random.default_rng(0)     # serve_lm's draws, in its order
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))).to('cuda', torch.int32)
    frames = torch.from_numpy(rng.normal(
        size=(LM_BATCH, LM_PROMPT, cfg.d_model))).to('cuda', torch.float32)
    encdec = cfg.family == 'encdec'
    init_state, prefill, decode, forward = lm_calls(torch, cfg, frames)
    forward_name = 'decode_train' if encdec else 'lm_apply'
    n_attn = attention_layers(cfg)
    mm_shapes = lm_w8a8_shapes(cfg)
    per_forward_mm = sum(mm_shapes.values())
    for quant in (False,) if encdec else (False, True):
        qtag = 'w8a8' if quant else 'fp32'
        state = init_state(LM_BATCH, LM_PROMPT + 1, 'cuda')
        with torch.no_grad():
            ops.reset_launches()
            out = {}
            shapes = record_shapes(ops, lambda: out.update(
                record_flash_entries(fak, lambda: prefill(
                    lm, tokens, state, quant))))
            last, state = out.pop('result')
            entries = out
            pre = ops.launch_counts()
            ops.reset_launches()
            nxt = last.argmax(-1).to(torch.int32)
            decode(lm, nxt, state, LM_PROMPT, quant)
            dec = ops.launch_counts()
            del state
            full = forward(lm, tokens, quant)[:, -1].clone()
        diff = last[:, 0] - full
        err = diff.abs().max().item()
        rel = (diff.norm() / full.norm()).item()
        scale = full.abs().max().item()
        if quant:
            noise = full - full_fp32
            tol = noise.abs().max().item()
            rel_tol = (noise.norm() / full_fp32.norm()).item()
            if w8a8_rtol is not None:
                tol = min(tol, w8a8_rtol * scale)
        else:
            tol, rel_tol = LM_FULL_FP32_ATOL, math.inf
            full_fp32 = full
        print(f'[{tag}] {cfg.name} {qtag} check: prefill last-token logits '
              f'vs {forward_name}: max abs err {err:.3e} (tol {tol:.3e}; '
              f'max |logit| {scale:.3f}); relative L2 {rel:.3e} (tol '
              f'{rel_tol:.3e}); launches per prefill {pre} (flash entries '
              f'{entries}), per decode step {dec}')
        check(err <= tol and rel <= rel_tol, f'{cfg.name} {qtag}: prefill '
              f'vs {forward_name} {err} > {tol} or relative L2 {rel} > '
              f'{rel_tol}')
        check(pre['flash_attention'] == n_attn
              and dec['flash_attention'] == 0,
              f'{cfg.name} {qtag}: flash launches {pre}, {dec}: want '
              f'{n_attn} per prefill, 0 per decode step')
        check(entries == {'bshd': n_attn, 'bshd_on_cache': n_attn,
                          'flat': 0},
              f'{cfg.name} {qtag}: flash entries per prefill {entries}: '
              'want every launch through flash_attention_bshd on the cache')
        want_mm = per_forward_mm if quant else 0
        check(pre['w8a8_matmul'] == want_mm == dec['w8a8_matmul'],
              f'{cfg.name} {qtag}: w8a8 launches {pre}, {dec}: want '
              f'{want_mm} per forward')
        got_shapes = collections.Counter(
            {(K, N): n for (M, K, N), n in shapes['w8a8_matmul'].items()})
        check(got_shapes == (mm_shapes if quant else {}),
              f'{cfg.name} {qtag}: W8A8 shapes per prefill {got_shapes}, '
              f'planned {mm_shapes}')
    torch.cuda.empty_cache()

    launches = collections.Counter()
    for quant in (False, True):
        qtag = 'w8a8' if quant else 'fp32'
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()              # the LM path's run starts here
        seqs, timing = serve_lm(cfg, LM_BATCH, LM_PROMPT, LM_TOKENS,
                                quant=quant, dtype=torch.float32,
                                device='cuda', params=lm)
        got = ops.launch_counts()         # ... and ends here
        launches.update(got)
        check(tuple(seqs.shape) == (LM_BATCH, LM_TOKENS)
              and seqs.dtype == torch.int32, f'{cfg.name} {qtag}: tokens '
              f'{seqs.shape} {seqs.dtype}')
        check(0 <= int(seqs.min()) and int(seqs.max()) < cfg.vocab,
              f'{cfg.name} {qtag}: token ids outside the vocabulary')
        want_mm = per_forward_mm * LM_TOKENS if quant else 0
        check(got['flash_attention'] == n_attn
              and got['w8a8_matmul'] == want_mm,
              f'{cfg.name} {qtag}: launches {got}, want flash {n_attn} and '
              f'w8a8 {want_mm}')
        if not quant:
            seqs_fp32 = seqs
        elif encdec:
            check(torch.equal(seqs, seqs_fp32), f'{cfg.name}: w8a8 tokens '
                  'differ from fp32 ones, though its steps ignore quant')
        print(f'[{tag}] {card}: {cfg.name} {qtag} serve_lm batch '
              f'{LM_BATCH}, prompt {LM_PROMPT}, {LM_TOKENS} new tokens: '
              f'prefill {timing["prefill_s"]:.3f} s, decode {LM_TOKENS - 1} '
              f'steps {timing["decode_s"]:.3f} s = '
              f'{timing["decode_tok_s"]:.1f} tok/s, peak memory '
              f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, '
              f'launches {got}, tokens[0] {seqs[0, :8].tolist()}')
    return launches


def phase_serve(torch, numpy, ops, card, pipe):
    """Phase 8: the serving CLI's path, ``serve_diffusion`` on SD v1.4 +
    VAE 512 at full width (4 slots, 10 steps, w8a8, no quality probe):
    (i) 8 requests at 4.0 req/s, (ii) the same trace with decode overlap,
    (iii) run (ii) traced, with the Chrome trace, the JSONL log and the
    Prometheus text written under ``build/serve-smoke``, (iv) 5x the
    measured capacity, 16 requests at 4 steps.  Checks counts only:
    requests completed, images, decodes overlapped, the trace reconciled,
    the overload tallies, kernel launches per UNet evaluation.  ``pipe``:
    ``serve_diffusion``'s SD v1.4 pipeline, shared with phase 12."""
    from repro_torch.launch import serve as tserve
    from repro_torch.obs import read_jsonl
    SERVE_OUT.mkdir(parents=True, exist_ok=True)
    files = {k: str(SERVE_OUT / f'serve.{k}') for k in ('json', 'jsonl',
                                                         'prom')}
    runs = {
        'i': dict(n_requests=SERVE_REQUESTS, rate_hz=SERVE_RATE,
                  steps=STEPS),
        'ii': dict(n_requests=SERVE_REQUESTS, rate_hz=SERVE_RATE,
                   steps=STEPS, overlap_decode=True),
        'iii': dict(n_requests=SERVE_REQUESTS, rate_hz=SERVE_RATE,
                    steps=STEPS, overlap_decode=True,
                    trace_path=files['json'], log_json_path=files['jsonl'],
                    prom_path=files['prom']),
        'iv': dict(n_requests=OVERLOAD_REQUESTS, rate_hz=SERVE_RATE,
                   steps=OVERLOAD_STEPS, overload=OVERLOAD),
    }
    evals = collections.Counter()

    def count_eval(module, args, kwargs):
        x, t, ctx, pol = (list(args) + [None, None])[:4]
        evals[(str(getattr(pol, 'name', pol)), ctx is None)] += 1

    hook = pipe.unet.register_forward_pre_hook(count_eval, with_kwargs=True)
    out = {}
    torch.cuda.synchronize()
    ops.reset_launches()                  # the CLI path's run starts here
    try:
        for name, kw in runs.items():
            torch.cuda.reset_peak_memory_stats()
            results, s = tserve.serve_diffusion(
                None, slots=SLOTS, precision='w8a8', quality_probe=0,
                model='sd-v1.4', device='cuda', pipe=pipe, **kw)
            peak = torch.cuda.max_memory_allocated() / 2**30
            out[name] = {r.request_id: r for r in results}, s
            print(f'[serve] {card}: run ({name}) {kw["n_requests"]} '
                  f'requests, {kw["steps"]} steps, '
                  + (f'{OVERLOAD:g}x capacity' if 'overload' in kw
                     else f'{SERVE_RATE} req/s')
                  + f', overlap {kw.get("overlap_decode", False)}, traced '
                  f'{"trace_path" in kw}: {int(s["completed"])} done, '
                  f'{int(s["shed"])} shed, {s["requests_per_s"]:.4f} req/s, '
                  f'p50 {s["p50_latency_ms"] / 1e3:.3f} s, p95 '
                  f'{s["p95_latency_ms"] / 1e3:.3f} s, makespan '
                  f'{s["makespan_s"]:.3f} s, energy '
                  f'{s["energy_per_request_mj"]:.3f} mJ/request, overlapped '
                  f'decodes {int(s["overlapped_decodes"])}, peak memory '
                  f'{peak:.2f} GiB')
    finally:
        hook.remove()
    launches = ops.launch_counts()        # ... and ends here
    # the warmups' guided requests add unconditional evaluations, and the
    # capacity probe serves fp32 requests, as the reference's does
    want_mm = 128 * evals[('w8a8', False)] + 64 * evals[('w8a8', True)]
    print(f'[serve] UNet evaluations by (policy, unconditional), warmups '
          f'and capacity probe included: {dict(evals)}; kernel launches '
          f'{launches}, expected fused_gn_swish {45 * sum(evals.values())}, '
          f'w8a8_matmul {want_mm}')
    check(launches['fused_gn_swish'] == 45 * sum(evals.values()) > 0,
          'serve: fused_gn_swish launches do not match the evaluations')
    check(launches['w8a8_matmul'] == want_mm > 0,
          'serve: w8a8_matmul launches do not match the evaluations')
    for name in ('i', 'ii', 'iii'):
        res, s = out[name]
        check(sorted(res) == list(range(SERVE_REQUESTS)),
              f'serve run ({name}): completed {sorted(res)}')
        for r in res.values():
            check(r.image.shape == (512, 512, 3)
                  and numpy.isfinite(r.image).all() and r.energy_j > 0,
                  f'serve run ({name}) request {r.request_id}: bad result')
    for name in ('ii', 'iii'):
        check(out[name][1]['overlapped_decodes'] >= 1,
              f'serve run ({name}): no decode overlapped')
    err = max(float(numpy.abs(out['ii'][0][k].image
                              - out['i'][0][k].image).max())
              for k in out['i'][0])
    print(f'[serve] images with decode overlap vs without: max abs err '
          f'{err:.3e} (tol {W8A8_ATOL})')
    check(err <= W8A8_ATOL, f'serve: overlap moved an image by {err}')
    with open(files['json']) as f:
        doc = json.loads(f.read(), parse_constant=lambda tok: 1 / 0)
    events = read_jsonl(files['jsonl'])
    with open(files['prom']) as f:
        prom = f.read()
    check(sum(e['name'] == 'request' for e in events) == SERVE_REQUESTS
          and f'repro_serving_completed_total {SERVE_REQUESTS}\n' in prom
          and len(doc['traceEvents']) > len(events),
          'serve run (iii): trace files disagree with the run')
    print(f'[serve] {card}: traced {out["iii"][1]["requests_per_s"]:.4f} '
          f'req/s beside untraced {out["ii"][1]["requests_per_s"]:.4f} '
          f'req/s (both with decode overlap); {len(events)} events, '
          f'{len(doc["traceEvents"])} Chrome rows, {len(prom)} bytes of '
          f'Prometheus text under {SERVE_OUT.relative_to(ROOT)}')
    res, s = out['iv']
    check(len(res) + int(s['shed']) == OVERLOAD_REQUESTS,
          f'serve run (iv): {len(res)} completed + {s["shed"]} shed != '
          f'{OVERLOAD_REQUESTS} offered')
    check(s['max_queue_depth'] <= 2 * SLOTS,
          f'serve run (iv): queue peaked at {s["max_queue_depth"]}')
    check(s['shed'] >= 1, 'serve run (iv): nothing shed at 5x capacity')
    print(f'[serve] overload: {len(res)} completed + {int(s["shed"])} shed '
          f'== {OVERLOAD_REQUESTS} offered (queue_full '
          f'{int(s.get("shed_queue_full", 0))}, expired '
          f'{int(s.get("shed_expired", 0))}, evicted '
          f'{int(s.get("shed_deadline_evict", 0))}), queue peaked at '
          f'{int(s["max_queue_depth"])} <= {2 * SLOTS}')
    decode_overlap_walls(torch, pipe, card)
    return launches


def decode_overlap_walls(torch, pipe, card):
    """What decode overlap can hide: the walls (``time_wall``) of one
    w8a8 UNet evaluation over 4 slots, of one 512-px VAE decode, of the
    two in turn on one stream, and of the decode on a second stream
    beside the evaluation, as the engine runs them."""
    cfg = pipe.unet_cfg
    gen = torch.Generator().manual_seed(1)
    ctx = torch.randn((SLOTS, 77, cfg.context_dim),
                      generator=gen)[:1].repeat(SLOTS, 1, 1).cuda()
    x = torch.randn((SLOTS, cfg.img_size, cfg.img_size, cfg.in_ch),
                    generator=gen).cuda()
    t = torch.full((SLOTS,), 500, device='cuda')
    side = torch.cuda.Stream()

    def step():
        pipe.unet(x, t, ctx, 'w8a8')

    def decode():
        pipe.decode(x[:1])

    def beside():
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            decode()
        step()
        torch.cuda.current_stream().wait_stream(side)

    with torch.no_grad():
        walls = {'step': time_wall(torch, step),
                 'decode': time_wall(torch, decode),
                 'step then decode': time_wall(torch, lambda: (step(),
                                                               decode())),
                 'decode beside step': time_wall(torch, beside)}
    print(f'[serve] {card}: walls (ms, median of 3) of a w8a8 evaluation '
          'over 4 slots and a 512-px decode: '
          + json.dumps({k: round(v, 3) for k, v in walls.items()}))


def mesh_engine(pipe, context, devices=None):
    """Phase 12's engine: w8a8 unguided over the shared context, no
    quality probe; sharded over ``devices`` at ``MESH_SPD`` slots each,
    else one device with ``SLOTS`` slots."""
    from repro_torch.launch.mesh import serving_mesh
    from repro_torch.serving import ContinuousBatchingEngine
    if devices is None:
        return ContinuousBatchingEngine(pipe, slots=SLOTS, context=context,
                                        quality_probe=0)
    return ContinuousBatchingEngine(
        pipe, mesh=serving_mesh(devices=devices), slots_per_device=MESH_SPD,
        context=context, quality_probe=0)


def mesh_requests(n, start=0, steps=STEPS, precision='w8a8'):
    from repro_torch.serving import GenerationRequest
    return [GenerationRequest(start + i, seed=300 + start + i, steps=steps,
                              precision=precision) for i in range(n)]


def mesh_run(torch, ops, engine, reqs, evals):
    """Serve ``reqs`` (all at t=0) with the counters set to 0 just before
    and read just after; returns results, launches, wall and peak GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    evals.clear()
    ops.reset_launches()
    t0 = time.perf_counter()
    results = serve(engine, reqs)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    return results, launches, wall, torch.cuda.max_memory_allocated() / 2**30


def mesh_tick_ms(torch, engine):
    """Median wall (ms, ``time_wall`` of 7) of one tick with every slot
    busy with a w8a8 request, no drain among the ticks timed (1 + 8 of
    the requests' ``STEPS``)."""
    for r in mesh_requests(engine.slots, start=100):
        check(engine.submit(r), 'tick-timing request rejected')
    engine.tick()                          # admission and the first step
    ms = time_wall(torch, engine.tick, reps=7)
    engine.run_until_idle()
    return ms


def check_mesh_images(numpy, what, got, want, tol):
    check(sorted(got) == sorted(want),
          f'{what}: completed {sorted(got)} of {sorted(want)}')
    err = 0.0
    for rid, r in got.items():
        check(r.image.shape == (512, 512, 3) and numpy.isfinite(r.image).all(),
              f'{what} request {rid}: image not a finite 512x512x3')
        err = max(err, float(numpy.abs(r.image - want[rid].image).max()))
    print(f'[mesh] {what}: {len(got)} images, max abs err {err:.3e} '
          f'(tol {tol})')
    check(err <= tol, f'{what}: images off by {err} > {tol}')


def phase_mesh(torch, numpy, ops, card, pipe, per_eval, checked):
    """Phase 12: the slot-sharded engine on SD v1.4 + VAE 512 at full
    width (``pipe``, phase 8's), w8a8, unguided over the shared context,
    over two logical shards on cuda:0 with ``MESH_SPD`` slots each:
    (i) 8 requests at 10 steps against an unsharded 4-slot engine, with
    the launches held to shards x ticks x the plan; (ii) the same 8
    through a 2 -> 1 resize after two ticks and a 1 -> 2 grow serving 4
    more; (iii) a w8a8+noise request on shard 1; (iv)
    ``serve_diffusion(devices=1)`` on a Poisson trace; with two or more
    cards, (i) again over cuda:0 and cuda:1.  Returns the launches."""
    from repro_torch.launch import serve as tserve
    cfg = pipe.unet_cfg
    gen = torch.Generator().manual_seed(1)
    context = torch.randn((SLOTS, 77, cfg.context_dim),
                          generator=gen)[:1].repeat(SLOTS, 1, 1).cuda()
    evals = collections.Counter()

    def count_eval(module, args, kwargs):
        x, t, ctx, pol = (list(args) + [None, None])[:4]
        evals[(str(getattr(pol, 'name', pol)), ctx is None)] += 1

    hook = pipe.unet.register_forward_pre_hook(count_eval, with_kwargs=True)
    total = collections.Counter()
    two = ['cuda:0', 'cuda:0']
    try:
        # (i) sharded against unsharded, and the plan's launches
        runs = {}
        for name, devices in (('unsharded', None), ('sharded', two)):
            eng = mesh_engine(pipe, context, devices)
            eng.warmup(precisions=('w8a8',))
            out = []
            seen = record_shapes(ops, lambda: out.extend(mesh_run(
                torch, ops, eng, mesh_requests(8), evals)))
            res, launches, wall, peak = out
            shards = 1 if eng.mesh is None else eng.mesh.size
            # every shape a shard's evaluation gave a kernel was held
            # against the plain version in phase 3
            want_shapes = checked[eng.slots // shards]
            for k, shapes in seen.items():
                check(set(shapes) <= want_shapes[k],
                      f'(i) {name}: {k} at shapes phase 3 did not check: '
                      f'{sorted(set(shapes) - want_shapes[k])}')
            print(f'[mesh] (i) {name}: kernel shapes of the run, each held '
                  f'to its plain version in phase 3: '
                  + json.dumps({k: sorted(map(list, v))
                                for k, v in seen.items()}))
            snap = eng.metrics.snapshot()
            n_evals = sum(evals.values())
            want = {'fused_gn_swish': per_eval['fused_gn_swish'] * n_evals,
                    'w8a8_matmul': per_eval['w8a8_matmul'] * n_evals,
                    'flash_attention': 0}
            print(f'[mesh] (i) {name}: {shards} shard(s) x '
                  f'{eng.slots // shards} slots, {snap.ticks} ticks, '
                  f'{n_evals} conditional w8a8 evaluations; launches '
                  f'{launches}, plan {want}')
            check(set(evals) == {('w8a8', False)}
                  and n_evals == shards * snap.ticks > 0,
                  f'(i) {name}: evaluations {dict(evals)} against {shards} '
                  f'shards x {snap.ticks} ticks')
            check(launches == want, f'(i) {name}: launches {launches} != '
                  f'the plan {want}')
            if eng.mesh is not None:
                check(snap.overlapped_decodes > 0 and snap.devices == 2,
                      '(i) sharded: no decode overlapped')
                total.update(launches)
            tick_ms = mesh_tick_ms(torch, eng)
            runs[name] = res
            print(f'[mesh] (i) {card}: {name}: wall {wall:.3f} s, '
                  f'{snap.requests_per_s:.4f} req/s, p50 '
                  f'{snap.p50_latency_s:.3f} s, peak memory {peak:.2f} GiB, '
                  f'one tick over {eng.slots} full slots {tick_ms:.1f} ms')
            del eng
        check_mesh_images(numpy, '(i) sharded vs unsharded', runs['sharded'],
                          runs['unsharded'], W8A8_ATOL)

        # (ii) shrink 2 -> 1 after two ticks, then grow 1 -> 2
        eng = mesh_engine(pipe, context, two)
        eng.warmup(precisions=('w8a8',))
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        for r in mesh_requests(8):
            check(eng.submit(r), f'request {r.request_id} rejected')
        done = eng.tick() + eng.tick()
        done += eng.elastic_resize(devices=['cuda:0'],
                                   precisions=('w8a8',))
        parked = len(eng._parked)
        check(eng.slots == MESH_SPD and parked == SLOTS - MESH_SPD,
              f'(ii) shrink: {eng.slots} slots, {parked} parked')
        done += eng.run_until_idle()
        shrunk_s = time.perf_counter() - t0
        eng.elastic_resize(devices=two, precisions=('w8a8',))
        grown = serve(eng, mesh_requests(4, start=8))
        launches = ops.launch_counts()
        total.update(launches)
        snap = eng.metrics.snapshot()
        print(f'[mesh] (ii) {card}: 8 requests through 2 -> 1 after two '
              f'ticks ({parked} parked) in {shrunk_s:.3f} s, then 1 -> 2 '
              f'and 4 more: {snap.completed} completed, resizes '
              f'{eng.metrics.resizes}, launches {launches}')
        check(eng.slots == SLOTS and snap.resizes == 2 and snap.devices == 2
              and sorted(grown) == list(range(8, 12)),
              f'(ii): slots {eng.slots}, resizes {snap.resizes}, grown '
              f'{sorted(grown)}')
        check(launches['w8a8_matmul'] > 0 and launches['fused_gn_swish'] > 0,
              '(ii): the resized engine launched no path kernel')
        check_mesh_images(numpy, '(ii) resized vs (i)',
                          {r.request_id: r for r in done}, runs['sharded'],
                          W8A8_ATOL)
        del eng

        # (iii) a noisy request on shard 1 (slot 3), beside 3 w8a8 ones,
        # at the paper's noise model and at one thirty times as loud;
        # each level also with the fault of shards drawing their noise at
        # their own shape (the noisy matmul without first_sample: shard 1
        # draws the rows of shard 0), off the main path, which the loud
        # level's check must catch by a margin
        from repro_torch.core import precision
        from repro_torch.core.photonic import noise
        right, paper = noise.noisy_w8a8_matmul, precision.NoiseModel

        def own_shape(*args, first_sample=0, **kw):
            return right(*args, **kw)

        def loud():
            return paper(**LOUD_NOISE)

        for level, model, steps in (('paper', paper, 4),
                                    ('30x', loud, LOUD_STEPS)):
            reqs = (mesh_requests(3, start=40, steps=steps)
                    + mesh_requests(1, start=43, steps=steps,
                                    precision='w8a8+noise'))
            noisy = {}
            for name, devices, draw in (('unsharded', None, right),
                                        ('sharded', two, right),
                                        ('sharded, own-shape draws', two,
                                         own_shape)):
                precision.NoiseModel, noise.noisy_w8a8_matmul = model, draw
                try:
                    eng = mesh_engine(pipe, context, devices)
                    res, launches, wall, _ = mesh_run(torch, ops, eng, reqs,
                                                      evals)
                finally:
                    precision.NoiseModel = paper
                    noise.noisy_w8a8_matmul = right
                if level == 'paper' and name == 'sharded':
                    total.update(launches)
                noisy[name] = res
                print(f'[mesh] (iii) {card}: {level} noise, {name}: 3 w8a8 '
                      f'+ 1 w8a8+noise requests at {steps} steps in '
                      f'{wall:.3f} s; launches {launches}')
                del eng
            check_mesh_images(numpy, f'(iii) {level} noise, noisy on shard '
                              '1, sharded vs unsharded', noisy['sharded'],
                              noisy['unsharded'], W8A8_ATOL)
            wrong = max(float(numpy.abs(
                r.image - noisy['unsharded'][rid].image).max())
                for rid, r in noisy['sharded, own-shape draws'].items())
            print(f'[mesh] (iii) {level} noise, own-shape draws (the '
                  f'fault) vs unsharded: max abs err {wrong:.3e} (tol '
                  f'{W8A8_ATOL})')
            if level == '30x':
                check(wrong > WRONG_DRAW_MARGIN * W8A8_ATOL,
                      f'(iii) own-shape draws off by only {wrong}: the '
                      'check cannot tell them from the right draws')

        # (iv) the CLI's function over a mesh of one
        ops.reset_launches()
        results, s = tserve.serve_diffusion(
            None, STEPS, MESH_CLI_REQUESTS, SERVE_RATE, SLOTS,
            precision='w8a8', quality_probe=0, devices=1, pipe=pipe)
        launches = ops.launch_counts()
        total.update(launches)
        print(f'[mesh] (iv) {card}: serve_diffusion(devices=1): '
              f'{int(s["completed"])} of {MESH_CLI_REQUESTS} at {SERVE_RATE} '
              f'req/s, {s["requests_per_s"]:.4f} req/s, p50 '
              f'{s["p50_latency_ms"] / 1e3:.3f} s, devices '
              f'{int(s["devices"])}; launches {launches}')
        check(len(results) == s['completed'] == MESH_CLI_REQUESTS
              and s['devices'] == 1, '(iv): requests lost on a mesh of one')

        # (i) over two real cards, where there are two
        if torch.cuda.device_count() >= 2:
            eng = mesh_engine(pipe, context, ['cuda:0', 'cuda:1'])
            eng.warmup(precisions=('w8a8',))
            res, launches, wall, _ = mesh_run(torch, ops, eng,
                                              mesh_requests(8), evals)
            total.update(launches)
            print(f'[mesh] (i) over cuda:0 and cuda:1: wall {wall:.3f} s, '
                  f'launches {launches}')
            check(launches['w8a8_matmul'] == per_eval['w8a8_matmul']
                  * sum(evals.values()) > 0, '(i) two cards: launches')
            check_mesh_images(numpy, '(i) two cards vs one', res,
                              runs['unsharded'], W8A8_ATOL)
            del eng
        else:
            print('[mesh] (i) over two real cards: skipped, '
                  f'{torch.cuda.device_count()} card visible')
    finally:
        hook.remove()
    return total


def phase_train(torch, ops, card):
    """Phase 11: training, every earlier model freed.  (a) the smoke
    configs of ``TRAIN_SMALL_ARCHS`` on the card against the CPU, and a
    ``Trainer``'s resume on the card; (b) InternLM2-1.8B at full width
    and depth (``train_full``), whose run it returns for phase 14."""
    gc.collect()
    torch.cuda.empty_cache()
    print(f'[train] {torch.cuda.memory_allocated() / 2**30:.2f} GiB '
          'allocated on the card before training')
    for arch in TRAIN_SMALL_ARCHS:
        train_small(torch, ops, arch)
    train_resume(torch)
    return train_full(torch, ops, card)


def train_small(torch, ops, arch):
    """``TRAIN_SMALL_STEPS`` train steps of the smoke ``arch`` at float32
    on the card and on the CPU from the same parameters and
    ``token_batch`` batches (4 x 64): losses and grad norms compared step
    by step, and no kernel launched."""
    import copy
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.pipeline import TokenPipelineConfig, token_batch
    from repro_torch.launch import steps as ST
    from repro_torch.optim.adamw import AdamWConfig, init_adamw
    cfg = smoke_config(arch)
    models = {'cpu': ST.init_params(torch.Generator().manual_seed(0), cfg,
                                    'cpu')}
    models['cuda'] = copy.deepcopy(models['cpu']).to('cuda')
    step = ST.build_train_step(cfg, AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=TRAIN_SMALL_STEPS),
        dtype=torch.float32)
    data = TokenPipelineConfig(cfg.vocab, seq_len=64, global_batch=4)
    opts = {d: init_adamw(list(ST.train_params(m).values()))
            for d, m in models.items()}
    ops.reset_launches()
    errs, losses = [], []
    for s in range(TRAIN_SMALL_STEPS):
        out = {}
        for d in models:
            models[d], opts[d], m = step(models[d], opts[d],
                                         token_batch(data, s, device=d))
            out[d] = (m['loss'].item(), m['grad_norm'].item())
        errs.append(max(abs(a - b) / abs(b)
                        for a, b in zip(out['cuda'], out['cpu'])))
        losses.append(out['cpu'][0])
    launches = sum(ops.launch_counts().values())
    print(f'[train-small] {cfg.name}: {TRAIN_SMALL_STEPS} steps of 4 x 64 '
          f'tokens, losses {[round(x, 4) for x in losses]}; card vs CPU '
          f'max relative err of loss and grad norm {max(errs):.3e} (tol '
          f'{TRAIN_SMALL_RTOL}); kernel launches {launches}')
    check(max(errs) <= TRAIN_SMALL_RTOL, f'train {cfg.name}: card vs CPU '
          f'{errs} > {TRAIN_SMALL_RTOL}')
    check(launches == 0, f'train {cfg.name}: {launches} kernel launches')


def train_resume(torch):
    """A ``Trainer`` on the card (the smoke InternLM2): 4 steps in one
    run against 2 steps, a checkpoint under ``build/train-smoke``, a new
    ``Trainer`` that restores it and 2 more steps; losses and final
    parameters compared."""
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.pipeline import TokenPipelineConfig
    from repro_torch.launch.train import Trainer
    from repro_torch.optim.adamw import AdamWConfig
    cfg = smoke_config(LM_ARCH)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    data = TokenPipelineConfig(cfg.vocab, seq_len=64, global_batch=4)
    shutil.rmtree(TRAIN_OUT, ignore_errors=True)
    whole = Trainer(cfg, opt, device='cuda')
    want = whole.run(data, 4, log_every=100)
    first = Trainer(cfg, opt, ckpt_dir=str(TRAIN_OUT), device='cuda')
    got = first.run(data, 2, log_every=100)
    second = Trainer(cfg, opt, ckpt_dir=str(TRAIN_OUT), device='cuda')
    second.maybe_restore()
    check(second.start_step == 2 and second.opt.step.item() == 2,
          f'resume: start step {second.start_step}, optimizer step '
          f'{second.opt.step.item()}; want 2')
    got += second.run(data, 4, log_every=100)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    param_err = max((a - b).abs().max().item() for a, b in zip(
        second.params.parameters(), whole.params.parameters()))
    print(f'[train-small] {cfg.name} Trainer on the card: 4 steps against '
          f'2 + checkpoint ({TRAIN_OUT.relative_to(ROOT)}, steps '
          f'{sorted(os.listdir(TRAIN_OUT))}) + restore + 2: losses '
          f'{[round(x, 5) for x in want]}, max relative err {loss_err:.3e}; '
          f'parameters max abs err {param_err:.3e} (tol {TRAIN_RESUME_TOL})')
    check(len(got) == 4 and loss_err <= TRAIN_RESUME_TOL
          and param_err <= TRAIN_RESUME_TOL,
          f'resume: losses {got} vs {want}, parameters {param_err}')


def train_full(torch, ops, card):
    """InternLM2-1.8B at full width and depth through ``Trainer.run``:
    ``TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens,
    float32, remat 'full', no checkpoint (parameters and moments are 22.7
    GB).  Checks: finite losses and grad norms, the first loss within
    ``TRAIN_LOSS0_ATOL`` of ln V + 0.02^2 d / 2, no kernel launched, and
    one more step on step 0's batch from the initial state lowering that
    batch's loss.  Prints the parameter count, the seconds of the first
    step and of the steady ones, tokens/s, model FLOPs a step (6 N
    tokens over the matmul parameters, the remat forward of the blocks,
    attention's scores and products) and their share of the float32
    peak, and the peak memory."""
    from repro_torch.configs.registry import get
    from repro_torch.data.pipeline import TokenPipelineConfig, token_batch
    from repro_torch.launch import steps as ST
    from repro_torch.launch.train import Trainer
    from repro_torch.models import layers as L
    from repro_torch.optim.adamw import AdamWConfig, init_adamw
    cfg = get(LM_ARCH)
    check(cfg.remat == 'full' and not cfg.tie_embeddings,
          f'{cfg.name}: remat {cfg.remat}, tied {cfg.tie_embeddings}')
    t0 = time.perf_counter()
    tr = Trainer(cfg, AdamWConfig(lr=1e-3, warmup_steps=2,
                                  total_steps=TRAIN_STEPS), device='cuda')
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tr.params.parameters())
    mm_blocks = sum(m.w.numel() for m in tr.params.blocks.modules()
                    if isinstance(m, L.Linear))
    mm_head = tr.params.lm_head.w.numel()
    print(f'[train-full] {cfg.name}: {n_params:,} parameters '
          f'({4 * n_params / 2**30:.1f} GiB; {mm_blocks + mm_head:,} in '
          f'matmuls) drawn on the card from seed 0 in '
          f'{time.perf_counter() - t0:.1f} s; {cfg.n_layers} layers, remat '
          f'{cfg.remat}')
    tokens = TRAIN_BATCH * TRAIN_SEQ
    attn = 4 * 4 * TRAIN_BATCH * cfg.n_heads * TRAIN_SEQ ** 2 * cfg.hd * \
        attention_layers(cfg)            # forward, 2x backward, remat
    flops = 6 * (mm_blocks + mm_head) * tokens + 2 * mm_blocks * tokens + attn
    init = [p.detach().to('cpu', copy=True)
            for p in ST.train_params(tr.params).values()]
    step_fn = tr.step_fn
    times, norms = timed_steps(torch, tr)
    data = TokenPipelineConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()               # the training run starts here
    losses = tr.run(data, TRAIN_STEPS, log_every=1)
    launches = ops.launch_counts()     # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 2**30
    steady = statistics.median(times[1:])
    print(f'[train-full] {card}: {cfg.name} {TRAIN_STEPS} steps of '
          f'{TRAIN_BATCH} x {TRAIN_SEQ} tokens, float32 (TF32 off): first '
          f'step {times[0]:.3f} s, steady {steady:.3f} s (median of '
          f'{len(times) - 1}: {[round(t, 3) for t in times[1:]]}) = '
          f'{tokens / steady:.1f} tokens/s; model FLOPs a step '
          f'{flops / 1e12:.2f} T (attention {attn / 1e12:.2f} T) = '
          f'{flops / steady / 1e12:.1f} TFLOP/s, '
          f'{100 * flops / steady / F32_OPS_PER_S:.1f}% of the float32 '
          f'peak ({F32_OPS_PER_S / 1e12:.0f} TFLOP/s; bound '
          f'{flops / F32_OPS_PER_S:.3f} s); peak memory {peak:.2f} GiB; '
          f'losses {[round(x, 4) for x in losses]}, grad norms '
          f'{[round(x, 4) for x in norms]}; launches {launches}')
    check(len(losses) == TRAIN_STEPS
          and all(math.isfinite(x) for x in losses + norms),
          f'{cfg.name} training: losses {losses}, grad norms {norms}')
    expected0 = math.log(cfg.vocab) + 0.02 ** 2 * cfg.d_model / 2
    check(abs(losses[0] - expected0) <= TRAIN_LOSS0_ATOL,
          f'{cfg.name}: first loss {losses[0]}, expected {expected0:.3f} '
          f'+- {TRAIN_LOSS0_ATOL}')
    check(sum(launches.values()) == 0,
          f'{cfg.name}: training launched kernels {launches}')

    # the direction check: the initial state again, one more step on
    # step 0's batch, and that batch's loss after it
    tr.step_fn, tr.opt = step_fn, None
    params = list(ST.train_params(tr.params).values())
    with torch.no_grad():
        for p, h in zip(params, init):
            p.copy_(h)
    del init
    batch0 = token_batch(data, 0, device='cuda')
    ops.reset_launches()
    _, _, m = step_fn(tr.params, init_adamw(params), batch0)
    with torch.no_grad():
        after = ST.train_loss(tr.params, cfg, batch0, torch.float32).item()
    before = m['loss'].item()
    extra = sum(ops.launch_counts().values())
    print(f"[train-full] {cfg.name}: one more step on step 0's batch from "
          f'the initial state: loss {before:.5f} (the run\'s first '
          f'{losses[0]:.5f}, expected {expected0:.3f}) -> {after:.5f}; '
          f'kernel launches {extra}')
    check(abs(before - losses[0]) <= 1e-5 * losses[0],
          f'{cfg.name}: the restored initial state gives loss {before}, '
          f'the run\'s first step {losses[0]}')
    check(after < before, f'{cfg.name}: a step on a batch did not lower '
          f'its loss: {before} -> {after}')
    check(extra == 0, f'{cfg.name}: the extra step launched {extra} kernels')
    del tr, params, m
    gc.collect()
    torch.cuda.empty_cache()
    return {'losses': losses, 'norms': norms, 'first': times[0],
            'steady': steady, 'peak': peak}


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def timed_steps(torch, tr):
    """Wrap ``tr.step_fn`` to record each step's seconds (synchronized
    on the card) and grad norm; returns the two lists."""
    times, norms = [], []
    step_fn = tr.step_fn

    def timed(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step_fn(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        norms.append(out[2]['grad_norm'].item())
        return out

    tr.step_fn = timed
    return times, norms


def rel_err(got, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def phase_mesh_train(torch, ops, card, single):
    """Phase 14: sharded training.  ``single`` is phase 11 (b)'s run."""
    mesh_one_rank(torch, ops, card, single)
    mesh_ranks(torch, card)


def mesh_one_rank(torch, ops, card, single):
    """(a) InternLM2-1.8B at full width and depth on a (1, 1) mesh, one
    rank under nccl, phase 11 (b)'s traffic, against phase 11 (b)."""
    import torch.distributed as dist
    from repro_torch.configs.registry import get
    from repro_torch.data.pipeline import TokenPipelineConfig
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import Trainer
    from repro_torch.optim.adamw import AdamWConfig
    cfg = get(LM_ARCH)
    dist.init_process_group('nccl', init_method=f'tcp://localhost:'
                            f'{free_port()}', rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ('data', 'model'), 'cuda')
        tr = Trainer(cfg, AdamWConfig(lr=1e-3, warmup_steps=2,
                                      total_steps=TRAIN_STEPS),
                     device='cuda', mesh=mesh)
        params = ST.train_params(tr.params).values()
        check(all(SH.is_dtensor(p) and p.to_local().is_cuda
                  for p in params) and
              all(SH.is_dtensor(m) for m in tr.opt.m + tr.opt.v),
              'the (1, 1) mesh holds a parameter or moment that is not a '
              'DTensor on the card')
        times, norms = timed_steps(torch, tr)
        data = TokenPipelineConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()           # the sharded run starts here
        losses = tr.run(data, TRAIN_STEPS, log_every=TRAIN_STEPS)
        launches = ops.launch_counts()  # ... and ends here
        peak = torch.cuda.max_memory_allocated() / 2**30
        steady = statistics.median(times[1:])
        tokens = TRAIN_BATCH * TRAIN_SEQ
        err_l = rel_err(losses, single['losses'])
        err_n = rel_err(norms, single['norms'])
        print(f'[mesh-train] {card}: (a) {cfg.name} full width and depth '
              f'on a (1, 1) nccl mesh (DTensor parameters and moments), '
              f'{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens: '
              f'first step {times[0]:.3f} s, steady {steady:.3f} s '
              f'({[round(t, 3) for t in times[1:]]}) = '
              f'{tokens / steady:.1f} tokens/s, peak memory {peak:.2f} GiB; '
              f'phase 11 (b): first {single["first"]:.3f} s, steady '
              f'{single["steady"]:.3f} s = '
              f'{tokens / single["steady"]:.1f} tokens/s, peak '
              f'{single["peak"]:.2f} GiB; losses '
              f'{[round(x, 5) for x in losses]}'
              f' against phase 11: max relative err {err_l:.3e}, grad norms '
              f'{err_n:.3e} (tol {MESH_ONE_RTOL}); launches {launches}')
        check(len(losses) == TRAIN_STEPS and err_l <= MESH_ONE_RTOL
              and err_n <= MESH_ONE_RTOL,
              f'(1, 1) mesh: losses {losses} / norms {norms} against '
              f'{single}')
        check(sum(launches.values()) == 0,
              f'(1, 1) mesh training launched kernels {launches}')
        del tr, params
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()


def mesh_cfg():
    """(b)'s model: InternLM2-1.8B at full width, ``MESH_LAYERS`` deep."""
    import dataclasses
    from repro_torch.configs.registry import get
    return dataclasses.replace(get(LM_ARCH), n_layers=MESH_LAYERS)


def mesh_opt(steps):
    from repro_torch.optim.adamw import AdamWConfig
    return AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=steps)


def mesh_data(cfg, batch=MESH_BATCH, seq=MESH_SEQ):
    from repro_torch.data.pipeline import TokenPipelineConfig
    return TokenPipelineConfig(cfg.vocab, seq, batch)


def gloo_collectives(torch, dist, world):
    """Every collective the phase reaches, once on CUDA tensors under
    gloo: {name: 'ok' or the error}."""
    dev = torch.device('cuda', 0)
    x = torch.arange(8, dtype=torch.float32, device=dev)
    calls = {
        'all_reduce': lambda: dist.all_reduce(x.clone()),
        'broadcast': lambda: dist.broadcast(x.clone(), 0),
        'all_gather_into_tensor': lambda: dist.all_gather_into_tensor(
            torch.empty(8 * world, device=dev), x),
        'reduce_scatter_tensor': lambda: dist.reduce_scatter_tensor(
            torch.empty(8 // world, device=dev), x),
        'all_to_all_single': lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
        'barrier': dist.barrier,
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
            out[name] = 'ok'
        except Exception as e:             # the phase reports every one
            out[name] = f'{type(e).__name__}: {str(e)[:160]}'
    return out


def mesh_rank(rank, world, port, out_dir):
    """One rank of (b) and (c), started by ``torch.multiprocessing``: its
    results in ``out_dir/{rank}.pt``, its traceback in ``{rank}.err``."""
    import datetime
    import traceback
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}',
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        torch.save(mesh_rank_work(torch, dist, rank, world),
                   os.path.join(out_dir, f'{rank}.pt'))
    except BaseException:
        with open(os.path.join(out_dir, f'{rank}.err'), 'w') as f:
            f.write(traceback.format_exc())
        os._exit(1)
    dist.destroy_process_group()


def mesh_rank_work(torch, dist, rank, world):
    import logging
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.pipeline import token_batch
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import Trainer
    logging.getLogger('torch.distributed.tensor').setLevel(logging.ERROR)
    out = {'collectives': gloo_collectives(torch, dist, world)}
    if any(v != 'ok' for v in out['collectives'].values()):
        return out
    ops.reset_launches()
    mesh = make_mesh(MESH_SHAPE, ('data', 'model'), 'cuda')
    # (c) one step of each smoke family
    out['families'] = {}
    for arch in TRAIN_SMALL_ARCHS:
        cfg = smoke_config(arch)
        tr = Trainer(cfg, mesh_opt(1), device='cuda', mesh=mesh)
        _, _, m = tr.step_fn(tr.params, tr.opt,
                             token_batch(mesh_data(cfg, 4, 64), 0,
                                         device='cuda'))
        out['families'][arch] = (m['loss'].item(), m['grad_norm'].item())
        del tr
    # (b) full width, MESH_LAYERS deep
    cfg = mesh_cfg()
    ckpt = str(MESH_OUT)
    if rank == 0:
        shutil.rmtree(MESH_OUT, ignore_errors=True)
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, mesh_opt(MESH_STEPS), ckpt_dir=ckpt, device='cuda',
                 mesh=mesh)
    params = ST.train_params(tr.params)
    out['local_on_cuda'] = all(SH.is_dtensor(p) and p.to_local().is_cuda
                               for p in params.values())
    out['sharded_both'] = sum(
        all(pl.is_shard() for pl in p.placements) for p in params.values())
    out['local_bytes'] = sum(p.to_local().numel() * 4
                             for p in params.values())
    times, norms = timed_steps(torch, tr)
    out['losses'] = tr.run(mesh_data(cfg), MESH_STEPS, log_every=MESH_STEPS)
    out['times'], out['norms'] = times, norms
    out['peak'] = torch.cuda.max_memory_allocated() / 2**30
    del tr, params
    gc.collect()
    torch.cuda.empty_cache()
    # restored onto (4, 1)
    mesh2 = make_mesh((world, 1), ('data', 'model'), 'cuda')
    tr = Trainer(cfg, mesh_opt(MESH_STEPS), ckpt_dir=ckpt, device='cuda',
                 mesh=mesh2)
    tr.maybe_restore()
    out['restored_at'] = tr.start_step
    out['restored'] = restored_equal(torch, tr) if rank == 0 else None
    if rank != 0:
        restored_equal(torch, tr, gather_only=True)
    out['launches'] = sum(ops.launch_counts().values())
    return out


def restored_equal(torch, tr, gather_only=False):
    """The parameters of ``tr`` gathered whole (a collective) against the
    arrays of its checkpoint's latest step: the names that differ."""
    import numpy
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import steps as ST
    full = {n: (p.full_tensor() if SH.is_dtensor(p) else p).detach().cpu()
            for n, p in ST.train_params(tr.params).items()}
    if gather_only:
        return None
    sd = MESH_OUT / f'step_{tr.ckpt.latest_step():08d}'
    with open(sd / 'meta.json') as f:
        meta = json.load(f)
    with numpy.load(sd / 'arrays.npz') as data:
        saved = {n[len('params.'):]: data[f'a{i}']
                 for i, n in enumerate(meta['names'])
                 if n.startswith('params.')}
    bad = [n for n, a in saved.items()
           if n not in full or not numpy.array_equal(full[n].numpy(), a)]
    return {'differ': bad, 'n': len(saved), 'mesh': meta['mesh']}


def mesh_ranks(torch, card):
    """(b) and (c): ``MESH_RANKS`` gloo ranks on cuda:0, then the
    single-device references and the (1, 1) restore in this process."""
    import tempfile
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.pipeline import token_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import Trainer
    t0 = time.perf_counter()
    ctx = mp.get_context('spawn')
    with tempfile.TemporaryDirectory() as out_dir:
        port = free_port()
        procs = [ctx.Process(target=mesh_rank,
                             args=(r, MESH_RANKS, port, out_dir))
                 for r in range(MESH_RANKS)]
        for p in procs:
            p.start()
        deadline = time.time() + MESH_TIMEOUT_S
        try:
            while any(p.exitcode is None for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs) or \
                        time.time() > deadline:
                    errs = [open(os.path.join(out_dir, n)).read()
                            for n in sorted(os.listdir(out_dir))
                            if n.endswith('.err')]
                    raise AssertionError(
                        f'phase 14 ranks failed or timed out: exit codes '
                        f'{[p.exitcode for p in procs]}\n' + ''.join(errs[:1]))
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        res = [torch.load(os.path.join(out_dir, f'{r}.pt'),
                          weights_only=False) for r in range(MESH_RANKS)]
    wall = time.perf_counter() - t0
    coll = res[0]['collectives']
    print(f'[mesh-train] {card}: (b) gloo on CUDA tensors, {MESH_RANKS} '
          f'ranks on cuda:0 (torch {torch.__version__}): {coll}')
    check(all(v == 'ok' for r in res for v in r['collectives'].values()),
          f'gloo lacks a collective on CUDA tensors: {coll}')
    # (c) the smoke families against one step on the card
    for arch in TRAIN_SMALL_ARCHS:
        cfg = smoke_config(arch)
        tr = Trainer(cfg, mesh_opt(1), device='cuda')
        _, _, m = tr.step_fn(tr.params, tr.opt,
                             token_batch(mesh_data(cfg, 4, 64), 0,
                                         device='cuda'))
        want = (m['loss'].item(), m['grad_norm'].item())
        got = res[0]['families'][arch]
        err = rel_err(got, want)
        print(f'[mesh-train] (c) {cfg.name} on the {MESH_SHAPE} card mesh: '
              f'loss {got[0]:.6f}, grad norm {got[1]:.6f}; one card '
              f'{want[0]:.6f}, {want[1]:.6f}: max relative err {err:.3e} '
              f'(tol {MESH_RTOL})')
        check(err <= MESH_RTOL and all(r['families'][arch] == got
                                       for r in res),
              f'{cfg.name} on the card mesh: {got} against {want}')
        del tr
    # (b) against a single-device Trainer of the same config on the card
    cfg = mesh_cfg()
    tr = Trainer(cfg, mesh_opt(MESH_STEPS), device='cuda')
    times, norms = timed_steps(torch, tr)
    want = tr.run(mesh_data(cfg), MESH_STEPS, log_every=MESH_STEPS)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    r0 = res[0]
    err_l, err_n = rel_err(r0['losses'], want), rel_err(r0['norms'], norms)
    tokens = MESH_BATCH * MESH_SEQ
    print(f'[mesh-train] {card}: (b) {cfg.name} at full width, '
          f'{MESH_LAYERS} layers, on a {MESH_SHAPE} gloo mesh of '
          f'{MESH_RANKS} ranks on cuda:0: {MESH_STEPS} steps of '
          f'{MESH_BATCH} x {MESH_SEQ} tokens, step seconds '
          f'{[round(t, 3) for t in r0["times"]]} (one card '
          f'{[round(t, 3) for t in times]}), steady '
          f'{tokens / statistics.median(r0["times"][1:]):.1f} tokens/s; '
          f'peak memory per rank {[round(r["peak"], 2) for r in res]} GiB, '
          f'local parameters {r0["local_bytes"] / 2**30:.2f} GiB a rank, '
          f'{r0["sharded_both"]} parameters sharded on both axes; losses '
          f'{[round(x, 5) for x in r0["losses"]]} against one card '
          f'{[round(x, 5) for x in want]}: max relative err {err_l:.3e}, '
          f'grad norms {err_n:.3e} (tol {MESH_RTOL}); every local shard on '
          f'cuda: {all(r["local_on_cuda"] for r in res)}; kernel launches '
          f'per rank {[r["launches"] for r in res]}; {wall:.1f} s for the '
          f'ranks')
    check(err_l <= MESH_RTOL and err_n <= MESH_RTOL,
          f'(2, 2) mesh: losses {r0["losses"]} against {want}')
    check(all(r['local_on_cuda'] for r in res) and r0['sharded_both'] > 0,
          'a rank holds a local shard off the card or nothing is sharded '
          'on both axes')
    check(all(r['losses'] == r0['losses'] for r in res),
          'the ranks disagree on the losses')
    check(all(r['launches'] == 0 for r in res),
          f'the card mesh launched kernels {[r["launches"] for r in res]}')
    # the (2, 2) checkpoint restored onto (4, 1) and (1, 1)
    rest = r0['restored']
    check(r0['restored_at'] == MESH_STEPS and not rest['differ']
          and rest['mesh'] == {'shape': list(MESH_SHAPE),
                               'axes': ['data', 'model']},
          f'(2, 2) checkpoint onto ({MESH_RANKS}, 1): {rest}')
    dist.init_process_group('gloo', init_method=f'tcp://localhost:'
                            f'{free_port()}', rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ('data', 'model'), 'cuda')
        tr = Trainer(cfg, mesh_opt(MESH_STEPS), ckpt_dir=str(MESH_OUT),
                     device='cuda', mesh=mesh)
        tr.maybe_restore()
        one = restored_equal(torch, tr)
        start = tr.start_step
        del tr
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    print(f'[mesh-train] (b) checkpoint saved on {MESH_SHAPE} '
          f'({MESH_OUT.relative_to(ROOT)}, mesh {rest["mesh"]}) restored '
          f'onto ({MESH_RANKS}, 1) and (1, 1) at step {start}: '
          f'{rest["n"]} parameters, differing from the saved arrays '
          f'{rest["differ"]} and {one["differ"]}')
    check(start == MESH_STEPS and not one['differ'],
          f'(2, 2) checkpoint onto (1, 1): {one}')


def tiny_sd():
    """Phase 4's tiny SD-shaped model: its UNet and VAE configs."""
    from repro_torch.models.autoencoder import VAEConfig
    from repro_torch.models.unet import UNetConfig
    return (UNetConfig('tiny-sd', img_size=8, in_ch=4, base_ch=32,
                       ch_mults=(1, 2), n_res_blocks=1, attn_resolutions=(4,),
                       n_heads=4, context_dim=16, timesteps=16, latent=True),
            VAEConfig(img_size=16, in_ch=3, z_ch=4, base_ch=16,
                      ch_mults=(1, 2), groups=8))


def unet_apply(unet, x, t, context):
    """``ddpm_loss``'s ``unet_apply_fn``: the UNet's fp32 forward."""
    return unet(x, t, context)


def max_err(a, b) -> float:
    return float((a.detach().cpu() - b.detach().cpu()).abs().max())


def phase_ddpm(torch, numpy, ops, card, checked):
    """Phase 13: the DDPM path and the latent-diffusion gradient step
    (``ddpm_small``, ``ddpm_gn_grad``, ``ddpm_sample_full``,
    ``ddpm_step_full``).  Returns the launches of (c) and (d)."""
    from repro_torch.configs.diffusion import SD_V1_4, VAE_512
    from repro_torch.diffusion.pipeline import DiffusionPipeline
    from repro_torch.models import layers as L
    from repro_torch.models.autoencoder import VAEEncoder
    ddpm_small(torch, numpy, ops)
    t0 = time.perf_counter()
    pipe = DiffusionPipeline.init(0, SD_V1_4, VAE_512,
                                  timesteps=DDPM_TIMESTEPS, device='cuda')
    enc = VAEEncoder(VAE_512)
    L.init_params(enc, torch.Generator().manual_seed(0))
    enc = enc.to('cuda').eval()
    print(f'[ddpm] SD v1.4 + VAE 512 decoder and a VAE 512 encoder from '
          f'seed 0 in {time.perf_counter() - t0:.1f} s; schedule of '
          f'{pipe.sched.T} steps')
    ddpm_gn_grad(torch, ops, pipe, checked)
    launches = collections.Counter(
        ddpm_sample_full(torch, numpy, ops, card, pipe))
    launches.update(ddpm_step_full(torch, ops, card, pipe, enc))
    del pipe, enc
    gc.collect()
    torch.cuda.empty_cache()
    print(f'[ddpm] {torch.cuda.memory_allocated() / 2**30:.2f} GiB '
          'allocated on the card after the phase')
    return launches


def ddpm_small(torch, numpy, ops):
    """(a) Phase 4's tiny model on the card against the CPU, from one
    seed: DDPM sampling at T = 16 (fp32 guided, w8a8 unguided),
    ``generate_deepcache`` (interval 1 against ``generate``, interval 2
    card against CPU), ``image_batch``, ``vae_encode`` (mean and with a
    key) and ``ddpm_loss`` with the gradient of every UNet parameter."""
    from repro_torch.core import prng
    from repro_torch.data.pipeline import ImagePipelineConfig, image_batch
    from repro_torch.diffusion.pipeline import DiffusionPipeline
    from repro_torch.launch.steps import train_params
    from repro_torch.models import layers as L
    from repro_torch.models.autoencoder import VAEEncoder, vae_encode
    from repro_torch.diffusion.schedule import ddpm_loss
    cfg, vae = tiny_sd()
    cpu = DiffusionPipeline.init(1, cfg, vae, device='cpu')
    pipes = {'cuda': cpu.to('cuda'), 'cpu': cpu}
    ctx = torch.randn((2, 5, 16), generator=torch.Generator().manual_seed(2))

    def both(what, fn, tol):
        out = {dev: fn(dev, p) for dev, p in pipes.items()}
        a, b = out['cuda'], out['cpu']
        check(tuple(a.shape) == tuple(b.shape)
              and bool(torch.isfinite(a).all()),
              f'small {what}: bad output {tuple(a.shape)}')
        err = max_err(a, b)
        print(f'[ddpm-small] {what}: card vs CPU max abs err {err:.3e} '
              f'(tol {tol})')
        check(err <= tol, f'small {what}: card vs CPU {err} > {tol}')
        return out

    both(f'generate(sampler=ddpm) T={cfg.timesteps} fp32 guided '
         f'{GUIDANCE}', lambda d, p: p.generate(
             13, batch=2, sampler='ddpm', context=ctx.to(d),
             guidance=GUIDANCE), FP32_ATOL)
    both(f'generate(sampler=ddpm) T={cfg.timesteps} w8a8 unguided',
         lambda d, p: p.generate(14, batch=2, sampler='ddpm',
                                 policy='w8a8'), W8A8_ATOL)
    gpu = pipes['cuda']
    a = gpu.generate(15, batch=2, steps=4, context=ctx.cuda())
    b = gpu.generate_deepcache(15, batch=2, steps=4, interval=1,
                               context=ctx.cuda())
    err = max_err(a, b)
    print(f'[ddpm-small] generate_deepcache interval 1 vs generate on the '
          f'card: max abs err {err:.3e} (tol {DEEPCACHE_EQ_ATOL})')
    check(err <= DEEPCACHE_EQ_ATOL, f'generate_deepcache(interval=1) is '
          f'{err} from generate')
    both('generate_deepcache interval 2', lambda d, p: p.generate_deepcache(
        15, batch=2, steps=4, interval=2, context=ctx.to(d)), FP32_ATOL)
    icfg = ImagePipelineConfig(vae.img_size, vae.in_ch, 2, seed=0)
    imgs = both('image_batch', lambda d, p: image_batch(icfg, 0, device=d),
                IMAGE_ATOL)
    enc_cpu = VAEEncoder(vae)
    L.init_params(enc_cpu, torch.Generator().manual_seed(1))
    encs = {'cpu': enc_cpu, 'cuda': copy.deepcopy(enc_cpu).cuda()}
    with torch.no_grad():
        both('vae_encode mean', lambda d, p: vae_encode(encs[d], imgs[d]),
             FP32_ATOL)
        x0 = both('vae_encode with a key', lambda d, p: vae_encode(
            encs[d], imgs[d], prng.PRNGKey(4)), FP32_ATOL)
    grads = {}

    def loss_fn(dev, p):
        unet = copy.deepcopy(p.unet)
        params = train_params(unet)
        loss = ddpm_loss(unet_apply, p.sched, unet, x0[dev], prng.PRNGKey(5),
                         ctx.to(dev))
        grads[dev] = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        return loss.detach().reshape(1)

    before = ops.launch_counts()['fused_gn_swish']
    both('ddpm_loss', loss_fn, FP32_ATOL)
    check(ops.launch_counts()['fused_gn_swish'] - before == 17,
          'small ddpm_loss: GroupNorm+swish launches on the card != 17')
    errs = {n: max_err(grads['cuda'][n], g) for n, g in grads['cpu'].items()}
    worst = max(errs, key=errs.get)
    zero = [n for n, g in grads['cuda'].items() if float(g.abs().max()) == 0]
    print(f'[ddpm-small] ddpm_loss gradient of {len(errs)} UNet parameters: '
          f'card vs CPU max abs err {errs[worst]:.3e} ({worst}; tol '
          f'{FP32_ATOL}); zero gradients: {zero}')
    check(errs[worst] <= FP32_ATOL and not zero,
          f'small ddpm_loss gradients: {worst} {errs[worst]}, zero {zero}')


def ddpm_gn_grad(torch, ops, pipe, checked):
    """(b) The GroupNorm+swish kernel's gradient at every GroupNorm shape
    of the SD v1.4 UNet at batch ``SLOTS`` (phase 3's): ``GNSwish``'s
    (dx, dscale, dbias) against autograd through ``gn_swish_plain`` on
    the same card inputs, within ``GN_GRAD_RTOL`` of the largest, and
    the time of forward plus backward of each per UNet evaluation, with
    the host (``time_ms``) and without (``graph_ms``), beside the bound
    (x and the output's gradient read once, dx written once)."""
    from repro_torch.kernels import fused_gn_swish as gnk
    cfg = pipe.unet_cfg
    x = torch.randn((SLOTS, cfg.img_size, cfg.img_size, cfg.in_ch),
                    device='cuda')
    t = torch.full((SLOTS,), 50, device='cuda')
    ctx = torch.randn((SLOTS, 77, cfg.context_dim), device='cuda')
    with torch.no_grad():
        shapes = record_shapes(ops, lambda: pipe.unet(x, t, ctx))
    shapes = shapes['fused_gn_swish']
    check(set(shapes) == checked[SLOTS]['fused_gn_swish']
          and sum(shapes.values()) == 45,
          f'GroupNorm shapes at batch {SLOTS} differ from phase 3\'s')
    gen = torch.Generator(device='cuda').manual_seed(3)
    tot = dict.fromkeys(('function_ms', 'plain_ms', 'function_device_ms',
                         'plain_device_ms', 'bound_ms'), 0.0)
    worst = 0.0
    for shape, count in sorted(shapes.items()):
        N, H, W, C, g = shape
        xg = torch.randn((N, H, W, C), device='cuda', generator=gen)
        sc = torch.randn(C, device='cuda', generator=gen)
        bi = torch.randn(C, device='cuda', generator=gen)
        dout = torch.randn((N, H, W, C), device='cuda', generator=gen)
        ins = [v.clone().requires_grad_() for v in (xg, sc, bi)]

        def function():
            return torch.autograd.grad(
                ops.fused_gn_swish(*ins, groups=g), ins, dout)

        def plain():
            return torch.autograd.grad(gnk.gn_swish_plain(*ins, g), ins,
                                       dout)
        errs = []
        for got, want in zip(function(), plain()):
            errs.append(max_err(got, want)
                        / max(float(want.abs().max()), 1e-30))
        worst = max(worst, max(errs))
        check(max(errs) <= GN_GRAD_RTOL, f'GNSwish gradient at {shape}: '
              f'relative err {errs} > {GN_GRAD_RTOL}')
        # inputs x, dout (and the vectors) read once, dx written once
        nbytes = 3 * N * H * W * C * 4 + 5 * C * 4
        row = {'function_ms': time_ms(torch, function),
               'plain_ms': time_ms(torch, plain),
               'function_device_ms': graph_ms(torch, function),
               'plain_device_ms': graph_ms(torch, plain),
               'bound_ms': nbytes / HBM_BYTES_PER_S * 1e3}
        for k in tot:
            tot[k] += count * row[k]
        print('[ddpm-grad] shape ' + json.dumps(
            {'shape': list(shape), 'per_eval': count,
             'rel_err_dx_dscale_dbias': errs, **row}))
    print(f'[ddpm-grad] GroupNorm+swish forward + backward per SD v1.4 '
          f'evaluation at batch {SLOTS} (45 calls): GNSwish (kernel '
          f'forward, plain backward) {tot["function_ms"]:.3f} ms (device '
          f'{tot["function_device_ms"]:.3f}), plain forward + autograd '
          f'{tot["plain_ms"]:.3f} ms (device {tot["plain_device_ms"]:.3f});'
          f' bound {tot["bound_ms"]:.3f} ms (bytes); largest relative err '
          f'{worst:.3e} (tol {GN_GRAD_RTOL})')


def ddpm_sample_full(torch, numpy, ops, card, pipe):
    """(c) DDPM ancestral sampling of SD v1.4 + VAE 512 at batch
    ``DDPM_BATCH`` over all ``DDPM_TIMESTEPS`` steps: fp32 guided at
    ``GUIDANCE`` over a random 77 x 768 context, then w8a8 unconditional;
    finite 512 x 512 x 3 images in [-1, 1] and launches held to the plan
    per evaluation (45 GroupNorm+swish; under w8a8 128 W8A8 conditional,
    64 unconditional)."""
    ctx = torch.randn((DDPM_BATCH, 77, pipe.unet_cfg.context_dim),
                      generator=torch.Generator().manual_seed(3)).cuda()
    launches = collections.Counter()
    for policy, context, guidance, seed in (('fp32', ctx, GUIDANCE, 30),
                                            ('w8a8', None, 0.0, 31)):
        evals = collections.Counter()

        def count_eval(module, args, kwargs):
            evals[(args + (None,) * 4)[2] is None] += 1

        hook = pipe.unet.register_forward_pre_hook(count_eval,
                                                   with_kwargs=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()            # the main path's run starts here
        t0 = time.perf_counter()
        try:
            img = pipe.generate(seed, batch=DDPM_BATCH, sampler='ddpm',
                                context=context, guidance=guidance,
                                policy=policy)
            torch.cuda.synchronize()
        finally:
            hook.remove()
        wall = time.perf_counter() - t0
        run = ops.launch_counts()       # ... and ends here
        launches.update(run)
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_eval = sum(evals.values())
        want = {'fused_gn_swish': 45 * n_eval,
                'w8a8_matmul': 0 if policy == 'fp32' else
                128 * evals[False] + 64 * evals[True],
                'flash_attention': 0}
        steps = pipe.sched.T
        print(f'[ddpm] {card}: SD v1.4 + VAE 512 DDPM {policy} guidance '
              f'{guidance} batch {DDPM_BATCH}, {steps} steps: wall '
              f'{wall:.3f} s, {wall / steps:.4f} s a step, UNet evaluations '
              f'(unconditional: count) {dict(evals)}, launches {run} '
              f'(expected {want}), peak memory {peak:.2f} GiB')
        check(n_eval == steps * (2 if guidance > 0 else 1),
              f'DDPM {policy}: {n_eval} UNet evaluations for {steps} steps')
        check(dict(run) == want, f'DDPM {policy}: launches {run}, '
              f'expected {want}')
        a = img.cpu().numpy()
        check(a.shape == (DDPM_BATCH, 512, 512, 3) and numpy.isfinite(a).all()
              and a.min() >= -1.0 and a.max() <= 1.0,
              f'DDPM {policy}: images {a.shape} not finite 512x512x3 in '
              '[-1, 1]')
    return launches


def ddpm_step_full(torch, ops, card, pipe, enc):
    """(d) One latent-diffusion gradient step at full SD v1.4 width:
    ``image_batch`` (4 x 512 x 512 x 3) -> ``vae_encode`` with a key ->
    latents (4, 64, 64, 4) -> ``ddpm_loss`` of the fp32 UNet over a
    random (4, 77, 768) context (45 GroupNorm+swish launches through
    ``GNSwish``, no W8A8 or flash launch) -> the gradient of every
    parameter of ``train_params`` -> one step ``p - DDPM_LR * g``.
    Checks: every gradient finite and non-zero (every parameter feeds the
    output under a context), and the step lowers ``ddpm_loss`` at the
    same key on the same batch."""
    from repro_torch.core import prng
    from repro_torch.data.pipeline import ImagePipelineConfig, image_batch
    from repro_torch.diffusion.schedule import ddpm_loss
    from repro_torch.launch.steps import train_params
    from repro_torch.models.autoencoder import vae_encode
    t0 = time.perf_counter()
    imgs = image_batch(ImagePipelineConfig(512, 3, DDPM_TRAIN_BATCH, seed=0),
                       0, device='cuda')
    with torch.no_grad():
        x0 = vae_encode(enc, imgs, prng.PRNGKey(7))
    torch.cuda.synchronize()
    check(tuple(x0.shape) == (DDPM_TRAIN_BATCH, 64, 64, 4)
          and bool(torch.isfinite(x0).all()),
          f'latents {tuple(x0.shape)} not finite (4, 64, 64, 4)')
    print(f'[ddpm-train] image_batch {tuple(imgs.shape)} -> vae_encode with '
          f'a key -> latents {tuple(x0.shape)} (std {x0.std().item():.4f}) '
          f'in {time.perf_counter() - t0:.3f} s')
    del imgs
    ctx = torch.randn((DDPM_TRAIN_BATCH, 77, pipe.unet_cfg.context_dim),
                      generator=torch.Generator().manual_seed(4)).cuda()
    unet = pipe.unet
    params = train_params(unet)
    key = prng.PRNGKey(8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                # the main path's run starts here
    t0 = time.perf_counter()
    loss = ddpm_loss(unet_apply, pipe.sched, unet, x0, key, ctx)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fwd = ops.launch_counts()
    grads = torch.autograd.grad(loss, list(params.values()))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with torch.no_grad():
        for p, g in zip(params.values(), grads):
            p.sub_(DDPM_LR * g)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.no_grad():
        after = ddpm_loss(unet_apply, pipe.sched, unet, x0, key, ctx).item()
    launches = ops.launch_counts()      # ... and ends here
    before = loss.item()
    sq = [float(g.square().sum()) for g in grads]
    bad = [n for n, g in zip(params, grads)
           if not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0]
    gn = [n for n in params if n.endswith(('gn1.scale', 'gn1.bias',
                                           'gn2.scale', 'gn2.bias'))
          or n.startswith('gn_out.')]
    n_params = sum(p.numel() for p in params.values())
    print(f'[ddpm-train] {card}: SD v1.4 ({n_params:,} parameters, '
          f'{len(params)} tensors) ddpm_loss at batch '
          f'{DDPM_TRAIN_BATCH} x 64 x 64 x 4, fp32 (TF32 off): forward '
          f'{t1 - t0:.3f} s, backward {t2 - t1:.3f} s, step {t3 - t2:.3f} s; '
          f'peak memory {peak:.2f} GiB; loss {before:.6f} -> {after:.6f} '
          f'after one step at lr {DDPM_LR} (first order: '
          f'{before - DDPM_LR * sum(sq):.6f}); grad norm '
          f'{math.sqrt(sum(sq)):.4f}; launches in the forward {fwd}, in '
          f'the run {launches}; {len(gn)} GroupNorm+swish parameters')
    check(not bad, f'gradients not finite or zero: {bad[:8]}')
    check(len(gn) == 2 * 44 + 2, f'{len(gn)} GroupNorm+swish parameters')
    check(fwd == {'fused_gn_swish': 45, 'w8a8_matmul': 0,
                  'flash_attention': 0}, f'loss forward launches {fwd}')
    check(launches['fused_gn_swish'] == 90 and launches['w8a8_matmul'] == 0
          and launches['flash_attention'] == 0,
          f'gradient step launches {launches}')
    check(after < before, f'the step did not lower ddpm_loss: {before} -> '
          f'{after}')
    for p in params.values():
        p.requires_grad_(False)
    del loss, grads, params, x0, ctx
    return launches


def main() -> int:
    import numpy
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    if not (ROOT / 'src' / 'repro_torch' / 'csrc').is_dir():
        print(f'chip_smoke: no src/repro_torch beside {__file__}',
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / 'src'))
    from repro_torch.configs.diffusion import SD_V1_4, VAE_512
    from repro_torch.configs.registry import get
    from repro_torch.diffusion.pipeline import DiffusionPipeline
    from repro_torch.kernels import build, ops

    t_start = last = time.perf_counter()

    def lap(phase: str) -> None:
        nonlocal last
        now = time.perf_counter()
        print(f'[time] phase {phase}: {now - last:.1f} s '
              f'({now - t_start:.1f} s in all)')
        last = now

    # phase 1: device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'[device] torch {torch.__version__} CUDA {torch.version.cuda}; '
          f'matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} '
          f'cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    card = smi.splitlines()[0]

    # phase 2: build
    t0 = time.perf_counter()
    libs = build.build(TPU_KERNELS)
    print(f'[build] {len(TPU_KERNELS)} kernels built in '
          f'{time.perf_counter() - t0:.2f} s')
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'[build] {name}: {line.strip()}')
    n_igmma = count_igmma(libs['w8a8_matmul'])
    print(f'[build] w8a8_matmul SASS: {n_igmma} int8 wgmma (IGMMA) '
          f'instructions ({find_cuobjdump()})')
    check(n_igmma > 0, 'the W8A8 library holds no int8 wgmma instruction')
    n_hgmma = count_hgmma_tf32(libs['flash_attention'])
    print(f'[build] flash_attention SASS: {n_hgmma} TF32 wgmma (HGMMA ... '
          'TF32) instructions')
    check(n_hgmma > 0, 'the flash library holds no TF32 wgmma instruction')
    lap('1-2 (device, build)')

    # the full-width model, shared by phases 3 and 5
    t0 = time.perf_counter()
    pipe = DiffusionPipeline.init(0, SD_V1_4, VAE_512, device='cuda')
    ctx_gen = torch.Generator().manual_seed(1)
    context = torch.randn((SLOTS, 77, SD_V1_4.context_dim),
                          generator=ctx_gen).cuda()
    print(f'[full] SD v1.4 UNet '
          f'{sum(p.numel() for p in pipe.unet.parameters()):,} parameters + '
          f'VAE decoder built from seed 0 in {time.perf_counter() - t0:.1f} s')

    # phase 3: kernels at the paths' shapes
    lm_cfg = get(LM_ARCH)
    summary, per_eval, checked = phase_kernels(torch, ops, pipe, context)
    check(per_eval['fused_gn_swish'] == 45 and per_eval['w8a8_matmul'] == 128,
          f'SD v1.4 launches per evaluation {per_eval}, expected 45 / 128')
    # InternLM2 and Granite against one cache row past the prompt,
    # Whisper and Qwen2-VL against serve_lm's prompt + new tokens
    summary['flash_attention'] = phase_flash(
        torch, lm_cfg.n_layers,
        [(lm_cfg, LM_PROMPT + 1), (get('granite-moe-1b-a400m'),
                                   LM_PROMPT + 1)]
        + [(get(a), LM_PROMPT + LM_TOKENS) for a in ENCDEC_VLM_PLAN])
    phase_w8a8_lm(torch, [lm_cfg] + [get(a) for a in FAMILY_PLAN]
                  + [get('qwen2-vl-7b')])
    lap('3 (kernels)')

    normal_ms = phase_prng(torch)
    lap('3b (prng)')

    # phase 4: small width, card vs CPU
    phase_small(torch, numpy)
    phase_small_features(torch, numpy)
    from repro_torch.launch.serve import setup_logging
    setup_logging('info')           # serve_diffusion's [tag] lines
    phase_serve_small(torch, numpy)
    lap('4 (small width)')

    # phase 5: full width through the engine
    launches = collections.Counter(
        phase_full(torch, numpy, ops, pipe, context, per_eval, card))
    print(f'[full] diffusion path launches: {dict(launches)}')
    lap('5 (full width)')
    feature_launches = phase_full_features(torch, numpy, ops, pipe, context,
                                           card, normal_ms)
    print(f'[features] serving-features run launches: '
          f'{dict(feature_launches)}')
    launches.update(feature_launches)
    del pipe, context
    torch.cuda.empty_cache()
    lap('5b (serving features)')

    # phase 6: LM small width, card vs CPU
    phase_lm_small(torch, numpy, ops)
    lap('6 (LM small width)')

    # phase 7: LM full width
    lm_launches = phase_lm_full(torch, numpy, ops, card)
    print(f'[lm-full] LM path launches: {dict(lm_launches)}')
    launches.update(lm_launches)
    lap('7 (LM full width)')

    # phase 8: the serving CLI's path at full width
    from repro_torch.launch import serve as tserve
    serve_pipe = tserve._diffusion_pipe('sd-v1.4', None, 'cuda')
    serve_launches = phase_serve(torch, numpy, ops, card, serve_pipe)
    print(f'[serve] serving CLI path launches: {dict(serve_launches)}')
    launches.update(serve_launches)
    lap('8 (serving CLI)')

    # phase 12: the slot-sharded engine on phase 8's pipeline
    mesh_launches = phase_mesh(torch, numpy, ops, card, serve_pipe, per_eval,
                               checked)
    print(f'[mesh] sharded serving path launches: {dict(mesh_launches)}')
    launches.update(mesh_launches)
    del serve_pipe
    torch.cuda.empty_cache()
    lap('12 (slot-sharded serving)')

    # phase 13: DDPM sampling and the latent-diffusion gradient step, on a
    # float pipeline of its own
    ddpm_launches = phase_ddpm(torch, numpy, ops, card, checked)
    print(f'[ddpm] DDPM path launches: {dict(ddpm_launches)}')
    launches.update(ddpm_launches)
    lap('13 (DDPM)')

    # phase 9: the MoE, MLA and SSM families at full width, every earlier
    # model freed
    family_launches = phase_lm_families(torch, numpy, ops, card,
                                        FAMILY_PLAN, 'lm-family')
    print(f'[lm-family] MoE / MLA / SSM path launches: '
          f'{dict(family_launches)}')
    launches.update(family_launches)
    lap('9 (LM families)')

    # phase 10: the encoder-decoder and the VLM at full width and depth,
    # every earlier model freed
    encdec_launches = phase_lm_families(torch, numpy, ops, card,
                                        ENCDEC_VLM_PLAN, 'encdec-vlm')
    print(f'[encdec-vlm] encoder-decoder / VLM path launches: '
          f'{dict(encdec_launches)}')
    launches.update(encdec_launches)
    lap('10 (encoder-decoder, VLM)')

    # phase 11: training, every earlier model freed; it launches no kernel
    single = phase_train(torch, ops, card)
    lap('11 (training)')

    # phase 14: sharded training on a DeviceMesh; no kernel either
    phase_mesh_train(torch, ops, card, single)
    lap('14 (sharded training)')

    kernels = []
    for name, (source, replaces) in TPU_KERNELS.items():
        s = summary[name]
        kernels.append({
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': launches[name],
            'max_abs_err': s['max_abs_err'], 'ms': s['ms'],
            'plain_ms': s['plain_ms'], 'bound_ms': s['bound_ms'],
            'bound_by': s['bound_by'], 'library_ms': s['library_ms'],
            **{k: s[k] for k in ('passes', 'bound_f32_ms') if k in s}})
    check(all(math.isfinite(k['ms']) for k in kernels), 'bad kernel times')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
