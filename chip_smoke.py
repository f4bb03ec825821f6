#!/usr/bin/env python3
"""Drive the PyTorch port's main paths (vision serving and training, the
four-direction launch ladder, LM serving and LM training on the GSPN-2
mixer, data-parallel on 2 ranks, on attention, on the SSM and xLSTM
mixers, on the mixture of experts, on M-RoPE with vision embeddings and
on whisper's encoder and cross-attention) on one CUDA card and hold
every CUDA kernel against its plain PyTorch version.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which fails the run on any error:

1. the toolchain and the card: torch, CUDA, nvcc, the card's name and
   power limit; no card means exit 1 before anything else;
2. the build of every CUDA kernel from the checkout's sources;
3. kernels: each kernel (the forward scans #1 and #3 and their adjoints
   #2 and #4) against its plain version on the card, at the main path's
   shapes (batch 64 of GSPN-2-T at 224²: G = 128 planes, G_w = 64,
   H = W = 56/28/14/7), the 1024² stage-1 shape (G = 32, H = W = 256), a
   ragged shape (H = 19, W = 37, cpw 1 and 4) and a chunked one, and the
   single scan and its adjoint also at the ``qwen2-1.5b-gspn`` mixer's
   two passes at ``train_4k`` (G = 128, cpw 8: H = 4 rows of W = 1024,
   and H = 1024 rows of W = 4), at the LM train phase's (G = 16) and at
   H = 32, W = 1024 with chunk 8, in
   float32 and bfloat16 streams (tolerance 1e-5 of the largest magnitude,
   1e-2 for the forward's bfloat16 output); at all but the ragged and
   small chunked shapes, the device time per launch of the kernel and of
   the plain version (CUDA-graph replays timed by CUDA events, median of
   20, the plain version's of 5) and of one eager call, and at the main-path shapes the kernel's
   time with the L2 flushed before each launch (``cold_ms``, as the main
   path finds its operands in device memory).  #1, #3 and #5 are the D =
   1, 2 and 4 instances of one forward template (a warp per plane,
   neighbours by shuffle, a ``cp.async`` ring in shared memory, taps
   staged once per weight group), #2 and #4 the D = 1 and 2 instances of
   its adjoint template (#2 spreading a row of more than 128 columns over
   warps: on a plane of up to 16 rows, windows of 64 or 128 columns read
   from device memory four rows ahead; on a taller one, eight bands that
   share the row from the ring).  Then the single-launch quad kernel (#5) against its
   plain version at the main-path shapes (N = 56/28/14/7), at 1024² (G =
   32, N = 256, its transposed directions streaming column slabs of x
   through the ring) and on a ragged square (N = 19, cpw 1 and 4),
   float32 and bfloat16, timed through its wrapper, which reads x in
   place (no stacked copy), warm and with a cold L2;
4. the single-direction gradient: the gradients of one "rl"
   ``directional_scan`` at 28², G = 128, through kernels #1 and #2 under
   autograd, counted (one launch each, no plain call) and held against
   the plain path (1e-5 of the largest magnitude);
5. model (serving): GSPN-2-T classification forward at 224², batch 64, weights from
   a seeded generator, images from ``synth_images``; the kernel path
   against the plain path on the card (TF32 off for convolutions and
   matrix products, 1e-4 of the largest logit), one counted forward that
   must launch the pair kernel 52 times and never call a plain scan, the
   forward's images/s over 10 timed runs, a profile of one forward
   (device time by kernel, idle share, the forward as one CUDA graph);
   and the reduced model on the card against the plain path on the CPU;
6. training: one GSPN-2-T training step at 224², batch 64, f32: a counted
   ``vision_loss`` + ``backward()`` that must launch the pair kernel and
   its adjoint 52 times each and never call a plain scan, its gradients
   against the plain path on the card (loss 1e-5 relative, each
   parameter's gradient 1e-4 of its largest magnitude), 5 timed runs of
   the loss and gradients alone, 5 timed AdamW steps (step ms, images/s,
   peak memory) and a profile of one step;
7. the trainer twin ``examples/train_vision_torch.py``, 60 steps on the
   reduced model, whose held-out accuracy must end above 2/n_classes;
8. the four-direction launch ladder (the paper's §4.3 design point) at
   GSPN-2-T's stage shapes, batch 64 (G = 128, cpw 2, N = 56/28/14/7,
   float32): the GSPN-1 per-step emulation, one scan per direction (#1
   four times), the pair dispatch (#3 twice) and the quad (#5 once), each
   through the port's public functions and held equal to the pair rung
   (1e-5 of the largest magnitude); its launches asserted from the
   counters and again from the ``kernel.launch`` spans; its device time as
   a CUDA graph and as an eager call (per_step eager only); a Chrome trace
   of one traced pass of every rung written to ``build/ladder_trace.json``;
9. LM serving: ``qwen2-1.5b-gspn`` at full width (28 layers, d_model 1536,
   d_ff 8960, vocab 151 936, C_proxy 8, row width 1024) with weights from
   a seeded generator on the card: its parameter count; under the f32
   policy, one 2048-token prefill through kernel #1 against the plain
   path (``impl="torch"``), a chunk chain of 2 × 1024 tokens against the
   one-shot prefill, and two decode steps against ``apply_lm`` at the same
   positions (logits within 1e-4 of their largest magnitude), each pass
   counted (56 launches of #1 per prefill or chunk, none per decode step,
   no plain scan); then a ``ServeEngine`` with 4 slots, prefill chunks of
   1024, greedy, under the config's own policy, over 6 requests of 4096,
   2048, 1536, 1024, 100 and 16 prompt tokens and 16 new tokens each:
   per-request TTFT and tokens, tok/s, the median decode step and chunk
   (``serve.*`` spans), the card's idle share over one decode step and
   one chunk (profiler), peak memory, and #1's launches by shape from the
   counters (56 per prefill or chunk, none per decode step), which the
   ``kernels`` line reports at the kernel phase's serving shapes (#1 at
   G = 8, cpw 8: 1 and 2 rows of 1024, 1024 rows of 1 and 2);
10. LM training (``lm train ...`` lines), ``qwen2-1.5b-gspn`` at full
   width with seeded weights and ``synth_tokens`` batches: (a) under the
   f32 policy without rematerialisation, ``lm_loss`` and every
   parameter's gradient at 1 × 2048 tokens through #1 and #2 against the
   plain path (loss 1e-5 relative, each gradient 1e-4 of its largest
   magnitude; 56 launches of each, no plain scan); (b) under the config's
   own policy and ``remat="unit"``, ``build_train_step`` with AdamW at
   2 × 4096 tokens: one counted step (112 launches of #1 and 56 of #2, by
   shape: G = 16, cpw 8, 4 rows of 1024 and 1024 rows of 4, which the
   ``kernels`` line reports at the kernel phase's training shapes), the
   median of 5 timed steps and tokens/s, loss and gradients alone, peak
   memory and a profiled step; (c) two steps of the ``bf16`` preset with
   the f32 master copy and loss scaling (finite gradients, the working
   copy equal to the master rounded, the kernels' bf16 instances); (d)
   the trainer twin ``examples/train_lm_torch.py --preset small`` for 60
   steps, whose loss must fall, then a restart that resumes from its
   checkpoint under ``build/``;
11. the attn block kind (``lm attn ...`` lines), ``qwen2-1.5b`` at full
   width and 7 of its 28 layers (d_model 1536, 12 heads over 2, vocab
   151 936, tied, qkv bias) with seeded weights, no scan launched anywhere: (a) under
   the f32 policy, a 2048-token prompt as two chunks of 1024 against the
   one-shot prefill (logits 1e-4, KV caches 1e-4) and 2 decode steps
   against ``apply_lm`` with its attention dense (1e-4; blockwise, 2050
   tokens would halve the key block to 2), and ``chunked_attention`` at
   1 x 4096,
   forward and gradients, against the exact (f64) attention (1e-5) and
   against ``full_attention`` (2e-5: on the card the dense path's own
   f32 dv sits 8.9e-6 from the exact one, the blockwise path's 3.9e-6);
   (b) the
   engine under the config's own policy over the serving phase's
   requests (4 slots, chunks of 1024, max_len 4112): TTFT per request,
   tok/s, the median decode step and chunk, their idle shares and
   attention's share of their device time, the KV pool's bytes, peak
   memory; (c) training at 2 x 4096 under ``remat="unit"`` with AdamW:
   the median of 5 steps, tokens/s, loss and gradients alone, peak
   memory, a profiled step and attention's share of its device time
   (the kernels under the ``attention.*`` spans of that profile); (d) ``granite-3-2b`` ``full()`` under the f32 policy: a
   prefill of 1024 and 4 decode steps against ``apply_lm`` (1e-4);
11b. data parallelism (``lm dp ...`` lines, phase ``lm dp``, after LM
   training): ``qwen2-1.5b-gspn`` ``full()`` under the f32 policy and
   ``remat="unit"``, seeded weights, on 2 ranks in processes of their own
   that share the card over gloo (FSDP2 over the ``data`` axis by the
   reference's sharding rules; every collective counted, its bytes
   through host memory and its host time), a global batch of 2 x 4096
   (1 x 4096 a rank): this process first runs the one-rank side (the
   seeded model's leaf sums, a counted loss and gradients at 1 x 4096,
   one AdamW step at 2 x 4096 with a seeded sample of 64 elements of
   every leaf and their gradients, the whole batch's and the mean of its
   halves'); then in the ranks (a) every parameter, moment and int8
   residual at the local shape its spec gives, and the shards' leaf sums
   against the one-rank model's; bytes a rank against one rank; (b) the
   first step counted: #1 and #2 by shape as the one-rank 1 x 4096
   pass, no plain scan; (c) that step against the one-rank step: loss
   1e-5 relative, ``grad_norm`` 1e-6, every sampled element 1e-5 of its
   leaf's largest, except where its gradient is under 1e-5 of its leaf's
   largest or the element is within four times the distance AdamW's
   first step puts between the whole batch's gradient and its halves'
   mean on the one rank (the noise control, counted); that step's ms,
   its share in the counted collectives, the bytes through host memory
   and peak memory a rank; (e) ``pipeline_apply`` over the 2 ranks, one
   full-width GSPN block a stage, 4 microbatches of 1 x 1024,
   against the blocks in sequence (1e-5), #1 launched on both; (d) the
   first ``grad_compression="int8_ef"`` step from the seed on the same
   mesh (each global leaf's scale from an all-reduce MAX), counted as
   (b), against the one-rank int8_ef step at 2 x 4096: loss and
   ``grad_norm`` 1e-5, a sampled residual off by more than 1e-5 of its
   leaf's largest quantised magnitude only by one int8 step or within
   four times (c)'s noise control (the residuals start at zero, so a
   residual's distance is its gradient's), a sampled parameter off by
   more than 1e-5 of its leaf's largest only at a step;
   then that FSDP-placed state (parameters, moments, residuals) of the
   first 2 of the 28 blocks and every leaf outside the blocks saved by
   both ranks with ``CheckpointManager``, zeroed and restored, every
   tensor bit for bit.  The launcher's ``--distributed``, which now
   builds a model axis, runs in the ``lm tp`` phase;
   then tensor parallelism (``lm tp ...`` lines, phase ``lm tp``):
   ``qwen2-1.5b-gspn`` ``full()`` on (data 1, model 2), 2 gloo ranks
   sharing the card, f32 policy, remat unit, seed 5: the one-rank side in
   this process first, then in the ranks (a) parameters and moments at
   the local shape the model axis gives, leaves split over ``model``,
   leaf sums against the one rank's, bytes a rank; (b) the first step at
   1 x 4096 counted, #1 and #2 by shape as the one rank's, no plain scan;
   (c) that step against the one rank's with (c)'s bounds of ``lm dp``,
   the noise control measured the same way: four times the distance
   AdamW's first step puts between the one rank's gradient and that
   gradient in another reduction order (d_ff and the vocabulary, the
   sums the model axis splits, in a seeded permutation); and every
   block's output after its all-reduce bit-equal on both ranks; (d)
   ``grok-1-314b`` cut to one
   ``attn_moe`` layer in f32 at M = 2 (ep 2, tp 1) against one rank at M
   = 1: loss, aux 1e-5, sampled gradients 1e-4 of their leaf's largest,
   at 1 x 256 tokens; (f) the recurrent kinds, ``zamba2-2.7b`` and
   ``xlstm-1.3b`` at full width and 1 unit each, f32, remat unit, on
   (data 1, model 2), every mixer on its own heads: placements as (a),
   the first step (zamba2 at 1 x 4096, xlstm at 1 x 1024) against the
   one rank's with (c)'s bounds and noise control, and ``lm_prefill`` of
   1 x 1024 with 8 greedy ``lm_decode_step``s against one rank: last
   logits within 1e-4 of the largest or four times the one rank's own
   noise (batch 2 against 1), equal tokens, every cache leaf that the
   axis keeps whole bit-equal on both ranks after each call, and the
   collective bytes a rank of the step, the prefill and a decode step;
   (g) the VL and encoder-decoder families the same way, f32, remat
   unit, on (data 1, model 2): ``whisper-base`` whole (its encoder, self-
   and cross-attention split by heads, its vocabulary of 51 865 whole on
   every rank), the step at 4 clips of 1500 frames and 448 tokens, then
   ``lm_encode`` (its ``enc_kv`` bit-equal on both ranks and counted), a
   prefill of 4 tokens a clip and 8 greedy decode steps; ``qwen2-vl-72b``
   at full width and 1 of its 80 layers (3.37 B parameters: the one rank
   runs its step alone before the ranks start), the step at 1 x 2048
   with 1024 vision embeddings, then a prefill of that prompt and 8
   greedy decode steps; the noise control's permutation takes every
   attention layer's heads too (the cross-attention's and
   ``enc_kv_proj``'s kv heads in one order);
   (e) ``launch/train.py --distributed
   --grad-compression int8_ef`` on 2 ranks under the config's own
   policy, which picks (data 1, model 2): 2 steps and a model-sharded
   checkpoint, then a launch of 1 step that resumes from it without
   compression (two checkpoints of the int8 state, 22.3 GB each, do not
   fit beside the rest of the smoke's 45 GiB); losses finite and
   falling, no plain scan;
12. the serving tier (``lm tier ...`` lines): the prefix cache cold and
   warm on both LMs, threaded replicas under each router policy and a
   replica's failure (``qwen2-1.5b-gspn`` at 7 of its 28 layers), and
   the tuner's seed cache;
13. sequence parallelism of the scan (``sp ...`` lines,
   ``parallel/gspn_sp.py``): (a) one rank over NCCL in this process,
   where ``gspn_scan_sp`` and ``gspn_scan_sp_pair`` at G = 128, N = 56,
   cpw 2 equal the kernel call bit for bit on #1 and #3; (b) 2 and then 4
   ranks in processes of their own that share the card over gloo (the
   exchange staged through host memory): all four directions at N = 56
   and 7 under each strategy, the fused pair under each exchange mode
   and the LM's two passes (16 x 4 x 1024, 16 x 1024 x 4), float32 and
   bfloat16, forward and gradients against the unsharded kernel call
   (1e-5 of the largest magnitude, 1e-2 in bfloat16), the exchange
   collectives of each counted, #1 to #4 launched under
   ``sp_block_local`` and no plain scan; the host-clock µs of the
   sharded and unsharded forward and of the block-local operators alone;
   (c) 2 ranks at full width: GSPN-2-T at batch 64 (logits 1e-4, loss
   1e-5 relative, gradients 1e-4, then an AdamW step), the first
   prefill of 4096 tokens of ``qwen2-1.5b-gspn`` (under the f32 policy
   logits 1e-4 of the largest with the policy's f32 wire and 1e-2
   relative L2 with a bf16 wire; under the config's own policy both
   measured beside a control, the unsharded plain scans against the
   unsharded kernels), and the serve launcher with ``--seq-parallel 2``
   under the f32 policy, whose tokens and #1 launches must equal the
   unsharded launcher's.

14. the SSM and xLSTM families (``ssm ...`` lines, phase ``lm ssm``; no
   kernel of the port and no scan runs on them, so #1–#5 launch 0 times):
   (a) ``chunked_gla`` against a loop of ``gla_decode_step`` over the
   same tokens at zamba2's heads (80 of 64 x 64, Mamba-2 decays) and
   xlstm's (4 of 1024 x 1025, mLSTM decays), 1024 and 1023 tokens (the
   latter as 1023 chunks of one), f32, 1e-4 of the largest magnitude;
   the causal conv streamed against its full pass, bit for bit; then for
   ``zamba2-2.7b`` and ``xlstm-1.3b`` at full width and a fraction of their
   depth (1 of zamba2's 9 units, 1 of xlstm's 6) with seeded weights: (b)
   under the f32 policy a prefill of 2048 and 16 decode steps against
   ``apply_lm`` over the 2064 tokens, at 1e-4 of
   the largest logit or four times the model's own f32 rounding noise
   measured in the run (``apply_lm`` over two copies of the tokens
   against one), whichever is larger; (c) the engine under the config's
   own policy over the serving phase's requests plus one of 1023 tokens
   (4 slots, greedy, ``max_len`` 4112, asked for chunks of 1024 and
   prefilling in one shot): per-request TTFT, tok/s, TTFT p50 / p90, the
   median decode step, the idle share of a decode step and of a
   1024-token prefill, the 1023-token prefill beside the 1024-token one,
   the state bytes a slot, peak memory; (d) training under
   ``remat="unit"`` with AdamW (zamba2 at 2 x 4096, xlstm at 2 x 1024):
   the median of 3 steps after one warm-up, tokens/s, peak memory, the
   loss finite and every gradient finite and nonzero (the shared attn
   block's too), a profiled step (xlstm's at 2 x 256).
15. the MoE family (``moe ...`` lines, phase ``lm moe``; no kernel of the
   port and no scan runs on it): ``kimi-k2-1t-a32b`` and ``grok-1-314b``
   at full width with the depth cut to what one card holds (kimi's dense
   layer and 1 of its 60 attn_moe layers under ``bf16``, grok 2 of its 64
   layers in f32), seeded weights: (a) the MoE layer alone at 1 x 1024
   and 1 x 4 tokens against ``moe_per_expert``, a loop over the experts
   (1e-5 of the largest magnitude in f32, 1e-2 under bf16), with the
   share of dropped pairs (> 0 in a kimi case); (b) ``lm_prefill`` of
   2048 tokens against ``apply_lm`` at the config's capacity factor, the
   drop shares of a 1024-token chunk, that prefill and a 4-slot decode
   step, then on a twin at capacity factor E/k (cap >= t, nothing drops)
   the chunk chain of 2 x 1024 against the one-shot prefill and 16 decode
   steps against ``apply_lm`` over 2064 tokens, at 1e-4 of the largest
   logit in f32 or 1e-2 relative L2 under bf16, or four times the model's
   own rounding noise measured in the run where that is larger; (c) the
   engine over the serving phase's requests (4 slots, chunks of 1024,
   ``max_len`` 4112, greedy; grok under its own policy over the same
   weights): TTFT, tok/s, the median decode step and chunk, their device
   time, idle share and top kernels, KV bytes a slot, peak memory; (d)
   grok at 1 layer under ``bf16`` (``remat="unit"``, 1 x 4096): the
   median of 3 ``lm_loss`` and gradients after a warm-up, tokens/s, peak
   memory, the loss and aux finite, aux > 0, every gradient finite and
   nonzero (the router's and each expert's rows of every slab), a
   profiled call; then two AdamW steps through ``launch/train.py
   --reduced`` on the card (a whole step at full width does not fit).
16. the VL family (``vl ...`` lines, phase ``lm vl``; no kernel of the
   port and no scan runs on it): (a) ``apply_mrope`` at qwen2-vl's head
   shape, (1, 2048, 64, 128), sections 16/24/24, three distinct planes
   (a patch grid, then text) against an f64 evaluation of the f32
   angles, 1e-5 of the largest magnitude, and three equal planes bit for
   bit ``apply_rope``; then ``qwen2-vl-72b`` at full width and 1 of its
   80 layers with seeded weights: (b) under the f32 policy
   ``lm_prefill`` of 2048 tokens, the first 1024 vision embeddings,
   against ``apply_lm``, 4 decode steps against ``apply_lm`` over 2052
   tokens, the text chain of 2 x 1024 chunks against the one-shot
   prefill, at 1e-4 of the largest logit or four times the noise control
   (``apply_lm`` over two copies against one), and ``apply_lm`` at
   (3, B, S) ids of three equal planes bit for bit the (B, S) call; (c)
   under its own policy (f32 weights, bf16 products) the engine over the
   serving phase's requests (4 slots, chunks of 1024, ``max_len`` 4112),
   then one image request (2048 prompt positions, 1024 of them vision
   embeddings, 16 greedy tokens): TTFT, tok/s, decode step and chunk ms,
   device time, idle share; (d) ``lm_loss`` and gradients at 1 x 4096
   with 2048 vision positions, ``remat="unit"``: the median of 2 after a
   warm-up, tokens/s, peak memory, every gradient finite and nonzero;
   then two AdamW steps through ``launch/train.py --reduced``.
17. the encoder-decoder family (``audio ...`` lines, phase ``lm audio``;
   no kernel of the port and no scan runs on it): (a) the encoder's
   non-causal self-attention at 1 x 1500 frames (375 key blocks of 4)
   against the dense non-causal path, forward and gradients, 1e-5 of the
   largest magnitude; then ``whisper-base`` whole with seeded weights:
   (b) under the f32 policy, 4 clips with prompts of 4, 16, 40 and 64
   tokens, ``lm_encode`` and ``lm_prefill(enc_kv=)`` against
   ``apply_lm(enc_frames=)`` and 8 decode steps against ``apply_lm``,
   ``max_len`` 448, at 1e-4 of the largest logit or four times the noise
   control; (c) under its own policy 4 clips batched, a prompt of 4
   tokens and 8 greedy tokens each: the encoder's, the prefill's and a
   decode step's ms, tok/s, the idle share and the share of a decode
   step's device time under the ``lm.cross_attention`` spans, and the
   engine's refusal of the model; (d) two AdamW steps of the whole model
   through ``launch/train.py`` at 4 x 448 tokens and 1500 frames: step
   seconds, every moment finite, the encoder's nonzero, and
   ``xattn.wk`` and ``xattn.wv``'s exactly 0 (their gradients were).
18. the roofline (``roofline ...`` lines, phase ``roofline``): (a)
   sharded serving at full width under the f32 policy, gloo ranks
   sharing the card (:func:`roofline_worker`): ``qwen2-1.5b-gspn`` on
   (data 1, model 2), ``lm_prefill`` of 1 x 4096 then 16 greedy decode
   steps, and ``qwen2-1.5b`` on (1, 4), 1 x 1024 then 16 (its 2 kv heads
   do not divide 4: the cache splits its positions), each step's last
   logits within 1e-4 of the largest of the one-rank run on the same
   weights, the greedy tokens equal, each rank's cache shapes those of
   ``cache_shardings``, #1 56 a rank a GSPN prefill and 0 a decode step,
   no plain call; (b) three programs measured on the card (the ``lm
   train`` step, the GSPN-2-T step, (a)'s GSPN prefill on rank 0)
   against their counts on ``meta`` (``roofline.cost``, in a process of
   their own, :func:`roofline_meta`): FLOPs equal to ``FlopCounterMode``'s
   on the card, the compute, memory and collective terms and their bound
   at most the measured median, the estimated peak within 0.7-1.3 of
   ``max_memory_allocated``; (c) the dry run of three production cells on
   the single mesh (``launch.dryrun`` in subprocesses beside the card's
   work), each ``ok``, with its terms.

It prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import math
import os
import pathlib
import re
import socket
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and f32 outside the
# tensor cores, at the 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
MAIN_WIDTHS = (56, 28, 14, 7)
# The plain versions' timings in the kernel phase take the median of this
# many calls (the kernels' of 20): the smoke's time limit.
PLAIN_REPS = 5
BATCH = 64
REPLACES = {
    "gspn_quad_fwd": "src/repro/kernels/gspn_multidir.py:422",
    "gspn_pair_fwd": "src/repro/kernels/gspn_multidir.py:165",
    "gspn_scan_fwd": "src/repro/kernels/gspn_scan.py:224",
    "gspn_pair_bwd": "src/repro/kernels/gspn_multidir.py:336",
    "gspn_scan_bwd": "src/repro/kernels/gspn_scan.py:384",
}
# Every kernel is an instance of a template in one source.
SOURCES = dict.fromkeys(REPLACES, "src/repro_torch/kernels/csrc/gspn_pair.cu")
# Kernels timed with a cold L2 at the main-path shapes: all of them.
COLD = tuple(REPLACES)
# Names of the scan kernels in the profiler's device records.
SCAN_KERNELS = ("gspn_fwd_kernel", "gspn_bwd_kernel")
# The templates' direction count D of each kernel.
NDIR = {"gspn_scan_fwd": 1, "gspn_pair_fwd": 2, "gspn_quad_fwd": 4,
        "gspn_scan_bwd": 1, "gspn_pair_bwd": 2}
# The single scan's and its adjoint's further shapes (G, H, W, cpw,
# chunk): the qwen2-1.5b-gspn mixer's T→B pass and within-row pass at
# train_4k (batch 16, C_proxy 8), and a chunked wide shape.
LM_SHAPES = ((128, 4, 1024, 8, None), (128, 1024, 4, 8, None),
             (128, 32, 1024, 8, 8))
# The single scan's shapes on the LM serving path (one request, C_proxy 8):
# the T→B pass of a one-shot prefill of up to 1024 tokens and of a seeded
# chunk of 1024 (1 and 2 rows of 1024), the within-row pass of both (1024
# rows of 1), and of a one-shot prefill of 2048 (1024 rows of 2).
SERVE_SHAPES = ((8, 1, 1024, 8, None), (8, 2, 1024, 8, None),
                (8, 1024, 1, 8, None), (8, 1024, 2, 8, None))
# The serving phase: the engine's requests (prompt tokens) and new tokens.
SERVE_PROMPTS = (4096, 2048, 1536, 1024, 100, 16)
SERVE_NEW = 16
SERVE_CHUNK = 1024
# The f32 checks' prompt: two chunks.
CHECK_LEN = 2048
# The LM training phase: batch x tokens of the timed steps (one chip's
# share of train_4k), the shapes of #1 and #2 there (G = 2 sequences x
# C_proxy 8, cpw 8: the T→B pass, 4 rows of 1024, and the within-row pass,
# 1024 rows of 4), the timed steps, and the trainer twin's steps.
TRAIN_BATCH, TRAIN_SEQ = 2, 4096
TRAIN_SHAPES = ((16, 4, 1024, 8, None), (16, 1024, 4, 8, None))
TRAIN_STEPS = 5
TWIN_STEPS = 60
# The serving tier: 6 prompts of a shared 3072-token prefix (three chunks)
# and suffixes of these lengths; the entries of each LM's prefix cache.
TIER_PREFIX = 3072
TIER_SUFFIXES = (1024, 256, 512, 768, 384, 640)
TIER_CAPACITY = {"gspn": 8, "attn": 4}
TIER_LAYERS = 7
# The two shapes at which every candidate launch shape is held against the
# plain version: #3 at N = 56 and #1's within-row pass of a chunk.
TIER_CHECKED = (("pair_fwd", 128, 56, 56, 2, "one_shot"),
                ("fwd", 8, 1024, 1, 8, "chunk_resume"))


def _run(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def _median_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median over ``n`` calls of CUDA-event time around one call of
    ``fn``: device time plus whatever host time the call leaves the card
    idle for."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _captured(fn, per_graph: int) -> torch.cuda.CUDAGraph:
    """``per_graph`` calls of ``fn`` captured in a CUDA graph, after three
    warm-up calls on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return graph


def _graph_ms(fn, per_graph: int, n: int = 20) -> float:
    """Device time of one call of ``fn``: ``per_graph`` calls captured in a
    CUDA graph, the median of ``n`` timed replays divided by
    ``per_graph``.  Replays leave out the host's launch overhead."""
    graph = _captured(fn, per_graph)
    ms = _median_ms(graph.replay, n=n) / per_graph
    del graph
    return ms


def _cold_ms(fn, n: int = 20) -> float:
    """Device time of one call of ``fn`` with the L2 cache flushed first:
    ``fn`` captured once in a CUDA graph; before each of ``n`` timed
    replays a 256 MiB buffer is written (more than the 50 MB L2) and the
    card spins for about half a millisecond, outside the timed window, so
    the host has queued the replay before it starts.  Median of ``n``."""
    graph = _captured(fn, 1)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    times = []
    for _ in range(n):
        flush.fill_(1)
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph, flush
    return statistics.median(times)


def _scan_inputs(gen, g, h, w, cpw, dtype, pair, kind="fwd", ndir=None):
    """(x, wl, wc, wr, lam) for a forward scan, (dy, wl, wc, wr) for an
    adjoint; ``ndir`` 4 gives the quad's operands."""
    lead = (ndir,) if ndir else (2,) if pair else ()
    dev = "cuda"
    x = torch.randn((g, h, w), generator=gen, device=dev)
    taps = torch.softmax(torch.randn(lead + (g // cpw, h, w, 3),
                                     generator=gen, device=dev), dim=-1)
    lam = torch.rand(lead + (g, h, w), generator=gen, device=dev)
    if kind == "bwd":
        dy = torch.randn(lead + (g, h, w), generator=gen, device=dev)
        return tuple(t.to(dtype).contiguous()
                     for t in (dy, taps[..., 0], taps[..., 1], taps[..., 2]))
    return tuple(t.to(dtype).contiguous()
                 for t in (x, taps[..., 0], taps[..., 1], taps[..., 2], lam))


def kernel_phase(gen):
    from repro_torch.kernels import gspn_multidir, gspn_scan

    kernels = {
        "gspn_scan_fwd": (gspn_scan.gspn_scan_fwd,
                          gspn_scan.gspn_scan_fwd_torch, False, "fwd"),
        "gspn_pair_fwd": (gspn_multidir.gspn_scan_bidir,
                          gspn_multidir.gspn_scan_bidir_torch, True, "fwd"),
        "gspn_scan_bwd": (gspn_scan.gspn_scan_bwd,
                          gspn_scan.gspn_scan_bwd_torch, False, "bwd"),
        "gspn_pair_bwd": (gspn_multidir.gspn_scan_bidir_bwd,
                          gspn_multidir.gspn_scan_bidir_bwd_torch, True,
                          "bwd"),
    }
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [(2 * BATCH, w, w, 2, None, dtype, True) for w in MAIN_WIDTHS]
        cases += [(32, 256, 256, 2, None, dtype, True),
                  (8, 19, 37, 1, None, dtype, False),
                  (8, 19, 37, 4, None, dtype, False),
                  (8, 38, 37, 4, 19, dtype, False)]
        cases += [shape + (dtype, True) for shape in LM_SHAPES]
        cases += [shape + (dtype, True) for shape in SERVE_SHAPES]
        cases += [shape + (dtype, True) for shape in TRAIN_SHAPES]
    # The adjoints write f32 computed in f32 from the same inputs as their
    # plain versions, in either stream dtype.
    tol = {("fwd", torch.float32): 1e-5, ("fwd", torch.bfloat16): 1e-2,
           ("bwd", torch.float32): 1e-5, ("bwd", torch.bfloat16): 1e-5}
    results = []
    for name, (kernel, plain, pair, kind) in kernels.items():
        for g, h, w, cpw, chunk, dtype, timed in cases:
            if pair and (g, h, w, cpw, chunk) in LM_SHAPES + TRAIN_SHAPES:
                continue
            if name != "gspn_scan_fwd" and \
                    (g, h, w, cpw, chunk) in SERVE_SHAPES:
                continue
            args = _scan_inputs(gen, g, h, w, cpw, dtype, pair, kind)
            got = kernel(*args, chunk=chunk)
            want = plain(*args, chunk=chunk)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            dname = str(dtype).removeprefix("torch.")
            row = dict(kernel=name, g=g, h=h, w=w, cpw=cpw, chunk=chunk,
                       dtype=dname, max_abs_err=err, max_abs=scale,
                       tol=tol[kind, dtype] * scale,
                       launch_shape=_launch_shape(g, h, w, cpw, dtype, kind,
                                                  NDIR[name]))
            if timed:
                row.update(
                    ms=_graph_ms(lambda: kernel(*args, chunk=chunk), 10),
                    plain_ms=_graph_ms(lambda: plain(*args, chunk=chunk), 2,
                                       n=PLAIN_REPS),
                    call_ms=_median_ms(lambda: kernel(*args, chunk=chunk)),
                    plain_call_ms=_median_ms(
                        lambda: plain(*args, chunk=chunk), n=PLAIN_REPS,
                        warmup=1),
                    **_bound(kind, NDIR[name], g, h, w, cpw, dtype))
                if name in COLD and h in MAIN_WIDTHS:
                    row["cold_ms"] = _cold_ms(
                        lambda: kernel(*args, chunk=chunk))
            print("kernel " + " ".join(f"{k}={v}" for k, v in row.items()),
                  flush=True)
            if not err <= row["tol"]:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version: {row}")
            results.append(row)
    return results + _quad_rows(gen)


def _launch_shape(g, h, w, cpw, dtype, kind, ndir):
    """The launch shape the kernel's wrapper launches (``gspn_scan.plan``:
    the tuning cache's entry for this card, else ``pair_launch_shape``),
    as printed in a kernel row."""
    from repro_torch.kernels import gspn_scan

    s = gspn_scan.plan(kind, ndir, g, h, w, cpw, dtype, "cuda")
    return (f"planes={s.planes},warps={s.warps},K={s.k},splits={s.splits},"
            f"S={s.stages},batch={s.batch},"
            f"grid={'x'.join(map(str, s.grid))},xpitch={s.xpitch},"
            f"bands={s.bands},direct={int(s.direct)},smem={s.smem_bytes}")


def _bound(kind, ndir, g, h, w, cpw, dtype):
    """The least time of one launch: its bytes (each input read once, each
    output written once) and its operations, both from the package's one
    count of a launch (``gspn_scan.launch_cost``, which the roofline's
    kernel records read too), over the card's rates."""
    from repro_torch.kernels.gspn_scan import launch_cost

    nbytes, ops = launch_cost(kind, ndir, g, h, w, cpw, dtype)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return dict(bytes=nbytes, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _quad_rows(gen):
    """Kernel #5 against its plain version.  ``ms`` and ``cold_ms`` are
    the public wrapper, which reads x in place, against the bound of the
    function it computes (x read once, taps and lam read, out written)."""
    from repro_torch.kernels import gspn_multidir as mk

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [(2 * BATCH, n, 2, dtype, True) for n in MAIN_WIDTHS]
        cases += [(32, 256, 2, dtype, True), (8, 19, 1, dtype, False),
                  (8, 19, 4, dtype, False)]
    rows = []
    for g, n, cpw, dtype, timed in cases:
        args = _scan_inputs(gen, g, n, n, cpw, dtype, False, ndir=4)
        got = mk.gspn_scan_quad(*args)
        want = mk.gspn_scan_quad_torch(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        row = dict(kernel=mk.KERNEL_QUAD, g=g, h=n, w=n, cpw=cpw, chunk=None,
                   dtype=str(dtype).removeprefix("torch."), max_abs_err=err,
                   max_abs=scale, tol=tol * scale,
                   launch_shape=_launch_shape(g, n, n, cpw, dtype, "fwd", 4))
        if timed:
            row.update(
                ms=_graph_ms(lambda: mk.gspn_scan_quad(*args), 10),
                plain_ms=_graph_ms(lambda: mk.gspn_scan_quad_torch(*args), 2,
                                   n=PLAIN_REPS),
                call_ms=_median_ms(lambda: mk.gspn_scan_quad(*args)),
                plain_call_ms=_median_ms(
                    lambda: mk.gspn_scan_quad_torch(*args), n=PLAIN_REPS,
                    warmup=1),
                **_bound("fwd", 4, g, n, n, cpw, dtype))
            if n in MAIN_WIDTHS:
                row["cold_ms"] = _cold_ms(lambda: mk.gspn_scan_quad(*args))
        print("kernel " + " ".join(f"{k}={v}" for k, v in row.items()),
              flush=True)
        if not err <= row["tol"]:
            raise AssertionError(f"{mk.KERNEL_QUAD} disagrees with its plain "
                                 f"version: {row}")
        rows.append(row)
    return rows


def single_direction_grad_check(gen):
    """Gradients of one "rl" ``directional_scan`` (kernels #1 and #2 under
    autograd) against the plain path, 1e-5 of the largest magnitude.
    Returns the counted run's launches by shape."""
    from repro_torch.core.gspn import directional_scan
    from repro_torch.kernels import cuda_lib

    args = _scan_inputs(gen, 2 * BATCH, 28, 28, 2, torch.float32, False)
    r = torch.randn(args[0].shape, generator=gen, device="cuda")

    def grads(impl):
        leaves = [a.clone().requires_grad_(True) for a in args]
        out = directional_scan(*leaves, "rl", impl=impl)
        return torch.autograd.grad((out * r).sum(), leaves)

    cuda_lib.clear_counts()
    got = grads("auto")
    launches = dict(cuda_lib.launch_counts)
    shapes = dict(cuda_lib.launch_shapes)
    want = grads("torch")
    torch.cuda.synchronize()
    worst = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(got, want))
    print(f"directional_scan 'rl' gradients, kernels vs plain: launches "
          f"{launches}, worst error / largest magnitude {worst:.3e}",
          flush=True)
    if launches != {"gspn_scan_fwd": 1, "gspn_scan_bwd": 1} \
            or not worst <= 1e-5:
        raise AssertionError("single-direction gradients disagree or "
                             "missed the kernels")
    return shapes


def _profile(fn, wall_s, what, spans=None):
    """Where one call of ``fn`` spends device time: the profiler's device
    time by kernel, the scan kernels' share (forward and adjoint), and the
    device's idle share of an eager call that took ``wall_s``.  With
    ``spans``, a prefix of ``obs`` span names, tracing is on for the call
    and the device time of the kernels launched inside those spans is
    read from the same profile, by span.  Returns the device time in ms,
    None when the profiler recorded none."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    if spans:
        obs.clear()
        obs.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        obs.disable()
    # Kernel records only: the operator records carry the same device
    # time, and so do the device-side ranges that the profiler adds for
    # each obs span (named as the span, idle gaps included).
    spanned = {r.name for r in obs.records()}
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0 and e.key not in spanned]
    ops.sort(key=lambda e: -e.self_device_time_total)
    device_us = sum(e.self_device_time_total for e in ops)
    scan_us = {k: sum(e.self_device_time_total for e in ops
                      if f"{k}<" in e.key)
               for k in SCAN_KERNELS}
    if device_us == 0:
        print(f"profile {what}: the profiler recorded no device time; "
              f"device breakdown not measured", flush=True)
        return None
    scans = ", ".join(f"{k} {v / 1e3:.3f} ms ({v / device_us:.4f})"
                      for k, v in scan_us.items())
    print(f"profile {what}: device time {device_us / 1e3:.3f} ms, eager "
          f"{wall_s * 1e3:.3f} ms, device idle share "
          f"{1 - device_us / 1e6 / wall_s:.3f}, scan kernels "
          f"{sum(scan_us.values()) / 1e3:.3f} ms "
          f"({sum(scan_us.values()) / device_us:.4f} of device time: "
          f"{scans})", flush=True)
    for e in ops[:15]:
        print(f"profile {what} op: {e.self_device_time_total / 1e3:9.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}", flush=True)
    if spans:
        _span_share(prof, spans, device_us, what)
    return device_us / 1e3


def _span_share(prof, prefix, device_us, what):
    """The device time under the host-side ``record_function`` ranges
    whose names start with ``prefix`` (each range's kernels and those of
    the operators inside it), by name, and their share of the profile's
    device time ``device_us``.  Fails when the spans hold more device
    time than the profile has, or when no span was recorded."""
    by_name = collections.Counter()
    count = collections.Counter()
    for e in prof.events():
        if e.name.startswith(prefix) and \
                e.device_type == torch.autograd.DeviceType.CPU:
            by_name[e.name] += e.device_time_total
            count[e.name] += 1
    total = sum(by_name.values())
    if not count:
        raise AssertionError(f"profile {what}: no {prefix}* span recorded")
    parts = ", ".join(f"{n} {by_name[n] / 1e3:.3f} ms x{count[n]}"
                      for n in sorted(by_name))
    if total == 0:
        print(f"profile {what}: {prefix}* spans ({parts}) hold no device "
              f"time; their share not measured", flush=True)
        return
    print(f"profile {what}: {prefix}* spans' device time "
          f"{total / 1e3:.3f} ms, {total / device_us:.4f} of the profile's "
          f"device time ({parts})", flush=True)
    if total > device_us * 1.0001:
        raise AssertionError(f"profile {what}: the {prefix}* spans hold "
                             f"more device time than the profile")


def _profile_forward(model, images, wall_s):
    """The profile of one kernel-path forward, and the forward replayed as
    one CUDA graph, which removes the host's launch overhead."""
    from repro_torch.models.vision import apply_vision

    _profile(lambda: apply_vision(model, images), wall_s, "forward")

    def forward():
        with torch.inference_mode():
            model(images)

    graph_ms = _graph_ms(forward, 1, n=10)
    print(f"forward as one CUDA graph: {graph_ms:.3f} ms "
          f"({BATCH / graph_ms * 1e3:.1f} images/s, median of 10 replays)",
          flush=True)


def model_phase(gen):
    from repro_torch.configs.gspn2_vision import GSPN2_T, reduced_vision
    from repro_torch.data.pipeline import DataConfig, synth_images
    from repro_torch.kernels import cuda_lib
    from repro_torch.models.vision import GSPNVision, apply_vision

    cfg = GSPN2_T
    t0 = time.perf_counter()
    model = GSPNVision(cfg, device="cuda", generator=gen).eval()
    plain = GSPNVision(dataclasses.replace(cfg, impl="torch"),
                       device="meta").eval()
    plain.load_state_dict(model.state_dict(), assign=True)
    batch = synth_images(DataConfig(1, 1, BATCH, seed=0), 0, cfg.img_size,
                         cfg.n_classes)
    images = torch.from_numpy(batch["images"]).cuda()
    torch.cuda.synchronize()
    print(f"model {cfg.name}: {sum(p.numel() for p in model.parameters())} "
          f"parameters, set-up {time.perf_counter() - t0:.3f} s", flush=True)

    apply_vision(model, images)                       # warm-up, not counted
    torch.cuda.synchronize()
    cuda_lib.clear_counts()
    logits = apply_vision(model, images)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launch_counts)
    shapes = dict(cuda_lib.launch_shapes)
    plain_calls = sum(cuda_lib.plain_calls.values())
    print(f"main path: launches {launches}, by shape "
          f"{ {'/'.join(map(str, k)): v for k, v in shapes.items()} }, "
          f"plain scan calls {plain_calls}", flush=True)
    n_blocks = sum(cfg.depths)
    if launches != {"gspn_pair_fwd": 2 * n_blocks} or plain_calls:
        raise AssertionError(
            f"expected {2 * n_blocks} pair launches and no plain scan in one "
            f"forward, got {launches} and {plain_calls} plain calls")

    ref = apply_vision(plain, images)
    torch.cuda.synchronize()
    if logits.shape != (BATCH, cfg.n_classes) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits: {logits.shape}")
    err = (logits - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"logits kernel vs plain path: max_abs_err={err} "
          f"max_abs={scale} tol={1e-4 * scale}", flush=True)
    if not err <= 1e-4 * scale:
        raise AssertionError("kernel path logits disagree with the plain path")

    n = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        apply_vision(model, images)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n
    t0 = time.perf_counter()
    for _ in range(3):
        apply_vision(plain, images)
    torch.cuda.synchronize()
    dt_plain = (time.perf_counter() - t0) / 3
    print(f"forward batch {BATCH} at {cfg.img_size}^2: kernel path "
          f"{dt * 1e3:.3f} ms ({BATCH / dt:.1f} images/s, {n} runs), plain "
          f"path {dt_plain * 1e3:.3f} ms ({BATCH / dt_plain:.1f} images/s, "
          f"3 runs), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    _profile_forward(model, images, dt)

    # The reduced model on the card against the plain path on the CPU.
    small = reduced_vision()
    cpu = GSPNVision(small, device="cpu",
                     generator=torch.Generator().manual_seed(1)).eval()
    card = GSPNVision(small, device="meta").eval()
    card.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()},
                         assign=True)
    b = synth_images(DataConfig(1, 1, 4, seed=1), 0, small.img_size,
                     small.n_classes)
    x = torch.from_numpy(b["images"])
    want = apply_vision(cpu, x)
    got = apply_vision(card, x.cuda()).cpu()
    err = (got - want).abs().max().item()
    print(f"reduced model card vs CPU: max_abs_err={err}", flush=True)
    if not err <= 1e-4 * want.abs().max().item():
        raise AssertionError("reduced model on the card disagrees with CPU")
    return shapes


def _twin():
    """The trainer twin, ``examples/train_vision_torch.py``, as a module."""
    path = ROOT / "examples" / "train_vision_torch.py"
    spec = importlib.util.spec_from_file_location("train_vision_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def train_phase(gen):
    """One GSPN-2-T training step at full width: counted, held against the
    plain path, timed and profiled.  Returns the counted step's launches
    by shape."""
    from repro_torch.configs.gspn2_vision import GSPN2_T
    from repro_torch.data.pipeline import DataConfig, synth_images
    from repro_torch.kernels import cuda_lib
    from repro_torch.models.vision import GSPNVision, vision_loss
    from repro_torch.optim.adamw import AdamWConfig

    cfg = GSPN2_T
    model = GSPNVision(cfg, device="cuda", generator=gen)
    plain = GSPNVision(dataclasses.replace(cfg, impl="torch"), device="meta")
    plain.load_state_dict(model.state_dict(), assign=True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in synth_images(
        DataConfig(1, 1, BATCH, seed=0), 0, cfg.img_size,
        cfg.n_classes).items()}
    params = dict(model.named_parameters())

    def loss_and_grads(m):
        loss, _ = vision_loss(m, batch)
        return loss, torch.autograd.grad(loss, list(m.parameters()))

    loss_and_grads(model)                            # warm-up, not counted
    torch.cuda.synchronize()
    cuda_lib.clear_counts()
    loss, grads = loss_and_grads(model)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launch_counts)
    shapes = dict(cuda_lib.launch_shapes)
    plain_calls = sum(cuda_lib.plain_calls.values())
    print(f"train step: launches {launches}, by shape "
          f"{ {'/'.join(map(str, k)): v for k, v in shapes.items()} }, "
          f"plain scan calls {plain_calls}", flush=True)
    n = 2 * sum(cfg.depths)
    if launches != {"gspn_pair_fwd": n, "gspn_pair_bwd": n} or plain_calls:
        raise AssertionError(
            f"expected {n} pair launches and {n} pair adjoint launches and "
            f"no plain scan in one step, got {launches} and {plain_calls} "
            f"plain calls")

    want_loss, want = loss_and_grads(plain)
    torch.cuda.synchronize()
    rel = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
    errs = {name: ((g - w).abs().max() / w.abs().max()).item()
            for name, g, w in zip(params, grads, want)}
    worst = max(errs, key=errs.get)
    print(f"train step kernel vs plain path: loss {loss.item()} vs "
          f"{want_loss.item()} (relative {rel:.3e}, tol 1e-5); gradients of "
          f"{len(errs)} parameters, worst {worst} at {errs[worst]:.3e} of "
          f"its largest magnitude (tol 1e-4), median "
          f"{statistics.median(errs.values()):.3e}", flush=True)
    if not all(torch.isfinite(g).all() for g in grads):
        raise AssertionError("non-finite gradients")
    if not rel <= 1e-5 or not errs[worst] <= 1e-4:
        raise AssertionError("kernel path gradients disagree with the "
                             "plain path")
    del plain, grads, want

    n_steps = 5
    t0 = time.perf_counter()
    for _ in range(n_steps):
        loss_and_grads(model)
    torch.cuda.synchronize()
    dt_grads = (time.perf_counter() - t0) / n_steps
    print(f"loss and gradients only (forward + backward): "
          f"{dt_grads * 1e3:.3f} ms ({n_steps} runs)", flush=True)

    step, _ = _twin().make_step(
        model, AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60,
                           weight_decay=0.01))
    step(batch)                                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(batch) for _ in range(n_steps)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_steps
    losses = [v.item() for v in losses]
    print(f"train step batch {BATCH} at {cfg.img_size}^2, f32, AdamW: "
          f"{dt * 1e3:.3f} ms ({BATCH / dt:.1f} images/s, {n_steps} steps), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"losses {losses}", flush=True)
    if not all(map(math.isfinite, losses)):
        raise AssertionError("non-finite training loss")
    _profile(lambda: step(batch), dt, "train step")
    return shapes


def twin_phase():
    """The trainer twin on the card: 60 steps, must learn."""
    t0 = time.perf_counter()
    acc = _twin().main(["--steps", "60"])
    print(f"trainer twin: held-out accuracy {acc:.2f} after 60 steps, "
          f"{time.perf_counter() - t0:.3f} s", flush=True)


def _ladder_rungs(x, wl, wc, wr, lam):
    """The four rungs of one four-direction pass, each from the same
    operands in the original orientation (taps and lam stacked per
    direction, (4, ...)) to the (4, G, N, N) result in that orientation:
    name -> (function, its kernel launches)."""
    from repro_torch.core.gspn import DIRECTIONS, directional_scan
    from repro_torch.kernels.gspn_multidir import gspn_scan_quad

    def per_direction():
        return torch.stack([directional_scan(x, wl[i], wc[i], wr[i], lam[i], d)
                            for i, d in enumerate(DIRECTIONS)])

    def quad():
        # Entries 2 and 3 (lr, rl) go in and come out in transposed
        # geometry.
        def t4(a):
            return torch.stack([a[0], a[1], a[2].transpose(-1, -2),
                                a[3].transpose(-1, -2)])
        return t4(gspn_scan_quad(x, t4(wl), t4(wc), t4(wr), t4(lam)))

    return {
        "per_step": (lambda: directional_scan(x, wl, wc, wr, lam, DIRECTIONS,
                                              impl="per_step"), {}),
        "per_direction": (per_direction, {"gspn_scan_fwd": 4}),
        "pair": (lambda: directional_scan(x, wl, wc, wr, lam, DIRECTIONS),
                 {"gspn_pair_fwd": 2}),
        "quad": (quad, {"gspn_quad_fwd": 1}),
    }


def ladder_phase(gen):
    """The four-direction launch ladder at GSPN-2-T's stage shapes, batch
    64, f32.  Timing runs with tracing off; then one counted pass of every
    rung with tracing on, whose launches are asserted from the counters
    and from the spans and written as a Chrome trace.  Returns that pass's
    launches by shape for the single scan and the quad."""
    from repro_torch import obs
    from repro_torch.core.gspn import DIRECTIONS, _normalize_taps_oriented
    from repro_torch.kernels import cuda_lib
    from repro_torch.obs import report

    g, gw = 2 * BATCH, BATCH
    operands = {}
    for n in MAIN_WIDTHS:
        x = torch.randn((g, n, n), generator=gen, device="cuda")
        lam = torch.sigmoid(torch.randn((4, g, n, n), generator=gen,
                                        device="cuda"))
        logits = torch.randn((4, gw, n, n, 3), generator=gen, device="cuda")
        taps = [_normalize_taps_oriented(logits[i], d, "softmax")
                for i, d in enumerate(DIRECTIONS)]
        wl, wc, wr = (torch.stack([t[k] for t in taps]) for k in range(3))
        operands[n] = (x, wl, wc, wr, lam)
        for name, (fn, _) in _ladder_rungs(*operands[n]).items():
            graph = "n/a (synchronises every row)" if name == "per_step" \
                else f"{_graph_ms(fn, 5):.6f}"
            eager = _median_ms(fn, n=5 if name == "per_step" else 20)
            print(f"ladder time n={n} g={g} cpw=2 float32 rung={name}: "
                  f"graph_ms={graph} eager_ms={eager:.6f}", flush=True)

    shapes = {}
    obs.enable()
    try:
        for n in MAIN_WIDTHS:
            rungs = _ladder_rungs(*operands[n])
            want = rungs["pair"][0]()
            scale = want.abs().max().item()
            for name, (fn, expected) in rungs.items():
                first = len(obs.spans("kernel.launch"))
                cuda_lib.clear_counts()
                with obs.trace("ladder.rung", rung=name, n=n):
                    out = fn()
                torch.cuda.synchronize()
                launches = dict(cuda_lib.launch_counts)
                rows = cuda_lib.plain_calls["per_step_row"]
                shapes.update({k: v for k, v in cuda_lib.launch_shapes.items()
                               if k[0] in ("gspn_scan_fwd", "gspn_quad_fwd")})
                spans = {}
                for r in obs.spans("kernel.launch")[first:]:
                    spans[r.args["kernel"]] = spans.get(r.args["kernel"], 0) + 1
                err = (out - want).abs().max().item()
                print(f"ladder pass n={n} rung={name}: launches {launches}, "
                      f"kernel.launch spans {spans}, per-step row steps "
                      f"{rows}, max_abs_err vs pair {err} (tol "
                      f"{1e-5 * scale})", flush=True)
                if launches != expected or spans != expected:
                    raise AssertionError(f"ladder rung {name} at n={n}: "
                                         f"expected launches {expected}")
                if name == "per_step" and rows != 4 * n:
                    raise AssertionError(f"per_step ran {rows} row steps, "
                                         f"expected {4 * n}")
                if out.shape != want.shape or not err <= 1e-5 * scale:
                    raise AssertionError(f"ladder rung {name} at n={n} "
                                         f"disagrees with the pair rung")
    finally:
        obs.disable()
    path = ROOT / "build" / "ladder_trace.json"
    path.parent.mkdir(exist_ok=True)
    obs.save_chrome_trace(path)
    print(f"ladder chrome trace: {path}", flush=True)
    report.summarize_trace(obs.chrome_trace())
    return shapes


def _wall_s(fn, n: int = 5) -> float:
    """Median host-clock seconds of one eager call of ``fn`` that ends in a
    synchronise, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _counted(fn, what, expect):
    """Run ``fn`` with the counters at 0; fail unless #1 was launched
    ``expect`` times and no plain scan ran.  Returns fn's result."""
    from repro_torch.kernels import cuda_lib

    cuda_lib.clear_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = cuda_lib.launch_counts["gspn_scan_fwd"]
    plain = sum(cuda_lib.plain_calls.values())
    print(f"lm {what}: #1 launches {launches}, plain scan calls {plain}",
          flush=True)
    if dict(cuda_lib.launch_counts) != ({"gspn_scan_fwd": expect}
                                        if expect else {}) or plain:
        raise AssertionError(f"lm {what}: expected {expect} launches of #1 "
                             f"and no plain scan, got "
                             f"{dict(cuda_lib.launch_counts)} and {plain}")
    return out


def _logits_check(what, got, want, tol=1e-4, tag="lm"):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    print(f"{tag} {what}: logits max_abs_err={err} max_abs={scale} "
          f"tol={tol * scale}", flush=True)
    if not (torch.isfinite(got).all() and err <= tol * scale):
        raise AssertionError(f"{tag} {what}: logits disagree")


def lm_serve_phase():
    """The LM serving path at full width (``qwen2-1.5b-gspn`` ``full()``):
    kernel path against the plain path, chunk chain against one-shot and
    decode against the forward under the f32 policy, then the engine over
    the requests of ``SERVE_PROMPTS`` under the config's own policy.
    Returns the engine run's launches by shape."""
    from repro_torch import obs
    from repro_torch.configs.base import with_precision
    from repro_torch.configs.qwen2_1_5b_gspn import full
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = full()
    prompts, chunk, new, check_len = (SERVE_PROMPTS, SERVE_CHUNK, SERVE_NEW,
                                      CHECK_LEN)
    device = "cuda"
    per_pass = 2 * cfg.layer_count()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    model = lm.LM(cfg, device=device, generator=gen)
    torch.cuda.synchronize()
    print(f"lm {cfg.name}: {lm.count_params(model)} parameters "
          f"({cfg.layer_count()} layers, d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, C_proxy {cfg.gspn_proxy_dim}, "
          f"row width {cfg.gspn_row_width}), set-up "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    # (b), (c): the f32 policy over the same weights (stored in f32).
    f32 = with_precision(cfg, "f32")
    kern = lm.LM(f32, device="meta")
    kern.load_state_dict(model.state_dict(), assign=True)
    plain = lm.LM(dataclasses.replace(f32, gspn_impl="torch"), device="meta")
    plain.load_state_dict(model.state_dict(), assign=True)
    toks = torch.randint(0, cfg.vocab, (1, check_len + 2), generator=gen,
                         device=device)
    prompt = toks[:, :check_len]
    with torch.no_grad():
        logits, caches = _counted(lambda: lm.lm_prefill(kern, prompt,
                                                        check_len + 2),
                                  f"f32 prefill of {check_len}", per_pass)
        want, _ = lm.lm_prefill(plain, prompt, check_len + 2)
        _logits_check(f"f32 prefill of {check_len}, kernel vs plain",
                      logits, want)
        del want
        c = lm.init_lm_cache(f32, 1, check_len + 2, device=device)
        parts = []
        for lo in range(0, check_len, chunk):
            part, c = _counted(
                lambda: lm.lm_prefill_chunk(kern, prompt[:, lo:lo + chunk],
                                            c, lo),
                f"f32 chunk at {lo}", per_pass)
            parts.append(part)
        _logits_check(f"f32 chunk chain of {check_len} vs one-shot",
                      torch.cat(parts, 1), logits)
        worst = max((a.float() - b.float()).abs().max().item()
                    / max(b.float().abs().max().item(), 1e-30)
                    for k in caches for n in caches[k]
                    for a, b in [(c[k][n], caches[k][n])])
        print(f"lm f32 chunk chain caches vs one-shot: worst leaf error / "
              f"largest magnitude {worst:.3e} (tol 1e-4)", flush=True)
        if not worst <= 1e-4:
            raise AssertionError("chunk-chain caches disagree")
        del parts, c
        steps = []
        for i in (check_len, check_len + 1):
            step, caches = _counted(
                lambda: lm.lm_decode_step(kern, toks[:, i:i + 1], caches),
                f"f32 decode step at {i}", 0)
            steps.append(step)
        full_logits = lm.apply_lm(kern, toks)[:, check_len:]
        _logits_check("f32 decode vs apply_lm", torch.cat(steps, 1),
                      full_logits)
        del logits, caches, steps, full_logits, kern, plain
    print(f"lm f32 checks: peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)

    # (d): the engine under the config's own policy.
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(model, batch_size=4, max_len=max(prompts) + new,
                      prefill_chunk=chunk)
    rng = torch.Generator().manual_seed(1)
    reqs = [Request(uid=i, prompt=torch.randint(0, cfg.vocab, (n,),
                                                generator=rng).numpy(),
                    max_new_tokens=new) for i, n in enumerate(prompts)]
    handles = [eng.submit(r) for r in reqs]
    torch.cuda.synchronize()
    cuda_lib.clear_counts()
    obs.clear()
    obs.enable()
    try:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        obs.disable()
    launches = dict(cuda_lib.launch_counts)
    shapes = dict(cuda_lib.launch_shapes)
    plain_calls = sum(cuda_lib.plain_calls.values())
    m = eng.metrics
    passes = m["prefills"] + m["prefill_chunks"]
    results = [h.result() for h in handles]
    total = sum(len(r.tokens) for r in results)
    for r, n in zip(results, prompts):
        print(f"lm serve request {r.uid}: prompt {n}, ttft "
              f"{r.ttft * 1e3:.3f} ms, queue {r.queue_delay * 1e3:.3f} ms, "
              f"chunks {r.prefill_chunks}, {len(r.tokens)} tokens "
              f"{r.tokens}", flush=True)
    step_ms = [s.dur / 1e6 for s in obs.spans("serve.decode_step")]
    chunk_ms = [s.dur / 1e6 for s in obs.spans("serve.prefill_chunk")]
    print(f"lm serve: {len(results)} requests, {total} tokens in "
          f"{dt:.3f} s ({total / dt:.3f} tok/s); {m['prefills']} one-shot "
          f"prefills, {m['prefill_chunks']} chunks, {m['decode_steps']} "
          f"decode steps; median decode step {statistics.median(step_ms):.3f}"
          f" ms (of {len(step_ms)}), median chunk "
          f"{statistics.median(chunk_ms):.3f} ms (of {len(chunk_ms)}); peak "
          f"memory of the run {torch.cuda.max_memory_allocated() / 2**30:.3f}"
          f" GiB",
          flush=True)
    print(f"lm serve: #1 launches {launches} by shape "
          f"{ {'/'.join(map(str, k)): v for k, v in shapes.items()} }, "
          f"plain scan calls {plain_calls}, {per_pass} expected per prefill "
          f"or chunk", flush=True)
    if launches != {"gspn_scan_fwd": per_pass * passes} or plain_calls:
        raise AssertionError(f"lm serve: expected {per_pass} launches of #1 "
                             f"per prefill or chunk ({passes}) and none per "
                             f"decode step")
    if [len(r.tokens) for r in results] != [new] * len(prompts) or \
            not all(0 <= t < cfg.vocab for r in results for t in r.tokens):
        raise AssertionError("lm serve: wrong tokens")

    # The card's idle share over one decode step of the 4 slots and one
    # chunk of 1024 tokens resumed at 1024.
    last = eng.last_token
    caches = eng.pool.caches
    c = lm.init_lm_cache(cfg, 1, eng.max_len, device=device)
    for sub in c.values():
        sub["pos"].fill_(chunk)
    ctoks = toks[:, :chunk]
    with torch.no_grad():
        def decode():
            return lm.lm_decode_step(model, last, caches)

        def resume():
            return lm.lm_prefill_chunk(model, ctoks, c, chunk)

        _profile(decode, _wall_s(decode), "lm decode step (4 slots)")
        _profile(resume, _wall_s(resume), f"lm chunk of {chunk}")
    return shapes


def _train_counted(fn, what, expect):
    """Run ``fn`` with the counters at 0; fail unless #1 and #2 were
    launched as ``expect`` says and no plain scan ran.  Returns fn's
    result and the launches by shape."""
    from repro_torch.kernels import cuda_lib

    cuda_lib.clear_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launch_counts)
    shapes = dict(cuda_lib.launch_shapes)
    plain = sum(cuda_lib.plain_calls.values())
    print(f"lm train {what}: launches {launches} by shape "
          f"{ {'/'.join(map(str, k)): v for k, v in shapes.items()} }, "
          f"plain scan calls {plain}", flush=True)
    if launches != expect or plain:
        raise AssertionError(f"lm train {what}: expected launches {expect} "
                             f"and no plain scan, got {launches} and {plain}")
    return out, shapes


def _lm_example():
    """``examples/train_lm_torch.py`` as a module."""
    path = ROOT / "examples" / "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def lm_train_phase():
    """The LM training path at full width (``qwen2-1.5b-gspn`` ``full()``,
    seeded weights, ``synth_tokens`` batches): (a) the f32 kernel path
    against the plain path, loss and every gradient; (b) the config's own
    policy under ``remat="unit"``: a counted step, the timed steps, loss
    and gradients alone, peak memory and a profiled step; (c) the ``bf16``
    preset with the master copy and loss scaling; (d) the trainer twin and
    its restart.  Returns (b)'s counted step's launches by shape."""
    import shutil

    from repro_torch.configs.base import with_precision
    from repro_torch.configs.qwen2_1_5b_gspn import full
    from repro_torch.data.pipeline import DataConfig, host_batch, to_device
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import (LossScaleConfig, build_train_step,
                                        init_train_state)

    cfg = full()
    n_layers = cfg.layer_count()
    device = "cuda"

    def batch_of(n, seq, step):
        return to_device(host_batch(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                               global_batch=n), step), device)

    def loss_and_grads(m, batch):
        loss, _ = lm.lm_loss(m, batch)
        return loss, torch.autograd.grad(loss, list(m.parameters()))

    # (a) The f32 policy, no rematerialisation: kernels against plain.
    f32 = dataclasses.replace(with_precision(cfg, "f32"), remat="none")
    gen = torch.Generator(device=device).manual_seed(2)
    model = lm.LM(f32, device=device, generator=gen)
    plain = lm.LM(dataclasses.replace(f32, gspn_impl="torch"), device="meta")
    plain.load_state_dict(model.state_dict(), assign=True)
    batch = batch_of(1, CHECK_LEN, 0)
    per = 2 * n_layers
    (loss, grads), _ = _train_counted(
        lambda: loss_and_grads(model, batch),
        f"f32 loss and gradients, 1 x {CHECK_LEN} tokens",
        {"gspn_scan_fwd": per, "gspn_scan_bwd": per})
    want_loss, want = loss_and_grads(plain, batch)
    torch.cuda.synchronize()
    rel = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
    errs = {n: ((g - w).abs().max() / w.abs().max()).item()
            for (n, _), g, w in zip(model.named_parameters(), grads, want)}
    worst = max(errs, key=errs.get)
    print(f"lm train f32 kernel vs plain: loss {loss.item()} vs "
          f"{want_loss.item()} (relative {rel:.3e}, tol 1e-5); gradients "
          f"of {len(errs)} parameters, worst {worst} at {errs[worst]:.3e} "
          f"of its largest magnitude (tol 1e-4), median "
          f"{statistics.median(errs.values()):.3e}", flush=True)
    if not all(torch.isfinite(g).all() for g in grads):
        raise AssertionError("lm train: non-finite gradients")
    if not rel <= 1e-5 or not errs[worst] <= 1e-4:
        raise AssertionError("lm train: kernel path disagrees with the "
                             "plain path")
    del model, plain, grads, want, loss, want_loss
    torch.cuda.empty_cache()

    # (b) The config's own policy (f32 parameters, bf16 products, the
    # mixer in f32) under remat="unit", AdamW.
    if cfg.remat != "unit":
        raise AssertionError(f"full() rematerialises {cfg.remat!r}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    gen = torch.Generator(device=device).manual_seed(3)
    model = lm.LM(cfg, device=device, generator=gen)
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=100)
    state = init_train_state(model, ocfg)
    step = build_train_step(model, ocfg)
    batches = [batch_of(TRAIN_BATCH, TRAIN_SEQ, s) for s in range(2)]
    state, _ = step(state, batches[0])                # warm-up, not counted
    torch.cuda.synchronize()
    (state, metrics), shapes = _train_counted(
        lambda: step(state, batches[1]),
        f"step, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, remat unit",
        {"gspn_scan_fwd": 4 * n_layers, "gspn_scan_bwd": 2 * n_layers})
    for (g, h, w, _, _) in TRAIN_SHAPES:
        for name, n in (("gspn_scan_fwd", 2 * n_layers),
                        ("gspn_scan_bwd", n_layers)):
            if shapes.get((name, g, h, w, "float32")) != n:
                raise AssertionError(f"lm train: expected {n} launches of "
                                     f"{name} at {g}x{h}x{w}")
    print(f"lm train step metrics: " + ", ".join(
        f"{k} {float(v):.6g}" for k, v in metrics.items()), flush=True)

    batch = batches[1]
    dt_grads = _wall_s(lambda: loss_and_grads(model, batch), n=TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for s in range(TRAIN_STEPS):
        b = batch_of(TRAIN_BATCH, TRAIN_SEQ, 2 + s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    print(f"lm train step {TRAIN_BATCH} x {TRAIN_SEQ} tokens, its own "
          f"policy, remat unit, AdamW: median {dt * 1e3:.3f} ms of "
          f"{TRAIN_STEPS} steps ({[round(t * 1e3, 3) for t in times]}), "
          f"{tokens / dt:.1f} tokens/s; loss and gradients alone "
          f"{dt_grads * 1e3:.3f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; losses "
          f"{losses}", flush=True)
    if not all(map(math.isfinite, losses)):
        raise AssertionError("lm train: non-finite loss")
    _profile(lambda: step(state, batch), dt, "lm train step")
    del model, state, step, batches, batch, metrics
    torch.cuda.empty_cache()

    # (c) The bf16 preset: bf16 parameters and scans, the f32 master copy
    # and dynamic loss scaling.
    bf16 = with_precision(cfg, "bf16")
    gen = torch.Generator(device=device).manual_seed(4)
    model = lm.LM(bf16, device=device, generator=gen)
    ls = LossScaleConfig()
    state = init_train_state(model, ocfg, master_weights=True,
                             loss_scaling=ls)
    step = build_train_step(model, ocfg, master_weights=True,
                            loss_scaling=ls)
    torch.cuda.reset_peak_memory_stats()
    for s in range(2):
        b = batch_of(TRAIN_BATCH, TRAIN_SEQ, s)
        t0 = time.perf_counter()
        (state, metrics), bshapes = _train_counted(
            lambda: step(state, b), f"bf16 master step {s}",
            {"gspn_scan_fwd": 4 * n_layers, "gspn_scan_bwd": 2 * n_layers})
        dt_b = time.perf_counter() - t0
        if {k[-1] for k in bshapes} != {"bfloat16"}:
            raise AssertionError("lm train: the bf16 step ran f32 scans")
        same = all(torch.equal(p, state["master"][n].to(torch.bfloat16))
                   for n, p in state["params"].items())
        print(f"lm train bf16 master step {s}: {dt_b * 1e3:.3f} ms, loss "
              f"{float(metrics['loss']):.6f}, grads_finite "
              f"{float(metrics['grads_finite']):.0f}, loss scale "
              f"{float(metrics['loss_scale'])} -> "
              f"{float(state['loss_scale']['scale'])}, working copy == "
              f"master rounded to bf16: {same}", flush=True)
        if float(metrics["grads_finite"]) != 1.0 or not same:
            raise AssertionError("lm train: bf16 master step failed")
    print(f"lm train bf16 master steps: peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    del model, state, step, metrics
    torch.cuda.empty_cache()

    # (d) The trainer twin, then a restart from its checkpoint.
    ckpt = ROOT / "build" / "lm_twin_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    example = _lm_example()
    argv = ["--preset", "small", "--mixer", "gspn", "--ckpt-dir", str(ckpt)]
    t0 = time.perf_counter()
    tr = example.main(argv + ["--steps", str(TWIN_STEPS)])
    print(f"lm trainer twin: loss {tr.history[0]:.4f} -> "
          f"{tr.history[-1]:.4f} over {len(tr.history)} steps, "
          f"{tr.recoveries} recoveries, {tr.stragglers} stragglers, "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    if not tr.history[-1] < tr.history[0] or tr.step != TWIN_STEPS:
        raise AssertionError("lm trainer twin: the loss did not fall")
    tr = example.main(argv + ["--steps", "10"])
    print(f"lm trainer twin restart: resumed at step {tr._first_step}, "
          f"ran to {tr.step}, loss {tr.history[0]:.4f} -> "
          f"{tr.history[-1]:.4f}", flush=True)
    if tr._first_step != TWIN_STEPS or tr.step != TWIN_STEPS + 10 or \
            not all(map(math.isfinite, tr.history)):
        raise AssertionError("lm trainer twin did not restart from its "
                             "checkpoint")
    return shapes


def _no_scans(fn, what, tag="lm attn"):
    """Run ``fn`` with the counters at 0; fail if any GSPN scan ran (the
    attention, SSM and xLSTM paths launch no kernel of their own and no
    scan).  Returns fn's result."""
    from repro_torch.kernels import cuda_lib

    cuda_lib.clear_counts()
    out = fn()
    torch.cuda.synchronize()
    if cuda_lib.launch_counts or cuda_lib.plain_calls:
        raise AssertionError(f"{tag} {what}: a scan ran: "
                             f"{dict(cuda_lib.launch_counts)}, "
                             f"{dict(cuda_lib.plain_calls)}")
    return out


def _exact_attention(q, k, v):
    """Causal GQA attention in f64 (q's head h reads kv head h // G),
    returned in q's dtype: the exact value both f32 paths round."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.double().reshape(b, s, hkv, hq // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.double()) / math.sqrt(d)
    i = torch.arange(s, device=q.device)
    p = torch.softmax(torch.where(i[None, :] <= i[:, None], logits,
                                  -math.inf), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.double())
    return out.reshape(b, s, hq, d).to(q.dtype)


def lm_attn_phase():
    """The attn block kind at full width: ``qwen2-1.5b`` ``full()`` cut to
    TIER_LAYERS of its 28 layers, with seeded weights.  (a) Under the f32 policy: a chunk chain against the
    one-shot prefill, decode against ``apply_lm``, and
    ``chunked_attention`` against ``full_attention`` at one layer's
    shapes; (b) the engine over ``SERVE_PROMPTS`` under the config's own
    policy; (c) training at ``TRAIN_BATCH`` x ``TRAIN_SEQ`` under
    ``remat="unit"`` with AdamW; (d) ``granite-3-2b`` ``full()`` under the
    f32 policy, prefill and decode against ``apply_lm``."""
    from repro_torch import obs
    from repro_torch.configs import granite_3_2b
    from repro_torch.configs.base import with_precision
    from repro_torch.configs.qwen2_1_5b import full
    from repro_torch.data.pipeline import DataConfig, host_batch, to_device
    from repro_torch.models import attention, lm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train.step import build_train_step, init_train_state

    # Full width, the tier's TIER_LAYERS of the 28 layers (the smoke's
    # time limit).
    cfg = dataclasses.replace(full(), unit=(("attn", TIER_LAYERS),),
                              n_layers=TIER_LAYERS)
    device = "cuda"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(0)
    model = lm.LM(cfg, device=device, generator=gen)
    torch.cuda.synchronize()
    print(f"lm attn {cfg.name}: {lm.count_params(model)} parameters "
          f"({cfg.layer_count()} of {full().n_layers} layers, d_model "
          f"{cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads}, head_dim {cfg.hd}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, qkv bias {cfg.qkv_bias}, "
          f"tied {cfg.tie_embeddings}), set-up "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    # (a) The f32 policy over the same weights (stored in f32).
    f32 = with_precision(cfg, "f32")
    kern = lm.LM(f32, device="meta")
    kern.load_state_dict(model.state_dict(), assign=True)
    chunk, check_len = SERVE_CHUNK, CHECK_LEN
    max_len = check_len + 2
    toks = torch.randint(0, cfg.vocab, (1, max_len), generator=gen,
                         device=device)
    prompt = toks[:, :check_len]
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, caches = _no_scans(
            lambda: lm.lm_prefill(kern, prompt, max_len),
            f"f32 prefill of {check_len}")
        print(f"lm attn f32 prefill of {check_len}: "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
        c = lm.init_lm_cache(f32, 1, max_len, device=device)
        parts = []
        for lo in range(0, check_len, chunk):
            part, c = _no_scans(
                lambda: lm.lm_prefill_chunk(kern, prompt[:, lo:lo + chunk],
                                            c, lo),
                f"f32 chunk at {lo}")
            parts.append(part)
        _logits_check(f"attn f32 chunk chain of {check_len} vs one-shot",
                      torch.cat(parts, 1), logits)
        worst = max((a.float() - b.float()).abs().max().item()
                    / max(b.float().abs().max().item(), 1e-30)
                    for k in caches for n in ("k", "v")
                    for a, b in [(c[k][n], caches[k][n])])
        print(f"lm attn f32 chunk chain KV caches vs one-shot: worst leaf "
              f"error / largest magnitude {worst:.3e} (tol 1e-4)",
              flush=True)
        if not worst <= 1e-4 or not all(
                torch.equal(c[k]["length"], caches[k]["length"])
                for k in caches):
            raise AssertionError("lm attn: chunk-chain caches disagree")
        del parts, c
        steps = []
        for i in (check_len, check_len + 1):
            step, caches = _no_scans(
                lambda: lm.lm_decode_step(kern, toks[:, i:i + 1], caches),
                f"f32 decode step at {i}")
            steps.append(step)
        # The reference forward of all max_len tokens with its attention
        # dense: 2050 = 2 x 1025 would halve block_k from 512 down to 2.
        dense = lm.LM(dataclasses.replace(f32, attn_block_k=max_len),
                      device="meta")
        dense.load_state_dict(model.state_dict(), assign=True)
        t0 = time.perf_counter()
        full_logits = _no_scans(lambda: lm.apply_lm(dense, toks),
                                f"f32 apply_lm of {max_len}")
        print(f"lm attn f32 apply_lm of {max_len} tokens (attention dense, "
              f"attn_block_k {max_len}): "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
        _logits_check("attn f32 decode vs apply_lm", torch.cat(steps, 1),
                      full_logits[:, check_len:])
        del logits, caches, steps, full_logits, kern, dense

    # One layer's attention in f32: blockwise against dense, forward and
    # gradients, at 1 x 4096 tokens; and each against the exact (f64)
    # attention, which tells the two paths' own f32 rounding apart.
    g2 = torch.Generator(device=device).manual_seed(5)
    seq = 4096
    shapes = ((1, seq, cfg.n_heads, cfg.hd), (1, seq, cfg.n_kv_heads, cfg.hd),
              (1, seq, cfg.n_kv_heads, cfg.hd))
    qkv = [torch.randn(s, generator=g2, device=device).requires_grad_()
           for s in shapes]
    ct = torch.randn(shapes[0], generator=g2, device=device)
    outs = {}
    for name, fn in (("chunked", lambda *a: attention.chunked_attention(
            *a, block_k=cfg.attn_block_k)),
                     ("full", attention.full_attention),
                     ("exact", _exact_attention)):
        out = fn(*qkv)
        outs[name] = (out.detach(), *torch.autograd.grad(out, qkv, ct))

    def errs(a, b):
        return [((x.double() - y.double()).abs().max()
                 / y.double().abs().max()).item()
                for x, y in zip(outs[a], outs[b])]

    for a, b in (("chunked", "full"), ("chunked", "exact"),
                 ("full", "exact")):
        e = errs(a, b)
        print(f"lm attn {a} vs {b} attention, 1 x {seq}, {cfg.n_heads} "
              f"over {cfg.n_kv_heads} heads, {cfg.hd}, f32: error / "
              f"largest magnitude out {e[0]:.3e}, dq {e[1]:.3e}, dk "
              f"{e[2]:.3e}, dv {e[3]:.3e}", flush=True)
    if not max(errs("chunked", "exact")) <= 1e-5:
        raise AssertionError("lm attn: chunked_attention is not within "
                             "1e-5 of the exact attention")
    if not max(errs("chunked", "full")) <= 2e-5:
        raise AssertionError("lm attn: chunked_attention disagrees with "
                             "full_attention")
    del qkv, ct, outs
    print(f"lm attn f32 checks: peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)

    # (b) The engine under the config's own policy.
    torch.cuda.reset_peak_memory_stats()
    prompts, new = SERVE_PROMPTS, SERVE_NEW
    eng = ServeEngine(model, batch_size=4, max_len=max(prompts) + new,
                      prefill_chunk=chunk)
    rng = torch.Generator().manual_seed(1)
    reqs = [Request(uid=i, prompt=torch.randint(0, cfg.vocab, (n,),
                                                generator=rng).numpy(),
                    max_new_tokens=new) for i, n in enumerate(prompts)]
    handles = [eng.submit(r) for r in reqs]
    torch.cuda.synchronize()
    obs.clear()
    obs.enable()
    try:
        t0 = time.perf_counter()
        _no_scans(eng.run, "engine run")
        dt = time.perf_counter() - t0
    finally:
        obs.disable()
    m = eng.metrics
    results = [h.result() for h in handles]
    total = sum(len(r.tokens) for r in results)
    for r, n in zip(results, prompts):
        print(f"lm attn serve request {r.uid}: prompt {n}, ttft "
              f"{r.ttft * 1e3:.3f} ms, queue {r.queue_delay * 1e3:.3f} ms, "
              f"chunks {r.prefill_chunks}, {len(r.tokens)} tokens "
              f"{r.tokens}", flush=True)
    step_ms = [s.dur / 1e6 for s in obs.spans("serve.decode_step")]
    chunk_ms = [s.dur / 1e6 for s in obs.spans("serve.prefill_chunk")]
    print(f"lm attn serve: {len(results)} requests, {total} tokens in "
          f"{dt:.3f} s ({total / dt:.3f} tok/s); {m['prefills']} one-shot "
          f"prefills, {m['prefill_chunks']} chunks, {m['decode_steps']} "
          f"decode steps; median decode step {statistics.median(step_ms):.3f}"
          f" ms (of {len(step_ms)}), median chunk "
          f"{statistics.median(chunk_ms):.3f} ms (of {len(chunk_ms)}); KV "
          f"pool {eng.pool.nbytes} bytes ({max(prompts) + new} positions x "
          f"4 slots); peak memory of the run "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    if [len(r.tokens) for r in results] != [new] * len(prompts) or \
            not all(0 <= t < cfg.vocab for r in results for t in r.tokens):
        raise AssertionError("lm attn serve: wrong tokens")
    last, pooled = eng.last_token, eng.pool.caches
    c = lm.init_lm_cache(cfg, 1, eng.max_len, device=device)
    ctoks = toks[:, :chunk]
    with torch.no_grad():
        def decode():
            return lm.lm_decode_step(model, last, pooled)

        def resume():
            return lm.lm_prefill_chunk(model, ctoks, c, chunk)

        _profile(decode, _wall_s(decode), "lm attn decode step (4 slots)",
                 spans="attention.")
        _profile(resume, _wall_s(resume), f"lm attn chunk of {chunk} at "
                                          f"{chunk}", spans="attention.")
    del eng, last, pooled, c, model
    torch.cuda.empty_cache()

    # (c) Training under the config's own policy, remat="unit", AdamW.
    if cfg.remat != "unit":
        raise AssertionError(f"full() rematerialises {cfg.remat!r}")

    def batch_of(n, seq, step):
        return to_device(host_batch(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                               global_batch=n), step), device)

    def loss_and_grads(m, batch):
        loss, _ = lm.lm_loss(m, batch)
        return loss, torch.autograd.grad(loss, list(m.parameters()))

    tokens = TRAIN_BATCH * TRAIN_SEQ
    gen = torch.Generator(device=device).manual_seed(3)
    model = lm.LM(cfg, device=device, generator=gen)
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=100)
    state = init_train_state(model, ocfg)
    step = build_train_step(model, ocfg)
    batch = batch_of(TRAIN_BATCH, TRAIN_SEQ, 0)
    state, metrics = _no_scans(lambda: step(state, batch), "train step")
    print(f"lm attn train step metrics: " + ", ".join(
        f"{k} {float(v):.6g}" for k, v in metrics.items()), flush=True)
    dt_grads = _wall_s(lambda: loss_and_grads(model, batch), n=TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for s in range(TRAIN_STEPS):
        b = batch_of(TRAIN_BATCH, TRAIN_SEQ, 1 + s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    print(f"lm attn train step {TRAIN_BATCH} x {TRAIN_SEQ} tokens, its own "
          f"policy, remat unit, AdamW: median {dt * 1e3:.3f} ms of "
          f"{TRAIN_STEPS} steps ({[round(t * 1e3, 3) for t in times]}), "
          f"{tokens / dt:.1f} tokens/s; loss and gradients alone "
          f"{dt_grads * 1e3:.3f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; losses "
          f"{losses}", flush=True)
    if not all(map(math.isfinite, losses)):
        raise AssertionError("lm attn train: non-finite loss")
    # Attention's share: the device time under the attention.* spans of
    # the same profiled step (the blockwise forward, its recompute under
    # remat and its two-sweep backward, in each layer).
    _profile(lambda: step(state, batch), dt, "lm attn train step",
             spans="attention.")
    del state, step, metrics, model
    torch.cuda.empty_cache()

    # (d) granite-3-2b full() under the f32 policy: no qkv bias, groups of
    # 4, an odd vocabulary.
    gcfg = with_precision(granite_3_2b.full(), "f32")
    gen = torch.Generator(device=device).manual_seed(7)
    t0 = time.perf_counter()
    model = lm.LM(gcfg, device=device, generator=gen)
    print(f"lm attn {gcfg.name}: {lm.count_params(model)} parameters "
          f"({gcfg.layer_count()} layers, d_model {gcfg.d_model}, "
          f"{gcfg.n_heads} heads over {gcfg.n_kv_heads}, vocab {gcfg.vocab}, "
          f"qkv bias {gcfg.qkv_bias}), f32, set-up "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    plen, n_dec = 1024, 4
    gtoks = torch.randint(0, gcfg.vocab, (1, plen + n_dec), generator=gen,
                          device=device)
    with torch.no_grad():
        logits, caches = _no_scans(
            lambda: lm.lm_prefill(model, gtoks[:, :plen], plen + n_dec),
            f"granite prefill of {plen}")
        steps = []
        for i in range(plen, plen + n_dec):
            step_logits, caches = _no_scans(
                lambda: lm.lm_decode_step(model, gtoks[:, i:i + 1], caches),
                f"granite decode step at {i}")
            steps.append(step_logits)
        full_logits = lm.apply_lm(model, gtoks)
        _logits_check(f"attn {gcfg.name} f32 prefill of {plen} vs "
                      f"apply_lm", logits, full_logits[:, :plen])
        _logits_check(f"attn {gcfg.name} f32 {n_dec} decode steps vs "
                      f"apply_lm", torch.cat(steps, 1), full_logits[:, plen:])
    if full_logits.shape[-1] != gcfg.vocab:
        raise AssertionError("lm attn granite: wrong vocabulary")
    del model, logits, caches, steps, full_logits
    torch.cuda.empty_cache()


def _busy_ms(prof) -> float | None:
    """Milliseconds in which the card ran at least one kernel, memcpy or
    memset in a profile (the union of the device records' intervals, so
    two streams' overlapping kernels count once), read from the raw
    profiler records; None when it recorded no device activity."""
    cuda = torch.autograd.DeviceType.CUDA
    try:
        spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                       for e in prof.profiler.kineto_results.events()
                       if e.device_type() == cuda)
    except (RuntimeError, AttributeError) as exc:
        print(f"profile: no device records ({exc!r})", flush=True)
        return None
    if not spans:
        return None
    busy, lo, hi = 0, *spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return (busy + hi - lo) / 1e6


def _tier_requests(vocab, lengths, new, seed, prefix=None):
    """Seeded requests of ``lengths`` prompt tokens (after ``prefix``)."""
    from repro_torch.serve.engine import Request

    rng = torch.Generator().manual_seed(seed)
    head = prefix if prefix is not None else torch.empty(0, dtype=torch.long)
    return [Request(uid=i, prompt=torch.cat(
                [head, torch.randint(0, vocab, (n,), generator=rng)]).numpy(),
                    max_new_tokens=new) for i, n in enumerate(lengths)]


def _tier_prefix(kind, model, cfg, max_len):
    """(a) The 6 shared-prefix requests with no prefix cache, then with a
    ``PrefixStateCache``: equal greedy tokens, 5 hits of 3072 tokens, and
    for the GSPN LM 3 chunks x 56 fewer launches of #1 per hit."""
    from repro_torch import obs
    from repro_torch.kernels import cuda_lib
    from repro_torch.serve.cache import PrefixStateCache
    from repro_torch.serve.engine import ServeEngine

    prefix = torch.randint(0, cfg.vocab, (TIER_PREFIX,),
                           generator=torch.Generator().manual_seed(7))
    runs = {}
    for label, cache in (("cold", None),
                         ("warm", PrefixStateCache(TIER_CAPACITY[kind]))):
        eng = ServeEngine(model, batch_size=4, max_len=max_len,
                          prefill_chunk=SERVE_CHUNK, prefix_cache=cache)
        reqs = _tier_requests(cfg.vocab, TIER_SUFFIXES, SERVE_NEW, 3,
                              prefix)
        handles = [eng.submit(r) for r in reqs]
        hits0 = obs.counter("serve_prefix_hits_total").value
        torch.cuda.synchronize()
        cuda_lib.clear_counts()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        res = [h.result() for h in handles]
        shapes = dict(cuda_lib.launch_shapes)
        plain = sum(cuda_lib.plain_calls.values())
        total = sum(len(r.tokens) for r in res)
        hits = obs.counter("serve_prefix_hits_total").value - hits0
        for r, req in zip(res, reqs):
            print(f"lm tier {kind} prefix {label} request {r.uid}: prompt "
                  f"{len(req.prompt)}, ttft {r.ttft * 1e3:.3f} ms, cached "
                  f"{r.cached_tokens}, chunks {r.prefill_chunks}, tokens "
                  f"{r.tokens}", flush=True)
        print(f"lm tier {kind} prefix {label}: {total} tokens in {dt:.3f} s "
              f"({total / dt:.3f} tok/s), prefix hits {hits}, cached tokens "
              f"{sum(r.cached_tokens for r in res)}, cache "
              f"{cache.nbytes if cache is not None else 0} bytes in "
              f"{len(cache) if cache is not None else 0} entries, #1 "
              f"launches by shape "
              f"{ {'/'.join(map(str, k)): v for k, v in shapes.items()} }",
              flush=True)
        if plain:
            raise AssertionError(f"lm tier {kind}: a plain scan ran")
        runs[label] = (res, shapes, hits)
        del eng, handles
    (cold, cshapes, _), (warm, wshapes, hits) = runs["cold"], runs["warm"]
    if [r.tokens for r in warm] != [r.tokens for r in cold]:
        raise AssertionError(f"lm tier {kind}: warm tokens differ from cold")
    cached = sum(r.cached_tokens for r in warm)
    if hits != 5 or cached != 5 * TIER_PREFIX:
        raise AssertionError(f"lm tier {kind}: {hits} hits and {cached} "
                             f"cached tokens, expected 5 and "
                             f"{5 * TIER_PREFIX}")
    if kind == "attn":
        if cshapes or wshapes:
            raise AssertionError("lm tier attn: a scan kernel ran")
        return
    per_hit = 3 * 2 * cfg.layer_count()
    drop = sum(cshapes.values()) - sum(wshapes.values())
    by_shape = {k: cshapes[k] - wshapes.get(k, 0) for k in cshapes}
    print(f"lm tier {kind} prefix: #1 launches fell by {drop} "
          f"({5 * per_hit} expected: 5 hits x 3 chunks x "
          f"{2 * cfg.layer_count()}), by shape "
          f"{ {'/'.join(map(str, k)): v for k, v in by_shape.items()} }",
          flush=True)
    if drop != 5 * per_hit or sorted(v for v in by_shape.values() if v) != \
            [5 * per_hit // 2] * 2:
        raise AssertionError(f"lm tier {kind}: #1's launches fell by {drop}")


def _tier_replicas(model, cfg):
    """(b) The serving phase's requests twice through a threaded Router of
    1 and of 2 replicas sharing ``model``, once per policy, against the
    single engine: equal greedy tokens per uid and equal launches of #1.
    (c) A sync Router of 2 that loses replica 0 after its first chunk.
    Returns the single engine's launches by shape."""
    from repro_torch import obs
    from repro_torch.kernels import cuda_lib
    from repro_torch.serve.engine import ServeEngine, drive
    from repro_torch.serve.router import Router
    from torch.profiler import ProfilerActivity, profile

    max_len = max(SERVE_PROMPTS) + SERVE_NEW
    lengths = SERVE_PROMPTS * 2

    def engine(seed=0):
        return ServeEngine(model, batch_size=4, max_len=max_len,
                           prefill_chunk=SERVE_CHUNK, seed=seed)

    eng = engine()
    reqs = _tier_requests(cfg.vocab, lengths, SERVE_NEW, 5)
    handles = [eng.submit(r) for r in reqs]
    torch.cuda.synchronize()
    cuda_lib.clear_counts()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    want = {h.uid: h.result().tokens for h in handles}
    single = dict(cuda_lib.launch_counts)
    single_shapes = dict(cuda_lib.launch_shapes)
    total = sum(len(t) for t in want.values())
    print(f"lm tier single engine: {len(reqs)} requests, {total} tokens in "
          f"{dt:.3f} s ({total / dt:.3f} tok/s), #1 launches {single}",
          flush=True)
    del eng
    for policy in ("least_loaded", "ttft"):
        for n in (1, 2):
            # Once as it serves, once under a CUDA-only profile for the
            # card's busy time.
            runs = []
            for profiled in (False, True):
                router = Router([engine(seed=i) for i in range(n)],
                                policy=policy, threaded=True)
                reqs = _tier_requests(cfg.vocab, lengths, SERVE_NEW, 5)
                risk0 = obs.counter("router_slo_at_risk_total").value
                torch.cuda.synchronize()
                cuda_lib.clear_counts()
                prof = profile(activities=[ProfilerActivity.CUDA]) \
                    if profiled else contextlib.nullcontext()
                router.start()
                try:
                    with prof:
                        t0 = time.perf_counter()
                        dt, handles = drive(router, reqs,
                                            [0.0] * len(reqs))
                        torch.cuda.synchronize()
                        wall = time.perf_counter() - t0
                finally:
                    router.stop()
                res = {h.uid: h.result() for h in handles}
                runs.append(dict(
                    dt=dt, wall=wall, res=res,
                    placed=[h.replica for h in handles],
                    risk=obs.counter("router_slo_at_risk_total").value - risk0,
                    launches=dict(cuda_lib.launch_counts),
                    busy=_busy_ms(prof) if profiled else None))
                del router, prof
            run, prun = runs
            res = run["res"]
            total = sum(len(r.tokens) for r in res.values())
            ttfts = sorted(r.ttft for r in res.values())
            busy, pwall = prun["busy"], prun["wall"]
            idle = ("not measured" if busy is None
                    else f"{1 - busy / 1e3 / pwall:.3f}")
            print(f"lm tier replicas={n} policy={policy}: {total} tokens in "
                  f"{run['dt']:.3f} s ({total / run['dt']:.3f} tok/s), "
                  f"placement {[run['placed'].count(r) for r in range(n)]},"
                  f" ttft p50 {ttfts[len(ttfts) // 2] * 1e3:.3f} ms max "
                  f"{ttfts[-1] * 1e3:.3f} ms, router_slo_at_risk_total "
                  f"+{run['risk']}, #1 launches {run['launches']}; profiled "
                  f"run {total / prun['dt']:.3f} tok/s, card busy {busy} ms "
                  f"of {pwall * 1e3:.3f} ms (idle share {idle})", flush=True)
            for r in runs:
                if {u: x.tokens for u, x in r["res"].items()} != want:
                    raise AssertionError(f"lm tier replicas={n} {policy}: "
                                         f"tokens differ from the single "
                                         f"engine's")
                if r["launches"] != single:
                    raise AssertionError(f"lm tier replicas={n} {policy}: "
                                         f"#1 launches {r['launches']} != "
                                         f"{single}")

    # (c) sync mode, replica 0 fails after its first chunk.
    router = Router([engine(seed=i) for i in range(2)])
    reqs = _tier_requests(cfg.vocab, SERVE_PROMPTS, SERVE_NEW, 5)
    handles = [router.submit(r) for r in reqs]
    first = {h.uid: h.replica for h in handles}
    while router.replicas[0].engine.metrics["prefill_chunks"] < 1:
        router.tick()
    moved = router.fail_replica(0)
    router.run()
    torch.cuda.synchronize()
    got = {h.uid: h.result().tokens for h in handles}
    print(f"lm tier failure: replica 0 failed after its first chunk, {moved} "
          f"requests re-routed; first placement {first}, final "
          f"{ {h.uid: h.replica for h in handles} }", flush=True)
    if not all(h.done and h.replica == 1 for h in handles) or \
            any(got[u] != want[u] for u in got):
        raise AssertionError("lm tier failure: a request did not finish on "
                             "the survivor with the unfailed run's tokens")
    return single_shapes


def _tier_tuner():
    """(d) The committed seed cache: no entry rejected; the heuristic's and
    the cached shape's µs at each key, beside the bound; and every
    candidate at ``TIER_CHECKED`` against the plain version."""
    from repro_torch import obs
    from repro_torch.kernels import autotune

    seed = autotune.TuningCache.load(autotune.SEED_CACHE_PATH)
    here = autotune.device_kind("cuda")
    print(f"lm tier tuner: seed {autotune.SEED_CACHE_PATH.name}, "
          f"{len(seed)} entries, measured on {seed.meta.get('device')} at "
          f"{seed.meta.get('power_limit')}; this card {here}", flush=True)
    rejects0 = obs.counter("autotune_cache_rejects_total").value
    for enc in sorted(seed.entries):
        key = autotune.ScanKey.decode(enc)
        spec = autotune.ScanSpec(direction=key.direction, impl="cuda",
                                 channels_per_weight=key.cpw,
                                 stream_dtype=key.dtype,
                                 boundary=key.boundary)
        cached = autotune.plan_for_spec(spec, key.g, key.h, key.w,
                                        device=key.device, cache=seed)
        heur = autotune.heuristic(key)
        args = autotune.operands(key)
        run, _ = autotune.kernel_runner(key, args)
        out = run(heur)
        nbytes = sum(t.numel() * t.element_size() for t in args) \
            + out.numel() * out.element_size()
        h_us, h_spread = autotune.measure(lambda: run(heur))
        c_us, c_spread = autotune.measure(lambda: run(cached))
        print(f"lm tier tuner key {enc}: heuristic "
              f"{autotune.Candidate.of(heur).label()} {h_us:.3f} us "
              f"(spread {h_spread:.3f}), cached "
              f"{autotune.Candidate.of(cached).label()} "
              f"[{seed.entries[enc]['source']}] {c_us:.3f} us (spread "
              f"{c_spread:.3f}), bound "
              f"{nbytes / PEAK_BYTES_PER_S * 1e6:.4f} us", flush=True)
    rejects = obs.counter("autotune_cache_rejects_total").value - rejects0
    print(f"lm tier tuner: {rejects} seed entries rejected", flush=True)
    if rejects or not seed.entries:
        raise AssertionError(f"lm tier tuner: {rejects} rejects in a seed "
                             f"of {len(seed)} entries")
    for direction, g, h, w, cpw, bnd in TIER_CHECKED:
        for dtype in ("float32", "bfloat16"):
            key = autotune.ScanKey(here, g, h, w, cpw, direction, dtype,
                                   boundary=bnd)
            cands = autotune.enumerate_candidates(key)
            checked = autotune.check_candidates(key, cands)
            worst = max(e / tol for _, e, tol in checked)
            bad = [c.label() for c, e, tol in checked if not e <= tol]
            print(f"lm tier tuner candidates {key.encode()}: {len(cands)} "
                  f"shapes against the plain version, worst error / "
                  f"tolerance {worst:.4f}, disagreeing {bad}", flush=True)
            if bad:
                raise AssertionError(f"lm tier tuner: {bad} disagree")


def tier_phase():
    """The serving tier on ``qwen2-1.5b-gspn`` ``full()`` (and ``qwen2-1.5b``
    for the prefix cache over KV caches), seeded weights, own policy,
    chunks of 1024: (a) the prefix cache cold vs warm, (b) replicas behind
    the router, (c) a replica's failure, (d) the tuner's seed cache.
    Returns the single engine's launches of #1 by shape."""
    from repro_torch.configs import qwen2_1_5b, qwen2_1_5b_gspn
    from repro_torch.models import lm

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = qwen2_1_5b_gspn.full()
    model = lm.LM(cfg, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(0))
    _tier_prefix("gspn", model, cfg, TIER_PREFIX + SERVE_CHUNK + SERVE_NEW)
    print(f"lm tier (a) gspn {time.perf_counter() - t0:.3f} s", flush=True)
    del model
    t0 = time.perf_counter()
    # (b), (c) run a quarter of the depth: the replicas' runs are host-bound
    # and took 110-168 s at 28 layers (PERF.md §4).
    cfg = dataclasses.replace(cfg, unit=(("gspn", TIER_LAYERS),),
                              n_layers=TIER_LAYERS)
    model = lm.LM(cfg, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(0))
    shapes = _tier_replicas(model, cfg)
    print(f"lm tier (b), (c) at {TIER_LAYERS} of 28 layers "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    del model
    t0 = time.perf_counter()
    cfg = qwen2_1_5b.full()
    model = lm.LM(cfg, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(0))
    _tier_prefix("attn", model, cfg, TIER_PREFIX + SERVE_CHUNK + SERVE_NEW)
    del model
    print(f"lm tier (a) attn {time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    _tier_tuner()
    print(f"lm tier (d) {time.perf_counter() - t0:.3f} s; peak memory of the "
          f"phase {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
          flush=True)
    return shapes


# ---------------------------------------------------------------------------
# Sequence parallelism of the scan (parallel/gspn_sp.py).
# ---------------------------------------------------------------------------

# Kernel level: the blocks of each run, GSPN-2-T's widths at batch 64 (G =
# 128, cpw 2; N = 56 and 7) and the LM mixer's two passes at one chip's
# share of train_4k (G = 16, cpw 8: 4 rows of 1024, 1024 rows of 4).
SP_KS = (2, 4)
SP_WIDTHS = (56, 7)
SP_LM_SHAPES = ((16, 4, 1024, 8), (16, 1024, 4, 8))
# The kernels of the sharded path, each launched under sp_block_local.
SP_KERNELS = ("gspn_scan_fwd", "gspn_scan_bwd", "gspn_pair_fwd",
              "gspn_pair_bwd")
# Full width: the serve launcher's own request stream at these sizes, its
# first 3 requests (4096, 2048 and 1536 prompt tokens; 6 until the lm dp
# phase came, which put the smoke near 1 050 s).
SP_SERVE_ARGS = ("--arch", "qwen2-1.5b-gspn", "--requests", "3",
                 "--prefill-chunk", "1024", "--max-len", "4112",
                 "--max-new", "16")
SP_WORKER_S = 600


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rel_err(got, want) -> float:
    """Largest error over the largest magnitude of ``want``."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def _sync_us(fn, n: int = 10) -> float:
    """Median host-clock µs of ``fn`` between two synchronisations: the
    sharded scan's gloo exchange runs on the host, so CUDA events alone
    would leave it out."""
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times)


def _sp_single_rank():
    """(a) World size 1 over NCCL in this process: the sharded entry
    points are the unsharded kernel call, bit for bit, on #1 and #3."""
    import torch.distributed as dist
    from repro_torch.kernels import cuda_lib, ops
    from repro_torch.launch import mesh as lmesh
    from repro_torch.parallel import gspn_sp as sp

    backend = lmesh.backend_for(torch.device("cuda"), 1)
    torch.cuda.set_device(0)
    dist.init_process_group(backend, rank=0, world_size=1,
                            init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        mesh = lmesh.make_sp_mesh(1)
        gen = torch.Generator(device="cuda").manual_seed(7)
        a = _scan_inputs(gen, 128, 56, 56, 2, torch.float32, False)
        p = _scan_inputs(gen, 128, 56, 56, 2, torch.float32, True)
        torch.cuda.synchronize()
        cuda_lib.clear_counts()
        got = (sp.gspn_scan_sp(*a, mesh=mesh),
               sp.gspn_scan_sp_pair(*p, mesh=mesh))
        torch.cuda.synchronize()
        launches = dict(cuda_lib.launch_counts)
        plain = sum(cuda_lib.plain_calls.values())
        want = (ops.gspn_scan(*a), ops.gspn_scan_pair(*p))
        equal = [torch.equal(g, w) for g, w in zip(got, want)]
    finally:
        dist.destroy_process_group()
    print(f"sp (a) world size 1 over {backend}: gspn_scan_sp and "
          f"gspn_scan_sp_pair at G=128 N=56 cpw 2 f32 bit-equal to the "
          f"unsharded call {equal}; launches {launches}, plain scan calls "
          f"{plain}", flush=True)
    if not all(equal) or plain or launches != {"gspn_scan_fwd": 1,
                                               "gspn_pair_fwd": 1}:
        raise AssertionError("sp (a): world size 1 is not the kernel call")


def _run_ranks(argv, k: int, tag: str, env=None) -> list:
    """Run ``argv`` in ``k`` processes started as torchrun starts ranks;
    print rank 0's output; every rank must exit 0.  Returns the ranks'
    outputs."""
    base = dict(os.environ, WORLD_SIZE=str(k), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(_free_port()),
                PYTHONPATH=str(ROOT / "src"), **(env or {}))
    log_dir = ROOT / "build" / "ranks"
    log_dir.mkdir(parents=True, exist_ok=True)
    paths = [log_dir / f"{tag.replace(' ', '_')}_{r}_of_{k}.log"
             for r in range(k)]
    files = [open(path, "w") for path in paths]
    procs = [subprocess.Popen(
        [sys.executable, *argv], cwd=ROOT,
        env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=f, stderr=subprocess.STDOUT, text=True)
        for r, f in enumerate(files)]
    t_end = time.monotonic() + SP_WORKER_S
    try:
        for p in procs:
            try:
                p.wait(timeout=max(t_end - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    logs = [path.read_text() for path in paths]
    print("\n".join(line for line in logs[0].splitlines()
                    if "socket.cpp" not in line), flush=True)
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    for r, _ in bad[:2]:
        print(f"{tag} rank {r} of {k}:\n{logs[r][-4000:]}", flush=True)
    if bad:
        raise AssertionError(f"{tag} K={k}: ranks failed {bad}")
    return logs


def _spawn_ranks(mode: str, k: int, out: pathlib.Path, env=None,
                 worker: str = "sp_worker") -> dict:
    """Run ``worker(mode, out)`` of this module in ``k`` ranks
    (:func:`_run_ranks`).  Returns what rank 0 wrote."""
    code = f"import chip_smoke; chip_smoke.{worker}({mode!r}, {str(out)!r})"
    _run_ranks(["-c", code], k, f"{worker[:-7]} {mode}", env)
    return json.loads(out.read_text())


def _sp_case(name, fn, ref, args, dtype, dy_gen, expect):
    """One sharded call against the unsharded kernel call: the forward,
    the gradients under a random cotangent, and the exchange collectives
    of the forward alone and of forward and backward, which must count
    ``expect`` (two dicts, kind -> calls)."""
    from repro_torch.parallel import gspn_sp as sp
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    with torch.no_grad():
        out, fwd_tape = sp.collectives(fn, *args)
    want = ref(*args)
    dy = torch.randn(want.shape, generator=dy_gen, device="cuda").to(dtype)
    args = [a.detach().requires_grad_() for a in args]
    grads, grad_tape = sp.collectives(
        lambda: torch.autograd.grad(fn(*args), args, dy))
    want_grads = torch.autograd.grad(ref(*args), args, dy)
    errs = [_rel_err(out, want)] + [_rel_err(g, w)
                                     for g, w in zip(grads, want_grads)]
    tapes = [dict(collections.Counter(c[0] for c in tape
                                      if c[0] != "assemble"))
             for tape in (fwd_tape, grad_tape)]
    finite = all(bool(torch.isfinite(t).all()) for t in (out, *grads))
    return {"case": name, "dtype": str(dtype).removeprefix("torch."),
            "err_fwd": errs[0], "err_grad": max(errs[1:]), "fwd": tapes[0],
            "grad": tapes[1],
            "ok": max(errs) <= tol and finite and tapes == list(expect)}


def _sp_kernel_cases(k: int) -> dict:
    """(b) The kernel level on K ranks: every case against the unsharded
    kernel call, the collectives, the launches' boundary label, and the
    µs of the sharded and unsharded scans with the operators' share."""
    from repro_torch.core.gspn import DIRECTIONS, directional_scan
    from repro_torch.kernels import cuda_lib, ops
    from repro_torch.launch.mesh import make_sp_mesh
    from repro_torch.parallel import gspn_sp as sp

    mesh = make_sp_mesh(k)
    ag, pp = "all_gather", "ppermute"
    # Exchange collectives forward, and forward with backward: a fused
    # pair gathers once each way; a direction's chain makes K-1 hops each
    # way and one fetch of the neighbour's tap row; a direction's gather
    # takes operator and boundary.
    expect = {"auto": ({ag: 2}, {ag: 4}),
              "ppermute": ({pp: 4 * (k - 1)}, {pp: 4 * (2 * k - 1)}),
              "allgather": ({ag: 8}, {ag: 16, pp: 4}),
              "pair": ({ag: 1}, {ag: 2}),
              "single auto": ({pp: k - 1}, {pp: 2 * k - 1}),
              "single allgather": ({ag: 2}, {ag: 4, pp: 1})}
    gen = torch.Generator(device="cuda").manual_seed(11)
    dy_gen = torch.Generator(device="cuda").manual_seed(12)
    rows = []
    torch.cuda.synchronize()
    cuda_lib.clear_counts()
    for dtype in (torch.float32, torch.bfloat16):
        for n in SP_WIDTHS:
            a = _scan_inputs(gen, 128, n, n, 2, dtype, False, ndir=4)
            for s in ("auto", "ppermute", "allgather"):
                rows.append(_sp_case(
                    f"4 directions N={n} {s}",
                    lambda *x, s=s: directional_scan(
                        *x, DIRECTIONS, impl="sp", mesh=mesh,
                        sp_strategy=s),
                    lambda *x: directional_scan(*x, DIRECTIONS), a, dtype,
                    dy_gen, expect[s]))
        p = _scan_inputs(gen, 128, 56, 56, 2, dtype, True)
        for m in ("overlap", "serial"):
            rows.append(_sp_case(
                f"pair N=56 {m}", lambda *x, m=m: sp.gspn_scan_sp_pair(
                    *x, mesh=mesh, exchange_mode=m),
                ops.gspn_scan_pair, p, dtype, dy_gen, expect["pair"]))
        with torch.no_grad():
            skip, tape = sp.collectives(sp.gspn_scan_sp_pair, *p, mesh=mesh,
                                        exchange_mode="skip")
        if [c for c in tape if c[0] != "assemble"] or \
                _rel_err(skip, ops.gspn_scan_pair(*p)) < 1e-3:
            raise AssertionError("sp skip: an exchange, or no error")
        for g, h, w, cpw in SP_LM_SHAPES:
            a = _scan_inputs(gen, g, h, w, cpw, dtype, False)
            for s in ("auto", "allgather"):
                rows.append(_sp_case(
                    f"single G={g} H={h} W={w} {s}",
                    lambda *x, s=s: sp.gspn_scan_sp(*x, mesh=mesh,
                                                    strategy=s),
                    ops.gspn_scan, a, dtype, dy_gen, expect["single " + s]))
    torch.cuda.synchronize()
    bnd = {name: cuda_lib.launch_boundaries[(name, sp.BOUNDARY)]
           for name in SP_KERNELS}
    plain = sum(cuda_lib.plain_calls.values())
    times = _sp_times(mesh, k, gen)
    return {"rows": rows, "sp_block_local": bnd, "plain_calls": plain,
            "times": times}


def _sp_times(mesh, k: int, gen) -> list:
    """µs of one forward, sharded and unsharded, and of the block-local
    operators alone on this rank's block (their share of the sharded
    call), f32: the fused pair at N = 56 and N = 7 (boundary states and
    corrections of both directions) and the LM passes (transfer operator
    and correction of the chain)."""
    from repro_torch.kernels import ops
    from repro_torch.parallel import gspn_sp as sp

    def block(a, lead):
        hb = -(-a.shape[lead + 1] // k)
        return a.narrow(lead + 1, 0, hb).contiguous()

    out = []
    with torch.no_grad():
        for n in SP_WIDTHS:
            x, wl2, wc2, wr2, lam2 = p = _scan_inputs(
                gen, 128, n, n, 2, torch.float32, True)
            bl = [block(x, 0)] + [block(t, 1) for t in (wl2, wc2, wr2, lam2)]

            def ops_pair():
                xb, wlb, wcb, wrb, lb = bl
                for d in (0, 1):
                    sp.block_boundary_states(xb, wlb[d], wcb[d], wrb[d],
                                             lb[d], reverse=d == 1)
                    sp.propagate_boundary(xb[:, 0], wlb[d], wcb[d], wrb[d],
                                          reverse=d == 1)
            out.append(("pair", (128, n, n), _sync_us(
                lambda: sp.gspn_scan_sp_pair(*p, mesh=mesh)),
                _sync_us(lambda: ops.gspn_scan_pair(*p)),
                _sync_us(ops_pair)))
        for g, h, w, cpw in SP_LM_SHAPES:
            a = _scan_inputs(gen, g, h, w, cpw, torch.float32, False)
            bl = [block(t, 0) for t in a]

            def ops_single():
                sp.block_transfer_operator(*bl[1:4])
                sp.propagate_boundary(bl[0][:, 0], *bl[1:4])
            out.append(("single", (g, h, w), _sync_us(
                lambda: sp.gspn_scan_sp(*a, mesh=mesh)),
                _sync_us(lambda: ops.gspn_scan(*a)), _sync_us(ops_single)))
    return out


def _sp_full() -> dict:
    """(c) K = 2 at full width: GSPN-2-T's forward and one AdamW step, and
    the qwen2-1.5b-gspn first prefill over a bf16 wire, each against the
    unsharded model on the same weights; then the serve launcher with
    --seq-parallel 2 on a fresh group."""
    import torch.distributed as dist
    from repro_torch.configs.base import with_precision
    from repro_torch.configs.gspn2_vision import GSPN2_T
    from repro_torch.configs.qwen2_1_5b_gspn import full
    from repro_torch.data.pipeline import DataConfig, synth_images
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_sp_mesh
    from repro_torch.models import lm
    from repro_torch.models.vision import (GSPNVision, apply_vision,
                                           vision_loss)
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    from repro_torch.parallel import gspn_sp as sp

    res = {}
    ctx = lm.Ctx(mesh=make_sp_mesh(2))
    cfg = dataclasses.replace(GSPN2_T, impl="sp")
    model = GSPNVision(cfg, device="cuda",
                       generator=torch.Generator().manual_seed(0))
    plain = GSPNVision(GSPN2_T, device="meta")
    plain.load_state_dict(model.state_dict(), assign=True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in synth_images(
        DataConfig(1, 1, BATCH, seed=0), 0, cfg.img_size,
        cfg.n_classes).items()}
    torch.cuda.synchronize()
    cuda_lib.clear_counts()
    logits, tape = sp.collectives(apply_vision, model, batch["images"],
                                  ctx=ctx)
    torch.cuda.synchronize()
    res["vision_fwd_launches"] = dict(cuda_lib.launch_counts)
    res["vision_fwd_gathers"] = sum(c[0] == "all_gather" for c in tape)
    res["vision_logits_err"] = _rel_err(logits,
                                        apply_vision(plain, batch["images"]))
    params = dict(model.named_parameters())

    def loss_and_grads(m, c):
        loss, _ = vision_loss(m, batch, ctx=c)
        return loss, torch.autograd.grad(loss, list(m.parameters()))
    loss, grads = loss_and_grads(model, ctx)
    want_loss, want = loss_and_grads(plain, None)
    res["vision_loss"] = [loss.item(), want_loss.item()]
    errs = {n: _rel_err(g, w) for n, g, w in zip(params, grads, want)}
    res["vision_grad_worst"] = max(errs.items(), key=lambda kv: kv[1])
    del want
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=60,
                       weight_decay=0.01)
    opt = adamw_init(ocfg, params)

    def step():
        loss, grads = loss_and_grads(model, ctx)
        adamw_update(ocfg, dict(zip(params, grads)), opt, params)
        return loss
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    after = step()
    torch.cuda.synchronize()
    res["vision_step_ms"] = (time.perf_counter() - t0) * 1e3
    res["vision_step_loss"] = after.item()
    res["vision_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["vision_plain_step_ms"] = _sync_us(
        lambda: loss_and_grads(plain, None), n=3) / 1e3
    del model, plain, grads, opt, params, logits
    torch.cuda.empty_cache()

    # The first prefill of a 4096-token prompt, sharded against unsharded
    # on the same weights: under the f32 policy and under the config's
    # own (bf16 products), each with the policy's wire (the mixer's f32
    # compute dtype) and a bf16 wire; under the own policy also the
    # unsharded plain scans against the unsharded kernels, a control of
    # what any other f32 rounding order does through 28 bf16 blocks.
    own = full()
    base = lm.LM(own, device="cuda",
                 generator=torch.Generator(device="cuda").manual_seed(0))
    state = base.state_dict()
    prompt = torch.randint(0, own.vocab, (1, SERVE_PROMPTS[0]),
                           generator=torch.Generator().manual_seed(1)).cuda()

    def prefill(cfg, wire=None, sharded=True):
        m = lm.LM(cfg, device="meta")
        m.load_state_dict(state, assign=True)
        if wire is not None:
            for _, _, blk in m.walk():
                blk.mix.cfg = dataclasses.replace(blk.mix.cfg,
                                                  boundary_dtype=wire)
        with torch.no_grad():
            return lm.lm_prefill(m, prompt, SERVE_PROMPTS[0],
                                 ctx=ctx if sharded else None)[0].float()

    def rel_l2(got, want):
        return ((got - want).norm() / want.norm()).item()

    for policy, cfg in (("f32", with_precision(own, "f32")), ("own", own)):
        want = prefill(cfg, sharded=False)
        sp_cfg = dataclasses.replace(cfg, gspn_impl="sp")
        got = prefill(sp_cfg)
        res[f"lm_{policy}"] = {"f32_wire": rel_l2(got, want),
                               "f32_wire_max": _rel_err(got, want)}
        del got
        res[f"lm_{policy}"]["bf16_wire"] = rel_l2(
            prefill(sp_cfg, wire=torch.bfloat16), want)
        if policy == "own":
            res["lm_own"]["plain_control"] = rel_l2(prefill(
                dataclasses.replace(cfg, gspn_impl="torch"), sharded=False),
                want)
        del want
    del base, state
    torch.cuda.empty_cache()
    dist.destroy_process_group()

    # The serve launcher, as torchrun starts it, on a group of its own.
    os.environ["MASTER_PORT"] = os.environ["SP_SERVE_PORT"]
    torch.cuda.reset_peak_memory_stats()
    results = serve.main([*SP_SERVE_ARGS, "--precision", "f32",
                          "--seq-parallel", "2"])
    res["serve_tokens"] = [[int(t) for t in r.tokens] for r in results]
    res["serve_ttft_ms"] = [r.ttft * 1e3 for r in results]
    res["serve_launches"] = dict(cuda_lib.launch_counts)
    res["serve_sp_block_local"] = cuda_lib.launch_boundaries[
        ("gspn_scan_fwd", sp.BOUNDARY)]
    res["serve_plain_calls"] = sum(cuda_lib.plain_calls.values())
    res["serve_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return res


def sp_worker(mode: str, out: str) -> None:
    """One rank of the sp phase, started by :func:`_spawn_ranks`: joins the
    group torchrun's environment describes (gloo, the ranks sharing one
    card), runs ``mode`` ("kernels" or "full") and on rank 0 writes the
    result to ``out``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    init_distributed(torch.device("cuda"))
    rank, k = dist.get_rank(), dist.get_world_size()
    res = _sp_kernel_cases(k) if mode == "kernels" else _sp_full()
    if dist.is_initialized():
        dist.destroy_process_group()
    if rank == 0:
        pathlib.Path(out).write_text(json.dumps(res))


def sp_phase():
    """Sequence parallelism of the scan: (a) world size 1 over NCCL; (b)
    the kernel level on K = 2 and 4 ranks sharing the card over gloo; (c)
    K = 2 at full width, vision and LM serving."""
    from repro_torch.configs.gspn2_vision import GSPN2_T
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import serve

    _sp_single_rank()
    torch.cuda.empty_cache()
    out_dir = ROOT / "build" / "sp"
    out_dir.mkdir(parents=True, exist_ok=True)
    for k in SP_KS:
        t0 = time.perf_counter()
        res = _spawn_ranks("kernels", k, out_dir / f"kernels{k}.json")
        for r in res["rows"]:
            print(f"sp (b) K={k} {r['case']} {r['dtype']}: forward "
                  f"{r['err_fwd']:.3e}, gradients {r['err_grad']:.3e} of the "
                  f"largest magnitude; exchange collectives forward "
                  f"{r['fwd']}, with the gradient {r['grad']}", flush=True)
        for kind, shape, sharded, unsharded, opus in res["times"]:
            print(f"sp (b) K={k} {kind} {tuple(shape)} f32 forward: sharded "
                  f"{sharded:.1f} us, unsharded {unsharded:.1f} us, the "
                  f"block-local operators alone {opus:.1f} us "
                  f"({opus / sharded:.2f} of the sharded call)", flush=True)
        print(f"sp (b) K={k}: sp_block_local launches {res['sp_block_local']}"
              f", plain scan calls {res['plain_calls']}; "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        bad = [r["case"] + " " + r["dtype"] for r in res["rows"]
               if not r["ok"]]
        if bad or res["plain_calls"] or \
                not all(res["sp_block_local"].values()):
            raise AssertionError(f"sp (b) K={k}: {bad}")

    # (c): the unsharded launcher here, then two ranks.
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.clear_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        want = serve.main([*SP_SERVE_ARGS, "--precision", "f32"])
    report = buf.getvalue()
    print(report, end="", flush=True)
    want_launches = dict(cuda_lib.launch_counts)
    want_tokens = [[int(t) for t in r.tokens] for r in want]
    want_ttft = [r.ttft * 1e3 for r in want]
    del want
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = _spawn_ranks("full", 2, out_dir / "full.json",
                       env={"SP_SERVE_PORT": str(_free_port())})
    loss, want_loss = res["vision_loss"]
    rel = abs(loss - want_loss) / abs(want_loss)
    worst, worst_err = res["vision_grad_worst"]
    print(f"sp (c) GSPN-2-T batch {BATCH} at 224^2 f32 over 2 ranks: "
          f"logits {res['vision_logits_err']:.3e} of the largest (tol "
          f"1e-4), {res['vision_fwd_gathers']} exchange gathers and "
          f"launches {res['vision_fwd_launches']} in the forward; loss "
          f"{loss} vs {want_loss} (relative {rel:.3e}, tol 1e-5); worst "
          f"gradient {worst} at {worst_err:.3e} of its largest (tol 1e-4); "
          f"one AdamW step {res['vision_step_ms']:.1f} ms (loss after "
          f"{res['vision_step_loss']}), unsharded loss and gradients "
          f"{res['vision_plain_step_ms']:.1f} ms, peak memory "
          f"{res['vision_peak_gib']:.2f} GiB a rank", flush=True)
    f32, own = res["lm_f32"], res["lm_own"]
    print(f"sp (c) qwen2-1.5b-gspn first prefill of {SERVE_PROMPTS[0]} "
          f"tokens, sharded against unsharded logits: f32 policy, f32 "
          f"wire {f32['f32_wire_max']:.3e} of the largest (tol 1e-4), "
          f"relative L2 {f32['f32_wire']:.3e}; f32 policy, bf16 wire "
          f"relative L2 {f32['bf16_wire']:.3e} (tol 1e-2); own policy "
          f"(measured, not held): f32 wire {own['f32_wire']:.3e}, bf16 "
          f"wire {own['bf16_wire']:.3e}, and the unsharded plain scans "
          f"against the unsharded kernels {own['plain_control']:.3e}",
          flush=True)
    rate = re.findall(r"([0-9.]+) tok/s", report)
    print(f"sp (c) serve --seq-parallel 2 (f32): tokens equal the unsharded "
          f"launcher's {res['serve_tokens'] == want_tokens}; TTFT ms "
          f"{[round(t, 1) for t in res['serve_ttft_ms']]} vs unsharded "
          f"{[round(t, 1) for t in want_ttft]}; unsharded {rate} tok/s; "
          f"#1 launches a rank {res['serve_launches']} "
          f"({res['serve_sp_block_local']} under sp_block_local) vs "
          f"unsharded {want_launches}, plain scan calls "
          f"{res['serve_plain_calls']}, peak memory "
          f"{res['serve_peak_gib']:.2f} GiB a rank; "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    if not (res["vision_logits_err"] <= 1e-4 and rel <= 1e-5
            and worst_err <= 1e-4
            and res["vision_fwd_gathers"] == 2 * sum(GSPN2_T.depths)
            and math.isfinite(res["vision_step_loss"])):
        raise AssertionError("sp (c): the sharded GSPN-2-T disagrees")
    if not (f32["f32_wire_max"] <= 1e-4 and f32["bf16_wire"] <= 1e-2
            and all(map(math.isfinite, own.values()))):
        raise AssertionError("sp (c): the sharded prefill disagrees")
    if res["serve_tokens"] != want_tokens or res["serve_plain_calls"] or \
            res["serve_launches"] != want_launches or \
            res["serve_sp_block_local"] != want_launches["gspn_scan_fwd"]:
        raise AssertionError("sp (c): sharded serving differs")


# Data parallelism (``lm dp ...`` lines): qwen2-1.5b-gspn full() over 2
# gloo ranks that share the card, a global batch of 2 x 4096.
DP_RANKS = 2
DP_SEED = 4
DP_SAMPLES = 64                  # sampled elements of each leaf in (c)
DP_PIPE = (4, 1, 1024)           # microbatches of 1 x 1024 tokens
# (d) saves and restores the leaves of the first DP_CKPT_BLOCKS of the 28
# blocks and every leaf outside the blocks (the embedding, the final
# norm): each kind of leaf, sharded over data or replicated, its
# parameter, moments and residual, in about a quarter of the whole
# state's bytes, whose save and restore took most of a minute (PERF.md
# §4).
DP_CKPT_BLOCKS = 2


def _dp_cfg():
    """The f32 policy of ``full()`` under remat "unit": (c) holds the
    sharded step to the one-rank step with the f32 bounds."""
    from repro_torch.configs.base import with_precision
    from repro_torch.configs.qwen2_1_5b_gspn import full
    return dataclasses.replace(with_precision(full(), "f32"), remat="unit")


def _dp_opt():
    from repro_torch.optim.adamw import AdamWConfig
    return AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=100)


def _dp_batch(cfg, n_hosts=1, host_id=0):
    from repro_torch.data.pipeline import DataConfig, host_batch, to_device
    return to_device(host_batch(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        n_hosts=n_hosts, host_id=host_id), 0), "cuda")


def _dp_reference(path: pathlib.Path) -> dict:
    """The one-rank side, in this process: the seeded model's leaf sums,
    a counted loss and gradients at 1 x 4096 (a rank's share), then one
    AdamW step at 2 x 4096 with its loss, gradient norm and, per leaf, a
    seeded sample of updated elements with their gradients, both of the
    whole batch and the mean of its two halves' (the sum the two ranks
    make: the noise control of (c)).  Saved to ``path`` for the
    ranks."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import lm
    from repro_torch.optim.adamw import lr_at
    from repro_torch.train.step import make_train_setup

    cfg = _dp_cfg()
    setup = make_train_setup(cfg, _dp_opt(), device="cuda", seed=DP_SEED)
    model = setup.model
    params = dict(model.named_parameters())
    ref = {"sums": {n: p.double().sum().item() for n, p in params.items()},
           "shapes": {n: list(p.shape) for n, p in params.items()}}
    half = {k: v[:1] for k, v in _dp_batch(cfg).items()}
    cuda_lib.clear_counts()
    loss, _ = lm.lm_loss(model, half)
    grads = torch.autograd.grad(loss, list(params.values()))
    torch.cuda.synchronize()
    ref["launches"] = {"/".join(map(str, k)): v for k, v in
                       cuda_lib.launch_shapes.items()}
    ref["plain"] = sum(cuda_lib.plain_calls.values())
    del grads, loss
    batch = _dp_batch(cfg)
    rng = np.random.default_rng(DP_SEED)
    idx = {n: torch.from_numpy(rng.integers(0, p.numel(), DP_SAMPLES)).cuda()
           for n, p in params.items()}
    ref["half_grad"] = {n: torch.zeros(DP_SAMPLES) for n in params}
    for h in range(TRAIN_BATCH):
        loss, _ = lm.lm_loss(model, {k: v[h:h + 1] for k, v in batch.items()})
        for n, g in zip(params, torch.autograd.grad(loss, list(
                params.values()))):
            ref["half_grad"][n] += g.flatten()[idx[n]].cpu() / TRAIN_BATCH
        del loss
    loss, _ = lm.lm_loss(model, batch)
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    ref["grad"] = {n: g.flatten()[idx[n]].cpu() for n, g in grads.items()}
    ref["grad_max"] = {n: g.abs().max().item() for n, g in grads.items()}
    del grads, loss
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metrics = setup.train_step(setup.state, batch)
    torch.cuda.synchronize()
    ref["step_ms"] = (time.perf_counter() - t0) * 1e3
    ref["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    # The noise control of (c): AdamW's first step moves an element by
    # lr * g / (|g| + eps) of its clipped gradient g, so the whole batch's
    # gradient and its halves' mean move it this far apart.
    ocfg = _dp_opt()
    clip = min(1.0, ocfg.grad_clip / max(float(metrics["grad_norm"]), 1e-9))
    lr = float(lr_at(ocfg, 1))

    def moved(g):
        return lr * g * clip / ((g * clip).abs() + ocfg.eps)

    ref["noise"] = {n: (moved(ref["grad"][n]) - moved(ref["half_grad"][n]))
                    .abs() for n in params}
    ref.update(loss=float(metrics["loss"]),
               grad_norm=float(metrics["grad_norm"]),
               idx={n: i.cpu() for n, i in idx.items()},
               value={n: p.detach().flatten()[idx[n]].cpu()
                      for n, p in params.items()},
               value_max={n: p.detach().abs().max().item()
                          for n, p in params.items()})
    del setup, model, params, metrics, _
    gc.collect()
    torch.cuda.empty_cache()
    # (d): the int8_ef step from the same seed on the whole batch.
    setup = make_train_setup(cfg, _dp_opt(), device="cuda", seed=DP_SEED,
                             grad_compression="int8_ef")
    _, metrics = setup.train_step(setup.state, batch)
    params, errors = setup.state["params"], setup.state["errors"]
    ref["int8"] = {
        "loss": float(metrics["loss"]),
        "grad_norm": float(metrics["grad_norm"]),
        "value": {n: p.flatten()[idx[n]].cpu() for n, p in params.items()},
        "value_max": {n: p.abs().max().item() for n, p in params.items()},
        "error": {n: e.flatten()[idx[n]].cpu() for n, e in errors.items()},
        "error_max": {n: e.abs().max().item() for n, e in errors.items()}}
    del setup, params, errors, metrics, _
    gc.collect()
    torch.cuda.empty_cache()
    torch.save(ref, path)
    return ref


def _dp_local(local, placement, idx):
    """(which sampled flat indices of the global leaf this rank holds,
    their flat indices in its local tensor)."""
    shape = list(local.shape)
    if placement is None:
        return torch.ones_like(idx, dtype=torch.bool), idx
    dim, parts, index = placement
    shape[dim] *= parts
    coords = np.unravel_index(idx.numpy(), shape)
    lo = index * local.shape[dim]
    mine = (coords[dim] >= lo) & (coords[dim] < lo + local.shape[dim])
    coords = [c[mine] for c in coords]
    coords[dim] = coords[dim] - lo
    flat = np.ravel_multi_index(coords, local.shape) if mine.any() else \
        np.zeros(0, np.int64)
    return torch.from_numpy(mine), torch.from_numpy(np.asarray(flat))


def _dp_placements(setup, ref, rank):
    """(a): local shapes as the specs say, for parameters, moments and
    int8 residuals; leaf sums against the one-rank model's (the shards'
    sums over the ranks; a replicated leaf's on every rank); bytes."""
    import torch.distributed as dist
    from repro_torch.parallel.sharding import sharded_dim
    from repro_torch.train.step import init_train_state

    errors = init_train_state(setup.model, _dp_opt(),
                              grad_compression="int8_ef")["errors"]
    bad = []
    for n, p in setup.state["params"].items():
        want = list(ref["shapes"][n])
        d = sharded_dim(setup.param_specs[n], "data")
        if d is not None:
            want[d[0]] //= DP_RANKS
        for what, t in (("params", p), ("m", setup.state["opt"]["m"][n]),
                        ("v", setup.state["opt"]["v"][n]),
                        ("errors", errors[n])):
            if list(t.shape) != want:
                bad.append(f"{what}/{n} {list(t.shape)} != {want}")
    names = sorted(setup.state["params"])
    sums = torch.tensor([setup.state["params"][n].double().sum().item()
                         for n in names], dtype=torch.float64)
    every = [torch.empty_like(sums) for _ in range(DP_RANKS)]
    dist.all_gather(every, sums)
    seed_bad = []
    for i, n in enumerate(names):
        want = ref["sums"][n]
        if f"params/{n}" in setup.state_placements:
            got = sum(e[i].item() for e in every)
        else:
            got = every[0][i].item()
            if any(e[i].item() != got for e in every):
                seed_bad.append(f"{n}: replicas differ")
        if abs(got - want) > 1e-9 * max(abs(want), 1.0):
            seed_bad.append(f"{n}: {got} != {want}")

    def nbytes(d):
        return sum(t.numel() * t.element_size() for t in d.values())

    full = sum(math.prod(s) for s in ref["shapes"].values()) * 4
    out = {"bad": bad, "seed_bad": seed_bad,
           "n_sharded": sum(1 for k in setup.state_placements
                            if k.startswith("params/")),
           "n_params": len(names),
           "bytes": {"params": nbytes(setup.state["params"]),
                     "moments": nbytes(setup.state["opt"]["m"])
                     + nbytes(setup.state["opt"]["v"]),
                     "errors": nbytes(errors)},
           "one_rank_bytes": {"params": full, "moments": 2 * full,
                              "errors": full}}
    del errors
    return out


def _dp_step(setup, ref, rank, note):
    """(b) and (c): the first step from the seed, counted and timed with
    its collectives, against the one-rank step."""
    import torch.distributed as dist
    from repro_torch.kernels import cuda_lib
    from repro_torch.parallel import collectives

    batch = _dp_batch(_dp_cfg(), DP_RANKS, rank)
    cuda_lib.clear_counts()
    collectives.clear_staged()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metrics = setup.train_step(setup.state, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = {"step0": {
        "ms": dt * 1e3, "loss": float(metrics["loss"]),
        "grad_norm": float(metrics["grad_norm"]),
        "launches": {"/".join(map(str, k)): v for k, v in
                     cuda_lib.launch_shapes.items()},
        "plain": sum(cuda_lib.plain_calls.values()),
        "staged_bytes": dict(collectives.staged_bytes),
        "link_bytes": dict(collectives.link_bytes),
        "collective_s": dict(collectives.staged_seconds)}}
    note(f"step, {dt * 1e3:.1f} ms, counted collectives "
         f"{dict(collectives.staged_seconds)} s")
    # An element may be off where its gradient is under 1e-5 of its
    # leaf's largest, or by up to four times the distance AdamW's first
    # step puts between it under the whole batch's gradient and under the
    # mean of its halves' (the ranks' sum) on the one rank itself: the
    # noise control.  A replicated leaf is checked on rank 0.
    counts = torch.zeros(4, dtype=torch.float64)
    worst = []
    for name, p in setup.state["params"].items():
        placement = setup.state_placements.get(f"params/{name}")
        if placement is None and rank:
            continue
        mine, flat = _dp_local(p, placement, ref["idx"][name])
        got = p.detach().flatten()[flat.cuda()].cpu()
        want = ref["value"][name][mine]
        g = ref["grad"][name][mine]
        off = (got - want).abs() > 1e-5 * ref["value_max"][name]
        floor = g.abs() <= 1e-5 * ref["grad_max"][name]
        noise = (got - want).abs() <= 1e-5 * ref["value_max"][name] \
            + 4 * ref["noise"][name][mine]
        bad = off & ~floor & ~noise
        counts += torch.tensor([float(mine.sum()), float(off.sum()),
                                float((off & ~floor & noise).sum()),
                                float(bad.sum())], dtype=torch.float64)
        for k in torch.nonzero(bad).flatten().tolist()[:2]:
            worst.append((name, float(got[k] - want[k]),
                          float(g[k]) / ref["grad_max"][name]))
    dist.all_reduce(counts)
    (out["sampled"], out["sample_off"], out["sample_noise"],
     out["sample_bad"]) = map(int, counts.tolist())
    out["sample_worst"] = worst[:6]
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def _digest(t) -> tuple:
    """Two integer sums of a tensor's bits (the plain sum and one weighted
    by position): equal for equal tensors, and a zeroed tensor restored
    from a checkpoint gives them back only if its bits came back."""
    v = t.detach().reshape(-1)
    if v.dtype == torch.float32:
        v = v.view(torch.int32)
    v = v.long()
    w = torch.arange(v.numel(), device=v.device) % 65521 + 1
    return int(v.sum()), int((v * w).sum())


def _depth_cut(state, blocks: int):
    """``state``'s nested dicts with the leaves of the blocks from
    ``blocks`` on left out (a parameter's name ``stages.<stage>.<unit>.
    <block>. ...``); every other leaf stays."""
    def keep(name):
        m = re.match(r"stages\.[^.]+\.\d+\.(\d+)\.", name)
        return m is None or int(m.group(1)) < blocks

    return {k: _depth_cut(v, blocks) if isinstance(v, dict) else v
            for k, v in state.items() if isinstance(v, dict) or keep(k)}


def _dp_int8(ref, rank, mesh, ckpt, note):
    """(d): the first int8_ef step from the seed on the (2, 1) mesh,
    counted, against the one-rank int8_ef step; then its FSDP-placed
    state (parameters, moments, int8 residuals) cut to DP_CKPT_BLOCKS
    blocks, saved by both ranks, overwritten with zeros and restored:
    every leaf bit for bit."""
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import CheckpointManager, flatten
    from repro_torch.kernels import cuda_lib
    from repro_torch.train.step import make_train_setup

    setup = make_train_setup(_dp_cfg(), _dp_opt(), mesh=mesh, device="cuda",
                             seed=DP_SEED, grad_compression="int8_ef")
    batch = _dp_batch(_dp_cfg(), DP_RANKS, rank)
    cuda_lib.clear_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metrics = setup.train_step(setup.state, batch)
    torch.cuda.synchronize()
    out = {"ms": (time.perf_counter() - t0) * 1e3,
           "loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"]),
           "launches": {"/".join(map(str, k)): v for k, v in
                        cuda_lib.launch_shapes.items()},
           "plain": sum(cuda_lib.plain_calls.values())}
    note(f"int8_ef step, {out['ms']:.1f} ms")
    # A residual (the gradient less its quantised value: the residuals
    # start at zero) may differ by more than 1e-5 of its leaf's largest
    # quantised magnitude (254 times the largest residual) by one int8
    # step (at least twice the largest residual), or by up to four times
    # the distance between the one rank's gradient of the whole batch
    # and its halves' mean (the noise control of (c)); a parameter may
    # be off by more than 1e-5 of its leaf's largest only at a step.  A
    # replicated leaf is checked on rank 0.
    r = ref["int8"]
    counts = torch.zeros(5, dtype=torch.float64)
    worst = []
    for name, p in setup.state["params"].items():
        placement = setup.state_placements.get(f"params/{name}")
        if placement is None and rank:
            continue
        mine, flat = _dp_local(p, placement, ref["idx"][name])
        flat = flat.cuda()
        e = setup.state["errors"][name].flatten()[flat].cpu()
        d = (e - r["error"][name][mine]).abs()
        emax = r["error_max"][name]
        tol = 1e-5 * 254 * emax
        off_e = d > tol
        flip = off_e & (d >= 1.9 * emax)
        noise = off_e & ~flip & (d <= tol + 4 * (
            ref["grad"][name][mine] - ref["half_grad"][name][mine]).abs())
        got = p.detach().flatten()[flat].cpu()
        off = (got - r["value"][name][mine]).abs() > 1e-5 * r["value_max"][
            name]
        bad = (off_e & ~flip & ~noise) | (off & ~flip)
        counts += torch.tensor([float(mine.sum()), float(flip.sum()),
                                float(noise.sum()), float(off.sum()),
                                float(bad.sum())], dtype=torch.float64)
        for k in torch.nonzero(bad).flatten().tolist()[:2]:
            worst.append((name, float(d[k]), emax))
    dist.all_reduce(counts)
    (out["sampled"], out["flips"], out["noise"], out["off"],
     out["bad"]) = map(int, counts.tolist())
    out["worst"] = worst[:6]

    state = _depth_cut(setup.state, DP_CKPT_BLOCKS)
    flat_state = {k: t for k, t in flatten(state).items()
                  if isinstance(t, torch.Tensor)}
    out["whole_leaves"] = sum(isinstance(t, torch.Tensor)
                              for t in flatten(setup.state).values())
    before = {k: _digest(t) for k, t in flat_state.items()}
    dist.barrier()
    t0 = time.perf_counter()
    ck = CheckpointManager(str(ckpt), host_id=rank, n_hosts=DP_RANKS)
    ck.save(1, state, placements=setup.state_placements,
            skip=setup.state_skip)
    ck.wait()
    out["save_s"] = time.perf_counter() - t0
    out["bytes"] = sum(f.stat().st_size for f in pathlib.Path(ckpt).rglob(
        "host_*.npz"))
    with torch.no_grad():
        for t in flat_state.values():
            t.zero_()
    t0 = time.perf_counter()
    _, step = CheckpointManager(str(ckpt), host_id=rank,
                                n_hosts=DP_RANKS).restore(
        target=state, placements=setup.state_placements)
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    out["restored_step"] = step
    out["leaves"] = len(before)
    out["restored_equal"] = sum(
        _digest(flat_state[k]) == v for k, v in before.items())
    note("int8_ef checkpoint saved and restored")
    return out


def _dp_pipe(rank):
    """(e): GPipe over the 2 ranks, one full-width GSPN block a stage, 4
    microbatches of 1 x 1024, against the two blocks in sequence."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.mesh import make_mesh_for_devices
    from repro_torch.models.lm import GSPNBlock
    from repro_torch.parallel.pipeline import pipeline_apply

    cfg = _dp_cfg()
    blocks = [GSPNBlock(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(100 + i)) for i in range(DP_RANKS)]
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(*DP_PIPE, cfg.d_model, device="cuda", generator=gen)
    mesh = make_mesh_for_devices(range(DP_RANKS), model_parallel=1,
                                 device_type="cuda")
    with torch.no_grad():
        cuda_lib.clear_counts()
        y = pipeline_apply(mesh, "data", lambda blk, a: blk(a), blocks[rank],
                           x, DP_PIPE[0], via_host=True)
        torch.cuda.synchronize()
        launches = dict(cuda_lib.launch_counts)
        seq = x
        for blk in blocks:
            seq = torch.stack([blk(m) for m in seq])
    return {"err": _rel_err(y, seq), "launches": launches,
            "plain": sum(cuda_lib.plain_calls.values())}


def dp_worker(mode: str, out: str) -> None:
    """One rank of the lm dp phase, started by :func:`_spawn_ranks`: joins
    the gloo group the ranks share, builds the sharded setup from the
    seed, runs (a), (b), (c), (e) and (d), and on rank 0 writes every
    rank's results to ``out``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_mesh_for_devices
    from repro_torch.train.step import make_train_setup
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    init_distributed(torch.device("cuda"))
    rank = dist.get_rank()
    t_start = time.perf_counter()

    def note(what):
        print(f"lm dp rank {rank}: {what} at {time.perf_counter() - t_start:.1f}"
              f" s", flush=True)

    ref = torch.load(pathlib.Path(out).with_name("ref.pt"))
    mesh = make_mesh_for_devices(range(DP_RANKS), model_parallel=1,
                                 device_type="cuda")
    t0 = time.perf_counter()
    setup = make_train_setup(_dp_cfg(), _dp_opt(), mesh=mesh, device="cuda",
                             seed=DP_SEED)
    torch.cuda.synchronize()
    note("setup")
    res = {"setup_s": time.perf_counter() - t0,
           "placements": _dp_placements(setup, ref, rank)}
    note("placements")
    res.update(_dp_step(setup, ref, rank, note))
    del setup
    gc.collect()
    torch.cuda.empty_cache()
    res["pipe"] = _dp_pipe(rank)
    note("pipeline")
    res["int8"] = _dp_int8(ref, rank, mesh, pathlib.Path(out).with_name(
        "ckpt"), note)
    every = [None] * DP_RANKS
    dist.all_gather_object(every, res)
    dist.destroy_process_group()
    if rank == 0:
        pathlib.Path(out).write_text(json.dumps(every))


def dp_phase():
    """Data parallelism at full width on a ("data", "model") mesh of
    (2, 1): (a) placements and the seed, (b) a counted step on each rank,
    (c) that step against the one-rank step, (e) pipeline_apply over the
    2 ranks, (d) the int8_ef step against the one-rank int8_ef step and a
    save and restore of its data-sharded state.  The launcher's
    --distributed, which now builds a model axis, runs in the lm tp
    phase."""
    import shutil

    out_dir = ROOT / "build" / "dp"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).strip()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = _dp_reference(out_dir / "ref.pt")
    print(f"lm dp one rank ({smi}): f32 policy, remat unit, seed {DP_SEED}; "
          f"1 x {TRAIN_SEQ} loss and gradients launch "
          f"{ref['launches']}, plain {ref['plain']}; one AdamW step at "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: loss {ref['loss']:.6f}, grad_norm "
          f"{ref['grad_norm']:.6f}, {ref['step_ms']:.1f} ms, peak "
          f"{ref['peak_gib']:.2f} GiB; {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = _spawn_ranks("step", DP_RANKS, out_dir / "step.json",
                         worker="dp_worker")
    fails = []
    for r, res in enumerate(ranks):
        pl = res["placements"]
        b, one = pl["bytes"], pl["one_rank_bytes"]
        print(f"lm dp (a) rank {r}: setup {res['setup_s']:.1f} s; "
              f"{pl['n_sharded']} of {pl['n_params']} parameters sharded, "
              f"shape faults {pl['bad'][:3]}, seed faults "
              f"{pl['seed_bad'][:3]}; bytes a rank: parameters "
              f"{b['params']} (one rank {one['params']}), moments "
              f"{b['moments']} ({one['moments']}), int8 residuals "
              f"{b['errors']} ({one['errors']})", flush=True)
        if pl["bad"] or pl["seed_bad"]:
            fails.append(f"(a) rank {r}")
        s0 = res["step0"]
        print(f"lm dp (b) rank {r}: launches by shape {s0['launches']}, "
              f"plain scan calls {s0['plain']} (one rank at 1 x "
              f"{TRAIN_SEQ}: {ref['launches']})", flush=True)
        if s0["launches"] != ref["launches"] or s0["plain"]:
            fails.append(f"(b) rank {r}")
        coll = sum(s0["collective_s"].values()) * 1e3
        by = {k: round(v * 1e3, 1) for k, v in s0["collective_s"].items()}
        print(f"lm dp step rank {r} ({smi}): the first step from the seed "
              f"(FSDP's lazy set-up included) {s0['ms']:.1f} ms, of which "
              f"the counted collectives {coll:.1f} ms "
              f"({coll / s0['ms']:.3f}) {by}, bytes through host memory "
              f"{sum(s0['staged_bytes'].values())} {s0['staged_bytes']}; "
              f"peak memory {res['peak_gib']:.2f} GiB; "
              f"{TRAIN_SEQ / s0['ms'] * 1e3:.1f} tokens/s a rank",
              flush=True)
    s0 = ranks[0]["step0"]
    rel = abs(s0["loss"] - ref["loss"]) / abs(ref["loss"])
    gn = abs(s0["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    r0 = ranks[0]
    print(f"lm dp (c) 2 ranks vs one rank at {TRAIN_BATCH} x {TRAIN_SEQ}: "
          f"loss {s0['loss']:.7f} vs {ref['loss']:.7f} (relative {rel:.3e}, "
          f"tol 1e-5), grad_norm {s0['grad_norm']:.7f} vs "
          f"{ref['grad_norm']:.7f} (relative {gn:.3e}, tol 1e-6); "
          f"of {r0['sampled']} sampled parameter elements "
          f"{r0['sample_off']} off by more than 1e-5 of their leaf's "
          f"largest, {r0['sample_noise']} of them with a gradient above 1e-5 "
          f"of its leaf's largest but within 4x the distance the one "
          f"rank's first step puts between the whole batch's gradient and "
          f"its halves' mean (the noise control), {r0['sample_bad']} "
          f"otherwise (tol 0) "
          f"{r0['sample_worst'] + ranks[1]['sample_worst']}", flush=True)
    if rel > 1e-5 or gn > 1e-6 or r0["sample_bad"] or \
            r0["sampled"] != DP_SAMPLES * len(ref["idx"]):
        fails.append("(c)")
    for r, res in enumerate(ranks):
        p = res["pipe"]
        print(f"lm dp (e) rank {r}: pipeline_apply over {DP_RANKS} stages, "
              f"{DP_PIPE[0]} microbatches of {DP_PIPE[1]} x {DP_PIPE[2]}, "
              f"against the blocks in sequence {p['err']:.3e} of the "
              f"largest (tol 1e-5); launches {p['launches']}, plain "
              f"{p['plain']}", flush=True)
        if p["err"] > 1e-5 or not p["launches"].get("gspn_scan_fwd") or \
                p["plain"]:
            fails.append(f"(e) rank {r}")
    i8 = [res["int8"] for res in ranks]
    one = ref["int8"]
    rel = abs(i8[0]["loss"] - one["loss"]) / abs(one["loss"])
    gn = abs(i8[0]["grad_norm"] - one["grad_norm"]) / one["grad_norm"]
    print(f"lm dp (d) int8_ef, 2 ranks vs one rank at {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} ({smi}): loss {i8[0]['loss']:.7f} vs "
          f"{one['loss']:.7f} (relative {rel:.3e}, tol 1e-5), grad_norm "
          f"{i8[0]['grad_norm']:.7f} vs {one['grad_norm']:.7f} (relative "
          f"{gn:.3e}, tol 1e-5); of {i8[0]['sampled']} sampled elements "
          f"{i8[0]['flips']} residuals one int8 step from the one rank's, "
          f"{i8[0]['noise']} off by more than 1e-5 of their leaf's largest "
          f"quantised magnitude but within 4x the distance between the "
          f"one rank's whole-batch gradient and its halves' mean (the "
          f"noise control), {i8[0]['off']} parameters off by more than "
          f"1e-5 of their leaf's largest, {i8[0]['bad']} otherwise off "
          f"(tol 0) "
          f"{i8[0]['worst'] + i8[1]['worst']}; the step "
          f"{i8[0]['ms']:.1f} / {i8[1]['ms']:.1f} ms, launches by shape "
          f"{i8[0]['launches']}, plain {i8[0]['plain'] + i8[1]['plain']}; "
          f"its state cut to blocks 0-{DP_CKPT_BLOCKS - 1} of 28 and every "
          f"leaf outside the blocks ({i8[0]['leaves']} of "
          f"{i8[0]['whole_leaves']} tensors a rank, {i8[0]['bytes']} "
          f"bytes in the shard files) saved in {i8[0]['save_s']:.1f} s, "
          f"zeroed and restored in {i8[0]['restore_s']:.1f} s: "
          f"{[x['restored_equal'] for x in i8]} of {i8[0]['leaves']} "
          f"tensors bit-equal on each rank", flush=True)
    if rel > 1e-5 or gn > 1e-5 or i8[0]["bad"] or \
            i8[0]["sampled"] != DP_SAMPLES * len(ref["idx"]) or \
            any(x["launches"] != ref["launches"] or x["plain"] or
                x["restored_step"] != 1 or x["restored_equal"] != x["leaves"]
                for x in i8):
        fails.append("(d)")
    shutil.rmtree(out_dir / "ckpt", ignore_errors=True)
    print(f"lm dp ranks: {time.perf_counter() - t0:.1f} s", flush=True)

    if fails:
        raise AssertionError(f"lm dp: {fails}")


# Tensor parallelism (``lm tp ...`` lines): qwen2-1.5b-gspn full() over 2
# gloo ranks that share the card on (data 1, model 2); grok-1-314b cut to
# one attn_moe layer at M = 2 (ep 2, tp 1); the launcher's model axis.
TP_RANKS = 2
TP_SEED = 5
TP_SAMPLES = 64                  # sampled elements of each leaf in (c), (d)
TP_MOE_TOKENS = (1, 256)         # (d): a few hundred tokens
TP_LAUNCH = ("-m", "repro_torch.launch.train", "--distributed", "--arch",
             "qwen2-1.5b-gspn", "--batch", str(TRAIN_BATCH), "--seq",
             str(TRAIN_SEQ))
# (f): the recurrent kinds at full width and SSM_UNITS' depth, f32, remat
# unit, on (data 1, model 2): {arch: the training step's 1 x length}
# (xlstm's sLSTM runs token by token, hence its shorter step), then a
# prefill of TP_REC_PROMPT tokens and TP_REC_DECODE greedy decode steps.
TP_REC = {"zamba2-2.7b": 4096, "xlstm-1.3b": 1024}
TP_REC_PROMPT = 1024
TP_REC_DECODE = 8
# (g): the VL and encoder-decoder families, f32, remat unit, on (data 1,
# model 2): {arch: (sequences, tokens a sequence, layers kept or None:
# all)}.  whisper-base whole, 4 clips of its 1500 frames with 448 tokens
# (its context) a step, then lm_encode, a prefill of TP_XF_PROMPT tokens
# a clip (the start-of-transcript tokens) and TP_REC_DECODE greedy steps
# in a cache of 448; qwen2-vl-72b at full width and 1 of its 80 layers,
# 1 x 2048 tokens, the first TP_XF_VISION of them vision embeddings, in
# the step and in the prompt.
TP_XF = {"whisper-base": (4, 448, None), "qwen2-vl-72b": (1, 2048, 1)}
TP_XF_VISION = 1024
TP_XF_PROMPT = {"whisper-base": 4, "qwen2-vl-72b": 2048}


def _tp_moe_cfg(m):
    """grok-1-314b's full width cut to one attn_moe layer, laid out for m
    model shards, in f32."""
    from repro_torch.configs.base import with_precision
    from repro_torch.configs.grok_1_314b import full
    return with_precision(dataclasses.replace(
        full(m), n_layers=1, unit=(("attn_moe", 1),)), "f32")


def _tp_rec_cfg(arch):
    """(f)'s config: the arch's full width cut to SSM_UNITS' units, the
    f32 policy, remat unit."""
    from repro_torch.configs.base import get_arch, with_precision
    cfg = get_arch(arch).full()
    units = SSM_UNITS[arch]
    return dataclasses.replace(
        with_precision(cfg, "f32"), n_units=units, remat="unit",
        n_layers=cfg.n_layers // cfg.n_units * units)


def _tp_xf_cfg(arch):
    """(g)'s config: the arch's full width, TP_XF's layers, the f32
    policy, remat unit."""
    from repro_torch.configs.base import get_arch, with_precision
    cfg = get_arch(arch).full()
    layers = TP_XF[arch][2]
    if layers:
        cfg = dataclasses.replace(cfg, unit=((cfg.unit[0][0], layers),),
                                  n_layers=layers)
    return dataclasses.replace(with_precision(cfg, "f32"), remat="unit")


def _tp_batch(cfg, seq=TRAIN_SEQ, batch=1, seed=0):
    """The synthetic batch, with TP_XF_VISION vision embeddings for the
    VL family and the encoder's frames for the audio family."""
    from repro_torch.data.pipeline import DataConfig, host_batch, to_device
    return to_device(host_batch(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed,
        vision_len=TP_XF_VISION if cfg.family == "vlm" else 0,
        enc_len=cfg.enc_len if cfg.family == "audio" else 0,
        d_model=cfg.d_model), 0), "cuda")


def _samples(params, grads, rng_seed):
    """Seeded flat indices of each leaf, the gradients there, and each
    gradient's largest magnitude."""
    rng = np.random.default_rng(rng_seed)
    idx = {n: torch.from_numpy(rng.integers(0, p.numel(), TP_SAMPLES))
           for n, p in params.items()}
    return {"idx": idx,
            "grad": {n: g.flatten()[idx[n].cuda()].cpu()
                     for n, g in grads.items()},
            "grad_max": {n: g.abs().max().item() for n, g in grads.items()}}


def _attn_perms(name, mod, kp) -> dict:
    """{leaf: (dim, permutation)} that relabels an attention layer's kv
    heads in the order ``kp``, each kv head's query heads with it: the
    columns of wq, wk, wv (and the biases) and the rows of wo."""
    cfg = mod.cfg
    hd, g = cfg.hd, cfg.n_heads // cfg.n_kv_heads
    qp = (kp[:, None] * g + torch.arange(g, device="cuda")).flatten()

    def cols(hp):
        return (hp[:, None] * hd + torch.arange(hd, device="cuda")).flatten()

    qc, kc = cols(qp), cols(kp)
    p = f"{name}."
    out = {p + "wq": (1, qc), p + "wk": (1, kc), p + "wv": (1, kc),
           p + "wo": (0, qc)}
    if cfg.qkv_bias:
        out.update({p + "bq": (0, qc), p + "bk": (0, kc), p + "bv": (0, kc)})
    return out


def _head_perms(name, mod, gen) -> dict:
    """{leaf: (dim, permutation)} that relabels the heads of a recurrent
    mixer or an attention layer ``mod`` (at module path ``name``) in a
    seeded order: every column, channel, row and vector that belongs to a
    head moves with it; Mamba-2's B and C, shared by the heads, stay.  A
    cross-attention's heads are relabelled in :func:`_tp_reordered`, with
    the encoder's K/V projection.  Empty for another module."""
    from repro_torch.models.attention import Attention
    from repro_torch.models.ssm import Mamba2
    from repro_torch.models.xlstm import MLSTM, SLSTM

    if isinstance(mod, Attention) and not name.endswith("xattn"):
        return _attn_perms(name, mod, torch.randperm(
            mod.cfg.n_kv_heads, device="cuda", generator=gen))
    if not isinstance(mod, (Mamba2, MLSTM, SLSTM)):
        return {}
    cfg = mod.cfg
    nh = cfg.n_heads
    width = cfg.dim if isinstance(mod, SLSTM) else cfg.d_inner
    hd = width // nh
    hp = torch.randperm(nh, device="cuda", generator=gen)
    cp = (hp[:, None] * hd + torch.arange(hd, device="cuda")).flatten()

    def ar(lo, hi):
        return torch.arange(lo, hi, device="cuda")

    p = f"{name}."
    if isinstance(mod, Mamba2):
        di, ns = cfg.d_inner, cfg.d_state
        chans = torch.cat([cp, ar(di, di + 2 * ns)])
        return {p + "in_proj": (1, torch.cat([cp, di + cp, ar(
                    2 * di, 2 * di + 2 * ns), 2 * di + 2 * ns + hp])),
                p + "conv.w": (0, chans), p + "conv.b": (0, chans),
                p + "a_log": (0, hp), p + "dt_bias": (0, hp),
                p + "d_skip": (0, hp), p + "norm.scale": (0, cp),
                p + "out_proj": (0, cp)}
    if isinstance(mod, MLSTM):
        di = cfg.d_inner
        return {p + "in_proj": (1, torch.cat(
                    [g * di + cp for g in range(4)]
                    + [4 * di + hp, 4 * di + nh + hp])),
                p + "norm.scale": (0, cp), p + "out_proj": (0, cp)}
    gates = torch.cat([g * width + cp for g in range(4)])
    return {p + "w_in": (1, gates), p + "b": (0, gates), p + "r": (1, hp),
            p + "out_proj": (0, cp)}


def _tp_reordered(model, batch, grads) -> tuple:
    """({leaf: the largest distance between its gradient ``grads`` and the
    one rank's gradient once more in another reduction order}, the
    relative distance between the two gradients' global norms): the FFN's
    hidden units, the vocabulary, the recurrent mixers' and the attention
    layers' heads taken in a seeded permutation (the same function; the
    sums over d_ff, over the vocabulary, over a mixer's inner width and
    over the heads, those the model axis splits, run in another order),
    the gradients read back in the model's own layout.  Every
    cross-attention and the encoder's K/V projection share one order of
    the kv heads.  The weights are put back bit for bit."""
    from repro_torch.models import lm
    from repro_torch.models.lm import XAttnBlock

    params = dict(model.named_parameters())
    gen = torch.Generator(device="cuda").manual_seed(TP_SEED + 2)
    vocab = torch.randperm(model.cfg.vocab, device="cuda", generator=gen)
    hidden = torch.randperm(model.cfg.d_ff, device="cuda", generator=gen)
    # {name: (dim, permutation)}: each leaf's permuted dim.
    perms = {"embed": (0, vocab)}
    if "head" in params:
        perms["head"] = (1, vocab)
    for n in params:
        if n.endswith(("ffn.gate", "ffn.up", "ffn.fc1")):
            perms[n] = (1, hidden)
        elif n.endswith(("ffn.down", "ffn.fc2", "ffn.b1")):
            perms[n] = (0, hidden)
    for name, mod in model.named_modules():
        perms.update(_head_perms(name, mod, gen))
    if model.cfg.encoder_layers:
        cfg, cross = model.cfg, torch.randperm(
            model.cfg.n_kv_heads, device="cuda", generator=gen)
        kc = (cross[:, None] * cfg.hd
              + torch.arange(cfg.hd, device="cuda")).flatten()
        perms.update({f"enc_kv_proj.{w}": (1, kc) for w in ("wk", "wv")})
        for name, mod in model.named_modules():
            if isinstance(mod, XAttnBlock):
                perms.update(_attn_perms(f"{name}.xattn", mod.xattn, cross))
    saved = {n: params[n].detach().clone() for n in perms}
    inv = torch.argsort(vocab)
    with torch.no_grad():
        for n, (dim, pi) in perms.items():
            params[n].copy_(saved[n].index_select(dim, pi))
    moved = {k: inv[v.long()] if k in ("tokens", "labels") else v
             for k, v in batch.items()}
    loss, _ = lm.lm_loss(model, moved)
    again = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()), allow_unused=True, materialize_grads=True)))
    del loss
    with torch.no_grad():
        for n in perms:
            params[n].copy_(saved[n])
    out = {}
    for n, g in again.items():
        if n in perms:
            dim, pi = perms[n]
            g = g.index_select(dim, torch.argsort(pi))
        out[n] = (g - grads[n]).abs().max().item()

    def norm(gs):
        return math.sqrt(sum(g.double().square().sum().item()
                             for g in gs.values()))

    return out, abs(norm(again) / norm(grads) - 1.0)


def _tp_reference(path: pathlib.Path) -> dict:
    """The one-rank side, in this process: (a)-(c)'s seeded model (its
    leaf sums), the counted loss and gradients at 1 x 4096, one AdamW step
    with its loss, gradient norm and a seeded sample of every leaf; then
    (d)'s grok layer at M = 1: loss, aux and sampled gradients at
    1 x 256.  Saved to ``path`` for the ranks."""
    from repro_torch.models import lm

    ref = _tp_one_rank(_dp_cfg(), TRAIN_SEQ)

    # (d) grok's layer at M = 1.
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    moe_cfg = _tp_moe_cfg(1)
    model = lm.LM(moe_cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(TP_SEED))
    params = dict(model.named_parameters())
    ref["moe_bytes"] = {n: p.numel() * p.element_size()
                        for n, p in params.items()}
    loss, metrics = lm.lm_loss(model, _tp_batch(moe_cfg, TP_MOE_TOKENS[1],
                                                TP_MOE_TOKENS[0]))
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    ref["moe"] = _samples(params, grads, TP_SEED + 1)
    ref["moe"].update(loss=loss.detach().item(),
                      aux=metrics["aux"].detach().item())
    torch.cuda.synchronize()
    ref["moe_s"] = time.perf_counter() - t0
    ref["moe_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del model, params, grads, loss, metrics
    torch.cuda.empty_cache()

    # (f) the recurrent kinds.
    ref["rec"] = {}
    for arch, seq in TP_REC.items():
        t0 = time.perf_counter()
        cfg = _tp_rec_cfg(arch)
        ref["rec"][arch] = _tp_one_rank(cfg, seq)
        ref["rec"][arch]["serve"] = _tp_rec_serve_one_rank(cfg)
        ref["rec"][arch]["s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()

    # (g) the VL and encoder-decoder families.
    ref["xf"] = {}
    for arch, (rows, seq, _) in TP_XF.items():
        t0 = time.perf_counter()
        cfg = _tp_xf_cfg(arch)
        ref["xf"][arch] = _tp_one_rank(cfg, seq, rows,
                                       lean=cfg.family == "vlm")
        ref["xf"][arch]["serve"] = _tp_xf_serve_one_rank(cfg)
        ref["xf"][arch]["s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    torch.save(ref, path)
    return ref


def _adamw_by_leaf(params, grads):
    """One AdamW step from zero moments of ``params`` by ``grads`` (which
    it empties), clipped by the global norm of all of them, each leaf
    updated by ``adamw_update`` on its own: the step's arithmetic with one
    leaf's moments and temporaries alive at a time.  Returns the global
    norm."""
    from repro_torch.optim.adamw import adamw_init, adamw_update, global_norm

    ocfg = _dp_opt()
    gnorm = global_norm(grads[n] for n in params)
    for n, p in params.items():
        one = {n: p}
        adamw_update(ocfg, {n: grads.pop(n)}, adamw_init(ocfg, one), one,
                     norm=lambda _: gnorm)
    return gnorm


def _tp_one_rank(cfg, seq, rows=1, lean=False) -> dict:
    """The one-rank side of a model-axis step check, in this process:
    the seeded model's leaf sums and shapes, the counted loss and
    gradients at ``rows`` x ``seq``, one AdamW step with its loss,
    gradient norm and a seeded sample of every leaf, and the noise
    control of (c).  The gradients and the control run before the
    optimizer's state exists; the step is then the train step of a
    setup drawn again from the seed, or, ``lean``, those gradients
    applied leaf by leaf (:func:`_adamw_by_leaf`): qwen2-vl's cut model
    (13.5 GB of f32 parameters) with its whole state, its gradients and
    AdamW's temporaries over the 4.6 GiB embedding and head does not fit
    the card."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import lm
    from repro_torch.optim.adamw import lr_at
    from repro_torch.train.step import make_train_setup

    torch.cuda.reset_peak_memory_stats()
    model = lm.LM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(TP_SEED))
    params = dict(model.named_parameters())
    ref = {"sums": {n: p.double().sum().item() for n, p in params.items()},
           "shapes": {n: list(p.shape) for n, p in params.items()},
           "seq": seq, "rows": rows}
    batch = _tp_batch(cfg, seq, rows)
    cuda_lib.clear_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = lm.lm_loss(model, batch)
    # Exact zeros for the leaves the loss does not read (xattn's own wk
    # and wv).
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()), allow_unused=True, materialize_grads=True)))
    torch.cuda.synchronize()
    grads_s = time.perf_counter() - t0
    ref["launches"] = {"/".join(map(str, k)): v for k, v in
                       cuda_lib.launch_shapes.items()}
    ref["plain"] = sum(cuda_lib.plain_calls.values())
    ref["step"] = _samples(params, grads, TP_SEED)
    ref["step"]["reorder"], ref["step"]["reorder_norm"] = _tp_reordered(
        model, batch, grads)
    if lean:
        t0 = time.perf_counter()
        metrics = {"loss": loss.detach(),
                   "grad_norm": _adamw_by_leaf(params, grads)}
        torch.cuda.synchronize()
        ref["step_ms"] = (grads_s + time.perf_counter() - t0) * 1e3
        setup = None
    else:
        del grads, model, params, loss
        gc.collect()
        torch.cuda.empty_cache()
        setup = make_train_setup(cfg, _dp_opt(), device="cuda",
                                 seed=TP_SEED)
        model = setup.model
        params = dict(model.named_parameters())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = setup.train_step(setup.state, batch)
        torch.cuda.synchronize()
        ref["step_ms"] = (time.perf_counter() - t0) * 1e3
    ref["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    ref.update(loss=float(metrics["loss"]),
               grad_norm=float(metrics["grad_norm"]),
               after={n: p.detach().flatten()[ref["step"]["idx"][n].cuda()]
                      .cpu() for n, p in params.items()},
               after_max={n: p.detach().abs().max().item()
                          for n, p in params.items()})
    # The noise control of (c): AdamW's first step moves an element by
    # lr * g / (|g| + eps) of its clipped gradient g, so a change of g by
    # the largest distance the reordered gradient shows on its leaf
    # moves it this far.
    ocfg = _dp_opt()
    clip = min(1.0, ocfg.grad_clip / max(ref["grad_norm"], 1e-9))
    lr = float(lr_at(ocfg, 1))

    def moved(g):
        return lr * g * clip / ((g * clip).abs() + ocfg.eps)

    ref["step"]["noise"] = {
        n: torch.maximum((moved(g + a) - moved(g)).abs(),
                         (moved(g - a) - moved(g)).abs())
        for n, g in ref["step"]["grad"].items()
        for a in [ref["step"]["reorder"][n]]}
    del setup, model, params
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def _tp_rec_tokens(cfg, batch=1):
    gen = torch.Generator(device="cuda").manual_seed(TP_SEED + 3)
    return torch.randint(0, cfg.vocab, (1, TP_REC_PROMPT), device="cuda",
                         generator=gen).expand(batch, TP_REC_PROMPT)


def _tp_rec_greedy(model, tokens, ctx=None, after=None):
    """:func:`_rl_greedy` over TP_REC_DECODE steps, each call timed: (the
    last logits of row 0, the tokens chosen, {call: ms}).
    ``after(what, caches)`` sees the caches after each call."""
    ms = {}

    def timed(what, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[what] = (time.perf_counter() - t0) * 1e3
        if after is not None:
            after(what, out[1])
        return out

    logits, chosen, _ = _rl_greedy(model, tokens,
                                   TP_REC_PROMPT + TP_REC_DECODE, ctx, timed,
                                   TP_REC_DECODE)
    return logits, chosen, ms


def _tp_rec_serve_one_rank(cfg) -> dict:
    """(f)'s serving reference: the seeded model's greedy run on one rank
    at batch 1, and its own rounding noise: the same run over a batch of
    two copies of the prompt (other product shapes, the same function),
    row 0's largest distance from batch 1's over the largest logit."""
    from repro_torch.models import lm
    model = lm.LM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(TP_SEED))
    logits, chosen, ms = _tp_rec_greedy(model, _tp_rec_tokens(cfg))
    twin, _, _ = _tp_rec_greedy(model, _tp_rec_tokens(cfg, 2))
    del model
    torch.cuda.empty_cache()
    return {"logits": logits, "tokens": chosen, "ms": ms,
            "noise": _rel_err(twin, logits)}


def _tp_xf_serve(model, ctx=None, after=None, copies=1):
    """(g)'s serving run of ``model`` (a TP_XF arch): whisper's clips
    through ``lm_encode``, then ``lm_prefill`` of the seeded prompt (the
    VL prompt's first TP_XF_VISION positions vision embeddings) and
    TP_REC_DECODE greedy decode steps, each call timed; ``copies`` stacks
    that many copies of the batch (the noise control).  ``after(what,
    out)`` sees each call's output.  Returns (the last logits of row 0,
    the tokens chosen, {call: ms})."""
    from repro_torch.models import lm

    cfg = model.cfg
    rows = TP_XF[cfg.name][0]
    gen = torch.Generator(device="cuda").manual_seed(TP_SEED + 4)
    tokens = torch.randint(0, cfg.vocab, (rows, TP_XF_PROMPT[cfg.name]),
                           device="cuda", generator=gen)
    vision = frames = None
    if cfg.family == "vlm":
        vision = torch.randn((rows, TP_XF_VISION, cfg.d_model),
                             device="cuda", generator=gen)
    if cfg.family == "audio":
        frames = torch.randn((rows, cfg.enc_len, cfg.d_model),
                             device="cuda", generator=gen)
    tokens, vision, frames = (None if t is None else torch.cat([t] * copies)
                              for t in (tokens, vision, frames))
    ms = {}

    def timed(what, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[what] = (time.perf_counter() - t0) * 1e3
        if after is not None:
            after(what, out)
        return out

    enc_kv = None
    if frames is not None:
        with torch.no_grad():
            enc_kv = timed("encode", lambda: lm.lm_encode(model, frames))
    max_len = 448 if cfg.family == "audio" else \
        TP_XF_PROMPT[cfg.name] + TP_REC_DECODE
    logits, chosen, _ = _rl_greedy(model, tokens, max_len, ctx, timed,
                                   TP_REC_DECODE, vision_embeds=vision,
                                   enc_kv=enc_kv)
    return logits, chosen, ms


def _tp_xf_serve_one_rank(cfg) -> dict:
    """(g)'s serving reference: the seeded model's run on one rank, and
    its own rounding noise (two copies of the batch against one, row
    0's largest distance over the largest logit)."""
    from repro_torch.models import lm
    model = lm.LM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(TP_SEED))
    logits, chosen, ms = _tp_xf_serve(model)
    twin, _, _ = _tp_xf_serve(model, copies=2)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"logits": logits, "tokens": chosen, "ms": ms,
            "noise": _rel_err(twin, logits)}


def _tp_placements(setup, ref):
    """(a): local shapes as the specs say, for parameters and moments;
    leaf sums against the one-rank model's (the shards' sums over the
    ranks; a replicated leaf's on every rank); bytes."""
    import torch.distributed as dist

    bad = []
    for n, p in setup.state["params"].items():
        want = list(ref["shapes"][n])
        pl = setup.state_placements.get(f"params/{n}")
        if pl is not None:
            want[pl[0]] //= pl[1]
        for what, t in (("params", p), ("m", setup.state["opt"]["m"][n]),
                        ("v", setup.state["opt"]["v"][n])):
            if list(t.shape) != want:
                bad.append(f"{what}/{n} {list(t.shape)} != {want}")
    names = sorted(setup.state["params"])
    sums = torch.tensor([setup.state["params"][n].double().sum().item()
                         for n in names], dtype=torch.float64)
    every = [torch.empty_like(sums) for _ in range(TP_RANKS)]
    dist.all_gather(every, sums)
    seed_bad = []
    for i, n in enumerate(names):
        want = ref["sums"][n]
        if f"params/{n}" in setup.state_placements:
            got = sum(e[i].item() for e in every)
        else:
            got = every[0][i].item()
            if any(e[i].item() != got for e in every):
                seed_bad.append(f"{n}: replicas differ")
        if abs(got - want) > 1e-9 * max(abs(want), 1.0):
            seed_bad.append(f"{n}: {got} != {want}")

    def nbytes(d):
        return sum(t.numel() * t.element_size() for t in d.values())

    full = sum(math.prod(s) for s in ref["shapes"].values()) * 4
    params = nbytes(setup.state["params"])
    return {"bad": bad, "seed_bad": seed_bad,
            "n_sharded": sum(1 for k in setup.state_placements
                             if k.startswith("params/")),
            "n_params": len(names),
            "bytes": {"params": params, "grads": params,
                      "moments": nbytes(setup.state["opt"]["m"])
                      + nbytes(setup.state["opt"]["v"])},
            "one_rank_bytes": {"params": full, "grads": full,
                               "moments": 2 * full}}


def _tp_hidden(setup):
    """(c)'s replication check: a forward without gradients from the
    seed, each block's output (the residual stream after its all-reduced
    FFN) hashed bit for bit (its int32 view summed in int64) and the last
    one gathered whole: equal on both ranks, or not."""
    import torch.distributed as dist
    from repro_torch.models import lm

    model, outs = setup.model, []
    hooks = [blk.register_forward_hook(
        lambda mod, args, out: outs.append(out.detach().clone()))
        for _, _, blk in model.walk()]
    try:
        with torch.no_grad():
            lm.lm_loss(model, _tp_batch(model.cfg))
    finally:
        for h in hooks:
            h.remove()
    sums = torch.stack([o.float().contiguous().view(torch.int32).long().sum()
                        for o in outs]).cpu()
    every = [torch.empty_like(sums) for _ in range(TP_RANKS)]
    dist.all_gather(every, sums)
    last = [torch.empty_like(outs[-1]) for _ in range(TP_RANKS)]
    dist.all_gather(last, outs[-1].contiguous())
    return {"blocks": len(outs),
            "equal_blocks": int((every[0] == every[1]).sum()),
            "last_equal": bool(torch.equal(last[0], last[1]))}


def _tp_step(setup, ref, rank, note):
    """(b) and (c) (and (f)'s step): the first step from the seed at 1 x
    ``ref["seq"]``, counted and timed with its collectives, against the
    one-rank step ``ref``."""
    import torch.distributed as dist
    from repro_torch.kernels import cuda_lib
    from repro_torch.parallel import collectives

    batch = _tp_batch(setup.model.cfg, ref["seq"], ref["rows"])
    cuda_lib.clear_counts()
    collectives.clear_staged()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metrics = setup.train_step(setup.state, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out = {"step0": {
        "ms": dt * 1e3, "loss": float(metrics["loss"]),
        "grad_norm": float(metrics["grad_norm"]),
        "launches": {"/".join(map(str, k)): v for k, v in
                     cuda_lib.launch_shapes.items()},
        "plain": sum(cuda_lib.plain_calls.values()),
        "staged_bytes": dict(collectives.staged_bytes),
        "link_bytes": dict(collectives.link_bytes),
        "collective_s": dict(collectives.staged_seconds)}}
    note(f"step, {dt * 1e3:.1f} ms, counted collectives "
         f"{dict(collectives.staged_seconds)} s")
    # An element may be off where its gradient is under 1e-5 of its
    # leaf's largest, or by up to four times the distance AdamW's first
    # step moves it under a change of its gradient by the largest
    # distance between the one rank's gradient of its leaf and that
    # gradient in another reduction order (the noise control, measured).
    # A replicated leaf is checked on rank 0.
    s = ref["step"]
    counts = torch.zeros(4, dtype=torch.float64)
    worst = []
    for name, p in setup.state["params"].items():
        placement = setup.state_placements.get(f"params/{name}")
        if placement is None and rank:
            continue
        mine, flat = _dp_local(p, placement, s["idx"][name])
        got = p.detach().flatten()[flat.cuda()].cpu()
        want = ref["after"][name][mine]
        g = s["grad"][name][mine]
        tol = 1e-5 * ref["after_max"][name]
        off = (got - want).abs() > tol
        floor = g.abs() <= 1e-5 * s["grad_max"][name]
        noise = (got - want).abs() <= tol + 4 * s["noise"][name][mine]
        bad = off & ~floor & ~noise
        counts += torch.tensor([float(mine.sum()), float(off.sum()),
                                float((off & ~floor & noise).sum()),
                                float(bad.sum())], dtype=torch.float64)
        for k in torch.nonzero(bad).flatten().tolist()[:2]:
            worst.append((name, float(got[k] - want[k]),
                          float(g[k]) / s["grad_max"][name]))
    dist.all_reduce(counts)
    (out["sampled"], out["sample_off"], out["sample_noise"],
     out["sample_bad"]) = map(int, counts.tolist())
    out["sample_worst"] = worst[:6]
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def _tp_moe(ref, rank, note):
    """(d): grok's layer at M = 2 (ep 2, tp 1), built one rank at a time
    (each draws the whole layer from the seed, then keeps its slab),
    loss, aux and sampled gradients at 1 x 256 against the one rank at
    M = 1.  At ep = M the converter's re-laid slabs (``relayout_slab``)
    are the M = 1 slabs reshaped: a flat index names the same element in
    both layouts."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh_for_devices
    from repro_torch.models import lm
    from repro_torch.parallel.tensor_parallel import shard_model

    cfg = _tp_moe_cfg(TP_RANKS)
    mesh = make_mesh_for_devices(range(TP_RANKS), model_parallel=TP_RANKS,
                                 device_type="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for r in range(TP_RANKS):
        if r == rank:
            model = lm.LM(cfg, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(TP_SEED))
            placements = shard_model(model, mesh)
            torch.cuda.empty_cache()
        dist.barrier()
    setup_s = time.perf_counter() - t0
    params = dict(model.named_parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    note(f"moe set-up {setup_s:.1f} s")
    t0 = time.perf_counter()
    loss, metrics = lm.lm_loss(model, _tp_batch(cfg, TP_MOE_TOKENS[1],
                                                TP_MOE_TOKENS[0]),
                               ctx=lm.Ctx(mesh=mesh))
    grads = dict(zip(params, torch.autograd.grad(loss, list(
        params.values()))))
    torch.cuda.synchronize()
    s = ref["moe"]
    counts = torch.zeros(2, dtype=torch.float64)
    worst = []
    for name, g in grads.items():
        placement = placements.get(name)
        if placement is None and rank:
            continue
        mine, flat = _dp_local(g, placement, s["idx"][name])
        got = g.flatten()[flat.cuda()].cpu()
        want = s["grad"][name][mine]
        bad = (got - want).abs() > 1e-4 * s["grad_max"][name]
        counts += torch.tensor([float(mine.sum()), float(bad.sum())],
                               dtype=torch.float64)
        for k in torch.nonzero(bad).flatten().tolist()[:2]:
            worst.append((name, float(got[k]), float(want[k])))
    dist.all_reduce(counts)
    return {"loss": loss.detach().item(),
            "aux": metrics["aux"].detach().item(),
            "setup_s": setup_s, "ms": (time.perf_counter() - t0) * 1e3,
            "bytes": nbytes, "n_sharded": len(placements),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "sampled": int(counts[0]), "bad": int(counts[1]),
            "worst": worst[:6]}


def _tp_rec(arch, ref, rank, note):
    """(f) on this rank: the arch's setup on (data 1, model 2) from the
    seed, its placements, its first step against the one rank's, then
    the seeded model sharded: the greedy prefill and decode steps, each
    call's collective bytes, and the digests of every cache leaf that the
    axis keeps whole (all but the KV caches) after each call."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh_for_devices
    from repro_torch.models import lm
    from repro_torch.parallel import collectives
    from repro_torch.parallel.tensor_parallel import (HeadParallel,
                                                      shard_model)
    from repro_torch.train.step import make_train_setup

    cfg = _tp_rec_cfg(arch)
    mesh = make_mesh_for_devices(range(TP_RANKS), model_parallel=TP_RANKS,
                                 device_type="cuda")
    torch.cuda.reset_peak_memory_stats()
    setup = make_train_setup(cfg, _dp_opt(), mesh=mesh, device="cuda",
                             seed=TP_SEED)
    out = {"placements": _tp_placements(setup, ref),
           "paths": sorted({f"{type(m).__name__}: "
                            f"{'whole' if m._own() is None else 'heads'}"
                            for m in setup.model.modules()
                            if isinstance(m, HeadParallel)})}
    out.update(_tp_step(setup, ref, rank, note))
    del setup
    gc.collect()
    torch.cuda.empty_cache()
    note(f"{arch} step")
    model = lm.LM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(TP_SEED))
    shard_model(model, mesh)
    digests, calls = [], {}

    def after(what, caches):
        calls[what] = {"staged": sum(collectives.staged_bytes.values()),
                       "link": sum(collectives.link_bytes.values())}
        collectives.clear_staged()
        digests.append({f"{k}/{n}": _digest(t) for k, sub in caches.items()
                        for n, t in sub.items() if n not in ("k", "v")})

    collectives.clear_staged()
    logits, chosen, ms = _tp_rec_greedy(model, _tp_rec_tokens(cfg),
                                        lm.Ctx(mesh=mesh), after)
    every = [None] * TP_RANKS
    dist.all_gather_object(every, digests)
    out.update(serve_ms=ms, tokens=chosen, calls=calls,
               caches_equal=[all(e[i] == digests[i] for e in every)
                             for i in range(len(digests))],
               leaves=len(digests[0]))
    if rank == 0:
        out["serve_err"] = _rel_err(logits, ref["serve"]["logits"])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    note(f"{arch} prefill and decode")
    return out


def _tp_xf(arch, ref, rank, note):
    """(g) on this rank: the arch's setup on (data 1, model 2) from the
    seed, its placements, its first step against the one rank's, then
    the seeded model sharded: (whisper's ``lm_encode``,) the prefill and
    the greedy decode steps, each call's collective bytes, the digests of
    ``enc_kv`` and of every cache leaf that the axis keeps whole after
    each call, and this rank's KV cache shape."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh_for_devices
    from repro_torch.models import lm
    from repro_torch.parallel import collectives
    from repro_torch.parallel.tensor_parallel import shard_model
    from repro_torch.train.step import make_train_setup

    cfg = _tp_xf_cfg(arch)
    mesh = make_mesh_for_devices(range(TP_RANKS), model_parallel=TP_RANKS,
                                 device_type="cuda")
    torch.cuda.reset_peak_memory_stats()
    setup = make_train_setup(cfg, _dp_opt(), mesh=mesh, device="cuda",
                             seed=TP_SEED)
    out = {"placements": _tp_placements(setup, ref),
           "vocab_parallel": setup.model.tp is not None}
    out.update(_tp_step(setup, ref, rank, note))
    del setup
    gc.collect()
    torch.cuda.empty_cache()
    note(f"{arch} step")
    model = lm.LM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(TP_SEED))
    shard_model(model, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    digests, calls = [], {}

    def after(what, res):
        calls[what] = {"staged": sum(collectives.staged_bytes.values()),
                       "link": sum(collectives.link_bytes.values())}
        collectives.clear_staged()
        if what == "encode":
            digests.append({f"enc_kv/{n}": _digest(t)
                            for n, t in zip("kv", res)})
            return
        caches = res[1]
        digests.append({f"{k}/{n}": _digest(t) for k, sub in caches.items()
                        for n, t in sub.items() if n not in ("k", "v")})
        if what == "prefill":
            calls[what]["kv_shapes"] = sorted({
                str(list(sub["k"].shape)) for sub in caches.values()})

    collectives.clear_staged()
    logits, chosen, ms = _tp_xf_serve(model, lm.Ctx(mesh=mesh), after)
    every = [None] * TP_RANKS
    dist.all_gather_object(every, digests)
    out.update(serve_ms=ms, tokens=chosen, calls=calls,
               caches_equal=[all(e[i] == digests[i] for e in every)
                             for i in range(len(digests))],
               leaves=len(digests[-1]))
    if rank == 0:
        out["serve_err"] = _rel_err(logits, ref["serve"]["logits"])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    note(f"{arch} serve")
    return out


def tp_worker(mode: str, out: str) -> None:
    """One rank of the lm tp phase, started by :func:`_spawn_ranks`: joins
    the gloo group the ranks share, builds the setup on (data 1, model 2)
    from the seed, runs (a), (b), (c), (d), (f) and (g), and on rank 0
    writes every rank's results to ``out``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_mesh_for_devices
    from repro_torch.train.step import make_train_setup
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    init_distributed(torch.device("cuda"))
    rank = dist.get_rank()
    t_start = time.perf_counter()

    def note(what):
        print(f"lm tp rank {rank}: {what} at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    ref = torch.load(pathlib.Path(out).with_name("ref.pt"))
    mesh = make_mesh_for_devices(range(TP_RANKS), model_parallel=TP_RANKS,
                                 device_type="cuda")
    t0 = time.perf_counter()
    setup = make_train_setup(_dp_cfg(), _dp_opt(), mesh=mesh, device="cuda",
                             seed=TP_SEED)
    torch.cuda.synchronize()
    note("setup")
    res = {"setup_s": time.perf_counter() - t0,
           "mesh": dict(zip(mesh.mesh_dim_names, list(mesh.mesh.shape))),
           "placements": _tp_placements(setup, ref)}
    res["hidden"] = _tp_hidden(setup)
    note("placements, hidden states")
    res.update(_tp_step(setup, ref, rank, note))
    del setup
    torch.cuda.empty_cache()
    res["moe"] = _tp_moe(ref, rank, note)
    note("moe")
    gc.collect()
    torch.cuda.empty_cache()
    res["rec"] = {arch: _tp_rec(arch, ref["rec"][arch], rank, note)
                  for arch in TP_REC}
    res["xf"] = {arch: _tp_xf(arch, ref["xf"][arch], rank, note)
                 for arch in TP_XF}
    every = [None] * TP_RANKS
    dist.all_gather_object(every, res)
    dist.destroy_process_group()
    if rank == 0:
        pathlib.Path(out).write_text(json.dumps(every))


def _tp_launch(extra, ckpt) -> tuple:
    """The train launcher with ``--distributed`` in 2 ranks; returns
    (rank 0's losses, its first step, its mesh line, every rank's launch
    line)."""
    logs = _run_ranks([*TP_LAUNCH, *extra, "--ckpt-dir", str(ckpt)],
                      TP_RANKS, "lm tp launcher")
    start = int(re.search(r"from step (\d+)", logs[0]).group(1))
    losses = json.loads(re.search(r"losses (\[[^\]]*\])", logs[0]).group(1))
    mesh = re.search(r"mesh (\{[^}]*\})", logs[0]).group(1)
    lines = [re.search(r"scan launches .*", log).group(0) for log in logs]
    return losses, start, mesh, lines


def _tp_rec_report(arch, ref, ranks, smi) -> list:
    """(f)'s lines for ``arch`` and the names of its failed checks."""
    cfg = _tp_rec_cfg(arch)
    return _tp_axis_report(
        "(f)", arch, ref, ranks, smi,
        f"full width, {cfg.n_units} of its units ({cfg.layer_count()} "
        f"blocks applied), f32, remat unit, on (data 1, model 2), mixers "
        f"{ranks[0]['paths']}",
        f"lm_prefill of 1 x {TP_REC_PROMPT} and {TP_REC_DECODE} greedy "
        f"lm_decode_steps", "vocabulary" + (" and d_ff" if cfg.d_ff else "")
        + " and heads")


def _tp_xf_report(arch, ref, ranks, smi) -> list:
    """(g)'s lines for ``arch`` and the names of its failed checks."""
    from repro_torch.configs.base import get_arch
    from repro_torch.models.attention import kv_split
    cfg = _tp_xf_cfg(arch)
    rows, seq, _ = TP_XF[arch]
    per = cfg.n_heads * cfg.hd // TP_RANKS
    prompt = TP_XF_PROMPT[arch]
    max_len = 448 if cfg.family == "audio" else prompt + TP_REC_DECODE
    extra = (f"{TP_XF_VISION} vision embeddings" if cfg.family == "vlm"
             else f"{cfg.enc_len} frames a clip")
    fails = _tp_axis_report(
        "(g)", arch, ref, ranks, smi,
        f"full width, {cfg.layer_count()} of {get_arch(arch).full().n_layers}"
        f" decoder layers, {cfg.encoder_layers} encoder layers, f32, remat "
        f"unit, on (data 1, model 2): {per // cfg.hd} heads of "
        f"{cfg.n_heads} ({per} rows of wo) a rank, KV caches split by "
        f"{kv_split(cfg.n_kv_heads, max_len, TP_RANKS)}, vocabulary "
        f"{'split' if ranks[0]['vocab_parallel'] else 'whole'}; the step "
        f"at {rows} x {seq} with {extra}",
        ("lm_encode, " if cfg.encoder_layers else "")
        + f"lm_prefill of {rows} x {prompt} ({extra}) and "
        f"{TP_REC_DECODE} greedy lm_decode_steps",
        "vocabulary, d_ff and heads")
    calls = ranks[0]["calls"]
    ms = ranks[0]["serve_ms"]
    sv = ref["serve"]
    enc = ""
    if "encode" in calls:
        enc = (f"lm_encode {ms['encode']:.1f} ms a rank (one rank "
               f"{sv['ms']['encode']:.1f}), {calls['encode']['staged']} "
               f"bytes a rank through host memory "
               f"({calls['encode']['link']} on its links), enc_kv "
               f"bit-equal on both ranks {all(r['caches_equal'][0] for r in ranks)}; ")
    print(f"lm tp (g) {arch} serve layout ({smi}): {enc}KV caches a rank "
          f"{calls['prefill']['kv_shapes']}; vocab-parallel "
          f"{ranks[0]['vocab_parallel']}", flush=True)
    if ranks[0]["vocab_parallel"] != (cfg.vocab % TP_RANKS == 0):
        fails.append(f"(g) {arch} vocabulary")
    return fails


def _tp_axis_report(tag, arch, ref, ranks, smi, layout, serve, permuted):
    """The lines of (f) or (g) (``tag``) for ``arch`` laid out as
    ``layout``, its serving run ``serve``, its noise control's permuted
    sums ``permuted``; the names of its failed checks."""
    fails = []
    r0, seq, rows = ranks[0], ref["seq"], ref["rows"]
    pl, s0 = r0["placements"], r0["step0"]
    print(f"lm tp {tag} {arch} ({smi}): {layout}; one rank set-up and "
          f"checks {ref['s']:.1f} s; {pl['n_sharded']} of {pl['n_params']} "
          f"parameters sharded over model, shape faults "
          f"{pl['bad'][:3] + ranks[1]['placements']['bad'][:3]}, seed "
          f"faults {pl['seed_bad'][:3]}; bytes a rank: parameters "
          f"{pl['bytes']['params']} (one rank "
          f"{pl['one_rank_bytes']['params']})", flush=True)
    if any(r["placements"]["bad"] or r["placements"]["seed_bad"]
           for r in ranks) or not pl["n_sharded"]:
        fails.append(f"{tag} {arch} placements")
    rel = abs(s0["loss"] - ref["loss"]) / abs(ref["loss"])
    gn = abs(s0["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    shares = sorted(a / max(ref["step"]["grad_max"][n], 1e-30)
                    for n, a in ref["step"]["reorder"].items())
    # grad_norm's bar: (c)'s 1e-6, or four times the relative distance
    # between the one rank's gradient norm and that of its reordered
    # gradient (the noise control's), measured in this run.
    gn_bar = max(1e-6, 4 * ref["step"]["reorder_norm"])
    for r, res in enumerate(ranks):
        st = res["step0"]
        coll = sum(st["collective_s"].values()) * 1e3
        by = {k: round(v * 1e3, 1) for k, v in st["collective_s"].items()}
        print(f"lm tp {tag} {arch} step rank {r} ({smi}): {rows} x {seq}, "
              f"the first step from the seed {st['ms']:.1f} ms (one rank "
              f"{ref['step_ms']:.1f} ms), of which the counted collectives "
              f"{coll:.1f} ms ({coll / st['ms']:.3f}) {by}, "
              f"bytes through host memory {sum(st['staged_bytes'].values())} "
              f"{st['staged_bytes']}, on the rank's links "
              f"{sum(st['link_bytes'].values())}; peak "
              f"{res['peak_gib']:.2f} GiB (one rank {ref['peak_gib']:.2f}); "
              f"launches {st['launches']}, plain {st['plain']}", flush=True)
    print(f"lm tp {tag} {arch} step vs one rank: loss {s0['loss']:.7f} vs "
          f"{ref['loss']:.7f} (relative {rel:.3e}, tol 1e-5), grad_norm "
          f"{s0['grad_norm']:.7f} vs {ref['grad_norm']:.7f} (relative "
          f"{gn:.3e}, tol {gn_bar:.3e}: 1e-6 or 4x the reordered one "
          f"rank's {ref['step']['reorder_norm']:.3e}); of {r0['sampled']} "
          f"sampled parameter elements {r0['sample_off']} off by more than "
          f"1e-5 of their leaf's largest, {r0['sample_noise']} of them "
          f"within (c)'s noise control ({permuted} permuted: "
          f"{shares[-1]:.3e} of a leaf's largest gradient at most, median "
          f"{shares[len(shares) // 2]:.3e}), {r0['sample_bad']} otherwise "
          f"(tol 0) {r0['sample_worst'] + ranks[1]['sample_worst']}",
          flush=True)
    if rel > 1e-5 or gn > gn_bar or r0["sample_bad"] or \
            r0["sampled"] != TP_SAMPLES * len(ref["step"]["idx"]) or \
            any(r["step0"]["launches"] or r["step0"]["plain"]
                for r in ranks):
        fails.append(f"{tag} {arch} step")
    sv = ref["serve"]
    bar = max(1e-4, 4 * sv["noise"])
    calls = r0["calls"]
    n_dec = len([k for k in calls if k.startswith("decode")])
    dec = [calls[f"decode {i}"] for i in range(n_dec)]
    equal = [all(r["caches_equal"][i] for r in ranks)
             for i in range(len(r0["caches_equal"]))]
    ms, one = r0["serve_ms"], sv["ms"]
    print(f"lm tp {tag} {arch} serve ({smi}): {serve} on (data 1, model 2) "
          f"vs one rank: last logits {r0['serve_err']:.3e} of the largest "
          f"(bar {bar:.3e}: 1e-4 or 4x the one rank's own noise "
          f"{sv['noise']:.3e}, a batch of two copies vs one), tokens "
          f"{r0['tokens']} vs {sv['tokens']}; the {r0['leaves']} whole "
          f"cache leaves bit-equal on both ranks after each call {equal}; "
          f"prefill {ms['prefill']:.1f} / {ranks[1]['serve_ms']['prefill']:.1f}"
          f" ms a rank (one rank {one['prefill']:.1f}), decode step median "
          f"{statistics.median(ms[f'decode {i}'] for i in range(n_dec)):.1f}"
          f" ms (one rank "
          f"{statistics.median(one[f'decode {i}'] for i in range(n_dec)):.1f}"
          f"); collective bytes a rank: prefill {calls['prefill']['staged']} "
          f"through host memory ({calls['prefill']['link']} on its links), "
          f"a decode step {dec[0]['staged']} ({dec[0]['link']})", flush=True)
    if r0["serve_err"] > bar or r0["tokens"] != sv["tokens"] or \
            ranks[1]["tokens"] != sv["tokens"] or not all(equal):
        fails.append(f"{tag} {arch} serve")
    return fails


def tp_phase():
    """Tensor parallelism at full width on (data 1, model 2): (a)
    placements and the seed, (b) a counted step on each rank, (c) that
    step against the one-rank step and the ranks' hidden states bit for
    bit, (d) grok's expert-parallel layer against one rank, (f) the
    recurrent kinds (zamba2-2.7b and xlstm-1.3b, SSM_UNITS' depth):
    placements, a step and a greedy prefill and decode against one rank,
    the caches bit-equal across ranks, (g) the VL and encoder-decoder
    families (whisper-base whole, qwen2-vl-72b at 1 of 80 layers): the
    same, with whisper's lm_encode and enc_kv bit-equal across ranks,
    (e) the launcher with --distributed, which now builds the model axis,
    and its resume from the model-sharded checkpoint."""
    import shutil

    out_dir = ROOT / "build" / "tp"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).strip()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = _tp_reference(out_dir / "ref.pt")
    print(f"lm tp one rank ({smi}): f32 policy, remat unit, seed {TP_SEED}; "
          f"1 x {TRAIN_SEQ} loss and gradients launch {ref['launches']}, "
          f"plain {ref['plain']}; one AdamW step: loss {ref['loss']:.6f}, "
          f"grad_norm {ref['grad_norm']:.6f}, {ref['step_ms']:.1f} ms, peak "
          f"{ref['peak_gib']:.2f} GiB; grok one attn_moe layer at M = 1, "
          f"{sum(ref['moe_bytes'].values())} bytes of f32 parameters (slabs "
          f"{sum(v for k, v in ref['moe_bytes'].items() if 'slab' in k)}), "
          f"loss {ref['moe']['loss']:.6f}, aux {ref['moe']['aux']:.6f}, "
          f"{ref['moe_s']:.1f} s, peak {ref['moe_peak_gib']:.2f} GiB; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # The ranks share the card: (g)'s qwen2-vl step takes ~34 GiB a rank.
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = _spawn_ranks("step", TP_RANKS, out_dir / "step.json",
                         worker="tp_worker")
    fails = []
    for r, res in enumerate(ranks):
        pl = res["placements"]
        b, one = pl["bytes"], pl["one_rank_bytes"]
        print(f"lm tp (a) rank {r} ({smi}): mesh {res['mesh']}, setup "
              f"{res['setup_s']:.1f} s; {pl['n_sharded']} of "
              f"{pl['n_params']} parameters sharded over model, shape "
              f"faults {pl['bad'][:3]}, seed faults {pl['seed_bad'][:3]}; "
              f"bytes a rank: parameters {b['params']} (one rank "
              f"{one['params']}), gradients {b['grads']} ({one['grads']}), "
              f"moments {b['moments']} ({one['moments']})", flush=True)
        if pl["bad"] or pl["seed_bad"] or not pl["n_sharded"]:
            fails.append(f"(a) rank {r}")
        s0 = res["step0"]
        print(f"lm tp (b) rank {r}: launches by shape {s0['launches']}, "
              f"plain scan calls {s0['plain']} (one rank at 1 x "
              f"{TRAIN_SEQ}: {ref['launches']})", flush=True)
        if s0["launches"] != ref["launches"] or s0["plain"]:
            fails.append(f"(b) rank {r}")
        coll = sum(s0["collective_s"].values()) * 1e3
        by = {k: round(v * 1e3, 1) for k, v in s0["collective_s"].items()}
        print(f"lm tp step rank {r} ({smi}): the first step from the seed "
              f"{s0['ms']:.1f} ms (one rank {ref['step_ms']:.1f} ms), of "
              f"which the counted collectives {coll:.1f} ms "
              f"({coll / s0['ms']:.3f}) {by}, bytes through host memory "
              f"{sum(s0['staged_bytes'].values())} {s0['staged_bytes']}; "
              f"peak memory {res['peak_gib']:.2f} GiB; "
              f"{TRAIN_SEQ / s0['ms'] * 1e3:.1f} tokens/s", flush=True)
    s0, r0 = ranks[0]["step0"], ranks[0]
    rel = abs(s0["loss"] - ref["loss"]) / abs(ref["loss"])
    gn = abs(s0["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
    hid = r0["hidden"]
    shares = sorted(a / max(ref["step"]["grad_max"][n], 1e-30)
                    for n, a in ref["step"]["reorder"].items())
    reorder, reorder_med = shares[-1], shares[len(shares) // 2]
    print(f"lm tp (c) (data 1, model 2) vs one rank at 1 x {TRAIN_SEQ}: "
          f"loss {s0['loss']:.7f} vs {ref['loss']:.7f} (relative {rel:.3e}, "
          f"tol 1e-5), grad_norm {s0['grad_norm']:.7f} vs "
          f"{ref['grad_norm']:.7f} (relative {gn:.3e}, tol 1e-6); of "
          f"{r0['sampled']} sampled parameter elements {r0['sample_off']} "
          f"off by more than 1e-5 of their leaf's largest, "
          f"{r0['sample_noise']} of them with a gradient above 1e-5 of its "
          f"leaf's largest but within 4x the distance the one rank's first "
          f"step moves it under a change of its gradient by the largest "
          f"distance the leaf's gradient shows in another reduction order "
          f"(d_ff and the vocabulary permuted: the noise control; that "
          f"distance {reorder:.3e} of the leaf's largest gradient at most, "
          f"median {reorder_med:.3e}), {r0['sample_bad']} otherwise "
          f"(tol 0) "
          f"{r0['sample_worst'] + ranks[1]['sample_worst']}; hidden states "
          f"after the all-reduces: {hid['equal_blocks']} of "
          f"{hid['blocks']} blocks bit-equal on both ranks, the last "
          f"gathered whole equal {hid['last_equal']} (no broadcast)",
          flush=True)
    if rel > 1e-5 or gn > 1e-6 or r0["sample_bad"] or \
            r0["sampled"] != TP_SAMPLES * len(ref["step"]["idx"]) or \
            hid["equal_blocks"] != hid["blocks"] or not hid["last_equal"]:
        fails.append("(c)")
    mo = [res["moe"] for res in ranks]
    lrel = abs(mo[0]["loss"] - ref["moe"]["loss"]) / abs(ref["moe"]["loss"])
    arel = abs(mo[0]["aux"] - ref["moe"]["aux"]) / abs(ref["moe"]["aux"])
    print(f"lm tp (d) grok-1-314b one attn_moe layer, 8 experts of hidden "
          f"32768, d_model 6144, f32, on (data 1, model 2), ep 2 tp 1, vs "
          f"one rank at M = 1, {TP_MOE_TOKENS[0]} x {TP_MOE_TOKENS[1]} "
          f"tokens ({smi}): loss {mo[0]['loss']:.7f} vs "
          f"{ref['moe']['loss']:.7f} (relative {lrel:.3e}, tol 1e-5), aux "
          f"{mo[0]['aux']:.7f} vs {ref['moe']['aux']:.7f} ({arel:.3e}, tol "
          f"1e-5); of {mo[0]['sampled']} sampled gradient elements "
          f"{mo[0]['bad']} off by more than 1e-4 of their leaf's largest "
          f"{mo[0]['worst'] + mo[1]['worst']}; a rank: {mo[0]['bytes']} "
          f"bytes of parameters, {mo[0]['n_sharded']} sharded, set-up "
          f"(one rank at a time) {mo[0]['setup_s']:.1f} s, loss and "
          f"gradients {mo[0]['ms']:.1f} ms, peak "
          f"{max(m['peak_gib'] for m in mo):.2f} GiB", flush=True)
    if lrel > 1e-5 or arel > 1e-5 or mo[0]["bad"] or mo[0]["sampled"] != \
            TP_SAMPLES * len(ref["moe"]["idx"]):
        fails.append("(d)")
    for arch in TP_REC:
        fails += _tp_rec_report(arch, ref["rec"][arch],
                                [res["rec"][arch] for res in ranks], smi)
    for arch in TP_XF:
        fails += _tp_xf_report(arch, ref["xf"][arch],
                               [res["xf"][arch] for res in ranks], smi)
    print(f"lm tp ranks: {time.perf_counter() - t0:.1f} s", flush=True)

    # (e) The launcher, its own policy, with int8_ef (each leaf's scale
    # from a MAX over the model axis), and a resume from its checkpoint.
    # The smoke keeps its disk writes under 45 GiB: one checkpoint of the
    # int8_ef state (parameters, moments, residuals: 22.3 GB over the
    # ranks) and one without residuals (16.7 GB) fit, two of the first
    # do not with the rest of the smoke, so the resume runs uncompressed.
    ckpt = out_dir / "ckpt"
    t0 = time.perf_counter()
    losses, start, mesh, lines = _tp_launch(
        ["--steps", "2", "--ckpt-every", "2", "--grad-compression",
         "int8_ef"], ckpt)
    t1 = time.perf_counter()
    again, start2, _, lines2 = _tp_launch(["--steps", "1"], ckpt)
    print(f"lm tp (e) launcher --distributed --grad-compression int8_ef on "
          f"{TP_RANKS} ranks ({smi}): mesh {mesh}, from step {start}, "
          f"losses {losses} ({t1 - t0:.1f} s, a model-sharded checkpoint "
          f"at step 2); resumed from step {start2} without compression, "
          f"losses {again} ({time.perf_counter() - t1:.1f} s); "
          f"{lines} {lines2}", flush=True)
    if start != 0 or len(losses) != 2 or start2 != 2 or len(again) != 1 \
            or "'model': 2" not in mesh \
            or not all(map(math.isfinite, losses + again)) \
            or not again[0] < losses[0] or \
            any("plain scan calls {}" not in ln for ln in lines + lines2):
        fails.append("(e)")
    shutil.rmtree(ckpt, ignore_errors=True)
    if fails:
        raise AssertionError(f"lm tp: {fails}")


# The SSM and xLSTM families (``ssm ...`` lines).
SSM_ARCHS = ("zamba2-2.7b", "xlstm-1.3b")
# Each family runs at full width and a fraction of its depth (1 of
# zamba2's 9 units, 1 of xlstm's 6): at full depth the phase took 317-436
# s of the smoke's 1200 s, and at 3 and 2 units 145 s, which with the VL
# and audio phases put the smoke past 1000 s; zamba2 went from 2 units to
# 1 when the lm dp phase came (PERF.md §4).
SSM_UNITS = {"zamba2-2.7b": 1, "xlstm-1.3b": 1}
SSM_CORE = {"zamba2": (80, 64, 64), "xlstm": (4, 1024, 1025)}
SSM_CORE_LENS = (1024, 1023)
SSM_PROMPTS = SERVE_PROMPTS + (1023,)
SSM_MAX_LEN = 4112
SSM_DECODE = 16
# xlstm-1.3b trains at 2 x 1024, the longest power of two that keeps the
# phase near its 300 s: its six sLSTM layers run token by token, about 40
# launches a token and layer forward, again under remat and in the
# backward, so a step takes 14.9-16.4 s at 2 x 1024, 28.6-31.0 s at
# 2 x 2048 and 51.4-66.1 s at 2 x 4096 on the H100
# (tools/ssm_train_lengths.py, PERF.md).
SSM_TRAIN = {"zamba2-2.7b": (2, 4096), "xlstm-1.3b": (2, 1024)}
SSM_TRAIN_STEPS = 3
# xlstm's profiled step runs at this length, with kernel records alone: a
# step of 2 x 256 already records about 650 000 operator events.
SSM_PROFILE_SEQ = 256


def _busy_profile(fn, wall_s, what):
    """The card's busy time in one call of ``fn`` (the union of its kernel,
    memcpy and memset records, ``_busy_ms``) and its idle share of an eager
    call that took ``wall_s``, from a profile of device activity alone."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = _busy_ms(prof)
    if busy is None:
        print(f"profile {what}: no device record; device time not measured",
              flush=True)
        return
    print(f"profile {what}: device busy {busy:.3f} ms, eager "
          f"{wall_s * 1e3:.3f} ms, device idle share "
          f"{1 - busy / 1e3 / wall_s:.3f}", flush=True)


def _ssm_core():
    """(a) ``chunked_gla`` against a loop of ``gla_decode_step`` over the
    same tokens at both families' head shapes and decays, S = 1024 and
    1023 (which runs as 1023 chunks of one), f32 (TF32 off): outputs and
    final state within 1e-4 of the largest magnitude; ``CausalConv1d``
    streamed token by token against its full pass, bit for bit."""
    from repro_torch.models.layers import CausalConv1d
    from repro_torch.models.ssm import (chunked_gla, gla_chunk_len,
                                        gla_decode_step)

    gen = torch.Generator(device="cuda").manual_seed(11)
    for fam, (h, dk, dv) in SSM_CORE.items():
        for s in SSM_CORE_LENS:
            torch.cuda.reset_peak_memory_stats()
            q, k = (torch.randn((1, s, h, dk), generator=gen, device="cuda")
                    / math.sqrt(dk) for _ in range(2))
            v = torch.randn((1, s, h, dv), generator=gen, device="cuda")
            raw = torch.randn((1, s, h), generator=gen, device="cuda")
            # Each family's decays: Mamba-2's -a * softplus(dt), a in
            # 1..16 over the heads, or the mLSTM's log_sigmoid(forget).
            ld = (-torch.linspace(1.0, 16.0, h, device="cuda")
                  * torch.nn.functional.softplus(raw) if fam == "zamba2"
                  else torch.nn.functional.logsigmoid(raw))
            t0 = time.perf_counter()
            y, st = chunked_gla(q, k, v, ld, chunk=256)
            torch.cuda.synchronize()
            t_chunked = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            state = torch.zeros((1, h, dk, dv), device="cuda")
            ys = []
            t0 = time.perf_counter()
            for t in range(s):
                yt, state = gla_decode_step(state, q[:, t], k[:, t], v[:, t],
                                            ld[:, t])
                ys.append(yt)
            torch.cuda.synchronize()
            t_loop = time.perf_counter() - t0
            e_y, e_s = _rel_err(y, torch.stack(ys, 1)), _rel_err(st, state)
            print(f"ssm core {fam} {h} heads {dk} x {dv}, S {s} (chunks of "
                  f"{gla_chunk_len(s, 256)}): chunked_gla "
                  f"{t_chunked * 1e3:.3f} ms, peak memory {peak:.3f} GiB; "
                  f"recurrence "
                  f"{t_loop * 1e3:.3f} ms; error / largest magnitude y "
                  f"{e_y:.3e}, state {e_s:.3e} (tol 1e-4)", flush=True)
            if not (e_y <= 1e-4 and e_s <= 1e-4):
                raise AssertionError(f"ssm core {fam} S {s}: chunked_gla "
                                     f"disagrees with its recurrence")
            del q, k, v, ld, y, st, state, ys
            torch.cuda.empty_cache()
    conv = CausalConv1d(5248, 4, generator=torch.Generator().manual_seed(0),
                        device="cuda")
    x = torch.randn((2, 64, 5248), generator=gen, device="cuda")
    with torch.no_grad():
        full, _ = conv(x)
        state = torch.zeros((2, 3, 5248), device="cuda")
        steps = []
        for t in range(x.shape[1]):
            yt, state = conv(x[:, t:t + 1], state)
            steps.append(yt)
    equal = torch.equal(torch.cat(steps, 1), full)
    print(f"ssm core causal conv (2 x 64 x 5248, k 4) streamed vs full: "
          f"bit-equal {equal}", flush=True)
    if not equal:
        raise AssertionError("ssm core: the streamed causal conv differs")


def _ssm_model(arch, precision=None, seed=0):
    from repro_torch.configs.base import get_arch, with_precision
    from repro_torch.models import lm

    cfg = get_arch(arch).full()
    units = SSM_UNITS[arch]
    cfg = dataclasses.replace(cfg, n_units=units,
                              n_layers=cfg.n_layers // cfg.n_units * units)
    if precision:
        cfg = with_precision(cfg, precision)
    t0 = time.perf_counter()
    model = lm.LM(cfg, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    print(f"ssm {arch}: {lm.count_params(model)} parameters "
          f"({cfg.layer_count()} blocks applied, d_model {cfg.d_model}, "
          f"units {cfg.unit} x {cfg.n_units}, shared attn "
          f"{cfg.shared_attn}, vocab {cfg.vocab}), "
          f"{precision or 'its own'} policy, set-up "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return cfg, model


def _ssm_whole(arch):
    """(b) Under the f32 policy at full width: ``lm_prefill`` of
    1 x CHECK_LEN and SSM_DECODE ``lm_decode_step``s against ``apply_lm``
    over the same tokens.  The bar is 1e-4 of the largest logit, or four
    times the model's own f32 rounding noise where that is larger: the
    same ``apply_lm`` over a batch of two copies of the tokens (other
    matrix-product shapes, the same function), measured in this run.
    Seeded zamba2 and xlstm at full depth amplify one f32 rounding of
    their input to about 2e-4 of the largest logit."""
    from repro_torch.models import lm

    cfg, model = _ssm_model(arch, "f32", seed=1)
    n = CHECK_LEN + SSM_DECODE
    toks = torch.randint(0, cfg.vocab, (1, n), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(2))
    tag = f"ssm {arch} f32"
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, caches = _no_scans(
            lambda: lm.lm_prefill(model, toks[:, :CHECK_LEN], n),
            f"prefill of {CHECK_LEN}", tag)
        t_prefill = time.perf_counter() - t0
        steps = []
        for i in range(CHECK_LEN, n):
            step, caches = _no_scans(
                lambda: lm.lm_decode_step(model, toks[:, i:i + 1], caches),
                f"decode step at {i}", tag)
            steps.append(step)
        del caches
        t0 = time.perf_counter()
        full = _no_scans(lambda: lm.apply_lm(model, toks),
                         f"apply_lm of {n}", tag)
        t_full = time.perf_counter() - t0
        twin = _no_scans(lambda: lm.apply_lm(model, toks.expand(2, n)),
                         f"apply_lm of 2 x {n}", tag)[:1]
    noise = _rel_err(twin, full)
    bar = max(1e-4, 4 * noise)
    print(f"{tag}: prefill of {CHECK_LEN} {t_prefill * 1e3:.3f} ms, "
          f"apply_lm of {n} {t_full * 1e3:.3f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; rounding "
          f"noise (apply_lm, batch 2 vs 1) {noise:.3e} of the largest "
          f"logit, bar {bar:.3e}", flush=True)
    _logits_check(f"prefill of {CHECK_LEN} vs apply_lm", logits,
                  full[:, :CHECK_LEN], tol=bar, tag=tag)
    _logits_check(f"{SSM_DECODE} decode steps vs apply_lm",
                  torch.cat(steps, 1), full[:, CHECK_LEN:], tol=bar, tag=tag)
    del model, logits, steps, full, twin
    torch.cuda.empty_cache()


def _state_bytes(caches, n_slots):
    """Pooled state bytes a slot, by family: the mamba stages' conv tail
    and SSM state, the mLSTM's matrix memory, the sLSTM's four vectors
    and the shared attn block's KV cache."""
    groups = {"mamba": "conv + SSM", "mlstm": "mLSTM", "slstm": "sLSTM",
              "shared_attn": "shared KV"}
    out = collections.Counter()
    for key, sub in caches.items():
        name = next(v for k, v in groups.items() if key.endswith(k))
        out[name] += sum(a.numel() * a.element_size()
                         for a in sub.values()) // n_slots
    return dict(out)


def _ssm_serve(arch):
    """(c) The engine under the config's own policy over SSM_PROMPTS, 4
    slots, greedy, asked for chunks of SERVE_CHUNK (one-shot prefill
    follows): TTFT, tok/s, the median decode step, the idle share of a
    decode step and of a 1024-token prefill, the 1023-token prefill beside
    the 1024-token one, peak memory and the state bytes a slot."""
    from repro_torch import obs
    from repro_torch.models import lm
    from repro_torch.models.ssm import gla_chunk_len
    from repro_torch.serve.engine import Request, ServeEngine

    cfg, model = _ssm_model(arch)
    tag = f"ssm {arch} serve"
    even, odd = SERVE_CHUNK, SERVE_CHUNK - 1
    toks = torch.randint(0, cfg.vocab, (1, even), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(3))
    with torch.no_grad():
        times = {}
        for n in (even, odd):
            times[n] = _wall_s(lambda: _no_scans(
                lambda: lm.lm_prefill(model, toks[:, :n], SSM_MAX_LEN),
                f"prefill of {n}", tag), n=1)
    print(f"{tag}: one-shot prefill of {even} tokens "
          f"{times[even] * 1e3:.3f} ms (chunks of "
          f"{gla_chunk_len(even, cfg.gla_chunk)}), of {odd} tokens "
          f"{times[odd] * 1e3:.3f} ms (chunks of "
          f"{gla_chunk_len(odd, cfg.gla_chunk)}: the chunk-halving quirk), "
          f"ratio {times[odd] / times[even]:.3f}", flush=True)

    # The engine runs on a stream of its own, which cannot reuse the
    # blocks the timed prefills cached on this one.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(model, batch_size=4, max_len=SSM_MAX_LEN,
                      prefill_chunk=SERVE_CHUNK)
    if eng.prefill_chunk != 0:
        raise AssertionError(f"{tag}: the engine chunks a model with no "
                             f"chunked prefill")
    rng = torch.Generator().manual_seed(1)
    reqs = [Request(uid=i, prompt=torch.randint(0, cfg.vocab, (n,),
                                                generator=rng).numpy(),
                    max_new_tokens=SERVE_NEW)
            for i, n in enumerate(SSM_PROMPTS)]
    handles = [eng.submit(r) for r in reqs]
    torch.cuda.synchronize()
    obs.clear()
    obs.enable()
    try:
        t0 = time.perf_counter()
        _no_scans(eng.run, "engine run", tag)
        dt = time.perf_counter() - t0
    finally:
        obs.disable()
    m = eng.metrics
    results = [h.result() for h in handles]
    total = sum(len(r.tokens) for r in results)
    for r, n in zip(results, SSM_PROMPTS):
        print(f"{tag} request {r.uid}: prompt {n}, ttft "
              f"{r.ttft * 1e3:.3f} ms, queue {r.queue_delay * 1e3:.3f} ms, "
              f"{len(r.tokens)} tokens {r.tokens}", flush=True)
    ttft = sorted(r.ttft * 1e3 for r in results)
    step_ms = [sp.dur / 1e6 for sp in obs.spans("serve.decode_step")]
    prefill_ms = [sp.dur / 1e6 for sp in obs.spans("serve.prefill")]
    per_slot = _state_bytes(eng.pool.caches, eng.bs)
    print(f"{tag}: {len(results)} requests, {total} tokens in {dt:.3f} s "
          f"({total / dt:.3f} tok/s); TTFT p50 "
          f"{statistics.median(ttft):.3f} ms, p90 "
          f"{ttft[math.ceil(0.9 * len(ttft)) - 1]:.3f} ms; {m['prefills']} "
          f"one-shot prefills (median {statistics.median(prefill_ms):.3f} "
          f"ms), {m['prefill_chunks']} chunks, {m['decode_steps']} decode "
          f"steps, median {statistics.median(step_ms):.3f} ms (of "
          f"{len(step_ms)}); state a slot {per_slot} bytes, pool "
          f"{eng.pool.nbytes} bytes ({eng.bs} slots); peak memory of the run "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    if m["prefills"] != len(SSM_PROMPTS) or m["prefill_chunks"] or \
            [len(r.tokens) for r in results] != [SERVE_NEW] * len(reqs) or \
            not all(0 <= t < cfg.vocab for r in results for t in r.tokens):
        raise AssertionError(f"{tag}: wrong prefills or tokens")
    last, pooled = eng.last_token, eng.pool.caches
    with torch.no_grad():
        def decode():
            return lm.lm_decode_step(model, last, pooled)

        def prefill():
            return lm.lm_prefill(model, toks, SSM_MAX_LEN)

        _profile(decode, _wall_s(decode), f"{tag} decode step (4 slots)")
        _profile(prefill, times[even], f"{tag} prefill of {even}")
    del eng, last, pooled, model
    torch.cuda.empty_cache()


def _ssm_train(arch):
    """(d) Training under the config's own policy, ``remat="unit"``, AdamW
    at SSM_TRAIN[arch]: one warm-up step, the median of SSM_TRAIN_STEPS
    timed steps, tokens/s, peak memory; the loss finite and every
    parameter's gradient finite and nonzero (the shared attn block's,
    summed over its applications, included); a profiled step."""
    from repro_torch.data.pipeline import DataConfig, host_batch, to_device
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import build_train_step, init_train_state

    cfg, model = _ssm_model(arch, seed=4)
    if cfg.remat != "unit":
        raise AssertionError(f"{arch} full() rematerialises {cfg.remat!r}")
    n, seq = SSM_TRAIN[arch]
    tag = f"ssm {arch} train"

    def batch_of(seq, step):
        return to_device(host_batch(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                               global_batch=n), step),
                         "cuda")

    ocfg = AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=100)
    state = init_train_state(model, ocfg)
    step = build_train_step(model, ocfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = _no_scans(lambda: step(state, batch_of(seq, 0)),
                               "warm-up step", tag)
    print(f"{tag} warm-up step {n} x {seq}: "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms; " + ", ".join(
              f"{k} {float(v):.6g}" for k, v in metrics.items()), flush=True)
    times, losses = [], []
    for i in range(SSM_TRAIN_STEPS):
        b = batch_of(seq, 1 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    print(f"{tag} {n} x {seq} tokens, its own policy, remat unit, AdamW: "
          f"median {dt * 1e3:.3f} ms of {SSM_TRAIN_STEPS} steps "
          f"({[round(t * 1e3, 3) for t in times]}), {n * seq / dt:.1f} "
          f"tokens/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; losses "
          f"{losses}", flush=True)
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"{tag}: non-finite loss")
    # The gradients are checked at xlstm's profiled length, where its
    # sLSTM loop is a quarter as long.
    gseq = SSM_PROFILE_SEQ if "xlstm" in arch else seq
    loss, _ = lm.lm_loss(model, batch_of(gseq, 9))
    names = [nm for nm, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    bad = [nm for nm, g in zip(names, grads)
           if not (torch.isfinite(g).all() and g.abs().max() > 0)]
    shared = [nm for nm in names if nm.startswith("shared_attn.")]
    print(f"{tag}: {n} x {gseq} tokens, loss {loss.item():.6g}; "
          f"{len(names)} gradients, "
          f"{len(bad)} not finite and nonzero {bad[:5]}; shared attn "
          f"gradients {len(shared)}", flush=True)
    if bad or not math.isfinite(loss.item()) or \
            (cfg.shared_attn and not shared):
        raise AssertionError(f"{tag}: gradients not finite and nonzero")
    del grads, loss
    if "xlstm" in arch:
        # Kernel records only, their busy time read from the raw records:
        # the operator-level breakdown of a step that runs the sLSTM loop
        # holds millions of profiler events.
        pb = batch_of(SSM_PROFILE_SEQ, 10)
        _busy_profile(lambda: step(state, pb),
                      _wall_s(lambda: step(state, pb), n=1),
                      f"{tag} step {n} x {SSM_PROFILE_SEQ}")
    else:
        b = batch_of(seq, 10)
        _profile(lambda: step(state, b), dt, f"{tag} step {n} x {seq}")
    del state, step, model, metrics
    torch.cuda.empty_cache()


def ssm_phase():
    """The SSM and xLSTM families (``ssm ...`` lines): (a) the GLA core
    and the causal conv; then for each of ``zamba2-2.7b`` and
    ``xlstm-1.3b`` at full width and the depth of SSM_UNITS, seeded
    weights, (b) the f32 prefill and decode chain against ``apply_lm``,
    (c) the engine, (d) training.  No GSPN scan runs anywhere on these
    paths."""
    t0 = time.perf_counter()
    _ssm_core()
    for arch in SSM_ARCHS:
        _ssm_whole(arch)
        _ssm_serve(arch)
        _ssm_train(arch)
        print(f"ssm {arch}: done at {time.perf_counter() - t0:.3f} s of the "
              f"phase", flush=True)


# The MoE family (``moe ...`` lines, phase ``lm moe``): full width, the
# depth cut to what one card holds (PERF.md §4).  kimi runs its dense first
# layer and 1 of its 60 attn_moe layers under bf16 (19 934 645 248
# parameters, 39.9 GB; 79.7 GB in f32), grok 2 of its 64 layers in f32
# (11 450 578 944, 45.8 GB) and 1 under bf16 for training (6 530 598 912,
# 13.1 GB).
MOE_CUTS = {"kimi-k2-1t-a32b": (1, "bf16"), "grok-1-314b": (2, "f32")}
MOE_LAYER_TOKENS = (1024, 4)
MOE_SLOTS = 4
MOE_MAX_LEN = 4112
MOE_DECODE = 16
# The rounding-noise control runs apply_lm over 2 x 1024 tokens against
# 1 x 1024: at cap = t kimi's dense (E, cap, D) buffer holds 11.4 GB at
# 2064 tokens, and twice that would not fit beside its weights.
MOE_NOISE_LEN = 1024
MOE_TRAIN = ("grok-1-314b", 1, "bf16", 4096)
MOE_TRAIN_STEPS = 3


def _moe_model(arch, n_moe, precision, seed=0):
    """``arch``'s full width with ``n_moe`` attn_moe layers after its
    prelude, weights from a seeded generator on the card."""
    from repro_torch.configs.base import get_arch, with_precision
    from repro_torch.models import lm

    cfg = get_arch(arch).full()
    cfg = with_precision(dataclasses.replace(
        cfg, unit=(("attn_moe", n_moe),),
        n_layers=sum(n for _, n in cfg.prelude) + n_moe), precision)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.LM(cfg, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"moe {arch}: {lm.count_params(model)} parameters ({nbytes} "
          f"bytes; {cfg.layer_count()} of {get_arch(arch).full().n_layers} "
          f"layers: prelude {cfg.prelude}, unit {cfg.unit}; d_model "
          f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k} of hidden "
          f"{cfg.moe_d_ff}, shared expert {cfg.shared_expert_ff}, capacity "
          f"factor {cfg.capacity_factor}, vocab {cfg.vocab}), {precision} "
          f"policy, set-up {time.perf_counter() - t0:.3f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    return cfg, model


def _moe_twin(model, **changes):
    """A model over ``model``'s weights (assigned, not copied) under a
    config with ``changes``."""
    from repro_torch.models import lm

    twin = lm.LM(dataclasses.replace(model.cfg, **changes), device="meta")
    twin.load_state_dict(model.state_dict(), assign=True)
    return twin


@contextlib.contextmanager
def _moe_drops():
    """(dropped pairs, pairs, experts (t, k)) of every MoE call inside the
    block, read from a wrapper around the dispatch (one host sync a call:
    never inside a timed run)."""
    from repro_torch.models import moe

    seen, real = [], moe.dispatch

    def spy(experts, cap, n_experts):
        row, kept = real(experts, cap, n_experts)
        seen.append((int((~kept).sum()), kept.numel(), experts))
        return row, kept

    moe.dispatch = spy
    try:
        yield seen
    finally:
        moe.dispatch = real


def _drop_share(seen) -> float:
    return sum(c[0] for c in seen) / max(sum(c[1] for c in seen), 1)


def _rerouted(one, chain, n_moe) -> int:
    """Tokens whose set of experts in some MoE layer differs between a
    one-shot call (``n_moe`` calls, one a layer) and a chain of chunks
    (``n_moe`` calls a chunk), from ``_moe_drops`` records."""
    flips = 0
    for i in range(n_moe):
        a = one[i][2].sort(-1).values
        b = torch.cat([c[2] for c in chain[i::n_moe]]).sort(-1).values
        flips += int((a != b).any(-1).sum())
    return flips


def _moe_err(got, want, bf16: bool) -> float:
    """Relative L2 under bf16 products, else the largest error over the
    largest magnitude."""
    if not bf16:
        return _rel_err(got, want)
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _moe_layer(arch, model):
    """(a) The first attn_moe block's MoE alone at 1 x 1024 and 1 x 4
    tokens of random input against ``moe_per_expert`` (a loop over the
    experts): 1e-5 of the largest magnitude in f32, 1e-2 under bf16; its
    ms and the loop's, the share of dropped pairs.  Returns the shares."""
    from repro_torch.models.moe import capacity, moe_per_expert

    layer = next(b.moe for _, _, b in model.walk() if hasattr(b, "moe"))
    cfg, cd = layer.cfg, layer.policy.compute_dtype
    tol = 1e-5 if cd == torch.float32 else 1e-2
    gen = torch.Generator(device="cuda").manual_seed(5)
    shares = []
    for t in MOE_LAYER_TOKENS:
        x = torch.randn((1, t, cfg.dim), generator=gen, device="cuda").to(cd)
        with torch.no_grad():
            with _moe_drops() as seen:
                y, aux = layer(x)
            plain, dropped, pairs = moe_per_expert(layer, x)
            ms = _wall_s(lambda: layer(x), n=3) * 1e3
            plain_ms = _wall_s(lambda: moe_per_expert(layer, x), n=3) * 1e3
        err = _rel_err(y, plain)
        shares.append(dropped / pairs)
        print(f"moe {arch} layer {str(cd).split('.')[-1]} 1 x {t}: cap "
              f"{capacity(cfg, t)}, dropped {dropped} of {pairs} pairs "
              f"(share {dropped / pairs:.4f}); max_abs_err / largest vs the "
              f"per-expert loop {err:.3e} (tol {tol}); aux {aux.item():.6g}; "
              f"layer {ms:.3f} ms, loop {plain_ms:.3f} ms", flush=True)
        if not (torch.isfinite(y).all() and err <= tol
                and [c[:2] for c in seen] == [(dropped, pairs)]):
            raise AssertionError(f"moe {arch} layer 1 x {t}: the layer "
                                 f"disagrees with the per-expert loop")
    return shares


def _moe_whole(arch, model):
    """(b) Prefill against apply_lm at the config's capacity factor (the
    same call shape, so the same drops) and the drop shares of a chunk of
    SERVE_CHUNK, the CHECK_LEN one-shot prefill and a 4-slot decode step;
    then, on a twin at capacity factor E/k (cap >= t: nothing drops, the
    attention dense), the chunk chain against the one-shot prefill and
    MOE_DECODE decode steps against apply_lm.  The twin isolates the KV
    cache and chunk logic from the per-call capacity, which a chain or a
    decode step does not share with a one-shot call.  Bars: 1e-4 of the
    largest logit in f32, 1e-2 relative L2 under bf16, or four times the
    model's own rounding noise where that is larger, the larger of two
    controls measured here: apply_lm over two copies of MOE_NOISE_LEN
    tokens against one (other product shapes; under bf16 the card's
    products give the same bits at both batches, so it reads 0), and the
    one-shot prefill with attention in key blocks of ``attn_block_k``
    against dense (the attention's f32 sums in another order, rounded
    to the compute dtype: what a chunk's attention changes).  Top-k
    routing turns such a rounding into another choice of experts for the
    tokens near a tie; the line counts them."""
    from repro_torch.models import lm

    cfg = model.cfg
    bf16 = cfg.compute_dtype != torch.float32
    n = CHECK_LEN + MOE_DECODE
    n_moe = sum(k for _, kind, k in cfg.stages() if kind == "attn_moe")
    tag = f"moe {arch} {'bf16' if bf16 else 'f32'}"
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (MOE_SLOTS, n), device="cuda",
                         generator=gen)
    one = toks[:1]
    with torch.no_grad():
        with _moe_drops() as d_prefill:
            logits, _ = _no_scans(lambda: lm.lm_prefill(
                model, one[:, :CHECK_LEN], CHECK_LEN), "prefill", tag)
        full = lm.apply_lm(model, one[:, :CHECK_LEN])
        e_same = _moe_err(logits, full, bf16)
        del logits, full
        c = lm.init_lm_cache(cfg, 1, SERVE_CHUNK, device="cuda")
        with _moe_drops() as d_chunk:
            lm.lm_prefill_chunk(model, one[:, :SERVE_CHUNK], c, 0,
                                with_logits=False)
        _, c = lm.lm_prefill(model, toks[:, :16], 32)
        with _moe_drops() as d_decode:
            lm.lm_decode_step(model, toks[:, 16:17], c)
        del c
        print(f"{tag} at capacity factor {cfg.capacity_factor}: dropped "
              f"share of a chunk of {SERVE_CHUNK} "
              f"{_drop_share(d_chunk):.4f}, of the one-shot prefill of "
              f"{CHECK_LEN} {_drop_share(d_prefill):.4f}, of a "
              f"{MOE_SLOTS}-slot decode step {_drop_share(d_decode):.4f}",
              flush=True)

        cf = cfg.n_experts / cfg.top_k
        nodrop = _moe_twin(model, capacity_factor=cf, attn_block_k=n)
        # At cap = t kimi's buffers take 11.4 GB each: return the blocks
        # the earlier calls cached, so that one allocation can hold them.
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with _moe_drops() as d_one:
            pre, caches = lm.lm_prefill(nodrop, one[:, :CHECK_LEN], n)
        with _moe_drops() as d_chain:
            c = lm.init_lm_cache(nodrop.cfg, 1, n, device="cuda")
            parts = []
            for lo in range(0, CHECK_LEN, SERVE_CHUNK):
                part, c = lm.lm_prefill_chunk(
                    nodrop, one[:, lo:lo + SERVE_CHUNK], c, lo)
                parts.append(part)
            chain = torch.cat(parts, 1)
            del parts, c
        with _moe_drops() as d_rest:
            steps = []
            for i in range(CHECK_LEN, n):
                step, caches = lm.lm_decode_step(nodrop, one[:, i:i + 1],
                                                 caches)
                steps.append(step)
            del caches
            full = lm.apply_lm(nodrop, one)[:, CHECK_LEN:]
            half = one[:, :MOE_NOISE_LEN]
            batch2 = _moe_err(lm.apply_lm(nodrop, half.expand(2, -1))[:1],
                              lm.apply_lm(nodrop, half), bf16)
            blocks = _moe_twin(model, capacity_factor=cf)
            order = _moe_err(lm.lm_prefill(blocks, one[:, :CHECK_LEN],
                                           n)[0], pre, bf16)
            del blocks
        t_twin = time.perf_counter() - t0
    noise = max(batch2, order)
    bar = max(1e-2 if bf16 else 1e-4, 4 * noise)
    e_chain = _moe_err(chain, pre, bf16)
    e_decode = _moe_err(torch.cat(steps, 1), full, bf16)
    dropped = _drop_share(d_one + d_chain + d_rest)
    what = "relative L2" if bf16 else "max_abs_err / largest"
    print(f"{tag}: {what}: prefill vs apply_lm at capacity factor "
          f"{cfg.capacity_factor} {e_same:.3e}; at capacity factor {cf} "
          f"(cap >= t, {dropped} dropped; isolates the cache and chunk "
          f"logic from the per-call capacity): chunk chain "
          f"{CHECK_LEN // SERVE_CHUNK} x {SERVE_CHUNK} vs one-shot "
          f"{e_chain:.3e} ({_rerouted(d_one, d_chain, n_moe)} of "
          f"{CHECK_LEN} tokens routed to another expert set in some "
          f"layer), {MOE_DECODE} decode steps vs apply_lm of {n} "
          f"{e_decode:.3e}; rounding noise: apply_lm 2 x {MOE_NOISE_LEN} vs "
          f"1 {batch2:.3e}, prefill with attention blocks of "
          f"{cfg.attn_block_k} vs dense {order:.3e}; bar {bar:.3e}; "
          f"{t_twin:.3f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    if not (e_same <= bar and e_chain <= bar and e_decode <= bar
            and dropped == 0 and torch.isfinite(chain).all()
            and torch.isfinite(full).all()):
        raise AssertionError(f"{tag}: the cache paths disagree")
    del nodrop, pre, chain, steps, full
    torch.cuda.empty_cache()


def _moe_serve(arch, model, tag=None):
    """(c) The engine (MOE_SLOTS slots, chunks of SERVE_CHUNK, greedy,
    max_len MOE_MAX_LEN) over SERVE_PROMPTS, SERVE_NEW new tokens each:
    TTFT, tok/s, the median decode step and chunk, their device time, idle
    share and top kernels (profiler), peak memory, KV bytes a slot.  The
    lines start with ``tag`` (``moe <arch> serve`` by default)."""
    from repro_torch import obs
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = model.cfg
    tag = tag or f"moe {arch} serve"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(model, batch_size=MOE_SLOTS, max_len=MOE_MAX_LEN,
                      prefill_chunk=SERVE_CHUNK)
    if eng.prefill_chunk != SERVE_CHUNK:
        raise AssertionError(f"{tag}: the engine does not chunk")
    rng = torch.Generator().manual_seed(1)
    reqs = [Request(uid=i, prompt=torch.randint(0, cfg.vocab, (n,),
                                                generator=rng).numpy(),
                    max_new_tokens=SERVE_NEW)
            for i, n in enumerate(SERVE_PROMPTS)]
    handles = [eng.submit(r) for r in reqs]
    torch.cuda.synchronize()
    obs.clear()
    obs.enable()
    try:
        t0 = time.perf_counter()
        _no_scans(eng.run, "engine run", tag)
        dt = time.perf_counter() - t0
    finally:
        obs.disable()
    m = eng.metrics
    results = [h.result() for h in handles]
    total = sum(len(r.tokens) for r in results)
    for r, n in zip(results, SERVE_PROMPTS):
        print(f"{tag} request {r.uid}: prompt {n}, ttft "
              f"{r.ttft * 1e3:.3f} ms, queue {r.queue_delay * 1e3:.3f} ms, "
              f"chunks {r.prefill_chunks}, {len(r.tokens)} tokens "
              f"{r.tokens}", flush=True)
    ttft = sorted(r.ttft * 1e3 for r in results)
    step_ms = [sp.dur / 1e6 for sp in obs.spans("serve.decode_step")]
    chunk_ms = [sp.dur / 1e6 for sp in obs.spans("serve.prefill_chunk")]
    print(f"{tag} (parameters {str(cfg.param_dtype)[6:]}, products "
          f"{str(cfg.compute_dtype)[6:]}): {len(results)} requests, {total} "
          f"tokens in {dt:.3f} s ({total / dt:.3f} tok/s); TTFT p50 "
          f"{statistics.median(ttft):.3f} ms, p90 "
          f"{ttft[math.ceil(0.9 * len(ttft)) - 1]:.3f} ms; "
          f"{m['prefills']} one-shot prefills, {m['prefill_chunks']} chunks "
          f"(median {statistics.median(chunk_ms):.3f} ms), "
          f"{m['decode_steps']} decode steps (median "
          f"{statistics.median(step_ms):.3f} ms of {len(step_ms)}); KV "
          f"{eng.pool.nbytes // eng.bs} bytes a slot, pool "
          f"{eng.pool.nbytes} bytes; peak memory of the run "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    if [len(r.tokens) for r in results] != [SERVE_NEW] * len(reqs) or \
            not all(0 <= t < cfg.vocab for r in results for t in r.tokens):
        raise AssertionError(f"{tag}: wrong tokens")
    last, pooled = eng.last_token, eng.pool.caches
    c = lm.init_lm_cache(cfg, 1, MOE_MAX_LEN, device="cuda")
    ctoks = torch.from_numpy(reqs[0].prompt[:SERVE_CHUNK]).cuda()[None]
    with torch.no_grad():
        def decode():
            return lm.lm_decode_step(model, last, pooled)

        def chunk():
            return lm.lm_prefill_chunk(model, ctoks, c, SERVE_CHUNK,
                                       with_logits=False)

        _profile(decode, _wall_s(decode), f"{tag} decode step "
                 f"({MOE_SLOTS} slots)")
        _profile(chunk, _wall_s(chunk), f"{tag} chunk of {SERVE_CHUNK}")
    del eng, last, pooled, c
    torch.cuda.empty_cache()


def _moe_train():
    """(d) grok at MOE_TRAIN's cut under bf16, ``remat="unit"``: one
    warm-up, then MOE_TRAIN_STEPS timed ``lm_loss`` and gradients at
    1 x seq: ms, tokens/s, peak memory; the loss and aux finite, aux > 0;
    every gradient finite and nonzero, the router's and each expert's
    rows of every slab included; a profiled call."""
    from repro_torch.data.pipeline import DataConfig, host_batch, to_device
    from repro_torch.models import lm

    arch, n_moe, precision, seq = MOE_TRAIN
    cfg, model = _moe_model(arch, n_moe, precision, seed=4)
    if cfg.remat != "unit":
        raise AssertionError(f"{arch} full() rematerialises {cfg.remat!r}")
    tag = f"moe {arch} train"
    params = list(model.parameters())
    names = [nm for nm, _ in model.named_parameters()]

    def batch(step):
        return to_device(host_batch(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                               global_batch=1), step), "cuda")

    def loss_and_grads(b):
        loss, parts = lm.lm_loss(model, b)
        return loss, parts, torch.autograd.grad(loss, params)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _no_scans(lambda: loss_and_grads(batch(0)), "warm-up", tag)
    print(f"{tag} warm-up 1 x {seq}: "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
    times = []
    for i in range(MOE_TRAIN_STEPS):
        b = batch(1 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, parts, grads = loss_and_grads(b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i + 1 < MOE_TRAIN_STEPS:
            del grads
    dt = statistics.median(times)
    bad = [nm for nm, g in zip(names, grads)
           if not (torch.isfinite(g).all() and g.abs().max() > 0)]
    for nm, g in zip(names, grads):
        if nm.endswith("_slab"):
            bad += [f"{nm}[expert {e}]" for e in range(g.shape[1])
                    if not g[0, e].abs().max() > 0]
    router = sum(nm.endswith("moe.router") for nm in names)
    print(f"{tag} 1 x {seq} tokens, {precision}, remat unit, lm_loss and "
          f"gradients: median {dt * 1e3:.3f} ms of {MOE_TRAIN_STEPS} "
          f"({[round(t * 1e3, 3) for t in times]}), {seq / dt:.1f} tokens/s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"loss {loss.item():.6g}, ce {parts['ce'].item():.6g}, aux "
          f"{parts['aux'].item():.6g}; {len(names)} gradients ({router} "
          f"routers), {len(bad)} not finite and nonzero {bad[:5]}",
          flush=True)
    if bad or not router or not math.isfinite(loss.item()) or \
            not parts["aux"].item() > 0:
        raise AssertionError(f"{tag}: loss, aux or gradients wrong")
    del grads, loss, parts
    b = batch(9)
    _profile(lambda: loss_and_grads(b), dt, f"{tag} lm_loss and gradients "
             f"1 x {seq}")
    del model, params, b
    torch.cuda.empty_cache()

    # A whole AdamW step at this cut does not fit one card: with bf16
    # moments it ran out of memory at 72.9 GiB (PERF.md §7).  The step
    # runs through the train launcher on the reduced config, on the card.
    _launch_train(tag, ["--arch", arch, "--reduced", "--steps", "2",
                        "--batch", "2", "--seq", "64"], "moe_ckpt")


def moe_phase():
    """The MoE family (``moe ...`` lines): for ``kimi-k2-1t-a32b`` and
    ``grok-1-314b`` at full width and cut depth with seeded weights, (a)
    the layer against a per-expert loop, (b) the cache paths, (c) the
    engine (grok under its own policy over the f32 weights), then (d)
    grok's loss and gradients.  No GSPN scan runs on these paths."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    kimi_shares = []
    for arch, (n_moe, precision) in MOE_CUTS.items():
        cfg, model = _moe_model(arch, n_moe, precision)
        shares = _moe_layer(arch, model)
        if arch.startswith("kimi"):
            kimi_shares = shares
        _moe_whole(arch, model)
        # grok serves under its own policy: its f32 weights, bf16 products.
        served = model if precision != "f32" else _moe_twin(
            model, compute_dtype=torch.bfloat16)
        _moe_serve(arch, served)
        del model, served
        torch.cuda.empty_cache()
        print(f"moe {arch}: done at {time.perf_counter() - t0:.3f} s of the "
              f"phase", flush=True)
    if not any(kimi_shares):
        raise AssertionError("moe kimi: no case of the layer dropped a pair")
    _moe_train()


# The VL family (``vl ...`` lines, phase ``lm vl``): qwen2-vl-72b at full
# width, its depth cut to VL_LAYERS of 80 (4 246 794 240 parameters, 17.0
# GB in f32; at 4 layers the smoke ran past 1000 s, PERF.md §4), seeded
# weights; the vision frontend is the reference's stub: random
# embeddings in place of the first positions.
VL_ARCH = "qwen2-vl-72b"
VL_LAYERS = 1
VL_VISION = 1024
VL_DECODE = 4
VL_IMAGE_DECODE = 16
VL_TRAIN = (4096, 2048)          # tokens, vision positions
VL_TRAIN_STEPS = 2


def _vl_model():
    """The cut model in f32 on the card, weights from a seeded generator."""
    from repro_torch.configs.base import get_arch, with_precision
    from repro_torch.models import lm

    full = get_arch(VL_ARCH).full()
    cfg = with_precision(dataclasses.replace(
        full, unit=(("attn", VL_LAYERS),), n_layers=VL_LAYERS), "f32")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.LM(cfg, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"vl {VL_ARCH}: {lm.count_params(model)} parameters ({nbytes} "
          f"bytes; {VL_LAYERS} of {full.n_layers} layers; d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads}, head "
          f"dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, M-RoPE "
          f"{cfg.mrope_sections}, theta {cfg.rope_theta}), set-up "
          f"{time.perf_counter() - t0:.3f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    return cfg, model


def _grid_positions(b, s, sv, device):
    """(3, b, s) ids as Qwen2-VL gives an image: frame 0, a row and a
    column of a sqrt(sv)-wide patch grid, then text at max + 1 on."""
    side = math.isqrt(sv)
    i = torch.arange(sv, device=device)
    grid = torch.stack([torch.zeros_like(i), i // side, i % side])
    text = torch.arange(s - sv, device=device) + side
    pos = torch.cat([grid, text.expand(3, -1)], dim=1)
    return pos[:, None].expand(3, b, s).contiguous()


def _vl_mrope():
    """(a) apply_mrope at the model's head shape, (1, 2048, 64, 128), with
    three distinct planes against an f64 evaluation (1e-5 of the largest
    magnitude), and with three equal planes bit for bit apply_rope.  The
    f64 evaluation takes the angles as f32 rounds them (position times
    frequency, as the reference and rope compute them): at text position
    1 000 an f32 angle is off by up to 3e-5 rad, a rounding of rope
    itself, which the line prints beside the bar."""
    from repro_torch.models.layers import apply_mrope, apply_rope, rope_freqs

    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((1, CHECK_LEN, 64, 128), generator=gen, device="cuda")
    pos = _grid_positions(1, CHECK_LEN, VL_VISION, "cuda")
    sections, theta = (16, 24, 24), 1e6
    got = apply_mrope(x, pos, sections, theta)
    freqs = 1.0 / (theta ** (torch.arange(0, 128, 2, device="cuda",
                                          dtype=torch.float64) / 128))
    plane = torch.repeat_interleave(torch.arange(3, device="cuda"),
                                    torch.tensor(sections, device="cuda"))
    sel = pos.permute(1, 2, 0)[..., plane]

    def rotated(ang):
        cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
        x1, x2 = x.double().chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    f32 = rope_freqs(128, theta, device="cuda")
    err = _rel_err(got, rotated((sel.float() * f32).double()))
    err_exact = _rel_err(got, rotated(sel.double() * freqs))
    flat = pos[1]
    same = torch.equal(apply_mrope(x, flat[None].expand(3, -1, -1),
                                   sections, theta),
                       apply_rope(x, flat, theta))
    ms = _wall_s(lambda: apply_mrope(x, pos, sections, theta)) * 1e3
    rope_ms = _wall_s(lambda: apply_rope(x, flat, theta)) * 1e3
    print(f"vl mrope (1, {CHECK_LEN}, 64, 128) sections {sections}: "
          f"max_abs_err / largest vs f64 of the f32 angles {err:.3e} (tol "
          f"1e-5), vs f64 angles {err_exact:.3e}; equal planes "
          f"bit-equal to rope {same}; {ms:.3f} ms, rope {rope_ms:.3f} ms",
          flush=True)
    if not (err <= 1e-5 and same):
        raise AssertionError("vl mrope: disagrees")


def _vl_f32(model):
    """(b) Under f32: lm_prefill of 1 x CHECK_LEN tokens, the first
    VL_VISION of them vision embeddings, against apply_lm; VL_DECODE
    decode steps against apply_lm over the extended tokens; a chain of
    text chunks of SERVE_CHUNK against the one-shot prefill; apply_lm at
    (3, B, S) ids of three equal planes bit for bit the 2-D call.  Bar
    1e-4 of the largest logit, or four times the model's own rounding
    noise (apply_lm over 2 copies against 1) where that is larger."""
    from repro_torch.models import lm

    cfg = model.cfg
    n = CHECK_LEN + VL_DECODE
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (1, n), device="cuda", generator=gen)
    ve = torch.randn((1, VL_VISION, cfg.d_model), generator=gen,
                     device="cuda")
    one = toks[:, :CHECK_LEN]
    t0 = time.perf_counter()
    with torch.no_grad():
        pre, caches = lm.lm_prefill(model, one, n, vision_embeds=ve)
        full = lm.apply_lm(model, toks, vision_embeds=ve)
        e_pre = _rel_err(pre, full[:, :CHECK_LEN])
        steps = []
        for i in range(CHECK_LEN, n):
            step, caches = lm.lm_decode_step(model, toks[:, i:i + 1], caches)
            steps.append(step)
        e_dec = _rel_err(torch.cat(steps, 1), full[:, CHECK_LEN:])
        del caches, steps
        twice = lm.apply_lm(model, one.expand(2, -1),
                            vision_embeds=ve.expand(2, -1, -1))[:1]
        flat = lm.apply_lm(model, one, vision_embeds=ve)
        noise = _rel_err(twice, flat)
        del twice
        planes = lm.apply_lm(model, one, vision_embeds=ve,
                             positions=torch.arange(
                                 CHECK_LEN, device="cuda")[None, None]
                             .expand(3, 1, -1))
        same = torch.equal(planes, flat)
        grid = lm.apply_lm(model, one, vision_embeds=ve,
                           positions=_grid_positions(1, CHECK_LEN, VL_VISION,
                                                     "cuda"))
        grid_ok = bool(torch.isfinite(grid).all()) and not torch.equal(
            grid, flat)
        del planes, grid, flat
        text, _ = lm.lm_prefill(model, one, n)
        c = lm.init_lm_cache(cfg, 1, n, device="cuda")
        parts = []
        for lo in range(0, CHECK_LEN, SERVE_CHUNK):
            part, c = lm.lm_prefill_chunk(model, one[:, lo:lo + SERVE_CHUNK],
                                          c, lo)
            parts.append(part)
        e_chain = _rel_err(torch.cat(parts, 1), text)
        del parts, c, text
    bar = max(1e-4, 4 * noise)
    print(f"vl f32: max_abs_err / largest logit: prefill of {CHECK_LEN} "
          f"({VL_VISION} vision) vs apply_lm {e_pre:.3e}, {VL_DECODE} decode "
          f"steps vs apply_lm of {n} {e_dec:.3e}, chain "
          f"{CHECK_LEN // SERVE_CHUNK} x {SERVE_CHUNK} vs one-shot "
          f"{e_chain:.3e}; noise control (2 copies vs 1) {noise:.3e}, bar "
          f"{bar:.3e}; (3, B, S) equal planes bit-equal to (B, S) {same}; "
          f"patch-grid ids finite and other than text ids {grid_ok}; "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    if not (e_pre <= bar and e_dec <= bar and e_chain <= bar and same
            and grid_ok and torch.isfinite(full).all()):
        raise AssertionError("vl f32: the paths disagree")
    del full, pre
    torch.cuda.empty_cache()


def _vl_image(model):
    """(c) One image request under the model's own policy: lm_prefill of a
    CHECK_LEN-token prompt whose first VL_VISION positions are vision
    embeddings, then VL_IMAGE_DECODE greedy decode steps: TTFT, the
    median step, tok/s, the idle share of a step."""
    from repro_torch.models import lm

    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (1, CHECK_LEN), device="cuda",
                         generator=gen)
    ve = torch.randn((1, VL_VISION, cfg.d_model), generator=gen,
                     device="cuda")
    with torch.no_grad():
        lm.lm_prefill(model, toks, MOE_MAX_LEN, vision_embeds=ve)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = lm.lm_prefill(model, toks, MOE_MAX_LEN,
                                       vision_embeds=ve)
        tok = logits[:, -1:].argmax(-1)
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        times, out = [], [int(tok)]
        for _ in range(VL_IMAGE_DECODE - 1):
            t1 = time.perf_counter()
            logits, caches = lm.lm_decode_step(model, tok, caches)
            tok = logits[:, -1:].argmax(-1)
            out.append(int(tok))
            times.append(time.perf_counter() - t1)
        total = time.perf_counter() - t0

        def step():
            return lm.lm_decode_step(model, tok, caches)

        print(f"vl image request (own policy): prompt {CHECK_LEN} "
              f"({VL_VISION} vision), TTFT {ttft * 1e3:.3f} ms, "
              f"{VL_IMAGE_DECODE} tokens in {total:.3f} s "
              f"({VL_IMAGE_DECODE / total:.3f} tok/s), decode step median "
              f"{statistics.median(times) * 1e3:.3f} ms; tokens {out}",
              flush=True)
        _profile(step, _wall_s(step), "vl image decode step (1 slot)")
    if not all(0 <= t < cfg.vocab for t in out):
        raise AssertionError("vl image request: wrong tokens")
    del caches, logits
    torch.cuda.empty_cache()


def _vl_train(model):
    """(d) lm_loss and its gradients at 1 x VL_TRAIN[0] tokens, the first
    VL_TRAIN[1] of them vision embeddings, remat "unit", the model's own
    policy: one warm-up, VL_TRAIN_STEPS timed calls: ms, tokens/s, peak
    memory; every gradient finite and nonzero.  Then two AdamW steps of
    the reduced config through launch/train.py (at this cut AdamW's f32
    moments would add 48 GB to the 48 GB of weights and gradients)."""
    from repro_torch.data.pipeline import DataConfig, host_batch, to_device
    from repro_torch.models import lm

    cfg = model.cfg
    seq, sv = VL_TRAIN
    if cfg.remat != "unit":
        raise AssertionError(f"{VL_ARCH} full() rematerialises {cfg.remat!r}")
    tag = "vl train"
    params = list(model.parameters())
    names = [nm for nm, _ in model.named_parameters()]
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=1,
                      vision_len=sv, d_model=cfg.d_model)

    def loss_and_grads(b):
        loss, _ = lm.lm_loss(model, b)
        return loss, torch.autograd.grad(loss, params)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    b = to_device(host_batch(dcfg, 0), "cuda")
    t0 = time.perf_counter()
    loss_and_grads(b)
    torch.cuda.synchronize()
    print(f"{tag} warm-up 1 x {seq}: "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms", flush=True)
    times = []
    for i in range(VL_TRAIN_STEPS):
        b = to_device(host_batch(dcfg, 1 + i), "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i + 1 < VL_TRAIN_STEPS:
            del grads
    dt = statistics.median(times)
    bad = [nm for nm, g in zip(names, grads)
           if not (torch.isfinite(g).all() and g.abs().max() > 0)]
    print(f"{tag} 1 x {seq} tokens ({sv} vision), own policy, remat unit, "
          f"lm_loss and gradients: median {dt * 1e3:.3f} ms of "
          f"{VL_TRAIN_STEPS} ({[round(t * 1e3, 3) for t in times]}), "
          f"{seq / dt:.1f} tokens/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; loss "
          f"{loss.item():.6g}; {len(names)} gradients, {len(bad)} not "
          f"finite and nonzero {bad[:5]}", flush=True)
    if bad or not math.isfinite(loss.item()):
        raise AssertionError(f"{tag}: loss or gradients wrong")
    del grads, loss, b, params
    torch.cuda.empty_cache()
    _launch_train(tag, ["--arch", VL_ARCH, "--reduced", "--steps", "2",
                        "--batch", "2", "--seq", "64"], "vl_ckpt")


def _scans_ran(tag):
    """Fail if a GSPN scan ran since the counters were last set to 0."""
    from repro_torch.kernels import cuda_lib

    if cuda_lib.launch_counts or cuda_lib.plain_calls:
        raise AssertionError(f"{tag}: a scan ran: "
                             f"{dict(cuda_lib.launch_counts)}, "
                             f"{dict(cuda_lib.plain_calls)}")


def _launch_train(tag, argv, ckpt_name):
    """Two AdamW steps through launch/train.py on the card with tracing
    on: the steps' seconds (its ``train.step`` spans) and losses.  The
    launcher sets the counters to 0, so those of the phase so far are read
    first.  Returns the Trainer."""
    import shutil

    from repro_torch import obs
    from repro_torch.launch import train as launch_train

    _scans_ran(tag)
    ckpt = ROOT / "build" / ckpt_name
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    obs.clear()
    obs.enable()
    try:
        t0 = time.perf_counter()
        tr = launch_train.main(argv + ["--ckpt-dir", str(ckpt)])
        dt = time.perf_counter() - t0
        steps = [round(sp.dur / 1e9, 3) for sp in obs.spans("train.step")]
    finally:
        obs.disable()
    print(f"{tag} launch/train.py {' '.join(argv)} on {tr.device}: "
          f"{tr.step} AdamW steps of {steps} s, losses {tr.history}, "
          f"{dt:.3f} s with set-up; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    if tr.step != 2 or tr.device.type != "cuda" or \
            not all(map(math.isfinite, tr.history)):
        raise AssertionError(f"{tag}: the launcher's AdamW steps failed")
    return tr


def vl_phase():
    """qwen2-vl-72b (``vl ...`` lines): (a) M-RoPE, (b) the f32 cache
    paths with vision embeddings, (c) the engine on text requests and one
    image request under the model's own policy (f32 weights, bf16
    products), (d) loss and gradients, then AdamW through the launcher.
    No GSPN scan and no kernel of the port runs on these paths."""
    from repro_torch.kernels import cuda_lib

    torch.cuda.empty_cache()
    cuda_lib.clear_counts()
    _vl_mrope()
    cfg, model = _vl_model()
    _vl_f32(model)
    own = _moe_twin(model, compute_dtype=torch.bfloat16)
    del model
    # The engine's run sets the counters to 0: read those of the phase.
    _scans_ran("vl")
    _moe_serve(VL_ARCH, own, tag="vl serve")
    _vl_image(own)
    _vl_train(own)
    del own
    torch.cuda.empty_cache()
    _scans_ran("vl")
    print("vl: #1-#5 launched 0 times in the phase", flush=True)


# The encoder-decoder family (``audio ...`` lines, phase ``lm audio``):
# whisper-base whole (6 + 6 layers, 98 505 728 parameters), seeded
# weights; the conv frontend is the reference's stub: random frames.
AUDIO_ARCH = "whisper-base"
AUDIO_CLIPS = 4
AUDIO_PROMPTS = (4, 16, 40, 64)
AUDIO_CHECK_DECODE = 8
AUDIO_MAX_LEN = 448              # Whisper's trained context
AUDIO_PROMPT = 4                 # the start-of-transcript tokens
AUDIO_NEW = 8


def _audio_attention():
    """(a) The encoder's self-attention at 1 x 1500 frames, 8 heads of 64:
    blockwise non-causal (block_k 512 halves to 4: 375 blocks) against the
    dense non-causal path, forward and gradients within 1e-5 of the
    largest magnitude; ms of each forward."""
    from repro_torch.models import attention

    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v, ct = (torch.randn((1, 1500, 8, 64), generator=gen,
                               device="cuda") for _ in range(4))
    fns = {"blockwise": lambda *a: attention.chunked_attention(
               *a, causal=False, block_k=512),
           "dense": lambda *a: attention.full_attention(*a, causal=False)}
    outs, ms = {}, {}
    for name, fn in fns.items():
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ins)
        outs[name] = (out, *torch.autograd.grad(out, ins, ct))
        with torch.no_grad():
            ms[name] = _wall_s(lambda: fn(q, k, v), n=3) * 1e3
    errs = [_rel_err(g, w) for g, w in zip(outs["blockwise"], outs["dense"])]
    print(f"audio attention 1 x 1500 non-causal, 375 blocks of 4: "
          f"max_abs_err / largest vs dense (out, dq, dk, dv) "
          f"{[f'{e:.3e}' for e in errs]} (tol 1e-5); forward blockwise "
          f"{ms['blockwise']:.3f} ms, dense {ms['dense']:.3f} ms", flush=True)
    if max(errs) > 1e-5:
        raise AssertionError("audio attention: blockwise disagrees")


def _audio_model():
    from repro_torch.configs.base import get_arch, with_precision
    from repro_torch.models import lm

    cfg = with_precision(get_arch(AUDIO_ARCH).full(), "f32")
    t0 = time.perf_counter()
    model = lm.LM(cfg, device="cuda",
                  generator=torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    print(f"audio {AUDIO_ARCH}: {lm.count_params(model)} parameters "
          f"({cfg.encoder_layers} encoder + {cfg.n_layers} decoder layers, "
          f"d_model {cfg.d_model}, {cfg.enc_len} frames, vocab {cfg.vocab}), "
          f"set-up {time.perf_counter() - t0:.3f} s", flush=True)
    return cfg, model


def _audio_f32(model, frames):
    """(b) Under f32, each clip with its own prompt (AUDIO_PROMPTS
    tokens): lm_encode of the clips, each clip's lm_prefill(enc_kv=)
    against apply_lm(enc_frames=); then AUDIO_CHECK_DECODE decode steps
    of the clips together, their caches stacked (each row at its own
    length, as in the engine), against apply_lm over the extended
    tokens, with max_len AUDIO_MAX_LEN.  apply_lm runs the clips in one
    batch, each row's tokens followed by padding, which no earlier
    position reads.  Bar 1e-4 of the largest logit, or four times the
    noise control (apply_lm over 2 copies of a clip against 1) where that
    is larger."""
    from repro_torch.models import lm

    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(4)
    width = max(AUDIO_PROMPTS) + AUDIO_CHECK_DECODE
    toks = torch.randint(0, cfg.vocab, (len(AUDIO_PROMPTS), width),
                         device="cuda", generator=gen)
    t0 = time.perf_counter()
    with torch.no_grad():
        kv = lm.lm_encode(model, frames)
        full = lm.apply_lm(model, toks, enc_frames=frames)
        pres, caches = [], []
        for i, n in enumerate(AUDIO_PROMPTS):
            pre, c = lm.lm_prefill(model, toks[i:i + 1, :n], AUDIO_MAX_LEN,
                                   enc_kv=tuple(t[i:i + 1] for t in kv))
            pres.append(pre)
            caches.append(c)
        # A stage's leaves carry (n_units, n) before the batch axis.
        caches = {key: {name: torch.cat([c[key][name] for c in caches], 2)
                        for name in caches[0][key]} for key in caches[0]}
        rows = torch.arange(len(AUDIO_PROMPTS), device="cuda")
        at = torch.tensor(AUDIO_PROMPTS, device="cuda")
        steps = []
        for j in range(AUDIO_CHECK_DECODE):
            step, caches = lm.lm_decode_step(
                model, toks[rows, at + j][:, None], caches, enc_kv=kv)
            steps.append(step)
        steps = torch.cat(steps, 1)
        errs = [(_rel_err(pre, full[i:i + 1, :n]),
                 _rel_err(steps[i], full[i, n:n + AUDIO_CHECK_DECODE]))
                for i, (pre, n) in enumerate(zip(pres, AUDIO_PROMPTS))]
        one = toks[:1, :AUDIO_PROMPTS[0] + AUDIO_CHECK_DECODE]
        noise = _rel_err(lm.apply_lm(model, one.expand(2, -1),
                                     enc_frames=frames[:1].expand(2, -1, -1))
                         [:1], lm.apply_lm(model, one, enc_frames=frames[:1]))
    bar = max(1e-4, 4 * noise)
    print(f"audio f32: max_abs_err / largest logit (prefill vs apply_lm, "
          f"{AUDIO_CHECK_DECODE} decode steps of the {len(AUDIO_PROMPTS)} "
          f"clips together vs apply_lm) for prompts "
          f"{AUDIO_PROMPTS}: {[(f'{a:.3e}', f'{b:.3e}') for a, b in errs]}; "
          f"noise control {noise:.3e}, bar {bar:.3e}; "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    if max(max(e) for e in errs) > bar:
        raise AssertionError("audio f32: the paths disagree")


def _audio_serve(model, frames):
    """(c) Under the model's own policy, AUDIO_CLIPS clips batched with a
    prompt of AUDIO_PROMPT tokens, AUDIO_NEW greedy tokens each: the
    encoder's, the prefill's and a decode step's ms, tok/s, the idle
    share and the share of a decode step under the cross-attention's
    spans; the engine refuses the model."""
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine

    cfg = model.cfg
    tag = "audio serve"
    gen = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (AUDIO_CLIPS, AUDIO_PROMPT),
                         device="cuda", generator=gen)
    with torch.no_grad():
        lm.lm_encode(model, frames)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kv = lm.lm_encode(model, frames)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        logits, caches = lm.lm_prefill(model, toks, AUDIO_MAX_LEN, enc_kv=kv)
        tok = logits[:, -1:].argmax(-1)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0 - t_enc
        times = []
        for _ in range(AUDIO_NEW - 1):
            t1 = time.perf_counter()
            logits, caches = lm.lm_decode_step(model, tok, caches, enc_kv=kv)
            tok = logits[:, -1:].argmax(-1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        total = time.perf_counter() - t0

        def step():
            return lm.lm_decode_step(model, tok, caches, enc_kv=kv)

        n = AUDIO_CLIPS * AUDIO_NEW
        print(f"{tag} (own policy) {AUDIO_CLIPS} clips x {cfg.enc_len} "
              f"frames, prompt {AUDIO_PROMPT}, {AUDIO_NEW} new tokens each: "
              f"encoder {t_enc * 1e3:.3f} ms, prefill {t_pre * 1e3:.3f} ms, "
              f"decode step median {statistics.median(times) * 1e3:.3f} ms; "
              f"{n} tokens in {total:.3f} s ({n / total:.3f} tok/s)",
              flush=True)
        # The idle shares read the wall times measured above: another
        # eager run of these host-bound calls costs seconds.
        _profile(step, statistics.median(times), f"{tag} decode step "
                 f"({AUDIO_CLIPS} clips)", spans="lm.cross_attention")
        _busy_profile(lambda: lm.lm_encode(model, frames), t_enc,
                      f"{tag} encoder ({AUDIO_CLIPS} clips)")
    try:
        ServeEngine(model, batch_size=AUDIO_CLIPS, max_len=AUDIO_MAX_LEN)
    except ValueError as exc:
        print(f"{tag}: the engine refuses {AUDIO_ARCH}: {exc}", flush=True)
    else:
        raise AssertionError(f"{tag}: the engine took an encoder-decoder")


def _audio_train():
    """(d) Two AdamW steps of the whole model through launch/train.py at
    AUDIO_CLIPS x AUDIO_MAX_LEN tokens and enc_len frames: step seconds;
    every moment finite; the moments of the encoder's and the K/V
    projection's leaves nonzero (their gradients were), those of every
    xattn.wk and xattn.wv exactly 0 (their gradients were exact zeros)."""
    tag = "audio train"
    tr = _launch_train(tag, ["--arch", AUDIO_ARCH, "--steps", "2", "--batch",
                             str(AUDIO_CLIPS), "--seq", str(AUDIO_MAX_LEN)],
                       "audio_ckpt")
    m, v = tr.state["opt"]["m"], tr.state["opt"]["v"]
    finite = all(torch.isfinite(t).all() for t in (*m.values(),
                                                    *v.values()))
    enc = [n for n in m if n.startswith(("encoder.", "enc_kv_proj."))]
    dead = [n for n in enc if not m[n].abs().max() > 0]
    unread = [n for n in m if n.endswith(("xattn.wk", "xattn.wv"))]
    moved = [n for n in unread if m[n].abs().max() > 0 or v[n].abs().max()]
    print(f"{tag}: data enc_len {tr.data_cfg.enc_len}; moments finite "
          f"{finite}; {len(enc)} encoder and K/V leaves, {len(dead)} with a "
          f"zero moment {dead[:3]}; {len(unread)} xattn.wk/wv leaves, "
          f"{len(moved)} with a nonzero moment", flush=True)
    if not finite or dead or moved or len(unread) != 12 or \
            tr.data_cfg.enc_len != 1500:
        raise AssertionError(f"{tag}: the gradients are wrong")


def audio_phase():
    """whisper-base (``audio ...`` lines): (a) the encoder's non-causal
    blockwise attention, (b) the f32 paths against apply_lm, (c) batched
    greedy decoding under the model's own policy and the engine's
    refusal, (d) two AdamW steps of the whole model.  No GSPN scan and no
    kernel of the port runs on these paths."""
    from repro_torch.kernels import cuda_lib

    torch.cuda.empty_cache()
    cuda_lib.clear_counts()
    _audio_attention()
    cfg, model = _audio_model()
    frames = torch.randn((AUDIO_CLIPS, cfg.enc_len, cfg.d_model),
                         generator=torch.Generator(device="cuda")
                         .manual_seed(6), device="cuda")
    _audio_f32(model, frames)
    _audio_serve(_moe_twin(model, compute_dtype=torch.bfloat16), frames)
    del model
    _audio_train()
    _scans_ran("audio")
    print("audio: #1-#5 launched 0 times in the phase", flush=True)


# ---------------------------------------------------------------------------
# The roofline phase: sharded serving, the roofline of measured paths, the
# dry run of three production cells.
# ---------------------------------------------------------------------------

# (a) The sharded serving runs: (arch, model ranks, prompt tokens), each
# followed by RL_DECODE greedy decode steps, under the f32 policy.
RL_SERVE = (("qwen2-1.5b-gspn", 2, 4096), ("qwen2-1.5b", 4, 1024))
RL_DECODE = 16
RL_SEED = 11
RL_PREFILLS = 3                  # rank 0 times this many prefills
# (c) The production cells dry-run on meta, single mesh.
RL_CELLS = (("lm", "qwen2-1.5b-gspn", "train_4k"),
            ("lm", "qwen2-1.5b", "decode_32k"),
            ("vision", "gspn2-b", "img_infer_1024"))


def _rl_cfg(arch):
    from repro_torch.configs.base import get_arch, with_precision
    return with_precision(get_arch(arch).full(), "f32")


def _rl_tokens(cfg, prompt, device):
    gen = torch.Generator().manual_seed(RL_SEED)
    return torch.randint(0, cfg.vocab, (1, prompt), generator=gen) \
        .to(device)


def _rl_greedy(model, tokens, max_len, ctx=None, counted=None,
               steps=RL_DECODE, vision_embeds=None, enc_kv=None):
    """``lm_prefill`` of ``tokens`` (with ``vision_embeds`` in place of the
    first embeddings) then ``steps`` greedy decode steps, row 0's choice
    fed to every row, the xattn blocks reading ``enc_kv``: (every step's
    last logits of row 0 (steps + 1, V) on the host, the tokens chosen,
    the prefill's caches).  ``counted(what, fn)`` wraps each call."""
    from repro_torch.models import lm
    counted = counted or (lambda what, fn: fn())
    with torch.no_grad():
        logits, caches = counted("prefill", lambda: lm.lm_prefill(
            model, tokens, max_len, ctx=ctx, vision_embeds=vision_embeds,
            enc_kv=enc_kv))
        first = caches
        last = [logits[:1, -1].float().cpu()]
        chosen = [int(logits[0, -1].argmax())]
        for i in range(steps):
            tok = torch.full((tokens.shape[0], 1), chosen[-1],
                             device=tokens.device)
            logits, caches = counted(f"decode {i}", lambda: lm.lm_decode_step(
                model, tok, caches, ctx=ctx, enc_kv=enc_kv))
            last.append(logits[:1, -1].float().cpu())
            chosen.append(int(logits[0, -1].argmax()))
    return torch.cat(last), chosen, first


def roofline_worker(mode: str, out: str) -> None:
    """One rank of the roofline phase's sharded serving (a), started by
    :func:`_spawn_ranks`: the f32 model of ``mode`` (an arch of
    RL_SERVE) from RL_SEED, sharded over (data 1, model M); rank 0 counts
    FLOPs over its first prefill (``FlopCounterMode``), times
    RL_PREFILLS prefills and reads its peak memory; every rank counts
    #1's launches and the plain calls of each call.  Rank 0 writes every
    rank's results to ``out`` and its logits beside it."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.mesh import (init_distributed,
                                         make_mesh_for_devices)
    from repro_torch.models import lm
    from repro_torch.parallel.tensor_parallel import shard_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    init_distributed(torch.device("cuda"))
    rank, world = dist.get_rank(), dist.get_world_size()
    arch, m, prompt = next(c for c in RL_SERVE if c[0] == mode)
    cfg = _rl_cfg(arch)
    model = lm.LM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(RL_SEED))
    mesh = make_mesh_for_devices(range(m), model_parallel=m,
                                 device_type="cuda")
    shard_model(model, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    ctx = lm.Ctx(mesh=mesh)
    tokens = _rl_tokens(cfg, prompt, "cuda")
    max_len = prompt + RL_DECODE
    res = {"launches": {}, "plain": {}}

    def counted(what, fn):
        torch.cuda.synchronize()
        cuda_lib.clear_counts()
        if what == "prefill":
            torch.cuda.reset_peak_memory_stats()
            with FlopCounterMode(display=False) as fc:
                out_ = fn()
            torch.cuda.synchronize()
            res["flops"] = fc.get_total_flops()
            res["peak_bytes"] = torch.cuda.max_memory_allocated()
        else:
            out_ = fn()
            torch.cuda.synchronize()
        res["launches"][what] = dict(cuda_lib.launch_counts)
        res["plain"][what] = sum(cuda_lib.plain_calls.values())
        return out_

    logits, chosen, caches = _rl_greedy(model, tokens, max_len, ctx, counted)
    res["cache_shapes"] = {k: {n: list(v.shape) for n, v in sub.items()}
                           for k, sub in caches.items()}
    del caches
    times = []
    with torch.no_grad():
        for _ in range(RL_PREFILLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lm.lm_prefill(model, tokens, max_len, ctx=ctx)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    res["prefill_ms"] = times
    res["tokens"] = chosen
    every = [None] * world
    dist.all_gather_object(every, res)
    dist.destroy_process_group()
    if rank == 0:
        torch.save(logits, pathlib.Path(out).with_suffix(".pt"))
        pathlib.Path(out).write_text(json.dumps(every))


def _rl_lm_step(device):
    """The LM train step of the ``lm train`` phase (b): ``qwen2-1.5b-gspn``
    ``full()`` under its own policy, remat "unit", AdamW, on ``device``:
    (step, state, batch)."""
    from repro_torch.configs.qwen2_1_5b_gspn import full
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import build_train_step, init_train_state

    cfg = full()
    model = lm.LM(cfg, device=device, generator=None if device == "meta"
                  else torch.Generator(device=device).manual_seed(3))
    ocfg = AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=100)
    gen = torch.Generator().manual_seed(5)
    batch = {k: torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                              generator=gen, dtype=torch.int64)
             .to(torch.int32).to(device) for k in ("tokens", "labels")}
    return build_train_step(model, ocfg), init_train_state(model, ocfg), \
        batch


def _rl_vision_step(device):
    """The GSPN-2-T train step of the ``train`` phase (b): the trainer
    twin's step (``examples/train_vision_torch.py``) at batch 64, 224²,
    f32: (step, its optimizer state and the model's parameters, batch)."""
    from repro_torch.configs.gspn2_vision import GSPN2_T
    from repro_torch.models.vision import GSPNVision
    from repro_torch.optim.adamw import AdamWConfig

    model = GSPNVision(GSPN2_T, device=device, generator=None
                       if device == "meta" else torch.Generator().manual_seed(0))
    step, opt = _twin().make_step(model, AdamWConfig(
        lr=1e-3, warmup_steps=5, total_steps=60, weight_decay=0.01))
    gen = torch.Generator().manual_seed(6)
    batch = {"images": torch.randn((BATCH, GSPN2_T.img_size,
                                    GSPN2_T.img_size, 3), generator=gen)
             .to(device),
             "labels": torch.randint(0, GSPN2_T.n_classes, (BATCH,),
                                     generator=gen).to(device)}
    return step, (opt, dict(model.named_parameters())), batch


def roofline_meta(out: str) -> None:
    """(b)'s three programs on ``meta`` under ``roofline.cost.CostMode``,
    in a process of their own (the prefill joins a fake group of the
    model ranks): their cost records, written to ``out``."""
    sys.path.insert(0, str(ROOT / "src"))
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import dryrun
    from repro_torch.models import lm
    from repro_torch.parallel.tensor_parallel import shard_model
    from repro_torch.roofline.cost import count

    res = {}
    step, state, batch = _rl_lm_step("meta")
    res["lm train"] = count(step, state, batch)[1]
    del step, state, batch
    step, resident, batch = _rl_vision_step("meta")
    res["vision train"] = count(step, batch, resident=resident)[1]
    del step, resident, batch
    arch, m, prompt = RL_SERVE[0]
    dryrun.fake_group(m)
    mesh = DeviceMesh("cpu", torch.arange(m).reshape(1, m),
                      mesh_dim_names=("data", "model"))
    model = lm.LM(_rl_cfg(arch), device="meta")
    shard_model(model, mesh)
    tokens = torch.empty((1, prompt), dtype=torch.int64, device="meta")

    def prefill():
        with torch.no_grad():
            return lm.lm_prefill(model, tokens, prompt + RL_DECODE,
                                 ctx=lm.Ctx(mesh=mesh))

    res["gspn prefill per rank"] = count(
        prefill, resident=(list(model.parameters()), tokens))[1]
    pathlib.Path(out).write_text(json.dumps(res))


def _rl_serve(arch, m, prompt, out_dir, smi):
    """(a) for one arch: the ranks' run against the one-rank run on the
    same weights.  Returns rank 0's record."""
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import cache_shardings

    every = _spawn_ranks(arch, m, out_dir / f"serve_{arch}.json",
                         worker="roofline_worker")
    got = torch.load(out_dir / f"serve_{arch}.pt")
    cfg = _rl_cfg(arch)
    model = lm.LM(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(RL_SEED))
    tokens = _rl_tokens(cfg, prompt, "cuda")
    want, chosen, _ = _rl_greedy(model, tokens, prompt + RL_DECODE)
    del model
    torch.cuda.empty_cache()
    err = ((got - want).abs().max() / want.abs().max()).item()
    whole = {k: {n: tuple(v.shape) for n, v in sub.items()} for k, sub in
             lm.init_lm_cache(cfg, 1, prompt + RL_DECODE,
                              device="meta").items()}
    specs = cache_shardings(whole, {"data": 1, "model": m})
    shapes = {k: {n: [d // m if s == "model" else d
                      for d, s in zip(whole[k][n], specs[k][n])]
                  for n in sub} for k, sub in whole.items()}
    n1 = 2 * cfg.layer_count() if arch.endswith("gspn") else 0
    launches = [r["launches"] for r in every]
    print(f"roofline serve {arch} on (data 1, model {m}) ({smi}), f32, "
          f"prompt 1 x {prompt} + {RL_DECODE} greedy tokens: last logits "
          f"{err:.3e} of the largest one-rank logit (tol 1e-4); tokens "
          f"equal {every[0]['tokens'] == chosen}; rank 0 cache "
          f"{every[0]['cache_shapes']}; #1 launches a rank in the prefill "
          f"{[lc['prefill'] for lc in launches]}, in decode steps "
          f"{sorted({str(v) for lc in launches for k, v in lc.items() if k.startswith('decode')})}; "
          f"plain calls {sum(sum(r['plain'].values()) for r in every)}; "
          f"rank 0 prefill {every[0]['prefill_ms']} ms", flush=True)
    if not err <= 1e-4 or every[0]["tokens"] != chosen:
        raise AssertionError(f"roofline serve {arch}: sharded run "
                             f"disagrees with one rank")
    for r in every:
        if r["cache_shapes"] != shapes:
            raise AssertionError(f"roofline serve {arch}: cache shapes "
                                 f"{r['cache_shapes']}, want {shapes}")
        if sum(r["plain"].values()):
            raise AssertionError(f"roofline serve {arch}: plain calls")
        for what, lc in r["launches"].items():
            want_n = n1 if what == "prefill" else 0
            if lc.get("gspn_scan_fwd", 0) != want_n or \
                    sum(lc.values()) != want_n:
                raise AssertionError(f"roofline serve {arch} {what}: "
                                     f"launches {lc}, want {want_n} of #1")
    return every[0]


def _rl_row(what, rec, flops_card, ms, peak_card, smi):
    """Print (b)'s line for one program and check its bounds: FLOPs on
    meta equal the card's, the roofline bound at most the measured
    median, the estimated peak within 0.7-1.3 of the card's."""
    from repro_torch.roofline.analysis import terms
    t = terms(rec["flops_by_dtype"], rec["bytes_hbm"],
              rec["collectives"]["total"])
    bound = max(t.values()) * 1e3
    ratio = rec["peak_bytes"] / peak_card
    print(f"roofline {what} ({smi}): FLOPs meta {rec['flops']:.0f} card "
          f"{flops_card:.0f} ({rec['flops_by_dtype']}); compute "
          f"{t['compute'] * 1e3:.3f} ms, memory {t['memory'] * 1e3:.3f} "
          f"ms ({rec['bytes_hbm']:.4g} bytes, eager upper bound), "
          f"collective {t['collective'] * 1e3:.3f} ms; bound {bound:.3f} "
          f"ms; measured median {ms:.3f} ms; bound / measured "
          f"{bound / ms:.4f}; peak estimated {rec['peak_bytes'] / 2**30:.3f}"
          f" GiB, max_memory_allocated {peak_card / 2**30:.3f} GiB (ratio "
          f"{ratio:.3f}); kernels {rec['kernels']}", flush=True)
    if rec["flops"] != flops_card:
        raise AssertionError(f"roofline {what}: FLOPs on meta "
                             f"{rec['flops']} != the card's {flops_card}")
    if not bound <= ms:
        raise AssertionError(f"roofline {what}: bound {bound} ms above the "
                             f"measured {ms} ms")
    if not 0.7 <= ratio <= 1.3:
        raise AssertionError(f"roofline {what}: estimated peak / measured "
                             f"{ratio}")


def _rl_card(make, what, n=3):
    """A card program of (b): a warm-up, one run under FlopCounterMode,
    ``n`` timed runs (median ms) and one run's peak memory."""
    from torch.utils.flop_counter import FlopCounterMode

    step, resident, batch = make("cuda")
    args = (resident, batch) if what == "lm train" else (batch,)
    step(*args)
    torch.cuda.synchronize()
    with FlopCounterMode(display=False) as fc:
        step(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.reset_peak_memory_stats()
    step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del step, resident, batch, args
    gc.collect()
    torch.cuda.empty_cache()
    return fc.get_total_flops(), statistics.median(times), peak


def roofline_phase():
    """(a) sharded serving at full width against one rank; (b) the
    roofline of three programs measured on the card against their meta
    counts; (c) the dry run of three production cells on meta.  The
    meta work runs in processes of its own beside the card's."""
    import shutil

    out_dir = ROOT / "build" / "roofline"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).strip()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    logs = {}
    for kind, arch, shape in RL_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", "single", "--out",
               str(out_dir / "dryrun")] + (["--vision"] if kind == "vision"
                                           else [])
        logs[arch] = open(out_dir / f"dryrun_{arch}.log", "w")
        procs[arch] = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                       stdout=logs[arch],
                                       stderr=subprocess.STDOUT)
    meta_out = out_dir / "meta.json"
    logs["meta"] = open(out_dir / "meta.log", "w")
    procs["meta"] = subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.roofline_meta({str(meta_out)!r})"],
        cwd=ROOT, env=env, stdout=logs["meta"], stderr=subprocess.STDOUT)
    try:
        gspn = None
        for arch, m, prompt in RL_SERVE:
            rec = _rl_serve(arch, m, prompt, out_dir, smi)
            gspn = gspn or rec
        card = {"lm train": _rl_card(_rl_lm_step, "lm train"),
                "vision train": _rl_card(_rl_vision_step, "vision train"),
                "gspn prefill per rank": (
                    gspn["flops"], statistics.median(gspn["prefill_ms"]),
                    gspn["peak_bytes"])}
        deadline = time.monotonic() + 600
        for name, p in procs.items():
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()
    bad = [n for n, p in procs.items() if p.returncode]
    if bad:
        for n in bad:
            path = out_dir / (f"dryrun_{n}.log" if n != "meta"
                              else "meta.log")
            print(f"roofline {n}:\n{path.read_text()[-3000:]}", flush=True)
        raise AssertionError(f"roofline: meta processes failed {bad}")
    meta = json.loads(meta_out.read_text())
    for what, (flops, ms, peak) in card.items():
        _rl_row(what, meta[what], flops, ms, peak, smi)

    # (c) The dry run's three production cells.
    from repro_torch.roofline.analysis import analyze_dir
    rows, skips, errors = analyze_dir(str(out_dir / "dryrun"), "single")
    for r in rows:
        rec = r.raw
        print(f"roofline dryrun {r.arch} x {r.shape} single (rank 0 of "
              f"{rec['n_devices']}, spec constants of {rec['hw']['name']}, "
              f"{rec['hw']['power_limit_w']} W): status {rec['status']}, "
              f"FLOPs {rec['flops']:.4g} {rec['flops_by_dtype']}, bytes "
              f"{rec['bytes_hbm']:.4g}, collectives "
              f"{rec['collectives']['total']:.4g}, peak "
              f"{rec['peak_bytes'] / 2**30:.3f} GiB; compute "
              f"{r.compute_s * 1e3:.3f} ms, memory {r.memory_s * 1e3:.3f} "
              f"ms, collective {r.collective_s * 1e3:.3f} ms, dominant "
              f"{r.dominant}; run {rec['compile_s']} s on the host",
              flush=True)
    if len(rows) != len(RL_CELLS) or skips or errors:
        raise AssertionError(f"roofline dryrun: {len(rows)} cells ok, "
                             f"errors {[e.get('error') for e in errors]}")


def main() -> int:
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import cuda_lib

    print(" / ".join(_run([cuda_lib.nvcc_path(), "--version"])
                     .splitlines()[-2:]))
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    print(smi, flush=True)
    # Full f32 in convolutions and matrix products for every comparison.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    t0 = time.perf_counter()
    cuda_lib.build()
    print(f"build {time.perf_counter() - t0:.3f} s", flush=True)
    for name, log in cuda_lib.build_logs.items():
        print(f"nvcc {name}:\n{log.strip()}", flush=True)

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {name} {time.perf_counter() - t0:.3f} s", flush=True)
        return out

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = phase("kernels", kernel_phase, gen)
    # #2's launches are those of the single-direction gradient.
    single_bwd = {k: v for k, v in
                  phase("grad", single_direction_grad_check, gen).items()
                  if k[0] == "gspn_scan_bwd"}
    shapes = phase("model", model_phase, torch.Generator().manual_seed(0))
    # The adjoints' launches are those of the counted training step.
    shapes.update({k: v for k, v in
                   phase("train", train_phase,
                         torch.Generator().manual_seed(0)).items()
                   if k[0].endswith("_bwd")})
    phase("twin", twin_phase)
    shapes.update(phase("ladder", ladder_phase,
                        torch.Generator(device="cuda").manual_seed(1)))
    shapes.update(single_bwd)
    # #1's launches at the serving shapes are those of the engine's run.
    shapes.update(phase("lm serve", lm_serve_phase))
    # #1's and #2's at the training shapes, those of the counted step.
    shapes.update(phase("lm train", lm_train_phase))
    # Data and tensor parallelism: their ranks' launches are read in
    # their own checks.
    phase("lm dp", dp_phase)
    phase("lm tp", tp_phase)
    # The attention LM launches no kernel: its phase adds no launches.
    phase("lm attn", lm_attn_phase)
    # The tier's launches are read in its own checks; the kernels line
    # keeps the serving phase's.
    phase("tier", tier_phase)
    # The sharded path's launches (in its ranks' processes) are read in
    # its own checks.
    phase("sp", sp_phase)
    # The SSM and xLSTM families launch no kernel: no launches to add.
    phase("lm ssm", ssm_phase)
    # Nor does the MoE family.
    phase("lm moe", moe_phase)
    # Nor do the VL and encoder-decoder families.
    phase("lm vl", vl_phase)
    phase("lm audio", audio_phase)
    # Sharded serving launches #1 in its ranks' processes, read there.
    phase("roofline", roofline_phase)

    entries = []
    for row in rows:
        if row["dtype"] != "float32" or "ms" not in row:
            continue
        key = (row["kernel"], row["g"], row["h"], row["w"], row["dtype"])
        entries.append({
            "name": f"{row['kernel']}@G{row['g']}xH{row['h']}xW{row['w']}"
                    f"/{row['dtype']}",
            "route": "cuda", "source": SOURCES[row["kernel"]],
            "replaces": REPLACES[row["kernel"]],
            "launches": shapes.get(key, 0),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "cold_ms": row.get("cold_ms"),
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
