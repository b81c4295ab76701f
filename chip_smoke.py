#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (deepspeed_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the repo root, one NVIDIA H100

Phases (any failure raises and the script exits nonzero):
  1. card: the card's name and power limit (nvidia-smi), and the build of
     every kernel from csrc/ and of the checkpoint writer
     (csrc/ckpt_writer.cpp, g++) (one compiler per source, all started
     together, into build/).
 0b. SASS: cuobjdump -sass of the paged-attention, fused-CE, MLP,
     grouped-matmul, flash-attention and block-sparse libraries; every
     instance of the
     Hopper designs on sm90_gemm.cuh / sm90_attention.cuh / wq_sm90.cuh
     (fused_ce_sm90_kernel, proj_mm_sm90_kernel, grouped_tgmm_sm90_kernel,
     grouped_gmm_sm90_kernel, flash_fwd_sm90_kernel<D, CARRY> for K1 and
     K10, flash_dkdv_sm90_kernel<D> and flash_dq_sm90_kernel<D> for K2,
     flash_bwd_qmajor_sm90_kernel<D> for K2-qmajor,
     paged_chunk_sm90_kernel<D> for K5, D = 64 and 128,
     wq_matmul_sm90_kernel<BITS, NR> for K7, the twelve
     wq_grouped_sm90_kernel<BITS, NR, SWIGLU, WIDE> for K9,
     grouped_swiglu_up_sm90_kernel<NR> for K8's up chain, NR = 16, 80 and
     128, and bsa_fwd_sm90_kernel<D>, bsa_dq_sm90_kernel<D> and
     bsa_dkv_sm90_kernel<D> for K11's three passes) is there, holds
     HGMMA (wgmma) and UTMALDG (TMA loads) and spills nothing (ptxas);
     their registers logged.
  2. kernels: each Hopper kernel against its plain PyTorch version on the
     card at the Llama-2-7B / Mistral-7B serving shapes (bf16 against the
     plain version run in fp32 on the same inputs, see bf16_mismatch; fp32
     at 1e-4, allowing for another summation order), a control that an
     output with half its blocks dropped fails that check; the split
     decode (K4) also repeated bitwise, equal to its split-and-merge plain
     version, and a control (that plain version's merge without one live
     split's partial) that must fail; then each kernel timed with CUDA
     events beside its plain version, its bound and one library call
     (SDPA on the gathered K/V, a yardstick only), K4 also at Mixtral's
     GQA G = 4 shape beside its bound and SDPA (kv heads repeated). K5's
     bf16 cases (block_c 16 and 64, start 0 / 1000 / 3800, true_len 256
     and 100, window 0 and 512, Mistral GQA with window 4096) all run on
     its sm90 design (counted), each repeated bitwise; fp32 cases on the
     fp32 kernel at 1e-4; a control (the plain version reading one live
     block through another table entry) that must fail; the sm90 design
     timed with its launches queued beside its SIMT design, the plain
     version, SDPA and the bound at Llama-2-7B's start-1000 chunk, and at
     Mixtral's chunk (G = 4), a prompt's first chunk and a start-3800
     chunk (a split key walk) beside SDPA, the bound and the other split
     choice.
  3. parity: a small fp32 Llama served with paged_kernel=True and False on
     the card must give identical greedy streams (split-fuse on and off).
  4. slice: full-width Llama-2-7B (random weights from a seeded generator)
     serves 8 requests through InferenceEngineV2; every request returns
     its 64 tokens, and each kernel's launch count over this run equals
     the count the engine's dispatches imply.
  5. training kernels: flash forward (K1), fused flash backward (K2) and
     the fused CE unembed (K3) at the GPT-2 350M training shapes, bf16
     against their plain versions run in fp32 on the same inputs (fp32
     cases at 1e-4), one control per kernel that must fail its check, and
     each timed beside its bound, plain version and one library call; K3's
     bf16 design (sm90) also at a ragged N=1000, V=50000 and repeated
     bitwise; K1's bf16 design (sm90) also at d = 64 and 128, causal,
     window and not, T off the 128-row tile, model and heads-major strides,
     repeated bitwise, a control (one 128-key K/V tile skipped) that must
     fail, and timed beside its mma_sync design; K2's bf16 design (sm90)
     likewise: d = 64 and 128, causal and not, windows 256 and 100, T =
     1000 and others off the tile, both layouts, lse cotangents, per (b, h)
     slab against the plain backward in fp32, repeated bitwise, a control
     (the dK/dV walk without one query tile) that must fail, timed beside
     its mma_sync design, with each design's delta, dK/dV and dQ kernels
     timed apart (torch.profiler).
  6. training parity: a small fp32 GPT-2 on the card with the kernels on
     (flash + fused CE kernel, save_flash) and off (dense attention +
     fused_linear_xent) gives the same loss and gradients.
  7. training slice: initialize(GPT2 350M, the bench config) and 10
     train_batch steps on one fixed batch; the loss falls and the kernels'
     launch counts are exactly 24 flash forwards (every one on sm90), 24
     flash backwards and 2 fused CE calls per step (no flash forward re-run
     in backward).
  8. MoE kernels: the grouped gate/up (swiglu_up) and down (gmm) kernels
     (K8) at the Mixtral-8x7B serving shapes (D=4096, F=14336, E=8; 16
     routed rows at decode, 512 at a 256-token chunk; uneven sizes, an
     empty group, every row on one expert, a tail past the groups), bf16
     against their plain versions run in fp32 on the same inputs, fp32
     cases at 1e-4, the tail exactly 0, controls (one group's rows times
     a neighbouring expert's weights; for swiglu_up also w1's 64-feature
     halves swapped and one 64-deep k slice of w1 and w3 dropped) that
     must fail, each timed beside its bound, plain version and one library
     call; gmm also under both of its bf16 designs (sm90, mma_sync) beside
     the one _gmm_design picks at each row count; swiglu_up's every case
     on the design _swiglu_up_design picks (counted) and repeated bitwise,
     both its bf16 designs timed with their launches queued.
  9. MoE parity: a small fp32 Mixtral served with grouped_kernel=True and
     False gives identical greedy streams (split-fuse on and off).
 10. MoE slice: Mixtral-8x7B widths at 24 layers (random weights from a
     seeded generator, bf16) serve phase 4's 8 requests; every request
     returns 64 tokens, each grouped kernel launches once per layer and
     forward, the paged kernels as in phase 4; gmm's launches all on sm90,
     swiglu_up's each on the design its rows give (sm90 from
     SWIGLU_UP_SM90_MIN_ROWS rows), counted.
 11. MoE backward kernels: grouped_tgmm (K8's _tgmm) at the GPT2MoE 350M
     shapes (49152 routed rows, E=4, (K, N) = (1024, 4096) and (4096,
     1024); an empty expert and a row tail), bf16 on its sm90 design
     against its plain version in fp32 slab by slab and repeated bitwise,
     fp32 at 1e-4, controls that must fail (a group a tile late, a slab
     summed 64 rows into the next expert); grouped_gmm's forward and its
     dx product through a transposed view of w, on the sm90 design, at
     the routed sizes and at [15000, 0, 20000, 10000] (an empty expert,
     boundaries off the 128-row tile, a 4152-row tail exactly 0), repeated
     bitwise, a control (expert 0's rows read one tile late) that must
     fail; each timed beside its bound, plain version, one library call
     and its mma_sync design; the
     grouped_swiglu backward at Mixtral-8x7B expert widths against its
     plain version, its forward's up product on sm90 (counted).
 12. MoE training parity: a small fp32 GPT2MoE gives the same loss, aux and
     gradients with the grouped kernels on and off.
 13. MoE training slice: initialize(GPT2MoE over the 350M widths, E=4,
     top-2, the bench config) and 10 train_batch steps on one fixed batch;
     the loss falls and the launch counts are what the dispatches imply
     (per layer and step: 6 gmm, all on sm90; 4 tgmm, wi and wo on sm90,
     the expert-bias row sums on mma_sync; one flash forward, on sm90, and
     one backward).
 14. wq kernels: K7 (wq_matmul) at the Llama-2-7B FFN shapes (8 decode
     rows, a 256-token chunk and 1, 200, 300 rows; D=4096 -> F=11008 and
     back) on the design _wq_design picks (sm90 for bf16: every call
     counted there, held also against its split-order plain version at
     the plan's K split, repeated bitwise) and K9 (grouped_swiglu_up_wq,
     grouped_gmm_wq) at phase 8's Mixtral-8x7B shapes and edge cases, int8
     and int4, bf16 against their plain versions in fp32 on the same
     inputs, fp32 at 1e-4, tails exactly 0; controls that must fail (K7's
     scale shifted by one channel, one k slice of its codes skipped, int4
     nibbles swapped, a K9 group on its neighbour expert's scales); each
     timed beside its bound, plain version and library yardsticks (bf16
     torch.matmul / torch._grouped_mm on the dequantized weights, and
     torch._weight_int8pack_mm where this torch runs it), K7 also beside
     its mma_sync design (wq_kernel) and the sm90 kernel at the plan's
     other K split, each with its launches queued behind a device spin
     (the eager call is about as long as its Python launch path: its
     time and the host's launch path are logged beside). K9's every case
     (int8 and int4: decode, chunk, empty groups, one expert, the 162-row
     tail) on the design _wq_grouped_design picks (sm90 for bf16: counted),
     repeated bitwise, tails exactly 0; its controls (a group on its
     neighbour's scales, a group's codes with one k slice skipped) at the
     decode and the chunk shapes; decode and chunk timed on both designs
     (sm90 and wq_kernel, launches queued) beside the library calls and
     the bound.
 15. wq parity: small fp32 Llama and Mixtral, int8 and int4, served with
     weight_quant give the same greedy streams as the same model with
     its dequantized weights served unquantized (split-fuse on and off).
 16. Llama-2-7B int4 slice and 17. Mixtral-8x7B at all 32 layers in int8:
     built quantized slice by slice, phase 4's settings and traffic;
     every request returns 64 tokens, launches exactly 3 wq_matmul per
     layer and forward (Llama; each call on the design its rows give:
     every call of at least WQ_SM90_MIN_ROWS rows on sm90) or one
     grouped_swiglu_up_wq and one grouped_gmm_wq (Mixtral), the paged
     kernels as in phase 4; in phase 17 every K9 launch on the design its
     rows give (sm90 for every call of at least WQ_GROUPED_SM90_MIN_ROWS
     rows, decode and chunk), counted. In phases 4, 10, 16 and 17 every K5
     launch (bf16, d = 128) is counted on its sm90 design.
 18. K13 / K6 kernels: the LayerNorm forward and backward (K13) at N =
     24 * 1024, 24 * 512 and an odd row count, D = 1024, and the
     layout-owning projection (K6: forward, dx, dW) at all four (x_t,
     out_t) orientations at the GPT-2 350M MLP shapes, bf16 against the
     plain versions run in fp32 (dscale, dbias and dW by relative error
     norm), fp32 at 1e-4; controls that must fail (one CTA's rows dropped
     from dscale, dW without its last row tile, an out_t output written
     untransposed); each timed beside its bound, plain version and one
     library call (F.layer_norm forward / backward, torch.matmul); K6's
     bf16 design (sm90) also at ragged I, J and C in every orientation,
     and each product repeated bitwise.
 19. K13 / K6 parity: a small fp32 GPT-2 with fused_layernorm in {True,
     "bwd"}, mlp_kernel in {"down", "both"} and fuse_dw both ways, and a
     GPT2MoE with fused_layernorm, give the knobs-off loss and gradients.
 20. K13 / K6 slice: phase 7 with fused_layernorm=True, mlp_kernel="both",
     mlp_kernel_fuse_dw=True; the loss falls, the launch counts are exactly
     98 LayerNorm forwards, 50 backwards, 144 K6 products and 48 dW a
     step, and the step time is printed beside phase 7's and beside 10
     steps with fused_layernorm=True alone.
 21. K2-qmajor kernel: the query-major fused backward at phase 5's shapes
     (bf16, plus a window, T=1000 and an lse cotangent) against its plain
     version in fp32, fp32 cases at 1e-4, a control (dk/dv without the last
     query tile) that must fail, a bitwise repeat and bitwise equality with
     the k-major K2; its bf16 design (sm90) in phase 5's cases, each output
     bitwise equal to K2's sm90 output; timed beside its bound, its mma_sync
     design, the k-major K2 and SDPA's backward.
 22. K11 kernels: the block-sparse forward, dq and dk/dv at B=4, H=16,
     d=64, bf16: (a) FixedSparsityConfig(block 64, 4 local, 1 global,
     unidirectional) causal and (b) BigBirdSparsityConfig(block 64) at
     T=8192, and block 16 at T=2048, against their plain versions in fp32;
     fp32 at every block size at 1e-4; controls (the forward on its design
     with a row list short by its last id; the sm90 dq and dk/dv with one
     row / column list short by its last entry, held on that block's rows;
     dk/dv from the neighbour head's column lists) that must fail; rows
     with no present block and key blocks no query block attends exactly
     0; bitwise repeats; every pass on the design _bsa_fwd_design /
     _bsa_bwd_design picks (sm90 at block 64: (a), (b); mma_sync at block
     16; counted), the union walk's extra block pairs and the split walk's
     idle half-steps logged; timed beside their bounds, plain versions,
     SDPA on the dense causal problem and the masked-dense op at T=2048,
     each pass's two bf16 designs with their launches queued.
 23. K2-qmajor / K11 parity: a small fp32 GPT-2 with flash_bwd_qmajor on
     and off gives the same loss and gradients (save_flash and
     nothing_saveable); SparseSelfAttention through the kernels equals the
     masked-dense op at T=2048 in fp32, forward and gradients.
 24. slices: phase 7 with flash_bwd_qmajor=True (10 steps, exactly 24
     flash forwards, 24 query-major and 0 k-major backwards and 2 fused CE
     a step, beside phase 7's step); SparseSelfAttention (a) and (b) at
     B=4, T=8192, 10 forward + backward calls each, no host sync in a
     call, one launch of each K11 kernel a call (every forward, dq and
     dk/dv on sm90),
     ms a call and peak memory; every bf16 K1 / K2-qmajor / K3 launch of
     the GPT-2 slice on sm90.
 25. K10 (``flash_block_fwd``, the ring's chunk-pair step with carried
     online-softmax state): fp32 cases at 1e-4; bf16 on its sm90 design
     (every launch counted there): three chained pairs on the late half of
     one state at d = 64 and 128 and ragged C, repeated bitwise, and at
     (B*H, C, d) = (64, 2048, 64), diagonal-causal and full, from a carried
     state, against its plain version in fp32 (the finalized o by the bf16
     check, lse at 1e-4); a control (the carry's m perturbed) that must
     fail; the zigzag schedule of R = 4 emulated in one process with the
     ring's step functions on one (B=4, T=8192, H=16, d=64) problem,
     against K1 on the whole sequence and the dense plain version;
     ``flash_block_bwd`` (K2 from the global o / lse, on K2's sm90 design)
     against the plain backward at the ring's (64, 2048, 64) pairs, full
     and diagonal-causal; the full and causal pairs timed beside their
     bounds, the
     mma_sync design, the plain version and SDPA's forward (causal too).
 26. K12 (blockwise int8 quantize / dequantize) on a buffer of GPT-2 350M's
     parameter count in fp32 and bf16: codes, scales and dequantized values
     bitwise equal to the plain versions (and the reduce-scatter's summing
     dequantize); a control (scales by IEEE division, the eager jnp form)
     that the bitwise check must catch; timed beside bound, plain version
     and the shortest torch expression of the same math.
 27. NCCL world of one on cuda:0: every comm op, the four quantized
     collectives (K12) equal to their plain versions bitwise, ring_attention
     at R = 1 (one K10 a call, on sm90), and initialize(sequence_parallel_size=1,
     attention_backend="ring") taking K1 with no K10, as JAX.
 28. two processes sharing cuda:0 over gloo (named by the caller; NCCL
     refuses two ranks on one card): GPT-2 at the 350M widths, 2 layers,
     fp32, seq = 2, ring and Ulysses, loss and every gradient against the
     same model at seq = 1 (2e-5, relative error norm 1e-4);
     quantized_all_gather / quantized_reduce_scatter at world 2 bitwise
     equal to their plain versions.
 29. the slice: GPT-2 350M (24 layers, T=4096, micro 4, ring,
     sequence_parallel_size=2, ZeRO-2, bf16) through initialize ->
     train_batch for 5 steps in two processes on cuda:0 over gloo; the
     loss falls and agrees on both ranks; exactly 6 K10 and 3 K2 (every
     one on its sm90 design, as each child reports) a layer and step on
     each rank (3 pairs forward, 3 in the remat re-run, 3 backward pairs); step
     time, tokens/s, each process's peak memory, and what went through
     host memory.
 30. K13 RMSNorm (``fused_rmsnorm``, the last Pallas site): fp32 at 1e-4
     (D up to 4096), bf16 and fp32 at (8, 1024, 1024) and (4, 2048, 4096)
     against its plain version, bitwise repeats, a control (one row with
     the scale a column off) that must fail; timed from CUDA graph replays
     (the call is shorter than its Python launch path; the eager call is
     timed too) beside its bound, the plain version, F.rms_norm and the
     torch expression; then the op's
     path: 10 calls at (8, 1024, 1024) bf16, one launch each.
 31. two processes sharing cuda:0 over gloo: GPT-2 at the 350M widths, 2
     layers, fp32, ZeRO stages 0-3 at dp = 2 (gas 2, 3 steps) against the
     same run at dp = 1: losses at 2e-5, global gradient norms at 1e-5,
     the master within a relative error norm of 1e-4, the same loss on
     both ranks.
 32. the slice: GPT-2 350M (24 layers, the bench configuration, micro 24 a
     rank, T=1024) at dp = 2 through initialize -> train_batch, ZeRO-2 for
     10 steps and ZeRO-3 for 3; the loss falls and agrees on both ranks;
     exactly 24 K1, 24 K2 and 2 K3 a step on each rank (every one on
     sm90, as each child reports); step time,
     tokens/s, each process's peak memory and the bytes each rank staged
     through host memory a step. After ZeRO-3's steps the two children
     save one tag (a shard file each); this process loads it at dp = 1
     under ZeRO-2 (gas 1 -> 2 keeps the global batch of 48, micro_steps
     realign), its master equal to the children's gathered master (their
     CRC32), and takes one step with a finite loss.
 33. checkpoints: GPT-2 350M at phase 7's configuration takes steps and
     saves one tag of its whole state (fp32 master, m, v: 4.26 GB) with
     each of the sync, async and native engines, stepping on while an
     async or native write is in flight; a second run repeats its first
     steps (the bitwise repeat the resume is held to); fresh engines load
     the sync and native tags and take the next steps: every saved leaf
     and the recast bf16 parameters bitwise, the losses the uninterrupted
     run's. Controls that must fail: a load by name of the native tag with
     one byte flipped in a chunk raises CheckpointCorruptionError; without
     a tag the load falls back to the async tag (load_fallbacks 1), which
     then resumes the same way. No engine degrades (counters["fallbacks"]
     0); launches exactly 24 K1, 24 K2 and 2 K3 a step, all on sm90. One
     ``checkpoint`` JSON line an engine: bytes a tag, the seconds
     save_checkpoint blocked, the seconds until 'latest' named the tag,
     write GB/s, load seconds, the median step overlapping an in-flight
     write against the median without, the counters, the card and the
     target's filesystem (tags under build/chip_smoke_ckpt, deleted after
     their checks).
 34. the serving front-end: (a) phase 3's small fp32 Llama with the
     kernels on, through a colocated 2-replica Router, a 1 prefill + 1
     decode fleet (disaggregate "auto") and the colocated fleet with
     replica_death on r1's third step: every greedy stream equal to one
     engine's, the death replayed (failovers 1, replayed r1's in-flight
     count), every live pool closed; (b) full-width Llama-2-7B in bf16
     (phase 4's settings with 160 KV blocks an engine, phase 4's eight
     prompts, all greedy, 64 new tokens): run 1 one engine (the reference
     streams), run 2 Router([prefill p0, decode d0]) over the in-process
     transport (streams equal run 1's; 8 handoffs; kv_stream_bytes the
     payloads' sum; 149 exported blocks; both pools closed; K5 = 32 x
     p0's chunk forwards, K4 = 32 x d0's decode forwards, p0 decoding
     nothing; the second engine adds its pool, not a second weight set),
     run 3 two colocated replicas with one dying mid-decode (streams
     equal run 1's, failovers 1, its in-flight requests replayed); one
     ``router`` JSON line a run: TTFT / TPOT p50, output tokens/s, handoff
     ms p50 / max and GB/s (export: gather, D2H, pack; import: unpack,
     H2D, pool writes), kv_stream_bytes, peak memory, the card.
Phases 7, 13, 20, 24, 32 and 33 also hold every bf16 K1 / K2 / K2-qmajor /
K3 / K6 launch to the sm90 design (the wrappers' DESIGN_LAUNCHES); the
serving slices count K4's launches by design (split / single), the
Mixtral slice K8's gmm (all sm90) and swiglu_up, the Llama int4 slice
K7's (phase 16), phases 27 and 29 K10's and K2's (all sm90), phase 24
K11's three passes (all sm90).
Then one JSON line of per-kernel numbers (launches summed over the main
paths that ran each kernel, and per path; the rows with more than one
design with the designs their main-path launches went to, the sm90 rows
with their SASS counts), and last the result line
{"ok": true, "device": {...}}. Without a CUDA device it exits 2 and prints
no result. ``--profile PATH`` also writes torch.profiler breakdowns of the
serving slice's device time to PATH, of three extra training steps to
PATH with "-train" before its extension, of the MoE slice with "-moe", of
three extra MoE training steps with "-moe-train", of the quantized
slices with "-llama-int4" and "-mixtral-int8" and of three extra
knobs-on GPT-2 steps with "-kernels-train" and of three extra qmajor
GPT-2 steps with "-qmajor-train" (profiled timings include the
profiler's overhead).
"""

import argparse
import ctypes
import dataclasses
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
# bf16 kernel output vs the plain version in fp32 on the same inputs: the
# output's own rounding is at most 2^-9 |ref| and rounding p to bf16 before
# PV adds about as much, so rtol 2^-7 holds with room; the atol covers
# values near zero. Rows over thousands of keys have outputs of a few
# hundredths, so each row's relative error norm (over the head dim) bounds
# what the atol would let by.
BF16_TOL = dict(rtol=2 ** -7, atol=4e-3)
BF16_REL_NORM = 1e-2
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 flash gradients against the plain backward in fp32 on the same
# inputs: p and ds are rounded to bf16 (2^-9 relative each) before products
# over up to T terms whose signed sum cancels, so no element-wise rtol
# holds near zero; the relative error norm of each (b, h) slab (T x d) is
# held instead, ~2^-9 times a small factor when right, of order 1 for a
# slab that lost a key or query tile.
BF16_GRAD_REL_NORM = 2e-2
# fused CE logz/gold (fp32) from bf16 h, w against the plain version in
# fp32 on the same inputs: each bf16 product is exact in fp32, so only the
# order of the D=1024-term sums differs; at h ~ N(0,1), w ~ 0.02 N(0,1) the
# worst-case bound D * 2^-24 * sum|h w| is about 8e-4.
CE_STAT_ATOL = 1e-3
# the grouped counters of the quantized kernels (K9): 0 on every bf16 path
NO_WQ = {"grouped_swiglu_up_wq": 0, "grouped_gmm_wq": 0}
SOURCES = {
    "paged_decode": "deepspeed_tpu_torch/csrc/paged_attention.cu",
    "paged_chunk": "deepspeed_tpu_torch/csrc/paged_attention.cu",
    "flash_fwd": "deepspeed_tpu_torch/csrc/flash_attention.cu",
    "flash_bwd": "deepspeed_tpu_torch/csrc/flash_attention.cu",
    "fused_ce": "deepspeed_tpu_torch/csrc/fused_ce.cu",
    "grouped_swiglu_up": "deepspeed_tpu_torch/csrc/grouped_matmul.cu",
    "grouped_gmm": "deepspeed_tpu_torch/csrc/grouped_matmul.cu",
    "grouped_tgmm": "deepspeed_tpu_torch/csrc/grouped_matmul.cu",
    "wq_matmul": "deepspeed_tpu_torch/csrc/mlp_matmul.cu",
    "grouped_swiglu_up_wq": "deepspeed_tpu_torch/csrc/grouped_matmul.cu",
    "grouped_gmm_wq": "deepspeed_tpu_torch/csrc/grouped_matmul.cu",
    "layernorm_fwd": "deepspeed_tpu_torch/csrc/layernorm.cu",
    "layernorm_bwd": "deepspeed_tpu_torch/csrc/layernorm.cu",
    "mlp_mm": "deepspeed_tpu_torch/csrc/mlp_matmul.cu",
    "mlp_dw": "deepspeed_tpu_torch/csrc/mlp_matmul.cu",
    "flash_bwd_qmajor": "deepspeed_tpu_torch/csrc/flash_attention.cu",
    "bsa_fwd": "deepspeed_tpu_torch/csrc/block_sparse_attention.cu",
    "bsa_dq": "deepspeed_tpu_torch/csrc/block_sparse_attention.cu",
    "bsa_dkv": "deepspeed_tpu_torch/csrc/block_sparse_attention.cu",
    "flash_block_fwd": "deepspeed_tpu_torch/csrc/flash_attention.cu",
    "quantize_blockwise": "deepspeed_tpu_torch/csrc/quantization.cu",
    "dequantize_blockwise": "deepspeed_tpu_torch/csrc/quantization.cu",
    "rmsnorm_fwd": "deepspeed_tpu_torch/csrc/layernorm.cu",
}
REPLACES = {
    "paged_decode": "deepspeed_tpu/ops/pallas/paged_attention.py:121",
    "paged_chunk": "deepspeed_tpu/ops/pallas/paged_attention.py:310",
    "flash_fwd": "deepspeed_tpu/ops/pallas/flash_attention.py:360",
    "flash_bwd": "deepspeed_tpu/ops/pallas/flash_attention.py:717",
    "fused_ce": "deepspeed_tpu/ops/pallas/fused_ce.py:44",
    "grouped_swiglu_up": "deepspeed_tpu/ops/pallas/grouped_matmul.py:182",
    "grouped_gmm": "deepspeed_tpu/ops/pallas/grouped_matmul.py:115",
    "grouped_tgmm": "deepspeed_tpu/ops/pallas/grouped_matmul.py:246",
    "wq_matmul": "deepspeed_tpu/ops/pallas/mlp_matmul.py:284",
    "grouped_swiglu_up_wq": "deepspeed_tpu/ops/pallas/grouped_matmul.py:536",
    "grouped_gmm_wq": "deepspeed_tpu/ops/pallas/grouped_matmul.py:465",
    "layernorm_fwd": "deepspeed_tpu/ops/pallas/layernorm.py:53",
    "layernorm_bwd": "deepspeed_tpu/ops/pallas/layernorm.py:63",
    "mlp_mm": "deepspeed_tpu/ops/pallas/mlp_matmul.py:70",
    "mlp_dw": "deepspeed_tpu/ops/pallas/mlp_matmul.py:134",
    "flash_bwd_qmajor": "deepspeed_tpu/ops/pallas/flash_attention.py:828",
    "bsa_fwd": "deepspeed_tpu/ops/pallas/block_sparse_attention.py:74",
    "bsa_dq": "deepspeed_tpu/ops/pallas/block_sparse_attention.py:117",
    "bsa_dkv": "deepspeed_tpu/ops/pallas/block_sparse_attention.py:150",
    "flash_block_fwd": "deepspeed_tpu/ops/pallas/flash_attention.py:1033",
    "quantize_blockwise": "deepspeed_tpu/ops/pallas/quantization.py:60",
    "dequantize_blockwise": "deepspeed_tpu/ops/pallas/quantization.py:69",
    "rmsnorm_fwd": "deepspeed_tpu/ops/pallas/layernorm.py:225",
}


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters):
    """Mean device time of one call, CUDA events around ``iters`` calls
    after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def time_queued(fn, iters):
    """(device ms, host ms) of one call with the host out of the way: the
    device spins (torch.cuda._sleep) while the host queues ``iters`` calls
    behind it, so CUDA events around them see the calls back to back, and
    the host clock around the queueing sees the launch path alone. For
    calls about as short as their Python launch path, which CUDA events
    around eager calls time at the host's pace (time_ms), and which a CUDA
    graph cannot capture as they are (a launcher that sets a kernel
    attribute)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)      # ~25 ms at 2 GHz
    t0.record()
    h0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - h0) * 1e3 / iters
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters, host


def time_graph_ms(fn, iters):
    """Mean device time of one call with the host out of the way:
    ``iters`` calls captured in one CUDA graph, replayed between CUDA
    events. A call shorter than its Python launch path is otherwise timed
    at the host's pace (time_ms)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    del graph
    return t0.elapsed_time(t1) / iters


def bf16_errors(out, ref):
    """bf16 ``out`` against fp32 ``ref``: (elements outside BF16_TOL, max
    |err|, the worst row's relative error norm over the last dim)."""
    diff = out.float() - ref
    over = diff.abs() > BF16_TOL["atol"] + BF16_TOL["rtol"] * ref.abs()
    rel = (torch.linalg.vector_norm(diff, dim=-1)
           / torch.linalg.vector_norm(ref, dim=-1)).max().item()
    return int(over.sum()), diff.abs().max().item(), rel


def bf16_mismatch(out, ref):
    """None if the bf16 ``out`` holds against the fp32 ``ref`` (BF16_TOL
    element by element, BF16_REL_NORM row by row), else why not."""
    if not torch.isfinite(out).all():
        return "non-finite output"
    n_over, err, rel = bf16_errors(out, ref)
    if n_over or rel > BF16_REL_NORM:
        return (f"{n_over} of {out.numel()} elements out of tolerance, max "
                f"|err| {err:.3g}, worst row relative error norm {rel:.3g}")
    return None


def bf16_grad_mismatch(out, ref):
    """None if the bf16 gradient ``out`` (B, H, T, d) holds against the fp32
    ``ref`` (every (b, h) slab's relative error norm within
    BF16_GRAD_REL_NORM), else why not."""
    if not torch.isfinite(out).all():
        return "non-finite output"
    rel = grad_rel_norm(out, ref)
    if rel > BF16_GRAD_REL_NORM:
        return f"worst (b, h) slab relative error norm {rel:.3g}"
    return None


def grad_rel_norm(out, ref):
    """The worst (b, h) slab's relative error norm of ``out`` vs ``ref``."""
    diff = (out.float() - ref).flatten(2)
    return (torch.linalg.vector_norm(diff, dim=-1)
            / torch.linalg.vector_norm(ref.flatten(2), dim=-1)).max().item()


def decode_with_blocks_dropped(pa, q, k, v, tables, lengths):
    """The output of a decode kernel that skipped every odd table block:
    the plain version over the even blocks alone (positions carry no
    meaning without ALiBi, so the kept keys are a prefix of the compacted
    table)."""
    BS = k.shape[2]
    L = lengths.long()
    jb = L // BS
    kept = torch.where(jb % 2 == 0, jb // 2 * BS + L % BS,
                       (jb + 1) // 2 * BS - 1)
    return pa.paged_decode_attention_reference(
        q, k, v, tables[:, ::2].contiguous(), kept.to(torch.int32))


def ptxas_summary(build_log):
    """(mangled kernel symbol, registers, spill store bytes) for each
    instance in an nvcc -Xptxas -v log."""
    import re
    out, entry = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            spill = 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.append((entry, int(m.group(1)), spill))
            entry = None
    return out


# the Hopper designs (sm90_gemm.cuh, sm90_attention.cuh, wq_sm90.cuh) of
# each kernel of the kernels line that has one: (library, substrings of the
# mangled symbols, one per instance that must be there); their SASS must
# hold wgmma (HGMMA) and TMA loads (UTMALDG)
SM90_DESIGNS = {
    "fused_ce": ("fused_ce", ("fused_ce_sm90_kernel",)),
    "mlp_mm": ("mlp_matmul", ("proj_mm_sm90_kernel",)),
    "mlp_dw": ("mlp_matmul", ("proj_mm_sm90_kernel",)),
    "grouped_tgmm": ("grouped_matmul", ("grouped_tgmm_sm90_kernel",)),
    "grouped_gmm": ("grouped_matmul", ("grouped_gmm_sm90_kernel",)),
    "flash_fwd": ("flash_attention", tuple(
        f"flash_fwd_sm90_kernelILi{d}ELb0E" for d in (64, 128))),
    # K10: flash_fwd_sm90_kernel<D, CARRY = true>
    "flash_block_fwd": ("flash_attention", tuple(
        f"flash_fwd_sm90_kernelILi{d}ELb1E" for d in (64, 128))),
    # K2: flash_dkdv_sm90_kernel<D> + flash_dq_sm90_kernel<D> (after the
    # delta kernel); K2-qmajor: flash_bwd_qmajor_sm90_kernel<D>
    "flash_bwd": ("flash_attention", tuple(
        f"flash_{k}_sm90_kernelILi{d}E" for k in ("dkdv", "dq")
        for d in (64, 128))),
    "flash_bwd_qmajor": ("flash_attention", tuple(
        f"flash_bwd_qmajor_sm90_kernelILi{d}E" for d in (64, 128))),
    # K7: wq_matmul_sm90_kernel<BITS, row tile>
    "wq_matmul": ("mlp_matmul", tuple(
        f"wq_matmul_sm90_kernelILi{b}ELi{n}E" for b in (4, 8)
        for n in (8, 64, 128, 256))),
    # K5: paged_chunk_sm90_kernel<D>
    "paged_chunk": ("paged_attention", tuple(
        f"paged_chunk_sm90_kernelILi{d}E" for d in (64, 128))),
    # K9: wq_grouped_sm90_kernel<BITS, row tile, SWIGLU, WIDE>
    "grouped_gmm_wq": ("grouped_matmul", tuple(
        f"wq_grouped_sm90_kernelILi{b}ELi{n}ELb0E" for b in (4, 8)
        for n in (16, 80, 128))),
    "grouped_swiglu_up_wq": ("grouped_matmul", tuple(
        f"wq_grouped_sm90_kernelILi{b}ELi{n}ELb1E" for b in (4, 8)
        for n in (16, 80, 128))),
    # K8's SwiGLU up chain: grouped_swiglu_up_sm90_kernel<row tile>
    "grouped_swiglu_up": ("grouped_matmul", tuple(
        f"grouped_swiglu_up_sm90_kernelILi{n}E" for n in (16, 80, 128))),
    # K11: bsa_fwd_sm90_kernel<D>, bsa_dq_sm90_kernel<D>,
    # bsa_dkv_sm90_kernel<D>
    **{name: ("block_sparse_attention", tuple(
        f"{name}_sm90_kernelILi{d}E" for d in (64, 128)))
       for name in ("bsa_fwd", "bsa_dq", "bsa_dkv")}}
# library -> the sm90 kernel symbols it must hold
SM90_KERNELS = {}
for _lib, _syms in SM90_DESIGNS.values():
    SM90_KERNELS.setdefault(_lib, set()).update(_syms)


def find_cuobjdump():
    """cuobjdump from the CUDA toolkit, else the copy in Triton's package;
    raises when neither has it."""
    found = ["/usr/local/cuda/bin/cuobjdump"]
    try:
        import triton
        found.append(os.path.join(os.path.dirname(triton.__file__),
                                  "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    for path in found:
        if os.path.exists(path):
            return path
    raise RuntimeError(f"cuobjdump not found (looked at {found})")


def phase_sass(builders):
    """Phase 0b: the SASS of every sm90 kernel instance (cuobjdump -sass on
    the built libraries) holds HGMMA and UTMALDG and ptxas spilled none of
    its registers; logs each instance's counts of both and its registers."""
    import re
    tool = find_cuobjdump()
    report = {}
    for b in builders:
        wants = SM90_KERNELS.get(b.NAME)
        if wants is None:
            continue
        regs = {e: (r, sp) for e, r, sp in ptxas_summary(b.build_log)}
        sass = subprocess.run([tool, "-sass", b.so_path()],
                              capture_output=True, text=True,
                              check=True).stdout
        counts, cur = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = m.group(1) if any(w in m.group(1) for w in wants) \
                    else None
                if cur:
                    counts[cur] = [0, 0]
            elif cur:
                counts[cur][0] += "HGMMA" in line
                counts[cur][1] += "UTMALDG" in line
        for want in wants:
            assert any(want in k for k in counts), \
                f"{b.NAME}: no {want} in the SASS of {b.so_path()}"
        for name, (hgmma, utmaldg) in counts.items():
            assert hgmma and utmaldg, \
                f"{name}: {hgmma} HGMMA, {utmaldg} UTMALDG in its SASS"
            r, sp = regs.get(name, (None, None))
            assert sp == 0, f"{name}: ptxas reports {sp} bytes spilled"
            report[name] = dict(hgmma=hgmma, utmaldg=utmaldg, registers=r,
                                spill_bytes=sp)
            log(f"SASS {name}: {hgmma} HGMMA, {utmaldg} UTMALDG; ptxas "
                f"{r} registers, {sp} bytes spilled")
    return report


# K3 / K6 / K8 tgmm / K4 launches of the main paths by design: {kernel:
# {design: n}}
PATH_DESIGNS = {}


def count_designs(name, by):
    acc = PATH_DESIGNS.setdefault(name, {})
    for k, v in by.items():
        acc[k] = acc.get(k, 0) + v


def assert_sm90(tag, *mods, main_path=False):
    """Every launch of the run just read of a kernel with designs (the
    ``LAUNCHES`` / ``DESIGN_LAUNCHES`` of the wrapper modules ``mods``: K1,
    K2, K2-qmajor, K10, K3, K6, K7) went to the sm90 design; ``main_path``:
    the run was a main path, whose counts go to PATH_DESIGNS."""
    for mod in mods:
        for name, by in mod.DESIGN_LAUNCHES.items():
            assert by["sm90"] == mod.LAUNCHES[name] and not any(
                v for k, v in by.items() if k != "sm90"), \
                (tag, name, by, mod.LAUNCHES[name])
            if main_path:
                count_designs(name, by)


def count_paged_designs(pa, launches):
    """A serving main path's paged launches by design, into PATH_DESIGNS:
    the decode's (split / single) must add up to its paged_decode count,
    and every chunk launch (bf16 at d = 128 over 64-position blocks) must
    be on sm90."""
    by = pa.DESIGN_LAUNCHES["paged_decode"]
    assert sum(by.values()) == launches["paged_decode"], (by, launches)
    count_designs("paged_decode", by)
    by = pa.DESIGN_LAUNCHES["paged_chunk"]
    assert by == {"sm90": launches["paged_chunk"], "simt": 0, "fp32": 0}, \
        (by, launches)
    count_designs("paged_chunk", by)


def bound(nbytes, flops):
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = flops / BF16_FLOPS_PER_S * 1e3
    return (max(b_ms, f_ms), "bytes" if b_ms >= f_ms else "operations")


# ----------------------------------------------------------------- kernels


class KernelCases:
    """Random paged inputs on the card (tables from a numpy seed, values
    from a seeded torch generator), each kernel held against its plain
    version."""

    def __init__(self, pa, seed=0):
        self.pa = pa
        self.rs = np.random.RandomState(seed)
        self.g = torch.Generator(device="cuda")
        self.g.manual_seed(seed)
        self.err = {"paged_decode": 0.0, "paged_chunk": 0.0}
        self.rel = {"paged_decode": 0.0, "paged_chunk": 0.0}

    def randn(self, shape, dtype):
        return torch.randn(shape, generator=self.g, device="cuda").to(dtype)

    def pools(self, NB, KVH, BS, d, dtype):
        shape = (NB, KVH, BS, d)
        return self.randn(shape, dtype), self.randn(shape, dtype)

    def check(self, name, out, plain, *inputs):
        """bf16: ``out`` against ``plain`` run in fp32 on the same inputs
        (bf16_mismatch); fp32: against ``plain`` at FP32_TOL."""
        torch.cuda.synchronize()
        assert torch.isfinite(out).all(), f"{name}: non-finite output"
        if out.dtype == torch.bfloat16:
            ref = plain(*(t.float() for t in inputs))
            why = bf16_mismatch(out, ref)
            assert why is None, f"{name}: {why}"
            _, e, r = bf16_errors(out, ref)
            self.err[name] = max(self.err[name], e)
            self.rel[name] = max(self.rel[name], r)
        else:
            torch.testing.assert_close(out, plain(*inputs), **FP32_TOL)

    def decode(self, B, H, KVH, d, BS, MB, lengths, dtype, window=0,
               alibi=False, alibi_scale=1.0, alibi_bf16=False):
        NB = 1 + B * MB
        k, v = self.pools(NB, KVH, BS, d, dtype)
        tables = np.zeros((B, MB), np.int32)
        tables[:] = self.rs.permutation(np.arange(1, NB))[:B * MB].reshape(
            B, MB)
        lengths = np.asarray(lengths, np.int32)
        tables[lengths == 0] = 0                 # inactive slot: scratch
        q = self.randn((B, H, d), dtype)
        tb = torch.from_numpy(tables).cuda()
        ln = torch.from_numpy(lengths).cuda()
        kw = dict(window=window, alibi_scale=alibi_scale,
                  alibi_bf16=alibi_bf16,
                  alibi_slopes=self.pa.alibi_slopes(H) if alibi else None)
        out = self.pa.paged_decode_attention(q, k, v, tb, ln, **kw)
        self.check("paged_decode", out, lambda q, k, v:
                   self.pa.paged_decode_attention_reference(
                       q, k, v, tb, ln, **kw), q, k, v)
        return dict(q=q, k=k, v=v, tables=tb, lengths=ln)

    def chunk(self, H, KVH, d, BS, MB, C, start, true_len, block_c, dtype,
              window=0):
        NB = 1 + MB
        k, v = self.pools(NB, KVH, BS, d, dtype)
        table = torch.from_numpy(
            self.rs.permutation(np.arange(1, NB))[:MB].astype(np.int32)).cuda()
        q = self.randn((C, H, d), dtype)
        self.pa.reset_launch_counts()
        out = self.pa.paged_chunk_attention(q, k, v, table, start, true_len,
                                            window=window, block_c=block_c)
        again = self.pa.paged_chunk_attention(q, k, v, table, start,
                                              true_len, window=window,
                                              block_c=block_c)
        torch.cuda.synchronize()
        # every bf16 case (d = 128, 64-position blocks) on sm90, fp32 on
        # the fp32 kernel; calls repeat bitwise
        want = "sm90" if dtype == torch.bfloat16 else "fp32"
        by = self.pa.DESIGN_LAUNCHES["paged_chunk"]
        assert by[want] == 2 and sum(by.values()) == 2, (want, by)
        assert torch.equal(out, again), "paged_chunk: calls differ"
        assert torch.isfinite(out).all(), "paged_chunk: non-finite pad rows"
        self.check("paged_chunk", out[:true_len], lambda q, k, v:
                   self.pa.paged_chunk_attention_reference(
                       q, k, v, table, start, true_len,
                       window=window)[:true_len], q, k, v)
        return dict(q=q, k=k, v=v, table=table, start=start,
                    true_len=true_len, block_c=block_c)


def dense_kv(k, v, tables):
    """(B, MB) tables -> gathered (B, KVH, S, d) K/V for the library call."""
    B, MB = tables.shape
    NB, KVH, BS, d = k.shape
    tl = tables.long()
    gk = k[tl].permute(0, 2, 1, 3, 4).reshape(B, KVH, MB * BS, d)
    gv = v[tl].permute(0, 2, 1, 3, 4).reshape(B, KVH, MB * BS, d)
    return gk.contiguous(), gv.contiguous()


def phase_kernels(pa):
    cases = KernelCases(pa)
    bf, f32 = torch.bfloat16, torch.float32
    rs = np.random.RandomState(1)

    # decode — Llama-2-7B: 8 slots, MHA, 64-token blocks, one inactive slot
    llama_len = rs.randint(1, 4096, 8)
    llama_len[3] = 0
    main_dec = cases.decode(8, 32, 32, 128, 64, 64, llama_len, bf)
    cases.decode(8, 32, 32, 128, 64, 64, llama_len, f32)
    # Mistral-7B: GQA G=4, window 4096 biting past position 4096
    mis_len = rs.randint(4097, 8192, 8)
    cases.decode(8, 32, 8, 128, 64, 128, mis_len, bf, window=4096)
    cases.decode(4, 32, 8, 128, 64, 128, mis_len[:4], f32, window=4096)
    # ALiBi (bloom slopes, 24 heads), and the falcon bf16/scaled variant
    al_len = rs.randint(1, 1024, 4)
    cases.decode(4, 24, 24, 128, 64, 16, al_len, bf, alibi=True)
    cases.decode(4, 24, 24, 128, 64, 16, al_len, f32, alibi=True,
                 alibi_scale=1 / math.sqrt(128), alibi_bf16=True)
    log(f"decode cases ok, max bf16 |err| {cases.err['paged_decode']:.3g}, "
        f"worst row relative error norm {cases.rel['paged_decode']:.3g}")
    d32 = [main_dec[n].float() for n in ("q", "k", "v")] + [
        main_dec["tables"], main_dec["lengths"]]
    dropped = decode_with_blocks_dropped(pa, *d32).to(bf)
    why = bf16_mismatch(dropped, pa.paged_decode_attention_reference(*d32))
    assert why is not None, "bf16 check let half the blocks drop"
    log(f"control: half the decode blocks dropped fails the bf16 check "
        f"({why})")
    # the split design at the main-path width: calls repeat bitwise, the
    # kernel agrees with the split-and-merge plain version, and a merge
    # that drops one live split's partial (from that plain version's fp32
    # partials) fails the check
    S, bps = pa.decode_splits(main_dec["tables"].shape[1], 64)
    args = [main_dec[n] for n in ("q", "k", "v", "tables", "lengths")]
    pa.reset_launch_counts()
    again = [pa.paged_decode_attention(*args) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(again[0], again[1]), "paged_decode: calls differ"
    assert pa.DESIGN_LAUNCHES["paged_decode"] == {"split": 2, "single": 0}
    m, l, acc = pa.paged_decode_split_partials(*d32)
    split_ref = pa.merge_decode_partials(m, l, acc, torch.float32)
    why = bf16_mismatch(again[0], split_ref)
    assert why is None, f"paged_decode vs the split plain version: {why}"
    live = [(b, s) for b in range(m.shape[0]) for s in range(1, S)
            if bool((l[b, :, s] > 0).all())]
    b, s = live[len(live) // 2]
    m[b, :, s], l[b, :, s], acc[b, :, s] = pa.NEG_INF, 0.0, 0.0
    why = bf16_mismatch(pa.merge_decode_partials(m, l, acc, bf),
                        pa.paged_decode_attention_reference(*d32))
    assert why is not None, "bf16 check let a live split's partial drop"
    log(f"split decode: {S} splits of {bps} blocks, calls repeat bitwise, "
        f"equal to the split plain version; control: the merge without "
        f"slot {b}'s split {s} fails the bf16 check ({why})")
    del d32, dropped, again, m, l, acc, split_ref

    # chunk — Llama-2-7B widths, 256-token chunks
    main_chk = None
    for block_c in (16, 64):
        for start in (0, 1000, 3800):
            for true_len in (256, 100):
                for window in (0, 512):
                    c = cases.chunk(32, 32, 128, 64, 64, 256, start,
                                    true_len, block_c, bf, window=window)
                    if (block_c, start, true_len, window) == (64, 1000, 256, 0):
                        main_chk = c
    cases.chunk(32, 32, 128, 64, 64, 256, 1000, 100, 64, f32)
    # Mistral-7B GQA chunk with its window biting
    cases.chunk(32, 8, 128, 64, 128, 256, 5000, 256, 64, bf, window=4096)
    cases.chunk(32, 8, 128, 64, 128, 256, 5000, 200, 16, f32, window=4096)
    log(f"chunk cases ok (every bf16 case on sm90, each repeated bitwise), "
        f"max bf16 |err| {cases.err['paged_chunk']:.3g}, worst row "
        f"relative error norm {cases.rel['paged_chunk']:.3g}")
    # control: the plain version reading one live block through another
    # table entry (the block past the walk) must fail the check
    c = main_chk
    c32 = [c[n].float() for n in ("q", "k", "v")]
    ref = pa.paged_chunk_attention_reference(*c32, c["table"], c["start"],
                                             c["true_len"])
    swapped = c["table"].clone()
    live = (c["start"] + c["true_len"]) // 64
    swapped[live // 2] = c["table"][-1]
    ctrl = pa.paged_chunk_attention_reference(*c32, swapped, c["start"],
                                              c["true_len"]).to(bf)
    why = bf16_mismatch(ctrl[:c["true_len"]], ref[:c["true_len"]])
    assert why is not None, "bf16 check let a swapped table entry pass"
    log(f"control: the chunk's live block {live // 2} read through another "
        f"table entry fails the bf16 check ({why})")
    del c32, ref, ctrl

    # ---- timing at the main-path shapes (bf16, Llama-2-7B)
    rows = {}
    d = main_dec
    B, H, hd = d["q"].shape
    KVH = d["k"].shape[1]
    esz = d["q"].element_size()
    n_pos = (d["lengths"].long() + 1).sum().item()
    dec_bytes = (2 * n_pos * KVH * hd * esz + 2 * d["q"].numel() * esz
                 + d["tables"].numel() * 4 + d["lengths"].numel() * 4)
    dec_flops = 4 * H * hd * n_pos
    gk, gv = dense_kv(d["k"], d["v"], d["tables"])
    S = gk.shape[2]
    dmask = (torch.arange(S, device="cuda")[None, :]
             <= d["lengths"].long()[:, None])[:, None, None, :]
    qd = d["q"][:, :, None, :]
    rows["paged_decode"] = dict(
        ms=time_ms(lambda: pa.paged_decode_attention(
            d["q"], d["k"], d["v"], d["tables"], d["lengths"]), 50),
        plain_ms=time_ms(lambda: pa.paged_decode_attention_reference(
            d["q"], d["k"], d["v"], d["tables"], d["lengths"]), 10),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qd, gk, gv, attn_mask=dmask), 50),
        bound=bound(dec_bytes, dec_flops),
        splits=dict(zip(("S", "blocks_per_split"),
                        pa.decode_splits(d["tables"].shape[1], 64))))
    del gk, gv, dmask
    # Mixtral-8x7B's decode shape (GQA G = 4, 8 kv heads) on the same table
    g4 = cases.decode(8, 32, 8, 128, 64, 64, llama_len, bf)
    g4_bytes = (2 * n_pos * 8 * hd * esz + 2 * g4["q"].numel() * esz
                + g4["tables"].numel() * 4 + g4["lengths"].numel() * 4)
    # its library call: SDPA on the gathered K/V, each kv head repeated
    # for its G = 4 query heads (gathered and repeated outside the timing)
    gk, gv = (t.repeat_interleave(4, dim=1)
              for t in dense_kv(g4["k"], g4["v"], g4["tables"]))
    S = gk.shape[2]
    gmask = (torch.arange(S, device="cuda")[None, :]
             <= g4["lengths"].long()[:, None])[:, None, None, :]
    gq = g4["q"][:, :, None, :]
    rows["paged_decode"]["gqa"] = dict(
        shape="Mixtral-8x7B widths: 8 slots, H = 32, KVH = 8, d = 128",
        ms=time_ms(lambda: pa.paged_decode_attention(
            g4["q"], g4["k"], g4["v"], g4["tables"], g4["lengths"]), 50),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            gq, gk, gv, attn_mask=gmask), 50),
        bound_ms=bound(g4_bytes, dec_flops)[0])
    del g4, gk, gv, gmask

    rows["paged_chunk"] = chunk_timing(pa, main_chk, with_plain=True)
    # Mixtral-8x7B's chunk (G = 4, 8 kv heads), a prompt's first chunk and
    # a chunk deep into a long prompt (a split key walk)
    for key, args in (("gqa", (32, 8, 1000)), ("first_chunk", (32, 32, 0)),
                      ("long_walk", (32, 32, 3800))):
        H_, KVH_, start_ = args
        rows["paged_chunk"][key] = chunk_timing(pa, cases.chunk(
            H_, KVH_, 128, 64, 64, 256, start_, 256, 64, bf))
    log(f"decode timed case: {n_pos} positions, {dec_bytes} bytes, "
        f"{dec_flops} flops")
    for name, r in rows.items():
        r["max_abs_err"] = cases.err[name]
        log(f"{name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, sdpa "
            f"{r['library_ms']:.4f}, bound {r['bound'][0]:.4f} by "
            f"{r['bound'][1]})")
    r = rows["paged_decode"]
    log(f"paged_decode / sdpa = {r['ms'] / r['library_ms']:.3f}; at GQA G=4 "
        f"({r['gqa']['shape']}): {r['gqa']['ms']:.4f} ms, sdpa "
        f"{r['gqa']['library_ms']:.4f}, bound {r['gqa']['bound_ms']:.4f} "
        f"by bytes")
    r = rows["paged_chunk"]
    log(f"paged_chunk (Llama-2-7B, start 1000): sm90 {r['ms']:.4f} ms "
        f"({r['splits']} splits; launches queued, host launch path "
        f"{r['host_ms']:.4f}), simt {r['simt_ms']:.4f} "
        f"({r['simt_ms'] / r['ms']:.2f}x sm90), sdpa {r['library_ms']:.4f} "
        f"({r['ms'] / r['library_ms']:.3f}x), sm90 at {r['alt_splits']} "
        f"splits {r['alt_splits_ms']:.4f}")
    for key in ("gqa", "first_chunk", "long_walk"):
        t = r[key]
        log(f"  paged_chunk {t['shape']}: sm90 {t['ms']:.4f} ms "
            f"({t['splits']} splits; at {t['alt_splits']} "
            f"{t['alt_splits_ms']:.4f}), simt {t['simt_ms']:.4f}, sdpa "
            f"{t['library_ms']:.4f}, bound {t['bound_ms']:.4f} by "
            f"{t['bound_by']}")
    return rows


def chunk_timing(pa, c, with_plain=False):
    """K5 on a ``KernelCases.chunk`` case: the design the rule picks (sm90)
    and its SIMT design with their launches queued behind a device spin
    (time_queued: a call is about as short as its Python launch path), the
    sm90 design at the other key-walk split choice (2 where the rule takes
    one, else 1), SDPA on the gathered K/V (kv heads repeated for G > 1; a
    yardstick only) and the bound; ``with_plain``: the plain version too."""
    C, H, hd = c["q"].shape
    KVH = c["k"].shape[1]
    G = H // KVH
    start, tl = c["start"], c["true_len"]
    q, k, v, table = c["q"], c["k"], c["v"], c["table"]
    esz = q.element_size()
    n_keys = start + tl
    pairs = sum(start + t + 1 for t in range(tl))
    nbytes = (2 * n_keys * KVH * hd * esz + 2 * q.numel() * esz
              + table.numel() * 4)
    sc = 1 / math.sqrt(hd)
    S = pa.chunk_splits(C, H, KVH, k.shape[2], table.shape[0], start, tl, 0)
    alt = 2 if S == 1 else 1

    def run(design, splits=None):
        return lambda: pa.paged_chunk_launch(q, k, v, table, start, tl, sc, 0,
                                             c["block_c"], design, splits)
    ms, host_ms = time_queued(run("sm90"), 50)
    gk, gv = (t.repeat_interleave(G, dim=1)
              for t in dense_kv(k, v, table[None]))
    qpos = start + torch.arange(C, device="cuda")[:, None]
    kpos = torch.arange(gk.shape[2], device="cuda")[None, :]
    mask = ((kpos <= qpos) & (kpos < start + tl))[None, None]
    qc = q.transpose(0, 1)[None]
    b = bound(nbytes, 4 * H * hd * pairs)
    r = dict(shape=f"H = {H}, KVH = {KVH}, d = {hd}, C = {C}, start {start}",
             ms=ms, host_ms=host_ms, splits=S,
             simt_ms=time_queued(run("simt"), 20)[0],
             alt_splits=alt, alt_splits_ms=time_queued(run("sm90", alt),
                                                       50)[0],
             library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                 qc, gk, gv, attn_mask=mask), 20),
             bound=b, bound_ms=b[0], bound_by=b[1])
    if with_plain:
        r["plain_ms"] = time_ms(lambda: pa.paged_chunk_attention_reference(
            q, k, v, table, start, tl), 5)
    log(f"chunk timed case ({r['shape']}): {pairs} (q, k) pairs, {nbytes} "
        f"bytes, {4 * H * hd * pairs} flops")
    return r


# ------------------------------------------------------------------ parity


def phase_parity():
    """Small fp32 Llama: kernel-on and kernel-off greedy streams agree."""
    from deepspeed_tpu_torch import InferenceEngineV2, Llama, LlamaConfig
    from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
    cfg = LlamaConfig(n_layer=2, n_head=4, n_kv_heads=2, d_model=128,
                      max_seq_len=512, vocab_size=512, remat=False,
                      dtype="float32")
    model = Llama(cfg, device="cuda", dtype=torch.float32, seed=7)
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 512, (n,)) for n in (5, 16, 37, 300)]
    for splitfuse in (64, 0):
        streams = {}
        for pk in (True, False):
            pa.reset_launch_counts()
            eng = InferenceEngineV2(model, dict(
                dtype="float32", kv_block_size=16, max_batch_size=4,
                prompt_bucket=64, splitfuse_tokens=splitfuse,
                paged_kernel=pk), device="cuda")
            streams[pk] = eng.generate_all(prompts, max_new_tokens=24)
            launched = sum(pa.LAUNCHES.values())
            assert (launched > 0) == pk, (pk, dict(pa.LAUNCHES))
        for a, b in zip(streams[True], streams[False]):
            np.testing.assert_array_equal(a, b)
        log(f"parity ok (splitfuse={splitfuse}): kernel-on == kernel-off "
            f"greedy streams, {sum(len(s) for s in streams[True])} tokens")
        del eng
    torch.cuda.empty_cache()


# ------------------------------------------------------------------- slice


def serve(eng, uids):
    """Step the engine until idle; returns per-uid first-token and done
    times on the host clock."""
    first, done = {}, {}
    while eng.has_work:
        eng.step()
        now = time.perf_counter()
        for u in uids:
            if u not in first and len(eng.get(u, flush=False)):
                first[u] = now
            if u not in done and eng.is_done(u):
                done[u] = now
    return first, done


# the kernel families PERF.md reports for the GPT-2 training profiles, by
# a substring of the kernel's name (the first family that matches)
PROFILE_FAMILIES = (
    ("K6", ("proj_mm",)), ("fused CE", ("fused_ce",)), ("flash", ("flash",)),
    ("K11", ("bsa_",)), ("K4 / K5", ("paged_",)),
    ("K7 / K9", ("wq_",)),             # before K8: wq_grouped_sm90_kernel
    ("K8", ("grouped_",)), ("K12", ("quant_blockwise",)),
    ("K13", ("ln_fwd", "ln_bwd", "ln_reduce", "rms_fwd")),
    ("cuBLAS", ("nvjet", "gemm", "cutlass")), ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "copy", "fill", "Memset", "Memcpy",
                     "CatArray")))


def profile_family(key):
    for family, marks in PROFILE_FAMILIES:
        if any(m in key for m in marks):
            return family
    return "other"


def write_profile(prof, path, wall_s):
    """Device time by kernel name and by family (PROFILE_FAMILIES), and the
    device's busy share of the profiled run's wall time (one stream, so
    kernel times do not overlap; the profiler's overhead lengthens that
    wall)."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    families = {}
    for key, us, _ in rows:
        family = profile_family(key)
        families[family] = families.get(family, 0) + us
    with open(path, "w") as f:
        f.write(f"wall_s {wall_s:.6f} device_busy_s {busy_us / 1e6:.6f} "
                f"busy_share {busy_us / 1e6 / wall_s:.4f}\n")
        for family, us in sorted(families.items(), key=lambda r: -r[1]):
            f.write(f"family {family}: {us / 1e3:.3f} ms\n")
        for key, us, n in rows:
            f.write(f"{us / 1e3:12.3f} ms {100 * us / busy_us:6.2f}% "
                    f"{n:8d}  {key[:110]}\n")
    log(f"profile -> {path}: device busy {busy_us / 1e6:.3f} s of "
        f"{wall_s:.3f} s wall")


def phase_slice(seed=0, profile=None):
    """Full-width Llama-2-7B serving 8 requests (6 greedy, 2 sampled).
    ``profile``: a path for a torch.profiler breakdown of the serving
    loop (its timings then include the profiler's overhead)."""
    from deepspeed_tpu_torch import InferenceEngineV2, Llama, LLAMA_PRESETS
    from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
    cfg = LLAMA_PRESETS["llama2-7b"]
    t0 = time.perf_counter()
    model = Llama(cfg, device="cuda", dtype=torch.bfloat16, seed=seed)
    eng = InferenceEngineV2(model, dict(
        dtype="bfloat16", kv_block_size=64, max_batch_size=8,
        splitfuse_tokens=256, decode_steps_per_dispatch=8), device="cuda")
    torch.cuda.synchronize()
    log(f"llama2-7b built in {time.perf_counter() - t0:.1f} s: "
        f"{cfg.num_params() / 1e9:.2f}B params, "
        f"{eng.state_mgr.allocator.total_blocks + 1} KV blocks")

    rs = np.random.RandomState(seed)
    lens = rs.randint(64, 2049, 8)
    new = 64
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
    for k in eng.forward_counts:
        eng.forward_counts[k] = 0
    t_start = time.perf_counter()
    uids = []
    for i, n in enumerate(lens):
        sampled = i >= 6
        uids.append(eng.put(rs.randint(0, cfg.vocab_size, (n,)), new,
                            temperature=0.8 if sampled else None,
                            top_k=40 if sampled else None))
    if profile:
        acts = [torch.profiler.ProfilerActivity.CUDA]   # kernels only
        with torch.profiler.profile(activities=acts) as prof:
            first, done = serve(eng, uids)
        e2e = time.perf_counter() - t_start
        write_profile(prof, profile, e2e)
    else:
        first, done = serve(eng, uids)
        e2e = time.perf_counter() - t_start
    launches = dict(pa.LAUNCHES)
    outs = [eng.get(u) for u in uids]

    for u, o in zip(uids, outs):
        assert len(o) == new, (u, len(o))
        assert ((o >= 0) & (o < cfg.vocab_size)).all(), u
    fc = eng.forward_counts
    want = {"paged_decode": cfg.n_layer * fc["decode"],
            "paged_chunk": cfg.n_layer * (fc["chunk"] + fc["prefill"])}
    assert launches == want and min(launches.values()) > 0, (launches, want)
    count_paged_designs(pa, launches)

    ttft = sorted(first[u] - t_start for u in uids)
    tpot = sorted((done[u] - first[u]) / (new - 1) for u in uids)
    stats = dict(
        requests=len(uids), prompt_tokens=int(lens.sum()),
        generated_tokens=int(sum(len(o) for o in outs)),
        ttft_p50_s=float(np.percentile(ttft, 50)),
        tpot_p50_ms=float(np.percentile(tpot, 50)) * 1e3,
        output_tok_per_s=float(sum(len(o) for o in outs) / e2e),
        e2e_s=e2e, forwards=dict(fc), launches=launches,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("slice " + json.dumps(stats))
    return launches


# -------------------------------------------------------- training kernels


def _causal_pairs(T):
    return T * (T + 1) // 2


def flash_with_key_tile_dropped(fa, q, k, v, tile=0, bk=64):
    """The output of a forward kernel that skipped key tile ``tile`` for
    every query past it: the plain version with those keys masked."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    T = q.shape[2]
    i = torch.arange(T, device=q.device)[:, None]
    j = torch.arange(T, device=q.device)[None, :]
    ok = (j <= i) & ~((j >= tile * bk) & (j < (tile + 1) * bk)
                      & (i >= (tile + 1) * bk))
    p = torch.softmax(torch.where(ok, s, fa.NEG_INF), dim=-1)
    return torch.matmul(p, v.float())


def flash_fwd_mma_sync(fa, q, k, v):
    """A call of K1's mma_sync kernel (the design flash_fwd_sm90_kernel
    replaces for bf16 at d = 64 / 128) on the same (B, H, T, d) operands,
    causal; timed beside it only."""
    B, H, T, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device="cuda")
    a = fa._args(B, H, T, D, True, 0, q=q, k=k, v=v, o=o, lse=lse)
    lib = fa.kernel_builder().load()
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.flash_fwd_launch(ctypes.byref(a), 1, stream)
        assert rc == 0, f"flash_fwd mma_sync launch: cudaError {rc}"
        return o, lse
    return call


def flash_sm90_cases(fa, randn):
    """K1's sm90 design (bf16, d = 64 and 128) against its plain version in
    fp32 at the bf16 limits: causal, window and non-causal, T not a
    multiple of the 128-row tile, in the model's (B, T, H, d) strides and
    heads-major; each call repeated bitwise; every launch on sm90."""
    cases = ((4, 8, 1000, 64, True, 0, False),
             (2, 4, 777, 128, True, 300, False),
             (2, 4, 640, 128, False, 0, True),
             (3, 2, 333, 64, True, 100, True),
             (1, 16, 2048, 128, True, 0, False))
    worst = 0.0
    for B, H, T, d, causal, window, heads_major in cases:
        shape = (B, H, T, d) if heads_major else (B, T, H, d)
        q, k, v = (randn(shape) for _ in range(3))
        if not heads_major:
            q, k, v = (x.transpose(1, 2) for x in (q, k, v))
        q = fa.scale_q(q, 1.0 / math.sqrt(d))
        fa.reset_launch_counts()
        o, lse = fa.flash_forward(q, k, v, causal=causal, window=window)
        o2, lse2 = fa.flash_forward(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert fa.DESIGN_LAUNCHES["flash_fwd"]["sm90"] == 2, \
            fa.DESIGN_LAUNCHES
        assert torch.equal(o, o2) and torch.equal(lse, lse2), \
            f"flash_fwd sm90 {shape}: calls differ"
        ro, rlse = fa.flash_forward_reference(
            q.float(), k.float(), v.float(), causal=causal, window=window)
        why = bf16_mismatch(o, ro)
        assert why is None, f"flash_fwd sm90 {shape} causal={causal} " \
            f"window={window}: {why}"
        torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
        worst = max(worst, bf16_errors(o, ro)[1])
        del q, k, v, o, o2, ro
    log(f"flash_fwd sm90 cases ok ({len(cases)}: d 64 / 128, causal, window "
        f"and not, T 333-2048 off the 128-row tile, model and heads-major "
        f"strides; repeats bitwise): max |err| {worst:.3g}")
    return worst


def flash_bwd_as(fa, design, qmajor=False):
    """K2's backward (``qmajor``: K2-qmajor's) through ``design`` whatever
    _bwd_design says (the mma_sync design timed beside the sm90 one)."""
    bwd = fa.flash_backward_qmajor if qmajor else fa.flash_backward

    def run(*args, **kw):
        orig = fa._bwd_design
        fa._bwd_design = lambda *_a, **_k: design
        try:
            return bwd(*args, **kw)
        finally:
            fa._bwd_design = orig
    return run


def kernel_split_ms(fn, iters=10):
    """{kernel name: device ms a launch} of ``fn`` (torch.profiler over
    ``iters`` calls after a warm-up call, each kernel's time over its own
    launch count): how a call of kernels launched once each divides."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / e.count
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def flash_kernel_ms(split, marks):
    """The device ms a call spent in the kernels whose names hold one of
    ``marks`` (from kernel_split_ms), by mark."""
    return {m: sum(ms for k, ms in split.items() if f"{m}<" in k)
            for m in marks}


def bwd_with_query_tile_dropped(fa, q, k, v, o, lse, do, rows):
    """(dk, dv) in fp32 of a dK/dV kernel whose walk skipped the query rows
    ``rows`` (one tile): the plain backward (causal) with those rows' p and
    ds left out of dk and dv."""
    s = torch.matmul(q, k.transpose(-1, -2))
    ok = fa._mask(q.shape[2], True, 0, q.device)
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    del s
    ds = p * (torch.matmul(do, v.transpose(-1, -2))
              - (do * o).sum(-1)[..., None])
    p[:, :, rows] = 0
    ds[:, :, rows] = 0
    dv = torch.matmul(p.to(torch.bfloat16).float().transpose(-1, -2), do)
    del p
    dk = torch.matmul(ds.to(torch.bfloat16).float().transpose(-1, -2), q)
    return dk, dv


def flash_bwd_sm90_cases(fa, randn, qmajor=False):
    """K2's sm90 design (``qmajor``: K2-qmajor's) against the plain backward
    in fp32 by the bf16 check per (b, h) slab: d = 64 and 128, causal and
    not, windows 256 and 100, T = 1000 and others off the 128-row tile, the
    model's (B, T, H, d) strides and heads-major, an lse cotangent; each
    call repeated bitwise, every launch on sm90; K2-qmajor's output bitwise
    equal to K2's sm90 output. Returns the worst slab relative error
    norm."""
    cases = ((4, 8, 1000, 64, True, 0, False, True),
             (2, 8, 1024, 64, True, 256, False, False),
             (2, 4, 777, 128, True, 256, False, True),
             (2, 4, 640, 128, False, 0, True, True),
             (3, 2, 333, 64, True, 100, True, False),
             (2, 4, 640, 64, False, 0, False, False),
             (1, 16, 2048, 128, True, 0, False, False))
    name = "flash_bwd_qmajor" if qmajor else "flash_bwd"
    bwd = fa.flash_backward_qmajor if qmajor else fa.flash_backward
    worst = 0.0
    for B, H, T, d, causal, window, heads_major, dl in cases:
        shape = (B, H, T, d) if heads_major else (B, T, H, d)
        q, k, v, do = (randn(shape) for _ in range(4))
        if not heads_major:
            q, k, v, do = (x.transpose(1, 2) for x in (q, k, v, do))
        q = fa.scale_q(q, 1.0 / math.sqrt(d))
        o, lse = fa.flash_forward(q, k, v, causal=causal, window=window)
        dlse = randn((B, H, T), torch.float32, 0.1) if dl else None
        kw = dict(causal=causal, window=window, dlse=dlse)
        fa.reset_launch_counts()
        got = bwd(q, k, v, o, lse, do, **kw)
        again = bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        assert fa.DESIGN_LAUNCHES[name]["sm90"] == 2, fa.DESIGN_LAUNCHES
        tag = f"{name} sm90 {shape} causal={causal} window={window}"
        assert all(torch.equal(a, b) for a, b in zip(got, again)), \
            f"{tag}: calls differ"
        if qmajor:
            kmajor = fa.flash_backward(q, k, v, o, lse, do, **kw)
            assert fa.DESIGN_LAUNCHES["flash_bwd"]["sm90"] == 1
            assert all(torch.equal(a, b) for a, b in zip(got, kmajor)), \
                f"{tag}: differs from K2's sm90 output"
            del kmajor
        refs = fa.flash_backward_reference(
            *(x.float() for x in (q, k, v, o)), lse, do.float(), **kw)
        for gname, a, r in zip(("dq", "dk", "dv"), got, refs):
            why = bf16_grad_mismatch(a, r)
            assert why is None, f"{tag} {gname}: {why}"
            worst = max(worst, grad_rel_norm(a, r))
        del q, k, v, do, o, got, again, refs
    log(f"{name} sm90 cases ok ({len(cases)}: d 64 / 128, causal and not, "
        f"windows 256 / 100, T 333-2048 off the 128-row tile, model and "
        f"heads-major strides, lse cotangents; repeats bitwise"
        + ("; bitwise equal to K2's sm90" if qmajor else "")
        + f"): worst slab relative error norm {worst:.3g}")
    return worst


def phase_train_kernels(fa, fce, seed=0):
    """K1, K2, K3 at the GPT-2 350M bench shapes (B=24, H=16, T=1024, d=64;
    CE over N = 24 * 512 rows, D=1024, V=50304), checked, controlled and
    timed."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    bf, f32 = torch.bfloat16, torch.float32

    def randn(shape, dtype=bf, s=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * s).to(dtype)

    rows, err = {}, {}
    # ---- fp32 cases (the kernels' fp32 instances, at FP32_TOL)
    for (B, H, T, d, window) in ((2, 4, 200, 64, 0), (1, 2, 333, 128, 100),
                                 (2, 2, 130, 32, 0)):
        q, k, v, do = (randn((B, T, H, d), f32).transpose(1, 2)
                       for _ in range(4))
        q = q * 0.3
        o, lse = fa.flash_forward(q, k, v, window=window)
        ro, rlse = fa.flash_forward_reference(q, k, v, window=window)
        torch.testing.assert_close(o, ro, **FP32_TOL)
        torch.testing.assert_close(lse, rlse, **FP32_TOL)
        grads = fa.flash_backward(q, k, v, o, lse, do, window=window)
        refs = fa.flash_backward_reference(q, k, v, o, lse, do,
                                           window=window)
        for got, ref in zip(grads, refs):
            torch.testing.assert_close(got, ref, **FP32_TOL)
    h32, w32 = randn((300, 128), f32), randn((1000, 128), f32, 0.1)
    t32 = torch.randint(-2, 1002, (300,), generator=g, device="cuda")
    for got, ref in zip(fce.unembed_logits_stats(h32, w32, t32),
                        fce.unembed_logits_stats_reference(h32, w32, t32)):
        torch.testing.assert_close(got, ref, **FP32_TOL)
    log("training kernels: fp32 cases ok (flash fwd/bwd incl. window and "
        "ragged T, fused CE with targets outside [0, V))")

    # ---- bf16 at the slice shapes (the model's (B, T, H, d) layout)
    B, H, T, d = 24, 16, 1024, 64
    q, k, v, do = (randn((B, T, H, d)).transpose(1, 2) for _ in range(4))
    q = fa.scale_q(q, 1.0 / math.sqrt(d))
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    fa.reset_launch_counts()
    o, lse = fa.flash_forward(q, k, v)
    again = fa.flash_forward(q, k, v)
    torch.cuda.synchronize()
    assert fa.DESIGN_LAUNCHES["flash_fwd"]["sm90"] == 2, fa.DESIGN_LAUNCHES
    assert all(torch.equal(a, b) for a, b in zip((o, lse), again)), \
        "flash_fwd does not repeat bitwise"
    del again
    ro, rlse = fa.flash_forward_reference(q32, k32, v32)
    why = bf16_mismatch(o, ro)
    assert why is None, f"flash_fwd: {why}"
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
    sm90_err = flash_sm90_cases(fa, randn)
    n_over, e, rel = bf16_errors(o, ro)
    err["flash_fwd"] = (n_over, max(e, sm90_err), rel)
    # controls: one 128-key K/V tile of the sm90 design skipped (tile 1,
    # for every query past it), and the first 64-key tile
    for tile, bk in ((1, 128), (0, 64)):
        dropped = flash_with_key_tile_dropped(fa, q32, k32, v32, tile,
                                              bk).to(bf)
        why = bf16_mismatch(dropped, ro)
        assert why is not None, \
            f"bf16 check let a dropped {bk}-key tile {tile} pass"
        log(f"control: flash forward with {bk}-key tile {tile} skipped "
            f"fails ({why})")
        del dropped

    fa.reset_launch_counts()
    grads = fa.flash_backward(q, k, v, o, lse, do)
    again = fa.flash_backward(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert fa.DESIGN_LAUNCHES["flash_bwd"]["sm90"] == 2, fa.DESIGN_LAUNCHES
    assert all(torch.equal(a, b) for a, b in zip(grads, again)), \
        "flash_bwd does not repeat bitwise"
    del again
    refs = fa.flash_backward_reference(q32, k32, v32, o.float(), lse, do32)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        why = bf16_grad_mismatch(got, ref)
        assert why is None, f"flash_bwd {name}: {why}"
    err["flash_bwd"] = (0, max((a.float() - b).abs().max().item()
                               for a, b in zip(grads, refs)),
                        max(grad_rel_norm(a, b) for a, b in zip(grads, refs)))
    do_cut = do32.clone()
    do_cut[:, :, 512:576] = 0          # query tile 8 skipped
    cut = fa.flash_backward_reference(q32, k32, v32, o.float(), lse, do_cut)
    why = bf16_grad_mismatch(cut[0].to(bf), refs[0])
    assert why is not None, "grad check let a skipped query tile pass"
    log(f"control: flash backward with query tile 8 skipped fails dq "
        f"({why})")
    del cut, do_cut, grads
    # control: the dK/dV walk without its second 128-query tile
    cut = bwd_with_query_tile_dropped(fa, q32, k32, v32, o.float(), lse,
                                      do32, slice(128, 256))
    for name, c, ref in zip(("dk", "dv"), cut, refs[1:]):
        why = bf16_grad_mismatch(c.to(bf), ref)
        assert why is not None, \
            f"grad check let {name} without query tile 1 pass"
        log(f"control: flash backward's {name} without query tile 1 of "
            f"the dK/dV walk fails ({why})")
    del refs, cut
    sm90_bwd = flash_bwd_sm90_cases(fa, randn)
    err["flash_bwd"] = err["flash_bwd"][:2] + (
        max(err["flash_bwd"][2], sm90_bwd),)

    # K3 bf16 (the sm90 design) at a ragged N and V: rows and vocab tiles
    # cut by the 128 x 256 tile, targets outside [0, V) and in the ragged
    # last vocab tile
    Nr, Vr = 1000, 50000
    hr, wr = randn((Nr, 1024)), randn((Vr, 1024), s=0.02)
    tr = torch.randint(0, Vr, (Nr,), generator=g, device="cuda")
    tr[:4] = torch.tensor([-1, Vr, Vr + 7, Vr - 1])
    tr[4:40] = torch.randint(Vr - Vr % fce.SM90_BLOCK_V, Vr, (36,),
                             generator=g, device="cuda")
    fce.reset_launch_counts()
    got = fce.unembed_logits_stats(hr, wr, tr)
    assert_sm90("fused_ce ragged", fce)
    ref = fce.unembed_logits_stats_reference(hr.float(), wr.float(), tr)
    why = bf16_mismatch(got[0], ref[0])
    assert why is None, f"fused_ce logits N={Nr} V={Vr}: {why}"
    for name, a, b in zip(("logz", "gold"), got[1:], ref[1:]):
        e = (a - b).abs().max().item()
        assert e <= CE_STAT_ATOL, f"fused_ce {name} N={Nr} V={Vr}: {e:.3g}"
    assert (got[2][:3] == 0).all(), "gold of a target outside [0, V)"
    log(f"fused CE bf16 at N={Nr} V={Vr} (ragged rows and vocab tiles, "
        f"targets outside [0, V) and in the last tile) ok")
    del hr, wr, got, ref

    N, D, V = B * 512, 1024, 50304
    h, w = randn((N, D)), randn((V, D), s=0.02)
    t = torch.randint(0, V, (N,), generator=g, device="cuda")
    logits, logz, gold = fce.unembed_logits_stats(h, w, t)
    again = fce.unembed_logits_stats(h, w, t)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((logits, logz, gold),
                                                 again)), \
        "fused_ce does not repeat bitwise"
    del again
    rl, rz, rg = fce.unembed_logits_stats_reference(h.float(), w.float(), t)
    why = bf16_mismatch(logits, rl)
    assert why is None, f"fused_ce logits: {why}"
    for name, got, ref in (("logz", logz, rz), ("gold", gold, rg)):
        e = (got - ref).abs().max().item()
        assert e <= CE_STAT_ATOL, f"fused_ce {name}: max |err| {e:.3g}"
    err["fused_ce"] = bf16_errors(logits, rl)
    # control: the vocab tile holding each row's target skipped
    tile = t // fce.SM90_BLOCK_V
    col = torch.arange(V, device="cuda")
    skip = (col[None, :] // fce.SM90_BLOCK_V) == tile[:, None]
    ctrl_z = torch.logsumexp(rl.masked_fill(skip, -1e30), dim=-1)
    ctrl_e = max((ctrl_z - rz).abs().max().item(), rg.abs().max().item())
    assert ctrl_e > CE_STAT_ATOL, "CE check let a skipped vocab tile pass"
    log(f"control: fused CE with each row's target tile skipped fails "
        f"(max |err| {ctrl_e:.3g} > {CE_STAT_ATOL})")
    del rl, skip, col
    log(f"training kernel checks ok at the slice shapes: max |err| flash "
        f"fwd {err['flash_fwd'][1]:.3g}, flash bwd {err['flash_bwd'][1]:.3g} "
        f"(worst slab rel norm {err['flash_bwd'][2]:.3g}), fused CE logits "
        f"{err['fused_ce'][1]:.3g}; fused CE logz/gold within "
        f"{CE_STAT_ATOL}, repeats bitwise")

    # ---- timing
    esz = 2
    pairs = B * H * _causal_pairs(T)
    act = B * T * H * d * esz
    fwd_bytes = 4 * act + B * H * T * 4
    bwd_bytes = 8 * act + B * H * T * 4
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa_o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                            scale=1.0)
    rows["flash_fwd"] = dict(
        ms=time_ms(lambda: fa.flash_forward(q, k, v), 20),
        mma_sync_ms=time_ms(flash_fwd_mma_sync(fa, q, k, v), 20),
        plain_ms=time_ms(lambda: fa.flash_forward_reference(q, k, v), 3),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=1.0), 20),
        bound=bound(fwd_bytes, 4 * d * pairs))
    bwd_mma_sync = flash_bwd_as(fa, "mma_sync")
    rows["flash_bwd"] = dict(
        ms=time_ms(lambda: fa.flash_backward(q, k, v, o, lse, do), 10),
        mma_sync_ms=time_ms(lambda: bwd_mma_sync(q, k, v, o, lse, do), 10),
        plain_ms=time_ms(lambda: fa.flash_backward_reference(
            q, k, v, o, lse, do), 2),
        library_ms=time_ms(lambda: torch.autograd.grad(
            sdpa_o, (qs, ks, vs), do, retain_graph=True), 10),
        bound=bound(bwd_bytes, 10 * d * pairs))
    # each design's three kernels, from the profiler
    split = flash_kernel_ms(
        kernel_split_ms(lambda: fa.flash_backward(q, k, v, o, lse, do)),
        ("flash_delta_kernel", "flash_dkdv_sm90_kernel",
         "flash_dq_sm90_kernel"))
    rows["flash_bwd"]["delta_ms"] = split["flash_delta_kernel"]
    rows["flash_bwd"]["split_ms"] = split
    rows["flash_bwd"]["mma_sync_split_ms"] = flash_kernel_ms(
        kernel_split_ms(lambda: bwd_mma_sync(q, k, v, o, lse, do)),
        ("flash_delta_kernel", "flash_dkdv_kernel", "flash_dq_kernel"))
    log(f"flash_bwd kernels a call (device ms, profiler): sm90 {split}, "
        f"mma_sync {rows['flash_bwd']['mma_sync_split_ms']}")
    del sdpa_o, qs, ks, vs
    ce_bytes = (N * D + V * D + N * V) * esz + N * 4 + 2 * N * 4
    rows["fused_ce"] = dict(
        ms=time_ms(lambda: fce.unembed_logits_stats(h, w, t), 5),
        plain_ms=time_ms(lambda: fce.unembed_logits_stats_reference(
            h, w, t), 2),
        library_ms=time_ms(lambda: torch.mm(h, w.t()), 10),
        bound=bound(ce_bytes, 2 * N * V * D))
    log(f"flash timed case: B={B} H={H} T={T} d={d} causal, {pairs} (q, k) "
        f"pairs, fwd {fwd_bytes} bytes / {4 * d * pairs} flops, bwd "
        f"{bwd_bytes} bytes / {10 * d * pairs} flops; fused CE: N={N} D={D} "
        f"V={V}, {ce_bytes} bytes / {2 * N * V * D} flops; library calls: "
        f"SDPA is_causal forward, SDPA backward (autograd.grad), cuBLAS "
        f"h @ w^T alone (no single call gives the CE stats)")
    for name, r in rows.items():
        r["max_abs_err"] = err[name][1]
        mma = (f"the mma_sync design {r['mma_sync_ms']:.4f}, "
               if "mma_sync_ms" in r else "")
        log(f"{name}: {r['ms']:.4f} ms ({mma}plain {r['plain_ms']:.4f}, "
            f"library {r['library_ms']:.4f}, bound {r['bound'][0]:.4f} by "
            f"{r['bound'][1]})")
    del h, w, q, k, v, do, o, lse
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------- training parity


def phase_train_parity(seed=0):
    """Small fp32 GPT-2: kernels on (flash + fused CE kernel, save_flash)
    and off (dense attention + fused_linear_xent, no remat) give the same
    loss (rtol 1e-5) and every gradient within a relative error norm of
    1e-4 (fp32 sums in another order through two softmaxes and the CE)."""
    from deepspeed_tpu_torch import GPT2, GPT2Config
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import fused_ce as fce
    base = dict(n_layer=2, n_head=2, d_model=128, max_seq_len=256,
                vocab_size=1000, dtype="float32", loss_chunk=100,
                fused_loss=True)
    on = dict(use_flash_attention=True, fused_loss_kernel=True, remat=True,
              remat_policy="save_flash")
    off = dict(use_flash_attention=False, fused_loss_kernel=False,
               remat=False)
    ids = torch.from_numpy(np.random.RandomState(seed).randint(
        0, 1000, (4, 256))).cuda()
    out = {}
    for name, over in (("on", on), ("off", off)):
        model = GPT2(GPT2Config(**base, **over), device="cuda", seed=seed)
        fa.reset_launch_counts()
        fce.reset_launch_counts()
        loss = model.loss({"input_ids": ids})
        loss.backward()
        torch.cuda.synchronize()
        launched = {**fa.LAUNCHES, **fce.LAUNCHES}
        want = ({"flash_fwd": 2, "flash_bwd": 2, "fused_ce": 3}
                if name == "on" else
                {"flash_fwd": 0, "flash_bwd": 0, "fused_ce": 0})
        want.update(flash_bwd_qmajor=0, flash_block_fwd=0)
        assert launched == want, (name, launched)
        out[name] = (loss.item(), {n: p.grad for n, p in
                                   model.named_parameters()})
    (l_on, g_on), (l_off, g_off) = out["on"], out["off"]
    assert abs(l_on - l_off) <= 1e-5 * abs(l_off), (l_on, l_off)
    worst = 0.0
    for n, g in g_off.items():
        rel = (torch.linalg.vector_norm(g_on[n] - g)
               / torch.linalg.vector_norm(g)).item()
        assert rel <= 1e-4, (n, rel)
        worst = max(worst, rel)
    log(f"training parity ok: kernels on vs off, loss {l_on:.7f} vs "
        f"{l_off:.7f}, worst gradient relative error norm {worst:.3g}")


# ----------------------------------------------------------- training slice


def phase_train_slice(seed=0, steps=10, profile=None, knobs=None,
                      tag="train slice", main_path=True):
    """GPT-2 350M through initialize -> train_batch with the bench config
    (benchmarks/bench_engine.py:46-77, :182-206): T=1024, micro 24, gas 1,
    AdamW lr 2e-4 wd 0.01, clip 1.0, bf16, ZeRO 2, save_flash, loss chunk
    512 with the fused CE kernel. One fixed numpy-seeded batch, as bench.py
    does. ``knobs``: GPT2Config fields set on top (phase 20: the K13 and
    K6 knobs; phase 24: flash_bwd_qmajor); the launch counts they imply
    are checked too (``main_path``: and its launches by design counted
    for the kernels line). The run's numbers go to TRAIN_STATS[tag]."""
    import dataclasses
    from deepspeed_tpu_torch import GPT2, GPT2_PRESETS, initialize
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import fused_ce as fce
    from deepspeed_tpu_torch.ops.cuda import layernorm as ln
    from deepspeed_tpu_torch.ops.cuda import mlp_matmul as mm
    knobs = knobs or {}
    cfg = dataclasses.replace(
        GPT2_PRESETS["350M"], max_seq_len=1024, use_flash_attention=True,
        flash_block_q=1024, flash_block_k=1024, flash_block_h=1,
        remat=True, remat_policy="save_flash", loss_chunk=512,
        fused_loss=True, fused_loss_kernel=True, **knobs)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    engine, _, _, _ = initialize(
        model=GPT2(cfg, device="cuda", seed=seed),
        config={"train_micro_batch_size_per_gpu": 24,
                "gradient_accumulation_steps": 1, "steps_per_print": 0,
                "optimizer": {"type": "AdamW",
                              "params": {"lr": 2e-4, "weight_decay": 0.01}},
                "gradient_clipping": 1.0, "bf16": {"enabled": True},
                "zero_optimization": {"stage": 2}})
    torch.cuda.synchronize()
    bsz = engine.config.train_batch_size
    log(f"gpt2-350M engine built in {time.perf_counter() - t0:.1f} s: "
        f"{cfg.num_params() / 1e6:.1f}M params, batch {bsz} x 1024"
        + (f", knobs {knobs}" if knobs else ""))
    batch = {"input_ids": np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (bsz, cfg.max_seq_len)).astype(np.int32)}

    mods = (fa, fce, ln, mm)
    torch.cuda.reset_peak_memory_stats()
    for mod in mods:
        mod.reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    L = cfg.n_layer
    qmajor = cfg.flash_bwd_qmajor is True
    want = {"flash_fwd": L * steps,
            "flash_bwd": 0 if qmajor else L * steps,
            "flash_bwd_qmajor": L * steps if qmajor else 0,
            "flash_block_fwd": 0, "fused_ce": 2 * steps, "wq_matmul": 0,
            **knob_launches(cfg, L, steps, chunks=2)}
    assert launches == want, (launches, want)
    assert_sm90(tag, fa, fce, mm, main_path=main_path)
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    step_s = float(np.median(times[1:]))
    tokens = bsz * cfg.max_seq_len
    stats = dict(
        steps=steps, losses=losses, step_s=times,
        step_s_median_after_first=step_s,
        tokens_per_s=tokens / step_s,
        model_tflops_per_s=cfg.flops_per_token() * tokens / step_s / 1e12,
        launches=launches,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    TRAIN_STATS[tag] = stats
    log(f"{tag} " + json.dumps(stats))
    if profile:
        acts = [torch.profiler.ProfilerActivity.CUDA]
        t1 = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                engine.train_batch(batch)
            torch.cuda.synchronize()
        write_profile(prof, profile, time.perf_counter() - t1)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches


TRAIN_STATS = {}


def knob_launches(cfg, L, steps, chunks):
    """K13 / K6 launches a GPT-2 training run of ``steps`` steps implies
    under save_flash with the fused CE head over ``chunks`` loss chunks:
    LayerNorm forwards for ln1 and ln2 in the forward and in save_flash's
    re-run, and for lnf per chunk; backwards for ln1, ln2 and lnf per
    chunk (the "bwd" knob: backwards only). K6 per layer: each product
    through it in the forward, its re-run and its dx; one dW each (none
    with fuse_dw=False)."""
    ln = cfg.fused_layernorm
    fwd = ln not in (False, "bwd", "auto")
    bwd = bool(ln) and ln != "auto"
    mode = cfg.mlp_kernel
    k6 = 0 if not mode or mode == "auto" else (2 if mode == "both" else 1)
    return {"layernorm_fwd": (4 * L + chunks) * steps if fwd else 0,
            "layernorm_bwd": (2 * L + chunks) * steps if bwd else 0,
            "mlp_mm": 3 * k6 * L * steps,
            "mlp_dw": k6 * L * steps if cfg.mlp_kernel_fuse_dw else 0,
            "rmsnorm_fwd": 0}


# ------------------------------------------------------------- MoE kernels


def routed_sizes(rs, tokens, E, k):
    """Rows per expert when each of ``tokens`` tokens picks k distinct
    experts uniformly (what top-k routing through random weights gives)."""
    sizes = np.zeros(E, np.int64)
    for _ in range(tokens):
        sizes[rs.choice(E, k, replace=False)] += 1
    return [int(s) for s in sizes]


def grouped_bound(M, K, N, sizes, n_w):
    """Bound of one grouped call: x read once, each touched expert's
    ``n_w`` weight tensors read once, the output written once; operations
    on the routed rows only."""
    live = min(sum(sizes), M)
    touched = sum(1 for s in sizes if s > 0)
    nbytes = (M * K + n_w * touched * K * N + M * N) * 2 + len(sizes) * 4
    return bound(nbytes, 2 * n_w * live * K * N)


def grouped_library(x, w, sizes):
    """(fn, name): one PyTorch call computing x w[g] per group, timed as a
    yardstick only: ``torch._grouped_mm`` where this torch has it, else a
    cuBLAS matmul per group."""
    gmm_op = getattr(torch, "_grouped_mm", None)
    if gmm_op is not None:
        offs = torch.tensor(np.cumsum(sizes), dtype=torch.int32,
                            device="cuda")
        return (lambda: gmm_op(x, w, offs=offs)), "torch._grouped_mm"
    bounds, start = [], 0
    for e, n in enumerate(sizes):
        if n:
            bounds.append((e, start, start + n))
        start += n
    out = torch.empty(x.shape[0], w.shape[2], dtype=x.dtype, device="cuda")

    def loop():
        for e, lo, hi in bounds:
            torch.mm(x[lo:hi], w[e], out=out[lo:hi])
        return out
    return loop, "cuBLAS torch.mm per group"


class MoECases:
    """The grouped kernels on Mixtral-8x7B-width experts, each call held
    against its plain version: bf16 against the plain version in fp32 on
    the same inputs (bf16_mismatch), fp32 at FP32_TOL; the rows past the
    groups exactly 0; grouped_swiglu_up on the design its rule names
    (``designs``: (rows, design) of each case) and repeated bitwise."""

    def __init__(self, gm, D=4096, Fd=14336, E=8, seed=0):
        self.gm = gm
        self.g = torch.Generator(device="cuda")
        self.g.manual_seed(seed)
        self.w1, self.w3 = (self.randn((E, D, Fd), s=0.02) for _ in range(2))
        self.w2 = self.randn((E, Fd, D), s=0.02)
        self.err = {"grouped_swiglu_up": 0.0, "grouped_gmm": 0.0}
        self.rel = dict(self.err)
        self.designs = []

    def randn(self, shape, dtype=torch.bfloat16, s=1.0):
        return (torch.randn(shape, generator=self.g, device="cuda")
                * s).to(dtype)

    def run(self, M, sizes, dtype=torch.bfloat16):
        gm = self.gm
        ws = [w.to(dtype) for w in (self.w1, self.w3, self.w2)]
        x = self.randn((M, ws[0].shape[1]), dtype)
        gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        design = gm._swiglu_up_design(x, ws[0], ws[1])
        gm.reset_launch_counts()
        h = gm.grouped_swiglu_up(x, ws[0], ws[1], gs)
        out = gm.grouped_matmul(h, ws[2], gs)
        again = gm.grouped_swiglu_up(x, ws[0], ws[1], gs)
        torch.cuda.synchronize()
        assert gm.DESIGN_LAUNCHES["grouped_swiglu_up"][design] == 2 == \
            gm.LAUNCHES["grouped_swiglu_up"], (sizes, gm.DESIGN_LAUNCHES)
        assert torch.equal(h, again), f"swiglu_up {sizes}: calls differ"
        self.designs.append((M, design))
        del again
        live = min(sum(sizes), M)
        assert (h[live:] == 0).all() and (out[live:] == 0).all(), \
            f"rows past the groups not zero (sizes {sizes})"
        w32 = [w.float() for w in ws]
        refs = {"grouped_swiglu_up": gm.grouped_swiglu_up_reference(
                    x.float(), w32[0], w32[1], gs),
                "grouped_gmm": gm.grouped_matmul_reference(
                    h.float(), w32[2], gs)}
        for name, got in (("grouped_swiglu_up", h), ("grouped_gmm", out)):
            ref = refs[name]
            if dtype == torch.float32:
                torch.testing.assert_close(got, ref, **FP32_TOL)
            elif live:
                why = bf16_mismatch(got[:live], ref[:live])
                assert why is None, f"{name} (sizes {sizes}): {why}"
                _, e, r = bf16_errors(got[:live], ref[:live])
                self.err[name] = max(self.err[name], e)
                self.rel[name] = max(self.rel[name], r)
        return dict(x=x, h=h, gs=gs, sizes=sizes, w32=w32, refs=refs)

    def control(self, c):
        """One group's rows multiplied by the next expert's weights (as a
        kernel that read the wrong group's tile would give) must fail the
        bf16 check, for each kernel."""
        sizes, w32 = c["sizes"], c["w32"]
        E = len(sizes)
        e = next(i for i, n in enumerate(sizes) if n)
        lo = sum(sizes[:e])
        hi = lo + sizes[e]
        nb = (e + 1) % E
        xs, hs = c["x"][lo:hi].float(), c["h"][lo:hi].float()
        w1, w3 = w32[0][e], w32[1][e]
        K, Fd = w1.shape
        # the sm90 design's weight boxes: 64 features a consumer, 64 k a
        # slice
        swapped = w1.view(K, Fd // 128, 2, 64).flip(2).reshape(K, Fd)
        kept = torch.ones(K, 1, device="cuda")
        kept[64:128] = 0
        wrong = [
            ("grouped_swiglu_up", "a wrong expert",
             F.silu(xs @ w32[0][nb]) * (xs @ w32[1][nb])),
            ("grouped_swiglu_up", "w1's 64-feature halves swapped",
             F.silu(xs @ swapped) * (xs @ w3)),
            ("grouped_swiglu_up", "k slice 1 of w1 and w3 dropped",
             F.silu(xs @ (w1 * kept)) * (xs @ (w3 * kept))),
            ("grouped_gmm", "a wrong expert", hs @ w32[2][nb])]
        out = []
        for name, label, rows in wrong:
            ctrl = c["refs"][name].clone()
            ctrl[lo:hi] = rows
            why = bf16_mismatch(ctrl.to(torch.bfloat16), c["refs"][name])
            assert why is not None, f"{name}: check let {label} pass"
            out.append(f"{name}, {label}: {why}")
        return out


def phase_moe_kernels(gm, seed=0):
    """K8's two forward kernels at the Mixtral-8x7B serving shapes,
    checked, controlled and timed (decode: 8 slots x top-2 = 16 rows;
    chunk: 256 tokens x top-2 = 512 rows)."""
    rs = np.random.RandomState(seed)
    cases = MoECases(gm, seed=seed)
    dec_sizes = routed_sizes(rs, 8, 8, 2)
    chk_sizes = routed_sizes(rs, 256, 8, 2)
    dec = cases.run(16, dec_sizes)
    chk = cases.run(512, chk_sizes)
    cases.run(512, [100, 0, 50, 30, 120, 80, 0, 132])     # empty groups
    cases.run(512, [0, 0, 0, 512, 0, 0, 0, 0])            # one expert
    cases.run(512, [0] * 8)                               # all empty
    cases.run(512, [40, 60, 0, 20, 100, 0, 80, 50])       # 162-row tail
    cases.run(16, dec_sizes, torch.float32)
    cases.run(100, [30, 0, 20, 10, 5, 0, 15, 10], torch.float32)
    log(f"MoE kernel cases ok: decode sizes {dec_sizes}, chunk sizes "
        f"{chk_sizes}; max bf16 |err| swiglu_up "
        f"{cases.err['grouped_swiglu_up']:.3g} (worst row relative error "
        f"norm {cases.rel['grouped_swiglu_up']:.3g}), gmm "
        f"{cases.err['grouped_gmm']:.3g} "
        f"({cases.rel['grouped_gmm']:.3g}); fp32 cases at 1e-4; tails 0")
    log(f"grouped_swiglu_up by the rule (rows, design): {cases.designs}; "
        f"every call repeated bitwise")
    for line in cases.control(dec):
        log(f"control: one group's rows fail ({line})")
    for c in (dec, chk):
        del c["w32"], c["refs"]
    torch.cuda.empty_cache()

    shapes = {}
    for tag, c in (("decode", dec), ("chunk", chk)):
        x, h, gs, sizes = c["x"], c["h"], c["gs"], c["sizes"]
        M, D = x.shape
        Fd = h.shape[1]
        up_lib, up_name = grouped_library(x, cases.w1, sizes)
        up_lib3, _ = grouped_library(x, cases.w3, sizes)
        dn_lib, dn_name = grouped_library(h, cases.w2, sizes)
        # the designs _gmm_design and _swiglu_up_design pick at this row
        # count, as launched
        gmm_design = gm._gmm_design(h, cases.w2)
        up_design = gm._swiglu_up_design(x, cases.w1, cases.w3)
        gm.reset_launch_counts()
        gm.grouped_matmul(h, cases.w2, gs)
        assert gm.DESIGN_LAUNCHES["grouped_gmm"][gmm_design] == 1, \
            (tag, gmm_design, gm.DESIGN_LAUNCHES)
        r = {
            "grouped_swiglu_up": dict(
                # device time with the launches queued, each design
                ms=time_queued(lambda: gm.grouped_swiglu_up(
                    x, cases.w1, cases.w3, gs), 30)[0],
                design=up_design,
                row_tile=gm.wq_grouped_plan(M, len(sizes)),
                sm90_ms=time_queued(lambda: gm._swiglu_up(
                    x, cases.w1, cases.w3, gs, design="sm90"), 30)[0],
                mma_sync_ms=time_queued(lambda: gm._swiglu_up(
                    x, cases.w1, cases.w3, gs, design="mma_sync"), 30)[0],
                plain_ms=time_ms(lambda: gm.grouped_swiglu_up_reference(
                    x, cases.w1, cases.w3, gs), 3),
                library_ms=time_ms(lambda: F.silu(up_lib()) * up_lib3(), 30),
                bound=grouped_bound(M, D, Fd, sizes, 2)),
            "grouped_gmm": dict(
                ms=time_ms(lambda: gm.grouped_matmul(h, cases.w2, gs), 30),
                design=gmm_design,
                sm90_ms=time_ms(gmm_call(gm, h, cases.w2, gs, "sm90"), 30),
                mma_sync_ms=time_ms(gmm_call(gm, h, cases.w2, gs,
                                             "mma_sync"), 30),
                plain_ms=time_ms(lambda: gm.grouped_matmul_reference(
                    h, cases.w2, gs), 3),
                library_ms=time_ms(dn_lib, 30),
                bound=grouped_bound(M, Fd, D, sizes, 1))}
        log(f"MoE {tag} ({M} rows, sizes {sizes}); library calls: "
            f"{up_name} x2 + silu*mul, {dn_name}")
        for name, t in r.items():
            t["max_abs_err"] = cases.err[name]
            t["shape"] = f"{tag}: {M} rows"
            designs = (f"; {t['design']} by the rule: sm90 "
                       f"{t['sm90_ms']:.4f}, mma_sync {t['mma_sync_ms']:.4f}"
                       if "design" in t else "")
            log(f"  {name}: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, "
                f"library {t['library_ms']:.4f}, bound {t['bound'][0]:.4f} "
                f"by {t['bound'][1]}{designs})")
        shapes[tag] = r
    rows = shapes["decode"]
    for name in rows:
        rows[name]["chunk"] = {k: shapes["chunk"][name][k] for k in
                               ("ms", "plain_ms", "library_ms", "design",
                                "sm90_ms", "mma_sync_ms", "row_tile")
                               if k in shapes["chunk"][name]}
        rows[name]["chunk"]["bound_ms"] = shapes["chunk"][name]["bound"][0]
    del cases, dec, chk
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# -------------------------------------------------------------- MoE parity


def phase_moe_parity():
    """Small fp32 Mixtral: grouped_kernel on and off give identical greedy
    streams; with the kernels on, each launches once per layer and
    forward."""
    from deepspeed_tpu_torch import MIXTRAL_TINY, InferenceEngineV2, Mixtral
    from deepspeed_tpu_torch.ops.cuda import grouped_matmul as gm
    cfg = dataclasses.replace(MIXTRAL_TINY, dtype="float32", max_seq_len=512)
    model = Mixtral(cfg, device="cuda", dtype=torch.float32, seed=7)
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 512, (n,)) for n in (5, 16, 37, 300)]
    for splitfuse in (64, 0):
        streams = {}
        for gk in (True, False):
            model.grouped_kernel = gk
            gm.reset_launch_counts()
            eng = InferenceEngineV2(model, dict(
                dtype="float32", kv_block_size=16, max_batch_size=4,
                prompt_bucket=64, splitfuse_tokens=splitfuse), device="cuda")
            streams[gk] = eng.generate_all(prompts, max_new_tokens=24)
            n = cfg.n_layer * sum(eng.forward_counts.values()) if gk else 0
            assert gm.LAUNCHES == {"grouped_swiglu_up": n, "grouped_gmm": n,
                                   "grouped_tgmm": 0, **NO_WQ}, \
                (gk, dict(gm.LAUNCHES))
        for a, b in zip(streams[True], streams[False]):
            np.testing.assert_array_equal(a, b)
        log(f"MoE parity ok (splitfuse={splitfuse}): grouped kernels on == "
            f"off greedy streams, {sum(len(s) for s in streams[True])} "
            f"tokens")
        del eng
    torch.cuda.empty_cache()


# --------------------------------------------------------------- MoE slice


def phase_moe_slice(seed=0, n_layer=24, profile=None):
    """Mixtral-8x7B widths at ``n_layer`` layers (the deepest that fits one
    80 GB card in bf16 beside the KV pool) serving phase 4's traffic."""
    from deepspeed_tpu_torch import MIXTRAL_8X7B, InferenceEngineV2, Mixtral
    from deepspeed_tpu_torch.models import mixtral as mx
    from deepspeed_tpu_torch.ops.cuda import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    assert left < 1e9, f"earlier phases left {left / 1e9:.2f} GB allocated"
    cfg = dataclasses.replace(MIXTRAL_8X7B, n_layer=n_layer)
    t0 = time.perf_counter()
    model = Mixtral(cfg, device="cuda", dtype=torch.bfloat16, seed=seed)
    eng = InferenceEngineV2(model, dict(
        dtype="bfloat16", kv_block_size=64, max_batch_size=8,
        splitfuse_tokens=256, decode_steps_per_dispatch=8,
        num_kv_blocks=513), device="cuda")
    torch.cuda.synchronize()
    log(f"mixtral-8x7b ({n_layer} layers) built in "
        f"{time.perf_counter() - t0:.1f} s: {cfg.num_params() / 1e9:.2f}B "
        f"params, {eng.state_mgr.allocator.total_blocks + 1} KV blocks, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")

    # the group sizes of the first decode step, one per layer (device
    # tensors kept as they are: no sync inside the serving loop)
    first_decode = []
    sort = mx.sort_by_expert

    def recording_sort(experts, E):
        order, sizes = sort(experts, E)
        if experts.shape[0] == 8 and len(first_decode) < n_layer:
            first_decode.append(sizes)
        return order, sizes

    up_rows = {}                 # grouped_swiglu_up's design -> its row counts
    up_design = gm._swiglu_up_design

    def recording_up_design(x, w1, w3):
        design = up_design(x, w1, w3)
        up_rows.setdefault(design, set()).add(x.shape[0])
        return design

    rs = np.random.RandomState(seed)
    lens = rs.randint(64, 2049, 8)
    new = 64
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
    gm.reset_launch_counts()
    for k in eng.forward_counts:
        eng.forward_counts[k] = 0
    mx.sort_by_expert = recording_sort
    gm._swiglu_up_design = recording_up_design
    try:
        t_start = time.perf_counter()
        uids = []
        for i, n in enumerate(lens):
            sampled = i >= 6
            uids.append(eng.put(rs.randint(0, cfg.vocab_size, (n,)), new,
                                temperature=0.8 if sampled else None,
                                top_k=40 if sampled else None))
        if profile:
            acts = [torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                first, done = serve(eng, uids)
            e2e = time.perf_counter() - t_start
            write_profile(prof, profile, e2e)
        else:
            first, done = serve(eng, uids)
            e2e = time.perf_counter() - t_start
    finally:
        mx.sort_by_expert = sort
        gm._swiglu_up_design = up_design
    launches = {**pa.LAUNCHES, **gm.LAUNCHES}
    outs = [eng.get(u) for u in uids]

    for u, o in zip(uids, outs):
        assert len(o) == new, (u, len(o))
        assert ((o >= 0) & (o < cfg.vocab_size)).all(), u
    fc = eng.forward_counts
    forwards = fc["prefill"] + fc["chunk"] + fc["decode"]
    want = {"paged_decode": n_layer * fc["decode"],
            "paged_chunk": n_layer * (fc["chunk"] + fc["prefill"]),
            "grouped_swiglu_up": n_layer * forwards,
            "grouped_gmm": n_layer * forwards}
    assert launches.pop("grouped_tgmm") == 0, "serving ran a backward kernel"
    assert all(launches.pop(k) == 0 for k in NO_WQ), "bf16 ran a wq kernel"
    assert launches == want and min(launches.values()) > 0, (launches, want)
    count_paged_designs(pa, launches)
    # grouped_gmm by _gmm_design: every bf16 forward, decode and chunk, on
    # sm90
    gmm_by = dict(gm.DESIGN_LAUNCHES["grouped_gmm"])
    assert gmm_by == {"sm90": launches["grouped_gmm"], "mma_sync": 0,
                      "fp32": 0}, (gmm_by, launches)
    count_designs("grouped_gmm", gmm_by)
    # grouped_swiglu_up by _swiglu_up_design: every bf16 call of at least
    # SWIGLU_UP_SM90_MIN_ROWS rows (each chunk's among them) on sm90, the
    # rest on mma_sync
    up_by = dict(gm.DESIGN_LAUNCHES["grouped_swiglu_up"])
    assert sum(up_by.values()) == launches["grouped_swiglu_up"] and \
        not up_by["fp32"] and up_by["sm90"], (up_by, launches)
    assert all(r >= gm.SWIGLU_UP_SM90_MIN_ROWS
               for r in up_rows.get("sm90", ())) and all(
        r < gm.SWIGLU_UP_SM90_MIN_ROWS
        for r in up_rows.get("mma_sync", ())), up_rows
    count_designs("grouped_swiglu_up", up_by)

    hist = [s.tolist() for s in first_decode]
    ttft = sorted(first[u] - t_start for u in uids)
    tpot = sorted((done[u] - first[u]) / (new - 1) for u in uids)
    stats = dict(
        n_layer=n_layer, requests=len(uids), prompt_tokens=int(lens.sum()),
        generated_tokens=int(sum(len(o) for o in outs)),
        ttft_p50_s=float(np.percentile(ttft, 50)),
        tpot_p50_ms=float(np.percentile(tpot, 50)) * 1e3,
        output_tok_per_s=float(sum(len(o) for o in outs) / e2e),
        e2e_s=e2e, forwards=dict(fc), launches=launches,
        grouped_gmm_designs=gmm_by, grouped_swiglu_up_designs=up_by,
        grouped_swiglu_up_rows={k: sorted(v) for k, v in up_rows.items()},
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        first_decode_expert_load=hist)
    log("moe slice " + json.dumps(stats))
    assert len(hist) == n_layer and all(sum(h) == 16 for h in hist), hist
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches[k] for k in ("grouped_swiglu_up", "grouped_gmm")}


# ------------------------------------------------------ MoE backward kernels


def slab_rel_norm(out, ref):
    """The worst leading-dim slab's relative error norm of ``out`` vs the
    fp32 ``ref`` (an all-zero slab of ``ref`` must come out exactly 0)."""
    diff = (out.float() - ref).flatten(1)
    den = torch.linalg.vector_norm(ref.flatten(1), dim=-1)
    num = torch.linalg.vector_norm(diff, dim=-1)
    assert bool((num[den == 0] == 0).all()), "an empty slab is not 0"
    live = den > 0
    return (num[live] / den[live]).max().item() if bool(live.any()) else 0.0


def tgmm_library(x, dy, sizes, ref):
    """(fn, name): one PyTorch call computing the per-expert x^T dy, timed
    as a yardstick only: ``torch._grouped_mm`` in its 2-D x 2-D form with
    offsets over the contracted row dim where this torch takes it (checked
    against ``ref``), else a cuBLAS matmul per expert."""
    gmm_op = getattr(torch, "_grouped_mm", None)
    why = "torch has no _grouped_mm"
    if gmm_op is not None:
        xt = x.t()                          # (K, M), a column-major view
        offs = torch.tensor(np.cumsum(sizes), dtype=torch.int32,
                            device="cuda")
        try:
            got = gmm_op(xt, dy, offs=offs)
            torch.cuda.synchronize()
            rel = slab_rel_norm(got, ref)
            if rel <= BF16_REL_NORM:
                return (lambda: gmm_op(xt, dy, offs=offs)), \
                    "torch._grouped_mm (2-D x 2-D, offsets over rows)"
            why = f"torch._grouped_mm 2-D x 2-D disagrees ({rel:.3g})"
        except RuntimeError as e:      # this build refuses the 2-D form
            why = f"torch._grouped_mm 2-D x 2-D refused: {str(e)[:120]}"
    ends = np.cumsum(sizes)
    out = torch.empty(len(sizes), x.shape[1], dy.shape[1], dtype=x.dtype,
                      device="cuda")

    def loop():
        for e, hi in enumerate(ends):
            torch.mm(x[hi - sizes[e]:hi].t(), dy[hi - sizes[e]:hi],
                     out=out[e])
        return out
    return loop, f"cuBLAS torch.mm per expert ({why})"


def tgmm_mma_sync(gm, x, dy, gs):
    """A call of grouped_tgmm's mma_sync kernel (the design the sm90 one
    replaces at these shapes) on the same bf16 operands, timed beside it
    only."""
    M, K = x.shape
    N, E = dy.shape[1], gs.shape[0]
    out = torch.empty(E, K, N, dtype=x.dtype, device="cuda")
    args = gm._TgmmArgs(x.data_ptr(), dy.data_ptr(), gs.data_ptr(),
                        out.data_ptr(), M, K, N, E, 1, 1)
    lib = gm.kernel_builder().load()
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.grouped_tgmm_launch(ctypes.byref(args), 1, stream)
        assert rc == 0, f"grouped_tgmm mma_sync launch: cudaError {rc}"
        return out
    return call


def gmm_call(gm, x, w, gs, design):
    """A call of grouped_gmm's ``design`` kernel ("sm90" or "mma_sync") on
    bf16 x (M, K) and w (E, K, N) through its strides, past the design
    rule; timed beside the wrapper only."""
    M, K = x.shape
    E, _, N = w.shape
    out = torch.empty(M, N, dtype=x.dtype, device="cuda")
    se, sk, sn = w.stride()
    args = gm._GroupedArgs(x.data_ptr(), w.data_ptr(), w.data_ptr(),
                           gs.data_ptr(), out.data_ptr(), se, sk, sn, M, K,
                           N, E, 1, 1, int(sk == 1 and sn != 1))
    lib = gm.kernel_builder().load()
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        if design == "sm90":
            rc = lib.grouped_gmm_sm90_launch(ctypes.byref(args), stream)
        else:
            rc = lib.grouped_gmm_launch(ctypes.byref(args), 1,
                                        gm.block_m_for(M), stream)
        assert rc == 0, f"grouped_gmm {design} launch: cudaError {rc}"
        return out
    return call


def gmm_training_checks(gm, x, w, cases, tag):
    """grouped_gmm at a GPT2MoE training shape for each (sizes, gs) of
    ``cases`` (the routed sizes; an empty expert, group boundaries off the
    128-row tile and a tail): every call on sm90 and repeated bitwise, the
    rows inside the groups within the bf16 limits of the plain version in
    fp32, the rows past them exactly 0. Control (the last case): expert 0's
    rows read one 128-row tile late must fail the check. Returns (max
    |err|, the control's failure)."""
    worst = 0.0
    for sizes, gs in cases:
        gm.reset_launch_counts()
        out = gm.grouped_matmul(x, w, gs)
        again = gm.grouped_matmul(x, w, gs)
        torch.cuda.synchronize()
        assert gm.DESIGN_LAUNCHES["grouped_gmm"] == {
            "sm90": 2, "mma_sync": 0, "fp32": 0}, (tag, gm.DESIGN_LAUNCHES)
        assert torch.equal(out, again), f"gmm {tag} {sizes}: calls differ"
        live = min(sum(sizes), x.shape[0])
        assert bool((out[live:] == 0).all()), f"gmm {tag}: tail not 0"
        del again
        ref = gm.grouped_matmul_reference(x.float(), w.float(), gs)
        why = bf16_mismatch(out[:live], ref[:live])
        assert why is None, f"gmm {tag} {sizes}: {why}"
        worst = max(worst, bf16_errors(out[:live], ref[:live])[1])
        del out
    e = next(i for i, n in enumerate(sizes) if n)
    lo = sum(sizes[:e])
    hi = lo + sizes[e]
    ctrl = ref.clone()
    ctrl[lo:hi] = x[lo + 128:hi + 128].float() @ w[e].float()
    why = bf16_mismatch(ctrl[:live].to(torch.bfloat16), ref[:live])
    assert why is not None, f"gmm {tag}: check let a shifted segment pass"
    del ctrl, ref
    return worst, why


def tgmm_bound(M, K, N, E, sizes):
    """x and dy read once, dw written once; operations on the rows inside
    the groups only."""
    live = min(sum(sizes), M)
    return bound((M * K + M * N + E * K * N) * 2 + E * 4,
                 2 * live * K * N)


def phase_moe_backward_kernels(gm, seed=0, tokens=24576, E=4, k=2):
    """K8's backward at the GPT2MoE 350M training shapes (24 x 1024 tokens,
    top-2 of 4 experts: 49152 routed rows): grouped_tgmm at (K, N) =
    (1024, 4096) and (4096, 1024), bf16 against its plain version in fp32
    (every expert slab's relative error norm within BF16_REL_NORM), fp32 at
    1e-4, an empty expert exactly 0, a control (one expert's rows shifted
    by a 64-row tile) that must fail; the dx product through a transposed
    view of w; each timed beside its bound, plain version and one library
    call. Then the grouped_swiglu backward at Mixtral-8x7B expert widths
    (512 rows) against its plain version. Returns the tgmm row and the two
    dx-view timings."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    bf, f32 = torch.bfloat16, torch.float32

    def randn(shape, dtype=bf, s=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * s).to(dtype)

    rs = np.random.RandomState(seed)
    sizes = routed_sizes(rs, tokens, E, k)
    M = tokens * k
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    tail_sizes = [15000, 0, 20000, 10000]     # empty expert, 4152-row tail
    tail_gs = torch.tensor(tail_sizes, dtype=torch.int32, device="cuda")
    rows, worst, err = {}, 0.0, 0.0
    for K, N in ((1024, 4096), (4096, 1024)):
        x, dy = randn((M, K)), randn((M, N))
        refs = []
        for sz, gsz in ((sizes, gs), (tail_sizes, tail_gs)):
            gm.reset_launch_counts()
            out = gm.grouped_tgmm(x, dy, gsz)
            again = gm.grouped_tgmm(x, dy, gsz)
            ref = gm.grouped_tgmm_reference(x.float(), dy.float(), gsz)
            refs.append(ref)
            torch.cuda.synchronize()
            assert gm.DESIGN_LAUNCHES["grouped_tgmm"]["sm90"] == 2, \
                gm.DESIGN_LAUNCHES
            assert torch.equal(out, again), f"tgmm {K}x{N}: calls differ"
            assert torch.isfinite(out).all(), f"tgmm {K}x{N}: non-finite"
            rel = slab_rel_norm(out, ref)
            assert rel <= BF16_REL_NORM, f"tgmm {K}x{N} {sz}: slab {rel:.3g}"
            worst = max(worst, rel)
            err = max(err, (out.float() - ref).abs().max().item())
            for e, n in enumerate(sz):
                if n == 0:
                    assert (out[e] == 0).all(), f"tgmm: empty expert {e}"
            del again
        # control: expert 0's rows taken one 64-row tile late
        ctrl = ref.clone()
        late = slice(64, sizes[0] + 64)
        ctrl[0] = x[late].float().t() @ dy[late].float()
        crel = slab_rel_norm(ctrl.to(bf), ref)
        assert crel > BF16_REL_NORM, "tgmm check let a shifted group pass"
        # control (routed sizes): expert 1's slab summed over rows running
        # one 64-row slice past its end into expert 2 (its x rows left
        # unmasked)
        ctrl = refs[0].clone()
        over = slice(sizes[0], sizes[0] + sizes[1] + 64)
        ctrl[1] = x[over].float().t() @ dy[over].float()
        orel = slab_rel_norm(ctrl.to(bf), refs[0])
        assert orel > BF16_REL_NORM, "tgmm check let rows past a group pass"
        del refs
        # fp32 (scaled so the 12k-row sums stay O(1)) at FP32_TOL
        x32, dy32 = x.float() * 0.1, dy.float() * 0.1
        for gsz in (gs, tail_gs):
            torch.testing.assert_close(
                gm.grouped_tgmm(x32, dy32, gsz),
                gm.grouped_tgmm_reference(x32, dy32, gsz), **FP32_TOL)
        del x32, dy32, ctrl
        ref = gm.grouped_tgmm_reference(x.float(), dy.float(), gs)
        lib, lib_name = tgmm_library(x, dy, sizes, ref)
        del ref
        # grouped_gmm: the forward x (M, K) times w (E, K, N), and the dx
        # product dy (M, N) times w^T, a transposed (E, N, K) view
        w = randn((E, K, N), s=0.02)
        wt = w.transpose(1, 2)
        gmm_cases = [(sizes, gs), (tail_sizes, tail_gs)]
        fwd_err, fwd_ctrl = gmm_training_checks(gm, x, w, gmm_cases,
                                                f"forward {K}x{N}")
        dx_err, dx_ctrl = gmm_training_checks(gm, dy, wt, gmm_cases,
                                              f"dx view {K}x{N}")
        fwd_lib, fwd_lib_name = grouped_library(x, w, sizes)
        dx_lib, dx_lib_name = grouped_library(dy, wt, sizes)
        tag = f"{M} rows, (K, N) = ({K}, {N})"
        r = dict(
            ms=time_ms(lambda: gm.grouped_tgmm(x, dy, gs), 10),
            plain_ms=time_ms(lambda: gm.grouped_tgmm_reference(x, dy, gs), 3),
            library_ms=time_ms(lib, 10), bound=tgmm_bound(M, K, N, E, sizes),
            mma_sync_ms=time_ms(tgmm_mma_sync(gm, x, dy, gs), 10),
            shape=tag, library=lib_name)
        fwd = dict(
            ms=time_ms(lambda: gm.grouped_matmul(x, w, gs), 10),
            mma_sync_ms=time_ms(gmm_call(gm, x, w, gs, "mma_sync"), 10),
            plain_ms=time_ms(lambda: gm.grouped_matmul_reference(
                x, w, gs), 3),
            library_ms=time_ms(fwd_lib, 10),
            bound_ms=grouped_bound(M, K, N, sizes, 1)[0],
            max_abs_err=fwd_err, design="sm90", shape=tag,
            library=fwd_lib_name)
        dxv = dict(
            ms=time_ms(lambda: gm.grouped_matmul(dy, wt, gs), 10),
            mma_sync_ms=time_ms(gmm_call(gm, dy, wt, gs, "mma_sync"), 10),
            contiguous_ms=time_ms(lambda: gm.grouped_matmul(
                dy, wt.contiguous(), gs), 10),
            plain_ms=time_ms(lambda: gm.grouped_matmul_reference(
                dy, wt, gs), 3),
            library_ms=time_ms(dx_lib, 10),
            bound_ms=grouped_bound(M, N, K, sizes, 1)[0],
            max_abs_err=dx_err, design="sm90", shape=tag,
            library=dx_lib_name)
        log(f"MoE backward {tag}, sizes {sizes}: tgmm {r['ms']:.4f} ms "
            f"(sm90; the mma_sync design {r['mma_sync_ms']:.4f}, plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f} "
            f"[{lib_name}], bound {r['bound'][0]:.4f} by {r['bound'][1]}); "
            f"forward gmm {fwd['ms']:.4f} ms (sm90; the mma_sync design "
            f"{fwd['mma_sync_ms']:.4f}, plain {fwd['plain_ms']:.4f}, library "
            f"{fwd['library_ms']:.4f} [{fwd_lib_name}], bound "
            f"{fwd['bound_ms']:.4f}); dx view gmm {dxv['ms']:.4f} ms (sm90; "
            f"the mma_sync design {dxv['mma_sync_ms']:.4f}, same product on "
            f"a contiguous copy {dxv['contiguous_ms']:.4f}, plain "
            f"{dxv['plain_ms']:.4f}, library {dxv['library_ms']:.4f} "
            f"[{dx_lib_name}], bound {dxv['bound_ms']:.4f}); controls: tgmm "
            f"expert 0 a tile late fails (slab relative error norm "
            f"{crel:.3g}), expert 1 over 64 rows of expert 2 fails "
            f"({orel:.3g}); gmm expert 0's rows read one 128-row tile late "
            f"fails (forward: {fwd_ctrl}; dx view: {dx_ctrl})")
        rows[(K, N)] = (r, fwd, dxv)
        del x, dy, w, wt
        torch.cuda.empty_cache()
    log(f"grouped_tgmm checks ok (sm90 design, calls repeat bitwise): worst "
        f"bf16 slab relative error norm {worst:.3g}, fp32 at 1e-4, empty "
        f"expert 0")

    # the grouped_swiglu backward at Mixtral-8x7B expert widths
    D, Fd, Em = 4096, 14336, 8
    msz = routed_sizes(rs, 256, Em, 2)
    mgs = torch.tensor(msz, dtype=torch.int32, device="cuda")
    x = randn((512, D))
    w1, w3 = (randn((Em, D, Fd), s=0.02) for _ in range(2))
    w2 = randn((Em, Fd, D), s=0.02)
    dy = randn((512, D))
    ps = [t.detach().requires_grad_() for t in (x, w1, w3, w2)]
    gm.reset_launch_counts()
    got = torch.autograd.grad(gm.grouped_swiglu(*ps, mgs), ps, dy)
    # the chain's forward up product through _swiglu_up_design: sm90
    assert gm.DESIGN_LAUNCHES["grouped_swiglu_up"] == {
        "sm90": 1, "mma_sync": 0, "fp32": 0}, gm.DESIGN_LAUNCHES
    ref = gm.grouped_swiglu_backward_reference(
        *(t.float() for t in (x, w1, w3, w2)), mgs, dy.float())
    for name, a, b in zip(("dx", "dw1", "dw3", "dw2"), got, ref):
        assert torch.isfinite(a).all(), f"swiglu backward {name}"
        rel = (grad_rel_norm(a[None], b[None]) if name == "dx"
               else slab_rel_norm(a, b))
        assert rel <= BF16_GRAD_REL_NORM, f"swiglu backward {name}: {rel:.3g}"
    log(f"grouped_swiglu backward ok at D={D}, F={Fd}, E={Em}, 512 rows "
        f"(sizes {msz}; the forward's up product on sm90): dx and every "
        f"expert slab within {BF16_GRAD_REL_NORM} of the plain backward in "
        f"fp32")
    del x, w1, w3, w2, dy, ps, got, ref
    gc.collect()
    torch.cuda.empty_cache()
    main_r = rows[(1024, 4096)][0]
    main_r["max_abs_err"] = err
    main_r["other"] = {k: rows[(4096, 1024)][0][k] for k in
                       ("ms", "plain_ms", "library_ms", "shape",
                        "mma_sync_ms")}
    main_r["other"]["bound_ms"] = rows[(4096, 1024)][0]["bound"][0]
    # (the tgmm row, the dx view rows, the forward rows)
    return (main_r, [rows[s][2] for s in ((1024, 4096), (4096, 1024))],
            [rows[s][1] for s in ((1024, 4096), (4096, 1024))])


# ------------------------------------------------------ MoE training parity


def moe_cfg(base, **over):
    from deepspeed_tpu_torch import GPT2MoEConfig
    return GPT2MoEConfig(**{**dataclasses.asdict(base), **over})


def phase_moe_train_parity(seed=0):
    """Small fp32 GPT2MoE (2 layers, E=4, top-2, save_flash, fused CE
    kernel): the grouped kernels on and off give the same loss, aux and
    every gradient (relative error norm 1e-4); the grouped kernels launch
    only when on, 6 gmm and 4 tgmm per layer."""
    from deepspeed_tpu_torch import GPT2Config, GPT2MoE
    from deepspeed_tpu_torch.ops.cuda import grouped_matmul as gm
    base = GPT2Config(n_layer=2, n_head=2, d_model=128, max_seq_len=256,
                      vocab_size=1000, dtype="float32", loss_chunk=100,
                      fused_loss=True, fused_loss_kernel=True,
                      use_flash_attention=True, remat=True,
                      remat_policy="save_flash")
    ids = torch.from_numpy(np.random.RandomState(seed).randint(
        0, 1000, (4, 256))).cuda()
    out = {}
    for on in (True, False):
        cfg = moe_cfg(base, num_experts=4, moe_top_k=2, moe_backend="ragged",
                      moe_grouped_kernel=on)
        model = GPT2MoE(cfg, device="cuda", seed=seed)
        gm.reset_launch_counts()
        loss = model.loss({"input_ids": ids})
        loss.backward()
        torch.cuda.synchronize()
        launched = dict(gm.LAUNCHES)
        n = cfg.n_layer if on else 0
        want = {"grouped_swiglu_up": 0, "grouped_gmm": 6 * n,
                "grouped_tgmm": 4 * n, **NO_WQ}
        assert launched == want, (on, launched, want)
        with torch.no_grad():
            aux = model.hidden_with_aux(ids)[1].item()
        out[on] = (loss.item(), aux, {n: p.grad for n, p in
                                      model.named_parameters()})
    (l_on, a_on, g_on), (l_off, a_off, g_off) = out[True], out[False]
    assert abs(l_on - l_off) <= 1e-5 * abs(l_off), (l_on, l_off)
    assert abs(a_on - a_off) <= 1e-5 * abs(a_off), (a_on, a_off)
    worst = 0.0
    for n, g in g_off.items():
        rel = (torch.linalg.vector_norm(g_on[n] - g)
               / torch.linalg.vector_norm(g)).item()
        assert rel <= 1e-4, (n, rel)
        worst = max(worst, rel)
    log(f"MoE training parity ok: grouped kernels on vs off, loss "
        f"{l_on:.7f} vs {l_off:.7f}, aux {a_on:.7f} vs {a_off:.7f}, worst "
        f"gradient relative error norm {worst:.3g}")


# ------------------------------------------------------- MoE training slice


def active_flops_per_token(cfg):
    """Training flops per token counting the k routed experts only:
    6 * (non-embedding params - L (E - k) expert params) + 12 L D T (the
    ``flops_per_token`` formula with k of E experts active)."""
    expert = 2 * cfg.d_model * cfg.d_ff + cfg.d_ff + cfg.d_model
    active = (cfg.num_params() - cfg.vocab_size * cfg.d_model
              - cfg.n_layer * (cfg.num_experts - cfg.moe_top_k) * expert)
    return 6 * active + 12 * cfg.n_layer * cfg.d_model * cfg.max_seq_len


def phase_moe_train_slice(seed=0, steps=10, profile=None):
    """GPT2MoE over the 350M widths (E=4, top-2, ragged, the grouped kernels
    on) through initialize -> train_batch with the bench config
    (benchmarks/bench_engine.py:46-92, :182-206), 10 steps on one fixed
    numpy-seeded batch."""
    from deepspeed_tpu_torch import GPT2_PRESETS, GPT2MoE, initialize
    from deepspeed_tpu_torch.moe import sharded_moe as sm
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import fused_ce as fce
    from deepspeed_tpu_torch.ops.cuda import grouped_matmul as gm
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    assert left < 1e9, f"earlier phases left {left / 1e9:.2f} GB allocated"
    cfg = moe_cfg(
        GPT2_PRESETS["350M"], max_seq_len=1024, use_flash_attention=True,
        flash_block_q=1024, flash_block_k=1024, flash_block_h=1,
        remat=True, remat_policy="save_flash", loss_chunk=512,
        fused_loss=True, fused_loss_kernel=True, num_experts=4, moe_top_k=2,
        moe_backend="ragged")
    t0 = time.perf_counter()
    engine, _, _, _ = initialize(
        model=GPT2MoE(cfg, device="cuda", seed=seed),
        config={"train_micro_batch_size_per_gpu": 24,
                "gradient_accumulation_steps": 1, "steps_per_print": 0,
                "optimizer": {"type": "AdamW",
                              "params": {"lr": 2e-4, "weight_decay": 0.01}},
                "gradient_clipping": 1.0, "bf16": {"enabled": True},
                "zero_optimization": {"stage": 2}})
    torch.cuda.synchronize()
    bsz = engine.config.train_batch_size
    log(f"gpt2moe-350M (E=4, top-2) engine built in "
        f"{time.perf_counter() - t0:.1f} s: {cfg.num_params() / 1e6:.1f}M "
        f"params, batch {bsz} x 1024, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    batch = {"input_ids": np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (bsz, cfg.max_seq_len)).astype(np.int32)}

    # the group sizes of step 1's forward, one per layer (device tensors:
    # no sync inside the step)
    first_step = []
    sort = sm.sort_by_expert

    def recording_sort(experts, E):
        order, sizes = sort(experts, E)
        if len(first_step) < cfg.n_layer:
            first_step.append(sizes)
        return order, sizes

    torch.cuda.reset_peak_memory_stats()
    for mod in (fa, fce, gm):
        mod.reset_launch_counts()
    losses, times = [], []
    sm.sort_by_expert = recording_sort
    try:
        for _ in range(steps):
            t1 = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
    finally:
        sm.sort_by_expert = sort
    launches = {**fa.LAUNCHES, **fce.LAUNCHES, **gm.LAUNCHES}
    L = cfg.n_layer
    # per layer and step: 2 forward gmm, 2 re-run by save_flash's backward,
    # 2 dx gmm; 4 tgmm (wi, wo and their biases' per-expert row sums)
    want = {"flash_fwd": L * steps, "flash_bwd": L * steps,
            "flash_bwd_qmajor": 0, "flash_block_fwd": 0,
            "fused_ce": 2 * steps, "grouped_swiglu_up": 0,
            "grouped_gmm": 6 * L * steps, "grouped_tgmm": 4 * L * steps,
            **NO_WQ}
    assert launches == want, (launches, want)
    assert_sm90("moe train slice", fa, fce, main_path=True)
    # every grouped_gmm (forward, re-run, dx view: 49152 rows) on sm90; wi
    # and wo's tgmm on sm90, the two expert-bias row sums (x = ones (M, 1))
    # on mma_sync
    for name, want_by in (
            ("grouped_gmm", {"sm90": 6 * L * steps, "mma_sync": 0,
                             "fp32": 0}),
            ("grouped_tgmm", {"sm90": 2 * L * steps,
                              "mma_sync": 2 * L * steps, "fp32": 0})):
        by = dict(gm.DESIGN_LAUNCHES[name])
        assert by == want_by, (name, by, want_by)
        count_designs(name, by)
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    load = [s.tolist() for s in first_step]
    assert len(load) == L and all(sum(s) == bsz * 1024 * 2 for s in load)
    step_s = float(np.median(times[1:]))
    tokens = bsz * cfg.max_seq_len
    stats = dict(
        steps=steps, losses=losses, step_s=times,
        step_s_median_after_first=step_s, tokens_per_s=tokens / step_s,
        active_flops_per_token=active_flops_per_token(cfg),
        model_tflops_per_s_active=active_flops_per_token(cfg) * tokens
        / step_s / 1e12,
        model_tflops_per_s_config_formula=cfg.flops_per_token() * tokens
        / step_s / 1e12,
        launches=launches,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        first_step_expert_load_min_max=[[min(s), max(s)] for s in load])
    log("moe train slice " + json.dumps(stats))
    if profile:
        acts = [torch.profiler.ProfilerActivity.CUDA]
        t1 = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                engine.train_batch(batch)
            torch.cuda.synchronize()
        write_profile(prof, profile, time.perf_counter() - t1)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------ quantized kernels (K7, K9)


def wq_bound(M, K, N, bits, touched=1, n_w=1, live=None):
    """Bound of one quantized product: x (bf16) read once, each touched
    weight's codes (1 byte, or half a byte at int4) and fp32 scales read
    once, the output written once; operations on the live rows only."""
    live = M if live is None else live
    code = K * N * (1.0 if bits == 8 else 0.5) + N * 4
    return bound(M * K * 2 + n_w * touched * code + M * N * 2,
                 2 * n_w * live * K * N)


def int8pack_library(x, w):
    """(fn, name) of ``torch._weight_int8pack_mm`` (x @ (codes * scale) with
    int8 codes (N, K) and bf16 scales) when this torch runs it on the card
    and it computes the kernel's function here, else None."""
    op = getattr(torch, "_weight_int8pack_mm", None)
    if op is None or w.bits != 8:
        return None
    codes = w.q.t().contiguous()
    scales = w.scale.reshape(-1).to(x.dtype)
    try:
        out = op(x, codes, scales)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        log(f"  torch._weight_int8pack_mm unavailable: {str(e)[:120]}")
        return None
    ref = (x.float() @ w.q.float()) * w.scale.reshape(1, -1)
    why = bf16_mismatch(out, ref)
    if why is not None:
        log(f"  torch._weight_int8pack_mm disagrees ({why}): not used")
        return None
    return (lambda: op(x, codes, scales)), "torch._weight_int8pack_mm"


class WqCases:
    """K7 and K9 on the card, each call held against its plain version:
    bf16 against the plain version run in fp32 on the same inputs
    (bf16_mismatch), fp32 at FP32_TOL, the rows past the groups exactly 0;
    a control per kernel that must fail the check."""

    def __init__(self, seed=0):
        self.g = torch.Generator(device="cuda")
        self.g.manual_seed(seed)
        self.err = {n: 0.0 for n in ("wq_matmul", "grouped_swiglu_up_wq",
                                     "grouped_gmm_wq")}
        self.rel = dict(self.err)

    def randn(self, shape, dtype=torch.bfloat16, s=1.0):
        return (torch.randn(shape, generator=self.g, device="cuda")
                * s).to(dtype)

    def quantized(self, shape, bits, s=0.02):
        """Codes of a seeded bf16 weight, drawn and quantized one (In, Out)
        slice at a time."""
        from deepspeed_tpu_torch.ops.int8_weights import quantize_slices
        n = math.prod(shape[:-2])
        return quantize_slices(shape, (self.randn(shape[-2:], s=s)
                                       for _ in range(n)), bits, "cuda")

    def hold(self, name, got, ref, what):
        if got.dtype == torch.float32:
            torch.testing.assert_close(got, ref, **FP32_TOL)
            return
        why = bf16_mismatch(got, ref)
        assert why is None, f"{name} ({what}): {why}"
        _, e, r = bf16_errors(got, ref)
        self.err[name] = max(self.err[name], e)
        self.rel[name] = max(self.rel[name], r)


def wq_controls(mm, gm, dense, grouped):
    """Each check must fail on a known-wrong answer: K7 with its scale
    vector shifted by one channel, or with one 64-deep k slice of its
    codes skipped; K9 (``grouped``: [(label, case)], the decode and the
    chunk shapes whose kernels ran on sm90) with one group's rows on its
    neighbour expert's scales, or on its own expert's codes with one
    64-deep k slice skipped; int4 with the two nibbles of every byte
    swapped."""
    out = []
    x, w, ref = dense["x"], dense["w"], dense["ref"]
    rows = 64 if w.bits == 8 else 32       # code rows of one k slice
    skipped = w.q.clone()
    skipped[rows:2 * rows] = 0
    wrongs = [("wq_matmul scale shifted one channel",
               type(w)(w.q, torch.roll(w.scale, 1, dims=-1))),
              ("wq_matmul k slice 1 of the codes skipped",
               type(w)(skipped, w.scale))]
    if w.bits == 4:
        b = w.q.to(torch.int16) & 0xFF
        swapped = ((b & 0xF) << 4 | (b >> 4)).to(torch.uint8)
        wrongs.append(("wq_matmul int4 nibbles swapped",
                       type(w)(swapped.view(torch.int8), w.scale)))
    for label, bad in wrongs:
        ctrl = mm.wq_matmul_reference(x.float(), bad)
        why = bf16_mismatch(ctrl.to(torch.bfloat16), ref)
        assert why is not None, f"{label}: check let it pass"
        out.append(f"{label}: {why}")
    for shape, c in grouped:
        sizes, E = c["sizes"], len(c["sizes"])
        e = next(i for i, n in enumerate(sizes) if n)
        lo = sum(sizes[:e])
        hi = lo + sizes[e]
        nb = (e + 1) % E
        for name, w, xin in (("grouped_swiglu_up_wq", c["w1"], c["x"]),
                             ("grouped_gmm_wq", c["w2"], c["h"])):
            scale = w.scale.clone()
            scale[e] = scale[nb]
            rows = 64 if w.bits == 8 else 32   # code rows of one k slice
            skipped = w.q.clone()
            skipped[e, rows:2 * rows] = 0
            ref = c["refs"][name]
            for label, bad in (
                    (f"group {e} on expert {nb}'s scales",
                     type(w)(w.q, scale)),
                    (f"group {e} with k slice 1 of its codes skipped",
                     type(w)(skipped, w.scale))):
                if name == "grouped_gmm_wq":
                    ctrl = gm.grouped_matmul_wq_reference(xin.float(), bad,
                                                          c["gs"])
                else:
                    ctrl = gm.grouped_swiglu_up_wq_reference(
                        xin.float(), bad, c["w3"], c["gs"])
                wrong = ref.clone()
                wrong[lo:hi] = ctrl[lo:hi]
                why = bf16_mismatch(wrong.to(torch.bfloat16), ref)
                assert why is not None, f"{name} {shape}: {label} passed"
                out.append(f"{name} {shape} {label}: {why}")
            del skipped
    return out


def phase_wq_kernels(mm, gm, seed=0):
    """K7 at the Llama-2-7B FFN shapes (8 decode rows and a 256-token
    chunk; D=4096 -> F=11008 and back) and K9 at the Mixtral-8x7B expert
    shapes (phase 8's routed sizes and edge cases), int8 and int4:
    checked, controlled and timed. The main-path widths: K7 int4 (the
    Llama slice), K9 int8 (the Mixtral slice)."""
    rs = np.random.RandomState(seed)
    cases = WqCases(seed)
    bf, f32 = torch.bfloat16, torch.float32
    D, Fl = 4096, 11008
    timings = {}

    # ---- K7: the design _wq_design picks (sm90 for bf16), checked against
    # the plain version and its split-order version, repeated bitwise, and
    # timed beside wq_kernel (mma_sync), the library calls and the sm90
    # kernel at the plan's other K split
    dense = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for bits in (4, 8):
        for K, N, tag in ((D, Fl, "up"), (Fl, D, "down")):
            w = cases.quantized((K, N), bits)
            for M, shape in ((8, "decode"), (256, "chunk"), (1, "1 row"),
                             (200, "200 rows"), (300, "300 rows")):
                x = cases.randn((1, M, K))
                x2 = x[0]
                mm.reset_launch_counts()
                out = mm.wq_matmul(x, w)
                again = mm.wq_matmul(x, w)
                design = mm._wq_design(x2, w)
                rt, S = mm.wq_plan(M, K, N, sms)
                ref = mm.wq_matmul_reference(x.float(), w)
                torch.cuda.synchronize()
                assert mm.DESIGN_LAUNCHES["wq_matmul"][design] == 2, \
                    (M, K, N, design, mm.DESIGN_LAUNCHES)
                assert torch.equal(out, again), \
                    f"wq_matmul int{bits} {shape} {tag}: repeat differs"
                what = f"int{bits} {shape} {tag} ({design}, row tile {rt}, " \
                       f"{S} splits)"
                cases.hold("wq_matmul", out, ref, what)
                if design == "sm90":
                    cases.hold("wq_matmul", out[0],
                               mm.wq_matmul_split_reference(x2.float(), w, S),
                               what + " vs its split-order plain version")
                if shape not in ("decode", "chunk"):
                    continue
                wdq = w.dequant(bf)
                lib = (lambda x2=x2, wdq=wdq: torch.matmul(x2, wdq))
                lib_name = "bf16 torch.matmul on the dequantized weight"
                packed = int8pack_library(x2, w)
                # device times with the launches queued (a call is about
                # as short as its Python launch path, so CUDA events
                # around eager wq_matmul calls time the host: eager_ms),
                # each design, the sm90 kernel at the other K split and
                # the library call; each design's host launch path (the
                # same entry, _wq_cuda, for both) beside them
                ms, host_ms = time_queued(lambda: mm._wq_cuda(x2, w), 30)
                mma_ms, mma_host_ms = time_queued(
                    lambda: mm._wq_cuda(x2, w, "mma_sync"), 30)
                t = dict(
                    ms=ms, host_ms=host_ms, mma_sync_ms=mma_ms,
                    mma_sync_host_ms=mma_host_ms,
                    eager_ms=time_ms(lambda: mm.wq_matmul(x, w), 30),
                    plain_ms=time_ms(lambda: mm.wq_matmul_reference(x, w),
                                     3),
                    bf16_matmul_ms=time_queued(lib, 30)[0],
                    bound=wq_bound(M, K, N, bits), design=design,
                    row_tile=rt, splits=S)
                if design == "sm90":
                    # the plan's other choice: unsplit where it splits K,
                    # else three splits (a second wave at 86 tiles)
                    t["alt_splits"] = 1 if S > 1 else 3
                    t["alt_splits_ms"] = time_queued(
                        lambda: mm._launch_wq_sm90(x2, w, t["alt_splits"]),
                        30)[0]
                t["library_ms"] = t["bf16_matmul_ms"]
                t["library"] = lib_name
                if packed is not None:
                    t["int8pack_ms"] = time_queued(packed[0], 30)[0]
                timings[("wq_matmul", bits, shape, tag)] = t
                if bits == 4 and shape == "decode" and tag == "up":
                    dense = dict(x=x, w=w, ref=ref)
                del wdq
            del w
        xs = cases.randn((2, 40, 512), f32)
        ws = cases.quantized((512, 384), bits)
        cases.hold("wq_matmul", mm.wq_matmul(xs, ws),
                   mm.wq_matmul_reference(xs, ws), f"int{bits} fp32")

    # ---- K9: every case on the design _wq_grouped_design picks (sm90 for
    # bf16), repeated bitwise, against the plain version; the decode and
    # chunk shapes timed on both designs (launches queued) beside the
    # library calls and the bound
    E, Fm = 8, 14336
    dec_sizes = routed_sizes(rs, 8, E, 2)
    chk_sizes = routed_sizes(rs, 256, E, 2)
    grouped = []
    for bits in (8, 4):
        w1, w3 = (cases.quantized((E, D, Fm), bits) for _ in range(2))
        w2 = cases.quantized((E, Fm, D), bits)
        for M, sizes, what in (
                (16, dec_sizes, "decode"), (512, chk_sizes, "chunk"),
                (512, [100, 0, 50, 30, 120, 80, 0, 132], "empty groups"),
                (512, [0, 0, 0, 512, 0, 0, 0, 0], "one expert"),
                (512, [40, 60, 0, 20, 100, 0, 80, 50], "162-row tail")):
            x = cases.randn((M, D))
            gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
            gm.reset_launch_counts()
            h = gm.grouped_swiglu_up_wq(x, w1, w3, gs)
            out = gm.grouped_matmul_wq(h, w2, gs)
            again = (gm.grouped_swiglu_up_wq(x, w1, w3, gs),
                     gm.grouped_matmul_wq(h, w2, gs))
            torch.cuda.synchronize()
            design = gm._wq_grouped_design(x, w1)
            for name in ("grouped_swiglu_up_wq", "grouped_gmm_wq"):
                by = gm.DESIGN_LAUNCHES[name]
                assert by[design] == 2 == sum(by.values()), (name, by)
            assert torch.equal(h, again[0]) and torch.equal(out, again[1]), \
                f"K9 int{bits} {what}: repeat differs"
            live = min(sum(sizes), M)
            assert (h[live:] == 0).all() and (out[live:] == 0).all(), \
                f"K9 rows past the groups not zero (sizes {sizes})"
            refs = {"grouped_swiglu_up_wq": gm.grouped_swiglu_up_wq_reference(
                        x.float(), w1, w3, gs),
                    "grouped_gmm_wq": gm.grouped_matmul_wq_reference(
                        h.float(), w2, gs)}
            for name, got in (("grouped_swiglu_up_wq", h),
                              ("grouped_gmm_wq", out)):
                cases.hold(name, got[:live], refs[name][:live],
                           f"int{bits} {what} ({design}), sizes {sizes}")
            if what not in ("decode", "chunk"):
                continue
            if bits == 8:
                grouped.append((what, dict(x=x, h=h, gs=gs, sizes=sizes,
                                           w1=w1, w3=w3, w2=w2, refs=refs)))
            touched = sum(1 for s in sizes if s)
            d1, d3, d2 = (w.dequant(bf) for w in (w1, w3, w2))
            up_lib, up_name = grouped_library(x, d1, sizes)
            up_lib3, _ = grouped_library(x, d3, sizes)
            dn_lib, dn_name = grouped_library(h, d2, sizes)
            for name, fn, xin, ws, lib, lib_name, dims in (
                    ("grouped_swiglu_up_wq", "grouped_swiglu_up_wq_launch",
                     x, (w1, w3), lambda: F.silu(up_lib()) * up_lib3(),
                     f"{up_name} x2 + silu*mul on the dequantized bf16 "
                     f"experts", (D, Fm, 2)),
                    ("grouped_gmm_wq", "grouped_gmm_wq_launch", h, (w2,),
                     dn_lib, f"{dn_name} on the dequantized bf16 experts",
                     (Fm, D, 1))):
                def call(design=None, fn=fn, name=name, xin=xin, ws=ws):
                    return gm._launch_wq_grouped(fn, name, xin, ws, gs,
                                                 design)
                ms, host_ms = time_queued(call, 30)
                mma_ms, mma_host_ms = time_queued(
                    lambda call=call: call("mma_sync"), 30)
                plain = (gm.grouped_swiglu_up_wq_reference
                         if name == "grouped_swiglu_up_wq"
                         else gm.grouped_matmul_wq_reference)
                timings[(name, bits, what, "")] = dict(
                    ms=ms, host_ms=host_ms, mma_sync_ms=mma_ms,
                    mma_sync_host_ms=mma_host_ms, design=design,
                    row_tile=gm.wq_grouped_plan(M, E),
                    plain_ms=time_ms(lambda plain=plain, xin=xin, ws=ws:
                                     plain(xin, *ws, gs), 3),
                    library_ms=time_ms(lib, 30), library=lib_name,
                    bound=wq_bound(M, dims[0], dims[1], bits, touched,
                                   dims[2], live))
            del d1, d3, d2
        for M, sizes in ((16, dec_sizes), (100, [30, 0, 20, 10, 5, 0, 15,
                                                 10])):
            xs = cases.randn((M, D), f32)
            gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
            hs = gm.grouped_swiglu_up_wq(xs, w1, w3, gs)
            cases.hold("grouped_swiglu_up_wq", hs,
                       gm.grouped_swiglu_up_wq_reference(xs, w1, w3, gs),
                       f"int{bits} fp32")
            cases.hold("grouped_gmm_wq", gm.grouped_matmul_wq(hs, w2, gs),
                       gm.grouped_matmul_wq_reference(hs, w2, gs),
                       f"int{bits} fp32")
        if bits == 4:
            del w1, w3, w2
    log(f"wq kernel cases ok: K9 decode sizes {dec_sizes}, chunk sizes "
        f"{chk_sizes}; max bf16 |err| " + ", ".join(
            f"{n} {cases.err[n]:.3g} (worst row relative error norm "
            f"{cases.rel[n]:.3g})" for n in cases.err)
        + "; fp32 cases at 1e-4; tails 0")
    for line in wq_controls(mm, gm, dense, grouped):
        log(f"control fails as it must: {line}")
    del dense, grouped
    gc.collect()
    torch.cuda.empty_cache()

    for key, t in timings.items():
        log(f"  {key[0]} int{key[1]} {key[2]} {key[3]}: {t['ms']:.4f} ms "
            f"(plain {t['plain_ms']:.4f}, library {t['library_ms']:.4f}, "
            f"bound {t['bound'][0]:.4f} by {t['bound'][1]})"
            + (f", torch._weight_int8pack_mm {t['int8pack_ms']:.4f}"
               if "int8pack_ms" in t else "")
            + (f"; launches queued; design {t['design']} (row tile "
               f"{t['row_tile']}, {t['splits']} splits), wq_kernel "
               f"(mma_sync) {t['mma_sync_ms']:.4f}; eager calls "
               f"{t['eager_ms']:.4f}; host launch path {t['host_ms']:.4f} "
               f"(mma_sync {t['mma_sync_host_ms']:.4f})"
               if "splits" in t else "")
            + (f"; launches queued; design {t['design']} (row tile "
               f"{t['row_tile']}), wq_kernel (mma_sync) "
               f"{t['mma_sync_ms']:.4f}; host launch path {t['host_ms']:.4f} "
               f"(mma_sync {t['mma_sync_host_ms']:.4f})"
               if "design" in t and "splits" not in t else "")
            + (f", sm90 at {t['alt_splits']} splits "
               f"{t['alt_splits_ms']:.4f}" if "alt_splits" in t else ""))
    for bits in (4, 8):
        for shape in ("decode", "chunk"):
            for tag in ("up", "down"):
                t = timings[("wq_matmul", bits, shape, tag)]
                faster = "sm90" if t["ms"] < t["mma_sync_ms"] else \
                    "mma_sync"
                log(f"  K7 {shape} int{bits} {tag}: the faster design on "
                    f"the card is {faster}, the rule picks {t['design']}; "
                    f"{t['ms'] / t['library_ms']:.2f}x the library call, "
                    f"{t['ms'] / t['mma_sync_ms']:.2f}x wq_kernel")
    for name in ("grouped_swiglu_up_wq", "grouped_gmm_wq"):
        for bits in (8, 4):
            for shape in ("decode", "chunk"):
                t = timings[(name, bits, shape, "")]
                faster = "sm90" if t["ms"] < t["mma_sync_ms"] else \
                    "mma_sync"
                log(f"  K9 {name} {shape} int{bits}: the faster design on "
                    f"the card is {faster}, the rule picks {t['design']}; "
                    f"{t['ms'] / t['library_ms']:.2f}x the library call, "
                    f"{t['ms'] / t['mma_sync_ms']:.2f}x wq_kernel, "
                    f"{t['bound'][0] / t['ms']:.2f} of the bound")
    main = {"wq_matmul": (4, "decode", "up"),
            "grouped_swiglu_up_wq": (8, "decode", ""),
            "grouped_gmm_wq": (8, "decode", "")}
    rows = {}
    for name, (bits, shape, tag) in main.items():
        r = dict(timings[(name, bits, shape, tag)])
        r.pop("design", None)           # the row's design: the main path's
        r["max_abs_err"] = cases.err[name]
        r["shape"] = f"int{bits} {shape} {tag}".strip()
        r["other"] = {f"int{b} {s} {tg}".strip(): {
            k: (v[0] if k == "bound" else v) for k, v in t.items()
            if k != "library"}
            for (n, b, s, tg), t in timings.items()
            if n == name and (b, s, tg) != (bits, shape, tag)}
        rows[name] = r
    return rows


# --------------------------------------------------------------- wq parity


def dequantized_copy(model, cls, cfg):
    """A float model holding ``model``'s quantized weights dequantized."""
    from deepspeed_tpu_torch.ops.int8_weights import dequant_tree
    tree = dequant_tree(model.params_tree(), torch.float32)
    state = {k: v for k, v in tree.items() if k != "blocks"}
    state.update({f"blocks.{k}": v for k, v in tree["blocks"].items()})
    plain = cls(cfg, device="cuda", dtype=torch.float32)
    plain.load_state_dict(state)
    return plain


def phase_wq_parity():
    """Small fp32 Llama and Mixtral, int8 and int4: weight_quant serving
    (K7 / K9 on the FFN) gives the same greedy streams as the same model
    with its dequantized weights served unquantized, split-fuse on and
    off; the wq kernels launch exactly as the forwards imply."""
    from deepspeed_tpu_torch import (LLAMA_PRESETS, MIXTRAL_TINY,
                                     InferenceEngineV2, Llama, Mixtral)
    from deepspeed_tpu_torch.ops.cuda import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.cuda import mlp_matmul as mm
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 512, (n,)) for n in (5, 16, 37, 300)]
    for cls, base in ((Llama, LLAMA_PRESETS["tiny"]), (Mixtral, MIXTRAL_TINY)):
        cfg = dataclasses.replace(base, dtype="float32", max_seq_len=512,
                                  d_model=256)
        for mode in ("int8", "int4"):
            quant = cls(cfg, device="cuda", dtype=torch.float32, seed=7,
                        quantize=mode)
            plain = dequantized_copy(quant, cls, cfg)
            for splitfuse in (64, 0):
                streams = {}
                for tag, model, wq in (("wq", quant, mode),
                                       ("plain", plain, "auto")):
                    mm.reset_launch_counts()
                    gm.reset_launch_counts()
                    eng = InferenceEngineV2(model, dict(
                        dtype="float32", kv_block_size=16, max_batch_size=4,
                        prompt_bucket=64, splitfuse_tokens=splitfuse,
                        weight_quant=wq), device="cuda")
                    streams[tag] = eng.generate_all(prompts,
                                                    max_new_tokens=24)
                    n = cfg.n_layer * sum(eng.forward_counts.values())
                    n = n if tag == "wq" else 0
                    got = (mm.LAUNCHES["wq_matmul"],
                           gm.LAUNCHES["grouped_swiglu_up_wq"],
                           gm.LAUNCHES["grouped_gmm_wq"])
                    want = (3 * n, 0, 0) if cls is Llama else (0, n, n)
                    assert got == want, (cls.__name__, mode, tag, got, want)
                    del eng
                for a, b in zip(streams["wq"], streams["plain"]):
                    np.testing.assert_array_equal(a, b)
                log(f"wq parity ok ({cls.__name__} {mode}, splitfuse="
                    f"{splitfuse}): weight_quant == dequantized greedy "
                    f"streams, {sum(len(s) for s in streams['wq'])} tokens")
            del quant, plain
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- wq slices


def phase_wq_slice(kind, seed=0, profile=None):
    """Full-depth serving through the fused wq path with phase 4's
    settings and traffic: "llama" = Llama-2-7B in int4 (K7 on the FFN),
    "mixtral" = Mixtral-8x7B at all 32 layers in int8 (K9 on the experts);
    both built quantized slice by slice, so the bf16 model never exists.
    ``profile``: a path for a torch.profiler breakdown of the serving
    loop. Returns the launch counts of the wq kernels."""
    from deepspeed_tpu_torch import (LLAMA_PRESETS, MIXTRAL_8X7B,
                                     InferenceEngineV2, Llama, Mixtral)
    from deepspeed_tpu_torch.models import mixtral as mx
    from deepspeed_tpu_torch.ops.cuda import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.cuda import mlp_matmul as mm
    from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    assert left < 1e9, f"earlier phases left {left / 1e9:.2f} GB allocated"
    if kind == "llama":
        cls, cfg, mode = Llama, LLAMA_PRESETS["llama2-7b"], "int4"
    else:
        cls, cfg, mode = Mixtral, MIXTRAL_8X7B, "int8"
    L = cfg.n_layer
    t0 = time.perf_counter()
    model = cls(cfg, device="cuda", dtype=torch.bfloat16, seed=seed,
                quantize=mode)
    eng = InferenceEngineV2(model, dict(
        dtype="bfloat16", kv_block_size=64, max_batch_size=8,
        splitfuse_tokens=256, decode_steps_per_dispatch=8,
        num_kv_blocks=513, weight_quant=mode), device="cuda")
    torch.cuda.synchronize()
    codes = sum(w.q.numel() for w in model.qblocks.values())
    log(f"{kind} {mode} ({L} layers) built in "
        f"{time.perf_counter() - t0:.1f} s: {cfg.num_params() / 1e9:.2f}B "
        f"params, {codes / 1e9:.2f} GB of codes, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")

    first_decode = []
    sort = mx.sort_by_expert

    def recording_sort(experts, E):
        order, sizes = sort(experts, E)
        if experts.shape[0] == 8 and len(first_decode) < L:
            first_decode.append(sizes)
        return order, sizes

    k7_calls = []                # (rows, design) of every K7 call
    wq_design = mm._wq_design
    k9_rows = {}                 # K9's design -> the row counts it took
    k9_design = gm._wq_grouped_design

    def recording_design(x2, w):
        design = wq_design(x2, w)
        k7_calls.append((x2.shape[0], design))
        return design

    def recording_k9_design(x, w):
        design = k9_design(x, w)
        k9_rows.setdefault(design, set()).add(x.shape[0])
        return design

    rs = np.random.RandomState(seed)
    lens = rs.randint(64, 2049, 8)
    new = 64
    torch.cuda.reset_peak_memory_stats()
    for mod in (pa, gm, mm):
        mod.reset_launch_counts()
    for k in eng.forward_counts:
        eng.forward_counts[k] = 0
    mx.sort_by_expert = recording_sort
    mm._wq_design = recording_design
    gm._wq_grouped_design = recording_k9_design
    try:
        t_start = time.perf_counter()
        uids = []
        for i, n in enumerate(lens):
            sampled = i >= 6
            uids.append(eng.put(rs.randint(0, cfg.vocab_size, (n,)), new,
                                temperature=0.8 if sampled else None,
                                top_k=40 if sampled else None))
        if profile:
            acts = [torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                first, done = serve(eng, uids)
            e2e = time.perf_counter() - t_start
            write_profile(prof, profile, e2e)
        else:
            first, done = serve(eng, uids)
            e2e = time.perf_counter() - t_start
    finally:
        mx.sort_by_expert = sort
        mm._wq_design = wq_design
        gm._wq_grouped_design = k9_design
    launches = {**pa.LAUNCHES, **gm.LAUNCHES, **mm.LAUNCHES}
    k7_by_design = {k: v for k, v in mm.DESIGN_LAUNCHES["wq_matmul"].items()
                    if v}
    outs = [eng.get(u) for u in uids]
    for u, o in zip(uids, outs):
        assert len(o) == new, (u, len(o))
        assert ((o >= 0) & (o < cfg.vocab_size)).all(), u
    fc = eng.forward_counts
    forwards = fc["prefill"] + fc["chunk"] + fc["decode"]
    want = {k: 0 for k in launches}
    want["paged_decode"] = L * fc["decode"]
    want["paged_chunk"] = L * (fc["chunk"] + fc["prefill"])
    if kind == "llama":
        want["wq_matmul"] = 3 * L * forwards
    else:
        want["grouped_swiglu_up_wq"] = want["grouped_gmm_wq"] = L * forwards
    assert launches == want, (launches, want)
    count_paged_designs(pa, launches)
    # K7 by design: every bf16 call of at least WQ_SM90_MIN_ROWS rows (each
    # chunk's products among them) on sm90, the rest on mma_sync
    k7_rows = {}
    if kind == "llama":
        assert len(k7_calls) == launches["wq_matmul"], len(k7_calls)
        for rows, design in k7_calls:
            assert design == ("sm90" if rows >= mm.WQ_SM90_MIN_ROWS
                              else "mma_sync"), (rows, design)
            k7_rows.setdefault(design, set()).add(rows)
        assert sum(k7_by_design.values()) == launches["wq_matmul"] and \
            k7_by_design.get("sm90", 0) == sum(
                1 for _, d in k7_calls if d == "sm90"), k7_by_design
        count_designs("wq_matmul", k7_by_design)
    else:
        # K9 by design: every bf16 call of at least WQ_GROUPED_SM90_MIN_ROWS
        # rows (decode and chunk) on sm90, the rest on mma_sync
        assert all(r >= gm.WQ_GROUPED_SM90_MIN_ROWS
                   for r in k9_rows.get("sm90", ())) and all(
            r < gm.WQ_GROUPED_SM90_MIN_ROWS
            for r in k9_rows.get("mma_sync", ())), k9_rows
        for name in ("grouped_swiglu_up_wq", "grouped_gmm_wq"):
            by = dict(gm.DESIGN_LAUNCHES[name])
            assert sum(by.values()) == launches[name] and not by["fp32"], \
                (name, by)
            count_designs(name, by)

    hist = [s.tolist() for s in first_decode]
    ttft = sorted(first[u] - t_start for u in uids)
    tpot = sorted((done[u] - first[u]) / (new - 1) for u in uids)
    stats = dict(
        model=f"{kind} {mode}", n_layer=L, requests=len(uids),
        prompt_tokens=int(lens.sum()),
        generated_tokens=int(sum(len(o) for o in outs)),
        ttft_p50_s=float(np.percentile(ttft, 50)),
        tpot_p50_ms=float(np.percentile(tpot, 50)) * 1e3,
        output_tok_per_s=float(sum(len(o) for o in outs) / e2e),
        e2e_s=e2e, forwards=dict(fc),
        launches={k: v for k, v in launches.items() if v},
        code_gb=codes / 1e9,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    if k7_rows:
        stats["wq_matmul_launches_by_design"] = k7_by_design
        stats["wq_matmul_rows_by_design"] = {
            k: [min(v), max(v)] for k, v in k7_rows.items()}
        stats["wq_matmul_chunk_launches"] = sum(
            1 for rows, _ in k7_calls if rows > 8)
    if kind == "mixtral":
        stats["first_decode_expert_load"] = hist
        stats["k9_launches_by_design"] = {
            n: {k: v for k, v in gm.DESIGN_LAUNCHES[n].items() if v}
            for n in ("grouped_swiglu_up_wq", "grouped_gmm_wq")}
        stats["k9_rows_by_design"] = {k: [min(v), max(v)]
                                      for k, v in k9_rows.items()}
        assert len(hist) == L and all(sum(h) == 16 for h in hist), hist
    log("wq slice " + json.dumps(stats))
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return {k: v for k, v in launches.items()
            if k in ("wq_matmul", "grouped_swiglu_up_wq", "grouped_gmm_wq")
            and v}


# ------------------------------------------- K13 / K6 kernels (phase 18)


def rel_norm(out, ref):
    """Relative error norm of ``out`` against the fp32 ``ref`` (a sum over
    rows: dscale, dbias, dW)."""
    return (torch.linalg.vector_norm(out.float() - ref)
            / torch.linalg.vector_norm(ref)).item()


def phase_knob_kernels(ln, mm, seed=0, P=24, T=1024, D=1024):
    """K13 (LayerNorm forward / backward) and K6 (the projection _mm and
    its dW) at the GPT-2 350M training shapes: LN over N = 24 * 1024 rows
    (ln1, ln2), 24 * 512 (lnf per CE chunk) and an odd 24 * 1024 + 37, D =
    1024; K6 at all four (x_t, out_t) pairs at (P, T) = (24, 1024), (K, M)
    = (1024, 4096) and (4096, 1024), forward, dx and dW. bf16 against the
    plain versions run in fp32 on the same inputs (bf16_mismatch; dscale,
    dbias and dW by relative error norm within BF16_REL_NORM), fp32 at
    1e-4; a control per kernel that must fail; each timed beside its bound,
    plain version and one library call (F.layer_norm's forward and
    backward ops, torch.matmul / einsum on the same operands)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    bf, f32 = torch.bfloat16, torch.float32

    def randn(shape, dtype=bf, s=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device="cuda") * s
                + shift).to(dtype)

    err = {"layernorm_fwd": 0.0, "layernorm_bwd": 0.0, "mlp_mm": 0.0,
           "mlp_dw": 0.0}
    worst = {"ds/db": 0.0, "dW": 0.0}

    # ---- K13: fp32 at 1e-4 (incl. D > 1024, rows read again), then bf16
    for N_, D_ in ((300, 384), (1000, 1024), (77, 2048)):
        x, dy = randn((N_, D_), f32, 2.0, 0.5), randn((N_, D_), f32)
        sc, bi = randn((D_,), f32, 0.1, 1.0), randn((D_,), f32, 0.1)
        torch.testing.assert_close(ln._fwd(x, sc, bi, 1e-5),
                                   ln.layernorm_reference(x, sc, bi),
                                   **FP32_TOL)
        for got, ref in zip(ln._bwd(x, sc, dy, 1e-5),
                            ln.layernorm_bwd_reference(x, sc, dy)):
            torch.testing.assert_close(got, ref, **FP32_TOL)
    sc, bi = randn((D,), bf, 0.1, 1.0), randn((D,), bf, 0.1)
    scf, bif = sc.float(), bi.float()
    ln_cases = {}
    for N_ in (P * T, P * 512, P * T + 37):
        x, dy = randn((N_, D), bf, 2.0, 0.5), randn((N_, D))
        xf, dyf = x.float(), dy.float()
        y = ln._fwd(x, sc, bi, 1e-5)
        dx, ds, db = ln._bwd(x, sc, dy, 1e-5)
        again = ln._bwd(x, sc, dy, 1e-5)
        torch.cuda.synchronize()
        ry = ln.layernorm_reference(xf, scf, bif)
        rdx, rds, rdb = ln.layernorm_bwd_reference(xf, scf, dyf)
        for name, got, ref in (("layernorm_fwd", y, ry),
                               ("layernorm_bwd", dx, rdx)):
            why = bf16_mismatch(got, ref)
            assert why is None, f"{name} N={N_}: {why}"
            err[name] = max(err[name], bf16_errors(got, ref)[1])
        for got, ref in ((ds, rds), (db, rdb)):
            rel = rel_norm(got, ref)
            assert rel <= BF16_REL_NORM, f"dscale/dbias N={N_}: {rel:.3g}"
            worst["ds/db"] = max(worst["ds/db"], rel)
        assert all(torch.equal(a, b) for a, b in zip((dx, ds, db), again)), \
            "layernorm_bwd does not repeat bitwise"
        # control: one CTA's 64 rows dropped from the dscale reduction
        keep = torch.ones(N_, dtype=torch.bool, device="cuda")
        keep[64 * (N_ // 128):64 * (N_ // 128) + 64] = False
        ctrl = ln.layernorm_bwd_reference(xf[keep], scf, dyf[keep])[1]
        crel = rel_norm(ctrl.to(bf), rds)
        assert crel > BF16_REL_NORM, "dscale check let a dropped CTA pass"
        ln_cases[N_] = (x, dy, crel)
        del y, dx, again, ry, rdx, keep, xf, dyf
    log(f"layernorm checks ok: fp32 at 1e-4 (D = 384, 1024, 2048), bf16 "
        f"max |err| y {err['layernorm_fwd']:.3g} dx "
        f"{err['layernorm_bwd']:.3g}, worst dscale/dbias relative error "
        f"norm {worst['ds/db']:.3g}; the backward repeats bitwise; control: "
        f"one CTA's rows dropped from dscale fails (relative error norm "
        + ", ".join(f"N={n}: {c[2]:.3g}" for n, c in ln_cases.items())
        + f" > {BF16_REL_NORM})")

    rows = {}
    for N_ in (P * T, P * 512):
        x, dy, _ = ln_cases[N_]
        nbytes = 2 * N_ * D * 2 + 2 * D * 2
        w_ = sc.detach()
        _, mean, rstd = torch.ops.aten.native_layer_norm(x, [D], w_, bi,
                                                         1e-5)
        tf = dict(
            ms=time_ms(lambda: ln._fwd(x, sc, bi, 1e-5), 50),
            plain_ms=time_ms(lambda: ln.layernorm_reference(x, sc, bi), 10),
            library_ms=time_ms(lambda: F.layer_norm(x, [D], sc, bi, 1e-5),
                               50),
            bound=bound(nbytes, 8 * N_ * D))
        tb = dict(
            ms=time_ms(lambda: ln._bwd(x, sc, dy, 1e-5), 50),
            plain_ms=time_ms(lambda: ln.layernorm_bwd_reference(x, sc, dy),
                             10),
            library_ms=time_ms(
                lambda: torch.ops.aten.native_layer_norm_backward(
                    dy, x, [D], mean, rstd, w_, bi, [True, True, True]), 50),
            bound=bound(3 * N_ * D * 2 + 3 * D * 2, 16 * N_ * D))
        for name, t in (("layernorm_fwd", tf), ("layernorm_bwd", tb)):
            t["shape"] = f"N={N_} D={D}"
            if name in rows:
                rows[name]["other"] = {t["shape"]: {
                    k: (v[0] if k == "bound" else v) for k, v in t.items()
                    if k != "shape"}}
            else:
                rows[name] = t
            log(f"{name} N={N_} D={D}: {t['ms']:.4f} ms (plain "
                f"{t['plain_ms']:.4f}, library {t['library_ms']:.4f}, bound "
                f"{t['bound'][0]:.4f} by {t['bound'][1]})")
    rows["layernorm_fwd"]["library"] = "F.layer_norm (aten native_layer_norm)"
    rows["layernorm_bwd"]["library"] = (
        "aten native_layer_norm_backward (from saved mean / rstd)")
    del ln_cases, x, dy, mean, rstd
    gc.collect()
    torch.cuda.empty_cache()

    # ---- K6: fp32 at 1e-4, small ragged shapes, every orientation
    for x_t, out_t in ((False, False), (True, False), (False, True),
                       (True, True)):
        x = randn((2, 136, 200) if x_t else (2, 200, 136), f32)
        w = randn((136, 96), f32, 0.1)
        dy = randn((2, 96, 200) if out_t else (2, 200, 96), f32)
        torch.testing.assert_close(
            mm._mm(x, w, x_t, False, out_t, f32),
            mm.mm_reference(x, w, x_t, False, out_t, f32), **FP32_TOL)
        torch.testing.assert_close(
            mm._mm(dy, w, out_t, True, x_t, f32),
            mm.mm_reference(dy, w, out_t, True, x_t, f32), **FP32_TOL)
        torch.testing.assert_close(
            mm._dw(x, dy, x_t, out_t, f32),
            mm.dw_reference(x, dy, x_t, out_t, f32), **FP32_TOL)

    # ---- K6: bf16 (the sm90 design) at ragged I, J and C, every
    # orientation: multiples of 8, none a multiple of the 128 x 256 tile or
    # the 64-deep k slice (forward (I, J, C) = (T, M, K), dW (K, M, T))
    Pr, Tr, Kr, Mr = 3, 200, 136, 264
    wr = randn((Kr, Mr), bf, 1 / math.sqrt(Kr))
    for x_t, out_t in ((False, False), (True, False), (False, True),
                       (True, True)):
        x = randn((Pr, Kr, Tr) if x_t else (Pr, Tr, Kr))
        dy = randn((Pr, Mr, Tr) if out_t else (Pr, Tr, Mr))
        xf, dyf, wf = x.float(), dy.float(), wr.float()
        mm.reset_launch_counts()
        y = mm._mm(x, wr, x_t, False, out_t, bf)
        dx = mm._mm(dy, wr, out_t, True, x_t, bf)
        dw = mm._dw(x, dy, x_t, out_t, bf)
        torch.cuda.synchronize()
        assert mm.LAUNCHES["mlp_mm"] == 2 and mm.LAUNCHES["mlp_dw"] == 1
        assert_sm90(f"K6 ragged x_t={x_t} out_t={out_t}", mm)
        tag = f"ragged (P, T, K, M) = ({Pr}, {Tr}, {Kr}, {Mr}) x_t={x_t} " \
              f"out_t={out_t}"
        for what, got, ref in (
                ("forward", y, mm.mm_reference(xf, wf, x_t, False, out_t,
                                               f32)),
                ("dx", dx, mm.mm_reference(dyf, wf, out_t, True, x_t, f32))):
            why = bf16_mismatch(got, ref)
            assert why is None, f"mlp_mm {what} {tag}: {why}"
        rel = rel_norm(dw, mm.dw_reference(xf, dyf, x_t, out_t, f32))
        assert torch.isfinite(dw).all() and rel <= BF16_REL_NORM, \
            f"mlp_dw {tag}: relative error norm {rel:.3g}"
    del wr, x, dy, xf, dyf, y, dx, dw

    # ---- K6: bf16 at the MLP shapes; the main path's orientations timed
    N = P * T
    timings = {}
    mm.reset_launch_counts()
    for K, M in ((D, 4 * D), (4 * D, D)):
        w = randn((K, M), bf, 1 / math.sqrt(K))
        wf = w.float()
        for x_t, out_t in ((False, False), (True, False), (False, True),
                           (True, True)):
            x = randn((P, K, T) if x_t else (P, T, K))
            dy = randn((P, M, T) if out_t else (P, T, M))
            xf, dyf = x.float(), dy.float()
            y = mm._mm(x, w, x_t, False, out_t, bf)
            dx = mm._mm(dy, w, out_t, True, x_t, bf)
            dw = mm._dw(x, dy, x_t, out_t, bf)
            again = (mm._mm(x, w, x_t, False, out_t, bf),
                     mm._mm(dy, w, out_t, True, x_t, bf),
                     mm._dw(x, dy, x_t, out_t, bf))
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip((y, dx, dw),
                                                         again)), \
                f"K6 (K, M) = ({K}, {M}) x_t={x_t} out_t={out_t} does not " \
                f"repeat bitwise"
            del again
            tag = f"(K, M) = ({K}, {M}) x_t={x_t} out_t={out_t}"
            for what, got, ref in (
                    ("forward", y, mm.mm_reference(xf, wf, x_t, False, out_t,
                                                   f32)),
                    ("dx", dx, mm.mm_reference(dyf, wf, out_t, True, x_t,
                                               f32))):
                why = bf16_mismatch(got, ref)
                assert why is None, f"mlp_mm {what} {tag}: {why}"
                err["mlp_mm"] = max(err["mlp_mm"], bf16_errors(got, ref)[1])
                if what == "forward" and out_t:
                    # control: the (P, N, M) result written as it lies into
                    # the (P, M, N) output
                    flat = ref.transpose(1, 2).contiguous().view(ref.shape)
                    assert bf16_mismatch(flat.to(bf), ref) is not None, \
                        "out_t check let an untransposed output pass"
                del ref
            rdw = mm.dw_reference(xf, dyf, x_t, out_t, f32)
            rel = rel_norm(dw, rdw)
            assert torch.isfinite(dw).all() and rel <= BF16_REL_NORM, \
                f"mlp_dw {tag}: relative error norm {rel:.3g}"
            worst["dW"] = max(worst["dW"], rel)
            err["mlp_dw"] = max(err["mlp_dw"],
                                (dw.float() - rdw).abs().max().item())
            # control: the contraction's last 64-row tile left out of dW
            xl = mm._log_a(xf, x_t)[-1, -64:]
            gl = mm._log_a(dyf, out_t)[-1, -64:]
            crel = rel_norm((rdw - xl.t() @ gl).to(bf), rdw)
            assert crel > BF16_REL_NORM, "dW check let a lost row tile pass"
            del y, dx, dw, rdw, xl, gl, xf, dyf
            # the main path ("both"): up (K=D) forward out_t, dx from the
            # (B, F, T) cotangent, dW with g_t; down (K=F) forward x_t, dx
            # out in x's (B, F, T) orientation, dW with a_t
            up = K == D
            if (x_t, out_t) != ((False, True) if up else (True, False)):
                del x, dy
                continue
            x_log, dy_log = mm._log_a(x, x_t), mm._log_a(dy, out_t)
            fwd_bytes = (N * K + K * M + N * M) * 2
            flops = 2 * N * K * M
            name = "up" if up else "down"
            timings[("mlp_mm", f"{name} forward")] = dict(
                ms=time_ms(lambda: mm._mm(x, w, x_t, False, out_t, bf), 10),
                plain_ms=time_ms(lambda: mm.mm_reference(
                    x, w, x_t, False, out_t, bf), 3),
                library_ms=time_ms(lambda: torch.matmul(x_log, w), 10),
                bound=bound(fwd_bytes, flops))
            timings[("mlp_mm", f"{name} dx")] = dict(
                ms=time_ms(lambda: mm._mm(dy, w, out_t, True, x_t, bf), 10),
                plain_ms=time_ms(lambda: mm.mm_reference(
                    dy, w, out_t, True, x_t, bf), 3),
                library_ms=time_ms(lambda: torch.matmul(dy_log, w.t()), 10),
                bound=bound(fwd_bytes, flops))
            timings[("mlp_dw", f"{name} dW")] = dict(
                ms=time_ms(lambda: mm._dw(x, dy, x_t, out_t, bf), 10),
                plain_ms=time_ms(lambda: mm.dw_reference(
                    x, dy, x_t, out_t, bf), 3),
                library_ms=time_ms(lambda: torch.einsum(
                    "pnk,pnm->km", x_log, dy_log), 10),
                bound=bound(fwd_bytes, flops))
            del x, dy, x_log, dy_log
        del w, wf
        gc.collect()
        torch.cuda.empty_cache()
    assert_sm90("K6 at the MLP shapes", mm)
    log(f"K6 checks ok: fp32 at 1e-4 (ragged, every orientation), bf16 "
        f"(sm90) ragged and at every (x_t, out_t) and both MLP shapes: max "
        f"|err| forward / dx {err['mlp_mm']:.3g}, worst dW relative error "
        f"norm {worst['dW']:.3g}; bitwise repeats; controls fail as they "
        f"must: an out_t output written untransposed, dW without its last "
        f"64-row tile")
    for (name, what), t in timings.items():
        log(f"{name} {what} (P, T) = ({P}, {T}): {t['ms']:.4f} ms (plain "
            f"{t['plain_ms']:.4f}, library {t['library_ms']:.4f}, bound "
            f"{t['bound'][0]:.4f} by {t['bound'][1]})")
    for name, main in (("mlp_mm", "up forward"), ("mlp_dw", "up dW")):
        r = dict(timings[(name, main)])
        r["shape"] = f"{main}, (P, T) = ({P}, {T}), D = {D}, F = {4 * D}"
        r["library"] = ("torch.matmul" if name == "mlp_mm" else
                        "torch.einsum pnk,pnm->km")
        r["other"] = {w: {k: (v[0] if k == "bound" else v)
                          for k, v in t.items()}
                      for (n, w), t in timings.items()
                      if n == name and w != main}
        rows[name] = r
    for name in rows:
        rows[name]["max_abs_err"] = err[name]
    # the sums over rows are held by relative error norm
    rows["layernorm_bwd"]["dscale_dbias_rel_norm"] = worst["ds/db"]
    rows["mlp_dw"]["rel_norm"] = worst["dW"]
    return rows


# --------------------------------------------- K13 / K6 parity (phase 19)


def phase_knob_parity(seed=0):
    """Small fp32 GPT-2 (D=128, save_flash, the flash and fused CE
    kernels) with fused_layernorm in {True, "bwd"}, mlp_kernel in {"down",
    "both"} and fuse_dw both ways against the same model with the knobs
    off: the same loss (rtol 2e-5) and every gradient (relative error norm
    1e-4), with exactly the launches the knobs imply; then a small GPT2MoE
    with fused_layernorm=True held the same way."""
    from deepspeed_tpu_torch import GPT2, GPT2Config, GPT2MoE
    from deepspeed_tpu_torch.ops.cuda import layernorm as ln
    from deepspeed_tpu_torch.ops.cuda import mlp_matmul as mm
    base = dict(n_layer=2, n_head=2, d_model=128, max_seq_len=256,
                vocab_size=1000, dtype="float32", loss_chunk=100,
                fused_loss=True, fused_loss_kernel=True,
                use_flash_attention=True, remat=True,
                remat_policy="save_flash")
    ids = torch.from_numpy(np.random.RandomState(seed).randint(
        0, 1000, (4, 256))).cuda()
    chunks = -(-255 // 100)

    def run(model):
        for mod in (ln, mm):
            mod.reset_launch_counts()
        loss = model.loss({"input_ids": ids})
        loss.backward()
        torch.cuda.synchronize()
        launched = {**ln.LAUNCHES, **mm.LAUNCHES}
        return loss.item(), {n: p.grad for n, p in
                             model.named_parameters()}, launched

    def hold(name, got, ref):
        (l_on, g_on, _), (l_off, g_off, _) = got, ref
        assert abs(l_on - l_off) <= 2e-5 * abs(l_off), (name, l_on, l_off)
        w = 0.0
        for n, g in g_off.items():
            rel = (torch.linalg.vector_norm(g_on[n] - g)
                   / torch.linalg.vector_norm(g)).item()
            assert rel <= 1e-4, (name, n, rel)
            w = max(w, rel)
        return w

    off = run(GPT2(GPT2Config(**base), device="cuda", seed=seed))
    assert not any(off[2].values()), off[2]
    worst = 0.0
    for ln_knob in (True, "bwd"):
        for mode in ("down", "both"):
            for fuse in (True, False):
                cfg = GPT2Config(**base, fused_layernorm=ln_knob,
                                 mlp_kernel=mode, mlp_kernel_fuse_dw=fuse)
                got = run(GPT2(cfg, device="cuda", seed=seed))
                want = {"wq_matmul": 0,
                        **knob_launches(cfg, cfg.n_layer, 1, chunks)}
                assert got[2] == want, (ln_knob, mode, fuse, got[2], want)
                worst = max(worst, hold((ln_knob, mode, fuse), got, off))
    moe = dict(num_experts=4, moe_top_k=2, moe_backend="ragged")
    moe_off = run(GPT2MoE(moe_cfg(GPT2Config(**base), **moe), device="cuda",
                          seed=seed))
    cfg = moe_cfg(GPT2Config(**base, fused_layernorm=True), **moe)
    moe_on = run(GPT2MoE(cfg, device="cuda", seed=seed))
    L = cfg.n_layer
    assert moe_on[2]["layernorm_fwd"] == 4 * L + chunks, moe_on[2]
    assert moe_on[2]["layernorm_bwd"] == 2 * L + chunks, moe_on[2]
    worst_moe = hold("moe", moe_on, moe_off)
    log(f"K13/K6 parity ok: 8 knob settings against the knobs off, loss "
        f"{off[0]:.7f}, worst gradient relative error norm {worst:.3g}; "
        f"GPT2MoE with fused_layernorm, loss {moe_on[0]:.7f} vs "
        f"{moe_off[0]:.7f}, worst {worst_moe:.3g}")


# ---------------------------------------------- K13 / K6 slice (phase 20)


def phase_knob_slice(seed=0, steps=10, profile=None):
    """Phase 7's GPT-2 350M bench configuration with fused_layernorm=True,
    mlp_kernel="both", mlp_kernel_fuse_dw=True: 10 train_batch steps, the
    loss falling, the launches exactly what the knobs imply; its step time
    beside phase 7's from this run, and beside 10 steps with
    fused_layernorm=True alone."""
    launches = phase_train_slice(
        seed=seed, steps=steps, profile=profile, tag="knob train slice",
        knobs=dict(fused_layernorm=True, mlp_kernel="both",
                   mlp_kernel_fuse_dw=True))
    # which knob moves the step: fused_layernorm alone, after the main path
    # (its launches are checked, not counted for the path)
    phase_train_slice(seed=seed, steps=steps, tag="layernorm-only slice",
                      knobs=dict(fused_layernorm=True), main_path=False)
    off = TRAIN_STATS["train slice"]
    keys = ("step_s_median_after_first", "tokens_per_s",
            "model_tflops_per_s", "max_memory_allocated_gb")
    for tag in ("knob train slice", "layernorm-only slice"):
        on = TRAIN_STATS[tag]
        log(f"gpt2-350M {tag} vs phase 7 (knobs off), this run: "
            + ", ".join(f"{k} {on[k]:.4f} vs {off[k]:.4f}" for k in keys))
    return launches


# --------------------------------------------- K2-qmajor kernel (phase 21)


def phase_qmajor_kernel(fa, seed=0):
    """K2-qmajor (``flash_backward_qmajor``) at phase 7's shapes (B=24,
    H=16, T=1024, d=64, bf16, causal) against its plain version run in fp32
    on the same inputs, with a window, a padded T and an lse cotangent;
    fp32 cases at 1e-4; a control (dk/dv without the last query tile's
    contribution) that must fail; a bitwise repeat, and bitwise equality
    with the k-major K2 (the same 64 x 64 tile products accumulated in the
    same order); timed beside its bound (row 7's work), the k-major K2 and
    SDPA's backward."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    bf, f32 = torch.bfloat16, torch.float32

    def randn(shape, dtype=bf, s=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * s).to(dtype)

    # ---- fp32 cases (the kernel's fp32 instances, at FP32_TOL)
    for (B, H, T, d, causal, window, dl) in (
            (2, 4, 200, 64, True, 0, True), (1, 2, 333, 128, True, 100, False),
            (2, 2, 130, 32, False, 0, True), (1, 3, 64, 64, True, 0, False)):
        q, k, v, do = (randn((B, T, H, d), f32).transpose(1, 2)
                       for _ in range(4))
        q = q * 0.3
        o, lse = fa.flash_forward(q, k, v, causal=causal, window=window)
        dlse = randn((B, H, T), f32) if dl else None
        kw = dict(causal=causal, window=window, dlse=dlse)
        got = fa.flash_backward_qmajor(q, k, v, o, lse, do, **kw)
        refs = fa.flash_bwd_qmajor_reference(q, k, v, o, lse, do, **kw)
        for a, r in zip(got, refs):
            torch.testing.assert_close(a, r, **FP32_TOL)
    log("K2-qmajor: fp32 cases ok (window, ragged T, non-causal, lse "
        "cotangent)")

    # ---- bf16 at the slice shapes: the main case, a window, a padded T
    # and an lse cotangent
    B, H, T, d = 24, 16, 1024, 64
    worst, err = 0.0, 0.0
    for case in (dict(), dict(window=256), dict(T=1000), dict(dlse=True)):
        Tc, window = case.get("T", T), case.get("window", 0)
        q, k, v, do = (randn((B, Tc, H, d)).transpose(1, 2)
                       for _ in range(4))
        q = fa.scale_q(q, 1.0 / math.sqrt(d))
        o, lse = fa.flash_forward(q, k, v, window=window)
        dlse = randn((B, H, Tc), f32, 0.1) if case.get("dlse") else None
        got = fa.flash_backward_qmajor(q, k, v, o, lse, do, window=window,
                                       dlse=dlse)
        f32s = [x.float() for x in (q, k, v, o)]
        refs = fa.flash_bwd_qmajor_reference(*f32s, lse, do.float(),
                                             window=window, dlse=dlse)
        for name, a, r in zip(("dq", "dk", "dv"), got, refs):
            why = bf16_grad_mismatch(a, r)
            assert why is None, f"flash_bwd_qmajor {case} {name}: {why}"
            worst = max(worst, grad_rel_norm(a, r))
            err = max(err, (a.float() - r).abs().max().item())
        if case:
            continue
        again = fa.flash_backward_qmajor(q, k, v, o, lse, do)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), \
            "flash_bwd_qmajor is not bitwise repeatable"
        # the same tile products in the same order as the k-major K2
        kmajor = fa.flash_backward(q, k, v, o, lse, do)
        assert all(torch.equal(a, b) for a, b in zip(got, kmajor)), \
            "flash_bwd_qmajor differs from the k-major K2"
        do_cut = do.float().clone()
        do_cut[:, :, T - 64:] = 0      # the last query tile's dk/dv dropped
        cut = fa.flash_bwd_qmajor_reference(*f32s, lse, do_cut)
        for name, i in (("dk", 1), ("dv", 2)):
            why = bf16_grad_mismatch(cut[i].to(bf), refs[i])
            assert why is not None, \
                f"grad check let {name} without the last query tile pass"
            log(f"control: qmajor {name} without the last query tile's "
                f"contribution fails ({why})")
        main = (q, k, v, o, lse, do)
        del cut, do_cut, again, kmajor
    log(f"K2-qmajor checks ok at the slice shapes (+ window 256, T=1000, "
        f"lse cotangent): max |err| {err:.3g}, worst slab relative error "
        f"norm {worst:.3g}; bitwise repeat, bitwise equal to the k-major "
        f"K2")
    worst = max(worst, flash_bwd_sm90_cases(fa, randn, qmajor=True))

    # ---- timing (row 7's work: the same bound)
    q, k, v, o, lse, do = main
    pairs = B * H * _causal_pairs(T)
    act = B * T * H * d * 2
    bwd_bytes = 8 * act + B * H * T * 4
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa_o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                            scale=1.0)
    qmajor_mma_sync = flash_bwd_as(fa, "mma_sync", qmajor=True)
    fa.reset_launch_counts()
    row = dict(
        ms=time_ms(lambda: fa.flash_backward_qmajor(q, k, v, o, lse, do), 10),
        mma_sync_ms=time_ms(lambda: qmajor_mma_sync(q, k, v, o, lse, do),
                            10),
        kmajor_ms=time_ms(lambda: fa.flash_backward(q, k, v, o, lse, do), 10),
        plain_ms=time_ms(lambda: fa.flash_bwd_qmajor_reference(
            q, k, v, o, lse, do), 2),
        library_ms=time_ms(lambda: torch.autograd.grad(
            sdpa_o, (qs, ks, vs), do, retain_graph=True), 10),
        bound=bound(bwd_bytes, 10 * d * pairs), max_abs_err=err,
        rel_norm=worst)
    assert fa.DESIGN_LAUNCHES["flash_bwd_qmajor"]["sm90"] == 13 and \
        fa.DESIGN_LAUNCHES["flash_bwd"]["sm90"] == 13, fa.DESIGN_LAUNCHES
    row["split_ms"] = flash_kernel_ms(
        kernel_split_ms(lambda: fa.flash_backward_qmajor(q, k, v, o, lse,
                                                         do)),
        ("flash_delta_kernel", "flash_bwd_qmajor_sm90_kernel"))
    log(f"flash_bwd_qmajor: {row['ms']:.4f} ms on sm90 (its mma_sync design "
        f"{row['mma_sync_ms']:.4f}; kernels a call {row['split_ms']}; "
        f"k-major K2 "
        f"{row['kmajor_ms']:.4f}, plain {row['plain_ms']:.4f}, SDPA "
        f"backward {row['library_ms']:.4f}, bound {row['bound'][0]:.4f} by "
        f"{row['bound'][1]}; fp32 dk/dv scratch "
        f"{2 * B * H * T * d * 4 / 1e6:.1f} MB)")
    del sdpa_o, qs, ks, vs, main, q, k, v, o, lse, do
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------- K11 kernels (phase 22)


def bsa_config(kind):
    """(SparsityConfig, causal, T) of the SparseSelfAttention cells: (a)
    Fixed, unidirectional, block 64; (b) BigBird, block 64, non-causal;
    block 16 at T=2048 (BigBird with a layout per head)."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, FixedSparsityConfig)
    if kind == "fixed":
        return FixedSparsityConfig(
            num_heads=16, block=64, num_local_blocks=4, num_global_blocks=1,
            attention="unidirectional"), True, 8192
    if kind == "bigbird":
        return BigBirdSparsityConfig(num_heads=16, block=64), False, 8192
    return BigBirdSparsityConfig(num_heads=16, block=16,
                                 different_layout_per_head=True,
                                 num_random_blocks=2), True, 2048


def bsa_bounds(lists, B, blk, d, T):
    """Each K11 kernel's bound from this layout's present block pairs
    (row counts summed over heads, times B) at bf16: forward 4 blk^2 d
    flops a pair (S, PV), dq 6 (S, dP, dQ), dk/dv 8 (S, dP, dV, dK); each
    input read once, each output written once."""
    H = lists["row_cnt"].shape[0]
    pairs = int(lists["row_cnt"].sum().item()) * B
    act = B * H * T * d * 2
    rowf = B * H * T * 4
    per = blk * blk * d
    return pairs, {"bsa_fwd": bound(4 * act + rowf, 4 * per * pairs),
                   "bsa_dq": bound(6 * act + 2 * rowf, 6 * per * pairs),
                   "bsa_dkv": bound(6 * act + 2 * rowf, 8 * per * pairs)}


def union_waste(lists):
    """The Hopper K11 forward's extra block pairs over the present ones:
    each of its consumers runs every entry of its pair's union walk, so
    (2 sum(ucnt) - sum(row_cnt)) / sum(row_cnt)."""
    cnt = int(lists["row_cnt"].sum().item())
    return (2 * int(lists["ucnt"].sum().item()) - cnt) / max(1, cnt)


def split_idle(lists):
    """The Hopper K11 backward's idle half-steps: its two consumers take the
    entries of one list in turns, two a stage, so a list of c entries runs
    2 ceil(c / 2) half-steps, c % 2 of them idle; the idle share of all
    half-steps over the row lists (dq) and the column lists (dk/dv)."""
    out = {}
    for name, key in (("bsa_dq", "row_cnt"), ("bsa_dkv", "col_cnt")):
        c = lists[key].long()
        out[name] = (c % 2).sum().item() / max(1, (2 * ((c + 1) // 2)).sum()
                                               .item())
    return out


def bsa_cut_lists(lists, key):
    """Host copies of the four lists with head 0's shortest ``key`` list
    ("row" or "col") of at least two entries short by its last entry, and
    that list's block."""
    host = {k: lists[k].cpu().numpy().copy()
            for k in ("rows", "row_cnt", "cols", "col_cnt")}
    cnt = host[f"{key}_cnt"][0]
    blk = int(np.argmin(np.where(cnt >= 2, cnt, np.iinfo(np.int32).max)))
    host[f"{key}_cnt"][0, blk] -= 1
    return host, blk


def bsa_bwd_controls(bsa, q, k, v, o, lse, delta, do, lists, causal, refs):
    """The sm90 K11 backward's controls: dk/dv with head 0's shortest column
    list (of at least two entries) short by its last entry, and dq with
    such a row list short, held by the bf16 gradient check on the cut
    block's rows of head 0's instances (``refs``: dq, dk, dv from the
    plain versions in fp32 on the whole lists), which the whole lists pass
    there and the cut ones must fail. Returns the reasons they fail."""
    H = lists["rows"].shape[0]

    def block_rows(x, b):            # (instances of head 0, 1, 64, d)
        return x[0::H, None, b * 64:(b + 1) * 64]

    whole = ((bsa.bsa_dq(q, k, v, o, lse, do, lists, 64, causal,
                         design="sm90")[0],)
             + bsa.bsa_dkv(q, k, v, lse, delta, do, lists, 64, causal,
                           design="sm90"))
    cut_c, j = bsa_cut_lists(lists, "col")
    cut_r, i = bsa_cut_lists(lists, "row")
    cut = ((bsa.bsa_dq(q, k, v, o, lse, do, bsa.lists_on(cut_r, "cuda"), 64,
                       causal, design="sm90")[0],)
           + bsa.bsa_dkv(q, k, v, lse, delta, do,
                         bsa.lists_on(cut_c, "cuda"), 64, causal,
                         design="sm90"))
    whys = {}
    for name, blk, a, b, ref in zip(("dq", "dk", "dv"), (i, j, j), whole,
                                    cut, refs):
        why = bf16_grad_mismatch(block_rows(a, blk), block_rows(ref, blk))
        assert why is None, f"{name} on the whole lists, block {blk}: {why}"
        why = bf16_grad_mismatch(block_rows(b, blk), block_rows(ref, blk))
        assert why is not None, \
            f"{name} with block {blk}'s list short by one entry passed"
        whys[name] = f"block {blk}: {why}"
    return whys


def phase_bsa_kernels(bsa, seed=0):
    """K11 (bsa_fwd, bsa_dq, bsa_dkv) at GPT-2 350M's attention widths (H=16,
    d=64, bf16, B=4): (a) Fixed causal and (b) BigBird at T=8192, block 64,
    and block 16 at T=2048, against their plain versions run in fp32 on the
    same inputs; fp32 cases at every block size at 1e-4; controls (the
    forward with one row's list short by its last id; the sm90 dq and
    dk/dv with one row / column list short by its last entry; dk/dv from
    the neighbour head's column lists) that must fail; rows with no
    present block exactly 0; bitwise repeats; each pass on the design its
    rule picks (counted); (a) and (b) timed beside their bounds, their
    plain versions, both bf16 designs of every pass (launches queued) and
    SDPA on the dense causal problem at the same shape, and the
    masked-dense op beside the kernels at T=2048."""
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, SparseSelfAttention, sparse_attention)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    bf, f32 = torch.bfloat16, torch.float32

    def randn(shape, dtype=bf, s=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * s).to(dtype)

    def run(q, k, v, do, lists, blk, causal):
        o, lse = bsa.bsa_forward(q, k, v, lists, blk, causal)
        dq, delta = bsa.bsa_dq(q, k, v, o, lse, do, lists, blk, causal)
        dk, dv = bsa.bsa_dkv(q, k, v, lse, delta, do, lists, blk, causal)
        return o, lse, dq, delta, dk, dv

    def plain(q, k, v, o, lse, do, lists, blk, causal):
        ro, rlse = bsa.bsa_forward_reference(q, k, v, lists, blk, causal)
        rdq, rdelta = bsa.bsa_dq_reference(q, k, v, o, lse, do, lists, blk,
                                           causal)
        rdk, rdv = bsa.bsa_dkv_reference(q, k, v, lse, rdelta, do, lists,
                                         blk, causal)
        return ro, rlse, rdq, rdelta, rdk, rdv

    # ---- fp32 at every block size, causal and not (FP32_TOL)
    for blk in bsa.BLOCKS:
        for causal in (True, False):
            cfg = BigBirdSparsityConfig(num_heads=2, block=blk,
                                        different_layout_per_head=True)
            T = 8 * blk
            lists = SparseSelfAttention(cfg, causal=causal).lists(T, "cuda")
            q, k, v, do = (randn((4, T, 64), f32) for _ in range(4))
            q = q * 0.3
            got = run(q, k, v, do, lists, blk, causal)
            refs = plain(q, k, v, got[0], got[1], do, lists, blk, causal)
            for a, r in zip(got, refs):
                torch.testing.assert_close(a, r, **FP32_TOL)
    log(f"K11: fp32 cases ok (blocks {bsa.BLOCKS}, causal and not)")

    # ---- rows with no present block: o, dq exactly 0; key blocks no
    # query block attends: dk, dv exactly 0 (every pass on sm90)
    lay = bsa_config("fixed")[0].make_layout(2048).copy()
    lay[:, 5] = False
    lay[:, 9] = False
    lay[:, :, 12] = False
    lists = bsa.lists_on(bsa.layout_lists(lay, True, 32, 32), "cuda")
    q, k, v, do = (randn((64, 2048, 64)) for _ in range(4))
    bsa.reset_launch_counts()
    o, lse, dq, _, dk, dv = run(q, k, v, do, lists, 64, True)
    assert all(by["sm90"] == 1 for by in bsa.DESIGN_LAUNCHES.values()), \
        bsa.DESIGN_LAUNCHES
    for rows in (slice(320, 384), slice(576, 640)):
        assert torch.count_nonzero(o[:, rows]) == 0, "masked row o != 0"
        assert torch.count_nonzero(dq[:, rows]) == 0, "masked row dq != 0"
        assert bool((lse[:, rows] == bsa.NEG_INF).all())
    for x in (dk, dv):
        assert torch.count_nonzero(x[:, 768:832]) == 0, "empty column != 0"
    log("K11: rows with no present block give o = 0, dq = 0, lse = -1e30; "
        "a key block with none gives dk = dv = 0")

    rows_out, err, rel, waste, idle = {}, {}, {}, {}, {}
    B, H, d = 4, 16, 64
    for kind in ("fixed", "bigbird", "block16"):
        cfg, causal, T = bsa_config(kind)
        blk = cfg.block
        lists = SparseSelfAttention(cfg, causal=causal).lists(T, "cuda")
        waste[kind] = union_waste(lists)
        idle[kind] = split_idle(lists)
        q, k, v, do = (randn((B * H, T, d)) for _ in range(4))
        q = q * 0.125                      # the softmax scale, in bf16
        # the forward's design by its rule: sm90 at block 64, mma_sync at 16
        design = bsa._bsa_fwd_design(q, k, v, blk, H)
        bwd_design = bsa._bsa_bwd_design(q, k, v, do, blk, H)
        assert design == bwd_design == (
            "mma_sync" if kind == "block16" else "sm90"), \
            (kind, design, bwd_design)
        bsa.reset_launch_counts()
        got = run(q, k, v, do, lists, blk, causal)
        o, lse, dq, delta, dk, dv = got
        f32s = [x.float() for x in (q, k, v)]
        refs = plain(*f32s, o.float(), lse, do.float(), lists, blk, causal)
        ro, rlse, rdq, rdelta, rdk, rdv = refs
        why = bf16_mismatch(o, ro)
        assert why is None, f"bsa_fwd {kind}: {why}"
        torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
        torch.testing.assert_close(delta, rdelta, rtol=1e-4, atol=1e-4)
        e = {"bsa_fwd": (o.float() - ro).abs().max().item()}
        r = {"bsa_fwd": bf16_errors(o, ro)[2]}
        for name, a, ref in (("bsa_dq", dq, rdq), ("bsa_dkv", dk, rdk),
                             ("bsa_dkv", dv, rdv)):
            why = bf16_grad_mismatch(a[:, None], ref[:, None])
            assert why is None, f"{name} {kind}: {why}"
            e[name] = max(e.get(name, 0.0),
                          (a.float() - ref).abs().max().item())
            r[name] = max(r.get(name, 0.0),
                          grad_rel_norm(a[:, None], ref[:, None]))
        err[kind], rel[kind] = e, r
        again = run(q, k, v, do, lists, blk, causal)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), \
            f"K11 {kind} is not bitwise repeatable"
        assert bsa.DESIGN_LAUNCHES["bsa_fwd"][design] == 2, \
            (kind, bsa.DESIGN_LAUNCHES)
        for name in ("bsa_dq", "bsa_dkv"):
            assert bsa.DESIGN_LAUNCHES[name][bwd_design] == 2 == \
                bsa.LAUNCHES[name], (kind, bsa.DESIGN_LAUNCHES)
        if bwd_design == "sm90":
            whys = bsa_bwd_controls(bsa, q, k, v, o, lse, delta, do, lists,
                                    causal, (rdq, rdk, rdv))
            for name, why in whys.items():
                log(f"control: {kind}, the sm90 {name} with one "
                    f"{'row' if name == 'dq' else 'column'} list short by "
                    f"its last entry fails ({why})")
        # control: the forward (on its design) with head 0's last query
        # block's list short by its last key block (the union walk rebuilt
        # from the short lists)
        short = {key: lists[key].cpu().numpy() for key in
                 ("rows", "row_cnt", "cols", "col_cnt")}
        n = T // blk
        short["row_cnt"][0, n - 1] -= 1
        cut, _ = bsa.bsa_forward(q, k, v, bsa.lists_on(short, "cuda"), blk,
                                 causal)
        why = bf16_mismatch(cut, ro)
        assert why is not None, f"{kind}: a short row list passed"
        log(f"control: {kind}, the {design} forward with one row's list "
            f"short by its last id, fails ({why})")
        if kind == "block16":
            # control: dk/dv from the neighbour head's column lists
            nb = dict(lists, cols=lists["cols"].roll(-1, 0),
                      col_cnt=lists["col_cnt"].roll(-1, 0))
            ndk, ndv = bsa.bsa_dkv_reference(*f32s, lse, rdelta, do.float(),
                                             nb, blk, causal)
            for name, a, ref in (("dk", ndk, rdk), ("dv", ndv, rdv)):
                why = bf16_grad_mismatch(a.to(bf)[:, None], ref[:, None])
                assert why is not None, \
                    f"{name} from the neighbour head's lists passed"
                log(f"control: {name} from the neighbour head's column "
                    f"lists fails ({why})")
        pairs, bounds = bsa_bounds(lists, B, blk, d, T)
        log(f"K11 {kind}: T={T} block {blk} causal={causal}, {pairs} block "
            f"pairs ({pairs / (B * H):.0f} a head), forward on {design} "
            f"(the union walk's extra pairs {100 * waste[kind]:.1f} %), "
            f"backward on {bwd_design} (the split walk's idle half-steps "
            f"dq {100 * idle[kind]['bsa_dq']:.1f} %, dk/dv "
            f"{100 * idle[kind]['bsa_dkv']:.1f} %), max |err| "
            + ", ".join(f"{n_} {x:.3g}" for n_, x in e.items())
            + "; worst relative error norm "
            + ", ".join(f"{n_} {x:.3g}" for n_, x in r.items()))
        if kind != "block16":
            # each pass on both bf16 designs with their launches queued
            calls = {
                "bsa_fwd": lambda dz: bsa.bsa_forward(
                    q, k, v, lists, blk, causal, design=dz),
                "bsa_dq": lambda dz: bsa.bsa_dq(
                    q, k, v, o, lse, do, lists, blk, causal, design=dz),
                "bsa_dkv": lambda dz: bsa.bsa_dkv(
                    q, k, v, lse, delta, do, lists, blk, causal, design=dz)}
            mma_ms = {name: time_queued(lambda: fn("mma_sync"), 20)[0]
                      for name, fn in calls.items()}
            t = {name: time_queued(lambda: fn("sm90"), 20)[0]
                 for name, fn in calls.items()}
            pt = {"bsa_fwd": time_ms(lambda: bsa.bsa_forward_reference(
                      q, k, v, lists, blk, causal), 2),
                  "bsa_dq": time_ms(lambda: bsa.bsa_dq_reference(
                      q, k, v, o, lse, do, lists, blk, causal), 2),
                  "bsa_dkv": time_ms(lambda: bsa.bsa_dkv_reference(
                      q, k, v, lse, delta, do, lists, blk, causal), 2)}
            for name in t:
                rows_out.setdefault(name, {})[kind] = dict(
                    ms=t[name], plain_ms=pt[name], bound=bounds[name],
                    max_abs_err=e[name], rel_norm=r[name], pairs=pairs,
                    design="sm90", mma_sync_ms=mma_ms[name])
            rows_out["bsa_fwd"][kind].update(union_waste=waste[kind])
            for name in ("bsa_dq", "bsa_dkv"):
                rows_out[name][kind].update(split_idle=idle[kind][name])
        del got, refs, again, q, k, v, do, o, lse, dq, delta, dk, dv
        torch.cuda.empty_cache()

    # ---- yardsticks: SDPA on the dense causal problem at (B=4, H=16,
    # T=8192, d=64), and the masked-dense op at T=2048 beside the kernels
    q, k, v, do = (randn((B, H, 8192, d)) for _ in range(4))
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa_o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    lib = {"bsa_fwd": time_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True), 10),
           "bsa_bwd": time_ms(lambda: torch.autograd.grad(
               sdpa_o, (qs, ks, vs), do, retain_graph=True), 5)}
    del sdpa_o, qs, ks, vs, q, k, v, do
    cfg, causal, _ = bsa_config("fixed")
    q, k, v = (randn((B, 2048, H, d)) for _ in range(3))
    lay = cfg.make_layout(2048)
    op = SparseSelfAttention(cfg, causal=causal)
    op.lists(2048, "cuda")
    dense_ms = time_ms(lambda: sparse_attention(q, k, v, lay, 64,
                                                causal=causal), 3)
    kern_ms = time_ms(lambda: op(q, k, v), 10)
    log(f"K11 yardsticks: SDPA dense causal at B=4 H=16 T=8192 d=64 forward "
        f"{lib['bsa_fwd']:.4f} ms, backward {lib['bsa_bwd']:.4f} ms; at "
        f"T=2048 (a)'s layout: masked-dense op forward {dense_ms:.4f} ms, "
        f"SparseSelfAttention forward (kernel) {kern_ms:.4f} ms")
    del q, k, v
    torch.cuda.empty_cache()

    out = {}
    for name, by in rows_out.items():
        a = by["fixed"]
        out[name] = dict(
            ms=a["ms"], plain_ms=a["plain_ms"], bound=a["bound"],
            library_ms=lib["bsa_fwd" if name == "bsa_fwd" else "bsa_bwd"],
            max_abs_err=max(err[k_][name] for k_ in err),
            rel_norm=max(rel[k_][name] for k_ in rel),
            shape=dict(B=B, H=H, T=8192, d=d, block=64, pairs=a["pairs"],
                       layout="fixed causal"),
            other={"bigbird": {k_: (v_ if k_ != "bound" else list(v_))
                               for k_, v_ in by["bigbird"].items()},
                   "masked_dense_fwd_ms_T2048": dense_ms,
                   "kernel_fwd_ms_T2048": kern_ms})
        out[name].update(mma_sync_ms=a["mma_sync_ms"])
        if name == "bsa_fwd":
            out[name].update(union_waste=waste)
        else:
            out[name].update(split_idle={k_: v_[name]
                                         for k_, v_ in idle.items()})
        b = by["bigbird"]
        designs = (f"; sm90 by the rule, mma_sync (a) {a['mma_sync_ms']:.4f}"
                   f", (b) {b['mma_sync_ms']:.4f}")
        log(f"{name}: (a) {a['ms']:.4f} ms (plain {a['plain_ms']:.4f}, "
            f"bound {a['bound'][0]:.4f} by {a['bound'][1]}); (b) "
            f"{b['ms']:.4f} ms (plain {b['plain_ms']:.4f}, bound "
            f"{b['bound'][0]:.4f} by {b['bound'][1]}); SDPA dense causal "
            f"{out[name]['library_ms']:.4f}{designs}")
    return out


# ---------------------------------------- K2-qmajor / K11 parity (phase 23)


def phase_qmajor_bsa_parity(seed=0):
    """fp32 on the card: a small GPT-2 (flash + fused CE kernels) with
    flash_bwd_qmajor on gives the knob-off loss (rtol 1e-5) and every
    gradient (relative error norm 1e-4) under save_flash and
    nothing_saveable, with the launches the knob implies; SparseSelfAttention
    at T=2048 (H=16, d=64) through the K11 kernels gives the masked-dense
    op's output and gradients (1e-4) for (a)'s and (b)'s layouts."""
    from deepspeed_tpu_torch import GPT2, GPT2Config
    from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.sparse_attention import SparseSelfAttention
    base = dict(n_layer=2, n_head=2, d_model=128, max_seq_len=256,
                vocab_size=1000, dtype="float32", loss_chunk=100,
                fused_loss=True, fused_loss_kernel=True,
                use_flash_attention=True, remat=True)
    ids = torch.from_numpy(np.random.RandomState(seed).randint(
        0, 1000, (4, 256))).cuda()
    worst = 0.0
    for policy in ("save_flash", "nothing_saveable"):
        out = {}
        for qm in (True, False):
            model = GPT2(GPT2Config(**base, remat_policy=policy,
                                    flash_bwd_qmajor=qm), device="cuda",
                         seed=seed)
            fa.reset_launch_counts()
            loss = model.loss({"input_ids": ids})
            loss.backward()
            torch.cuda.synchronize()
            L = base["n_layer"]
            assert fa.LAUNCHES["flash_bwd_qmajor"] == (L if qm else 0), \
                (policy, qm, fa.LAUNCHES)
            assert fa.LAUNCHES["flash_bwd"] == (0 if qm else L), \
                (policy, qm, fa.LAUNCHES)
            out[qm] = (loss.item(), {n: p.grad for n, p in
                                     model.named_parameters()})
        (l_on, g_on), (l_off, g_off) = out[True], out[False]
        assert abs(l_on - l_off) <= 1e-5 * abs(l_off), (policy, l_on, l_off)
        for n, gr in g_off.items():
            r = (torch.linalg.vector_norm(g_on[n] - gr)
                 / torch.linalg.vector_norm(gr)).item()
            assert r <= 1e-4, (policy, n, r)
            worst = max(worst, r)
    log(f"qmajor parity ok: flash_bwd_qmajor on vs off (save_flash, "
        f"nothing_saveable), loss {l_on:.7f} vs {l_off:.7f}, worst gradient "
        f"relative error norm {worst:.3g}")

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    for kind in ("fixed", "bigbird"):
        cfg, causal, _ = bsa_config(kind)
        q, k, v = ((torch.randn((2, 2048, 16, 64), generator=g,
                                device="cuda") * 0.5).requires_grad_()
                   for _ in range(3))
        w = torch.randn((2, 2048, 16, 64), generator=g, device="cuda")
        res = {}
        for use_kernel in (True, False):
            bsa.reset_launch_counts()
            op = SparseSelfAttention(cfg, causal=causal,
                                     use_kernel=use_kernel)
            o = op(q, k, v)
            grads = torch.autograd.grad((o * w).sum(), (q, k, v))
            torch.cuda.synchronize()
            n = 1 if use_kernel else 0
            assert bsa.LAUNCHES == {"bsa_fwd": n, "bsa_dq": n,
                                    "bsa_dkv": n}, bsa.LAUNCHES
            res[use_kernel] = (o.detach(),) + grads
        for name, a, b in zip(("o", "dq", "dk", "dv"), res[True],
                              res[False]):
            torch.testing.assert_close(a, b, **FP32_TOL, msg=f"{kind} {name}")
    log("K11 parity ok: SparseSelfAttention kernel == masked-dense op at "
        "T=2048, fp32, (a) and (b) layouts, output and gradients at 1e-4")


# -------------------------------- qmajor GPT-2 / K11 slices (phase 24)


def phase_qmajor_slice(seed=0, steps=10, profile=None):
    """Phase 7's GPT-2 350M bench configuration with flash_bwd_qmajor=True:
    10 train_batch steps, the loss falling, exactly 24 flash forwards, 24
    query-major backwards, 0 k-major and 2 fused CE a step; its step time
    beside phase 7's from this run."""
    launches = phase_train_slice(seed=seed, steps=steps, profile=profile,
                                 tag="qmajor train slice",
                                 knobs=dict(flash_bwd_qmajor=True))
    off, on = TRAIN_STATS["train slice"], TRAIN_STATS["qmajor train slice"]
    keys = ("step_s_median_after_first", "tokens_per_s",
            "model_tflops_per_s", "max_memory_allocated_gb")
    log("gpt2-350M qmajor train slice vs phase 7 (k-major), this run: "
        + ", ".join(f"{k} {on[k]:.4f} vs {off[k]:.4f}" for k in keys))
    return launches


BSA_STATS = {}


def phase_bsa_slice(kind, seed=0, calls=10):
    """SparseSelfAttention over GPT-2 350M's attention widths (B=4, T=8192,
    H=16, d=64, bf16) with (a)'s or (b)'s layout: ``calls`` forward +
    backward calls through the op (its lists uploaded once beforehand, as
    set-up); no host sync inside a call (torch.cuda.set_sync_debug_mode
    "error"); exactly one launch of each K11 kernel a call; the output
    finite and equal to the plain forward's within the bf16 check; ms a
    call (host clock around a synchronised call, median after the first)
    and peak memory."""
    from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.sparse_attention import SparseSelfAttention
    cfg, causal, T = bsa_config(kind)
    B, H, d = 4, 16, 64
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q, k, v, do = (torch.randn((B, T, H, d), generator=g,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    op = SparseSelfAttention(cfg, causal=causal)
    lists = op.lists(T, "cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in (bsa, fa):
        mod.reset_launch_counts()
    times = []
    for _ in range(calls):
        t1 = time.perf_counter()
        # a call makes no host sync: any synchronising operation raises
        torch.cuda.set_sync_debug_mode("error")
        try:
            o = op(q, k, v)
            grads = torch.autograd.grad(o, (q, k, v), do)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    launches = {**bsa.LAUNCHES, **fa.LAUNCHES}
    want = {"bsa_fwd": calls, "bsa_dq": calls, "bsa_dkv": calls,
            "flash_fwd": 0, "flash_bwd": 0, "flash_bwd_qmajor": 0,
            "flash_block_fwd": 0}
    assert launches == want, (launches, want)
    # every bf16 block-64 forward, dq and dk/dv on sm90
    by_design = {name: dict(by) for name, by in bsa.DESIGN_LAUNCHES.items()}
    for name, by in by_design.items():
        assert by == {"sm90": calls, "mma_sync": 0, "fp32": 0}, (name, by)
        count_designs(name, by)
    peak = torch.cuda.max_memory_allocated() / 1e9
    assert o.shape == q.shape and all(torch.isfinite(x).all()
                                      for x in (o,) + grads)

    def fold(x):
        return x.detach().transpose(1, 2).reshape(B * H, T, d).float()

    ro, _ = bsa.bsa_forward_reference(fold(q) * 0.125, fold(k), fold(v),
                                      lists, cfg.block, causal)
    why = bf16_mismatch(fold(o).to(torch.bfloat16), ro)
    assert why is None, f"{kind} slice output: {why}"
    stats = dict(calls=calls, call_s=times,
                 call_ms_median_after_first=float(np.median(times[1:])) * 1e3,
                 density=op.density(T), launches=launches,
                 bsa_designs=by_design,
                 max_memory_allocated_gb=peak)
    BSA_STATS[kind] = stats
    log(f"SparseSelfAttention {kind} slice " + json.dumps(stats))
    del o, grads, q, k, v, do, ro
    torch.cuda.empty_cache()
    return {k_: v_ for k_, v_ in launches.items() if k_.startswith("bsa")}


# ------------------------------------------------- K10 ring step (phase 25)


def ring_block_bound(BH, C, d, causal):
    """(bytes, flops) of one K10 pair: q, k, v bf16 read once, the fp32
    state (m, l, acc) read and written once; QK^T and PV over the pair's
    live (q, k) entries."""
    nbytes = 3 * BH * C * d * 2 + 2 * (2 * BH * C * 4 + BH * C * d * 4)
    pairs = BH * (_causal_pairs(C) if causal else C * C)
    return nbytes, 4 * d * pairs


def dense_plain_in_chunks(fa, q, k, v, heads=8):
    """The dense plain forward in fp32 over (BH, T, d) folded operands,
    ``heads`` rows of BH at a time (the (T, T) scores of all 64 would not
    fit)."""
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for i in range(0, q.shape[0], heads):
        sl = slice(i, i + heads)
        out[sl] = fa.flash_forward_reference(
            q[sl][None].float(), k[sl][None].float(),
            v[sl][None].float())[0][0]
    return out


def block_fwd_as(fa, design):
    """flash_block_fwd through ``design`` whatever _block_design says (the
    other design timed beside the picked one)."""
    def run(q, k, v, st, causal=False):
        orig = fa._block_design
        fa._block_design = lambda *_: design
        try:
            return fa.flash_block_fwd(q, k, v, st, causal=causal)
        finally:
            fa._block_design = orig
    return run


def phase_ring_kernel(fa, seed=0):
    """K10 (``flash_block_fwd``): chained fp32 cases at FP32_TOL; bf16 at
    the slice's step-0 shape (B*H, C, d) = (64, 2048, 64) in both modes from
    a carried state, against its plain version in fp32 on the same inputs
    (the finalized o by bf16_mismatch, lse at 1e-4); a control (the carry's
    m perturbed) that must fail; the zigzag schedule of R = 4 emulated in
    this process with the ring's step functions on one global (B=4, T=8192,
    H=16, d=64) problem, against K1 on the whole sequence and the dense
    plain version; ``flash_block_bwd`` (K2 from the global o / lse) against
    the plain backward; timed beside its bound, plain version and SDPA's
    forward on the same full pair."""
    from deepspeed_tpu_torch.sequence import ring as ring_mod
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    bf, f32 = torch.bfloat16, torch.float32

    def randn(shape, dtype=bf, s=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * s).to(dtype)

    def state(st):
        return tuple(x.clone() for x in st)

    # ---- fp32: two chained pairs (diagonal-causal, then full)
    for (BH, C, d) in ((4, 200, 64), (3, 130, 32), (2, 64, 128)):
        q = randn((BH, C, d), f32, 0.3)
        st = fa.flash_block_state(BH, C, d, device="cuda")
        ref = state(st)
        for causal in (True, False):
            k, v = randn((BH, C, d), f32), randn((BH, C, d), f32)
            fa.flash_block_fwd(q, k, v, st, causal=causal)
            ref = fa.flash_block_fwd_reference(q, k, v, ref, causal=causal)
            for a, b in zip(st, ref):
                torch.testing.assert_close(a, b, **FP32_TOL)
    log("K10: fp32 cases ok (chained causal + full pairs, ragged C, "
        "d = 32 / 64 / 128)")

    # ---- bf16 on the sm90 design: chained pairs on views of one state
    # (the zigzag's late half), ragged C, d = 64 / 128, repeated bitwise
    for (BH, C, d) in ((8, 1000, 64), (4, 777, 128), (16, 2048, 128)):
        q = fa.scale_q(randn((BH, C, d)), d ** -0.5)
        kv = [(randn((BH, C, d)), randn((BH, C, d)), causal)
              for causal in (True, False, False)]
        fa.reset_launch_counts()
        runs = []
        for _ in range(2):
            big = fa.flash_block_state(BH, 2 * C, d, device="cuda")
            st = tuple(x[:, C:] for x in big)
            for k, v, causal in kv:
                fa.flash_block_fwd(q, k, v, st, causal=causal)
            runs.append(big)
        torch.cuda.synchronize()
        assert fa.DESIGN_LAUNCHES["flash_block_fwd"]["sm90"] == 6, \
            fa.DESIGN_LAUNCHES
        assert all(torch.equal(a, b) for a, b in zip(*runs)), \
            f"K10 sm90 ({BH}, {C}, {d}): a repeat differs"
        assert torch.equal(runs[0][1][:, :C], torch.zeros_like(
            runs[0][1][:, :C])), "K10 wrote outside its state view"
        ref = fa.flash_block_state(BH, C, d, device="cuda")
        for k, v, causal in kv:
            ref = fa.flash_block_fwd_reference(q.float(), k.float(),
                                               v.float(), ref, causal=causal)
        o, lse = fa.flash_block_finalize(tuple(x[:, C:] for x in runs[0]))
        ro, rlse = fa.flash_block_finalize(ref)
        why = bf16_mismatch(o.to(bf), ro)
        assert why is None, f"K10 sm90 ({BH}, {C}, {d}) chained: {why}"
        torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
    log("K10 sm90: three chained pairs (causal, full, full) on the late "
        "half of one state at (B*H, C, d) = (8, 1000, 64), (4, 777, 128), "
        "(16, 2048, 128): within the bf16 limits, lse at 1e-4, repeated "
        "bitwise, the early half untouched")

    # ---- bf16 at the step-0 shape, both modes, from a carried state
    BH, C, d = 64, 2048, 64
    q = fa.scale_q(randn((BH, C, d)), d ** -0.5)
    k0, v0, k, v = (randn((BH, C, d)) for _ in range(4))
    carry = fa.flash_block_fwd_reference(
        q.float(), k0.float(), v0.float(),
        fa.flash_block_state(BH, C, d, device="cuda"), causal=False)
    err = 0.0
    fa.reset_launch_counts()
    for causal in (True, False):
        st = fa.flash_block_fwd(q, k, v, state(carry), causal=causal)
        st2 = fa.flash_block_fwd(q, k, v, state(carry), causal=causal)
        assert all(torch.equal(a, b) for a, b in zip(st, st2)), \
            f"flash_block_fwd causal={causal}: a repeat differs"
        ref = fa.flash_block_fwd_reference(q.float(), k.float(), v.float(),
                                           carry, causal=causal)
        o, lse = fa.flash_block_finalize(st)
        ro, rlse = fa.flash_block_finalize(ref)
        why = bf16_mismatch(o.to(bf), ro)
        assert why is None, f"flash_block_fwd causal={causal}: {why}"
        torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
        err = max(err, (o - ro).abs().max().item())
    bad = state(carry)
    bad[0][:, :64] += 2.0                    # one query tile's running max
    co, _ = fa.flash_block_finalize(fa.flash_block_fwd_reference(
        q.float(), k.float(), v.float(), bad, causal=False))
    why = bf16_mismatch(co.to(bf), ro)
    assert why is not None, "K10 check let a perturbed carry m pass"
    log(f"control: K10 with the carry's m of query tile 0 raised by 2 "
        f"fails ({why})")
    designs = dict(fa.DESIGN_LAUNCHES["flash_block_fwd"])
    assert designs["sm90"] == 4, designs
    log(f"K10 bf16 at (B*H, C, d) = ({BH}, {C}, {d}), causal and full from "
        f"a carried state on {designs}: max |err| of the finalized o "
        f"{err:.3g}, repeated bitwise")

    # ---- the zigzag schedule of R = 4 on one (4, 8192, 16, 64) problem
    B, T, H, R = 4, 8192, 16, 4
    Cz = T // (2 * R)
    qg = fa.scale_q(randn((B * H, T, d)), d ** -0.5)
    kg, vg = randn((B * H, T, d)), randn((B * H, T, d))

    def local(x, r):                          # zigzag chunks r, 2R-1-r
        return torch.cat([x[:, r * Cz:(r + 1) * Cz],
                          x[:, (2 * R - 1 - r) * Cz:(2 * R - r) * Cz]], 1)

    before = fa.LAUNCHES["flash_block_fwd"]
    o_ring = torch.empty(B * H, T, d, dtype=f32, device="cuda")
    for r in range(R):
        qf = local(qg, r)
        st = fa.flash_block_state(B * H, 2 * Cz, d, device="cuda")
        st = ring_mod._step_kernel(qf, local(kg, r), local(vg, r), st, True)
        for s in range(1, R):
            src = (r - s) % R
            kvb = torch.stack([local(kg, src), local(vg, src)])
            st = ring_mod._zig_step(st, kvb, s, qf=qf, r=r, C=Cz,
                                    step=ring_mod._step_kernel)
        o_r, _ = fa.flash_block_finalize(st)
        o_ring[:, r * Cz:(r + 1) * Cz] = o_r[:, :Cz]
        o_ring[:, (2 * R - 1 - r) * Cz:(2 * R - r) * Cz] = o_r[:, Cz:]
    pairs = fa.LAUNCHES["flash_block_fwd"] - before
    assert pairs == R * (1 + 2 * (R - 1)), pairs
    assert fa.DESIGN_LAUNCHES["flash_block_fwd"]["sm90"] == \
        fa.LAUNCHES["flash_block_fwd"], fa.DESIGN_LAUNCHES
    k1, _ = fa.flash_forward(qg[None], kg[None], vg[None])
    dense = dense_plain_in_chunks(fa, qg, kg, vg)
    for name, out in (("zigzag ring", o_ring.to(bf)), ("K1", k1[0])):
        why = bf16_mismatch(out, dense)
        assert why is None, f"{name} vs the dense plain version: {why}"
    why = bf16_mismatch(o_ring.to(bf), k1[0].float())
    assert why is None, f"zigzag ring vs K1: {why}"
    zig_err = (o_ring - dense).abs().max().item()
    log(f"zigzag R={R} emulated on (B, T, H, d) = ({B}, {T}, {H}, {d}): "
        f"{pairs} K10 pairs ({R} causal + {2 * R * (R - 1)} full), equal "
        f"to K1 on the whole sequence and to the dense plain version "
        f"(max |err| {zig_err:.3g})")
    del qg, kg, vg, o_ring, k1, dense

    # ---- flash_block_bwd: K2 from the global o / lse, both modes, on
    # its sm90 design
    do = randn((BH, C, d))
    gerr = 0.0
    fa.reset_launch_counts()
    for causal in (True, False):
        o, lse = fa.flash_block_finalize(fa.flash_block_fwd(
            q, k, v, state(carry), causal=causal))
        o = o.to(bf)
        got = fa.flash_block_bwd(q, k, v, o, lse, do, causal=causal)
        refs = fa.flash_backward_reference(
            *(x.float()[None] for x in (q, k, v, o)), lse[None],
            do.float()[None], causal=causal)
        for name, a, b in zip(("dq", "dk", "dv"), got, refs):
            why = bf16_grad_mismatch(a[None], b)
            assert why is None, f"flash_block_bwd causal={causal} {name}: " \
                f"{why}"
            gerr = max(gerr, grad_rel_norm(a[None], b))
    assert fa.DESIGN_LAUNCHES["flash_bwd"] == {
        "sm90": 2, "mma_sync": 0, "fp32": 0}, fa.DESIGN_LAUNCHES
    log(f"flash_block_bwd (K2 from the global o / lse) ok on sm90, causal "
        f"and full at (B*H, C, d) = ({BH}, {C}, {d}): worst slab relative "
        f"error norm {gerr:.3g}")

    # ---- timing: the full and the causal pair at the step-0 shape, each
    # beside the mma_sync design and SDPA's forward on the same pair
    st = state(carry)
    nbytes, flops = ring_block_bound(BH, C, d, causal=False)
    mma_sync = block_fwd_as(fa, "mma_sync")
    row = dict(
        ms=time_ms(lambda: fa.flash_block_fwd(q, k, v, st), 20),
        mma_sync_ms=time_ms(lambda: mma_sync(q, k, v, st), 20),
        causal_ms=time_ms(lambda: fa.flash_block_fwd(q, k, v, st,
                                                     causal=True), 20),
        causal_mma_sync_ms=time_ms(lambda: mma_sync(q, k, v, st, True), 20),
        plain_ms=time_ms(lambda: fa.flash_block_fwd_reference(q, k, v, st),
                         3),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], scale=1.0), 20),
        causal_library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], scale=1.0, is_causal=True), 20),
        bound=bound(nbytes, flops),
        causal_bound_ms=bound(*ring_block_bound(BH, C, d, causal=True))[0],
        max_abs_err=err, shape=[BH, C, d])
    log(f"flash_block_fwd full pair (B*H, C, d) = ({BH}, {C}, {d}) bf16: "
        f"{row['ms']:.4f} ms on sm90 (mma_sync {row['mma_sync_ms']:.4f}; "
        f"plain {row['plain_ms']:.4f}, SDPA forward {row['library_ms']:.4f}, "
        f"bound {row['bound'][0]:.4f} by {row['bound'][1]}: {nbytes} bytes "
        f"/ {flops} flops); causal pair {row['causal_ms']:.4f} (mma_sync "
        f"{row['causal_mma_sync_ms']:.4f}, SDPA causal forward "
        f"{row['causal_library_ms']:.4f}, bound "
        f"{row['causal_bound_ms']:.4f})")
    del q, k, v, k0, v0, do, carry, st
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------- K12 kernels (phase 26)


def phase_quant_kernels(qz, seed=0):
    """K12 on a buffer of one GPT-2 350M model's gradients (its parameter
    count, ragged against the 2048 block) in fp32 and in bf16: codes and
    scales bitwise equal to the plain version, dequantize (to fp32 and to
    the input type) bitwise, the reduce-scatter's summing dequantize over
    two rows bitwise; a control (scales from IEEE division by 127, the
    eager jnp form the compiled JAX programs do not use) that the bitwise
    check must catch; each timed beside its bound, plain version and the
    shortest torch expression of the same math (no single PyTorch call
    quantizes blockwise)."""
    from deepspeed_tpu_torch import GPT2_PRESETS
    n = GPT2_PRESETS["350M"].num_params()
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.randn(n, generator=g, device="cuda") * 1e-3
    block = qz.QUANT_BLOCK
    for dtype in (torch.float32, torch.bfloat16):
        xs = x.to(dtype)
        q, s, meta = qz.quantize_blockwise(xs)
        rq, rs = qz.quantize_rows_reference(xs.view(1, n), block)
        assert torch.equal(q, rq) and torch.equal(s, rs), \
            f"quantize_blockwise {dtype}: codes or scales differ"
        for out in (torch.float32, dtype):
            d = qz.dequantize_rows(q, s, 1, n, out)
            assert torch.equal(d, qz.dequantize_rows_reference(
                q, s, 1, n, out)), f"dequantize_blockwise {dtype} -> {out}"
        del rq, rs, d
        if dtype == torch.float32:
            absmax = xs[:n // block * block].view(-1, block).abs().amax(
                -1, keepdim=True)
            # a tensor divisor: PyTorch turns division by a scalar on the
            # card into a product with its reciprocal
            div = torch.where(absmax > 0,
                              absmax / torch.full_like(absmax, 127.0), 1.0)
            flips = int((div != s[:div.shape[0]]).sum())
            assert flips > 0, "bitwise check let a division scale pass"
            log(f"control: scales from IEEE division by 127 differ from "
                f"the kernel's in {flips} of {div.shape[0]} blocks")
            del absmax, div
    half = n // 2
    q2, s2 = qz.quantize_rows(x[:2 * half].view(2, half), block)
    assert torch.equal(
        qz.dequantize_rows(q2, s2, 2, half, torch.float32, sum_rows=True),
        qz.dequantize_rows_reference(q2, s2, 2, half, torch.float32,
                                     sum_rows=True)), "summing dequantize"
    del q2, s2
    log(f"K12 bitwise at {n} elements (fp32 and bf16): codes, scales, "
        f"dequantize to fp32 and to the input type, the summing dequantize "
        f"of two rows")

    q, s, meta = qz.quantize_blockwise(x)
    nb = q.shape[0]
    xa = x[:n // block * block].view(-1, block)

    def torch_quant():
        sc = xa.abs().amax(-1, keepdim=True) / 127
        return torch.clamp(torch.round(xa / sc), -127, 127).to(torch.int8)

    rows = {
        "quantize_blockwise": dict(
            ms=time_ms(lambda: qz.quantize_rows(x.view(1, n)), 20),
            plain_ms=time_ms(lambda: qz.quantize_rows_reference(
                x.view(1, n), block), 3),
            library_ms=time_ms(torch_quant, 5),
            library="amax + divide + round + clamp on the block-aligned "
                    "prefix",
            bound=bound(n * 4 + n + nb * 4, 4 * n), max_abs_err=0.0),
        "dequantize_blockwise": dict(
            ms=time_ms(lambda: qz.dequantize_rows(q, s, 1, n,
                                                  torch.float32), 20),
            plain_ms=time_ms(lambda: qz.dequantize_rows_reference(
                q, s, 1, n, torch.float32), 3),
            library_ms=time_ms(lambda: q.float() * s, 5),
            library="q.float() * s",
            bound=bound(n + nb * 4 + n * 4, n), max_abs_err=0.0)}
    for name, r in rows.items():
        r["shape"] = [n]
        log(f"{name} ({n} fp32 elements): {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f}, torch expression {r['library_ms']:.4f}, "
            f"bound {r['bound'][0]:.4f} by {r['bound'][1]})")
    del x, q, s, xa
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------- NCCL world of one (phase 27)


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def plain_qdq(qz, x, block=2048):
    """The plain quantize -> dequantize of one flat tensor."""
    q, s = qz.quantize_rows_reference(x.reshape(1, -1), block)
    return qz.dequantize_rows_reference(q, s, 1, x.numel(),
                                        x.dtype).view_as(x)


def phase_nccl_world(fa, qz, seed=0):
    """One process, NCCL, world size 1, cuda:0: every comm op gives its
    one-rank result; the four quantized collectives launch K12 and equal
    their plain versions bitwise (the path's launches are returned);
    ring_attention at R = 1 launches K10 once a call (causal) and equals
    the flash forward's plain version; initialize with
    sequence_parallel_size=1 and attention_backend="ring" takes K1 and
    launches no K10, as JAX."""
    import dataclasses
    from deepspeed_tpu_torch import GPT2, GPT2_PRESETS, comm, initialize
    from deepspeed_tpu_torch.sequence import ring_attention
    from deepspeed_tpu_torch.utils import groups
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    comm.init_distributed(device="cuda:0", verbose=False)
    assert comm.get_backend() == "nccl", comm.get_backend()
    groups.reset()
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.randn(4, 6, generator=g, device="cuda")
    outs = [comm.all_reduce(x, "data", op=op)
            for op in ("sum", "avg", "max", "min")]
    outs += [comm.reduce_scatter(x, "seq"), comm.all_gather(x, "data", 1),
             comm.all_to_all(x, "seq", 0, 1), comm.broadcast(x, "seq"),
             comm.ppermute(x, "seq", [(0, 0)]), comm.send_forward(x, "seq"),
             comm.send_backward(x, groups.GRAD_REDUCE_AXES)]
    assert all(torch.equal(o, x) for o in outs)
    assert comm.axis_index("seq") == 0 and comm.get_world_size() == 1
    assert comm.ring_exchange_bytes(b"x") == (None, None)
    assert comm.allgather_bytes(b"x") is None
    comm.barrier()
    log("NCCL world of 1 on cuda:0: all_reduce (sum/avg/max/min), "
        "reduce_scatter, all_gather, all_to_all, broadcast, ppermute, "
        "send_forward/backward, axis_index, the byte transports and barrier "
        "give the one-rank results")

    xq = torch.randn(4_000_000, generator=g, device="cuda")
    qz.reset_launch_counts()
    got = {"all_gather": comm.quantized_all_gather(xq, "data"),
           "reduce_scatter": comm.quantized_reduce_scatter(xq, "data"),
           "clamp": comm.dcn_precision_clamp(xq),
           "hierarchical": comm.all_to_all_quant_reduce(xq)}
    torch.cuda.synchronize()
    launches = dict(qz.LAUNCHES)
    once = plain_qdq(qz, xq)
    want = {"all_gather": once[None], "reduce_scatter": once,
            "clamp": once, "hierarchical": plain_qdq(qz, once)}
    for name, w in want.items():
        assert torch.equal(got[name], w), f"quantized {name} at world 1"
    assert launches == {"quantize_blockwise": 5,
                        "dequantize_blockwise": 5}, launches
    log(f"quantized collectives at world 1 equal their plain versions "
        f"bitwise; K12 launches {launches}")

    q, k, v, do = (torch.randn((4, 2048, 16, 64), generator=g,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    fa.reset_launch_counts()
    o = ring_attention(q, k, v, "seq")
    torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    ring_launches = dict(fa.LAUNCHES)
    assert ring_launches == {"flash_fwd": 0, "flash_bwd": 1,
                             "flash_bwd_qmajor": 0, "flash_block_fwd": 1}, \
        ring_launches
    for name in ("flash_block_fwd", "flash_bwd"):
        assert fa.DESIGN_LAUNCHES[name] == {
            "sm90": 1, "mma_sync": 0, "fp32": 0}, fa.DESIGN_LAUNCHES
        count_designs(name, fa.DESIGN_LAUNCHES[name])

    def heads(t):
        return fa.scale_q(t.detach().transpose(1, 2), 0.125).float()

    ref, _ = fa.flash_forward_reference(heads(q), k.detach().transpose(
        1, 2).float(), v.detach().transpose(1, 2).float())
    why = bf16_mismatch(o.detach().transpose(1, 2), ref)
    assert why is None, f"ring_attention at R=1: {why}"
    log("ring_attention at R=1 (B=4, T=2048, H=16, d=64, bf16): one K10 "
        "launch (causal, sm90) and one K2 (sm90), equal to the plain "
        "forward")
    del q, k, v, do, o, ref

    cfg = dataclasses.replace(
        GPT2_PRESETS["350M"], n_layer=2, max_seq_len=1024,
        attention_backend="ring", use_flash_attention=True, remat=True,
        remat_policy="save_flash")
    engine, *_ = initialize(
        model=GPT2(cfg, device="cuda:0", seed=seed), device="cuda:0",
        config={"train_micro_batch_size_per_gpu": 4, "steps_per_print": 0,
                "optimizer": {"type": "AdamW", "params": {"lr": 2e-4}},
                "bf16": {"enabled": True}, "zero_optimization": {"stage": 2},
                "sequence_parallel_size": 1})
    ids = np.random.RandomState(seed).randint(0, cfg.vocab_size, (4, 1024))
    fa.reset_launch_counts()
    losses = [float(engine.train_batch({"input_ids": ids}))
              for _ in range(2)]
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_block_fwd"] == 0 and \
        fa.LAUNCHES["flash_fwd"] == 2 * cfg.n_layer, fa.LAUNCHES
    assert all(math.isfinite(v) for v in losses), losses
    log(f"initialize(sequence_parallel_size=1, attention_backend='ring'): "
        f"K1 {fa.LAUNCHES['flash_fwd']} launches, K10 0 (the flash path, "
        f"as JAX at seq = 1); losses {losses}")
    del engine
    torch.distributed.destroy_process_group()
    groups.reset()
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_PORT"):
        os.environ.pop(key)
    gc.collect()
    torch.cuda.empty_cache()
    return {"comm-nccl-w1": launches, "ring-nccl-w1": ring_launches}


# ------------------------ two processes on cuda:0 over gloo (phases 28-29)


def run_children(role, world=2, timeout=900):
    """``world`` processes of ``chip_smoke.py --child ROLE`` sharing
    cuda:0 in a gloo world (NCCL refuses two ranks on one card); returns
    their JSON reports in rank order. Every child is waited for, and
    killed if the run fails."""
    import tempfile
    port = free_port()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    procs = []
    try:
        for r in range(world):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--child", role,
                 "--child-out", os.path.join(tmp, f"{r}.json")], env=env))
        deadline = time.time() + timeout
        for p in procs:
            p.wait(timeout=max(1, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    assert rcs == [0] * world, f"{role} children exited {rcs}"
    reports = []
    for r in range(world):
        with open(os.path.join(tmp, f"{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def child_world():
    """Join the two-process gloo world on cuda:0 as the caller names it."""
    from deepspeed_tpu_torch import comm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    comm.init_distributed(dist_backend="gloo", device="cuda:0",
                          verbose=False)
    return comm.get_rank(), comm.get_world_size()


def child_parity():
    """Phase 28 in one rank: GPT-2 at the 350M widths with 2 layers, fp32,
    seq = 2, ring and Ulysses: the loss and every gradient (summed over the
    two ranks) against the same model at seq = 1 on the same batch; then
    quantized_all_gather / quantized_reduce_scatter at world 2 against
    their plain versions, bitwise (both ranks' inputs are made here from
    one seed)."""
    import dataclasses
    from deepspeed_tpu_torch import GPT2, GPT2_PRESETS, comm
    from deepspeed_tpu_torch.ops.cuda import quantization as qz
    from deepspeed_tpu_torch.utils import groups
    rank, world = child_world()
    groups.initialize(groups.TopologyConfig(seq_parallel_size=world))
    cfg = dataclasses.replace(GPT2_PRESETS["350M"], n_layer=2,
                              max_seq_len=1024, dtype="float32", remat=False,
                              use_flash_attention=False)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 1024))).cuda()

    def loss_grads(model, seq_sharded):
        loss = model.loss({"input_ids": ids}, seq_sharded=seq_sharded)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        if seq_sharded:
            grads = {n: comm.all_reduce(g_, "seq") for n, g_ in grads.items()}
        return loss.item(), grads

    ref_loss, ref = loss_grads(GPT2(cfg, device="cuda:0", seed=1), False)
    out = {"rank": rank, "ref_loss": ref_loss}
    for backend in ("ring", "dense"):
        model = GPT2(dataclasses.replace(cfg, attention_backend=backend),
                     device="cuda:0", seed=1)
        loss, grads = loss_grads(model, True)
        rel = {n: (torch.linalg.vector_norm(grads[n] - ref[n])
                   / torch.linalg.vector_norm(ref[n])).item() for n in ref}
        out[backend] = {"loss": loss, "worst_grad": max(rel.items(),
                                                       key=lambda t: t[1])}
        del model, grads
    del ref
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    xs = [torch.randn(4_000_000, generator=g, device="cuda")
          for _ in range(world)]
    qz.reset_launch_counts()
    ag = comm.quantized_all_gather(xs[rank], "seq")
    rs = comm.quantized_reduce_scatter(xs[rank], "seq")
    torch.cuda.synchronize()
    out["quant_launches"] = dict(qz.LAUNCHES)
    P = xs[0].numel() // world
    pieces = [qz.quantize_rows_reference(x.view(world, P), 2048)
              for x in xs]
    nb = pieces[0][0].shape[0] // world
    mine_q = torch.cat([q[rank * nb:(rank + 1) * nb] for q, _ in pieces])
    mine_s = torch.cat([s[rank * nb:(rank + 1) * nb] for _, s in pieces])
    out["quant_equal"] = {
        "all_gather": bool(torch.equal(
            ag, torch.stack([plain_qdq(qz, x) for x in xs]))),
        "reduce_scatter": bool(torch.equal(
            rs, qz.dequantize_rows_reference(mine_q, mine_s, world, P,
                                             torch.float32, sum_rows=True)))}
    out["staged"] = {k: list(v) for k, v in
                     comm.get_comms_logger().host_staged.items()}
    return out


# a step takes ~18 s through host memory: 5 keep the whole script well
# inside its time limit
PHASE29 = dict(steps=5, micro=4, seq_len=4096, sp=2)


def child_train():
    """Phase 29 in one rank: GPT-2 350M (24 layers, T=4096, micro 4,
    attention_backend="ring", sequence_parallel_size=2, ZeRO-2, bf16)
    through initialize -> train_batch for PHASE29["steps"] steps on one
    numpy-seeded batch; reports losses, step times, this process's peak
    memory, the kernels' launches and what went through host memory."""
    import dataclasses
    from deepspeed_tpu_torch import GPT2, GPT2_PRESETS, comm, initialize
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import fused_ce as fce
    from deepspeed_tpu_torch.ops.cuda import quantization as qz
    rank, world = child_world()
    p = PHASE29
    cfg = dataclasses.replace(
        GPT2_PRESETS["350M"], max_seq_len=p["seq_len"],
        attention_backend="ring", use_flash_attention=True, remat=True,
        remat_policy="save_flash", loss_chunk=512, fused_loss=True,
        fused_loss_kernel=True)
    t0 = time.perf_counter()
    engine, *_ = initialize(
        model=GPT2(cfg, device="cuda:0", seed=0), device="cuda:0",
        config={"train_micro_batch_size_per_gpu": p["micro"],
                "gradient_accumulation_steps": 1, "steps_per_print": 0,
                "optimizer": {"type": "AdamW",
                              "params": {"lr": 2e-4, "weight_decay": 0.01}},
                "gradient_clipping": 1.0, "bf16": {"enabled": True},
                "zero_optimization": {"stage": 2},
                "sequence_parallel_size": p["sp"]})
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    batch = {"input_ids": np.random.RandomState(0).randint(
        0, cfg.vocab_size, (p["micro"], p["seq_len"])).astype(np.int32)}
    comm.get_comms_logger().reset()
    torch.cuda.reset_peak_memory_stats()
    for mod in (fa, fce, qz):
        mod.reset_launch_counts()
    losses, times = [], []
    for _ in range(p["steps"]):
        t1 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    return {"rank": rank, "losses": losses, "step_s": times,
            "build_s": build_s, "params": cfg.num_params(),
            "launches": {**fa.LAUNCHES, **fce.LAUNCHES, **qz.LAUNCHES},
            "block_designs": dict(fa.DESIGN_LAUNCHES["flash_block_fwd"]),
            "bwd_designs": dict(fa.DESIGN_LAUNCHES["flash_bwd"]),
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "staged": {k: list(v) for k, v in
                       comm.get_comms_logger().host_staged.items()}}


def phase_seq_parity():
    """Phase 28: two processes on cuda:0 over gloo (child_parity)."""
    reps = run_children("parity")
    for r in reps:
        for backend in ("ring", "dense"):
            res = r[backend]
            assert abs(res["loss"] - r["ref_loss"]) <= 2e-5 * abs(
                r["ref_loss"]), (backend, res["loss"], r["ref_loss"])
            assert res["worst_grad"][1] <= 1e-4, (backend, res)
        assert all(r["quant_equal"].values()), r["quant_equal"]
    log("seq = 2 over gloo on cuda:0, GPT-2 at the 350M widths, 2 layers, "
        "fp32: " + "; ".join(
            f"{b} loss {reps[0][b]['loss']:.7f} vs seq=1 "
            f"{reps[0]['ref_loss']:.7f}, worst gradient relative error norm "
            f"{max(r[b]['worst_grad'][1] for r in reps):.3g} "
            f"({reps[0][b]['worst_grad'][0]})" for b in ("ring", "dense")))
    log("quantized_all_gather / quantized_reduce_scatter at world 2 equal "
        "their plain versions bitwise on both ranks")
    return {k: sum(r["quant_launches"][k] for r in reps)
            for k in reps[0]["quant_launches"]}


def phase_seq_slice():
    """Phase 29: GPT-2 350M at T=4096 over two processes on cuda:0
    (child_train): the loss falls and is the same on both ranks, and each
    step launches exactly 6 K10 a layer on each rank (3 pairs in the
    forward, 3 again in the remat re-run) and 3 K2 (the backward's pairs),
    no K1, K3 or K12; step time, tokens/s and each process's peak
    memory."""
    reps = run_children("train")
    p = PHASE29
    L, steps = 24, p["steps"]
    want = {"flash_fwd": 0, "flash_bwd": 3 * L * steps,
            "flash_bwd_qmajor": 0, "flash_block_fwd": 6 * L * steps,
            "fused_ce": 0, "quantize_blockwise": 0,
            "dequantize_blockwise": 0}
    for r in reps:
        assert r["launches"] == want, (r["rank"], r["launches"], want)
        # every K10 pair on the sm90 design
        assert r["block_designs"] == {"sm90": want["flash_block_fwd"],
                                      "mma_sync": 0, "fp32": 0}, \
            (r["rank"], r["block_designs"])
        count_designs("flash_block_fwd", r["block_designs"])
        # and every K2 pair (flash_block_bwd)
        assert r["bwd_designs"] == {"sm90": want["flash_bwd"],
                                    "mma_sync": 0, "fp32": 0}, \
            (r["rank"], r["bwd_designs"])
        count_designs("flash_bwd", r["bwd_designs"])
        assert all(math.isfinite(x) for x in r["losses"]), r["losses"]
        assert r["losses"][-1] < r["losses"][0], r["losses"]
    assert reps[0]["losses"] == reps[1]["losses"], \
        (reps[0]["losses"], reps[1]["losses"])
    step_s = float(np.median(reps[0]["step_s"][1:]))
    tokens = p["micro"] * p["seq_len"]
    stats = dict(
        steps=steps, losses=reps[0]["losses"],
        step_s=[max(a, b) for a, b in zip(reps[0]["step_s"],
                                          reps[1]["step_s"])],
        step_s_median_after_first=step_s, tokens_per_s=tokens / step_s,
        engine_build_s=[r["build_s"] for r in reps],
        max_memory_allocated_gb=[r["max_memory_allocated_gb"] for r in reps],
        launches_per_step_per_rank={k: v // steps for k, v in want.items()},
        k10_launches_by_design_per_rank=reps[0]["block_designs"],
        k2_launches_by_design_per_rank=reps[0]["bwd_designs"],
        params=reps[0]["params"])
    log("gpt2-350M seq-parallel slice " + json.dumps(stats))
    log(f"the ring's collectives went through host memory over gloo "
        f"because this machine has one card (NCCL refuses two ranks on "
        f"one card): per rank, {steps} steps, op -> [calls, bytes] "
        f"{reps[0]['staged']}")
    return {k: sum(r["launches"][k] for r in reps) for k in
            ("flash_block_fwd", "flash_bwd")}


# ----------------------------------------------- K13 RMSNorm (phase 30)


def phase_rmsnorm_kernel(ln, seed=0):
    """K13's RMSNorm forward (``fused_rmsnorm``): fp32 at 1e-4 on small
    shapes (D up to 4096, where the row is read again); bf16 and fp32 at
    the JAX microbenchmark's (8, 1024, 1024) and at (4, 2048, 4096)
    (Llama-2-7B's width) against the plain version (bf16: run in fp32 on
    the same inputs, bf16_mismatch); bitwise repeats; a control (one row
    normalised with the scale shifted by one column) that must fail; each
    timed (device time of calls replayed from a CUDA graph, time_graph_ms;
    the kernel also eagerly) beside its bound, the plain version,
    ``F.rms_norm`` (the one PyTorch call) and the torch expression
    ``x * rsqrt(x.float().pow(2).mean(-1) + eps) * scale``."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    bf, f32 = torch.bfloat16, torch.float32

    def randn(shape, dtype, s=1.0, shift=0.0):
        return (torch.randn(shape, generator=g, device="cuda") * s
                + shift).to(dtype)

    for N, D in ((300, 384), (1000, 1024), (77, 4096)):
        x, sc = randn((N, D), f32, 2.0, 0.5), randn((D,), f32, 0.1, 1.0)
        torch.testing.assert_close(ln.fused_rmsnorm(x, sc),
                                   ln.rmsnorm_reference(x, sc), **FP32_TOL)
    err, ctrl_log, timed = 0.0, [], {}
    for shape in ((8, 1024, 1024), (4, 2048, 4096)):
        D = shape[-1]
        for dt in (bf, f32):
            x, sc = randn(shape, dt, 2.0, 0.5), randn((D,), dt, 0.1, 1.0)
            y, again = ln.fused_rmsnorm(x, sc), ln.fused_rmsnorm(x, sc)
            torch.cuda.synchronize()
            assert torch.equal(y, again), f"rmsnorm {shape} does not repeat"
            ref = ln.rmsnorm_reference(x.float(), sc.float())
            # control: one row normalised with the scale a column off
            ctrl = y.clone().view(-1, D)
            r = ctrl.shape[0] // 2
            ctrl[r] = ln.rmsnorm_reference(x.view(-1, D)[r].float(),
                                           sc.float().roll(1)).to(dt)
            ctrl = ctrl.view(shape)
            if dt == bf:
                why = bf16_mismatch(y, ref)
                assert why is None, f"rmsnorm_fwd {shape}: {why}"
                err = max(err, bf16_errors(y, ref)[1])
                caught = bf16_mismatch(ctrl, ref)
            else:
                torch.testing.assert_close(y, ref, **FP32_TOL)
                caught = not torch.allclose(ctrl, ref, **FP32_TOL)
            assert caught, f"rmsnorm check let a shifted scale pass {shape}"
            ctrl_log.append(f"{tuple(shape)} {str(dt)[6:]}")
            # timed over 4 inputs in turn (> 50 MB together), so no call
            # finds its x in L2 left there by the call before
            eps, xs = 1e-5, [x] + [randn(shape, dt, 2.0, 0.5)
                                   for _ in range(3)]
            nxt = itertools.cycle(xs).__next__

            def expression(x_):
                return x_ * torch.rsqrt(
                    x_.float().pow(2).mean(-1, keepdim=True) + eps) * sc

            t = dict(
                ms=time_graph_ms(lambda: ln.fused_rmsnorm(nxt(), sc), 20),
                eager_ms=time_ms(lambda: ln.fused_rmsnorm(nxt(), sc), 50),
                plain_ms=time_graph_ms(
                    lambda: ln.rmsnorm_reference(nxt(), sc), 8),
                library_ms=time_graph_ms(
                    lambda: F.rms_norm(nxt(), [D], sc, eps), 20),
                expression_ms=time_graph_ms(lambda: expression(nxt()), 8),
                bound=bound(2 * x.numel() * x.element_size()
                            + D * sc.element_size(), 4 * x.numel()))
            timed[f"{tuple(shape)} {str(dt)[6:]}"] = t
            log(f"rmsnorm_fwd {tuple(shape)} {dt}: {t['ms']:.4f} ms (eager "
                f"call {t['eager_ms']:.4f}, plain {t['plain_ms']:.4f}, "
                f"F.rms_norm {t['library_ms']:.4f}, torch expression "
                f"{t['expression_ms']:.4f}, bound {t['bound'][0]:.4f} by "
                f"{t['bound'][1]})")
            del x, xs, y, again, ref, ctrl
    log(f"rmsnorm checks ok: fp32 at 1e-4 (D = 384, 1024, 4096), bf16 max "
        f"|err| {err:.3g}, bitwise repeats; control: one row with the "
        f"scale a column off fails at " + ", ".join(ctrl_log))
    main_key = "(8, 1024, 1024) bfloat16"
    row = dict(timed.pop(main_key), shape=main_key, max_abs_err=err,
               library="F.rms_norm")
    row["other"] = {k: {k2: (v2[0] if k2 == "bound" else v2)
                        for k2, v2 in v.items()} for k, v in timed.items()}
    torch.cuda.empty_cache()
    return {"rmsnorm_fwd": row}


def phase_rmsnorm_op(ln, seed=0, calls=10):
    """The op's path: ``fused_rmsnorm`` called ``calls`` times at the JAX
    microbenchmark's (8, 1024, 1024) bf16 (the public op is the entry
    point: no JAX model calls it); one launch a call; the output holds
    against the plain version."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.randn((8, 1024, 1024), generator=g, device="cuda").to(
        torch.bfloat16)
    sc = (1 + 0.1 * torch.randn((1024,), generator=g, device="cuda")).to(
        torch.bfloat16)
    ln.reset_launch_counts()
    for _ in range(calls):
        y = ln.fused_rmsnorm(x, sc)
    torch.cuda.synchronize()
    launches = dict(ln.LAUNCHES)
    assert launches == {"layernorm_fwd": 0, "layernorm_bwd": 0,
                        "rmsnorm_fwd": calls}, launches
    why = bf16_mismatch(y, ln.rmsnorm_reference(x.float(), sc.float()))
    assert why is None, f"rmsnorm op: {why}"
    log(f"fused_rmsnorm op: {calls} calls at (8, 1024, 1024) bf16, "
        f"launches {launches}")
    return {"rmsnorm_fwd": launches["rmsnorm_fwd"]}


# ------------------------- ZeRO at dp = 2 over gloo on cuda:0 (31-32)


def zero_config(stage, **over):
    """The JAX bench configuration (benchmarks/bench_engine.py:182-206)
    at ZeRO ``stage``."""
    return {"gradient_accumulation_steps": 1, "steps_per_print": 0,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 2e-4, "weight_decay": 0.01}},
            "gradient_clipping": 1.0, "bf16": {"enabled": True},
            "zero_optimization": {"stage": stage}, **over}


def child_zero_parity():
    """Phase 31 in one rank: GPT-2 at the 350M widths with 2 layers, fp32,
    3 train_batch steps (gas 2) at dp = 2 for ZeRO stages 0-3 against the
    same run at dp = 1 (a one-rank topology, no collectives) in the same
    process: every step's loss and global gradient norm, and the gathered
    fp32 master (the whole master's relative error norm, and the three
    leaves with the largest)."""
    from deepspeed_tpu_torch import GPT2, GPT2_PRESETS, comm, initialize
    from deepspeed_tpu_torch.utils import groups
    rank, world = child_world()
    cfg = dataclasses.replace(GPT2_PRESETS["350M"], n_layer=2,
                              max_seq_len=1024, dtype="float32", remat=False,
                              use_flash_attention=False)
    rs = np.random.RandomState(0)
    batches = [{"input_ids": rs.randint(0, cfg.vocab_size, (4, 1024))
                .astype(np.int32)} for _ in range(3)]

    def run(stage, topology=None):
        engine, *_ = initialize(
            model=GPT2(cfg, device="cuda:0", seed=1), device="cuda:0",
            topology=topology, config=zero_config(
                stage, train_batch_size=4, gradient_accumulation_steps=2,
                bf16={"enabled": False}))
        losses, norms = [], []
        for b in batches:
            losses.append(float(engine.train_batch(b)))
            norms.append(engine.get_global_grad_norm())
        return engine.dp, losses, norms, engine.gathered_master()

    one = groups.ParallelTopology(groups.TopologyConfig(), world_size=1,
                                  rank=0)
    _, ref_losses, ref_norms, ref = run(0, one)
    ref_sq = sum(float(r.square().sum()) for r in ref.values())
    out = {"rank": rank, "ref_losses": ref_losses, "ref_norms": ref_norms,
           "stages": {}}
    comm.get_comms_logger().reset()
    for stage in range(4):
        dp, losses, norms, master = run(stage)
        leaves = sorted(((n, rel_norm(master[n], ref[n])) for n in ref),
                        key=lambda t: -t[1])
        diff_sq = sum(float((master[n] - ref[n]).square().sum())
                      for n in ref)
        out["stages"][stage] = {"dp": dp, "losses": losses,
                                "grad_norms": norms,
                                "master_rel_norm": (diff_sq / ref_sq) ** 0.5,
                                "worst_leaves": leaves[:3]}
        del master
    out["staged"] = {k: list(v) for k, v in
                     comm.get_comms_logger().host_staged.items()}
    return out


def phase_zero_parity():
    """Phase 31: two processes on cuda:0 over gloo (child_zero_parity):
    each ZeRO stage at dp = 2 gives dp = 1's losses (2e-5 relative), global
    gradient norms (1e-5 relative: the reduced gradients, counted once)
    and master (relative error norm 1e-4), the same loss on both ranks.
    The per-leaf figures are logged, not held: Adam turns fp32 noise in a
    gradient that is zero in exact arithmetic (the key bias's: softmax
    ignores a shift common to a row's scores) into steps of up to lr, so
    a leaf holding it differs by more than its own rounding."""
    reps = run_children("zero-parity")
    for r in reps:
        for stage, res in r["stages"].items():
            assert res["dp"] == 2, res
            for got, want in zip(res["losses"], r["ref_losses"]):
                assert abs(got - want) <= 2e-5 * abs(want),                     (stage, res["losses"], r["ref_losses"])
            for got, want in zip(res["grad_norms"], r["ref_norms"]):
                assert abs(got - want) <= 1e-5 * want, \
                    (stage, res["grad_norms"], r["ref_norms"])
            assert res["master_rel_norm"] <= 1e-4, (stage, res)
    for stage in reps[0]["stages"]:
        assert reps[0]["stages"][stage]["losses"] == \
            reps[1]["stages"][stage]["losses"], stage
    log("ZeRO at dp = 2 over gloo on cuda:0, GPT-2 at the 350M widths, 2 "
        "layers, fp32, 3 steps (gas 2) against dp = 1: " + "; ".join(
            f"stage {st} losses {res['losses']} (dp = 1 "
            f"{reps[0]['ref_losses']}), grad norms {res['grad_norms']} "
            f"(dp = 1 {reps[0]['ref_norms']}), master relative error norm "
            f"{max(r['stages'][st]['master_rel_norm'] for r in reps):.3g}, "
            f"largest leaves {res['worst_leaves']}"
            for st, res in reps[0]["stages"].items()))
    log(f"phase 31 host-staged per rank, stages 0-3, op -> [calls, bytes] "
        f"{reps[0]['staged']}")


PHASE32 = dict(micro=24, seq_len=1024, steps={2: 10, 3: 3})


def master_crc(master):
    """CRC32 of a whole fp32 master's bytes, leaf by leaf in the engine's
    (JAX tree) order."""
    import zlib
    crc = 0
    for m in master.values():
        crc = zlib.crc32(m.detach().cpu().numpy().tobytes(), crc)
    return crc & 0xFFFFFFFF


CKPT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "chip_smoke_ckpt")


def child_zero_train():
    """Phase 32 in one rank: GPT-2 350M (all 24 layers, the JAX bench
    configuration: bf16 + fp32 master, AdamW, clip 1.0, save_flash, fused
    CE kernel, micro 24, T=1024) at dp = 2 through initialize ->
    train_batch, ZeRO-2 for 10 steps and ZeRO-3 for 3, each on one
    numpy-seeded global batch; reports per stage the losses, step times,
    this process's peak memory after the engine's build, the kernels'
    launches and what went through host memory. After ZeRO-3's steps it
    saves one tag (this rank's shard file) under CKPT_ROOT/dp2 and reports
    the CRC of the gathered master it holds."""
    from deepspeed_tpu_torch import GPT2, GPT2_PRESETS, comm, initialize
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import fused_ce as fce
    from deepspeed_tpu_torch.ops.cuda import quantization as qz
    rank, world = child_world()
    p = PHASE32
    cfg = dataclasses.replace(
        GPT2_PRESETS["350M"], max_seq_len=p["seq_len"],
        use_flash_attention=True, remat=True, remat_policy="save_flash",
        loss_chunk=512, fused_loss=True, fused_loss_kernel=True)
    batch = {"input_ids": np.random.RandomState(0).randint(
        0, cfg.vocab_size, (world * p["micro"], p["seq_len"])).astype(
            np.int32)}
    out = {"rank": rank, "params": cfg.num_params()}
    for stage, steps in p["steps"].items():
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        engine, *_ = initialize(
            model=GPT2(cfg, device="cuda:0", seed=0), device="cuda:0",
            config=zero_config(
                stage, train_micro_batch_size_per_gpu=p["micro"]))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        comm.get_comms_logger().reset()
        torch.cuda.reset_peak_memory_stats()
        for mod in (fa, fce, qz):
            mod.reset_launch_counts()
        losses, times = [], []
        for _ in range(steps):
            t1 = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        out[f"zero{stage}"] = {
            "dp": engine.dp, "losses": losses, "step_s": times,
            "build_s": build_s,
            "launches": {**fa.LAUNCHES, **fce.LAUNCHES, **qz.LAUNCHES},
            "designs": dict(fce.DESIGN_LAUNCHES["fused_ce"]),
            "flash_designs": dict(fa.DESIGN_LAUNCHES["flash_fwd"]),
            "bwd_designs": dict(fa.DESIGN_LAUNCHES["flash_bwd"]),
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
            "staged": {k: list(v) for k, v in
                       comm.get_comms_logger().host_staged.items()}}
        if stage == 3:
            crc = master_crc(engine.gathered_master())
            t1 = time.perf_counter()
            tag = engine.save_checkpoint(os.path.join(CKPT_ROOT, "dp2"))
            out["ckpt"] = {"tag": tag, "master_crc": crc,
                           "save_s": time.perf_counter() - t1,
                           "global_step": engine.global_step,
                           "counters": engine.checkpoint_engine.counters}
        del engine
    return out


def phase_zero_slice():
    """Phase 32: GPT-2 350M at dp = 2 over two processes on cuda:0
    (child_zero_train): for ZeRO-2 and ZeRO-3, the loss falls and is the
    same on both ranks, and each step launches exactly 24 K1, 24 K2 and 2
    K3 on each rank (no K2-qmajor, K10 or K12); step time, tokens/s, each
    process's peak memory and the bytes each rank staged through host
    memory a step. Then the children's ZeRO-3 tag resumed at dp = 1
    (resume_dp2_at_dp1)."""
    import shutil
    shutil.rmtree(os.path.join(CKPT_ROOT, "dp2"), ignore_errors=True)
    reps = run_children("zero-train")
    p = PHASE32
    L, total = 24, {}
    for stage, steps in p["steps"].items():
        key = f"zero{stage}"
        want = {"flash_fwd": L * steps, "flash_bwd": L * steps,
                "flash_bwd_qmajor": 0, "flash_block_fwd": 0,
                "fused_ce": 2 * steps, "quantize_blockwise": 0,
                "dequantize_blockwise": 0}
        for r in reps:
            res = r[key]
            assert res["dp"] == 2, res["dp"]
            assert res["launches"] == want, (r["rank"], key,
                                             res["launches"], want)
            assert res["designs"] == {"sm90": 2 * steps, "fp32": 0}, \
                (r["rank"], key, res["designs"])
            assert res["flash_designs"] == {"sm90": L * steps,
                                            "mma_sync": 0, "fp32": 0}, \
                (r["rank"], key, res["flash_designs"])
            assert res["bwd_designs"] == {"sm90": L * steps,
                                          "mma_sync": 0, "fp32": 0}, \
                (r["rank"], key, res["bwd_designs"])
            count_designs("fused_ce", res["designs"])
            count_designs("flash_fwd", res["flash_designs"])
            count_designs("flash_bwd", res["bwd_designs"])
            assert all(math.isfinite(x) for x in res["losses"]), res
            assert res["losses"][-1] < res["losses"][0], res["losses"]
        assert reps[0][key]["losses"] == reps[1][key]["losses"], \
            (key, reps[0][key]["losses"], reps[1][key]["losses"])
        for k, v in want.items():
            total[k] = total.get(k, 0) + 2 * v
        times = [max(a, b) for a, b in zip(reps[0][key]["step_s"],
                                           reps[1][key]["step_s"])]
        step_s = float(np.median(times[1:]))
        tokens = 2 * p["micro"] * p["seq_len"]
        staged = reps[0][key]["staged"]
        stats = dict(
            stage=stage, steps=steps, losses=reps[0][key]["losses"],
            step_s=times, step_s_median_after_first=step_s,
            tokens_per_s=tokens / step_s,
            engine_build_s=[r[key]["build_s"] for r in reps],
            max_memory_allocated_gb=[r[key]["max_memory_allocated_gb"]
                                     for r in reps],
            host_staged_gb_per_rank_step=sum(
                b for _, b in staged.values()) / steps / 1e9,
            launches_per_step_per_rank={k: v // steps
                                        for k, v in want.items()},
            params=reps[0]["params"])
        ZERO_STATS[key] = stats
        log(f"gpt2-350M dp = 2 ZeRO-{stage} slice " + json.dumps(stats))
        log(f"ZeRO-{stage}: per rank, {steps} steps, op -> [calls, bytes] "
            f"through host memory over gloo (one card: NCCL refuses two "
            f"ranks on it) {staged}")
    resume_dp2_at_dp1(reps)
    return {k: v for k, v in total.items() if v}


def resume_dp2_at_dp1(reps, seed=0):
    """Phase 32's checkpoint: the two children's ZeRO-3 tag (two shard
    files) loaded by this process at dp = 1 under ZeRO-2 with micro 24:
    reshape keeps the global batch of 48 (gas 1 -> 2) and folds the RNG
    words; the loaded master is the children's gathered master bitwise
    (their CRC); one step on a 48-row batch gives a finite loss."""
    import shutil
    from deepspeed_tpu_torch import GPT2, GPT2_PRESETS, initialize
    ck = [r["ckpt"] for r in reps]
    assert ck[0]["tag"] == ck[1]["tag"] == "global_step3", ck
    assert ck[0]["master_crc"] == ck[1]["master_crc"], ck
    assert all(c["counters"]["fallbacks"] == 0 for c in ck), ck
    d = os.path.join(CKPT_ROOT, "dp2")
    files = sorted(os.listdir(os.path.join(d, ck[0]["tag"])))
    assert files == ["shard-0.npz", "shard-1.npz"], files
    nbytes = sum(os.path.getsize(os.path.join(d, ck[0]["tag"], f))
                 for f in files)
    cfg = dataclasses.replace(
        GPT2_PRESETS["350M"], max_seq_len=PHASE32["seq_len"],
        use_flash_attention=True, remat=True, remat_policy="save_flash",
        loss_chunk=512, fused_loss=True, fused_loss_kernel=True)
    gc.collect()
    torch.cuda.empty_cache()
    engine, *_ = initialize(
        model=GPT2(cfg, device="cuda", seed=seed + 7),
        config=zero_config(2, train_micro_batch_size_per_gpu=PHASE32[
            "micro"]))
    assert engine.config.gradient_accumulation_steps == 1
    t0 = time.perf_counter()
    path, _ = engine.load_checkpoint(d)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    assert path.endswith(ck[0]["tag"]), path
    assert engine.dp == 1 and engine.global_step == 3, engine.global_step
    assert engine.config.gradient_accumulation_steps == 2
    assert engine.config.train_batch_size == 2 * PHASE32["micro"]
    assert engine.micro_steps == 6, engine.micro_steps
    crc = master_crc(engine.state["master"])
    assert crc == ck[0]["master_crc"], (crc, ck[0]["master_crc"])
    batch = {"input_ids": np.random.RandomState(seed + 3).randint(
        0, cfg.vocab_size, (2 * PHASE32["micro"], PHASE32["seq_len"]))
        .astype(np.int32)}
    loss = float(engine.train_batch(batch))
    assert math.isfinite(loss), loss
    assert engine.checkpoint_engine.counters["fallbacks"] == 0
    log(f"checkpoint dp = 2 -> 1: the children's ZeRO-3 tag "
        f"({nbytes / 1e9:.3f} GB in 2 shard files, saved in "
        f"{max(c['save_s'] for c in ck):.2f} s, filesystem "
        f"{filesystem_of(d)}) loaded at dp = 1, ZeRO-2 in {load_s:.2f} s; "
        f"gas 1 -> 2 (global batch 48), micro_steps 6, master CRC "
        f"{crc:#010x} = the children's; next step loss {loss:.6f}")
    del engine
    shutil.rmtree(d, ignore_errors=True)


ZERO_STATS = {}


# ------------------------------------------------ checkpoints (phase 33)


def filesystem_of(path):
    """'<fstype> on <mount point>' of the mount holding ``path`` (the
    longest mount point of /proc/mounts that prefixes it)."""
    path = os.path.realpath(path)
    best = ("?", "?")
    with open("/proc/mounts") as f:
        for line in f:
            dev, mnt, fstype = line.split()[:3]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) >= len(best[1]):
                best = (fstype, mnt)
    return f"{best[0]} on {best[1]}"


def state_snapshot(engine):
    """Device copies of every saved leaf of a one-rank engine and of its
    working parameters (the recast from the master)."""
    st = engine.state
    snap = {f"master.{n}": t.clone() for n, t in st["master"].items()}
    for k in ("m", "v"):
        snap.update({f"{k}.{n}": t.clone()
                     for n, t in st["opt"][k].items()})
    snap.update({f"param.{n}": t.detach().clone()
                 for n, t in st["params"].items()})
    snap.update({f"scale.{k}": v.clone() for k, v in st["scale"].items()})
    snap["opt_step"] = st["opt"]["step"].clone()
    snap["step"] = torch.tensor(st["step"])
    snap["skipped"] = torch.tensor(engine.skipped_steps)
    snap["rng"] = torch.from_numpy(np.asarray(engine.rng_data).copy())
    return snap


def state_mismatches(engine, snap):
    cur = state_snapshot(engine)
    assert set(cur) == set(snap)
    return [k for k in snap if cur[k].dtype != snap[k].dtype
            or not torch.equal(cur[k], snap[k])]


def corrupt_one_chunk_byte(shard):
    """Flip one byte in the middle of the first chunk of an npz shard (its
    zip structure stays readable; a load reads that chunk first, so the
    control fails without reading the whole tag)."""
    import zipfile
    with zipfile.ZipFile(shard) as z:
        info = z.infolist()[0]
        assert info.filename != "__meta__.npy", info.filename
    with open(shard, "r+b") as f:
        f.seek(info.header_offset + 26)
        n, m = np.frombuffer(f.read(4), np.uint16)
        off = info.header_offset + 30 + int(n) + int(m) \
            + info.file_size // 2
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0x5A]))
    return info.filename


PHASE33 = dict(engines=("sync", "async", "native"), between=4,
               max_overlap=12, resume_steps=2)
CKPT_STATS = {}


def phase_checkpoint(card, seed=0):
    """Phase 33: GPT-2 350M at phase 7's configuration (bf16 + fp32 master,
    micro 24, T=1024, AdamW, clip 1.0, ZeRO 2, save_flash, fused CE) saves
    and resumes through save_checkpoint / load_checkpoint. One run takes
    steps on numpy-seeded batches and saves one tag of the whole state with
    each of the sync, async and native engines (steps go on while an async
    or native write is in flight); a second run repeats its first steps
    (the bitwise repeat the resume is held to); fresh engines from another
    seed load the sync and native tags by name and take the next steps:
    every saved leaf (master, m, v, scale, steps, rng words) and the
    recast bf16 parameters equal the saved run's bitwise, the losses equal
    the uninterrupted run's. Controls that must fail: one byte flipped in
    a chunk of the newest (native) tag raises CheckpointCorruptionError on
    a load by name; without a tag the load falls back to the async tag
    (load_fallbacks 1), which then resumes as above. Every engine's
    counters["fallbacks"] is 0. One 'checkpoint' line per engine: bytes a
    tag, seconds save_checkpoint blocked, seconds until 'latest' named the
    tag, write GB/s, load seconds, the median step of steps overlapping an
    in-flight write against the median without, counters; each with the
    card's name and power limit. Returns the path's launches."""
    import shutil
    from deepspeed_tpu_torch import GPT2, GPT2_PRESETS, initialize
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import fused_ce as fce
    from deepspeed_tpu_torch.ops.cuda import layernorm as ln
    from deepspeed_tpu_torch.ops.cuda import mlp_matmul as mm
    from deepspeed_tpu_torch.runtime.checkpoint_engine import \
        serialization as ser
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engines import \
        create_checkpoint_engine
    from deepspeed_tpu_torch.runtime.config import CheckpointEngineConfig
    p = PHASE33
    cfg = dataclasses.replace(
        GPT2_PRESETS["350M"], max_seq_len=1024, use_flash_attention=True,
        flash_block_q=1024, flash_block_k=1024, flash_block_h=1,
        remat=True, remat_policy="save_flash", loss_chunk=512,
        fused_loss=True, fused_loss_kernel=True)
    root = os.path.join(CKPT_ROOT, "gpt2-350M")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    fs = filesystem_of(root)
    free_gb = shutil.disk_usage(root).free / 1e9
    log(f"phase 33 checkpoints under {root}: {fs}, {free_gb:.1f} GB free")

    def build(model_seed, typ="sync"):
        gc.collect()
        torch.cuda.empty_cache()
        engine, *_ = initialize(
            model=GPT2(cfg, device="cuda", seed=model_seed),
            config={"train_micro_batch_size_per_gpu": 24,
                    "gradient_accumulation_steps": 1, "steps_per_print": 0,
                    "optimizer": {"type": "AdamW", "params": {
                        "lr": 2e-4, "weight_decay": 0.01}},
                    "gradient_clipping": 1.0, "bf16": {"enabled": True},
                    "zero_optimization": {"stage": 2},
                    "checkpoint_engine": {"type": typ}})
        return engine

    def batch(step):
        return {"input_ids": np.random.RandomState(seed + 1000 + step)
                .randint(0, cfg.vocab_size, (24, cfg.max_seq_len))
                .astype(np.int32)}

    n_steps = 0

    def step(engine):
        nonlocal n_steps
        t0 = time.perf_counter()
        loss = float(engine.train_batch(batch(engine.global_step + 1)))
        torch.cuda.synchronize()
        n_steps += 1
        return loss, time.perf_counter() - t0

    mods = (fa, fce, ln, mm)
    for mod in mods:
        mod.reset_launch_counts()
    run = build(seed)
    losses, without = {}, []
    for _ in range(2):
        loss = step(run)[0]
        losses[run.global_step] = loss
    snaps, tags, rec = {}, {}, {}
    for typ in p["engines"]:
        if typ != "sync":
            run.checkpoint_engine.shutdown()
            run.checkpoint_engine = create_checkpoint_engine(
                CheckpointEngineConfig(type=typ))
        snaps[typ] = state_snapshot(run)
        tags[typ] = run.save_checkpoint(root)
        overlap = []
        while run.last_save["latest_s"] is None and \
                len(overlap) < p["max_overlap"]:
            loss, t = step(run)
            losses[run.global_step] = loss
            overlap.append(t)
        run.checkpoint_engine.wait()
        assert run.last_save["latest_s"] is not None, run.last_save
        for _ in range(p["between"]):
            loss, t = step(run)
            losses[run.global_step] = loss
            without.append(t)
        shard = os.path.join(root, tags[typ], "shard-0.npz")
        rec[typ] = dict(tag=tags[typ], bytes=os.path.getsize(shard),
                        blocked_s=run.last_save["blocked_s"],
                        latest_s=run.last_save["latest_s"],
                        overlap_step_s=overlap,
                        counters=dict(run.checkpoint_engine.counters))
        assert rec[typ]["counters"]["fallbacks"] == 0, (typ, rec[typ])
        assert rec[typ]["counters"]["save_errors"] == 0, (typ, rec[typ])
    run.save_checkpoint_terminate()
    del run

    # the repeat: an uninterrupted run from the same seed, its first steps
    rep = build(seed)
    repeat = [step(rep)[0] for _ in range(2)]
    del rep
    gap = max(abs(a - losses[i + 1]) for i, a in enumerate(repeat))
    log(f"phase 33 repeat of steps 1-2: {repeat} vs {[losses[1], losses[2]]}"
        f" (largest gap {gap})")

    def resume(engine, typ, **kw):
        t0 = time.perf_counter()
        path, _ = engine.load_checkpoint(root, **kw)
        torch.cuda.synchronize()
        rec[typ]["load_s"] = time.perf_counter() - t0
        assert path == os.path.join(root, tags[typ]), (typ, path)
        bad = state_mismatches(engine, snaps[typ])
        assert not bad, (typ, bad[:8])
        got = [step(engine)[0] for _ in range(p["resume_steps"])]
        want = [losses[engine.global_step - p["resume_steps"] + 1 + i]
                for i in range(p["resume_steps"])]
        rec[typ]["resumed_losses"] = got
        rec[typ]["uninterrupted_losses"] = want
        assert all(abs(a - b) <= gap for a, b in zip(got, want)), \
            (typ, got, want, gap)
        assert engine.checkpoint_engine.counters["fallbacks"] == 0

    for typ in ("sync", "native"):
        eng = build(seed + 100, typ)
        resume(eng, typ, tag=tags[typ])
        del eng
        if typ == "sync":
            shutil.rmtree(os.path.join(root, tags["sync"]))

    # controls: one byte flipped in a chunk of the newest tag
    entry = corrupt_one_chunk_byte(
        os.path.join(root, tags["native"], "shard-0.npz"))
    eng = build(seed + 200, "async")
    try:
        eng.load_checkpoint(root, tag=tags["native"])
    except ser.CheckpointCorruptionError as e:
        log(f"control: the load of {tags['native']} with one byte flipped "
            f"in {entry} raised CheckpointCorruptionError ({e}: "
            f"{e.__cause__})")
    else:
        raise AssertionError("a corrupt tag loaded by name")
    assert eng.checkpoint_engine.counters["load_fallbacks"] == 0
    resume(eng, "async")           # no tag: falls back to the async tag
    assert eng.checkpoint_engine.counters["load_fallbacks"] == 1, \
        eng.checkpoint_engine.counters
    rec["async"]["load_counters"] = dict(eng.checkpoint_engine.counters)
    del eng
    shutil.rmtree(root, ignore_errors=True)

    launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
    L = cfg.n_layer
    want = {"flash_fwd": L * n_steps, "flash_bwd": L * n_steps,
            "flash_bwd_qmajor": 0, "flash_block_fwd": 0,
            "fused_ce": 2 * n_steps, "wq_matmul": 0,
            **knob_launches(cfg, L, n_steps, chunks=2)}
    assert launches == want, (launches, want)
    assert_sm90("checkpoint slice", fa, fce, mm, main_path=True)
    med_without = float(np.median(without))
    for typ in p["engines"]:
        r = rec[typ]
        line = dict(
            engine=typ, card=card, filesystem=fs, tag=r["tag"],
            bytes=r["bytes"], blocked_s=r["blocked_s"],
            latest_s=r["latest_s"],
            write_gb_per_s=r["bytes"] / r["latest_s"] / 1e9,
            load_s=r["load_s"],
            overlap_steps=len(r["overlap_step_s"]),
            overlap_step_s_median=(float(np.median(r["overlap_step_s"]))
                                   if r["overlap_step_s"] else None),
            step_s_median_without=med_without,
            resumed_losses=r["resumed_losses"],
            uninterrupted_losses=r["uninterrupted_losses"],
            counters={k: v for k, v in r["counters"].items() if v})
        CKPT_STATS[typ] = line
        print("checkpoint " + json.dumps(line), flush=True)
    log(f"phase 33: {n_steps} steps, repeat gap {gap}, launches {launches}")
    return launches


# ------------------------------------- serving front-end (phase 34)


def doomed_replica(name, engine, role="colocated", die_at=None,
                   decoded=None):
    """A ``Replica`` that arms ``replica_death`` right before its own step
    ``die_at`` (counting its steps from 1), or before the first step at
    which one of its sequences has ``decoded`` tokens or more, and records
    its in-flight count then (what the router must replay)."""
    from deepspeed_tpu_torch.inference.v2 import Replica
    from deepspeed_tpu_torch.utils import fault_injection

    class Doomed(Replica):
        def step(self):
            self.n_steps = getattr(self, "n_steps", 0) + 1
            seqs = self.engine.state_mgr._seqs.values()
            if getattr(self, "inflight_at_death", None) is None and (
                    self.n_steps == die_at or (decoded is not None and any(
                        len(s.generated) >= decoded for s in seqs))):
                self.inflight_at_death = len(self.inflight)
                self.generated_at_death = sorted(
                    len(s.generated) for s in seqs)
                fault_injection.arm("replica_death", fails=1)
            return super().step()

    return Doomed(name, engine, role=role)


def timed_replica(name, engine, role):
    """A ``Replica`` that times each handoff: export = the engine's gather
    and D2H copy (``export_handoff``) + the pack, import = the unpack + the
    engine's H2D copy and pool writes (``import_handoff``, synchronized);
    each export also records the blocks and bytes it carries."""
    from deepspeed_tpu_torch.inference.v2 import Replica

    def timed(fn, log, sync=False):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            if sync:
                torch.cuda.synchronize()
            log.append(time.perf_counter() - t0)
            return out
        return call

    class Timed(Replica):
        def export_handoff(self, uid):
            t0 = time.perf_counter()
            seq = self.engine.state_mgr.get_sequence(uid)
            blocks = self.engine.state_mgr.blocks_needed(seq.seen_tokens - 1)
            n = len(self.device_s)
            payload = super().export_handoff(uid)
            s = time.perf_counter() - t0
            self.exports.append(dict(uid=uid, blocks=blocks,
                                     bytes=len(payload), s=s,
                                     device_s=self.device_s[n]))
            return payload

        def import_handoff(self, payload):
            t0 = time.perf_counter()
            n = len(self.device_s)
            uid = super().import_handoff(payload)
            self.imports.append(dict(uid=uid, s=time.perf_counter() - t0,
                                     device_s=self.device_s[n]))
            return uid

    rep = Timed(name, engine, role=role)
    rep.exports, rep.imports, rep.device_s = [], [], []
    engine.export_handoff = timed(engine.export_handoff, rep.device_s)
    engine.import_handoff = timed(engine.import_handoff, rep.device_s,
                                  sync=True)
    return rep


def serve_fleet(router, uids):
    """Step the router until idle; -> per-uid first-token and done times on
    the host clock (first token: posted on the engine now serving it)."""
    engines = {r.name: r.engine for r in router.replicas}
    first, done = {}, {}
    while router.has_work:
        router.step()
        now = time.perf_counter()
        for u in uids:
            if u in done:
                continue
            if router.is_done(u):
                done[u] = now
                first.setdefault(u, now)
                continue
            eng = engines.get(router._reqs[u].replica)
            seq = eng.state_mgr._seqs.get(u) if eng is not None else None
            if u not in first and seq is not None and seq.generated:
                first[u] = now
    return first, done


def pool_closed(eng):
    alloc = eng.state_mgr.allocator
    return alloc.free_blocks == alloc.total_blocks


def fleet_stats(uids, outs, first, done, t_start, e2e, new):
    ttft = sorted(first[u] - t_start for u in uids)
    tpot = sorted((done[u] - first[u]) / (new - 1) for u in uids)
    return dict(ttft_p50_s=float(np.percentile(ttft, 50)),
                tpot_p50_ms=float(np.percentile(tpot, 50)) * 1e3,
                output_tok_per_s=float(sum(len(o) for o in outs) / e2e),
                e2e_s=e2e)


def phase_router_parity():
    """Phase 34 (a): a small fp32 Llama (phase 3's) with the kernels on:
    a colocated 2-replica Router, a 1 prefill + 1 decode fleet and the
    colocated fleet with replica_death on r1's third step each give one
    engine's greedy streams; every pool closes."""
    from deepspeed_tpu_torch import (InferenceEngineV2, Llama, LlamaConfig,
                                     Replica, Router)
    from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
    from deepspeed_tpu_torch.utils import fault_injection
    cfg = LlamaConfig(n_layer=2, n_head=4, n_kv_heads=2, d_model=128,
                      max_seq_len=512, vocab_size=512, remat=False,
                      dtype="float32")
    model = Llama(cfg, device="cuda", dtype=torch.float32, seed=7)
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 512, (n,)) for n in (5, 16, 37, 300)]
    conf = dict(dtype="float32", kv_block_size=16, max_batch_size=4,
                prompt_bucket=64, splitfuse_tokens=64, paged_kernel=True)

    def engine():
        return InferenceEngineV2(model, dict(conf), device="cuda")

    pa.reset_launch_counts()
    want = engine().generate_all(prompts, max_new_tokens=24)
    assert min(pa.LAUNCHES.values()) > 0, dict(pa.LAUNCHES)
    fleets = {
        "colocated": [Replica("r0", engine()), Replica("r1", engine())],
        "disaggregated": [Replica("p0", engine(), role="prefill"),
                          Replica("d0", engine(), role="decode")],
        "colocated, r1 dies": [Replica("r0", engine()),
                               doomed_replica("r1", engine(), die_at=3)]}
    for tag, reps in fleets.items():
        fault_injection.reset()
        router = Router(reps)
        uids = [router.put(p, max_new_tokens=24) for p in prompts]
        rounds = 0
        while router.has_work:
            router.step()
            rounds += 1
            assert rounds < 1000, tag
        for u, w in zip(uids, want):
            np.testing.assert_array_equal(router.get(u), w, err_msg=tag)
        snap = router.snapshot()
        live = [r for r in reps if not r.dead]
        assert all(pool_closed(r.engine) for r in live), tag
        if tag == "disaggregated":
            assert snap["handoffs"] == len(prompts), snap
            assert reps[0].engine.forward_counts["decode"] == 0
        if tag == "colocated, r1 dies":
            assert snap["failovers"] == 1 and reps[1].dead, snap
            assert snap["replayed"] == reps[1].inflight_at_death > 0, snap
        log(f"router parity ok ({tag}): {len(prompts)} greedy streams == "
            f"one engine's, {rounds} rounds, handoffs {snap['handoffs']}, "
            f"failovers {snap['failovers']}, replayed {snap['replayed']}")
    fault_injection.reset()
    del fleets, model
    gc.collect()
    torch.cuda.empty_cache()


PHASE34 = dict(blocks=160, new=64)


def phase_router(card, seed=0):
    """Phase 34: (a) phase_router_parity; (b) full-width Llama-2-7B in bf16
    (all 32 layers, phase 4's engine settings with 160 KV blocks an
    engine, phase 4's eight prompts, all greedy, 64 new tokens each): run
    1 one engine (the reference streams); run 2 Router([prefill p0,
    decode d0]) over the in-process transport: the streams run 1's, 8
    handoffs, kv_stream_bytes the payloads' sum, the exported blocks
    sum(ceil(T / 64)), both pools closed, K5 = 32 x p0's chunk forwards,
    K4 = 32 x the decode forwards (d0's; p0 runs none), one weight set
    (the second engine adds a pool, not the model); run 3 two colocated
    replicas, one dying mid-decode: the streams run 1's, one failover, its
    in-flight requests replayed. Returns run 2's launch counts."""
    from deepspeed_tpu_torch import (InferenceEngineV2, LLAMA_PRESETS, Llama,
                                     Replica, Router)
    from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
    from deepspeed_tpu_torch.utils import fault_injection
    phase_router_parity()
    cfg = LLAMA_PRESETS["llama2-7b"]
    new = PHASE34["new"]
    model = Llama(cfg, device="cuda", dtype=torch.bfloat16, seed=seed)
    torch.cuda.synchronize()
    model_gb = torch.cuda.memory_allocated() / 1e9
    conf = dict(dtype="bfloat16", kv_block_size=64, max_batch_size=8,
                splitfuse_tokens=256, decode_steps_per_dispatch=8,
                num_kv_blocks=PHASE34["blocks"])

    def engine():
        return InferenceEngineV2(model, dict(conf), device="cuda")

    rs = np.random.RandomState(seed)
    lens = rs.randint(64, 2049, 8)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)) for n in lens]
    pool_gb = 2 * cfg.n_layer * PHASE34["blocks"] * cfg.n_kv_heads * 64 \
        * cfg.d_head * 2 / 1e9
    lines = {}

    # run 1: one engine, the reference streams
    eng = engine()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    uids = [eng.put(p, new) for p in prompts]
    first, done = serve(eng, uids)
    e2e = time.perf_counter() - t_start
    want = [eng.get(u) for u in uids]
    assert pool_closed(eng)
    lines["run 1: one engine"] = dict(
        fleet_stats(uids, want, first, done, t_start, e2e, new),
        forwards=dict(eng.forward_counts),
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # run 2: one prefill and one decode replica, the KV over the host
    reps = [timed_replica("p0", engine(), "prefill"),
            timed_replica("d0", engine(), "decode")]
    torch.cuda.synchronize()
    fleet_gb = torch.cuda.memory_allocated() / 1e9
    assert fleet_gb - model_gb < 2 * pool_gb + 1.0, \
        (model_gb, fleet_gb, pool_gb)          # one weight set for both
    router = Router(reps)
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
    t_start = time.perf_counter()
    uids = [router.put(p, max_new_tokens=new) for p in prompts]
    first, done = serve_fleet(router, uids)
    e2e = time.perf_counter() - t_start
    launches = dict(pa.LAUNCHES)
    outs = [router.get(u) for u in uids]
    snap = router.snapshot()
    for u, o, w in zip(uids, outs, want):
        np.testing.assert_array_equal(o, w, err_msg=f"run 2, request {u}")
    exports, imports = reps[0].exports, reps[1].imports
    fp, fd = reps[0].engine.forward_counts, reps[1].engine.forward_counts
    assert snap["handoffs"] == len(prompts) == len(exports), snap
    assert snap["kv_stream_bytes"] == sum(x["bytes"] for x in exports)
    assert sum(x["blocks"] for x in exports) == sum(-(-lens // 64))
    assert pool_closed(reps[0].engine) and pool_closed(reps[1].engine)
    assert fp["decode"] == fp["prefill"] == fd["chunk"] == fd["prefill"] \
        == 0, (fp, fd)
    want_launches = {"paged_decode": cfg.n_layer * fd["decode"],
                     "paged_chunk": cfg.n_layer * fp["chunk"]}
    assert launches == want_launches, (launches, want_launches)
    count_paged_designs(pa, launches)
    import_s = {y["uid"]: y["s"] for y in imports}
    hand_s = sorted(x["s"] + import_s[x["uid"]] for x in exports)
    lines["run 2: prefill p0 + decode d0"] = dict(
        fleet_stats(uids, outs, first, done, t_start, e2e, new),
        handoffs=snap["handoffs"], kv_stream_bytes=snap["kv_stream_bytes"],
        exported_blocks=sum(x["blocks"] for x in exports),
        handoff_ms_p50=float(np.percentile(hand_s, 50)) * 1e3,
        handoff_ms_max=max(hand_s) * 1e3,
        export_ms_p50=float(np.percentile(
            [x["s"] for x in exports], 50)) * 1e3,
        import_ms_p50=float(np.percentile(
            [y["s"] for y in imports], 50)) * 1e3,
        handoff_s_split=dict(
            gather_d2h=sum(x["device_s"] for x in exports),
            pack=sum(x["s"] - x["device_s"] for x in exports),
            unpack=sum(y["s"] - y["device_s"] for y in imports),
            h2d_write=sum(y["device_s"] for y in imports)),
        handoff_gb_per_s=snap["kv_stream_bytes"] / sum(hand_s) / 1e9,
        handoff_s_total=sum(hand_s), kv_stream_ms=snap["kv_stream_ms"],
        forwards={"p0": dict(fp), "d0": dict(fd)}, launches=launches,
        model_gb=model_gb, fleet_gb=fleet_gb, pool_gb=pool_gb,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    del router, reps
    gc.collect()
    torch.cuda.empty_cache()

    # run 3: two colocated replicas, r1 dies mid-decode
    fault_injection.reset()
    reps = [Replica("r0", engine()),
            doomed_replica("r1", engine(), decoded=new // 4)]
    router = Router(reps)
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
    t_start = time.perf_counter()
    uids = [router.put(p, max_new_tokens=new) for p in prompts]
    first, done = serve_fleet(router, uids)
    e2e = time.perf_counter() - t_start
    outs = [router.get(u) for u in uids]
    snap = router.snapshot()
    fault_injection.reset()
    for u, o, w in zip(uids, outs, want):
        np.testing.assert_array_equal(o, w, err_msg=f"run 3, request {u}")
    assert snap["failovers"] == 1 and reps[1].dead, snap
    assert snap["replayed"] == reps[1].inflight_at_death > 0, snap
    assert pool_closed(reps[0].engine)
    lines["run 3: r0 + r1, r1 dies mid-decode"] = dict(
        fleet_stats(uids, outs, first, done, t_start, e2e, new),
        failovers=snap["failovers"], replayed=snap["replayed"],
        r1_generated_at_death=reps[1].generated_at_death,
        r1_steps=reps[1].n_steps, launches=dict(pa.LAUNCHES),
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    del router, reps, model
    gc.collect()
    torch.cuda.empty_cache()
    for run, stats in lines.items():
        log("router " + json.dumps(dict(
            run=run, requests=len(prompts), prompt_tokens=int(lens.sum()),
            new_tokens=new, **stats, card=card)))
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="",
                    help="write a torch.profiler breakdown of the slice here")
    ap.add_argument("--child", choices=("parity", "train", "zero-parity",
                                        "zero-train"),
                    help=argparse.SUPPRESS)      # phases 28-29, 31-32
    ap.add_argument("--child-out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.child:
        report = {"parity": child_parity, "train": child_train,
                  "zero-parity": child_zero_parity,
                  "zero-train": child_zero_train}[args.child]()
        with open(args.child_out, "w") as f:
            json.dump(report, f)
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
        return 0
    from deepspeed_tpu_torch.op_builder import build_all
    from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import fused_ce as fce
    from deepspeed_tpu_torch.ops.cuda import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.cuda import layernorm as ln
    from deepspeed_tpu_torch.ops.cuda import mlp_matmul as mm
    from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
    from deepspeed_tpu_torch.ops.cuda import quantization as qz
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    from deepspeed_tpu_torch.op_builder import (BlockSparseAttentionBuilder,
                                                CkptWriterBuilder,
                                                FlashAttentionBuilder,
                                                FusedCEBuilder,
                                                GroupedMatmulBuilder,
                                                LayerNormBuilder,
                                                MlpMatmulBuilder,
                                                PagedAttentionBuilder,
                                                QuantizationBuilder)
    builders = [PagedAttentionBuilder(), FlashAttentionBuilder(),
                FusedCEBuilder(), GroupedMatmulBuilder(), MlpMatmulBuilder(),
                LayerNormBuilder(), BlockSparseAttentionBuilder(),
                QuantizationBuilder(), CkptWriterBuilder()]
    t0 = time.perf_counter()
    build_all(builders)                # one compiler per source, together
    log(f"kernels and the checkpoint writer (g++) built in "
        f"{time.perf_counter() - t0:.1f} s wall")
    for b in builders:
        log(f"  {b.NAME}: {b.COMPILER} {b.build_seconds:.1f} s -> {b.so_path()}")
        for entry, regs, spill in ptxas_summary(b.build_log):
            log(f"    ptxas {entry}: {regs} registers, {spill} bytes "
                f"spilled")
    for mod in (pa, fa, fce, gm, mm, ln, bsa, qz):
        mod.kernel_builder()           # bind the built libraries
    sass = phase_sass(builders)
    log(f"phase 0b (SASS of the sm90 kernels) ok: {len(sass)} instances "
        f"hold HGMMA and UTMALDG")

    def profile_path(suffix):
        if not args.profile:
            return None
        root, ext = os.path.splitext(args.profile)
        return f"{root}-{suffix}{ext}"

    t_phase = time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        log(f"phase {name} took {now - t_phase:.1f} s")
        t_phase = now

    # launch counts of each main path, read right after it ran
    paths = {}
    rows = phase_kernels(pa)
    phase_parity()
    paths["llama-serve"] = phase_slice(profile=args.profile)
    phase_done("1-4 (serving)")
    rows.update(phase_train_kernels(fa, fce))
    phase_train_parity()
    paths["gpt2-train"] = phase_train_slice(profile=profile_path("train"))
    phase_done("5-7 (training)")
    rows.update(phase_moe_kernels(gm))
    phase_done("8 (MoE kernels)")
    phase_moe_parity()
    phase_done("9 (MoE parity)")
    paths["mixtral-serve"] = phase_moe_slice(profile=profile_path("moe"))
    phase_done("10 (MoE slice)")
    (rows["grouped_tgmm"], rows["grouped_gmm"]["dx_view"],
     rows["grouped_gmm"]["training_forward"]) = phase_moe_backward_kernels(gm)
    phase_done("11 (MoE backward kernels)")
    phase_moe_train_parity()
    phase_done("12 (MoE training parity)")
    paths["gpt2moe-train"] = phase_moe_train_slice(
        profile=profile_path("moe-train"))
    phase_done("13 (MoE training slice)")
    rows.update(phase_wq_kernels(mm, gm))
    phase_done("14 (wq kernels)")
    phase_wq_parity()
    phase_done("15 (wq parity)")
    paths["llama-int4-serve"] = phase_wq_slice(
        "llama", profile=profile_path("llama-int4"))
    phase_done("16 (Llama-2-7B int4 slice)")
    paths["mixtral-int8-serve"] = phase_wq_slice(
        "mixtral", profile=profile_path("mixtral-int8"))
    phase_done("17 (Mixtral-8x7B int8 slice)")
    rows.update(phase_knob_kernels(ln, mm))
    phase_done("18 (K13 / K6 kernels)")
    phase_knob_parity()
    phase_done("19 (K13 / K6 parity)")
    paths["gpt2-kernels-train"] = phase_knob_slice(
        profile=profile_path("kernels-train"))
    phase_done("20 (GPT-2 350M with K13 / K6)")
    rows["flash_bwd_qmajor"] = phase_qmajor_kernel(fa)
    phase_done("21 (K2-qmajor kernel)")
    rows.update(phase_bsa_kernels(bsa))
    phase_done("22 (K11 kernels)")
    phase_qmajor_bsa_parity()
    phase_done("23 (K2-qmajor / K11 parity)")
    paths["gpt2-qmajor-train"] = phase_qmajor_slice(
        profile=profile_path("qmajor-train"))
    paths["bsa-fixed"] = phase_bsa_slice("fixed")
    paths["bsa-bigbird"] = phase_bsa_slice("bigbird")
    phase_done("24 (qmajor GPT-2 and SparseSelfAttention slices)")
    rows["flash_block_fwd"] = phase_ring_kernel(fa)
    phase_done("25 (K10 kernel)")
    rows.update(phase_quant_kernels(qz))
    phase_done("26 (K12 kernels)")
    paths.update(phase_nccl_world(fa, qz))
    phase_done("27 (NCCL world of one)")
    paths["comm-gloo-w2"] = phase_seq_parity()
    phase_done("28 (two processes on cuda:0: seq = 2 parity, quantized "
               "collectives)")
    paths["gpt2-seq-train"] = phase_seq_slice()
    phase_done("29 (GPT-2 350M at T=4096, seq = 2)")
    rows.update(phase_rmsnorm_kernel(ln))
    paths["rmsnorm-op"] = phase_rmsnorm_op(ln)
    phase_done("30 (K13 RMSNorm)")
    phase_zero_parity()
    phase_done("31 (two processes on cuda:0: ZeRO 0-3 at dp = 2 parity)")
    paths["gpt2-zero-train"] = phase_zero_slice()
    phase_done("32 (GPT-2 350M at dp = 2, ZeRO-2 and ZeRO-3, a ZeRO-3 tag "
               "resumed at dp = 1)")
    paths["gpt2-ckpt-train"] = phase_checkpoint(card)
    phase_done("33 (GPT-2 350M checkpoints: sync, async, native)")
    paths["llama-router-serve"] = phase_router(card)
    phase_done("34 (serving front-end: Router / Replica, a disaggregated "
               "Llama-2-7B fleet)")

    kernels = []
    for name, r in rows.items():
        by_path = {p: c[name] for p, c in paths.items() if c.get(name)}
        assert by_path, f"{name}: no main path launched it"
        row = dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=sum(by_path.values()),
            launches_by_path=by_path, max_abs_err=r["max_abs_err"],
            ms=r["ms"], kernel_ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1],
            library_ms=r["library_ms"])
        for extra in ("shape", "chunk", "other", "dx_view",
                      "training_forward", "library",
                      "dscale_dbias_rel_norm", "rel_norm", "kmajor_ms",
                      "causal_ms", "expression_ms", "eager_ms", "gqa",
                      "splits", "mma_sync_ms", "sm90_ms",
                      "causal_mma_sync_ms", "union_waste", "split_idle",
                      "causal_library_ms", "causal_bound_ms", "row_tile",
                      "alt_splits", "alt_splits_ms", "int8pack_ms",
                      "bf16_matmul_ms", "delta_ms", "split_ms",
                      "mma_sync_split_ms",
                      "host_ms", "mma_sync_host_ms", "simt_ms",
                      "first_chunk", "long_walk"):
            if extra in r:
                row[extra] = r[extra]
        if name in PATH_DESIGNS:
            row["design"] = "+".join(sorted(
                k for k, v in PATH_DESIGNS[name].items() if v))
            row["launches_by_design"] = {
                k: v for k, v in PATH_DESIGNS[name].items() if v}
        if name in SM90_DESIGNS:
            want = SM90_DESIGNS[name][1]
            row["sass"] = {k: v for k, v in sass.items()
                           if any(w in k for w in want)}
        kernels.append(row)
    # again at the end, where a caller that keeps only the output's tail
    # finds it beside the numbers
    log(f"card: {card}; all phases took "
        f"{time.perf_counter() - t_start:.1f} s (kernel build included)")
    print(json.dumps({"kernels": kernels}))
    # the cards this run used: every phase drives one
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
