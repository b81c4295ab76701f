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
     GQA G = 4 shape beside its bound and SDPA (kv heads repeated); K4 on
     a tensor-parallel rank's ALiBi heads (32 over 2 ranks, 24 over 3:
     the head offset) bitwise the whole-head call's rows, equal to the
     plain version, with a control (rank 1's heads at offset 0) that must
     fail. K5's
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
 10. MoE slice: Mixtral-8x7B widths at 12 layers (random weights from a
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
 14. wq kernels: K7 (wq_matmul) at the Llama-2-7B FFN shapes (8 decode rows, a
     256-token chunk and 1, 200, 300 rows; D=4096 -> F=11008 and back; and a
     tensor_parallel = 2 rank's slices, 4096 -> 5504 and back, at 8 and 256
     rows) on the design _wq_design picks (sm90 for bf16: every call counted
     there, held also against its split-order plain version at the plan's K
     split, repeated bitwise) and K9 (grouped_swiglu_up_wq, grouped_gmm_wq) at
     phase 8's Mixtral-8x7B shapes and edge cases, int8 and int4, bf16 against
     their plain versions in fp32 on the same inputs, fp32 at 1e-4, tails
     exactly 0; controls that must fail (K7's scale shifted by one channel, one
     k slice of its codes skipped, int4 nibbles swapped, a K9 group on its
     neighbour expert's scales); each timed beside its bound, plain version and
     library yardsticks (bf16 torch.matmul / torch._grouped_mm on the
     dequantized weights, and torch._weight_int8pack_mm where this torch runs
     it), K7 also beside its mma_sync design (wq_kernel) and the sm90 kernel at
     the plan's other K split, each with its launches queued behind a device
     spin (the eager call is about as long as its Python launch path: its time
     and the host's launch path are logged beside). K9's every case (int8 and
     int4: decode, chunk, empty groups, one expert, the 162-row tail) on the
     design _wq_grouped_design picks (sm90 for bf16: counted), repeated
     bitwise, tails exactly 0; its controls (a group on its neighbour's scales,
     a group's codes with one k slice skipped) at the decode and the chunk
     shapes; decode and chunk timed on both designs (sm90 and wq_kernel,
     launches queued) beside the library calls and the bound.
 15. wq parity: small fp32 Llama and Mixtral, int8 and int4, served with
     weight_quant give the same greedy streams as the same model with
     its dequantized weights served unquantized (split-fuse on and off).
 16. Llama-2-7B int4 slice and 17. Mixtral-8x7B in int8, each at
     WQ_LAYERS (4) of its 32 layers: built quantized slice by slice, phase 4's settings and traffic;
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
 29. the slice: GPT-2 350M (PHASE29["layers"] (3) of its 24 layers,
     T=4096, micro 4, ring,
     sequence_parallel_size=2, ZeRO-2, bf16) through initialize ->
     train_batch for PHASE29["steps"] (3) steps in two processes on
     cuda:0 over gloo; the
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
     both ranks; then GPT2MoE at the same widths (E = 4, top-2, flash
     attention and the grouped kernels, fp32; 2 steps, gas 2), whose aux
     loss sums its routing statistics over both ranks, at dp = 2 against
     dp = 1: losses at 2e-5, global gradient norms at 1e-5, the same loss
     on both ranks, its launches (K1, K2, 4 gmm and 4 tgmm a layer and
     micro step, fp32) the main path "moe-dp2".
 32. the slice: GPT-2 350M (PHASE32["layers"] (3) of its 24 layers, the
     bench configuration,
     micro 24 a rank, T=1024) at dp = 2 through initialize -> train_batch,
     ZeRO-2 for 3 steps and ZeRO-3 for 3; the loss falls and agrees on
     both ranks; one K1 and one K2 a layer and 2 K3 a step on each rank (every one on
     sm90, as each child reports); step time,
     tokens/s, each process's peak memory and the bytes each rank staged
     through host memory a step. After ZeRO-3's steps the two children
     save one tag (a shard file each); this process loads it at dp = 1
     under ZeRO-2 (gas 1 -> 2 keeps the global batch of 48, micro_steps
     realign), its master equal to the children's gathered master (their
     CRC32), and takes one step with a finite loss.
 33. checkpoints: GPT-2 350M at phase 7's configuration
     (PHASE33["layers"] (3) of its 24 layers) takes steps and saves one tag of its whole state (fp32
     master, m, v) with
     each of the sync, async and native engines, stepping on while an
     async or native write is in flight; a second run repeats its first
     steps (the bitwise repeat the resume is held to); fresh engines load
     the sync and native tags and take the next steps: every saved leaf
     and the recast bf16 parameters bitwise, the losses the uninterrupted
     run's. Controls that must fail: a load by name of the native tag with
     one byte flipped in a chunk raises CheckpointCorruptionError; without
     a tag the load falls back to the async tag (load_fallbacks 1), which
     then resumes the same way. No engine degrades (counters["fallbacks"]
     0); launches exactly one K1 and one K2 a layer and 2 K3 a step, all
     on sm90. One
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
     count), every live pool closed; (b) full-width Llama-2-7B
     (SERVE_LAYERS (2) of its 32 layers) in bf16
     (phase 4's settings with 160 KV blocks an engine, phase 4's eight
     prompts, all greedy, 64 new tokens): run 1 one engine (the reference
     streams), run 2 Router([prefill p0, decode d0]) over the in-process
     transport (streams equal run 1's; 8 handoffs; kv_stream_bytes the
     payloads' sum; 149 exported blocks; both pools closed; K5 = L x
     p0's chunk forwards, K4 = L x d0's decode forwards, p0 decoding
     nothing; the second engine adds its pool, not a second weight set),
     run 3 two colocated replicas with one dying mid-decode (streams
     equal run 1's, failovers 1, its in-flight requests replayed); one
     ``router`` JSON line a run: TTFT / TPOT p50, output tokens/s, handoff
     ms p50 / max and GB/s (export: gather, D2H, pack; import: unpack,
     H2D, pool writes), kv_stream_bytes, peak memory, the card.
 35. the serving features: (0) Llama-2-7B widths at 4 layers in fp32
     (and the narrow draft): greedy streams with the prefix cache on
     (a hit and a CoW), speculating with the target as its own draft and
     with the narrow draft, under KV host offload (decode in groups) and
     through a two-replica prefix-affinity Router each equal to one plain
     engine's, every pool back to full; K5 at the verify shape (C = 5
     rows, contexts 1024-1500, H = KVH = 32, d = 128) on its sm90 design
     against its plain version, repeated bitwise, the eight slots as views
     q[b] of one tensor, timed beside its SIMT design, SDPA and the bound;
     then Llama-2-7B in bf16 at SERVE_LAYERS (2) layers: (a) 16 requests
     on a 1024-token
     system prompt (32 new) with the cache off and on (hit rate, skipped
     prompt tokens, CoW copies, K5 launches, TTFT) and through two
     replicas with prefix_affinity="auto" (where each landed, its
     prefix_score); (b) 8 requests of 1024-1500 tokens (64 new) plain,
     with the target as its own draft and with a 2-layer d_model 1024
     draft (rounds, proposed / accepted / committed, tokens a verify, the
     verify's K5 launches by design, the acceptance latch, TPOT against
     plain); (c) 8 requests of 1500 tokens on 200 logical blocks (pinned
     host memory) with 64 on the card against the same engine resident
     (groups a dispatch, H2D / D2H bytes and GB/s, TPOT, peak memory; the
     streams must be equal). bf16 streams are compared and the differing
     ones' first position and top-2 logit margin printed; launches equal
     what each run's forwards imply. One ``features`` JSON line a run.
 36. the Llama family's training: (1) K1 and K2 on their sm90 designs at
     d = 128 at Llama-2-7B's training shape (B = 1, H = 32, T = 4096,
     causal) and at Mistral-7B's window (H = 8, T = 8192, window 4096),
     bf16 against the plain versions in fp32, repeated bitwise, a control
     per kernel that must fail (a 128-key tile skipped; the dK/dV walk
     without a query tile), each timed beside the plain version, SDPA
     (the window as a mask) and the bound (the kernels line's ``d128``);
     (2) a small fp32 Llama (GQA 8 / 2 heads, d = 128, window 256 of T =
     512) and the Mixtral over it (E = 4, top-2): kernels on (K1 / K2,
     the grouped K8 chain, whole-block remat) and off (dense, ragged, no
     remat) give the same loss (1e-5) and gradients (relative error norm
     1e-4); (3) Llama-2-7B at 8 layers and Mixtral-8x7B at 2 layers, full
     width, bf16, through initialize -> train_batch (AdamW, clip 1.0,
     micro 1 x T = 4096), 10 steps on one fixed batch: the loss falls;
     exactly 2 K1 and 1 K2 a layer and step (Mixtral also 2 swiglu_up, 7
     gmm, 3 tgmm), every one on sm90; step time, tokens/s, model TFLOP/s
     (Mixtral: all experts and the 2 active), peak memory (one ``train
     slice`` JSON line each).
 37. K1 and K2 on fp16 operands (the fp16 build of flash_attention.cu,
     FlashAttentionF16Builder: the .f16 wgmma / mma.sync forms, built
     with the rest and in the SASS check): d 32 / 64 / 128, causal,
     window and not, both layouts, against the plain versions in fp32 at
     the bf16 limits tightened to fp16's mantissa, repeated bitwise, each
     design (sm90 at 64 / 128, mma_sync at 32) counted; controls that
     must fail (a 64-key tile dropped; the bf16 kernels' output on the
     same inputs); an overflow case (ds past 65504: the kernel's
     non-finite rows are the plain fp16 backward's, nothing saturates);
     both timed at the GPT-2 350M shapes beside the plain version, SDPA
     in fp16 and the bound (the kernels line's ``fp16``).
 38. GPT-2 350M in fp16 through initialize -> train_batch with a
     WarmupDecayLR schedule and the dynamic loss scaler from 2^24
     (hysteresis 2), 14 steps: the first steps overflow and are skipped,
     the scale path is the scaler's, the loss falls over the applied
     steps, K1 / K2 once a layer a step on sm90 in fp16; skipped steps,
     scale, lr and step time logged; then one bf16 train_batch each
     under LAMB, Lion, Adagrad and SGD.
 39. MoE expert parallel, processes on cuda:0 over gloo: GPT2MoE at the
     350M widths (1 layer) and Mixtral-8x7B's widths (1 layer) at ep =
     2, Mixtral's staged exchange at data_outer 2 x expert 2 (4
     processes, Mixtral's widths, 1 layer) with dcn_quantize off and
     on, fp32, each step held
     against the same model at ep = 1 (loss, aux, every gradient), the
     K8 and K12 launches the dispatches imply, the bytes each rank's
     exchanges stage through host memory and the exchange's share of
     the step.
 40. the kernels of the Llama families at their shapes
     (phase_family_kernels): K1 / K2 with ALiBi at Bloom-7b1's attention
     (B 1, H 32, T 2048, d 128) on sm90, on mma_sync, falcon-rw's
     bf16-rounded scaled term (d 64) and on fp16 operands; K1 / K2, K4
     and K5 at d = 80 (phi-2), 96 (gpt-neox-20b) and 256 (gpt-j-6b); K4 /
     K5 at Falcon-7b's H 71 / KVH 1 and Qwen2-7B's H 28 / KVH 4; K7 int8
     at Bloom-7b1's and Falcon-7b's non-gated FFN, 8 and 256 rows: each
     against its plain version (bf16 / fp16 in fp32 on the same inputs),
     repeated bitwise where it has a design rule, a control that must fail
     (the plain version without ALiBi, a skipped key tile, dropped table
     blocks, a table entry read as its neighbour, a k slice of codes
     zeroed), timed beside its plain version, the library call (SDPA with
     the ALiBi term as a float mask; torch.matmul on the dequantized
     weight) and its bound.
 41. Bloom-7b1: its widths at 2 layers in fp32, greedy streams with K4
     (the ALiBi slopes in the kernel) equal those with K4's plain version;
     then 15 of its 30 layers in bf16 serving 8 requests (64 new each): TTFT /
     TPOT p50, tokens/s, peak memory, K4's launches by design and no K5
     (ALiBi prefill and chunk are dense, as in JAX).
 42. Bloom-7b1 training: its widths at 2 layers, fp32, T = 512: the loss
     (1e-5) and every gradient (relative error norm 1e-4) with K1 / K2
     carrying ALiBi equal the dense path's; then 8 of its 30 layers in
     bf16 through initialize -> train_batch (AdamW, ZeRO-2, micro 1 x
     2048), 10 steps: the loss falls, K1 / K2 on sm90 as the step implies;
     step time, tokens/s, model TFLOP/s, peak memory.
 43. Falcon-7b, GPT-NeoX-20B, GPT-J-6B, InternLM-7B, Phi-2 and Qwen2-7B
     at their published widths, 4 layers each, bf16, 4 requests each:
     TPOT and K4 / K5 launches by design (d = 64 at G = 71, 96, 256, 128,
     80, 128 at G = 7).
 44. the kernels of the GPT-2 family's paths at its shapes, bf16
     (phase_gpt2_family_kernels): K4 (8 slots) and K5 (a 512-token
     prefill at start 0, a 256-token chunk at start 1024, a 5-token
     verify at start 1200) at GPT-2 1.3B's H = KVH 32, d 64 and at
     GPT-Neo-1.3B's H 16, d 128 with unscaled scores (scale 1.0) at
     window 256 and 0; K7 int8 and int4 on GPT-2 1.3B's wup (2048 ->
     8192) and wdown (8192 -> 2048) at 8 and 256 rows; K3 at GPT-Neo's
     odd vocabulary 50257: each against its plain version, repeated
     bitwise, its design recorded, a control that must fail (the newest
     block read through another table entry, a k slice of codes zeroed,
     the target's vocab tile skipped), timed beside its plain version,
     the library call (SDPA with the causal / window mask at the model's
     scale; torch.matmul on the dequantized weight; cuBLAS h @ w^T) and
     its bound.
 45. GPT-2 1.3B serving: its widths (and GPT-Neo-1.3B's, windows 0 / 256) at 2
     layers in fp32, greedy streams with K4 / K5 on equal their plain versions'
     (split-fuse and bucketed) and weight_quant int8 / int4 (K7) equal the
     dequantized weights served unquantized; then 12 of its 24 layers in bf16,
     8 requests (32 new each): bf16, weight_quant int8 and int4 (the 2-D bias
     leaves bqkv / bup quantized over L), and with bucketed prefill plain and
     with GPT-2 125M as the draft: TTFT / TPOT p50, tokens/s, peak memory, K4 /
     K5 / K7 launches by design, the draft's tokens a verify and TPOT against
     plain decode.
 46. OPT-1.3b and GPT-Neo-1.3B at their published widths and 12 of 24 layers,
     bf16, 8 requests each of 300-2016 tokens (GPT-Neo's window-256
     layers cut; its prefix cache resolves off): the same figures; then
     GPT-Neo at 4 layers through initialize -> train_batch (micro 1 x
     2048, the fused CE head), 2 steps: every layer dense (its windows, as
     JAX), no K1 / K2 launch, K3 four a step at V = 50257 on sm90; step
     time and peak memory.
 47. the autotune winner cache. Every earlier phase ran under cache_only
     on a fresh, empty cache file the script points DSTPU_AUTOTUNE_CACHE
     at before phase 0 (a stale file must not steer their counts): (a)
     at phases 4's, 7's, 10's, 35's and 45's buckets every resolver gives
     the port's cold choice and no search has run; (b) searches under
     on_first_use on a file of their own at full-width buckets (Llama-2-7B
     decode, chunk 256 and verify 5; GPT-2 1.3B decode and chunk; GPT-2
     350M's flash backward on qkv_t, LayerNorm and MLP, each step at its
     bucket's size), one line each with every candidate's ms, its parity,
     default_ms and the winner; every candidate passes parity, every entry
     carries this card's name; the verify's split choices also timed alone
     at start 1200; the one-candidate ops (Mixtral-8x7B's experts at 16
     and 512 rows, phase 35's prefix-cache and speculation pools) take
     their defaults with no search and no entry; (c) a 2-layer Llama-2-7B
     engine on phase 4's traffic serves from the filled file under
     cache_only (bf16; its K4 / K5 launches by lever are the winners'),
     and in fp32 the cold, the searching (on_first_use), the filled and a
     seeded non-default (one decode split, a 16-row chunk tile) engine
     give the same greedy streams; every engine's forwards launch exactly
     the K4 / K5 their counts imply (the searching engine's searches'
     own launches counted apart); (d) an entry measured on another device
     kind is refused (a miss) and an entry naming the dense path for the
     decode raises.
 48. GPT2MoE serving at the 350M widths: at 2 layers in fp32, the ragged
     backend's greedy streams with K4 / K5 / K8 on equal those with all off,
     and the dense backend without drops gives the ragged backend's prefill
     logits (fp32 at 1e-4; bf16 within a relative error norm of 1e-2); at 12 of
     its 24 layers in bf16 (the int8 run (c) at 24), 8 requests of 64-992
     tokens, 32 new each: (a) ragged, 4 experts, top-2: K4 / K5 one a layer and
     forward, K8's grouped_gmm two; (b) the config's MoE defaults (dense, 8
     experts, top-1, eval capacity factor 2.0): K4 / K5, no K8, the gate's
     dropped choices counted; (c) (a) under weight_quant int8 (exactly the
     block leaves JAX's quantize_tree names, the router and the expert biases
     included, each dequantized a layer at a time, as JAX, then K8): TTFT /
     TPOT p50, tokens/s, peak memory.
 49. GPT2MoE dense training: at 2 layers in fp32 the dense backend
     without drops gives the ragged backend's loss, aux and gradients
     (relative error norm 1e-4); the config's MoE defaults at 6 of 24
     layers, bf16, micro 8 x 1024, through initialize -> train_batch, 4
     steps: the loss falls, K1 / K2 one a layer and step (sm90), K3 two a
     step, no K8; step time, tokens/s, peak memory, the dropped share;
     one RSample step of a 2-layer model.
 50. tensor-parallel serving in two processes sharing cuda:0 (a gloo
     world, --child serve-tp): the v2 engine at tensor_parallel = 2, each
     rank holding its slice (H / 2 heads, KVH / 2 KV heads and F / 2 FFN
     columns; GPT-2's wqkv split per head) and summing over "tensor"
     after each row-parallel product. At 2 layers in fp32 the tp = 2
     greedy streams of Llama-2-7B (also under weight_quant int8 and
     int4), GPT-2 1.3B and Bloom-7b1 widths equal a one-rank engine's on
     the same weights; then in bf16, 8 requests of
     64-1023 tokens, 32 new each, split-fuse 256: Llama-2-7B at 8 layers
     (K4 / K5 at 16 local heads, one a layer and forward) and the same
     under weight_quant int8 (K7 three a layer and forward on the rank's
     5504 columns / rows), GPT-2 1.3B at 4, Bloom-7b1 at 2 (K4 with the
     head offset: the global heads' ALiBi slopes): both ranks' streams
     identical (and how many of a rank's own picks rank 0's broadcast
     replaced), exact launch counts a rank, TTFT / TPOT p50, tokens/s,
     peak GB a process, the comm layer's traffic a decode step (what went
     through host memory, and each collective's calls and bytes). A
     one-card world measures correctness and launch counts: its TPOT is
     set by gloo's host staging, not by tensor parallelism on two cards.
 51. expert-parallel serving the same way (--child serve-ep):
     Mixtral-8x7B widths at expert_parallel = 2, 4 experts a rank; at 1
     layer in fp32 the ep = 2 streams equal one rank's; at 2 layers in
     bf16 the rows of each forward split over the two ranks, exchanged to
     the ranks of their experts (K8's grouped pair one each a layer and
     forward on the received rows) and gathered back; the same figures.
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
import collections
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
# library -> the sm90 kernel symbols it must hold; the fp16 build of
# flash_attention.cu holds K1's and K2's in their .f16 forms
SM90_KERNELS = {}
for _lib, _syms in SM90_DESIGNS.values():
    SM90_KERNELS.setdefault(_lib, set()).update(_syms)
SM90_KERNELS["flash_attention_f16"] = set(
    SM90_DESIGNS["flash_fwd"][1] + SM90_DESIGNS["flash_bwd"][1])


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
            key = f"{b.NAME}:{name}" if b.NAME.endswith("_f16") else name
            report[key] = dict(hgmma=hgmma, utmaldg=utmaldg, registers=r,
                               spill_bytes=sp)
            log(f"SASS {key}: {hgmma} HGMMA, {utmaldg} UTMALDG; ptxas "
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
              window=0, want=None):
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
        # every bf16 case (d = 128, 64-position blocks) on sm90 unless the
        # caller names the design, fp32 on the fp32 kernel; calls repeat
        # bitwise
        want = want or ("sm90" if dtype == torch.bfloat16 else "fp32")
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


def decode_head_offset(pa, cases, H=32, tp=2):
    """K4 on a tensor-parallel rank's heads (Bloom-7b1's 32 ALiBi heads
    over tp = 2, and 24 heads over tp = 3: the power-of-two count 16 and
    the interleaved rest, split between ranks): each rank's call with
    ``alibi_offset`` = its first global head and ``alibi_heads`` = H is
    bitwise the whole-head call's rows (each head's arithmetic is its own;
    at offset 0 the kernel computes what it did before the offset
    existed) and agrees with the plain version with the same arguments;
    the control, rank 1's heads with offset 0's slopes, fails the bf16
    check."""
    bf = torch.bfloat16
    for heads, parts in ((H, tp), (24, 3)):
        lens = cases.rs.randint(1, 2048, 8)
        d = cases.decode(8, heads, heads, 128, 64, 32, lens, bf, alibi=True)
        args = [d[n] for n in ("q", "k", "v")]
        whole = pa.paged_decode_attention(
            *args, d["tables"], d["lengths"],
            alibi_slopes=pa.alibi_slopes(heads))
        Hl = heads // parts
        for r in range(parts):
            hs = slice(r * Hl, (r + 1) * Hl)
            q, k, v = (t[:, hs].contiguous() for t in args)
            kw = dict(alibi_slopes=pa.alibi_slopes(heads)[hs],
                      alibi_offset=r * Hl, alibi_heads=heads)
            out = pa.paged_decode_attention(q, k, v, d["tables"],
                                            d["lengths"], **kw)
            cases.check("paged_decode", out, lambda q, k, v, kw=kw:
                        pa.paged_decode_attention_reference(
                            q, k, v, d["tables"], d["lengths"], **kw),
                        q, k, v)
            assert torch.equal(out, whole[:, hs]), \
                f"K4 head offset {r * Hl}: not the whole call's rows"
        q, k, v = (t[:, Hl:2 * Hl].contiguous() for t in args)
        ctrl = pa.paged_decode_attention(
            q, k, v, d["tables"], d["lengths"],
            alibi_slopes=pa.alibi_slopes(heads)[:Hl], alibi_offset=0,
            alibi_heads=heads)
        ref = pa.paged_decode_attention_reference(
            q.float(), k.float(), v.float(), d["tables"], d["lengths"],
            alibi_slopes=pa.alibi_slopes(heads)[Hl:2 * Hl],
            alibi_offset=Hl, alibi_heads=heads)
        why = bf16_mismatch(ctrl, ref)
        assert why is not None, "bf16 check let offset 0's slopes pass"
        log(f"K4 head offset ({heads} ALiBi heads over {parts} ranks): each "
            f"rank's call bitwise the whole call's rows, equal to the plain "
            f"version; control: rank 1's heads at offset 0 fail ({why})")


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
    decode_head_offset(pa, cases)
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


def phase_moe_slice(seed=0, n_layer=12, profile=None):
    """Mixtral-8x7B widths at ``n_layer`` layers (24 is the deepest that
    fits one 80 GB card in bf16 beside the KV pool; 12 for the run's time
    limit) serving phase 4's traffic."""
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
    chunk; D=4096 -> F=11008 and back, and a tensor_parallel = 2 rank's
    slices, 4096 -> 5504 and back: 43 k tiles of 128 split over the plan's
    K splits) and K9 at the Mixtral-8x7B expert
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
    every = ((8, "decode"), (256, "chunk"), (1, "1 row"), (200, "200 rows"),
             (300, "300 rows"))
    for bits in (4, 8):
        for K, N, tag, Ms in ((D, Fl, "up", every), (Fl, D, "down", every),
                              (D, Fl // 2, "up tp2", every[:2]),
                              (Fl // 2, D, "down tp2", every[:2])):
            w = cases.quantized((K, N), bits)
            for M, shape in Ms:
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
            for tag in ("up", "down", "up tp2", "down tp2"):
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


WQ_LAYERS = 4          # of 32 (the run's time limit)


def phase_wq_slice(kind, seed=0, profile=None):
    """Full-depth serving through the fused wq path with phase 4's
    settings and traffic: "llama" = Llama-2-7B in int4 (K7 on the FFN),
    "mixtral" = Mixtral-8x7B in int8 (K9 on the experts), each at
    WQ_LAYERS of their 32 layers;
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
    cfg = dataclasses.replace(cfg, n_layer=WQ_LAYERS)
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


# GPT-2 350M's widths cut to 3 of its 24 layers, 3 steps (the run's time
# limit; a step goes through host memory)
PHASE29 = dict(steps=3, micro=4, seq_len=4096, sp=2, layers=3)


def child_train():
    """Phase 29 in one rank: GPT-2 350M (PHASE29["layers"] layers, T=4096,
    micro 4,
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
        GPT2_PRESETS["350M"], n_layer=p["layers"], max_seq_len=p["seq_len"],
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
    L, steps = p["layers"], p["steps"]
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
    out["moe"] = child_moe_zero_parity(cfg, batches[:MOE_DP_STEPS])
    return out


# phase 31's GPT2MoE: the 350M widths at 2 layers, E = 4, top-2, fp32;
# one step (the run's time limit)
MOE_DP_STEPS = 1


def child_moe_zero_parity(cfg, batches):
    """Phase 31's GPT2MoE half in one rank: the 350M widths at 2 layers, E
    = 4, top-2 (ragged, the grouped kernels, flash attention), fp32,
    ``MOE_DP_STEPS`` train_batch steps (gas 2) at dp = 2 for ZeRO stages
    0-3, whose aux loss sums its routing statistics over both ranks,
    against the same run at dp = 1 in this process: losses, global
    gradient norms, the master's relative error norm; the launches of the
    dp = 2 runs (the main path "moe-dp2"), by design."""
    from deepspeed_tpu_torch import GPT2MoE, initialize
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import grouped_matmul as gm
    from deepspeed_tpu_torch.utils import groups
    mcfg = moe_cfg(cfg, num_experts=4, moe_top_k=2, moe_backend="ragged",
                   use_flash_attention=True)

    def run(stage, topology=None):
        engine, *_ = initialize(
            model=GPT2MoE(mcfg, device="cuda:0", seed=2), device="cuda:0",
            topology=topology, config=zero_config(
                stage, train_batch_size=4, gradient_accumulation_steps=2,
                bf16={"enabled": False}))
        losses, norms = [], []
        for b in batches:
            losses.append(float(engine.train_batch(b)))
            norms.append(engine.get_global_grad_norm())
        return (engine.dp, engine.model._moe_dp_axes, losses, norms,
                engine.gathered_master())

    one = groups.ParallelTopology(groups.TopologyConfig(), world_size=1,
                                  rank=0)
    _, _, ref_losses, ref_norms, ref = run(0, one)
    ref_sq = sum(float(r.square().sum()) for r in ref.values())
    out = {"ref_losses": ref_losses, "ref_norms": ref_norms, "stages": {}}
    for mod in (fa, gm):
        mod.reset_launch_counts()
    for stage in range(4):
        dp, axes, losses, norms, master = run(stage)
        diff_sq = sum(float((master[n] - ref[n]).square().sum())
                      for n in ref)
        out["stages"][stage] = {"dp": dp, "axes": list(axes or ()),
                                "losses": losses, "grad_norms": norms,
                                "master_rel_norm": (diff_sq / ref_sq) ** 0.5}
        del master
    out["launches"] = {**fa.LAUNCHES, **gm.LAUNCHES}
    out["by_design"] = {n: dict(by) for mod in (fa, gm)
                        for n, by in mod.DESIGN_LAUNCHES.items()}
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
    return phase_moe_zero_parity([r["moe"] for r in reps])


def phase_moe_zero_parity(reps):
    """Phase 31's GPT2MoE half (child_moe_zero_parity): each ZeRO stage at
    dp = 2, its aux loss over both ranks' tokens, gives dp = 1's losses
    (2e-5 relative) and global gradient norms (1e-5 relative), the same
    loss on both ranks; the master's relative error norm logged. Launches
    a rank and micro step: K1 and K2 once a layer (fp32), 4 gmm and 4
    tgmm a layer (fp32). Returns the launches summed over the ranks."""
    L, micro = 2, 4 * MOE_DP_STEPS * 2
    for r in reps:
        for stage, res in r["stages"].items():
            assert res["dp"] == 2 and res["axes"] == ["data"], res
            for got, want in zip(res["losses"], r["ref_losses"]):
                assert abs(got - want) <= 2e-5 * abs(want), \
                    (stage, res["losses"], r["ref_losses"])
            for got, want in zip(res["grad_norms"], r["ref_norms"]):
                assert abs(got - want) <= 1e-5 * want, \
                    (stage, res["grad_norms"], r["ref_norms"])
        want = {"flash_fwd": L * micro, "flash_bwd": L * micro,
                "flash_bwd_qmajor": 0, "flash_block_fwd": 0,
                "grouped_swiglu_up": 0, "grouped_gmm": 4 * L * micro,
                "grouped_tgmm": 4 * L * micro, **NO_WQ}
        assert r["launches"] == want, (r["launches"], want)
        for name in ("flash_fwd", "flash_bwd", "grouped_gmm",
                     "grouped_tgmm"):
            by = r["by_design"][name]
            assert by["fp32"] == want[name], (name, by)
            count_designs(name, by)
    for stage in reps[0]["stages"]:
        assert reps[0]["stages"][stage]["losses"] == \
            reps[1]["stages"][stage]["losses"], stage
    log("GPT2MoE at dp = 2 over gloo on cuda:0 (350M widths, 2 layers, E = "
        f"4, top-2, fp32, {MOE_DP_STEPS} steps, gas 2; aux loss over both "
        "ranks) against dp = 1: " + "; ".join(
            f"stage {st} losses {res['losses']} (dp = 1 "
            f"{reps[0]['ref_losses']}), grad norms {res['grad_norms']} "
            f"(dp = 1 {reps[0]['ref_norms']}), master relative error norm "
            f"{max(r['stages'][st]['master_rel_norm'] for r in reps):.3g}"
            for st, res in reps[0]["stages"].items()))
    return {k: sum(r["launches"][k] for r in reps)
            for k in reps[0]["launches"]}


# 3 ZeRO-2 steps (the run's time limit) and 3 ZeRO-3 steps (the tag
# phase 32 resumes at dp = 1 is global_step3), 3 of the 24 layers (the
# run's time limit)
PHASE32 = dict(micro=24, seq_len=1024, steps={2: 3, 3: 3}, layers=3)


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
    """Phase 32 in one rank: GPT-2 350M (PHASE32's layers, the JAX bench
    configuration: bf16 + fp32 master, AdamW, clip 1.0, save_flash, fused
    CE kernel, micro 24, T=1024) at dp = 2 through initialize ->
    train_batch, ZeRO-2 for 3 steps and ZeRO-3 for 3, each on one
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
        GPT2_PRESETS["350M"], n_layer=p["layers"], max_seq_len=p["seq_len"],
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
    same on both ranks, and each step launches exactly one K1 and one K2
    a layer and 2 K3 on each rank (no K2-qmajor, K10 or K12); step time, tokens/s, each
    process's peak memory and the bytes each rank staged through host
    memory a step. Then the children's ZeRO-3 tag resumed at dp = 1
    (resume_dp2_at_dp1)."""
    import shutil
    shutil.rmtree(os.path.join(CKPT_ROOT, "dp2"), ignore_errors=True)
    reps = run_children("zero-train")
    p = PHASE32
    L, total = p["layers"], {}
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
        GPT2_PRESETS["350M"], n_layer=PHASE32["layers"],
        max_seq_len=PHASE32["seq_len"], use_flash_attention=True, remat=True, remat_policy="save_flash",
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


# 3 of GPT-2 350M's 24 layers (the run's time limit)
PHASE33 = dict(engines=("sync", "async", "native"), between=4,
               max_overlap=12, resume_steps=2, layers=3)
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
        GPT2_PRESETS["350M"], n_layer=p["layers"], max_seq_len=1024,
        use_flash_attention=True,
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


# phases 34 and 35 serve Llama-2-7B's widths at 8 of its 32 layers (the
# run's time limit: both are host-bound, a forward's launches scale with L)
SERVE_LAYERS = 2
PHASE34 = dict(blocks=160, new=64)


def phase_router(card, seed=0):
    """Phase 34: (a) phase_router_parity; (b) full-width Llama-2-7B in bf16
    (SERVE_LAYERS of its 32 layers, phase 4's engine settings with 160 KV
    blocks an engine, phase 4's eight prompts, all greedy, 64 new tokens
    each): run 1 one engine (the reference streams); run 2
    Router([prefill p0, decode d0]) over the in-process transport: the
    streams run 1's, 8
    handoffs, kv_stream_bytes the payloads' sum, the exported blocks
    sum(ceil(T / 64)), both pools closed, K5 = L x p0's chunk forwards,
    K4 = L x the decode forwards (d0's; p0 runs none), one weight set
    (the second engine adds a pool, not the model); run 3 two colocated
    replicas, one dying mid-decode: the streams run 1's, one failover, its
    in-flight requests replayed. Returns run 2's launch counts."""
    from deepspeed_tpu_torch import (InferenceEngineV2, LLAMA_PRESETS, Llama,
                                     Replica, Router)
    from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
    from deepspeed_tpu_torch.utils import fault_injection
    phase_router_parity()
    cfg = dataclasses.replace(LLAMA_PRESETS["llama2-7b"], n_layer=SERVE_LAYERS)
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


# -------------------------------------- serving features (phase 35)

# phase 35's traffic and pools (Llama-2-7B, 64-position blocks): (a) 16
# requests on a 1024-token system prompt, 32 new tokens; (b) 8 requests of
# 1024-1500 tokens, 64 new; (c) 8 requests of 1500 tokens on 200 logical
# blocks with 64 on the device, 32 new
PHASE35 = dict(system=1024, requests=16, new=32, prefix_blocks=320,
               spec_requests=8, spec_new=64, spec_blocks=216,
               offload_requests=8, offload_prompt=1500, offload_new=32,
               offload_blocks=200, device_blocks=64, parity_layers=4)
# the narrow draft of (b): Llama-2-7B's vocabulary, 2 layers, d_model 1024,
# 8 heads of 128
NARROW_DRAFT = dict(n_layer=2, n_head=8, n_kv_heads=8, d_model=1024)


def features_prompts(rs, vocab, system, n, lo=64, hi=256):
    """``n`` prompts: one shared ``system`` prompt, then a distinct suffix
    of lo..hi tokens each; the last suffix repeats the first one's first
    40 tokens, so once the first request retired into the tree the last
    one's match ends 40 tokens into a block (a partial-tail CoW)."""
    head = rs.randint(0, vocab, (system,))
    tails = [rs.randint(0, vocab, (rs.randint(lo, hi + 1),))
             for _ in range(n)]
    tails[-1][:40] = tails[0][:40]
    return [np.concatenate([head, t]) for t in tails]


def top2_margin(model, tokens):
    """The model's top-1 minus top-2 logit after ``tokens`` (one bucketed
    prefill into a scratch pool of its own)."""
    BS = 64
    T = len(tokens)
    nb = -(-T // BS)
    cache = model.init_paged_cache(nb + 1, BS)
    idx = np.arange(T)
    tb = torch.from_numpy((1 + idx // BS).astype(np.int32)).cuda()
    to = torch.from_numpy((idx % BS).astype(np.int32)).cuda()
    ids = torch.from_numpy(np.asarray(tokens, np.int32)[None]).cuda()
    with torch.inference_mode():
        logits, _ = model.apply_paged_prefill(ids, cache, tb, to, T)
    top = logits[0].topk(2).values
    return float(top[0] - top[1])


def compare_streams(model, prompts, got, want, tag):
    """bf16 streams against the reference's: the count of equal ones, and
    for each that differs its first differing position and the reference
    model's top-2 logit margin there."""
    diffs = []
    for i, (p, g, w) in enumerate(zip(prompts, got, want)):
        if len(g) == len(w) and (g == w).all():
            continue
        n = min(len(g), len(w))
        j = int(np.nonzero(g[:n] != w[:n])[0][0]) if (g[:n] != w[:n]).any() \
            else n
        diffs.append(dict(request=i, position=j, margin=top2_margin(
            model, np.concatenate([p, w[:j]]))))
    log(f"phase 35 {tag}: {len(prompts) - len(diffs)} of {len(prompts)} "
        f"bf16 streams equal the reference's; differing: {diffs}")
    return dict(equal=len(prompts) - len(diffs), differing=diffs)


def pools_full(eng):
    """Target, draft and offload pools back to full after a drain: every
    block free or held by the tree alone (refcount 1), no draft block, no
    occupied device slot."""
    alloc = eng.state_mgr.allocator
    pc = eng.prefix_cache
    tree = pc.tree_blocks if pc is not None else 0
    ok = alloc.free_blocks + tree == alloc.total_blocks
    if pc is not None:
        ok = ok and all(alloc.refcount(n.block) == 1 for n in pc._walk())
    da = eng.state_mgr.draft_allocator
    if da is not None:
        ok = ok and da.free_blocks == da.total_blocks
    if eng.kv_pool is not None:
        ok = ok and bool((eng.kv_pool.logical_of[1:] < 0).all())
    return ok


def scored_replica(name, engine):
    """A ``Replica`` that records the prefix score the router reads for
    each prompt it probes (keyed by the prompt's bytes)."""
    from deepspeed_tpu_torch.inference.v2 import Replica

    class Scored(Replica):
        def prefix_score(self, prompt):
            s = super().prefix_score(prompt)
            key = np.asarray(prompt, np.int32).tobytes()
            self.scores[key] = max(self.scores.get(key, 0), s)
            return s

    rep = Scored(name, engine)
    rep.scores = {}
    return rep


def serve_run(eng, prompts, new, pa=None):
    """Submit ``prompts`` together and serve them to the end; -> (streams,
    stats, launches (None without ``pa``)). Counts are reset right before
    and read right after."""
    for k in eng.forward_counts:
        eng.forward_counts[k] = 0
    for k in eng.draft_forward_counts:
        eng.draft_forward_counts[k] = 0
    if pa is not None:
        pa.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    uids = [eng.put(p, new) for p in prompts]
    first, done = serve(eng, uids)
    e2e = time.perf_counter() - t_start
    launches = dict(pa.LAUNCHES) if pa is not None else None
    outs = [eng.get(u) for u in uids]
    for u, o in zip(uids, outs):
        assert len(o) == new, (u, len(o))
    ttft = sorted(first[u] - t_start for u in uids)
    tpot = sorted((done[u] - first[u]) / (new - 1) for u in uids)
    stats = dict(ttft_p50_s=float(np.percentile(ttft, 50)),
                 tpot_p50_ms=float(np.percentile(tpot, 50)) * 1e3,
                 output_tok_per_s=float(sum(len(o) for o in outs) / e2e),
                 e2e_s=e2e, forwards=dict(eng.forward_counts),
                 max_memory_allocated_gb=(
                     torch.cuda.max_memory_allocated() / 1e9))
    if eng.draft_model is not None:
        stats["draft_forwards"] = dict(eng.draft_forward_counts)
    return outs, stats, launches


def expected_launches(eng, L, draft_L=0):
    """K4 / K5 launches a run's forwards imply: one a layer and forward,
    a verify forward one K5 a slot and layer; the draft's likewise."""
    fc, dc = eng.forward_counts, eng.draft_forward_counts
    B = eng.config.max_batch_size
    return {"paged_decode": L * fc["decode"] + draft_L * dc["decode"],
            "paged_chunk": L * (fc["chunk"] + fc["prefill"]
                                + B * fc["verify"]) + draft_L * dc["chunk"]}


def phase_features_parity(seed=0):
    """Phase 35 (0): Llama-2-7B widths at PHASE35["parity_layers"] layers
    in fp32 (the narrow draft too): greedy streams of the prefix cache on,
    speculation with the target as its own draft and with the narrow
    draft, KV host offload and a two-replica prefix-affinity Router each
    equal one plain engine's; every pool back to full; the cache took a
    hit and a CoW, the self-draft committed more than a token a round."""
    from deepspeed_tpu_torch import (InferenceEngineV2, LLAMA_PRESETS, Llama,
                                     Router)
    cfg = dataclasses.replace(LLAMA_PRESETS["llama2-7b"],
                              n_layer=PHASE35["parity_layers"],
                              dtype="float32")
    model = Llama(cfg, device="cuda", dtype=torch.float32, seed=seed)
    draft = Llama(dataclasses.replace(cfg, **NARROW_DRAFT), device="cuda",
                  dtype=torch.float32, seed=seed + 1)
    conf = dict(dtype="float32", kv_block_size=64, max_batch_size=4,
                splitfuse_tokens=256, decode_steps_per_dispatch=8,
                num_kv_blocks=96)
    rs = np.random.RandomState(seed + 35)
    prompts = features_prompts(rs, cfg.vocab_size, 256, 8, lo=64, hi=160)
    new = 24

    def engine(**kw):
        return InferenceEngineV2(model, dict(conf, **kw), device="cuda")

    want = engine().generate_all(prompts, max_new_tokens=new)
    out = {}
    runs = {"prefix cache": (dict(prefix_cache=True), {}),
            "self-draft": (dict(spec_k=4), dict(draft_model=model)),
            "narrow draft": (dict(spec_k=4), dict(draft_model=draft)),
            "offload": (dict(kv_host_offload=True, device_kv_blocks=12,
                             num_kv_blocks=64), {})}
    for tag, (kw, extra) in runs.items():
        eng = InferenceEngineV2(model, dict(conf, **kw), device="cuda",
                                **extra)
        got = eng.generate_all(prompts, max_new_tokens=new)
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w, err_msg=f"{tag}, {i}")
        assert pools_full(eng), tag
        snap = eng.telemetry_snapshot()
        if tag == "prefix cache":
            s = eng.prefix_cache.stats()
            assert s["hits"] >= 1 and s["cow_copies"] >= 1, s
            out[tag] = s
        elif tag == "offload":
            assert max(eng.offload_group_counts) > 1, \
                dict(eng.offload_group_counts)
            out[tag] = dict(groups=dict(eng.offload_group_counts),
                            swapped_in=eng.kv_pool.swapped_in,
                            swapped_out=eng.kv_pool.swapped_out)
        else:
            out[tag] = {k: v for k, v in snap.items()
                        if k.startswith("spec")}
        if tag == "self-draft":
            assert snap["spec_tokens_per_verify_step"] > 1, snap
        del eng
    reps = [scored_replica(f"r{i}", engine(prefix_cache=True))
            for i in range(2)]
    router = Router(reps, prefix_affinity="auto")
    assert router._affinity_on()
    uids = [router.put(p, max_new_tokens=new) for p in prompts]
    rounds = 0
    while router.has_work:
        router.step()
        rounds += 1
        assert rounds < 2000
    for i, (u, w) in enumerate(zip(uids, want)):
        np.testing.assert_array_equal(router.get(u), w,
                                      err_msg=f"affinity fleet, {i}")
    assert all(pools_full(r.engine) for r in reps)
    out["affinity fleet"] = {r.name: r.engine.prefix_cache.stats()["hits"]
                             for r in reps}
    log(f"phase 35 fp32 parity ok at {cfg.n_layer} layers: {len(prompts)} "
        f"greedy streams of each run == one plain engine's; "
        + json.dumps(out))
    del reps, router, model, draft
    gc.collect()
    torch.cuda.empty_cache()


def verify_kernel(pa, seed=0):
    """K5 at the verify shape (phase 35): C = 5 query rows a slot over
    Llama-2-7B's pools (H = KVH = 32, d = 128, 64-position blocks) at a
    1200-token context, on its sm90 design, against its plain version in
    fp32, repeated bitwise; then the eight slots of one verify as views
    q[b] of one (8, 5, 32, 128) tensor (the bases the model passes) at
    contexts 1024-1500, each against its plain version; timed beside its
    SIMT design, the other split choice, SDPA and the bound."""
    cases = KernelCases(pa, seed)
    c = cases.chunk(32, 32, 128, 64, 64, 5, 1200, 5, "auto", torch.bfloat16)
    r = chunk_timing(pa, c, with_plain=True)
    k, v = c["k"], c["v"]
    NB = k.shape[0]
    q_all = cases.randn((8, 5, 32, 128), torch.bfloat16)
    starts = cases.rs.randint(1024, 1501, 8)
    tables = torch.from_numpy(np.stack([
        cases.rs.permutation(np.arange(1, NB))[:64] for _ in range(8)])
        .astype(np.int32)).cuda()
    pa.reset_launch_counts()
    for b in range(8):
        out = pa.paged_chunk_attention(q_all[b], k, v, tables[b],
                                       int(starts[b]), 5)
        cases.check("paged_chunk", out, lambda q, k, v, b=b:
                    pa.paged_chunk_attention_reference(
                        q, k, v, tables[b], int(starts[b]), 5), q_all[b], k,
                    v)
    assert pa.DESIGN_LAUNCHES["paged_chunk"]["sm90"] == 8, \
        dict(pa.DESIGN_LAUNCHES["paged_chunk"])
    r["max_abs_err"] = cases.err["paged_chunk"]
    r["rel_norm"] = cases.rel["paged_chunk"]
    r["shape"] += "; verify C = 5 rows a slot"
    log("phase 35 K5 verify shape " + json.dumps(
        {k2: v2 for k2, v2 in r.items() if k2 != "bound"}))
    return r


def phase_features(card, pa, seed=0):
    """Phase 35: (0) phase_features_parity; K5 at the verify shape
    (verify_kernel); then Llama-2-7B in bf16 at SERVE_LAYERS of its 32
    layers (random weights from the seed, 64-position blocks, batch 8,
    split-fuse 256, 8 decode steps a dispatch): (a) the prefix cache off,
    then on, over
    16 requests on a 1024-token system prompt (32 new tokens each; one
    suffix diverging mid-block), then a two-replica Router with prefix
    affinity (one request first, then the other 15 together); (b) 8
    requests of 1024-1500 tokens (64 new) plain, with the
    target as its own draft and with the narrow draft; (c) 8 requests of
    1500 tokens on 200 logical blocks, 64 of them on the device, against
    the same engine resident (bucketed prefill, so all 8 decode
    together). Gates: every pool back to full, a hit and a
    CoW, the self-draft more than one token a verify round, offload's
    streams equal resident's, launches as the forwards imply. Returns
    (launches by path, the verify row)."""
    from deepspeed_tpu_torch import (InferenceEngineV2, LLAMA_PRESETS, Llama,
                                     Router)
    phase_features_parity(seed)
    verify = verify_kernel(pa, seed)
    cfg = dataclasses.replace(LLAMA_PRESETS["llama2-7b"], n_layer=SERVE_LAYERS)
    L = cfg.n_layer
    P = PHASE35
    model = Llama(cfg, device="cuda", dtype=torch.bfloat16, seed=seed)
    base = dict(dtype="bfloat16", kv_block_size=64, max_batch_size=8,
                splitfuse_tokens=256, decode_steps_per_dispatch=8)
    rs = np.random.RandomState(seed + 35)
    lines, paths = {}, {}

    def engine(**kw):
        return InferenceEngineV2(model, dict(base, **kw), device="cuda")

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # (a) prefix cache: off, on, a two-replica affinity fleet
    prompts = features_prompts(rs, cfg.vocab_size, P["system"],
                               P["requests"])
    new = P["new"]
    eng = engine(num_kv_blocks=P["prefix_blocks"], prefix_cache=False)
    want, stats, launches = serve_run(eng, prompts, new, pa)
    assert launches == expected_launches(eng, L), launches
    count_paged_designs(pa, launches)
    paths["llama-prefix-off-serve"] = launches
    lines["(a) prefix cache off"] = dict(stats, launches=launches)
    assert pools_full(eng)
    eng = None
    free()
    eng = engine(num_kv_blocks=P["prefix_blocks"], prefix_cache=True)
    got, stats, launches = serve_run(eng, prompts, new, pa)
    assert launches == expected_launches(eng, L), launches
    count_paged_designs(pa, launches)
    paths["llama-prefix-serve"] = launches
    s = eng.prefix_cache.stats()
    assert s["hits"] >= 1 and s["cow_copies"] >= 1, s
    lines["(a) prefix cache on"] = dict(
        stats, launches=launches, prefix=s,
        prompt_tokens_skipped=s["cached_tokens"],
        streams=compare_streams(model, prompts, got, want, "prefix on"))
    assert pools_full(eng)
    eng = None
    free()
    reps = [scored_replica(f"r{i}", engine(
        num_kv_blocks=P["prefix_blocks"], prefix_cache=True))
        for i in range(2)]
    router = Router(reps, prefix_affinity="auto")
    assert router._affinity_on()
    pa.reset_launch_counts()
    t_start = time.perf_counter()
    # one request first (it retires into its replica's tree), then the
    # other 15 together: affinity sends those that fit to that replica
    uids = [router.put(prompts[0], max_new_tokens=new)]
    first, fin = serve_fleet(router, uids)
    uids += [router.put(p, max_new_tokens=new) for p in prompts[1:]]
    more = serve_fleet(router, uids[1:])
    first.update(more[0])
    fin.update(more[1])
    e2e = time.perf_counter() - t_start
    landed = [router._reqs[u].replica for u in uids]
    outs = [router.get(u) for u in uids]
    launches = dict(pa.LAUNCHES)
    per = [expected_launches(r.engine, L) for r in reps]
    assert launches == {k: sum(e[k] for e in per) for k in launches}, \
        (launches, per)
    count_paged_designs(pa, launches)
    paths["llama-affinity-serve"] = launches
    # the score the router read on each replica it probed (None: that
    # replica could not take the request that round, so it was not asked)
    scores = [{r.name: r.scores.get(np.asarray(p, np.int32).tobytes())
               for r in reps} for p in prompts]
    for r in reps:
        assert pools_full(r.engine), r.name
    lines["(a) two replicas, prefix affinity"] = dict(
        fleet_stats(uids, outs, first, fin, t_start, e2e, new),
        landed=landed, prefix_score=scores,
        hits={r.name: r.engine.prefix_cache.stats()["hits"] for r in reps},
        launches=launches,
        streams=compare_streams(model, prompts, outs, want, "affinity"))
    router = reps = None
    free()

    # (b) speculative decoding: plain, self-draft, narrow draft
    n = P["spec_requests"]
    lens = rs.randint(1024, 1501, n)
    prompts = [rs.randint(0, cfg.vocab_size, (m,)) for m in lens]
    new = P["spec_new"]
    eng = engine(num_kv_blocks=P["spec_blocks"])
    want, plain, launches = serve_run(eng, prompts, new, pa)
    assert launches == expected_launches(eng, L), launches
    count_paged_designs(pa, launches)
    lines["(b) plain decode"] = dict(plain, launches=launches)
    assert pools_full(eng)
    eng = None
    free()
    narrow = Llama(dataclasses.replace(cfg, **NARROW_DRAFT), device="cuda",
                   dtype=torch.bfloat16, seed=seed + 1)
    for tag, draft, dL in (("self-draft", model, L),
                           ("narrow draft", narrow, NARROW_DRAFT["n_layer"])):
        eng = InferenceEngineV2(model, dict(base,
                                            num_kv_blocks=P["spec_blocks"]),
                                device="cuda", draft_model=draft)
        assert eng._spec_k == 4
        latched = []
        drop_draft = eng.state_mgr.drop_draft

        def drop(seq, drop_draft=drop_draft, latched=latched):
            if not seq.spec_on and seq.draft_blocks:
                latched.append(seq.spec_rounds)      # the acceptance latch
            drop_draft(seq)

        eng.state_mgr.drop_draft = drop
        got, stats, launches = serve_run(eng, prompts, new, pa)
        by = dict(pa.DESIGN_LAUNCHES["paged_chunk"])
        assert launches == expected_launches(eng, L, dL), launches
        count_paged_designs(pa, launches)
        paths["llama-spec-self-serve" if draft is model
              else "llama-spec-narrow-serve"] = launches
        tel = eng.telemetry
        spec = dict(rounds=tel.spec_rounds, proposed=tel.spec_proposed,
                    accepted=tel.spec_accepted,
                    committed=tel.spec_committed,
                    tokens_per_verify=tel.spec_committed / max(
                        1, tel.spec_rounds),
                    verify_forwards=eng.forward_counts["verify"],
                    verify_k5_launches=(L * eng.config.max_batch_size
                                        * eng.forward_counts["verify"]),
                    k5_design=by, latched_after_rounds=latched)
        if draft is model:
            assert spec["committed"] > spec["rounds"], spec
        lines[f"(b) {tag}"] = dict(
            stats, launches=launches, spec=spec,
            tpot_vs_plain=stats["tpot_p50_ms"] / plain["tpot_p50_ms"],
            streams=compare_streams(model, prompts, got, want, tag))
        assert pools_full(eng)
        eng = None
        free()
    narrow = None

    # (c) KV host offload against the same engine resident, bucketed
    # prefill (all 8 prefilled at admission, so all 8 decode together)
    n = P["offload_requests"]
    prompts = [rs.randint(0, cfg.vocab_size, (P["offload_prompt"],))
               for _ in range(n)]
    new = P["offload_new"]
    eng = engine(num_kv_blocks=P["offload_blocks"], splitfuse_tokens=0)
    want, resident, launches = serve_run(eng, prompts, new, pa)
    assert launches == expected_launches(eng, L), launches
    count_paged_designs(pa, launches)
    lines["(c) resident"] = dict(resident, launches=launches)
    assert pools_full(eng)
    eng = None
    free()
    t0 = time.perf_counter()
    eng = engine(num_kv_blocks=P["offload_blocks"], splitfuse_tokens=0,
                 kv_host_offload=True, device_kv_blocks=P["device_blocks"])
    build_s = time.perf_counter() - t0
    pool = eng.kv_pool
    pool.timing = True
    got, stats, launches = serve_run(eng, prompts, new, pa)
    assert launches == expected_launches(eng, L), launches
    count_paged_designs(pa, launches)
    paths["llama-offload-serve"] = launches
    xfer = pool.transfer_stats()
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"offload, request {i}")
    assert max(eng.offload_group_counts) > 1, dict(eng.offload_group_counts)
    lines["(c) offload"] = dict(
        stats, launches=launches,
        groups_a_dispatch=dict(eng.offload_group_counts),
        swapped_in=pool.swapped_in, swapped_out=pool.swapped_out,
        h2d_bytes=xfer["h2d"]["bytes"], d2h_bytes=xfer["d2h"]["bytes"],
        h2d_gb_per_s=xfer["h2d"]["bytes"] / max(xfer["h2d"]["s"], 1e-9) / 1e9,
        d2h_gb_per_s=xfer["d2h"]["bytes"] / max(xfer["d2h"]["s"], 1e-9) / 1e9,
        h2d_s=xfer["h2d"]["s"], d2h_s=xfer["d2h"]["s"],
        pinned_gb=pool.pinned_bytes / 1e9, pool_build_s=build_s,
        tpot_vs_resident=stats["tpot_p50_ms"] / resident["tpot_p50_ms"],
        streams_equal=n)
    assert pools_full(eng)
    eng = None
    free()
    model = None
    free()
    for run, stats in lines.items():
        log("features " + json.dumps(dict(run=run, **stats, card=card)))
    return paths, verify


# ------------------------------------- Llama / Mixtral training (phase 36)


# K1 / K2 at the Llama family's training shapes: Llama-2-7B's heads at its
# context, and Mistral-7B's window over twice that at 8 heads (so the plain
# version's (H, T, T) scores fit)
LLAMA_ATTN_CASES = (("llama2-7b", 1, 32, 4096, 128, 0),
                    ("mistral-window", 1, 8, 8192, 128, 4096))


def window_pairs(T, window):
    """The (query, key) pairs a causal attention over T positions visits,
    each query seeing at most ``window`` keys (0: all before it)."""
    if not window or window >= T:
        return _causal_pairs(T)
    return window * (window + 1) // 2 + (T - window) * window


def phase_llama_attention_kernels(fa, seed=0):
    """Phase 36, part 1: K1 and K2 on their sm90 designs at d = 128 and the
    Llama family's training shapes (LLAMA_ATTN_CASES, the model's (B, T,
    H, d) strides), bf16 against the plain versions in fp32 on the same
    inputs, each call repeated bitwise; at the Llama-2-7B shape a control
    per kernel that must fail (a 128-key tile skipped; the dK/dV walk
    without its second query tile); each timed beside its plain version,
    SDPA (the window as a boolean mask) and its bound. Returns
    {"flash_fwd" | "flash_bwd": {case: figures}}."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    bf = torch.bfloat16

    def randn(shape):
        return torch.randn(shape, generator=g, device="cuda").to(bf)

    out = {"flash_fwd": {}, "flash_bwd": {}}
    for tag, B, H, T, d, window in LLAMA_ATTN_CASES:
        kw = dict(causal=True, window=window)
        q, k, v, do = (randn((B, T, H, d)).transpose(1, 2) for _ in range(4))
        q = fa.scale_q(q, 1.0 / math.sqrt(d))
        q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
        fa.reset_launch_counts()
        o, lse = fa.flash_forward(q, k, v, **kw)
        again = fa.flash_forward(q, k, v, **kw)
        torch.cuda.synchronize()
        assert fa.DESIGN_LAUNCHES["flash_fwd"]["sm90"] == 2, \
            (tag, fa.DESIGN_LAUNCHES)
        assert all(torch.equal(a, b) for a, b in zip((o, lse), again)), \
            f"flash_fwd {tag}: calls differ"
        del again
        ro, rlse = fa.flash_forward_reference(q32, k32, v32, **kw)
        why = bf16_mismatch(o, ro)
        assert why is None, f"flash_fwd {tag}: {why}"
        torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
        _, fwd_err, fwd_rel = bf16_errors(o, ro)
        if not window:
            dropped = flash_with_key_tile_dropped(fa, q32, k32, v32, 1,
                                                  128).to(bf)
            why = bf16_mismatch(dropped, ro)
            assert why is not None, \
                f"bf16 check let a dropped key tile pass at {tag}"
            log(f"control: flash forward at {tag} with 128-key tile 1 "
                f"skipped fails ({why})")
            del dropped
        del ro, rlse
        grads = fa.flash_backward(q, k, v, o, lse, do, **kw)
        again = fa.flash_backward(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        assert fa.DESIGN_LAUNCHES["flash_bwd"]["sm90"] == 2, \
            (tag, fa.DESIGN_LAUNCHES)
        assert all(torch.equal(a, b) for a, b in zip(grads, again)), \
            f"flash_bwd {tag}: calls differ"
        del again
        refs = fa.flash_backward_reference(q32, k32, v32, o.float(), lse,
                                           do32, **kw)
        bwd_rel, bwd_err = 0.0, 0.0
        for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
            why = bf16_grad_mismatch(a, r)
            assert why is None, f"flash_bwd {tag} {name}: {why}"
            bwd_rel = max(bwd_rel, grad_rel_norm(a, r))
            bwd_err = max(bwd_err, (a.float() - r).abs().max().item())
        del grads
        if not window:
            cut = bwd_with_query_tile_dropped(fa, q32, k32, v32, o.float(),
                                              lse, do32, slice(128, 256))
            for name, c, r in zip(("dk", "dv"), cut, refs[1:]):
                why = bf16_grad_mismatch(c.to(bf), r)
                assert why is not None, \
                    f"grad check let {name} without a query tile pass"
                log(f"control: flash backward's {name} at {tag} without "
                    f"query tile 1 of the dK/dV walk fails ({why})")
            del cut
        del refs, q32, k32, v32, do32
        torch.cuda.empty_cache()

        pairs = B * H * window_pairs(T, window)
        act = B * T * H * d * 2
        mask = (fa._mask(T, True, window, q.device) if window else None)
        qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))

        def sdpa(a, b, c):
            if mask is None:
                return F.scaled_dot_product_attention(a, b, c, is_causal=True,
                                                      scale=1.0)
            return F.scaled_dot_product_attention(a, b, c, attn_mask=mask,
                                                  scale=1.0)
        sdpa_o = sdpa(qs, ks, vs)
        fwd = dict(
            shape=[B, H, T, d], window=window, pairs=pairs,
            ms=time_ms(lambda: fa.flash_forward(q, k, v, **kw), 10),
            plain_ms=time_ms(lambda: fa.flash_forward_reference(
                q, k, v, **kw), 2),
            library_ms=time_ms(lambda: sdpa(q, k, v), 10),
            bound=bound(4 * act + B * H * T * 4, 4 * d * pairs),
            max_abs_err=fwd_err, rel_norm=fwd_rel)
        bwd = dict(
            shape=[B, H, T, d], window=window, pairs=pairs,
            ms=time_ms(lambda: fa.flash_backward(q, k, v, o, lse, do, **kw),
                       10),
            plain_ms=time_ms(lambda: fa.flash_backward_reference(
                q, k, v, o, lse, do, **kw), 2),
            library_ms=time_ms(lambda: torch.autograd.grad(
                sdpa_o, (qs, ks, vs), do, retain_graph=True), 10),
            bound=bound(8 * act + B * H * T * 4, 10 * d * pairs),
            max_abs_err=bwd_err, rel_norm=bwd_rel)
        for name, r in (("flash_fwd", fwd), ("flash_bwd", bwd)):
            r["bound_ms"], r["bound_by"] = r.pop("bound")
            out[name][tag] = r
            log(f"{name} d=128 {tag} (B={B} H={H} T={T} window={window}, "
                f"{pairs} pairs): {r['ms']:.4f} ms (plain "
                f"{r['plain_ms']:.4f}, SDPA {r['library_ms']:.4f}, bound "
                f"{r['bound_ms']:.4f} by {r['bound_by']}), max |err| "
                f"{r['max_abs_err']:.3g}, worst rel norm {r['rel_norm']:.3g}")
        del sdpa_o, qs, ks, vs, q, k, v, do, o, lse, mask
        torch.cuda.empty_cache()
    return out


def llama_train_launches(cfg, steps):
    """A training step's launches of a Llama / Mixtral under whole-block
    remat: K1 twice a layer (the forward and its recompute), K2 once; a
    Mixtral layer's experts 2 swiglu_up, 7 gmm (2 forward, 5 backward:
    g and u again, then dh, dg and du's dx views) and 3 tgmm."""
    L = cfg.n_layer
    fwd = 2 * L if cfg.remat else L
    moe = hasattr(cfg, "num_experts")
    return {"flash_fwd": fwd * steps, "flash_bwd": L * steps,
            "flash_bwd_qmajor": 0, "flash_block_fwd": 0, "fused_ce": 0,
            "grouped_swiglu_up": fwd * steps if moe else 0,
            "grouped_gmm": (fwd + 5 * L) * steps if moe else 0,
            "grouped_tgmm": 3 * L * steps if moe else 0, **NO_WQ}


def phase_llama_train_parity(seed=0):
    """Phase 36, part 2: a small fp32 Llama (GQA 8 / 2 heads, d = 128,
    a window of 256 under T = 512) and the Mixtral over it (E = 4, top-2)
    on the card with the kernels on (flash K1 / K2, the grouped K8 chain,
    whole-block remat) and off (dense attention, the ragged math, no
    remat): the same loss (1e-5 relative) and every gradient within a
    relative error norm of 1e-4; launches exactly what the step implies
    when on, none when off."""
    from deepspeed_tpu_torch import Llama, LlamaConfig, Mixtral, MixtralConfig
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import fused_ce as fce
    from deepspeed_tpu_torch.ops.cuda import grouped_matmul as gm
    base = dict(n_layer=2, n_head=8, n_kv_heads=2, d_model=1024, d_ff=2048,
                vocab_size=1000, max_seq_len=512, sliding_window=256,
                dtype="float32", remat_policy="nothing_saveable")
    ids = torch.from_numpy(np.random.RandomState(seed).randint(
        0, 1000, (2, 512))).cuda()
    for name, cls, cfg_cls, extra in (
            ("llama", Llama, LlamaConfig, {}),
            ("mixtral", Mixtral, MixtralConfig,
             dict(num_experts=4, moe_top_k=2, d_ff=1024))):
        out = {}
        for on in (True, False):
            cfg = cfg_cls(**{**base, **extra}, use_flash_attention=on,
                          remat=on)
            model = cls(cfg, device="cuda", seed=seed)
            if extra:
                model.grouped_kernel = on
            for mod in (fa, fce, gm):
                mod.reset_launch_counts()
            loss = model.loss({"input_ids": ids})
            loss.backward()
            torch.cuda.synchronize()
            launched = {**fa.LAUNCHES, **fce.LAUNCHES, **gm.LAUNCHES}
            want = llama_train_launches(cfg, 1 if on else 0)
            assert launched == want, (name, on, launched, want)
            out[on] = (loss.item(), {n: p.grad for n, p in
                                     model.named_parameters()})
            del model
        (l_on, g_on), (l_off, g_off) = out[True], out[False]
        assert abs(l_on - l_off) <= 1e-5 * abs(l_off), (name, l_on, l_off)
        worst = 0.0
        for n, gr in g_off.items():
            rel = (torch.linalg.vector_norm(g_on[n] - gr)
                   / torch.linalg.vector_norm(gr)).item()
            assert rel <= 1e-4, (name, n, rel)
            worst = max(worst, rel)
        log(f"{name} training parity ok (fp32, 2 layers, GQA 8 / 2, window "
            f"256 of T = 512): kernels on vs off, loss {l_on:.7f} vs "
            f"{l_off:.7f}, worst gradient relative error norm {worst:.3g}")
        del out, g_on, g_off
        torch.cuda.empty_cache()


def mixtral_active_flops_per_token(cfg):
    """``flops_per_token`` with k of the E experts a token runs: 6 *
    (non-embedding params - L (E - k) 3 D F) + 12 L D T."""
    cut = cfg.n_layer * (cfg.num_experts - cfg.moe_top_k) * 3 \
        * cfg.d_model * cfg.ffn_dim
    n = cfg.num_params() - cfg.vocab_size * cfg.d_model - cut
    return 6 * n + 12 * cfg.n_layer * cfg.d_model * cfg.max_seq_len


# depth cuts of phase 36's training slices: the bf16 weights, grads, fp32
# master and Adam moments of 8 Llama-2-7B layers (1.88 B parameters) take
# ~34 GB, of 2 Mixtral-8x7B layers (3.16 B) ~63 GB at the step's peak
LLAMA_TRAIN_LAYERS = {"llama": 8, "mixtral": 2}


def phase_llama_train_slice(kind, seed=0, steps=10, profile=None):
    """Phase 36, part 3: Llama-2-7B (8 layers) or Mixtral-8x7B (2 layers)
    at full width in bf16 through initialize -> train_batch (AdamW, clip
    1.0, ZeRO-2 at dp = 1, micro 1 x T = 4096, the presets' whole-block
    remat, flash attention, the grouped kernels), 10 steps on one fixed
    numpy-seeded batch: the loss falls; the launches are exactly
    ``llama_train_launches``, every one on sm90; step time, tokens/s,
    model TFLOP/s (Mixtral: all experts and the k active) and peak memory.
    Returns the launch counts."""
    from deepspeed_tpu_torch import (LLAMA_PRESETS, MIXTRAL_8X7B, Llama,
                                     Mixtral, initialize)
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import fused_ce as fce
    from deepspeed_tpu_torch.ops.cuda import grouped_matmul as gm
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated()
    assert left < 1e9, f"earlier phases left {left / 1e9:.2f} GB allocated"
    T = 4096
    base, cls = ((LLAMA_PRESETS["llama2-7b"], Llama) if kind == "llama"
                 else (MIXTRAL_8X7B, Mixtral))
    cfg = dataclasses.replace(base, n_layer=LLAMA_TRAIN_LAYERS[kind],
                              max_seq_len=T, use_flash_attention=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, *_ = initialize(
        model=cls(cfg, device="cuda", seed=seed),
        config=zero_config(2, train_micro_batch_size_per_gpu=1))
    torch.cuda.synchronize()
    built = torch.cuda.memory_allocated()
    log(f"{kind}-train engine built in {time.perf_counter() - t0:.1f} s: "
        f"{cfg.num_params() / 1e9:.3f} B params ({cfg.n_layer} layers), "
        f"micro 1 x {T}, {built / 1e9:.2f} GB allocated")
    batch = {"input_ids": np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (1, T)).astype(np.int32)}
    for mod in (fa, fce, gm):
        mod.reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    launches = {**fa.LAUNCHES, **fce.LAUNCHES, **gm.LAUNCHES}
    want = llama_train_launches(cfg, steps)
    assert launches == want, (kind, launches, want)
    assert_sm90(f"{kind} train slice", fa, main_path=True)
    if kind == "mixtral":
        for name in ("grouped_swiglu_up", "grouped_gmm", "grouped_tgmm"):
            by = dict(gm.DESIGN_LAUNCHES[name])
            assert by == {"sm90": want[name], "mma_sync": 0, "fp32": 0}, \
                (name, by)
            count_designs(name, by)
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    step_s = float(np.median(times[1:]))
    stats = dict(
        kind=kind, n_layer=cfg.n_layer, params=cfg.num_params(), steps=steps,
        losses=losses, step_s=times, step_s_median_after_first=step_s,
        tokens_per_s=T / step_s, flops_per_token=cfg.flops_per_token(),
        model_tflops_per_s=cfg.flops_per_token() * T / step_s / 1e12,
        launches_per_step={k: v // steps for k, v in launches.items() if v},
        memory_after_build_gb=built / 1e9,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        max_memory_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)
    if kind == "mixtral":
        act = mixtral_active_flops_per_token(cfg)
        stats.update(active_flops_per_token=act,
                     model_tflops_per_s_active=act * T / step_s / 1e12)
    log(f"{kind} train slice " + json.dumps(stats))
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


# ----------------------------------------------- fp16 K1 / K2 (phase 37)

# fp16 flash output and gradients vs the plain version in fp32 on the same
# inputs: the bf16 limits tightened to fp16's mantissa (10 bits against
# bf16's 7: each rounding 8x finer).
FP16_TOL = dict(rtol=2 ** -10, atol=5e-4)
FP16_REL_NORM = BF16_REL_NORM / 8
FP16_GRAD_REL_NORM = BF16_GRAD_REL_NORM / 8


def fp16_mismatch(out, ref, tol=FP16_TOL, rel_norm=FP16_REL_NORM):
    """None if ``out`` holds against the fp32 ``ref`` at the fp16 limits
    (element by element, and each row's relative error norm), else why
    not."""
    if not torch.isfinite(out).all():
        return "non-finite output"
    diff = out.float() - ref
    over = int((diff.abs() > tol["atol"] + tol["rtol"] * ref.abs()).sum())
    rel = (torch.linalg.vector_norm(diff, dim=-1)
           / torch.linalg.vector_norm(ref, dim=-1)).max().item()
    if over or rel > rel_norm:
        return (f"{over} of {out.numel()} elements out of tolerance, max "
                f"|err| {diff.abs().max().item():.3g}, worst row relative "
                f"error norm {rel:.3g}")
    return None


def fp16_grad_mismatch(out, ref):
    if not torch.isfinite(out).all():
        return "non-finite output"
    rel = grad_rel_norm(out, ref)
    if rel > FP16_GRAD_REL_NORM:
        return f"worst (b, h) slab relative error norm {rel:.3g}"
    return None


def phase_fp16_kernels(fa, seed=0):
    """Phase 37: K1 and K2 on fp16 operands, the fp16 build of
    flash_attention.cu (FlashAttentionF16Builder, -DDS_ELEM_F16: the .f16
    wgmma / mma.sync forms). Each case against the plain version in fp32
    at the fp16 limits, repeated bitwise, its design counted (sm90 at d =
    64 / 128, mma_sync at d = 32); controls that must fail: a 64-key tile
    dropped, and the bf16 kernels' output on the same inputs (the fp16
    limits tell the two precisions apart); an overflow case (do rows near
    fp16's top, so ds = p (dp - delta) passes 65504): the kernel's rows
    and key rows that hold inf are the plain fp16 backward's, nothing
    saturates; then both timed at the GPT-2 350M shapes beside the plain
    version, SDPA in fp16 and the bound."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    h16 = torch.float16

    def randn(shape, dtype=h16, s=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * s).to(dtype)

    cases = ((4, 8, 1000, 64, True, 0, False),
             (2, 4, 777, 128, True, 300, False),
             (2, 4, 640, 128, False, 0, True),
             (3, 2, 333, 64, True, 100, True),
             (2, 4, 500, 32, True, 0, False))
    worst = {"flash_fwd": 0.0, "flash_bwd": 0.0}
    for B, H, T, d, causal, window, heads_major in cases:
        shape = (B, H, T, d) if heads_major else (B, T, H, d)
        q, k, v, do = (randn(shape) for _ in range(4))
        if not heads_major:
            q, k, v, do = (x.transpose(1, 2) for x in (q, k, v, do))
        q = fa.scale_q(q, 1.0 / math.sqrt(d))
        design = "mma_sync" if d == 32 else "sm90"
        kw = dict(causal=causal, window=window)
        tag = f"fp16 {shape} causal={causal} window={window}"
        fa.reset_launch_counts()
        o, lse = fa.flash_forward(q, k, v, **kw)
        o2, lse2 = fa.flash_forward(q, k, v, **kw)
        grads = fa.flash_backward(q, k, v, o, lse, do, **kw)
        again = fa.flash_backward(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        for name in ("flash_fwd", "flash_bwd"):
            assert fa.DESIGN_LAUNCHES[name][design] == 2 == \
                fa.DTYPE_LAUNCHES[name]["float16"] == fa.LAUNCHES[name], \
                (tag, fa.DESIGN_LAUNCHES, fa.DTYPE_LAUNCHES)
        assert torch.equal(o, o2) and torch.equal(lse, lse2), \
            f"flash_fwd {tag}: calls differ"
        assert all(torch.equal(a, b) for a, b in zip(grads, again)), \
            f"flash_bwd {tag}: calls differ"
        q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
        ro, rlse = fa.flash_forward_reference(q32, k32, v32, **kw)
        why = fp16_mismatch(o, ro)
        assert why is None, f"flash_fwd {tag}: {why}"
        torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
        worst["flash_fwd"] = max(worst["flash_fwd"],
                                 (o.float() - ro).abs().max().item())
        refs = fa.flash_backward_reference(q32, k32, v32, o.float(), lse,
                                           do32, **kw)
        for gname, a, r in zip(("dq", "dk", "dv"), grads, refs):
            why = fp16_grad_mismatch(a, r)
            assert why is None, f"flash_bwd {tag} {gname}: {why}"
            worst["flash_bwd"] = max(worst["flash_bwd"],
                                     (a.float() - r).abs().max().item())
        if d == 64 and causal and not window:
            # controls: a 64-key tile dropped, and the bf16 kernels' output
            dropped = flash_with_key_tile_dropped(fa, q32, k32, v32, 1,
                                                  64).to(h16)
            why = fp16_mismatch(dropped, ro)
            assert why is not None, "fp16 check let a dropped key tile pass"
            log(f"control: fp16 forward with 64-key tile 1 dropped fails "
                f"({why})")
            qb, kb, vb, dob = (x.to(torch.bfloat16) for x in (q, k, v, do))
            ob, lseb = fa.flash_forward(qb, kb, vb, **kw)
            why = fp16_mismatch(ob, ro)
            assert why is not None, "fp16 check let a bf16 output pass"
            gb = fa.flash_backward(qb, kb, vb, ob, lseb, dob, **kw)
            why_g = fp16_grad_mismatch(gb[0], refs[0])
            assert why_g is not None, "fp16 check let a bf16 dq pass"
            log(f"control: the bf16 kernels on the same inputs fail the "
                f"fp16 limits (forward: {why}; dq: {why_g})")
            del dropped, qb, kb, vb, dob, ob, gb
        del q, k, v, do, o, o2, grads, again, refs, ro
    log(f"fp16 K1 / K2 cases ok ({len(cases)}: d 32 / 64 / 128, causal, "
        f"window and not, model and heads-major strides; repeats bitwise; "
        f"sm90 at 64 / 128, mma_sync at 32): max |err| forward "
        f"{worst['flash_fwd']:.3g}, backward {worst['flash_bwd']:.3g}")

    # overflow: the first 8 query rows of every (b, h) carry do at 3e4, so
    # ds = p (dp - delta) passes fp16's 65504 there and rounds to inf (the
    # JAX kernel's astype); the other rows stay finite. The kernel's
    # non-finite dq rows and dk key rows (the products of the rounded ds)
    # must be the plain fp16 backward's: a kernel that clamped or saturated
    # ds would leave them finite.
    B, H, T, d = 2, 4, 512, 64
    q, k, v, do = (randn((B, H, T, d)) for _ in range(4))
    q = fa.scale_q(q, 1.0 / math.sqrt(d))
    do[:, :, :8] = do[:, :, :8].float().mul(3e4).clamp(-6e4, 6e4).to(h16)
    o, lse = fa.flash_forward(q, k, v)
    got = fa.flash_backward(q, k, v, o, lse, do)
    ref = fa.flash_backward_reference(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    over = {}
    for gname, a, r in zip(("dq", "dk"), got, ref):
        bad, rbad = (~torch.isfinite(x).all(-1) for x in (a, r))
        assert torch.equal(bad, rbad), \
            f"fp16 overflow: {gname}'s non-finite rows differ from the " \
            f"plain version's ({int(bad.sum())} vs {int(rbad.sum())})"
        over[gname] = int(bad.sum())
    assert over["dq"] > 0 and over["dq"] < B * H * T, over
    ok = torch.isfinite(ref[0]).all(-1)
    why = fp16_grad_mismatch(
        got[0][ok].view(1, 1, -1, d), ref[0].float()[ok].view(1, 1, -1, d))
    assert why is None, f"fp16 overflow case, finite dq rows: {why}"
    log(f"fp16 overflow case ok: non-finite rows as the plain fp16 backward "
        f"(dq {over['dq']}, dk {over['dk']} of {B * H * T}), no "
        f"saturation; the finite dq rows within the fp16 limits")
    del q, k, v, do, o, got, ref

    # timing at the GPT-2 350M shapes (phase 5's), the model's layout
    B, H, T, d = 24, 16, 1024, 64
    q, k, v, do = (randn((B, T, H, d)).transpose(1, 2) for _ in range(4))
    q = fa.scale_q(q, 1.0 / math.sqrt(d))
    o, lse = fa.flash_forward(q, k, v)
    pairs = B * H * _causal_pairs(T)
    act = B * T * H * d * 2
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa_o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                            scale=1.0)
    rows = {
        "flash_fwd": dict(
            ms=time_ms(lambda: fa.flash_forward(q, k, v), 20),
            plain_ms=time_ms(lambda: fa.flash_forward_reference(q, k, v), 3),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=1.0), 20),
            bound=bound(4 * act + B * H * T * 4, 4 * d * pairs),
            max_abs_err=worst["flash_fwd"]),
        "flash_bwd": dict(
            ms=time_ms(lambda: fa.flash_backward(q, k, v, o, lse, do), 10),
            plain_ms=time_ms(lambda: fa.flash_backward_reference(
                q, k, v, o, lse, do), 2),
            library_ms=time_ms(lambda: torch.autograd.grad(
                sdpa_o, (qs, ks, vs), do, retain_graph=True), 10),
            bound=bound(8 * act + B * H * T * 4, 10 * d * pairs),
            max_abs_err=worst["flash_bwd"])}
    for name, r in rows.items():
        log(f"{name} fp16 (B={B} H={H} T={T} d={d} causal): {r['ms']:.4f} "
            f"ms (plain {r['plain_ms']:.4f}, SDPA fp16 "
            f"{r['library_ms']:.4f}, bound {r['bound'][0]:.4f} by "
            f"{r['bound'][1]})")
    del q, k, v, do, o, lse, qs, ks, vs, sdpa_o
    torch.cuda.empty_cache()
    return rows


# ------------------------ fp16 training, the other optimizers (phase 38)

# phase 38's fp16 run: from 2^24 the 350M model's first steps overflow
# fp16 (from 2^20 they do not: its gradients at the random initial
# weights are small, and only grow past 2^20's limit after a few steps)
FP16_SLICE = dict(steps=14, initial_scale_power=24, hysteresis=2,
                  schedule={"type": "WarmupDecayLR", "params": {
                      "total_num_steps": 14, "warmup_min_lr": 0.0,
                      "warmup_max_lr": 2e-4, "warmup_num_steps": 4}})


def phase_fp16_slice(seed=0):
    """Phase 38: GPT-2 350M at full width in fp16 through initialize ->
    train_batch (phase 7's configuration with fp16 in place of bf16, the
    dynamic loss scaler from 2^24 with a hysteresis of 2, a WarmupDecayLR
    schedule; the fused loss head's plain chunks: K3 takes bf16 / fp32
    only), 14 steps on one batch: each step's loss, overflow flag, loss
    scale and lr logged with the skipped steps and the step time; the
    first step overflows and a later one applies, the scale path is the
    dynamic scaler's on the overflow flags seen, the losses are finite and
    fall over the applied steps, and K1 / K2 launch once a layer a step,
    all on sm90 in fp16. Then one bf16 train_batch of the same model under
    each of LAMB, Lion, Adagrad and SGD: applied, finite, the master
    moved. Returns the fp16 run's launches."""
    from deepspeed_tpu_torch import GPT2, GPT2_PRESETS, initialize
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import fused_ce as fce
    from deepspeed_tpu_torch.runtime.fp16.loss_scaler import \
        DynamicLossScaler
    spec = FP16_SLICE
    base = dataclasses.replace(
        GPT2_PRESETS["350M"], max_seq_len=1024, use_flash_attention=True,
        remat=True, remat_policy="save_flash", loss_chunk=512,
        fused_loss=True, fused_loss_kernel=False)
    batch = {"input_ids": np.random.RandomState(seed).randint(
        0, base.vocab_size, (24, 1024)).astype(np.int32)}
    config = {"train_micro_batch_size_per_gpu": 24, "steps_per_print": 0,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 2e-4, "weight_decay": 0.01}},
              "gradient_clipping": 1.0, "zero_optimization": {"stage": 2},
              "fp16": {"enabled": True,
                       "initial_scale_power": spec["initial_scale_power"],
                       "hysteresis": spec["hysteresis"]},
              "scheduler": spec["schedule"]}
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(base, dtype="float16")
    engine, *_ = initialize(model=GPT2(cfg, device="cuda", seed=seed),
                            config=config)
    for mod in (fa, fce):
        mod.reset_launch_counts()
    rows, times = [], []
    for _ in range(spec["steps"]):
        t1 = time.perf_counter()
        loss = float(engine.train_batch(batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        m = engine.last_metrics
        rows.append({"loss": loss, "overflow": bool(m["overflow"]),
                     "loss_scale": float(m["loss_scale"]),
                     "lr": float(m["lr"])})
    launches = {**fa.LAUNCHES, **fce.LAUNCHES}
    L, steps = cfg.n_layer, spec["steps"]
    want = {"flash_fwd": L * steps, "flash_bwd": L * steps,
            "flash_bwd_qmajor": 0, "flash_block_fwd": 0, "fused_ce": 0}
    assert launches == want, (launches, want)
    for name in ("flash_fwd", "flash_bwd"):
        assert fa.DTYPE_LAUNCHES[name]["float16"] == L * steps, \
            fa.DTYPE_LAUNCHES
    assert_sm90("fp16 slice", fa, main_path=True)
    flags = [r["overflow"] for r in rows]
    assert flags[0] and not all(flags), rows
    scaler = DynamicLossScaler(
        init_scale=2.0 ** spec["initial_scale_power"],
        delayed_shift=spec["hysteresis"])
    st = scaler.init_state()
    for r in rows:
        assert r["loss_scale"] == float(st["scale"]), rows
        st = scaler.update(st, r["overflow"])
    applied = [r["loss"] for r in rows if not r["overflow"]]
    assert all(math.isfinite(r["loss"]) for r in rows), rows
    assert applied[-1] < rows[0]["loss"], rows
    assert engine.skipped_steps == sum(flags)
    step_s = float(np.median(times[1:]))
    log(f"fp16 slice (GPT-2 350M, micro 24 x 1024, from 2^"
        f"{spec['initial_scale_power']}, hysteresis {spec['hysteresis']}, "
        f"WarmupDecayLR): skipped {engine.skipped_steps} of {steps} steps; "
        f"loss scale path {[r['loss_scale'] for r in rows]}; lr path "
        f"{[r['lr'] for r in rows]}; losses "
        f"{[round(r['loss'], 4) for r in rows]}; step {step_s:.4f} s "
        f"median after the first ({json.dumps(launches)})")
    TRAIN_STATS["fp16 slice"] = dict(rows=rows, step_s=times,
                                     step_s_median_after_first=step_s,
                                     skipped=engine.skipped_steps)
    del engine
    opts = {"Lamb": {"lr": 2e-4, "weight_decay": 0.01},
            "Lion": {"lr": 2e-5, "weight_decay": 0.01},
            "Adagrad": {"lr": 1e-3}, "SGD": {"lr": 1e-2, "momentum": 0.9}}
    out = {}
    for name, params in opts.items():
        gc.collect()
        torch.cuda.empty_cache()
        engine, *_ = initialize(
            model=GPT2(base, device="cuda", seed=seed), config={
                **{k: v for k, v in config.items() if k != "scheduler"},
                "fp16": {"enabled": False}, "bf16": {"enabled": True},
                "optimizer": {"type": name, "params": params}})
        before = engine.state["master"]["wte"][:8].clone()
        t1 = time.perf_counter()
        loss = float(engine.train_batch(batch))
        torch.cuda.synchronize()
        took = time.perf_counter() - t1
        moved = (engine.state["master"]["wte"][:8] - before).abs().max()
        assert math.isfinite(loss) and not engine.last_metrics["overflow"]
        assert float(moved) > 0, name
        out[name] = dict(loss=loss, step_s=took,
                         grad_norm=engine.get_global_grad_norm())
        del engine, before
    log(f"one bf16 train_batch of GPT-2 350M (ZeRO-2) under each optimizer "
        f"(applied, the master moved): {json.dumps(out)}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------- MoE expert parallel (phase 39)

# phase 39's runs: name -> (world, model, layers, model config changes,
# config knobs of each variant, run in turn by the same processes), all at
# the models' published widths. Cuts: GPT2MoE at 2 layers, Mixtral-8x7B at
# 1 layer (its fp32 experts take 5.6 GB whole; rank 0 keeps an ep = 1
# copy's gradients in host memory and gathers each variant's there)
EP_RUNS = {
    "gpt2moe-ep2": (2, "gpt2moe", 1, {}, {"": {}}),
    "mixtral-ep2": (2, "mixtral", 1, {}, {"": {}}),
    "mixtral-staged": (4, "mixtral", 1, {}, {
        "": {"zero_optimization": {"stage": 1, "mics_shard_size": 1}},
        "-dcn": {"zero_optimization": {"stage": 1, "mics_shard_size": 1},
                 "moe": {"dcn_quantize": True}}}),
}
# T (the run's time limit); each rank's micro batch is 2 x T (GPT2MoE),
# 1 x T
EP_TOKENS = 512
EP_STEPS = 2            # the first held against ep = 1, the second timed


def ep_model(kind, n_layer, over, seed=3):
    from deepspeed_tpu_torch import (GPT2_PRESETS, GPT2MoE, MIXTRAL_8X7B,
                                     Mixtral)
    if kind == "gpt2moe":
        cfg = moe_cfg(dataclasses.replace(
            GPT2_PRESETS["350M"], n_layer=n_layer, max_seq_len=EP_TOKENS,
            dtype="float32", remat=False), num_experts=4, moe_top_k=2,
            moe_backend="ragged", use_flash_attention=True)
        return GPT2MoE(cfg, device="cuda:0", seed=seed)
    cfg = dataclasses.replace(MIXTRAL_8X7B, n_layer=n_layer,
                              max_seq_len=EP_TOKENS, dtype="float32",
                              remat=False, use_flash_attention=True, **over)
    return Mixtral(cfg, device="cuda:0", seed=seed)


class _CommClock:
    """Wall seconds (synchronised on both sides, so a rank's wait for the
    others counts) and calls of the comm layer's all_to_all (the
    exchanges, both ways) and all_reduce (the gradients, the capacity,
    the aux statistics) while installed, in the comm module and in the
    package that re-exports it."""

    def __init__(self, *mods):
        self.mods = mods
        self.real = {op: getattr(mods[0], op)
                     for op in ("all_to_all", "all_reduce")}
        self.reset()

    def reset(self):
        """Start a new count (the last one stays with whoever read it)."""
        self.stats = {op: [0, 0.0] for op in self.real}

    def wrap(self, op):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            y = self.real[op](*a, **k)
            torch.cuda.synchronize()
            self.stats[op][0] += 1
            self.stats[op][1] += time.perf_counter() - t
            return y
        return timed

    def __enter__(self):
        for op in self.real:
            timed = self.wrap(op)
            for mod in self.mods:
                setattr(mod, op, timed)
        return self

    def __exit__(self, *exc):
        for op, fn in self.real.items():
            for mod in self.mods:
                setattr(mod, op, fn)


def child_ep(name):
    """Phase 39 in one rank: each variant of ``EP_RUNS[name]`` at fp32
    through initialize -> train_batch (SGD, ZeRO-1), EP_STEPS steps on
    one batch: the first step's loss and clipped gradients, the aux loss
    after them (GPT2MoE), each step's time and its comm layer's
    all_to_all / all_reduce calls and seconds, the run's launches by
    kernel and by design and the bytes staged through host memory. Rank 0
    first runs the same model at ep = 1 (a one-rank topology, the whole
    batch), keeps its gradients in host memory and holds each variant's
    loss, aux and every gradient (gathered to it, _ep_grad_errs) against
    them."""
    from deepspeed_tpu_torch import comm, initialize
    from deepspeed_tpu_torch.comm import comm as comm_mod
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.cuda import quantization as qz
    from deepspeed_tpu_torch.utils import groups
    rank, world = child_world()
    _, kind, n_layer, model_over, variants = EP_RUNS[name]
    rows = 2 if kind == "gpt2moe" else 1
    base = {"train_batch_size": rows * world, "steps_per_print": 0,
            "optimizer": {"type": "SGD", "params": {"lr": 1e-3}},
            "gradient_clipping": 1.0, "zero_optimization": {"stage": 1}}
    vocab = 50304 if kind == "gpt2moe" else 32000
    batch = {"input_ids": np.random.RandomState(5).randint(
        0, vocab, (rows * world, EP_TOKENS)).astype(np.int32)}
    mods = (fa, gm, qz)

    def run(config, topology=None, ref=None):
        gc.collect()
        torch.cuda.empty_cache()
        engine, *_ = initialize(model=ep_model(kind, n_layer, model_over),
                                device="cuda:0", topology=topology,
                                config=config)
        grads = []
        clip = engine._unscale_clip

        def record(g, scale):
            got = clip(g, scale)
            if not grads:
                grads.append(
                    {n: t.float().cpu() for n, t in got[0].items()}
                    if topology is not None else
                    _ep_grad_errs(engine, got[0], ref))
            return got
        engine._unscale_clip = record
        for mod in mods:
            mod.reset_launch_counts()
        comm.get_comms_logger().reset()
        times, losses, comms = [], [], []
        with _CommClock(comm_mod, comm) as clock:
            for _ in range(EP_STEPS):
                clock.reset()
                t1 = time.perf_counter()
                losses.append(float(engine.train_batch(batch)))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t1)
                comms.append(clock.stats)
        launches = {k: v for mod in mods for k, v in mod.LAUNCHES.items()}
        by_design = {n: dict(by) for mod in (fa, gm)
                     for n, by in mod.DESIGN_LAUNCHES.items()}
        staged = {k: list(v) for k, v in
                  comm.get_comms_logger().host_staged.items()}
        aux = None
        if kind == "gpt2moe":
            r = engine.topology.axis_index(groups.BATCH_AXES)
            ids = torch.from_numpy(batch["input_ids"]).cuda()
            micro = ids.shape[0] // engine.dp
            with torch.no_grad():
                aux = float(engine.model.hidden_with_aux(
                    ids[r * micro:(r + 1) * micro])[1])
        out = dict(losses=losses, step_s=times, aux=aux, launches=launches,
                   by_design=by_design, staged=staged, comm=comms,
                   dp=engine.dp, ep_size=engine.topology.axis_size("expert"),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   expert_split={n: list(a) for n, (_, a) in
                                 engine._expert.items()})
        del engine
        return out, grads[0]

    report = {"rank": rank, "variants": {}}
    ref = None
    if rank == 0:
        one = groups.ParallelTopology(groups.TopologyConfig(), world_size=1,
                                      rank=0)
        report["ref"], ref = run(base, one)
        groups.reset()
    comm.barrier()
    for tag, over in variants.items():
        got, errs = run({**base, "expert_parallel_size": 2, **over}, ref=ref)
        if rank == 0:
            got["grad_rel_norm"] = errs
        report["variants"][tag] = got
    return report


def _ep_grad_errs(engine, grads, ref):
    """Each of a step's clipped gradient leaves made whole on rank 0 alone,
    in host memory (ZeRO-1 keeps them whole but for the expert split; the
    ranks' expert shards gathered there, placed by their index along the
    split's axes) and its relative error norm against rank 0's ep = 1
    gradients ``ref`` (host): {name: error} on rank 0, None elsewhere.
    Collective over the world."""
    import torch.distributed as dist
    assert all(d is None for d, _ in engine.plan.parts["grad"].values())
    rank, world = dist.get_rank(), dist.get_world_size()
    idx = [None] * world
    dist.all_gather_object(idx, {axes: engine.topology.axis_index(axes)
                                 for _, axes in engine._expert.values()})
    errs = {}
    for n, g in grads.items():
        if n in engine._expert or rank == 0:
            g = g.float().cpu()
        if n in engine._expert:
            dim, axes = engine._expert[n]
            got = [torch.empty_like(g) for _ in range(world)] \
                if rank == 0 else None
            dist.gather(g, got, dst=0)
            if rank == 0:
                first = {}
                for r in range(world):
                    first.setdefault(idx[r][axes], r)
                g = torch.cat([got[first[i]] for i in range(len(first))],
                              dim)
            del got
        if rank == 0:
            errs[n] = rel_norm(g, ref[n])
    return errs if rank == 0 else None


# with dcn_quantize (the int8 round trip on the staged exchange's
# data_outer legs, straight-through in the backward) against ep = 1, at
# most: the loss's relative gap (read 4.0e-5 at Mixtral's widths) and the
# gradients' relative error norm (read 1.46e-2)
EP_DCN_LOSS = 2e-4
EP_DCN_BOUND = 5e-2


def phase_ep():
    """Phase 39: MoE expert parallelism, processes on cuda:0 over gloo
    (child_ep): GPT2MoE at the 350M widths (E = 4, top-2, 2 layers) and
    Mixtral-8x7B's widths (1 layer) at ep = 2, and Mixtral's staged
    exchange at data_outer 2 x expert 2 (4 processes, experts over the
    (data_outer, expert) grid, Mixtral's widths, 1 layer), with
    dcn_quantize off and on; fp32. Each run's first step against the same
    model at ep = 1 on rank 0: the loss (1e-5 relative; EP_DCN_LOSS with
    dcn_quantize), the aux loss (GPT2MoE), every gradient (relative error
    norm 1e-4; EP_DCN_BOUND with dcn_quantize); each rank's K8 launches
    equal the ep = 1 run's (the same dispatches), K12 quantize /
    dequantize 2 a layer and forward with dcn_quantize (0 otherwise); the
    host bytes each rank's exchanges stage, each step's time and its
    all_to_all / all_reduce calls and seconds logged.
    Returns the launches of each run summed over its ranks, by path
    (their K1 / K2 / K8 launches by design counted for the kernels
    line)."""
    paths = {}
    for name, (world, kind, n_layer, model_over, variants) in \
            EP_RUNS.items():
        reps = run_children(f"ep:{name}", world=world)
        ref = reps[0]["ref"]
        for tag, over in variants.items():
            dcn = bool(over.get("moe", {}).get("dcn_quantize"))
            tol = EP_DCN_LOSS if dcn else 1e-5
            got = [r["variants"][tag] for r in reps]
            for ep in got:
                assert ep["ep_size"] == 2 and ep["dp"] == world, ep
                assert abs(ep["losses"][0] - ref["losses"][0]) <= \
                    tol * abs(ref["losses"][0]), (name, tag, ep["losses"],
                                                  ref["losses"])
                if kind == "gpt2moe":
                    assert abs(ep["aux"] - ref["aux"]) <= \
                        1e-5 * abs(ref["aux"]), (name, ep["aux"], ref["aux"])
                for k8 in ("grouped_swiglu_up", "grouped_gmm",
                           "grouped_tgmm"):
                    assert ep["launches"][k8] == ref["launches"][k8], \
                        (name, tag, k8, ep["launches"], ref["launches"])
                clamps = 2 * n_layer * EP_STEPS if dcn else 0
                assert ep["launches"]["quantize_blockwise"] == clamps and \
                    ep["launches"]["dequantize_blockwise"] == clamps, \
                    (name, tag, ep["launches"])
            rels = got[0]["grad_rel_norm"]
            worst = max(rels.values())
            assert worst <= (EP_DCN_BOUND if dcn else 1e-4), \
                (name, tag, sorted(rels.items(), key=lambda t: -t[1])[:3])
            staged = [ep["staged"].get("all_to_all", [0, 0]) for ep in got]
            step, comm = got[0]["step_s"], got[0]["comm"]
            log(f"{name}{tag} (world {world}, {kind}, {n_layer} layer(s)"
                f"{', ' + json.dumps(model_over) if model_over else ''}, "
                f"fp32, experts split {got[0]['expert_split']}): loss "
                f"{got[0]['losses'][0]:.6f} vs ep = 1 {ref['losses'][0]:.6f}"
                + (f", aux {got[0]['aux']:.6f} vs {ref['aux']:.6f}"
                   if kind == "gpt2moe" else "")
                + f", worst gradient relative error norm {worst:.3g}; "
                f"launches a rank in {EP_STEPS} steps "
                f"{json.dumps(got[0]['launches'])} (ep = 1: "
                f"{json.dumps(ref['launches'])}); all_to_all staged through "
                f"host memory a rank in {EP_STEPS} steps [calls, bytes] "
                f"{staged}; steps {[round(t, 3) for t in step]} s, rank 0's "
                f"comm layer in each [calls, s] {json.dumps(comm)}; ep = 1 "
                f"steps {[round(t, 3) for t in ref['step_s']]} s; peak "
                f"allocated a rank {[round(ep['peak_gb'], 2) for ep in got]}"
                f" GB")
            paths[f"ep-{name}{tag}"] = {
                k: sum(ep["launches"][k] for ep in got)
                for k in got[0]["launches"]}
            for ep in got:
                for k, by in ep["by_design"].items():
                    count_designs(k, by)
    return paths


# ------------------------------------------------------- phases 40-43

# K1 / K2 with ALiBi (tag, B, H, T, d, dtype, design, alibi_scale,
# alibi_bf16): Bloom-7b1's attention on sm90 and, forced, on mma_sync;
# falcon-rw-1b's (32 heads of 64, HF falcon's bf16-rounded term pre-scaled
# by 1 / sqrt(d)); Bloom-7b1's shape on fp16 operands
ALIBI_CASES = (
    ("bloom-7b1", 1, 32, 2048, 128, torch.bfloat16, "sm90", 1.0, False),
    ("bloom-7b1-mma_sync", 1, 32, 2048, 128, torch.bfloat16, "mma_sync",
     1.0, False),
    ("falcon-rw-1b", 1, 32, 2048, 64, torch.bfloat16, "sm90", 0.125, True),
    ("bloom-7b1-fp16", 1, 32, 2048, 128, torch.float16, "sm90", 1.0, False))
# the new head dims at their families' widths: (tag, H, KVH, d)
HEAD_DIM_CASES = (("phi-2", 32, 32, 80), ("gpt-neox-20b", 64, 64, 96),
                  ("gpt-j-6b", 16, 16, 256))
# K4 / K5 at the GQA groups the sm90 chunk design does not take
GQA_CASES = (("falcon-7b", 71, 1, 64), ("qwen2-7b", 28, 4, 128))
# K7 at the non-gated FFN shapes: (tag, D, F)
FFN_CASES = (("bloom-7b1", 4096, 16384), ("falcon-7b", 4544, 18176))


def forced_design(fa, design, fn):
    """``fn`` with K1's and K2's design rules answering ``design``."""
    def run(*args, **kw):
        saved = fa._fwd_design, fa._bwd_design
        fa._fwd_design = lambda *_a, **_k: design
        fa._bwd_design = lambda *_a, **_k: design
        try:
            return fn(*args, **kw)
        finally:
            fa._fwd_design, fa._bwd_design = saved
    return run


def alibi_mask(fa, H, T, scale, bf16):
    """SDPA's float mask of a causal ALiBi attention: the term where a key
    is live, -inf where the causal mask cuts."""
    term = fa.alibi_term(H, T, "cuda", scale, bf16)[:, 0]     # (H, T)
    ok = fa._mask(T, True, 0, "cuda")
    return torch.where(ok[None], term[:, None, :], float("-inf"))


def flash_case(fa, tag, q, k, v, do, kw, design, mismatch, grad_mismatch,
               control):
    """K1 then K2 on (B, H, T, d) operands (scale in q) through ``design``,
    each held against its plain version in fp32 (``mismatch`` /
    ``grad_mismatch``), each call repeated bitwise; ``control(ro)`` is a
    wrong answer the check must refuse. Returns (o, lse, max |err| fwd,
    max |err| bwd, worst slab relative norm)."""
    fwd = forced_design(fa, design, fa.flash_forward)
    bwd = forced_design(fa, design, fa.flash_backward)
    fa.reset_launch_counts()
    o, lse = fwd(q, k, v, **kw)
    again = fwd(q, k, v, **kw)
    grads = bwd(q, k, v, o, lse, do, **kw)
    grads2 = bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_bwd"):
        assert fa.DESIGN_LAUNCHES[name][design] == 2, (tag, fa.DESIGN_LAUNCHES)
    assert torch.equal(o, again[0]) and all(
        torch.equal(a, b) for a, b in zip(grads, grads2)), \
        f"K1 / K2 {tag}: calls differ"
    del again, grads2
    f32 = [x.float() for x in (q, k, v, do)]
    ro, rlse = fa.flash_forward_reference(*f32[:3], **kw)
    why = mismatch(o, ro)
    assert why is None, f"flash_fwd {tag}: {why}"
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-3)
    why = mismatch(o, control(ro))
    assert why is not None, f"flash_fwd {tag}: the control passed"
    log(f"control: flash_fwd {tag} against a wrong answer fails ({why})")
    fwd_err = (o.float() - ro).abs().max().item()
    refs = fa.flash_backward_reference(*f32[:3], o.float(), lse, f32[3],
                                       **kw)
    bwd_err, rel = 0.0, 0.0
    for gname, a, r in zip(("dq", "dk", "dv"), grads, refs):
        why = grad_mismatch(a, r)
        assert why is None, f"flash_bwd {tag} {gname}: {why}"
        bwd_err = max(bwd_err, (a.float() - r).abs().max().item())
        rel = max(rel, grad_rel_norm(a, r))
    del grads, refs, ro, rlse, f32
    torch.cuda.empty_cache()
    return o, lse, fwd_err, bwd_err, rel


def flash_figures(fa, q, k, v, o, lse, do, kw, design, mask):
    """K1 / K2's figures on one case: kernel, plain and SDPA (``mask``, a
    float mask, or causal) device ms and the bounds."""
    B, H, T, d = q.shape
    fwd = forced_design(fa, design, fa.flash_forward)
    bwd = forced_design(fa, design, fa.flash_backward)
    pairs = B * H * _causal_pairs(T)
    act = B * T * H * d * q.element_size()
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))

    def sdpa(a, b, c):
        if mask is None:
            return F.scaled_dot_product_attention(a, b, c, is_causal=True,
                                                  scale=1.0)
        return F.scaled_dot_product_attention(a, b, c, attn_mask=mask,
                                              scale=1.0)
    sdpa_o = sdpa(qs, ks, vs)
    out = {}
    out["flash_fwd"] = dict(
        ms=time_ms(lambda: fwd(q, k, v, **kw), 10),
        plain_ms=time_ms(lambda: fa.flash_forward_reference(q, k, v, **kw),
                         2),
        library_ms=time_ms(lambda: sdpa(q, k, v), 10),
        bound=bound(4 * act + B * H * T * 4, 4 * d * pairs))
    out["flash_bwd"] = dict(
        ms=time_ms(lambda: bwd(q, k, v, o, lse, do, **kw), 10),
        plain_ms=time_ms(lambda: fa.flash_backward_reference(
            q, k, v, o, lse, do, **kw), 2),
        library_ms=time_ms(lambda: torch.autograd.grad(
            sdpa_o, (qs, ks, vs), do, retain_graph=True), 10),
        bound=bound(8 * act + B * H * T * 4, 10 * d * pairs))
    del sdpa_o, qs, ks, vs
    for r in out.values():
        r["bound_ms"], r["bound_by"] = r.pop("bound")
    return out


def phase_family_kernels(fa, pa, mm, seed=0):
    """Phase 40: the kernels of the seven Llama-family models at their
    shapes, each held against its plain version (bf16 / fp16 in fp32 on
    the same inputs) with a control that must fail and timed beside its
    plain version, the library call and its bound:
    K1 / K2 with ALiBi (ALIBI_CASES: the control is the plain version
    without ALiBi); K1 / K2, K4 and K5 at d = 80, 96, 256
    (HEAD_DIM_CASES: K1 / K2 on mma_sync, K5 on simt; controls: a skipped
    key tile, dropped table blocks, a table entry read as its neighbour);
    K4 / K5 at
    Falcon-7b's G = 71 and Qwen2-7B's G = 7 (GQA_CASES); K7 at Bloom-7b1's
    and Falcon-7b's non-gated FFN (FFN_CASES, int8, 8 and 256 rows;
    control: a k slice of codes zeroed). Returns {kernel: {case: figures}}
    for the kernels line."""
    from deepspeed_tpu_torch.ops import int8_weights as iw
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rs = np.random.RandomState(seed)

    def randn(shape, dt=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    rows = {n: {} for n in ("flash_fwd", "flash_bwd", "paged_decode",
                            "paged_chunk", "wq_matmul")}

    def keep(name, tag, r, err):
        r["max_abs_err"] = err
        rows[name][tag] = r
        log(f"{name} {tag}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"library {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']}), max |err| {err:.3g}")

    # K1 / K2 with ALiBi
    for tag, B, H, T, d, dt, design, a_scale, a_bf16 in ALIBI_CASES:
        kw = dict(causal=True, alibi=fa.alibi_slopes(H),
                  alibi_scale=a_scale, alibi_bf16=a_bf16)
        q, k, v, do = (randn((B, T, H, d), dt).transpose(1, 2)
                       for _ in range(4))
        q = fa.scale_q(q, 1.0 / math.sqrt(d))
        half = dt == torch.float16
        plain_no_alibi = fa.flash_forward_reference(
            q.float(), k.float(), v.float(), causal=True)[0]
        o, lse, fe, be, rel = flash_case(
            fa, tag, q, k, v, do, kw, design,
            fp16_mismatch if half else bf16_mismatch,
            fp16_grad_mismatch if half else bf16_grad_mismatch,
            lambda ro: plain_no_alibi)
        del plain_no_alibi
        figs = flash_figures(fa, q, k, v, o, lse, do, kw, design,
                             alibi_mask(fa, H, T, a_scale, a_bf16).to(dt))
        for name, err in (("flash_fwd", fe), ("flash_bwd", be)):
            figs[name].update(shape=[B, H, T, d], design=design,
                              dtype=str(dt).split(".")[-1],
                              alibi_scale=a_scale, alibi_bf16=a_bf16,
                              rel_norm=rel)
            keep(name, f"alibi-{tag}", figs[name], err)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()

    # K1 / K2 at the new head dims (the model's (B, T, H, d) strides)
    for tag, H, KVH, d in HEAD_DIM_CASES:
        B, T = 1, 2048
        kw = dict(causal=True)
        q, k, v, do = (randn((B, T, H, d)).transpose(1, 2)
                       for _ in range(4))
        q = fa.scale_q(q, 1.0 / math.sqrt(d))
        assert fa._fwd_design(q, k, v) == "mma_sync"
        o, lse, fe, be, rel = flash_case(
            fa, tag, q, k, v, do, kw, "mma_sync", bf16_mismatch,
            bf16_grad_mismatch, lambda ro: flash_with_key_tile_dropped(
                fa, q.float(), k.float(), v.float(), 1, 64))
        figs = flash_figures(fa, q, k, v, o, lse, do, kw, "mma_sync", None)
        for name, err in (("flash_fwd", fe), ("flash_bwd", be)):
            figs[name].update(shape=[B, H, T, d], design="mma_sync",
                              rel_norm=rel)
            keep(name, f"d{d}-{tag}", figs[name], err)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()

    # K4 / K5 at the new head dims and the GQA groups
    kc = KernelCases(pa, seed)
    BS = 64
    for tag, H, KVH, d in HEAD_DIM_CASES + GQA_CASES:
        B, MB = 8, 32
        lengths = rs.randint(1000, MB * BS - 1, size=B)
        pa.reset_launch_counts()
        dec = kc.decode(B, H, KVH, d, BS, MB, lengths, torch.bfloat16)
        assert pa.LAUNCHES["paged_decode"] == 1
        dropped = decode_with_blocks_dropped(pa, *(dec[x].float() for x in (
            "q", "k", "v")), dec["tables"], dec["lengths"])
        ref = pa.paged_decode_attention_reference(
            *(dec[x].float() for x in ("q", "k", "v")), dec["tables"],
            dec["lengths"])
        out = pa.paged_decode_attention(dec["q"], dec["k"], dec["v"],
                                        dec["tables"], dec["lengths"])
        why = bf16_mismatch(out, dropped)
        assert why is not None, f"paged_decode {tag}: the control passed"
        log(f"control: paged_decode {tag} against dropped blocks fails "
            f"({why})")
        gk, gv = dense_kv(dec["k"], dec["v"], dec["tables"])
        G = H // KVH
        gk, gv = (x.repeat_interleave(G, 1) for x in (gk, gv))
        kpos = torch.arange(MB * BS, device="cuda")
        live = (kpos[None] <= dec["lengths"].long()[:, None])[:, None, None]
        qd = dec["q"][:, :, None]
        n_live = int(dec["lengths"].sum().item()) + B
        r = dict(
            shape=[B, H, KVH, d, BS, MB],
            ms=time_ms(lambda: pa.paged_decode_attention(
                dec["q"], dec["k"], dec["v"], dec["tables"],
                dec["lengths"]), 20),
            plain_ms=time_ms(lambda: pa.paged_decode_attention_reference(
                dec["q"], dec["k"], dec["v"], dec["tables"],
                dec["lengths"]), 3),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qd, gk, gv, attn_mask=live), 20))
        r["bound_ms"], r["bound_by"] = bound(
            n_live * KVH * d * 2 * 2 + 2 * B * H * d * 2,
            4 * n_live * H * d)
        keep("paged_decode", f"{tag}-d{d}-G{G}", r,
             (out.float() - ref).abs().max().item())
        del dec, dropped, ref, out, gk, gv, live, qd

        C, start = 256, 1024
        MBc = (start + C) // BS
        ch = kc.chunk(H, KVH, d, BS, MBc, C, start, C, "auto",
                      torch.bfloat16, want="simt")
        # the control: block 0's keys and values read from block 1
        swapped = ch["table"].clone()
        swapped[0] = swapped[1]
        wrong = pa.paged_chunk_attention_reference(
            *(ch[x].float() for x in ("q", "k", "v")), swapped, start, C)
        out = pa.paged_chunk_attention(ch["q"], ch["k"], ch["v"],
                                       ch["table"], start, C)
        ref = pa.paged_chunk_attention_reference(
            *(ch[x].float() for x in ("q", "k", "v")), ch["table"], start, C)
        why = bf16_mismatch(out, wrong)
        assert why is not None, f"paged_chunk {tag}: the control passed"
        log(f"control: paged_chunk {tag} with table entry 0 read as entry "
            f"1 fails ({why})")
        S = start + C
        gk = ch["k"][ch["table"].long()].transpose(1, 2).reshape(
            S, KVH, d).repeat_interleave(G, 1).transpose(0, 1)[None]
        gv = ch["v"][ch["table"].long()].transpose(1, 2).reshape(
            S, KVH, d).repeat_interleave(G, 1).transpose(0, 1)[None]
        qc = ch["q"].transpose(0, 1)[None]
        cmask = (torch.arange(S, device="cuda")[None]
                 <= start + torch.arange(C, device="cuda")[:, None])
        pairs = C * start + C * (C + 1) // 2
        r = dict(
            shape=[C, H, KVH, d, BS, start],
            ms=time_ms(lambda: pa.paged_chunk_attention(
                ch["q"], ch["k"], ch["v"], ch["table"], start, C), 20),
            plain_ms=time_ms(lambda: pa.paged_chunk_attention_reference(
                ch["q"], ch["k"], ch["v"], ch["table"], start, C), 3),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qc, gk, gv, attn_mask=cmask), 20))
        r["bound_ms"], r["bound_by"] = bound(
            S * KVH * d * 2 * 2 + 2 * C * H * d * 2, 4 * pairs * H * d)
        keep("paged_chunk", f"{tag}-d{d}-G{G}", r,
             (out.float() - ref).abs().max().item())
        del ch, wrong, ref, out, gk, gv, qc, cmask
        torch.cuda.empty_cache()

    # K7 at the non-gated FFN shapes, int8
    for tag, D, Fd in FFN_CASES:
        for K, N in ((D, Fd), (Fd, D)):
            w = iw.quantize_tensor(randn((K, N), torch.float32) * 0.02, 8)
            wd = w.dequant(torch.bfloat16)
            for M in (8, 256):
                x = randn((M, K))
                mm.reset_launch_counts()
                out = mm.wq_matmul(x, w)
                assert mm.LAUNCHES["wq_matmul"] == 1
                ref = mm._plain_rows(x.float(), w)
                why = bf16_mismatch(out, ref.float())
                assert why is None, f"wq_matmul {tag} {M}x{K}x{N}: {why}"
                cut = iw.Int8Weight(w.q.clone(), w.scale)
                cut.q[:64] = 0
                why = bf16_mismatch(out, mm._plain_rows(x.float(), cut))
                assert why is not None, f"wq_matmul {tag}: control passed"
                r = dict(
                    shape=[M, K, N], bits=8,
                    ms=time_queued(lambda: mm.wq_matmul(x, w), 20)[0],
                    plain_ms=time_ms(lambda: mm._plain_rows(x, w), 5),
                    library_ms=time_ms(lambda: torch.matmul(x, wd), 20))
                r["bound_ms"], r["bound_by"] = wq_bound(M, K, N, 8)
                keep("wq_matmul", f"{tag}-{M}x{K}x{N}", r,
                     (out.float() - ref.float()).abs().max().item())
                del x, out, ref, cut
            log(f"control: wq_matmul {tag} {K}x{N} with a k slice of codes "
                f"zeroed fails")
            del w, wd
    torch.cuda.empty_cache()
    return rows


# phases 41-43: the families' serving and training runs
# phase 41 serves at 15 of Bloom-7b1's 30 layers (the run's time limit:
# since PR 27)
BLOOM_SERVE = dict(requests=8, new=64, parity_layers=2, parity_new=16,
                   layers=15)
BLOOM_TRAIN = dict(layers=8, T=2048, steps=10, parity_layers=2,
                   parity_T=512)
FAMILY_SERVE = dict(layers=4, requests=4, new=32)
# the six other families at their published widths (models/*.py presets)
FAMILY_PRESETS = (("falcon", "FALCON_PRESETS", "falcon-7b"),
                  ("gpt_neox", "GPTNEOX_PRESETS", "gpt-neox-20b"),
                  ("gptj", "GPTJ_PRESETS", "gpt-j-6b"),
                  ("internlm", "INTERNLM_PRESETS", "internlm-7b"),
                  ("phi", "PHI_PRESETS", "phi-2"),
                  ("qwen", "QWEN_PRESETS", "qwen2-7b"))


def serve_family(model, cfg, requests, new, rs, tag):
    """Serve ``requests`` random prompts (64 .. max_seq_len - new tokens,
    split-fuse 256, 8 decode steps a dispatch) on ``model`` in bf16 and
    return (stats, the paged launches, their designs). The launches must
    be what the forwards imply: K4 a layer each decode forward, K5 a layer
    each chunk or prefill forward unless the family runs ALiBi (dense
    prefill / chunk, JAX llama.py:702-703, :785-786)."""
    from deepspeed_tpu_torch import InferenceEngineV2
    from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
    eng = InferenceEngineV2(model, dict(
        dtype="bfloat16", kv_block_size=64, max_batch_size=8,
        splitfuse_tokens=256, decode_steps_per_dispatch=8), device="cuda")
    lens = rs.randint(64, cfg.max_seq_len - new + 1, requests)
    lens = np.minimum(lens, 2048)
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
    for k in eng.forward_counts:
        eng.forward_counts[k] = 0
    t_start = time.perf_counter()
    uids = [eng.put(rs.randint(0, cfg.vocab_size, (n,)), new) for n in lens]
    first, done = serve(eng, uids)
    e2e = time.perf_counter() - t_start
    launches = dict(pa.LAUNCHES)
    designs = {k: dict(v) for k, v in pa.DESIGN_LAUNCHES.items()}
    outs = [eng.get(u) for u in uids]
    for u, o in zip(uids, outs):
        assert len(o) == new and ((o >= 0) & (o < cfg.vocab_size)).all(), \
            (tag, u)
    fc = eng.forward_counts
    L = cfg.n_layer
    want = {"paged_decode": L * fc["decode"],
            "paged_chunk": 0 if cfg.alibi else L * (fc["chunk"]
                                                     + fc["prefill"])}
    assert launches == want and launches["paged_decode"] > 0, \
        (tag, launches, want)
    assert sum(designs["paged_decode"].values()) == want["paged_decode"]
    assert sum(designs["paged_chunk"].values()) == want["paged_chunk"]
    for name in ("paged_decode", "paged_chunk"):
        count_designs(name, designs[name])
    ttft = sorted(first[u] - t_start for u in uids)
    tpot = sorted((done[u] - first[u]) / (new - 1) for u in uids)
    stats = dict(
        family=tag, n_layer=L, d_head=cfg.d_head,
        G=cfg.n_head // cfg.n_kv_heads, requests=len(uids),
        prompt_tokens=int(lens.sum()),
        generated_tokens=int(sum(len(o) for o in outs)),
        ttft_p50_s=float(np.percentile(ttft, 50)),
        tpot_p50_ms=float(np.percentile(tpot, 50)) * 1e3,
        output_tok_per_s=float(sum(len(o) for o in outs) / e2e),
        e2e_s=e2e, forwards=dict(fc), launches=launches,
        launches_by_design={k: {d: n for d, n in v.items() if n}
                            for k, v in designs.items()},
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    del eng
    return stats, launches


def phase_bloom_serve(seed=0):
    """Phase 41: Bloom-7b1. First its fp32 greedy streams at its widths
    and BLOOM_SERVE["parity_layers"] layers with K4 on (the slopes in the
    kernel) equal the streams with K4's plain version in its place (ALiBi
    families take K4 whatever paged_kernel says, so the plain version is
    swapped in by name); then BLOOM_SERVE["layers"] of its 30 layers in
    bf16 serving 8 requests:
    TTFT / TPOT p50, tokens/s, peak memory and K4 launches by design.
    Returns the serving run's launches."""
    from deepspeed_tpu_torch import BLOOM_PRESETS, Bloom, InferenceEngineV2
    from deepspeed_tpu_torch.models import llama as tl
    from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
    gc.collect()
    torch.cuda.empty_cache()
    base = BLOOM_PRESETS["bloom-7b1"]
    rs = np.random.RandomState(seed)
    cfg = dataclasses.replace(base, n_layer=BLOOM_SERVE["parity_layers"],
                              dtype="float32")
    model = Bloom(cfg, device="cuda", dtype=torch.float32, seed=seed)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)) for n in (7, 64, 300)]
    streams = {}
    for on in (True, False):
        pa.reset_launch_counts()
        saved = tl.paged_decode_attention
        if not on:
            tl.paged_decode_attention = tl.paged_decode_attention_reference
        try:
            eng = InferenceEngineV2(model, dict(
                dtype="float32", kv_block_size=64, max_batch_size=4,
                splitfuse_tokens=256), device="cuda")
            streams[on] = eng.generate_all(
                prompts, max_new_tokens=BLOOM_SERVE["parity_new"])
        finally:
            tl.paged_decode_attention = saved
        assert (pa.LAUNCHES["paged_decode"] > 0) == on, dict(pa.LAUNCHES)
        assert pa.LAUNCHES["paged_chunk"] == 0, dict(pa.LAUNCHES)
        del eng
    for a, b in zip(streams[True], streams[False]):
        np.testing.assert_array_equal(a, b)
    log(f"phase 41 parity ok: Bloom-7b1 widths at {cfg.n_layer} layers, "
        f"fp32, K4 with ALiBi on == its plain version, "
        f"{sum(len(x) for x in streams[True])} tokens")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    base = dataclasses.replace(base, n_layer=BLOOM_SERVE["layers"])
    model = Bloom(base, device="cuda", dtype=torch.bfloat16, seed=seed)
    torch.cuda.synchronize()
    log(f"bloom-7b1 built in {time.perf_counter() - t0:.1f} s: "
        f"{base.num_params() / 1e9:.3f}B params, {base.n_layer} layers")
    stats, launches = serve_family(model, base, BLOOM_SERVE["requests"],
                                   BLOOM_SERVE["new"], rs, "bloom-7b1")
    log("phase 41 slice " + json.dumps(stats))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_bloom_train(seed=0):
    """Phase 42: Bloom-7b1 training. First at its widths and 2 layers in
    fp32, T = 512: the loss and every gradient with the kernels on (K1 /
    K2 with the slopes in the kernels, whole-block remat) equal the dense
    path's (loss 1e-5 relative, each gradient's relative error norm
    1e-4); then at its widths and 8 of its 30 layers in bf16 through
    initialize -> train_batch (AdamW, clip 1.0, ZeRO-2, micro 1 x 2048,
    flash attention carrying ALiBi), 10 steps on one fixed batch: the
    loss falls, K1 / K2 launch exactly as the step implies, all on sm90;
    step time, tokens/s, model TFLOP/s (``flops_per_token``, the biases
    counted) and peak memory. Returns the launch counts."""
    from deepspeed_tpu_torch import BLOOM_PRESETS, Bloom, initialize
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import fused_ce as fce
    from deepspeed_tpu_torch.ops.cuda import grouped_matmul as gm
    gc.collect()
    torch.cuda.empty_cache()
    base = BLOOM_PRESETS["bloom-7b1"]
    Tp = BLOOM_TRAIN["parity_T"]
    ids = torch.from_numpy(np.random.RandomState(seed).randint(
        0, base.vocab_size, (1, Tp))).cuda()
    out = {}
    for on in (True, False):
        cfg = dataclasses.replace(
            base, n_layer=BLOOM_TRAIN["parity_layers"], max_seq_len=Tp,
            dtype="float32", use_flash_attention=on, remat=on)
        model = Bloom(cfg, device="cuda", seed=seed)
        fa.reset_launch_counts()
        loss = model.loss({"input_ids": ids})
        loss.backward()
        torch.cuda.synchronize()
        L = cfg.n_layer
        want = {"flash_fwd": 2 * L if on else 0, "flash_bwd": L if on else 0,
                "flash_bwd_qmajor": 0, "flash_block_fwd": 0}
        assert fa.LAUNCHES == want, (on, fa.LAUNCHES, want)
        if on:
            assert fa.DESIGN_LAUNCHES["flash_fwd"]["fp32"] == 2 * L
        out[on] = (loss.item(), {n: p.grad for n, p in
                                 model.named_parameters()})
        del model
    (l_on, g_on), (l_off, g_off) = out[True], out[False]
    assert abs(l_on - l_off) <= 1e-5 * abs(l_off), (l_on, l_off)
    worst = 0.0
    norm = torch.linalg.vector_norm
    for n, gr in g_off.items():
        # the key bias's gradient is zero in exact arithmetic (it shifts
        # each query's scores by one constant, softmax is shift invariant
        # and ALiBi takes no rotary): both sides are rounding residue, so
        # the difference is held against the query bias's gradient norm
        scale = norm(g_off["blocks.bq"]) if n == "blocks.bk" else norm(gr)
        rel = (norm(g_on[n] - gr) / scale).item()
        assert rel <= 1e-4, (n, rel, norm(gr).item(), scale.item())
        worst = max(worst, rel)
    log(f"phase 42 parity: the key bias's gradient norm "
        f"{norm(g_off['blocks.bk']).item():.3g} (off) / "
        f"{norm(g_on['blocks.bk']).item():.3g} (on) against the query "
        f"bias's {norm(g_off['blocks.bq']).item():.3g}")
    log(f"phase 42 parity ok: Bloom-7b1 widths at 2 layers, fp32, T = "
        f"{Tp}: K1 / K2 with ALiBi vs dense, loss {l_on:.7f} vs "
        f"{l_off:.7f}, worst gradient relative error norm {worst:.3g}")
    del out, g_on, g_off
    gc.collect()
    torch.cuda.empty_cache()

    T, steps = BLOOM_TRAIN["T"], BLOOM_TRAIN["steps"]
    cfg = dataclasses.replace(base, n_layer=BLOOM_TRAIN["layers"],
                              max_seq_len=T, use_flash_attention=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, *_ = initialize(
        model=Bloom(cfg, device="cuda", seed=seed),
        config=zero_config(2, train_micro_batch_size_per_gpu=1))
    torch.cuda.synchronize()
    built = torch.cuda.memory_allocated()
    log(f"bloom-7b1-train engine built in {time.perf_counter() - t0:.1f} s: "
        f"{cfg.num_params() / 1e9:.3f} B params ({cfg.n_layer} layers), "
        f"micro 1 x {T}, {built / 1e9:.2f} GB allocated")
    batch = {"input_ids": np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (1, T)).astype(np.int32)}
    for mod in (fa, fce, gm):
        mod.reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    launches = {**fa.LAUNCHES, **fce.LAUNCHES, **gm.LAUNCHES}
    want = llama_train_launches(cfg, steps)
    assert launches == want, (launches, want)
    assert_sm90("bloom train slice", fa, main_path=True)
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    step_s = float(np.median(times[1:]))
    stats = dict(
        kind="bloom-7b1", n_layer=cfg.n_layer, params=cfg.num_params(),
        steps=steps, losses=losses, step_s=times,
        step_s_median_after_first=step_s, tokens_per_s=T / step_s,
        flops_per_token=cfg.flops_per_token(),
        model_tflops_per_s=cfg.flops_per_token() * T / step_s / 1e12,
        launches_per_step={k: v // steps for k, v in launches.items() if v},
        memory_after_build_gb=built / 1e9,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("phase 42 slice " + json.dumps(stats))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_family_serve(seed=0):
    """Phase 43: the six other families at their published widths and
    FAMILY_SERVE["layers"] layers each, bf16, serving a few requests
    (serve_family): TPOT and each paged kernel's launches by design; the
    run on the card of K4 / K5 at d = 64 (Falcon-7b, G = 71), 80 (Phi-2),
    96 (GPT-NeoX-20B), 256 (GPT-J-6B) and 128 (InternLM-7B; Qwen2-7B at G
    = 7). Returns {family: launches}."""
    import deepspeed_tpu_torch as ds
    rs = np.random.RandomState(seed)
    out = {}
    for mod, presets, preset in FAMILY_PRESETS:
        gc.collect()
        torch.cuda.empty_cache()
        cls_name = {"falcon": "Falcon", "gpt_neox": "GPTNeoX",
                    "gptj": "GPTJ", "internlm": "InternLM", "phi": "Phi",
                    "qwen": "Qwen"}[mod]
        cfg = dataclasses.replace(getattr(ds, presets)[preset],
                                  n_layer=FAMILY_SERVE["layers"])
        t0 = time.perf_counter()
        model = getattr(ds, cls_name)(cfg, device="cuda",
                                      dtype=torch.bfloat16, seed=seed)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        stats, launches = serve_family(model, cfg, FAMILY_SERVE["requests"],
                                       FAMILY_SERVE["new"], rs, preset)
        stats["build_s"] = build_s
        log("phase 43 slice " + json.dumps(stats))
        out[f"{preset}-serve"] = launches
        del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# phases 44-46: the GPT-2 family (GPT-2, OPT, GPT-Neo)
# K4 / K5 at the family's attention: (tag, H = KVH, d, scale (None: 1 /
# sqrt(d)), window, table blocks of 64 positions a sequence)
GPT2_ATTN_CASES = (("gpt2-1.3b", 32, 64, None, 0, 20),
                   ("gpt-neo-1.3b-w256", 16, 128, 1.0, 256, 32),
                   ("gpt-neo-1.3b-w0", 16, 128, 1.0, 0, 32))
# K5's three uses: (variant, C, start); true_len = C
GPT2_CHUNK_CASES = (("prefill", 512, 0), ("chunk", 256, 1024),
                    ("verify", 5, 1200))
# K7 at GPT-2 1.3B's FFN: (leaf, K, N)
GPT2_FFN_CASES = (("wup", 2048, 8192), ("wdown", 8192, 2048))
# phase 45's serving runs at 12 of GPT-2 1.3B's 24 layers (the run's time
# limit: since PR 27)
GPT2_SERVE = dict(requests=8, new=32, parity_layers=2, parity_new=8,
                  layers=12)
# phase 46's serving runs at 12 of the 24 layers (the run's time limit:
# since PR 27)
GPT2_FAMILY_SERVE = dict(requests=8, new=32, min_prompt=300, layers=12)
GPTNEO_TRAIN = dict(layers=4, T=2048, steps=2, loss_chunk=512)


def _visible(q_pos, k_pos, lengths_or_end, window):
    """Keys a query sees: causal, below the sequence's end, inside the
    window (0 = global)."""
    ok = (k_pos <= q_pos) & (k_pos < lengths_or_end)
    if window:
        ok = ok & (q_pos - k_pos < window)
    return ok


def phase_gpt2_family_kernels(pa, mm, fce, seed=0):
    """Phase 44: the kernels of the GPT-2 family's paths at its shapes, in
    bf16, each held against its plain version run in fp32 on the same
    inputs (bf16_mismatch), repeated bitwise, with a control that must
    fail, and timed beside its plain version, the library call and its
    bound: K4 (8 slots) and K5 (a 512-token prefill at start 0, a
    256-token chunk at start 1024, a 5-token verify at start 1200) at
    GPT-2 1.3B's H = KVH 32, d 64 and at GPT-Neo-1.3B's H 16, d 128 with
    unscaled scores (scale 1.0), window 256 and 0 (GPT2_ATTN_CASES;
    control: each sequence's newest block read through another table
    entry; library: SDPA over the gathered keys with the causal / window
    mask); K7 int8 and int4 on GPT-2 1.3B's wup (2048 -> 8192) and wdown
    (8192 -> 2048) at 8 and 256 rows (control: a k slice of codes zeroed;
    library: torch.matmul on the dequantized weight); K3 at GPT-Neo's odd
    vocabulary 50257 (one 512-token loss chunk; control: each row's
    target tile skipped; library: cuBLAS h @ w^T). Returns {kernel:
    {case: figures}} for the kernels line."""
    from deepspeed_tpu_torch.ops import int8_weights as iw
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    rs = np.random.RandomState(seed + 44)

    def randn(shape, dt=torch.bfloat16, s=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * s).to(dt)

    rows = {n: {} for n in ("paged_decode", "paged_chunk", "wq_matmul",
                            "fused_ce")}

    def keep(name, tag, r, err):
        r["max_abs_err"] = err
        rows[name][tag] = r
        log(f"{name} {tag}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, "
            f"library {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']}), design {r['design']}, max |err| {err:.3g}")

    def designs(name):
        return {k: v for k, v in pa.DESIGN_LAUNCHES[name].items() if v}

    BS, B = 64, 8
    for tag, H, d, scale, window, MB in GPT2_ATTN_CASES:
        s = 1.0 / math.sqrt(d) if scale is None else scale
        kw = dict(scale=scale, window=window)
        NB = 1 + B * MB
        k, v = randn((NB, H, BS, d)), randn((NB, H, BS, d))
        k32, v32 = k.float(), v.float()

        # K4: 8 slots at random lengths
        tables = torch.from_numpy(rs.permutation(np.arange(1, NB))[
            :B * MB].reshape(B, MB).astype(np.int32)).cuda()
        lengths = torch.from_numpy(rs.randint(
            300, MB * BS - 1, B).astype(np.int32)).cuda()
        q = randn((B, H, d))
        pa.reset_launch_counts()
        out = pa.paged_decode_attention(q, k, v, tables, lengths, **kw)
        again = pa.paged_decode_attention(q, k, v, tables, lengths, **kw)
        torch.cuda.synchronize()
        assert pa.LAUNCHES["paged_decode"] == 2, dict(pa.LAUNCHES)
        assert torch.equal(out, again), f"paged_decode {tag}: calls differ"
        design = designs("paged_decode")
        ref = pa.paged_decode_attention_reference(q.float(), k32, v32,
                                                  tables, lengths, **kw)
        why = bf16_mismatch(out, ref)
        assert why is None, f"paged_decode {tag}: {why}"
        cur = (lengths.long() // BS)
        rows_b = torch.arange(B, device="cuda")
        wrong = tables.clone()
        wrong[rows_b, cur] = tables[rows_b, (cur + 1) % MB]
        why = bf16_mismatch(out, pa.paged_decode_attention_reference(
            q.float(), k32, v32, wrong, lengths, **kw))
        assert why is not None, f"paged_decode {tag}: the control passed"
        log(f"control: paged_decode {tag} with each slot's newest block "
            f"read through another entry fails ({why})")
        gk, gv = dense_kv(k, v, tables)
        kpos = torch.arange(MB * BS, device="cuda")
        live = _visible(lengths.long()[:, None], kpos[None],
                        lengths.long()[:, None] + 1, window)
        n_live = int(live.sum().item())
        mask = live[:, None, None]
        qd = q[:, :, None]
        r = dict(
            shape=[B, H, d, BS, MB], scale=s, window=window, design=design,
            ms=time_queued(lambda: pa.paged_decode_attention(
                q, k, v, tables, lengths, **kw), 20)[0],
            plain_ms=time_ms(lambda: pa.paged_decode_attention_reference(
                q, k, v, tables, lengths, **kw), 3),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qd, gk, gv, attn_mask=mask, scale=s), 20))
        r["bound_ms"], r["bound_by"] = bound(
            n_live * H * d * 2 * 2 + 2 * B * H * d * 2, 4 * n_live * H * d)
        keep("paged_decode", tag, r, (out.float() - ref).abs().max().item())
        del out, again, ref, gk, gv, live, mask, qd, q

        # K5: prefill, chunk, verify of one sequence
        for variant, C, start in GPT2_CHUNK_CASES:
            MBc = -(-(start + C) // BS)
            table = torch.from_numpy(rs.permutation(np.arange(1, NB))[
                :MBc].astype(np.int32)).cuda()
            qc = randn((C, H, d))
            pa.reset_launch_counts()
            out = pa.paged_chunk_attention(qc, k, v, table, start, C, **kw)
            again = pa.paged_chunk_attention(qc, k, v, table, start, C,
                                             **kw)
            torch.cuda.synchronize()
            design = designs("paged_chunk")
            assert design == {"sm90": 2}, (tag, variant, design)
            assert torch.equal(out, again), \
                f"paged_chunk {tag} {variant}: calls differ"
            ref = pa.paged_chunk_attention_reference(
                qc.float(), k32, v32, table, start, C, **kw)
            why = bf16_mismatch(out, ref)
            assert why is None, f"paged_chunk {tag} {variant}: {why}"
            last = (start + C - 1) // BS
            wrong = table.clone()
            wrong[last] = table[last - 1]
            why = bf16_mismatch(out, pa.paged_chunk_attention_reference(
                qc.float(), k32, v32, wrong, start, C, **kw))
            assert why is not None, \
                f"paged_chunk {tag} {variant}: the control passed"
            log(f"control: paged_chunk {tag} {variant} with its last block "
                f"read as its neighbour fails ({why})")
            S = MBc * BS
            tl = table.long()
            gk = k[tl].transpose(1, 2).reshape(S, H, d).transpose(0, 1)[None]
            gv = v[tl].transpose(1, 2).reshape(S, H, d).transpose(0, 1)[None]
            qpos = start + torch.arange(C, device="cuda")[:, None]
            kpos = torch.arange(S, device="cuda")[None]
            cmask = _visible(qpos, kpos, start + C, window)
            pairs = int(cmask.sum().item())
            k_lo = max(0, start - window + 1) if window else 0
            qq = qc.transpose(0, 1)[None]
            r = dict(
                shape=[C, H, d, BS, start], variant=variant, scale=s,
                window=window, design=design,
                ms=time_queued(lambda: pa.paged_chunk_attention(
                    qc, k, v, table, start, C, **kw), 20)[0],
                plain_ms=time_ms(lambda: pa.paged_chunk_attention_reference(
                    qc, k, v, table, start, C, **kw), 3),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qq, gk, gv, attn_mask=cmask, scale=s), 20))
            r["bound_ms"], r["bound_by"] = bound(
                (start + C - k_lo) * H * d * 2 * 2 + 2 * C * H * d * 2,
                4 * pairs * H * d)
            keep("paged_chunk", f"{tag}-{variant}", r,
                 (out.float() - ref).abs().max().item())
            del out, again, ref, gk, gv, qq, cmask, qc
        del k, v, k32, v32
        torch.cuda.empty_cache()

    # K7 on GPT-2 1.3B's FFN, int8 and int4, decode and chunk rows
    for leaf, K, N in GPT2_FFN_CASES:
        wf = randn((K, N), torch.float32, s=0.02)
        for bits in (8, 4):
            w = iw.quantize_tensor(wf, bits)
            wd = w.dequant(torch.bfloat16)
            for M in (8, 256):
                x = randn((M, K))
                mm.reset_launch_counts()
                out = mm.wq_matmul(x, w)
                again = mm.wq_matmul(x, w)
                torch.cuda.synchronize()
                assert mm.LAUNCHES["wq_matmul"] == 2
                assert torch.equal(out, again), f"wq_matmul {leaf}: differ"
                design = {k_: n for k_, n in
                          mm.DESIGN_LAUNCHES["wq_matmul"].items() if n}
                ref = mm._plain_rows(x.float(), w)
                why = bf16_mismatch(out, ref.float())
                assert why is None, f"wq_matmul {leaf} {M} int{bits}: {why}"
                cut = type(w)(w.q.clone(), w.scale)
                cut.q[:64 if bits == 8 else 32] = 0
                why = bf16_mismatch(out, mm._plain_rows(x.float(), cut))
                assert why is not None, \
                    f"wq_matmul {leaf} int{bits}: the control passed"
                r = dict(
                    shape=[M, K, N], bits=bits, design=design,
                    ms=time_queued(lambda: mm.wq_matmul(x, w), 20)[0],
                    plain_ms=time_ms(lambda: mm._plain_rows(x, w), 5),
                    library_ms=time_ms(lambda: torch.matmul(x, wd), 20))
                r["bound_ms"], r["bound_by"] = wq_bound(M, K, N, bits)
                keep("wq_matmul", f"gpt2-1.3b-{leaf}-{M}-int{bits}", r,
                     (out.float() - ref.float()).abs().max().item())
                del x, out, again, ref, cut
            log(f"control: wq_matmul {leaf} int{bits} with a k slice of "
                f"codes zeroed fails")
            del w, wd
        del wf

    # K3 at GPT-Neo's odd vocabulary (its scalar-store epilogue: V % 8)
    N, D, V = GPTNEO_TRAIN["loss_chunk"], 2048, 50257
    h, w = randn((N, D)), randn((V, D), s=0.02)
    t = torch.randint(0, V, (N,), generator=g, device="cuda")
    fce.reset_launch_counts()
    got = fce.unembed_logits_stats(h, w, t)
    again = fce.unembed_logits_stats(h, w, t)
    torch.cuda.synchronize()
    assert fce.DESIGN_LAUNCHES["fused_ce"] == {"sm90": 2, "fp32": 0}, \
        dict(fce.DESIGN_LAUNCHES["fused_ce"])
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "fused_ce at V = 50257: calls differ"
    ref = fce.unembed_logits_stats_reference(h.float(), w.float(), t)
    why = bf16_mismatch(got[0], ref[0])
    assert why is None, f"fused_ce logits V={V}: {why}"
    stat_err = max((a - b).abs().max().item()
                   for a, b in zip(got[1:], ref[1:]))
    assert stat_err <= CE_STAT_ATOL, f"fused_ce stats V={V}: {stat_err:.3g}"
    tile = t // fce.SM90_BLOCK_V
    col = torch.arange(V, device="cuda")
    skip = (col[None, :] // fce.SM90_BLOCK_V) == tile[:, None]
    ctrl = (torch.logsumexp(ref[0].masked_fill(skip, -1e30), dim=-1)
            - ref[1]).abs().max().item()
    assert ctrl > CE_STAT_ATOL, "CE check let a skipped vocab tile pass"
    log(f"control: fused CE at V={V} with each row's target tile skipped "
        f"fails (max |err| {ctrl:.3g} > {CE_STAT_ATOL})")
    r = dict(shape=[N, D, V], design={"sm90": 1}, stat_max_abs_err=stat_err,
             ms=time_ms(lambda: fce.unembed_logits_stats(h, w, t), 10),
             plain_ms=time_ms(lambda: fce.unembed_logits_stats_reference(
                 h, w, t), 3),
             library_ms=time_ms(lambda: torch.mm(h, w.t()), 10))
    r["bound_ms"], r["bound_by"] = bound(
        (N * D + V * D + N * V) * 2 + 3 * N * 4, 2 * N * V * D)
    keep("fused_ce", "gpt-neo-1.3b-V50257", r,
         (got[0].float() - ref[0]).abs().max().item())
    del h, w, got, again, ref, skip, col
    torch.cuda.empty_cache()
    return rows


def gpt2_serve_run(eng, prompts, new, pa, mm, L, draft_L=0):
    """serve_run with the GPT-2 family's launch gates: K4 / K5 as the
    forwards imply (count_paged_designs: every chunk launch on sm90), K7
    two a layer and forward under weight_quant (all sm90), none without.
    Returns (streams, stats with the launches by design, launches)."""
    mm.reset_launch_counts()
    outs, stats, launches = serve_run(eng, prompts, new, pa)
    assert launches == expected_launches(eng, L, draft_L), launches
    count_paged_designs(pa, launches)
    fc = eng.forward_counts
    wq = 2 * L * sum(fc.values()) if eng.model._weight_quant_fused else 0
    assert mm.LAUNCHES["wq_matmul"] == wq, (mm.LAUNCHES["wq_matmul"], wq)
    assert_sm90("gpt2 family serve", mm, main_path=True)
    launches["wq_matmul"] = mm.LAUNCHES["wq_matmul"]
    stats["launches"] = launches
    stats["launches_by_design"] = {
        "paged_decode": {k: v for k, v in pa.DESIGN_LAUNCHES[
            "paged_decode"].items() if v},
        "paged_chunk": {k: v for k, v in pa.DESIGN_LAUNCHES[
            "paged_chunk"].items() if v},
        "wq_matmul": {k: v for k, v in mm.DESIGN_LAUNCHES[
            "wq_matmul"].items() if v}}
    for o in outs:
        assert ((o >= 0) & (o < eng.model.config.vocab_size)).all()
    assert pools_full(eng)
    return outs, stats, launches


def phase_gpt2_serve(pa, mm, seed=0):
    """Phase 45: GPT-2 1.3B serving. (0) At its widths and
    GPT2_SERVE["parity_layers"] layers in fp32, greedy streams: the paged
    kernels on (K4 / K5) equal their plain versions (paged_kernel=False),
    bucketed and split-fuse; weight_quant int8 and int4 (K7 on wup / wdown)
    equal the same model's dequantized weights served unquantized; the
    same for GPT-Neo-1.3B's widths (unscaled scores, windows 0 / 256) at 2
    layers. Then GPT2_SERVE["layers"] of its 24 layers in bf16, 8 requests
    of 64-992 tokens, 32 new each (64-position blocks, batch 8, split-fuse
    256, 8 decode steps a dispatch): bf16, weight_quant int8, weight_quant
    int4 (2-D leaves
    quantized over L: bqkv, bup), and speculative decoding with GPT-2 125M
    as the draft (with bucketed prefill, against plain decode with
    bucketed prefill): TTFT / TPOT p50, tokens/s, peak memory, K4 / K5 /
    K7 launches by design; the draft's tokens a verify and TPOT against
    plain decode. Returns {path: launches}."""
    from deepspeed_tpu_torch import GPT2, GPT2_PRESETS, InferenceEngineV2
    from deepspeed_tpu_torch import GPTNEO_PRESETS, GPTNeo
    gc.collect()
    torch.cuda.empty_cache()
    rs = np.random.RandomState(seed + 45)
    P = GPT2_SERVE
    for cls, base in ((GPT2, GPT2_PRESETS["1.3B"]),
                      (GPTNeo, GPTNEO_PRESETS["gpt-neo-1.3b"])):
        cfg = dataclasses.replace(base, n_layer=P["parity_layers"],
                                  dtype="float32")
        if cfg.attn_layer_windows:
            cfg = dataclasses.replace(cfg, attn_layer_windows=(0, 256))
        prompts = [rs.randint(0, cfg.vocab_size, (n,)) for n in (7, 64, 300)]
        model = cls(cfg, device="cuda", dtype=torch.float32, seed=seed)
        conf = dict(dtype="float32", kv_block_size=64, max_batch_size=4)
        for splitfuse in (256, 0):
            streams = {}
            for on in (True, False):
                pa.reset_launch_counts()
                eng = InferenceEngineV2(model, dict(
                    conf, splitfuse_tokens=splitfuse, paged_kernel=on),
                    device="cuda")
                streams[on] = eng.generate_all(prompts,
                                               max_new_tokens=P["parity_new"])
                assert (pa.LAUNCHES["paged_decode"] > 0) == on, \
                    dict(pa.LAUNCHES)
                assert (pa.LAUNCHES["paged_chunk"] > 0) == on, \
                    dict(pa.LAUNCHES)
                del eng
            for a, b in zip(streams[True], streams[False]):
                np.testing.assert_array_equal(a, b)
        for mode in ("int8", "int4"):
            quant = cls(cfg, device="cuda", dtype=torch.float32, seed=seed)
            quant.quantize_(mode)
            plain = dequantized_copy(quant, cls, cfg)
            streams = {}
            for tag, m, wq in (("wq", quant, mode), ("plain", plain, "auto")):
                mm.reset_launch_counts()
                eng = InferenceEngineV2(m, dict(
                    conf, splitfuse_tokens=256, weight_quant=wq),
                    device="cuda")
                streams[tag] = eng.generate_all(
                    prompts, max_new_tokens=P["parity_new"])
                want = 2 * cfg.n_layer * sum(eng.forward_counts.values())
                assert mm.LAUNCHES["wq_matmul"] == (
                    want if tag == "wq" else 0), (tag, dict(mm.LAUNCHES))
                del eng
            for a, b in zip(streams["wq"], streams["plain"]):
                np.testing.assert_array_equal(a, b)
            del quant, plain
        log(f"phase 45 parity ok: {cls.__name__} widths at {cfg.n_layer} "
            f"layers, fp32: K4 / K5 on == off (split-fuse 256 and "
            f"bucketed), weight_quant int8 / int4 (K7) == the dequantized "
            f"weights served unquantized")
        del model
        gc.collect()
        torch.cuda.empty_cache()

    cfg = dataclasses.replace(GPT2_PRESETS["1.3B"], n_layer=P["layers"])
    L = cfg.n_layer
    lens = rs.randint(64, cfg.max_seq_len - P["new"] + 1, P["requests"])
    prompts = [rs.randint(0, cfg.vocab_size, (n,)) for n in lens]
    base = dict(dtype="bfloat16", kv_block_size=64, max_batch_size=8,
                splitfuse_tokens=256, decode_steps_per_dispatch=8)
    paths = {}
    bf16_outs = None
    for mode in ("bf16", "int8", "int4"):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = GPT2(cfg, device="cuda", dtype=torch.bfloat16, seed=seed)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        wq = "auto" if mode == "bf16" else mode
        eng = InferenceEngineV2(model, dict(base, weight_quant=wq),
                                device="cuda")
        outs, stats, launches = gpt2_serve_run(eng, prompts, P["new"], pa,
                                               mm, L)
        stats.update(model="gpt2-1.3b", mode=mode, n_layer=L,
                     build_s=build_s, prompt_tokens=int(lens.sum()),
                     quantized_leaves=sorted(model.qblocks),
                     weight_gb=sum(
                         p.numel() * p.element_size()
                         for p in model.parameters()) / 1e9 + sum(
                         w.q.numel() + 4 * w.scale.numel()
                         for w in model.qblocks.values()) / 1e9)
        if mode != "bf16":
            # at 1.3B the (L, 3D) and (L, F) biases pass min_size and are
            # quantized over L (one (1, N) scale, layer_slice's rule)
            assert {"bqkv", "bup", "wqkv", "wo", "wup", "wdown"} <= set(
                model.qblocks), sorted(model.qblocks)
            stats["streams_equal_bf16"] = sum(
                int(np.array_equal(a, b)) for a, b in zip(outs, bf16_outs))
        paths[f"gpt2-1.3b-{mode}-serve"] = launches
        if mode == "bf16":
            bf16_outs = outs
        log("phase 45 slice " + json.dumps(stats))
        if mode == "bf16":
            # speculative decoding: GPT-2 125M (the same vocabulary) drafts.
            # Bucketed prefill, so all 8 prefill at admission and every
            # decode dispatch can speculate (while a split-fuse prefill is
            # queued, dispatches decode plainly), against plain decode
            # under the same schedule
            bucketed = dict(base, splitfuse_tokens=0)
            eng = InferenceEngineV2(model, bucketed, device="cuda")
            outs, stats, launches = gpt2_serve_run(eng, prompts, P["new"],
                                                   pa, mm, L)
            stats.update(model="gpt2-1.3b", mode="bf16 bucketed prefill")
            paths["gpt2-1.3b-bucketed-serve"] = launches
            log("phase 45 slice " + json.dumps(stats))
            plain = (outs, stats)
            draft = GPT2(GPT2_PRESETS["125M"], device="cuda",
                         dtype=torch.bfloat16, seed=seed + 1)
            eng = InferenceEngineV2(model, bucketed, device="cuda",
                                    draft_model=draft)
            got, stats, launches = gpt2_serve_run(
                eng, prompts, P["new"], pa, mm, L,
                draft_L=GPT2_PRESETS["125M"].n_layer)
            tel = eng.telemetry
            stats.update(
                model="gpt2-1.3b",
                mode="bf16 + gpt2-125m draft, bucketed prefill",
                spec=dict(
                    k=eng._spec_k, rounds=tel.spec_rounds,
                    proposed=tel.spec_proposed, accepted=tel.spec_accepted,
                    committed=tel.spec_committed,
                    tokens_per_verify=tel.spec_committed / max(
                        1, tel.spec_rounds),
                    verify_forwards=eng.forward_counts["verify"]),
                tpot_vs_plain=stats["tpot_p50_ms"]
                / plain[1]["tpot_p50_ms"],
                streams_equal_plain=sum(int(np.array_equal(a, b))
                                        for a, b in zip(got, plain[0])))
            assert eng.forward_counts["verify"] > 0, eng.forward_counts
            paths["gpt2-1.3b-spec-serve"] = launches
            log("phase 45 slice " + json.dumps(stats))
            del draft
        del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def phase_gpt2_families(pa, mm, fa, fce, seed=0):
    """Phase 46: OPT-1.3b and GPT-Neo-1.3B at their published widths and
    GPT2_FAMILY_SERVE["layers"] of their 24 layers in bf16, serving 8
    requests each of 300-2016 tokens (so
    GPT-Neo's window-256 layers cut), 32 new each, phase 45's settings:
    TTFT / TPOT p50, tokens/s, peak memory, K4 / K5 launches by design
    (GPT-Neo's prefix cache resolves off). Then GPT-Neo-1.3B's widths at 4
    layers through initialize -> train_batch (AdamW, ZeRO-2, micro 1 x
    2048, whole-block remat, the fused CE head over 512-token chunks),
    2 steps: every layer attends densely (its windows, as JAX), so no K1
    / K2 launch; K3 at the odd vocabulary 50257, four a step, on sm90;
    step time, tokens/s and peak memory. Returns {path: launches}."""
    from deepspeed_tpu_torch import (GPTNEO_PRESETS, OPT_PRESETS, OPT,
                                     GPTNeo, InferenceEngineV2, initialize)
    rs = np.random.RandomState(seed + 46)
    P = GPT2_FAMILY_SERVE
    base = dict(dtype="bfloat16", kv_block_size=64, max_batch_size=8,
                splitfuse_tokens=256, decode_steps_per_dispatch=8)
    paths = {}
    for cls, cfg, tag in ((OPT, OPT_PRESETS["opt-1.3b"], "opt-1.3b"),
                          (GPTNeo, GPTNEO_PRESETS["gpt-neo-1.3b"],
                           "gpt-neo-1.3b")):
        cut = cfg.attn_layer_windows[:P["layers"]]
        cfg = dataclasses.replace(cfg, n_layer=P["layers"],
                                  attn_layer_windows=cut)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = cls(cfg, device="cuda", dtype=torch.bfloat16, seed=seed)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        eng = InferenceEngineV2(model, base, device="cuda")
        assert eng.prefix_cache is None
        lens = rs.randint(P["min_prompt"], cfg.max_seq_len - P["new"] + 1,
                          P["requests"])
        prompts = [rs.randint(0, cfg.vocab_size, (n,)) for n in lens]
        _, stats, launches = gpt2_serve_run(eng, prompts, P["new"], pa, mm,
                                            cfg.n_layer)
        stats.update(model=tag, n_layer=cfg.n_layer, d_head=cfg.d_head,
                     scale_attn=cfg.scale_attn,
                     windows=sorted(set(cfg.attn_layer_windows)),
                     activation=cfg.activation, build_s=build_s,
                     prompt_tokens=int(lens.sum()))
        log("phase 46 slice " + json.dumps(stats))
        paths[f"{tag}-serve"] = launches
        del eng, model

    gc.collect()
    torch.cuda.empty_cache()
    T, steps = GPTNEO_TRAIN["T"], GPTNEO_TRAIN["steps"]
    cfg = dataclasses.replace(
        GPTNEO_PRESETS["gpt-neo-1.3b"], n_layer=GPTNEO_TRAIN["layers"],
        attn_layer_windows=GPTNEO_PRESETS["gpt-neo-1.3b"]
        .attn_layer_windows[:GPTNEO_TRAIN["layers"]],
        max_seq_len=T, loss_chunk=GPTNEO_TRAIN["loss_chunk"],
        fused_loss=True, fused_loss_kernel=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, *_ = initialize(
        model=GPTNeo(cfg, device="cuda", seed=seed),
        config=zero_config(2, train_micro_batch_size_per_gpu=1))
    torch.cuda.synchronize()
    built = torch.cuda.memory_allocated()
    log(f"gpt-neo-1.3b-train engine built in {time.perf_counter() - t0:.1f} "
        f"s: {cfg.num_params() / 1e9:.3f} B params ({cfg.n_layer} layers, "
        f"windows {cfg.attn_layer_windows}), micro 1 x {T}")
    batch = {"input_ids": np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (1, T)).astype(np.int32)}
    fa.reset_launch_counts()
    fce.reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    chunks = -(-(T - 1) // GPTNEO_TRAIN["loss_chunk"])
    assert not any(fa.LAUNCHES.values()), dict(fa.LAUNCHES)
    assert fce.LAUNCHES["fused_ce"] == chunks * steps, dict(fce.LAUNCHES)
    assert_sm90("gpt-neo train", fce, main_path=True)
    assert all(math.isfinite(x) for x in losses), losses
    stats = dict(
        kind="gpt-neo-1.3b", n_layer=cfg.n_layer, params=cfg.num_params(),
        vocab_size=cfg.vocab_size, steps=steps, losses=losses,
        step_s=times, tokens_per_s=T / times[-1],
        launches_per_step={"fused_ce": chunks, "flash_fwd": 0,
                           "flash_bwd": 0},
        memory_after_build_gb=built / 1e9,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("phase 46 train " + json.dumps(stats))
    paths["gpt-neo-1.3b-train"] = {"fused_ce": fce.LAUNCHES["fused_ce"]}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return paths


# ------------------------------------------------- winner cache (phase 47)

# phase 47 (c): the 2-layer Llama-2-7B engine on phase 4's traffic
WINNER_SERVE = dict(layers=2, requests=8, new=64)


def winner_searches():
    """(label, op, bucket, dtype) of phase 47 (b)'s searches: the
    full-width buckets of the paths that take each op with more than one
    candidate."""
    from deepspeed_tpu_torch import GPT2_PRESETS, LLAMA_PRESETS
    from deepspeed_tpu_torch.ops.cuda import _common as c
    llama_mb = -(-LLAMA_PRESETS["llama2-7b"].max_seq_len // 64)
    gpt2_mb = -(-GPT2_PRESETS["1.3B"].max_seq_len // 64)
    bf = "bfloat16"
    return (
        ("llama2-7b decode", "paged_decode",
         c.paged_decode_bucket(8, llama_mb, 64, 32, 1, 128), bf),
        ("llama2-7b chunk 256", "paged_chunk",
         c.paged_chunk_bucket(256, llama_mb, 64, 32, 1, 128), bf),
        ("llama2-7b verify 5", "paged_chunk",
         c.paged_chunk_bucket(5, llama_mb, 64, 32, 1, 128), bf),
        ("gpt2-1.3b decode", "paged_decode",
         c.paged_decode_bucket(8, gpt2_mb, 64, 32, 1, 64), bf),
        ("gpt2-1.3b chunk 256", "paged_chunk",
         c.paged_chunk_bucket(256, gpt2_mb, 64, 32, 1, 64), bf),
        ("gpt2-350m flash (qkv_t)", "flash_attention",
         c.flash_bucket(1024, 64, True, True), bf),
        ("gpt2-350m layernorm", "layernorm", c.ln_bucket(24 * 1024, 1024),
         bf),
        ("gpt2-350m mlp", "mlp_matmul", c.mlp_bucket(1024, 1024, 4096), bf))


def winner_unsearched():
    """(label, op, bucket, dtype) of the one-candidate ops at their paths'
    buckets: K8 takes no lever, the serving policies have no step that
    replays measured traffic."""
    from deepspeed_tpu_torch.ops.cuda import _common as c
    bf = "bfloat16"
    return (
        ("mixtral-8x7b experts, decode", "moe_grouped_mm",
         c.moe_grouped_bucket(16, 8, 4096, 14336), bf),
        ("mixtral-8x7b experts, chunk", "moe_grouped_mm",
         c.moe_grouped_bucket(512, 8, 4096, 14336), bf),
        ("phase 35 prefix pool", "prefix_cache",
         c.prefix_cache_bucket(8, PHASE35["prefix_blocks"], 64), bf),
        ("phase 35 spec pool", "spec_decode",
         c.spec_bucket(8, PHASE35["spec_blocks"], 64), bf))


def winner_cold_checks(pa, cuda):
    """Phase 47 (a): the cold cache at phases 4's, 7's, 10's, 35's and
    45's buckets gives every resolver the choice the port made before it
    had a cache (the shape rules, K2, the plain LayerNorm and MLP, the
    kernels for the experts, the JAX policy defaults)."""
    from deepspeed_tpu_torch import GPT2_PRESETS, LLAMA_PRESETS, MIXTRAL_8X7B
    from deepspeed_tpu_torch.autotuning import kernel_registry as kr
    from deepspeed_tpu_torch.inference.v2.prefix_cache import \
        resolve_prefix_cache
    from deepspeed_tpu_torch.inference.v2.speculative import resolve_spec
    from deepspeed_tpu_torch.moe.sharded_moe import resolve_grouped_params
    from deepspeed_tpu_torch.ops.cuda import _common as c
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    bf = torch.bfloat16
    mb = {name: -(-cfg.max_seq_len // 64) for name, cfg in (
        ("llama", LLAMA_PRESETS["llama2-7b"]), ("mixtral", MIXTRAL_8X7B),
        ("gpt2", GPT2_PRESETS["1.3B"]))}
    dec, chunk = pa.resolve_paged_decode_levers, pa.resolve_paged_chunk_levers
    split, tile = pa.DECODE_SPLIT_POSITIONS, pa.PAGED_CHUNK_BLOCK_C
    checks = {
        "phase 4 decode": (dec("auto", 8, mb["llama"], 64, 32, 1, 128, bf,
                               cuda), (True, split)),
        "phase 4 chunk": (chunk("auto", "auto", 256, mb["llama"], 64, 32, 1,
                                128, bf, cuda), (True, tile, None)),
        "phase 7 flash backward": (fa.resolve_bwd_qmajor(
            "auto", 1024, 64, True, True, bf, cuda), False),
        "phase 7 layernorm": (c.dispatch(
            "layernorm", c.ln_bucket(24 * 1024, 1024), "bfloat16",
            kr.LN_DEFAULTS, device=cuda), {"variant": "plain"}),
        "phase 7 mlp": (c.dispatch(
            "mlp_matmul", c.mlp_bucket(1024, 1024, 4096), "bfloat16",
            kr.MLP_DEFAULTS, device=cuda), kr.MLP_DEFAULTS),
        "phase 10 decode": (dec("auto", 8, mb["mixtral"], 64, 8, 4, 128, bf,
                                cuda), (True, split)),
        "phase 10 experts (decode, chunk)": (
            [resolve_grouped_params("auto", rows, 8, 4096, 14336, bf, cuda)
             for rows in (16, 512)], [{"backend": "kernel"}] * 2),
        "phase 35 prefix cache": (resolve_prefix_cache(
            "auto", "auto", 8, PHASE35["prefix_blocks"], 64, "bfloat16",
            cuda), (False, 1, 0)),
        "phase 35 speculation": (resolve_spec(
            "auto", "auto", 8, PHASE35["spec_blocks"], 64, "bfloat16", cuda),
            (True, 4, 0.35)),
        "phase 45 decode": (dec("auto", 8, mb["gpt2"], 64, 32, 1, 64, bf,
                                cuda), (True, split)),
        "phase 45 chunk": (chunk("auto", "auto", 256, mb["gpt2"], 64, 32, 1,
                                 64, bf, cuda), (True, tile, None)),
    }
    for name, (got, want) in checks.items():
        assert got == want, f"cold cache, {name}: {got} != {want}"
    return {name: got for name, (got, _) in checks.items()}


def verify_splits_at_1200(pa, winner, seed=0):
    """The verify (C = 5) at start 1200 of Llama-2-7B's table, K5's sm90
    design timed with queued launches at the rule's split count, at 1 and
    2 splits and at the winner's."""
    g = torch.Generator(device="cuda").manual_seed(seed + 1200)
    KVH, BS, D, MB = 32, 64, 128, 64
    NB = 2 * MB + 1
    q = torch.randn(5, KVH, D, generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn(NB, KVH, BS, D, generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    table = (torch.randperm(NB - 1, generator=g, device="cuda")[:MB] + 1) \
        .to(torch.int32)
    scale = 1.0 / math.sqrt(D)
    out = {"rule_splits": pa.chunk_splits(5, KVH, KVH, BS, MB, 1200, 5, 0,
                                          pa._sm_count(0))}
    for tag, s in (("rule", None), ("splits_1", 1), ("splits_2", 2),
                   ("winner", winner)):
        out[f"{tag}_ms"] = time_queued(
            lambda s=s: pa.paged_chunk_launch(q, k, v, table, 1200, 5, scale,
                                              0, "auto", "sm90", splits=s),
            200)[0]
    return out


def phase_winner_cache(pa, seed=0):
    """Phase 47: the autotune winner cache (see the module docstring).
    Returns the launches of (c)'s bf16 engine serving from the filled
    file."""
    import shutil
    import tempfile
    from deepspeed_tpu_torch import InferenceEngineV2, LLAMA_PRESETS, Llama
    from deepspeed_tpu_torch.autotuning import (KernelCache,
                                                kernel_autotuner,
                                                kernel_dispatch)
    from deepspeed_tpu_torch.autotuning import kernel_registry as kr
    from deepspeed_tpu_torch.autotuning.kernel_cache import entry_key
    from deepspeed_tpu_torch.ops.cuda import _common as c
    kind = torch.cuda.get_device_name(0)
    cuda = torch.device("cuda", 0)
    bf = torch.bfloat16

    # (a) the cold cache phases 1-46 ran under
    cold = kernel_dispatch.cache_path()
    assert kernel_dispatch.current_mode() == "cache_only"
    assert not kernel_dispatch.reports(), "a search ran in phases 1-46"
    assert len(KernelCache.load(cold)) == 0, cold
    resolved = winner_cold_checks(pa, cuda)
    assert len(KernelCache.load(cold)) == 0, cold
    log("winner-cache (a) cold " + json.dumps(
        {k: str(v) for k, v in resolved.items()}))

    tmp = tempfile.mkdtemp(prefix="phase47-", dir=os.path.dirname(cold))
    try:
        # (b) measured searches on a file of their own
        filled = os.path.join(tmp, "filled.json")
        kernel_dispatch.configure(mode="on_first_use", cache_path=filled)
        searches = winner_searches()
        winners = {}
        for label, op, bucket, dtype in searches:
            t0 = time.perf_counter()
            defaults = kr.REGISTRY[op]["defaults"](kr.parse_bucket(bucket))
            winners[label] = c.dispatch(op, bucket, dtype, defaults,
                                        device=cuda)
            rep = kernel_dispatch.reports()[entry_key(kind, op, bucket,
                                                      dtype)]
            bad = [r for r in rep["candidates"] if r["parity"] != "ok"]
            assert not bad, f"{label}: {bad}"
            log("winner-cache (b) search " + json.dumps(dict(
                label=label, op=op, bucket=bucket, dtype=dtype,
                candidates=[[r["params"], r["ms"], r["parity"]]
                            for r in rep["candidates"]],
                default_ms=rep["default_ms"], winner=rep["winner"],
                winner_ms=rep["winner_ms"],
                seconds=time.perf_counter() - t0)))
            gc.collect()
            torch.cuda.empty_cache()
        for label, op, bucket, dtype in winner_unsearched():
            defaults = kr.REGISTRY[op]["defaults"](kr.parse_bucket(bucket))
            got = c.dispatch(op, bucket, dtype, defaults, device=cuda)
            assert got == defaults, (label, got)
            assert entry_key(kind, op, bucket, dtype) not in \
                kernel_dispatch.reports(), label
            log(f"winner-cache (b) one candidate, not searched: {label} "
                f"{op} {bucket} -> {got}")
        entries = KernelCache.load(filled).entries
        assert len(entries) == len(searches), sorted(entries)
        assert all(e["device_kind"] == kind for e in entries.values()), \
            entries
        verify = winners["llama2-7b verify 5"]["splits"]
        log("winner-cache (b) verify at start 1200 " + json.dumps(
            verify_splits_at_1200(pa, None if verify == "rule" else verify,
                                  seed)))

        # (c) serving from the filled file
        cfg = dataclasses.replace(LLAMA_PRESETS["llama2-7b"],
                                  n_layer=WINNER_SERVE["layers"])
        L, new = cfg.n_layer, WINNER_SERVE["new"]
        MB = -(-cfg.max_seq_len // 64)
        rs = np.random.RandomState(seed + 47)
        prompts = [rs.randint(0, cfg.vocab_size, (n,))
                   for n in rs.randint(64, 2049, WINNER_SERVE["requests"])]
        base = dict(kv_block_size=64, max_batch_size=8, splitfuse_tokens=256,
                    decode_steps_per_dispatch=8)

        def decode_lever(win):
            return f"S={pa.decode_splits(MB, 64, win['split_positions'])[0]}"

        def serve_on(model, dtype, mode, path):
            eng = InferenceEngineV2(model, dict(
                base, dtype=dtype, autotune_mode=mode, autotune_cache=path),
                device="cuda")
            # a search inside the run launches K4 / K5 on its own steps:
            # counted apart, so that the forwards' launches are exact
            searched = collections.Counter()
            real = kernel_autotuner.search

            def counted(*a, **k):
                before = dict(pa.LAUNCHES)
                try:
                    return real(*a, **k)
                finally:
                    searched.update({n: pa.LAUNCHES[n] - before[n]
                                     for n in before})

            kernel_autotuner.search = counted
            try:
                streams, _, launches = serve_run(eng, prompts, new, pa)
            finally:
                kernel_autotuner.search = real
            forwards = {k: launches[k] - searched[k] for k in launches}
            want = expected_launches(eng, L)
            assert forwards == want, (launches, dict(searched), want)
            assert mode == "on_first_use" or not +searched, searched
            if +searched:
                log(f"winner-cache (c) {dtype} {mode}: the searches "
                    f"launched {dict(searched)} beside the forwards' "
                    f"{want}")
            return streams, forwards, {k: dict(v) for k, v in
                                       pa.LEVER_LAUNCHES.items()}

        model = Llama(cfg, device="cuda", dtype=bf, seed=seed)
        _, launches, levers = serve_on(model, "bfloat16", "cache_only",
                                       filled)
        count_paged_designs(pa, launches)
        assert levers["paged_decode"] == {decode_lever(
            winners["llama2-7b decode"]): launches["paged_decode"]}, levers
        chunk_splits = winners["llama2-7b chunk 256"]["splits"]
        if chunk_splits != "rule":
            assert levers["paged_chunk"] == {
                f"S={chunk_splits}": launches["paged_chunk"]}, levers
        assert sum(levers["paged_chunk"].values()) == \
            launches["paged_chunk"], levers
        log("winner-cache (c) bf16 from the filled file " + json.dumps(
            dict(launches=launches, levers=levers)))
        model = None
        gc.collect()
        torch.cuda.empty_cache()

        model = Llama(cfg, device="cuda", dtype=torch.float32, seed=seed)
        dec_b = c.paged_decode_bucket(8, MB, 64, 32, 1, 128)
        chunk_b = c.paged_chunk_bucket(256, MB, 64, 32, 1, 128)
        fp32, forced = (os.path.join(tmp, f) for f in ("fp32.json",
                                                       "forced.json"))
        seeded = KernelCache()
        seeded.put(kind, "paged_decode", dec_b, "float32",
                   {"mode": "kernel", "split_positions": 0})
        seeded.put(kind, "paged_chunk", chunk_b, "float32",
                   {"mode": "kernel", "block_c": 16, "splits": "rule"})
        seeded.save(forced)
        runs = {tag: serve_on(model, "float32", mode, path)
                for tag, mode, path in (
                    ("cold", "cache_only", os.path.join(tmp, "empty.json")),
                    ("searching", "on_first_use", fp32),
                    ("filled", "cache_only", fp32),
                    ("seeded", "cache_only", forced))}
        table = KernelCache.load(fp32)
        wd = table.lookup(kind, "paged_decode", dec_b, "float32")
        wc = table.lookup(kind, "paged_chunk", chunk_b, "float32")
        assert wd is not None and wc is not None, sorted(table.entries)
        expect = {"cold": ({decode_lever(pa.PAGED_DECODE_DEFAULTS)},
                           {f"block_c={pa.PAGED_CHUNK_BLOCK_C}"}),
                  "filled": ({decode_lever(wd)},
                             {f"block_c={min(int(wc['block_c']), 256)}"}),
                  "seeded": ({"S=1"}, {"block_c=16"})}
        for tag, (dec_keys, chunk_keys) in expect.items():
            got = runs[tag][2]
            assert set(got["paged_decode"]) == dec_keys, (tag, got)
            assert set(got["paged_chunk"]) == chunk_keys, (tag, got)
        for tag, (streams, _, levers) in runs.items():
            assert all(np.array_equal(a, b) for a, b in
                       zip(streams, runs["cold"][0])), \
                f"fp32 greedy streams of the {tag} engine differ"
            log(f"winner-cache (c) fp32 {tag}: streams equal the cold "
                f"engine's; launches by lever {json.dumps(levers)}; "
                f"winners decode {wd}, chunk {wc}")
        model = None
        gc.collect()
        torch.cuda.empty_cache()

        # (d) refusals: an entry filed under this card but measured on
        # another is a miss; a dense decode entry raises
        other = "NVIDIA A100-SXM4-80GB"
        foreign = KernelCache()
        foreign.put(other, "paged_decode", dec_b, "bfloat16",
                    {"mode": "kernel", "split_positions": 0})
        foreign.entries[entry_key(kind, "paged_decode", dec_b, "bfloat16")] \
            = dict(foreign.entries[entry_key(other, "paged_decode", dec_b,
                                             "bfloat16")])
        path = os.path.join(tmp, "foreign.json")
        foreign.save(path)
        kernel_dispatch.configure(mode="cache_only", cache_path=path)
        assert pa.resolve_paged_decode_levers(
            "auto", 8, MB, 64, 32, 1, 128, bf, cuda) == \
            (True, pa.DECODE_SPLIT_POSITIONS)
        plain = KernelCache()
        plain.put(kind, "paged_decode", dec_b, "bfloat16",
                  {"mode": "dense", "split_positions": 512})
        path = os.path.join(tmp, "plain.json")
        plain.save(path)
        kernel_dispatch.configure(mode="cache_only", cache_path=path)
        try:
            pa.resolve_paged_decode_levers("auto", 8, MB, 64, 32, 1, 128, bf,
                                           cuda)
        except ValueError as e:
            log(f"winner-cache (d) another device kind's entry refused (a "
                f"miss); a dense decode entry raises: {e}")
        else:
            raise AssertionError("a dense paged_decode winner was applied")
    finally:
        kernel_dispatch.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ------------------------------------------ GPT2MoE serving (phase 48)

# phase 48: 8 requests of 64-992 tokens, 32 new each, phase 45's engine
# settings; the parity engines at 2 layers in fp32
# phase 48's serving runs at 12 of the 350M widths' 24 layers (the run's
# time limit: since PR 27), the int8 run (c) at all 24: there the router
# (L, D, E) and the expert biases reach quantize_tree's 2^16 elements
GPT2MOE_SERVE = dict(requests=8, new=32, parity_layers=2, parity_new=8,
                     layers=12, int8_layers=24)
# the block leaves JAX's quantize_tree takes from GPT2MoE at the 350M
# widths, 24 layers, 4 experts: every float leaf of >= 2 dims and 2^16
# elements but moe_gate (deepspeed_tpu/ops/int8_weights.py:113-147)
GPT2MOE_INT8_LEAVES = {"wqkv", "bqkv", "wo", "moe.gate_w", "moe.wi",
                       "moe.bi", "moe.wo", "moe.bo"}
# the JAX bench's MoE serving config (benchmarks/bench_engine.py:84-92)
GPT2MOE_RAGGED = dict(num_experts=4, moe_top_k=2, moe_backend="ragged")


class DropCounter:
    """A capacity gate that counts, on the device, the choices it drops
    (weight 0) and, on the host, the choices it routes."""

    def __init__(self, gate):
        self.gate = gate
        self.dropped = None
        self.choices = 0

    def __call__(self, *args, **kwargs):
        g = self.gate(*args, **kwargs)
        d = (g.weights == 0).sum()
        self.dropped = d if self.dropped is None else self.dropped + d
        self.choices += g.weights.numel()
        return g


def prefill_logits(model, ids, BS=64):
    """The fp32 logits (V,) of ``model.apply_paged_prefill`` over one
    prompt ``ids`` (a fresh pool, the prompt bucketed to whole blocks)."""
    T = len(ids)
    T_pad = -(-T // BS) * BS
    cache = model.init_paged_cache(T_pad // BS + 1, BS)
    x = torch.zeros(1, T_pad, dtype=torch.int32, device="cuda")
    x[0, :T] = torch.as_tensor(ids, dtype=torch.int32)
    pos = torch.arange(T_pad, device="cuda")
    tb = torch.where(pos < T, 1 + pos // BS, 0).to(torch.int32)
    to = torch.where(pos < T, pos % BS, 0).to(torch.int32)
    logits, _ = model.apply_paged_prefill(x, cache, tb, to, T)
    return logits[0].float()


def gpt2moe_serve_run(eng, prompts, new, pa, gm, mm, L, grouped):
    """serve_run with GPT2MoE's launch gates: K4 / K5 as the forwards imply
    (count_paged_designs), K8's grouped_gmm two a layer and forward when
    ``grouped`` (the ragged experts' up and down; none under the dense
    backend), no other grouped or K7 launch. Returns (streams, stats,
    launches)."""
    gm.reset_launch_counts()
    mm.reset_launch_counts()
    outs, stats, launches = serve_run(eng, prompts, new, pa)
    assert launches == expected_launches(eng, L), launches
    count_paged_designs(pa, launches)
    fc = eng.forward_counts
    want = {"grouped_swiglu_up": 0, "grouped_tgmm": 0,
            "grouped_gmm": 2 * L * sum(fc.values()) if grouped else 0,
            **NO_WQ}
    assert gm.LAUNCHES == want, (dict(gm.LAUNCHES), want)
    assert mm.LAUNCHES["wq_matmul"] == 0, dict(mm.LAUNCHES)
    by = dict(gm.DESIGN_LAUNCHES["grouped_gmm"])
    assert sum(by.values()) == want["grouped_gmm"] and not by["fp32"], by
    count_designs("grouped_gmm", by)
    launches["grouped_gmm"] = gm.LAUNCHES["grouped_gmm"]
    stats["launches"] = launches
    stats["launches_by_design"] = {
        "paged_decode": {k: v for k, v in pa.DESIGN_LAUNCHES[
            "paged_decode"].items() if v},
        "paged_chunk": {k: v for k, v in pa.DESIGN_LAUNCHES[
            "paged_chunk"].items() if v},
        "grouped_gmm": {k: v for k, v in by.items() if v}}
    for o in outs:
        assert ((o >= 0) & (o < eng.model.config.vocab_size)).all()
    assert pools_full(eng)
    return outs, stats, launches


def phase_gpt2moe_serve(pa, gm, mm, seed=0):
    """Phase 48: GPT2MoE serving at the 350M widths. (0) At
    GPT2MOE_SERVE["parity_layers"] layers in fp32: the ragged backend's
    greedy streams with the paged kernels and K8 on equal those with
    both off (paged_kernel=False, moe_grouped_kernel=False), split-fuse 256
    and bucketed; the dense backend with moe_drop_tokens=False gives the
    ragged backend's prefill logits (top-1, 8 experts, the same weights)
    at FP32_TOL, and in bf16 within BF16_REL_NORM. Then GPT2MOE_SERVE[
    "layers"] of the 24 layers in bf16, 8 requests of 64-992 tokens, 32
    new each (phase 45's settings):
    (a) ragged, 4 experts, top-2 (the JAX bench's MoE config): K4 / K5 one
    a layer and forward, K8's grouped_gmm two; (b) the config's own MoE
    defaults (dense, 8 experts, top-1, eval capacity factor 2.0): K4 / K5
    as (a), no K8, the gate's dropped choices counted; (c) (a) at
    GPT2MOE_SERVE["int8_layers"] layers under weight_quant="int8": exactly
    the leaves GPT2MOE_INT8_LEAVES quantized, each dequantized a layer at
    a time, then K8 in bf16 (as JAX), no K7 / K9. TTFT / TPOT p50,
    tokens/s, peak memory. Returns {path: launches}."""
    from deepspeed_tpu_torch import GPT2_PRESETS, GPT2MoE, InferenceEngineV2
    gc.collect()
    torch.cuda.empty_cache()
    rs = np.random.RandomState(seed + 48)
    P = GPT2MOE_SERVE
    base350 = GPT2_PRESETS["350M"]
    cfg = moe_cfg(base350, n_layer=P["parity_layers"], dtype="float32",
                  **GPT2MOE_RAGGED)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)) for n in (7, 64, 300)]
    conf = dict(dtype="float32", kv_block_size=64, max_batch_size=4)
    model = GPT2MoE(cfg, device="cuda", dtype=torch.float32, seed=seed)
    for splitfuse in (256, 0):
        streams = {}
        for on in (True, False):
            model.moe.grouped_kernel = on
            pa.reset_launch_counts()
            gm.reset_launch_counts()
            eng = InferenceEngineV2(model, dict(
                conf, splitfuse_tokens=splitfuse, paged_kernel=on),
                device="cuda")
            streams[on] = eng.generate_all(prompts,
                                           max_new_tokens=P["parity_new"])
            assert (pa.LAUNCHES["paged_decode"] > 0) == on, dict(pa.LAUNCHES)
            assert (pa.LAUNCHES["paged_chunk"] > 0) == on, dict(pa.LAUNCHES)
            assert (gm.LAUNCHES["grouped_gmm"] > 0) == on, dict(gm.LAUNCHES)
            del eng
        for a, b in zip(streams[True], streams[False]):
            np.testing.assert_array_equal(a, b)
    del model
    dropless = {}
    for dt in (torch.float32, torch.bfloat16):
        dense_cfg = moe_cfg(base350, n_layer=P["parity_layers"],
                            dtype=str(dt).split(".")[-1],
                            moe_drop_tokens=False)
        dense = GPT2MoE(dense_cfg, device="cuda", dtype=dt, seed=seed)
        ragged = GPT2MoE(dataclasses.replace(dense_cfg, moe_backend="ragged",
                                             moe_grouped_kernel=True),
                         device="cuda", dtype=dt, seed=seed + 1)
        ragged.load_state_dict(dense.state_dict())
        ld = prefill_logits(dense, prompts[2])
        lr = prefill_logits(ragged, prompts[2])
        rel = (torch.linalg.vector_norm(ld - lr)
               / torch.linalg.vector_norm(lr)).item()
        if dt == torch.float32:
            torch.testing.assert_close(ld, lr, **FP32_TOL)
        else:
            assert rel <= BF16_REL_NORM, rel
        dropless[str(dt).split(".")[-1]] = dict(
            max_abs_err=(ld - lr).abs().max().item(), rel_norm=rel)
        del dense, ragged
    log(f"phase 48 parity ok: GPT2MoE 350M widths at {P['parity_layers']} "
        f"layers, fp32: K4 / K5 / K8 on == off (split-fuse 256 and "
        f"bucketed); dense without drops == ragged prefill logits "
        f"{json.dumps(dropless)}")
    gc.collect()
    torch.cuda.empty_cache()

    lens = rs.randint(64, base350.max_seq_len - P["new"] + 1, P["requests"])
    prompts = [rs.randint(0, base350.vocab_size, (n,)) for n in lens]
    base = dict(dtype="bfloat16", kv_block_size=64, max_batch_size=8,
                splitfuse_tokens=256, decode_steps_per_dispatch=8)
    paths = {}
    for tag, over, wq, L in (
            ("gpt2moe-serve", GPT2MOE_RAGGED, "auto", P["layers"]),
            ("gpt2moe-dense-serve", {}, "auto", P["layers"]),
            ("gpt2moe-int8-serve", GPT2MOE_RAGGED, "int8",
             P["int8_layers"])):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = moe_cfg(base350, n_layer=L, **over)
        t0 = time.perf_counter()
        model = GPT2MoE(cfg, device="cuda", dtype=torch.bfloat16, seed=seed)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        counter = None
        if model.moe.gate is not None:
            counter = model.moe.gate = DropCounter(model.moe.gate)
        eng = InferenceEngineV2(model, dict(base, weight_quant=wq),
                                device="cuda")
        outs, stats, launches = gpt2moe_serve_run(
            eng, prompts, P["new"], pa, gm, mm, L,
            grouped=model.moe.gate is None)
        stats.update(model=tag, backend=cfg.moe_backend,
                     experts=cfg.num_experts, top_k=cfg.moe_top_k,
                     n_layer=L, build_s=build_s,
                     prompt_tokens=int(lens.sum()),
                     quantized_leaves=sorted(model.qblocks),
                     weight_gb=sum(
                         p.numel() * p.element_size()
                         for p in model.parameters()) / 1e9 + sum(
                         w.q.numel() + 4 * w.scale.numel()
                         for w in model.qblocks.values()) / 1e9)
        if counter is not None:
            forwards = sum(eng.forward_counts.values())
            dropped = int(counter.dropped)
            assert counter.choices > 0
            stats.update(dropped_choices=dropped,
                         routed_choices=counter.choices,
                         dropped_share=dropped / counter.choices,
                         dropped_per_forward=dropped / forwards,
                         eval_capacity_factor=cfg.eval_capacity_factor)
        if wq == "int8":
            # exactly the block leaves JAX's quantize_tree takes, the router
            # (L, D, E) = 98,304 elements and the expert biases included;
            # each is dequantized a layer at a time, so K8 runs in bf16 and
            # no K7 / K9 launches
            assert L == 24 and set(model.qblocks) == GPT2MOE_INT8_LEAVES, \
                sorted(model.qblocks)
        paths[tag] = launches
        log("phase 48 slice " + json.dumps(stats))
        del eng, model, counter
    gc.collect()
    torch.cuda.empty_cache()
    return paths


# ------------------------------------- GPT2MoE dense training (phase 49)

# phase 49: GPT2MoE's own MoE config (dense, 8 experts, top-1, capacity
# factor 1.25) over the 350M widths, cut to 6 of 24 layers for the run's
# time limit; micro 8 x 1024
GPT2MOE_TRAIN = dict(layers=6, micro=8, steps=4, parity_layers=2,
                     parity_T=256)


def phase_gpt2moe_dense_train(fa, fce, gm, seed=0):
    """Phase 49: GPT2MoE's GShard capacity backend in training. (0) The
    350M widths at GPT2MOE_TRAIN["parity_layers"] layers in fp32 with
    moe_drop_tokens=False: the dense backend's loss, aux and every gradient
    equal the ragged backend's (top-1, 8 experts, K8 on; the same
    weights) at a relative error norm of 1e-4 (JAX's
    test_dropless_vs_dense_dispatch_no_drops). Then the config's own MoE
    defaults at GPT2MOE_TRAIN["layers"] layers, bf16, through initialize
    -> train_batch (phase 13's engine config, micro 8 x 1024, save_flash,
    the fused CE head), GPT2MOE_TRAIN["steps"] steps on one batch: the loss
    finite and falling, exactly one K1 forward (sm90) and one K2 backward a
    layer and step, two K3 calls a step, no K8 launch (the capacity
    dispatch is batched products); step time, tokens/s, peak memory; one
    step of a 2-layer model with noisy_gate_policy="RSample" (the engine's
    per-step key through loss(rng=)). Returns {path: launches}."""
    from deepspeed_tpu_torch import GPT2_PRESETS, GPT2MoE, initialize
    gc.collect()
    torch.cuda.empty_cache()
    P = GPT2MOE_TRAIN
    base350 = GPT2_PRESETS["350M"]
    T = P["parity_T"]
    pcfg = moe_cfg(base350, n_layer=P["parity_layers"], max_seq_len=T,
                   dtype="float32", remat=False, use_flash_attention=True,
                   moe_drop_tokens=False)
    ids = torch.from_numpy(np.random.RandomState(seed).randint(
        0, pcfg.vocab_size, (2, T))).cuda()
    out = {}
    dense = GPT2MoE(pcfg, device="cuda", dtype=torch.float32, seed=seed)
    ragged = GPT2MoE(dataclasses.replace(pcfg, moe_backend="ragged",
                                         moe_grouped_kernel=True),
                     device="cuda", dtype=torch.float32, seed=seed + 1)
    ragged.load_state_dict(dense.state_dict())
    for name, model in (("dense", dense), ("ragged", ragged)):
        gm.reset_launch_counts()
        loss = model.loss({"input_ids": ids})
        loss.backward()
        with torch.no_grad():
            aux = model.hidden_with_aux(ids, train=True)[1].item()
        assert (gm.LAUNCHES["grouped_gmm"] > 0) == (name == "ragged"), \
            dict(gm.LAUNCHES)
        out[name] = (loss.item(), aux, {n: p.grad for n, p in
                                        model.named_parameters()})
    (l_d, a_d, g_d), (l_r, a_r, g_r) = out["dense"], out["ragged"]
    assert abs(l_d - l_r) <= 1e-5 * abs(l_r), (l_d, l_r)
    assert abs(a_d - a_r) <= 1e-5 * abs(a_r), (a_d, a_r)
    worst = 0.0
    for n, g in g_r.items():
        rel = (torch.linalg.vector_norm(g_d[n] - g)
               / torch.linalg.vector_norm(g)).item()
        assert rel <= 1e-4, (n, rel)
        worst = max(worst, rel)
    log(f"phase 49 parity ok: dense without drops == ragged at "
        f"{P['parity_layers']} layers, fp32: loss {l_d:.7f} vs {l_r:.7f}, "
        f"aux {a_d:.7f} vs {a_r:.7f}, worst gradient relative error norm "
        f"{worst:.3g}")
    del dense, ragged, out, g_d, g_r
    gc.collect()
    torch.cuda.empty_cache()

    engine_cfg = {"train_micro_batch_size_per_gpu": P["micro"],
                  "gradient_accumulation_steps": 1, "steps_per_print": 0,
                  "optimizer": {"type": "AdamW", "params": {
                      "lr": 2e-4, "weight_decay": 0.01}},
                  "gradient_clipping": 1.0, "bf16": {"enabled": True},
                  "zero_optimization": {"stage": 2}}
    cfg = moe_cfg(
        base350, n_layer=P["layers"], max_seq_len=1024,
        use_flash_attention=True, flash_block_q=1024, flash_block_k=1024,
        flash_block_h=1, remat=True, remat_policy="save_flash",
        loss_chunk=512, fused_loss=True, fused_loss_kernel=True)
    assert (cfg.moe_backend, cfg.num_experts, cfg.moe_top_k) == \
        ("dense", 8, 1), cfg
    t0 = time.perf_counter()
    engine, *_ = initialize(model=GPT2MoE(cfg, device="cuda", seed=seed),
                            config=engine_cfg)
    torch.cuda.synchronize()
    bsz = engine.config.train_batch_size
    log(f"gpt2moe-350M dense (E=8, top-1, {cfg.n_layer} layers) engine "
        f"built in {time.perf_counter() - t0:.1f} s: "
        f"{cfg.num_params() / 1e6:.1f}M params, batch {bsz} x 1024")
    batch = {"input_ids": np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (bsz, cfg.max_seq_len)).astype(np.int32)}
    counter = engine.model.moe.gate = DropCounter(engine.model.moe.gate)
    torch.cuda.reset_peak_memory_stats()
    for mod in (fa, fce, gm):
        mod.reset_launch_counts()
    losses, times = [], []
    for _ in range(P["steps"]):
        t1 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    launches = {**fa.LAUNCHES, **fce.LAUNCHES, **gm.LAUNCHES}
    L, steps = cfg.n_layer, P["steps"]
    want = {"flash_fwd": L * steps, "flash_bwd": L * steps,
            "flash_bwd_qmajor": 0, "flash_block_fwd": 0,
            "fused_ce": 2 * steps, "grouped_swiglu_up": 0,
            "grouped_gmm": 0, "grouped_tgmm": 0, **NO_WQ}
    assert launches == want, (launches, want)
    assert_sm90("gpt2moe dense train", fa, fce, main_path=True)
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    # save_flash re-runs each layer's MLP in the backward: two gate calls a
    # layer and step
    assert counter.choices == 2 * L * steps * bsz * cfg.max_seq_len, \
        counter.choices
    dropped = int(counter.dropped)
    step_s = float(np.median(times[1:]))
    tokens = bsz * cfg.max_seq_len
    stats = dict(
        kind="gpt2moe-350m-dense", n_layer=L, experts=cfg.num_experts,
        top_k=cfg.moe_top_k, capacity_factor=cfg.capacity_factor,
        steps=steps, losses=losses, step_s=times,
        step_s_median_after_first=step_s, tokens_per_s=tokens / step_s,
        active_flops_per_token=active_flops_per_token(cfg),
        model_tflops_per_s_active=active_flops_per_token(cfg) * tokens
        / step_s / 1e12, launches=launches,
        dropped_share=dropped / counter.choices,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("phase 49 train " + json.dumps(stats))
    del engine, counter
    gc.collect()
    torch.cuda.empty_cache()

    noisy = dataclasses.replace(cfg, n_layer=2, noisy_gate_policy="RSample")
    engine, *_ = initialize(model=GPT2MoE(noisy, device="cuda", seed=seed),
                            config=engine_cfg)
    assert engine.model._requires_train_rng()
    key0 = engine.rng_data.copy()
    loss = float(engine.train_batch(batch))
    assert math.isfinite(loss), loss
    assert not np.array_equal(engine.rng_data, key0)
    log(f"phase 49 RSample step ok: 2 layers, loss {loss:.5f}, key "
        f"{key0.tolist()} -> {engine.rng_data.tolist()}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"gpt2moe-dense-train": launches}


# ---------- multi-rank serving: two processes on cuda:0 over gloo (50-51)

# Cuts (the run's time limit): Llama-2-7B at 8 of its 32 layers, GPT-2
# 1.3B at 4 of 24, Bloom-7b1 at 2 of 30, Mixtral-8x7B at 2 of 32; the
# fp32 parity at 2 layers (Mixtral's at 1: its fp32 experts are 5.6 GB a
# layer whole)
MR_SERVE = dict(layers=8, requests=8, new=32, parity_layers=2, parity_new=8,
                gpt2_layers=4, bloom_layers=2, ep_layers=2,
                ep_parity_layers=1)


def mr_prompts(rs, cfg, n, new):
    """``n`` random prompts of 64 tokens up to 1023 (and room for ``new``
    more in ``cfg.max_seq_len``), from a numpy seed: every rank draws the
    same."""
    hi = min(1024, cfg.max_seq_len - new + 1)
    return [rs.randint(0, cfg.vocab_size, (int(t),))
            for t in rs.randint(64, hi, n)]


def mr_serve_run(eng, prompts, new, L, tag, alibi=False, wq=0,
                 experts=False):
    """``serve_run`` on this rank of a multi-rank engine with the rank's
    exact launch gates: K4 a layer each decode forward, K5 a layer each
    chunk or prefill forward (none under ALiBi: dense, as in JAX), K7
    ``wq`` a layer and forward (all sm90), K8's grouped pair one each a
    layer and forward with ``experts``; each kernel's launches by design.
    -> (streams as lists, stats)."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops.cuda import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.cuda import mlp_matmul as mm
    from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
    mm.reset_launch_counts()
    gm.reset_launch_counts()
    comm.get_comms_logger().reset()
    outs, stats, launches = serve_run(eng, prompts, new, pa)
    fc = eng.forward_counts
    fwd = sum(fc.values())
    want = {"paged_decode": L * fc["decode"],
            "paged_chunk": 0 if alibi else L * (fc["chunk"] + fc["prefill"])}
    assert launches == want and launches["paged_decode"] > 0, \
        (tag, launches, want)
    launches["wq_matmul"] = mm.LAUNCHES["wq_matmul"]
    assert launches["wq_matmul"] == wq * L * fwd, (tag, launches)
    for k in ("grouped_swiglu_up", "grouped_gmm"):
        launches[k] = gm.LAUNCHES[k]
        assert launches[k] == (L * fwd if experts else 0), (tag, launches)
    designs = {
        n: {k: v for k, v in mod.DESIGN_LAUNCHES[n].items() if v}
        for mod, names in ((pa, ("paged_decode", "paged_chunk")),
                           (mm, ("wq_matmul",)),
                           (gm, ("grouped_swiglu_up", "grouped_gmm")))
        for n in names}
    for n in ("paged_decode", "paged_chunk", "wq_matmul",
              "grouped_swiglu_up", "grouped_gmm"):
        assert sum(designs[n].values()) == launches[n], (tag, n, designs)
    for n in ("paged_chunk", "wq_matmul"):
        assert set(designs[n]) <= {"sm90"}, (tag, n, designs)
    for o in outs:
        assert len(o) == new and ((o >= 0) & (o < eng.model.config
                                              .vocab_size)).all(), tag
    assert pools_full(eng), tag
    stats.update(tag=tag, n_layer=L, launches=launches,
                 launches_by_design=designs, agreement=eng.agreement(),
                 staged={k: list(v) for k, v in
                         comm.get_comms_logger().host_staged.items()})
    return [o.tolist() for o in outs], stats


def mr_decode_window(eng, prompts):
    """The comm layer's traffic a decode step of this rank: ``prompts``
    admitted and prefilled (their chunks run until none is left), then one
    decode dispatch with the comms logger on. -> per decode step, {op:
    [calls, bytes]} staged through host memory and moved by each
    collective."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.runtime.config import CommsLoggerConfig
    n = eng.config.decode_steps_per_dispatch
    uids = [eng.put(p, 2 * n + 2) for p in prompts]
    while eng._pending or eng._prefill_q:
        eng.step()
    lg = comm.get_comms_logger()
    lg.reset()
    lg.configure(CommsLoggerConfig(enabled=True))
    before = eng.forward_counts["decode"]
    eng.step()
    steps = eng.forward_counts["decode"] - before
    lg.configure(CommsLoggerConfig(enabled=False))
    assert steps == n, (steps, n)
    out = {"decode_steps": steps,
           "host_staged": {k: [v[0] / steps, v[1] / steps]
                           for k, v in lg.host_staged.items()},
           "collectives": {f"{op}:{ax}": [v[0] / steps, v[1] / steps]
                           for op, axes in lg.comms_dict.items()
                           for ax, v in axes.items()}}
    while eng.has_work:
        eng.step()
    for u in uids:
        eng.get(u)
    return out


def mr_parity(build, conf, prompts, new, rank, **common):
    """fp32 greedy streams of a multi-rank engine (``conf``) and, on rank
    0, of a one-rank engine on the same weights (``build()`` makes the
    model from one seed on every rank), both with the engine settings
    ``common`` (weight_quant). -> (multi-rank streams, one-rank streams or
    None)."""
    from deepspeed_tpu_torch import InferenceEngineV2, comm
    from deepspeed_tpu_torch.ops.cuda import mlp_matmul as mm
    base = dict(dtype="float32", kv_block_size=64, max_batch_size=4,
                splitfuse_tokens=256, **common)
    one = None
    if rank == 0:
        eng = InferenceEngineV2(build(), base, device="cuda:0")
        one = [o.tolist() for o in eng.generate_all(prompts,
                                                    max_new_tokens=new)]
        del eng
    comm.barrier()
    mm.reset_launch_counts()
    eng = InferenceEngineV2(build(), dict(base, **conf), device="cuda:0")
    got = [o.tolist() for o in eng.generate_all(prompts, max_new_tokens=new)]
    assert eng.multi_rank
    # K7 three a layer and forward on the rank's slices when quantized
    fwd = eng.model.config.n_layer * sum(eng.forward_counts.values())
    wq = 3 * fwd if common.get("weight_quant") in ("int8", "int4") else 0
    assert mm.LAUNCHES["wq_matmul"] == wq, (conf, common, dict(mm.LAUNCHES))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return got, one


def mr_model(cls_name, preset, n_layer, dtype, seed=0):
    """A preset of ``deepspeed_tpu_torch`` at ``n_layer`` layers, built
    whole on cuda:0 from ``seed`` (the same weights on every rank)."""
    import deepspeed_tpu_torch as dt
    cfg = dataclasses.replace(preset, n_layer=n_layer,
                              dtype=str(dtype).split(".")[-1])
    return getattr(dt, cls_name)(cfg, device="cuda:0", dtype=dtype,
                                 seed=seed)


def child_serve_tp():
    """Phases 50a-b in one rank of a tensor_parallel = 2 world on cuda:0.
    (a) Llama-2-7B widths: at MR_SERVE["parity_layers"] layers in fp32 the
    tp = 2 greedy streams (rank 0's one-rank engine on the same weights
    beside them), unquantized and under weight_quant int8 and int4 (the
    one-rank engine quantized alike); MR_SERVE["layers"] layers in bf16
    serving 8 prompts of
    64-1023 tokens, 32 new each, split-fuse 256 (K4 / K5 at 16 local
    heads), the rank's decode-step traffic, then the same under
    weight_quant int8 (K7 on the rank's F / 2 = 5504 columns and rows).
    (b) GPT-2 1.3B (the per-head wqkv split) and Bloom-7b1 (ALiBi: K4 with
    the head offset) the same way at their cut depths. Reports streams,
    stats (TTFT / TPOT p50, tokens/s, peak GB, launches by design) and the
    comm layer's traffic."""
    from deepspeed_tpu_torch import (BLOOM_PRESETS, GPT2_1_3B, LLAMA_PRESETS,
                                     InferenceEngineV2)
    from deepspeed_tpu_torch.ops.cuda import mlp_matmul as mm
    rank, world = child_world()
    P = MR_SERVE
    tp = dict(tensor_parallel=world)
    bf = dict(dtype="bfloat16", kv_block_size=64, max_batch_size=8,
              splitfuse_tokens=256, decode_steps_per_dispatch=8,
              tensor_parallel=world)
    report = {"rank": rank, "parity": {}, "serve": {}}
    rs = np.random.RandomState(50)
    for tag, cls, preset in (
            ("llama2-7b", "Llama", LLAMA_PRESETS["llama2-7b"]),
            ("gpt2-1.3b", "GPT2", GPT2_1_3B),
            ("bloom-7b1", "Bloom", BLOOM_PRESETS["bloom-7b1"])):
        vocab = preset.vocab_size
        prompts = [rs.randint(0, vocab, (n,)) for n in (7, 64, 300)]
        quants = ("auto", "int8", "int4") if tag == "llama2-7b" else \
            ("auto",)
        for wq in quants:
            # the quantized parities: the whole tree's int8 / int4 codes
            # sliced (row shards on the global scale) and K7 on the
            # rank's F / 2 columns and rows, in fp32
            report["parity"][tag if wq == "auto" else f"{tag}-{wq}"] = \
                mr_parity(lambda: mr_model(cls, preset, P["parity_layers"],
                                           torch.float32),
                          tp, prompts, P["parity_new"], rank,
                          weight_quant=wq)
        L = {"llama2-7b": P["layers"], "gpt2-1.3b": P["gpt2_layers"],
             "bloom-7b1": P["bloom_layers"]}[tag]
        prompts = mr_prompts(rs, preset, P["requests"], P["new"])
        modes = ("bf16", "int8") if tag == "llama2-7b" else ("bf16",)
        for mode in modes:
            gc.collect()
            torch.cuda.empty_cache()
            model = mr_model(cls, preset, L, torch.bfloat16)
            eng = InferenceEngineV2(model, dict(
                bf, weight_quant="int8" if mode == "int8" else "auto"),
                device="cuda:0")
            streams, stats = mr_serve_run(
                eng, prompts, P["new"], L, f"{tag}-tp{world}-{mode}",
                alibi=getattr(preset, "alibi", False),
                wq=(3 if mode == "int8" else 0))
            stats["decode_window"] = mr_decode_window(eng, prompts)
            stats["local_shapes"] = {
                k: list(v.shape) for k, v in
                {**dict(model.blocks.named_parameters()),
                 **model.qblocks}.items()}
            stats["pool"] = list(eng.cache["k"][0].shape)
            if mode == "int8":
                stats["wq_plan"] = {
                    f"{M}x{K}x{N}": list(mm.wq_plan(M, K, N))
                    for M in (8, 256) for K, N in (
                        (preset.d_model, preset.ffn_dim // world),
                        (preset.ffn_dim // world, preset.d_model))}
            # "-tp2-" keeps the path apart from phase 45's gpt2-1.3b-bf16
            report["serve"][f"{tag}-tp{world}-{mode}"] = dict(
                streams=streams, stats=stats)
            del eng, model
    return report


def child_serve_ep():
    """Phase 51 in one rank of an expert_parallel = 2 world on cuda:0:
    Mixtral-8x7B widths. At MR_SERVE["ep_parity_layers"] layers in fp32
    the ep = 2 greedy streams (rank 0's one-rank engine beside them); then
    MR_SERVE["ep_layers"] layers in bf16 serving 8 prompts, 32 new each,
    split-fuse 256: 4 experts a rank, K8's grouped pair one each a layer
    and forward on the rank's exchanged rows, K4 / K5 at all 32 heads; the
    rank's decode-step traffic (the exchange and the gather staged through
    host memory)."""
    from deepspeed_tpu_torch import MIXTRAL_8X7B, InferenceEngineV2
    rank, world = child_world()
    P = MR_SERVE
    rs = np.random.RandomState(51)
    vocab = MIXTRAL_8X7B.vocab_size
    report = {"rank": rank}
    prompts = [rs.randint(0, vocab, (n,)) for n in (7, 64, 300)]
    report["parity"] = {"mixtral-8x7b": mr_parity(
        lambda: mr_model("Mixtral", MIXTRAL_8X7B, P["ep_parity_layers"],
                         torch.float32), dict(expert_parallel=world),
        prompts, P["parity_new"], rank)}
    L = P["ep_layers"]
    prompts = mr_prompts(rs, MIXTRAL_8X7B, P["requests"], P["new"])
    model = mr_model("Mixtral", MIXTRAL_8X7B, L, torch.bfloat16)
    eng = InferenceEngineV2(model, dict(
        dtype="bfloat16", kv_block_size=64, max_batch_size=8,
        splitfuse_tokens=256, decode_steps_per_dispatch=8,
        expert_parallel=world), device="cuda:0")
    streams, stats = mr_serve_run(eng, prompts, P["new"], L,
                                  "mixtral-8x7b-ep2", experts=True)
    stats["decode_window"] = mr_decode_window(eng, prompts)
    stats["local_shapes"] = {k: list(v.shape) for k, v in
                             model.blocks.named_parameters()}
    report["serve"] = {"mixtral-8x7b-ep2": dict(streams=streams,
                                                stats=stats)}
    return report


def mr_check(reps, role):
    """Both ranks' streams identical in every run; each parity's
    multi-rank streams equal rank 0's one-rank streams. Logs each run's
    stats (rank 0's, with both ranks' peak GB) and returns {path:
    launches} (rank 0's; rank 1's are the same, checked)."""
    out = {}
    for name, (got, one) in reps[0]["parity"].items():
        for r in reps[1:]:
            assert r["parity"][name][0] == got, f"{role} {name}: ranks differ"
        assert got == one, f"{role} {name}: multi-rank != one rank"
        log(f"phase {role} parity ok: {name}, fp32, the multi-rank greedy "
            f"streams on every rank == the one-rank engine's "
            f"({sum(len(t) for t in got)} tokens)")
    for name, run in reps[0]["serve"].items():
        for r in reps[1:]:
            assert r["serve"][name]["streams"] == run["streams"], \
                f"{role} {name}: ranks' streams differ"
            assert r["serve"][name]["stats"]["launches"] == \
                run["stats"]["launches"], f"{role} {name}: launches differ"
        stats = dict(run["stats"])
        stats["peak_gb_by_rank"] = [r["serve"][name]["stats"][
            "max_memory_allocated_gb"] for r in reps]
        # each rank's own picks that rank 0's broadcast replaced: the
        # ranks' streams are equal by construction, this counts where
        # their logits would have parted
        stats["agreement_by_rank"] = [r["serve"][name]["stats"][
            "agreement"] for r in reps]
        log(f"phase {role} slice " + json.dumps(stats))
        for k, by in stats["launches_by_design"].items():
            count_designs(k, by)
        out[f"{name}-serve"] = {k: v for k, v in stats["launches"].items()
                                if v}
    return out


def phase_serve_tp(card):
    """Phase 50: tensor-parallel serving in two processes on cuda:0
    (child_serve_tp). One card measures correctness and launch counts:
    its TPOT is set by gloo's host staging and says nothing of tensor
    parallelism's speed on two cards."""
    reps = run_children("serve-tp", timeout=600)
    log(f"phase 50 card: {card} (a one-card world: TPOT set by gloo's "
        f"host staging, not tensor parallelism's speed on two cards)")
    return mr_check(reps, "50")


def phase_serve_ep(card):
    """Phase 51: expert-parallel serving in two processes on cuda:0
    (child_serve_ep); the same caveat as phase 50."""
    reps = run_children("serve-ep", timeout=600)
    log(f"phase 51 card: {card} (a one-card world)")
    return mr_check(reps, "51")


def add_paths(paths, new):
    """Merge a phase's {path: launches} into ``paths``; a path name an
    earlier phase took raises (its launches would drop out of the kernels
    line)."""
    clash = set(new) & set(paths)
    assert not clash, f"path names taken by an earlier phase: {sorted(clash)}"
    paths.update(new)


def fresh_winner_cache():
    """Point the autotune winner cache (cache_only) at a fresh, empty file
    in a temporary directory, removed at exit, before any phase: a cache
    file of an earlier run must not steer this run's launch counts. Child
    processes inherit it."""
    import atexit
    import shutil
    import tempfile
    from deepspeed_tpu_torch.autotuning import KernelCache
    from deepspeed_tpu_torch.autotuning.kernel_cache import CACHE_PATH_ENV
    d = tempfile.mkdtemp(prefix="chip-smoke-autotune-")
    atexit.register(shutil.rmtree, d, ignore_errors=True)
    path = os.path.join(d, "kernel_autotune.json")
    KernelCache().save(path)
    os.environ[CACHE_PATH_ENV] = path
    os.environ["DSTPU_AUTOTUNE"] = "cache_only"
    log(f"autotune winner cache: cache_only on a fresh file {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="",
                    help="write a torch.profiler breakdown of the slice here")
    ap.add_argument("--child", choices=(
        "parity", "train", "zero-parity", "zero-train", "serve-tp",
        "serve-ep", *(f"ep:{name}" for name in EP_RUNS)),
        help=argparse.SUPPRESS)      # phases 28-29, 31-32, 39, 50-51
    ap.add_argument("--child-out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if not args.child:
        fresh_winner_cache()
    if args.child:
        if args.child.startswith("ep:"):
            report = child_ep(args.child[3:])
        else:
            report = {"parity": child_parity, "train": child_train,
                      "zero-parity": child_zero_parity,
                      "zero-train": child_zero_train,
                      "serve-tp": child_serve_tp,
                      "serve-ep": child_serve_ep}[args.child]()
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
                                                FlashAttentionF16Builder,
                                                FusedCEBuilder,
                                                GroupedMatmulBuilder,
                                                LayerNormBuilder,
                                                MlpMatmulBuilder,
                                                PagedAttentionBuilder,
                                                QuantizationBuilder)
    builders = [PagedAttentionBuilder(), FlashAttentionBuilder(),
                FlashAttentionF16Builder(), FusedCEBuilder(),
                GroupedMatmulBuilder(), MlpMatmulBuilder(),
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
    fa.kernel_builder(torch.float16)
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
    phase_done(f"29 (GPT-2 350M widths, {PHASE29['layers']} layers, at "
               f"T=4096, seq = 2)")
    rows.update(phase_rmsnorm_kernel(ln))
    paths["rmsnorm-op"] = phase_rmsnorm_op(ln)
    phase_done("30 (K13 RMSNorm)")
    paths["moe-dp2"] = phase_zero_parity()
    phase_done("31 (two processes on cuda:0: ZeRO 0-3 at dp = 2 parity, "
               "GPT-2 and GPT2MoE)")
    paths["gpt2-zero-train"] = phase_zero_slice()
    phase_done("32 (GPT-2 350M at dp = 2, ZeRO-2 and ZeRO-3, a ZeRO-3 tag "
               "resumed at dp = 1)")
    paths["gpt2-ckpt-train"] = phase_checkpoint(card)
    phase_done("33 (GPT-2 350M checkpoints: sync, async, native)")
    paths["llama-router-serve"] = phase_router(card)
    phase_done("34 (serving front-end: Router / Replica, a disaggregated "
               "Llama-2-7B fleet)")
    feature_paths, rows["paged_chunk"]["verify"] = phase_features(card, pa)
    paths.update(feature_paths)
    phase_done("35 (serving features: prefix cache, speculative decoding, "
               "KV host offload on Llama-2-7B)")
    d128 = phase_llama_attention_kernels(fa)
    for name, figures in d128.items():
        rows[name]["d128"] = figures
    phase_llama_train_parity()
    paths["llama-train"] = phase_llama_train_slice(
        "llama", profile=profile_path("llama-train"))
    paths["mixtral-train"] = phase_llama_train_slice(
        "mixtral", profile=profile_path("mixtral-train"))
    phase_done("36 (K1 / K2 at d = 128, Llama / Mixtral training parity, "
               "Llama-2-7B and Mixtral-8x7B training)")
    for name, figures in phase_fp16_kernels(fa).items():
        rows[name]["fp16"] = figures
    phase_done("37 (K1 / K2 on fp16 operands)")
    paths["gpt2-fp16-train"] = phase_fp16_slice()
    phase_done("38 (GPT-2 350M in fp16 with WarmupDecayLR; LAMB, Lion, "
               "Adagrad, SGD)")
    paths.update(phase_ep())
    phase_done("39 (MoE expert parallel: GPT2MoE and Mixtral at ep = 2, "
               "the staged exchange at data_outer 2 x expert 2)")
    for name, cases in phase_family_kernels(fa, pa, mm).items():
        rows[name]["families"] = cases
    phase_done("40 (K1 / K2 with ALiBi, K1 / K2 / K4 / K5 at d = 80, 96, "
               "256, K4 / K5 at G = 71 and 7, K7 at the non-gated FFNs)")
    paths["bloom-serve"] = phase_bloom_serve()
    phase_done(f"41 (Bloom-7b1 serving, {BLOOM_SERVE['layers']} layers)")
    paths["bloom-train"] = phase_bloom_train()
    phase_done(f"42 (Bloom-7b1 training, {BLOOM_TRAIN['layers']} layers)")
    paths.update(phase_family_serve())
    phase_done(f"43 (Falcon-7b, GPT-NeoX-20B, GPT-J-6B, InternLM-7B, "
               f"Phi-2, Qwen2-7B serving, {FAMILY_SERVE['layers']} layers "
               f"each)")
    for name, cases in phase_gpt2_family_kernels(pa, mm, fce).items():
        rows[name]["gpt2_family"] = cases
    phase_done("44 (K4 / K5 at GPT-2 1.3B's and GPT-Neo-1.3B's attention, "
               "K7 at GPT-2 1.3B's FFN, K3 at GPT-Neo's vocabulary)")
    paths.update(phase_gpt2_serve(pa, mm))
    phase_done(f"45 (GPT-2 1.3B serving, {GPT2_SERVE['layers']} layers: "
               f"bf16, int8, int4, a GPT-2 125M draft)")
    paths.update(phase_gpt2_families(pa, mm, fa, fce))
    phase_done(f"46 (OPT-1.3b and GPT-Neo-1.3B serving, "
               f"{GPT2_FAMILY_SERVE['layers']} layers; "
               f"GPT-Neo training, {GPTNEO_TRAIN['layers']} layers)")
    paths["llama-winner-cache"] = phase_winner_cache(pa)
    phase_done(f"47 (the autotune winner cache: cold resolvers, "
               f"{len(winner_searches())} searches, Llama-2-7B served "
               f"from the filled file at {WINNER_SERVE['layers']} layers, "
               f"refusals)")
    paths.update(phase_gpt2moe_serve(pa, gm, mm))
    phase_done(f"48 (GPT2MoE serving at the 350M widths, "
               f"{GPT2MOE_SERVE['layers']} layers: ragged, dense; int8 at "
               f"{GPT2MOE_SERVE['int8_layers']})")
    paths.update(phase_gpt2moe_dense_train(fa, fce, gm))
    phase_done(f"49 (GPT2MoE dense training, {GPT2MOE_TRAIN['layers']} "
               f"layers; dense == ragged without drops; an RSample step)")
    add_paths(paths, phase_serve_tp(card))
    phase_done(f"50 (two processes on cuda:0: tensor_parallel = 2 serving, "
               f"Llama-2-7B at {MR_SERVE['layers']} layers bf16 and int8, "
               f"GPT-2 1.3B at {MR_SERVE['gpt2_layers']}, Bloom-7b1 at "
               f"{MR_SERVE['bloom_layers']}; fp32 == one rank, unquantized "
               f"and int8 / int4)")
    add_paths(paths, phase_serve_ep(card))
    phase_done(f"51 (two processes on cuda:0: expert_parallel = 2 serving, "
               f"Mixtral-8x7B at {MR_SERVE['ep_layers']} layers; fp32 == "
               f"one rank)")

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
                      "first_chunk", "long_walk", "verify", "d128",
                      "fp16", "families", "gpt2_family"):
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
