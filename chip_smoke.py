#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (deepspeed_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the repo root, one NVIDIA H100

Phases (any failure raises and the script exits nonzero):
  1. card: the card's name and power limit (nvidia-smi), and the build of
     every kernel of the serving path from csrc/ (nvcc, into build/).
  2. kernels: each Hopper kernel against its plain PyTorch version on the
     card at the Llama-2-7B / Mistral-7B serving shapes (bf16 against the
     plain version run in fp32 on the same inputs, see bf16_mismatch; fp32
     at 1e-4, allowing for another summation order), a control that an
     output with half its blocks dropped fails that check, then each kernel
     timed with CUDA events beside its plain version, its bound and one
     library call (SDPA on the gathered K/V, a yardstick only).
  3. parity: a small fp32 Llama served with paged_kernel=True and False on
     the card must give identical greedy streams (split-fuse on and off).
  4. slice: full-width Llama-2-7B (random weights from a seeded generator)
     serves 8 requests through InferenceEngineV2; every request returns
     its 64 tokens, and each kernel's launch count over this run equals
     the count the engine's dispatches imply.
Then one JSON line of per-kernel numbers, and last the result line
{"ok": true, "device": {...}}. Without a CUDA device it exits 2 and prints
no result. ``--profile PATH`` also writes a torch.profiler breakdown of the
slice's device time to PATH (the slice's timings then include the
profiler's overhead).
"""

import argparse
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
SOURCE = "deepspeed_tpu_torch/csrc/paged_attention.cu"
REPLACES = {
    "paged_decode": "deepspeed_tpu/ops/pallas/paged_attention.py:121",
    "paged_chunk": "deepspeed_tpu/ops/pallas/paged_attention.py:310",
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
        out = self.pa.paged_chunk_attention(q, k, v, table, start, true_len,
                                            window=window, block_c=block_c)
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
    del d32, dropped

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
    log(f"chunk cases ok, max bf16 |err| {cases.err['paged_chunk']:.3g}, "
        f"worst row relative error norm {cases.rel['paged_chunk']:.3g}")

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
        bound=bound(dec_bytes, dec_flops))
    del gk, gv, dmask

    c = main_chk
    C, H, hd = c["q"].shape
    KVH = c["k"].shape[1]
    start, tl = c["start"], c["true_len"]
    n_keys = start + tl
    pairs = sum(start + t + 1 for t in range(tl))
    chk_bytes = (2 * n_keys * KVH * hd * esz + 2 * c["q"].numel() * esz
                 + c["table"].numel() * 4)
    chk_flops = 4 * H * hd * pairs
    gk, gv = dense_kv(c["k"], c["v"], c["table"][None])
    S = gk.shape[2]
    qpos = start + torch.arange(C, device="cuda")[:, None]
    kpos = torch.arange(S, device="cuda")[None, :]
    cmask = ((kpos <= qpos) & (kpos < start + tl))[None, None]
    qc = c["q"].transpose(0, 1)[None]
    rows["paged_chunk"] = dict(
        ms=time_ms(lambda: pa.paged_chunk_attention(
            c["q"], c["k"], c["v"], c["table"], start, tl,
            block_c=c["block_c"]), 20),
        plain_ms=time_ms(lambda: pa.paged_chunk_attention_reference(
            c["q"], c["k"], c["v"], c["table"], start, tl), 5),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qc, gk, gv, attn_mask=cmask), 20),
        bound=bound(chk_bytes, chk_flops))
    log(f"decode timed case: {n_pos} positions, {dec_bytes} bytes, "
        f"{dec_flops} flops; chunk timed case: {pairs} (q, k) pairs, "
        f"{chk_bytes} bytes, {chk_flops} flops")
    for name, r in rows.items():
        r["max_abs_err"] = cases.err[name]
        log(f"{name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, sdpa "
            f"{r['library_ms']:.4f}, bound {r['bound'][0]:.4f} by "
            f"{r['bound'][1]})")
    return rows


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


def write_profile(prof, path, wall_s):
    """Device time by kernel name and the device's busy share of the
    profiled run's wall time (one stream, so kernel times do not overlap;
    the profiler's overhead lengthens that wall)."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    with open(path, "w") as f:
        f.write(f"wall_s {wall_s:.6f} device_busy_s {busy_us / 1e6:.6f} "
                f"busy_share {busy_us / 1e6 / wall_s:.4f}\n")
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="",
                    help="write a torch.profiler breakdown of the slice here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    builder = pa.kernel_builder()      # builds csrc/paged_attention.cu
    log(f"kernels built in {time.perf_counter() - t0:.1f} s (nvcc "
        f"{builder.build_seconds:.1f} s) -> {builder.so_path()}")
    for line in builder.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas " + line.strip())

    rows = phase_kernels(pa)
    phase_parity()
    launches = phase_slice(profile=args.profile)

    kernels = []
    for name, r in rows.items():
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], kernel_ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound"][0], bound_by=r["bound"][1],
            library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
