// A Hopper GEMM mainloop (sm_90a): TMA loads into a shared-memory ring,
// wgmma from shared memory, warp-specialised and persistent. K3's bf16
// instance (fused_ce.cu, fused_ce_sm90_kernel), K6's (mlp_matmul.cu,
// proj_mm_sm90_kernel) and K8's expert dW and forward / dx products
// (grouped_matmul.cu, grouped_tgmm_sm90_kernel, grouped_gmm_sm90_kernel)
// are this loop with their own epilogues.
//
// Problem: O[z, i, j] = sum_q sum_c A[z, q, i, c] * B[z, q, c, j] in bf16
// with fp32 accumulation. Each operand is addressed by a TMA tensor map
// built on the host (make_operand_map) over (inner, outer[, q][, z]), inner
// contiguous, with a 128-byte swizzle:
//   A K-major  (c contiguous): box 64 c x 128 i, one load a stage;
//   A MN-major (i contiguous): box 64 i x 64 c, two loads (one per
//              consumer's 64 rows);
//   B K-major  (c contiguous): box 64 c x 256 j, one load;
//   B MN-major (j contiguous): box 64 j x 64 c, four loads.
// The orientation is the wgmma transpose bit (TA / TB = 1 for MN-major), so
// no layout costs a copy. Dims of extent 1 or stride 0 are left out of the
// map (a broadcast operand is read at coordinate 0). TMA fills loads past a
// tensor's bounds with zeros, so a ragged k slice adds nothing and ragged
// rows / columns are only masked at the store.
//
// The CTA (384 threads, one per SM, a static-stride walk over the tiles):
//   warpgroup 0, the producer: setmaxnreg.dec to 40; one thread waits for a
//     ring slot's empty barrier, arms its full barrier with the stage's
//     bytes and issues the stage's TMA loads (A then B) into it;
//   warpgroups 1 and 2, the consumers: setmaxnreg.inc to 232; each owns 64
//     rows of the 128 x 256 output tile, waits for a slot's full barrier,
//     issues four wgmma m64n256k16 (one 64-deep slice) from swizzled shared
//     memory descriptors, keeps one wgmma group in flight and releases the
//     previous slot through its empty barrier (one arrive per warp). On a
//     finished tile each calls the kernel's epilogue functor on its 64 x 256
//     fp32 accumulator; the producer meanwhile loads the next tile's slices.
// Tile order is a parameter: group_m row tiles per column band (K6: 8, for
// L2 reuse; K3: every row tile, so each vocab tile of w is read from device
// memory once while h stays in L2).
//
// The walk is a functor too (``Walk``): by default the static order above;
// grouped_gmm_sm90_kernel resolves a logical tile on the device to an
// expert's row segment of a physical row tile (or to nothing: a dead tile,
// which loads and stores nothing). Producer and consumers call the same
// functor on the same t, so they agree on every tile without a message.
//
// The contraction range of a tile is a functor of its z (``Range``): the
// whole of [0, C) by default, or a range only the device knows
// (grouped_tgmm: expert z's rows, from the group sizes in device memory).
// The k-loop's TMA coordinates start at the range's first c, which needs
// no alignment. TMA zero-fills only past the tensor's bounds, so where the
// range ends inside the tensor (Range::MASK_A) the consumers zero their
// A lines at or past its end in the last slice before any wgmma reads them:
// in the MN-major A box each c is one whole 128-byte swizzle line, so the
// zeroing does not depend on the swizzle; a fence.proxy.async orders the
// generic stores before wgmma's async-proxy reads, and the warpgroup's
// named barrier makes every thread's stores visible.
//
// Shared memory: 4 stages x (16 KB A + 32 KB B) = 192 KB, two 16 KB epilogue
// staging tiles (64 x 64 bf16 with a 16-byte row pad, or two 64 x 64 TMA
// boxes), 8 barriers and up to 1 KB to align the ring to the 1024-byte
// swizzle atom: 225 KB of 227.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through cudart
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;  // output rows of a tile (two consumer warpgroups of 64)
constexpr int BN = 256;  // output columns of a tile (wgmma n = 256)
constexpr int BK = 64;   // 64 bf16 = 128 bytes: one swizzle atom of k
constexpr int STAGES = 4;
constexpr int THREADS = 384;
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int EPI_COLS = 64;               // columns staged per epilogue pass
constexpr int EPI_PITCH = EPI_COLS + 8;    // bf16 per staged line (16-byte pad)
// a consumer's staging tile: one padded 64 x 64 bf16 tile (store_tile), or
// two 64 x 64 TMA boxes (grouped_gmm's double-buffered TMA store)
constexpr int EPI_BYTES = 2 * 64 * EPI_COLS * 2;
static_assert(64 * EPI_PITCH * 2 <= EPI_BYTES, "store_tile's padded tile fits");
constexpr int SMEM_BYTES = 1024 + STAGES * (A_BYTES + B_BYTES) + 2 * EPI_BYTES + 2 * STAGES * 8;
static_assert(SMEM_BYTES <= 232448, "one CTA per SM");

// The walk: tile t of num_tiles -> (z, row tile, column tile); the maps'
// ranks and whether their third dim is q (else z).
struct Problem {
  int Z, Q, I, J, C;
  int tiles_i, tiles_j, group_m, num_tiles;
  int a_rank, a_dim2_q, b_rank, b_dim2_q;
};

// ------------------------------------------------------------------ device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the barrier's phase differs from ``parity``.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA load of a box at coordinates (c0, c1[, c2][, c3]) into shared
// memory, completing on ``bar``.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int rank,
                                         int c0, int c1, int c2, int c3) {
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  const uint32_t d = smem_u32(dst), b = smem_u32(bar);
  if (rank == 2)
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(d),
        "l"(m), "r"(b), "r"(c0), "r"(c1)
        : "memory");
  else if (rank == 3)
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(d),
        "l"(m), "r"(b), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(d),
        "l"(m), "r"(b), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One TMA store of a box at (c0, c1) from shared memory, in the issuing
// thread's bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// TMA store completion, per issuing thread: commit its stores as a group;
// wait until every committed group has read its shared-memory source; wait
// until every committed group has finished.
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units). K-major: rows of 128 bytes, 8-row
// groups 1024 bytes apart (SBO), k advanced by moving the start 32 bytes per
// 16 values. MN-major: 128-byte lines of 64 MN values, one per k, 8-k groups
// 1024 bytes apart (SBO), 64-wide MN atoms one 8 KB box apart (LBO), k
// advanced by 16 lines (2048 bytes).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma issue / wait.
__device__ __forceinline__ void fence_acc(float (&d)[BN / 2]) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, fp32 fragments) += A (64 x 16) * B (16 x 256), both from
// shared memory; TA / TB: operand MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Accumulator fragment of wgmma m64nNk16 (per warpgroup thread tid): value
// d[4 b + e] is at row 16 (tid / 32) + (tid % 32) / 4 + 8 (e / 2), column
// 8 b + 2 (tid % 4) + e % 2.
__device__ __forceinline__ int frag_row(int tid, int e) {
  return (tid >> 5) * 16 + ((tid & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int tid, int b, int e) { return b * 8 + 2 * (tid & 3) + (e & 1); }

// Writes a consumer's 64 x 256 accumulator as bf16: element (r, c) to
// out[r * ld + c], or out[c * ld + r] when TRANS, for row_lo <= r < rows
// (row_lo: not TRANS) and c < cols. 64 columns at a time go through ``stage`` (laid out along the
// output's contiguous axis) so that each thread stores 16 contiguous bytes
// (``vec``: out and ld allow it; else element stores).
template <bool TRANS>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2], bf16* stage, bf16* out,
                                           long long ld, int rows, int cols, bool vec, int bar,
                                           int tid, int row_lo = 0) {
#pragma unroll
  for (int pass = 0; pass < BN / EPI_COLS; ++pass) {
    if (pass * EPI_COLS >= cols) break;  // uniform across the warpgroup
    named_sync(bar);                      // the previous pass has been read
#pragma unroll
    for (int b = 0; b < EPI_COLS / 8; ++b) {
      const int k = (pass * EPI_COLS / 8 + b) * 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = frag_row(tid, 2 * h), c = frag_col(tid, b, 0);
        const bf16 v0 = __float2bfloat16(acc[k + 2 * h]), v1 = __float2bfloat16(acc[k + 2 * h + 1]);
        if (TRANS) {
          stage[c * EPI_PITCH + r] = v0;
          stage[(c + 1) * EPI_PITCH + r] = v1;
        } else {
          *reinterpret_cast<__nv_bfloat162*>(stage + r * EPI_PITCH + c) = __halves2bfloat162(v0, v1);
        }
      }
    }
    named_sync(bar);
    // 64 lines of 64 values: 512 runs of 8, four per thread
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int run = tid + 128 * k, line = run >> 3, off = (run & 7) * 8;
      const int r = TRANS ? off : line, c = pass * EPI_COLS + (TRANS ? line : off);
      const int n = TRANS ? (c < cols ? rows - r : 0)
                          : (r >= row_lo && r < rows ? cols - c : 0);
      if (n <= 0) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(stage + line * EPI_PITCH + off);
      bf16* dst = TRANS ? out + (long long)c * ld + r : out + (long long)r * ld + c;
      if (vec && n >= 8) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const bf16* e = reinterpret_cast<const bf16*>(&v);
        for (int u = 0; u < 8 && u < n; ++u) dst[u] = e[u];
      }
    }
  }
}

__device__ __forceinline__ void tile_coords(const Problem& p, int t, int& z, int& ti, int& tj) {
  const int per_z = p.tiles_i * p.tiles_j;
  z = t / per_z;
  int r = t - z * per_z;
  const int band = p.group_m * p.tiles_j;
  const int first = (r / band) * p.group_m;
  const int gm = min(p.group_m, p.tiles_i - first);
  r -= (r / band) * band;
  ti = first + r % gm;
  tj = r / gm;
}

// The default walk: every tile of the static order, each live.
struct StaticWalk {
  __device__ __forceinline__ bool operator()(const Problem& p, int t, int& z, int& ti,
                                             int& tj) const {
    tile_coords(p, t, z, ti, tj);
    return true;
  }
};

// The default contraction range: every c of every q.
struct FullRange {
  static constexpr bool MASK_A = false;
  __device__ __forceinline__ void operator()(const Problem& p, int, int& lo, int& hi) const {
    lo = 0;
    hi = p.C;
  }
};

extern __shared__ __align__(128) unsigned char sm90_smem[];  // aligned to 1024 at run time

// An epilogue's optional ``finish(tid)``, called by each consumer thread
// once its last tile is stored (an epilogue that stores by TMA drains its
// stores there).
template <class E>
__device__ __forceinline__ auto epilogue_finish(const E& e, int tid, int) -> decltype(e.finish(tid)) {
  return e.finish(tid);
}
template <class E>
__device__ __forceinline__ void epilogue_finish(const E&, int, long) {}

// The kernel body: ``epi(acc, z, i0, j0, stage, tid, bar)`` is called by
// each consumer warpgroup on its 64 rows (from i0) x 256 columns (from j0)
// of a finished tile; ``stage`` is its own staging tile (1024-aligned),
// ``tid`` its thread in the warpgroup and ``bar`` its named barrier.
template <int TA, int TB, class Epi, class Range = FullRange, class Walk = StaticWalk>
__device__ __forceinline__ void gemm(const CUtensorMap& ma, const CUtensorMap& mb,
                                     const Problem& p, const Epi& epi,
                                     const Range& range = Range(), const Walk& walk = Walk()) {
  static_assert(!Range::MASK_A || TA, "A rows are zeroed by whole lines: A MN-major");
  unsigned char* base = sm90_smem + ((1024 - (smem_u32(sm90_smem) & 1023)) & 1023);
  unsigned char* sa = base;
  unsigned char* sb = base + STAGES * A_BYTES;
  bf16* epi_smem = reinterpret_cast<bf16*>(sb + STAGES * B_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + STAGES * B_BYTES + 2 * EPI_BYTES);
  uint64_t* empty = full + STAGES;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < p.num_tiles; t += gridDim.x) {
        int z, ti, tj;
        if (!walk(p, t, z, ti, tj)) continue;
        const int i0 = ti * BM, j0 = tj * BN;
        int lo, hi;
        range(p, z, lo, hi);
        const int nc = hi > lo ? (hi - lo + BK - 1) / BK : 0;
        const int steps = p.Q * nc;
        for (int s = 0; s < steps; ++s) {
          const int q = s / nc, c0 = lo + (s - q * nc) * BK;
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], A_BYTES + B_BYTES);
          unsigned char* a = sa + stage * A_BYTES;
          unsigned char* b = sb + stage * B_BYTES;
          const int qa = p.a_dim2_q ? q : z, qb = p.b_dim2_q ? q : z;
          if (TA) {
            tma_load(a, &ma, &full[stage], p.a_rank, i0, c0, qa, z);
            tma_load(a + A_BYTES / 2, &ma, &full[stage], p.a_rank, i0 + 64, c0, qa, z);
          } else {
            tma_load(a, &ma, &full[stage], p.a_rank, c0, i0, qa, z);
          }
          if (TB) {
#pragma unroll
            for (int h = 0; h < BN / 64; ++h)
              tma_load(b + h * (B_BYTES * 64 / BN), &mb, &full[stage], p.b_rank, j0 + 64 * h, c0,
                       qb, z);
          } else {
            tma_load(b, &mb, &full[stage], p.b_rank, c0, j0, qb, z);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1, lane = tid & 31;
    bf16* stage_tile = epi_smem + cw * (EPI_BYTES / 2);
    float acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < p.num_tiles; t += gridDim.x) {
      int z, ti, tj;
      if (!walk(p, t, z, ti, tj)) continue;
      int lo, hi;
      range(p, z, lo, hi);
      const int nc = hi > lo ? (hi - lo + BK - 1) / BK : 0;
      const int steps = p.Q * nc;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int s = 0; s < steps; ++s) {
        mbar_wait(&full[stage], phase);
        unsigned char* a = sa + stage * A_BYTES + cw * (A_BYTES / 2);
        const unsigned char* b = sb + stage * B_BYTES;
        if (Range::MASK_A) {
          // lines c >= hi of the range's last slice (this consumer's 64 i)
          const int live = hi - (lo + (s % nc) * BK);
          if (live < BK) {
            for (int u = live * 8 + tid; u < BK * 8; u += 128)
              reinterpret_cast<uint4*>(a)[u] = make_uint4(0u, 0u, 0u, 0u);
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            named_sync(1 + cw);
          }
        }
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da = TA ? smem_desc(a + kk * 2048, 8192, 1024) : smem_desc(a + kk * 32, 16, 1024);
          const uint64_t db = TB ? smem_desc(b + kk * 2048, 8192, 1024) : smem_desc(b + kk * 32, 16, 1024);
          wgmma_m64n256k16<TA, TB>(acc, da, db);
        }
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();  // the previous slice's products are done
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      epi(acc, z, ti * BM + 64 * cw, tj * BN, stage_tile, tid, 1 + cw);
    }
    epilogue_finish(epi, tid, 0);
  }
}

// -------------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (the
// library links cudart only).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A map over a bf16 operand X[z, q, outer, inner] (strides in elements,
// inner contiguous) with a (64, box_outer) box and the 128-byte swizzle;
// q and z are map dims only where they have extent > 1 and a stride.
inline cudaError_t make_operand_map(CUtensorMap* map, const void* base, long long inner,
                                    long long outer, long long s_outer, int Q, long long s_q, int Z,
                                    long long s_z, int box_outer, int* rank, int* dim2_q) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[4] = {(cuuint64_t)inner, (cuuint64_t)outer, 1, 1};
  cuuint64_t strides[3] = {(cuuint64_t)s_outer * 2, 0, 0};
  int r = 2;
  *dim2_q = 0;
  if (Q > 1 && s_q != 0) {
    dims[r] = Q;
    strides[r - 1] = (cuuint64_t)s_q * 2;
    *dim2_q = 1;
    ++r;
  }
  if (Z > 1 && s_z != 0) {
    dims[r] = Z;
    strides[r - 1] = (cuuint64_t)s_z * 2;
    ++r;
  }
  const cuuint32_t box[4] = {64, (cuuint32_t)box_outer, 1, 1}, unit[4] = {1, 1, 1, 1};
  *rank = r;
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, r, const_cast<void*>(base), dims,
                          strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Maps of both operands for the problem's orientation (TA: A MN-major, TB:
// B MN-major), strides in elements as (z, q, i, c) and (z, q, c, j).
inline cudaError_t make_maps(CUtensorMap* ma, CUtensorMap* mb, Problem* p, const void* a,
                             const long long (&sa)[4], int ta, const void* b,
                             const long long (&sb)[4], int tb) {
  cudaError_t e = ta ? make_operand_map(ma, a, p->I, p->C, sa[3], p->Q, sa[1], p->Z, sa[0], 64,
                                        &p->a_rank, &p->a_dim2_q)
                     : make_operand_map(ma, a, p->C, p->I, sa[2], p->Q, sa[1], p->Z, sa[0], BM,
                                        &p->a_rank, &p->a_dim2_q);
  if (e != cudaSuccess) return e;
  return tb ? make_operand_map(mb, b, p->J, p->C, sb[2], p->Q, sb[1], p->Z, sb[0], 64, &p->b_rank,
                               &p->b_dim2_q)
            : make_operand_map(mb, b, p->C, p->J, sb[3], p->Q, sb[1], p->Z, sb[0], BN, &p->b_rank,
                               &p->b_dim2_q);
}

// The persistent grid of ``num_tiles`` tiles: one CTA per SM, at most one
// per tile.
inline int persistent_grid(int num_tiles) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return num_tiles < sms ? num_tiles : sms;
}

// Fills the walk and returns the persistent grid.
inline int plan(Problem* p, int group_m) {
  p->tiles_i = (p->I + BM - 1) / BM;
  p->tiles_j = (p->J + BN - 1) / BN;
  p->group_m = group_m < 1 ? 1 : (group_m > p->tiles_i ? p->tiles_i : group_m);
  const long long tiles = (long long)p->Z * p->tiles_i * p->tiles_j;
  if (tiles > 0x7fffffffLL) return -1;
  p->num_tiles = (int)tiles;
  return persistent_grid(p->num_tiles);
}

template <typename Kernel>
cudaError_t allow_sm90_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

}  // namespace sm90
