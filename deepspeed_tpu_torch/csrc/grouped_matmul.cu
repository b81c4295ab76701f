// Grouped (ragged) matmul for the dropless-MoE expert FFN, CUDA C++ for
// sm_90a.
//
// grouped_gmm_sm90_kernel / grouped_kernel<T, BM, false, WT> replace
//   deepspeed_tpu/ops/pallas/grouped_matmul.py _gmm_kernel (via _gmm, both
//   trans_w: the forward and the dx product of training).
//   out[s, n] = sum_k x[s, k] w[g(s), k, n], fp32 accumulation, one rounding
//   to the output dtype; rows past sum(group_sizes) exactly 0. w is
//   addressed through its (e, k, n) strides, so a transposed view (the dx
//   product) needs no second kernel and no (E, N, K) copy. bf16 operands
//   TMA can address, above a row count, take the Hopper design
//   (grouped_gmm_sm90_kernel: sm90_gemm.cuh's mainloop with the tiles
//   resolved on the device, below); other bf16 and fp32 the mma.sync /
//   scalar-FMA grouped_kernel, where w with a unit n stride is staged
//   [k][n] with 16-byte cp.async, w with a unit k stride (the transposed
//   view) [n][k], its B fragments by plain ldmatrix, and any other stride
//   element by element (the wrapper's _gmm_design picks one per call).
// grouped_swiglu_up_sm90_kernel / grouped_kernel<T, BM, true, false>
//   replace _swiglu_up_kernel (via _swiglu_up).
//   h = silu(x w1[g]) * (x w3[g]): one staged x tile feeds both products;
//   the silu*mul epilogue runs in fp32 and rounds h once (as
//   grouped_matmul.py:204-210). bf16 operands TMA can address, from a row
//   count the card sets, take the Hopper design (grouped_swiglu_up_sm90_kernel,
//   below: the transposed product on wgmma with the weight boxes as A,
//   K9's runs); other bf16 and fp32 the mma.sync / scalar-FMA
//   grouped_kernel (the wrapper's _swiglu_up_design picks one per call).
// grouped_tgmm_sm90_kernel / grouped_tgmm_kernel replace _tgmm_kernel (via
//   _tgmm, the weight gradient of training): dw[e, k, n] = sum over group
//   e's rows s of x[s, k] dy[s, n], fp32 accumulation, one rounding. bf16
//   operands TMA can address take the Hopper design (sm90_gemm.cuh's
//   mainloop with each expert's row range resolved on the device; see its
//   comment), other bf16 and fp32 the mma.sync / scalar-FMA kernel (the
//   wrapper's _tgmm_design picks one per call).
// grouped_gmm_wq / grouped_swiglu_up_wq (K9) replace _gmm_wq_kernel and
//   _swiglu_up_wq_kernel: the same two forward products with int8 or
//   packed-int4 expert codes and per-(expert, channel) scales. bf16 x and
//   codes TMA can address take the Hopper design (wq_grouped_sm90_kernel,
//   below, on wq_sm90.cuh); fp32 and the rest of bf16 wq_gemm.cuh's
//   wq_kernel on this file's grid and group resolution (the wrapper's
//   _wq_grouped_design picks one per call).
//
// Rows are sorted by group; group_sizes (E,) int32 stays in device memory
// (no host sync). The grid is (tiles_m + E logical tiles) x (N / 64 column
// tiles). Logical tile i is resolved in-kernel from the E sizes, replacing
// the TPU's scalar-prefetched _group_metadata maps: the non-empty groups
// and the tail [sum(group_sizes), M) partition the rows, each segment
// visits every BM-row physical tile it touches (a boundary tile is visited
// once per segment), so there are at most tiles_m + E visits. A visit
// writes only its own segment's rows, so no atomics and no read-modify-
// write are needed (the TPU kernel's `prev` carry exists only because a
// TPU output block is revisited in order); a tail visit writes zeros (the
// ragged_dot contract: rows past the groups are exactly 0). CTAs past the
// live visit count exit at once. The logical index runs fastest in the
// grid, so the visits that share a weight tile run side by side and the
// second read comes from L2.
//
// Bound: bytes at the Mixtral-8x7B serving shapes. A decode step routes
// 16 rows (8 slots x top-2) over up to 8 experts: swiglu_up streams
// 2 x 4096 x 14336 bf16 weights per touched expert (1.88 GB for 8) against
// 3.8 GFLOP. The design streams each touched expert's weight tile once per
// call: BM = 16 at decode (one physical tile, one visit per group), BM = 64
// for larger calls; 64 output columns per CTA give 224 (swiglu_up) or 64
// (gmm) column tiles per group to load the card; a 4-stage cp.async ring
// keeps ~3 weight tiles per CTA in flight. Products are mma.sync m16n8k16
// (bf16 -> fp32), B fragments read from the row-major [k][n] weight tile
// with ldmatrix.trans. The training shapes, bound by operations, take
// grouped_gmm_sm90_kernel (TMA + wgmma); split-K is later work.
//
// The extern "C" launchers return cudaGetLastError() (0 = launched); they
// never synchronize or allocate. fp32 instances do the products with
// scalar FMAs in the same fragment layout (the parity checks).

#include "gemm_common.cuh"
#include "sm90_gemm.cuh"
#include "wq_gemm.cuh"
#include "wq_sm90.cuh"

struct GroupedArgs {
  const void* x;           // (M, K) contiguous
  const void* w1;          // (E, K, N) through strides (gmm: w; swiglu_up: w1)
  const void* w3;          // swiglu_up: (E, K, N), w1's strides; gmm: unused
  const int* group_sizes;  // (E,) int32, device memory
  void* out;               // (M, N) contiguous
  long long sw_e, sw_k, sw_n;  // w strides in elements
  int M, K, N, E;
  int vec_x;     // x rows may be staged as 16-byte vectors
  int vec_w;     // w's unit-stride rows may be staged as 16-byte vectors
  int w_kmajor;  // gmm only: w has a unit k stride (a transposed view)
};

struct TgmmArgs {
  const void* x;           // (M, K) contiguous
  const void* dy;          // (M, N) contiguous
  const int* group_sizes;  // (E,) int32, device memory
  void* out;               // (E, K, N) contiguous
  int M, K, N, E;
  int vec_x, vec_dy;       // rows may be staged as 16-byte vectors
};

namespace {

// k rows [k0, k0+BK) x cols [n0, n0+BN) of one expert's (K, N) weights,
// through strides, into shared [BK][ldb]; k >= K and n >= N are zero.
template <typename T, int BK>
__device__ __forceinline__ void load_w(T* dst, int ldb, const T* w, long long sk, long long sn,
                                       int K, int N, int k0, int n0, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  if (vec) {  // unit n stride, 16-byte aligned rows
    constexpr int CPR = BN / VEC;
    for (int i = threadIdx.x; i < BK * CPR; i += NT) {
      const int r = i / CPR, c = (i - r * CPR) * VEC;
      const int k = k0 + r, n = n0 + c;
      T* d = dst + r * ldb + c;
      const T* s = w + (long long)k * sk + n;
      if (k < K && n + VEC <= N) {
        cp_async16(d, s);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) d[v] = (k < K && n + v < N) ? s[v] : from_f<T>(0.f);
      }
    }
  } else {  // any strides: neighbouring threads walk k (unit k stride coalesces)
    for (int i = threadIdx.x; i < BK * BN; i += NT) {
      const int c = i / BK, r = i - c * BK;
      const int k = k0 + r, n = n0 + c;
      dst[r * ldb + c] = (k < K && n < N) ? w[(long long)k * sk + (long long)n * sn]
                                          : from_f<T>(0.f);
    }
  }
}

// The same tile from a w with a unit k stride (a transposed view), into
// shared [BN][ldk] (k contiguous, read by plain ldmatrix); k >= K and
// n >= N are zero.
template <typename T, int BK>
__device__ __forceinline__ void load_w_kmajor(T* dst, int ldk, const T* w, long long sn, int K,
                                              int N, int k0, int n0, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = BK / VEC;
  for (int i = threadIdx.x; i < BN * CPR; i += NT) {
    const int r = i / CPR, c = (i - r * CPR) * VEC;
    const int n = n0 + r, k = k0 + c;
    T* d = dst + r * ldk + c;
    const T* s = w + (long long)n * sn + k;
    if (vec && n < N && k + VEC <= K) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) d[v] = (n < N && k + v < K) ? s[v] : from_f<T>(0.f);
    }
  }
}

// Shared elements of one stage's weight tile: [BK][BN + PAD], or
// [BN][BK + PAD] when WT (w with a unit k stride).
template <typename T, bool WT>
__host__ __device__ constexpr int w_tile_elems() {
  return WT ? BN * (Slice<T>::BK + 16 / (int)sizeof(T))
            : Slice<T>::BK * (BN + 16 / (int)sizeof(T));
}

template <typename T, int BM, bool SWIGLU, bool WT>
__global__ void __launch_bounds__(NT) grouped_kernel(GroupedArgs a) {
  constexpr int BK = Slice<T>::BK;
  constexpr int PAD = 16 / sizeof(T);
  constexpr int LDA = BK + PAD;
  constexpr int LDB = WT ? BK + PAD : BN + PAD;
  constexpr int WTILE = w_tile_elems<T, WT>();
  constexpr int NWT = SWIGLU ? 2 : 1;  // weight tiles per stage
  constexpr int WM = BM / 16;          // warps along m
  constexpr int WN = NW / WM;          // warps along n
  constexpr int N8 = BN / WN / 8;      // n8 tiles per warp
  static_assert(WM * WN == NW && N8 % 2 == 0, "tile shape");
  static_assert(!(SWIGLU && WT), "swiglu_up takes [k][n] weights");

  __shared__ int info[4];
  if (threadIdx.x == 0) {
    int mt = 0, lo = 0, hi = 0;
    info[0] = resolve_tile<BM>(a.group_sizes, a.E, a.M, blockIdx.x, mt, lo, hi);
    info[1] = mt;
    info[2] = lo;
    info[3] = hi;
  }
  __syncthreads();
  const int g = info[0], mt = info[1], lo = info[2], hi = info[3];
  if (g == -2) return;  // past the live visits
  const int n0 = blockIdx.y * BN;
  T* out = reinterpret_cast<T*>(a.out);

  if (g == -1) {  // rows past the groups: exactly zero
    for (int i = threadIdx.x; i < (hi - lo) * BN; i += NT) {
      const int r = lo + i / BN, n = n0 + i % BN;
      if (n < a.N) out[(long long)r * a.N + n] = from_f<T>(0.f);
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // [STAGES][BM][LDA]
  T* Bs = As + STAGES * BM * LDA;           // [STAGES][NWT][WTILE]

  const T* x = reinterpret_cast<const T*>(a.x);
  const T* w[2] = {reinterpret_cast<const T*>(a.w1) + (long long)g * a.sw_e,
                   SWIGLU ? reinterpret_cast<const T*>(a.w3) + (long long)g * a.sw_e : nullptr};
  const int row0 = mt * BM;
  const int nk = (a.K + BK - 1) / BK;
  const bool vx = a.vec_x != 0, vw = a.vec_w != 0;

  auto load_stage = [&](int slot, int kt) {
    const int k0 = kt * BK;
    load_x<T, BM, BK>(As + slot * BM * LDA, LDA, x, a.M, a.K, row0, k0, vx);
#pragma unroll
    for (int j = 0; j < NWT; ++j) {
      T* dst = Bs + (slot * NWT + j) * WTILE;
      if (WT)
        load_w_kmajor<T, BK>(dst, LDB, w[j], a.sw_n, a.K, a.N, k0, n0, vw);
      else
        load_w<T, BK>(dst, LDB, w[j], a.sw_k, a.sw_n, a.K, a.N, k0, n0, vw);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % WM, wn = warp / WM;
  const int b_off = wn * (BN / WN) * (WT ? LDB : 1);  // this warp's first column
  float acc[NWT][N8][4];
#pragma unroll
  for (int j = 0; j < NWT; ++j)
#pragma unroll
    for (int n = 0; n < N8; ++n) acc[j][n][0] = acc[j][n][1] = acc[j][n][2] = acc[j][n][3] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed; slot (kt - 1) % STAGES is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) load_stage(nxt % STAGES, nxt);
    cp_async_commit();
    const int slot = kt % STAGES;
    const T* at = As + slot * BM * LDA + wm * 16 * LDA;
#pragma unroll
    for (int j = 0; j < NWT; ++j)
      mma_tile<N8, BK, false, WT>(acc[j], at, LDA, Bs + (slot * NWT + j) * WTILE + b_off, LDB);
  }
  cp_async_wait<0>();

  // epilogue: only this segment's rows; fp32 silu*mul, one rounding
  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < N8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + wm * 16 + gq + (e >> 1) * 8;
      const int col = n0 + wn * (BN / WN) + n * 8 + 2 * t4 + (e & 1);
      if (row < lo || row >= hi || col >= a.N) continue;
      float v = acc[0][n][e];
      if (SWIGLU) v = v / (1.f + expf(-v)) * acc[NWT - 1][n][e];
      out[(long long)row * a.N + col] = from_f<T>(v);
    }
  }
}

// The weight gradient dw[e, k, n] = sum_{s in group e} x[s, k] dy[s, n]
// (_tgmm, grouped_matmul.py:246-301). The TPU kernel walks the logical
// row tiles in order and carries one fp32 accumulator per group through
// the sequential grid axis; here each CTA owns one (expert, 64 k x 64 n)
// output tile and loops over that expert's rows itself, BS rows a stage
// (a 4-stage cp.async ring of x and dy slices), so there is no host sync,
// no atomics and no second pass, and every output element is written once
// (deterministic, as K2 chose). Stages start at the group's first row;
// rows of the last stage past the group are zero in shared memory (the
// TPU kernel's jnp.where(mask, x, 0)); an empty group runs no stage and
// writes zeros. A = x^T: the x slice is staged as it lies, [s][k], and
// its fragments come by ldmatrix.trans; B = the dy slice, [s][n], as the
// forward kernel's weight tile. Grid (N/64, K/64, E): at the GPT2-MoE
// 350M shapes 4096 CTAs.
//
// Bound: operations. At (rows, K, N) = (49152, 1024, 4096) the work is
// 412 GFLOP (0.42 ms at the bf16 peak) against 0.54 GB of x, dy and dw
// (0.16 ms). The 64 x 64 output tile re-reads each x slice once per n
// tile and each dy slice once per k tile (most of it from L2). bf16
// operands TMA can address take grouped_tgmm_sm90_kernel below; this
// kernel serves fp32 and the rest of bf16 (x of width 1: the expert-bias
// row sums).
template <typename T>
__global__ void __launch_bounds__(NT) grouped_tgmm_kernel(TgmmArgs a) {
  constexpr int BS = Slice<T>::BK;  // routed rows per stage
  constexpr int BKO = 64;           // output rows (k) per CTA, 16 per warp
  constexpr int PAD = 16 / sizeof(T);
  constexpr int LDA = BKO + PAD;
  constexpr int LDB = BN + PAD;
  constexpr int N8 = BN / 8;
  static_assert(BKO == NW * 16, "one m16 tile per warp");

  const int e = blockIdx.z, k0 = blockIdx.y * BKO, n0 = blockIdx.x * BN;
  int lo = 0;  // group e's rows [lo, hi), clipped to M as resolve_tile does
  for (int i = 0; i < e; ++i) lo = min(lo + max(a.group_sizes[i], 0), a.M);
  const int hi = min(lo + max(a.group_sizes[e], 0), a.M);
  const int ns = (hi - lo + BS - 1) / BS;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // [STAGES][BS][LDA]: x, k contiguous
  T* Bs = As + STAGES * BS * LDA;           // [STAGES][BS][LDB]: dy, n contiguous
  const T* x = reinterpret_cast<const T*>(a.x);
  const T* dy = reinterpret_cast<const T*>(a.dy);
  const bool vx = a.vec_x != 0, vdy = a.vec_dy != 0;

  auto load_stage = [&](int slot, int st) {
    const int r0 = lo + st * BS;  // rows >= hi are zero
    load_x<T, BS, BKO>(As + slot * BS * LDA, LDA, x, hi, a.K, r0, k0, vx);
    load_x<T, BS, BN>(Bs + slot * BS * LDB, LDB, dy, hi, a.N, r0, n0, vdy);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[N8][4];
#pragma unroll
  for (int n = 0; n < N8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ns) load_stage(s, s);
    cp_async_commit();
  }
  for (int st = 0; st < ns; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice st landed; slot (st - 1) % STAGES is free
    const int nxt = st + STAGES - 1;
    if (nxt < ns) load_stage(nxt % STAGES, nxt);
    cp_async_commit();
    const int slot = st % STAGES;
    mma_tile<N8, BS, true, false>(acc, As + slot * BS * LDA + warp * 16, LDA,
                                  Bs + slot * BS * LDB, LDB);
  }
  cp_async_wait<0>();

  T* out = reinterpret_cast<T*>(a.out) + (long long)e * a.K * a.N;
  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < N8; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = k0 + warp * 16 + gq + (i >> 1) * 8;
      const int col = n0 + n * 8 + 2 * t4 + (i & 1);
      if (row < a.K && col < a.N) out[(long long)row * a.N + col] = from_f<T>(acc[n][i]);
    }
  }
}

// The weight gradient on the Hopper mainloop (bf16 operands TMA can
// address): O[z = e, i = k, j = n] = sum over c in expert e's rows of
// A[i, c] B[c, j] with A = x^T and B = dy, both MN-major (x's k and dy's n
// contiguous): the operand pair of K6's _dw. The tile walk runs over (e, k
// tile of 128, n tile of 256): 512 tiles at both GPT2-MoE 350M shapes,
// expert-major, so the CTAs in flight read one expert's rows together and
// each x / dy slice comes from device memory about once a wave. Each
// tile's row range [lo_e, hi_e) is clipped to M as grouped_tgmm_kernel
// clips it; x's rows at or past hi_e in the last 64-row slice (the next
// expert's, or the tail's) are zeroed in shared memory (the TPU kernel's
// jnp.where(mask, x, 0)); an empty expert runs no slice and stores zeros.
// The epilogue rounds the fp32 accumulator to bf16 once (store_tile).
// Bound: operations, 412 GFLOP at (rows, K, N) = (49152, 1024, 4096)
// against 0.54 GB moved (0.42 ms vs 0.16 ms).
struct ExpertRows {
  const int* group_sizes;  // (E,) int32, device memory
  int M;
  static constexpr bool MASK_A = true;
  __device__ __forceinline__ void operator()(const sm90::Problem&, int e, int& lo, int& hi) const {
    int start = 0;
    for (int i = 0; i < e; ++i) start = min(start + max(group_sizes[i], 0), M);
    lo = start;
    hi = min(start + max(group_sizes[e], 0), M);
  }
};

struct TgmmEpilogue {
  bf16* out;  // (E, K, N) contiguous
  int K, N;
  int vec;    // 16-byte stores allowed

  __device__ __forceinline__ void operator()(float (&acc)[sm90::BN / 2], int e, int i0, int j0,
                                             bf16* stage, int tid, int bar) const {
    bf16* o = out + ((long long)e * K + i0) * N + j0;
    sm90::store_tile<false>(acc, stage, o, N, K - i0, N - j0, vec != 0, bar, tid);
  }
};

__global__ void __launch_bounds__(sm90::THREADS, 1)
    grouped_tgmm_sm90_kernel(const __grid_constant__ CUtensorMap mx,
                             const __grid_constant__ CUtensorMap mdy, sm90::Problem p,
                             TgmmEpilogue epi, ExpertRows rows) {
  sm90::gemm<1, 1>(mx, mdy, p, epi, rows);
}

cudaError_t launch_tgmm_sm90(const TgmmArgs& a, cudaStream_t s) {
  sm90::Problem p{};
  p.Z = a.E;
  p.Q = 1;
  p.I = a.K;
  p.J = a.N;
  p.C = a.M;
  CUtensorMap mx, mdy;
  // strides in elements: A (z, q, i, c) = (0, 0, 1, K), B (z, q, c, j) = (0, 0, N, 1)
  const long long sx[4] = {0, 0, 1, a.K}, sdy[4] = {0, 0, a.N, 1};
  cudaError_t e = sm90::make_maps(&mx, &mdy, &p, a.x, sx, 1, a.dy, sdy, 1);
  if (e != cudaSuccess) return e;
  const int grid = sm90::plan(&p, 8);
  if (grid <= 0) return cudaErrorInvalidValue;
  const TgmmEpilogue epi{(bf16*)a.out, a.K, a.N,
                         (uintptr_t)a.out % 16 == 0 && a.N % 8 == 0};
  auto kernel = grouped_tgmm_sm90_kernel;
  e = sm90::allow_sm90_smem(kernel);
  if (e != cudaSuccess) return e;
  kernel<<<grid, sm90::THREADS, sm90::SMEM_BYTES, s>>>(mx, mdy, p, epi,
                                                      ExpertRows{a.group_sizes, a.M});
  return cudaGetLastError();
}

// The grouped product on the Hopper mainloop (bf16 operands TMA can
// address): O[z = segment, i = row, j = n] = sum_k x[i, k] w[e, k, n] with
// A = x K-major (box 64 k x 128 rows) and B = w[e]: MN-major (TB = 1, the
// forward's unit n stride) or K-major (TB = 0, the dx product's transposed
// view with a unit k stride), the expert a dim of B's map. The walk runs
// over (row visit, n tile of 256) in bands of 8 visits; visit v resolves
// on the device, from group_sizes, to a segment of a 128-row physical tile
// exactly as grouped_kernel's logical tiles do (resolve_tile): the
// non-empty experts in order, then the tail [sum, M); a boundary tile is
// visited once per segment, so at most ceil(M / 128) + E visits. A visit
// of expert e runs the whole k loop on its physical tile's rows; the
// epilogue stores only its segment's rows (store_tile's lower bound), so
// every output row is written by one visit, with no atomics, and calls
// repeat bitwise. A tail visit loads nothing and stores zeros; a visit past
// the live count (a dead tile) loads and stores nothing.
// Bound: operations at the GPT2-MoE 350M training shapes: 412 GFLOP at
// (rows, K, N) = (49152, 1024, 4096) against 0.54 GB moved (0.42 ms vs
// 0.16 ms); a row tile shared by two experts costs its k loop twice.
struct GmmWalk {
  const int* group_sizes;  // (E,) int32, device memory
  int M, E;
  __device__ __forceinline__ bool operator()(const sm90::Problem& p, int t, int& z, int& ti,
                                             int& tj) const {
    int band_z, v, lo, hi;
    sm90::tile_coords(p, t, band_z, v, tj);
    const int g = resolve_tile<sm90::BM>(group_sizes, E, M, v, ti, lo, hi);
    z = g < 0 ? E : g;  // the tail is segment E
    return g != -2;
  }
};

struct GmmRange {  // the whole k range for an expert's visit, none for the tail
  int E;
  static constexpr bool MASK_A = false;
  __device__ __forceinline__ void operator()(const sm90::Problem& p, int z, int& lo,
                                             int& hi) const {
    lo = 0;
    hi = z < E ? p.C : 0;
  }
};

// The epilogue: a consumer's 64 rows of a visit, rounded to bf16 once. Where
// the segment holds all 64 rows (every visit but the boundary ones) they
// go out by TMA store, 64 columns a pass, through the two halves of the
// consumer's staging tile in turn, in the box's swizzled layout. The
// consumer waits only until a store has read its half, two passes later
// (its thread 0 waits while the others write the next pass), so the rows
// drain to memory while the next passes and the next tile's products run.
// A boundary visit stores its segment's rows alone through store_tile.
struct GmmEpilogue {
  CUtensorMap map;         // out as (N, M), box 64 columns x 64 rows (when tma)
  bf16* out;               // (M, N) contiguous
  const int* group_sizes;  // (E,) int32, device memory
  int M, N, E;
  int vec;                 // 16-byte stores allowed
  int tma;                 // ``map`` is encoded

  __device__ __forceinline__ void operator()(float (&acc)[sm90::BN / 2], int z, int i0, int j0,
                                             bf16* stage, int tid, int bar) const {
    int start = 0;  // segment z's rows [start, end), clipped to M as resolve_tile clips them
    for (int i = 0; i < z; ++i) start = min(start + max(group_sizes[i], 0), M);
    const int end = z < E ? min(start + max(group_sizes[z], 0), M) : M;
    const int lo = max(start, i0), hi = min(end, i0 + 64);
    if (hi <= lo) return;  // uniform across the warpgroup
    if (tid == 0) sm90::tma_store_wait_read();  // the last tile's stores have read the staging
    if (!tma || lo != i0 || hi != i0 + 64) {
      sm90::store_tile<false>(acc, stage, out + (long long)i0 * N + j0, N, hi - i0, N - j0,
                              vec != 0, bar, tid, lo - i0);
      return;
    }
    sm90::named_sync(bar);
#pragma unroll
    for (int pass = 0; pass < sm90::BN / sm90::EPI_COLS; ++pass) {
      if (pass * sm90::EPI_COLS >= N - j0) break;  // uniform across the warpgroup
      unsigned char* st = reinterpret_cast<unsigned char*>(stage) + (pass & 1) * 64 * 128;
#pragma unroll
      for (int b = 0; b < sm90::EPI_COLS / 8; ++b) {
        const int k = (pass * sm90::EPI_COLS / 8 + b) * 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // (r, c) at r * 128 bytes, 16-byte chunk c / 8 ^ r % 8
          const int r = sm90::frag_row(tid, 2 * h), c = sm90::frag_col(tid, b, 0);
          const __nv_bfloat162 v = __floats2bfloat162_rn(acc[k + 2 * h], acc[k + 2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(st + r * 128 + (((c >> 3) ^ (r & 7)) << 4) +
                                              (c & 7) * 2) = v;
        }
      }
      sm90::fence_proxy_async();
      // the last pass's store has read the other half, which the next pass
      // writes after this barrier
      if (tid == 0) sm90::tma_store_wait_read();
      sm90::named_sync(bar);
      if (tid == 0) {
        sm90::tma_store_2d(&map, st, j0 + pass * sm90::EPI_COLS, i0);
        sm90::tma_store_commit();
      }
    }
  }

  __device__ __forceinline__ void finish(int tid) const {
    if (tid == 0) sm90::tma_store_wait_all();
  }
};

template <int TB>
__global__ void __launch_bounds__(sm90::THREADS, 1)
    grouped_gmm_sm90_kernel(const __grid_constant__ CUtensorMap mx,
                            const __grid_constant__ CUtensorMap mw, sm90::Problem p,
                            const __grid_constant__ GmmEpilogue epi, GmmRange range,
                            GmmWalk walk) {
  sm90::gemm<0, TB>(mx, mw, p, epi, range, walk);
}

cudaError_t launch_gmm_sm90(const GroupedArgs& a, cudaStream_t s) {
  sm90::Problem p{};
  p.Z = a.E;
  p.Q = 1;
  p.I = a.M;
  p.J = a.N;
  p.C = a.K;
  const int tb = a.w_kmajor ? 0 : 1;
  CUtensorMap mx, mw;
  // strides in elements: A (z, q, i, c) = (0, 0, K, 1), B (z, q, c, j) = w's (e, -, k, n)
  const long long sx[4] = {0, 0, a.K, 1}, sw[4] = {a.sw_e, 0, a.sw_k, a.sw_n};
  cudaError_t e = sm90::make_maps(&mx, &mw, &p, a.x, sx, 0, a.w1, sw, tb);
  if (e != cudaSuccess) return e;
  p.tiles_i = (a.M + sm90::BM - 1) / sm90::BM + a.E;  // row visits, live or not
  p.tiles_j = (a.N + sm90::BN - 1) / sm90::BN;
  p.group_m = p.tiles_i < 8 ? p.tiles_i : 8;
  const long long tiles = (long long)p.tiles_i * p.tiles_j;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  p.num_tiles = (int)tiles;
  const int grid = sm90::persistent_grid(p.num_tiles);
  GmmEpilogue epi{};
  epi.out = (bf16*)a.out;
  epi.group_sizes = a.group_sizes;
  epi.M = a.M;
  epi.N = a.N;
  epi.E = a.E;
  epi.vec = (uintptr_t)a.out % 16 == 0 && a.N % 8 == 0;
  if (epi.vec) {  // the output as a 2-d map (N, M), box 64 x 64: the TMA store
    int rank, dim2;
    e = sm90::make_operand_map(&epi.map, a.out, a.N, a.M, a.N, 1, 0, 1, 0, sm90::EPI_COLS,
                               &rank, &dim2);
    if (e != cudaSuccess) return e;
    epi.tma = 1;
  }
  const GmmRange range{a.E};
  const GmmWalk walk{a.group_sizes, a.M, a.E};
  if (tb) {
    auto kernel = grouped_gmm_sm90_kernel<1>;
    e = sm90::allow_sm90_smem(kernel);
    if (e != cudaSuccess) return e;
    kernel<<<grid, sm90::THREADS, sm90::SMEM_BYTES, s>>>(mx, mw, p, epi, range, walk);
  } else {
    auto kernel = grouped_gmm_sm90_kernel<0>;
    e = sm90::allow_sm90_smem(kernel);
    if (e != cudaSuccess) return e;
    kernel<<<grid, sm90::THREADS, sm90::SMEM_BYTES, s>>>(mx, mw, p, epi, range, walk);
  }
  return cudaGetLastError();
}

// K9's Hopper design (bf16 x and codes TMA can address): K7's CTA
// (wq_sm90.cuh wq_cta: the widened codes as wgmma's register operand, x
// from swizzled shared memory) on a grouped walk. CTA (v, f) takes run v
// of the features from f * FT (FT = 128, or 256 for the wide down
// projection). Runs resolve on the device from the E sizes
// (resolve_run): each non-empty group's rows, then the tail, cut into
// runs of NR rows from the segment's own first row, so x's box starts
// there and an evenly routed expert's rows are one run (at most
// ceil(M / NR) + E + 1 runs). An expert's run loads its NR x rows from
// its first and that expert's code boxes (the code maps' third dim) over
// every k slice, computes all NR rows and stores only its own, with its
// own expert's scales; a tail run stores zeros; a dead run exits. The run
// index runs fastest, so the runs that share an expert's code tile run
// side by side and the second read comes from L2. SWIGLU: w1's and w3's
// code boxes share each x slice, two accumulators, s1 and s3 on the fp32
// sums, then silu * mul in fp32 and one rounding. WIDE (the down
// projection above decode): two 128-feature boxes of the one weight share
// each x slice, halving the x slices read a feature.
template <int NR>
__device__ __forceinline__ int resolve_run(const int* group_sizes, int E, int M, int idx, int& lo,
                                           int& hi) {
  int start = 0;
  for (int e = 0; e <= E; ++e) {
    int s, en;
    if (e < E) {
      s = min(start, M);
      en = min(start + max(group_sizes[e], 0), M);
      start = en;
    } else {
      s = min(start, M);
      en = M;
    }
    if (en <= s) continue;
    const int n = (en - s + NR - 1) / NR;
    if (idx < n) {
      lo = s + idx * NR;
      hi = min(en, lo + NR);
      return e < E ? e : -1;
    }
    idx -= n;
  }
  return -2;
}

template <bool SWIGLU>
struct RunEpi {
  bf16* out;  // (M, N) contiguous
  const float* s1;
  const float* s3;
  int N, f0, lo, hi;
  // acc[j][4 b + e]: box j's feature f + (e >> 1) at row lo + 8 b + 2 t + (e & 1)
  template <int NQ, int NA>
  __device__ __forceinline__ void operator()(const float (&acc)[NQ][NA], int f, int t4) const {
#pragma unroll
    for (int j = 0; j < (SWIGLU ? 1 : NQ); ++j) {
      const int F = f0 + j * wq90::FT + f;
      if (F >= N) continue;
      const float a0 = s1[F], a1 = s1[F + 1];
      const float c0 = SWIGLU ? s3[F] : 0.f, c1 = SWIGLU ? s3[F + 1] : 0.f;
#pragma unroll
      for (int b = 0; b < NA / 4; ++b)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = lo + 8 * b + 2 * t4 + e;
          if (r >= hi) continue;
          float v0 = acc[j][4 * b + e] * a0, v1 = acc[j][4 * b + 2 + e] * a1;
          if constexpr (SWIGLU) {
            v0 = v0 / (1.f + expf(-v0)) * (acc[NQ - 1][4 * b + e] * c0);
            v1 = v1 / (1.f + expf(-v1)) * (acc[NQ - 1][4 * b + 2 + e] * c1);
          }
          *reinterpret_cast<uint32_t*>(out + (long long)r * N + F) = sm90::pack_bf16(v0, v1);
        }
    }
  }
};

// features a CTA of the K9 design: two boxes of the one weight (WIDE) or one
template <bool SWIGLU, bool WIDE>
__host__ __device__ constexpr int wq_run_features() {
  return WIDE && !SWIGLU ? 2 * wq90::FT : wq90::FT;
}

template <int BITS, int NR, bool SWIGLU, bool WIDE>
__global__ void __launch_bounds__(wq90::THREADS, 1)
    wq_grouped_sm90_kernel(const __grid_constant__ CUtensorMap mx,
                           const __grid_constant__ CUtensorMap mq1,
                           const __grid_constant__ CUtensorMap mq3, WqArgs a, int q_rank) {
  constexpr int FT = wq_run_features<SWIGLU, WIDE>();
  __shared__ int info[3];
  if (threadIdx.x == 0) {
    int lo = 0, hi = 0;
    info[0] = resolve_run<NR>(a.group_sizes, a.E, a.M, blockIdx.x, lo, hi);
    info[1] = lo;
    info[2] = hi;
  }
  __syncthreads();
  const int g = info[0], lo = info[1], hi = info[2];
  if (g == -2) return;  // past the live runs
  const int f0 = blockIdx.y * FT;
  bf16* out = reinterpret_cast<bf16*>(a.out);
  if (g == -1) {  // rows past the groups: exactly zero
    for (int i = threadIdx.x; i < (hi - lo) * FT; i += wq90::THREADS) {
      const int r = lo + i / FT, n = f0 + i % FT;
      if (n < a.N) out[(long long)r * a.N + n] = __float2bfloat16(0.f);
    }
    return;
  }
  const RunEpi<SWIGLU> epi{out, a.s1 + (long long)g * a.N,
                           SWIGLU ? a.s3 + (long long)g * a.N : nullptr, a.N, f0, lo, hi};
  wq90::wq_cta<BITS, NR, SWIGLU || WIDE ? 2 : 1>(mx, mq1, mq3, q_rank, f0,
                                                 SWIGLU ? f0 : f0 + wq90::FT, lo, g, 0,
                                                 (a.K + wq90::KS - 1) / wq90::KS, epi);
}

template <int BITS, int NR, bool SWIGLU, bool WIDE>
cudaError_t launch_wq_grouped(const WqArgs& a, cudaStream_t s) {
  constexpr int KR_DIV = BITS == 8 ? 1 : 2;
  constexpr int FT = wq_run_features<SWIGLU, WIDE>();
  CUtensorMap mx, mq1, mq3;
  int rank, dim2;
  cudaError_t e = sm90::make_operand_map(&mx, a.x, a.K, a.M, a.K, 1, 0, 1, 0, NR, &rank, &dim2);
  if (e == cudaSuccess)
    e = wq90::make_code_map(&mq1, a.q1, a.K / KR_DIV, a.N, wq90::q_rows<BITS>(), a.E);
  if (e == cudaSuccess && SWIGLU)
    e = wq90::make_code_map(&mq3, a.q3, a.K / KR_DIV, a.N, wq90::q_rows<BITS>(), a.E);
  if (e != cudaSuccess) return e;
  if (!SWIGLU) mq3 = mq1;
  auto kernel = wq_grouped_sm90_kernel<BITS, NR, SWIGLU, WIDE>;
  constexpr int smem = wq90::smem_bytes<BITS, NR, SWIGLU || WIDE ? 2 : 1>();
  static bool smem_set = false;  // once: later calls may be captured in a graph
  if (!smem_set) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const long long runs = (a.M + NR - 1) / NR + a.E + 1;
  if (runs > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)runs, (a.N + FT - 1) / FT);
  kernel<<<grid, wq90::THREADS, smem, s>>>(mx, mq1, mq3, a, a.E > 1 ? 3 : 2);
  return cudaGetLastError();
}

// the row tile; the down projection is wide at row tiles above decode's
template <int BITS, bool SWIGLU>
cudaError_t wq_grouped_by_tile(const WqArgs& a, int row_tile, cudaStream_t s) {
  switch (row_tile) {
    case 16: return launch_wq_grouped<BITS, 16, SWIGLU, false>(a, s);
    case 80: return launch_wq_grouped<BITS, 80, SWIGLU, !SWIGLU>(a, s);
    case 128: return launch_wq_grouped<BITS, 128, SWIGLU, !SWIGLU>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// K9's launchers: design 0 = fp32 and 1 = mma_sync (wq_kernel<float | bf16>
// at block_m = ``tile``, 16 or 64), 2 = sm90 (wq_grouped_sm90_kernel at the
// row tile ``tile``, 16, 64 or 128: bf16 x with K a multiple of 8, codes
// with N a multiple of 16, 16-byte aligned x, codes, scales and out).
template <bool SWIGLU>
int grouped_wq(const WqArgs* a, int design, int bits, int tile, void* stream) {
  if (a == nullptr || a->group_sizes == nullptr) return cudaErrorInvalidValue;
  if (design == 0 || design == 1) return wq_dispatch<SWIGLU>(a, design, bits, tile, stream);
  if (design != 2 || a->M <= 0 || a->K <= 0 || a->N <= 0 || a->E <= 0 || a->K % 8 != 0 ||
      a->N % 16 != 0 || (bits != 4 && bits != 8) || (a->N + wq90::FT - 1) / wq90::FT > 65535 ||
      (uintptr_t)a->x % 16 || (uintptr_t)a->q1 % 16 || (uintptr_t)a->s1 % 16 ||
      (uintptr_t)a->out % 16 ||
      (SWIGLU && (a->q3 == nullptr || a->s3 == nullptr || (uintptr_t)a->q3 % 16 ||
                  (uintptr_t)a->s3 % 16)))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bits == 8 ? wq_grouped_by_tile<8, SWIGLU>(*a, tile, s)
                   : wq_grouped_by_tile<4, SWIGLU>(*a, tile, s);
}

// K8's bf16 Hopper design of grouped_swiglu_up (x, w1, w3 bf16 that TMA
// can address, w with a unit n stride): h = silu(x w1[g]) * (x w3[g]) as
// the transposed product h^T = w^T x^T, K9's walk (resolve_run: runs of NR
// rows from each group segment's own first row, so x's box starts there
// and an evenly routed expert is one run) with bf16 weights in place of
// codes. CTA (v, f) takes run v at the features from f * SW_FT (SW_FT =
// 128):
//   warpgroup 0, the producer: one thread TMA-loads each 64-deep k slice
//     into an mbarrier ring: x's box (64 k x NR rows from the run's first,
//     K-major, 128-byte swizzle) and two 64-feature x 64-k boxes of each of
//     w1 and w3 (the expert the map's third coordinate; f is w's unit
//     stride, so a box holds a 128-byte line of 64 features per k: the
//     MN-major layout). No copy of a weight is written anywhere.
//   warpgroups 1 and 2, the consumers: each owns 64 features, wgmma's M,
//     the run's rows are N (16, 80 or 128): per 16-deep slice one wgmma
//     m64nNRk16 from shared memory with A = its w1 box transposed (the
//     transpose bit) and B = x, and one with its w3 box, into two fp32
//     accumulators; one wgmma group stays in flight and the wait that
//     retires the previous slice frees its slot (one arrive per consumer
//     warp).
//   Epilogue: silu(g) * u in fp32 and one rounding; a thread holds features
//     (F, F + 8) at rows (s, s + 1), so a shuffle with the neighbouring
//     feature's lane pairs them up and each thread stores one bf16 pair a
//     (row, feature pair), only the run's own rows [lo, hi). A tail run
//     stores zeros; a run past the live ones exits. Every output element
//     has one writer and there are no atomics: calls repeat bitwise.
// Bound: bytes, each touched expert's w1 and w3 streamed once (1.88 GB for
// Mixtral-8x7B's 8 experts, 0.56 ms): the ring is as deep as 227 KB allows
// (6 stages of 34 KB at NR = 16, 5 of 42 KB at 80, 4 of 48 KB at 128). The
// run index runs fastest in the grid, so an expert's second run reads its
// weight tile from L2.
constexpr int SW_FT = 128;               // features a CTA (two consumers of 64)
constexpr int SW_KS = 64;                // k a slice: one 128-byte swizzle line of x
constexpr int SW_WBOX = 64 * SW_KS * 2;  // one 64-feature x 64-k weight box: 8 KB
constexpr int SW_WBYTES = 4 * SW_WBOX;   // w1's and w3's two boxes each a stage

template <int NR>
__host__ __device__ constexpr int sw_stages() {
  constexpr int fit = (232448 - 1024 - 512) / (NR * SW_KS * 2 + SW_WBYTES);
  return fit < 8 ? fit : 8;
}
template <int NR>
__host__ __device__ constexpr int sw_smem_bytes() {
  return 1024 + sw_stages<NR>() * (NR * SW_KS * 2 + SW_WBYTES + 16);
}

template <int NR>
__global__ void __launch_bounds__(384, 1)
    grouped_swiglu_up_sm90_kernel(const __grid_constant__ CUtensorMap mx,
                                  const __grid_constant__ CUtensorMap mw1,
                                  const __grid_constant__ CUtensorMap mw3, GroupedArgs a,
                                  int w_rank) {
  constexpr int ST = sw_stages<NR>();
  constexpr int XB = NR * SW_KS * 2;
  __shared__ int info[3];
  if (threadIdx.x == 0) {
    int lo = 0, hi = 0;
    info[0] = resolve_run<NR>(a.group_sizes, a.E, a.M, blockIdx.x, lo, hi);
    info[1] = lo;
    info[2] = hi;
  }
  __syncthreads();
  const int g = info[0], lo = info[1], hi = info[2];
  if (g == -2) return;  // past the live runs
  const int f0 = blockIdx.y * SW_FT;
  bf16* out = reinterpret_cast<bf16*>(a.out);
  if (g == -1) {  // rows past the groups: exactly zero
    for (int i = threadIdx.x; i < (hi - lo) * SW_FT; i += 384) {
      const int r = lo + i / SW_FT, n = f0 + i % SW_FT;
      if (n < a.N) out[(long long)r * a.N + n] = __float2bfloat16(0.f);
    }
    return;
  }

  unsigned char* base =
      sm90::sm90_smem + ((1024 - (sm90::smem_u32(sm90::sm90_smem) & 1023)) & 1023);
  unsigned char* xs = base;            // [ST][XB]
  unsigned char* ws = base + ST * XB;  // [ST][w1 lo, w1 hi, w3 lo, w3 hi][SW_WBOX]
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + ST * SW_WBYTES);
  uint64_t* empty = full + ST;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int steps = (a.K + SW_KS - 1) / SW_KS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int s = 0; s < steps; ++s) {
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        sm90::mbar_expect_tx(&full[stage], XB + SW_WBYTES);
        const int k0 = s * SW_KS;
        unsigned char* w = ws + stage * SW_WBYTES;
        sm90::tma_load(xs + stage * XB, &mx, &full[stage], 2, k0, lo, 0, 0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sm90::tma_load(w + h * SW_WBOX, &mw1, &full[stage], w_rank, f0 + 64 * h, k0, g, 0);
          sm90::tma_load(w + (2 + h) * SW_WBOX, &mw3, &full[stage], w_rank, f0 + 64 * h, k0, g,
                         0);
        }
        if (++stage == ST) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1, warp = tid >> 5, lane = tid & 31;
    float g1[NR / 2], g3[NR / 2];
#pragma unroll
    for (int i = 0; i < NR / 2; ++i) g1[i] = g3[i] = 0.f;
    int stage = 0, prev = -1;
    uint32_t phase = 0;
    for (int s = 0; s < steps; ++s) {
      sm90::mbar_wait(&full[stage], phase);
      const unsigned char* xb = xs + stage * XB;
      const unsigned char* w1 = ws + stage * SW_WBYTES + cw * SW_WBOX;
      const unsigned char* w3 = w1 + 2 * SW_WBOX;
      sm90::fence_regs(g1);
      sm90::fence_regs(g3);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SW_KS / 16; ++kk) {
        // A: 16 k lines (2048 bytes) a slice of the MN-major box; B: 32
        // bytes a slice along x's swizzled k rows
        const uint64_t db = sm90::smem_desc(xb + kk * 32, 16, 1024);
        sm90::wgmma_tn<NR>(g1, sm90::smem_desc(w1 + kk * 2048, SW_WBOX, 1024), db);
        sm90::wgmma_tn<NR>(g3, sm90::smem_desc(w3 + kk * 2048, SW_WBOX, 1024), db);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the previous slice's products are done
      sm90::fence_regs(g1);
      sm90::fence_regs(g3);
      if (prev >= 0 && lane == 0) sm90::mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == ST) {
        stage = 0;
        phase ^= 1;
      }
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(g1);
    sm90::fence_regs(g3);
    // (no arrive for the last slot: nothing loads after it)

    // g1[4 b + e]: feature F + 8 (e >> 1) at row lo + 8 b + 2 t + (e & 1),
    // F = f0 + 64 cw + 16 warp + lane / 4. The lane of feature F ^ 1 (lane
    // ^ 4) swaps one value with this one, so a lane of even F stores row s
    // at (F, F + 1) and one of odd F row s + 1 at (F - 1, F).
    const int t4 = lane & 3, odd = (lane >> 2) & 1;
    const int F = f0 + 64 * cw + 16 * warp + (lane >> 2) - odd;
#pragma unroll
    for (int b = 0; b < NR / 8; ++b)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i0 = 4 * b + 2 * hf;
        const float v0 = g1[i0] / (1.f + expf(-g1[i0])) * g3[i0];              // row s
        const float v1 = g1[i0 + 1] / (1.f + expf(-g1[i0 + 1])) * g3[i0 + 1];  // row s + 1
        const float got = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
        const int r = lo + 8 * b + 2 * t4 + odd, f = F + 8 * hf;
        if (r < hi && f < a.N)
          *reinterpret_cast<uint32_t*>(out + (long long)r * a.N + f) =
              odd ? sm90::pack_bf16(got, v1) : sm90::pack_bf16(v0, got);
      }
  }
}

template <int NR>
cudaError_t launch_swiglu_up_sm90(const GroupedArgs& a, cudaStream_t s) {
  CUtensorMap mx, mw1, mw3;
  int rank, w_rank, dim2;
  cudaError_t e = sm90::make_operand_map(&mx, a.x, a.K, a.M, a.K, 1, 0, 1, 0, NR, &rank, &dim2);
  if (e == cudaSuccess)
    e = sm90::make_operand_map(&mw1, a.w1, a.N, a.K, a.sw_k, 1, 0, a.E, a.sw_e, SW_KS, &w_rank,
                               &dim2);
  if (e == cudaSuccess)
    e = sm90::make_operand_map(&mw3, a.w3, a.N, a.K, a.sw_k, 1, 0, a.E, a.sw_e, SW_KS, &w_rank,
                               &dim2);
  if (e != cudaSuccess) return e;
  auto kernel = grouped_swiglu_up_sm90_kernel<NR>;
  constexpr int smem = sw_smem_bytes<NR>();
  static bool smem_set = false;  // once: later calls may be captured in a graph
  if (!smem_set) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const long long runs = (a.M + NR - 1) / NR + a.E + 1;
  if (runs > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)runs, (a.N + SW_FT - 1) / SW_FT);
  kernel<<<grid, 384, smem, s>>>(mx, mw1, mw3, a, w_rank);
  return cudaGetLastError();
}

// bf16 x (M, K) contiguous, w1 and w3 (E, K, N) with a unit n stride and
// shared strides, 16-byte aligned bases, K and N multiples of 8, the k
// stride and (E > 1) the expert stride multiples of 8 elements; the row
// tile NR = 16, 80 or 128.
cudaError_t swiglu_up_sm90(const GroupedArgs& a, int row_tile, cudaStream_t s) {
  if (a.M <= 0 || a.K <= 0 || a.N <= 0 || a.E <= 0 || a.K % 8 != 0 || a.N % 8 != 0 ||
      a.w3 == nullptr || a.w_kmajor || a.sw_n != 1 || a.sw_k % 8 != 0 ||
      (a.E > 1 && a.sw_e % 8 != 0) || (a.N + SW_FT - 1) / SW_FT > 65535 ||
      (uintptr_t)a.x % 16 || (uintptr_t)a.w1 % 16 || (uintptr_t)a.w3 % 16 ||
      (uintptr_t)a.out % 16)
    return cudaErrorInvalidValue;
  switch (row_tile) {
    case 16: return launch_swiglu_up_sm90<16>(a, s);
    case 80: return launch_swiglu_up_sm90<80>(a, s);
    case 128: return launch_swiglu_up_sm90<128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int BM, bool SWIGLU, bool WT>
cudaError_t launch(const GroupedArgs& a, cudaStream_t s) {
  constexpr int BK = Slice<T>::BK;
  constexpr int PAD = 16 / sizeof(T);
  const size_t smem = sizeof(T) * (size_t)STAGES *
                      ((size_t)BM * (BK + PAD) + (SWIGLU ? 2 : 1) * w_tile_elems<T, WT>());
  auto kernel = grouped_kernel<T, BM, SWIGLU, WT>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles_m = (a.M + BM - 1) / BM;
  const dim3 grid(tiles_m + a.E, (a.N + BN - 1) / BN);
  kernel<<<grid, NT, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, bool SWIGLU>
cudaError_t launch_bm(const GroupedArgs& a, int block_m, cudaStream_t s) {
  if (block_m == 16) return a.w_kmajor ? launch<T, 16, false, true>(a, s)
                                       : launch<T, 16, SWIGLU, false>(a, s);
  if (block_m == 64) return a.w_kmajor ? launch<T, 64, false, true>(a, s)
                                       : launch<T, 64, SWIGLU, false>(a, s);
  return cudaErrorInvalidValue;
}

template <bool SWIGLU>
int dispatch(const GroupedArgs* a, int dtype, int block_m, void* stream) {
  if (a == nullptr || a->M <= 0 || a->K <= 0 || a->N <= 0 || a->E <= 0 ||
      (a->N + BN - 1) / BN > 65535 || (SWIGLU && (a->w3 == nullptr || a->w_kmajor)))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch_bm<bf16, SWIGLU>(*a, block_m, s);
  if (dtype == 0) return launch_bm<float, SWIGLU>(*a, block_m, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_tgmm(const TgmmArgs& a, cudaStream_t s) {
  constexpr int BS = Slice<T>::BK;
  constexpr int PAD = 16 / sizeof(T);
  const size_t smem = sizeof(T) * (size_t)STAGES * BS * ((64 + PAD) + (BN + PAD));
  auto kernel = grouped_tgmm_kernel<T>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + BN - 1) / BN, (a.K + 63) / 64, a.E);
  kernel<<<grid, NT, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; block_m: 16 or 64. Returns a
// cudaError_t (0 = launched).
extern "C" int grouped_gmm_launch(const GroupedArgs* a, int dtype, int block_m, void* stream) {
  return dispatch<false>(a, dtype, block_m, stream);
}

// design: 0 = fp32 and 1 = mma_sync (grouped_kernel<float | bf16, block_m,
// true, false>, block_m 16 or 64), 2 = sm90 (grouped_swiglu_up_sm90_kernel
// at the row tile ``block_m``, 16, 80 or 128; see swiglu_up_sm90); any
// other code is refused. Returns a cudaError_t (0 = launched).
extern "C" int grouped_swiglu_up_launch(const GroupedArgs* a, int design, int block_m,
                                        void* stream) {
  if (a == nullptr) return cudaErrorInvalidValue;
  if (design == 0 || design == 1) return dispatch<true>(a, design, block_m, stream);
  if (design == 2) return swiglu_up_sm90(*a, block_m, (cudaStream_t)stream);
  return cudaErrorInvalidValue;
}

// The bf16 Hopper design of grouped_gmm: x (M, K) contiguous and w through
// its strides, bf16, 16-byte aligned bases, K a multiple of 8, w with a
// unit n stride (the forward) or a unit k stride (w_kmajor: the dx
// product's transposed view), its other two strides (the expert's where E
// > 1) multiples of 8 elements, M > 0. Returns a cudaError_t (0 =
// launched).
extern "C" int grouped_gmm_sm90_launch(const GroupedArgs* a, void* stream) {
  if (a == nullptr || a->M <= 0 || a->K <= 0 || a->N <= 0 || a->E <= 0 || a->K % 8 != 0 ||
      (uintptr_t)a->x % 16 != 0 || (uintptr_t)a->w1 % 16 != 0)
    return cudaErrorInvalidValue;
  const long long unit = a->w_kmajor ? a->sw_k : a->sw_n;
  const long long outer = a->w_kmajor ? a->sw_n : a->sw_k;
  if (unit != 1 || outer % 8 != 0 || (a->E > 1 && a->sw_e % 8 != 0))
    return cudaErrorInvalidValue;
  return launch_gmm_sm90(*a, (cudaStream_t)stream);
}

// The bf16 Hopper design: x, dy and out bf16 with 16-byte aligned bases and
// rows (K and N multiples of 8), M > 0. Returns a cudaError_t (0 =
// launched).
extern "C" int grouped_tgmm_sm90_launch(const TgmmArgs* a, void* stream) {
  if (a == nullptr || a->M <= 0 || a->K <= 0 || a->N <= 0 || a->E <= 0 || a->K % 8 != 0 ||
      a->N % 8 != 0 || (uintptr_t)a->x % 16 != 0 || (uintptr_t)a->dy % 16 != 0)
    return cudaErrorInvalidValue;
  return launch_tgmm_sm90(*a, (cudaStream_t)stream);
}

// out (E, K, N) in x's dtype; M may be 0 (every group empty: zeros).
extern "C" int grouped_tgmm_launch(const TgmmArgs* a, int dtype, void* stream) {
  if (a == nullptr || a->M < 0 || a->K <= 0 || a->N <= 0 || a->E <= 0 ||
      (a->K + 63) / 64 > 65535 || a->E > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch_tgmm<bf16>(*a, s);
  if (dtype == 0) return launch_tgmm<float>(*a, s);
  return cudaErrorInvalidValue;
}

// K9: x (M, K) times one expert's codes per group, WqArgs.group_sizes set;
// design and tile as grouped_wq; bits 8 or 4. Returns a cudaError_t (0 =
// launched).
extern "C" int grouped_gmm_wq_launch(const WqArgs* a, int design, int bits, int tile,
                                     void* stream) {
  return grouped_wq<false>(a, design, bits, tile, stream);
}

extern "C" int grouped_swiglu_up_wq_launch(const WqArgs* a, int design, int bits, int tile,
                                           void* stream) {
  return grouped_wq<true>(a, design, bits, tile, stream);
}
