// grouped_matmul: the MoE expert GEMMs  out[e] = x[e] @ w[e]  for every expert
// e, on Hopper.
//
// Replaces: src/repro/kernels/grouped_matmul/grouped_matmul.py, _gmm_kernel
// (the Pallas kernel: grid (E, C/bc, F/bf, D/bd) with the contraction axis
// sequential and an fp32 accumulator in VMEM scratch).  On the card the
// contraction becomes a loop inside the block and the accumulator lives in
// registers.
//
// What it computes: x [E, C, D] (the capacity-dispatched token buffer, C
// slots per expert) times w [E, D, F] (the stacked expert weights) gives
// [E, C, F]; each output sums its D products in fp32 and is rounded once to
// x's dtype (the Pallas kernel's preferred_element_type=float32).  Every
// path sums in a fixed order (no atomics, no split of D across blocks), so
// results are the same run to run; the order differs between paths.
//
// Bound on the card: the MoE serve path runs it at two shapes.  Prefill
// (4 x 512 tokens, top-6 of 64 experts, C = 240) is [64, 240, 2048] @
// [64, 2048, 1408]: 88.6 GFLOP on 475 MB, 0.09 ms at the bf16 tensor-core
// rate and 0.14 ms at the memory rate, so a tensor-core kernel that reads
// each weight once is bound by bytes.  Decode (C = 1) is 2 flops a weight
// byte: bound by the weights it must read, 369 MB (0.11 ms) if every expert
// holds a token, but only ~20 of 64 do (4 rows x top-6), and an empty
// expert's slots are exact zeros (models/moe.py), whose products need no
// weight.
//
// Three paths, chosen by the launcher (grouped_matmul.py, gmm_path):
//
// 1. wgmma (bf16, C above the small-C limit, rows 16-byte aligned): one CTA
//    of three warpgroups per (128-row C tile, 128-column F tile, expert),
//    the C tiles of one (expert, F tile) adjacent in the grid so that they
//    run together and the second reads the weight tile from L2, not DRAM.
//    One thread of warpgroup 2 streams 64-deep steps of x ([128 rows][64])
//    and w ([64][128 columns], two 64-column boxes) by TMA (3-D tensor maps
//    over [E, C, D] and [E, D, F]; rows past C, columns past F and depth
//    past D read as zeros) through a four-stage mbarrier ring in the
//    128-byte swizzle; warpgroups 0 and 1 each run m64n128k16 wgmmas on
//    their 64 rows, x K-major and w MN-major (F contiguous: the
//    descriptor's transpose bit), keeping one step's products in flight
//    while the next stage lands.  A warpgroup whose rows all lie past C
//    (C = 60: one prompt admitted) computes nothing.  fp32 accumulators,
//    rounded once; rows past C and columns past F are not stored.
// 2. small C (bf16, C <= 16, rows 16-byte aligned, x[e] fits in shared
//    memory): bandwidth-shaped, for decode.  One CTA of 256 threads per
//    (256-column F slice, expert) first stages x[e] in shared memory; if
//    every value is zero it writes zeros and reads no weight (exact for
//    finite weights: 0 * w = 0), decided on the device.  Otherwise each
//    warp streams a contiguous eighth of w[e]'s rows with 16-byte loads,
//    eight in flight a thread, one lane per 8 columns, into fp32 FMAs with
//    x's C rows; the eight warps' partial sums meet in shared memory, added
//    in warp order.
// 3. CUDA cores (fp32; or rows that do not start on 16 bytes, such as a
//    ragged D or F): the first, simple kernel, described next.
//
// CUDA-core design: one CTA of 256 threads per (64-column F tile, 64-row C tile,
// expert).  It walks D in 64-wide steps; x's [64 rows x 64] tile and w's
// [64 x 64 columns] tile are staged in shared memory as fp32.  The next step's
// tiles are loaded into registers (16-byte loads, 2 per operand per thread in
// bf16, 4 in fp32, all in flight together) while the current step computes,
// so the loads' latency overlaps the FMAs.  Thread (ty, tx) owns rows
// 4ty..4ty+3 and columns 4tx..4tx+3 and reads both operands with 16-byte
// shared loads: 8 loads feed 64 FMAs.  Masked edges: rows past C, columns
// past F and depth past D are staged as zeros (which leave the sums
// unchanged) and never stored, so any C, D, F works, C = 1 (every decode
// step) included; a thread whose rows all lie past C skips the FMAs, and
// rows past C are never loaded.  In fp32 the 16-byte path needs every row of
// x and w to start on 16 bytes (D and F multiples of 4, aligned bases); the
// entry point checks that and otherwise picks the scalar-load path, which
// stages the same tiles one element at a time (16 loads in flight per
// thread and operand).  bf16 reaches this kernel only with rows that do not
// start on 16 bytes, so it takes the scalar-load path alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;        // rows of C per CTA
constexpr int BN = 64;        // columns of F per CTA
constexpr int BK = 64;        // depth of D per step
constexpr int THREADS = 256;
constexpr int XLD = BK + 4;   // x tile row pitch (floats): rows stay 16-byte aligned
constexpr int WLD = BN;       // w tile row pitch (floats)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Widen the VEC values held in a 16-byte register to fp32 and store them at
// dst (16-byte aligned) with 16-byte shared stores.
__device__ __forceinline__ void store_vec(float* dst, uint4 v, float) {
  *reinterpret_cast<float4*>(dst) = make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                                                __uint_as_float(v.z), __uint_as_float(v.w));
}
__device__ __forceinline__ void store_vec(float* dst, uint4 v, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(c.x, c.y, d.x, d.y);
}

// One [ROWS x COLS] tile of a row-major operand (row stride ld), origin
// `src`, of which rows < nr and columns < nc are inside the matrix.  load()
// starts every global load of the tile into registers; store() writes them
// to shared memory (pitch LD) as fp32.  Outside the matrix: zeros, no load.
template <typename T, int ROWS, int COLS, bool VEC16>
struct TileLoader;

template <typename T, int ROWS, int COLS>
struct TileLoader<T, ROWS, COLS, true> {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int PER_ROW = COLS / VEC;
  static constexpr int N = ROWS * PER_ROW / THREADS;
  static_assert(ROWS * PER_ROW % THREADS == 0, "tiling");
  uint4 buf[N];

  __device__ __forceinline__ void load(const T* src, long long ld, int nr, int nc, int tid) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / PER_ROW, c = (e % PER_ROW) * VEC;
      // nc is a multiple of VEC (checked by the launcher): a vector is
      // wholly inside or wholly outside
      buf[i] = (r < nr && c < nc)
                   ? __ldg(reinterpret_cast<const uint4*>(src + r * ld + c))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  template <int LD>
  __device__ __forceinline__ void store(float* dst, int tid) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / PER_ROW, c = (e % PER_ROW) * VEC;
      store_vec(dst + r * LD + c, buf[i], T());
    }
  }
};

template <typename T, int ROWS, int COLS>
struct TileLoader<T, ROWS, COLS, false> {
  static constexpr int N = ROWS * COLS / THREADS;
  static_assert(ROWS * COLS % THREADS == 0, "tiling");
  float buf[N];

  __device__ __forceinline__ void load(const T* src, long long ld, int nr, int nc, int tid) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / COLS, c = e % COLS;
      buf[i] = (r < nr && c < nc) ? to_f32(src[r * ld + c]) : 0.0f;
    }
  }
  template <int LD>
  __device__ __forceinline__ void store(float* dst, int tid) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = tid + i * THREADS;
      dst[(e / COLS) * LD + e % COLS] = buf[i];
    }
  }
};

template <typename T, bool VEC16>
__global__ void __launch_bounds__(THREADS, 2)
grouped_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      T* __restrict__ out, int C, int D, int F) {
  __shared__ __align__(16) float xs[BM * XLD];
  __shared__ __align__(16) float ws[BK * WLD];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int col0 = blockIdx.x * BN, row0 = blockIdx.y * BM;
  const int e = blockIdx.z;
  const int nr = min(BM, C - row0), nc = min(BN, F - col0);
  // a thread whose first row lies past C has no row to compute
  const bool active = 4 * ty < nr;

  const T* xe = x + (static_cast<long long>(e) * C + row0) * D;
  const T* we = w + static_cast<long long>(e) * D * F + col0;

  TileLoader<T, BM, BK, VEC16> xl;
  TileLoader<T, BK, BN, VEC16> wl;
  xl.load(xe, D, nr, min(BK, D), tid);
  wl.load(we, F, min(BK, D), nc, tid);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < D; k0 += BK) {
    xl.template store<XLD>(xs, tid);
    wl.template store<WLD>(ws, tid);
    __syncthreads();
    const int k1 = k0 + BK;
    if (k1 < D) {  // the next step's tiles, in flight during this step's FMAs
      xl.load(xe + k1, D, nr, min(BK, D - k1), tid);
      wl.load(we + static_cast<long long>(k1) * F, F, min(BK, D - k1), nc, tid);
    }
    if (active) {
#pragma unroll 4
      for (int kk = 0; kk < BK; kk += 4) {
        float a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(xs + (4 * ty + i) * XLD + kk);
          a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 b = *reinterpret_cast<const float4*>(ws + (kk + q) * WLD + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][0] = fmaf(a[i][q], b.x, acc[i][0]);
            acc[i][1] = fmaf(a[i][q], b.y, acc[i][1]);
            acc[i][2] = fmaf(a[i][q], b.z, acc[i][2]);
            acc[i][3] = fmaf(a[i][q], b.w, acc[i][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (!active) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= nr) break;
    T* orow = out + (static_cast<long long>(e) * C + row0 + r) * F + col0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * tx + j;
      if (c < nc) orow[c] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, bool VEC16>
int launch(const void* x, const void* w, void* out, int E, int C, int D, int F,
           void* stream) {
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  grouped_matmul_kernel<T, VEC16><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), C, D, F);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// The wgmma path (bf16, C > small-C limit)
// ---------------------------------------------------------------------------
namespace wg {

using bf16 = __nv_bfloat16;
constexpr int BM = 128;             // C rows per CTA: two warpgroups of 64
constexpr int BN = 128;             // F columns per CTA: two 64-column boxes
constexpr int BK = 64;              // D per stage
constexpr int STAGES = 4;
constexpr int THREADS = 384;        // warpgroups 0, 1 consume; 2 produces
constexpr int CONSUMERS = 256;
constexpr int BOX = 64 * 64;
constexpr int BOX_BYTES = BOX * 2;

struct Smem {
  bf16 x[STAGES][2][BOX];           // [stage][warpgroup]: [64 rows][64 of D]
  bf16 w[STAGES][2][BOX];           // [stage][F half]: [64 of D][64 columns]
  uint64_t full[STAGES], empty[STAGES];
};
constexpr size_t SMEM_BYTES = sizeof(Smem) + 1024;

// blockIdx = (C tile, F tile, expert)
__global__ void __launch_bounds__(THREADS, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap, bf16* __restrict__ out, int C,
                 int D, int F) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align_1024(smem_raw));
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, e = blockIdx.z;
  const int n_k = (D + BK - 1) / BK;
  const int x_boxes = m0 + 64 < C ? 2 : 1;     // warpgroups with a row inside C

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer ----
    if (tid == CONSUMERS) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&sm.empty[s], ((kt / STAGES) - 1) & 1);
        const int k0 = kt * BK;
        mbar_expect_tx(&sm.full[s], (x_boxes + 2) * BOX_BYTES);
        for (int wgi = 0; wgi < x_boxes; ++wgi)
          tma_load_3d(sm.x[s][wgi], &xmap, &sm.full[s], k0, m0 + 64 * wgi, e);
#pragma unroll
        for (int c = 0; c < 2; ++c) tma_load_3d(sm.w[s][c], &wmap, &sm.full[s], n0 + 64 * c, k0, e);
      }
    }
    return;
  }

  // ---- consumers: warpgroup g owns rows m0 + 64 g .. + 63 ----
  const int g = tid / 128;
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const bool live = m0 + 64 * g < C;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < n_k; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&sm.full[s], (kt / STAGES) & 1);
    if (live) {
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = desc_sw128(sm.x[s][g] + kk * 16, 16, 1024);
        const uint64_t db = desc_sw128(sm.w[s][0] + kk * 16 * 64, BOX_BYTES, 1024);
        wgmma_ss_n128<1>(acc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();            // the previous step's products are done
      fence_regs(acc);
    }
    if (kt > 0) mbar_arrive(&sm.empty[(kt - 1) % STAGES]);
  }
  if (!live) return;
  wgmma_wait<0>();
  fence_regs(acc);

  // acc[4i + 2j + c] is (row 16 warp + lane/4 + 8j, column 8i + 2(lane%4) + c)
  const int cq = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = m0 + 64 * g + 16 * warp + lane / 4 + 8 * j;
    if (row >= C) continue;
    bf16* orow = out + (static_cast<long long>(e) * C + row) * F + n0 + cq;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
      if (n0 + 8 * i + cq < F)
        *reinterpret_cast<uint32_t*>(orow + 8 * i) =
            pack_bf16(acc[4 * i + 2 * j], acc[4 * i + 2 * j + 1]);
  }
}

int launch(const void* x, const void* w, void* out, int E, int C, int D, int F, void* stream) {
  CUtensorMap xm, wm;
  const uint64_t xd[3] = {static_cast<uint64_t>(D), static_cast<uint64_t>(C),
                          static_cast<uint64_t>(E)};
  const uint64_t xs[2] = {2ull * D, 2ull * C * D};
  const uint64_t wd[3] = {static_cast<uint64_t>(F), static_cast<uint64_t>(D),
                          static_cast<uint64_t>(E)};
  const uint64_t ws[2] = {2ull * F, 2ull * D * F};
  int err = hopper::encode_bf16_sw128(&xm, x, 3, xd, xs, 64);
  if (!err) err = hopper::encode_bf16_sw128(&wm, w, 3, wd, ws, 64);
  if (err) return err;
  static bool opted_in = false;     // idempotent, so a benign race
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        gmm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_BYTES));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const dim3 grid((C + BM - 1) / BM, (F + BN - 1) / BN, E);
  gmm_wgmma_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      xm, wm, static_cast<bf16*>(out), C, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ---------------------------------------------------------------------------
// The small-C path (bf16, C <= 16): decode
// ---------------------------------------------------------------------------
namespace small_c {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;        // eight warps
constexpr int WARPS = THREADS / 32;
constexpr int COLS = 256;           // F columns per CTA: 8 per lane
constexpr int UNROLL = 8;           // weight rows in flight per thread
constexpr int MAX_X_BYTES = 96 * 1024;

// blockIdx = (F slice, expert); C <= CM.  Dynamic shared memory: x[e], C x D.
template <int CM>
__global__ void __launch_bounds__(THREADS)
gmm_small_c_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   bf16* __restrict__ out, int C, int D, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  __shared__ __align__(16) float red[WARPS][COLS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int f0 = blockIdx.x * COLS, e = blockIdx.y;

  // x[e] into shared memory; is any value non-zero (ignoring the sign bit)?
  const bf16* xe = x + static_cast<long long>(e) * C * D;
  const int n_vec = C * D / 8;
  unsigned int any = 0;
  for (int i = tid; i < n_vec; i += THREADS) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(xe) + i);
    reinterpret_cast<uint4*>(xs)[i] = v;
    any |= (v.x | v.y | v.z | v.w) & 0x7fff7fffu;
  }
  bf16* oe = out + static_cast<long long>(e) * C * F;
  if (!__syncthreads_or(any != 0)) {        // an empty expert: zeros, no weight read
    for (int i = tid; i < C * COLS; i += THREADS) {
      const int c = i / COLS, f = f0 + i % COLS;
      if (f < F) oe[static_cast<long long>(c) * F + f] = __float2bfloat16(0.0f);
    }
    return;
  }

  const int f = f0 + 8 * lane;              // this lane's 8 columns
  const bool col_ok = f < F;                // F % 8 == 0: a vector is wholly in or out
  const int rows = (D + WARPS - 1) / WARPS;
  const int d_beg = warp * rows, d_end = min(D, d_beg + rows);
  const bf16* wp = w + static_cast<long long>(e) * D * F + f;
  float acc[CM][8];
#pragma unroll
  for (int c = 0; c < CM; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[c][j] = 0.0f;

  for (int d0 = d_beg; d0 < d_end; d0 += UNROLL) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      v[u] = col_ok && d0 + u < d_end
                 ? __ldg(reinterpret_cast<const uint4*>(wp + static_cast<long long>(d0 + u) * F))
                 : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (d0 + u >= d_end) break;
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[u]);
      float wv[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 t = __bfloat1622float2(h[q]);
        wv[2 * q] = t.x;
        wv[2 * q + 1] = t.y;
      }
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        if (c >= C) break;
        const float xv = __bfloat162float(xs[c * D + d0 + u]);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[c][j] = fmaf(xv, wv[j], acc[c][j]);
      }
    }
  }

  // the warps' partial sums, added in warp order, one row of C at a time
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    if (c >= C) break;
    float4* dst = reinterpret_cast<float4*>(&red[warp][8 * lane]);
    dst[0] = make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
    dst[1] = make_float4(acc[c][4], acc[c][5], acc[c][6], acc[c][7]);
    __syncthreads();
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) sum += red[k][tid];
    if (f0 + tid < F) oe[static_cast<long long>(c) * F + f0 + tid] = __float2bfloat16(sum);
    __syncthreads();
  }
}

template <int CM>
int launch_cm(const void* x, const void* w, void* out, int E, int C, int D, int F,
              void* stream) {
  static bool opted_in = false;     // idempotent, so a benign race
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        gmm_small_c_kernel<CM>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_X_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const dim3 grid((F + COLS - 1) / COLS, E);
  gmm_small_c_kernel<CM><<<grid, THREADS, static_cast<size_t>(C) * D * 2,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(out), C, D, F);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* x, const void* w, void* out, int E, int C, int D, int F, void* stream) {
  if (C < 1 || C > 16 || static_cast<long long>(C) * D * 2 > MAX_X_BYTES || D % 8 || F % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C <= 1) return launch_cm<1>(x, w, out, E, C, D, F, stream);
  if (C <= 2) return launch_cm<2>(x, w, out, E, C, D, F, stream);
  if (C <= 4) return launch_cm<4>(x, w, out, E, C, D, F, stream);
  if (C <= 8) return launch_cm<8>(x, w, out, E, C, D, F, stream);
  return launch_cm<16>(x, w, out, E, C, D, F, stream);
}

}  // namespace small_c

}  // namespace

// x [E, C, D] @ w [E, D, F], contiguous: 16-byte staging where every row
// starts on 16 bytes, scalar staging otherwise
extern "C" int grouped_matmul_f32(const void* x, const void* w, void* out, int E,
                                  int C, int D, int F, void* stream) {
  const bool vec16 = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0 && D % 4 == 0 && F % 4 == 0;
  return vec16 ? launch<float, true>(x, w, out, E, C, D, F, stream)
               : launch<float, false>(x, w, out, E, C, D, F, stream);
}

// the same in bf16, scalar staging: rows that start on 16 bytes take the
// wgmma or small-C path
extern "C" int grouped_matmul_bf16(const void* x, const void* w, void* out, int E,
                                   int C, int D, int F, void* stream) {
  return launch<__nv_bfloat16, false>(x, w, out, E, C, D, F, stream);
}

// bf16 x [E, C, D] @ w [E, D, F], contiguous, every row 16-byte aligned (D and
// F multiples of 8): the tensor-core path
extern "C" int grouped_matmul_bf16_wgmma(const void* x, const void* w, void* out, int E,
                                         int C, int D, int F, void* stream) {
  return wg::launch(x, w, out, E, C, D, F, stream);
}

// the same arguments, C <= 16 and C * D * 2 <= 96 KB: the small-C path
extern "C" int grouped_matmul_bf16_small_c(const void* x, const void* w, void* out, int E,
                                           int C, int D, int F, void* stream) {
  return small_c::launch(x, w, out, E, C, D, F, stream);
}
