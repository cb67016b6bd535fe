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
// [E, C, F]; each output sums its D products in fp32, k = 0..D-1 in order (so
// results are deterministic run to run), and is rounded once to x's dtype.
// Inputs are fp32, or bf16 widened to fp32 as they are staged (the Pallas
// kernel's preferred_element_type=float32).
//
// Bound on the card: the MoE serve path runs it at two shapes.  Prefill
// (4 x 512 tokens, top-6 of 64 experts, C = 240) is [64, 240, 2048] @
// [64, 2048, 1408]: 88.6 GFLOP on 475 MB, 0.09 ms at the bf16 tensor-core
// rate and 0.14 ms at the memory rate.  Decode (C = 1) reads every expert's
// weights, 369 MB for 2 flops a weight: bound by bytes, 0.11 ms.  This first
// kernel is the simple, exact one: CUDA-core fp32 FMAs out of shared memory,
// no tensor cores (mma/wgmma), no TMA, so the prefill shape runs at the fp32
// CUDA-core rate, far from the bf16 roof; tensor cores are later work.
//
// Design: one CTA of 256 threads per (64-column F tile, 64-row C tile,
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
// rows past C are never loaded.  The 16-byte path needs every row of x and w
// to start on 16 bytes (D and F multiples of 16 / sizeof(T), aligned bases);
// the launcher checks that and otherwise picks the scalar-load path, which
// stages the same tiles one element at a time (16 loads in flight per
// thread and operand).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <typename T>
int launch(const void* x, const void* w, void* out, int E, int C, int D, int F,
           int vec16, void* stream) {
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (vec16)
    grouped_matmul_kernel<T, true><<<grid, THREADS, 0, s>>>(xp, wp, op, C, D, F);
  else
    grouped_matmul_kernel<T, false><<<grid, THREADS, 0, s>>>(xp, wp, op, C, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int grouped_matmul_f32(const void* x, const void* w, void* out, int E,
                                  int C, int D, int F, int vec16, void* stream) {
  return launch<float>(x, w, out, E, C, D, F, vec16, stream);
}

extern "C" int grouped_matmul_bf16(const void* x, const void* w, void* out, int E,
                                   int C, int D, int F, int vec16, void* stream) {
  return launch<__nv_bfloat16>(x, w, out, E, C, D, F, vec16, stream);
}
