// bmod: the sparselu trailing update  out = A - L @ U  (paper §5.6), on Hopper.
//
// Replaces: src/repro/kernels/block_lu/block_lu.py, _bmod_kernel (the Pallas
// kernel: one [bm, bn] tile per grid step, the contraction sequential, an
// fp32 accumulator in VMEM scratch).
//
// Bound on the card: at sparselu's blocks (fp32, square B x B, B in 64, 96,
// 128) the work is 2*B^3 flops on 4*B^2 words.  At B = 128 that is 4.2 MFLOP
// and 256 KiB, under a microsecond at the card's fp32 and HBM rates, so one
// launch is bound by launch latency, not by either roof; batching a wave's
// bmods into one launch is later work.
//
// Design: a shared-memory-tiled SGEMM, kept simple and exact.  A block of
// 256 threads owns a 64 x 64 output tile and walks K in 16-wide tiles of L
// and U staged in shared memory; each thread accumulates a 4 x 4 register
// tile in IEEE fp32 (no TF32, no tensor cores: the 1e-4 check and the
// factorization parity need full fp32).  Thread (ty, tx) owns rows ty + 16i
// and columns tx + 16j, so a warp's epilogue writes 16 adjacent columns per
// row.  Loads outside M, N or K are masked to zero (B = 96 is not a multiple
// of 64), which leaves the sums unchanged; the epilogue stores only inside
// the matrix.  Each output sums k = 0..K-1 in order, so results are
// deterministic run to run.  Inputs are fp32, or bf16 widened to fp32 on
// load (the Pallas kernel's preferred_element_type); the result is written
// in A's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bmod_kernel(const T* __restrict__ a, const T* __restrict__ l,
            const T* __restrict__ u, T* __restrict__ out, int M, int N, int K) {
  // L tile stored transposed (k-major) and padded so the transposing store
  // does not conflict on shared-memory banks
  __shared__ float ls[BK][BM + 1];
  __shared__ float us[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int m = e / BK, k = e % BK;
      const int gm = row0 + m, gk = k0 + k;
      ls[k][m] = (gm < M && gk < K) ? to_f32(l[static_cast<long long>(gm) * K + gk]) : 0.0f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int k = e / BN, n = e % BN;
      const int gk = k0 + k, gn = col0 + n;
      us[k][n] = (gk < K && gn < N) ? to_f32(u[static_cast<long long>(gk) * N + gn]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float lf[4], uf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) lf[i] = ls[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) uf[j] = us[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(lf[i], uf[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = row0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = col0 + tx + 16 * j;
      if (gn >= N) continue;
      const long long idx = static_cast<long long>(gm) * N + gn;
      out[idx] = from_f32<T>(to_f32(a[idx]) - acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* l, const void* u, void* out, int M,
           int N, int K, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  bmod_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(l),
      static_cast<const T*>(u), static_cast<T*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bmod_f32(const void* a, const void* l, const void* u, void* out,
                        int M, int N, int K, void* stream) {
  return launch<float>(a, l, u, out, M, N, K, stream);
}

extern "C" int bmod_bf16(const void* a, const void* l, const void* u,
                         void* out, int M, int N, int K, void* stream) {
  return launch<__nv_bfloat16>(a, l, u, out, M, N, K, stream);
}
