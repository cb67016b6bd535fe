// bmod: the sparselu trailing update  out = A - L @ U  (paper §5.6), on Hopper.
//
// Replaces: src/repro/kernels/block_lu/block_lu.py, _bmod_kernel (the Pallas
// kernel: one [bm, bn] tile per grid step, the contraction sequential, an
// fp32 accumulator in VMEM scratch).
//
// Bound on the card: at sparselu's blocks (fp32, square B x B, B in 64, 96,
// 128) the work is 2*B^3 flops on 4*B^2 words.  At B = 128 that is 4.2 MFLOP
// and 256 KiB, under a microsecond at the card's fp32 and HBM rates, so one
// launch is bound by latency: how many SMs share the work, and how long each
// thread's dependent loop of loads and FMAs runs.  Batching a wave's bmods
// into one launch would change the runtime's one-launch-per-task contract.
//
// Design: a shared-memory-tiled SGEMM with small tiles, kept exact.  A CTA
// of 256 threads owns a 32 x 32 output tile, so B = 128 runs 16 CTAs (B = 96:
// 9), and walks K in 32-wide steps.  The L and U tiles of the steps stream
// through a ring of NSTAGE shared-memory stages with 16-byte cp.async copies,
// so at B = 128 the whole contraction is in flight before the first FMA.
// Each thread accumulates a 2 x 2 register tile (rows ty and ty + 16, columns
// 2tx and 2tx + 1) in IEEE fp32 FMAs: no TF32 and no tensor cores (the 1e-4
// check and the factorization parity need full fp32).  It reads four
// consecutive k of its two L rows as one vector (the L tile keeps its
// row-major layout, rows padded by one 16-byte chunk) and its two U columns as
// one pair.  Each output sums k = 0..K-1 in order in one thread, so the
// result depends on the shapes alone: bitwise the same on any stream, from
// any thread, run after run.  Copies past M, N or K are zero-filled (cp.async
// reads only the bytes inside the matrix), which leaves the sums unchanged;
// the epilogue stores only inside the matrix.  cp.async needs 16-byte aligned
// rows; operands whose rows are not (K or N not a multiple of 16 bytes) take
// the same kernel with plain element loads into the ring instead (the
// launcher's "elementwise" path).  Inputs are fp32, or bf16 widened to fp32
// on read (the Pallas kernel's preferred_element_type); the result is written
// in A's dtype.

#include "hopper.cuh"

namespace {

constexpr int BM = 32;
constexpr int BN = 32;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int NSTAGE = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// four consecutive elements, and two, as fp32
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(x.x << 16); f[1] = __uint_as_float(x.x & 0xffff0000u);
  f[2] = __uint_as_float(x.y << 16); f[3] = __uint_as_float(x.y & 0xffff0000u);
}
__device__ __forceinline__ void load2(const float* p, float (&f)[2]) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  f[0] = x.x; f[1] = x.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float (&f)[2]) {
  const unsigned int x = *reinterpret_cast<const unsigned int*>(p);
  f[0] = __uint_as_float(x << 16); f[1] = __uint_as_float(x & 0xffff0000u);
}

template <typename T, bool ASYNC>
__global__ void __launch_bounds__(THREADS)
bmod_kernel(const T* __restrict__ a, const T* __restrict__ l,
            const T* __restrict__ u, T* __restrict__ out, int M, int N, int K) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));   // elements a 16-byte chunk
  constexpr int LP = BK + VEC;                            // L tile row pitch (elements)
  constexpr int STAGE = BM * LP + BK * BN;                // elements: L tile, U tile
  __shared__ __align__(16) unsigned char ring_bytes[NSTAGE * STAGE * sizeof(T)];
  T* ring = reinterpret_cast<T*>(ring_bytes);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  auto load_step = [&](int kt) {
    T* ls = ring + (kt % NSTAGE) * STAGE;
    T* us = ls + BM * LP;
    const int k0 = kt * BK;
    if constexpr (ASYNC) {
      for (int e = tid; e < BM * BK / VEC; e += THREADS) {      // L: [BM][BK]
        const int m = e / (BK / VEC), kc = (e % (BK / VEC)) * VEC;
        const int gm = row0 + m, gk = k0 + kc;
        const int n_in = gm < M ? min(max(K - gk, 0), VEC) : 0;
        const T* src = n_in > 0 ? l + static_cast<long long>(gm) * K + gk : l;
        hopper::cp_async16(ls + m * LP + kc, src, n_in * sizeof(T));
      }
      for (int e = tid; e < BK * BN / VEC; e += THREADS) {      // U: [BK][BN]
        const int k = e / (BN / VEC), nc = (e % (BN / VEC)) * VEC;
        const int gk = k0 + k, gn = col0 + nc;
        const int n_in = gk < K ? min(max(N - gn, 0), VEC) : 0;
        const T* src = n_in > 0 ? u + static_cast<long long>(gk) * N + gn : u;
        hopper::cp_async16(us + k * BN + nc, src, n_in * sizeof(T));
      }
    } else {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int m = e / BK, k = e % BK;
        const int gm = row0 + m, gk = k0 + k;
        ls[m * LP + k] = gm < M && gk < K ? l[static_cast<long long>(gm) * K + gk]
                                          : from_f32<T>(0.0f);
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int k = e / BN, n = e % BN;
        const int gk = k0 + k, gn = col0 + n;
        us[k * BN + n] = gk < K && gn < N ? u[static_cast<long long>(gk) * N + gn]
                                          : from_f32<T>(0.0f);
      }
    }
  };

  const int n_steps = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n_steps) load_step(s);
    if constexpr (ASYNC) hopper::cp_async_commit();
  }

  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  for (int kt = 0; kt < n_steps; ++kt) {
    if constexpr (ASYNC) hopper::cp_async_wait<NSTAGE - 2>();   // this thread's step kt
    __syncthreads();                       // everyone's; step kt - 1 consumed
    if (kt + NSTAGE - 1 < n_steps) load_step(kt + NSTAGE - 1);
    if constexpr (ASYNC) hopper::cp_async_commit();
    const T* ls = ring + (kt % NSTAGE) * STAGE;
    const T* us = ls + BM * LP;
#pragma unroll
    for (int k = 0; k < BK; k += 4) {
      float l0[4], l1[4];
      load4(ls + ty * LP + k, l0);
      load4(ls + (ty + 16) * LP + k, l1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float uf[2];
        load2(us + (k + i) * BN + 2 * tx, uf);
        acc[0][0] = fmaf(l0[i], uf[0], acc[0][0]);
        acc[0][1] = fmaf(l0[i], uf[1], acc[0][1]);
        acc[1][0] = fmaf(l1[i], uf[0], acc[1][0]);
        acc[1][1] = fmaf(l1[i], uf[1], acc[1][1]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gm = row0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int gn = col0 + 2 * tx + j;
      if (gn >= N) continue;
      const long long idx = static_cast<long long>(gm) * N + gn;
      out[idx] = from_f32<T>(to_f32(a[idx]) - acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* l, const void* u, void* out, int M, int N, int K,
           int async_copies, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (async_copies)
    bmod_kernel<T, true><<<grid, THREADS, 0, s>>>(
        static_cast<const T*>(a), static_cast<const T*>(l), static_cast<const T*>(u),
        static_cast<T*>(out), M, N, K);
  else
    bmod_kernel<T, false><<<grid, THREADS, 0, s>>>(
        static_cast<const T*>(a), static_cast<const T*>(l), static_cast<const T*>(u),
        static_cast<T*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a [M, N], l [M, K], u [K, N], out [M, N], all contiguous.  async_copies
// = 1 needs l and u 16-byte aligned with rows of a multiple of 16 bytes.
extern "C" int bmod_f32(const void* a, const void* l, const void* u, void* out,
                        int M, int N, int K, int async_copies, void* stream) {
  return launch<float>(a, l, u, out, M, N, K, async_copies, stream);
}

extern "C" int bmod_bf16(const void* a, const void* l, const void* u,
                         void* out, int M, int N, int K, int async_copies, void* stream) {
  return launch<__nv_bfloat16>(a, l, u, out, M, N, K, async_copies, stream);
}
