// ssd_scan: the Mamba2 SSD chunked scan (state-space duality), on Hopper.
//
// Replaces: src/repro/kernels/ssd_scan/ssd_scan.py, _ssd_kernel (the Pallas
// kernel: grid (batch*heads, chunk) with the chunk axis sequential and the
// running [N, P] state in VMEM scratch).  On the card the chunk axis becomes a
// loop inside the block, and the state lives in shared memory.
//
// What it computes, for every sequence b and head h (group g = h / (H / G)),
// over the rows t of a chunk with la = dt * A and cum its inclusive cumsum:
//   intra:  y_t  = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//   inter:  y_t += exp(cum_t) (C_t . h_in)
//   state:  h_out = h_in exp(cum_last) + sum_t exp(cum_last - cum_t) B_t (x) dt_t x_t
// in fp32 from the inputs' values, y rounded once to x's dtype; the final
// state is written in fp32.  As in the Pallas kernel, the state starts from
// zero and the state entering a chunk is kept in fp32 (the jnp oracle rounds
// it to the projections' dtype before the inter term, so the two differ by
// that rounding in bf16).  The scan is exact under any chunking, so the
// kernel runs its own chunk length, Q = 64, whatever the model's chunk: only
// the rounding order moves.  A ragged tail (S not a multiple of Q) is masked:
// rows past S load dt = 0, x = B = C = 0, so they decay nothing and add
// nothing, and the final state is exact; their y is not stored.
//
// Reads the model's layout in place: x [b, S, H, P], B and C [b, S, G, N] with
// any strides (the last dim contiguous), so the in-projection's slices are
// never copied and no group is repeated; dt [b, S, H] and A [H] in fp32.
//
// Bound on the card: bytes.  At zamba2-2.7b's prefill (b = 4, S = 512, 80
// heads of P = 64, N = 64, bf16) x and y are 21 MB each, the state 5.2 MB, dt
// 0.66 MB, B and C 0.52 MB: about 48 MB, 14.5 us at 3.35 TB/s, against ~4
// GFLOP that the tensor cores would do in ~4 us.
// Design, the simple one: one CTA of 256 threads per (b, h), walking the
// chunks in order.  Per chunk it stages dt*x, B and C in shared memory as
// fp32, warp 0 takes the inclusive cumsum of dt*A by a warp scan, and three
// 64-row products follow, each thread owning a strided 4 x (P/16) (or
// (N/16) x (P/16)) block of outputs in registers: the scores C B^T times the
// decay L (built on the fly from the cumsums, zero above the diagonal) into a
// [Q, Q] shared tile; y = (C B^T . L)(dt x) + exp(cum) (C h); then the state
// update.  fp32 CUDA-core FMAs, no tensor cores: 0.08 ms of fp32 work at the
// zamba2 shape at the CUDA cores' peak, far above the byte bound; wgmma and
// more than one CTA per head are later work.  Shared memory: 82 KB at N = 64
// (two CTAs per SM), 130 KB at N = 128, so the launch opts in past 48 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int Q = 64;         // rows per chunk (the kernel's own chunk length)
constexpr int THREADS = 256;  // a 16 x 16 grid of threads over each tile
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {              // in elements
  long long x_b, x_s, x_h;    // x [b, S, H, P]
  long long dt_b, dt_s, dt_h; // dt [b, S, H]
  long long b_b, b_s, b_g;    // B [b, S, G, N]
  long long c_b, c_s, c_g;    // C [b, S, G, N]
};

template <int P, int N>
constexpr size_t smem_floats() {
  return static_cast<size_t>(Q) * P + 2 * Q * (N + 1) + Q * (Q + 1) + N * P + 4 * Q;
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y, float* __restrict__ h_out, Strides st, int S,
                int H, int G) {
  constexpr int LDN = N + 1;  // B, C rows padded one word: 16 rows, 16 banks
  constexpr int LDQ = Q + 1;
  constexpr int PJ = P / 16;  // output columns per thread (y and state)
  constexpr int NI = N / 16;  // state rows per thread
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;           // [Q][P]   dt * x
  float* Bs = Xs + Q * P;     // [Q][LDN]
  float* Cs = Bs + Q * LDN;   // [Q][LDN]
  float* Ss = Cs + Q * LDN;   // [Q][LDQ] (C B^T) * L
  float* Hs = Ss + Q * LDQ;   // [N][P]   the state entering the chunk
  float* dts = Hs + N * P;    // [Q]
  float* cum = dts + Q;       // [Q] inclusive cumsum of dt * A
  float* ein = cum + Q;       // [Q] exp(cum)
  float* wend = ein + Q;      // [Q] exp(cum[Q - 1] - cum)

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const float a_h = A[h];
  const T* xb = x + b * st.x_b + h * st.x_h;
  const float* dtb = dt + b * st.dt_b + h * st.dt_h;
  const T* Bb = Bm + b * st.b_b + g * st.b_g;
  const T* Cb = Cm + b * st.c_b + g * st.c_g;
  const long long hoff = static_cast<long long>(bh) * N * P;

  for (int e = tid; e < N * P; e += THREADS) Hs[e] = 0.0f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int rows = min(Q, S - c0);
    __syncthreads();                  // the previous chunk fully consumed
    if (tid < Q) dts[tid] = tid < rows ? dtb[(c0 + tid) * st.dt_s] : 0.0f;
    __syncthreads();

    if (warp == 0) {                  // inclusive cumsum of dt * A, two rows a lane
      const float a0 = dts[2 * lane] * a_h, a1 = dts[2 * lane + 1] * a_h;
      float s = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(FULL, s, off);
        if (lane >= off) s += t;
      }
      float before = __shfl_up_sync(FULL, s, 1);
      if (lane == 0) before = 0.0f;
      const float c0v = before + a0, c1v = c0v + a1;
      const float last = __shfl_sync(FULL, c1v, 31);
      cum[2 * lane] = c0v;
      cum[2 * lane + 1] = c1v;
      ein[2 * lane] = expf(c0v);
      ein[2 * lane + 1] = expf(c1v);
      wend[2 * lane] = expf(last - c0v);
      wend[2 * lane + 1] = expf(last - c1v);
    }
#pragma unroll 4
    for (int e = tid; e < Q * P; e += THREADS) {
      const int r = e / P, c = e % P;
      Xs[e] = r < rows ? to_f32(xb[(c0 + r) * st.x_s + c]) * dts[r] : 0.0f;
    }
#pragma unroll 4
    for (int e = tid; e < Q * N; e += THREADS) {
      const int r = e / N, c = e % N;
      const bool live = r < rows;
      Bs[r * LDN + c] = live ? to_f32(Bb[(c0 + r) * st.b_s + c]) : 0.0f;
      Cs[r * LDN + c] = live ? to_f32(Cb[(c0 + r) * st.c_s + c]) : 0.0f;
    }
    __syncthreads();

    // scores: Ss[i][j] = (C_i . B_j) exp(cum_i - cum_j) for j <= i, else 0
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < N; ++k) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Cs[(ty + 16 * i) * LDN + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * LDN + k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          Ss[r * LDQ + c] = c <= r ? acc[i][j] * expf(cum[r] - cum[c]) : 0.0f;
        }
      }
    }
    __syncthreads();

    // y = Ss (dt x) + exp(cum) (C h_in), rows ty + 16 i, columns tx + 16 j
    {
      float acc[4][PJ], inter[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = inter[i][j] = 0.0f;
#pragma unroll 4
      for (int k = 0; k < Q; ++k) {
        float a[4], bv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Ss[(ty + 16 * i) * LDQ + k];
#pragma unroll
        for (int j = 0; j < PJ; ++j) bv[j] = Xs[k * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float a[4], bv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Cs[(ty + 16 * i) * LDN + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) bv[j] = Hs[n * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) inter[i][j] = fmaf(a[i], bv[j], inter[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r < rows) {
          T* yrow = y + ((static_cast<long long>(b) * S + c0 + r) * H + h) * P;
#pragma unroll
          for (int j = 0; j < PJ; ++j)
            yrow[tx + 16 * j] = from_f32<T>(acc[i][j] + ein[r] * inter[i][j]);
        }
      }
    }

    // state: h_out = h_in exp(cum_last) + sum_t wend_t B_t (x) (dt x)_t
    {
      float s[NI][PJ];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) s[i][j] = 0.0f;
#pragma unroll 4
      for (int t = 0; t < Q; ++t) {
        const float w = wend[t];
        float a[NI], bv[PJ];
#pragma unroll
        for (int i = 0; i < NI; ++i) a[i] = Bs[t * LDN + ty + 16 * i] * w;
#pragma unroll
        for (int j = 0; j < PJ; ++j) bv[j] = Xs[t * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) s[i][j] = fmaf(a[i], bv[j], s[i][j]);
      }
      const float decay = ein[Q - 1];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j)
          s[i][j] += Hs[(ty + 16 * i) * P + tx + 16 * j] * decay;
      __syncthreads();                // every read of h_in (the inter term) done
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) Hs[(ty + 16 * i) * P + tx + 16 * j] = s[i][j];
    }
  }

  __syncthreads();
  for (int e = tid; e < N * P; e += THREADS) h_out[hoff + e] = Hs[e];
}

template <typename T, int P, int N>
int launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
           void* y, void* h_out, const Strides& st, int b, int S, int H, int G,
           void* stream) {
  const size_t smem = sizeof(float) * smem_floats<P, N>();
  static bool opted_in = false;     // idempotent, so a benign race
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  ssd_scan_kernel<T, P, N><<<b * H, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<T*>(y),
      static_cast<float*>(h_out), st, S, H, G);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* A, const void* B, const void* C,
             void* y, void* h_out, const long long* s, int b, int S, int H, int G,
             int P, int N, void* stream) {
  if (G <= 0 || H % G != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
  if (P == 64 && N == 64)
    return launch<T, 64, 64>(x, dt, A, B, C, y, h_out, st, b, S, H, G, stream);
  if (P == 64 && N == 128)
    return launch<T, 64, 128>(x, dt, A, B, C, y, h_out, st, b, S, H, G, stream);
  if (P == 16 && N == 16)
    return launch<T, 16, 16>(x, dt, A, B, C, y, h_out, st, b, S, H, G, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x [b, S, H, P], B/C [b, S, G, N] in the kernel's dtype and dt [b, S, H]
// fp32, with the given element strides (x: batch, row, head; dt: batch, row,
// head; B and C: batch, row, group; the last dims contiguous); A [H] fp32;
// y [b, S, H, P] and h_out [b, H, N, P] (fp32) contiguous.
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* B,
                            const void* C, void* y, void* h_out,
                            const long long* strides, int b, int S, int H, int G,
                            int P, int N, void* stream) {
  return dispatch<float>(x, dt, A, B, C, y, h_out, strides, b, S, H, G, P, N, stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A, const void* B,
                             const void* C, void* y, void* h_out,
                             const long long* strides, int b, int S, int H, int G,
                             int P, int N, void* stream) {
  return dispatch<__nv_bfloat16>(x, dt, A, B, C, y, h_out, strides, b, S, H, G, P, N,
                                 stream);
}
