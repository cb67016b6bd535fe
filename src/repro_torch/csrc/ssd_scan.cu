// ssd_scan: the Mamba2 SSD chunked scan (state-space duality), on Hopper.
//
// Replaces: src/repro/kernels/ssd_scan/ssd_scan.py, _ssd_kernel (the Pallas
// kernel: grid (batch*heads, chunk) with the chunk axis sequential and the
// running [N, P] state in VMEM scratch).  On the card the chunk axis is cut
// across the CTAs of a thread-block cluster, whose states are folded in
// order through distributed shared memory.
//
// What it computes, for every sequence b and head h (group g = h / (H / G)),
// over the rows t of a chunk with la = dt * A and cum its inclusive cumsum:
//   intra:  y_t  = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//   inter:  y_t += exp(cum_t) (C_t . h_in)
//   state:  h_out = h_in exp(cum_last) + sum_t exp(cum_last - cum_t) B_t (x) dt_t x_t
// in fp32 from the inputs' values, y rounded once to x's dtype; the final
// state is written in fp32.  As in the Pallas kernel, the state starts from
// zero and the state entering a chunk is kept in fp32 (the jnp oracle rounds
// it to the projections' dtype before the inter term).  The scan is exact
// under any chunking, so the kernel runs its own chunk length, Q = 64,
// whatever the model's chunk: only the rounding order moves.  A ragged tail
// (S not a multiple of Q) is masked: rows past S load dt = 0, x = B = C = 0,
// so they decay nothing and add nothing, and their y is not stored.
//
// Reads the model's layout in place: x [b, S, H, P], B and C [b, S, G, N] with
// any strides (the last dim contiguous, rows 16-byte aligned), so the
// in-projection's slices are never copied and no group is repeated; dt
// [b, S, H] and A [H] in fp32.
//
// Bound on the card: bytes.  At zamba2-2.7b's prefill (b = 4, S = 512, 80
// heads of P = 64, N = 64, bf16) x and y are 21 MB each, the state 5.2 MB, dt
// 0.66 MB, B and C 0.52 MB: about 48 MB, 14.4 us at 3.35 TB/s, against ~4
// GFLOP that the tensor cores would do in ~4 us.
//
// Design.  One cluster of `cluster` CTAs per (b, h) (launched with
// cudaLaunchKernelEx and a cluster dimension); CTA c takes the run of `per`
// whole chunks from chunk c * per (the launcher's ssd_plan: about four
// chunks a CTA, at most eight CTAs; at S = 512 two CTAs of four).  Three
// phases:
//  1. in parallel, each CTA stages its chunks one at a time and folds their
//     states from zero into its run's local state, with the run's decay (the
//     product of exp(cum_last) over its chunks);
//  2. the fold, in cluster order: CTA c waits on an mbarrier in its own
//     shared memory for h_in from CTA c - 1 (CTA 0 takes zero), forms h_out =
//     h_in * decay + local in place and copies it into CTA c + 1's shared
//     memory (mapa + cp.async.bulk, completing as bytes on c + 1's mbarrier);
//     the last CTA writes the final state.  N x P FMAs a hop, in a fixed
//     order: the result is deterministic;
//  3. each CTA walks its run again from h_in, staging each chunk anew: y =
//     y_intra + exp(cum) (C h), stored once, and h <- h exp(cum_last) + the
//     chunk's state for the next chunk of the run.
// A cluster barrier after the mbarriers' init orders them before any copy.
// On the tensor-core path each warp folds its own 16 rows of the state (a
// chain per warp, an mbarrier per warp), and CTA c + 1's warps acknowledge
// on an mbarrier in CTA c that their rows have landed, so c keeps its shared
// memory until then and leaves without waiting for the whole cluster.
// Measured on an H100 (700 W) at zamba2's prefill: one-chunk runs of eight
// CTAs gave 0.0832 ms, runs of four on two CTAs 0.0748; per-thread remote
// stores (st.shared::cluster, or st.async) made a hop 1.2-1.6 us where one
// bulk copy a warp takes ~0.7; a second staging buffer to prefetch the next
// chunk halved the CTAs per SM and lost more than it hid.
//
// Two paths (the launcher's ssd_path):
//  * wgmma (bf16, P = 64, N = 64 or 128): one warpgroup a CTA.  x, B, C and
//    dt are staged by cp.async, x, B and C as bf16 into the 128-byte-swizzled
//    boxes wgmma reads; every product is an m64n64k16 wgmma with fp32
//    accumulators: C B^T (both operands as they are, from shared memory);
//    C h (h as the MN-major B operand); (C B^T . L . dt) x and W^T x with W =
//    B . exp(cum_last - cum) . dt (A from registers, x the MN-major B
//    operand, one m64 block of the state per 64 rows of N).  The three
//    derived fp32 operands (C B^T . L . dt, W and h) each enter as a bf16
//    pair hi + lo (two products into one accumulator), so the arithmetic
//    stays within ~2^-16 of fp32; x, B and C are exact bf16.  y accumulates
//    C h first, scaled by exp(cum) in registers, then the intra product on
//    top; L comes from the SFU's 2^x of the cumsums scaled by log2(e).
//  * fma (fp32 at P = 64, N = 64 or 128; both dtypes at P = N = 16): 256
//    threads, the chunk staged as fp32 in shared memory, each thread owning
//    a 4 x (P/16) (or (N/16) x (P/16)) block of outputs, CUDA-core FMAs; one
//    bulk copy a hop, and a closing cluster barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int Q = 64;                 // rows per chunk (the kernel's own chunk length)
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

// the chunks [k0, k1) of cluster rank `rank`
struct Run {
  int k0, k1;
};
__device__ __forceinline__ Run chunk_run(int rank, int per, int S) {
  const int k0 = rank * per;
  return {k0, min(k0 + per, (S + Q - 1) / Q)};
}

// Warp 0: the inclusive cumsum of dt * a over a chunk, two rows a lane;
// ein = exp(cum), wend = exp(cum_last - cum) (times dt when WEND_DT).
template <bool WEND_DT>
__device__ __forceinline__ void chunk_cumsum(const float* dts, float* cum, float* ein,
                                             float* wend, float a_h, int lane) {
  const float d0 = dts[2 * lane], d1 = dts[2 * lane + 1];
  const float a0 = d0 * a_h, a1 = d1 * a_h;
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
  wend[2 * lane] = expf(last - c0v) * (WEND_DT ? d0 : 1.0f);
  wend[2 * lane + 1] = expf(last - c1v) * (WEND_DT ? d1 : 1.0f);
}

// Launch `kernel` as clusters of `cluster` CTAs along x, one per (b, h).
template <typename... KArgs, typename... Args>
int launch_clusters(void (*kernel)(KArgs...), size_t smem, int threads, int cluster, int bh,
                    void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster) * static_cast<unsigned>(bh));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The fma path (CUDA cores)
// ---------------------------------------------------------------------------
namespace cores {

constexpr int THREADS = 256;          // a 16 x 16 grid of threads over each tile

template <int P, int N>
struct Layout {                       // offsets in floats after the 16-byte mbarrier slot
  static constexpr int LDN = N + 1;   // B, C rows padded one word: 16 rows, 16 banks
  static constexpr int LDQ = Q + 1;
  static constexpr int XS = 0;                  // [Q][P]   dt * x
  static constexpr int BS = XS + Q * P;         // [Q][LDN]
  static constexpr int CS = BS + Q * LDN;       // [Q][LDN]
  static constexpr int SS = CS + Q * LDN;       // [Q][LDQ] (C B^T) * L
  static constexpr int HS = SS + Q * LDQ;       // [N][P]   the state
  static constexpr int RS = HS + N * P;         // [N][P]   h_in from the previous CTA
  static constexpr int DT = RS + N * P;         // [Q] dt, cum, exp(cum), exp(cum_last - cum)
  static constexpr int END = DT + 4 * Q;
  static_assert(RS % 4 == 0, "the bulk copy's source starts on 16 bytes");
  static constexpr size_t BYTES = 16 + sizeof(float) * END;
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_fma_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, T* __restrict__ y, float* __restrict__ h_out,
               Strides st, int S, int H, int G, int cluster, int per) {
  using L = Layout<P, N>;
  constexpr int LDN = L::LDN, LDQ = L::LDQ;
  constexpr int PJ = P / 16;          // output columns per thread (y and state)
  constexpr int NI = N / 16;          // state rows per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* recv_full = reinterpret_cast<uint64_t*>(smem_raw);
  float* smem = reinterpret_cast<float*>(smem_raw + 16);
  float* Xs = smem + L::XS;
  float* Bs = smem + L::BS;
  float* Cs = smem + L::CS;
  float* Ss = smem + L::SS;
  float* Hs = smem + L::HS;
  float* Rs = smem + L::RS;
  float* dts = smem + L::DT;
  float* cum = dts + Q;
  float* ein = cum + Q;
  float* wend = ein + Q;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int rank = static_cast<int>(hopper::cluster_rank());
  const int bh = blockIdx.x / cluster;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const float a_h = A[h];
  const T* xb = x + b * st.x_b + h * st.x_h;
  const float* dtb = dt + b * st.dt_b + h * st.dt_h;
  const T* Bb = Bm + b * st.b_b + g * st.b_g;
  const T* Cb = Cm + b * st.c_b + g * st.c_g;
  const long long hoff = static_cast<long long>(bh) * N * P;
  const Run run = chunk_run(rank, per, S);

  for (int e = tid; e < N * P; e += THREADS) Hs[e] = 0.0f;
  if (tid == 0) {                     // h_in arrives as one bulk copy of N * P floats
    hopper::mbar_init(recv_full, 1);
    if (rank > 0) hopper::mbar_expect_tx(recv_full, sizeof(float) * N * P);
    hopper::fence_barrier_init();
  }
  hopper::cluster_arrive();           // waited for before the first copy into a neighbour

  // stage chunk k: dt, the cumsums, dt * x, B and C as fp32
  auto stage = [&](int k) {
    const int c0 = k * Q, rows = min(Q, S - c0);
    __syncthreads();                  // the previous chunk fully consumed
    if (tid < Q) dts[tid] = tid < rows ? dtb[(c0 + tid) * st.dt_s] : 0.0f;
    __syncthreads();
    if (warp == 0) chunk_cumsum<false>(dts, cum, ein, wend, a_h, lane);
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
  };

  // Hs = Hs exp(cum_last) + sum_t wend_t B_t (x) (dt x)_t
  auto state_update = [&]() {
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
      for (int j = 0; j < PJ; ++j) s[i][j] += Hs[(ty + 16 * i) * P + tx + 16 * j] * decay;
    __syncthreads();                  // every read of Hs done
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) Hs[(ty + 16 * i) * P + tx + 16 * j] = s[i][j];
  };

  // y of chunk k = Ss (dt x) + exp(cum) (C Hs), the inter term only when have_h
  auto chunk_y = [&](int k, bool have_h) {
    const int c0 = k * Q, rows = min(Q, S - c0);
    {                                 // Ss[i][j] = (C_i . B_j) exp(cum_i - cum_j), j <= i
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
      for (int kk = 0; kk < N; ++kk) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Cs[(ty + 16 * i) * LDN + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * LDN + kk];
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
    float acc[4][PJ], inter[4][PJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) acc[i][j] = inter[i][j] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < Q; ++kk) {
      float a[4], bv[PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ss[(ty + 16 * i) * LDQ + kk];
#pragma unroll
      for (int j = 0; j < PJ; ++j) bv[j] = Xs[kk * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    if (have_h) {
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
  };

  // 1. this run's state from zero, and its decay
  float decay = 1.0f;
  for (int k = run.k0; k < run.k1; ++k) {
    stage(k);
    state_update();
    decay *= ein[Q - 1];
  }

  // 2. the fold: h_out = h_in decay + local, in place in Rs, then one bulk
  // copy into the next CTA's Rs (the last CTA writes the output)
  hopper::cluster_wait();
  __syncthreads();                    // the local state complete
  if (rank > 0) hopper::mbar_wait_cluster(recv_full, 0);
  const bool last = rank + 1 == cluster;
  for (int e = tid; e < N * P; e += THREADS) {
    const float hin = rank > 0 ? Rs[e] : 0.0f;
    const float o = fmaf(hin, decay, Hs[e]);
    if (last)
      h_out[hoff + e] = o;
    else
      Rs[e] = o;
    Hs[e] = hin;
  }
  if (!last) {
    hopper::fence_proxy_async();      // Rs, before the copy reads it
    __syncthreads();
    if (tid == 0)
      hopper::bulk_copy_to_cluster(hopper::map_shared(Rs, rank + 1), Rs,
                                   sizeof(float) * N * P,
                                   hopper::map_shared(recv_full, rank + 1));
  }

  // 3. y over the run from h_in
  for (int k = run.k0; k < run.k1; ++k) {
    stage(k);
    chunk_y(k, rank > 0 || k > run.k0);
    if (k + 1 < run.k1) state_update();
  }
  hopper::cluster_arrive();
  hopper::cluster_wait();
}

template <typename T, int P, int N>
int launch(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y,
           void* h_out, const Strides& st, int b, int S, int H, int G, int cluster, int per,
           void* stream) {
  constexpr size_t smem = Layout<P, N>::BYTES;
  static bool opted_in = false;     // idempotent, so a benign race
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_fma_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  return launch_clusters(ssd_fma_kernel<T, P, N>, smem, THREADS, cluster, b * H, stream,
                         static_cast<const T*>(x), static_cast<const float*>(dt),
                         static_cast<const float*>(A), static_cast<const T*>(B),
                         static_cast<const T*>(C), static_cast<T*>(y),
                         static_cast<float*>(h_out), st, S, H, G, cluster, per);
}

}  // namespace cores

// ---------------------------------------------------------------------------
// The wgmma path (bf16, P = 64, N = 64 or 128)
// ---------------------------------------------------------------------------
namespace wg {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 128;          // one warpgroup
constexpr int P = 64;
constexpr int BOX = Q * 64;           // one [64 rows][64 columns] bf16 box
constexpr int BOX_BYTES = BOX * 2;
constexpr int LDR = 72;               // row pitch (floats) of the received state: a
                                      // warp's 64-bit accesses hit 32 distinct bank pairs

template <int N>
struct Smem {
  bf16 x[BOX];                        // [t][p], 128-byte swizzle
  bf16 b[N / 64][BOX];                // [t][n], 64 n-columns a box
  bf16 c[N / 64][BOX];
  bf16 h_hi[N * P];                   // [n][p], N / 8 swizzle atoms: the state
  bf16 h_lo[N * P];                   // entering the chunk as a bf16 pair
  float recv[N * LDR];                // [n][p] h_in from the previous CTA, then h_out
  float dts[Q], cum2[Q], ein[Q], wend[Q];
  uint64_t recv_full[4];              // per warp: its rows of h_in have landed
  uint64_t acked;                     // the next CTA has all of h_out
};

template <int N>
constexpr size_t smem_bytes() { return sizeof(Smem<N>) + 1024; }  // + alignment slack

// byte offset of the 16-byte chunk `ch` of row `r` in a 128-byte-swizzled box
__device__ __forceinline__ uint32_t sw128(int r, int ch) {
  return static_cast<uint32_t>(r * 128 + ((ch ^ (r & 7)) << 4));
}

// element (r, col) of a swizzled [rows][64] bf16 box
__device__ __forceinline__ float ld_sw(const bf16* box, int r, int col) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(
      reinterpret_cast<const unsigned char*>(box) + sw128(r, col >> 3) + (col & 7) * 2));
}

// (v0, v1) as two bf16 pairs: hi = v rounded, lo = v - hi rounded
__device__ __forceinline__ void split_pack(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 2^x by the SFU (ex2.approx: relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Accumulator layout of an m64n64 product, per thread: element 4i + 2j + c
// is (row rA + 8j, column 8i + cq + c), rA = 16 warp + lane / 4, cq = 2 (lane
// % 4); an A fragment of the 16-wide step kk holds, in register 2(i % 2) + j,
// the pair of that element's row and columns 16kk + 8(i % 2) + cq + {0, 1}.
// The launch bounds ask registers for three CTAs per SM at N = 64 (~60 KB of
// shared memory each), two at N = 128 (~112 KB).
template <int N>
__global__ void __launch_bounds__(THREADS, (N == 64 ? 3 : 2))
ssd_wgmma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Bm,
                 const bf16* __restrict__ Cm, bf16* __restrict__ y,
                 float* __restrict__ h_out, Strides st, int S, int H, int G, int cluster,
                 int per) {
  using namespace hopper;
  constexpr int NB = N / 64;          // 64-wide boxes of B and C; m64 blocks of the state
  constexpr int NK = N / 16;          // 16-wide steps over N
  constexpr uint32_t ROWS_BYTES = sizeof(float) * 16 * LDR;   // 16 rows of recv
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ unsigned char wg_smem[];
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(align_1024(wg_smem));

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rA = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const int rank = static_cast<int>(cluster_rank());
  const int bh = blockIdx.x / cluster;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const float a_h = A[h];
  const bf16* xb = x + b * st.x_b + h * st.x_h;
  const float* dtb = dt + b * st.dt_b + h * st.dt_h;
  const bf16* Bb = Bm + b * st.b_b + g * st.b_g;
  const bf16* Cb = Cm + b * st.c_b + g * st.c_g;
  const Run run = chunk_run(rank, per, S);

  if (tid == 0) {                     // h_in arrives as NB bulk copies a warp
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      mbar_init(&sm.recv_full[w], 1);
      if (rank > 0) mbar_expect_tx(&sm.recv_full[w], NB * ROWS_BYTES);
    }
    mbar_init(&sm.acked, 4);
    fence_barrier_init();
  }
  cluster_arrive();                   // waited for before the first copy into a neighbour

  // the state, [n][p] over NB m64 blocks: this run's from zero in phase 1,
  // then the state entering each chunk in phase 3
  float hs[NB][32];
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) hs[m][i] = 0.0f;

  // stage chunk k: x, B (and C when with_c: phase 1 does not read it) by
  // cp.async into the swizzled boxes, dt by 4-byte cp.async; then the cumsums
  // of dt * A, kept as cum * log2(e) for the SFU's 2^x
  auto stage = [&](int k, bool with_c) {
    const int c0 = k * Q, rows = min(Q, S - c0);
    __syncthreads();                  // the previous chunk fully consumed
    for (int e = tid; e < Q * 8; e += THREADS) {
      const int r = e >> 3, ch = e & 7;
      const bool live = r < rows;
      cp_async16(reinterpret_cast<unsigned char*>(sm.x) + sw128(r, ch),
                 live ? xb + (c0 + r) * st.x_s + ch * 8 : xb, live ? 16u : 0u);
    }
    for (int e = tid; e < Q * (N / 8); e += THREADS) {
      const int r = e / (N / 8), cc = e % (N / 8);
      const bool live = r < rows;
      const uint32_t off = sw128(r, cc & 7);
      cp_async16(reinterpret_cast<unsigned char*>(sm.b[cc >> 3]) + off,
                 live ? Bb + (c0 + r) * st.b_s + cc * 8 : Bb, live ? 16u : 0u);
      if (with_c)
        cp_async16(reinterpret_cast<unsigned char*>(sm.c[cc >> 3]) + off,
                   live ? Cb + (c0 + r) * st.c_s + cc * 8 : Cb, live ? 16u : 0u);
    }
    if (tid < Q)
      cp_async4(&sm.dts[tid], tid < rows ? dtb + (c0 + tid) * st.dt_s : dtb,
                tid < rows ? 4u : 0u);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();              // the copies, before wgmma reads them
    __syncthreads();
    if (warp == 0) {
      chunk_cumsum<true>(sm.dts, sm.cum2, sm.ein, sm.wend, a_h, lane);
      sm.cum2[2 * lane] *= LOG2E;
      sm.cum2[2 * lane + 1] *= LOG2E;
    }
    __syncthreads();
  };

  // hs = hs exp(cum_last) + W^T x, W[t][n] = B[t][n] wend[t] as a hi/lo pair
  auto state_update = [&]() {
    const float a = sm.ein[Q - 1];
#pragma unroll
    for (int m = 0; m < NB; ++m) {
#pragma unroll
      for (int i = 0; i < 32; ++i) hs[m][i] *= a;
      uint32_t whi[4][4], wlo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = rA + 8 * (q & 1);                // within box m
          const int t = 16 * kk + 8 * (q >> 1) + cq;
          split_pack(ld_sw(sm.b[m], t, n) * sm.wend[t],
                     ld_sw(sm.b[m], t + 1, n) * sm.wend[t + 1], whi[kk][q], wlo[kk][q]);
        }
      fence_regs(hs[m]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = desc_sw128(sm.x + kk * 16 * 64, BOX_BYTES, 1024);
        wgmma_rs_n64<1>(hs[m], whi[kk], db, 1);
        wgmma_rs_n64<1>(hs[m], wlo[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();                // before the fragments' registers are reused
      fence_regs(hs[m]);
    }
  };

  // y of chunk k: exp(cum) (C h) when have_h, plus (C B^T . L . dt) x
  auto chunk_y = [&](int k, bool have_h) {
    const int c0 = k * Q, rows = min(Q, S - c0);
    float yacc[32], sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) yacc[i] = sc[i] = 0.0f;
    if (have_h) {                     // h as the B operand [n][p], a hi/lo pair
#pragma unroll
      for (int m = 0; m < NB; ++m)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = 64 * m + rA + 8 * j;
            uint32_t hi, lo;
            split_pack(hs[m][4 * i + 2 * j], hs[m][4 * i + 2 * j + 1], hi, lo);
            const uint32_t off = sw128(n, i) + cq * 2;
            *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(sm.h_hi) + off) = hi;
            *reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(sm.h_lo) + off) = lo;
          }
      fence_proxy_async();
      __syncthreads();
    }
    fence_regs(yacc);
    fence_regs(sc);
    wgmma_fence();
    if (have_h) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const uint64_t da = desc_sw128(sm.c[kk / 4] + (kk % 4) * 16, 16, 1024);
        wgmma_ss_n64<1>(yacc, da, desc_sw128(sm.h_hi + kk * 16 * 64, BOX_BYTES, 1024), 1);
        wgmma_ss_n64<1>(yacc, da, desc_sw128(sm.h_lo + kk * 16 * 64, BOX_BYTES, 1024), 1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)   // S = C B^T, both K-major
      wgmma_ss_n64<0>(sc, desc_sw128(sm.c[kk / 4] + (kk % 4) * 16, 16, 1024),
                      desc_sw128(sm.b[kk / 4] + (kk % 4) * 16, 16, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(yacc);
    fence_regs(sc);

    float cs2[16], ds[16];            // this thread's columns 8i + cq + c
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        cs2[2 * i + c] = sm.cum2[8 * i + cq + c];
        ds[2 * i + c] = sm.dts[8 * i + cq + c];
      }
    uint32_t mhi[4][4], mlo[4][4];    // M = S . L . dt_s, zero above the diagonal
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = rA + 8 * j;
      const float ct = sm.cum2[t], et = sm.ein[t];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        yacc[4 * i + 2 * j] *= et;
        yacc[4 * i + 2 * j + 1] *= et;
        float m2[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * i + cq + c;
          m2[c] = col <= t ? sc[4 * i + 2 * j + c] * ex2(ct - cs2[2 * i + c]) * ds[2 * i + c]
                           : 0.0f;
        }
        split_pack(m2[0], m2[1], mhi[i / 2][(i % 2) * 2 + j], mlo[i / 2][(i % 2) * 2 + j]);
      }
    }
    fence_regs(yacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // y += M x, x the MN-major B operand
      const uint64_t db = desc_sw128(sm.x + kk * 16 * 64, BOX_BYTES, 1024);
      wgmma_rs_n64<1>(yacc, mhi[kk], db, 1);
      wgmma_rs_n64<1>(yacc, mlo[kk], db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(yacc);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = rA + 8 * j;
      if (t >= rows) continue;
      bf16* yrow = y + ((static_cast<long long>(b) * S + c0 + t) * H + h) * P + cq;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<uint32_t*>(yrow + 8 * i) =
            pack_bf16(yacc[4 * i + 2 * j], yacc[4 * i + 2 * j + 1]);
    }
  };

  // 2. the fold, one chain per warp over its own rows of the state: h_out =
  // h_in decay + local, in place in recv, then the warp's bulk copies into
  // the next CTA's recv, completing on that warp's mbarrier there (the last
  // CTA writes the output); each warp then tells the previous CTA that its
  // rows have landed
  const bool last = rank + 1 == cluster;
  auto fold = [&](float decay) {
    cluster_wait();
    if (rank > 0) mbar_wait_cluster(&sm.recv_full[warp], 0);
    float* hrow = h_out + static_cast<long long>(bh) * N * P;
#pragma unroll
    for (int m = 0; m < NB; ++m)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = 64 * m + rA + 8 * j, p = 8 * i + cq;
          float2* slot = reinterpret_cast<float2*>(&sm.recv[n * LDR + p]);
          const float2 hin = rank > 0 ? *slot : make_float2(0.0f, 0.0f);
          const float2 o = make_float2(fmaf(hin.x, decay, hs[m][4 * i + 2 * j]),
                                       fmaf(hin.y, decay, hs[m][4 * i + 2 * j + 1]));
          if (last)
            *reinterpret_cast<float2*>(hrow + n * P + p) = o;
          else
            *slot = o;
          hs[m][4 * i + 2 * j] = hin.x;
          hs[m][4 * i + 2 * j + 1] = hin.y;
        }
    if (!last) {
      fence_proxy_async();            // the warp's rows, before the copy reads them
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int m = 0; m < NB; ++m) {
          const float* rows = &sm.recv[(64 * m + 16 * warp) * LDR];
          bulk_copy_to_cluster(map_shared(rows, rank + 1), rows, ROWS_BYTES,
                               map_shared(&sm.recv_full[warp], rank + 1));
        }
      }
    }
    if (rank > 0 && lane == 0) mbar_arrive_cluster(map_shared(&sm.acked, rank - 1));
  };

  // 1. the run's state from zero, chunk by chunk
  float decay = 1.0f;
  for (int k = run.k0; k < run.k1; ++k) {
    stage(k, false);
    state_update();
    decay *= sm.ein[Q - 1];
  }
  // 2. the fold
  fold(decay);
  // 3. the run again: each chunk's y from the state entering it, then that
  // state carried on
  for (int k = run.k0; k < run.k1; ++k) {
    stage(k, true);
    chunk_y(k, rank > 0 || k > run.k0);
    if (k + 1 < run.k1) state_update();
  }
  if (!last) mbar_wait_cluster(&sm.acked, 0);   // recv stays until the copies have landed
}

template <int N>
int launch(const void* x, const void* dt, const void* A, const void* B, const void* C, void* y,
           void* h_out, const Strides& st, int b, int S, int H, int G, int cluster, int per,
           void* stream) {
  constexpr size_t smem = smem_bytes<N>();
  static bool opted_in = false;     // idempotent, so a benign race
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_wgmma_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  return launch_clusters(ssd_wgmma_kernel<N>, smem, THREADS, cluster, b * H, stream,
                         static_cast<const bf16*>(x), static_cast<const float*>(dt),
                         static_cast<const float*>(A), static_cast<const bf16*>(B),
                         static_cast<const bf16*>(C), static_cast<bf16*>(y),
                         static_cast<float*>(h_out), st, S, H, G, cluster, per);
}

}  // namespace wg

bool valid(int H, int G, int cluster, int per) {
  return G > 0 && H % G == 0 && cluster >= 1 && cluster <= 8 && per >= 1;
}

Strides strides_of(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
}

}  // namespace

// x [b, S, H, P], B/C [b, S, G, N] in the kernel's dtype and dt [b, S, H]
// fp32, with the given element strides (x: batch, row, head; dt: batch, row,
// head; B and C: batch, row, group; the last dims contiguous, rows 16-byte
// aligned); A [H] fp32; y [b, S, H, P] and h_out [b, H, N, P] (fp32)
// contiguous.  `cluster` CTAs per (b, h), each `per` chunks of 64 rows.
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* B,
                            const void* C, void* y, void* h_out, const long long* strides,
                            int b, int S, int H, int G, int P, int N, int cluster, int per,
                            void* stream) {
  if (!valid(H, G, cluster, per)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st = strides_of(strides);
  if (P == 64 && N == 64)
    return cores::launch<float, 64, 64>(x, dt, A, B, C, y, h_out, st, b, S, H, G, cluster, per,
                                      stream);
  if (P == 64 && N == 128)
    return cores::launch<float, 64, 128>(x, dt, A, B, C, y, h_out, st, b, S, H, G, cluster, per,
                                       stream);
  if (P == 16 && N == 16)
    return cores::launch<float, 16, 16>(x, dt, A, B, C, y, h_out, st, b, S, H, G, cluster, per,
                                      stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 at P = N = 16 (the smoke configs); bf16 at P = 64 takes the wgmma entry
extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A, const void* B,
                             const void* C, void* y, void* h_out, const long long* strides,
                             int b, int S, int H, int G, int P, int N, int cluster, int per,
                             void* stream) {
  if (!valid(H, G, cluster, per) || P != 16 || N != 16)
    return static_cast<int>(cudaErrorInvalidValue);
  return cores::launch<__nv_bfloat16, 16, 16>(x, dt, A, B, C, y, h_out, strides_of(strides), b,
                                            S, H, G, cluster, per, stream);
}

// The tensor-core path: bf16 at P = 64, N = 64 or 128; the same arguments.
extern "C" int ssd_scan_bf16_wgmma(const void* x, const void* dt, const void* A, const void* B,
                                   const void* C, void* y, void* h_out,
                                   const long long* strides, int b, int S, int H, int G, int P,
                                   int N, int cluster, int per, void* stream) {
  if (!valid(H, G, cluster, per) || P != 64) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st = strides_of(strides);
  if (N == 64)
    return wg::launch<64>(x, dt, A, B, C, y, h_out, st, b, S, H, G, cluster, per, stream);
  if (N == 128)
    return wg::launch<128>(x, dt, A, B, C, y, h_out, st, b, S, H, G, cluster, per, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
