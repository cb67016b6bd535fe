// flash_decode: one-token GQA attention against a KV cache, on Hopper.
//
// Replaces: src/repro/kernels/flash_decode/flash_decode.py, _decode_kernel
// (the Pallas kernel: grid (batch*kv_heads, cache block) with the cache axis
// sequential; the online-softmax state of the group's r query rows in VMEM
// scratch; kv_len masks the tail).  On the card the cache axis becomes a loop
// inside the block.
//
// What it computes, for every sequence b and kv head kh: the r query heads
// h = kh*r + g attend over the first kv_len[b] cache rows.  Exactly the Pallas
// kernel's arithmetic: fp32 scores times 1/sqrt(d); rows at or past kv_len
// score the finite -1e30; online softmax per query row over tiles of 64 rows;
// p rounded to v's dtype before the PV product; fp32 accumulators; out =
// acc / max(l, 1e-30) in q's dtype.
//
// The loop stops after the tile that holds row kv_len - 1: later tiles are
// wholly masked, and for a row that has met a valid key they give alpha = 1
// and p = 0, so stopping equals the reference's tail mask.  kv_len = 0 is the
// exception: every score is the same -1e30, the reference's softmax is
// uniform and its output the mean of all S value rows, so then the loop runs
// over the whole cache.  Cache rows past S (the ragged last tile) score -inf
// and contribute exactly nothing.
//
// Bound on the card: bytes.  Each step reads the kv_len[b] live rows of K and
// V once (2 * kv_len * d elements per kv head) for 4 * r * d flops a row.
// Design: one CTA of 128 threads per (b, kv head), which is B*K CTAs — 32 at
// the serve path's decode (4 sequences x 8 kv heads) on 132 SMs, so most SMs
// idle; splitting the cache across CTAs with a combine pass (flash-decoding)
// is later work.  The r query rows sit in shared memory in fp32; K and V are
// staged a 64-row tile at a time with 16-byte loads, several in flight per
// thread (K rows padded one word so the 64 threads reading 64 different rows
// hit different banks).  Scores go to a small
// shared tile, one warp per query row reduces max and sum with shuffles, and
// each thread then owns (query row, output column) pairs of the fp32
// accumulator in registers.  Shared memory can exceed 48 KB (d = 256), so
// the launch opts in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 64;      // cache rows per tile
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int RMAX = 16;      // largest query group (H / K) supported
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

struct Strides {              // in elements: batch, cache row, kv head
  long long k_b, k_s, k_h, v_b, v_s, v_h;
};

// Copy rows [row0, row0 + ROWS) of a [*, D] operand (row stride `stride`, in
// elements) into shared memory with row pitch LDS; rows at or past `n_rows`
// become zeros.  16-byte global loads, up to eight in flight per thread
// before any is stored (a scalar loop waits out one load latency per
// element); stores are 32-bit, as padded rows are only word aligned.  The
// launcher checks that rows are 16-byte aligned.  The tile's vectors need not
// divide evenly among the threads (d = 80: ten vectors a bf16 row): the last
// pass is then partial, its surplus lanes load and store nothing; where they
// do divide (EVEN) the guard compiles away.
template <typename T, int D, int ROWS, int LDS>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long stride,
                                           int row0, int n_rows, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  constexpr int TOTAL = ROWS * PER_ROW;                  // vectors in the tile
  constexpr int PER_THREAD = (TOTAL + THREADS - 1) / THREADS;
  constexpr int BATCH = PER_THREAD < 8 ? PER_THREAD : 8;
  constexpr bool EVEN = TOTAL % THREADS == 0 && PER_THREAD % BATCH == 0;
  static_assert(D % VEC == 0, "rows are whole 16-byte vectors");
#pragma unroll
  for (int i0 = 0; i0 < PER_THREAD; i0 += BATCH) {
    uint4 buf[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int e = tid + (i0 + i) * THREADS;
      const int j = e / PER_ROW, c = (e % PER_ROW) * VEC;
      buf[i] = (EVEN || e < TOTAL) && j < n_rows
                   ? *reinterpret_cast<const uint4*>(src + (row0 + j) * stride + c)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int e = tid + (i0 + i) * THREADS;
      if (!EVEN && e >= TOTAL) continue;                 // the partial last pass
      const int j = e / PER_ROW, c = (e % PER_ROW) * VEC;
      unsigned int* d = reinterpret_cast<unsigned int*>(dst + j * LDS + c);
      d[0] = buf[i].x;
      d[1] = buf[i].y;
      d[2] = buf[i].z;
      d[3] = buf[i].w;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    T* __restrict__ o, Strides st, int S, int H, int K, int r,
                    float scale) {
  constexpr int PAD = 4 / sizeof(T);
  constexpr int LD = D + PAD;
  constexpr int NACC = RMAX * D / THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + TILE * LD;
  float* Qs = reinterpret_cast<float*>(Vs + TILE * D);   // [r][D]
  float* Ps = Qs + r * D;                                 // [r][TILE]
  float* alpha_s = Ps + r * TILE;                         // [r]
  float* l_s = alpha_s + r;                               // [r]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / K, kh = blockIdx.x % K;
  const T* qg = q + (static_cast<long long>(b) * H + kh * r) * D;
  const T* kb = k + b * st.k_b + kh * st.k_h;
  const T* vb = v + b * st.v_b + kh * st.v_h;

  for (int e = tid; e < r * D; e += THREADS) Qs[e] = to_f32(qg[e]);

  const int len = kv_len[b];
  const int live = len > 0 ? min(len, S) : S;   // kv_len = 0: the whole cache
  const int n_tiles = (live + TILE - 1) / TILE;

  float m_row[RMAX / WARPS], l_row[RMAX / WARPS];   // rows warp, warp + WARPS, ...
#pragma unroll
  for (int i = 0; i < RMAX / WARPS; ++i) { m_row[i] = NEG_INF; l_row[i] = 0.0f; }
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * TILE;
    __syncthreads();                  // previous tile fully consumed
    stage_rows<T, D, TILE, LD>(Ks, kb, st.k_s, k0, S - k0, tid);
    stage_rows<T, D, TILE, D>(Vs, vb, st.v_s, k0, S - k0, tid);
    __syncthreads();

    // scores: thread -> cache row j, query rows g = tid / TILE, + 2, ...
    {
      const int j = tid % TILE;
      const int pos = k0 + j;
      for (int g = tid / TILE; g < r; g += THREADS / TILE) {
        float s = 0.0f;
        const float* qrow = Qs + g * D;
        const T* krow = Ks + j * LD;
#pragma unroll 8
        for (int c = 0; c < D; ++c) s = fmaf(qrow[c], to_f32(krow[c]), s);
        Ps[g * TILE + j] = pos >= S ? -INFINITY : (pos < len ? s * scale : NEG_INF);
      }
    }
    __syncthreads();

    // online softmax: one warp per query row
#pragma unroll
    for (int i = 0; i < RMAX / WARPS; ++i) {
      const int g = warp + i * WARPS;
      if (g < r) {
        float* prow = Ps + g * TILE;
        const float x0 = prow[lane], x1 = prow[lane + 32];
        float mx = fmaxf(x0, x1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_row[i], mx);
        const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
        float sum = p0 + p1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const float alpha = expf(m_row[i] - m_new);
        l_row[i] = l_row[i] * alpha + sum;
        m_row[i] = m_new;
        prow[lane] = round_to<T>(p0);
        prow[lane + 32] = round_to<T>(p1);
        if (lane == 0) alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc[g][c] = acc * alpha[g] + sum_j p[g][j] * v[j][c]
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int e = tid + i * THREADS;
      if (e < r * D) {
        const int g = e / D, c = e % D;
        const float* prow = Ps + g * TILE;
        float a = acc[i] * alpha_s[g];
#pragma unroll 8
        for (int j = 0; j < TILE; ++j) a = fmaf(prow[j], to_f32(Vs[j * D + c]), a);
        acc[i] = a;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RMAX / WARPS; ++i) {
    const int g = warp + i * WARPS;
    if (g < r && lane == 0) l_s[g] = l_row[i];
  }
  __syncthreads();
  T* og = o + (static_cast<long long>(b) * H + kh * r) * D;
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int e = tid + i * THREADS;
    if (e < r * D) og[e] = from_f32<T>(acc[i] / fmaxf(l_s[e / D], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* o, const Strides& st, int B, int S, int H, int K, void* stream) {
  constexpr int LD = D + 4 / sizeof(T);
  const int r = H / K;
  const size_t smem = sizeof(T) * (static_cast<size_t>(TILE) * LD + TILE * D)
                      + sizeof(float) * (static_cast<size_t>(RMAX) * D + RMAX * TILE + 2 * RMAX);
  static bool opted_in = false;     // idempotent, so a benign race
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  flash_decode_kernel<T, D><<<B * K, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_len), static_cast<T*>(o), st, S, H, K, r,
      1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* kv_len,
             void* o, const long long* strides, int B, int S, int H, int K, int d,
             void* stream) {
  if (K <= 0 || H % K != 0 || H / K > RMAX) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4], strides[5]};
  switch (d) {
    case 64: return launch<T, 64>(q, k, v, kv_len, o, st, B, S, H, K, stream);
    case 80: return launch<T, 80>(q, k, v, kv_len, o, st, B, S, H, K, stream);
    case 128: return launch<T, 128>(q, k, v, kv_len, o, st, B, S, H, K, stream);
    case 256: return launch<T, 256>(q, k, v, kv_len, o, st, B, S, H, K, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, H, d] contiguous; k/v [B, S, K, d] with the given element strides
// (batch, cache row, kv head; the last dim contiguous); kv_len [B] int32;
// o [B, H, d] contiguous.
extern "C" int flash_decode_f32(const void* q, const void* k, const void* v,
                                const void* kv_len, void* o, const long long* strides,
                                int B, int S, int H, int K, int d, void* stream) {
  return dispatch<float>(q, k, v, kv_len, o, strides, B, S, H, K, d, stream);
}

extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* kv_len, void* o, const long long* strides,
                                 int B, int S, int H, int K, int d, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, kv_len, o, strides, B, S, H, K, d, stream);
}
