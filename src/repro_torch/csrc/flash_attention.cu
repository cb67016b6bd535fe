// flash_attention: causal / sliding-window GQA attention forward, on Hopper.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py, _flash_kernel
// (the Pallas kernel: grid (batch*kv_heads, group row, q block, kv block) with
// the kv axis sequential and the online-softmax state (acc, m, l) in VMEM
// scratch).  On the card the kv axis becomes a loop inside the block, and the
// state lives in registers.
//
// What it computes, for every (batch b, query head h = kv_head * r + g, query
// row i): the softmax over the keys j that are valid for i (j < Skv; j <= i
// when causal; i - j < window when window > 0) of the scaled scores q_i . k_j,
// applied to v.  Exactly the Pallas kernel's arithmetic:
//   * scores in fp32 from the inputs' values, then times 1/sqrt(d);
//   * a masked score is the finite -1e30 (not -inf);
//   * online softmax per row over tiles of keys: m' = max(m, rowmax s),
//     p = exp(s - m'), alpha = exp(m - m'), l' = l*alpha + rowsum p;
//   * p is rounded to v's dtype before the PV product; acc is fp32;
//   * out = acc / max(l, 1e-30), written in q's dtype.
//
// Bound on the card: at the serve path's prefill (4 sequences x 24 heads,
// 512 causal rows, d = 128, bf16) the unmasked work is 2*Sq^2*d flops per
// head, 6.4 GFLOP in all, on 34 MB of q, k, v and o: about 6 us at the bf16
// tensor-core rate and 10 us at the memory rate, so the roofs are close.
// This first kernel is the simple, exact one: CUDA-core fp32 FMAs out of
// shared memory, no tensor cores (wgmma), no TMA, so it runs far from
// either roof; those are later work.
//
// Design: one CTA per (b, query head, 64-row query tile); 256 threads, four
// per query row, each owning 16 of a tile's 64 key columns for the scores
// and d/4 of the output columns for the accumulator.  The Q tile is staged in
// shared memory once; K and V a 64-key tile at a time, with 16-byte loads,
// several in flight per thread.  Rows are
// padded by one 32-bit word so that threads reading different rows hit
// different banks.  The row max and row sum are reduced across the row's four
// threads with warp shuffles, and p reaches the PV product by shuffle too, so
// the score tile never goes to shared memory.  Tiles wholly above the causal
// diagonal or wholly outside the window are skipped: for a row that has met a
// valid key such a tile gives alpha = 1 and p = 0, and a tile before a row's
// first valid key is erased by the first valid tile (alpha = exp(-1e30 - m) =
// 0), so the result is that of visiting every tile.  Keys past Skv (the
// ragged last tile) score -inf and contribute exactly nothing; query rows
// past Sq (ragged Sq) are computed on zeros and not stored.  Shared memory
// exceeds 48 KB for d = 128 (bf16) and above, so the launch opts in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 256;  // four threads per query row
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// p rounded to v's dtype (the Pallas kernel's p.astype(v.dtype))
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

struct Strides {              // in elements: batch, sequence, head
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h;
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
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, Strides st,
                       int Sq, int Skv, int H, int r, int causal, int window,
                       float scale) {
  constexpr int PAD = 4 / sizeof(T);  // one 32-bit word per row
  constexpr int LD = D + PAD;
  constexpr int NC = BKV / 4;         // score columns per thread
  constexpr int NO = D / 4;           // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BQ * LD;
  T* Vs = Ks + BKV * LD;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = tid >> 2;           // query row within the tile
  const int cq = tid & 3;             // this thread's quarter of the row
  const int bh = blockIdx.x;          // b * H + h
  const int b = bh / H, h = bh % H;
  const int kh = h / r;
  const int q0 = blockIdx.y * BQ;
  const int q_pos = q0 + row;

  const T* qb = q + b * st.q_b + h * st.q_h;
  const T* kb = k + b * st.k_b + kh * st.k_h;
  const T* vb = v + b * st.v_b + kh * st.v_h;

  stage_rows<T, D, BQ, LD>(Qs, qb, st.q_s, q0, Sq - q0, tid);

  // keys any row of this tile can attend: [k_lo, k_hi)
  const int q_last = min(q0 + BQ, Sq) - 1;
  int k_lo = 0, k_hi = Skv;
  if (causal) k_hi = min(Skv, q_last + 1);
  if (window > 0) k_lo = max(0, q0 - window + 1);

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.0f;
  float m = NEG_INF, l = 0.0f;

  for (int k0 = (k_lo / BKV) * BKV; k0 < k_hi; k0 += BKV) {
    __syncthreads();                  // previous tile fully consumed
    stage_rows<T, D, BKV, LD>(Ks, kb, st.k_s, k0, Skv - k0, tid);
    stage_rows<T, D, BKV, D>(Vs, vb, st.v_s, k0, Skv - k0, tid);
    __syncthreads();

    float s[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) s[j] = 0.0f;
    for (int c = 0; c < D; ++c) {
      const float qv = to_f32(Qs[row * LD + c]);
#pragma unroll
      for (int j = 0; j < NC; ++j)
        s[j] = fmaf(qv, to_f32(Ks[(cq + 4 * j) * LD + c]), s[j]);
    }

    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int k_pos = k0 + cq + 4 * j;
      float x;
      if (k_pos >= Skv) {
        x = -INFINITY;                // no such key
      } else {
        bool valid = true;
        if (causal) valid = valid && q_pos >= k_pos;
        if (window > 0) valid = valid && (q_pos - k_pos < window);
        x = valid ? s[j] * scale : NEG_INF;
      }
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float p = expf(s[j] - m_new);
      sum += p;
      s[j] = round_to<T>(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * alpha + sum;
    m = m_new;

#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] *= alpha;
    const int base = lane & ~3;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
#pragma unroll
      for (int src = 0; src < 4; ++src) {
        // key column 4j + src lives in s[j] of the row's thread `src`
        const float p = __shfl_sync(0xffffffffu, s[j], base + src);
        const T* vrow = Vs + (4 * j + src) * D + cq;
#pragma unroll
        for (int i = 0; i < NO; ++i) acc[i] = fmaf(p, to_f32(vrow[4 * i]), acc[i]);
      }
    }
  }

  if (q_pos < Sq) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * Sq + q_pos) * H + h) * D + cq;
#pragma unroll
    for (int i = 0; i < NO; ++i) orow[4 * i] = from_f32<T>(acc[i] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides& st, int B, int Sq, int Skv, int H, int K, int causal,
           int window, void* stream) {
  constexpr int LD = D + 4 / sizeof(T);
  const size_t smem = sizeof(T) * (static_cast<size_t>(BQ) * LD + BKV * LD + BKV * D);
  static bool opted_in = false;     // idempotent, so a benign race
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_attention_kernel<T, D><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), st, Sq, Skv, H, H / K, causal, window,
      1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const long long* strides, int B, int Sq, int Skv, int H, int K,
             int d, int causal, int window, void* stream) {
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5], strides[6], strides[7], strides[8]};
  switch (d) {
    case 64: return launch<T, 64>(q, k, v, o, st, B, Sq, Skv, H, K, causal, window, stream);
    case 80: return launch<T, 80>(q, k, v, o, st, B, Sq, Skv, H, K, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, st, B, Sq, Skv, H, K, causal, window, stream);
    case 256: return launch<T, 256>(q, k, v, o, st, B, Sq, Skv, H, K, causal, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, Sq, H, d], k/v [B, Skv, K, d] with the given element strides (batch,
// sequence, head; the last dim contiguous); o [B, Sq, H, d] contiguous.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, const long long* strides, int B,
                                   int Sq, int Skv, int H, int K, int d,
                                   int causal, int window, void* stream) {
  return dispatch<float>(q, k, v, o, strides, B, Sq, Skv, H, K, d, causal, window, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, const long long* strides, int B,
                                    int Sq, int Skv, int H, int K, int d,
                                    int causal, int window, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, strides, B, Sq, Skv, H, K, d, causal,
                                 window, stream);
}
