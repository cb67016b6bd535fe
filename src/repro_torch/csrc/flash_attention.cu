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
// tensor-core rate and 10 us at the memory rate, so the roofs are close and
// only wgmma (the tensor cores) can approach them.
//
// Two paths, chosen by the launcher (flash_attention.py, attention_path):
//
// 1. wgmma (bf16 at d = 64, 80, 128): one CTA of three warpgroups per
//    (b, query head, 128-row query tile).  Warpgroups 0 and 1 each own 64
//    query rows; one thread of warpgroup 2 issues every copy.  Q is loaded
//    once by TMA; K and V pass through a ring of two stages of 64 keys,
//    each loaded by TMA (4-D tensor maps over the model layout [B, S, H, d]
//    with its strides, so q, k, v are read in place, fused-projection views
//    included) into the 128-byte-swizzled layout wgmma reads, completing on
//    per-stage mbarriers (K and V apart, so QK^T starts before V lands);
//    the consumers release a stage on an "empty" mbarrier.  S = Q K^T is a
//    wgmma with both operands in shared memory (K-major); the fp32 scores
//    stay in registers, where the row max and sum are reduced within the
//    accumulator's quad of threads; p is rounded to bf16 straight into the
//    A-operand registers of P V, whose B operand is V in shared memory,
//    MN-major (d contiguous: the descriptor's transpose bit).  A row of
//    d = 80 is 160 bytes, not a multiple of the 128-byte swizzle atom: it
//    is loaded as two 64-column boxes, the second reading columns 64..127
//    of which the tensor map's bounds zero all past 80; QK^T then runs five
//    16-wide steps (the zeros are never multiplied) and PV an N = 80
//    product that reads the second box's first 16 columns.  Ragged Sq and
//    Skv: rows past the bounds read as zeros; keys past Skv score -inf,
//    query rows past Sq are not stored.
// 2. CUDA cores (fp32 at every d; bf16 at d = 256, whose 128 accumulator
//    registers a thread per 64 rows leave no room for the rest without
//    spilling): the first, simple kernel, described next.
//
// CUDA-core design: one CTA per (b, query head, 64-row query tile); 256
// threads, four per query row, each owning 16 of a tile's 64 key columns for
// the scores and d/4 of the output columns for the accumulator.  The Q tile
// is staged in shared memory once; K and V a 64-key tile at a time, with
// 16-byte loads, several in flight per thread.  Rows are padded by one
// 32-bit word so that threads reading different rows hit
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

#include "hopper.cuh"

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


// ---------------------------------------------------------------------------
// The wgmma path (bf16, d = 64, 80, 128)
// ---------------------------------------------------------------------------
namespace wg {

using bf16 = __nv_bfloat16;
constexpr int BQ = 128;              // query rows per CTA: two warpgroups of 64
constexpr int BKV = 64;              // keys per stage
constexpr int STAGES = 2;
constexpr int THREADS = 384;         // warpgroups 0, 1 consume; 2 produces
constexpr int CONSUMERS = 256;
constexpr int BOX = 64 * 64;         // one [64 rows][64 columns] TMA box
constexpr int BOX_BYTES = BOX * 2;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int NH = (D + 63) / 64;  // 64-column boxes a row
  bf16 q[2][NH][BOX];                       // [warpgroup][box]
  bf16 k[STAGES][NH][BOX];
  bf16 v[STAGES][NH][BOX];
  uint64_t q_full, k_full[STAGES], v_full[STAGES], empty[STAGES];
};

template <int D>
constexpr size_t smem_bytes() { return sizeof(Smem<D>) + 1024; }  // + alignment slack

// the P V product at N = D, P from registers
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
  hopper::wgmma_rs_n64<1>(o, a, db, 1);
}
template <>
__device__ __forceinline__ void pv<80>(float (&o)[40], const uint32_t (&a)[4], uint64_t db) {
  hopper::wgmma_rs_n80<1>(o, a, db, 1);
}
template <>
__device__ __forceinline__ void pv<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t db) {
  hopper::wgmma_rs_n128<1>(o, a, db, 1);
}

// q [B, Sq, H, D], k/v [B, Skv, K, D] through their tensor maps (dims D, S,
// heads, B); o [B, Sq, H, D] contiguous.  blockIdx.x = b * H + h; blockIdx.y
// counts query tiles from the last (the longest causal work first).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
                             int Sq, int Skv, int H, int r, int causal, int window,
                             float scale_log2) {
  using namespace hopper;
  constexpr int NH = Smem<D>::NH;
  constexpr int KSTEPS = D / 16;    // 16-wide steps of Q K^T (d = 80: five)
  constexpr int NO = D / 2;         // O accumulator floats a thread
  extern __shared__ unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(align_1024(smem_raw));

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, kh = h / r;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;

  // keys any row of this tile can attend: tiles t0 .. t0 + n_tiles - 1
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_hi = causal ? min(Skv, q_last + 1) : Skv;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t0 = k_lo / BKV;
  const int n_tiles = k_hi > t0 * BKV ? (k_hi - t0 * BKV + BKV - 1) / BKV : 0;
  const int q_boxes = q0 + 64 < Sq ? 2 : 1;   // warpgroups with a row inside Sq

  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer: one thread issues every TMA load ----
    if (tid == CONSUMERS) {
      mbar_expect_tx(&sm.q_full, q_boxes * NH * BOX_BYTES);
      for (int w = 0; w < q_boxes; ++w)
#pragma unroll
        for (int c = 0; c < NH; ++c)
          tma_load_4d(sm.q[w][c], &qmap, &sm.q_full, 64 * c, q0 + 64 * w, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&sm.empty[s], ((it / STAGES) - 1) & 1);
        const int k0 = (t0 + it) * BKV;
        mbar_expect_tx(&sm.k_full[s], NH * BOX_BYTES);
#pragma unroll
        for (int c = 0; c < NH; ++c)
          tma_load_4d(sm.k[s][c], &kmap, &sm.k_full[s], 64 * c, k0, kh, b);
        mbar_expect_tx(&sm.v_full[s], NH * BOX_BYTES);
#pragma unroll
        for (int c = 0; c < NH; ++c)
          tma_load_4d(sm.v[s][c], &vmap, &sm.v_full[s], 64 * c, k0, kh, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns query rows row0 .. row0 + 63 ----
  const int w = tid / 128;
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int row0 = q0 + 64 * w;
  const int rA = row0 + 16 * warp + lane / 4;   // this thread's rows rA, rA + 8
  const int cq = 2 * (lane % 4);                // its first column in each 8-wide block
  const bool wg_live = row0 < Sq;
  const int wg_last = min(row0 + 63, Sq - 1);

  float oacc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) oacc[i] = 0.0f;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.0f, 0.0f};

  if (wg_live) mbar_wait(&sm.q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t ph = (it / STAGES) & 1;
    const int k0 = (t0 + it) * BKV;
    // does any key of this tile count for any row of this warpgroup?
    const bool live = wg_live && !(causal && k0 > wg_last) &&
                      !(window > 0 && k0 + BKV - 1 <= row0 - window);
    mbar_wait(&sm.k_full[s], ph);
    if (live) {
      // S = Q K^T, 64 x 64, both operands K-major in shared memory
      float sacc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[i] = 0.0f;
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint64_t da = desc_sw128(sm.q[w][kk / 4] + (kk % 4) * 16, 16, 1024);
        const uint64_t db = desc_sw128(sm.k[s][kk / 4] + (kk % 4) * 16, 16, 1024);
        wgmma_ss_n64<0>(sacc, da, db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);

      // masks and the online softmax in the log2 domain: sacc[4i + 2j + c]
      // is (row rA + 8j, key k0 + 8i + cq + c)
      const bool full = k0 + BKV <= Skv && (!causal || k0 + BKV - 1 <= row0) &&
                        (window <= 0 || k0 >= wg_last - window + 1);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x = sacc[4 * i + 2 * j + c] * scale_log2;
            if (!full) {
              const int key = k0 + 8 * i + cq + c, row = rA + 8 * j;
              if (key >= Skv) {
                x = -INFINITY;                     // no such key
              } else {
                bool valid = true;
                if (causal) valid = row >= key;
                if (window > 0) valid = valid && row - key < window;
                if (!valid) x = -1e30f;
              }
            }
            sacc[4 * i + 2 * j + c] = x;
            mx[j] = fmaxf(mx[j], x);
          }
      float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
        alpha[j] = exp2f(m[j] - mx[j]);
        m[j] = mx[j];
      }
      uint32_t pa[4][4];          // P as the A operand of four 16-key steps
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p0 = exp2f(sacc[4 * i + 2 * j] - m[j]);
          const float p1 = exp2f(sacc[4 * i + 2 * j + 1] - m[j]);
          sum[j] += p0 + p1;
          pa[i / 2][(i % 2) * 2 + j] = pack_bf16(p0, p1);
        }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], 1);
        sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], 2);
        l[j] = l[j] * alpha[j] + sum[j];
      }
#pragma unroll
      for (int i = 0; i < NO / 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          oacc[4 * i + 2 * j] *= alpha[j];
          oacc[4 * i + 2 * j + 1] *= alpha[j];
        }

      // O += P V: V [keys, d] is the MN-major B operand
      mbar_wait(&sm.v_full[s], ph);
      fence_regs(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        pv<D>(oacc, pa[kk], desc_sw128(sm.v[s][0] + kk * 16 * 64, BOX_BYTES, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(oacc);
    } else {
      mbar_wait(&sm.v_full[s], ph);   // the stage is released only once it has landed
    }
    mbar_arrive(&sm.empty[s]);
  }

  if (!wg_live) return;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = rA + 8 * j;
    if (row >= Sq) continue;
    const float inv = 1.0f / fmaxf(l[j], 1e-30f);
    bf16* orow = o + ((static_cast<long long>(b) * Sq + row) * H + h) * D + cq;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(orow + 8 * i) =
          pack_bf16(oacc[4 * i + 2 * j] * inv, oacc[4 * i + 2 * j + 1] * inv);
  }
}

// a 4-D map over [B, S, heads, D] with element strides (b, s, head); a
// stride of a size-1 dim is never stepped, so any aligned value stands in
int encode(CUtensorMap* map, const void* base, int B, int S, int heads, int d,
           long long sb, long long ss, long long sh) {
  const uint64_t fill = 16;
  const uint64_t dims[4] = {static_cast<uint64_t>(d), static_cast<uint64_t>(S),
                            static_cast<uint64_t>(heads), static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {S > 1 ? 2 * static_cast<uint64_t>(ss) : fill,
                               heads > 1 ? 2 * static_cast<uint64_t>(sh) : fill,
                               B > 1 ? 2 * static_cast<uint64_t>(sb) : fill};
  return hopper::encode_bf16_sw128(map, base, 4, dims, strides, 64);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, const long long* st, int B,
           int Sq, int Skv, int H, int K, int causal, int window, void* stream) {
  CUtensorMap qm, km, vm;
  int err = encode(&qm, q, B, Sq, H, D, st[0], st[1], st[2]);
  if (!err) err = encode(&km, k, B, Skv, K, D, st[3], st[4], st[5]);
  if (!err) err = encode(&vm, v, B, Skv, K, D, st[6], st[7], st[8]);
  if (err) return err;
  constexpr size_t smem = smem_bytes<D>();
  static bool opted_in = false;     // idempotent, so a benign race
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_attention_wgmma_kernel<D><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, static_cast<bf16*>(o), Sq, Skv, H, H / K, causal, window,
      LOG2E / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

// q [B, Sq, H, d], k/v [B, Skv, K, d] with the given element strides (batch,
// sequence, head; the last dim contiguous); o [B, Sq, H, d] contiguous.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* o, const long long* strides, int B,
                                   int Sq, int Skv, int H, int K, int d,
                                   int causal, int window, void* stream) {
  return dispatch<float>(q, k, v, o, strides, B, Sq, Skv, H, K, d, causal, window, stream);
}

// bf16 at d = 64, 80 and 128 takes the wgmma path; this entry serves d = 256
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* o, const long long* strides, int B,
                                    int Sq, int Skv, int H, int K, int d,
                                    int causal, int window, void* stream) {
  if (d != 256) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
                   strides[5], strides[6], strides[7], strides[8]};
  return launch<__nv_bfloat16, 256>(q, k, v, o, st, B, Sq, Skv, H, K, causal, window, stream);
}

// The tensor-core path: bf16 at d = 64, 80 or 128, every row 16-byte aligned
// (the tensor maps' strides); the same arguments.
extern "C" int flash_attention_bf16_wgmma(const void* q, const void* k, const void* v,
                                          void* o, const long long* strides, int B, int Sq,
                                          int Skv, int H, int K, int d, int causal, int window,
                                          void* stream) {
  switch (d) {
    case 64: return wg::launch<64>(q, k, v, o, strides, B, Sq, Skv, H, K, causal, window, stream);
    case 80: return wg::launch<80>(q, k, v, o, strides, B, Sq, Skv, H, K, causal, window, stream);
    case 128: return wg::launch<128>(q, k, v, o, strides, B, Sq, Skv, H, K, causal, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
