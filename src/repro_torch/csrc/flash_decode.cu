// flash_decode: one-token GQA attention against a KV cache, on Hopper, as
// split-KV flash decoding with a deterministic combine.
//
// Replaces: src/repro/kernels/flash_decode/flash_decode.py, _decode_kernel
// (the Pallas kernel: grid (batch*kv_heads, cache block) with the cache axis
// sequential; the online-softmax state of the group's r query rows in VMEM
// scratch; kv_len masks the tail).  On the card the cache axis is cut into
// splits that run side by side, and a second pass folds their states.
//
// What it computes, for every sequence b and kv head kh: the r query heads
// h = kh*r + g attend over the first kv_len[b] cache rows.  The Pallas
// kernel's arithmetic: fp32 scores times 1/sqrt(d); rows at or past kv_len
// score the finite -1e30; rows past S (a ragged last tile) score -inf and
// contribute exactly nothing; an online softmax per query row; p rounded to
// v's dtype before the PV product; fp32 accumulators; out = acc / max(l,
// 1e-30) in q's dtype.  kv_len = 0 gives the mean of all S value rows (every
// score is the same -1e30, so the softmax is uniform).
//
// Bound on the card: bytes.  A call reads the live rows of K and V once
// (2 * kv_len * d elements per kv head) for 4 * r * d flops a row: about
// 3 flops a byte at r = 3, far under what the CUDA cores can feed, so no
// tensor-core product is wanted.  The time goes to keeping enough loads in
// flight, which takes many CTAs and overlapped copies.
//
// Design:
//  * Split kernel, grid (B*K, n_split), 128 threads.  Split s of (b, kh)
//    owns cache rows [s * rows_per_split, (s + 1) * rows_per_split); the
//    launcher picks n_split and rows_per_split (a multiple of 64) from the
//    shapes and the SM count alone, never from kv_len's values, so a call
//    reads nothing back and captures into a CUDA graph as it is.  A split
//    whose rows all lie at or past kv_len[b] (kv_len > 0) writes an empty
//    state (m = -inf, l = 0, o = 0) and exits: its rows would score -1e30
//    and weigh exp(-1e30 - m) = 0 once any valid row is seen, so skipping
//    them is exact.  Inside a split only the tiles up to the one holding row
//    kv_len - 1 run, by the same argument; under kv_len = 0 every split runs
//    its whole range, so the fold gives the uniform mean.
//  * Inside a split, K and V tiles of TILE rows stream through a ring of
//    NSTAGE = 2 shared-memory stages with 16-byte cp.async copies (rows past
//    S zero-filled), so tile t + 1 is in flight while tile t is scored and
//    accumulated; the launcher keeps splits to one or two 64-row units, so
//    a split's whole range is in flight at once.  The kernel is bound by
//    latency, so occupancy counts more than pipeline depth: two stages leave
//    room for three CTAs an SM at d = 128 in bf16, and the r = 1 groups
//    (moonshot, zamba2) get their own instantiation with fewer registers.  Q.K: PARTS threads share a cache row, each
//    taking every PARTS-th 16-byte chunk of it against the fp32 query rows
//    (shared memory, read as float4 by every thread of a row group at once),
//    and add their partial sums with shuffles; K rows are padded so those
//    chunk reads hit distinct banks.  Softmax: one warp per query row.  PV:
//    each thread owns 8 output columns of every query row and a residue
//    class of the tile's rows; the row classes are summed at the end of the
//    split in a fixed order.
//  * Each split writes its state (o unnormalized, m, l) in fp32 to a
//    workspace [B*H, n_split, d + 2] that the launcher takes from PyTorch's
//    caching allocator on the current stream.  The combine kernel (one CTA
//    per query row) folds splits 0 .. n_split-1 in that order: m = max m_i,
//    w_i = exp(m_i - m) (0 for an empty split), l = sum l_i w_i, out =
//    (sum o_i w_i) / max(l, 1e-30).  The result never depends on which CTA
//    finished first, and nothing outlives the call.  The combine is a
//    programmatic dependent launch: it may start while the split kernel
//    runs, and waits (griddepcontrol.wait) for that grid to finish before it
//    reads the workspace.  With one split the split kernel writes the output
//    itself and no combine runs.
// Every sum runs in an order fixed by the shapes, so equal inputs give
// bitwise equal outputs.  Shared memory exceeds 48 KB, so the launch opts in.

#include "hopper.cuh"

#include <math.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int NSTAGE = 2;           // K/V tiles in the shared-memory ring
constexpr int SPLIT_UNIT = 64;      // rows_per_split is a multiple of this
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

// the elements of one 16-byte chunk as fp32 (a bf16 is the high half of an fp32)
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[4]) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4& w, float (&f)[8]) {
  const unsigned int x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(x[i] << 16);
    f[2 * i + 1] = __uint_as_float(x[i] & 0xffff0000u);
  }
}

struct Strides {              // in elements: batch, cache row, kv head
  long long k_b, k_s, k_h, v_b, v_s, v_h;
};

template <typename T, int D, int RB>
struct Plan {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // elements a chunk
  static constexpr int U = D / VEC;                              // chunks a row
  static constexpr int TILE = D * static_cast<int>(sizeof(T)) <= 256 ? 64 : 32;
  static constexpr int PARTS = THREADS / TILE;                   // threads a row in Q.K
  // K row pitch in chunks, = PARTS (mod 8): the PARTS threads of a row and
  // the rows beside them read distinct 16-byte bank groups
  static constexpr int KP = U + (8 + PARTS - U % 8) % 8;
  static constexpr int STAGE = TILE * (KP + U) * 16;             // bytes: K tile, V tile
  static constexpr int CG = D / 8;                               // 8-column groups (PV)
  static constexpr int JG = THREADS / CG;                        // row classes (PV)
  static constexpr int RING = NSTAGE * STAGE;
  static constexpr int RED = JG * RB * D * 4;                    // row-class sums, at the end
  static constexpr int BIG = RING > RED ? RING : RED;
  static constexpr int SMEM = BIG + 4 * (RB * D + RB * TILE + 3 * RB);
  static_assert(D % VEC == 0 && U % PARTS == 0 && D % 8 == 0, "whole chunks");
  static constexpr int NGW = (RB + WARPS - 1) / WARPS;           // query rows a warp (softmax)
};

template <typename T, int D, int RB>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    T* __restrict__ o, float* __restrict__ ws, Strides st, int S, int H,
                    int K, int r, int rows_per_split, int n_split, float scale) {
  using P = Plan<T, D, RB>;
  constexpr int TILE = P::TILE, VEC = P::VEC, U = P::U, KP = P::KP, PARTS = P::PARTS;
  constexpr int CG = P::CG, JG = P::JG;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + P::BIG);   // [r][D], fp32
  float* Ps = Qs + RB * D;                               // [r][TILE]
  float* alpha_s = Ps + RB * TILE;                       // [r]
  float* m_s = alpha_s + RB;                             // [r]
  float* l_s = m_s + RB;                                 // [r]

  // the combine kernel may start launching now: it waits for this grid to
  // finish before it reads anything (griddepcontrol.wait)
  asm volatile("griddepcontrol.launch_dependents;");
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int bk = blockIdx.x, split = blockIdx.y;
  const int b = bk / K, kh = bk % K;
  const long long row_q = static_cast<long long>(b) * H + kh * r;   // first query row

  const int len = kv_len[b];
  const int live = len > 0 ? min(len, S) : S;   // kv_len = 0: the whole cache
  const int row0 = split * rows_per_split;
  const int row_end = min(row0 + rows_per_split, live);
  const int n_tiles = row_end > row0 ? (row_end - row0 + TILE - 1) / TILE : 0;

  if (n_tiles == 0) {          // every row at or past kv_len: an empty state
    for (int e = tid; e < r * D; e += THREADS) {
      const int g = e / D, c = e % D;
      if (n_split == 1) o[(row_q + g) * D + c] = from_f32<T>(0.0f);   // S = 0
      else ws[((row_q + g) * n_split + split) * (D + 2) + c] = 0.0f;
    }
    if (n_split > 1 && tid < r) {
      float* w = ws + ((row_q + tid) * n_split + split) * (D + 2);
      w[D] = -INFINITY;
      w[D + 1] = 0.0f;
    }
    return;
  }

  const T* kb = k + b * st.k_b + kh * st.k_h;
  const T* vb = v + b * st.v_b + kh * st.v_h;
  auto load_tile = [&](int t) {
    unsigned char* stage = smem + (t % NSTAGE) * P::STAGE;
    const int k0 = row0 + t * TILE;
#pragma unroll
    for (int i = 0; i < (TILE * U + THREADS - 1) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      if ((TILE * U) % THREADS == 0 || e < TILE * U) {
        const int j = e / U, c = e % U;
        const bool in = k0 + j < S;
        const long long row = in ? k0 + j : 0;
        hopper::cp_async16(stage + (j * KP + c) * 16, kb + row * st.k_s + c * VEC, in ? 16 : 0);
        hopper::cp_async16(stage + (TILE * KP + j * U + c) * 16, vb + row * st.v_s + c * VEC,
                           in ? 16 : 0);
      }
    }
  };
#pragma unroll
  for (int t = 0; t < NSTAGE - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    hopper::cp_async_commit();
  }

  // the r query rows as fp32, 16-byte loads all in flight at once (the
  // launcher's q rows start on 16 bytes)
  const uint4* qg = reinterpret_cast<const uint4*>(q + row_q * D);
#pragma unroll
  for (int i = 0; i < (RB * U + THREADS - 1) / THREADS; ++i) {
    const int e = tid + i * THREADS;
    if (e < r * U) {
      float f[VEC];
      unpack(qg[e], f);
#pragma unroll
      for (int x = 0; x < VEC; ++x) Qs[e * VEC + x] = f[x];
    }
  }

  float m_row[P::NGW], l_row[P::NGW];     // query rows warp, warp + WARPS, ...
#pragma unroll
  for (int i = 0; i < P::NGW; ++i) { m_row[i] = NEG_INF; l_row[i] = 0.0f; }
  float acc[RB][8];
#pragma unroll
  for (int g = 0; g < RB; ++g)
#pragma unroll
    for (int x = 0; x < 8; ++x) acc[g][x] = 0.0f;
  const int cg = tid % CG, jg = tid / CG;       // PV: 8 columns, a row class

  for (int t = 0; t < n_tiles; ++t) {
    hopper::cp_async_wait<NSTAGE - 2>();         // this thread's copies of tile t
    __syncthreads();                             // everyone's; tile t - 1 consumed
    if (t + NSTAGE - 1 < n_tiles) load_tile(t + NSTAGE - 1);
    hopper::cp_async_commit();
    const unsigned char* stage = smem + (t % NSTAGE) * P::STAGE;
    const int k0 = row0 + t * TILE;

    // scores: PARTS threads per cache row j
    {
      const int j = tid / PARTS, part = tid % PARTS;
      const uint4* krow = reinterpret_cast<const uint4*>(stage) + j * KP;
      float s[RB];
#pragma unroll
      for (int g = 0; g < RB; ++g) s[g] = 0.0f;
#pragma unroll
      for (int i = 0; i < U / PARTS; ++i) {
        const int c = i * PARTS + part;
        float kf[VEC];
        unpack(krow[c], kf);
#pragma unroll
        for (int g = 0; g < RB; ++g) {
          if (g < r) {
            const float4* qv = reinterpret_cast<const float4*>(Qs + g * D + c * VEC);
#pragma unroll
            for (int x = 0; x < VEC / 4; ++x) {
              const float4 qq = qv[x];
              s[g] = fmaf(qq.x, kf[4 * x], s[g]);
              s[g] = fmaf(qq.y, kf[4 * x + 1], s[g]);
              s[g] = fmaf(qq.z, kf[4 * x + 2], s[g]);
              s[g] = fmaf(qq.w, kf[4 * x + 3], s[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < RB; ++g)
#pragma unroll
        for (int off = 1; off < PARTS; off <<= 1)
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
      if (part == 0) {
        const int pos = k0 + j;
#pragma unroll
        for (int g = 0; g < RB; ++g)
          if (g < r)
            Ps[g * TILE + j] = pos >= S ? -INFINITY : (pos < len ? s[g] * scale : NEG_INF);
      }
    }
    __syncthreads();

    // online softmax: one warp per query row
#pragma unroll
    for (int i = 0; i < P::NGW; ++i) {
      const int g = warp + i * WARPS;
      if (g < r) {
        float* prow = Ps + g * TILE;
        float x[TILE / 32];
        float mx = -INFINITY;
#pragma unroll
        for (int u = 0; u < TILE / 32; ++u) {
          x[u] = prow[lane + 32 * u];
          mx = fmaxf(mx, x[u]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_row[i], mx);
        float sum = 0.0f;
#pragma unroll
        for (int u = 0; u < TILE / 32; ++u) {
          x[u] = expf(x[u] - m_new);
          sum += x[u];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const float alpha = expf(m_row[i] - m_new);
        l_row[i] = l_row[i] * alpha + sum;
        m_row[i] = m_new;
#pragma unroll
        for (int u = 0; u < TILE / 32; ++u) prow[lane + 32 * u] = round_to<T>(x[u]);
        if (lane == 0) alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc[g][:] = acc * alpha[g] + sum over this thread's rows j of p[g][j] * v[j][:]
    if (jg < JG) {
#pragma unroll
      for (int g = 0; g < RB; ++g) {
        if (g < r) {
          const float a = alpha_s[g];
#pragma unroll
          for (int x = 0; x < 8; ++x) acc[g][x] *= a;
        }
      }
      const uint4* vt = reinterpret_cast<const uint4*>(stage) + TILE * KP;
      for (int j = jg; j < TILE; j += JG) {
        float vf[8];
        if constexpr (VEC == 8) {
          unpack(vt[j * U + cg], vf);
        } else {
          float lo[4], hi[4];
          unpack(vt[j * U + 2 * cg], lo);
          unpack(vt[j * U + 2 * cg + 1], hi);
#pragma unroll
          for (int x = 0; x < 4; ++x) { vf[x] = lo[x]; vf[4 + x] = hi[x]; }
        }
#pragma unroll
        for (int g = 0; g < RB; ++g) {
          if (g < r) {
            const float p = Ps[g * TILE + j];
#pragma unroll
            for (int x = 0; x < 8; ++x) acc[g][x] = fmaf(p, vf[x], acc[g][x]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < P::NGW; ++i) {
    const int g = warp + i * WARPS;
    if (g < r && lane == 0) { m_s[g] = m_row[i]; l_s[g] = l_row[i]; }
  }
  __syncthreads();                     // the ring is free: it becomes the row-class sums
  float* red = reinterpret_cast<float*>(smem);           // [JG][r][D]
  if (jg < JG) {
#pragma unroll
    for (int g = 0; g < RB; ++g) {
      if (g < r) {
        float4* dst = reinterpret_cast<float4*>(red + (jg * r + g) * D + cg * 8);
        dst[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        dst[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < r * D; e += THREADS) {
    const int g = e / D, c = e % D;
    float sum = 0.0f;
    for (int i = 0; i < JG; ++i) sum += red[(i * r + g) * D + c];
    if (n_split == 1) o[(row_q + g) * D + c] = from_f32<T>(sum / fmaxf(l_s[g], 1e-30f));
    else ws[((row_q + g) * n_split + split) * (D + 2) + c] = sum;
  }
  if (n_split > 1 && tid < r) {
    float* w = ws + ((row_q + tid) * n_split + split) * (D + 2);
    w[D] = m_s[tid];
    w[D + 1] = l_s[tid];
  }
}

// one CTA per query row: fold the n_split states in split order.  The
// states' (m, l) are read by one thread each, all at once, into shared
// memory; every sum then runs in split order from there, and each column's
// o_i loads are unrolled so several are in flight.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const float* __restrict__ ws, T* __restrict__ o, int n_split) {
  extern __shared__ float wsh[];                 // [n_split] m_i, then weights; [n_split] l_i
  float* lsh = wsh + n_split;
  // launched as a programmatic dependent of the split kernel: wait until that
  // grid has finished and its workspace writes are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const long long row = blockIdx.x;
  const float* w = ws + row * n_split * (D + 2);
  for (int i = threadIdx.x; i < n_split; i += THREADS) {
    wsh[i] = w[i * (D + 2) + D];
    lsh[i] = w[i * (D + 2) + D + 1];
  }
  __syncthreads();
  float m = -INFINITY;
  for (int i = 0; i < n_split; ++i) m = fmaxf(m, wsh[i]);
  __syncthreads();
  for (int i = threadIdx.x; i < n_split; i += THREADS)
    wsh[i] = wsh[i] == -INFINITY ? 0.0f : expf(wsh[i] - m);
  __syncthreads();
  float l = 0.0f;
  for (int i = 0; i < n_split; ++i) l += lsh[i] * wsh[i];
  for (int c = threadIdx.x; c < D; c += THREADS) {
    float acc = 0.0f;
#pragma unroll 8
    for (int i = 0; i < n_split; ++i) acc += w[i * (D + 2) + c] * wsh[i];
    o[row * D + c] = from_f32<T>(acc / fmaxf(l, 1e-30f));
  }
}

template <typename T, int D, int RB>
int launch(const void* q, const void* k, const void* v, const void* kv_len, void* o,
           void* ws, const Strides& st, int B, int S, int H, int K, int rows_per_split,
           int n_split, void* stream) {
  using P = Plan<T, D, RB>;
  static bool opted_in = false;     // idempotent, so a benign race
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<T, D, RB>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  decode_split_kernel<T, D, RB><<<dim3(B * K, n_split), THREADS, P::SMEM, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_len), static_cast<T*>(o), static_cast<float*>(ws), st, S, H,
      K, H / K, rows_per_split, n_split, 1.0f / sqrtf(static_cast<float>(D)));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  // programmatic dependent launch: the combine's launch overlaps the split
  // kernel's tail
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 2 * n_split * sizeof(float);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_combine_kernel<T, D>, static_cast<const float*>(ws),
                           static_cast<T*>(o), n_split);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int by_group(const void* q, const void* k, const void* v, const void* kv_len, void* o,
             void* ws, const Strides& st, int B, int S, int H, int K, int rows_per_split,
             int n_split, void* stream) {
  if (H / K == 1)      // the served models' groups (r = 1, 3) in fewer registers
    return launch<T, D, 1>(q, k, v, kv_len, o, ws, st, B, S, H, K, rows_per_split, n_split,
                           stream);
  if (H / K <= 4)
    return launch<T, D, 4>(q, k, v, kv_len, o, ws, st, B, S, H, K, rows_per_split, n_split,
                           stream);
  return launch<T, D, 16>(q, k, v, kv_len, o, ws, st, B, S, H, K, rows_per_split, n_split,
                          stream);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* kv_len, void* o,
             void* ws, const long long* strides, int B, int S, int H, int K, int d,
             int rows_per_split, int n_split, void* stream) {
  if (K <= 0 || H % K != 0 || H / K > 16 || n_split < 1 || rows_per_split < SPLIT_UNIT ||
      rows_per_split % SPLIT_UNIT != 0 ||
      static_cast<long long>(n_split - 1) * rows_per_split >= (S > 0 ? S : 1) ||
      static_cast<long long>(n_split) * rows_per_split < S || (n_split > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2], strides[3], strides[4], strides[5]};
  switch (d) {
    case 64: return by_group<T, 64>(q, k, v, kv_len, o, ws, st, B, S, H, K, rows_per_split, n_split, stream);
    case 80: return by_group<T, 80>(q, k, v, kv_len, o, ws, st, B, S, H, K, rows_per_split, n_split, stream);
    case 128: return by_group<T, 128>(q, k, v, kv_len, o, ws, st, B, S, H, K, rows_per_split, n_split, stream);
    case 256: return by_group<T, 256>(q, k, v, kv_len, o, ws, st, B, S, H, K, rows_per_split, n_split, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, H, d] contiguous; k/v [B, S, K, d] with the given element strides
// (batch, cache row, kv head; the last dim contiguous, rows 16-byte
// aligned); kv_len [B] int32; o [B, H, d] contiguous; ws fp32 [B*H, n_split,
// d + 2] (unused, and may be null, when n_split = 1).  Splits of
// rows_per_split rows (a multiple of 64) cover the cache, none of them past
// it.  Launches the split kernel and, for n_split > 1, the combine kernel on
// `stream`; returns the first launch error.
extern "C" int flash_decode_f32(const void* q, const void* k, const void* v,
                                const void* kv_len, void* o, void* ws,
                                const long long* strides, int B, int S, int H, int K, int d,
                                int rows_per_split, int n_split, void* stream) {
  return dispatch<float>(q, k, v, kv_len, o, ws, strides, B, S, H, K, d, rows_per_split,
                         n_split, stream);
}

extern "C" int flash_decode_bf16(const void* q, const void* k, const void* v,
                                 const void* kv_len, void* o, void* ws,
                                 const long long* strides, int B, int S, int H, int K, int d,
                                 int rows_per_split, int n_split, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, kv_len, o, ws, strides, B, S, H, K, d,
                                 rows_per_split, n_split, stream);
}
