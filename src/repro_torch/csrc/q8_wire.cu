// The block-int8 wire's round trip (quantize, then dequantize) on Hopper.
//
// Replaces: no TPU kernel.  The reference's wire is
// decompress(compress(a)) of src/repro/core/compression.py:34-48, which XLA
// fuses into one pass; eager PyTorch would run it as about eight launches
// per leaf (abs, max, divide, where, divide, round, clip, cast, multiply).
// The transport's quantize step (core/transport.py, Q8_KERNEL) launches this
// once per gradient leaf per device instead.
//
// Work, per block of 256 fp32 values (one warp, 8 values a lane, loads
// coalesced across the warp): absmax by a warp reduction (max is exact in
// any order); scale = absmax / 127 (IEEE division, __fdiv_rn; the build has
// no --use_fast_math); scale == 0 -> 1; q = clamp(rint(x / scale), -127,
// 127) (rint rounds half to even, as torch.round and jnp.round do); the
// round trip writes (float)(int)q * scale, the int cast turning a -0 into
// the +0 that the int8 payload carries.  The last block's tail is
// zero-padded, as compress pads it.  Every step is one correctly rounded
// fp32 operation, so the result equals the plain version
// (kernels/q8_wire/ref.py) bit for bit, for finite inputs.
//
// `out` may be `x` itself for an in-place pass; the transport never asks
// for that: it installs a new tensor, because a live mediary slot is never
// written in place (a SEND may be carrying it).
//
// Bound on the card: bytes.  The round trip reads 4 bytes and writes 4 per
// value and does ~8 operations per value, far under the card's operation
// peak, so one pass over the buffer at the memory rate is the bound.
// Eight independent loads a lane are in flight before the reduction.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;                 // values per scale (compression.py's block)
constexpr int kLanes = 32;
constexpr int kPerLane = kBlock / kLanes;   // 8
constexpr int kWarps = 8;                   // blocks of values per CTA

__global__ void __launch_bounds__(kWarps * kLanes)
q8_wire_kernel(const float* x, float* out, long long n) {
  const int lane = threadIdx.x & (kLanes - 1);
  const long long blk = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long n_blocks = (n + kBlock - 1) / kBlock;
  if (blk >= n_blocks) return;
  const long long base = blk * kBlock;
  float v[kPerLane];
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const long long idx = base + i * kLanes + lane;
    v[i] = idx < n ? x[idx] : 0.0f;
    amax = fmaxf(amax, fabsf(v[i]));
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  float scale = __fdiv_rn(amax, 127.0f);
  if (scale == 0.0f) scale = 1.0f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const long long idx = base + i * kLanes + lane;
    const float r = fminf(fmaxf(rintf(__fdiv_rn(v[i], scale)), -127.0f), 127.0f);
    if (idx < n) out[idx] = __fmul_rn(static_cast<float>(static_cast<int>(r)), scale);
  }
}

}  // namespace

extern "C" int q8_wire(const void* x, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long n_blocks = (n + kBlock - 1) / kBlock;
  const long long grid = (n_blocks + kWarps - 1) / kWarps;
  q8_wire_kernel<<<static_cast<unsigned>(grid), kWarps * kLanes, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
