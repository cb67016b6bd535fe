// Mandelbrot escape-time counts for a strip of global rows — the paper's
// §5.4 workload, on Hopper.
//
// Replaces: src/repro/kernels/mandelbrot/mandelbrot.py, _mandel_kernel (the
// Pallas kernel) and the JAX table kernel mandel_strip(rows) of
// benchmarks/bots_mandelbrot.py, whose signature it takes: the rows arrive
// as a device array of global row ids, so one compiled kernel serves every
// strip of a `total_height` image.
//
// Bound on the card: the issue rate of separately rounded fp32 operations
// (one dispatch slot each; they must not fuse, see Rounding).  An iteration
// needs two squares, z^2 + c (a subtract, two adds, two multiplies) and the
// escape sum |z|^2 = zx^2 + zy^2; that sum is only needed for the test, so
// tested once per chunk of iterations it is amortised and the least work is
// 7 operations per counted iteration: 7 * sum(counts).  The int32 output
// write (85 MB at 4600^2) is small beside it.
//
// Design: one thread per pixel, a 32 x 8 block (a warp spans 32 adjacent
// columns of one row, so the output write is coalesced).  A per-iteration
// test spends about five more slots than the seven operations (the compare,
// the break, the counter and the loop branch), so the loop runs in chunks
// of kChunk = 16 unrolled iterations with no test inside (4 and 8 timed
// slower on the card; MANDELBROT_CHUNK builds another size for that sweep), and tests |z|^2 <= 4
// once at the chunk's end (its squares are the next iteration's, so only
// the sum is extra).  When that test fails, the thread restores z as it was
// at the chunk's start and replays the chunk one iteration at a time with
// the exact test and break, which gives the exact count.  The max_iter mod
// kChunk iterations that fill no chunk run first, in the same exact loop:
// most pixels outside the set escape within a few iterations, and a warp of
// them then never runs (and replays) a whole chunk.
//
// Why the end-of-chunk test is exact: escape is permanent.  For |c| <= 2,
// once |z|^2 > 4, |z'| >= |z|^2 - |c| > |z|; for |c| > 2 the pixel escapes
// at count 1 and |z_2| = |c| |c + 1| > max(2, |c|).  So a test that fails
// inside a chunk fails at its end too; in fp32 the growth ends in inf or
// NaN, which the !(<=) form treats as escaped.  chip_smoke.py holds the
// kernel bit for bit against the plain version over the full image, whose
// corners reach |c| = 2.39.
//
// The TPU kernel runs all `max_iter` iterations under an "alive" mask to
// keep its loop static; here a thread leaves its loop once its pixel
// escapes, which gives the same count (the count only grows while the pixel
// is alive) and lets escaped warps retire early.
//
// Rounding: every multiply and add is written as __fmul_rn / __fadd_rn /
// __fsub_rn, which nvcc never contracts into an FMA.  A fused a*b+c would
// round once where the reference rounds twice and flip boundary pixels, so
// the counts are bit-identical to the reference's separate fp32 operations
// whatever the -fmad setting.  cx and cy are computed as the reference does:
// the fp32 step times the fp32 index, added to the fp32 lower bound.

#include <cuda_runtime.h>

#ifndef MANDELBROT_CHUNK
#define MANDELBROT_CHUNK 16
#endif

namespace {

constexpr int kChunk = MANDELBROT_CHUNK;

// Up to n iterations from z, each after the reference's test: returns the
// count of those that found the pixel alive, and leaves z where it stopped.
__device__ __forceinline__ int exact_iterations(float& zx, float& zy, float cx,
                                                float cy, int n) {
  int count = 0;
#pragma unroll 1
  for (; count < n; ++count) {
    const float zx2 = __fmul_rn(zx, zx);
    const float zy2 = __fmul_rn(zy, zy);
    // written as !(<=) so that a NaN escapes, as the masked reference does
    if (!(__fadd_rn(zx2, zy2) <= 4.0f)) break;
    const float nzx = __fadd_rn(__fsub_rn(zx2, zy2), cx);
    const float nzy = __fadd_rn(__fmul_rn(__fmul_rn(2.0f, zx), zy), cy);
    zx = nzx;
    zy = nzy;
  }
  return count;
}

// `chunks` chunks of kChunk iterations from z, the escape test at each
// chunk's end only; the chunk that fails it is replayed from its start with
// exact_iterations.  Returns the count of iterations that found the pixel
// alive.  z need not have passed its own test: if it fails, so does the
// first chunk's end test, and the replay stops at once.
__device__ __forceinline__ int chunked_iterations(float zx, float zy, float cx,
                                                  float cy, int chunks) {
  float zx2 = __fmul_rn(zx, zx), zy2 = __fmul_rn(zy, zy);
  float sx = zx, sy = zy;  // z at the chunk's start
  bool escaped = false;
  int c = 0;
#pragma unroll 1
  for (; c < chunks; ++c) {
    sx = zx;
    sy = zy;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float nzx = __fadd_rn(__fsub_rn(zx2, zy2), cx);
      const float nzy = __fadd_rn(__fmul_rn(__fmul_rn(2.0f, zx), zy), cy);
      zx = nzx;
      zy = nzy;
      zx2 = __fmul_rn(zx, zx);  // the next iteration's squares, and the test's
      zy2 = __fmul_rn(zy, zy);
    }
    if (!(__fadd_rn(zx2, zy2) <= 4.0f)) {
      escaped = true;
      break;
    }
  }
  // the replay runs after the loop, so a warp's lanes replay together
  return escaped ? c * kChunk + exact_iterations(sx, sy, cx, cy, kChunk)
                 : chunks * kChunk;
}

__global__ void __launch_bounds__(256)
    mandelbrot_rows_kernel(const int* __restrict__ rows, int* __restrict__ out,
                           int height, int width, float x0, float dx, float y0,
                           float dy, int max_iter) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (col >= width || r >= height) return;
  const float cx = __fadd_rn(x0, __fmul_rn(static_cast<float>(col), dx));
  const float cy = __fadd_rn(y0, __fmul_rn(static_cast<float>(rows[r]), dy));
  // the max_iter mod kChunk iterations that fill no chunk run first, one
  // test each: most pixels outside the set escape within them and never
  // pay for a chunk
  const int head = max_iter % kChunk;
  float zx = 0.0f, zy = 0.0f;
  int count = exact_iterations(zx, zy, cx, cy, head);
  if (count == head) {
    count += chunked_iterations(zx, zy, cx, cy, max_iter / kChunk);
  }
  out[static_cast<long long>(r) * width + col] = count;
}

}  // namespace

extern "C" int mandelbrot_rows(const void* rows, void* out, int height,
                               int width, float x0, float dx, float y0,
                               float dy, int max_iter, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y);
  mandelbrot_rows_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), static_cast<int*>(out), height, width, x0,
      dx, y0, dy, max_iter);
  return static_cast<int>(cudaGetLastError());
}
