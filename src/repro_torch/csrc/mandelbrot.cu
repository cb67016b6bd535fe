// Mandelbrot escape-time counts for a strip of global rows — the paper's
// §5.4 workload, on Hopper.
//
// Replaces: src/repro/kernels/mandelbrot/mandelbrot.py, _mandel_kernel (the
// Pallas kernel) and the JAX table kernel mandel_strip(rows) of
// benchmarks/bots_mandelbrot.py, whose signature it takes: the rows arrive
// as a device array of global row ids, so one compiled kernel serves every
// strip of a `total_height` image.
//
// Bound on the card: fp32 issue rate.  Each iteration is about 8 flops
// (two squares, the escape test, z^2 + c), so the work is sum(counts) * 8
// flops; the int32 output write (85 MB at 4600^2) is small beside it.
//
// Design: one thread per pixel, a 32 x 8 block (a warp spans 32 adjacent
// columns of one row, so the output write is coalesced).  The TPU kernel
// runs all `max_iter` iterations under an "alive" mask to keep its loop
// static; here a thread leaves its loop once its pixel escapes, which gives
// the same count (the count only grows while the pixel is alive) and lets
// escaped warps retire early.
//
// Rounding: every multiply and add is written as __fmul_rn / __fadd_rn /
// __fsub_rn, which nvcc never contracts into an FMA.  A fused a*b+c would
// round once where the reference rounds twice and flip boundary pixels, so
// the counts are bit-identical to the reference's separate fp32 operations
// whatever the -fmad setting.  cx and cy are computed as the reference does:
// the fp32 step times the fp32 index, added to the fp32 lower bound.

#include <cuda_runtime.h>

namespace {

__global__ void mandelbrot_rows_kernel(const int* __restrict__ rows,
                                       int* __restrict__ out, int height,
                                       int width, float x0, float dx,
                                       float y0, float dy, int max_iter) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (col >= width || r >= height) return;
  const float cx = __fadd_rn(x0, __fmul_rn(static_cast<float>(col), dx));
  const float cy = __fadd_rn(y0, __fmul_rn(static_cast<float>(rows[r]), dy));
  float zx = 0.0f, zy = 0.0f;
  int count = 0;
  for (int it = 0; it < max_iter; ++it) {
    const float zx2 = __fmul_rn(zx, zx);
    const float zy2 = __fmul_rn(zy, zy);
    // written as !(<=) so that a NaN escapes, as the masked reference does
    if (!(__fadd_rn(zx2, zy2) <= 4.0f)) break;
    const float nzx = __fadd_rn(__fsub_rn(zx2, zy2), cx);
    const float nzy = __fadd_rn(__fmul_rn(__fmul_rn(2.0f, zx), zy), cy);
    zx = nzx;
    zy = nzy;
    ++count;
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
