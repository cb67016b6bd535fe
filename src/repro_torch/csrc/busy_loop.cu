// The BOTS fib leaf (paper §5.5) on Hopper: fib(n), then a busy loop sized
// to the recursion tree the leaf stands for, in one launch.
//
// Replaces: the JAX table kernel fib_subtree(n) of benchmarks/bots_fib.py,
// whose busy loop is XLA's compiled fori_loop (there is no TPU kernel to
// port).  Eager PyTorch would launch one kernel per step (up to 13.1 M steps
// for fib(21)), so the loop runs here, in one block.
//
// Work: fib(n) by n fp32 steps of (a, b) -> (b, a + b); iters = (2 fib(n) -
// 1) * 600 (the work per simulated call); each of the 128 lanes (one thread
// each) runs `iters` dependent steps of acc = acc * 1.0000001 + 1e-7 from
// acc = 1; the lanes' sum, summed in lane order, is folded into the output
// as the reference folds it (fib(n) + 1 if the sum is infinite, else + 0),
// so nothing can drop the loop.
//
// Bound on the card: the latency of the dependent chain.  Each step is a
// multiply and an add that depend on the one before (about 8 cycles a
// step), so a leaf takes iters * 8 / clock whatever the card's throughput;
// one block of 128 threads is all the work there is.  The roofline bound
// (2 * 128 * iters separately rounded fp32 operations at the card's peak)
// is far below that.
//
// Rounding: the multiply and the add are __fmul_rn / __fadd_rn, which nvcc
// never contracts into an FMA, so every lane gives the plain version's bits
// (kernels/busy_loop/ref.py rounds each operation to fp32).  n is read on
// the card: a leaf's size never goes through the host.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;        // the reference's busy accumulator, jnp.ones((128,))
constexpr int kWorkPerCall = 600;  // the reference's WORK_PER_CALL

__global__ void __launch_bounds__(kLanes)
fib_subtree_kernel(const int* __restrict__ n, float* __restrict__ out,
                   float* __restrict__ acc_out) {
  __shared__ float lane_acc[kLanes];
  const int k = *n;
  float a = 0.0f, b = 1.0f;
  for (int i = 0; i < k; ++i) {
    const float t = __fadd_rn(a, b);
    a = b;
    b = t;
  }
  const float calls = __fsub_rn(__fmul_rn(2.0f, a), 1.0f);
  const int iters = static_cast<int>(__fmul_rn(calls, static_cast<float>(kWorkPerCall)));
  float acc = 1.0f;
  for (int i = 0; i < iters; ++i) acc = __fadd_rn(__fmul_rn(acc, 1.0000001f), 1e-7f);
  acc_out[threadIdx.x] = acc;
  lane_acc[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.0f;
    for (int i = 0; i < kLanes; ++i) sum = __fadd_rn(sum, lane_acc[i]);
    out[0] = __fadd_rn(a, isinf(sum) ? 1.0f : 0.0f);
  }
}

}  // namespace

extern "C" int fib_subtree(const void* n, void* out, void* acc, void* stream) {
  fib_subtree_kernel<<<1, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(n), static_cast<float*>(out), static_cast<float*>(acc));
  return static_cast<int>(cudaGetLastError());
}
