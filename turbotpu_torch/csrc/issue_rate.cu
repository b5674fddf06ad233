// Issue-rate microbenchmark for Hopper (sm_90a): per thread, LANES
// independent chains of v = max(v + c, v) in fp32.
//
// Replaces the TPU kernel experiments/cost_breakdown.py::_calibrate_vpu
// (pallas_call at :230), which runs the same recurrence on one (8, 128) fp32
// tile.  With one chain per thread the time per operation is the latency of
// a dependent fp32 add or max (what bounds the SISO kernel when a warp has
// an SM to itself); with 8 or 16 chains it is the rate at which one warp can
// issue independent fp32 instructions; at full occupancy it is the SM's
// issue rate.  The loop is unrolled by 8 like the SISO kernel's blocks, the
// add is an explicit __fadd_rn, and the file is built with -fmad=false like
// siso.cu.
//
// Bound: operations (2 per chain step and thread; 4 bytes in and 4 x LANES
// out per thread do not count beside them).  There is nothing to design
// around: the kernel exists to measure that bound.  The chain values are
// written out so that the work cannot be removed and can be checked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UNROLL = 8;

template <int LANES>
__global__ void issue_rate_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, int64_t n_threads,
                                  int n_blocks) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_threads) return;
  const float x0 = x[i];
  const float c = __fmul_rn(x0, 0.5f);
  float v[LANES];
#pragma unroll
  for (int l = 0; l < LANES; ++l) v[l] = __fadd_rn(x0, (float)l);
  for (int n = 0; n < n_blocks; ++n) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int l = 0; l < LANES; ++l) v[l] = fmaxf(__fadd_rn(v[l], c), v[l]);
    }
  }
#pragma unroll
  for (int l = 0; l < LANES; ++l) out[i * LANES + l] = v[l];
}

}  // namespace

// x: (n_threads,) fp32; out: (n_threads, lanes) fp32; lanes 1, 8 or 16;
// n_blocks: loop trips of 8 chain steps each; grid x threads >= n_threads.
// Returns the launch's cudaError_t (0 = ok), or -1 for an unknown `lanes`.
extern "C" int turbotpu_issue_rate_launch(const void* x, void* out,
                                          int64_t n_threads, int lanes,
                                          int n_blocks, int grid, int threads,
                                          void* stream) {
  const float* xi = (const float*)x;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if ((int64_t)grid * threads < n_threads) return (int)cudaErrorInvalidValue;
  switch (lanes) {
    case 1:
      issue_rate_kernel<1><<<grid, threads, 0, st>>>(xi, o, n_threads,
                                                     n_blocks);
      break;
    case 8:
      issue_rate_kernel<8><<<grid, threads, 0, st>>>(xi, o, n_threads,
                                                     n_blocks);
      break;
    case 16:
      issue_rate_kernel<16><<<grid, threads, 0, st>>>(xi, o, n_threads,
                                                      n_blocks);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}
