// Row gather for Hopper (sm_90a): out[t, :] = src[idx[t], :] on a (T, B)
// tensor of 1-, 2- or 4-byte elements, one launch.
//
// Replaces the TPU kernel experiments/gather_inkernel.py::row_gather_pallas
// (pallas_call at :112): a scalar-prefetched index table and one DMA per
// row, issued and retired window by window.  None of that machinery exists
// here.  A row is `row_bytes` contiguous bytes; the threads of a block copy
// whole rows with the widest vector load that the row length and the
// pointers' alignment allow (16 bytes down to 1), neighbouring threads on
// neighbouring vectors.  It is the standalone form of the read that the
// folded SISO kernel (siso.cu, SISO_FOLD) does per step, and the experiment
// that says what such a read costs beside torch.index_select.
//
// Bound: bytes.  Every row is read once and written once, 2 x T x row_bytes
// plus 4 T bytes of indices, and there is no arithmetic beyond addresses.
// What the design does about it: a block is 256 threads laid out as
// (vectors of a row) x (rows), so short rows (1 KB at B=1024, int8) still
// give every warp 512 contiguous bytes per row and full blocks, and long rows
// are walked by the block's x-threads in a loop of independent 16-byte
// copies.  At the decoder's stream (6400 rows of 1 KB) the 13 MB sit in the
// 50 MB L2.  The Hopper counterpart of the per-row DMA (a persistent grid
// issuing cp.async.bulk copies through shared memory on mbarriers) was
// measured slower than this kernel at 1 KB and at 32 KB rows, and dropped.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_THREADS = 256;

template <typename V>
__global__ void row_gather_kernel(const V* __restrict__ src,
                                  const int* __restrict__ idx,
                                  V* __restrict__ out, int T, int64_t vpr) {
  const int t = blockIdx.x * blockDim.y + threadIdx.y;
  if (t >= T) return;
  const V* __restrict__ s = src + (int64_t)idx[t] * vpr;
  V* __restrict__ o = out + (int64_t)t * vpr;
#pragma unroll 4
  for (int64_t v = threadIdx.x; v < vpr; v += blockDim.x) o[v] = s[v];
}

template <typename V>
cudaError_t launch(const void* src, const int* idx, void* out, int T,
                   int64_t row_bytes, cudaStream_t stream) {
  const int64_t vpr = row_bytes / (int64_t)sizeof(V);
  // x: threads along a row, a power of two up to the block; y: rows
  int tx = 1;
  while (tx < BLOCK_THREADS && tx < vpr) tx *= 2;
  const int ty = BLOCK_THREADS / tx;
  const dim3 block(tx, ty), grid((T + ty - 1) / ty);
  row_gather_kernel<V><<<grid, block, 0, stream>>>(
      (const V*)src, idx, (V*)out, T, vpr);
  return cudaGetLastError();
}

}  // namespace

// One launch.  `a` holds six int64 arguments (read before the launch, so
// the caller may reuse the block at once):
//   a[0] src, a[1] idx, a[2] out: device addresses; src and out (T,
//        row_bytes) bytes, contiguous, not overlapping; idx (T,) int32 with
//        values in [0, number of rows of src);
//   a[3] T, a[4] row_bytes, a[5] the cudaStream_t.
// One pointer instead of six typed arguments keeps the host's cost of the
// call (ctypes converts every typed argument) below a microsecond.
// Returns the launch's cudaError_t (0 = ok).
extern "C" int turbotpu_row_gather_launch(const int64_t* a) {
  const void* src = (const void*)a[0];
  const int* ix = (const int*)a[1];
  void* out = (void*)a[2];
  const int64_t T = a[3], row_bytes = a[4];
  cudaStream_t st = (cudaStream_t)a[5];
  if (T <= 0 || T > INT32_MAX || row_bytes <= 0)
    return (int)cudaErrorInvalidValue;
  const uintptr_t bits = (uintptr_t)src | (uintptr_t)out | (uintptr_t)row_bytes;
  const int n = (int)T;
  if (bits % 16 == 0) return (int)launch<uint4>(src, ix, out, n, row_bytes, st);
  if (bits % 8 == 0) return (int)launch<uint2>(src, ix, out, n, row_bytes, st);
  if (bits % 4 == 0)
    return (int)launch<uint32_t>(src, ix, out, n, row_bytes, st);
  if (bits % 2 == 0)
    return (int)launch<uint16_t>(src, ix, out, n, row_bytes, st);
  return (int)launch<uint8_t>(src, ix, out, n, row_bytes, st);
}
