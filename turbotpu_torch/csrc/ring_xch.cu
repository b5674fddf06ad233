// Boundary-metric ring exchange for Hopper (sm_90a): K6.
//
// Replaces the TPU kernel turbotpu/dist/dma.py::_xch_kernel (called by
// boundary_exchange_dma, pallas_call at :119): on a (data, seq) mesh every
// shard ships its forward payload (the alpha edges of both SISOs) to its
// ring successor in the seq direction and its backward payload (the beta
// edges) to its predecessor, both directions in flight in the same pass, with
// a barrier before the writes so that a receive buffer the neighbour still
// reads is not overwritten.  Shard i = d * n_seq + s (row-major logical ids,
// as dma.py:14-19); the ring stays within its data row.
//
// The kernel sees only pointers: a device table of 4 x n entries (source
// forward, source backward, destination forward, destination backward, one
// of each per shard) and a flag buffer.  On one card the shards' buffers are
// buffers of one device; across cards the destinations would be peer-mapped
// or symmetric-memory pointers, and only where the table's pointers come from
// would change.  Per shard, as _xch_kernel does (dma.py:70-90):
//   1. signal both ring neighbours: a system-scope release add on their
//      ready flags (one CTA of the shard does it);
//   2. wait until its own ready flag reaches 2 x epoch, read with acquire:
//      both neighbours have entered this exchange, so every read of the
//      buffers this exchange overwrites is done;
//   3. copy its forward payload to the successor's forward receive buffer
//      and its backward payload to the predecessor's backward receive buffer
//      in one loop, 16 bytes per access;
//   4. after its copies each CTA adds one, with release, to the arrival
//      counter of both destinations, and waits until its own counter reaches
//      2 x ctas x epoch: both incoming payloads have landed (the reference's
//      fwd.wait() / bwd.wait()).
// The flags only grow; epoch counts the exchanges made with this flag buffer.
// Every spin is bounded by a timeout on the global timer: a CTA that runs out
// of it writes an error code (1: the neighbours' signals did not come; 2: the
// incoming payloads did not land) and returns, and the wrapper raises.  The
// spins need every CTA of the grid resident at once; the wrapper keeps the
// grid at most one CTA per SM.
//
// Bound: at the sequence path's edge shape (2 SISOs x 8 states x 4096
// codewords x 4 B = 256 KiB per shard and direction) the bytes take about
// 0.3 us at 3.35 TB/s; the launch and the two flag round trips through the
// memory system set the time.  What the design does about it: one launch for
// both directions of every shard of the mesh, a few CTAs per shard.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void red_release_sys(int* p, int v) {
  asm volatile("red.release.sys.global.add.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int ld_acquire_sys(const int* p) {
  int v;
  asm volatile("ld.acquire.sys.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *p >= target or the timeout runs out (false then).
__device__ bool wait_geq(const int* p, int target, int64_t timeout_ns) {
  const uint64_t t0 = global_ns();
  while (ld_acquire_sys(p) < target) {
    if ((int64_t)(global_ns() - t0) > timeout_ns) return false;
    __nanosleep(64);
  }
  return true;
}

// grid = n shards x ctas; flags = ready[n], arrived[n], err.
__global__ void ring_xch_kernel(const int4* const* __restrict__ table,
                                int* flags, int n_seq, int ctas, int epoch,
                                int64_t n_vec, int64_t timeout_ns) {
  const int n = gridDim.x / ctas;
  const int i = blockIdx.x / ctas, g = blockIdx.x % ctas;
  const int row = i - i % n_seq, s = i % n_seq;
  const int nxt = row + (s + 1) % n_seq, prv = row + (s + n_seq - 1) % n_seq;
  int* ready = flags;
  int* arrived = flags + n;
  int* err = flags + 2 * n;
  __shared__ int ok;

  if (threadIdx.x == 0) {
    if (g == 0) {
      red_release_sys(&ready[nxt], 1);
      red_release_sys(&ready[prv], 1);
    }
    ok = wait_geq(&ready[i], 2 * epoch, timeout_ns);
    if (!ok) atomicCAS(err, 0, 1);
  }
  __syncthreads();
  if (!ok) return;

  const int4* src_fwd = table[i];
  const int4* src_bwd = table[n + i];
  int4* dst_fwd = const_cast<int4*>(table[2 * n + nxt]);
  int4* dst_bwd = const_cast<int4*>(table[3 * n + prv]);
  for (int64_t v = (int64_t)g * blockDim.x + threadIdx.x; v < n_vec;
       v += (int64_t)ctas * blockDim.x) {
    dst_fwd[v] = src_fwd[v];
    dst_bwd[v] = src_bwd[v];
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    __threadfence_system();
    red_release_sys(&arrived[nxt], 1);
    red_release_sys(&arrived[prv], 1);
    if (!wait_geq(&arrived[i], 2 * ctas * epoch, timeout_ns))
      atomicCAS(err, 0, 2);
  }
  __syncthreads();
}

}  // namespace

// table: device array of 4 * n pointers (src_fwd[n], src_bwd[n], dst_fwd[n],
// dst_bwd[n]), each buffer n_vec * 16 bytes and 16-byte aligned; flags:
// device int32[2 * n + 1], zero before the first exchange; epoch: this
// exchange's number, 1 for the first.  Returns the launch's cudaError_t.
extern "C" int turbotpu_ring_xch_launch(const void* table, void* flags, int n,
                                        int n_seq, int ctas, int epoch,
                                        long long n_vec, int threads,
                                        long long timeout_ns, void* stream) {
  if (n <= 0 || n_seq <= 0 || n % n_seq || ctas <= 0 || epoch <= 0)
    return (int)cudaErrorInvalidValue;
  ring_xch_kernel<<<n * ctas, threads, 0, (cudaStream_t)stream>>>(
      (const int4* const*)table, (int*)flags, n_seq, ctas, epoch,
      (int64_t)n_vec, (int64_t)timeout_ns);
  return (int)cudaGetLastError();
}
