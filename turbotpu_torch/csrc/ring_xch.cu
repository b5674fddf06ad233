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
//   1. signal both ring neighbours: a release add on their ready flags (one
//      CTA of the shard does it, first of all); each CTA advances its own
//      exchange count (the flag buffer's count slot of the CTA: written only
//      by that CTA, one launch after another, so every CTA of a launch reads
//      the same number, epoch, and a CUDA graph that replays the launch
//      makes real exchanges);
//   2. wait until its own ready flag reaches 2 x epoch, read with acquire:
//      both neighbours have entered this exchange, so every read of the
//      buffers this exchange overwrites is done;
//   3. copy its forward payload to the successor's forward receive buffer
//      and its backward payload to the predecessor's backward receive buffer,
//      16 bytes per access: each thread loads VEC vectors of each direction
//      before it stores any, from read-only sources into distinct
//      destinations (the first round's loads are issued before step 2, since
//      the exchange does not write a shard's own payloads);
//   4. after its copies each CTA adds one, with release, to the arrival
//      counter of both destinations, and waits until its own counter reaches
//      2 x ctas x epoch: both incoming payloads have landed (the reference's
//      fwd.wait() / bwd.wait()).
// The flags only grow.  Every spin is bounded by a timeout on the global
// timer: a CTA that runs out of it sets the error flag (1: the neighbours'
// signals did not come; 2: the incoming payloads did not land) if it is
// still 0, and returns.  The flag stays set; the caller reads it once, after
// its loop of exchanges (dma.check), not after every launch.  The spins need
// every CTA of the grid resident at once; the wrapper keeps the grid at most
// one CTA per SM.
// Scope: every buffer and flag of a launch today lies on one device, so the
// flags are released and acquired at .gpu scope.  The peer-to-peer form,
// with the shards on two cards, needs .sys scope again.
//
// Bound: at the sequence path's edge shape (2 SISOs x 8 states x 4096
// codewords x 4 B = 256 KiB per shard and direction) the bytes take about
// 0.6 us at 3.35 TB/s for two shards; the launch and the two flag round
// trips through L2 set the time.  What the design does about it: one launch
// for both directions of every shard of the mesh; a grid sized so that each
// thread makes one round of VEC loads per direction at that shape (32 CTAs
// per shard of 128 threads); every load of a round in flight before the
// first store, the first round's behind the barrier; a CTA's count read
// beside its first poll of the ready flag, not before it; one add of 2 where
// both neighbours are one shard; no sleep in the spins.  (Measured on an
// H100: the polls read with acquire beat relaxed polls and one fence; the
// pointers passed by value in the launch's parameters instead of the device
// table were slower.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VEC = 4;  // 16-byte vectors per thread and direction a round

__device__ __forceinline__ void red_release_gpu(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *p >= target or the timeout runs out (false then), given the
// value of a first poll.  The timer is read once every 64 polls: a poll that
// finds the flag set returns at once.
__device__ bool wait_geq(const int* p, int first, int target,
                         int64_t timeout_ns) {
  uint64_t t0 = 0;
  for (int k = 0, v = first; v < target; ++k, v = ld_acquire_gpu(p)) {
    if (k % 64) continue;
    const uint64_t t = global_ns();
    if (k == 0) t0 = t;
    else if ((int64_t)(t - t0) > timeout_ns) return false;
  }
  return true;
}

// Add v to the flags of both ring neighbours (one flag, twice, when they
// are the same shard), with release.
__device__ __forceinline__ void signal(int* flag, int nxt, int prv) {
  if (nxt == prv) {
    red_release_gpu(&flag[nxt], 2);
  } else {
    red_release_gpu(&flag[nxt], 1);
    red_release_gpu(&flag[prv], 1);
  }
}

// One round of a thread's copies: VEC vectors of each direction, v0 + k x
// stride for k < VEC, the ones below n_vec.
struct Round {
  int4 f[VEC], b[VEC];

  __device__ __forceinline__ void load(const int4* __restrict__ src_fwd,
                                       const int4* __restrict__ src_bwd,
                                       int64_t v0, int64_t stride,
                                       int64_t n_vec) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int64_t v = v0 + k * stride;
      if (v < n_vec) {
        f[k] = __ldg(src_fwd + v);
        b[k] = __ldg(src_bwd + v);
      }
    }
  }

  __device__ __forceinline__ void store(int4* __restrict__ dst_fwd,
                                        int4* __restrict__ dst_bwd,
                                        int64_t v0, int64_t stride,
                                        int64_t n_vec) const {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int64_t v = v0 + k * stride;
      if (v < n_vec) {
        dst_fwd[v] = f[k];
        dst_bwd[v] = b[k];
      }
    }
  }
};

// grid = n shards x ctas; flags = ready[n], arrived[n], err, count[n * ctas].
// A shard's own payloads are not written by the exchange, so every thread
// loads its first round of them before the barrier, and only the stores
// wait for it.
__global__ void ring_xch_kernel(const int4* const* __restrict__ table,
                                int* flags, int n_seq, int ctas,
                                int64_t n_vec, int64_t timeout_ns) {
  const int n = gridDim.x / ctas;
  const int i = blockIdx.x / ctas, g = blockIdx.x % ctas;
  const int row = i - i % n_seq, s = i % n_seq;
  const int nxt = row + (s + 1) % n_seq, prv = row + (s + n_seq - 1) % n_seq;
  int* ready = flags;
  int* arrived = flags + n;
  int* err = flags + 2 * n;
  int* count = flags + 2 * n + 1;
  __shared__ int ok, epoch;

  // first of all, so that no load of this thread's waits before it
  if (threadIdx.x == 0 && g == 0) signal(ready, nxt, prv);
  const int4* __restrict__ src_fwd = table[i];
  const int4* __restrict__ src_bwd = table[n + i];
  int4* __restrict__ dst_fwd = const_cast<int4*>(table[2 * n + nxt]);
  int4* __restrict__ dst_bwd = const_cast<int4*>(table[3 * n + prv]);
  const int64_t stride = (int64_t)ctas * blockDim.x;
  int64_t v0 = (int64_t)g * blockDim.x + threadIdx.x;
  Round r;
  r.load(src_fwd, src_bwd, v0, stride, n_vec);

  if (threadIdx.x == 0) {
    // the count and a first poll of the flag in flight together (the
    // count's plain load first: the acquire orders only what follows it)
    const int done = count[blockIdx.x];
    const int first = ld_acquire_gpu(&ready[i]);
    epoch = done + 1;
    count[blockIdx.x] = epoch;
    ok = wait_geq(&ready[i], first, 2 * epoch, timeout_ns);
    if (!ok) atomicCAS(err, 0, 1);
  }
  __syncthreads();
  if (!ok) return;

  while (v0 < n_vec) {
    r.store(dst_fwd, dst_bwd, v0, stride, n_vec);
    v0 += VEC * stride;
    r.load(src_fwd, src_bwd, v0, stride, n_vec);
  }
  __syncthreads();

  // the barrier orders every thread's stores before thread 0's release
  // (release is cumulative), as CUTLASS's inter-CTA barrier relies on
  if (threadIdx.x == 0) {
    signal(arrived, nxt, prv);
    if (!wait_geq(&arrived[i], ld_acquire_gpu(&arrived[i]), 2 * ctas * epoch,
                  timeout_ns))
      atomicCAS(err, 0, 2);
  }
}

}  // namespace

// One exchange.  `a` holds nine int64 arguments (read before the launch, so
// the caller may reuse the block at once):
//   a[0] table: device array of 4 * n pointers (src_fwd[n], src_bwd[n],
//        dst_fwd[n], dst_bwd[n]), each buffer n_vec * 16 bytes, 16-byte
//        aligned, sources and destinations distinct;
//   a[1] flags: device int32[2 * n + 1 + n * ctas], zero before the first
//        exchange, and every later exchange on it with the same n and ctas;
//   a[2] n, a[3] n_seq (n % n_seq == 0), a[4] ctas per shard, a[5] n_vec,
//   a[6] threads per CTA, a[7] the spins' timeout in ns, a[8] the
//   cudaStream_t.
// One pointer instead of nine typed arguments keeps the host's cost of the
// call below a microsecond.  Returns the launch's cudaError_t (0 = ok).
extern "C" int turbotpu_ring_xch_launch(const int64_t* a) {
  const int64_t n = a[2], n_seq = a[3], ctas = a[4], threads = a[6];
  if (n <= 0 || n_seq <= 0 || n % n_seq || ctas <= 0 || n * ctas > INT32_MAX ||
      threads <= 0 || threads > 1024 || a[5] < 0)
    return (int)cudaErrorInvalidValue;
  ring_xch_kernel<<<(unsigned)(n * ctas), (unsigned)threads, 0,
                    (cudaStream_t)a[8]>>>((const int4* const*)a[0],
                                          (int*)a[1], (int)n_seq, (int)ctas,
                                          a[5], a[7]);
  return (int)cudaGetLastError();
}
