// HARQ incremental-redundancy combining for Hopper (sm_90a), one launch per
// run of code blocks of one (K, E, F): each block row's E received LLRs,
// sent at its own redundancy version, go into its soft buffer, which is
// kept in the decoder's input layout (ls, lp1, lp2 at the bucket width and
// the two (rows, 6) tails), so the decode reads what the combine wrote.
//
// Replaces no TPU kernel.  The JAX package combines HARQ transmissions by
// de-rate-matching each one and summing them before one decode
// (turbotpu/tx/rate_match_jax.py:95 `de_rate_match_harq_jax`): every
// transmission of a block handed in at once, the whole batch at one
// redundancy version each, and nothing kept between calls.  Here a soft
// buffer lives on the card from one TTI to the next, and one call mixes
// rows at every redundancy version, new data and retransmissions.
//
//   combine_kernel: for each block row r (slot r % m) and each position q of
//     its buffer row (3 bucket + 12 of them), j = table[rv][q] is the index
//     among the first wrap's selected bits of the one that lands on q (-1
//     none, -2 a pinned position: the embedding pad and the fillers of the
//     systematic stream).  The received sum at q is llr[r, j] + llr[r, j +
//     period] + ... wrap after wrap, in the order de_rate_match adds them
//     (a wrap's missing tail adds 0, as its padding does there).  A
//     new-data row writes the sum, 0 where nothing lands and BIG where
//     pinned; a retransmission row adds the sum where something lands and
//     leaves the rest.
//
// Bound: bytes.  One fp32 add a received bit.  At the PUSCH cell's shape (K =
// 5824, E = 6642 / 6648, 512 slots) a new-data row reads 4E and writes 4 (3K +
// 12) bytes, a retransmission reads 4E and reads and writes 4 bytes at each of
// its E distinct positions.  What the design does about it: a block takes one
// block row; it reads the row's received LLRs once, in order, into shared
// memory (26.6 KB, so eight blocks fit an SM; rows of more than STAGE_MAX LLRs
// are gathered from device memory instead), then walks the buffer row's
// positions in order, UNROLL of them a thread at once, so the table and the
// buffer are read and written in whole lines and the scattered reads of the
// redundancy version's selection fall on shared memory.  A first version that
// gathered the received LLRs from device memory, 256 positions a block, moved
// 22% of the bytes the bound allows.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;        // positions a thread has in flight
constexpr int STAGE_MAX = 12288; // received LLRs a block stages (48 KB,
                                 // the most without an opt-in)
constexpr int TAIL_COLS = 6;

struct CombineArgs {
  const float* llr;             // (rows, E) fp32
  const int64_t* rv;            // (m,) redundancy version of each slot
  const uint8_t* fresh;         // (m,) new data (bool)
  const int32_t* table;         // (4, Q) int32, Q = 3 bucket + 12
  float* out[5];                // ls, lp1, lp2 (rows, bucket); t1, t2
  int m, E, period, n_wraps, bucket, Q;
  float big;
};

// the received sum at index j of the first wrap, wrap after wrap
__device__ __forceinline__ float received(const float* in, int j,
                                          const CombineArgs& a) {
  float s = in[j];
  for (int w = 1; w < a.n_wraps; ++w) {
    const int k = j + w * a.period;
    s = __fadd_rn(s, k < a.E ? in[k] : 0.f);
  }
  return s;
}

// positions [0, n) of one stream of the row: dst[c] from table entry t[c]
__device__ __forceinline__ void walk(float* __restrict__ dst,
                                     const int32_t* __restrict__ t, int n,
                                     bool fresh, const float* in,
                                     const CombineArgs& a) {
  for (int c0 = threadIdx.x; c0 < n; c0 += THREADS * UNROLL) {
    int j[UNROLL];
    float old[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = c0 + u * THREADS;
      j[u] = c < n ? t[c] : -1;
    }
    if (!fresh) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        old[u] = j[u] >= 0 ? dst[c0 + u * THREADS] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = c0 + u * THREADS;
      if (j[u] >= 0) {
        const float s = received(in, j[u], a);
        dst[c] = fresh ? s : __fadd_rn(old[u], s);
      } else if (fresh && c < n) {
        dst[c] = j[u] == -2 ? a.big : 0.f;
      }
    }
  }
}

template <bool STAGED>
__global__ void __launch_bounds__(THREADS) combine_kernel(CombineArgs a) {
  extern __shared__ float stage[];     // STAGED: the row's E LLRs
  const int64_t r = blockIdx.x;
  const int slot = (int)(r % a.m);
  const bool fresh = a.fresh[slot] != 0;
  const int32_t* tab = a.table + (int64_t)(a.rv[slot] & 3) * a.Q;
  const float* src = a.llr + r * a.E;
  if (STAGED) {
    for (int i = threadIdx.x; i < a.E; i += THREADS) stage[i] = src[i];
    __syncthreads();
  }
  const float* in = STAGED ? stage : src;
#pragma unroll
  for (int s = 0; s < 3; ++s)
    walk(a.out[s] + r * a.bucket, tab + s * a.bucket, a.bucket, fresh, in, a);
  walk(a.out[3] + r * TAIL_COLS, tab + 3 * a.bucket, TAIL_COLS, fresh, in,
       a);
  walk(a.out[4] + r * TAIL_COLS, tab + 3 * a.bucket + TAIL_COLS, TAIL_COLS,
       fresh, in, a);
}

}  // namespace

// One pointer to a block of int64 arguments, read before the launch (the
// caller may reuse the block at once); returns the launch's cudaError_t (0 =
// ok).  Every tensor is contiguous, on the stream's device, and overlaps no
// other; the rows of the five outputs are the block rows of llr.
//
// 16 arguments: a[0] llr (rows, E) fp32; a[1] rv (m,) int64; a[2] new (m,)
// bool; a[3] table (4, 3 bucket + 12) int32; a[4..8] ls, lp1, lp2 (rows,
// bucket) and tail1, tail2 (rows, 6) fp32; a[9] rows, a multiple of m;
// a[10] m; a[11] E; a[12] the period (distinct positions of a wrap, at
// most E); a[13] bucket; a[14] the bits of BIG as a double; a[15] the
// cudaStream_t.
extern "C" int turbotpu_harq_combine_launch(const int64_t* a) {
  const int64_t rows = a[9], m = a[10], E = a[11], period = a[12],
                bucket = a[13];
  if (rows <= 0 || m <= 0 || rows % m != 0 || period <= 0 || E < period ||
      E > INT32_MAX / 2 || bucket <= 0 || 3 * bucket + 12 > INT32_MAX ||
      rows > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  double big;
  memcpy(&big, &a[14], sizeof big);
  CombineArgs c;
  c.llr = (const float*)a[0];
  c.rv = (const int64_t*)a[1];
  c.fresh = (const uint8_t*)a[2];
  c.table = (const int32_t*)a[3];
  for (int s = 0; s < 5; ++s) c.out[s] = (float*)a[4 + s];
  c.m = (int)m, c.E = (int)E, c.period = (int)period;
  c.n_wraps = (int)((E + period - 1) / period);
  c.bucket = (int)bucket, c.Q = (int)(3 * bucket + 12);
  c.big = (float)big;
  cudaStream_t st = (cudaStream_t)a[15];
  if (E <= STAGE_MAX)
    combine_kernel<true><<<(unsigned)rows, THREADS, E * sizeof(float), st>>>(
        c);
  else
    combine_kernel<false><<<(unsigned)rows, THREADS, 0, st>>>(c);
  return (int)cudaGetLastError();
}
