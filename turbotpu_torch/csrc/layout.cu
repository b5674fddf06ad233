// The decoder's two layout crossings for Hopper (sm_90a), one launch each:
// the public (B, K) codeword-major tensors into the kernels' time-major
// (KTp, B) streams before the loop, and the loop's time-major extrinsics
// back into the (B, K) LLR and hard bits after it; and the CRC early exit
// that runs between them once an iteration (exit_kernel, below), with the
// live prefix's close and column moves (live_close_kernel, compact_kernel).
//
// Replaces no TPU kernel.  The JAX package leaves both crossings to XLA
// (turbotpu/decoder/turbo_cells.py:120 `stream`: concatenate, pad, astype
// and transpose per stream; :186 `full_llr` and the transposes after the
// loop), which fuses each into one pass.  PyTorch runs them as some twenty-five separate
// operations (cat, pad, cast, strided transpose copies, five fp32 (K, B)
// temporaries for L), each a full pass over device memory, so the two
// crossings are written here as the one pass each that XLA made of them.
//
//   pack_kernel:   ls1, lp1s, lp2s (KTp, B) from ls, lp1, lp2 (B, K) fp32
//                  and the (B, 6) tails: body rows [0, K) the inputs
//                  transposed, rows K..K+2 tail[:, off + 2j], rows from K+3
//                  the pad, each stream's tail, off and pad as the caller
//                  gives them (BIG on systematic streams, 0 on parity);
//                  ls2's tail and pad rows.  ls2's body is ls1's rows
//                  gathered by the interleaver, left to the caller's row
//                  gather.
//   unpack_kernel: L = ls + deq * (le1 + le21) (fp32, in that order, each
//                  step rounded as PyTorch rounds it) and hard = (L < 0),
//                  both (B, K), from rows [0, K) of the (KTp, B) streams;
//                  in the live prefix (below) each iteration, for the
//                  working columns that retire, into their codewords' rows.
//
// Bound: bytes.  There is no arithmetic beyond one cast (pack) or three
// fp32 operations (unpack) an element.  At B=16384, K=6144 with bf16
// streams pack reads 1.21 GB and writes 0.84 GB less ls2's body (0.61 ms at
// 3.35 TB/s), unpack reads 0.40 GB and writes 0.50 GB (0.27 ms).  What the
// design does about it: every element is read once and written once, and
// both sides of the transpose go to device memory in full 128-byte lines.
// A block moves a tile of 64 time steps x 64 codewords through shared
// memory: a (B, K) row is read or written 16 bytes a thread along K (four
// fp32), a (KTp, B) row 16 bytes a thread along B (eight bf16 or four fp32)
// when the shapes and pointers allow it, and element by element at a
// ragged edge.  The tile's rows are padded by one 4-byte word, so the
// column side of the transpose meets at most two-way bank conflicts.  The
// tiles of pack hold one stream at a time (8.4 KB for bf16, 16.6 KB for
// fp32), so eight blocks of 256 threads fit an SM.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

namespace {

constexpr int TILE = 64;        // time steps x codewords of a block's tile
constexpr int THREADS = 256;
constexpr int TAIL_COLS = 6;    // (B, 6) tails: x, p, x, p, x, p

// ---- element types -------------------------------------------------------
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 v) { return float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
// round to nearest even, as torch's .to(torch.bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int BYTES> struct VecOf;
template <> struct VecOf<4> { using type = uint32_t; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<16> { using type = uint4; };

// n consecutive elements at p as one aligned vector access
template <int N, typename T>
__device__ __forceinline__ void load_vec(T (&v)[N], const T* p) {
  using V = typename VecOf<N * sizeof(T)>::type;
  const V q = *reinterpret_cast<const V*>(p);
  memcpy(v, &q, sizeof(V));
}
template <int N, typename T>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[N]) {
  using V = typename VecOf<N * sizeof(T)>::type;
  V q;
  memcpy(&q, v, sizeof(V));
  *reinterpret_cast<V*>(p) = q;
}

bool aligned(const void* p, int bytes) {
  return (uintptr_t)p % (uintptr_t)bytes == 0;
}

// ---- pack ----------------------------------------------------------------
struct PackArgs {
  const float* body[3];      // ls, lp1, lp2: (B, K) fp32
  const float* tail[4];      // the tail of each output: (B, 6) fp32
  int tail_off[4];           // its first column: rows K + j read 2j + off
  float pad[4];              // the value of rows K + 3 up
  void* out[4];              // ls1, lp1s, lp2s, ls2: (KTp, B)
  int B, K, KTp;
  bool vec_in;               // 16-byte loads along K
  bool vec_out;              // 16-byte stores along B
};

template <typename Out>
__global__ void __launch_bounds__(THREADS) pack_kernel(PackArgs a) {
  // [codeword][step], rows padded by one 4-byte word
  __shared__ Out tile[TILE][TILE + 4 / sizeof(Out)];
  constexpr int V = 16 / sizeof(Out);   // codewords a thread stores
  constexpr int XS = TILE / V;          // threads along a stored row
  const int t0 = blockIdx.x * TILE, b0 = blockIdx.y * TILE;
  const int tid = threadIdx.x;
  for (int s = 0; s < 4; ++s) {
    // ls2 (s == 3) has no body here; a tile past K has none either
    if (s < 3 && t0 < a.K) {
      __syncthreads();      // the last stream's reads of the tile are done
      const int tl = 4 * (tid % 16);
      const int t = t0 + tl;
      for (int r = tid / 16; r < TILE; r += THREADS / 16) {
        const int b = b0 + r;
        if (b >= a.B) break;
        const float* src = a.body[s] + (int64_t)b * a.K + t;
        float v[4];
        if (a.vec_in && t + 3 < a.K) {
          load_vec(v, src);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = t + i < a.K ? src[i] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) tile[r][tl + i] = from_f<Out>(v[i]);
      }
      __syncthreads();
    }
    if (s == 3 && t0 + TILE <= a.K) break;
    Out* __restrict__ out = (Out*)a.out[s];
    const float* __restrict__ tail = a.tail[s];
    const Out pad = from_f<Out>(a.pad[s]);
    const int bl = V * (tid % XS);
    const int b = b0 + bl;
    if (b >= a.B) continue;
    for (int r = tid / XS; r < TILE; r += THREADS / XS) {
      const int t = t0 + r;
      if (t >= a.KTp) break;
      if (s == 3 && t < a.K) continue;
      Out v[V];
      if (t < a.K) {
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = tile[bl + i][r];
      } else if (t < a.K + 3) {
        const int col = 2 * (t - a.K) + a.tail_off[s];
#pragma unroll
        for (int i = 0; i < V; ++i)
          v[i] = b + i < a.B
                     ? from_f<Out>(tail[(int64_t)(b + i) * TAIL_COLS + col])
                     : pad;
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = pad;
      }
      Out* dst = out + (int64_t)t * a.B + b;
      if (a.vec_out && b + V <= a.B) {
        store_vec(dst, v);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i)
          if (b + i < a.B) dst[i] = v[i];
      }
    }
  }
}

template <typename Out>
cudaError_t launch_pack(PackArgs a, cudaStream_t st) {
  a.vec_in = a.K % 4 == 0;
  for (int s = 0; s < 3; ++s) a.vec_in = a.vec_in && aligned(a.body[s], 16);
  a.vec_out = a.B % (16 / sizeof(Out)) == 0;
  for (int s = 0; s < 4; ++s) a.vec_out = a.vec_out && aligned(a.out[s], 16);
  const dim3 grid((a.KTp + TILE - 1) / TILE, (a.B + TILE - 1) / TILE);
  pack_kernel<Out><<<grid, THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

// ---- unpack --------------------------------------------------------------
struct UnpackArgs {
  const void* ls;            // (KTp, B) channel stream
  const void* le1;           // (KTp, B) extrinsic streams
  const void* le21;
  float* L;                  // (B, K) fp32
  int8_t* hard;              // (B, K)
  // the live prefix, or all null: the first *count columns are working
  // columns, column j codeword col[j]; it retires where synd[j] == 0 or on
  // the last iteration, and only those columns are written, into row col[j]
  const uint32_t* synd;
  const int32_t* col;
  const int32_t* count;
  int B, K;
  float deq;
  bool last;
  bool vec_in;               // 4-element loads along B
  bool vec_out;              // 16-byte L, 4-byte hard stores along K
};

// whether working column j writes its outputs (every column without a
// live prefix)
__device__ __forceinline__ bool retires(const UnpackArgs& a, int j) {
  return !a.synd || a.last || a.synd[j] == 0;
}

template <typename Chan, typename Ext>
__global__ void __launch_bounds__(THREADS) unpack_kernel(UnpackArgs a) {
  __shared__ float tile[TILE][TILE + 1];       // [step][codeword]
  const int t0 = blockIdx.x * TILE, b0 = blockIdx.y * TILE;
  const int n = a.count ? *a.count : a.B;
  if (b0 >= n) return;        // the whole block past the live prefix
  const int tid = threadIdx.x;
  const Chan* __restrict__ ls = (const Chan*)a.ls;
  const Ext* __restrict__ e1 = (const Ext*)a.le1;
  const Ext* __restrict__ e21 = (const Ext*)a.le21;
  {
    const int bl = 4 * (tid % 16);
    const int b = b0 + bl;
    bool any = false;         // a column of the four is written
#pragma unroll
    for (int i = 0; i < 4; ++i) any |= b + i < n && retires(a, b + i);
    for (int r = tid / 16; r < TILE && any; r += THREADS / 16) {
      const int t = t0 + r;
      if (t >= a.K) break;
      const int64_t o = (int64_t)t * a.B + b;
      Chan x[4];
      Ext y[4], z[4];
      if (a.vec_in && b + 3 < a.B) {
        load_vec(x, ls + o);
        load_vec(y, e1 + o);
        load_vec(z, e21 + o);
      } else {      // past B, lane i repeats codeword b (never stored)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int64_t j = o + (b + i < a.B ? i : 0);
          x[i] = ls[j], y[i] = e1[j], z[i] = e21[j];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tile[r][bl + i] = __fadd_rn(
            to_f(x[i]), __fmul_rn(a.deq, __fadd_rn(to_f(y[i]), to_f(z[i]))));
    }
  }
  __syncthreads();
  const int tl = 4 * (tid % 16);
  const int t = t0 + tl;
  if (t >= a.K) return;
  for (int r = tid / 16; r < TILE; r += THREADS / 16) {
    const int b = b0 + r;
    if (b >= n) break;
    if (!retires(a, b)) continue;
    float v[4];
    int8_t h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = tile[tl + i][r];
      h[i] = v[i] < 0.f;
    }
    const int64_t o = (int64_t)(a.col ? a.col[b] : b) * a.K + t;
    if (a.vec_out && t + 3 < a.K) {
      store_vec(a.L + o, v);
      store_vec(a.hard + o, h);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (t + i < a.K) a.L[o + i] = v[i], a.hard[o + i] = h[i];
    }
  }
}

template <typename Chan, typename Ext>
cudaError_t launch_unpack(UnpackArgs a, int N, cudaStream_t st) {
  a.vec_in = a.B % 4 == 0 && aligned(a.ls, 4 * sizeof(Chan)) &&
             aligned(a.le1, 4 * sizeof(Ext)) &&
             aligned(a.le21, 4 * sizeof(Ext));
  a.vec_out = a.K % 4 == 0 && aligned(a.L, 16) && aligned(a.hard, 4);
  const dim3 grid((a.K + TILE - 1) / TILE, (N + TILE - 1) / TILE);
  unpack_kernel<Chan, Ext><<<grid, THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename Chan>
cudaError_t unpack_ext(int ext, UnpackArgs a, int N, cudaStream_t st) {
  switch (ext) {
    case 0: return launch_unpack<Chan, float>(a, N, st);
    case 1: return launch_unpack<Chan, __nv_bfloat16>(a, N, st);
    case 2: return launch_unpack<Chan, int8_t>(a, N, st);
    case 3: return launch_unpack<Chan, __nv_fp8_e4m3>(a, N, st);
  }
  return cudaErrorInvalidValue;
}

// ---- CRC early exit -------------------------------------------------------
// One iteration's verdicts and freezes of the `crc` loop, in the time-major
// layout, in place of the PyTorch chain of `crc_exit_plain`
// (decoder/layout.py): L and its sign, a (B, K) @ (K, 24) fp32 matmul for
// the syndrome, two torch.where freezes, some twenty launches and 2.6 GB an
// iteration at B=6656, K=5824.
//
// Replaces no TPU kernel.  The JAX loop's syndrome (`dot_general`) and
// freezes (turbotpu/decoder/turbo_cells.py:251-267) are fused by XLA.
//
//   exit_kernel:       for each codeword not done before this iteration,
//                      hard = (ls + deq * (le1n + le21n) < 0) on rows
//                      [0, K), L in fp32 in unpack_kernel's order, and the
//                      syndrome as the XOR of the 24-bit check mask of every
//                      row whose hard bit is 1 (the CRC is linear over
//                      GF(2), so XOR is exact and order-free: the result
//                      equals (hard @ H) mod 2 whatever the blocks' order);
//                      for each codeword done before, the carried le1 and
//                      le21 written over its new buffers on all KTp rows.
//                      A block takes 128 codewords (4 a thread, the warp's
//                      lanes along B) and a chunk of rows (its 8 warps take
//                      every 8th); its partial syndromes meet in shared
//                      memory and reach the (B,) syndrome by atomicXor.
//   exit_close_kernel: one block over B: iters += !done, done |= (synd ==
//                      0), synd = 0 for the next iteration, and done.all()
//                      into the flag that the loop copies to the host.
//
// Bound: bytes.  A live codeword reads 4 bytes a row at bf16 + int8 (K rows
// of the channel and both extrinsics), a frozen one reads and writes 2 a row
// on KTp rows: at B=6656, K=5824 about 155 MB an iteration, 0.046 ms at
// 3.35 TB/s.  What the design does about it: each element is read once, in
// 4-codeword vectors (8 + 4 + 4 bytes at bf16 + int8) that a warp's lanes
// lay side by side along B, with the loads of four rows in flight a thread
// before any is used; a vector of codewords all live skips the freeze, one
// all done skips the LLR, and one that mixes them (the dearest case: it
// reads both and merges the freeze in registers, one store a stream) still
// writes whole vectors; no (K, B) temporary is written.  The grid adapts to
// the shape it is given: blocks of 128 codewords across B, and enough
// chunks of rows (at least 32 a chunk) for EXIT_BLOCKS_PER_SM blocks an SM,
// so B=13 and B=6656 both spread over every SM.
constexpr int EXIT_V = 4;                       // codewords a thread
constexpr int EXIT_COLS = 32 * EXIT_V;          // codewords a block
constexpr int EXIT_WARPS = THREADS / 32;
constexpr int EXIT_MIN_ROWS = 32;               // rows a chunk, at least
constexpr int EXIT_ROWS = 4;                    // rows in flight a thread
// Blocks an SM the grid aims at, more than stay resident: the SMs take the
// chunks as they free up, which evens out cheap blocks (every codeword done,
// or every one live) beside mixed ones.  On an H100 80GB HBM3 at B=6656,
// K=5824 with half the codewords done, one wave sized by the occupancy API
// took 0.17 ms a call, this grid 0.14.
constexpr int EXIT_BLOCKS_PER_SM = 8;
constexpr int CLOSE_THREADS = 1024;

struct ExitArgs {
  const int* count;          // the live prefix's length, or null (below)
  const void* ls;            // (KTp, B) channel stream
  void* le1n;                // (KTp, B) this iteration's le1 (frozen here)
  const void* le21n;         // (KTp, B) this iteration's le21, natural order
  const void* le1;           // (KTp, B) the carry before this iteration
  const void* le21;
  void* f21;                 // (KTp, B) le21's new buffer, frozen here
  const uint8_t* done;       // (B,) bool, before this iteration (no count)
  const uint32_t* masks;     // (K,) the check bits of row t
  uint32_t* synd;            // (B,) 0 on entry
  int B, K, KTp;
  int rows;                  // rows a block's chunk
  float deq;
  bool vec;                  // 4-codeword vector access
};

// With a count (the live-prefix loop, decoder/turbo_cells.py) the columns
// are the loop's working set: the first *count hold codewords not done
// yet, in any order, and nothing is frozen; exit_kernel forms their
// syndromes alone, and live_close_kernel (below) closes the iteration.

// Rows t, t + EXIT_WARPS, ... (R of them) of codewords b .. b + EXIT_V - 1:
// the sign of L XORed into the syndromes of the live ones, every load of
// the R rows issued before the first use.
template <int R, typename Chan, typename Ext>
__device__ __forceinline__ void llr_rows(const ExitArgs& a, int t, int b,
                                         bool full,
                                         const bool (&live)[EXIT_V],
                                         uint32_t (&s)[EXIT_V]) {
  const Chan* __restrict__ ls = (const Chan*)a.ls;
  const Ext* e1n = (const Ext*)a.le1n;
  const Ext* e21n = (const Ext*)a.le21n;
  Chan x[R][EXIT_V];
  Ext y[R][EXIT_V], z[R][EXIT_V];
  uint32_t m[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int tr = t + r * EXIT_WARPS;
    const int64_t o = (int64_t)tr * a.B + b;
    if (full) {
      load_vec(x[r], ls + o);
      load_vec(y[r], e1n + o);
      load_vec(z[r], e21n + o);
    } else {      // past B, lane i repeats codeword b (never counted)
#pragma unroll
      for (int i = 0; i < EXIT_V; ++i) {
        const int64_t j = o + (b + i < a.B ? i : 0);
        x[r][i] = ls[j], y[r][i] = e1n[j], z[r][i] = e21n[j];
      }
    }
    m[r] = a.masks[tr];
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < EXIT_V; ++i) {
      const float L = __fadd_rn(
          to_f(x[r][i]),
          __fmul_rn(a.deq, __fadd_rn(to_f(y[r][i]), to_f(z[r][i]))));
      if (live[i] && L < 0.f) s[i] ^= m[r];
    }
}

// The same rows' freeze: the carried le1 and le21 written over the new
// buffers on the codewords done before.  A vector of codewords that mixes
// done and live ones is merged in registers and stored whole (a live
// codeword gets its own bytes back).
template <int R, typename Ext>
__device__ __forceinline__ void freeze_rows(const ExitArgs& a, int t, int b,
                                            bool full, bool all_frozen,
                                            const bool (&frozen)[EXIT_V]) {
  const Ext* __restrict__ e1 = (const Ext*)a.le1;
  const Ext* __restrict__ e21 = (const Ext*)a.le21;
  Ext* f1 = (Ext*)a.le1n;
  Ext* f21 = (Ext*)a.f21;
  if (!full) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t o = (int64_t)(t + r * EXIT_WARPS) * a.B + b;
#pragma unroll
      for (int i = 0; i < EXIT_V; ++i)
        if (frozen[i]) f1[o + i] = e1[o + i], f21[o + i] = e21[o + i];
    }
    return;
  }
  Ext v1[R][EXIT_V], v21[R][EXIT_V], n1[R][EXIT_V], n21[R][EXIT_V];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t o = (int64_t)(t + r * EXIT_WARPS) * a.B + b;
    load_vec(v1[r], e1 + o);
    load_vec(v21[r], e21 + o);
    if (!all_frozen) {
      load_vec(n1[r], f1 + o);
      load_vec(n21[r], f21 + o);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t o = (int64_t)(t + r * EXIT_WARPS) * a.B + b;
    if (!all_frozen) {
#pragma unroll
      for (int i = 0; i < EXIT_V; ++i)
        if (!frozen[i]) v1[r][i] = n1[r][i], v21[r][i] = n21[r][i];
    }
    store_vec(f1 + o, v1[r]);
    store_vec(f21 + o, v21[r]);
  }
}

template <typename Chan, typename Ext>
__global__ void __launch_bounds__(THREADS) exit_kernel(ExitArgs a) {
  __shared__ uint32_t part[EXIT_WARPS][EXIT_COLS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c0 = blockIdx.x * EXIT_COLS;
  const int n = a.count ? *a.count : a.B;
  if (c0 >= n) return;        // the whole block past the live prefix
  const int b = c0 + EXIT_V * lane;
  const int r0 = blockIdx.y * a.rows;
  const int r1 = min(r0 + a.rows, a.KTp);
  const bool full = a.vec && b + EXIT_V <= a.B;
  // In place: le21n may be f21 (the carry in natural order).  A thread
  // reads and writes only its own codewords, and reads a row's le21n
  // before it writes the row.
  bool live[EXIT_V], frozen[EXIT_V];
  uint32_t s[EXIT_V];
  bool any_live = false, any_frozen = false, all_frozen = true;
#pragma unroll
  for (int i = 0; i < EXIT_V; ++i) {
    const bool in = b + i < n;
    const bool d = in && !a.count && a.done[b + i];
    live[i] = in && !d, frozen[i] = d, s[i] = 0;
    any_live |= live[i], any_frozen |= d, all_frozen &= d;
  }
  constexpr int STEP = EXIT_ROWS * EXIT_WARPS;
  if (any_live) {
    const int end = min(r1, a.K);
    int t = r0 + warp;
    for (; t + STEP - EXIT_WARPS < end; t += STEP)
      llr_rows<EXIT_ROWS, Chan, Ext>(a, t, b, full, live, s);
    for (; t < end; t += EXIT_WARPS)
      llr_rows<1, Chan, Ext>(a, t, b, full, live, s);
  }
  if (any_frozen) {
    int t = r0 + warp;
    for (; t + STEP - EXIT_WARPS < r1; t += STEP)
      freeze_rows<EXIT_ROWS, Ext>(a, t, b, full, all_frozen, frozen);
    for (; t < r1; t += EXIT_WARPS)
      freeze_rows<1, Ext>(a, t, b, full, all_frozen, frozen);
  }
#pragma unroll
  for (int i = 0; i < EXIT_V; ++i) part[warp][EXIT_V * lane + i] = s[i];
  __syncthreads();
  if (threadIdx.x < EXIT_COLS) {
    uint32_t x = 0;
#pragma unroll
    for (int w = 0; w < EXIT_WARPS; ++w) x ^= part[w][threadIdx.x];
    if (x != 0) atomicXor(a.synd + c0 + threadIdx.x, x);   // only live
  }
}

__global__ void __launch_bounds__(CLOSE_THREADS) exit_close_kernel(
    uint8_t* done, int32_t* iters, uint32_t* synd, uint8_t* all_done,
    int B) {
  int all = 1;
  for (int b = threadIdx.x; b < B; b += CLOSE_THREADS) {
    const bool d = done[b];
    const bool now = d || synd[b] == 0;
    if (!d) iters[b] += 1;
    done[b] = now;
    synd[b] = 0;
    all &= now;
  }
  all = __syncthreads_and(all);
  if (threadIdx.x == 0) *all_done = all != 0;
}

template <typename Chan, typename Ext>
cudaError_t launch_exit(ExitArgs a, int N, uint8_t* done, int32_t* iters,
                        uint8_t* all_done, cudaStream_t st) {
  a.vec = a.B % EXIT_V == 0 && aligned(a.ls, EXIT_V * sizeof(Chan)) &&
          aligned(a.done, EXIT_V);
  for (const void* p : {(const void*)a.le1n, a.le21n, a.le1, a.le21,
                        (const void*)a.f21})
    a.vec = a.vec && aligned(p, EXIT_V * sizeof(Ext));
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // chunks of rows: EXIT_BLOCKS_PER_SM blocks an SM, no chunk under
  // EXIT_MIN_ROWS rows, rows a multiple of the warps
  const int64_t cols = (N + EXIT_COLS - 1) / EXIT_COLS;
  int64_t chunks = (EXIT_BLOCKS_PER_SM * (int64_t)sms + cols - 1) / cols;
  chunks = std::min(chunks, (int64_t)(a.KTp + EXIT_MIN_ROWS - 1) /
                                EXIT_MIN_ROWS);
  chunks = std::max<int64_t>(1, std::min<int64_t>(chunks, 65535));
  int64_t rows = (a.KTp + chunks - 1) / chunks;
  rows = (rows + EXIT_WARPS - 1) / EXIT_WARPS * EXIT_WARPS;
  a.rows = (int)rows;
  const dim3 grid((unsigned)cols, (unsigned)((a.KTp + rows - 1) / rows));
  exit_kernel<Chan, Ext><<<grid, THREADS, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.count) return err;
  exit_close_kernel<<<1, CLOSE_THREADS, 0, st>>>(done, iters, a.synd,
                                                 all_done, a.B);
  return cudaGetLastError();
}

template <typename Chan>
cudaError_t exit_ext(int ext, ExitArgs a, int N, uint8_t* done,
                     int32_t* iters, uint8_t* all_done, cudaStream_t st) {
  switch (ext) {
    case 0: return launch_exit<Chan, float>(a, N, done, iters, all_done, st);
    case 1:
      return launch_exit<Chan, __nv_bfloat16>(a, N, done, iters, all_done,
                                              st);
    case 2:
      return launch_exit<Chan, int8_t>(a, N, done, iters, all_done, st);
    case 3:
      return launch_exit<Chan, __nv_fp8_e4m3>(a, N, done, iters, all_done,
                                              st);
  }
  return cudaErrorInvalidValue;
}

// ---- the live prefix ------------------------------------------------------
// The `crc` loop with one shared interleaver table keeps the codewords not
// yet done in the first n columns of its working set (every (rows, B)
// stream it carries, B the pitch); `col` (B,) int32 names the codeword of
// each working column.  After each iteration's syndromes, the columns that
// retire (passed, or all on the last iteration) write their outputs
// (unpack_kernel with a live prefix), and then:
//
//   live_close_kernel: one block over the n columns: iters[col[j]] += 1,
//                      done[col[j]] = (synd[j] == 0), synd[j] = 0; n' = the
//                      columns that stay.  It lists the moves: the k-th
//                      retired column below n' (a hole) takes the k-th
//                      staying column at or above n' (a source), so the two
//                      sets are disjoint and the moves are at most the
//                      codewords done now; col follows the moves, and state
//                      = (n', retired, moves).
//   compact_kernel:    copies columns of (rows, B) arrays along the list of
//                      (source, hole) pairs, whose length m is on the card:
//                      a warp takes 32 pairs (a lane each) on COMPACT_ROWS
//                      rows of one array, and the grid strides over every
//                      such item; every array the loop carries, in place.
//
// Bound: bytes.  A move reads and writes one element a row of every
// carried array (at bf16 + int8 with NII: 9 bytes a row of KTp and 8 fp32
// a window); at B=6656, K=5824 a batch of cell 3 moves about 2600 columns,
// about 0.28 GB read and written, 0.08 ms at 3.35 TB/s.  What the design
// does about it: the lists
// are ascending, so the 32 columns a warp touches in a row lie close
// together and share 32-byte sectors; each lane has COMPACT_ROWS loads in
// flight before it stores, and the items of every row and pair spread over
// a grid of COMPACT_BLOCKS_PER_SM blocks an SM (a warp walking all m pairs
// of its rows in turn was bound by that chain's latency: 0.95 ms a batch
// of cell 3 on an H100).  The close is latency: one block, 8 columns a
// thread between two block-wide scans, so B <= 8192 is one round.
constexpr int COMPACT_ROWS = 8;        // rows an item, loads in flight
constexpr int COMPACT_BLOCKS_PER_SM = 8;
constexpr int COMPACT_JOBS = 8;        // arrays a launch, at most
constexpr int CLOSE_ITEMS = 8;         // columns a thread of the close
constexpr int CLOSE_WARPS = CLOSE_THREADS / 32;

// The exclusive prefix sum of v over the block of CLOSE_THREADS threads,
// and the block's total; sh holds CLOSE_WARPS ints.
__device__ __forceinline__ int block_scan(int v, int* sh, int& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = sh[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    sh[lane] = w;
  }
  __syncthreads();
  const int before = warp ? sh[warp - 1] : 0;
  total = sh[CLOSE_WARPS - 1];
  __syncthreads();            // sh is free for the next scan
  return before + x - v;
}

// lists: (2, B) int32, rows: the moves' source and hole
__global__ void __launch_bounds__(CLOSE_THREADS) live_close_kernel(
    uint8_t* done, int32_t* iters, int32_t* col, uint32_t* synd,
    int32_t* state, int32_t* lists, int B, int last) {
  static_assert(CLOSE_WARPS == 32, "block_scan scans 32 warp sums");
  __shared__ int sh[CLOSE_WARPS];
  int32_t* mv_from = lists;
  int32_t* mv_to = lists + B;
  const int n = state[0];
  constexpr int CHUNK = CLOSE_THREADS * CLOSE_ITEMS;
  const int j0 = CLOSE_ITEMS * threadIdx.x;
  // the verdicts; synd[j] holds whether column j retires until the moves
  int n_ret = 0;
  for (int base = 0; base < n; base += CHUNK) {
    int mine = 0;
#pragma unroll
    for (int i = 0; i < CLOSE_ITEMS; ++i) {
      const int j = base + j0 + i;
      if (j < n) {
        const bool ok = synd[j] == 0;
        const int c = col[j];
        iters[c] += 1;
        done[c] = ok;
        synd[j] = ok || last;
        mine += ok || last;
      }
    }
    int total;
    block_scan(mine, sh, total);
    n_ret += total;
  }
  const int stay = n - n_ret;
  // the holes below stay, the sources from stay up, each in ascending order
  int n_mv = 0, n_src = 0;
  for (int base = 0; base < n; base += CHUNK) {
    bool hole[CLOSE_ITEMS], src[CLOSE_ITEMS];
    int holes = 0, srcs = 0;
#pragma unroll
    for (int i = 0; i < CLOSE_ITEMS; ++i) {
      const int j = base + j0 + i;
      hole[i] = src[i] = false;
      if (j < n) {
        const bool r = synd[j] != 0;
        synd[j] = 0;
        hole[i] = j < stay && r;
        src[i] = j >= stay && !r;
        holes += hole[i], srcs += src[i];
      }
    }
    int t_holes, t_srcs;
    int h = n_mv + block_scan(holes, sh, t_holes);
    int g = n_src + block_scan(srcs, sh, t_srcs);
#pragma unroll
    for (int i = 0; i < CLOSE_ITEMS; ++i) {
      if (hole[i]) mv_to[h++] = base + j0 + i;
      if (src[i]) mv_from[g++] = base + j0 + i;
    }
    n_mv += t_holes, n_src += t_srcs;
  }
  __syncthreads();            // the lists are written
  // holes and sources are disjoint: no column is read after it is written
  for (int k = threadIdx.x; k < n_mv; k += CLOSE_THREADS)
    col[mv_to[k]] = col[mv_from[k]];
  if (threadIdx.x == 0) {
    state[0] = stay;
    state[1] = n_ret;
    state[2] = n_mv;
  }
}

struct CompactJob {
  const char* src;           // (rows, B) elements of `size` bytes
  char* dst;                 // the same shape; src itself for a move
  int rows, size;
};

struct CompactArgs {
  CompactJob job[COMPACT_JOBS];
  int first[COMPACT_JOBS + 1];   // each job's first row group; last: all
  int n_jobs;
  const int32_t* from;       // (B,) source columns
  const int32_t* to;         // (B,) destination columns
  const int32_t* count;      // the pairs' number, on the card
  int64_t B;
};

// Pair k (k < m) on rows t0 .. t0 + COMPACT_ROWS - 1 of one array.
template <typename T>
__device__ __forceinline__ void copy_column(const CompactArgs& a,
                                            const CompactJob& jb, int t0,
                                            int k) {
  const T* src = (const T*)jb.src;
  T* dst = (T*)jb.dst;
  const int rows = min(COMPACT_ROWS, jb.rows - t0);
  const int64_t f = a.from[k], d = a.to[k];
  T v[COMPACT_ROWS];
#pragma unroll
  for (int r = 0; r < COMPACT_ROWS; ++r)
    if (r < rows) v[r] = src[(int64_t)(t0 + r) * a.B + f];
#pragma unroll
  for (int r = 0; r < COMPACT_ROWS; ++r)
    if (r < rows) dst[(int64_t)(t0 + r) * a.B + d] = v[r];
}

__global__ void __launch_bounds__(THREADS) compact_kernel(CompactArgs a) {
  const int m = *a.count;
  const int chunks = (m + 31) / 32;
  const int64_t items = (int64_t)chunks * a.first[a.n_jobs];
  const int64_t warps = (int64_t)gridDim.x * (THREADS / 32);
  const int lane = threadIdx.x % 32;
  // item i: the chunk i % chunks of 32 pairs on row group i / chunks, so
  // neighbouring warps take neighbouring pairs of one row group
  for (int64_t i = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
       i < items; i += warps) {
    const int g = (int)(i / chunks);
    const int k = (int)(i % chunks) * 32 + lane;
    if (k >= m) continue;
    int j = 0;
    while (g >= a.first[j + 1]) ++j;
    const CompactJob& jb = a.job[j];
    const int t0 = (g - a.first[j]) * COMPACT_ROWS;
    switch (jb.size) {
      case 1: copy_column<uint8_t>(a, jb, t0, k); break;
      case 2: copy_column<uint16_t>(a, jb, t0, k); break;
      case 4: copy_column<uint32_t>(a, jb, t0, k); break;
    }
  }
}

cudaError_t launch_compact(CompactArgs a, cudaStream_t st) {
  a.first[0] = 0;
  for (int j = 0; j < a.n_jobs; ++j)
    a.first[j + 1] =
        a.first[j] + (a.job[j].rows + COMPACT_ROWS - 1) / COMPACT_ROWS;
  if (a.first[a.n_jobs] == 0) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  compact_kernel<<<COMPACT_BLOCKS_PER_SM * sms, THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

// offsets are int64; indices along one axis, int; the grid's y (tiles of
// 64 codewords) holds at most 65535
bool shape_ok(int64_t B, int64_t K, int64_t KTp) {
  return B > 0 && K > 0 && KTp >= K + 3 && KTp <= INT32_MAX - TILE &&
         (B + TILE - 1) / TILE <= 65535;
}

}  // namespace

// Type codes, as the SISO library's: channel stream 0 fp32, 1 bf16;
// extrinsic stream 0 fp32, 1 bf16, 2 int8, 3 float8_e4m3fn (its bytes).
// Each entry takes one pointer to a block of int64 arguments, read before
// the launch (the caller may reuse the block at once), and returns the
// launch's cudaError_t (0 = ok).  Every tensor is contiguous, on the
// stream's device, and overlaps no other.
//
// Pack, 24 arguments: a[0..2] ls, lp1, lp2 (B, K) fp32; then for the
// outputs ls1, lp1s, lp2s, ls2 in turn: a[3..6] the (B, 6) fp32 tail each
// reads, a[7..10] its first tail column (row K + j reads column off + 2j),
// a[11..14] the bits of its pad as a double (rows from K + 3), a[15..18]
// the output (KTp, B) of the channel type; a[19] B, a[20] K, a[21] KTp (at
// least K + 3); a[22] the channel type; a[23] the cudaStream_t.  The format
// is the caller's (decoder/layout.py::_FORMAT).
extern "C" int turbotpu_pack_streams_launch(const int64_t* a) {
  const int64_t B = a[19], K = a[20], KTp = a[21];
  if (!shape_ok(B, K, KTp)) return (int)cudaErrorInvalidValue;
  PackArgs p;
  for (int s = 0; s < 3; ++s) p.body[s] = (const float*)a[s];
  for (int s = 0; s < 4; ++s) {
    if (a[7 + s] < 0 || a[7 + s] > 1) return (int)cudaErrorInvalidValue;
    double pad;
    memcpy(&pad, &a[11 + s], sizeof pad);
    p.tail[s] = (const float*)a[3 + s];
    p.tail_off[s] = (int)a[7 + s];
    p.pad[s] = (float)pad;
    p.out[s] = (void*)a[15 + s];
  }
  p.B = (int)B, p.K = (int)K, p.KTp = (int)KTp;
  cudaStream_t st = (cudaStream_t)a[23];
  switch (a[22]) {
    case 0: return (int)launch_pack<float>(p, st);
    case 1: return (int)launch_pack<__nv_bfloat16>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Unpack, 16 arguments: a[0] ls1 (KTp, B) of the channel type; a[1], a[2]
// le1, le21 (KTp, B) of the extrinsic type, of which rows [0, K) are read;
// a[3] L (B, K) fp32; a[4] hard (B, K) int8; a[5] B, a[6] K; a[7] the bits
// of deq as a double, rounded to fp32 as PyTorch rounds a Python scalar
// multiplying an fp32 tensor; a[8] the channel type, a[9] the extrinsic
// type; the live prefix, or all 0: a[10] the syndromes (B,) int32, a[11]
// col (B,) int32, a[12] the live count, an int32, a[13] 1 on the last
// iteration (see UnpackArgs); a[14] N, the columns the grid spans (B
// without a live prefix, with one a bound of the count); a[15] the
// cudaStream_t.
extern "C" int turbotpu_assemble_outputs_launch(const int64_t* a) {
  const int64_t B = a[5], K = a[6], N = a[14];
  const bool live = a[10] != 0;
  if (!shape_ok(B, K, K + 3) || N < 1 || N > B || (!live && N != B) ||
      live != (a[11] != 0) || live != (a[12] != 0))
    return (int)cudaErrorInvalidValue;
  double deq;
  memcpy(&deq, &a[7], sizeof deq);
  UnpackArgs u;
  u.ls = (const void*)a[0];
  u.le1 = (const void*)a[1];
  u.le21 = (const void*)a[2];
  u.L = (float*)a[3];
  u.hard = (int8_t*)a[4];
  u.synd = (const uint32_t*)a[10];
  u.col = (const int32_t*)a[11];
  u.count = (const int32_t*)a[12];
  u.last = a[13] != 0;
  u.B = (int)B, u.K = (int)K;
  u.deq = (float)deq;
  cudaStream_t st = (cudaStream_t)a[15];
  switch (a[8]) {
    case 0: return (int)unpack_ext<float>((int)a[9], u, (int)N, st);
    case 1: return (int)unpack_ext<__nv_bfloat16>((int)a[9], u, (int)N, st);
  }
  return (int)cudaErrorInvalidValue;
}

// CRC early exit, 20 arguments: a[0] ls1 (KTp, B) of the channel type;
// a[1] le1n, this iteration's le1, a[2] le21n, its le21 in natural order
// (the same tensor as a[5] unless the loop carries le2 raw), a[3], a[4] the
// carried le1 and le21, a[5] le21's new buffer: (KTp, B) of the extrinsic
// type; a[6] done (B,) bool; a[7] iters (B,) int32; a[8] the check masks
// (K,) int32, bit j of row t set where the CRC's check matrix has a 1;
// a[9] the syndrome scratch (B,) int32, zero, and left zero; a[10] the
// all-done flag, a bool; a[11] B, a[12] K, a[13] KTp; a[14] the bits of deq
// as a double (rounded to fp32 as for unpack); a[15] the channel type,
// a[16] the extrinsic type; a[17] the live count, the device address of
// an int32, or 0; a[18] N, the columns the grid spans (B without a count;
// with one, a bound it does not exceed); a[19] the cudaStream_t.  Without
// a count, two launches: exit_kernel, then exit_close_kernel; a[1] and
// a[5] are written in place on the columns of codewords done before the
// call; done, iters and the flag after it.  With a count, the live-prefix
// loop's syndromes: exit_kernel alone, on the first *count columns, which
// are all live; done, iters and the flag are not read (0 for none), a[1]
// and a[5] not written, and the syndromes are left in a[9] for
// live_close_kernel (turbotpu_live_compact_launch).
extern "C" int turbotpu_crc_exit_launch(const int64_t* a) {
  const int64_t B = a[11], K = a[12], KTp = a[13], N = a[18];
  if (!shape_ok(B, K, KTp) || N < 1 || N > B || (!a[17] && N != B))
    return (int)cudaErrorInvalidValue;
  double deq;
  memcpy(&deq, &a[14], sizeof deq);
  ExitArgs e;
  e.count = (const int*)a[17];
  e.ls = (const void*)a[0];
  e.le1n = (void*)a[1];
  e.le21n = (const void*)a[2];
  e.le1 = (const void*)a[3];
  e.le21 = (const void*)a[4];
  e.f21 = (void*)a[5];
  e.done = (const uint8_t*)a[6];
  e.masks = (const uint32_t*)a[8];
  e.synd = (uint32_t*)a[9];
  e.B = (int)B, e.K = (int)K, e.KTp = (int)KTp;
  e.deq = (float)deq;
  uint8_t* done = (uint8_t*)a[6];
  int32_t* iters = (int32_t*)a[7];
  uint8_t* all_done = (uint8_t*)a[10];
  cudaStream_t st = (cudaStream_t)a[19];
  switch (a[15]) {
    case 0: return (int)exit_ext<float>((int)a[16], e, (int)N, done, iters,
                                        all_done, st);
    case 1: return (int)exit_ext<__nv_bfloat16>((int)a[16], e, (int)N, done,
                                                iters, all_done, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The live prefix's close and moves, 20 arguments: a[0] done (B,) bool,
// a[1] iters (B,) int32, a[2] col (B,) int32, a[3] the syndromes (B,)
// int32 that exit_kernel left (zero after the call), a[4] state (3,)
// int32: the live count n on entry, then (n', retired, moves), a[5] lists
// (2, B) int32 scratch; a[6] B, a[7] 1 on the loop's last iteration (every
// live column retires); the working set: a[8..11] the channel streams
// ls1, lp1, ls2, lp2, a[12] KTp, a[13] the channel element's bytes, a[14]
// the carried extrinsic (le21, or le2 raw), a[15] its element's bytes,
// a[16], a[17] the two (n_win, 8, B) fp32 window tables, 0 for none (exact
// contract), a[18] their rows (n_win x 8); a[19] the cudaStream_t.  Two
// launches: live_close_kernel, then compact_kernel.
extern "C" int turbotpu_live_compact_launch(const int64_t* a) {
  const int64_t B = a[6], KTp = a[12], chan = a[13], ext = a[15];
  if (!shape_ok(B, 1, KTp) || (ext != 1 && ext != 2 && ext != 4) ||
      (chan != 2 && chan != 4) || (a[16] == 0) != (a[17] == 0) ||
      a[18] < 0 || a[18] > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)a[19];
  int32_t* state = (int32_t*)a[4];
  int32_t* lists = (int32_t*)a[5];
  live_close_kernel<<<1, CLOSE_THREADS, 0, st>>>(
      (uint8_t*)a[0], (int32_t*)a[1], (int32_t*)a[2], (uint32_t*)a[3], state,
      lists, (int)B, a[7] != 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CompactArgs m{};
  m.B = B;
  for (int i = 0; i < 4; ++i)
    m.job[m.n_jobs++] = {(const char*)a[8 + i], (char*)a[8 + i], (int)KTp,
                         (int)chan};
  m.job[m.n_jobs++] = {(const char*)a[14], (char*)a[14], (int)KTp, (int)ext};
  for (int i = 0; i < 2; ++i)
    if (a[16 + i]) m.job[m.n_jobs++] = {(const char*)a[16 + i],
                                        (char*)a[16 + i], (int)a[18], 4};
  m.from = lists, m.to = lists + B, m.count = state + 2;
  return (int)launch_compact(m, st);
}
