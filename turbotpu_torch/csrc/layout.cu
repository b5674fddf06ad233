// The decoder's two layout crossings for Hopper (sm_90a), one launch each:
// the public (B, K) codeword-major tensors into the kernels' time-major
// (KTp, B) streams before the loop, and the loop's time-major extrinsics
// back into the (B, K) LLR and hard bits after it.
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
//                  both (B, K), from rows [0, K) of the (KTp, B) streams.
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
  int B, K;
  float deq;
  bool vec_in;               // 4-element loads along B
  bool vec_out;              // 16-byte L, 4-byte hard stores along K
};

template <typename Chan, typename Ext>
__global__ void __launch_bounds__(THREADS) unpack_kernel(UnpackArgs a) {
  __shared__ float tile[TILE][TILE + 1];       // [step][codeword]
  const int t0 = blockIdx.x * TILE, b0 = blockIdx.y * TILE;
  const int tid = threadIdx.x;
  const Chan* __restrict__ ls = (const Chan*)a.ls;
  const Ext* __restrict__ e1 = (const Ext*)a.le1;
  const Ext* __restrict__ e21 = (const Ext*)a.le21;
  {
    const int bl = 4 * (tid % 16);
    const int b = b0 + bl;
    for (int r = tid / 16; r < TILE && b < a.B; r += THREADS / 16) {
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
    if (b >= a.B) break;
    float v[4];
    int8_t h[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = tile[tl + i][r];
      h[i] = v[i] < 0.f;
    }
    const int64_t o = (int64_t)b * a.K + t;
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
cudaError_t launch_unpack(UnpackArgs a, cudaStream_t st) {
  a.vec_in = a.B % 4 == 0 && aligned(a.ls, 4 * sizeof(Chan)) &&
             aligned(a.le1, 4 * sizeof(Ext)) &&
             aligned(a.le21, 4 * sizeof(Ext));
  a.vec_out = a.K % 4 == 0 && aligned(a.L, 16) && aligned(a.hard, 4);
  const dim3 grid((a.K + TILE - 1) / TILE, (a.B + TILE - 1) / TILE);
  unpack_kernel<Chan, Ext><<<grid, THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename Chan>
cudaError_t unpack_ext(int ext, UnpackArgs a, cudaStream_t st) {
  switch (ext) {
    case 0: return launch_unpack<Chan, float>(a, st);
    case 1: return launch_unpack<Chan, __nv_bfloat16>(a, st);
    case 2: return launch_unpack<Chan, int8_t>(a, st);
    case 3: return launch_unpack<Chan, __nv_fp8_e4m3>(a, st);
  }
  return cudaErrorInvalidValue;
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

// Unpack, 11 arguments: a[0] ls1 (KTp, B) of the channel type; a[1], a[2]
// le1, le21 (KTp, B) of the extrinsic type, of which rows [0, K) are read;
// a[3] L (B, K) fp32; a[4] hard (B, K) int8; a[5] B, a[6] K; a[7] the bits
// of deq as a double, rounded to fp32 as PyTorch rounds a Python scalar
// multiplying an fp32 tensor; a[8] the channel type, a[9] the extrinsic
// type; a[10] the cudaStream_t.
extern "C" int turbotpu_assemble_outputs_launch(const int64_t* a) {
  const int64_t B = a[5], K = a[6];
  if (!shape_ok(B, K, K + 3)) return (int)cudaErrorInvalidValue;
  double deq;
  memcpy(&deq, &a[7], sizeof deq);
  UnpackArgs u;
  u.ls = (const void*)a[0];
  u.le1 = (const void*)a[1];
  u.le21 = (const void*)a[2];
  u.L = (float*)a[3];
  u.hard = (int8_t*)a[4];
  u.B = (int)B, u.K = (int)K;
  u.deq = (float)deq;
  cudaStream_t st = (cudaStream_t)a[10];
  switch (a[8]) {
    case 0: return (int)unpack_ext<float>((int)a[9], u, st);
    case 1: return (int)unpack_ext<__nv_bfloat16>((int)a[9], u, st);
  }
  return (int)cudaErrorInvalidValue;
}
