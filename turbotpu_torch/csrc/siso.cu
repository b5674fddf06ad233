// Fused BCJR SISO half-iteration for Hopper (sm_90a), in the three max*
// modes: max-log, linlog and log-MAP.
//
// Replaces the TPU kernel turbotpu/siso/pallas_kernel.py::_make_kernel (built
// there by _build_call), with the max* of _mstar/_mstar_tree and the per-leaf
// _extrinsic of the same file, in its two contracts:
//   NII   (nii=True):  window-start alphas come from the previous
//                      half-iteration (ain), fresh ones go out (aout);
//   exact (nii=False): no approximation: every window starts from the true
//                      alpha and beta at its edges.
// Both emit the extrinsic
//   Le = max*(u=0 edges) - max*(u=1 edges)
// from alpha before each step and beta after it.  Beta is exact in both: it
// runs continuously backward through every window.  Two more forms of the
// same function are libraries of their own, so that a decode without them
// never compiles them:
// K4 (-DSISO_BND=1), the boundary contracts (boundary=True, with and without
// nii, with_offset; consumed by the sequence-sharded decoder): the trellis is
// one chunk of a longer one, so the recursions start from edge metrics the
// caller passes in and the edges at the chunk's ends go out:
//   exact + boundary: alpha starts from a0 at the chunk start, and alpha at
//                     the chunk end goes out; beta starts from bT at the
//                     chunk end, and beta at the chunk start goes out;
//   NII + boundary:   window 0 starts from the received edge_in; the last
//                     window's end alpha goes out as eout, beside the
//                     shifted-slot writes of the window table; beta as above.
// The a-priori mask is on the global row off + t < K, with K the global info
// length and off the chunk's first row: t < K - off on the chunk's rows.
// With a0 = bT = edge_in = e0 and off = 0 the boundary forms equal the exact
// and NII kernels bit for bit.
// K5 (-DSISO_FOLD=1), the NII contract with the extrinsic interleave folded
// into the kernel (the reference's fold_gather=True call, pallas_call at :570
// of the same file): the a-priori row of step t is read from row idx[t] of
// the OTHER SISO's raw output, through a (T,) int32 table shared by the
// batch, so the decoder runs no gather between the two half-iterations.
// Everything after the read is the NII code, so its outputs equal the NII
// kernel's on a materialised gather bit for bit.
// All forms run on the same two window-parallel passes (their note below).
// The mode is a compile-time parameter:
//   max-log  max*(a, b) = max(a, b); the parity add is factored out of the
//            extrinsic's reduction (exact there: rounding is monotone);
//   linlog   max(a, b) + max(0, 0.693147 - 0.25 |a - b|);
//   log-MAP  max(a, b) + log1p(exp(-|a - b|)), full-precision libm.
// linlog's clipped correction depends on the order of the reduction, so
// linlog and log-MAP reduce the extrinsic's 8 leaves per input bit, parity
// added per leaf, as a balanced pairwise tree in state order.  The
// corrections multiply the instructions per step (linlog about 2.5x max-log,
// log-MAP two libm calls per max*) on the same dependent chain.
//
// Layout: every stream is time-major (T, B): element (t, b) at t*B + b, so
// the 32 codewords of a warp read 32 neighbouring values at each step.  That
// also holds for the folded read: row idx[t] is B contiguous values, and the
// index is the same for every codeword.  The reference issues one DMA per
// row for this; here it is an indexed load whose index sits on the load's
// address chain (index load, 64-bit multiply-add, stream load): pass 1 loads
// the index one block ahead of the copy that uses it, and the table (25.6 KB
// at T=6400) stays in L1.  Window tables (ain, aout) and edges are fp32,
// (n_win, 8, B) and (8, B).  No kernel allocates: the wrapper passes the
// scratch.
//
// Arithmetic is kept in the reference's order so results agree bit for bit:
// explicit __fadd_rn/__fmul_rn (no FMA contraction), renormalisation by the
// 8-state max after every 8 steps counted from the window start, alphas
// stored before the step and un-renormalised inside a block, gamma(1,1)=A+P
// formed first, int8 codes rounded half-to-even (rintf), float8_e4m3fn codes
// saturated at +-448 and rounded to nearest even (the reference's
// _quantize_le before XLA's convert).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#ifndef SISO_FOLD
#define SISO_FOLD 0
#endif
#ifndef SISO_BND
#define SISO_BND 0
#endif

namespace {

// the library's form (see the entry point at the end)
constexpr bool FOLD = SISO_FOLD != 0, BND = SISO_BND != 0;

constexpr int UNROLL = 8;    // steps per block; also the renorm cadence
constexpr float BIG = 1e9f;  // e0 = (0, -BIG x 7)

// max* modes, as the wrapper numbers them.
constexpr int MAXLOG = 0, LINLOG = 1, LOGMAP = 2;
constexpr float LIN_C0 = 0.693147f, LIN_C1 = 0.25f;

// ---- 3GPP RSC trellis (g0 = 13, g1 = 15 octal) as bit formulas ----------
// state s = (a1 << 2) | (a2 << 1) | a3, feedback bit ak = u ^ a2 ^ a3.
__host__ __device__ constexpr int t_next(int s, int u) {
  return (((u ^ (s >> 1) ^ s) & 1) << 2) | (((s >> 2) & 1) << 1) | ((s >> 1) & 1);
}
__host__ __device__ constexpr int t_par(int s, int u) {
  return ((u ^ (s >> 1) ^ s) ^ (s >> 2) ^ s) & 1;
}
// the state s with t_next(s, u) == s2
__host__ __device__ constexpr int t_prev(int s2, int u) {
  return (((s2 >> 1) & 1) << 2) | ((s2 & 1) << 1) | (((s2 >> 2) ^ u ^ s2) & 1);
}
__host__ __device__ constexpr int t_prev_par(int s2, int u) {
  return t_par(t_prev(s2, u), u);
}

static_assert(t_next(0, 0) == 0 && t_next(0, 1) == 4 && t_next(1, 0) == 4 &&
              t_next(2, 0) == 5 && t_next(3, 1) == 5 && t_next(4, 0) == 2 &&
              t_next(5, 0) == 6 && t_next(6, 0) == 7 && t_next(7, 0) == 3 &&
              t_next(7, 1) == 7, "trellis next-state table");
static_assert(t_par(0, 1) == 1 && t_par(1, 0) == 0 && t_par(2, 0) == 1 &&
              t_par(3, 0) == 1 && t_par(4, 0) == 1 && t_par(5, 1) == 0 &&
              t_par(6, 0) == 0 && t_par(7, 1) == 1, "trellis parity table");
static_assert(t_next(t_prev(5, 0), 0) == 5 && t_next(t_prev(5, 1), 1) == 5 &&
              t_next(t_prev(2, 0), 0) == 2 && t_next(t_prev(3, 1), 1) == 3,
              "trellis prev-state table");

// ---- stream element types ------------------------------------------------
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 v) { return float(v); }

__device__ __forceinline__ void st_le(float* p, float v, float) { *p = v; }
__device__ __forceinline__ void st_le(__nv_bfloat16* p, float v, float) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void st_le(int8_t* p, float v, float inv_q) {
  // uniform quantisation: round half to even, saturate at +-127
  float q = rintf(__fmul_rn(v, inv_q));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  *p = (int8_t)(int)q;
}
__device__ __forceinline__ void st_le(__nv_fp8_e4m3* p, float v, float) {
  // the reference's _quantize_le: saturate at the format's largest finite
  // value (e4m3fn has no inf), then round to nearest even
  v = fminf(fmaxf(v, -448.0f), 448.0f);
  p->__x = __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
}

// ---- recursion steps -----------------------------------------------------
template <int MODE>
__device__ __forceinline__ float mstar(float a, float b) {
  const float m = fmaxf(a, b);
  if (MODE == MAXLOG) return m;
  const float d = fabsf(__fsub_rn(a, b));
  if (MODE == LINLOG)
    return __fadd_rn(m, fmaxf(0.0f, __fsub_rn(LIN_C0, __fmul_rn(LIN_C1, d))));
  return __fadd_rn(m, log1pf(expf(-d)));
}

__device__ __forceinline__ void init_e0(float (&m)[8]) {
  m[0] = 0.0f;
#pragma unroll
  for (int s = 1; s < 8; ++s) m[s] = -BIG;
}

template <int MODE>
__device__ __forceinline__ void alpha_step(float (&a)[8], float A, float P) {
  const float AP = __fadd_rn(A, P);
  float n[8];
#pragma unroll
  for (int s2 = 0; s2 < 8; ++s2) {
    float c0 = a[t_prev(s2, 0)];
    if (t_prev_par(s2, 0)) c0 = __fadd_rn(c0, P);
    const float c1 = __fadd_rn(a[t_prev(s2, 1)], t_prev_par(s2, 1) ? AP : A);
    n[s2] = mstar<MODE>(c0, c1);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) a[s] = n[s];
}

template <int MODE>
__device__ __forceinline__ void beta_step(float (&b)[8], float A, float P) {
  const float AP = __fadd_rn(A, P);
  float n[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    float c0 = b[t_next(s, 0)];
    if (t_par(s, 0)) c0 = __fadd_rn(c0, P);
    const float c1 = __fadd_rn(b[t_next(s, 1)], t_par(s, 1) ? AP : A);
    n[s] = mstar<MODE>(c0, c1);
  }
#pragma unroll
  for (int s = 0; s < 8; ++s) b[s] = n[s];
}

__device__ __forceinline__ void renorm(float (&m)[8]) {
  float mx = m[0];
#pragma unroll
  for (int s = 1; s < 8; ++s) mx = fmaxf(mx, m[s]);
#pragma unroll
  for (int s = 0; s < 8; ++s) m[s] = __fsub_rn(m[s], mx);
}

// max over the u=U edges of alpha[s] + beta[next(s, U)] (+ P on parity-1
// edges, added once to the parity-1 subtree's max).
template <int U>
__device__ __forceinline__ float ext_side(const float (&a)[8],
                                          const float (&b)[8], float P) {
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float x = __fadd_rn(a[s], b[t_next(s, U)]);
    if (t_par(s, U)) m1 = fmaxf(m1, x); else m0 = fmaxf(m0, x);
  }
  return fmaxf(m0, __fadd_rn(m1, P));
}

// max* over the u=U edges, per leaf: alpha[s] + beta[next(s, U)], + P where
// the edge's parity is 1, reduced pairwise (0,1)(2,3)(4,5)(6,7), then pairs
// of those, then the last pair.
template <int MODE, int U>
__device__ __forceinline__ float ext_leaves(const float (&a)[8],
                                            const float (&b)[8], float P) {
  float x[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    x[s] = __fadd_rn(a[s], b[t_next(s, U)]);
    if (t_par(s, U)) x[s] = __fadd_rn(x[s], P);
  }
  const float x01 = mstar<MODE>(x[0], x[1]), x23 = mstar<MODE>(x[2], x[3]);
  const float x45 = mstar<MODE>(x[4], x[5]), x67 = mstar<MODE>(x[6], x[7]);
  return mstar<MODE>(mstar<MODE>(x01, x23), mstar<MODE>(x45, x67));
}

template <int MODE>
__device__ __forceinline__ float extrinsic(const float (&a)[8],
                                           const float (&b)[8], float P) {
  if (MODE == MAXLOG)
    return __fsub_rn(ext_side<0>(a, b, P), ext_side<1>(a, b, P));
  return __fsub_rn(ext_leaves<MODE, 0>(a, b, P), ext_leaves<MODE, 1>(a, b, P));
}

// One block of UNROLL raw stream rows, as loaded.  Blocks are fetched one
// ahead of the block being computed and converted only when their turn
// comes, so a load's latency hides behind a block of arithmetic.
template <typename TC, typename TE>
struct Rows {
  TC ls[UNROLL];
  TC lp[UNROLL];
  TE la[UNROLL];
};

// In a FOLD library la row t is read from row rows[t] (the gather table).
template <typename TC, typename TE>
struct Streams {
  const TC* __restrict__ ls;
  const TC* __restrict__ lp;
  const TE* __restrict__ la;
  const int* __restrict__ rows;  // FOLD only: (T,) source row of each la row
  int64_t B, b;   // batch size, this thread's codeword
  int K;          // a-priori mask: la counts only at t < K
  float eff;      // extrinsic scale times the int8 step

  __device__ __forceinline__ void fetch(int t0, Rows<TC, TE>& r) const {
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int64_t o = (int64_t)(t0 + j) * B + b;
      r.ls[j] = ls[o];
      r.lp[j] = lp[o];
      r.la[j] = FOLD ? la[(int64_t)rows[t0 + j] * B + b] : la[o];
    }
  }

  // Branch-metric generators of the block fetched from t0:
  //   A = -(la * [t < K] * eff + ls),  P = -lp.
  // The mask is on la only; la rows at t >= K may hold any finite value.
  __device__ __forceinline__ void metrics(const Rows<TC, TE>& r, int t0,
                                          float (&A)[UNROLL],
                                          float (&P)[UNROLL]) const {
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const float sm = (t0 + j < K) ? eff : 0.0f;
      A[j] = -__fadd_rn(__fmul_rn(to_f(r.la[j]), sm), to_f(r.ls[j]));
      P[j] = -to_f(r.lp[j]);
    }
  }
};

// UNROLL forward steps from t0 on the rows in `cur`, after starting the
// fetch of the next block into `nxt`, then the renorm.
template <int MODE, typename TC, typename TE>
__device__ __forceinline__ void alpha_block(const Streams<TC, TE>& st, int t0,
                                            bool more, const Rows<TC, TE>& cur,
                                            Rows<TC, TE>& nxt,
                                            float (&alpha)[8]) {
  float A[UNROLL], P[UNROLL];
  st.metrics(cur, t0, A, P);
  if (more) st.fetch(t0 + UNROLL, nxt);
#pragma unroll
  for (int j = 0; j < UNROLL; ++j) alpha_step<MODE>(alpha, A[j], P[j]);
  renorm(alpha);
}

// K4's boundary operands, (8, B) fp32 each (state s of codeword b at
// s*B + b); null outside a BND library, which alone reads them.
struct Edges {
  const float* a_in;  // exact: alpha at the chunk start (a0);
                      // NII: window 0's start (edge_in)
  const float* b_in;  // beta at the chunk end (bT)
  float* a_out;       // exact: alpha at the chunk end; NII: eout
  float* b_out;       // beta at the chunk start
  int off;            // the chunk's first global row
};

__device__ __forceinline__ void load_edge(float (&m)[8], const float* e,
                                          int64_t B, int64_t b) {
#pragma unroll
  for (int s = 0; s < 8; ++s) m[s] = e[s * B + b];
}

__device__ __forceinline__ void store_edge(float* e, const float (&m)[8],
                                           int64_t B, int64_t b) {
#pragma unroll
  for (int s = 0; s < 8; ++s) e[s * B + b] = m[s];
}

// alpha at t = 0 (a_in in a BND library) or beta at T (b_in)
__device__ __forceinline__ void start_edge(float (&m)[8], const float* e,
                                           int64_t B, int64_t b) {
  if (BND) load_edge(m, e, B, b); else init_e0(m);
}

// ---- the window-parallel passes ------------------------------------------
//
// Every contract's outputs depend only on alpha and beta at each step.  Beta
// is a plain recursion from its edge at T (e0, or b_in) with a renorm after
// every 8-step block (blocks aligned at multiples of 8 from t = 0).  Alpha
// is one too in the exact contract, from its edge at t = 0 (e0, or a_in); in
// the NII contract it restarts at every window start w*W from ain[w] (window
// 0 from e0, or edge_in), renormalised every 8 steps from that start.  The
// serial schedule (one thread per codeword walking the windows backward, as
// the plain versions in siso/cuda_kernel.py do) walks the trellis three
// times (exact) or twice (NII).  Here the trellis is cut into segments of
// seg steps (a power of two up to 64, a multiple of 8; for NII one that
// divides the window W, so every segment edge is an 8-step renorm edge of
// the window walk too; for exact any multiple of 8 gives the same values,
// since every segment edge is a block edge), and:
//   pass 1, beta: beta runs backward from its edge at T down to row seg and
//           writes beta at each segment end (bck[j], the beta entering
//           segment j from above, j <= n_seg-2), T - seg dependent steps.  A
//           codeword's 8 states sit on 8 lanes: each lane does its state's
//           step on two metrics shuffled in from the lanes of the successor
//           states, which cuts the dependent chain of a step to a shuffle,
//           an add and a max* and the instructions per lane to a few (one
//           thread per codeword, its rows staged the same way, measured
//           slower in every mode, max-log included).  The rows of each
//           8-step block are staged PASS1_DEPTH - 1 blocks ahead (cp.async
//           into a ring of tiles in shared memory; register loads where
//           B % 4 != 0); lane s forms row s's A and P, and the 8 lanes
//           exchange them.  The folded read (K5) stages row idx[t] of la.
//   pass 1, alpha (exact_pass1, other blockIdx.y): the same walk forward
//           from its edge over segments 0..n_seg-2, writing alpha at each
//           segment start (ack[j], j >= 1).
//   pass 1, alpha (nii_pass1, blocks after the beta walk's, one launch): one
//           thread per (window, codeword) walks alpha over its window's W
//           steps from ain[w], writes alpha at each segment start inside the
//           window (ack[j]; at the window start that is ain[w] itself) and
//           the window's end alpha to aout[w+1].  These are n_win x B walks
//           of W steps beside one walk of T - seg steps per codeword, so the
//           beta walk sets the pass's time.
//   pass 2 (exact_pass2, both contracts): one thread per (segment,
//           codeword) decodes its segment alone: alpha forward from ack[j]
//           (the alpha edge for segment 0), keeping alpha at each 8-step
//           block start in shared memory (seg / 8 x 8 fp32 a thread); then
//           block by block backward, alpha recomputed over the block from
//           its sub-checkpoint into registers, and beta from bck[j] (the
//           beta edge for the last segment) steps down the block emitting
//           Le.  In a BND library the thread of segment 0 writes its beta
//           at row 0 (b_out), and the thread of the last segment runs alpha
//           over its last block too and writes alpha at the chunk end
//           (a_out: the exact contract's chunk end, the NII contract's last
//           window end).  The edges come from pass 2 because a chunk of one
//           segment has no pass 1.
// Every value is produced by the same step functions on the same operands in
// the same order as in the serial schedule (the renorm's max over 8 lanes is a
// tree, which is exact for fmaxf), so Le, aout and the outgoing edges are
// equal to it bit for bit.  The critical path is T - seg + 3 seg steps (one
// warp's beta walk, then one segment) instead of 3T (exact) or 2T (NII); the
// segment alphas never leave the SM, and pass 2 has n_seg x B independent
// threads (100 x 1024 at the flagship shape, 50 x 4096 at the sequence
// path's chunk).
// Bound: latency, not bytes (about 6 B per step and codeword) or issue at
// the decoders' batches: pass 1's beta walk, a chain of a shuffle, an add
// and a max* per step and three shuffle-max levels per renorm, is the
// critical path, and it is the same walk in every contract: the NII
// contract saves the forward walk's instructions, not its time.
constexpr int EXACT_THREADS = 32;  // pass 1 and pass 2 blocks: one warp
constexpr int PASS1_CW = EXACT_THREADS / 8;  // pass 1: codewords per warp
constexpr int PASS1_DEPTH = 8;     // row blocks in flight in pass 1
constexpr unsigned FULL = 0xffffffffu;

// The codewords a launch decodes: the first n of the N columns its grid
// spans, n read from the card (`count`, the decoder's live prefix, which
// the host bounds by N) or N itself where the caller passes no count.
// Blocks wholly past n return at once; lanes past n inside a block do
// what lanes past B did before there was a count: they walk a column they
// never store.
__device__ __forceinline__ int live_count(const int* count, int N) {
  return count ? min(*count, N) : N;
}

// Asynchronous copies global -> shared of N bytes (4, 8 or 16), completed
// in groups.  Waiting for "all but the newest N groups" is what a register
// prefetch cannot express: ptxas puts every stream load on one scoreboard,
// and the first use of a block's rows waits for every load in flight,
// including those just issued for the blocks ahead (the SASS of this walk
// with register loads shows it), so each block pays a full load latency.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "n"(N)
               : "memory");
#else
  memcpy(dst, src, N);
#endif
}
__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;" ::: "memory");
#endif
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
#endif
}

// One 8-step block of the rows of a warp's PASS1_CW codewords, as staged:
// row r of codeword c at [r][c].
template <typename TC, typename TE>
struct Tile {
  TC ls[UNROLL][PASS1_CW];
  TC lp[UNROLL][PASS1_CW];
  TE la[UNROLL][PASS1_CW];
};

// One pass-1 step on the lane's state s of its codeword (lanes 8c..8c+7):
// the alpha or beta step of alpha_step/beta_step for that state, its two
// operands shuffled in from the lanes of the predecessor (successor) states.
template <int MODE>
__device__ __forceinline__ float walk_step(float m, float A, float P, int src0,
                                           int src1, bool par0, bool par1) {
  const float AP = __fadd_rn(A, P);
  float c0 = __shfl_sync(FULL, m, src0);
  const float m1 = __shfl_sync(FULL, m, src1);
  if (par0) c0 = __fadd_rn(c0, P);
  const float c1 = __fadd_rn(m1, par1 ? AP : A);
  return mstar<MODE>(c0, c1);
}

// renorm over the 8 lanes of a codeword (fmaxf is exact, so the order of the
// reduction does not matter)
__device__ __forceinline__ float renorm8(float m) {
  float mx = fmaxf(m, __shfl_xor_sync(FULL, m, 1));
  mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
  mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 4));
  return __fsub_rn(m, mx);
}

// One walk of pass 1 for the lane's (codeword b, state s), from the edge
// `edge` (BND) or e0.  Block i covers rows i*8.. (forward) or
// T - (i+1)*8.. (backward), fetched PASS1_DEPTH - 1 blocks ahead of the
// arithmetic.  STAGED (B % 4 == 0, aligned streams): 24 lanes each copy one
// row of one stream for the warp's 4 codewords into a ring of tiles in
// shared memory; otherwise lane s loads row s of each stream into
// registers.  Lane s forms row s's A and P, and the 8 lanes of the codeword
// exchange them.  (Doing that for block i + 1 before block i's steps, to
// overlap their chain, measured 15-30% slower on an H100.)
template <int MODE, bool FWD, bool STAGED, typename TC, typename TE>
__device__ __forceinline__ void walk(const TC* __restrict__ ls,
                                     const TC* __restrict__ lp,
                                     const TE* __restrict__ la,
                                     const int* __restrict__ rows,
                                     const float* edge, float* ck, int64_t B,
                                     int64_t b, bool live, int K, int n_win,
                                     int W, float eff, Tile<TC, TE>* tiles) {
  const int lane = threadIdx.x, s = lane & 7, g = lane & ~7, c = lane >> 3;
  const int src0 = g | (FWD ? t_prev(s, 0) : t_next(s, 0));
  const int src1 = g | (FWD ? t_prev(s, 1) : t_next(s, 1));
  const bool par0 = FWD ? t_prev_par(s, 0) : t_par(s, 0);
  const bool par1 = FWD ? t_prev_par(s, 1) : t_par(s, 1);
  const int T = n_win * W;
  const int nb = (n_win - 1) * W / UNROLL, nsub = W / UNROLL;
  auto row0 = [&](int i) { return FWD ? i * UNROLL : T - (i + 1) * UNROLL; };
  TC rls[PASS1_DEPTH], rlp[PASS1_DEPTH];
  TE rla[PASS1_DEPTH];
  // FOLD: the la row of the next fetch's row s, loaded one fetch ahead
  // (fetch is called for i = 0, 1, 2, ... in turn)
  int src = FOLD ? rows[row0(0) + s] : 0;
  // block i into slot d (a group of copies, committed even when empty)
  auto fetch = [&](int i, int d) {
    int64_t ra = 0;  // la's row for row s of block i
    if (i < nb) {
      ra = FOLD ? src : row0(i) + s;
      if (FOLD && i + 1 < nb) src = rows[row0(i + 1) + s];
    }
    if constexpr (STAGED) {
      if (i < nb) {
        const int64_t o = (int64_t)(row0(i) + s) * B + (b - c);
        if (c == 0) cp_async<PASS1_CW * sizeof(TC)>(tiles[d].ls[s], ls + o);
        if (c == 1) cp_async<PASS1_CW * sizeof(TC)>(tiles[d].lp[s], lp + o);
        if (c == 2)
          cp_async<PASS1_CW * sizeof(TE)>(tiles[d].la[s],
                                          la + ra * B + (b - c));
      }
      cp_async_commit();
    } else {
      if (i >= nb) return;
      const int64_t o = (int64_t)(row0(i) + s) * B + b;
      rls[d] = ls[o];
      rlp[d] = lp[o];
      rla[d] = la[ra * B + b];
    }
  };
  // A and P of the 8 rows of block i (slot d) on every lane of the codeword:
  // lane s forms row s's (Streams::metrics), then they are exchanged
  auto metrics = [&](int i, int d, float (&A)[UNROLL], float (&P)[UNROLL]) {
    TC vls, vlp;
    TE vla;
    if constexpr (STAGED) {
      cp_async_wait<PASS1_DEPTH - 2>();  // block i's group has landed
      __syncwarp();
      vls = tiles[d].ls[s][c];
      vlp = tiles[d].lp[s][c];
      vla = tiles[d].la[s][c];
    } else {
      vls = rls[d];
      vlp = rlp[d];
      vla = rla[d];
    }
    const float sm = (row0(i) + s < K) ? eff : 0.0f;
    const float a_s = -__fadd_rn(__fmul_rn(to_f(vla), sm), to_f(vls));
    const float p_s = -to_f(vlp);
#pragma unroll
    for (int jj = 0; jj < UNROLL; ++jj) {
      A[jj] = __shfl_sync(FULL, a_s, g | jj);
      P[jj] = __shfl_sync(FULL, p_s, g | jj);
    }
  };
  float m = BND ? edge[s * B + b] : (s == 0 ? 0.0f : -BIG);
#pragma unroll
  for (int j = 0; j < PASS1_DEPTH - 1; ++j) fetch(j, j);
  int in_win = 0, n_ck = 0;  // blocks into the window; checkpoints written
  for (int k = 0; k < nb; k += PASS1_DEPTH) {
#pragma unroll
    for (int j = 0; j < PASS1_DEPTH; ++j) {
      const int i = k + j;
      if (i < nb) {
        float A[UNROLL], P[UNROLL];
        metrics(i, j, A, P);
        // into block i - 1's slot, which every lane has read
        fetch(i + PASS1_DEPTH - 1, (j + PASS1_DEPTH - 1) % PASS1_DEPTH);
        if (FWD) {
#pragma unroll
          for (int jj = 0; jj < UNROLL; ++jj)
            m = walk_step<MODE>(m, A[jj], P[jj], src0, src1, par0, par1);
        } else {
#pragma unroll
          for (int jj = UNROLL - 1; jj >= 0; --jj)
            m = walk_step<MODE>(m, A[jj], P[jj], src0, src1, par0, par1);
        }
        m = renorm8(m);
        // at a window edge: alpha at the next window's start, beta at the
        // previous one's end
        if (++in_win == nsub) {
          in_win = 0;
          ++n_ck;
          if (live)
            ck[((int64_t)(FWD ? n_ck : n_win - 1 - n_ck) * 8 + s) * B + b] = m;
        }
      }
    }
  }
}

// Pass 1 of the exact contract: blockIdx.y 0 walks alpha, 1 walks beta,
// PASS1_CW codewords a warp, 8 lanes each.  Lanes of codewords past the
// count walk their own column (past B: the last codeword) and store
// nothing: every lane takes part in every shuffle.
template <int MODE, bool STAGED, typename TC, typename TE>
__global__ void exact_pass1(const TC* __restrict__ ls,
                            const TC* __restrict__ lp,
                            const TE* __restrict__ la, float* __restrict__ ack,
                            float* __restrict__ bck, int B_, int N,
                            const int* count, int K, int n_win, int W,
                            float eff, Edges e) {
  __shared__ __align__(16) Tile<TC, TE> tiles[STAGED ? PASS1_DEPTH : 1];
  const int64_t B = B_;
  const int n = live_count(count, N);
  if ((int64_t)blockIdx.x * PASS1_CW >= n) return;
  const int64_t bq = (int64_t)blockIdx.x * PASS1_CW + (threadIdx.x >> 3);
  const bool live = bq < n;
  const int64_t b = bq < B ? bq : B - 1;
  if (blockIdx.y == 0)
    walk<MODE, true, STAGED>(ls, lp, la, nullptr, e.a_in, ack, B, b, live, K,
                             n_win, W, eff, tiles);
  else
    walk<MODE, false, STAGED>(ls, lp, la, nullptr, e.b_in, bck, B, b, live, K,
                              n_win, W, eff, tiles);
}

// The NII contract's alpha walk of window w for codeword st.b (pass 1):
// from ain[w] (window 0 from its edge), renormalised after every 8-step
// block of the window; alpha at each segment start inside the window goes to
// ack (segment 0's slot is never read), the window's end to aout[w + 1] (the
// last window's end comes from pass 2).
template <int MODE, typename TC, typename TE>
__device__ __forceinline__ void window_alpha(const Streams<TC, TE>& st,
                                             const float* __restrict__ ain,
                                             float* __restrict__ aout,
                                             float* __restrict__ ack, int w,
                                             int n_win, int W, int seg,
                                             const float* a_in) {
  const int64_t B = st.B, b = st.b;
  const int base = w * W;
  float alpha[8];
  if (w == 0) start_edge(alpha, a_in, B, b);
  else load_edge(alpha, ain + (int64_t)w * 8 * B, B, b);
  Rows<TC, TE> r0, r1;
  st.fetch(base, r0);
  for (int tw = 0; tw < W; tw += 2 * UNROLL) {
    if (tw % seg == 0 && base + tw > 0)
      store_edge(ack + (int64_t)((base + tw) / seg) * 8 * B, alpha, B, b);
    alpha_block<MODE>(st, base + tw, tw + UNROLL < W, r0, r1, alpha);
    const int t1 = tw + UNROLL;
    if (t1 == W) break;
    if (t1 % seg == 0)
      store_edge(ack + (int64_t)((base + t1) / seg) * 8 * B, alpha, B, b);
    alpha_block<MODE>(st, base + t1, t1 + UNROLL < W, r1, r0, alpha);
  }
  if (w + 1 < n_win) store_edge(aout + (int64_t)(w + 1) * 8 * B, alpha, B, b);
}

// Pass 1 of the NII contract, one launch: blocks [0, n_beta) walk beta over
// the segments as exact_pass1's beta slice does (PASS1_CW codewords a warp,
// 8 lanes each); the n_win x ceil(N / 32) blocks after them walk the window
// alphas, one thread per (window, codeword).  The beta blocks come first,
// so the long walk starts first and the short ones fill the SMs beside it.
template <int MODE, bool STAGED, typename TC, typename TE>
__global__ void nii_pass1(const TC* __restrict__ ls, const TC* __restrict__ lp,
                          const TE* __restrict__ la,
                          const int* __restrict__ idx,
                          const float* __restrict__ ain,
                          float* __restrict__ aout, float* __restrict__ ack,
                          float* __restrict__ bck, int B_, int N,
                          const int* count, int K, int n_win, int W, int seg,
                          int n_beta, float eff, Edges e) {
  __shared__ __align__(16) Tile<TC, TE> tiles[STAGED ? PASS1_DEPTH : 1];
  const int64_t B = B_;
  const int n = live_count(count, N);
  if ((int)blockIdx.x < n_beta) {
    if ((int64_t)blockIdx.x * PASS1_CW >= n) return;
    const int64_t bq = (int64_t)blockIdx.x * PASS1_CW + (threadIdx.x >> 3);
    walk<MODE, false, STAGED>(ls, lp, la, idx, e.b_in, bck, B,
                              bq < B ? bq : B - 1, bq < n, K,
                              n_win * W / seg, seg, eff, tiles);
    return;
  }
  const int i = (int)blockIdx.x - n_beta;
  const int gx = (N + EXACT_THREADS - 1) / EXACT_THREADS;
  const int64_t b = (int64_t)(i % gx) * EXACT_THREADS + threadIdx.x;
  if (b >= n) return;
  const Streams<TC, TE> st{ls, lp, la, idx, B, b, K, eff};
  window_alpha<MODE>(st, ain, aout, ack, i / gx, n_win, W, seg, e.a_in);
}

// Pass 2, one backward block at t0 (window block i): alpha over the block
// recomputed from its sub-checkpoint (the alpha before each step, no renorm
// inside a block), then Le and beta from the block's last row down.  The
// next block down is fetched first.
template <int MODE, typename TC, typename TE>
__device__ __forceinline__ void exact_block(
    const Streams<TC, TE>& st, int t0, bool more, const Rows<TC, TE>& cur,
    Rows<TC, TE>& nxt, const float* sub, float (&beta)[8],
    TE* __restrict__ le, float inv_q) {
  float A[UNROLL], P[UNROLL];
  st.metrics(cur, t0, A, P);
  if (more) st.fetch(t0 - UNROLL, nxt);
  float at[UNROLL][8];
#pragma unroll
  for (int s = 0; s < 8; ++s) at[0][s] = sub[s * EXACT_THREADS];
#pragma unroll
  for (int j = 0; j + 1 < UNROLL; ++j) {
#pragma unroll
    for (int s = 0; s < 8; ++s) at[j + 1][s] = at[j][s];
    alpha_step<MODE>(at[j + 1], A[j], P[j]);
  }
#pragma unroll
  for (int j = UNROLL - 1; j >= 0; --j) {
    st_le(le + (int64_t)(t0 + j) * st.B + st.b,
          extrinsic<MODE>(at[j], beta, P[j]), inv_q);
    beta_step<MODE>(beta, A[j], P[j]);
  }
  renorm(beta);
}

template <int MODE, typename TC, typename TE>
__global__ void exact_pass2(const TC* __restrict__ ls,
                            const TC* __restrict__ lp,
                            const TE* __restrict__ la,
                            const int* __restrict__ idx, TE* __restrict__ le,
                            const float* __restrict__ ack,
                            const float* __restrict__ bck, int B_, int N,
                            const int* count, int K, int n_win, int W,
                            float eff, float inv_q, Edges e) {
  // the sub-checkpoints of the block's EXACT_THREADS codewords: (W / UNROLL,
  // 8, EXACT_THREADS) fp32, state s of block i of lane l at (i*8 + s)*32 + l
  extern __shared__ float exact_sub[];
  const int64_t B = B_;
  const int lane = threadIdx.x;
  const int64_t b = (int64_t)blockIdx.x * EXACT_THREADS + lane;
  // each thread reads only its own shared memory
  if (b >= live_count(count, N)) return;
  const Streams<TC, TE> st{ls, lp, la, idx, B, b, K, eff};
  const int w = blockIdx.y, base = w * W, nsub = W / UNROLL;
  float* sub = exact_sub + lane;
  Rows<TC, TE> r0, r1;
  // BND: the last segment's last block gives the outgoing alpha edge; its
  // steps are unused otherwise
  const bool tail = BND && w == n_win - 1;

  float alpha[8];
  if (w == 0) start_edge(alpha, e.a_in, B, b);
  else load_edge(alpha, ack + (int64_t)w * 8 * B, B, b);
  st.fetch(base, r0);
  // forward: alpha at each block start
  for (int i = 0; i < nsub; i += 2) {
#pragma unroll
    for (int s = 0; s < 8; ++s) sub[(i * 8 + s) * EXACT_THREADS] = alpha[s];
    if (i + 1 == nsub && !tail) break;
    alpha_block<MODE>(st, base + i * UNROLL, i + 1 < nsub, r0, r1, alpha);
    if (i + 1 == nsub) break;
#pragma unroll
    for (int s = 0; s < 8; ++s)
      sub[((i + 1) * 8 + s) * EXACT_THREADS] = alpha[s];
    if (i + 2 == nsub && !tail) break;
    alpha_block<MODE>(st, base + (i + 1) * UNROLL, i + 2 < nsub, r1, r0,
                      alpha);
  }
  if (tail) store_edge(e.a_out, alpha, B, b);

  float beta[8];
  if (w == n_win - 1) start_edge(beta, e.b_in, B, b);
  else load_edge(beta, bck + (int64_t)w * 8 * B, B, b);
  st.fetch(base + W - UNROLL, r0);
  for (int i = nsub - 1; i >= 0; i -= 2) {
    exact_block<MODE>(st, base + i * UNROLL, i > 0, r0, r1,
                      sub + i * 8 * EXACT_THREADS, beta, le, inv_q);
    if (i == 0) break;
    exact_block<MODE>(st, base + (i - 1) * UNROLL, i > 1, r1, r0,
                      sub + (i - 1) * 8 * EXACT_THREADS, beta, le, inv_q);
  }
  if (BND && w == 0) store_edge(e.b_out, beta, B, b);
}

// The unit of the window-parallel passes: the largest power of two up to 64
// that divides n (a multiple of 8).  The exact contract's wrapper passes
// segments already (W = segment_of(T)); the NII contract cuts each window W
// into segments of segment_of(W).
constexpr int segment_of(int n) {
  int seg = 64;
  while (n % seg) seg /= 2;
  return seg;
}

// Which of the two passes a launch runs: both (a siso_cells call), or one
// alone, to time it (pass 2 alone then reads the checkpoints of an earlier
// call).
constexpr int PASS1 = 1, PASS2 = 2;

// Every contract on one stream.  ck is (2, n_seg, 8, B) fp32: alpha
// checkpoints (slot 0 unused), then beta checkpoints (slot n_seg - 1
// unused).  Exact: (n_win, W) are the segments, ain/aout unused.  NII:
// (n_win, W) are the windows, ain/aout the (n_win, 8, B) window tables.
template <typename TC, typename TE, int MODE>
cudaError_t launch(bool nii, const void* ls, const void* lp, const void* la,
                   const int* idx, void* le, const float* ain, float* aout,
                   float* ck, int B, int N, const int* count, int K,
                   int n_win, int W, float eff, float inv_q, const Edges& e,
                   int passes, cudaStream_t stream) {
  const int seg = nii ? segment_of(W) : W;
  const int n_seg = n_win * W / seg;
  const int Kc = K - e.off;  // the mask on the chunk's own rows
  float* ack = ck;
  float* bck = ck + (int64_t)n_seg * 8 * B;
  const TC* cls = (const TC*)ls;
  const TC* clp = (const TC*)lp;
  const TE* cla = (const TE*)la;
  // the grid spans the first N columns (N <= B, the row pitch)
  const unsigned gx = (unsigned)((N + EXACT_THREADS - 1) / EXACT_THREADS);
  // staged: every warp's rows are whole aligned pieces of 4 codewords
  const bool staged = B % PASS1_CW == 0 &&
                      ((uintptr_t)ls | (uintptr_t)lp | (uintptr_t)la) % 16 == 0;
  // one segment: pass 2 starts from the edges at both ends, and no window
  // table is written (one window)
  if ((passes & PASS1) && n_seg > 1) {
    if (nii) {
      const int n_beta = (N + PASS1_CW - 1) / PASS1_CW;
      const dim3 g1((unsigned)(n_beta + n_win * (int)gx));
      if (staged)
        nii_pass1<MODE, true, TC, TE><<<g1, dim3(EXACT_THREADS), 0, stream>>>(
            cls, clp, cla, idx, ain, aout, ack, bck, B, N, count, Kc, n_win,
            W, seg, n_beta, eff, e);
      else
        nii_pass1<MODE, false, TC, TE><<<g1, dim3(EXACT_THREADS), 0, stream>>>(
            cls, clp, cla, idx, ain, aout, ack, bck, B, N, count, Kc, n_win,
            W, seg, n_beta, eff, e);
    } else if constexpr (!FOLD) {
      const dim3 g1((unsigned)((N + PASS1_CW - 1) / PASS1_CW), 2);
      if (staged)
        exact_pass1<MODE, true, TC, TE><<<g1, dim3(EXACT_THREADS), 0,
                                          stream>>>(cls, clp, cla, ack, bck, B,
                                                    N, count, Kc, n_seg, seg,
                                                    eff, e);
      else
        exact_pass1<MODE, false, TC, TE><<<g1, dim3(EXACT_THREADS), 0,
                                           stream>>>(cls, clp, cla, ack, bck,
                                                     B, N, count, Kc, n_seg,
                                                     seg, eff, e);
    }
  }
  if (passes & PASS2) {
    // segments of at most 64 steps take 8 KB
    const size_t smem = (size_t)seg * 8 * EXACT_THREADS * sizeof(float) / UNROLL;
    if (smem > 48 * 1024) return cudaErrorInvalidValue;
    exact_pass2<MODE, TC, TE><<<dim3(gx, n_seg), dim3(EXACT_THREADS), smem,
                                stream>>>(cls, clp, cla, idx, (TE*)le, ack,
                                          bck, B, N, count, Kc, n_seg, seg,
                                          eff, inv_q, e);
  }
  return cudaGetLastError();
}

}  // namespace

// One library holds one variant, chosen at compile time:
//   -DSISO_MODE=  0 max-log, 1 linlog, 2 log-MAP
//   -DSISO_CHAN=  0 float32, 1 bfloat16          (ls, lp)
//   -DSISO_EXT=   0 float32, 1 bfloat16, 2 int8, 3 float8_e4m3fn
//                 (la in, le out)
//   -DSISO_FOLD=  0 (default), or 1: the NII contract with the folded read
//                 (K5) alone
//   -DSISO_BND=   0 (default), or 1: the NII and exact contracts in their
//                 boundary forms (K4) alone
// (the variants compile side by side, and a decode builds only its own).
#if !defined(SISO_MODE) || !defined(SISO_CHAN) || !defined(SISO_EXT)
#error "compile with -DSISO_MODE=, -DSISO_CHAN= and -DSISO_EXT="
#endif
#if SISO_FOLD && SISO_BND
#error "SISO_FOLD and SISO_BND are separate libraries"
#endif
#if SISO_MODE < 0 || SISO_MODE > 2 || SISO_CHAN < 0 || SISO_CHAN > 1 || \
    SISO_EXT < 0 || SISO_EXT > 3
#error "unknown SISO_MODE, SISO_CHAN or SISO_EXT"
#endif

namespace {
template <int CODE> struct StreamType;
template <> struct StreamType<0> { using type = float; };
template <> struct StreamType<1> { using type = __nv_bfloat16; };
template <> struct StreamType<2> { using type = int8_t; };
template <> struct StreamType<3> { using type = __nv_fp8_e4m3; };
}  // namespace

// The entry of every library: one pointer to 27 int64 arguments, read
// before the launch (the caller may reuse the block at once).
//   a[0] passes: 3 for a call, 1 or 2 for that pass alone, to time it (pass
//        2 alone reads the checkpoints in ckpt, so a full launch on the same
//        operands comes first);
//   a[1..3] the mode, channel and extrinsic type codes, which must be this
//        library's (else -1); a[4] nii;
//   a[5..16] device addresses, 0 for none: ls, lp, la, idx, le, ain, aout,
//        ckpt, then the edges a_in, b_in, a_out, b_out;
//   a[17] off, a[18] B, a[19] K, a[20] n_win, a[21] W;
//   a[22], a[23] the bits of eff and inv_q as doubles, rounded to fp32 here
//        as ctypes' c_float rounds a Python float;
//   a[24] the live count: the device address of an int32 (0 for none), the
//        number of leading columns to decode, read by every block when it
//        starts (the decoder's live prefix, which the card alone knows
//        exactly); a[25] N, the columns the grid spans, 1..B: without a
//        count B, with one a bound the count never exceeds when the launch
//        runs; a[26] the cudaStream_t.
// nii != 0: (n_win, W) are the windows; ain/aout are (n_win, 8, B) fp32,
// ckpt is (2, n_win * W / segment_of(W), 8, B) fp32 scratch.  nii == 0:
// (n_win, W) are the segments the wrapper cut (W = segment_of(n_win * W));
// ckpt is (2, n_win, 8, B) fp32 scratch, ain/aout unused.
// idx: null, except in a SISO_FOLD library (nii != 0 only): the
// (n_win * W,) int32 gather table with values in [0, n_win * W).
// The edges: null, except in a SISO_BND library: (8, B) fp32 each (see
// Edges), none of them overlapping another operand; off is the chunk's
// first global row (0 elsewhere) and K the global info length.
// Returns the cudaError_t (0 = ok) of the first failing launch.
extern "C" int turbotpu_siso_launch(const int64_t* a) {
  if (a[1] != SISO_MODE || a[2] != SISO_CHAN || a[3] != SISO_EXT) return -1;
  const int passes = (int)a[0];
  const bool nii = a[4] != 0;
  const Edges e{(const float*)a[13], (const float*)a[14], (float*)a[15],
                (float*)a[16], (int)a[17]};
  const int n_edges = (e.a_in != nullptr) + (e.b_in != nullptr) +
                      (e.a_out != nullptr) + (e.b_out != nullptr);
  const int* count = (const int*)a[24];
  if (passes < PASS1 || passes > (PASS1 | PASS2) || (a[8] != 0) != FOLD ||
      (FOLD && !nii) || n_edges != (BND ? 4 : 0) || (!BND && e.off != 0) ||
      a[25] < 1 || a[25] > a[18] || (!count && a[25] != a[18]))
    return (int)cudaErrorInvalidValue;
  double eff, inv_q;
  memcpy(&eff, &a[22], sizeof eff);
  memcpy(&inv_q, &a[23], sizeof inv_q);
  return (int)launch<StreamType<SISO_CHAN>::type, StreamType<SISO_EXT>::type,
                     SISO_MODE>(
      nii, (const void*)a[5], (const void*)a[6], (const void*)a[7],
      (const int*)a[8], (void*)a[9], (const float*)a[10], (float*)a[11],
      (float*)a[12], (int)a[18], (int)a[25], count, (int)a[19], (int)a[20],
      (int)a[21], (float)eff, (float)inv_q, e, passes, (cudaStream_t)a[26]);
}
