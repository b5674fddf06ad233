// Fused BCJR SISO half-iteration for Hopper (sm_90a), in the three max*
// modes: max-log, linlog and log-MAP.
//
// Replaces the TPU kernel turbotpu/siso/pallas_kernel.py::_make_kernel (built
// there by _build_call), with the max* of _mstar/_mstar_tree and the per-leaf
// _extrinsic of the same file, in its two non-boundary contracts:
//   NII   (nii=True):  window-start alphas come from the previous
//                      half-iteration (ain), fresh ones go out (aout);
//   exact (nii=False): no approximation: every window starts from the true
//                      alpha and beta at its edges.
// Both emit the extrinsic
//   Le = max*(u=0 edges) - max*(u=1 edges)
// from alpha before each step and beta after it.  Both run window-parallel
// on the same two passes (nii_pass1/exact_pass1, then exact_pass2, with their
// own note below): the contracts differ only in where alpha comes from.  Beta
// is exact in both: it runs continuously backward from e0 at the padded
// trellis end through every window.
// The serial schedule (siso_kernel: one thread per codeword walks the windows
// backward, recomputing alpha through each into a scratch and running beta
// down it) remains for two forms, each a library of its own:
// K4, the boundary contracts of the same function (boundary=True, with and
// without nii, with_offset; consumed by the sequence-sharded decoder): the
// trellis is one chunk of a longer one, so the recursions start from edge
// metrics the caller passes in and the edges at the chunk's ends go out:
//   exact + boundary: phase 1 starts from a0, and alpha at the chunk end goes
//                     out; beta starts from bT, and beta at the chunk start
//                     goes out;
//   NII + boundary:   window 0 starts from the received edge_in; the last
//                     window's end alpha goes out as eout, beside the
//                     shifted-slot writes of the window table; beta as above.
// The a-priori mask is on the global row off + t < K, with K the global info
// length and off the chunk's first row.  A compile-time BND of the kernel,
// built as a library of its own (-DSISO_BND=1), so a decode without the
// sequence path never compiles it; with a0 = bT = edge_in = e0 and off = 0
// the boundary forms equal the exact and NII kernels bit for bit.  They add
// four edge pointers and an offset and no work per step, so they are bound
// as the serial kernel is (below), over the chunk's C steps: at the sequence
// path's batch (4096 codewords = 128 warps, about one per SM) by one warp's
// dependent chain.
// K5, a third form of the NII contract, folds the extrinsic interleave into
// the kernel (the reference's fold_gather=True call, pallas_call at :570 of
// the same file): the a-priori row of step t is read from row idx[t] of the
// OTHER SISO's raw output, through a (T,) int32 table shared by the batch,
// so the decoder runs no gather between the two half-iterations.  Everything
// after the read is the serial NII code, so its outputs equal the NII
// kernel's on a materialised gather bit for bit (-DSISO_FOLD=1).
// The mode is a compile-time parameter:
//   max-log  max*(a, b) = max(a, b); the parity add is factored out of the
//            extrinsic's reduction (exact there: rounding is monotone);
//   linlog   max(a, b) + max(0, 0.693147 - 0.25 |a - b|);
//   log-MAP  max(a, b) + log1p(exp(-|a - b|)), full-precision libm.
// linlog's clipped correction depends on the order of the reduction, so
// linlog and log-MAP reduce the extrinsic's 8 leaves per input bit, parity
// added per leaf, as a balanced pairwise tree in state order.
//
// Layout: every stream is time-major (T, B): element (t, b) at t*B + b, so
// the 32 codewords of a warp read 32 neighbouring values at each step.  That
// also holds for the folded read: row idx[t] is B contiguous values, the
// index is the same for the whole warp, and the warp reads one 32-byte (int8)
// to 128-byte (fp32) piece of it.  The reference issues one DMA per row for
// this; here it is an indexed load.  The index sits on the load's address
// chain (index load, 64-bit multiply-add, stream load), which the prefetch of
// a block of rows one block ahead has to absorb; the table is read through
// the read-only path from global memory (25.6 KB at T=6400: it stays in L1).
// A first version that copied the table to shared memory once per block
// measured about 3% slower than this plain form, at 1024 and at 16384
// codewords.
// Window tables (ain, aout) are (n_win, 8, B) fp32.  The serial kernel's
// alpha window scratch is (W, 8, B) fp32.  One thread decodes one codeword
// and keeps the 8 state metrics in registers; the trellis permutation is
// register renaming in the unrolled step.  No kernel allocates: the wrapper
// passes the scratch.
//
// Bound of the serial kernel (K4, K5): at the decoder's batch (1024
// codewords = 32 warps) the card is mostly empty, and the kernel is bound by
// latency, not by bytes (about 6 B per step and codeword) or by fp32 issue:
// one warp's dependent add/max chain over 2 x KTp steps (NII; 3 x KTp for the
// exact boundary form), plus every load it has to wait for.  What the design
// does about it: blocks are one warp wide so the codewords spread over as
// many SMs as possible, and streams and stored alphas are fetched a block of
// 8 steps at a time, one block ahead of the arithmetic, into a second set of
// registers (the two sets swap roles in a loop unrolled by two).  That
// prefetch is waited on in full (see cp_async below); the window-parallel
// passes are the way out, and K4 and K5 are next to take them.
//
// The corrections multiply the arithmetic per step (linlog about 2.5x the
// instructions of max-log, log-MAP two libm calls per max*) on the same
// dependent chain, so these modes are bound by issue and latency all the
// more; the memory side is unchanged.
//
// Arithmetic is kept in the reference's order so results agree bit for bit:
// explicit __fadd_rn/__fmul_rn (no FMA contraction), renormalisation by the
// 8-state max after every 8 steps counted from the window start, alphas
// stored before the step and un-renormalised inside a block, gamma(1,1)=A+P
// formed first, int8 codes rounded half-to-even (rintf).

#include <cuda_bf16.h>
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

// FOLD: la row t is read from row rows[t] (the gather table) instead of
// row t.
template <typename TC, typename TE, bool FOLD>
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
// fetch of the next block into `nxt`.  With aw != nullptr the alpha before
// each step goes to the window scratch (row t0 - window start = tw).
template <int MODE, typename TC, typename TE, bool FOLD>
__device__ __forceinline__ void alpha_block(
    const Streams<TC, TE, FOLD>& st, int t0, bool more,
    const Rows<TC, TE>& cur, Rows<TC, TE>& nxt, float (&alpha)[8], float* aw,
    int tw) {
  float A[UNROLL], P[UNROLL];
  st.metrics(cur, t0, A, P);
  if (more) st.fetch(t0 + UNROLL, nxt);
#pragma unroll
  for (int j = 0; j < UNROLL; ++j) {
    if (aw != nullptr) {
#pragma unroll
      for (int s = 0; s < 8; ++s)
        aw[((int64_t)(tw + j) * 8 + s) * st.B + st.b] = alpha[s];
    }
    alpha_step<MODE>(alpha, A[j], P[j]);
  }
  renorm(alpha);
}

// The window scratch is written and read back by the same thread within one
// launch: its pointer is never declared read-only.
__device__ __forceinline__ void fetch_alphas(const float* aw, int64_t B,
                                             int64_t b, int tw,
                                             float (&at)[UNROLL][8]) {
#pragma unroll
  for (int j = 0; j < UNROLL; ++j)
#pragma unroll
    for (int s = 0; s < 8; ++s)
      at[j][s] = aw[((int64_t)(tw + j) * 8 + s) * B + b];
}

// UNROLL backward steps over the block at t0 (window row tw): emit Le from
// the stored alphas and the running beta, then step beta.  The next block
// down (t0 - UNROLL) is fetched first.
template <int MODE, typename TC, typename TE, bool FOLD>
__device__ __forceinline__ void beta_block(
    const Streams<TC, TE, FOLD>& st, int t0, int tw, bool more,
    const Rows<TC, TE>& cur, const float (&at)[UNROLL][8],
    Rows<TC, TE>& nxt, float (&atn)[UNROLL][8], float (&beta)[8],
    const float* aw, TE* __restrict__ le, float inv_q) {
  float A[UNROLL], P[UNROLL];
  st.metrics(cur, t0, A, P);
  if (more) {
    st.fetch(t0 - UNROLL, nxt);
    fetch_alphas(aw, st.B, st.b, tw - UNROLL, atn);
  }
#pragma unroll
  for (int j = UNROLL - 1; j >= 0; --j) {
    st_le(le + (int64_t)(t0 + j) * st.B + st.b,
          extrinsic<MODE>(at[j], beta, P[j]), inv_q);
    beta_step<MODE>(beta, A[j], P[j]);
  }
  renorm(beta);
}

// K4's boundary operands, (8, B) fp32 each (state s of codeword b at
// s*B + b); null outside the BND instantiations, which alone read them.
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

template <typename TC, typename TE, bool NII, int MODE, bool FOLD, bool BND>
__global__ void siso_kernel(
    const TC* __restrict__ ls, const TC* __restrict__ lp,
    const TE* __restrict__ la, const int* __restrict__ idx,
    TE* __restrict__ le, const float* __restrict__ ain,
    float* __restrict__ aout, float* __restrict__ aw,
    float* __restrict__ ckpt, int B_, int K, int n_win, int W, float eff,
    float inv_q, Edges e) {
  static_assert(NII || !FOLD, "the folded read exists for the NII contract");
  static_assert(!(FOLD && BND), "the folded read has no boundary form");
  const int64_t B = B_;
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  // BND: the mask off + t < K is t < K - off on the chunk's own rows.
  const Streams<TC, TE, FOLD> st{ls, lp, la, idx, B, b, BND ? K - e.off : K,
                                 eff};
  const int T = n_win * W;
  Rows<TC, TE> r0, r1;

  if (!NII) {
    // Phase 1: forward alpha over the whole trellis, one checkpoint per
    // window start.
    float alpha[8];
    if (BND) load_edge(alpha, e.a_in, B, b); else init_e0(alpha);
    st.fetch(0, r0);
    for (int t0 = 0; t0 < T; t0 += 2 * UNROLL) {
      if (t0 % W == 0) {
#pragma unroll
        for (int s = 0; s < 8; ++s)
          ckpt[((int64_t)(t0 / W) * 8 + s) * B + b] = alpha[s];
      }
      alpha_block<MODE>(st, t0, t0 + UNROLL < T, r0, r1, alpha, nullptr, 0);
      const int t1 = t0 + UNROLL;
      if (t1 < T) {
        if (t1 % W == 0) {
#pragma unroll
          for (int s = 0; s < 8; ++s)
            ckpt[((int64_t)(t1 / W) * 8 + s) * B + b] = alpha[s];
        }
        alpha_block<MODE>(st, t1, t1 + UNROLL < T, r1, r0, alpha, nullptr, 0);
      }
    }
    if (BND) store_edge(e.a_out, alpha, B, b);  // alpha at the chunk end
  }

  // Phase 2: windows backward; recompute alpha, run beta, emit Le.
  float beta[8];
  if (BND) load_edge(beta, e.b_in, B, b); else init_e0(beta);
  for (int w = n_win - 1; w >= 0; --w) {
    const int base = w * W;
    st.fetch(base, r0);
    float alpha[8];
    if (NII) {
      if (w == 0) {
        if (BND) load_edge(alpha, e.a_in, B, b); else init_e0(alpha);
      } else {
#pragma unroll
        for (int s = 0; s < 8; ++s) alpha[s] = ain[((int64_t)w * 8 + s) * B + b];
      }
    } else {
#pragma unroll
      for (int s = 0; s < 8; ++s) alpha[s] = ckpt[((int64_t)w * 8 + s) * B + b];
    }

    for (int tw = 0; tw < W; tw += 2 * UNROLL) {
      alpha_block<MODE>(st, base + tw, tw + UNROLL < W, r0, r1, alpha, aw,
                        tw);
      if (tw + UNROLL < W)
        alpha_block<MODE>(st, base + tw + UNROLL, tw + 2 * UNROLL < W, r1, r0,
                          alpha, aw, tw + UNROLL);
    }
    if (NII && w + 1 < n_win) {
#pragma unroll
      for (int s = 0; s < 8; ++s)
        aout[((int64_t)(w + 1) * 8 + s) * B + b] = alpha[s];
    }
    // the last window's end is the outgoing chunk edge
    if (NII && BND && w == n_win - 1) store_edge(e.a_out, alpha, B, b);

    float a0[UNROLL][8], a1[UNROLL][8];
    st.fetch(base + W - UNROLL, r0);
    fetch_alphas(aw, B, b, W - UNROLL, a0);
    for (int tw = W - UNROLL; tw >= 0; tw -= 2 * UNROLL) {
      beta_block<MODE>(st, base + tw, tw, tw > 0, r0, a0, r1, a1, beta, aw, le,
                       inv_q);
      if (tw > 0)
        beta_block<MODE>(st, base + tw - UNROLL, tw - UNROLL, tw > UNROLL, r1,
                         a1, r0, a0, beta, aw, le, inv_q);
    }
  }
  if (BND) store_edge(e.b_out, beta, B, b);  // beta at the chunk start
}

// ---- the window-parallel passes (K2, K1 and K3's rows of both) ----------
//
// The serial schedule walks the trellis three times (exact) or twice (NII)
// in one thread per codeword.  Both contracts' outputs depend only on alpha
// and beta at each step.  Beta is, in both, a plain recursion from e0 at T
// with a renorm after every 8-step block (blocks aligned at multiples of 8
// from t = 0).  Alpha is one too in the exact contract, from e0 at t = 0; in
// the NII contract it restarts at every window start w*W from ain[w] (e0 for
// window 0), renormalised every 8 steps from that start.  So the trellis is
// cut into segments of seg steps (a power of two up to 64, a multiple of 8;
// for NII one that divides the window W, so every segment edge is an 8-step
// renorm edge of the window walk too; for exact any multiple of 8 gives the
// same values, since every segment edge is a block edge), and:
//   pass 1, beta: beta runs backward from e0 at T down to row seg and writes
//           beta at each segment end (bck[j], the beta entering segment j
//           from above, j <= n_seg-2), T - seg dependent steps.  A
//           codeword's 8 states sit on 8 lanes: each lane does its state's
//           step on two metrics shuffled in from the lanes of the successor
//           states, which cuts the dependent chain of a step to a shuffle,
//           an add and a max* and the instructions per lane to a few (one
//           thread per codeword, its rows staged the same way, measured
//           slower in every mode, max-log included).  The rows of each
//           8-step block are staged PASS1_DEPTH - 1 blocks ahead (cp.async
//           into a ring of tiles in shared memory; register loads where
//           B % 4 != 0); lane s forms row s's A and P, and the 8 lanes
//           exchange them.
//   pass 1, alpha (exact_pass1, other blockIdx.y): the same walk forward
//           from e0 over segments 0..n_seg-2, writing alpha at each segment
//           start (ack[j], j >= 1).
//   pass 1, alpha (nii_pass1, blocks after the beta walk's, one launch): one
//           thread per (window, codeword) walks alpha over its window's W
//           steps from ain[w], writes alpha at each segment start inside the
//           window (ack[j]; at the window start that is ain[w] itself) and
//           the window's end alpha to aout[w+1].  These are n_win x B walks
//           of W steps beside one walk of T - seg steps per codeword, so the
//           beta walk sets the pass's time.
//   pass 2 (exact_pass2, both contracts): one thread per (segment,
//           codeword) decodes its segment alone: alpha forward from ack[j]
//           (e0 for segment 0), keeping alpha at each 8-step block start in
//           shared memory (seg / 8 x 8 fp32 a thread); then block by block
//           backward, alpha recomputed over the block from its
//           sub-checkpoint into registers, and beta from bck[j] (e0 for the
//           last segment) steps down the block emitting Le.
// Every value is produced by the same step functions on the same operands in
// the same order as the serial schedule (the renorm's max over 8 lanes is a
// tree, which is exact for fmaxf), so Le and aout are equal bit for bit.
// The critical path is T - seg + 3 seg steps (one warp's beta walk, then one
// segment) instead of 3T (exact) or 2T (NII); the segment alphas never leave
// the SM, and at the decoder's batch pass 2 has n_seg x B independent threads
// (100 x 1024 at the flagship shape).
// Bound: as the serial kernel, latency and not bytes or issue at the
// decoder's batch; pass 1's beta walk, a chain of a shuffle, an add and a
// max* per step and three shuffle-max levels per renorm, is the critical
// path, and it is the same walk in both contracts: the NII contract saves
// the forward walk's instructions, not its time.
constexpr int EXACT_THREADS = 32;  // pass 1 and pass 2 blocks: one warp
constexpr int PASS1_CW = EXACT_THREADS / 8;  // pass 1: codewords per warp
constexpr int PASS1_DEPTH = 8;     // row blocks in flight in pass 1
constexpr unsigned FULL = 0xffffffffu;

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

// One walk of pass 1 for the lane's (codeword b, state s).  Block i covers
// rows i*8.. (forward) or T - (i+1)*8.. (backward), fetched PASS1_DEPTH - 1
// blocks ahead of the arithmetic.  STAGED (B % 4 == 0, aligned streams): 24
// lanes each copy one row of one stream for the warp's 4 codewords into a
// ring of tiles in shared memory; otherwise lane s loads row s of each
// stream into registers.  Lane s forms row s's A and P, and the 8 lanes of
// the codeword exchange them.  (Doing that for block i + 1 before block i's
// steps, to overlap their chain, measured 15-30% slower on an H100.)
template <int MODE, bool FWD, bool STAGED, typename TC, typename TE>
__device__ __forceinline__ void walk(const TC* __restrict__ ls,
                                     const TC* __restrict__ lp,
                                     const TE* __restrict__ la, float* ck,
                                     int64_t B, int64_t b, bool live, int K,
                                     int n_win, int W, float eff,
                                     Tile<TC, TE>* tiles) {
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
  // block i into slot d (a group of copies, committed even when empty)
  auto fetch = [&](int i, int d) {
    if constexpr (STAGED) {
      if (i < nb) {
        const int64_t o = (int64_t)(row0(i) + s) * B + (b - c);
        if (c == 0) cp_async<PASS1_CW * sizeof(TC)>(tiles[d].ls[s], ls + o);
        if (c == 1) cp_async<PASS1_CW * sizeof(TC)>(tiles[d].lp[s], lp + o);
        if (c == 2) cp_async<PASS1_CW * sizeof(TE)>(tiles[d].la[s], la + o);
      }
      cp_async_commit();
    } else {
      if (i >= nb) return;
      const int64_t o = (int64_t)(row0(i) + s) * B + b;
      rls[d] = ls[o];
      rlp[d] = lp[o];
      rla[d] = la[o];
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
  float m = s == 0 ? 0.0f : -BIG;  // e0
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

// Pass 1: blockIdx.y 0 walks alpha, 1 walks beta, PASS1_CW codewords a warp,
// 8 lanes each.  Lanes of codewords past B walk the last codeword and store
// nothing: every lane takes part in every shuffle.
template <int MODE, bool STAGED, typename TC, typename TE>
__global__ void exact_pass1(const TC* __restrict__ ls,
                            const TC* __restrict__ lp,
                            const TE* __restrict__ la, float* __restrict__ ack,
                            float* __restrict__ bck, int B_, int K, int n_win,
                            int W, float eff) {
  __shared__ __align__(16) Tile<TC, TE> tiles[STAGED ? PASS1_DEPTH : 1];
  const int64_t B = B_;
  const int64_t bq = (int64_t)blockIdx.x * PASS1_CW + (threadIdx.x >> 3);
  const bool live = bq < B;
  const int64_t b = live ? bq : B - 1;
  if (blockIdx.y == 0)
    walk<MODE, true, STAGED>(ls, lp, la, ack, B, b, live, K, n_win, W, eff,
                             tiles);
  else
    walk<MODE, false, STAGED>(ls, lp, la, bck, B, b, live, K, n_win, W, eff,
                              tiles);
}

// The NII contract's alpha walk of window w for codeword st.b (pass 1):
// from ain[w] (e0 for window 0), renormalised after every 8-step block of the
// window as the serial kernel does; alpha at each segment start inside the
// window goes to ack (segment 0's slot is never read), the window's end to
// aout[w + 1] (the last window's end goes nowhere).
template <int MODE, typename TC, typename TE>
__device__ __forceinline__ void window_alpha(const Streams<TC, TE, false>& st,
                                             const float* __restrict__ ain,
                                             float* __restrict__ aout,
                                             float* __restrict__ ack, int w,
                                             int n_win, int W, int seg) {
  const int64_t B = st.B, b = st.b;
  const int base = w * W;
  float alpha[8];
  if (w == 0) init_e0(alpha);
  else load_edge(alpha, ain + (int64_t)w * 8 * B, B, b);
  Rows<TC, TE> r0, r1;
  st.fetch(base, r0);
  for (int tw = 0; tw < W; tw += 2 * UNROLL) {
    if (tw % seg == 0 && base + tw > 0)
      store_edge(ack + (int64_t)((base + tw) / seg) * 8 * B, alpha, B, b);
    alpha_block<MODE>(st, base + tw, tw + UNROLL < W, r0, r1, alpha, nullptr,
                      0);
    const int t1 = tw + UNROLL;
    if (t1 == W) break;
    if (t1 % seg == 0)
      store_edge(ack + (int64_t)((base + t1) / seg) * 8 * B, alpha, B, b);
    alpha_block<MODE>(st, base + t1, t1 + UNROLL < W, r1, r0, alpha, nullptr,
                      0);
  }
  if (w + 1 < n_win) store_edge(aout + (int64_t)(w + 1) * 8 * B, alpha, B, b);
}

// K1's pass 1, one launch: blocks [0, n_beta) walk beta over the segments as
// exact_pass1's beta slice does (PASS1_CW codewords a warp, 8 lanes each);
// the n_win x ceil(B / 32) blocks after them walk the window alphas, one
// thread per (window, codeword).  The beta blocks come first, so the long
// walk starts first and the short ones fill the SMs beside it.
template <int MODE, bool STAGED, typename TC, typename TE>
__global__ void nii_pass1(const TC* __restrict__ ls, const TC* __restrict__ lp,
                          const TE* __restrict__ la,
                          const float* __restrict__ ain,
                          float* __restrict__ aout, float* __restrict__ ack,
                          float* __restrict__ bck, int B_, int K, int n_win,
                          int W, int seg, int n_beta, float eff) {
  __shared__ __align__(16) Tile<TC, TE> tiles[STAGED ? PASS1_DEPTH : 1];
  const int64_t B = B_;
  if ((int)blockIdx.x < n_beta) {
    const int64_t bq = (int64_t)blockIdx.x * PASS1_CW + (threadIdx.x >> 3);
    const bool live = bq < B;
    walk<MODE, false, STAGED>(ls, lp, la, bck, B, live ? bq : B - 1, live, K,
                              n_win * W / seg, seg, eff, tiles);
    return;
  }
  const int i = (int)blockIdx.x - n_beta;
  const int gx = (B_ + EXACT_THREADS - 1) / EXACT_THREADS;
  const int64_t b = (int64_t)(i % gx) * EXACT_THREADS + threadIdx.x;
  if (b >= B) return;
  const Streams<TC, TE, false> st{ls, lp, la, nullptr, B, b, K, eff};
  window_alpha<MODE>(st, ain, aout, ack, i / gx, n_win, W, seg);
}

// Pass 2, one backward block at t0 (window block i): alpha over the block
// recomputed from its sub-checkpoint (the alpha before each step, no renorm
// inside a block), then Le and beta from the block's last row down.  The
// next block down is fetched first.
template <int MODE, typename TC, typename TE>
__device__ __forceinline__ void exact_block(
    const Streams<TC, TE, false>& st, int t0, bool more,
    const Rows<TC, TE>& cur, Rows<TC, TE>& nxt, const float* sub,
    float (&beta)[8], TE* __restrict__ le, float inv_q) {
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
                            const TE* __restrict__ la, TE* __restrict__ le,
                            const float* __restrict__ ack,
                            const float* __restrict__ bck, int B_, int K,
                            int n_win, int W, float eff, float inv_q) {
  // the sub-checkpoints of the block's EXACT_THREADS codewords: (W / UNROLL,
  // 8, EXACT_THREADS) fp32, state s of block i of lane l at (i*8 + s)*32 + l
  extern __shared__ float exact_sub[];
  const int64_t B = B_;
  const int lane = threadIdx.x;
  const int64_t b = (int64_t)blockIdx.x * EXACT_THREADS + lane;
  if (b >= B) return;  // each thread reads only its own shared memory
  const Streams<TC, TE, false> st{ls, lp, la, nullptr, B, b, K, eff};
  const int w = blockIdx.y, base = w * W, nsub = W / UNROLL;
  float* sub = exact_sub + lane;
  Rows<TC, TE> r0, r1;

  float alpha[8];
  if (w == 0) init_e0(alpha);
  else load_edge(alpha, ack + (int64_t)w * 8 * B, B, b);
  st.fetch(base, r0);
  // forward: alpha at each block start; the last block's steps are unused
  for (int i = 0; i < nsub; i += 2) {
#pragma unroll
    for (int s = 0; s < 8; ++s) sub[(i * 8 + s) * EXACT_THREADS] = alpha[s];
    if (i + 1 == nsub) break;
    alpha_block<MODE>(st, base + i * UNROLL, true, r0, r1, alpha, nullptr, 0);
#pragma unroll
    for (int s = 0; s < 8; ++s)
      sub[((i + 1) * 8 + s) * EXACT_THREADS] = alpha[s];
    if (i + 2 == nsub) break;
    alpha_block<MODE>(st, base + (i + 1) * UNROLL, true, r1, r0, alpha,
                      nullptr, 0);
  }

  float beta[8];
  if (w == n_win - 1) init_e0(beta);
  else load_edge(beta, bck + (int64_t)w * 8 * B, B, b);
  st.fetch(base + W - UNROLL, r0);
  for (int i = nsub - 1; i >= 0; i -= 2) {
    exact_block<MODE>(st, base + i * UNROLL, i > 0, r0, r1,
                      sub + i * 8 * EXACT_THREADS, beta, le, inv_q);
    if (i == 0) break;
    exact_block<MODE>(st, base + (i - 1) * UNROLL, i > 1, r1, r0,
                      sub + (i - 1) * 8 * EXACT_THREADS, beta, le, inv_q);
  }
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

// The window-parallel contracts on one stream.  ck is (2, n_seg, 8, B) fp32:
// alpha checkpoints (slot 0 unused), then beta checkpoints (slot n_seg - 1
// unused).  Exact: (n_win, W) are the segments, ain/aout unused.  NII:
// (n_win, W) are the windows, ain/aout the (n_win, 8, B) window tables.
template <typename TC, typename TE, int MODE>
cudaError_t launch_parallel(bool nii, const void* ls, const void* lp,
                            const void* la, void* le, const float* ain,
                            float* aout, float* ck, int B, int K, int n_win,
                            int W, float eff, float inv_q, int passes,
                            cudaStream_t stream) {
  const int seg = nii ? segment_of(W) : W;
  const int n_seg = n_win * W / seg;
  float* ack = ck;
  float* bck = ck + (int64_t)n_seg * 8 * B;
  const unsigned gx = (unsigned)((B + EXACT_THREADS - 1) / EXACT_THREADS);
  // staged: every warp's rows are whole aligned pieces of 4 codewords
  const bool staged = B % PASS1_CW == 0 &&
                      ((uintptr_t)ls | (uintptr_t)lp | (uintptr_t)la) % 16 == 0;
  // one segment: pass 2 starts from e0 at both ends, and no window table is
  // written (one window)
  if ((passes & PASS1) && n_seg > 1) {
    const TC* cls = (const TC*)ls;
    const TC* clp = (const TC*)lp;
    const TE* cla = (const TE*)la;
    if (nii) {
      const int n_beta = (B + PASS1_CW - 1) / PASS1_CW;
      const dim3 g1((unsigned)(n_beta + n_win * (int)gx));
      if (staged)
        nii_pass1<MODE, true, TC, TE><<<g1, dim3(EXACT_THREADS), 0, stream>>>(
            cls, clp, cla, ain, aout, ack, bck, B, K, n_win, W, seg, n_beta,
            eff);
      else
        nii_pass1<MODE, false, TC, TE><<<g1, dim3(EXACT_THREADS), 0, stream>>>(
            cls, clp, cla, ain, aout, ack, bck, B, K, n_win, W, seg, n_beta,
            eff);
    } else {
      const dim3 g1((unsigned)((B + PASS1_CW - 1) / PASS1_CW), 2);
      if (staged)
        exact_pass1<MODE, true, TC, TE><<<g1, dim3(EXACT_THREADS), 0,
                                          stream>>>(cls, clp, cla, ack, bck, B,
                                                    K, n_seg, seg, eff);
      else
        exact_pass1<MODE, false, TC, TE><<<g1, dim3(EXACT_THREADS), 0,
                                           stream>>>(cls, clp, cla, ack, bck,
                                                     B, K, n_seg, seg, eff);
    }
  }
  if (passes & PASS2) {
    // segments of at most 64 steps take 8 KB
    const size_t smem = (size_t)seg * 8 * EXACT_THREADS * sizeof(float) / UNROLL;
    if (smem > 48 * 1024) return cudaErrorInvalidValue;
    exact_pass2<MODE, TC, TE><<<dim3(gx, n_seg), dim3(EXACT_THREADS), smem,
                                stream>>>((const TC*)ls, (const TC*)lp,
                                          (const TE*)la, (TE*)le, ack, bck, B,
                                          K, n_seg, seg, eff, inv_q);
  }
  return cudaGetLastError();
}

template <typename TC, typename TE, int MODE>
cudaError_t launch(bool nii, const void* ls, const void* lp, const void* la,
                   const int* idx, void* le, const float* ain, float* aout,
                   float* aw, float* ckpt, int B, int K, int n_win, int W,
                   float eff, float inv_q, int threads, cudaStream_t stream,
                   const Edges& e) {
#if SISO_FOLD || SISO_BND
  // the serial kernel: K5 (folded read, NII) or K4 (boundary forms)
  constexpr bool FOLD = SISO_FOLD != 0, BND = SISO_BND != 0;
  const dim3 grid((B + threads - 1) / threads), block(threads);
  if (FOLD && (!nii || idx == nullptr)) return cudaErrorInvalidValue;
  if (!FOLD && idx != nullptr) return cudaErrorInvalidValue;
  if (nii)
    siso_kernel<TC, TE, true, MODE, FOLD, BND><<<grid, block, 0, stream>>>(
        (const TC*)ls, (const TC*)lp, (const TE*)la, idx, (TE*)le, ain, aout,
        aw, ckpt, B, K, n_win, W, eff, inv_q, e);
  else if constexpr (!FOLD)
    siso_kernel<TC, TE, false, MODE, false, BND><<<grid, block, 0, stream>>>(
        (const TC*)ls, (const TC*)lp, (const TE*)la, idx, (TE*)le, ain, aout,
        aw, ckpt, B, K, n_win, W, eff, inv_q, e);
  return cudaGetLastError();
#else
  // the plain library: both contracts window-parallel, no serial kernel
  if (idx != nullptr) return cudaErrorInvalidValue;
  return launch_parallel<TC, TE, MODE>(nii, ls, lp, la, le, ain, aout, ckpt,
                                       B, K, n_win, W, eff, inv_q,
                                       PASS1 | PASS2, stream);
#endif
}

}  // namespace

// One library holds one variant, chosen at compile time:
//   -DSISO_MODE=  0 max-log, 1 linlog, 2 log-MAP
//   -DSISO_CHAN=  0 float32, 1 bfloat16          (ls, lp)
//   -DSISO_EXT=   0 float32, 1 bfloat16, 2 int8  (la in, le out)
//   -DSISO_FOLD=  0 (default) the NII and the exact contract, both
//                 window-parallel,
//                 1 the serial NII kernel with the folded read (K5), alone
//   -DSISO_BND=   0 (default), or 1: the serial NII and exact kernels in
//                 their boundary forms (K4), alone, behind
//                 turbotpu_siso_bnd_launch
// (the variants compile side by side, and a decode builds only its own; the
// folded and the boundary kernels are libraries of their own so that a
// decode without them never waits for their compile).
#if !defined(SISO_MODE) || !defined(SISO_CHAN) || !defined(SISO_EXT)
#error "compile with -DSISO_MODE=, -DSISO_CHAN= and -DSISO_EXT="
#endif
#if SISO_FOLD && SISO_BND
#error "SISO_FOLD and SISO_BND are separate libraries"
#endif
#if SISO_MODE < 0 || SISO_MODE > 2 || SISO_CHAN < 0 || SISO_CHAN > 1 || \
    SISO_EXT < 0 || SISO_EXT > 2
#error "unknown SISO_MODE, SISO_CHAN or SISO_EXT"
#endif

namespace {
template <int CODE> struct StreamType;
template <> struct StreamType<0> { using type = float; };
template <> struct StreamType<1> { using type = __nv_bfloat16; };
template <> struct StreamType<2> { using type = int8_t; };
}  // namespace

// mode, chan_type, ext_type: the caller's codes, which must be this
// library's (else -1).
// The plain library (SISO_FOLD=0, SISO_BND=0), window-parallel:
//   nii != 0: (n_win, W) are the windows; ain/aout are (n_win, 8, B) fp32,
//             ckpt is (2, n_win * W / segment_of(W), 8, B) fp32 scratch;
//   nii == 0: (n_win, W) are the segments the wrapper cut (W =
//             segment_of(n_win * W)); ckpt is (2, n_win, 8, B) fp32 scratch,
//             ain/aout unused;
//   idx is null; aw and threads are unused.
// The serial libraries (SISO_FOLD=1, SISO_BND=1): aw is (W, 8, B) fp32
// scratch and threads the block size; nii != 0: ain/aout as above, ckpt
// unused; nii == 0 (BND only): ckpt is (n_win, 8, B) fp32 scratch.  In a
// SISO_FOLD library idx is the (n_win * W,) int32 gather table with values
// in [0, n_win * W) (nii != 0 only).
// Returns the launch's cudaError_t (0 = ok), the first failing one of its
// launches.
#if SISO_BND
// The boundary forms: a_in, b_in, a_out, b_out are (8, B) fp32 (see Edges);
// off is the chunk's first global row and K the global info length.
extern "C" int turbotpu_siso_bnd_launch(
    int mode, int chan_type, int ext_type, int nii, const void* ls,
    const void* lp, const void* la, void* le, const void* ain, void* aout,
    void* aw, void* ckpt, const void* a_in, const void* b_in, void* a_out,
    void* b_out, int off, int B, int K, int n_win, int W, float eff,
    float inv_q, int threads, void* stream) {
  if (mode != SISO_MODE || chan_type != SISO_CHAN || ext_type != SISO_EXT)
    return -1;
  if (a_in == nullptr || b_in == nullptr || a_out == nullptr ||
      b_out == nullptr)
    return (int)cudaErrorInvalidValue;
  const Edges e{(const float*)a_in, (const float*)b_in, (float*)a_out,
                (float*)b_out, off};
  return (int)launch<StreamType<SISO_CHAN>::type, StreamType<SISO_EXT>::type,
                     SISO_MODE>(
      nii != 0, ls, lp, la, nullptr, le, (const float*)ain, (float*)aout,
      (float*)aw, (float*)ckpt, B, K, n_win, W, eff, inv_q, threads,
      (cudaStream_t)stream, e);
}
#else
extern "C" int turbotpu_siso_launch(
    int mode, int chan_type, int ext_type, int nii, const void* ls,
    const void* lp, const void* la, const void* idx, void* le,
    const void* ain, void* aout, void* aw, void* ckpt, int B, int K,
    int n_win, int W, float eff, float inv_q, int threads, void* stream) {
  if (mode != SISO_MODE || chan_type != SISO_CHAN || ext_type != SISO_EXT)
    return -1;
  return (int)launch<StreamType<SISO_CHAN>::type, StreamType<SISO_EXT>::type,
                     SISO_MODE>(
      nii != 0, ls, lp, la, (const int*)idx, le, (const float*)ain,
      (float*)aout, (float*)aw, (float*)ckpt, B, K, n_win, W, eff, inv_q,
      threads, (cudaStream_t)stream, Edges{});
}
#if !SISO_FOLD
// One pass of the plain library's window-parallel contracts alone (pass 1 or
// 2), with the operands of turbotpu_siso_launch, to time it.  Pass 2 reads
// the checkpoints in ckpt, so a full launch on the same operands comes first.
extern "C" int turbotpu_siso_pass_launch(
    int pass, int mode, int chan_type, int ext_type, int nii, const void* ls,
    const void* lp, const void* la, void* le, const void* ain, void* aout,
    void* ckpt, int B, int K, int n_win, int W, float eff, float inv_q,
    void* stream) {
  if (mode != SISO_MODE || chan_type != SISO_CHAN || ext_type != SISO_EXT)
    return -1;
  if (pass != PASS1 && pass != PASS2) return (int)cudaErrorInvalidValue;
  return (int)launch_parallel<StreamType<SISO_CHAN>::type,
                              StreamType<SISO_EXT>::type, SISO_MODE>(
      nii != 0, ls, lp, la, le, (const float*)ain, (float*)aout,
      (float*)ckpt, B, K, n_win, W, eff, inv_q, pass, (cudaStream_t)stream);
}
#endif
#endif
