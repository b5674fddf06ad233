// Fused BCJR SISO half-iteration for Hopper (sm_90a), in the three max*
// modes: max-log, linlog and log-MAP.
//
// Replaces the TPU kernel turbotpu/siso/pallas_kernel.py::_make_kernel (built
// there by _build_call), with the max* of _mstar/_mstar_tree and the per-leaf
// _extrinsic of the same file, in its two non-boundary contracts:
//   NII   (nii=True):  window-start alphas come from the previous
//                      half-iteration (ain), fresh ones go out (aout);
//   exact (nii=False): phase 1 runs alpha forward and keeps one checkpoint
//                      per window, phase 2 starts each window from it.
// Both then walk the windows backward: recompute and store alpha through the
// window, run beta through it (continuous across windows, exact from e0 at
// the padded trellis end) and emit the extrinsic
//   Le = max*(u=0 edges) - max*(u=1 edges).
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
// the boundary forms are the exact and NII kernels bit for bit.  They add
// four edge pointers and an offset and no work per step, so they are bound
// as the others (below), over the chunk's C steps: at the sequence path's
// batch (4096 codewords = 128 warps, about one per SM) by one warp's
// dependent chain, as at 1024.
// A third form of the NII contract folds the extrinsic interleave into the
// kernel (the reference's fold_gather=True call, pallas_call at :570 of the
// same file): the a-priori row of step t is read from row idx[t] of the
// OTHER SISO's raw output, through a (T,) int32 table shared by the batch,
// so the decoder runs no gather between the two half-iterations.  Everything
// after the read is the NII kernel's code, so its outputs equal that kernel's
// on a materialised gather bit for bit.
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
// Checkpoints are (n_win, 8, B) fp32, the alpha window scratch (W, 8, B) fp32.
// One thread decodes one codeword and keeps the 8 state metrics in
// registers; the trellis permutation is register renaming in the unrolled
// step.  The kernel allocates nothing: the wrapper passes the scratch.
//
// Bound: at the decoder's batch (1024 codewords = 32 warps) the card is
// mostly empty, and the kernel is bound by latency, not by bytes (about 6 B
// per step and codeword) or by fp32 issue: one warp's dependent add/max
// chain over 2 x KTp steps, plus every load it has to wait for.  What the
// design does about it: blocks are one warp wide so the codewords spread
// over as many SMs as possible, and streams and stored alphas are fetched a
// block of 8 steps at a time, one block ahead of the arithmetic, into a
// second set of registers (the two sets swap roles in a loop unrolled by
// two).  Splitting a codeword's 8 states over 8 lanes is the next step.
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

template <typename TC, typename TE, int MODE>
cudaError_t launch(bool nii, const void* ls, const void* lp, const void* la,
                   const int* idx, void* le, const float* ain, float* aout,
                   float* aw, float* ckpt, int B, int K, int n_win, int W,
                   float eff, float inv_q, int threads, cudaStream_t stream,
                   const Edges& e) {
  const dim3 grid((B + threads - 1) / threads), block(threads);
#if SISO_FOLD
  if (!nii || idx == nullptr) return cudaErrorInvalidValue;
  siso_kernel<TC, TE, true, MODE, true, false><<<grid, block, 0, stream>>>(
      (const TC*)ls, (const TC*)lp, (const TE*)la, idx, (TE*)le, ain, aout,
      aw, ckpt, B, K, n_win, W, eff, inv_q, e);
#else
  constexpr bool BND = SISO_BND != 0;
  if (idx != nullptr) return cudaErrorInvalidValue;
  if (nii) {
    siso_kernel<TC, TE, true, MODE, false, BND><<<grid, block, 0, stream>>>(
        (const TC*)ls, (const TC*)lp, (const TE*)la, idx, (TE*)le, ain, aout,
        aw, ckpt, B, K, n_win, W, eff, inv_q, e);
  } else {
    siso_kernel<TC, TE, false, MODE, false, BND><<<grid, block, 0, stream>>>(
        (const TC*)ls, (const TC*)lp, (const TE*)la, idx, (TE*)le, ain, aout,
        aw, ckpt, B, K, n_win, W, eff, inv_q, e);
  }
#endif
  return cudaGetLastError();
}

}  // namespace

// One library holds one variant, chosen at compile time:
//   -DSISO_MODE=  0 max-log, 1 linlog, 2 log-MAP
//   -DSISO_CHAN=  0 float32, 1 bfloat16          (ls, lp)
//   -DSISO_EXT=   0 float32, 1 bfloat16, 2 int8  (la in, le out)
//   -DSISO_FOLD=  0 (default) the NII and the exact kernel,
//                 1 the NII kernel with the folded read, alone
//   -DSISO_BND=   0 (default), or 1: the NII and the exact kernel in their
//                 boundary forms (K4), alone, behind turbotpu_siso_bnd_launch
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
// nii != 0:  ain/aout are (n_win, 8, B) fp32, ckpt unused (may be null);
// nii == 0:  ckpt is (n_win, 8, B) fp32 scratch, ain/aout unused.
// idx: null, or in a SISO_FOLD library the (n_win * W,) int32 gather table
// with values in [0, n_win * W) (nii != 0 only).
// aw is (W, 8, B) fp32 scratch.  Returns the launch's cudaError_t (0 = ok).
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
#endif
