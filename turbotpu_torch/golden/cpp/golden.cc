// Bit-exact C++ golden model for the 3GPP turbo code (TS 36.212 s5.1.3 /
// TS 25.212 s4.2.3): scalar RSC encoder + log-MAP / max-log-MAP BCJR turbo
// decoder.  This is the framework's native ground-truth component
// (SURVEY.md section 3, component 32) -- the role the CUDA reference's C++
// host model plays -- bound to Python via ctypes (pybind11 unavailable,
// SURVEY.md section 8 environment facts).
//
// Conventions match turbotpu/golden/numpy_ref.py exactly:
//   state s = (a_{k-1}<<2) | (a_{k-2}<<1) | a_{k-3}
//   g0 = 1 + D^2 + D^3 (feedback), g1 = 1 + D + D^3 (parity)
//   LLR positive favors bit 0; branch metric contribution -b * llr.
//
// Build: make (produces libgolden.so).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kStates = 8;
constexpr double kNegInf = -1e30;

struct Trellis {
  int next_state[kStates][2];
  int parity[kStates][2];
  int tail_bit[kStates];
  Trellis() {
    for (int s = 0; s < kStates; ++s) {
      int a1 = (s >> 2) & 1, a2 = (s >> 1) & 1, a3 = s & 1;
      int fb = a2 ^ a3;
      for (int u = 0; u < 2; ++u) {
        int ak = u ^ fb;
        parity[s][u] = ak ^ a1 ^ a3;
        next_state[s][u] = (ak << 2) | (a1 << 1) | a2;
      }
      tail_bit[s] = fb;
    }
  }
};

const Trellis kTrellis;

// mode: 0 = log-MAP (exact Jacobian), 1 = max-log, 2 = linlog (the
// piecewise-linear correction max(0, ln2 - |d|/4) of siso/maxstar.py;
// NOTE it is order-dependent -- this scalar model folds sequentially,
// the JAX kernels reduce in tree order, so linlog cross-checks carry a
// tolerance).
inline double maxstar(double a, double b, int mode) {
  double m = a > b ? a : b;
  if (mode == 1 || m <= kNegInf / 2) return m;
  if (mode == 2) {
    double c = 0.693147 - 0.25 * std::fabs(a - b);
    return m + (c > 0 ? c : 0);
  }
  return m + std::log1p(std::exp(-std::fabs(a - b)));
}

}  // namespace

extern "C" {

// Encode K bits; outputs: par[K], tail[6] = (x_K, z_K, ..., x_K+2, z_K+2).
void ttpu_rsc_encode(const int8_t* bits, int K, int8_t* par, int8_t* tail) {
  int s = 0;
  for (int k = 0; k < K; ++k) {
    int u = bits[k];
    par[k] = static_cast<int8_t>(kTrellis.parity[s][u]);
    s = kTrellis.next_state[s][u];
  }
  for (int t = 0; t < 3; ++t) {
    int u = kTrellis.tail_bit[s];
    tail[2 * t] = static_cast<int8_t>(u);
    tail[2 * t + 1] = static_cast<int8_t>(kTrellis.parity[s][u]);
    s = kTrellis.next_state[s][u];
  }
}

// Canonical-format turbo encode: sys[K], par1[K], par2[K], tail1[6], tail2[6].
void ttpu_turbo_encode(const int8_t* bits, int K, const int32_t* perm,
                       int8_t* sys, int8_t* par1, int8_t* par2,
                       int8_t* tail1, int8_t* tail2) {
  std::memcpy(sys, bits, static_cast<size_t>(K));
  ttpu_rsc_encode(bits, K, par1, tail1);
  std::vector<int8_t> ib(static_cast<size_t>(K));
  for (int i = 0; i < K; ++i) ib[static_cast<size_t>(i)] = bits[perm[i]];
  ttpu_rsc_encode(ib.data(), K, par2, tail2);
}

// One SISO half-iteration over the terminated K+3-step trellis.
// ls, lp: length K+3 (info + tail).  la: length K.  Outputs L[K], Le[K].
// mode: 0 = log-MAP, 1 = max-log-MAP, 2 = linlog.
void ttpu_bcjr_siso(const double* ls, const double* lp, const double* la,
                    int K, int maxlog, double* L, double* Le) {
  const int KT = K + 3;
  std::vector<double> alpha(static_cast<size_t>(KT + 1) * kStates, kNegInf);
  std::vector<double> beta(static_cast<size_t>(KT + 1) * kStates, kNegInf);
  auto A = [&](int k, int s) -> double& { return alpha[static_cast<size_t>(k) * kStates + s]; };
  auto B = [&](int k, int s) -> double& { return beta[static_cast<size_t>(k) * kStates + s]; };
  auto gamma = [&](int k, int u, int c) {
    double lak = k < K ? la[k] : 0.0;
    return -u * (lak + ls[k]) - c * lp[k];
  };

  A(0, 0) = 0.0;
  for (int k = 0; k < KT; ++k) {
    for (int s = 0; s < kStates; ++s) {
      if (A(k, s) <= kNegInf / 2) continue;
      for (int u = 0; u < 2; ++u) {
        int s2 = kTrellis.next_state[s][u];
        double m = A(k, s) + gamma(k, u, kTrellis.parity[s][u]);
        A(k + 1, s2) = maxstar(A(k + 1, s2), m, maxlog);
      }
    }
    double mx = kNegInf;
    for (int s = 0; s < kStates; ++s) mx = std::max(mx, A(k + 1, s));
    for (int s = 0; s < kStates; ++s) A(k + 1, s) -= mx;
  }

  B(KT, 0) = 0.0;
  for (int k = KT - 1; k >= 0; --k) {
    for (int s = 0; s < kStates; ++s) {
      for (int u = 0; u < 2; ++u) {
        int s2 = kTrellis.next_state[s][u];
        if (B(k + 1, s2) <= kNegInf / 2) continue;
        double m = B(k + 1, s2) + gamma(k, u, kTrellis.parity[s][u]);
        B(k, s) = maxstar(B(k, s), m, maxlog);
      }
    }
    double mx = kNegInf;
    for (int s = 0; s < kStates; ++s) mx = std::max(mx, B(k, s));
    for (int s = 0; s < kStates; ++s) B(k, s) -= mx;
  }

  for (int k = 0; k < K; ++k) {
    double m0 = kNegInf, m1 = kNegInf;
    for (int s = 0; s < kStates; ++s) {
      for (int u = 0; u < 2; ++u) {
        double m = A(k, s) + gamma(k, u, kTrellis.parity[s][u]) +
                   B(k + 1, kTrellis.next_state[s][u]);
        if (u == 0) m0 = maxstar(m0, m, maxlog);
        else m1 = maxstar(m1, m, maxlog);
      }
    }
    L[k] = m0 - m1;
    Le[k] = L[k] - la[k] - ls[k];
  }
}

// CRC-24 check (TS 36.212 s5.1.1): MSB-first division, init 0, no final
// XOR.  Returns 1 iff the trailing 24 bits of bits[0..n) are the CRC of
// the leading n-24.
int ttpu_crc_check(const int8_t* bits, int n, uint32_t poly) {
  if (n <= 24) return 0;
  uint32_t reg = 0;
  for (int i = 0; i < n - 24; ++i) {
    reg = ((reg << 1) | static_cast<uint32_t>(bits[i])) & 0x1FFFFFFu;
    if (reg >> 24) reg ^= (1u << 24) | poly;
  }
  for (int i = 0; i < 24; ++i) {
    reg = (reg << 1) & 0x1FFFFFFu;
    if (reg >> 24) reg ^= (1u << 24) | poly;
  }
  for (int i = 0; i < 24; ++i) {
    if (static_cast<int>((reg >> (23 - i)) & 1u) != bits[n - 24 + i]) return 0;
  }
  return 1;
}

// UMTS wire order (TS 25.212 s4.2.3.1): x1 z1 z'1 x2 z2 z'2 ... then the
// 12 tail bits x_K+1 z_K+1 ... x'_K+3 z'_K+3.  Generic over double so it
// serves both bit (cast) and LLR streams; length 3K + 12.
void ttpu_umts_mux(const double* sys, const double* par1, const double* par2,
                   const double* tail1, const double* tail2, int K,
                   double* wire) {
  for (int k = 0; k < K; ++k) {
    wire[3 * k] = sys[k];
    wire[3 * k + 1] = par1[k];
    wire[3 * k + 2] = par2[k];
  }
  for (int i = 0; i < 6; ++i) wire[3 * K + i] = tail1[i];
  for (int i = 0; i < 6; ++i) wire[3 * K + 6 + i] = tail2[i];
}

void ttpu_umts_demux(const double* wire, int K, double* sys, double* par1,
                     double* par2, double* tail1, double* tail2) {
  for (int k = 0; k < K; ++k) {
    sys[k] = wire[3 * k];
    par1[k] = wire[3 * k + 1];
    par2[k] = wire[3 * k + 2];
  }
  for (int i = 0; i < 6; ++i) tail1[i] = wire[3 * K + i];
  for (int i = 0; i < 6; ++i) tail2[i] = wire[3 * K + 6 + i];
}

// Full turbo decode, canonical-format LLRs.  Returns iterations run.
// tail1/tail2 layout: (x_K, z_K, x_K+1, z_K+1, x_K+2, z_K+2) per encoder.
// crc_poly != 0 enables CRC early termination: after each full iteration
// the hard decision is CRC-checked and decoding stops on success
// (component 20 parity with numpy_ref.turbo_decode).
int ttpu_turbo_decode(const double* ls, const double* lp1, const double* lp2,
                      const double* tail1, const double* tail2,
                      const int32_t* perm, const int32_t* inv, int K,
                      int n_iters, int maxlog, double ext_scale,
                      uint32_t crc_poly, int8_t* hard, double* L_out) {
  std::vector<double> ls1(static_cast<size_t>(K + 3)), lp1f(static_cast<size_t>(K + 3));
  std::vector<double> ls2(static_cast<size_t>(K + 3)), lp2f(static_cast<size_t>(K + 3));
  for (int k = 0; k < K; ++k) {
    ls1[static_cast<size_t>(k)] = ls[k];
    lp1f[static_cast<size_t>(k)] = lp1[k];
    ls2[static_cast<size_t>(k)] = ls[perm[k]];
    lp2f[static_cast<size_t>(k)] = lp2[k];
  }
  for (int t = 0; t < 3; ++t) {
    ls1[static_cast<size_t>(K + t)] = tail1[2 * t];
    lp1f[static_cast<size_t>(K + t)] = tail1[2 * t + 1];
    ls2[static_cast<size_t>(K + t)] = tail2[2 * t];
    lp2f[static_cast<size_t>(K + t)] = tail2[2 * t + 1];
  }

  std::vector<double> le21(static_cast<size_t>(K), 0.0), le1(static_cast<size_t>(K)),
      le2(static_cast<size_t>(K)), la2(static_cast<size_t>(K)), L(static_cast<size_t>(K)),
      tmp(static_cast<size_t>(K));
  int it = 0;
  for (it = 1; it <= n_iters; ++it) {
    ttpu_bcjr_siso(ls1.data(), lp1f.data(), le21.data(), K, maxlog, L.data(), le1.data());
    for (int k = 0; k < K; ++k) le1[static_cast<size_t>(k)] *= ext_scale;
    for (int k = 0; k < K; ++k) la2[static_cast<size_t>(k)] = le1[static_cast<size_t>(perm[k])];
    ttpu_bcjr_siso(ls2.data(), lp2f.data(), la2.data(), K, maxlog, tmp.data(), le2.data());
    for (int k = 0; k < K; ++k) le2[static_cast<size_t>(k)] *= ext_scale;
    for (int k = 0; k < K; ++k) le21[static_cast<size_t>(k)] = le2[static_cast<size_t>(inv[k])];
    for (int k = 0; k < K; ++k) L[static_cast<size_t>(k)] = ls[k] + le1[static_cast<size_t>(k)] + le21[static_cast<size_t>(k)];
    if (crc_poly != 0) {
      for (int k = 0; k < K; ++k) hard[k] = L[static_cast<size_t>(k)] < 0 ? 1 : 0;
      if (ttpu_crc_check(hard, K, crc_poly)) {
        if (L_out) for (int k = 0; k < K; ++k) L_out[k] = L[static_cast<size_t>(k)];
        return it;
      }
    }
  }
  for (int k = 0; k < K; ++k) {
    hard[k] = L[static_cast<size_t>(k)] < 0 ? 1 : 0;
    if (L_out) L_out[k] = L[static_cast<size_t>(k)];
  }
  return it - 1;
}

}  // extern "C"
