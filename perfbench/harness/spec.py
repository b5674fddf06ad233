"""Frozen 3GPP tables and index maps of the benchmark (numpy only).

The benchmark's own copies, so that its generator and its reference depend
on nothing the program under test defines: the QPP interleaver (TS 36.212
Table 5.1.3-3), CRC-24A/B (section 5.1.1), code block segmentation (section
5.1.2), the split of a transport block's channel bits over its code blocks
(section 5.1.4.1.2) and the turbo rate matcher's bit selection (section
5.1.4.1: sub-block interleaver, circular buffer, redundancy version).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

CRC24A = 0x864CFB
CRC24B = 0x800063
CRC_LEN = 24
Z = 6144                          # largest code block

# (K, f1, f2): TS 36.212 Table 5.1.3-3, all 188 rows.
QPP_TABLE = (
    (40, 3, 10), (48, 7, 12), (56, 19, 42), (64, 7, 16), (72, 7, 18),
    (80, 11, 20), (88, 5, 22), (96, 11, 24), (104, 7, 26), (112, 41, 84),
    (120, 103, 90), (128, 15, 32), (136, 9, 34), (144, 17, 108), (152, 9, 38),
    (160, 21, 120), (168, 101, 84), (176, 21, 44), (184, 57, 46),
    (192, 23, 48), (200, 13, 50), (208, 27, 52), (216, 11, 36), (224, 27, 56),
    (232, 85, 58), (240, 29, 60), (248, 33, 62), (256, 15, 32),
    (264, 17, 198), (272, 33, 68), (280, 103, 210), (288, 19, 36),
    (296, 19, 74), (304, 37, 76), (312, 19, 78), (320, 21, 120),
    (328, 21, 82), (336, 115, 84), (344, 193, 86), (352, 21, 44),
    (360, 133, 90), (368, 81, 46), (376, 45, 94), (384, 23, 48),
    (392, 243, 98), (400, 151, 40), (408, 155, 102), (416, 25, 52),
    (424, 51, 106), (432, 47, 72), (440, 91, 110), (448, 29, 168),
    (456, 29, 114), (464, 247, 58), (472, 29, 118), (480, 89, 180),
    (488, 91, 122), (496, 157, 62), (504, 55, 84), (512, 31, 64),
    (528, 17, 66), (544, 35, 68), (560, 227, 420), (576, 65, 96),
    (592, 19, 74), (608, 37, 76), (624, 41, 234), (640, 39, 80),
    (656, 185, 82), (672, 43, 252), (688, 21, 86), (704, 155, 44),
    (720, 79, 120), (736, 139, 92), (752, 23, 94), (768, 217, 48),
    (784, 25, 98), (800, 17, 80), (816, 127, 102), (832, 25, 52),
    (848, 239, 106), (864, 17, 48), (880, 137, 110), (896, 215, 112),
    (912, 29, 114), (928, 15, 58), (944, 147, 118), (960, 29, 60),
    (976, 59, 122), (992, 65, 124), (1008, 55, 84), (1024, 31, 64),
    (1056, 17, 66), (1088, 171, 204), (1120, 67, 140), (1152, 35, 72),
    (1184, 19, 74), (1216, 39, 76), (1248, 19, 78), (1280, 199, 240),
    (1312, 21, 82), (1344, 211, 252), (1376, 21, 86), (1408, 43, 88),
    (1440, 149, 60), (1472, 45, 92), (1504, 49, 846), (1536, 71, 48),
    (1568, 13, 28), (1600, 17, 80), (1632, 25, 102), (1664, 183, 104),
    (1696, 55, 954), (1728, 127, 96), (1760, 27, 110), (1792, 29, 112),
    (1824, 29, 114), (1856, 57, 116), (1888, 45, 354), (1920, 31, 120),
    (1952, 59, 610), (1984, 185, 124), (2016, 113, 420), (2048, 31, 64),
    (2112, 17, 66), (2176, 171, 136), (2240, 209, 420), (2304, 253, 216),
    (2368, 367, 444), (2432, 265, 456), (2496, 181, 468), (2560, 39, 80),
    (2624, 27, 164), (2688, 127, 504), (2752, 143, 172), (2816, 43, 88),
    (2880, 29, 300), (2944, 45, 92), (3008, 157, 188), (3072, 47, 96),
    (3136, 13, 28), (3200, 111, 240), (3264, 443, 204), (3328, 51, 104),
    (3392, 51, 212), (3456, 451, 192), (3520, 257, 220), (3584, 57, 336),
    (3648, 313, 228), (3712, 271, 232), (3776, 179, 236), (3840, 331, 120),
    (3904, 363, 244), (3968, 375, 248), (4032, 127, 168), (4096, 31, 64),
    (4160, 33, 130), (4224, 43, 264), (4288, 33, 134), (4352, 477, 408),
    (4416, 35, 138), (4480, 233, 280), (4544, 357, 142), (4608, 337, 480),
    (4672, 37, 146), (4736, 71, 444), (4800, 71, 120), (4864, 37, 152),
    (4928, 39, 462), (4992, 127, 234), (5056, 39, 158), (5120, 39, 80),
    (5184, 31, 96), (5248, 113, 902), (5312, 41, 166), (5376, 251, 336),
    (5440, 43, 170), (5504, 21, 86), (5568, 43, 174), (5632, 45, 176),
    (5696, 45, 178), (5760, 161, 120), (5824, 89, 182), (5888, 323, 184),
    (5952, 47, 186), (6016, 23, 94), (6080, 47, 190), (6144, 263, 480),
)
QPP = {k: (f1, f2) for k, f1, f2 in QPP_TABLE}

# Inter-column permutation of the sub-block interleaver, Table 5.1.4-1.
COLUMN_PERM = (0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
               1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31)


@functools.lru_cache(maxsize=None)
def qpp_perm(K: int) -> np.ndarray:
    """pi(i) = (f1 i + f2 i^2) mod K: interleaved[i] = natural[pi(i)]."""
    f1, f2 = QPP[K]
    i = np.arange(K, dtype=np.int64)
    return (f1 * i + f2 * (i * i % K)) % K


@functools.lru_cache(maxsize=None)
def crc_parity_matrix(n: int, poly: int) -> np.ndarray:
    """(n, 24) 0/1 matrix M with crc(bits) = bits @ M mod 2 for n bits:
    row i is the remainder of D^(n - 1 - i + 24) modulo the generator."""
    g = (1 << CRC_LEN) | poly
    rows = np.zeros((n, CRC_LEN), dtype=np.int64)
    rem = poly                    # D^24 mod g
    for i in range(n - 1, -1, -1):
        rows[i] = [(rem >> (CRC_LEN - 1 - j)) & 1 for j in range(CRC_LEN)]
        rem <<= 1
        if rem >> CRC_LEN:
            rem ^= g
    return rows


def crc24(bits: np.ndarray, poly: int) -> np.ndarray:
    """The 24 parity bits of one bit vector, by long division (the
    spec's definition: register 0, MSB first, no final inversion)."""
    g = (1 << CRC_LEN) | poly
    reg = 0
    for b in list(np.asarray(bits, dtype=np.int64)) + [0] * CRC_LEN:
        reg = (reg << 1) | int(b)
        if reg >> CRC_LEN:
            reg ^= g
    return np.array([(reg >> (CRC_LEN - 1 - j)) & 1 for j in range(CRC_LEN)],
                    dtype=np.int8)


@dataclasses.dataclass(frozen=True)
class Segmentation:
    """Section 5.1.2 for a CRC-attached transport block of B bits."""
    B: int
    C: int
    K_plus: int
    K_minus: int
    C_minus: int
    F: int
    sizes: tuple[int, ...]        # block sizes in block order (K- first)

    def chunks(self) -> list[tuple[int, int]]:
        """(offset, length) of each block's share of the B input bits."""
        out, s = [], 0
        for r, K in enumerate(self.sizes):
            n = K - (CRC_LEN if self.C > 1 else 0) - (self.F if r == 0 else 0)
            out.append((s, n))
            s += n
        return out


def segment(B: int) -> Segmentation:
    legal = sorted(QPP)
    if B <= Z:
        C, Bp = 1, B
    else:
        C = -(-B // (Z - CRC_LEN))
        Bp = B + C * CRC_LEN
    K_plus = min(k for k in legal if C * k >= Bp)
    if C == 1:
        K_minus, C_minus = 0, 0
    else:
        K_minus = max(k for k in legal if k < K_plus)
        C_minus = (C * K_plus - Bp) // (K_plus - K_minus)
    C_plus = C - C_minus
    F = C_plus * K_plus + C_minus * K_minus - Bp
    return Segmentation(B, C, K_plus, K_minus, C_minus, F,
                        (K_minus,) * C_minus + (K_plus,) * C_plus)


def block_e(G: int, C: int, Qm: int, NL: int = 1) -> tuple[int, ...]:
    """Section 5.1.4.1.2: E_r of each of C blocks sharing G channel bits;
    the first C - gamma blocks get the floor, the rest the ceiling."""
    Gp = G // (NL * Qm)
    gamma = Gp % C
    return tuple(NL * Qm * (Gp // C if r <= C - gamma - 1 else -(-Gp // C))
                 for r in range(C))


@functools.lru_cache(maxsize=None)
def selection(K: int, E: int, rv: int = 0, F: int = 0) -> np.ndarray:
    """Indices into the flat [d0 | d1 | d2] streams (each D = K + 4 long)
    of the E transmitted bits in order (section 5.1.4.1, N_cb = K_w as
    for the UL-SCH).  Dummy and filler positions are skipped."""
    D = K + 4
    R = -(-D // 32)
    Kp = 32 * R
    ND = Kp - D
    col = np.asarray(COLUMN_PERM, dtype=np.int64)
    # y = <NULL>^ND ++ d; v0/v1 read column by column after permuting the
    # columns of the row-by-row written R x 32 matrix; v2 through pi(k).
    v01 = np.arange(Kp).reshape(R, 32)[:, col].T.reshape(-1)
    k = np.arange(Kp)
    v2 = (col[k // R] + 32 * (k % R) + 1) % Kp
    flat = np.empty(3 * Kp, dtype=np.int64)      # circular buffer -> y index
    stream = np.empty(3 * Kp, dtype=np.int64)
    flat[:Kp], stream[:Kp] = v01, 0
    flat[Kp::2], stream[Kp::2] = v01, 1
    flat[Kp + 1::2], stream[Kp + 1::2] = v2, 2
    pos = flat - ND                              # position in d, < 0 dummy
    ok = pos >= 0
    if F:
        ok &= ~((stream < 2) & (pos < F))       # fillers of d0 and d1
    Ncb = 3 * Kp
    k0 = R * (2 * -(-Ncb // (8 * R)) * rv + 2)
    order = (k0 + np.arange(Ncb)) % Ncb
    order = order[ok[order]]
    reps = -(-E // len(order))
    picks = np.tile(order, reps)[:E]
    return stream[picks] * D + pos[picks]
