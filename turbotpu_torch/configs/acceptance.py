"""The named acceptance configurations: C1-C5 plus C3-RM (mixed-K +
per-group rate matching) of the BER sweep, and C6 of the transport-block
sweep.

The port's own copy of configs/acceptance.py: the same values, with
siso="cuda" where the JAX package says "pallas".  C5's sharded decode runs
through `python -m turbotpu_torch.cli c5` (harness/c5.py); `ber --config c5`
sweeps the same decoder configuration monolithically.
"""

from ..decoder.turbo import DecoderConfig
from ..harness.ber import SimConfig
from ..harness.tb import TBConfig

# C1: LTE rate-1/3, K=40 QPP, single codeword, 4 iters, AWGN BPSK.
C1 = SimConfig(
    name="c1_lte_k40",
    K=40, B=1,
    ebn0_db_grid=(0.0, 1.0, 2.0, 3.0),
    decoder=DecoderConfig(K=40, n_iters=4, mode="logmap"),
    use_crc=False,
    min_frame_errors=30,
    steps_per_check=32,
)

# C2: LTE K=6144 max block, max-log-MAP, 6 iters, batch=64.
C2 = SimConfig(
    name="c2_lte_k6144",
    K=6144, B=64,
    ebn0_db_grid=(0.4, 0.6, 0.8, 1.0),
    decoder=DecoderConfig(K=6144, n_iters=6, mode="maxlog", ext_scale=0.75,
                          siso="cuda", early_term="crc"),
    use_crc=True,
    min_frame_errors=30,
    steps_per_check=8,
)

# C3: UMTS (prunable interleaver), CRC early termination, mixed block sizes
# decoded in ONE batch: each codeword is a TRUE K_mix[i]-size codeword
# (own interleaver, own 3K+12 transmission, per-K Eb/N0 accounting),
# embedded into the K=5114 bucket with leading known-filler LLRs and
# decoded through per-codeword permutation tables.
C3_SIZES = (320, 1280, 5114)
C3 = SimConfig(
    name="c3_umts_mixed",
    K=5114, K_mix=C3_SIZES, B=128,
    ebn0_db_grid=(0.5, 1.0, 1.5),
    decoder=DecoderConfig(K=5114, n_iters=8, mode="linlog",
                          interleaver="umts", early_term="crc",
                          siso="cuda"),
    use_crc=True,
    min_frame_errors=30,
    max_frames=51_200,
    steps_per_check=8,
)

# C3-RM: TRUE mixed-K LTE batch where each group is rate-matched to its own
# proportional E_g (aggregate rate 1/2) and decoded in one embedded call.
C3_RM = SimConfig(
    name="c3rm_mixed_rate_matched",
    K=5056, K_mix=(320, 1280, 5056), B=96,
    E=10112,                      # rate 1/2; per-group E_g = E*K_g/K
    ebn0_db_grid=(1.2, 1.6, 2.0),
    decoder=DecoderConfig(K=5056, n_iters=8, mode="linlog",
                          early_term="crc", siso="cuda"),
    use_crc=True,
    min_frame_errors=30,
    max_frames=38_400,
    steps_per_check=8,
)

# C4: rate-matched LTE (puncturing + repetition) full Eb/N0 sweep.
C4_PUNCTURED = SimConfig(
    name="c4_rm_punctured",
    K=1024, B=128,
    # rate 1/2 via puncturing: E = 2*K
    E=2048, rv=0,
    ebn0_db_grid=(1.0, 1.4, 1.8, 2.2),
    decoder=DecoderConfig(K=1024, n_iters=8, mode="linlog", early_term="crc",
                          siso="cuda"),
    use_crc=True,
    min_frame_errors=30,
    max_frames=51_200,
    steps_per_check=8,
)
C4_REPEATED = SimConfig(
    name="c4_rm_repeated",
    K=1024, B=128,
    # rate 1/4 via repetition: E = 4*K > 3K+12
    E=4096, rv=0,
    ebn0_db_grid=(-0.6, -0.2, 0.2, 0.6),
    decoder=DecoderConfig(K=1024, n_iters=8, mode="linlog", early_term="crc",
                          siso="cuda"),
    use_crc=True,
    min_frame_errors=30,
    max_frames=51_200,
    steps_per_check=8,
)

# C5: 4096 codewords, sliding-window BCJR, boundary exchanges.  The decoder
# configuration of the sharded C5 decode (harness/c5.run_c5 with --nii
# --window 256): the fused chunk kernel with bfloat16 LLR streams and CRC
# early termination on a (data, seq) mesh, NII inside the chunk too.
C5 = SimConfig(
    name="c5_multihost",
    K=6144, B=4096,
    ebn0_db_grid=(0.8,),
    decoder=DecoderConfig(K=6144, n_iters=6, mode="maxlog",
                          siso="cuda", io_dtype="bfloat16",
                          early_term="crc", nii=True, window=256),
    use_crc=True,
    min_frame_errors=30,
)

# C6: segmented transport block, fully device-side.  A = 12000 info bits
# -> B = 12024 with CRC-24A -> C = 2 code blocks (K- = 6016, K+ = 6080,
# F = 24 fillers), each rate-matched to its E_r share of G = 24000
# (aggregate rate 1/2), decoded in ONE embedded mixed-K call with CRC-24B
# early termination, reassembled and CRC-24A checked on device.
# Run: python -m turbotpu_torch.cli tb --config c6.
C6_TB = TBConfig(
    name="c6_transport_block",
    A=12000, n_tb=32, G=24000,
    ebn0_db_grid=(1.2, 1.4, 1.6),
    n_iters=8, mode="maxlog", siso="cuda", io_dtype="bfloat16",
    min_tb_errors=20, max_tbs=4096,
)

ALL = {
    "c1": C1,
    "c2": C2,
    "c3": C3,
    "c3rm": C3_RM,
    "c4": (C4_PUNCTURED, C4_REPEATED),
    "c5": C5,
    "c6": C6_TB,
}
