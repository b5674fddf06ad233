"""The reference against the port on the CPU: bit for bit against the
port's plain rendering of its kernels (the path the card runs), and on the
decisions against the port's scan SISO path at small K."""

import dataclasses

import pytest
import torch

from pbtestlib import REPO  # noqa: F401
from perfbench.harness import gen, spec
from perfbench.reference import rx_ref, turbo_ref


def _port_config(K, W, early, iters=6):
    from turbotpu_torch.decoder.turbo import DecoderConfig
    return DecoderConfig(K=K, n_iters=iters, mode="maxlog", ext_scale=0.75,
                         siso="cuda", io_dtype="bfloat16", ext_dtype="int8",
                         ext_qscale=0.25, nii=True, window=W,
                         early_term=early, crc_poly=spec.CRC24A)


@pytest.mark.parametrize("K,W,early,ebn0", [(256, 64, "none", 0.5),
                                            (256, 64, "crc", 1.5),
                                            (512, 128, "crc", 1.0)])
def test_reference_equals_the_ports_kernel_path(K, W, early, ebn0):
    from turbotpu_torch.decoder.turbo import turbo_decode
    g = torch.Generator().manual_seed(K + W)
    streams = gen.codeblocks(g, 6, K, ebn0)
    h, it, L = turbo_decode(*streams, _port_config(K, W, early),
                            device="cpu")
    dec = turbo_ref.Decoder(K=K, window=W,
                            crc_poly=spec.CRC24A if early == "crc" else 0)
    rh, rit, rL = turbo_ref.decode(*streams, dec)
    assert torch.equal(h, rh) and torch.equal(it, rit) and torch.equal(L, rL)


def test_reference_agrees_with_the_ports_scan_path():
    """The port's exact log-domain scan SISO (max-log, fp32 extrinsics)
    and the reference (NII, bf16 channel, int8 extrinsics) reach the same
    decisions where the channel leaves no doubt: one window, 2.5 dB."""
    from turbotpu_torch.decoder.turbo import DecoderConfig, turbo_decode
    K = 104
    g = torch.Generator().manual_seed(11)
    streams = gen.codeblocks(g, 8, K, 2.5)
    cfg = DecoderConfig(K=K, n_iters=6, mode="maxlog", ext_scale=0.75,
                        siso="scan", early_term="crc", crc_poly=spec.CRC24A)
    h, it, _ = turbo_decode(*streams, cfg, device="cpu")
    rh, rit, _ = turbo_ref.decode(*streams, turbo_ref.Decoder(
        K=K, window=128, crc_poly=spec.CRC24A))
    assert torch.equal(h, rh) and torch.equal(it, rit)
    assert turbo_ref.crc_pass(rh, spec.CRC24A).all()


def test_receive_chain_equals_the_ports_transport_block_path():
    """Two transport blocks of a segmented size with filler bits in block
    0 and blocks of two sizes (A = 6400: C = 2, K 3264 and 3200... bucket
    3264) would take long on the CPU; one block of 250 bits with 6 fillers
    takes the same steps."""
    from turbotpu_torch.decoder.bucketing import grouped_perm_tables
    from turbotpu_torch.decoder.turbo import turbo_decode
    from turbotpu_torch.tx.rate_match import de_rate_match, lte_demux
    A, G, Qm = 250, 600, 2
    g = torch.Generator().manual_seed(5)
    runs, tx = gen.transport_blocks(g, 4, A, G, Qm, 1.5)
    seg, layout = gen.block_layout(A, G, Qm)
    (K, E, F), = layout
    ls, lp1, lp2, t1, t2 = lte_demux(de_rate_match(runs[0], K, 0, F=F))
    mine = rx_ref.demux(rx_ref.de_rate_match(runs[0], K, F), K)
    for a, b in zip((ls, lp1, lp2, t1, t2), mine):
        assert torch.equal(a, b)
    ls = ls.clone()
    ls[:, :F] = 1e9
    tables = grouped_perm_tables([K] * 4, K)
    h, it, L = turbo_decode(ls, lp1, lp2, t1, t2,
                            _port_config(K, 64, "crc"), group_tables=tables,
                            device="cpu")
    dec = turbo_ref.Decoder(K=K, window=64)
    tb, ok, rit, rL = rx_ref.receive(runs, 4, A, G, Qm, dec)
    assert torch.equal(rx_ref.reassemble(h, seg, 4), tb)
    assert torch.equal(it, rit) and torch.equal(L, rL)
    assert torch.equal(ok, (tb == tx).all(dim=1))


def test_control_precision_is_coarser():
    assert turbo_ref.INT4.code_max == 7
    assert turbo_ref.INT4.step * 7 == pytest.approx(127 * 0.25)
    assert dataclasses.replace(turbo_ref.INT8).step == 0.25
