"""The one way from Python into a CUDA kernel, checked without a card.

Every C entry of the port takes one pointer to a block of int64 arguments
(`_build.PackedEntry`), called through `_device.launch_on`, which appends
the stream and counts the launch in `_device.LAUNCHES`.  A field missing
from the block or added to it shows only on a card; here each entry's C
function is read from its `.cu` source instead, and the highest field it
reads (the stream, last) must be the entry's `n_args - 1`.  On CPU tensors
every wrapper takes its plain version and leaves the one count as it was.

JAX-free: `python -m pytest --noconftest tests/test_torch_launch.py` runs it
where JAX is not installed.
"""

from __future__ import annotations

import importlib
import pkgutil
import re

import pytest
import torch

import turbotpu_torch
from turbotpu_torch import _build, _device, harq
from turbotpu_torch.decoder import layout
from turbotpu_torch.dist import dma
from turbotpu_torch.dist.mesh import make_mesh
from turbotpu_torch.experiments import cost_breakdown as cb
from turbotpu_torch.experiments import gather_inkernel as gi
from turbotpu_torch.siso import cuda_kernel as ck
from turbotpu_torch.spec.crc import CRC24B_POLY


def _packed_entries() -> dict[str, _build.PackedEntry]:
    """Every PackedEntry the package holds at module level, and the SISO
    libraries' entry (one C function for all 72 of them), by symbol."""
    found = {}
    for info in pkgutil.walk_packages(turbotpu_torch.__path__,
                                      "turbotpu_torch."):
        if info.name.endswith("__main__"):
            continue
        module = importlib.import_module(info.name)
        for value in vars(module).values():
            if isinstance(value, _build.PackedEntry):
                found[value.symbol] = value
    siso = ck._entry("maxlog", torch.float32, torch.float32)
    found[siso.symbol] = siso
    return found


ENTRIES = _packed_entries()


def _c_body(source: str, symbol: str) -> str:
    """The body of `extern "C" int symbol(const int64_t* a)` in source."""
    head = re.search(r'extern "C" int ' + re.escape(symbol)
                     + r"\(const int64_t\* a\) \{", source)
    assert head, f"{symbol} is not a packed C entry"
    depth, i = 1, head.end()
    while depth:
        depth += {"{": 1, "}": -1}.get(source[i], 0)
        i += 1
    return source[head.end():i - 1]


def test_every_kernel_source_has_its_entry():
    """Nine packed C entries: layout.cu's four, one each in harq.cu,
    ring_xch.cu, row_gather.cu, issue_rate.cu and siso.cu."""
    assert sorted(ENTRIES) == sorted([
        "turbotpu_pack_streams_launch", "turbotpu_assemble_outputs_launch",
        "turbotpu_crc_exit_launch", "turbotpu_live_compact_launch",
        "turbotpu_harq_combine_launch",
        "turbotpu_ring_xch_launch", "turbotpu_row_gather_launch",
        "turbotpu_issue_rate_launch", "turbotpu_siso_launch"])
    sources = {e.target[0] for e in ENTRIES.values()}
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == sources


@pytest.mark.parametrize("symbol", sorted(ENTRIES))
def test_packed_entry_reads_its_block(symbol):
    """The highest field the C entry reads, the stream, is the last of the
    n_args the Python side packs (launch_on appends the stream)."""
    entry = ENTRIES[symbol]
    body = _c_body((_build.CSRC / f"{entry.target[0]}.cu").read_text(),
                   symbol)
    read = {int(i) for i in re.findall(r"\ba\[(\d+)\]", body)}
    assert max(read) + 1 == entry.n_args, (symbol, sorted(read))
    assert re.search(rf"\(cudaStream_t\)a\[{entry.n_args - 1}\]", body)


def test_siso_entry_reads_every_field():
    """The SISO entry reads each of its 27 fields: passes, the codes and
    nii, twelve pointers, five sizes, eff and inv_q, the live count and the
    columns its grid spans, the stream."""
    body = _c_body((_build.CSRC / "siso.cu").read_text(),
                   "turbotpu_siso_launch")
    read = {int(i) for i in re.findall(r"\ba\[(\d+)\]", body)}
    assert read == set(range(27))


def _streams(KTp=48, B=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((KTp, B), generator=g) * 3,
            torch.randn((KTp, B), generator=g) * 3)


def _siso(contract):
    ls, lp = _streams()
    KTp, B = ls.shape
    W, K = 16, 40
    la = torch.zeros_like(ls)
    e0 = ck._e0(B, "cpu")
    ain = torch.zeros((KTp // W, 8, B))
    kw = {"exact": {}, "nii": {"nii_ckpt": ain},
          "fold": {"nii_ckpt": ain,
                   "gather_idx": torch.randperm(KTp).to(torch.int32)},
          "bnd_exact": {"boundaries": (e0, e0)},
          "bnd_nii": {"nii_boundaries": (ain, e0, e0)},
          "live": {"nii_ckpt": ain,
                   "live": (torch.tensor([3], dtype=torch.int32), B)},
          }[contract]
    ck.siso_cells(ls, lp, la, K, "maxlog", window=W, **kw)


def _pack():
    B, K = 3, 40
    g = torch.Generator().manual_seed(1)
    ls, lp1, lp2 = (torch.randn((B, K), generator=g) for _ in range(3))
    tail1, tail2 = (torch.randn((B, 6), generator=g) for _ in range(2))
    layout.pack_streams(ls, lp1, lp2, tail1, tail2, 48, torch.bfloat16,
                        torch.randperm(K))


def _assemble():
    ls, le = _streams()
    layout.assemble_outputs(ls, le, le.neg(), 40, 0.75, torch.float32)


def _exit():
    ls, le = _streams()
    B = ls.shape[1]
    layout.crc_exit(ls, le, le, le.clone(), le, le.clone(),
                    torch.zeros(B, dtype=torch.bool),
                    torch.zeros(B, dtype=torch.int32), 40, 0.75,
                    torch.float32, CRC24B_POLY)


def _live():
    ls, le = _streams()
    B = ls.shape[1]
    live = layout.live_prefix(B, torch.device("cpu"))
    le1, le21 = le.clone(), le.neg()
    layout.live_syndromes(ls, le1, le21, 40, 0.75, torch.float32,
                          CRC24B_POLY, live, B)
    layout.retire_outputs(torch.zeros((B, 40), dtype=torch.int8),
                          torch.zeros((B, 40)), ls, le1, le21, 40, 0.75,
                          torch.float32, live, B, False)
    layout.live_compact(torch.zeros(B, dtype=torch.bool),
                        torch.zeros(B, dtype=torch.int32), live,
                        (ls, ls.clone(), ls.clone(), ls.clone(), le21, None,
                         None), False)


def _combine():
    K, E, F, bucket, rows = 40, 150, 0, 40, 4
    table, period = harq.combine_table(K, E, F, bucket, torch.device("cpu"))
    streams = tuple(torch.zeros((rows, w)) for w in (bucket,) * 3 + (6, 6))
    harq.combine(streams, torch.randn((rows, E)), table, period,
                 torch.tensor([0, 2]), torch.tensor([True, False]))


def _ring():
    mesh = make_mesh(1, 2, device="cpu")
    fwd = [torch.randn(2, 8, 4) for _ in range(2)]
    dma.boundary_exchange_dma(fwd, [-x for x in fwd], mesh)


WRAPPERS = {
    **{f"siso_cells_{c}": (lambda c=c: _siso(c))
       for c in ("exact", "nii", "fold", "bnd_exact", "bnd_nii", "live")},
    "pack_streams": _pack,
    "assemble_outputs": _assemble,
    "crc_exit": _exit,
    "live_prefix": _live,
    "harq_combine": _combine,
    "ring_exchange": _ring,
    "row_gather": lambda: gi.row_gather(
        torch.arange(12, dtype=torch.int8).reshape(4, 3),
        torch.tensor([3, 0, 2, 1], dtype=torch.int32)),
    "issue_rate": lambda: cb.issue_rate(torch.rand(64), 8, 256),
}


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_cpu_wrappers_leave_the_count(wrapper):
    """On CPU tensors every kernel wrapper takes its plain version and
    launches nothing: the one launch count stays as it was."""
    before = _device.LAUNCHES.copy()
    WRAPPERS[wrapper]()
    assert _device.LAUNCHES == before
