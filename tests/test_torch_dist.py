"""The mesh, K6's plain version, the data-parallel decode, the C5 runner and
the process mesh of the port (turbotpu_torch/dist/, harness/c5.py), on the
CPU.

Counterparts of tests/dist/test_dma.py, test_data_parallel.py and
test_multiprocess.py.  The port needs no JAX here: K6's plain version is
held to a rotation made with torch.roll, the decodes with the two boundary
exchanges to each other, the process mesh (four gloo processes) to the
local mesh.  The kernel itself is held to its plain version on a card by the
test marked `cuda` and by chip_smoke.py.
"""

import time

import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from turbotpu_torch import DecoderConfig, _device, turbo_decode
from turbotpu_torch.dist import dma, multihost
from turbotpu_torch.dist.data_parallel import (count_errors_sharded,
                                               decode_batch_sharded)
from turbotpu_torch.dist.mesh import make_mesh
from turbotpu_torch.dist.seq_parallel import decode_seq_sharded
from turbotpu_torch.harness.bench import make_decode_inputs
from turbotpu_torch.harness.c5 import run_c5


def _payloads(n_rows, n_seq, shape=(2, 8, 16), sign=1.0):
    n = n_rows * n_seq
    return [sign * torch.arange(i * 1000, i * 1000 + np.prod(shape),
                                dtype=torch.float32).reshape(shape)
            for i in range(n)]


def _rolled(xs, n_seq, shift):
    """The ring rotation within each row by torch.roll on the stacked rows."""
    rows = torch.stack(xs).reshape(-1, n_seq, *xs[0].shape)
    return list(torch.roll(rows, shift, dims=1).reshape(-1, *xs[0].shape))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_k6_plain_matches_ring_rotation(n):
    """Forward payloads move to seq shard s+1, backward ones to s-1, within
    each data row: the plain version, and the wrapper on CPU tensors of a
    local mesh (which takes it), against torch.roll."""
    for n_rows in (1, 2):
        fwd, bwd = _payloads(n_rows, n), _payloads(n_rows, n, sign=-1.0)
        mesh = make_mesh(n_rows, n, device="cpu")
        for got in (dma.boundary_exchange_plain(fwd, bwd, n),
                    dma.boundary_exchange_dma(fwd, bwd, mesh),
                    mesh.seq_ring(fwd, bwd)):
            for a, b in zip(got[0], _rolled(fwd, n, 1)):
                assert torch.equal(a, b)
            for a, b in zip(got[1], _rolled(bwd, n, -1)):
                assert torch.equal(a, b)
    assert _device.LAUNCHES["ring_xch"] == 0      # CPU tensors launch nothing


def test_k6_iterated_in_a_loop():
    """The decode loop's use: payloads exchanged again and again, changed in
    between; tracks the rotation every trip."""
    n, trips = 4, 5
    mesh = make_mesh(1, n, device="cpu")
    f, b = _payloads(1, n), _payloads(1, n, sign=-1.0)
    rf, rb = list(f), list(b)
    for _ in range(trips):
        f, b = dma.boundary_exchange_dma(f, b, mesh)
        f, b = [x + 1.0 for x in f], [x - 1.0 for x in b]
        rf = [x + 1.0 for x in _rolled(rf, n, 1)]
        rb = [x - 1.0 for x in _rolled(rb, n, -1)]
    assert all(torch.equal(x, y) for x, y in zip(f + b, rf + rb))
    with pytest.raises(ValueError, match="one payload per shard"):
        dma.boundary_exchange_dma(f[:2], b[:2], mesh)


def test_k6_error_flag_is_read_by_check():
    """An exchange reads nothing back: a timeout sets the ring's sticky
    error flag, and `dma.check` reads the flags of every ring of the mesh
    and raises with the fault's message.  On the CPU the buffers carry the
    flags but no per-CTA counts."""
    mesh = make_mesh(1, 2, device="cpu")
    dma.check(mesh)                       # no ring yet: nothing to read
    ring = dma.ring_buffers(mesh, 2, (2, 8, 16), torch.float32)
    assert ring.ctas == 0 and ring.flags.shape == (2 * 2 + 1,)
    dma.check(mesh)
    for code, message in ((1, "never signalled the barrier"),
                          (2, "incoming payload never landed")):
        ring.flags.zero_()
        ring.error.fill_(code)
        with pytest.raises(RuntimeError, match=message):
            dma.check(mesh)


@pytest.mark.parametrize("nii", [False, True])
def test_seq_decode_checks_k6_once(monkeypatch, nii):
    """The sequence-sharded decode with boundary_xch='dma' exchanges once per
    iteration and reads the error flags once, after its iterations; with the
    ring shift it reads none."""
    calls = {"check": 0, "exchange": 0}
    check, exchange = dma.check, dma.boundary_exchange_dma

    def counted(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped
    monkeypatch.setattr(dma, "check", counted("check", check))
    monkeypatch.setattr(dma, "boundary_exchange_dma",
                        counted("exchange", exchange))
    inputs = make_decode_inputs(168, 8, seed=4, ebn0_db=1.5)
    mesh = make_mesh(1, 2, device="cpu")
    base = dict(K=168, n_iters=3, mode="maxlog", siso="cuda", nii=nii,
                window=16 if nii else 0)
    decode_seq_sharded(mesh, DecoderConfig(**base, boundary_xch="dma"))(
        *inputs)
    assert calls == {"check": 1, "exchange": 3}
    decode_seq_sharded(mesh, DecoderConfig(**base))(*inputs)
    assert calls == {"check": 1, "exchange": 3}


@pytest.mark.parametrize("nii", [False, True])
def test_seq_decode_dma_equals_ppermute(nii):
    """boundary_xch='dma' through the sharded decode (payload stacking, the
    NII edge pinning) equals the ring shift of the mesh bit for bit, on a
    2x4 local mesh with CRC early termination."""
    inputs = make_decode_inputs(168, 8, seed=3, ebn0_db=1.5, with_crc=True)
    mesh = make_mesh(2, 4, device="cpu")
    base = dict(K=168, n_iters=2, mode="maxlog", siso="cuda",
                early_term="crc", nii=nii)
    outs = [decode_seq_sharded(mesh, DecoderConfig(**base, boundary_xch=x))(
        *inputs) for x in ("ppermute", "dma")]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_data_parallel_decode_and_counts():
    """decode_batch_sharded equals the single decode; count_errors_sharded
    sums over data only, so a seq axis does not multiply the counts."""
    K, B = 40, 8
    inputs, bits = make_decode_inputs(K, B, seed=1, ebn0_db=0.5,
                                      return_bits=True)
    cfg = DecoderConfig(K=K, n_iters=2)
    want = turbo_decode(*inputs, cfg, device="cpu")
    for data, seq in ((4, 2), (2, 1), (1, 4)):
        mesh = make_mesh(data, seq, device="cpu")
        got = decode_batch_sharded(mesh, cfg)(*inputs)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        bit, frame = count_errors_sharded(mesh)(got[0], bits)
        wrong = got[0].numpy() != bits
        assert (int(bit), int(frame)) == (int(wrong.sum()),
                                          int(wrong.any(axis=1).sum()))
        assert int(bit) > 0


def test_run_c5_cpu_record():
    """A tiny run_c5 on the CPU: a well-formed record with the reference's
    keys, the backend and the real mesh."""
    rec = run_c5(K=40, B=8, n_iters=3, seq=2, n_timed=1, verbose=False,
                 nii=True, window=16, device="cpu")
    for key in ("K", "B", "mesh", "siso", "nii", "window", "io_dtype",
                "ext_dtype", "seq_groups", "seq_groups_effective",
                "boundary_xch", "early_term", "processes", "devices",
                "ebn0_db", "bit_errs", "frame_errs", "ber", "fer", "wall_s",
                "timed_reps", "mbit_per_s", "backend"):
        assert key in rec
    assert rec["mesh"] == {"data": 1, "seq": 2} and rec["backend"] == "local"
    assert rec["device"] == "cpu" and rec["timer"] == "host_clock"
    assert 0 <= rec["fer"] <= 1 and rec["wall_s"] > 0
    assert 1 <= rec["max_iters"] <= 3


def test_cli_c5_runs_on_the_cpu(capsys):
    """`cli c5` on the CPU at a tiny size prints one JSON record of the mesh
    it ran, here with the K6 path's plain version on a 2x2 local mesh."""
    import json

    from turbotpu_torch import cli
    assert cli.main(["c5", "--device", "cpu", "--k", "40", "--batch", "8",
                     "--iters", "2", "--reps", "1", "--data", "2", "--nii",
                     "--window", "16", "--xch", "dma"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["mesh"] == {"data": 2, "seq": 2} and rec["B"] == 8
    assert rec["boundary_xch"] == "dma" and rec["nii"] is True


def test_multihost_single_process():
    """Without a coordinator or a process count nothing is initialised; a
    local mesh's share of a batch is all of it."""
    assert multihost.init_distributed() is False
    mesh = make_mesh(2, 2, device="cpu")
    assert multihost.host_local_batch(64, mesh) == 64
    assert multihost.host_local_batch(64) == 64
    x = multihost.make_global_array(np.ones((4, 3), np.float32), mesh)
    assert isinstance(x, torch.Tensor) and x.shape == (4, 3)
    with pytest.raises(ValueError, match="coordinator"):
        multihost.init_distributed(num_processes=2)


def test_process_mesh_equals_local_mesh(tmp_path, monkeypatch):
    """Four gloo processes, data=2 x seq=2, one shard each (the port's
    counterpart of tests/dist/test_multiprocess.py): every rank's outputs
    of the kernel route (exact + CRC, NII + dma), the scan route and the
    data-parallel decode equal the local mesh's for its data row, bit for
    bit, and the counts are the global ones on every rank."""
    data, seq = 2, 2
    world = data * seq
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")   # the ranks talk locally
    ctx = torch.multiprocessing.start_processes(
        worker.run, args=(world, str(tmp_path / "store"), str(tmp_path), data,
                          seq),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + 150
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the gloo ranks timed out"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    inputs, bits = worker.batch()
    local = make_mesh(data, seq, device="cpu")
    want = {name: decode_seq_sharded(local, cfg)(*inputs)
            for name, cfg in worker.CONFIGS.items()}
    want_dp = decode_batch_sharded(local, worker.CONFIGS["scan-sign"])(
        *inputs)[0]
    wrong = want["cells-exact-crc"][0].numpy() != bits
    counts = (int(wrong.sum()), int(wrong.any(axis=1).sum()))
    per_row = worker.B // data
    for rank in range(world):
        got = torch.load(tmp_path / f"rank{rank}.pt")
        rows = slice(rank // seq * per_row, (rank // seq + 1) * per_row)
        for name in worker.CONFIGS:
            for a, b in zip(got[name], want[name]):
                assert torch.equal(a, b[rows]), (rank, name)
        assert torch.equal(got["data_parallel_hard"], want_dp[rows])
        assert tuple(int(x) for x in got["counts"]) == counts


@pytest.mark.cuda
def test_k6_kernel_matches_plain_on_card():
    """Needs a card: K6 against the rotation over 20 exchanges on a 2x4
    local mesh, and the flags after them: ready at 2 x 20, arrivals at
    2 x ctas x 20, no error, every CTA's count at 20."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    mesh = make_mesh(2, 4, device="cuda")
    n_seq = 4
    for epoch in range(20):
        f = [x.cuda() + epoch for x in _payloads(2, n_seq, (2, 8, 100))]
        b = [x.cuda() - epoch for x in _payloads(2, n_seq, (2, 8, 100), -1.0)]
        rf, rb = dma.boundary_exchange_dma(f, b, mesh)
        pf, pb = dma.boundary_exchange_plain(f, b, n_seq)
        assert all(torch.equal(x, y) for x, y in zip(rf + rb, pf + pb))
    ring = dma.ring_buffers(mesh, 8, (2, 8, 100), torch.float32)
    flags = ring.flags.tolist()
    assert flags[:8] == [2 * 20] * 8
    assert flags[8:16] == [2 * ring.ctas * 20] * 8 and flags[16] == 0
    assert flags[17:] == [20] * (8 * ring.ctas)
    dma.check(mesh)
