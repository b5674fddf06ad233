"""Sharded decoding over a (data, seq) mesh: dist/mesh.py (the grid, local
or one shard per torch.distributed rank), dist/seq_parallel.py (the
sequence-sharded decoder), dist/dma.py (K6, the boundary ring exchange),
dist/data_parallel.py, dist/multihost.py."""
