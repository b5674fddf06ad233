"""Measurements that hold a kernel of their own: what a folded row gather
costs (gather_inkernel) and what the card's fp32 pipes deliver to one warp
and to a full SM (cost_breakdown).  Counterparts of the JAX package's
experiments/gather_inkernel.py and experiments/cost_breakdown.py."""
