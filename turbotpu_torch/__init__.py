"""turbotpu_torch: the PyTorch/CUDA port of the turbotpu 3GPP turbo decoder.

A package of its own beside the JAX package `turbotpu`, which stays the
reference.  It imports torch and numpy, never jax and nothing of turbotpu.
Its public names are the reference's:

    from turbotpu_torch import DecoderConfig, turbo_decode, SimConfig, simulate_ber
"""

from .decoder.turbo import DecoderConfig, turbo_decode

__version__ = "0.1.0"
__all__ = ["DecoderConfig", "turbo_decode", "SimConfig", "simulate_ber",
           "encode_transport_block", "transmit_transport_block",
           "decode_transport_block", "embedded_perm_tables",
           "grouped_perm_tables", "decode_mixed",
           "__version__"]


def __getattr__(name):
    # Lazy imports keep `import turbotpu_torch` light (the harness pulls in
    # the transmit chain).
    if name in ("SimConfig", "simulate_ber"):
        from .harness import ber
        return getattr(ber, name)
    if name in ("encode_transport_block", "transmit_transport_block",
                "decode_transport_block"):
        from . import transport
        return getattr(transport, name)
    if name in ("embedded_perm_tables", "grouped_perm_tables",
                "decode_mixed"):
        from .decoder import bucketing
        return getattr(bucketing, name)
    raise AttributeError(name)
