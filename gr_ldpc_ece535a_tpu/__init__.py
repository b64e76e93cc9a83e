"""gr_ldpc_ece535a_tpu — a JAX LDPC coded-modulation framework for GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
GNU Radio OOT module ``ericdegroot/gr-ldpc_ece535a``: GF(2) LDPC encoding,
BPSK mapping, AWGN channel, four belief-propagation-family decoders with a
frame-sync state machine, image/ASCII stream sinks, Monte-Carlo BER/FER
simulators, and mesh-sharded multi-chip scaling.

Layout:
  codes/     H-matrix data + host-side GF(2) LU preprocessing
  ops/       batched device ops (encode, channel, DSP, decode, Triton BP kernel)
  blocks/    streaming block layer (flowgraph, sync state machine, sinks)
  parallel/  jax.sharding mesh utilities, sharded sweeps, stream sharding
  sim/       BER/FER waterfall harness (ldpc_lapack/ldpc_umfpack equivalents)
  utils/     BMP io, bit packing, profiling
  runtime/   native C++ stream runtime (ring buffers, scanners) via ctypes
"""

__version__ = "0.1.0"

from . import codes

_SUBMODULES = ("blocks", "ops", "parallel", "runtime", "sim", "utils")

__all__ = ["codes", *_SUBMODULES, "__version__"]


def __getattr__(name):
    # lazy submodule import: `import gr_ldpc_ece535a_tpu` stays cheap (no jax
    # trace-time work) while `pkg.blocks` etc. resolve on first touch
    if name in _SUBMODULES:
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
