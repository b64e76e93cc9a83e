"""Monte-Carlo BER/FER simulation harness (waterfall curves).

Batched replacement for the reference's standalone simulators
(/root/reference/apps/ldpc_lapack.cpp and ldpc_umfpack.cpp): the per-frame
encode/noise/decode loop becomes the mesh-sharded batched sweep step
(parallel/sweep.py), and the MATLAB plotting script the reference prints is
reproduced alongside JSON and matplotlib outputs.
"""

from .waterfall import WaterfallResult, run_waterfall

__all__ = ["WaterfallResult", "run_waterfall"]
