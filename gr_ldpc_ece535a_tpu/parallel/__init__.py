"""Multi-chip scaling: device meshes, sharded sweeps, stream sharding.

The reference has no multi-device execution of any kind (SURVEY.md §2,
"Parallelism / distribution inventory"); its only concurrency is the GNU
Radio one-thread-per-block scheduler and its only "distributed" boundary is
the analog RF link between transmitter.grc and receiver.grc. This package
provides the device-mesh scaling layer:

  mesh.py    jax.sharding.Mesh construction helpers (hosts x chips)
  sweep.py   codeword-batch data parallelism: the Monte-Carlo BER/FER step
             sharded over the mesh with psum-aggregated statistics
  stream.py  time-block ("sequence") parallelism over a continuous symbol
             stream with (N-1)-symbol halo exchange between neighboring
             shards via ppermute, so frames crossing shard boundaries decode
             locally
  receiver.py batched (offset x polarity) sync acquisition + the full
             mesh-sharded streaming receiver built on stream.py
"""

from .mesh import make_mesh, mesh_axis_sizes
from .receiver import Acquisition, ReceiveResult, StreamReceiver, acquire
from .stream import shard_stream_decode, stream_decode_reference
from .sweep import SweepStats, make_sweep_step

__all__ = [
    "Acquisition",
    "ReceiveResult",
    "StreamReceiver",
    "SweepStats",
    "acquire",
    "make_mesh",
    "make_sweep_step",
    "mesh_axis_sizes",
    "shard_stream_decode",
    "stream_decode_reference",
]
