"""Device mesh construction.

Axis convention used across the framework:

  "batch"   data parallelism over the codeword batch (the primary axis — the
            Monte-Carlo sweep and the bulk decoder shard frames over it)
  "stream"  sequence parallelism over time-blocks of a continuous symbol
            stream (halo exchange between neighbors, parallel/stream.py)

A 1D mesh over "batch" is the common case; the streaming receiver uses a 2D
("stream", "batch") mesh. The cards of a host are joined all to all, so no
device order is closer than another: the axis order follows the algorithm
alone (the sweep's psum runs over "batch", the stream decode's neighbour
ppermute over "stream").
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "mesh_axis_sizes"]


def make_mesh(
    axes: Sequence[str] = ("batch",),
    shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a Mesh over the given logical axes.

    If ``shape`` is None, all devices go to the last axis (the batch axis in
    the ("stream", "batch") convention), with size-1 leading axes.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        shape = [1] * (len(axes) - 1) + [n]
    shape = list(shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, tuple(axes))


def mesh_axis_sizes(mesh: Mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))
