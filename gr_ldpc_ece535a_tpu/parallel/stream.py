"""Time-block ("sequence") sharding of a continuous symbol stream.

The reference receiver consumes one 64-symbol frame at a time in a single
thread (/root/reference/lib/ldpc_decoder_cb_impl.cc:147-234). The mesh
scale-out shards the stream itself: the time axis is cut into S contiguous
blocks, one per device along the mesh's "stream" axis, and each device
decodes every frame whose start falls inside its block. Because the frame
grid (period N) is not aligned to block boundaries, a frame can straddle two
shards; each shard therefore fetches the first N-1 symbols of its right
neighbor — a halo exchange via ``jax.lax.ppermute`` to the left neighbour —
which is exactly the amount the symbol-slip frame search can shift alignment
by (lib/ldpc_decoder_cb_impl.cc:194-199).

The exchange is a single neighbor permute per call (no all-gather of the
stream), so the communication volume per device is N-1 symbols regardless of
block length: the design scales to arbitrarily long streams at fixed
link cost.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..codes import LdpcCode
from ..ops import make_decoder, syndrome_weight

__all__ = ["shard_stream_decode", "stream_decode_reference"]


def stream_decode_reference(
    symbols: np.ndarray,
    code: LdpcCode,
    method: int | str = 0,
    iterations: int = 5,
    offset: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Unsharded oracle: decode every complete frame starting at offset+k*N.

    Returns (vhat (F, N) int8, syndrome_weights (F,)) for the F frames fully
    contained in the stream.
    """
    N = code.N
    T = len(symbols)
    F = max(0, (T - offset) // N)
    frames = np.asarray(symbols[offset : offset + F * N], np.float32).reshape(F, N)
    dec = make_decoder(code, method=method, iterations=iterations)
    vhat = np.asarray(dec(jnp.asarray(frames)))
    w = np.asarray(syndrome_weight(jnp.asarray(vhat), code.H))
    return vhat, w


def shard_stream_decode(
    symbols: jax.Array,
    code: LdpcCode,
    mesh: Mesh,
    method: int | str = 0,
    iterations: int = 5,
    offset: int = 0,
    stream_axis: str = "stream",
    decode_fn: Optional[Callable[[jax.Array], jax.Array]] = None,
    return_packed: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Decode a (T,) real symbol stream sharded into time blocks with halo.

    Constraints (static): T divisible by S*N where S = size of the stream
    axis (so every shard owns the same number of whole frame periods), and
    0 <= offset < N is the known frame-grid phase from sync acquisition.

    Returns (vhat (F, N) int8, weights (F,) int32) where F = T // N frames
    are laid out in stream order. With ``return_packed=True`` (requires the
    data-bit count K to be a whole number of bytes) the first output is
    instead the MSB-first packed data bytes (F, K//8) uint8 — the decoder
    block's byte repack (/root/reference/lib/ldpc_decoder_cb_impl.cc:207-225)
    fused on device — and weights are uint8 (every shipped code has M < 256),
    shrinking the device->host fetch ~16x for streaming consumers.

    When offset > 0 the final frame's tail wraps around the ring halo into
    the stream head — its decode is garbage by construction; callers must
    drop frames whose global end offset + (k+1)*N exceeds T (there is
    exactly one such frame iff offset > 0).

    The decoder is the one ``ops.decode.decode_backend`` picks for the
    mesh's platform.
    """
    S = dict(zip(mesh.axis_names, mesh.devices.shape))[stream_axis]
    N = code.N
    T = symbols.shape[0]
    if T % (S * N) != 0:
        raise ValueError(f"stream length {T} must divide into {S} blocks of whole "
                         f"frame periods (multiple of {S * N})")
    if not 0 <= offset < N:
        raise ValueError(f"offset must be in [0, {N}); got {offset}")
    if return_packed and code.K % 8 != 0:
        raise ValueError(
            f"return_packed requires K % 8 == 0; code has K={code.K}")
    if decode_fn is None:
        run = _sharded_stream_runner(code, mesh, method, iterations, offset,
                                     stream_axis, return_packed)
    else:
        run = _build_stream_runner(code, mesh, method, iterations, offset,
                                   stream_axis, decode_fn, return_packed)
    return run(jnp.asarray(symbols, jnp.float32))


@functools.lru_cache(maxsize=None)
def _sharded_stream_runner(code, mesh, method, iterations, offset,
                           stream_axis, return_packed=False):
    """Memoized jitted sharded runner: rebuilding shard_map+jit per call
    would re-trace. The frame-grid offset is static (one compilation per
    lock offset)."""
    return _build_stream_runner(code, mesh, method, iterations, offset,
                                stream_axis, None, return_packed)


def _build_stream_runner(code, mesh, method, iterations, offset, stream_axis,
                         decode_fn, return_packed=False):
    S = dict(zip(mesh.axis_names, mesh.devices.shape))[stream_axis]
    N = code.N
    # route on the mesh's platform: the mesh may hold other devices than
    # the process default
    dec = decode_fn or make_decoder(
        code, method=method, iterations=iterations, jit=False, mesh=mesh)

    def _shard(x: jax.Array) -> tuple[jax.Array, jax.Array]:
        # receive the right neighbor's first N-1 symbols (ring: the last
        # shard receives the stream head, making its straddling frame static
        # -shape; the caller masks that frame when offset > 0)
        Tb = x.shape[0]
        nf = Tb // N
        perm = [(i, (i - 1) % S) for i in range(S)]
        halo = jax.lax.ppermute(x[: N - 1], stream_axis, perm)
        ext = jnp.concatenate([x, halo])                # (Tb + N - 1,)
        frames = jax.lax.dynamic_slice_in_dim(ext, offset, nf * N).reshape(nf, N)
        vhat = dec(frames)
        w = syndrome_weight(vhat, code.H)
        if return_packed:
            from ..ops import pack_bits
            return pack_bits(vhat[:, code.M:]), w.astype(jnp.uint8)
        return vhat, w

    return jax.jit(jax.shard_map(
        _shard,
        mesh=mesh,
        in_specs=P(stream_axis),
        out_specs=(P(stream_axis), P(stream_axis)),
        # the decoders' fori_loop carries start replicated and become varying
        # along the stream axis, which the VMA checker rejects; correctness is
        # covered by the oracle-equality test instead
        check_vma=False,
    ))
