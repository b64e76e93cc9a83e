"""Mesh-sharded Monte-Carlo BER/FER sweep step.

The device-parallel scale-up of the reference's simulator loop
(/root/reference/apps/ldpc_lapack.cpp:581-714): per step, every device in the
mesh's "batch" axis draws its own random data frames, encodes, passes them
through AWGN, decodes, and counts errors; the per-device counters are
psum-aggregated across the mesh so the host sees one global statistic vector
per step regardless of mesh size. Keys are fold_in'd with the device's axis
index so shards draw independent streams from one host-provided key.

Error accounting matches the reference:
  - bit errors count over ALL N codeword bits (biterr, ldpc_lapack.cpp:508-517)
  - true frame error = any bit mismatch vs the transmitted codeword
  - detected frame error = nonzero syndrome after decode, the statistic the
    reference uses for its FER curves (ldpc_lapack.cpp:669-707); comparing the
    two exposes the same false-positive/negative accounting the reference
    prints.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..codes import LdpcCode
from ..ops import awgn, bpsk_map, encode_bits, make_decoder, syndrome_weight

__all__ = ["SweepStats", "make_sweep_step"]


class SweepStats(NamedTuple):
    """Globally aggregated counters for one sweep step (all int64-safe f64/i32)."""

    bit_errors: jax.Array        # total wrong bits over all N codeword bits
    info_bit_errors: jax.Array   # wrong bits over the K data positions only
    frame_errors: jax.Array      # frames with any bit error (true FER)
    detected_errors: jax.Array   # frames with nonzero post-decode syndrome
    n_frames: jax.Array
    n_bits: jax.Array


def make_sweep_step(
    code: LdpcCode,
    mesh: Mesh,
    method: int | str = 1,
    iterations: int = 5,
    frames_per_device: int = 1024,
    early_exit: bool = True,
    batch_axis: str = "batch",
    decode_fn: Callable[[jax.Array], jax.Array] | None = None,
) -> Callable[[jax.Array, jax.Array], SweepStats]:
    """Build the jitted sharded step: (key, ebn0_db) -> SweepStats.

    ``key`` and ``ebn0_db`` are replicated inputs; all heavy arrays live and
    die on-device inside the step (nothing but six scalars returns to host).
    ``decode_fn`` overrides the decoder; otherwise the mesh's platform picks
    it (``ops.decode.decode_backend``). ``step.shard_stats(key, ebn0_db,
    idx)`` runs shard ``idx``'s computation alone, unsharded, so the psum
    can be checked against serial runs of the same keys.
    """
    dec = decode_fn or make_decoder(
        code, method=method, iterations=iterations, early_exit=early_exit,
        jit=False, mesh=mesh)
    K, M, N = code.K, code.M, code.N

    def shard_stats(key: jax.Array, ebn0_db: jax.Array,
                    idx: jax.Array) -> SweepStats:
        """One shard's counters, for frames drawn from fold_in(key, idx)."""
        kd, kn = jax.random.split(jax.random.fold_in(key, idx))
        d = jax.random.bernoulli(kd, 0.5, (frames_per_device, K)).astype(jnp.int8)
        u = encode_bits(d, code)                       # (B, N) [check | data]
        rx = awgn(kn, bpsk_map(u), ebn0_db)
        vhat = dec(rx)
        wrong = (vhat != u).astype(jnp.int32)          # (B, N)
        bit_e = jnp.sum(wrong)
        info_e = jnp.sum(wrong[:, M:])
        frame_e = jnp.sum(jnp.any(wrong > 0, axis=-1))
        det_e = jnp.sum(syndrome_weight(vhat, code.H) > 0)
        return SweepStats(
            bit_errors=bit_e.astype(jnp.float32),
            info_bit_errors=info_e.astype(jnp.float32),
            frame_errors=frame_e.astype(jnp.float32),
            detected_errors=det_e.astype(jnp.float32),
            n_frames=jnp.float32(frames_per_device),
            n_bits=jnp.float32(frames_per_device * N),
        )

    def _shard_step(key: jax.Array, ebn0_db: jax.Array) -> SweepStats:
        local = shard_stats(key, ebn0_db, jax.lax.axis_index(batch_axis))
        return jax.tree.map(
            lambda x: jax.lax.psum(x, batch_axis), local)

    sharded = jax.shard_map(
        _shard_step,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    jitted = jax.jit(sharded)

    def step(key: jax.Array, ebn0_db) -> SweepStats:
        return jitted(key, jnp.asarray(ebn0_db, jnp.float32))

    serial = jax.jit(shard_stats)

    def one_shard(key: jax.Array, ebn0_db, idx: int) -> SweepStats:
        return serial(key, jnp.asarray(ebn0_db, jnp.float32), jnp.int32(idx))

    # the same per-shard program run alone on the default device: the
    # step's result is the sum of one_shard over idx in range(mesh size)
    step.shard_stats = one_shard
    return step
