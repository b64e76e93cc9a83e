"""Batched LDPC encoding + BPSK mapping.

The reference encodes one frame at a time with two dense double-precision
LAPACK solves (/root/reference/lib/ldpc_encoder_bc_impl.cc:180-223,275-294).
Here the GF(2) triangular solves are composed offline into the parity operator
P (codes/ldpc.py), so a whole batch encodes as one small matmul:

    c = (d @ P^T) mod 2         # (B, K) @ (K, M)
    u = [c | d]                 # codeword order: check bits then data bits
    s = 2u - 1                  # BPSK: bit 1 -> +1, bit 0 -> -1
                                # (encoder convention at lib/ldpc_encoder_bc_impl.cc:155)

Counts fit exactly in float32 (<= K < 2^24), so the f32 matmul is exact GF(2)
arithmetic after mod 2.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..codes import LdpcCode
from .bits import unpack_bits

__all__ = ["encode_bits", "encode_bytes", "bpsk_map", "encode_to_symbols"]


def encode_bits(data_bits: jax.Array, code: LdpcCode) -> jax.Array:
    """(B, K) 0/1 -> codeword bits (B, N) = [check | data]."""
    Pt = jnp.asarray(code.P.T.astype(np.float32))  # (K, M)
    z = jnp.dot(data_bits.astype(jnp.float32), Pt, preferred_element_type=jnp.float32)
    c = jnp.mod(z.astype(jnp.int32), 2).astype(jnp.int8)
    return jnp.concatenate([c, data_bits.astype(jnp.int8)], axis=-1)


def encode_bytes(data: jax.Array, code: LdpcCode) -> jax.Array:
    """uint8 (B, K//8) -> codeword bits (B, N); bytes unpacked MSB-first."""
    assert code.K % 8 == 0, f"code K={code.K} is not byte-aligned"
    return encode_bits(unpack_bits(data), code)


def bpsk_map(bits: jax.Array, dtype=jnp.float32) -> jax.Array:
    """bit 1 -> +1.0, bit 0 -> -1.0."""
    return (2 * bits.astype(dtype) - 1).astype(dtype)


@functools.partial(jax.jit, static_argnums=(1,))
def encode_to_symbols(data: jax.Array, code: LdpcCode) -> jax.Array:
    """Bytes (B, K//8) -> BPSK symbols (B, N) float32, the full encoder block."""
    return bpsk_map(encode_bytes(data, code))
