"""Batched device ops: encode, channel, decode (XLA decoders + Triton kernel)."""

from .bits import pack_bits, pack_bits_np, unpack_bits, unpack_bits_np
from .channel import awgn, channel_model, ebn0_to_n0
from .decode import (
    METHODS,
    decode_bitflip,
    decode_backend,
    decode_bitflip_mp,
    decode_hard,
    decode_minsum,
    decode_sumproduct,
    make_decoder,
    syndrome_ok,
    syndrome_weight,
)
from .encode import bpsk_map, encode_bits, encode_bytes, encode_to_symbols

__all__ = [
    "METHODS",
    "awgn",
    "bpsk_map",
    "channel_model",
    "decode_bitflip",
    "decode_backend",
    "decode_bitflip_mp",
    "decode_hard",
    "decode_minsum",
    "decode_sumproduct",
    "ebn0_to_n0",
    "encode_bits",
    "encode_bytes",
    "encode_to_symbols",
    "make_decoder",
    "pack_bits",
    "pack_bits_np",
    "syndrome_ok",
    "syndrome_weight",
    "unpack_bits",
    "unpack_bits_np",
]
