"""LDPC encoder/decoder stream blocks, including the frame-sync state machine.

Behavioral contract (matched to the reference blocks):

- ``LdpcEncoderBlock`` = ldpc_encoder_bc (bytes -> complex BPSK symbols),
  /root/reference/lib/ldpc_encoder_bc_impl.cc:118-178: per frame, K/8 input
  bytes unpack MSB-first to K data bits, M check bits are computed, and the
  frame [c | d] is emitted bit 1 -> +1, 0 -> -1. Rate 1/2: 16 symbols/byte.
  Batched difference: all available frames encode in ONE batched device
  call via the precomputed parity operator.

- ``LdpcDecoderBlock`` = ldpc_decoder_cb (complex -> bytes) with the full
  sync state machine, /root/reference/lib/ldpc_decoder_cb_impl.cc:132-234:
  states OUT_OF_SYNC / IN_SYNC / IN_SYNC_INVERTED; syndrome-weight accept
  threshold M/8; >10 consecutive bad frames in sync -> fall out of sync
  (with an immediate phase-inverted retry of the same frame — including the
  reference's quirk that the retry negates the *current-state* input, and on
  success always enters IN_SYNC_INVERTED); out of sync -> try normal then
  inverted polarity, else slip one symbol. Bad-but-tolerated frames still
  emit their (possibly corrupt) bytes, exactly like the reference.
  Batched difference: the symbol-slip search evaluates a whole window of
  candidate offsets x {+,-} polarities as ONE batched device decode and picks
  the first acceptable (offset, polarity) in the reference's trial order;
  in-sync stretches decode as one batch and are walked on the host.
"""

from __future__ import annotations

import functools
import sys
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..codes import LdpcCode, get_code
from ..ops import make_decoder, syndrome_weight, encode_to_symbols
from .base import Block

__all__ = ["LdpcEncoderBlock", "LdpcDecoderBlock"]

STATE_OUT_OF_SYNC = 0
STATE_IN_SYNC = 1
STATE_IN_SYNC_INVERTED = 2

_METHOD_BANNER = {3: "Hard", 2: "BitFlip", 1: "SumProduct", 0: "LogDomain"}


def _next_bucket(n: int, cap: int = 65536) -> int:
    b = 16
    while b < n and b < cap:
        b *= 2
    return min(b, cap)


class LdpcEncoderBlock(Block):
    in_dtype = np.uint8
    out_dtype = np.complex64
    name = "ldpc_encoder"

    def __init__(self, code: Optional[LdpcCode] = None) -> None:
        super().__init__()
        self.code = code or get_code("block_32_64")
        assert self.code.K % 8 == 0
        self._bytes_per_frame = self.code.K // 8

        @functools.partial(jax.jit, static_argnums=())
        def _enc(data_u8):
            return encode_to_symbols(data_u8, self.code)

        self._enc = _enc

    def work(self, data: np.ndarray):
        bpf = self._bytes_per_frame
        nf = len(data) // bpf
        if nf == 0:
            return 0, None
        frames = np.asarray(data[: nf * bpf], np.uint8).reshape(nf, bpf)
        # pad the batch to a power-of-two bucket (as the decoder block does):
        # streaming chunk sizes vary call-to-call, and every distinct shape
        # would otherwise be a fresh jit compile
        bucket = _next_bucket(nf)
        if bucket != nf:
            frames = np.concatenate(
                [frames, np.zeros((bucket - nf, bpf), np.uint8)])
        sym = np.asarray(self._enc(jnp.asarray(frames)))[:nf]  # (nf, N) f32
        return nf * bpf, sym.reshape(-1).astype(np.complex64)


class LdpcDecoderBlock(Block):
    in_dtype = np.complex64
    out_dtype = np.uint8
    name = "ldpc_decoder"

    def __init__(
        self,
        method: int = 0,
        code: Optional[LdpcCode] = None,
        iterations: int = 5,
        error_threshold: Optional[int] = None,
        max_errors: int = 10,
        search_window: int = 1024,
        verbose: bool = True,
    ) -> None:
        super().__init__()
        self.code = code or get_code("block_32_64")
        self.method = method
        self.iterations = iterations
        self.threshold = (
            self.code.M // 8 if error_threshold is None else error_threshold)
        self.max_errors = max_errors
        self.search_window = search_window
        self.verbose = verbose
        self.state = STATE_OUT_OF_SYNC
        self.errors = 0
        self._decoders: dict[int, callable] = {}
        if verbose:
            print(f"Method: {_METHOD_BANNER.get(method, 'LogDomain')}")

    # -- device helpers ------------------------------------------------------

    def _decode_fn(self, bucket: int):
        fn = self._decoders.get(bucket)
        if fn is None:
            dec = make_decoder(
                self.code, method=self.method, iterations=self.iterations,
                jit=False)

            def _run(rx):
                vhat = dec(rx)
                return vhat, syndrome_weight(vhat, self.code.H)

            fn = jax.jit(_run)
            self._decoders[bucket] = fn
        return fn

    def _decode_batch(self, frames: np.ndarray):
        """Decode (nf, N) float32 frames -> (vhat (nf, N) int8, weights (nf,))."""
        nf = frames.shape[0]
        bucket = _next_bucket(nf)
        padded = np.zeros((bucket, self.code.N), np.float32)
        padded[:nf] = frames
        vhat, w = self._decode_fn(bucket)(jnp.asarray(padded))
        return np.asarray(vhat)[:nf], np.asarray(w)[:nf]

    def _emit(self, vhat: np.ndarray, out: list) -> None:
        data_bits = vhat[self.code.M :].astype(np.uint8)
        out.append(np.packbits(data_bits))  # MSB-first, matches the reference

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg)
            sys.stdout.flush()

    # -- streaming work ------------------------------------------------------

    def work(self, data: np.ndarray):
        N = self.code.N
        reals = np.ascontiguousarray(np.real(np.asarray(data)), dtype=np.float32)
        consumed = 0
        out: list[np.ndarray] = []

        while len(reals) - consumed >= N:
            if self.state == STATE_OUT_OF_SYNC:
                consumed = self._search(reals, consumed, out)
            else:
                consumed = self._synced_run(reals, consumed, out)

        payload = np.concatenate(out) if out else None
        return consumed, payload

    def _search(self, reals: np.ndarray, consumed: int, out: list) -> int:
        """Batched symbol-slip search: all offsets x {+,-} in one decode."""
        N = self.code.N
        avail = len(reals) - consumed
        n_off = min(avail - N + 1, self.search_window)
        frames = np.lib.stride_tricks.sliding_window_view(
            reals[consumed : consumed + n_off + N - 1], N)[:n_off]
        batch = np.concatenate([frames, -frames], axis=0).astype(np.float32)
        vhats, weights = self._decode_batch(batch)
        ok = weights <= self.threshold
        gp, gm = ok[:n_off], ok[n_off:]
        good = gp | gm
        idx = np.nonzero(good)[0]
        if idx.size == 0:
            return consumed + n_off  # slipped past the whole window
        o = int(idx[0])
        consumed += o
        if gp[o]:
            self.state = STATE_IN_SYNC
            self._log("IN SYNC")
            self._emit(vhats[o], out)
        else:
            # normal polarity failed at this offset, inverted succeeded —
            # the reference's retry path (lib/ldpc_decoder_cb_impl.cc:178-192)
            self.state = STATE_IN_SYNC_INVERTED
            self._log("IN SYNC; PHASE INVERTED")
            self._emit(vhats[n_off + o], out)
        self.errors = 0
        return consumed + N

    def _synced_run(self, reals: np.ndarray, consumed: int, out: list) -> int:
        """Decode every complete frame in one batch, then walk the sync logic."""
        N = self.code.N
        mult = -1.0 if self.state == STATE_IN_SYNC_INVERTED else 1.0
        nf = (len(reals) - consumed) // N
        frames = reals[consumed : consumed + nf * N].reshape(nf, N) * mult
        vhats, weights = self._decode_batch(frames)

        for i in range(nf):
            if weights[i] > self.threshold:
                self.errors += 1
                if self.errors > self.max_errors:
                    self.errors = 0
                    prev_mult = mult
                    self.state = STATE_OUT_OF_SYNC
                    self._log("MAX ERRORS; OUT OF SYNC")
                    # reference quirk: retry negates the *current-state* tx
                    # (which already included the inversion multiplier), and
                    # success always enters IN_SYNC_INVERTED (:190-191)
                    vh2, w2 = self._decode_batch(-frames[i : i + 1])
                    if w2[0] <= self.threshold:
                        self.state = STATE_IN_SYNC_INVERTED
                        self.errors = 0
                        self._log("IN SYNC; PHASE INVERTED")
                        self._emit(vh2[0], out)
                        consumed += N
                        if prev_mult == -1.0:
                            # multiplier unchanged (-tx of inverted == ... the
                            # new state is inverted too); keep walking batch
                            continue
                        return consumed  # polarity changed: re-decode rest
                    # retry failed: slip one symbol, outer loop re-searches
                    return consumed + 1
                # tolerated bad frame: bytes still emitted (reference :207)
                self._emit(vhats[i], out)
                consumed += N
            else:
                self._emit(vhats[i], out)
                consumed += N
        return consumed
