"""Receiver-chain DSP stream blocks (the GR stock-block roles in
example4/5/6.grc: pfb_arb_resampler+RRC, agc2, costas_loop, pfb_clock_sync).

Filters run overlap-save (an L-1 input tail carries across work() chunks, so
chunked output equals one-shot causal filtering); the feedback loops (AGC,
Costas) carry their loop state (gain / phase+freq) across chunks, so the
streaming result is sample-for-sample identical to processing the whole
stream in one call.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import dsp
from .base import Block


def _cpu():
    """Pin a streaming chunk's compute to the host CPU device.

    These blocks process modest sequential chunks with loop state carried in
    Python; dispatching each chunk to an accelerator adds a round trip per
    chunk. The batched device DSP for mesh receivers is ops/dsp.py.
    """
    return jax.default_device(jax.devices("cpu")[0])

__all__ = ["BpskModBlock", "PulseShapeBlock", "AgcBlock2", "CostasLoopBlock",
           "SymbolSyncBlock", "FreqRecoveryBlock", "PfbClockSyncBlock"]


class BpskModBlock(Block):
    """Uncoded BPSK mapper: bytes -> 8 complex +-1 symbols, MSB first.

    The digital_psk_mod role in the reference's LDPC-free sync prototypes
    (/root/reference/examples/example2.grc, example3.grc); bit 1 -> +1
    matches the encoder's convention (lib/ldpc_encoder_bc_impl.cc:154-165).
    Chain with ``pulse_shape`` for the mod block's RRC/sps stage.
    """

    in_dtype = np.uint8
    out_dtype = np.complex64
    name = "bpsk_mod"

    def work(self, data):
        n = len(data)
        if n == 0:
            return 0, None
        bits = np.unpackbits(np.asarray(data, np.uint8))
        return n, (2.0 * bits - 1.0).astype(np.complex64)


class _OverlapSaveFir:
    """Causal chunked FIR: emit convolve(concat(tail, x), taps, 'valid')."""

    def __init__(self, taps: np.ndarray) -> None:
        self.taps = np.asarray(taps, np.float32)
        self._tail = np.zeros(len(self.taps) - 1, np.complex64)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        v = np.concatenate([self._tail, x.astype(np.complex64)])
        L = len(self.taps)
        if len(v) < L:
            self._tail = v
            return np.zeros(0, np.complex64)
        with _cpu():
            y = np.asarray(jnp.convolve(jnp.asarray(v), jnp.asarray(self.taps),
                                        mode="valid")).astype(np.complex64)
        self._tail = v[len(v) - (L - 1):]
        return y


class PulseShapeBlock(Block):
    """Zero-stuff to sps samples/symbol and RRC-shape (transmit side)."""

    in_dtype = np.complex64
    out_dtype = np.complex64
    name = "pulse_shape"

    def __init__(self, sps: int = 2, excess_bw: float = 0.35,
                 ntaps: int = 45) -> None:
        super().__init__()
        self.sps = int(sps)
        self._fir = _OverlapSaveFir(dsp.rrc_taps(self.sps, excess_bw, ntaps))

    def work(self, data):
        n = len(data)
        if n == 0:
            return 0, None
        up = np.zeros(n * self.sps, np.complex64)
        up[:: self.sps] = np.asarray(data, np.complex64) * self.sps
        return n, self._fir(up)


class AgcBlock2(Block):
    """agc2-equivalent automatic gain control (gain carried across chunks)."""

    in_dtype = np.complex64
    out_dtype = np.complex64
    name = "agc"

    def __init__(self, rate: float = 1e-2, reference: float = 1.0) -> None:
        super().__init__()
        self.rate = float(rate)
        self.reference = float(reference)
        self.gain = 1.0

    def work(self, data):
        n = len(data)
        if n == 0:
            return 0, None
        with _cpu():
            y, g = dsp.agc(jnp.asarray(np.asarray(data, np.complex64)),
                           rate=self.rate, reference=self.reference,
                           gain0=self.gain)
        self.gain = float(g)
        return n, np.asarray(y)


class CostasLoopBlock(Block):
    """2nd-order BPSK Costas loop (phase/freq carried across chunks)."""

    in_dtype = np.complex64
    out_dtype = np.complex64
    name = "costas_loop"

    def __init__(self, loop_bw: float = 6.28 / 100.0) -> None:
        super().__init__()
        self.loop_bw = float(loop_bw)
        self.phase = 0.0
        self.freq = 0.0

    def work(self, data):
        n = len(data)
        if n == 0:
            return 0, None
        with _cpu():
            y, (p, f) = dsp.costas_loop(
                jnp.asarray(np.asarray(data, np.complex64)),
                loop_bw=self.loop_bw, phase0=self.phase, freq0=self.freq)
        self.phase, self.freq = float(p), float(f)
        return n, np.asarray(y)


class SymbolSyncBlock(Block):
    """Matched filter + integer-phase downsampling (timing recovery for
    channels without fractional timing drift). The polyphase branch is chosen
    once from the first ``lock_samples`` filtered samples and then held."""

    in_dtype = np.complex64
    out_dtype = np.complex64
    name = "symbol_sync"

    def __init__(self, sps: int = 2, excess_bw: float = 0.35,
                 ntaps: int = 45, lock_samples: int = 2048) -> None:
        super().__init__()
        self.sps = int(sps)
        self._fir = _OverlapSaveFir(dsp.rrc_taps(self.sps, excess_bw, ntaps))
        self._lock_samples = lock_samples
        self._lockbuf = np.zeros(0, np.complex64)
        self.phase: Optional[int] = None
        self._rem = np.zeros(0, np.complex64)  # sps-alignment remainder

    def _pick_phase(self, mf: np.ndarray) -> int:
        n = (len(mf) // self.sps) * self.sps
        br = mf[:n].reshape(-1, self.sps)
        return int(np.argmax(np.mean(np.abs(br) ** 2, axis=0)))

    def work(self, data):
        n = len(data)
        if n == 0:
            return 0, None
        mf = self._fir(np.asarray(data, np.complex64))
        if self.phase is None:
            self._lockbuf = np.concatenate([self._lockbuf, mf])
            if len(self._lockbuf) < self._lock_samples:
                return n, None  # still acquiring timing
            self.phase = self._pick_phase(self._lockbuf)
            mf, self._lockbuf = self._lockbuf, np.zeros(0, np.complex64)
        v = np.concatenate([self._rem, mf])
        take = (len(v) // self.sps) * self.sps
        self._rem = v[take:]
        if take == 0:
            return n, None
        return n, v[:take].reshape(-1, self.sps)[:, self.phase].copy()


class FreqRecoveryBlock(Block):
    """Coarse carrier-frequency acquisition (the fll_band_edge role in
    example4/5/6.grc — see ops.dsp.coarse_cfo_estimate for the batched
    feedforward design).

    Buffers ``lock_samples`` samples, estimates the CFO once from the
    squared-signal spectrum, then derotates the stream with a continuous
    phase (sample counter carried across chunks). The residual offset
    (<1e-4 cycles/sample) is well inside the downstream Costas loop's
    pull-in range.
    """

    in_dtype = np.complex64
    out_dtype = np.complex64
    name = "fll_band_edge"

    def __init__(self, lock_samples: int = 16384, max_freq: float = 0.2
                 ) -> None:
        super().__init__()
        self.lock_samples = int(lock_samples)
        self.max_freq = float(max_freq)
        self.freq: Optional[float] = None
        self._lockbuf = np.zeros(0, np.complex64)
        self._t = 0  # running sample index for continuous-phase derotation

    def work(self, data):
        n = len(data)
        if n == 0:
            return 0, None
        x = np.asarray(data, np.complex64)
        if self.freq is None:
            self._lockbuf = np.concatenate([self._lockbuf, x])
            if len(self._lockbuf) < self.lock_samples:
                return n, None  # still acquiring
            with _cpu():
                self.freq = float(dsp.coarse_cfo_estimate(
                    jnp.asarray(self._lockbuf), max_freq=self.max_freq))
            x, self._lockbuf = self._lockbuf, np.zeros(0, np.complex64)
        k = self._t + np.arange(len(x))
        self._t += len(x)
        rot = np.exp(-2j * np.pi * self.freq * k).astype(np.complex64)
        return n, x * rot


class PfbClockSyncBlock(Block):
    """Polyphase clock recovery with fractional-delay/clock-drift tracking
    (the pfb_clock_sync role in example4.grc; ops.dsp.pfb_clock_sync).

    Streams through an internal buffer in fixed ``segment`` sample slices
    (bounding the jit cache); acquisition (batched power search) runs on the
    first full segment, then the (ibase, frac, rate) loop state carries
    across segments.
    """

    in_dtype = np.complex64
    out_dtype = np.complex64
    name = "pfb_clock_sync"

    def __init__(self, sps: int = 2, nfilts: int = 32,
                 excess_bw: float = 0.35, loop_bw: float = 0.06,
                 segment: int = 16384) -> None:
        super().__init__()
        self.sps = int(sps)
        self.nfilts = int(nfilts)
        self.excess_bw = float(excess_bw)
        self.loop_bw = float(loop_bw)
        self.segment = int(segment)
        self._buf = np.zeros(0, np.complex64)
        self._state = None  # (ibase, frac, rate) after acquisition

    def work(self, data):
        n = len(data)
        if n == 0:
            return 0, None
        self._buf = np.concatenate([self._buf,
                                    np.asarray(data, np.complex64)])
        outs = []
        while len(self._buf) >= self.segment:
            seg = self._buf[:self.segment]
            with _cpu():
                y, (ib, fr, ra) = dsp.pfb_clock_sync(
                    jnp.asarray(seg), sps=self.sps, nfilts=self.nfilts,
                    excess_bw=self.excess_bw, loop_bw=self.loop_bw,
                    state0=self._state)
            consumed = int(ib)
            if consumed <= 0:  # pathological; drop the segment to progress
                consumed = self.segment
            self._buf = self._buf[consumed:]
            self._state = (0, float(fr), float(ra))
            outs.append(np.asarray(y))
        if not outs:
            return n, None
        return n, np.concatenate(outs)
