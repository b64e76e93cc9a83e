"""Channel-model stream block (GRC channels_channel_model equivalent).

examples/example4/5/6.grc route the encoder output through a channel model
with a noise-voltage slider (default 10^(-12/10)), zero frequency offset and
unit taps. This block applies complex AWGN + phase/frequency rotation to the
symbol stream, batched on device.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .base import Block

__all__ = ["ChannelModelBlock", "AwgnBlock"]


class ChannelModelBlock(Block):
    in_dtype = np.complex64
    out_dtype = np.complex64
    name = "channel_model"

    def __init__(self, noise_voltage: float = 0.0, freq_offset: float = 0.0,
                 phase_offset: float = 0.0, epsilon: float = 1.0,
                 seed: int = 0) -> None:
        super().__init__()
        self.noise_voltage = float(noise_voltage)
        self.freq_offset = float(freq_offset)
        self.phase_offset = float(phase_offset)
        # epsilon = receiver/transmitter sample-clock ratio, the GR
        # channel_model parameter (example4.grc sets 1.0; real radio links
        # like transmitter/receiver.grc drift tens of ppm) — implemented as
        # streaming polyphase fractional resampling (ops.dsp)
        self.epsilon = float(epsilon)
        self._key = jax.random.PRNGKey(seed)
        self._t = 0  # running sample index for the frequency rotation
        self._rbuf = np.zeros(0, np.complex64)  # resampler input carry
        self._rpos = 0.0                        # fractional read position

    def _resample(self, x: np.ndarray) -> np.ndarray:
        """Streaming clock-drift resampler: consume x at rate ``epsilon``."""
        from ..ops import dsp as _dsp

        v = np.concatenate([self._rbuf, x])
        y = np.asarray(_dsp.fractional_resample(
            jnp.asarray(v), self.epsilon, t0=self._rpos))
        if len(y) == 0:
            self._rbuf = v
            return y
        end = self._rpos + len(y) * self.epsilon
        keep = int(np.floor(end))
        self._rpos = end - keep
        self._rbuf = v[keep:]
        return y

    def work(self, data):
        n = len(data)
        if n == 0:
            return 0, None
        if self.epsilon != 1.0:
            data = self._resample(np.asarray(data, np.complex64))
            if len(data) == 0:
                return n, None
        m = len(data)  # may differ from n when epsilon-resampling
        self._key, sub = jax.random.split(self._key)
        # per-chunk host-side compute (see blocks/dsp.py::_cpu rationale:
        # streaming chunks are latency-bound)
        with jax.default_device(jax.devices("cpu")[0]):
            x = jnp.asarray(np.asarray(data, np.complex64))
            kr, ki = jax.random.split(sub)
            noise = (jax.random.normal(kr, (m,), jnp.float32)
                     + 1j * jax.random.normal(ki, (m,), jnp.float32))
            noise = noise * (self.noise_voltage / np.sqrt(2.0))
            t = (self._t + jnp.arange(m, dtype=jnp.float32))
            rot = jnp.exp(
                1j * (2 * np.pi * self.freq_offset * t + self.phase_offset))
            out = x * rot.astype(jnp.complex64) + noise.astype(jnp.complex64)
        self._t += m
        return n, np.asarray(out)


class AwgnBlock(Block):
    """Real-equivalent AWGN at a given Eb/N0 (simulator convention,
    apps/ldpc_lapack.cpp:635-642): rx = tx + sqrt(10^(-EbN0/10)) * n."""

    in_dtype = np.complex64
    out_dtype = np.complex64
    name = "awgn"

    def __init__(self, ebn0_db: float, seed: int = 0) -> None:
        super().__init__()
        self.sigma = float(10.0 ** (-ebn0_db / 20.0))  # sqrt(N0)
        self._rng = np.random.default_rng(seed)

    def work(self, data):
        n = len(data)
        noise = self._rng.standard_normal(n).astype(np.float32)
        return n, (np.asarray(data, np.complex64)
                   + noise.astype(np.complex64) * self.sigma)
