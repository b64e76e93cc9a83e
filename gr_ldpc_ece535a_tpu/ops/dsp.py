"""DSP ops for the full receiver chain: pulse shaping, AGC, carrier/timing
recovery, fractional resampling.

The reference's example4/5/6.grc route the BPSK symbols through GNU Radio
stock DSP at 2 samples/symbol — pfb_arb_resampler with RRC taps, channel
model, agc2, fll_band_edge, pfb_clock_sync, costas_loop (SURVEY.md §3.4) —
none of which live in the reference module itself (they are L0 externals).
This module provides device-resident equivalents for the whole chain, in
two styles per stage:

  * faithful sequential loops (``agc``, ``costas_loop``): ``lax.scan``
    recurrences with the GR control-loop parameterization, state carried
    across stream chunks by the blocks layer;
  * feedforward/batched redesigns for the device-resident fast path
    (``block_agc``, ``coarse_cfo_estimate`` = the fll_band_edge role as a
    squaring-FFT estimator, ``vv_carrier_recovery`` = the costas role as
    block Viterbi&Viterbi, ``pfb_clock_sync`` = per-block polyphase clock
    tracking with batched power-search acquisition) — composed by
    ``rx_chain``.

Matmul precision: a float32 matmul may run in TF32 on the GPU, which keeps
10 mantissa bits. Every matmul on the chain path (the one-hot tap selects,
the DFT bank, the windows matmul) asks for ``Precision.HIGHEST``, so the
chain computes the same float32 values as on the CPU up to summation order;
each call site states its tolerance.

``fractional_resample`` is the channel-side clock-drift impairment (the GR
channel_model ``epsilon``); ``symbol_sync`` remains the cheap integer-phase
timing recovery for drift-free synthetic channels. Every carrier-recovery
stage leaves the BPSK pi ambiguity to the decoder's IN_SYNC_INVERTED state,
exactly as the reference chain does.
"""

from __future__ import annotations

import functools
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "rrc_taps",
    "fir_filter",
    "pulse_shape",
    "agc",
    "block_agc",
    "costas_loop",
    "symbol_sync",
    "polyphase_rrc_banks",
    "fractional_resample",
    "coarse_cfo_estimate",
    "mix",
    "pfb_clock_sync",
    "vv_carrier_recovery",
    "rx_chain",
    # pair-form (complex-free) chain: (2, T) f32 planes
    "to_pairs",
    "from_pairs",
    "mix_pairs",
    "block_agc_pairs",
    "coarse_cfo_estimate_pairs",
    "vv_carrier_recovery_pairs",
    "pfb_clock_sync_pairs",
    "pfb_clock_sync_ff_pairs",
    "rx_chain_pairs",
]


def rrc_taps(sps: int, excess_bw: float = 0.35, ntaps: int = 45,
             gain: float = 1.0) -> np.ndarray:
    """Root-raised-cosine FIR taps (firdes.root_raised_cosine equivalent).

    sps = samples/symbol; taps normalized to unit energy then scaled by gain.
    """
    beta = float(excess_bw)
    n = int(ntaps)
    t = (np.arange(n) - (n - 1) / 2) / sps  # time in symbol periods
    h = np.zeros(n)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            h[i] = 1.0 - beta + 4 * beta / math.pi
        elif beta > 0 and abs(abs(ti) - 1 / (4 * beta)) < 1e-9:
            h[i] = (beta / math.sqrt(2)) * (
                (1 + 2 / math.pi) * math.sin(math.pi / (4 * beta))
                + (1 - 2 / math.pi) * math.cos(math.pi / (4 * beta)))
        else:
            num = (math.sin(math.pi * ti * (1 - beta))
                   + 4 * beta * ti * math.cos(math.pi * ti * (1 + beta)))
            den = math.pi * ti * (1 - (4 * beta * ti) ** 2)
            h[i] = num / den
    h = h / np.sqrt(np.sum(h * h))
    return (gain * h).astype(np.float32)


def fir_filter(x: jax.Array, taps: np.ndarray, decim: int = 1) -> jax.Array:
    """'same'-aligned FIR filter of a 1D (complex or real) stream; optional
    decimation keeps every decim-th output."""
    t = jnp.asarray(taps, jnp.float32)
    if jnp.iscomplexobj(x):
        y = (jnp.convolve(jnp.real(x), t, mode="same")
             + 1j * jnp.convolve(jnp.imag(x), t, mode="same"))
        y = y.astype(jnp.complex64)
    else:
        y = jnp.convolve(x, t, mode="same")
    return y[::decim] if decim > 1 else y


def pulse_shape(symbols: jax.Array, sps: int, taps: np.ndarray) -> jax.Array:
    """Transmit pulse shaping: zero-stuff to sps samples/symbol + RRC filter
    (the pfb_arb_resampler-with-RRC-taps role of example4.grc at rate=sps)."""
    n = symbols.shape[0]
    up = jnp.zeros(n * sps, symbols.dtype).at[::sps].set(symbols * sps)
    return fir_filter(up, taps)


@partial(jax.jit, static_argnames=("rate", "reference"))
def agc(x: jax.Array, rate: float = 1e-2, reference: float = 1.0,
        gain0: float = 1.0):
    """agc_cc-style automatic gain control: out = x*g; g += rate*(ref-|out|).

    Returns (out, final_gain) so streaming blocks can carry gain across
    chunks.
    """
    def step(g, xi):
        yi = xi * g
        g = g + rate * (reference - jnp.abs(yi))
        return g, yi

    gF, y = jax.lax.scan(step, jnp.float32(gain0), x)
    return y, gF


@partial(jax.jit, static_argnames=("loop_bw",))
def costas_loop(x: jax.Array, loop_bw: float = 6.28 / 100.0,
                phase0: float = 0.0, freq0: float = 0.0):
    """2nd-order BPSK Costas loop (GR costas_loop_cc order=2 equivalent).

    error = Re(y)*Im(y); critically damped gains from loop_bw. Returns
    (y, (final_phase, final_freq)); converges to the carrier up to a 180-deg
    ambiguity the LDPC decoder's inverted-sync state resolves.
    """
    damping = math.sqrt(2.0) / 2.0
    denom = 1.0 + 2.0 * damping * loop_bw + loop_bw * loop_bw
    alpha = jnp.float32(4 * damping * loop_bw / denom)
    beta = jnp.float32(4 * loop_bw * loop_bw / denom)
    two_pi = jnp.float32(2 * math.pi)
    fmax = jnp.float32(1.0)

    def step(carry, xi):
        phase, freq = carry
        yi = xi * jnp.exp(-1j * phase).astype(jnp.complex64)
        err = jnp.clip(jnp.real(yi) * jnp.imag(yi), -1.0, 1.0)
        freq = jnp.clip(freq + beta * err, -fmax, fmax)
        phase = phase + freq + alpha * err
        phase = jnp.mod(phase + jnp.pi, two_pi) - jnp.pi
        return (phase, freq), yi

    (phaseF, freqF), y = jax.lax.scan(
        step, (jnp.float32(phase0), jnp.float32(freq0)), x)
    return y, (phaseF, freqF)


def symbol_sync(x: jax.Array, sps: int, taps: np.ndarray):
    """Matched filter + integer-phase timing: downsample at the polyphase
    branch with maximum mean energy — the cheap timing recovery for
    channels WITHOUT fractional timing drift (channel epsilon == 1.0). Any
    sample-clock drift needs ``pfb_clock_sync``, which tracks fractional
    delay. Returns (symbols, chosen_phase)."""
    mf = fir_filter(x, taps)
    n = (mf.shape[0] // sps) * sps
    branches = mf[:n].reshape(-1, sps)          # (n_sym, sps)
    energy = jnp.mean(jnp.abs(branches) ** 2, axis=0)
    phase = jnp.argmax(energy)
    return jnp.take(branches, phase, axis=1), phase


# ---------------------------------------------------------------------------
# polyphase machinery: fractional resampling + clock recovery + coarse CFO
# ---------------------------------------------------------------------------

def polyphase_rrc_banks(sps: int, nfilts: int = 32, excess_bw: float = 0.35,
                        ntaps_per: int = 11):
    """(bank, dbank): polyphase RRC matched-filter bank and its derivative.

    ``bank[k]`` correlates against the matched filter sampled at a delay of
    +k/nfilts INPUT samples (larger k = later sampling instant — this
    direction is load-bearing for the clock-recovery wrap bookkeeping and is
    pinned by tests/test_dsp.py; the naive ``proto[k::nfilts]`` slicing
    yields the OPPOSITE direction, which makes a tracking loop slip one
    symbol at every phase wrap). The dbank rows are d/dt of the matched
    filter at the same delays, scaled to per-input-sample units.

    The GR pfb_clock_sync role (examples/example4.grc: nfilts=32 RRC bank +
    derivative bank; /root/reference has no local implementation — it is an
    L0 external per SURVEY.md section 3.4).
    """
    Lp = ntaps_per * sps * nfilts
    proto = rrc_taps(sps * nfilts, excess_bw, Lp, gain=float(nfilts))
    dproto = (np.gradient(proto) * nfilts).astype(np.float32)
    L = ntaps_per * sps + 1
    z = np.zeros(nfilts, np.float32)
    p2 = np.concatenate([z, proto, z])
    d2 = np.concatenate([z, dproto, z])
    bank = np.stack([p2[nfilts - k::nfilts][:L] for k in range(nfilts)])
    dbank = np.stack([d2[nfilts - k::nfilts][:L] for k in range(nfilts)])
    return bank.astype(np.float32), dbank.astype(np.float32)


def _interp_bank(nfilts: int, ntaps_per: int) -> np.ndarray:
    """Polyphase sinc interpolation bank, row k = fractional delay
    +k/nfilts (same verified direction as polyphase_rrc_banks). Rows are
    normalized to unit DC gain; the group delay is (L-1)//2 input samples."""
    Lp = nfilts * ntaps_per
    n = np.arange(Lp) - (Lp - 1) / 2
    proto = (np.sinc(n / nfilts) * np.hanning(Lp)).astype(np.float64)
    z = np.zeros(nfilts)
    p2 = np.concatenate([z, proto, z])
    L = ntaps_per + 1
    bank = np.stack([p2[nfilts - k::nfilts][:L] for k in range(nfilts)])
    bank /= bank.sum(axis=1, keepdims=True)
    return bank.astype(np.float32)


def fractional_resample(x: jax.Array, ratio: float, nfilts: int = 128,
                        ntaps_per: int = 8, t0: float = 0.0) -> jax.Array:
    """Arbitrary-rate polyphase resampler: y[k] ~= x(t0 + k*ratio + c) with
    c = the bank's (ntaps_per//2)-sample group delay.

    This is the channels_channel_model ``epsilon`` role (the reference's
    example4.grc sets epsilon=1.0 = no drift; transmitter/receiver.grc run
    over real radios whose clocks DO drift) — the impairment
    ``pfb_clock_sync`` exists to undo. ratio is the receiver-clock/
    transmitter-clock ratio (1 + 50e-6 = receiver sampling 50 ppm slow).
    The output frequency scaling and delay convention are pinned by
    tests/test_dsp.py. Output length is static given (len(x), ratio, t0).
    """
    x = jnp.asarray(x)
    bank = jnp.asarray(_interp_bank(nfilts, ntaps_per))
    L = ntaps_per + 1
    n_out = int((x.shape[0] - L - 2 - t0) / ratio)
    t = t0 + np.arange(n_out) * ratio
    i = np.floor(t).astype(np.int64)
    mu = t - i
    pidx = np.round(mu * nfilts).astype(np.int64)
    i += pidx // nfilts
    pidx %= nfilts
    win = jnp.take(x, jnp.asarray(i[:, None] + np.arange(L)[None, :]), axis=0)
    return jnp.sum(win * bank[jnp.asarray(pidx)], axis=1).astype(x.dtype)


def mix(x: jax.Array, freq: float | jax.Array, phase0: float = 0.0,
        t0: float | jax.Array = 0.0) -> jax.Array:
    """Rotate by exp(-j*(2*pi*freq*(t0 + n) + phase0)): remove a carrier
    offset of ``freq`` cycles/sample (pass -freq to inject one)."""
    n = t0 + jnp.arange(x.shape[0], dtype=jnp.float32)
    ph = 2 * jnp.pi * freq * n + phase0
    return (x * jnp.exp(-1j * ph)).astype(jnp.complex64)


def coarse_cfo_estimate(x: jax.Array, nfft: int = 1 << 16,
                        max_freq: float = 0.2) -> jax.Array:
    """Coarse carrier-frequency estimate for BPSK, cycles/sample.

    The fll_band_edge role of example4/5/6.grc (SURVEY.md section 3.4):
    coarse carrier acquisition ahead of clock sync, pulling offsets far
    beyond the Costas loop's lock-in range. Batched design: feedforward
    instead of a per-sample feedback loop — squaring removes the BPSK
    modulation (x^2 has a spectral line at 2*f_cfo), one windowed FFT
    locates the line, and a 3-point parabolic interpolation refines it to a
    fraction of a bin. Fully batched FFT work, no sequential state.

    max_freq bounds the search to |f| <= max_freq cycles/sample, keeping
    the estimate unambiguous against the squared signal's symbol-rate
    sidelines at 2f +- 1/T (T = symbol period; keep
    max_freq < 1/(2T) - guard).
    """
    n = min(nfft, int(x.shape[0]))
    v = x[:n] * x[:n]
    win = jnp.asarray(np.hanning(n).astype(np.float32))
    X = jnp.fft.fft(v * win, n=nfft)
    mag = jnp.abs(X) ** 2
    freqs = np.fft.fftfreq(nfft)  # cycles/sample, numpy (static)
    ok = jnp.asarray(np.abs(freqs) <= 2 * max_freq)
    mag = jnp.where(ok, mag, 0.0)
    k = jnp.argmax(mag)
    # parabolic refinement on the log-magnitude of the peak and neighbors
    km, kp = (k - 1) % nfft, (k + 1) % nfft
    lm = jnp.log(mag[km] + 1e-30)
    l0 = jnp.log(mag[k] + 1e-30)
    lp = jnp.log(mag[kp] + 1e-30)
    denom = lm - 2 * l0 + lp
    delta = jnp.where(jnp.abs(denom) > 1e-12,
                      0.5 * (lm - lp) / denom, 0.0)
    delta = jnp.clip(delta, -0.5, 0.5)
    kf = k.astype(jnp.float32) + delta
    f2 = jnp.where(kf > nfft / 2, kf - nfft, kf) / nfft  # signed, c/sample
    return f2 * 0.5  # squared-signal line sits at 2*f_cfo


def block_agc(x: jax.Array, reference: float = 1.0,
              block: int = 256) -> jax.Array:
    """Feedforward block AGC: per-block RMS normalization to ``reference``.

    The agc2 role for the device-resident chain — a per-sample feedback
    loop is sequential (see ``agc``, kept for the faithful streaming
    block); normalizing each block by its own RMS is fully batched and
    settles instantly. Trailing partial blocks are padded with zeros for
    the RMS estimate (slight under-gain on the last block only).
    """
    n = x.shape[0]
    nb = -(-n // block)
    xp = jnp.zeros(nb * block, x.dtype).at[:n].set(x)
    v = xp.reshape(nb, block)
    rms = jnp.sqrt(jnp.mean(jnp.abs(v) ** 2, axis=1, keepdims=True)) + 1e-12
    return (v * (reference / rms)).reshape(-1)[:n].astype(x.dtype)


def _pfb_init_search(xr: jax.Array, xi: jax.Array, bank: jax.Array, sps: int,
                     probe_syms: int):
    """Open-loop timing acquisition: mean matched-filter output power over
    every (integer offset, polyphase phase) in one batched pass; returns
    (ibase, frac) at the power maximum — the tracking loop's stable lock
    point (the S-curve zero with negative slope sits at the power peak).
    Operates on f32 planes (no complex dtype; filters are real)."""
    nfilts, L = bank.shape
    n = probe_syms * sps + L
    # correlate the probe with all nfilts rows at every lag: one grouped
    # conv per plane
    def conv_all(v):
        inp = v.reshape(1, 1, n)
        flt = bank[:, None, ::-1]
        out = jax.lax.conv_general_dilated(
            inp, flt, window_strides=(1,), padding="VALID",
            dimension_numbers=("NCH", "OIH", "NCH"))
        return out[0]                      # (nfilts, n - L + 1)
    yr = conv_all(xr[:n])
    yi = conv_all(xi[:n])
    pwr = yr * yr + yi * yi                # (nfilts, n - L + 1)
    m = ((pwr.shape[1] - sps) // sps) * sps
    # mean power per (phase, start offset s): samples s, s+sps, ...
    ps = pwr[:, :m + sps]
    nsym = m // sps
    ps = ps[:, : nsym * sps].reshape(nfilts, nsym, sps).mean(axis=1)  # (nfilts, sps)
    flat = ps.T.reshape(-1)                # index = s * nfilts + k
    best = jnp.argmax(flat)
    ibase = (best // nfilts).astype(jnp.int32)
    frac = (best % nfilts).astype(jnp.float32) / nfilts
    return ibase, frac


def _pfb_core(xr: jax.Array, xi: jax.Array, sps: int, nfilts: int,
              excess_bw: float, ntaps_per: int, block_syms: int,
              loop_bw: float, rate_clip: float, probe_syms: int, state0):
    """All-real polyphase clock-recovery core shared by the complex and
    pair-form entry points: planes in, (2, nsym) symbol planes + loop
    state out. See pfb_clock_sync for the algorithm documentation."""
    bank_np, dbank_np = polyphase_rrc_banks(sps, nfilts, excess_bw, ntaps_per)
    bank, dbank = jnp.asarray(bank_np), jnp.asarray(dbank_np)
    L = bank_np.shape[1]
    damping = math.sqrt(2.0) / 2.0
    den = 1.0 + 2.0 * damping * loop_bw + loop_bw * loop_bw
    alpha = jnp.float32(4 * damping * loop_bw / den)
    beta = jnp.float32(4 * loop_bw * loop_bw / den)

    n = int(xr.shape[0])
    B = block_syms
    # Per-symbol position model inside one block: pos_k = frac + k*(sps +
    # rate), k = 0..B-1. Its integer part deviates from the nominal k*sps
    # grid by d_k in [-B*rate_clip, 1 + B*rate_clip + 1]; D0/Dspan bound
    # that deviation so every window index is static-shape.
    D0 = int(math.ceil(B * rate_clip)) + 1
    Dspan = 2 * D0 + 1
    T = L + Dspan                       # per-symbol window columns
    # natural-order window matrix via the reshape trick (see filter_block):
    # columns round up to whole sps groups, window length to whole rows
    Tq = (T + sps - 1) // sps
    T2 = Tq * sps
    win_len = (B + Tq + 1) * sps
    nblocks = max((n - win_len - sps - 4) // (B * sps), 0)
    margin = int(rate_clip * nblocks * B) + 2 * sps + 4
    nblocks = max((n - win_len - margin) // (B * sps), 0)

    # D0 leading zeros keep the window slice start (ibase) nonnegative
    # when d_k < 0 early in a block; all ibase arithmetic stays in the
    # ORIGINAL stream indexing (the pad cancels the -D0 column offset)
    xr_p = jnp.concatenate([jnp.zeros(D0, xr.dtype), xr])
    xi_p = jnp.concatenate([jnp.zeros(D0, xi.dtype), xi])

    if state0 is None:
        ibase0, frac0 = _pfb_init_search(xr, xi, bank, sps,
                                         min(probe_syms, max(nblocks, 1)
                                             * block_syms))
        rate0 = jnp.float32(0.0)
    else:
        ibase0 = jnp.asarray(state0[0], jnp.int32)
        frac0 = jnp.asarray(state0[1], jnp.float32)
        rate0 = jnp.asarray(state0[2], jnp.float32)

    ks = jnp.arange(B, dtype=jnp.float32)
    # Extended tap bank: row r = d*nfilts + p holds bank[p] placed at
    # window column d — one row index encodes BOTH the integer sample
    # shift and the polyphase phase, linear in the quantized sampling
    # position (adjacent r = adjacent instants, across integer-sample
    # boundaries too). The matched filter, its derivative, and both at
    # row shifts -+1 (the S-curve probes: np.roll moves the whole bank
    # one quantization step) are concatenated column-wise, so ONE
    # one-hot (B, R) @ (R, 6*T2) matmul fetches all six per-symbol
    # tap rows per block.
    R = Dspan * nfilts
    etaps_np = np.zeros((R, 2 * T2), np.float32)
    for dd in range(Dspan):
        etaps_np[dd * nfilts:(dd + 1) * nfilts, dd:dd + L] = bank_np
        etaps_np[dd * nfilts:(dd + 1) * nfilts,
                 T2 + dd:T2 + dd + L] = dbank_np
    big = jnp.asarray(np.concatenate(
        [etaps_np, np.roll(etaps_np, 1, 0), np.roll(etaps_np, -1, 0)],
        axis=1))                                            # (R, 6*T2)
    iota_r = jnp.arange(R, dtype=jnp.int32)[None, :]

    def filter_block(ibase, frac, rate):
        """Matched-filter one block at per-symbol interpolated instants
        pos_k = frac + k*(sps + rate), at three polyphase shifts (0, -1,
        +1 quantization steps = -+1/nfilts input samples; the outer
        shifts measure the discriminant's S-curve slope in-band).
        Returns three (yr, yi, u, pw) tuples [center, minus, plus].

        The window matrix is built from a (B+Tq+1, sps) reshape followed
        by Tq CONTIGUOUS row slabs instead of per-symbol strided slices —
        W0[k, q*sps+s] = reshape(w)[k+q, s], so concatenating the slabs
        yields natural offset order with zero permutation. Per-symbol taps
        for all three shifts come from one one-hot matmul against the
        widened bank. No gathers anywhere."""
        # the k*sps*nfilts part of the sampling position is kept as EXACT
        # integers; only the small fractional part (|frac + k*rate| <=
        # 1 + B*rate_clip) is rounded — at B >= 8192 the naive product
        # (frac + k*(sps+rate))*nfilts reaches ~5e5 where the f32 quantum
        # equals a whole phase step and the tracker loses lock
        posq = (jnp.arange(B, dtype=jnp.int32) * (sps * nfilts)
                + jnp.round((frac + ks * rate) * nfilts).astype(jnp.int32))
        r = posq - (jnp.arange(B, dtype=jnp.int32) * sps - D0) * nfilts
        r = jnp.clip(r, 1, R - 2)            # keep the -+1 rows in range
        oh = (r[:, None] == iota_r).astype(jnp.float32)     # (B, R)
        wr = jax.lax.dynamic_slice(xr_p, (ibase,), (win_len,))
        wi = jax.lax.dynamic_slice(xi_p, (ibase,), (win_len,))
        Mr = wr.reshape(B + Tq + 1, sps)
        Mi = wi.reshape(B + Tq + 1, sps)
        W0r = jnp.concatenate([Mr[q:q + B] for q in range(Tq)], 1)
        W0i = jnp.concatenate([Mi[q:q + B] for q in range(Tq)], 1)
        # one-hot rows select taps: HIGHEST keeps each selected tap exact
        # (TF32 would round the taps to 10 mantissa bits, ~1e-3 relative)
        td = jnp.dot(oh, big, preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)

        outs = []
        for b in range(3):                   # center, minus, plus
            tf = td[:, (2 * b) * T2:(2 * b + 1) * T2]
            df = td[:, (2 * b + 1) * T2:(2 * b + 2) * T2]
            yr = jnp.sum(W0r * tf, axis=1)                  # (B,)
            yi_ = jnp.sum(W0i * tf, axis=1)
            dyr = jnp.sum(W0r * df, axis=1)
            dyi = jnp.sum(W0i * df, axis=1)
            outs.append((yr, yi_, yr * dyr + yi_ * dyi,
                         yr * yr + yi_ * yi_))
        return outs

    def half_errs(u, pw):
        h = B // 2
        e1 = jnp.mean(u[:h]) / (jnp.mean(pw[:h]) + 1e-12)
        e2 = jnp.mean(u[h:]) / (jnp.mean(pw[h:]) + 1e-12)
        return e1, e2

    def step(carry, _):
        """One tracking block: per-symbol linear phase interpolation with
        a SELF-CALIBRATING timing discriminant.

        Each symbol k samples at its own interpolated instant frac +
        k*(sps + rate), so block size no longer bounds the tolerable
        clock drift (the round-3 limit ``block*sps*ppm << 1/nfilts``)
        and the sequential scan — whose per-step latency, not compute,
        bounds chain throughput — runs B/64 times fewer steps.

        A per-block alpha/beta loop cannot survive that step-count diet:
        its raw discriminant e = <y·dy>/<y²> carries an unknown S-curve
        gain g = de/dτ, and convergence needs tens of block updates a
        large-block stream never provides (measured: rate settles at a
        wrong value that per-block phase corrections silently absorb at
        block 64-256, and poisons the intra-block interpolation at 1024+).
        So the block is ALSO filtered at polyphase shifts +-1 (two more
        fully-parallel passes) to measure g in-band: g = (e+ - e-) *
        nfilts / 2, making tau = e/g the timing error in true input-
        sample units. Half-block tau estimates then drive a damped
        deadbeat update — their difference observes the residual rate
        error directly, their mean the phase error — and lock settles
        within a few blocks at ANY block size (pinned at 2048 symbols
        under +-50 ppm drift in tests/test_dsp.py).
        """
        ibase, frac, rate = carry
        ((yr, yi_, u0, pw0), (_, _, um, pwm),
         (_, _, up, pwp)) = filter_block(ibase, frac, rate)
        e1, e2 = half_errs(u0, pw0)
        e1m, e2m = half_errs(um, pwm)
        e1p, e2p = half_errs(up, pwp)
        delta = 1.0 / nfilts                 # input samples per phase step
        g1 = (e1p - e1m) / (2.0 * delta)
        g2 = (e2p - e2m) / (2.0 * delta)
        # tau in input samples, via the QUADRATURE form (round 5): the
        # discriminant is sinusoidal in the timing offset — e ~ E
        # sin(2 pi tau/sps), g ~ E (2 pi/sps) cos(...) — so
        # atan2(e, g*sps/2pi) recovers the signed distance to the STABLE
        # zero over the FULL symbol. Near lock it reduces exactly to the
        # classic e/g linearization; at the S-curve peak (g through 0,
        # where both a raw quotient and any sign-of-g floor point the
        # wrong way for half the starting phases — a mid-symbol
        # acquisition failure observed on long streams) it returns
        # +-sps/4 toward the stable zero; with no signal (e, g -> 0) it
        # returns a NEUTRAL 0 instead of a clamped kick.
        qs = sps / (2.0 * np.pi)
        tau1 = qs * jnp.arctan2(e1, g1 * qs)
        tau2 = qs * jnp.arctan2(e2, g2 * qs)
        h = B // 2
        # gain schedule: tau noise scales ~1/sqrt(half-block), so large
        # blocks take a near-deadbeat step (lock in ~2 blocks — all a
        # short large-block stream provides) while small blocks damp
        # toward the classic slow-loop regime; rate gain is the square
        # of the phase gain (standard 2nd-order ordering)
        a = float(np.clip(0.7 * B / 1024.0, 0.15, 0.7))
        rate = jnp.clip(rate - (a * a) * (tau2 - tau1) / h,
                        -rate_clip, rate_clip)
        # tau extrapolated to the block end (the next block's start)
        tau_end = tau2 + 0.5 * (tau2 - tau1)
        adv = frac + B * sps + B * rate - a * tau_end
        stepi = jnp.floor(adv).astype(jnp.int32)
        return ((ibase + stepi, adv - stepi, rate),
                jnp.stack([yr, yi_]))                       # (2, B)

    (ibaseF, fracF, rateF), ys = jax.lax.scan(
        step, (ibase0, frac0, rate0), None, length=nblocks)
    # ys: (nblocks, 2, block_syms) -> (2, nblocks*block_syms)
    ys = jnp.transpose(ys, (1, 0, 2)).reshape(2, -1)
    return ys, (ibaseF, fracF, rateF)


@partial(jax.jit, static_argnames=("sps", "nfilts", "excess_bw", "ntaps_per",
                                   "block_syms", "loop_bw", "rate_clip",
                                   "probe_syms"))
def pfb_clock_sync(x: jax.Array, sps: int, nfilts: int = 32,
                   excess_bw: float = 0.35, ntaps_per: int = 11,
                   block_syms: int = 64, loop_bw: float = 0.06,
                   rate_clip: float = 0.002, probe_syms: int = 256,
                   state0=None):
    """Polyphase matched-filter clock recovery with fractional-delay and
    clock-drift tracking (the pfb_clock_sync role of example4.grc).

    Batched structure: GR updates the loop once per SYMBOL (a
    fundamentally sequential per-symbol feedback); here acquisition is a
    fully batched open-loop power search over all sps*nfilts timing
    offsets (_pfb_init_search), and tracking is a ``lax.scan`` over BLOCKS
    of ``block_syms`` symbols — within a block the timing is frozen (at
    +-50 ppm clock drift the intra-block drift is <= 0.01 samples, well
    under the 1/nfilts phase grid), the block's symbols come from one
    dynamically-phase-selected FIR pass, and the loop updates once per
    block from the power-normalized Gardner-family detector
    e = mean(Re(y)Re(y') + Im(y)Im(y')) (y' = derivative-bank output).
    The detector's stable zero is the matched-filter power peak; e > 0
    means the sampling instant is late, so the update is frac -= alpha*e
    (sign pinned by tests against injected +-50/200 ppm drift).

    Returns (symbols (nblocks*block_syms,), (ibase, frac, rate)): the final
    loop state. ``state0`` (same tuple shape, with ibase relative to this
    call's ``x``) continues tracking across stream chunks WITHOUT re-running
    acquisition — the PfbClockSyncBlock carries it, slicing its buffer to
    the returned ibase each chunk.
    """
    xr = jnp.real(x).astype(jnp.float32)
    xi = jnp.imag(x).astype(jnp.float32)
    ys, state = _pfb_core(xr, xi, sps, nfilts, excess_bw, ntaps_per,
                          block_syms, loop_bw, rate_clip, probe_syms, state0)
    return (ys[0] + 1j * ys[1]).astype(jnp.complex64), state


def vv_carrier_recovery(syms: jax.Array, block: int = 64) -> jax.Array:
    """Feedforward BPSK carrier-phase recovery (Viterbi&Viterbi, M=2).

    The costas_loop role for the device-resident chain: instead of a
    per-symbol feedback scan, estimate the residual carrier phase per
    BLOCK as angle(mean(y^2))/2 (squaring removes BPSK modulation), unwrap
    the mod-pi estimates across blocks (valid while the residual CFO moves
    the phase < pi/2 per block — guaranteed after coarse_cfo_estimate),
    linearly interpolate per symbol, and derotate. Fully vectorized; the
    remaining pi ambiguity is absorbed by the decoder's IN_SYNC_INVERTED
    state exactly as the Costas loop's is.
    """
    n = syms.shape[0]
    nb = -(-n // block)
    v = jnp.zeros(nb * block, syms.dtype).at[:n].set(syms).reshape(nb, block)
    ph2 = jnp.angle(jnp.mean(v * v, axis=1))        # 2*phase, mod 2pi
    # unwrap (mod 2pi in the doubled domain = mod pi in phase)
    d = jnp.diff(ph2)
    d = jnp.mod(d + jnp.pi, 2 * jnp.pi) - jnp.pi
    ph2u = jnp.concatenate([ph2[:1], ph2[0] + jnp.cumsum(d)])
    ph = ph2u * 0.5                                 # per-block center phase
    # per-symbol linear interpolation between the uniform block centers,
    # in closed form (shifted neighbors + weight vector) instead of
    # jnp.interp's searchsorted + gather; see vv_carrier_recovery_pairs
    ph_prev = jnp.concatenate([ph[:1], ph[:-1]])
    ph_next = jnp.concatenate([ph[1:], ph[-1:]])
    tau = ((jnp.arange(block, dtype=jnp.float32) + 0.5) / block
           - 0.5)[None, :]
    lo = ph_prev[:, None] + (1.0 + tau) * (ph - ph_prev)[:, None]
    hi = ph[:, None] + tau * (ph_next - ph)[:, None]
    phi = jnp.where(tau < 0, lo, hi).reshape(-1)[:n]
    return (syms * jnp.exp(-1j * phi)).astype(jnp.complex64)


def rx_chain(x: jax.Array, sps: int = 2, excess_bw: float = 0.35,
             nfilts: int = 32, agc_block: int = 256,
             carrier_block: int = 64, max_freq: float = 0.2) -> jax.Array:
    """Device-resident receive chain: AGC -> coarse CFO -> polyphase timing
    -> carrier recovery, returning 1-sample/symbol soft BPSK symbols.

    The example4.grc chain (agc2 -> fll_band_edge -> pfb_clock_sync ->
    costas_loop, SURVEY.md section 3.4) recomposed for a batch device: every
    feedback loop that can be a feedforward estimator is one (block AGC,
    squaring-FFT CFO, Viterbi&Viterbi carrier), and the one true tracking
    loop (clock recovery) scans per 64-symbol block, not per sample. The
    whole chain jits as one program; compose with
    parallel.StreamReceiver.receive (which takes the returned device array
    directly) for frame sync + mesh-sharded decode. The pi phase ambiguity
    of the carrier recovery is absorbed by the receiver's inverted-sync
    handling, exactly as the reference's Costas ambiguity is.
    """
    x = block_agc(x, block=agc_block)
    f = coarse_cfo_estimate(x, max_freq=max_freq)
    x = mix(x, f)
    y, _state = pfb_clock_sync(x, sps=sps, nfilts=nfilts,
                               excess_bw=excess_bw)
    return vv_carrier_recovery(y, block=carrier_block)


# ---------------------------------------------------------------------------
# Pair-form (complex-free) chain: I/Q as (2, T) float32 planes
# ---------------------------------------------------------------------------
#
# The pair form carries a complex signal as two f32 planes (2, T) and never
# uses a complex dtype or an FFT: the DFT the CFO estimator needs is a
# chunk-factorized matmul. Each *_pairs function matches its complex
# counterpart (same math, floating-point reassociation only);
# rx_chain_pairs is the device-resident example4 chain. Which of the two
# chains is faster on the GPU is not measured yet.


def to_pairs(x: jax.Array) -> jax.Array:
    """complex (T,) -> planes (2, T) f32 [re, im]."""
    return jnp.stack([jnp.real(x), jnp.imag(x)]).astype(jnp.float32)


def from_pairs(xp: jax.Array) -> jax.Array:
    """planes (2, T) -> complex64 (T,)."""
    return (xp[0] + 1j * xp[1]).astype(jnp.complex64)


def mix_pairs(xp: jax.Array, freq: float | jax.Array, phase0: float = 0.0,
              t0: float | jax.Array = 0.0) -> jax.Array:
    """Pair-form ``mix``: rotate by exp(-j*(2*pi*freq*(t0+n) + phase0))."""
    n = t0 + jnp.arange(xp.shape[1], dtype=jnp.float32)
    ph = 2 * jnp.pi * freq * n + phase0
    c, s = jnp.cos(ph), jnp.sin(ph)
    r, i = xp[0], xp[1]
    return jnp.stack([r * c + i * s, i * c - r * s])


def block_agc_pairs(xp: jax.Array, reference: float = 1.0,
                    block: int = 256) -> jax.Array:
    """Pair-form ``block_agc``: per-block RMS normalization."""
    n = xp.shape[1]
    nb = -(-n // block)
    v = jnp.pad(xp, ((0, 0), (0, nb * block - n))).reshape(2, nb, block)
    rms = jnp.sqrt(jnp.mean(v[0] ** 2 + v[1] ** 2, axis=1,
                            keepdims=True)) + 1e-12          # (nb, 1)
    return (v * (reference / rms)[None]).reshape(2, -1)[:, :n]


@functools.lru_cache(maxsize=None)
def _dft_bank(chunk: int, nch: int, f_lo: float, f_hi: float, nbins: int):
    """Constants for a chunk-factorized DFT over a static frequency grid:
    per-chunk cos/sin bases (chunk, nbins) and chunk-combination phasors
    (nch, nbins), evaluated in float64 then cast (exact arguments, no f32
    range-reduction error at large t)."""
    freqs = np.linspace(f_lo, f_hi, nbins, endpoint=False).astype(np.float64)
    u = np.arange(chunk, dtype=np.float64)
    ang_u = 2 * np.pi * np.outer(u, freqs)
    c = np.arange(nch, dtype=np.float64) * chunk
    ang_c = 2 * np.pi * np.outer(c, freqs)
    return (freqs.astype(np.float32),
            np.cos(ang_u).astype(np.float32), np.sin(ang_u).astype(np.float32),
            np.cos(ang_c).astype(np.float32), np.sin(ang_c).astype(np.float32))


def _dft_grid_mag(sr: jax.Array, si: jax.Array, chunk: int, bank) -> jax.Array:
    """|DFT|^2 of the complex signal (sr, si) planes on the bank's static
    frequency grid, chunk-factorized:
    X(f_k) = sum_c P_c(f_k) * sum_u s[cC+u] e^{-j2pi f_k u},
    P_c = e^{-j2pi f_k cC}. The inner sums are two stacked (nch, 2C) @
    (2C, nbins) matmuls; the combination is a tiny elementwise pass —
    no complex dtype anywhere."""
    _, Bc, Bs, Pc, Ps = bank
    nch = sr.shape[0] // chunk
    Sr = sr.reshape(nch, chunk)
    Si = si.reshape(nch, chunk)
    B1 = jnp.concatenate([jnp.asarray(Bc), jnp.asarray(Bs)], axis=0)
    # HIGHEST: the estimate is the arg-max of |X|^2 over the grid, and
    # TF32 inputs (~1e-3 relative error per term, summed over 2C terms)
    # could reorder near-tied bins; full f32 keeps the grid's peak where
    # the CPU finds it (tests bound the estimate error at 5e-3 cycles)
    Zr = jnp.dot(jnp.concatenate([Sr, Si], axis=1), B1,
                 preferred_element_type=jnp.float32,
                 precision=jax.lax.Precision.HIGHEST)
    Zi = jnp.dot(jnp.concatenate([Si, -Sr], axis=1), B1,
                 preferred_element_type=jnp.float32,
                 precision=jax.lax.Precision.HIGHEST)
    Pc_, Ps_ = jnp.asarray(Pc), jnp.asarray(Ps)
    Xr = jnp.sum(Zr * Pc_ + Zi * Ps_, axis=0)          # (nbins,)
    Xi = jnp.sum(Zi * Pc_ - Zr * Ps_, axis=0)
    return Xr * Xr + Xi * Xi


def coarse_cfo_estimate_pairs(xp: jax.Array, nfft: int = 1 << 16,
                              max_freq: float = 0.2, chunk: int = 1024,
                              n1: int = 4096,
                              zoom_bins: int = 256) -> jax.Array:
    """Pair-form coarse CFO estimate: the squared-BPSK spectral line located
    with a two-stage chunk-factorized matmul DFT instead of an FFT (no
    complex dtype anywhere).

    Stage 1 searches the full +-2*max_freq band with a SHORT window (n1
    samples) on a half-bin grid (step 1/(2*n1)), so the windowed line can
    never fall between grid points — a fine grid under a long window would
    need ~n*4*max_freq bins, and a coarse grid under a long window misses
    the narrow main lobe entirely (the failure mode that killed the
    single-stage design). Stage 2 derotates the full-window squared signal
    by the stage-1 estimate (dynamic-frequency rotation — plain cos/sin)
    and zooms with a +-1/(2*n1) static grid of ``zoom_bins`` around zero,
    then 3-point parabolic refinement: final resolution ~1e-6
    cycles/sample, finer than the FFT version's bin-limited estimate.
    """
    T = int(xp.shape[1])
    if T < 16:
        raise ValueError(
            f"coarse_cfo_estimate_pairs needs >= 16 samples, got {T}")
    n = min(nfft, T)
    # shrink the chunk for short streams so n = nch * chunk never exceeds
    # the samples actually present (round-3 advisor finding: n > T made
    # the window multiplies shape-mismatch)
    chunk = min(chunk, n)
    nch = n // chunk
    n = nch * chunk
    r, i = xp[0, :n], xp[1, :n]
    sr = r * r - i * i                         # squared signal planes
    si = 2.0 * r * i
    # ---- stage 1: short window, half-bin grid over the whole band
    m1 = min(n1, n)
    res1 = 1.0 / (2 * m1)
    nbins1 = int(np.ceil(4 * max_freq / res1))
    win1 = jnp.asarray(np.hanning(m1).astype(np.float32))
    bank1 = _dft_bank(min(chunk, m1), m1 // min(chunk, m1),
                      -2 * max_freq, -2 * max_freq + nbins1 * res1, nbins1)
    mag1 = _dft_grid_mag(sr[:m1] * win1, si[:m1] * win1, min(chunk, m1),
                         bank1)
    f1 = jnp.asarray(bank1[0])[jnp.argmax(mag1)]       # line freq, coarse
    # ---- stage 2: derotate by f1 (dynamic), zoom +-res1 on the full window
    t = jnp.arange(n, dtype=jnp.float32)
    ph = 2 * jnp.pi * f1 * t
    c_, s_ = jnp.cos(ph), jnp.sin(ph)
    dr = sr * c_ + si * s_                     # s * e^{-j 2pi f1 t}
    di = si * c_ - sr * s_
    win = jnp.asarray(np.hanning(n).astype(np.float32))
    zoom_span = 2 * res1
    dfz = zoom_span / zoom_bins
    bank2 = _dft_bank(chunk, nch, -res1, -res1 + zoom_bins * dfz, zoom_bins)
    mag = _dft_grid_mag(dr * win, di * win, chunk, bank2)
    k = jnp.argmax(mag)
    km = jnp.clip(k - 1, 0, zoom_bins - 1)
    kp = jnp.clip(k + 1, 0, zoom_bins - 1)
    lm = jnp.log(mag[km] + 1e-30)
    l0 = jnp.log(mag[k] + 1e-30)
    lp = jnp.log(mag[kp] + 1e-30)
    denom = lm - 2 * l0 + lp
    delta = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (lm - lp) / denom, 0.0)
    delta = jnp.clip(delta, -0.5, 0.5)
    f2 = f1 + jnp.float32(-res1) + (k.astype(jnp.float32) + delta) * dfz
    return f2 * 0.5                                    # line sits at 2*f_cfo


def vv_carrier_recovery_pairs(sp: jax.Array, block: int = 64) -> jax.Array:
    """Pair-form ``vv_carrier_recovery`` (Viterbi&Viterbi, M=2).

    The per-sample phase is linearly interpolated between uniform block
    centers in CLOSED FORM (shifted-neighbor arrays + a per-position
    weight vector) instead of ``jnp.interp``: interp lowers to
    searchsorted + gather; the arithmetic form equals interp's clamped-end
    semantics up to rounding, since the centers are a uniform grid.
    """
    r, i = sp[0], sp[1]
    n = r.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    vr = jnp.pad(r, (0, pad)).reshape(nb, block)
    vi = jnp.pad(i, (0, pad)).reshape(nb, block)
    s2r = jnp.mean(vr * vr - vi * vi, axis=1)
    s2i = jnp.mean(2.0 * vr * vi, axis=1)
    ph2 = jnp.arctan2(s2i, s2r)                       # 2*phase, mod 2pi
    d = jnp.diff(ph2)
    d = jnp.mod(d + jnp.pi, 2 * jnp.pi) - jnp.pi
    ph2u = jnp.concatenate([ph2[:1], ph2[0] + jnp.cumsum(d)])
    ph = ph2u * 0.5                                   # (nb,) center phases
    ph_prev = jnp.concatenate([ph[:1], ph[:-1]])
    ph_next = jnp.concatenate([ph[1:], ph[-1:]])
    # sample j of block m sits at tau = (j+0.5)/block - 0.5 center units:
    # tau < 0 interpolates toward ph_prev, tau >= 0 toward ph_next; the
    # duplicated end rows reproduce interp's endpoint clamping
    tau = ((jnp.arange(block, dtype=jnp.float32) + 0.5) / block
           - 0.5)[None, :]                            # (1, block)
    lo = ph_prev[:, None] + (1.0 + tau) * (ph - ph_prev)[:, None]
    hi = ph[:, None] + tau * (ph_next - ph)[:, None]
    phi = jnp.where(tau < 0, lo, hi).reshape(-1)[:n]
    c, s = jnp.cos(phi), jnp.sin(phi)
    return jnp.stack([r * c + i * s, i * c - r * s])


@partial(jax.jit, static_argnames=("sps", "nfilts", "excess_bw", "ntaps_per",
                                   "block_syms", "loop_bw", "rate_clip",
                                   "probe_syms"))
def pfb_clock_sync_pairs(xp: jax.Array, sps: int, nfilts: int = 32,
                         excess_bw: float = 0.35, ntaps_per: int = 11,
                         block_syms: int = 64, loop_bw: float = 0.06,
                         rate_clip: float = 0.002, probe_syms: int = 256,
                         state0=None):
    """Pair-form ``pfb_clock_sync``: planes in, (2, nsym) planes out. The
    tracking core is already all-real (the complex API splits to planes
    internally); this entry point simply never touches a complex dtype."""
    ys, state = _pfb_core(xp[0], xp[1], sps, nfilts, excess_bw, ntaps_per,
                          block_syms, loop_bw, rate_clip, probe_syms, state0)
    return ys, state


def _wrap(v, period):
    return jnp.mod(v + 0.5 * period, period) - 0.5 * period


@partial(jax.jit, static_argnames=("sps", "nfilts", "excess_bw", "ntaps_per",
                                   "est_block", "chunk_syms", "rate_clip"))
def pfb_clock_sync_ff_pairs(xp: jax.Array, sps: int, nfilts: int = 32,
                            excess_bw: float = 0.35, ntaps_per: int = 11,
                            est_block: int = 1024, chunk_syms: int = 8192,
                            rate_clip: float = 2.5e-4):
    """FEED-FORWARD polyphase clock recovery (round 5).

    The tracking scan in ``_pfb_core`` is a feedback loop: each block's
    sampling depends on the previous block's update, so the sequential
    scan's per-step latency — not compute — bounds chain throughput. For
    the continuous-pipeline regime
    (transmitter/receiver.grc: one stable clock per stream, the BASELINE
    config-5 scenario) the timing trajectory is a LINE, tau(m) = a + r*m,
    and fitting it needs no feedback. Two passes, both parallel:

    1. One windows matmul applies the matched filter, its derivative,
       and both at -+1/nfilts probe shifts at the NOMINAL grid over the
       whole stream at once (six tap columns, (nsym, T12) @ (T12, 6)).
       Per ``est_block`` symbols the power-normalized Gardner
       discriminant e = <y.y'>/<|y|^2> and its in-band S-curve slope
       g = (e+ - e-)*nfilts/2 form an amplitude-normalized QUADRATURE
       pair whose atan2 recovers the wrapped timing tau_b over the FULL
       symbol (period sps) — including at the unstable zero, where a
       plain e/g quotient diverges. The clock model is then fit
       WRAP-ROBUSTLY: drift r from a confidence-weighted mean of
       wrapped block-to-block differences (no cumulative unwrap to
       poison), offset a from the circular mean of tau_b - r*m_b, with
       per-block S-curve-amplitude-times-power confidence weights.
    2. A lean ``lax.scan`` over ``chunk_syms``-symbol chunks whose
       (ibase, frac) are PRECOMPUTED arrays (no feedback in the carry)
       filters at the model positions through the same extended
       shift+phase tap bank as the tracker (one one-hot matmul per
       chunk), emitting symbols AND residual (e, g) probes; a weighted
       least-squares line fit of the residuals refines (a, r) once —
       pass-1 estimates are shrinkage-biased where |tau| nears sps/2,
       the refinement measures in the discriminant's linear region —
       and a second scan emits the final symbols.

    rate_clip bounds |r| in samples/symbol (2.5e-4 covers +-62 ppm at
    sps=2). Returns (ys (2, nsym), (a, r)). Lock under +-50 ppm drift +
    carrier offset is pinned by tests against the tracking core's output.

    It is kept as the structurally parallel design (no sequential
    dependence between chunks — e.g. shardable over a mesh axis, which
    the feedback tracker fundamentally is not); whether it beats the
    tracker on the GPU is not measured.
    """
    xr = xp[0].astype(jnp.float32)
    xi = xp[1].astype(jnp.float32)
    bank_np, dbank_np = polyphase_rrc_banks(sps, nfilts, excess_bw, ntaps_per)
    L = bank_np.shape[1]
    n = int(xr.shape[0])
    # guard BEFORE pass 1: its window reshape would otherwise fail with
    # an opaque negative-dimension trace error on streams too short for
    # even one pass-2 chunk (same geometry as computed below)
    _D0 = int(math.ceil(chunk_syms * rate_clip)) + 2
    _Tq = (L + 2 * _D0 + 1 + sps - 1) // sps
    _win = (chunk_syms + _Tq + 1) * sps
    _mo = int(math.ceil(rate_clip * (n // max(sps, 1)))) + sps + 2
    if (n - _win - _mo) // (chunk_syms * sps) < 1:
        raise ValueError(
            f"stream of {n} samples too short for chunk_syms={chunk_syms}")

    # ---- pass 1: six-tap-set windows matmul at the nominal grid --------
    # (reshape-slab windows + one (nsym, T12) @ (T12, 6) matmul instead of
    # a lax.conv)
    T1 = L + 2
    Tq1 = (T1 + sps - 1) // sps
    T12 = Tq1 * sps
    nsym1 = (n - (Tq1 + 1) * sps) // sps
    kerm = np.zeros((T12, 6), np.float32)
    # extended-row convention (see _pfb_core): position offset of
    # (shift d, phase p) = d + p/nfilts; center sits at offset 1 so the
    # -1/nfilts probe stays in-window
    kerm[1:1 + L, 0] = bank_np[0]
    kerm[1:1 + L, 1] = dbank_np[0]
    kerm[0:L, 2] = bank_np[nfilts - 1]            # center - 1/nfilts
    kerm[0:L, 3] = dbank_np[nfilts - 1]
    kerm[1:1 + L, 4] = bank_np[1]                 # center + 1/nfilts
    kerm[1:1 + L, 5] = dbank_np[1]
    kerm_j = jnp.asarray(kerm)

    def _p1(x):
        M = x[: (nsym1 + Tq1 + 1) * sps].reshape(nsym1 + Tq1 + 1, sps)
        W = jnp.concatenate([M[q:q + nsym1] for q in range(Tq1)], 1)
        # HIGHEST: these are FIR outputs that feed the timing fit; TF32
        # would add ~1e-3 relative error to every output
        return jnp.dot(W, kerm_j, preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)

    cr, ci_ = _p1(xr), _p1(xi)                    # (nsym1, 6)
    nb = nsym1 // est_block
    cr_b = cr[: nb * est_block].reshape(nb, est_block, 6)
    ci_b = ci_[: nb * est_block].reshape(nb, est_block, 6)
    e_probe = []
    pw_mean = None
    for p in range(3):
        yr, dyr = cr_b[:, :, 2 * p], cr_b[:, :, 2 * p + 1]
        yi, dyi = ci_b[:, :, 2 * p], ci_b[:, :, 2 * p + 1]
        u = jnp.mean(yr * dyr + yi * dyi, axis=1)
        pw = jnp.mean(yr * yr + yi * yi, axis=1)
        e_probe.append(u / (pw + 1e-12))
        if p == 0:
            pw_mean = pw
    e0, em, ep = e_probe
    g = (ep - em) * (nfilts / 2.0)                 # de/dtau, per block
    # the discriminant is sinusoidal in the timing offset (measured:
    # e(tau) ~ E sin(2 pi tau / sps), so g(tau) ~ E (2 pi / sps)
    # cos(...)) — (e, g*sps/2pi) is a QUADRATURE pair and atan2 recovers
    # tau over the FULL symbol, unbiased (a plain e/g linearization
    # shrinks toward 0 away from the stable zero and explodes near the
    # unstable one)
    gq = g * (sps / (2.0 * jnp.pi))
    # normalize the quadrature pair by the measured S-curve amplitudes
    # before atan2: if amp(e) != amp(gq) the raw angle is elliptically
    # warped (up to ~0.3-sample bias between the zeros); normalizing by
    # the per-stream RMS amplitudes removes it, so the single refinement
    # scan below starts in the discriminant's linear region.
    sconf = pw_mean / (jnp.sum(pw_mean) + 1e-12)
    amp_e = jnp.sqrt(2.0 * jnp.sum(sconf * e0 * e0)) + 1e-12
    amp_g = jnp.sqrt(2.0 * jnp.sum(sconf * gq * gq)) + 1e-12
    # sign: the scan applies ofs as a sampling ADVANCE, and its residual
    # convention is "positive = late" (corrected by subtraction); the
    # nominal-grid estimate enters the model negated so pass 2 starts
    # with a near-zero residual (a sign-inverted start doubles the
    # residual slope and can out-run the chunk unwrap)
    tau = -(sps / (2.0 * jnp.pi)) * jnp.arctan2(e0 * amp_g, gq * amp_e)
    conf = pw_mean * jnp.sqrt(e0 * e0 + gq * gq)   # S-curve amplitude
    # drift from wrapped diffs (no cumulative unwrap), offset circularly
    w2 = jnp.minimum(conf[1:], conf[:-1])
    d = _wrap(tau[1:] - tau[:-1], float(sps))
    r0 = jnp.sum(w2 * d) / (jnp.sum(w2) + 1e-12) / est_block
    # the stream padding and bank windows below are sized for
    # |r| <= rate_clip; a noisy raw estimate (bounded only by the wrap,
    # ~sps/(2*est_block)) must not outrun them
    r0 = jnp.clip(r0, -rate_clip, rate_clip)
    m_b = (jnp.arange(nb, dtype=jnp.float32) + 0.5) * est_block
    ang = 2 * jnp.pi * (tau - r0 * m_b) / sps
    a0 = (sps / (2 * jnp.pi)) * jnp.arctan2(
        jnp.sum(conf * jnp.sin(ang)), jnp.sum(conf * jnp.cos(ang)) + 1e-12)

    # ---- pass 2: precomputed-parameter chunk scan ----------------------
    B = chunk_syms
    D0 = int(math.ceil(B * rate_clip)) + 2
    Dspan = 2 * D0 + 1
    T = L + Dspan
    Tq = (T + sps - 1) // sps
    T2 = Tq * sps
    win_len = (B + Tq + 1) * sps
    R = Dspan * nfilts
    # ONE extra shift group beyond Dspan: a dynamic row slice
    # [s, s + R) of the extended bank implements the per-chunk
    # fractional phase (s = round(frac * nfilts)), which keeps the
    # (B, R) one-hot INDEPENDENT of the chunk — XLA hoists its
    # construction out of the scan, so each step is one matmul against
    # a small sliced bank instead of an 11-MB one-hot materialization
    # (measured: the chunk-dependent one-hot dominated the scan wall)
    etaps_np = np.zeros((R + nfilts, 2 * T2), np.float32)
    for dd in range(Dspan + 1):
        etaps_np[dd * nfilts:(dd + 1) * nfilts, dd:dd + L] = bank_np
        etaps_np[dd * nfilts:(dd + 1) * nfilts,
                 T2 + dd:T2 + dd + L] = dbank_np
    # measure bank: center + -+1/nfilts probes x (y, dy) = 6 tap sets;
    # emit bank: the center matched filter only (a third of the matmul work
    # — the final scan needs no probes). bf16: the one-hot selection is
    # exact; tap rounding (~0.4%) sits ~48 dB under the symbols, far
    # below channel noise
    big_m = jnp.asarray(np.concatenate(
        [etaps_np, np.roll(etaps_np, 1, 0), np.roll(etaps_np, -1, 0)],
        axis=1), jnp.bfloat16)                     # (R + nfilts, 6*T2)
    big_e = jnp.asarray(etaps_np[:, :T2], jnp.bfloat16)
    iota_r = jnp.arange(R, dtype=jnp.int32)[None, :]
    # worst-case |a + r*m| over the stream bounds the front/back padding
    max_ofs = int(math.ceil(rate_clip * (n // max(sps, 1)))) + sps + 2
    P0 = max_ofs + D0 + 2
    xr_p = jnp.concatenate([jnp.zeros(P0, jnp.float32), xr,
                            jnp.zeros(P0 + win_len, jnp.float32)])
    xi_p = jnp.concatenate([jnp.zeros(P0, jnp.float32), xi,
                            jnp.zeros(P0 + win_len, jnp.float32)])
    nc = (n - win_len - max_ofs) // (B * sps)   # >= 1: guarded above
    ks_i = jnp.arange(B, dtype=jnp.int32)
    ks_f = ks_i.astype(jnp.float32)

    def chunk_params(a_hat, r_hat):
        mc = jnp.arange(nc, dtype=jnp.float32) * B
        ofs = a_hat + r_hat * mc
        ib = ((jnp.arange(nc, dtype=jnp.int32) * (B * sps))
              + jnp.floor(ofs).astype(jnp.int32) + P0)
        fr = ofs - jnp.floor(ofs)
        # fractional phase as an extended-bank row shift (see above);
        # quantizing frac separately from k*r_hat costs at most one
        # 1/nfilts step of jitter vs the fused rounding
        return ib, jnp.clip(jnp.round(fr * nfilts).astype(jnp.int32),
                            0, nfilts)

    def chunk_onehot(r_hat):
        # chunk-independent symbol row indices (the frac shift moved to
        # the bank slice) — constructed ONCE per scan, hoisted by XLA
        r_idx = (D0 * nfilts
                 + jnp.round(ks_f * r_hat * nfilts).astype(jnp.int32))
        r_idx = jnp.clip(r_idx, 1, R - 2)
        return (r_idx[:, None] == iota_r).astype(jnp.bfloat16)

    def windows(ibase):
        wr = jax.lax.dynamic_slice(xr_p, (ibase,), (win_len,))
        wi = jax.lax.dynamic_slice(xi_p, (ibase,), (win_len,))
        Mr = wr.reshape(B + Tq + 1, sps)
        Mi = wi.reshape(B + Tq + 1, sps)
        W0r = jnp.concatenate([Mr[q:q + B] for q in range(Tq)], 1)
        W0i = jnp.concatenate([Mi[q:q + B] for q in range(Tq)], 1)
        return W0r, W0i

    def measure_pass(a_hat, r_hat):
        ib, sh = chunk_params(a_hat, r_hat)
        oh = chunk_onehot(r_hat)

        def body(_, inps):
            ibase, s_c = inps
            W0r, W0i = windows(ibase)
            bsl = jax.lax.dynamic_slice(big_m, (s_c, jnp.int32(0)),
                                        (R, 6 * T2))
            # one-hot select of bf16 taps: HIGHEST keeps the selection exact
            td = jnp.dot(oh, bsl, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
            es, pws = [], []
            for b in range(3):
                tf = td[:, (2 * b) * T2:(2 * b + 1) * T2]
                df = td[:, (2 * b + 1) * T2:(2 * b + 2) * T2]
                yr = jnp.sum(W0r * tf, axis=1)
                yi_ = jnp.sum(W0i * tf, axis=1)
                u = jnp.mean(yr * jnp.sum(W0r * df, axis=1)
                             + yi_ * jnp.sum(W0i * df, axis=1))
                pw = jnp.mean(yr * yr + yi_ * yi_)
                es.append(u / (pw + 1e-12))
                pws.append(pw)
            g_c = (es[2] - es[1]) * (nfilts / 2.0)
            return None, (es[0], g_c, pws[0])

        return jax.lax.scan(body, None, (ib, sh))[1]

    def emit_pass(a_hat, r_hat):
        ib, sh = chunk_params(a_hat, r_hat)
        oh = chunk_onehot(r_hat)

        def body(_, inps):
            ibase, s_c = inps
            W0r, W0i = windows(ibase)
            bsl = jax.lax.dynamic_slice(big_e, (s_c, jnp.int32(0)),
                                        (R, T2))
            # one-hot select of bf16 taps: HIGHEST keeps the selection exact
            td = jnp.dot(oh, bsl, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
            return None, jnp.stack([jnp.sum(W0r * td, axis=1),
                                    jnp.sum(W0i * td, axis=1)])

        ys = jax.lax.scan(body, None, (ib, sh))[1]
        return jnp.transpose(ys, (1, 0, 2)).reshape(2, -1)

    # ONE refinement round: pass 1's normalized-quadrature estimate lands
    # within the discriminant's linear region, where atan2(e, gq) -> e/g
    # is exact, so a single measured correction reaches the noise floor;
    # the emit scan then runs with the center-bank only
    m_c = (jnp.arange(nc, dtype=jnp.float32) + 0.5) * B
    e_c, g_c, pw_c = measure_pass(a0, r0)
    gq_c = g_c * (sps / (2.0 * jnp.pi))
    dtau = (sps / (2.0 * jnp.pi)) * jnp.arctan2(e_c, gq_c)
    # residuals live on a circle (period sps); a leftover drift error
    # makes the far chunks wrap, and a straight-line fit of wrapped
    # data shrinks the slope (measured: r stalled 11% off while one
    # stream end stayed perfect). Unwrap along chunks first —
    # adjacent-chunk residual steps are << sps/2 by construction.
    dtau = jnp.concatenate(
        [dtau[:1], dtau[:1] + jnp.cumsum(
            _wrap(dtau[1:] - dtau[:-1], float(sps)))])
    w_c = pw_c * jnp.sqrt(e_c * e_c + gq_c * gq_c)
    sw = jnp.sum(w_c) + 1e-12
    mx = jnp.sum(w_c * m_c) / sw
    my = jnp.sum(w_c * dtau) / sw
    varx = jnp.sum(w_c * (m_c - mx) ** 2) / sw + 1e-12
    dr = jnp.sum(w_c * (m_c - mx) * (dtau - my)) / sw / varx
    # bound the refined model to the envelope the padding was sized for
    # (a lives on the symbol circle; the fit can only shift it by the
    # residual, but clamp defensively against a garbage fit)
    a_hat = jnp.clip(a0 - (my - dr * mx), -float(sps), float(sps))
    r_hat = jnp.clip(r0 - dr, -rate_clip, rate_clip)
    return emit_pass(a_hat, r_hat), (a_hat, r_hat)


def rx_chain_pairs(xp: jax.Array, sps: int = 2, excess_bw: float = 0.35,
                   nfilts: int = 32, agc_block: int = 256,
                   carrier_block: int = 64, max_freq: float = 0.2,
                   timing_block_syms: int = 64,
                   timing: str = "track",
                   timing_rate_clip: float = 0.002) -> jax.Array:
    """Device-resident receive chain in pair form: (2, T) samples ->
    (2, nsym) 1-sample/symbol soft BPSK symbols. The complex-free twin
    of ``rx_chain``; feed plane 0
    (the real part) to ``parallel.StreamReceiver.receive``.

    timing="track" (default): the feedback clock tracker
    (``pfb_clock_sync_pairs``) — adapts to a time-varying clock, and
    ``timing_block_syms`` sets its sequential-scan block. 64 through
    8192-symbol blocks lock under +-50 ppm drift + 0.01 carrier offset
    (pinned by tests; the round-5 quadrature discriminant extended the
    per-block capture to the full symbol, which is what 8192 needs —
    16384 still loses lock). ``timing_rate_clip`` bounds the tracked
    drift in samples/sample; the 0.002 default covers +-500 ppm at
    sps=2, and tightening it to the actual clock spec shrinks the
    tracker's per-symbol shift window proportionally.

    timing="ff": the round-5 FEED-FORWARD recovery
    (``pfb_clock_sync_ff_pairs``) — fits the linear clock model
    (offset, drift) with parallel estimation passes and a
    precomputed-parameter scan instead of a feedback loop. "track"
    remains the default; "ff" is the structurally parallel
    alternative for the one-stable-clock regime and is pinned by the
    same lock tests.
    """
    if timing not in ("track", "ff"):
        raise ValueError(f"unknown timing {timing!r}; use 'track' or 'ff'")
    xp = block_agc_pairs(xp, block=agc_block)
    f = coarse_cfo_estimate_pairs(xp, max_freq=max_freq)
    xp = mix_pairs(xp, f)
    if timing == "ff":
        yp, _model = pfb_clock_sync_ff_pairs(xp, sps=sps, nfilts=nfilts,
                                             excess_bw=excess_bw,
                                             rate_clip=timing_rate_clip)
    else:
        yp, _state = pfb_clock_sync_pairs(xp, sps=sps, nfilts=nfilts,
                                          excess_bw=excess_bw,
                                          block_syms=timing_block_syms,
                                          rate_clip=timing_rate_clip)
    return vv_carrier_recovery_pairs(yp, block=carrier_block)
