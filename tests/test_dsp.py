"""Receiver-chain DSP tests: RRC, AGC, Costas, timing, and the full chain.

The full-chain test is the example4.grc-equivalent integration case: LDPC
encode -> 2 sps RRC pulse shaping -> channel (noise + phase rotation +
carrier offset) -> AGC -> Costas -> matched-filter symbol sync -> LDPC
decode with the sync state machine -> original bytes.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gr_ldpc_ece535a_tpu.blocks import (
    AgcBlock2,
    ChannelModelBlock,
    CostasLoopBlock,
    FlowGraph,
    FreqRecoveryBlock,
    PfbClockSyncBlock,
    LdpcDecoderBlock,
    LdpcEncoderBlock,
    PulseShapeBlock,
    SymbolSyncBlock,
    VectorSink,
    VectorSource,
)
from gr_ldpc_ece535a_tpu.ops import dsp


def test_rrc_taps_properties():
    taps = dsp.rrc_taps(sps=2, excess_bw=0.35, ntaps=45)
    assert taps.shape == (45,)
    assert np.argmax(taps) == 22  # symmetric, peak at center
    np.testing.assert_allclose(taps, taps[::-1], atol=1e-6)
    np.testing.assert_allclose(np.sum(taps**2), 1.0, atol=1e-5)
    # matched pair at sps=2 is ~ISI-free: raised-cosine at symbol spacing
    rc = np.convolve(taps, taps)
    center = len(rc) // 2
    symbol_taps = rc[center % 2 :: 2]
    peak = np.argmax(symbol_taps)
    others = np.delete(symbol_taps, peak)
    assert np.abs(others).max() < 0.05 * symbol_taps[peak]


def test_agc_converges():
    x = jnp.asarray(np.full(4000, 0.1 + 0.0j, np.complex64) * 5.0)
    y, gain = dsp.agc(x, rate=1e-2, reference=1.0)
    assert abs(float(jnp.abs(y[-1])) - 1.0) < 0.05
    assert float(gain) == pytest.approx(2.0, rel=0.1)


def test_costas_locks_phase_and_freq():
    rng = np.random.default_rng(0)
    sym = np.sign(rng.standard_normal(6000)).astype(np.complex64)
    f0, p0 = 1e-3, 0.7
    t = np.arange(len(sym))
    rx = sym * np.exp(1j * (2 * np.pi * f0 * t + p0)).astype(np.complex64)
    y, (phase, freq) = dsp.costas_loop(jnp.asarray(rx), loop_bw=0.06)
    tail = np.asarray(y[-2000:])
    # after lock, symbols are real up to a sign ambiguity
    assert np.abs(tail.imag).mean() < 0.1
    assert np.abs(np.abs(tail.real) - 1.0).mean() < 0.1
    # loop integrator must have found the carrier (freq in rad/sample)
    assert float(freq) == pytest.approx(2 * np.pi * f0, rel=0.15)


def test_symbol_sync_picks_energy_phase():
    rng = np.random.default_rng(1)
    sym = np.sign(rng.standard_normal(400)).astype(np.complex64)
    taps = dsp.rrc_taps(2, 0.35, 45)
    shaped = np.asarray(dsp.pulse_shape(jnp.asarray(sym), 2, taps))
    out, phase = dsp.symbol_sync(jnp.asarray(shaped), 2, taps)
    out = np.asarray(out)
    # 'same'-mode filters are zero-delay, so recovered symbols align 1:1
    # (edges trimmed to avoid filter startup transients)
    assert int(phase) == 0
    match = np.mean(np.sign(out.real[50:-50]) == np.sign(sym[50:-50].real))
    assert match == 1.0


def test_full_example4_chain_streaming():
    msg = (b"Full receiver chain with carrier recovery! " * 24)[:1024]
    fg = FlowGraph()
    src = VectorSource(np.frombuffer(msg, np.uint8), chunk=300)
    enc = LdpcEncoderBlock()
    tx = PulseShapeBlock(sps=2)
    chan = ChannelModelBlock(noise_voltage=0.05, freq_offset=5e-4,
                             phase_offset=2.5, seed=4)
    agc = AgcBlock2(rate=2e-2)
    costas = CostasLoopBlock(loop_bw=0.08)
    timing = SymbolSyncBlock(sps=2)
    dec = LdpcDecoderBlock(method=0, error_threshold=0, verbose=False)
    snk = VectorSink(np.uint8)
    fg.connect(src, enc, tx, chan, agc, costas, timing, dec, snk)
    fg.run()
    out = bytes(snk.data())
    # the loops need some symbols to lock, so the head of the message may be
    # lost before IN_SYNC; require the tail 3/4 to be recovered contiguously
    assert msg[len(msg) // 4 :] in out
    assert dec.state in (1, 2)  # locked (possibly phase-inverted)


# ---------------------------------------------------------------------------
# round-3 additions: fractional resampling, coarse CFO, PFB clock recovery
# ---------------------------------------------------------------------------

def _tail_symbol_accuracy(y, bits, lag_range=80):
    """Best hard-decision agreement (either BPSK polarity) over the tail
    half of the recovered symbol stream, searched over integer lags."""
    yh = np.sign(np.asarray(y).real)
    b = 2.0 * np.asarray(bits, np.float64) - 1.0
    n2 = len(yh) // 2
    best = 0.0
    for lag in range(-lag_range, lag_range + 1):
        rs = n2 - lag
        if rs < 0:
            continue
        ref = b[rs:rs + len(yh) - n2]
        seg = yh[n2:n2 + len(ref)]
        if len(seg) < 100:
            continue
        best = max(best, np.mean(seg == ref), np.mean(seg == -ref))
    return best


def _shaped_bpsk(nsym=20000, sps=2, seed=0):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, nsym)
    syms = (2.0 * bits - 1.0).astype(np.complex64)
    taps = dsp.rrc_taps(sps, 0.35, 45)
    return bits, np.asarray(dsp.pulse_shape(jnp.asarray(syms), sps, taps))


def test_fractional_resample_frequency_scaling():
    """y[k] = x(k*ratio): a tone at f must come out at f*ratio (this pins
    the polyphase bank's delay DIRECTION — the reversed convention shows a
    sawtooth phase error and fails this by orders of magnitude)."""
    f = 0.11
    x = np.exp(2j * np.pi * f * np.arange(3000)).astype(np.complex64)
    for ratio in (1 + 50e-6, 1 - 50e-6, 1.01):
        y = np.asarray(dsp.fractional_resample(jnp.asarray(x), ratio))
        ph = np.unwrap(np.angle(y[50:-50]))
        slope = np.polyfit(np.arange(len(ph)), ph, 1)[0] / (2 * np.pi)
        assert abs(slope - f * ratio) < 1e-6, ratio


def test_fractional_resample_half_sample_delay():
    f = 0.09
    x = np.exp(2j * np.pi * f * np.arange(2000)).astype(np.complex64)
    y = np.asarray(dsp.fractional_resample(jnp.asarray(x), 1.0, t0=0.5))
    c = 4  # (ntaps_per//2) group delay of the default 8-tap bank
    ideal = np.exp(2j * np.pi * f * (0.5 + np.arange(len(y)) + c))
    assert np.abs(y[50:-50] - ideal[50:-50]).max() < 0.02


@pytest.mark.parametrize("f0", [0.001, 0.01, 0.05, -0.02])
def test_coarse_cfo_estimate(f0):
    """The fll_band_edge-role coarse acquisition must localize carrier
    offsets far beyond the Costas pull-in range (example4.grc chain,
    SURVEY.md section 3.4)."""
    _, tx = _shaped_bpsk(nsym=30000)
    rng = np.random.default_rng(1)
    rx = np.asarray(dsp.mix(jnp.asarray(tx), -f0))  # inject +f0
    rx = rx + (rng.standard_normal(len(rx)) * 0.1).astype(np.complex64)
    fe = float(dsp.coarse_cfo_estimate(jnp.asarray(rx)))
    assert abs(fe - f0) < 1e-4


@pytest.mark.parametrize("name,ratio,skip,noise", [
    ("clean", 1.0, 0, 0.0),
    ("+50ppm", 1 + 50e-6, 0, 0.05),
    ("-50ppm", 1 - 50e-6, 3, 0.05),
    ("+200ppm", 1 + 200e-6, 1, 0.05),
])
def test_pfb_clock_sync_tracks_drift(name, ratio, skip, noise):
    """Fractional timing recovery: a +-50/200 ppm sample-clock drift plus
    an arbitrary initial offset must be acquired and tracked with ~zero
    tail symbol errors (the pfb_clock_sync role the round-2 VERDICT flagged
    as missing — the integer-phase symbol_sync breaks under any drift)."""
    bits, tx = _shaped_bpsk()
    rng = np.random.default_rng(2)
    rx = np.asarray(dsp.fractional_resample(jnp.asarray(tx), ratio))[skip:]
    rx = rx + (rng.standard_normal(len(rx)) * noise).astype(np.complex64)
    y, _state = dsp.pfb_clock_sync(jnp.asarray(rx), sps=2)
    assert _tail_symbol_accuracy(y, bits) >= 0.9995, name


def test_pfb_plus_vv_carrier_survives_cfo_and_drift():
    """Composed coarse-CFO -> timing -> feedforward carrier recovery at
    freq_offset 0.01 (20x the old example4_full operating point) AND
    +50 ppm clock drift."""
    bits, tx = _shaped_bpsk()
    rng = np.random.default_rng(3)
    rx = np.asarray(dsp.fractional_resample(jnp.asarray(tx), 1 + 50e-6))
    rx = np.asarray(dsp.mix(jnp.asarray(rx), -0.01))
    rx = rx + (rng.standard_normal(len(rx)) * 0.05).astype(np.complex64)
    rxj = jnp.asarray(rx)
    fe = dsp.coarse_cfo_estimate(rxj)
    y, _ = dsp.pfb_clock_sync(dsp.mix(rxj, fe), sps=2)
    y = dsp.vv_carrier_recovery(y)
    assert _tail_symbol_accuracy(y, bits) >= 0.9995


def test_block_agc_normalizes():
    _, tx = _shaped_bpsk(nsym=3000)
    y = np.asarray(dsp.block_agc(jnp.asarray(3.7 * tx)))
    assert abs(np.sqrt(np.mean(np.abs(y) ** 2)) - 1.0) < 0.05


def test_full_chain_blocks_with_cfo_and_clock_drift():
    """example4_full.yaml regime at stream-block level: freq_offset 0.01 +
    50 ppm sample-clock drift + noise through enc -> pulse_shape -> channel
    -> AGC -> fll_band_edge -> pfb_clock_sync -> costas -> decoder. The
    round-2 chain (integer-phase symbol_sync, Costas-only carrier) cannot
    survive either impairment."""
    msg = (b"Round-3 chain: coarse CFO + fractional timing recovery! " * 64)
    fg = FlowGraph()
    src = VectorSource(np.frombuffer(msg, np.uint8), chunk=512)
    enc = LdpcEncoderBlock()
    tx = PulseShapeBlock(sps=2)
    chan = ChannelModelBlock(noise_voltage=0.05, freq_offset=0.01,
                             phase_offset=2.5, epsilon=1 + 50e-6, seed=4)
    agc = AgcBlock2(rate=2e-2)
    fll = FreqRecoveryBlock(lock_samples=8192)
    timing = PfbClockSyncBlock(sps=2, segment=8192)
    costas = CostasLoopBlock(loop_bw=0.08)
    dec = LdpcDecoderBlock(method=0, error_threshold=0, verbose=False)
    snk = VectorSink(np.uint8)
    fg.connect(src, enc, tx, chan, agc, fll, timing, costas, dec, snk)
    fg.run()
    out = bytes(snk.data())
    # acquisition consumes the head; require a long contiguous tail
    assert msg[len(msg) // 2:] in out
    assert dec.state in (1, 2)  # locked (possibly phase-inverted)


def test_rx_chain_to_stream_receiver_end_to_end():
    """Device-resident chain -> mesh receiver: encoded payload through
    pulse shaping, 50 ppm clock drift, 0.01 carrier offset and noise, then
    ops.dsp.rx_chain (AGC/CFO/timing/carrier) feeding
    parallel.StreamReceiver (frame sync + sharded decode). The recovered
    byte stream must contain the transmitted payload contiguously."""
    from gr_ldpc_ece535a_tpu.codes import get_code
    from gr_ldpc_ece535a_tpu.ops import encode_to_symbols
    from gr_ldpc_ece535a_tpu.parallel import StreamReceiver

    code = get_code("block_32_64")
    msg = (b"rx_chain + StreamReceiver: the device-resident example4! " * 40)
    data = np.frombuffer(msg, np.uint8).reshape(-1, code.K // 8)
    tx_syms = np.asarray(encode_to_symbols(jnp.asarray(data), code)
                         ).reshape(-1)
    taps = dsp.rrc_taps(2, 0.35, 45)
    shaped = np.asarray(dsp.pulse_shape(jnp.asarray(tx_syms), 2, taps))
    rng = np.random.default_rng(9)
    rx = np.asarray(dsp.fractional_resample(jnp.asarray(shaped), 1 + 50e-6))
    rx = np.asarray(dsp.mix(jnp.asarray(rx), -0.01))
    rx = 2.5 * (rx + (rng.standard_normal(len(rx)) * 0.05
                      ).astype(np.complex64))

    syms = dsp.rx_chain(jnp.asarray(rx), sps=2)
    recv = StreamReceiver(code=code, iterations=8)
    out = recv.receive(syms)
    assert out.acquisition is not None, "receiver never locked"
    # acquisition consumes the chain-settle head; the tail must be intact
    assert msg[len(msg) // 2:] in out.data


# ---------------------------------------------------------------------------
# pair-form (complex-free) chain: (2, T) f32 planes, no complex dtype
# ---------------------------------------------------------------------------


def test_pairs_roundtrip_and_stagewise_equivalence():
    """Each *_pairs stage must match its complex counterpart (same math on
    (2, T) f32 planes; floating-point reassociation only)."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)
         ).astype(np.complex64)
    xj = jnp.asarray(x)
    xp = dsp.to_pairs(xj)
    np.testing.assert_array_equal(np.asarray(dsp.from_pairs(xp)), x)
    # mix
    a = np.asarray(dsp.mix(xj, 0.013, phase0=0.7))
    b = np.asarray(dsp.from_pairs(dsp.mix_pairs(xp, 0.013, phase0=0.7)))
    np.testing.assert_allclose(a, b, atol=2e-5)
    # block AGC
    a = np.asarray(dsp.block_agc(3.0 * xj))
    b = np.asarray(dsp.from_pairs(dsp.block_agc_pairs(3.0 * xp)))
    np.testing.assert_allclose(a, b, atol=2e-5)
    # V&V carrier recovery
    a = np.asarray(dsp.vv_carrier_recovery(xj, block=64))
    b = np.asarray(dsp.from_pairs(dsp.vv_carrier_recovery_pairs(xp, block=64)))
    np.testing.assert_allclose(a, b, atol=5e-5)


def test_pfb_clock_sync_pairs_matches_complex():
    _, rx = _shaped_bpsk(nsym=2000, seed=3)
    yc, state_c = dsp.pfb_clock_sync(jnp.asarray(rx), sps=2)
    yp, state_p = dsp.pfb_clock_sync_pairs(dsp.to_pairs(jnp.asarray(rx)),
                                           sps=2)
    np.testing.assert_allclose(np.asarray(yc),
                               np.asarray(dsp.from_pairs(yp)), atol=1e-5)
    for a, b in zip(state_c, state_p):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("f0", [-0.11, 0.0137, 0.19])
def test_coarse_cfo_estimate_pairs(f0):
    """The chunk-factorized matmul-DFT estimator (no FFT, no complex dtype)
    must locate an injected carrier offset to ~1e-4 cycles/sample."""
    _, tx = _shaped_bpsk(nsym=6000, seed=7)
    rng = np.random.default_rng(7)
    tx = tx + (rng.standard_normal(len(tx)) * 0.02).astype(np.complex64)
    rx = np.asarray(dsp.mix(jnp.asarray(tx), -f0))  # inject +f0
    f_hat = float(dsp.coarse_cfo_estimate_pairs(
        dsp.to_pairs(jnp.asarray(rx))))
    assert abs(f_hat - f0) < 3e-4, (f_hat, f0)


def test_coarse_cfo_estimate_pairs_short_stream():
    """Streams shorter than the chunk (1024) must not crash: the chunk
    shrinks to fit (round-3 advisor finding), and absurdly short input
    raises a clear ValueError."""
    _, tx = _shaped_bpsk(nsym=200, seed=3)          # 400 samples < chunk
    rx = np.asarray(dsp.mix(jnp.asarray(tx), -0.05))
    f_hat = float(dsp.coarse_cfo_estimate_pairs(
        dsp.to_pairs(jnp.asarray(rx))))
    assert abs(f_hat - 0.05) < 5e-3, f_hat          # coarse but sane
    with pytest.raises(ValueError, match="16 samples"):
        dsp.coarse_cfo_estimate_pairs(jnp.zeros((2, 8), jnp.float32))


def test_rx_chain_pairs_to_stream_receiver_end_to_end():
    """Pair-form device-resident chain -> receiver, same regime as the
    complex test: 0.01 carrier offset, 50 ppm clock drift, noise."""
    from gr_ldpc_ece535a_tpu.codes import get_code
    from gr_ldpc_ece535a_tpu.ops import encode_to_symbols
    from gr_ldpc_ece535a_tpu.parallel import StreamReceiver

    code = get_code("block_32_64")
    msg = (b"rx_chain_pairs: complex-free example4 on the GPU backend! " * 40)
    data = np.frombuffer(msg, np.uint8).reshape(-1, code.K // 8)
    tx_syms = np.asarray(encode_to_symbols(jnp.asarray(data), code)
                         ).reshape(-1)
    taps = dsp.rrc_taps(2, 0.35, 45)
    shaped = np.asarray(dsp.pulse_shape(jnp.asarray(tx_syms), 2, taps))
    rng = np.random.default_rng(9)
    # impairments in pair form end to end (per-plane resample is exact for
    # the real-tap polyphase interpolator)
    rp = jnp.stack([
        dsp.fractional_resample(jnp.asarray(shaped), 1 + 50e-6),
        jnp.zeros_like(dsp.fractional_resample(jnp.asarray(shaped),
                                               1 + 50e-6))])
    rp = dsp.mix_pairs(rp, -0.01)
    noise = rng.standard_normal((2, rp.shape[1])).astype(np.float32) * 0.05
    rp = 2.5 * (rp + jnp.asarray(noise))

    sp = dsp.rx_chain_pairs(rp, sps=2)
    recv = StreamReceiver(code=code, iterations=8)
    out = recv.receive(sp[0])         # real plane feeds the frame sync
    assert out.acquisition is not None, "receiver never locked"
    assert msg[len(msg) // 2:] in out.data


@pytest.mark.parametrize("ratio", [1 + 50e-6, 1 - 50e-6])
@pytest.mark.parametrize("block", [256, 2048, 8192])
def test_rx_chain_pairs_large_timing_block_survives_50ppm(ratio, block):
    """Large timing_block_syms (fewer sequential tracking steps — the
    chain's throughput knob) must still lock under +-50 ppm drift plus
    a 0.01 carrier offset. Since round 4 the tracker interpolates the
    sampling phase per symbol inside each block, so block size no longer
    bounds the tolerable drift; since round 5 the quadrature discriminant
    captures the full symbol period, which is what 8192-symbol blocks
    (the composed-path setting, with the rate clip at the +-62 ppm spec)
    need to acquire from any starting phase."""
    from gr_ldpc_ece535a_tpu.codes import get_code
    from gr_ldpc_ece535a_tpu.ops import encode_to_symbols
    from gr_ldpc_ece535a_tpu.parallel import StreamReceiver

    code = get_code("block_32_64")
    msg = (b"large timing blocks on the scan, still locked at 50ppm! " * 40)
    data = np.frombuffer(msg, np.uint8).reshape(-1, code.K // 8)
    tx_syms = np.asarray(encode_to_symbols(jnp.asarray(data), code)
                         ).reshape(-1)
    taps = dsp.rrc_taps(2, 0.35, 45)
    shaped = np.asarray(dsp.pulse_shape(jnp.asarray(tx_syms), 2, taps))
    res = dsp.fractional_resample(jnp.asarray(shaped), ratio)
    rp = jnp.stack([res, jnp.zeros_like(res)])
    rp = dsp.mix_pairs(rp, -0.01)
    rng = np.random.default_rng(11)
    rp = rp + jnp.asarray(rng.standard_normal((2, rp.shape[1]))
                          .astype(np.float32) * 0.05)
    rc = 2.5e-4 if block >= 8192 else 0.002
    sp = dsp.rx_chain_pairs(rp, sps=2, timing_block_syms=block,
                            timing_rate_clip=rc)
    recv = StreamReceiver(code=code, iterations=8)
    out = recv.receive(sp[0])
    assert out.acquisition is not None, "receiver never locked"
    assert msg[len(msg) // 2:] in out.data


@pytest.mark.parametrize("name,ratio,phase,noise", [
    ("clean", 1.0, 0.0, 0.0),
    ("+50ppm", 1 + 50e-6, 0.0, 0.05),
    ("-50ppm+phase", 1 - 50e-6, 0.7, 0.05),
    ("midsym-phase", 1.0, 1.3, 0.05),
])
def test_pfb_clock_sync_ff_locks(name, ratio, phase, noise):
    """Feed-forward clock recovery (round 5): the parallel two-pass
    (offset, drift) model fit must recover +-50 ppm drift and an
    arbitrary initial phase — including a mid-symbol start, where the
    quadrature (e, g) estimator's full-period capture matters — to the
    same ~zero tail symbol errors as the feedback tracker."""
    bits, tx = _shaped_bpsk(nsym=60000)
    rng = np.random.default_rng(2)
    rx = np.asarray(dsp.fractional_resample(
        jnp.asarray(np.real(tx).astype(np.float32)), ratio, t0=phase))
    rx = rx + (rng.standard_normal(len(rx)) * noise).astype(np.float32)
    xp = jnp.stack([jnp.asarray(rx), jnp.zeros(len(rx), jnp.float32)])
    ys, (a, r) = dsp.pfb_clock_sync_ff_pairs(xp, sps=2)
    assert _tail_symbol_accuracy(np.asarray(ys[0]), bits) >= 0.9995, name


def test_rx_chain_pairs_ff_to_stream_receiver_end_to_end():
    """rx_chain_pairs(timing="ff") through the full example4-grade
    impairments (0.01 carrier offset + 50 ppm drift + noise) recovers the
    payload through the StreamReceiver, same as the tracking chain."""
    from gr_ldpc_ece535a_tpu.codes import get_code
    from gr_ldpc_ece535a_tpu.ops import encode_to_symbols
    from gr_ldpc_ece535a_tpu.parallel import StreamReceiver

    code = get_code("block_32_64")
    msg = (b"feed-forward timing: fit the clock line, no feedback. " * 48)
    data = np.frombuffer(msg, np.uint8).reshape(-1, code.K // 8)
    tx_syms = np.asarray(encode_to_symbols(jnp.asarray(data), code)
                         ).reshape(-1)
    taps = dsp.rrc_taps(2, 0.35, 45)
    shaped = np.asarray(dsp.pulse_shape(jnp.asarray(tx_syms), 2, taps))
    rng = np.random.default_rng(9)
    rs = dsp.fractional_resample(jnp.asarray(shaped), 1 + 50e-6)
    rp = jnp.stack([rs, jnp.zeros_like(rs)])
    rp = dsp.mix_pairs(rp, -0.01)
    noise = rng.standard_normal((2, rp.shape[1])).astype(np.float32) * 0.05
    rp = 2.5 * (rp + jnp.asarray(noise))

    sp = dsp.rx_chain_pairs(rp, sps=2, timing="ff")
    recv = StreamReceiver(code=code, iterations=8)
    out = recv.receive(sp[0])
    assert out.acquisition is not None, "receiver never locked (ff timing)"
    # the ff path truncates the stream to whole chunks, so assert on a
    # mid-stream payload span rather than the tail
    third = len(msg) // 3
    assert msg[third:2 * third] in out.data


@pytest.mark.parametrize("timing", ["track", "ff"])
def test_rx_chain_pairs_matmuls_ask_for_highest_precision(timing):
    """Every matmul on the pair-form chain path states HIGHEST precision, so
    a GPU cannot run it in TF32 (10 mantissa bits)."""
    xp = jax.ShapeDtypeStruct((2, 1 << 16), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda x: dsp.rx_chain_pairs(
        x, sps=2, timing=timing, timing_block_syms=256))(xp)

    def dots(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                yield eqn
            for sub in jax.core.jaxprs_in_params(eqn.params):
                yield from dots(sub)

    found = list(dots(jaxpr.jaxpr))
    assert found
    for eqn in found:
        prec = eqn.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), prec
