"""Batched JAX decoders vs the float64 sequential oracle.

The acceptance criterion is *bit-exact hard decisions* at the same iteration
count (BASELINE.md): for every random frame, the jnp decoder's vhat must equal
the oracle's vhat. The oracle replicates the C++ loop order exactly
(ops/oracle.py), so agreement here transfers to agreement with the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gr_ldpc_ece535a_tpu.codes import get_code
from gr_ldpc_ece535a_tpu.ops import (
    awgn,
    bpsk_map,
    decode_bitflip,
    decode_hard,
    decode_minsum,
    decode_sumproduct,
    encode_bits,
    make_decoder,
    syndrome_weight,
)
from gr_ldpc_ece535a_tpu.ops import oracle

CODES = ["block_32_64", "sim_8_16", "sim_50_100", "sim_24_48"]


def _random_rx(code, batch, seed, ebn0_db=3.0):
    """Encode random data and pass through AWGN; returns (rx, u) numpy f64."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2, size=(batch, code.K), dtype=np.int8)
    c = ((d @ code.P.T.astype(np.int64)) % 2).astype(np.int8)
    u = np.concatenate([c, d], axis=1)
    tx = 2.0 * u - 1.0
    n0 = 10 ** (-ebn0_db / 10)
    rx = tx + np.sqrt(n0) * rng.standard_normal(tx.shape)
    return rx, u


@pytest.mark.parametrize("name", CODES)
def test_minsum_matches_oracle(name):
    code = get_code(name)
    rx, _ = _random_rx(code, 64, seed=0, ebn0_db=2.0)
    got = np.asarray(decode_minsum(jnp.asarray(rx), code, iterations=5, dtype=jnp.float64))
    for b in range(rx.shape[0]):
        want = oracle.decode_log_domain_simple(rx[b], code.H, 5)
        assert np.array_equal(got[b], want), f"frame {b} mismatch"


@pytest.mark.parametrize("name", CODES)
def test_sumproduct_matches_oracle(name):
    code = get_code(name)
    rx, _ = _random_rx(code, 64, seed=1, ebn0_db=2.0)
    got = np.asarray(decode_sumproduct(jnp.asarray(rx), code, iterations=5, dtype=jnp.float64))
    for b in range(rx.shape[0]):
        want = oracle.decode_sum_product_soft(rx[b], code.H, 5)
        assert np.array_equal(got[b], want), f"frame {b} mismatch"


@pytest.mark.parametrize("name", CODES)
def test_bitflip_matches_oracle(name):
    code = get_code(name)
    rx, _ = _random_rx(code, 64, seed=2, ebn0_db=0.0)
    got = np.asarray(decode_bitflip(jnp.asarray(rx), code, iterations=5))
    for b in range(rx.shape[0]):
        want = oracle.decode_bit_flipping(rx[b], code.H, 5)
        assert np.array_equal(got[b], want), f"frame {b} mismatch"


def test_hard_matches_oracle():
    code = get_code("block_32_64")
    rx, _ = _random_rx(code, 32, seed=3, ebn0_db=-2.0)
    got = np.asarray(decode_hard(jnp.asarray(rx)))
    for b in range(rx.shape[0]):
        assert np.array_equal(got[b], oracle.decode_hard(rx[b]))


def test_noiseless_roundtrip_all_methods():
    """At zero noise every iterative decoder returns the codeword exactly."""
    code = get_code("block_32_64")
    rng = np.random.default_rng(9)
    d = rng.integers(0, 2, size=(128, code.K), dtype=np.int8)
    u = np.asarray(encode_bits(jnp.asarray(d), code))
    tx = jnp.asarray(2.0 * u - 1.0)
    for method in range(4):
        dec = make_decoder(code, method=method, iterations=5)
        vhat = np.asarray(dec(tx))
        assert np.array_equal(vhat, u), f"method {method}"
        # data bits live in the second half of the codeword
        assert np.array_equal(vhat[:, code.M :], d)


def test_early_exit_equals_reference_semantics():
    """early_exit=True must give identical vhat to the oracle even when some
    frames converge at different iterations (the batched freeze must not leak
    between frames)."""
    code = get_code("block_32_64")
    rx, _ = _random_rx(code, 256, seed=4, ebn0_db=4.0)
    got = np.asarray(decode_minsum(jnp.asarray(rx), code, iterations=5, dtype=jnp.float64))
    mism = 0
    for b in range(rx.shape[0]):
        want = oracle.decode_log_domain_simple(rx[b], code.H, 5)
        mism += int(not np.array_equal(got[b], want))
    assert mism == 0


def test_f32_vs_f64_hard_decision_agreement():
    """The f32 device path must agree with f64 on hard decisions at operating SNR."""
    code = get_code("block_32_64")
    rx, _ = _random_rx(code, 2048, seed=5, ebn0_db=3.0)
    for fn in (decode_minsum, decode_sumproduct):
        v32 = np.asarray(fn(jnp.asarray(rx, jnp.float32), code, iterations=5, dtype=jnp.float32))
        v64 = np.asarray(fn(jnp.asarray(rx), code, iterations=5, dtype=jnp.float64))
        frames_diff = int((v32 != v64).any(axis=1).sum())
        assert frames_diff == 0, f"{fn.__name__}: {frames_diff}/2048 frames differ"


def test_syndrome_weight():
    code = get_code("block_32_64")
    rng = np.random.default_rng(6)
    d = rng.integers(0, 2, size=(16, code.K), dtype=np.int8)
    u = np.asarray(encode_bits(jnp.asarray(d), code))
    w = np.asarray(syndrome_weight(jnp.asarray(u), code.H))
    assert (w == 0).all()
    # flipping one bit makes the syndrome nonzero (weight = column weight)
    u2 = u.copy()
    u2[:, 0] ^= 1
    w2 = np.asarray(syndrome_weight(jnp.asarray(u2), code.H))
    assert (w2 == code.H[:, 0].sum()).all()


def test_fixed_iteration_variant_runs():
    code = get_code("block_32_64")
    rx, _ = _random_rx(code, 32, seed=7)
    for fn in (decode_minsum, decode_sumproduct, decode_bitflip):
        v = fn(jnp.asarray(rx, jnp.float32), code, iterations=20, early_exit=False)
        assert v.shape == rx.shape


def test_offset_minsum_improves_ber():
    """The normalized min-sum extension must beat plain min-sum's BER at a
    mid-waterfall operating point (scale 0.8 was the empirical sweet spot
    for this short weight-3 code; large offsets HURT it), and the defaults
    must reproduce the reference arithmetic bit-for-bit."""
    import jax

    from gr_ldpc_ece535a_tpu.ops import awgn, bpsk_map, encode_bits
    from gr_ldpc_ece535a_tpu.ops.decode import decode_minsum

    code = get_code("block_32_64")
    kd, kn = jax.random.split(jax.random.PRNGKey(21))
    d = jax.random.bernoulli(kd, 0.5, (8192, code.K)).astype(jnp.int8)
    u = encode_bits(d, code)
    rx = awgn(kn, bpsk_map(u), ebn0_db=3.0)
    base = decode_minsum(rx, code, iterations=8)
    off = decode_minsum(rx, code, iterations=8, norm_scale=0.8)
    un = np.asarray(u)
    ber_base = (np.asarray(base) != un).mean()
    ber_off = (np.asarray(off) != un).mean()
    assert ber_off < ber_base * 0.9, (ber_base, ber_off)
    # defaults unchanged
    again = decode_minsum(rx, code, iterations=8, norm_offset=0.0,
                          norm_scale=1.0)
    assert np.array_equal(np.asarray(base), np.asarray(again))


def test_offset_minsum_pallas_matches_xla():
    from gr_ldpc_ece535a_tpu.ops.pallas_bp import pallas_decode_minsum

    code = get_code("block_32_64")
    rx = np.random.default_rng(9).standard_normal((300, 64)).astype(np.float32)
    vp = np.asarray(pallas_decode_minsum(
        jnp.asarray(rx), code, iterations=5, interpret=True,
        norm_offset=0.25, norm_scale=0.9))
    vj = np.asarray(decode_minsum(
        jnp.asarray(rx), code, iterations=5, early_exit=False,
        norm_offset=0.25, norm_scale=0.9))
    assert np.array_equal(vp, vj)


def test_bitflip_mp_matches_oracle():
    """The umfpack-variant message-passing bit-flip (the reference ships
    a DIFFERENT decodeBitFlipping in ldpc_umfpack.cpp than in the GR
    module / ldpc_lapack — see decode_bitflip_mp's docstring) must match
    its Python loop oracle bit for bit, including the rx == 0 -> ci = 0
    sign quirk."""
    import jax.numpy as jnp

    from gr_ldpc_ece535a_tpu.codes import get_code
    from gr_ldpc_ece535a_tpu.ops import decode_bitflip_mp
    from gr_ldpc_ece535a_tpu.ops.oracle import decode_bit_flipping_mp

    for code_name in ("sim_8_16", "block_32_64"):
        code = get_code(code_name)
        rng = np.random.default_rng(5)
        rx = rng.normal(0.0, 1.0, (64, code.N))
        rx[0, :3] = 0.0                      # exercise the sign(0) quirk
        got = np.asarray(decode_bitflip_mp(jnp.asarray(rx, jnp.float32),
                                           code, iterations=5))
        for b in range(rx.shape[0]):
            want = decode_bit_flipping_mp(rx[b], code.H, iterations=5)
            assert (got[b] == want).all(), (code_name, b)


def test_bitflip_mp_actually_corrects():
    """Unlike the majority flip (which can never fire on column-weight-3
    codes), the message-passing variant must fix a nonzero fraction of
    noisy frames on the (16,8) code — the property that exposed the two
    reference variants in the round-5 binary anchor."""
    import jax
    import jax.numpy as jnp

    from gr_ldpc_ece535a_tpu.codes import get_code
    from gr_ldpc_ece535a_tpu.ops import (awgn, bpsk_map, decode_bitflip,
                                         decode_bitflip_mp, encode_bits,
                                         syndrome_weight)

    code = get_code("sim_8_16")
    kd, kn = jax.random.split(jax.random.PRNGKey(0))
    d = jax.random.bernoulli(kd, 0.5, (4096, code.K)).astype(jnp.int8)
    rx = awgn(kn, bpsk_map(encode_bits(d, code)), ebn0_db=2.0)
    fail_mp = int((np.asarray(syndrome_weight(
        decode_bitflip_mp(rx, code, iterations=5), code.H)) > 0).sum())
    fail_maj = int((np.asarray(syndrome_weight(
        decode_bitflip(rx, code, iterations=5), code.H)) > 0).sum())
    assert fail_mp < fail_maj * 0.9, (fail_mp, fail_maj)


@pytest.mark.parametrize("name", ["block_32_64", "sim_50_100", "sim_5_10"])
def test_layout_gathers_match_one_hot_permutes(name):
    """The static-index gathers move every edge message exactly where the
    dense one-hot permutation matrices would (pads read 0)."""
    from gr_ldpc_ece535a_tpu.ops import decode as D
    from gr_ldpc_ece535a_tpu.ops.layout import edge_layout

    code = get_code(name)
    lay = edge_layout(code)
    M, N, Wr, Wc = lay.M, lay.N, lay.Wr, lay.Wc
    T_vm = np.zeros((M * Wr, N * Wc))
    T_cm = np.zeros((N * Wc, M * Wr))
    B_cm = np.zeros((N, M * Wr))
    B_vm = np.zeros((M, N * Wc))
    for j in range(N):
        for v in range(Wc):
            if lay.var_mask[j, v]:
                T_vm[lay.vm_from_cm[j, v], j * Wc + v] = 1
                B_vm[lay.var_nbrs[j, v], j * Wc + v] = 1
    for m in range(M):
        for w in range(Wr):
            if lay.chk_mask[m, w]:
                T_cm[lay.cm_from_vm[m, w], m * Wr + w] = 1
                B_cm[lay.chk_nbrs[m, w], m * Wr + w] = 1
    rng = np.random.default_rng(0)
    B = 5
    x_cm = rng.standard_normal((B, M, Wr)) * lay.chk_mask
    x_vm = rng.standard_normal((B, N, Wc)) * lay.var_mask
    x_var = rng.standard_normal((B, N))
    x_chk = rng.standard_normal((B, M))
    for got, want in (
            (D._gather_vm(jnp.asarray(x_cm), lay), x_cm.reshape(B, -1) @ T_vm),
            (D._gather_cm(jnp.asarray(x_vm), lay), x_vm.reshape(B, -1) @ T_cm),
            (D._bcast_cm(jnp.asarray(x_var), lay), x_var @ B_cm),
            (D._bcast_vm(jnp.asarray(x_chk), lay), x_chk @ B_vm)):
        np.testing.assert_array_equal(np.asarray(got).reshape(B, -1), want)


def test_oracle_sumproduct_saturated_tanh():
    """A saturated tanh (T == +-1 in float64) gives +-inf check messages as
    in C, not a Python ZeroDivisionError, and the oracle still agrees with
    the float64 XLA decoder."""
    from gr_ldpc_ece535a_tpu.ops import bpsk_map, encode_bits

    code = get_code("block_32_64")
    d = np.random.default_rng(0).integers(0, 2, (8, code.K)).astype(np.int8)
    u = np.asarray(encode_bits(jnp.asarray(d), code))
    rx = 40.0 * np.asarray(bpsk_map(jnp.asarray(u)), np.float64)
    rx[:, 0] *= -1
    vo = np.stack([oracle.decode_sum_product_soft(r, code.H, 20) for r in rx])
    vx = np.asarray(decode_sumproduct(jnp.asarray(rx), code, iterations=20,
                                      dtype=jnp.float64))
    np.testing.assert_array_equal(vo, vx)
