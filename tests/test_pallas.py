"""The Triton BP kernel (ops/pallas_bp.py) against the XLA f32 decoders.

The kernel runs here in interpret mode, where its arithmetic is the XLA
decoders' operation for operation: hard decisions must be identical on the
reference code, at any batch size, in both loop forms. Also covered: the
envelope rule and routing (ops.decode.decode_backend), the static wiring,
and lowering to Triton IR for the GPU (no card needed to lower).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gr_ldpc_ece535a_tpu.codes import get_code
from gr_ldpc_ece535a_tpu.codes.ldpc import LdpcCode, make_ldpc
from gr_ldpc_ece535a_tpu.ops import (awgn, bpsk_map, decode_minsum,
                                     decode_sumproduct, encode_bits,
                                     make_decoder)
from gr_ldpc_ece535a_tpu.ops.decode import decode_backend, syndrome_ok
from gr_ldpc_ece535a_tpu.ops.pallas_bp import (
    MAX_EDGES, TILE, _wiring, kernel_supported, pallas_decode_minsum,
    pallas_decode_sumproduct)

KERNELS = {"minsum": (pallas_decode_minsum, decode_minsum),
           "sumproduct": (pallas_decode_sumproduct, decode_sumproduct)}


def _codewords(code, n, seed, ebn0_db=4.0):
    kd, kn = jax.random.split(jax.random.PRNGKey(seed))
    d = jax.random.bernoulli(kd, 0.5, (n, code.K)).astype(jnp.int8)
    return awgn(kn, bpsk_map(encode_bits(d, code)), ebn0_db=ebn0_db)


@pytest.mark.parametrize("iters", [1, 5, 20])
def test_pallas_minsum_matches_jnp_f32(iters):
    code = get_code("block_32_64")
    rx = np.random.default_rng(0).standard_normal((300, 64)).astype(np.float32)
    vp = np.asarray(pallas_decode_minsum(
        jnp.asarray(rx), code, iterations=iters, interpret=True))
    vj = np.asarray(decode_minsum(
        jnp.asarray(rx), code, iterations=iters, early_exit=False, dtype=jnp.float32))
    assert np.array_equal(vp, vj)


@pytest.mark.parametrize("iters", [1, 5, 20])
def test_pallas_sumproduct_matches_jnp_f32(iters):
    code = get_code("block_32_64")
    rx = np.random.default_rng(1).standard_normal((300, 64)).astype(np.float32)
    vp = np.asarray(pallas_decode_sumproduct(
        jnp.asarray(rx), code, iterations=iters, interpret=True))
    vj = np.asarray(decode_sumproduct(
        jnp.asarray(rx), code, iterations=iters, early_exit=False, dtype=jnp.float32))
    assert np.array_equal(vp, vj)


def test_pallas_nonaligned_batch():
    """Batches smaller than a tile and non-multiples of it pad and crop."""
    code = get_code("block_32_64")
    rng = np.random.default_rng(2)
    for B in (1, 100, 257):
        rx = rng.standard_normal((B, 64)).astype(np.float32)
        vp = np.asarray(pallas_decode_minsum(
            jnp.asarray(rx), code, iterations=5, interpret=True))
        vj = np.asarray(decode_minsum(
            jnp.asarray(rx), code, iterations=5, early_exit=False, dtype=jnp.float32))
        assert vp.shape == (B, 64) and vp.dtype == np.int8
        assert np.array_equal(vp, vj), B


@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
def test_pallas_early_exit_exact_under_reference_semantics(kind):
    """Under the reference's early-exit semantics (syndrome checked per
    iteration, converged frames freeze, a tile stops once all its frames
    converged) the kernel reproduces the XLA f32 decisions exactly."""
    code = get_code("block_32_64")
    pall, ref = KERNELS[kind]
    rx = _codewords(code, 1024, seed=7)
    vp = np.asarray(pall(rx, code, iterations=20, interpret=True,
                         early_exit=True))
    vj = np.asarray(ref(rx, code, iterations=20, early_exit=True,
                        dtype=jnp.float32))
    assert np.array_equal(vp, vj)


def test_pallas_fixed_iteration_wander_is_post_convergence():
    """With early_exit=False a converged frame keeps iterating; any
    disagreement with the XLA path must be post-convergence wander (both
    outputs valid codewords). In interpret mode there is none at all."""
    code = get_code("block_32_64")
    rx = _codewords(code, 2048, seed=11)
    vp = np.asarray(pallas_decode_sumproduct(
        rx, code, iterations=20, interpret=True, early_exit=False))
    vj = np.asarray(decode_sumproduct(rx, code, iterations=20,
                                      early_exit=False, dtype=jnp.float32))
    bad = (vp != vj).any(axis=1)
    assert bad.mean() < 0.01
    if bad.any():
        ok_p = np.asarray(syndrome_ok(jnp.asarray(vp[bad]), code.H))
        ok_j = np.asarray(syndrome_ok(jnp.asarray(vj[bad]), code.H))
        assert ok_p.all() and ok_j.all(), \
            "a fixed-iteration disagreement was not post-convergence wander"


def test_pallas_zero_input_sign_convention():
    """rx rows containing exact zeros exercise sign(0)=0 handling."""
    code = get_code("block_32_64")
    rx = np.zeros((8, 64), dtype=np.float32)
    rx[4:, :32] = 1.0
    for kind, (pall, ref) in KERNELS.items():
        vp = np.asarray(pall(jnp.asarray(rx), code, iterations=5,
                             interpret=True))
        vj = np.asarray(ref(jnp.asarray(rx), code, iterations=5,
                            early_exit=False, dtype=jnp.float32))
        assert np.array_equal(vp, vj), kind


@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
@pytest.mark.parametrize("iters", [1, 2, 5, 20])
def test_pallas_early_exit_matches_xla_freezing(kind, iters):
    """early_exit=True reproduces ops/decode.py's batched freezing: converged
    frames keep the decision of their converging iteration; the SPA checks
    every iteration, min-sum guards the last."""
    code = get_code("block_32_64")
    pall, ref = KERNELS[kind]
    rx = _codewords(code, 300, seed=11)
    ve = np.asarray(pall(rx, code, iterations=iters, interpret=True,
                         early_exit=True))
    vj = np.asarray(ref(rx, code, iterations=iters, early_exit=True))
    assert np.array_equal(ve, vj), (kind, iters)


@pytest.mark.parametrize("code_name", ["sim_50_100", "sim_24_48", "sim_8_16"])
def test_pallas_other_codes(code_name):
    """The kernel is generic over H: irregular row and column weights, M not
    a power of two, and the reference simulators' small codes agree with
    the XLA path (up to summation-order ulps on marginal frames)."""
    code = get_code(code_name)
    rx = _codewords(code, 256, seed=13)
    for early in (False, True):
        for pall, ref in KERNELS.values():
            vf = np.asarray(pall(rx, code, iterations=5, interpret=True,
                                 early_exit=early))
            vj = np.asarray(ref(rx, code, iterations=5, early_exit=early))
            agree = (vf == vj).all(axis=1).mean()
            assert agree >= 0.98, (code_name, pall.__name__, early, agree)


@pytest.mark.parametrize("early", [False, True])
def test_pallas_zero_iterations_and_empty_batch(early):
    """iterations=0 returns all-zero decisions and an empty batch an empty
    result, as the XLA decoders do."""
    code = get_code("block_32_64")
    rx = jnp.ones((5, 64), jnp.float32)
    for pall, ref in KERNELS.values():
        v0 = np.asarray(pall(rx, code, iterations=0, early_exit=early,
                             interpret=True))
        assert np.array_equal(v0, np.asarray(ref(rx, code, iterations=0,
                                                 early_exit=early)))
        ve = pall(jnp.zeros((0, 64), jnp.float32), code, iterations=5,
                  early_exit=early, interpret=True)
        assert ve.shape == (0, 64)


def test_pallas_padding_frames_do_not_change_results():
    """Padding frames (zeros) are marked converged up front; a frame's
    decision does not depend on which tile or batch it is decoded in."""
    code = get_code("block_32_64")
    rx = _codewords(code, TILE + 7, seed=17, ebn0_db=2.0)
    whole = np.asarray(pallas_decode_sumproduct(
        rx, code, iterations=10, early_exit=True, interpret=True))
    part = np.asarray(pallas_decode_sumproduct(
        rx[TILE:], code, iterations=10, early_exit=True, interpret=True))
    assert np.array_equal(whole[TILE:], part)


@pytest.mark.parametrize("code_name", ["block_32_64", "sim_50_100", "sim_5_10"])
def test_pallas_wiring_matches_h(code_name):
    """The static wiring lists every edge of H once, in the layouts' slot
    orders (checks by ascending variable, variables by ascending check)."""
    code = get_code(code_name)
    checks, edge_var, variables = _wiring(code)
    assert len(edge_var) == code.n_edges
    for m, edges in enumerate(checks):
        assert [edge_var[e] for e in edges] == list(np.flatnonzero(code.H[m]))
    seen = sorted(e for edges in variables for e in edges)
    assert seen == list(range(code.n_edges))
    for j, edges in enumerate(variables):
        assert all(edge_var[e] == j for e in edges)
        chk = [next(m for m, es in enumerate(checks) if e in es) for e in edges]
        assert chk == list(np.flatnonzero(code.H[:, j]))


class _Dev:
    def __init__(self, platform):
        self.platform = platform


class _Mesh:
    def __init__(self, *platforms):
        self.devices = np.asarray([_Dev(p) for p in platforms], dtype=object)


BIG = LdpcCode.from_h(make_ldpc(128, 256, col_weight=3, seed=1),
                      name="gen_128_256")


@pytest.mark.parametrize("platform,method,code,dtype,want", [
    ("gpu", "minsum", "block_32_64", jnp.float32, "triton"),
    ("gpu", 1, "block_32_64", jnp.float32, "triton"),
    ("gpu", "bitflip", "block_32_64", jnp.float32, "xla"),
    ("gpu", "hard", "block_32_64", jnp.float32, "xla"),
    ("gpu", "minsum", "big", jnp.float32, "xla"),
    ("gpu", "sumproduct", "block_32_64", jnp.float64, "xla"),
    ("cpu", "minsum", "block_32_64", jnp.float32, "xla"),
    ("cpu", "sumproduct", "big", jnp.float32, "xla"),
])
def test_decode_backend_routes(platform, method, code, dtype, want):
    code = BIG if code == "big" else get_code(code)
    assert decode_backend(code, method, _Mesh(platform), dtype) == want


@pytest.mark.parametrize("platforms", [("metal",), ("gpu", "cpu")])
def test_decode_backend_rejects_other_platforms(platforms):
    with pytest.raises(ValueError, match="platform"):
        decode_backend(get_code("block_32_64"), 0, _Mesh(*platforms))


def test_kernel_envelope_rule():
    """One rule on code size: the edge count against MAX_EDGES."""
    assert kernel_supported(get_code("block_32_64"))   # 168 edges
    assert get_code("sim_50_100").n_edges > MAX_EDGES
    assert not kernel_supported(get_code("sim_50_100"))
    assert not kernel_supported(BIG)                    # 768 edges
    # the default device here is the CPU: every route is XLA
    dec = make_decoder(BIG, method=0, iterations=2)
    assert np.asarray(dec(jnp.zeros((4, BIG.N), jnp.float32))).shape == (4, BIG.N)
    with pytest.raises(ValueError, match="backend"):
        make_decoder(get_code("block_32_64"), 0, 5, backend="pallas")


@pytest.mark.parametrize("kind", ["minsum", "sumproduct"])
@pytest.mark.parametrize("early", [False, True])
def test_pallas_lowers_to_triton_for_gpu(kind, early):
    """The kernel lowers for CUDA through the Triton route (lowering needs
    no card; compiling the Triton IR happens on the GPU)."""
    code = get_code("block_32_64")
    pall, _ = KERNELS[kind]
    lowered = jax.jit(lambda r: pall(r, code, iterations=20,
                                     early_exit=early)).trace(
        jax.ShapeDtypeStruct((1000, code.N), jnp.float32)).lower(
        lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert f"bp_{kind}" in text
