"""Batched JAX decoders: the four reference methods over (batch, N) frames.

Each decoder consumes real-valued received symbols ``rx`` of shape (B, N) and
returns hard decisions ``vhat`` (B, N) int8, matching the corresponding C++
routine frame-for-frame (same message schedule, same reduction semantics, same
early-exit placement):

  method 0  decode_minsum      <- decodeLogDomainSimple, lib/ldpc_decoder_cb_impl.cc:309
  method 1  decode_sumproduct  <- decodeSumProductSoft,  lib/ldpc_decoder_cb_impl.cc:478
  method 2  decode_bitflip     <- decodeBitFlipping,     lib/ldpc_decoder_cb_impl.cc:414
  method 3  decode_hard        <- decodeHard,            lib/ldpc_decoder_cb_impl.cc:559

Early exit is batched: a per-frame ``done`` mask freezes converged frames
(equivalent to the reference's ``break`` — later iterations simply don't touch
them), so the whole batch runs a static ``iterations``-step loop under jit.
Set ``early_exit=False`` for the fixed-iteration benchmark variant.

Exclusion reductions ("sum/min/product over neighbors except self") are
computed without divide/subtract tricks — prefix/suffix scans over the tiny
padded neighbor axis — so hard decisions track the float64 oracle exactly;
the only deviations from the sequential C++ are floating-point reassociations
of 2-3 term reductions (validated empirically in tests/test_decoders.py).
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..codes import LdpcCode
from .layout import EdgeLayout, edge_layout

__all__ = [
    "decode_hard",
    "decode_minsum",
    "decode_sumproduct",
    "decode_bitflip",
    "syndrome_weight",
    "syndrome_ok",
    "make_decoder",
    "decode_backend",
    "METHODS",
    "BP_METHODS",
]


def _f(x, dtype):
    return jnp.asarray(x, dtype=dtype)


def syndrome_weight(vhat: jax.Array, H: np.ndarray) -> jax.Array:
    """Number of unsatisfied checks per frame: popcount(H @ vhat mod 2). (B,)"""
    Ht = jnp.asarray(H.T.astype(np.float32))
    s = jnp.dot(vhat.astype(jnp.float32), Ht, preferred_element_type=jnp.float32)
    parity = jnp.mod(s.astype(jnp.int32), 2)
    return jnp.sum(parity, axis=-1)


def syndrome_ok(vhat: jax.Array, H: np.ndarray) -> jax.Array:
    return syndrome_weight(vhat, H) == 0


def decode_hard(rx: jax.Array) -> jax.Array:
    """Slicer: rx < 0 -> 0 else 1 (note >= 0 maps to 1, including exact 0)."""
    return jnp.where(rx < 0, 0, 1).astype(jnp.int8)


# ---------------------------------------------------------------------------
# layout helpers (all index arrays are compile-time constants)
# ---------------------------------------------------------------------------

def _take(x: jax.Array, idx: np.ndarray) -> jax.Array:
    """Static-index gather along axis 1: x (B, n) -> (B, *idx.shape).

    Out-of-range indices (the layouts' pad sentinels) read 0.
    """
    out = jnp.take(x, jnp.asarray(idx.reshape(-1)), axis=1, mode="fill",
                   fill_value=0)
    return out.reshape(x.shape[0], *idx.shape)


def _gather_vm(x_cm: jax.Array, lay: EdgeLayout) -> jax.Array:
    """Check-major edges (B, M, Wr) -> var-major (B, N, Wc)."""
    return _take(x_cm.reshape(x_cm.shape[0], -1), lay.vm_from_cm)


def _gather_cm(x_vm: jax.Array, lay: EdgeLayout) -> jax.Array:
    """Var-major edges (B, N, Wc) -> check-major (B, M, Wr)."""
    return _take(x_vm.reshape(x_vm.shape[0], -1), lay.cm_from_vm)


def _bcast_cm(x_var: jax.Array, lay: EdgeLayout) -> jax.Array:
    """Per-variable values (B, N) -> check-major edges (B, M, Wr)."""
    return _take(x_var, lay.chk_nbrs)


def _bcast_vm(x_chk: jax.Array, lay: EdgeLayout) -> jax.Array:
    """Per-check values (B, M) -> var-major edges (B, N, Wc)."""
    return _take(x_chk, lay.var_nbrs)


def _excl_sum(t: jax.Array) -> jax.Array:
    """Sum over the last axis excluding self, via exclusive prefix+suffix sums."""
    pre = jnp.cumsum(t, axis=-1) - t
    rev = jnp.flip(t, axis=-1)
    suf = jnp.flip(jnp.cumsum(rev, axis=-1) - rev, axis=-1)
    return pre + suf


def _excl_prod(t: jax.Array) -> jax.Array:
    """Product over the last axis excluding self (pads must be 1).

    Shift-based exclusive prefix/suffix scans — no division, so zeros are safe.
    """
    ones = jnp.ones_like(t[..., :1])
    pre = jnp.cumprod(jnp.concatenate([ones, t[..., :-1]], axis=-1), axis=-1)
    rev = jnp.flip(t, axis=-1)
    suf_rev = jnp.cumprod(jnp.concatenate([ones, rev[..., :-1]], axis=-1), axis=-1)
    suf = jnp.flip(suf_rev, axis=-1)
    return pre * suf


def _sign(x: jax.Array) -> jax.Array:
    """(x > 0) - (x < 0), matching the C++ sign (sign(0) = 0)."""
    return (x > 0).astype(x.dtype) - (x < 0).astype(x.dtype)


# ---------------------------------------------------------------------------
# min-sum (decodeLogDomainSimple)
# ---------------------------------------------------------------------------

def decode_minsum(
    rx: jax.Array,
    code: LdpcCode,
    iterations: int = 5,
    early_exit: bool = True,
    dtype=jnp.float32,
    norm_offset: float = 0.0,
    norm_scale: float = 1.0,
) -> jax.Array:
    """Min-sum (reference decodeLogDomainSimple) with optional corrections.

    norm_offset/norm_scale extend the reference algorithm with the standard
    offset/normalized min-sum check-message corrections
    (|Lr| -> norm_scale * max(|Lr| - norm_offset, 0)), which recover most of
    min-sum's gap to the true sum-product rule at no extra cost. The
    defaults (0, 1) reproduce the reference arithmetic exactly; the BER
    improvement is asserted statistically in tests/test_decoders.py.
    """
    lay = edge_layout(code)
    B = rx.shape[0]
    big = jnp.asarray(np.finfo(np.dtype(dtype)).max, dtype)  # DBL_MAX analog
    cmask = jnp.asarray(lay.chk_mask)
    vmask = jnp.asarray(lay.var_mask)

    Lci = -_f(rx, dtype)  # (B, N)
    # init Lq in check-major: Lq(m, w) = Lci[chk_nbrs[m, w]]
    Lq = _bcast_cm(Lci, lay)

    vhat0 = jnp.zeros((B, lay.N), jnp.int8)
    done0 = jnp.zeros((B,), bool)

    def step(Lq):
        alpha = _sign(Lq)
        beta = jnp.abs(Lq)
        beta_m = jnp.where(cmask, beta, big)
        alpha_m = jnp.where(cmask, alpha, jnp.ones_like(alpha))
        # product of signs over the row (masked slots contribute 1)
        prod_alpha = jnp.prod(alpha_m, axis=-1, keepdims=True)
        # min excluding self via top-2: first-argmin gets the second minimum
        min1 = jnp.min(beta_m, axis=-1, keepdims=True)
        argmin1 = jnp.argmin(beta_m, axis=-1)
        is_arg = jax.nn.one_hot(argmin1, lay.Wr, dtype=bool)
        min2 = jnp.min(jnp.where(is_arg, big, beta_m), axis=-1, keepdims=True)
        min_excl = jnp.where(is_arg, min2, min1)
        if norm_offset != 0.0:
            min_excl = jnp.maximum(min_excl - _f(norm_offset, dtype), 0)
        if norm_scale != 1.0:
            min_excl = min_excl * _f(norm_scale, dtype)
        Lr = prod_alpha * alpha * min_excl  # check-major (B, M, Wr)
        # variable step
        Lr_vm = _gather_vm(jnp.where(cmask, Lr, 0), lay)  # (B, N, Wc)
        sum_lr = jnp.sum(jnp.where(vmask, Lr_vm, 0), axis=-1)  # (B, N)
        LQ = Lci + sum_lr
        vhat = (LQ < 0).astype(jnp.int8)
        Lq_vm = Lci[:, :, None] + sum_lr[:, :, None] - Lr_vm  # ref: Lci + sum - Lrji
        Lq_new = _gather_cm(jnp.where(vmask, Lq_vm, 0), lay)
        return Lq_new, vhat

    if not early_exit:
        def body(_n, carry):
            Lq, _ = carry
            return step(Lq)
        _, vhat = jax.lax.fori_loop(0, iterations, body, (Lq, vhat0))
        return vhat

    def body(n, carry):
        Lq, vhat, done = carry
        Lq_new, vhat_new = step(Lq)
        keep = done[:, None, None]
        Lq = jnp.where(keep, Lq, Lq_new)
        vhat = jnp.where(done[:, None], vhat, vhat_new)
        conv = syndrome_ok(vhat_new, code.H) & (n + 1 < iterations)
        done = done | (~done & conv)
        return (Lq, vhat, done)

    _, vhat, _ = jax.lax.fori_loop(0, iterations, body, (Lq, vhat0, done0))
    return vhat


# ---------------------------------------------------------------------------
# tanh-rule sum-product (decodeSumProductSoft)
# ---------------------------------------------------------------------------

def decode_sumproduct(
    rx: jax.Array,
    code: LdpcCode,
    iterations: int = 5,
    early_exit: bool = True,
    dtype=jnp.float32,
) -> jax.Array:
    lay = edge_layout(code)
    B = rx.shape[0]
    cmask = jnp.asarray(lay.chk_mask)
    vmask = jnp.asarray(lay.var_mask)

    r = -_f(rx, dtype)  # (B, N)
    Mmsg = _bcast_cm(r, lay)

    vhat0 = jnp.zeros((B, lay.N), jnp.int8)
    done0 = jnp.zeros((B,), bool)

    def half_step(Mmsg):
        """Check messages + tentative decision."""
        t = jnp.where(cmask, jnp.tanh(Mmsg / 2), jnp.ones_like(Mmsg))
        T = _excl_prod(t)  # product over row excluding self
        E = jnp.log((1 + T) / (1 - T))  # check-major (B, M, Wr)
        # test: L_i = sum over connected checks of (E + r_i)
        E_vm = _gather_vm(jnp.where(cmask, E, 0), lay)  # (B, N, Wc)
        terms = jnp.where(vmask, E_vm + r[:, :, None], 0)
        L = jnp.sum(terms, axis=-1)
        vhat = (L <= 0).astype(jnp.int8)
        return E_vm, terms, vhat

    def bit_step(terms):
        """Bit messages: M(j, i) = sum over other checks of (E + r_i)."""
        M_vm = _excl_sum(terms)  # (B, N, Wc); pads contribute 0
        return _gather_cm(jnp.where(vmask, M_vm, 0), lay)

    if not early_exit:
        def body(_n, carry):
            Mmsg, _ = carry
            _, terms, vhat = half_step(Mmsg)
            return bit_step(terms), vhat
        _, vhat = jax.lax.fori_loop(0, iterations, body, (Mmsg, vhat0))
        return vhat

    def body(_n, carry):
        Mmsg, vhat, done = carry
        _, terms, vhat_new = half_step(Mmsg)
        vhat = jnp.where(done[:, None], vhat, vhat_new)
        # reference checks the syndrome EVERY iteration (":535"), before the
        # bit-message update, with no (n+1 < iterations) guard
        done = done | syndrome_ok(vhat_new, code.H)
        Mmsg_new = bit_step(terms)
        Mmsg = jnp.where(done[:, None, None], Mmsg, Mmsg_new)
        return (Mmsg, vhat, done)

    _, vhat, _ = jax.lax.fori_loop(0, iterations, body, (Mmsg, vhat0, done0))
    return vhat


# ---------------------------------------------------------------------------
# bit flipping (decodeBitFlipping)
# ---------------------------------------------------------------------------

def decode_bitflip(
    rx: jax.Array,
    code: LdpcCode,
    iterations: int = 5,
    early_exit: bool = True,
    dtype=jnp.float32,
) -> jax.Array:
    del dtype  # integer algorithm
    lay = edge_layout(code)
    B = rx.shape[0]
    vmask = jnp.asarray(lay.var_mask)
    Hf = jnp.asarray(code.H.astype(np.float32))
    flip_threshold = code.M // 2

    y = jnp.where(rx < 0, 0, 1).astype(jnp.int32)  # (B, N)
    ci0 = y
    vhat0 = y.astype(jnp.int8)
    done0 = jnp.zeros((B,), bool)

    def step(ci):
        # row sums S_m = sum of ci over the check's neighbors (exact in f32:
        # counts <= Wr << 2^24)
        S = jnp.dot(ci.astype(jnp.float32), Hf.T, preferred_element_type=jnp.float32)
        p = jnp.mod(S.astype(jnp.int32), 2)  # (B, M) row parity
        # 0/1 values broadcast to edges via exact f32 one-hot matmul
        p_vm = _bcast_vm(p.astype(jnp.float32), lay).astype(jnp.int32)
        # E(m, j) = (S_m - ci_j) mod 2 = p_m XOR ci_j on edges
        E = p_vm ^ ci[:, :, None]
        disagree = jnp.sum(jnp.where(vmask, (E != y[:, :, None]).astype(jnp.int32), 0), axis=-1)
        ci_new = jnp.where(disagree > flip_threshold, 1 - y, ci)
        return ci_new

    if not early_exit:
        def body(_n, ci):
            return step(ci)
        ci = jax.lax.fori_loop(0, iterations, body, ci0)
        return ci.astype(jnp.int8)

    def body(n, carry):
        ci, done = carry
        ci_new = step(ci)
        ci = jnp.where(done[:, None], ci, ci_new)
        conv = syndrome_ok(ci_new.astype(jnp.int8), code.H) & (n + 1 < iterations)
        done = done | (~done & conv)
        return (ci, done)

    ci, _ = jax.lax.fori_loop(0, iterations, body, (ci0, done0))
    return ci.astype(jnp.int8)


def decode_bitflip_mp(
    rx: jax.Array,
    code: LdpcCode,
    iterations: int = 5,
    early_exit: bool = True,
    dtype=jnp.float32,
) -> jax.Array:
    """Message-passing bit-flip: the ldpc_umfpack app's OWN variant
    (/root/reference/apps/ldpc_umfpack.cpp:384-470).

    The reference ships two DIFFERENT algorithms under the name
    "decodeBitFlipping": the GR module and ldpc_lapack use the majority
    flip (``decode_bitflip`` here — which can never flip a bit on a
    column-weight-3 code, so it degenerates to the hard slicer), while
    ldpc_umfpack uses this Gallager-A-style decoder with per-edge
    extrinsic-parity messages rji and bit messages qij — it genuinely
    corrects errors. Discovered in round 5 when anchoring the (16,8)
    waterfall to a run of the umfpack binary: its bitflip curve beat the
    majority rule's, and this replica closes the gap.

    Semantics preserved: ci = int(0.5*(sign(rx)+1)) (rx == 0 -> 0 via
    truncation), rji = extrinsic row parity, the >=-biased majority votes
    R + ci >= W - R (+ rji for the edge messages) with the CHANNEL hard
    decision ci never updated, and NO syndrome early exit — the reference
    loop always runs all iterations (``early_exit`` is accepted for API
    uniformity and ignored).
    """
    del dtype, early_exit  # integer algorithm; reference has no early exit
    H = jnp.asarray(code.H.astype(np.int32))       # (M, N)
    mask = (H != 0)[None]                           # (1, M, N)
    ci = (0.5 * (jnp.sign(rx) + 1.0)).astype(jnp.int32)   # (B, N)
    colw = jnp.sum(H, axis=0)                       # (N,)
    qij0 = ci[:, None, :] * H[None]                 # (B, M, N)

    def body(_n, carry):
        qij, _v = carry
        qsum = jnp.sum(qij, axis=2, keepdims=True)  # (B, M, 1); support-only
        rji = jnp.where(mask, (qsum + qij) % 2, 0)
        R = jnp.sum(rji, axis=1)                    # (B, N)
        vhat = (R + ci >= colw[None] - R).astype(jnp.int8)
        qij_new = jnp.where(
            mask,
            (R[:, None, :] + ci[:, None, :]
             >= colw[None, None, :] - R[:, None, :] + rji
             ).astype(jnp.int32),
            0)
        return qij_new, vhat

    _, vhat = jax.lax.fori_loop(0, iterations, body,
                                (qij0, ci.astype(jnp.int8)))
    return vhat


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

METHODS = {
    0: "minsum",        # reference default (LogDomain)
    1: "sumproduct",
    2: "bitflip",
    3: "hard",
}


BP_METHODS = ("minsum", "sumproduct")


def decode_backend(code: LdpcCode, method: int | str, mesh=None,
                   dtype=jnp.float32) -> str:
    """The platform decision for decoding: "triton" or "xla".

    The platform is the mesh's (all its devices share one) or, with no
    mesh, the default device's. On "gpu", float32 min-sum and sum-product
    on codes inside the kernel's envelope (``pallas_bp.kernel_supported``,
    an edge-count bound) take the Triton kernel; everything else takes the
    XLA decoders. "cpu" takes XLA. Any other platform raises.
    """
    devices = jax.devices() if mesh is None else mesh.devices.flat
    platforms = {d.platform for d in devices}
    platform = platforms.pop() if len(platforms) == 1 else None
    name = METHODS[method] if isinstance(method, int) else method
    if platform == "cpu":
        return "xla"
    if platform == "gpu":
        from .pallas_bp import kernel_supported
        if (name in BP_METHODS and jnp.dtype(dtype) == jnp.float32
                and kernel_supported(code)):
            return "triton"
        return "xla"
    raise ValueError(f"no decode path for platform {platform!r} "
                     f"(supported: gpu, cpu)")


@functools.lru_cache(maxsize=None)
def make_decoder(
    code: LdpcCode,
    method: int | str = 0,
    iterations: int = 5,
    early_exit: bool = True,
    dtype=jnp.float32,
    jit: bool = True,
    backend: str | None = None,
    mesh=None,
) -> Callable[[jax.Array], jax.Array]:
    """Build a decoder fn rx (B, N) -> vhat (B, N) for a method id or name.

    Memoized: repeated calls with the same configuration return the SAME
    jitted callable, so its compilation cache is reused.

    backend: None takes the route ``decode_backend`` picks for the mesh's
    (or the default device's) platform; "xla" forces the XLA decoders, the
    oracle path on any platform and dtype.
    """
    if isinstance(method, int):
        method = METHODS[method]
    if backend not in (None, "xla"):
        raise ValueError(f"unknown backend {backend!r}; use None or 'xla'")
    if backend is None and decode_backend(code, method, mesh, dtype) == "triton":
        from .pallas_bp import pallas_decode_minsum, pallas_decode_sumproduct
        pfn = (pallas_decode_minsum if method == "minsum"
               else pallas_decode_sumproduct)
        fn = functools.partial(pfn, code=code, iterations=iterations,
                               early_exit=early_exit)
        return jax.jit(fn) if jit else fn
    if method == "hard":
        fn = decode_hard
    elif method == "minsum":
        fn = functools.partial(
            decode_minsum, code=code, iterations=iterations,
            early_exit=early_exit, dtype=dtype)
    elif method == "sumproduct":
        fn = functools.partial(
            decode_sumproduct, code=code, iterations=iterations,
            early_exit=early_exit, dtype=dtype)
    elif method == "bitflip":
        fn = functools.partial(
            decode_bitflip, code=code, iterations=iterations,
            early_exit=early_exit, dtype=dtype)
    elif method == "bitflip_mp":
        fn = functools.partial(
            decode_bitflip_mp, code=code, iterations=iterations,
            early_exit=early_exit, dtype=dtype)
    else:
        raise ValueError(f"unknown method {method!r}")
    return jax.jit(fn) if jit else fn
