"""Belief-propagation decode kernel for NVIDIA GPUs (Pallas, Triton route).

The XLA decoders in ops/decode.py write every (B, E) message array to device
memory on each iteration. This kernel keeps a tile of frames' messages on
chip for all iterations: each program owns ``TILE`` frames (one per thread),
loads their received symbols once, iterates, and writes only the hard
decisions.

The Tanner graph is a compile-time constant, so the kernel carries the
messages as one (TILE,) vector per edge and wires the check and variable
updates in Python. Moving a message between the check-major and var-major
views is a renaming of traced values: no gather, one-hot product or shared
memory traffic runs on the device. The arithmetic follows ops/decode.py
operation for operation (same exclusion scans, same summation order), so in
interpret mode the kernel reproduces the XLA f32 decoders' hard decisions
exactly. On the GPU, libdevice's tanh and log differ from XLA's in the last
bits, so sum-product decisions can differ on frames at the decoding limit.

Envelope: the unrolled program grows with the edge count, and its compile
time faster still (see ``MAX_EDGES``). Codes with more than ``MAX_EDGES``
edges use the XLA decoders (``ops.decode.decode_backend``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..codes import LdpcCode

__all__ = ["pallas_decode_minsum", "pallas_decode_sumproduct",
           "kernel_supported", "MAX_EDGES", "TILE"]

TILE = 128       # frames per program, one per thread
NUM_WARPS = 4    # 4 warps x 32 threads = TILE
# Largest edge count routed to the kernel. The fully unrolled kernel's
# compile time grows faster than its size: on an H100, 168 edges (the
# reference code) compile in 20-32 s per variant, 384 edges in 311 s, and
# 768 edges did not finish within 10 minutes.
MAX_EDGES = 192


def kernel_supported(code: LdpcCode) -> bool:
    """Whether ``code`` is inside the kernel's envelope (edge count)."""
    return code.n_edges <= MAX_EDGES


@functools.lru_cache(maxsize=None)
def _wiring(code: LdpcCode):
    """Static Tanner-graph wiring over real edges in check-major order.

    Returns (checks, edge_var, variables): checks[m] the edge ids of check m
    in slot order, edge_var[e] the variable of edge e, variables[j] the edge
    ids of variable j in var-major slot order (ascending check index, as
    ``code.var_nbrs``).
    """
    checks, edge_var, slot = [], [], {}
    for m in range(code.M):
        ids = []
        for j in code.chk_nbrs[m, :code.chk_deg[m]]:
            slot[(m, int(j))] = len(edge_var)
            ids.append(len(edge_var))
            edge_var.append(int(j))
        checks.append(tuple(ids))
    variables = tuple(
        tuple(slot[(int(m), j)] for m in code.var_nbrs[j, :code.var_deg[j]])
        for j in range(code.N))
    return tuple(checks), tuple(edge_var), variables


def _sign(x):
    """(x > 0) - (x < 0), as ops.decode._sign (sign(0) = 0)."""
    return (x > 0).astype(x.dtype) - (x < 0).astype(x.dtype)


def _excl(vals, op):
    """[op over all k != w of vals[k] for each w], by prefix/suffix passes."""
    d = len(vals)
    pre, suf = [None] * d, [None] * d
    for w in range(1, d):
        pre[w] = vals[w - 1] if pre[w - 1] is None else op(pre[w - 1], vals[w - 1])
    for w in range(d - 2, -1, -1):
        suf[w] = vals[w + 1] if suf[w + 1] is None else op(suf[w + 1], vals[w + 1])
    return [p if s is None else s if p is None else op(p, s)
            for p, s in zip(pre, suf)]


def _syndrome_ok(bits, checks, edge_var):
    """Per-frame all-checks-satisfied flag (int32 0/1) from int32 0/1 bits."""
    unsat = None
    for edges in checks:
        par = bits[edge_var[edges[0]]]
        for e in edges[1:]:
            par = par ^ bits[edge_var[e]]
        unsat = par if unsat is None else unsat | par
    return (unsat == 0).astype(jnp.int32)


def _pack(bits):
    """N int32 0/1 vectors -> ceil(N/32) int32 words (bit j%32 of word j//32)."""
    words = []
    for k in range(0, len(bits), 32):
        w = bits[k]
        for i, b in enumerate(bits[k + 1:k + 32], start=1):
            w = w | (b << i)
        words.append(w)
    return words


def _store_words(out_ref, words, n):
    for j in range(n):
        out_ref[j, :] = ((words[j // 32] >> (j % 32)) & 1).astype(jnp.int8)


def _pad_done(n_valid):
    """Initial done flag: 1 on batch-padding frames, so an all-zero pad frame
    cannot keep a tile's early-exit loop running."""
    col = pl.program_id(0) * TILE + jax.lax.broadcasted_iota(
        jnp.int32, (TILE,), 0)
    return (col >= n_valid).astype(jnp.int32)


# ---------------------------------------------------------------------------
# min-sum (ops.decode.decode_minsum)
# ---------------------------------------------------------------------------

def _minsum_kernel(wiring, iterations, early_exit, n_valid, norm_offset,
                   norm_scale, rx_ref, out_ref):
    checks, edge_var, variables = wiring
    n = len(variables)
    Lci = [-rx_ref[j, :] for j in range(n)]

    def check_step(Lq):
        Lr = [None] * len(Lq)
        for edges in checks:
            alpha = [_sign(Lq[e]) for e in edges]
            prod = alpha[0]
            for a in alpha[1:]:
                prod = prod * a
            # min over the other edges: the value XLA's min1/min2/first-argmin
            # selection yields (minima are exact, so the order is free)
            mins = _excl([jnp.abs(Lq[e]) for e in edges], jnp.minimum)
            for e, a, m in zip(edges, alpha, mins):
                if norm_offset != 0.0:
                    m = jnp.maximum(m - jnp.float32(norm_offset), 0.0)
                if norm_scale != 1.0:
                    m = m * jnp.float32(norm_scale)
                Lr[e] = prod * a * m
        return Lr

    def var_step(Lr, want_bits=True, want_msgs=True):
        Lq, bits = [None] * len(Lr), []
        for j, edges in enumerate(variables):
            s = Lr[edges[0]]
            for e in edges[1:]:
                s = s + Lr[e]
            LQ = Lci[j] + s
            if want_bits:
                bits.append((LQ < 0).astype(jnp.int32))
            if want_msgs:
                for e in edges:
                    Lq[e] = LQ - Lr[e]
        return Lq, bits

    Lq0 = tuple(Lci[v] for v in edge_var)
    if not early_exit:
        def body(_i, Lq):
            return tuple(var_step(check_step(Lq), want_bits=False)[0])
        Lq = jax.lax.fori_loop(0, iterations - 1, body, Lq0)
        _, bits = var_step(check_step(Lq), want_msgs=False)
        for j in range(n):
            out_ref[j, :] = bits[j].astype(jnp.int8)
        return

    def cond(carry):
        i, _Lq, _words, done = carry
        return jnp.logical_and(i < iterations, jnp.min(done) == 0)

    def wbody(carry):
        i, Lq, words, done = carry
        Lq_new, bits = var_step(check_step(Lq))
        keep = done > 0
        Lq = tuple(jnp.where(keep, a, b) for a, b in zip(Lq, Lq_new))
        words = tuple(jnp.where(keep, a, b) for a, b in zip(words, _pack(bits)))
        conv = _syndrome_ok(bits, checks, edge_var) * (i + 1 < iterations)
        return i + 1, Lq, words, done | conv

    zero = jnp.zeros((TILE,), jnp.int32)
    words0 = tuple(zero for _ in range(0, n, 32))
    _, _, words, _ = jax.lax.while_loop(
        cond, wbody, (0, Lq0, words0, _pad_done(n_valid)))
    _store_words(out_ref, words, n)


# ---------------------------------------------------------------------------
# tanh-rule sum-product (ops.decode.decode_sumproduct)
# ---------------------------------------------------------------------------

def _sumproduct_kernel(wiring, iterations, early_exit, n_valid, rx_ref,
                       out_ref):
    checks, edge_var, variables = wiring
    n = len(variables)
    r = [-rx_ref[j, :] for j in range(n)]

    def half_step(Mmsg):
        """Check messages, then per-variable terms and the tentative bits."""
        E = [None] * len(Mmsg)
        for edges in checks:
            T = _excl([jnp.tanh(Mmsg[e] / 2.0) for e in edges], jnp.multiply)
            for e, t in zip(edges, T):
                E[e] = jnp.log((1.0 + t) / (1.0 - t))
        terms, bits = [], []
        for j, edges in enumerate(variables):
            tj = [E[e] + r[j] for e in edges]
            L = tj[0]
            for t in tj[1:]:
                L = L + t
            terms.append(tj)
            bits.append((L <= 0).astype(jnp.int32))
        return terms, bits

    def bit_step(terms):
        """M(j, i) = sum over the other checks: decode._excl_sum's
        (cumsum - t) + (reverse cumsum - t), in its summation order."""
        M = [None] * len(edge_var)
        for edges, tj in zip(variables, terms):
            d = len(tj)
            cs, rs = [tj[0]], [tj[d - 1]]
            for w in range(1, d):
                cs.append(cs[-1] + tj[w])
                rs.append(rs[-1] + tj[d - 1 - w])
            rs = rs[::-1]
            for w, e in enumerate(edges):
                M[e] = (cs[w] - tj[w]) + (rs[w] - tj[w])
        return tuple(M)

    M0 = tuple(r[v] for v in edge_var)
    if not early_exit:
        def body(_i, Mmsg):
            return bit_step(half_step(Mmsg)[0])
        Mmsg = jax.lax.fori_loop(0, iterations - 1, body, M0)
        _, bits = half_step(Mmsg)
        for j in range(n):
            out_ref[j, :] = bits[j].astype(jnp.int8)
        return

    # the reference checks the syndrome every iteration, before the bit
    # messages, with no iteration guard (decode.decode_sumproduct)
    def cond(carry):
        i, _M, _words, done = carry
        return jnp.logical_and(i < iterations, jnp.min(done) == 0)

    def wbody(carry):
        i, Mmsg, words, done = carry
        terms, bits = half_step(Mmsg)
        words = tuple(jnp.where(done > 0, a, b)
                      for a, b in zip(words, _pack(bits)))
        done = done | _syndrome_ok(bits, checks, edge_var)
        M_new = bit_step(terms)
        Mmsg = tuple(jnp.where(done > 0, a, b) for a, b in zip(Mmsg, M_new))
        return i + 1, Mmsg, words, done

    zero = jnp.zeros((TILE,), jnp.int32)
    words0 = tuple(zero for _ in range(0, n, 32))
    _, _, words, _ = jax.lax.while_loop(
        cond, wbody, (0, M0, words0, _pad_done(n_valid)))
    _store_words(out_ref, words, n)


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def _launch(kernel, name, rx, iterations, interpret):
    rx = jnp.asarray(rx, jnp.float32)
    B, N = rx.shape
    if iterations <= 0 or B == 0:
        return jnp.zeros((B, N), jnp.int8)
    Bp = -(-B // TILE) * TILE
    # frames along the minor axis: each per-variable row load is contiguous
    rx_t = jnp.pad(rx, ((0, Bp - B), (0, 0))).T
    out = pl.pallas_call(
        kernel,
        grid=(Bp // TILE,),
        in_specs=[pl.BlockSpec((N, TILE), lambda i: (0, i))],
        out_specs=pl.BlockSpec((N, TILE), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((N, Bp), jnp.int8),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name=name,
    )(rx_t)
    return out[:, :B].T


def pallas_decode_minsum(
    rx: jax.Array, code: LdpcCode, iterations: int = 20,
    early_exit: bool = False, norm_offset: float = 0.0,
    norm_scale: float = 1.0, interpret: bool = False,
) -> jax.Array:
    """Min-sum decode, rx (B, N) -> vhat (B, N) int8, with the semantics of
    ``ops.decode.decode_minsum`` (early exit freezes converged frames; a
    tile stops once all its frames have converged)."""
    kernel = functools.partial(
        _minsum_kernel, _wiring(code), iterations, early_exit, rx.shape[0],
        float(norm_offset), float(norm_scale))
    return _launch(kernel, "bp_minsum", rx, iterations, interpret)


def pallas_decode_sumproduct(
    rx: jax.Array, code: LdpcCode, iterations: int = 20,
    early_exit: bool = False, interpret: bool = False,
) -> jax.Array:
    """Sum-product decode, rx (B, N) -> vhat (B, N) int8, with the
    semantics of ``ops.decode.decode_sumproduct``."""
    kernel = functools.partial(
        _sumproduct_kernel, _wiring(code), iterations, early_exit,
        rx.shape[0])
    return _launch(kernel, "bp_sumproduct", rx, iterations, interpret)
