"""Mesh-sharded streaming receiver: acquisition + time-block sharded decode.

The scale-out counterpart of the host-side sync state machine in
blocks/ldpc.py (behavioral spec: /root/reference/lib/ldpc_decoder_cb_impl.cc:
147-226): acquisition finds the frame-grid phase and BPSK polarity once, on
the stream head, by decoding every candidate (offset, polarity) as one
batched device call in the reference's trial order (offset-major, normal
before inverted — the slide-by-1 retry collapsed into a batch); the body of
the stream then decodes fully sharded over the mesh's "stream" axis with
halo exchange (stream.py). This is BASELINE.json config 5: the continuous
transmitter->receiver chain on N hosts.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ..codes import LdpcCode, get_code
from ..ops import make_decoder, pack_bits_np, syndrome_weight
from .mesh import make_mesh, mesh_axis_sizes
from .stream import shard_stream_decode

__all__ = ["Acquisition", "ReceiveResult", "StreamReceiver", "acquire"]


@functools.lru_cache(maxsize=None)
def _decode_and_weigh(code, method, iterations):
    """Memoized jitted (decode + syndrome weight): a fresh jax.jit per
    acquire() call would retrace and recompile every time."""
    dec = make_decoder(code, method=method, iterations=iterations, jit=False)

    @jax.jit
    def run(b):
        vhat = dec(b)
        return syndrome_weight(vhat, code.H)

    return run


@functools.lru_cache(maxsize=None)
def _acquire_fused(code, method, iterations, n_off, verify_frames):
    """One-shot acquisition program: takes the stream HEAD (length
    n_off - 1 + (1 + verify_frames) * N) and decodes every candidate
    (offset, polarity) frame PLUS its verify window in a single batched
    call, returning syndrome weights (2, n_off, 1 + verify_frames)
    [polarity 0 = normal, 1 = inverted]. One host->device upload of the
    head and one small weight fetch replace the search + verify round
    trips; window extraction is a constant-index gather on device."""
    N = code.N
    L = 1 + verify_frames
    dec = make_decoder(code, method=method, iterations=iterations, jit=False)
    idx = (np.arange(n_off)[:, None] + np.arange(L * N)[None, :]).astype(
        np.int32)  # (n_off, L*N) constant

    @jax.jit
    def run(head):
        win = jnp.take(head, jnp.asarray(idx), axis=0)      # (n_off, L*N)
        frames = jnp.concatenate([win, -win]).reshape(2 * n_off * L, N)
        w = syndrome_weight(dec(frames), code.H)
        return w.reshape(2, n_off, L).astype(jnp.int32)

    return run, n_off - 1 + L * N


@functools.lru_cache(maxsize=None)
def _accept_bitmask(code, threshold):
    """Jitted (F,) syndrome weights -> MSB-first packed accept bitmask
    (ceil(F/8),) uint8: 1 bit per frame over the wire instead of 1 byte."""

    @jax.jit
    def run(w):
        acc = (w.astype(jnp.int32) <= threshold).astype(jnp.int32)
        Fp = ((acc.shape[0] + 7) // 8) * 8
        acc = jnp.pad(acc, (0, Fp - acc.shape[0]))
        bits = acc.reshape(-1, 8)
        weights = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.int32)
        return jnp.sum(bits * weights, axis=1).astype(jnp.uint8)

    return run


# verification window of the device-side acquisition programs (matches
# acquire()'s default verify_frames; used by the fused, chunked, and
# segmented paths so their cached programs share geometry)
_VERIFY_FRAMES = 4


def _bucket_frames(F_real: int) -> int:
    """Pad a frame count to a 5-significant-bit bucket so the lru-cached
    whole-stream programs compile once per bucket instead of once per
    distinct stream length (worst-case zero-tail decode waste 6.25%,
    rejected by syndrome and host-truncated; <= 32 cached shapes per
    octave)."""
    if F_real <= 32:
        return F_real
    g = 1 << (F_real.bit_length() - 5)
    return ((F_real + g - 1) // g) * g


def _select_lock(w, threshold, n_off):
    """Device-side (ok, off, pol) winner from acquisition syndrome
    weights w (2, n_off, L), in the reference's trial order: offsets
    ascending, normal polarity before inverted at each offset
    (/root/reference/lib/ldpc_decoder_cb_impl.cc:178-199's slide/negate
    retry collapsed into an argmin over a rank score)."""
    hit = jnp.all(w <= threshold, axis=2)                 # (2, n_off)
    score = (2 * jax.lax.broadcasted_iota(jnp.int32, (2, n_off), 1)
             + jax.lax.broadcasted_iota(jnp.int32, (2, n_off), 0))
    score = jnp.where(hit, score, jnp.int32(2 ** 30))
    best = jnp.min(score)
    ok = best < 2 ** 30
    off = jnp.where(ok, best // 2, 0)
    pol = jnp.where(ok, best % 2, 0)
    return ok, off, pol


@functools.lru_cache(maxsize=None)
def _fused_receiver_program(code, method, iterations, threshold, n_off,
                            verify_frames, T_padded):
    """Single-dispatch receiver for a 1-shard mesh: acquisition (offset x
    polarity search + verify), polarity correction, whole-stream decode,
    MSB-first byte repack, and the accept bitmask — ONE jitted program, so
    no host round-trip separates acquisition from the body decode (the
    two-phase path fetches the weights before it can dispatch the body). The winning (offset, polarity) is selected ON
    DEVICE in the reference's trial order (offset-major, normal before
    inverted — lib/ldpc_decoder_cb_impl.cc:178-199's slide/negate retry
    collapsed into an argmin) and comes back alongside the payload in the
    single result fetch.

    Returns (packed (F, K//8) u8, bitmask ceil(F/8) u8, ok bool,
    offset i32, inverted i32, weight0 i32) with F = T_padded // N.
    """
    N, M, K = code.N, code.M, code.K
    L = 1 + verify_frames
    F = T_padded // N
    dec = make_decoder(code, method=method, iterations=iterations, jit=False)
    idx = (np.arange(n_off)[:, None] + np.arange(L * N)[None, :]).astype(
        np.int32)
    from ..ops import pack_bits

    @jax.jit
    def run(stream):                          # (T_padded,) f32
        win = jnp.take(stream, jnp.asarray(idx), axis=0)
        cand = jnp.concatenate([win, -win]).reshape(2 * n_off * L, N)
        w = syndrome_weight(dec(cand), code.H).reshape(2, n_off, L)
        ok, off, pol = _select_lock(w, threshold, n_off)
        body = jnp.where(pol > 0, -stream, stream)
        # tail padding must cover the FULL searched offset range: the
        # dynamic_slice start clamps to [0, len(ext) - F*N], so padding
        # only N zeros silently mis-decoded any lock offset > N (round-3
        # advisor finding). Offsets reach n_off - 1, so pad that many
        # frame periods; the zero tail frames fail the syndrome accept
        # and the host truncates to n_valid = (T - offset) // N anyway.
        pad = max(N, ((n_off - 1 + N - 1) // N) * N)
        ext = jnp.concatenate([body, jnp.zeros(pad, jnp.float32)])
        frames = jax.lax.dynamic_slice_in_dim(ext, off, F * N).reshape(F, N)
        vhat = dec(frames)
        wf = syndrome_weight(vhat, code.H)
        packed = pack_bits(vhat[:, M:])
        bm = _accept_bitmask(code, threshold)(wf)
        w0 = w[pol, off, 0]
        return packed, bm, ok, off, pol, w0.astype(jnp.int32)

    return run


@functools.lru_cache(maxsize=None)
def _acquire_select_program(code, method, iterations, threshold, n_off,
                            verify_frames):
    """Acquisition with ON-DEVICE winner selection: stream head -> (ok,
    off, pol, w0) device scalars, never fetched before the body decode —
    the chunked pipeline feeds them straight into the chunk programs as a
    device-side data dependency (zero host round-trips between
    acquisition and decode). Selection order matches the reference's
    trials (offset-major, normal before inverted,
    /root/reference/lib/ldpc_decoder_cb_impl.cc:178-199)."""
    N = code.N
    L = 1 + verify_frames
    dec = make_decoder(code, method=method, iterations=iterations, jit=False)
    idx = (np.arange(n_off)[:, None] + np.arange(L * N)[None, :]).astype(
        np.int32)

    @jax.jit
    def run(head):                      # (n_off - 1 + L*N,) f32
        win = jnp.take(head, jnp.asarray(idx), axis=0)
        cand = jnp.concatenate([win, -win]).reshape(2 * n_off * L, N)
        w = syndrome_weight(dec(cand), code.H).reshape(2, n_off, L)
        ok, off, pol = _select_lock(w, threshold, n_off)
        return ok, off, pol, w[pol, off, 0].astype(jnp.int32)

    return run, n_off - 1 + L * N


@functools.lru_cache(maxsize=None)
def _chunk_decode_program(code, method, iterations, threshold, Fc, ext_len):
    """One pipeline chunk: (ext (ext_len,), off, pol, c) -> (packed
    (Fc, K//8) u8, bitmask u8). Decodes the Fc frames starting at off +
    c*Fc*N with polarity applied post-slice. Compiled once per chunk
    geometry — every chunk index reuses the same program (c is traced)."""
    N, M = code.N, code.M
    dec = make_decoder(code, method=method, iterations=iterations, jit=False)
    from ..ops import pack_bits

    @jax.jit
    def run(ext, off, pol, c):
        start = off + c * (Fc * N)
        frames = jax.lax.dynamic_slice_in_dim(ext, start, Fc * N
                                              ).reshape(Fc, N)
        frames = jnp.where(pol > 0, -frames, frames)
        vhat = dec(frames)
        wf = syndrome_weight(vhat, code.H)
        return pack_bits(vhat[:, M:]), _accept_bitmask(code, threshold)(wf)

    return run


# one jitted reducer for the chunked profile's device-sync point: jit
# specializes per (arity, shape), so every bucket geometry compiles once
# and the sync is one dispatch instead of one per array
@jax.jit
def _sync_sum(*bs):
    acc = jnp.int32(0)
    for b in bs:
        acc = acc + jnp.sum(b.astype(jnp.int32))
    return acc


@dataclasses.dataclass(frozen=True)
class Acquisition:
    offset: int          # frame-grid phase in [0, N)
    inverted: bool       # BPSK 180-degree ambiguity (Costas lock)
    weight: int          # syndrome weight of the locking decode


@dataclasses.dataclass
class ReceiveResult:
    data: bytes                  # packed data bytes of ACCEPTED frames, in order
    acquisition: Optional[Acquisition]
    n_frames: int                # complete frames after the lock point
    accepted: np.ndarray         # (n_frames,) bool, syndrome <= threshold
    weights: np.ndarray          # (n_frames,) syndrome weights
    timings: Optional[dict] = None  # wall breakdown: acquire/decode_fetch/host (s)


def acquire(
    stream: np.ndarray,
    code: LdpcCode,
    method: int | str = 0,
    iterations: int = 5,
    threshold: Optional[int] = None,
    window: Optional[int] = None,
    verify_frames: int = 4,
    max_candidates: int = 32,
) -> Optional[Acquisition]:
    """Search (offset, polarity) over the head of a real-symbol stream.

    Decodes all sliding windows x both polarities in one batched call and
    walks the hits in the reference's trial order (offset-major, normal
    polarity before inverted). Because a BP decoder happily converges
    *misaligned* windows onto some codeword, a raw syndrome hit can be a
    false lock — the reference handles that by locking anyway and falling
    back out after 10 bad frames (lib/ldpc_decoder_cb_impl.cc:169-176); this
    batched acquisition instead *verifies* each candidate against its next
    ``verify_frames`` frames (one more batched decode) and accepts the first
    candidate whose whole verification window passes. Returns None when no
    candidate verifies.
    """
    N = code.N
    threshold = code.M // 8 if threshold is None else threshold
    is_dev = isinstance(stream, jax.Array) and not isinstance(
        stream, np.ndarray)
    if is_dev:
        head = stream  # device-resident: only the weight tensor is fetched
        head_len = int(head.shape[0])
    else:
        head = np.asarray(stream, np.float32)
        head_len = len(head)
    n_off = head_len - N + 1
    if window is not None:
        n_off = min(n_off, window)
    if n_off <= 0:
        return None
    # fast path: when the head covers full verify windows for every
    # candidate offset, search + verify run as ONE device call on the
    # (already-uploaded, for device streams) head; only the small weight
    # tensor crosses to the host
    if verify_frames > 0:
        run_f, need = _acquire_fused(code, method, iterations, n_off,
                                     verify_frames)
        if head_len >= need:
            w = np.asarray(run_f(head[:need] if is_dev
                                 else jnp.asarray(head[:need])))
            ok = w <= threshold
            hit = ok.all(axis=2)                             # lock + verify
            for o in np.nonzero(hit[0] | hit[1])[0]:
                pol = 0 if hit[0, o] else 1
                return Acquisition(offset=int(o), inverted=bool(pol),
                                   weight=int(w[pol, o, 0]))
            return None
    if is_dev:  # the sliding-window fallback is host-side
        head = np.asarray(head, np.float32)
    frames = np.lib.stride_tricks.sliding_window_view(
        head[: n_off + N - 1], N)[:n_off]
    batch = np.concatenate([frames, -frames]).astype(np.float32)
    run = _decode_and_weigh(code, method, iterations)

    w = np.asarray(run(jnp.asarray(batch)))
    ok = w <= threshold
    # trial order: offsets ascending, normal before inverted at each offset
    candidates: list[tuple[int, bool, int]] = []
    for o in np.nonzero(ok[:n_off] | ok[n_off:])[0]:
        o = int(o)
        if ok[o]:
            candidates.append((o, False, int(w[o])))
        if ok[n_off + o]:
            candidates.append((o, True, int(w[n_off + o])))
        if len(candidates) >= max_candidates:
            break
    if not candidates:
        return None
    if verify_frames <= 0:
        o, inv, wt = candidates[0]
        return Acquisition(offset=o, inverted=inv, weight=wt)
    # verification pass: next verify_frames frames of every candidate in one
    # batched decode (frames truncated to what the stream actually holds).
    # The batch is padded to a STATIC (max_candidates * verify_frames, N)
    # shape so this call compiles once per configuration — a data-dependent
    # candidate count would retrace/recompile on every acquisition.
    ver = np.zeros((max_candidates * verify_frames, N), np.float32)
    counts: list[int] = []
    for ci, (o, inv, _) in enumerate(candidates):
        avail = (len(head) - o) // N
        k = min(verify_frames, max(0, avail - 1))
        f = head[o + N : o + (k + 1) * N].reshape(k, N)
        ver[ci * verify_frames : ci * verify_frames + k] = -f if inv else f
        counts.append(k)
    wv = np.asarray(run(jnp.asarray(ver)))
    for ci, ((o, inv, wt), k) in enumerate(zip(candidates, counts)):
        chunk = wv[ci * verify_frames : ci * verify_frames + k]
        if np.all(chunk <= threshold):
            return Acquisition(offset=o, inverted=inv, weight=wt)
    return None


class StreamReceiver:
    """Acquire once on the head, then decode the whole stream mesh-sharded.

    Unlike the stateful per-frame walk of blocks/ldpc.py (which tolerates
    mid-stream polarity flips), this receiver assumes one stable lock per
    call — the continuous-pipeline regime of transmitter.grc/receiver.grc —
    and buys full device-mesh parallelism for it.
    """

    def __init__(
        self,
        code: Optional[LdpcCode] = None,
        mesh: Optional[Mesh] = None,
        method: int | str = 0,
        iterations: int = 5,
        threshold: Optional[int] = None,
        acquire_window: int = 1024,
        stream_axis: str = "stream",
    ) -> None:
        self.code = code or get_code("block_32_64")
        self.mesh = mesh or make_mesh((stream_axis,))
        self.method = method
        self.iterations = iterations
        self.threshold = (self.code.M // 8 if threshold is None else threshold)
        self.acquire_window = acquire_window
        self.stream_axis = stream_axis
        self._S = mesh_axis_sizes(self.mesh)[stream_axis]

    def receive(self, symbols, fetch_weights: bool = True,
                profile: bool = False) -> ReceiveResult:
        """Decode a real-symbol stream (complex input: real part is taken).

        Accepts a host array (numpy) or a DEVICE-RESIDENT jax.Array. With a
        device array only the stream head (acquisition window) is fetched to
        the host; polarity flip, padding, the sharded decode, and the
        MSB-first data-byte repack all run on device, and only the packed
        payload bytes plus per-frame syndrome weights come back — the
        host<->device traffic is O(head + decoded bytes), not O(stream).

        fetch_weights=False (packed-byte codes only) replaces the per-frame
        weight fetch with an on-device accept BITMASK (threshold compare +
        bit-pack, 1 bit/frame instead of 1 byte/frame): ~20% fewer wire
        bytes on the reference code. ``weights`` is then empty; ``accepted``
        is still exact.

        profile=True splits the decode/fetch wall: a scalar reduction is
        fetched first (device sync -> decode_s, one extra round trip), then
        the payload (fetch_s), and timings gains fetch_bytes / wire_mb_s.
        """
        import time

        code, N = self.code, self.code.N
        on_device = isinstance(symbols, jax.Array) and not isinstance(
            symbols, np.ndarray)
        packed_ok = code.K % 8 == 0
        t0 = time.perf_counter()
        if on_device:
            dev = symbols
            if jnp.iscomplexobj(dev):
                dev = jnp.real(dev)
            dev = dev.astype(jnp.float32)
            T = int(dev.shape[0])
            if (self._S == 1 and packed_ok and fetch_weights is False):
                # single-shard fast path: acquisition + body decode fused
                # into one dispatch (no host sync between them)
                return self._receive_fused(dev, T, profile)
            # acquisition runs on the device-resident head; only its weight
            # tensor crosses to the host (acquire()'s device path)
            head_len = min(T, self.acquire_window + 6 * N)
            head = dev[:head_len]
        else:
            head = reals = np.ascontiguousarray(
                np.real(np.asarray(symbols)), np.float32)
            T = len(reals)
        acq = acquire(
            head, code,
            method=self.method, iterations=self.iterations,
            threshold=self.threshold, window=self.acquire_window)
        t_acquire = time.perf_counter() - t0
        if acq is None:
            return ReceiveResult(
                data=b"", acquisition=None, n_frames=0,
                accepted=np.zeros(0, bool), weights=np.zeros(0, np.int32),
                timings={"acquire_s": t_acquire})
        # frames fully contained in the stream from the lock point; the
        # sharded decode takes the frame-grid PHASE in [0, N) — a lock
        # offset >= N means `skip` whole frame periods before the lock
        # point whose decodes are pre-lock noise and are dropped below
        skip, phase = divmod(acq.offset, N)
        n_valid = (T - acq.offset) // N
        # pad to a whole number of frame periods per shard (padding symbols
        # only feed frames that are dropped below)
        chunk = self._S * N
        T_padded = ((T + chunk - 1) // chunk) * chunk
        t0 = time.perf_counter()
        if on_device:
            stream_dev = -dev if acq.inverted else dev
            stream_dev = jnp.pad(stream_dev, (0, T_padded - T))
        else:
            if acq.inverted:
                reals = -reals
            padded = np.zeros(T_padded, np.float32)
            padded[:T] = reals
            stream_dev = jnp.asarray(padded)
        out, w = shard_stream_decode(
            stream_dev, code, self.mesh, method=self.method,
            iterations=self.iterations, offset=phase,
            stream_axis=self.stream_axis, return_packed=packed_ok)
        bitmask = fetch_weights is False and packed_ok
        if bitmask:
            w = _accept_bitmask(self.code, self.threshold)(w)
        timings = {"acquire_s": t_acquire}
        if profile:
            # true sync point: the decode is done when this scalar lands
            jax.device_get(jnp.sum(w.astype(jnp.int32)))
            timings["decode_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        # one combined transfer for payload + weights/bitmask
        out_np, w_np = jax.device_get((out, w))
        t_fetch = time.perf_counter() - t0
        if profile:
            nbytes = out_np.nbytes + w_np.nbytes
            timings.update(fetch_s=t_fetch, fetch_bytes=int(nbytes),
                           wire_mb_s=nbytes / max(t_fetch, 1e-9) / 1e6)
        else:
            timings["decode_fetch_s"] = t_fetch
        t0 = time.perf_counter()
        if bitmask:
            accepted = np.unpackbits(w_np)[skip:skip + n_valid].astype(bool)
            w = np.zeros(0, np.int32)
        else:
            w = w_np[skip:skip + n_valid].astype(np.int32)
            accepted = w <= self.threshold
        if packed_ok:
            packed = out_np[skip:skip + n_valid]    # (F, K//8) uint8
            payload = packed[accepted].reshape(-1).tobytes()
        else:
            vhat = out_np[skip:skip + n_valid]
            data_bits = vhat[accepted][:, code.M:].astype(np.uint8)
            payload = (pack_bits_np(data_bits).reshape(-1).tobytes()
                       if data_bits.size else b"")
        timings["host_s"] = time.perf_counter() - t0
        return ReceiveResult(
            data=payload, acquisition=acq, n_frames=int(n_valid),
            accepted=accepted, weights=w, timings=timings)

    def _chunked_dispatch(self, dev: jax.Array, T: int, F_pad: int,
                          n_off: int, profile: bool = False) -> dict:
        """Issue the chunked pipeline's device work and async copies.

        Dispatch order: one acquisition program whose (ok, off, pol)
        outputs stay on device, then C chunk-decode programs consuming
        them as a device-side dependency, then copy_to_host_async on
        every chunk result — so the host link starts moving payload
        the moment chunk 0 finishes decoding while chunks 1..C-1 still
        compute (and, in segmented use, while LATER segments' chain +
        decode programs run). No host blocking happens here.
        """
        import time

        code = self.code
        verify = _VERIFY_FRAMES
        C = 8
        Fc = F_pad // C
        T_padded = F_pad * code.N
        pad = max(code.N, ((n_off - 1 + code.N - 1) // code.N) * code.N)
        ext_len = T_padded + pad
        t0 = time.perf_counter()
        acq_run, need = _acquire_select_program(
            code, self.method, self.iterations, self.threshold, n_off,
            verify)
        chunk_run = _chunk_decode_program(
            code, self.method, self.iterations, self.threshold, Fc, ext_len)
        ext = jnp.pad(dev, (0, ext_len - T))
        ok, off, pol, w0 = acq_run(ext[:need])
        timings: dict = {"fused": True, "pipeline_chunks": C}
        if profile:
            # record acquisition separately (comparable with the
            # two-phase/fused breakdowns' acquire_s): sync on the lock
            # scalars before dispatching chunks — costs one round trip,
            # and only in the profiled pass; unprofiled, the chunks
            # consume (off, pol) as a device-side dependency with no
            # host sync in between
            jax.device_get(ok)
            timings["acquire_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        outs = [chunk_run(ext, off, pol, jnp.int32(c)) for c in range(C)]
        timings["dispatch_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if profile:
            # honest decode/wire split: block on ONE jitted scalar that
            # depends on every chunk's output before any payload copy is
            # issued, so fetch_s below is pure wire. The profiled pass
            # therefore serializes decode and wire (the unprofiled pass
            # overlaps them), costing one extra round trip — same
            # methodology as the unfused path's scalar sync.
            jax.device_get(_sync_sum(*[b for _, b in outs]))
            timings["decode_s"] = time.perf_counter() - t0
        # each chunk's copy starts the moment its decode finishes (wire
        # overlaps the remaining decode); profiled, all copies start
        # post-sync and overlap each other
        for p, b in outs:
            p.copy_to_host_async()
            b.copy_to_host_async()
        return {"T": T, "outs": outs, "scalars": (ok, off, pol, w0),
                "timings": timings, "profile": profile,
                "t_fetch0": time.perf_counter()}

    def _chunked_collect(self, st: dict) -> ReceiveResult:
        """Block once (ONE batched device_get over every array, not one
        round trip per chunk) and assemble the payload."""
        outs = st["outs"]
        ok, off, pol, w0 = st["scalars"]
        scalars_np, packed_list, bms = jax.device_get(
            ((ok, off, pol, w0), [p for p, _ in outs], [b for _, b in outs]))
        return self._chunked_assemble(st, scalars_np, packed_list, bms)

    def receive_collect_many(self, states: list) -> list:
        """Collect SEVERAL dispatched segments with ONE device_get instead
        of one round trip per segment."""
        payload = [(st["scalars"], [p for p, _ in st["outs"]],
                    [b for _, b in st["outs"]]) for st in states]
        fetched = jax.device_get(payload)
        return [self._chunked_assemble(st, sc, ps, bs)
                for st, (sc, ps, bs) in zip(states, fetched)]

    def _chunked_assemble(self, st: dict, scalars_np, packed_list,
                          bms) -> ReceiveResult:
        import time

        N = self.code.N
        T, timings = st["T"], st["timings"]
        ok_np, off_np, pol_np, w0_np = scalars_np
        t0 = st["t_fetch0"]
        bm_np = np.concatenate(bms)
        t_fetch = time.perf_counter() - t0
        if st["profile"]:
            nbytes = sum(p.nbytes for p in packed_list) + bm_np.nbytes
            timings.update(fetch_s=t_fetch, fetch_bytes=int(nbytes),
                           wire_mb_s=nbytes / max(t_fetch, 1e-9) / 1e6)
        else:
            timings["decode_fetch_s"] = t_fetch
        t0 = time.perf_counter()
        if not bool(ok_np):
            timings["host_s"] = time.perf_counter() - t0
            return ReceiveResult(
                data=b"", acquisition=None, n_frames=0,
                accepted=np.zeros(0, bool), weights=np.zeros(0, np.int32),
                timings=timings)
        offset = int(off_np)
        n_valid = (T - offset) // N
        # Fc is a multiple of 8 here (F_pad >= 4096 with a >=256 bucket
        # granule), so per-chunk bitmask bits concatenate without padding
        # holes
        accepted = np.unpackbits(bm_np, count=n_valid).view(bool)
        # per-chunk assembly: fully-accepted chunks are straight memcpys;
        # only chunks containing rejected frames pay a boolean
        # row-compaction. No global concatenate — host time stays out of
        # the wire floor (the wall should BE the wire)
        pieces, pos = [], 0
        for arr in packed_list:
            take = min(n_valid - pos, len(arr))
            if take <= 0:
                break
            acc_c = accepted[pos:pos + take]
            if acc_c.all():
                pieces.append(arr[:take].tobytes())
            else:
                pieces.append(arr[:take][acc_c].reshape(-1).tobytes())
            pos += take
        payload = b"".join(pieces)
        acq = Acquisition(offset=offset, inverted=bool(pol_np),
                          weight=int(w0_np))
        timings["host_s"] = time.perf_counter() - t0
        return ReceiveResult(
            data=payload, acquisition=acq, n_frames=int(n_valid),
            accepted=accepted, weights=np.zeros(0, np.int32),
            timings=timings)

    def _receive_chunked(self, dev: jax.Array, T: int, F_pad: int,
                         n_off: int, profile: bool) -> ReceiveResult:
        """Chunked device-resident pipeline (see _receive_fused's branch):
        dispatch everything, then block once."""
        return self._chunked_collect(
            self._chunked_dispatch(dev, T, F_pad, n_off, profile))

    def receive_dispatch(self, symbols: jax.Array) -> dict:
        """Non-blocking half of ``receive`` for SEGMENTED pipelines.

        Issues the whole chunked receive (acquisition + C chunk decodes +
        async payload copies) for a device-resident symbol segment and
        returns an opaque state for ``receive_collect`` — no host sync.
        Interleaving ``chain -> receive_dispatch`` over consecutive
        stream segments and collecting at the end overlaps each
        segment's payload wire transfer under the NEXT segments' chain +
        decode compute, which is what makes the composed
        chain->receive path wire-overlapped end to end (round-4 VERDICT
        item 2: the unsegmented composition serialized chain, decode,
        and wire). Requires the chunked path's conditions: 1-shard mesh,
        byte-packable code, and a stream of >= 4096 frame periods.
        """
        code, N = self.code, self.code.N
        if self._S != 1 or code.K % 8 != 0:
            raise ValueError("receive_dispatch needs a 1-shard mesh and a "
                             "byte-packable code (K % 8 == 0)")
        dev = symbols
        if jnp.iscomplexobj(dev):
            dev = jnp.real(dev)
        dev = dev.astype(jnp.float32)
        T = int(dev.shape[0])
        F_pad = _bucket_frames((T + N - 1) // N)
        L = 1 + _VERIFY_FRAMES
        n_off = min(self.acquire_window, T - L * N + 1)
        if not (F_pad >= 4096 and F_pad % 8 == 0 and n_off > 0):
            raise ValueError(
                f"segment too short for the chunked pipeline "
                f"({(T + N - 1) // N} frame periods; need >= 4096)")
        return self._chunked_dispatch(dev, T, F_pad, n_off)

    def receive_collect(self, state: dict) -> ReceiveResult:
        """Blocking half of ``receive_dispatch``: one batched fetch +
        payload assembly for that segment."""
        return self._chunked_collect(state)

    def _receive_fused(self, dev: jax.Array, T: int,
                       profile: bool) -> ReceiveResult:
        """Single-dispatch device-resident receive (see
        _fused_receiver_program). Only reached with a 1-shard mesh, packed
        byte codes, and fetch_weights=False."""
        import time

        code, N = self.code, self.code.N
        verify = _VERIFY_FRAMES
        L = 1 + verify
        t0 = time.perf_counter()
        # bucketed padded frame count (round-3 advisor finding: exact-T
        # cache keys meant a multi-second recompile per distinct stream
        # length) — see _bucket_frames
        F_pad = _bucket_frames((T + N - 1) // N)
        T_padded = F_pad * N
        # candidate offsets must keep their whole verify window inside the
        # REAL samples — windows reaching into the zero tail would lock on
        # the all-zero codeword
        n_off = min(self.acquire_window, T - L * N + 1)
        if n_off <= 0:
            return ReceiveResult(
                data=b"", acquisition=None, n_frames=0,
                accepted=np.zeros(0, bool), weights=np.zeros(0, np.int32),
                timings={"acquire_s": 0.0})
        # long streams take the chunked pipeline: the decode splits into C
        # programs whose device-to-host copies start the moment each chunk
        # finishes (copy_to_host_async), so transfer time overlaps the
        # remaining decode instead of following it
        if F_pad >= 4096 and F_pad % 8 == 0:
            return self._receive_chunked(dev, T, F_pad, n_off, profile)
        run = _fused_receiver_program(
            code, self.method, self.iterations, self.threshold, n_off,
            verify, T_padded)
        res = run(jnp.pad(dev, (0, T_padded - T)))
        timings: dict = {"fused": True}
        if profile:
            jax.device_get(res[2])               # ok flag: true device sync
            timings["decode_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        packed_np, bm_np, ok_np, off_np, pol_np, w0_np = jax.device_get(res)
        t_fetch = time.perf_counter() - t0
        if profile:
            nbytes = packed_np.nbytes + bm_np.nbytes
            timings.update(fetch_s=t_fetch, fetch_bytes=int(nbytes),
                           wire_mb_s=nbytes / max(t_fetch, 1e-9) / 1e6)
        else:
            timings["decode_fetch_s"] = t_fetch
        t0 = time.perf_counter()
        if not bool(ok_np):
            timings["host_s"] = time.perf_counter() - t0
            return ReceiveResult(
                data=b"", acquisition=None, n_frames=0,
                accepted=np.zeros(0, bool), weights=np.zeros(0, np.int32),
                timings=timings)
        offset = int(off_np)
        n_valid = (T - offset) // N
        accepted = np.unpackbits(bm_np)[:n_valid].astype(bool)
        payload = packed_np[:n_valid][accepted].reshape(-1).tobytes()
        acq = Acquisition(offset=offset, inverted=bool(pol_np),
                          weight=int(w0_np))
        timings["host_s"] = time.perf_counter() - t0
        return ReceiveResult(
            data=payload, acquisition=acq, n_frames=int(n_valid),
            accepted=accepted, weights=np.zeros(0, np.int32),
            timings=timings)
