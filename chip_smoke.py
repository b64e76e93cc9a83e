#!/usr/bin/env python3
"""Smoke run of the system's main paths on one GPU, at full width.

    python chip_smoke.py           # phases (a)-(d) on one card
    python chip_smoke.py --multi   # the four-card paths only

Phases, each through the entry points a user calls:

  (a) bulk decode: ``make_decoder``'s default route against the XLA f32
      decoder (``backend="xla"``) and, on a subset, the float64 host oracle
      (ops/oracle.py), for min-sum and sum-product, early exit and fixed
      iterations, on the reference 32x64 code and a generated 128x256 code;
  (b) stream receiver: ``StreamReceiver`` on an offset, phase-inverted
      noisy stream; lock, and payload bytes against a plain decode of the
      aligned frames and against the bytes sent;
  (c) sweep step: ``make_sweep_step`` on a one-device mesh; frame-error
      counts against the Clopper-Pearson bands of a recorded waterfall;
  (d) composed chain: ``ops.dsp.rx_chain_pairs`` -> ``StreamReceiver`` on
      an impaired sample stream; lock and exact payload bytes.

``--multi`` runs the psum sweep on a 4-card "batch" mesh against serial
per-shard runs of the same keys, and ``shard_stream_decode`` on a 4-card
"stream" mesh against the unsharded decode of the same stream.

Every check raises on failure; nothing is caught on the way to the last
line, which is one JSON object {"ok": true, "device": {...}}. Printed wall
times are smoke times (first call includes compilation), not benchmark
numbers. Exits non-zero where JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from gr_ldpc_ece535a_tpu.codes import LdpcCode, get_code, make_ldpc  # noqa: E402
from gr_ldpc_ece535a_tpu.ops import (  # noqa: E402
    awgn, bpsk_map, encode_bits, encode_to_symbols, make_decoder, oracle,
    pack_bits_np, syndrome_weight)
from gr_ldpc_ece535a_tpu.ops.decode import BP_METHODS, decode_backend  # noqa: E402

WATERFALL = REPO / "results" / "waterfall_block_32_64_bp_1e7.json"
ORACLES = {"minsum": oracle.decode_log_domain_simple,
           "sumproduct": oracle.decode_sum_product_soft}
# repo bounds against the XLA f32 decoder on the same device: early exit
# may disagree on at most 16 frames in 4096 (frames at the decoding limit,
# where last-bit differences in tanh/log pick the other outcome); fixed
# iterations keep iterating converged frames, which can then wander, so
# at most 1% of the batch
EARLY_PER_4096 = 16
FIXED_FRACTION = 0.01
ALPHA = 1e-3  # two-sided 99.9% bands


def check(cond: bool, what: str, detail) -> None:
    """Raise unless ``cond``: the smoke run stops at the first failure."""
    if not cond:
        raise RuntimeError(f"FAILED {what}: {detail}")


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def generated_code() -> LdpcCode:
    """The generated 128x256 column-weight-3 code (768 edges)."""
    return LdpcCode.from_h(make_ldpc(128, 256, col_weight=3, seed=1),
                           name="gen_128_256")


def _bound(per_4096: float, n: int) -> int:
    return math.ceil(per_4096 * n / 4096)


def _frames(code, batch, seed, ebn0_db):
    kd, kn = jax.random.split(jax.random.PRNGKey(seed))
    d = jax.random.bernoulli(kd, 0.5, (batch, code.K)).astype(jnp.int8)
    return jax.block_until_ready(awgn(kn, bpsk_map(encode_bits(d, code)),
                                      ebn0_db))


def _compare(v, vx, H):
    """(frames differing, frames differing with both outputs valid, mask)."""
    diff = jnp.any(v != vx, axis=1)
    ok = (syndrome_weight(v, H) == 0) & (syndrome_weight(vx, H) == 0)
    return jnp.sum(diff), jnp.sum(diff & ok), diff


def phase_decode(code: LdpcCode, batch: int, iterations: int = 20,
                 subset: int = 4096, oracle_frames: int = 4096,
                 ebn0_db: float = 4.0, seed: int = 0) -> dict:
    """(a) default route vs XLA f32 vs f64 oracle, both BP methods, both
    loop forms."""
    rx = _frames(code, batch, seed, ebn0_db)
    subset = min(subset, batch)
    n_or = min(oracle_frames, batch)
    rx64 = np.asarray(rx[:n_or], np.float64)
    compare = jax.jit(lambda v, vx: _compare(v, vx, code.H))
    out = {}
    for method in BP_METHODS:
        route = decode_backend(code, method)
        for early in (True, False):
            dec = make_decoder(code, method, iterations, early_exit=early)
            ref = make_decoder(code, method, iterations, early_exit=early,
                               backend="xla")
            t0 = time.perf_counter()
            v = jax.block_until_ready(dec(rx))
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
            v = jax.block_until_ready(dec(rx))
            t_warm = time.perf_counter() - t0
            vx = ref(rx)
            n_diff, both_valid, diff = (np.asarray(a) for a in
                                        compare(v, vx))
            rec = {"code": code.name, "route": route, "batch": batch,
                   "iterations": iterations, "mismatch_vs_xla": int(n_diff),
                   "both_valid_different": int(both_valid),
                   "smoke_first_call_s": round(t_first, 4),
                   "smoke_warm_s": round(t_warm, 4)}
            if early:
                n_sub = int(diff[:subset].sum())
                rec["mismatch_vs_xla_first_%d" % subset] = n_sub
                check(n_sub <= _bound(EARLY_PER_4096, subset),
                      f"{code.name} {method} early exit vs XLA", rec)
                if method == "sumproduct":
                    check(both_valid == 0,
                          f"{code.name} sum-product two valid codewords", rec)
                # float64 oracle, reference semantics (early exit)
                vo = np.stack([ORACLES[method](r, code.H, iterations)
                               for r in rx64])
                m_dev = int((np.asarray(v[:n_or]) != vo).any(1).sum())
                m_xla = int((np.asarray(vx[:n_or]) != vo).any(1).sum())
                rec.update(oracle_frames=n_or, mismatch_vs_f64=m_dev,
                           xla_mismatch_vs_f64=m_xla)
                bound = _bound(EARLY_PER_4096, n_or)
                check(m_dev <= bound and m_xla <= bound,
                      f"{code.name} {method} vs f64 oracle", rec)
                rec["tolerance"] = (f"<= {EARLY_PER_4096}/4096 frames vs XLA "
                                    f"and vs f64; sum-product both-valid 0")
            else:
                check(n_diff <= FIXED_FRACTION * batch,
                      f"{code.name} {method} fixed iterations vs XLA", rec)
                rec["tolerance"] = f"<= {FIXED_FRACTION:.0%} of frames vs XLA"
            key = f"{code.name}/{method}/{'early' if early else 'fixed'}"
            log("a decode", case=key, **rec)
            out[key] = rec
    return out


def _plain_receive(stream, code, offset, inverted, n_frames, threshold,
                   iterations):
    """Plain reference of the receiver's payload: align, fix polarity,
    decode every frame, keep frames with syndrome weight <= threshold."""
    N = code.N
    frames = np.asarray(stream[offset:offset + n_frames * N], np.float32)
    frames = (-frames if inverted else frames).reshape(n_frames, N)
    dec = make_decoder(code, 0, iterations)
    vhat = dec(jnp.asarray(frames))
    w = np.asarray(syndrome_weight(vhat, code.H))
    acc = w <= threshold
    payload = pack_bits_np(np.asarray(vhat)[acc][:, code.M:].astype(np.uint8))
    return payload.reshape(-1).tobytes(), acc


def phase_receiver(code: LdpcCode, n_frames: int = 1 << 19, offset: int = 17,
                   ebn0_db: float = 6.0, iterations: int = 5,
                   seed: int = 1) -> dict:
    """(b) StreamReceiver on an offset, 180-degree-flipped noisy stream."""
    from gr_ldpc_ece535a_tpu.parallel import StreamReceiver

    kd, kn = jax.random.split(jax.random.PRNGKey(seed))
    data = jax.random.randint(kd, (n_frames, code.K // 8), 0, 256,
                              jnp.int32).astype(jnp.uint8)
    tx = encode_to_symbols(data, code).reshape(-1)
    stream = jnp.concatenate([jnp.zeros(offset, jnp.float32),
                              -awgn(kn, tx, ebn0_db=ebn0_db)])
    stream = jax.block_until_ready(stream)
    recv = StreamReceiver(code=code, iterations=iterations)
    t0 = time.perf_counter()
    res = recv.receive(stream, fetch_weights=False)
    t_first = time.perf_counter() - t0
    acq = res.acquisition
    rec = {"code": code.name, "frames": n_frames, "offset": offset,
           "ebn0_db": ebn0_db, "iterations": iterations,
           "lock": None if acq is None else [acq.offset, acq.inverted],
           "n_frames": res.n_frames, "accepted": int(res.accepted.sum()),
           "smoke_first_call_s": round(t_first, 3)}
    check(acq is not None and acq.offset == offset and acq.inverted,
          "receiver lock at the injected offset, inverted", rec)
    check(res.n_frames == n_frames, "receiver frame count", rec)
    # the receiver's chunking, acquisition, bitmask and byte assembly
    # must reproduce a plain decode of the aligned frames exactly
    want, acc = _plain_receive(np.asarray(stream), code, offset, True,
                               n_frames, recv.threshold, iterations)
    check(np.array_equal(acc, res.accepted) and res.data == want,
          "receiver payload vs plain decode", rec)
    # against the bytes sent: an accepted frame can still carry wrong
    # bits (a wrong codeword with syndrome weight <= threshold); their
    # count must fit the recorded frame-error rate at this Eb/N0
    sent = np.asarray(data)[acc]
    got = np.frombuffer(res.data, np.uint8).reshape(sent.shape)
    wrong = int((got != sent).any(1).sum())
    fer = _record_fer("minsum", ebn0_db)
    hi = _count_band(fer, n_frames)[1] if fer is not None else 0
    rec.update(accepted_wrong_vs_sent=wrong, accepted_wrong_bound=hi)
    check(wrong <= hi, "accepted frames vs bytes sent", rec)
    log("b receiver", **rec)
    return rec


def _record():
    return json.loads(WATERFALL.read_text())


def _record_fer(method: str, ebn0_db: float):
    r = _record()
    if r["iterations"] != 5:
        return None
    grid = np.asarray(r["ebn0_db"])
    i = int(np.argmin(np.abs(grid - ebn0_db)))
    if abs(grid[i] - ebn0_db) > 1e-9:
        return None
    return int(round(r["fer"][method][i] * r["frames_per_point"])), int(
        r["frames_per_point"])


def _count_band(rec_counts, n: int) -> tuple[int, int]:
    """Two-sided 99.9% band for a count out of ``n`` frames, given the
    record's count k of K frames: the record's Clopper-Pearson interval
    for the rate, widened by the binomial spread of n frames."""
    from scipy import stats

    k, K = rec_counts
    lo = stats.beta.ppf(ALPHA / 2, k, K - k + 1) if k > 0 else 0.0
    hi = stats.beta.ppf(1 - ALPHA / 2, k + 1, K - k) if k < K else 1.0
    return (int(stats.binom.ppf(ALPHA / 2, n, lo)),
            int(stats.binom.isf(ALPHA / 2, n, hi)))


def phase_sweep(code: LdpcCode, frames_per_device: int = 131072,
                points=(3.0, 5.0), seed: int = 7, mesh=None) -> dict:
    """(c) one sweep step per (method, point) on a one-device mesh; frame
    errors inside the recorded waterfall's 99.9% bands."""
    from gr_ldpc_ece535a_tpu.parallel import make_mesh, make_sweep_step

    r = _record()
    mesh = mesh or make_mesh(("batch",), devices=jax.devices()[:1])
    out = {}
    for method in r["methods"]:
        step = make_sweep_step(code, mesh, method=method,
                               iterations=r["iterations"],
                               frames_per_device=frames_per_device)
        for e in points:
            s = step(jax.random.PRNGKey(seed), e)
            k, n = int(s.frame_errors), int(s.n_frames)
            lo, hi = _count_band(_record_fer(method, e), n)
            rec = {"method": method, "ebn0_db": e, "frames": n,
                   "iterations": r["iterations"], "frame_errors": k,
                   "band_99.9": [lo, hi],
                   "route": decode_backend(code, method, mesh)}
            check(lo <= k <= hi, "sweep frame errors in the record's band",
                  rec)
            log("c sweep", **rec)
            out[f"{method}/{e}"] = rec
    return out


def impaired_pairs(code, n_frames, key, f_off=0.01, ppm=50e-6, noise=0.05,
                   sps=2):
    """(2, T) impaired sample planes (carrier offset, clock drift, AWGN) and
    the payload bytes sent, as the example4 flowgraph impairs them."""
    from gr_ldpc_ece535a_tpu.ops import dsp

    kd, kn = jax.random.split(key)
    data = jax.random.randint(kd, (n_frames, code.K // 8), 0, 256,
                              jnp.int32).astype(jnp.uint8)
    tx = encode_to_symbols(data, code).reshape(-1)
    shaped = dsp.pulse_shape(tx, sps, dsp.rrc_taps(sps, 0.35, 45))
    drifted = dsp.fractional_resample(shaped, 1.0 + ppm)
    xp = jnp.stack([drifted, jnp.zeros_like(drifted)])
    xp = dsp.mix_pairs(xp, -f_off)
    n = jax.random.normal(kn, (2, xp.shape[1]), jnp.float32)
    return xp + noise * n, data


def phase_chain(code: LdpcCode, n_frames: int = 65536, seed: int = 3) -> dict:
    """(d) rx_chain_pairs -> StreamReceiver at the example4 impairment:
    lock, and every accepted frame is one of the frames sent, in order."""
    from gr_ldpc_ece535a_tpu.ops import dsp
    from gr_ldpc_ece535a_tpu.parallel import StreamReceiver

    xp, data = impaired_pairs(code, n_frames, jax.random.PRNGKey(seed))
    xp = jax.block_until_ready(xp)
    chain = jax.jit(lambda x: dsp.rx_chain_pairs(
        x, sps=2, timing_block_syms=8192, timing_rate_clip=2.5e-4))
    t0 = time.perf_counter()
    syms = chain(xp)[0]
    res = StreamReceiver(code=code, iterations=5).receive(
        syms, fetch_weights=False)
    t_first = time.perf_counter() - t0
    acq = res.acquisition
    rec = {"code": code.name, "frames_sent": n_frames,
           "impairment": {"carrier_offset": 0.01, "clock_ppm": 50,
                          "noise": 0.05, "sps": 2},
           "locked": acq is not None, "n_frames": res.n_frames,
           "accepted": int(res.accepted.sum()),
           "smoke_first_call_s": round(t_first, 3)}
    check(acq is not None and res.accepted.any(), "chain lock", rec)
    sent = np.asarray(data)
    got = np.frombuffer(res.data, np.uint8).reshape(-1, sent.shape[1])
    idx = np.flatnonzero(res.accepted)
    # received frame i is sent frame i + k0 (frames lost at the stream
    # head shift the grid); exactly one k0 must match every accepted frame
    k0 = next((k for k in range(64) if idx[-1] + k < n_frames
               and np.array_equal(got, sent[idx + k])), None)
    rec.update(first_frame_sent_index=k0)
    check(k0 is not None, "chain payload bytes exact", rec)
    check(res.accepted.sum() >= 0.99 * res.n_frames,
          "chain frames accepted", rec)
    log("d chain", **rec)
    return rec


def phase_multi(code: LdpcCode, devices, frames_per_device: int = 131072,
                method: int = 1, iterations: int = 5) -> dict:
    """--multi: psum sweep on a 'batch' mesh vs serial per-shard runs of the
    same keys; shard_stream_decode on a 'stream' mesh vs the unsharded
    decode of the same stream. Both decode ``frames_per_device`` frames per
    card with the same method and iteration count."""
    from gr_ldpc_ece535a_tpu.parallel import (
        make_mesh, make_sweep_step, shard_stream_decode,
        stream_decode_reference)

    S = len(devices)
    key, ebn0 = jax.random.PRNGKey(42), 3.0
    mesh = make_mesh(("batch",), devices=devices)
    step = make_sweep_step(code, mesh, method=method, iterations=iterations,
                           frames_per_device=frames_per_device)
    got = np.asarray([float(x) for x in step(key, ebn0)][:4])
    want = sum(np.asarray([float(x) for x in step.shard_stats(key, ebn0, i)][:4])
               for i in range(S))
    rec = {"devices": S, "frames_per_device": frames_per_device,
           "method": method, "sharded": got.tolist(), "serial": want.tolist()}
    check(np.array_equal(got, want), "psum sweep vs serial shards", rec)
    log("multi sweep", **rec)

    offset, N = 17, code.N
    stream_frames = S * frames_per_device
    kd, kn = jax.random.split(jax.random.PRNGKey(5))
    data = jax.random.randint(kd, (stream_frames, code.K // 8), 0, 256,
                              jnp.int32).astype(jnp.uint8)
    tx = encode_to_symbols(data, code).reshape(-1)
    noisy = awgn(kn, tx, ebn0_db=4.0)
    stream = np.concatenate([np.zeros(offset, np.float32),
                             np.asarray(noisy)])[:stream_frames * N]
    smesh = make_mesh(("stream",), devices=devices)
    vs, ws = shard_stream_decode(jnp.asarray(stream), code, smesh,
                                 method=method, iterations=iterations,
                                 offset=offset)
    vr, wr = stream_decode_reference(stream, code, method=method,
                                     iterations=iterations, offset=offset)
    F = vr.shape[0]
    rec = {"devices": S, "stream_frames": stream_frames, "offset": offset,
           "method": method,
           "frames_compared": F,
           "mismatch_frames": int((np.asarray(vs)[:F] != vr).any(1).sum()),
           "weights_equal": bool(np.array_equal(np.asarray(ws)[:F], wr))}
    check(rec["mismatch_frames"] == 0 and rec["weights_equal"],
          "sharded stream decode vs unsharded", rec)
    log("multi stream", **rec)
    return rec


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card paths")
    args = ap.parse_args()
    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX platform "
                 f"{devices[0].platform!r})")
    from gr_ldpc_ece535a_tpu.utils import enable_persistent_compile_cache
    enable_persistent_compile_cache()
    print(card_line(), flush=True)
    code = get_code("block_32_64")
    t0 = time.perf_counter()
    if args.multi:
        if len(devices) < 4:
            sys.exit(f"chip_smoke --multi: needs 4 GPUs, found {len(devices)}")
        devices = devices[:4]
        phase_multi(code, devices)
    else:
        devices = devices[:1]
        phase_decode(code, batch=131072)
        phase_decode(generated_code(), batch=131072)
        phase_receiver(code)
        phase_sweep(code)
        phase_chain(code)
    print(f"smoke wall {time.perf_counter() - t0:.1f} s", flush=True)
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
