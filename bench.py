"""Decode benchmark on one GPU: decoded info bits/s at 20 BP iterations.

Times the belief-propagation decoders (min-sum = the reference's default
method 0, /root/reference/lib/ldpc_decoder_cb_impl.cc:309; sum-product =
method 1, :478) on the reference 32x64 code over a 131072-frame batch
generated on the device, through ``make_decoder``'s default route and
through the XLA decoders (``backend="xla"``). Each time is the median of
host-clock walls around ``jax.block_until_ready`` after a warm-up call.
Also records the hard-decision parity counters (default route vs XLA f32,
early exit) and the stream receiver end to end.

Prints one JSON line with the device's platform, kind, count and the card's
name and power limit. Exits non-zero without a GPU.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

ITERATIONS = 20
BATCH = 1 << 17  # 131072 frames resident
REPS = 5


def _make_inputs(code, batch, key, ebn0_db=4.0):
    from gr_ldpc_ece535a_tpu.ops import awgn, bpsk_map, encode_bits

    kd, kn = jax.random.split(key)
    d = jax.random.bernoulli(kd, 0.5, (batch, code.K)).astype(jnp.int8)
    return awgn(kn, bpsk_map(encode_bits(d, code)), ebn0_db=ebn0_db)


def time_call(fn, *args, reps: int = REPS) -> float:
    """Median host-clock seconds of ``fn(*args)`` to completion, after one
    warm-up call (which compiles)."""
    jax.block_until_ready(fn(*args))
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def _bench_parity(code, rx):
    """Default route vs XLA f32 under the reference's early-exit semantics,
    with the mismatches split by syndrome outcome: 'both_valid_different'
    (two different valid codewords) is the only bin that could silently
    corrupt accepted data."""
    from gr_ldpc_ece535a_tpu.ops import make_decoder, syndrome_weight

    out = {"parity_frames": int(rx.shape[0]), "parity_ebn0_db": 4.0}
    for name in ("minsum", "sumproduct"):
        v = make_decoder(code, name, ITERATIONS)(rx)
        vx = make_decoder(code, name, ITERATIONS, backend="xla")(rx)
        diff = np.asarray(jnp.any(v != vx, axis=1))
        ok_v = np.asarray(syndrome_weight(v, code.H) == 0)
        ok_x = np.asarray(syndrome_weight(vx, code.H) == 0)
        out[f"mismatch_{name}"] = int(diff.sum())
        out[f"mismatch_{name}_decomp"] = {
            "both_syndrome_fail": int((diff & ~ok_v & ~ok_x).sum()),
            "both_valid_different": int((diff & ok_v & ok_x).sum()),
            "only_xla_valid": int((diff & ok_x & ~ok_v).sum()),
            "only_default_valid": int((diff & ok_v & ~ok_x).sum()),
        }
    return out


def _bench_receiver(code, n_frames: int = 1 << 19, offset: int = 17):
    """End-to-end streaming receive of an offset, phase-inverted stream
    held on the device: acquisition + decode + byte repack + fetch + host
    accept. A second, profiled pass splits decode from transfer."""
    from gr_ldpc_ece535a_tpu.ops import awgn, encode_to_symbols
    from gr_ldpc_ece535a_tpu.parallel import StreamReceiver

    kd, kn = jax.random.split(jax.random.PRNGKey(1))
    data = jax.random.randint(kd, (n_frames, code.K // 8), 0, 256, jnp.int32
                              ).astype(jnp.uint8)
    tx = encode_to_symbols(data, code).reshape(-1)
    stream = jax.block_until_ready(jnp.concatenate(
        [jnp.zeros(offset, jnp.float32), -awgn(kn, tx, ebn0_db=6.0)]))
    recv = StreamReceiver(code=code, iterations=5)
    recv.receive(stream, fetch_weights=False)  # compile at this shape/offset
    t0 = time.perf_counter()
    out = recv.receive(stream, fetch_weights=False)
    dt = time.perf_counter() - t0
    ok = out.acquisition is not None and out.acquisition.offset == offset
    recv.receive(stream, fetch_weights=False, profile=True)
    prof = recv.receive(stream, fetch_weights=False, profile=True)
    return {
        "stream_receiver_info_bits_per_s": len(out.data) * 8 / dt,
        "stream_receiver_frames": out.n_frames,
        "stream_receiver_locked": bool(ok and out.acquisition.inverted),
        "stream_receiver_breakdown": prof.timings,
    }


def main() -> None:
    from gr_ldpc_ece535a_tpu.codes import get_code
    from gr_ldpc_ece535a_tpu.ops import make_decoder
    from gr_ldpc_ece535a_tpu.ops.decode import decode_backend
    from gr_ldpc_ece535a_tpu.utils import enable_persistent_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: no GPU (JAX platform {dev.platform!r})")
    enable_persistent_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    code = get_code("block_32_64")
    rx = jax.block_until_ready(_make_inputs(code, BATCH, jax.random.PRNGKey(0)))

    seconds = {}
    for name in ("minsum", "sumproduct"):
        route = decode_backend(code, name)
        for label, backend in ((route, None), ("xla", "xla")):
            if f"{name}_{label}" in seconds:
                continue
            dec = make_decoder(code, name, ITERATIONS, early_exit=False,
                               backend=backend)
            seconds[f"{name}_{label}"] = time_call(dec, rx)
    bits = {k: BATCH * code.K / v for k, v in seconds.items()}
    best = max(bits, key=bits.get)
    print(json.dumps({
        "metric": "decoded_info_bits_per_s_20bp_iters",
        "value": bits[best],
        "unit": "bits/s",
        "best_path": best,
        "batch": BATCH,
        "seconds_per_decode": seconds,
        "all_paths_bits_per_s": bits,
        **_bench_parity(code, rx),
        **_bench_receiver(code),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))


if __name__ == "__main__":
    main()
