#!/usr/bin/env python3
"""Multi-process ("multi-host") sweep worker: one JAX process of N.

Stands in for one host of a cluster: ``jax.distributed.initialize`` +
CPU-gloo collectives give a real cross-process device mesh, the same
execution model as a multi-host run (each process sees all GLOBAL devices,
addresses only its local ones, and the psum in parallel/sweep.py rides the
collective fabric). Launched by tests/test_multihost.py and usable
standalone:

    python tools/multihost_worker.py <process_id> <num_processes> <port> \
        [devices_per_process] [frames_per_device] [mode]

mode "sweep" (default): process 0 prints one JSON line with the globally
aggregated SweepStats — which must be bit-identical to a single-process run
over the same number of devices (the sweep folds the PRNG key by GLOBAL
axis index, so the sharding topology is invisible to the statistics).

mode "stream": runs ``shard_stream_decode`` — the ppermute N-1-symbol halo
exchange — over the cross-process mesh on a deterministic noisy stream with
a 17-symbol frame offset, and prints integer digests of the decoded frames
and syndrome weights. The halo of the process-boundary shard crosses a REAL
process boundary here (the round-2 VERDICT's untested collective); digests
must be bit-identical to the single-process run, and the 1-process worker
additionally asserts its sharded result equals the unsharded oracle.

mode "bench": weak-scaling wall-clock — times the jitted sweep step (decode
+ psum-aggregated stats) over the global mesh at a FIXED per-device frame
count and prints steps/s and frames/s from process 0.

Launcher: ``python tools/multihost_worker.py --bench [frames_per_device]``
spawns the 1-process x 2-device and 2-process x 2-device-each
configurations back to back and prints the weak-scaling efficiency
t(1 proc) / t(2 proc). ``--bench-stream`` does the same for the halo
path (shard_stream_decode, whose (N-1)-symbol ppermute crosses the
process boundary — BASELINE config 5's collective). On this CPU-gloo fabric the number is a
methodology check, not a hardware claim: CPU mesh collectives share one
machine's memory bus, so the printed efficiency under- or over-states what
a real interconnect would deliver; the identical command on real hosts
(minus the CPU forcing) produces the claimable number.
"""

import json
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", int(sys.argv[4]) if len(sys.argv) > 4 else 2)
jax.config.update("jax_cpu_collectives_implementation", "gloo")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _run_sweep(frames: int) -> dict:
    from gr_ldpc_ece535a_tpu.codes import get_code
    from gr_ldpc_ece535a_tpu.parallel.mesh import make_mesh
    from gr_ldpc_ece535a_tpu.parallel.sweep import make_sweep_step

    code = get_code("block_32_64")
    mesh = make_mesh(("batch",))  # over all GLOBAL devices
    step = make_sweep_step(code, mesh, method=0, iterations=5,
                           frames_per_device=frames)
    stats = step(jax.random.PRNGKey(0), 4.0)
    return {k: float(v) for k, v in stats._asdict().items()}


def _run_stream(frames_per_device: int) -> dict:
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gr_ldpc_ece535a_tpu.codes import get_code
    from gr_ldpc_ece535a_tpu.ops import bpsk_map, encode_bits
    from gr_ldpc_ece535a_tpu.parallel.mesh import make_mesh
    from gr_ldpc_ece535a_tpu.parallel.stream import (
        shard_stream_decode, stream_decode_reference)

    code = get_code("block_32_64")
    N = code.N
    S = jax.device_count()
    offset = 17
    nfr = frames_per_device * S
    T = nfr * N
    # deterministic stream, constructed identically on every process
    rng = np.random.default_rng(7)
    data = rng.integers(0, 2, (nfr, code.K)).astype(np.int8)
    tx = np.asarray(bpsk_map(encode_bits(jnp.asarray(data), code))
                    ).reshape(-1)
    stream = np.zeros(T, np.float32)
    avail = T - offset
    stream[offset:] = tx[:avail] + rng.normal(0.0, 0.4, avail)
    mesh = make_mesh(("stream",))
    sh = NamedSharding(mesh, P("stream"))
    garr = jax.make_array_from_callback((T,), sh,
                                        lambda idx: stream[idx])
    vhat, w = shard_stream_decode(garr, code, mesh, method=0, iterations=5,
                                  offset=offset)
    # integer digests (replicated scalars every process can read). The last
    # frame's tail wraps the ring halo into the stream head (offset > 0), so
    # digests cover the nfr-1 fully-contained frames only — the same set the
    # unsharded oracle decodes.
    F = nfr - 1
    cv = np.random.default_rng(11).integers(1, 1 << 16, (F, N)
                                            ).astype(np.int64)
    cw = np.random.default_rng(12).integers(1, 1 << 16, F).astype(np.int64)

    @jax.jit
    def digest(v, wt):
        return (jnp.sum(v[:F].astype(jnp.int64) * jnp.asarray(cv)),
                jnp.sum(wt[:F].astype(jnp.int64) * jnp.asarray(cw)))

    dv, dw = digest(vhat, w)
    out = {"digest_vhat": int(dv), "digest_w": int(dw), "n_frames": F}
    if jax.process_count() == 1:
        ref_v, ref_w = stream_decode_reference(stream, code, method=0,
                                               iterations=5, offset=offset)
        assert int((ref_v[:F].astype(np.int64) * cv).sum()) == int(dv), \
            "sharded decode != unsharded oracle (vhat digest)"
        assert int((ref_w[:F].astype(np.int64) * cw).sum()) == int(dw), \
            "sharded decode != unsharded oracle (weight digest)"
        out["oracle_checked"] = True
    return out


def _run_bench(frames_per_device: int, reps: int = 20) -> dict:
    import time

    from gr_ldpc_ece535a_tpu.codes import get_code
    from gr_ldpc_ece535a_tpu.parallel.mesh import make_mesh
    from gr_ldpc_ece535a_tpu.parallel.sweep import make_sweep_step

    code = get_code("block_32_64")
    mesh = make_mesh(("batch",))
    step = make_sweep_step(code, mesh, method=0, iterations=5,
                           frames_per_device=frames_per_device)
    key = jax.random.PRNGKey(0)
    for _ in range(2):          # compile + warm
        jax.block_until_ready(step(key, 4.0))
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(step(key, 4.0))
    dt = (time.perf_counter() - t0) / reps
    g = jax.device_count()
    return {
        "mode": "bench",
        "frames_per_device": frames_per_device,
        "step_wall_s": dt,
        "steps_per_s": 1.0 / dt,
        "frames_per_s_global": frames_per_device * g / dt,
    }


def _run_bench_stream(frames_per_device: int, reps: int = 10) -> dict:
    """Weak-scaling wall-clock of the HALO path (BASELINE config 5):
    shard_stream_decode over the global mesh — each step moves the
    (N-1)-symbol ppermute halo across every shard boundary, including
    the process boundary when nproc > 1."""
    import time

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gr_ldpc_ece535a_tpu.codes import get_code
    from gr_ldpc_ece535a_tpu.parallel.mesh import make_mesh
    from gr_ldpc_ece535a_tpu.parallel.stream import _sharded_stream_runner

    code = get_code("block_32_64")
    N = code.N
    S = jax.device_count()
    T = frames_per_device * S * N
    rng = np.random.default_rng(7)
    stream = rng.normal(0.0, 1.0, T).astype(np.float32)
    mesh = make_mesh(("stream",))
    sh = NamedSharding(mesh, P("stream"))
    garr = jax.make_array_from_callback((T,), sh, lambda idx: stream[idx])
    run = _sharded_stream_runner(code, mesh, 0, 5, 0, "stream")
    for _ in range(2):
        _, w = run(garr)
        jnp.sum(w).block_until_ready()
    t0 = time.perf_counter()
    for _ in range(reps):
        _, w = run(garr)
        jnp.sum(w).block_until_ready()
    dt = (time.perf_counter() - t0) / reps
    return {
        "mode": "bench_stream",
        "frames_per_device": frames_per_device,
        "step_wall_s": dt,
        "frames_per_s_global": frames_per_device * S / dt,
    }


def _bench_launcher(frames_per_device: int, stream: bool = False) -> None:
    """Weak-scaling efficiency, 1 process -> 2 processes (same per-device
    work). Spawns the workers itself; prints one JSON line. stream=True
    benches the halo (shard_stream_decode) path instead of the psum
    sweep."""
    import os
    import socket
    import subprocess

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    results = {}
    mode = "bench_stream" if stream else "bench"
    for nproc, dev_per in ((1, 2), (2, 2)):
        port = free_port()
        procs = [
            subprocess.Popen(
                [sys.executable, __file__, str(pid), str(nproc), str(port),
                 str(dev_per), str(frames_per_device), mode],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=dict(os.environ))
            for pid in range(nproc)
        ]
        outs, errs = [], []
        try:
            for p in procs:
                o, e = p.communicate(timeout=600)
                outs.append(o)
                errs.append(e)
        finally:
            for p in procs:        # a timeout must not orphan siblings
                if p.poll() is None:
                    p.kill()
        if any(p.returncode for p in procs):
            raise RuntimeError(
                f"worker failed for nproc={nproc}; stderr tails: "
                + " | ".join(e.strip()[-400:] for e in errs))
        results[nproc] = json.loads(outs[0].strip().splitlines()[-1])
    t1, t2 = results[1]["step_wall_s"], results[2]["step_wall_s"]
    print(json.dumps({
        "metric": f"weak_scaling_efficiency_1to2proc_{mode}",
        "value": t1 / t2,
        "fabric": "cpu-gloo (methodology check, not a hardware number)",
        "one_proc": results[1],
        "two_proc": results[2],
    }))


def main() -> None:
    if sys.argv[1:2] == ["--bench"]:
        _bench_launcher(int(sys.argv[2]) if len(sys.argv) > 2 else 2048)
        return
    if sys.argv[1:2] == ["--bench-stream"]:
        _bench_launcher(int(sys.argv[2]) if len(sys.argv) > 2 else 512,
                        stream=True)
        return
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    frames = int(sys.argv[5]) if len(sys.argv) > 5 else 64
    mode = sys.argv[6] if len(sys.argv) > 6 else "sweep"
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    if mode == "sweep":
        out = _run_sweep(frames)
    elif mode == "bench":
        out = _run_bench(frames)
    elif mode == "bench_stream":
        out = _run_bench_stream(frames)
    else:
        out = _run_stream(frames)
    out["n_global_devices"] = jax.device_count()
    out["n_local_devices"] = jax.local_device_count()
    out["process_id"] = pid
    if pid == 0:
        print(json.dumps(out))
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
