#!/usr/bin/env python3
"""BER/FER waterfall sweep app (ldpc_lapack / ldpc_umfpack equivalent).

Reference: /root/reference/apps/ldpc_lapack.cpp:533-820 — Monte-Carlo sweep
over an Eb/N0 grid with 4 decoders on the (100,50) code, printing a MATLAB
plot script. This app runs the same experiment mesh-sharded at batch scale
and can emit the Octave script, a JSON dump, and a PNG.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    from gr_ldpc_ece535a_tpu.utils import enable_persistent_compile_cache
    enable_persistent_compile_cache()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--code", default="sim_50_100",
                    help="code registry name (see codes.list_codes)")
    ap.add_argument("--start-db", type=float, default=-7.0)
    ap.add_argument("--stop-db", type=float, default=10.0)
    ap.add_argument("--step-db", type=float, default=0.5)
    ap.add_argument("--points", type=int, default=None,
                    help="override: evenly spaced point count start..stop")
    ap.add_argument("--frames-per-point", type=int, default=30_000)
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--methods", default="hard,bitflip,minsum,sumproduct",
                    help="comma list; also available: bitflip_mp (the "
                         "ldpc_umfpack app's message-passing variant)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--octave", action="store_true",
                    help="print the MATLAB/Octave plot script (reference format)")
    ap.add_argument("--json", default=None, help="write results JSON here")
    ap.add_argument("--png", default=None, help="write waterfall plot PNG here")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (8 virtual devices)")
    ap.add_argument("--checkpoint", default=None,
                    help="JSONL checkpoint: completed Eb/N0 points are "
                         "skipped on rerun with the same configuration")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)

    import numpy as np

    from gr_ldpc_ece535a_tpu.sim import run_waterfall

    if args.points:
        grid = np.linspace(args.start_db, args.stop_db, args.points)
    else:
        grid = np.arange(args.start_db, args.stop_db + args.step_db / 2,
                         args.step_db)
    res = run_waterfall(
        code=args.code, ebn0_db=grid,
        frames_per_point=args.frames_per_point,
        iterations=args.iterations,
        methods=tuple(args.methods.split(",")),
        seed=args.seed, progress=True,
        checkpoint=args.checkpoint)
    print(res.to_table())
    print(f"# {res.frames_per_point} frames/point, wall {res.wall_s:.1f}s")
    if args.octave:
        print(res.to_octave())
    if args.json:
        Path(args.json).write_text(res.to_json())
        print(f"wrote {args.json}")
    if args.png:
        res.plot(args.png)
        print(f"wrote {args.png}")


if __name__ == "__main__":
    main()
