#!/usr/bin/env python3
"""ASCII loopback dump app (ldpc_ece535a_dump equivalent).

Reference: /root/reference/apps/ldpc_ece535a_dump:35-61 — random printable
bytes -> throttle -> LDPC encode -> decode -> dump_sink printing ASCII.
Here the throttle is optional (the reference throttles to 1000 B/s only so
a human can watch); default runs unthrottled batches.
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
    ap.add_argument("--frames", type=int, default=256,
                    help="number of 4-byte frames to stream")
    ap.add_argument("--method", type=int, default=0,
                    help="decoder: 0=LogDomain 1=SumProduct 2=BitFlip 3=Hard")
    ap.add_argument("--ebn0-db", type=float, default=None,
                    help="add AWGN at this Eb/N0 (default: clean loopback)")
    ap.add_argument("--rate", type=float, default=None,
                    help="throttle to N bytes/s (reference uses 1000)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from gr_ldpc_ece535a_tpu.blocks import (
        AwgnBlock, DumpSink, FlowGraph, LdpcDecoderBlock, LdpcEncoderBlock,
        RandomSource, Throttle)

    fg = FlowGraph()
    src = RandomSource(32, 127, total=args.frames * 4, seed=args.seed)
    enc = LdpcEncoderBlock()
    dec = LdpcDecoderBlock(method=args.method)
    dump = DumpSink()
    chain = [src]
    if args.rate:
        chain.append(Throttle(args.rate))
    chain.append(enc)
    if args.ebn0_db is not None:
        chain.append(AwgnBlock(args.ebn0_db, seed=args.seed + 1))
    chain += [dec, dump]
    fg.connect(*chain)
    fg.run()
    print()


if __name__ == "__main__":
    main()
