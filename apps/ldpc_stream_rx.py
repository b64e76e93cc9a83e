#!/usr/bin/env python3
"""Mesh-sharded streaming receiver app (receiver.grc at pod scale).

Reads a recorded complex64 symbol stream (e.g. /tmp/ldpc_link.c64 written by
`apps/ldpc_flowgraph.py examples/transmitter.yaml`), acquires frame sync
(offset + polarity) with one batched search, then decodes the entire stream
sharded over the device mesh's "stream" axis with halo exchange — the
scale-out alternative to the sequential sync walk in the decoder block.
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
    ap.add_argument("--in", dest="infile", default="/tmp/ldpc_link.c64",
                    help="recorded complex64 symbol stream")
    ap.add_argument("--out", default=None,
                    help="write decoded bytes here (default: stdout as ASCII)")
    ap.add_argument("--image-out", default=None,
                    help="feed decoded bytes to an image sink writing here")
    ap.add_argument("--method", type=int, default=0)
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--chain", action="store_true",
                    help="input is a raw SAMPLE stream (e.g. 2 samples/"
                         "symbol off a channel with carrier offset and "
                         "clock drift): run the device-resident receive "
                         "chain (AGC -> matmul-DFT CFO -> polyphase "
                         "timing -> V&V carrier, complex-free pair form) "
                         "before frame sync")
    ap.add_argument("--sps", type=int, default=2,
                    help="samples/symbol for --chain")
    ap.add_argument("--timing-block-syms", type=int, default=64,
                    help="--chain tracking block (256 = fastest, locks "
                         "to ~60 ppm drift)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (8 virtual devices)")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)

    import numpy as np

    from gr_ldpc_ece535a_tpu.parallel import StreamReceiver

    symbols = np.fromfile(args.infile, np.complex64)
    rx = StreamReceiver(method=args.method, iterations=args.iterations)
    if args.chain:
        import jax.numpy as jnp

        from gr_ldpc_ece535a_tpu.ops import dsp

        xp = jnp.asarray(np.stack([symbols.real, symbols.imag])
                         .astype(np.float32))
        sp = dsp.rx_chain_pairs(xp, sps=args.sps,
                                timing_block_syms=args.timing_block_syms)
        res = rx.receive(sp[0])          # real plane feeds the frame sync
    else:
        res = rx.receive(symbols)
    if res.acquisition is None:
        print("no sync lock found", file=sys.stderr)
        sys.exit(1)
    a = res.acquisition
    print(f"locked: offset={a.offset} inverted={a.inverted} "
          f"frames={res.n_frames} accepted={int(res.accepted.sum())}",
          file=sys.stderr)
    if args.image_out:
        from gr_ldpc_ece535a_tpu.blocks import (
            FlowGraph, ImageSink, VectorSource)
        fg = FlowGraph()
        sink = ImageSink(out_path=args.image_out, verbose=False)
        fg.connect(VectorSource(np.frombuffer(res.data, np.uint8)), sink)
        fg.run()
        print(f"images written: {sink.images_written}", file=sys.stderr)
    elif args.out:
        Path(args.out).write_bytes(res.data)
    else:
        sys.stdout.write(res.data.decode("latin-1"))


if __name__ == "__main__":
    main()
