#!/usr/bin/env python3
"""Run a declarative YAML flowgraph (GRC equivalent).

Usage:
    python apps/ldpc_flowgraph.py examples/example1.yaml
    python apps/ldpc_flowgraph.py examples/example6.yaml -p chan.noise_voltage=0.2

-p overrides block parameters: ``-p block.param=value`` (value parsed as YAML,
the CLI analog of moving a GRC slider).
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
    ap.add_argument("graph", help="YAML flowgraph path")
    ap.add_argument("-p", "--param", action="append", default=[],
                    metavar="BLOCK.PARAM=VALUE", help="override a block param")
    ap.add_argument("--cpu", action="store_true", help="force the CPU backend")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import yaml

    overrides: dict[str, dict] = {}
    for spec in args.param:
        try:
            target, value = spec.split("=", 1)
            bname, pname = target.split(".", 1)
        except ValueError:
            ap.error(f"bad -p {spec!r}; expected block.param=value")
        overrides.setdefault(bname, {})[pname] = yaml.safe_load(value)

    from gr_ldpc_ece535a_tpu.blocks import run_flowgraph

    blocks = run_flowgraph(args.graph, overrides=overrides)
    # post-run report for sink blocks
    for name, b in blocks.items():
        if getattr(b, "images_written", None) is not None:
            print(f"{name}: images_written={b.images_written}")
        if getattr(b, "count", None) is not None:
            print(f"{name}: items={b.count}")


if __name__ == "__main__":
    main()
