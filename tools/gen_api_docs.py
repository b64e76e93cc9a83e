#!/usr/bin/env python3
"""Generate docs/api.md from the package's public API docstrings.

The analog of the reference's docs machinery
(/root/reference/docs/doxygen: a Doxygen -> SWIG-docstring pipeline whose
project content was empty boilerplate). This walks every public submodule,
collects `__all__` symbols with their signatures and docstrings, and writes
one markdown reference. Regenerate after API changes:

    python tools/gen_api_docs.py
"""

from __future__ import annotations

import importlib
import inspect
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

MODULES = [
    "gr_ldpc_ece535a_tpu.codes",
    "gr_ldpc_ece535a_tpu.ops",
    "gr_ldpc_ece535a_tpu.ops.pallas_bp",
    "gr_ldpc_ece535a_tpu.ops.dsp",
    "gr_ldpc_ece535a_tpu.blocks",
    "gr_ldpc_ece535a_tpu.blocks.graphcfg",
    "gr_ldpc_ece535a_tpu.parallel",
    "gr_ldpc_ece535a_tpu.sim",
    "gr_ldpc_ece535a_tpu.runtime",
    "gr_ldpc_ece535a_tpu.utils.config",
    "gr_ldpc_ece535a_tpu.utils.profiling",
    "gr_ldpc_ece535a_tpu.utils.bmp",
]


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d if d else "*(no docstring)*"


def _emit_symbol(out: list[str], name: str, obj) -> None:
    if inspect.isclass(obj):
        out.append(f"### class `{name}{_sig(obj)}`\n")
        out.append(_doc(obj) + "\n")
        methods = [
            (m, fn) for m, fn in vars(obj).items()
            if not m.startswith("_") and callable(fn)
        ]
        for m, fn in methods:
            if inspect.getdoc(fn):
                out.append(f"**`.{m}{_sig(fn)}`** — {inspect.getdoc(fn)}\n")
    elif callable(obj):
        out.append(f"### `{name}{_sig(obj)}`\n")
        out.append(_doc(obj) + "\n")
    else:
        out.append(f"### `{name}`\n")
        out.append(f"`{type(obj).__name__}` constant: `{obj!r}`"[:400] + "\n")


def main() -> None:
    out: list[str] = [
        "# API reference — gr_ldpc_ece535a_tpu",
        "",
        "Generated by `tools/gen_api_docs.py` from the public (`__all__`)",
        "docstrings. Reference parity citations (file:line into",
        "`/root/reference`) live in the docstrings themselves.",
        "",
    ]
    for modname in MODULES:
        mod = importlib.import_module(modname)
        out.append(f"\n## `{modname}`\n")
        mdoc = inspect.getdoc(mod)
        if mdoc:
            out.append(mdoc.split("\n\n")[0] + "\n")
        names = getattr(mod, "__all__", None)
        if names is None:
            names = [n for n in vars(mod) if not n.startswith("_")]
        for name in names:
            obj = getattr(mod, name)
            if inspect.ismodule(obj):
                continue
            _emit_symbol(out, name, obj)
    path = REPO / "docs" / "api.md"
    path.write_text("\n".join(out))
    n_sections = sum(1 for line in out if line.startswith("### "))
    print(f"wrote {path} ({n_sections} symbols, {len(out)} lines)")


if __name__ == "__main__":
    main()
