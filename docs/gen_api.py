#!/usr/bin/env python
"""Generate docs/API.md — the rendered API reference.

The reference ships doxygen + swig_doc.py machinery
(/root/reference/docs/doxygen/, ~2,600 lines) to turn C++ comments into
Python docstrings; here the docstrings ARE the source of truth (they cite
reference file:line throughout), and this script renders them into one
browsable markdown artifact.  Stdlib-only, deterministic.

Usage:  python docs/gen_api.py          (writes docs/API.md)
        python docs/gen_api.py --check  (fails if API.md is stale)
"""

from __future__ import annotations

import importlib
import inspect
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MODULES = [
    "ltetrigger_jax",
    "ltetrigger_jax.models.api",
    "ltetrigger_jax.models.multi",
    "ltetrigger_jax.models.wideband",
    "ltetrigger_jax.models.trigger",
    "ltetrigger_jax.runtime.cellstore",
    "ltetrigger_jax.runtime.native",
    "ltetrigger_jax.runtime.chunkbuf",
    "ltetrigger_jax.parallel.mesh",
    "ltetrigger_jax.parallel.sharded",
    "ltetrigger_jax.ops.correlate",
    "ltetrigger_jax.ops.sync",
    "ltetrigger_jax.ops.cfo",
    "ltetrigger_jax.ops.pbch",
    "ltetrigger_jax.ops.viterbi",
    "ltetrigger_jax.ops.resample",
    "ltetrigger_jax.ops.channelize",
    "ltetrigger_jax.ops.cplx",
    "ltetrigger_jax.ops.dft",
    "ltetrigger_jax.ltecore.constants",
    "ltetrigger_jax.ltecore.synth",
    "ltetrigger_jax.ltecore.refrx",
    "ltetrigger_jax.apps.cell_search_file",
    "ltetrigger_jax.apps.snr_sweep",
    "ltetrigger_jax.apps.live_monitor",
    "ltetrigger_jax.apps.wideband_scan",
    "ltetrigger_jax.apps.run_flowgraph",
    "ltetrigger_jax.utils.eng_notation",
    "ltetrigger_jax.utils.profiling",
]


def _sig(obj) -> str:
    try:
        # path defaults render relative to the checkout, so the document
        # does not depend on where the repository lives
        return str(inspect.signature(obj)).replace(ROOT, "<checkout>")
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj, indent: str = "") -> str:
    d = inspect.getdoc(obj)
    if not d:
        return ""
    return "\n".join(indent + ln for ln in d.splitlines())


def _is_public(name: str) -> bool:
    return not name.startswith("_")


def render() -> str:
    out = ["# ltetrigger_jax — API reference",
           "",
           "Generated by `docs/gen_api.py` from the live docstrings "
           "(which cite reference file:line for parity checking).  "
           "Regenerate with `python docs/gen_api.py`.",
           ""]
    for modname in MODULES:
        mod = importlib.import_module(modname)
        out.append(f"## `{modname}`")
        out.append("")
        md = _doc(mod)
        if md:
            out.append(md)
            out.append("")
        members = sorted(vars(mod).items())
        for name, obj in members:
            if not _is_public(name):
                continue
            if getattr(obj, "__module__", None) != modname:
                continue
            if inspect.isclass(obj):
                out.append(f"### class `{name}{_sig(obj)}`")
                out.append("")
                cd = _doc(obj)
                if cd:
                    out.append(cd)
                    out.append("")
                for mname, meth in sorted(vars(obj).items()):
                    if not _is_public(mname):
                        continue
                    if isinstance(meth, property):
                        out.append(f"* **`{mname}`** (property) — "
                                   + (inspect.getdoc(meth) or "").strip()
                                   .split("\n")[0])
                    elif inspect.isfunction(meth):
                        out.append(f"* **`{mname}{_sig(meth)}`**")
                        d1 = _doc(meth, "  ")
                        if d1:
                            out.append("")
                            out.append(d1)
                    else:
                        continue
                    out.append("")
            elif inspect.isfunction(obj):
                out.append(f"### `{name}{_sig(obj)}`")
                out.append("")
                fd = _doc(obj)
                if fd:
                    out.append(fd)
                    out.append("")
        out.append("")
    return "\n".join(out).rstrip() + "\n"


def main():
    path = os.path.join(ROOT, "docs", "API.md")
    text = render()
    if "--check" in sys.argv:
        with open(path) as f:
            if f.read() != text:
                print("docs/API.md is stale — run python docs/gen_api.py")
                return 1
        print("docs/API.md up to date")
        return 0
    with open(path, "w") as f:
        f.write(text)
    print(f"wrote {path} ({len(text.splitlines())} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
