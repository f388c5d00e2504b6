"""Registers, stack and spills of every instantiation of the port's CUDA
kernels, as ``nvcc -Xptxas -v`` reports them, for this tree and for
others (a parent commit unpacked with ``git archive`` into a gitignored
directory), so a change's register allocation is read beside its
parent's.

    python3 tools/kernel_registers.py [--root DIR ...] [--kernel NAME]

Each tree's kernel library is built into a fresh temporary directory by
its own ``raytracing_tpu_torch._kernels.library()`` in a process of its
own (so each imports its own package, and a library built earlier cannot
hide the compiler's report). Prints one line per kernel instantiation
(``chip_smoke.ptxas_summary``), those whose name holds ``--kernel`` (all
without it), under a heading per tree, then one JSON line with the
instantiations whose registers, stack or spills differ between the first
tree and each other one. An instantiation of another tree is matched to
this tree's with the same switches or, where this tree's template has
gained a last switch, with that switch off (``<1,0,0,0,1>`` is
``<1,0,0,0,1,0>``). Needs ``nvcc`` (the machine with the card).
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import ptxas_summary  # noqa: E402

BUILD = r"""
import sys, tempfile
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from raytracing_tpu_torch import _kernels
_kernels.BUILD_DIR = Path(tempfile.mkdtemp(prefix="rt_kernels_"))
print(_kernels.library().build_log)
"""


def report(root: Path) -> list:
    out = subprocess.run([sys.executable, "-c", BUILD, str(root)], capture_output=True,
                         text=True, cwd=root)
    if out.returncode != 0:
        raise RuntimeError(f"building the kernels of {root} failed:\n{out.stderr[-4000:]}")
    return ptxas_summary(out.stdout)


def numbers(line: str) -> tuple:
    """(registers, stack frame bytes, spill store bytes, spill load bytes)."""
    def first(pat):
        m = re.search(pat, line)
        return int(m.group(1)) if m else None

    return (first(r"Used (\d+) registers"), first(r"(\d+) bytes stack frame"),
            first(r"(\d+) bytes spill stores"), first(r"(\d+) bytes spill loads"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", default=[],
                    help="another tree to report beside this one (repeatable)")
    ap.add_argument("--kernel", default="", help="only instantiations whose name holds this")
    args = ap.parse_args(argv)
    trees = [ROOT, *(Path(r).resolve() for r in args.root)]
    tables = {}
    for tree in trees:
        lines = [x for x in report(tree) if args.kernel in x.split(":", 1)[0]]
        print(f"== {tree} ({len(lines)} instantiations)")
        for x in lines:
            print(f"  {x}")
        tables[str(tree)] = {x.split(":", 1)[0]: numbers(x) for x in lines}
    base = tables[str(ROOT)]

    def this(key):
        return base.get(key, base.get(key[:-1] + ",0>") if key.endswith(">") else None)

    diff = {}
    for tree, table in list(tables.items())[1:]:
        diff[tree] = {k: {"this": this(k), "other": v} for k, v in table.items()
                      if this(k) != v}
    print(json.dumps({"fields": ["registers", "stack", "spill_stores", "spill_loads"],
                      "differs_from_this_tree": diff}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
