"""K1's (or K5's) compiled sphere tests, read from their SASS.

    python3 tools/k1_sass.py [--kernel k1|k5] [--root DIR] [--out DIR]

Builds the kernel library of the raytracing_tpu_torch package under DIR
(default: this checkout; a parent commit unpacked elsewhere can be read in
the same call), disassembles it with ``cuobjdump -sass`` and prints, for
each instantiation of the kernel (K1: ``k1_trace_block<MOVING, NOISE,
IMAGE, CAP[, WALK]>``; K5: ``k5_trace_group<BVH, STAGED, NOISE, IMAGE,
GUARD, SPLIT, COUNT>``, the last three its design switches and the
counting probe), one JSON line: its instruction count, calls, square
roots (``MUFU.RSQ``), the roots guarded by a branch that a miss takes past
them, and the loop that is the innermost to hold a ``MUFU.RSQ`` (K1's
sweep: four roots to an iteration of its unrolled loop): its length in
instructions, square roots, instructions per sphere test, the calls
inside it (the correctly rounded ``sqrtf`` reaches its slow path through
a call) and the length of the called subroutine, the guarded roots and
the instructions a miss skips, with the loop's instructions by opcode.
With ``--out`` it writes each function's SASS there. Needs the CUDA
toolkit (``nvcc``, ``cuobjdump``).
"""
from __future__ import annotations

import argparse
import collections
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
KERNELS = {"k1": "k1_trace_block", "k5": "k5_trace_group"}


def functions(sass: str):
    """{mangled name: [(address, instruction text)]} of a cuobjdump listing."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = INSTR.search(line)
        if m and name is not None:
            out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def opcode(text: str) -> str:
    """The opcode of an instruction, without its predicate."""
    parts = text.split()
    if parts and parts[0].startswith("@"):
        parts = parts[1:]
    return parts[0] if parts else ""


def target(text: str):
    """A branch's or call's target address, or None."""
    m = re.search(r"\b0x([0-9a-f]+)\b", text.split(" ", 1)[-1])
    return int(m.group(1), 16) if m else None


def subroutine_length(instrs, entry):
    """Instructions from a call's target to the first return after it."""
    n = 0
    for a, t in instrs:
        if a < entry:
            continue
        n += 1
        if opcode(t).startswith("RET"):
            return n
    return None


def guarded_roots(body):
    """For each MUFU.RSQ of ``body`` guarded by a conditional branch (one
    of the four instructions before it) forward past the root's call: the
    instructions from that branch to its target, which a miss skips."""
    skipped = []
    for k, (a, t) in enumerate(body):
        if not opcode(t).startswith("MUFU.RSQ"):
            continue
        for a2, t2 in body[max(0, k - 4):k]:
            tgt = target(t2)
            if t2.startswith("@") and opcode(t2).startswith("BRA") and tgt and tgt > a + 0x40:
                skipped.append(sum(a2 < x < tgt for x, _ in body))
    return skipped


def sweep_loop(instrs):
    """The innermost loop (the shortest backward branch's span) holding a
    MUFU.RSQ: its summary, or None. A square root is guarded when one of
    the four instructions before its MUFU.RSQ is a conditional branch
    forward past the root's call; a miss then skips the instructions up to
    that branch's target."""
    best = None
    for addr, text in instrs:
        tgt = target(text)
        if not opcode(text).startswith("BRA") or tgt is None or tgt >= addr:
            continue
        body = [(a, t) for a, t in instrs if tgt <= a <= addr]
        if any(opcode(t).startswith("MUFU.RSQ") for _, t in body) and (
                best is None or len(body) < len(best[2])):
            best = (tgt, addr, body)
    if best is None:
        return None
    start, end, body = best
    ops = collections.Counter(opcode(t) for _, t in body)
    calls = [t for _, t in body if opcode(t).startswith("CALL")]
    leaves = [t for _, t in body if opcode(t).startswith("BRA") and target(t) is not None
              and not start <= target(t) <= end]
    skipped = guarded_roots(body)
    rsq = ops["MUFU.RSQ"]
    slow = {target(t) for t in calls}
    return dict(start=hex(start), end=hex(end), instructions=len(body), rsq=rsq,
                per_sphere_test=round(len(body) / rsq, 2), calls_in_loop=len(calls),
                slow_path_instructions=[subroutine_length(instrs, x) for x in sorted(slow)],
                guarded_rsq=len(skipped), skipped_on_miss=skipped,
                branches_out=len(leaves), ops=dict(ops.most_common()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="k1")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    kernels = importlib.import_module("raytracing_tpu_torch._kernels")
    lib = kernels.library()
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or os.path.join(cuda_home, "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib.path)], capture_output=True, text=True,
                          check=True).stdout
    out = Path(args.out) if args.out else None
    if out:
        out.mkdir(parents=True, exist_ok=True)
    kernel = KERNELS[args.kernel]
    print(f"k1_sass: {kernels.__file__} ({lib.path.name}) {kernel}")
    for name, instrs in sorted(functions(sass).items()):
        if f"{kernel}I" not in name:
            continue
        # the template's bool arguments, in order (K5's Design<...> among them)
        tpl = ",".join(re.findall(r"Lb([01])E", name.split(f"{kernel}I", 1)[1]))
        row = dict(kernel=f"{kernel}<{tpl}>", instructions=len(instrs),
                   calls=sum(opcode(t).startswith("CALL") for _, t in instrs),
                   rsq=sum(opcode(t).startswith("MUFU.RSQ") for _, t in instrs),
                   guarded_rsq=len(guarded_roots(instrs)), sweep_loop=sweep_loop(instrs))
        print(json.dumps(row))
        if out:
            (out / f"{args.kernel}_{tpl.replace(',', '')}.sass").write_text(
                "\n".join(f"/*{a:04x}*/ {t}" for a, t in instrs) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
