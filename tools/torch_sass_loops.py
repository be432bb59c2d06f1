"""Instruction counts of the loops in the SASS of one kernel source of
popsift_torch, on a machine with the CUDA toolkit and a Hopper card.

    python3 tools/torch_sass_loops.py [--source desc_grid] [--min 60]

Builds the kernel library as its first use on the card does
(``kernels/_lib.py``), disassembles the object of ``csrc/<source>.cu``
with ``cuobjdump -sass``, and prints for each kernel its instruction
count and, for each loop (a branch back to an earlier address) of at
least ``--min`` instructions, its length and its most frequent opcodes.
Nested loops are printed each with their whole body.  The card's name
and power limit come first.  A kernel bound by instruction issue takes
about (instructions of its inner loop) x (trips) / (issue rate): the
counts say which operations to cut.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def parse(sass: str) -> dict:
    """{mangled kernel name: [(address, instruction text)]}."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and cur:
            funcs[cur].append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def short_name(mangled: str) -> str:
    """The last length-prefixed name of a mangled _ZN...E symbol."""
    s, parts, i = mangled.removeprefix("_ZN"), [], 0
    while i < len(s) and s[i].isdigit():
        j = i
        while s[j].isdigit():
            j += 1
        parts.append(s[j:j + int(s[i:j])])
        i = j + int(s[i:j])
    return parts[-1] if parts else mangled


def opcode(text: str) -> str:
    words = text.split()
    return words[1] if words[0].startswith("@") else words[0]


def loops(ins) -> list:
    """(first, last) instruction index of each backward branch's body."""
    at = {a: i for i, (a, _) in enumerate(ins)}
    out = []
    for i, (a, text) in enumerate(ins):
        m = re.search(r"BRA.*?0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) < a and int(m.group(1), 16) in at:
            out.append((at[int(m.group(1), 16)], i))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default="desc_grid")
    ap.add_argument("--min", type=int, default=60)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_sass_loops: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("cs", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from popsift_torch.kernels import _lib
    print(cs.smi_line(), flush=True)
    _lib.library(torch.device("cuda"))
    lib = Path(_lib.build_info["path"])
    obj = lib.parent / (lib.stem + ".obj") / f"{args.source}.o"
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(obj)], capture_output=True,
                          text=True, check=True).stdout
    for name, ins in parse(sass).items():
        print(f"{short_name(name)}: {len(ins)} instructions")
        for first, last in loops(ins):
            if last - first + 1 < args.min:
                continue
            ops = collections.Counter(opcode(t) for _, t in
                                      ins[first:last + 1])
            top = ", ".join(f"{k} {v}" for k, v in ops.most_common(12))
            print(f"  loop {first}-{last}: {last - first + 1} "
                  f"instructions; {top}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
