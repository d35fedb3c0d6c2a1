#!/usr/bin/env python3
"""The evidence kernel's machine code, counted by instruction class.

    python3 scripts/torch_evidence_sass.py [--source evidence.cu] [--k 20]

Compiles ``gp_dla_detection_tpu_torch/csrc/evidence.cu`` (or ``--source``,
another version with the same kernels, e.g. one from git history) with
the port's nvcc target to a cubin (ptxas's registers and spills printed),
disassembles it with ``cuobjdump
-sass`` and splits ``evidence_kernel<k, false>`` (single) and
``evidence_kernel<k, true>`` (pair) into basic blocks.  Every block with
floating-point work is printed, in the order of the code, with its
counts: FFMA, FMUL, FADD, the MUFU special-function results (RCP: the
divisions' reciprocal; EX2: ``expf``; LG2), shared-memory loads and stores and all instructions.  The producers'
loops are unrolled over U = 8 pixels, so a producer block's counts over
U are per (sample, pixel): one line's wing is the block with U RCP and
no EX2 and no stores, one line with its core U RCP and U EX2, the raw
exp(optical depth) U EX2 and U stores, the weights U RCP and 2 U stores.

Needs nvcc and cuobjdump (the CUDA toolkit; no GPU).  Ends with a
``SASS {json}`` line.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SOURCE = REPO / "gp_dla_detection_tpu_torch" / "csrc" / "evidence.cu"

_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_INSTR = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
_PREDICATE = re.compile(r"^@!?U?P[T0-9]+\s+")
# instructions after which control may leave the straight line
_ENDS_BLOCK = ("BRA", "BRX", "JMP", "JMX", "EXIT", "RET", "CALL")
CLASSES = ("FFMA", "FMUL", "FADD", "MUFU.RCP", "MUFU.EX2", "MUFU.LG2", "LDS", "STS", "all")


def opcode(text: str) -> str:
    """``@!P0 FFMA.FTZ R1, ...`` -> ``FFMA.FTZ``."""
    return _PREDICATE.sub("", text).split()[0]


def functions(sass: str) -> dict[str, list[list[str]]]:
    """Each function's basic blocks, each a list of opcodes: a block ends
    at a label and after a branch, a call, a return or an exit."""
    out: dict[str, list[list[str]]] = {}
    blocks = None
    for line in sass.splitlines():
        if m := _FUNCTION.search(line):
            blocks = out.setdefault(m.group(1), [[]])
        elif blocks is None:
            continue
        elif _LABEL.match(line):
            if blocks[-1]:
                blocks.append([])
        elif m := _INSTR.match(line):
            op = opcode(m.group(1))
            blocks[-1].append(op)
            if op.split(".")[0] in _ENDS_BLOCK:
                blocks.append([])
    return {name: [b for b in bl if b] for name, bl in out.items()}


def counts(block: list[str]) -> dict[str, int]:
    """The block's instruction classes (``CLASSES``); a class counts every
    variant of its opcode (FFMA.FTZ, LDS.64, ...)."""
    c = Counter()
    for op in block:
        base = op.split(".")[0]
        if base == "MUFU":
            c[".".join(op.split(".")[:2])] += 1
        elif base in ("FFMA", "FMUL", "FADD", "LDS", "STS"):
            c[base] += 1
    c["all"] = len(block)
    return {k: c[k] for k in CLASSES}


def report(sass: str, k: int) -> dict:
    """Per configuration, every block with floating-point work, in the
    order of the code."""
    out = {}
    for name, blocks in functions(sass).items():
        m = re.search(rf"evidence_kernelILi{k}ELb([01])E", name)
        if not m:
            continue
        rows = []
        for i, b in enumerate(blocks):
            c = counts(b)
            if c["FFMA"] + c["FMUL"] + c["FADD"] >= 4 or any(c[x] for x in CLASSES[3:6]):
                rows.append({"block": i, **c})
        out["pair" if m.group(1) == "1" else "single"] = rows
    return out


def disassemble(source: Path) -> str:
    sys.path.insert(0, str(REPO))
    from gp_dla_detection_tpu_torch import _build

    nvcc = Path(_build.nvcc_path())
    with tempfile.TemporaryDirectory(prefix="evidence_sass_") as tmp:
        cubin = Path(tmp) / "evidence.cubin"
        subprocess.run([str(nvcc), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                        "-O3", "-Xptxas", "-v", "-cubin", "-o", str(cubin), str(source)],
                       check=True)
        return subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass", str(cubin)],
                              check=True, capture_output=True, text=True).stdout


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=SOURCE)
    ap.add_argument("--k", type=int, default=20)
    args = ap.parse_args()
    rep = report(disassemble(args.source), args.k)
    for config, rows in rep.items():
        print(f"{args.source} evidence_kernel<{args.k}, {config == 'pair'}>:")
        print("  " + " ".join(f"{h:>9}" for h in ("block", *CLASSES)))
        for r in rows:
            print("  " + " ".join(f"{r[h]:>9}" for h in ("block", *CLASSES)))
    print("SASS " + json.dumps({"source": str(args.source), "k": args.k, **rep}))


if __name__ == "__main__":
    main()
