"""What a hand-written kernel compiled to: the instruction mix of its hot
loop, read from the SASS that `cuobjdump -sass` prints for a built
library, and ptxas's register, stack-frame and spill report.

The hot loop is the kernel's widest backward branch (for K1, one pixel
an iteration).  Its instructions are counted once each, and a call
inside it adds its callee's body once a call site; a loop nested in it
is listed (`inner_loops`) and its body counted `inner_trips` times
(default once), so the count is an iteration's only when that list is
empty or every nested loop runs `inner_trips` times.  Calls to ptxas's IEEE divide
and square-root slow paths are listed apart and not added, nor is the
code that sets them up: they run only for operands outside the fast
path's range.  ptxas jumps over such a call with a predicated branch
just before it, which is how one is told from a call of a device
function.  Any other branch inside the loop counts both ways.

    python3 -m libplacebo_tpu_torch._sass LIBRARY.so|LISTING KERNEL [TRIPS]

prints the mix as JSON (KERNEL is a substring of the mangled name; a
LISTING is saved `cuobjdump -sass` output, read without cuobjdump;
TRIPS is `inner_trips`).
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys
from collections import Counter
from typing import Dict, List

__all__ = ["CLASSES", "classify", "cuobjdump_path", "disassemble",
           "parse_functions", "loop_mix", "ptxas_report"]

# instruction classes, by the opcode's first dot-separated field
CLASSES = {
    "fp32": {"FFMA", "FMUL", "FADD", "FMNMX", "FSETP", "FSEL", "FSET",
             "FCHK", "FSWZADD"},
    "mufu": {"MUFU"},
    "lds": {"LDS", "LDSM"},
    "sts": {"STS"},
    "atoms": {"ATOMS"},
    "call_ret": {"CALL", "RET"},
    "local": {"LDL", "STL"},
    "global": {"LDG", "STG", "LD", "ST", "RED", "ATOM", "ATOMG"},
    "constant_load": {"LDC", "ULDC"},
    "conversion": {"F2I", "I2F", "F2F", "FRND", "I2FP", "F2IP"},
    "integer": {"IMAD", "IADD3", "IADD", "ISETP", "LOP3", "LOP", "SHF",
                "SHL", "SHR", "LEA", "IMNMX", "IABS", "POPC", "FLO",
                "BREV", "PRMT", "SEL", "ISCADD", "IMUL", "VIADD", "VIMNMX",
                "IMAD.WIDE", "SGXT", "BMSK"},
    "uniform": {"UIADD3", "ULOP3", "UISETP", "UMOV", "USHF", "ULEA",
                "UIMAD", "USEL", "UFLO", "UPOPC", "UPRMT", "ULOP",
                "USGXT", "UBMSK", "UPLOP3", "UP2UR", "UR2UP", "VOTEU"},
    "branch": {"BRA", "BRX", "JMP", "JMX", "EXIT", "BSSY", "BSYNC",
               "WARPSYNC", "BREAK", "YIELD", "BPT", "KILL"},
    "move": {"MOV", "MOV32I", "S2R", "CS2R", "S2UR", "R2UR", "SHFL", "P2R",
             "R2P", "PLOP3", "VOTE", "MATCH", "CSMTEST"},
    "barrier": {"BAR", "MEMBAR", "DEPBAR", "ERRBAR", "CCTL", "FENCE"},
    "nop": {"NOP"},
}
_CLASS_OF = {op: cls for cls, ops in CLASSES.items() for op in ops}
_SLOW_PATH = re.compile(r"slowpath|slow_path", re.I)

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_LABEL = re.compile(r"^\s*(\S+):\s*$")
_INSN = re.compile(r"^\s*/\*([0-9a-fA-F]+)\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"`\(([^)]+)\)|\b(0x[0-9a-fA-F]+)\b")


def classify(op: str) -> str:
    """The class of one opcode (e.g. 'FFMA.FTZ' -> 'fp32')."""
    base = op.split(".")[0]
    return _CLASS_OF.get(base, "other")


def cuobjdump_path() -> str:
    """cuobjdump beside nvcc, else the copy in Triton's package; raises
    when neither exists."""
    from ._build import nvcc_path
    cands = []
    try:
        cands.append(os.path.join(os.path.dirname(nvcc_path()), "cuobjdump"))
    except RuntimeError:
        pass
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        cands.append(os.path.join(os.path.dirname(spec.origin), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError(f"cuobjdump not found (looked at {cands})")


def disassemble(lib_path: str) -> str:
    """`cuobjdump -sass` of a built library."""
    return subprocess.run([cuobjdump_path(), "-sass", lib_path],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout


def parse_functions(sass: str) -> Dict[str, dict]:
    """{mangled name: {"insns": [(addr, predicate, opcode, operands)],
    "labels": {label: addr}}} for every function of a SASS listing."""
    funcs: Dict[str, dict] = {}
    cur = None
    pending: List[str] = []
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), {"insns": [], "labels": {}})
            pending = []
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m and not line.lstrip().startswith("/*"):
            pending.append(m.group(1))
            continue
        m = _INSN.match(line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        text = m.group(2).strip()
        pred = ""
        if text.startswith("@"):
            pred, _, text = text.partition(" ")
        op, _, operands = text.strip().partition(" ")
        cur["insns"].append((addr, pred, op, operands))
        for lab in pending:
            cur["labels"][lab] = addr
        pending = []
    return funcs


def _target(operands: str, labels: Dict[str, int]):
    """(address or None, name) of a branch or call operand."""
    m = _TARGET.search(operands)
    if not m:
        return None, operands.strip()
    if m.group(1):
        name = m.group(1)
        return labels.get(name, labels.get(name.lstrip("$"))), name
    return int(m.group(2), 16), m.group(2)


def _body_size(insns, start: int) -> Counter:
    """Opcodes from `start` through the first RET."""
    out: Counter = Counter()
    for addr, _, op, _ in insns:
        if addr < start:
            continue
        out[op] += 1
        if op.split(".")[0] == "RET":
            break
    return out


def loop_mix(sass: str, kernel: str, inner_trips: int = 1) -> dict:
    """The instruction mix of `kernel`'s hot loop (see the module note);
    `kernel` is a substring of the function's mangled name, and each
    loop nested in the hot loop counts `inner_trips` times."""
    funcs = parse_functions(sass)
    names = [n for n in funcs if kernel in n]
    if len(names) != 1:
        raise ValueError(f"{len(names)} functions match {kernel!r}: {names}")
    f = funcs[names[0]]
    insns, labels = f["insns"], f["labels"]
    loops = []
    for addr, _, op, operands in insns:
        if op.split(".")[0] != "BRA":
            continue
        tgt, _ = _target(operands, labels)
        if tgt is not None and tgt < addr:
            loops.append((tgt, addr))
    if not loops:
        raise ValueError(f"{names[0]} has no loop")
    start, end = max(loops, key=lambda t: t[1] - t[0])
    inner = sorted((s, e) for s, e in loops
                   if start <= s and e < end and (s, e) != (start, end))
    # a call that a predicated branch just before it jumps over, and the
    # set-up between them: an IEEE slow path
    skipped = set()
    for i, (addr, _, op, _) in enumerate(insns):
        if op.split(".")[0] != "CALL":
            continue
        for j in range(i - 1, max(i - 7, -1), -1):
            _, pred, op2, operands2 = insns[j]
            if pred and op2.split(".")[0] == "BRA":
                tgt2, _ = _target(operands2, labels)
                if tgt2 is not None and tgt2 > addr:
                    skipped.update(a for a, _, _, _ in insns[j + 1:]
                                   if a < tgt2)
                break
    ops: Counter = Counter()
    static: Counter = Counter()
    calls: Counter = Counter()
    slow_calls: Counter = Counter()
    n_skipped = 0
    for addr, _, op, operands in insns:
        if not start <= addr <= end:
            continue
        static[op] += 1
        n = inner_trips if any(s <= addr <= e for s, e in inner) else 1
        is_call = op.split(".")[0] == "CALL"
        tgt, name = _target(operands, labels) if is_call else (None, "")
        if addr in skipped or (is_call and _SLOW_PATH.search(name)):
            n_skipped += n
            if is_call:
                slow_calls[name] += n
            continue
        ops[op] += n
        if not is_call:
            continue
        calls[name] += n
        callee = funcs.get(name.lstrip("$"))
        body = (_body_size(callee["insns"], 0) if callee is not None
                else _body_size(insns, tgt) if tgt is not None
                else Counter())
        ops.update({k: v * n for k, v in body.items()})

    def by_class(c: Counter) -> Dict[str, int]:
        out: Counter = Counter()
        for op, n in c.items():
            out[classify(op)] += n
        return dict(sorted(out.items()))

    return {"function": names[0], "loop_bytes": [start, end],
            "inner_loops": [[s, e] for s, e in inner],
            "static_instructions": sum(static.values()),
            "per_iteration": sum(ops.values()),
            "slow_path_instructions": n_skipped,
            "classes": by_class(ops), "static_classes": by_class(static),
            "calls": dict(calls), "slow_path_calls": dict(slow_calls),
            "opcodes": dict(sorted(ops.items(), key=lambda t: -t[1]))}


_PROPS = re.compile(r"Function properties for (\S+)")
_COMPILING = re.compile(r"Compiling entry function '([^']+)'")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(log: str) -> Dict[str, dict]:
    """{function: {registers, stack_frame, spill_stores, spill_loads}}
    from nvcc's `-Xptxas -v` output."""
    out: Dict[str, dict] = {}
    cur = None
    for line in log.splitlines():
        m = _PROPS.search(line) or _COMPILING.search(line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = _STACK.search(line)
        if m:
            cur.update(stack_frame=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = _REGS.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def main(argv) -> int:
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    with open(argv[0], "rb") as f:
        is_library = f.read(4) == b"\x7fELF"
    if is_library:
        sass = disassemble(argv[0])
    else:
        with open(argv[0]) as f:
            sass = f.read()
    trips = int(argv[2]) if len(argv) == 3 else 1
    print(json.dumps(loop_mix(sass, argv[1], trips)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
