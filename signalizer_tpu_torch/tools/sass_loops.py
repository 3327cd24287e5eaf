"""Read the loops of a kernel's machine code (SASS): instructions a loop
iteration and the longest chain of dependent instructions through it.

    python -m signalizer_tpu_torch.tools.sass_loops SOURCE.cu --kernel NAME
        [--per N] [--out FILE] [--from-sass] [--min N]

Compiles ``SOURCE.cu`` with the package's ``nvcc`` flags for ``sm_90a`` into
a cubin under ``build/sass_loops/``, dumps its SASS with ``cuobjdump -sass``,
takes every function whose mangled name holds ``NAME`` (a kernel in an
anonymous namespace has no plain name there) and finds its innermost loops:
each backward branch, with the instructions from its target to it, that
holds no other. For each it prints one JSON line: the instructions, a count
by opcode, and the longest chain, the most instructions of the body of which
each reads a register or predicate that the one before it wrote (an
instruction under a guard also reads the register it writes). ``--per N``
divides both by N (the samples a loop iteration steps through); ``--min``
leaves out loops of fewer instructions. The chain is counted in
instructions, not cycles, and from the text alone: a register that enters
the body starts at depth 0. ``--out`` also writes the SASS of each function
there, and ``--from-sass`` reads such a file in place of compiling a source.

Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit); no GPU.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

from signalizer_tpu_torch.kernels import _build

_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"(\.L_x_\d+|0x[0-9a-f]+)")
_REG = re.compile(r"\b(U?R\d+|U?P\d)\b")
# opcodes that write no register
_NO_DEST = ("ST", "STS", "STG", "STL", "BRA", "EXIT", "BAR", "RET", "NOP", "BSYNC", "BSSY", "WARPSYNC",
            "CALL", "RED", "MEMBAR", "ERRBAR", "CCTL", "YIELD", "DEPBAR")


def _cuobjdump() -> str:
    return str(Path(_build.find_nvcc()).with_name("cuobjdump"))


def compile_cubin(source: Path) -> Path:
    out_dir = _build.BUILD_DIR.parent / "sass_loops"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{source.stem}.cubin"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    done = subprocess.run([_build.find_nvcc(), *flags, "-I", str(_build.CSRC), "-cubin", "-o", str(out), str(source)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    return out


def functions(cubin: Path, name: str) -> dict:
    """SASS text of each function whose mangled name holds ``name``."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(cubin)], capture_output=True, text=True, check=True).stdout
    return split_functions(sass, name)


def split_functions(sass: str, name: str) -> dict:
    parts = re.split(r"^\s*Function : (\S+)\s*$", sass, flags=re.M)
    return {fn: text for fn, text in zip(parts[1::2], parts[2::2]) if name in fn}


def parse(sass: str):
    """[(address, instruction text)] and {label: address of the next instruction}."""
    code, labels, pending = [], {}, []
    for line in sass.splitlines():
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _LINE.search(line)
        if m and not m.group(2).startswith("0x"):
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            code.append((addr, m.group(2)))
    return code, labels


def _split(text: str):
    guard = None
    if text.startswith("@"):
        guard, text = text.split(None, 1)
    op, _, rest = text.partition(" ")
    operands = [o.strip() for o in rest.split(",")] if rest else []
    return guard, op, operands


def _width(op: str) -> int:
    for w, n in ((".128", 4), (".64", 2)):
        if w in op:
            return n
    return 1


def _regs(token: str, width: int = 1):
    out = []
    for r in _REG.findall(token):
        if r.startswith(("R", "UR")) and width > 1:
            base = int(r.lstrip("UR"))
            prefix = "UR" if r.startswith("UR") else "R"
            out += [f"{prefix}{base + k}" for k in range(width)]
        else:
            out.append(r)
    return out


def chain(body) -> tuple:
    """Longest chain of dependent instructions in a straight-line body, and
    the instruction count by opcode."""
    depth = collections.defaultdict(int)
    longest, ops = 0, collections.Counter()
    for _, text in body:
        guard, op, operands = _split(text)
        base = op.split(".")[0]
        ops[base] += 1
        if base in _NO_DEST or not operands:
            dests, srcs = [], operands
        elif "SETP" in base or base in ("PLOP3", "R2P"):
            dests, srcs = operands[:2], operands[2:]
        else:
            dests, srcs = operands[:1], operands[1:]
        w = _width(op)
        dest_regs = [r for d in dests for r in _regs(d, w) if r not in ("PT", "UPT")]
        src_regs = [r for s in srcs for r in _regs(s, w if base.startswith("ST") else 1)]
        if guard:
            src_regs += _regs(guard) + dest_regs
        d = 1 + max((depth[r] for r in src_regs), default=0)
        for r in dest_regs:
            depth[r] = d
        longest = max(longest, d)
    return longest, ops


def loops(code, labels):
    """(first address, last address, body) of each innermost loop: each
    backward branch whose body holds no other."""
    found = []
    for addr, text in code:
        _, op, operands = _split(text)
        if not op.startswith("BRA") or not operands:
            continue
        m = _TARGET.search(operands[-1])
        if not m:
            continue
        target = m.group(1)
        start = int(target, 16) if target.startswith("0x") else labels.get(target, addr + 1)
        if start > addr:
            continue
        found.append((start, addr, [c for c in code if start <= c[0] <= addr]))
    return [a for a in found if not any(b[:2] != a[:2] and a[0] <= b[0] and b[1] <= a[1] for b in found)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("source")
    parser.add_argument("--kernel", required=True)
    parser.add_argument("--per", type=int, default=1, help="samples a loop iteration steps through")
    parser.add_argument("--out", default=None, help="also write each function's SASS to this file")
    parser.add_argument("--from-sass", action="store_true", help="SOURCE is a SASS dump (--out's) to read, not a .cu")
    parser.add_argument("--min", type=int, default=0, help="print only loops of at least this many instructions")
    args = parser.parse_args(argv)
    if args.from_sass:
        dumps = split_functions(Path(args.source).read_text(), args.kernel)
    else:
        dumps = functions(compile_cubin(Path(args.source)), args.kernel)
    if not dumps:
        print(f"sass_loops: no function named like {args.kernel} in {args.source}", file=sys.stderr)
        return 1
    if args.out:
        Path(args.out).write_text("".join(f"\tFunction : {fn}\n{text}" for fn, text in dumps.items()))
    for fn, sass in dumps.items():
        code, labels = parse(sass)
        for start, end, body in loops(code, labels):
            if len(body) < args.min:
                continue
            longest, ops = chain(body)
            print(json.dumps({
                "source": args.source, "function": fn, "loop": [hex(start), hex(end)],
                "instructions": len(body), "longest_chain": longest, "per": args.per,
                "instructions_per": len(body) / args.per, "chain_per": longest / args.per,
                "ops": dict(ops.most_common()),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
