"""What the benchmark may load.

Module names are compared by their top-level name, the part before the
first dot, as a whole: ``signalizer_tpu_torch`` (the program) begins with
``signalizer_tpu`` (the JAX package) and is not it.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

# never in the process that prints a result
BANNED = frozenset({"jax", "jaxlib", "flax", "signalizer_tpu"})
PROGRAM = "signalizer_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_banned(names=None) -> list:
    """The banned top-level names among module ``names`` (default: the
    modules loaded in this process; an entry set to None blocks an import
    and loads nothing)."""
    if names is None:
        names = [m for m, mod in list(sys.modules.items()) if mod is not None]
    return sorted({top_level(m) for m in names} & BANNED)


def reference_imports(reference_dir: Path) -> list:
    """``(file, module)`` for every import under ``reference_dir`` of the
    program, of a banned name, or of a part of the benchmark other than the
    reference itself."""
    bad = []
    for path in sorted(Path(reference_dir).glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    continue  # a relative import stays inside the reference package
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = top_level(name)
                outside = top == "portbench" and not name.startswith("portbench.reference")
                if top in BANNED or top == PROGRAM or outside:
                    bad.append((path.name, name))
    return bad
