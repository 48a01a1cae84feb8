"""Nothing the benchmark runs may load JAX or the JAX package. Modules
are compared by their whole top-level name (the part before the first
dot): the port's name begins with the JAX package's."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

REFERENCE = Path(__file__).resolve().parents[1] / "reference"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "steppingstone_tpu"})


def forbidden(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)


def check() -> None:
    """Exit with code 3, naming what was found, if a forbidden module is
    loaded or the reference imports the port, JAX or the JAX package."""
    found = forbidden() + [f"{f}: {m}" for f, m in reference_imports()]
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr, flush=True)
        raise SystemExit(3)


def reference_imports(forbidden=FORBIDDEN | {"steppingstone_tpu_torch"}) -> list:
    """(file, module) for every import in benchmark/reference whose
    top-level name is forbidden there: JAX, the JAX package, the port."""
    found = []
    for path in sorted(REFERENCE.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) and node.module
                     and not node.level else [])
            found += [(path.name, n) for n in names if n.split(".", 1)[0] in forbidden]
    return found
