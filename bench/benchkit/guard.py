"""The harness's import guard: nothing it runs may load JAX or the JAX
package the port was made from.  Names are compared whole, by their
top-level part (``repro_torch`` is the port and passes; ``repro`` fails)."""
from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden(module_names) -> list[str]:
    """The forbidden top-level names among ``module_names``."""
    return sorted({name.partition(".")[0] for name in module_names} & FORBIDDEN)


def loaded_forbidden() -> list[str]:
    """The forbidden top-level names among the modules loaded now."""
    return forbidden(list(sys.modules))


def top_level_imports(path: Path) -> set[str]:
    """Top-level names of every absolute import in one source file."""
    names = set()
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.partition(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.partition(".")[0])
    return names
