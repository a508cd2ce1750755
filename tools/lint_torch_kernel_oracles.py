#!/usr/bin/env python
"""Static check: every kernel entry point of the PyTorch port is held
against its plain version, on the card and in the tests.

A hand-written CUDA kernel never ships on trust: its wrapper keeps a
plain PyTorch version beside it, and a test runs both on the same
inputs. This linter AST-parses ``distkeras_tpu_torch/ops/*.py`` and
finds every kernel entry point -- a public top-level function that
transitively (through same-module helpers) reaches a
``kernels.library(...)`` call, the load of a built kernel -- then
requires, for each:

  * a case in ``tests/test_torch_cuda.py`` (the card's tests) naming
    it; and
  * a ``tests/test_torch_*.py`` naming it together with a plain version
    of its module (a public ``*_reference`` or ``reference_*`` function
    there).

A justified exception carries ``# lint: allow-no-oracle`` on the
``def`` line, as in ``lint_kernel_oracles.py``.

Exit status 1 when findings exist (wired into tier-1 as
``tests/test_torch_lint_kernel_oracles.py``).
"""

from __future__ import annotations

import ast
import re
import sys
from pathlib import Path
from typing import Dict, List, Set, Tuple

ALLOW_MARK = "lint: allow-no-oracle"

OPS_DIR = "distkeras_tpu_torch/ops"
TESTS_DIR = "tests"
CARD_TESTS = "tests/test_torch_cuda.py"

Finding = Tuple[str, int, str]


def _loads_kernel(node: ast.Call) -> bool:
    f = node.func
    return isinstance(f, ast.Attribute) and f.attr == "library" \
        and isinstance(f.value, ast.Name) and f.value.id == "kernels"


def kernel_entry_points(src: str, rel: str) -> Tuple[List[Tuple[str, int]],
                                                     List[str]]:
    """``([(name, lineno)], plain_versions)`` of one module: its public
    functions that reach a kernel, and its ``*_reference`` functions."""
    tree = ast.parse(src, filename=rel)
    fns: Dict[str, ast.AST] = {
        n.name: n for n in tree.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    reaches: Set[str] = set()
    edges: Dict[str, Set[str]] = {}
    for name, fn in fns.items():
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
        if any(_loads_kernel(c) for c in calls):
            reaches.add(name)
        edges[name] = {c.func.id for c in calls
                       if isinstance(c.func, ast.Name)} & set(fns)
    changed = True
    while changed:
        changed = False
        for name, called in edges.items():
            if name not in reaches and called & reaches:
                reaches.add(name)
                changed = True
    entries = sorted((n, fns[n].lineno) for n in reaches
                     if not n.startswith("_"))
    plain = sorted(n for n in fns if not n.startswith("_") and (
        n.endswith("_reference") or n.startswith("reference_")))
    return entries, plain


def check_tree(root: Path) -> List[Finding]:
    texts = {str(p.relative_to(root)): p.read_text()
             for p in sorted((root / TESTS_DIR).glob("test_torch_*.py"))}
    card = texts.get(CARD_TESTS, "")
    findings: List[Finding] = []
    for mod in sorted((root / OPS_DIR).glob("*.py")):
        rel = str(mod.relative_to(root))
        src = mod.read_text()
        try:
            entries, plain = kernel_entry_points(src, rel)
        except SyntaxError as e:
            findings.append((rel, e.lineno or 0, f"syntax error: {e.msg}"))
            continue
        lines = src.splitlines()
        for name, lineno in entries:
            if ALLOW_MARK in lines[lineno - 1]:
                continue
            pat = re.compile(rf"\b{re.escape(name)}\b")
            if not pat.search(card):
                findings.append((rel, lineno, f"kernel entry point "
                                 f"'{name}' has no case in {CARD_TESTS}"))
            held = any(pat.search(t) and any(
                re.search(rf"\b{p}\b", t) for p in plain)
                for t in texts.values())
            if not held:
                findings.append((rel, lineno, f"kernel entry point "
                                 f"'{name}' is held against no plain "
                                 f"version of its module ({plain or 'none'})"
                                 " in any tests/test_torch_*.py"))
    return findings


def main(argv=None) -> int:
    root = Path(argv[0]) if argv else Path(__file__).resolve().parent.parent
    findings = check_tree(root)
    for rel, lineno, msg in findings:
        print(f"{rel}:{lineno}: {msg}")
    if findings:
        print(f"{len(findings)} kernel-oracle finding(s); add a card case "
              f"and a test against the plain version, or mark the def "
              f"line with '# {ALLOW_MARK}'", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
