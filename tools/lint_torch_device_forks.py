#!/usr/bin/env python
"""Static check: the PyTorch port forks on the device in few places.

The port's rule: a CUDA tensor goes to its kernel or raises, a CPU
tensor takes the plain version, and an entry point runs on the card
unless asked for the CPU -- never a silent fallback from one to the
other. The kernel wrappers (``ops/``, ``kernels/``) are where a tensor's
device picks the code path; anywhere else a fork on the device is a
place where a missing card could quietly become a CPU run. This linter
walks the AST of ``distkeras_tpu_torch/`` and flags:

  * ``torch.cuda.is_available()`` outside ``compat.py`` (which resolves
    an entry point's device and raises without a card),
    ``utils/profiling.py`` and ``obs/tape.py`` (which read the card's
    memory and peak when there is one);
  * a read of ``.is_cuda``, or of ``.type`` on a device (``x.device``,
    or a name ``dev``/``device``/``*_device``), outside ``ops/``,
    ``kernels/`` and ``compat.py``.

A fork that picks a host-side mechanism and not a code path (pinned
staging buffers, the device count) carries ``# lint: allow-device-fork``
on its line, with its reason.

Exit status 1 when findings exist (wired into tier-1 as
``tests/test_torch_lint_device_forks.py``).
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import List, Tuple

ALLOW_MARK = "lint: allow-device-fork"

#: the port's package, repo-relative
SCAN = "distkeras_tpu_torch"
#: files (package-relative) that may ask whether there is a card
AVAILABLE_OK = ("compat.py", "utils/profiling.py", "obs/tape.py")
#: where a tensor's device picks the code path (package-relative)
FORK_OK_DIRS = ("ops", "kernels")
FORK_OK_FILES = ("compat.py",)

Finding = Tuple[str, int, str]


def _is_device(node: ast.AST) -> bool:
    """``x.device``, or a name that holds a device."""
    if isinstance(node, ast.Attribute):
        return node.attr == "device"
    return isinstance(node, ast.Name) and (
        node.id in ("dev", "device") or node.id.endswith("_device"))


def check_source(src: str, rel: str, available_ok: bool = False,
                 fork_ok: bool = False) -> List[Finding]:
    """Findings for one file's source text."""
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:  # a broken file is its own finding
        return [(rel, e.lineno or 0, f"syntax error: {e.msg}")]
    lines = src.splitlines()
    out: List[Finding] = []
    for node in ast.walk(tree):
        msg = None
        if isinstance(node, ast.Call) and not available_ok:
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr == "is_available" \
                    and isinstance(f.value, ast.Attribute) \
                    and f.value.attr == "cuda":
                msg = ("torch.cuda.is_available() outside compat.py, "
                       "utils/profiling.py and obs/tape.py -- resolve the "
                       "device with compat.resolve_device, which raises "
                       "without a card")
        elif isinstance(node, ast.Attribute) and not fork_ok:
            if node.attr == "is_cuda" or (node.attr == "type"
                                          and _is_device(node.value)):
                msg = (f".{node.attr} fork outside ops/ and kernels/ -- "
                       "the kernel wrappers pick the path by the tensor's "
                       "device; a fork here can turn a missing card into a "
                       "silent CPU run")
        if msg and ALLOW_MARK not in lines[node.lineno - 1]:
            out.append((rel, node.lineno, msg))
    return sorted(out, key=lambda f: f[1])


def check_tree(root: Path) -> List[Finding]:
    pkg = root / SCAN
    findings: List[Finding] = []
    for path in sorted(pkg.rglob("*.py")):
        rel = path.relative_to(pkg)
        findings.extend(check_source(
            path.read_text(), str(path.relative_to(root)),
            available_ok=rel.as_posix() in AVAILABLE_OK,
            fork_ok=rel.parts[0] in FORK_OK_DIRS
            or rel.as_posix() in FORK_OK_FILES))
    return findings


def main(argv=None) -> int:
    root = Path(argv[0]) if argv else Path(__file__).resolve().parent.parent
    findings = check_tree(root)
    for rel, lineno, msg in findings:
        print(f"{rel}:{lineno}: {msg}")
    if findings:
        print(f"{len(findings)} device-fork finding(s); keep the fork in "
              f"the kernel wrappers or mark the line with "
              f"'# {ALLOW_MARK}'", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
