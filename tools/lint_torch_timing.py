#!/usr/bin/env python
"""Static check: raw clock reads in the PyTorch port belong to its
telemetry layer only.

The rule is ``lint_timing.py``'s (its per-file checker is reused): no
``time.time()`` / ``time.perf_counter()`` / ``time.monotonic()`` call
and no ``from time import`` alias of them. The scan is the port's
package, ``distkeras_tpu_torch/``; its clock owner is
``utils/profiling.py`` (``now()``, ``wall()``), and ``obs/`` (the
telemetry layer built on it) and ``examples/`` (scripts that use the
package, as the JAX package's examples sit outside its scan) are exempt. A justified
exception carries ``# lint: allow-raw-clock`` on its line.

Exit status 1 when findings exist (wired into tier-1 as
``tests/test_torch_lint_timing.py``).
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import List

sys.path.insert(0, str(Path(__file__).resolve().parent))

from lint_timing import ALLOW_MARK, Finding, check_source  # noqa: E402

#: the port's package, repo-relative
SCAN = "distkeras_tpu_torch"
#: the clock owner, and the directories that may read clocks raw
EXEMPT_FILES = ("utils/profiling.py",)
EXEMPT_DIRS = ("obs", "examples")


def check_tree(root: Path) -> List[Finding]:
    findings: List[Finding] = []
    pkg = root / SCAN
    for f in sorted(pkg.rglob("*.py")):
        rel = f.relative_to(pkg)
        if str(rel) in EXEMPT_FILES or rel.parts[0] in EXEMPT_DIRS:
            continue
        findings.extend(check_source(f.read_text(),
                                     str(f.relative_to(root))))
    return findings


def main(argv=None) -> int:
    root = Path(argv[0]) if argv else Path(__file__).resolve().parent.parent
    findings = check_tree(root)
    for rel, lineno, msg in findings:
        print(f"{rel}:{lineno}: {msg}")
    if findings:
        print(f"{len(findings)} raw-clock finding(s); route through "
              f"utils.profiling.now()/wall() or mark the line with "
              f"'# {ALLOW_MARK}'", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
