#!/usr/bin/env python
"""Static check: the PyTorch port's registry metric names are literal
``component.snake_case``.

The rule is ``lint_metric_names.py``'s (its per-file checker is
reused): every ``.counter(...)`` / ``.gauge(...)`` / ``.histogram(...)``
call passes a string literal first argument matching
``component.snake_case``; a runtime-built name mints unbounded series.
The scan is the port's package, ``distkeras_tpu_torch/``, but its
``examples/`` (scripts that use the package, as the JAX package's
examples sit outside its scan). A justified exception carries ``# lint:
allow-dynamic-metric-name`` on its line.

Exit status 1 when findings exist (wired into tier-1 as
``tests/test_torch_lint_metric_names.py``).
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import List

sys.path.insert(0, str(Path(__file__).resolve().parent))

from lint_metric_names import ALLOW_MARK, Finding, check_source  # noqa: E402

#: the port's package, repo-relative, and its directories out of scope
SCAN = "distkeras_tpu_torch"
EXEMPT_DIRS = ("examples",)


def check_tree(root: Path) -> List[Finding]:
    pkg = root / SCAN
    return [f for path in sorted(pkg.rglob("*.py"))
            if path.relative_to(pkg).parts[0] not in EXEMPT_DIRS
            for f in check_source(path.read_text(),
                                  str(path.relative_to(root)))]


def main(argv=None) -> int:
    root = Path(argv[0]) if argv else Path(__file__).resolve().parent.parent
    findings = check_tree(root)
    for rel, lineno, msg in findings:
        print(f"{rel}:{lineno}: {msg}")
    if findings:
        print(f"{len(findings)} metric-name finding(s); use literal "
              f"component.snake_case names (labels for variable "
              f"dimensions) or mark the line with '# {ALLOW_MARK}'",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
