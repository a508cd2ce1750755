#!/usr/bin/env python
"""Static check: the PyTorch port must not swallow the un-catchable.

The rule is ``lint_exception_swallow.py``'s (its per-file checker is
reused): a bare ``except:`` or an ``except BaseException`` handler that
does not re-raise eats ``KeyboardInterrupt``/``SystemExit`` and
injected faults. The scan is the port's package,
``distkeras_tpu_torch/``. A handler that hands the error on (a worker
thread stashing it for the thread that re-raises it, a writer that
surfaces it at the next call) carries ``# lint: allow-swallow`` on its
``except`` line.

Exit status 1 when findings exist (wired into tier-1 as
``tests/test_torch_lint_exception_swallow.py``).
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import List

sys.path.insert(0, str(Path(__file__).resolve().parent))

from lint_exception_swallow import (ALLOW_MARK, Finding,  # noqa: E402
                                    check_source)

#: the port's package, repo-relative
SCAN = "distkeras_tpu_torch"


def check_tree(root: Path) -> List[Finding]:
    return [f for path in sorted((root / SCAN).rglob("*.py"))
            for f in check_source(path.read_text(),
                                  str(path.relative_to(root)))]


def main(argv=None) -> int:
    root = Path(argv[0]) if argv else Path(__file__).resolve().parent.parent
    findings = check_tree(root)
    for rel, lineno, msg in findings:
        print(f"{rel}:{lineno}: {msg}")
    if findings:
        print(f"{len(findings)} exception-swallow finding(s); re-raise or "
              f"mark the line with '# {ALLOW_MARK}'", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
