#!/usr/bin/env python
"""Static check: the PyTorch port's fault-point names in code and in its
catalog agree.

``resilience.faults`` addresses injection sites by name: a chaos
schedule, a ``DKT_FAULTS`` script or a test arming
``faults.inject("serving.decode", ...)`` binds to the string literal at
a ``faults.point("...")`` / ``faults.corrupt("...", ...)`` site. A
renamed site breaks none of them loudly -- the injection never fires.
The port's catalog is ``distkeras_tpu_torch.resilience.faults.CATALOG``;
this linter holds it equal to the literal sites under
``distkeras_tpu_torch/`` (found by ``lint_fault_points.code_points``),
with a finding for every name on one side only.

Exit status 1 when findings exist (wired into tier-1 as
``tests/test_torch_lint_fault_points.py``).
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Iterable, List, Optional

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

from lint_fault_points import Finding, code_points  # noqa: E402


def check(root=None, catalog: Optional[Iterable[str]] = None
          ) -> List[Finding]:
    root = Path(root) if root else REPO / "distkeras_tpu_torch"
    if catalog is None:
        sys.path.insert(0, str(REPO))
        from distkeras_tpu_torch.resilience.faults import CATALOG
        catalog = CATALOG
    in_code, in_catalog = code_points(root), set(catalog)
    findings: List[Finding] = []
    for name in sorted(set(in_code) - in_catalog):
        findings.append((name, f"fault point {name!r} "
                               f"({', '.join(in_code[name])}) is not in "
                               "faults.CATALOG -- add it (chaos schedules "
                               "bind to the catalogued name)"))
    for name in sorted(in_catalog - set(in_code)):
        findings.append((name, f"faults.CATALOG lists {name!r} but no "
                               "faults.point/corrupt site declares it -- "
                               "renamed or removed? schedules armed on it "
                               "now silently no-op"))
    return findings


def main(argv=None) -> int:
    findings = check()
    for _, msg in findings:
        print(f"lint_torch_fault_points: {msg}", file=sys.stderr)
    if findings:
        print(f"lint_torch_fault_points: {len(findings)} finding(s)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
