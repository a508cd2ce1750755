#!/usr/bin/env python
"""Live check: every series name the PyTorch port's scenario report
reads exists.

``distkeras_tpu_torch/obs/report.py`` reads registry series by name out
of time-series scrapes (``REPORT_SERIES``). A metric renamed in the
port's ``serving/metrics.py`` or ``obs/slo.py`` breaks no import: the
report's joins come back empty and a panel flatlines. As
``lint_report_series.py`` does for the JAX package, this linter builds
the live instrument surface the report reads -- a port
``ServingMetrics`` window and one ``SLOEngine`` evaluation against it --
and asserts that every ``REPORT_SERIES`` name is registered there.

Exit status 1 when findings exist (wired into tier-1 as
``tests/test_torch_lint_report_series.py``).
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import List, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

Finding = Tuple[str, str]     # (series name, message)


def live_series() -> set:
    """Every series name the port's report surfaces register: a fresh
    ``ServingMetrics`` window plus one ``SLOEngine`` evaluation."""
    from distkeras_tpu_torch.obs.slo import SLOEngine, availability, ttft_p99
    from distkeras_tpu_torch.serving.metrics import ServingMetrics
    metrics = ServingMetrics()
    slo = SLOEngine([ttft_p99(0.5), availability(0.9)],
                    registry=metrics.registry)
    slo.evaluate(metrics)
    return set(metrics.registry.instruments())


def check(names=None) -> List[Finding]:
    """Findings for ``names`` (default: the port report's
    ``REPORT_SERIES``)."""
    if names is None:
        from distkeras_tpu_torch.obs.report import REPORT_SERIES
        names = REPORT_SERIES
    live = live_series()
    return [(n, f"series {n!r} read by distkeras_tpu_torch/obs/report.py "
                "is not registered by any live instrument surface "
                "(renamed or dropped?)")
            for n in names if n not in live]


def main(argv=None) -> int:
    findings = check()
    for _, msg in findings:
        print(f"lint_torch_report_series: {msg}", file=sys.stderr)
    if findings:
        print(f"lint_torch_report_series: {len(findings)} finding(s)",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
