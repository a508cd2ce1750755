"""tools/lint_torch_report_series.py in tier-1: every series the port's
scenario report reads is registered by the port's live instruments, and
a renamed one is a finding."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import lint_torch_report_series as lint  # noqa: E402


def test_port_report_series_are_all_live():
    findings = lint.check()
    assert not findings, "\n".join(m for _, m in findings)


def test_checker_flags_a_renamed_series():
    from distkeras_tpu_torch.obs.report import REPORT_SERIES
    names = tuple(REPORT_SERIES) + ("serving.ttft_seconds",)
    assert [n for n, _ in lint.check(names)] == ["serving.ttft_seconds"]
