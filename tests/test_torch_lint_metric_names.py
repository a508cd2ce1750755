"""tools/lint_torch_metric_names.py in tier-1: every registry metric the
port's package names is a literal ``component.snake_case``, and the
checker flags a runtime-built one injected into it."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import lint_torch_metric_names as lint  # noqa: E402


def test_port_metric_names_are_literal():
    findings = lint.check_tree(REPO)
    assert not findings, "\n".join(f"{f}:{ln}: {m}" for f, ln, m in findings)


def test_checker_flags_injected_dynamic_and_malformed_names(tmp_path):
    pkg = tmp_path / "distkeras_tpu_torch"
    (pkg / "obs").mkdir(parents=True)
    (pkg / "examples").mkdir()
    (pkg / "obs" / "bad.py").write_text(
        "reg.counter('serving.ok_total')\n"
        "reg.gauge(f'serving.{name}')\n"
        "reg.histogram('NoDots')\n")
    (pkg / "examples" / "demo.py").write_text("reg.gauge(name)\n")
    findings = lint.check_tree(tmp_path)
    assert [(f, ln) for f, ln, _ in findings] == [
        ("distkeras_tpu_torch/obs/bad.py", 2),
        ("distkeras_tpu_torch/obs/bad.py", 3)]
