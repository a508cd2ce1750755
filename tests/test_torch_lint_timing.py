"""tools/lint_torch_timing.py in tier-1: the port's package reads no raw
clock outside ``utils/profiling.py``, ``obs/`` and its examples, and the
checker flags one injected into a file it scans."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import lint_torch_timing as lint  # noqa: E402


def test_port_is_free_of_raw_clocks():
    findings = lint.check_tree(REPO)
    assert not findings, "\n".join(f"{f}:{ln}: {m}" for f, ln, m in findings)


def test_checker_flags_an_injected_raw_clock(tmp_path):
    pkg = tmp_path / "distkeras_tpu_torch"
    for rel in ("utils/history.py", "utils/profiling.py", "obs/tape.py",
                "examples/demo.py"):
        (pkg / rel).parent.mkdir(parents=True, exist_ok=True)
        (pkg / rel).write_text("import time\nt = time.time()\n")
    findings = lint.check_tree(tmp_path)
    assert [(f, ln) for f, ln, _ in findings] == [
        ("distkeras_tpu_torch/utils/history.py", 2)]
    (pkg / "utils/history.py").write_text(
        f"import time\nt = time.time()  # {lint.ALLOW_MARK}: a deadline\n")
    assert lint.check_tree(tmp_path) == []
