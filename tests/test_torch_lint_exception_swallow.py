"""tools/lint_torch_exception_swallow.py in tier-1: no handler in the
port's package swallows ``BaseException`` unmarked, and the checker
flags one injected into it."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import lint_torch_exception_swallow as lint  # noqa: E402

SWALLOW = ("def f(g):\n"
           "    try:\n"
           "        g()\n"
           "    except BaseException{mark}\n"
           "        pass\n")


def test_port_swallows_nothing_unmarked():
    findings = lint.check_tree(REPO)
    assert not findings, "\n".join(f"{f}:{ln}: {m}" for f, ln, m in findings)


def test_checker_flags_an_injected_swallow(tmp_path):
    pkg = tmp_path / "distkeras_tpu_torch" / "utils"
    pkg.mkdir(parents=True)
    (pkg / "bad.py").write_text(SWALLOW.format(mark=":"))
    findings = lint.check_tree(tmp_path)
    assert [(f, ln) for f, ln, _ in findings] == [
        ("distkeras_tpu_torch/utils/bad.py", 4)]
    (pkg / "bad.py").write_text(
        SWALLOW.format(mark=f":  # {lint.ALLOW_MARK} -- re-raised later"))
    assert lint.check_tree(tmp_path) == []
