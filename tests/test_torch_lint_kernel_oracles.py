"""tools/lint_torch_kernel_oracles.py in tier-1: every public ``ops/``
function of the port that loads a kernel has a card case in
``tests/test_torch_cuda.py`` and a test against its module's plain
version, and the checker flags an entry point with neither."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import lint_torch_kernel_oracles as lint  # noqa: E402

MODULE = ("from x import kernels\n"
          "def _launch(t):\n"
          "    return kernels.library('k')\n"
          "def public_op(t):\n"
          "    return _launch(t)\n"
          "def helper(t):\n"
          "    return t\n"
          "def public_op_reference(t):\n"
          "    return t\n")


def test_every_port_kernel_entry_point_is_held_to_its_plain_version():
    findings = lint.check_tree(REPO)
    assert not findings, "\n".join(f"{f}:{ln}: {m}" for f, ln, m in findings)


def test_entry_points_reach_the_kernel_through_private_helpers():
    entries, plain = lint.kernel_entry_points(MODULE, "m.py")
    assert entries == [("public_op", 4)] and plain == ["public_op_reference"]


def test_checker_flags_an_entry_point_without_oracles(tmp_path):
    ops = tmp_path / "distkeras_tpu_torch" / "ops"
    ops.mkdir(parents=True)
    (ops / "m.py").write_text(MODULE)
    tests = tmp_path / "tests"
    tests.mkdir()
    (tests / "test_torch_cuda.py").write_text("# nothing here\n")
    assert len(lint.check_tree(tmp_path)) == 2
    (tests / "test_torch_cuda.py").write_text("public_op(x)\n")
    (tests / "test_torch_m.py").write_text(
        "assert public_op(x) == public_op_reference(x)\n")
    assert lint.check_tree(tmp_path) == []
