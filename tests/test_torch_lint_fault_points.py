"""tools/lint_torch_fault_points.py in tier-1: the port's fault-point
sites equal its catalog (``resilience.faults.CATALOG``), and a site or
a catalog entry on one side only is a finding."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import lint_torch_fault_points as lint  # noqa: E402

from distkeras_tpu_torch.resilience.faults import CATALOG  # noqa: E402


def test_port_fault_sites_equal_the_catalog():
    findings = lint.check()
    assert not findings, "\n".join(m for _, m in findings)
    assert len(CATALOG) == 12


def test_checker_flags_an_undocumented_site_and_a_stale_entry(tmp_path):
    pkg = tmp_path / "distkeras_tpu_torch"
    pkg.mkdir()
    (pkg / "mod.py").write_text(
        "from x import faults\n"
        "faults.point('serving.decode')\n"
        "faults.point('serving.new_site')\n"
        "faults.inject('serving.elsewhere', nth=1)\n")
    findings = lint.check(pkg, catalog={"serving.decode", "ckpt.write"})
    assert sorted(name for name, _ in findings) == ["ckpt.write",
                                                    "serving.new_site"]
