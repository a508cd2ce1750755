"""tools/lint_torch_host_sync.py in tier-1: the port's epoch loops and
serving loop read the device back only at their marked sites (exactly
one in the serving loop: ``_fetch``'s lagged read), and the checker
flags each PyTorch host-sync idiom injected into a loop."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import lint_torch_host_sync as lint  # noqa: E402


def test_port_loops_are_free_of_unmarked_host_syncs():
    findings = lint.check_tree(REPO)
    assert not findings, "\n".join(f"{f}:{ln}: {m}" for f, ln, m in findings)


def test_checker_flags_each_sync_idiom():
    src = ("import numpy as np\n"
           "import torch\n"
           "def epoch(loss, ev, rows, host):\n"
           "    a = loss.item()\n"
           "    b = loss.cpu()\n"
           "    c = loss.tolist()\n"
           "    d = loss.numpy()\n"
           "    e = float(loss)\n"
           "    torch.cuda.synchronize()\n"
           "    ev.synchronize()\n"
           "    f = float(len(rows))\n"
           "    g = float(np.mean(host))\n"
           "    h = np.asarray(host).tolist()\n"
           "    i = loss.cpu()  # lint: allow-host-sync\n")
    lines = [ln for _, ln, _ in lint.check_source(src, "x.py")]
    assert lines == [4, 5, 6, 7, 8, 9, 10]


def test_checker_scopes_the_serving_loop_and_counts_its_marks():
    src = ("class E:\n"
           "    def __init__(self, x):\n"
           "        self.n = float(x)\n"
           "    def _fetch(self, p):\n"
           "        p.event.synchronize()  # lint: allow-host-sync\n"
           "    def step(self, t):\n"
           "        return t.item()\n"
           "    def health(self, t):\n"
           "        return t.item()\n")
    funcs = {"_fetch", "step"}
    findings = lint.check_source(src, "e.py", only_funcs=funcs,
                                 allowed_marks=1)
    assert [ln for _, ln, _ in findings] == [7]
    two = src.replace("return t.item()\n    def health",
                      "return t.item()  # lint: allow-host-sync\n"
                      "    def health")
    assert [ln for _, ln, _ in lint.check_source(
        two, "e.py", only_funcs=funcs, allowed_marks=1)] == [0]
    assert lint.check_source(src, "e.py", only_funcs={"gone"})[0][1] == 0
