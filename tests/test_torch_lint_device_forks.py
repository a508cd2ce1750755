"""tools/lint_torch_device_forks.py in tier-1: outside the kernel
wrappers the port forks on the device only at marked host-mechanism
sites, asks ``torch.cuda.is_available()`` only where it resolves or
measures the card, and the checker flags each fork injected elsewhere."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import lint_torch_device_forks as lint  # noqa: E402

FORKS = ("import torch\n"
         "ok = torch.cuda.is_available()\n"
         "a = x.is_cuda\n"
         "b = x.device.type == 'cuda'\n"
         "c = dev.type\n"
         "d = self.device.type\n"
         "e = dtype.type\n"
         "f = y.is_cuda  # lint: allow-device-fork (pinned staging)\n")


def test_port_forks_only_where_allowed():
    findings = lint.check_tree(REPO)
    assert not findings, "\n".join(f"{f}:{ln}: {m}" for f, ln, m in findings)


def test_checker_flags_injected_forks_by_place(tmp_path):
    pkg = tmp_path / "distkeras_tpu_torch"
    for rel in ("serving/bad.py", "ops/kernel.py", "compat.py",
                "obs/tape.py"):
        (pkg / rel).parent.mkdir(parents=True, exist_ok=True)
        (pkg / rel).write_text(FORKS)
    got = [(f.split("distkeras_tpu_torch/")[1], ln)
           for f, ln, _ in lint.check_tree(tmp_path)]
    # compat.py: neither rule; obs/tape.py: forks only; ops/: the
    # availability question only; anywhere else: both
    assert got == [("obs/tape.py", 3),
                   ("obs/tape.py", 4), ("obs/tape.py", 5),
                   ("obs/tape.py", 6), ("ops/kernel.py", 2),
                   ("serving/bad.py", 2), ("serving/bad.py", 3),
                   ("serving/bad.py", 4), ("serving/bad.py", 5),
                   ("serving/bad.py", 6)]
