#!/usr/bin/env python
"""Static check: no ad-hoc host syncs in the PyTorch port's epoch loops
and serving loop.

The port's trainers keep per-step losses on the device until one fetch
at the epoch's end, and its serving engine pipelines each step's launch
behind the one in flight, reading a unit's tokens one iteration late
(``_fetch``). A stray device-to-host read dropped into either loop
makes the host wait for the card every step -- the regression class
``lint_host_sync.py`` pins down in the JAX package. The port's reads
are PyTorch's, so its rules are:

  * ``.item()``, ``.cpu()``, ``.tolist()`` and ``.numpy()`` calls (on
    anything but a name or call rooted in ``np``/``numpy``: host
    arrays);
  * ``float(x)`` where ``x`` is not a constant and mentions neither
    ``np``/``numpy`` nor ``len`` (``float(len(rows))`` and host numpy
    are not syncs);
  * ``torch.cuda.synchronize()`` and any ``.synchronize()`` method call
    (an ``Event``'s or a ``Stream``'s).

``__init__`` bodies are exempt, as in the JAX lint. Zones:

  * the epoch-loop modules (``EPOCH_LOOP_MODULES``): a sanctioned fetch
    (the epoch's end, ``val_logs``, a checkpoint's snapshot) carries
    ``# lint: allow-host-sync`` on its line;
  * the serving loop: the step/decode-path methods of
    ``serving/engine.py`` (``SERVING_LOOP_FUNCS``), which carry exactly
    one mark, the lagged read in ``_fetch`` -- none (the contract was
    deleted) or a second (a new sync slipped in) is a finding;
  * the speculation path: the propose/tree functions of
    ``serving/speculation.py`` (``SPECULATION_LOOP_FUNCS``).

Exit status 1 when findings exist (wired into tier-1 as
``tests/test_torch_lint_host_sync.py``).
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import List, Optional, Tuple

ALLOW_MARK = "lint: allow-host-sync"

EPOCH_LOOP_MODULES = (
    "distkeras_tpu_torch/parallel/trainers.py",
    "distkeras_tpu_torch/parallel/distributed.py",
    "distkeras_tpu_torch/parallel/engine.py",
)
SERVING_LOOP_MODULE = "distkeras_tpu_torch/serving/engine.py"
#: the serving iteration loop (JAX's set; the port has no
#: ``_merge_keys``: its per-slot keys chain on the card)
SERVING_LOOP_FUNCS = frozenset({
    "step", "_advance_decode", "_spec_step", "_launch_step",
    "_process_step", "_flush_pending", "_flush_host_window", "_fetch",
    "_fuse_window", "_inflight", "_ensure_decode_pages", "_fragmentation",
    "_record_iteration", "_finish", "_admit", "_expire_deadlines",
    "_spec_tree_step", "_tree_shape", "_adapt_tree", "_drop_swap",
    "_consume_spec",
})
#: the one sanctioned mark of the serving loop: ``_fetch``'s lagged read
SERVING_ALLOWED_MARKS = 1
SPECULATION_MODULE = "distkeras_tpu_torch/serving/speculation.py"
SPECULATION_LOOP_FUNCS = frozenset({
    "propose", "propose_tree", "lookup", "continuations", "_grow",
    "build_token_tree", "tree_ancestors", "_draft_steps", "_heal",
    "_context",
})
#: the tensor methods that read device memory back to the host
FETCH_METHODS = ("item", "cpu", "tolist", "numpy")

Finding = Tuple[str, int, str]


def _mentions(node: ast.AST, names) -> bool:
    return any(isinstance(sub, ast.Name) and sub.id in names
               for sub in ast.walk(node))


def _ranges(tree: ast.AST, names) -> List[Tuple[int, int]]:
    return [(n.lineno, n.end_lineno or n.lineno)
            for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n.name in names]


def _sync(node: ast.Call) -> Optional[str]:
    """What host sync a call is, or None."""
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr in FETCH_METHODS and not _mentions(f.value,
                                                      ("np", "numpy")):
            return (f".{f.attr}() reads the device back to the host; keep "
                    "the value on the card until the sanctioned fetch")
        if f.attr == "synchronize":
            return (".synchronize() blocks the host on the device; let "
                    "the sanctioned fetch bound the loop")
    elif isinstance(f, ast.Name) and f.id == "float" and node.args \
            and not isinstance(node.args[0], ast.Constant) \
            and not _mentions(node.args[0], ("np", "numpy", "len")):
        return ("float(<non-numpy value>) on a device scalar is a "
                "blocking transfer; fetch at the boundary (or go through "
                "numpy) instead")
    return None


def check_source(src: str, rel: str, only_funcs=None,
                 allowed_marks: Optional[int] = None) -> List[Finding]:
    """Findings for one file's source text. With ``only_funcs`` only
    statements inside those functions are checked; ``allowed_marks``
    asserts the exact number of marks inside that scope."""
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:  # a broken file is its own finding
        return [(rel, e.lineno or 0, f"syntax error: {e.msg}")]
    lines = src.splitlines()
    inits = _ranges(tree, ("__init__",))
    scope = None if only_funcs is None else _ranges(tree, only_funcs)
    if scope is not None and not scope:
        return [(rel, 0, "none of the scoped loop functions "
                         f"({', '.join(sorted(only_funcs))}) exist in "
                         "this file -- update the lint's function set")]

    def within(ln, spans):
        return any(lo <= ln <= hi for lo, hi in spans)

    out: List[Finding] = []
    if allowed_marks is not None:
        marks = sum(1 for ln, text in enumerate(lines, 1)
                    if ALLOW_MARK in text and within(ln, scope))
        if marks != allowed_marks:
            out.append((rel, 0, f"{marks} '{ALLOW_MARK}' mark(s) in the "
                                "serving loop, expected exactly "
                                f"{allowed_marks} (the lagged read in "
                                "_fetch)"))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        ln = node.lineno
        if (scope is not None and not within(ln, scope)) \
                or within(ln, inits) or ALLOW_MARK in lines[ln - 1]:
            continue
        msg = _sync(node)
        if msg:
            out.append((rel, ln, msg))
    return sorted(out, key=lambda f: f[1])


def check_tree(root: Path) -> List[Finding]:
    findings: List[Finding] = []
    for entry in EPOCH_LOOP_MODULES:
        findings.extend(check_source((root / entry).read_text(), entry))
    findings.extend(check_source(
        (root / SERVING_LOOP_MODULE).read_text(), SERVING_LOOP_MODULE,
        only_funcs=SERVING_LOOP_FUNCS,
        allowed_marks=SERVING_ALLOWED_MARKS))
    findings.extend(check_source(
        (root / SPECULATION_MODULE).read_text(), SPECULATION_MODULE,
        only_funcs=SPECULATION_LOOP_FUNCS))
    return findings


def main(argv=None) -> int:
    root = Path(argv[0]) if argv else Path(__file__).resolve().parent.parent
    findings = check_tree(root)
    for rel, lineno, msg in findings:
        print(f"{rel}:{lineno}: {msg}")
    if findings:
        print(f"{len(findings)} host-sync finding(s); route through the "
              f"sanctioned fetch points or mark the line with "
              f"'# {ALLOW_MARK}'", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
