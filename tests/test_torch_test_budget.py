"""Every port test runs under a time limit, and so does every process and
notebook it starts.

``tests/torch_time_limit.py`` gives each test ``TEST_SECONDS`` through an
autouse fixture that every ``tests/test_torch_*.py`` imports. A process
that hangs should fail its test with its own message within that. So every
``subprocess`` call that waits (``run``, ``call``, ``check_call``,
``check_output``), every ``communicate`` of a ``Popen`` and every
``nbclient.NotebookClient`` or ``nbconvert`` ``ExecutePreprocessor`` in the
port's test files and the rank worker passes a ``timeout`` no larger than
the limit: a number, a top-level name bound to one, or ``min`` of anything
with one of those. Read from the sources with ``ast``: no jax, no torch.
"""

import ast
from pathlib import Path

from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)

TESTS = Path(__file__).resolve().parent
TEST_FILES = sorted(TESTS.glob("test_torch_*.py"))
FILES = TEST_FILES + [TESTS / "torch_rank_worker.py"]
RUNS = {"run", "call", "check_call", "check_output"}
WAITS = {"communicate", "NotebookClient", "ExecutePreprocessor"}


def _constants(tree):
    """The module's top-level ``NAME = <number>`` assignments."""
    return {node.targets[0].id: node.value.value for node in tree.body
            if isinstance(node, ast.Assign) and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name) and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, (int, float))}


def _seconds(node, names):
    """The most seconds ``node`` can give, or None if it is not bounded."""
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return node.value
    if isinstance(node, ast.Name):
        return names.get(node.id)
    if isinstance(node, ast.Call) and _callee(node) == "min":
        bounds = [b for b in (_seconds(a, names) for a in node.args) if b is not None]
        return min(bounds, default=None)
    return None


def _callee(call):
    f = call.func
    return f.attr if isinstance(f, ast.Attribute) else f.id if isinstance(f, ast.Name) else None


def _waits(call, from_subprocess):
    """Whether ``call`` starts or waits for a process or notebook kernel:
    ``subprocess.run(...)`` (or ``run`` imported from ``subprocess``), any
    ``.communicate(...)``, a notebook client."""
    f, name = call.func, _callee(call)
    if name in RUNS:
        if isinstance(f, ast.Attribute):
            return isinstance(f.value, ast.Name) and f.value.id == "subprocess"
        return name in from_subprocess
    return name in WAITS


def test_every_subprocess_and_notebook_has_a_timeout_within_the_test_limit():
    limit = _constants(ast.parse((TESTS / "torch_time_limit.py").read_text()))["TEST_SECONDS"]
    found, faults = 0, []
    for path in FILES:
        tree = ast.parse(path.read_text())
        names = _constants(tree)
        imported = {a.asname or a.name for node in ast.walk(tree)
                    if isinstance(node, ast.ImportFrom) and node.module == "subprocess"
                    for a in node.names}
        for call in ast.walk(tree):
            if not (isinstance(call, ast.Call) and _waits(call, imported)):
                continue
            found += 1
            where = f"{path.name}:{call.lineno} {_callee(call)}"
            kw = {k.arg: k.value for k in call.keywords}
            seconds = _seconds(kw["timeout"], names) if "timeout" in kw else None
            if seconds is None:
                faults.append(f"{where}: no timeout bounded by a constant of the file")
            elif not 0 < seconds <= limit:
                faults.append(f"{where}: timeout {seconds} s, the per-test limit {limit} s")
    assert not faults, faults
    assert found >= 5  # the rank worker's, the checkpoint's and the notebooks' at least


def test_every_port_test_file_imports_the_time_limit():
    def imports_it(path):
        return any(isinstance(n, ast.ImportFrom) and n.module == "torch_time_limit"
                   and any(a.name == "time_limit" for a in n.names)
                   for n in ast.walk(ast.parse(path.read_text())))
    assert not [p.name for p in TEST_FILES if not imports_it(p)]
