"""No module of the benchmark or of what a run loads has the top-level
name of JAX or of the JAX package; the reference loads nothing of the
port. Top-level names are compared whole: the port's name starts with the
JAX package's."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest
from conftest import ROOT

from asrbench.registry import FORBIDDEN

PORT = "qwen3_asr_tpu_torch"
SOURCES = sorted((ROOT / "asrbench").rglob("*.py"))
# what judges `correct`: none of it may load the port
REFERENCE_SIDE = ("asrbench.reference.model", "asrbench.reference.mel",
                  "asrbench.reference.prompt", "asrbench.check", "asrbench.weights",
                  "asrbench.work", "asrbench.traffic")


def _imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    names = _imports(path)
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)
    if "reference" in path.parts or path.name in ("check.py", "weights.py", "work.py"):
        assert PORT not in names


def _loaded(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("LOADED:")][-1]
    return set(line[len("LOADED:"):].split(",")) - {""}


def test_reference_loads_nothing_of_the_port():
    """Nor does a family module, which loads the port only inside `load`
    and `port_config`."""
    code = ("import sys; " + "; ".join(f"import {m}" for m in REFERENCE_SIDE)
            + "; from asrbench import registry; registry.family({})"
            + "; print('LOADED:' + ','.join(sorted({m.split('.')[0] for m in sys.modules})))")
    loaded = _loaded(code)
    assert PORT not in loaded and not loaded & set(FORBIDDEN)


@pytest.mark.parametrize("cell", ["asr-short-cli", "align-longform-cli", "asr-server-poisson"])
def test_a_run_loads_no_jax(cell):
    """A whole run at a tiny size on the CPU: the program, the trace and
    the reference, then the modules loaded."""
    code = (
        "import sys; sys.path.insert(0, 'asrbench/tests'); "
        "from conftest import tiny_cell; from asrbench.run import run_cell; "
        "from asrbench.registry import forbidden_modules; "
        f"r = run_cell(tiny_cell({cell!r}), 3, 1.0, True, device='cpu', read_metrics=False); "
        "assert r['compared']; print('LOADED:' + ','.join(forbidden_modules()))")
    assert _loaded(code) == set()
