"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
references import nothing of the program either. Module names are compared
by their whole top-level name: `etude_tpu_torch` is not `etude_tpu`."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from h100_bench import harness

BENCH = harness.BENCH_DIR
JAX_SIDE = {"jax", "jaxlib", "flax", "etude_tpu"}
PROGRAM = {"etude_tpu_torch"}


def _sources(under: Path):
    return sorted(p for p in under.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


def _imported_tops(path: Path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", _sources(BENCH), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_side_import(path):
    assert not _imported_tops(path) & JAX_SIDE


@pytest.mark.parametrize("path", _sources(BENCH / "reference"),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    assert not _imported_tops(path) & (JAX_SIDE | PROGRAM)


def test_names_are_compared_whole():
    assert "etude_tpu_torch".split(".")[0] not in JAX_SIDE
    saved = dict(sys.modules)
    try:
        sys.modules["etude_tpu_torch_fake_probe"] = object()
        assert harness.forbidden_loaded() == sorted(
            n for n in sys.modules if n.split(".")[0] in harness.FORBIDDEN_MODULES)
        sys.modules["etude_tpu.fake_probe"] = object()
        assert "etude_tpu.fake_probe" in harness.forbidden_loaded()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_importing_every_module_loads_no_jax():
    """Import the harness, every driver, reference and metric in a fresh
    interpreter, and look at what it loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from h100_bench import harness\n"
        "import pathlib\n"
        "b = harness.BENCH_DIR\n"
        "for p in sorted(b.rglob('*.py')):\n"
        "    if 'tests' in p.relative_to(b).parts or p.name in ('run.py', 'control.py'):\n"
        "        continue\n"
        "    harness.load_module(p, 'probe_' + str(abs(hash(str(p)))))\n"
        "print(','.join(harness.forbidden_loaded()))\n" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == ""
