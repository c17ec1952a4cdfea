"""The port stands alone: etude_tpu_torch and chip_smoke.py import nothing
of JAX, of the JAX package, of orbax, of pydantic or of pandas, and PyYAML
only inside the guarded settings reader, so they run where only torch,
numpy and the CUDA toolkit are installed. No file of the package is large."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "etude_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "etude_tpu", "orbax", "pydantic", "yaml", "pandas")
# (file, enclosing function) where `import yaml` is allowed: only when the
# caller names a YAML settings file.
YAML_ALLOWED = {("etude_tpu_torch/config.py", "_read_settings")}


def _imports(path: Path):
    """(module, enclosing function or None) for every absolute import."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    found = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            if isinstance(child, ast.Import):
                found.extend((a.name, func) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                found.append((child.module, func))
            visit(child, func)

    visit(tree, None)
    return found


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_imports(path):
    rel = str(path.relative_to(REPO))
    for module, func in _imports(path):
        top = module.split(".")[0]
        if top == "yaml" and (rel, func) in YAML_ALLOWED:
            continue
        assert top not in FORBIDDEN, f"{rel} imports {module} (in {func or 'module'})"


def test_yaml_import_is_guarded():
    imports = _imports(REPO / "etude_tpu_torch" / "config.py")
    assert ("yaml", "_read_settings") in imports


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib, etude_tpu_torch\n"
        "for m in pkgutil.walk_packages(etude_tpu_torch.__path__, 'etude_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_the_serving_options_modules_are_covered():
    """The modules of the rebuild engine, the attribute prior, reference
    weights and their synthetic writer are among the files checked above."""
    covered = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert {"etude_tpu_torch/models/generate.py", "etude_tpu_torch/models/attr_prior.py",
            "etude_tpu_torch/utils/torch_port.py",
            "etude_tpu_torch/tools/reference_state.py"} <= covered


def test_no_large_files_in_the_package():
    for path in (REPO / "etude_tpu_torch").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert path.stat().st_size < 2**20, f"{path} is over 1 MB"
        assert path.suffix not in (".so", ".npz", ".pt", ".pth"), path
