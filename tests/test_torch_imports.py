"""The port imports torch, numpy and the standard library only: every
``.py`` file under ``src/repro_torch/``, and ``chip_smoke.py``, parsed
with ``ast`` -- no ``import jax`` / ``from jax ...`` and nothing of the
JAX package ``repro``, at any depth of the file (a function's lazy
import included)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imports(path: pathlib.Path):
    """Every module name an import statement of ``path`` names."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _banned(name: str) -> bool:
    return name.split(".")[0] in BANNED


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_repro(path):
    bad = [n for n in _imports(path) if _banned(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_guard_sees_every_form(tmp_path):
    """The guard's own check: each banned form is caught, the port's own
    package name is not."""
    src = tmp_path / "m.py"
    src.write_text("import os\nimport jax.numpy as jnp\n"
                   "from repro.serve import engine\n"
                   "from repro_torch import prng\n"
                   "def f():\n    import jaxlib\n    from . import x\n")
    assert [n for n in _imports(src) if _banned(n)] == [
        "jax.numpy", "repro.serve", "jaxlib"]


@pytest.mark.parametrize("rel", [
    "src/repro_torch/models/rglru.py", "src/repro_torch/paper/__init__.py",
    "src/repro_torch/paper/__main__.py", "src/repro_torch/paper/table1.py",
    "src/repro_torch/paper/fig23.py", "src/repro_torch/paper/classifier.py",
    "src/repro_torch/parallel/moe_ep.py", "src/repro_torch/tree.py",
    "src/repro_torch/optim/optimizer.py",
    "src/repro_torch/optim/compression.py",
    "src/repro_torch/data/pipeline.py",
    "src/repro_torch/checkpoint/manager.py",
    "src/repro_torch/runtime/fault_tolerance.py",
    "src/repro_torch/launch/steps.py", "src/repro_torch/launch/train.py"])
def test_the_guard_covers_the_hybrid_and_paper_modules(rel):
    assert ROOT / rel in FILES
