"""Nothing under rtbench/ imports JAX or rtf_tpu, and nothing under
rtbench/reference/ imports the program: top-level module names compared
whole (rtf_tpu_torch begins with rtf_tpu)."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_rtf_tpu(path):
    bad = top_level_imports(path) & {"jax", "jaxlib", "flax", "rtf_tpu"}
    assert not bad, bad


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "rtf_tpu_torch" not in top_level_imports(path), path


def test_frozen_files_name_their_origin():
    for path in (BENCH / "reference" / "frozen").rglob("*.py"):
        if path.name != "__init__.py":
            assert path.read_text().startswith(
                "# Frozen copy of rtf_tpu_torch/"), path


def test_the_scan_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import rtf_tpu_torch.render\nfrom jax.numpy import x\n")
    assert top_level_imports(p) == {"rtf_tpu_torch", "jax"}


def test_scene_makers_import_nothing_of_the_program():
    """The reference builds its scene through rtbench/scenes.py and the
    makers of rtbench/makers/, so they take their classes from `Kinds`."""
    for path in [BENCH / "scenes.py", *(BENCH / "makers").glob("*.py")]:
        assert "rtf_tpu_torch" not in top_level_imports(path), path
