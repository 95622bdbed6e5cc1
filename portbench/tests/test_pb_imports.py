"""Nothing under portbench/ imports JAX or the JAX package (top-level names
compared whole: `redtail_tpu_torch` begins with `redtail_tpu`), and the
reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "redtail_tpu"}


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax(path):
    found = FORBIDDEN & set(top_level_imports(path))
    assert not found, f"{path} imports {found}"


REFERENCE = sorted((BENCH / "reference").rglob("*.py"))


@pytest.mark.parametrize("path", REFERENCE,
                         ids=[p.name for p in REFERENCE])
def test_reference_imports_nothing_of_the_program(path):
    names = set(top_level_imports(path))
    assert "redtail_tpu_torch" not in names
    assert not {n for n in names if n.startswith("redtail")}


def test_scan_compares_whole_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import redtail_tpu_torch.models\nimport jax.numpy\n"
                   "from redtail_tpu.ops import x\n")
    assert set(top_level_imports(src)) == {"redtail_tpu_torch", "jax",
                                           "redtail_tpu"}
    assert FORBIDDEN & {"redtail_tpu_torch"} == set()


def test_run_refuses_loaded_jax():
    import importlib.util
    spec = importlib.util.spec_from_file_location("pb_run", BENCH / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    assert run.forbidden_modules({"redtail_tpu_torch": 1, "torch": 1}) == []
    assert run.forbidden_modules({"jax.numpy": 1, "redtail_tpu.ops": 1,
                                  "flax": 1}) == ["flax", "jax.numpy",
                                                  "redtail_tpu.ops"]
