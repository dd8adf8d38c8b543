"""Nothing under benchmark/ imports JAX, its libraries or the JAX package:
an ``ast`` walk of every ``.py``, top-level module names compared whole
(``desenet_tpu_torch`` is the port and allowed)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "desenet_tpu"}


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".", 1)[0])
    return out


SOURCES = sorted(p for p in BENCH.rglob("*.py") if ".cache" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not imported_tops(path) & FORBIDDEN


def test_the_walk_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import desenet_tpu_torch\nfrom desenet_tpu.ops import x\n")
    assert imported_tops(bad) & FORBIDDEN == {"desenet_tpu"}
    ok = tmp_path / "ok.py"
    ok.write_text("import desenet_tpu_torch.api\nimport jaxtyping\n")
    assert not imported_tops(ok) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert "desenet_tpu_torch" not in imported_tops(path), path
