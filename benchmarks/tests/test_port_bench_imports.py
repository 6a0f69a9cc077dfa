"""An AST scan of every module under benchmarks/: none imports JAX, its
libraries or the JAX package (top-level names compared whole: the port's
name begins with the JAX package's), nor bench.py, chip_smoke.py or tools/;
the reference imports nothing of the program either."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "optax", "orbax", "tf_operator_tpu", "bench", "chip_smoke",
         "tools"}
NOT_IN_REFERENCE = NEVER | {"tf_operator_tpu_torch"}
MODULES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path: Path) -> set[str]:
    """The top-level names of every module `path` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.partition(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) in (
                "import_module", "__import__") and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.partition(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_forbidden_import(path):
    never = NOT_IN_REFERENCE if "reference" in path.relative_to(HERE).parts else NEVER
    assert not imported(path) & never


def test_the_scan_compares_whole_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import tf_operator_tpu_torch.ops\nfrom tf_operator_tpu.models import x\n"
                   "import jax.numpy as jnp\n")
    assert imported(src) == {"tf_operator_tpu_torch", "tf_operator_tpu", "jax"}
    assert imported(src) & NEVER == {"tf_operator_tpu", "jax"}


def test_the_scan_sees_every_module():
    names = {str(p.relative_to(HERE)) for p in MODULES}
    assert {"run.py", "flops.py", "trace.py", "reference/bert_mlm.py",
            "metrics/mfu.py"} <= names
