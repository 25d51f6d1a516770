"""No module of the benchmark imports JAX, its libraries or the JAX
package (top-level names compared whole: the program's name begins with
the JAX package's), and the reference imports nothing of the program."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "eoe_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = {str(p.relative_to(BENCH)): sorted(set(_imports(p)) & FORBIDDEN) for p in files}
    assert not {k: v for k, v in bad.items() if v}


def test_reference_imports_no_program():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    for p in files:
        assert "eoe_tpu_torch" not in set(_imports(p)), p


def test_the_walk_sees_a_forbidden_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom eoe_tpu.models import x\nimport eoe_tpu_torch\n")
    assert set(_imports(p)) == {"jax", "eoe_tpu", "eoe_tpu_torch"}


def test_no_old_benchmark_files_read():
    for p in BENCH.rglob("*.py"):
        text = p.read_text()
        if p.name == Path(__file__).name:
            continue
        assert "BENCH_r0" not in text and "MULTICHIP_r0" not in text and "bench.py" not in text
