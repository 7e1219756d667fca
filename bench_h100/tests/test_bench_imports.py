"""No file of the benchmark imports JAX or the JAX package, and the
plain references import nothing of the program.  Top-level module names
(the part before the first dot) are compared whole, so ``repro_torch``
is not ``repro``."""

import ast
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def imported_tops(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f.relative_to(HERE)): imported_tops(f) & FORBIDDEN
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_the_references_import_nothing_of_the_program():
    files = sorted((HERE / "reference").rglob("*.py"))
    assert files
    for f in files:
        assert "repro_torch" not in imported_tops(f), f


def test_the_scan_sees_whole_names(tmp_path):
    tmp = tmp_path / "probe.py"
    tmp.write_text("import repro_torch.kernels\nfrom repro_torch import ops\n"
                   "import jaxtyping\nfrom repro.core import x\n")
    tops = imported_tops(tmp)
    assert tops & FORBIDDEN == {"repro"}
    assert {"repro_torch", "jaxtyping"} <= tops
