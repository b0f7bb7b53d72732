"""No file of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the port. Module names are compared by their
whole top-level name, so ``repro_torch`` is not ``repro``."""
import ast
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files():
    return sorted(HERE.rglob("*.py"))


def test_no_file_imports_jax_or_the_jax_package():
    bad = {str(p): sorted(set(_imports(p)) & NEVER) for p in _files()}
    assert not {p: b for p, b in bad.items() if b}


def test_the_reference_imports_nothing_of_the_port():
    ref = [p for p in _files() if "reference" in p.parts]
    assert ref
    bad = {str(p): sorted(set(_imports(p)) & (NEVER | {"repro_torch"}))
           for p in ref}
    assert not {p: b for p, b in bad.items() if b}


def test_the_walk_tells_repro_torch_from_repro(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.serving\nfrom repro.models import x\n")
    assert set(_imports(f)) == {"repro_torch", "repro"}
