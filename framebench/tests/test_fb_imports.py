"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: every module under
framebench/, its top-level import names compared whole."""
import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "libplacebo_tpu"}


def _modules(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    """The top-level names a module imports (absolute imports only: a
    relative import stays inside its package)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_modules("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "libplacebo_tpu_torch" not in names
    assert "framebench" not in names


def test_names_compared_whole(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import libplacebo_tpu_torch.ops\nimport jaxtyping\n"
                 "from libplacebo_tpu.core import x\n")
    assert top_level_imports(str(p)) & FORBIDDEN == {"libplacebo_tpu"}
