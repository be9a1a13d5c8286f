"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port (top-level module names compared
whole: the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "go_pocket_tts_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "_build" not in p.parts)


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_imports(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "references").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "go_pocket_tts_tpu_torch" not in set(top_level_imports(path))
    assert "pbench" not in set(top_level_imports(path))


def test_whole_name_compare():
    from pbench.harness import forbidden_loaded

    assert forbidden_loaded(["go_pocket_tts_tpu_torch.runtime.generate", "numpy", "jaxtyping"]) == []
    assert forbidden_loaded(["go_pocket_tts_tpu.models", "jax.numpy", "flax"]) == ["flax", "go_pocket_tts_tpu", "jax"]
