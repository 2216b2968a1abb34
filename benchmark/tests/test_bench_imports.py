"""Nothing the benchmark runs imports JAX or the JAX package (compared by
whole top-level names: the port's name begins with the JAX package's), and
the reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ucod_dpl_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "ucod_dpl_tpu_torch" not in set(_imports(path))
    assert not {"ucod_dpl_tpu_torch", "jax"} & set(path.read_text().split())


def test_the_guard_compares_whole_top_level_names():
    import sys

    from benchmark import run

    try:
        sys.modules["ucod_dpl_tpu_torch_fake"] = sys
        assert "ucod_dpl_tpu" not in run.loaded_forbidden()
        sys.modules["ucod_dpl_tpu.fake"] = sys
        assert "ucod_dpl_tpu" in run.loaded_forbidden()
    finally:
        sys.modules.pop("ucod_dpl_tpu_torch_fake", None)
        sys.modules.pop("ucod_dpl_tpu.fake", None)
