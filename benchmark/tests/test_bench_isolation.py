"""No module of the benchmark imports JAX, the JAX package or the
repository's JAX-side scripts, and the plain reference imports nothing of
the port: every import of every module under benchmark/, read by its AST,
compared by its top-level name as a whole string (the port's name begins
with the JAX package's)."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "geoformer_tpu", "bench", "tools",
             "__graft_entry__"}


def _modules():
    for root, _, files in os.walk(BENCH):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", list(_modules()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_anywhere(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in _modules()
                                  if os.sep + "reference" + os.sep in p],
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_port(path):
    assert "geoformer_tpu_torch" not in set(_imports(path))


def test_names_are_compared_whole():
    from benchmark import harness

    assert set(harness.FORBIDDEN) == FORBIDDEN
    assert "geoformer_tpu_torch".split(".")[0] not in harness.FORBIDDEN
