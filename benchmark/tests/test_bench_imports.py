"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: every import statement's
top-level name (before the first dot) compared whole."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "pasta_gan_tpu"}


def modules():
    for root, _, files in os.walk(BENCH):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(root, f), BENCH)


def imported_names(path):
    tree = ast.parse(open(os.path.join(BENCH, path)).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(modules()))
def test_no_jax_import(path):
    bad = [n for n in imported_names(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted(p for p in modules() if p.startswith("reference" + os.sep)))
def test_reference_imports_nothing_of_the_program(path):
    bad = [n for n in imported_names(path) if n.split(".")[0] == "pasta_gan_tpu_torch" or n.startswith("benchmark")]
    assert not bad, f"{path} imports {bad}"
    assert "pasta_gan_tpu_torch" not in open(os.path.join(BENCH, path)).read(), path


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    import sys

    from benchmark.harness import env

    for name in ("pasta_gan_tpu_torch_fake", "jaxtyping_fake", "jax.numpy", "pasta_gan_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, object())
    found = env.forbidden_modules()
    assert "jax.numpy" in found and "pasta_gan_tpu.ops" in found
    assert "pasta_gan_tpu_torch_fake" not in found and "jaxtyping_fake" not in found
