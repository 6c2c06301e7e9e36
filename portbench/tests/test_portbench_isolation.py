"""Nothing the benchmark runs imports JAX or the JAX package (whole
top-level names), the reference imports nothing of the program, and
nothing reads the JAX package's benchmark or its assets."""

import ast
import os

import pytest

from harness import isolation

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib.xla_client",
                                  "flax", "flax.linen", "demonet_tpu",
                                  "demonet_tpu.models.builders"])
def test_refuses_jax_and_the_jax_package(name):
    assert isolation.forbidden_modules([name, "torch"]) == [name]


@pytest.mark.parametrize("name", ["demonet_tpu_torch",
                                  "demonet_tpu_torch.models.detection",
                                  "jaxtyping", "flaxen", "torch", "numpy"])
def test_allows_the_port_and_other_names(name):
    assert isolation.forbidden_modules([name]) == []


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not set(_imports(path)) & isolation.FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "demonet_tpu_torch" not in set(_imports(path)), path


def test_nothing_reads_the_jax_benchmark_or_its_assets():
    words = ("bench_assets", "chip_smoke", "bench.py")
    here = os.path.abspath(__file__)
    for path in _sources():
        if os.path.abspath(path) == here:
            continue
        text = open(path).read()
        assert not any(w in text for w in words), path


def test_the_process_has_not_loaded_jax():
    import harness.runner  # noqa: F401
    assert isolation.forbidden_modules() == []
