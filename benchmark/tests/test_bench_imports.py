"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program; module names are compared by
their whole top-level name."""

import ast
import glob
import os
import sys

import pytest

from benchmark import harness, spec

HERE = os.path.join(spec.ROOT, "benchmark")
FILES = sorted(glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True))


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    names = top_level_imports(os.path.join(HERE, "reference.py"))
    assert "bsmr_sddmm_tpu_torch" not in names
    assert names <= {"__future__", "numpy", "torch"}


def test_whole_name_comparison():
    assert harness.forbidden_modules(
        ["bsmr_sddmm_tpu_torch", "bsmr_sddmm_tpu_torch.ops", "jaxtyping",
         "torch"]) == []
    assert harness.forbidden_modules(
        ["jax.numpy", "bsmr_sddmm_tpu.ops", "flax"]) == [
            "bsmr_sddmm_tpu", "flax", "jax"]


def test_this_process_holds_none():
    assert "bsmr_sddmm_tpu" not in harness.forbidden_modules(
        [m for m in sys.modules if m.startswith("bsmr_sddmm_tpu_torch")])
