"""Nothing the card's run reaches imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names compared
whole (the port's `cover_vla_tpu_torch` begins with `cover_vla_tpu`)."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from coverbench.run import FORBIDDEN, forbidden_modules

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
SOURCES = sorted(p for p in glob.glob(os.path.join(HERE, "**", "*.py"),
                                      recursive=True)
                 if os.sep + "tests" + os.sep not in p)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, HERE) for p in SOURCES])
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py",):
        assert top_level_imports(os.path.join(HERE, name)) <= {
            "__future__", "hashlib", "math", "numpy", "torch"}
    code = ("import sys; sys.modules['cover_vla_tpu_torch'] = None; "
            "import coverbench.reference, coverbench.yardstick")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_forbidden_names_compared_whole():
    assert forbidden_modules(["cover_vla_tpu_torch", "cover_vla_tpu_torch.ops",
                              "numpy", "jaxtyping"]) == []
    assert forbidden_modules(["cover_vla_tpu.models", "jax.numpy",
                              "ml_dtypes"]) == ["cover_vla_tpu", "jax",
                                                "ml_dtypes"]


def test_run_process_loads_no_jax():
    """The harness's modules and the port's step, imported in a fresh
    process, leave no forbidden module loaded."""
    code = ("import sys, coverbench.run, coverbench.harness, "
            "coverbench.readings; "
            "import cover_vla_tpu_torch.engine.batched_engine, "
            "cover_vla_tpu_torch.ops.quant; "
            "from coverbench.run import forbidden_modules; "
            "bad = forbidden_modules(); print(bad); sys.exit(1 if bad else 0)")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)
