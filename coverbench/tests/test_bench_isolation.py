"""Nothing the card's run reaches imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names compared
whole (the port's `cover_vla_tpu_torch` begins with `cover_vla_tpu`)."""

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

from coverbench import reference
from coverbench.backbones import gemma
from coverbench.run import FORBIDDEN, forbidden_modules
from coverbench.tests.tiny import episode_inputs, make_weights, tiny_cell

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


def test_reference_imports_nothing_of_the_program(tmp_path):
    """The reference imports plain libraries and the benchmark's own
    modules, and runs a whole episode through its backbone's layers, at
    full precision and on the int8 grid, in a process where neither the
    program nor the JAX package can be imported: an import that the
    reference or a backbone's layers make when they run fails there."""
    for name in ("reference.py",):
        assert top_level_imports(os.path.join(HERE, name)) <= {
            "__future__", "hashlib", "math", "numpy", "torch", "coverbench"}
    torch.set_num_threads(2)
    cell = tiny_cell("w8a8")
    args = (make_weights(cell.config, cell, gemma), cell.config,
            *episode_inputs(cell.config, cell))
    torch.save(args, tmp_path / "args.pt")
    code = ("import sys, torch; torch.set_num_threads(2); "
            "sys.modules['cover_vla_tpu_torch'] = None; "
            "sys.modules['cover_vla_tpu'] = None; "
            "from coverbench import reference; "
            "args = torch.load(sys.argv[1], weights_only=False); "
            "torch.save({lv: reference.episode(*args, lv, 'cpu') "
            "for lv in (None, 127)}, sys.argv[2])")
    subprocess.run([sys.executable, "-c", code, str(tmp_path / "args.pt"),
                    str(tmp_path / "out.pt")], cwd=ROOT, check=True,
                   timeout=300)
    got = torch.load(tmp_path / "out.pt")
    for levels, out in got.items():
        want = reference.episode(*args, levels, "cpu")
        assert set(out) == set(want)
        for key in want:
            assert torch.equal(out[key], want[key]), (levels, key)


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
