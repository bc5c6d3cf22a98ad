"""Nothing a run loads is JAX or the JAX package, and the reference
imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from _tiny import PKG, ROOT
from gridbench.guard import forbidden_modules


@pytest.mark.parametrize("names,found", [
    (["jax"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["csparse3_tpu", "csparse3_tpu.ops"], ["csparse3_tpu"]),
    (["csparse3_tpu_torch", "csparse3_tpu_torch.models.powerflow"], []),
    (["jax_utils", "jaxtyping", "numpy"], []),
])
def test_whole_top_level_names(names, found):
    assert forbidden_modules(names) == found


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.module
            else:
                yield "." * node.level + (node.module or "")


def _files(*parts):
    base = os.path.join(PKG, *parts)
    for dirpath, _, names in os.walk(base):
        if "tests" in dirpath.split(os.sep):
            continue
        yield from (os.path.join(dirpath, n) for n in names
                    if n.endswith(".py"))


def test_reference_imports_only_numpy_scipy_and_itself():
    for path in _files("reference"):
        for mod in _imports(path):
            top = mod.split(".", 1)[0]
            assert mod.startswith(".") or top in {
                "__future__", "numpy", "scipy", "warnings"}, (path, mod)


def test_no_benchmark_file_imports_jax():
    for path in _files():
        tops = {m.split(".", 1)[0] for m in _imports(path)}
        assert not forbidden_modules(tops), path


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import gridbench.reference.compare, "
            "gridbench.reference.powerflow; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('csparse3_tpu_torch', 'csparse3_tpu', 'jax', 'torch')); "
            "print(bad); sys.exit(1 if bad else 0)" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
