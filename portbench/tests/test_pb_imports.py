"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program either. Top-level names
are compared whole: the program's name begins with the JAX package's."""
import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEVER = {"jax", "jaxlib", "flax", "xivo_tpu"}
PROGRAM = "xivo_tpu_torch"
# the reference's side: the frozen copy, its drivers, the generators and
# the arithmetic it is judged by
REFERENCE = ("vioref", "refs", "gen", "peaks.py")


def modules():
    for root, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & NEVER


@pytest.mark.parametrize("path", sorted(
    p for p in modules()
    if os.path.relpath(p, HERE).split(os.sep)[0] in REFERENCE),
    ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in set(top_level_imports(path))


def test_the_scan_sees_the_program():
    """The scan finds the program where the program's side imports it."""
    entries = os.path.join(HERE, "entries", "pcw.py")
    assert PROGRAM in set(top_level_imports(entries))
