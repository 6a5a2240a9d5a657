"""Nothing under portbench imports JAX or the JAX package, and the plain
reference imports nothing of the program (top-level names compared whole:
the program's name begins with the JAX package's)."""

import ast
import os

from _util import ROOT

JAX_NAMES = {"jax", "jaxlib", "flax", "mav_tube_trajectory_generation_tpu"}
PROGRAM = "mav_tube_trajectory_generation_tpu_torch"


def _top_level_imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".", 1)[0])
    return out


def _files(sub=""):
    base = os.path.join(ROOT, "portbench", sub)
    for d, _, fs in os.walk(base):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    for path in _files():
        assert not (_top_level_imports(path) & JAX_NAMES), path


def test_reference_imports_nothing_of_the_program():
    for path in _files("reference"):
        names = _top_level_imports(path)
        assert PROGRAM not in names, path
        assert names <= {"__future__", "math", "typing", "numpy", "torch"}, path


def test_nothing_reads_the_old_benchmarks_folder():
    for path in _files():
        if path == os.path.abspath(__file__):
            continue
        with open(path) as fh:
            text = fh.read()
        assert "benchmarks/" not in text and '"benchmarks"' not in text, path


def test_the_names_are_compared_whole():
    from portbench import core
    assert "mav_tube_trajectory_generation_tpu" in core.FORBIDDEN_MODULES
    assert PROGRAM not in core.FORBIDDEN_MODULES
