"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared whole: `gubernator_tpu_torch` is not `gubernator_tpu`."""

import ast
import glob
import os
import subprocess
import sys

from portbench import bench
from portbench.tests import tiny

PORTBENCH = os.path.join(tiny.ROOT, "portbench")


def imported_tops(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    files = glob.glob(os.path.join(PORTBENCH, "**", "*.py"), recursive=True)
    assert files
    for path in files:
        assert not set(imported_tops(path)) & set(bench.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "roofline.py", "traffic.py", "control.py"):
        tops = set(imported_tops(os.path.join(PORTBENCH, name)))
        assert "gubernator_tpu_torch" not in tops and "torch" not in tops, name
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference, portbench.control; "
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('gubernator')))"
            % tiny.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True).stdout.strip()
    assert out == "[]"


def test_a_whole_run_loads_no_jax():
    code = f"""
import sys, time
sys.path.insert(0, {tiny.ROOT!r})
from portbench import bench
from portbench.tests import tiny
config, m = tiny.cell("leaky1m-batched-128c")
bench.run_cell({{"name": "x"}}, config, m, 3, 0.5, False, device="cpu",
               t_start=time.perf_counter(), log=lambda *a: None)
print(bench.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout.strip().splitlines()
    assert out[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gubernator_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert "gubernator_tpu" not in bench.forbidden_modules()
    assert "jax" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in bench.forbidden_modules()
