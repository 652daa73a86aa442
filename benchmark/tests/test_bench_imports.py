"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (``ndcn_tpu_torch`` begins with ``ndcn_tpu``),
and the reference, the work counts and the trace arithmetic import no part
of the port either: a static look at every import under ``benchmark/`` and
the modules a fresh process holds after a whole run."""

import ast
import json
import subprocess
import sys

from benchmark.spec import HERE
from benchmark.tests import tiny_root

FORBIDDEN = {"jax", "jaxlib", "flax", "ndcn_tpu"}
# the yardstick: no module of the program in them or what they import
YARDSTICK = ("reference/__init__.py", "reference/dopri5.py",
             "reference/ndcn.py", "reference/products.py", "roofline.py",
             "trace.py", "check.py", "inputs.py")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_yardstick_imports_no_part_of_the_port():
    for rel in YARDSTICK:
        tops = {m.split(".")[0] for m in _imports(HERE / rel)}
        assert "ndcn_tpu_torch" not in tops, rel
    code = ("import sys, benchmark.check, benchmark.inputs, "
            "benchmark.roofline, benchmark.trace, benchmark.reference.ndcn; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, check=True)
    tops = set(json.loads(out.stdout.replace("'", '"')))
    assert not tops & (FORBIDDEN | {"ndcn_tpu_torch"})


def test_a_whole_run_loads_neither(tmp_path):
    root = tiny_root.make(tmp_path)
    code = (
        "import sys, time, json, torch; torch.set_num_threads(2)\n"
        "from pathlib import Path\n"
        "from benchmark import run\n"
        f"c, r = run.run_cell('grid400.train-graphed', 5, 0.2, True, "
        f"device='cpu', root=Path({str(root)!r}), t_start=time.time())\n"
        "print(json.dumps([c, r['correct'], sorted({m.split('.')[0] for m "
        "in sys.modules})]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, check=True)
    c, correct, tops = json.loads(out.stdout.splitlines()[-1])
    assert c == 0 and correct
    assert "ndcn_tpu_torch" in tops
    assert not set(tops) & FORBIDDEN
