"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names, and the reference imports nothing of the
program."""
import ast
import os
import subprocess
import sys

from benchmark import cells, run

ROOT = os.path.dirname(cells.ROOT)
PORT = "cudatracerlib_tpu_torch"


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "cudatracerlib_tpu_torch_fake", sys)
    assert run.forbidden_modules() == [m for m in run.forbidden_modules()
                                       if m.split(".")[0] in run.FORBIDDEN]
    assert "cudatracerlib_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cudatracerlib_tpu.fake", sys)
    assert "cudatracerlib_tpu.fake" in run.forbidden_modules()


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from benchmark import run; from benchmark.tests.bench_helpers import *;"
            "run.run_cell('veach_mis.pt', SEED, 0.1, True, device='cpu',"
            " overrides=small_overrides('veach_mis.pt', 16));"
            "bad = run.forbidden_modules(); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(cells.ROOT, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for name in _imports(os.path.join(ref, f)):
                assert name.split(".")[0] not in (PORT, "jax", "cudatracerlib_tpu"), (f, name)
    code = ("import sys, torch; sys.path.insert(0, sys.argv[1]);"
            "from benchmark import cells, control;"
            "from benchmark.reference import judge;"
            "c = cells.load_cell('veach_mis.pt'); c.config.update(width=16, height=16);"
            "c.traffic['judge'] = {'tiles': 1, 'tile': 16, 'ref_spp': 2};"
            "judge.reference_tiles(c, cells.make_scene(c.config), 3, torch.device('cpu'));"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
            " ('cudatracerlib_tpu_torch', 'cudatracerlib_tpu', 'jax'));"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
