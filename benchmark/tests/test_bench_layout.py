"""A configuration, a traffic mix, a cell and a per-layer metric are added
by new files alone: in a copy of the benchmark, new files make a new cell
that runs (on the CPU) and reports the new metric."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import cells

ROOT = os.path.dirname(cells.ROOT)


def test_existing_cells_resolve():
    names = cells.cell_names()
    assert {"cornell_box.game", "veach_mis.pt", "veach_mis.sobol"} <= set(names)
    for n in names:
        c = cells.load_cell(n)
        assert c.chips == 1
        assert set(c.workload["limits"]) and c.traffic["reference"] in ("path", "game")


def test_bad_names_refused():
    for bad in ("../x", "a/b", "", ".hidden", "a b"):
        with pytest.raises(ValueError):
            cells.load_cell(bad)


def test_new_cell_from_new_files_only(tmp_path):
    dst = tmp_path / "benchmark"
    shutil.copytree(cells.ROOT, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((dst / "configs" / "veach_mis.json").read_text())
    cfg.update(name="veach_tiny", width=16, height=16, fill_light_radiance=400.0)
    (dst / "configs" / "veach_tiny.json").write_text(json.dumps(cfg))
    tr = json.loads((dst / "traffic" / "pt.json").read_text())
    tr["kwargs"]["max_depth"] = 3
    tr["judge"] = {"tiles": 1, "tile": 16, "ref_spp": 4}
    tr["trace_passes"] = 1
    (dst / "traffic" / "pt_depth3.json").write_text(json.dumps(tr))
    (dst / "workloads" / "veach_tiny.pt_depth3.json").write_text(json.dumps(
        {"config": "veach_tiny", "traffic": "pt_depth3", "chips": 1,
         "end_to_end": ["spp_per_s", "setup_s"],
         "limits": {"weight_off": 0, "tile_rel_l1_capped": 10.0}}))
    (dst / "metrics" / "passes_traced.py").write_text(
        "def read(run):\n    return (float(run.passes), 'passes')\n")
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); sys.path.append(sys.argv[2]);"
            "from benchmark import run;"
            "r = run.run_cell('veach_tiny.pt_depth3', 5, 0.1, True, device='cpu');"
            "print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), ROOT],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["metrics"]["passes_traced"] == {"value": 1.0, "unit": "passes"}
    assert res["correct"] is True


def test_fails_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark, a run
    prints no result and exits non-zero."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(cells.ROOT, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "veach_mis.pt",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
