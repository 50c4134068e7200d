"""BENCHMARK.json agrees with the files the harness finds by name."""
import json
import os
import re

from benchmark import cells

ROOT = os.path.dirname(cells.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_and_files():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    for c in b["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        cell = cells.load_cell(w["name"])
        assert (cell.workload["config"], cell.workload["traffic"], cell.chips) == (
            w["config"], w["traffic"], w["chips"])
        want = {n for n, m in e2e.items() if w["name"] in m.get("workloads", [w["name"]])}
        assert set(cell.workload["end_to_end"]) == want
    assert set(cells.cell_names()) == {w["name"] for w in b["workloads"]}
    assert sorted(m["name"] for m in b["per_layer"]) == cells.metric_names()
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert m.get("workloads", [None]) and m["layer"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
