"""The per-layer metrics that read the port's own spans
(``benchmark/program_spans.py``): a traced CPU rehearsal of each cell
reports each of them in the cells its entry in BENCHMARK.json lists, and in
no other; on a program without the span recorder they read nothing and
raise nothing."""
import json
import os

import pytest

from benchmark import cells, program_spans, run
from benchmark.tests.bench_helpers import SEED, small_overrides

ROOT = os.path.dirname(cells.ROOT)
SPAN_METRICS = ("traverse_ms", "shade_ms", "sampler_ms", "filter_ms", "first_pass_s")


def _entries():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return {m["name"]: m for m in json.load(f)["per_layer"]}


@pytest.mark.parametrize("cell", ["cornell_box.game", "veach_mis.pt", "veach_mis.sobol"])
def test_span_metrics_in_their_cells(cell):
    entries = _entries()
    res = run.run_cell(cell, SEED, 0.2, True, device="cpu",
                       overrides=small_overrides(cell, 16))
    for name in SPAN_METRICS:
        assert entries[name]["source"] == "program_span"
        if cell in entries[name]["workloads"]:
            m = res["metrics"][name]
            assert m["value"] > 0 and m["unit"] == entries[name]["unit"], (name, m)
        else:
            assert name not in res["metrics"], name


def test_span_metrics_silent_without_the_recorder(monkeypatch):
    """A program whose timers module keeps no RECORDER (the parent of the
    recorder) gives every reader None."""
    from cudatracerlib_tpu_torch.utils import timers
    monkeypatch.delattr(timers, "RECORDER")
    r = run.Run(None, 1, {}, {}, [], 0, 0.0)
    for name in SPAN_METRICS:
        assert cells.metric_reader(name)(r) is None
    assert program_spans.stretch(r) is None
