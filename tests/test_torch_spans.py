"""The port's span recorder (``utils/timers.RECORDER``) and the spans the
path and game tracers open, on the CPU: off unless a profiler records; the
names, parents and pass ids of a traced pass; the stretch of traced passes
that readers see; the first pass's seconds; GameTracer's step counter."""
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cudatracerlib_tpu_torch.models import game as tgame
from cudatracerlib_tpu_torch.models import path as tpath
from cudatracerlib_tpu_torch.ops import traversal8
from cudatracerlib_tpu_torch.utils import example_scenes as tscenes
from cudatracerlib_tpu_torch.utils import timers

DEPTH = 3


@pytest.fixture
def rec(monkeypatch):
    r = timers.PerformanceTimer()
    monkeypatch.setattr(timers, "RECORDER", r)
    return r


@pytest.fixture(scope="module")
def cornell():
    return tscenes.cornell_box(16, 16).build("cpu")


def _traced(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args)
    return Counter(e.name for e in prof.events() if e.name.startswith("ctl."))


def _shape(rec):
    return Counter((s.name, s.parent.name if s.parent else None) for s in rec.spans)


def _sobol(scene):
    return tpath.PathTracer(scene, 16, 16, max_depth=DEPTH, sampler_type=2)


def test_off_without_profiler(rec, cornell):
    tr = _sobol(cornell)
    tr.do_pass()
    tgame.GameTracer(cornell, 16, 16).do_pass()
    assert rec.spans == [] and not rec.totals and not rec.counts
    assert timers.span("ctl.traverse") is timers.span("ctl.nee")


def test_path_pass_spans(rec, cornell):
    """A Sobol' PT pass at depth 3: the camera's sampler draw, a merged
    traversal and the three stages a bounce, their NEE and BSDF draws, and
    the last shadow flush, all of one pass id."""
    tr = _sobol(cornell)
    tr.do_pass()
    events = _traced(tr.do_pass)
    assert _shape(rec) == {
        ("ctl.pass", None): 1, ("ctl.sampler", "ctl.pass"): 1,
        ("ctl.traverse", "ctl.pass"): DEPTH + 1,
        ("ctl.surface", "ctl.pass"): DEPTH, ("ctl.nee", "ctl.pass"): DEPTH,
        ("ctl.bsdf", "ctl.pass"): DEPTH,
        ("ctl.sampler", "ctl.nee"): DEPTH, ("ctl.sampler", "ctl.bsdf"): DEPTH}
    assert {s.pass_id for s in rec.spans} == {1}
    assert events == Counter(s.name for s in rec.spans)
    assert all(s.t1_ns >= s.t0_ns and s.device_s() >= 0 for s in rec.spans)
    assert set(rec.device_totals()) == {s.name for s in rec.spans}


def test_game_frame_spans(rec, cornell):
    """A game frame: camera traversal, surface, NEE with its shadow
    traversal, the filter."""
    tr = tgame.GameTracer(cornell, 16, 16)
    tr.pass_idx = 7
    events = _traced(tr.do_pass)
    assert _shape(rec) == {
        ("ctl.pass", None): 1, ("ctl.traverse", "ctl.pass"): 1,
        ("ctl.surface", "ctl.pass"): 1, ("ctl.nee", "ctl.pass"): 1,
        ("ctl.traverse", "ctl.nee"): 1, ("ctl.filter", "ctl.pass"): 1}
    assert {s.pass_id for s in rec.spans} == {7}
    assert events == Counter(s.name for s in rec.spans)


def test_stretch_of_traced_passes(rec, cornell):
    """Readers see the latest run of traced passes: an untraced pass
    between two traced ones starts a new stretch."""
    tr = tgame.GameTracer(cornell, 16, 16)

    def passes():
        return [s.pass_id for s in rec.spans if s.name == "ctl.pass"]
    _traced(tr.do_pass)
    _traced(tr.do_pass)
    assert passes() == [0, 1]
    tr.do_pass()
    assert passes() == [0, 1]
    _traced(tr.do_pass)
    assert passes() == [3]
    assert rec.counts["ctl.pass"] == 3
    assert rec.device_totals()["ctl.pass"] == pytest.approx(rec.totals["ctl.pass"])


def test_first_pass_seconds(rec, cornell):
    a = tgame.GameTracer(cornell, 16, 16)
    assert rec.first_pass_s is None
    a.do_pass()
    first = a.last_pass_seconds
    assert rec.first_pass_s == first > 0
    a.do_pass()
    assert rec.first_pass_s == first
    b = _sobol(cornell)
    _traced(b.do_pass)
    assert rec.first_pass_s == b.last_pass_seconds != first


def test_game_step_counter(monkeypatch, cornell):
    """GameTracer's _iters_dev is the sum of its camera and shadow
    traversals' steps, and counting them leaves the frames unchanged."""
    orig = traversal8.intersect_scene
    steps = []

    def counting(*a, **k):
        res = orig(*a, **k)
        steps.append(int(res[1]))
        return res

    def uncounted(*a, **k):
        k["with_iters"] = False
        hit = orig(*a, **k)
        return hit, torch.zeros((), dtype=torch.int64), None, None
    films = []
    for fn in (counting, uncounted):
        monkeypatch.setattr(traversal8, "intersect_scene", fn)
        tr = tgame.GameTracer(cornell, 16, 16)
        for _ in range(2):
            tr.do_pass()
        films.append((tr.film.rgb, int(tr._iters_dev)))
    assert len(steps) == 4 and min(steps) > 0
    assert films[0][1] == sum(steps) and films[1][1] == 0
    assert torch.equal(films[0][0], films[1][0])
