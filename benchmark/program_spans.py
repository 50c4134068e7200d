"""The benchmark's reading of the port's own spans: the recorder
``cudatracerlib_tpu_torch.utils.timers.RECORDER``, which the port fills
while a profiler records (the traced passes of a ``--trace 1`` run). Apart
from ``port.py`` this is the benchmark's only contact with the port.

Every reader returns None unless the recorder's stretch holds exactly the
run's traced passes (``run.passes`` spans ``ctl.pass``), and so on a
program that keeps no such recorder."""
from __future__ import annotations

STAGES = ("ctl.surface", "ctl.nee", "ctl.bsdf")
CHILDREN = ("ctl.traverse", "ctl.sampler")


def _recorder():
    try:
        from cudatracerlib_tpu_torch.utils import timers
    except ImportError:
        return None
    return getattr(timers, "RECORDER", None)


def stretch(run):
    """The recorder's spans of the run's traced passes, or None."""
    spans = getattr(_recorder(), "spans", None)
    if not spans or sum(s.name == "ctl.pass" for s in spans) != run.passes:
        return None
    return spans


def _outermost(spans, name):
    return [s for s in spans if s.name == name
            and (s.parent is None or s.parent.name != name)]


def ms_per_pass(run, name):
    """Device milliseconds a traced pass of the spans `name` (not counting
    one nested in another of its name), or None where there are none."""
    spans = stretch(run)
    hits = _outermost(spans or [], name)
    if not hits:
        return None
    return 1e3 * sum(s.device_s() for s in hits) / run.passes


def shade_ms_per_pass(run):
    """Device milliseconds a traced pass of the bounce's own stages: each
    ``STAGES`` span's duration less what its ``CHILDREN`` spans cover."""
    spans = stretch(run)
    if spans is None:
        return None
    own = {id(s): s.device_s() for s in spans if s.name in STAGES}
    if not own:
        return None
    for s in spans:
        if s.name in CHILDREN and s.parent is not None and id(s.parent) in own:
            own[id(s.parent)] -= s.device_s()
    return 1e3 * sum(own.values()) / run.passes


def first_pass_s(run):
    """Host seconds of the newest tracer's first pass (the warm-up pass)."""
    if stretch(run) is None:
        return None
    return getattr(_recorder(), "first_pass_s", None)
