"""Device milliseconds a traced pass spends inside the port's traversals:
its ``ctl.traverse`` spans (``ops/traversal8.intersect_scene``), read from
the port's recorder."""
from ..program_spans import ms_per_pass


def read(run):
    v = ms_per_pass(run, "ctl.traverse")
    return None if v is None else (v, "ms/pass")
