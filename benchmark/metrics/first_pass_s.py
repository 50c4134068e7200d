"""Host seconds of the tracer's first pass, the warm-up pass of set-up, as
the port's ``TracerBase.do_pass`` records it in its span recorder."""
from ..program_spans import first_pass_s


def read(run):
    v = first_pass_s(run)
    return None if v is None else (v, "s")
