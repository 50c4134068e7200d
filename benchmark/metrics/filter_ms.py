"""Device milliseconds a game frame spends in the path-space filter: the
port's ``ctl.filter`` span (the hash grid, the neighbourhood gather and
the temporal blend), read from its recorder."""
from ..program_spans import ms_per_pass


def read(run):
    v = ms_per_pass(run, "ctl.filter")
    return None if v is None else (v, "ms/pass")
