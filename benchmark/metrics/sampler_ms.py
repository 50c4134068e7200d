"""Device milliseconds a traced pass spends drawing sequence samples: the
port's ``ctl.sampler`` spans (the camera's and each bounce's NEE and BSDF
dimensions), read from its recorder."""
from ..program_spans import ms_per_pass


def read(run):
    v = ms_per_pass(run, "ctl.sampler")
    return None if v is None else (v, "ms/pass")
