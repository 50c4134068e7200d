"""Device milliseconds a traced pass spends in the integrator's own stages:
the self time of the port's ``ctl.surface``, ``ctl.nee`` and ``ctl.bsdf``
spans (less their traversals and sampler draws), read from its recorder."""
from ..program_spans import shade_ms_per_pass


def read(run):
    v = shade_ms_per_pass(run)
    return None if v is None else (v, "ms/pass")
