"""Multiple importance sampling heuristics (port of ``cudatracerlib_tpu/core/mis.py``)."""
from __future__ import annotations


def balance_heuristic(pdf_a, pdf_b):
    return pdf_a / (pdf_a + pdf_b).clamp_min(1e-20)


def power_heuristic(pdf_a, pdf_b):
    a2 = pdf_a * pdf_a
    b2 = pdf_b * pdf_b
    return a2 / (a2 + b2).clamp_min(1e-20)


def pdf_area_to_solid_angle(pdf_area, dist_sqr, cos_there):
    """Convert a pdf w.r.t. area at the target to solid angle at the source."""
    return pdf_area * dist_sqr / cos_there.abs().clamp_min(1e-12)


def pdf_solid_angle_to_area(pdf_sa, dist_sqr, cos_there):
    return pdf_sa * cos_there.abs() / dist_sqr.clamp_min(1e-20)
