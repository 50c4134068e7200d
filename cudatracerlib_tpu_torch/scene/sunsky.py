"""Preetham analytic sun/sky model (host-side env-map generation).

Verbatim port of ``cudatracerlib_tpu/scene/sunsky.py``, the Mitsuba
`sky`/`sun`/`sunsky` emitters' environment map. Generates an equirectangular
radiance map from the Preetham et al. 1999 daylight model: Perez luminance /
chromaticity distributions with turbidity-derived coefficients, plus an
optional sun disc.
"""
from __future__ import annotations

import numpy as np

# Perez coefficient tables (A..E) for Y, x, y as linear functions of turbidity
_PEREZ_Y = np.array([[0.1787, -1.4630], [-0.3554, 0.4275], [-0.0227, 5.3251],
                     [0.1206, -2.5771], [-0.0670, 0.3703]])
_PEREZ_X = np.array([[-0.0193, -0.2592], [-0.0665, 0.0008], [-0.0004, 0.2125],
                     [-0.0641, -0.8989], [-0.0033, 0.0452]])
_PEREZ_Y2 = np.array([[-0.0167, -0.2608], [-0.0950, 0.0092], [-0.0079, 0.2102],
                      [-0.0441, -1.6537], [-0.0109, 0.0529]])


def _perez(theta, gamma, c):
    cos_t = np.maximum(np.cos(theta), 1e-3)
    return ((1.0 + c[0] * np.exp(c[1] / cos_t))
            * (1.0 + c[2] * np.exp(c[3] * gamma) + c[4] * np.cos(gamma) ** 2))


def _zenith(turbidity, theta_s):
    T = turbidity
    chi = (4.0 / 9.0 - T / 120.0) * (np.pi - 2.0 * theta_s)
    Yz = (4.0453 * T - 4.9710) * np.tan(chi) - 0.2155 * T + 2.4192  # kcd/m^2
    Yz = max(Yz, 0.001) * 1000.0
    t2, ts = T * T, theta_s
    v = np.array([ts ** 3, ts ** 2, ts, 1.0])
    xz = (np.array([0.00166, -0.02903, 0.11693]) * np.array([t2, T, 1]) ).sum() * 0
    # full matrix form (Preetham appendix)
    Mx = np.array([[0.00166, -0.00375, 0.00209, 0.0],
                   [-0.02903, 0.06377, -0.03202, 0.00394],
                   [0.11693, -0.21196, 0.06052, 0.25886]])
    My = np.array([[0.00275, -0.00610, 0.00317, 0.0],
                   [-0.04214, 0.08970, -0.04153, 0.00516],
                   [0.15346, -0.26756, 0.06670, 0.26688]])
    tv = np.array([t2, T, 1.0])
    xz = float(tv @ Mx @ v)
    yz = float(tv @ My @ v)
    return Yz, xz, yz


def preetham_sky(sun_dir, turbidity: float = 3.0, resolution: int = 128,
                 sun_scale: float = 1.0, with_sun: bool = True,
                 sky_scale: float = 1.0) -> np.ndarray:
    """(H, 2H, 3) linear-RGB equirectangular radiance map.

    Mapping matches lights._env_direction_from_uv: +y up,
    dir = (sin t sin p, cos t, -sin t cos p) for u=(p+pi)/2pi, v=t/pi.
    """
    sun = np.asarray(sun_dir, np.float64)
    sun = sun / np.linalg.norm(sun)
    theta_s = np.arccos(np.clip(sun[1], -1.0, 1.0))
    theta_s = min(theta_s, np.pi / 2 - 1e-3)
    T = turbidity

    coefY = _PEREZ_Y @ np.array([T, 1.0])
    coefx = _PEREZ_X @ np.array([T, 1.0])
    coefy = _PEREZ_Y2 @ np.array([T, 1.0])
    Yz, xz, yz = _zenith(T, theta_s)

    H = resolution
    W = 2 * H
    v = (np.arange(H) + 0.5) / H
    u = (np.arange(W) + 0.5) / W
    theta = v * np.pi                       # zenith angle of the direction
    phi = u * 2.0 * np.pi - np.pi
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    d = np.stack([np.sin(tt) * np.sin(pp), np.cos(tt), -np.sin(tt) * np.cos(pp)], -1)
    cos_gamma = np.clip(d @ sun, -1.0, 1.0)
    gamma = np.arccos(cos_gamma)
    theta_clip = np.minimum(tt, np.pi / 2 - 1e-3)  # mirror below-horizon dimly

    fY = _perez(theta_clip, gamma, coefY) / _perez(0.0, theta_s, coefY)
    fx = _perez(theta_clip, gamma, coefx) / _perez(0.0, theta_s, coefx)
    fy = _perez(theta_clip, gamma, coefy) / _perez(0.0, theta_s, coefy)
    Y = Yz * fY
    x = xz * fx
    y = yz * fy

    # Yxy -> XYZ -> RGB (normalize so zenith luminance ~ sky_scale units)
    Y = Y / max(Yz, 1e-9) * sky_scale
    ys = np.maximum(y, 1e-5)
    X = x * Y / ys
    Z = (1.0 - x - y) * Y / ys
    M = np.array([[3.240479, -1.537150, -0.498535],
                  [-0.969256, 1.875991, 0.041556],
                  [0.055648, -0.204043, 1.057311]])
    rgb = np.stack([X, Y, Z], -1) @ M.T
    rgb = np.maximum(rgb, 0.0)
    below = tt > np.pi / 2
    rgb[below] *= 0.2  # simple ground attenuation

    if with_sun:
        # power-conserving splat: deposit the sun's irradiance into the pixel
        # containing the sun center (resolution-independent total energy;
        # at practical resolutions the disc is smaller than one pixel)
        phi_s = np.arctan2(sun[0], -sun[2])
        ui = int(np.clip((phi_s + np.pi) / (2 * np.pi) * W, 0, W - 1))
        vi = int(np.clip(theta_s / np.pi * H, 0, H - 1))
        d_omega = (np.pi / H) * (2 * np.pi / W) * max(np.sin(theta_s), 1e-3)
        E_sun = 15.0 * sun_scale * sky_scale  # irradiance in sky-relative units
        rgb[vi, ui] += np.array([1.0, 0.93, 0.82]) * (E_sun / d_omega)
    return rgb.astype(np.float32)
