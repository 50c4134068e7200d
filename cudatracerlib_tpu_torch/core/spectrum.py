"""RGB spectrum helpers and hero-wavelength spectral transport.

Port of ``cudatracerlib_tpu/core/spectrum.py``: a spectrum is a plain
``(..., 3)`` float32 tensor in linear RGB. Besides the sRGB transfer
functions, the XYZ conversions and the blackbody colour, the spectral integrator's pieces: hero
wavelengths, the fitted spectral-primary upsampling basis (and Smits'
1999 basis), the Wyman-Sloan-Shirley CIE 1931 colour matching functions
and the Monte Carlo resolve of spectral radiance to linear RGB; RGBE and
the 8-bit RGBA packings, whose 32-bit patterns (the JAX package's uint32)
travel in int64 tensors, as torch's uint32 has few operators.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

# ITU-R Rec. BT.709 primaries
_RGB2XYZ = ((0.412453, 0.357580, 0.180423),
            (0.212671, 0.715160, 0.072169),
            (0.019334, 0.119193, 0.950227))
_XYZ2RGB = ((3.240479, -1.537150, -0.498535),
            (-0.969256, 1.875991, 0.041556),
            (0.055648, -0.204043, 1.057311))


def _mat(rows, like: Tensor) -> Tensor:
    return torch.tensor(rows, dtype=torch.float32, device=like.device)


def luminance(rgb: Tensor) -> Tensor:
    return (rgb * _mat(_RGB2XYZ[1], rgb)).sum(-1)


def rgb_to_xyz(rgb: Tensor) -> Tensor:
    return torch.einsum("ij,...j->...i", _mat(_RGB2XYZ, rgb), rgb)


def xyz_to_rgb(xyz: Tensor) -> Tensor:
    return torch.einsum("ij,...j->...i", _mat(_XYZ2RGB, xyz), xyz)


def xyz_to_yxy(xyz: Tensor) -> Tensor:
    s = xyz.sum(-1)
    safe = s.clamp_min(1e-12)
    return torch.stack([xyz[..., 1], xyz[..., 0] / safe, xyz[..., 1] / safe], dim=-1)


def yxy_to_xyz(yxy: Tensor) -> Tensor:
    Y, x, y = yxy[..., 0], yxy[..., 1], yxy[..., 2]
    ys = y.clamp_min(1e-12)
    X = x * Y / ys
    Z = (1.0 - x - y) * Y / ys
    return torch.stack([X, Y, Z], dim=-1)


def srgb_to_linear(c: Tensor) -> Tensor:
    return torch.where(c <= 0.04045, c / 12.92,
                       torch.pow(((c + 0.055) / 1.055).clamp_min(0.0), 2.4))


def linear_to_srgb(c: Tensor) -> Tensor:
    c = c.clamp_min(0.0)
    return torch.where(c <= 0.0031308, 12.92 * c,
                       1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


# --------------------------------------------------------------------------
# RGBE shared-exponent packing (Ward). 32 bits: r,g,b mantissas + exponent.
# --------------------------------------------------------------------------

def to_rgbe(rgb: Tensor) -> Tensor:
    """Pack (...,3) float rgb to (...,) RGBE words (int64 holding uint32)."""
    rgb = rgb.clamp_min(0.0)
    m = rgb.amax(dim=-1)
    # frexp: m = f * 2^e with f in [0.5, 1)
    f, e = torch.frexp(m.clamp_min(1e-32))
    scale = f * 256.0 / m.clamp_min(1e-32)
    quant = (rgb * scale[..., None]).to(torch.int64).clamp(0, 255)
    ebits = (e.to(torch.int64) + 128).clamp(0, 255)
    packed = quant[..., 0] | (quant[..., 1] << 8) | (quant[..., 2] << 16) | (ebits << 24)
    return torch.where(m < 1e-32, 0, packed)


def from_rgbe(p: Tensor) -> Tensor:
    r = (p & 0xFF).to(torch.float32)
    g = ((p >> 8) & 0xFF).to(torch.float32)
    b = ((p >> 16) & 0xFF).to(torch.float32)
    e = ((p >> 24) & 0xFF).to(torch.int32)
    one = torch.ones(e.shape, dtype=torch.float32, device=p.device)
    scale = torch.where(p == 0, 0.0, torch.ldexp(one, e - (128 + 8)))
    return torch.stack([r, g, b], dim=-1) * scale[..., None]


# --------------------------------------------------------------------------
# 8-bit RGBA packing ("RGBCOL" display format in the reference)
# --------------------------------------------------------------------------

def to_rgbcol(rgb: Tensor) -> Tensor:
    q = torch.round(rgb * 255.0).clamp(0, 255).to(torch.int64)
    return q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | 0xFF000000


def from_rgbcol(p: Tensor) -> Tensor:
    r = (p & 0xFF).to(torch.float32)
    g = ((p >> 8) & 0xFF).to(torch.float32)
    b = ((p >> 16) & 0xFF).to(torch.float32)
    return torch.stack([r, g, b], dim=-1) / 255.0


def blackbody(temperature_k: float, scale: float = 1.0, device="cpu") -> Tensor:
    """Normalized RGB of a blackbody emitter: Planck's law sampled at one
    wavelength per RGB primary, in float32 as the JAX package computes it
    (the constants rounded to float32 before they meet a tensor, lam^5 as
    XLA's integer power multiplies it). A host-side material colour (the
    scene loader's `blackbody` spectrum), so it is made on the CPU unless
    the caller asks for another device."""
    lam = torch.tensor([610.0, 550.0, 465.0], dtype=torch.float32, device=device) * 1e-9
    h, c, kb = 6.62607e-34, 2.998e8, 1.38065e-23
    lam2 = lam * lam
    lam5 = lam * (lam2 * lam2)
    x = torch.full_like(lam, h * c) / (lam * kb * temperature_k)
    p = torch.full_like(lam, 2 * h * c * c) / lam5 / (torch.exp(x) - 1.0)
    p = p / p.max()
    return (p * scale).to(torch.float32)


# ---------------------------------------------------------------------------
# Hero-wavelength spectral transport: each path carries C stratified
# wavelengths, RGB scene colours are upsampled to spectra on the fly, and
# the path's spectral radiance resolves to XYZ -> linear RGB at the end.
# The basis is the JAX package's fitted spectral-primary decomposition
# (tools/fit_spectral_basis.py): a partition of unity whose resolve through
# this module reproduces the sRGB primaries.
# ---------------------------------------------------------------------------

SPECTRUM_MIN_WAVELENGTH = 380.0   # nm
SPECTRUM_MAX_WAVELENGTH = 720.0

# Smits (1999) "An RGB to Spectrum Conversion for Reflectances": 10 bins
# over 380-720nm for the white/cyan/magenta/yellow/red/green/blue bases.
_SMITS_BINS = 10
_SMITS = (
    (1.0000, 1.0000, 0.9999, 0.9993, 0.9992, 0.9998, 1.0000, 1.0000, 1.0000, 1.0000),
    (0.9710, 0.9426, 1.0007, 1.0007, 1.0007, 1.0007, 0.1564, 0.0000, 0.0000, 0.0000),
    (1.0000, 1.0000, 0.9685, 0.2229, 0.0000, 0.0458, 0.8369, 1.0000, 1.0000, 0.9959),
    (0.0001, 0.0000, 0.1088, 0.6651, 1.0000, 1.0000, 0.9996, 0.9586, 0.9685, 0.9840),
    (0.1012, 0.0515, 0.0000, 0.0000, 0.0000, 0.0000, 0.8325, 1.0149, 1.0149, 1.0149),
    (0.0000, 0.0000, 0.0273, 0.7937, 1.0000, 0.9418, 0.1719, 0.0000, 0.0000, 0.0025),
    (1.0000, 1.0000, 0.8916, 0.3323, 0.0000, 0.0000, 0.0003, 0.0369, 0.0483, 0.0496),
)   # white, cyan, magenta, yellow, red, green, blue


def sample_hero_wavelengths(u: Tensor, n: int = 4):
    """(B,) uniform -> ((B, n) wavelengths nm, scalar pdf per wavelength).

    Hero lambda uniform over the visible range; companions rotated by
    range/n (stratified, wrap-around)."""
    span = SPECTRUM_MAX_WAVELENGTH - SPECTRUM_MIN_WAVELENGTH
    hero = SPECTRUM_MIN_WAVELENGTH + u * span
    offs = torch.arange(n, dtype=torch.float32, device=u.device) * (span / n)
    lam = SPECTRUM_MIN_WAVELENGTH + torch.remainder(
        hero[..., None] + offs - SPECTRUM_MIN_WAVELENGTH, span)
    return lam, 1.0 / span


_N_BASIS_BINS = 64
_BASIS_TABLE = (  # (N, 3), the JAX package's fitted basis
    (0.325399, 0.334142, 0.340459),
    (0.320791, 0.333202, 0.346007),
    (0.316006, 0.330028, 0.353966),
    (0.311918, 0.320994, 0.367088),
    (0.307469, 0.300497, 0.392033),
    (0.294089, 0.261169, 0.444741),
    (0.251970, 0.195148, 0.552882),
    (0.159907, 0.100661, 0.739432),
    (0.041646, 0.012092, 0.946261),
    (-0.000000, -0.000000, 1.000000),
    (-0.000000, -0.000000, 1.000000),
    (-0.000000, -0.000000, 1.000000),
    (-0.000000, -0.000000, 1.000000),
    (-0.000000, -0.000000, 1.000000),
    (-0.000000, -0.000000, 1.000000),
    (-0.000000, -0.000000, 1.000000),
    (-0.000000, 0.001684, 0.998316),
    (-0.000000, 0.090630, 0.909371),
    (-0.000000, 0.236062, 0.763938),
    (-0.000000, 0.378146, 0.621854),
    (-0.000000, 0.503404, 0.496596),
    (-0.000000, 0.616945, 0.383055),
    (-0.000000, 0.726920, 0.273081),
    (-0.000000, 0.841335, 0.158666),
    (-0.000000, 0.950274, 0.049726),
    (-0.000000, 0.999984, 0.000016),
    (-0.000000, 0.999986, 0.000014),
    (-0.000000, 0.999987, 0.000013),
    (-0.000000, 0.999989, 0.000012),
    (-0.000000, 0.999990, 0.000010),
    (-0.000000, 0.999991, 0.000009),
    (-0.000000, 0.999993, 0.000008),
    (-0.000000, 0.999994, 0.000006),
    (-0.000000, 0.999995, 0.000005),
    (-0.000000, 0.999997, 0.000003),
    (-0.000000, 0.999998, 0.000002),
    (-0.000000, 0.981331, 0.018669),
    (-0.000000, 0.903268, 0.096732),
    (0.012702, 0.806386, 0.180913),
    (0.330794, 0.560610, 0.108596),
    (0.681194, 0.294654, 0.024151),
    (0.931324, 0.068676, -0.000000),
    (1.000000, -0.000000, -0.000000),
    (1.000000, -0.000000, -0.000000),
    (1.000000, -0.000000, -0.000000),
    (1.000000, -0.000000, -0.000000),
    (1.000000, -0.000000, -0.000000),
    (1.000000, -0.000000, -0.000000),
    (0.997651, -0.000000, 0.002349),
    (0.909539, 0.005237, 0.085225),
    (0.781144, 0.071520, 0.147335),
    (0.664230, 0.141857, 0.193913),
    (0.568216, 0.199132, 0.232652),
    (0.492678, 0.243831, 0.263492),
    (0.436085, 0.277144, 0.286771),
    (0.395835, 0.300594, 0.303571),
    (0.368707, 0.316123, 0.315170),
    (0.351456, 0.325726, 0.322818),
    (0.341198, 0.331178, 0.327623),
    (0.335594, 0.333922, 0.330485),
    (0.332886, 0.335028, 0.332086),
    (0.331847, 0.335239, 0.332913),
    (0.331679, 0.335029, 0.333292),
    (0.331863, 0.334676, 0.333461),
)


def _bin(lam: Tensor, bins: int) -> Tensor:
    span = SPECTRUM_MAX_WAVELENGTH - SPECTRUM_MIN_WAVELENGTH
    return ((lam - SPECTRUM_MIN_WAVELENGTH) / span * bins).to(torch.int32) \
        .clamp(0, bins - 1).long()


def rgb_to_spectral(rgb: Tensor, lam: Tensor) -> Tensor:
    """Fitted spectral-primary upsampling: (B, 3) linear-RGB reflectance ->
    (B, C) spectral reflectance at wavelengths lam (B, C) nm."""
    basis = _mat(_BASIS_TABLE, lam)[_bin(lam, _N_BASIS_BINS)]   # (B, C, 3)
    return torch.einsum("...ci,...i->...c", basis, rgb).clamp_min(0.0)


def rgb_to_spectral_smits(rgb: Tensor, lam: Tensor) -> Tensor:
    """Smits (1999) upsampling: (B, 3) linear-RGB reflectance -> (B, C)
    spectral reflectance at lam (B, C) nm."""
    basis = _mat(_SMITS, lam).T[_bin(lam, _SMITS_BINS)]          # (B, C, 7)
    w_b, c_b, m_b, y_b, r_b, g_b, b_b = [basis[..., i] for i in range(7)]
    r, g, b = rgb[..., 0:1], rgb[..., 1:2], rgb[..., 2:3]

    def branch(lo, mid, hi, sec, prim):
        return lo * w_b + (mid - lo) * sec + (hi - mid) * prim
    out_r_min = torch.where(g <= b, branch(r, g, b, c_b, b_b),
                            branch(r, b, g, c_b, g_b))
    out_g_min = torch.where(r <= b, branch(g, r, b, m_b, b_b),
                            branch(g, b, r, m_b, r_b))
    out_b_min = torch.where(r <= g, branch(b, r, g, y_b, g_b),
                            branch(b, g, r, y_b, r_b))
    r_min = (r <= g) & (r <= b)
    g_min = (g <= r) & (g <= b) & ~r_min
    out = torch.where(r_min, out_r_min, torch.where(g_min, out_g_min, out_b_min))
    return out.clamp_min(0.0)


def _cmf_gauss(x, mu, s1, s2):
    s = torch.where(x < mu, s1, s2)
    return torch.exp(-0.5 * ((x - mu) / s) ** 2)


def cie_xyz_cmf(lam: Tensor) -> Tensor:
    """CIE 1931 colour matching functions at lam (nm) -> (..., 3), the
    Wyman, Sloan & Shirley 2013 multi-lobe Gaussian fit."""
    x = (1.056 * _cmf_gauss(lam, 599.8, 37.9, 31.0)
         + 0.362 * _cmf_gauss(lam, 442.0, 16.0, 26.7)
         - 0.065 * _cmf_gauss(lam, 501.1, 20.4, 26.2))
    y = (0.821 * _cmf_gauss(lam, 568.8, 46.9, 40.5)
         + 0.286 * _cmf_gauss(lam, 530.9, 16.3, 31.1))
    z = (1.217 * _cmf_gauss(lam, 437.0, 11.8, 36.0)
         + 0.681 * _cmf_gauss(lam, 459.0, 26.0, 13.8))
    return torch.stack([x, y, z], dim=-1)


# per-channel white calibration: the flat unit spectrum resolves to RGB
# white through the CMF fit on [380, 720]
_CMF_WHITE_CALIB = (0.00890268, 0.00935350, 0.01019191)


def spectral_to_rgb(L: Tensor, lam: Tensor, inv_pdf) -> Tensor:
    """Monte Carlo resolve of per-path spectral radiance L (B, C) at lam
    (B, C) nm, sampled with density 1/inv_pdf, to linear RGB."""
    cmf = cie_xyz_cmf(lam)                                # (B, C, 3)
    xyz = (L[..., None] * cmf).mean(dim=-2) * inv_pdf * _mat(_CMF_WHITE_CALIB, L)
    return xyz_to_rgb(xyz)
