"""Participating media: homogeneous and voxel-grid volumes.

Port of ``cudatracerlib_tpu/models/medium.py``. sigma queries sum over
all volume rows (a few at most) with containment masks; heterogeneous
media use null-collision (delta / ratio) tracking against a scene
majorant.

MediumTable.params layout:
  [0:3] sigma_a  [3:6] sigma_s  [6] phase_type  [7] phase_g  [8] density scale
  [9:12] Le (emission)
grid_offset[v] = (off_density, off_le, unused); -1 -> constant.

The tracking loops run while any active lane is undone, at most
MAX_TRACKING_STEPS times, and every lane draws its uniforms in every
iteration, done or not, so the RNG streams equal the JAX package's. Each
exit test reads one bool back from the device; ``host_reads`` counts
them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import rng as rngmod
from ..core import vecmath as vm
from ..scene import schema

Tensor = torch.Tensor

MED_HOMOGENEOUS = 0
MED_GRID = 1
MAX_TRACKING_STEPS = 256

# exit tests of the tracking loops read back from the device so far
host_reads = 0


def has_media(media: schema.MediumTable) -> bool:
    return media.med_type.shape[0] > 0


def _kinds(media: schema.MediumTable):
    """Per volume: is it a grid (its density lookup is needed)? Read back
    once per media table and kept on its med_type tensor, so the volume
    loops skip the lookup of homogeneous volumes (the JAX package computes
    it and discards it)."""
    t = media.med_type
    flags = getattr(t, "_grid_flags", None)
    if flags is None:
        flags = t._grid_flags = tuple(k == MED_GRID for k in t.tolist())
    return flags


def media_aabb(media: schema.MediumTable):
    """World-space AABB union of all media volumes (unit cube x to_world)."""
    # the unit cube's corners: x, y, z in {0, 1}, w = 1
    m = media.to_world[:, None, :3, :]                                  # (V, 1, 3, 4)
    pts = torch.stack([m[..., 0] * x + m[..., 1] * y + m[..., 2] * z + m[..., 3]
                       for x in (0, 1) for y in (0, 1) for z in (0, 1)], 1)
    pts = pts[:, :, 0, :]                                               # (V, 8, 3)
    pts = pts.reshape(-1, 3)
    return pts.amin(0), pts.amax(0)


def _density_at(media: schema.MediumTable, v: int, p_local: Tensor) -> Tensor:
    """Trilinear density lookup for grid volume row v at local [0,1]^3 coords."""
    dim = media.grid_dim[v]
    off = media.grid_offset[v, 0]
    nx, ny, nz = dim[0], dim[1], dim[2]
    nxf, nyf, nzf = ((n.to(torch.float32) - 1) for n in (nx, ny, nz))
    zero = torch.zeros((), dtype=torch.float32, device=p_local.device)
    x = torch.minimum(torch.maximum(p_local[..., 0] * nxf, zero), nxf)
    y = torch.minimum(torch.maximum(p_local[..., 1] * nyf, zero), nyf)
    z = torch.minimum(torch.maximum(p_local[..., 2] * nzf, zero), nzf)
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    z0 = torch.floor(z).to(torch.int32)
    fx, fy, fz = x - x0, y - y0, z - z0

    def fetch(xi, yi, zi):
        xi = torch.minimum(xi, nx - 1)
        yi = torch.minimum(yi, ny - 1)
        zi = torch.minimum(zi, nz - 1)
        return media.voxels[(off + (zi * ny + yi) * nx + xi).long()]

    c000 = fetch(x0, y0, z0); c100 = fetch(x0 + 1, y0, z0)
    c010 = fetch(x0, y0 + 1, z0); c110 = fetch(x0 + 1, y0 + 1, z0)
    c001 = fetch(x0, y0, z0 + 1); c101 = fetch(x0 + 1, y0, z0 + 1)
    c011 = fetch(x0, y0 + 1, z0 + 1); c111 = fetch(x0 + 1, y0 + 1, z0 + 1)
    c00 = c000 * (1 - fx) + c100 * fx
    c10 = c010 * (1 - fx) + c110 * fx
    c01 = c001 * (1 - fx) + c101 * fx
    c11 = c011 * (1 - fx) + c111 * fx
    return (c00 * (1 - fy) + c10 * fy) * (1 - fz) + (c01 * (1 - fy) + c11 * fy) * fz


def sigma_at(media: schema.MediumTable, p: Tensor):
    """Total (sigma_a, sigma_s, phase_type, phase_g) at world points p (B,3).

    Sums contributions of all volumes containing p; the phase function of the
    highest-index containing volume wins (media are rarely overlapped).
    """
    B, dev = p.shape[0], p.device
    sig_a = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    sig_s = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    ptype = torch.zeros(B, dtype=torch.int32, device=dev)
    g = torch.zeros(B, dtype=torch.float32, device=dev)
    for v, grid in enumerate(_kinds(media)):
        pl = vm.transform_point(media.world_to[v], p)  # local unit-cube coords
        inside = ((pl >= 0.0) & (pl <= 1.0)).all(dim=-1)
        dens = (_density_at(media, v, pl) if grid else 1.0) * media.params[v, 8]
        sa = media.params[v, 0:3] * dens[..., None]
        ss = media.params[v, 3:6] * dens[..., None]
        sig_a = sig_a + torch.where(inside[..., None], sa, 0.0)
        sig_s = sig_s + torch.where(inside[..., None], ss, 0.0)
        ptype = torch.where(inside, media.params[v, 6].to(torch.int32), ptype)
        g = torch.where(inside, media.params[v, 7], g)
    return sig_a, sig_s, ptype, g


def tau_segment(media: schema.MediumTable, o: Tensor, d: Tensor,
                t0: Tensor, t1: Tensor, grid_samples: int = 2) -> Tensor:
    """Optical depth of ray segments [t0, t1]: exact for homogeneous media
    (analytic chord clipping against each volume's unit cube), the midpoint
    rule over grid_samples points for density grids."""
    B = o.shape[0]
    tau = torch.zeros((B, 3), dtype=torch.float32, device=o.device)
    for v, grid in enumerate(_kinds(media)):
        w2l = media.world_to[v]
        ol = vm.transform_point(w2l, o)
        dl = vm.transform_vector(w2l, d)
        safe = torch.where(dl.abs() < 1e-12,
                           torch.where(dl >= 0, 1e-12, -1e-12), dl)
        ta = (0.0 - ol) / safe
        tb = (1.0 - ol) / safe
        t_in = torch.maximum(torch.minimum(ta, tb).amax(-1), t0)
        t_out = torch.minimum(torch.maximum(ta, tb).amin(-1), t1)
        ell = (t_out - t_in).clamp_min(0.0)
        sig_t = media.params[v, 0:3] + media.params[v, 3:6]
        dens = torch.ones(B, dtype=torch.float32, device=o.device)
        if grid:
            # average density over grid_samples points of the clipped chord
            dens = torch.zeros(B, dtype=torch.float32, device=o.device)
            for s in range(grid_samples):
                t_s = t_in + ell * ((s + 0.5) / grid_samples)
                pl = ol + dl * t_s[:, None]
                dens = dens + _density_at(media, v, pl.clamp(0.0, 1.0))
            dens = dens / grid_samples
        tau = tau + (sig_t * media.params[v, 8])[None, :] * (dens * ell)[:, None]
    return tau


def majorant(media: schema.MediumTable) -> Tensor:
    """Scalar upper bound on sigma_t anywhere (a 0-dim tensor)."""
    V = media.med_type.shape[0]
    if V == 0:
        return torch.zeros((), dtype=torch.float32, device=media.params.device)
    base = ((media.params[:, 0:3] + media.params[:, 3:6]).amax(-1)
            * media.params[:, 8])
    vox_max = media.voxels.max().clamp_min(0.0)  # conservative grid bound
    st = torch.where(media.med_type == MED_GRID, base * vox_max, base)
    return st.sum()  # overlapping volumes: sum of bounds


class MediumSample(NamedTuple):
    valid: Tensor    # (B,) interaction happened before t_max
    t: Tensor        # (B,)
    p: Tensor        # (B, 3)
    weight: Tensor   # (B, 3) throughput factor (sigma_s * T / pdf for events,
    #                  T / P_surface for pass-through)
    ptype: Tensor    # (B,) phase type at event
    g: Tensor        # (B,)


def _undone(done: Tensor, active: Tensor) -> bool:
    """The tracking loops' exit test: one read back from the device."""
    global host_reads
    host_reads += 1
    return bool((~done & active).any())


def sample_distance(media: schema.MediumTable, o: Tensor, d: Tensor,
                    t_max: Tensor, state: Tensor, active: Tensor) -> tuple:
    """Delta-tracking distance sampling through the aggregate medium.

    Returns (MediumSample, state). For lanes with no interaction the weight is
    the (unbiased) transmittance-over-probability factor, which for perfect
    importance sampling is 1; chromatic sigma uses the spectral ratio at
    accepted events.
    """
    B, dev = o.shape[0], o.device
    maj = majorant(media).clamp_min(1e-6)
    t = torch.zeros(B, dtype=torch.float32, device=dev)
    done = ~active
    escaped = torch.zeros(B, dtype=torch.bool, device=dev)
    w = torch.ones((B, 3), dtype=torch.float32, device=dev)
    p_ev = o
    pt_ev = torch.zeros(B, dtype=torch.int32, device=dev)
    g_ev = torch.zeros(B, dtype=torch.float32, device=dev)
    it = 0
    while it < MAX_TRACKING_STEPS and _undone(done, active):
        state, u1 = rngmod.next_float(state)
        t_new = t - torch.log((1.0 - u1).clamp_min(1e-12)) / maj
        esc_now = t_new >= t_max
        p = o + d * torch.minimum(t_new, t_max)[..., None]
        sig_a, sig_s, ptype, g = sigma_at(media, p)
        sig_t_spec = sig_a + sig_s
        # spectral next-flight tracking: SCATTER with the scalar probability
        # max_c sigma_s / maj; everything else (true null AND absorption)
        # continues as a weighted null, so chromatic absorption stays
        # unbiased per channel
        p_scat = (sig_s.amax(-1) / maj).clamp(0.0, 1.0)
        state, u2 = rngmod.next_float(state)
        scat = u2 < p_scat
        ev_now = ~done & ~esc_now & scat
        null_now = ~done & ~esc_now & ~scat
        w_scat = sig_s / (maj * p_scat).clamp_min(1e-9)[..., None]
        w_null = ((1.0 - sig_t_spec / maj).clamp_min(0.0)
                  / (1.0 - p_scat).clamp_min(1e-6)[..., None])
        w = torch.where(ev_now[..., None], w * w_scat,
                        torch.where(null_now[..., None], w * w_null, w))
        p_ev = torch.where(ev_now[..., None], p, p_ev)
        pt_ev = torch.where(ev_now, ptype, pt_ev)
        g_ev = torch.where(ev_now, g, g_ev)
        t = torch.where(done, t, t_new)
        escaped = escaped | (esc_now & ~done)
        done = done | esc_now | ev_now
        it += 1
    interacted = active & done & ~escaped
    # escaped lanes keep their accumulated null-collision corrections
    ms = MediumSample(valid=interacted, t=t, p=p_ev,
                      weight=torch.where(active[..., None], w, 1.0),
                      ptype=pt_ev, g=g_ev)
    return ms, state


def transmittance(media: schema.MediumTable, o: Tensor, d: Tensor,
                  t_max: Tensor, state: Tensor, active: Tensor) -> tuple:
    """Ratio-tracking transmittance estimate along shadow segments."""
    B, dev = o.shape[0], o.device
    maj = majorant(media).clamp_min(1e-6)
    t = torch.zeros(B, dtype=torch.float32, device=dev)
    done = ~active
    T = torch.ones((B, 3), dtype=torch.float32, device=dev)
    it = 0
    while it < MAX_TRACKING_STEPS and _undone(done, active):
        state, u1 = rngmod.next_float(state)
        t = t - torch.log((1.0 - u1).clamp_min(1e-12)) / maj
        esc = t >= t_max
        p = o + d * torch.minimum(t, t_max)[..., None]
        sig_a, sig_s, _, _ = sigma_at(media, p)
        factor = (1.0 - (sig_a + sig_s) / maj).clamp_min(0.0)
        T = torch.where((~done & ~esc)[..., None], T * factor, T)
        done = done | esc
        it += 1
    return torch.where(active[..., None], T, 1.0), state
