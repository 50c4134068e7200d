"""Volumetric photon-mapping estimators: Point / BeamGrid / BeamBeam.

Port of ``cudatracerlib_tpu/models/vol_estimators.py`` (the reference's
``Integrators/VolEstimators``: ``BeamGrid.h:8-135``, the photon "beam
radiance estimate" over per-cell photon discs along a DDA walk of the
camera ray, and ``Beam.h:63-117`` + ``BeamBeamGrid.h``, photon beams
against the camera beam with a 1D kernel). The grids are the sort-based
grids of ops/hashgrid.py, the walks the lockstep DDA lanes of ops/dda.py,
and photon-disc insertion is 8-way row duplication with foot-point-cell
dedup at query time. The Point estimator is ``ppm.volumetric_radiance``.
"""
from __future__ import annotations

import torch

from ..core import kernels as kernelsmod
from ..core import rng as rngmod
from ..core import vecmath as vm
from ..ops import dda, hashgrid
from ..scene import schema
from . import medium as mediummod
from . import phase as phasemod

Tensor = torch.Tensor

VOL_POINT = "point"
VOL_BEAMGRID = "beamgrid"
VOL_BEAMBEAM = "beambeam"


def _walk(scene, grid, o, d, t1, radius, max_cells, max_per_cell, accum):
    """dda_walk over `grid` with the camera transmittance accumulated per
    visited cell chord; accum(L, rows, in_range, flat_cell, t_enter,
    t_exit, alive, T_enter, sig_t, sig_s, ptype, g) adds the cell's rows.
    Returns (L, the whole segment's analytic transmittance)."""
    B, dev = o.shape[0], o.device
    zero = torch.zeros(B, dtype=torch.float32, device=dev)

    def visit(carry, flat_cell, t_enter, t_exit, alive):
        L, tau = carry
        mid = o + d * (0.5 * (t_enter + t_exit))[:, None]
        sig_a, sig_s, ptype, g = mediummod.sigma_at(scene.media, mid)
        T_enter = torch.exp(-tau)

        def acc(L, rows, in_range):
            return accum(L, rows, in_range, flat_cell, t_enter, t_exit, alive,
                         T_enter, sig_a + sig_s, sig_s, ptype, g)

        L = dda.gather_cell(grid, flat_cell, acc, L, max_per_cell=max_per_cell)
        tau_cell = mediummod.tau_segment(scene.media, o, d, t_enter, t_exit)
        tau = tau + torch.where(alive[:, None], tau_cell, 0.0)
        return L, tau

    L0 = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    L, _ = dda.dda_walk(grid, o, d, zero, t1, visit, (L0, L0), max_cells=max_cells)
    # eye transmittance over the WHOLE segment analytically: exact even when
    # the walk exhausts max_cells or the grid clips the segment (the walked
    # tau only weights the in-scatter terms)
    Tr = torch.exp(-mediummod.tau_segment(scene.media, o, d, zero, t1))
    return L, Tr


def radiance_beamgrid(scene: schema.SceneData, grid: hashgrid.HashGrid,
                      o: Tensor, d: Tensor, t1: Tensor, radius,
                      max_cells: int = 96, max_per_cell: int = 16):
    """Beam radiance estimate: exact 1D line integral of the 2D kernel over
    each photon disc pierced by the camera ray (reference BeamGrid.h:86-135).
    Transmittance accumulates per visited cell chord (exact for homogeneous
    media, midpoint rule for grids). Photon rows: [pos(3) power(3)
    wi_prop(3) ...]. Returns (L, Tr)."""
    B = o.shape[0]
    r_lane = torch.as_tensor(radius, dtype=torch.float32, device=o.device).expand(B)
    lo_m, hi_m = mediummod.media_aabb(scene.media)
    o_, d_ = o[:, None, :], d[:, None, :]

    def accum(L, rows, in_range, flat_cell, t_enter, t_exit, alive, T_enter,
              sig_t, sig_s, ptype, g):
        ph_pos, ph_pow, ph_wi = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9]
        t_p = vm.dot(ph_pos - o_, d_)                           # (B, K)
        foot = o_ + d_ * t_p[..., None]
        foot_cell = hashgrid.cell_of(grid, foot)
        dist = torch.sqrt(vm.length_sqr(ph_pos - foot).clamp_min(0.0))
        ok = (alive[:, None] & in_range & (dist <= r_lane[:, None])
              & (foot_cell == flat_cell[:, None])   # count each disc once
              & (t_p >= t_enter[:, None]) & (t_p <= t_exit[:, None]))
        kw = kernelsmod.k(kernelsmod.PERLIN, dist, r_lane[:, None], dim=2)
        # boundary-corrected kernel: renormalize by the kernel-mass fraction
        # inside the medium
        b_d = torch.minimum(foot - lo_m, hi_m - foot).amin(-1)
        kw = kw / kernelsmod.boundary_frac(b_d.clamp_min(0.0), r_lane[:, None], 2)
        ph = phasemod.eval_phase(ptype[:, None], g[:, None], ph_wi,
                                 (-d_).expand(ph_wi.shape))
        # transmittance from the cell entry to each disc with the cell's
        # sigma (midpoint rule within the chord; exact for homogeneous media)
        dt_p = (t_p - t_enter[:, None]).clamp_min(0.0)
        T_p = T_enter[:, None, :] * torch.exp(-sig_t[:, None, :] * dt_p[..., None])
        contrib = ph_pow * (kw * ph)[..., None] * T_p
        return L + torch.where(ok[..., None], contrib, 0.0).sum(1)

    return _walk(scene, grid, o, d, t1, radius, max_cells, max_per_cell, accum)


def radiance_beambeam(scene: schema.SceneData, beam_grid: hashgrid.HashGrid,
                      o: Tensor, d: Tensor, t1: Tensor, radius,
                      max_cells: int = 96, max_per_cell: int = 16):
    """Photon-beam x camera-beam estimator (reference Beam.h:63-117): for
    each photon beam near the camera ray, the 1D kernel over the closest
    approach between the two segments, divided by the |sin theta| Jacobian.
    Beam rows: [o(3) d(3) t_len(1) power(3) sigma_t(3) ...]; power is the
    throughput at the beam origin, attenuated to the closest-approach point
    with the stored sigma_t. Returns (L, Tr)."""
    B = o.shape[0]
    r_lane = torch.as_tensor(radius, dtype=torch.float32, device=o.device).expand(B)
    lo_m, hi_m = mediummod.media_aabb(scene.media)
    o_, d_ = o[:, None, :], d[:, None, :]

    def accum(L, rows, in_range, flat_cell, t_enter, t_exit, alive, T_enter,
              sig_t, sig_s, ptype, g):
        bo, bd = rows[..., 0:3], rows[..., 3:6]
        b_len, b_pow, b_sig = rows[..., 6], rows[..., 7:10], rows[..., 10:13]
        # closest approach between ray (o, d) and beam (bo, bd)
        w0 = o_ - bo
        b_ = vm.dot(d_, bd)
        c_ = vm.dot(bd, bd)
        dd_ = vm.dot(d_, w0)
        e_ = vm.dot(bd, w0)
        denom = c_ - b_ * b_                     # a_ == 1 for unit d
        sin2 = denom.clamp_min(1e-8)             # |d x bd|^2 for unit dirs
        s_cam = (b_ * e_ - c_ * dd_) / sin2      # param on camera ray
        t_beam = (e_ - b_ * dd_) / sin2          # param on photon beam
        s_cam_c = torch.minimum(s_cam.clamp_min(0.0), t1[:, None])
        t_beam_c = torch.minimum(t_beam.clamp_min(0.0), b_len)
        p_cam = o_ + d_ * s_cam_c[..., None]
        p_beam = bo + bd * t_beam_c[..., None]
        dist = torch.sqrt(vm.length_sqr(p_cam - p_beam).clamp_min(0.0))
        foot_cell = hashgrid.cell_of(beam_grid, p_cam)
        ok = (alive[:, None] & in_range & (dist <= r_lane[:, None])
              & (foot_cell == flat_cell[:, None])
              & (s_cam >= 0.0) & (s_cam <= t1[:, None])
              & (t_beam >= 0.0) & (t_beam <= b_len))
        sin_theta = torch.sqrt(sin2.clamp(1e-8, 1.0))
        kw = kernelsmod.k(kernelsmod.PERLIN, dist, r_lane[:, None], dim=1)
        # boundary-corrected 1D kernel (see radiance_beamgrid)
        b_d = torch.minimum(p_cam - lo_m, hi_m - p_cam).amin(-1)
        kw = kw / kernelsmod.boundary_frac(b_d.clamp_min(0.0), r_lane[:, None], 1)
        ph = phasemod.eval_phase(ptype[:, None], g[:, None], bd,
                                 (-d_).expand(bd.shape))
        # camera transmittance from the cell entry with the cell's sigma
        dt_c = (s_cam_c - t_enter[:, None]).clamp_min(0.0)
        T_cam = T_enter[:, None, :] * torch.exp(-sig_t[:, None, :] * dt_c[..., None])
        T_beam = torch.exp(-b_sig * t_beam_c[..., None])
        # in-scattered sigma_s at the gather point
        contrib = (b_pow * T_beam * T_cam * ((kw * ph / sin_theta)[..., None])
                   * sig_s[:, None, :])
        return L + torch.where(ok[..., None], contrib, 0.0).sum(1)

    return _walk(scene, beam_grid, o, d, t1, radius, max_cells, max_per_cell,
                 accum)


def build_beam_cells(beams: Tensor, valid: Tensor, radius, lo: Tensor,
                     hi: Tensor, max_dim: int = 96, samples_per_beam: int = 16,
                     keep_prob: float = 0.25) -> hashgrid.HashGrid:
    """Rasterize photon beams into the grid: sample points along each beam
    and insert the 2x2x2 neighborhood of each sample (covers cells within r
    of the beam axis; reference BeamBeamGrid inserts along a DDA). Beam
    rows: [o(3) d(3) t_len(1) power(3) sigma_t(3) ...].

    Beams are subsampled with probability keep_prob and their power scaled
    by 1/keep_prob (unbiased beam thinning), so per-cell occupancy stays
    inside the fixed gather budget."""
    N, dev = beams.shape[0], beams.device
    radius = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    if keep_prob < 1.0:
        h = rngmod.pcg_hash(torch.arange(N, dtype=torch.int64, device=dev) ^ 0xBEA7)
        keep = (h & 0xFFFF).to(torch.float32) < keep_prob * 65536.0
        valid = valid & keep
        beams = beams.clone()
        beams[:, 7:10] *= 1.0 / keep_prob
    extent = (hi - lo).clamp_min(1e-6)
    # grow the cell (never clamp dims) so the grid always covers the medium
    cell_size = torch.maximum(2.0 * radius, extent.amax() / (max_dim - 1))
    dims = torch.ceil(extent / cell_size.clamp_min(1e-6)).to(torch.int32) + 1
    inv_cell = 1.0 / cell_size.clamp_min(1e-6)
    bo, bd, b_len = beams[:, 0:3], beams[:, 3:6], beams[:, 6]
    S = samples_per_beam
    frac = (torch.arange(S, dtype=torch.float32, device=dev) + 0.5) / S
    pts = bo[:, None, :] + bd[:, None, :] * (b_len[:, None] * frac[None, :])[:, :, None]
    base = hashgrid.clip_cells(
        hashgrid.to_int32((pts - radius - lo) * inv_cell), dims - 2)   # (N,S,3)
    cc = hashgrid.clip_cells(base[:, :, None, :]
                             + hashgrid.offsets8(dev)[None, None, :, :], dims - 1)
    cid = hashgrid.flat_cell(cc, dims).reshape(N, S * 8)
    # drop duplicates within each beam (sort per beam, invalidate equal
    # neighbors)
    cid_sorted = torch.sort(cid, dim=1).values
    dup = torch.cat([torch.zeros((N, 1), dtype=torch.bool, device=dev),
                     cid_sorted[:, 1:] == cid_sorted[:, :-1]], dim=1)
    cid_final = torch.where(valid[:, None] & ~dup, cid_sorted, hashgrid.INT32_MAX)
    cid_flat = cid_final.reshape(-1)
    order = torch.argsort(cid_flat, stable=True)
    return hashgrid.HashGrid(data=beams[order // (S * 8)],
                             cell_ids=cid_flat[order], lo=lo,
                             inv_cell=inv_cell, dims=dims)
