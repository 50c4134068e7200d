"""One frame of path-space-filtered direct light, worked out by the plain
reference for the game cell.

The frame is a deterministic function of the scene, the pass index and
the history (the previous frame's image, hit points and normals): camera
rays jittered by the PCG streams, the primary hits, one light sample each
(lights chosen by power; an area light's triangle by a Walker alias table
over area and a point uniform on it; the environment's texel by an alias
table over luminance times sin(theta)), a shadow ray, a cache of (position,
light, normal) rows sorted by cells of twice the radius, a gather of at
most 16 rows from each of the 2x2x2 cells around a hit within a
footprint-sized radius, the rows' light averaged where the normals agree
within 0.8, and an exponential blend with the history where the hit stayed
put; an area light seen directly adds its radiance. Everything here is
worked out from the frozen scene description: the acceleration structure
(``geometry.Grid``), the light and alias tables and the cell sort; the
history is the reference's own previous frame."""
from __future__ import annotations

import math

import numpy as np
import torch

from . import pcg
from .path import _dot
from ..scenes import common
from .scene import RefScene, offset_origin

LUM_W = np.array([0.212671, 0.715160, 0.072169], np.float32)
PER_CELL = 16


def _alias_table(weights):
    """Walker/Vose alias rows (prob, alias, pmf_self, pmf_alias)."""
    w = np.asarray(weights, np.float64).ravel()
    n = w.size
    pmf = w / w.sum()
    scaled = pmf * n
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s_i = small.pop()
        l_i = large.pop()
        prob[s_i] = scaled[s_i]
        alias[s_i] = l_i
        scaled[l_i] = (scaled[l_i] + scaled[s_i]) - 1.0
        (small if scaled[l_i] < 1.0 else large).append(l_i)
    for i in small + large:
        prob[i] = 1.0
        alias[i] = i
    return (prob.astype(np.float32), alias, pmf.astype(np.float32),
            pmf[alias].astype(np.float32))


class GameReference:
    def __init__(self, rs: RefScene, radius: float, temporal_alpha: float):
        self.rs = rs
        self.radius = radius
        self.alpha = temporal_alpha
        desc = rs.desc
        dev, dt = rs.device, rs.dtype
        t = lambda x, d=dt: torch.as_tensor(np.asarray(x), dtype=d, device=dev)
        lo, hi = rs.world_lo, rs.world_hi
        # lights in the scene's order (distant, area, environment), chosen by
        # power; the powers and their sums in float32
        powers = np.asarray([row[1] for row in rs.light_rows], np.float32)
        cdf = np.cumsum(powers)
        self.cdf = t(cdf / max(cdf[-1], 1e-20), torch.float32)
        self.kinds = []
        a = common.world_arrays(desc)
        for kind, _, prm in rs.light_rows:
            if kind == "distant":
                self.kinds.append((kind, prm))
            elif kind == "area":
                ids = prm["ids"]
                v0, v1, v2 = a["v0"][ids], a["v1"][ids], a["v2"][ids]
                e1, e2 = v1 - v0, v2 - v0
                ng = np.cross(e1, e2)
                ng = ng / np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
                areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
                prob, alias, _, _ = _alias_table(areas)
                self.kinds.append((kind, dict(
                    n=len(ids), prob=t(prob, torch.float32), alias=t(alias, torch.int64),
                    v0=t(v0), e1=t(e1), e2=t(e2), ng=t(ng.astype(np.float32)),
                    le=t(prm["le"]), area=float(np.float32(areas.sum())))))
            else:
                self.kinds.append((kind, None))
        if desc.env_image is not None:
            env = desc.env_image.astype(np.float32)
            He, We = env.shape[:2]
            sin_t = np.sin((np.arange(He) + 0.5) / He * np.pi)[:, None].astype(np.float32)
            prob, alias, pmf, pmf_alias = _alias_table((env @ LUM_W) * sin_t + 1e-12)
            self.a_prob = t(prob, torch.float32)
            self.a_alias = t(alias, torch.int64)
            self.a_pmf = t(pmf)
            self.a_pmf_alias = t(pmf_alias)
            self.env = t(env)
            self.He, self.We = He, We
        self.diag = float(np.linalg.norm(hi - lo))
        self.lo = t(lo)
        self.hi = t(hi)

    def _sample_light(self, p, state):
        """(direction, distance, radiance over pdf) of one light sample."""
        dev, dt = p.device, p.dtype
        B = p.shape[0]
        state, u_sel = pcg.next_float(state)
        state, ua = pcg.next_float(state)
        state, ub = pcg.next_float(state)
        state, u_tri = pcg.next_float(state)
        state, ue0 = pcg.next_float(state)
        state, ue1 = pcg.next_float(state)
        idx = torch.searchsorted(self.cdf, u_sel, side="left").clamp(0, self.cdf.numel() - 1)
        prev = torch.where(idx > 0, self.cdf[(idx - 1).clamp_min(0)], torch.zeros_like(u_sel))
        pdf_sel = (self.cdf[idx] - prev).clamp_min(1e-12).to(dt)
        d_out = torch.zeros((B, 3), dtype=dt, device=dev)
        dist = torch.zeros(B, dtype=dt, device=dev)
        rop = torch.zeros((B, 3), dtype=dt, device=dev)
        for i, (kind, prm) in enumerate(self.kinds):
            sel = idx == i
            if kind == "distant":
                d_out = torch.where(sel[:, None], -torch.as_tensor(prm["d"], dtype=dt,
                                                                   device=dev), d_out)
                dist = torch.where(sel, 1e7, dist)
                rop = torch.where(sel[:, None], torch.as_tensor(prm["rad"], dtype=dt,
                                                                device=dev), rop)
            elif kind == "area":
                # a triangle by area (alias table), a point uniform on it
                n = prm["n"]
                scaled = u_tri.clamp_max(1.0 - 1e-7) * n
                slot = scaled.to(torch.int64).clamp_max(n - 1)
                frac = scaled - slot.to(torch.float32)
                k = torch.where(frac < prm["prob"][slot], slot, prm["alias"][slot])
                sq = torch.sqrt(ua.clamp_min(0.0)).to(dt)
                b0, b1 = (1.0 - sq)[:, None], (sq * ub.to(dt))[:, None]
                pos = prm["v0"][k] + prm["e1"][k] * b0 + prm["e2"][k] * b1
                dd = pos - p
                d2 = (dd * dd).sum(-1).clamp_min(1e-12)
                dl = torch.sqrt(d2)
                dirn = dd / dl[:, None]
                cos_l = -(prm["ng"][k] * dirn).sum(-1)
                pdf = d2 / (cos_l * prm["area"]).clamp_min(1e-9)
                r = torch.where((cos_l > 0)[:, None], prm["le"] / pdf[:, None],
                                torch.zeros_like(dd))
                d_out = torch.where(sel[:, None], dirn, d_out)
                dist = torch.where(sel, dl, dist)
                rop = torch.where(sel[:, None], r, rop)
            else:
                n = self.He * self.We
                slot = (ue0 * n).to(torch.int64).clamp_max(n - 1)
                use_alias = ue1 >= self.a_prob[slot]
                pix = torch.where(use_alias, self.a_alias[slot], slot)
                pmf = torch.where(use_alias, self.a_pmf_alias[slot], self.a_pmf[slot])
                y, x = pix // self.We, pix % self.We
                dirn, st = self.rs.env_dir(y, x)
                jac = (self.He * self.We) / (2.0 * math.pi * math.pi * st.clamp_min(1e-5))
                pdf = (pmf * jac).clamp_min(1e-12)
                le = self.env[y, x]
                d_out = torch.where(sel[:, None], dirn, d_out)
                dist = torch.where(sel, self.diag * 2.0, dist)
                rop = torch.where(sel[:, None], le / pdf[:, None], rop)
        return d_out, dist, rop / pdf_sel[:, None], state

    def frame(self, pass_idx: int, prev_rgb=None, prev_p=None, prev_ns=None,
              with_state: bool = False):
        """The frame's image (H, W, 3); without a history, the first frame.
        with_state adds the frame's hit points and normals (the next
        frame's history)."""
        rs = self.rs
        W, H = rs.desc.width, rs.desc.height
        dev, dt = rs.device, rs.dtype
        B = W * H
        pix = torch.arange(B, dtype=torch.int64, device=dev)
        state = pcg.seed(pix, 0, pass_idx)
        state, ux = pcg.next_float(state)
        state, uy = pcg.next_float(state)
        state, _ = pcg.next_float(state)
        state, _ = pcg.next_float(state)
        fx = ((pix % W).to(torch.float32) + 0.5 + (ux - 0.5)).to(dt)
        fy = ((pix // W).to(torch.float32) + 0.5 + (uy - 0.5)).to(dt)
        o, d = rs.camera_rays(fx, fy)
        t_hit, tri, u, v = rs.grid.intersect(o, d, torch.full((B,), 1e30, dtype=dt, device=dev))
        alive = tri >= 0
        p, ng, ns, uv, mat = rs.surface(o, d, t_hit, tri, u, v)
        wi = -d
        c0 = rs.albedo(mat, uv)

        ld, ldist, rop, state = self._sample_light(p, state)
        n2 = torch.where((_dot(wi, ns) < 0)[:, None], -ns, ns)
        ci, co = _dot(wi, n2), _dot(ld, n2)
        f = c0 * (co.clamp_min(0.0) / math.pi)[:, None]
        f = torch.where(((ci > 0) & (co > 0))[:, None], f, torch.zeros_like(f))
        so = offset_origin(p, ng, ld)
        _, occ, _, _ = rs.grid.intersect(so, ld, torch.where(alive, ldist * 0.999,
                                                             torch.zeros_like(ldist)), any_hit=True)
        Li = torch.where((alive & (occ < 0))[:, None], f * rop, torch.zeros_like(f))

        # the cache: rows sorted by cell (stable, so pixel order within one)
        cell = torch.tensor(2.0 * self.radius, dtype=torch.float32, device=dev).to(dt)
        extent = (self.hi - self.lo).clamp_min(1e-6)
        dims = (torch.ceil(extent / cell).to(torch.int64) + 1).clamp_max(128)
        inv_cell = 1.0 / cell

        def flat(c):
            return (c[..., 2] * dims[1] + c[..., 1]) * dims[0] + c[..., 0]

        def to_int(x):
            return torch.where(torch.isfinite(x), x, torch.zeros_like(x)).clamp(
                -2.0 ** 31, 2.0 ** 31 - 1).to(torch.int64)

        c = torch.minimum(to_int((p - self.lo) * inv_cell).clamp_min(0), dims - 1)
        cid = torch.where(alive, flat(c), torch.full_like(flat(c), 2 ** 31 - 1))
        order = torch.argsort(cid, stable=True)
        s_cid, s_p, s_li, s_ns = cid[order], p[order], Li[order], ns[order]

        params_fov = math.radians(rs.desc.fov_x_deg)
        cone = 2.0 * math.tan(0.5 * params_fov) / max(float(W), 1.0)
        r_lane = (4.0 * cone * t_hit).clamp(self.radius / 16.0, self.radius)
        base = to_int((p - r_lane[:, None] - self.lo) * inv_cell)
        base = torch.minimum(base.clamp_min(0), dims - 2)
        offs = torch.tensor([[i, j, k] for k in (0, 1) for j in (0, 1) for i in (0, 1)],
                            dtype=torch.int64, device=dev)
        cells = flat(torch.minimum((base[:, None, :] + offs).clamp_min(0), dims - 1))
        start = torch.searchsorted(s_cid, cells.reshape(-1), side="left").reshape(B, 8)
        count = (torch.searchsorted(s_cid, cells.reshape(-1), side="right").reshape(B, 8) - start)
        acc = torch.zeros((B, 3), dtype=dt, device=dev)
        cnt = torch.zeros(B, dtype=dt, device=dev)
        for k in range(PER_CELL):
            idx = (start + k).clamp_max(B - 1)
            rp, rl, rn = s_p[idx], s_li[idx], s_ns[idx]
            d2 = ((rp - p[:, None, :]) ** 2).sum(-1)
            ok = ((k < count) & (d2 <= (r_lane * r_lane)[:, None])
                  & ((rn * ns[:, None, :]).sum(-1) > 0.8))
            acc = acc + torch.where(ok[..., None], rl, torch.zeros_like(rl)).sum(1)
            cnt = cnt + ok.to(dt).sum(1)
        filtered = acc / cnt.clamp_min(1.0)[:, None]
        # an area light seen directly adds its radiance (one-sided along ng)
        lid = torch.where(alive, rs.tri_light_t[tri.clamp_min(0)], -1)
        le = torch.zeros_like(filtered)
        for i, (kind, prm) in enumerate(self.kinds):
            if kind == "area":
                front = (lid == i) & (_dot(ng, wi) > 0)
                le = torch.where(front[:, None], prm["le"], le)
        Lout = torch.where(alive[:, None], filtered + le, rs.eval_env(d))
        state_out = (p.reshape(H, W, 3), ns.reshape(H, W, 3))
        if prev_rgb is None:
            img = Lout.reshape(H, W, 3)
            return (img, *state_out) if with_state else img
        same_pt = (p - prev_p.reshape(B, 3).to(dt)).norm(dim=-1) < r_lane
        same_n = _dot(ns, prev_ns.reshape(B, 3).to(dt)) > 0.9
        a = torch.where(same_pt & same_n, self.alpha, 1.0).to(dt).reshape(H, W, 1)
        img = prev_rgb.to(dt) * (1 - a) + Lout.reshape(H, W, 3) * a
        return (img, *state_out) if with_state else img
