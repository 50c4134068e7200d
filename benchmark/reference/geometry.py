"""Ray-triangle queries for the plain reference: a uniform grid over the
triangles, built here from the scene's world-space arrays, walked by a 3D
DDA (Amanatides and Woo 1987) in plain PyTorch, with a Moller-Trumbore test
of every triangle a visited cell lists. Shares nothing with the program's
BVH."""
from __future__ import annotations

import math

import numpy as np
import torch


class Grid:
    """Triangles binned into the cells their bounding boxes overlap."""

    def __init__(self, v0, v1, v2, device, dtype=torch.float32, cells_per_tri=1.0):
        v0 = np.asarray(v0, np.float64)
        v1 = np.asarray(v1, np.float64)
        v2 = np.asarray(v2, np.float64)
        lo = np.minimum(np.minimum(v0, v1), v2)
        hi = np.maximum(np.maximum(v0, v1), v2)
        g_lo = lo.min(0) - 1e-3
        g_hi = hi.max(0) + 1e-3
        ext = g_hi - g_lo
        n = v0.shape[0]
        k = (cells_per_tri * n / np.prod(ext)) ** (1.0 / 3.0)
        res = np.clip(np.ceil(ext * k), 1, 512).astype(np.int64)
        cell = ext / res
        c_lo = np.clip(np.floor((lo - g_lo) / cell), 0, res - 1).astype(np.int64)
        c_hi = np.clip(np.floor((hi - g_lo) / cell), 0, res - 1).astype(np.int64)
        span = c_hi - c_lo + 1
        counts = span.prod(1)
        tri = np.repeat(np.arange(n, dtype=np.int64), counts)
        # each pair's offset inside its triangle's box of cells
        first = np.repeat(np.cumsum(counts) - counts, counts)
        local = np.arange(tri.size, dtype=np.int64) - first
        sx, sy = span[tri, 0], span[tri, 1]
        cx = c_lo[tri, 0] + local % sx
        cy = c_lo[tri, 1] + (local // sx) % sy
        cz = c_lo[tri, 2] + local // (sx * sy)
        flat = (cz * res[1] + cy) * res[0] + cx
        order = np.argsort(flat, kind="stable")
        flat, tri = flat[order], tri[order]
        n_cells = int(res.prod())
        start = np.searchsorted(flat, np.arange(n_cells), side="left")
        end = np.searchsorted(flat, np.arange(n_cells), side="right")
        t = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=device)
        self.dtype = dtype
        self.device = device
        self.res = t(res, torch.int64)
        self.lo = t(g_lo)
        self.hi = t(g_hi)
        self.cell = t(cell)
        self.start = t(start, torch.int64)
        self.count = t(end - start, torch.int64)
        self.items = t(tri, torch.int64)
        self.v0 = t(v0)
        self.e1 = t(v1 - v0)
        self.e2 = t(v2 - v0)
        self.max_steps = int(res.sum()) + 3

    def _moller(self, o, d, tri, t_lo, t_hi):
        e1, e2, v0 = self.e1[tri], self.e2[tri], self.v0[tri]
        pv = torch.cross(d, e2, dim=-1)
        det = (e1 * pv).sum(-1)
        ok_det = det.abs() > 1e-12
        inv = 1.0 / torch.where(ok_det, det, torch.ones_like(det))
        tv = o - v0
        u = (tv * pv).sum(-1) * inv
        qv = torch.cross(tv, e1, dim=-1)
        v = (d * qv).sum(-1) * inv
        t = (e2 * qv).sum(-1) * inv
        ok = ok_det & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_lo) & (t < t_hi)
        return ok, t, u, v

    def intersect(self, o, d, tmax, any_hit=False, chunk=1 << 21):
        """Closest hit (or, with any_hit, whether any hit lies before tmax)
        of each ray. Returns (t, tri, u, v); tri is -1 where nothing was hit."""
        o = o.to(self.dtype)
        d = d.to(self.dtype)
        tmax = tmax.to(self.dtype)
        B = o.shape[0]
        best_t = tmax.clone()
        best_tri = torch.full((B,), -1, dtype=torch.int64, device=o.device)
        best_u = torch.zeros(B, dtype=self.dtype, device=o.device)
        best_v = torch.zeros(B, dtype=self.dtype, device=o.device)
        # entry into the grid's box
        inv_d = 1.0 / torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
        t0s = (self.lo - o) * inv_d
        t1s = (self.hi - o) * inv_d
        t_enter = torch.minimum(t0s, t1s).amax(-1).clamp_min(0.0)
        t_leave = torch.maximum(t0s, t1s).amin(-1)
        active = (t_enter <= t_leave) & (t_enter < tmax)
        p = o + d * t_enter[:, None]
        cidx = torch.floor((p - self.lo) / self.cell).to(torch.int64)
        cidx = torch.minimum(torch.maximum(cidx, torch.zeros_like(cidx)), self.res - 1)
        step = torch.where(d >= 0, 1, -1).to(torch.int64)
        nxt = self.lo + (cidx + (step > 0).to(torch.int64)).to(self.dtype) * self.cell
        t_next = torch.where(d.abs() < 1e-12, torch.full_like(d, math.inf), (nxt - o) * inv_d)
        t_delta = torch.where(d.abs() < 1e-12, torch.full_like(d, math.inf),
                              self.cell * inv_d.abs())
        ids = torch.arange(B, device=o.device)
        for _ in range(self.max_steps):
            a = ids[active]
            if a.numel() == 0:
                break
            c = cidx[a]
            flat = (c[:, 2] * self.res[1] + c[:, 1]) * self.res[0] + c[:, 0]
            cnt = self.count[flat]
            t_exit = t_next[a].amin(-1)
            has = cnt > 0
            if bool(has.any()):
                ah, fh, ch = a[has], flat[has], cnt[has]
                for s in range(0, ah.numel(), chunk):
                    ray = torch.repeat_interleave(ah[s:s + chunk], ch[s:s + chunk])
                    first = torch.repeat_interleave(self.start[fh[s:s + chunk]], ch[s:s + chunk])
                    offs = torch.cumsum(ch[s:s + chunk], 0) - ch[s:s + chunk]
                    local = (torch.arange(ray.numel(), device=o.device)
                             - torch.repeat_interleave(offs, ch[s:s + chunk]))
                    tri = self.items[first + local]
                    ok, t, u, v = self._moller(o[ray], d[ray], tri, 0.0, best_t[ray])
                    if not bool(ok.any()):
                        continue
                    ray, tri, t, u, v = ray[ok], tri[ok], t[ok], u[ok], v[ok]
                    if any_hit:
                        best_tri[ray] = tri
                        best_t[ray] = t
                        continue
                    m = torch.full((B,), math.inf, dtype=self.dtype, device=o.device)
                    m.scatter_reduce_(0, ray, t, reduce="amin")
                    win = t == m[ray]
                    ray, tri, t, u, v = ray[win], tri[win], t[win], u[win], v[win]
                    # ties: the lowest triangle id
                    key = torch.full((B,), self.items.numel() + 1,
                                     dtype=torch.int64, device=o.device)
                    key.scatter_reduce_(0, ray, tri, reduce="amin")
                    win = tri == key[ray]
                    ray, tri, t, u, v = ray[win], tri[win], t[win], u[win], v[win]
                    best_t[ray] = t
                    best_tri[ray] = tri
                    best_u[ray] = u
                    best_v[ray] = v
            # a ray is done once its best hit lies inside the current cell,
            # or it leaves the grid
            done = (best_tri[a] >= 0) & ((best_t[a] <= t_exit) | any_hit)
            axis = t_next[a].argmin(-1)
            onehot = torch.nn.functional.one_hot(axis, 3).to(torch.bool)
            cidx[a] = torch.where(onehot, c + step[a], c)
            t_next[a] = torch.where(onehot, t_next[a] + t_delta[a], t_next[a])
            c2 = cidx[a]
            out = ((c2 < 0) | (c2 >= self.res)).any(-1) | (t_exit > best_t[a]) | (t_exit > tmax[a])
            active[a] = ~(done | out)
        return best_t, best_tri, best_u, best_v
