"""The plain reference's view of a benchmark scene: world-space triangle
tensors, materials, textures, lights and the camera, worked out from the
frozen description alone (``benchmark/scenes``), in a chosen dtype."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..scenes import common
from .geometry import Grid

LUM = (0.212671, 0.715160, 0.072169)
DIFFUSE, ROUGHCONDUCTOR = 0, 1


class RefScene:
    def __init__(self, desc: common.Scene, device, dtype=torch.float32):
        a = common.world_arrays(desc)
        self.desc = desc
        self.device = device
        self.dtype = dtype
        t = lambda x, dt=dtype: torch.as_tensor(np.asarray(x), dtype=dt, device=device)
        self.grid = Grid(a["v0"], a["v1"], a["v2"], device, dtype)
        e1 = a["v1"].astype(np.float64) - a["v0"]
        e2 = a["v2"].astype(np.float64) - a["v0"]
        cr = np.cross(e1, e2)
        area2 = np.linalg.norm(cr, axis=-1)
        self.ng = t(cr / np.maximum(area2, 1e-20)[:, None])
        self.n = [t(a[f"n{k}"]) for k in range(3)]
        self.uv = [t(a[f"uv{k}"]) for k in range(3)]
        self.mat = t(a["mat"], torch.int64)
        self.emit = t(a["emit"])
        pts = np.concatenate([a["v0"], a["v1"], a["v2"]])
        self.world_lo = pts.min(0).astype(np.float32)
        self.world_hi = pts.max(0).astype(np.float32)
        allv = np.concatenate([n.mesh.transformed(n.to_world).v for n in desc.nodes])
        self.diag = float(np.linalg.norm(allv.max(0) - allv.min(0)))
        self.world_radius = 0.5 * float(np.linalg.norm(self.world_hi - self.world_lo)) + 1e-3

        # materials and their textures
        mats = desc.materials
        self.m_kind = t([DIFFUSE if m.kind == "diffuse" else ROUGHCONDUCTOR for m in mats],
                        torch.int64)
        self.m_refl = t([m.reflectance for m in mats])
        self.m_alpha = t([max(m.alpha, 1e-4) for m in mats])
        self.m_eta = t([m.eta_c for m in mats])
        self.m_k = t([m.k_c for m in mats])
        self.textures = {i: m.texture for i, m in enumerate(mats) if m.texture is not None}
        self.images = {i: t(tex[1]) for i, tex in self.textures.items() if tex[0] == "image"}

        # area lights: one per emissive node, in node order; then the
        # distant lights ahead of them and the environment last, selected
        # in proportion to their power
        tri_first = np.cumsum([0] + [n.mesh.f.shape[0] for n in desc.nodes])
        rows = []
        areas = 0.5 * area2
        for d, rad in desc.distant:
            rows.append(("distant", float(np.dot(rad, LUM)) * math.pi * self.world_radius ** 2,
                         dict(d=np.asarray(d, np.float32), rad=np.asarray(rad, np.float32))))
        self.tri_light = np.full(a["mat"].shape[0], -1, np.int64)
        for k, node in enumerate(desc.nodes):
            if node.emission is None or max(node.emission) <= 0:
                continue
            ids = np.arange(tri_first[k], tri_first[k + 1])
            tot = float(areas[ids].sum())
            rows.append(("area", float(np.dot(node.emission, LUM)) * math.pi * tot,
                         dict(ids=ids, le=np.asarray(node.emission, np.float32),
                              area=tot, cdf=np.cumsum(areas[ids]) / tot)))
        if desc.env_image is not None:
            env = desc.env_image.astype(np.float32)
            env_lum = float(np.mean(env @ np.asarray(LUM, np.float32)))
            rows.append(("env", env_lum * 4 * math.pi * math.pi * self.world_radius ** 2, {}))
        for i, (kind, _, p) in enumerate(rows):
            if kind == "area":
                self.tri_light[p["ids"]] = i
        self.light_rows = rows
        powers = np.array([r[1] for r in rows], np.float64)
        self.light_p = powers / powers.sum()
        self.tri_light_t = t(self.tri_light, torch.int64)
        self.env = None
        if desc.env_image is not None:
            env = desc.env_image.astype(np.float32)
            He, We = env.shape[:2]
            sin_t = np.sin((np.arange(He) + 0.5) / He * np.pi)[:, None]
            w = (env @ np.asarray(LUM, np.float32)) * sin_t + 1e-12
            self.env = t(env)
            self.env_pmf_np = (w / w.sum()).ravel()
            self.env_pmf = t(self.env_pmf_np)
        self.cam = desc.camera_to_world.astype(np.float64)
        self.tan_half = math.tan(0.5 * math.radians(desc.fov_x_deg))

    # -- geometry ---------------------------------------------------------
    def surface(self, o, d, t_hit, tri, u, v):
        """Hit position, geometric and shading normals, uv, material."""
        tr = tri.clamp_min(0)
        w = (1 - u - v)[:, None]
        ns = w * self.n[0][tr] + u[:, None] * self.n[1][tr] + v[:, None] * self.n[2][tr]
        ns = ns / ns.norm(dim=-1, keepdim=True).clamp_min(1e-20)
        uv = w * self.uv[0][tr] + u[:, None] * self.uv[1][tr] + v[:, None] * self.uv[2][tr]
        p = o + d * t_hit[:, None]
        return p, self.ng[tr], ns, uv, self.mat[tr]

    # -- textures: bilinear at full resolution, repeat wrap, v flipped ---
    def albedo(self, mat, uv):
        out = self.m_refl[mat]
        for i, tex in self.textures.items():
            sel = mat == i
            if not bool(sel.any()):
                continue
            uvs = uv[sel]
            if tex[0] == "checker":
                u = uvs[:, 0] * tex[3][0]
                v = uvs[:, 1] * tex[3][1]
                par = (torch.floor(u).to(torch.int64) + torch.floor(v).to(torch.int64)) & 1
                c0 = torch.as_tensor(tex[1], dtype=self.dtype, device=self.device)
                c1 = torch.as_tensor(tex[2], dtype=self.dtype, device=self.device)
                col = torch.where((par == 0)[:, None], c0, c1)
            else:
                img = self.images[i]
                h, w_ = img.shape[0], img.shape[1]
                u = uvs[:, 0] * tex[2][0]
                v = uvs[:, 1] * tex[2][1]
                x = torch.remainder(u, 1.0) * w_ - 0.5
                y = torch.remainder(1.0 - torch.remainder(v, 1.0), 1.0) * h - 0.5
                x0 = torch.floor(x)
                y0 = torch.floor(y)
                fx = (x - x0)[:, None]
                fy = (y - y0)[:, None]
                xi = x0.to(torch.int64)
                yi = y0.to(torch.int64)
                tex_at = lambda yy, xx: img[torch.remainder(yy, h), torch.remainder(xx, w_)]
                col = (tex_at(yi, xi) * (1 - fx) * (1 - fy) + tex_at(yi, xi + 1) * fx * (1 - fy)
                       + tex_at(yi + 1, xi) * (1 - fx) * fy + tex_at(yi + 1, xi + 1) * fx * fy)
            out = out.clone()
            out[sel] = col.to(self.dtype)
        return out

    # -- camera: perspective, film coordinates in pixels ------------------
    def camera_rays(self, fx, fy):
        W, H = self.desc.width, self.desc.height
        x = (2.0 * fx / W - 1.0) * self.tan_half
        y = (1.0 - 2.0 * fy / H) * self.tan_half * (H / W)
        dc = torch.stack([x, y, torch.ones_like(x)], -1)
        dc = dc / dc.norm(dim=-1, keepdim=True)
        rot = torch.as_tensor(self.cam[:3, :3], dtype=self.dtype, device=self.device)
        d = dc @ rot.T
        d = d / d.norm(dim=-1, keepdim=True)
        o = torch.as_tensor(self.cam[:3, 3], dtype=self.dtype, device=self.device).expand_as(d)
        return o.contiguous(), d

    # -- environment: equirectangular, nearest texel ----------------------
    def env_uv(self, d):
        theta = torch.arccos(d[:, 1].clamp(-1.0, 1.0))
        phi = torch.atan2(d[:, 0], -d[:, 2])
        u = torch.remainder((phi + math.pi) / (2 * math.pi), 1.0)
        return u, (theta / math.pi).clamp(0.0, 1.0)

    def env_texel(self, d):
        He, We = self.env.shape[0], self.env.shape[1]
        u, v = self.env_uv(d)
        x = (u * We).to(torch.int64).clamp(0, We - 1)
        y = (v * He).to(torch.int64).clamp(0, He - 1)
        return y, x

    def eval_env(self, d):
        if self.env is None:
            return torch.zeros_like(d)
        y, x = self.env_texel(d)
        return self.env[y, x]

    def env_dir(self, y, x):
        He, We = self.env.shape[0], self.env.shape[1]
        phi = ((x.to(self.dtype) + 0.5) / We) * 2 * math.pi - math.pi
        theta = ((y.to(self.dtype) + 0.5) / He) * math.pi
        st = torch.sin(theta)
        d = torch.stack([st * torch.sin(phi), torch.cos(theta), -st * torch.cos(phi)], -1)
        return d, st


def offset_origin(p, n, d, eps=1e-4):
    """A secondary ray's origin pushed off the surface along the side of n
    that d leaves by."""
    scale = p.abs().amax(-1).clamp_min(1.0)
    side = torch.where(((d * n).sum(-1) >= 0)[:, None], n, -n)
    return p + (eps * scale)[:, None] * side
