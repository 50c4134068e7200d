"""A plain path tracer for the reference: the same light transport as the
program's path tracers (NEE with the power heuristic at every vertex,
emission and environment weighted against it, Russian roulette, at most
`max_depth` segments) with its own random numbers (a torch.Generator), its
own warps and its own GGX visible-normal sampling. Both are unbiased
estimators of the same truncated path integral, so their pixel means agree
in expectation; ``judge.py`` compares them tile by tile."""
from __future__ import annotations

import math

import torch

from .scene import DIFFUSE, RefScene, offset_origin

INV_PI = 1.0 / math.pi


def _frame(n):
    """An orthonormal basis (t, b) about unit n (Duff et al. 2017)."""
    s = torch.where(n[:, 2] >= 0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = torch.stack([1.0 + s * n[:, 0] ** 2 * a, s * b, -s * n[:, 0]], -1)
    bt = torch.stack([b, s + n[:, 1] ** 2 * a, -n[:, 1]], -1)
    return t, bt


def _dot(a, b):
    return (a * b).sum(-1)


def _ggx_d(cos_m, alpha):
    c2 = cos_m * cos_m
    a2 = alpha * alpha
    root = c2 * (1.0 + (1.0 - c2) / c2.clamp_min(1e-12) / a2)
    d = 1.0 / (math.pi * a2 * (root * root).clamp_min(1e-16))
    return torch.where(cos_m > 0, d, torch.zeros_like(d))


def _ggx_g1(cos_v, v_dot_m, alpha):
    c2 = (cos_v * cos_v).clamp_min(1e-12)
    tan2 = ((1.0 - c2) / c2).clamp_min(0.0)
    g = 2.0 / (1.0 + torch.sqrt(1.0 + alpha * alpha * tan2))
    return torch.where(v_dot_m * cos_v <= 0, torch.zeros_like(g), g)


def _fresnel_conductor(cos_i, eta, k):
    ci2 = (cos_i * cos_i)[:, None]
    si2 = 1.0 - ci2
    t0 = eta * eta - k * k - si2
    a2pb2 = torch.sqrt((t0 * t0 + 4.0 * k * k * eta * eta).clamp_min(0.0))
    a = torch.sqrt((0.5 * (a2pb2 + t0)).clamp_min(0.0))
    ci = cos_i.abs()[:, None]
    t1 = a2pb2 + ci2
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / (t1 + t2).clamp_min(1e-12)
    t3 = ci2 * a2pb2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / (t3 + t4).clamp_min(1e-12)
    return 0.5 * (rs + rp)


def power_heuristic(a, b):
    a2 = a * a
    return torch.where(a > 0, a2 / (a2 + b * b).clamp_min(1e-30), torch.zeros_like(a))


class Bsdf:
    """Two-sided diffuse or GGX rough conductor at a batch of hits, about
    the shading normal turned toward the incoming direction."""

    def __init__(self, rs: RefScene, mat, uv, ns, wi):
        self.n = torch.where((_dot(wi, ns) < 0)[:, None], -ns, ns)
        self.wi = wi
        self.kind = rs.m_kind[mat]
        self.c0 = rs.albedo(mat, uv)
        self.alpha = rs.m_alpha[mat]
        self.eta = rs.m_eta[mat]
        self.k = rs.m_k[mat]
        self.diffuse = self.kind == DIFFUSE

    def eval(self, wo):
        """(f * cos_o, solid-angle pdf) toward wo."""
        n, wi = self.n, self.wi
        ci = _dot(wi, n)
        co = _dot(wo, n)
        up = (ci > 0) & (co > 0)
        f_d = self.c0 * (INV_PI * co.clamp_min(0.0))[:, None]
        pdf_d = co.clamp_min(0.0) * INV_PI
        h = wi + wo
        h = h / h.norm(dim=-1, keepdim=True).clamp_min(1e-20)
        ch = _dot(h, n)
        D = _ggx_d(ch, self.alpha)
        g1i = _ggx_g1(ci, _dot(wi, h), self.alpha)
        G = g1i * _ggx_g1(co, _dot(wo, h), self.alpha)
        F = _fresnel_conductor(_dot(wi, h), self.eta, self.k)
        cic = ci.abs().clamp_min(1e-6)
        f_c = self.c0 * F * (D * G / (4.0 * cic))[:, None]
        pdf_vis = g1i * _dot(wi, h).abs() * D / ci.abs().clamp_min(1e-12)
        pdf_c = pdf_vis / (4.0 * _dot(wo, h).abs()).clamp_min(1e-8)
        f = torch.where(self.diffuse[:, None], f_d, f_c)
        pdf = torch.where(self.diffuse, pdf_d, pdf_c)
        return (torch.where(up[:, None], f, torch.zeros_like(f)),
                torch.where(up, pdf, torch.zeros_like(pdf)))

    def sample(self, u1, u2):
        """(wo, weight f*cos/pdf, pdf)."""
        n, wi = self.n, self.wi
        t, b = _frame(n)
        # diffuse: cosine-weighted hemisphere
        r = torch.sqrt(u1)
        phi = 2 * math.pi * u2
        z = torch.sqrt((1 - u1).clamp_min(0.0))
        wo_d = (r * torch.cos(phi))[:, None] * t + (r * torch.sin(phi))[:, None] * b + z[:, None] * n
        # conductor: GGX visible normals (Heitz 2018) in the local frame
        a = self.alpha
        vl = torch.stack([_dot(wi, t), _dot(wi, b), _dot(wi, n)], -1)
        vh = torch.stack([a * vl[:, 0], a * vl[:, 1], vl[:, 2]], -1)
        vh = vh / vh.norm(dim=-1, keepdim=True).clamp_min(1e-20)
        lensq = vh[:, 0] ** 2 + vh[:, 1] ** 2
        t1 = torch.where((lensq > 0)[:, None],
                         torch.stack([-vh[:, 1], vh[:, 0], torch.zeros_like(lensq)], -1)
                         / torch.sqrt(lensq.clamp_min(1e-30))[:, None],
                         torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device))
        t2 = torch.cross(vh, t1, dim=-1)
        rr = torch.sqrt(u1)
        ph = 2 * math.pi * u2
        p1 = rr * torch.cos(ph)
        p2 = rr * torch.sin(ph)
        s = 0.5 * (1.0 + vh[:, 2])
        p2 = (1.0 - s) * torch.sqrt((1.0 - p1 * p1).clamp_min(0.0)) + s * p2
        nh = (p1[:, None] * t1 + p2[:, None] * t2
              + torch.sqrt((1.0 - p1 * p1 - p2 * p2).clamp_min(0.0))[:, None] * vh)
        ml = torch.stack([a * nh[:, 0], a * nh[:, 1], nh[:, 2].clamp_min(0.0)], -1)
        ml = ml / ml.norm(dim=-1, keepdim=True).clamp_min(1e-20)
        m = ml[:, 0:1] * t + ml[:, 1:2] * b + ml[:, 2:3] * n
        wo_c = 2.0 * _dot(wi, m)[:, None] * m - wi
        wo = torch.where(self.diffuse[:, None], wo_d, wo_c)
        f, pdf = self.eval(wo)
        w = f / pdf.clamp_min(1e-12)[:, None]
        ok = (pdf > 0) & (_dot(wo, n) > 0) & (_dot(wi, n) > 0)
        return wo, torch.where(ok[:, None], w, torch.zeros_like(w)), pdf


class Lights:
    """Next-event estimation toward one light chosen by power."""

    def __init__(self, rs: RefScene):
        self.rs = rs
        dev, dt = rs.device, rs.dtype
        self.sel_cdf = torch.as_tensor(rs.light_p.cumsum(), dtype=torch.float64, device=dev)
        self.p_sel = torch.as_tensor(rs.light_p, dtype=dt, device=dev)
        self.kinds = [r[0] for r in rs.light_rows]
        if rs.env is not None:
            self.env_cdf = torch.as_tensor(rs.env_pmf_np.cumsum(), dtype=torch.float64, device=dev)
            self.env_row = self.kinds.index("env")

    def pdf_env(self, d):
        """Solid-angle pdf that NEE picks direction d on the environment."""
        rs = self.rs
        He, We = rs.env.shape[0], rs.env.shape[1]
        y, x = rs.env_texel(d)
        _, v = rs.env_uv(d)
        sin_t = torch.sin(v.clamp(1e-4, 1 - 1e-4) * math.pi).clamp_min(1e-5)
        return rs.env_pmf[y * We + x] * (He * We) / (2 * math.pi ** 2 * sin_t) * self.p_sel[self.env_row]

    def pdf_area(self, ref_p, hit_p, tri):
        """Solid-angle pdf that NEE picks this point of an area light."""
        rs = self.rs
        li = rs.tri_light_t[tri.clamp_min(0)]
        area = torch.zeros(li.shape, dtype=rs.dtype, device=rs.device)
        psel = torch.zeros_like(area)
        for i, (kind, _, p) in enumerate(rs.light_rows):
            if kind == "area":
                area = torch.where(li == i, p["area"], area)
                psel = torch.where(li == i, self.p_sel[i], psel)
        d = hit_p - ref_p
        dist2 = _dot(d, d).clamp_min(1e-12)
        cos_l = _dot(rs.ng[tri.clamp_min(0)], -d) * torch.rsqrt(dist2)
        pdf = dist2 / (cos_l * area).clamp_min(1e-9) * psel
        return torch.where((li >= 0) & (cos_l > 0), pdf, torch.zeros_like(pdf))

    def sample(self, p, gen):
        """(direction, distance, radiance / pdf, solid-angle pdf, is_delta)."""
        rs = self.rs
        B, dev, dt = p.shape[0], p.device, p.dtype
        u = torch.rand((B, 4), generator=gen, device=dev, dtype=torch.float64)
        idx = torch.searchsorted(self.sel_cdf, u[:, 0].contiguous(), side="right").clamp_max(
            len(self.kinds) - 1)
        d_out = torch.zeros((B, 3), dtype=dt, device=dev)
        dist = torch.ones(B, dtype=dt, device=dev)
        rop = torch.zeros((B, 3), dtype=dt, device=dev)
        pdf = torch.zeros(B, dtype=dt, device=dev)
        delta = torch.zeros(B, dtype=torch.bool, device=dev)
        diag = float(torch.linalg.vector_norm(torch.as_tensor(rs.world_hi - rs.world_lo)))
        for i, (kind, _, prm) in enumerate(rs.light_rows):
            sel = idx == i
            if not bool(sel.any()):
                continue
            ps = self.p_sel[i]
            if kind == "distant":
                d_out[sel] = -torch.as_tensor(prm["d"], dtype=dt, device=dev)
                dist[sel] = 1e7
                rop[sel] = torch.as_tensor(prm["rad"], dtype=dt, device=dev) / ps
                delta[sel] = True
            elif kind == "area":
                cdf = torch.as_tensor(prm["cdf"], dtype=torch.float64, device=dev)
                k = torch.searchsorted(cdf, u[sel, 1].contiguous(), side="right").clamp_max(
                    cdf.numel() - 1)
                tri = torch.as_tensor(prm["ids"], device=dev)[k]
                su = torch.sqrt(u[sel, 2]).to(dt)
                b0 = 1.0 - su
                b1 = (u[sel, 3].to(dt)) * su
                g = rs.grid
                q = g.v0[tri] + g.e1[tri] * (1 - b0 - b1)[:, None] + g.e2[tri] * b1[:, None]
                dv = q - p[sel]
                d2 = _dot(dv, dv).clamp_min(1e-12)
                dd = torch.sqrt(d2)
                dirn = dv / dd[:, None]
                cos_l = _dot(rs.ng[tri], -dirn)
                pa = d2 / (cos_l * prm["area"]).clamp_min(1e-9) * ps
                le = torch.as_tensor(prm["le"], dtype=dt, device=dev)
                d_out[sel] = dirn
                dist[sel] = dd
                rop[sel] = torch.where((cos_l > 0)[:, None], le / pa.clamp_min(1e-20)[:, None],
                                       torch.zeros_like(dirn))
                pdf[sel] = torch.where(cos_l > 0, pa, torch.zeros_like(pa))
            else:
                He, We = rs.env.shape[0], rs.env.shape[1]
                pix = torch.searchsorted(self.env_cdf, u[sel, 1].contiguous(), side="right").clamp_max(
                    He * We - 1)
                y, x = pix // We, pix % We
                dirn, st = rs.env_dir(y, x)
                pe = rs.env_pmf[pix] * (He * We) / (2 * math.pi ** 2 * st.clamp_min(1e-5)) * ps
                d_out[sel] = dirn
                dist[sel] = 2.0 * diag
                rop[sel] = rs.env[y, x] / pe.clamp_min(1e-12)[:, None]
                pdf[sel] = pe
        return d_out, dist, rop, pdf, delta


def render(rs: RefScene, pixels, spp: int, gen, max_depth: int, rr_depth: int,
           chunk: int = 1 << 19):
    """Mean radiance (float64, (P, 3)) of each flat pixel id over spp
    samples."""
    dev, dt = rs.device, rs.dtype
    W = rs.desc.width
    lights = Lights(rs)
    acc = torch.zeros((pixels.numel(), 3), dtype=torch.float64, device=dev)
    lanes_all = pixels.repeat(spp)
    slot_all = torch.arange(pixels.numel(), device=dev).repeat(spp)
    for s in range(0, lanes_all.numel(), chunk):
        lanes = lanes_all[s:s + chunk]
        L = radiance(rs, lights, lanes, W, gen, max_depth, rr_depth)
        L = torch.where(torch.isfinite(L), L, torch.zeros_like(L))
        acc.index_add_(0, slot_all[s:s + chunk], L.to(torch.float64))
    return acc / spp


def radiance(rs, lights, pix, W, gen, max_depth, rr_depth):
    dev, dt = rs.device, rs.dtype
    B = pix.numel()
    j = torch.rand((B, 2), generator=gen, device=dev, dtype=torch.float64).to(dt)
    o, d = rs.camera_rays((pix % W).to(dt) + j[:, 0], (pix // W).to(dt) + j[:, 1])
    L = torch.zeros((B, 3), dtype=dt, device=dev)
    beta = torch.ones((B, 3), dtype=dt, device=dev)
    prev_pdf = torch.zeros(B, dtype=dt, device=dev)
    prev_delta = torch.ones(B, dtype=torch.bool, device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    inf = torch.full((B,), 1e30, dtype=dt, device=dev)
    for depth in range(max_depth):
        t, tri, u, v = rs.grid.intersect(o, d, torch.where(alive, inf, torch.zeros_like(inf)))
        hit = alive & (tri >= 0)
        miss = alive & (tri < 0)
        if rs.env is not None and bool(miss.any()):
            le = rs.eval_env(d)
            w = torch.where(prev_delta, torch.ones_like(prev_pdf),
                            power_heuristic(prev_pdf, lights.pdf_env(d)))
            L = L + torch.where(miss[:, None], beta * le * w[:, None], torch.zeros_like(L))
        p, ng, ns, uv, mat = rs.surface(o, d, t, tri, u, v)
        wi = -d
        # emission, one-sided along the geometric normal
        le = rs.emit[tri.clamp_min(0)]
        front = _dot(ng, wi) > 0
        w_hit = torch.where(prev_delta, torch.ones_like(prev_pdf),
                            power_heuristic(prev_pdf, lights.pdf_area(o, p, tri)))
        L = L + torch.where((hit & front)[:, None], beta * le * w_hit[:, None], torch.zeros_like(L))

        bsdf = Bsdf(rs, mat, uv, ns, wi)
        ld, ldist, rop, lpdf, ldelta = lights.sample(p, gen)
        f, fpdf = bsdf.eval(ld)
        w_nee = torch.where(ldelta, torch.ones_like(lpdf), power_heuristic(lpdf, fpdf))
        contrib = beta * f * rop * w_nee[:, None]
        do_sh = hit & ((fpdf + _dot(f, f)) > 0)
        so = offset_origin(p, ng, ld)
        _, occ, _, _ = rs.grid.intersect(so, ld, torch.where(do_sh, ldist * 0.999,
                                                             torch.zeros_like(ldist)), any_hit=True)
        L = L + torch.where((do_sh & (occ < 0))[:, None], contrib, torch.zeros_like(L))

        ub = torch.rand((B, 3), generator=gen, device=dev, dtype=torch.float64).to(dt)
        wo, weight, pdf = bsdf.sample(ub[:, 0], ub[:, 1])
        beta_next = beta * weight
        alive = hit & (weight.abs().amax(-1) > 0) & (depth + 1 < max_depth)
        if depth >= rr_depth:
            q = beta_next.amax(-1).clamp(0.05, 0.95)
            surv = ub[:, 2] < q
            beta_next = torch.where(surv[:, None], beta_next / q[:, None], beta_next)
            alive = alive & surv
        beta = torch.where(alive[:, None], beta_next, torch.zeros_like(beta_next))
        o = offset_origin(p, ng, wo)
        d = wo
        prev_pdf = pdf
        prev_delta = torch.zeros_like(prev_delta)
    return L
