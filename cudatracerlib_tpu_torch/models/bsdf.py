"""The BSDF system: sample / evaluate / pdf for the full Mitsuba-style set.

Port of ``cudatracerlib_tpu/models/bsdf.py``: all 16 types. The 13 simple
ones are diffuse, rough diffuse (Oren-Nayar), smooth dielectric (with the
RGB dispersion roulette, or the continuous Cauchy eta at the hero
wavelength in spectral transport), thin dielectric, rough dielectric,
conductor, rough conductor, plastic, rough plastic (its diffuse energy
weighted by the rough transmittance tables, core/rough_transmittance.py),
Phong, Ward, Hanrahan-Krueger and null; the nested ones are coating, rough
coating and blend, whose inner BSDFs are simple types. Beside them: the
alpha test, bump and parallax-occlusion mapping, and path regularization
(regularize_ctx). Material rows are gathered into a flat ``BsdfCtx``, with
their textures evaluated (ops/texture.py), and every lane evaluates the
closed forms of the active types (a static tuple), selecting per-lane
results with masks; a coating, rough coating or blend evaluates every
simple type again for its nested BSDFs, as the JAX package does.

Conventions (Mitsuba): directions in the local shading frame, +z = normal,
`wi` the fixed incident direction, `wo` the sampled/queried outgoing one,
both pointing away from the surface. `evaluate` returns f(wi,wo)*|cos_o|
for smooth lobes only; delta lobes (the conductor) only appear through
`sample`.

Param layout (MaterialTable.params): [0:3] reflectance [3] alpha [4] eta
[5] mf distribution [6] alpha_u [7] alpha_v [8:11] conductor eta [11:14]
conductor k [14] nonlinear [15] phong exponent [16] hg phase g [17]
thickness [18] blend weight [19:22] transmittance/diffuse [22] two-sided
flag [23] Cauchy dispersion B [24] parallax scale [25:28] bssrdf sigma_a
[28:31] bssrdf sigma_s [31] bssrdf g [32:37] the alpha test (mode,
threshold, key colour).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from ..core import frame as fr
from ..core import fresnel
from ..core import microfacet as mf
from ..core import records
from ..core import rough_transmittance as rt
from ..core import rng as rngmod
from ..core import vecmath as vm
from ..core import warp
from ..ops import texture as texmod
from ..scene import schema

Tensor = torch.Tensor
INV_PI = 1.0 / math.pi

ALL_TYPES = tuple(range(16))
PORTED_TYPES = ALL_TYPES
_DELTA_TYPES = (schema.BSDF_DIELECTRIC, schema.BSDF_THINDIELECTRIC,
                schema.BSDF_CONDUCTOR, schema.BSDF_NULL)
_NESTED_TYPES = (schema.BSDF_COATING, schema.BSDF_ROUGHCOATING,
                 schema.BSDF_BLEND)
# BSDFs that transmit (skip the two-sided flip)
_TRANSMISSIVE = (schema.BSDF_DIELECTRIC, schema.BSDF_THINDIELECTRIC,
                 schema.BSDF_ROUGHDIELECTRIC, schema.BSDF_HK, schema.BSDF_NULL)


class BsdfCtx(NamedTuple):
    """Per-lane material data with textures pre-evaluated."""
    mat_type: Tensor   # (B,) i32
    params: Tensor     # (B, N_MAT_PARAMS)
    c0: Tensor         # (B, 3) evaluated primary color (albedo / specular)
    c1: Tensor         # (B, 3) evaluated secondary color
    n_type: Tensor     # nested simple BSDF for coating / blend
    n_params: Tensor
    n_c0: Tensor
    n_c1: Tensor
    n2_type: Tensor
    n2_params: Tensor
    n2_c0: Tensor
    n2_c1: Tensor
    lam_um: Tensor = None

    def nested_ctx(self) -> "BsdfCtx":
        z = torch.full_like(self.n_type, schema.BSDF_DIFFUSE)
        return self._replace(mat_type=self.n_type, params=self.n_params,
                             c0=self.n_c0, c1=self.n_c1, n_type=z, n2_type=z)

    def nested2_ctx(self) -> "BsdfCtx":
        z = torch.full_like(self.n_type, schema.BSDF_DIFFUSE)
        return self._replace(mat_type=self.n2_type, params=self.n2_params,
                             c0=self.n2_c0, c1=self.n2_c1, n_type=z, n2_type=z)


class Lobe(NamedTuple):
    f: Tensor      # (B, 3) f * |cos_o| (smooth components only)
    pdf: Tensor    # (B,)


class SampleOut(NamedTuple):
    wo: Tensor
    weight: Tensor        # (B, 3) f*cos/pdf
    pdf: Tensor           # (B,) solid-angle pdf
    sampled_type: Tensor  # (B,) i32 flags
    eta: Tensor           # (B,) relative IOR along the sampled path


def _mat_fat_rows(mats: schema.MaterialTable) -> Tensor:
    """[type | params(N_MAT_PARAMS) | tex(4) | nested | nested2] per material,
    int32 columns bitcast into float32, so one gather fetches a lane's whole
    material record."""
    return torch.cat([
        mats.mat_type.view(torch.float32)[:, None], mats.params,
        mats.tex.view(torch.float32),
        mats.nested.view(torch.float32)[:, None],
        mats.nested2.view(torch.float32)[:, None]], dim=1)


def gather_ctx(scene: schema.SceneData, mat_id: Tensor, uv: Tensor,
               uv_footprint: Tensor | None = None,
               active_types=None, with_textures: bool | int = True,
               ewa: tuple | None = None,
               extra: Tensor | None = None) -> BsdfCtx:
    """Gather material rows and evaluate their textures for a lane batch.

    active_types (static) skips the nested-BSDF gathers when no coating,
    rough coating or blend is active: the nested fields then hold the
    lane's own row. with_textures is a per-slot bitmask (1 = reflectance
    slot, 2 = secondary-color slot; True = both, False/0 = none, see
    scene_texture_mask). uv_footprint (the ray-cone width in uv units),
    ewa = (major-axis uv direction, major length) and extra pass through to
    ops/texture.eval_texture."""
    mats = scene.materials
    n_mat = mats.mat_type.shape[0]
    fat = _mat_fat_rows(mats)
    P = schema.N_MAT_PARAMS
    tex_mask = 3 if with_textures is True else int(with_textures)
    e_dir, e_maj = ewa if ewa is not None else (None, None)

    def gather_one(rows):
        # clamp before the gather: an out-of-range index stops a CUDA device
        r = fat[rows.clamp(0, n_mat - 1).long()]
        t = r[:, 0].view(torch.int32)
        p = r[:, 1:1 + P]
        c0, c1 = p[:, 0:3], p[:, 19:22]
        if tex_mask:
            tex_ids = r[:, 1 + P:5 + P].view(torch.int32)
            if tex_mask & 1:
                c0 = texmod.eval_texture(scene.textures, tex_ids[:, 0], uv, c0,
                                         uv_footprint, e_dir, e_maj, extra=extra)
            if tex_mask & 2:
                c1 = texmod.eval_texture(scene.textures, tex_ids[:, 1], uv, c1,
                                         uv_footprint, e_dir, e_maj, extra=extra)
        return r, t, p, c0, c1

    r, t, p, c0, c1 = gather_one(mat_id)
    if active_types is not None and not any(at in _NESTED_TYPES for at in active_types):
        z = torch.full_like(t, schema.BSDF_DIFFUSE)
        return BsdfCtx(mat_type=t, params=p, c0=c0, c1=c1,
                       n_type=z, n_params=p, n_c0=c0, n_c1=c1,
                       n2_type=z, n2_params=p, n2_c0=c0, n2_c1=c1)
    nested = r[:, 5 + P].view(torch.int32)
    nested2 = r[:, 6 + P].view(torch.int32)
    _, nt, np_, nc0, nc1 = gather_one(nested)
    _, n2t, n2p, n2c0, n2c1 = gather_one(nested2)
    nt = torch.where(nested >= 0, nt, schema.BSDF_DIFFUSE)
    n2t = torch.where(nested2 >= 0, n2t, schema.BSDF_DIFFUSE)
    return BsdfCtx(mat_type=t, params=p, c0=c0, c1=c1,
                   n_type=nt, n_params=np_, n_c0=nc0, n_c1=nc1,
                   n2_type=n2t, n2_params=n2p, n2_c0=n2c0, n2_c1=n2c1)


def scene_has_textures(scene: schema.SceneData) -> bool:
    """Host-side static check: any material referencing a texture slot."""
    return bool((schema.host_meta(scene)["mat_tex"] >= 0).any())


def scene_texture_mask(scene: schema.SceneData) -> int:
    """Per-slot texture mask: bit 0 = some material textures its
    reflectance slot, bit 1 = its secondary-color slot."""
    mt = schema.host_meta(scene)["mat_tex"]
    return ((1 if bool((mt[:, 0] >= 0).any()) else 0)
            | (2 if bool((mt[:, 1] >= 0).any()) else 0))


def scene_has_alpha(scene: schema.SceneData) -> bool:
    meta = schema.host_meta(scene)
    modes = meta.get("mat_alpha_mode")
    return bool((meta["mat_tex"][:, 2] >= 0).any()
                or (modes is not None and (modes != 0).any()))


def scene_has_bump(scene: schema.SceneData) -> bool:
    return bool((schema.host_meta(scene)["mat_tex"][:, 3] >= 0).any())


def scene_has_bssrdf(scene: schema.SceneData) -> bool:
    b = schema.host_meta(scene).get("mat_bssrdf")
    if b is None:
        b = scene.materials.params[:, 25:31].sum(-1).cpu().numpy()
    return bool((b > 0).any())


def scene_has_parallax(scene: schema.SceneData) -> bool:
    meta = schema.host_meta(scene)
    pscale = meta.get("mat_parallax")
    if pscale is None:
        pscale = scene.materials.params[:, 24].cpu().numpy()
    return bool(((meta["mat_tex"][:, 3] >= 0) & (pscale > 0)).any())


def _mat_rows(scene: schema.SceneData, mat_id: Tensor):
    """(texture ids (B, 4), params (B, N_MAT_PARAMS)) of each lane's
    material (ids clamped into the table, as jnp.take clamps)."""
    mats = scene.materials
    mid = mat_id.clamp(0, mats.mat_type.shape[0] - 1).long()
    return mats.tex[mid], mats.params[mid]


def eval_alpha(scene: schema.SceneData, mat_id: Tensor, uv: Tensor) -> Tensor:
    """Survival probability in [0,1] of the alpha test (1 = solid).

    Mode 0 with an alpha-mask texture is the continuous opacity; the binary
    modes come out as 0/1:
      mode&3==1  luminance(sample) >= s survives
      mode&3==2  alpha channel    >= s survives
      mode&3==3  max|sample - c|  <= s survives
      mode&4     sample the reflectance texture (slot 0), not the alpha mask
    (the 'alpha channel' is channel 0 of the mask image)."""
    tex_ids, p = _mat_rows(scene, mat_id)
    mp = p[:, 32:37]
    mode = mp[:, 0].to(torch.int32)
    s_val = mp[:, 1]
    c_val = mp[:, 2:5]
    src = torch.where((mode & 4) != 0, tex_ids[:, 0], tex_ids[:, 2])
    ones = torch.ones((mat_id.shape[0], 3), dtype=torch.float32, device=uv.device)
    a = texmod.eval_texture(scene.textures, src, uv, ones)
    cont = a[:, 0].clamp(0.0, 1.0)          # mode 0: continuous opacity
    lum = a @ torch.tensor([0.212671, 0.715160, 0.072169], dtype=torch.float32,
                           device=uv.device)
    surv_lum = (lum >= s_val).to(torch.float32)
    surv_alp = (a[:, 0] >= s_val).to(torch.float32)
    surv_col = ((a - c_val).abs().amax(-1) <= s_val).to(torch.float32)
    m3 = mode & 3
    out = torch.where(m3 == schema.ALPHA_LUMINANCE, surv_lum,
                      torch.where(m3 == schema.ALPHA_ALPHA, surv_alp,
                                  torch.where(m3 == schema.ALPHA_COLOR, surv_col,
                                              cont)))
    return torch.where(mode == 0, cont, out)


def apply_bump(scene: schema.SceneData, si, scale: float = 1.0):
    """Perturb the shading frame with a height-map texture (finite-difference
    gradients)."""
    tex_ids, _ = _mat_rows(scene, si.mat_id)
    bump_id = tex_ids[:, 3]
    eps = 2e-3
    B, dev = si.mat_id.shape[0], si.uv.device
    zero3 = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    tex = scene.textures
    h0 = texmod.eval_texture(tex, bump_id, si.uv, zero3)[:, 0]
    hu = texmod.eval_texture(tex, bump_id, si.uv + torch.tensor(
        [eps, 0.0], dtype=torch.float32, device=dev), zero3)[:, 0]
    hv = texmod.eval_texture(tex, bump_id, si.uv + torch.tensor(
        [0.0, eps], dtype=torch.float32, device=dev), zero3)[:, 0]
    dhdu = (hu - h0) / eps * scale
    dhdv = (hv - h0) / eps * scale
    ns = vm.normalize(si.ns - si.frame_t * dhdu[:, None] - si.frame_s * dhdv[:, None])
    has = (bump_id >= 0)[:, None]
    ns = torch.where(has, ns, si.ns)
    t, s2 = vm.coordinate_system(ns)
    return si._replace(ns=ns, frame_t=torch.where(has, t, si.frame_t),
                       frame_s=torch.where(has, s2, si.frame_s))


def apply_parallax(scene: schema.SceneData, si, n_steps: int = 8,
                   n_refine: int = 4):
    """Parallax-occlusion mapping: march the height field along the
    tangent-space view ray to the offset uv the viewer sees. Materials opt
    in with a parallax scale in params[24]; the height is the bump texture
    (slot 3).

    With cone-step maps in the texel pool (scene/conemap.py; the host build
    makes one for every parallax height map) the march cone-steps: each
    iteration advances to the boundary of the conservative cone at the
    current texel, so it never overshoots the first intersection. A table
    without them (img_cone None, a hand-built table) takes the linear
    search with bisection."""
    tex_ids, p = _mat_rows(scene, si.mat_id)
    bump_id = tex_ids[:, 3]
    h_scale = p[:, 24]
    active = (bump_id >= 0) & (h_scale > 0)
    B, dev = si.mat_id.shape[0], si.uv.device
    zero3 = torch.zeros((B, 3), dtype=torch.float32, device=dev)

    v = si.frame().to_local(si.wi)              # toward the viewer
    vz = v[..., 2].clamp_min(0.2)
    # uv shift per unit depth: the view ray's slope in tangent space
    slope = torch.stack([v[..., 0], v[..., 1]], -1) / vz[..., None] * h_scale[..., None]
    tex = scene.textures

    def height(uv):
        return texmod.eval_texture(tex, bump_id, uv, zero3)[:, 0]

    if tex.img_cone is not None:
        # ---- cone-step march ----
        bid = bump_id.clamp(0, tex.image_id.shape[0] - 1).long()
        timg = tex.image_id[bid].clamp(0, tex.img_cone.shape[0] - 1).long()
        cone_off = tex.img_cone[timg]
        w0 = tex.img_w[timg, 0]
        h0 = tex.img_h[timg, 0]
        tp = tex.params[bid]
        n_texels = tex.texels.shape[0]

        def cone(uv):
            # the image fetch's uv mapping and v flip (ops/texture.py)
            u_ = uv[:, 0] * tp[:, 6] + tp[:, 8]
            v_ = uv[:, 1] * tp[:, 7] + tp[:, 9]
            xi = torch.remainder(torch.floor(torch.remainder(u_, 1.0)
                                             * w0.to(torch.float32))
                                 .to(torch.int32), w0)
            yi = torch.remainder(torch.floor(torch.remainder(
                1.0 - torch.remainder(v_, 1.0), 1.0) * h0.to(torch.float32))
                .to(torch.int32), h0)
            idx = cone_off.clamp_min(0) + yi * w0 + xi
            c = tex.texels[idx.clamp(0, n_texels - 1).long(), 0]
            # no cone map: a huge ratio degenerates to secant iteration
            return torch.where(cone_off >= 0, c, 1e3)

        # ray-slope magnitude in mapped uv units (cone ratios live there)
        smag = torch.sqrt((slope[:, 0] * tp[:, 6]) ** 2
                          + (slope[:, 1] * tp[:, 7]) ** 2) + 1e-9
        d = torch.zeros_like(vz)
        for _ in range(n_steps + n_refine):
            uv_k = si.uv - slope * d[..., None]
            dep = 1.0 - height(uv_k)
            c = cone(uv_k)
            # advance to where the ray leaves the conservative cone opened
            # at (uv_k, dep): |slope|*dd = c*(dep - (d+dd))
            step = c * (dep - d).clamp_min(0.0) / (smag + c)
            d = (d + step).clamp_max(1.0)
        uv_new = si.uv - slope * d[..., None]
        return si._replace(uv=torch.where(active[..., None], uv_new, si.uv))

    # ---- linear search from the surface down + bisection refinement ----
    d_lo = torch.zeros_like(vz)                 # last depth above the surface
    d_hi = torch.ones_like(vz)                  # first depth below
    found = torch.zeros_like(active)
    for k in range(1, n_steps + 1):
        d = torch.full_like(vz, k / n_steps)
        h = 1.0 - height(si.uv - slope * d[..., None])
        below = d >= h
        d_hi = torch.where(below & ~found, d, d_hi)
        d_lo = torch.where(~below & ~found, d, d_lo)
        found = found | below
    for _ in range(n_refine):
        dm = 0.5 * (d_lo + d_hi)
        h = 1.0 - height(si.uv - slope * dm[..., None])
        below = dm >= h
        d_hi = torch.where(below, dm, d_hi)
        d_lo = torch.where(below, d_lo, dm)
    d = 0.5 * (d_lo + d_hi)
    uv_new = si.uv - slope * d[..., None]
    return si._replace(uv=torch.where(active[..., None], uv_new, si.uv))


def _mirror(w: Tensor) -> Tensor:
    """Specular reflection about +z."""
    return torch.stack([-w[..., 0], -w[..., 1], w[..., 2]], dim=-1)


def _dist(params):
    return params[:, 5].to(torch.int32)


def _alphas(params):
    return params[:, 6].clamp_min(1e-4), params[:, 7].clamp_min(1e-4)


def _lum(c: Tensor) -> Tensor:
    return 0.212671 * c[..., 0] + 0.715160 * c[..., 1] + 0.072169 * c[..., 2]


def _diffuse_eval(ctx, wi, wo):
    up = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    f = ctx.c0 * (INV_PI * wo[..., 2].clamp_min(0.0))[..., None]
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    return Lobe(f=torch.where(up[..., None], f, 0.0),
                pdf=torch.where(up, pdf, 0.0))


def _diffuse_sample(ctx, wi, u):
    wo = warp.square_to_cosine_hemisphere(u[..., 1:3])
    lob = _diffuse_eval(ctx, wi, wo)
    w = torch.where(wi[..., 2, None] > 0, ctx.c0, 0.0)
    shape = wi.shape[:-1]
    return SampleOut(wo=wo, weight=w, pdf=lob.pdf,
                     sampled_type=torch.full(shape, records.T_DIFFUSE_REFLECTION,
                                             dtype=torch.int32, device=wi.device),
                     eta=torch.ones(shape, dtype=torch.float32, device=wi.device))


def _conductor_sample(ctx, wi, u):
    wo = _mirror(wi)
    F = fresnel.fresnel_conductor_exact(wi[..., 2].abs(),
                                        ctx.params[:, 8:11], ctx.params[:, 11:14])
    w = torch.where(wi[..., 2, None] > 0, ctx.c0 * F, 0.0)
    shape = wi.shape[:-1]
    return SampleOut(wo=wo, weight=w,
                     pdf=torch.ones(shape, dtype=torch.float32, device=wi.device),
                     sampled_type=torch.full(shape, records.T_DELTA_REFLECTION,
                                             dtype=torch.int32, device=wi.device),
                     eta=torch.ones(shape, dtype=torch.float32, device=wi.device))


_LAM2_RGB = (0.610 ** 2, 0.550 ** 2, 0.465 ** 2)   # um^2, the RGB channels


def _dielectric_sample(ctx, wi, u):
    # dispersion: params[23] > 0 is a Cauchy B coefficient (um^2). A channel
    # is chosen by roulette on u[..., 2] and the path continues
    # monochromatically (weight x3 on that channel); in spectral transport
    # (ctx.lam_um set) the lane refracts with the continuous eta at its hero
    # wavelength instead, and the integrator collapses the companion
    # wavelengths after the event
    disp_b = ctx.params[:, 23]
    eta_base = ctx.params[:, 4]
    dispersive = disp_b > 0.0
    if ctx.lam_um is not None:
        eta_h = eta_base + disp_b / (ctx.lam_um * ctx.lam_um).clamp_min(1e-6)
        eta = torch.where(dispersive, eta_h, eta_base)
    else:
        lam2 = torch.tensor(_LAM2_RGB, dtype=torch.float32, device=wi.device)
        eta_rgb = eta_base[:, None] + disp_b[:, None] / lam2[None, :]
        chan = (u[..., 2] * 3.0).to(torch.int32).clamp(0, 2)
        oh = torch.arange(3, device=wi.device)[None, :] == chan[:, None]
        eta_chan = torch.where(oh, eta_rgb, 0.0).sum(dim=1)
        eta = torch.where(dispersive, eta_chan, eta_base)
    F, cos_t = fresnel.fresnel_dielectric_ext(wi[..., 2], eta)
    reflect = u[..., 0] < F
    wo_r = _mirror(wi)
    n = torch.zeros_like(wi)
    n[..., 2] = 1.0
    wo_t = vm.refract(wi, n, eta, cos_t)
    wo = torch.where(reflect[..., None], wo_r, wo_t)
    # radiance scaling on refraction: (eta_i/eta_t)^2
    factor = torch.where(cos_t < 0, 1.0 / eta, eta)
    w_t = ctx.c1 * (factor * factor)[..., None]
    weight = torch.where(reflect[..., None], ctx.c0, w_t)
    if ctx.lam_um is None:
        # dispersive lanes are monochromatic either way (F depends on the
        # channel): isolate the sampled channel with x3 roulette compensation
        chan_mask = torch.where(oh, 3.0, 0.0)
        weight = torch.where(dispersive[..., None], weight * chan_mask, weight)
    stype = torch.where(reflect, records.T_DELTA_REFLECTION,
                        records.T_DELTA_TRANSMISSION)
    eta_out = torch.where(reflect, 1.0, torch.where(cos_t < 0, eta, 1.0 / eta))
    pdf = torch.where(reflect, F, 1.0 - F)
    return SampleOut(wo=wo, weight=weight, pdf=pdf.clamp_min(1e-12),
                     sampled_type=stype.to(torch.int32), eta=eta_out)


def _thindielectric_sample(ctx, wi, u):
    eta = ctx.params[:, 4]
    R = fresnel.fresnel_dielectric(wi[..., 2].abs(), eta)
    R = torch.where(R < 1.0, R * 2.0 / (1.0 + R), 1.0)  # double interface
    reflect = u[..., 0] < R
    wo = torch.where(reflect[..., None], _mirror(wi), -wi)
    weight = torch.where(reflect[..., None], ctx.c0, ctx.c1)
    stype = torch.where(reflect, records.T_DELTA_REFLECTION,
                        records.T_DELTA_TRANSMISSION)
    pdf = torch.where(reflect, R, 1.0 - R)
    return SampleOut(wo=wo, weight=weight, pdf=pdf.clamp_min(1e-12),
                     sampled_type=stype.to(torch.int32), eta=torch.ones_like(R))


def _roughconductor_eval(ctx, wi, wo):
    up = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    a_u, a_v = _alphas(ctx.params)
    dist = _dist(ctx.params)
    h = vm.normalize(wi + wo)
    D = mf.eval_d(dist, a_u, a_v, h)
    G = mf.smith_g(dist, a_u, a_v, wi, wo, h)
    F = fresnel.fresnel_conductor_exact(vm.dot(wi, h),
                                        ctx.params[:, 8:11], ctx.params[:, 11:14])
    ci = wi[..., 2].abs().clamp_min(1e-6)
    f = ctx.c0 * F * (D * G / (4.0 * ci))[..., None]  # f*cos_o (cos_o cancels)
    pdf = mf.pdf(dist, a_u, a_v, wi, h) / (4.0 * vm.dot(wo, h).abs()).clamp_min(1e-8)
    return Lobe(f=torch.where(up[..., None], f, 0.0), pdf=torch.where(up, pdf, 0.0))


def _roughconductor_sample(ctx, wi, u):
    a_u, a_v = _alphas(ctx.params)
    dist = _dist(ctx.params)
    m, _ = mf.sample(dist, a_u, a_v, wi, u[..., 1:3])
    wo = vm.reflect(wi, m)
    lob = _roughconductor_eval(ctx, wi, wo)
    w = lob.f / lob.pdf.clamp_min(1e-12)[..., None]
    valid = (lob.pdf > 0) & (wo[..., 2] > 0)
    shape = wi.shape[:-1]
    return SampleOut(wo=wo, weight=torch.where(valid[..., None], w, 0.0), pdf=lob.pdf,
                     sampled_type=torch.full(shape, records.T_GLOSSY_REFLECTION,
                                             dtype=torch.int32, device=wi.device),
                     eta=torch.ones(shape, dtype=torch.float32, device=wi.device))


def _ones(wi):
    return torch.ones(wi.shape[:-1], dtype=torch.float32, device=wi.device)


def _kind(wi, kind):
    return torch.full(wi.shape[:-1], kind, dtype=torch.int32, device=wi.device)


def _roughdiffuse_eval(ctx, wi, wo):
    """Oren-Nayar (the fast approximation, as the reference's roughdiffuse)."""
    up = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    sigma = ctx.params[:, 3] * 0.7853981  # alpha -> sigma (45 deg scaling, Mitsuba)
    s2 = sigma * sigma
    A = 1.0 - s2 / (2.0 * (s2 + 0.33))
    Bc = 0.45 * s2 / (s2 + 0.09)
    si, so = fr.sin_theta(wi), fr.sin_theta(wo)
    cos_dphi = torch.where((si > 1e-6) & (so > 1e-6),
                           (wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1])
                           / (si * so).clamp_min(1e-12), 0.0)
    max_cos = cos_dphi.clamp_min(0.0)
    ci, co = wi[..., 2].abs(), wo[..., 2].abs()
    sin_alpha = torch.where(ci > co, so, si)
    tan_beta = torch.where(ci > co, si / co.clamp_min(1e-6), so / ci.clamp_min(1e-6))
    f = ctx.c0 * (INV_PI * (A + Bc * max_cos * sin_alpha * tan_beta)
                  * wo[..., 2].clamp_min(0.0))[..., None]
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    return Lobe(f=torch.where(up[..., None], f, 0.0), pdf=torch.where(up, pdf, 0.0))


def _roughdiffuse_sample(ctx, wi, u):
    wo = warp.square_to_cosine_hemisphere(u[..., 1:3])
    lob = _roughdiffuse_eval(ctx, wi, wo)
    w = lob.f / lob.pdf.clamp_min(1e-12)[..., None]
    return SampleOut(wo=wo, weight=w, pdf=lob.pdf,
                     sampled_type=_kind(wi, records.T_DIFFUSE_REFLECTION),
                     eta=_ones(wi))


def _roughdielectric_eval(ctx, wi, wo):
    """Walter et al. 2007 rough dielectric, radiance transport."""
    eta = ctx.params[:, 4]
    a_u, a_v = _alphas(ctx.params)
    dist = _dist(ctx.params)
    ci = wi[..., 2]
    co = wo[..., 2]
    reflect = ci * co > 0
    eta_rel = torch.where(ci > 0, eta, 1.0 / eta)  # eta_t/eta_i for this crossing

    # half-vector: reflection h = wi+wo; transmission h = -(wi + eta_rel*wo)
    h_r = vm.normalize(wi + wo)
    h_t = vm.normalize(-(wi + wo * eta_rel[..., None]))
    h = torch.where(reflect[..., None], h_r, h_t)
    h = torch.where(h[..., 2:3] < 0, -h, h)  # micronormal in the upper hemisphere

    dot_wi_h = vm.dot(wi, h)
    dot_wo_h = vm.dot(wo, h)
    F, _ = fresnel.fresnel_dielectric_ext(dot_wi_h, eta)
    D = mf.eval_d(dist, a_u, a_v, h)
    G = mf.smith_g(dist, a_u, a_v, wi, wo, h)
    aci = ci.abs().clamp_min(1e-6)

    f_r = ctx.c0 * (F * D * G / (4.0 * aci))[..., None]

    sqrt_denom = dot_wi_h + eta_rel * dot_wo_h
    # f_t * cos_o, with the radiance factor (eta_i/eta_t)^2 folded in
    ft = ((dot_wi_h * dot_wo_h).abs() * (1.0 - F) * D * G
          / (sqrt_denom * sqrt_denom * aci).clamp_min(1e-10))
    f_t = ctx.c1 * ft[..., None]

    pdf_m = mf.pdf(dist, a_u, a_v, torch.where((ci < 0)[..., None], -wi, wi), h)
    jac_r = 1.0 / (4.0 * dot_wo_h.abs()).clamp_min(1e-8)
    jac_t = (eta_rel * eta_rel * dot_wo_h.abs()
             / (sqrt_denom * sqrt_denom).clamp_min(1e-10))
    pdf_r = pdf_m * F * jac_r
    pdf_t = pdf_m * (1.0 - F) * jac_t

    valid_r = reflect & (dot_wi_h * ci > 0) & (dot_wo_h * co > 0)
    valid_t = (~reflect) & (dot_wi_h * ci > 0) & (dot_wo_h * co > 0)
    f = torch.where(valid_r[..., None], f_r, torch.where(valid_t[..., None], f_t, 0.0))
    pdf = torch.where(valid_r, pdf_r, torch.where(valid_t, pdf_t, 0.0))
    return Lobe(f=f, pdf=pdf)


def _roughdielectric_sample(ctx, wi, u):
    eta = ctx.params[:, 4]
    a_u, a_v = _alphas(ctx.params)
    dist = _dist(ctx.params)
    wi_up = torch.where((wi[..., 2] < 0)[..., None], -wi, wi)
    m, _ = mf.sample(dist, a_u, a_v, wi_up, u[..., 1:3])  # m in the upper hemisphere
    dot_wi_m = vm.dot(wi, m)
    F, cos_t = fresnel.fresnel_dielectric_ext(dot_wi_m, eta)
    reflect = u[..., 0] < F
    wo_r = 2.0 * dot_wi_m[..., None] * m - wi
    wo_t = vm.refract(wi, m, eta, cos_t)
    wo = torch.where(reflect[..., None], wo_r, wo_t)
    lob = _roughdielectric_eval(ctx, wi, wo)
    w = lob.f / lob.pdf.clamp_min(1e-12)[..., None]
    valid = lob.pdf > 1e-12
    stype = torch.where(reflect, records.T_GLOSSY_REFLECTION, records.T_GLOSSY_TRANSMISSION)
    eta_out = torch.where(reflect, 1.0, torch.where(cos_t < 0, eta, 1.0 / eta))
    return SampleOut(wo=wo, weight=torch.where(valid[..., None], w, 0.0), pdf=lob.pdf,
                     sampled_type=stype.to(torch.int32), eta=eta_out)


def _plastic_internal(ctx):
    eta = ctx.params[:, 4]
    fdr = fresnel.fresnel_diffuse_reflectance(eta)
    nonlinear = ctx.params[:, 14] > 0.5
    diff = ctx.c1
    avg = _lum(diff)
    denom = torch.where(nonlinear[..., None], 1.0 - diff * fdr[..., None],
                        (1.0 - avg * fdr)[..., None])
    return diff / denom.clamp_min(1e-6), eta


def _plastic_eval(ctx, wi, wo):
    """Smooth plastic's diffuse component (the specular part is a delta)."""
    up = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    diff, eta = _plastic_internal(ctx)
    Fi = fresnel.fresnel_dielectric(wi[..., 2], eta)
    Fo = fresnel.fresnel_dielectric(wo[..., 2], eta)
    inv_eta2 = 1.0 / (eta * eta)
    f = diff * (INV_PI * wo[..., 2].clamp_min(0.0) * inv_eta2
                * (1.0 - Fi) * (1.0 - Fo))[..., None]
    # pdf: the diffuse lobe's share of the combined sampling strategy
    spec_w = _lum(ctx.c0) * Fi
    diff_w = _lum(ctx.c1) * (1.0 - Fi)
    p_spec = spec_w / (spec_w + diff_w).clamp_min(1e-12)
    pdf = (1.0 - p_spec) * warp.square_to_cosine_hemisphere_pdf(wo)
    return Lobe(f=torch.where(up[..., None], f, 0.0), pdf=torch.where(up, pdf, 0.0))


def _plastic_sample(ctx, wi, u):
    diff, eta = _plastic_internal(ctx)
    Fi = fresnel.fresnel_dielectric(wi[..., 2], eta)
    spec_w = _lum(ctx.c0) * Fi
    diff_w = _lum(ctx.c1) * (1.0 - Fi)
    p_spec = spec_w / (spec_w + diff_w).clamp_min(1e-12)
    choose_spec = u[..., 0] < p_spec
    wo_s = _mirror(wi)
    wo_d = warp.square_to_cosine_hemisphere(u[..., 1:3])
    wo = torch.where(choose_spec[..., None], wo_s, wo_d)
    w_spec = ctx.c0 * (Fi / p_spec.clamp_min(1e-12))[..., None]
    lob_d = _plastic_eval(ctx, wi, wo_d)
    w_diff = lob_d.f / lob_d.pdf.clamp_min(1e-12)[..., None]
    weight = torch.where(choose_spec[..., None], w_spec, w_diff)
    weight = torch.where((wi[..., 2] > 0)[..., None], weight, 0.0)
    pdf = torch.where(choose_spec, p_spec, lob_d.pdf)
    stype = torch.where(choose_spec, records.T_DELTA_REFLECTION, records.T_DIFFUSE_REFLECTION)
    return SampleOut(wo=wo, weight=weight, pdf=pdf.clamp_min(1e-12),
                     sampled_type=stype.to(torch.int32), eta=torch.ones_like(Fi))


def _rough_spec_albedo(ctx, cos):
    """Directional-hemispherical specular reflectance E_spec(cos, alpha) of
    the rough dielectric interface from the rough transmittance tables:
    both distributions' tables are evaluated, the lane's distribution id
    selects, and its IOR interpolates over the eta knots' tables."""
    a = ctx.params[:, 6].clamp_min(1e-4)
    eta = ctx.params[:, 4]
    e_bk, e_ggx = rt.eval_specular_albedo_dists((0, 1), eta, cos, a)
    return torch.where(_dist(ctx.params) == 1, e_ggx, e_bk)


def _roughplastic_eval(ctx, wi, wo):
    """Rough plastic: microfacet dielectric reflection plus internally
    scattered diffuse, the diffuse energy weighted by the rough
    transmittance (1 - E_spec(cos, alpha)) instead of the smooth Fresnel."""
    up = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    a_u, a_v = _alphas(ctx.params)
    dist = _dist(ctx.params)
    eta = ctx.params[:, 4]
    h = vm.normalize(wi + wo)
    D = mf.eval_d(dist, a_u, a_v, h)
    G = mf.smith_g(dist, a_u, a_v, wi, wo, h)
    F = fresnel.fresnel_dielectric(vm.dot(wi, h), eta)
    ci = wi[..., 2].abs().clamp_min(1e-6)
    f_spec = ctx.c0 * (F * D * G / (4.0 * ci))[..., None]

    diff, _ = _plastic_internal(ctx)
    Ei = _rough_spec_albedo(ctx, wi[..., 2])
    Eo = _rough_spec_albedo(ctx, wo[..., 2])
    inv_eta2 = 1.0 / (eta * eta)
    f_diff = diff * (INV_PI * wo[..., 2].clamp_min(0.0) * inv_eta2
                     * (1.0 - Ei) * (1.0 - Eo))[..., None]

    p_spec = _rp_spec_prob(ctx, wi)
    pdf_spec = mf.pdf(dist, a_u, a_v, wi, h) / (4.0 * vm.dot(wo, h).abs()).clamp_min(1e-8)
    pdf = p_spec * pdf_spec + (1.0 - p_spec) * warp.square_to_cosine_hemisphere_pdf(wo)
    return Lobe(f=torch.where(up[..., None], f_spec + f_diff, 0.0),
                pdf=torch.where(up, pdf, 0.0))


def _rp_spec_prob(ctx, wi):
    eta = ctx.params[:, 4]
    Fi = fresnel.fresnel_dielectric(wi[..., 2], eta)
    spec_w = _lum(ctx.c0) * Fi
    diff_w = _lum(ctx.c1) * (1.0 - Fi)
    return (spec_w / (spec_w + diff_w).clamp_min(1e-12)).clamp(0.05, 0.95)


def _roughplastic_sample(ctx, wi, u):
    a_u, a_v = _alphas(ctx.params)
    dist = _dist(ctx.params)
    p_spec = _rp_spec_prob(ctx, wi)
    choose_spec = u[..., 0] < p_spec
    m, _ = mf.sample(dist, a_u, a_v, wi, u[..., 1:3])
    wo_s = vm.reflect(wi, m)
    wo_d = warp.square_to_cosine_hemisphere(u[..., 1:3])
    wo = torch.where(choose_spec[..., None], wo_s, wo_d)
    lob = _roughplastic_eval(ctx, wi, wo)
    w = lob.f / lob.pdf.clamp_min(1e-12)[..., None]
    valid = (lob.pdf > 1e-12) & (wo[..., 2] > 0) & (wi[..., 2] > 0)
    stype = torch.where(choose_spec, records.T_GLOSSY_REFLECTION,
                        records.T_DIFFUSE_REFLECTION)
    return SampleOut(wo=wo, weight=torch.where(valid[..., None], w, 0.0), pdf=lob.pdf,
                     sampled_type=stype.to(torch.int32), eta=_ones(wi))


def _phong_eval(ctx, wi, wo):
    up = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    e = ctx.params[:, 15].clamp_min(1.0)
    refl = _mirror(wi)
    cos_a = vm.dot(refl, wo).clamp_min(0.0)
    f_spec = ctx.c0 * ((e + 2.0) * (0.5 * INV_PI) * torch.pow(cos_a, e)
                       * wo[..., 2].clamp_min(0.0))[..., None]
    f_diff = ctx.c1 * (INV_PI * wo[..., 2].clamp_min(0.0))[..., None]
    p_spec = _phong_spec_prob(ctx)
    pdf_spec = (e + 1.0) * (0.5 * INV_PI) * torch.pow(cos_a, e)
    pdf = p_spec * pdf_spec + (1 - p_spec) * warp.square_to_cosine_hemisphere_pdf(wo)
    return Lobe(f=torch.where(up[..., None], f_spec + f_diff, 0.0),
                pdf=torch.where(up, pdf, 0.0))


def _phong_spec_prob(ctx):
    sw, dw = _lum(ctx.c0), _lum(ctx.c1)
    return (sw / (sw + dw).clamp_min(1e-12)).clamp(0.05, 0.95)


def _phong_sample(ctx, wi, u):
    e = ctx.params[:, 15].clamp_min(1.0)
    p_spec = _phong_spec_prob(ctx)
    choose_spec = u[..., 0] < p_spec
    # sample the cos^e lobe around the mirror direction
    cos_a = torch.pow(u[..., 1].clamp_min(1e-9), 1.0 / (e + 1.0))
    sin_a = (1.0 - cos_a * cos_a).clamp_min(0.0).sqrt()
    phi = 2.0 * math.pi * u[..., 2]
    local = torch.stack([sin_a * torch.cos(phi), sin_a * torch.sin(phi), cos_a], dim=-1)
    wo_s = fr.Frame.from_normal(_mirror(wi)).to_world(local)
    wo_d = warp.square_to_cosine_hemisphere(u[..., 1:3])
    wo = torch.where(choose_spec[..., None], wo_s, wo_d)
    lob = _phong_eval(ctx, wi, wo)
    w = lob.f / lob.pdf.clamp_min(1e-12)[..., None]
    valid = (lob.pdf > 1e-12) & (wo[..., 2] > 0) & (wi[..., 2] > 0)
    stype = torch.where(choose_spec, records.T_GLOSSY_REFLECTION,
                        records.T_DIFFUSE_REFLECTION)
    return SampleOut(wo=wo, weight=torch.where(valid[..., None], w, 0.0), pdf=lob.pdf,
                     sampled_type=stype.to(torch.int32), eta=_ones(wi))


def _ward_eval(ctx, wi, wo):
    """Balanced Ward-Duer (no Fresnel, as the reference's ward)."""
    up = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    a_u, a_v = _alphas(ctx.params)
    h = wi + wo
    ci = wi[..., 2].clamp_min(1e-6)
    co = wo[..., 2].clamp_min(1e-6)
    hz2 = (h[..., 2] * h[..., 2]).clamp_min(1e-12)
    expo = torch.exp(-(h[..., 0] ** 2 / (a_u * a_u) + h[..., 1] ** 2 / (a_v * a_v)) / hz2)
    f_spec = ctx.c0 * (expo / (4.0 * math.pi * a_u * a_v * torch.sqrt(ci * co))
                       * co)[..., None]
    f_diff = ctx.c1 * (INV_PI * co)[..., None]
    p_spec = _phong_spec_prob(ctx)
    # the pdf of the Ward half-vector sampling mapped to wo
    hn = vm.normalize(h)
    d_pdf = (torch.exp(-fr.tan_theta2(hn) * ((fr.cos_phi(hn) / a_u) ** 2
                                             + (fr.sin_phi(hn) / a_v) ** 2))
             / (math.pi * a_u * a_v * (hn[..., 2] ** 3).clamp_min(1e-9)))
    pdf_spec = d_pdf / (4.0 * vm.dot(wo, hn).abs()).clamp_min(1e-8)
    pdf = p_spec * pdf_spec + (1 - p_spec) * warp.square_to_cosine_hemisphere_pdf(wo)
    return Lobe(f=torch.where(up[..., None], f_spec + f_diff, 0.0),
                pdf=torch.where(up, pdf, 0.0))


def _ward_sample(ctx, wi, u):
    a_u, a_v = _alphas(ctx.params)
    p_spec = _phong_spec_prob(ctx)
    choose_spec = u[..., 0] < p_spec
    # sample the anisotropic Ward half-vector (gaussian in slope space)
    phi = torch.atan2(a_v * torch.sin(2 * math.pi * u[..., 2]),
                      a_u * torch.cos(2 * math.pi * u[..., 2]))
    cp, sp = torch.cos(phi), torch.sin(phi)
    t2 = -torch.log(u[..., 1].clamp_min(1e-9)) / ((cp / a_u) ** 2 + (sp / a_v) ** 2)
    ct = 1.0 / torch.sqrt(1.0 + t2)
    st = (1 - ct * ct).clamp_min(0.0).sqrt()
    h = torch.stack([st * cp, st * sp, ct], dim=-1)
    wo_s = vm.reflect(wi, h)
    wo_d = warp.square_to_cosine_hemisphere(u[..., 1:3])
    wo = torch.where(choose_spec[..., None], wo_s, wo_d)
    lob = _ward_eval(ctx, wi, wo)
    w = lob.f / lob.pdf.clamp_min(1e-12)[..., None]
    valid = (lob.pdf > 1e-12) & (wo[..., 2] > 0) & (wi[..., 2] > 0)
    return SampleOut(wo=wo, weight=torch.where(valid[..., None], w, 0.0), pdf=lob.pdf,
                     sampled_type=_kind(wi, records.T_GLOSSY_REFLECTION), eta=_ones(wi))


def _hg_phase(cos_theta, g):
    g2 = g * g
    denom = (1.0 + g2 - 2.0 * g * cos_theta).clamp_min(1e-6)
    return (0.25 * INV_PI) * (1.0 - g2) / (denom * torch.sqrt(denom))


def _hk_eval(ctx, wi, wo):
    """Hanrahan-Krueger single scattering in a thin slab: reflection and
    glossy transmission lobes, with the HG phase as the scattering pdf."""
    same = (wi[..., 2] > 0) == (wo[..., 2] > 0)
    sig_s = _lum(ctx.c0)
    sig_t = sig_s + _lum(ctx.c1)
    albedo = torch.where(sig_t > 0, sig_s / sig_t.clamp_min(1e-9), 0.0)
    tau = sig_t * ctx.params[:, 17]
    g = ctx.params[:, 16]
    ci = wi[..., 2].abs().clamp_min(1e-6)
    co = wo[..., 2].abs().clamp_min(1e-6)
    p = _hg_phase(-vm.dot(wi, wo), g)
    tint = ctx.c0 / sig_s.clamp_min(1e-9)[..., None]
    # single-scatter reflection from a slab of optical depth tau
    fr_ss = albedo * p * ci / (ci + co) * (1.0 - torch.exp(-tau * (1.0 / ci + 1.0 / co)))
    # single-scatter transmission through the slab: the classic
    # (e^{-tau/ci} - e^{-tau/co}) / (ci - co) form with its ci == co limit
    dc = ci - co
    near = dc.abs() < 1e-4
    ft_gen = (torch.exp(-tau / ci) - torch.exp(-tau / co)) / torch.where(near, 1.0, dc)
    ft_lim = (tau / (ci * ci)) * torch.exp(-tau / ci)
    ft_ss = albedo * p * ci * torch.where(near, ft_lim, ft_gen)
    f_refl = fr_ss * co / ci
    f_trans = ft_ss * co / ci
    f = tint * torch.where(same, f_refl, f_trans)[..., None]
    # pdf: the HG phase about the propagation direction times the
    # probability that _hk_sample picks the scatter branch over the delta
    # pass-through, so MIS weights built from evaluate() match the sampler
    trans = torch.exp(-tau / ci)
    pdf = (1.0 - trans) * _hg_phase(-vm.dot(wi, wo), g)
    return Lobe(f=f.clamp_min(0.0), pdf=pdf.clamp_min(0.0))


def _hk_sample(ctx, wi, u):
    """Sample the delta pass-through or an HG-distributed scatter direction."""
    sig_s = _lum(ctx.c0)
    sig_t = sig_s + _lum(ctx.c1)
    tau = sig_t * ctx.params[:, 17]
    g = ctx.params[:, 16]
    ci = wi[..., 2].abs().clamp_min(1e-6)
    trans = torch.exp(-tau / ci)  # unscattered straight-through transmission
    choose_trans = u[..., 0] < trans
    wo_t = -wi
    # HG inversion about the propagation direction -wi
    g_safe = torch.where(g.abs() < 1e-3, 1e-3, g)
    sqr = (1.0 - g_safe * g_safe) / (1.0 - g_safe + 2.0 * g_safe * u[..., 1])
    cos_hg = (1.0 + g_safe * g_safe - sqr * sqr) / (2.0 * g_safe)
    cos_t = torch.where(g.abs() < 1e-3, 1.0 - 2.0 * u[..., 1], cos_hg).clamp(-1.0, 1.0)
    sin_t = (1.0 - cos_t * cos_t).clamp_min(0.0).sqrt()
    phi = 2.0 * math.pi * u[..., 2]
    wo_s = fr.Frame.from_normal(-wi).to_world(
        torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], -1))
    wo = torch.where(choose_trans[..., None], wo_t, wo_s)
    lob = _hk_eval(ctx, wi, wo_s)
    # lob.pdf already includes the (1 - trans) scatter-branch probability
    w_r = lob.f / lob.pdf[..., None].clamp_min(1e-12)
    weight = torch.where(choose_trans[..., None], torch.ones_like(ctx.c0), w_r)
    pdf = torch.where(choose_trans, trans, lob.pdf)
    same_side = (wi[..., 2] > 0) == (wo[..., 2] > 0)
    stype = torch.where(choose_trans, records.T_DELTA_TRANSMISSION,
                        torch.where(same_side, records.T_GLOSSY_REFLECTION,
                                    records.T_GLOSSY_TRANSMISSION))
    return SampleOut(wo=wo, weight=weight, pdf=pdf.clamp_min(1e-12),
                     sampled_type=stype.to(torch.int32), eta=_ones(wi))


def _null_sample(ctx, wi, u):
    return SampleOut(wo=-wi, weight=torch.ones_like(ctx.c0), pdf=_ones(wi),
                     sampled_type=_kind(wi, records.T_NULL), eta=_ones(wi))


# ---------------------------------------------------------------------------
# coating / blend (nested)
# ---------------------------------------------------------------------------

def _refract_z(w, eta, cos_t):
    """w refracted through the smooth interface whose normal is +z."""
    n = torch.zeros_like(w)
    n[..., 2] = 1.0
    return vm.refract(w, n, eta, cos_t)


def _coating_refract_into(wi, eta):
    """Refract wi into the coating layer (smooth interface, normal +z)."""
    F, cos_t = fresnel.fresnel_dielectric_ext(wi[..., 2], eta)
    return F, -_refract_z(wi, eta, cos_t)  # the direction inside, pointing away


def _coating_absorption(ctx, cos_in, cos_out):
    sig_a = ctx.c1  # the coating's sigma_a lives in the secondary color slot
    d = ctx.params[:, 17]
    tau = sig_a * d[..., None]
    return torch.exp(-tau * (1.0 / cos_in.abs().clamp_min(1e-6)
                             + 1.0 / cos_out.abs().clamp_min(1e-6))[..., None])


def _coating_eval(ctx, wi, wo, nested_eval):
    eta = ctx.params[:, 4]
    Fi, wi_in = _coating_refract_into(wi, eta)
    Fo, wo_in = _coating_refract_into(wo, eta)
    lob_n = nested_eval(ctx.nested_ctx(), wi_in, wo_in)
    absorb = _coating_absorption(ctx, wi_in[..., 2], wo_in[..., 2])
    # eta^2 compression of the nested cosine measure (Mitsuba coating)
    co_ratio = wo[..., 2].clamp_min(1e-6) / wo_in[..., 2].clamp_min(1e-6)
    f = lob_n.f * absorb * ((1.0 - Fi) * (1.0 - Fo) * co_ratio / (eta * eta))[..., None]
    p_spec = Fi.clamp(0.05, 0.95)
    # the density of wo under nested sampling of wo_in followed by refraction
    # out: dw_in/dw_out = cos_out / (eta^2 cos_in)  (sin_out = eta sin_in)
    pdf_n = lob_n.pdf * (wo[..., 2].clamp_min(1e-6)
                         / wo_in[..., 2].clamp_min(1e-6)) / (eta * eta)
    pdf = (1.0 - p_spec) * pdf_n
    up = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return Lobe(f=torch.where(up[..., None], f, 0.0), pdf=torch.where(up, pdf, 0.0))


def _coating_sample(ctx, wi, u, nested_sample, nested_eval):
    eta = ctx.params[:, 4]
    Fi, wi_in = _coating_refract_into(wi, eta)
    p_spec = Fi.clamp(0.05, 0.95)
    choose_spec = u[..., 0] < p_spec
    wo_spec = _mirror(wi)
    w_spec = ctx.c0 * (Fi / p_spec.clamp_min(1e-9))[..., None]
    # the nested sample, with the lobe-choice uniform remapped
    u_n = torch.stack([(u[..., 0] - p_spec) / (1 - p_spec).clamp_min(1e-9),
                       u[..., 1], u[..., 2]], dim=-1)
    s_n = nested_sample(ctx.nested_ctx(), wi_in, u_n)
    # refract the nested wo out of the layer
    F_out, cos_t = fresnel.fresnel_dielectric_ext(s_n.wo[..., 2], 1.0 / eta)
    wo_out = -_refract_z(s_n.wo, 1.0 / eta, cos_t)
    tir = F_out >= 1.0
    lob = _coating_eval(ctx, wi, wo_out, nested_eval)
    w_n = lob.f / lob.pdf.clamp_min(1e-12)[..., None]
    w_n = torch.where(tir[..., None], 0.0, w_n)
    wo = torch.where(choose_spec[..., None], wo_spec, wo_out)
    weight = torch.where(choose_spec[..., None], w_spec, w_n)
    pdf = torch.where(choose_spec, p_spec, lob.pdf)
    stype = torch.where(choose_spec, records.T_DELTA_REFLECTION, records.T_GLOSSY_REFLECTION)
    return SampleOut(wo=wo, weight=weight, pdf=pdf.clamp_min(1e-12),
                     sampled_type=stype.to(torch.int32), eta=torch.ones_like(Fi))


def _roughcoating_eval(ctx, wi, wo, nested_eval):
    """Rough coating (Mitsuba roughcoating): microfacet dielectric
    reflection at the coat plus the nested BSDF seen through the rough
    interface, the energy split taken from the rough transmittance tables
    E_spec(cos, alpha, eta)."""
    eta = ctx.params[:, 4]
    a = ctx.params[:, 6].clamp_min(1e-4)
    dist = _dist(ctx.params)
    up = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    ci = wi[..., 2].abs().clamp_min(1e-6)
    h = vm.normalize(wi + wo)
    D = mf.eval_d(dist, a, a, h)
    G = mf.smith_g(dist, a, a, wi, wo, h)
    F = fresnel.fresnel_dielectric(vm.dot(wi, h), eta)
    f_spec = ctx.c0 * (F * D * G / (4.0 * ci))[..., None]

    Fi, wi_in = _coating_refract_into(wi, eta)
    Fo, wo_in = _coating_refract_into(wo, eta)
    lob_n = nested_eval(ctx.nested_ctx(), wi_in, wo_in)
    absorb = _coating_absorption(ctx, wi_in[..., 2], wo_in[..., 2])
    # the directional rough transmittance replaces the smooth (1-F) factors
    Ei = _rough_spec_albedo(ctx, wi[..., 2])
    Ti = 1.0 - Ei
    To = 1.0 - _rough_spec_albedo(ctx, wo[..., 2])
    co_ratio = wo[..., 2].clamp_min(1e-6) / wo_in[..., 2].clamp_min(1e-6)
    f_nested = lob_n.f * absorb * (Ti * To * co_ratio / (eta * eta))[..., None]

    p_spec = Ei.clamp(0.05, 0.95)
    pdf_spec = mf.pdf(dist, a, a, wi, h) / (4.0 * vm.dot(wo, h).abs()).clamp_min(1e-8)
    # refraction measure: dw_in/dw_out = cos_out / (eta^2 cos_in)
    pdf_n = lob_n.pdf * (wo[..., 2].clamp_min(1e-6)
                         / wo_in[..., 2].clamp_min(1e-6)) / (eta * eta)
    pdf = p_spec * pdf_spec + (1.0 - p_spec) * pdf_n
    return Lobe(f=torch.where(up[..., None], f_spec + f_nested, 0.0),
                pdf=torch.where(up, pdf, 0.0))


def _roughcoating_sample(ctx, wi, u, nested_sample, nested_eval):
    eta = ctx.params[:, 4]
    a = ctx.params[:, 6].clamp_min(1e-4)
    dist = _dist(ctx.params)
    p_spec = _rough_spec_albedo(ctx, wi[..., 2]).clamp(0.05, 0.95)
    choose_spec = u[..., 0] < p_spec
    m, _ = mf.sample(dist, a, a, wi, u[..., 1:3])
    wo_spec = vm.reflect(wi, m)
    # the nested branch: sample inside the layer, refract out
    _, wi_in = _coating_refract_into(wi, eta)
    u_n = torch.stack([(u[..., 0] - p_spec) / (1 - p_spec).clamp_min(1e-9),
                       u[..., 1], u[..., 2]], dim=-1)
    s_n = nested_sample(ctx.nested_ctx(), wi_in, u_n)
    F_out, cos_t = fresnel.fresnel_dielectric_ext(s_n.wo[..., 2], 1.0 / eta)
    wo_out = -_refract_z(s_n.wo, 1.0 / eta, cos_t)
    tir = F_out >= 1.0
    wo = torch.where(choose_spec[..., None], wo_spec, wo_out)
    # both lobes are smooth: weight = f/pdf of the combined evaluation
    lob = _roughcoating_eval(ctx, wi, wo, nested_eval)
    w = lob.f / lob.pdf.clamp_min(1e-12)[..., None]
    valid = ((lob.pdf > 1e-12) & (wo[..., 2] > 0) & (wi[..., 2] > 0)
             & ~(tir & ~choose_spec))
    return SampleOut(wo=wo, weight=torch.where(valid[..., None], w, 0.0),
                     pdf=lob.pdf.clamp_min(1e-12),
                     sampled_type=_kind(wi, records.T_GLOSSY_REFLECTION), eta=_ones(wi))


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

# the delta types (conductor, the two smooth dielectrics, null) have a
# sampler and no evaluation (their evaluate is the zero lobe)
_EVAL_FNS = {
    schema.BSDF_DIFFUSE: _diffuse_eval,
    schema.BSDF_ROUGHDIFFUSE: _roughdiffuse_eval,
    schema.BSDF_ROUGHDIELECTRIC: _roughdielectric_eval,
    schema.BSDF_ROUGHCONDUCTOR: _roughconductor_eval,
    schema.BSDF_PLASTIC: _plastic_eval,
    schema.BSDF_ROUGHPLASTIC: _roughplastic_eval,
    schema.BSDF_PHONG: _phong_eval,
    schema.BSDF_WARD: _ward_eval,
    schema.BSDF_HK: _hk_eval,
}

_SAMPLE_FNS = {
    schema.BSDF_DIFFUSE: _diffuse_sample,
    schema.BSDF_ROUGHDIFFUSE: _roughdiffuse_sample,
    schema.BSDF_DIELECTRIC: _dielectric_sample,
    schema.BSDF_THINDIELECTRIC: _thindielectric_sample,
    schema.BSDF_ROUGHDIELECTRIC: _roughdielectric_sample,
    schema.BSDF_CONDUCTOR: _conductor_sample,
    schema.BSDF_ROUGHCONDUCTOR: _roughconductor_sample,
    schema.BSDF_PLASTIC: _plastic_sample,
    schema.BSDF_ROUGHPLASTIC: _roughplastic_sample,
    schema.BSDF_PHONG: _phong_sample,
    schema.BSDF_WARD: _ward_sample,
    schema.BSDF_HK: _hk_sample,
    schema.BSDF_NULL: _null_sample,
}


def _apply_two_sided(ctx: BsdfCtx, wi: Tensor):
    """Mirror the frame for two-sided opaque materials hit from behind."""
    transmissive = torch.zeros(ctx.mat_type.shape, dtype=torch.bool,
                               device=wi.device)
    for t in _TRANSMISSIVE:
        transmissive |= ctx.mat_type == t
    two_sided = (ctx.params[:, 22] > 0.5) & ~transmissive
    flip = two_sided & (wi[..., 2] < 0)
    wi = torch.where(flip[..., None], torch.cat([wi[..., :2], -wi[..., 2:]], -1), wi)
    return wi, flip


def _flip_back(flip, wo):
    return torch.where(flip[..., None], torch.cat([wo[..., :2], -wo[..., 2:]], -1), wo)


def _blend_lobes(ctx, wi, wo):
    w = ctx.params[:, 18].clamp(0.0, 1.0)
    l1 = _eval_simple_nested(ctx.nested_ctx(), wi, wo)
    l2 = _eval_simple_nested(ctx.nested2_ctx(), wi, wo)
    return Lobe(f=(1 - w)[..., None] * l1.f + w[..., None] * l2.f,
                pdf=(1 - w) * l1.pdf + w * l2.pdf)


def evaluate(ctx: BsdfCtx, wi: Tensor, wo: Tensor,
             active_types: Sequence[int] = ALL_TYPES) -> Lobe:
    """f(wi,wo)*|cos_o| + pdf for smooth lobes, masked over active types."""
    wi, flip = _apply_two_sided(ctx, wi)
    wo = _flip_back(flip, wo)  # mirror wo consistently with wi
    B = wi.shape[0]
    f = torch.zeros((B, 3), dtype=torch.float32, device=wi.device)
    pdf = torch.zeros(B, dtype=torch.float32, device=wi.device)
    for t in active_types:
        if t == schema.BSDF_COATING:
            lob = _coating_eval(ctx, wi, wo, _eval_simple_nested)
        elif t == schema.BSDF_ROUGHCOATING:
            lob = _roughcoating_eval(ctx, wi, wo, _eval_simple_nested)
        elif t == schema.BSDF_BLEND:
            lob = _blend_lobes(ctx, wi, wo)
        elif t in _EVAL_FNS:
            lob = _EVAL_FNS[t](ctx, wi, wo)
        else:
            continue
        m = ctx.mat_type == t
        f = torch.where(m[..., None], lob.f, f)
        pdf = torch.where(m, lob.pdf, pdf)
    return Lobe(f=f, pdf=pdf)


def _empty_sample(wi: Tensor) -> SampleOut:
    B, dev = wi.shape[0], wi.device
    return SampleOut(wo=torch.zeros((B, 3), dtype=torch.float32, device=dev),
                     weight=torch.zeros((B, 3), dtype=torch.float32, device=dev),
                     pdf=torch.zeros(B, dtype=torch.float32, device=dev),
                     sampled_type=torch.zeros(B, dtype=torch.int32, device=dev),
                     eta=torch.ones(B, dtype=torch.float32, device=dev))


def _select(m: Tensor, s: SampleOut, out: SampleOut) -> SampleOut:
    """s on the lanes of m, out elsewhere."""
    return SampleOut(*(torch.where(m[..., None] if a.dim() == 2 else m, a, b)
                       for a, b in zip(s, out)))


def _eval_simple_nested(ctx: BsdfCtx, wi: Tensor, wo: Tensor) -> Lobe:
    """evaluate over the simple types only (the BSDFs nested inside a
    coating or a blend)."""
    B = wi.shape[0]
    f = torch.zeros((B, 3), dtype=torch.float32, device=wi.device)
    pdf = torch.zeros(B, dtype=torch.float32, device=wi.device)
    for t, fn in _EVAL_FNS.items():
        lob = fn(ctx, wi, wo)
        m = ctx.mat_type == t
        f = torch.where(m[..., None], lob.f, f)
        pdf = torch.where(m, lob.pdf, pdf)
    return Lobe(f=f, pdf=pdf)


def _sample_simple_nested(ctx: BsdfCtx, wi: Tensor, u: Tensor) -> SampleOut:
    out = _empty_sample(wi)
    for t, fn in _SAMPLE_FNS.items():
        out = _select(ctx.mat_type == t, fn(ctx, wi, u), out)
    return out


def pdf(ctx: BsdfCtx, wi: Tensor, wo: Tensor,
        active_types: Sequence[int] = ALL_TYPES) -> Tensor:
    return evaluate(ctx, wi, wo, active_types).pdf


def _blend_sample(ctx, wi, u, flip):
    """Pick one of the blend's two BSDFs by its weight and sample it; a
    smooth sample's weight and pdf are then those of the whole blend,
    evaluated on the directions flipped back (evaluate applies the
    two-sided flip itself)."""
    w = ctx.params[:, 18].clamp(0.0, 1.0)
    pick2 = u[..., 0] < w
    u_r = torch.stack([torch.where(pick2, u[..., 0] / w.clamp_min(1e-9),
                                   (u[..., 0] - w) / (1 - w).clamp_min(1e-9)),
                       u[..., 1], u[..., 2]], -1)
    s1 = _sample_simple_nested(ctx.nested_ctx(), wi, u_r)
    s2 = _sample_simple_nested(ctx.nested2_ctx(), wi, u_r)
    s_sel = _select(pick2, s2, s1)
    lob = evaluate(ctx, _flip_back(flip, wi), _flip_back(flip, s_sel.wo),
                   active_types=(schema.BSDF_BLEND,))
    is_delta = (s_sel.sampled_type & records.T_DELTA) != 0
    w_smooth = lob.f / lob.pdf.clamp_min(1e-12)[..., None]
    pdf_sel = torch.where(pick2, w, 1 - w) * s_sel.pdf
    # a delta sample's weight already includes its lobe's pdf
    return SampleOut(wo=s_sel.wo,
                     weight=torch.where(is_delta[..., None], s_sel.weight, w_smooth),
                     pdf=torch.where(is_delta, pdf_sel, lob.pdf),
                     sampled_type=s_sel.sampled_type, eta=s_sel.eta)


def sample(ctx: BsdfCtx, wi: Tensor, u: Tensor,
           active_types: Sequence[int] = ALL_TYPES) -> SampleOut:
    """Sample the BSDF. u: (B, 3) uniforms (lobe choice + 2D)."""
    wi, flip = _apply_two_sided(ctx, wi)
    out = _empty_sample(wi)
    for t in active_types:
        if t == schema.BSDF_COATING:
            s = _coating_sample(ctx, wi, u, _sample_simple_nested, _eval_simple_nested)
        elif t == schema.BSDF_ROUGHCOATING:
            s = _roughcoating_sample(ctx, wi, u, _sample_simple_nested,
                                     _eval_simple_nested)
        elif t == schema.BSDF_BLEND:
            s = _blend_sample(ctx, wi, u, flip)
        elif t in _SAMPLE_FNS:
            s = _SAMPLE_FNS[t](ctx, wi, u)
        else:
            continue
        out = _select(ctx.mat_type == t, s, out)
    return out._replace(wo=_flip_back(flip, out.wo))


def sample_with_rng(ctx: BsdfCtx, wi: Tensor, state: Tensor,
                    active_types: Sequence[int] = ALL_TYPES,
                    u_override: Optional[Tensor] = None,
                    override_mask: Optional[Tensor] = None):
    """Draw the 3 BSDF-sampling uniforms from the PCG stream; lanes where
    override_mask is set use u_override instead."""
    state, u = rngmod.next_float3(state)
    if u_override is not None:
        u = torch.where(override_mask[..., None], u_override, u)
    return sample(ctx, wi, u, active_types), state


def is_delta_only(ctx: BsdfCtx) -> Tensor:
    """Lanes whose material has no smooth component (pure delta)."""
    m = torch.zeros(ctx.mat_type.shape, dtype=torch.bool,
                    device=ctx.mat_type.device)
    for t in _DELTA_TYPES:
        m |= ctx.mat_type == t
    return m


def regularize_ctx(ctx: BsdfCtx, do_reg: Tensor, alpha_min: float = 0.08) -> BsdfCtx:
    """Path regularization: on the lanes of `do_reg`, the smooth dielectric
    and conductor become their rough counterparts, and the rough ones get a
    roughness of at least alpha_min, so that NEE and MIS connect through
    otherwise-delta chains (biased, consistent as alpha_min -> 0)."""
    t = ctx.mat_type
    new_t = torch.where(do_reg & (t == schema.BSDF_DIELECTRIC),
                        schema.BSDF_ROUGHDIELECTRIC, t)
    new_t = torch.where(do_reg & (t == schema.BSDF_CONDUCTOR),
                        schema.BSDF_ROUGHCONDUCTOR, new_t)
    bump_rough = do_reg & ((t == schema.BSDF_DIELECTRIC) | (t == schema.BSDF_CONDUCTOR)
                           | (new_t == schema.BSDF_ROUGHDIELECTRIC)
                           | (new_t == schema.BSDF_ROUGHCONDUCTOR))
    p = ctx.params.clone()
    p[:, 6:8] = torch.where(bump_rough[:, None], p[:, 6:8].clamp_min(alpha_min), p[:, 6:8])
    return ctx._replace(mat_type=new_t.to(torch.int32), params=p)


# the types a regularized path may turn its delta lobes into
REGULARIZE_EXTRA_TYPES = (schema.BSDF_ROUGHDIELECTRIC, schema.BSDF_ROUGHCONDUCTOR)
