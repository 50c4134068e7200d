"""The BSDF system: sample / evaluate / pdf.

Port of ``cudatracerlib_tpu/models/bsdf.py`` for the diffuse, conductor
and rough-conductor BSDFs. Material rows are gathered into a flat
``BsdfCtx``, with their textures evaluated (ops/texture.py), and every lane
evaluates the closed forms of the types present in the scene (a static
tuple), selecting per-lane results with masks. The other 10 simple types
and the nested (coating, rough coating, blend) materials are not ported
yet: asking for them raises.

Conventions (Mitsuba): directions in the local shading frame, +z = normal,
`wi` the fixed incident direction, `wo` the sampled/queried outgoing one,
both pointing away from the surface. `evaluate` returns f(wi,wo)*|cos_o|
for smooth lobes only; delta lobes (the conductor) only appear through
`sample`.

Param layout (MaterialTable.params): [0:3] reflectance [5] mf distribution
[6] alpha_u [7] alpha_v [8:11] conductor eta [11:14] conductor k ...
[19:22] transmittance/diffuse, [22] two-sided flag (see the JAX module).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from ..core import fresnel
from ..core import microfacet as mf
from ..core import records
from ..core import rng as rngmod
from ..core import vecmath as vm
from ..core import warp
from ..ops import texture as texmod
from ..scene import schema

Tensor = torch.Tensor
INV_PI = 1.0 / math.pi

ALL_TYPES = tuple(range(16))
PORTED_TYPES = (schema.BSDF_DIFFUSE, schema.BSDF_CONDUCTOR,
                schema.BSDF_ROUGHCONDUCTOR)
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


class Lobe(NamedTuple):
    f: Tensor      # (B, 3) f * |cos_o| (smooth components only)
    pdf: Tensor    # (B,)


class SampleOut(NamedTuple):
    wo: Tensor
    weight: Tensor        # (B, 3) f*cos/pdf
    pdf: Tensor           # (B,) solid-angle pdf
    sampled_type: Tensor  # (B,) i32 flags
    eta: Tensor           # (B,) relative IOR along the sampled path


def _check_types(active_types):
    missing = [t for t in active_types if t not in PORTED_TYPES]
    if missing:
        raise NotImplementedError(f"BSDF types {missing} are not ported yet")


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
    """Gather material rows and evaluate their textures for a lane batch
    (non-nested materials).

    with_textures is a per-slot bitmask (1 = reflectance slot, 2 =
    secondary-color slot; True = both, False/0 = none, see
    scene_texture_mask). uv_footprint (the ray-cone width in uv units),
    ewa = (major-axis uv direction, major length) and extra pass through to
    ops/texture.eval_texture."""
    if active_types is None or any(t in _NESTED_TYPES for t in active_types):
        raise NotImplementedError("nested (coating/blend) BSDFs are not ported yet")
    mats = scene.materials
    # clamp before the gather: an out-of-range index stops a CUDA device
    mid = mat_id.clamp(0, mats.mat_type.shape[0] - 1).long()
    r = _mat_fat_rows(mats)[mid]
    P = schema.N_MAT_PARAMS
    t = r[:, 0].view(torch.int32)
    p = r[:, 1:1 + P]
    c0, c1 = p[:, 0:3], p[:, 19:22]
    tex_mask = 3 if with_textures is True else int(with_textures)
    if tex_mask:
        tex_ids = r[:, 1 + P:5 + P].view(torch.int32)
        e_dir, e_maj = ewa if ewa is not None else (None, None)
        if tex_mask & 1:
            c0 = texmod.eval_texture(scene.textures, tex_ids[:, 0], uv, c0,
                                     uv_footprint, e_dir, e_maj, extra=extra)
        if tex_mask & 2:
            c1 = texmod.eval_texture(scene.textures, tex_ids[:, 1], uv, c1,
                                     uv_footprint, e_dir, e_maj, extra=extra)
    z = torch.full_like(t, schema.BSDF_DIFFUSE)
    return BsdfCtx(mat_type=t, params=p, c0=c0, c1=c1,
                   n_type=z, n_params=p, n_c0=c0, n_c1=c1,
                   n2_type=z, n2_params=p, n2_c0=c0, n2_c1=c1)


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


# the conductor is a pure delta lobe: it has a sampler and no evaluation
_EVAL_FNS = {schema.BSDF_DIFFUSE: _diffuse_eval,
             schema.BSDF_ROUGHCONDUCTOR: _roughconductor_eval}
_SAMPLE_FNS = {schema.BSDF_DIFFUSE: _diffuse_sample,
               schema.BSDF_CONDUCTOR: _conductor_sample,
               schema.BSDF_ROUGHCONDUCTOR: _roughconductor_sample}


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


def evaluate(ctx: BsdfCtx, wi: Tensor, wo: Tensor,
             active_types: Sequence[int] = PORTED_TYPES) -> Lobe:
    """f(wi,wo)*|cos_o| + pdf for smooth lobes, masked over active types."""
    _check_types(active_types)
    wi, flip = _apply_two_sided(ctx, wi)
    wo = _flip_back(flip, wo)
    B = wi.shape[0]
    f = torch.zeros((B, 3), dtype=torch.float32, device=wi.device)
    pdf = torch.zeros(B, dtype=torch.float32, device=wi.device)
    for t in active_types:
        if t not in _EVAL_FNS:
            continue
        lob = _EVAL_FNS[t](ctx, wi, wo)
        m = ctx.mat_type == t
        f = torch.where(m[..., None], lob.f, f)
        pdf = torch.where(m, lob.pdf, pdf)
    return Lobe(f=f, pdf=pdf)


def sample(ctx: BsdfCtx, wi: Tensor, u: Tensor,
           active_types: Sequence[int] = PORTED_TYPES) -> SampleOut:
    """Sample the BSDF. u: (B, 3) uniforms (lobe choice + 2D)."""
    _check_types(active_types)
    wi, flip = _apply_two_sided(ctx, wi)
    B, dev = wi.shape[0], wi.device
    out = SampleOut(wo=torch.zeros((B, 3), dtype=torch.float32, device=dev),
                    weight=torch.zeros((B, 3), dtype=torch.float32, device=dev),
                    pdf=torch.zeros(B, dtype=torch.float32, device=dev),
                    sampled_type=torch.zeros(B, dtype=torch.int32, device=dev),
                    eta=torch.ones(B, dtype=torch.float32, device=dev))
    for t in active_types:
        s = _SAMPLE_FNS[t](ctx, wi, u)
        m = ctx.mat_type == t
        out = SampleOut(wo=torch.where(m[..., None], s.wo, out.wo),
                        weight=torch.where(m[..., None], s.weight, out.weight),
                        pdf=torch.where(m, s.pdf, out.pdf),
                        sampled_type=torch.where(m, s.sampled_type, out.sampled_type),
                        eta=torch.where(m, s.eta, out.eta))
    return out._replace(wo=_flip_back(flip, out.wo))


def sample_with_rng(ctx: BsdfCtx, wi: Tensor, state: Tensor,
                    active_types: Sequence[int] = PORTED_TYPES,
                    u_override: Optional[Tensor] = None,
                    override_mask: Optional[Tensor] = None):
    """Draw the 3 BSDF-sampling uniforms from the PCG stream; lanes where
    override_mask is set use u_override instead."""
    state, u = rngmod.next_float3(state)
    if u_override is not None:
        u = torch.where(override_mask[..., None], u_override, u)
    return sample(ctx, wi, u, active_types), state
