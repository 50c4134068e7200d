"""Emitter sampling / evaluation / pdfs.

Port of ``cudatracerlib_tpu/models/lights.py`` for point, spot, distant and
area lights and the environment map (equirectangular, sampled by an alias
table over its pixels). Batched and branchless: every lane computes the
closed forms of each light type and selects by the sampled row's type id.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import rng as rngmod
from ..core import vecmath as vm
from ..core import warp
from ..scene import schema

Tensor = torch.Tensor


class EmitterDirect(NamedTuple):
    """Result of next-event estimation toward one sampled emitter."""
    p: Tensor         # (B, 3) point on the emitter
    d: Tensor         # (B, 3) unit direction ref -> emitter
    dist: Tensor      # (B,)
    n: Tensor         # (B, 3) emitter normal (zeros for point-ish)
    radiance_over_pdf: Tensor  # (B, 3) Le / (selection pdf * pdf)
    pdf: Tensor       # (B,) solid-angle pdf at ref including selection
    is_delta: Tensor  # (B,) delta emitters (excluded from BSDF-side MIS)
    light_idx: Tensor  # (B,) i32


class EmitterRay(NamedTuple):
    """Sampled emission ray for light tracing and BDPT."""
    o: Tensor          # (B, 3)
    d: Tensor          # (B, 3)
    n: Tensor          # (B, 3) emitter surface normal (zeros for point)
    power: Tensor      # (B, 3) full path weight Le*cos/(pdf_pos*pdf_dir*pdf_sel)
    pdf_pos: Tensor    # (B,) area pdf (incl. selection)
    pdf_dir: Tensor    # (B,) direction pdf (solid angle)
    light_idx: Tensor  # (B,) i32
    le: Tensor         # (B, 3) emitted radiance / intensity at the origin


def has_env_static(lights: schema.LightTable) -> bool:
    """Shape-level check for an environment light: the builder emits a 1x1
    black placeholder map when no infinite light exists."""
    return lights.env_map.shape[0] * lights.env_map.shape[1] > 1


def _env_direction_from_uv(lights: schema.LightTable, u_img: Tensor, v_img: Tensor):
    """(u,v) in [0,1)^2 equirect -> world direction (and sin theta)."""
    phi = u_img * 2.0 * math.pi - math.pi
    theta = v_img * math.pi
    st = torch.sin(theta)
    d_local = torch.stack([st * torch.sin(phi), torch.cos(theta),
                           -st * torch.cos(phi)], dim=-1)
    return vm.transform_vector(lights.env_to_world, d_local), st


def _env_uv_from_direction(lights: schema.LightTable, d: Tensor):
    dl = vm.transform_vector(lights.env_world_to, d)
    theta = torch.arccos(dl[..., 1].clamp(-1.0, 1.0))
    phi = torch.atan2(dl[..., 0], -dl[..., 2])
    u = (phi + math.pi) / (2.0 * math.pi)
    v = theta / math.pi
    return torch.remainder(u, 1.0), v.clamp(0.0, 1.0)


def _env_pixel(lights: schema.LightTable, u: Tensor, v: Tensor):
    He, We = lights.env_map.shape[0], lights.env_map.shape[1]
    x = (u * We).to(torch.int32).clamp(0, We - 1)
    y = (v * He).to(torch.int32).clamp(0, He - 1)
    return y, x


def _env_row(lights: schema.LightTable):
    """(has_env, row index of the env light) as (,) and (1,) device tensors:
    indexing with them needs no host read."""
    is_env = lights.light_type == schema.LIGHT_INFINITE
    return is_env.any(), is_env.to(torch.int32).argmax().reshape(1)


def eval_environment(scene: schema.SceneData, d: Tensor) -> Tensor:
    """Env radiance for escaped rays (KernelDynamicScene::EvalEnvironment)."""
    lights = scene.lights
    if not has_env_static(lights):
        return torch.zeros(d.shape[:-1] + (3,), dtype=torch.float32, device=d.device)
    y, x = _env_pixel(lights, *_env_uv_from_direction(lights, d))
    texel = lights.env_map[y.long(), x.long()]
    has_env, env_row = _env_row(lights)
    # env scale lives in the env light row's params[3:6]
    scale = lights.params.index_select(0, env_row)[0, 3:6]
    return torch.where(has_env, texel * scale, 0.0)


def _env_pdf_dir(scene: schema.SceneData, d: Tensor) -> Tensor:
    """Solid-angle pdf of env importance sampling for direction d: one pmf
    gather (scene/alias.py tables)."""
    lights = scene.lights
    if not has_env_static(lights):
        return torch.zeros(d.shape[:-1], dtype=torch.float32, device=d.device)
    He, We = lights.env_map.shape[0], lights.env_map.shape[1]
    u, v = _env_uv_from_direction(lights, d)
    y, x = _env_pixel(lights, u, v)
    p_pixel = lights.env_pmf.reshape(-1)[(y * We + x).long()]
    sin_t = torch.sin(v.clamp(1e-4, 1 - 1e-4) * math.pi).clamp_min(1e-5)
    jac = (He * We) / (2.0 * math.pi * math.pi * sin_t)
    return p_pixel * jac


def _env_sample_pixel(lights: schema.LightTable, u2: Tensor):
    """O(1) alias-table draw of an env pixel: (y, x, pmf) from two uniforms
    with ONE (B, 4) fat-row gather."""
    He, We = lights.env_map.shape[0], lights.env_map.shape[1]
    n = He * We
    slot = (u2[:, 0] * n).to(torch.int32).clamp_max(n - 1)
    row = lights.env_alias[slot.long()]
    use_alias = u2[:, 1] >= row[:, 0]
    alias_idx = row[:, 1].view(torch.int32)
    pix = torch.where(use_alias, alias_idx, slot)
    pmf = torch.where(use_alias, row[:, 3], row[:, 2])
    return pix // We, pix % We, pmf


def _sample_area_tri(lights: schema.LightTable, first: Tensor, count: Tensor,
                     u: Tensor) -> Tensor:
    """O(1) area-weighted emitter-triangle draw (absolute al_tris index): one
    alias-row gather. The integer and fractional parts of u*count are
    independent uniforms (slot choice and alias coin)."""
    cnt = count.to(torch.float32)
    scaled = u.clamp_max(1.0 - 1e-7) * cnt
    ofs = torch.minimum(scaled.to(torch.int32), count - 1)
    frac = scaled - ofs.to(torch.float32)
    # clamp before the gather: an out-of-range index stops a CUDA device
    slot = (first + ofs).clamp(0, lights.al_alias.shape[0] - 1)
    row = lights.al_alias[slot.long()]
    return torch.where(frac < row[:, 0], slot, row[:, 1].view(torch.int32))


def _select_light(lights: schema.LightTable, u: Tensor):
    if lights.power_cdf.shape[0] == 1:  # single-light fast path
        return (torch.zeros(u.shape, dtype=torch.int32, device=u.device),
                torch.ones(u.shape, dtype=torch.float32, device=u.device))
    cdf = lights.power_cdf
    idx = torch.searchsorted(cdf, u, side="left").clamp(0, cdf.shape[0] - 1)
    prev = torch.where(idx > 0, cdf[(idx - 1).clamp_min(0)], 0.0)
    pdf_sel = cdf[idx] - prev
    return idx.to(torch.int32), pdf_sel.clamp_min(1e-12)


def _light_fat_rows(lights: schema.LightTable) -> Tensor:
    """[type | params | al_first | al_count | cdf | cdf_prev] per light row."""
    cdf = lights.power_cdf
    prev = torch.cat([torch.zeros(1, dtype=cdf.dtype, device=cdf.device), cdf[:-1]])
    return torch.cat([
        lights.light_type.view(torch.float32)[:, None], lights.params,
        lights.al_first.view(torch.float32)[:, None],
        lights.al_count.view(torch.float32)[:, None],
        cdf[:, None], prev[:, None]], dim=1)


def _select_cases(masks, values):
    out = values[0]
    for m, v in zip(masks[1:], values[1:]):
        if v.ndim > m.ndim:
            m = m[..., None]
        out = torch.where(m, v, out)
    return out


def sample_emitter_direct(scene: schema.SceneData, ref_p: Tensor,
                          state: Tensor, u_override: Tensor = None,
                          override_mask: Tensor = None) -> tuple:
    """NEE: sample one emitter (by power CDF), one point on it, return the
    direct-illumination record and the advanced RNG state."""
    lights = scene.lights
    B, dev = ref_p.shape[0], ref_p.device
    state, u_sel = rngmod.next_float(state)
    state, u2 = rngmod.next_float2(state)
    if u_override is not None:
        u_sel = torch.where(override_mask, u_override[..., 0], u_sel)
        u2 = torch.where(override_mask[..., None], u_override[..., 1:3], u2)
    idx, pdf_sel = _select_light(lights, u_sel)
    row = _light_fat_rows(lights)[idx.long()]
    NP = schema.N_LIGHT_PARAMS
    ltype = row[:, 0].view(torch.int32)
    p = row[:, 1:1 + NP]

    # --- point ---
    d_pt = p[:, 0:3] - ref_p
    dist2_pt = vm.length_sqr(d_pt).clamp_min(1e-12)
    dist_pt = torch.sqrt(dist2_pt)
    dir_pt = d_pt / dist_pt[..., None]
    rop_pt = p[:, 3:6] / dist2_pt[..., None]

    # --- spot: like point with cone falloff ---
    cos_cut = p[:, 6]
    cos_beam = p[:, 7]
    cos_ang = vm.dot(p[:, 8:11], -dir_pt)
    fall = ((cos_ang - cos_cut) / (cos_beam - cos_cut).clamp_min(1e-6)).clamp(0.0, 1.0)
    fall = fall * fall * (3.0 - 2.0 * fall)  # smoothstep falloff
    rop_spot = rop_pt * fall[..., None]

    # --- distant: delta direction ---
    dir_dist = -p[:, 0:3]
    rop_dist = p[:, 3:6]

    # --- area light: alias-sampled triangle, uniform barycentric ---
    first = row[:, 1 + NP].view(torch.int32)
    count = row[:, 2 + NP].view(torch.int32).clamp_min(1)
    state, u_tri = rngmod.next_float(state)
    ai = _sample_area_tri(lights, first, count, u_tri)
    trow = lights.al_rows[ai.clamp(0, lights.al_rows.shape[0] - 1).long()]
    bary = warp.square_to_uniform_triangle(u2)
    pos_area = (trow[:, 0:3] + trow[:, 3:6] * bary[:, 0:1] + trow[:, 6:9] * bary[:, 1:2])
    ng = trow[:, 9:12]
    d_ar = pos_area - ref_p
    dist2_ar = vm.length_sqr(d_ar).clamp_min(1e-12)
    dist_ar = torch.sqrt(dist2_ar)
    dir_ar = d_ar / dist_ar[..., None]
    cos_l = vm.dot(ng, -dir_ar)
    area_total = p[:, 6].clamp_min(1e-12)
    pdf_ar = dist2_ar / (cos_l * area_total).clamp_min(1e-9)  # area->solid angle
    front = cos_l > 0
    rop_ar = torch.where(front[..., None], p[:, 3:6] / pdf_ar[..., None], 0.0)

    # --- env: importance-sample the map (skipped when the scene has none;
    # the draw always happens so the RNG stream is layout-independent) ---
    state, u_env = rngmod.next_float2(state)
    if has_env_static(lights):
        He, We = lights.env_map.shape[0], lights.env_map.shape[1]
        y, x, pmf = _env_sample_pixel(lights, u_env)
        u_img = (x.to(torch.float32) + 0.5) / We
        v_img = (y.to(torch.float32) + 0.5) / He
        dir_env, sin_t = _env_direction_from_uv(lights, u_img, v_img)
        le_env = lights.env_map.reshape(-1, 3)[(y * We + x).long()] * p[:, 3:6]
        jac = (He * We) / (2.0 * math.pi * math.pi * sin_t.clamp_min(1e-5))
        pdf_env = (pmf * jac).clamp_min(1e-12)
        rop_env = le_env / pdf_env[..., None]
    else:
        dir_env = dir_pt
        pdf_env = torch.ones(B, dtype=torch.float32, device=dev)
        rop_env = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    world_rad = torch.maximum(p[:, 7], vm.length(scene.world_hi - scene.world_lo))

    is_pt = ltype == schema.LIGHT_POINT
    is_spot = ltype == schema.LIGHT_SPOT
    is_dist = ltype == schema.LIGHT_DISTANT
    is_area = ltype == schema.LIGHT_DIFFUSE
    is_env = ltype == schema.LIGHT_INFINITE

    def sel3(*tv):
        return _select_cases([is_pt, is_spot, is_dist, is_area, is_env], tv)

    zeros = torch.zeros(B, dtype=torch.float32, device=dev)
    d_out = sel3(dir_pt, dir_pt, dir_dist, dir_ar, dir_env)
    dist_out = sel3(dist_pt, dist_pt, torch.full((B,), 1e7, device=dev),
                    dist_ar, world_rad * 2.0)
    p_out = ref_p + d_out * dist_out[..., None]
    p_out = torch.where(is_area[..., None], pos_area, p_out)
    n_out = torch.where(is_area[..., None], ng, torch.zeros_like(ref_p))
    rop = sel3(rop_pt, rop_spot, rop_dist, rop_ar, rop_env)
    rop = rop / pdf_sel[..., None]
    pdf_sa = sel3(zeros, zeros, zeros, pdf_ar, pdf_env) * pdf_sel
    is_delta = is_pt | is_spot | is_dist
    return EmitterDirect(p=p_out, d=d_out, dist=dist_out, n=n_out,
                         radiance_over_pdf=rop, pdf=pdf_sa, is_delta=is_delta,
                         light_idx=idx), state


def sample_emitter_ray(scene: schema.SceneData, state: Tensor) -> tuple:
    """Sample an emission ray carrying its full power weight: the entry
    point of light tracing and BDPT's light walk (ParticleProcess emission
    sampling). Every lane computes each light type's closed form and
    selects by its sampled row's type."""
    lights = scene.lights
    state, u_sel = rngmod.next_float(state)
    idx, pdf_sel = _select_light(lights, u_sel)
    row = _light_fat_rows(lights)[idx.long()]
    NP = schema.N_LIGHT_PARAMS
    ltype = row[:, 0].view(torch.int32)
    p = row[:, 1:1 + NP]
    B, dev = u_sel.shape[0], u_sel.device
    f32 = dict(dtype=torch.float32, device=dev)
    state, u_pos = rngmod.next_float2(state)
    state, u_dir = rngmod.next_float2(state)

    world_c = 0.5 * (scene.world_lo + scene.world_hi)
    world_r = (0.5 * vm.length(scene.world_hi - scene.world_lo)).clamp_min(1e-3) * 1.01

    # point: uniform sphere
    o_pt = p[:, 0:3]
    d_pt = warp.square_to_uniform_sphere(u_dir)
    w_pt = p[:, 3:6] * (4.0 * math.pi)
    pdfp_pt = torch.ones(B, **f32)
    pdfd_pt = torch.full((B,), warp.INV_FOURPI, **f32)

    # spot: cone with falloff
    cos_cut = p[:, 6]
    d_cone = warp.square_to_uniform_cone(u_dir, cos_cut)
    spot_t, spot_s = vm.coordinate_system(p[:, 8:11])
    d_spot = (spot_t * d_cone[:, 0:1] + spot_s * d_cone[:, 1:2]
              + p[:, 8:11] * d_cone[:, 2:3])
    pdf_cone = warp.square_to_uniform_cone_pdf(cos_cut)
    cos_beam = p[:, 7]
    fall = ((d_cone[:, 2] - cos_cut) / (cos_beam - cos_cut).clamp_min(1e-6)).clamp(0, 1)
    fall = fall * fall * (3 - 2 * fall)
    w_spot = p[:, 3:6] * (fall / pdf_cone)[..., None]
    pdfd_spot = torch.full((B,), 1.0, **f32) * pdf_cone

    # distant: point on a disk of the world's radius, fixed direction
    dir_d = p[:, 0:3]
    t1, t2 = vm.coordinate_system(dir_d)
    disk = warp.square_to_uniform_disk_concentric(u_pos) * world_r
    o_dist = world_c - dir_d * world_r[..., None] + t1 * disk[:, 0:1] + t2 * disk[:, 1:2]
    area_disk = math.pi * world_r * world_r
    w_dist = p[:, 3:6] * area_disk[..., None]
    pdfp_dist = 1.0 / area_disk * torch.ones(B, **f32)
    pdfd_dist = torch.ones(B, **f32)

    # area: position by the alias-sampled triangle + cosine direction
    first = row[:, 1 + NP].view(torch.int32)
    count = row[:, 2 + NP].view(torch.int32).clamp_min(1)
    state, u_tri = rngmod.next_float(state)
    ai = _sample_area_tri(lights, first, count, u_tri)
    trow = lights.al_rows[ai.clamp(0, lights.al_rows.shape[0] - 1).long()]
    bary = warp.square_to_uniform_triangle(u_pos)
    o_ar = trow[:, 0:3] + trow[:, 3:6] * bary[:, 0:1] + trow[:, 6:9] * bary[:, 1:2]
    ng = trow[:, 9:12]
    local = warp.square_to_cosine_hemisphere(u_dir)
    fr_t, fr_s = vm.coordinate_system(ng)
    d_ar = fr_t * local[:, 0:1] + fr_s * local[:, 1:2] + ng * local[:, 2:3]
    area_total = p[:, 6].clamp_min(1e-12)
    w_ar = p[:, 3:6] * (math.pi * area_total)[..., None]
    pdfp_ar = 1.0 / area_total
    pdfd_ar = warp.square_to_cosine_hemisphere_pdf(local)

    # env: direction from the map (pointing into the scene), origin on the
    # far disk
    if has_env_static(lights):
        He, We = lights.env_map.shape[0], lights.env_map.shape[1]
        y, x, pmf = _env_sample_pixel(lights, u_dir)
        u_img = (x.to(torch.float32) + 0.5) / We
        v_img = (y.to(torch.float32) + 0.5) / He
        d_from_env, sin_te = _env_direction_from_uv(lights, u_img, v_img)
        d_env = -d_from_env  # radiance flows opposite the direction to the env
        le_env = lights.env_map.reshape(-1, 3)[(y * We + x).long()] * p[:, 3:6]
        jac_e = (He * We) / (2.0 * math.pi * math.pi * sin_te.clamp_min(1e-5))
        pdf_env_d = (pmf * jac_e).clamp_min(1e-12)
        e1, e2 = vm.coordinate_system(d_env)
        disk_e = warp.square_to_uniform_disk_concentric(u_pos) * world_r
        o_env = (world_c - d_env * world_r[..., None] + e1 * disk_e[:, 0:1]
                 + e2 * disk_e[:, 1:2])
        area_e = math.pi * world_r * world_r
        w_env = le_env * (area_e / pdf_env_d)[..., None]
        pdfp_env = 1.0 / area_e * torch.ones(B, **f32)
        pdfd_env = pdf_env_d
    else:
        d_env = d_pt
        o_env = o_pt
        le_env = torch.zeros((B, 3), **f32)
        w_env = torch.zeros((B, 3), **f32)
        pdfp_env = torch.ones(B, **f32)
        pdfd_env = torch.ones(B, **f32)

    masks = [ltype == schema.LIGHT_POINT, ltype == schema.LIGHT_SPOT,
             ltype == schema.LIGHT_DISTANT, ltype == schema.LIGHT_DIFFUSE,
             ltype == schema.LIGHT_INFINITE]

    def sel(*tv):
        return _select_cases(masks, tv)

    zero3 = torch.zeros_like(o_pt)
    o = sel(o_pt, o_pt, o_dist, o_ar, o_env)
    d = sel(d_pt, d_spot, dir_d, d_ar, d_env)
    n = sel(zero3, zero3, dir_d, ng, d_env)
    w = sel(w_pt, w_spot, w_dist, w_ar, w_env) / pdf_sel[..., None]
    pdf_pos = sel(pdfp_pt, pdfp_pt, pdfp_dist, pdfp_ar, pdfp_env) * pdf_sel
    pdf_dir = sel(pdfd_pt, pdfd_spot, pdfd_dist, pdfd_ar, pdfd_env)
    le = sel(p[:, 3:6], p[:, 3:6] * fall[..., None], p[:, 3:6], p[:, 3:6], le_env)
    return EmitterRay(o=o, d=d, n=n, power=w, pdf_pos=pdf_pos, pdf_dir=pdf_dir,
                      light_idx=idx, le=le), state


def eval_hit_emitter(scene: schema.SceneData, light_id: Tensor, ng: Tensor,
                     wi: Tensor) -> Tensor:
    """Radiance of a hit area light toward wi (one-sided along ng)."""
    params = scene.lights.params
    # clamp before the gather: an out-of-range index stops a CUDA device
    lid = light_id.clamp(0, params.shape[0] - 1).long()
    p = params[lid]
    front = vm.dot(ng, wi) > 0
    return torch.where(((light_id >= 0) & front)[..., None], p[:, 3:6], 0.0)


def pdf_hit_emitter_direct(scene: schema.SceneData, light_id: Tensor,
                           ref_p: Tensor, hit_p: Tensor, ng: Tensor) -> Tensor:
    """Solid-angle pdf that NEE would have sampled this hit point on this
    area light (incl. light selection), for BSDF-side MIS weights."""
    NP = schema.N_LIGHT_PARAMS
    fat = _light_fat_rows(scene.lights)
    lid = light_id.clamp(0, fat.shape[0] - 1).long()
    row = fat[lid]
    p = row[:, 1:1 + NP]
    pdf_sel = (row[:, 3 + NP] - row[:, 4 + NP]).clamp_min(1e-12)
    d = hit_p - ref_p
    dist2 = vm.length_sqr(d).clamp_min(1e-12)
    cos_l = vm.dot(ng, -d) * torch.rsqrt(dist2)
    area_total = p[:, 6].clamp_min(1e-12)
    pdf = dist2 / (cos_l * area_total).clamp_min(1e-9) * pdf_sel
    return torch.where((light_id >= 0) & (cos_l > 0), pdf, 0.0)


def pdf_env_direct(scene: schema.SceneData, d: Tensor) -> Tensor:
    """Solid-angle pdf that NEE would have sampled direction d on the env
    map, including the env light's selection probability."""
    lights = scene.lights
    if not has_env_static(lights):
        return torch.zeros(d.shape[:-1], dtype=torch.float32, device=d.device)
    has_env, env_row = _env_row(lights)
    cdf = lights.power_cdf
    prev = torch.where(env_row > 0,
                       cdf.index_select(0, (env_row - 1).clamp_min(0)), 0.0)
    pdf_sel = (cdf.index_select(0, env_row) - prev).clamp_min(1e-12)
    return torch.where(has_env, _env_pdf_dir(scene, d) * pdf_sel, 0.0)
