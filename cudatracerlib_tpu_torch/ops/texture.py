"""Texture evaluation (reference: ``SceneTypes/Texture.h`` + ``Engine/MIPMap``).

Port of ``cudatracerlib_tpu/ops/texture.py``. Batched and branchless: every
texture type is a cheap closed form except images, which gather from the
flat texel pool: bilinear from mip 0, trilinear from the ray-cone footprint,
or gaussian-weighted taps along the footprint's major axis (EWA).

Two rules keep it equal to the JAX version: ``%`` is floor-mod there, so
the port uses ``torch.remainder`` (never ``torch.fmod``); and every index
that ``jnp.take`` would clamp or fill is clamped here before the gather,
since torch raises on the CPU and stops a CUDA device on a bad index.
"""
from __future__ import annotations

import math

import torch

from ..scene import schema

Tensor = torch.Tensor

# True-EWA quadrature along the footprint's major axis (reference ellipse
# walk: Engine/MIPMap_device.h:57-83). The eccentricity clamp mirrors the
# reference's minor-axis scaling so EWA_N_TAPS probes always suffice.
EWA_MAX_ANISO = 8.0
EWA_N_TAPS = 9


def _take_rows(table: Tensor, idx: Tensor) -> Tensor:
    """table[idx] with idx clamped into range (jnp.take's clamp)."""
    return table[idx.clamp(0, table.shape[0] - 1).long()]


def eval_texture(tex: schema.TextureTable, tex_id: Tensor, uv: Tensor,
                 default: Tensor, uv_footprint: Tensor | None = None,
                 ewa_dir: Tensor | None = None,
                 ewa_major: Tensor | None = None,
                 extra: Tensor | None = None) -> Tensor:
    """Evaluate texture rows for a lane batch.

    tex_id: (B,) i32 (-1 = use `default`); uv: (B, 2); default: (B, 3).
    uv_footprint: optional (B,) pixel footprint in UV units (ray-cone width *
    uv density); each image picks its mip level from it (trilinear).
    ewa_dir/ewa_major: optional anisotropy, the unit uv-space direction of
    the footprint's MAJOR axis and its length: images are then filtered
    with gaussian-weighted taps along the major axis at the minor-axis LOD.
    """
    tid = tex_id.clamp_min(0)
    # one fat-row gather: [type | params | image_id]
    fat = torch.cat([tex.tex_type.view(torch.float32)[:, None], tex.params,
                     tex.image_id.view(torch.float32)[:, None]], dim=1)
    row = _take_rows(fat, tid)
    ttype = row[:, 0].view(torch.int32)
    p = row[:, 1:1 + tex.params.shape[1]]
    u = uv[..., 0] * p[:, 6] + p[:, 8]
    v = uv[..., 1] * p[:, 7] + p[:, 9]

    c_const = p[:, 0:3]

    # checkerboard: color0 / color1 on integer parity
    iu = torch.floor(u).to(torch.int32)
    iv = torch.floor(v).to(torch.int32)
    par = (iu + iv) & 1
    c_checker = torch.where((par == 0)[:, None], p[:, 0:3], p[:, 3:6])

    # bilerp between color0 (at 0,0 / 1,1) and color1 via uv
    fu, fv = torch.remainder(u, 1.0), torch.remainder(v, 1.0)
    w = fu * fv + (1 - fu) * (1 - fv)
    c_bilerp = w[:, None] * p[:, 0:3] + (1 - w)[:, None] * p[:, 3:6]

    # uv debug
    c_uv = torch.stack([fu, fv, torch.zeros_like(u)], dim=-1)

    # image: bilinear (mip 0), trilinear (ray-cone footprint), or EWA-style
    # anisotropic taps from the atlas
    if uv_footprint is None:
        c_image = _sample_image(tex, tid, u, v)
    else:
        img_row = row[:, -1].view(torch.int32).clamp_min(0)
        nm = _take_rows(tex.img_nmips, img_row)
        w0 = _take_rows(tex.img_w[:, 0], img_row).to(torch.float32)
        minor = uv_footprint
        if ewa_dir is not None:
            # eccentricity clamp (reference MIPMap_device.h:61-66): widening
            # the minor axis raises the LOD so the fixed tap count still
            # covers the whole ellipse without aliasing
            major_c = torch.maximum(ewa_major, minor)
            minor = torch.maximum(minor, major_c / EWA_MAX_ANISO)
        texels_covered = minor * p[:, 6].abs() * w0
        lod = torch.log2(texels_covered.clamp_min(1.0))
        lev = torch.minimum(lod.clamp_min(0.0), nm.to(torch.float32) - 1.0)
        l0 = torch.floor(lev).to(torch.int32)
        fl = (lev - l0.to(torch.float32))[:, None]

        def tri_at(uu, vv):
            c_lo = _sample_image(tex, tid, uu, vv, l0)
            c_hi = _sample_image(tex, tid, uu, vv, torch.minimum(l0 + 1, nm - 1))
            return c_lo * (1 - fl) + c_hi * fl

        if ewa_dir is None:
            c_image = tri_at(u, v)
        else:
            # fixed-count probes over the ellipse extent not already covered
            # by the trilinear minor width, weighted by the reference's
            # gaussian falloff w(r^2) = exp(-2 r^2) - exp(-2)
            span = (major_c - minor).clamp_min(0.0)
            # tap offsets are in RAW uv; scale into the texture's mapped uv
            du = ewa_dir[:, 0] * span * p[:, 6]
            dv = ewa_dir[:, 1] * span * p[:, 7]
            c_image = torch.zeros_like(c_const)
            w_sum = 0.0
            for i in range(EWA_N_TAPS):
                # tap centres at cell midpoints: the r=+-1 endpoints would
                # carry weight 0 yet cost a gather each
                r = (2.0 * i + 1.0) / EWA_N_TAPS - 1.0
                w_ = math.exp(-2.0 * r * r) - math.exp(-2.0)
                w_sum += w_
                c_image = c_image + w_ * tri_at(u + du * (r * 0.5),
                                                v + dv * (r * 0.5))
            c_image = c_image / w_sum

    # wireframe: uv-grid lines stand in for the distance to the nearest edge
    edge = torch.minimum(torch.minimum(fu, fv), torch.minimum(1 - fu, 1 - fv)) < 0.05
    c_wire = torch.where(edge[:, None], p[:, 0:3], p[:, 3:6])

    out = c_const
    out = torch.where((ttype == schema.TEX_CHECKERBOARD)[:, None], c_checker, out)
    out = torch.where((ttype == schema.TEX_BILERP)[:, None], c_bilerp, out)
    out = torch.where((ttype == schema.TEX_IMAGE)[:, None], c_image, out)
    out = torch.where((ttype == schema.TEX_UV)[:, None], c_uv, out)
    out = torch.where((ttype == schema.TEX_WIREFRAME)[:, None], c_wire, out)
    if extra is not None:
        # per-vertex extra data interpolated by fill_dg, tinted by color0
        # (reference ExtraDataTexture, SceneTypes/Texture.h:234)
        c_extra = extra[:, None] * p[:, 0:3]
        out = torch.where((ttype == schema.TEX_EXTRADATA)[:, None], c_extra, out)
    return torch.where((tex_id >= 0)[:, None], out, default)


def _sample_image(tex: schema.TextureTable, tid: Tensor, u: Tensor, v: Tensor,
                  level: Tensor | None = None) -> Tensor:
    img = _take_rows(tex.image_id, tid).clamp_min(0)
    if level is None:
        off = _take_rows(tex.img_offset[:, 0], img)
        w = _take_rows(tex.img_w[:, 0], img)
        h = _take_rows(tex.img_h[:, 0], img)
    else:
        lv = level.clamp(0, tex.img_offset.shape[1] - 1).long()[:, None]
        off = _take_rows(tex.img_offset, img).gather(1, lv)[:, 0]
        w = _take_rows(tex.img_w, img).gather(1, lv)[:, 0]
        h = _take_rows(tex.img_h, img).gather(1, lv)[:, 0]
    # wrap repeat; v flipped (uv origin bottom-left, image row 0 on top)
    x = torch.remainder(u, 1.0) * w.to(torch.float32) - 0.5
    y = torch.remainder(1.0 - torch.remainder(v, 1.0), 1.0) * h.to(torch.float32) - 0.5
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = (x - x0.to(torch.float32))[:, None]
    fy = (y - y0.to(torch.float32))[:, None]
    # ONE fat-row gather per bilinear tap: the quad pool row at (x0, y0)
    # holds all four wrap-neighbour texels (schema.texels_quad)
    q = _take_rows(tex.texels_quad,
                   off + torch.remainder(y0, h) * w + torch.remainder(x0, w))
    c00, c10, c01, c11 = q[:, 0:3], q[:, 3:6], q[:, 6:9], q[:, 9:12]
    return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
            + c01 * (1 - fx) * fy + c11 * fx * fy)
