"""Surface interaction construction from ray hits.

Port of ``cudatracerlib_tpu/ops/shading.py``: one shade-row gather per
hit, then interpolated normals, UVs and a tangent frame. In a two-level
scene the rows are in the instance's local space: normals go to world
space by the inverse transpose of local-to-world (w2l's rotation,
transposed), dpdu by local-to-world, the uv density by the instance's
inv_scale, and the instance's material and light override the triangle's
(the sentinels -1 and -2 of the flat part keep the triangle's own). The
matrix products are separate multiplies and adds, so the card and the CPU
round them alike.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import frame as fr
from ..core import vecmath as vm
from ..scene import schema
from . import traversal

Tensor = torch.Tensor


class SurfaceInteraction(NamedTuple):
    valid: Tensor    # (B,) hit anything
    p: Tensor        # (B, 3) hit position
    t: Tensor        # (B,) distance
    ng: Tensor       # (B, 3) geometric normal
    ns: Tensor       # (B, 3) interpolated shading normal
    uv: Tensor       # (B, 2)
    frame_t: Tensor  # (B, 3) shading tangent
    frame_s: Tensor  # (B, 3) shading bitangent
    bary: Tensor     # (B, 2) (u, v)
    mat_id: Tensor   # (B,) i32
    light_id: Tensor  # (B,) i32
    tri: Tensor      # (B,) i32
    wi: Tensor       # (B, 3) unit direction toward the ray origin (world)
    flipped: Tensor  # (B,) bool: true if normals were flipped to face the ray
    uv_density: Tensor  # (B,) sqrt(uv area / world area) for ray-cone mip LOD
    extra: "Tensor | None" = None  # (B,) interpolated per-vertex extra data

    def frame(self) -> fr.Frame:
        return fr.Frame(self.frame_t, self.frame_s, self.ns)


def fill_dg(geom: schema.GeometryTable, rays: traversal.Rays,
            hit: traversal.Hit, flip_to_ray: bool = True) -> SurfaceInteraction:
    """One fat-row gather per hit (schema.pack_shade_rows layout)."""
    # clamp before the gather: an out-of-range index stops a CUDA device
    tid = hit.tri.clamp(0, geom.shade.shape[0] - 1).long()
    u, v = hit.u, hit.v
    w = 1.0 - u - v
    row = geom.shade[tid]                               # (B, 32)
    n0, n1, n2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    uv0, uv1, uv2 = row[:, 9:11], row[:, 11:13], row[:, 13:15]
    ns = vm.normalize(w[:, None] * n0 + u[:, None] * n1 + v[:, None] * n2)
    uv = w[:, None] * uv0 + u[:, None] * uv1 + v[:, None] * uv2
    ng = row[:, 15:18]
    p = rays.o + rays.d * hit.t[:, None]
    dpdu = row[:, 18:21]
    uv_density = row[:, 21]
    degenerate = row[:, 22] > 0.5
    mat_id = row[:, 23].view(torch.int32)
    light_id = row[:, 24].view(torch.int32)

    if geom.inst is not None and hit.inst is not None:
        it = geom.inst
        ik = hit.inst.clamp_min(0).long()
        w2l = it.w2l[ik]                                 # (B, 3, 4)
        # w2l_rot^T @ n: row j of the result is sum_i w2l[i, j] * n[i]
        rot_t = lambda n: (w2l[:, 0, :3] * n[:, 0:1] + w2l[:, 1, :3] * n[:, 1:2]
                           + w2l[:, 2, :3] * n[:, 2:3])
        ns = vm.normalize(rot_t(ns))
        ng = vm.normalize(rot_t(ng))
        l2w = it.l2w[ik]
        dpdu = (l2w[:, :, 0] * dpdu[:, 0:1] + l2w[:, :, 1] * dpdu[:, 1:2]
                + l2w[:, :, 2] * dpdu[:, 2:3])
        uv_density = uv_density * it.inv_scale[ik]
        imat = it.mat_id[ik]
        mat_id = torch.where(imat >= 0, imat, mat_id)
        ilight = it.light_id[ik]
        light_id = torch.where(ilight != -2, ilight, light_id)

    if flip_to_ray:
        flip = vm.dot(ng, rays.d) > 0.0
        ng = torch.where(flip[:, None], -ng, ng)
        flip_s = vm.dot(ns, rays.d) > 0.0
        ns = torch.where(flip_s[:, None], -ns, ns)
    else:
        flip = torch.zeros(hit.t.shape, dtype=torch.bool, device=hit.t.device)

    # tangent frame: Gram-Schmidt dpdu against ns; fallback to branchless ONB
    t_fallback, _ = vm.coordinate_system(ns)
    t_raw = torch.where(degenerate[:, None], t_fallback, dpdu)
    t_proj = t_raw - ns * vm.dot(t_raw, ns)[:, None]
    tiny = vm.length_sqr(t_proj) < 1e-16
    t_final = vm.normalize(torch.where(tiny[:, None], t_fallback, t_proj))
    s_final = vm.cross(ns, t_final)

    extra = w * row[:, 26] + u * row[:, 27] + v * row[:, 28]
    return SurfaceInteraction(
        valid=hit.tri >= 0, p=p, t=hit.t, ng=ng, ns=ns, uv=uv,
        frame_t=t_final, frame_s=s_final,
        bary=torch.stack([u, v], -1),
        mat_id=mat_id, light_id=light_id, tri=hit.tri,
        wi=-rays.d, flipped=flip, uv_density=uv_density, extra=extra)


def offset_ray_origin(p: Tensor, n: Tensor, d: Tensor, eps: float = 1e-4) -> Tensor:
    """Offset a secondary-ray origin along the geometric normal to avoid
    self-intersection (scale-aware epsilon)."""
    scale = p.abs().amax(dim=-1).clamp_min(1.0)
    off = (eps * scale)[:, None] * torch.where(vm.dot(d, n)[:, None] >= 0, n, -n)
    return p + off
