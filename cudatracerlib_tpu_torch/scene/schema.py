"""Device-side scene representation: NamedTuples of SoA tensors.

Port of ``cudatracerlib_tpu/scene/schema.py``. Every polymorphic family
(BSDF, light, sensor, texture) is a table with a type-id column and a
fixed-width parameter matrix; the enums and widths are copied verbatim.

Two table families store int32 data bitcast into float32: the fat-row links
and triangle ids of ``GeometryTable.wide`` and the material, light and node
ids of ``GeometryTable.shade``. Readers take their bits with
``.view(torch.int32)``; no code converts their values.

``SceneData.host`` holds numpy mirrors of the small metadata tables, so
tracer construction reads nothing back from the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor

# BSDF types (reference: SceneTypes/BSDF_Simple.h + BSDF_Complex.h)
BSDF_DIFFUSE = 0
BSDF_ROUGHDIFFUSE = 1
BSDF_DIELECTRIC = 2
BSDF_THINDIELECTRIC = 3
BSDF_ROUGHDIELECTRIC = 4
BSDF_CONDUCTOR = 5
BSDF_ROUGHCONDUCTOR = 6
BSDF_PLASTIC = 7
BSDF_ROUGHPLASTIC = 8
BSDF_PHONG = 9
BSDF_WARD = 10
BSDF_HK = 11
BSDF_COATING = 12
BSDF_ROUGHCOATING = 13
BSDF_BLEND = 14
BSDF_NULL = 15

# Light types (reference: SceneTypes/Light.h)
LIGHT_POINT = 0
LIGHT_DIFFUSE = 1     # area light
LIGHT_DISTANT = 2
LIGHT_SPOT = 3
LIGHT_INFINITE = 4    # environment map

# Sensor types (reference: SceneTypes/Sensor.h)
SENSOR_SPHERICAL = 0
SENSOR_PERSPECTIVE = 1
SENSOR_THINLENS = 2
SENSOR_ORTHOGRAPHIC = 3
SENSOR_TELECENTRIC = 4

# Texture types (reference: SceneTypes/Texture.h)
TEX_CONSTANT = 0
TEX_CHECKERBOARD = 1
TEX_BILERP = 2
TEX_IMAGE = 3
TEX_UV = 4
TEX_WIREFRAME = 5
TEX_EXTRADATA = 6

N_MAT_PARAMS = 40  # slots 32..36 hold the alpha-blend test
N_MAT_TEX = 4      # texture slots: 0=reflectance, 1=second albedo, 2=alpha-mask, 3=bump

ALPHA_DISABLED = 0
ALPHA_LUMINANCE = 1
ALPHA_ALPHA = 2
ALPHA_COLOR = 3
ALPHA_SRC_REFLECTANCE = 4
N_LIGHT_PARAMS = 24
N_TEX_PARAMS = 12


class InstanceTable(NamedTuple):
    """Two-level (TLAS/BLAS) instancing: per-instance transforms over shared
    local-space BLAS subtrees of the unified fat-row table
    (ops/instanced.py). Each visited instance re-traverses the shared table
    from its own root row; ``tlas`` (present from
    ``host.DynamicScene.TLAS_MIN_INSTANCES`` instances on) is an 8-wide BVH
    over the instance boxes whose leaf links keep the binary builder's
    -2-(first*16+count) codes over ``tlas_order``."""
    w2l: Tensor        # (I, 3, 4) world->local affine
    l2w: Tensor        # (I, 3, 4) local->world affine
    root: Tensor       # (I,) i32 BLAS root row in GeometryTable.wide
    mat_id: Tensor     # (I,) i32 material override (-1: the tri's own)
    light_id: Tensor   # (I,) i32 area-light row (-2: the tri's own)
    node_id: Tensor    # (I,) i32 scene-graph node (-1: the flat part)
    lo: Tensor         # (I, 3) world-space instance AABB
    hi: Tensor         # (I, 3)
    inv_scale: Tensor  # (I,) |det l2w_rot|^(-1/3): uv-density correction
    tlas: "Tensor | None" = None        # (R_tlas, 128) f32 TLAS node rows
    tlas_order: "Tensor | None" = None  # (I,) i32 leaf-contiguous instance ids
    # per-instance TOP-LOCAL root row in the treelet top table, when the
    # shared table is split (treelet.TreeletTable.root_top of its part)
    root_top: "Tensor | None" = None


class GeometryTable(NamedTuple):
    """Triangle soup + BVH. The builds leave the per-tri columns (``tris``,
    ``n0`` ... ``node_id``) as None: every reader uses the packed ``shade``
    rows and the ``wide`` fat-row table. Tables of more than 2,048 rows also
    carry their treelet split (scene/treelet.py), row-major: ``tt_top``
    (R_top, 128), ``tt_slabs`` (n_treelets, rows, 128) and ``tt_vid``
    (n_vids, 2); smaller tables leave the three as None. Without instancing
    everything is world space and ``inst`` is None; with it, the triangle
    pool and ``wide`` hold each shared mesh once in LOCAL space, and
    ``inst`` maps rays and hits between the spaces."""
    tris: "Tensor | None"   # (T, 12) f32 [v0, e1, e2, pad]
    nodes: Tensor           # (N, 16) f32 packed 2-wide BVH nodes
    tri_order: Tensor       # (T,) i32
    wide: Tensor            # (R, 128) f32 unified 8-wide fat-row BVH
    n0: "Tensor | None"
    n1: "Tensor | None"
    n2: "Tensor | None"
    uv0: "Tensor | None"
    uv1: "Tensor | None"
    uv2: "Tensor | None"
    ng: "Tensor | None"
    mat_id: "Tensor | None"
    light_id: "Tensor | None"
    node_id: "Tensor | None"
    shade: Tensor           # (T, 32) f32 packed shading rows (pack_shade_rows)
    tt_top: "Tensor | None" = None    # (R_top, 128) f32 treelet top table
    tt_slabs: "Tensor | None" = None  # (n_treelets, rows, 128) f32 slabs
    tt_vid: "Tensor | None" = None    # (n_vids, 2) i32 (treelet, root) map
    inst: "InstanceTable | None" = None


SHADE_WIDTH = 32


def pack_shade_rows(n0, n1, n2, uv0, uv1, uv2, ng, v0, v1, v2,
                    mat_id, light_id, node_id, extra=None):
    """Pack per-triangle shading data into one (T, 32) fat row (numpy).

    Layout: [0:3]=n0 [3:6]=n1 [6:9]=n2 [9:11]=uv0 [11:13]=uv1 [13:15]=uv2
    [15:18]=ng [18:21]=dpdu (0 when the UV map is degenerate) [21]=uv_density
    [22]=degenerate flag [23]=mat_id [24]=light_id [25]=node_id (i32 bitcast)
    [26:29]=per-vertex extra data.
    """
    T = n0.shape[0]
    rows = np.zeros((T, SHADE_WIDTH), np.float32)
    if extra is not None:
        rows[:, 26:29] = np.asarray(extra, np.float32)
    rows[:, 0:3] = n0
    rows[:, 3:6] = n1
    rows[:, 6:9] = n2
    rows[:, 9:11] = uv0
    rows[:, 11:13] = uv1
    rows[:, 13:15] = uv2
    rows[:, 15:18] = ng
    e1 = (v1 - v0).astype(np.float32)
    e2 = (v2 - v0).astype(np.float32)
    duv1 = (uv1 - uv0).astype(np.float32)
    duv2 = (uv2 - uv0).astype(np.float32)
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    degenerate = np.abs(det) < 1e-12
    inv_det = np.where(degenerate, 0.0, 1.0 / np.where(degenerate, 1.0, det))
    rows[:, 18:21] = (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2) * inv_det[:, None]
    world_area2 = np.linalg.norm(np.cross(e1, e2), axis=-1)
    rows[:, 21] = np.sqrt(np.abs(det) / np.maximum(world_area2, 1e-20))
    rows[:, 22] = degenerate.astype(np.float32)
    rows[:, 23] = np.asarray(mat_id, np.int32).view(np.float32)
    rows[:, 24] = np.asarray(light_id, np.int32).view(np.float32)
    rows[:, 25] = np.asarray(node_id, np.int32).view(np.float32)
    return rows


class MaterialTable(NamedTuple):
    """BSDF aggregate: type id + params + texture slots + optional nested bsdf."""
    mat_type: Tensor    # (M,) i32
    params: Tensor      # (M, N_MAT_PARAMS) f32
    tex: Tensor         # (M, N_MAT_TEX) i32 texture table ids (-1 = none)
    nested: Tensor      # (M,) i32 nested simple-bsdf row for coating/blend (-1)
    nested2: Tensor     # (M,) i32 second nested row for blend (-1)


class TextureTable(NamedTuple):
    """Texture aggregate + image atlas: every image's mip chain lies in one
    flat texel pool, and ``texels_quad`` holds each texel's 2x2 wrap
    neighbourhood so a bilinear tap is one row gather."""
    tex_type: Tensor    # (X,) i32
    params: Tensor      # (X, N_TEX_PARAMS) f32
    image_id: Tensor    # (X,) i32
    img_offset: Tensor  # (I, MAX_MIPS) i32
    img_w: Tensor       # (I, MAX_MIPS) i32
    img_h: Tensor       # (I, MAX_MIPS) i32
    img_nmips: Tensor   # (I,) i32
    texels: Tensor      # (P, 3) f32
    img_cone: Tensor    # (I,) i32
    texels_quad: Tensor  # (P, 12) f32


class LightTable(NamedTuple):
    light_type: Tensor  # (L,) i32
    params: Tensor      # (L, N_LIGHT_PARAMS) f32
    power_cdf: Tensor   # (L,) f32 normalized inclusive CDF over emitter power
    al_tris: Tensor     # (AT,) i32 area-light triangle ids
    al_cdf: Tensor      # (AT,) f32 per-light inclusive CDF over tri area
    al_first: Tensor    # (L,) i32 offset into al_tris
    al_count: Tensor    # (L,) i32
    env_map: Tensor     # (He, We, 3) f32 radiance (1x1 black if absent)
    env_alias: Tensor   # (He*We, 4) f32
    env_pmf: Tensor     # (He, We) f32
    env_to_world: Tensor  # (4, 4)
    env_world_to: Tensor  # (4, 4)
    al_rows: Tensor     # (AT, 12) f32 area-light triangle rows [v0 e1 e2 ng]
    al_alias: Tensor    # (AT, 2) f32 per-light alias rows [prob, abs alias bits]


class SensorData(NamedTuple):
    sensor_type: int     # SENSOR_* (uniform per scene, so a Python int)
    to_world: Tensor     # (4, 4) f32 camera-to-world
    to_world_inv: Tensor  # (4, 4)
    params: Tensor       # (16,) f32: [fov, near, far, aperture_r, focus_dist,
    #                      film_w, film_h, ortho_scale_x, ortho_scale_y, ...]


class MediumTable(NamedTuple):
    """Participating media: homogeneous volumes and density grids, each
    filling the image of the unit cube under its to_world (layout of
    params and grid_offset in models/medium.py)."""
    med_type: Tensor    # (V,) i32
    params: Tensor      # (V, 24) f32
    to_world: Tensor    # (V, 4, 4)
    world_to: Tensor    # (V, 4, 4)
    grid_offset: Tensor  # (V, 3) i32
    grid_dim: Tensor    # (V, 3) i32
    voxels: Tensor      # (VP,) f32


class SceneData(NamedTuple):
    """The full device scene view; every tensor lies on one device."""
    geom: GeometryTable
    materials: MaterialTable
    textures: TextureTable
    lights: LightTable
    sensor: SensorData
    media: MediumTable
    world_lo: Tensor    # (3,)
    world_hi: Tensor    # (3,)
    host: dict          # numpy mirrors of the metadata (see host_meta)

    @property
    def device(self) -> torch.device:
        return self.geom.wide.device

    @property
    def num_tris(self) -> int:
        return self.geom.shade.shape[0]

    @property
    def num_lights(self) -> int:
        return self.lights.light_type.shape[0]


def host_meta(scene: SceneData) -> dict:
    """Numpy mirrors of the scene's small metadata tables: mat_type, mat_tex,
    mat_alpha_mode, mat_parallax, mat_bssrdf, world_lo, world_hi,
    light_type, n_media; the port's own
    builds add build_seconds (host seconds of the BVH build and of the
    treelet partition)."""
    return scene.host


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point of the port builds on. The default is the
    card; asking for a CUDA device without one raises (pass "cpu" to build
    on the CPU): nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for {device!r}: the port builds on the card "
            "unless the caller asks for the CPU (device='cpu')")
    return dev


def to_tensor(a, device) -> Tensor:
    """numpy -> tensor on `device`, with the JAX package's 32-bit
    canonicalisation (float64 -> float32, int64 -> int32)."""
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def scene_from_numpy(arrays: dict, host_meta: dict, device="cuda") -> SceneData:
    """Build the port's SceneData from a JAX SceneData flattened to numpy.

    `arrays` maps dotted leaf names ("geom.wide", "geom.inst.root",
    "lights.al_rows", "sensor.sensor_type", "world_lo", ...) to numpy arrays; leaves the JAX
    scene holds as None are simply absent. Bitcast int32 payloads travel as
    the float32 bits they are stored in; nothing converts their values.
    The treelet tables arrive in the JAX device layout (transposed, padded)
    and are turned back into the port's row-major layout. `device` defaults
    to the card (``resolve_device``)."""
    device = resolve_device(device)
    arrays = dict(arrays)
    if "geom.tt_top" in arrays:
        from . import treelet
        arrays["geom.tt_top"], arrays["geom.tt_slabs"] = \
            treelet.from_jax_layout(np.asarray(arrays["geom.tt_top"]),
                                    np.asarray(arrays["geom.tt_slabs"]))

    def table(cls, prefix):
        kw = {}
        for f in cls._fields:
            key = f"{prefix}.{f}"
            kw[f] = to_tensor(arrays[key], device) if key in arrays else None
        return cls(**kw)

    sensor = table(SensorData, "sensor")._replace(
        sensor_type=int(arrays["sensor.sensor_type"]))
    geom = table(GeometryTable, "geom")
    if "geom.inst.root" in arrays:
        geom = geom._replace(inst=table(InstanceTable, "geom.inst"))
    return SceneData(
        geom=geom,
        materials=table(MaterialTable, "materials"),
        textures=table(TextureTable, "textures"),
        lights=table(LightTable, "lights"),
        sensor=sensor,
        media=table(MediumTable, "media"),
        world_lo=to_tensor(arrays["world_lo"], device),
        world_hi=to_tensor(arrays["world_hi"], device),
        host=dict(host_meta))
