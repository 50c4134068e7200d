"""Host-side scene management: build the device tables from meshes,
materials, lights and an environment map.

Port of ``cudatracerlib_tpu/scene/host.py``. Scenes under 4,096 triangles
take the numpy binned-SAH builder; larger ones the native builder
(``scene/native_bvh.py``), a dummy 2-wide BVH, and, when the fat-row table
exceeds 2,048 rows, its treelet split (``scene/treelet.py``). A mesh shared
by several nodes makes a two-level scene (``build(instancing="auto")``):
each shared mesh is stored once in local space, with an ``InstanceTable``
of per-node transforms and, from 32 instances on, an 8-wide TLAS over
their boxes. ``update_transforms`` moves nodes without a rebuild: an
instance's row is rewritten, or a flat table is refit. Images get their
full mip chain in one texel pool, and a parallax material's height map its
cone-step map (``scene/conemap.py``) in the same pool. Homogeneous and grid
media fill the image of the unit cube under their to_world, and the world
bounds grow to hold them. The numpy code is carried over verbatim; tensors
are made only at the ``SceneData`` boundary (``schema.to_tensor``), and the
arrays are byte-identical to the JAX build's (the treelet tables in the
port's row-major layout).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from . import alias as aliasmod
from . import bvh as bvhmod
from . import bvh8 as bvh8mod
from . import conemap, native_bvh, schema, shapes
from . import treelet as treeletmod
from ..ops import traversal8

MAX_FLAT_TRIS = 4096  # from here on the native builder, as in the JAX build
_CORNERS01 = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                       for z in (0, 1)], np.float32)
MAX_MIPS = 12
LUM_W = np.array([0.212671, 0.715160, 0.072169], np.float32)


@dataclass
class TextureSpec:
    tex_type: int = schema.TEX_CONSTANT
    value: tuple = (1.0, 1.0, 1.0)      # constant / color0
    value1: tuple = (0.0, 0.0, 0.0)     # checkerboard color1 / bilerp corners
    uv_scale: tuple = (1.0, 1.0)
    uv_offset: tuple = (0.0, 0.0)
    image: Optional[np.ndarray] = None  # (H, W, 3) float32 linear RGB


@dataclass
class MaterialSpec:
    """Host-side BSDF description; packed into MaterialTable rows by build().

    Parameter conventions follow the Mitsuba BSDF set the reference implements
    (SceneTypes/BSDF_Simple.h / BSDF_Complex.h).
    """
    bsdf_type: int = schema.BSDF_DIFFUSE
    reflectance: tuple = (0.5, 0.5, 0.5)    # c0: albedo / specular reflectance
    transmittance: tuple = (1.0, 1.0, 1.0)  # c1: spec transmittance / diffuse of plastic&phong
    eta: float = 1.5                         # int_ior/ext_ior (dielectrics, plastic, coating)
    alpha: float = 0.1                       # roughness (isotropic default)
    alpha_v: Optional[float] = None          # anisotropic second roughness
    distribution: int = 1                    # microfacet type (core.microfacet: 0=beckmann,1=ggx,2=phong)
    eta_c: tuple = (0.2, 0.9, 1.4)           # conductor spectral eta
    k_c: tuple = (3.9, 2.5, 2.1)             # conductor spectral k
    exponent: float = 30.0                   # phong exponent
    nonlinear: bool = False                  # plastic
    sigma_s: tuple = (0.0, 0.0, 0.0)         # hk scattering
    sigma_a: tuple = (0.0, 0.0, 0.0)         # hk / coating absorption
    phase_g: float = 0.0                     # hk phase
    thickness: float = 1.0                   # hk / coating layer thickness
    blend_weight: float = 0.5                # blend
    dispersion_b: float = 0.0                # Cauchy B (um^2): >0 = dispersive dielectric
    nested: Optional["MaterialSpec"] = None  # coating/blend inner bsdf
    nested2: Optional["MaterialSpec"] = None  # blend second bsdf
    # texture slots (None = use the constant tuples above)
    tex_reflectance: Optional[TextureSpec] = None
    tex_transmittance: Optional[TextureSpec] = None
    tex_alpha_mask: Optional[TextureSpec] = None
    tex_bump: Optional[TextureSpec] = None
    # alpha-blend test (reference AlphaBlendData, Engine/Material.h:13-35):
    # 0 keeps the continuous Mitsuba opacity semantics of tex_alpha_mask;
    # schema.ALPHA_* modes make the test binary (luminance / alpha / color)
    alpha_mode: int = 0
    alpha_test: float = 0.5
    alpha_test_color: tuple = (0.0, 0.0, 0.0)
    parallax_scale: float = 0.0   # >0: parallax-occlusion mapping with the bump height map
    # BSSRDF: internal medium attached to the surface (reference
    # Material.h:38-60 GetBSSRDF); paths transmitting into the surface
    # random-walk through this homogeneous medium until they exit
    bssrdf_sigma_a: tuple = (0.0, 0.0, 0.0)
    bssrdf_sigma_s: tuple = (0.0, 0.0, 0.0)
    bssrdf_g: float = 0.0
    two_sided: bool = True


@dataclass
class _Node:
    mesh: shapes.TriMesh          # object-space mesh
    to_world: np.ndarray          # (4, 4)
    material: int                 # material row
    emission: Optional[tuple]     # area-light radiance or None
    name: str = ""


def _pack_material(spec: MaterialSpec, mats: list, texs: list) -> int:
    """Append spec (and nested specs) to the tables; returns the row index."""
    def tex_id(t: Optional[TextureSpec]) -> int:
        if t is None:
            return -1
        texs.append(t)
        return len(texs) - 1

    nested_id = _pack_material(spec.nested, mats, texs) if spec.nested else -1
    nested2_id = _pack_material(spec.nested2, mats, texs) if spec.nested2 else -1
    p = np.zeros(schema.N_MAT_PARAMS, np.float32)
    p[0:3] = spec.reflectance
    p[3] = spec.alpha
    p[4] = spec.eta
    p[5] = spec.distribution
    p[6] = spec.alpha
    p[7] = spec.alpha_v if spec.alpha_v is not None else spec.alpha
    p[8:11] = spec.eta_c
    p[11:14] = spec.k_c
    p[14] = 1.0 if spec.nonlinear else 0.0
    p[15] = spec.exponent
    p[16] = spec.phase_g
    p[17] = spec.thickness
    p[18] = spec.blend_weight
    p[19:22] = spec.transmittance
    p[22] = 1.0 if spec.two_sided else 0.0
    p[23] = spec.dispersion_b
    p[24] = spec.parallax_scale
    p[25:28] = spec.bssrdf_sigma_a
    p[28:31] = spec.bssrdf_sigma_s
    p[31] = spec.bssrdf_g
    p[32] = spec.alpha_mode
    p[33] = spec.alpha_test
    p[34:37] = spec.alpha_test_color
    # sigma_s/sigma_a for hk share the color slots (c0/c1) by convention
    row = dict(mat_type=spec.bsdf_type, params=p,
               tex=np.array([tex_id(spec.tex_reflectance), tex_id(spec.tex_transmittance),
                             tex_id(spec.tex_alpha_mask), tex_id(spec.tex_bump)], np.int32),
               nested=nested_id, nested2=nested2_id)
    mats.append(row)
    return len(mats) - 1


def _pack_al_rows(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                  al_tris: np.ndarray) -> np.ndarray:
    """(AT, 12) area-light tri fat rows [v0 e1 e2 ng] (schema.LightTable
    .al_rows): precomputed so GeometryTable needs no (T, 12) tris table."""
    if v0.shape[0] == 0:
        return np.zeros((al_tris.shape[0], 12), np.float32)
    ids = np.clip(al_tris.astype(np.int64), 0, v0.shape[0] - 1)
    a = v0[ids].astype(np.float32)
    e1 = (v1[ids] - v0[ids]).astype(np.float32)
    e2 = (v2[ids] - v0[ids]).astype(np.float32)
    ng = np.cross(e1, e2)
    ng = ng / np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
    return np.concatenate([a, e1, e2, ng.astype(np.float32)], axis=-1)


class DynamicScene:
    """Mutable host scene; `build()` produces the immutable device SceneData."""

    def __init__(self):
        self._nodes: list[_Node] = []
        self._materials: list[dict] = []
        self._textures: list[TextureSpec] = []
        self._lights: list[dict] = []       # non-area lights
        self._env: Optional[dict] = None
        self._sensor: Optional[schema.SensorData] = None
        self._media: list[dict] = []

    # -- materials ---------------------------------------------------------
    def add_material(self, spec: MaterialSpec) -> int:
        return _pack_material(spec, self._materials, self._textures)

    # -- geometry ----------------------------------------------------------
    def create_node(self, mesh: shapes.TriMesh, material: int,
                    to_world: Optional[np.ndarray] = None,
                    emission: Optional[tuple] = None, name: str = "") -> int:
        if mesh.n is None:
            mesh = shapes.compute_vertex_normals(mesh)
        if to_world is None:
            to_world = np.eye(4, dtype=np.float32)
        self._nodes.append(_Node(mesh, np.asarray(to_world, np.float32),
                                 material, emission, name))
        return len(self._nodes) - 1

    # -- lights ------------------------------------------------------------
    def add_point_light(self, position, intensity):
        p = np.zeros(schema.N_LIGHT_PARAMS, np.float32)
        p[0:3] = position
        p[3:6] = intensity
        self._lights.append(dict(light_type=schema.LIGHT_POINT, params=p))

    def add_distant_light(self, direction, radiance):
        p = np.zeros(schema.N_LIGHT_PARAMS, np.float32)
        d = np.asarray(direction, np.float32)
        p[0:3] = d / np.linalg.norm(d)
        p[3:6] = radiance
        self._lights.append(dict(light_type=schema.LIGHT_DISTANT, params=p))

    def add_spot_light(self, position, direction, intensity,
                       cutoff_deg: float = 20.0, beam_deg: Optional[float] = None):
        p = np.zeros(schema.N_LIGHT_PARAMS, np.float32)
        p[0:3] = position
        p[3:6] = intensity
        d = np.asarray(direction, np.float32)
        p[8:11] = d / np.linalg.norm(d)
        p[6] = np.cos(np.deg2rad(cutoff_deg))
        p[7] = np.cos(np.deg2rad(beam_deg if beam_deg is not None else cutoff_deg * 0.75))
        self._lights.append(dict(light_type=schema.LIGHT_SPOT, params=p))

    def set_environment(self, image: np.ndarray, scale=(1.0, 1.0, 1.0),
                        to_world: Optional[np.ndarray] = None):
        self._env = dict(image=np.asarray(image, np.float32), scale=scale,
                         to_world=np.eye(4, dtype=np.float32) if to_world is None else
                         np.asarray(to_world, np.float32))

    # -- media -------------------------------------------------------------
    def add_homogeneous_medium(self, sigma_a, sigma_s, to_world,
                               phase_type: int = 0, phase_g: float = 0.0,
                               scale: float = 1.0, emission=(0, 0, 0)):
        """Medium filling the image of the unit cube [0,1]^3 under to_world."""
        self._media.append(dict(med_type=0, sigma_a=sigma_a, sigma_s=sigma_s,
                                to_world=np.asarray(to_world, np.float32),
                                phase_type=phase_type, phase_g=phase_g,
                                scale=scale, emission=emission, density=None))

    def add_grid_medium(self, density: np.ndarray, sigma_a, sigma_s, to_world,
                        phase_type: int = 0, phase_g: float = 0.0,
                        scale: float = 1.0, emission=(0, 0, 0)):
        """Heterogeneous medium: density (nz, ny, nx) scales sigma_a/sigma_s."""
        self._media.append(dict(med_type=1, sigma_a=sigma_a, sigma_s=sigma_s,
                                to_world=np.asarray(to_world, np.float32),
                                phase_type=phase_type, phase_g=phase_g,
                                scale=scale, emission=emission,
                                density=np.asarray(density, np.float32)))

    # -- sensor ------------------------------------------------------------
    def set_sensor(self, sensor: schema.SensorData):
        self._sensor = sensor

    def sensor_data(self, device="cuda") -> schema.SensorData:
        """The scene's sensor with its tensors on `device` (the card unless
        the caller asks for the CPU; raises without one)."""
        device = schema.resolve_device(device)
        sensor = self._sensor
        return sensor._replace(to_world=sensor.to_world.to(device),
                               to_world_inv=sensor.to_world_inv.to(device),
                               params=sensor.params.to(device))

    # -- build -------------------------------------------------------------
    TLAS_MIN_INSTANCES = 32

    def build(self, device="cuda", *, instancing: str = "auto") -> schema.SceneData:
        """Pack the device tables onto `device`: the card unless the caller
        asks for the CPU (``build("cpu")``). Raises without a card, before
        any host work; nothing falls back to the CPU.

        instancing: "auto" builds a two-level TLAS/BLAS scene when a mesh is
        shared by >= 2 non-emissive nodes and the sharing saves >= 1,024
        triangles (each shared mesh stored once, in local space;
        ``_build_instanced``); "off" always flattens every node into one
        world-space triangle soup with one BVH8."""
        device = schema.resolve_device(device)
        if instancing not in ("auto", "off"):
            raise ValueError(f"instancing must be 'auto' or 'off', not {instancing!r}")
        nodes = [n for n in self._nodes if n is not None]
        if not nodes:
            raise ValueError("scene has no geometry")
        if self._sensor is None:
            raise ValueError("scene has no sensor")

        if instancing == "auto":
            by_mesh: dict = {}
            for idx, node in enumerate(nodes):
                if node.emission is None:
                    by_mesh.setdefault(id(node.mesh), []).append(idx)
            # instance only when the sharing saves real memory: tiny shared
            # meshes (unit rectangles reused for walls) flatten instead
            groups = {k: v for k, v in by_mesh.items()
                      if len(v) >= 2 and (len(v) - 1)
                      * nodes[v[0]].mesh.f.shape[0] >= 1024}
            if groups:
                return self._build_instanced(nodes, groups, device)

        (v0, v1, v2, n0a, n1a, n2a, uv0a, uv1a, uv2a, mat_a, light_a, node_a,
         area_lights) = self._world_soup(nodes, range(len(nodes)))
        T = v0.shape[0]
        t_bvh = time.perf_counter()
        if T >= MAX_FLAT_TRIS:
            # the native builder; the 2-wide reference structure is a dummy,
            # since only the fat-row table is traversed
            b8 = native_bvh.build_bvh8(v0, v1, v2)
            b = bvhmod.BVH(nodes=np.zeros((1, 16), np.float32),
                           tri_order=np.arange(T, dtype=np.int32),
                           world_lo=b8.world_lo, world_hi=b8.world_hi)
        else:
            b = bvhmod.build_bvh(v0, v1, v2, max_leaf=bvh8mod.LEAF_TRIS)
            b8 = bvh8mod.collapse_bvh2(b, v0, v1, v2)
        wide = traversal8.pack_unified(b8.nodes, b8.leaves)
        t_bvh = time.perf_counter() - t_bvh
        ng = np.cross(v1 - v0, v2 - v0)
        ng = ng / np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
        shade = schema.pack_shade_rows(n0a, n1a, n2a, uv0a, uv1a, uv2a, ng,
                                       v0, v1, v2, mat_a, light_a, node_a)
        t = lambda a: schema.to_tensor(a, device)
        t_part = time.perf_counter()
        part = treeletmod.partition(wide)   # None for tables of <= 2,048 rows
        t_part = time.perf_counter() - t_part
        geom = schema.GeometryTable(
            tris=None, nodes=t(b.nodes), tri_order=t(b.tri_order), wide=t(wide),
            n0=None, n1=None, n2=None, uv0=None, uv1=None, uv2=None,
            ng=None, mat_id=None, light_id=None, node_id=None,
            shade=t(shade),
            tt_top=None if part is None else t(part.top),
            tt_slabs=None if part is None else t(part.slabs),
            tt_vid=None if part is None else t(part.vid_map))

        # scene bounds include media volumes (a medium may extend past all
        # geometry; PPM's radius and grids and the lights' scene radius
        # read them)
        w_lo, w_hi = self._grow_by_media(b.world_lo, b.world_hi)
        b = b._replace(world_lo=w_lo, world_hi=w_hi)
        host = self._host_meta(area_lights, w_lo, w_hi, t_bvh, t_part)
        return schema.SceneData(
            geom=geom, materials=self._build_materials(device),
            textures=self._build_textures(device),
            lights=self._build_lights(area_lights, v0, v1, v2, b, device),
            sensor=self.sensor_data(device),
            media=_build_media_table(self._media, device),
            world_lo=t(b.world_lo), world_hi=t(b.world_hi), host=host)

    def _world_soup(self, nodes, ids):
        """The world-space triangle soup of nodes[ids], in that order:
        (v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, mat_id, light_id, node_id,
        area_lights); an emissive node's triangles become one area light
        (its light row follows the non-area lights)."""
        v0s, v1s, v2s, n0s, n1s, n2s = [], [], [], [], [], []
        uv0s, uv1s, uv2s, mats, lights_, nids = [], [], [], [], [], []
        area_lights = []  # dict(first, count, radiance)
        tri_cursor = 0
        n_other = len(self._lights)
        for node_idx in ids:
            node = nodes[node_idx]
            m = node.mesh.transformed(node.to_world)
            f = m.f
            v0s.append(m.v[f[:, 0]]); v1s.append(m.v[f[:, 1]]); v2s.append(m.v[f[:, 2]])
            n0s.append(m.n[f[:, 0]]); n1s.append(m.n[f[:, 1]]); n2s.append(m.n[f[:, 2]])
            uv = m.uv if m.uv is not None else np.zeros((m.v.shape[0], 2), np.float32)
            uv0s.append(uv[f[:, 0]]); uv1s.append(uv[f[:, 1]]); uv2s.append(uv[f[:, 2]])
            nf = f.shape[0]
            mats.append(np.full(nf, node.material, np.int32))
            nids.append(np.full(nf, node_idx, np.int32))
            if node.emission is not None:
                lights_.append(np.full(nf, n_other + len(area_lights), np.int32))
                area_lights.append(dict(first=tri_cursor, count=nf,
                                        radiance=np.asarray(node.emission, np.float32)))
            else:
                lights_.append(np.full(nf, -1, np.int32))
            tri_cursor += nf
        cat = lambda xs, d: (np.concatenate(xs) if xs else
                             np.zeros((0, d), np.float32) if d else
                             np.zeros(0, np.int32))
        return (cat(v0s, 3), cat(v1s, 3), cat(v2s, 3), cat(n0s, 3),
                cat(n1s, 3), cat(n2s, 3), cat(uv0s, 2), cat(uv1s, 2),
                cat(uv2s, 2), cat(mats, 0), cat(lights_, 0), cat(nids, 0),
                area_lights)

    def _grow_by_media(self, lo, hi):
        """World bounds (lo, hi) grown by every medium's box, float32."""
        w_lo = np.asarray(lo, np.float32).copy()
        w_hi = np.asarray(hi, np.float32).copy()
        corners = np.array([[x, y, z, 1.0] for x in (0, 1) for y in (0, 1)
                            for z in (0, 1)], np.float32)
        for med in self._media:
            m2w = np.asarray(med["to_world"], np.float32)
            pts = (corners @ m2w.T)[:, :3]
            w_lo = np.minimum(w_lo, pts.min(0))
            w_hi = np.maximum(w_hi, pts.max(0))
        return w_lo, w_hi

    def _host_meta(self, area_lights, w_lo, w_hi, t_bvh, t_part) -> dict:
        mats = self._materials or [dict(mat_type=schema.BSDF_DIFFUSE,
                                        tex=np.full(schema.N_MAT_TEX, -1, np.int32),
                                        params=np.zeros(schema.N_MAT_PARAMS, np.float32))]
        return dict(
            mat_type=np.asarray([m["mat_type"] for m in mats], np.int32),
            mat_tex=np.stack([np.asarray(m["tex"], np.int32) for m in mats]),
            mat_alpha_mode=np.asarray([m["params"][32] for m in mats], np.float32),
            mat_parallax=np.asarray([m["params"][24] for m in mats], np.float32),
            mat_bssrdf=np.asarray([float(m["params"][25:31].sum()) for m in mats],
                                  np.float32),
            world_lo=np.asarray(w_lo, np.float32),
            world_hi=np.asarray(w_hi, np.float32),
            light_type=np.asarray([l["light_type"] for l in self._lights]
                                  + [schema.LIGHT_DIFFUSE] * len(area_lights)
                                  + ([schema.LIGHT_INFINITE] if self._env is not None else []),
                                  np.int32),
            n_media=len(self._media),
            build_seconds=dict(bvh=t_bvh, treelet=t_part),
        )

    @staticmethod
    def _add_tlas(h: dict) -> None:
        """Attach (or refresh) the 8-wide TLAS over the instance boxes of the
        host instance table `h` (ops/instanced.tlas_visits reads it). Fewer
        than TLAS_MIN_INSTANCES instances keep the dense slab scan
        (tlas=None)."""
        I = h["root"].shape[0]
        if I < DynamicScene.TLAS_MIN_INSTANCES:
            h["tlas"] = None
            h["tlas_order"] = None
            return
        table, order = bvh8mod.build_tlas8(np.asarray(h["lo"], np.float32),
                                           np.asarray(h["hi"], np.float32))
        h["tlas"] = table
        h["tlas_order"] = np.asarray(order, np.int32)

    @staticmethod
    def _instance_table(h: dict, device) -> schema.InstanceTable:
        return schema.InstanceTable(**{
            k: None if v is None else schema.to_tensor(v, device)
            for k, v in h.items()})

    def _build_instanced(self, nodes, groups, device) -> schema.SceneData:
        """Two-level TLAS/BLAS build: each mesh shared by several nodes is
        kept once in LOCAL space (one BLAS each); the per-node transforms
        live in an InstanceTable. Emissive nodes stay flattened (area-light
        sampling needs world triangles); the flattened remainder is the
        first part and instance 0, with an identity transform and the
        sentinels material -1 and light -2 (the triangles' own). Parts in
        order: the flat part, then the groups in insertion order; each gets
        its own BVH8, its links and triangle ids shifted to its place in
        the concatenated table. A table of more than 2,048 rows is split
        into treelets from every part root, and each instance carries its
        root's top-local row (root_top)."""
        inst_node_ids = set(i for v in groups.values() for i in v)
        flat_ids = [i for i in range(len(nodes)) if i not in inst_node_ids]

        def local_part(mesh):
            f = mesh.f
            m = mesh if mesh.n is not None else shapes.compute_vertex_normals(mesh)
            uv = m.uv if m.uv is not None else np.zeros((m.v.shape[0], 2), np.float32)
            T = f.shape[0]
            return (m.v[f[:, 0]], m.v[f[:, 1]], m.v[f[:, 2]],
                    m.n[f[:, 0]], m.n[f[:, 1]], m.n[f[:, 2]],
                    uv[f[:, 0]], uv[f[:, 1]], uv[f[:, 2]],
                    np.zeros(T, np.int32), np.full(T, -1, np.int32),
                    np.full(T, -1, np.int32))

        parts = []
        flat = self._world_soup(nodes, flat_ids)
        fv0, fv1, fv2, area_lights = flat[0], flat[1], flat[2], flat[12]
        if fv0.shape[0] > 0:
            parts.append(dict(arrs=flat[:12], flat=True))
        group_items = list(groups.items())
        for _, idxs in group_items:
            parts.append(dict(arrs=local_part(nodes[idxs[0]].mesh), flat=False))

        # per-part BVH, link and triangle-id fix-up, concatenation
        t_bvh = time.perf_counter()
        row_off = 0
        tri_off = 0
        wides, shades = [], []
        for part in parts:
            v0, v1, v2, n0, n1, n2, u0, u1, u2, ma, li, ni = part["arrs"]
            T = v0.shape[0]
            if T >= MAX_FLAT_TRIS:
                b8 = native_bvh.build_bvh8(v0, v1, v2)
            else:
                b8 = bvh8mod.build_bvh8(v0, v1, v2)
            n8 = b8.nodes.shape[0]
            wide_p = traversal8.pack_unified(b8.nodes, b8.leaves).copy()
            lk = wide_p[:n8, 48:56].copy().view(np.int32)
            internal = lk >= 0
            leaf = lk <= -2
            lk[internal] += row_off
            lk[leaf] = -2 - ((-2 - lk[leaf]) + row_off)
            wide_p[:n8, 48:56] = lk.view(np.float32)
            ids = wide_p[n8:, 108:120].copy().view(np.int32)
            ids[ids >= 0] += tri_off
            wide_p[n8:, 108:120] = ids.view(np.float32)
            ng = np.cross(v1 - v0, v2 - v0)
            ng = ng / np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
            shades.append(schema.pack_shade_rows(n0, n1, n2, u0, u1, u2, ng,
                                                 v0, v1, v2, ma, li, ni))
            part["root"] = row_off
            part["lo"] = b8.world_lo
            part["hi"] = b8.world_hi
            row_off += wide_p.shape[0]
            tri_off += T
            wides.append(wide_p)
        wide_all = np.concatenate(wides)
        t_bvh = time.perf_counter() - t_bvh

        # the forest's treelet split from every part root; each instance
        # maps to its BLAS root's top-local row
        part_roots = tuple(int(p["root"]) for p in parts)
        t_part = time.perf_counter()
        tpart = treeletmod.partition(wide_all, roots=part_roots)
        t_part = time.perf_counter() - t_part
        root_top_of = (None if tpart is None else
                       {r: int(rt) for r, rt in zip(part_roots, tpart.root_top)})
        t = lambda a: schema.to_tensor(a, device)
        geom = schema.GeometryTable(
            tris=None, nodes=t(np.zeros((1, 16), np.float32)),
            tri_order=t(np.arange(tri_off, dtype=np.int32)), wide=t(wide_all),
            n0=None, n1=None, n2=None, uv0=None, uv1=None, uv2=None,
            ng=None, mat_id=None, light_id=None, node_id=None,
            shade=t(np.concatenate(shades)),
            tt_top=None if tpart is None else t(tpart.top),
            tt_slabs=None if tpart is None else t(tpart.slabs),
            tt_vid=None if tpart is None else t(tpart.vid_map))

        # instance table: identity row for the flat part, then each node of
        # each shared mesh
        w2l_rows, l2w_rows, roots, imat, ilig, inode = [], [], [], [], [], []
        los, his, inv_scales, local_aabbs = [], [], [], []
        self._inst_of_node = {}
        part_i = 0
        if parts and parts[0]["flat"]:
            eye = np.eye(4, dtype=np.float32)
            w2l_rows.append(eye[:3]); l2w_rows.append(eye[:3])
            roots.append(parts[0]["root"])
            imat.append(-1); ilig.append(-2); inode.append(-1)
            los.append(parts[0]["lo"]); his.append(parts[0]["hi"])
            inv_scales.append(1.0)
            local_aabbs.append((parts[0]["lo"], parts[0]["hi"]))
            part_i = 1
        for _, idxs in group_items:
            part = parts[part_i]; part_i += 1
            lo, hi = part["lo"], part["hi"]
            corners = lo + _CORNERS01 * (hi - lo)
            for node_idx in idxs:
                node = nodes[node_idx]
                l2w = np.asarray(node.to_world, np.float32)
                w2l = np.linalg.inv(l2w).astype(np.float32)
                pts = corners @ l2w[:3, :3].T + l2w[:3, 3]
                w2l_rows.append(w2l[:3]); l2w_rows.append(l2w[:3])
                roots.append(part["root"])
                imat.append(node.material); ilig.append(-1); inode.append(node_idx)
                los.append(pts.min(0)); his.append(pts.max(0))
                det = abs(float(np.linalg.det(l2w[:3, :3])))
                inv_scales.append(max(det, 1e-20) ** (-1.0 / 3.0))
                local_aabbs.append((lo, hi))
                self._inst_of_node[node_idx] = len(roots) - 1
        self._inst_host = dict(
            w2l=np.stack(w2l_rows).astype(np.float32),
            l2w=np.stack(l2w_rows).astype(np.float32),
            root=np.asarray(roots, np.int32),
            mat_id=np.asarray(imat, np.int32),
            light_id=np.asarray(ilig, np.int32),
            node_id=np.asarray(inode, np.int32),
            lo=np.stack(los).astype(np.float32),
            hi=np.stack(his).astype(np.float32),
            inv_scale=np.asarray(inv_scales, np.float32),
            root_top=(np.asarray([root_top_of[r] for r in roots], np.int32)
                      if root_top_of is not None else None))
        self._add_tlas(self._inst_host)
        self._inst_local_aabbs = local_aabbs
        geom = geom._replace(inst=self._instance_table(self._inst_host, device))

        w_lo, w_hi = self._grow_by_media(np.stack(los).min(0), np.stack(his).max(0))
        b_like = bvhmod.BVH(nodes=np.zeros((1, 16), np.float32),
                            tri_order=np.arange(max(fv0.shape[0], 1), dtype=np.int32),
                            world_lo=w_lo, world_hi=w_hi)
        return schema.SceneData(
            geom=geom, materials=self._build_materials(device),
            textures=self._build_textures(device),
            lights=self._build_lights(area_lights, fv0, fv1, fv2, b_like, device),
            sensor=self.sensor_data(device),
            media=_build_media_table(self._media, device),
            world_lo=t(w_lo), world_hi=t(w_hi),
            host=self._host_meta(area_lights, w_lo, w_hi, t_bvh, t_part))

    # -- updates -----------------------------------------------------------
    def set_node_transform(self, node_id: int, to_world: np.ndarray):
        self._nodes[node_id].to_world = np.asarray(to_world, np.float32)

    def remove_node(self, node_id: int):
        self._nodes[node_id] = None  # tombstone; compacted at build

    def update_transforms(self, scene_data: schema.SceneData,
                          node_transforms: dict) -> schema.SceneData:
        """Incremental update: move nodes without a full rebuild (the
        reference's SceneBVH invalidate and refit). Returns a new SceneData
        on `scene_data`'s device.

        - Two-level scene, every moved node an instance: O(moved nodes).
          Only their InstanceTable rows are rewritten (transforms, world
          boxes, inv_scale) and the TLAS is rebuilt over the boxes.
        - Flat scene: the world triangles of every node are recomputed, the
          fat-row table refit bottom-up with its topology kept
          (``animation.refit_wide``), the shade rows repacked, the treelet
          slabs of a split table and the area lights' rows refreshed. A
          large motion loses BVH quality; a periodic build() restores it.
        - Two-level scene with a moved node in its flattened part: a full
          build() (the refit assumes the flattened layout)."""
        from . import animation as animmod
        for nid, m in node_transforms.items():
            self.set_node_transform(nid, m)
        device = scene_data.device
        inst_map = getattr(self, "_inst_of_node", None)
        if scene_data.geom.inst is not None:
            if inst_map is None or any(nid not in inst_map for nid in node_transforms):
                return self.build(device)
            # copy: on the CPU the old scene's tensors share these arrays
            h = {k: None if v is None else v.copy() for k, v in self._inst_host.items()}
            for nid in node_transforms:
                row = inst_map[nid]
                l2w = np.asarray(self._nodes[nid].to_world, np.float32)
                w2l = np.linalg.inv(l2w).astype(np.float32)
                h["l2w"][row] = l2w[:3]
                h["w2l"][row] = w2l[:3]
                lo, hi = self._inst_local_aabbs[row]
                pts = (lo + _CORNERS01 * (hi - lo)) @ l2w[:3, :3].T + l2w[:3, 3]
                h["lo"][row] = pts.min(0)
                h["hi"][row] = pts.max(0)
                det = abs(float(np.linalg.det(l2w[:3, :3])))
                h["inv_scale"][row] = max(det, 1e-20) ** (-1.0 / 3.0)
            self._add_tlas(h)
            self._inst_host = h
            w_lo, w_hi = self._grow_by_media(h["lo"].min(0), h["hi"].max(0))
            meta = dict(scene_data.host, world_lo=w_lo, world_hi=w_hi)
            t = lambda a: schema.to_tensor(a, device)
            return scene_data._replace(
                geom=scene_data.geom._replace(inst=self._instance_table(h, device)),
                world_lo=t(w_lo), world_hi=t(w_hi), host=meta)

        nodes = [n for n in self._nodes if n is not None]
        (v0, v1, v2, n0, n1, n2, uv0, uv1, uv2, mat_a, light_a, node_a,
         _) = self._world_soup(nodes, range(len(nodes)))
        wide_np = scene_data.geom.wide.cpu().numpy()
        # leaf rows carry their triangle count in column 120, node rows 0;
        # node rows come first
        leafy = wide_np[:, 120] > 0
        n_node_rows = int(np.argmax(leafy)) if leafy.any() else wide_np.shape[0]
        new_wide = animmod.refit_wide(wide_np, n_node_rows, v0, v1, v2)
        ng = np.cross(v1 - v0, v2 - v0)
        ng = ng / np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
        shade = schema.pack_shade_rows(n0, n1, n2, uv0, uv1, uv2, ng, v0, v1, v2,
                                       mat_a, light_a, node_a)
        t = lambda a: schema.to_tensor(a, device)
        geom = scene_data.geom._replace(wide=t(new_wide), shade=t(shade))
        # a split table's treelet slabs are packed copies of its rows: the
        # refit must refresh them, or the two-phase traversal would read
        # stale boxes
        if scene_data.geom.tt_slabs is not None:
            part = treeletmod.partition(new_wide)
            geom = geom._replace(tt_top=t(part.top), tt_slabs=t(part.slabs),
                                 tt_vid=t(part.vid_map))
        # animated emitter triangles: refresh the area lights' rows
        lights = scene_data.lights._replace(al_rows=t(_pack_al_rows(
            v0, v1, v2, scene_data.lights.al_tris.cpu().numpy())))
        lo = np.minimum(np.minimum(v0, v1), v2).min(0).astype(np.float32)
        hi = np.maximum(np.maximum(v0, v1), v2).max(0).astype(np.float32)
        meta = dict(scene_data.host, world_lo=lo, world_hi=hi)
        return scene_data._replace(geom=geom, lights=lights, world_lo=t(lo),
                                   world_hi=t(hi), host=meta)

    def _build_materials(self, device) -> schema.MaterialTable:
        mats = self._materials if self._materials else [dict(
            mat_type=schema.BSDF_DIFFUSE,
            params=np.zeros(schema.N_MAT_PARAMS, np.float32),
            tex=np.full(schema.N_MAT_TEX, -1, np.int32), nested=-1, nested2=-1)]
        t = lambda a: schema.to_tensor(a, device)
        return schema.MaterialTable(
            mat_type=t(np.asarray([m["mat_type"] for m in mats], np.int32)),
            params=t(np.stack([m["params"] for m in mats])),
            tex=t(np.stack([m["tex"] for m in mats])),
            nested=t(np.asarray([m["nested"] for m in mats], np.int32)),
            nested2=t(np.asarray([m["nested2"] for m in mats], np.int32)))

    def _build_textures(self, device) -> schema.TextureTable:
        texs = self._textures
        X = max(len(texs), 1)
        tex_type = np.zeros(X, np.int32)
        params = np.zeros((X, schema.N_TEX_PARAMS), np.float32)
        image_id = np.full(X, -1, np.int32)
        images = []
        for i, tx in enumerate(texs):
            tex_type[i] = tx.tex_type
            params[i, 0:3] = tx.value
            params[i, 3:6] = tx.value1
            params[i, 6:8] = tx.uv_scale
            params[i, 8:10] = tx.uv_offset
            if tx.image is not None:
                images.append(np.asarray(tx.image, np.float32))
                image_id[i] = len(images) - 1
        # images needing a cone-step map: height maps (bump slot 3) of
        # parallax materials (scene/conemap.py)
        cone_imgs = set()
        for m in self._materials:
            if float(m["params"][24]) > 0:
                ti = int(m["tex"][3])
                if 0 <= ti < X and image_id[ti] >= 0:
                    cone_imgs.add(int(image_id[ti]))

        def quad_pack(lv: np.ndarray) -> np.ndarray:
            """(h, w, 3) level -> (h*w, 12) rows of the 2x2 wrap-neighborhood
            [T(y,x), T(y,x+1), T(y+1,x), T(y+1,x+1)] (schema.texels_quad)."""
            q = np.stack([lv, np.roll(lv, -1, axis=1), np.roll(lv, -1, axis=0),
                          np.roll(np.roll(lv, -1, axis=0), -1, axis=1)], axis=2)
            return q.reshape(-1, 12).astype(np.float32)

        if images:
            offs, ws, hs, nmips, pool = [], [], [], [], []
            qpool = []
            cone_offs = []
            cursor = 0
            for img_i, img in enumerate(images):
                # full mip chain by 2x2 box downsampling (reference MIPMap)
                levels = [img]
                while min(levels[-1].shape[0], levels[-1].shape[1]) > 1 \
                        and len(levels) < MAX_MIPS:
                    prev = levels[-1]
                    h2, w2 = max(prev.shape[0] // 2, 1), max(prev.shape[1] // 2, 1)
                    ds = prev[:h2 * 2, :w2 * 2].reshape(h2, 2, w2, 2, 3).mean((1, 3))
                    levels.append(ds.astype(np.float32))
                o_row = np.zeros(MAX_MIPS, np.int32)
                w_row = np.ones(MAX_MIPS, np.int32)
                h_row = np.ones(MAX_MIPS, np.int32)
                for li, lv in enumerate(levels):
                    o_row[li] = cursor
                    h_, w_ = lv.shape[:2]
                    w_row[li] = w_
                    h_row[li] = h_
                    pool.append(lv.reshape(-1, 3))
                    qpool.append(quad_pack(lv))
                    cursor += w_ * h_
                # clamp trailing levels to the last real one
                for li in range(len(levels), MAX_MIPS):
                    o_row[li] = o_row[len(levels) - 1]
                    w_row[li] = w_row[len(levels) - 1]
                    h_row[li] = h_row[len(levels) - 1]
                offs.append(o_row); ws.append(w_row); hs.append(h_row)
                nmips.append(len(levels))
                if img_i in cone_imgs:
                    cone = conemap.build_cone_map(img.mean(-1))
                    pool.append(np.repeat(cone.reshape(-1, 1), 3, axis=1))
                    # cone maps are point-sampled from the flat pool; the
                    # quad pool only pads to keep the shared offsets aligned
                    qpool.append(np.zeros((cone.size, 12), np.float32))
                    cone_offs.append(cursor)
                    cursor += cone.size
                else:
                    cone_offs.append(-1)
            texels = np.concatenate(pool)
            texels_quad = np.concatenate(qpool)
            img_offset = np.stack(offs)
            img_w = np.stack(ws)
            img_h = np.stack(hs)
            img_nmips = np.asarray(nmips, np.int32)
            img_cone = np.asarray(cone_offs, np.int32)
        else:
            texels = np.zeros((1, 3), np.float32)
            texels_quad = np.zeros((1, 12), np.float32)
            img_offset = np.zeros((1, MAX_MIPS), np.int32)
            img_w = np.ones((1, MAX_MIPS), np.int32)
            img_h = np.ones((1, MAX_MIPS), np.int32)
            img_nmips = np.ones(1, np.int32)
            img_cone = np.full(1, -1, np.int32)
        t = lambda a: schema.to_tensor(a, device)
        return schema.TextureTable(
            tex_type=t(tex_type), params=t(params), image_id=t(image_id),
            img_offset=t(img_offset), img_w=t(img_w), img_h=t(img_h),
            img_nmips=t(img_nmips), texels=t(texels), img_cone=t(img_cone),
            texels_quad=t(texels_quad))

    def _build_lights(self, area_lights, v0, v1, v2, b: bvhmod.BVH,
                      device) -> schema.LightTable:
        world_radius = 0.5 * float(np.linalg.norm(b.world_hi - b.world_lo)) + 1e-3
        rows = list(self._lights)
        al_tris, al_cdf, al_first, al_count = [], [], [], []
        for al in area_lights:
            p = np.zeros(schema.N_LIGHT_PARAMS, np.float32)
            p[3:6] = al["radiance"]
            first, count = al["first"], al["count"]
            ids = np.arange(first, first + count, dtype=np.int32)
            areas = 0.5 * np.linalg.norm(
                np.cross(v1[ids] - v0[ids], v2[ids] - v0[ids]), axis=-1)
            total = max(float(areas.sum()), 1e-20)
            cdf = np.cumsum(areas) / total
            p[6] = total  # total area
            al_first.append(sum(len(x) for x in al_tris))
            al_count.append(count)
            al_tris.append(ids)
            al_cdf.append(cdf.astype(np.float32))
            rows.append(dict(light_type=schema.LIGHT_DIFFUSE, params=p))
        if self._env is not None:
            p = np.zeros(schema.N_LIGHT_PARAMS, np.float32)
            p[3:6] = self._env["scale"]
            p[7] = world_radius
            rows.append(dict(light_type=schema.LIGHT_INFINITE, params=p))

        L = max(len(rows), 1)
        light_type = np.zeros(L, np.int32)
        params = np.zeros((L, schema.N_LIGHT_PARAMS), np.float32)
        powers = np.zeros(L, np.float32)
        for i, r in enumerate(rows):
            light_type[i] = r["light_type"]
            params[i] = r["params"]
            lum = float(r["params"][3:6] @ LUM_W)
            t = r["light_type"]
            if t == schema.LIGHT_POINT:
                powers[i] = lum * 4 * np.pi
            elif t == schema.LIGHT_DIFFUSE:
                powers[i] = lum * np.pi * r["params"][6]
            elif t == schema.LIGHT_DISTANT:
                powers[i] = lum * np.pi * world_radius ** 2
                params[i, 7] = world_radius
            elif t == schema.LIGHT_SPOT:
                powers[i] = lum * 2 * np.pi * (1 - r["params"][6])
            elif t == schema.LIGHT_INFINITE:
                env_lum = float(np.mean(self._env["image"] @ LUM_W))
                powers[i] = env_lum * lum * 4 * np.pi * np.pi * world_radius ** 2
        if not rows:
            powers[0] = 1.0
        cdf = np.cumsum(powers)
        cdf = cdf / max(cdf[-1], 1e-20)

        if al_tris:
            al_tris_arr = np.concatenate(al_tris)
            al_cdf_arr = np.concatenate(al_cdf)
            # per-light alias tables over tri area (absolute alias indices),
            # flattened at the al_first offsets — O(1) selection at trace time
            al_alias_arr = np.zeros((len(al_tris_arr), 2), np.float32)
            ofs = 0
            for ids in al_tris:
                n = len(ids)
                areas = 0.5 * np.linalg.norm(
                    np.cross(v1[ids] - v0[ids], v2[ids] - v0[ids]), axis=-1)
                tab = aliasmod.build_alias_table(areas)
                al_alias_arr[ofs:ofs + n, 0] = tab[:, 0]
                al_alias_arr[ofs:ofs + n, 1] = (
                    tab[:, 1].view(np.int32) + ofs).view(np.float32)
                ofs += n
        else:
            al_tris_arr = np.zeros(1, np.int32)
            al_cdf_arr = np.ones(1, np.float32)
            al_alias_arr = np.asarray([[1.0, 0.0]], np.float32)
        al_rows_arr = _pack_al_rows(v0, v1, v2, al_tris_arr)
        al_first_arr = np.zeros(L, np.int32)
        al_count_arr = np.zeros(L, np.int32)
        ai = 0
        for i, r in enumerate(rows):
            if r["light_type"] == schema.LIGHT_DIFFUSE:
                al_first_arr[i] = al_first[ai]
                al_count_arr[i] = al_count[ai]
                ai += 1

        if self._env is not None:
            env = self._env["image"] * np.asarray(self._env["scale"], np.float32)
            env_lum = env @ LUM_W
            He, We = env.shape[:2]
            # sin(theta) weighting for the equirectangular solid-angle measure
            sin_t = np.sin((np.arange(He) + 0.5) / He * np.pi)[:, None].astype(np.float32)
            w = env_lum * sin_t + 1e-12
            env_alias = aliasmod.build_alias_table(w)
            env_pmf = env_alias[:, 2].reshape(He, We)
            env_to_world = self._env["to_world"]
        else:
            # no environment map: a 1x1 black placeholder
            env = np.zeros((1, 1, 3), np.float32)
            env_alias = np.asarray([[1.0, 0.0, 1.0, 1.0]], np.float32)
            env_pmf = np.ones((1, 1), np.float32)
            env_to_world = np.eye(4, dtype=np.float32)

        t = lambda a: schema.to_tensor(a, device)
        return schema.LightTable(
            light_type=t(light_type), params=t(params),
            power_cdf=t(np.asarray(cdf, np.float32)),
            al_rows=t(al_rows_arr),
            al_tris=t(al_tris_arr), al_cdf=t(al_cdf_arr),
            al_alias=t(al_alias_arr),
            al_first=t(al_first_arr), al_count=t(al_count_arr),
            env_map=t(env), env_alias=t(env_alias),
            env_pmf=t(env_pmf),
            env_to_world=t(env_to_world),
            env_world_to=t(np.linalg.inv(env_to_world)))


def _build_media_table(media_list, device) -> schema.MediumTable:
    """Pack the media rows (params layout in models/medium.py) onto
    `device`; no media gives the empty table."""
    V = len(media_list)
    med_type = np.zeros(V, np.int32)
    params = np.zeros((V, 24), np.float32)
    to_world = np.zeros((V, 4, 4), np.float32)
    world_to = np.zeros((V, 4, 4), np.float32)
    grid_offset = np.full((V, 3), -1, np.int32)
    grid_dim = np.zeros((V, 3), np.int32)
    voxels = []
    cursor = 0
    for i, m in enumerate(media_list):
        med_type[i] = m["med_type"]
        params[i, 0:3] = m["sigma_a"]
        params[i, 3:6] = m["sigma_s"]
        params[i, 6] = m["phase_type"]
        params[i, 7] = m["phase_g"]
        params[i, 8] = m["scale"]
        params[i, 9:12] = m["emission"]
        to_world[i] = m["to_world"]
        world_to[i] = np.linalg.inv(m["to_world"])
        if m["density"] is not None:
            d = m["density"]
            nz, ny, nx = d.shape
            grid_dim[i] = (nx, ny, nz)
            grid_offset[i, 0] = cursor
            voxels.append(d.reshape(-1))
            cursor += d.size
    vox = np.concatenate(voxels) if voxels else np.zeros(1, np.float32)
    t = lambda a: schema.to_tensor(a, device)
    return schema.MediumTable(
        med_type=t(med_type), params=t(params), to_world=t(to_world),
        world_to=t(world_to), grid_offset=t(grid_offset),
        grid_dim=t(grid_dim), voxels=t(vox))
