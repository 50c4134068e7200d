"""Frozen numpy helpers for the benchmark's scenes.

A copy of the triangulated shapes and 4x4 transforms that the program's
example scenes use, kept here so that a later change to the program cannot
change what the benchmark renders. A scene is a plain description
(``Scene``) that the harness hands to the program through its scene API and
the reference takes as world-space arrays (``world_arrays``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np


class TriMesh(NamedTuple):
    v: np.ndarray                 # (V, 3) f32 positions (object space)
    f: np.ndarray                 # (F, 3) i32 vertex indices
    n: Optional[np.ndarray]       # (V, 3) f32 vertex normals or None
    uv: Optional[np.ndarray]      # (V, 2) f32 or None

    def transformed(self, m: np.ndarray) -> "TriMesh":
        v = self.v @ m[:3, :3].T + m[:3, 3]
        n = None
        if self.n is not None:
            n = self.n @ np.linalg.inv(m[:3, :3])
            n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
        return TriMesh(v.astype(np.float32), self.f, n, self.uv)


def rectangle() -> TriMesh:
    """Unit rectangle on the xy-plane spanning [-1,1]^2, normal +z."""
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return TriMesh(v, f, n, uv)


def cube() -> TriMesh:
    """Axis-aligned cube spanning [-1,1]^3 with outward face normals."""
    verts, faces, normals, uvs = [], [], [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            nvec = np.zeros(3, np.float32)
            nvec[axis] = sign
            u_ax, v_ax = (axis + 1) % 3, (axis + 2) % 3
            base = len(verts)
            for (du, dv) in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = np.zeros(3, np.float32)
                p[axis] = sign
                p[u_ax] = du * sign
                p[v_ax] = dv
                verts.append(p)
                normals.append(nvec)
                uvs.append([(du + 1) / 2, (dv + 1) / 2])
            faces += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return TriMesh(np.array(verts, np.float32), np.array(faces, np.int32),
                   np.array(normals, np.float32), np.array(uvs, np.float32))


def sphere(radius: float = 1.0, center=(0.0, 0.0, 0.0),
           n_theta: int = 32, n_phi: int = 64) -> TriMesh:
    """Lat-long triangulated sphere with exact vertex normals."""
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi + 1)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    n = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)],
                 -1).reshape(-1, 3).astype(np.float32)
    v = (n * radius + np.asarray(center, np.float32)).astype(np.float32)
    uv = np.stack([pp / (2 * np.pi), 1.0 - tt / np.pi], -1).reshape(-1, 2).astype(np.float32)
    faces = []
    W = n_phi + 1
    for i in range(n_theta):
        for j in range(n_phi):
            a, b = i * W + j, i * W + j + 1
            c, d = (i + 1) * W + j, (i + 1) * W + j + 1
            if i > 0:
                faces.append([a, c, b])
            if i < n_theta - 1:
                faces.append([b, c, d])
    return TriMesh(v, np.array(faces, np.int32), n, uv)


def compute_vertex_normals(mesh: TriMesh) -> TriMesh:
    """Area-weighted smooth vertex normals."""
    v, f = mesh.v, mesh.f
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    n = np.zeros_like(v)
    for k in range(3):
        np.add.at(n, f[:, k], fn)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    return TriMesh(v, f, n.astype(np.float32), mesh.uv)


def translate(t):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = t
    return m


def scale(s):
    s = np.broadcast_to(np.asarray(s, np.float32), (3,))
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotate_deg(axis, angle_deg):
    axis = np.asarray(axis, np.float64)
    x, y, z = axis / np.linalg.norm(axis)
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    C = 1 - c
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([
        [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, z * z * C + c]], np.float32)
    return m


def look_at(origin, target, up=(0, 1, 0)):
    """Camera-to-world: +z forward, +y up, +x right."""
    origin = np.asarray(origin, np.float64)
    d = np.asarray(target, np.float64) - origin
    d /= np.linalg.norm(d)
    up = np.asarray(up, np.float64)
    r = np.cross(up / np.linalg.norm(up), d)
    r /= np.linalg.norm(r)
    u = np.cross(d, r)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = r, u, d, origin
    return m


def compose(*ms):
    out = np.eye(4, dtype=np.float32)
    for m in ms:
        out = out @ m
    return out


@dataclass
class Material:
    """A diffuse or rough-conductor (GGX) material; `texture` replaces the
    reflectance: ("image", HxWx3 array, uv_scale) or ("checker", color0,
    color1, uv_scale). All materials are two-sided."""
    kind: str = "diffuse"                      # "diffuse" | "roughconductor"
    reflectance: tuple = (0.5, 0.5, 0.5)
    alpha: float = 0.1
    eta_c: tuple = (0.2, 0.9, 1.4)
    k_c: tuple = (3.9, 2.5, 2.1)
    texture: Optional[tuple] = None


@dataclass
class Node:
    mesh: TriMesh
    material: int
    to_world: np.ndarray
    emission: Optional[tuple] = None


@dataclass
class Scene:
    width: int
    height: int
    camera_to_world: np.ndarray = None
    fov_x_deg: float = 35.0
    materials: list = field(default_factory=list)
    nodes: list = field(default_factory=list)
    env_image: Optional[np.ndarray] = None     # (H, W, 3) equirect, scale 1
    distant: list = field(default_factory=list)  # (unit direction, radiance)

    def add_material(self, m: Material) -> int:
        self.materials.append(m)
        return len(self.materials) - 1

    def add_node(self, mesh, material, to_world=None, emission=None):
        if mesh.n is None:
            mesh = compute_vertex_normals(mesh)
        if to_world is None:
            to_world = np.eye(4, dtype=np.float32)
        self.nodes.append(Node(mesh, material, np.asarray(to_world, np.float32),
                               emission))

    def add_distant_light(self, direction, radiance):
        d = np.asarray(direction, np.float32)
        self.distant.append((d / np.linalg.norm(d), tuple(radiance)))

    def n_triangles(self) -> int:
        return int(sum(n.mesh.f.shape[0] for n in self.nodes))


def world_arrays(sc: Scene) -> dict:
    """The scene as world-space triangle arrays (float32): v0, v1, v2 and
    vertex normals n0, n1, n2, uv0, uv1, uv2, per-triangle material id and
    emitted radiance."""
    out = {k: [] for k in ("v0", "v1", "v2", "n0", "n1", "n2",
                           "uv0", "uv1", "uv2", "mat", "emit")}
    for node in sc.nodes:
        m = node.mesh.transformed(node.to_world)
        f = m.f
        for k in range(3):
            out[f"v{k}"].append(m.v[f[:, k]])
            out[f"n{k}"].append(m.n[f[:, k]])
            uv = m.uv if m.uv is not None else np.zeros((m.v.shape[0], 2), np.float32)
            out[f"uv{k}"].append(uv[f[:, k]])
        out["mat"].append(np.full(f.shape[0], node.material, np.int32))
        e = node.emission if node.emission is not None else (0.0, 0.0, 0.0)
        out["emit"].append(np.tile(np.asarray(e, np.float32), (f.shape[0], 1)))
    return {k: np.concatenate(v).astype(np.int32 if k == "mat" else np.float32)
            for k, v in out.items()}
