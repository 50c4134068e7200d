"""Procedural shapes triangulated host-side (numpy).

Verbatim port of ``cudatracerlib_tpu/scene/shapes.py``: the Mitsuba shape
primitives the scene loader supports (rectangle, sphere, cube, cylinder,
disk) in Mitsuba's canonical object-space conventions.
"""
from __future__ import annotations

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
            inv3 = np.linalg.inv(m[:3, :3])
            n = self.n @ inv3  # normal transform: (M^-1)^T . n == n @ M^-1
            ln = np.linalg.norm(n, axis=-1, keepdims=True)
            n = n / np.maximum(ln, 1e-20)
        return TriMesh(v.astype(np.float32), self.f, n, self.uv)

    def surface_areas(self) -> np.ndarray:
        a, b, c = self.v[self.f[:, 0]], self.v[self.f[:, 1]], self.v[self.f[:, 2]]
        return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)


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
                p[u_ax] = du * sign  # winding flips with sign for outward faces
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
    x = np.sin(tt) * np.cos(pp)
    y = np.sin(tt) * np.sin(pp)
    z = np.cos(tt)
    n = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
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


def cylinder(p0=(0, 0, 0), p1=(0, 0, 1), radius: float = 1.0,
             n_seg: int = 64) -> TriMesh:
    """Open cylinder from p0 to p1 (Mitsuba convention: no caps)."""
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    axis = p1 - p0
    length = np.linalg.norm(axis)
    w = axis / max(length, 1e-20)
    # build a frame around w
    a = np.array([1.0, 0, 0]) if abs(w[0]) < 0.9 else np.array([0, 1.0, 0])
    u = np.cross(a, w)
    u /= np.linalg.norm(u)
    vv = np.cross(w, u)
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    ring = (np.outer(np.cos(ang), u) + np.outer(np.sin(ang), vv)) * radius
    verts = np.concatenate([p0 + ring, p1 + ring]).astype(np.float32)
    normals = np.concatenate([ring, ring]) / radius
    uv = np.concatenate([
        np.stack([ang / (2 * np.pi), np.zeros(n_seg)], -1),
        np.stack([ang / (2 * np.pi), np.ones(n_seg)], -1)]).astype(np.float32)
    faces = []
    for i in range(n_seg):
        j = (i + 1) % n_seg
        faces += [[i, j, n_seg + i], [j, n_seg + j, n_seg + i]]
    return TriMesh(verts, np.array(faces, np.int32), normals.astype(np.float32), uv)


def disk(n_seg: int = 64) -> TriMesh:
    """Unit disk on the xy-plane at z=0, normal +z."""
    ang = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    rim = np.stack([np.cos(ang), np.sin(ang), np.zeros(n_seg)], -1)
    v = np.concatenate([[[0, 0, 0]], rim]).astype(np.float32)
    f = np.array([[0, 1 + i, 1 + (i + 1) % n_seg] for i in range(n_seg)], np.int32)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (n_seg + 1, 1))
    uv = (v[:, :2] * 0.5 + 0.5).astype(np.float32)
    return TriMesh(v, f, n, uv)


def merge(meshes) -> TriMesh:
    """Concatenate meshes into one (used by shapegroups)."""
    vs, fs, ns, uvs = [], [], [], []
    off = 0
    has_n = all(m.n is not None for m in meshes)
    has_uv = all(m.uv is not None for m in meshes)
    for m in meshes:
        vs.append(m.v)
        fs.append(m.f + off)
        if has_n:
            ns.append(m.n)
        if has_uv:
            uvs.append(m.uv)
        off += m.v.shape[0]
    return TriMesh(np.concatenate(vs), np.concatenate(fs),
                   np.concatenate(ns) if has_n else None,
                   np.concatenate(uvs) if has_uv else None)


def compute_vertex_normals(mesh: TriMesh) -> TriMesh:
    """Area-weighted smooth vertex normals (for meshes loaded without them)."""
    v, f = mesh.v, mesh.f
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    n = np.zeros_like(v)
    for k in range(3):
        np.add.at(n, f[:, k], fn)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(ln, 1e-20)
    return TriMesh(v, f, n.astype(np.float32), mesh.uv)
