"""The Cornell box as measured (Cornell Program of Computer Graphics,
Cornell Box data): five walls, a short and a tall block and a ceiling
light, all quads given by their corners in mm in the configuration, seen
through the published pinhole camera (a 35 mm lens on a 25 mm film)."""
from __future__ import annotations

import math

import numpy as np

from . import common as c


def quads(corners) -> c.TriMesh:
    """Quads given by four corners each, two triangles a quad, with flat
    normals along (v1 - v0) x (v2 - v0)."""
    q = np.asarray(corners, np.float32).reshape(-1, 4, 3)
    v = q.reshape(-1, 3)
    base = np.arange(q.shape[0], dtype=np.int32)[:, None] * 4
    f = np.concatenate([base + [0, 1, 2], base + [0, 2, 3]], axis=1).reshape(-1, 3)
    fn = np.cross(q[:, 1] - q[:, 0], q[:, 2] - q[:, 0])
    fn = fn / np.linalg.norm(fn, axis=-1, keepdims=True)
    n = np.repeat(fn, 4, axis=0).astype(np.float32)
    uv = np.tile(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32), (q.shape[0], 1))
    return c.TriMesh(v, f.astype(np.int32), n, uv)


def make(cfg: dict) -> c.Scene:
    sc = c.Scene(cfg["width"], cfg["height"])
    white = sc.add_material(c.Material(reflectance=tuple(cfg["white"])))
    red = sc.add_material(c.Material(reflectance=tuple(cfg["red"])))
    green = sc.add_material(c.Material(reflectance=tuple(cfg["green"])))
    black = sc.add_material(c.Material(reflectance=(0.0, 0.0, 0.0)))
    sc.add_node(quads([cfg["floor"], cfg["ceiling"], cfg["back_wall"]]
                      + cfg["short_block"] + cfg["tall_block"]), white)
    sc.add_node(quads([cfg["left_wall"]]), red)
    sc.add_node(quads([cfg["right_wall"]]), green)
    sc.add_node(quads([cfg["light"]]), black, emission=tuple(cfg["light_radiance"]))
    pos = np.asarray(cfg["camera_position"], np.float64)
    sc.camera_to_world = c.look_at(pos, pos + np.asarray(cfg["camera_direction"]),
                                   cfg["camera_up"])
    sc.fov_x_deg = math.degrees(2.0 * math.atan(0.5 * cfg["film_mm"] / cfg["focal_length_mm"]))
    return sc
