"""Host-side (numpy) 4x4 transform helpers for scene construction."""
from __future__ import annotations

import numpy as np


def identity():
    return np.eye(4, dtype=np.float32)


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
    axis = axis / np.linalg.norm(axis)
    a = np.deg2rad(angle_deg)
    x, y, z = axis
    c, s = np.cos(a), np.sin(a)
    C = 1 - c
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([
        [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, z * z * C + c]], np.float32)
    return m


def look_at(origin, target, up=(0, 1, 0)):
    """Camera-to-world: +z forward, +y up, +x right (Mitsuba convention)."""
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
