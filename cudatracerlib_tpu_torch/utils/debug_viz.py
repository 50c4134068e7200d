"""Per-pixel debug visualizers.

Port of ``cudatracerlib_tpu/utils/debug_viz.py`` (reference:
``Kernel/PixelDebugVisualizers/*``: named float/Vec2f/Vec3f buffers filled
inside kernels and drawn as normalized scalar maps, quiver arrows, or
frames). Integrators return extra per-pixel tensors; this module copies
them to the host (numpy) and normalizes and colormaps them for inspection.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _np(x, dtype=None):
    """A tensor (on any device) or array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


class DebugVisualizerManager:
    """Collects named per-pixel buffers and renders them to displayable RGB."""

    def __init__(self, width: int, height: int):
        self.w, self.h = width, height
        self.buffers: Dict[str, np.ndarray] = {}

    def record(self, name: str, values, pixel_x=None, pixel_y=None):
        """Store a full-frame (H,W[,C]) buffer or scatter lane values."""
        arr = _np(values)
        if pixel_x is None:
            self.buffers[name] = arr.reshape(self.h, self.w, -1)
        else:
            buf = self.buffers.get(name)
            if buf is None:
                buf = np.zeros((self.h, self.w, arr.shape[-1] if arr.ndim > 1 else 1),
                               np.float32)
            buf[_np(pixel_y), _np(pixel_x)] = arr.reshape(len(arr), -1)
            self.buffers[name] = buf
        return self

    def normalized_scalar(self, name: str, percentile: float = 99.0) -> np.ndarray:
        """Scalar heatmap in [0,1] with robust normalization."""
        b = self.buffers[name]
        s = b.mean(-1) if b.ndim == 3 else b
        hi = np.percentile(s, percentile)
        lo = np.percentile(s, 100 - percentile)
        return np.clip((s - lo) / max(hi - lo, 1e-9), 0, 1)

    def heatmap(self, name: str) -> np.ndarray:
        """Viridis-ish 3-stop colormap of the normalized scalar."""
        t = self.normalized_scalar(name)[..., None]
        c0 = np.array([0.267, 0.005, 0.329])
        c1 = np.array([0.128, 0.567, 0.551])
        c2 = np.array([0.993, 0.906, 0.144])
        lo = c0 + (c1 - c0) * np.clip(t * 2, 0, 1)
        return np.where(t < 0.5, lo, c1 + (c2 - c1) * np.clip(t * 2 - 1, 0, 1))

    def vector_map(self, name: str) -> np.ndarray:
        """Vec3 buffer displayed as 0.5 + 0.5*normalize(v) (frame drawing)."""
        b = self.buffers[name]
        n = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-9)
        return 0.5 + 0.5 * n

    def overlay_frames(self, drawer: "OverlayDrawer", pos_name: str,
                       normal_name: str, stride: int = 8,
                       scale: float = 0.05):
        """Draw a 3D shading frame at every stride-th pixel's recorded
        world position (reference PixelDebugVisualizer<Vec3f> 'frame'
        drawing, `PixelDebugVisualizer.h:15-50`)."""
        p = self.buffers[pos_name][..., :3]
        n = self.buffers[normal_name][..., :3]
        for y in range(stride // 2, self.h, stride):
            for x in range(stride // 2, self.w, stride):
                nv = n[y, x]
                if np.linalg.norm(nv) < 1e-6:
                    continue
                drawer.draw_frame(p[y, x], nv, scale)
        return drawer

    def quiver(self, name: str, stride: int = 8) -> np.ndarray:
        """ASCII-art style arrow overlay for Vec2 buffers: returns an RGB image
        with arrow segments rasterized (a minimal IDebugDrawer)."""
        b = self.buffers[name][..., :2]
        img = np.zeros((self.h, self.w, 3), np.float32)
        mag = np.linalg.norm(b, axis=-1)
        mmax = max(mag.max(), 1e-9)
        for y in range(stride // 2, self.h, stride):
            for x in range(stride // 2, self.w, stride):
                v = b[y, x] / mmax * (stride * 0.45)
                n = int(max(abs(v[0]), abs(v[1]), 1))
                for i in range(n + 1):
                    xi = int(round(x + v[0] * i / n))
                    yi = int(round(y + v[1] * i / n))
                    if 0 <= xi < self.w and 0 <= yi < self.h:
                        img[yi, xi] = (1.0, 0.8, 0.2)
        return img


class OverlayDrawer:
    """3D debug drawing over a rendered image (reference ``IDebugDrawer``,
    `Kernel/PixelDebugVisualizers/PixelDebugVisualizer.h:15-50`: DrawLine /
    DrawEllipse / per-pixel frame overlays).

    Host-side numpy rasterization: world-space primitives are projected
    through the scene's perspective sensor and drawn as anti-alias-free
    polylines onto a copy of the HDR image. Debug path only: it runs on the
    host."""

    def __init__(self, image, sensor):
        self.img = np.array(_np(image), np.float32, copy=True)
        self.h, self.w = self.img.shape[:2]
        self.w2c = _np(sensor.to_world_inv, np.float64)
        p = _np(sensor.params, np.float64)
        self.tan_half = np.tan(0.5 * p[0])

    def project(self, pts: np.ndarray):
        """world (N,3) -> (pixel xy (N,2), in-front mask)."""
        pts = np.atleast_2d(np.asarray(pts, np.float64))
        ph = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
        c = ph @ self.w2c.T
        z = c[:, 2]
        ok = z > 1e-6
        x = c[:, 0] / np.where(ok, z, 1.0) / self.tan_half
        y = c[:, 1] / np.where(ok, z, 1.0) / (self.tan_half * self.h / self.w)
        px = (x + 1.0) * 0.5 * self.w
        py = (1.0 - y) * 0.5 * self.h
        return np.stack([px, py], axis=1), ok

    def _plot(self, px, py, color):
        xi = np.round(px).astype(np.int64)
        yi = np.round(py).astype(np.int64)
        keep = (xi >= 0) & (xi < self.w) & (yi >= 0) & (yi < self.h)
        self.img[yi[keep], xi[keep]] = color

    def draw_line(self, p0, p1, color=(1.0, 0.1, 0.1), samples=None):
        (a, b), ok = self.project(np.stack([np.asarray(p0), np.asarray(p1)]))
        if not ok.all():
            return self
        n = samples or int(max(abs(b[0] - a[0]), abs(b[1] - a[1]), 1)) + 1
        t = np.linspace(0.0, 1.0, min(n, 4 * max(self.w, self.h)))
        self._plot(a[0] + (b[0] - a[0]) * t, a[1] + (b[1] - a[1]) * t,
                   np.asarray(color, np.float32))
        return self

    def draw_frame(self, p, n, scale=0.05):
        """Tangent frame at p about normal n: t red, bitangent green,
        normal blue (the reference's frame visualization)."""
        p = np.asarray(p, np.float64)
        n = np.asarray(n, np.float64)
        n = n / max(np.linalg.norm(n), 1e-12)
        s = 1.0 if n[2] >= 0 else -1.0
        a = -1.0 / (s + n[2])
        b = n[0] * n[1] * a
        t = np.array([1.0 + s * n[0] ** 2 * a, s * b, -s * n[0]])
        bt = np.array([b, s + n[1] ** 2 * a, -n[1]])
        self.draw_line(p, p + t * scale, (1.0, 0.15, 0.15))
        self.draw_line(p, p + bt * scale, (0.15, 1.0, 0.15))
        self.draw_line(p, p + n * scale, (0.2, 0.4, 1.0))
        return self

    def draw_ellipse(self, center, axis1, axis2, color=(1.0, 0.9, 0.1),
                     samples=64):
        """World-space ellipse (e.g. an EWA footprint or kNN gather disc)."""
        th = np.linspace(0.0, 2.0 * np.pi, samples, endpoint=False)
        pts = (np.asarray(center)[None, :]
               + np.cos(th)[:, None] * np.asarray(axis1)[None, :]
               + np.sin(th)[:, None] * np.asarray(axis2)[None, :])
        pr, ok = self.project(pts)
        pr = pr[ok]
        for i in range(len(pr)):
            a, b = pr[i], pr[(i + 1) % len(pr)]
            n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]), 1)) + 1
            t = np.linspace(0.0, 1.0, min(n, 2 * max(self.w, self.h)))
            self._plot(a[0] + (b[0] - a[0]) * t, a[1] + (b[1] - a[1]) * t,
                       np.asarray(color, np.float32))
        return self
