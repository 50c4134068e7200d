"""Sensor models: camera-ray generation and direct sampling (for
light-tracing splats).

Port of ``cudatracerlib_tpu/scene/sensors.py``: the spherical, perspective,
thin-lens, orthographic and telecentric sensors. The sensor type is uniform
per scene and a Python int here, so each function dispatches with a plain
``if`` where the JAX package switches (``lax.switch``) over the same branch
tables: ``sample_ray`` maps (spherical, perspective, thin lens, orthographic,
telecentric), ``sample_direct`` (spherical, perspective, perspective,
orthographic, telecentric): the thin lens connects as the pinhole does.

Param layout (SensorData.params):
  [0] fov_x (radians)  [1] near  [2] far  [3] aperture_radius
  [4] focus_distance  [5] film_w  [6] film_h  [7] ortho_scale_x  [8] ortho_scale_y
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import vecmath as vm
from ..core import warp
from . import schema

Tensor = torch.Tensor


class SensorRays(NamedTuple):
    o: Tensor       # (B, 3)
    d: Tensor       # (B, 3)
    weight: Tensor  # (B, 3) importance weight (1 for ideal sensors)


def _film_to_camera_dir(params: Tensor, p_film: Tensor) -> Tensor:
    """Pixel coords (B,2) -> unnormalized camera-space direction (perspective)."""
    w, h = params[5], params[6]
    tan_half = torch.tan(0.5 * params[0])
    x = (2.0 * p_film[..., 0] / w - 1.0) * tan_half
    y = (1.0 - 2.0 * p_film[..., 1] / h) * tan_half * (h / w)
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def _film_to_ortho(params: Tensor, p_film: Tensor):
    """Pixel coords (B,2) -> the camera-space (x, y) of an orthographic film."""
    w, h = params[5], params[6]
    x = (2.0 * p_film[..., 0] / w - 1.0) * params[7]
    y = (1.0 - 2.0 * p_film[..., 1] / h) * params[8]
    return x, y


def sample_ray(sensor: schema.SensorData, p_film: Tensor, u_aperture: Tensor) -> SensorRays:
    """Generate camera rays for continuous film positions (pixels).

    p_film: (B, 2) continuous pixel coordinates in [0,W)x[0,H).
    u_aperture: (B, 2) uniforms for lens sampling (thin lens, telecentric).
    """
    B = p_film.shape[0]
    params = sensor.params
    t2w = sensor.to_world
    st = sensor.sensor_type
    one = torch.ones((B, 3), dtype=torch.float32, device=p_film.device)
    zero = torch.zeros(B, dtype=torch.float32, device=p_film.device)
    if st == schema.SENSOR_PERSPECTIVE:
        d_cam = vm.normalize(_film_to_camera_dir(params, p_film))
        o = t2w[:3, 3].expand(B, 3)
        d = vm.normalize(vm.transform_vector(t2w, d_cam))
    elif st == schema.SENSOR_THINLENS:
        d_cam = _film_to_camera_dir(params, p_film)
        focus = d_cam * (params[4] / d_cam[..., 2:3])  # point on focal plane
        lens = warp.square_to_uniform_disk_concentric(u_aperture) * params[3]
        o_cam = torch.cat([lens, zero[:, None]], dim=-1)
        d_cam2 = vm.normalize(focus - o_cam)
        o = vm.transform_point(t2w, o_cam)
        d = vm.normalize(vm.transform_vector(t2w, d_cam2))
    elif st == schema.SENSOR_ORTHOGRAPHIC:
        x, y = _film_to_ortho(params, p_film)
        o = vm.transform_point(t2w, torch.stack([x, y, zero], dim=-1))
        # the camera's +z axis is the third column of to_world
        d = (t2w[:3, 2] / vm.length(t2w[:3, 2])).expand(B, 3)
    elif st == schema.SENSOR_SPHERICAL:
        w, h = params[5], params[6]
        phi = (1.0 - p_film[..., 0] / w) * 2.0 * math.pi - math.pi
        theta = p_film[..., 1] / h * math.pi
        s_t, c_t = torch.sin(theta), torch.cos(theta)
        d_cam = torch.stack([s_t * torch.sin(phi), c_t, -s_t * torch.cos(phi)], dim=-1)
        o = t2w[:3, 3].expand(B, 3)
        d = vm.normalize(vm.transform_vector(t2w, d_cam))
    elif st == schema.SENSOR_TELECENTRIC:
        x, y = _film_to_ortho(params, p_film)
        lens = warp.square_to_uniform_disk_concentric(u_aperture) * params[3]
        o_cam = torch.stack([x + lens[..., 0], y + lens[..., 1], zero], dim=-1)
        focus = torch.stack([x, y, zero + params[4]], dim=-1)
        d_cam = vm.normalize(focus - o_cam)
        o = vm.transform_point(t2w, o_cam)
        d = vm.normalize(vm.transform_vector(t2w, d_cam))
    else:
        raise ValueError(f"unknown sensor type {st}")
    return SensorRays(o, d, one)


class SensorDirect(NamedTuple):
    """Result of sampling the sensor from a scene point (for splatting)."""
    p_film: Tensor   # (B, 2) continuous pixel coords
    d: Tensor        # (B, 3) unit direction ref -> sensor
    dist: Tensor     # (B,)
    weight: Tensor   # (B, 3) We / pdf (importance over the solid-angle pdf)
    valid: Tensor    # (B,) inside the frustum and in front


def _direct(p_film_x, p_film_y, d, dist, we, valid):
    return SensorDirect(p_film=torch.stack([p_film_x, p_film_y], -1), d=d,
                        dist=dist, weight=we[..., None].expand(-1, 3),
                        valid=valid)


def sample_direct(sensor: schema.SensorData, ref_p: Tensor, u: Tensor) -> SensorDirect:
    """Connect world points to the sensor (reference Sensor::sampleDirect).

    For the pinhole (and the thin lens, which connects as the pinhole does)
    the aperture is a point: the pdf is a delta and the weight is the full
    importance We(p->lens) / p(lens) with the 1/dist^2 geometry folded in.
    `u` (lens uniforms) matters only for the telecentric aperture; None
    gives the lens centre."""
    params = sensor.params
    w2c = sensor.to_world_inv
    t2w = sensor.to_world
    st = sensor.sensor_type
    w, h = params[5], params[6]
    if u is None:
        u = torch.full((ref_p.shape[0], 2), 0.5, dtype=torch.float32,
                       device=ref_p.device)
    if st in (schema.SENSOR_PERSPECTIVE, schema.SENSOR_THINLENS):
        to_lens = t2w[:3, 3] - ref_p
        dist = vm.length(to_lens)
        d = to_lens / dist[..., None].clamp_min(1e-12)
        p_cam = vm.transform_point(w2c, ref_p)
        z = p_cam[..., 2]
        tan_half = torch.tan(0.5 * params[0])
        x_ndc = p_cam[..., 0] / z.clamp_min(1e-12) / tan_half
        y_ndc = p_cam[..., 1] / z.clamp_min(1e-12) / (tan_half * h / w)
        px = (x_ndc + 1.0) * 0.5 * w
        py = (1.0 - y_ndc) * 0.5 * h
        valid = (z > params[1]) & (px >= 0) & (px < w) & (py >= 0) & (py < h)
        # importance of the pinhole: after the change of variables the
        # per-sample film contribution is 1/(A_film * cos^3 * dist^2), with
        # the film area in z=1 plane units
        cam_fwd = t2w[:3, 2] / vm.length(t2w[:3, 2])
        cos_theta = vm.dot(-d, cam_fwd)
        film_area = 4.0 * tan_half * tan_half * (h / w)
        ct = cos_theta.clamp_min(1e-6)
        we = 1.0 / (film_area * ct ** 3 * dist.clamp_min(1e-12) ** 2)
    elif st == schema.SENSOR_SPHERICAL:
        # inverse of sample_ray's equirectangular mapping: every direction
        # maps to a film position; dOmega/dA_norm = 2 pi^2 sin(theta)
        to_sensor = t2w[:3, 3] - ref_p
        dist = vm.length(to_sensor)
        d = to_sensor / dist[..., None].clamp_min(1e-12)
        d_cam = vm.normalize(vm.transform_vector(w2c, -d))
        theta = torch.arccos(d_cam[..., 1].clamp(-1.0, 1.0))
        phi = torch.arctan2(d_cam[..., 0], -d_cam[..., 2])
        # floor-mod, as jnp.mod
        px = torch.remainder((1.0 - (phi + math.pi) / (2.0 * math.pi)) * w, w)
        py = (theta / math.pi * h).clamp(0.0, h - 1e-3)
        sin_t = torch.sin(theta).clamp_min(1e-6)
        we = 1.0 / (2.0 * math.pi ** 2 * sin_t * dist.clamp_min(1e-12) ** 2)
        valid = dist > 1e-9
    elif st == schema.SENSOR_ORTHOGRAPHIC:
        # parallel projection: the connection direction is the camera axis
        # (a delta); the splat weight is 1/(world film area), no 1/dist^2
        sx, sy = params[7], params[8]
        p_cam = vm.transform_point(w2c, ref_p)
        z = p_cam[..., 2]
        px = (p_cam[..., 0] / sx.clamp_min(1e-9) + 1.0) * 0.5 * w
        py = (1.0 - p_cam[..., 1] / sy.clamp_min(1e-9)) * 0.5 * h
        d = (-(t2w[:3, 2] / vm.length(t2w[:3, 2]))).expand(ref_p.shape[0], 3)
        valid = (z > params[1]) & (px >= 0) & (px < w) & (py >= 0) & (py < h)
        dist = z
        we = (1.0 / (4.0 * sx * sy).clamp_min(1e-12)).expand(ref_p.shape[0])
    elif st == schema.SENSOR_TELECENTRIC:
        # ortho with an aperture: a lens offset on the disc; the film point
        # follows from the focus-plane constraint (x stays the ray family's
        # anchor). The lens pdf cancels against the lens-area factor of We
        # (exact as the aperture goes to 0; reference TelecentricSensor)
        sx, sy = params[7], params[8]
        r_ap, fd = params[3], params[4]
        lens = warp.square_to_uniform_disk_concentric(u) * r_ap
        p_cam = vm.transform_point(w2c, ref_p)
        z = p_cam[..., 2]
        # the anchor (x, y) solving p_xy = x + lx * (1 - z/fd)
        shrink = 1.0 - z / fd.clamp_min(1e-6)
        x = p_cam[..., 0] - lens[..., 0] * shrink
        y = p_cam[..., 1] - lens[..., 1] * shrink
        o_cam = torch.stack([x + lens[..., 0], y + lens[..., 1],
                             torch.zeros_like(x)], -1)
        to_lens = vm.transform_point(t2w, o_cam) - ref_p
        dist = vm.length(to_lens)
        d = to_lens / dist[..., None].clamp_min(1e-12)
        px = (x / sx.clamp_min(1e-9) + 1.0) * 0.5 * w
        py = (1.0 - y / sy.clamp_min(1e-9)) * 0.5 * h
        valid = (z > params[1]) & (px >= 0) & (px < w) & (py >= 0) & (py < h)
        we = (1.0 / (4.0 * sx * sy).clamp_min(1e-12)).expand(ref_p.shape[0])
    else:
        raise ValueError(f"unknown sensor type {st}")
    we = torch.where(valid, we, 0.0)
    return _direct(px, py, d, dist, we, valid)


def make_sensor(sensor_type: int, to_world, fov_x_deg: float = 35.0,
                film_w: int = 512, film_h: int = 512, near: float = 1e-3,
                far: float = 1e7, aperture_radius: float = 0.0,
                focus_distance: float = 1.0, ortho_scale=(1.0, 1.0)) -> schema.SensorData:
    """Host-side sensor row (CPU tensors; `DynamicScene.build` moves it)."""
    params = np.zeros(16, np.float32)
    params[0] = np.deg2rad(fov_x_deg)
    params[1], params[2] = near, far
    params[3], params[4] = aperture_radius, focus_distance
    params[5], params[6] = film_w, film_h
    params[7], params[8] = ortho_scale
    t2w = np.asarray(to_world, np.float32)
    return schema.SensorData(
        sensor_type=int(sensor_type),
        to_world=torch.from_numpy(t2w.copy()),
        to_world_inv=torch.from_numpy(np.linalg.inv(t2w)),
        params=torch.from_numpy(params))
