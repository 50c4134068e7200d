"""Sensor models: camera-ray generation.

Port of ``cudatracerlib_tpu/scene/sensors.py`` for the perspective sensor.
The other sensor types (spherical, thin lens, orthographic, telecentric)
and sensor-side direct sampling are not ported yet and raise.

Param layout (SensorData.params):
  [0] fov_x (radians)  [1] near  [2] far  [3] aperture_radius
  [4] focus_distance  [5] film_w  [6] film_h  [7] ortho_scale_x  [8] ortho_scale_y
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import vecmath as vm
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


def sample_ray(sensor: schema.SensorData, p_film: Tensor, u_aperture: Tensor) -> SensorRays:
    """Generate camera rays for continuous film positions (pixels).

    p_film: (B, 2) continuous pixel coordinates in [0,W)x[0,H).
    u_aperture: (B, 2) lens uniforms (unused by the pinhole perspective sensor).
    """
    if sensor.sensor_type != schema.SENSOR_PERSPECTIVE:
        raise NotImplementedError(
            f"sensor type {sensor.sensor_type} is not ported yet")
    B = p_film.shape[0]
    t2w = sensor.to_world
    d_cam = vm.normalize(_film_to_camera_dir(sensor.params, p_film))
    o = t2w[:3, 3].expand(B, 3)
    d = vm.normalize(vm.transform_vector(t2w, d_cam))
    return SensorRays(o, d, torch.ones((B, 3), dtype=torch.float32,
                                       device=p_film.device))


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
