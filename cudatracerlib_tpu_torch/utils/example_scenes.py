"""Procedural example scenes (port of ``cudatracerlib_tpu/utils/example_scenes.py``)."""
from __future__ import annotations

from ..scene import host, schema, sensors, shapes
from . import transforms as tf


def cornell_box(width: int = 256, height: int = 256, spheres: bool = True):
    """Classic Cornell box: white room, red/green walls, area light, two objects."""
    sc = host.DynamicScene()
    white = sc.add_material(host.MaterialSpec(reflectance=(0.725, 0.71, 0.68)))
    red = sc.add_material(host.MaterialSpec(reflectance=(0.63, 0.065, 0.05)))
    green = sc.add_material(host.MaterialSpec(reflectance=(0.14, 0.45, 0.091)))
    black = sc.add_material(host.MaterialSpec(reflectance=(0.0, 0.0, 0.0)))

    rect = shapes.rectangle()
    sc.create_node(rect, white, tf.compose(tf.translate([0, -1, 0]), tf.rotate_deg([1, 0, 0], -90)), name="floor")
    sc.create_node(rect, white, tf.compose(tf.translate([0, 1, 0]), tf.rotate_deg([1, 0, 0], 90)), name="ceiling")
    sc.create_node(rect, white, tf.compose(tf.translate([0, 0, 1]), tf.rotate_deg([0, 1, 0], 180)), name="back")
    sc.create_node(rect, red, tf.compose(tf.translate([-1, 0, 0]), tf.rotate_deg([0, 1, 0], 90)), name="left")
    sc.create_node(rect, green, tf.compose(tf.translate([1, 0, 0]), tf.rotate_deg([0, 1, 0], -90)), name="right")

    # area light: small rectangle near the ceiling, facing down
    sc.create_node(rect, black,
                   tf.compose(tf.translate([0, 0.995, 0]), tf.rotate_deg([1, 0, 0], 90),
                              tf.scale(0.25)),
                   emission=(17.0, 12.0, 4.0), name="light")

    if spheres:
        sc.create_node(shapes.sphere(radius=0.35, center=(0, 0, 0), n_theta=24, n_phi=48),
                       white, tf.translate([-0.4, -0.65, 0.3]), name="sphere")
        sc.create_node(shapes.cube(), white,
                       tf.compose(tf.translate([0.45, -0.7, -0.2]),
                                  tf.rotate_deg([0, 1, 0], 20), tf.scale([0.25, 0.3, 0.25])),
                       name="box")

    cam = sensors.make_sensor(
        schema.SENSOR_PERSPECTIVE,
        tf.look_at([0, 0, -3.5], [0, 0, 0]),
        fov_x_deg=32.0, film_w=width, film_h=height)
    sc.set_sensor(cam)
    return sc
