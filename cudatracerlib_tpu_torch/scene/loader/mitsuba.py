"""Mitsuba 0.5 XML scene loader (host side, numpy).

Verbatim port of ``cudatracerlib_tpu/scene/loader/mitsuba.py``: one
recursive property parser over xml.etree with `<default>` substitution,
spec-producing sub-parsers, and a DynamicScene as the build target. Covers
the BSDFs with the twosided/mask/bumpmap adapters and the coating and blend
materials, obj/ply/serialized/rectangle/sphere/cube/disk/cylinder/
shapegroup/instance shapes, point/spot/directional/area/constant/envmap/
sun/sky emitters, all 5 sensors, bitmap/checkerboard/scale textures. As in
the JAX package, a bitmap or envmap image that cannot be loaded becomes a
grey 0.5 image, and an OBJ material's map_kd that cannot be loaded is
dropped. `load_mitsuba(...)[0].build(device)` builds the scene on the card
unless the caller asks for the CPU.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .. import host, schema, sensors, shapes
from ...utils import transforms as tf
from . import images, obj as objmod, ply as plymod, serialized as sermod

# ---------------------------------------------------------------------------
# IOR library (named dielectrics + conductor spectra at RGB resolution)
# reference: ObjectParser BsdfParser's IoR library + data/ior/*.spd files
# ---------------------------------------------------------------------------

DIELECTRIC_IOR = {
    "vacuum": 1.0, "helium": 1.000036, "hydrogen": 1.000132, "air": 1.000277,
    "carbon dioxide": 1.00045, "water": 1.3330, "acetone": 1.36,
    "ethanol": 1.361, "carbon tetrachloride": 1.461, "glycerol": 1.4729,
    "benzene": 1.501, "silicone oil": 1.52045, "bromine": 1.661,
    "water ice": 1.31, "fused quartz": 1.458, "pyrex": 1.470,
    "acrylic glass": 1.49, "polypropylene": 1.49, "bk7": 1.5046,
    "sodium chloride": 1.544, "amber": 1.55, "pet": 1.575, "diamond": 2.419,
}

# (eta_rgb, k_rgb) fits of the Mitsuba conductor spectra
CONDUCTOR_IOR = {
    "a-c": ((2.94, 2.22, 1.98), (0.88, 0.80, 0.82)),
    "ag": ((0.155, 0.116, 0.138), (4.82, 3.12, 2.14)),
    "al": ((1.345, 0.965, 0.617), (7.47, 6.40, 5.30)),
    "au": ((0.143, 0.375, 1.442), (3.98, 2.39, 1.60)),
    "cu": ((0.200, 0.924, 1.102), (3.91, 2.45, 2.14)),
    "cr": ((3.17, 3.18, 2.44), (3.30, 3.33, 3.74)),
    "li": ((0.265, 0.195, 0.220), (3.54, 2.35, 1.63)),
    "w": ((3.48, 3.33, 3.00), (2.71, 2.68, 2.94)),
    "ni": ((1.97, 1.79, 1.61), (3.78, 3.31, 2.86)),
    "hg": ((1.87, 1.52, 1.13), (5.11, 4.36, 3.65)),
    "tio2": ((2.78, 2.90, 3.27), (0.0, 0.0, 0.0)),
    "none": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
}

_SENSOR_TYPES = {
    "perspective": schema.SENSOR_PERSPECTIVE,
    "thinlens": schema.SENSOR_THINLENS,
    "orthographic": schema.SENSOR_ORTHOGRAPHIC,
    "spherical": schema.SENSOR_SPHERICAL,
    "telecentric": schema.SENSOR_TELECENTRIC,
}

_DIST_NAMES = {"beckmann": 0, "ggx": 1, "phong": 2, "as": 1}


@dataclass
class RenderSettings:
    integrator: str = "path"
    max_depth: int = 8
    rr_depth: int = 5
    spp: int = 16
    width: int = 512
    height: int = 512


@dataclass
class _Ctx:
    base_dir: str
    defaults: Dict[str, str]
    named: Dict[str, object] = field(default_factory=dict)   # id -> spec object
    shapegroups: Dict[str, list] = field(default_factory=dict)


def _subst(val: str, ctx: _Ctx) -> str:
    if "$" in val:
        for k, v in ctx.defaults.items():
            val = val.replace("$" + k, v)
    return val


def _parse_spectrum(val: str):
    """rgb / single-value / wavelength-list spectra -> rgb tuple."""
    val = val.strip()
    if "," in val or " " in val:
        parts = [p for p in val.replace(",", " ").split() if p]
        if ":" in val:  # wavelength:value pairs -> average into rgb crudely
            pairs = [(float(a), float(b)) for a, b in (p.split(":") for p in parts)]
            lam = np.array([p[0] for p in pairs])
            v = np.array([p[1] for p in pairs])
            def band(lo, hi):
                m = (lam >= lo) & (lam < hi)
                return float(v[m].mean()) if m.any() else float(v.mean())
            return (band(580, 780), band(480, 580), band(380, 480))
        vals = [float(p) for p in parts]
        if len(vals) >= 3:
            return tuple(vals[:3])
        return (vals[0],) * 3
    f = float(val)
    return (f, f, f)


def _parse_transform(elem: ET.Element, ctx: _Ctx) -> np.ndarray:
    m = tf.identity()
    for child in elem:
        tag = child.tag
        a = {k: _subst(v, ctx) for k, v in child.attrib.items()}
        if tag == "translate":
            t = [float(a.get(k, 0)) for k in "xyz"]
            m = tf.translate(t) @ m
        elif tag == "scale":
            if "value" in a:
                s = [float(a["value"])] * 3
            else:
                s = [float(a.get(k, 1)) for k in "xyz"]
            m = tf.scale(s) @ m
        elif tag == "rotate":
            axis = [float(a.get(k, 0)) for k in "xyz"]
            m = tf.rotate_deg(axis, float(a.get("angle", 0))) @ m
        elif tag == "matrix":
            vals = [float(x) for x in a["value"].split()]
            if len(vals) == 16:
                mm = np.asarray(vals, np.float32).reshape(4, 4)
            else:
                mm = np.eye(4, dtype=np.float32)
                mm[:3, :3] = np.asarray(vals, np.float32).reshape(3, 3)
            m = mm @ m
        elif tag in ("lookat", "lookAt"):
            origin = [float(x) for x in a["origin"].replace(",", " ").split()]
            target = [float(x) for x in a["target"].replace(",", " ").split()]
            up = [float(x) for x in a.get("up", "0, 1, 0").replace(",", " ").split()]
            m = tf.look_at(origin, target, up) @ m
    return m


def _parse_props(elem: ET.Element, ctx: _Ctx):
    """Collect typed child properties + nested objects of a plugin element."""
    props: Dict[str, object] = {}
    nested: List[ET.Element] = []
    for child in elem:
        tag = child.tag
        a = {k: _subst(v, ctx) for k, v in child.attrib.items()}
        name = a.get("name", "")
        if tag == "float":
            props[name] = float(a["value"])
        elif tag == "integer":
            props[name] = int(float(a["value"]))
        elif tag == "boolean":
            props[name] = a["value"].lower() == "true"
        elif tag == "string":
            props[name] = a["value"]
        elif tag in ("rgb", "srgb", "spectrum", "blackbody"):
            if tag == "blackbody":
                from ...core import spectrum as spmod
                t = float(a.get("temperature", 6500))
                props[name] = tuple(spmod.blackbody(t).tolist())
            else:
                rgb = _parse_spectrum(a["value"])
                if tag == "srgb":
                    rgb = tuple(float(np.where(c <= 0.04045, c / 12.92,
                                               ((c + 0.055) / 1.055) ** 2.4)) for c in rgb)
                props[name] = rgb
        elif tag in ("point", "vector"):
            if "value" in a:
                props[name] = tuple(float(x) for x in a["value"].replace(",", " ").split())
            else:
                props[name] = (float(a.get("x", 0)), float(a.get("y", 0)), float(a.get("z", 0)))
        elif tag == "transform":
            props[name or "toWorld"] = _parse_transform(child, ctx)
        elif tag in ("bsdf", "texture", "emitter", "medium", "shape", "ref",
                     "phase", "volume"):
            nested.append(child)
    return props, nested


def _tex_from_elem(elem: ET.Element, ctx: _Ctx) -> host.TextureSpec:
    if elem.tag == "ref":
        t = ctx.named.get(elem.attrib.get("id", ""))
        if isinstance(t, host.TextureSpec):
            return t
        return host.TextureSpec()
    ttype = elem.attrib.get("type", "bitmap")
    props, nested = _parse_props(elem, ctx)
    if ttype == "bitmap":
        fn = os.path.join(ctx.base_dir, str(props.get("filename", "")))
        gamma = props.get("gamma", -1)
        try:
            img = images.load_image(fn, gamma=(gamma != 1.0))
        except Exception:
            img = np.full((2, 2, 3), 0.5, np.float32)  # missing texture -> gray
        spec = host.TextureSpec(
            tex_type=schema.TEX_IMAGE, image=img,
            uv_scale=(float(props.get("uscale", 1)), float(props.get("vscale", 1))),
            uv_offset=(float(props.get("uoffset", 0)), float(props.get("voffset", 0))))
    elif ttype in ("checkerboard", "gridtexture"):
        spec = host.TextureSpec(
            tex_type=schema.TEX_CHECKERBOARD,
            value=props.get("color0", (0.4, 0.4, 0.4)),
            value1=props.get("color1", (0.2, 0.2, 0.2)),
            uv_scale=(float(props.get("uscale", 1)) * 2, float(props.get("vscale", 1)) * 2))
    elif ttype == "scale":
        inner = None
        for n in nested:
            if n.tag in ("texture", "ref"):
                inner = _tex_from_elem(n, ctx)
        s = props.get("scale", 1.0)
        s3 = (s, s, s) if not isinstance(s, tuple) else s
        if inner is not None and inner.image is not None:
            spec = host.TextureSpec(tex_type=schema.TEX_IMAGE,
                                    image=inner.image * np.asarray(s3, np.float32),
                                    uv_scale=inner.uv_scale, uv_offset=inner.uv_offset)
        elif inner is not None:
            spec = host.TextureSpec(tex_type=inner.tex_type,
                                    value=tuple(v * w for v, w in zip(inner.value, s3)),
                                    value1=tuple(v * w for v, w in zip(inner.value1, s3)),
                                    uv_scale=inner.uv_scale, uv_offset=inner.uv_offset)
        else:
            spec = host.TextureSpec(value=s3)
    elif ttype == "wireframe":
        spec = host.TextureSpec(tex_type=schema.TEX_WIREFRAME,
                                value=props.get("interiorColor", (0.5, 0.5, 0.5)),
                                value1=props.get("edgeColor", (0.1, 0.1, 0.1)))
    elif ttype == "vertexcolors":
        spec = host.TextureSpec(tex_type=schema.TEX_EXTRADATA)
    else:
        spec = host.TextureSpec(value=(0.5, 0.5, 0.5))
    tid = elem.attrib.get("id")
    if tid:
        ctx.named[tid] = spec
    return spec


def _ior_value(props, key_num, key_name, default):
    if key_num in props:
        return float(props[key_num])
    if key_name in props:
        return DIELECTRIC_IOR.get(str(props[key_name]).lower(), default)
    return default


def _color_or_tex(props, nested, ctx, names, default):
    """Return (rgb tuple, TextureSpec|None) for a possibly-textured property."""
    for nm in names:
        if nm in props:
            return props[nm], None
    for n in nested:
        target = n.attrib.get("name", "")
        if target in names and n.tag in ("texture", "ref"):
            t = _tex_from_elem(n, ctx)
            return default, t
    return default, None


def parse_bsdf(elem: ET.Element, ctx: _Ctx) -> host.MaterialSpec:
    """BSDF element -> MaterialSpec (recursive for adapters/nested)."""
    if elem.tag == "ref":
        m = ctx.named.get(elem.attrib.get("id", ""))
        if isinstance(m, host.MaterialSpec):
            return m
        return host.MaterialSpec()
    btype = elem.attrib.get("type", "diffuse")
    props, nested = _parse_props(elem, ctx)
    child_bsdfs = [n for n in nested if n.tag in ("bsdf", "ref")
                   and not isinstance(ctx.named.get(n.attrib.get("id", "")), host.TextureSpec)]

    def dist():
        return _DIST_NAMES.get(str(props.get("distribution", "beckmann")).lower(), 0)

    def alphas():
        a = float(props.get("alpha", 0.1))
        return a, float(props.get("alphaU", a)), float(props.get("alphaV", a))

    spec: host.MaterialSpec
    if btype == "twosided":
        spec = parse_bsdf(child_bsdfs[0], ctx) if child_bsdfs else host.MaterialSpec()
        spec = _clone(spec, two_sided=True)
    elif btype == "mask":
        inner = parse_bsdf(child_bsdfs[0], ctx) if child_bsdfs else host.MaterialSpec()
        _, opac_tex = _color_or_tex(props, nested, ctx, ("opacity",), (1, 1, 1))
        # extension props mapping to the reference's AlphaBlendState modes
        # (Engine/Material.h:13-35): default stays Mitsuba's continuous
        # opacity; alphaMode in {luminance, alpha, color} makes it a binary
        # test at threshold alphaTest (optionally against alphaTestColor and
        # sampling the reflectance texture with alphaSource="reflectance")
        mode_name = str(props.get("alphaMode", "")).lower()
        mode = {"": 0, "luminance": schema.ALPHA_LUMINANCE,
                "alpha": schema.ALPHA_ALPHA,
                "color": schema.ALPHA_COLOR}.get(mode_name, 0)
        if mode and str(props.get("alphaSource", "")).lower() == "reflectance":
            mode |= schema.ALPHA_SRC_REFLECTANCE
        tc = props.get("alphaTestColor", (0.0, 0.0, 0.0))
        if isinstance(tc, str):
            tc = tuple(float(x) for x in tc.replace(",", " ").split())
        spec = _clone(inner, tex_alpha_mask=opac_tex, alpha_mode=mode,
                      alpha_test=float(props.get("alphaTest", 0.5)),
                      alpha_test_color=tuple(tc))
    elif btype == "bumpmap":
        inner = parse_bsdf(child_bsdfs[0], ctx) if child_bsdfs else host.MaterialSpec()
        bump = None
        for n in nested:
            if n.tag in ("texture", "ref") and n.attrib.get("name", "") in ("", "map", "bumpmap"):
                bump = _tex_from_elem(n, ctx)
        spec = _clone(inner, tex_bump=bump)
    elif btype in ("diffuse", "roughdiffuse"):
        refl, tex = _color_or_tex(props, nested, ctx, ("reflectance", "diffuseReflectance"),
                                  (0.5, 0.5, 0.5))
        spec = host.MaterialSpec(
            bsdf_type=schema.BSDF_ROUGHDIFFUSE if btype == "roughdiffuse" else schema.BSDF_DIFFUSE,
            reflectance=refl, tex_reflectance=tex, alpha=float(props.get("alpha", 0.2)))
    elif btype in ("dielectric", "thindielectric", "roughdielectric"):
        int_ior = _ior_value(props, "intIOR", "intIORName", 1.5046)
        if isinstance(props.get("intIOR"), str):
            int_ior = DIELECTRIC_IOR.get(props["intIOR"].lower(), 1.5046)
        ext_ior = _ior_value(props, "extIOR", "extIORName", 1.000277)
        if isinstance(props.get("extIOR"), str):
            ext_ior = DIELECTRIC_IOR.get(props["extIOR"].lower(), 1.000277)
        sr, sr_tex = _color_or_tex(props, nested, ctx, ("specularReflectance",), (1, 1, 1))
        st, st_tex = _color_or_tex(props, nested, ctx, ("specularTransmittance",), (1, 1, 1))
        a, au, av = alphas()
        kinds = {"dielectric": schema.BSDF_DIELECTRIC,
                 "thindielectric": schema.BSDF_THINDIELECTRIC,
                 "roughdielectric": schema.BSDF_ROUGHDIELECTRIC}
        spec = host.MaterialSpec(bsdf_type=kinds[btype], eta=int_ior / ext_ior,
                                 reflectance=sr, transmittance=st,
                                 tex_reflectance=sr_tex, tex_transmittance=st_tex,
                                 alpha=au, alpha_v=av, distribution=dist(), two_sided=False)
    elif btype in ("conductor", "roughconductor"):
        mat = str(props.get("material", "cu")).lower()
        eta_c, k_c = CONDUCTOR_IOR.get(mat, CONDUCTOR_IOR["cu"])
        if "eta" in props:
            eta_c = props["eta"] if isinstance(props["eta"], tuple) else (props["eta"],) * 3
        if "k" in props:
            k_c = props["k"] if isinstance(props["k"], tuple) else (props["k"],) * 3
        sr, sr_tex = _color_or_tex(props, nested, ctx, ("specularReflectance",), (1, 1, 1))
        a, au, av = alphas()
        spec = host.MaterialSpec(
            bsdf_type=schema.BSDF_ROUGHCONDUCTOR if btype == "roughconductor" else schema.BSDF_CONDUCTOR,
            reflectance=sr, tex_reflectance=sr_tex, eta_c=eta_c, k_c=k_c,
            alpha=au, alpha_v=av, distribution=dist())
    elif btype in ("plastic", "roughplastic"):
        int_ior = _ior_value(props, "intIOR", "intIORName", 1.49)
        ext_ior = _ior_value(props, "extIOR", "extIORName", 1.000277)
        dr, dr_tex = _color_or_tex(props, nested, ctx, ("diffuseReflectance",), (0.5, 0.5, 0.5))
        sr, sr_tex = _color_or_tex(props, nested, ctx, ("specularReflectance",), (1, 1, 1))
        a, au, av = alphas()
        spec = host.MaterialSpec(
            bsdf_type=schema.BSDF_ROUGHPLASTIC if btype == "roughplastic" else schema.BSDF_PLASTIC,
            reflectance=sr, transmittance=dr, tex_reflectance=sr_tex,
            tex_transmittance=dr_tex, eta=int_ior / ext_ior,
            nonlinear=bool(props.get("nonlinear", False)),
            alpha=au, alpha_v=av, distribution=dist())
    elif btype == "phong":
        sr, sr_tex = _color_or_tex(props, nested, ctx, ("specularReflectance",), (0.2,) * 3)
        dr, dr_tex = _color_or_tex(props, nested, ctx, ("diffuseReflectance",), (0.5,) * 3)
        spec = host.MaterialSpec(bsdf_type=schema.BSDF_PHONG, reflectance=sr,
                                 transmittance=dr, tex_reflectance=sr_tex,
                                 tex_transmittance=dr_tex,
                                 exponent=float(props.get("exponent", 30)))
    elif btype == "ward":
        sr, sr_tex = _color_or_tex(props, nested, ctx, ("specularReflectance",), (0.2,) * 3)
        dr, dr_tex = _color_or_tex(props, nested, ctx, ("diffuseReflectance",), (0.5,) * 3)
        a, au, av = alphas()
        spec = host.MaterialSpec(bsdf_type=schema.BSDF_WARD, reflectance=sr,
                                 transmittance=dr, tex_reflectance=sr_tex,
                                 tex_transmittance=dr_tex, alpha=au, alpha_v=av)
    elif btype == "hk":
        ss = props.get("sigmaS", (2.0, 2.0, 2.0))
        sa = props.get("sigmaA", (0.05, 0.05, 0.05))
        spec = host.MaterialSpec(bsdf_type=schema.BSDF_HK, reflectance=ss,
                                 transmittance=sa, thickness=float(props.get("thickness", 1)),
                                 phase_g=0.0, two_sided=False)
    elif btype in ("coating", "roughcoating"):
        inner = parse_bsdf(child_bsdfs[0], ctx) if child_bsdfs else host.MaterialSpec()
        int_ior = _ior_value(props, "intIOR", "intIORName", 1.49)
        ext_ior = _ior_value(props, "extIOR", "extIORName", 1.000277)
        sa = props.get("sigmaA", (0.0, 0.0, 0.0))
        a, au, av = alphas()
        spec = host.MaterialSpec(
            bsdf_type=schema.BSDF_ROUGHCOATING if btype == "roughcoating" else schema.BSDF_COATING,
            eta=int_ior / ext_ior, transmittance=sa,
            thickness=float(props.get("thickness", 1)),
            alpha=au, alpha_v=av, distribution=dist(), nested=inner)
    elif btype == "blendbsdf":
        b1 = parse_bsdf(child_bsdfs[0], ctx) if len(child_bsdfs) > 0 else host.MaterialSpec()
        b2 = parse_bsdf(child_bsdfs[1], ctx) if len(child_bsdfs) > 1 else host.MaterialSpec()
        spec = host.MaterialSpec(bsdf_type=schema.BSDF_BLEND,
                                 blend_weight=float(props.get("weight", 0.5)),
                                 nested=b1, nested2=b2)
    elif btype == "null":
        spec = host.MaterialSpec(bsdf_type=schema.BSDF_NULL, two_sided=False)
    else:
        spec = host.MaterialSpec()  # unknown -> gray diffuse
    bid = elem.attrib.get("id")
    if bid:
        ctx.named[bid] = spec
    return spec


def _clone(spec: host.MaterialSpec, **kw) -> host.MaterialSpec:
    import dataclasses
    return dataclasses.replace(spec, **kw)


def _load_shape_mesh(stype: str, props, ctx: _Ctx):
    """Shape plugin -> list of (TriMesh, MaterialSpec|None from file)."""
    if stype == "obj":
        fn = os.path.join(ctx.base_dir, str(props["filename"]))
        subs = objmod.load_obj(fn)
        return [(s.mesh, s.material) for s in subs]
    if stype == "ply":
        fn = os.path.join(ctx.base_dir, str(props["filename"]))
        return [(plymod.load_ply(fn), None)]
    if stype == "serialized":
        fn = os.path.join(ctx.base_dir, str(props["filename"]))
        return [(sermod.load_serialized(fn, int(props.get("shapeIndex", 0))), None)]
    if stype == "rectangle":
        return [(shapes.rectangle(), None)]
    if stype == "cube":
        return [(shapes.cube(), None)]
    if stype == "sphere":
        c = props.get("center", (0.0, 0.0, 0.0))
        r = float(props.get("radius", 1.0))
        return [(shapes.sphere(radius=r, center=c), None)]
    if stype == "disk":
        return [(shapes.disk(), None)]
    if stype == "cylinder":
        return [(shapes.cylinder(p0=props.get("p0", (0, 0, 0)),
                                 p1=props.get("p1", (0, 0, 1)),
                                 radius=float(props.get("radius", 1))), None)]
    return []


def load_mitsuba(path: str, scene_out: Optional[host.DynamicScene] = None,
                 override_res: Optional[tuple] = None):
    """Parse a Mitsuba XML file into a DynamicScene + RenderSettings."""
    tree = ET.parse(path)
    root = tree.getroot()
    base_dir = os.path.dirname(os.path.abspath(path))
    ctx = _Ctx(base_dir=base_dir, defaults={})
    sc = scene_out or host.DynamicScene()
    settings = RenderSettings()

    for d in root.findall("default"):
        ctx.defaults[d.attrib["name"]] = d.attrib["value"]

    for elem in root:
        tag = elem.tag
        if tag == "integrator":
            settings.integrator = elem.attrib.get("type", "path")
            props, _ = _parse_props(elem, ctx)
            settings.max_depth = int(props.get("maxDepth", 8))
            settings.rr_depth = int(props.get("rrDepth", 5))
        elif tag == "sensor":
            _parse_sensor(elem, ctx, sc, settings, override_res)
        elif tag == "bsdf":
            parse_bsdf(elem, ctx)
        elif tag == "texture":
            _tex_from_elem(elem, ctx)
        elif tag == "shape":
            _parse_shape(elem, ctx, sc)
        elif tag == "emitter":
            _parse_scene_emitter(elem, ctx, sc)
    return sc, settings


def _parse_sensor(elem, ctx: _Ctx, sc: host.DynamicScene, settings: RenderSettings,
                  override_res):
    stype = _SENSOR_TYPES.get(elem.attrib.get("type", "perspective"),
                              schema.SENSOR_PERSPECTIVE)
    props, nested = _parse_props(elem, ctx)
    w, h = 512, 512
    for film in elem.findall("film"):
        fprops, _ = _parse_props(film, ctx)
        w = int(fprops.get("width", 512))
        h = int(fprops.get("height", 512))
    for sampler in elem.findall("sampler"):
        sprops, _ = _parse_props(sampler, ctx)
        settings.spp = int(sprops.get("sampleCount", 16))
    if override_res:
        w, h = override_res
    settings.width, settings.height = w, h
    to_world = props.get("toWorld", tf.identity())
    fov = float(props.get("fov", 35.0))
    fov_axis = str(props.get("fovAxis", "x")).lower()
    if fov_axis == "y":
        fov = float(np.rad2deg(2 * np.arctan(np.tan(np.deg2rad(fov) / 2) * w / h)))
    elif fov_axis == "smaller":
        if h < w:
            fov = float(np.rad2deg(2 * np.arctan(np.tan(np.deg2rad(fov) / 2) * w / h)))
    sc.set_sensor(sensors.make_sensor(
        stype, to_world, fov_x_deg=fov, film_w=w, film_h=h,
        near=float(props.get("nearClip", 1e-2)), far=float(props.get("farClip", 1e4)),
        aperture_radius=float(props.get("apertureRadius", 0.0)),
        focus_distance=float(props.get("focusDistance", 1.0)),
        ortho_scale=(1.0, 1.0)))


def _parse_shape(elem, ctx: _Ctx, sc: host.DynamicScene, group: Optional[list] = None):
    stype = elem.attrib.get("type", "obj")
    props, nested = _parse_props(elem, ctx)
    to_world = props.get("toWorld", tf.identity())

    if stype == "shapegroup":
        items: list = []
        for sub in elem.findall("shape"):
            _parse_shape(sub, ctx, sc, group=items)
        gid = elem.attrib.get("id", f"group{len(ctx.shapegroups)}")
        ctx.shapegroups[gid] = items
        return
    if stype == "instance":
        ref_id = None
        for n in elem.findall("ref"):
            ref_id = n.attrib.get("id")
        items = ctx.shapegroups.get(ref_id, [])
        for (mesh, mat_id, emission) in items:
            sc.create_node(mesh, mat_id, to_world=to_world, emission=emission,
                           name=f"instance:{ref_id}")
        return

    # material: nested/ref bsdf, else default gray
    mat_spec = None
    for n in elem:
        if n.tag == "bsdf":
            mat_spec = parse_bsdf(n, ctx)
        elif n.tag == "ref":
            cand = ctx.named.get(n.attrib.get("id", ""))
            if isinstance(cand, host.MaterialSpec):
                mat_spec = cand

    # area emitter attached to this shape?
    emission = None
    for n in elem.findall("emitter"):
        if n.attrib.get("type") == "area":
            eprops, _ = _parse_props(n, ctx)
            emission = eprops.get("radiance", (1.0, 1.0, 1.0))

    pieces = _load_shape_mesh(stype, props, ctx)
    for mesh, file_mat in pieces:
        if mat_spec is not None:
            spec = mat_spec
        elif file_mat is not None:
            spec = _obj_mat_to_spec(file_mat)
        else:
            spec = host.MaterialSpec()
        if bool(props.get("flipNormals", False)):
            mesh = shapes.TriMesh(mesh.v, mesh.f[:, ::-1],
                                  -mesh.n if mesh.n is not None else None, mesh.uv)
        if file_mat is not None and any(c > 0 for c in file_mat.ke) and emission is None:
            emission = file_mat.ke
        mat_id = sc.add_material(spec)
        if group is not None:
            group.append((mesh.transformed(to_world), mat_id, emission))
        else:
            sc.create_node(mesh, mat_id, to_world=to_world, emission=emission,
                           name=f"{stype}:{props.get('filename', '')}")


def _obj_mat_to_spec(m) -> host.MaterialSpec:
    tex = None
    if m.map_kd:
        try:
            img = images.load_image(m.map_kd if os.path.isabs(m.map_kd) else m.map_kd)
            tex = host.TextureSpec(tex_type=schema.TEX_IMAGE, image=img)
        except Exception:
            tex = None
    ks_lum = sum(m.ks) / 3
    if m.d < 1.0 or m.illum in (4, 6, 7, 9):
        return host.MaterialSpec(bsdf_type=schema.BSDF_DIELECTRIC, eta=max(m.ni, 1.01),
                                 two_sided=False)
    if ks_lum > 0.4 and m.illum >= 3:
        return host.MaterialSpec(bsdf_type=schema.BSDF_ROUGHCONDUCTOR,
                                 reflectance=(1, 1, 1),
                                 alpha=float(np.clip(np.sqrt(2.0 / (m.ns + 2)), 0.01, 0.5)))
    if ks_lum > 0.0:
        return host.MaterialSpec(bsdf_type=schema.BSDF_PHONG, reflectance=m.ks,
                                 transmittance=m.kd, tex_transmittance=tex,
                                 exponent=max(m.ns, 1.0))
    return host.MaterialSpec(reflectance=m.kd, tex_reflectance=tex)


def _parse_scene_emitter(elem, ctx: _Ctx, sc: host.DynamicScene):
    etype = elem.attrib.get("type", "point")
    props, nested = _parse_props(elem, ctx)
    if etype == "point":
        sc.add_point_light(props.get("position", (0, 0, 0)),
                           props.get("intensity", (1, 1, 1)))
    elif etype == "spot":
        to_world = props.get("toWorld", tf.identity())
        pos = to_world[:3, 3]
        d = to_world[:3, 2]
        sc.add_spot_light(pos, d, props.get("intensity", (1, 1, 1)),
                          cutoff_deg=float(props.get("cutoffAngle", 20)),
                          beam_deg=float(props.get("beamWidth",
                                                   float(props.get("cutoffAngle", 20)) * 0.75)))
    elif etype in ("directional", "sun"):
        d = props.get("direction", (0, -1, 0))
        rad = props.get("irradiance", props.get("radiance", (1, 1, 1)))
        if etype == "sun":
            rad = tuple(float(props.get("scale", 1)) * 20.0 * c for c in (1.0, 0.95, 0.85))
            d = props.get("sunDirection", d)
        sc.add_distant_light(d, rad)
    elif etype == "constant":
        rad = props.get("radiance", (1, 1, 1))
        sc.set_environment(np.full((1, 1, 3), 1.0, np.float32), scale=rad)
    elif etype in ("envmap",):
        fn = os.path.join(ctx.base_dir, str(props.get("filename", "")))
        try:
            img = images.load_image(fn)
        except Exception:
            img = np.full((2, 2, 3), 0.5, np.float32)
        sc.set_environment(img, scale=(float(props.get("scale", 1)),) * 3,
                           to_world=props.get("toWorld", None))
    elif etype in ("sky", "sunsky"):
        from .. import sunsky
        sun_dir = props.get("sunDirection", None)
        if sun_dir is None:
            # hour/latitude support can layer on; default: mid-morning sun
            sun_dir = (0.35, 0.7, 0.45)
        img = sunsky.preetham_sky(
            sun_dir, turbidity=float(props.get("turbidity", 3.0)),
            with_sun=(etype == "sunsky"),
            sky_scale=float(props.get("scale", 1.0)),
            sun_scale=float(props.get("sunScale", 1.0)))
        sc.set_environment(img)
