"""Core math of the port against the JAX package on random inputs.

Tolerance: rtol 1e-6, with atol 1e-6 for values near zero (cancellation in
cross products and frame changes). Neither side is exact: XLA on the CPU may
contract a*b+c into an FMA where PyTorch rounds twice."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudatracerlib_tpu.core import frame as jframe, mis as jmis
from cudatracerlib_tpu.core import vecmath as jvm, warp as jwarp
from cudatracerlib_tpu_torch.core import frame as tframe, mis as tmis
from cudatracerlib_tpu_torch.core import vecmath as tvm, warp as twarp

torch.set_num_threads(2)
TOL = dict(rtol=1e-6, atol=1e-6)
N = 4096


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.fixture(scope="module")
def data():
    r = np.random.default_rng(5)
    a = r.normal(size=(N, 3)).astype(np.float32)
    b = r.normal(size=(N, 3)).astype(np.float32)
    n = a / np.linalg.norm(a, axis=1, keepdims=True)
    u2 = r.random((N, 2), dtype=np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3] = r.normal(size=(3, 4)).astype(np.float32)
    return a, b, n, u2, m


@pytest.mark.parametrize("name", ["dot", "cross", "normalize", "length",
                                  "reflect", "coordinate_system"])
def test_vecmath(data, name):
    a, b, n, _, _ = data
    ta, tb, tn = map(torch.from_numpy, (a, b, n))
    if name == "coordinate_system":
        for x, y in zip(tvm.coordinate_system(tn), jvm.coordinate_system(jnp.asarray(n))):
            _close(x, y)
        return
    args = {"dot": (a, b), "cross": (a, b), "normalize": (a,),
            "length": (a,), "reflect": (a, n)}[name]
    _close(getattr(tvm, name)(*map(torch.from_numpy, args)),
           getattr(jvm, name)(*map(jnp.asarray, args)))
    del ta, tb


def test_transforms(data):
    a, _, _, _, m = data
    _close(tvm.transform_vector(torch.from_numpy(m), torch.from_numpy(a)),
           jvm.transform_vector(jnp.asarray(m), jnp.asarray(a)))
    _close(tvm.transform_point(torch.from_numpy(m), torch.from_numpy(a)),
           jvm.transform_point(jnp.asarray(m), jnp.asarray(a)))


def test_frame(data):
    a, _, n, _, _ = data
    tf = tframe.Frame.from_normal(torch.from_numpy(n))
    jf = jframe.Frame.from_normal(jnp.asarray(n))
    loc = tf.to_local(torch.from_numpy(a))
    _close(loc, jf.to_local(jnp.asarray(a)))
    _close(tf.to_world(loc), jf.to_world(jf.to_local(jnp.asarray(a))))
    tfn = tframe.Frame.from_tn(torch.from_numpy(a), torch.from_numpy(n))
    jfn = jframe.Frame.from_tn(jnp.asarray(a), jnp.asarray(n))
    for x, y in zip(tfn, jfn):
        _close(x, y)
    for name in ["cos_theta", "abs_cos_theta", "sin_theta2", "sin_theta",
                 "tan_theta", "tan_theta2", "sin_phi", "cos_phi"]:
        _close(getattr(tframe, name)(torch.from_numpy(n)),
               getattr(jframe, name)(jnp.asarray(n)))


@pytest.mark.parametrize("name", [
    "square_to_uniform_sphere", "square_to_uniform_hemisphere",
    "square_to_uniform_disk",
    "square_to_uniform_disk_concentric", "square_to_uniform_triangle",
    "square_to_std_normal", "square_to_tent"])
def test_warp(data, name):
    u2 = data[3]
    _close(getattr(twarp, name)(torch.from_numpy(u2)),
           getattr(jwarp, name)(jnp.asarray(u2)))


def test_warp_cosine_hemisphere(data):
    # z = sqrt(1 - x^2 - y^2) magnifies one-ulp differences of sin/cos near
    # the rim, so z is compared through z^2, which has no such magnification
    u2 = data[3]
    t = twarp.square_to_cosine_hemisphere(torch.from_numpy(u2))
    j = np.asarray(jwarp.square_to_cosine_hemisphere(jnp.asarray(u2)))
    _close(t[:, :2], j[:, :2])
    _close(t[:, 2] ** 2, j[:, 2] ** 2)


def test_warp_cone_and_pdfs(data):
    u2, n = data[3], data[2]
    cc = np.linspace(-0.5, 0.99, N).astype(np.float32)
    _close(twarp.square_to_uniform_cone(torch.from_numpy(u2), torch.from_numpy(cc)),
           jwarp.square_to_uniform_cone(jnp.asarray(u2), jnp.asarray(cc)))
    _close(twarp.square_to_uniform_cone_pdf(torch.from_numpy(cc)),
           jwarp.square_to_uniform_cone_pdf(jnp.asarray(cc)))
    _close(twarp.square_to_cosine_hemisphere_pdf(torch.from_numpy(n)),
           jwarp.square_to_cosine_hemisphere_pdf(jnp.asarray(n)))


def test_mis(data):
    r = np.random.default_rng(9)
    pa, pb = (r.random(N, dtype=np.float32) * 10 for _ in range(2))
    pb[:16] = 0.0
    for name in ["balance_heuristic", "power_heuristic"]:
        _close(getattr(tmis, name)(torch.from_numpy(pa), torch.from_numpy(pb)),
               getattr(jmis, name)(jnp.asarray(pa), jnp.asarray(pb)))
    d2, c = pa + 0.1, pb - 5.0
    for name in ["pdf_area_to_solid_angle", "pdf_solid_angle_to_area"]:
        _close(getattr(tmis, name)(torch.from_numpy(pa), torch.from_numpy(d2),
                                   torch.from_numpy(c)),
               getattr(jmis, name)(jnp.asarray(pa), jnp.asarray(d2), jnp.asarray(c)))
