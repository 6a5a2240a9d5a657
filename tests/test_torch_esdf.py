"""The port's signed distance field (``models.esdf``, ``native.py``) held
against the JAX package's on the same NumPy grids, float64.

Tolerances: the exact transforms (min-plus and the C++ one) and the
trilinear query to 1e-12; the collision potential to 1e-14; the query's
gradient against ``jax.grad`` to 1e-10.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mav_tube_trajectory_generation_tpu.models import esdf as jesdf
from mav_tube_trajectory_generation_tpu_torch import convert
from mav_tube_trajectory_generation_tpu_torch import native as tnative
from mav_tube_trajectory_generation_tpu_torch.models import esdf as tesdf

from torch_port_util import to_np, tt

ORIGIN = (0.1, -0.2, 0.3)
RES = 0.25


def _grid(shape, seed, density=0.06):
    rng = np.random.RandomState(seed)
    occ = rng.rand(*shape) < density
    occ[tuple(s // 2 for s in shape)] = True
    return occ


@pytest.fixture(scope="module")
def fields():
    occ = _grid((16, 18, 20), 0)
    jf = jesdf.esdf_from_occupancy(occ, ORIGIN, RES, dtype=jnp.float64,
                                   method="xla")
    tf = tesdf.esdf_from_occupancy(occ, ORIGIN, RES, dtype=torch.float64,
                                   method="xla", device="cpu")
    return occ, jf, tf


@pytest.mark.parametrize("method", ["xla", "native"])
@pytest.mark.parametrize("signed", [True, False])
def test_edt_matches_jax(method, signed):
    occ = _grid((17, 16, 19), 1)
    jf = jesdf.esdf_from_occupancy(occ, ORIGIN, RES, dtype=jnp.float64,
                                   signed=signed, method=method)
    tf = tesdf.esdf_from_occupancy(occ, ORIGIN, RES, dtype=torch.float64,
                                   signed=signed, method=method,
                                   device="cpu")
    assert tf.method == method
    np.testing.assert_allclose(to_np(tf.distance), np.asarray(jf.distance),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(to_np(tf.origin), ORIGIN, rtol=0, atol=0)
    assert float(tf.resolution) == RES


def test_native_equals_minplus_to_float32():
    """Both transforms are exact: the C++ field (float32 arithmetic) equals
    the min-plus one to float32 rounding, and the all-free map is large
    and finite everywhere."""
    occ = _grid((20, 20, 20), 2)
    a = tesdf.esdf_from_occupancy(occ, ORIGIN, RES, method="xla",
                                  device="cpu")
    b = tesdf.esdf_from_occupancy(occ, ORIGIN, RES, method="native",
                                  device="cpu")
    assert a.distance.dtype == b.distance.dtype == torch.float32
    np.testing.assert_allclose(to_np(a.distance), to_np(b.distance),
                               rtol=0, atol=1e-5)
    free = np.zeros((6, 5, 4), bool)
    for method in ("xla", "native"):
        f = tesdf.esdf_from_occupancy(free, ORIGIN, RES, method=method,
                                      device="cpu")
        d = to_np(f.distance)
        assert np.all(np.isfinite(d)) and np.all(d > 1.0)


def test_edt_matches_bruteforce():
    occ = _grid((9, 10, 11), 3, density=0.1)
    f = tesdf.esdf_from_occupancy(occ, (0, 0, 0), RES, dtype=torch.float64,
                                  device="cpu")
    dist = to_np(f.distance)
    occ_idx, free_idx = np.argwhere(occ), np.argwhere(~occ)
    for idx in np.ndindex(occ.shape):
        ref = occ_idx if not occ[idx] else free_idx
        brute = np.min(np.linalg.norm(ref - np.array(idx), axis=1)) * RES
        assert dist[idx] == pytest.approx(-brute if occ[idx] else brute,
                                          abs=1e-12)


def test_auto_rule(monkeypatch):
    """"auto" takes the C++ transform for a 3-D grid above 64^3 voxels when
    it builds, the min-plus one otherwise (and when it does not build);
    "native" raises when it does not build."""
    small = np.zeros((8, 8, 8), bool)
    small[3, 3, 3] = True
    f = tesdf.esdf_from_occupancy(small, (0, 0, 0), 1.0, device="cpu")
    assert f.method == "xla"
    big = np.zeros((65, 64, 64), bool)
    big[10, 20, 30] = True
    f = tesdf.esdf_from_occupancy(big, (0, 0, 0), 1.0, device="cpu")
    assert f.method == "native"
    assert float(f.distance[10, 20, 30]) == pytest.approx(-1.0)
    assert float(f.distance[10, 20, 33]) == pytest.approx(3.0)

    def broken():
        raise OSError("no compiler")
    monkeypatch.setattr(tnative, "_edt_lib", None)
    monkeypatch.setattr(tnative, "load_edt", broken)
    f = tesdf.esdf_from_occupancy(big, (0, 0, 0), 1.0, device="cpu")
    assert f.method == "xla"
    with pytest.raises(OSError, match="no compiler"):
        tesdf.esdf_from_occupancy(small, (0, 0, 0), 1.0, method="native",
                                  device="cpu")
    with pytest.raises(ValueError, match="method"):
        tesdf.esdf_from_occupancy(small, (0, 0, 0), 1.0, method="scipy",
                                  device="cpu")


def test_distance_at_matches_jax(fields):
    occ, jf, tf = fields
    rng = np.random.RandomState(4)
    span = (np.array(occ.shape) - 1) * RES
    # inside the map and outside it (clamped to the border)
    pts = np.array(ORIGIN) + (rng.rand(2, 300, 3) * 1.4 - 0.2) * span
    ours = to_np(tesdf.distance_at(tf, tt(pts)))
    ref = np.asarray(jesdf.distance_at(jf, jnp.asarray(pts)))
    assert ours.shape == (2, 300)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)


def test_distance_at_gradient_matches_jax(fields):
    occ, jf, tf = fields
    rng = np.random.RandomState(5)
    pts = np.array(ORIGIN) + rng.rand(400, 3) * (np.array(occ.shape) - 1) \
        * RES
    w = rng.randn(400)
    ref = np.asarray(jax.grad(lambda p: jnp.sum(
        jnp.asarray(w) * jesdf.distance_at(jf, p) ** 2))(jnp.asarray(pts)))
    x = tt(pts).requires_grad_(True)
    (tt(w) * tesdf.distance_at(tf, x) ** 2).sum().backward()
    np.testing.assert_allclose(to_np(x.grad), ref, rtol=0, atol=1e-10)


def test_collision_potential_matches_jax():
    d = np.linspace(-1.0, 2.0, 3001)
    for eps, rr, mult in ((0.5, 0.3, 1.0), (0.3, 0.15, 20.0)):
        ours = to_np(tesdf.collision_potential(tt(d), eps, rr, mult))
        ref = np.asarray(jesdf.collision_potential(jnp.asarray(d), eps, rr,
                                                   mult))
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-14)
        np.testing.assert_array_equal(
            to_np(tesdf.is_in_collision(tt(d), rr)),
            np.asarray(jesdf.is_in_collision(jnp.asarray(d), rr)))


def test_make_obstacle_grid_equal():
    kw = dict(boxes=[((0.3, 0.3, 0.3), (0.5, 0.6, 0.5))],
              spheres=[((1.0, 0.2, 0.7), 0.35)])
    ours = tesdf.make_obstacle_grid((14, 12, 10), (0, 0, 0), 0.1, **kw)
    ref = jesdf.make_obstacle_grid((14, 12, 10), (0, 0, 0), 0.1, **kw)
    assert ours.dtype == bool and ours.any()
    np.testing.assert_array_equal(ours, ref)


def test_native_builds_into_the_package():
    """The C++ source is the port's own and builds into its git-ignored
    build directory under a name keyed by the source."""
    tnative.load_edt()
    path = tnative._edt_path()
    assert path.startswith(tnative.BUILD_DIR) and path.endswith(".so")
    assert tnative.EDT_SRC.endswith("csrc/edt.cpp")
    mask = np.zeros((3, 4, 5), bool)
    mask[1, 2, 3] = True
    sq = tnative.edt_squared_cpp(mask)
    assert sq[1, 2, 3] == 0.0 and sq[0, 0, 0] == 1 + 4 + 9
    with pytest.raises(ValueError, match="3-D"):
        tnative.edt_squared_cpp(np.zeros((3, 3), bool))


def test_esdf_from_numpy(fields):
    """A JAX package's field carried across: the same queries."""
    occ, jf, tf = fields
    back = convert.esdf_from_numpy(jf, device="cpu")
    assert back.method is None and back.distance.dtype == torch.float64
    np.testing.assert_array_equal(to_np(back.distance),
                                  np.asarray(jf.distance))
    pts = tt(np.array(ORIGIN) + np.random.RandomState(6).rand(50, 3))
    np.testing.assert_allclose(to_np(tesdf.distance_at(back, pts)),
                               to_np(tesdf.distance_at(tf, pts)), rtol=0,
                               atol=1e-12)
