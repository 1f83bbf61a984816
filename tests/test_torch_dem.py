"""The torch port's DEM backends against the JAX package, on the CPU in
float64, within 1e-12: `NodeSphereDem` (two boxes inside each other's
sphere skin, damped, with friction and random velocities),
`node_sphere_radii`, the regions of `_closest_point_tri`, three
`GranularDem` steps over a plate, `dem_params_from_material`, and
`spread_point_forces` / `DemMeshCollision` with a stub engine."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlfea.collision import dem as j_dem
from tlfea.collision.dem_bridge import DemMeshCollision as JBridge
from tlfea.collision.dem_bridge import spread_point_forces as j_spread
from tlfea.utils.mesh_manager import MeshManager as JMeshManager
from tlfea.utils.tetmesh import box_t10_mesh, surface_triangles_t10
from tlfea_torch.collision import dem
from tlfea_torch.collision.dem_bridge import DemMeshCollision, spread_point_forces
from tlfea_torch.interop import from_numpy_collision
from tlfea_torch.utils.mesh_manager import MeshManager

torch.set_num_threads(2)


def _close(got, want, tol=1e-12, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} of {scale:.3e}"


def _two_box_scene(gap, cls):
    """`tests/test_dem.py:21-31`: two boxes stacked in z, `gap` apart."""
    mm = cls()
    n1, c1 = box_t10_mesh(0.4, 0.4, 0.2, 2, 2, 1)
    mm.add_mesh(n1, c1, "a")
    mm.add_mesh(n1, c1, "b")
    mm.translate_mesh(1, (0.0, 0.0, 0.2 + gap))
    return mm, [mm.surface_triangles(mid) for mid in range(2)]


def test_node_sphere_radii_equal():
    nodes, conn = box_t10_mesh(0.4, 0.4, 0.2, 2, 2, 1)
    tris = surface_triangles_t10(conn)
    np.testing.assert_array_equal(dem.node_sphere_radii(nodes, tris, 0.7),
                                  j_dem.node_sphere_radii(nodes, tris, 0.7))


@pytest.mark.parametrize("params", [dict(kn=1e5, cn=0.0, mu=0.0),
                                    dict(kn=1e5, cn=30.0, mu=0.4, v_reg=1e-2)])
def test_node_sphere_dem_matches_jax(params):
    """Surfaces 0.04 apart, inside the sphere skin: forces within 1e-12,
    the same contact count, the third law, and the sign."""
    mm, tris = _two_box_scene(0.04, JMeshManager)
    x = mm.nodes
    v = 0.1 * np.random.default_rng(2).standard_normal(x.shape)
    jp = j_dem.DemParams(**params)
    tp = from_numpy_collision(jp, device="cpu")
    assert tp == dem.DemParams(**params)
    jf, jinfo, _ = j_dem.NodeSphereDem(x, tris).step(x, v, jp)
    td = dem.NodeSphereDem(x, tris, device="cpu")
    tf, tinfo, tovf = td.step(torch.as_tensor(x), torch.as_tensor(v), tp)
    _close(tf, jf, what="f")
    assert int(tinfo.n_contacts) == int(jinfo.n_contacts) > 0 and not bool(tovf)
    assert float(tf.sum(0).abs().max()) <= 1e-10 * float(tf.abs().max())
    ids_b = np.unique(np.asarray(tris[1]).reshape(-1))
    assert float(tf[ids_b, 2].sum()) > 0


def test_closest_point_tri_regions():
    """`tests/test_dem.py:72-91`'s seven regions, batched, against JAX."""
    a, b, c = np.zeros(3), np.array([1.0, 0, 0]), np.array([0, 1.0, 0])
    p = np.array([[0.25, 0.25, 1.0], [-1.0, -1.0, 0.5], [2.0, -1.0, 0.0], [-0.5, 2.0, 0.0],
                  [0.5, -1.0, 0.0], [-1.0, 0.5, 0.0], [1.0, 1.0, 0.0]])
    expect = np.array([[0.25, 0.25, 0], [0, 0, 0], [1, 0, 0], [0, 1, 0], [0.5, 0, 0],
                       [0, 0.5, 0], [0.5, 0.5, 0]])
    jpt, jbary = j_dem._closest_point_tri(jnp.asarray(p), jnp.asarray(a), jnp.asarray(b),
                                          jnp.asarray(c))
    tpt, tbary = dem._closest_point_tri(*(torch.as_tensor(q) for q in (p, a, b, c)))
    _close(tpt, jpt, what="point")
    _close(tbary, jbary, what="barycentric")
    np.testing.assert_allclose(tpt.numpy(), expect, atol=1e-12)


def test_granular_dem_three_steps_match_jax():
    """A 4 x 4 cloud touching a plate, three steps of 16 substeps against
    moving mesh nodes: the cloud and the mesh forces within 1e-12, and the
    impulse balance."""
    nodes, conn = box_t10_mesh(0.5, 0.5, 0.1, 2, 2, 1)
    tris = surface_triangles_t10(conn)
    rng = np.random.default_rng(9)
    jc = j_dem.SphereCloud.grid(center=(0.25, 0.25, 0.12), extent=(0.2, 0.2, 0.0),
                                spacing=0.05, radius=0.028)
    tc = dem.SphereCloud.grid(center=(0.25, 0.25, 0.12), extent=(0.2, 0.2, 0.0),
                              spacing=0.05, radius=0.028, device="cpu")
    for k in ("x", "v", "r", "m"):
        np.testing.assert_array_equal(getattr(tc, k).numpy(), np.asarray(getattr(jc, k)))
    moved = from_numpy_collision(jc, device="cpu")
    assert all(torch.equal(getattr(moved, k), getattr(tc, k)) for k in ("x", "v", "r", "m"))
    jd, td = j_dem.GranularDem(tris, n_sub=16), dem.GranularDem(tris, n_sub=16, device="cpu")
    jd.bind_cloud(jc)
    td.bind_cloud(tc)
    jp = j_dem.DemParams(kn=1e5, cn=10.0, mu=0.3)
    tp = from_numpy_collision(jp, device="cpu")
    for step in range(3):
        x = nodes + 1e-3 * rng.standard_normal(nodes.shape)
        v = 0.05 * rng.standard_normal(nodes.shape)
        p0 = (td.cloud.m[:, None] * td.cloud.v).sum(0)
        jf, jinfo, _ = jd.step(x, v, jp, dt=1e-3)
        tf, tinfo, tovf = td.step(torch.as_tensor(x), torch.as_tensor(v), tp, dt=1e-3)
        _close(tf, jf, what=f"mesh force, step {step}")
        for k in ("x", "v"):
            _close(getattr(tinfo["cloud"], k), getattr(jinfo["cloud"], k),
                   what=f"cloud {k}, step {step}")
        p1 = (td.cloud.m[:, None] * td.cloud.v).sum(0)
        grav = torch.tensor([0.0, 0.0, -9.81 * float(td.cloud.m.sum()) * 1e-3],
                            dtype=torch.float64)
        _close(p1 - p0 - grav, -tf.sum(0) * 1e-3, 1e-6, "impulse")
        assert not bool(tovf)
    assert float(tf[:, 2].sum()) < 0


def test_dem_params_from_material():
    for cor in (0.0, 0.5, 1.0):
        want = j_dem.dem_params_from_material(1e7, 0.3, cor, 0.01, 0.02, mu=0.25)
        got = dem.dem_params_from_material(1e7, 0.3, cor, 0.01, 0.02, mu=0.25)
        for k in ("kn", "cn", "mu", "v_reg"):
            assert getattr(got, k) == float(np.asarray(getattr(want, k))), (cor, k)
    with pytest.raises(ValueError):
        dem.dem_params_from_material(1e7, 0.3, 1.5, 0.01, 0.02)


class _StubEngine:
    """A scripted engine: two contacts, one on each mesh."""

    def do_dynamics(self, meshes, x_np, v_np):
        pts = np.array([x_np[0] + 1e-3, x_np[-1] - 1e-3, x_np[5]])
        return pts, np.array([[0.0, 0.0, 1.0], [0.5, 0.0, 2.0], [0.0, -1.0, 0.0]]), \
            np.array([0, 1, 1])


def test_spread_and_bridge_match_jax():
    rng = np.random.default_rng(4)
    pts, frc, surf = rng.random((7, 3)), rng.standard_normal((7, 3)), rng.random((20, 3))
    np.testing.assert_array_equal(spread_point_forces(pts, frc, surf, k=3),
                                  j_spread(pts, frc, surf, k=3))
    jm, _ = _two_box_scene(0.5, JMeshManager)
    tm, _ = _two_box_scene(0.5, MeshManager)
    x = jm.nodes
    jf, _, _ = JBridge(jm, backend=_StubEngine()).step(x)
    tf, patches, ovf = DemMeshCollision(tm, backend=_StubEngine()).step(torch.as_tensor(x))
    assert isinstance(tf, torch.Tensor) and tf.device.type == "cpu" and patches is None
    _close(tf, jf, what="bridge")
    np.testing.assert_allclose(tf.sum(0).numpy(), [0.5, -1.0, 3.0], atol=1e-12)
    with pytest.raises(RuntimeError):
        DemMeshCollision(tm)

    class TwoArgs:
        def do_dynamics(self, meshes, x_np):
            return _StubEngine().do_dynamics(meshes, x_np, None)

    with pytest.raises(TypeError):
        DemMeshCollision(tm, backend=TwoArgs()).step(x)
