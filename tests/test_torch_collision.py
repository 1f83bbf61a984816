"""The torch port's hydroelastic collision pipeline against the JAX
package, on the CPU in float64: the setup tables and every broadphase
mode's (pairs, valid, overflow) exactly, the compaction, the narrowphase
of one batch of random tet pairs (masks and counts equal, fields within
1e-12), patches and forces with damping and friction (1e-12 of max |f|),
the collision step and the capacities `grow()` doubles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tlfea.collision import broadphase as j_bp
from tlfea.collision import gridhash as j_grid
from tlfea.collision.forces import patch_forces as j_patch_forces
from tlfea.collision.hydroelastic import HydroelasticCollision as JCollision
from tlfea.collision.hydroelastic import HydroelasticParams as JParams
from tlfea.collision.narrowphase import _patch_one as j_patch_one
from tlfea.collision.narrowphase import compute_patches as j_compute_patches
from tlfea.utils.pressure import distance_pressure_field
from tlfea.utils.tetmesh import box_t10_mesh, hairpin_t10_mesh
from tlfea_torch.collision import broadphase, gridhash
from tlfea_torch.collision.forces import patch_forces
from tlfea_torch.collision.hydroelastic import HydroelasticCollision, HydroelasticParams
from tlfea_torch.collision.narrowphase import _patch_one, compute_patches
from tlfea_torch.interop import from_numpy_collision

torch.set_num_threads(2)

FIELDS = ("verts", "normal", "centroid", "area", "g_A", "g_B", "p_eq")
MASKS = ("n_verts", "valid", "valid_orientation")


def two_box_scene(gap=-0.2):
    """`tests/test_collision.py`'s two unit boxes, overlapping by |gap| in x."""
    na, ca = box_t10_mesh(1.0, 1.0, 1.0, 2, 2, 2)
    nb = na + np.array([1.0 + gap, 0.0, 0.0])
    nodes = np.vstack([na, nb])
    conn = np.vstack([ca, ca + na.shape[0]])
    mesh_ids = np.repeat(np.arange(2, dtype=np.int32), ca.shape[0])
    pressures = np.concatenate([distance_pressure_field(na, ca, modulus=1e5),
                                distance_pressure_field(nb, ca, modulus=1e5)])
    return nodes, conn, mesh_ids, pressures


@pytest.fixture(scope="module")
def boxes():
    return two_box_scene()


@pytest.fixture(scope="module")
def hairpin():
    nodes, conn = hairpin_t10_mesh(leg=0.4, gap=0.06, nx=8, ny=2, nz=2)
    return nodes, conn, np.zeros(conn.shape[0], np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _equal(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)


def test_setup_tables_equal(boxes, hairpin):
    """corners, all nodes, mesh ids, neighbour keys (values), the dense
    cross list, BlockCross at block=8 and GridSetup equal the JAX tables."""
    nodes, conn, mesh_ids, _ = boxes
    for c, m in ((conn, mesh_ids), hairpin[1:]):
        jb = j_bp.setup_broadphase(c, m, window=16, margin=0.01)
        tb = broadphase.setup_broadphase(c, m, window=16, margin=0.01, device="cpu")
        for k in ("corners", "all_nodes", "mesh_ids"):
            _equal(getattr(tb, k), getattr(jb, k), k)
        keys = np.asarray(jb.neighbor_hashes)
        assert keys.size > 1 and keys.max() < 2**63
        _equal(tb.neighbor_hashes, keys.astype(np.int64), "neighbor keys")
        assert (tb.window, tb.margin) == (jb.window, jb.margin)
    _equal(broadphase.setup_dense_cross(conn, mesh_ids, device="cpu"),
           j_bp.setup_dense_cross(conn, mesh_ids), "dense cross")
    assert broadphase.setup_dense_cross(hairpin[1], hairpin[2], device="cpu") is None
    jk = j_bp.setup_block_cross(conn, mesh_ids, nodes, block=8, block_pair_cap=16)
    tk = broadphase.setup_block_cross(conn, mesh_ids, nodes, block=8, block_pair_cap=16,
                                      device="cpu")
    for k in ("order_pad", "pad_mask", "block_pairs"):
        _equal(getattr(tk, k), getattr(jk, k), k)
    assert (tk.block, tk.n_blocks, tk.block_pair_cap) == (jk.block, jk.n_blocks,
                                                          jk.block_pair_cap)
    hn, hc, _ = hairpin
    jg = j_grid.setup_grid(hn, hc, margin=0.02)
    tg = gridhash.setup_grid(hn, hc, margin=0.02, device="cpu")
    _equal(tg.origin, jg.origin, "origin")
    _equal(tg.inv_h, jg.inv_h, "inv_h")
    assert (tg.dims, tg.cell_cap) == (jg.dims, jg.cell_cap)


def _modes(boxes, hairpin):
    nodes, conn, mesh_ids, _ = boxes
    hn, hc, hm = hairpin
    x = nodes + 0.01 * np.random.default_rng(3).standard_normal(nodes.shape)
    xh = hn + 0.002 * np.random.default_rng(4).standard_normal(hn.shape)
    for name in ("dense", "sap", "block", "grid", "sap_self"):
        if name in ("grid", "sap_self"):
            c, m, xx, margin, self_col = hc, hm, xh, 0.02, True
        else:
            c, m, xx, margin, self_col = conn, mesh_ids, x, 0.0, False
        jb = j_bp.setup_broadphase(c, m, window=24, margin=margin)
        tb = broadphase.setup_broadphase(c, m, window=24, margin=margin, device="cpu")
        jx, tx = jnp.asarray(xx), torch.as_tensor(xx)
        if name == "dense":
            want = jax.jit(j_bp.find_pairs_dense)(jb, jx, j_bp.setup_dense_cross(c, m))
            got = broadphase.find_pairs_dense(
                tb, tx, broadphase.setup_dense_cross(c, m, device="cpu"))
        elif name == "block":
            want = jax.jit(j_bp.find_pairs_block)(jb, j_bp.setup_block_cross(
                c, m, nodes, block=8, block_pair_cap=12), jx)
            got = broadphase.find_pairs_block(tb, broadphase.setup_block_cross(
                c, m, nodes, block=8, block_pair_cap=12, device="cpu"), tx)
        elif name == "grid":
            want = jax.jit(j_grid.find_pairs_grid)(
                jb, j_grid.setup_grid(hn, hc, margin=margin), jx)
            got = gridhash.find_pairs_grid(
                tb, gridhash.setup_grid(hn, hc, margin=margin, device="cpu"), tx)
        else:
            want = jax.jit(j_bp.find_pairs, static_argnums=2)(jb, jx, self_col)
            got = broadphase.find_pairs(tb, tx, self_col)
        yield name, got, want


def test_broadphase_modes_equal(boxes, hairpin):
    """(pairs, valid, overflow) of dense, SAP and block on the two boxes and
    of grid and self-collision SAP on the hairpin, exactly as in JAX."""
    seen = {}
    for name, got, want in _modes(boxes, hairpin):
        for k, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{name} output {k}")
        assert got[0].dtype == torch.int32
        seen[name] = (int(got[1].sum()), bool(got[2]))
    assert all(n > 0 for n, _ in seen.values()), seen
    assert seen["block"][1], "block_pair_cap 12 is meant to overflow here"


@pytest.mark.parametrize("capacity", [5, 40, 200])
def test_compact_pairs(capacity):
    rng = np.random.default_rng(capacity)
    pairs = rng.integers(0, 1000, (120, 2)).astype(np.int32)
    valid = rng.random(120) < 0.3
    want = j_bp.compact_pairs(jnp.asarray(pairs), jnp.asarray(valid), capacity)
    got = broadphase.compact_pairs(_t(pairs), _t(valid), capacity)
    for k, (g, w) in enumerate(zip(got, want)):
        _equal(g, w, f"output {k}")
    assert bool(got[2]) == (valid.sum() > capacity)


def _random_tet_pairs(n=60, seed=7):
    """`tests/test_narrowphase_oracle.py`'s generator."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        base = rng.standard_normal(3) * 0.1
        vA = base + rng.standard_normal((4, 3))
        vB = vA * rng.uniform(0.6, 1.1) + rng.standard_normal(3) * 0.3
        out.append((vA, rng.uniform(0.1, 2.0, 4), vB, rng.uniform(0.1, 2.0, 4)))
    return [np.stack(a) for a in zip(*out)]


def _close(got, want, tol, what):
    got = got.numpy()
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} of {scale:.3e}"


def test_patch_one_batched_matches_jax():
    """The 60 random tet pairs (rng 7) in one batch against JAX's vmap."""
    vA, pA, vB, pB = _random_tet_pairs()
    want = jax.jit(jax.vmap(j_patch_one))(*(jnp.asarray(a) for a in (vA, pA, vB, pB)))
    got = _patch_one(*(_t(a) for a in (vA, pA, vB, pB)))
    for k in MASKS:
        _equal(got[k], want[k], k)
    for k in FIELDS:
        _close(got[k], want[k], 1e-12, k)
    assert int(got["valid"].sum()) >= 10


@pytest.mark.parametrize("damping,friction", [(0.0, 0.0), (0.5, 0.3)])
def test_patches_and_forces_match_jax(boxes, damping, friction):
    nodes, conn, mesh_ids, pressures = boxes
    rng = np.random.default_rng(11)
    x = nodes + 0.01 * rng.standard_normal(nodes.shape)
    v = rng.standard_normal(nodes.shape)
    jb = j_bp.setup_broadphase(conn, mesh_ids)
    tb = broadphase.setup_broadphase(conn, mesh_ids, device="cpu")
    jp, jv, _ = j_bp.compact_pairs(*j_bp.find_pairs_dense(
        jb, jnp.asarray(x), j_bp.setup_dense_cross(conn, mesh_ids))[:2], 1024)
    tp, tv, _ = broadphase.compact_pairs(*broadphase.find_pairs_dense(
        tb, _t(x), broadphase.setup_dense_cross(conn, mesh_ids, device="cpu"))[:2], 1024)
    want = jax.jit(j_compute_patches)(jnp.asarray(x), jnp.asarray(pressures), jb.corners,
                                      jp, jv, jb.mesh_ids)
    got = compute_patches(_t(x), _t(pressures), tb.corners, tp, tv, tb.mesh_ids)
    for k in MASKS + ("tetA", "tetB"):
        _equal(getattr(got, k), getattr(want, k), k)
    for k in FIELDS:
        _close(getattr(got, k), getattr(want, k), 1e-12, k)
    assert int(got.n_contacts) == int(want.n_contacts) > 0
    fw = jax.jit(j_patch_forces)(want, jnp.asarray(x), jnp.asarray(v), jb.corners, damping,
                                 friction)
    fg = patch_forces(got, _t(x), _t(v), tb.corners, damping, friction)
    scale = float(np.abs(np.asarray(fw)).max())
    assert scale > 0 and float(np.abs(fg.numpy() - np.asarray(fw)).max()) <= 1e-12 * scale


def test_collision_step_and_grow(boxes):
    """HydroelasticCollision.step (dense under auto) with friction and
    damping: forces within 1e-12 of max |f|, the same patch masks and
    overflow; the modes auto picks; grow() doubles the capacities."""
    nodes, conn, mesh_ids, pressures = boxes
    v = np.random.default_rng(5).standard_normal(nodes.shape)
    jc = JCollision(conn, mesh_ids, pressures, window=64)
    tc = HydroelasticCollision(conn, mesh_ids, pressures, window=64, device="cpu")
    jparams = JParams(damping=0.5, friction=0.3)
    tparams = from_numpy_collision(jparams, device="cpu")
    assert tparams == HydroelasticParams(damping=0.5, friction=0.3)
    jf, jpatch, jo = jc.step(jnp.asarray(nodes), jnp.asarray(v), jparams)
    tf, tpatch, to = tc.step(_t(nodes), _t(v), tparams)
    assert tc.mode == "dense" and bool(to) == bool(jo) is False
    for k in MASKS:
        _equal(getattr(tpatch, k), getattr(jpatch, k), k)
    scale = float(np.abs(np.asarray(jf)).max())
    assert scale > 0 and float(np.abs(tf.numpy() - np.asarray(jf)).max()) <= 1e-12 * scale
    assert float(tf.sum(0).abs().max()) <= 1e-10 * scale  # third law

    blk = HydroelasticCollision(conn, mesh_ids, pressures, dense_cross_cap=100,
                                rest_nodes=nodes, block_pair_cap=8, device="cpu")
    grid = HydroelasticCollision(conn, mesh_ids, pressures, enable_self_collision=True,
                                 rest_nodes=nodes, device="cpu")
    sap = HydroelasticCollision(conn, mesh_ids, pressures, dense_cross_cap=100, device="cpu")
    assert (blk.mode, grid.mode, sap.mode) == ("block", "grid", "sap")
    for c, jargs in ((blk, dict(dense_cross_cap=100, rest_nodes=nodes, block_pair_cap=8)),
                     (grid, dict(enable_self_collision=True, rest_nodes=nodes)), (sap, {})):
        g, jg = c.grow(), JCollision(conn, mesh_ids, pressures, **jargs).grow()
        assert (g.bp.window, g.max_pairs) == (2 * c.bp.window, 2 * c.max_pairs) == (
            jg._init_args["window"], jg._init_args["max_pairs"])
        if c.blk is not None:
            assert g.blk.block_pair_cap == jg.blk.block_pair_cap == 16
        if c.grid is not None:
            assert g.grid.cell_cap == jg.grid.cell_cap == 2 * c.grid.cell_cap
        assert g.bp.neighbor_hashes.device.type == "cpu"


def test_entry_points_default_to_the_card(boxes):
    """Every setup and backend puts its tensors on the card unless given
    device="cpu"; on a machine without one the defaults raise."""
    from tlfea_torch.collision import dem

    nodes, conn, mesh_ids, pressures = boxes
    tris = [conn[:1, :3], conn[-1:, :3]]
    constructors = [
        lambda: broadphase.setup_broadphase(conn, mesh_ids),
        lambda: broadphase.setup_dense_cross(conn, mesh_ids),
        lambda: broadphase.setup_block_cross(conn, mesh_ids, nodes),
        lambda: gridhash.setup_grid(nodes, conn),
        lambda: HydroelasticCollision(conn, mesh_ids, pressures),
        lambda: dem.NodeSphereDem(nodes, tris),
        lambda: dem.GranularDem(tris[0]),
        lambda: dem.SphereCloud.grid((0, 0, 0), (0.1, 0.1, 0.0), 0.05, 0.01),
    ]
    for build in constructors:
        if torch.cuda.is_available():
            assert build() is not None
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                build()
