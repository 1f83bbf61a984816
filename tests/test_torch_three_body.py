"""A three-body contact scene against the JAX package, in float64 on the
CPU: three boxes (`MeshManager.scene`, band-minimised), each pair of them
overlapping, through `HydroelasticCollision` with each broadphase in both
packages. Equal force-carrying masks and overflow flags, their patches'
pairs equal and fields within 1e-12, the forces within 1e-12 of max |f|;
every force-carrying patch joins two different bodies (the mesh-id filter),
and each of the three pairs of bodies has some.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.example_parity import force_carrying, same_contacts
from tlfea.collision.hydroelastic import HydroelasticCollision as JCollision
from tlfea.collision.hydroelastic import HydroelasticParams as JParams
from tlfea.utils.mesh_manager import MeshManager as JMeshManager
from tlfea.utils.pressure import distance_pressure_field as j_pressure_field
from tlfea_torch.collision.hydroelastic import HydroelasticCollision, HydroelasticParams
from tlfea_torch.utils.mesh_manager import MeshManager
from tlfea_torch.utils.pressure import distance_pressure_field
from tlfea_torch.utils.tetmesh import box_t10_mesh

torch.set_num_threads(2)

# Box offsets: the second on the first's top, the third against both sides.
BODIES = ((0.0, 0.0, 0.0), (0.02, 0.02, 0.11), (0.2, 0.05, 0.08))
FIELDS = ("area", "p_eq", "g_A", "g_B", "centroid", "normal")


def _three_boxes(mm_cls, pressure_fn):
    mm = mm_cls()
    nodes, conn = box_t10_mesh(0.3, 0.3, 0.12, 2, 2, 2)
    for k, offset in enumerate(BODIES):
        mid = mm.add_mesh(nodes, conn, f"box{k}")
        mm.translate_mesh(mid, offset)
        inst = mm.instances[mid]
        local = mm.elements[inst.elem_offset: inst.elem_offset + inst.n_elems] - inst.node_offset
        mm.set_scalar_field(mid, pressure_fn(mm.mesh_nodes(mid), local, 5e5))
    return mm.scene(reorder=True)


@pytest.fixture(scope="module")
def three_bodies():
    """The scene in both packages (equal arrays), and a perturbed state."""
    js, ts = _three_boxes(JMeshManager, j_pressure_field), _three_boxes(MeshManager,
                                                                         distance_pressure_field)
    for key in ("nodes", "conn", "elem_mesh_ids", "pressures"):
        np.testing.assert_array_equal(getattr(ts, key), getattr(js, key), err_msg=key)
    rng = np.random.default_rng(5)
    x = ts.nodes + 2e-3 * rng.standard_normal(ts.nodes.shape)
    v = 0.1 * rng.standard_normal(ts.nodes.shape)
    return ts, x, v


@pytest.mark.parametrize("mode", ["dense", "block", "sap", "grid"])
def test_three_body_contact_matches_jax(three_bodies, mode):
    scene, x, v = three_bodies
    kw = dict(window=256, max_pairs=4096, broadphase=mode, rest_nodes=scene.nodes, block=16)
    jcol = JCollision(scene.conn, scene.elem_mesh_ids, scene.pressures, **kw)
    tcol = HydroelasticCollision(scene.conn, scene.elem_mesh_ids, scene.pressures,
                                 device="cpu", **kw)
    assert tcol.mode == jcol.mode == mode
    jf, jp, jo = jcol.step(jnp.asarray(x), jnp.asarray(v), JParams(damping=0.5, friction=0.3))
    tf, tp, to = tcol.step(torch.as_tensor(x), torch.as_tensor(v),
                           HydroelasticParams(damping=0.5, friction=0.3))
    assert bool(to) == bool(jo) is False
    n = same_contacts(tp, jp, mode)
    floor = 1e-12 * float(np.abs(np.asarray(jp.area)).max())
    live = force_carrying(jp, floor)
    for key in ("tetA", "tetB"):
        np.testing.assert_array_equal(getattr(tp, key).numpy()[live],
                                      np.asarray(getattr(jp, key))[live], err_msg=key)
    for key in FIELDS:
        want = np.asarray(getattr(jp, key))[live]
        got = getattr(tp, key).numpy()[live]
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max(), key
    scale = float(np.abs(np.asarray(jf)).max())
    assert scale > 0 and float(np.abs(tf.numpy() - np.asarray(jf)).max()) <= 1e-12 * scale
    ids = scene.elem_mesh_ids
    a, b = ids[tp.tetA.numpy()[live]], ids[tp.tetB.numpy()[live]]
    assert (a != b).all()  # the mesh-id filter: no patch within a body
    assert {tuple(sorted(p)) for p in zip(a.tolist(), b.tolist())} == {(0, 1), (0, 2), (1, 2)}
    assert n == int(live.sum()) > 0
