"""Host-side setup of the torch port (`tlfea_torch.utils`, `elements.feat10`)
against the JAX package: the port keeps its own NumPy copies (importing
`tlfea` pulls in jax), so every table, mesh, permutation and element array
must be exactly equal to the original's. (The ANCF tables are held in
`tests/test_torch_ancf.py`.)"""

import inspect

import numpy as np
import pytest
import torch

from tlfea.elements import feat10 as j_feat10
from tlfea.utils import quadrature as j_quad
from tlfea.utils import reorder as j_reorder
from tlfea.utils import tetmesh as j_tetmesh
from tlfea_torch.elements import feat10 as t_feat10
from tlfea_torch.utils import quadrature as t_quad
from tlfea_torch.utils import reorder as t_reorder
from tlfea_torch.utils import tetmesh as t_tetmesh

torch.set_num_threads(2)

BOXES = [(1.0, 0.2, 0.2, 3, 1, 1), (2.0, 0.35, 0.3, 6, 2, 2)]


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 4, 5])
def test_quadrature_tables_equal(n):
    for a, b in zip(t_quad.gauss_legendre_1d(n), j_quad.gauss_legendre_1d(n)):
        _equal(a, b)
    for a, b in zip(t_quad.tet_duffy_rule(n), j_quad.tet_duffy_rule(n)):
        _equal(a, b)
    for a, b in zip(t_quad.keast5_tet(), j_quad.keast5_tet()):
        _equal(a, b)


@pytest.mark.parametrize("rule", [(3, 2, 2), (4, 4, 3), (7, 7, 3)])
def test_tensor_product_rule_equal(rule):
    for a, b in zip(t_quad.tensor_product_rule(*rule), j_quad.tensor_product_rule(*rule)):
        _equal(a, b)


def test_builders_default_to_the_card():
    """Entry points run on the card unless the caller asks for the CPU."""
    from tlfea_torch import interop
    from tlfea_torch.elements import ancf3243, ancf3443

    for fn in (t_feat10.build, ancf3443.build, ancf3243.build, interop.from_numpy_system):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__qualname__


def test_builders_raise_without_a_card():
    """No silent fallback: without a card, the default device fails."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    nodes, conn = t_tetmesh.box_t10_mesh(1.0, 0.2, 0.2, 1, 1, 1)
    with pytest.raises((RuntimeError, AssertionError)):
        t_feat10.build(nodes, conn, rho=1000.0)


@pytest.mark.parametrize("box", BOXES)
def test_box_mesh_and_reorder_equal(box):
    nodes, conn = t_tetmesh.box_t10_mesh(*box)
    j_nodes, j_conn = j_tetmesh.box_t10_mesh(*box)
    _equal(nodes, j_nodes)
    _equal(conn, j_conn)
    n = len(nodes)
    for a, b in zip(t_reorder.node_adjacency(conn, n), j_reorder.node_adjacency(conn, n)):
        _equal(a, b)
    _equal(t_reorder.rcm_order(conn, n), j_reorder.rcm_order(conn, n))
    perm = t_reorder.best_order(nodes, conn)
    _equal(perm, j_reorder.best_order(nodes, conn))
    for a, b in zip(t_reorder.apply_node_order(nodes, conn, perm),
                    j_reorder.apply_node_order(nodes, conn, perm)):
        _equal(a, b)
    assert t_reorder.bandwidth(conn) == j_reorder.bandwidth(conn)


def test_t10_from_t4_equal():
    rng = np.random.default_rng(3)
    nodes4 = rng.normal(size=(6, 3))
    conn4 = np.array([[0, 1, 2, 3], [1, 2, 3, 4], [2, 3, 4, 5]])
    for a, b in zip(t_tetmesh.t10_from_t4(nodes4, conn4), j_tetmesh.t10_from_t4(nodes4, conn4)):
        _equal(a, b)


@pytest.mark.parametrize("box", BOXES)
def test_feat10_arrays_equal(box):
    nodes, conn = t_tetmesh.box_t10_mesh(*box)
    nodes, conn = t_reorder.apply_node_order(nodes, conn, t_reorder.best_order(nodes, conn))
    xi = np.random.default_rng(1).uniform(0.0, 0.3, size=(7, 3))
    _equal(t_feat10.shape_functions(xi), j_feat10.shape_functions(xi))
    _equal(t_feat10.shape_gradients_natural(xi), j_feat10.shape_gradients_natural(xi))
    for a, b in zip(t_feat10.precompute(nodes, conn), j_feat10.precompute(nodes, conn)):
        _equal(a, b)
    for rule in ("exact", "keast5"):
        _equal(t_feat10.element_mass(nodes, conn, 1000.0, rule=rule),
               j_feat10.element_mass(nodes, conn, 1000.0, rule=rule))
    for t_dtype, j_dtype in ((torch.float64, np.float64), (torch.float32, np.float32)):
        te = t_feat10.build(nodes, conn, rho=1000.0, dtype=t_dtype, device="cpu")
        je = j_feat10.build(nodes, conn, rho=1000.0, dtype=j_dtype)
        for name in ("grad_N", "dV", "mass_elem", "xe_ref", "x_ref"):
            _equal(getattr(te, name).numpy(), np.asarray(getattr(je, name)))
        _equal(te.conn.numpy(), np.asarray(je.conn).astype(np.int64))
        assert te.n_coef == je.n_coef and te.trans_mask == je.trans_mask


def test_feat10_rejects_inverted_elements():
    nodes, conn = t_tetmesh.box_t10_mesh(1.0, 0.2, 0.2, 2, 1, 1)
    with pytest.raises(ValueError, match="non-positive Jacobian"):
        t_feat10.build(nodes * np.array([1.0, 1.0, -1.0]), conn, rho=1.0, device="cpu")


def test_precision_pins_hold():
    """TF32 keeps ~3 digits: the port pins full float32 products on import."""
    import tlfea_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
