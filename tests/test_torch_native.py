"""The port's native host helpers (`tlfea_torch.native`, built from its own
copy `tlfea_torch/csrc/native.cpp`) against the JAX package's
(`tlfea.native`) and the port's NumPy colouring, on a FEAT10 box and an
ANCF3243 beam: equal colours and incidence lists, and
`utils.coloring.colors_and_incidence` through the native path."""

import os

import numpy as np
import pytest

from tlfea import native as j_native
from tlfea.elements import ancf3243 as j_ancf3243
from tlfea.utils.tetmesh import box_t10_mesh
from tlfea_torch import native
from tlfea_torch.utils import coloring


def _ancf_conn(n_elem):
    """ANCF3243 coefficient connectivity (E, 8): both nodes' 4 rows each."""
    _, conn_nodes = j_ancf3243.straight_beam(n_elem)
    return (4 * conn_nodes[:, :, None] + np.arange(4)[None, None, :]).reshape(n_elem, 8)


MESHES = {
    "feat10_box": lambda: box_t10_mesh(1.0, 0.5, 0.5, 4, 2, 2)[1],
    "ancf3243_beam": lambda: _ancf_conn(17),
}


@pytest.fixture(scope="module")
def built():
    """The library, built from the port's source into tlfea_torch/_build/."""
    if not native.available():
        pytest.fail(f"the native helper did not build: {native.BUILD_ERROR}")
    path = native.library_path()
    assert os.path.isfile(path)
    assert os.path.basename(os.path.dirname(path)) == "_build"
    return path


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_native_matches_jax_and_numpy(built, mesh):
    conn = MESHES[mesh]()
    n = int(conn.max()) + 1
    colors = native.greedy_color(conn, n)
    inc, mask = native.build_incidence(conn, n)
    adj = coloring.build_adjacency(conn, n)
    np.testing.assert_array_equal(colors, coloring.greedy_coloring(adj))
    assert coloring.validate_coloring(adj, colors)
    inc_np, mask_np = coloring.build_incidence(conn, n)
    np.testing.assert_array_equal(mask, mask_np)
    np.testing.assert_array_equal(inc, inc_np)
    if j_native.available():
        np.testing.assert_array_equal(colors, j_native.greedy_color(conn, n))
        j_inc, j_mask = j_native.build_incidence(conn, n)
        np.testing.assert_array_equal(inc, j_inc)
        np.testing.assert_array_equal(mask, j_mask)
    assert colors.dtype == np.int64 and inc.dtype == np.int32 and mask.dtype == bool


def test_colors_and_incidence_takes_native(built, monkeypatch):
    """colors_and_incidence calls the native helper (and returns its
    arrays, equal to the NumPy path's)."""
    conn = MESHES["feat10_box"]()
    n = int(conn.max()) + 1
    calls = []
    for name in ("greedy_color", "build_incidence"):
        fn = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, fn=fn, name=name: calls.append(name)
                            or fn(*a))
    colors, inc, mask = coloring.colors_and_incidence(conn, n)
    assert calls == ["greedy_color", "build_incidence"]
    np.testing.assert_array_equal(colors, coloring.greedy_coloring(
        coloring.build_adjacency(conn, n)))
    inc_np, mask_np = coloring.build_incidence(conn, n)
    np.testing.assert_array_equal(inc, inc_np)
    np.testing.assert_array_equal(mask, mask_np)


def test_native_rejects_bad_connectivity(built):
    conn = MESHES["feat10_box"]().copy()
    n = int(conn.max()) + 1
    conn[0, 0] = n + 5
    with pytest.raises(ValueError):
        native.greedy_color(conn, n)
    with pytest.raises(ValueError):
        native.build_incidence(conn, n)


def test_numpy_fallback_without_library(monkeypatch):
    """Without the library (no compiler) colors_and_incidence takes the
    NumPy functions, as the JAX package does."""
    monkeypatch.setattr(native, "load", lambda: None)
    conn = MESHES["ancf3243_beam"]()
    n = int(conn.max()) + 1
    colors, inc, mask = coloring.colors_and_incidence(conn, n)
    np.testing.assert_array_equal(colors, coloring.greedy_coloring(
        coloring.build_adjacency(conn, n)))
    np.testing.assert_array_equal(inc, coloring.build_incidence(conn, n)[0])
