"""The port's mesh readers, writers, scene assembly, pressure fields and
CLI registry (`tlfea_torch.utils`) against the JAX package's: equal arrays,
and files equal byte for byte."""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.mesh_files import write_tetgen as _write_tetgen
from tests.test_scene_io import REF
from tlfea.elements import ancf3243 as j_ancf3243
from tlfea.elements import ancf3443 as j_ancf3443
from tlfea.utils import ancf_mesh as j_ancf_mesh
from tlfea.utils import cli as j_cli
from tlfea.utils import io_vtk as j_io
from tlfea.utils import mesh_manager as j_mm
from tlfea.utils import pressure as j_pressure
from tlfea.utils import tetmesh as j_tetmesh
from tlfea_torch.elements import ancf3243, ancf3443
from tlfea_torch.utils import ancf_mesh, cli, io_vtk, mesh_manager, pressure, tetmesh

torch.set_num_threads(2)


@pytest.mark.parametrize("base", [0, 1])
def test_read_tetgen(tmp_path, base):
    nodes, conn = tetmesh.box_t10_mesh(1.0, 0.5, 0.5, 2, 1, 1)
    node, ele = _write_tetgen(str(tmp_path / "box"), nodes, conn, base)
    got, want = tetmesh.read_tetgen(node, ele), j_tetmesh.read_tetgen(node, ele)
    for g, w, orig in zip(got, want, (nodes, conn)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, orig)


def test_surface_triangles_and_hairpin():
    nodes, conn = tetmesh.box_t10_mesh(1.0, 0.5, 0.5, 3, 2, 1)
    tris = tetmesh.surface_triangles_t10(conn)
    np.testing.assert_array_equal(tris, j_tetmesh.surface_triangles_t10(conn))
    assert len(tris) == 2 * 2 * (3 * 2 + 3 * 1 + 2 * 1)  # two triangles a boundary cell face
    for kw in ({}, dict(leg=0.3, gap=0.05, nx=12, ny=2, nz=2)):
        for g, w in zip(tetmesh.hairpin_t10_mesh(**kw), j_tetmesh.hairpin_t10_mesh(**kw)):
            np.testing.assert_array_equal(g, w)


def _patches(rng, n=6, max_verts=5):
    """Contact patches with the fields the writers read (any object with
    them will do)."""
    return SimpleNamespace(
        verts=rng.standard_normal((n, max_verts, 3)), n_verts=np.array([3, 4, 5, 3, 4, 5]),
        valid=np.array([True, True, False, True, True, True]),
        valid_orientation=np.array([True, False, True, True, True, True]),
        area=rng.random(n), p_eq=rng.random(n), g_A=rng.random(n), g_B=rng.random(n),
        centroid=rng.standard_normal((n, 3)), normal=rng.standard_normal((n, 3)),
        tetA=np.arange(n), tetB=np.arange(n) + 10)


def test_writers_byte_for_byte(tmp_path):
    """Every io_vtk writer's file equals the JAX package's on the same
    arrays (the T10 VTU from tensors in the port)."""
    rng = np.random.default_rng(0)
    nodes, conn = tetmesh.box_t10_mesh(1.0, 1.0, 1.0, 1, 1, 2)
    disp = 1e-3 * rng.standard_normal(nodes.shape)
    pd = {"p": rng.random(len(nodes)), "vel": rng.standard_normal(nodes.shape)}
    patches = _patches(rng)
    coefs, c2 = ancf3243.straight_beam(3)
    jcoefs, jc2 = j_ancf3243.straight_beam(3)
    scoefs, c4 = ancf3443.shell_grid(2, 2)
    jscoefs, jc4 = j_ancf3443.shell_grid(2, 2)
    tris = tetmesh.surface_triangles_t10(conn)
    rows = [(0.0, 1.0, 1.0 / 3.0), (0.1, 0.9, 2e-17)]
    cases = {
        "mesh.vtu": (lambda m, p: m.write_vtu_t10(p, nodes, conn, point_data=pd,
                                                  displacement=disp),
                     lambda p: io_vtk.write_vtu_t10(p, torch.as_tensor(nodes),
                                                    torch.as_tensor(conn), point_data=pd,
                                                    displacement=torch.as_tensor(disp))),
        "patches.vtp": (lambda m, p: m.write_vtp_patches(p, patches), None),
        "normals.vtp": (lambda m, p: m.write_vtp_normals(p, patches, scale=0.2), None),
        "beam.vtu": (lambda m, p: m.write_vtu_ancf_hex(
            p, coefs if m is io_vtk else jcoefs, c2 if m is io_vtk else jc2, 2.0 / 3.0, 0.1,
            0.05, "3243", point_data={"s": np.arange(24.0)}), None),
        "shell.vtu": (lambda m, p: m.write_vtu_ancf_hex(
            p, scoefs if m is io_vtk else jscoefs, c4 if m is io_vtk else jc4, 0.5, 0.5, 0.01,
            "3443"), None),
        "hist.csv": (lambda m, p: m.write_csv_history(p, ["t", "tip_z", "w"], rows), None),
        "patches.csv": (lambda m, p: m.write_patches_csv(p, patches), None),
        "patches.json": (lambda m, p: m.write_patches_json(p, patches), None),
        "surf.obj": (lambda m, p: m.write_obj_surface(p, nodes, tris), None),
    }
    for name, (write, write_tensors) in cases.items():
        want, got = tmp_path / f"jax_{name}", tmp_path / f"port_{name}"
        write(j_io, str(want))
        write(io_vtk, str(got))
        assert got.read_bytes() == want.read_bytes(), name
        if write_tensors is not None:
            write_tensors(str(got))
            assert got.read_bytes() == want.read_bytes(), name
    with pytest.raises(ValueError):
        io_vtk.write_vtu_ancf_hex(str(tmp_path / "x.vtu"), coefs, c2, 1.0, 0.1, 0.1, "3343")


def test_mesh_manager_scene_and_pressure(tmp_path):
    """A two-mesh scene (translated, rotated, a scalar field from NPZ, the
    TetGen reader) and the distance pressure field equal the JAX
    package's, array for array."""
    nodes, conn = tetmesh.box_t10_mesh(1.0, 1.0, 1.0, 2, 1, 1)
    node, ele = _write_tetgen(str(tmp_path / "box"), nodes, conn)
    field = np.arange(len(nodes), dtype=float)
    np.savez(tmp_path / "field.npz", p_vertex=field)
    np.savez(tmp_path / "corner.npz", p_vertex=field[:5])
    R = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    scenes = []
    for mod in (mesh_manager, j_mm):
        mm = mod.MeshManager()
        a = mm.add_mesh(nodes, conn, "a")
        b = mm.load_mesh(node, ele, "b")
        c = mm.add_mesh(nodes, conn)
        mm.translate_mesh(b, (2.0, 0.0, 0.0))
        mm.transform_mesh(a, R, t=(0.0, 0.0, 0.5))
        mm.load_scalar_field_from_npz(b, str(tmp_path / "field.npz"))
        mm.load_corner_pressures_from_npz(c, str(tmp_path / "corner.npz"))
        with pytest.raises(ValueError):
            mm.set_scalar_field(a, np.zeros(3))
        assert [i.name for i in mm.instances] == ["a", "b", "mesh2"]
        scenes.append((mm, mm.scene(), mm.scene(reorder=False)))
    (tm, ts, ts0), (jm, js, js0) = scenes
    np.testing.assert_array_equal(tm.nodes, jm.nodes)
    np.testing.assert_array_equal(tm.elements, jm.elements)
    np.testing.assert_array_equal(tm.scalar_field(), jm.scalar_field())
    np.testing.assert_array_equal(tm.surface_triangles(1), jm.surface_triangles(1))
    for t_sc, j_sc in ((ts, js), (ts0, js0)):
        for k in ("nodes", "conn", "pressures", "elem_mesh_ids", "node_mesh_ids", "perm", "inv"):
            np.testing.assert_array_equal(getattr(t_sc, k), getattr(j_sc, k), err_msg=k)
        assert t_sc.elem_ranges == j_sc.elem_ranges
        np.testing.assert_array_equal(t_sc.surface_triangles(0), j_sc.surface_triangles(0))
        np.testing.assert_array_equal(t_sc.mesh_node_ids(2), j_sc.mesh_node_ids(2))
        np.testing.assert_array_equal(t_sc.to_old(t_sc.nodes), j_sc.to_old(j_sc.nodes))

    got = pressure.distance_pressure_field(nodes, conn, modulus=3e5, chunk=7)
    np.testing.assert_array_equal(got, j_pressure.distance_pressure_field(nodes, conn, 3e5, 7))
    assert got.max() > 0 and got[tetmesh.surface_triangles_t10(conn).reshape(-1)].max() == 0
    rng = np.random.default_rng(2)
    p, tri = rng.standard_normal((9, 3)), rng.standard_normal((4, 3, 3))
    np.testing.assert_array_equal(pressure.point_triangle_distance(p, tri),
                                  j_pressure.point_triangle_distance(p, tri))


def test_cli_matches_jax(capsys):
    def build(mod):
        return (mod.Cli("demo").add("steps", 10, "steps").add("dt", 1e-3)
                .add("name", "x").add("vtk", False))

    argv = ["--steps=5", "--dt=2e-3", "--name=a=b", "--vtk=yes"]
    assert build(cli).parse(argv) == build(j_cli).parse(argv) == dict(
        steps=5, dt=2e-3, name="a=b", vtk=True)
    assert build(cli).parse([]) == build(j_cli).parse([])
    for bad in (["steps=5"], ["--nope=1"]):
        msgs = []
        for mod in (cli, j_cli):
            with pytest.raises(SystemExit) as err:
                build(mod).parse(bad)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    build(cli).print_help()
    port_help = capsys.readouterr().out
    build(j_cli).print_help()
    assert port_help == capsys.readouterr().out


_MESH_3243 = """ancf3243_mesh 1
# a two-segment beam welded to a third, pinned at its start
grid nx 2 ny 1 L 0.5 origin 0 0 0
nodes 4
0 free 0 1 0 0  0 0 1 0  0 0 0 1
1 free 0.5 1 0 0  0 0 1 0  0 0 0 1
2 free 1.0 1 0 0  0 0 1 0  0 0 0 1
3 free 1.5 1 0 0  0 0 1 0  0 0 0 1
elements 3
0 beam 0 1
1 beam 1 2
2 beam 2 3
constraints 2
pinned 2 3
welded 0 1 1 0 0 0 1 0 0 0 1
"""

_MESH_3443 = """ancf3443_mesh 1
nodes 4
0 s 0 1 0 0  0 0 1 0  0 0 0 1
1 s 1 1 0 0  0 0 1 0  0 0 0 1
2 s 1 1 0 0  1 0 1 0  0 0 0 1
3 s 0 1 0 0  1 0 1 0  0 0 0 1
elements 1
0 shell 1.0 1.0 0.01 0 1 2 3
"""


def _same_mesh(got, want):
    for k in ("coefs", "conn", "elem_L", "elem_W", "elem_H"):
        g, w = getattr(got, k), getattr(want, k)
        assert (g is None) == (w is None), k
        if g is not None:
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert (got.node_family, got.elem_family, got.grid, got.n_nodes) == (
        want.node_family, want.elem_family, want.grid, want.n_nodes)
    jc, tc = want.constraints(), got.constraints(device="cpu")
    assert (jc is None) == (tc is None)
    if jc is not None:
        for k in ("rows", "cols", "vals", "b"):
            np.testing.assert_array_equal(getattr(tc, k).numpy(), np.asarray(getattr(jc, k)))
        assert tc.n_rows == jc.n_rows
        np.testing.assert_allclose(tc.eval_c(torch.as_tensor(got.coefs)).numpy(),
                                   np.asarray(jc.eval_c(jnp.asarray(want.coefs))), atol=1e-15)


def test_ancf_mesh_readers(tmp_path):
    """Both readers on small files in the reference format (grid line,
    comments, pinned and welded rows; a shell without constraints) equal
    the JAX package's readers, rows included."""
    p1, p2 = tmp_path / "beam.ancf3243mesh", tmp_path / "tile.ancf3443mesh"
    p1.write_text(_MESH_3243)
    p2.write_text(_MESH_3443)
    beam = ancf_mesh.read_ancf3243_mesh(str(p1))
    _same_mesh(beam, j_ancf_mesh.read_ancf3243_mesh(str(p1)))
    assert beam.constraints(device="cpu").n_rows == 3 + 3 + 9
    np.testing.assert_allclose(beam.elem_L, [0.5, 0.5, 0.5])
    _same_mesh(ancf_mesh.read_ancf3443_mesh(str(p2)), j_ancf_mesh.read_ancf3443_mesh(str(p2)))
    with pytest.raises(ValueError, match="expected header"):
        ancf_mesh.read_ancf3443_mesh(str(p1))


def test_ancf_mesh_readers_reference_meshes():
    """The reference's sample meshes, where the reference data is present
    (as `tests/test_scene_io.py` reads them)."""
    p3243 = os.path.join(REF, "data/meshes/ANCF3243/net_pinned_nx20_ny20_L0.5.ancf3243mesh")
    p3443 = os.path.join(REF, "data/meshes/ANCF3443/airless_tire.ancf3443mesh")
    if not (os.path.exists(p3243) and os.path.exists(p3443)):
        pytest.skip("reference data not available")
    _same_mesh(ancf_mesh.read_ancf3243_mesh(p3243), j_ancf_mesh.read_ancf3243_mesh(p3243))
    _same_mesh(ancf_mesh.read_ancf3443_mesh(p3443), j_ancf_mesh.read_ancf3443_mesh(p3443))
