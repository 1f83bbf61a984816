"""The ported mesh-bound example scripts (`tlfea_torch.examples`:
`feat10_resolution_study`, `ancf3243_net`, `ancf3443_tire`) against the JAX
scripts of `examples/`, in float64 on the CPU, on meshes the tests write
(`tests/mesh_files.py`; the reference's meshes are not in the repository).

- The resolution study reads TetGen beams under a temporary reference
  folder (both packages' REF_DATA pointed at it): res 0 written, res 1
  absent, so both scripts run the one and skip the other.
- The net: a 3 x 3 pinned-joint net (L 0.5) through --mesh, its joint rows
  plus the corners' fix_dof rows, and `center_z.csv`.
- The tire: a 6 x 2 shell patch with a welded seam, centred so that the
  nodes within --rim_radius (0.16) are fixed on every slot, run at
  --rho_alm=1e6: at the script's 1e8 the weld's penalty rows keep every
  step at the Newton cap (6) with ~200 CG iterations, unconverged, and the
  rounding of either package's sums then grows ~1000x a step in both alike
  (7e-11, 1e-7, 6e-5 of the displacement over steps 1-3, with equal counts);
  at 1e6 each step converges in 3-4 Newton iterations.

Each runs 3 steps in both packages: equal Newton / CG counts per step, every
step's positions and the CSV / VTU outputs within 1e-9 of the displacement
scale (`tests/example_parity.py`), and the constraint rows equal.
"""

import numpy as np
import pytest
import torch

from tests.example_parity import assert_same_run, run_pair
from tests.mesh_files import write_ancf3243_net, write_ancf3443_patch, write_resolution_beams
from tlfea_torch.examples import feat10_resolution_study

torch.set_num_threads(2)

NET = (3, 3, 0.5)  # nx, ny, L
PATCH = dict(nu=6, nv=2, h=0.1, thickness=0.01, seams=(5,))


def _rows(cons):
    return {k: np.asarray(getattr(cons, k).numpy() if hasattr(getattr(cons, k), "numpy")
                          else getattr(cons, k)) for k in ("rows", "cols", "vals", "b")}


@pytest.fixture(scope="module")
def resolution(tmp_path_factory):
    ref = tmp_path_factory.mktemp("ref")
    written = write_resolution_beams(str(ref), [0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(feat10_resolution_study, "REF_DATA", str(ref))
        runs = run_pair("feat10_resolution_study", ["--res=0,1", "--steps=3"],
                        tmp_path_factory.mktemp("resolution"), mp,
                        before_jax=lambda jmod: mp.setattr(jmod, "REF_DATA", str(ref)))
    return written, runs


@pytest.fixture(scope="module")
def net(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("net") / "net.ancf3243mesh")
    counts = write_ancf3243_net(path, *NET)
    with pytest.MonkeyPatch.context() as mp:
        runs = run_pair("ancf3243_net", [f"--mesh={path}", "--steps=3", "--vtk_every=1"],
                        tmp_path_factory.mktemp("net_run"), mp)
    return counts, runs


@pytest.fixture(scope="module")
def tire(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tire") / "patch.ancf3443mesh")
    counts = write_ancf3443_patch(path, **PATCH)
    with pytest.MonkeyPatch.context() as mp:
        runs = run_pair("ancf3443_tire", [f"--mesh={path}", "--steps=3", "--vtk_every=1",
                                          "--rho_alm=1e6"],
                        tmp_path_factory.mktemp("tire_run"), mp)
    return counts, runs


@pytest.mark.parametrize("scene", ["resolution", "net", "tire"])
def test_script_matches_jax(scene, request):
    _, runs = request.getfixturevalue(scene)
    assert_same_run(runs)


def test_resolution_skips_an_absent_mesh(resolution):
    """res 0 runs (its 36 elements, one CSV), res 1 has no mesh and is
    skipped in both packages (no CSV, no Simulation)."""
    written, runs = resolution
    assert written == {0: 36}
    for side in ("jax", "port"):
        assert list(runs[side]["files"]) == ["feat10_resolution/track_res0.csv"], side
        assert len(runs[side]["sims"]) == 1 and len(runs[side]["counts"]) == 3
    sim, hists = runs["port"]["result"]
    assert list(hists) == [0] and len(hists[0]) == 3 and sim.system.elems.n_elem == 36


def test_net_constraint_rows(net):
    """The joints' rows (3 a pinned crossing) and the corners' fix_dof rows
    (3 a corner node, both beams' nodes at each of 4 corners) equal JAX's."""
    (n_nodes, n_elem, n_joints), runs = net
    jc, tc = (runs[s]["sims"][0].system.constraints for s in ("jax", "port"))
    assert tc.n_rows == jc.n_rows == 3 * n_joints + 3 * 8
    for key, want in _rows(jc).items():
        np.testing.assert_array_equal(_rows(tc)[key], want, err_msg=key)
    sim, hist = runs["port"]["result"]
    assert sim.system.elems.n_elem == n_elem == 24 and sim.system.n_coef == 4 * n_nodes
    assert len(hist) == 3 and hist[-1][1] < 0  # the centre sags


def test_tire_rim_rows(tire):
    """Every slot and component of every rim node (within 0.16 of the
    centre: the middle three columns, nine grid points) fixed by a fix_dof
    row of one entry, beside the seam's welded rows (3 + 9 a joint, two
    entries each), all equal to JAX's."""
    (n_nodes, n_shells, n_welds), runs = tire
    jc, tc = (runs[s]["sims"][0].system.constraints for s in ("jax", "port"))
    n_rim = 9
    assert tc.n_rows == jc.n_rows == 12 * n_welds + 12 * n_rim
    rows = _rows(tc)
    for key, want in _rows(jc).items():
        np.testing.assert_array_equal(rows[key], want, err_msg=key)
    single = np.bincount(rows["rows"], minlength=tc.n_rows) == 1
    dofs = rows["cols"][single[rows["rows"]]]  # coefficient * 3 + component
    assert len(dofs) == 12 * n_rim
    for node in np.unique(dofs // 12):
        assert sorted(dofs[dofs // 12 == node] % 12) == list(range(12))  # 4 slots x 3
    sim, hist = runs["port"]["result"]
    assert sim.system.elems.n_elem == n_shells == 12 and sim.system.n_coef == 4 * n_nodes
    assert len(hist) == 2 and hist[-1][1] > 0  # (step, max |dz|) at steps 0 and 2
