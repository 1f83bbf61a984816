"""The ported contact scenes with free bodies (`tlfea_torch.examples`:
`sphere_drop_collision`, `item_drop` with `--collision=hydro` and `deme`)
against the JAX scripts of `examples/`, in float64 on the CPU, on their
fallback meshes (the reference's sphere mesh is not in the repository).

Each scene runs a few steps in both packages at the same options, the
bodies overlapping from the first step (a negative `--drop_height`), so the
compared steps are in contact: equal Newton / CG counts per step, every
step's positions and the VTU files within 1e-9 of the displacement scale,
equal force-carrying contacts at every collision call
(`tests/example_parity.py`). The DEM branch runs with the contact stiffness
and damping given (`--dem_kn`, `--dem_cn`): the JAX script's material map
takes the row-sum lumped mass, negative at every T10 vertex, and its cn is
NaN; the port's map (the diagonally scaled mass) is held to JAX's
`dem_params_from_material` on JAX's masses apart.
"""

import numpy as np
import pytest
import torch

from tests.example_parity import assert_same_run, run_pair
from tlfea.collision import dem as j_dem
from tlfea.elements import feat10 as j_feat10
from tlfea.elements.assembly import lumped_mass as j_lumped_mass
from tlfea.elements.assembly import mass_diag as j_mass_diag

torch.set_num_threads(2)

# The port's material map on item_drop's fallback scene (kn, cn).
DEM_KN, DEM_CN = 4578.754578754578, 15.442694097106264
SCENES = {
    "sphere_drop": ("sphere_drop_collision",
                    ["--steps=3", "--drop_height=-0.005", "--vtk_every=1"]),
    "item_hydro": ("item_drop", ["--steps=3", "--drop_height=-0.005", "--vtk_every=1"]),
    "item_deme": ("item_drop", ["--steps=3", "--drop_height=-0.005", "--vtk_every=1",
                                "--collision=deme", f"--dem_kn={DEM_KN!r}",
                                f"--dem_cn={DEM_CN!r}"]),
}


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request, tmp_path_factory):
    script, argv = SCENES[request.param]
    with pytest.MonkeyPatch.context() as mp:
        runs = run_pair(script, argv, tmp_path_factory.mktemp(request.param), mp)
    return request.param, runs


def test_scene_matches_jax(scene):
    """Counts, positions, files and force-carrying contacts, every step in
    contact."""
    name, runs = scene
    n = assert_same_run(runs, contact=True)
    assert min(n) > 0, (name, n)


def test_scene_result(scene):
    """main() returns the Simulation, on the CPU in float64, and the history
    the script prints: (step, contacts) first at step 0."""
    name, runs = scene
    sim, hist = runs["port"]["result"]
    assert sim.state.x.dtype == torch.float64 and sim.state.x.device.type == "cpu"
    assert sim is runs["port"]["sims"][0] and sim.step_count == 3
    assert hist[0][0] == 0 and hist[0][1] == int(runs["port"]["contacts"][0].n_contacts) > 0
    if name != "sphere_drop":  # it calls the collision and the solver apart
        assert sim.last_diag["converged"] in (True, False)


def test_dem_material_map(tmp_path, monkeypatch):
    """item_drop --collision=deme without --dem_kn: the port's contact
    parameters are JAX's `dem_params_from_material` at the median sphere
    radius and the median diagonally scaled (HRZ) lumped mass of the
    contact spheres, that mass taken from JAX's `mass_diag` and
    `lumped_mass`; JAX's row-sum mass there, the JAX script's, is negative
    (its cn NaN)."""
    from tlfea_torch.examples import item_drop

    monkeypatch.chdir(tmp_path)
    sim, _ = item_drop.main(["--steps=1", "--collision=deme", "--vtk_every=0",
                             "--device=cpu", "--dtype=float64"])
    col = sim.collision
    surf = torch.unique(torch.cat([i for pair in col._pairs for i in pair])).numpy()
    nodes = sim.system.elems.x_ref.numpy()
    jel = j_feat10.build(nodes, sim.system.elems.conn.numpy(), rho=1000.0)
    diag, rows = np.asarray(j_mass_diag(jel)), np.asarray(j_lumped_mass(jel))
    hrz = diag * (rows.sum() / diag.sum())
    np.testing.assert_allclose(item_drop.hrz_lumped_mass(sim.system.elems).numpy(), hrz,
                               rtol=1e-13)
    assert (hrz > 0).all() and np.median(rows[surf]) < 0
    want = j_dem.dem_params_from_material(2e6, 0.3, 0.0,
                                          radius=float(np.median(col._radii.numpy()[surf])),
                                          mass=float(np.median(hrz[surf])), mu=0.4)
    got = sim.collision_params
    for key in ("kn", "cn", "mu", "v_reg"):
        assert abs(getattr(got, key) - float(getattr(want, key))) <= 1e-12 * abs(
            float(getattr(want, key))), key
    assert (got.kn, got.cn) == pytest.approx((DEM_KN, DEM_CN), rel=1e-12)
    assert bool(torch.isfinite(sim.state.x).all())
