"""The ported contact scenes under prescribed motion (`tlfea_torch.examples`:
`bubble_gripper`, `self_contact_fold`) against the JAX scripts of
`examples/`, in float64 on the CPU.

The scripts run a few steps in both packages at the same options, chosen so
that the bodies touch within them: the gripper closing at 3 m/s with dt
4e-3 (contact from its third step), the fold (nx 6) pressed 0.096 m over 4
steps (self-contact in the last). Equal Newton / CG counts per step, every
step's positions and the VTU files within 1e-9 of the displacement scale,
equal force-carrying contacts at every collision call
(`tests/example_parity.py`). The JAX gripper's pads get two cells through
their thickness, as the port's (`bubble_gripper.PAD_CELLS`): with the JAX
script's one, every corner of a pad is on its surface, its affine pressure
field is zero and no contact ever fires.
"""

import pytest
import torch

from tests.example_parity import assert_same_run, run_pair
from tlfea_torch.examples.bubble_gripper import PAD_CELLS

torch.set_num_threads(2)

RUNS = {
    "bubble_gripper": ["--steps=4", "--dt=4e-3", "--close_speed=3", "--close_frac=1.0",
                       "--vtk_every=1"],
    "self_contact_fold": ["--steps=4", "--nx=6", "--press=0.096", "--vtk_every=1"],
}
JAX_PAD = (0.08, 0.3, 0.3, 1, 3, 3)  # the JAX gripper's pad mesh


def _pads_as_port(mp):
    """before_jax: the JAX gripper's pads at PAD_CELLS; its other meshes as
    they are."""
    def patch(jmod):
        mesher = jmod.box_t10_mesh
        mp.setattr(jmod, "box_t10_mesh",
                   lambda *a: mesher(*(a[:3] + PAD_CELLS if a == JAX_PAD else a)))
    return patch


@pytest.fixture(scope="module", params=list(RUNS))
def scene(request, tmp_path_factory):
    script = request.param
    with pytest.MonkeyPatch.context() as mp:
        runs = run_pair(script, RUNS[script], tmp_path_factory.mktemp(script), mp,
                        before_jax=_pads_as_port(mp) if script == "bubble_gripper" else None)
    return script, runs


def test_scene_matches_jax(scene):
    """Counts, positions, files and force-carrying contacts; some step in
    contact."""
    _, runs = scene
    assert_same_run(runs, contact=True)


def test_prescribed_motion(scene):
    """The retargeted pins at the end of the schedule: the gripper's driven
    faces closed by 4 steps of 3 m/s x 4e-3 s each, the fold's upper end
    lowered by the whole --press; main() returns the Simulation and the
    printed history."""
    script, runs = scene
    sim, hist = runs["port"]["result"]
    x0 = sim.system.elems.x_ref
    cons = sim.system.constraints
    if script == "bubble_gripper":
        pinned = cons.mask[:, 0] > 0
        moved = (cons.target - x0)[pinned]
        assert torch.allclose(moved[:, 0].abs(), torch.full_like(moved[:, 0], 0.048),
                              rtol=0, atol=1e-15)
        assert float(moved[:, 1:].abs().max()) == 0.0
        assert hist == [(0, 0)]
    else:
        drop = (cons.target - x0[cons.idx])[:, 2]
        n_up = int((drop < 0).sum())
        assert n_up > 0 and torch.allclose(drop[drop < 0], torch.full((n_up,), -0.096,
                                                                       dtype=drop.dtype))
        assert hist == [(0, 0)]
    assert sim.step_count == 4 and sim.state.x.dtype == torch.float64
