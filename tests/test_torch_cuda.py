"""The port's CUDA kernels on the card (`cuda` marker; skipped without one).

Each kernel is held against its plain PyTorch twin on the same card inputs
(float64 within 1e-12 relative, float32 within 1e-5: the same arithmetic in
another summation order), and a short rollout through the kernels against
the same rollout through the twins. This file imports neither jax nor the
JAX package, so it runs where only PyTorch is installed; tests/conftest.py
imports jax, so on such a machine run it as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from tlfea_torch.constraints import FixedCoefs
from tlfea_torch.elements import feat10
from tlfea_torch.elements.assembly import lumped_mass
from tlfea_torch.materials import SVK, lame_from_E_nu
from tlfea_torch.ops import fem_kernels as fk
from tlfea_torch.solvers import StepState, System, newton
from tlfea_torch.utils.tetmesh import box_t10_mesh

DT = 1e-3
KERNELS = ["primal_prep", "hv", "svk_blocks", "node_reduce"]


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on the card")
    fk.build_kernels()
    return torch.device("cuda")


def _box_system(device, dtype, dims=(1.0, 0.2, 0.2, 3, 1, 1)):
    nodes, conn = box_t10_mesh(*dims)
    lam, mu = lame_from_E_nu(1e7, 0.3)
    elems = feat10.build(nodes, conn, rho=1000.0, dtype=dtype)
    f_ext = torch.zeros((len(nodes), 3), dtype=dtype)
    f_ext[:, 2] = lumped_mass(elems) * -9.81
    x0 = torch.as_tensor(nodes, dtype=dtype, device=device)
    system = System(elems=elems.to(device), material=SVK(lam, mu, 1e3, 1e3),
                    constraints=FixedCoefs.from_indices(np.nonzero(nodes[:, 0] < 1e-12)[0], x0))
    return system, x0, f_ext.to(device)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_matches_twin_on_card(cuda_dev, kernel, dtype, tol):
    system, _, _ = _box_system(cuda_dev, dtype)
    op = system.fem
    n = system.n_coef
    rng = np.random.default_rng(7)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=cuda_dev).contiguous()

    packed = dev(np.concatenate([rng.normal(size=(n, 3)) * 1e-3, rng.normal(size=(n, 6))], 1))
    _, prep = fk.primal_prep_plain(op, packed)
    args = {
        "primal_prep": (packed,),
        "hv": (dev(rng.normal(size=(n, 3))), prep, DT),
        "svk_blocks": (dev(rng.normal(size=(n, 3)) * 1e-3),),
        "node_reduce": (dev(rng.normal(size=(op.S * 6, op.E))),),
    }[kernel]
    fk.reset_launch_counts()
    got = getattr(fk, kernel)(op, *args)
    want = getattr(fk, kernel + "_plain")(op, *args)
    torch.cuda.synchronize()
    assert fk.LAUNCHES[kernel] == 1
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert _rel(g, w) < tol


@pytest.mark.cuda
def test_node_reduce_is_bitwise_repeatable(cuda_dev):
    system, _, _ = _box_system(cuda_dev, torch.float32)
    vals = torch.randn(system.fem.S * 3, system.fem.E, device=cuda_dev)
    first = fk.node_reduce(system.fem, vals)
    for _ in range(5):
        assert torch.equal(fk.node_reduce(system.fem, vals), first)


@pytest.mark.cuda
def test_rollout_through_kernels_matches_twins(cuda_dev):
    """Four float64 steps of a small cantilever, kernels against twins:
    same Newton and CG counts, positions within 1e-10 of the displacement."""
    system, x0, f_ext = _box_system(cuda_dev, torch.float64, dims=(1.0, 0.2, 0.2, 6, 1, 1))
    fs = float(f_ext.norm())
    params = newton.NewtonParams(dt=DT, rho=1e7, inner_atol=1e-3 * fs, outer_tol=1e-9,
                                 max_outer=2, max_inner=6, cg_rtol=1e-3, cg_max_iter=50)
    out = {}
    for plain in (False, True):
        sysx = replace(system, plain=plain)
        fk.reset_launch_counts()
        out[plain] = newton.make_rollout(sysx, params, 4, precond_refresh=2)(
            StepState.rest(sysx, x0), f_ext)
        assert (min(fk.LAUNCHES.values()) > 0) != plain
    (sk, ck), (sp, cp) = out[False], out[True]
    assert ck == cp
    assert float((sk.x - sp.x).abs().max()) < 1e-10 * float((sp.x - x0).abs().max())
