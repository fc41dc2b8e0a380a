"""3D steady Poisson in an embedded sphere (reference gate:
test/convergence_test.jl:51-70, global weighted L2 < 1e-2 at n=40).

The 137k-unknown system is solved matrix-free with Jacobi-preconditioned
BiCGStab — the matrix-free replacement for the reference's sparse direct
backslash."""

import numpy as np
import pytest

import penguin_tpu as pt
from penguin_tpu.solvers import DiffusionSteadyMono


@pytest.mark.slow
def test_steady_3d():
    n = 40
    mesh = pt.Mesh((n, n, n), (4.0, 4.0, 4.0), (0.0, 0.0, 0.0))
    body = pt.geometry.sphere((2.0, 2.0, 2.0), 1.0)
    cap = pt.compute_capacity(body, mesh, p=6, s=1)
    ops = pt.make_diffusion_ops(cap)
    bc = pt.Dirichlet(0.0)
    bc1 = pt.Dirichlet(1.0)
    bc_b = pt.BorderConditions(
        {k: bc1 for k in ("left", "right", "top", "bottom", "forward", "backward")}
    )
    phase = pt.Phase(cap, ops, lambda x, y, z: 6.0, 1.0)
    solver = DiffusionSteadyMono(phase, bc_b, bc)
    solver.solve(method="bicgstab", tol=1e-10, maxiter=4000)

    def u_ana(x, y, z):
        return 1.0 - (x - 2.0) ** 2 - (y - 2.0) ** 2 - (z - 2.0) ** 2

    _, _, glob, *_ = pt.check_convergence(u_ana, solver, cap, 2, False)
    assert glob < 1e-2
