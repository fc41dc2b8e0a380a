"""3D Stokes smoke test (the solver is dimension-generic) and a vmapped
parameter sweep — the 'data parallel' analogue from SURVEY §2:
batches of geometries solved in one compiled program."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import penguin_tpu as pt
from penguin_tpu.solvers.stokes import PinPressureGauge, StokesMono


@pytest.mark.slow
def test_stokes_3d_hydrostatic():
    n, L = 8, 1.0
    mesh_p = pt.Mesh((n, n, n), (L, L, L), (0.0, 0.0, 0.0))
    d = L / n
    meshes_u = [
        pt.Mesh((n, n, n), (L, L, L),
                tuple(-0.5 * d if i == a else 0.0 for i in range(3)))
        for a in range(3)
    ]
    body = pt.geometry.full_domain(3)
    caps_u = [pt.compute_capacity(body, m, p=4, s=1) for m in meshes_u]
    cap_p = pt.compute_capacity(body, mesh_p, p=4, s=1)
    fluid = pt.Fluid(
        mesh_u=tuple(meshes_u), mesh_p=mesh_p,
        capacity_u=tuple(caps_u),
        operator_u=tuple(pt.make_diffusion_ops(c) for c in caps_u),
        capacity_p=cap_p, operator_p=pt.make_diffusion_ops(cap_p),
        mu=1.0, rho=1.0,
        f_u=lambda x, y, z: 1.0, f_p=lambda x, y, z: 0.0,
    )
    noslip = pt.Dirichlet(0.0)
    bc = pt.BorderConditions({k: noslip for k in
                              ("left", "right", "bottom", "top",
                               "backward", "forward")})
    solver = StokesMono(fluid, (bc, bc, bc), PinPressureGauge(), pt.Dirichlet(0.0))
    solver.solve(method="lstsq")
    # closed box + constant force: u = 0, dp/dx balances the force
    for d_ in range(3):
        assert np.abs(np.asarray(solver.velocity(d_))[:n, :n, :n]).max() < 1e-8
    p = np.asarray(solver.pressure)
    dp = p[1:n - 1, 1:n - 1, 1:n - 1] - p[0:n - 2, 1:n - 1, 1:n - 1]
    np.testing.assert_allclose(dp, -L / n, atol=1e-8)


def test_vmapped_geometry_sweep():
    """Solve a batch of embedded-circle Poisson problems in ONE compiled
    program by vmapping over the radius — the framework's batched-geometry
    capability (no Julia analogue: the reference loops scripts)."""
    mesh = pt.Mesh((24, 24), (4.0, 4.0), (0.0, 0.0))
    bc1 = pt.Dirichlet(0.0)
    bc_b = pt.BorderConditions({k: bc1 for k in ("left", "right", "top", "bottom")})

    from penguin_tpu.capacity import compute_capacity_spacetime

    def solve_radius(radius):
        # traced-radius capacity via the parametrized space-time engine
        body = lambda x, y, t, r: jnp.sqrt((x - 2.0) ** 2 + (y - 2.0) ** 2) - r
        cap_st = compute_capacity_spacetime(body, mesh, 0.0, 1.0, p=6, s=1,
                                            params=radius)
        from penguin_tpu.solvers.moving_diffusion import slice_spacetime
        from penguin_tpu.solvers.moving_diffusion import _direct_solve

        ops, Va, Vb, G0, C_sp, Cg = slice_spacetime(cap_st)

        def apply(x):
            TW, TG = x
            q = ops.flux(TW, TG)
            r1 = ops.GT(q)
            r2 = G0 * TG
            from penguin_tpu.assembly import _col_G_nz

            act = _col_G_nz(ops)
            r1 = jnp.where(act, r1, TW)
            r2 = jnp.where(G0 > 0, r2, TG)
            return (r1, r2)

        b1 = jnp.where(_colg(ops), ops.V * 4.0, 0.0)
        b2 = jnp.zeros_like(b1)
        x = _direct_solve(apply, (b1, b2))
        # max of u ~ r^2 at the center for -ΔT = 4 in a disk
        return jnp.max(x[0])

    from penguin_tpu.assembly import _col_G_nz as _colg

    radii = jnp.asarray([0.6, 0.9, 1.2])
    peaks = jax.vmap(solve_radius)(radii)
    peaks = np.asarray(peaks)
    # u_max = r^2 (u = r^2 - d^2 with f=4), loose tolerance on coarse grid
    np.testing.assert_allclose(peaks, np.asarray(radii) ** 2, rtol=0.15)
    assert np.all(np.diff(peaks) > 0)


@pytest.mark.slow
def test_navierstokes_3d_cavity_smoke():
    """3D lid-driven cavity, few Picard sweeps: the convection operators are
    dimension-generic (reference NS is 2D-focused; this exceeds parity)."""
    from penguin_tpu.solvers.navierstokes import NavierStokesMono

    n, L = 6, 1.0
    mesh_p = pt.Mesh((n, n, n), (L, L, L), (0.0, 0.0, 0.0))
    d = L / n
    meshes_u = [
        pt.Mesh((n, n, n), (L, L, L),
                tuple(-0.5 * d if i == a else 0.0 for i in range(3)))
        for a in range(3)
    ]
    body = pt.geometry.full_domain(3)
    caps_u = [pt.compute_capacity(body, m, p=4, s=1) for m in meshes_u]
    cap_p = pt.compute_capacity(body, mesh_p, p=4, s=1)
    fluid = pt.Fluid(
        mesh_u=tuple(meshes_u), mesh_p=mesh_p,
        capacity_u=tuple(caps_u),
        operator_u=tuple(pt.make_diffusion_ops(c) for c in caps_u),
        capacity_p=cap_p, operator_p=pt.make_diffusion_ops(cap_p),
        mu=1e-2, rho=1.0,
        f_u=lambda x, y, z: 0.0, f_p=lambda x, y, z: 0.0,
    )
    noslip, lid = pt.Dirichlet(0.0), pt.Dirichlet(1.0)
    keys = ("left", "right", "bottom", "top", "backward", "forward")
    bc_ux = pt.BorderConditions(
        {k: (lid if k == "forward" else noslip) for k in keys})
    bc_0 = pt.BorderConditions({k: noslip for k in keys})
    solver = NavierStokesMono(fluid, (bc_ux, bc_0, bc_0), PinPressureGauge(),
                              pt.Dirichlet(0.0))
    solver.solve_steady(max_iter=3, tol=1e-12, method="lstsq")

    ux = np.asarray(solver.velocity(0))
    assert all(np.isfinite(np.asarray(v)).all() for v in solver.x)
    assert np.abs(ux).max() > 0.1  # lid drives a flow
    # interior velocity bounded by the lid speed (sanity)
    assert np.abs(ux).max() < 1.5
