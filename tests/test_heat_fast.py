"""FastHeatBE (the benchmark stepper) must reproduce the general masked
block solver exactly: same operators, same masks, interface unknowns
eliminated analytically."""

import numpy as np
import jax.numpy as jnp

import penguin_tpu as pt
from penguin_tpu.solvers import DiffusionUnsteadyMono
from penguin_tpu.solvers.heat_fast import FastHeatBE


def test_fast_heat_matches_general():
    nx = ny = 32
    lx = ly = 4.0
    mesh = pt.Mesh((nx, ny), (lx, ly), (0.0, 0.0))
    body = pt.geometry.circle((2.01, 2.01), 1.0)
    cap = pt.compute_capacity(body, mesh)
    ops = pt.make_diffusion_ops(cap)
    bc = pt.Dirichlet(1.0)
    bc0 = pt.Dirichlet(0.0)
    bc_b = pt.BorderConditions(
        {"left": bc0, "right": bc0, "top": bc0, "bottom": bc0}
    )
    f = lambda x, y, z, t: 0.0
    phase = pt.Phase(cap, ops, f, 1.0)
    dt = 0.25 * (lx / nx) ** 2
    t_end = 6.5 * dt  # initial solve + ceil(6.5)=7 steps = 8 BE applications

    z = jnp.zeros(mesh.np_shape)
    solver = DiffusionUnsteadyMono(phase, bc_b, bc, dt, (z, z), "BE")
    solver.solve(t_end, method="direct")

    fast = FastHeatBE(cap, ops, 1.0, f, bc, bc_b, dt,
                      cg_tol=1e-13, cg_maxiter=500)
    Tf = fast.run(z, 8)

    ref = np.asarray(solver.x_omega)
    got = np.asarray(Tf)
    active = np.asarray(fast.active)
    assert np.abs(got[active] - ref[active]).max() < 1e-9


def test_f32_matches_f64_heat():
    """SURVEY §4 JAX-specific gate: the f32 production path agrees with
    the f64 verification path to single-precision tolerance on the
    benchmark configuration (scaled down)."""
    nx = 64
    lx = 4.0
    mesh = pt.Mesh((nx, nx), (lx, lx), (0.0, 0.0))
    body = pt.geometry.circle((2.0, 2.0), 1.0)
    bc_b = pt.BorderConditions({k: pt.Dirichlet(0.0)
                                for k in ("left", "right", "top", "bottom")})
    dt = 0.25 * (lx / nx) ** 2

    results = {}
    for dtype in (jnp.float64, jnp.float32):
        cap = pt.compute_capacity(body, mesh, p=4, s=1, dtype=dtype)
        ops = pt.make_diffusion_ops(cap)
        fast = FastHeatBE(cap, ops, 1.0, lambda x, y, z, t: 0.0,
                          pt.Dirichlet(1.0), bc_b, dt,
                          cg_tol=1e-6, cg_maxiter=64, dtype=dtype)
        T = fast.run(jnp.zeros(mesh.np_shape, dtype), 20)
        results[str(dtype)] = np.asarray(T, np.float64)

    a = results["<class 'jax.numpy.float64'>"]
    b = results["<class 'jax.numpy.float32'>"]
    assert np.abs(a - b).max() < 5e-4, np.abs(a - b).max()


def test_fast_heat_3d_matches_general():
    """The 3D stencil collapse must reproduce the general solver."""
    n = (12, 10, 14)
    mesh = pt.Mesh(n, (2.0, 2.0, 2.0), (0.0, 0.0, 0.0))
    body = pt.geometry.sphere((1.0, 1.0, 1.0), 0.7)
    cap = pt.compute_capacity(body, mesh)
    ops = pt.make_diffusion_ops(cap)
    bc = pt.Dirichlet(1.0)
    bc0 = pt.Dirichlet(0.0)
    bc_b = pt.BorderConditions({k: bc0 for k in
                                ("left", "right", "top", "bottom",
                                 "front", "back")})
    f = lambda x, y, z, t: 0.0
    phase = pt.Phase(cap, ops, f, 1.0)
    dt = 1e-3
    z = jnp.zeros(mesh.np_shape)
    solver = DiffusionUnsteadyMono(phase, bc_b, bc, dt, (z, z), "BE")
    solver.solve(3.5 * dt, method="direct")

    fast = FastHeatBE(cap, ops, 1.0, f, bc, bc_b, dt,
                      cg_tol=1e-13, cg_maxiter=800)
    Tf = fast.run(z, 5)

    ref = np.asarray(solver.x_omega)
    got = np.asarray(Tf)
    active = np.asarray(fast.active)
    assert np.abs(got[active] - ref[active]).max() < 1e-8
