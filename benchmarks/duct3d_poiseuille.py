"""3D Navier-Stokes rectangular-duct validation with the exact Fourier
series — the quantitative 3D NS benchmark the reference lacks (its only
3D NS artifact is the 16x16x12 smoke example,
/root/reference/examples/3D/NavierStokes/channel_flow_3d.jl:1-70).

Laminar flow in a rectangular duct (cross-section [-a,a] x [-b,b],
pressure gradient G along x) has the classical series solution

  u(y,z) = (16 G a^2 / (mu pi^3)) * sum_{k odd} (-1)^{(k-1)/2} / k^3
           * [1 - cosh(k pi z / 2a) / cosh(k pi b / 2a)]
           * cos(k pi y / 2a)

Setup: the series profile is prescribed at the inlet, Outflow at the
outlet, ghost-row no-slip side walls (O(h^2) wall placement), steady
Newton-Krylov on the FULL Navier-Stokes operator (convection is zero on
the exact solution but every convection stencil is exercised).  The
mid-duct cross-section is compared to the series under cross-section
refinement; measured orders (n=8..32): max-norm 1.71 (corner-ring
limited), L2 1.82 (gated > 1.5 / > 1.8).

Run:  python benchmarks/duct3d_poiseuille.py           (CPU f64 study)
      python benchmarks/duct3d_poiseuille.py --timing  (an f32 ms/step
                                                        row at 8x48x29
                                                        CN, on the GPU)
      python benchmarks/duct3d_poiseuille.py --timing-large (PRODUCTION-
                                    scale row: 128x128x77 = 1.26M cells,
                                    CN/pgmres marched, warm-chunk timing)
"""

import sys as _sys, os as _os
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

timing_row = "--timing" in _sys.argv
timing_large = "--timing-large" in _sys.argv
if not (timing_row or timing_large):
    from benchmarks.phaseflow.harness import ensure_cpu_f64
    ensure_cpu_f64()

import time

import numpy as np
import jax.numpy as jnp

import penguin_tpu as pt
from penguin_tpu.solvers.navierstokes import NavierStokesMono
from penguin_tpu.solvers.stokes import PinPressureGauge

a, b = 0.5, 0.3      # half-widths (y, z)
mu, rho = 0.1, 1.0
G = 1.0              # driving gradient used in the exact profile


def u_exact(y, z, nterms=60):
    out = 0.0
    for k in range(1, 2 * nterms, 2):
        sgn = (-1.0) ** ((k - 1) // 2)
        out = out + (sgn / k ** 3
                     * (1.0 - np.cosh(k * np.pi * z / (2 * a))
                        / np.cosh(k * np.pi * b / (2 * a)))
                     * np.cos(k * np.pi * y / (2 * a)))
    return 16.0 * G * a ** 2 / (mu * np.pi ** 3) * out


def solve(n, nx=6, dtype=None):
    Lx = 1.0
    Ny, Nz = n, max(int(round(n * b / a)), 4)
    Ly, Lz = 2 * a, 2 * b
    dxyz = (Lx / nx, Ly / Ny, Lz / Nz)
    # mesh convention: integration cells span [x0 + h/2, x0 + L + h/2]
    # (mesh.py), so shift the origin a half cell to put the ghost-row
    # walls exactly at y = ±a, z = ±b
    x0 = (0.0, -a - 0.5 * dxyz[1], -b - 0.5 * dxyz[2])
    mesh_p = pt.Mesh((nx, Ny, Nz), (Lx, Ly, Lz), x0)
    meshes_u = [pt.Mesh((nx, Ny, Nz), (Lx, Ly, Lz),
                        tuple(x0[i] - (0.5 * dxyz[i] if i == ax else 0.0)
                              for i in range(3)))
                for ax in range(3)]
    body = pt.geometry.full_domain(3)
    kw = dict(p=4, s=1) if dtype is None else dict(p=4, s=1, dtype=dtype)
    caps_u = [pt.compute_capacity(body, m, **kw) for m in meshes_u]
    cap_p = pt.compute_capacity(body, mesh_p, **kw)
    fluid = pt.Fluid(
        mesh_u=tuple(meshes_u), mesh_p=mesh_p,
        capacity_u=tuple(caps_u),
        operator_u=tuple(pt.make_diffusion_ops(c) for c in caps_u),
        capacity_p=cap_p, operator_p=pt.make_diffusion_ops(cap_p),
        mu=mu, rho=rho,
        f_u=lambda x, y, z: 0.0, f_p=lambda x, y, z: 0.0)

    def inflow(x, y, z, t=None):
        return jnp.asarray(u_exact(np.asarray(y), np.asarray(z)))

    # the inlet profile is evaluated on static arrays at setup
    noslip = pt.Dirichlet(0.0)
    bc_ux = pt.BorderConditions(
        {"left": pt.Dirichlet(lambda x, y, z, t=None: u_exact_j(y, z)),
         "right": pt.Outflow(),
         "bottom": noslip, "top": noslip,
         "backward": noslip, "forward": noslip})
    bc_0 = pt.BorderConditions(
        {k: noslip for k in ("left", "right", "bottom", "top",
                             "backward", "forward")})
    solver = NavierStokesMono(fluid, (bc_ux, bc_0, bc_0),
                              PinPressureGauge(), pt.Dirichlet(0.0),
                              wall_row="ghost")
    if _SKIP_STEADY:
        return 0.0, 1.0, solver, 0.0
    solver.solve_steady_newton_krylov(max_iter=12, tol=1e-11,
                                     lin_maxiter=400)
    ux = np.asarray(solver.velocity(0))
    C = np.asarray(caps_u[0].C_om)
    i_mid = nx // 2
    y = C[i_mid, :Ny, :Nz, 1]
    z = C[i_mid, :Ny, :Nz, 2]
    ue = u_exact(y, z)
    err = np.abs(ux[i_mid, :Ny, :Nz] - ue)
    l2 = float(np.sqrt((err ** 2).mean()) / np.sqrt((ue ** 2).mean()))
    return float(err.max()), float(np.abs(ue).max()), solver, l2


_SKIP_STEADY = False


def u_exact_j(y, z):
    # jnp-compatible series (traced under jit for the BC evaluation);
    # 40 odd terms — enough for ~1e-6 truncation and cosh stays inside
    # the f32 range (cosh(74) ~ 1e32; the 60-term numpy reference series
    # runs in f64 host-side only)
    out = 0.0
    for k in range(1, 80, 2):
        sgn = (-1.0) ** ((k - 1) // 2)
        out = out + (sgn / k ** 3
                     * (1.0 - jnp.cosh(k * jnp.pi * z / (2 * a))
                        / jnp.cosh(k * jnp.pi * b / (2 * a)))
                     * jnp.cos(k * jnp.pi * y / (2 * a)))
    return 16.0 * G * a ** 2 / (mu * jnp.pi ** 3) * out


def _study():
    """Measured (f64): max-norm errors 0.084/0.046/0.025/0.014/0.0079 at
    n=8..32 — fitted order 1.71 STABLE across the sweep (an extra level
    was added in round 5 to test the 'order rises toward 2' prediction:
    it does not).  The max-norm error is CORNER-limited: the duct's four
    wall-edge lines carry the ghost rows' 1D extrapolation degeneracy, so
    the worst cell sits by an edge at every size; the L2 norm, which the
    corner ring cannot dominate, fits 1.82 (gated > 1.8) — near-second
    order in the bulk with an O(h^1.7) corner ring in max norm."""
    errs, el2s, hs = [], [], []
    for n in (8, 12, 16, 24, 32):
        t0 = time.time()
        e, scale, _, l2 = solve(n)
        errs.append(e / scale)
        el2s.append(l2)
        hs.append(2 * a / n)
        print(f"n={n:3d}: max rel err {e / scale:.5f}  L2 rel {l2:.5f}"
              f"  [{time.time()-t0:.1f} s]")
    order = np.polyfit(np.log(hs), np.log(errs), 1)[0]
    order_l2 = np.polyfit(np.log(hs), np.log(el2s), 1)[0]
    print(f"fitted order: max-norm {order:.2f}, L2 {order_l2:.2f}")
    assert errs[-1] < 0.01, errs
    assert order > 1.5, order
    assert order_l2 > 1.8, order_l2
    print("OK")


def _timing_row():
    # f32 timing row: 48x48x29-class 3D duct, implicit-Picard CN steps
    # (fgmres/DCT inner solves), marched from rest with the exact-series
    # inflow.  f32 note: the 80-term cosh series overflows f32 (cosh(74)
    # is fine, k>100 is not) — the traced BC series caps terms; the f32
    # steady JFNK variant is NOT offered (it NaNs at this aspect ratio,
    # march instead).
    import jax

    e, scale, solver = None, None, None
    n = 48
    nx = 8
    dt = 2e-3
    # build via solve()'s setup but march unsteady instead of JFNK
    import benchmarks.duct3d_poiseuille as _self  # noqa: F401
    global _SKIP_STEADY
    _SKIP_STEADY = True
    try:
        e, scale, solver, _ = solve(n, nx=nx, dtype=jnp.float32)
    finally:
        _SKIP_STEADY = False
    # CN/AB2 + pgmres: the duct has NO cut cells, so the Chebyshev-Schur
    # bounds are well-behaved and the convective CFL is tiny (u~0.4,
    # CFL ~ 0.04); the Picard/DCT path measured ~1 s/step here — the 3D
    # DCT transform is the wrong tool at this size
    t0 = time.time()
    solver.solve_unsteady(dt, 20 * dt, scheme="CN", method="pgmres",
                          tol=1e-5, maxiter=120)
    jax.block_until_ready(solver.x)
    t_warm = time.time()
    solver.solve_unsteady(dt, 20 * dt, scheme="CN", method="pgmres",
                          tol=1e-5, maxiter=120, x0=solver.x,
                          t_start=20 * dt)
    jax.block_until_ready(solver.x)
    ms = (time.time() - t_warm) / 20 * 1e3
    umax = float(max(np.abs(np.asarray(u)).max() for u in solver.x[:4]))
    print(f"f32 8x{n}x{max(int(round(n*b/a)),4)} CN/AB2 pgmres: "
          f"{ms:.1f} ms/step (warm 10-step chunk), max|u| {umax:.3f}")
    assert np.isfinite(ms) and np.isfinite(umax) and umax < 10.0
    print("OK")


def _timing_large_row():
    """The >=1M-cell 3D NS number: 128x128x77 duct (1.26M pressure cells,
    9.2M state values), CN + block-Schur pgmres marched from rest, f32.
    Timed over warm 10-step chunks (one compiled scan, short chunks).  Alongside ms/step the row reports GMRES
    its/step and the cell-step throughput — the quantities a production
    sizing decision needs; 'achieved bandwidth' is NOT printed because a
    matrix-free NS step is a fused chain whose true HBM traffic XLA
    decides (any number here would be a model, not a measurement)."""
    import jax

    n = 128
    nx = 128
    dt = 2e-3
    global _SKIP_STEADY
    _SKIP_STEADY = True
    try:
        _, _, solver, _ = solve(n, nx=nx, dtype=jnp.float32)
    finally:
        _SKIP_STEADY = False
    Ny, Nz = n, max(int(round(n * b / a)), 4)
    ncells = nx * Ny * Nz
    # SHORT dispatch chunks: 2-step chunks with maxiter 60 keep each
    # device-side scan short
    chunk = 2
    t0 = time.time()
    solver.solve_unsteady(dt, chunk * dt, scheme="CN", method="pgmres",
                          tol=1e-5, maxiter=60)
    jax.block_until_ready(solver.x)
    print(f"# cold chunk (compile + {chunk} steps): {time.time()-t0:.0f} s",
          flush=True)
    its, rels = [], []
    t_warm = time.time()
    for k in range(10):
        solver.solve_unsteady(dt, (k + 2) * chunk * dt, scheme="CN",
                              method="pgmres", tol=1e-5, maxiter=60,
                              x0=solver.x,
                              t_start=(k + 1) * chunk * dt,
                              conv_prev=getattr(solver, "conv_prev_out",
                                                None))
        jax.block_until_ready(solver.x)
        its.append(np.asarray(solver.krylov_iters))
        rels.append(np.asarray(solver.krylov_relres))
    ms = (time.time() - t_warm) / (10 * chunk) * 1e3
    it = np.concatenate(its)
    rel = np.concatenate(rels)
    umax = float(max(np.abs(np.asarray(u)).max() for u in solver.x[:6]))
    thru = ncells / (ms * 1e-3) / 1e6
    print(f"f32 {nx}x{Ny}x{Nz} ({ncells/1e6:.2f}M cells) CN pgmres: "
          f"{ms:.0f} ms/step warm, GMRES {it.mean():.0f} it/step "
          f"(max {it.max()}, relres max {rel.max():.1e}), "
          f"{thru:.1f} Mcell-steps/s, max|u| {umax:.3f}", flush=True)
    assert np.isfinite(ms) and np.isfinite(umax) and umax < 10.0
    assert rel.max() < 1e-3, rel.max()
    print("OK")


if __name__ == "__main__":
    if timing_large:
        _timing_large_row()
    elif timing_row:
        _timing_row()
    else:
        _study()
