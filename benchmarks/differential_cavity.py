"""Differentially heated cavity (de Vahl Davis 1983, Ra=1e3, Pr=0.71) —
reference benchmark/navierstokes_coupled/differential_cavity.jl.

Square cavity, hot left wall (+0.5), cold right wall (-0.5), adiabatic
floor/ceiling, Boussinesq buoyancy, NS + temperature Picard coupling
marched to steady state.  Gates (same as the reference's asserts):

- mean hot-wall Nusselt  Nu = 1.116  within 5%
- peak |u_x| on the vertical midline, scaled by alpha/L:  3.634 within 10%
- peak |u_y| on the horizontal midline, scaled by alpha/L: 3.7   within 10%

Run:  python benchmarks/differential_cavity.py [--coarse]
"""

import sys as _sys, os as _os
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import time

import numpy as np
import jax.numpy as jnp

import penguin_tpu as pt
from penguin_tpu.solvers.navierstokes import NavierStokesMono
from penguin_tpu.solvers.ns_scalar import (NavierStokesScalarCoupler,
                                           PicardCoupling)
from penguin_tpu.solvers.stokes import PinPressureGauge

Ra, Pr, L = 1.0e3, 0.71, 1.0
nu = float(np.sqrt(Pr / Ra))
alpha = nu / Pr
T_hot, T_cold = 0.5, -0.5

coarse = "--coarse" in _sys.argv
n = 32 if coarse else 64
dt, t_end = 0.05, 20.0


def build(n):
    mesh_p = pt.Mesh((n, n), (L, L), (0.0, 0.0))
    d = L / n
    mesh_ux = pt.Mesh((n, n), (L, L), (-0.5 * d, 0.0))
    mesh_uy = pt.Mesh((n, n), (L, L), (0.0, -0.5 * d))
    body = pt.geometry.full_domain(2)
    caps = [pt.compute_capacity(body, m, p=4, s=1)
            for m in (mesh_ux, mesh_uy, mesh_p)]
    fluid = pt.Fluid(
        mesh_u=(mesh_ux, mesh_uy), mesh_p=mesh_p,
        capacity_u=(caps[0], caps[1]),
        operator_u=(pt.make_diffusion_ops(caps[0]),
                    pt.make_diffusion_ops(caps[1])),
        capacity_p=caps[2], operator_p=pt.make_diffusion_ops(caps[2]),
        mu=nu, rho=1.0,
        f_u=lambda x, y, z: 0.0, f_p=lambda x, y, z: 0.0,
    )
    noslip = pt.Dirichlet(0.0)
    bc0 = pt.BorderConditions(
        {k: noslip for k in ("left", "right", "bottom", "top")})
    mom = NavierStokesMono(fluid, (bc0, bc0), PinPressureGauge(),
                           pt.Dirichlet(0.0))
    cap_T = caps[2]
    # scalar border keys follow the reference's plane classification
    # (solver.jl:379-409): "bottom"/"top" = x-min/x-max planes -> hot
    # vertical wall at x=0, cold at x=1, adiabatic floor/ceiling
    bc_T = pt.BorderConditions({
        "bottom": pt.Dirichlet(T_hot), "top": pt.Dirichlet(T_cold),
        "left": pt.Neumann(0.0), "right": pt.Neumann(0.0),
    })
    C = np.asarray(cap_T.C_om)
    T0w = jnp.asarray((T_hot + (T_cold - T_hot) * np.clip(C[..., 0], 0, 1))
                      * (np.asarray(cap_T.V) > 0))
    coupler = NavierStokesScalarCoupler(
        mom, cap_T, pt.make_diffusion_ops(cap_T), kappa=alpha,
        scalar_source=lambda x, y, z, t: 0.0,
        bc_scalar=bc_T, bc_scalar_cut=pt.Dirichlet(0.0),
        strategy=PicardCoupling(tol_T=1e-6, tol_U=1e-6, maxiter=8,
                                relaxation=1.0),
        beta=1.0, gravity=(0.0, -1.0), T_ref=0.0, T0=(T0w, T0w),
    )
    return coupler, (mesh_ux, mesh_uy, mesh_p)


def main():
    coupler, (mesh_ux, mesh_uy, mesh_p) = build(n)
    t0 = time.time()
    k, du = 0, np.inf
    chunk = 20  # steps per compiled scan (short scans, conv check between)
    while coupler.time < t_end - 1e-9:
        x_prev = coupler.x
        # pgmres: BiCGStab overflows on the f32 saddle point (cf. DFG run)
        coupler.run_fast(dt, min(coupler.time + chunk * dt, t_end),
                         scheme="BE", picard_iters=2, tol=1e-6,
                         method="pgmres")
        k += chunk
        du = max(float(jnp.abs(a - b).max())
                 for a, b in zip(coupler.x, x_prev)) / (chunk * dt)
        print(f"t={coupler.time:6.2f}  max|du/dt|={du:.3e}  "
              f"({(time.time()-t0):.0f}s)", flush=True)
        if du < 2e-5:
            break
    wall = time.time() - t0

    ux = np.asarray(coupler.x[0])
    uy = np.asarray(coupler.x[2])
    T = np.asarray(coupler.T[0])
    d = L / n

    # mean hot-wall Nusselt: second-order one-sided dT/dx at x=0 on the
    # interior rows of the (n+1, n+1) node grid
    dTdx = (-1.5 * T[0, :] + 2.0 * T[1, :] - 0.5 * T[2, :]) / d
    Nu = float(np.mean(-L * dTdx[1:-1]))

    # peak velocities on the midlines, dimensionless scale alpha/L
    xs_u = np.asarray(mesh_ux.nodes[0]) - 0.5 * d
    i_mid = int(np.argmin(np.abs(xs_u - 0.5)))
    u_peak = float(np.abs(ux[i_mid, 1:-1]).max()) / (alpha / L)
    ys_v = np.asarray(mesh_uy.nodes[1]) - 0.5 * d
    j_mid = int(np.argmin(np.abs(ys_v - 0.5)))
    v_peak = float(np.abs(uy[1:-1, j_mid]).max()) / (alpha / L)

    Nu_ref, u_ref, v_ref = 1.116, 3.634, 3.7
    print(f"n={n}  steps={k}  wall={wall:.0f}s  final max|du/dt|={du:.2e}")
    print(f"Nu_hot      = {Nu:.4f}   (de Vahl Davis {Nu_ref}, "
          f"dev {100*(Nu/Nu_ref-1):+.2f}%)")
    print(f"u_mid/alpha = {u_peak:.4f} (ref {u_ref}, "
          f"dev {100*(u_peak/u_ref-1):+.2f}%)")
    print(f"v_mid/alpha = {v_peak:.4f} (ref {v_ref}, "
          f"dev {100*(v_peak/v_ref-1):+.2f}%)")
    if not coarse:
        assert abs(Nu - Nu_ref) / Nu_ref <= 0.05, Nu
        assert abs(u_peak - u_ref) / u_ref <= 0.10, u_peak
        assert abs(v_peak - v_ref) / v_ref <= 0.10, v_peak
        print("differential cavity gates OK")
    return Nu, u_peak, v_peak


if __name__ == "__main__":
    main()
