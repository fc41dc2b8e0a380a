"""DFG 2D vortex-shedding benchmark (Schaefer-Turek geometry, Re=100).

Channel 2.2 x 0.41 with a cylinder of radius 0.05 at (0.2, 0.2) (slightly
off-center, which seeds the shedding instability); parabolic inflow with
peak 1.5 -> mean velocity 1.0, nu = 1e-3 -> Re = 100.  Implicit-Picard CN
unsteady NS to periodic shedding; drag/lift coefficients, Strouhal number
and the front-to-back pressure difference are sampled IN-SCAN every step
and gated against the published benchmark ranges.

Mirrors /root/reference/benchmark/navierstokes/flow_around_circle_cd_cl.jl
(same geometry/discretisation family; the reference post-processes a full
state history on the host, here scalars are recorded inside the jitted
scan).  Published ranges (Schaefer & Turek 1996, 2D-2): Cd in [3.22, 3.24],
Cl_max in [0.99, 1.01], St in [0.295, 0.305]; the reference script gates
Cd in [3.1, 3.6], |Cl_mean| < 0.08, St in [0.29, 0.32] at 128x64.

Accuracy record (f32, 256x128 implicit-Picard CN + fgmres/DCT-Schur,
4000 steps, fgmres ~8 it/step; exact wall geometry via the -h/2 origin
shift + ghost wall rows + DOF-centroid BC sampling + the MOMENT-CONSISTENT
CUT FLUX, now the default):
Cd_mean 3.2819, Cl_mean -0.0270, Cl_amp 1.1371, St 0.2999,
dP_mean 2.4749 — St dead-center in the published window, dP within 0.2%,
Cd within 1.3% (round-4 centroid flux: 2.2%).  128x64 `--coarse` on the
same path: Cd 3.2365 — INSIDE the published band [3.22, 3.24]'s 2D-2
vicinity even at the reference's own grid (round-4 centroid: 3.3029) —
Cl_amp 1.159, St 0.2999, dP 2.302.

Run:  python benchmarks/dfg_cylinder_shedding.py           (256 x 128)
      python benchmarks/dfg_cylinder_shedding.py --coarse  (128 x 64)
"""

import sys as _sys, os as _os
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import time
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp

import penguin_tpu as pt
from penguin_tpu.solvers.navierstokes import NavierStokesMono
from penguin_tpu.solvers.stokes import PinPressureGauge

Lx, Ly = 2.2, 0.41
R, cx, cy = 0.05, 0.2, 0.2
D = 2 * R
Umax, Ubar = 1.5, 1.0
rho, nu = 1.0, 1e-3
T_ramp = 1.0


def inflow(x, y, z=0.0, t=None):
    """Parabolic profile with a smooth cosine start-up ramp: an impulsive
    start under CN spikes |u| ~ 16 at step 0 and the AB2 convection
    extrapolation then blows past the CFL limit (observed); DFG itself
    prescribes ramped inflow for the time-dependent cases (2D-3)."""
    xi = y / Ly
    prof = Umax * 4.0 * xi * (1.0 - xi)
    if t is None:
        return prof
    ramp = jnp.where(t >= T_ramp, 1.0,
                     0.5 * (1.0 - jnp.cos(jnp.pi * t / T_ramp)))
    return ramp * prof


def dfg_case(nx, ny, dtype=jnp.float32):
    """The DFG 2D-2 channel-cylinder NS solver on an ``nx`` x ``ny`` grid.

    Returns a namespace with ``solver`` (a ``NavierStokesMono``) and
    ``force_scale`` (0.5 ρ Ū² D, the drag/lift normalization)."""
    dx = Lx / nx
    dy = Ly / ny
    # mesh convention: integration cells span [x0 + h/2, x0 + L + h/2]
    # (mesh.py), so shift the origin half a cell to put the channel walls
    # exactly at y = 0 and y = Ly (ghost wall rows impose no-slip THERE) —
    # otherwise the walls sit h/2 high and the midline misses the cylinder
    # offset that seeds the DFG asymmetry
    mesh_p = pt.Mesh((nx, ny), (Lx, Ly), (-0.5 * dx, -0.5 * dy))
    mesh_ux = pt.Mesh((nx, ny), (Lx, Ly), (-dx, -0.5 * dy))
    mesh_uy = pt.Mesh((nx, ny), (Lx, Ly), (-0.5 * dx, -dy))
    body = pt.geometry.complement(pt.geometry.circle((cx, cy), R))
    caps = [pt.compute_capacity(body, m, p=4, s=1, dtype=dtype)
            for m in (mesh_ux, mesh_uy, mesh_p)]
    fluid = pt.Fluid(
        mesh_u=(mesh_ux, mesh_uy), mesh_p=mesh_p,
        capacity_u=(caps[0], caps[1]),
        operator_u=(pt.make_diffusion_ops(caps[0]),
                    pt.make_diffusion_ops(caps[1])),
        capacity_p=caps[2], operator_p=pt.make_diffusion_ops(caps[2]),
        mu=rho * nu, rho=rho,
        f_u=lambda x, y, z: 0.0, f_p=lambda x, y, z: 0.0,
    )
    noslip = pt.Dirichlet(0.0)
    bc_ux = pt.BorderConditions({"left": pt.Dirichlet(inflow),
                                 "right": pt.Outflow(),
                                 "bottom": noslip, "top": noslip})
    bc_uy = pt.BorderConditions({"left": noslip, "right": noslip,
                                 "bottom": noslip, "top": noslip})
    solver = NavierStokesMono(fluid, (bc_ux, bc_uy), PinPressureGauge(),
                              pt.Dirichlet(0.0), wall_row="ghost")
    return SimpleNamespace(solver=solver,
                           force_scale=0.5 * rho * Ubar ** 2 * D)


def main():
    coarse = "--coarse" in _sys.argv
    fine = "--fine" in _sys.argv
    nx, ny = (128, 64) if coarse else ((512, 256) if fine else (256, 128))
    dt, T_end, t_stats = 0.002, 8.0, 4.0
    if fine:
        dt = 0.001  # rim CFL at the finer grid

    case = dfg_case(nx, ny)
    solver = case.solver
    # control-volume (momentum-deficit) force on grid lines ~6 cells off the
    # rim: the rim traction integral carries the O(h) cut-placement bias
    # (+14% on Cl_amp at this grid); F_cv(t) = Fs(t) - dM/dt in post
    cvf = solver.make_control_volume_recorder((0.10, 0.32, 0.08, 0.32))
    # O(h²) least-squares pressure probe AT the DFG surface points
    # A = (0.15, 0.2) (front) and B = (0.25, 0.2) (back) (the
    # nearest-centroid probe reads up to ~h off a stagnation point: -1.1%
    # on the steady 2D-1 dP, measured)
    probe_lsq = solver.make_pressure_probe([(0.15, 0.2), (0.25, 0.2)])

    def record(x):
        fx, fy = solver.interface_force_traced(x)
        pAB = probe_lsq(x)
        Fsx, Fsy, Mx, My = cvf(x)
        # force ON the body; physical front-minus-back pressure drop pA - pB
        return (-fx, -fy, pAB[0] - pAB[1], Fsx, Fsy, Mx, My)

    t0 = time.time()
    # Time integrator: implicit-Picard CN convection (2 sweeps) with
    # FLEXIBLE GMRES + the DCT-Poisson/CG Schur preconditioner at BOTH
    # resolutions.  The AB2 explicit path is rim-CFL-unstable at 256x128,
    # and at 128x64 it NaN'd once the walls moved to the exact geometry +
    # tolerance-respecting inner solves (the old run survived on the
    # oversolved fixed-depth GMRES cycles); the Chebyshev-Schur pgmres
    # variant additionally mistunes its power-iteration bounds on this
    # channel.  Chunked: short warm-started chunks reuse one compiled scan
    # and keep each device-side scan short.
    chunk_steps = 500 if coarse else (50 if fine else 100)
    n_steps = int(round(T_end / dt))
    logs, kits, rels = [], [], []
    x = None
    for k0 in range(0, n_steps, chunk_steps):
        t0_c = k0 * dt
        t1_c = min(n_steps, k0 + chunk_steps) * dt
        x = solver.solve_unsteady_picard(
            dt, t1_c, scheme="CN", picard_iters=2, method="fgmres",
            tol=1e-6, maxiter=120, record=record, x0=x, t_start=t0_c)
        logs.append(solver.record_log)
        kits.append(np.asarray(solver.krylov_iters))
        rels.append(np.asarray(solver.krylov_relres))
    wall = time.time() - t0
    Fx, Fy, dP, Fsx, Fsy, Mx, My = (
        np.concatenate([lg[i] for lg in logs]) for i in range(7))
    times = (np.arange(n_steps) + 1) * dt
    kit = np.concatenate(kits)
    rel = np.concatenate(rels)
    print(f"{nx}x{ny}, {n_steps} steps: {wall:.1f} s wall "
          f"({wall / n_steps * 1e3:.1f} ms/step incl compile), "
          f"GMRES {kit.mean():.1f} it/step (max {kit.max()}), "
          f"relres max {rel.max():.1e}")

    scale = case.force_scale
    # control-volume force: F(t) = Fs(t) - dM/dt (box momentum content
    # differenced in time; np.gradient = central differences)
    Fx_cv = Fsx - np.gradient(Mx, dt)
    Fy_cv = Fsy - np.gradient(My, dt)
    Cd_rim = Fx / scale
    Cl_rim = Fy / scale
    Cd = Fx_cv / scale
    Cl = Fy_cv / scale
    w = times >= t_stats
    Cd_mean = float(np.mean(Cd[w]))
    Cl_mean = float(np.mean(Cl[w]))
    Cl_amp = float(np.max(Cl[w]) - np.min(Cl[w])) / 2
    dP_mean = float(np.mean(dP[w]))
    Cd_rim_mean = float(np.mean(Cd_rim[w]))
    Cl_rim_amp = float(np.max(Cl_rim[w]) - np.min(Cl_rim[w])) / 2
    print(f"rim-integral Cd_mean = {Cd_rim_mean:.4f}  Cl_amp = "
          f"{Cl_rim_amp:.4f}  (O(h) cut-rim traction, for the record)")

    sig = Cl[w] - np.mean(Cl[w])
    spec = np.abs(np.fft.rfft(sig))
    freqs = np.fft.rfftfreq(sig.size, d=dt)
    f_shed = float(freqs[1:][np.argmax(spec[1:])])
    St = f_shed * D / Ubar

    print(f"Cd_mean = {Cd_mean:.4f}   (DFG 2D-2: 3.22-3.24)")
    print(f"Cl_mean = {Cl_mean:+.4f}  (gate |.| < 0.08)")
    print(f"Cl_amp  = {Cl_amp:.4f}   (DFG: ~1.0)")
    print(f"St      = {St:.4f}     (DFG: 0.295-0.305)")
    print(f"dP_mean = {dP_mean:.4f}  (DFG: ~2.48)")

    shedding = Cl_amp > 0.05
    print(f"shedding developed: {shedding}")
    if coarse:
        # 128x64 with the moment cut flux (measured Cd 3.2365, St 0.2999):
        # tightened from the reference's own 3.1-3.6 / 0.28-0.33 windows
        assert shedding
        assert 3.15 < Cd_mean < 3.35, Cd_mean
        assert abs(Cl_mean) < 0.08, Cl_mean
        assert 0.29 < St < 0.31, St
    elif fine:
        # 512x256, dt=1e-3: sanity gates only until a measured record exists
        assert shedding
        assert 3.1 < Cd_mean < 3.4, Cd_mean
        assert abs(Cl_mean) < 0.08, Cl_mean
        assert 0.29 < St < 0.31, St
    else:
        # 256x128 moment cut flux (measured Cd 3.2819, dP 2.4749, Cl_amp
        # 1.1371): Cd/dP tightened toward the published 3.22-3.24 / 2.48;
        # Cl_amp stays a wide honesty gate (+14% above the published ~1.0 —
        # the remaining known gap, see docs/benchmarks/dfg_cylinder.md)
        assert shedding
        assert 3.18 < Cd_mean < 3.35, Cd_mean
        assert abs(Cl_mean) < 0.08, Cl_mean
        assert 0.29 < St < 0.31, St
        assert abs(dP_mean - 2.48) < 0.03, dP_mean
        assert 0.95 < Cl_amp < 1.25, Cl_amp
    print("OK")


if __name__ == "__main__":
    main()
