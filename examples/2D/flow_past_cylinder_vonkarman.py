"""Von Karman vortex street behind a circular cylinder at Re=150
(reference examples/2D/NavierStokes/flow_past_circle_vonkarman.jl:1-60).

Channel 6 x 2 with a cylinder of radius 0.2 at (0, 0) (domain origin
(-1,-1)), parabolic inflow, Re = 150 based on the diameter.  The cylinder
sits slightly below the channel axis via the grid offset, which seeds the
asymmetry; natural periodic shedding develops and the lift-coefficient FFT
gives the Strouhal number.  Unconfined Re=150 sheds at St ~ 0.18; the 20%
blockage plus parabolic inflow raises it to ~0.30, matching the DFG
confined-cylinder benchmark at the same blockage
(benchmarks/dfg_cylinder_shedding.py: St 0.295-0.305).
Measured (f32): Cd_mean 3.06, Cl_amp 1.54, St 0.300.

The reference drives shedding with a modulated inflow and post-processes a
stored state history on the host; here the inflow is steady, the lift/drag
are recorded inside the jitted scan (one scalar triple per step, no state
history materialized), and the run is chunked to reuse one compiled scan.

Run (on the GPU):  python examples/2D/flow_past_cylinder_vonkarman.py
"""

import sys as _sys, os as _os
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))))

import time

import numpy as np
import jax.numpy as jnp

import penguin_tpu as pt
from penguin_tpu.solvers.navierstokes import NavierStokesMono
from penguin_tpu.solvers.stokes import PinPressureGauge

nx, ny = 256, 96
Lx, Ly = 6.0, 2.0
x0, y0 = -1.0, -1.0
R, cx, cy = 0.2, 0.0, 0.0
D = 2 * R
Umax = 1.5
Ubar = Umax * 2.0 / 3.0
rho = 1.0
Re = 150.0
mu = rho * Ubar * D / Re
dt, T_end, t_stats = 0.005, 24.0, 12.0
T_ramp = 1.0

dx = Lx / nx
dy = Ly / ny
mesh_p = pt.Mesh((nx, ny), (Lx, Ly), (x0, y0))
mesh_ux = pt.Mesh((nx, ny), (Lx, Ly), (x0 - 0.5 * dx, y0))
mesh_uy = pt.Mesh((nx, ny), (Lx, Ly), (x0, y0 - 0.5 * dy))
body = pt.geometry.complement(pt.geometry.circle((cx, cy), R))
caps = [pt.compute_capacity(body, m, p=4, s=1, dtype=jnp.float32)
        for m in (mesh_ux, mesh_uy, mesh_p)]
fluid = pt.Fluid(
    mesh_u=(mesh_ux, mesh_uy), mesh_p=mesh_p,
    capacity_u=(caps[0], caps[1]),
    operator_u=(pt.make_diffusion_ops(caps[0]), pt.make_diffusion_ops(caps[1])),
    capacity_p=caps[2], operator_p=pt.make_diffusion_ops(caps[2]),
    mu=mu, rho=rho,
    f_u=lambda x, y, z: 0.0, f_p=lambda x, y, z: 0.0,
)


def inflow(x, y, z=0.0, t=None):
    xi = (y - y0) / Ly
    prof = Umax * 4.0 * xi * (1.0 - xi)
    if t is None:
        return prof
    ramp = jnp.where(t >= T_ramp, 1.0,
                     0.5 * (1.0 - jnp.cos(jnp.pi * t / T_ramp)))
    return ramp * prof


noslip = pt.Dirichlet(0.0)
bc_ux = pt.BorderConditions({"left": pt.Dirichlet(inflow),
                             "right": pt.Outflow(),
                             "bottom": noslip, "top": noslip})
bc_uy = pt.BorderConditions({"left": noslip, "right": noslip,
                             "bottom": noslip, "top": noslip})
solver = NavierStokesMono(fluid, (bc_ux, bc_uy), PinPressureGauge(),
                          pt.Dirichlet(0.0))


def record(x):
    fx, fy = solver.interface_force_traced(x)
    return (-fx, -fy)  # force ON the body


t0 = time.time()
# implicit-Picard CN + fgmres/DCT-Schur: the pgmres (Chebyshev-Schur)
# path's power-iteration spectrum bounds are f32-fragile on channel
# geometries and stall host-dependently (observed here and on the
# 256x128 DFG run — the AB2 CFL is also marginal at this grid)
chunk_steps = 300
n_steps = int(round(T_end / dt))
logs = []
x = None
for k0 in range(0, n_steps, chunk_steps):
    t1_c = min(n_steps, k0 + chunk_steps) * dt
    x = solver.solve_unsteady_picard(
        dt, t1_c, scheme="CN", picard_iters=2, method="fgmres",
        tol=1e-6, maxiter=120, record=record, x0=x, t_start=k0 * dt)
    logs.append(solver.record_log)
wall = time.time() - t0
Fx, Fy = (np.concatenate([lg[i] for lg in logs]) for i in range(2))
times = (np.arange(n_steps) + 1) * dt
print(f"{nx}x{ny}, {n_steps} steps: {wall:.1f} s wall "
      f"({wall / n_steps * 1e3:.1f} ms/step incl compile)")

scale = 0.5 * rho * Ubar**2 * D
Cd = Fx / scale
Cl = Fy / scale
w = times >= t_stats
Cl_amp = float(np.max(Cl[w]) - np.min(Cl[w])) / 2
Cd_mean = float(np.mean(Cd[w]))

sig = Cl[w] - np.mean(Cl[w])
spec = np.abs(np.fft.rfft(sig))
freqs = np.fft.rfftfreq(sig.size, d=dt)
f_shed = float(freqs[1:][np.argmax(spec[1:])])
St = f_shed * D / Ubar

print(f"Cd_mean = {Cd_mean:.3f}  Cl_amp = {Cl_amp:.3f}  St = {St:.3f} "
      f"(von Karman street; ~0.30 at this 20% blockage, cf. DFG)")
assert np.isfinite(Cd).all() and np.isfinite(Cl).all()
assert Cl_amp > 0.05, f"no shedding developed: Cl_amp={Cl_amp}"
assert 0.12 < St < 0.32, St
assert 0.8 < Cd_mean < 4.0, Cd_mean
print("von Karman vortex street OK")
