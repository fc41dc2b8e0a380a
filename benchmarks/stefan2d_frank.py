"""2D front-tracking Stefan step timing on the Frank disk (the flagship
moving-interface configuration, f32): measures ms per GN iteration — a
full slab geometry rebuild + temperature solve + volume Jacobian + LM
update — and gates the front radius against the analytic Frank solution.

Run:  python benchmarks/stefan2d_frank.py        (64², both Jacobians; 128², 256²)
      python benchmarks/stefan2d_frank.py 512    (512² with 512 markers)
"""

import sys as _sys, os as _os
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import time
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
from scipy.special import exp1

import penguin_tpu as pt
from penguin_tpu.front_tracking import FrontTracker
from penguin_tpu.solvers.stefan2d import StefanMono2D

NEWTON = (8, 1e-4, 1e-6, 1.0)


def frank_disk(n, nm, dtype=jnp.float32):
    """Frank-disk Stefan problem (S = 1) on an ``n`` x ``n`` grid with
    ``nm`` front markers, started from the similarity solution at t0 = 1."""
    S = 1.0
    St = (S**2 / 4) * np.exp(S**2 / 4) * exp1(S**2 / 4)
    T_inf = -St
    L, center = 8.0, (4.0, 4.0)
    mesh = pt.Mesh((n, n), (L, L), (0.0, 0.0))
    # keep the front displacement per step below ~a cell: at dt=0.02 the
    # Frank front (v ≈ S/2√t ≈ 0.5) moves ~0.01 per step — more than one
    # cell once h < 0.01 (n ≥ 512 at L=8), which the 8-iteration GN budget
    # cannot converge (measured at 1024²: the front lags 11% while every
    # per-iteration timing looks healthy).  Timing is per GN iteration, so
    # scaling dt down keeps the benchmark honest without changing what is
    # measured.
    t0 = 1.0
    dt = 0.02 * min(1.0, 256.0 / n)
    front = FrontTracker().create_circle(center, S * np.sqrt(t0), n=nm)
    front.markers = front.markers.astype(dtype)
    cap0 = pt.compute_capacity(lambda x, y: -front.sdf(x, y), mesh, p=4, s=1,
                               dtype=dtype)
    C = np.asarray(cap0.C_om)
    r = np.sqrt((C[..., 0] - 4) ** 2 + (C[..., 1] - 4) ** 2)
    s_ = r / np.sqrt(t0)
    Tw0 = jnp.asarray(np.where(
        s_ >= S, T_inf * (1 - exp1(np.maximum(s_**2 / 4, 1e-9)) / exp1(S**2 / 4)),
        0.0), dtype)
    bc_b = pt.BorderConditions({k: pt.Dirichlet(float(T_inf))
                                for k in ("left", "right", "top", "bottom")})
    phase = pt.Phase(cap0, pt.make_diffusion_ops(cap0),
                     lambda x, y, z, t: 0.0, 1.0)
    ic = pt.InterfaceConditions(pt.ScalarJump(1.0, 1.0, 0.0),
                                pt.FluxJump(1.0, 1.0, 1.0))
    solver = StefanMono2D(phase, bc_b, pt.Dirichlet(0.0), dt,
                          (Tw0, jnp.zeros(mesh.np_shape, dtype)), mesh, "BE")
    return SimpleNamespace(solver=solver, front=front, ic=ic, dt=dt,
                           markers0=front.markers, center=center, S=S, t0=t0)


def run(case, n_steps, jac="intercept"):
    """March ``n_steps`` from the initial front (reset first, so repeated
    calls run the identical problem and reuse the solver's compiled loop).
    Returns (front radius, analytic radius)."""
    case.front.markers = case.markers0
    # the solver marches round(t_end / dt) + 1 steps
    case.solver.solve(case.front, 0.0, (n_steps - 1) * case.dt, case.ic,
                      newton_params=NEWTON, interior_fluid=False,
                      method="auto", jac=jac, p=4, s=1)
    mk = np.asarray(case.solver.markers)
    R_end = float(np.sqrt(((mk - np.asarray(case.center)) ** 2).sum(1)).mean())
    R_ana = float(case.S * np.sqrt(case.t0
                                   + len(case.solver.iters_log) * case.dt))
    return R_end, R_ana


def main(n=64, nm=64, dtype=jnp.float32, jac="autodiff"):
    case = frank_disk(n, nm, dtype)
    solver = case.solver
    t0w = time.time()
    run(case, 1, jac)
    wall = time.time() - t0w
    iters = int(solver.iters_log.sum())
    print(f"[jac={jac}] grid {n}x{n}, {nm} markers, "
          f"{len(solver.iters_log)} steps, {iters} GN iterations")
    print(f"total {wall:.2f}s (incl. trace + compile)")
    # steady-state timing: warm + timed calls run the IDENTICAL problem
    # (front reset between calls) so the second call hits the solver's
    # compiled-loop cache.  (Letting the front evolve between calls can
    # bump the auto band budget across a power-of-two boundary and
    # silently charge a full re-trace to the timed call.)
    n_steps = 20
    run(case, n_steps, jac)
    t0w = time.time()
    R_end, R_ana = run(case, n_steps, jac)
    wall = time.time() - t0w
    iters = int(solver.iters_log.sum())
    klv = int(np.asarray(solver.krylov_iters).sum())
    print(f"{n_steps}-step run (steady state): {wall:.2f}s wall, "
          f"{iters} GN iterations -> {wall / max(iters, 1) * 1e3:.1f} ms/GN, "
          f"{klv} total CG iters ({klv / max(iters, 1):.0f}/GN)")
    # correctness gate, not just timing: the f32 GN must actually advance
    # the Frank disk (a round-3 regression froze it via NaN'd volume-
    # Jacobian tangents while the timing numbers looked perfectly healthy).
    # The gate is HARD for jac="intercept" (the exact analytic Jacobian,
    # the production path).  The f32 AUTODIFF Jacobian is marginally
    # conditioned (ARCHITECTURE.md round-3 f32 campaign: roundoff-level
    # input perturbations flip melt/regrow tangents) and its convergence
    # is HOST-DEPENDENT — on some environments the GN bounces at residual
    # ~0.1 or NaNs while the same problem converges under intercept — so
    # that leg gates only marker sanity and is reported as timing.
    print(f"front radius {R_end:.4f} vs analytic {R_ana:.4f} "
          f"({(R_end / R_ana - 1) * 100:+.1f}%)")
    assert np.isfinite(np.asarray(solver.markers)).all(), \
        "markers went non-finite"
    if jac == "intercept":
        assert np.isfinite(np.asarray(solver.residual_log)).all(), \
            "GN residuals went non-finite"
        assert abs(R_end / R_ana - 1) < 0.10, (R_end, R_ana)
    elif not (np.isfinite(np.asarray(solver.residual_log)).all()
              and abs(R_end / R_ana - 1) < 0.10):
        print("WARNING: f32 autodiff-Jacobian leg did not converge on "
              "this host (known marginality; correctness is gated on "
              "the intercept leg)")


if __name__ == "__main__":
    if len(_sys.argv) > 1:
        n = int(_sys.argv[1])
        main(n=n, nm=n, jac="intercept")
    else:
        main(jac="autodiff")
        main(jac="intercept")
        for n in (128, 256):
            main(n=n, nm=n, jac="intercept")
