"""Run the solver stack once on one GPU at the grid sizes its users run, and
check every result against a plain reference on the same card.

Phases, one printed line each:

  heat2d    FastHeatBE on the embedded circle at 4096², stiff dt = 100 h²,
            20 steps: f32 against the same steps in f64 (max|ΔT| <= 5e-4
            on the cells both solve for; the cells active in one run only
            are at most 1e-3 of the cut cells and hold at most 1e-5 of a
            cell's volume)
  heat3d    the same on a sphere at 256³
  collapse  the f64 stencil-collapsed stepper (cg_tol 1e-12) against the
            general masked block solver DiffusionUnsteadyMono (f64, Krylov
            tol 1e-12) at 256², 8 BE steps (<= 1e-8 on active cells)
  ns        DFG 2D-2 at 256x128, implicit-Picard CN + fgmres/DCT-Schur,
            50 steps: every fgmres relres <= 2e-4, fields finite, and the
            last step's Cd and Cl within 1e-3 of the f64 run (relative to
            the f64 drag; Cl is near zero this early in the run)
  stefan    Frank disk at 256² with 256 markers, intercept Jacobian, 20
            steps: markers finite, front radius within 10% of the
            analytic radius

Each line gives the set-up seconds (capacity build, compilation and the
first run), the steady ms/step (host clock around a second, warm run that
ends in block_until_ready), the device's peak bytes in use so far, the
Krylov iterations and each comparison error beside its bound.  The card's
name and power limit come first; the last line is a JSON object naming the
device.  A phase that raises, or an error over its bound, exits nonzero;
without a GPU the script stops before any phase.

Run:  python chip_smoke.py          one GPU, every phase
      python chip_smoke.py --multi  four GPUs: the sharded heat step at
                                    4096² and the sharded Picard NS step at
                                    256x128, each against its one-card run
"""

import argparse
import json
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

import penguin_tpu as pt
from bench import heat_case
from benchmarks._timing import card_info, require_gpu, timed
from benchmarks.dfg_cylinder_shedding import dfg_case
from benchmarks.stefan2d_frank import NEWTON, frank_disk, run as run_frank
from penguin_tpu.solvers import DiffusionUnsteadyMono

F32, F64 = jnp.float32, jnp.float64


class Check(NamedTuple):
    label: str
    value: float
    bound: float | None  # None: reported, not gated

    def ok(self):
        return self.bound is None or self.value <= self.bound

    def __str__(self):
        if self.bound is None:
            return f"{self.label} {self.value!r}"
        verdict = "ok" if self.ok() else "FAILED"
        return f"{self.label} {self.value!r} <= {self.bound!r} {verdict}"


class Phase(NamedTuple):
    name: str
    setup_s: float
    ms_per_step: float | None
    krylov: str
    checks: list

    def ok(self):
        return all(c.ok() for c in self.checks)

    def line(self):
        stats = jax.devices()[0].memory_stats() or {}
        peak = stats.get("peak_bytes_in_use", "n/a")
        ms = "n/a" if self.ms_per_step is None else repr(self.ms_per_step)
        parts = [f"{self.name}: setup {self.setup_s!r} s", f"{ms} ms/step",
                 f"peak_bytes_in_use {peak}", self.krylov]
        return " | ".join(parts + [str(c) for c in self.checks])


class _HeatRun(NamedTuple):
    T: np.ndarray
    active: np.ndarray
    vfrac: np.ndarray  # fluid volume / cell volume
    n_cut: int
    setup_s: float
    ms_per_step: float
    cg: tuple  # CG iterations per step: last, max


def _heat_run(shape, dtype, steps):
    """``steps`` stiff BE steps of ``FastHeatBE`` in ``dtype``."""
    case = heat_case(shape, dtype, 100.0, cg_tol=1e-6, cg_maxiter=600)
    _, t_first = timed(case.fast.run_telemetry, case.T0, steps)
    (T, last, mx), t_run = timed(case.fast.run_telemetry, case.T0, steps)
    vfrac = np.asarray(case.cap.V, np.float64) / np.prod(case.cap.mesh.h)
    return _HeatRun(np.asarray(T, np.float64), np.asarray(case.fast.active),
                    vfrac, int((np.asarray(case.cap.Gamma) > 0).sum()),
                    case.t_cap + t_first, t_run / steps * 1e3,
                    (int(last), int(mx)))


def phase_heat(shape, steps=20):
    """f32 ``FastHeatBE`` against the same steps in f64, on the cells both
    runs solve for.  A cut cell active in one dtype only is an identity row
    in the other: such cells must be few and nearly empty."""
    r32 = _heat_run(shape, F32, steps)
    with jax.enable_x64(True):
        r64 = _heat_run(shape, F64, steps)
    both = r32.active & r64.active
    one = r32.active != r64.active
    vfrac_one = np.maximum(r32.vfrac, r64.vfrac)[one]
    checks = [
        Check("max|T32-T64|", float(np.abs(r32.T - r64.T)[both].max()), 5e-4),
        Check("cells active in one run only / cut cells",
              int(one.sum()) / r64.n_cut, 1e-3),
        Check("their max volume fraction",
              float(vfrac_one.max()) if one.any() else 0.0, 1e-5),
    ]
    name = f"heat{len(shape)}d {'x'.join(map(str, shape))} f32"
    return Phase(name, r32.setup_s, r32.ms_per_step,
                 f"CG it/step last {r32.cg[0]} max {r32.cg[1]}", checks)


def phase_collapse(n=256, steps=8):
    """f64 stencil-collapsed stepper against the general masked block
    solver: the same BE steps, Krylov tolerance 1e-12 on both."""
    with jax.enable_x64(True):
        case = heat_case((n, n), F64, 0.25, cg_tol=1e-12, cg_maxiter=2000)
        phase = pt.Phase(case.cap, case.ops, case.source, 1.0)
        z = case.T0
        general = DiffusionUnsteadyMono(phase, case.bc_b, case.bc_i, case.dt,
                                        (z, z), "BE")
        # the initial solve plus ceil(steps - 1.5) further steps: ``steps``
        # BE applications in all
        general.solve((steps - 1.5) * case.dt, method="bicgstab", tol=1e-12,
                      keep_states=False)
        ref = np.asarray(general.x_omega)
        _, t_first = timed(case.fast.run_telemetry, z, steps)
        (T, last, mx), t_run = timed(case.fast.run_telemetry, z, steps)
        active = np.asarray(case.fast.active)
        err = float(np.abs(np.asarray(T)[active] - ref[active]).max())
    return Phase(f"collapse {n}x{n} f64", case.t_cap + t_first,
                 t_run / steps * 1e3,
                 f"CG it/step last {int(last)} max {int(mx)}",
                 [Check("max|T_stencil-T_general|", err, 1e-8)])


def _ns_run(nx, ny, steps, dt, dtype):
    case = dfg_case(nx, ny, dtype)
    solver = case.solver

    def record(x):
        fx, fy = solver.interface_force_traced(x)
        return -fx / case.force_scale, -fy / case.force_scale

    def go():
        return solver.solve_unsteady_picard(
            dt, steps * dt, scheme="CN", picard_iters=2, method="fgmres",
            tol=1e-6, maxiter=120, record=record)

    _, t_first = timed(go)
    x, t_run = timed(go)
    cd, cl = (float(np.asarray(v)[-1]) for v in solver.record_log)
    return dict(setup=t_first, ms=t_run / steps * 1e3, cd=cd, cl=cl,
                its=np.asarray(solver.krylov_iters),
                relres=float(np.asarray(solver.krylov_relres).max()),
                finite=all(bool(jnp.isfinite(a).all()) for a in x))


def phase_ns(nx=256, ny=128, steps=50, dt=0.002):
    """DFG 2D-2, f32, against the same steps in f64."""
    r = _ns_run(nx, ny, steps, dt, F32)
    with jax.enable_x64(True):
        r64 = _ns_run(nx, ny, steps, dt, F64)
    cd64 = abs(r64["cd"])
    checks = [
        Check("|steps marched-steps|", abs(len(r["its"]) - steps), 0),
        Check("max fgmres relres", r["relres"], 2e-4),
        Check("non-finite fields", float(not r["finite"]), 0.0),
        Check("|Cd32-Cd64|/|Cd64|", abs(r["cd"] - r64["cd"]) / cd64, 1e-3),
        Check("|Cl32-Cl64|/|Cd64|", abs(r["cl"] - r64["cl"]) / cd64, 1e-3),
        Check("Cd", r["cd"], None), Check("Cl", r["cl"], None),
    ]
    krylov = (f"fgmres its of each step's last Picard sweep: mean "
              f"{float(r['its'].mean())!r} max {int(r['its'].max())}")
    return Phase(f"ns dfg2d-2 {nx}x{ny} f32", r["setup"], r["ms"], krylov,
                 checks)


def phase_stefan(n=256, nm=256, steps=20):
    """Frank disk: the front radius against the analytic radius."""
    case = frank_disk(n, nm, F32)
    _, t_first = timed(lambda: run_frank(case, steps))
    (R_end, R_ana), t_run = timed(lambda: run_frank(case, steps))
    s = case.solver
    gn = np.asarray(s.iters_log)
    finite = bool(np.isfinite(np.asarray(s.markers)).all()
                  and np.isfinite(s.residual_log).all())
    checks = [Check("|steps marched-steps|", abs(len(gn) - steps), 0),
              Check("non-finite markers/residuals", float(not finite), 0.0),
              Check("|R/R_analytic-1|", abs(R_end / R_ana - 1), 0.10)]
    max_gn = NEWTON[0]
    krylov = (f"GN its {int(gn.sum())} over {len(gn)} steps, "
              f"{int((gn >= max_gn).sum())} steps at the cap of {max_gn}, "
              f"final GN residual max {float(np.max(s.residual_log))!r} "
              f"(tol {NEWTON[1]!r}) | CG its "
              f"{int(np.asarray(s.krylov_iters).sum())}")
    return Phase(f"stefan frank {n}x{n} {nm} markers f32", t_first,
                 t_run / len(gn) * 1e3, krylov, checks)


def phase_multi(n_devices=4, heat_grid=(4096, 4096), ns_grid=(256, 128)):
    """The sharded heat step and the sharded Picard NS step over a 2x2
    device mesh, each against its one-card run in this process."""
    from penguin_tpu.parallel.sharding import (dryrun_heat_multichip,
                                               dryrun_ns_picard_multichip)

    err_heat, t_heat = timed(
        lambda: dryrun_heat_multichip(n_devices, grid=heat_grid))
    with jax.enable_x64(True):
        ns, t_ns = timed(
            lambda: dryrun_ns_picard_multichip(n_devices, grid=ns_grid))
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", "n/a")
             for d in jax.devices()[:n_devices]]
    checks = [
        Check(f"heat {heat_grid[0]}x{heat_grid[1]} f32 max|sharded-one|",
              err_heat, 1e-5),
        Check(f"ns {ns_grid[0]}x{ns_grid[1]} f64 preconditioner "
              "max|sharded-one|/scale", ns["err_M"], 1e-9),
        Check("ns max fgmres relres", ns["relres"], 1e-6),
        Check("ns grid-sized all-gathers", float(ns["gathers"]), 4.0),
    ]
    return Phase(f"multi {n_devices} devices (peak bytes per device "
                 f"{peaks})", t_heat + t_ns, None,
                 "Krylov: see sharding.py dryruns", checks)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true")
    args = ap.parse_args(argv)

    device = require_gpu(4 if args.multi else 1)
    print(card_info(), flush=True)
    phases = [lambda: phase_multi(4)] if args.multi else [
        lambda: phase_heat((4096, 4096)),
        lambda: phase_heat((256, 256, 256)),
        phase_collapse, phase_ns, phase_stefan,
    ]
    results = []
    for phase in phases:
        results.append(phase())
        print(results[-1].line(), flush=True)
    failed = [r.name for r in results if not r.ok()]
    if failed:
        raise SystemExit(f"chip_smoke: over its bound in {failed}")
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
