"""Heat-step benchmark: 1024² unsteady cut-cell heat (BE, embedded circle)
ms/step on one GPU.  Target from BASELINE.md: < 10 ms/step.

Prints exactly one JSON line:
  {"metric": ..., "value": N, "unit": "ms", "vs_baseline": N,
   "device": {"platform", "kind", "count"}, "card": "<name>, <power limit>"}
``vs_baseline`` = value / 10.0 (fraction of the target budget; < 1 beats it).

Stderr carries the rows the JSON omits: CG iterations per step at the
easy dt (0.25 h²: the BE system is near-identity and the warm-started CG
converges in a few iterations) and the STIFF row at dt = 100 h² (where an
implicit cut-cell solver earns its keep: ~400x worse conditioning), with
its own ms/step and iteration counts.

Run:  python bench.py            (needs a GPU; stops without one)
"""

import json
import sys
from types import SimpleNamespace

import jax.numpy as jnp


def heat_case(shape, dtype, dt_h2, cg_tol=1e-6, cg_maxiter=600):
    """``FastHeatBE`` on the embedded body in a box of side 4: a circle of
    radius 1 (2D) or a sphere of radius 1.5 (3D), T = 1 on the body, T = 0
    on the walls, no source, dt = ``dt_h2`` · h².  Returns a namespace with
    the stepper ``fast``, the zero field ``T0``, the capacity build seconds
    ``t_cap`` and the pieces a general solver needs (``cap``, ``ops``,
    ``bc_b``, ``bc_i``, ``source``, ``dt``)."""
    import penguin_tpu as pt
    from penguin_tpu.solvers.heat_fast import FastHeatBE
    from benchmarks._timing import timed

    ndim = len(shape)
    L = 4.0
    mesh = pt.Mesh(shape, (L,) * ndim, (0.0,) * ndim)
    body = (pt.geometry.circle((2.0, 2.0), 1.0) if ndim == 2
            else pt.geometry.sphere((2.0, 2.0, 2.0), 1.5))
    cap, t_cap = timed(lambda: pt.compute_capacity(body, mesh, p=4, s=1,
                                                   dtype=dtype))
    ops = pt.make_diffusion_ops(cap)
    walls = ("left", "right", "bottom", "top", "backward", "forward")
    bc_b = pt.BorderConditions({k: pt.Dirichlet(0.0)
                                for k in walls[:2 * ndim]})
    bc_i = pt.Dirichlet(1.0)
    source = lambda x, y, z, t: 0.0
    dt = dt_h2 * (L / shape[0]) ** 2
    fast = FastHeatBE(cap, ops, 1.0, source, bc_i, bc_b, dt, cg_tol=cg_tol,
                      cg_maxiter=cg_maxiter, dtype=dtype)
    return SimpleNamespace(fast=fast, T0=jnp.zeros(mesh.np_shape, dtype),
                           t_cap=t_cap, cap=cap, ops=ops, bc_b=bc_b,
                           bc_i=bc_i, source=source, dt=dt)


def per_step(fast, T, n):
    """(ms/step over an ``n``-step run, CG iterations last and max)."""
    from benchmarks._timing import best_seconds

    T, it_last, it_max = fast.run_telemetry(T, 5)  # compile + settle
    s = best_seconds(fast.run, T, n)
    _, it_last, it_max = fast.run_telemetry(T, n)
    return s / n * 1e3, int(it_last), int(it_max)


def main():
    from benchmarks._timing import card_info, require_gpu

    device = require_gpu()
    card = card_info()
    case = heat_case((1024, 1024), jnp.float32, 0.25, cg_tol=1e-5,
                     cg_maxiter=24)
    ms, it_last, it_max = per_step(case.fast, case.T0, 400)
    print(json.dumps({
        "metric": "2d_heat_1024sq_BE_ms_per_step",
        "value": ms,
        "unit": "ms",
        "vs_baseline": ms / 10.0,
        "device": device,
        "card": card,
    }))
    print(f"# capacity build (incl. compile): {case.t_cap:.2f}s; card: {card}",
          file=sys.stderr)
    print(f"# easy dt=0.25h^2: {ms:.4f} ms/step, warm-started CG "
          f"iters/step last={it_last} max={it_max} (tol 1e-5)",
          file=sys.stderr)
    case = heat_case((1024, 1024), jnp.float32, 100.0, cg_tol=1e-5,
                     cg_maxiter=600)
    ms_s, it_last_s, it_max_s = per_step(case.fast, case.T0, 100)
    print(f"# stiff dt=100h^2:      {ms_s:.4f} ms/step, CG iters/step "
          f"last={it_last_s} max={it_max_s} (tol 1e-5, maxiter 600)",
          file=sys.stderr)


if __name__ == "__main__":
    main()
