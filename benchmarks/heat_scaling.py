"""Cut-cell BE heat step scaling sweep (reference benchmark/
BenchmarkHeatSol.jl + Heat.jl): ms/step and CG iterations vs grid size on
one GPU, embedded circle, f32, dt = 0.25 h² — writes heat_scaling.csv.

Run:  python benchmarks/heat_scaling.py [max_n]     (needs a GPU)
"""

import sys as _sys, os as _os
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import csv

import jax.numpy as jnp

from bench import heat_case, per_step
from benchmarks._timing import card_info, require_gpu


def sweep(sizes, ndim, out_name):
    """ms/step over each n in ``sizes`` (grid n^ndim), one CSV row each."""
    require_gpu()
    card = card_info()
    rows = []
    for n in sizes:
        case = heat_case((n,) * ndim, jnp.float32, 0.25, cg_tol=1e-6,
                         cg_maxiter=32)
        ms, it_last, it_max = per_step(case.fast, case.T0, 100)
        rows.append((n, ms, it_last, it_max))
        print(f"n={n}^{ndim}: {ms!r} ms/step (CG iters/step last {it_last} "
              f"max {it_max}); {card}", flush=True)
        del case
    out = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                        out_name)
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["n", "ms_per_step", "cg_iters_last", "cg_iters_max"])
        w.writerows(rows)
    print(f"wrote {out} ({card})")


if __name__ == "__main__":
    max_n = int(_sys.argv[1]) if len(_sys.argv) > 1 else 4096
    sweep([n for n in (256, 512, 1024, 2048, 4096) if n <= max_n], 2,
          "heat_scaling.csv")
