"""Shared harness for the BenchPhaseFlow literature suite.

Port of the reference's convergence-study driver
(/root/reference/BenchPhaseFlow/utils/convergence.jl + the per-problem
run_*_convergence loops): run a case over a mesh-size list, collect the
volume-weighted L2 errors split by cell type, fit log-log orders and write
one CSV per case under benchmarks/phaseflow/results/.
"""

import csv
import os
import sys

import numpy as np


def ensure_cpu_f64():
    """These are f64 accuracy studies of small systems: run them on the
    local CPU backend with 64-bit types.  jax may already be imported, so
    the platform is also set at runtime (as tests/conftest.py does)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("JAX_ENABLE_X64", "1")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def fit_order(h, err):
    """Least-squares log-log slope over points with positive error."""
    h = np.asarray(h, float)
    err = np.asarray(err, float)
    m = err > 0
    if m.sum() < 2:
        return float("nan")
    return float(np.polyfit(np.log(h[m]), np.log(err[m]), 1)[0])


def results_dir():
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")
    os.makedirs(d, exist_ok=True)
    return d


def write_csv(name, rows, header):
    path = os.path.join(results_dir(), f"{name}.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    return path


def convergence_study(name, solve_one, sizes, verbose=True):
    """``solve_one(n) -> (h, dict(all=, full=, cut=, empty=))``.  Returns
    dict with h/err lists and fitted orders.

    Writes the CSV only on verbose (full) runs: the pytest gates re-run
    cases at reduced sizes with ``verbose=False``, and letting them write
    would clobber the recorded full-size result tables."""
    hs, errs = [], {"all": [], "full": [], "cut": [], "empty": []}
    for n in sizes:
        h, e = solve_one(n)
        hs.append(h)
        for k in errs:
            errs[k].append(e.get(k, 0.0))
        if verbose:
            print(f"{name} n={n}: h={h:.4e} L2(all)={e['all']:.4e} "
                  f"full={e['full']:.4e} cut={e['cut']:.4e}")
    orders = {k: fit_order(hs, v) for k, v in errs.items()}
    if verbose:
        print(f"{name} orders: all={orders['all']:.2f} "
              f"full={orders['full']:.2f} cut={orders['cut']:.2f}")
    if verbose:
        rows = [(n, hs[i], errs["all"][i], errs["full"][i], errs["cut"][i])
                for i, n in enumerate(sizes)]
        write_csv(name, rows, ["n", "h", "err_all", "err_full", "err_cut"])
    return {"h": hs, "err": errs, "orders": orders, "sizes": list(sizes)}
