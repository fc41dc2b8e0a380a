"""Structured diagnostics: timers, optional step logging, profiler traces.

The reference's observability is ``println`` scattered through solver loops
plus per-iteration PNG dumps (SURVEY §5: diffusion.jl:279,297,
navierstokes.jl:1410,1463, stefan.jl:845-859).  Here:

- ``timed(name)`` — context manager timing a block with
  ``block_until_ready`` semantics on an optional result array, recording
  into a global registry (``report()`` prints a table).
- ``trace(name, dir)`` — context manager wrapping ``jax.profiler`` so a
  solver run produces a TensorBoard-loadable device trace.
- ``log_every(k)`` — throttled logger for time loops driven from Python.
- ``KrylovHistory`` — mirrors the reference's ``Solver.ch`` convergence
  histories (solver.jl:136-139,176-180): wrap a matvec to count
  applications and record residual norms of an iterative solve without
  touching the jitted path (host callbacks are deliberately avoided; the
  history is reconstructed from returned residuals).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import jax

__all__ = ["timed", "report", "reset", "trace", "log_every",
           "KrylovHistory", "convergence_rates"]

_REGISTRY: dict = {}


@contextlib.contextmanager
def timed(name, sync=None):
    """Time a block; ``sync`` (optional array/pytree) is block_until_ready'd
    before the clock stops so device work is included."""
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        target = box.get("sync", sync)
        if target is not None:
            jax.tree_util.tree_map(
                lambda a: a.block_until_ready()
                if hasattr(a, "block_until_ready") else a, target)
        el = time.perf_counter() - t0
        rec = _REGISTRY.setdefault(name, {"n": 0, "total": 0.0, "max": 0.0})
        rec["n"] += 1
        rec["total"] += el
        rec["max"] = max(rec["max"], el)


def report(print_fn=print):
    """Print the timing table and return it as a dict."""
    out = {}
    for name, rec in sorted(_REGISTRY.items()):
        mean = rec["total"] / max(rec["n"], 1)
        out[name] = {"n": rec["n"], "total_s": rec["total"],
                     "mean_s": mean, "max_s": rec["max"]}
        print_fn(f"{name:40s} n={rec['n']:6d} total={rec['total']:9.3f}s "
                 f"mean={mean * 1e3:9.3f}ms max={rec['max'] * 1e3:9.3f}ms")
    return out


def reset():
    _REGISTRY.clear()


@contextlib.contextmanager
def trace(name="penguin", log_dir="/tmp/penguin_trace"):
    """jax.profiler trace around a block (view with TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        with jax.profiler.TraceAnnotation(name):
            yield log_dir
    finally:
        jax.profiler.stop_trace()


def log_every(k, print_fn=print):
    """Returns ``maybe_log(step, msg_fn)`` printing every k-th call."""
    def maybe_log(step, msg_fn):
        if step % k == 0:
            print_fn(msg_fn())
    return maybe_log


class KrylovHistory:
    """Counts matvec applications and records residual norms around an
    iterative solve — the reference's ``Solver.ch`` (log=true) analogue.

    Usage::

        hist = KrylovHistory(apply_fn)
        x, info = bicgstab(hist, b, ...)
        hist.record_final(b, x)        # appends ||b - Ax|| / ||b||
    """

    def __init__(self, apply_fn):
        self._apply = apply_fn
        self.n_matvec = 0
        self.residuals = []

    def __call__(self, x):
        self.n_matvec += 1
        return self._apply(x)

    def record_final(self, b, x):
        from jax.flatten_util import ravel_pytree

        r = jax.tree_util.tree_map(lambda bb, ax: bb - ax, b, self._apply(x))
        rn = float(np.linalg.norm(np.asarray(ravel_pytree(r)[0])))
        bn = float(np.linalg.norm(np.asarray(ravel_pytree(b)[0])))
        self.residuals.append(rn / max(bn, 1e-300))
        return self.residuals[-1]


def convergence_rates(residual_hist):
    """Per-timestep log-reduction rate of an inner Newton/GN iteration.

    ``residual_hist``: (n_steps, max_iter) with NaN past convergence (the
    layout ``StefanMono2D.solve`` records).  Returns an (n_steps,) array:
    the least-squares slope of log10(residual) per iteration (negative =
    converging; ~ -1 means 10x reduction per iteration).  Steps that
    converged within one iteration return 0.0.
    """
    H = np.asarray(residual_hist, float)
    out = np.zeros(H.shape[0])
    for k in range(H.shape[0]):
        row = H[k]
        row = row[np.isfinite(row) & (row > 0)]
        if row.size >= 2:
            x = np.arange(row.size)
            out[k] = np.polyfit(x, np.log10(row), 1)[0]
    return out
