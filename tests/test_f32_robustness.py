"""f32 (production precision) robustness regressions.

The accelerator runs the production path in float32.  Three failure modes were
found and fixed in round 3 — each silently broke the flagship Stefan
front-tracking GN loop in f32 while every f64 test stayed green:

1. ``polyline_sdf`` padded its segment blocks with 1e30 coordinates:
   dist^2 overflowed f32 to inf and the min-reduction JVP NaN'd.
2. Its projection guard ``maximum(ab2, 1e-30)``: the division JVP forms
   x*dy/(y*y) and (1e-30)^2 underflows f32 to 0 -> 0/0 NaN tangents for
   EVERY query point (the LM NaN-guard then zeroed every GN step).
3. ``linsolve`` breakdown fallbacks used 1e-300 literals (= 0.0 in f32)
   and honored unreachable tolerances, iterating f32 Krylov into NaN.

These tests pin all three in pure-f32 arithmetic.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import penguin_tpu as pt
from penguin_tpu.front_tracking import (FrontTracker, polyline_normals,
                                        polyline_sdf)


def test_polyline_sdf_jacfwd_finite_f32():
    front = FrontTracker().create_circle((4.0, 4.0), 1.0, n=48)
    mk = jnp.asarray(front.markers, jnp.float32)
    normals = polyline_normals(mk).astype(jnp.float32)
    # chunk=32 pads 48 segments with 16 far segments — the failing config
    q = jnp.asarray(2.8, jnp.float32)

    def f(d):
        return polyline_sdf(mk + d[:, None] * normals, q, q, chunk=32)

    J = jax.jacfwd(f)(jnp.zeros(48, jnp.float32))
    assert J.dtype == jnp.float32
    assert bool(jnp.isfinite(J).all()), J
    assert float(jnp.abs(J).max()) > 0.0  # and not silently zero


def test_polyline_sdf_grid_jacfwd_finite_f32():
    front = FrontTracker().create_circle((4.0, 4.0), 1.0, n=48)
    mk = jnp.asarray(front.markers, jnp.float32)
    normals = polyline_normals(mk).astype(jnp.float32)
    xs = jnp.linspace(2.5, 5.5, 24, dtype=jnp.float32)
    X, Y = jnp.meshgrid(xs, xs)

    def f(d):
        return polyline_sdf(mk + d[:, None] * normals, X, Y).ravel()

    J = jax.jacfwd(f)(jnp.zeros(48, jnp.float32))
    assert bool(jnp.isfinite(J).all())
    # markers on the circle must influence nearby cells
    assert int((jnp.abs(J) > 1e-6).sum()) > 40


@pytest.mark.parametrize("solver_name", ["pcg", "pbicgstab", "pgmres"])
def test_krylov_f32_unreachable_tol_no_nan(solver_name):
    """Asking an f32 Krylov for 1e-14 must return a clean (floored-tol)
    solution, not iterate into breakdown NaNs."""
    from penguin_tpu import linsolve

    rng = np.random.default_rng(0)
    n = 64
    A = np.asarray(rng.normal(size=(n, n)), np.float32)
    A = A @ A.T + n * np.eye(n, dtype=np.float32)
    x_true = np.asarray(rng.normal(size=n), np.float32)
    b = jnp.asarray(A @ x_true)
    Aj = jnp.asarray(A)

    solve = getattr(linsolve, solver_name)
    x, it, relres = solve(lambda v: Aj @ v, b, jnp.zeros(n, jnp.float32),
                          tol=1e-14, maxiter=300)
    assert x.dtype == jnp.float32
    assert bool(jnp.isfinite(x).all())
    err = float(jnp.linalg.norm(x - x_true) / np.linalg.norm(x_true))
    assert err < 1e-4, (err, int(it), float(relres))


_STEFAN_F32_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
import jax
jax.config.update("jax_platforms", "cpu")   # x64 stays OFF: pure f32
import sys
sys.path.insert(0, "@@REPO@@")
import numpy as np, jax.numpy as jnp
from scipy.special import exp1
import penguin_tpu as pt
from penguin_tpu.front_tracking import FrontTracker
from penguin_tpu.solvers.stefan2d import StefanMono2D

S = 1.0
T_inf = -(S**2/4) * np.exp(S**2/4) * exp1(S**2/4)
n = 32
mesh = pt.Mesh((n, n), (8.0, 8.0), (0.0, 0.0))
dt = 0.02
front = FrontTracker().create_circle((4.0, 4.0), 1.0, n=32)
cap0 = pt.compute_capacity(lambda x, y: -front.sdf(x, y), mesh, p=4, s=1)
C = np.asarray(cap0.C_om)
r = np.sqrt((C[..., 0]-4)**2 + (C[..., 1]-4)**2)
Tw0 = jnp.asarray(np.where(r >= S, T_inf*(1 - exp1(np.maximum(r**2/4, 1e-9))
                                          / exp1(S**2/4)), 0.0))
bc_b = pt.BorderConditions({k: pt.Dirichlet(float(T_inf)) for k in
                            ("left", "right", "top", "bottom")})
phase = pt.Phase(cap0, pt.make_diffusion_ops(cap0), lambda x, y, z, t: 0.0, 1.0)
ic = pt.InterfaceConditions(pt.ScalarJump(1.0, 1.0, 0.0),
                            pt.FluxJump(1.0, 1.0, 1.0))
s = StefanMono2D(phase, bc_b, pt.Dirichlet(0.0), dt,
                 (Tw0, jnp.zeros(mesh.np_shape)), mesh, "BE")
s.solve(front, 0.0, 2.5*dt, ic, newton_params=(8, 1e-4, 1e-6, 1.0),
        interior_fluid=False, method="auto", p=4, s=1)
assert s.markers.dtype == jnp.float32, s.markers.dtype
mk = np.asarray(s.markers)
R_end = float(np.sqrt(((mk - 4.0)**2).sum(1)).mean())
assert np.isfinite(np.asarray(s.residual_log)).all(), s.residual_log
# motion + finiteness gate (accuracy is gated by the f64 Frank-disk
# tests): analytic sqrt(1 + 3 dt) = 1.0296 at a coarse 32^2/32-marker
# resolution lands within ~1.01-1.10 in f32
assert 1.01 < R_end < 1.10, R_end
print("OK", R_end)
"""


@pytest.mark.slow
def test_stefan_gn_moves_in_f32():
    """Three f32 GN steps on the Frank disk in a pure-f32 subprocess (x64
    off, the production precision): the front must actually grow (the
    regression froze it at the initial radius with zero GN updates)."""
    import subprocess
    import sys as _sys
    import os as _os

    repo = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    env = dict(_os.environ)
    env.pop("JAX_ENABLE_X64", None)
    res = subprocess.run(
        [_sys.executable, "-c", _STEFAN_F32_SCRIPT.replace("@@REPO@@", repo)],
        capture_output=True, text=True, env=env, timeout=480)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "OK" in res.stdout, res.stdout
