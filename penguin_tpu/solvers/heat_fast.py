"""Stencil-collapsed BE heat stepper (the repository's heat-step
benchmark path).

Specialization of the general mono unsteady system for Dirichlet interface
conditions: the interface closure row ``Γ T_γ = Γ g_γ`` is eliminated
analytically (T_γ := g_γ on cut cells), leaving one SPD system on the bulk
field::

    (V + dt · Id · Gᵀ Wꜝ G) T_ω = V T_ωⁿ + dt V f − dt Id Gᵀ Wꜝ H g_γ

Because every factor is diagonal-or-shift, the whole operator collapses to
a (2N+1)-point variable-coefficient stencil.  The coefficients (including
the inactive-cell identity masking and Dirichlet border rows) are
precomputed once, so the CG matvec is one elementwise fusion that reads
2N+2 arrays and writes one.  Solved by Jacobi-preconditioned CG with warm
starts under ``lax.while_loop``.

The jitted step/run functions live at module level and take the stencil
coefficients as ARGUMENTS (a pytree), not as closure constants: closed-over
arrays are baked into the lowered HLO as literals, which re-compiles per
FastHeatBE instance and makes the program as large as the grid.  As
arguments they are runtime parameters: the program is a few KB and
instances with equal shapes share the compile cache.

Mathematically identical to the general masked block solver in
``solvers/diffusion.py`` (unit-tested against it); the reference solves the
same system with sparse LU (src/solver/diffusion.jl:212-301).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..assembly import (
    border_info,
    coefficient_diag,
    gamma_value_vector,
    source_vector,
    _col_G_nz,
)
from ..boundary import Dirichlet, eval_condition_value
from ..linsolve import vdot
from ..operators import _shift_m, _shift_p, _zlast, dm, dm_t

__all__ = ["FastHeatBE"]


def _apply_stencil(coeffs, x):
    """(2N+1)-point variable-coefficient matvec."""
    acc = coeffs[0] * x
    for d in range((len(coeffs) - 1) // 2):
        acc = (acc + coeffs[1 + 2 * d] * _shift_m(x, d)
               + coeffs[2 + 2 * d] * _shift_p(x, d))
    return acc


def _cg(cg_maxiter, coeffs, dinv, tol2, b, x0):
    matvec = partial(_apply_stencil, coeffs)
    r = b - matvec(x0)
    z = dinv * r
    p = z
    rz = vdot(r, z)
    bb = jnp.maximum(vdot(b, b), jnp.asarray(1e-30, b.dtype))

    def cond_fn(state):
        x, r, p, rz, k = state
        return (vdot(r, r) > tol2 * bb) & (k < cg_maxiter)

    def body_fn(state):
        x, r, p, rz, k = state
        Ap = matvec(p)
        alpha = rz / vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = dinv * r
        rz_new = vdot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        return (x, r, p, rz_new, k + 1)

    x, r, p, rz, k = jax.lax.while_loop(
        cond_fn, body_fn, (x0, r, p, rz, jnp.zeros((), jnp.int32)))
    return x, k


@partial(jax.jit, static_argnames=("cg_maxiter",))
def _step_fn(cg_maxiter, params, Tw, x0):
    """One BE step: solve (V + dt·Id·GᵀWꜝG) x = V Tw + rhs."""
    b = params["Va"] * Tw + params["rhs"]
    return _cg(cg_maxiter, params["coeffs"], params["dinv"], params["tol2"],
               b, x0)


@partial(jax.jit, static_argnames=("cg_maxiter",))
def _run_fn(cg_maxiter, params, T0, n_steps):
    # quadratically extrapolated warm start (x0 = 3Tn - 3Tn-1 + Tn-2) saves
    # ~1-2 CG iterations per step; cubic extrapolation regresses in f32
    # (noise amplification)
    def body(_, carry):
        T, T1, T2 = carry
        Tn, _it = _step_fn(cg_maxiter, params, T, 3.0 * T - 3.0 * T1 + T2)
        return (Tn, T, T1)

    Tn, _, _ = jax.lax.fori_loop(0, n_steps, body, (T0, T0, T0))
    return Tn


@partial(jax.jit, static_argnames=("cg_maxiter",))
def _run_telemetry_fn(cg_maxiter, params, T0, n_steps):
    """Like ``_run_fn`` but carries CG-iteration telemetry (last / max
    over the run) — the cost is one extra scalar pair in the carry."""
    def body(_, carry):
        T, T1, T2, _last, mx = carry
        Tn, it = _step_fn(cg_maxiter, params, T, 3.0 * T - 3.0 * T1 + T2)
        return (Tn, T, T1, it, jnp.maximum(mx, it))

    z = jnp.zeros((), jnp.int32)
    Tn, _, _, last, mx = jax.lax.fori_loop(
        0, n_steps, body, (T0, T0, T0, z, z))
    return Tn, last, mx


class FastHeatBE:
    """Backward-Euler heat stepper with Dirichlet interface + Dirichlet
    borders, eliminated interface unknowns, and stencil-collapsed CG."""

    def __init__(self, capacity, ops, diffusion, source, bc_i, bc_b, dt,
                 cg_tol=1e-6, cg_maxiter=32, dtype=None):
        if dtype is None:
            dtype = capacity.V.dtype
        cast = lambda a: jnp.asarray(a, dtype)
        self.dt = dt = jnp.asarray(dt, dtype)
        V = cast(ops.V)
        A = tuple(cast(a) for a in ops.A)
        B = tuple(cast(b) for b in ops.B)
        Wdag = tuple(cast(w) for w in ops.Wdag)
        Id = cast(coefficient_diag(diffusion, capacity))
        g_gamma = cast(gamma_value_vector(bc_i, capacity))
        f_cells = cast(source_vector(source, capacity, 0.0))
        Gamma = cast(capacity.Gamma)
        ndim = len(A)

        # eliminated interface field: g on cut cells, 0 elsewhere
        Tg = jnp.where(Gamma > 0, g_gamma, 0.0)

        border = border_info(capacity.mesh, bc_b, capacity=capacity)
        bmask = jnp.zeros(capacity.V.shape, bool)
        bvals = jnp.zeros(capacity.V.shape, dtype)
        for key, cond, axis, side, mask in border.items:
            if not isinstance(cond, Dirichlet):
                raise ValueError("FastHeatBE supports Dirichlet borders only")
            bmask = bmask | mask
            bvals = jnp.where(
                mask, cast(eval_condition_value(cond.value, border.pos)), bvals
            )

        active = (V != 0.0) | _col_G_nz(ops)
        active = jnp.asarray(active) & (~bmask)

        # ------------------------------------------------------------------
        # collapse V + dt·Id·GᵀWꜝG to a (2N+1)-point stencil
        #   y_j = c_c x_j + Σ_d (c_m[d] x_{j-1_d} + c_p[d] x_{j+1_d})
        # row m (padding) vanishes automatically because B[m] = 0.
        # ------------------------------------------------------------------
        c_c = V
        c_m, c_p = [], []
        for d in range(ndim):
            diag_d = _zlast(B[d] ** 2 * (Wdag[d] + _shift_p(Wdag[d], d)), d)
            c_c = c_c + dt * Id * diag_d
            c_m.append(-dt * Id * B[d] * Wdag[d] * _shift_m(B[d], d))
            c_p.append(-dt * Id * B[d] * _shift_p(Wdag[d] * B[d], d))
        # masking folded into the coefficients: inactive/border -> identity row
        c_c = jnp.where(active, c_c, 1.0)
        c_m = [jnp.where(active, c, 0.0) for c in c_m]
        c_p = [jnp.where(active, c, 0.0) for c in c_p]

        coeffs = [c_c]
        for d in range(ndim):
            coeffs += [c_m[d], c_p[d]]
        coeffs = tuple(coeffs)

        # constant rhs pieces: dt·V·f − dt·Id·GᵀWꜝH g_γ  (+ border values)
        def h_apply(tg):
            out = 0.0
            for d in range(ndim):
                q = Wdag[d] * (A[d] * dm(tg, d) - dm(B[d] * tg, d))
                out = out + Id * (B[d] * dm_t(q, d))
            return out

        rhs_const = dt * V * f_cells - dt * h_apply(Tg)
        rhs_const = jnp.where(active, rhs_const, 0.0)
        rhs_const = jnp.where(bmask, bvals, rhs_const)

        diag = jnp.where(c_c == 0, 1.0, c_c)
        V_active = jnp.where(active, V, 0.0)

        self._params = {
            "coeffs": coeffs,
            "dinv": 1.0 / diag,
            "Va": V_active,
            "rhs": rhs_const,
            "tol2": jnp.asarray(cg_tol * cg_tol, dtype),
        }
        self._cg_maxiter = int(cg_maxiter)

        self.Tg = Tg
        self.active = active
        self.dtype = dtype

    # ------------------------------------------------------------------
    def step(self, Tw, x0=None):
        """One BE step: returns (T_{n+1}, cg_iters)."""
        return _step_fn(self._cg_maxiter, self._params, Tw,
                        Tw if x0 is None else x0)

    def matvec(self, x):
        return _apply_stencil(self._params["coeffs"], x)

    def run(self, T0, n_steps):
        """n_steps of BE in one XLA program (single compile; the step count
        is a dynamic loop bound)."""
        return _run_fn(self._cg_maxiter, self._params, T0, n_steps)

    def run_telemetry(self, T0, n_steps):
        """Like :meth:`run`, also returning (cg_iters_last, cg_iters_max)
        over the span — the bench uses it to record how hard the implicit
        solve actually works at a given dt."""
        return _run_telemetry_fn(self._cg_maxiter, self._params, T0, n_steps)
