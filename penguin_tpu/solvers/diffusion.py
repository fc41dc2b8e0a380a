"""Scalar diffusion solvers: steady/unsteady, mono/diphasic.

Matrix-free re-design of the reference's ``src/solver/diffusion.jl``: the
2-block (bulk T_omega + interface T_gamma) and 4-block (two phases + jump
rows) systems are solved matrix-free; the unsteady drivers jit one implicit
step (rhs build + solve) and run it under ``lax.scan``, with the dense LU
path factorizing once per scheme exactly like the reference reuses its
assembled matrix.

Time-loop semantics mirror the reference driver
(solve_DiffusionUnsteadyMono!, src/solver/diffusion.jl:268-301): one solve
at t=0 from the initial condition, then ``ceil(Tend/dt)`` further steps with
the rhs evaluated at the *advanced* time.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..assembly import (
    border_info,
    build_I_bc,
    coefficient_diag,
    diph_apply_fn,
    diph_masks,
    diph_rhs_fn,
    mono_apply_fn,
    mono_diag_fn,
    mono_rhs_fn,
    scalar_masks,
)
from ..linsolve import DenseFactorSolver, KrylovSolver, solve_linear

__all__ = [
    "DiffusionSteadyMono",
    "DiffusionUnsteadyMono",
    "DiffusionSteadyDiph",
    "DiffusionUnsteadyDiph",
    "zero_state_mono",
    "zero_state_diph",
]


def zero_state_mono(mesh, dtype=None):
    z = jnp.zeros(mesh.np_shape, dtype=dtype)
    return (z, z)


def zero_state_diph(mesh, dtype=None):
    z = jnp.zeros(mesh.np_shape, dtype=dtype)
    return (z, z, z, z)


class _PhaseView:
    def __init__(self, x_omega):
        self.x_omega = x_omega


def _num_steps(dt, t_end):
    return int(np.ceil(t_end / dt - 1e-12))


class _ScalarSolverBase:
    x = None
    states = None

    @property
    def x_omega(self):
        return self.x[0]

    @property
    def x_gamma(self):
        return self.x[1]

    def phase_view(self, i):
        return _PhaseView(self.x[2 * i])


class DiffusionSteadyMono(_ScalarSolverBase):
    """Steady monophasic diffusion (reference DiffusionSteadyMono,
    src/solver/diffusion.jl:14-58)."""

    def __init__(self, phase, bc_b, bc_i):
        cap = phase.capacity
        ops = phase.operator
        ia, ib = build_I_bc(bc_i)
        Id = coefficient_diag(phase.diffusion, cap)
        masks = scalar_masks(ops, cap.Gamma, ia, ib, steady=True)
        border = border_info(cap.mesh, bc_b, capacity=cap)
        self.capacity = cap
        self.apply = mono_apply_fn(ops, Id, cap.Gamma, ia, ib, border=border,
                                   masks=masks)
        self._rhs = mono_rhs_fn(ops, Id, cap.Gamma, ia, ib, cap, phase.source,
                                bc_i, border=border, masks=masks)
        self._diag = mono_diag_fn(ops, Id, cap.Gamma, ia, ib, border=border,
                                  masks=masks)

    def solve(self, method="auto", precondition=True, **kw):
        b = self._rhs()
        M = None
        if precondition and method in ("cg", "bicgstab", "gmres"):
            dinv = jax.tree_util.tree_map(lambda d: 1.0 / d, self._diag)

            def M(r):
                return jax.tree_util.tree_map(lambda a, b_: a * b_, r, dinv)

        self.x = solve_linear(self.apply, b, method=method, M=M, **kw)
        self.states = [self.x]
        return self.x


class DiffusionUnsteadyMono(_ScalarSolverBase):
    """Unsteady monophasic diffusion with BE/CN theta schemes
    (reference DiffusionUnsteadyMono, src/solver/diffusion.jl:192-301)."""

    def __init__(self, phase, bc_b, bc_i, dt, u0, scheme="BE"):
        cap = phase.capacity
        ops = phase.operator
        ia, ib = build_I_bc(bc_i)
        Id = coefficient_diag(phase.diffusion, cap)
        masks = scalar_masks(ops, cap.Gamma, ia, ib, steady=False)
        border = border_info(cap.mesh, bc_b, capacity=cap)
        self.capacity = cap
        self.dt = float(dt)
        self.scheme = scheme
        self.u0 = u0
        self.apply = mono_apply_fn(ops, Id, cap.Gamma, ia, ib, dt=self.dt,
                                   scheme=scheme, border=border, masks=masks)
        self._rhs = mono_rhs_fn(ops, Id, cap.Gamma, ia, ib, cap, phase.source,
                                bc_i, dt=self.dt, scheme=scheme, border=border,
                                masks=masks)
        self._diag = mono_diag_fn(ops, Id, cap.Gamma, ia, ib, dt=self.dt,
                                  scheme=scheme, border=border, masks=masks)

    def solve(self, t_end, method="auto", tol=1e-12, maxiter=None,
              keep_states=True, t_start=0.0, initial_solve=True):
        """``t_end`` is the duration from ``t_start``.  ``initial_solve``
        performs the reference's extra solve at the start time
        (diffusion.jl loop semantics); pass False when resuming from a
        checkpoint so the step count continues exactly."""
        dt = self.dt
        n_steps = _num_steps(dt, t_end)
        nflat = sum(np.prod(np.asarray(u.shape)) for u in self.u0)
        if method == "auto":
            method = "direct" if nflat <= 8000 else "bicgstab"

        if method == "direct":
            factor = DenseFactorSolver(self.apply, self.u0)

            def step(x, t):
                b = self._rhs(x, t)
                return factor.solve(b)
        else:
            # Jacobi preconditioning: the unsteady rows mix V/dt-scaled bulk
            # with O(1) border/interface surgery rows — unpreconditioned
            # cg/bicgstab diverge once an inhomogeneous border makes the
            # solve nontrivial (pgmres equilibrates internally)
            M = None
            if method in ("cg", "bicgstab", "gmres"):
                dinv = jax.tree_util.tree_map(lambda d: 1.0 / d, self._diag)

                def M(r):
                    return jax.tree_util.tree_map(lambda a, b_: a * b_,
                                                  r, dinv)

            solver = KrylovSolver(self.apply, method=method, tol=tol,
                                  maxiter=maxiter, M=M, template=self.u0)

            def step(x, t):
                b = self._rhs(x, t)
                return solver.solve(b, x0=x)

        @jax.jit
        def run(u0):
            x0 = step(u0, t_start) if initial_solve else u0

            def body(x, k):
                t = t_start + (k + 1.0) * dt
                xn = step(x, t)
                return xn, xn

            xf, hist = jax.lax.scan(body, x0, jnp.arange(n_steps))
            return x0, xf, hist

        x0, xf, hist = run(self.u0)
        self.x = xf
        if keep_states:
            self.states = [x0] + [
                tuple(h[k] for h in hist) for k in range(n_steps)
            ]
        else:
            self.states = [xf]
        return self.x


class DiffusionSteadyDiph(_ScalarSolverBase):
    """Steady diphasic diffusion with ScalarJump/FluxJump interface rows
    (reference DiffusionSteadyDiph, src/solver/diffusion.jl:88-161)."""

    def __init__(self, phase1, phase2, bc_b, ic):
        cap1, cap2 = phase1.capacity, phase2.capacity
        ops1, ops2 = phase1.operator, phase2.operator
        Id1 = coefficient_diag(phase1.diffusion, cap1)
        Id2 = coefficient_diag(phase2.diffusion, cap2)
        a1, a2 = ic.scalar.alpha1, ic.scalar.alpha2
        b1c, b2c = ic.flux.beta1, ic.flux.beta2
        masks = diph_masks(ops1, ops2, cap1.Gamma, cap2.Gamma, a1, a2, b1c,
                           b2c, steady=True)
        border1 = border_info(cap1.mesh, bc_b, phase_mask=cap1.cell_types != 0, capacity=cap1)
        border2 = border_info(cap2.mesh, bc_b, phase_mask=cap2.cell_types != 0, capacity=cap2)
        self.capacity = cap1
        self.capacity2 = cap2
        self.apply = diph_apply_fn(ops1, ops2, Id1, Id2, ic, border1=border1,
                                   border2=border2, masks=masks)
        self._rhs = diph_rhs_fn(ops1, ops2, Id1, Id2, cap1, cap2,
                                phase1.source, phase2.source, ic,
                                border1=border1, border2=border2, masks=masks)

    def solve(self, method="auto", **kw):
        b = self._rhs()
        self.x = solve_linear(self.apply, b, method=method, **kw)
        self.states = [self.x]
        return self.x


class DiffusionUnsteadyDiph(_ScalarSolverBase):
    """Unsteady diphasic diffusion (reference DiffusionUnsteadyDiph,
    src/solver/diffusion.jl:319-455)."""

    def __init__(self, phase1, phase2, bc_b, ic, dt, u0, scheme="BE"):
        cap1, cap2 = phase1.capacity, phase2.capacity
        ops1, ops2 = phase1.operator, phase2.operator
        Id1 = coefficient_diag(phase1.diffusion, cap1)
        Id2 = coefficient_diag(phase2.diffusion, cap2)
        a1, a2 = ic.scalar.alpha1, ic.scalar.alpha2
        b1c, b2c = ic.flux.beta1, ic.flux.beta2
        masks = diph_masks(ops1, ops2, cap1.Gamma, cap2.Gamma, a1, a2, b1c,
                           b2c, steady=False)
        border1 = border_info(cap1.mesh, bc_b, phase_mask=cap1.cell_types != 0, capacity=cap1)
        border2 = border_info(cap2.mesh, bc_b, phase_mask=cap2.cell_types != 0, capacity=cap2)
        self.capacity = cap1
        self.capacity2 = cap2
        self.dt = float(dt)
        self.scheme = scheme
        self.u0 = u0
        self.apply = diph_apply_fn(ops1, ops2, Id1, Id2, ic, dt=self.dt,
                                   scheme=scheme, border1=border1,
                                   border2=border2, masks=masks)
        self._rhs = diph_rhs_fn(ops1, ops2, Id1, Id2, cap1, cap2,
                                phase1.source, phase2.source, ic, dt=self.dt,
                                scheme=scheme, border1=border1,
                                border2=border2, masks=masks)

    def solve(self, t_end, method="auto", tol=1e-12, maxiter=None,
              keep_states=False, t_start=0.0, initial_solve=True):
        dt = self.dt
        n_steps = _num_steps(dt, t_end)
        nflat = sum(np.prod(np.asarray(u.shape)) for u in self.u0)
        if method == "auto":
            method = "direct" if nflat <= 8000 else "bicgstab"

        if method == "direct":
            factor = DenseFactorSolver(self.apply, self.u0)

            def step(x, t):
                return factor.solve(self._rhs(x, t))
        else:
            solver = KrylovSolver(self.apply, method=method, tol=tol,
                                  maxiter=maxiter, template=self.u0)

            def step(x, t):
                return solver.solve(self._rhs(x, t), x0=x)

        @jax.jit
        def run(u0):
            x0 = step(u0, t_start) if initial_solve else u0

            def body(x, k):
                t = t_start + (k + 1.0) * dt
                xn = step(x, t)
                return xn, xn if keep_states else None

            xf, hist = jax.lax.scan(body, x0, jnp.arange(n_steps))
            return x0, xf, hist

        x0, xf, hist = run(self.u0)
        self.x = xf
        if keep_states and hist is not None:
            self.states = [x0] + [
                tuple(h[k] for h in hist) for k in range(n_steps)
            ]
        else:
            self.states = [x0, xf]
        return self.x
