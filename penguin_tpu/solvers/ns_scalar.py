"""Navier-Stokes ↔ scalar (temperature) coupling with Boussinesq buoyancy.

Re-design of ``/root/reference/src/solver/navierstokes_scalar_coupling.jl``:

- ``PassiveCoupling``: advance momentum, then transport the scalar with the
  new velocity (one-way);
- ``PicardCoupling``: fixed-point iterations per step — velocity with
  buoyancy from the scalar iterate, scalar with the new velocity —
  until both updates drop below tolerance (:10-27);
- buoyancy force ``-ρ β g_d V_d (T|_vel - T_ref)`` added to momentum rows
  (:248-259);
- inter-mesh transfer by nearest-neighbor index maps (the reference builds
  sparse 0/1 projection matrices, :60-88,120-141; here gather indices).

All three couplings are implemented, including ``MonolithicCoupling``
(one Newton system over u, p, T with an autodiff Jacobian; see
``solve_monolithic_steady`` below).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from ..assembly import (
    border_info,
    build_I_bc,
    coefficient_diag,
    mono_apply_fn,
    mono_rhs_fn,
    scalar_masks,
)
from ..linsolve import solve_linear
from ..operators import make_convection_ops

__all__ = ["PassiveCoupling", "PicardCoupling", "MonolithicCoupling",
           "NavierStokesScalarCoupler"]


@dataclasses.dataclass(frozen=True)
class PassiveCoupling:
    pass


@dataclasses.dataclass(frozen=True)
class PicardCoupling:
    tol_T: float = 1e-6
    tol_U: float = 1e-6
    maxiter: int = 5
    relaxation: float = 1.0


@dataclasses.dataclass(frozen=True)
class MonolithicCoupling:
    """Fully coupled Newton over (u, p, T) per step with the exact autodiff
    Jacobian (the reference hand-assembles it,
    navierstokes_scalar_coupling.jl:29-44)."""

    tol: float = 1e-9
    maxiter: int = 8
    damping: float = 1.0


def _nearest_map(src_coords, dst_coords):
    """Per-axis nearest-neighbor gather indices (uniform shifted grids)."""
    idx = np.searchsorted(src_coords, dst_coords)
    idx = np.clip(idx, 1, len(src_coords) - 1)
    lo = src_coords[idx - 1]
    hi = src_coords[idx]
    choose_lo = np.abs(dst_coords - lo) <= np.abs(hi - dst_coords)
    return np.where(choose_lo, idx - 1, idx)


def _grid_map(mesh_src, mesh_dst):
    """Index arrays mapping a field on mesh_src's DOF grid to mesh_dst's."""
    maps = []
    for d in range(mesh_src.ndim):
        src = np.asarray(mesh_src.nodes[d])  # length = np_shape[d]
        dst = np.asarray(mesh_dst.nodes[d])
        maps.append(jnp.asarray(_nearest_map(src, dst)))
    return maps


def _gather2d(field, maps):
    return field[maps[0][:, None], maps[1][None, :]]


class NavierStokesScalarCoupler:
    def __init__(self, momentum, scalar_capacity, scalar_ops, kappa,
                 scalar_source, bc_scalar, bc_scalar_cut,
                 strategy=None, beta=0.0, gravity=(0.0, -1.0), T_ref=0.0,
                 T0=None, method="lstsq"):
        self.momentum = momentum
        self.cap_T = scalar_capacity
        self.ops_T = scalar_ops
        self.kappa = kappa
        self.source_T = scalar_source
        self.bc_T = bc_scalar
        self.bc_T_cut = bc_scalar_cut
        self.strategy = strategy or PassiveCoupling()
        self.beta = float(beta)
        self.gravity = tuple(float(g) for g in gravity)
        self.T_ref = float(T_ref)
        self.method = method

        z = jnp.zeros(scalar_capacity.V.shape)
        self.T = T0 if T0 is not None else (z, z)
        self.x = momentum.zero_state()
        self.conv_prev = None
        self.time = 0.0
        self.states = []

        mesh_T = scalar_capacity.mesh
        # scalar -> velocity-grid gather maps (buoyancy), velocity -> scalar
        self._T_to_u = [
            _grid_map(mesh_T, momentum.fluid.mesh_u[d]) for d in range(2)
        ]
        self._u_to_T = [
            _grid_map(momentum.fluid.mesh_u[d], mesh_T) for d in range(2)
        ]

    # -- momentum substep with buoyancy from T ---------------------------
    def _momentum_step(self, dt, theta, Tw, t):
        mom = self.momentum
        apply_fn = mom.make_unsteady_apply(dt, theta)
        rhs_fn = mom.make_unsteady_rhs(dt, theta)
        rho = mom.fluid.rho
        rho_val = 1.0 if callable(rho) else float(rho)
        conv_c = mom.conv_vectors(self.x)
        extra = []
        for d in range(2):
            if self.conv_prev is None:
                conv = conv_c[d]
            else:
                conv = 1.5 * conv_c[d] - 0.5 * self.conv_prev[d]
            term = -rho_val * conv
            if self.beta != 0.0 and self.gravity[d] != 0.0:
                T_on_u = _gather2d(Tw, self._T_to_u[d])
                Vd = mom.fluid.operator_u[d].V
                term = term - rho_val * self.beta * self.gravity[d] * Vd * (
                    T_on_u - self.T_ref
                )
            extra.append(term)
        b = rhs_fn(self.x, t, t + dt, extra_mom=tuple(extra))
        x_new = solve_linear(apply_fn, b, method=self.method)
        return x_new, conv_c

    # -- scalar substep with velocity from momentum ----------------------
    def _scalar_step(self, dt, scheme, x_vel, t):
        cap, ops = self.cap_T, self.ops_T
        u_onT = tuple(
            _gather2d(x_vel[2 * d], self._u_to_T[d]) for d in range(2)
        )
        ug_onT = tuple(
            _gather2d(x_vel[2 * d + 1], self._u_to_T[d]) for d in range(2)
        )
        conv = make_convection_ops(cap, u_onT, ug_onT)
        ia, ib = build_I_bc(self.bc_T_cut)
        Id = coefficient_diag(self.kappa, cap)
        masks = scalar_masks(conv, cap.Gamma, ia, ib, steady=False, conv=conv)
        border = border_info(cap.mesh, self.bc_T)
        apply_fn = mono_apply_fn(conv, Id, cap.Gamma, ia, ib, dt=dt,
                                 scheme=scheme, border=border, masks=masks,
                                 conv=conv)
        rhs_fn = mono_rhs_fn(conv, Id, cap.Gamma, ia, ib, cap, self.source_T,
                             self.bc_T_cut, dt=dt, scheme=scheme,
                             border=border, masks=masks, conv=conv)
        b = rhs_fn(self.T, t)
        return solve_linear(apply_fn, b, method=self.method)

    # -- fully coupled Newton step ---------------------------------------
    def _monolithic_step(self, dt, scheme, st):
        """One implicit step of the coupled (u, p, T) system solved by
        Newton with an exact autodiff Jacobian."""
        from jax.flatten_util import ravel_pytree

        theta = 0.5 if scheme == "CN" else 1.0
        mom = self.momentum
        t = self.time
        rho = mom.fluid.rho
        rho_val = 1.0 if callable(rho) else float(rho)
        N = 2
        mom_rhs = mom.make_unsteady_rhs(dt, theta)
        x_prev, T_prev = self.x, self.T

        # scalar implicit blocks depend on u -> build residual directly
        from ..assembly import (
            border_info as _binfo,
            build_I_bc as _bic,
            coefficient_diag as _cdiag,
            mono_apply_fn as _mapply,
            mono_rhs_fn as _mrhs,
            scalar_masks as _smasks,
        )

        cap, opsT = self.cap_T, self.ops_T
        ia, ib = _bic(self.bc_T_cut)
        Id = _cdiag(self.kappa, cap)

        def residual(z):
            xv = z[: 2 * N + 1]
            Tv = z[2 * N + 1:]
            # momentum residual with implicit convection + buoyancy at (u,T)
            conv_c = mom.conv_vectors(xv)
            extra = []
            for d in range(N):
                term = -rho_val * conv_c[d]
                if self.beta != 0.0 and self.gravity[d] != 0.0:
                    T_on_u = _gather2d(Tv[0], self._T_to_u[d])
                    Vd = mom.fluid.operator_u[d].V
                    term = term - rho_val * self.beta * self.gravity[d] * Vd * (
                        T_on_u - self.T_ref
                    )
                extra.append(term)
            b_mom = mom_rhs(x_prev, t, t + dt, extra_mom=tuple(extra))
            A_mom = mom.make_unsteady_apply(dt, theta)(xv)
            r_mom = tuple(a - bb for a, bb in zip(A_mom, b_mom))
            # scalar residual with convection from u
            u_onT = tuple(_gather2d(xv[2 * d], self._u_to_T[d]) for d in range(N))
            ug_onT = tuple(
                _gather2d(xv[2 * d + 1], self._u_to_T[d]) for d in range(N)
            )
            conv = make_convection_ops(cap, u_onT, ug_onT)
            masks = _smasks(conv, cap.Gamma, ia, ib, steady=False, conv=conv)
            border = _binfo(cap.mesh, self.bc_T)
            aT = _mapply(conv, Id, cap.Gamma, ia, ib, dt=dt, scheme=scheme,
                         border=border, masks=masks, conv=conv)
            bT = _mrhs(conv, Id, cap.Gamma, ia, ib, cap, self.source_T,
                       self.bc_T_cut, dt=dt, scheme=scheme, border=border,
                       masks=masks, conv=conv)(T_prev, t)
            AT = aT(Tv)
            r_T = tuple(a - bb for a, bb in zip(AT, bT))
            return r_mom + r_T

        z0 = tuple(x_prev) + tuple(T_prev)
        flat, unravel = ravel_pytree(z0)

        def R(v):
            return ravel_pytree(residual(unravel(v)))[0]

        import jax as _jax

        jac = _jax.jit(_jax.jacfwd(R))
        Rj = _jax.jit(R)
        for it in range(st.maxiter):
            r = Rj(flat)
            rn = float(jnp.linalg.norm(r))
            if rn < st.tol:
                break
            J = jac(flat)
            delta, *_ = jnp.linalg.lstsq(J, r, rcond=1e-12)
            flat = flat - st.damping * delta
        z = unravel(flat)
        self.x = tuple(z[: 2 * N + 1])
        self.T = tuple(z[2 * N + 1:])
        self.conv_prev = None

    def step(self, dt, scheme="BE"):
        theta = 0.5 if scheme == "CN" else 1.0
        t = self.time
        if isinstance(self.strategy, MonolithicCoupling):
            self._monolithic_step(dt, scheme, self.strategy)
            self.time += dt
            self.states.append((self.time, self.x, self.T))
            return self.x, self.T
        if isinstance(self.strategy, PicardCoupling):
            st = self.strategy
            x_it, T_it = self.x, self.T
            conv_c = None
            for _ in range(st.maxiter):
                x_new, conv_c = self._momentum_step(dt, theta, T_it[0], t)
                T_new = self._scalar_step(dt, scheme, x_new, t)
                if st.relaxation != 1.0:
                    T_new = tuple(
                        st.relaxation * a + (1 - st.relaxation) * b_
                        for a, b_ in zip(T_new, T_it)
                    )
                dT = float(jnp.abs(T_new[0] - T_it[0]).max())
                dU = max(
                    float(jnp.abs(a - b_).max()) for a, b_ in zip(x_new, x_it)
                )
                x_it, T_it = x_new, T_new
                if dT < st.tol_T and dU < st.tol_U:
                    break
            self.x, self.T = x_it, T_it
            self.conv_prev = conv_c
        else:  # passive
            x_new, conv_c = self._momentum_step(dt, theta, self.T[0], t)
            self.T = self._scalar_step(dt, scheme, x_new, t)
            self.x = x_new
            self.conv_prev = conv_c
        self.time += dt
        self.states.append((self.time, self.x, self.T))
        return self.x, self.T

    def run(self, dt, t_end, scheme="BE"):
        while self.time < t_end - 1e-12:
            self.step(dt, scheme)
        return self.x, self.T

    # -- compiled-scan fast path -----------------------------------------
    def run_fast(self, dt, t_end, scheme="BE", picard_iters=None,
                 tol=1e-8, maxiter=200, method="pbicgstab", restart=60):
        """Advance to ``t_end`` with one jitted ``lax.scan`` over steps.

        Same stepping semantics as :meth:`step` (AB2-extrapolated explicit
        convection; per-step Picard sweeps that update buoyancy from the
        scalar iterate and scalar convection from the new velocity), but
        every linear solve is preconditioned Krylov instead of the dense
        ``lstsq`` fallback: momentum rides the block-Schur BiCGStab of
        ``NavierStokesMono.solve_unsteady`` and the scalar a
        Jacobi-preconditioned BiCGStab.  The Picard sweep count is fixed
        (unrolled in the trace) rather than tolerance-gated — call this in
        chunks and check convergence between chunks, like the unsteady NS
        benchmarks do (short device-side scans).

        The reference marches this coupling with per-step sparse factor
        solves (navierstokes_scalar_coupling.jl:370-420); here the whole
        chunk is one compiled scan on device.
        """
        import jax

        from ..assembly import mono_diag_fn
        from ..linsolve import pbicgstab, pgmres

        if method == "pgmres":
            # the robust f32 choice: BiCGStab can overflow on the cut-cell
            # saddle point in single precision (see solve_unsteady)
            def krylov(apply_fn, b, x0, Minv):
                return pgmres(apply_fn, b, x0, Minv=Minv, tol=tol,
                              maxiter=maxiter, restart=restart)
        else:
            def krylov(apply_fn, b, x0, Minv):
                return pbicgstab(apply_fn, b, x0, Minv=Minv, tol=tol,
                                 maxiter=maxiter)

        theta = 0.5 if scheme == "CN" else 1.0
        if picard_iters is None:
            picard_iters = (self.strategy.maxiter
                            if isinstance(self.strategy, PicardCoupling) else 1)
            picard_iters = min(int(picard_iters), 3)
        mom = self.momentum
        n_steps = int(np.ceil((t_end - self.time) / dt - 1e-12))
        cache = getattr(self, "_fast_run_cache", None)
        if cache is None:
            cache = self._fast_run_cache = {}
        key = (dt, theta, scheme, picard_iters, tol, maxiter, method,
               restart, n_steps)
        cached_run = cache.get(key)
        # the eager setup below (block preconditioner power iteration) runs
        # only on a cache miss — warm-started chunks reuse the executable
        # and everything it closes over
        apply_u = mom.make_unsteady_apply(dt, theta)
        rhs_u = mom.make_unsteady_rhs(dt, theta)
        Mu = (mom.make_block_preconditioner(dt=dt, theta=theta)
              if cached_run is None else None)
        rho = mom.fluid.rho
        rho_val = 1.0 if callable(rho) else float(rho)
        cap = self.cap_T
        ia, ib = build_I_bc(self.bc_T_cut)
        Id = coefficient_diag(self.kappa, cap)
        border = border_info(cap.mesh, self.bc_T)

        def momentum_solve(xc, conv_c, conv_p, first, Tw, t):
            extra = []
            for d in range(2):
                conv = jnp.where(first, conv_c[d],
                                 1.5 * conv_c[d] - 0.5 * conv_p[d])
                term = -rho_val * conv
                if self.beta != 0.0 and self.gravity[d] != 0.0:
                    T_on_u = _gather2d(Tw, self._T_to_u[d])
                    Vd = mom.fluid.operator_u[d].V
                    term = term - rho_val * self.beta * self.gravity[d] * Vd * (
                        T_on_u - self.T_ref)
                extra.append(term)
            b = rhs_u(xc, t, t + dt, extra_mom=tuple(extra))
            return krylov(apply_u, b, xc, Mu)

        def scalar_solve(Tc, x_vel, t):
            u_onT = tuple(
                _gather2d(x_vel[2 * d], self._u_to_T[d]) for d in range(2))
            ug_onT = tuple(
                _gather2d(x_vel[2 * d + 1], self._u_to_T[d]) for d in range(2))
            conv = make_convection_ops(cap, u_onT, ug_onT)
            masks = scalar_masks(conv, cap.Gamma, ia, ib, steady=False,
                                 conv=conv)
            af = mono_apply_fn(conv, Id, cap.Gamma, ia, ib, dt=dt,
                               scheme=scheme, border=border, masks=masks,
                               conv=conv)
            bf = mono_rhs_fn(conv, Id, cap.Gamma, ia, ib, cap, self.source_T,
                             self.bc_T_cut, dt=dt, scheme=scheme,
                             border=border, masks=masks, conv=conv)
            diag = mono_diag_fn(conv, Id, cap.Gamma, ia, ib, dt=dt,
                                scheme=scheme, border=border, masks=masks)

            def Minv(r):
                return tuple(a / d_ for a, d_ in zip(r, diag))

            return krylov(af, bf(Tc, t), Tc, Minv)

        run = cached_run
        if run is None:
            @jax.jit
            def run(x0, T0, conv_p0, first0, t0_):
                def body(carry, k):
                    xc, Tc, conv_p, first = carry
                    t = t0_ + k * dt
                    conv_c = mom.conv_vectors(xc)
                    x_it, T_it = xc, Tc
                    for _ in range(picard_iters):
                        x_it, itu, rru = momentum_solve(
                            xc, conv_c, conv_p, first, T_it[0], t)
                        T_it, itT, rrT = scalar_solve(Tc, x_it, t)
                    return ((x_it, T_it, conv_c, jnp.asarray(False)),
                            (itu, rru, itT, rrT))

                carry0 = (x0, T0, conv_p0, first0)
                (xf, Tf, conv_f, _), aux = jax.lax.scan(
                    body, carry0, jnp.arange(n_steps, dtype=jnp.float64))
                return xf, Tf, conv_f, aux

            cache[key] = run

        first0 = jnp.asarray(self.conv_prev is None)
        conv_p0 = (self.conv_prev if self.conv_prev is not None
                   else mom.conv_vectors(self.x))
        self.x, self.T, self.conv_prev, aux = run(
            self.x, self.T, conv_p0, first0, self.time)
        self.krylov_iters_u = np.asarray(aux[0])
        self.krylov_relres_u = np.asarray(aux[1])
        self.krylov_iters_T = np.asarray(aux[2])
        self.krylov_relres_T = np.asarray(aux[3])
        self.time += n_steps * dt
        self.states.append((self.time, self.x, self.T))
        return self.x, self.T
