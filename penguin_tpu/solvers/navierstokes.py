"""Incompressible Navier-Stokes on the staggered cut-cell Stokes layout.

Re-design of ``/root/reference/src/solver/navierstokes.jl`` (3277 LoC):

- flux-form skew convection per component d (build_convection_matrix,
  navierstokes.jl:119-137): primary term ``Dp_d(Sm_d(A_d u_d) ⊙ Sm_d(q))``
  plus cross terms ``Dp_j(Sm_d(A_j u_j) ⊙ Sm_j(q))`` — note the cross flux
  is averaged along the *primary* axis, as in the reference;
- interface transfer ``K_d = diag(Sp_d(Hᵀ u_γ^rot))`` with the component-
  rotated interface stacking (rotated_interfaces, navierstokes.jl:148-166);
- unsteady θ-scheme with Adams-Bashforth-2 extrapolated explicit convection
  (assemble_navierstokes2D_unsteady!, navierstokes.jl:632-700):
  ``rhs -= ρ (1.5 conv^n - 0.5 conv^{n-1})``;
- steady Picard linearization ``visc + ρ C(u_k) - ρ/2 K(u_k)`` in the
  momentum diagonal (assemble_navierstokes2D_steady_picard!,
  navierstokes.jl:1122-1200).

Everything is matrix-free; the unsteady loop jits rhs-build + LU-solve per
step with the factorization reused across steps.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..linsolve import HIGHEST, DenseFactorSolver, solve_linear, vdot
from ..operators import dp, sm, sp
from .stokes import StokesMono

__all__ = ["NavierStokesMono"]


class NavierStokesMono(StokesMono):
    # ------------------------------------------------------------------
    # convection operators (matrix-free)
    # ------------------------------------------------------------------
    def _conv_outflow_masks(self, d):
        """Outlet-plane masks (one per own-axis Outflow border, either
        side) on component d's grid, built once per instance."""
        masks = getattr(self, "_conv_out_masks", None)
        if masks is None:
            from ..boundary import Outflow as _Out
            from .stokes import _AXIS_KEYS, _AXIS_KEYS_1D

            keymap = _AXIS_KEYS_1D if self.N == 1 else _AXIS_KEYS
            masks = []
            for c in range(self.N):
                items = []
                for key, cond in self.bc_u[c].borders:
                    if not isinstance(cond, _Out) or key not in keymap:
                        continue
                    axis, side = keymap[key]
                    if axis != c:
                        continue
                    shape = self.fluid.mesh_u[c].np_shape
                    m = np.zeros(shape, bool)
                    sl = [slice(None)] * len(shape)
                    sl[axis] = 0 if side == 0 else \
                        self.fluid.mesh_u[c].n[axis] - 1
                    m[tuple(sl)] = True
                    # cache the NUMPY mask: this getter can first run inside
                    # a jit trace, and a jnp constant created there leaks
                    # that trace's tracer into later traces via the cache
                    items.append((axis, side, m))
                masks.append(tuple(items))
            self._conv_out_masks = masks
        return masks[d]

    def conv_bulk(self, d, uw_all, q):
        """C_d(u) q : flux-form convection of q on component-d's grid.

        At an own-axis Outflow border the centered flux-form stencil is
        replaced by an UPWIND one-sided difference on the last live plane:
        the padding plane beyond it is structurally zeroed inside sm/dp
        (``_zlast``), so the centered form sees only a quarter of the
        outgoing momentum flux — effectively a 75%-blocked wall.  On the
        DFG channel that reflected the convected front when it reached the
        outlet (t ≈ 0.6) and blew up the run; the one-sided form lets it
        leave transparently."""
        from ..operators import _shift_m, _shift_p

        A = self.fluid.capacity_u[d].A
        own_g = sm(A[d] * uw_all[d], d) * sm(q, d)
        out = dp(own_g, d)
        for axis, side, mask in self._conv_outflow_masks(d):
            if side == 1:      # high-side outlet: backward one-sided diff
                repl = own_g - _shift_m(own_g, axis)
            else:              # low-side outlet: forward one-sided diff,
                # shifted one face inward (own_g[0] is the truncated
                # quarter-flux face, own_g[2]-own_g[1] avoids it)
                s1 = _shift_p(own_g, axis)
                repl = _shift_p(s1, axis) - s1
            out = jnp.where(mask, repl, out)
        for j in range(self.N):
            if j == d:
                continue
            flux_c = sm(A[j] * uw_all[j], d)
            out = out + dp(flux_c * sm(q, j), j)
        return out

    def conv_K(self, d, ug_all):
        """diag weights of K_d (interface transfer)."""
        faces = tuple(ug_all[(d + a) % self.N] for a in range(self.N))
        return sp(self.fluid.operator_u[d].HT(faces), d)

    def conv_vectors(self, x):
        """conv_d = C_d(u) uω_d - K_d(uγ) uω_d (same-state form,
        compute_convection_vectors!, navierstokes.jl:346-434)."""
        N = self.N
        uws = x[0:2 * N:2]
        ugs = x[1:2 * N:2]
        out = []
        for d in range(N):
            Kw = self.conv_K(d, ugs)
            out.append(self.conv_bulk(d, uws, uws[d]) - Kw * uws[d])
        return tuple(out)

    # ------------------------------------------------------------------
    # unsteady: implicit viscous + AB2 explicit convection
    # ------------------------------------------------------------------
    def solve_unsteady(self, dt, t_end, scheme="CN", method="auto", x0=None,
                       tol=1e-10, maxiter=None, record=None, t_start=0.0,
                       conv_prev=None):
        """``record``: optional jittable ``f(x) -> pytree of scalars``
        evaluated on every step's state inside the scan (e.g. interface
        forces / probe pressures for the DFG Cd/Cl time series — the
        reference keeps every full state in ``histories`` and
        post-processes on the host, flow_around_circle_cd_cl.jl:112-145;
        recording scalars in-scan avoids holding 4000 full states).
        Results land in ``self.record_log`` (stacked over steps).

        ``t_start``: BC/source evaluation time of the first step — lets a
        long run be split into warm-started chunks (``x0`` = previous
        chunk's state), which keeps each device-side scan short.
        ``conv_prev``: the previous chunk's final convection carry
        (``self.conv_prev_out``) — passing it keeps every step AB2 across
        chunk boundaries; without it each chunk restarts with one
        locally-first-order AB1 step."""
        theta = 0.5 if scheme in ("CN", "cn") else 1.0
        rho = self.fluid.rho
        rho_val = 1.0 if callable(rho) else float(rho)
        N = self.N

        x = x0 if x0 is not None else self.zero_state()
        n_steps = int(np.ceil((t_end - t_start) / dt - 1e-12))
        nflat = sum(int(np.prod(np.asarray(u.shape))) for u in x)
        if method == "auto":
            method = "direct" if nflat <= 12000 else "pbicgstab"
        telemetry = method in ("pbicgstab", "pgmres", "fgmres")

        # compiled-scan cache: chunked runs (same n_steps, varying t_start)
        # reuse one executable — t_start is a traced argument.  The key
        # holds the record fn object itself (keeps it alive: no GC id
        # reuse).  Everything the scan closes over (operators, rhs,
        # preconditioner, dense LU) is built ONLY on a cache miss: a warm
        # chunk must not pay the eager power-iteration / factorization
        # setup again just to discard it.
        cache = getattr(self, "_unsteady_run_cache", None)
        if cache is None:
            cache = self._unsteady_run_cache = {}
        key = (dt, theta, method, tol, maxiter, n_steps, record)
        run = cache.get(key)
        if run is None:
            apply_fn = self.make_unsteady_apply(dt, theta)
            base_rhs = self.make_unsteady_rhs(dt, theta)
            if method == "direct":
                factor = DenseFactorSolver(apply_fn, x)
                lin_solve = factor.solve
            elif method == "pbicgstab":
                from ..linsolve import pbicgstab

                M = self.make_block_preconditioner(dt=dt, theta=theta)

                def lin_solve(b, x0_=None):
                    return pbicgstab(apply_fn, b, x0_, Minv=M, tol=tol,
                                     maxiter=maxiter or 400)
            elif method == "pgmres":
                # restarted GMRES with the block-Schur preconditioner: the
                # robust choice when BiCGStab breaks down on the cut-cell
                # saddle point (observed on the DFG channel-cylinder system
                # in f32: BiCGStab overflows at ~110 its, GMRES(60)
                # converges)
                from ..linsolve import pgmres

                M = self.make_block_preconditioner(dt=dt, theta=theta)

                def lin_solve(b, x0_=None):
                    return pgmres(apply_fn, b, x0_, Minv=M, tol=tol,
                                  maxiter=maxiter or 400, restart=60)
            elif method == "fgmres":
                # flexible GMRES with the DCT-Poisson/CG Schur solve: no
                # spectral bounds, so it survives geometries where the
                # Chebyshev bound estimate mistunes (e.g. the 256x128 DFG
                # channel, where pgmres stalls at relres ~1e-2 and the
                # run blows up); the DCT surrogate keeps the inner
                # iteration count mesh-size-independent
                from ..linsolve import fgmres

                M = self.make_block_preconditioner(dt=dt, theta=theta,
                                                   schur="dct_cg",
                                                   schur_cg_iters=20)

                def lin_solve(b, x0_=None):
                    return fgmres(apply_fn, b, x0_, Minv=M, tol=tol,
                                  maxiter=maxiter or 400, restart=40)
            else:
                from jax.scipy.sparse.linalg import gmres

                def lin_solve(b, x0_=None):
                    xs, _ = gmres(apply_fn, b, x0=x0_, tol=tol, M=None,
                                  maxiter=maxiter or 2000,
                                  solve_method="batched")
                    return xs

            def full_rhs(xc, conv_c, conv_p, first, t):
                extra = tuple(
                    -rho_val * jnp.where(first, conv_c[d],
                                         1.5 * conv_c[d] - 0.5 * conv_p[d])
                    for d in range(N)
                )
                return base_rhs(xc, t, t + dt, extra_mom=extra)

            @jax.jit
            def run(x0_, t0_, cp0_, first0_):
                conv0 = self.conv_vectors(x0_)
                # AB2 carry across chunks: use the caller's conv_prev when
                # given (first0_=False), else fall back to AB1 on step 0
                conv0 = tuple(
                    jnp.where(first0_, c, p) for c, p in zip(conv0, cp0_))

                def body(carry, k):
                    xc, conv_p, first = carry
                    t = t0_ + k * dt
                    conv_c = self.conv_vectors(xc)
                    b = full_rhs(xc, conv_c, conv_p, first, t)
                    if telemetry:
                        xn, iters, relres = lin_solve(b, xc)
                        aux = (iters, relres)
                    else:
                        xn = lin_solve(b, xc)
                        aux = None
                    rec = record(xn) if record is not None else None
                    return (xn, conv_c, jnp.asarray(False)), (aux, rec)

                (xf, conv_f, _), aux = jax.lax.scan(
                    body, (x0_, conv0, first0_),
                    jnp.arange(n_steps, dtype=jnp.float64),
                )
                return xf, conv_f, aux

            cache[key] = run

        if conv_prev is None:
            cp0 = tuple(jnp.zeros_like(u) for u in x[0:2 * N:2])
            first0 = jnp.asarray(True)
        else:
            cp0 = conv_prev
            first0 = jnp.asarray(False)
        self.x, self.conv_prev_out, (aux, rec) = run(x, t_start, cp0, first0)
        if telemetry:
            self.krylov_iters = np.asarray(aux[0])
            self.krylov_relres = np.asarray(aux[1])
        if record is not None:
            self.record_log = jax.tree_util.tree_map(np.asarray, rec)
        return self.x

    # ------------------------------------------------------------------
    # unsteady: fully implicit Picard convection
    # ------------------------------------------------------------------
    def solve_unsteady_picard(self, dt, t_end, scheme="BE", picard_iters=4,
                              picard_tol=1e-9, method="lstsq", x0=None,
                              verbose=False, tol=1e-6, maxiter=240,
                              t_start=0.0, record=None):
        """θ-scheme with implicit (Picard-linearized) convection per step
        (assemble_navierstokes2D_unsteady_picard, navierstokes.jl:840-1066).

        ``method="fgmres"`` runs the whole span as one compiled scan with
        flexible GMRES + the DCT-CG block-Schur preconditioner per Picard
        sweep (fixed ``picard_iters``, no tolerance gating inside the
        trace).  Implicit convection removes the AB2 cut-cell CFL limit
        that destabilizes the explicit path on fine grids (256²-class DFG
        runs blow up at rim cells regardless of solver tolerance).
        ``t_start``/``record`` mirror :meth:`solve_unsteady` (chunked
        warm-started runs, in-scan scalar recording)."""
        theta = 0.5 if scheme in ("CN", "cn") else 1.0
        base_rhs = self.make_unsteady_rhs(dt, theta)
        rho = self.fluid.rho
        rho_val = 1.0 if callable(rho) else float(rho)
        N = self.N
        x = x0 if x0 is not None else self.zero_state()
        n_steps = int(np.ceil((t_end - t_start) / dt - 1e-12))

        if method == "fgmres":
            from ..linsolve import fgmres
            from .stokes import stokes_divergence

            def picard_apply(x_it, v):
                uws_k = x_it[0:2 * N:2]
                ugs_k = x_it[1:2 * N:2]
                Kws = [self.conv_K(d, ugs_k) for d in range(N)]
                uws = v[0:2 * N:2]
                ugs = v[1:2 * N:2]
                p = v[2 * N]
                out = []
                for d in range(N):
                    mass = self.rho_diag[d] * self.fluid.operator_u[d].V / dt
                    yw = (
                        mass * uws[d]
                        + theta * self._visc(d, uws[d], ugs[d])
                        + theta * rho_val * self.conv_bulk(d, uws_k, uws[d])
                        - 0.5 * theta * rho_val * Kws[d] * uws[d]
                        + self._grad(d, p)
                    )
                    yw = jnp.where(self.u_active[d], yw, uws[d])
                    yg = ugs[d]
                    yw, yg = self.borders[d].matvec(yw, yg, uws[d], ugs[d])
                    out += [yw, yg]
                yp = self._div(uws, ugs)
                yp = jnp.where(self.p_active, yp, p)
                yp = self._gauge_fix(yp, p)
                return tuple(out) + (yp,)

            cache = getattr(self, "_picard_run_cache", None)
            if cache is None:
                cache = self._picard_run_cache = {}
            key = (dt, theta, picard_iters, tol, maxiter, n_steps, record)
            run = cache.get(key)
            if run is None:
                # eager setup (power iteration + DCT plan) only on a miss —
                # warm chunks reuse the executable and its closed-over M
                M = self.make_block_preconditioner(dt=dt, theta=theta,
                                                   schur="dct_cg",
                                                   schur_cg_iters=8)

                @jax.jit
                def run(x0_, t0_):
                    def body(xc, k):
                        t = t0_ + k * dt
                        if theta < 1.0:
                            # θ-scheme consistency: the (1−θ) explicit
                            # convection half lives on the RHS (the
                            # implicit side carries only θ·conv)
                            conv_c = self.conv_vectors(xc)
                            extra = tuple(-(1.0 - theta) * rho_val * c
                                          for c in conv_c)
                            b = base_rhs(xc, t, t + dt, extra_mom=extra)
                        else:
                            b = base_rhs(xc, t, t + dt)
                        x_it = xc
                        for _ in range(picard_iters):
                            x_it, its, rel = fgmres(
                                lambda v, _x=x_it: picard_apply(_x, v),
                                b, x_it, Minv=M, tol=tol, maxiter=maxiter,
                                restart=40)
                        rec = record(x_it) if record is not None else None
                        return x_it, ((its, rel), rec)

                    xf, aux = jax.lax.scan(
                        body, x0_, jnp.arange(n_steps, dtype=jnp.float64))
                    return xf, aux

                cache[key] = run

            self.x, ((its, rel), rec) = run(x, t_start)
            self.krylov_iters = np.asarray(its)
            self.krylov_relres = np.asarray(rel)
            if record is not None:
                self.record_log = jax.tree_util.tree_map(np.asarray, rec)
            return self.x

        from ..linsolve import solve_linear

        for k in range(n_steps):
            t = t_start + k * dt
            if theta < 1.0:
                conv_c = self.conv_vectors(x)
                b = base_rhs(x, t, t + dt,
                             extra_mom=tuple(-(1.0 - theta) * rho_val * c
                                             for c in conv_c))
            else:
                b = base_rhs(x, t, t + dt)
            x_it = x
            for it in range(picard_iters):
                uws_k = x_it[0:2 * N:2]
                ugs_k = x_it[1:2 * N:2]
                Kws = [self.conv_K(d, ugs_k) for d in range(N)]

                def apply(v):
                    uws = v[0:2 * N:2]
                    ugs = v[1:2 * N:2]
                    p = v[2 * N]
                    out = []
                    for d in range(N):
                        mass = self.rho_diag[d] * self.fluid.operator_u[d].V / dt
                        yw = (
                            mass * uws[d]
                            + theta * self._visc(d, uws[d], ugs[d])
                            + theta * rho_val * self.conv_bulk(d, uws_k, uws[d])
                            - 0.5 * theta * rho_val * Kws[d] * uws[d]
                            + self._grad(d, p)
                        )
                        yw = jnp.where(self.u_active[d], yw, uws[d])
                        yg = ugs[d]
                        yw, yg = self.borders[d].matvec(yw, yg, uws[d], ugs[d])
                        out += [yw, yg]
                    from .stokes import stokes_divergence

                    yp = self._div(uws, ugs)
                    yp = jnp.where(self.p_active, yp, p)
                    yp = self._gauge_fix(yp, p)
                    return tuple(out) + (yp,)

                x_new = solve_linear(apply, b, method=method)
                diff = max(float(jnp.abs(a - c).max())
                           for a, c in zip(x_new, x_it))
                x_it = x_new
                if verbose:
                    print(f"step {k} picard {it}: {diff:.2e}")
                if diff < picard_tol:
                    break
            x = x_it
        self.x = x
        return self.x

    # ------------------------------------------------------------------
    # diagnostics: reaction forces on the cut boundary
    # ------------------------------------------------------------------
    def control_volume_force(self, box, x=None, nsamp=None):
        """Body force by the momentum-deficit (control-volume) integral —
        the coarse-rim-accurate alternative to :meth:`interface_force`.

        For STEADY flow, the force on an immersed body equals
        ``F_d = ∮_S [ −p n_d + μ(∂u_d/∂x_n + ∂u_n/∂x_d) n_n
                      − ρ u_d (u·n) ] dS``
        over any closed surface S enclosing the body.  Evaluating S on
        grid lines a few cells away from the cut rim uses only
        smooth-field values, so the result converges at the bulk
        second order instead of the O(h) cut-rim rate of the H-aperture
        traction integral (at the DFG 2D-1 grid, R/dx ≈ 5.8, the rim
        integral is ~10% high on Cd; the control volume lands in the
        published band).  2D only; ``box = (x_lo, x_hi, y_lo, y_hi)``.

        The reference has no analogue (it reports the rim integral,
        navierstokes.jl:2977-3058)."""
        if self.N != 2:
            raise NotImplementedError("control_volume_force is 2D")
        from scipy.ndimage import map_coordinates

        x = x if x is not None else self.x
        mu = self.fluid.mu
        mu_val = 1.0 if callable(mu) else float(mu)
        rho = self.fluid.rho
        rho_val = 1.0 if callable(rho) else float(rho)
        ux = np.asarray(x[0], float)
        uy = np.asarray(x[2], float)
        p = -np.asarray(x[4], float)  # state stores -p_phys
        meshes = (self.fluid.mesh_u[0], self.fluid.mesh_u[1],
                  self.fluid.mesh_p)

        def sampler(arr, mesh):
            # fields live at cell CENTERS (box centers) of their mesh:
            # position of index i along axis d is nodes[d][i] + h/2
            orig = [float(mesh.nodes[d][0]) + 0.5 * mesh.h[d]
                    for d in range(2)]
            h = [float(v) for v in mesh.h]

            def f(px, py):
                ci = (np.asarray(px) - orig[0]) / h[0]
                cj = (np.asarray(py) - orig[1]) / h[1]
                return map_coordinates(arr, [ci, cj], order=1,
                                       mode="nearest")
            return f

        f_ux, f_uy, f_p = (sampler(a, m)
                           for a, m in zip((ux, uy, p), meshes))
        hmin = min(float(self.fluid.mesh_p.h[0]),
                   float(self.fluid.mesh_p.h[1]))
        dlt = 0.25 * hmin

        def grad(f, px, py):
            dfdx = (f(px + dlt, py) - f(px - dlt, py)) / (2 * dlt)
            dfdy = (f(px, py + dlt) - f(px, py - dlt)) / (2 * dlt)
            return dfdx, dfdy

        x_lo, x_hi, y_lo, y_hi = (float(v) for v in box)
        if nsamp is None:
            nsamp = 4 * max(int((x_hi - x_lo) / hmin),
                            int((y_hi - y_lo) / hmin), 8)
        Fx = Fy = 0.0
        for (n_vec, const_axis, cval, t_lo, t_hi) in (
                ((1.0, 0.0), 0, x_hi, y_lo, y_hi),
                ((-1.0, 0.0), 0, x_lo, y_lo, y_hi),
                ((0.0, 1.0), 1, y_hi, x_lo, x_hi),
                ((0.0, -1.0), 1, y_lo, x_lo, x_hi)):
            t = np.linspace(t_lo, t_hi, nsamp)
            w = np.full(nsamp, (t_hi - t_lo) / (nsamp - 1))
            w[0] *= 0.5
            w[-1] *= 0.5  # trapezoid
            if const_axis == 0:
                px, py = np.full(nsamp, cval), t
            else:
                px, py = t, np.full(nsamp, cval)
            uxs, uys, ps = f_ux(px, py), f_uy(px, py), f_p(px, py)
            duxdx, duxdy = grad(f_ux, px, py)
            duydx, duydy = grad(f_uy, px, py)
            nx_, ny_ = n_vec
            un = uxs * nx_ + uys * ny_
            # traction of the full stress tensor + momentum flux
            tx = (-ps * nx_ + mu_val * (2 * duxdx * nx_
                                        + (duxdy + duydx) * ny_)
                  - rho_val * uxs * un)
            ty = (-ps * ny_ + mu_val * ((duydx + duxdy) * nx_
                                        + 2 * duydy * ny_)
                  - rho_val * uys * un)
            Fx += float(np.sum(w * tx))
            Fy += float(np.sum(w * ty))
        # force ON the body (the integral gives the force the fluid
        # outside S exerts on the contents of S; steady momentum balance
        # makes it the drag/lift on the body)
        return Fx, Fy

    def make_control_volume_recorder(self, box, nsamp=None, nq=2):
        """Traced control-volume (momentum-deficit) force for UNSTEADY
        runs — the jittable companion of :meth:`control_volume_force`.

        Returns ``cvf(x) -> (Fs_x, Fs_y, M_x, M_y)`` for use inside a
        jitted per-step ``record``: ``Fs`` is the surface integral of
        ``−p n + μ(∇u+∇uᵀ)n − ρ u (u·n)`` over the box boundary and
        ``M = ∫_box ρ u dV`` (bilinear quadrature, ``nq`` points per
        pressure cell per axis).  The force ON the body at time t is
        ``F(t) = Fs(t) − dM/dt`` (difference the logged M in
        post-processing); for a steady state dM/dt = 0 and this reduces
        to :meth:`control_volume_force`.  Rationale: the cut-rim
        traction integral carries the O(h) rim-placement error — at DFG
        2D-2 resolution (R/dx ≈ 5.8) that bias is ~+1.3% on mean Cd and
        ~+14% on Cl amplitude versus the published values, while the
        control volume uses only smooth-field values a few cells off
        the rim.  No reference analogue (it reports the rim integral
        only, navierstokes.jl:2977-3058)."""
        if self.N != 2:
            raise NotImplementedError("control_volume_force is 2D")
        mu = self.fluid.mu
        mu_val = 1.0 if callable(mu) else float(mu)
        rho = self.fluid.rho
        rho_val = 1.0 if callable(rho) else float(rho)
        meshes = (self.fluid.mesh_u[0], self.fluid.mesh_u[1],
                  self.fluid.mesh_p)
        shapes = tuple(m.np_shape for m in meshes)

        def bilin(mesh, shape, px, py):
            # static numpy gather indices + weights -> traced closure
            orig = [float(mesh.nodes[d][0]) + 0.5 * mesh.h[d]
                    for d in range(2)]
            h = [float(v) for v in mesh.h]
            ci = (np.asarray(px, float) - orig[0]) / h[0]
            cj = (np.asarray(py, float) - orig[1]) / h[1]
            i0 = np.clip(np.floor(ci).astype(np.int32), 0, shape[0] - 2)
            j0 = np.clip(np.floor(cj).astype(np.int32), 0, shape[1] - 2)
            fi = np.clip(ci - i0, 0.0, 1.0)
            fj = np.clip(cj - j0, 0.0, 1.0)

            def f(arr):
                w00 = jnp.asarray((1 - fi) * (1 - fj), arr.dtype)
                w10 = jnp.asarray(fi * (1 - fj), arr.dtype)
                w01 = jnp.asarray((1 - fi) * fj, arr.dtype)
                w11 = jnp.asarray(fi * fj, arr.dtype)
                return (arr[i0, j0] * w00 + arr[i0 + 1, j0] * w10
                        + arr[i0, j0 + 1] * w01 + arr[i0 + 1, j0 + 1] * w11)
            return f

        x_lo, x_hi, y_lo, y_hi = (float(v) for v in box)
        hmin = min(float(self.fluid.mesh_p.h[0]),
                   float(self.fluid.mesh_p.h[1]))
        dlt = 0.25 * hmin
        if nsamp is None:
            nsamp = 4 * max(int((x_hi - x_lo) / hmin),
                            int((y_hi - y_lo) / hmin), 8)
        # surface sample points (4 edges), + gradient stencil offsets
        edges = []
        for (n_vec, const_axis, cval, t_lo, t_hi) in (
                ((1.0, 0.0), 0, x_hi, y_lo, y_hi),
                ((-1.0, 0.0), 0, x_lo, y_lo, y_hi),
                ((0.0, 1.0), 1, y_hi, x_lo, x_hi),
                ((0.0, -1.0), 1, y_lo, x_lo, x_hi)):
            t = np.linspace(t_lo, t_hi, nsamp)
            w = np.full(nsamp, (t_hi - t_lo) / (nsamp - 1))
            w[0] *= 0.5
            w[-1] *= 0.5
            if const_axis == 0:
                px, py = np.full(nsamp, cval), t
            else:
                px, py = t, np.full(nsamp, cval)
            edges.append((n_vec, px, py, w))
        px_all = np.concatenate([e[1] for e in edges])
        py_all = np.concatenate([e[2] for e in edges])
        w_all = np.concatenate([e[3] for e in edges])
        nx_all = np.concatenate([np.full(nsamp, e[0][0]) for e in edges])
        ny_all = np.concatenate([np.full(nsamp, e[0][1]) for e in edges])

        stencil = [(0.0, 0.0), (dlt, 0.0), (-dlt, 0.0),
                   (0.0, dlt), (0.0, -dlt)]
        samplers = []  # [field][stencil point]
        for m, s in zip(meshes, shapes):
            samplers.append([bilin(m, s, px_all + ox, py_all + oy)
                             for (ox, oy) in stencil])

        # volume-quadrature points: midpoints of an nq-per-cell subgrid
        hq = hmin / nq
        qx = np.arange(x_lo + 0.5 * hq, x_hi, hq)
        qy = np.arange(y_lo + 0.5 * hq, y_hi, hq)
        QX, QY = (a.ravel() for a in np.meshgrid(qx, qy, indexing="ij"))
        wq = hq * hq
        vol_samp = [bilin(meshes[d], shapes[d], QX, QY) for d in range(2)]
        wj = jnp.asarray(w_all)
        nxj = jnp.asarray(nx_all)
        nyj = jnp.asarray(ny_all)

        def cvf(x):
            ux, uy = x[0], x[2]
            p = -x[2 * self.N]  # state stores -p_phys
            sx, sy, sp = samplers

            def vals_grads(samp, arr):
                v = samp[0](arr)
                dx_ = (samp[1](arr) - samp[2](arr)) / (2 * dlt)
                dy_ = (samp[3](arr) - samp[4](arr)) / (2 * dlt)
                return v, dx_, dy_

            uxs, duxdx, duxdy = vals_grads(sx, ux)
            uys, duydx, duydy = vals_grads(sy, uy)
            ps = sp[0](p)
            un = uxs * nxj + uys * nyj
            tx = (-ps * nxj + mu_val * (2 * duxdx * nxj
                                        + (duxdy + duydx) * nyj)
                  - rho_val * uxs * un)
            ty = (-ps * nyj + mu_val * ((duydx + duxdy) * nxj
                                        + 2 * duydy * nyj)
                  - rho_val * uys * un)
            Fsx = jnp.sum(wj * tx)
            Fsy = jnp.sum(wj * ty)
            Mx = rho_val * wq * jnp.sum(vol_samp[0](ux))
            My = rho_val * wq * jnp.sum(vol_samp[1](uy))
            return Fsx, Fsy, Mx, My

        return cvf

    def pressure_probe(self, points, x=None, radius=2.5):
        """O(h²) pointwise physical pressure by a weighted least-squares
        linear fit over active pressure-cell centroids near each point.

        The nearest-active-centroid probe is only O(h): at a stagnation
        point the centroid offset (up to ~h) times the local pressure
        gradient is a percent-level error at DFG resolutions (measured
        −1.1% on the 2D-1 ΔP).  Fitting p ≈ a + g·(c − x₀) over the
        cells within ``radius`` pressure-cell widths and reporting ``a``
        removes the offset error.  ``points`` is a list of N-tuples;
        returns a list of pressures (physical sign; the state stores
        −p_phys, stokes.py header).  Host-side diagnostic (numpy).

        The reference reads the raw nearest cell value for its pressure
        probes (navierstokes.jl:3083+); this probe is deliberately
        better."""
        x = x if x is not None else self.x
        p = -np.asarray(x[2 * self.N], float)
        idxs, wts = self._probe_weights(points, radius)
        return [float(np.dot(w, p.ravel()[i])) for i, w in zip(idxs, wts)]

    def _probe_weights(self, points, radius=2.5):
        """The LSQ probe is LINEAR in the cell pressures: p(x₀) = Σ wᵢ pᵢ
        with w = e₀ᵀ(AᵀWA)⁻¹AᵀW (moving-least-squares shape function).
        Precomputing (flat indices, weights) per point lets the probe run
        inside a jitted scan as one gather + dot per step."""
        pc = np.asarray(self.fluid.capacity_p.C_om, float)
        act = np.asarray(self.p_active)
        # distances in per-axis CELL units: on anisotropic meshes an
        # isotropic physical radius r*hmin selects a near-collinear
        # sliver of cells (4 cells at DFG 512x256, dx/dy = 2.7) and the
        # linear fit extrapolates wildly along the starved axis
        # (measured: dP -11% vs nearest-centroid -1.3%)
        h = np.array([float(v) for v in self.fluid.mesh_p.h])
        flat_idx = np.arange(act.size)[act.ravel()]
        cen = pc.reshape(-1, self.N)[act.ravel()]
        # damp barely-constrained sliver-cell pressures by fluid fraction
        vfrac = np.asarray(self.fluid.capacity_p.V, float).ravel()[
            act.ravel()] / float(np.prod(h))
        vfrac = np.clip(vfrac, 0.0, 1.0)
        idxs, wts = [], []
        for pt_xy in points:
            d = (cen - np.asarray(pt_xy, float)) / h
            r = np.sqrt((d * d).sum(1))
            sel = r < radius
            if sel.sum() < self.N + 2:  # pragma: no cover - tiny grids
                idxs.append(flat_idx[[np.argmin(r)]])
                wts.append(np.ones(1))
                continue
            ds = d[sel]
            w = vfrac[sel] * (1.0 - r[sel] / radius) ** 2  # Wendland-style
            A = np.concatenate([np.ones((sel.sum(), 1)), ds], axis=1)
            Aw = A * w[:, None]
            M = np.linalg.solve(Aw.T @ A, Aw.T)  # (N+1, npts)
            idxs.append(flat_idx[sel])
            wts.append(M[0])
        return idxs, wts

    def make_pressure_probe(self, points, radius=2.5):
        """Traced :meth:`pressure_probe`: returns ``f(x) -> jnp array of
        physical pressures at ``points`` for use inside a jitted per-step
        ``record`` (one static gather + dot per point)."""
        idxs, wts = self._probe_weights(points, radius)

        def f(x):
            p = -x[2 * self.N].ravel()  # state stores -p_phys
            return jnp.stack([jnp.dot(jnp.asarray(w, p.dtype), p[i],
                                      precision=HIGHEST)
                              for i, w in zip(idxs, wts)])
        return f

    # ------------------------------------------------------------------
    # steady: Picard
    # ------------------------------------------------------------------
    def make_picard_apply(self, x_k):
        """Linearized steady operator at the Picard iterate x_k."""
        N = self.N
        uws_k = x_k[0:2 * N:2]
        ugs_k = x_k[1:2 * N:2]
        rho = self.fluid.rho
        rho_val = 1.0 if callable(rho) else float(rho)
        Kws = [self.conv_K(d, ugs_k) for d in range(N)]

        def apply(x):
            uws = x[0:2 * N:2]
            ugs = x[1:2 * N:2]
            p = x[2 * N]
            out = []
            for d in range(N):
                yw = (
                    self._visc(d, uws[d], ugs[d])
                    + self._grad(d, p)
                    + rho_val * self.conv_bulk(d, uws_k, uws[d])
                    - 0.5 * rho_val * Kws[d] * uws[d]
                )
                yw = jnp.where(self.u_active[d], yw, uws[d])
                yg = ugs[d]
                yw, yg = self.borders[d].matvec(yw, yg, uws[d], ugs[d])
                out += [yw, yg]
            from .stokes import stokes_divergence

            yp = self._div(uws, ugs)
            yp = jnp.where(self.p_active, yp, p)
            yp = self._gauge_fix(yp, p)
            return tuple(out) + (yp,)

        return apply

    def nonlinear_residual(self, x, b):
        """R(x) = A(x)x - b with the convection evaluated at x itself (the
        true steady nonlinear residual; the reference builds its analytic
        Newton Jacobian by hand, navierstokes.jl:2111-2434 — here the exact
        Jacobian is autodiff of this residual)."""
        apply_fn = self.make_picard_apply(x)
        Ax = apply_fn(x)
        return tuple(a - bb for a, bb in zip(Ax, b))

    def solve_steady_newton(self, max_iter=20, tol=1e-10, damping=1.0,
                            x0=None, picard_warmup=3, verbose=False):
        """Steady Newton with exact autodiff Jacobian (reference:
        Picard warm-up then Newton, solve_NavierStokesMono_steady!,
        navierstokes.jl:1768-1812)."""
        from jax.flatten_util import ravel_pytree

        b = self.rhs_steady()
        x = x0 if x0 is not None else self.zero_state()
        if picard_warmup:
            x = self.solve_steady(max_iter=picard_warmup, tol=0.0, x0=x)
        flat_x, unravel = ravel_pytree(x)

        def R(v):
            return ravel_pytree(self.nonlinear_residual(unravel(v), b))[0]

        jac = jax.jit(jax.jacfwd(R))
        Rj = jax.jit(R)
        self.residual_history = []
        for it in range(max_iter):
            r = Rj(flat_x)
            rn = float(jnp.linalg.norm(r))
            self.residual_history.append(rn)
            if verbose:
                print(f"newton iter {it}: |R|={rn:.3e}")
            if rn < tol:
                break
            J = jac(flat_x)
            delta, *_ = jnp.linalg.lstsq(J, r, rcond=1e-12)
            flat_x = flat_x - damping * delta
        self.x = unravel(flat_x)
        return self.x

    def solve_steady_newton_krylov(self, max_iter=25, tol=1e-9,
                                   lin_maxiter=400, x0=None,
                                   picard_warmup=0, verbose=False,
                                   inner="fgmres", restart=100,
                                   mom="jacobi", mom_cg_iters=8,
                                   schur=None):
        """Jacobian-free Newton-Krylov for the steady problem (VERDICT
        round-1 item 8): block-Schur-preconditioned Krylov over the exact
        Jacobian-vector product ``jax.jvp`` of the nonlinear residual —
        the matrix-free replacement for the reference's hand-assembled
        analytic Jacobian Newton (navierstokes.jl:1768-1812, 2111-2434).
        Inner tolerances follow an Eisenstat-Walker-style forcing
        ``η_k = min(0.1, √‖R_k‖)`` for superlinear convergence without
        oversolving.  Residual norms in ``self.residual_history``.

        ``inner``: "fgmres" (default — FLEXIBLE restarted GMRES with the
        DCT-Poisson/CG Schur preconditioner: the Chebyshev variant's
        power-iteration spectrum bounds are run-to-run fragile in f32 on
        channel geometries — on the 256x128 DFG channel the mistuned
        sweep amplifies weak pressure modes and the Newton iteration
        stalls at |R| ~ 2e-2 on SOME hosts while converging on others;
        the inner-CG Schur solve needs no spectral bounds and is
        deterministic), "pgmres" (linear Chebyshev preconditioner;
        GMRES(100) drives the Re=1000 cavity to the f32 floor at 128²) or
        "pbicgstab" (stalls at |R| ~ 4e-3 on the Re=1000 cavity).

        ``picard_warmup`` defaults to 0: on the Re=1000 cavity a loose
        Picard warmup sends Newton into a stall basin (|R| plateaus at
        7e-4, min u -0.12); from zeros the first Newton step is a Stokes
        solve and the iteration reaches the f32 floor."""
        from ..linsolve import fgmres, pbicgstab, pgmres

        b = self.rhs_steady()
        x = x0 if x0 is not None else self.zero_state()
        if schur is None:
            schur = "dct_cg" if inner == "fgmres" else "cheb"
        M = self.make_block_preconditioner(
            dt=None, theta=1.0, mom=mom, mom_cg_iters=mom_cg_iters,
            schur=schur)
        if picard_warmup:
            for _ in range(picard_warmup):
                apply_fn = self.make_picard_apply(x)
                # loose warmup solves; reject a diverged/broken-down update
                xw, _, rr = pbicgstab(apply_fn, b, x, Minv=M, tol=1e-3,
                                      maxiter=lin_maxiter)
                ok = np.isfinite(float(rr)) and float(rr) < 1.0
                if ok:
                    x = xw

        def R(v):
            return self.nonlinear_residual(v, b)

        def rnorm(r):
            return jnp.sqrt(sum(vdot(a, a)
                                for a in jax.tree_util.tree_leaves(r)))

        zeros = jax.tree_util.tree_map(jnp.zeros_like, x)

        @jax.jit
        def newton_delta(xc, eta):
            r = R(xc)

            def Jv(v):
                return jax.jvp(R, (xc,), (v,))[1]

            if inner == "pbicgstab":
                delta, its, rr = pbicgstab(Jv, r, zeros, Minv=M, tol=eta,
                                           maxiter=lin_maxiter)
            elif inner == "fgmres":
                delta, its, rr = fgmres(Jv, r, zeros, Minv=M, tol=eta,
                                        maxiter=lin_maxiter,
                                        restart=restart)
            else:
                delta, its, rr = pgmres(Jv, r, zeros, Minv=M, tol=eta,
                                        maxiter=lin_maxiter,
                                        restart=restart)
            return delta, its

        @jax.jit
        def take(xc, delta, alpha):
            return jax.tree_util.tree_map(lambda a, d: a - alpha * d,
                                          xc, delta)

        rn_fn = jax.jit(lambda v: rnorm(R(v)))
        self.residual_history = []
        self.newton_lin_iters = []
        best_rn, best_x, stall = np.inf, x, 0
        for it in range(max_iter):
            rn = float(rn_fn(x))
            self.residual_history.append(rn)
            if verbose:
                print(f"jfnk iter {it}: |R|={rn:.3e}")
            if rn < best_rn:
                best_rn, best_x, stall = rn, x, 0
            else:
                # inner Krylov can no longer improve on the forcing
                # tolerance (f64 floor / BiCGStab breakdown)
                stall += 1
                if stall >= 3:
                    break
            if rn < tol:
                break
            # Eisenstat-Walker forcing, floored (the floor matters: at
            # 1e-3 the Re=1000 cavity stalls at |R| ~ 4e-3 because the
            # inner solve is too loose to produce a descent direction;
            # 1e-4 lets GMRES(100) drive |R| to the f32 floor)
            eta = float(np.clip(np.sqrt(max(rn, 1e-300)), 1e-4, 0.1))
            delta, its = newton_delta(x, jnp.asarray(eta))
            self.newton_lin_iters.append(int(its))
            # backtracking line search: accept the first step that does
            # not worsen |R| (guards against inner-solve breakdown)
            accepted = False
            for alpha in (1.0, 0.5, 0.25, 0.1):
                xa = take(x, delta, alpha)
                ra = float(rn_fn(xa))
                if np.isfinite(ra) and ra < rn * (1.0 + 1e-8):
                    x, accepted = xa, True
                    break
            if not accepted:
                stall += 2  # no usable direction — terminate next check
        self.x = best_x
        return self.x

    def solve_steady(self, max_iter=30, tol=1e-8, relax=1.0, method="lstsq",
                     x0=None, verbose=False):
        """Picard iteration (the reference warms up with Picard before
        Newton, solve_NavierStokesMono_steady!, navierstokes.jl:1768-1812).
        ``method="pbicgstab"`` runs matrix-free with the block-Schur
        preconditioner (scalable path); other methods go through
        ``solve_linear``."""
        x = x0 if x0 is not None else self.zero_state()
        b = self.rhs_steady()
        self.residual_history = []
        M = (self.make_block_preconditioner(dt=None, theta=1.0)
             if method == "pbicgstab" else None)
        for it in range(max_iter):
            apply_fn = self.make_picard_apply(x)
            if method == "pbicgstab":
                from ..linsolve import pbicgstab

                x_new, _, _ = pbicgstab(apply_fn, b, x, Minv=M, tol=1e-9,
                                        maxiter=600)
            else:
                x_new = solve_linear(apply_fn, b, method=method)
            if relax != 1.0:
                x_new = jax.tree_util.tree_map(
                    lambda a, c: relax * a + (1 - relax) * c, x_new, x
                )
            diff = max(
                float(jnp.abs(a - c).max()) for a, c in zip(x_new, x)
            )
            self.residual_history.append(diff)
            x = x_new
            if verbose:
                print(f"picard iter {it}: diff={diff:.3e}")
            if diff < tol:
                break
        self.x = x
        return self.x

    def solve_steady_marching(self, dt, t_max=100.0, chunk=2.0, tol=1e-6,
                              scheme="CN", method="pbicgstab", lin_tol=1e-7,
                              maxiter=300, x0=None, verbose=False):
        """Steady state by pseudo-time continuation — the scalable
        matrix-free path for problems past dense factorization (the
        Picard/Newton steady solvers materialize the saddle point; GMRES
        alone stagnates on the unpreconditioned steady system, while the
        unsteady system is mass-dominated and well-conditioned).  Marches
        ``solve_unsteady`` in chunks until ``max|Δu|/chunk < tol``.
        Validated at 128² Re=1000 against the Ghia et al. profiles
        (benchmarks/lid_cavity_ghia_re1000.py)."""
        x = x0
        t = 0.0
        self.residual_history = []
        while t < t_max - 1e-12:
            span = min(chunk, t_max - t)
            x_prev = x
            x = self.solve_unsteady(dt, span, scheme=scheme, method=method,
                                    x0=x, tol=lin_tol, maxiter=maxiter)
            t += span
            if x_prev is not None:
                rate = max(
                    float(jnp.abs(a - c).max())
                    for a, c in zip(x[:2 * self.N], x_prev[:2 * self.N])
                ) / span
                self.residual_history.append(rate)
                if verbose:
                    print(f"marching t={t:.2f}: |du/dt|={rate:.3e}")
                if rate < tol:
                    break
        self.x = x
        return self.x
