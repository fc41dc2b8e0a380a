"""2D Stefan phase change with marker front tracking (the flagship solver).

Re-design of ``/root/reference/src/liquidmotionsolver/stefan.jl`` (1852 LoC)
with the front as a fixed-size marker array moving *inside jit*:

Per time step, a Gauss-Newton / Levenberg-Marquardt iteration over the
marker normal displacements d (stefan.jl:546-1091):

1. slab temperature solve with the space-time body interpolating the
   marker SDFs between the step-start front and the displaced front
   (stefan.jl:1058-1090);
2. per-cell interface flux ``Id Hᵀ Wꜝ (G Tω + H Tγ)`` (stefan.jl:560-571);
3. residual ``F_cell = ρL (V(t0)_cell - V(t1)_cell) - flux_cell``
   (stefan.jl:840-842, with the height-tracking slot convention our 1D
   solver validated against the analytic similarity solution), optionally
   3×3 stencil-fused (stefan.jl:588-785 — here a box-filter convolution);
4. volume Jacobian ∂F/∂d: **exact autodiff** of the cut-cell volumes
   through the capacity quadrature (jacfwd), replacing the reference's
   central finite differences of LibGEOS-clipped polygon areas
   (front_tracking.jl:635-802);
5. damped normal-equations solve ``(JᵀJ + λ diag) δ = Jᵀ F`` with LM λ
   adaptation (stefan.jl:875-941);
6. circular moving-average smoothing of d (stefan.jl:944-1018) and marker
   update along normals.

The entire time loop (geometry rebuilds included) is one jitted scan with a
``lax.while_loop`` GN/LM iteration inside.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..assembly import border_info
from ..capacity import (
    _BAND_DEFAULT_SAFETY,
    _is_traced,
    _round_budget,
    compute_capacity_spacetime,
    compute_cell_volumes,
)
from ..front_tracking import (
    polyline_curvature,
    polyline_normals,
    polyline_sdf,
    resample_markers,
    smooth_displacements,
)
from ..linsolve import HIGHEST
from .diffusion import _ScalarSolverBase
from .moving_diffusion import (
    _direct_solve,
    _eval_D,
    build_moving_mono_system,
    slice_spacetime,
    solve_moving_mono_step,
)

__all__ = ["StefanMono2D", "StefanDiph2D"]


def _st_marker_body(x, y, t, params):
    """Space-time SDF: linear-in-time interpolation of the marker SDFs
    between slab start and end (slab times [0, dt]); ``sign=-1`` tracks a
    fluid exterior to the polygon."""
    mk_a, mk_b, dt, sign = params
    phi_a = polyline_sdf(mk_a, x, y)
    phi_b = polyline_sdf(mk_b, x, y)
    return sign * ((dt - t) * phi_a + t * phi_b) / dt


def _sp_vol_body_pos(x, y, mk):
    return polyline_sdf(mk, x, y)


def _sp_vol_body_neg(x, y, mk):
    return -polyline_sdf(mk, x, y)


def _spatial_volumes(markers, mesh, sign, p, s, band_budget=None):
    """Cut-cell fluid volumes of the spatial grid for a marker polygon
    (cells only, padded grid).  Narrow-band when ``band_budget`` is set —
    the polyline SDF is O(n_markers)/sample, so skipping far-field samples
    is the dominant cost lever."""
    body = _sp_vol_body_pos if sign > 0 else _sp_vol_body_neg
    return compute_cell_volumes(body, mesh, p=p, s=s, params=markers,
                                band_budget=band_budget)


def _auto_band_budget(markers, mesh, dt, sign, band_budget, headroom=4):
    """Size the static narrow-band budget from the *initial* front
    (membership is traced per GN iteration; the budget cannot be).

    The count is geometric — cells within ~safety×diag of the polyline:
    perimeter/h × band width in cells (cross-checked against the exact
    nodal count from ``estimate_band_budget``: circle at 512², exact 3264
    vs geometric ~3600; the exact count would cost an eager full-grid
    polyline-SDF pass, which defeats the purpose).  ``headroom``× covers
    front growth over the run; overflow degrades to corner-sign full/empty
    far values."""
    if band_budget != "auto":
        return band_budget
    if _is_traced(markers):
        return None
    mk = np.asarray(markers)
    seg = np.roll(mk, -1, axis=0) - mk
    P = float(np.sum(np.hypot(seg[:, 0], seg[:, 1])))
    h = float(min(mesh.h[:2]))
    width = 2.0 * _BAND_DEFAULT_SAFETY * 1.5 + 3.0  # cells across the band
    count = max(int(P / h * width), 256)
    return _round_budget(headroom * count, mesh.ncells())


def _sticky_band_budget(solver, markers, mesh, dt, sign, band_budget):
    """Per-solver sticky budget: repeated solve() calls keep the previous
    (sufficient) budget so the compiled-loop cache stays hot — a freshly
    grown front crossing a power-of-two budget boundary would otherwise
    force a full ~minute recompile of the scan."""
    est = _auto_band_budget(markers, mesh, dt, sign, band_budget)
    prev = getattr(solver, "_band_budget", None)
    if (band_budget == "auto" and est is not None and prev is not None
            and est <= prev):
        est = prev
    if est is not None:
        solver._band_budget = est
    return est


def _cond_key(obj):
    """Value-based cache key for BC / interface-condition objects.  Object
    ids are unsafe (CPython reuses them after GC); holding the callables in
    the key tuple keeps identity-keyed entries alive."""
    if obj is None:
        return None
    vals = [type(obj).__name__]
    for fld in ("Tm", "eps_k", "eps_v", "alpha", "beta", "alpha1", "alpha2",
                "beta1", "beta2", "value"):
        v = getattr(obj, fld, None)
        if isinstance(v, (int, float)):
            vals.append((fld, float(v)))
        elif v is None or callable(v):
            vals.append((fld, v))
        else:  # array-valued: compare by content
            vals.append((fld, np.asarray(v).tobytes()))
    return tuple(vals)


def _ic_key(ic):
    return (_cond_key(getattr(ic, "scalar", None)),
            _cond_key(getattr(ic, "flux", None)))


def _box3_filter(F):
    """3x3 stencil fusion: each cell's residual becomes the sum over its
    3x3 neighborhood (stefan.jl get_stencil_cells, '3x3' strategy)."""
    out = F
    for ax in (0, 1):
        out = (
            out
            + jnp.pad(out, [(1, 0) if a == ax else (0, 0) for a in range(2)])[
                tuple(slice(0, -1) if a == ax else slice(None) for a in range(2))
            ]
            + jnp.pad(out, [(0, 1) if a == ax else (0, 0) for a in range(2)])[
                tuple(slice(1, None) if a == ax else slice(None) for a in range(2))
            ]
        )
    return out


class StefanMono2D(_ScalarSolverBase):
    """One-phase 2D Stefan solver with front tracking."""

    def __init__(self, phase, bc_b, bc_i, dt, u0, mesh, scheme="BE"):
        self.phase = phase
        self.bc_b = bc_b
        self.bc_i = bc_i
        self.dt = float(dt)
        self.u0 = u0
        self.mesh = mesh
        self.scheme = scheme
        self.border = border_info(mesh, bc_b)

    def solve(self, front, t_start, t_end, ic,
              newton_params=(30, 1e-6, 1e-6, 1.0),
              interior_fluid=True,
              method="auto", lin_tol=1e-9, lin_maxiter=400,
              lm_init_lambda=1e-4, lm_lambda_factor=10.0,
              lm_min_lambda=1e-10, lm_max_lambda=1e6,
              enable_stencil_fusion=True,
              smooth_window=5, smooth_passes=1,
              extrapolation_factor=0.8, max_disp_cells=0.5,
              jac="autodiff",
              p=4, s=1, jac_p=4, jac_s=1, band_budget="auto",
              capture_residual_field=False):
        """``front``: FrontTracker (markers define the *solid/fluid*
        polygon; ``interior_fluid`` chooses which side is the simulated
        phase).  Returns final temperature; marker history in
        ``self.marker_log``.

        Per-step telemetry (the moving-solver debugging surface the
        reference dumps as PNGs, src/vizualize_mov.jl + stefan.jl:845-859):
        ``self.residual_hist`` (n_steps, max_iter) — the GN residual of
        EVERY inner iteration (NaN-padded past convergence; feed to
        ``viz.plot_newton_rates`` / ``diagnostics.convergence_rates``);
        ``self.residual_log``/``iters_log``/``krylov_iters`` per step;
        ``capture_residual_field=True`` additionally records the final
        per-cell energy-residual GRID of each step in
        ``self.residual_fields`` (n_steps, *np_shape) for heatmap
        inspection (``viz.plot_residual_fields``).

        ``jac``: ``"autodiff"`` differentiates the cut-cell volume
        quadrature exactly (jacfwd, one JVP per marker); ``"intercept"``
        uses the analytic intercept Jacobian dV_cell/dd_i =
        sign/2 (|seg_{i-1} ∩ cell| + |seg_i ∩ cell|) — each marker carries
        half of its two adjacent segments (front_tracking.jl:2630-2678) —
        which is one Liang-Barsky clipping pass instead of nm quadrature
        JVPs (a large speedup for many markers at equal converged fronts
        on smooth interfaces)."""
        dt = self.dt
        K = int(np.ceil((t_end - t_start) / dt - 1e-12))
        max_iter, tol, reltol, alpha = newton_params
        max_iter = int(max_iter)
        rhoL = ic.flux.value
        sign = 1.0 if interior_fluid else -1.0
        D, f = self.phase.diffusion, self.phase.source
        bc_i, border, mesh, scheme = self.bc_i, self.border, self.mesh, self.scheme
        nm = front.markers.shape[0]

        from ..boundary import GibbsThomson

        gibbs = isinstance(bc_i, GibbsThomson)
        band_budget = _sticky_band_budget(self, front.markers, mesh, dt,
                                          sign, band_budget)

        def slab_solve(Told, mk_a, mk_b, t, Tguess=None):
            cap = compute_capacity_spacetime(
                _st_marker_body, mesh, 0.0, dt, p=p, s=s,
                params=(mk_a, mk_b, dt, sign), band_budget=band_budget,
            )
            g_override = None
            if gibbs:
                # Gibbs-Thomson: g = Tm - eps_k * kappa ± eps_v * v
                # with the cell-wise normal interface velocity recovered
                # from the slab volume change (reference feeds bc.vᵞ/κ from
                # the front motion, liquidmotionsolver/diffusion2d.jl:94-101)
                _, Va_, Vb_, G0_, _, Cg_ = slice_spacetime(cap)
                # ΔV/Γ0_st is NOT v: the space-time measure satisfies
                # Γ0 = dt·Γ_sp·sqrt(1+v²) while ΔV = dt·Γ_sp·v, so the
                # ratio is v/sqrt(1+v²); invert it to recover v exactly
                # (otherwise fast fronts saturate at |v|=1)
                v_r = (Vb_ - Va_) / jnp.where(G0_ > 0, G0_, 1.0)
                v_r = jnp.clip(jnp.where(G0_ > 0, v_r, 0.0), -0.999, 0.999)
                v_liq = v_r / jnp.sqrt(1.0 - v_r * v_r)
                # Kinetic term sign: v_liq > 0 is LIQUID growth (melting).
                # The solid-growth velocity is -v_liq, and kinetic
                # attachment resistance gives g = Tm - eps_v * v_solid
                # = Tm + eps_v * v_liq: undercooled while solidifying,
                # superheated while melting.  (The reference uses
                # Tm - eps_v*|v|, solver.jl:327, which would *superheat* a
                # solidifying front and destabilize it — verified on the
                # Frank disk: eps_v > 0 must SLOW growth.)
                g_override = bc_i.Tm + bc_i.eps_v * v_liq
                if bc_i.eps_k:
                    # per-cell curvature: nearest marker's discrete Menger
                    # curvature, looked up from the interface centroids.
                    # Gibbs-Thomson uses the SOLID's curvature (convex solid
                    # -> kappa > 0 -> depressed melting temperature): the
                    # polygon is the solid when the fluid is exterior
                    # (sign=-1), and the solid's curvature is the polygon's
                    # negative when the fluid is interior (sign=+1).
                    kap_m = -sign * polyline_curvature(mk_b)
                    d2 = jnp.sum(
                        (Cg_[..., None, :] - mk_b[None, None, :, :]) ** 2,
                        axis=-1,
                    )
                    kap_cell = kap_m[jnp.argmin(d2, axis=-1)]
                    kap_cell = jnp.where(G0_ > 0, kap_cell, 0.0)
                    g_override = g_override - bc_i.eps_k * kap_cell
            T, klv_it, klv_res = solve_moving_mono_step(
                cap, D, f, bc_i, border, Told, t, dt, scheme,
                tol=lin_tol, maxiter=lin_maxiter, g_override=g_override,
                method=method, x0=Tguess,
            )
            ops, Va, Vb, Gamma0, C_sp, _ = slice_spacetime(cap)
            Id = _eval_D(D, C_sp)
            q = ops.flux(T[0], T[1])
            flux = Id * ops.HT(q)
            return T, flux, Va, Vb, klv_it

        def residual(Told, mk_a, normals, d, t, Tguess=None):
            mk_b = mk_a + d[:, None] * normals
            T, flux, Va, Vb, klv_it = slab_solve(Told, mk_a, mk_b, t, Tguess)
            F = rhoL * (Va - Vb) - flux
            if enable_stencil_fusion:
                F = _box3_filter(F)
            return F, T, klv_it

        def vol_residual(d, mk_a, normals):
            """Volume part of F as a function of d only (for the Jacobian;
            the reference also freezes the temperature/flux when building
            J, stefan.jl:793-807)."""
            mk_b = mk_a + d[:, None] * normals
            Vb = _spatial_volumes(mk_b, mesh, sign, jac_p, jac_s,
                                  band_budget)
            F = -rhoL * Vb
            if enable_stencil_fusion:
                F = _box3_filter(F)
            return F.ravel()

        if jac == "intercept":
            from ..front_tracking import segment_cell_intersection_moments

            def jac_fn(d, mk_a, normals):
                # exact linear-tilt sensitivity: moving marker i sweeps the
                # triangle-weighted strips of its two adjacent segments —
                # weight t on incoming segment i-1 (i is its end), 1-t on
                # outgoing segment i (i is its start)
                mk_b = mk_a + d[:, None] * normals
                L0, L1 = segment_cell_intersection_moments(mesh, mk_b)
                Jm = jnp.roll(L1, 1, axis=2) + (L0 - L1)
                Jm = jnp.pad(Jm, [(0, mesh.np_shape[0] - Jm.shape[0]),
                               (0, mesh.np_shape[1] - Jm.shape[1]), (0, 0)])
                Jm = -rhoL * sign * Jm
                if enable_stencil_fusion:
                    Jm = jax.vmap(_box3_filter, in_axes=2, out_axes=2)(Jm)
                return Jm.reshape(-1, Jm.shape[-1])
        else:
            jac_fn = jax.jacfwd(vol_residual)
        max_disp = max_disp_cells * min(mesh.h[:2])

        def gn_step(Told, mk_a, d0, t):
            normals = polyline_normals(mk_a)

            def cond(st):
                d, T, Fg, hist, lam, prev_rn, rn, it, kit = st
                return (it < max_iter) & (rn > tol)

            def body(st):
                d, T, Fg, hist, lam, prev_rn, rn_old, it, kit = st
                # NOTE: deliberately NO warm start from the previous GN
                # iterate T here — it makes the slab solution a function of
                # the GN *path* instead of a deterministic function of d,
                # and the resulting flux noise (inner tol amplified by the
                # 1/h² flux extraction) stalls the GN at ~1e-2 residuals
                # (measured at 512²: cold 1.7 GN/step vs warm 8.4 = max_iter)
                F, Tn, klv_it = residual(Told, mk_a, normals, d, t)
                Fv = F.ravel()
                J = jac_fn(d, mk_a, normals)  # (ncells, nm)
                JTJ = jnp.matmul(J.T, J, precision=HIGHEST)
                diag = jnp.diagonal(JTJ)
                diag = jnp.maximum(diag, 1e-10 * jnp.max(diag))
                A = JTJ + lam * jnp.diag(diag)
                delta = jnp.linalg.solve(
                    A, jnp.matmul(J.T, Fv, precision=HIGHEST))
                # a non-finite LM step (singular J, diverged inner solve)
                # must not poison the markers: skip it, let λ adaptation
                # and the next residual recover
                delta = jnp.where(jnp.isfinite(delta), delta, 0.0)
                d_new = d - alpha * delta
                d_new = smooth_displacements(d_new, smooth_window, smooth_passes)
                d_new = jnp.clip(d_new, -max_disp, max_disp)
                rn = jnp.linalg.norm(Fv)
                hist = hist.at[it].set(rn)
                Fg_new = F if capture_residual_field else Fg
                lam_new = jnp.where(
                    rn < prev_rn,
                    jnp.maximum(lam / lm_lambda_factor, lm_min_lambda),
                    jnp.minimum(lam * lm_lambda_factor, lm_max_lambda),
                )
                lam_new = jnp.where(it == 0, lam, lam_new)
                return (d_new, Tn, Fg_new, hist, lam_new, rn, rn, it + 1,
                        kit + klv_it)

            hist0 = jnp.full((max_iter,), jnp.nan, d0.dtype)
            Fg0 = (jnp.zeros(mesh.np_shape, d0.dtype)
                   if capture_residual_field else jnp.zeros((), d0.dtype))
            init = (d0, Told, Fg0, hist0,
                    jnp.asarray(lm_init_lambda, d0.dtype),
                    jnp.asarray(jnp.inf, d0.dtype),
                    jnp.asarray(jnp.inf, d0.dtype), 0, 0)
            d, T, Fg, hist, lam, _, rn, it, kit = jax.lax.while_loop(
                cond, body, init)
            return d, T, Fg, hist, rn, it, kit

        @jax.jit
        def run(u0, markers0):
            d_zero = jnp.zeros(nm, markers0.dtype)

            def step(carry, k):
                T, mk, last_d = carry
                t = t_start + k * dt
                d0 = jnp.where(k > 0, extrapolation_factor * last_d, 0.0)
                d, Tn, Fg, hist, rn, it, kit = gn_step(T, mk, d0, t)
                normals = polyline_normals(mk)
                mk_new = resample_markers(mk + d[:, None] * normals)
                return (Tn, mk_new, d), (mk_new, rn, it, kit, hist, Fg)

            (Tf, mkf, _), (mk_log, rns, its, kits, hists, Fgs) = jax.lax.scan(
                step, (u0, markers0, d_zero), jnp.arange(K + 1.0)
            )
            return Tf, mkf, mk_log, rns, its, kits, hists, Fgs

        # cache the traced/compiled loop across solve() calls: run is a
        # fresh closure each call, so without this every solve retraces
        # the whole scan (tens of seconds at 256²) even though the device
        # time per GN iteration is ~36 ms.
        cache_key = (K, nm, t_start, self.dt, jac, method, p, s, jac_p,
                     jac_s, max_iter, tol, reltol, alpha, lin_tol,
                     lin_maxiter, enable_stencil_fusion, smooth_window,
                     smooth_passes, extrapolation_factor, max_disp_cells,
                     interior_fluid, lm_init_lambda, lm_lambda_factor,
                     band_budget, _ic_key(ic), _cond_key(self.bc_i),
                     capture_residual_field)
        if getattr(self, "_run_cache_key", None) == cache_key:
            run = self._run_cache
        else:
            self._run_cache = run
            self._run_cache_key = cache_key

        Tf, mkf, mk_log, rns, its, kits, hists, Fgs = run(self.u0,
                                                          front.markers)
        self.x = Tf
        self.markers = mkf
        self.marker_log = np.asarray(mk_log)
        self.residual_log = np.asarray(rns)
        self.iters_log = np.asarray(its)
        self.krylov_iters = np.asarray(kits)  # total Krylov its per step
        self.residual_hist = np.asarray(hists)  # (steps, max_iter), NaN-pad
        self.residual_fields = (np.asarray(Fgs)
                                if capture_residual_field else None)
        self.states = [Tf]
        front.markers = mkf
        return self.x

    def solve_geom(self, front, t_start, t_end, ic,
                   newton_params=(20, 1e-6, 1e-6, 0.8),
                   interior_fluid=True,
                   method="auto", lin_tol=1e-9, lin_maxiter=400,
                   smooth_window=11, smooth_passes=2,
                   extrapolation_factor=0.8, max_disp_cells=0.5,
                   p=4, s=1, band_budget="auto"):
        """Geometric front update (solve_StefanMono2D_geom!,
        stefan.jl:1135-1403): instead of the Gauss-Newton volume Jacobian,
        each iteration converts the per-cell energy residual
        ``F = ρL (Va - Vb) - flux`` directly into a cell displacement
        ``δ_cell = F / (ρL L_cell sign)`` (the 1-dof-per-cell Newton step
        with the exact geometric sensitivity ∂V/∂δ = ±L_cell), distributes
        it to interface segments weighted by segment∩cell intersection
        lengths (compute_geometric_segment_displacements,
        stefan.jl:180-247), and averages segments onto markers.  Cheaper
        than GN (no Jacobian assembly) at the cost of ignoring cross-cell
        coupling."""
        from ..front_tracking import segment_cell_intersections

        dt = self.dt
        K = int(np.ceil((t_end - t_start) / dt - 1e-12))
        max_iter, tol, reltol, alpha = newton_params
        max_iter = int(max_iter)
        rhoL = ic.flux.value
        sign = 1.0 if interior_fluid else -1.0
        D, f = self.phase.diffusion, self.phase.source
        bc_i, border, mesh, scheme = self.bc_i, self.border, self.mesh, self.scheme
        nm = front.markers.shape[0]
        nx, ny = mesh.n
        max_disp = max_disp_cells * min(mesh.h[:2])
        band_budget = _sticky_band_budget(self, front.markers, mesh, dt,
                                          sign, band_budget)

        def slab_solve(Told, mk_a, mk_b, t):
            cap = compute_capacity_spacetime(
                _st_marker_body, mesh, 0.0, dt, p=p, s=s,
                params=(mk_a, mk_b, dt, sign), band_budget=band_budget,
            )
            T, _klv_it, _klv_res = solve_moving_mono_step(
                cap, D, f, bc_i, border, Told, t, dt, scheme,
                tol=lin_tol, maxiter=lin_maxiter, method=method,
            )
            ops, Va, Vb, Gamma0, C_sp, _ = slice_spacetime(cap)
            Id = _eval_D(D, C_sp)
            q = ops.flux(T[0], T[1])
            flux = Id * ops.HT(q)
            return T, flux, Va, Vb

        def geom_displacements(mk_b, F_grid):
            """Per-cell residual -> per-marker normal displacement."""
            L = segment_cell_intersections(mesh, mk_b)  # (nx, ny, ns)
            Fc = F_grid[:nx, :ny]
            tot = L.sum(-1)
            D_cell = jnp.where(
                tot > 1e-12, Fc / (rhoL * jnp.maximum(tot, 1e-12) * sign), 0.0
            )
            seg_acc = jnp.einsum("xys,xy->s", L, D_cell, precision=HIGHEST)
            seg_w = L.sum((0, 1))
            seg_d = jnp.where(seg_w > 1e-12,
                              seg_acc / jnp.maximum(seg_w, 1e-12), 0.0)
            # segments -> markers: length-weighted average of the two
            # segments adjoining each marker (segment i starts at marker i)
            a, b = mk_b, jnp.roll(mk_b, -1, axis=0)
            w = jnp.maximum(jnp.linalg.norm(b - a, axis=-1), 1e-10)
            wd = w * seg_d
            return (wd + jnp.roll(wd, 1)) / (w + jnp.roll(w, 1))

        def geom_step(Told, mk_a, d0, t):
            normals = polyline_normals(mk_a)

            def cond(st):
                d, T, inc, it = st
                return (it < max_iter) & (inc > tol)

            def body(st):
                d, T, _, it = st
                mk_b = mk_a + d[:, None] * normals
                Tn, flux, Va, Vb = slab_solve(Told, mk_a, mk_b, t)
                F = rhoL * (Va - Vb) - flux
                d_inc = alpha * geom_displacements(mk_b, F)
                d_inc = smooth_displacements(d_inc, smooth_window,
                                             smooth_passes)
                d_new = jnp.clip(d + d_inc, -max_disp, max_disp)
                return (d_new, Tn, jnp.linalg.norm(d_inc), it + 1)

            init = (d0, Told, jnp.asarray(jnp.inf, d0.dtype), 0)
            d, T, inc, it = jax.lax.while_loop(cond, body, init)
            return d, T, inc, it

        @jax.jit
        def run(u0, markers0):
            d_zero = jnp.zeros(nm, markers0.dtype)

            def step(carry, k):
                T, mk, last_d = carry
                t = t_start + k * dt
                d0 = jnp.where(k > 0, extrapolation_factor * last_d, 0.0)
                d, Tn, inc, it = geom_step(T, mk, d0, t)
                normals = polyline_normals(mk)
                mk_new = resample_markers(mk + d[:, None] * normals)
                return (Tn, mk_new, d), (mk_new, inc, it)

            (Tf, mkf, _), (mk_log, incs, its) = jax.lax.scan(
                step, (u0, markers0, d_zero), jnp.arange(K + 1.0)
            )
            return Tf, mkf, mk_log, incs, its

        Tf, mkf, mk_log, incs, its = run(self.u0, front.markers)
        self.x = Tf
        self.markers = mkf
        self.marker_log = np.asarray(mk_log)
        self.residual_log = np.asarray(incs)
        self.iters_log = np.asarray(its)
        self.states = [Tf]
        front.markers = mkf
        return self.x


class StefanDiph2D(_ScalarSolverBase):
    """Two-phase 2D Stefan with front tracking (reference StefanDiph2D,
    stefan.jl:1404-1852): the marker GN/LM loop of StefanMono2D driving the
    _stef diphasic slab system; the residual sums both phases' interface
    fluxes:  F = ρL (V1(t0) - V1(t1)) - (flux1 + flux2)."""

    def __init__(self, phase1, phase2, bc_b, ic, dt, u0, mesh, scheme="BE"):
        self.phase1, self.phase2 = phase1, phase2
        self.bc_b = bc_b
        self.ic = ic
        self.dt = float(dt)
        self.u0 = u0
        self.mesh = mesh
        self.scheme = scheme

    def solve(self, front, t_start, t_end,
              newton_params=(12, 1e-4, 1e-6, 1.0),
              interior_phase1=True,
              latent_sign=1.0,
              method="auto", lin_tol=1e-9, lin_maxiter=800,
              lm_init_lambda=1e-4, lm_lambda_factor=10.0,
              lm_min_lambda=1e-10, lm_max_lambda=1e6,
              enable_stencil_fusion=True,
              smooth_window=5, smooth_passes=1,
              extrapolation_factor=0.8, max_disp_cells=0.5,
              jac="autodiff",
              p=4, s=1, jac_p=4, jac_s=1, band_budget="auto"):
        """``latent_sign``: +1 when phase-1 growth *absorbs* latent heat
        (melting into phase 1, the 1D reference bookkeeping), -1 when
        phase-1 growth *releases* it (solidification, e.g. Frank disk)."""
        from ..assembly import border_info
        from .moving_diffusion import (
            _eval_D as evD,
            solve_moving_diph_stef_step,
        )

        dt = self.dt
        K = int(np.ceil((t_end - t_start) / dt - 1e-12))
        max_iter, tol, reltol, alpha = newton_params
        max_iter = int(max_iter)
        rhoL = self.ic.flux.value
        sign = 1.0 if interior_phase1 else -1.0
        mesh, scheme, ic, bc_b = self.mesh, self.scheme, self.ic, self.bc_b
        D1, f1 = self.phase1.diffusion, self.phase1.source
        D2, f2 = self.phase2.diffusion, self.phase2.source
        nm = front.markers.shape[0]
        band_budget = _sticky_band_budget(self, front.markers, mesh, dt,
                                          sign, band_budget)

        def slab_solve(Xold, mk_a, mk_b, t, Xguess=None):
            cap1 = compute_capacity_spacetime(
                _st_marker_body, mesh, 0.0, dt, p=p, s=s,
                params=(mk_a, mk_b, dt, sign), band_budget=band_budget)
            cap2 = compute_capacity_spacetime(
                _st_marker_body, mesh, 0.0, dt, p=p, s=s,
                params=(mk_a, mk_b, dt, -sign), band_budget=band_budget)
            b1m = border_info(mesh, bc_b, phase_mask=cap1.cell_types[..., 0] != 0)
            b2m = border_info(mesh, bc_b, phase_mask=cap2.cell_types[..., 0] != 0)
            X, _klv_it, _klv_res = solve_moving_diph_stef_step(
                cap1, cap2, D1, D2, f1, f2, ic, b1m, b2m, Xold, t, dt,
                scheme, tol=lin_tol, maxiter=lin_maxiter, method=method,
                x0=Xguess)
            s1 = slice_spacetime(cap1)
            s2 = slice_spacetime(cap2)
            Id1 = evD(D1, s1[4])
            Id2 = evD(D2, s2[4])
            flux1 = Id1 * s1[0].HT(s1[0].flux(X[0], X[1]))
            flux2 = Id2 * s2[0].HT(s2[0].flux(X[2], X[3]))
            F = latent_sign * rhoL * (s1[1] - s1[2]) - (flux1 + flux2)
            if enable_stencil_fusion:
                F = _box3_filter(F)
            return X, F

        def vol_residual(d, mk_a, normals):
            mk_b = mk_a + d[:, None] * normals
            Vb = _spatial_volumes(mk_b, mesh, sign, jac_p, jac_s,
                                  band_budget)
            F = -latent_sign * rhoL * Vb
            if enable_stencil_fusion:
                F = _box3_filter(F)
            return F.ravel()

        if jac == "intercept":
            from ..front_tracking import segment_cell_intersection_moments

            def jac_fn(d, mk_a, normals):
                # analytic linear-tilt sensitivity (see StefanMono2D.solve)
                mk_b = mk_a + d[:, None] * normals
                L0, L1 = segment_cell_intersection_moments(mesh, mk_b)
                Jm = jnp.roll(L1, 1, axis=2) + (L0 - L1)
                Jm = jnp.pad(Jm, [(0, mesh.np_shape[0] - Jm.shape[0]),
                               (0, mesh.np_shape[1] - Jm.shape[1]), (0, 0)])
                Jm = -latent_sign * rhoL * sign * Jm
                if enable_stencil_fusion:
                    Jm = jax.vmap(_box3_filter, in_axes=2, out_axes=2)(Jm)
                return Jm.reshape(-1, Jm.shape[-1])
        else:
            jac_fn = jax.jacfwd(vol_residual)
        max_disp = max_disp_cells * min(mesh.h[:2])

        def gn_step(Xold, mk_a, d0, t):
            normals = polyline_normals(mk_a)

            def cond(st):
                d, X, lam, prev_rn, rn, it = st
                return (it < max_iter) & (rn > tol)

            def body(st):
                d, X, lam, prev_rn, rn_old, it = st
                mk_b = mk_a + d[:, None] * normals
                # no warm start from X: see StefanMono2D (GN determinism)
                Xn, F = slab_solve(Xold, mk_a, mk_b, t)
                Fv = F.ravel()
                J = jac_fn(d, mk_a, normals)
                JTJ = jnp.matmul(J.T, J, precision=HIGHEST)
                diag = jnp.maximum(jnp.diagonal(JTJ),
                                   1e-10 * jnp.max(jnp.diagonal(JTJ)))
                delta = jnp.linalg.solve(JTJ + lam * jnp.diag(diag),
                                        jnp.matmul(J.T, Fv, precision=HIGHEST))
                delta = jnp.where(jnp.isfinite(delta), delta, 0.0)
                d_new = smooth_displacements(d - alpha * delta, smooth_window,
                                             smooth_passes)
                d_new = jnp.clip(d_new, -max_disp, max_disp)
                rn = jnp.linalg.norm(Fv)
                lam_new = jnp.where(rn < prev_rn,
                                    jnp.maximum(lam / lm_lambda_factor, lm_min_lambda),
                                    jnp.minimum(lam * lm_lambda_factor, lm_max_lambda))
                lam_new = jnp.where(it == 0, lam, lam_new)
                return (d_new, Xn, lam_new, rn, rn, it + 1)

            init = (d0, Xold, jnp.asarray(lm_init_lambda, d0.dtype),
                    jnp.asarray(jnp.inf, d0.dtype),
                    jnp.asarray(jnp.inf, d0.dtype), 0)
            d, X, lam, _, rn, it = jax.lax.while_loop(cond, body, init)
            return d, X, rn, it

        @jax.jit
        def run(u0, markers0):
            d_zero = jnp.zeros(nm, markers0.dtype)

            def stepf(carry, k):
                X, mk, last_d = carry
                t = t_start + k * dt
                d0 = jnp.where(k > 0, extrapolation_factor * last_d, 0.0)
                d, Xn, rn, it = gn_step(X, mk, d0, t)
                normals = polyline_normals(mk)
                mk_new = resample_markers(mk + d[:, None] * normals)
                return (Xn, mk_new, d), (mk_new, rn, it)

            (Xf, mkf, _), (mk_log, rns, its) = jax.lax.scan(
                stepf, (u0, markers0, d_zero), jnp.arange(K + 1.0))
            return Xf, mkf, mk_log, rns, its

        Xf, mkf, mk_log, rns, its = run(self.u0, front.markers)
        self.x = Xf
        self.markers = mkf
        self.marker_log = np.asarray(mk_log)
        self.residual_log = np.asarray(rns)
        self.iters_log = np.asarray(its)
        self.states = [Xf]
        front.markers = mkf
        return self.x
