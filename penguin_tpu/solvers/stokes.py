"""Monolithic cut-cell Stokes solver (steady + unsteady θ-scheme).

Re-design of ``/root/reference/src/solver/stokes.jl`` (1652 LoC).  Unknowns
per velocity component live on staggered component meshes (offset −h/2
along their own axis); the state is the pytree
``(uω_0, uγ_0, ..., uω_{N-1}, uγ_{N-1}, p)`` on the shared padded grid.

Matrix-free blocks (stokes2D_blocks, stokes.jl:122-178):

- momentum d: ``Iμ_d GᵀWꜝG uω_d + Iμ_d GᵀWꜝH uγ_d  - A^p_d Dm_d(p)``
  (the pressure-gradient block is ``-(Gp+Hp)`` row-sliced, which collapses
  to ``-A^p_d ⊙ Dm_d`` since G+H = A·Dm on diagonals; note the reference's
  sign convention stores p = -p_physical, kept here for parity);
- tie rows: ``uγ_d = g_cut`` (identity);
- continuity: ``Σ_d [-DmTd(A^p_d uω_d) + DmTd(A^p_d uγ_d) - B^p_d DmTd(uγ_d)]``;
- velocity Dirichlet/Symmetry/Outflow/Periodic border surgery on both uω
  and uγ rows (apply_velocity_dirichlet_2D!, stokes.jl:867-1471) — note
  Stokes borders use the standard axis naming (left/right = x extremes),
  unlike the scalar solvers' legacy mapping;
- pressure gauge: pin one wet DOF or impose volume-weighted zero mean
  (stokes.jl:1472-1510).

Unsteady θ-scheme: ``(ρV/dt) u' + θ·visc(u') + grad p' = (ρV/dt) u -
(1-θ)·visc(u) + load`` — the *physical* sign used by the reference's
Navier-Stokes assembly (navierstokes.jl:540); its Stokes-only unsteady path
carries a sign slip (stokes.jl:648 uses ``-θ visc``) that we do not copy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from ..assembly import (
    coefficient_diag,
    eval_condition_value,
    _col_G_nz,
    _col_H_nz,
)
from ..boundary import Dirichlet, Neumann, Outflow, Periodic, Symmetry, Traction
from ..linsolve import HIGHEST, DenseFactorSolver, solve_linear, vdot
from ..operators import dm, dm_t, _shift_p, _shift_m

__all__ = ["StokesMono", "PinPressureGauge", "MeanPressureGauge",
           "VelocityBorder", "stokes_divergence"]


@dataclasses.dataclass(frozen=True)
class PinPressureGauge:
    index: object = None


@dataclasses.dataclass(frozen=True)
class MeanPressureGauge:
    pass


_AXIS_KEYS = {
    "left": (0, 0), "right": (0, 1),
    "bottom": (1, 0), "top": (1, 1),
    "backward": (2, 0), "forward": (2, 1),
}
_AXIS_KEYS_1D = {"bottom": (0, 0), "top": (0, 1), "left": (0, 0), "right": (0, 1)}


class VelocityBorder:
    """Border surgery for one velocity component (applied to both uω and uγ
    rows).  ``comp``: which velocity component this mesh carries.

    ``wall_row="ghost"`` replaces the first-cell-center Dirichlet row with
    a linearly extrapolated *wall-face* row (VERDICT round-1 item 4): for
    a tangential component the DOF line sits h/2 inside the wall, so the
    Dirichlet row becomes ``1.5 u₀ − 0.5 u₁ = g(wall)``; the normal
    component on the high side sits a full h inside, giving
    ``2 u_{n-1} − u_{n-2} = g(wall)``.  This moves the wall-placement
    error from O(h) to O(h²) and is what closes the Ghia profile gap
    (benchmark/navierstokes/ghia/*.ghia)."""

    def __init__(self, mesh_comp, bc: "BorderConditions", comp: int,
                 wall_row: str = "center"):
        self.items = []
        self.ghost = wall_row == "ghost"
        N = mesh_comp.ndim
        shape = mesh_comp.np_shape
        keymap = _AXIS_KEYS_1D if N == 1 else _AXIS_KEYS
        # DOF-position arrays over the full padded grid: border rows must
        # evaluate their Dirichlet data AT the DOF (cell-centroid)
        # positions, nodes[d] + h/2.  Evaluating at the nodes (pre-round-4
        # behaviour) offset every non-constant profile by half a cell
        # along every axis — measured as a one-index shift of the inlet
        # tensor-parabola on the 3D duct and an O(h) inflow bias on the
        # DFG channel.
        pos = []
        for d in range(N):
            c = np.zeros(shape[d])
            nd = mesh_comp.n[d] + 1
            c[:nd] = np.asarray(mesh_comp.nodes[d]) + 0.5 * mesh_comp.h[d]
            c[nd:] = c[nd - 1]
            shp = [1] * N
            shp[d] = shape[d]
            pos.append(jnp.asarray(np.broadcast_to(c.reshape(shp), shape)))
        self.pos = pos
        self.mesh_comp = mesh_comp
        for key, cond in bc.borders:
            if key not in keymap:
                continue
            if isinstance(cond, Periodic):
                # Periodic is an OPERATOR property, not row surgery: build
                # the component operators with make_diffusion_ops(cap,
                # periodic=...) and the wrap rows stay real momentum
                # equations.  Surgered wrap ties orphan near-wall pressure
                # modes (velocity-carrying null space) — verified against
                # the body-force periodic channel, which is exact to the
                # staggered wall placement without surgery.
                continue
            axis, side = keymap[key]
            if axis >= N:
                continue
            if isinstance(cond, Outflow) and axis == comp:
                # Normal component at an open boundary: KEEP the momentum
                # row.  The staggered comp-mesh ends half a cell inside the
                # domain, so its edge W slot is structurally zero — the
                # natural truncation already imposes zero diffusive normal
                # flux (the do-nothing condition) — and the through-flow
                # rate is then set by momentum + the prescribed outflow
                # pressure plane (StokesMono.__init__).  Replacing this row
                # with ``u_b − u_{b−1} = 0`` (as for the tangential
                # component) leaves the flow rate appearing in NO momentum
                # row: combined with the one-cell pressure pin it produced
                # an exact through-flow null mode (mass loss, SVD-verified
                # on the 16×8 inflow channel).
                continue
            n_real = mesh_comp.n[axis]
            idx = 0 if side == 0 else n_real - 1
            mask = np.zeros(shape, dtype=bool)
            sl = [slice(None)] * N
            sl[axis] = idx
            mask[tuple(sl)] = True
            self.items.append((key, cond, axis, side, comp, jnp.asarray(mask)))
        self.h = mesh_comp.h

    def _ghost_coefs(self, axis, side, comp):
        """(c0, c1) of the extrapolated wall row c0·u_b + c1·u_inner = g;
        None when the DOF already sits on the wall."""
        if comp == axis:
            return None if side == 0 else (2.0, -1.0)
        return (1.5, -0.5)

    def matvec(self, yw, yg, uw, ug):
        for key, cond, axis, side, comp, mask in self.items:
            if isinstance(cond, Dirichlet):
                coefs = self._ghost_coefs(axis, side, comp) if self.ghost \
                    else None
                if coefs is not None:
                    c0, c1 = coefs
                    nb_w = _shift_p(uw, axis) if side == 0 else _shift_m(uw, axis)
                    yw = jnp.where(mask, c0 * uw + c1 * nb_w, yw)
                else:
                    yw = jnp.where(mask, uw, yw)
                yg = jnp.where(mask, ug, yg)
            elif isinstance(cond, Symmetry):
                if comp == axis:  # normal component: u = 0
                    yw = jnp.where(mask, uw, yw)
                    yg = jnp.where(mask, ug, yg)
                else:  # tangential: zero gradient
                    nb_w = _shift_p(uw, axis) if side == 0 else _shift_m(uw, axis)
                    nb_g = _shift_p(ug, axis) if side == 0 else _shift_m(ug, axis)
                    yw = jnp.where(mask, uw - nb_w, yw)
                    yg = jnp.where(mask, ug - nb_g, yg)
            elif isinstance(cond, Outflow):
                nb_w = _shift_p(uw, axis) if side == 0 else _shift_m(uw, axis)
                nb_g = _shift_p(ug, axis) if side == 0 else _shift_m(ug, axis)
                yw = jnp.where(mask, uw - nb_w, yw)
                yg = jnp.where(mask, ug - nb_g, yg)
            elif isinstance(cond, Neumann):
                nb_w = _shift_p(uw, axis) if side == 0 else _shift_m(uw, axis)
                yw = jnp.where(mask, (uw - nb_w) / self.h[axis], yw)
        return yw, yg

    def _wall_pos(self, axis, side, comp):
        """Positions with the border-axis coordinate snapped to the exact
        wall face (ghost rows impose the value *at the wall*)."""
        m = self.mesh_comp
        n = m.n[axis]
        wall = float(m.nodes[axis][0] if side == 0 else m.nodes[axis][n])
        if comp == axis:  # this mesh is offset -h/2 along its own axis
            wall += 0.5 * m.h[axis]
        pos = list(self.pos)
        pos[axis] = jnp.full_like(pos[axis], wall)
        return pos

    def rhs(self, bw, bg, t=None):
        for key, cond, axis, side, comp, mask in self.items:
            if isinstance(cond, Dirichlet):
                ghost = self.ghost and \
                    self._ghost_coefs(axis, side, comp) is not None
                p = self._wall_pos(axis, side, comp) if ghost else self.pos
                val = eval_condition_value(cond.value, p, t)
                bw = jnp.where(mask, val, bw)
                bg = jnp.where(mask, val, bg)
            elif isinstance(cond, Symmetry):
                bw = jnp.where(mask, 0.0, bw)
                bg = jnp.where(mask, 0.0, bg)
            elif isinstance(cond, Outflow):
                bw = jnp.where(mask, 0.0, bw)
                bg = jnp.where(mask, 0.0, bg)
            elif isinstance(cond, Neumann):
                val = eval_condition_value(cond.value, self.pos, t)
                bw = jnp.where(mask, val, bw)
        return bw, bg


def stokes_divergence(fluid, uws, ugs):
    """Continuity residual Σ_d div_d (matrix-free)."""
    opp = fluid.operator_p
    N = len(uws)
    out = 0.0
    for d in range(N):
        Ap = opp.A[d]
        Bp = opp.B[d]
        per = opp._per(d)
        out = (out - dm_t(Ap * uws[d], d, per) + dm_t(Ap * ugs[d], d, per)
               - Bp * dm_t(ugs[d], d, per))
    return out


class StokesMono:
    """Fully coupled steady/unsteady Stokes."""

    def __init__(self, fluid, bc_u, pressure_gauge=None, bc_cut=None,
                 wall_row="center", cut_row="center", cut_flux="auto"):
        self.fluid = fluid
        self.bc_u = bc_u if isinstance(bc_u, tuple) else (bc_u,)
        self.gauge = pressure_gauge or PinPressureGauge()
        self.bc_cut = bc_cut or Dirichlet(0.0)
        # bc_cut may be one condition for all velocity components or a
        # per-component tuple (e.g. a rotating wall: uγ_x = -Ω y, uγ_y = Ω x)
        N = fluid.ndim
        self.N = N
        # ``cut_flux="moment"``: moment-consistent cut viscous flux —
        # (a) wet-line cross-moment sampling of B·u in G/Gᵀ (operators
        # rebuilt with cross_moment=True) and (b) the uγ boundary term
        # evaluated at the per-axis per-half-strip n_d-weighted Γ centroids
        # instead of C_ga (a pure RHS correction, see _gamma_moment_rhs).
        # Together they make the cut flux exact for linear velocity fields,
        # fixing the O(h) immersed-wall placement the reference shares
        # (src/solver/stokes.jl:122-178).  Requires capacities built with
        # ``cut_moments=True`` (the compute_capacity default for static
        # N>=2 geometry since round 5).
        # ``"auto"`` (default): "moment" whenever the capacities carry the
        # moments and the cut condition is Dirichlet-like; "centroid" is
        # the reference-parity fallback (Traction rows, space-time /
        # moving capacities built without moments, 1D).
        if cut_flux == "auto":
            cut_flux = ("moment"
                        if (not isinstance(self._cut(0), Traction)
                            and N >= 2
                            and all(fluid.capacity_u[d].Bm is not None
                                    for d in range(N)))
                        else "centroid")
        self.cut_flux = cut_flux
        self._ghm = None
        self._ghm_p = None
        self._divw = None
        if cut_flux == "moment" and isinstance(self._cut(0), Traction):
            raise ValueError("cut_flux='moment' supports Dirichlet cut "
                             "conditions only (not Traction); the 'auto' "
                             "default falls back to 'centroid' for "
                             "Traction rows")
        if cut_flux == "moment":
            from ..capacity import gamma_half_moments
            from ..operators import make_diffusion_ops as _mkops
            if any(fluid.capacity_u[d].Bm is None for d in range(N)):
                raise ValueError(
                    "cut_flux='moment' needs capacities built with "
                    "compute_capacity(..., cut_moments=True)")
            new_ops = tuple(
                (_mkops(fluid.capacity_u[d],
                        periodic=fluid.operator_u[d].periodic,
                        cross_moment=True)
                 if fluid.operator_u[d].Xw is None else fluid.operator_u[d])
                for d in range(N))
            self.fluid = fluid = dataclasses.replace(fluid,
                                                     operator_u=new_ops)
            self._ghm = tuple(gamma_half_moments(fluid.capacity_u[d])
                              for d in range(N))
            self._ghm_p = (gamma_half_moments(fluid.capacity_p)
                           if fluid.capacity_p.Bm is not None else None)
            # divergence/pressure-gradient cross-moment pair: continuity
            # samples A^p_d·uω_d at the full-face centre, but the exact
            # mass flux needs u at the WET-face centroid Am^p — the u_d
            # DOF (cell centre of the staggered component mesh) coincides
            # with the p-face centre only for uncut cells.  Correction
            # P^A(u) = A·u + A·(δ·∇u), δ = Am^p[d] − C_om^{u_d}, with the
            # same LSQ gradients (on the component-d capacity); the
            # pressure gradient uses the exact adjoint so the saddle
            # point stays symmetric.  This is the pressure-drag half of
            # the moment closure (γ mass placement is _cont_moment_rhs).
            self._divw = None
            if self._ghm_p is not None:
                from ..operators import _LsqGradient
                cap_p = fluid.capacity_p
                divw = []
                for d in range(N):
                    cap_u = fluid.capacity_u[d]
                    lsq = _LsqGradient(cap_u)
                    delta = cap_p.Am[d] - cap_u.C_om
                    hmax = jnp.asarray(max(float(v)
                                           for v in fluid.mesh_p.h),
                                       delta.dtype)
                    delta = jnp.clip(delta, -hmax, hmax)
                    # active only where the face is partially wet or the
                    # u-cell is cut; elsewhere δ is quadrature noise
                    face_cut = (cap_p.cell_types == -1) | \
                        (cap_u.cell_types == -1)
                    delta = jnp.where(face_cut[..., None], delta, 0.0)
                    delta = delta * cap_p.A[d][..., None]
                    divw.append(lsq.weights_for(delta))
                self._divw = tuple(divw)
        self.mu_diag = tuple(
            coefficient_diag(fluid.mu, fluid.capacity_u[d]) for d in range(N)
        )
        self.rho_diag = tuple(
            coefficient_diag(fluid.rho, fluid.capacity_u[d]) for d in range(N)
        )
        self.borders = tuple(
            VelocityBorder(fluid.mesh_u[d], self.bc_u[d], d,
                           wall_row=wall_row) for d in range(N)
        )
        # activity masks (zero-row/col elimination): padding and dry DOFs
        # become identity rows, mirroring remove_zero_rows_cols!
        self.u_active = tuple(
            jnp.asarray(
                _col_G_nz(fluid.operator_u[d]) | (fluid.operator_u[d].V != 0)
            )
            for d in range(N)
        )
        # Gibou-style one-sided ghost rows for badly-cut momentum DOFs
        # (opt-in, static geometry) — built BEFORE the orphan-pressure
        # elimination because a replaced momentum row no longer carries
        # its pressure-gradient column.  See _build_ghost_cut_rows.
        self.traction = isinstance(self._cut(0), Traction)
        self._ghost = (None,) * N
        if cut_row == "ghost" and not self.traction:
            self._ghost = self._build_ghost_cut_rows()

        p_act = np.asarray(
            _col_G_nz(fluid.operator_p) | (fluid.operator_p.V != 0)
        )
        # saddle-point orphan-pressure elimination (the reference's
        # remove_zero_rows_cols!, src/solver.jl:59-78, drops pressure DOFs
        # whose column is structurally zero): p[j] feeds momentum-d rows j
        # (coef Ap_d[j]) and j+1 (coef Ap_d[j+1]); rows replaced by border
        # surgery or masked inactive don't count.  Without this the last
        # row/column of pressure cells is a null space that breaks Krylov
        # (direct/lstsq silently repaired it via the dense zero-row fix).
        p_feeds = np.zeros(p_act.shape, bool)
        for d in range(N):
            live = np.asarray(self.u_active[d])
            for item in self.borders[d].items:
                live = live & ~np.asarray(item[5])
            if self._ghost[d] is not None:
                live = live.copy()
                live.ravel()[np.asarray(self._ghost[d]["gpos"])] = False
            c = (np.asarray(fluid.operator_p.A[d]) != 0) & live
            cp = np.zeros_like(c)
            sl_dst = [slice(None)] * c.ndim
            sl_src = [slice(None)] * c.ndim
            sl_dst[d] = slice(0, -1)
            sl_src[d] = slice(1, None)
            cp[tuple(sl_dst)] = c[tuple(sl_src)]
            p_feeds |= c | cp
        self.p_active = jnp.asarray(p_act & p_feeds)
        # Traction cut-BC: the uγ tie rows become traction-balance rows
        # (the reference's traction test expects
        # [Iμ HᵀWꜝG, Iμ HᵀWꜝH, -Hp] rows, test/solver/traction_test.jl;
        # its own assembly helper is absent from src, so this implements
        # the documented row).  self.traction set above (ghost build).
        if self.traction:
            self.trac_active = tuple(
                jnp.asarray(_col_H_nz(fluid.operator_u[d])) for d in range(N)
            )
        # Outflow(pressure): a prescribed reference pressure is imposed on
        # the border pressure cells (reference Outflow,
        # /root/reference/src/boundary.jl:60-74); without a value the
        # pressure stays free (zero-gradient velocity rows only)
        p_shape = fluid.capacity_p.V.shape
        keymap = _AXIS_KEYS_1D if N == 1 else _AXIS_KEYS
        out_mask = np.zeros(p_shape, bool)
        out_vals = np.zeros(p_shape)
        pos_p = []
        for d in range(N):
            c = np.zeros(p_shape[d])
            c[: fluid.mesh_p.n[d]] = np.asarray(fluid.mesh_p.centers[d])
            shp = [1] * N
            shp[d] = p_shape[d]
            pos_p.append(np.broadcast_to(c.reshape(shp), p_shape))
        for bc_i_, bc in enumerate(self.bc_u):
            for key, cond in bc.borders:
                if not isinstance(cond, Outflow):
                    continue
                if key not in keymap:
                    continue
                axis, side = keymap[key]
                if axis >= N or axis != bc_i_:
                    continue
                # Prescribe the pressure on the WHOLE outflow plane (the
                # standard staggered pressure-outlet closure; reference
                # Outflow, src/boundary.jl:60-74, default level 0).  The
                # plane's continuity rows become p = p_ref; the last
                # interior normal-velocity momentum row (kept real — see
                # VelocityBorder) then sets the through-flow rate.  A
                # single-cell reference pin is NOT enough: in an open
                # system every continuity row is independent, so deleting
                # one (pin or gauge) creates an exact through-flow null
                # mode — mass entered at the pinned cell and left through
                # the outlet (SVD on the 16×8 channel: σ_min = 7e-16,
                # station fluxes of the null mode uniform past the pin).
                # The plane nearest the border that holds active pressure
                # DOFs is used (the border plane itself can be dry).
                n_ax = fluid.mesh_p.n[axis]
                step = 1 if side == 0 else -1
                start = 0 if side == 0 else n_ax - 1
                m = np.zeros(p_shape, bool)
                for idx in range(start, start + step * n_ax, step):
                    sl = [slice(None)] * N
                    sl[axis] = idx
                    m = np.zeros(p_shape, bool)
                    m[tuple(sl)] = True
                    m &= np.asarray(self.p_active)
                    if m.any():
                        break
                if not m.any():
                    continue
                # Outflow(pressure=...) prescribes the PHYSICAL pressure;
                # the state stores -p_physical (hydrostatic balance test:
                # dp_state = -h f), so the plane rows pin -value.
                val = cond.pressure
                if callable(val):
                    v = -np.asarray(eval_condition_value(
                        val, [jnp.asarray(q) for q in pos_p]))
                elif val is not None:
                    v = -float(val) * np.ones(p_shape)
                else:
                    v = np.zeros(p_shape)
                out_vals = np.where(m, v, out_vals)
                out_mask |= m
        if out_mask.any():
            # the outflow pin fixes the pressure level only of its own
            # connected fluid region; with disconnected regions (and the
            # gauge disabled below) the others would keep a free constant
            # mode — gauge-pin one cell of each at level 0
            from scipy import ndimage
            lab, nlab = ndimage.label(np.asarray(self.p_active))
            pinned = set(np.unique(lab[out_mask & (lab > 0)]).tolist())
            for comp in range(1, nlab + 1):
                if comp in pinned:
                    continue
                cells = np.flatnonzero((lab == comp).ravel())
                m1 = np.zeros(p_shape, bool)
                m1.ravel()[cells[cells.size // 2]] = True
                out_mask |= m1  # out_vals stays 0 there (gauge level)
        self.outflow_p_mask = jnp.asarray(out_mask) if out_mask.any() else None
        self.outflow_p_vals = jnp.asarray(out_vals)

        # pressure gauge bookkeeping (static); a prescribed Outflow
        # pressure already fixes the pressure level, so no gauge row then
        Vp = np.asarray(fluid.capacity_p.V)
        if self.outflow_p_mask is not None:
            self.pin_mask = None
            self.pin_idx = None
            self.mean_w = None
        elif isinstance(self.gauge, PinPressureGauge):
            idx = self.gauge.index
            if idx is None:
                # pin the first wet *active* cell (an orphan-pressure pin
                # would leave the active block's constant mode unpinned)
                wet = (Vp > 1e-12) & np.asarray(self.p_active)
                flatF = wet.ravel(order="F")  # reference scans x-fastest
                k = int(np.argmax(flatF)) if flatF.any() else 0
                idx = np.unravel_index(k, Vp.shape, order="F")
            self.pin_idx = tuple(int(v) for v in idx)
            pin = np.zeros(Vp.shape, bool)
            pin[self.pin_idx] = True
            self.pin_mask = jnp.asarray(pin)
            self.mean_w = None
        else:
            w = Vp.copy()
            if np.allclose(w, 0.0):
                w[:] = 1.0
            self.mean_w = jnp.asarray(w / w.sum())
            self.pin_mask = None

    # ------------------------------------------------------------------
    def _build_ghost_cut_rows(self, frac_max=0.5):
        """For each velocity component, precompute (host-side, static
        geometry) the replacement row data for cut cells with wet fraction
        < ``frac_max``:  u_c − θ·I(u)(x_f) = (1−θ)·u_wall(x_w), where x_w
        is the wall foot point of the DOF centroid, x_f a probe point
        1.5–3 h into the fluid along the inward normal, I bilinear
        interpolation from trusted cells, θ = d_c/d_f the distance ratio."""
        out = []
        N = self.N
        for d in range(N):
            cap = self.fluid.capacity_u[d]
            mesh_c = self.fluid.mesh_u[d]
            V = np.asarray(cap.V, float)
            ct = np.asarray(cap.cell_types)
            shape = V.shape
            h = np.asarray(mesh_c.h, float)
            cellvol = float(np.prod(h))
            frac = V / cellvol
            cand = (ct == -1) & (frac < frac_max) & np.asarray(self.u_active[d])
            for item in self.borders[d].items:
                cand &= ~np.asarray(item[5])
            if not cand.any():
                out.append(None)
                continue
            # fluid-inward interface normal from the aperture closure
            # n_in,e |Γ| = A_hi,e − A_lo,e  (Gauss over the wet region)
            nvec = np.zeros(shape + (N,))
            for e in range(N):
                Ae = np.asarray(cap.A[e], float)
                hi = np.zeros_like(Ae)
                sl_dst = [slice(None)] * N
                sl_src = [slice(None)] * N
                sl_dst[e] = slice(0, -1)
                sl_src[e] = slice(1, None)
                hi[tuple(sl_dst)] = Ae[tuple(sl_src)]
                nvec[..., e] = hi - Ae
            nn = np.linalg.norm(nvec, axis=-1)
            Com = np.asarray(cap.C_om, float)[..., :N]
            Cga = np.asarray(cap.C_ga, float)[..., :N]
            alt = Com - Cga
            use_alt = nn < 1e-12
            nvec = np.where(use_alt[..., None], alt, nvec)
            nn = np.linalg.norm(nvec, axis=-1)
            cand &= nn > 1e-12
            nvec = nvec / np.maximum(nn, 1e-300)[..., None]
            hbar = float(np.max(h))
            d_c = np.einsum("...k,...k->...", Com - Cga, nvec)
            d_c = np.clip(d_c, 0.05 * hbar, 2.0 * hbar)
            # trusted interpolation sources: every wet cell that keeps a
            # real row (momentum or border-Dirichlet identity)
            good_src = (V > 1e-12) & ~cand
            x0 = np.array([float(mesh_c.centers[e][0]) for e in range(N)])
            gidx = np.argwhere(cand)
            K = len(gidx)
            corners = 2 ** N

            def bilinear(xf):
                """(flat ids, weights) of the lattice cell around xf, or
                None when a source cell is untrusted/out of range."""
                i0 = np.floor((xf - x0) / h).astype(int)
                if np.any(i0 < 0) or np.any(i0 + 1 > np.array(shape) - 1):
                    return None
                fr = (xf - (x0 + i0 * h)) / h
                ids, ws = [], []
                for corner in range(corners):
                    off = [(corner >> e) & 1 for e in range(N)]
                    cidx = tuple(int(i0[e] + off[e]) for e in range(N))
                    if not good_src[cidx]:
                        return None
                    w = 1.0
                    for e in range(N):
                        w *= fr[e] if off[e] else (1.0 - fr[e])
                    ids.append(np.ravel_multi_index(cidx, shape))
                    ws.append(w)
                return ids, ws

            # two probe points along the inward normal -> quadratic
            # (Gibou-style second-order) extrapolation to the DOF point:
            # u(s) Lagrange through (0, u_w), (s1, u1), (s2, u2), s = dist
            # from the wall; row coefficients evaluated at s = d_c.
            idx_all = np.zeros((K, 2 * corners), np.int64)
            wts_all = np.zeros((K, 2 * corners))
            cwall = np.zeros(K)
            xw = np.zeros((K, N))
            keep = np.zeros(K, bool)
            for k in range(K):
                ji = tuple(gidx[k])
                xc, nv, dc = Com[ji], nvec[ji], d_c[ji]
                for tmul in (1.5, 2.0, 2.5, 3.0):
                    t = tmul * hbar
                    b1 = bilinear(xc + t * nv)
                    b2 = bilinear(xc + 2.0 * t * nv)
                    if b1 is None or b2 is None:
                        continue
                    s1, s2 = dc + t, dc + 2.0 * t
                    lw = ((dc - s1) * (dc - s2)) / (s1 * s2)
                    l1 = (dc * (dc - s2)) / (s1 * (s1 - s2))
                    l2 = (dc * (dc - s1)) / (s2 * (s2 - s1))
                    idx_all[k] = b1[0] + b2[0]
                    wts_all[k] = ([l1 * w for w in b1[1]]
                                  + [l2 * w for w in b2[1]])
                    cwall[k] = lw
                    xw[k] = xc - dc * nv
                    keep[k] = True
                    break
            if not keep.any():
                out.append(None)
                continue
            gpos = np.ravel_multi_index(tuple(gidx[keep].T), shape)
            out.append({
                "gpos": jnp.asarray(gpos),
                "idx": jnp.asarray(idx_all[keep]),
                "wts": jnp.asarray(wts_all[keep]),
                "cwall": jnp.asarray(cwall[keep]),
                "xw": tuple(jnp.asarray(xw[keep][:, e]) for e in range(N)),
            })
        return tuple(out)

    def _ghost_fix(self, d, yw, uw):
        g = self._ghost[d]
        if g is None:
            return yw
        uf = (uw.ravel()[g["idx"]] * g["wts"].astype(uw.dtype)).sum(1)
        val = uw.ravel()[g["gpos"]] - uf
        return yw.ravel().at[g["gpos"]].set(val).reshape(yw.shape)

    def _ghost_rhs(self, d, bw, t=None):
        g = self._ghost[d]
        if g is None:
            return bw
        uwall = eval_condition_value(self._cut(d).value, list(g["xw"]), t)
        cw = g["cwall"].astype(bw.dtype)
        uwall = jnp.broadcast_to(jnp.asarray(uwall, bw.dtype), cw.shape)
        return bw.ravel().at[g["gpos"]].set(cw * uwall).reshape(bw.shape)

    # ------------------------------------------------------------------
    def _gamma_moment_rhs(self, d, t=None):
        """μ Gᵀ Wꜝ Δq — the uγ placement correction of the cut viscous
        flux (``cut_flux="moment"``).  Δq_a(face k) = S_hi(k−1)·[g(X_hi) −
        g(C_ga)](k−1) + S_lo(k)·[g(X_lo) − g(C_ga)](k): the exact
        per-half-strip Γ boundary term for the prescribed Dirichlet data g
        minus what the uγ = g(C_ga) tie delivers through H.  Subtract from
        the momentum RHS (data, so the operator and its preconditioner are
        unchanged)."""
        if self._ghm is None:
            return None
        N = self.N
        cap = self.fluid.capacity_u[d]
        ops = self.fluid.operator_u[d]
        g = self._cut(d).value
        # same evaluation points as the tie rows (C_ga where cut, C_om
        # elsewhere) so the correction subtracts exactly what H delivers
        Cg = jnp.where((cap.cell_types == -1)[..., None],
                       cap.C_ga, cap.C_om)
        g_cga = eval_condition_value(g, [Cg[..., i] for i in range(N)], t)
        dq = []
        for a in range(N):
            S_lo, X_lo, S_hi, X_hi = self._ghm[d][a]
            g_lo = eval_condition_value(
                g, [X_lo[..., i] for i in range(N)], t)
            g_hi = eval_condition_value(
                g, [X_hi[..., i] for i in range(N)], t)
            D_lo = S_lo * (g_lo - g_cga)
            D_hi = S_hi * (g_hi - g_cga)
            dq.append(_shift_m(D_hi, a) + D_lo)
        return self.mu_diag[d] * ops.GT(ops.Wq(tuple(dq)))

    def _cont_moment_rhs(self, t=None):
        """Continuity γ-placement correction (``cut_flux="moment"``).

        The discrete continuity γ-term at p-cell k along d is
        ``S_lo(k)·uγ_d(k) + S_hi(k)·uγ_d(k+1)`` (p-mesh half-strip
        measures; note the hi half pairs with the NEXT cell's γ DOF).  The
        exact Γ mass term is ``S_lo·g_d(X_lo) + S_hi·g_d(X_hi)`` with X
        the n_d-weighted Γ centroids of the p-mesh half-cells.  Returns
        Δ = exact − discrete(data) to subtract from the continuity RHS."""
        if self._ghm_p is None:
            return None
        N = self.N
        delta = 0.0
        for d in range(N):
            cap_u = self.fluid.capacity_u[d]
            g = self._cut(d).value
            Cg = jnp.where((cap_u.cell_types == -1)[..., None],
                           cap_u.C_ga, cap_u.C_om)
            gtie = eval_condition_value(g, [Cg[..., i] for i in range(N)], t)
            gtie = jnp.broadcast_to(gtie, cap_u.V.shape)
            S_lo, X_lo, S_hi, X_hi = self._ghm_p[d]
            g_lo = eval_condition_value(
                g, [X_lo[..., i] for i in range(N)], t)
            g_hi = eval_condition_value(
                g, [X_hi[..., i] for i in range(N)], t)
            delta = delta + S_lo * (g_lo - gtie) \
                + S_hi * (g_hi - _shift_p(gtie, d))
        return delta

    def _traction_row(self, d, uw, ug, p):
        ops = self.fluid.operator_u[d]
        q = ops.flux(uw, ug)
        visc_trac = self.mu_diag[d] * ops.HT(q)
        opp = self.fluid.operator_p
        per = opp._per(d)
        hp = opp.A[d] * dm(p, d, per) - dm(opp.B[d] * p, d, per)
        return visc_trac - hp

    def _tie_or_traction(self, d, uw, ug, p):
        if not self.traction:
            return ug
        row = self._traction_row(d, uw, ug, p)
        return jnp.where(self.trac_active[d], row, ug)

    def _visc(self, d, uw, ug):
        ops = self.fluid.operator_u[d]
        q = ops.flux(uw, ug)
        return self.mu_diag[d] * ops.GT(q)

    def _grad(self, d, p):
        opp = self.fluid.operator_p
        g = -(opp.A[d] * dm(p, d, opp._per(d)))
        if self._divw is not None:
            from ..operators import sw_applyT
            g = g - sw_applyT(self._divw[d], dm(p, d, opp._per(d)))
        return g

    def _div(self, uws, ugs):
        """Continuity operator incl. the wet-face cross-moment correction
        (adjoint pair of :meth:`_grad`)."""
        out = stokes_divergence(self.fluid, uws, ugs)
        if self._divw is not None:
            from ..operators import sw_apply
            opp = self.fluid.operator_p
            for d in range(self.N):
                out = out - dm_t(sw_apply(self._divw[d], uws[d]), d,
                                 opp._per(d))
        return out

    def _gauge_fix(self, yp, p):
        if self.outflow_p_mask is not None:
            return jnp.where(self.outflow_p_mask, p, yp)
        if self.pin_mask is not None:
            return jnp.where(self.pin_mask, p, yp)
        # mean gauge: replace the first continuity row by the weighted mean
        flat = jnp.sum(self.mean_w * p)
        idx0 = (0,) * p.ndim
        return yp.at[idx0].set(flat)

    def _gauge_rhs(self, bp):
        if self.outflow_p_mask is not None:
            return jnp.where(self.outflow_p_mask, self.outflow_p_vals, bp)
        if self.pin_mask is not None:
            return jnp.where(self.pin_mask, 0.0, bp)
        idx0 = (0,) * bp.ndim
        return bp.at[idx0].set(0.0)

    def apply_steady(self, x):
        N = self.N
        uws = x[0:2 * N:2]
        ugs = x[1:2 * N:2]
        p = x[2 * N]
        out = []
        for d in range(N):
            yw = self._visc(d, uws[d], ugs[d]) + self._grad(d, p)
            yw = jnp.where(self.u_active[d], yw, uws[d])
            yw = self._ghost_fix(d, yw, uws[d])
            yg = self._tie_or_traction(d, uws[d], ugs[d], p)
            yw, yg = self.borders[d].matvec(yw, yg, uws[d], ugs[d])
            out += [yw, yg]
        yp = self._div(uws, ugs)
        yp = jnp.where(self.p_active, yp, p)
        yp = self._gauge_fix(yp, p)
        return tuple(out) + (yp,)

    def _cut(self, d):
        bc = self.bc_cut
        return bc[d] if isinstance(bc, (tuple, list)) else bc

    def rhs_steady(self, t=None):
        N = self.N
        out = []
        for d in range(N):
            cap = self.fluid.capacity_u[d]
            ops = self.fluid.operator_u[d]
            C = cap.C_om
            coords = [C[..., i] for i in range(C.shape[-1])]
            fu = self.fluid.f_u
            fu_d = fu[d] if isinstance(fu, (tuple, list)) else fu
            f = eval_condition_value(fu_d, coords, t)
            bw = ops.V * f
            # tie evaluation points: interface centroid where the cell is
            # cut, the CELL centroid elsewhere.  C_ga is stored as the
            # zero vector at non-cut cells, and their uγ DOFs are NOT all
            # structurally inert: the continuity γ-term pairs cell k's
            # hi-half measure with uγ(k+1), so the γ of a full cell one
            # step inside the fluid enters cut continuity rows with O(h)
            # weight.  Evaluating g at the origin there injected O(1)
            # bogus wall values as mass sources (measured on the Couette
            # annulus: a 0.18 wall-normal velocity leak at the θ=π outer
            # wall).
            Cg = jnp.where((cap.cell_types == -1)[..., None],
                           cap.C_ga, cap.C_om)
            gco = [Cg[..., i] for i in range(Cg.shape[-1])]
            bg = eval_condition_value(self._cut(d).value, gco, t)
            if self.traction:
                bg = jnp.where(self.trac_active[d], bg, 0.0)
            corr = self._gamma_moment_rhs(d, t)
            if corr is not None:
                bw = bw - corr
            bw = jnp.where(self.u_active[d], bw, 0.0)
            bw = self._ghost_rhs(d, bw, t)
            bw, bg = self.borders[d].rhs(bw, bg, t)
            out += [bw, bg]
        bp = jnp.zeros_like(self.fluid.capacity_p.V)
        dc = self._cont_moment_rhs(t)
        if dc is not None:
            bp = jnp.where(self.p_active, -dc, bp)
        bp = self._gauge_rhs(bp)
        return tuple(out) + (bp,)

    def make_unsteady_apply(self, dt, theta):
        N = self.N

        def apply(x):
            uws = x[0:2 * N:2]
            ugs = x[1:2 * N:2]
            p = x[2 * N]
            out = []
            for d in range(N):
                mass = self.rho_diag[d] * self.fluid.operator_u[d].V / dt
                yw = (
                    mass * uws[d]
                    + theta * self._visc(d, uws[d], ugs[d])
                    + self._grad(d, p)
                )
                yw = jnp.where(self.u_active[d], yw, uws[d])
                yw = self._ghost_fix(d, yw, uws[d])
                yg = self._tie_or_traction(d, uws[d], ugs[d], p)
                yw, yg = self.borders[d].matvec(yw, yg, uws[d], ugs[d])
                out += [yw, yg]
            yp = self._div(uws, ugs)
            yp = jnp.where(self.p_active, yp, p)
            yp = self._gauge_fix(yp, p)
            return tuple(out) + (yp,)

        return apply

    def make_unsteady_rhs(self, dt, theta):
        N = self.N

        def rhs(x_prev, t_prev, t_next, extra_mom=None):
            out = []
            for d in range(N):
                cap = self.fluid.capacity_u[d]
                ops = self.fluid.operator_u[d]
                mass = self.rho_diag[d] * ops.V / dt
                uw_p = x_prev[2 * d]
                ug_p = x_prev[2 * d + 1]
                C = cap.C_om
                coords = [C[..., i] for i in range(C.shape[-1])]
                fu = self.fluid.f_u
                fu_d = fu[d] if isinstance(fu, (tuple, list)) else fu
                f_prev = eval_condition_value(fu_d, coords, t_prev)
                f_next = eval_condition_value(fu_d, coords, t_next)
                load = ops.V * (theta * f_next + (1 - theta) * f_prev)
                bw = mass * uw_p - (1 - theta) * self._visc(d, uw_p, ug_p) + load
                if extra_mom is not None:
                    bw = bw + extra_mom[d]
                if self._ghm is not None:
                    corr_n = self._gamma_moment_rhs(d, t_next)
                    corr_p = self._gamma_moment_rhs(d, t_prev)
                    bw = bw - theta * corr_n - (1 - theta) * corr_p
                bw = jnp.where(self.u_active[d], bw, 0.0)
                # C_om fallback at non-cut cells — see rhs_steady
                Cg = jnp.where((cap.cell_types == -1)[..., None],
                               cap.C_ga, cap.C_om)
                gco = [Cg[..., i] for i in range(Cg.shape[-1])]
                bg = eval_condition_value(self._cut(d).value, gco, t_next)
                if self.traction:
                    bg = jnp.where(self.trac_active[d], bg, 0.0)
                bw = self._ghost_rhs(d, bw, t_next)
                bw, bg = self.borders[d].rhs(bw, bg, t_next)
                out += [bw, bg]
            bp = jnp.zeros_like(self.fluid.capacity_p.V)
            dc = self._cont_moment_rhs(t_next)
            if dc is not None:
                bp = jnp.where(self.p_active, -dc, bp)
            bp = self._gauge_rhs(bp)
            return tuple(out) + (bp,)

        return rhs

    # ------------------------------------------------------------------
    def zero_state(self):
        N = self.N
        z = [jnp.zeros_like(self.fluid.operator_u[d].V) for d in range(N)]
        out = []
        for d in range(N):
            out += [z[d], z[d]]
        return tuple(out) + (jnp.zeros_like(self.fluid.capacity_p.V),)

    def force_diagnostics(self, x=None, parts=False):
        """Reaction force on the immersed boundary: pressure + viscous
        momentum-residual parts (compute_navierstokes_force_diagnostics,
        navierstokes.jl:2977-3058):
        F_d = Σ [ A_p ∂_d p + Iμ Gᵀ Wꜝ (G uω_d + H uγ_d) ].
        ``parts=True`` returns ((Fp_d, Fv_d), ...) per component.

        By the telescoping of Gᵀ/Dm the full-domain sum equals the
        traction integral over ALL boundaries (body + outer borders) —
        the reference uses it in Dirichlet far-field boxes where the
        outer part is what balances the drag.  With Outflow/driven
        borders use :meth:`interface_force` instead."""
        x = x if x is not None else self.x
        N = self.N
        p = x[2 * N]
        out = []
        for d in range(N):
            ops = self.fluid.operator_u[d]
            q = ops.flux(x[2 * d], x[2 * d + 1])
            visc = float(jnp.sum(self.mu_diag[d] * ops.GT(q)))
            pres = float(jnp.sum(-self._grad(d, p)))
            out.append((pres, visc) if parts else pres + visc)
        return tuple(out)

    def interface_force(self, x=None, parts=False):
        """Traction integral on the EMBEDDED boundary only: the H-column
        (interface-aperture) parts of the viscous and pressure operators,
        F_d = Σ [ Iμ Hᵀ Wꜝ (G uω_d + H uγ_d) + (Hᵖ_d p) ] with
        Hᵖ_d p = A^p_d ∂_d p − ∂_d(B^p_d p).  Unlike the domain sum this
        isolates the body force regardless of the outer border types
        (verified: F ∝ μ to machine precision on the Stokes cylinder,
        lift/drag ~ 0.5% by symmetry).  Sign: force ON the fluid; the
        drag on the body is the negative."""
        x = x if x is not None else self.x
        out = self.interface_force_traced(x, parts=parts)
        if parts:
            return tuple((float(a), float(b)) for a, b in out)
        return tuple(float(v) for v in out)

    def interface_force_traced(self, x, parts=False):
        """Jittable :meth:`interface_force` (jnp scalars — usable inside a
        scan for per-step force time series, e.g. the DFG Cd/Cl benchmark)."""
        N = self.N
        p = x[2 * N]
        opp = self.fluid.operator_p
        out = []
        for d in range(N):
            ops = self.fluid.operator_u[d]
            q = ops.flux(x[2 * d], x[2 * d + 1])
            visc = jnp.sum(self.mu_diag[d] * ops.HT(q))
            Hp = (opp.A[d] * dm(p, d, opp._per(d))
                  - dm(opp.B[d] * p, d, opp._per(d)))
            pres = jnp.sum(Hp)
            out.append((pres, visc) if parts else pres + visc)
        return tuple(out)

    def drag_lift_coefficients(self, u_ref=1.0, l_ref=1.0, x=None,
                               interface_only=False):
        """C_d, C_l = 2 |F| / (ρ u_ref² l_ref) (navierstokes.jl:3067-3082).
        ``interface_only=True`` uses :meth:`interface_force` (body-only)."""
        rho = self.fluid.rho
        rho_val = 1.0 if callable(rho) else float(rho)
        F = (self.interface_force(x) if interface_only
             else self.force_diagnostics(x))
        scale = 0.5 * rho_val * u_ref**2 * l_ref
        return tuple(f / scale for f in F)

    # ------------------------------------------------------------------
    # block (Schur-complement) preconditioner — VERDICT round-1 item 3.
    # Approximate block-LDU inverse of the saddle point [A G; Gᵀ 0]:
    #   y   = Â⁻¹ r_u                  (Â = Jacobi diagonal of momentum)
    #   s   = r_p − Gᵀ y − (uγ terms)
    #   z_p = −Ŝ⁻¹ s                   (Ŝ = Gᵀ Â⁻¹ G, the pressure Poisson
    #                                   operator; Chebyshev semi-iteration
    #                                   on the Jacobi-scaled Ŝ — a LINEAR
    #                                   fixed operator, safe inside any
    #                                   Krylov method)
    #   z_u = y − Â⁻¹ G z_p
    # The reference has no analogue (it factorizes the saddle point with
    # UMFPACK, stokes.jl:1512-1567); this is the matrix-free replacement.
    # ------------------------------------------------------------------
    def make_block_preconditioner(self, dt=None, theta=1.0, cheb_iters=20,
                                  lmin=None, lmax=None, conv_diag=None,
                                  schur="cheb", schur_cg_iters=25,
                                  mom="jacobi", mom_cg_iters=8):
        """Returns ``M(r) -> z`` approximating the inverse of the
        (unsteady if ``dt`` given) Stokes operator.  ``conv_diag``: extra
        per-component momentum diagonal (Picard convection).

        ``mom``: momentum-block approximation.  "jacobi" (default) uses
        the diagonal — for STEADY problems the block is the viscous
        Laplacian, so the preconditioned conditioning grows like 1/h²
        and restarted GMRES stagnates on fine grids (measured on DFG
        2D-1 at 512x256: every JFNK inner solve hits the 800-iteration
        cap and Newton stalls at |R| ~ 1.6e-5, leaving Cd 1.3% high;
        at 384x192 the same solve converges).  "cg" runs
        ``mom_cg_iters`` Jacobi-PCG sweeps on the masked SPD viscous
        block per application — a NONLINEAR preconditioner: use under a
        flexible outer method (linsolve.fgmres) only.

        ``lmin``/``lmax`` bound the spectrum of the Jacobi-scaled pressure
        Schur complement for the inner Chebyshev.  ``None`` (default)
        estimates them by power iteration at build time — fixed literals
        are fragile: cut geometries with weakly coupled near-interface
        pressure cells push eigenvalues BELOW any fixed floor and
        Chebyshev then AMPLIFIES those modes (measured: the 128² annulus
        stalls restarted GMRES at 4e-4 with the old lmin=0.04, converges
        to 1e-11 with estimated bounds)."""
        from ..assembly import _diag_GtWG

        N = self.N
        diag_mom, dinv = [], []
        for d in range(N):
            ops = self.fluid.operator_u[d]
            dm_ = theta * self.mu_diag[d] * _diag_GtWG(ops)
            if dt is not None:
                dm_ = dm_ + self.rho_diag[d] * ops.V / dt
            if conv_diag is not None:
                dm_ = dm_ + conv_diag[d]
            dm_ = jnp.where(self.u_active[d], dm_, 1.0)
            for item in self.borders[d].items:
                dm_ = jnp.where(item[5], 1.0, dm_)
            if self._ghost[d] is not None:
                # ghost cut rows are unit-diagonal interpolation rows —
                # the sliver's viscous diag (Wꜝ ~ 1/V) no longer applies
                dm_ = dm_.ravel().at[self._ghost[d]["gpos"]].set(1.0) \
                    .reshape(dm_.shape)
            dm_ = jnp.where(dm_ == 0.0, 1.0, dm_)
            diag_mom.append(dm_)
            dinv.append(1.0 / dm_)

        opp = self.fluid.operator_p
        coeff = tuple(opp.A[d] ** 2 * dinv[d] for d in range(N))
        dLp = 0.0
        for d in range(N):
            dLp = dLp + coeff[d] + _shift_p(coeff[d], d)
        dLp = jnp.where(self.p_active, dLp, 1.0)
        dLp = jnp.where(dLp == 0.0, 1.0, dLp)
        dLp_inv = 1.0 / dLp

        def Lp(p):
            pa = jnp.where(self.p_active, p, 0.0)
            out = 0.0
            for d in range(N):
                per = opp._per(d)
                out = out + dm_t(coeff[d] * dm(pa, d, per), d, per)
            return jnp.where(self.p_active, out, p)

        mask = self.p_active
        nact = jnp.maximum(jnp.sum(jnp.where(mask, 1.0, 0.0)), 1.0)

        def _deflate(p):
            # remove the pressure-gauge constant mode over the active set
            # (Lp's null space) so the estimates/Chebyshev see only the
            # physically relevant spectrum
            mean = jnp.sum(jnp.where(mask, p, 0.0)) / nact
            return jnp.where(mask, p - mean, 0.0)

        if lmin is None or lmax is None:
            # spectrum bounds of D⁻¹Lp on the active set by power iteration
            # (similar to the SPD D^{-1/2} Lp D^{-1/2}: spectrum is real
            # nonnegative).  Deterministic start with an index modulation so
            # the top mode is never orthogonal by symmetry accident.
            mod = 0.0
            for d in range(N):
                shp = [1] * mask.ndim
                shp[d] = mask.shape[d]
                mod = mod + jnp.arange(mask.shape[d]).reshape(shp) * (d + 1.3)
            v = _deflate(jnp.where(mask, 1.0 + jnp.sin(mod), 0.0))

            def scaled(p):
                return jnp.where(mask, dLp_inv * Lp(p), 0.0)

            def _power(op, v0, iters=16):
                vk = v0 / jnp.maximum(jnp.linalg.norm(v0), 1e-300)
                lam = jnp.asarray(1.0, jnp.zeros(0).dtype)
                for _ in range(iters):
                    w = _deflate(op(vk))
                    lam = vdot(vk, w)
                    vk = w / jnp.maximum(jnp.linalg.norm(w), 1e-300)
                return lam

            lmax_e = _power(scaled, v)
            lmax_eff = 1.05 * jnp.maximum(lmax_e, 1e-8)
            # smallest DEFLATED eigenvalue via the shifted operator
            mu = _power(lambda p: lmax_eff * jnp.where(mask, p, 0.0)
                        - scaled(p), v)
            lmin_e = lmax_eff - mu
            if lmax is None:
                lmax = lmax_eff
            if lmin is None:
                # power iteration approaches the smallest eigenvalue from
                # ABOVE (Ritz interlacing): halve it for safety.  Wider
                # margins (/8 tried) flatten the Chebyshev polynomial over
                # the actual spectrum and measurably weaken the JFNK inner
                # solves; /2 converges every measured geometry (incl. the
                # 128 annulus that diverged under the old fixed 0.04).
                lmin = jnp.clip(0.5 * lmin_e, 1e-4 * lmax_eff,
                                0.5 * lmax_eff)

        # deepen the sweep to match the measured spectral width (the old
        # fixed 14 was tuned for ratio ~50); outside a trace the ratio is
        # concrete and the unroll count can follow it
        try:
            ratio_f = float(lmax) / max(float(lmin), 1e-30)
            cheb_iters = int(min(max(1.6 * np.sqrt(ratio_f), cheb_iters),
                                 48))
        except (TypeError, jax.errors.TracerArrayConversionError,
                jax.errors.ConcretizationTypeError):
            pass  # traced bounds: keep the caller's fixed depth

        self._schur_bounds = (lmin, lmax, cheb_iters)  # diagnostics
        th_c = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = th_c / delta

        if schur == "dct_cg":
            # Constant-coefficient DCT-II Poisson surrogate of Lp as the
            # inner-CG preconditioner: mesh-size-independent (one forward/
            # inverse DCT per application), exact for the uniform-coefficient
            # Neumann Laplacian that Lp is away from the cut region and
            # borders.  Jacobi-PCG needs ~sqrt(cond) ~
            # O(n) iterations on an n² grid; with the DCT surrogate the
            # inner iteration count is O(1) in mesh size (only the cut/
            # border discrepancy remains for CG to correct).
            ncell = tuple(s_ - 1 for s_ in mask.shape)  # strip padding slot
            m_act = jnp.where(mask, 1.0, 0.0)
            nact_s = jnp.maximum(jnp.sum(m_act), 1.0)
            lam = jnp.zeros(ncell)
            for d in range(N):
                wbar = jnp.sum(coeff[d] * m_act) / nact_s
                k = jnp.arange(ncell[d])
                shp = [1] * N
                shp[d] = ncell[d]
                lam = lam + wbar * 2.0 * (
                    1.0 - jnp.cos(jnp.pi * k / ncell[d])).reshape(shp)
            lam = jnp.where(lam <= 0.0, 1.0, lam)  # zero mode: deflated

            core = tuple(slice(0, nc) for nc in ncell)

            # DCT-II as a MATMUL, not an FFT: Y = C X with
            # C[k,j] = s_k cos(pi (j+1/2) k / n) (ortho), inverse = Cᵀ.
            # It partitions cleanly under GSPMD — a sharded operand times a
            # replicated cosine matrix is a plain collective matmul,
            # whereas the FFT lowering both materializes the grid and
            # trips an XLA:CPU layout RET_CHECK when the input is sharded
            # (observed in dryrun_ns_picard_multichip).  Which of the two
            # is faster on a GPU is not measured yet.
            dtype0 = mask_dtype = jnp.zeros(0).dtype
            Cmats = []
            for d in range(N):
                nd_ = ncell[d]
                jj = np.arange(nd_)
                kk = np.arange(nd_)[:, None]
                Cd = (np.cos(np.pi * (jj[None, :] + 0.5) * kk / nd_)
                      * np.sqrt(2.0 / nd_))
                Cd[0] *= np.sqrt(0.5)
                Cmats.append(jnp.asarray(Cd, dtype0))

            def _along(M, x, axis):
                return jnp.moveaxis(jnp.matmul(jnp.moveaxis(x, axis, -1), M.T,
                                               precision=HIGHEST), -1, axis)

            def dct_inv(s):
                sc = s[core]
                for d in range(N):
                    sc = _along(Cmats[d], sc, d)          # DCT-II
                sc = sc / lam
                sc = sc.at[(0,) * N].set(0.0)
                for d in range(N):
                    sc = _along(Cmats[d].T, sc, d)        # DCT-III (inv)
                out = jnp.zeros_like(s)
                out = out.at[core].set(sc)
                return _deflate(out)

            inner_prec = dct_inv
        elif schur == "mass":
            # Steady viscous-dominated Schur complement is spectrally
            # equivalent to the (1/μ)-scaled pressure MASS matrix
            # (Elman-Silvester-Wathen), NOT the Poisson surrogate GᵀD⁻¹G
            # — the right pairing once the momentum block is actually
            # solved (mom="cg") instead of Jacobi-scaled.  Ŝ⁻¹ = μ Mp⁻¹.
            mu_p = self.fluid.mu
            mu_p_val = 1.0 if callable(mu_p) else float(mu_p)
            Vp = self.fluid.operator_p.V
            Vp_inv = jnp.where(mask & (Vp > 0.0), 1.0 / jnp.where(
                Vp > 0.0, Vp, 1.0), 0.0)

            def inner_prec(r):
                return mu_p_val * Vp_inv * r
        else:
            def inner_prec(r):
                return dLp_inv * r

        def schur_cg(bp):
            """~Lp⁻¹ bp by ``schur_cg_iters`` PCG steps (Jacobi or DCT
            preconditioner) on the deflated active set.  NONLINEAR in bp —
            use only under a flexible outer Krylov method
            (``linsolve.fgmres``).  Unlike Chebyshev it needs no spectral
            bounds, which matters on geometries where the power-iteration
            lmin estimate is far off (measured on the DFG channel: the
            deflated spectrum reaches ~50x below the 16-step
            power-iteration Ritz value and the mistuned Chebyshev then
            amplifies those modes — outer GMRES stalls at relres ~2e-1)."""
            r = bp
            x = jnp.zeros_like(bp)
            z = inner_prec(r)
            p_ = z
            rz = vdot(r, z)
            for _ in range(schur_cg_iters):
                Ap_ = _deflate(Lp(p_))
                pAp = vdot(p_, Ap_)
                alpha = rz / jnp.where(pAp <= 0.0, 1.0, pAp)
                alpha = jnp.where(pAp <= 0.0, 0.0, alpha)
                x = x + alpha * p_
                r = r - alpha * Ap_
                z = inner_prec(r)
                rz_new = vdot(r, z)
                beta = rz_new / jnp.where(rz == 0.0, 1.0, rz)
                beta = jnp.where(rz == 0.0, 0.0, beta)
                rz = rz_new
                p_ = z + beta * p_
            return x

        def cheb(bp):
            """~Lp⁻¹ bp by Chebyshev on the Jacobi-scaled operator (linear
            in bp; spectrum of D⁻¹Lp assumed ⊂ [lmin, lmax])."""
            bs = dLp_inv * bp
            x = jnp.zeros_like(bp)
            r = bs
            dvec = r / th_c
            rho = 1.0 / sigma
            for i in range(cheb_iters):
                x = x + dvec
                r = r - dLp_inv * Lp(dvec)
                rho_new = 1.0 / (2.0 * sigma - rho)
                dvec = rho_new * rho * dvec + (2.0 * rho_new / delta) * r
                rho = rho_new
            return x

        if mom in ("cg", "cg_dst"):
            mom_solvers = []
            for d in range(N):
                idm = jnp.where(self.u_active[d], 1.0, 0.0)
                for item in self.borders[d].items:
                    idm = jnp.where(item[5], 0.0, idm)
                if self._ghost[d] is not None:
                    idm = idm.ravel().at[self._ghost[d]["gpos"]] \
                        .set(0.0).reshape(idm.shape)
                act_d = idm > 0.5
                extra = jnp.zeros_like(diag_mom[d])
                if dt is not None:
                    extra = extra + (self.rho_diag[d]
                                     * self.fluid.operator_u[d].V / dt)
                if conv_diag is not None:
                    extra = extra + conv_diag[d]

                if mom == "cg_dst":
                    # Constant-coefficient DST-I (homogeneous-Dirichlet)
                    # surrogate of the masked viscous block as the inner
                    # CG preconditioner — the velocity-space analogue of
                    # the Schur dct_inv: mesh-size-independent inner
                    # conditioning (Jacobi-PCG on the viscous Laplacian
                    # needs O(n) sweeps; the surrogate leaves CG only the
                    # cut/border discrepancy).  Coefficients from the
                    # active-mean of the exact interior stencil weight
                    # μ B_a² Wꜝ_a per axis (anisotropy-correct).
                    ops_d = self.fluid.operator_u[d]
                    m_act = jnp.where(act_d, 1.0, 0.0)
                    nact_d = jnp.maximum(jnp.sum(m_act), 1.0)
                    ncell_d = tuple(s_ - 1 for s_ in act_d.shape)
                    lam_m = jnp.zeros(ncell_d)
                    for a in range(N):
                        wa = (theta * self.mu_diag[d] * ops_d.B[a] ** 2
                              * ops_d.Wdag[a])
                        wbar = jnp.sum(wa * m_act) / nact_d
                        k = jnp.arange(ncell_d[a])
                        shp = [1] * N
                        shp[a] = ncell_d[a]
                        lam_m = lam_m + wbar * 2.0 * (
                            1.0 - jnp.cos(jnp.pi * (k + 1.0)
                                          / (ncell_d[a] + 1))).reshape(shp)
                    lam_m = lam_m + jnp.sum(extra * m_act) / nact_d
                    lam_m = jnp.where(lam_m <= 0.0, 1.0, lam_m)
                    dtype0 = jnp.zeros(0).dtype
                    Smats = []
                    for a in range(N):
                        na = ncell_d[a]
                        jj = np.arange(na)
                        kk = np.arange(na)[:, None]
                        Sa = (np.sin(np.pi * (jj[None, :] + 1.0)
                                     * (kk + 1.0) / (na + 1))
                              * np.sqrt(2.0 / (na + 1)))
                        Smats.append(jnp.asarray(Sa, dtype0))
                    core_d = tuple(slice(0, nc) for nc in ncell_d)

                    def _along_m(Mt, x, axis):
                        return jnp.moveaxis(
                            jnp.matmul(jnp.moveaxis(x, axis, -1), Mt.T,
                                       precision=HIGHEST), -1, axis)

                    def dst_inv(r, lam_m=lam_m, Smats=Smats,
                                core_d=core_d, act_d=act_d):
                        rc = r[core_d]
                        for a in range(N):
                            rc = _along_m(Smats[a], rc, a)  # DST-I (=inv)
                        rc = rc / lam_m
                        for a in range(N):
                            rc = _along_m(Smats[a], rc, a)
                        out = jnp.zeros_like(r)
                        out = out.at[core_d].set(rc)
                        return jnp.where(act_d, out, 0.0)

                    prec_d = dst_inv
                else:
                    prec_d = None  # Jacobi below

                def mk(d=d, act_d=act_d, extra=extra, dinv_d=dinv[d],
                       prec_d=prec_d):
                    def Aop(u):
                        # masked SPD viscous (+ diagonal mass/convection)
                        # block: inactive/border/ghost rows and columns
                        # are zeroed so CG sees a symmetric operator on
                        # the active subspace
                        um = jnp.where(act_d, u, 0.0)
                        y = (theta * self._visc(d, um, jnp.zeros_like(um))
                             + extra * um)
                        return jnp.where(act_d, y, 0.0)

                    def prec(r_):
                        if prec_d is not None:
                            return prec_d(r_)
                        return jnp.where(act_d, dinv_d * r_, 0.0)

                    def solve(rb):
                        b_ = jnp.where(act_d, rb, 0.0)
                        x = jnp.zeros_like(b_)
                        r_ = b_
                        z = prec(r_)
                        p_ = z
                        rz = vdot(r_, z)
                        for _ in range(mom_cg_iters):
                            Ap_ = Aop(p_)
                            pAp = vdot(p_, Ap_)
                            alpha = rz / jnp.where(pAp <= 0.0, 1.0, pAp)
                            alpha = jnp.where(pAp <= 0.0, 0.0, alpha)
                            x = x + alpha * p_
                            r_ = r_ - alpha * Ap_
                            z = prec(r_)
                            rz_new = vdot(r_, z)
                            beta = rz_new / jnp.where(rz == 0.0, 1.0, rz)
                            beta = jnp.where(rz == 0.0, 0.0, beta)
                            rz = rz_new
                            p_ = z + beta * p_
                        return jnp.where(act_d, x, rb)
                    return solve
                mom_solvers.append(mk())

            def mom_solve(d, rb):
                return mom_solvers[d](rb)
        else:
            def mom_solve(d, rb):
                return dinv[d] * rb

        def M(r):
            rws = r[0:2 * N:2]
            rgs = r[1:2 * N:2]
            rp = r[2 * N]
            y = tuple(mom_solve(d, rws[d]) for d in range(N))
            zg = rgs
            s = rp - self._div(y, zg)
            s = jnp.where(self.p_active, s, 0.0)
            if self.pin_mask is not None:
                s = jnp.where(self.pin_mask, 0.0, s)
            if self.outflow_p_mask is not None:
                s = jnp.where(self.outflow_p_mask, 0.0, s)
            # Chebyshev must not see Lp's constant null mode (it would
            # amplify it cosh-fast); route that component through a bounded
            # identity instead — the pin/gauge rows own the level anyway
            mean_s = jnp.sum(jnp.where(mask, s, 0.0)) / nact
            solve_s = (inner_prec if schur == "mass"
                       else schur_cg if schur in ("cg", "dct_cg") else cheb)
            zp = -(solve_s(_deflate(s))
                   + (mean_s / jnp.maximum(lmax, 1e-30))
                   * jnp.where(mask, 1.0, 0.0))
            zp = jnp.where(self.p_active, zp, rp)
            if self.pin_mask is not None:
                zp = jnp.where(self.pin_mask, rp, zp)
            if self.outflow_p_mask is not None:
                zp = jnp.where(self.outflow_p_mask, rp, zp)
            out = []
            for d in range(N):
                zw = y[d] - mom_solve(d, self._grad(d, zp))
                zw = jnp.where(self.u_active[d], zw, rws[d])
                for item in self.borders[d].items:
                    zw = jnp.where(item[5], rws[d], zw)
                out += [zw, zg[d]]
            return tuple(out) + (zp,)

        M.mom_solve = mom_solve  # diagnostics / tests
        return M

    def solve(self, method="auto", tol=1e-10, maxiter=None, x0=None,
              restart=100):
        """Steady solve.  ``auto``: dense LU for small systems, else
        block-Schur-preconditioned GMRES (``schur_gmres``) — the scalable
        saddle-point path (the reference factorizes with UMFPACK,
        src/solver/stokes.jl:1512-1567; here the approximate block-LDU
        inverse + restarted GMRES replaces it)."""
        b = self.rhs_steady()
        if method == "auto":
            nflat = sum(int(np.prod(np.asarray(u.shape))) for u in b)
            method = "direct" if nflat <= 12000 else "schur_gmres"
        if method in ("schur_gmres", "schur_bicgstab"):
            from ..linsolve import pbicgstab, pgmres

            M = self.make_block_preconditioner(dt=None, theta=1.0)
            x0_ = x0 if x0 is not None else self.zero_state()
            if method == "schur_gmres":
                x, its, rr = pgmres(self.apply_steady, b, x0_, Minv=M,
                                    tol=tol, maxiter=maxiter or 2000,
                                    restart=restart)
            else:
                x, its, rr = pbicgstab(self.apply_steady, b, x0_, Minv=M,
                                       tol=tol, maxiter=maxiter or 2000)
            self.x = x
            self.krylov_iters = int(its)
            self.krylov_relres = float(rr)
            return self.x
        self.x = solve_linear(self.apply_steady, b, method=method, tol=tol,
                              maxiter=maxiter)
        return self.x

    def solve_unsteady(self, dt, t_end, scheme="CN", method="auto",
                       x0=None, tol=1e-10, maxiter=None):
        theta = 0.5 if scheme in ("CN", "cn") else 1.0
        apply_fn = self.make_unsteady_apply(dt, theta)
        rhs_fn = self.make_unsteady_rhs(dt, theta)
        x = x0 if x0 is not None else self.zero_state()
        n_steps = int(np.ceil(t_end / dt - 1e-12))
        nflat = sum(int(np.prod(np.asarray(u.shape))) for u in x)
        if method == "auto":
            method = "direct" if nflat <= 12000 else "pbicgstab"
        telemetry = False
        if method == "direct":
            factor = DenseFactorSolver(apply_fn, x)

            def step(xc, t):
                return factor.solve(rhs_fn(xc, t, t + dt))
        elif method == "pbicgstab":
            # block-Schur-preconditioned BiCGStab with per-step telemetry
            from ..linsolve import pbicgstab

            M = self.make_block_preconditioner(dt=dt, theta=theta)
            telemetry = True

            def step(xc, t):
                return pbicgstab(apply_fn, rhs_fn(xc, t, t + dt), xc,
                                 Minv=M, tol=tol, maxiter=maxiter or 400)
        else:
            from jax.scipy.sparse.linalg import gmres

            M = (self.make_block_preconditioner(dt=dt, theta=theta)
                 if method == "pgmres" else None)

            def step(xc, t):
                xs, _ = gmres(apply_fn, rhs_fn(xc, t, t + dt), x0=xc, tol=tol,
                              maxiter=maxiter or 2000, M=M,
                              solve_method="batched")
                return xs

        @jax.jit
        def run(x0_):
            def body(xc, k):
                if telemetry:
                    xn, iters, relres = step(xc, k * dt)
                    return xn, (iters, relres)
                xn = step(xc, k * dt)
                return xn, None

            xf, aux = jax.lax.scan(body, x0_,
                                   jnp.arange(n_steps, dtype=jnp.float64))
            return xf, aux

        self.x, aux = run(x)
        if telemetry:
            self.krylov_iters = np.asarray(aux[0])
            self.krylov_relres = np.asarray(aux[1])
        return self.x

    # views
    def velocity(self, d, gamma=False):
        return self.x[2 * d + (1 if gamma else 0)]

    @property
    def pressure(self):
        return self.x[2 * self.N]
