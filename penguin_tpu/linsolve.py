"""Matrix-free linear solvers.

The reference trims zero rows/columns from an assembled sparse matrix and
calls UMFPACK / IterativeSolvers (``/root/reference/src/solver.jl:59-188``).
Here systems stay matrix-free: inactive DOFs are replaced by identity
equations (``x_i = 0``) — exactly equivalent to the reference's
``remove_zero_rows_cols!`` (which keeps index ``i`` only when row *and*
column ``i`` are structurally nonzero) — and solves are:

- ``direct``: materialize the operator densely (vmapped basis application,
  a batched matmul) + LU.  For small/medium systems.
- ``cg`` / ``bicgstab`` / ``gmres``: jax.scipy matrix-free Krylov with
  optional Jacobi preconditioning; dot products become ``psum`` collectives
  under sharding.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

__all__ = [
    "materialize_dense",
    "solve_linear",
    "DenseFactorSolver",
    "KrylovSolver",
    "pcg",
    "pbicgstab",
    "pgmres",
    "HIGHEST",
    "vdot",
]

# A float32 product on a GPU may run in TF32, which keeps about three
# decimal digits; Krylov inner products and the small dense products of the
# preconditioners and normal equations ask for full precision explicitly.
HIGHEST = jax.lax.Precision.HIGHEST


def vdot(a, b):
    """Real part of the inner product ⟨a, b⟩ at the dtype's full precision."""
    return jnp.vdot(a, b, precision=HIGHEST).real


# ---------------------------------------------------------------------------
# pytree Krylov with iteration telemetry (the reference stores convergence
# histories in Solver.ch, src/solver.jl:136-139,176-180; here every jitted
# solve returns (x, iters, relres) so callers can log solver health)
# ---------------------------------------------------------------------------

def _tdot(a, b):
    """Pytree dot product — becomes a psum collective under sharding."""
    parts = jax.tree_util.tree_map(vdot, a, b)
    return sum(jax.tree_util.tree_leaves(parts))


def _taxpy(alpha, x, y):
    return jax.tree_util.tree_map(lambda a, b: alpha * a + b, x, y)


def _tmul(d, x):
    return jax.tree_util.tree_map(lambda a, b: a * b, d, x)


def _make_prec(Minv):
    if Minv is None:
        return lambda r: r
    if callable(Minv):
        return Minv
    return lambda r: _tmul(Minv, r)


def _dtype_of(tree):
    return jax.tree_util.tree_leaves(tree)[0].dtype


def _guards(tree, tol):
    """(tiny, floored tol) for the working dtype.

    The old literal guards (``1e-300`` fallbacks) flush to 0.0 in f32,
    turning every breakdown branch into a division by zero — the f32
    Stefan GN loop NaN'd through exactly this path.  ``tiny`` is the
    smallest NORMAL number of the dtype; the tol floor keeps callers from
    asking an f32 Krylov for 1e-9 (unreachable: it just iterates into
    rounding-noise breakdowns).  ``tol`` may be a TRACED scalar (the JFNK
    Eisenstat-Walker forcing), so the floor uses jnp.maximum."""
    fi = jnp.finfo(_dtype_of(tree))
    return float(fi.tiny), jnp.maximum(tol, 8.0 * float(fi.eps))


def pcg(apply_fn, b, x0, Minv=None, tol=1e-8, maxiter=500):
    """Jacobi(/diagonal)-preconditioned conjugate gradients on pytrees.

    ``Minv``: pytree of inverse-diagonal entries, or a callable
    ``r -> M⁻¹r`` (None = identity).
    Returns ``(x, iters, relres)`` with ``relres = ||r||/||b||`` — the
    telemetry the reference keeps in ``Solver.ch``.

    NOTE deliberately NO best-iterate tracking or stagnation patience:
    any data-dependent selection (argmin over iterates, adaptive early
    exit) makes the returned x a *discontinuous* function of (A, b),
    which destabilizes outer Newton/Gauss-Newton loops that difference
    solutions across nearby systems (measured on the 512² Stefan GN:
    best-iterate return turned 1.7 GN/step convergence into an 8/step
    stall).  The only adaptivity is the tolerance test, whose jump size
    ~tol·‖b‖ stays below outer-loop noise floors."""
    prec = _make_prec(Minv)
    tiny, tol = _guards(b, tol)
    bb = jnp.maximum(_tdot(b, b), tiny)
    tol2 = tol * tol

    r0 = jax.tree_util.tree_map(lambda u, v: u - v, b, apply_fn(x0))
    z0 = prec(r0)
    rz0 = _tdot(r0, z0)

    def cond(st):
        x, r, p, rz, rr, k = st
        # NOTE no isfinite() bailout either: a transient f32 overflow
        # (rr = Inf, observed on the 512² Stefan slab CG around it ~26)
        # keeps iterating via `Inf > tol` and recovers; aborting on it
        # returns a garbage iterate and stalls the outer GN
        return (rr > tol2 * bb) & (k < maxiter)

    def body(st):
        x, r, p, rz, rr, k = st
        Ap = apply_fn(p)
        pAp = _tdot(p, Ap)
        alpha = rz / jnp.where(pAp != 0, pAp, 1.0)
        x = _taxpy(alpha, p, x)
        r = _taxpy(-alpha, Ap, r)
        z = prec(r)
        rz_new = _tdot(r, z)
        beta = rz_new / jnp.where(rz != 0, rz, 1.0)
        p = _taxpy(beta, p, z)
        return (x, r, p, rz_new, _tdot(r, r), k + 1)

    init = (x0, r0, z0, rz0, _tdot(r0, r0), 0)
    x, r, p, rz, rr, k = jax.lax.while_loop(cond, body, init)
    return x, k, jnp.sqrt(rr / bb)


def pbicgstab(apply_fn, b, x0, Minv=None, tol=1e-8, maxiter=500):
    """Preconditioned BiCGStab on pytrees (right preconditioning).
    ``Minv``: inverse-diagonal pytree or callable ``r -> M⁻¹r``.
    Returns ``(x, iters, relres)``.  No best-iterate/patience adaptivity —
    see the ``pcg`` note (outer-loop smoothness)."""
    prec = _make_prec(Minv)
    tiny, tol = _guards(b, tol)
    bb = jnp.maximum(_tdot(b, b), tiny)
    tol2 = tol * tol

    r0 = jax.tree_util.tree_map(lambda u, v: u - v, b, apply_fn(x0))
    zeros = jax.tree_util.tree_map(jnp.zeros_like, b)
    one = jnp.asarray(1.0, jax.tree_util.tree_leaves(b)[0].dtype)
    # ρ-breakdown threshold scales with the rounding noise of the dtype
    brk_tol = 1e-12 if jnp.finfo(_dtype_of(b)).eps < 1e-10 else 1e-6

    def cond(st):
        x, r, rhat, p, v, rho, alpha, omega, rr, k = st
        return (rr > tol2 * bb) & (k < maxiter)

    def body(st):
        x, r, rhat, p, v, rho, alpha, omega, rr, k = st
        rho_new = _tdot(rhat, r)
        # ρ-breakdown (serendipitous ⟂ of r and the shadow residual):
        # restart with rhat := r — the standard remedy; without it the
        # 1/ρ guard silently amplifies garbage until the iterate NaNs.
        brk = jnp.abs(rho_new) < brk_tol * jnp.sqrt(
            jnp.maximum(_tdot(rhat, rhat), tiny) * jnp.maximum(rr, tiny)
        )
        rhat = jax.tree_util.tree_map(
            lambda rh, rr_: jnp.where(brk, rr_, rh), rhat, r
        )
        rho_new = jnp.where(brk, rr, rho_new)
        # β=0 on restart makes the direction p := r below
        beta = jnp.where(
            brk,
            0.0,
            (rho_new / jnp.where(jnp.abs(rho) > tiny, rho, tiny))
            * (alpha / jnp.where(jnp.abs(omega) > tiny, omega, tiny)),
        )
        p = jax.tree_util.tree_map(
            lambda rr_, pp, vv: rr_ + beta * (pp - omega * vv), r, p, v
        )
        phat = prec(p)
        v = apply_fn(phat)
        rhv = _tdot(rhat, v)
        alpha = rho_new / jnp.where(jnp.abs(rhv) > tiny, rhv, tiny)
        s = _taxpy(-alpha, v, r)
        shat = prec(s)
        t = apply_fn(shat)
        tt = _tdot(t, t)
        omega = _tdot(t, s) / jnp.where(jnp.abs(tt) > tiny, tt, tiny)
        x = jax.tree_util.tree_map(
            lambda xx, ph, sh: xx + alpha * ph + omega * sh, x, phat, shat
        )
        r = _taxpy(-omega, t, s)
        return (x, r, rhat, p, v, rho_new, alpha, omega, _tdot(r, r), k + 1)

    init = (x0, r0, r0, zeros, zeros, one, one, one, _tdot(r0, r0), 0)
    x, r, rhat, p, v, rho, alpha, omega, rr, k = jax.lax.while_loop(
        cond, body, init
    )
    return x, k, jnp.sqrt(rr / bb)


def row_norm_equilibrator(apply_fn, template, probes=8):
    """Matrix-free row-norm estimate for left equilibration.

    For Rademacher probes z, ``E[(Az)_i²] = Σ_j A_ij²`` — so ``probes``
    applications of the operator estimate every row 2-norm at once.
    Returns a pytree of inverse row norms to pass as ``Minv`` (left) to
    ``pgmres``.  On the moving diphasic slab systems this equilibration
    beats Jacobi by orders of magnitude (measured cond 1.4e4 vs 1.6e10 on
    a 24² translating circle: the diagonal is *not* representative of the
    row scale when bulk rows carry O(1/W) cut-face couplings)."""
    leaves, treedef = jax.tree_util.tree_flatten(template)
    key = jax.random.PRNGKey(0)
    acc = jax.tree_util.tree_map(jnp.zeros_like, template)
    for _ in range(probes):
        key, sub = jax.random.split(key)
        subs = jax.random.split(sub, len(leaves))
        z = jax.tree_util.tree_unflatten(
            treedef,
            [jax.random.rademacher(s, l.shape, dtype=l.dtype)
             for s, l in zip(subs, leaves)],
        )
        y = apply_fn(z)
        acc = jax.tree_util.tree_map(lambda a, v: a + v * v, acc, y)
    return jax.tree_util.tree_map(
        lambda a: 1.0 / jnp.maximum(jnp.sqrt(a / probes), 1e-30), acc
    )


def pgmres(apply_fn, b, x0, Minv=None, tol=1e-8, maxiter=500, restart=40):
    """Left-preconditioned restarted GMRES(m) on pytrees with telemetry.

    ``Minv`` (inverse-diagonal pytree or callable) is applied on the LEFT —
    row equilibration, which the badly row-scaled cut-cell saddle/jump
    systems need (bulk rows scale like V~hᵈ, jump rows like 1; BiCGStab
    with right Jacobi stalls on them, GMRES with row scaling converges).
    Returns ``(x, iters, relres)``; ``relres`` is in the preconditioned
    residual norm.  All shapes static: one lax.while_loop over restart
    cycles, lax.fori_loop for the Arnoldi/Givens recurrences.
    """
    prec = _make_prec(Minv)
    pb_flat, unravel = ravel_pytree(prec(b))
    x0_flat = ravel_pytree(x0)[0]
    n = pb_flat.size
    dtype = pb_flat.dtype
    m = int(min(restart, n))

    def Ap(v):
        return ravel_pytree(prec(apply_fn(unravel(v))))[0]

    tiny, tol = _guards(b, tol)
    bb = jnp.maximum(vdot(pb_flat, pb_flat), tiny)
    tol2 = jnp.asarray(tol * tol, dtype)

    def cycle_body(st):
        j, V, R, cs, sn, g = st
        w = Ap(V[j])

        def mgs(i, wh):
            w, h = wh
            keep = (i <= j).astype(dtype)
            hij = keep * vdot(V[i], w)
            return (w - hij * V[i], h.at[i].set(hij))

        w, h = jax.lax.fori_loop(
            0, m + 1, mgs, (w, jnp.zeros((m + 1,), dtype))
        )
        hnext = jnp.linalg.norm(w)
        V = V.at[j + 1].set(w / jnp.where(hnext == 0, 1.0, hnext))

        def rot(i, hh):
            h, lo = hh
            keep = i < j
            hi = jnp.where(keep, cs[i] * h[i] + sn[i] * h[i + 1], h[i])
            hi1 = jnp.where(keep, -sn[i] * h[i] + cs[i] * h[i + 1], h[i + 1])
            return (h.at[i].set(hi).at[i + 1].set(hi1), lo)

        h, _ = jax.lax.fori_loop(0, m, rot, (h, 0))
        # new rotation eliminating (h[j], hnext)
        denom = jnp.sqrt(h[j] ** 2 + hnext ** 2)
        safe = jnp.where(denom == 0, 1.0, denom)
        c_j, s_j = jnp.where(denom == 0, 1.0, h[j] / safe), hnext / safe
        cs, sn = cs.at[j].set(c_j), sn.at[j].set(s_j)
        rjj = c_j * h[j] + s_j * hnext
        h = h.at[j].set(rjj)
        g_j1 = -s_j * g[j]
        g = g.at[j + 1].set(g_j1).at[j].set(c_j * g[j])
        R = R.at[:, j].set(h[: m + 1])
        return j + 1, V, R, cs, sn, g

    def cycle_cond(st):
        # early exit on the running Givens residual estimate |g[j]| — the
        # fixed-depth variant oversolved by up to a full restart cycle
        # (measured on the 3D duct: 60 its/step to relres 1e-9 against
        # tol 1e-5)
        j, V, R, cs, sn, g = st
        return (j < m) & (g[j] ** 2 > tol2 * bb)

    def one_cycle(x):
        r = pb_flat - Ap(x)
        beta = jnp.linalg.norm(r)
        V = jnp.zeros((m + 1, n), dtype)
        V = V.at[0].set(r / jnp.where(beta == 0, 1.0, beta))
        R = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros((m,), dtype)
        sn = jnp.zeros((m,), dtype)
        g = jnp.zeros((m + 1,), dtype).at[0].set(beta)
        j_f, V, R, cs, sn, g = jax.lax.while_loop(
            cycle_cond, cycle_body, (0, V, R, cs, sn, g)
        )
        # back substitution on the rotated (upper-triangular) R.  Columns
        # >= j_f are all-zero (never set) with unit-substituted diagonals,
        # but g[j_f] holds the NONZERO Givens residual estimate — left in,
        # it makes y[j_f] = g[j_f] and x picks up a spurious g[j_f]*V[j_f]
        # term (true residual ~||A||x reported relres).  Mask g above the
        # completed depth so unrun columns contribute exactly zero.
        Rm = R[:m, :m]
        dsafe = jnp.where(jnp.abs(jnp.diagonal(Rm)) < 1e-30, 1.0,
                          jnp.diagonal(Rm))
        Rm = Rm - jnp.diag(jnp.diagonal(Rm)) + jnp.diag(dsafe)
        gm = jnp.where(jnp.arange(m) < j_f, g[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(Rm, gm, lower=False)
        x_new = x + jnp.matmul(V[:m].T, y, precision=HIGHEST)
        return x_new, jnp.abs(g[j_f]), j_f

    def cond(st):
        x, rnorm, k = st
        return (rnorm * rnorm > tol2 * bb) & (k < maxiter)

    def body(st):
        x, rnorm, k = st
        x, rnorm, j_f = one_cycle(x)
        return (x, rnorm, k + j_f)

    r0 = pb_flat - Ap(x0_flat)
    st = (x0_flat, jnp.linalg.norm(r0), 0)
    x, rnorm, k = jax.lax.while_loop(cond, body, st)
    return unravel(x), k, rnorm / jnp.sqrt(bb)


def fgmres(apply_fn, b, x0, Minv=None, tol=1e-8, maxiter=500, restart=40):
    """Flexible restarted GMRES (right preconditioning, Saad 1993).

    Unlike :func:`pgmres`, the preconditioner may be a NONLINEAR operator
    (e.g. an inner Krylov solve on a Schur block): each Arnoldi vector's
    preconditioned image ``z_j = M(v_j)`` is stored and the update is
    ``x += Z y``.  Costs one extra (m, n) basis; ``relres`` is in the TRUE
    (unpreconditioned) residual norm.  Returns ``(x, iters, relres)``.
    """
    prec = _make_prec(Minv)
    b_flat, unravel = ravel_pytree(b)
    x0_flat = ravel_pytree(x0)[0]
    n = b_flat.size
    dtype = b_flat.dtype
    m = int(min(restart, n))

    def Af(v):
        return ravel_pytree(apply_fn(unravel(v)))[0]

    def Mf(v):
        return ravel_pytree(prec(unravel(v)))[0]

    tiny, tol = _guards(b, tol)
    bb = jnp.maximum(vdot(b_flat, b_flat), tiny)
    tol2 = jnp.asarray(tol * tol, dtype)

    def cycle_body(st):
        j, V, Z, R, cs, sn, g = st
        z = Mf(V[j])
        Z = Z.at[j].set(z)
        w = Af(z)

        def mgs(i, wh):
            w, h = wh
            keep = (i <= j).astype(dtype)
            hij = keep * vdot(V[i], w)
            return (w - hij * V[i], h.at[i].set(hij))

        w, h = jax.lax.fori_loop(
            0, m + 1, mgs, (w, jnp.zeros((m + 1,), dtype))
        )
        hnext = jnp.linalg.norm(w)
        V = V.at[j + 1].set(w / jnp.where(hnext == 0, 1.0, hnext))

        def rot(i, hh):
            h, lo = hh
            keep = i < j
            hi = jnp.where(keep, cs[i] * h[i] + sn[i] * h[i + 1], h[i])
            hi1 = jnp.where(keep, -sn[i] * h[i] + cs[i] * h[i + 1], h[i + 1])
            return (h.at[i].set(hi).at[i + 1].set(hi1), lo)

        h, _ = jax.lax.fori_loop(0, m, rot, (h, 0))
        denom = jnp.sqrt(h[j] ** 2 + hnext ** 2)
        safe = jnp.where(denom == 0, 1.0, denom)
        c_j, s_j = jnp.where(denom == 0, 1.0, h[j] / safe), hnext / safe
        cs, sn = cs.at[j].set(c_j), sn.at[j].set(s_j)
        h = h.at[j].set(c_j * h[j] + s_j * hnext)
        g = g.at[j + 1].set(-s_j * g[j]).at[j].set(c_j * g[j])
        R = R.at[:, j].set(h[: m + 1])
        return j + 1, V, Z, R, cs, sn, g

    def cycle_cond(st):
        # early exit on the running Givens residual (see pgmres): the
        # fixed-depth cycle oversolved by up to a whole restart
        j, V, Z, R, cs, sn, g = st
        return (j < m) & (g[j] ** 2 > tol2 * bb)

    def one_cycle(x):
        r = b_flat - Af(x)
        beta = jnp.linalg.norm(r)
        V = jnp.zeros((m + 1, n), dtype)
        V = V.at[0].set(r / jnp.where(beta == 0, 1.0, beta))
        Z = jnp.zeros((m, n), dtype)
        R = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros((m,), dtype)
        sn = jnp.zeros((m,), dtype)
        g = jnp.zeros((m + 1,), dtype).at[0].set(beta)
        j_f, V, Z, R, cs, sn, g = jax.lax.while_loop(
            cycle_cond, cycle_body, (0, V, Z, R, cs, sn, g)
        )
        Rm = R[:m, :m]
        dsafe = jnp.where(jnp.abs(jnp.diagonal(Rm)) < 1e-30, 1.0,
                          jnp.diagonal(Rm))
        Rm = Rm - jnp.diag(jnp.diagonal(Rm)) + jnp.diag(dsafe)
        # mask g past the completed Arnoldi depth (see pgmres): Z[j_f] is
        # zero here so the spurious term cannot reach x, but y[j_f] must
        # still vanish for the y-vector itself to be the LS solution
        gm = jnp.where(jnp.arange(m) < j_f, g[:m], 0.0)
        y = jax.scipy.linalg.solve_triangular(Rm, gm, lower=False)
        return (x + jnp.matmul(Z.T, y, precision=HIGHEST), jnp.abs(g[j_f]),
                j_f)

    def cond(st):
        x, rnorm, k = st
        return (rnorm * rnorm > tol2 * bb) & (k < maxiter)

    def body(st):
        x, rnorm, k = st
        x, rnorm, j_f = one_cycle(x)
        return (x, rnorm, k + j_f)

    r0 = b_flat - Af(x0_flat)
    st = (x0_flat, jnp.linalg.norm(r0), 0)
    x, rnorm, k = jax.lax.while_loop(cond, body, st)
    return unravel(x), k, rnorm / jnp.sqrt(bb)


def materialize_dense(apply_fn, template):
    """Build the dense matrix of a linear pytree operator.

    ``apply_fn(x) -> y`` with x, y pytrees shaped like ``template``.
    Returns (A, unravel) where ``A[i, j]`` acts on the raveled vector.
    """
    flat, unravel = ravel_pytree(template)
    n = flat.size

    def flat_apply(v):
        out = apply_fn(unravel(v))
        return ravel_pytree(out)[0]

    A = jax.vmap(flat_apply)(jnp.eye(n, dtype=flat.dtype)).T
    return A, unravel


def _fix_inactive_dense(A, b):
    """Replicate reference drop semantics: index i is inactive when row i or
    column i is all-zero; inactive rows/cols are replaced by identity."""
    row_nz = jnp.abs(A).sum(axis=1) > 0.0
    col_nz = jnp.abs(A).sum(axis=0) > 0.0
    keep = row_nz & col_nz
    d = keep.astype(A.dtype)
    A = A * d[:, None] * d[None, :] + jnp.diag(1.0 - d)
    b = jnp.where(keep, b, 0.0)
    return A, b


class DenseFactorSolver:
    """LU-factorized dense solve for repeated right-hand sides (the unsteady
    time loops reuse the factorization every step, mirroring the reference's
    single matrix build per scheme)."""

    def __init__(self, apply_fn, template):
        A_raw, self.unravel = materialize_dense(apply_fn, template)
        row_nz = jnp.abs(A_raw).sum(axis=1) > 0.0
        col_nz = jnp.abs(A_raw).sum(axis=0) > 0.0
        self.keep = row_nz & col_nz
        d = self.keep.astype(A_raw.dtype)
        A = A_raw * d[:, None] * d[None, :] + jnp.diag(1.0 - d)
        self.lu, self.piv = jax.scipy.linalg.lu_factor(A)

    def solve(self, b, x0=None):
        flat_b, _ = ravel_pytree(b)
        flat_b = jnp.where(self.keep, flat_b, 0.0)
        x = jax.scipy.linalg.lu_solve((self.lu, self.piv), flat_b)
        return self.unravel(x)


def _jacobi_precondition(diag):
    dinv = jnp.where(jnp.abs(diag) > 0, 1.0 / jnp.where(diag != 0, diag, 1.0), 1.0)

    def M(r):
        return jax.tree_util.tree_map(lambda a, b: a * b, dinv, r)

    return M


class KrylovSolver:
    """Matrix-free Krylov wrapper over jax.scipy.sparse.linalg, plus the
    in-house ``pgmres`` (row-equilibrated restarted GMRES — the robust
    choice for nonsymmetric/convective cut-cell systems).  For pgmres
    pass ``template`` (any pytree shaped like b) so the row-norm
    equilibrator is estimated once at construction, not per step."""

    def __init__(self, apply_fn, method="bicgstab", tol=1e-10, atol=0.0,
                 maxiter=None, M=None, template=None, restart=150):
        self.apply_fn = apply_fn
        self.method = method
        self.tol = tol
        self.atol = atol
        self.maxiter = maxiter
        self.M = M
        self.restart = restart
        self.Minv = (row_norm_equilibrator(apply_fn, template)
                     if method == "pgmres" and template is not None else None)

    def solve(self, b, x0=None):
        from jax.scipy.sparse.linalg import bicgstab, cg, gmres

        if self.method == "pgmres":
            Minv = self.Minv
            if Minv is None:
                Minv = row_norm_equilibrator(self.apply_fn, b)
            x, _, _ = pgmres(self.apply_fn, b,
                             x0 if x0 is not None else
                             jax.tree_util.tree_map(jnp.zeros_like, b),
                             Minv=Minv, tol=self.tol,
                             maxiter=self.maxiter or 2000,
                             restart=self.restart)
            return x
        if x0 is None:
            x0 = jax.tree_util.tree_map(jnp.zeros_like, b)
        # the in-house solvers converge on relres <= tol (floored at 8*eps
        # of the working dtype by _guards — tol=0 therefore means "to
        # rounding noise", not "exactly maxiter").  jax.scipy's absolute
        # criterion max(tol*||b||, atol) maps onto that as a tol bump.
        tol_eff = self.tol
        if self.atol:
            flat_b, _ = ravel_pytree(b)
            bnorm = jnp.maximum(jnp.linalg.norm(flat_b),
                                float(jnp.finfo(flat_b.dtype).tiny))
            tol_eff = jnp.maximum(tol_eff, self.atol / bnorm)
        if self.method in ("cg", "pcg"):
            # in-house pytree CG: jax.scipy's cg NaNs on rho-breakdown
            x, _, _ = pcg(self.apply_fn, b, x0, Minv=self.M, tol=tol_eff,
                          maxiter=self.maxiter or 2000)
        elif self.method in ("bicgstab", "pbicgstab"):
            x, _, _ = pbicgstab(self.apply_fn, b, x0, Minv=self.M,
                                tol=tol_eff, maxiter=self.maxiter or 2000)
        elif self.method == "gmres":
            x, _ = gmres(self.apply_fn, b, x0=x0, solve_method="batched",
                         tol=self.tol, atol=self.atol, maxiter=self.maxiter,
                         M=self.M)
        else:
            raise ValueError(f"unknown Krylov method {self.method}")
        return x


def solve_linear(apply_fn, b, method="auto", x0=None, tol=1e-10, maxiter=None,
                 M=None):
    """One-shot linear solve.  ``method``: auto | direct | cg | bicgstab |
    gmres.  ``auto`` chooses direct for small systems, bicgstab otherwise."""
    flat_b, _ = ravel_pytree(b)
    n = flat_b.size
    if method == "auto":
        method = "direct" if n <= 8000 else "pgmres"
    if method == "pgmres":
        # row-equilibrated restarted GMRES: the robust matrix-free default
        # for nonsymmetric cut-cell systems (plain bicgstab diverges on
        # convection-dominated ones, e.g. the Graetz channel at Pe h ~ 1).
        # The restart length is sized to a ~1.2 GB Krylov-basis budget so
        # large 3D systems (n ~ 1e7) don't materialize a 12 GB basis.
        Minv = row_norm_equilibrator(apply_fn, b)
        restart = int(min(150, max(20, 1.5e8 // max(n, 1))))
        x, _, _ = pgmres(apply_fn, b, x0 if x0 is not None else
                         jax.tree_util.tree_map(jnp.zeros_like, b),
                         Minv=Minv, tol=tol, maxiter=maxiter or 2000,
                         restart=restart)
        return x
    if method == "direct":
        A, unravel = materialize_dense(apply_fn, b)
        A, bb = _fix_inactive_dense(A, flat_b)
        x = jnp.linalg.solve(A, bb)
        return unravel(x)
    if method == "lstsq":
        # min-norm SVD solve: handles structurally singular saddle points
        # (orphan pressure modes) the way the reference's Krylov fallback
        # does (solve_stokes_linear_system!, stokes.jl:1540-1548)
        A, unravel = materialize_dense(apply_fn, b)
        A, bb = _fix_inactive_dense(A, flat_b)
        x, *_ = jnp.linalg.lstsq(A, bb, rcond=1e-12)
        return unravel(x)
    solver = KrylovSolver(apply_fn, method=method, tol=tol, maxiter=maxiter, M=M)
    return solver.solve(b, x0=x0)
