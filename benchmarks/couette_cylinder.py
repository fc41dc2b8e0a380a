"""Taylor-Couette flow between concentric cylinders (inner rotating) vs the
analytic azimuthal profile — reference
benchmark/navierstokes/couettecylinder.jl and
couettecylinder_convergence.jl.  Writes couette_cylinder.csv.

u_theta(r) = A r + B / r,  A = -Omega ri^2/(ro^2-ri^2), B = Omega ri^2 ro^2/(ro^2-ri^2)

Run:  python benchmarks/couette_cylinder.py
"""

import sys as _sys, os as _os
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

if "--convergence" in _sys.argv:
    # the convergence sweep is an f64 accuracy study: in f32 the n=128
    # profile error floors at the Krylov rounding level (~1.6e-2) and the
    # fitted order collapses
    from benchmarks.phaseflow.harness import ensure_cpu_f64
    ensure_cpu_f64()

import csv

import numpy as np
import jax.numpy as jnp

import penguin_tpu as pt
from penguin_tpu.solvers.stokes import StokesMono, PinPressureGauge

ri, ro, Om = 0.5, 1.5, 1.0
A = -Om * ri**2 / (ro**2 - ri**2)
B = Om * ri**2 * ro**2 / (ro**2 - ri**2)
c = (2.0 + 0.008, 2.0 + 0.008)


def solve(n):
    L = 4.0
    d = L / n
    mesh_p = pt.Mesh((n, n), (L, L), (0.0, 0.0))
    mesh_ux = pt.Mesh((n, n), (L, L), (-0.5 * d, 0.0))
    mesh_uy = pt.Mesh((n, n), (L, L), (0.0, -0.5 * d))
    annulus = lambda x, y: jnp.maximum(
        ri - jnp.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2),
        jnp.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2) - ro,
    )
    # moment-consistent cut flux (default; --centroid reverts to the
    # reference-parity centroid-sampled scheme for A/B comparison)
    moment = "--centroid" not in _sys.argv
    caps = [pt.compute_capacity(annulus, m, p=4, s=1, cut_moments=moment)
            for m in (mesh_ux, mesh_uy, mesh_p)]
    fluid = pt.Fluid(
        mesh_u=(mesh_ux, mesh_uy), mesh_p=mesh_p,
        capacity_u=(caps[0], caps[1]),
        operator_u=(pt.make_diffusion_ops(caps[0]),
                    pt.make_diffusion_ops(caps[1])),
        capacity_p=caps[2], operator_p=pt.make_diffusion_ops(caps[2]),
        mu=1.0, rho=1.0,
        f_u=lambda x, y, z: 0.0, f_p=lambda x, y, z: 0.0,
    )
    still = pt.Dirichlet(0.0)
    bc = pt.BorderConditions({k: still
                              for k in ("left", "right", "bottom", "top")})
    # interface velocity: rigid rotation on the inner wall, rest on the
    # outer — select by radius
    def ug_x(x, y, z, t=None):
        r = jnp.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2)
        return jnp.where(r < 0.5 * (ri + ro), -Om * (y - c[1]), 0.0)

    def ug_y(x, y, z, t=None):
        r = jnp.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2)
        return jnp.where(r < 0.5 * (ri + ro), Om * (x - c[0]), 0.0)

    s = StokesMono(fluid, (bc, bc), PinPressureGauge(),
                   (pt.Dirichlet(ug_x), pt.Dirichlet(ug_y)),
                   cut_flux="moment" if moment else "centroid")
    # auto -> block-Schur GMRES above the dense cutoff (the n=64 annulus
    # took minutes via dense lstsq; the preconditioned solve is seconds)
    s.solve(tol=1e-8)
    ux = np.asarray(s.velocity(0))
    Cy = np.asarray(caps[0].C_om)
    # sample u_x along the vertical line through the center: u_theta(r) = -u_x
    j = np.argmin(np.abs(np.asarray(mesh_ux.nodes[0]) + 0.5 * d - c[0]))
    ys = Cy[j, :, 1]
    r = np.abs(ys - c[1])
    sel = (r > ri + 2 * d) & (r < ro - 2 * d)
    u_th = np.where(ys > c[1], -ux[j, :], ux[j, :])
    exact = A * r + B / np.maximum(r, 1e-12)
    err = np.abs(u_th - exact)[sel]
    # effective wall radii: least-squares fit u_th = a r + b / r on the
    # sampled band, then solve a r + b/r = Om*ri (inner) / = 0 (outer) —
    # the walls the NUMERICAL profile actually enforces.  The round-3
    # centroid scheme put these O(h) off with a cut-phase-dependent sign
    # (ri_eff 0.4952/0.4908 at n=64/128); the moment-consistent scheme
    # keeps them within a tenth of a cell.
    M = np.stack([r[sel], 1.0 / r[sel]], 1)
    a_f, b_f = np.linalg.lstsq(M, u_th[sel], rcond=None)[0]
    ri_eff = np.nan
    if a_f * b_f < 0:
        ro_eff = float(np.sqrt(-b_f / a_f))  # a r + b/r = 0
        disc = (Om * ri) ** 2 - 4 * a_f * b_f
        ri_eff = float((Om * ri - np.sqrt(max(disc, 0.0))) / (2 * a_f))
    else:
        ro_eff = np.nan
    return (float(err.max()), float(np.abs(exact[sel]).max()),
            ri_eff, ro_eff)


import sys

if len(sys.argv) > 1 and sys.argv[1] == "--quick":
    sizes = (32,)
elif len(sys.argv) > 1 and sys.argv[1] == "--convergence":
    # reference couettecylinder_convergence.jl: sweep resolutions, print
    # successive convergence rates of the azimuthal profile error
    # (n=16 is excluded: the 2-cell-margin sampling band is empty there)
    sizes = (32, 64, 128)
else:
    sizes = (32, 64)
rows = []
for n in sizes:
    import time as _time
    t0 = _time.time()
    e, scale, ri_eff, ro_eff = solve(n)
    h = 4.0 / n
    print(f"n={n}: max|u_theta - exact| = {e:.4f} (rel {e/scale:.3f}) "
          f"ri_eff={ri_eff:.4f} ({(ri_eff-ri)/h:+.2f}h) "
          f"ro_eff={ro_eff:.4f} ({(ro_eff-ro)/h:+.2f}h) "
          f"[{_time.time()-t0:.1f} s]")
    rows.append((n, e, e / scale, ri_eff, ro_eff))

out = _os.path.join(_os.path.dirname(__file__), "couette_cylinder.csv")
with open(out, "w", newline="") as f:
    w = csv.writer(f)
    w.writerow(["n", "max_err", "rel_err", "ri_eff", "ro_eff"])
    w.writerows(rows)
print(f"wrote {out}")
moment_run = "--centroid" not in _sys.argv
if len(rows) >= 3:
    import numpy as _np
    ns = _np.array([r[0] for r in rows], float)
    es = _np.array([r[1] for r in rows], float)
    rates = _np.log2(es[:-1] / es[1:])
    print("successive rates:", " ".join(f"{r:.2f}" for r in rates))
    if moment_run:
        # moment-consistent cut flux (round 4): monotone convergence at
        # ~O(h^1.4-2) — measured 0.0048/0.0019/0.0005 (rates 1.37/1.78) —
        # and the fitted effective wall radii within a tenth of a cell.
        # The round-3 centroid scheme plateaued non-monotone at ~1e-2
        # (0.0212/0.0066/0.0155) with walls wandering O(h/2); the
        # reference shares that plateau (src/solver/stokes.jl:122-178).
        assert all(r > 1.0 for r in rates), rates
        assert rows[-1][2] < 0.005, rows
        for n_, _, _, ri_e, ro_e in rows[1:]:
            h_ = 4.0 / n_
            assert abs(ri_e - ri) < 0.15 * h_, (n_, ri_e)
            assert abs(ro_e - ro) < 0.15 * h_, (n_, ro_e)
    else:
        assert rates[0] > 0.9, rates
        assert all(r[2] < 0.08 for r in rows), rows
assert rows[-1][2] < (0.02 if moment_run else 0.08)
