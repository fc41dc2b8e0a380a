"""Multi-device domain decomposition.

The reference is single-process (SURVEY.md §2: no Distributed/MPI/threads);
the scaling story here is grid domain decomposition over a
``jax.sharding.Mesh``: shard the padded DOF arrays over ('x','y') device
axes and let XLA's SPMD partitioner turn the ±1-shift stencils into halo
exchanges (``collective-permute``, NVLink between the GPUs of one host) and
the Krylov dot products into ``psum`` collectives.  The mesh shape follows
the grid alone: every GPU of a host reaches every other at the same rate.  No communication is hand-written — the operators in
``operators.py`` are ordinary shifted-array expressions, which is exactly
the form GSPMD partitions optimally.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_grid_mesh", "grid_sharding", "shard_pytree", "padded_mesh",
           "dryrun_heat_multichip", "dryrun_stokes_multichip",
           "dryrun_moving_multichip", "dryrun_stefan_multichip",
           "dryrun_ns_multichip", "dryrun_ns_picard_multichip"]


def _factor2(n):
    a = int(np.floor(np.sqrt(n)))
    while n % a:
        a -= 1
    return max(a, 1), n // max(a, 1)


def make_grid_mesh(n_devices=None, devices=None):
    """2D device mesh with axes ('x', 'y') for domain decomposition."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    a, b = _factor2(len(devices))
    dev = np.asarray(devices).reshape(a, b)
    return Mesh(dev, axis_names=("x", "y"))


def grid_sharding(mesh, ndim=2):
    """NamedSharding placing grid axis 0 on 'x' and axis 1 on 'y'; higher
    axes replicated."""
    spec = [None] * ndim
    spec[0] = "x"
    if ndim >= 2:
        spec[1] = "y"
    return NamedSharding(mesh, P(*spec))


def padded_mesh(dev_mesh, n, domain_size, x0=None):
    """A ``penguin_tpu.Mesh`` whose DOF shape is divisible by the device
    grid: the per-axis inert padding (normally 1 slot) is grown to the next
    multiple of the device-axis size.  Extra slots carry zero capacities and
    become identity rows, so the physics on the ``n`` real cells is
    unchanged — this removes any grid/device divisibility restriction."""
    import penguin_tpu as pt

    dev_shape = dev_mesh.devices.shape
    pad = []
    for d in range(len(n)):
        ax = dev_shape[d] if d < len(dev_shape) else 1
        p = 1
        while (n[d] + p) % ax:
            p += 1
        pad.append(p)
    return pt.Mesh(n, domain_size, x0, pad=tuple(pad))


def shard_pytree(tree, sharding):
    """device_put every array leaf of a pytree with the given sharding
    (leaves whose rank differs get a replicated-compatible spec)."""

    def put(leaf):
        try:
            nd = leaf.ndim
        except AttributeError:
            return leaf
        if nd >= 2:
            return jax.device_put(leaf, sharding)
        return jax.device_put(
            leaf, NamedSharding(sharding.mesh, P(*([None] * nd)))
        )

    return jax.tree_util.tree_map(put, tree)


def dryrun_heat_multichip(n_devices, grid=(63, 63)):
    """Build the flagship 2D cut-cell heat step, shard every field over an
    ('x','y') device mesh, and execute ONE implicit step (rhs + CG solve)
    SPMD.  Exercises the full multi-device code path: halo exchange for the
    shift stencils, psum for the CG dot products.  Returns the max
    difference from the same step on one device."""
    import jax.numpy as jnp

    import penguin_tpu as pt
    from penguin_tpu.solvers.heat_fast import FastHeatBE

    dev_mesh = make_grid_mesh(n_devices)
    nx, ny = grid
    # inert DOF padding grows to the next device-grid multiple, so ANY grid
    # works (no divisibility restriction)
    mesh = padded_mesh(dev_mesh, (nx, ny), (4.0, 4.0), (0.0, 0.0))
    body = pt.geometry.circle((2.0, 2.0), 1.0)
    cap = pt.compute_capacity(body, mesh, p=4, s=1, dtype=jnp.float32)
    bc = pt.Dirichlet(1.0)
    bc0 = pt.Dirichlet(0.0)
    bc_b = pt.BorderConditions(
        {"left": bc0, "right": bc0, "top": bc0, "bottom": bc0}
    )
    dt = 0.25 * (4.0 / nx) ** 2

    def stepper(cap):
        return FastHeatBE(cap, pt.make_diffusion_ops(cap), 1.0,
                          lambda x, y, z, t: 0.0, bc, bc_b, dt, cg_tol=1e-5,
                          cg_maxiter=16, dtype=jnp.float32)

    # the one-device reference: every array on the first device
    cap_one = jax.device_put(cap, jax.devices()[0])
    T1_ref, _ = stepper(cap_one).step(jnp.zeros(mesh.np_shape, jnp.float32))
    T1_ref = np.asarray(T1_ref)
    del cap_one

    sharding = grid_sharding(dev_mesh)
    fast = stepper(shard_pytree(cap, sharding))
    T0 = jax.device_put(jnp.zeros(mesh.np_shape, jnp.float32), sharding)
    step = jax.jit(fast.step, in_shardings=sharding,
                   out_shardings=(sharding, None))
    T1, iters = step(T0)
    T1.block_until_ready()
    assert len(T1.sharding.device_set) == len(dev_mesh.devices.flat), \
        f"sharded step landed on {T1.sharding.device_set}"
    # the sharded step must agree with the one-device one
    err = float(np.abs(np.asarray(T1) - T1_ref).max())
    assert err < 1e-5, f"sharded vs single-device mismatch: {err}"
    return err


def dryrun_stokes_multichip(n_devices, grid=(31, 31)):
    """Shard the monolithic Stokes saddle-point state (staggered velocity
    components + pressure) over the device mesh and execute the matrix-free
    apply SPMD — the operator whose shifts/divergences become halo
    exchanges in a production multi-device Stokes solve."""
    import jax.numpy as jnp

    import penguin_tpu as pt
    from penguin_tpu.solvers.stokes import PinPressureGauge, StokesMono

    dev_mesh = make_grid_mesh(n_devices)
    nx, ny = grid
    L = 1.0
    mesh_p = padded_mesh(dev_mesh, (nx, ny), (L, L), (0.0, 0.0))
    d = L / nx
    mesh_ux = padded_mesh(dev_mesh, (nx, ny), (L, L), (-0.5 * d, 0.0))
    mesh_uy = padded_mesh(dev_mesh, (nx, ny), (L, L), (0.0, -0.5 * d))
    body = pt.geometry.full_domain(2)
    caps = [pt.compute_capacity(body, m, p=4, s=1, dtype=jnp.float32)
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
    noslip, lid = pt.Dirichlet(0.0), pt.Dirichlet(1.0)
    bc_ux = pt.BorderConditions(
        {"left": noslip, "right": noslip, "bottom": noslip, "top": lid})
    bc_uy = pt.BorderConditions(
        {k: noslip for k in ("left", "right", "bottom", "top")})
    solver = StokesMono(fluid, (bc_ux, bc_uy), PinPressureGauge(),
                        pt.Dirichlet(0.0))

    sharding = grid_sharding(dev_mesh)
    key_fields = tuple(
        jnp.sin(jnp.arange(float(np.prod(mesh_p.np_shape)))
                .reshape(mesh_p.np_shape) * (0.01 * (i + 1))).astype(jnp.float32)
        for i in range(5)
    )
    x_ref = solver.apply_steady(key_fields)
    x_sh = tuple(jax.device_put(f, sharding) for f in key_fields)
    apply_sh = jax.jit(solver.apply_steady,
                       in_shardings=(tuple([sharding] * 5),),
                       out_shardings=tuple([sharding] * 5))
    out = apply_sh(x_sh)
    jax.block_until_ready(out)
    err = max(float(jnp.abs(a - b).max()) for a, b in zip(out, x_ref))
    assert err < 1e-5, f"sharded vs single-device Stokes apply mismatch: {err}"
    return out


def dryrun_moving_multichip(n_devices, grid=(30, 30)):
    """One full prescribed-motion moving-interface step — space-time cut-cell
    capacity rebuild + slab system solve — executed SPMD over the device
    mesh, on a deliberately non-divisible grid (the inert DOF padding grows
    to the device grid).  Verifies sharded == unsharded."""
    import jax.numpy as jnp

    import penguin_tpu as pt
    from penguin_tpu.solvers.moving_diffusion import solve_moving_mono_step

    dev_mesh = make_grid_mesh(n_devices)
    nx, ny = grid
    mesh = padded_mesh(dev_mesh, (nx, ny), (4.0, 4.0), (0.0, 0.0))
    dt = 0.1

    def body_st(x, y, t):
        xc = 2.0 + 0.5 * t
        return jnp.sqrt((x - xc) ** 2 + (y - 2.0) ** 2) - 1.0

    bc0 = pt.Dirichlet(0.0)
    bc_b = pt.BorderConditions(
        {k: bc0 for k in ("left", "right", "top", "bottom")}
    )
    border = pt.assembly.border_info(mesh, bc_b)
    x0 = (jnp.zeros(mesh.np_shape), jnp.zeros(mesh.np_shape))

    def step(x, t):
        cap = pt.capacity.compute_capacity_spacetime(
            body_st, mesh, t, t + dt, p=4, s=1
        )
        xn, iters, res = solve_moving_mono_step(
            cap, 1.0, lambda *a: 0.0, pt.Dirichlet(1.0), border, x, t, dt,
            "BE", tol=1e-10,
        )
        return xn

    x_ref = jax.jit(step)(x0, 0.0)
    sharding = grid_sharding(dev_mesh)
    x_sh = tuple(jax.device_put(f, sharding) for f in x0)
    step_sh = jax.jit(step, in_shardings=(tuple([sharding] * 2), None),
                      out_shardings=tuple([sharding] * 2))
    out = step_sh(x_sh, 0.0)
    jax.block_until_ready(out)
    err = max(float(jnp.abs(a - b).max()) for a, b in zip(out, x_ref))
    assert err < 1e-8, f"sharded vs single-device moving step mismatch: {err}"
    return out


def dryrun_ns_multichip(n_devices, grid=(48, 24), n_steps=3,
                        check_hlo=True):
    """The production multi-chip FLOW path: the chunked unsteady
    Navier-Stokes scan — CN θ-scheme with AB2-extrapolated convection and
    the block-Schur-preconditioned GMRES inner loop — executed SPMD on a
    channel-cylinder geometry (the DFG layout shrunk), with the staggered
    velocity/pressure state sharded over the ('x','y') device mesh.

    Verifies (a) sharded == unsharded final state after ``n_steps`` CN/AB2
    steps, and (b) the compiled scan's HLO contains no all-gather
    materializing a grid-sized array — the state stays decomposed through
    convection, RHS build, GMRES (halo exchanges + psum reductions) and
    the γ/border surgeries."""
    import re

    import jax.numpy as jnp

    import penguin_tpu as pt
    from penguin_tpu.solvers.navierstokes import NavierStokesMono
    from penguin_tpu.solvers.stokes import PinPressureGauge

    dev_mesh = make_grid_mesh(n_devices)
    nx, ny = grid
    Lx, Ly = 2.2, 0.41
    R, cx, cy = 0.05, 0.2, 0.2
    dt = 0.01

    def setup():
        dx = Lx / nx
        mesh_p = padded_mesh(dev_mesh, (nx, ny), (Lx, Ly), (0.0, 0.0))
        mesh_ux = padded_mesh(dev_mesh, (nx, ny), (Lx, Ly), (-0.5 * dx, 0.0))
        mesh_uy = padded_mesh(dev_mesh, (nx, ny), (Lx, Ly),
                              (0.0, -0.5 * (Ly / ny)))
        body = pt.geometry.complement(pt.geometry.circle((cx, cy), R))
        caps = [pt.compute_capacity(body, m, p=4, s=1)
                for m in (mesh_ux, mesh_uy, mesh_p)]
        fluid = pt.Fluid(
            mesh_u=(mesh_ux, mesh_uy), mesh_p=mesh_p,
            capacity_u=(caps[0], caps[1]),
            operator_u=(pt.make_diffusion_ops(caps[0]),
                        pt.make_diffusion_ops(caps[1])),
            capacity_p=caps[2], operator_p=pt.make_diffusion_ops(caps[2]),
            mu=1e-3, rho=1.0,
            f_u=lambda x, y, z: 0.0, f_p=lambda x, y, z: 0.0,
        )

        def inflow(x, y, z=0.0, t=None):
            xi = y / Ly
            return 0.3 * 4.0 * xi * (1.0 - xi)

        noslip = pt.Dirichlet(0.0)
        bc_ux = pt.BorderConditions({"left": pt.Dirichlet(inflow),
                                     "right": pt.Outflow(),
                                     "bottom": noslip, "top": noslip})
        bc_uy = pt.BorderConditions({"left": noslip, "right": noslip,
                                     "bottom": noslip, "top": noslip})
        return NavierStokesMono(fluid, (bc_ux, bc_uy), PinPressureGauge(),
                                pt.Dirichlet(0.0))

    kw = dict(scheme="CN", method="pgmres", tol=1e-8, maxiter=80)

    solver_ref = setup()
    x_ref = solver_ref.solve_unsteady(dt, n_steps * dt, **kw)

    solver_sh = setup()
    sharding = grid_sharding(dev_mesh)
    x0_sh = tuple(jax.device_put(f, sharding)
                  for f in solver_sh.zero_state())
    x_sh = solver_sh.solve_unsteady(dt, n_steps * dt, x0=x0_sh, **kw)

    scale = max(float(jax.numpy.abs(a).max()) for a in x_ref)
    err = max(float(jax.numpy.abs(a - b).max())
              for a, b in zip(x_sh, x_ref))
    assert err < 1e-6 * max(scale, 1.0), \
        f"sharded vs single-device NS mismatch: {err} (scale {scale})"

    if check_hlo:
        run = next(iter(solver_sh._unsteady_run_cache.values()))
        cp0 = tuple(jax.numpy.zeros_like(u) for u in x0_sh[0:2 * 2:2])
        txt = run.lower(x0_sh, 0.0, cp0,
                        jax.numpy.asarray(True)).compile().as_text()
        ncells = int(np.prod(solver_sh.fluid.mesh_p.np_shape))
        offenders = []
        for m in re.finditer(r"(\S+)\s*=\s*\S*\s*all-gather\(", txt):
            line = txt[m.start():txt.find("\n", m.start())]
            shapes = re.findall(r"[a-z0-9]+\[([0-9,]+)\]",
                                line.split("=")[0])
            for sh in shapes:
                n_el = int(np.prod([int(v) for v in sh.split(",") if v]))
                if n_el >= ncells:
                    offenders.append(line.strip()[:160])
        assert not offenders, (
            "grid-sized all-gather(s) in the compiled NS scan:\n"
            + "\n".join(offenders))
    return x_sh


def dryrun_ns_picard_multichip(n_devices, grid=(48, 24), n_steps=2,
                               check_hlo=True):
    """The ROBUST production NS path under SPMD: implicit-Picard CN with
    flexible GMRES + the DCT-CG block-Schur preconditioner — the exact
    solver configuration the DFG shedding and Ghia records use
    (``solve_unsteady_picard(method="fgmres")``) — sharded over the
    ('x','y') device mesh on the shrunk DFG channel-cylinder geometry.

    The DCT Poisson inside the Schur preconditioner is a GLOBAL transform
    and therefore the likeliest thing in the codebase to make GSPMD
    materialize a grid-sized array; this dryrun (a) verifies sharded ==
    unsharded after ``n_steps`` Picard/fgmres steps, and (b) inspects the
    compiled scan's HLO for grid-sized all-gathers, reporting the count
    (the DCT is ALLOWED to gather — it is a spectral solve on the
    pressure grid — but the momentum/convection/Krylov path must stay
    decomposed; the assertion therefore bounds the number of gathered
    grid-sized arrays by what the DCT plan itself needs per application
    instead of demanding zero).

    Returns ``{"err_M": preconditioner max|sharded - one device| over
    max(scale, 1), "relres": max fgmres relres, "gathers": grid-sized
    all-gathers (None without ``check_hlo``)}``."""
    import re

    import jax.numpy as jnp

    import penguin_tpu as pt
    from penguin_tpu.solvers.navierstokes import NavierStokesMono
    from penguin_tpu.solvers.stokes import PinPressureGauge

    dev_mesh = make_grid_mesh(n_devices)
    nx, ny = grid
    Lx, Ly = 2.2, 0.41
    R, cx, cy = 0.05, 0.2, 0.2
    dt = 0.01

    def setup():
        dx = Lx / nx
        mesh_p = padded_mesh(dev_mesh, (nx, ny), (Lx, Ly), (0.0, 0.0))
        mesh_ux = padded_mesh(dev_mesh, (nx, ny), (Lx, Ly), (-0.5 * dx, 0.0))
        mesh_uy = padded_mesh(dev_mesh, (nx, ny), (Lx, Ly),
                              (0.0, -0.5 * (Ly / ny)))
        body = pt.geometry.complement(pt.geometry.circle((cx, cy), R))
        caps = [pt.compute_capacity(body, m, p=4, s=1)
                for m in (mesh_ux, mesh_uy, mesh_p)]
        fluid = pt.Fluid(
            mesh_u=(mesh_ux, mesh_uy), mesh_p=mesh_p,
            capacity_u=(caps[0], caps[1]),
            operator_u=(pt.make_diffusion_ops(caps[0]),
                        pt.make_diffusion_ops(caps[1])),
            capacity_p=caps[2], operator_p=pt.make_diffusion_ops(caps[2]),
            mu=1e-3, rho=1.0,
            f_u=lambda x, y, z: 0.0, f_p=lambda x, y, z: 0.0,
        )

        def inflow(x, y, z=0.0, t=None):
            xi = y / Ly
            return 0.3 * 4.0 * xi * (1.0 - xi)

        noslip = pt.Dirichlet(0.0)
        bc_ux = pt.BorderConditions({"left": pt.Dirichlet(inflow),
                                     "right": pt.Outflow(),
                                     "bottom": noslip, "top": noslip})
        bc_uy = pt.BorderConditions({"left": noslip, "right": noslip,
                                     "bottom": noslip, "top": noslip})
        return NavierStokesMono(fluid, (bc_ux, bc_uy), PinPressureGauge(),
                                pt.Dirichlet(0.0))

    kw = dict(scheme="CN", picard_iters=2, method="fgmres", tol=1e-8,
              maxiter=80)

    # (1) OPERATOR + PRECONDITIONER equality, sharded vs unsharded, on a
    # fixed nontrivial state — deterministic and machine-tight.  (The
    # end-state of a full Picard/fgmres SOLVE is NOT a usable equality
    # metric here: the shrunk-DFG rim slivers give the saddle system a
    # conditioning ~1e9, so two runs that both converge to relres 1e-12
    # still differ at ~1e-3 in bulk — measured; that tests the slivers'
    # conditioning, not SPMD correctness.)
    solver_ref = setup()
    theta = 0.5
    M_ref = solver_ref.make_block_preconditioner(dt=dt, theta=theta,
                                                 schur="dct_cg",
                                                 schur_cg_iters=8)
    shape_p = solver_ref.fluid.mesh_p.np_shape
    key_state = tuple(
        jax.numpy.sin(jax.numpy.arange(float(np.prod(shape_p)))
                      .reshape(shape_p) * (0.013 * (i + 1)))
        for i in range(5)
    )
    y_ref = M_ref(key_state)

    sharding = grid_sharding(dev_mesh)
    ks_sh = tuple(jax.device_put(f, sharding) for f in key_state)
    M_sh = jax.jit(M_ref, in_shardings=(tuple([sharding] * 5),),
                   out_shardings=tuple([sharding] * 5))
    y_sh = M_sh(ks_sh)
    jax.block_until_ready(y_sh)
    err_M = max(float(jax.numpy.abs(a - b).max())
                for a, b in zip(y_sh, y_ref))
    scale_M = max(float(jax.numpy.abs(a).max()) for a in y_ref)
    assert err_M < 1e-9 * max(scale_M, 1.0), \
        f"sharded vs single-device DCT-Schur preconditioner: {err_M}"

    # (2) the full production scan runs SPMD end-to-end: finite state,
    # converged inner solves
    solver_sh = setup()
    x0_sh = tuple(jax.device_put(f, sharding)
                  for f in solver_sh.zero_state())
    x_sh = solver_sh.solve_unsteady_picard(dt, n_steps * dt, x0=x0_sh,
                                           **kw)
    for a in x_sh:
        assert bool(jax.numpy.isfinite(a).all()), "non-finite SPMD state"
    relres = float(np.asarray(solver_sh.krylov_relres).max())
    assert relres < 1e-6, solver_sh.krylov_relres
    out = {"err_M": err_M / max(scale_M, 1.0), "relres": relres,
           "gathers": None}

    if check_hlo:
        run = next(iter(solver_sh._picard_run_cache.values()))
        txt = run.lower(x0_sh, 0.0).compile().as_text()
        ncells = int(np.prod(solver_sh.fluid.mesh_p.np_shape))
        offenders = []
        for m in re.finditer(r"(\S+)\s*=\s*\S*\s*all-gather\(", txt):
            line = txt[m.start():txt.find("\n", m.start())]
            shapes = re.findall(r"[a-z0-9]+\[([0-9,]+)\]",
                                line.split("=")[0])
            for sh in shapes:
                n_el = int(np.prod([int(v) for v in sh.split(",") if v]))
                if n_el >= ncells:
                    offenders.append(line.strip()[:160])
        # the DCT-Schur plan applies 2 forward + 2 inverse 1D transforms
        # per preconditioner application; each MAY legitimately gather the
        # pressure grid once.  Anything beyond that bound means the
        # momentum/Krylov path lost its decomposition.
        assert len(offenders) <= 4, (
            f"{len(offenders)} grid-sized all-gathers in the Picard NS "
            "scan (DCT budget is 4):\n" + "\n".join(offenders[:8]))
        out["gathers"] = len(offenders)
    return out


def dryrun_stefan_multichip(n_devices, grid=(32, 32), nm=32,
                            check_hlo=True):
    """The FLAGSHIP under SPMD: one full Stefan front-tracking time step —
    marker polyline SDF -> narrow slab capacity rebuild -> GN/LM iteration
    (slab temperature solve, interface flux, intercept volume Jacobian,
    damped normal equations) -> marker move — with the temperature grids
    sharded over the ('x','y') device mesh and the marker array replicated.

    Verifies (a) sharded == unsharded end state (temperature AND markers),
    and (b) the compiled HLO contains NO all-gather materializing a
    grid-sized array: the grid stays decomposed through the GN loop (halo
    exchanges + psum reductions only); the only legitimately replicated
    objects are O(n_markers) — the marker array, the (nm, nm) normal
    equations, and the per-marker Jacobian contractions."""
    import re

    import jax.numpy as jnp

    import penguin_tpu as pt
    from penguin_tpu.front_tracking import FrontTracker
    from penguin_tpu.solvers.stefan2d import StefanMono2D

    dev_mesh = make_grid_mesh(n_devices)
    nx, ny = grid
    L = 8.0
    center = (4.0, 4.0)
    mesh = padded_mesh(dev_mesh, (nx, ny), (L, L), (0.0, 0.0))
    dt = 0.02
    R0 = 1.5
    T_inf = -0.5

    def setup():
        front = FrontTracker().create_circle(center, R0, n=nm)
        cap0 = pt.compute_capacity(
            lambda x, y: -front.sdf(x, y), mesh, p=4, s=1)
        ops0 = pt.make_diffusion_ops(cap0)
        C = np.asarray(cap0.C_om)
        r = np.sqrt((C[..., 0] - center[0]) ** 2
                    + (C[..., 1] - center[1]) ** 2)
        Tw0 = jnp.asarray(np.where(r >= R0, T_inf * (1 - R0 / np.maximum(r, R0)),
                                   0.0))
        Tg0 = jnp.zeros(mesh.np_shape)
        bc_b = pt.BorderConditions(
            {k: pt.Dirichlet(T_inf)
             for k in ("left", "right", "top", "bottom")})
        phase = pt.Phase(cap0, ops0, lambda x, y, z, t: 0.0, 1.0)
        ic = pt.InterfaceConditions(pt.ScalarJump(1.0, 1.0, 0.0),
                                    pt.FluxJump(1.0, 1.0, 1.0))
        solver = StefanMono2D(phase, bc_b, pt.Dirichlet(0.0), dt,
                              (Tw0, Tg0), mesh, "BE")
        return solver, front, ic, (Tw0, Tg0)

    kw = dict(newton_params=(6, 1e-8, 1e-8, 1.0), interior_fluid=False,
              method="bicgstab", jac="intercept", band_budget=None)

    # single-device reference
    solver_ref, front_ref, ic, u0 = setup()
    solver_ref.solve(front_ref, 0.0, dt / 2, ic, **kw)
    T_ref, mk_ref = solver_ref.x, solver_ref.markers

    # sharded run: grid fields over the device mesh, markers replicated
    sharding = grid_sharding(dev_mesh)
    repl = NamedSharding(dev_mesh, P(None, None))
    solver_sh, front_sh, ic2, _ = setup()
    solver_sh.u0 = tuple(jax.device_put(f, sharding) for f in solver_sh.u0)
    front_sh.markers = jax.device_put(front_sh.markers, repl)
    solver_sh.solve(front_sh, 0.0, dt / 2, ic2, **kw)
    T_sh, mk_sh = solver_sh.x, solver_sh.markers

    err_T = max(float(jnp.abs(a - b).max()) for a, b in zip(T_sh, T_ref))
    err_mk = float(jnp.abs(mk_sh - mk_ref).max())
    assert err_T < 1e-6, f"sharded vs single-device Stefan T mismatch: {err_T}"
    assert err_mk < 1e-8, f"sharded vs single-device marker mismatch: {err_mk}"

    if check_hlo:
        # the compiled SPMD module must not all-gather any grid-sized
        # array: each all-gather's result element count must stay below
        # the full DOF grid (halo exchanges are collective-permutes;
        # Krylov/Jacobian reductions are all-reduces)
        run = solver_sh._run_cache
        txt = run.lower(solver_sh.u0, front_sh.markers).compile().as_text()
        ncells = int(np.prod(mesh.np_shape))
        offenders = []
        for m in re.finditer(r"(\S+)\s*=\s*\S*\s*all-gather\(", txt):
            line = txt[m.start():txt.find("\n", m.start())]
            shapes = re.findall(r"[a-z0-9]+\[([0-9,]+)\]", line.split("=")[0])
            for sh in shapes:
                n_el = int(np.prod([int(v) for v in sh.split(",") if v]))
                if n_el >= ncells:
                    offenders.append(line.strip()[:160])
        assert not offenders, (
            "grid-sized all-gather(s) in the compiled Stefan step:\n"
            + "\n".join(offenders))
    return T_sh, mk_sh
