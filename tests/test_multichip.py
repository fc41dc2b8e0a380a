"""Sharded-vs-single-device equality on the virtual 8-device CPU mesh —
the 'multi-node without a cluster' analogue from SURVEY.md §4."""

import jax
import pytest


def test_dryrun_heat_multichip():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from penguin_tpu.parallel.sharding import dryrun_heat_multichip

    dryrun_heat_multichip(8, grid=(31, 31))


def test_graft_entry_singlechip():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    out.block_until_ready()


def test_dryrun_stokes_multichip():
    """Sharded Stokes saddle-point apply == single-device apply on the
    8-device virtual mesh."""
    from penguin_tpu.parallel.sharding import dryrun_stokes_multichip

    dryrun_stokes_multichip(8, grid=(31, 31))


def test_dryrun_moving_multichip():
    """One full moving-geometry step (space-time capacity rebuild + Jacobi-
    BiCGStab slab solve) sharded == unsharded, on a grid that is NOT
    divisible by the device mesh (inert DOF padding grows to fit)."""
    from penguin_tpu.parallel.sharding import dryrun_moving_multichip

    dryrun_moving_multichip(8, grid=(30, 30))


def test_padded_mesh_physics_unchanged():
    """A mesh with extra inert DOF padding produces the same heat solution
    on the real cells as the standard pad=1 mesh."""
    import jax.numpy as jnp

    import penguin_tpu as pt
    from penguin_tpu.solvers.heat_fast import FastHeatBE

    def make(pad):
        mesh = pt.Mesh((30, 30), (4.0, 4.0), (0.0, 0.0), pad=pad)
        body = pt.geometry.circle((2.0, 2.0), 1.0)
        cap = pt.compute_capacity(body, mesh, p=4, s=1)
        ops = pt.make_diffusion_ops(cap)
        bc_b = pt.BorderConditions(
            {k: pt.Dirichlet(0.0) for k in ("left", "right", "top", "bottom")}
        )
        fast = FastHeatBE(cap, ops, 1.0, lambda x, y, z, t: 0.0,
                          pt.Dirichlet(1.0), bc_b, 0.01,
                          cg_tol=1e-10, cg_maxiter=200)
        T = fast.run(jnp.zeros(mesh.np_shape), 5)
        return T[:30, :30]

    T1 = make((1, 1))
    T2 = make((3, 2))
    assert float(jnp.abs(T1 - T2).max()) < 1e-10


def test_dryrun_stefan_multichip():
    """The FLAGSHIP sharded: one Stefan front-tracking GN step (marker SDF
    -> slab capacity -> LM solve -> marker move) with grid fields sharded
    over the 8-device mesh and markers replicated; sharded == unsharded and
    the compiled HLO contains no grid-sized all-gather."""
    from penguin_tpu.parallel.sharding import dryrun_stefan_multichip

    dryrun_stefan_multichip(8, grid=(32, 32), nm=32)


def test_dryrun_ns_multichip():
    """The chunked unsteady NS scan (CN/AB2 + preconditioned GMRES inner
    loop) sharded == unsharded, HLO free of grid-sized all-gathers — the
    production multi-chip flow path."""
    from penguin_tpu.parallel.sharding import dryrun_ns_multichip

    dryrun_ns_multichip(8)


@pytest.mark.slow
def test_dryrun_ns_picard_multichip():
    """The robust production NS path (implicit-Picard CN + fgmres with the
    DCT-CG block-Schur preconditioner) under SPMD: preconditioner equality
    sharded vs unsharded + zero grid-sized all-gathers in the scan HLO
    (the matmul DCT partitions; the FFT lowering did not)."""
    from penguin_tpu.parallel.sharding import dryrun_ns_picard_multichip

    n_gathers = dryrun_ns_picard_multichip(8)["gathers"]
    assert n_gathers == 0, n_gathers
