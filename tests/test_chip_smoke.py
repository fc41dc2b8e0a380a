"""The GPU smoke run's phases at tiny sizes on the CPU, its refusal to run
without a GPU, the compile-cache location, and the full-precision matmul
and inner-product sites (a float32 product on a GPU may run in TF32)."""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.extend.core import ClosedJaxpr, Jaxpr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import penguin_tpu as pt  # noqa: E402
from penguin_tpu import linsolve  # noqa: E402


@pytest.mark.parametrize("phase", [
    lambda: chip_smoke.phase_heat((64, 64)),
    lambda: chip_smoke.phase_heat((16, 16, 16)),
    lambda: chip_smoke.phase_collapse(32),
    lambda: chip_smoke.phase_ns(32, 16, steps=3),
    lambda: chip_smoke.phase_stefan(32, 32, steps=2),
], ids=["heat2d", "heat3d", "collapse", "ns", "stefan"])
def test_phase_tiny(phase):
    # 32-bit by default, as in the script's own process (the suite enables
    # 64-bit types globally; the f64 references turn them on themselves)
    with jax.enable_x64(False):
        result = phase()
    assert result.checks and result.ok(), result.line()
    assert np.isfinite(result.ms_per_step) and result.setup_s > 0


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_main_refuses_cpu(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert exc.value.code not in (0, None)
    assert "no GPU" in str(exc.value.code)
    assert capsys.readouterr().out == ""  # no phase ran, no result printed


@pytest.mark.parametrize("environ", [{}, {"JAX_COMPILATION_CACHE_DIR": ""}])
def test_compile_cache_in_checkout_when_unset(environ):
    path = pt._compile_cache_dir(environ)
    assert path == pt._compile_cache_dir(environ) == os.path.join(
        ROOT, ".jax_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_follows_variable(tmp_path):
    environ = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    assert pt._compile_cache_dir(environ) == str(tmp_path)


# ---------------------------------------------------------------------------
# every dot_general of the Krylov, preconditioner and normal-equation paths
# asks for HIGHEST precision
# ---------------------------------------------------------------------------

def _dot_precisions(jaxpr):
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                if isinstance(sub, ClosedJaxpr):
                    out += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, Jaxpr):
                    out += _dot_precisions(sub)
    return out


def _heat_jaxpr():
    from bench import heat_case

    case = heat_case((16, 16), jnp.float32, 100.0)
    return jax.make_jaxpr(case.fast.step)(case.T0)


def _krylov_jaxpr(name):
    fn = getattr(linsolve, name)
    d = jnp.linspace(1.0, 2.0, 16, dtype=jnp.float32)
    b = jnp.ones(16, jnp.float32)
    return jax.make_jaxpr(
        lambda b: fn(lambda x: d * x, b, jnp.zeros_like(b), Minv=1.0 / d,
                     tol=1e-5, maxiter=20))(b)


def _ns_jaxpr():
    from benchmarks.dfg_cylinder_shedding import dfg_case

    solver = dfg_case(32, 16, jnp.float32).solver
    probe = solver.make_pressure_probe([(0.15, 0.2)])
    solver.solve_unsteady_picard(0.002, 0.002, scheme="CN", picard_iters=1,
                                 method="fgmres", tol=1e-5, maxiter=10,
                                 record=probe)
    run = next(iter(solver._picard_run_cache.values()))
    return jax.make_jaxpr(run)(solver.zero_state(), 0.0)


def _stefan_jaxpr():
    from benchmarks.stefan2d_frank import frank_disk, run

    case = frank_disk(16, 16, jnp.float32)
    run(case, 1)
    s = case.solver
    return jax.make_jaxpr(s._run_cache)(s.u0, case.front.markers)


@pytest.mark.parametrize("make", [
    _heat_jaxpr,
    lambda: _krylov_jaxpr("pcg"),
    lambda: _krylov_jaxpr("pgmres"),
    lambda: _krylov_jaxpr("fgmres"),
    _ns_jaxpr,
    _stefan_jaxpr,
], ids=["heat_cg", "pcg", "pgmres", "fgmres", "ns_picard", "stefan_gn"])
def test_dots_run_at_highest_precision(make):
    with jax.enable_x64(False):
        precisions = _dot_precisions(make().jaxpr)
    assert precisions
    highest = jax.lax.Precision.HIGHEST
    assert all(p == (highest, highest) for p in precisions), precisions
