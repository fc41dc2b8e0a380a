"""penguin_tpu — a cut-cell finite-volume framework for accelerators.

From-scratch JAX/XLA re-design of the capabilities of the Julia
reference Penguin.jl (see SURVEY.md): level-set capacity construction,
matrix-free cut-cell operators, scalar diffusion / advection-diffusion /
Darcy solvers, diphasic interface-jump systems, moving interfaces (prescribed
and Stefan front-tracking), and Stokes/Navier-Stokes saddle-point solvers —
all jit-compiled, with Krylov solves replacing sparse direct factorization.
"""

import os as _os

import jax as _jax


def _compile_cache_dir(environ=_os.environ):
    """Where the persistent XLA compilation cache lives: the directory
    ``JAX_COMPILATION_CACHE_DIR`` names if it is set, else ``.jax_cache``
    at the root of the checkout.  The path is fixed (it is part of the
    cache's key), so a second process finds what a first one compiled."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


try:
    _cache_dir = _compile_cache_dir()
    _os.makedirs(_cache_dir, exist_ok=True)
    _jax.config.update("jax_compilation_cache_dir", _cache_dir)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
except OSError:  # pragma: no cover - the cache is an optimization only
    pass

from .mesh import Mesh, SpaceTimeMesh
from . import geometry
from .capacity import Capacity, compute_capacity
from .operators import (
    DiffusionOps,
    ConvectionOps,
    make_diffusion_ops,
    make_convection_ops,
)
from .boundary import (
    Dirichlet,
    Neumann,
    Robin,
    Periodic,
    Symmetry,
    Outflow,
    GibbsThomson,
    ScalarJump,
    FluxJump,
    BorderConditions,
    InterfaceConditions,
)
from .phase import Phase, Fluid
from .checkpoint import (checkpoint_solver, load_checkpoint, restore_solver,
                         save_checkpoint)
from .convergence import check_convergence, check_convergence_diph, lp_norm
from .utils import clamp_merge_small_cells

__all__ = [
    "clamp_merge_small_cells",
    "Mesh",
    "SpaceTimeMesh",
    "geometry",
    "Capacity",
    "compute_capacity",
    "DiffusionOps",
    "ConvectionOps",
    "make_diffusion_ops",
    "make_convection_ops",
    "Dirichlet",
    "Neumann",
    "Robin",
    "Periodic",
    "Symmetry",
    "Outflow",
    "GibbsThomson",
    "ScalarJump",
    "FluxJump",
    "BorderConditions",
    "InterfaceConditions",
    "Phase",
    "Fluid",
    "save_checkpoint",
    "load_checkpoint",
    "checkpoint_solver",
    "restore_solver",
    "check_convergence",
    "check_convergence_diph",
    "lp_norm",
]
