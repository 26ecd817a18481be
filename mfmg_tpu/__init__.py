"""mfmg_tpu — a matrix-free spectral-AMGe multigrid framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of ORNL-CEES/mfmg:
element-agglomeration AMGe with local spectral coarse spaces,
partition-of-unity weighted restriction, Galerkin coarse operators,
Jacobi/Chebyshev smoothers, V-cycle preconditioned CG — built as batched
array programs for an accelerator (batched dense eigensolves instead of
threaded per-agglomerate ARPACK loops, gather-free stencil applies instead of
cuSPARSE, and `jax.sharding` + `shard_map` halo exchange instead of MPI).
It runs on an NVIDIA GPU, and on the CPU for the tests.

Public API mirrors mfmg's Hierarchy (reference include/mfmg/common/hierarchy.hpp):

    from mfmg_tpu import Config, LaplaceProblem, Hierarchy
    problem = LaplaceProblem.hyper_cube(dim=3, n_refinements=2)
    hier = Hierarchy(problem, Config(...))
    x = hier.apply(b, x)        # one V-cycle (mfmg Hierarchy::apply)
    x, info = hier.solve_cg(b)  # V-cycle preconditioned CG
"""

from mfmg_tpu.config import Config, EigensolverConfig, SmootherConfig, CoarseConfig, AgglomerationConfig
from mfmg_tpu.fem.laplace import LaplaceProblem
from mfmg_tpu.amge.hierarchy import Hierarchy

__version__ = "0.1.0"

__all__ = [
    "Config",
    "EigensolverConfig",
    "SmootherConfig",
    "CoarseConfig",
    "AgglomerationConfig",
    "LaplaceProblem",
    "Hierarchy",
]
