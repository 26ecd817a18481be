"""Configuration for mfmg_tpu.

Dataclass analog of mfmg's boost::property_tree parameter trees
(reference tests/data/hierarchy_input.info and
include/mfmg/common/hierarchy.hpp:168-172 for the defaults).  The same keys are
accepted from nested dicts via :meth:`Config.from_dict`, and from mfmg-style
``.info`` files via :meth:`Config.from_info` (see utils/info_parser.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class EigensolverConfig:
    """Parameters of the per-agglomerate eigensolver.

    Mirrors the ``eigensolver`` subtree (reference
    dealii/amge_host.templates.hpp:164-207 for how each key is consumed).

    type: "lapack" (batched dense eigh — the default, analog of the
      reference's LAPACK/cuSOLVER paths), "lanczos" (batched Lanczos with
      Cullum-Willoughby filtering), "anasazi" (batched LOBPCG,
      eigen/lobpcg.py, with use_initial_guess warm-start support), or
      "arpack" (genuine shift-invert ARPACK per agglomerate, eigen/arpack.py
      — the same Fortran ARPACK the reference links through deal.II).
    """

    type: str = "lapack"
    # Eigenvectors per SUPER-agglomerate on recursive levels (>= 1); None =
    # same as n_eigenvectors.  Deep levels coarsen s^dim-fold per step, so a
    # richer deep space is nearly free in apply cost and buys V-cycle
    # quality (bench config: rate 0.67 -> 0.57 with deep=4 at +12 us/cycle).
    n_eigenvectors_deep: Optional[int] = None
    # Constrained-dof treatment in the local eigenproblems: "auto" follows the
    # reference's convention for the chosen operator path (matrix path -> "pin"
    # = shift + diag 200; matrix-free path -> "identity" = diag 1); "raw"
    # reproduces the reference CUDA path (fragile, see eigen/batched_eigh.py).
    constrained_mode: str = "auto"
    # Where to run the batched dense eigensolve: "host" (LAPACK, float64),
    # "device" (on the accelerator), or "auto" (the level-0 structured batch
    # runs eigen/device_eig.py on a GPU, everything else runs on the host).
    backend: str = "auto"
    n_eigenvectors: int = 2            # "number of eigenvectors"
    tolerance: float = 1e-14
    max_iterations: int = 200
    percent_overshoot: int = 5
    is_deflated: bool = False
    num_cycles: int = 1
    num_eigenpairs_per_cycle: int = 1
    use_initial_guess: bool = False
    # Anasazi "Full Ortho" stability mode (anasazi.templates.hpp:56-88):
    # True = QR-orthonormalize the whole LOBPCG trial basis each iteration
    # (the reference driver's setting); False = raw-basis generalized
    # Rayleigh-Ritz (Anasazi's cheaper, less stable default).
    full_ortho: bool = True


@dataclasses.dataclass
class SmootherConfig:
    """Smoother parameters (reference source/dealii/dealii_smoother.cc:25-70,
    dealii_matrix_free_smoother.cc:25-60).

    type: "jacobi" (the reference's device smoother,
      source/cuda/cuda_smoother.cu:39-60), "chebyshev" (the reference's
      matrix-free smoother), or "symmetric gauss-seidel"/"gauss-seidel"
      (implemented as data-parallel multicolor sweeps).
    n_smoothing_steps: pre- and post-smoothing step count per level.
    degree / smoothing_range / max_eigenvalue: Chebyshev parameters matching
      deal.II's PreconditionChebyshev::AdditionalData semantics.
    """

    type: str = "jacobi"
    # Gauss-Seidel ordering: "multicolor" (data-parallel sweeps, the
    # production choice) or "lexicographic" (the reference's sequential
    # Trilinos SOR/SSOR semantics, dealii_smoother.cc:38-52, realized as
    # dense triangular solves — the golden-rate parity oracle, O(n^2) memory,
    # capped at small n).
    coloring: str = "multicolor"
    # Sweep ordering for coloring="lexicographic": "natural" (our x-fastest
    # dof numbering) or "dealii" (the reference's DoFHandler numbering via
    # fem/dealii_order.py — required to reproduce the sequential-GS golden
    # rates bit-for-bit, test_hierarchy.cc:343-356).
    ordering: str = "natural"
    n_smoothing_steps: int = 1
    degree: int = 1
    smoothing_range: float = 0.0
    max_eigenvalue: Optional[float] = None
    # Chebyshev eigenvalue-interval estimator when max_eigenvalue is None:
    #   "lanczos"   — converged (40-step) Lanczos interval; the production
    #                 default.  An accurate lmax is what keeps the V-cycle
    #                 contraction (and hence PCG iteration counts) intact at
    #                 scale.
    #   "dealii_cg" — deal.II PreconditionChebyshev parity: exactly
    #                 eig_cg_n_iterations (default 8) preconditioned-CG steps
    #                 from the i%11 start vector.  Deliberately under-converged
    #                 — the reference's golden rates depend on it — so it is
    #                 the golden-parity mode, NOT the production default
    #                 (an 8-step estimate underestimates lmax badly at 10^5+
    #                 dofs: measured PCG 10 -> 17 iterations at 274k).
    eig_estimate: str = "lanczos"
    eig_cg_n_iterations: int = 8
    jacobi_omega: float = 1.0


@dataclasses.dataclass
class CoarseConfig:
    """Coarsest-level solver (reference source/dealii/dealii_solver.cc:25-87,
    source/cuda/cuda_solver.cu:42-515).

    type: "direct" (dense Cholesky factorization at setup, triangular solves at
      apply — the analog of Amesos-KLU / cusolver lu_dense), "cg" (iterative
      coarse solve), or "amg" (recursive AMGe hierarchy on the coarse matrix —
      analog of the reference's ML/AMGX coarse solvers).
    """

    type: str = "direct"
    # "cg" coarse solver controls
    tolerance: float = 1e-12
    max_iterations: int = 200
    # "amg"/"ml" coarse solver: parameters of the recursive hierarchy
    max_levels: int = 2
    n_agglomerates: int = 8
    # ML-style parameter-list overlay (the analog of the reference's
    # ptree2plist coarse.params.* keys, source/common/utils.cc:20-80);
    # consumed by solve/coarse._build_algebraic_amg, unknown keys warn.
    params: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class AgglomerationConfig:
    """Agglomerate partitioning (reference common/amge.templates.hpp:51-85).

    partitioner "block": nx/ny/nz cells per agglomerate in each dimension
    (the reference's x->y->z block walk, amge.templates.hpp:412-499).
    partitioner "metis"/"zoltan": target ``n_agglomerates`` via graph
    partitioning of the cell connectivity graph.
    """

    partitioner: str = "block"
    nx: int = 2
    ny: int = 2
    nz: int = 2
    n_agglomerates: int = 4

    def block_dims(self, dim: int):
        return (self.nx, self.ny, self.nz)[:dim]


@dataclasses.dataclass
class Config:
    """Top-level hierarchy parameters (reference common/hierarchy.hpp:159-236).

    max_levels default 2 and is_preconditioner default True match
    hierarchy.hpp:168-172.  fast_ap selects the matrix-free construction of
    A·Rᵀ from per-agglomerate pieces (dealii_hierarchy_helpers.cc:77-288).
    """

    max_levels: int = 2
    is_preconditioner: bool = True
    # None = auto: fast AP on for matrix-free-style operators (stencil /
    # matrix_free / sumfac — the global fine matrix is then never assembled),
    # off for the assembled ELL path.  Explicit True/False is respected.
    fast_ap: bool | None = None
    # Multigrid cycle shape: "v" (the reference's only cycle), "w", or "f".
    # Only meaningful for max_levels > 2 (all cycles coincide at 2 levels).
    cycle_type: str = "v"
    eigensolver: EigensolverConfig = dataclasses.field(default_factory=EigensolverConfig)
    smoother: SmootherConfig = dataclasses.field(default_factory=SmootherConfig)
    coarse: CoarseConfig = dataclasses.field(default_factory=CoarseConfig)
    agglomeration: AgglomerationConfig = dataclasses.field(default_factory=AgglomerationConfig)
    # Operator representation for the fine level: "ell" (assembled sparse,
    # analog of the reference's matrix path), "matrix_free" (cell-local
    # apply, analog of DealIIMatrixFreeOperator), "sumfac" (sum-factorized
    # high-order matrix-free), or "stencil" (structured-grid fast path).
    operator: str = "ell"
    # Device compute dtype for the apply path ("float32"/"float64"/"bfloat16").
    # Setup always runs in float64 on host.
    dtype: str = "float64"
    # Distribute the level-0 setup across jax.distributed processes (each
    # process assembles + eigensolves only its own contiguous agglomerate
    # slab; eigenvectors / Galerkin contributions are all-gathered — the
    # analog of the reference's MPI-decomposed setup,
    # amge.templates.hpp:596-643).  No effect with a single process.
    distributed_setup: bool = False
    # Storage dtype for the stencil coefficient planes INSIDE the hierarchy
    # (the V-cycle preconditioner).  "bfloat16" halves the dominant HBM
    # stream of the fine-level apply; the outer CG residual always uses a
    # full-precision operator, so solve accuracy is unaffected.  None = same
    # as dtype.
    coeff_dtype: str | None = None

    @staticmethod
    def from_dict(d: dict, info_style: bool = False) -> "Config":
        """Build a Config from a nested dict using mfmg's .info key names.

        info_style=True marks a reference-style .info input: the smoother's
        eigenvalue estimator then defaults to the reference's own deal.II
        8-step CG estimate for golden parity.  Native (JSON/Python) configs
        keep the production 'lanczos' default — the 8-step estimate
        underestimates lmax at 1e5+ dofs (PCG 10 -> 17 measured at 274k).
        """
        cfg = Config()
        cfg.max_levels = int(d.get("max levels", d.get("max_levels", cfg.max_levels)))
        cfg.cycle_type = str(d.get("cycle type", d.get("cycle_type", cfg.cycle_type))).strip().lower()
        cfg.is_preconditioner = _to_bool(d.get("is preconditioner", d.get("is_preconditioner", cfg.is_preconditioner)))
        if "fast_ap" in d:
            cfg.fast_ap = _to_bool(d["fast_ap"])
        cfg.operator = d.get("operator", cfg.operator)
        cfg.dtype = d.get("dtype", cfg.dtype)
        e = d.get("eigensolver", {})
        cfg.eigensolver = EigensolverConfig(
            type=_canonical_eigensolver(e.get("type", cfg.eigensolver.type)),
            n_eigenvectors=int(e.get("number of eigenvectors", e.get("n_eigenvectors", 2))),
            n_eigenvectors_deep=(int(e["n_eigenvectors_deep"])
                                 if "n_eigenvectors_deep" in e else None),
            tolerance=float(e.get("tolerance", 1e-14)),
            max_iterations=int(e.get("max_iterations", 200)),
            percent_overshoot=int(e.get("percent_overshoot", 5)),
            is_deflated=_to_bool(e.get("is_deflated", False)),
            num_cycles=int(e.get("num_cycles", 1)),
            num_eigenpairs_per_cycle=int(e.get("num_eigenpairs_per_cycle", 1)),
            use_initial_guess=_to_bool(e.get("use_initial_guess", False)),
            full_ortho=_to_bool(e.get("full_ortho", True)),
            backend=e.get("backend", "auto"),
            constrained_mode=e.get("constrained_mode", "auto"),
        )
        s = d.get("smoother", {})
        cfg.smoother = SmootherConfig(
            type=s.get("type", cfg.smoother.type).strip().lower(),
            coloring=s.get("coloring", "multicolor").strip().lower(),
            ordering=s.get("ordering", "natural").strip().lower(),
            n_smoothing_steps=int(s.get("n_smoothing_steps", 1)),
            degree=int(s.get("degree", 1)),
            smoothing_range=float(s.get("smoothing_range", 0.0)),
            max_eigenvalue=(float(s["max_eigenvalue"]) if "max_eigenvalue" in s else None),
            # .info configs are reference-style inputs: default to the
            # reference's own (deal.II 8-step) estimator for parity there;
            # native configs keep the production default.
            eig_estimate=s.get("eig_estimate",
                               "dealii_cg" if info_style
                               else cfg.smoother.eig_estimate).strip().lower(),
            eig_cg_n_iterations=int(s.get("eig_cg_n_iterations", 8)),
            jacobi_omega=float(s.get("jacobi_omega", 1.0)),
        )
        c = d.get("coarse", {})
        cfg.coarse = CoarseConfig(
            type=c.get("type", cfg.coarse.type).strip().lower(),
            tolerance=float(c.get("tolerance", 1e-12)),
            max_iterations=int(c.get("max_iterations", 200)),
            max_levels=int(c.get("max levels", c.get("max_levels", 2))),
            n_agglomerates=int(c.get("n_agglomerates", 8)),
            params=dict(c.get("params", {})),
        )
        a = d.get("agglomeration", {})
        cfg.agglomeration = AgglomerationConfig(
            partitioner=a.get("partitioner", "block"),
            nx=int(a.get("nx", 2)),
            ny=int(a.get("ny", 2)),
            nz=int(a.get("nz", 2)),
            n_agglomerates=int(a.get("n_agglomerates", 4)),
        )
        _warn_unknown(d, {
            "": {"max levels", "max_levels", "cycle type", "cycle_type",
                 "is preconditioner", "is_preconditioner", "fast_ap",
                 "operator", "dtype", "eigensolver", "smoother", "coarse",
                 "agglomeration", "solver", "laplace", "material_property",
                 "use_raw_ml", "hidden"},   # driver-consumed reference keys
            "eigensolver": {"type", "number of eigenvectors", "n_eigenvectors",
                            "n_eigenvectors_deep",
                            "tolerance", "max_iterations", "percent_overshoot",
                            "is_deflated", "num_cycles",
                            "num_eigenpairs_per_cycle", "use_initial_guess",
                            "full_ortho", "backend", "constrained_mode"},
            "smoother": {"type", "coloring", "ordering",
                         "n_smoothing_steps", "degree",
                         "smoothing_range", "max_eigenvalue",
                         "eig_estimate", "eig_cg_n_iterations",
                         "jacobi_omega"},
            "coarse": {"type", "tolerance", "max_iterations", "max levels",
                       "max_levels", "n_agglomerates", "params", "config_file"},
            "agglomeration": {"partitioner", "nx", "ny", "nz",
                              "n_agglomerates", "eigensolver"},
        })
        return cfg


def _warn_unknown(d: dict, known: dict) -> None:
    """Warn about config keys that would otherwise be silently dropped
    (the reference aborts on malformed ptrees; we keep going but say so)."""
    import warnings
    for section, keys in known.items():
        sub = d if section == "" else d.get(section, {})
        if not isinstance(sub, dict):
            continue
        for k in sub:
            if k not in keys:
                where = f"{section}.{k}" if section else k
                warnings.warn(f"config key {where!r} is not consumed by "
                              f"mfmg_tpu", stacklevel=3)


def _to_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("true", "1", "yes", "on")


def _canonical_eigensolver(name: str) -> str:
    """Normalize reference eigensolver names ("anasazi" -> batched LOBPCG,
    "arpack" -> shift-invert ARPACK, "lapack" -> batched eigh,
    "lanczos" -> batched Lanczos)."""
    return name.strip().lower()
