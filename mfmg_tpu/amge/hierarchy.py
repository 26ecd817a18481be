"""The multigrid hierarchy: setup + jitted V-cycle.

Analog of mfmg::Hierarchy (reference include/mfmg/common/hierarchy.hpp:155-309).
Design difference: where the reference is an object graph with virtual
dispatch (Operator/Smoother/Solver/HierarchyHelpers), this hierarchy is
*data* — a pytree of per-level arrays built once by pure setup code — and the
V-cycle is a pure jitted function over that pytree.  One XLA compilation holds
the entire cycle: every smoothing step, residual, restriction SpMV and the
dense coarse solve fuse into a single device program with no host round-trips.

Setup pipeline per level (mirrors hierarchy.hpp:178-234):
    operator -> smoother -> agglomerates -> batched eigensolve -> R (PoU
    weighted) -> AP (SpGEMM or fast_ap) -> A_coarse = R·AP -> recurse/coarse solver.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from mfmg_tpu.amge.agglomeration import build_agglomerates
from mfmg_tpu.amge.local_problems import build_agglomerate_batch
from mfmg_tpu.amge.restriction import build_restriction, check_restriction
from mfmg_tpu.config import Config
from mfmg_tpu.eigen.batched_eigh import batched_smallest_eigenpairs
from mfmg_tpu.ops.sparse import ELLMatrix, ell_from_scipy
from mfmg_tpu.solve.cg import cg_solve
from mfmg_tpu.solve.coarse import build_coarse_solver
from mfmg_tpu.solve.operator import apply_op
from mfmg_tpu.solve.smoothers import build_smoother


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class LevelData:
    """Per-level state (analog of mfmg::Level, common/level.hpp:22-77)."""

    op: object                           # ELLMatrix | MatrixFreeOperator | StencilOperator
    smoother: object = None              # None on the coarsest level
    R: Optional[ELLMatrix] = None        # restriction INTO this level's coarse
    RT: Optional[ELLMatrix] = None       # prolongation (R transpose)
    transfer: object = None              # StructuredTransfer (gather-free path)
    coarse: object = None                # coarse solver on the coarsest level


def _restrict(lvl, res):
    return lvl.transfer.restrict(res) if lvl.transfer is not None else lvl.R @ res


def _prolong(lvl, xc):
    return lvl.transfer.prolong(xc) if lvl.transfer is not None else lvl.RT @ xc


def _vcycle(levels, b, x, level, n_smoothing_steps, is_preconditioner,
            cycle_type="v"):
    """Recursive multigrid cycle (hierarchy.hpp:246-309), unrolled at trace
    time.  cycle_type selects the recursion shape: "v" (one coarse visit, the
    reference's only cycle), "w" (two), or "f" (an F-cycle recursion followed
    by a V-cycle sweep) — the deeper cycles pair with the recursive AMGe
    levels (amge/multilevel.py) the reference delegates to ML/AMGX.
    """
    if level == 0 and is_preconditioner:
        x = jnp.zeros_like(b)
    return _cycle(levels, b, x, level, n_smoothing_steps, cycle_type)


def _cycle(levels, b, x, level, n_smoothing_steps, cycle_type):
    """One cycle from `level` down.  Every stage runs under a named scope
    ("L<level>/<stage>"), which the compiled program keeps as op metadata,
    so a profiler trace attributes device time to levels and stages."""
    lvl = levels[level]
    tag = f"L{level}"
    if level == len(levels) - 1:
        with jax.named_scope(f"{tag}/coarse_solve"):
            return lvl.coarse.apply(b)
    with jax.named_scope(f"{tag}/presmooth"):
        for _ in range(n_smoothing_steps):
            x = lvl.smoother.apply(lvl.op, b, x)
    with jax.named_scope(f"{tag}/residual"):
        # negative residual: res = A x - b (hierarchy.hpp:282-286)
        res = apply_op(lvl.op, x) - b
    with jax.named_scope(f"{tag}/restrict"):
        b_coarse = _restrict(lvl, res)
    x_coarse = jnp.zeros_like(b_coarse)
    # ("f" recurses F then revisits with V; "w" recurses W twice)
    sub_cycles = {"v": ("v",), "w": ("w", "w"), "f": ("f", "v")}[cycle_type]
    for sub in sub_cycles:
        x_coarse = _cycle(levels, b_coarse, x_coarse, level + 1,
                          n_smoothing_steps, sub)
    with jax.named_scope(f"{tag}/prolong"):
        x = x - _prolong(lvl, x_coarse)
    with jax.named_scope(f"{tag}/postsmooth"):
        for _ in range(n_smoothing_steps):
            x = lvl.smoother.apply(lvl.op, b, x)
    return x


@partial(jax.jit, static_argnames=("n_smoothing_steps", "is_preconditioner",
                                   "cycle_type"))
def vcycle(levels, b, x, n_smoothing_steps=1, is_preconditioner=True,
           cycle_type="v"):
    return _vcycle(tuple(levels), b, x, 0, n_smoothing_steps,
                   is_preconditioner, cycle_type)


class Hierarchy:
    """Public entry point — ctor runs the full setup (hierarchy.hpp:159-236)."""

    def __init__(self, problem, config: Config | None = None):
        from mfmg_tpu.utils.cache import enable_compilation_cache
        enable_compilation_cache()
        self.config = config or Config()
        self.problem = problem
        self.dtype = jnp.dtype(self.config.dtype)
        self.levels: list[LevelData] = []
        # which level-0 eigensolve ran: "device" (eigen/device_eig.py) or
        # "host" (LAPACK and the other host eigensolvers)
        self.eig_path = "host"
        self._setup()

    # ------------------------------------------------------------- setup --
    def _setup(self):
        import os, sys, time as _time
        verbose = bool(os.environ.get("MFMG_TPU_VERBOSE"))
        _t = [_time.perf_counter()]

        def _mark(name):
            if verbose:
                now = _time.perf_counter()
                print(f"[mfmg_tpu setup] {name}: {now - _t[0]:.1f}s",
                      file=sys.stderr, flush=True)
                _t[0] = now

        cfg = self.config
        problem = self.problem

        # fast_ap "auto" (None): on for matrix-free-style operators — those
        # paths then never assemble the global fine matrix (the reference's
        # matrix-free hierarchy semantics, dealii_matrix_free_hierarchy_
        # helpers.cc:55-303); the assembled ELL path keeps host SpGEMM.
        mf_types = ("matrix_free", "sumfac", "stencil")
        fast_ap = cfg.fast_ap
        if fast_ap is None:
            fast_ap = cfg.operator in mf_types
        if getattr(problem.mesh, "hanging", None) is not None:
            # Hanging meshes: the coarse operator must be Galerkin in the
            # CONDENSED matrix (master rows carry w A w corrections the raw
            # per-agglomerate blocks don't see), so the Galerkin product goes
            # through the assembled condensed A; the fine-level APPLY stays
            # matrix-free (C^T A C cell-wise, ops/local_apply.py).
            fast_ap = False
        self._fast_ap = fast_ap
        matrix_free_setup = fast_ap and cfg.operator in mf_types

        if cfg.operator == "matrix_free":
            fine_op = problem.matrix_free_operator(dtype=self.dtype)
        elif cfg.operator == "sumfac":
            fine_op = problem.matrix_free_operator(dtype=self.dtype, mode="sumfac")
        elif cfg.operator == "stencil":
            from mfmg_tpu.ops.stencil import stencil_from_cell_matrices
            # coeff_dtype (e.g. bfloat16) reduces the dominant HBM stream of
            # the V-cycle; the hierarchy is a preconditioner, so reduced
            # coefficient precision perturbs only the preconditioner — the
            # outer CG residual uses the exact-dtype operator (solve_cg).
            coeff_dt = jnp.dtype(cfg.coeff_dtype) if cfg.coeff_dtype else self.dtype
            # device=False: setup reads the planes host-side (nnz, deal.II CG
            # estimate); _op_to_device pushes them exactly once at level
            # finalization, so they never make a device-to-host round trip.
            raw = None
            if self._distributed():
                # extraction is additive over cells: scatter own cell range,
                # sum-reduce planes across processes before elimination
                from mfmg_tpu.ops.stencil import stencil_layout
                from mfmg_tpu.parallel import dist_setup
                offsets, oid_ab, _, n_nodes = stencil_layout(problem.mesh)
                raw = dist_setup.distributed_stencil_planes(
                    problem.mesh, problem.A_loc, len(offsets), n_nodes, oid_ab)
            fine_op = stencil_from_cell_matrices(
                problem.mesh, problem.A_loc, problem.constrained,
                problem.diag_raw, dtype=coeff_dt, device=False,
                raw_planes=raw)
        else:
            fine_op = problem.ell_operator(dtype=self.dtype)

        num_levels = cfg.max_levels
        # Coarse-solver families (dealii_solver.cc:25-87, cuda_solver.cu:42-515):
        #   "amg"/"amgx" — the nested hierarchy the reference delegates to
        #     AMGX is built by CONTINUING the same AMGe recursion for
        #     coarse.max_levels - 1 extra levels, packaged into an
        #     AMGCoarseSolver below (one nested V-cycle per coarse solve).
        #     With coarse "max levels" == 1 this degenerates to the direct
        #     solver exactly.
        #   "ml" — Trilinos ML's actual algorithm: SMOOTHED AGGREGATION on
        #     the coarse matrix (solve/coarse._build_algebraic_amg), seeded
        #     with the restricted fine-grid constant as the near-null
        #     candidate (ML's default nullspace).  With coarse.params
        #     "max levels" == 1 it degenerates to the direct solver exactly
        #     (the reference's ML consistency oracle,
        #     test_hierarchy.cc:228-260).
        ctype = cfg.coarse.type.strip().lower()
        amg_coarse = ctype in ("amg", "amgx")
        ml_coarse = ctype == "ml"
        nested_extra = 0
        ml_knobs = None
        if amg_coarse:
            from mfmg_tpu.solve.coarse import parse_ml_params
            ml_knobs = parse_ml_params(cfg.coarse)
            nested_extra = max(0, ml_knobs["max_levels"] - 1)
        total_levels = num_levels + nested_extra

        # level-0 slot is None on the matrix-free setup path: global A is
        # neither assembled nor needed (fast AP + cell-matrix eig estimate).
        A_fine = None if matrix_free_setup else problem.A
        self._A_per_level = [A_fine]
        nnz_fine = (problem.A.nnz if A_fine is not None else
                    self._op_nnz(fine_op))
        self._A_shapes = [(problem.n_dofs, problem.n_dofs)]
        self._A_nnzs = [nnz_fine]

        op = fine_op
        _mark("fine operator")
        for level in range(total_levels):
            if level == total_levels - 1:
                A_c = self._A_per_level[level]
                if A_c is None:
                    A_c = problem.A          # max_levels==1 degenerate case
                from mfmg_tpu.config import CoarseConfig
                bottom_cfg = (CoarseConfig(type="direct") if amg_coarse
                              else cfg.coarse)
                near_null = None
                if ml_coarse:
                    # ML's default nullspace is the constant vector; in the
                    # AMGe coarse space that is the restricted fine constant
                    R_comp = getattr(self, "_R_composed", None)
                    near_null = (np.asarray(R_comp @ np.ones(R_comp.shape[1]))
                                 if R_comp is not None and level > 0
                                 else np.ones(A_c.shape[0]))
                coarse = build_coarse_solver(A_c, bottom_cfg, dtype=self.dtype,
                                             near_null=near_null)
                _mark(f"coarse solver (n={A_c.shape[0]})")
                op_dev = self._op_to_device(op)
                _mark("final level op upload")
                self.levels.append(LevelData(op=op_dev, coarse=coarse))
                break
            smoother_cfg = cfg.smoother
            if (amg_coarse and level >= num_levels - 1
                    and ml_knobs["smoother_type"]):
                t = ml_knobs["smoother_type"].strip().lower()
                t = ("chebyshev" if "cheby" in t else
                     "symmetric gauss-seidel" if "gauss" in t else "jacobi")
                smoother_cfg = dataclasses.replace(cfg.smoother, type=t)
            smoother = build_smoother(op, smoother_cfg, dtype=self.dtype,
                                      A_scipy=self._A_per_level[level],
                                      problem=problem if level == 0 else None)
            _mark(f"smoother L{level}")

            R = self._build_restrictor(level)
            _mark(f"restrictor L{level}")
            if fast_ap and level == 0:
                # matrix-free Galerkin product (the role of fast AP,
                # hierarchy.hpp:214-227): R·A·Rᵀ assembled from batched
                # per-agglomerate dense blocks Rb_a A_agg_a Rb_aᵀ — neither
                # the global fine matrix nor AP is ever materialized, and the
                # same blocks are reused by the level-1 recursive restrictor.
                from mfmg_tpu.amge.multilevel import (
                    _dof_row_structure, agg_galerkin_blocks,
                    galerkin_product_from_blocks)
                batch, evals, evecs = self._level0_eigendata
                dof_rows, dof_vals = _dof_row_structure(R)
                if self._distributed():
                    # additive over agglomerates: slab blocks + COO reduce
                    from mfmg_tpu.parallel import dist_setup
                    batch_slab, _ = self._dist_slab
                    A_coarse, blocks_slab = dist_setup.distributed_galerkin(
                        batch_slab, dof_rows, dof_vals, R.shape[0],
                        return_blocks=True)
                    self._level0_blocks = None
                    self._level0_blocks_slab = blocks_slab
                else:
                    blocks = None
                    import os as _os
                    if (getattr(self, "_device_A", None) is not None
                            and _os.environ.get("MFMG_DEVICE_GALERKIN")):
                        # K = Rb A Rb^T on the device against the still-
                        # resident device batch (eigen/device_eig.py).
                        # OPT-IN: it moves the Rb upload (884 MB at 2.1M
                        # dofs) and the K readback in exchange for the host
                        # BLAS product, and that trade has not been measured
                        # on the GPU yet.
                        from mfmg_tpu.eigen import device_eig
                        blocks = device_eig.device_galerkin_blocks(
                            batch, self._device_A, dof_rows, dof_vals,
                            R.shape[0])
                    self._device_A = None                # free the 2 GB
                    if blocks is None:
                        if batch.A_agg is None:          # device path failed
                            batch = build_agglomerate_batch(
                                problem.mesh, problem.A_loc,
                                self._level0_agg_ids,
                                batch_dtype=(np.float64 if self.dtype ==
                                             jnp.float64 else np.float32))
                        blocks = agg_galerkin_blocks(batch, dof_rows, dof_vals,
                                                     R.shape[0],
                                                     eliminate=False)
                    A_coarse = galerkin_product_from_blocks(blocks, R.shape[0])
                    self._level0_blocks = blocks
            else:
                A_coarse = (R @ self._A_per_level[level] @ R.T).tocsr()
            self._A_per_level.append(A_coarse)
            self._A_shapes.append(A_coarse.shape)
            self._A_nnzs.append(A_coarse.nnz)
            _mark(f"galerkin product L{level}")

            transfer = None
            if level == 0 and cfg.operator == "stencil":
                from mfmg_tpu.ops.structured_transfer import structured_transfer_from_batch
                batch, _, evecs = self._level0_eigendata
                transfer = structured_transfer_from_batch(
                    self.problem.mesh, batch, evecs, self.problem.diag_raw,
                    dtype=self.dtype)
                self._agg_grid = transfer.agg_shape if transfer is not None else None
            elif level > 0 and cfg.operator == "stencil" and getattr(self, "_agg_grid", None):
                from mfmg_tpu.ops.structured_transfer import general_window_transfer_from_csr
                n_ev0 = cfg.eigensolver.n_eigenvectors
                n_evd = cfg.eigensolver.n_eigenvectors_deep or n_ev0
                in_comp = n_ev0 if level == 1 else n_evd
                out_grid = tuple(reversed(self._super_grid_xyz))
                stride = tuple(reversed(cfg.agglomeration.block_dims(self.problem.mesh.dim)))
                transfer = general_window_transfer_from_csr(
                    R, self._agg_grid, in_comp, out_grid, n_evd, stride,
                    dtype=self.dtype)
                if transfer is not None:
                    self._agg_grid = out_grid
            if transfer is not None:
                self.levels.append(LevelData(op=self._op_to_device(op),
                                             smoother=smoother,
                                             transfer=transfer))
            else:
                self.levels.append(LevelData(
                    op=self._op_to_device(op),
                    smoother=smoother,
                    R=ell_from_scipy(R, dtype=self.dtype),
                    RT=ell_from_scipy(R.T.tocsr(), dtype=self.dtype),
                ))
            op = None
            if transfer is not None:
                # coarse AMGe level on a structured agglomerate grid IS a
                # block stencil — keep the gather-free path (ops/block_stencil)
                from mfmg_tpu.ops.block_stencil import block_stencil_from_csr
                coarse_grid = getattr(transfer, "out_grid", None) or transfer.agg_shape
                n_comp = (cfg.eigensolver.n_eigenvectors if level == 0 else
                          cfg.eigensolver.n_eigenvectors_deep
                          or cfg.eigensolver.n_eigenvectors)
                op = block_stencil_from_csr(
                    A_coarse, coarse_grid, n_comp, dtype=self.dtype)
            if op is None:
                op = ell_from_scipy(A_coarse, dtype=self.dtype)

        if amg_coarse and nested_extra > 0:
            # package the continued levels as the coarse solver
            from mfmg_tpu.solve.coarse import AMGCoarseSolver
            nested = tuple(self.levels[num_levels - 1:])
            solver = AMGCoarseSolver(
                levels=nested, n_smoothing_steps=ml_knobs["n_smoothing_steps"])
            self.levels = self.levels[: num_levels - 1] + [
                LevelData(op=nested[0].op, coarse=solver)]

    def _build_restrictor(self, level: int) -> sp.csr_matrix:
        """Analog of HierarchyHelpers::build_restrictor for one level.

        Level 0 agglomerates mesh cells; deeper levels (multilevel mode)
        agglomerate the coarse operator algebraically.
        """
        cfg = self.config
        problem = self.problem
        if level == 0:
            agg_ids = build_agglomerates(problem.mesh, cfg.agglomeration)
            batch_dtype = np.float64 if self.dtype == jnp.float64 else np.float32
            if self._distributed():
                # each process assembles + eigensolves only its slab; the
                # eigenvectors are all-gathered (amge.templates.hpp:596-643).
                # The slab is ALIGNED TO SUPER-AGGLOMERATE boundaries so the
                # level-1 recursive restrictor can reuse the same slab (every
                # member agglomerate of an owned super is local).
                from mfmg_tpu.amge.multilevel import group_agglomerates
                from mfmg_tpu.parallel import dist_setup
                n_agg = int(agg_ids.max()) + 1
                bdims = cfg.agglomeration.block_dims(problem.mesh.dim)
                super_of_agg, _ = group_agglomerates(problem.mesh, agg_ids,
                                                     bdims)
                agg_sel, s_range, _, agg_sels = dist_setup.super_partition(
                    super_of_agg)
                batch_slab = build_agglomerate_batch(
                    problem.mesh, problem.A_loc, agg_ids,
                    batch_dtype=batch_dtype, agg_range=agg_sel)
                batch = build_agglomerate_batch(
                    problem.mesh, problem.A_loc, agg_ids,
                    batch_dtype=batch_dtype, assemble_operator=False)
                check_restriction(batch, problem.diag_raw, problem.n_dofs)
                evals_s, evecs_s = self._eigensolve(batch_slab)
                evals = dist_setup.gather_to_rows(
                    np.asarray(evals_s, dtype=np.float64), agg_sels, n_agg)
                evecs = dist_setup.gather_to_rows(
                    np.asarray(evecs_s, dtype=np.float64), agg_sels, n_agg)
                self._dist_slab = (batch_slab, agg_sels)
                self._dist_super = s_range
            else:
                evals = evecs = None
                batch = None
                self._device_A = None
                if self._use_device_eig():
                    # the device does the eigensolve + keeps the assembled
                    # batch there for the Galerkin blocks (eigen/device_eig.py)
                    # — the 2 GB dense host batch is never assembled
                    from mfmg_tpu.eigen import device_eig
                    light = build_agglomerate_batch(
                        problem.mesh, problem.A_loc, agg_ids,
                        batch_dtype=batch_dtype, assemble_operator=False)
                    if device_eig.supports(problem.mesh, light, agg_ids):
                        out = device_eig.device_smallest_eigenpairs(
                            problem, agg_ids, light,
                            cfg.eigensolver.n_eigenvectors, keep_A=True)
                        if out is not None:
                            evals, evecs, self._device_A = out
                            batch = light
                            self.eig_path = "device"
                if evals is None:
                    batch = build_agglomerate_batch(
                        problem.mesh, problem.A_loc, agg_ids,
                        batch_dtype=batch_dtype)
                    evals, evecs = self._eigensolve(batch)
                check_restriction(batch, problem.diag_raw, problem.n_dofs)
            self._level0_agg_ids = agg_ids
            self._level0_eigendata = (batch, evals, evecs)
            R = build_restriction(batch, evecs, problem.diag_raw, problem.n_dofs)
            self._cell_agg = agg_ids
            self._R_composed = R
            return R
        # Deeper levels: recursive spectral AMGe on super-agglomerates (the
        # reference defaults to 2 levels and delegates deeper hierarchies to
        # ML/AMGX; here the same construction recurses, amge/multilevel.py).
        from mfmg_tpu.amge.multilevel import build_recursive_restriction
        n_evd = (cfg.eigensolver.n_eigenvectors_deep
                 or cfg.eigensolver.n_eigenvectors)
        if (level == 1 and self._distributed()
                and getattr(self, "_dist_super", None) is not None
                and getattr(self, "_dist_slab", None) is not None
                and self._dist_slab[0].A_agg is not None):
            # level-1 setup distributed over super slabs: each process solves
            # only its supers' pencils and the restriction rows are
            # allgathered (amge.templates.hpp:596-643, every level)
            from mfmg_tpu.parallel import dist_setup
            R_l, cell_super, super_grid = (
                dist_setup.distributed_recursive_restriction(
                    problem.mesh, problem.A_loc, self._cell_agg,
                    self._R_composed, self._A_per_level[level],
                    problem.constrained, n_evd,
                    cfg.agglomeration.block_dims(problem.mesh.dim),
                    self._dist_slab[0],
                    getattr(self, "_level0_blocks_slab", None),
                    self._dist_super))
        else:
            prev_batch = self._level0_eigendata[0] if level == 1 else None
            prev_blocks = (getattr(self, "_level0_blocks", None)
                           if level == 1 else None)
            if (prev_batch is not None and prev_batch.A_agg is None
                    and prev_blocks is None):
                prev_batch = None        # light batch without blocks: the
                                         # per-super path needs the dense ops
            R_l, cell_super, super_grid = build_recursive_restriction(
                problem.mesh, problem.A_loc, self._cell_agg, self._R_composed,
                self._A_per_level[level], problem.constrained,
                n_evd, cfg.agglomeration.block_dims(problem.mesh.dim),
                prev_batch=prev_batch, prev_blocks=prev_blocks)
        self._cell_agg = cell_super
        self._R_composed = (R_l @ self._R_composed).tocsr()
        self._super_grid_xyz = super_grid
        return R_l

    def _use_device_eig(self) -> bool:
        """Device batched eigensolve for the level-0 'lapack' path: on by
        default wherever eigen/device_eig.supports() accepts the device and
        mesh (backend='auto'); disable with backend='host' or
        MFMG_NO_DEVICE_EIG=1."""
        import os
        if os.environ.get("MFMG_NO_DEVICE_EIG"):
            return False
        e = self.config.eigensolver
        return (e.type == "lapack" and e.backend in ("auto", "device")
                and self._constrained_mode() == "pin")

    def _distributed(self) -> bool:
        """Distributed setup is active: configured AND >1 jax process."""
        if not self.config.distributed_setup:
            return False
        import jax
        return jax.process_count() > 1

    def _constrained_mode(self) -> str:
        mode = self.config.eigensolver.constrained_mode
        if mode != "auto":
            return mode
        # Follow the reference's per-path convention: matrix-free evaluators
        # see constrained dofs as identity rows (deal.II MatrixFree); the
        # assembled host path shifts + pins them to 200.
        return ("identity" if self.config.operator in ("matrix_free", "sumfac")
                else "pin")

    def _eigensolve(self, batch):
        cfg = self.config.eigensolver
        mode = self._constrained_mode()
        # Batched dense eigh of the assembled batch runs on host LAPACK
        # unless the config asks for backend="device" (jnp.linalg.eigh);
        # the structured level-0 batch has its own device pipeline
        # (_use_device_eig).  float32 host eigh when the hierarchy doesn't
        # need f64 (2x faster, eigenvector error ~1e-6).
        use_device = cfg.backend == "device"
        if cfg.type == "lapack":
            return batched_smallest_eigenpairs(
                batch, cfg.n_eigenvectors, constrained_mode=mode,
                use_device=use_device,
                host_dtype=(np.float64 if self.dtype == jnp.float64 else np.float32))
        if cfg.type == "arpack":
            from mfmg_tpu.eigen.arpack import batched_arpack_smallest
            return batched_arpack_smallest(batch, cfg, constrained_mode=mode)
        if cfg.type == "lanczos":
            from mfmg_tpu.eigen.lanczos import batched_lanczos_smallest
            return batched_lanczos_smallest(batch, cfg, constrained_mode=mode)
        if cfg.type == "anasazi":
            from mfmg_tpu.eigen.lobpcg import batched_lobpcg_smallest
            guess = None
            if cfg.use_initial_guess and getattr(self, "_level0_eigendata", None):
                guess = self._level0_eigendata[2]      # previous setup's vectors
            return batched_lobpcg_smallest(batch, cfg, constrained_mode=mode,
                                           initial_guess=guess)
        raise ValueError(f"unknown eigensolver type {cfg.type!r}")

    # ------------------------------------------------------------- apply --
    def apply(self, b, x=None):
        """One V-cycle: solves/preconditions A x = b (hierarchy.hpp:246)."""
        b = jnp.asarray(b, dtype=self.dtype)
        if x is None:
            x = jnp.zeros_like(b)
        return vcycle(self.levels, b, x,
                      n_smoothing_steps=self.config.smoother.n_smoothing_steps,
                      is_preconditioner=self.config.is_preconditioner,
                      cycle_type=self.config.cycle_type)

    def vmult(self, b):
        """Preconditioner application x = M^{-1} b (hierarchy.hpp:238-244)."""
        b = jnp.asarray(b, dtype=self.dtype)
        return vcycle(self.levels, b, jnp.zeros_like(b),
                      n_smoothing_steps=self.config.smoother.n_smoothing_steps,
                      is_preconditioner=True,
                      cycle_type=self.config.cycle_type)

    def solve_cg(self, b, tol=1e-12, maxiter=1000):
        """Hierarchy-preconditioned CG (analog of laplace.hpp:206-219)."""
        levels = self.levels
        nss = self.config.smoother.n_smoothing_steps

        def precond(r):
            return vcycle(levels, r, jnp.zeros_like(r),
                          n_smoothing_steps=nss, is_preconditioner=True,
                          cycle_type=self.config.cycle_type)

        b = jnp.asarray(b, dtype=self.dtype)
        return cg_solve(self._exact_fine_op(), b, preconditioner=precond,
                        tol=tol, maxiter=maxiter)

    def _exact_fine_op(self):
        """Fine operator at the full hierarchy dtype for the OUTER Krylov
        residual.  When coeff_dtype reduces the hierarchy's coefficient
        storage (bf16 preconditioner), this rebuilds (and caches) the exact
        operator so CG solves the unperturbed system."""
        cfg = self.config
        if (cfg.operator != "stencil" or not cfg.coeff_dtype
                or jnp.dtype(cfg.coeff_dtype) == self.dtype):
            return self.levels[0].op
        if getattr(self, "_exact_op_cache", None) is None:
            from mfmg_tpu.ops.stencil import stencil_from_cell_matrices
            p = self.problem
            self._exact_op_cache = self._op_to_device(
                stencil_from_cell_matrices(p.mesh, p.A_loc, p.constrained,
                                           p.diag_raw, dtype=self.dtype,
                                           device=False))
        return self._exact_op_cache

    # ------------------------------------------------------- persistence --
    def save(self, path: str) -> None:
        """Persist the built hierarchy (skip setup on reload); utils/serialize."""
        from mfmg_tpu.utils.serialize import save_hierarchy
        save_hierarchy(self, path)

    @staticmethod
    def load(path: str, problem=None) -> "Hierarchy":
        from mfmg_tpu.utils.serialize import load_hierarchy
        return load_hierarchy(path, problem)

    @staticmethod
    def _op_to_device(op):
        """Finalize a level operator: push host-built stencil planes to the
        device (exactly one h2d transfer; see stencil_from_cell_matrices)."""
        from mfmg_tpu.ops.stencil import StencilOperator, stencil_to_device
        if isinstance(op, StencilOperator):
            return stencil_to_device(op)
        return op

    # ------------------------------------------------------------ metrics --
    @staticmethod
    def _op_nnz(op) -> int:
        """Operator nonzero count without assembling anything global.

        Device arrays are reduced on-device (scalar result), so the planes
        are never copied back to the host.
        """
        from mfmg_tpu.ops.stencil import StencilOperator
        if isinstance(op, StencilOperator):
            if isinstance(op.coeffs, np.ndarray):
                return int(np.count_nonzero(op.coeffs))
            return int(jnp.count_nonzero(op.coeffs))
        from mfmg_tpu.ops.sparse import ELLMatrix
        if isinstance(op, ELLMatrix):
            if isinstance(op.vals, np.ndarray):
                return int(np.count_nonzero(op.vals))
            return int(jnp.count_nonzero(op.vals))
        # matrix-free: stencil-equivalent estimate (interior row length)
        cells = np.asarray(op.cells)
        n_loc = cells.shape[1]
        dim = int(round(np.log2(n_loc))) if n_loc in (2, 4, 8) else 2
        return int(op.shape[0]) * 3 ** dim

    def grid_complexity(self) -> float:
        """Σ level sizes / fine size (operator.hpp:49-51 contract)."""
        sizes = [s[0] for s in self._A_shapes]
        return sum(sizes) / sizes[0]

    def operator_complexity(self) -> float:
        nnzs = list(self._A_nnzs)
        return sum(nnzs) / nnzs[0]


def measure_vcycle_rate(hierarchy: Hierarchy, n_cycles: int = 20, seed: int = 0):
    """Asymptotic V-cycle convergence-rate harness.

    Mirrors the reference's gold-standard measurement
    (tests/test_hierarchy.cc:95-124): random initial error (uniform [0,1),
    zero at Dirichlet dofs), zero RHS, n_cycles standalone V-cycles; rate =
    res[n]/res[n-1].  The error is renormalized every cycle (valid since the
    iteration is linear), so the measurement is exact power iteration on the
    error-propagation operator and does not underflow in float32.
    """
    problem = hierarchy.problem
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, size=problem.n_dofs)
    x[problem.constrained] = 0.0
    x = jnp.asarray(x, dtype=hierarchy.dtype)
    b = jnp.zeros_like(x)
    op = hierarchy.levels[0].op
    nss = hierarchy.config.smoother.n_smoothing_steps

    res_prev = None
    rate = None
    for i in range(n_cycles):
        x = vcycle(hierarchy.levels, b, x, n_smoothing_steps=nss,
                   is_preconditioner=False,
                   cycle_type=hierarchy.config.cycle_type)
        res = float(jnp.linalg.norm(apply_op(op, x)))
        if res_prev is not None and res_prev > 0:
            rate = res / res_prev
        # renormalize to keep the iteration in range
        nrm = float(jnp.linalg.norm(x))
        if nrm > 0:
            x = x / nrm
            res_prev = res / nrm
        else:
            res_prev = res
    return rate
