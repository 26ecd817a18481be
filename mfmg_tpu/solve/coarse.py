"""Coarsest-level solvers.

Analog of the reference's DealIISolver (Amesos-KLU direct / ML,
source/dealii/dealii_solver.cc:25-87) and CudaSolver (cusolver
cholesky/lu_dense, source/cuda/cuda_solver.cu:42-515).

The coarse problem (n_agglomerates x n_eigenvectors dofs, tiny compared to
the fine grid) is solved densely: its (pseudo)inverse is formed once at
setup and lives on the device, so the coarse solve is one matvec instead of
a host round-trip.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DirectCoarseSolver:
    """Dense direct solve applied as one matmul: x = A_c^+ b.

    The pseudoinverse (eigh with relative cutoff) is used instead of a
    Cholesky/LU factorization because AMGe coarse matrices can be *exactly*
    consistent-singular: overlapping agglomerate eigenvectors may produce
    linearly dependent restriction rows (observed on symmetric meshes; the
    reference's KLU/cusolver LU factors these by luck of pivoting, relying on
    prolongation to annihilate the null-space junk).  A_c^+ b is the exact
    solution of the consistent system, and one dense matvec is the coarse
    apply.  It runs at Precision.DEFAULT (TF32 on a GPU), inside the
    preconditioner only.
    """

    inv: jax.Array                # dense pseudoinverse of A_c

    def apply(self, b):
        return self.inv @ b


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CGCoarseSolver:
    """Iterative coarse solve (unpreconditioned CG on the coarse ELL matrix)."""
    op: object
    tol: float = dataclasses.field(metadata=dict(static=True), default=1e-12)
    maxiter: int = dataclasses.field(metadata=dict(static=True), default=200)

    def apply(self, b):
        from mfmg_tpu.solve.cg import cg_solve
        x, _ = cg_solve(self.op, b, tol=self.tol, maxiter=self.maxiter)
        return x


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class AMGCoarseSolver:
    """Recursive algebraic multigrid as the coarsest-level solver — the
    analog of the reference's Trilinos-ML coarse solver
    (dealii_solver.cc:25-87, applied as a single AMG vmult) and of the AMGX
    path (cuda_solver.cu:42-515).

    levels is the same LevelData pytree the outer hierarchy uses, so the
    nested V-cycles fuse into the same jitted program.
    """

    levels: tuple
    n_smoothing_steps: int = dataclasses.field(metadata=dict(static=True), default=1)
    n_cycles: int = dataclasses.field(metadata=dict(static=True), default=1)

    def apply(self, b):
        from mfmg_tpu.amge.hierarchy import _cycle
        x = jnp.zeros_like(b)
        for _ in range(self.n_cycles):
            x = _cycle(self.levels, b, x, 0, self.n_smoothing_steps, "v")
        return x


# ML parameter-list keys accepted in coarse.params.* — the analog of the
# reference's ptree2plist overlay (source/common/utils.cc:20-80) mapped onto
# the knobs of the AMG coarse solvers.
_ML_PARAM_KEYS = {
    "max levels": ("max_levels", int),
    "smoother: sweeps": ("n_smoothing_steps", int),
    "smoother: type": ("smoother_type", str),
    "aggregation: nodes per aggregate": ("nodes_per_aggregate", int),
    "number of eigenvectors": ("n_eigenvectors", int),
    # ML's bottom solver; ours is always the dense direct solve (the
    # Amesos-KLU analog), so the value is accepted and need not dispatch
    "coarse: type": ("coarse_type", str),
}


def parse_ml_params(coarse_cfg):
    """Consume the coarse.params.* ML parameter list; warn on unknown keys
    (the reference passes the list to ML verbatim; we map it onto the nested
    hierarchy's knobs instead of dropping it silently)."""
    import warnings
    # Defaults mirror ML_Epetra::SetDefaults("SA") where a knob maps:
    # "smoother: sweeps" 2, symmetric Gauss-Seidel smoothing (see
    # _build_algebraic_amg).
    knobs = dict(max_levels=coarse_cfg.max_levels,
                 n_smoothing_steps=2, smoother_type=None,
                 nodes_per_aggregate=27, n_eigenvectors=2)
    for key, val in dict(getattr(coarse_cfg, "params", {}) or {}).items():
        if key in _ML_PARAM_KEYS:
            attr, conv = _ML_PARAM_KEYS[key]
            knobs[attr] = conv(val)
        else:
            warnings.warn(f"coarse.params key {key!r} not consumed by the "
                          f"AMG coarse solver", stacklevel=3)
    return knobs


def _build_algebraic_amg(A_c: sp.spmatrix, coarse_cfg, dtype, smoothed: bool,
                         near_null=None):
    """Nested algebraic spectral-aggregation hierarchy on the coarse matrix.

    Rows are partitioned into disjoint aggregates (graph partitioning of the
    matrix connectivity); each aggregate's tentative basis is the restriction
    of the near-null candidates (ML's nullspace vectors — for an AMGe coarse
    matrix that is R·1, which the outer hierarchy passes in) enriched with
    the lowest eigenvectors of the lumped-Neumann local block; `smoothed`
    applies one Jacobi-smoothing step to the tentative prolongator (smoothed
    aggregation — what Trilinos ML does).  Candidates propagate down the
    nested levels by restriction.  All products are host scipy (the matrices
    here are the outer hierarchy's coarsest level: tiny).
    """
    from mfmg_tpu.amge.graph_partition import partition_graph
    from mfmg_tpu.amge.hierarchy import LevelData
    from mfmg_tpu.ops.sparse import ell_from_scipy
    from mfmg_tpu.solve.smoothers import build_smoother
    from mfmg_tpu.config import SmootherConfig

    knobs = parse_ml_params(coarse_cfg)
    # ML smoother names -> this package's smoothers.  ML's SA default (and the
    # reference's hidden raw-ML config) is symmetric Gauss-Seidel — realized
    # here as the multicolor sweep; "Chebyshev"/"MLS" map to Chebyshev.
    sm_raw = (knobs["smoother_type"] or "symmetric gauss-seidel").strip().lower()
    if "gauss" in sm_raw or sm_raw in ("sgs", "sor", "ssor"):
        sm_type = "symmetric gauss-seidel"
    elif "jacobi" in sm_raw:
        sm_type = "jacobi"
    else:
        sm_type = "chebyshev"          # Chebyshev / MLS / unknown
    n_ev = knobs["n_eigenvectors"]

    levels = []
    A = sp.csr_matrix(A_c).astype(np.float64)
    if near_null is not None:
        near_null = np.asarray(near_null, dtype=np.float64).reshape(A.shape[0], -1)
    for level in range(max(1, knobs["max_levels"]) - 1):
        n = A.shape[0]
        n_agg = max(1, n // max(2 * n_ev, knobs["nodes_per_aggregate"]))
        if n <= 128 or n_agg < 2:
            break
        parts = partition_graph(A.indptr, A.indices, n_agg)
        n_agg = int(parts.max()) + 1
        # padded principal-submatrix batch
        order = np.argsort(parts, kind="stable")
        counts = np.bincount(parts, minlength=n_agg)
        offs = np.concatenate([[0], np.cumsum(counts)])
        m_max = int(counts.max())
        Ad = A.toarray()
        rowsum = Ad.sum(axis=1)
        batchA = np.zeros((n_agg, m_max, m_max))
        rows_pad = np.zeros((n_agg, m_max), dtype=np.int64)
        for g in range(n_agg):
            idx = order[offs[g]: offs[g + 1]]
            m = len(idx)
            rows_pad[g, :m] = idx
            blk = Ad[np.ix_(idx, idx)]
            # lumped-Neumann compensation: fold each row's off-aggregate
            # couplings into the diagonal so globally-near-null vectors stay
            # near-null on the local block (plain Dirichlet truncation would
            # bias the local modes; standard aggregation-AMG filtering)
            d_out = rowsum[idx] - blk.sum(axis=1)
            blk = blk + np.diag(d_out)
            batchA[g, :m, :m] = blk
            batchA[g, m:, m:] = np.eye(m_max - m) * 1e30   # decouple padding
        w, V = np.linalg.eigh(batchA)
        kk = min(n_ev, m_max)
        # tentative basis per aggregate: near-null restrictions first (they
        # are what the coarse space MUST represent), block eigenvectors fill
        # the remaining columns; per-aggregate QR keeps it well-conditioned
        R_rows, R_cols, R_vals = [], [], []
        next_row = 0
        for g in range(n_agg):
            idx = order[offs[g]: offs[g + 1]]
            m = len(idx)
            cand = []
            if near_null is not None:
                cand.append(near_null[idx])
            cand.append(V[g, :m, :kk])
            C = np.concatenate(cand, axis=1)
            Q, Rq = np.linalg.qr(C)
            diagR = np.abs(np.diag(Rq))
            keep = diagR > 1e-10 * max(diagR.max(), 1e-300)
            cols = Q[:, keep][:, :min(kk, m)]
            for j in range(cols.shape[1]):
                R_rows.append(np.full(m, next_row))
                R_cols.append(idx)
                R_vals.append(cols[:, j])
                next_row += 1
        R = sp.csr_matrix((np.concatenate(R_vals),
                           (np.concatenate(R_rows), np.concatenate(R_cols))),
                          shape=(next_row, n))
        if near_null is not None:
            near_null = np.asarray(R @ near_null)
        if smoothed:
            # one Jacobi step on the prolongator (smoothed aggregation):
            # P = (I - 4/(3 lmax) D^{-1} A) R^T, applied as a row op on R
            d = np.asarray(A.diagonal())
            Dinv = sp.diags(1.0 / np.where(d != 0, d, 1.0))
            from mfmg_tpu.solve.smoothers import estimate_extreme_eigenvalues_host
            _, lmax = estimate_extreme_eigenvalues_host(A, n_iter=20)
            R = (R - (R @ A @ Dinv) * (4.0 / (3.0 * max(lmax, 1e-30)))).tocsr()
        nonzero = np.diff(R.indptr) > 0
        R = R[nonzero]
        op = ell_from_scipy(A, dtype=dtype)
        # Trilinos ML's Gauss-Seidel is lexicographic; use the faithful
        # dense-triangular parity smoother at the small sizes SA levels have
        # (multicolor beyond that — rates differ slightly, as any reordering)
        coloring = ("lexicographic"
                    if "gauss" in sm_type and A.shape[0] <= 4096
                    else "multicolor")
        smoother = build_smoother(op, SmootherConfig(
            type=sm_type, degree=2, coloring=coloring), dtype=dtype, A_scipy=A)
        levels.append(LevelData(op=op, smoother=smoother,
                                R=ell_from_scipy(R, dtype=dtype),
                                RT=ell_from_scipy(R.T.tocsr(), dtype=dtype)))
        A = (R @ A @ R.T).tocsr()
    direct = build_coarse_solver(
        A, type(coarse_cfg)(type="direct"), dtype=dtype)
    levels.append(LevelData(op=ell_from_scipy(A, dtype=dtype), coarse=direct))
    return AMGCoarseSolver(levels=tuple(levels),
                           n_smoothing_steps=knobs["n_smoothing_steps"])


def build_coarse_solver(A_c: sp.spmatrix, coarse_cfg, dtype=jnp.float64,
                        near_null=None):
    """Factory (analog of HierarchyHelpers::build_coarse_solver).

    near_null: optional (n, k) near-null candidates for the AMG/ML coarse
    solver (the analog of ML's nullspace vectors; for an AMGe coarse matrix
    the outer hierarchy passes the restricted fine-grid constant R·1)."""
    ctype = coarse_cfg.type.strip().lower()
    if ctype in ("amg", "ml", "amgx"):
        # "ml" = smoothed aggregation (the Trilinos-ML default); "amg"/"amgx"
        # = unsmoothed spectral aggregation (recursive AMGe / AMGX analog).
        return _build_algebraic_amg(A_c, coarse_cfg, dtype,
                                    smoothed=(ctype == "ml"),
                                    near_null=near_null)
    if ctype in ("direct", "cholesky", "lu_dense", "amesos-klu"):
        Ad = np.asarray(A_c.todense())
        # Symmetrize against assembly roundoff.
        Ad = 0.5 * (Ad + Ad.T)
        n = Ad.shape[0]
        if n >= 2048 and dtype != jnp.float64:
            # Large coarse problems: jittered float32 Cholesky inverse on the
            # host (7.4 s at n=8192 against minutes for host eigh).  The
            # tiny relative jitter keeps the factorization of consistent-
            # singular coarse matrices stable.
            import scipy.linalg
            A32 = Ad.astype(np.float32)
            jitter = np.float32(1e-6 * (np.trace(A32) / n))
            try:
                c = scipy.linalg.cho_factor(A32 + jitter * np.eye(n, dtype=np.float32))
                inv = scipy.linalg.cho_solve(c, np.eye(n, dtype=np.float32))
                if np.all(np.isfinite(inv)):
                    return DirectCoarseSolver(inv=jnp.asarray(inv, dtype=dtype))
            except scipy.linalg.LinAlgError:
                pass                      # fall through to the eigh pinv
        # Eigendecompose, invert above a relative cutoff (rank-deficient
        # coarse systems are consistent; see DirectCoarseSolver docstring).
        w, V = np.linalg.eigh(Ad)
        cut = w > 1e-10 * max(w[-1], 0.0)
        inv = (V[:, cut] / w[cut]) @ V[:, cut].T
        return DirectCoarseSolver(inv=jnp.asarray(inv, dtype=dtype))
    if ctype == "cg":
        from mfmg_tpu.ops.sparse import ell_from_scipy
        return CGCoarseSolver(op=ell_from_scipy(A_c, dtype=dtype),
                              tol=coarse_cfg.tolerance, maxiter=coarse_cfg.max_iterations)
    raise ValueError(f"unknown coarse solver type {coarse_cfg.type!r}")
