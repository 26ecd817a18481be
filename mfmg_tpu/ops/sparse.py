"""Sparse linear algebra on the device.

The reference's sparse stack is Epetra CSR on host and cuSPARSE CSR on device
(reference cuda/sparse_matrix_device.cuh, csrmv at
sparse_matrix_device.templates.cuh:34-70).  Here the SpMV layout is ELL
(padded rows): FE matrices on quasi-uniform meshes have near-constant row
length, so padding waste is small and the kernel becomes a dense gather +
multiply + row-sum with a fixed shape and no data-dependent control flow.

Setup-time sparse-sparse products (Galerkin triple product R·A·Rᵀ, SpGEMM)
run on host via scipy — mirroring the reference, whose parallel device path
also falls back to host SpGEMM (sparse_matrix_device.templates.cuh:417-433).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ELLMatrix:
    """ELL (padded-row) sparse matrix living on device.

    vals : (n_rows, max_nnz_row) float
    cols : (n_rows, max_nnz_row) int32, padded entries point at column 0 with
           value 0 (any valid index works since the value is 0).
    n_cols is static metadata.
    """

    vals: jax.Array
    cols: jax.Array
    n_cols: int = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self):
        return (self.vals.shape[0], self.n_cols)

    def __matmul__(self, x):
        return ell_spmv(self, x)


@jax.jit
def ell_spmv(A: ELLMatrix, x: jax.Array) -> jax.Array:
    """y = A @ x.  One gather of x at (n_rows, L) indices + row reduction."""
    return jnp.sum(A.vals * x[A.cols], axis=1)


def ell_from_scipy(A: sp.spmatrix, dtype=jnp.float64, pad_to: int | None = None) -> ELLMatrix:
    """Convert a scipy sparse matrix to device ELL format."""
    A = sp.csr_matrix(A)
    A.sum_duplicates()
    n, m = A.shape
    row_nnz = np.diff(A.indptr)
    L = int(row_nnz.max()) if n > 0 else 0
    if pad_to is not None:
        L = max(L, pad_to)
    from mfmg_tpu import native
    packed = native.ell_pack(A.indptr, A.indices, A.data, n, L) if A.nnz > 0 else None
    if packed is not None:
        vals, cols = packed
    else:
        vals = np.zeros((n, L), dtype=np.float64)
        cols = np.zeros((n, L), dtype=np.int32)
        # vectorized fill: position of each nnz within its row
        if A.nnz > 0:
            rows = np.repeat(np.arange(n), row_nnz)
            pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], row_nnz)
            vals[rows, pos] = A.data
            cols[rows, pos] = A.indices
    return ELLMatrix(vals=jnp.asarray(vals, dtype=dtype),
                     cols=jnp.asarray(cols), n_cols=m)


def eliminate_dirichlet(A_raw: sp.spmatrix, constrained: np.ndarray) -> sp.csr_matrix:
    """Apply Dirichlet elimination: zero constrained rows/cols, keep the raw
    diagonal entry for constrained dofs.

    This is the analog of deal.II AffineConstraints::distribute_local_to_global
    condensation (reference tests/laplace.hpp:197-199).  Keeping the *raw*
    diagonal (instead of deal.II's rescaled value) preserves the partition of
    unity Σ_agg local_diag/global_diag = 1 at every dof, which the reference
    asserts in check_restriction_matrix (common/utils.hpp:120-146).
    """
    A = sp.coo_matrix(A_raw)
    keep = (~constrained[A.row] & ~constrained[A.col]) | (A.row == A.col)
    return sp.csr_matrix((A.data[keep], (A.row[keep], A.col[keep])), shape=A.shape)


def assemble_csr(cells: np.ndarray, A_loc: np.ndarray, n_dofs: int) -> sp.csr_matrix:
    """Assemble batched cell matrices into a global CSR (host, setup time).

    cells: (n_cells, n_loc) global dof ids; A_loc: (n_cells, n_loc, n_loc).
    """
    n_cells, n_loc = cells.shape
    rows = np.broadcast_to(cells[:, :, None], (n_cells, n_loc, n_loc)).reshape(-1)
    cols = np.broadcast_to(cells[:, None, :], (n_cells, n_loc, n_loc)).reshape(-1)
    # Direct COO->CSR (counting sort by row + in-row dedup) is ~12x faster
    # than coo_matrix(...).sum_duplicates() (global lexsort of all entries).
    A = sp.csr_matrix((A_loc.reshape(-1), (rows, cols)), shape=(n_dofs, n_dofs))
    A.sum_duplicates()
    return A
