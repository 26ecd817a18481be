"""Distributed (multi-process) hierarchy setup: levels 0 AND 1.

The reference's entire setup runs under MPI domain decomposition: each rank
builds only its own agglomerates, and the restriction matrix is assembled by
allgathering the per-rank row counts and rows
(/root/reference/include/mfmg/common/amge.templates.hpp:596-643) — at every
level of the hierarchy.

Analog over ``jax.distributed`` processes:

  * SUPER-agglomerates (the level-1 groups) are split into contiguous
    slabs, and each process's level-0 slab is its supers' member
    agglomerates (super_partition) — one partition drives the level-0
    eigensolve, the level-0 Galerkin blocks AND the level-1 recursive
    restrictor (distributed_recursive_restriction), so the two dominant
    setup stages both scale 1/P;
  * each process assembles only its slab's dense batch and eigensolves it —
    the dominant setup cost scales 1/P;
  * levels >= 2 (a few hundred dofs) remain replicated: their setup cost is
    microscopic and the allgathered level-1 operator is global anyway;
  * the slab eigenvectors are exchanged with ONE padded device all-gather
    (multihost_utils.process_allgather — the analog of the reference's
    MPI_Allgather), after which every process assembles the full R locally
    (cheap: one scatter of nnz values);
  * the matrix-free Galerkin product A_c = R A R^T is additive over
    agglomerates, so each process computes only its slab's Galerkin blocks
    and the coarse matrix is summed by all-gathering the slab COO triplets;
  * the fine stencil extraction is additive over CELLS: each process
    scatters its own cell range and the coefficient planes are
    sum-all-gathered before Dirichlet elimination.

Enabled by ``Config.distributed_setup`` (auto-activates only when
``jax.process_count() > 1``); the apply-side SPMD sharding
(parallel/spmd.py) is unchanged.
"""

from __future__ import annotations

import numpy as np


def slab_range(n: int, pid: int | None = None, nproc: int | None = None):
    """Contiguous [lo, hi) slab of n items for this process (+ all bounds)."""
    import jax

    nproc = nproc if nproc is not None else jax.process_count()
    pid = pid if pid is not None else jax.process_index()
    bounds = np.linspace(0, n, nproc + 1).astype(int)
    return int(bounds[pid]), int(bounds[pid + 1]), bounds


def _gather_padded(arr: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """All-gather per-process leading-axis slabs of possibly unequal size:
    pad to the max slab, one device all-gather, reassemble in slab order."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    counts = np.diff(bounds)
    m = int(counts.max())
    pad = np.zeros((m,) + arr.shape[1:], dtype=arr.dtype)
    pad[: arr.shape[0]] = arr
    gathered = np.asarray(multihost_utils.process_allgather(jnp.asarray(pad)))
    # (nproc, m, ...) -> trim each slab to its true count
    return np.concatenate([gathered[p, : counts[p]]
                           for p in range(len(counts))], axis=0)


def _allreduce_sum(arr: np.ndarray) -> np.ndarray:
    """Sum a same-shape host array across processes (one device gather)."""
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    g = np.asarray(multihost_utils.process_allgather(jnp.asarray(arr)))
    return g.sum(axis=0)


def distributed_eigensolve(batch_full_light, batch_slab, bounds, eigensolve):
    """Eigensolve only this process's slab; all-gather (evals, evecs).

    batch_full_light carries the full dof_map/diag (cheap, closed-form);
    batch_slab carries this slab's dense operators.
    """
    evals_s, evecs_s = eigensolve(batch_slab)
    evals = _gather_padded(np.asarray(evals_s, dtype=np.float64), bounds)
    evecs = _gather_padded(np.asarray(evecs_s, dtype=np.float64), bounds)
    return evals, evecs


def super_partition(super_of_agg: np.ndarray, nproc: int | None = None,
                    pid: int | None = None):
    """Partition SUPER-agglomerates into contiguous slabs and derive each
    process's level-0 agglomerate index set (its supers' member aggs).

    Aligning the level-0 slab to super boundaries lets the SAME slab batch
    drive the level-0 eigensolve, the level-0 Galerkin blocks AND the
    level-1 recursive restrictor (every member agglomerate of an owned super
    is local) — the analog of the reference's every-level domain
    decomposition (amge.templates.hpp:596-643).

    Returns (agg_sel (this process), (s_lo, s_hi), sel_counts (per process),
    agg_sels (list per process — deterministic, no communication needed)).
    """
    import jax

    nproc = nproc if nproc is not None else jax.process_count()
    pid = pid if pid is not None else jax.process_index()
    n_super = int(super_of_agg.max()) + 1
    if nproc > n_super:
        # an empty super slab would flow an n_agg==0 batch into the slab
        # eigensolve / Galerkin-block paths, which are not written for it
        raise ValueError(
            f"distributed setup needs process_count <= n_super "
            f"({nproc} processes > {n_super} super-agglomerates); use fewer "
            f"processes or a finer mesh, or disable Config.distributed_setup")
    bounds = np.linspace(0, n_super, nproc + 1).astype(int)
    agg_sels = [np.nonzero((super_of_agg >= bounds[p])
                           & (super_of_agg < bounds[p + 1]))[0]
                for p in range(nproc)]
    counts = np.array([len(s) for s in agg_sels])
    return (agg_sels[pid], (int(bounds[pid]), int(bounds[pid + 1])),
            counts, agg_sels)


def gather_to_rows(arr_slab: np.ndarray, agg_sels, n_total: int) -> np.ndarray:
    """All-gather per-process row slabs (selected by arbitrary index sets)
    into the full (n_total, ...) array."""
    counts = np.array([len(s) for s in agg_sels])
    m = int(counts.max())
    import jax.numpy as jnp
    from jax.experimental import multihost_utils

    pad = np.zeros((m,) + arr_slab.shape[1:], dtype=arr_slab.dtype)
    pad[: arr_slab.shape[0]] = arr_slab
    g = np.asarray(multihost_utils.process_allgather(jnp.asarray(pad)))
    out = np.zeros((n_total,) + arr_slab.shape[1:], dtype=arr_slab.dtype)
    for p, sel in enumerate(agg_sels):
        out[sel] = g[p, : counts[p]]
    return out


def allgather_coo(A_part, shape):
    """Sum per-process sparse contributions: pad COO triplets to the max
    nnz, one device all-gather each, rebuild + sum_duplicates (the analog of
    Trilinos compress after per-rank assembly)."""
    import jax.numpy as jnp
    import scipy.sparse as sp
    from jax.experimental import multihost_utils

    A_part = A_part.tocoo()
    nnz = np.array([A_part.nnz], dtype=np.int64)
    all_nnz = np.asarray(multihost_utils.process_allgather(jnp.asarray(nnz)))
    m = int(all_nnz.max())
    rows = np.zeros(m, dtype=np.int64)
    cols = np.zeros(m, dtype=np.int64)
    vals = np.zeros(m, dtype=np.float64)
    rows[: A_part.nnz] = A_part.row
    cols[: A_part.nnz] = A_part.col
    vals[: A_part.nnz] = A_part.data
    g_rows = np.asarray(multihost_utils.process_allgather(jnp.asarray(rows)))
    g_cols = np.asarray(multihost_utils.process_allgather(jnp.asarray(cols)))
    g_vals = np.asarray(multihost_utils.process_allgather(jnp.asarray(vals)))
    counts = all_nnz[:, 0]
    r = np.concatenate([g_rows[p, : counts[p]] for p in range(len(counts))])
    c = np.concatenate([g_cols[p, : counts[p]] for p in range(len(counts))])
    v = np.concatenate([g_vals[p, : counts[p]] for p in range(len(counts))])
    A = sp.csr_matrix((v, (r, c)), shape=shape)
    A.sum_duplicates()
    return A


def distributed_recursive_restriction(mesh, A_loc, cell_agg_prev, R_prev,
                                      A_coarse_prev, boundary_dofs, n_ev,
                                      block_dims, batch_slab, blocks_slab,
                                      super_range):
    """Level-1 restrictor with each process building only its super slab
    (the deep-level analog of distributed_eigensolve): local rows are
    offset to their global position, allgathered as COO, and empty rows
    (supers whose pencil lost rank) dropped globally."""
    from mfmg_tpu.amge.multilevel import build_recursive_restriction

    R_local, cell_super, super_grid = build_recursive_restriction(
        mesh, A_loc, cell_agg_prev, R_prev, A_coarse_prev, boundary_dofs,
        n_ev, block_dims, prev_batch=batch_slab, prev_blocks=blocks_slab,
        super_range=super_range)
    n_super = int(cell_super.max()) + 1
    s_lo, _ = super_range
    part = R_local.tocoo()
    import scipy.sparse as sp
    shifted = sp.coo_matrix(
        (part.data, (part.row + s_lo * n_ev, part.col)),
        shape=(n_super * n_ev, R_local.shape[1]))
    R_full = allgather_coo(shifted, shifted.shape)
    nonzero = np.diff(R_full.indptr) > 0
    return R_full[nonzero], cell_super, super_grid


def distributed_galerkin(batch_slab, dof_rows, dof_vals, n_rows,
                         return_blocks: bool = False):
    """Slab contribution to A_c = R A R^T, summed across processes.

    Assembly is additive over agglomerates, so each process scatters only
    its own slab's Galerkin blocks; the COO triplets are all-gathered and
    summed (the small-coarse-matrix analog of Trilinos compress).

    return_blocks=True also returns the slab's AggBlocks for reuse by the
    distributed level-1 restrictor."""
    from mfmg_tpu.amge.multilevel import (agg_galerkin_blocks,
                                          galerkin_product_from_blocks)

    blocks = agg_galerkin_blocks(batch_slab, dof_rows, dof_vals, n_rows,
                                 eliminate=False)
    A_part = galerkin_product_from_blocks(blocks, n_rows)
    A = allgather_coo(A_part, (n_rows, n_rows))
    A.eliminate_zeros()
    return (A, blocks) if return_blocks else A


def distributed_stencil_planes(mesh, A_loc, n_offsets: int, n_nodes: int,
                               oid_ab: np.ndarray) -> np.ndarray:
    """Raw (un-eliminated) stencil planes from this process's cell range,
    sum-reduced across processes (extraction is additive over cells)."""
    lo, hi, _ = slab_range(mesh.n_cells)
    rows = mesh.cells[lo:hi].astype(np.int64)
    from mfmg_tpu import native
    coeffs = native.stencil_scatter(rows, oid_ab, A_loc[lo:hi],
                                    n_offsets, n_nodes)
    if coeffs is None:
        flat = oid_ab[None, :, :] * n_nodes + rows[:, :, None]
        coeffs = np.bincount(flat.reshape(-1),
                             weights=A_loc[lo:hi].reshape(-1),
                             minlength=n_offsets * n_nodes)
        coeffs = coeffs.reshape(n_offsets, n_nodes)
    return _allreduce_sum(coeffs)
