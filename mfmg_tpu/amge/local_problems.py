"""Per-agglomerate local operators as one padded dense batch.

The reference builds a sub-triangulation + sparse matrix per agglomerate and
eigensolves them one at a time under WorkStream threading
(dealii/amge_host.templates.hpp:586-615) or sequentially on GPU
(cuda/amge_device.templates.cuh:208-432, with a TODO to batch).  This
design *is* that TODO: all agglomerate operators are materialized
as a single (n_agg, m_max, m_max) padded dense batch so the eigensolve runs as
one batched `eigh`/Lanczos — ragged sizes handled by masking, threads replaced
by the batch dimension.

Boundary conditions per agglomerate mirror the reference
(tests/test_hierarchy_helpers.hpp:253-259): Dirichlet is applied only where
the agglomerate touches the global Dirichlet boundary; interior agglomerate
boundaries are natural (Neumann).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mfmg_tpu.fem.mesh import Mesh


@dataclasses.dataclass
class AgglomerateBatch:
    """Padded batch of local problems.

    dof_map : (n_agg, m_max) int64 global dof ids, -1 padding
    valid   : (n_agg, m_max) bool
    A_agg   : (n_agg, m_max, m_max) Dirichlet-eliminated local matrices
              (raw diagonal kept at constrained dofs); padded diagonal 1
    diag    : (n_agg, m_max) local raw diagonals (the PoU numerators)
    constrained : (n_agg, m_max) bool
    sizes   : (n_agg,) int
    """

    dof_map: np.ndarray
    valid: np.ndarray
    A_agg: np.ndarray
    diag: np.ndarray
    constrained: np.ndarray
    sizes: np.ndarray

    @property
    def n_agg(self) -> int:
        return self.dof_map.shape[0]

    @property
    def m_max(self) -> int:
        return self.dof_map.shape[1]


def build_agglomerate_batch(mesh: Mesh, A_loc: np.ndarray, agg_ids: np.ndarray,
                            batch_dtype=np.float64,
                            agg_range=None,
                            assemble_operator: bool = True) -> AgglomerateBatch:
    """Assemble local dense operators for every agglomerate.

    A_loc: (n_cells, n_loc, n_loc) cell stiffness matrices (raw / Neumann).

    Structured meshes with uniform block agglomerates take a fully vectorized
    path (every agglomerate shares one local index structure — the batching
    the reference leaves as a TODO at amge_device.templates.cuh:391-392);
    anything else falls back to the generic per-agglomerate loop.

    batch_dtype: dtype of the dense A_agg batch.  float32 halves the batch's
    memory traffic through the eigensolve and Galerkin blocks; the PoU
    diagonals are always accumulated in float64 (the partition-of-unity
    identity is checked to 1e-12).

    agg_range: optional (lo, hi) tuple OR integer index array — build ONLY
    those agglomerates (the distributed-setup slab path,
    parallel/dist_setup.py: each process assembles and eigensolves its own
    slab; super-aligned partitions pass index arrays).

    assemble_operator=False skips the dense A_agg assembly (A_agg = None):
    the "light" batch carrying only dof_map/diag/valid/constrained — what
    restriction assembly, the PoU check and the structured transfers need —
    used by the distributed setup for the agglomerates other processes own.
    """
    fast = _try_build_structured(mesh, A_loc, agg_ids, batch_dtype,
                                 agg_range=agg_range,
                                 assemble_operator=assemble_operator)
    if fast is not None:
        return fast
    batch = _build_generic(mesh, A_loc, agg_ids)
    if agg_range is not None:
        sel = (np.asarray(agg_range) if not isinstance(agg_range, tuple)
               else np.arange(agg_range[0], agg_range[1]))
        batch = AgglomerateBatch(
            dof_map=batch.dof_map[sel], valid=batch.valid[sel],
            A_agg=batch.A_agg[sel], diag=batch.diag[sel],
            constrained=batch.constrained[sel], sizes=batch.sizes[sel])
    if np.dtype(batch_dtype) != np.float64 and batch.A_agg is not None:
        batch.A_agg = batch.A_agg.astype(batch_dtype)
    return batch


def _try_build_structured(mesh: Mesh, A_loc: np.ndarray, agg_ids: np.ndarray,
                          batch_dtype=np.float64, agg_range=None,
                          assemble_operator: bool = True):
    """Vectorized batch build for uniform blocks on a structured grid."""
    if not mesh.is_structured or mesh.dof_renumbered:
        return None              # renumbered dofs: closed-form ids invalid
    n_agg = int(agg_ids.max()) + 1
    counts = np.bincount(agg_ids, minlength=n_agg)
    if counts.min() != counts.max():
        return None                       # ragged blocks -> generic path
    nc = np.asarray(mesh.structured_shape)
    dim, k = mesh.dim, mesh.degree
    mi = mesh.cell_multi_index()          # (n_cells, dim)
    # infer block dims: extent of agglomerate 0 in each direction
    sel = agg_ids == agg_ids[0]
    bdims = (mi[sel].max(axis=0) - mi[sel].min(axis=0) + 1)
    if np.prod(bdims) != counts[0] or np.any(nc % bdims):
        return None
    # verify the id layout is the closed-form block partition
    agg_mi = mi // bdims
    n_agg_dim = nc // bdims
    stride = np.cumprod(np.concatenate([[1], n_agg_dim[:-1]]))
    if not np.array_equal(agg_ids, agg_mi @ stride):
        return None

    # Local structure shared by all agglomerates: cells inside a block and
    # their dof->local-dof map, computed once.
    m_dims = bdims * k + 1                # local nodes per dim
    m = int(np.prod(m_dims))
    n_loc = mesh.n_loc
    from mfmg_tpu.fem.reference import reference_element
    ref = reference_element(dim, k)
    lm = ref.local_multi_index            # (n_loc, dim)
    # block-local cell multi-indices, x fastest (same convention as agg_ids)
    bc = np.stack(np.meshgrid(*[np.arange(b) for b in bdims], indexing="ij"),
                  axis=-1).reshape(-1, dim, order="F")   # x fastest
    lstride = np.cumprod(np.concatenate([[1], m_dims[:-1]]))
    # local dof index of cell c, local node a
    local_cells = ((bc[:, None, :] * k + lm[None, :, :]) @ lstride).astype(np.int64)

    # cell ids per agglomerate in the same block-local order
    gstride = np.cumprod(np.concatenate([[1], nc[:-1]]))
    agg_origin_mi = np.stack(np.meshgrid(*[np.arange(a) for a in n_agg_dim], indexing="ij"),
                             axis=-1).reshape(-1, dim, order="F") * bdims
    if agg_range is not None:
        if isinstance(agg_range, tuple):
            lo, hi = agg_range
            agg_origin_mi = agg_origin_mi[lo:hi]
            n_agg = hi - lo
        else:
            sel = np.asarray(agg_range)
            agg_origin_mi = agg_origin_mi[sel]
            n_agg = len(sel)
    cells_per_agg = (agg_origin_mi[:, None, :] + bc[None, :, :]) @ gstride  # (n_agg, n_bc)

    # global dof map per agglomerate (lexicographic local order)
    node_dims = nc * k + 1
    nstride = np.cumprod(np.concatenate([[1], node_dims[:-1]]))
    local_node_mi = np.stack(np.meshgrid(*[np.arange(md) for md in m_dims], indexing="ij"),
                             axis=-1).reshape(-1, dim, order="F")   # x fastest
    dof_map = ((agg_origin_mi * k)[:, None, :] + local_node_mi[None, :, :]) @ nstride

    # batched dense assembly: native kernel, numpy scatter-add fallback
    from mfmg_tpu import native
    if not assemble_operator:
        diag = np.zeros((n_agg, m))
        d_loc = np.einsum("cii->ci", A_loc)[cells_per_agg]
        np.add.at(diag, (np.broadcast_to(np.arange(n_agg)[:, None, None], d_loc.shape),
                         np.broadcast_to(local_cells[None], d_loc.shape)), d_loc)
        return AgglomerateBatch(
            dof_map=dof_map, valid=np.ones((n_agg, m), dtype=bool),
            A_agg=None, diag=diag,
            constrained=mesh.constrained_mask[dof_map],
            sizes=np.full(n_agg, m, dtype=np.int64))
    A_agg = native.assemble_agglomerate_batch_uniform(
        cells_per_agg, local_cells, A_loc, n_agg, m, dtype=batch_dtype)
    if A_agg is None:
        A_agg = np.zeros((n_agg, m, m), dtype=batch_dtype)
        gi = np.broadcast_to(np.arange(n_agg)[:, None, None, None],
                             (n_agg, len(bc), n_loc, n_loc))
        rows = np.broadcast_to(local_cells[None, :, :, None], gi.shape)
        cols = np.broadcast_to(local_cells[None, :, None, :], gi.shape)
        np.add.at(A_agg, (gi.reshape(-1), rows.reshape(-1), cols.reshape(-1)),
                  A_loc[cells_per_agg].reshape(-1).astype(batch_dtype))

    valid = np.ones((n_agg, m), dtype=bool)
    if np.dtype(batch_dtype) == np.float64:
        diag = np.einsum("gii->gi", A_agg).copy()
    else:
        # PoU diagonals in float64 straight from the cell matrices
        diag = np.zeros((n_agg, m))
        d_loc = np.einsum("cii->ci", A_loc)[cells_per_agg]   # (n_agg, n_bc, n_loc)
        np.add.at(diag, (np.broadcast_to(np.arange(n_agg)[:, None, None], d_loc.shape),
                         np.broadcast_to(local_cells[None], d_loc.shape)), d_loc)
    constrained = mesh.constrained_mask[dof_map]

    keep = ~constrained
    A_agg *= keep[:, :, None] * keep[:, None, :]
    gi2, ii2 = np.nonzero(constrained)
    A_agg[gi2, ii2, ii2] = diag[gi2, ii2].astype(batch_dtype)

    return AgglomerateBatch(dof_map=dof_map, valid=valid, A_agg=A_agg,
                            diag=diag, constrained=constrained,
                            sizes=np.full(n_agg, m, dtype=np.int64))


def _build_generic(mesh: Mesh, A_loc: np.ndarray, agg_ids: np.ndarray) -> AgglomerateBatch:
    n_agg = int(agg_ids.max()) + 1
    n_loc = mesh.n_loc

    # Group cells by agglomerate.
    order = np.argsort(agg_ids, kind="stable")
    cells_sorted = order
    counts = np.bincount(agg_ids, minlength=n_agg)
    offsets = np.concatenate([[0], np.cumsum(counts)])

    dof_maps = []
    sizes = np.empty(n_agg, dtype=np.int64)
    local_cells = []       # per agg: (n_agg_cells, n_loc) local dof indices
    for g in range(n_agg):
        cs = cells_sorted[offsets[g]: offsets[g + 1]]
        dofs = mesh.cells[cs]                              # (k, n_loc)
        uniq, inv = np.unique(dofs, return_inverse=True)
        dof_maps.append(uniq)
        sizes[g] = len(uniq)
        local_cells.append(inv.reshape(dofs.shape))

    m_max = int(sizes.max())
    dof_map = -np.ones((n_agg, m_max), dtype=np.int64)
    valid = np.zeros((n_agg, m_max), dtype=bool)
    A_agg = np.zeros((n_agg, m_max, m_max))
    for g in range(n_agg):
        m = sizes[g]
        dof_map[g, :m] = dof_maps[g]
        valid[g, :m] = True
        cs = cells_sorted[offsets[g]: offsets[g + 1]]
        li = local_cells[g]                                # (k, n_loc)
        rows = np.broadcast_to(li[:, :, None], (len(cs), n_loc, n_loc))
        cols = np.broadcast_to(li[:, None, :], (len(cs), n_loc, n_loc))
        np.add.at(A_agg[g], (rows.reshape(-1), cols.reshape(-1)), A_loc[cs].reshape(-1))

    diag = np.einsum("gii->gi", A_agg).copy()              # raw local diagonals
    constrained = np.zeros((n_agg, m_max), dtype=bool)
    constrained[valid] = mesh.constrained_mask[dof_map[valid]]

    # Dirichlet elimination inside each agglomerate: zero constrained rows and
    # columns, restore the raw diagonal entry (see ops.sparse.eliminate_dirichlet
    # for why raw is kept).
    keep = ~constrained
    A_agg *= keep[:, :, None] * keep[:, None, :]
    gi, ii = np.nonzero(constrained)
    A_agg[gi, ii, ii] = diag[gi, ii]
    # Unit diagonal on padding so padded eigenpairs are decoupled and harmless.
    gi, ii = np.nonzero(~valid)
    A_agg[gi, ii, ii] = 1.0

    return AgglomerateBatch(dof_map=dof_map, valid=valid, A_agg=A_agg,
                            diag=diag, constrained=constrained, sizes=sizes)
