"""deal.II-compatible cell and DoF orderings for structured hyper_cube meshes.

The reference inherits deal.II's orderings everywhere an ordering matters:
  * active cells iterate in refinement-tree order — for hyper_cube +
    refine_global(r) that is Morton/Z-order over the 2^r-per-dim cell grid
    (children numbered x-fastest: child = ix + 2*iy + 4*iz);
  * DoFHandler numbering is first-touch over that cell iteration, local
    vertices in deal.II order (x fastest) — reference tests assemble in it
    and the sequential Gauss-Seidel goldens (test_hierarchy.cc:343-356)
    measure rates in it.

Our meshes use x-fastest *lexicographic* numbering (the accelerator-friendly layout
for stencils and slab sharding).  These helpers provide the exact deal.II
permutations on top, so ordering-sensitive reference goldens (Gauss-Seidel
rates, literal agglomerate-id vectors, test_agglomerate.cc:79-288) can be
reproduced bit-for-bit without giving up the native layout.
"""

from __future__ import annotations

import numpy as np

from mfmg_tpu.fem.mesh import Mesh


def _check_structured_pow2(mesh: Mesh) -> int:
    if not mesh.is_structured:
        raise ValueError("deal.II ordering is defined for structured "
                         "hyper_cube meshes only")
    shape = mesh.structured_shape
    nc = shape[0]
    if any(s != nc for s in shape):
        raise ValueError("deal.II ordering needs equal cells per dimension "
                         f"(refine_global semantics); got {shape}")
    r = int(nc).bit_length() - 1
    if 2 ** r != nc:
        raise ValueError(f"cells per dim must be a power of two, got {nc}")
    return r


def dealii_cell_order(mesh: Mesh) -> np.ndarray:
    """Our cell ids in deal.II active-cell iteration order.

    Returns order (n_cells,) such that mesh.cells[order] walks cells exactly
    as deal.II's cell iterator does after refine_global: recursively through
    children numbered ix + 2*iy (+ 4*iz) — i.e. Morton order with x the
    least-significant axis within each refinement level.
    """
    r = _check_structured_pow2(mesh)
    mi = mesh.cell_multi_index()          # (n_cells, dim), x first
    key = np.zeros(mesh.n_cells, dtype=np.int64)
    for level in range(r - 1, -1, -1):
        child = np.zeros(mesh.n_cells, dtype=np.int64)
        for d in range(mesh.dim):
            child += ((mi[:, d] >> level) & 1) << d
        key = key * (2 ** mesh.dim) + child
    return np.argsort(key, kind="stable")


def dealii_dof_numbering(mesh: Mesh) -> np.ndarray:
    """deal.II DoF number for each of our dofs (Q1 structured hyper_cube).

    Returns dealii_of (n_nodes,) with dealii_of[our_dof] = deal.II dof index:
    first-touch assignment over cells in deal.II iteration order, local
    vertices x-fastest (identical to our local order for Q1).
    """
    if mesh.degree != 1:
        raise NotImplementedError(
            "deal.II numbering implemented for Q1 (the reference goldens' "
            "fe_degree); FE_Q<k>'s vertex/line/quad/hex block order is not "
            "reproduced for k > 1")
    order = dealii_cell_order(mesh)
    seq = mesh.cells[order].reshape(-1)
    # first occurrence position of each dof in the traversal
    _, first_pos = np.unique(seq, return_index=True)   # sorted by dof id
    dealii_of = np.empty(mesh.n_nodes, dtype=np.int64)
    # dofs ranked by first-touch position
    touch_order = np.argsort(first_pos, kind="stable")
    dealii_of[touch_order] = np.arange(mesh.n_nodes)
    return dealii_of
