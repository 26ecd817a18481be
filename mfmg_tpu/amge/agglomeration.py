"""Agglomerate partitioning of mesh cells.

Analog of AMGe::build_agglomerates (reference common/amge.templates.hpp:51-85):
  * "block": group nx x ny x nz neighboring cells per agglomerate — the
    reference's x->y->z walk (amge.templates.hpp:412-499).  On a structured
    grid this is a closed-form index computation instead of a mesh walk; the
    partition (which cells share an agglomerate) is identical, agglomerate
    *numbering* may differ from deal.II's Z-order iteration, which affects
    nothing downstream (restriction rows are permutation-invariant).
  * "metis"/"zoltan": graph partitioning of the cell-connectivity graph into
    n_agglomerates parts (amge.templates.hpp:501-594).  Implemented with a
    recursive coordinate-bisection partitioner (no external graph library
    needed); produces balanced connected parts like Zoltan's RCB.
"""

from __future__ import annotations

import numpy as np

from mfmg_tpu.fem.mesh import Mesh


def build_agglomerates(mesh: Mesh, agg_cfg) -> np.ndarray:
    """Returns (n_cells,) agglomerate ids in [0, n_agg)."""
    if agg_cfg.partitioner == "block":
        return build_agglomerates_block(mesh, agg_cfg.block_dims(mesh.dim))
    if agg_cfg.partitioner == "block_dealii":
        # The reference walk with deal.II's cell iteration (Morton) seed
        # order — reproduces the literal agglomerate-id goldens
        # (test_agglomerate.cc:79-288) bit-for-bit; the *partition* is the
        # same as "block" whenever block dims divide the mesh evenly.
        from mfmg_tpu.fem.dealii_order import dealii_cell_order
        return _block_walk_unstructured(mesh, agg_cfg.block_dims(mesh.dim),
                                        seed_order=dealii_cell_order(mesh))
    if agg_cfg.partitioner == "metis":
        # true multilevel KL/FM graph partitioning (METIS's scheme)
        from mfmg_tpu.amge.graph_partition import build_agglomerates_multilevel
        return build_agglomerates_multilevel(mesh, agg_cfg.n_agglomerates)
    if agg_cfg.partitioner in ("zoltan", "rcb"):
        return build_agglomerates_rcb(mesh, agg_cfg.n_agglomerates)
    raise ValueError(f"unknown partitioner {agg_cfg.partitioner!r}")


def build_agglomerates_block(mesh: Mesh, block_dims) -> np.ndarray:
    if mesh.is_structured:
        nc = mesh.structured_shape
        mi = mesh.cell_multi_index()                     # (n_cells, dim)
        agg_mi = np.empty_like(mi)
        n_agg_per_dim = []
        for d in range(mesh.dim):
            agg_mi[:, d] = mi[:, d] // block_dims[d]
            n_agg_per_dim.append(-(-nc[d] // block_dims[d]))
        agg = np.zeros(mesh.n_cells, dtype=np.int64)
        stride = 1
        for d in range(mesh.dim):
            agg += agg_mi[:, d] * stride
            stride *= n_agg_per_dim[d]
        return agg
    # Unstructured block walk: greedy growth along neighbor directions — the
    # direct analog of the reference's walk.  Uses cell centroids to define
    # the +x/+y/+z neighbor relation.
    return _block_walk_unstructured(mesh, block_dims)


def _cell_centroids(mesh: Mesh) -> np.ndarray:
    return mesh.nodes[mesh.cells].mean(axis=1)


def face_neighbors(mesh: Mesh) -> np.ndarray:
    """(n_cells, 2*dim) neighbor across each local face, -1 at boundary.

    Face order matches deal.II (amge.templates.hpp:416-420): x-,x+,y-,y+,z-,z+
    in the CELL-LOCAL frame (neighbors follow local orientation, as deal.II
    iterators do)."""
    dim = mesh.dim
    k = mesh.degree
    lm_all = np.arange((k + 1) ** dim)
    # local node multi-index, x fastest
    from mfmg_tpu.fem.reference import reference_element
    lm = reference_element(dim, k).local_multi_index
    face_local = []
    for d in range(dim):
        for side in (0, k):
            face_local.append(np.nonzero(lm[:, d] == side)[0])
    face_map = {}
    n_cells = mesh.n_cells
    nbrs = -np.ones((n_cells, 2 * dim), dtype=np.int64)
    for c in range(n_cells):
        for f, fl in enumerate(face_local):
            key = tuple(sorted(int(v) for v in mesh.cells[c, fl]))
            other = face_map.pop(key, None)
            if other is None:
                face_map[key] = (c, f)
            else:
                oc, of = other
                nbrs[c, f] = oc
                nbrs[oc, of] = c
    return nbrs


def _block_walk_unstructured(mesh: Mesh, block_dims, seed_order=None) -> np.ndarray:
    """The reference's x->y->z block walk, verbatim semantics
    (amge.templates.hpp:422-494): seed at the first unassigned cell in cell
    order, then walk nx cells through each cell's local x+ face, stepping the
    row start through y+ and the plane start through z+.  Cells are
    (re)marked unconditionally during a walk, exactly like the reference's
    set_user_index.

    seed_order: optional cell iteration order for seeding (deal.II Morton
    order for golden parity); default is our natural cell order."""
    dim = mesh.dim
    nbrs = face_neighbors(mesh)
    X_P, Y_P, Z_P = 1, 3, 5                     # local face ids (x+, y+, z+)
    n_cells = mesh.n_cells
    agg = np.zeros(n_cells, dtype=np.int64)     # 0 = unassigned (reference convention)
    current = 0
    d3 = block_dims[2] if dim == 3 else 1
    if seed_order is None:
        seed_order = range(n_cells)
    for c0 in seed_order:
        if agg[c0] != 0:
            continue
        current += 1
        agg[c0] = current
        z_cell = c0
        for _k in range(d3):
            y_cell = z_cell
            for _j in range(block_dims[1]):
                cell = y_cell
                for _i in range(block_dims[0]):
                    agg[cell] = current
                    nxt = nbrs[cell, X_P]
                    if nxt < 0:
                        break
                    cell = nxt
                nxt = nbrs[y_cell, Y_P]
                if nxt < 0:
                    break
                y_cell = nxt
            if dim == 3:
                nxt = nbrs[z_cell, Z_P]
                if nxt < 0:
                    break
                z_cell = nxt
    # compress ids (stolen cells can empty an agglomerate) and 0-base
    _, agg = np.unique(agg, return_inverse=True)
    return agg


def build_agglomerates_rcb(mesh: Mesh, n_agglomerates: int) -> np.ndarray:
    """Recursive coordinate bisection into n_agglomerates balanced parts."""
    centroids = _cell_centroids(mesh)
    ids = np.arange(mesh.n_cells)
    parts = [(ids, n_agglomerates)]
    out = np.zeros(mesh.n_cells, dtype=np.int64)
    next_id = 0
    while parts:
        idx, k = parts.pop()
        if k <= 1:
            out[idx] = next_id
            next_id += 1
            continue
        pts = centroids[idx]
        spread = pts.max(axis=0) - pts.min(axis=0)
        d = int(np.argmax(spread))
        order = np.argsort(pts[:, d], kind="stable")
        k_left = k // 2
        split = int(round(len(idx) * k_left / k))
        parts.append((idx[order[:split]], k_left))
        parts.append((idx[order[split:]], k - k_left))
    return out
