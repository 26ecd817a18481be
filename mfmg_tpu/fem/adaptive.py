"""Adaptive (1-irregular) mesh refinement with hanging-node constraints.

The reference inherits hanging-node handling from deal.II: locally refined
Triangulations produce AffineConstraints that tie each hanging dof to the
dofs of the coarse neighbor face, and assembly condenses them into the global
system (reference tests/laplace.hpp:126-141,197-199).  This module is the
minimal analog for Q1 elements:

  * ``refine_adaptive(verts, cells, marks)`` splits the marked hex/quad cells
    into 2^dim children (flat transfinite vertex placement, matching
    deal.II's TriaAccessor::center on flat manifolds) and returns the
    1-irregular cell complex plus the hanging constraints:
      - edge midpoint hanging on an unrefined neighbor edge:
            u_mid = 1/2 (u_a + u_b)
      - 3D face center hanging on an unrefined neighbor face:
            u_ctr = 1/4 (u_00 + u_10 + u_01 + u_11)
    exactly deal.II's Q1 constraint weights
    (dealii DoFTools::make_hanging_node_constraints).

  * ``HangingConstraints`` is the AffineConstraints analog: the constraint
    matrix C (identity on free dofs, interpolation weights on slave rows) in
    sparse form, with ``condense`` (A -> C^T A C) and ``distribute``
    (u_slave <- sum w * u_master) — the solve happens in range(C).

The framework treats hanging slave dofs like Dirichlet-constrained dofs
everywhere downstream (AMGe local problems, smoothers, transfer operators):
their rows in the condensed system are identity, the V-cycle leaves them
untouched, and ``LaplaceProblem.distribute`` recovers their values after the
solve.  Callers opt in per mesh (``Mesh.hanging``); conforming meshes are
entirely unaffected.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class HangingConstraints:
    """Hanging-node constraints u[slave] = sum_j weights[j] * u[masters[j]].

    masters/weights are padded to the max master count per slave;
    n_masters gives the valid prefix length per row.
    """

    slaves: np.ndarray        # (n_h,) int
    masters: np.ndarray       # (n_h, m_max) int, padded with 0
    weights: np.ndarray       # (n_h, m_max) float, padded with 0.0
    n_masters: np.ndarray     # (n_h,) int

    @property
    def n(self) -> int:
        return len(self.slaves)

    def slave_mask(self, n_dofs: int) -> np.ndarray:
        mask = np.zeros(n_dofs, dtype=bool)
        mask[self.slaves] = True
        return mask

    def matrix(self, n_dofs: int) -> sp.csr_matrix:
        """The constraint matrix C (n_dofs x n_dofs): identity on free dofs,
        interpolation weights on slave rows (zero slave columns)."""
        free = np.setdiff1d(np.arange(n_dofs), self.slaves)
        rows = [free]
        cols = [free]
        vals = [np.ones(len(free))]
        for i in range(self.n):
            m = int(self.n_masters[i])
            rows.append(np.full(m, self.slaves[i]))
            cols.append(self.masters[i, :m])
            vals.append(self.weights[i, :m])
        return sp.csr_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=(n_dofs, n_dofs))

    def condense(self, A_raw: sp.spmatrix) -> sp.csr_matrix:
        """C^T A C with the raw diagonal restored at slave dofs (the framework's
        constrained-diagonal convention, see ops.sparse.eliminate_dirichlet)."""
        n = A_raw.shape[0]
        C = self.matrix(n)
        A = (C.T @ A_raw @ C).tocsr()
        d = sp.coo_matrix(
            (np.asarray(A_raw.diagonal())[self.slaves],
             (self.slaves, self.slaves)), shape=(n, n))
        return (A + d).tocsr()

    def distribute(self, u: np.ndarray) -> np.ndarray:
        """Set slave values from their masters (AffineConstraints::distribute)."""
        out = np.array(u)
        vals = np.einsum("hm,hm->h", self.weights,
                         np.where(np.arange(self.masters.shape[1])[None, :]
                                  < self.n_masters[:, None],
                                  out[self.masters], 0.0))
        out[self.slaves] = vals
        return out


def refine_adaptive(verts: np.ndarray, cells: np.ndarray, marks: np.ndarray,
                    prior_constraints=None):
    """Refine the marked cells of a quad/hex complex into 2^dim children.

    Returns (verts, cells, constraints_raw, interface_faces) where
    constraints_raw is a list of (slave_vertex, [master_vertices], [weights])
    at the VERTEX level (Q1).

    Multi-sweep refinement: pass the PREVIOUS sweep's constraints_raw (or a
    packed HangingConstraints) as ``prior_constraints``.  Prior hanging
    vertices are then
      * reused (not duplicated) when their coarse facet is refined this sweep,
      * kept constrained while their coarse neighbor stays unrefined,
      * released when the coarse side refines (both sides then conform).
    The result must stay 1-irregular: marking a cell on the FINE side of a
    still-active interface would hang new vertices two levels below the
    coarse facet; that is detected and raises ValueError (deal.II instead
    auto-refines the coarse neighbor — callers should mark it too and
    re-sweep).
    """
    from mfmg_tpu.fem.ball import _cell_faces

    verts = np.asarray(verts, dtype=float)
    cells = np.asarray(cells, dtype=np.int64)
    marks = np.asarray(marks, dtype=bool)
    dim = verts.shape[1]
    faces = _cell_faces(dim)

    prior_raw = _unpack_constraints(prior_constraints)

    # Entities (edges / 3D faces) of the UNREFINED cells: a new mid vertex on
    # one of these is hanging.
    unref_edges: set = set()
    unref_faces: set = set()
    for c in cells[~marks]:
        for f in faces:
            fv = tuple(sorted(int(c[i]) for i in f))
            if dim == 2:
                unref_edges.add(fv)
            else:
                unref_faces.add(fv)
                a, b, c_, d = (int(c[i]) for i in f)   # (00,10,01,11)
                for e in ((a, b), (c_, d), (a, c_), (b, d)):
                    unref_edges.add(tuple(sorted(e)))

    V = [v for v in verts]
    cache: dict = {}
    hanging: dict = {}          # new vertex id -> (masters, weights)

    # ---- merge state from previous sweeps --------------------------------
    # Seed the midpoint cache with prior hanging vertices so a coarse facet
    # refined this sweep reuses them instead of duplicating; partition prior
    # constraints into retained (coarse side still unrefined) and released.
    retained_prior: list = []
    for s, ms, ws in prior_raw:
        key = tuple(sorted(int(m) for m in ms))
        cache[key] = int(s)
        kept = key in (unref_edges if len(ms) == 2 else unref_faces)
        if kept:
            retained_prior.append((int(s), [int(m) for m in ms],
                                   [float(w) for w in ws]))
    active_slaves = {s: set(ms) for s, ms, _ in retained_prior}

    def _check_edge(a, b):
        # Splitting an edge that lies INSIDE a still-active coarse facet
        # (one endpoint is a retained hanging vertex, the other one of its
        # masters) would create a 2-irregular vertex.
        for u, v in ((a, b), (b, a)):
            if u in active_slaves and v in active_slaves[u]:
                raise ValueError(
                    "refinement would make the mesh 2-irregular: cell edge "
                    f"({a},{b}) subdivides a facet that still hangs on an "
                    "unrefined coarse neighbor — mark that neighbor for "
                    "refinement in the same sweep")
    # Facets (edges in 2D, quads in 3D) that sit on a hanging interface: they
    # appear in exactly one cell of the refined complex (the coarse facet on
    # the unrefined side, its subfacets on the refined side) yet are interior.
    # from_cell_complex must not mistake them for boundary.
    interface_faces: set = set()

    # Geometric vertex dedup: a multi-sweep refinement recreates midpoints
    # that an earlier sweep already built (e.g. the boundary-edge midpoints
    # of a released interface, which were never constraints and so are not
    # in the constraint-seeded cache).  Midpoint formulas are bitwise
    # reproducible (same IEEE expression on the same inputs); rounding adds
    # safety margin.
    coord_index: dict = {tuple(np.round(v, 12)): i for i, v in enumerate(V)}

    def _new(p):
        p = np.asarray(p, dtype=float)
        key = tuple(np.round(p, 12))
        vid = coord_index.get(key)
        if vid is not None:
            return vid
        V.append(p)
        coord_index[key] = len(V) - 1
        return len(V) - 1

    def line_mid(a, b):
        key = tuple(sorted((int(a), int(b))))
        if key in cache:
            return cache[key]
        _check_edge(*key)
        vid = _new(0.5 * (V[key[0]] + V[key[1]]))
        cache[key] = vid
        if key in unref_edges:
            hanging[vid] = (list(key), [0.5, 0.5])
            if dim == 2:
                interface_faces.update(
                    {key, tuple(sorted((key[0], vid))),
                     tuple(sorted((key[1], vid)))})
        return vid

    def quad_mid(q):
        """q in (v00, v10, v01, v11) layout (3D faces / 2D cell centers)."""
        key = tuple(sorted(int(v) for v in q))
        if key in cache:
            return cache[key]
        # splitting a subface of a still-active coarse face (its center is a
        # retained 4-master hanging vertex among our corners) -> 2-irregular
        for v in key:
            ms = active_slaves.get(v)
            if ms is not None and len(ms) == 4 and ms & set(key):
                raise ValueError(
                    "refinement would make the mesh 2-irregular: face "
                    f"{key} subdivides a face that still hangs on an "
                    "unrefined coarse neighbor — mark that neighbor for "
                    "refinement in the same sweep")
        a, b, c_, d = (int(v) for v in q)
        e_ab, e_cd = line_mid(a, b), line_mid(c_, d)
        e_ac, e_bd = line_mid(a, c_), line_mid(b, d)
        lm = [V[e_ab], V[e_cd], V[e_ac], V[e_bd]]
        vs = [V[i] for i in (a, b, c_, d)]
        vid = _new(0.5 * sum(lm) - 0.25 * sum(vs))
        cache[key] = vid
        if dim == 3 and key in unref_faces:
            # Q1 interpolation of the coarse face at its center: 1/4 each
            # corner (deal.II make_hanging_node_constraints).
            hanging[vid] = ([a, b, c_, d], [0.25] * 4)
            interface_faces.add(key)
            for corner, ex, ey in ((a, e_ab, e_ac), (b, e_ab, e_bd),
                                   (c_, e_cd, e_ac), (d, e_cd, e_bd)):
                interface_faces.add(tuple(sorted((corner, ex, ey, vid))))
        return vid

    def hex_mid(c):
        key = tuple(sorted(int(v) for v in c))
        if key in cache:
            return cache[key]
        fm = [V[quad_mid(tuple(c[list(f)]))] for f in _cell_faces(3)]
        idx = np.arange(8)
        coords = [(idx >> d) & 1 for d in range(3)]
        lmids = []
        for d in range(3):
            for i in idx[coords[d] == 0]:
                j = i + (1 << d)
                lmids.append(V[line_mid(int(c[i]), int(c[j]))])
        vs = [V[int(v)] for v in c]
        vid = _new(0.5 * sum(fm) - 0.25 * sum(lmids) + 0.125 * sum(vs))
        cache[key] = vid
        return vid

    new_cells = []
    for c, m in zip(cells, marks):
        if not m:
            new_cells.append([int(v) for v in c])
            continue
        grid = {}
        for mi in np.ndindex(*(3,) * dim):
            odd = [d for d in range(dim) if mi[d] == 1]
            if not odd:
                grid[mi] = int(c[sum((mi[d] // 2) << d for d in range(dim))])
            elif len(odd) == 1:
                d0 = odd[0]
                lo = tuple(0 if d == d0 else mi[d] // 2 for d in range(dim))
                a = c[sum(lo[d] << d for d in range(dim))]
                b = c[sum((lo[d] if d != d0 else 1) << d for d in range(dim))]
                grid[mi] = line_mid(int(a), int(b))
            elif len(odd) == 2:
                dfix = [d for d in range(dim) if d not in odd]
                quad = []
                for t1 in (0, 1):
                    for t0 in (0, 1):
                        corner = [0] * dim
                        corner[odd[0]] = t0
                        corner[odd[1]] = t1
                        for d in dfix:
                            corner[d] = mi[d] // 2
                        quad.append(int(c[sum(corner[d] << d for d in range(dim))]))
                grid[mi] = quad_mid(tuple(quad))
            else:
                grid[mi] = hex_mid(c)
        for si in range(2 ** dim):
            sub = tuple((si >> d) & 1 for d in range(dim))
            child = []
            for ci in range(2 ** dim):
                corner = tuple((ci >> d) & 1 for d in range(dim))
                mi = tuple(sub[d] + corner[d] for d in range(dim))
                child.append(grid[mi])
            new_cells.append(child)

    # ---- re-emit retained prior constraints + their interface facets -----
    def _mid_id(a, b):
        """Vertex id of the midpoint of (a, b): from the constraint-seeded
        cache, else geometrically (prior midpoints that were never
        constraints, e.g. edge midpoints on the domain boundary)."""
        vid = cache.get(tuple(sorted((a, b))))
        if vid is None:
            vid = coord_index.get(tuple(np.round(0.5 * (V[a] + V[b]), 12)))
        return vid

    for s, ms, ws in retained_prior:
        if s not in hanging:
            hanging[s] = (ms, ws)
        if len(ms) == 2:
            a, b = ms
            if dim == 2:
                interface_faces.update({tuple(sorted((a, b))),
                                        tuple(sorted((a, s))),
                                        tuple(sorted((b, s)))})
        else:                                   # 3D face constraint
            a, b, c_, d = ms                    # (00,10,01,11) creation layout
            interface_faces.add(tuple(sorted(ms)))
            e_ab, e_cd = _mid_id(a, b), _mid_id(c_, d)
            e_ac, e_bd = _mid_id(a, c_), _mid_id(b, d)
            if None not in (e_ab, e_cd, e_ac, e_bd):
                for corner, ex, ey in ((a, e_ab, e_ac), (b, e_ab, e_bd),
                                       (c_, e_cd, e_ac), (d, e_cd, e_bd)):
                    interface_faces.add(tuple(sorted((corner, ex, ey, s))))

    constraints_raw = [(vid, ms, ws) for vid, (ms, ws) in sorted(hanging.items())]
    # invariant: masters are free vertices (1-irregularity was enforced above)
    slave_set = {s for s, _, _ in constraints_raw}
    for s, ms, _ in constraints_raw:
        assert not (slave_set & set(ms)), (
            f"constraint chain at vertex {s} — mesh is not 1-irregular")
    return (np.asarray(V), np.asarray(new_cells, dtype=np.int64), constraints_raw,
            interface_faces)


def _unpack_constraints(prior) -> list:
    """Normalize prior constraints (raw list or HangingConstraints) to the
    raw [(slave, masters, weights)] form."""
    if prior is None:
        return []
    if isinstance(prior, HangingConstraints):
        return [(int(prior.slaves[i]),
                 [int(m) for m in prior.masters[i, :prior.n_masters[i]]],
                 [float(w) for w in prior.weights[i, :prior.n_masters[i]]])
                for i in range(prior.n)]
    return list(prior)


def _pack_constraints(constraints_raw) -> HangingConstraints | None:
    if not constraints_raw:
        return None
    n_h = len(constraints_raw)
    m_max = max(len(ms) for _, ms, _ in constraints_raw)
    slaves = np.empty(n_h, dtype=np.int64)
    masters = np.zeros((n_h, m_max), dtype=np.int64)
    weights = np.zeros((n_h, m_max))
    n_masters = np.empty(n_h, dtype=np.int64)
    for i, (s, ms, ws) in enumerate(constraints_raw):
        slaves[i] = s
        masters[i, :len(ms)] = ms
        weights[i, :len(ws)] = ws
        n_masters[i] = len(ms)
    return HangingConstraints(slaves=slaves, masters=masters,
                              weights=weights, n_masters=n_masters)


def adaptive_mesh(verts: np.ndarray, cells: np.ndarray, marks: np.ndarray,
                  prior_constraints=None):
    """Refine marked cells and build a Q1 Mesh carrying the hanging
    constraints.  Marks may be a bool mask or a callable(cell_centers)->mask.
    Only degree-1 elements are supported on hanging meshes.

    For a SECOND refinement sweep on an already-adaptive mesh, pass the
    previous mesh's constraints (``mesh.hanging``) as ``prior_constraints``
    (or use :func:`refine_mesh`, which threads them automatically)."""
    from mfmg_tpu.fem.mesh import from_cell_complex

    if callable(marks):
        centers = np.asarray(verts)[np.asarray(cells)].mean(axis=1)
        marks = np.asarray(marks(centers), dtype=bool)
    v2, c2, raw, interface = refine_adaptive(verts, cells, marks,
                                             prior_constraints=prior_constraints)
    mesh = from_cell_complex(v2, c2, degree=1, interior_faces=interface)
    # from_cell_complex(degree=1) keeps vertex ids as dof ids, so the raw
    # vertex-level constraints are already dof-level.
    mesh.hanging = _pack_constraints(raw)
    if mesh.hanging is not None:
        # A hanging dof on the Dirichlet boundary keeps its Dirichlet status
        # (the boundary mask wins; deal.II merges constraints the same way:
        # boundary values are the dominating constraint set).
        keep = ~mesh.boundary_dofs[mesh.hanging.slaves]
        if not keep.all():
            h = mesh.hanging
            mesh.hanging = HangingConstraints(
                slaves=h.slaves[keep], masters=h.masters[keep],
                weights=h.weights[keep], n_masters=h.n_masters[keep])
    return mesh


def refine_mesh(mesh, marks) -> "Mesh":
    """One adaptive sweep on an existing Q1 mesh, carrying its hanging
    constraints through (multi-sweep entry point)."""
    return adaptive_mesh(mesh.nodes, mesh.cells, marks,
                         prior_constraints=getattr(mesh, "hanging", None))


def adaptive_cube(dim: int, n_refinements: int, marks) -> "Mesh":
    """Uniformly refined unit cube with one extra adaptive sweep over the
    cells selected by ``marks`` (mask or callable on cell centers) — the
    hanging-node analog of the reference's locally refined test meshes."""
    nc = 2 ** n_refinements
    axes = [np.linspace(0.0, 1.0, nc + 1) for _ in range(dim)]
    grids = np.meshgrid(*axes, indexing="ij")
    verts = np.stack([g.flatten(order="F") for g in grids], axis=-1)
    n1 = nc + 1
    strides = np.array([n1 ** d for d in range(dim)])
    n_cells = nc ** dim
    idx = np.arange(n_cells)
    mi = np.empty((n_cells, dim), dtype=np.int64)
    tmp = idx.copy()
    for d in range(dim):
        mi[:, d] = tmp % nc
        tmp //= nc
    cells = np.zeros((n_cells, 2 ** dim), dtype=np.int64)
    for ci in range(2 ** dim):
        corner = [(ci >> d) & 1 for d in range(dim)]
        cells[:, ci] = ((mi + np.asarray(corner)) * strides).sum(axis=1)
    return adaptive_mesh(verts, cells, marks)
