"""Adaptive (hanging-node) meshes: the AffineConstraints analog.

The reference inherits hanging-node handling from deal.II AffineConstraints
(tests/laplace.hpp:126-141: make_hanging_node_constraints + condense +
distribute).  These tests cover the minimal analog in
fem/adaptive.py: constraint construction, condensation correctness on a
manufactured solution, and the full AMGe hierarchy on a 1-irregular mesh.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from mfmg_tpu import Config, Hierarchy, LaplaceProblem
from mfmg_tpu.config import AgglomerationConfig, SmootherConfig
from mfmg_tpu.fem.adaptive import adaptive_cube
from mfmg_tpu.fem.mesh import hyper_cube


def _quadrant(centers):
    return np.all(centers < 0.5, axis=1)


def test_constraints_2d_structure():
    mesh = adaptive_cube(2, 2, _quadrant)       # 4x4 grid, lower-left 2x2 refined
    h = mesh.hanging
    assert h is not None
    # 1-irregular interface: the refined quadrant meets unrefined cells along
    # two interface segments of 2 coarse edges each -> 2 interior hanging
    # midpoints per segment minus the boundary-owned ones.  Each hanging dof
    # has exactly 2 masters with weight 1/2.
    assert h.n > 0
    assert np.all(h.n_masters == 2)
    assert np.allclose(h.weights[:, :2], 0.5)
    # every slave sits at the midpoint of its masters (flat mesh)
    mid = 0.5 * (mesh.nodes[h.masters[:, 0]] + mesh.nodes[h.masters[:, 1]])
    assert np.allclose(mesh.nodes[h.slaves], mid)
    # slaves are flagged constrained but are not Dirichlet
    assert np.all(mesh.constrained_mask[h.slaves])
    assert not np.any(mesh.boundary_dofs[h.slaves])


def test_constraints_3d_face_and_edge():
    mesh = adaptive_cube(3, 1, _quadrant)       # 2x2x2, one cell refined
    h = mesh.hanging
    assert h is not None
    # The refined corner cell exposes 3 interior faces to unrefined neighbors:
    # each contributes edge-midpoint constraints (2 masters) and one
    # face-center constraint (4 masters, weight 1/4).
    n4 = int(np.sum(h.n_masters == 4))
    n2 = int(np.sum(h.n_masters == 2))
    assert n4 == 3, (n4, n2)
    assert n2 > 0
    w4 = h.weights[h.n_masters == 4]
    assert np.allclose(w4, 0.25)
    # face centers sit at the mean of their 4 masters
    s4 = h.slaves[h.n_masters == 4]
    m4 = h.masters[h.n_masters == 4]
    assert np.allclose(mesh.nodes[s4], mesh.nodes[m4].mean(axis=1))


def test_condensed_solve_manufactured():
    """-Δu = f with u = sin(pi x) sin(pi y): the condensed system on the
    adaptive mesh must be SPD on free dofs, continuous across the hanging
    interface, and at least as accurate as the unrefined mesh."""

    def exact(p):
        return np.sin(np.pi * p[..., 0]) * np.sin(np.pi * p[..., 1])

    def source(p):
        return 2.0 * np.pi**2 * exact(p)

    errs = {}
    for name, mesh in [("coarse", hyper_cube(2, 4)),
                       ("adaptive", adaptive_cube(2, 4, _quadrant)),
                       ("fine", hyper_cube(2, 5))]:
        prob = LaplaceProblem.from_mesh(mesh, "constant")
        A = prob.A
        assert abs(A - A.T).max() < 1e-12          # condensation keeps symmetry
        rhs = prob.assemble_rhs(source)
        import scipy.sparse.linalg as spla
        u = spla.spsolve(A.tocsc(), rhs)
        u = prob.distribute(u)
        # continuity: slave values equal the coarse-side interpolation
        if mesh.hanging is not None:
            hh = mesh.hanging
            interp = 0.5 * (u[hh.masters[:, 0]] + u[hh.masters[:, 1]])
            assert np.allclose(u[hh.slaves], interp)
        errs[name] = prob.l2_error(u, exact)
    # refinement helps, full refinement helps more
    assert errs["adaptive"] < errs["coarse"]
    assert errs["fine"] < errs["adaptive"]


def test_hierarchy_on_adaptive_mesh():
    """Full AMGe hierarchy on a 1-irregular mesh: slaves ride through setup as
    constrained dofs; PCG converges and the V-cycle contracts."""
    mesh = adaptive_cube(2, 4, _quadrant)
    prob = LaplaceProblem.from_mesh(mesh, "linear")
    cfg = Config(operator="ell", max_levels=2, is_preconditioner=True,
                 smoother=SmootherConfig(type="chebyshev", degree=3),
                 agglomeration=AgglomerationConfig(partitioner="metis",
                                                   n_agglomerates=16))
    hier = Hierarchy(prob, cfg)

    rng = np.random.default_rng(3)
    b = rng.standard_normal(prob.n_dofs)
    b[prob.constrained] = 0.0
    x, info = hier.solve_cg(jnp.asarray(b), tol=1e-8)
    assert int(info["iterations"]) < 40, info
    r = np.asarray(b) - prob.A @ np.asarray(x)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-7
    # hanging slaves stay untouched by the preconditioned solve (identity rows)
    assert np.allclose(np.asarray(x)[mesh.hanging.slaves], 0.0)


def test_matrix_free_equals_assembled_on_hanging():
    """C^T A C applied cell-wise (ops/local_apply.py hanging path) matches
    the assembled condensed matrix to roundoff — the reference's
    MatrixFree+AffineConstraints equivalence (tests/laplace.hpp:126-141) —
    in both compute modes, 2D and 3D."""
    from mfmg_tpu.ops.local_apply import mf_diagonal

    for dim, nr in ((2, 3), (3, 1)):
        mesh = adaptive_cube(dim, nr, _quadrant)
        prob = LaplaceProblem.from_mesh(mesh, "linear")
        rng = np.random.default_rng(2)
        u = jnp.asarray(rng.standard_normal(prob.n_dofs))
        y_ref = prob.A @ np.asarray(u)
        for mode in ("local_matrix", "quadrature"):
            op = prob.matrix_free_operator(mode=mode)
            y = np.asarray(op @ u)
            np.testing.assert_allclose(y, y_ref, atol=1e-9 * np.abs(y_ref).max())
            np.testing.assert_allclose(np.asarray(mf_diagonal(op)),
                                       np.asarray(prob.A.diagonal()), rtol=1e-12)


def test_hierarchy_on_adaptive_mesh_matrix_free():
    """Full AMGe hierarchy with the MATRIX-FREE operator on a 1-irregular
    mesh (the round-2 verdict gap): PCG converges against the condensed
    system."""
    mesh = adaptive_cube(2, 4, _quadrant)
    prob = LaplaceProblem.from_mesh(mesh, "linear")
    cfg = Config(operator="matrix_free", max_levels=2, is_preconditioner=True,
                 smoother=SmootherConfig(type="chebyshev", degree=3),
                 agglomeration=AgglomerationConfig(partitioner="metis",
                                                   n_agglomerates=16))
    hier = Hierarchy(prob, cfg)

    rng = np.random.default_rng(3)
    b = rng.standard_normal(prob.n_dofs)
    b[prob.constrained] = 0.0
    x, info = hier.solve_cg(jnp.asarray(b), tol=1e-8)
    assert int(info["iterations"]) < 40, info
    r = np.asarray(b) - prob.A @ np.asarray(x)
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-7
    assert np.allclose(np.asarray(x)[mesh.hanging.slaves], 0.0)


def _linear_patch_residual(mesh):
    """Conformity oracle: Q1 + hanging constraints reproduce a global linear
    u = x exactly, so the condensed operator C^T A C applied to it must
    vanish at every free (non-Dirichlet, non-slave) dof.  A dropped or wrong
    constraint leaves a nonzero residual at the interface."""
    from mfmg_tpu.ops.sparse import assemble_csr
    prob = LaplaceProblem.from_mesh(mesh, "constant")
    A_raw = assemble_csr(mesh.cells, prob.A_loc, mesh.n_nodes)
    C = mesh.hanging.matrix(mesh.n_nodes) if mesh.hanging is not None else None
    A_c = (C.T @ A_raw @ C) if C is not None else A_raw
    u = mesh.nodes[:, 0]
    r = np.asarray(A_c @ u)
    free = ~mesh.constrained_mask
    return np.abs(r[free]).max()


def test_multi_sweep_keeps_prior_constraints():
    """Second adaptive sweep away from the first interface: sweep-1 hanging
    vertices remain constrained (the advisor's round-2 finding — they were
    silently dropped), and the basis stays conforming (a global linear is
    reproduced to roundoff)."""
    from mfmg_tpu.fem.adaptive import refine_mesh

    m1 = adaptive_cube(2, 3, _quadrant)          # 8x8, lower-left refined
    h1_slaves = set(int(s) for s in m1.hanging.slaves)
    n1 = m1.hanging.n

    def far_corner(centers):                     # upper-right corner cell
        return np.all(centers > 1.0 - 1.0 / 8, axis=1)

    m2 = refine_mesh(m1, far_corner)
    h2_slaves = set(int(s) for s in m2.hanging.slaves)
    assert h1_slaves <= h2_slaves, "sweep-1 constraints were dropped"
    assert m2.hanging.n > n1                     # plus the new interface
    assert _linear_patch_residual(m2) < 1e-10


def test_multi_sweep_releases_refined_coarse_side():
    """Refining the coarse neighbor of an active interface releases its
    hanging vertices (both sides now conform) and reuses the midpoint
    vertices instead of duplicating them."""
    from mfmg_tpu.fem.adaptive import refine_mesh

    m1 = adaptive_cube(2, 2, _quadrant)          # 4x4, lower-left 2x2 refined
    n_nodes_1 = m1.n_nodes

    # refine every unrefined coarse cell -> uniformly fine, conforming mesh
    def coarse_cells(centers):
        return ~_quadrant(centers)

    m2 = refine_mesh(m1, coarse_cells)
    assert m2.hanging is None or m2.hanging.n == 0
    # prior hanging midpoints were reused: the released slaves' coordinates
    # appear exactly once in the new vertex table
    _, counts = np.unique(np.round(m2.nodes, 12), axis=0, return_counts=True)
    assert counts.max() == 1
    assert _linear_patch_residual(m2) < 1e-10


def test_multi_sweep_detects_2_irregular():
    """Marking a cell on the FINE side of a still-active interface must raise
    (deal.II auto-refines the coarse neighbor; we require the caller to)."""
    from mfmg_tpu.fem.adaptive import refine_mesh

    m1 = adaptive_cube(2, 2, _quadrant)
    slave = int(m1.hanging.slaves[0])
    a = int(m1.hanging.masters[0, 0])
    # a fine-side cell that touches the hanging interface: contains the slave
    touching = np.any(m1.cells == slave, axis=1)
    assert touching.any()
    marks = np.zeros(m1.n_cells, dtype=bool)
    marks[np.nonzero(touching)[0][0]] = True
    with pytest.raises(ValueError, match="2-irregular"):
        refine_mesh(m1, marks)


def test_multi_sweep_3d():
    """3D second sweep away from the interface keeps face + edge constraints
    and the basis stays conforming."""
    from mfmg_tpu.fem.adaptive import refine_mesh

    m1 = adaptive_cube(3, 1, _quadrant)          # 2x2x2, corner refined
    n1 = m1.hanging.n

    def far_corner(centers):
        return np.all(centers > 0.5, axis=1)

    m2 = refine_mesh(m1, far_corner)
    assert m2.hanging.n > n1
    assert int(np.sum(m2.hanging.n_masters == 4)) >= 3
    assert _linear_patch_residual(m2) < 1e-10
