"""Matrix-free operator apply: gather -> batched element matmul -> scatter-add.

Batched replacement for deal.II MatrixFree::cell_loop + FEEvaluation
(reference tests/laplace_matrix_free.hpp:129-156) and for
DealIIMatrixFreeOperator::vmult / CudaMatrixFreeOperator::vmult.  Instead of a
threaded loop over SIMD cell batches, ALL cells are processed as one batched
contraction; ghost/constraint handling is a masked elementwise
pass.

Two compute modes:
  * "local_matrix": per-cell stiffness matrices A_loc[c,i,j] are precomputed at
    setup; apply is a single (n_cells, n_loc)x(n_loc,n_loc) batched matmul.
    Cheapest for low order (Q1/Q2).
  * "quadrature": contracts through quadrature-point gradients
    t[c,q,d] = G[c,q,d,j] u[c,j]; y[c,i] = G[c,q,d,i] (JxW*coeff*t).  Uses
    O(n_loc * n_q * dim) memory per cell instead of O(n_loc^2); the high-order
    path (mirrors FEEvaluation evaluate/integrate-gradients).

Dirichlet dofs are treated as identity rows scaled by the raw diagonal
(consistent with ops.sparse.eliminate_dirichlet), so matrix-free and assembled
applies agree to roundoff — the reference asserts exactly this equivalence at
1e-9 (tests/test_hierarchy.cc:647-695).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MatrixFreeOperator:
    """Jittable pytree holding the matrix-free apply data for one mesh.

    cells : (n_cells, n_loc) int32
    A_loc : (n_cells, n_loc, n_loc) or None  (local_matrix mode)
    G     : (n_cells, n_q, dim, n_loc) or None (quadrature mode)
    scale : (n_cells, n_q) JxW*coeff or None (quadrature mode)
    constrained : (n_dofs,) bool mask of Dirichlet dofs
    diag : (n_dofs,) matrix diagonal (raw values at constrained dofs)

    Hanging-node meshes (the reference applies these through deal.II
    MatrixFree + AffineConstraints, tests/laplace.hpp:126-141): the optional
    hc_* fields carry the constraints u[slave] = sum_m w * u[master], and the
    apply becomes the condensed C^T A C cell-wise — distribute into slaves,
    raw cell apply, collect slave rows into masters — matching the assembled
    condensed matrix to roundoff.
      hc_slaves  : (n_h,) int32
      hc_masters : (n_h, m_max) int32, zero-padded
      hc_weights : (n_h, m_max), zero-padded
      diag_all   : (n_dofs,) full diagonal of the CONDENSED eliminated
                   operator (master rows pick up w A w corrections)
    """

    cells: jax.Array
    constrained: jax.Array
    diag: jax.Array
    A_loc: jax.Array | None = None
    G: jax.Array | None = None
    scale: jax.Array | None = None
    hc_slaves: jax.Array | None = None
    hc_masters: jax.Array | None = None
    hc_weights: jax.Array | None = None
    diag_all: jax.Array | None = None

    @property
    def shape(self):
        n = self.diag.shape[0]
        return (n, n)

    def __matmul__(self, u):
        return mf_apply(self, u)


@jax.jit
def mf_apply(op: MatrixFreeOperator, u: jax.Array) -> jax.Array:
    uz = jnp.where(op.constrained, 0.0, u)
    if op.hc_slaves is not None:
        # C x: interpolate slaves from (already Dirichlet-zeroed) masters
        interp = jnp.einsum("hm,hm->h", op.hc_weights, uz[op.hc_masters])
        uz = uz.at[op.hc_slaves].set(interp)
    u_loc = uz[op.cells]                                    # (c, nl)
    if op.A_loc is not None:
        y_loc = jnp.einsum("cij,cj->ci", op.A_loc, u_loc)
    else:
        t = jnp.einsum("cqdj,cj->cqd", op.G, u_loc)
        t = t * op.scale[..., None]
        y_loc = jnp.einsum("cqdi,cqd->ci", op.G, t)
    y = jnp.zeros_like(u).at[op.cells.reshape(-1)].add(y_loc.reshape(-1))
    if op.hc_slaves is not None:
        # C^T y: collect slave-row contributions into masters, then identity
        # rows (raw diag at slaves, condensed diag at Dirichlet dofs)
        ys = y[op.hc_slaves]
        y = y.at[op.hc_masters.reshape(-1)].add(
            (op.hc_weights * ys[:, None]).reshape(-1))
        y = y.at[op.hc_slaves].set(op.diag[op.hc_slaves] * u[op.hc_slaves])
        return jnp.where(op.constrained, op.diag_all * u, y)
    return jnp.where(op.constrained, op.diag * u, y)


@jax.jit
def mf_diagonal(op: MatrixFreeOperator) -> jax.Array:
    """Extract the operator diagonal without unit-vector probing.

    The reference probes with unit vectors per local dof
    (laplace_matrix_free.hpp:158-199); with batched local data the diagonal is
    just a scatter-add of the local matrix diagonals.
    """
    if op.diag_all is not None:
        return op.diag_all            # hanging meshes: condensed diagonal
    if op.A_loc is not None:
        d_loc = jnp.einsum("cii->ci", op.A_loc)
    else:
        d_loc = jnp.einsum("cqdi,cq,cqdi->ci", op.G, op.scale, op.G)
    n = op.diag.shape[0]
    d = jnp.zeros((n,), dtype=d_loc.dtype).at[op.cells.reshape(-1)].add(d_loc.reshape(-1))
    return jnp.where(op.constrained, op.diag, d)
