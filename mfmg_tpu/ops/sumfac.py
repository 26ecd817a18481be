"""Sum-factorized Q_k matrix-free operator apply.

High-order path for the reference's matrix-free operator
(tests/laplace_matrix_free.hpp:129-156; hierarchy_driver.cc template-dispatches
fe_degree 1..10).  The quadrature-mode apply in ops/local_apply.py contracts
through a per-cell table G[c,q,d,i] of size n_q*dim*n_loc = O((k+1)^{2dim});
this module factors the tensor-product structure of Q_k instead:

  reference gradient   t_a = (D_1d on axis a, V_1d elsewhere) u        [dim^2
  metric contraction   s_a = K[c,q,a,b] t_b                             small
  integration          y  += (D_1d^T on axis a, V_1d^T elsewhere) s_a   matmuls]

Per-cell data shrinks from O((k+1)^{2dim}) to the (n_q, dim, dim) metric K
(deal.II MappingInfo compression, see fem/geometry.py compute_metric), and
FLOPs from O((k+1)^{2dim}) to O(dim^2 (k+1)^{dim+1}).  Every contraction is a
large batched matmul over all cells, the shape XLA hands to its matmul
kernels; the loop structure of FEEvaluation becomes 3 einsum chains.

Local dof and quadrature orderings are the reference element's x-fastest
lexicographic flatten (fem/reference.py), so index i reshapes to tensor axes
(..., i_z, i_y, i_x) in C order with no permutation.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SumFactoredOperator:
    """Jittable pytree for the sum-factorized variable-coefficient apply.

    cells : (n_cells, n_loc) int32 global dof ids, x-fastest local order
    constrained : (n_dofs,) bool Dirichlet mask
    diag : (n_dofs,) raw matrix diagonal (identity-row scaling at constraints)
    op_diag : (n_dofs,) full operator diagonal (for Jacobi/Chebyshev), host-
        precomputed — probing is never needed (cf. laplace_matrix_free.hpp:158)
    K : (n_cells, n_q, dim, dim) metric tensor (JxW * coeff * Jinv Jinv^T)
    V, D : (n_q_1d, k+1) 1D shape value / derivative tables
    """

    cells: jax.Array
    constrained: jax.Array
    diag: jax.Array
    op_diag: jax.Array
    K: jax.Array
    V: jax.Array
    D: jax.Array

    @property
    def shape(self):
        n = self.diag.shape[0]
        return (n, n)

    def __matmul__(self, u):
        return sumfac_apply(self, u)


def _contract_axis(w: jax.Array, M: jax.Array, spatial_axis: int, dim: int):
    """Contract 1D operator M (out, in) along spatial axis d of w.

    w has shape (n_cells, a_{dim-1}, ..., a_0) — spatial axis d lives at
    tensor position dim - d (x is last)."""
    ax = dim - spatial_axis
    w = jnp.moveaxis(w, ax, -1)
    w = jnp.einsum("...i,oi->...o", w, M)
    return jnp.moveaxis(w, -1, ax)


@jax.jit
def sumfac_apply(op: SumFactoredOperator, u: jax.Array) -> jax.Array:
    dim = op.K.shape[-1]
    n_cells, n_loc = op.cells.shape
    n1 = op.V.shape[1]
    nq1 = op.V.shape[0]
    n_q = op.K.shape[1]

    uz = jnp.where(op.constrained, 0.0, u)
    w0 = uz[op.cells].reshape((n_cells,) + (n1,) * dim)

    # forward: reference-space gradients at quadrature points, sharing the
    # pure-interpolation prefixes across gradient directions
    t = []
    for a in range(dim):
        w = w0
        for d in range(dim):
            w = _contract_axis(w, op.D if d == a else op.V, d, dim)
        t.append(w.reshape(n_cells, n_q))
    t = jnp.stack(t, axis=-1)                          # (c, q, dim)

    s = jnp.einsum("cqab,cqb->cqa", op.K, t)           # metric contraction

    # backward: integrate with transposed 1D operators
    y_loc = jnp.zeros((n_cells,) + (n1,) * dim, dtype=u.dtype)
    for a in range(dim):
        w = s[..., a].reshape((n_cells,) + (nq1,) * dim)
        for d in range(dim):
            M = op.D if d == a else op.V
            w = _contract_axis(w, M.T, d, dim)
        y_loc = y_loc + w

    y = jnp.zeros_like(u).at[op.cells.reshape(-1)].add(
        y_loc.reshape(n_cells * n_loc))
    return jnp.where(op.constrained, op.diag * u, y)


def sumfac_diagonal(op: SumFactoredOperator) -> jax.Array:
    """Operator diagonal — precomputed at setup (see laplace.py), returned
    as stored; keeps the operator_diagonal dispatch uniform."""
    return op.op_diag


def build_sumfac_operator(mesh, coeff_at_q: np.ndarray, diag_raw: np.ndarray,
                          A_loc: np.ndarray, dtype=jnp.float32) -> SumFactoredOperator:
    """Assemble the pytree from host setup data.

    A_loc is only used for the operator diagonal (one scatter-add at setup);
    the device never sees the O(n_loc^2) cell matrices.
    """
    from mfmg_tpu.fem.geometry import compute_metric
    from mfmg_tpu.fem.reference import reference_element

    ref = reference_element(mesh.dim, mesh.degree)
    K = compute_metric(mesh, coeff_at_q)
    d_loc = np.einsum("cii->ci", A_loc)
    op_diag = np.zeros(mesh.n_nodes)
    np.add.at(op_diag, mesh.cells.reshape(-1), d_loc.reshape(-1))
    op_diag = np.where(mesh.boundary_dofs, diag_raw, op_diag)
    return SumFactoredOperator(
        cells=jnp.asarray(mesh.cells, dtype=jnp.int32),
        constrained=jnp.asarray(mesh.boundary_dofs),
        diag=jnp.asarray(diag_raw, dtype=dtype),
        op_diag=jnp.asarray(op_diag, dtype=dtype),
        K=jnp.asarray(K, dtype=dtype),
        V=jnp.asarray(ref.v1d, dtype=dtype),
        D=jnp.asarray(ref.g1d, dtype=dtype),
    )
