"""Gather-free stencil operator for structured meshes.

On a structured Q_k grid the assembled Laplace operator is a (2k+1)^dim
stencil with variable coefficients:

    y[i] = sum_o C_o[i] * x[i + o]

so the SpMV becomes (2k+1)^dim shifted static slices and multiply-adds, one
elementwise XLA fusion that streams the coefficient planes once, with no
gather (the ELL path's per-entry column indices are never read).  It is the
analog of the reference's matrix-free FEEvaluation cell loop
(laplace_matrix_free.hpp:129-156) and of cuSPARSE csrmv on its device path.

The stencil values are extracted exactly from the assembled (Dirichlet-
eliminated) CSR matrix, so `StencilOperator @ x == A @ x` to roundoff.
"""

from __future__ import annotations

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from mfmg_tpu.fem.mesh import Mesh


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class StencilOperator:
    """coeffs: (n_offsets,) + grid_shape arrays; offsets static metadata.

    grid_shape is (n1_last, ..., n1_x) — C-order node grid (x fastest in the
    flat dof id).  offsets[o] is the per-axis shift in the same axis order.
    """

    coeffs: jax.Array
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    grid_shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def shape(self):
        n = int(np.prod(self.grid_shape))
        return (n, n)

    def __matmul__(self, x):
        return stencil_apply(self, x)


@jax.jit
def stencil_apply(op: StencilOperator, x: jax.Array) -> jax.Array:
    """y = sum_o C_o * shift(x, o), as one fused elementwise slice-sum.

    x is zero-padded once by the stencil radius; every shifted read is then a
    static full-shape slice, so the whole sum is a single XLA fusion with no
    scatter/dynamic-update semantics (an `.at[].add` formulation compiles to
    dozens of unfused kernels inside larger programs).  Out-of-domain reads
    hit the zero padding and the corresponding stencil coefficients are zero
    anyway (no such matrix entries exist).  Reduced-precision planes (bf16)
    are widened to x's dtype inside the fusion.
    """
    k = max(max(abs(o) for o in off) for off in op.offsets)
    xg = x.reshape(op.grid_shape)
    xp = jnp.pad(xg, k)
    terms = []
    for i, off in enumerate(op.offsets):
        sl = tuple(slice(k + o, k + o + n) for o, n in zip(off, op.grid_shape))
        terms.append(op.coeffs[i] * xp[sl])
    y = terms[0]
    for t in terms[1:]:
        y = y + t
    return y.reshape(x.shape)


def stencil_layout(mesh: Mesh):
    """Static scatter layout of the structured-mesh stencil extraction:
    (offsets [(z..x) shifts], oid_ab [(a,b)->offset plane], grid_shape,
    n_nodes).  Shared by the local and the distributed extraction paths."""
    k = mesh.degree
    nc = mesh.structured_shape
    dim = mesh.dim
    n1 = tuple(k * c + 1 for c in nc)          # nodes per dim, x first
    grid_shape = tuple(reversed(n1))           # C-order: (z, y, x)
    n_nodes = int(np.prod(n1))

    from mfmg_tpu.fem.reference import reference_element
    lm = reference_element(dim, k).local_multi_index     # (n_loc, dim) x first
    doff = lm[None, :, :] - lm[:, None, :]               # (a, b, dim) x first
    offsets = list(itertools.product(*[range(-k, k + 1)] * dim))  # (z,..,x)
    oid_ab = np.zeros(doff.shape[:2], dtype=np.int64)
    for d in range(dim - 1, -1, -1):           # (z,..,x) enumeration order
        oid_ab = oid_ab * (2 * k + 1) + (doff[:, :, d] + k)
    return offsets, oid_ab, grid_shape, n_nodes


def stencil_from_cell_matrices(mesh: Mesh, A_loc: np.ndarray,
                               constrained: np.ndarray, diag_raw: np.ndarray,
                               dtype=jnp.float32,
                               device: bool = True,
                               raw_planes: np.ndarray | None = None) -> StencilOperator:
    """Exact stencil extraction straight from the per-cell matrices — the
    global CSR is never assembled (the matrix-free setup path,
    dealii_matrix_free_hierarchy_helpers.cc:55-303 analog).

    On a uniform structured mesh the per-axis offset between two local nodes
    of a cell is fixed across cells, so entry (c, a, b) lands in stencil
    plane offset(lm[b]-lm[a]) at row node(c, a): one bincount scatters all
    cell matrices.  Dirichlet elimination is then applied in stencil form:
    constrained rows keep only the raw-diagonal center, and couplings INTO
    constrained columns are zeroed (matches ops.sparse.eliminate_dirichlet).

    device=False keeps the coefficient planes as host numpy (same dtype):
    setup consumers (nnz count, the deal.II CG eigenvalue estimate, coloring)
    all read the coefficients host-side, so the planes never make a
    device-to-host round trip.  Hierarchy pushes the operator to the device
    exactly once, when the level is finalized.
    """
    if getattr(mesh, "hanging", None) is not None:
        raise NotImplementedError(
            "stencil operators on hanging-node meshes are not supported "
            "yet; use the assembled path (Config.operator='ell') which "
            "condenses the constraints")
    if not mesh.is_structured or mesh.dof_renumbered:
        raise ValueError("stencil operator requires a structured mesh with "
                         "lexicographic dof numbering (use operator='ell' "
                         "after renumber_dofs)")
    k = mesh.degree
    offsets, oid_ab, grid_shape, n_nodes = stencil_layout(mesh)

    if raw_planes is not None:
        # distributed setup: planes already scattered per cell range and
        # sum-reduced across processes (parallel/dist_setup.py)
        coeffs = np.array(raw_planes, dtype=np.float64)
    else:
        rows = mesh.cells.astype(np.int64)               # (n_cells, n_loc)
        from mfmg_tpu import native
        coeffs = native.stencil_scatter(rows, oid_ab, A_loc, len(offsets),
                                        n_nodes)
        if coeffs is None:
            flat = oid_ab[None, :, :] * n_nodes + rows[:, :, None]
            coeffs = np.bincount(flat.reshape(-1), weights=A_loc.reshape(-1),
                                 minlength=len(offsets) * n_nodes)
            coeffs = coeffs.reshape(len(offsets), n_nodes)

    # Dirichlet elimination in stencil form
    con = constrained.reshape(grid_shape)
    kpad = k
    con_pad = np.pad(con, kpad, constant_values=False)
    center = len(offsets) // 2
    for i, off in enumerate(offsets):
        sl = tuple(slice(kpad + o, kpad + o + n) for o, n in zip(off, grid_shape))
        col_con = con_pad[sl].reshape(-1)                # target-col constrained?
        if i == center:
            coeffs[i] = np.where(constrained, diag_raw, coeffs[i])
        else:
            coeffs[i] = np.where(constrained | col_con, 0.0, coeffs[i])

    coeffs = coeffs.reshape((len(offsets),) + grid_shape)
    nonzero = [i for i in range(len(offsets)) if np.any(coeffs[i])]
    coeffs = coeffs[nonzero]
    offsets = tuple(offsets[i] for i in nonzero)
    coeffs = (jnp.asarray(coeffs, dtype=dtype) if device
              else coeffs.astype(jnp.dtype(dtype)))
    return StencilOperator(coeffs=coeffs, offsets=offsets,
                           grid_shape=grid_shape)


def stencil_to_device(op: StencilOperator) -> StencilOperator:
    """Push a host-built stencil operator's planes to the device (no-op if
    already there)."""
    if isinstance(op.coeffs, np.ndarray):
        op = StencilOperator(coeffs=jnp.asarray(op.coeffs),
                             offsets=op.offsets, grid_shape=op.grid_shape)
    return op


def stencil_from_csr(A: sp.spmatrix, mesh: Mesh, dtype=jnp.float32) -> StencilOperator:
    """Exact stencil extraction from an assembled matrix on a structured mesh."""
    if not mesh.is_structured:
        raise ValueError("stencil operator requires a structured mesh")
    k = mesh.degree
    nc = mesh.structured_shape
    dim = mesh.dim
    n1 = tuple(k * c + 1 for c in nc)          # nodes per dim, x first
    grid_shape = tuple(reversed(n1))           # C-order: (z, y, x)

    A = sp.coo_matrix(A)
    # decode per-axis offset of each entry from row/col multi-indices (x fastest)
    def multi(idx):
        out = []
        rem = idx.copy()
        for d in range(dim):
            out.append(rem % n1[d])
            rem = rem // n1[d]
        return np.stack(out, axis=-1)          # (..., dim) x first

    mr, mc = multi(A.row), multi(A.col)
    diff = mc - mr                             # per-axis offsets, x first
    if np.abs(diff).max() > k:
        raise ValueError("matrix has entries outside the (2k+1)^dim stencil")

    offsets = list(itertools.product(*[range(-k, k + 1)] * dim))  # (z,...,x) order
    # offset id from diff (x first -> reverse to match offsets tuple order)
    diff_rev = diff[:, ::-1]                   # (nnz, dim) in (z, y, x) order
    oid = np.zeros(len(A.data), dtype=np.int64)
    for d in range(dim):
        oid = oid * (2 * k + 1) + (diff_rev[:, d] + k)

    coeffs = np.zeros((len(offsets), int(np.prod(n1))))
    np.add.at(coeffs, (oid, A.row), A.data)
    coeffs = coeffs.reshape((len(offsets),) + grid_shape)

    # drop all-zero offset planes (corners of the stencil box absent in Q1 2D etc.)
    nonzero = [i for i in range(len(offsets)) if np.any(coeffs[i])]
    coeffs = coeffs[nonzero]
    offsets = tuple(offsets[i] for i in nonzero)
    return StencilOperator(coeffs=jnp.asarray(coeffs, dtype=dtype),
                           offsets=offsets, grid_shape=grid_shape)
