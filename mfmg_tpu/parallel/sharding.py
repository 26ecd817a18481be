"""Multi-chip distribution of the hierarchy via jax.sharding.

Replacement for the reference's MPI domain decomposition
(reference §2.4: Epetra row maps + ghosted vectors; the CUDA path all-gathers
the whole source vector per SpMV, sparse_matrix_device.templates.cuh:104-138).

Design: one 1-D device mesh axis "x" shards the DoF-row dimension of every
fine-level object — ELL rows, matrix-free cell batches, and vectors — while
the small coarse-level objects are replicated.  Row dimensions are padded to a
multiple of the mesh size (padded ELL rows are all-zero, padded matrix-free
cells scatter zeros into dof 0), so every shard is identical in shape — the
analog of Epetra's balanced row maps.  The V-cycle is the SAME jitted
function as single-chip; GSPMD partitions it and inserts the collectives
(all-gathers for off-shard column reads, psums for scatter-adds), reproducing
the reference CUDA backend's gather-SpMV pattern.  The optimized
structured path (ppermute halo exchange overlapped with interior compute,
modeled on the reference's AMGX one-ring maps) lives in parallel/stencil.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()[: (n_devices or len(jax.devices()))]
    return Mesh(np.array(devices), axis_names=("x",))


def padded_size(n: int, mesh: Mesh) -> int:
    k = mesh.devices.size
    return ((n + k - 1) // k) * k


def _pad_rows(arr, n_pad: int, fill=0):
    n = arr.shape[0]
    if n == n_pad:
        return arr
    pad_width = [(0, n_pad - n)] + [(0, 0)] * (arr.ndim - 1)
    return jnp.pad(arr, pad_width, constant_values=fill)


def shard_vector(mesh: Mesh, v, n_pad: int | None = None):
    """Pad a fine-level vector to the sharded size and place it row-sharded
    (over ALL mesh axes — a (host, device) 2-axis mesh shards rows over the
    flattened device grid)."""
    v = jnp.asarray(v)
    n_pad = n_pad or padded_size(v.shape[0], mesh)
    return jax.device_put(_pad_rows(v, n_pad),
                          NamedSharding(mesh, P(mesh.axis_names)))


def unpad_vector(v, n: int):
    return v[:n]


def _row_shard(mesh: Mesh, arr, n_pad: int, fill=0):
    arr = _pad_rows(jnp.asarray(arr), n_pad, fill)
    spec = P(*((mesh.axis_names,) + (None,) * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def _replicate(mesh: Mesh, tree):
    return jax.device_put(tree, NamedSharding(mesh, P()))


def shard_hierarchy(levels, mesh: Mesh):
    """Return levels with fine-level row dimensions padded + sharded over x.

    Fine level: operator rows, smoother diagonals and prolongation rows are
    sharded; the restriction R (coarse rows, small) and all coarse levels are
    replicated — the analog of the reference gathering the coarse problem to
    one rank for the direct solve (cuda_solver.cu lu_dense path).

    Padded smoother diagonals get inv_diag=0 so padded dofs never move;
    padded MF cells are all-zero and scatter nothing.
    """
    from mfmg_tpu.amge.hierarchy import LevelData
    from mfmg_tpu.ops.local_apply import MatrixFreeOperator
    from mfmg_tpu.ops.sparse import ELLMatrix
    from mfmg_tpu.solve.smoothers import ChebyshevSmoother, JacobiSmoother

    fine_n = levels[0].op.shape[0]
    n_pad = padded_size(fine_n, mesh)

    out = []
    for i, lvl in enumerate(levels):
        if i == 0:
            op = lvl.op
            if isinstance(op, ELLMatrix):
                op = ELLMatrix(vals=_row_shard(mesh, op.vals, n_pad),
                               cols=_row_shard(mesh, op.cols, n_pad),
                               n_cols=op.n_cols)
            elif isinstance(op, MatrixFreeOperator):
                n_cells_pad = padded_size(op.cells.shape[0], mesh)
                op = MatrixFreeOperator(
                    cells=_row_shard(mesh, op.cells, n_cells_pad),
                    constrained=shard_vector(mesh, op.constrained, n_pad),
                    diag=shard_vector(mesh, op.diag, n_pad),
                    A_loc=None if op.A_loc is None else _row_shard(mesh, op.A_loc, n_cells_pad),
                    G=None if op.G is None else _row_shard(mesh, op.G, n_cells_pad),
                    scale=None if op.scale is None else _row_shard(mesh, op.scale, n_cells_pad),
                )
            sm = lvl.smoother
            if isinstance(sm, JacobiSmoother):
                sm = JacobiSmoother(inv_diag=shard_vector(mesh, sm.inv_diag, n_pad),
                                    omega=sm.omega)
            elif isinstance(sm, ChebyshevSmoother):
                sm = ChebyshevSmoother(inv_diag=shard_vector(mesh, sm.inv_diag, n_pad),
                                       theta=_replicate(mesh, sm.theta),
                                       delta=_replicate(mesh, sm.delta), degree=sm.degree)
            R = None if lvl.R is None else _replicate(mesh, lvl.R)
            RT = lvl.RT
            if RT is not None:
                RT = ELLMatrix(vals=_row_shard(mesh, RT.vals, n_pad),
                               cols=_row_shard(mesh, RT.cols, n_pad),
                               n_cols=RT.n_cols)
            out.append(LevelData(op=op, smoother=sm, R=R, RT=RT, coarse=lvl.coarse))
        else:
            out.append(_replicate(mesh, lvl))
    return out
