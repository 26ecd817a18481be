"""Gather-free restriction/prolongation for structured block agglomerates.

On a structured grid with uniform block agglomerates, the AMGe restriction is
a strided-window operation: coarse dof (agglomerate a, eigenvector e) reads
the fine grid window starting at a*s of width s+1 (windows overlap by one
node plane).  Both directions become static strided slices + small einsums —
no gathers, no scatters — the transfer-operator counterpart of the stencil
SpMV:

  restrict:  out[e, a] = sum_t W[e, t, a] * x[a*s + t]
  prolong:   y[a*s + t] += sum_e W[e, t, a] * xc[e, a]   (overlap-add)

The overlap-add is materialized scatter-free by accumulating, for every
within-block position t < s, the contributions of the 2^dim neighboring
window corners, then a transpose+reshape writes the whole grid at once.
"""

from __future__ import annotations

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class StructuredTransfer:
    """W: (n_ev,) + window_shape + agg_shape weights (C-order, z..x axes).

    window_shape = s+1 per axis; agg_shape = blocks per axis;
    grid_shape = s*agg+1 per axis (the fine node grid).
    Coarse vector layout: flat index = e + n_ev*(ax + nax*(ay + nay*az))
    i.e. a C-order (az, ay, ax, e) array — matching the CSR restriction's
    (agglomerate, eigenvector) row order with x-fastest agglomerate ids.
    """

    W: jax.Array
    window_shape: tuple = dataclasses.field(metadata=dict(static=True))
    agg_shape: tuple = dataclasses.field(metadata=dict(static=True))
    grid_shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def n_ev(self):
        return self.W.shape[0]

    @property
    def shape(self):
        return (self.n_ev * int(np.prod(self.agg_shape)), int(np.prod(self.grid_shape)))

    def restrict(self, x):
        return structured_restrict(self, x)

    def prolong(self, xc):
        return structured_prolong(self, xc)


def _selection_matrix(naa: int, w: int, s: int, g: int) -> np.ndarray:
    """((a, t) -> grid) window-selection operator: S[a*w + t, a*s + t] = 1."""
    S = np.zeros((naa * w, g), dtype=np.float64)
    a = np.repeat(np.arange(naa), w)
    t = np.tile(np.arange(w), naa)
    S[a * w + t, a * s + t] = 1.0
    return S


def _sel_mats(tr: StructuredTransfer, dtype):
    s = tuple(w - 1 for w in tr.window_shape)
    return [jnp.asarray(_selection_matrix(tr.agg_shape[d], tr.window_shape[d],
                                          s[d], tr.grid_shape[d]), dtype=dtype)
            for d in range(len(tr.agg_shape))]


# The selection matmuls run at Precision.DEFAULT: on a GPU a float32 product
# then runs in TF32 (about three decimal digits), and on the CPU it is exact
# float32.  The transfers live inside the PRECONDITIONER (the outer Krylov
# residual uses the exact operator), so the reduced precision perturbs only
# the preconditioner; TF32 also makes restrict/prolong no longer exact
# adjoints (a mildly nonsymmetric preconditioner).  MFMG_TRANSFER_HI=1 forces
# exact float32 (Precision.HIGHEST).
#
# The env var is read at TRACE time (each call below), not import time, so
# setting it programmatically before building/applying a hierarchy in the
# same process works; already-compiled executables keep the precision they
# were traced with (jit caches are keyed on shapes, not env vars).
import os as _os


def _prec():
    return (jax.lax.Precision.HIGHEST if _os.environ.get("MFMG_TRANSFER_HI")
            else jax.lax.Precision.DEFAULT)


@jax.jit
def structured_restrict(tr: StructuredTransfer, x: jax.Array) -> jax.Array:
    """Windowed contraction as a chain of per-axis SELECTION MATMULS:
    the overlapped 5^3-stride-4 windows are materialized by multiplying each
    grid axis with a ((a,t) x grid) 0/1 operator — three matmuls — then one
    fused mul-reduce against the per-agglomerate weights.  No gathers and no
    blocked-reshape concatenations."""
    _HI = _prec()
    dim = len(tr.agg_shape)
    na, win = tr.agg_shape, tr.window_shape
    t = x.reshape(tr.grid_shape)
    for d, S in enumerate(_sel_mats(tr, x.dtype)):
        t = jnp.moveaxis(jnp.tensordot(S, t, axes=((1,), (d,)),
                                       precision=_HI), 0, d)
    shape = []
    for d in range(dim):
        shape += [na[d], win[d]]
    xw = t.reshape(shape)                         # (u, i, v, j, [w, k])
    lt = ["i", "j", "k"][:dim]
    lb = ["u", "v", "w"][:dim]
    spec = ("e" + "".join(lt) + "".join(lb) + ","
            + "".join(lb[d] + lt[d] for d in range(dim))
            + "->" + "".join(lb) + "e")
    out = jnp.einsum(spec, tr.W, xw, precision=_HI)
    return out.reshape(-1)


@jax.jit
def structured_prolong(tr: StructuredTransfer, xc: jax.Array) -> jax.Array:
    """Exact linear transpose of structured_restrict, written directly as the
    reverse chain (weights contraction, then per-axis transposed-selection
    matmuls — overlap-add happens inside the S^T matmul)."""
    _HI = _prec()
    dim = len(tr.agg_shape)
    na, win = tr.agg_shape, tr.window_shape
    xcg = xc.reshape(na + (tr.n_ev,))
    lt = ["i", "j", "k"][:dim]
    lb = ["u", "v", "w"][:dim]
    spec = ("e" + "".join(lt) + "".join(lb) + ","
            + "".join(lb) + "e->"
            + "".join(lb[d] + lt[d] for d in range(dim)))
    C = jnp.einsum(spec, tr.W, xcg, precision=_HI)
    shape = tuple(na[d] * win[d] for d in range(dim))
    t = C.reshape(shape)
    for d, S in enumerate(_sel_mats(tr, xc.dtype)):
        t = jnp.moveaxis(jnp.tensordot(S, t, axes=((0,), (d,)),
                                       precision=_HI), 0, d)
    return t.reshape(-1)


# Dense-transfer size cap: below this many entries (64 MB f32) the
# coarse-level transfer is stored as a dense matrix and applied as one
# matvec; above it the windowed form keeps memory O(window * out_grid).
DENSE_TRANSFER_MAX_ELEMS = 16_000_000


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GeneralWindowTransfer:
    """Windowed transfer between two structured block grids with components.

    Used for AMGe levels >= 1, where restriction rows couple a super-block to
    the member + ring blocks of the previous level: window offsets t in
    [t0, t0+w) per axis with stride s (w > s+1 allowed, unlike the fine-level
    StructuredTransfer).  Restriction is the fine level's design: per-axis
    window-selection matmuls, then one contraction with the weights;
    prolongation is derived mechanically as its linear transpose (matmuls
    with the transposed selections).  When the operator is small
    (DENSE_TRANSFER_MAX_ELEMS) a dense copy Rd is stored instead and both
    directions are single matvecs.

    W : (n_out,) + window_shape + (n_in,) + out_grid   weights
    """

    W: jax.Array
    window_shape: tuple = dataclasses.field(metadata=dict(static=True))
    t0: tuple = dataclasses.field(metadata=dict(static=True))
    stride: tuple = dataclasses.field(metadata=dict(static=True))
    in_grid: tuple = dataclasses.field(metadata=dict(static=True))
    out_grid: tuple = dataclasses.field(metadata=dict(static=True))
    n_in: int = dataclasses.field(metadata=dict(static=True))
    n_out: int = dataclasses.field(metadata=dict(static=True))
    Rd: object = None                    # dense (n_out_total, n_in_total)

    def restrict(self, x):
        if self.Rd is not None:
            return _dense_restrict(self.Rd, x)
        return _gwt_restrict(self, x)

    def prolong(self, xc):
        if self.Rd is not None:
            return _dense_prolong(self.Rd, xc)
        dim = len(self.in_grid)
        n = int(np.prod(self.in_grid)) * self.n_in
        f = jax.linear_transpose(
            lambda v: _gwt_restrict(self, v),
            jax.ShapeDtypeStruct((n,), self.W.dtype))
        (y,) = f(xc)
        return y


@jax.jit
def _dense_restrict(Rd, x):
    return Rd @ x


@jax.jit
def _dense_prolong(Rd, xc):
    return xc @ Rd


def _gwt_sel_mats(tr: GeneralWindowTransfer, dtype):
    """Per-axis ((S, t) -> input position) 0/1 operators:
    Sel_d[S*w + t, S*stride + t0 + t] = 1 where that position is inside the
    input grid (positions outside it read zero)."""
    mats = []
    for d in range(len(tr.in_grid)):
        w, o, g = tr.window_shape[d], tr.out_grid[d], tr.in_grid[d]
        S = np.repeat(np.arange(o), w)
        t = np.tile(np.arange(w), o)
        pos = S * tr.stride[d] + tr.t0[d] + t
        ok = (pos >= 0) & (pos < g)
        M = np.zeros((o * w, g))
        M[(S * w + t)[ok], pos[ok]] = 1.0
        mats.append(jnp.asarray(M, dtype=dtype))
    return mats


@jax.jit
def _gwt_restrict(tr: GeneralWindowTransfer, x: jax.Array) -> jax.Array:
    """Windows by per-axis selection matmuls, then one contraction with W.
    (A strided-patches convolution did the same in one op, but its linear
    transpose — the prolongation — measured 6.2 ms per call on an H100 at
    the 2.1M-dof hierarchy's L1->L2 transfer, and seconds on XLA:CPU.)"""
    prec = _prec()
    dim = len(tr.in_grid)
    t = x.reshape(tr.in_grid + (tr.n_in,))
    for d, S in enumerate(_gwt_sel_mats(tr, x.dtype)):
        t = jnp.moveaxis(jnp.tensordot(S, t, axes=((1,), (d,)),
                                       precision=prec), 0, d)
    shape = []
    for d in range(dim):
        shape += [tr.out_grid[d], tr.window_shape[d]]
    xw = t.reshape(tuple(shape) + (tr.n_in,))     # (u, i, v, j, [w, k], f)
    lt = ["i", "j", "k"][:dim]
    lb = ["u", "v", "w"][:dim]
    spec = ("e" + "".join(lt) + "f" + "".join(lb) + ","
            + "".join(lb[d] + lt[d] for d in range(dim)) + "f"
            + "->" + "".join(lb) + "e")
    out = jnp.einsum(spec, tr.W, xw, precision=prec)
    return out.reshape(-1)


def general_window_transfer_from_csr(R_l, in_grid, n_in, out_grid, n_out,
                                     stride, dtype=jnp.float32,
                                     max_halo: int = 1):
    """Build a GeneralWindowTransfer from a CSR level-l restriction.

    Decodes every entry: row -> (super S, e_out), col -> (block B, e_in),
    t = B - S*stride (must lie in [-max_halo, stride + max_halo)); returns
    None when the sparsity doesn't fit the window (unstructured levels)."""
    import scipy.sparse as sp

    dim = len(in_grid)
    A = sp.coo_matrix(R_l)
    dims_in_xyz = tuple(reversed(in_grid))
    dims_out_xyz = tuple(reversed(out_grid))
    if A.shape != (int(np.prod(out_grid)) * n_out, int(np.prod(in_grid)) * n_in):
        return None

    def decode(idx, n_comp, dims_xyz):
        e = idx % n_comp
        g = idx // n_comp
        mi = []
        rem = g.copy()
        for d in range(dim):
            mi.append(rem % dims_xyz[d])
            rem //= dims_xyz[d]
        return e, np.stack(mi, axis=-1)      # x-first coords

    e_out, S = decode(A.row, n_out, dims_out_xyz)
    e_in, B = decode(A.col, n_in, dims_in_xyz)
    stride_xyz = tuple(reversed(stride))
    t = B - S * np.array(stride_xyz)
    t0_xyz = tuple(-max_halo for _ in range(dim))
    w_xyz = tuple(stride_xyz[d] + 2 * max_halo for d in range(dim))
    if np.any(t < np.array(t0_xyz)) or np.any(t >= np.array(t0_xyz) + np.array(w_xyz)):
        return None

    # W in (e_out, tz, ty, tx, e_in, out-grid C-order) layout
    window_shape = tuple(reversed(w_xyz))
    t_rev = (t - np.array(t0_xyz))[:, ::-1]            # z..x window index
    out_flat = (S * np.cumprod((1,) + dims_out_xyz[:-1])).sum(axis=1)
    W = np.zeros((n_out,) + window_shape + (n_in, int(np.prod(out_grid))))
    tidx = tuple(t_rev[:, d] for d in range(dim))
    np.add.at(W, (e_out,) + tidx + (e_in, out_flat), A.data)
    W = W.reshape((n_out,) + window_shape + (n_in,) + out_grid)
    Rd = None
    if R_l.shape[0] * R_l.shape[1] <= DENSE_TRANSFER_MAX_ELEMS:
        Rd = jnp.asarray(np.asarray(sp.csr_matrix(R_l).todense()), dtype=dtype)
    return GeneralWindowTransfer(
        W=jnp.asarray(W, dtype=dtype), window_shape=window_shape,
        t0=tuple(reversed(t0_xyz)), stride=tuple(reversed(stride_xyz)),
        in_grid=in_grid, out_grid=out_grid, n_in=n_in, n_out=n_out, Rd=Rd)


def structured_transfer_from_batch(mesh, batch, evecs, global_diag,
                                   dtype=jnp.float32):
    """Build the windowed-weight transfer from the structured agglomerate
    batch (same math as amge.restriction.build_restriction: W = PoU weight
    times eigenvector)."""
    if not mesh.is_structured:
        return None
    dim, k = mesh.dim, mesh.degree
    nc = np.asarray(mesh.structured_shape)
    n_agg, m, n_ev = evecs.shape
    if not np.all(batch.valid):
        return None                        # uniform blocks only
    # infer block dims from window size: m = prod(b*k+1)
    # agg grid dims from count; block dims from first agglomerate's dof extent
    mi = mesh.cell_multi_index()
    sel = np.nonzero(batch.dof_map[0] >= 0)[0]
    # use the dof_map extents along each axis
    n1 = nc * k + 1
    dof0 = batch.dof_map[0]
    mx = []
    rem = dof0.copy()
    coords = []
    for d in range(dim):
        coords.append(rem % n1[d])
        rem = rem // n1[d]
    coords = np.stack(coords, axis=-1)
    wdims = coords.max(axis=0) - coords.min(axis=0) + 1   # window per axis, x first
    if int(np.prod(wdims)) != m:
        return None
    strides = wdims - 1
    if np.any(strides < 1) or np.any((n1 - 1) % strides):
        return None
    na = (n1 - 1) // strides                              # aggs per axis, x first
    if int(np.prod(na)) != n_agg:
        return None

    w = batch.diag / global_diag[batch.dof_map]
    Wfull = w[:, :, None] * evecs                         # (n_agg, m, n_ev)
    # reorder: n_agg (x fastest) -> (az, ay, ax); m (x fastest) -> (tz, ty, tx)
    Wfull = Wfull.reshape(tuple(na[::-1]) + tuple(wdims[::-1]) + (n_ev,))
    # current axes: (az, ay, ax, tz, ty, tx, e) -> (e, tz, ty, tx, az, ay, ax)
    Wfull = np.moveaxis(Wfull, -1, 0)
    Wfull = np.moveaxis(Wfull, list(range(1 + dim, 1 + 2 * dim)), list(range(1, 1 + dim)))
    return StructuredTransfer(W=jnp.asarray(Wfull, dtype=dtype),
                              window_shape=tuple(int(v) for v in wdims[::-1]),
                              agg_shape=tuple(int(v) for v in na[::-1]),
                              grid_shape=tuple(int(v) for v in n1[::-1]))
