"""SPMD stencil V-cycle: slab/pencil decomposition + ppermute halo exchange.

The analog of the reference's MPI domain decomposition with ghost
exchange (reference §2.4).  Where the reference CUDA path all-gathers the
whole source vector per SpMV (sparse_matrix_device.templates.cuh:104-138) and
its AMGX path builds one-ring halo maps (cuda_solver.cu:264-443), here the
structured node grid is sharded over a 1-D ("x") or 2-D ("x","y") device
mesh — z-slabs, or (z,y) pencils past the slab surface-to-volume wall at
high device counts — and each stencil apply exchanges exactly the k boundary
planes with its neighbors via `lax.ppermute`, per sharded axis in sequence
(the second exchange carries the first axis's halo along, which covers the
corner/edge exchanges).  The one-ring pattern, which XLA can overlap with
interior compute.

Layout: every sharded axis is padded to P_d * ceil(.) agglomerate windows of
s_d planes each (padded planes carry zero stencil coefficients and zero
restriction weights, so padded dofs remain exactly zero and contribute
nothing), giving every device an identical window-aligned block.  The coarse
problem is replicated (all-gather of the small coarse residual), matching the
reference's gathered direct coarse solves.  Prolongation is generated as the
exact linear transpose of the sharded restriction (jax.linear_transpose), so
XLA emits the reversed ppermute/scatter pattern automatically.
"""

from __future__ import annotations

import dataclasses
import itertools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mfmg_tpu.ops.stencil import StencilOperator
from mfmg_tpu.ops.structured_transfer import StructuredTransfer

try:
    from jax import shard_map as _shard_map
except ImportError:                         # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map


@dataclasses.dataclass
class SpmdVcycle:
    """Jitted V-cycle over slab/pencil-sharded grid vectors."""

    mesh: Mesh
    grid_shape: tuple              # padded (gz_pad, [gy_pad,] ..., nx)
    orig_grid: tuple
    fn: object                     # (b_grid, x_grid) -> x_grid (jitted)

    def to_grid(self, v_flat):
        g = np.zeros(self.grid_shape, dtype=np.asarray(v_flat).dtype)
        g[tuple(slice(0, o) for o in self.orig_grid)] = (
            np.asarray(v_flat).reshape(self.orig_grid))
        spec = P(*self.mesh.axis_names)
        return jax.device_put(jnp.asarray(g), NamedSharding(self.mesh, spec))

    def from_grid(self, g):
        return np.asarray(g)[tuple(slice(0, o) for o in self.orig_grid)].reshape(-1)


def build_spmd_vcycle(hier, n_devices: int | None = None, devices=None,
                      mesh_shape: tuple | None = None) -> SpmdVcycle:
    """Build the sharded V-cycle from a stencil-path Hierarchy
    (Config(operator="stencil"), dense direct coarse solver).

    mesh_shape: (P,) for z-slabs (default), (Pz, Py) for a 2-D pencil
    decomposition of the grid (VERDICT round-2 item #9: slabs hit the
    surface-to-volume wall at high device counts)."""
    from mfmg_tpu.solve.coarse import DirectCoarseSolver
    from mfmg_tpu.solve.smoothers import ChebyshevSmoother, JacobiSmoother

    lvl0 = hier.levels[0]
    if not isinstance(lvl0.op, StencilOperator) or lvl0.transfer is None:
        raise ValueError("SPMD V-cycle needs the stencil operator + structured transfer")
    if not isinstance(hier.levels[-1].coarse, DirectCoarseSolver):
        raise ValueError("SPMD V-cycle needs the direct coarse solver")

    if devices is None:
        devices = jax.devices()[: (n_devices or len(jax.devices()))]
    devices = np.asarray(devices)
    if mesh_shape is None:
        mesh_shape = (devices.size,)
    n_shard = len(mesh_shape)
    op: StencilOperator = lvl0.op
    tr: StructuredTransfer = lvl0.transfer
    sm = lvl0.smoother
    dim = len(op.grid_shape)
    if dim not in (2, 3):
        raise ValueError("SPMD V-cycle supports 2D and 3D grids")
    if not (1 <= n_shard <= 2) or n_shard >= dim:
        raise ValueError(f"mesh_shape {mesh_shape} must shard 1..min(2, dim-1) axes")
    if int(np.prod(mesh_shape)) != devices.size:
        raise ValueError("mesh_shape does not match the device count")

    names = ("x", "y")[:n_shard]
    mesh = Mesh(devices.reshape(mesh_shape), axis_names=names)
    Pd = tuple(int(p) for p in mesh_shape)

    # levels >= 1 run replicated per device (they are tiny relative to the
    # fine grid: one agglomerate-grid dof per s^dim fine nodes); only the
    # 2-level case reduces to the bare inverse matvec.
    levels_rest = tuple(hier.levels[1:])
    dtype = tr.W.dtype                 # vector dtype (the planes may be bf16)

    rest_grid = op.grid_shape[n_shard:]
    rest_agg = tr.agg_shape[n_shard:]
    k = max(max(abs(o) for o in off) for off in op.offsets)
    strides = tuple(w - 1 for w in tr.window_shape)
    n_ev = tr.n_ev

    # window-aligned padded layout per sharded axis (see module docstring)
    na_pad, g_pad, na_loc, n_loc_ax = [], [], [], []
    for d in range(n_shard):
        s_d, na_d, g_d = strides[d], tr.agg_shape[d], op.grid_shape[d]
        npad = Pd[d] * (-(-na_d // Pd[d]))
        if npad * s_d < g_d:                   # final real plane must fit
            npad += Pd[d]
        na_pad.append(npad)
        g_pad.append(npad * s_d)
        na_loc.append(npad // Pd[d])
        n_loc_ax.append((npad // Pd[d]) * s_d)

    def _pad_to(arr, axis, target):
        pw = [(0, 0)] * arr.ndim
        pw[axis] = (0, target - arr.shape[axis])
        return jnp.pad(arr, pw)

    coeffs_p = op.coeffs
    inv_diag_p = sm.inv_diag.reshape(op.grid_shape)
    W_pad = tr.W
    for d in range(n_shard):
        coeffs_p = _pad_to(coeffs_p, 1 + d, g_pad[d])
        inv_diag_p = _pad_to(inv_diag_p, d, g_pad[d])
        W_pad = _pad_to(W_pad, 1 + dim + d, na_pad[d])

    none_rest = (None,) * (dim - n_shard)
    shard_grid = P(*(names + none_rest))
    spec_coeff = P(*((None,) + names + none_rest))
    spec_W = P(*((None,) * (1 + dim) + names + none_rest))
    smap = partial(_shard_map, mesh=mesh)

    # ------------------------------------------------------------- apply --
    def _halo_pair(arr, width, axis, name, P_ax):
        """Append both neighbors' boundary planes along `axis` (one-ring)."""
        lo = jax.lax.slice_in_dim(arr, arr.shape[axis] - width,
                                  arr.shape[axis], axis=axis)
        hi = jax.lax.slice_in_dim(arr, 0, width, axis=axis)
        up = jax.lax.ppermute(lo, name, [(i, i + 1) for i in range(P_ax - 1)])
        down = jax.lax.ppermute(hi, name, [(i, i - 1) for i in range(1, P_ax)])
        return jnp.concatenate([up, arr, down], axis=axis)

    def apply_loc(c_loc, x_loc):
        x_ext = x_loc
        for d in range(n_shard):
            x_ext = _halo_pair(x_ext, k, d, names[d], Pd[d])
        xp = jnp.pad(x_ext, ((0, 0),) * n_shard + ((k, k),) * (dim - n_shard))
        terms = None
        for i, off in enumerate(op.offsets):
            sl = tuple(slice(k + off[d], k + off[d] + n_loc_ax[d])
                       for d in range(n_shard)) + tuple(
                slice(k + o, k + o + g)
                for o, g in zip(off[n_shard:], rest_grid))
            t = c_loc[i] * xp[sl]
            terms = t if terms is None else terms + t
        return terms

    @jax.jit
    def apply_fn(coeffs, x):
        return smap(apply_loc, in_specs=(spec_coeff, shard_grid),
                    out_specs=shard_grid)(coeffs, x)

    # --------------------------------------------------------- restriction --
    def restrict_loc(W_loc, x_loc):
        # one halo plane per sharded axis from the block above (windows close
        # on its first row); sequential exchange carries corners along
        x_ext = x_loc
        for d in range(n_shard):
            top = jax.lax.ppermute(
                jax.lax.slice_in_dim(x_ext, 0, 1, axis=d),
                names[d], [(i, i - 1) for i in range(1, Pd[d])])
            x_ext = jnp.concatenate([x_ext, top], axis=d)
        out = jnp.zeros((n_ev,) + tuple(na_loc) + rest_agg, dtype=x_loc.dtype)
        for t in itertools.product(*[range(w) for w in tr.window_shape]):
            sl = tuple(
                slice(t[d], t[d] + strides[d] * (na_loc[d] - 1) + 1, strides[d])
                for d in range(n_shard)) + tuple(
                slice(td, td + sd * (ad - 1) + 1, sd)
                for td, sd, ad in zip(t[n_shard:], strides[n_shard:], rest_agg))
            xs = x_ext[sl]
            out = out + W_loc[(slice(None),) + t] * xs[None]
        return out

    @jax.jit
    def restrict_fn(W, x):
        loc = smap(restrict_loc, in_specs=(spec_W, shard_grid),
                   out_specs=P(*((None,) + names + none_rest)))(W, x)
        full = jax.lax.with_sharding_constraint(loc, NamedSharding(mesh, P()))
        # real agglomerates only, (a_z, [a_y,] ..., e) flat order
        trim = (slice(None),) + tuple(slice(0, tr.agg_shape[d])
                                      for d in range(n_shard))
        return jnp.moveaxis(full[trim], 0, -1).reshape(-1)

    # Prolongation = R^T is generated inside vcycle_fn via linear_transpose
    # of the sharded restriction with W as a traced ARGUMENT — closing over
    # W_pad would embed a constant that, under jax.distributed, can span
    # non-addressable devices (multi-process jit forbids that).

    # ------------------------------------------------------------ smoother --
    if isinstance(sm, ChebyshevSmoother):
        theta, delta, degree = sm.theta, sm.delta, sm.degree

        def smooth(coeffs, b, x):
            src = apply_fn(coeffs, x) - b
            xx = jnp.zeros_like(src)
            r = src
            p = None
            alpha = None
            for i in range(1, degree + 1):
                z = inv_diag_p * r
                if i == 1:
                    p, alpha = z, 1.0 / theta
                else:
                    beta = (delta * alpha / 2.0) ** 2
                    alpha = 1.0 / (theta - beta / alpha)
                    p = z + beta * p
                xx = xx + alpha * p
                if i < degree:
                    r = src - apply_fn(coeffs, xx)
            return x - xx
    elif isinstance(sm, JacobiSmoother):
        omega = sm.omega

        def smooth(coeffs, b, x):
            return x - omega * inv_diag_p * (apply_fn(coeffs, x) - b)
    else:
        raise ValueError("SPMD V-cycle supports Jacobi/Chebyshev smoothers")

    n_smooth = hier.config.smoother.n_smoothing_steps
    cycle_type = hier.config.cycle_type
    grid_padded = tuple(g_pad) + rest_grid

    @jax.jit
    def vcycle_fn(coeffs, W, rest, b, x):
        from mfmg_tpu.amge.hierarchy import _cycle
        restrict_T = jax.linear_transpose(
            lambda v: restrict_fn(W, v),
            jax.ShapeDtypeStruct(grid_padded, dtype))
        for _ in range(n_smooth):
            x = smooth(coeffs, b, x)
        res = apply_fn(coeffs, x) - b
        bc = restrict_fn(W, res)
        if len(rest) == 1:
            xc = rest[0].coarse.apply(bc)
        else:
            # coarser AMGe levels, replicated on every device
            xc = _cycle(rest, bc, jnp.zeros_like(bc), 0, n_smooth, cycle_type)
        (corr,) = restrict_T(xc)
        x = x - corr
        for _ in range(n_smooth):
            x = smooth(coeffs, b, x)
        return x

    # Commit every per-call operand with its TARGET sharding once: without
    # this, the padded coefficient planes (and W) sit on one device and jit
    # re-shards them across the mesh ON EVERY CALL — measured 9.6 s/cycle
    # at P=2/65^3-local on the CPU mesh (~60 MB of per-call movement), the
    # real cause of the round-4 weak-scaling collapse that was misread as
    # collective-rendezvous cost.  The coarser levels are replicated.
    coeffs_p = jax.device_put(coeffs_p, NamedSharding(mesh, spec_coeff))
    W_pad = jax.device_put(W_pad, NamedSharding(mesh, spec_W))
    levels_rest = jax.device_put(levels_rest, NamedSharding(mesh, P()))

    return SpmdVcycle(mesh=mesh, grid_shape=grid_padded,
                      orig_grid=op.grid_shape,
                      fn=partial(vcycle_fn, coeffs_p, W_pad, levels_rest))
