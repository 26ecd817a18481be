"""Smoothers.

All smoothers implement the reference contract (common/smoother.hpp:23-43):
``x <- x + B^{-1}(b - A x)`` coded via the negative-residual trick exactly as
the reference does (dealii_smoother.cc:69-81, cuda_smoother.cu:39-60).

Selection:
  * Jacobi — the reference's device smoother (cuda_smoother.cu); one fused
    elementwise pass after the SpMV.
  * Chebyshev — the reference's matrix-free smoother
    (dealii_matrix_free_smoother.cc); polynomial in D^{-1}A, pure
    SpMV/elementwise, the production smoother on the accelerator.  Parameter
    semantics follow deal.II PreconditionChebyshev: the eigenvalue interval is
    [max_ev/smoothing_range, max_ev] when smoothing_range > 1, otherwise
    [min_est, max_ev], with max_ev = 1.2 x Lanczos estimate when not given.
  * multicolor Gauss-Seidel — the data-parallel form of the reference's
    (S)SOR:
    lattice coloring for stencil operators, greedy coloring for ELL.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from mfmg_tpu.solve.operator import apply_op, operator_diagonal


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class JacobiSmoother:
    inv_diag: jax.Array
    omega: float = dataclasses.field(metadata=dict(static=True), default=1.0)

    def apply(self, op, b, x):
        # x += omega * D^{-1} (b - A x)   [negative-residual form]
        r = apply_op(op, x) - b
        return x - self.omega * self.inv_diag * r


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MulticolorGSSmoother:
    """Multicolor Gauss-Seidel — the data-parallel form of the reference's
    (symmetric) Gauss-Seidel smoothers (dealii_smoother.cc:38-52).

    Lexicographic GS is inherently sequential; coloring the structured grid so
    same-color dofs never couple makes each color update an independent
    vectorized Jacobi-like step, with the GS ordering carried between colors.
    Rates differ slightly from lexicographic SGS (as any reordering does) but
    retain GS-quality smoothing.

    Cost model: stencil operators use the MASKED SUBLATTICE sweep
    (_stencil_color_sweep) — each color's residual is evaluated only on its
    own strided sublattice, so a full forward sweep reads every stencil
    coefficient exactly once (~2 operator applies of total traffic) instead
    of one full operator apply per color (8 in 3D).  The production smoother
    is Chebyshev (as in the reference's matrix-free path); GS exists for
    parity.

    colors: (n,) int32 color index per dof; n_colors static.
    """

    inv_diag: jax.Array
    colors: jax.Array
    n_colors: int = dataclasses.field(metadata=dict(static=True), default=2)
    symmetric: bool = dataclasses.field(metadata=dict(static=True), default=True)

    def apply(self, op, b, x):
        from mfmg_tpu.ops.stencil import StencilOperator
        order = list(range(self.n_colors))
        if self.symmetric:
            order = order + order[::-1]
        if isinstance(op, StencilOperator):
            k = max(max(abs(o) for o in off) for off in op.offsets)
            if self.n_colors == (k + 1) ** len(op.grid_shape):
                return _stencil_color_sweep(op, self.inv_diag, b, x, order)
            # a grid with an axis shorter than k+1 compresses away unused
            # colors (_color_operator's np.unique); the sublattice sweep
            # needs the full lattice coloring, so use the masked form
        for c in order:
            r = apply_op(op, x) - b
            mask = self.colors == c
            x = jnp.where(mask, x - self.inv_diag * r, x)
        return x


def _stencil_color_sweep(op, inv_diag, b, x, color_order):
    """Gauss-Seidel sweep over lattice colors with per-color SUBLATTICE
    residuals: color (cz..cx) updates x[c::base, ...] from
    r_c = sum_i C_i[c::base] * x[c+off_i :: base] - b[c::base],
    touching each coefficient plane element exactly once per full sweep.
    Identical math (same ordering, same updates) to the masked
    apply-per-color form, at ~1/n_colors of its traffic."""
    grid = op.grid_shape
    dim = len(grid)
    k = max(max(abs(o) for o in off) for off in op.offsets)
    base = k + 1
    n_colors = base ** dim
    assert len(set(color_order)) == n_colors, "lattice sweep needs lattice colors"

    xg = x.reshape(grid)
    bg = b.reshape(grid)
    dg = inv_diag.reshape(grid)

    def color_multi(c):
        out = []
        for _ in range(dim):
            out.append(c % base)
            c //= base
        return tuple(reversed(out))        # (cz, .., cx) to match _color_operator

    def sub(arr, c_mi, shift=(0,) * 64):
        sl = []
        for d in range(dim):
            start = c_mi[d] + shift[d]
            ext = (grid[d] - c_mi[d] + base - 1) // base
            sl.append(slice(start, start + (ext - 1) * base + 1, base))
        return arr[tuple(sl)]

    for c in color_order:
        c_mi = color_multi(c)
        xp = jnp.pad(xg, k)
        r = -sub(bg, c_mi)
        for i, off in enumerate(op.offsets):
            shift = tuple(k + o for o in off)
            r = r + sub(op.coeffs[i], c_mi) * sub(xp, c_mi, shift)
        sl = tuple(slice(c_mi[d], None, base) for d in range(dim))
        xg = xg.at[sl].add(-sub(dg, c_mi) * r)
    return xg.reshape(x.shape)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class LexicographicGSSmoother:
    """Sequential (lexicographic) Gauss-Seidel / symmetric Gauss-Seidel with
    the reference's exact Trilinos semantics (dealii_smoother.cc:38-52):
    "gauss-seidel" = PreconditionSOR, one forward sweep from zero,
    B^{-1} = (D+L)^{-1}; "symmetric gauss-seidel" = PreconditionSSOR
    (Ifpack point relaxation, forward then backward sweep from zero),
    B^{-1} = (D+U)^{-1} D (D+L)^{-1}.

    Lexicographic sweeps are inherently sequential, so this variant keeps the
    triangular factors DENSE and solves them on device — O(n^2) memory, meant
    as the golden-rate parity oracle on the reference's small test meshes
    (SmootherConfig.coloring == "lexicographic").  Production smoothing uses
    MulticolorGSSmoother.
    """

    L: jax.Array                          # D + strict lower, dense
    U: object = None                      # D + strict upper (symmetric only)
    diag: object = None                   # D (symmetric only)
    perm: object = None                   # sweep order (dealii parity); None = natural
    iperm: object = None
    symmetric: bool = dataclasses.field(metadata=dict(static=True), default=False)

    def apply(self, op, b, x):
        r = apply_op(op, x) - b           # negative residual
        if self.perm is not None:
            r = r[self.perm]
        y = jax.scipy.linalg.solve_triangular(self.L, r, lower=True)
        if self.symmetric:
            y = jax.scipy.linalg.solve_triangular(self.U, self.diag * y,
                                                  lower=False)
        if self.perm is not None:
            y = y[self.iperm]
        return x - y


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ILUSmoother:
    """ILU(0) smoother — the reference's fourth host smoother option
    (dealii_smoother.cc:38-52, smoother.type "ILU" -> Trilinos Ifpack ILU
    with fill level 0).

    The factors keep the sparsity pattern of A (classical IKJ ILU(0),
    computed on the host at setup); the apply is
    ``x += (LU)^{-1} (b - A x)`` with the triangular solves run DENSE on
    device — like LexicographicGSSmoother this is the parity/oracle form
    (triangular solves are inherently sequential; at production scale the
    smoother is Chebyshev), capped at small n.
    """

    L: jax.Array                          # unit lower triangular, dense
    U: jax.Array                          # upper triangular, dense

    def apply(self, op, b, x):
        r = apply_op(op, x) - b           # negative residual
        y = jax.scipy.linalg.solve_triangular(self.L, r, lower=True,
                                              unit_diagonal=True)
        y = jax.scipy.linalg.solve_triangular(self.U, y, lower=False)
        return x - y


def _ilu0_factor(A_csr):
    """Classical IKJ ILU(0): factors confined to A's sparsity pattern.
    Host, setup time; returns dense (L unit-lower, U upper)."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A_csr).astype(np.float64)
    n = A.shape[0]
    lu = A.toarray()
    pattern = lu != 0
    for i in range(1, n):
        row_k = np.nonzero(pattern[i, :i])[0]
        for k in row_k:
            piv = lu[k, k]
            if piv == 0.0:
                continue
            m = lu[i, k] / piv
            lu[i, k] = m
            upd = pattern[i, k + 1:] & pattern[k, k + 1:]
            lu[i, k + 1:][upd] -= m * lu[k, k + 1:][upd]
    L = np.tril(lu, -1) + np.eye(n)
    U = np.triu(lu)
    return L, U


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ChebyshevSmoother:
    inv_diag: jax.Array
    theta: jax.Array          # (lmax + lmin) / 2 of D^{-1}A interval
    delta: jax.Array          # (lmax - lmin) / 2
    degree: int = dataclasses.field(metadata=dict(static=True), default=1)

    def apply(self, op, b, x):
        r = apply_op(op, x) - b          # negative residual
        dx = _chebyshev_vmult(self, op, r)
        return x - dx

    # mfmg applies the polynomial with the smoother's own operator; expose the
    # raw preconditioner action too for reuse in eigenvalue estimation.


def _chebyshev_vmult(sm: ChebyshevSmoother, op, src):
    """dst = p_degree(D^{-1}A) D^{-1} src — Chebyshev acceleration of Jacobi,
    zero initial guess (matches dealii::PreconditionChebyshev::vmult)."""
    theta, delta = sm.theta, sm.delta
    x = jnp.zeros_like(src)
    r = src
    p = jnp.zeros_like(src)
    alpha = jnp.asarray(0.0, dtype=src.dtype)
    for i in range(1, sm.degree + 1):
        z = sm.inv_diag * r
        if i == 1:
            p = z
            alpha = 1.0 / theta
        else:
            beta = (delta * alpha / 2.0) ** 2
            alpha = 1.0 / (theta - beta / alpha)
            p = z + beta * p
        x = x + alpha * p
        if i < sm.degree:
            r = src - apply_op(op, x)
    return x


def _color_operator(op):
    """Distance-1 coloring of the operator graph.

    Structured stencil operators use the closed-form lattice coloring
    ((k+1) colors per axis); general operators use greedy graph coloring on
    the host at setup.
    """
    from mfmg_tpu.ops.stencil import StencilOperator
    from mfmg_tpu.ops.sparse import ELLMatrix
    from mfmg_tpu.ops.block_stencil import BlockStencilOperator

    if isinstance(op, BlockStencilOperator):
        # lattice coloring of the agglomerate grid x component index:
        # same-color dofs sit in identical components of non-adjacent blocks
        base = 2
        shape = op.agg_shape
        colors = np.zeros(shape, dtype=np.int64)
        for d, n in enumerate(shape):
            idx = np.arange(n) % base
            colors = colors * base + idx.reshape((-1,) + (1,) * (len(shape) - d - 1))
        colors = (colors[..., None] * op.n_comp + np.arange(op.n_comp)).reshape(-1)
        _, colors = np.unique(colors, return_inverse=True)
        return jnp.asarray(colors.astype(np.int32)), int(colors.max()) + 1
    if isinstance(op, StencilOperator):
        width = max(max(abs(o) for o in off) for off in op.offsets)
        base = width + 1
        shape = op.grid_shape
        colors = np.zeros(shape, dtype=np.int64)
        for d, n in enumerate(shape):
            idx = np.arange(n) % base
            colors = colors * base + idx.reshape((-1,) + (1,) * (len(shape) - d - 1))
        colors = colors.reshape(-1)
        # compress to used colors
        _, colors = np.unique(colors, return_inverse=True)
        return jnp.asarray(colors.astype(np.int32)), int(colors.max()) + 1
    if isinstance(op, ELLMatrix):
        vals = np.asarray(op.vals)
        cols = np.asarray(op.cols)
        n = vals.shape[0]
        from mfmg_tpu import native
        colors = native.greedy_color(cols, vals)
        if colors is None:
            # vectorized fallback: Luby-style maximal-independent-set rounds
            # by random priority (O(rounds * nnz) numpy, no Python-per-row
            # loop; a few more colors than sequential greedy is fine)
            rng = np.random.default_rng(0)
            pri = rng.permutation(n).astype(np.int64)
            adj = (vals != 0) & (cols != np.arange(n)[:, None])
            colors = np.full(n, -1, dtype=np.int64)
            remaining = np.ones(n, dtype=bool)
            c = 0
            while remaining.any():
                nb_pri = np.where(adj & remaining[cols], pri[cols], -1)
                winners = remaining & (pri[:, None] > nb_pri).all(axis=1)
                colors[winners] = c
                remaining &= ~winners
                c += 1
        colors = colors.astype(np.int64)
        return jnp.asarray(colors.astype(np.int32)), int(colors.max()) + 1
    raise TypeError(f"cannot color operator type {type(op)}")


@partial(jax.jit, static_argnames=("n_iter",))
def _lanczos_coeffs(op, sqrt_dinv, v0, n_iter: int):
    """n_iter Lanczos steps on D^{-1/2} A D^{-1/2} as ONE device program
    (no per-iteration dispatch).  Returns (alphas, betas)."""

    def step(carry, _):
        v, v_prev, beta = carry
        w = sqrt_dinv * apply_op(op, sqrt_dinv * v)
        alpha = jnp.vdot(v, w)
        w = w - alpha * v - beta * v_prev
        beta_new = jnp.linalg.norm(w)
        safe = beta_new > 1e-30
        v_next = jnp.where(safe, w / jnp.where(safe, beta_new, 1.0), v)
        return (v_next, v, jnp.where(safe, beta_new, 0.0)), (alpha, beta_new)

    v0 = v0 / jnp.linalg.norm(v0)
    (_, _, _), (alphas, betas) = jax.lax.scan(
        step, (v0, jnp.zeros_like(v0), jnp.asarray(0.0, v0.dtype)), None,
        length=n_iter)
    return alphas, betas


def estimate_extreme_eigenvalues(op, inv_diag, n_iter: int = 20, seed: int = 7):
    """Estimate (lmin, lmax) of D^{-1}A by Lanczos on the symmetrized
    operator D^{-1/2} A D^{-1/2} (same spectrum).

    Analog of deal.II's CG-Lanczos estimate used by PreconditionChebyshev
    (consumed at dealii_matrix_free_smoother.cc:34-56).  Device scan at setup;
    host tridiagonal eigensolve of a tiny matrix.
    """
    n = inv_diag.shape[0]
    n_iter = min(n_iter, n)
    rng = np.random.default_rng(seed)
    v0 = jnp.asarray(rng.uniform(0.0, 1.0, size=n), dtype=inv_diag.dtype)
    alphas_j, betas_j = _lanczos_coeffs(op, jnp.sqrt(inv_diag), v0, n_iter)
    alphas = np.asarray(alphas_j, dtype=np.float64)
    betas = np.asarray(betas_j, dtype=np.float64)
    # truncate at Krylov exhaustion
    m = n_iter
    dead = np.nonzero(betas < 1e-30)[0]
    if len(dead):
        m = int(dead[0]) + 1
    alphas, betas = alphas[:m], betas[: m - 1]
    T = np.diag(alphas) + np.diag(betas, 1) + np.diag(betas, -1)
    ev = np.linalg.eigvalsh(T)
    return float(ev[0]), float(ev[-1])


def estimate_extreme_eigenvalues_host(A_scipy, n_iter: int = 40, seed: int = 7):
    """Host Lanczos estimate of the D^{-1}A interval from the assembled scipy
    matrix — no device program to compile at setup."""
    return _host_lanczos_interval(lambda v: A_scipy @ v,
                                  np.asarray(A_scipy.diagonal()),
                                  A_scipy.shape[0], n_iter, seed)


def estimate_extreme_eigenvalues_stencil(op, n_iter: int = 40, seed: int = 7):
    """Host Lanczos estimate using the stencil coefficients directly (numpy
    shifted-slice apply — mirrors ops.stencil.stencil_apply)."""
    coeffs = np.asarray(op.coeffs, dtype=np.float64)
    grid_shape, offsets = op.grid_shape, op.offsets
    k = max(max(abs(o) for o in off) for off in offsets)
    n = int(np.prod(grid_shape))
    center = [i for i, off in enumerate(offsets) if not any(off)]
    diag = coeffs[center[0]].reshape(-1) if center else np.ones(n)

    def apply_fn(v):
        xp = np.pad(v.reshape(grid_shape), k)
        y = np.zeros(grid_shape)
        for i, off in enumerate(offsets):
            sl = tuple(slice(k + o, k + o + m) for o, m in zip(off, grid_shape))
            y += coeffs[i] * xp[sl]
        return y.reshape(-1)

    return _host_lanczos_interval(apply_fn, diag, n, n_iter, seed)


def estimate_extreme_eigenvalues_cells(cells, A_loc, constrained, diag_raw,
                                       n_iter: int = 40, seed: int = 7):
    """Host Lanczos estimate straight from the per-cell matrices — the
    matrix-free setup path (the global matrix is never assembled).  The apply
    matches the eliminated operator: gather -> batched cell matvec ->
    scatter-add, with identity-times-raw-diagonal rows at constrained dofs
    (ops/local_apply.py semantics)."""
    n = diag_raw.shape[0]
    flat = cells.reshape(-1)

    def apply_fn(v):
        vz = np.where(constrained, 0.0, v)
        y_loc = np.einsum("cij,cj->ci", A_loc, vz[cells])
        y = np.bincount(flat, weights=y_loc.reshape(-1), minlength=n)
        return np.where(constrained, diag_raw * v, y)

    return _host_lanczos_interval(apply_fn, diag_raw, n, n_iter, seed)


def dealii_cg_eigenvalue_estimate(apply_fn, diag, n, n_iter: int = 8):
    """deal.II PreconditionChebyshev::estimate_eigenvalues parity.

    The reference never sets smoother.max_eigenvalue (dealii_matrix_free_
    smoother.cc:36-56), so deal.II estimates the Chebyshev window with exactly
    eig_cg_n_iterations (default 8) preconditioned-CG iterations, M = D^{-1},
    x0 = 0, rhs v_i = (i % 11) - mean(v) (set_initial_guess for
    LinearAlgebra::distributed::Vector), and reads the Ritz values off the CG
    tridiagonal: diag_k = 1/alpha_k + beta_{k-1}/alpha_{k-1},
    offdiag_k = sqrt(beta_k)/alpha_k (deal.II solver_cg.h eigenvalue slot).
    An under-converged 8-step estimate is part of the reference's observable
    behavior — the golden rates depend on it (e.g. hyper_ball MF 0.2981...).
    """
    v = np.arange(n, dtype=np.float64) % 11.0
    v -= v.mean()
    inv_diag = 1.0 / np.where(diag != 0, diag, 1.0)
    r = v.copy()
    z = inv_diag * r
    p = z.copy()
    rz = r @ z
    alphas, betas = [], []
    for _ in range(min(n_iter, n)):
        Ap = apply_fn(p)
        pAp = p @ Ap
        if pAp <= 0.0:
            break
        alpha = rz / pAp
        alphas.append(alpha)
        r = r - alpha * Ap
        z = inv_diag * r
        rz_new = r @ z
        if rz_new <= 1e-300:
            break
        betas.append(rz_new / rz)
        p = z + (rz_new / rz) * p
        rz = rz_new
    m = len(alphas)
    if m == 0:
        return 1.0, 1.0
    T_diag = np.empty(m)
    T_diag[0] = 1.0 / alphas[0]
    for k in range(1, m):
        T_diag[k] = 1.0 / alphas[k] + betas[k - 1] / alphas[k - 1]
    T_off = np.array([np.sqrt(betas[k]) / alphas[k] for k in range(m - 1)])
    if m == 1:
        return float(T_diag[0]), float(T_diag[0])
    import scipy.linalg as sla
    ev = sla.eigh_tridiagonal(T_diag, T_off, eigvals_only=True)
    return float(ev[0]), float(ev[-1])


def _host_apply_and_diag(op, A_scipy=None, problem=None):
    """(apply_fn, diag) on the host for the operator actually smoothed —
    assembled CSR, stencil coefficients, or raw cell matrices (matrix-free
    setup: the global matrix is never formed)."""
    from mfmg_tpu.ops.stencil import StencilOperator

    if A_scipy is not None:
        return (lambda x: A_scipy @ x), np.asarray(A_scipy.diagonal())
    if isinstance(op, StencilOperator):
        coeffs = np.asarray(op.coeffs, dtype=np.float64)
        grid_shape, offsets = op.grid_shape, op.offsets
        k = max(max(abs(o) for o in off) for off in offsets)
        center = [i for i, off in enumerate(offsets) if not any(off)]
        n = int(np.prod(grid_shape))
        diag = coeffs[center[0]].reshape(-1) if center else np.ones(n)

        def apply_fn(x):
            xp = np.pad(x.reshape(grid_shape), k)
            y = np.zeros(grid_shape)
            for i, off in enumerate(offsets):
                sl = tuple(slice(k + o, k + o + m)
                           for o, m in zip(off, grid_shape))
                y += coeffs[i] * xp[sl]
            return y.reshape(-1)

        return apply_fn, diag
    if problem is not None:
        cells = problem.mesh.cells
        A_loc = problem.A_loc
        constrained = problem.constrained
        diag_raw = problem.diag_raw
        n = diag_raw.shape[0]
        flat = cells.reshape(-1)

        def apply_fn(v):
            # deal.II MatrixFreeOperators::Base convention: constrained rows
            # are identity with value exactly 1 (dst_c = src_c, diagonal 1) —
            # this enters the CG coefficients (p^T A p) of the eigenvalue
            # estimate, so it must match bit-for-bit, not just up to D^{-1}.
            vz = np.where(constrained, 0.0, v)
            y_loc = np.einsum("cij,cj->ci", A_loc, vz[cells])
            y = np.bincount(flat, weights=y_loc.reshape(-1), minlength=n)
            return np.where(constrained, v, y)

        return apply_fn, np.where(constrained, 1.0, diag_raw)
    return None, None


def _host_lanczos_interval(apply_fn, diag, n, n_iter: int, seed: int):
    n_iter = min(n_iter, n)
    sq = 1.0 / np.sqrt(np.where(diag != 0, diag, 1.0))
    rng = np.random.default_rng(seed)
    v = rng.uniform(0.0, 1.0, size=n)
    v /= np.linalg.norm(v)
    v_prev = np.zeros(n)
    beta = 0.0
    alphas, betas = [], []
    for _ in range(n_iter):
        w = sq * apply_fn(sq * v)
        alpha = v @ w
        w = w - alpha * v - beta * v_prev
        alphas.append(alpha)
        beta_new = np.linalg.norm(w)
        if beta_new < 1e-30:
            break
        v_prev, v, beta = v, w / beta_new, beta_new
        betas.append(beta_new)
    T = np.diag(alphas) + np.diag(betas[: len(alphas) - 1], 1) + np.diag(betas[: len(alphas) - 1], -1)
    ev = np.linalg.eigvalsh(T)
    return float(ev[0]), float(ev[-1])


def build_smoother(op, smoother_cfg, dtype=jnp.float64, A_scipy=None,
                   problem=None):
    """Factory (analog of HierarchyHelpers::build_smoother).

    A_scipy: optional assembled matrix for host-side eigenvalue estimation
    (avoids compiling a device Lanczos program at setup).  problem: cell-
    matrix source for the same estimate on the matrix-free setup path
    (neither assembles nor needs the global matrix)."""
    diag = operator_diagonal(op)
    inv_diag = jnp.where(diag != 0, 1.0 / diag, 0.0).astype(dtype)
    stype = smoother_cfg.type.strip().lower()
    if stype in ("jacobi",):
        return JacobiSmoother(inv_diag=inv_diag, omega=smoother_cfg.jacobi_omega)
    if stype in ("gauss-seidel", "symmetric gauss-seidel", "sgs", "gs"):
        symmetric = stype in ("symmetric gauss-seidel", "sgs")
        if smoother_cfg.coloring == "lexicographic":
            if A_scipy is None:
                raise ValueError(
                    "lexicographic Gauss-Seidel needs the assembled matrix "
                    "(operator='ell' path); use coloring='multicolor' on "
                    "matrix-free paths")
            n = A_scipy.shape[0]
            if n > 8192:
                raise ValueError(
                    f"lexicographic Gauss-Seidel stores dense triangular "
                    f"factors (n={n} > 8192); it is the golden-rate parity "
                    f"oracle — use coloring='multicolor' at scale")
            A_d = np.asarray(A_scipy.todense(), dtype=np.float64)
            perm = iperm = None
            if smoother_cfg.ordering == "dealii":
                if problem is None:
                    raise ValueError("ordering='dealii' needs the mesh "
                                     "(available on the finest level only)")
                from mfmg_tpu.fem.dealii_order import dealii_dof_numbering
                p = np.argsort(dealii_dof_numbering(problem.mesh))
                A_d = A_d[np.ix_(p, p)]
                perm = jnp.asarray(p, dtype=jnp.int32)
                iperm = jnp.asarray(np.argsort(p), dtype=jnp.int32)
            L = jnp.asarray(np.tril(A_d), dtype=dtype)
            U = jnp.asarray(np.triu(A_d), dtype=dtype) if symmetric else None
            d = jnp.asarray(np.diag(A_d), dtype=dtype) if symmetric else None
            return LexicographicGSSmoother(L=L, U=U, diag=d, perm=perm,
                                           iperm=iperm, symmetric=symmetric)
        colors, n_colors = _color_operator(op)
        return MulticolorGSSmoother(inv_diag=inv_diag, colors=colors,
                                    n_colors=n_colors,
                                    symmetric=symmetric)
    if stype == "ilu":
        if A_scipy is None:
            raise ValueError("ILU smoothing needs the assembled matrix "
                             "(operator='ell' path)")
        n = A_scipy.shape[0]
        if n > 8192:
            raise ValueError(
                f"ILU(0) stores dense triangular factors (n={n} > 8192); it "
                f"is the reference-parity smoother option — use Chebyshev "
                f"at scale")
        L, U = _ilu0_factor(A_scipy)
        return ILUSmoother(L=jnp.asarray(L, dtype=dtype),
                           U=jnp.asarray(U, dtype=dtype))
    if stype == "chebyshev":
        if smoother_cfg.max_eigenvalue is not None:
            lmax = float(smoother_cfg.max_eigenvalue)
            lmin_est = lmax / 20.0
        else:
            apply_fn, diag_h = _host_apply_and_diag(op, A_scipy=A_scipy,
                                                    problem=problem)
            est = smoother_cfg.eig_estimate.strip().lower()
            if est == "dealii_cg" and apply_fn is not None:
                # deal.II parity: exactly eig_cg_n_iterations (default 8) of
                # preconditioned CG from the i%11 start vector — an
                # intentionally under-converged estimate the reference's
                # golden rates depend on
                # (PreconditionChebyshev::estimate_eigenvalues).  Opt-in via
                # SmootherConfig.eig_estimate: at production sizes the 8-step
                # estimate underestimates lmax and degrades the cycle.
                lmin_est, lmax_est = dealii_cg_eigenvalue_estimate(
                    apply_fn, diag_h, diag_h.shape[0],
                    n_iter=smoother_cfg.eig_cg_n_iterations)
            elif apply_fn is not None:
                # production default: converged-enough host Lanczos interval
                # (16 steps put lmax within 0.8% of the 40-step value at
                # 274k dofs — absorbed by the 1.2 safety factor — and the
                # host estimate is ~15 s of the 2.1M setup at 40 steps)
                lmin_est, lmax_est = _host_lanczos_interval(
                    apply_fn, diag_h, diag_h.shape[0], n_iter=16, seed=7)
            else:
                lmin_est, lmax_est = estimate_extreme_eigenvalues(
                    op, inv_diag, n_iter=40)
            lmax = 1.2 * lmax_est          # deal.II safety factor
            lmin_est = max(lmin_est, 1e-12)
        if smoother_cfg.smoothing_range > 1.0:
            lmin = lmax / smoother_cfg.smoothing_range
        else:
            # deal.II: alpha = min(0.9 * max_estimate, min_estimate)
            lmin = min(0.9 * lmax / 1.2, lmin_est)
        theta = jnp.asarray((lmax + lmin) / 2.0, dtype=dtype)
        delta = jnp.asarray((lmax - lmin) / 2.0, dtype=dtype)
        return ChebyshevSmoother(inv_diag=inv_diag, theta=theta, delta=delta,
                                 degree=smoother_cfg.degree)
    raise ValueError(f"unknown smoother type {smoother_cfg.type!r}")
