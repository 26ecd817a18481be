"""Lanczos eigensolver with Cullum-Willoughby filtering and deflation.

Re-implementation of the reference's Lanczos stack
(common/lanczos.templates.hpp, common/lanczos_deflatedop.templates.hpp):

  * single-operator solve with the reference's exact semantics — convergence
    checked on the percent_overshoot schedule (lanczos.templates.hpp:250-276),
    tridiagonal eigensolve per check, Cullum-Willoughby spurious-eigenvalue
    filter with tol 5e-12 (lanczos.templates.hpp:336-419), Ritz vectors from
    stored Lanczos vectors, optional multi-cycle deflated mode,
  * a batched device variant for the AMGe setup: a fixed-iteration
    `lax.scan` Lanczos over the whole padded agglomerate batch (matvec =
    one batched matmul), with the tridiagonal solves + CW
    filtering replayed on host over the stored coefficients, reproducing the
    reference's stopping behaviour exactly while keeping the device loop
    branch-free.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg

CW_TOL = 5.0e-12  # lanczos.templates.hpp:346


# --------------------------------------------------------------------------
# tridiagonal eigensolve + Cullum-Willoughby filter
# --------------------------------------------------------------------------
def tridiag_eigenpairs_cw(alphas, betas, num_requested):
    """Eigenpairs of T = tridiag(betas, alphas, betas) with the CW filter.

    Returns (evals[num_requested], evecs[n, num_requested]) or (None, None)
    if fewer than num_requested non-spurious eigenpairs are available
    (lanczos.templates.hpp:295-453).
    """
    n = len(alphas)
    if n < num_requested:
        return None, None
    if n == 1:
        w = np.array(alphas)
        v = np.ones((1, 1))
    else:
        w, v = scipy.linalg.eigh_tridiagonal(np.asarray(alphas), np.asarray(betas))

    # repeated / marked flags (lanczos.templates.hpp:348-364)
    is_repeated = np.zeros(n, dtype=bool)
    is_marked = np.zeros(n, dtype=bool)
    for i in range(n):
        is_repeated[i] = ((i > 0 and w[i] <= w[i - 1] + CW_TOL) or
                          (i < n - 1 and w[i + 1] <= w[i] + CW_TOL))
        is_marked[i] = (i == 0) or (w[i] > w[i - 1] + CW_TOL)

    # spurious = non-repeated eigenvalue of T also an eigenvalue of T2
    # (T minus first row/col)  (lanczos.templates.hpp:366-419)
    is_spurious = np.zeros(n, dtype=bool)
    n2 = n - 1
    if n2 >= 1 and n2 >= num_requested:
        if n2 == 1:
            w2 = np.array([alphas[1]])
        else:
            w2 = scipy.linalg.eigvalsh_tridiagonal(np.asarray(alphas[1:]), np.asarray(betas[1:]))
        j_start = 0
        for i in range(n):
            if is_repeated[i]:
                continue
            for j in range(j_start, n2):
                if w2[j] < w[i] - CW_TOL:
                    j_start = j
                    continue
                if w2[j] > w[i] + CW_TOL:
                    break
                is_spurious[i] = True
                break

    keep = is_marked & ~is_spurious
    if keep.sum() < num_requested:
        return None, None
    idx = np.nonzero(keep)[0][:num_requested]
    evals = w[idx]
    evecs = v[:, idx]
    evecs = evecs / np.linalg.norm(evecs, axis=0, keepdims=True)
    return evals, evecs


def _check_convergence(beta, evecs, tol):
    """beta * |last component of each requested tridiag eigenvector| <= tol
    (lanczos.templates.hpp:455-479)."""
    return bool(np.all(beta * np.abs(evecs[-1, :]) <= tol))


def check_schedule(maxit, percent_overshoot):
    """Iterations at which the reference checks convergence
    (lanczos.templates.hpp:250-257): first iteration, maxit, and whenever
    100*(it - it_prev_check) > percent_overshoot * it_prev_check."""
    checks = []
    it_prev = 0
    for it in range(1, maxit + 1):
        if it == 1 or it == maxit or 100 * (it - it_prev) > percent_overshoot * it_prev:
            checks.append(it)
            it_prev = it
    return checks


# --------------------------------------------------------------------------
# single-operator host solve (reference-exact)
# --------------------------------------------------------------------------
class DeflatedOperator:
    """(I - V V^T) A with modified Gram-Schmidt deflation-vector insertion
    (common/lanczos_deflatedop.templates.hpp:31-126)."""

    def __init__(self, matvec):
        self._matvec = matvec
        self.V = []  # orthonormal deflation vectors

    def matvec(self, x):
        y = self._matvec(x)
        return self.deflate(y)

    def deflate(self, v):
        v = v.copy()
        for u in self.V:
            v -= (u @ v) * u
        return v

    def add_deflation_vecs(self, vecs):
        # modified Gram-Schmidt against existing + new vectors, keep norm order
        for v in vecs:
            w = self.deflate(np.array(v, dtype=float))
            for u in self.V:
                w -= (u @ w) * u
            nrm = np.linalg.norm(w)
            if nrm > 1e-14:
                self.V.append(w / nrm)


def lanczos_solve(matvec, n, num_requested, tol, maxit, percent_overshoot=0,
                  initial_guess=None, is_deflated=False, num_cycles=1,
                  num_eigenpairs_per_cycle=None, seed_base=0):
    """Reference-equivalent Lanczos solve (lanczos.templates.hpp:83-176).

    Returns (evals[num_requested], evecs[n, num_requested], n_iterations).
    """
    rng = np.random.default_rng(seed_base)
    if initial_guess is None:
        initial_guess = rng.uniform(0.0, 1.0, size=n)
    if not is_deflated:
        num_cycles, per_cycle = 1, num_requested
    else:
        per_cycle = num_eigenpairs_per_cycle or num_requested

    dop = DeflatedOperator(matvec)
    all_evals, all_evecs = [], []
    total_iters = 0
    guess = np.array(initial_guess, dtype=float)
    for cycle in range(num_cycles):
        if cycle > 0:
            # re-seed: multiply entries by (1 + uniform) keeping zeros zero
            # (lanczos.templates.hpp:36-49)
            g = np.random.default_rng(cycle)
            guess = (1.0 + g.uniform(0.0, 1.0, size=n)) * initial_guess
        v = dop.deflate(guess)
        evals, evecs, iters = _solve_single(dop.matvec, v, per_cycle, tol,
                                            maxit, percent_overshoot)
        total_iters += iters
        all_evals.extend(evals)
        all_evecs.extend(evecs.T)
        if cycle != num_cycles - 1:
            dop.add_deflation_vecs(list(evecs.T))

    all_evals = np.array(all_evals[: max(num_requested, len(all_evals))])
    order = np.argsort(all_evals, kind="stable")[:num_requested]
    evals = all_evals[order]
    evecs = np.stack([all_evecs[i] for i in order], axis=1)
    return evals, evecs, total_iters


def _solve_single(matvec, initial, num_requested, tol, maxit, percent_overshoot):
    beta = np.linalg.norm(initial)
    assert beta > 0, "zero initial guess"
    lanc = [np.array(initial, dtype=float)]
    alphas, betas = [], []
    evals = evecs_t = None
    it_prev_check = 0
    it_final = maxit
    for it in range(1, maxit + 1):
        lanc[it - 1] = lanc[it - 1] / beta
        w = matvec(lanc[it - 1])
        if it != 1:
            w = w - beta * lanc[it - 2]
            betas.append(beta)
        alpha = lanc[it - 1] @ w
        alphas.append(alpha)
        w = w - alpha * lanc[it - 1]
        beta = np.linalg.norm(w)
        lanc.append(w)
        check = (it == 1 or it == maxit or
                 100 * (it - it_prev_check) > percent_overshoot * it_prev_check)
        if check:
            evals, evecs_t = tridiag_eigenpairs_cw(alphas, betas, num_requested)
            if evals is not None and _check_convergence(beta, evecs_t, tol):
                it_final = it
                break
            it_prev_check = it
        if beta < 1e-300:
            # Krylov space exhausted; final eigensolve below
            evals, evecs_t = tridiag_eigenpairs_cw(alphas, betas, num_requested)
            it_final = it
            break
    if evals is None:
        evals, evecs_t = tridiag_eigenpairs_cw(alphas, betas, num_requested)
    assert evals is not None, "Lanczos failed to produce enough eigenpairs"
    # Ritz vectors from stored Lanczos vectors (lanczos.templates.hpp:481-503)
    Q = np.stack(lanc[: len(alphas)], axis=1)     # (n, m)
    evecs = Q @ evecs_t
    return evals, evecs, it_final


# --------------------------------------------------------------------------
# Batched device variant for the AMGe setup
# --------------------------------------------------------------------------
def batched_lanczos_smallest(batch, eig_cfg, constrained_mode: str = "pin"):
    """Smallest eigenpairs of every agglomerate via one batched device Lanczos.

    Device part: fixed-count lax.scan whose body is a single
    (n_agg, m, m) x (n_agg, m) batched matvec — the batched replacement for the
    reference's per-agglomerate threaded Lanczos loops.  Host part: replay of
    the reference's convergence schedule + CW filter over the stored
    tridiagonal coefficients (tiny).

    Deflated multi-cycle mode (is_deflated / num_cycles /
    num_eigenpairs_per_cycle, lanczos.templates.hpp:83-176): each cycle runs
    the batched scan against the deflated operator (I - V Vᵀ)A — the
    deflation basis rides the scan as one extra batched projection — with
    the reference's re-seeded initial guess, and converged vectors join V by
    batched modified Gram-Schmidt between cycles.

    Returns (evals (n_agg, n_ev), evecs (n_agg, m_max, n_ev)) like
    batched_smallest_eigenpairs.
    """
    import jax.numpy as jnp
    from mfmg_tpu.eigen.batched_eigh import CONSTRAINED_DIAG

    n_ev = eig_cfg.n_eigenvectors
    tol = max(eig_cfg.tolerance, 1e-4)      # reference tol floor, amge_host.templates.hpp:181
    n_agg, m_max = batch.dof_map.shape

    # Build the (mode-dependent) batched operator exactly as batched_eigh does.
    M = batch.A_agg.astype(np.float64)
    if M is batch.A_agg:
        M = M.copy()
    ar = np.arange(m_max)
    if constrained_mode == "pin":
        shifts = (batch.diag * batch.valid).sum(axis=1) / batch.sizes
    else:
        shifts = np.zeros(n_agg)
    M[:, ar, ar] += shifts[:, None] * batch.valid
    di = M[:, ar, ar]
    if constrained_mode in ("pin", "identity"):
        di = np.where(batch.constrained, CONSTRAINED_DIAG, di)
    pad_value = 100.0 * max(np.abs(M).max(), CONSTRAINED_DIAG)
    di = np.where(~batch.valid, pad_value, di)
    M[:, ar, ar] = di

    if eig_cfg.is_deflated:
        n_cycles = max(1, eig_cfg.num_cycles)
        per_cycle = eig_cfg.num_eigenpairs_per_cycle or n_ev
    else:
        n_cycles, per_cycle = 1, n_ev

    # The Krylov space of agglomerate g has dimension sizes[g] (padding dims
    # are decoupled and never entered: the initial guess is zero there).
    maxit = int(min(eig_cfg.max_iterations, batch.sizes.min()))

    # Initial guess: uniform random, zero at constrained dofs & padding
    # (dealii_mesh_evaluator.cc:43-55 semantics).
    rng = np.random.default_rng(0)
    base_guess = rng.uniform(0.0, 1.0, size=(n_agg, m_max))
    mask = batch.valid & ~batch.constrained
    base_guess = np.where(mask, base_guess, 0.0)

    Mj = jnp.asarray(M)
    all_evals = []                 # per cycle: (n_agg, per_cycle)
    all_evecs = []                 # per cycle: (n_agg, m_max, per_cycle)
    V = np.zeros((n_agg, m_max, 0))
    for cycle in range(n_cycles):
        if cycle == 0:
            guess = base_guess
        else:
            # re-seed: entries scaled by (1 + uniform), zeros stay zero
            # (lanczos.templates.hpp:36-49)
            g = np.random.default_rng(cycle)
            guess = (1.0 + g.uniform(0.0, 1.0, size=(n_agg, m_max))) * base_guess
        if V.shape[2]:
            guess = guess - np.einsum("gmk,gk->gm", V,
                                      np.einsum("gmk,gm->gk", V, guess))
        ev_c, vec_c = _batched_lanczos_cycle(
            Mj, V if V.shape[2] else None, guess, per_cycle, maxit,
            eig_cfg.percent_overshoot, tol, shifts, batch)
        all_evals.append(ev_c)
        all_evecs.append(vec_c)
        if cycle != n_cycles - 1:
            V = _batched_add_deflation(V, vec_c)

    evals_cat = np.concatenate(all_evals, axis=1)          # (n_agg, total)
    evecs_cat = np.concatenate(all_evecs, axis=2)
    order = np.argsort(evals_cat, axis=1, kind="stable")[:, :n_ev]
    evals_out = np.take_along_axis(evals_cat, order, axis=1)
    evecs_out = np.take_along_axis(evecs_cat, order[:, None, :], axis=2)
    # normalize (Ritz vectors have unit norm up to roundoff already)
    nrm = np.linalg.norm(evecs_out, axis=1, keepdims=True)
    evecs_out = np.where(nrm > 0, evecs_out / np.where(nrm == 0, 1, nrm), evecs_out)
    evecs_out = evecs_out * batch.valid[:, :, None]
    return evals_out, evecs_out


def _batched_lanczos_cycle(Mj, V, guess, per_cycle, maxit, percent_overshoot,
                           tol, shifts, batch):
    """One batched Lanczos pass against (I - V Vᵀ) A (V may be None)."""
    import jax
    import jax.numpy as jnp

    n_agg, m_max = guess.shape
    v0j = jnp.asarray(guess)
    beta0 = jnp.linalg.norm(v0j, axis=1)
    Vj = jnp.asarray(V) if V is not None else None

    def step(carry, _):
        v_curr, v_prev, beta = carry
        v_norm = v_curr / beta[:, None]
        w = jnp.einsum("gij,gj->gi", Mj, v_norm)
        if Vj is not None:
            # deflated operator: project converged directions out of the
            # output (lanczos_deflatedop.templates.hpp:31-46)
            w = w - jnp.einsum("gmk,gk->gm", Vj,
                               jnp.einsum("gmk,gm->gk", Vj, w))
        w = w - beta[:, None] * v_prev
        alpha = jnp.einsum("gi,gi->g", v_norm, w)
        w = w - alpha[:, None] * v_norm
        beta_new = jnp.linalg.norm(w, axis=1)
        # guard against Krylov exhaustion: freeze with beta=1, w=unit dummy
        safe = beta_new > 1e-30
        beta_new = jnp.where(safe, beta_new, 1.0)
        return (w, v_norm, beta_new), (alpha, beta_new, v_norm)

    # first step has v_prev = 0, beta multiplying it = beta0 (harmless)
    (_, _, _), (alphas, betas, vs) = jax.lax.scan(
        step, (v0j, jnp.zeros_like(v0j), beta0), None, length=maxit)
    alphas = np.asarray(alphas).T            # (n_agg, maxit)
    betas = np.asarray(betas).T              # (n_agg, maxit) - beta after each it
    vs = np.transpose(np.asarray(vs), (1, 0, 2))  # (n_agg, maxit, m)

    # Host replay of the reference's stopping schedule per agglomerate.
    checks = check_schedule(maxit, percent_overshoot)
    evals_out = np.empty((n_agg, per_cycle))
    evecs_out = np.zeros((n_agg, m_max, per_cycle))
    for g in range(n_agg):
        done = False
        for it in checks:
            w_, v_ = tridiag_eigenpairs_cw(alphas[g, :it], betas[g, :it - 1], per_cycle)
            if w_ is not None and (_check_convergence(betas[g, it - 1], v_, tol)
                                   or it == checks[-1]):
                evals_out[g] = w_ - shifts[g]
                evecs_out[g] = vs[g, :it].T @ v_
                done = True
                break
        if not done:
            w_, v_ = tridiag_eigenpairs_cw(alphas[g], betas[g, :-1], per_cycle)
            assert w_ is not None, f"agglomerate {g}: Lanczos produced too few eigenpairs"
            evals_out[g] = w_ - shifts[g]
            evecs_out[g] = vs[g].transpose(1, 0) @ v_
    return evals_out, evecs_out


def _batched_add_deflation(V, new_vecs):
    """Batched modified Gram-Schmidt insertion of new deflation vectors
    (lanczos_deflatedop.templates.hpp:57-117); vectors that collapse to zero
    are kept as zero columns (they then deflate nothing — harmless)."""
    cols = [V]
    Vcur = V
    for j in range(new_vecs.shape[2]):
        w = new_vecs[:, :, j].copy()
        for _ in range(2):                     # MGS twice for stability
            if Vcur.shape[2]:
                w = w - np.einsum("gmk,gk->gm", Vcur,
                                  np.einsum("gmk,gm->gk", Vcur, w))
        nrm = np.linalg.norm(w, axis=1, keepdims=True)
        w = np.where(nrm > 1e-14, w / np.where(nrm == 0, 1, nrm), 0.0)
        cols.append(w[:, :, None])
        Vcur = np.concatenate(cols, axis=2)
    return Vcur
