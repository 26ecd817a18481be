"""Batched LOBPCG — the batched form of the reference's Anasazi adapter.

The reference runs Trilinos Anasazi's LOBPCG per agglomerate under WorkStream
threads (dealii/anasazi.templates.hpp:36-105, "SM" smallest-magnitude,
Hermitian, optional full orthogonalization, non-relative tolerance), with an
optional warm start reusing previous eigenvectors
(amge_host.templates.hpp:226-266, the "anasazi_init_guess" golden family).

Here all agglomerates iterate TOGETHER: one `lax.while_loop` whose carried
state is the batched block (n_agg, m, 3*nev) and whose body is batched dense
algebra — the per-iteration Rayleigh-Ritz is a batched eigh of (3*nev x 3*nev)
blocks.  Termination mirrors Anasazi's:

  * per-agglomerate convergence test: block g converges when every requested
    Ritz pair satisfies ||A x - theta x||_2 <= tol (the adapter's NON-relative
    "Convergence Tolerance", anasazi.templates.hpp:56-88);
  * converged blocks are FROZEN (masked out of the update) so their pairs do
    not drift while stragglers iterate;
  * the loop exits as soon as every block is converged, or at max_iterations.

full_ortho selects Anasazi's "Full Ortho" stability mode: True (the
reference driver's choice) orthonormalizes the whole [X R P] trial basis by
QR before the Rayleigh-Ritz; False keeps the raw basis and solves the
generalized pencil (S^T A S, S^T S) — cheaper per iteration but can go
unstable when the basis degenerates, exactly as Anasazi documents.
"""

from __future__ import annotations

import numpy as np

from mfmg_tpu.eigen.batched_eigh import CONSTRAINED_DIAG


def _build_batched_operator(batch, constrained_mode):
    M = batch.A_agg.copy()
    ar = np.arange(batch.m_max)
    if constrained_mode == "pin":
        shifts = (batch.diag * batch.valid).sum(axis=1) / batch.sizes
    else:
        shifts = np.zeros(batch.n_agg)
    M[:, ar, ar] += shifts[:, None] * batch.valid
    di = M[:, ar, ar]
    if constrained_mode in ("pin", "identity"):
        di = np.where(batch.constrained, CONSTRAINED_DIAG, di)
    pad_value = 100.0 * max(np.abs(M).max(), CONSTRAINED_DIAG)
    di = np.where(~batch.valid, pad_value, di)
    M[:, ar, ar] = di
    return M, shifts


def batched_lobpcg_smallest(batch, eig_cfg, constrained_mode: str = "pin",
                            initial_guess: np.ndarray | None = None,
                            max_iterations: int | None = None,
                            return_info: bool = False):
    """Smallest eigenpairs of every agglomerate via one batched LOBPCG.

    initial_guess: optional (n_agg, m_max, n_ev) warm start (the reference's
    use_initial_guess path reusing the previous setup's eigenvectors).
    Returns (evals (n_agg, n_ev), evecs (n_agg, m_max, n_ev)); with
    return_info also a dict {"iterations", "converged"}.

    Tolerance and iteration cap come from the eigensolver config (the
    Anasazi adapter's non-relative user tolerance and max_iterations,
    anasazi.templates.hpp:36-105) — with a floor of 1e-6 on the tolerance
    in float32: the batched single-precision iteration cannot resolve
    residuals below roundoff of the Rayleigh quotients, where the
    reference's double-precision Anasazi can (documented deviation).
    """
    import jax
    import jax.numpy as jnp

    n_ev = eig_cfg.n_eigenvectors
    f64 = jnp.zeros(()).dtype == jnp.float64
    tol = max(eig_cfg.tolerance, 1e-10 if f64 else 1e-6)
    full_ortho = bool(getattr(eig_cfg, "full_ortho", True))
    if max_iterations is None:
        max_iterations = eig_cfg.max_iterations
    n_agg, m = batch.dof_map.shape
    Mop, shifts = _build_batched_operator(batch, constrained_mode)
    A = jnp.asarray(Mop)

    mask = batch.valid & ~batch.constrained
    rng = np.random.default_rng(0)
    if initial_guess is None:
        X0 = rng.uniform(0.0, 1.0, size=(n_agg, m, n_ev))
    else:
        X0 = np.array(initial_guess, dtype=float)
        # re-randomize zero columns (reference fixes degenerate warm starts,
        # amge_host.templates.hpp:244-265)
        dead = np.linalg.norm(X0, axis=1) < 1e-14
        X0 = np.where(dead[:, None, :], rng.uniform(size=X0.shape), X0)
    X0 = X0 * mask[:, :, None]

    def rayleigh_ritz_qr(S):
        # full-ortho path: orthonormalize the trial basis, ordinary eigh.
        # Also returns the Ritz coefficients IN THE S BASIS (c = RR^{-1} V,
        # from S = Q RR) so the caller can form the classical LOBPCG
        # conjugate direction from the R,P block components.
        if S.shape[2] > S.shape[1]:
            # more trial columns than dofs (m_max < 3*n_ev): the reduced QR's
            # RR is non-square and the triangular solve below is undefined —
            # use the whitened-pencil path, whose masked Gram handles the
            # necessarily rank-deficient basis
            return rayleigh_ritz_raw(S)
        Q, RR = jnp.linalg.qr(S)
        T = jnp.einsum("gmi,gmn,gnj->gij", Q, A, Q)
        T = 0.5 * (T + jnp.swapaxes(T, 1, 2))
        w, V = jnp.linalg.eigh(T)
        Vk = V[:, :, :n_ev]
        # guard: degenerate basis columns make RR singular; regularize the
        # diagonal (the affected coefficients only feed the P update)
        d = jnp.abs(jnp.einsum("gii->gi", RR))
        scale = jnp.max(d, axis=1, keepdims=True)
        eye = jnp.eye(RR.shape[-1], dtype=RR.dtype)
        RRr = RR + (1e-14 * scale + 1e-300)[:, :, None] * eye
        c = jax.lax.linalg.triangular_solve(RRr, Vk, left_side=True,
                                            lower=False)
        return w[:, :n_ev], jnp.einsum("gmk,gkj->gmj", Q, Vk), c

    def rayleigh_ritz_raw(S):
        # non-full-ortho path: generalized pencil on the raw basis
        # (Anasazi's cheaper default mode).  The Gram is rank-deficient
        # whenever a residual/conjugate column degenerates, so it is
        # whitened by a MASKED eigendecomposition: deficient directions get
        # zero weight and their Ritz slots are pushed to the top of the
        # spectrum so the smallest-n_ev selection never picks them.
        G = jnp.einsum("gmi,gmj->gij", S, S)
        G = 0.5 * (G + jnp.swapaxes(G, 1, 2))
        g, E = jnp.linalg.eigh(G)
        gmax = jnp.maximum(g[:, -1:], 1e-300)
        ok = g > 1e-12 * gmax
        winv = jnp.where(ok, 1.0 / jnp.sqrt(jnp.maximum(g, 1e-300)), 0.0)
        W = E * winv[:, None, :]
        T = jnp.einsum("gmi,gmn,gnj->gij", S, A, S)
        Tr = jnp.einsum("gki,gkl,glj->gij", W, T, W)
        Tr = 0.5 * (Tr + jnp.swapaxes(Tr, 1, 2))
        big = (1.0 + jnp.max(jnp.abs(Tr), axis=(1, 2), keepdims=True)) * 1e6
        eye = jnp.eye(Tr.shape[-1], dtype=Tr.dtype)
        Tr = Tr + big * (jnp.where(ok, 0.0, 1.0)[:, :, None] * eye)
        w, V = jnp.linalg.eigh(Tr)
        c = jnp.einsum("gkl,glj->gkj", W, V[:, :, :n_ev])
        X = jnp.einsum("gmk,gkj->gmj", S, c)
        nrm = jnp.linalg.norm(X, axis=1, keepdims=True)
        return w[:, :n_ev], X / jnp.where(nrm == 0, 1.0, nrm), c

    rayleigh_ritz = rayleigh_ritz_qr if full_ortho else rayleigh_ritz_raw

    def residual_norms(X, theta):
        AX = jnp.einsum("gmn,gnk->gmk", A, X)
        R = AX - X * theta[:, None, :]
        return R, jnp.linalg.norm(R, axis=1)          # (n_agg, n_ev)

    def _unit_cols(V):
        nrm = jnp.linalg.norm(V, axis=1, keepdims=True)
        return V / jnp.where(nrm < 1e-300, 1.0, nrm)

    def body(carry):
        X, P, theta, active, it = carry
        R, _ = residual_norms(X, theta)
        # unit-normalize the R and P blocks: spans are unchanged and the QR
        # of the trial basis stays well conditioned near convergence
        S = jnp.concatenate([X, _unit_cols(R), _unit_cols(P)], axis=2)
        theta_n, Xn, c = rayleigh_ritz(S)
        # classical LOBPCG conjugate direction: the R,P components of the
        # new Ritz vectors, p_new = [R P] c_rp  (Knyazev 2001, eq. 4.3)
        Pn = _unit_cols(jnp.einsum("gmk,gkj->gmj", S[:, :, n_ev:],
                                   c[:, n_ev:, :]))
        # masked convergence: frozen blocks keep their converged pairs
        keep = active[:, None, None]
        X = jnp.where(keep, Xn, X)
        P = jnp.where(keep, Pn, P)
        theta = jnp.where(active[:, None], theta_n, theta)
        _, rn = residual_norms(X, theta)
        active = active & (jnp.max(rn, axis=1) > tol)
        return X, P, theta, active, it + 1

    def cond(carry):
        _, _, _, active, it = carry
        return jnp.any(active) & (it < max_iterations)

    X = jnp.asarray(X0)
    theta0, X, _ = rayleigh_ritz_qr(X)
    P = jnp.zeros_like(X)
    active0 = jnp.ones((n_agg,), dtype=bool)
    X, P, theta, active, iters = jax.lax.while_loop(
        cond, body, (X, P, theta0, active0, jnp.asarray(0)))

    evals = np.asarray(theta, dtype=np.float64) - shifts[:, None]
    evecs = np.asarray(X, dtype=np.float64)
    # normalize + zero padding
    evecs = evecs * batch.valid[:, :, None]
    nrm = np.linalg.norm(evecs, axis=1, keepdims=True)
    evecs = np.where(nrm > 0, evecs / np.where(nrm == 0, 1, nrm), evecs)
    if return_info:
        info = {"iterations": int(iters),
                "converged": np.asarray(~active)}
        return evals, evecs, info
    return evals, evecs
