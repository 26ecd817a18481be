"""Device-side batched agglomerate eigensolve: the device does the setup.

The dominant level-0 setup cost is the batched small symmetric eigensolve
(32768 x 125x125 at 2.1M dofs) plus the assembly of the dense agglomerate
batch it reads (about 2 GB at that size).  This module runs the whole
pipeline on the device as dense batched linear algebra, and only the
eigenvectors come back to the host:

  1. assembly as ONE einsum: on translation-invariant structured meshes the
     cell matrices factor as A_loc[c] = sum_q s[c,q] B_q (fem/geometry.py
     local_stiffness_matrices), so the agglomerate batch is
     A[a] = einsum('apq,pqij->aij', s_blocked, KPQ) with KPQ the per-
     (block-cell, quadrature) scatter of B_q — a (n_agg, 512) x (512, m^2)
     matmul.  Only the (n_cells, n_q) coefficient table is uploaded (67 MB
     at 2.1M dofs, against 2 GB for the assembled batch);
  2. smallest eigenpairs by Cholesky inverse subspace iteration: the pinned
     batch is SPD, L = cholesky(A + eps*I), and X <- L^-T L^-1 X with Gram
     re-orthonormalization converges in a few iterations because the
     smallest eigenvalues sit ~eps while the rest are O(1) — batched
     triangular solves and matmuls, no QR iteration anywhere;
  3. Rayleigh-Ritz in the n_probe-dim subspace (batched tiny eigh) selects
     the n_ev smallest; only the (n_agg, m, n_ev) eigenvectors come back to
     the host (33 MB at 2.1M dofs).

Every product runs at Precision.HIGHEST: on a GPU a DEFAULT float32 product
runs in TF32 (about 1e-3 relative error), which is above the Gram
Cholesky's 1e-5 jitter, so the re-orthonormalization could fail.

Reference analog: this is the cuSOLVER sygvd batching TODO the reference
left open (cuda/amge_device.templates.cuh:391-392), done as one program.
Semantics follow the host "pin" path (amge_host.templates.hpp:384-394):
mean-diagonal shift, constrained diagonal pinned to 200.
"""

from __future__ import annotations

import sys
from functools import partial

import jax
import numpy as np

from mfmg_tpu import backend

CONSTRAINED_DIAG = 200.0
# Probe columns and inverse-iteration steps.  Each step shrinks the error of
# the k-th Ritz pair by about (lam_k + eps) / (lam_{p+1} + eps) for p probe
# columns; the low spectrum of a 4x4x4-cell Q1 agglomerate is clustered
# (lam_2..lam_4, lam_5..lam_8), so with 8 probes and 8 steps the Rayleigh
# quotients stayed up to 6e-3 (relative to the mean diagonal) from LAPACK's
# and the subspaces up to 0.3 rad.  12 probes and 32 steps put them within
# 1e-9 and 1e-4 rad for up to 4 eigenvectors (tests/test_device_eig.py).
_N_PROBE = 12
_N_ITER = 32
_HI = jax.lax.Precision.HIGHEST


def supports(mesh, batch, agg_ids=None) -> bool:
    """Device path preconditions: a GPU, translation-invariant
    structured mesh, uniform blocks (no padding), factorized cell matrices,
    and — when agg_ids is given — the agglomeration IS the closed-form block
    partition (_structured_layout infers block dims from agglomerate 0's
    extent; a uniform-size NON-block partition, e.g. metis/zoltan on a
    structured mesh, could otherwise slip through on a shape coincidence and
    produce a silently wrong coarse space — advisor finding, round 4)."""
    if not backend.is_gpu():
        return False
    if not mesh.is_structured or mesh.dof_renumbered or mesh.hanging is not None:
        return False
    if not bool(np.all(batch.valid)):
        return False
    if agg_ids is not None:
        nc = np.asarray(mesh.structured_shape)
        mi = mesh.cell_multi_index()
        sel = agg_ids == agg_ids[0]
        bdims = mi[sel].max(axis=0) - mi[sel].min(axis=0) + 1
        if np.any(nc % bdims):
            return False
        n_agg_dim = nc // bdims
        stride = np.cumprod(np.concatenate([[1], n_agg_dim[:-1]]))
        expected = (mi // bdims) @ stride
        if not np.array_equal(expected, agg_ids):
            return False
    return True


def _structured_layout(mesh, agg_ids):
    """(cells_per_agg, local_cells) of the uniform block partition — the same
    closed-form index structure _try_build_structured uses."""
    from mfmg_tpu.fem.reference import reference_element

    nc = np.asarray(mesh.structured_shape)
    dim, k = mesh.dim, mesh.degree
    mi = mesh.cell_multi_index()
    sel = agg_ids == agg_ids[0]
    bdims = (mi[sel].max(axis=0) - mi[sel].min(axis=0) + 1)
    ref = reference_element(dim, k)
    lm = ref.local_multi_index
    m_dims = bdims * k + 1
    bc = np.stack(np.meshgrid(*[np.arange(b) for b in bdims], indexing="ij"),
                  axis=-1).reshape(-1, dim, order="F")
    lstride = np.cumprod(np.concatenate([[1], m_dims[:-1]]))
    local_cells = ((bc[:, None, :] * k + lm[None, :, :]) @ lstride).astype(np.int64)
    gstride = np.cumprod(np.concatenate([[1], nc[:-1]]))
    n_agg_dim = nc // bdims
    agg_origin = np.stack(np.meshgrid(*[np.arange(a) for a in n_agg_dim],
                                      indexing="ij"),
                          axis=-1).reshape(-1, dim, order="F") * bdims
    cells_per_agg = (agg_origin[:, None, :] + bc[None, :, :]) @ gstride
    m = int(np.prod(m_dims))
    return cells_per_agg, local_cells, m


def device_smallest_eigenpairs(problem, agg_ids, batch, n_ev: int,
                               keep_A: bool = False):
    """Device pipeline for the 'pin' constrained mode.  Returns
    (evals (n_agg, n_ev) f64, evecs (n_agg, m, n_ev) f64) like the host path
    (eigenvectors L2-normalized, zero at constrained dofs); with keep_A also
    the ELIMINATED+PINNED batch as a live device array (the Galerkin blocks
    consume it on-device, device_galerkin_blocks, so the 2 GB dense host
    batch is never assembled)."""
    import jax.numpy as jnp

    mesh = problem.mesh
    geom = problem.geom
    if geom.G_shared is None:
        return None
    cells_per_agg, local_cells, m = _structured_layout(mesh, agg_ids)
    n_agg, n_bc = cells_per_agg.shape
    n_q = geom.JxW.shape[1]

    # KPQ[p, q] = scatter of B_q at block position p  (m x m, built once)
    G1 = geom.G_shared                          # (q, dim, n_loc)
    B = np.einsum("qdi,qdj->qij", G1, G1)       # (q, n_loc, n_loc)
    KPQ = np.zeros((n_bc, n_q, m, m), dtype=np.float32)
    for p_i in range(n_bc):
        li = local_cells[p_i]
        KPQ[p_i][:, li[:, None], li[None, :]] += B.astype(np.float32)
    s = (geom.JxW * problem.coeff_at_q).astype(np.float32)   # (n_cells, n_q)
    s_blocked = s[cells_per_agg]                              # (n_agg, n_bc, n_q)

    con = batch.constrained                                   # (n_agg, m)
    keep = (~con).astype(np.float32)
    # mean-diagonal shift per agglomerate (host f64 diag already in batch)
    shifts = (batch.diag * batch.valid).sum(axis=1) / batch.sizes

    j = jnp.asarray
    # eps sets the per-step inverse-iteration amplification (lam2+eps)/eps.
    # Too small (1e-5) collapses every probe column onto v1 in ONE step and
    # the f32 Gram Cholesky goes singular (NaN, observed); 1e-2 amplifies
    # ~5x/step — gentle enough for stable re-orthonormalization.
    eps_rel = 1e-2

    @partial(jax.jit, static_argnames=("want_A",))
    def pipeline(s_blocked, KPQ, keep, shifts, want_A=False):
        # probe block generated ON DEVICE (saves a 131 MB (n_agg, m, 8)
        # f32 upload at 2.1M dofs)
        X0 = jax.random.normal(jax.random.PRNGKey(0), (n_agg, m, _N_PROBE),
                               dtype=jnp.float32) * keep[:, :, None]
        A = jnp.einsum("apq,pqij->aij", s_blocked, KPQ, precision=_HI)
        A = 0.5 * (A + jnp.swapaxes(A, 1, 2))
        # Dirichlet elimination + pin + shift (host-path semantics)
        km = keep[:, :, None] * keep[:, None, :]
        eye = jnp.eye(m, dtype=A.dtype)
        diag_raw = jnp.einsum("aii->ai", A)
        A = A * km
        # UNSHIFTED pinned matrix: the mean-diagonal shift of the host path
        # changes eigenvalues only (never eigenvectors) and would ruin the
        # inverse-iteration ratio ((lam1+shift)/(lamk+shift) ~ 0.9); against
        # the raw spectrum the ratio is (lam1+eps)/(lamk) ~ 1e-4 per step.
        pin_diag = jnp.where(keep > 0, diag_raw, CONSTRAINED_DIAG)
        A = A + (pin_diag - jnp.einsum("aii->ai", A))[:, :, None] * eye[None]
        # eps regularizes the exactly singular interior (pure-Neumann)
        # agglomerates for the Cholesky; sized just above f32 assembly noise
        A_solve = A + (eps_rel * shifts)[:, None, None] * eye[None]
        L = jnp.linalg.cholesky(A_solve)

        def body(i, X):
            Y = jax.lax.linalg.triangular_solve(L, X, left_side=True,
                                                lower=True)
            Y = jax.lax.linalg.triangular_solve(L, Y, left_side=True,
                                                lower=True, transpose_a=True)
            Y = Y * keep[:, :, None]
            # column-normalize, then Cholesky-orthonormalize the (unit-
            # diagonal) Gram with a jitter well above f32 roundoff
            cn = jnp.linalg.norm(Y, axis=1, keepdims=True)
            Y = Y / jnp.where(cn == 0, 1.0, cn)
            G = jnp.einsum("aik,ail->akl", Y, Y, precision=_HI)
            C = jnp.linalg.cholesky(G + 1e-5 * jnp.eye(_N_PROBE, dtype=G.dtype))
            return jax.lax.linalg.triangular_solve(
                C, Y, left_side=False, lower=True, transpose_a=True)

        X = jax.lax.fori_loop(0, _N_ITER, body, X0)
        T = jnp.einsum("aik,aij,ajl->akl", X, A, X, precision=_HI)
        T = 0.5 * (T + jnp.swapaxes(T, 1, 2))
        w, V = jnp.linalg.eigh(T)
        evals = w[:, :n_ev]
        evecs = jnp.einsum("aik,akl->ail", X, V[:, :, :n_ev], precision=_HI)
        nrm = jnp.linalg.norm(evecs, axis=1, keepdims=True)
        evecs = evecs / jnp.where(nrm == 0, 1.0, nrm)
        return (evals, evecs, A) if want_A else (evals, evecs, None)

    evals_d, evecs_d, A_dev = pipeline(j(s_blocked), j(KPQ), j(keep),
                                       j(shifts.astype(np.float32)),
                                       want_A=keep_A)
    # Rayleigh quotients of the UNSHIFTED matrix == the host path's
    # (shifted eigensolve, then subtract the shift)
    evals = np.asarray(evals_d, dtype=np.float64)
    evecs = np.asarray(evecs_d, dtype=np.float64)
    # the f32 fixed-step inverse iteration has no in-loop residual check and
    # CAN produce NaN (observed for too-small eps); a non-finite result must
    # surface as "no device result" so the caller's host fallback fires
    # instead of silently building a garbage coarse space
    if not (np.isfinite(evals).all() and np.isfinite(evecs).all()):
        print("[mfmg_tpu setup] device eigensolve gave non-finite eigenpairs; "
              "falling back to host LAPACK", file=sys.stderr, flush=True)
        return None
    evecs *= (batch.valid & ~batch.constrained)[:, :, None]
    if keep_A:
        return evals, evecs, A_dev
    return evals, evecs


def device_galerkin_blocks(batch_light, A_dev, dof_rows, dof_vals, n_rows):
    """AggBlocks with the BLAS-3 K = Rb A Rb^T on the device.

    The host builds only the index structure and the dense Rb values
    (native agg_row_blocks — no A_agg needed); Rb uploads, K comes back
    (t_max^2 per agglomerate, ~33 MB at 2.1M vs the 2 GB dense batch that
    the host BLAS path reads twice).  NOTE: A_dev carries the eigensolve's
    pinned constrained diagonal (200) instead of the raw assembled value —
    irrelevant to K because Rb rows are zero at constrained dofs
    (eliminate=False keeps PoU-weighted eigenvector values, and the
    eigenvectors are exactly zero there)."""
    import jax.numpy as jnp

    from mfmg_tpu.amge.multilevel import AggBlocks, agg_galerkin_blocks

    # reuse the host helper for the index structure + Rb, skipping K:
    # replicate its native path directly
    from mfmg_tpu import native
    dm = np.where(batch_light.valid, batch_light.dof_map, 0)
    keep = batch_light.valid
    nat = native.agg_row_blocks(dm, batch_light.valid, keep, dof_rows,
                                dof_vals)
    if nat is None:
        return None
    arows, t_s, Rb = nat
    Rb_d = jnp.asarray(Rb.astype(np.float32))
    K_d = jnp.einsum("atm,amn,asn->ats", Rb_d, A_dev, Rb_d, precision=_HI)
    K = np.asarray(K_d)          # f32: half the bytes of an f64 readback
    return AggBlocks(arows, t_s, Rb, K)
