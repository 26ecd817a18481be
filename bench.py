"""Benchmark harness: V-cycle DoF/s (+ SpMV nnz/s) on one NVIDIA GPU.

Prints ONE JSON line:
  {"metric": "vcycle_dof_per_s", "value": N, "unit": "DoF/s", "extra": {...}}

It refuses to run anywhere but on a GPU: a number taken on the CPU is not a
device number.  The card's name and power limit (nvidia-smi) go beside the
numbers, because a card set below its maximum power runs slower under load.

Measurement methodology: V-cycles inside ONE jitted lax.fori_loop, timed at
two trip counts; the slope is the per-cycle time, with the per-call launch
and synchronisation cost cancelled.

Config: 3D variable-coefficient Laplace, n_ref=6 (274625 dofs), Q1,
4x4x4-cell agglomerates, 2 eigenvectors, Chebyshev(2) smoother, stencil
operator + structured transfers + device-inverted dense coarse solve.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

import os as _env_os

N_REF = int(_env_os.environ.get("MFMG_BENCH_NREF", "6"))
N_CYCLES = 200
MAX_LEVELS = int(_env_os.environ.get("MFMG_BENCH_LEVELS", "3"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_cache_key(cfg, root=None) -> str:
    """Invalidation key for the on-disk large-bench hierarchy cache: a hash
    of every mfmg_tpu source file (content, sorted paths) + the dataclass
    repr of the Config.  Pure content hash — works in dirty git trees too."""
    import hashlib
    import os

    if root is None:
        root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "mfmg_tpu")
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames.sort()
        for fn in sorted(filenames):
            if fn.endswith((".py", ".cpp", ".so")):
                p = os.path.join(dirpath, fn)
                h.update(p.encode())
                with open(p, "rb") as f:
                    h.update(f.read())
    h.update(repr(cfg).encode())
    return h.hexdigest()[:16]


def _measure_large(cycles_fn_template=None):
    """2.15M-dof block (bench_large.py config) folded into the driver bench:
    129^3 stencil fine level, 3-level AMGe, bf16 coefficient planes.  Runs
    after the main metric with a time budget; any failure is recorded, never
    fatal."""
    import os
    from functools import partial

    import jax
    import jax.numpy as jnp

    from mfmg_tpu import Config, Hierarchy, LaplaceProblem
    from mfmg_tpu.amge.hierarchy import _vcycle
    from mfmg_tpu.config import (AgglomerationConfig, CoarseConfig,
                                 SmootherConfig)

    from mfmg_tpu.config import EigensolverConfig

    t0 = time.perf_counter()
    prob = LaplaceProblem.hyper_cube(3, 7, material_property="linear")
    # SAME configuration as the 274k flagship (incl. deep=4 coarse-space
    # enrichment): PCG counts are comparable across sizes.
    cfg = Config(max_levels=3, operator="stencil", dtype="float32",
                 coeff_dtype="bfloat16",
                 eigensolver=EigensolverConfig(n_eigenvectors=2,
                                               n_eigenvectors_deep=4),
                 smoother=SmootherConfig(type="chebyshev", degree=2),
                 agglomeration=AgglomerationConfig(nx=4, ny=4, nz=4),
                 coarse=CoarseConfig(type="direct"))
    # hierarchy cache: the first run saves the built hierarchy; later runs
    # load it and skip the setup.  setup_s always reports the FRESH build time (from
    # the sidecar on cache hits) — it is itself a tracked metric.  The cache
    # is KEYED on a hash of the mfmg_tpu source tree + the serialized config:
    # any setup-affecting commit invalidates it, so the bench can never run
    # on a stale hierarchy or report a stale setup_s.
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".bench_large_hier.npz")
    sidecar = cache + ".meta.json"
    key = bench_cache_key(cfg)
    cached = None
    if os.path.exists(cache) and os.path.exists(sidecar):
        with open(sidecar) as f:
            meta = json.load(f)
        if meta.get("key") == key:
            try:
                cached = Hierarchy.load(cache, prob)
                setup_s = meta["fresh_setup_s"]
            except Exception as e:
                log(f"large cache load failed (rebuilding): {e!r}")
        else:
            log("large cache stale (source/config changed) — rebuilding")
    if cached is not None:
        hier = cached
        log(f"large: loaded cached hierarchy ({time.perf_counter()-t0:.1f}s "
            f"incl. problem build; fresh setup was {setup_s:.1f}s)")
    else:
        t1 = time.perf_counter()
        hier = Hierarchy(prob, cfg)
        setup_s = time.perf_counter() - t1
        try:
            hier.save(cache)
            with open(sidecar, "w") as f:
                json.dump({"fresh_setup_s": setup_s, "key": key}, f)
        except Exception as e:
            log(f"large cache save failed: {e!r}")
        log(f"large setup: n_dofs={prob.n_dofs} t={setup_s:.1f}s")

    levels = tuple(hier.levels)
    nss = cfg.smoother.n_smoothing_steps

    @partial(jax.jit, static_argnames=("n",))
    def cycles(levels, b, x, n):
        def body(i, x):
            return _vcycle(levels, b, x, 0, nss, False)
        return jax.lax.fori_loop(0, n, body, x)

    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.uniform(size=prob.n_dofs).astype(np.float32))

    def _fresh():
        seed = int.from_bytes(os.urandom(4), "little")
        v = jnp.asarray(np.random.default_rng(seed).uniform(
            size=prob.n_dofs).astype(np.float32))
        jax.block_until_ready(v)
        return v

    def timed(n):
        v = _fresh()
        t1 = time.perf_counter()
        out = cycles(levels, b, v, n)
        assert np.isfinite(float(jnp.vdot(out, out)))
        return time.perf_counter() - t1

    def _two_point(tfun, n_lo, n_hi):
        tfun(n_lo), tfun(n_hi)
        slopes = []
        for _ in range(6):
            tl, th = tfun(n_lo), tfun(n_hi)
            if 0 < tl < th:
                slopes.append((th - tl) / (n_hi - n_lo))
            if len(slopes) >= 3:
                break
        return float(np.median(slopes))

    N_LO, N_HI = 10, 60
    dt = _two_point(timed, N_LO, N_HI)
    xs, info = hier.solve_cg(b, tol=1e-5, maxiter=50)
    log(f"large: {dt*1e3:.2f} ms/cycle -> {prob.n_dofs/dt:.3e} DoF/s, "
        f"pcg {int(info['iterations'])}")

    return {"n_dofs": prob.n_dofs, "ms_per_vcycle": dt * 1e3,
            "dof_per_s": prob.n_dofs / dt, "setup_s": setup_s,
            "pcg_iterations": int(info["iterations"])}


def main():
    import jax
    import jax.numpy as jnp

    t0 = time.perf_counter()
    from mfmg_tpu import Config, Hierarchy, LaplaceProblem
    from mfmg_tpu.amge.hierarchy import _vcycle
    from mfmg_tpu.config import AgglomerationConfig, CoarseConfig, SmootherConfig
    from mfmg_tpu.solve.operator import apply_op

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench.py measures a GPU; JAX found {dev.platform!r}")
        sys.exit(1)
    from mfmg_tpu.backend import gpu_name_and_power_limit
    card = gpu_name_and_power_limit()
    log(f"device: {dev.platform} {dev.device_kind} ({card})")

    prob = LaplaceProblem.hyper_cube(3, N_REF, material_property="linear")
    # bf16 coefficient planes halve the dominant HBM stream of the V-cycle
    # preconditioner; the outer CG residual uses the exact f32 operator
    # (Hierarchy._exact_fine_op).  deep=4 eigenvectors per super-agglomerate
    # enrich the deeper coarse spaces.
    from mfmg_tpu.config import EigensolverConfig
    cfg = Config(operator="stencil", dtype="float32", max_levels=MAX_LEVELS,
                 coeff_dtype="bfloat16",
                 eigensolver=EigensolverConfig(n_eigenvectors=2,
                                               n_eigenvectors_deep=4),
                 smoother=SmootherConfig(type="chebyshev", degree=2),
                 agglomeration=AgglomerationConfig(nx=4, ny=4, nz=4),
                 coarse=CoarseConfig(type="direct"))
    hier = Hierarchy(prob, cfg)
    setup_s = time.perf_counter() - t0
    nnz = hier._A_nnzs[0]       # stencil nonzeros; global A never assembled
    log(f"setup: n_dofs={prob.n_dofs} nnz={nnz} t={setup_s:.1f}s")

    rng = np.random.default_rng(0)
    b = rng.uniform(size=prob.n_dofs).astype(np.float32)
    b[prob.constrained] = 0.0
    b = jnp.asarray(b)

    levels = tuple(hier.levels)
    nss = cfg.smoother.n_smoothing_steps

    # level arrays are jit ARGUMENTS, not closure constants, so they are not
    # embedded in the compiled program
    from functools import partial

    @partial(jax.jit, static_argnames=("n",))
    def cycles(levels, b, x, n):
        def body(i, x):
            return _vcycle(levels, b, x, 0, nss, False)
        return jax.lax.fori_loop(0, n, body, x)

    import os as _os

    def _fresh():
        seed = int.from_bytes(_os.urandom(4), "little")
        v = jnp.asarray(np.random.default_rng(seed).uniform(
            size=prob.n_dofs).astype(np.float32))
        jax.block_until_ready(v)
        return v

    def _timed(n):
        """One executable call on a fresh random input; returns wall time.

        Two-point measurement (T(N_HI)-T(N_LO))/(N_HI-N_LO) cancels per-call
        dispatch overhead; the checksum forces completion."""
        v = _fresh()
        t0 = time.perf_counter()
        out = cycles(levels, b, v, n)
        cs = float(jnp.vdot(out, out))
        assert np.isfinite(cs)
        return time.perf_counter() - t0

    N_LO, N_HI = 20, N_CYCLES

    def _two_point(timed_fn, n_lo, n_hi, n_samples=4):
        """Median of per-attempt (T(n_hi)-T(n_lo))/(n_hi-n_lo) slopes.

        A single positive difference can be pure dispatch jitter; the median
        over several attempts is robust to both signs of that noise."""
        slopes = []
        for _attempt in range(2 * n_samples):
            t_lo, t_hi = timed_fn(n_lo), timed_fn(n_hi)
            if 0 < t_lo < t_hi:
                slopes.append((t_hi - t_lo) / (n_hi - n_lo))
            if len(slopes) >= n_samples:
                break
        assert slopes, "could not obtain a consistent timing"
        return float(np.median(slopes)), t_lo, t_hi

    # warmup-compile both trip counts
    _timed(N_LO), _timed(N_HI)
    dt, t_lo, t_hi = _two_point(_timed, N_LO, N_HI)
    dof_s = prob.n_dofs / dt
    log(f"vcycle: {dt*1e3:.3f} ms/cycle -> {dof_s:.3e} DoF/s "
        f"(t_lo={t_lo*1e3:.1f}ms t_hi={t_hi*1e3:.1f}ms)")

    # SpMV nnz/s on the fine stencil operator, same two-point method
    op = levels[0].op

    @partial(jax.jit, static_argnames=("n",))
    def spmvs(op, x, n):
        return jax.lax.fori_loop(0, n, lambda i, y: apply_op(op, y) / 27.0, x)

    def _timed_s(n):
        v = _fresh()
        t0 = time.perf_counter()
        out = spmvs(op, v, n)
        cs = float(jnp.vdot(out, out))
        assert np.isfinite(cs)
        return time.perf_counter() - t0

    S_LO, S_HI = 500, 5000
    _timed_s(S_LO), _timed_s(S_HI)
    spmv_dt, t_lo, t_hi = _two_point(_timed_s, S_LO, S_HI)
    nnz_s = nnz / spmv_dt
    log(f"spmv: {spmv_dt*1e3:.3f} ms -> {nnz_s:.3e} nnz/s")

    # solution sanity: preconditioned CG converges
    xs, info = hier.solve_cg(b, tol=1e-5, maxiter=50)
    iters = int(info["iterations"])
    log(f"pcg: {iters} iterations, relres {float(info['relres']):.2e}")

    # ---- large (2.1M-dof) block, time-budgeted
    large = None
    import os as _os2
    if (not _os2.environ.get("MFMG_BENCH_SKIP_LARGE")
            and time.perf_counter() - t0 < 2400):
        try:
            large = _measure_large(cycles_fn_template=None)
        except Exception as e:
            log(f"large block failed: {e!r}")
            large = {"error": repr(e)}

    # Speed-of-light accounting: COMPULSORY HBM bytes each V-cycle must move
    # (operator data + in/out vectors once per apply; transfer matrices once
    # per direction; coarse inverse once).  This is a lower bound — it
    # ignores intermediate vector traffic XLA fails to fuse — so
    # bytes/time is a lower bound on achieved bandwidth.  The roofline it is
    # compared against is measured IN THIS HARNESS by a triad kernel
    # (a = b + s*a over a large stream), not quoted from a datasheet.
    def _op_bytes(op):
        n = op.shape[0]
        from mfmg_tpu.ops.block_stencil import BlockStencilOperator
        from mfmg_tpu.ops.sparse import ELLMatrix
        from mfmg_tpu.ops.stencil import StencilOperator
        if isinstance(op, StencilOperator):
            data = op.coeffs.size * op.coeffs.dtype.itemsize
        elif isinstance(op, BlockStencilOperator):
            data = op.K.size * op.K.dtype.itemsize
        elif isinstance(op, ELLMatrix):
            data = (op.vals.size * op.vals.dtype.itemsize
                    + op.cols.size * op.cols.dtype.itemsize)
        else:                                   # matrix-free: cell data
            data = sum(int(np.prod(a.shape)) * a.dtype.itemsize
                       for a in jax.tree_util.tree_leaves(op))
        return data + 2 * n * 4                 # + read x, write y

    def _coarse_bytes(solver):
        inv = getattr(solver, "inv", None)
        if inv is not None:
            return int(np.prod(inv.shape)) * inv.dtype.itemsize
        nested = getattr(solver, "levels", None)  # AMG coarse: nested cycle
        return sum(_level_bytes(l) for l in nested) if nested else 0

    def _level_bytes(lvl):
        if lvl.coarse is not None:
            return _coarse_bytes(lvl.coarse)
        n_l = lvl.op.shape[0]
        deg = cfg.smoother.degree
        nss = cfg.smoother.n_smoothing_steps
        # Chebyshev smoother.apply = 1 residual apply + (deg-1) inner applies
        # = deg operator applies per smoothing step (pre + post), plus the
        # V-cycle residual.  (Round 2 counted 2*deg-1 per step — an
        # overstatement that inflated pct_of_sol.)
        n_apply = 2 * nss * deg + 1
        b = n_apply * _op_bytes(lvl.op)
        b += 2 * nss * deg * n_l * 4            # inv-diag reads per cheb term
        if lvl.transfer is not None:
            b += sum(int(np.prod(a.shape)) * a.dtype.itemsize
                     for a in jax.tree_util.tree_leaves(lvl.transfer))
        else:
            b += (lvl.R.vals.size + lvl.R.cols.size
                  + lvl.RT.vals.size + lvl.RT.cols.size) * 4
        return b

    bytes_cycle = sum(_level_bytes(lvl) for lvl in levels)

    # triad roofline: a = b + s*a, 3 street accesses of m floats per iter
    m = 32 * 1024 * 1024
    tb = jnp.ones((m,), jnp.float32)

    @partial(jax.jit, static_argnames=("n",))
    def triad(a, b, n):
        return jax.lax.fori_loop(0, n, lambda i, a: b + 0.999 * a, a)

    def _timed_t(n):
        a = _fresh_triad()
        t0 = time.perf_counter()
        out = triad(a, tb, n)
        assert np.isfinite(float(out[0]))
        return time.perf_counter() - t0

    def _fresh_triad():
        v = jnp.full((m,), float(np.random.default_rng().uniform()), jnp.float32)
        jax.block_until_ready(v)
        return v

    T_LO, T_HI = 50, 500
    _timed_t(T_LO), _timed_t(T_HI)
    triad_dt, _, _ = _two_point(_timed_t, T_LO, T_HI)
    triad_bw = 3 * m * 4 / triad_dt / 1e9
    achieved = bytes_cycle / dt / 1e9
    pct_sol = 100.0 * achieved / triad_bw
    log(f"speed-of-light: {bytes_cycle/1e6:.1f} MB compulsory/cycle in "
        f"{dt*1e3:.2f} ms -> >= {achieved:.0f} GB/s achieved vs "
        f"{triad_bw:.0f} GB/s triad roofline ({pct_sol:.0f}% of SoL)")

    log(f"card: {card}")
    print(json.dumps({"metric": "vcycle_dof_per_s", "value": dof_s,
                      "unit": "DoF/s",
                      "extra": {"device": {"platform": dev.platform,
                                           "kind": dev.device_kind,
                                           "count": len(jax.devices()),
                                           "name_power_limit": card},
                                "spmv_nnz_per_s": nnz_s,
                                "n_dofs": prob.n_dofs,
                                "ms_per_vcycle": dt * 1e3,
                                "setup_s": setup_s,
                                "pct_of_sol": pct_sol,
                                "triad_gb_s": triad_bw,
                                "pcg_iterations": iters,
                                "large": large}}))


if __name__ == "__main__":
    main()
