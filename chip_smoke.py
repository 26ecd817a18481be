"""Smoke test of the solver's main path on an NVIDIA GPU.

    python chip_smoke.py              # one GPU: phases 1-6 at 274k and 2.1M dofs
    python chip_smoke.py --four       # four GPUs: the sharded V-cycle (phase 7)
    python chip_smoke.py --trace DIR  # one GPU: per-layer device time of a
                                      # traced window of V-cycles

It drives the flagship configuration (3D variable-coefficient Laplace, Q1,
stencil operator with bf16 coefficient planes, 3-level AMGe with 2/4
eigenvectors, Chebyshev(2), 4x4x4 agglomerates, direct coarse solve) through
`Hierarchy`, `vcycle` and `Hierarchy.solve_cg`, and checks each phase
against a plain reference:

  1. device      the platform is "gpu"; the card's name and power limit
  2. stencil     the fine stencil apply against scipy float64 `A @ x`
  3. setup       hierarchy setup; device eigenpairs against host LAPACK
  4. vcycle      one V-cycle against the same cycle at HIGHEST precision
  5. pcg         V-cycle-preconditioned CG; true residual in float64
  6. timing      ms per V-cycle and peak device memory (printed, not checked)
  7. --four      slab and pencil SPMD V-cycles and a GSPMD CG step on four
                 cards, against one device

Every phase prints one line.  The last line of standard output is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}} when every
phase passed; {"ok": false, "phase": ..., "error": ...} and exit code 1
otherwise, including when JAX finds no GPU.  Everything runs in this one
process (one JAX process per card).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time
import traceback

import numpy as np

SIZES = (6, 7)                   # n_ref: 65^3 = 274,625 and 129^3 = 2,146,689
STENCIL_F32_BOUND = 1e-5         # float32 planes: rounding of planes and x
STENCIL_BF16_BOUND = 1e-2        # bf16 planes keep 8 bits
EIG_RQ_BOUND = 1e-4              # Rayleigh quotient error / mean diagonal
EIG_ANGLE_BOUND = 1e-3           # rad, against the host invariant subspace
EIG_CLUSTER = 1e-2               # eigenvalues closer than this (relative to
                                 # the mean diagonal) form one cluster
EIG_SAMPLE = 64                  # agglomerates compared with host LAPACK
VCYCLE_BOUND = 2e-2              # TF32 products + bf16 planes, preconditioner
PCG_TOL = 1e-5
PCG_ROUNDINGS = 8                # the true residual of a float32 solution
                                 # sits above tol by the float32 floor (see
                                 # float32_floor): CG's <= 12 rounded updates
                                 # of x add up like a random walk (~3.5
                                 # roundings), times a 2x margin
PCG_MAX_ITERS = 12               # guard: 9 iterations expected at both sizes
SPMD_ATOL = 1e-5                 # times max|x|, same-precision comparison
GSPMD_RTOL = 1e-4                # float32 dot products over the whole grid,
                                 # summed in another order across shards
TIMING_CYCLES = {6: 50, 7: 20}


class PhaseFailed(Exception):
    pass


class Phases:
    """Names the phase that is running, so a failure can say where."""

    def __init__(self):
        self.current = "start"

    def start(self, name):
        self.current = name

    def say(self, msg):
        print(f"[{self.current}] {msg}", flush=True)

    def check(self, ok, msg):
        if not ok:
            raise PhaseFailed(msg)


# ------------------------------------------------------ comparison helpers --
def rel_max_err(y, ref):
    """max|y - ref| / max|ref| (float64)."""
    y = np.asarray(y, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(y - ref).max() / np.abs(ref).max())


def rel_l2(y, ref):
    y = np.asarray(y, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.linalg.norm(y - ref) / np.linalg.norm(ref))


def largest_angle(U, V):
    """Largest principal angle (rad) between span(U) and the subspace
    span(V) ⊇ it should lie in: asin ||(I - Q_V Q_V^T) Q_U||_2."""
    Qu, _ = np.linalg.qr(np.asarray(U, dtype=np.float64))
    Qv, _ = np.linalg.qr(np.asarray(V, dtype=np.float64))
    s = np.linalg.norm(Qu - Qv @ (Qv.T @ Qu), 2)
    return float(np.arcsin(min(1.0, s)))


def compare_eigenpairs(A, evecs, ref_evals, ref_evecs, n_ev, scale):
    """Device eigenvectors against a float64 host reference on a batch of
    dense matrices.

    A: (n, m, m); evecs: (n, m, n_ev) under test; ref_evals/ref_evecs: the
    host's smallest eigenpairs, at least n_ev of them; scale: (n,) spectral
    scale (mean diagonal).  Returns (max Rayleigh-quotient error relative to
    scale, max angle to the host invariant subspace, max plain angle).  The
    host subspace is extended by the eigenvectors whose eigenvalues lie
    within EIG_CLUSTER * scale of the n_ev-th: inside such a cluster any
    basis is an equally valid coarse space, and the angle to the n_ev-dim
    host subspace alone measures the gap, not the solver."""
    A = np.asarray(A, dtype=np.float64)
    V = np.asarray(evecs, dtype=np.float64)
    rq = (np.einsum("aik,aij,ajk->ak", V, A, V)
          / np.einsum("aik,aik->ak", V, V))
    rq_err = float((np.abs(rq - ref_evals[:, :n_ev])
                    / scale[:, None]).max())
    angle = plain = 0.0
    for a in range(A.shape[0]):
        k = n_ev
        while (k < ref_evals.shape[1] and ref_evals[a, k] - ref_evals[a, n_ev - 1]
               <= EIG_CLUSTER * scale[a]):
            k += 1
        angle = max(angle, largest_angle(V[a], ref_evecs[a, :, :k]))
        plain = max(plain, largest_angle(V[a], ref_evecs[a, :, :n_ev]))
    return rq_err, angle, plain


def flagship_config():
    from mfmg_tpu import Config
    from mfmg_tpu.config import (AgglomerationConfig, CoarseConfig,
                                 EigensolverConfig, SmootherConfig)
    return Config(max_levels=3, operator="stencil", dtype="float32",
                  coeff_dtype="bfloat16",
                  eigensolver=EigensolverConfig(n_eigenvectors=2,
                                                n_eigenvectors_deep=4),
                  smoother=SmootherConfig(type="chebyshev", degree=2),
                  agglomeration=AgglomerationConfig(nx=4, ny=4, nz=4),
                  coarse=CoarseConfig(type="direct"))


def float32_floor(A, x, b, seed=0):
    """||A e|| / ||b|| for e one float32 rounding of x (uniform in +-2^-24
    |x|): how far from b any float32 vector near the solution must stay."""
    x = np.asarray(x, dtype=np.float64)
    e = np.random.default_rng(seed).uniform(-1.0, 1.0, x.shape) * 2.0 ** -24 * np.abs(x)
    return float(np.linalg.norm(A @ e) / np.linalg.norm(b))


def random_rhs(prob, seed):
    b = np.random.default_rng(seed).uniform(size=prob.n_dofs)
    b[prob.constrained] = 0.0
    return b


@contextlib.contextmanager
def highest_precision():
    """Exact float32 products everywhere: the context manager covers every
    DEFAULT-precision dot, MFMG_TRANSFER_HI the transfers' explicit
    Precision.DEFAULT (ops/structured_transfer.py)."""
    import jax
    old = os.environ.get("MFMG_TRANSFER_HI")
    os.environ["MFMG_TRANSFER_HI"] = "1"
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        if old is None:
            del os.environ["MFMG_TRANSFER_HI"]
        else:
            os.environ["MFMG_TRANSFER_HI"] = old


def build_hierarchy(prob, cfg):
    """Hierarchy(prob, cfg) with its MFMG_TPU_VERBOSE stage marks captured;
    returns (hierarchy, seconds, 'stage 1.2s | ...')."""
    from mfmg_tpu import Hierarchy
    buf = io.StringIO()
    old = os.environ.get("MFMG_TPU_VERBOSE")
    os.environ["MFMG_TPU_VERBOSE"] = "1"
    try:
        with contextlib.redirect_stderr(buf):
            t0 = time.perf_counter()
            hier = Hierarchy(prob, cfg)
            secs = time.perf_counter() - t0
    finally:
        if old is None:
            del os.environ["MFMG_TPU_VERBOSE"]
        else:
            os.environ["MFMG_TPU_VERBOSE"] = old
    marks = [ln.split("] ", 1)[1] for ln in buf.getvalue().splitlines()
             if ln.startswith("[mfmg_tpu setup]")]
    other = [ln for ln in buf.getvalue().splitlines()
             if not ln.startswith("[mfmg_tpu setup]")]
    if other:
        print("\n".join(other), file=sys.stderr, flush=True)
    return hier, secs, " | ".join(marks)


# ------------------------------------------------------------------ phases --
def phase_device(ph):
    import jax
    ph.start("1 device")
    dev = jax.devices()[0]
    ph.check(dev.platform == "gpu",
             f"JAX found platform {dev.platform!r}, not 'gpu'")
    from mfmg_tpu.backend import gpu_name_and_power_limit
    from mfmg_tpu.utils.cache import compilation_cache_dir, enable_compilation_cache
    enable_compilation_cache()
    card = gpu_name_and_power_limit()
    ph.say(f"platform {dev.platform}, kind {dev.device_kind}, "
           f"{len(jax.devices())} device(s), jax {jax.__version__}, "
           f"compile cache {compilation_cache_dir()}; nvidia-smi: {card}")
    return dev, card


def phase_stencil(ph, prob, label):
    import jax.numpy as jnp
    from mfmg_tpu.ops.stencil import stencil_apply, stencil_from_cell_matrices
    ph.start(f"2 stencil {label}")
    x = np.random.default_rng(3).uniform(size=prob.n_dofs)
    y_ref = prob.A @ x
    out = []
    for name, dt, bound in (("float32", jnp.float32, STENCIL_F32_BOUND),
                            ("bf16", jnp.bfloat16, STENCIL_BF16_BOUND)):
        op = stencil_from_cell_matrices(prob.mesh, prob.A_loc,
                                        prob.constrained, prob.diag_raw,
                                        dtype=dt)
        y = stencil_apply(op, jnp.asarray(x, dtype=jnp.float32))
        err = rel_max_err(y, y_ref)
        out.append(f"{name} planes rel max err {err:.3e} (bound {bound:g})")
        ph.check(err <= bound, out[-1])
    ph.say(f"n_dofs {prob.n_dofs}: " + "; ".join(out))


def phase_setup(ph, prob, cfg, label):
    ph.start(f"3 setup {label}")
    hier, secs, marks = build_hierarchy(prob, cfg)
    ph.say(f"setup {secs:.2f} s, level-0 eigensolve on {hier.eig_path}, "
           f"levels {len(hier.levels)}, marks: {marks}")
    ph.check(hier.eig_path == "device",
             "the level-0 eigensolve did not run on the device")
    return hier


def phase_eigen(ph, prob, cfg, label):
    """Device eigensolve against host LAPACK: accuracy on a sample of
    agglomerates, and both paths' times on the whole batch."""
    from mfmg_tpu.amge.agglomeration import build_agglomerates
    from mfmg_tpu.amge.local_problems import build_agglomerate_batch
    from mfmg_tpu.eigen import device_eig
    from mfmg_tpu.eigen.batched_eigh import batched_smallest_eigenpairs
    ph.start(f"3 eigensolve {label}")
    n_ev = cfg.eigensolver.n_eigenvectors
    agg_ids = build_agglomerates(prob.mesh, cfg.agglomeration)

    def device_path():
        light = build_agglomerate_batch(prob.mesh, prob.A_loc, agg_ids,
                                        batch_dtype=np.float32,
                                        assemble_operator=False)
        ph.check(device_eig.supports(prob.mesh, light, agg_ids),
                 "device_eig.supports() refused the flagship mesh")
        out = device_eig.device_smallest_eigenpairs(prob, agg_ids, light, n_ev)
        ph.check(out is not None, "device eigensolve returned no result")
        return out

    t0 = time.perf_counter()
    device_path()
    t_dev_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    evals, evecs = device_path()
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    full = build_agglomerate_batch(prob.mesh, prob.A_loc, agg_ids,
                                   batch_dtype=np.float32)
    batched_smallest_eigenpairs(full, n_ev, constrained_mode="pin",
                                host_dtype=np.float32)
    t_host = time.perf_counter() - t0
    del full

    n_agg = evals.shape[0]
    sample = np.unique(np.linspace(0, n_agg - 1, EIG_SAMPLE).astype(np.int64))
    ref = build_agglomerate_batch(prob.mesh, prob.A_loc, agg_ids,
                                  batch_dtype=np.float64, agg_range=sample)
    ref_evals, ref_evecs = batched_smallest_eigenpairs(
        ref, n_ev + 6, constrained_mode="pin", host_dtype=np.float64)
    scale = (ref.diag * ref.valid).sum(axis=1) / ref.sizes
    rq_err, angle, plain = compare_eigenpairs(
        ref.A_agg, evecs[sample], ref_evals, ref_evecs, n_ev, scale)
    msg = (f"{n_agg} agglomerates x {n_ev}: device {t_dev:.2f} s "
           f"(first call {t_dev_first:.2f} s incl. compile), host LAPACK "
           f"{t_host:.2f} s (assembly + syevx); on {len(sample)} sampled "
           f"agglomerates: Rayleigh quotient rel err {rq_err:.2e} "
           f"(bound {EIG_RQ_BOUND:g}), largest angle to the host invariant "
           f"subspace {angle:.2e} rad (bound {EIG_ANGLE_BOUND:g}; clusters "
           f"within {EIG_CLUSTER:g} x mean diagonal), to the {n_ev}-dim host "
           f"subspace alone {plain:.2e} rad")
    ph.check(rq_err <= EIG_RQ_BOUND and angle <= EIG_ANGLE_BOUND, msg)
    ph.say(msg)


def phase_vcycle(ph, prob, hier, label, with_rate):
    import jax.numpy as jnp
    from mfmg_tpu.amge.hierarchy import measure_vcycle_rate, vcycle
    ph.start(f"4 vcycle {label}")
    nss = hier.config.smoother.n_smoothing_steps
    b = jnp.asarray(random_rhs(prob, 1), dtype=jnp.float32)
    x0 = jnp.zeros_like(b)
    x = vcycle(hier.levels, b, x0, n_smoothing_steps=nss, is_preconditioner=True)
    with highest_precision():
        x_hi = vcycle(hier.levels, b, x0, n_smoothing_steps=nss,
                      is_preconditioner=True)
    ph.check(bool(jnp.all(jnp.isfinite(x))), "non-finite V-cycle output")
    diff = rel_l2(x, x_hi)
    msg = (f"DEFAULT vs HIGHEST precision rel L2 diff {diff:.3e} "
           f"(bound {VCYCLE_BOUND:g})")
    if with_rate:
        msg += f"; measure_vcycle_rate {measure_vcycle_rate(hier, 20):.4f}"
    ph.check(diff <= VCYCLE_BOUND, msg)
    ph.say(msg)


def phase_pcg(ph, prob, hier, label):
    import jax.numpy as jnp
    ph.start(f"5 pcg {label}")
    b = random_rhs(prob, 2)
    bj = jnp.asarray(b, dtype=jnp.float32)
    t0 = time.perf_counter()
    x, info = hier.solve_cg(bj, tol=PCG_TOL, maxiter=50)
    x.block_until_ready()
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = hier.solve_cg(bj, tol=PCG_TOL, maxiter=50)
    x.block_until_ready()
    t_solve = time.perf_counter() - t0
    iters = int(info["iterations"])
    r = b - prob.A @ np.asarray(x, dtype=np.float64)
    true_rel = float(np.linalg.norm(r) / np.linalg.norm(b))
    floor = float32_floor(prob.A, x, b)
    slack = PCG_ROUNDINGS * floor / PCG_TOL
    bound = PCG_TOL * (1.0 + slack)
    msg = (f"{iters} iterations (guard {PCG_MAX_ITERS}), recursive relres "
           f"{float(info['relres']):.3e}, true float64 relres {true_rel:.3e} "
           f"(bound {bound:.3e} = tol x (1 + slack {slack:.3f}); slack = "
           f"{PCG_ROUNDINGS} x float32 floor {floor:.3e} / tol), "
           f"solve {t_solve * 1e3:.1f} ms (first call {t_first:.2f} s)")
    ph.check(iters <= PCG_MAX_ITERS and true_rel <= bound, msg)
    ph.say(msg)


def cycles_program():
    """jit(n cycles of vcycle in one lax.fori_loop)."""
    from functools import partial

    import jax

    from mfmg_tpu.amge.hierarchy import vcycle

    @partial(jax.jit, static_argnames=("n", "nss"))
    def cycles(levels, b, x, n, nss):
        return jax.lax.fori_loop(
            0, n, lambda i, x: vcycle(levels, b, x, n_smoothing_steps=nss,
                                      is_preconditioner=False), x)
    return cycles


def phase_timing(ph, prob, hier, label, n_ref, card):
    import jax
    import jax.numpy as jnp
    ph.start(f"6 timing {label}")
    cycles = cycles_program()
    nss = hier.config.smoother.n_smoothing_steps
    n = TIMING_CYCLES.get(n_ref, 20)
    levels = tuple(hier.levels)
    b = jnp.asarray(random_rhs(prob, 4), dtype=jnp.float32)
    x0 = jnp.zeros_like(b)
    cycles(levels, b, x0, n=n, nss=nss).block_until_ready()    # compile
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        cycles(levels, b, x0, n=n, nss=nss).block_until_ready()
        ms.append((time.perf_counter() - t0) * 1e3 / n)
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    ph.say(f"{np.median(ms):.4f} ms per V-cycle (median of 5 windows of {n} "
           f"cycles: {', '.join(f'{v:.4f}' for v in ms)}), "
           f"{prob.n_dofs / (np.median(ms) * 1e-3):.4e} DoF/s, "
           f"peak_bytes_in_use {peak}; card {card}")


# ----------------------------------------------------------------- tracing --
def layer_bytes(hier):
    """Compulsory device-memory bytes per V-cycle stage (stage_key names):
    what an ideal fused implementation must read and write once.  Operator
    data (planes, block-stencil tensors, transfer weights, the coarse
    inverse) at its stored width; vectors at the hierarchy dtype."""
    import jax
    vb = np.dtype(hier.dtype).itemsize
    deg = hier.config.smoother.degree
    nss = hier.config.smoother.n_smoothing_steps

    def nbytes(tree):
        return sum(int(np.prod(a.shape)) * a.dtype.itemsize
                   for a in jax.tree_util.tree_leaves(tree))

    out = {}
    for l, lvl in enumerate(hier.levels):
        n = lvl.op.shape[0] * vb
        if lvl.coarse is not None:
            out[f"L{l}/coarse_solve"] = nbytes(lvl.coarse) + 2 * n
            continue
        # a block stencil's apply reads only its patches-layout tensor K
        K = getattr(lvl.op, "K", None)
        op = nbytes(lvl.op if K is None else K)
        # pre + post: deg applies each, + inv_diag, b, x
        out[f"L{l}/smooth"] = 2 * nss * (deg * (op + 2 * n) + 3 * n)
        out[f"L{l}/residual"] = op + 3 * n
        tr = lvl.transfer if lvl.transfer is not None else (lvl.R, lvl.RT)
        nc = hier.levels[l + 1].op.shape[0] * vb
        out[f"L{l}/restrict"] = nbytes(tr) // (1 if lvl.transfer is not None else 2) + n + nc
        out[f"L{l}/prolong"] = out[f"L{l}/restrict"] + n
    return out


def stage_key(scope):
    """Reporting stage of a named scope: XLA gives identical fusions one
    kernel (and one kernel name), so pre- and post-smoothing kernels cannot
    be told apart in a trace; both count as "L<l>/smooth"."""
    return scope.replace("presmooth", "smooth").replace("postsmooth", "smooth")


def hlo_scopes(hlo_text):
    """{HLO instruction name: "L<l>/<stage>"} from a compiled program's text.

    An instruction's own op_name gives its stage.  A fusion that merged ops
    of several stages keeps no op_name, or only their common prefix; it is
    given the stage of the ROOT of the computation it calls (the value it
    produces), else the stage most of that computation's ops carry,
    following nested fusions."""
    import re
    from collections import Counter

    stage_re = re.compile(r"(L\d+/[a-z_]+)")
    inst_re = re.compile(r"^\s*(ROOT\s+)?%([\w.\-]+) = .*$")
    own, calls, root_of, votes, comp = {}, {}, {}, {}, None
    for line in hlo_text.splitlines():
        head = re.match(r"^(?:ENTRY\s+)?%([\w.\-]+) .*\{\s*$", line)
        if head:
            comp = head.group(1)
            continue
        m = inst_re.match(line)
        if not m:
            continue
        name = m.group(2)
        op = re.search(r'op_name="([^"]*)"', line)
        st = stage_re.search(op.group(1)) if op else None
        if st:
            own[name] = stage_key(st.group(1))
            votes.setdefault(comp, Counter())[own[name]] += 1
        c = re.search(r"calls=%([\w.\-]+)", line)
        if c:
            calls[name] = c.group(1)
        if m.group(1) and comp is not None:
            root_of[comp] = name

    def stage(name, depth=0):
        if name in own or depth > 8:
            return own.get(name)
        comp = calls.get(name)
        st = stage(root_of[comp], depth + 1) if comp in root_of else None
        if st is None and votes.get(comp):
            st = votes[comp].most_common(1)[0][0]
        return st

    out = {}
    for name in set(own) | set(calls):
        st = stage(name)
        if st:
            out[name] = st
    # cuBLAS GEMMs run inside command buffers under library kernel names;
    # they belong to the stages of the cuBLAS custom-calls
    gemm = sorted({own[m.group(1)] for m in re.finditer(
        r"%([\w.\-]+) = [^\n]*custom_call_target=\"__cublas", hlo_text)
        if m.group(1) in own})
    if gemm:
        out["<cublas gemm>"] = "+".join(gemm)
    return out


def reduce_trace(trace_dir, hlo_text, n_cycles, plane_prefix="/device:GPU",
                 line_prefix="Stream"):
    """Per-stage device time from a jax.profiler trace.

    Kernel events are the events on the lines named `line_prefix*` of the
    planes named `plane_prefix*` (a GPU plane's derived "XLA Ops"/"XLA
    Modules" lines repeat the same time and are skipped).  Each event's
    stage is the named scope in its op_name: the "name" stat of a GPU
    kernel event, else the metadata of its HLO instruction (its "hlo_op"
    stat) in `hlo_text`.  Returns
    ({stage: seconds per cycle}, busy seconds per cycle, window seconds per
    cycle, [(unmapped kernel, ns)...], {line name: events})."""
    import glob
    import re

    from jax.profiler import ProfileData

    scope_of = hlo_scopes(hlo_text)
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    per, spans, unmapped, lines_seen = {}, [], {}, {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            events = list(line.events)
            lines_seen[line.name] = len(events)
            if not line.name.startswith(line_prefix):
                continue
            for ev in events:
                stats = dict(ev.stats)
                if plane_prefix.startswith("/host") and "hlo_op" not in stats:
                    continue                # host threads: XLA ops only
                # a GPU kernel event carries its op_name as the "name" stat;
                # inside a command buffer (a CUDA graph of several kernels)
                # hlo_op is "command_buffer", and the kernel's own name is
                # its fusion's HLO name with "_N" for ".N"
                s = re.search(r"(L\d+/[a-z_]+)", str(stats.get("name", "")))
                stage = (stage_key(s.group(1)) if s else
                         scope_of.get(str(stats.get("hlo_op", ev.name)))
                         or scope_of.get(ev.name)
                         or scope_of.get(re.sub(r"_(\d+)$", r".\1", ev.name)))
                if stage is None and "gemm" in ev.name:
                    stage = scope_of.get("<cublas gemm>")
                if stage is None:
                    unmapped[ev.name] = unmapped.get(ev.name, 0) + ev.duration_ns
                    stage = "unmapped"
                per[stage] = per.get(stage, 0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0.0, -np.inf
    for s0, e0 in spans:
        if e0 > end:
            busy += e0 - max(s0, end)
            end = e0
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    per = {k: v * 1e-9 / n_cycles for k, v in per.items()}
    return (per, busy * 1e-9 / n_cycles, window * 1e-9 / n_cycles,
            sorted(unmapped.items(), key=lambda kv: -kv[1])[:8], lines_seen)


def phase_trace(ph, prob, hier, label, n_ref, trace_dir):
    import jax
    import jax.numpy as jnp
    ph.start(f"trace {label}")
    cycles = cycles_program()
    nss = hier.config.smoother.n_smoothing_steps
    n = TIMING_CYCLES.get(n_ref, 20)
    levels = tuple(hier.levels)
    b = jnp.asarray(random_rhs(prob, 4), dtype=jnp.float32)
    x0 = jnp.zeros_like(b)
    hlo = cycles.lower(levels, b, x0, n=n, nss=nss).compile().as_text()
    cycles(levels, b, x0, n=n, nss=nss).block_until_ready()
    out_dir = os.path.join(trace_dir, f"nref{n_ref}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "program.hlo.txt"), "w") as f:
        f.write(hlo)
    with jax.profiler.trace(out_dir):
        cycles(levels, b, x0, n=n, nss=nss).block_until_ready()
    per, busy, window, unmapped, lines_seen = reduce_trace(out_dir, hlo, n)
    lb = layer_bytes(hier)
    rows = []
    for stage in sorted(per, key=lambda k: -per[k]):
        t = per[stage]
        byt = lb.get(stage)
        share = (f", {byt / 1e6:.2f} MB, {byt / t / 3.35e12 * 100:.1f}% of "
                 f"3.35 TB/s" if byt and t > 0 else "")
        rows.append(f"{stage} {t * 1e6:.1f} us{share}")
    ph.say(f"per cycle: window {window * 1e6:.1f} us, busy {busy * 1e6:.1f} us "
           f"(idle {100 * (1 - busy / window) if window else 0:.1f}%); "
           + "; ".join(rows) + f"; top unmapped: {unmapped}; "
           f"trace lines: {lines_seen}")


# ------------------------------------------------------------- four cards --
def phase_four(ph, card, spmd_nref=7, gspmd_nref=6):
    """Phase 7: the SPMD stencil V-cycle (slabs and pencils) at 129^3 and a
    GSPMD CG step at 65^3, each against one device at HIGHEST precision."""
    import jax
    import jax.numpy as jnp

    from mfmg_tpu import Config, LaplaceProblem
    from mfmg_tpu.amge.hierarchy import vcycle
    from mfmg_tpu.config import AgglomerationConfig, SmootherConfig
    from mfmg_tpu.parallel.sharding import make_mesh, shard_hierarchy, shard_vector
    from mfmg_tpu.parallel.spmd import build_spmd_vcycle
    from mfmg_tpu.solve.operator import apply_op

    ph.start("7 four")
    devs = jax.devices()
    ph.check(len(devs) == 4, f"--four needs 4 devices, found {len(devs)}")
    prob = LaplaceProblem.hyper_cube(3, spmd_nref, material_property="linear")
    hier, secs, _ = build_hierarchy(prob, flagship_config())
    b = random_rhs(prob, 5).astype(np.float32)
    bj = jnp.asarray(b)
    nss = hier.config.smoother.n_smoothing_steps
    msgs = [f"SPMD at {prob.n_dofs} dofs, setup {secs:.1f} s"]
    with highest_precision():
        x1 = np.asarray(vcycle(hier.levels, bj, jnp.zeros_like(bj),
                               n_smoothing_steps=nss, is_preconditioner=True))
        atol = SPMD_ATOL * float(np.abs(x1).max())
        for mesh_shape in ((4,), (2, 2)):
            sv = build_spmd_vcycle(hier, n_devices=4, mesh_shape=mesh_shape)
            bg = sv.to_grid(b)
            on = {len(bg.sharding.device_set),
                  len(sv.fn.args[0].sharding.device_set)}
            ph.check(on == {4}, f"mesh {mesh_shape}: fine-level shards sit "
                                f"on {on} devices, not 4")
            xg = sv.fn(bg, sv.to_grid(np.zeros_like(b)))
            err = float(np.abs(sv.from_grid(xg) - x1).max())
            msgs.append(f"mesh {mesh_shape} max abs diff {err:.3e} "
                        f"(atol {atol:.3e}), shards on 4 devices")
            ph.check(err <= atol, msgs[-1])

        prob_g = LaplaceProblem.hyper_cube(3, gspmd_nref,
                                           material_property="linear")
        cfg_g = Config(operator="matrix_free", dtype="float32", max_levels=2,
                       smoother=SmootherConfig(type="chebyshev", degree=2),
                       agglomeration=AgglomerationConfig(nx=4, ny=4, nz=4))
        hier_g, _, _ = build_hierarchy(prob_g, cfg_g)
        bg = random_rhs(prob_g, 6).astype(np.float32)

        def cg_step(levels, b):
            x = jnp.zeros_like(b)
            z = vcycle(levels, b, x, n_smoothing_steps=1, is_preconditioner=True)
            rz = jnp.vdot(b, z)
            Ap = apply_op(levels[0].op, z)
            alpha = rz / jnp.vdot(z, Ap)
            return x + alpha * z, b - alpha * Ap

        x_1, r_1 = jax.jit(cg_step)(hier_g.levels, jnp.asarray(bg))
        mesh = make_mesh(4)
        levels_s = shard_hierarchy(hier_g.levels, mesh)
        b_s = shard_vector(mesh, jnp.asarray(bg))
        on = len(levels_s[0].op.cells.sharding.device_set)
        ph.check(on == 4, f"GSPMD fine operator sits on {on} devices")
        x_4, r_4 = jax.jit(cg_step)(levels_s, b_s)
        n = prob_g.n_dofs
        err = max(rel_max_err(np.asarray(x_4)[:n], x_1),
                  rel_max_err(np.asarray(r_4)[:n], r_1))
        msgs.append(f"GSPMD CG step ({n} dofs) rel max diff {err:.3e} "
                    f"(bound {GSPMD_RTOL:g}), fine operator on 4 devices")
        ph.check(err <= GSPMD_RTOL, msgs[-1])
    ph.say("; ".join(msgs) + f"; card {card}")


# -------------------------------------------------------------------- main --
def run(args, ph):
    import jax

    from mfmg_tpu import LaplaceProblem

    dev, card = phase_device(ph)
    if args.four:
        phase_four(ph, card)
    else:
        cfg = flagship_config()
        for n_ref in args.sizes:
            prob = LaplaceProblem.hyper_cube(3, n_ref,
                                             material_property="linear")
            label = f"n_ref={n_ref} ({prob.n_dofs} dofs)"
            if args.trace:
                hier = phase_setup(ph, prob, cfg, label)
                phase_trace(ph, prob, hier, label, n_ref, args.trace)
                continue
            phase_stencil(ph, prob, label)
            hier = phase_setup(ph, prob, cfg, label)
            phase_eigen(ph, prob, cfg, label)
            phase_vcycle(ph, prob, hier, label, with_rate=(n_ref == min(args.sizes)))
            phase_pcg(ph, prob, hier, label)
            phase_timing(ph, prob, hier, label, n_ref, card)
            del hier
    print(f"card: {card}", flush=True)
    return {"ok": True, "device": {"platform": dev.platform,
                                   "kind": dev.device_kind,
                                   "count": len(jax.devices())}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only phase 7 on four GPUs")
    p.add_argument("--sizes", default=",".join(map(str, SIZES)),
                   help="comma-separated n_ref values (default 6,7)")
    p.add_argument("--trace", metavar="DIR", default=None,
                   help="trace a window of V-cycles per size into DIR and "
                        "print per-stage device time instead of phases 2-6")
    args = p.parse_args(argv)
    args.sizes = tuple(int(s) for s in args.sizes.split(","))
    ph = Phases()
    try:
        result = run(args, ph)
    except Exception as e:          # report which phase failed, then exit 1
        traceback.print_exc()
        print(json.dumps({"ok": False, "phase": ph.current,
                          "error": f"{type(e).__name__}: {e}"}), flush=True)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
