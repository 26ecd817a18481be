"""chip_smoke.py off the GPU: its comparison helpers, its trace reduction and
byte counts at a tiny size, and its refusal to run without a GPU or without
the package."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402


def test_relative_errors():
    ref = np.array([1.0, -2.0, 4.0])
    y = ref + np.array([0.0, 0.04, 0.0])
    assert cs.rel_max_err(y, ref) == pytest.approx(0.01)
    assert cs.rel_l2(y, ref) == pytest.approx(0.04 / np.sqrt(21.0))


def test_largest_angle_of_rotated_plane():
    t = 1e-3
    U = np.array([[1.0, 0.0], [0.0, np.cos(t)], [0.0, np.sin(t)]])
    V = np.eye(3)[:, :2]
    assert cs.largest_angle(U, V) == pytest.approx(t, rel=1e-6)
    assert cs.largest_angle(V, V) < 1e-12


def test_compare_eigenpairs_treats_clusters_as_one_subspace():
    """A basis rotated inside a degenerate pair is as good as the host's:
    the angle to the cluster is ~0 while the plain angle is large, and the
    Rayleigh quotients still match."""
    lam = np.array([0.0, 1.0, 1.0 + 1e-6, 5.0])
    Q, _ = np.linalg.qr(np.random.default_rng(0).standard_normal((4, 4)))
    A = (Q * lam) @ Q.T
    c, s = np.cos(0.7), np.sin(0.7)
    V = Q[:, :2].copy()
    V[:, 1] = c * Q[:, 1] + s * Q[:, 2]
    rq_err, angle, plain = cs.compare_eigenpairs(
        A[None], V[None], lam[None], Q[None], 2, np.array([1.0]))
    assert rq_err < 1e-6
    assert angle < 1e-9
    assert plain > 0.5


@pytest.fixture(scope="module")
def tiny_hierarchy():
    import jax

    from mfmg_tpu import Hierarchy, LaplaceProblem

    jax.config.update("jax_enable_x64", False)
    try:
        prob = LaplaceProblem.hyper_cube(3, 4, material_property="linear")
        yield prob, Hierarchy(prob, cs.flagship_config())
    finally:
        jax.config.update("jax_enable_x64", True)


def test_layer_bytes_cover_the_named_stages(tiny_hierarchy):
    import re

    import jax.numpy as jnp
    prob, hier = tiny_hierarchy
    b = jnp.ones(prob.n_dofs, jnp.float32)
    hlo = cs.cycles_program().lower(tuple(hier.levels), b, b, n=2,
                                    nss=1).compile().as_text()
    stages = {cs.stage_key(m) for m in re.findall(r"(L\d+/[a-z_]+)", hlo)}
    lb = cs.layer_bytes(hier)
    assert set(lb) == stages
    # pre- and post-smoothing stream the bf16 planes twice each (degree 2)
    planes = hier.levels[0].op.coeffs
    assert lb["L0/smooth"] >= 4 * planes.size * planes.dtype.itemsize


def test_reduce_trace_attributes_time_to_stages(tiny_hierarchy, tmp_path):
    import jax
    import jax.numpy as jnp
    prob, hier = tiny_hierarchy
    cycles = cs.cycles_program()
    levels = tuple(hier.levels)
    b = jnp.ones(prob.n_dofs, jnp.float32)
    hlo = cycles.lower(levels, b, b, n=2, nss=1).compile().as_text()
    cycles(levels, b, b, n=2, nss=1).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        cycles(levels, b, b, n=2, nss=1).block_until_ready()
    per, busy, window, _, _ = cs.reduce_trace(
        str(tmp_path), hlo, 2, plane_prefix="/host:CPU", line_prefix="")
    assert per.get("L0/smooth", 0) > 0 and per.get("L0/residual", 0) > 0
    assert 0 < busy <= window * (1 + 1e-9)


def _run_smoke(cwd, extra_env, sizes="3"):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(extra_env)
    return subprocess.run([sys.executable, "chip_smoke.py", "--sizes", sizes],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=900)


@pytest.fixture
def gpu_card():
    """Skip unless an NVIDIA GPU is present (asked of nvidia-smi, so this
    process, which conftest.py keeps on the CPU, never opens the card)."""
    try:
        out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        pytest.skip("no NVIDIA GPU here (nvidia-smi not available)")
    if out.returncode != 0 or "GPU" not in out.stdout:
        pytest.skip("no NVIDIA GPU here (nvidia-smi lists none)")


@pytest.mark.gpu
def test_smoke_passes_on_gpu(gpu_card):
    """Phases 1-6 at 274k DoFs on the card, in a child process of its own."""
    r = _run_smoke(ROOT, {}, sizes="6")
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"


def test_smoke_fails_on_cpu():
    r = _run_smoke(ROOT, {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is False and last["phase"] == "1 device"


def test_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path), {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert json.loads(r.stdout.strip().splitlines()[-1])["ok"] is False


def test_float32_floor_of_identity():
    """One float32 rounding of x = 1 under A = I leaves a relative residual
    of 2^-24 / sqrt(3) (uniform rounding errors)."""
    import scipy.sparse as sp
    n = 200_000
    floor = cs.float32_floor(sp.identity(n, format="csr"), np.ones(n), np.ones(n))
    assert floor == pytest.approx(2.0 ** -24 / np.sqrt(3.0), rel=1e-2)
