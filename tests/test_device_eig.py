"""The device batched eigensolve (eigen/device_eig.py) run on the CPU: its
eigenpairs and Galerkin blocks against the host LAPACK path, its non-finite
fallback, and the hierarchy's choice between the two paths."""

import os
import sys
import types

import numpy as np
import pytest

from mfmg_tpu import Config, Hierarchy, LaplaceProblem
from mfmg_tpu.amge.agglomeration import build_agglomerates
from mfmg_tpu.amge.local_problems import build_agglomerate_batch
from mfmg_tpu.config import AgglomerationConfig, EigensolverConfig, SmootherConfig
from mfmg_tpu.eigen import device_eig
from mfmg_tpu.eigen.batched_eigh import batched_smallest_eigenpairs

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def flagship_small():
    """The flagship agglomeration (4x4x4 cells, 125-dof agglomerates) on a
    16^3-cell mesh: 64 agglomerates."""
    prob = LaplaceProblem.hyper_cube(3, 4, material_property="linear")
    agg = build_agglomerates(prob.mesh, AgglomerationConfig(nx=4, ny=4, nz=4))
    light = build_agglomerate_batch(prob.mesh, prob.A_loc, agg,
                                    batch_dtype=np.float32,
                                    assemble_operator=False)
    ref = build_agglomerate_batch(prob.mesh, prob.A_loc, agg,
                                  batch_dtype=np.float64)
    return prob, agg, light, ref


@pytest.mark.parametrize("n_ev", [1, 2, 4])
def test_device_eigenpairs_match_lapack(flagship_small, n_ev):
    prob, agg, light, ref = flagship_small
    evals, evecs = device_eig.device_smallest_eigenpairs(prob, agg, light, n_ev)
    ref_evals, ref_evecs = batched_smallest_eigenpairs(
        ref, n_ev + 4, constrained_mode="pin", host_dtype=np.float64)
    scale = (ref.diag * ref.valid).sum(axis=1) / ref.sizes
    rq_err, angle, _ = chip_smoke.compare_eigenpairs(
        ref.A_agg, evecs, ref_evals, ref_evecs, n_ev, scale)
    assert rq_err <= chip_smoke.EIG_RQ_BOUND, rq_err
    assert angle <= chip_smoke.EIG_ANGLE_BOUND, angle
    # the returned eigenvalues are the float32 Rayleigh-Ritz values
    assert np.abs(evals - ref_evals[:, :n_ev]).max() <= 1e-4 * scale.max()
    assert np.all(evecs[ref.constrained] == 0.0)


def test_device_galerkin_blocks_match_host(flagship_small):
    from mfmg_tpu.amge.multilevel import (_dof_row_structure,
                                          agg_galerkin_blocks,
                                          galerkin_product_from_blocks)
    from mfmg_tpu.amge.restriction import build_restriction

    prob, agg, light, ref = flagship_small
    evals, evecs, A_dev = device_eig.device_smallest_eigenpairs(
        prob, agg, light, 2, keep_A=True)
    R = build_restriction(light, evecs, prob.diag_raw, prob.n_dofs)
    dof_rows, dof_vals = _dof_row_structure(R)
    blocks_d = device_eig.device_galerkin_blocks(light, A_dev, dof_rows,
                                                 dof_vals, R.shape[0])
    assert blocks_d is not None
    blocks_h = agg_galerkin_blocks(ref, dof_rows, dof_vals, R.shape[0],
                                   eliminate=False)
    Ac_d = galerkin_product_from_blocks(blocks_d, R.shape[0]).toarray()
    Ac_h = galerkin_product_from_blocks(blocks_h, R.shape[0]).toarray()
    np.testing.assert_allclose(Ac_d, Ac_h, atol=1e-5 * np.abs(Ac_h).max())


def test_non_finite_device_result_falls_back_and_logs(flagship_small, capsys,
                                                      monkeypatch):
    prob, agg, light, _ = flagship_small
    monkeypatch.setattr(prob, "coeff_at_q", np.full_like(prob.coeff_at_q, np.nan))
    assert device_eig.device_smallest_eigenpairs(prob, agg, light, 2) is None
    assert "falling back to host LAPACK" in capsys.readouterr().err


def _rate_and_pcg(prob, hier):
    from mfmg_tpu.amge.hierarchy import measure_vcycle_rate
    b = np.random.default_rng(0).uniform(size=prob.n_dofs)
    b[prob.constrained] = 0.0
    _, info = hier.solve_cg(b, tol=1e-8, maxiter=100)
    return measure_vcycle_rate(hier, 20, seed=0), int(info["iterations"])


def test_hierarchy_eigensolve_path(monkeypatch):
    """On the CPU the hierarchy runs the host eigensolve; where the backend
    is a GPU it runs the device pipeline, and the two hierarchies
    precondition alike."""
    prob = LaplaceProblem.hyper_cube(3, 4, material_property="linear")
    cfg = Config(operator="stencil", max_levels=2,
                 eigensolver=EigensolverConfig(n_eigenvectors=2),
                 smoother=SmootherConfig(type="chebyshev", degree=2),
                 agglomeration=AgglomerationConfig(nx=4, ny=4, nz=4))
    host = Hierarchy(prob, cfg)
    assert host.eig_path == "host"
    monkeypatch.setattr(device_eig, "backend",
                        types.SimpleNamespace(is_gpu=lambda: True))
    dev = Hierarchy(prob, cfg)
    assert dev.eig_path == "device"
    rate_h, it_h = _rate_and_pcg(prob, host)
    rate_d, it_d = _rate_and_pcg(prob, dev)
    assert rate_d == pytest.approx(rate_h, abs=1e-3)
    assert it_d == it_h


def test_backend_host_config_keeps_host_path(monkeypatch):
    monkeypatch.setattr(device_eig, "backend",
                        types.SimpleNamespace(is_gpu=lambda: True))
    prob = LaplaceProblem.hyper_cube(3, 3, material_property="linear")
    cfg = Config(operator="stencil", max_levels=2,
                 eigensolver=EigensolverConfig(backend="host"),
                 agglomeration=AgglomerationConfig(nx=2, ny=2, nz=2))
    assert Hierarchy(prob, cfg).eig_path == "host"
