"""Stencil operator tests: exact equivalence with the assembled matrix."""

import numpy as np
import pytest
import jax.numpy as jnp

from mfmg_tpu import Config, Hierarchy, LaplaceProblem
from mfmg_tpu.amge.hierarchy import measure_vcycle_rate
from mfmg_tpu.config import AgglomerationConfig, SmootherConfig
from mfmg_tpu.ops.stencil import stencil_from_csr
from mfmg_tpu.solve.operator import operator_diagonal


@pytest.mark.parametrize("dim,n_ref,degree,material", [
    (1, 3, 1, "constant"),
    (2, 3, 1, "linear"),
    (2, 2, 2, "constant"),
    (3, 2, 1, "discontinuous"),
])
def test_stencil_equals_csr(dim, n_ref, degree, material):
    prob = LaplaceProblem.hyper_cube(dim, n_ref, degree=degree, material_property=material)
    S = stencil_from_csr(prob.A, prob.mesh, dtype=jnp.float64)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.uniform(size=prob.n_dofs))
    np.testing.assert_allclose(np.asarray(S @ x), prob.A @ np.asarray(x), atol=1e-12)
    np.testing.assert_allclose(np.asarray(operator_diagonal(S)), prob.A.diagonal(), atol=1e-14)


def test_stencil_hierarchy_matches_ell_rate():
    prob = LaplaceProblem.hyper_cube(3, 2)
    mk = lambda op: Config(operator=op, is_preconditioner=False,
                           smoother=SmootherConfig(type="chebyshev", degree=1),
                           agglomeration=AgglomerationConfig(nx=2, ny=2, nz=2))
    r_ell = measure_vcycle_rate(Hierarchy(prob, mk("ell")), 20, seed=0)
    r_st = measure_vcycle_rate(Hierarchy(prob, mk("stencil")), 20, seed=0)
    assert r_st == pytest.approx(r_ell, abs=1e-8)


@pytest.mark.parametrize("dtype,bound", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_stencil_apply_planes_dtype_matches_csr(dtype, bound):
    """The production apply (float32 x, float32 or bf16 coefficient planes
    built from the cell matrices) against the float64 assembled matrix, at
    the bounds chip_smoke.py holds the GPU to."""
    from mfmg_tpu.ops.stencil import stencil_apply, stencil_from_cell_matrices

    p = LaplaceProblem.hyper_cube(3, 4, material_property="linear")
    op = stencil_from_cell_matrices(p.mesh, p.A_loc, p.constrained,
                                    p.diag_raw, dtype=jnp.dtype(dtype))
    assert op.coeffs.dtype == jnp.dtype(dtype)
    x = np.random.default_rng(3).uniform(size=p.n_dofs)
    y = stencil_apply(op, jnp.asarray(x, dtype=jnp.float32))
    assert y.dtype == jnp.float32
    y_ref = p.A @ x
    err = np.abs(np.asarray(y, dtype=np.float64) - y_ref).max() / np.abs(y_ref).max()
    assert err <= bound, err
