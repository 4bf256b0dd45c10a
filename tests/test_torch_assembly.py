"""The port's Gram assembly, cross-Gram and trace-adaptive nugget against
the JAX package, on the same numpy points in f64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinpdes_gpsolver_tpu.ops as jops
import nonlinpdes_gpsolver_tpu_torch.ops as tops
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)

# Both packages evaluate the same closed form in the same order, so the
# blocks agree to rounding: rtol 1e-12, with an absolute floor of 1e-12 of
# the matrix scale for entries that cancel to near zero.
RTOL = 1e-12


def _observables(pkg):
    return (
        pkg.Observable("domain", pkg.laplacian()),
        pkg.Observable("domain", pkg.identity()),
        pkg.Observable("boundary", pkg.identity()),
    )


def _points(seed=0, n_dom=40, n_bdy=12):
    rng = np.random.default_rng(seed)
    return {
        "domain": rng.uniform(0, 1, (n_dom, 2)),
        "boundary": rng.uniform(0, 1, (n_bdy, 2)),
    }


def _jax_pts(pts):
    return {k: jnp.asarray(v) for k, v in pts.items()}


def _torch_pts(pts):
    return {k: torch.as_tensor(v) for k, v in pts.items()}


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        got.numpy(), ref, rtol=RTOL, atol=RTOL * np.abs(ref).max()
    )


@pytest.mark.parametrize(
    "kernel",
    [("gaussian", (0.2,)), ("anisotropic", ([0.3, 0.05],))],
)
def test_gram_matrix_matches_jax(kernel):
    ctor, args = kernel
    pts = _points()
    ref = jops.gram_matrix(
        getattr(jops.SquaredExponential, ctor)(*args), _observables(jops), _jax_pts(pts)
    )
    got = tops.gram_matrix(
        getattr(tops.SquaredExponential, ctor)(*args), _observables(tops), _torch_pts(pts)
    )
    _close(got, ref)
    # the lower blocks are exact transposed copies of the upper ones
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("row_op", ["identity", "laplacian"])
def test_cross_gram_matches_jax(row_op):
    pts = _points(seed=1)
    X_rows = np.random.default_rng(2).uniform(0, 1, (23, 2))
    ref = jops.cross_gram(
        jops.SquaredExponential.gaussian(0.2), getattr(jops, row_op)(),
        jnp.asarray(X_rows), _observables(jops), _jax_pts(pts),
    )
    got = tops.cross_gram(
        tops.SquaredExponential.gaussian(0.2), getattr(tops, row_op)(),
        torch.as_tensor(X_rows), _observables(tops), _torch_pts(pts),
    )
    assert got.shape == (23, 40 + 40 + 12)
    _close(got, ref)


@pytest.mark.parametrize("nugget_type", ["adaptive", "identity", "none"])
def test_nugget_diag_and_regularized_gram_match_jax(nugget_type):
    pts = _points(seed=3)
    kj, kt = jops.SquaredExponential.gaussian(0.2), tops.SquaredExponential.gaussian(0.2)
    theta_j = jops.gram_matrix(kj, _observables(jops), _jax_pts(pts))
    theta_t = tops.gram_matrix(kt, _observables(tops), _torch_pts(pts))
    sizes = tops.observable_sizes(_observables(tops), _torch_pts(pts))
    assert sizes == jops.observable_sizes(_observables(jops), _jax_pts(pts))
    ref = jops.adaptive_nugget_diag(theta_j, _observables(jops), sizes, 1e-6, nugget_type)
    got = tops.adaptive_nugget_diag(theta_t, _observables(tops), sizes, 1e-6, nugget_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=0)
    if nugget_type == "adaptive":
        # derivative rows carry nugget * trace ratio, identity rows the nugget
        assert float(got[0]) > 1e-6 and float(got[-1]) == 1e-6
    _close(
        tops.regularized_gram(kt, _observables(tops), _torch_pts(pts), 1e-6, nugget_type),
        jops.regularized_gram(kj, _observables(jops), _jax_pts(pts), 1e-6, nugget_type),
    )


def test_unknown_nugget_type_raises():
    theta = torch.eye(3, dtype=torch.float64)
    with pytest.raises(ValueError):
        tops.adaptive_nugget_diag(theta, (), (3,), 1e-6, "bogus")
