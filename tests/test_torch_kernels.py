"""The port's closed-form kernel blocks, f32 exponential and Gram tile
evaluator, held against the JAX package on the same numpy inputs.

On the CPU the Gram tile evaluator runs its plain version; the CUDA kernel
itself is held against that plain version by ``tests/test_torch_cuda.py``
(skipped without a card) and by ``chip_smoke.py``.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinpdes_gpsolver_tpu.ops as jops
from nonlinpdes_gpsolver_tpu.ops.kernels import exp_neg_accurate as jax_exp_neg
from nonlinpdes_gpsolver_tpu.ops.pallas_gram import _combined_terms as jax_combined
from nonlinpdes_gpsolver_tpu.ops.pallas_gram import pallas_pair_fn

import nonlinpdes_gpsolver_tpu_torch.ops as tops
from nonlinpdes_gpsolver_tpu_torch.ops import gram_tile
from nonlinpdes_gpsolver_tpu_torch.ops.kernels import exp_neg_accurate
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)

OPS = ["id", "d0", "d1", "d00", "d11", "d01", "lap"]
KERNELS = {
    "gaussian": ("gaussian", (0.2,)),
    "aniso_len": ("anisotropic", ([0.3, 0.05],)),
    "aniso_prec": ("anisotropic", ([3.0, 20.0], "precision")),
}


def _op(pkg, name):
    return {
        "id": lambda: pkg.identity(),
        "d0": lambda: pkg.d(0),
        "d1": lambda: pkg.d(1),
        "d00": lambda: pkg.d2(0, 0),
        "d11": lambda: pkg.d2(1, 1),
        "d01": lambda: pkg.d2(0, 1),
        "lap": lambda: pkg.laplacian(),
    }[name]()


def _kernel(pkg, name):
    ctor, args = KERNELS[name]
    return getattr(pkg.SquaredExponential, ctor)(*args)


def _points(n, m, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (n, 2)), rng.uniform(0, 1, (m, 2))


def _t(a, dtype=torch.float64):
    return torch.as_tensor(a, dtype=dtype)


@pytest.mark.parametrize("kname", list(KERNELS))
@pytest.mark.parametrize("ox,oy", list(itertools.combinations_with_replacement(OPS, 2)))
def test_plain_block_matches_jax_pair_fn(kname, ox, oy):
    """Same f64 closed form, same operation order: rtol 1e-12. Entries that
    cancel to near zero get an absolute floor of 1e-12 of the block's scale."""
    X, Y = _points(7, 5)
    ref = np.asarray(
        _kernel(jops, kname).pair_fn(_op(jops, ox), _op(jops, oy))(jnp.asarray(X), jnp.asarray(Y))
    )
    got = gram_tile.gram_tile_pair_fn(
        _kernel(tops, kname), _op(tops, ox), _op(tops, oy)
    )(_t(X), _t(Y))
    np.testing.assert_allclose(
        got.numpy(), ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max()
    )


@pytest.mark.parametrize(
    "kname,ox,oy",
    [("gaussian", "lap", "lap"), ("aniso_len", "d01", "d1"), ("aniso_prec", "lap", "d00")],
)
def test_plain_block_matches_autodiff_oracle(kname, ox, oy):
    """torch.func nested grads against the closed form (the JAX package's own
    bound for this check: 1e-9 of the block's scale)."""
    X, Y = _points(6, 5, seed=1)
    k = _kernel(tops, kname)
    closed = k.pair_fn(_op(tops, ox), _op(tops, oy))(_t(X), _t(Y))
    ad = tops.ad_pair_fn(k.kappa, _op(tops, ox), _op(tops, oy))(_t(X), _t(Y))
    scale = max(1.0, float(ad.abs().max()))
    np.testing.assert_allclose(closed.numpy(), ad.numpy(), rtol=0, atol=1e-9 * scale)


@pytest.mark.parametrize(
    "kname,ox,oy,n,m",
    [
        ("gaussian", "id", "id", 50, 70),
        ("gaussian", "lap", "id", 50, 70),
        ("gaussian", "lap", "lap", 50, 70),
        ("gaussian", "d0", "d11", 50, 70),
        ("aniso_len", "lap", "d1", 33, 17),
    ],
)
def test_plain_block_matches_pallas_interpret(kname, ox, oy, n, m):
    """The Pallas tile kernel (interpret mode, tiles of 16 with edge padding)
    and the plain version share the closed form: rtol 1e-12 in f64."""
    X, Y = _points(n, m, seed=5)
    ref = np.asarray(
        pallas_pair_fn(
            _kernel(jops, kname), _op(jops, ox), _op(jops, oy),
            tile_m=16, tile_n=16, interpret=True,
        )(jnp.asarray(X), jnp.asarray(Y))
    )
    got = gram_tile.gram_tile_pair_fn(
        _kernel(tops, kname), _op(tops, ox), _op(tops, oy)
    )(_t(X), _t(Y))
    assert got.shape == (n, m)
    np.testing.assert_allclose(
        got.numpy(), ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max()
    )


def test_exp_neg_accurate_f32_matches_jax():
    """The same Cody-Waite routine in both packages: within 1 ulp over the
    kernel's whole range (the two frameworks may round a fused step
    differently); the f64 path is exactly torch.exp."""
    q = np.linspace(0.0, 87.0, 200001).astype(np.float32)
    ref = np.asarray(jax_exp_neg(jnp.asarray(q)))
    got = exp_neg_accurate(torch.as_tensor(q)).numpy()
    assert got.dtype == np.float32
    ulps = np.abs(got.astype(np.float64) - ref) / np.spacing(ref)
    assert ulps.max() <= 1.0, ulps.max()
    truth = np.exp(-q.astype(np.float64))
    assert (np.abs(got - truth) / np.spacing(got)).max() <= 4.0
    q64 = torch.tensor([0.3, 2.0, 10.0], dtype=torch.float64)
    assert torch.equal(exp_neg_accurate(q64), torch.exp(-q64))


@pytest.mark.parametrize("kname", list(KERNELS))
@pytest.mark.parametrize("ox,oy", [("lap", "lap"), ("d01", "lap"), ("id", "d1"), ("d00", "d11")])
def test_packed_table_matches_combined_terms(kname, ox, oy):
    """The kernel's table holds exactly the JAX package's merged terms."""
    kj, kt = _kernel(jops, kname), _kernel(tops, kname)
    terms = jax_combined(kj.inv_sq, _op(jops, ox).terms, _op(jops, oy).terms)
    table, degs = gram_tile.pack_terms(kt.inv_sq, _op(tops, ox).terms, _op(tops, oy).terms)
    dim, stride = kt.dim, gram_tile.MAX_DEGREE + 1
    assert table[:dim].tolist() == list(kt.inv_sq)
    assert degs.shape == (len(terms), dim)
    rows = table[dim:].reshape(len(terms), 1 + dim * stride)
    for (coef, polys), row, deg in zip(terms, rows, degs):
        assert row[0] == coef
        for k, coeffs in enumerate(polys):
            cf = row[1 + k * stride : 1 + (k + 1) * stride]
            if coeffs is None:
                assert deg[k] == 0 and not cf.any()
            else:
                assert deg[k] == len(coeffs) - 1
                assert cf[: len(coeffs)].tolist() == list(coeffs)
                assert not cf[len(coeffs):].any()


def test_packed_table_rejects_what_the_kernel_cannot_take():
    k3 = tops.SquaredExponential.gaussian(0.2, dim=4)
    with pytest.raises(ValueError, match="dim"):
        gram_tile.pack_terms(k3.inv_sq, tops.identity(4).terms, tops.identity(4).terms)
    k = tops.SquaredExponential.gaussian(0.2)
    high = tops.LinearOp(2, ((1.0, (5, 0)),))
    with pytest.raises(ValueError, match="order"):
        gram_tile.pack_terms(k.inv_sq, high.terms, high.terms)


def test_cpu_block_writes_into_strided_slot_without_launching():
    """``out`` may be a slot of a larger matrix (row stride > width); a CPU
    tensor runs the plain version and never counts a kernel launch."""
    X, Y = _points(9, 6, seed=2)
    k = tops.SquaredExponential.gaussian(0.2)
    fn = gram_tile.gram_tile_pair_fn(k, tops.laplacian(), tops.identity())
    big = torch.zeros((12, 11), dtype=torch.float64)
    before = gram_tile.LAUNCHES
    fn(_t(X), _t(Y), out=big[2:11, 3:9])
    assert gram_tile.LAUNCHES == before
    np.testing.assert_array_equal(big[2:11, 3:9].numpy(), fn(_t(X), _t(Y)).numpy())
    assert big[:2].abs().sum() == 0 and big[:, :3].abs().sum() == 0
