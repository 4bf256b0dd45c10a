"""Triangular solves at P = 1 (``ops/trsm_rowblock.py``): the plain row-block
version against ``torch.linalg.solve_triangular``, the layout of the
diagonal-block inverses, the route rule of
``parallel/cholesky.py::trsm_route``, the route counter
``ops/graphs.py::TRSM_ROUTES`` on a CPU mesh solve, and on a card the
kernel against its plain version and cuBLAS at the cells' shapes and
against cuBLAS on the Darcy cell's own factors, two
launches and a recorded CUDA graph bitwise, and the recorded mesh loop
bitwise its eager run with the kernel on its path.

The file imports nothing of JAX: on a machine with a card,
``python -m pytest --noconftest -q tests/test_torch_trsm_rowblock.py``.
"""

import pytest
import torch

import nonlinpdes_gpsolver_tpu_torch as tpt
from nonlinpdes_gpsolver_tpu_torch.ops import graphs
from nonlinpdes_gpsolver_tpu_torch.ops import trsm_rowblock as tr
from nonlinpdes_gpsolver_tpu_torch.parallel import cholesky
from nonlinpdes_gpsolver_tpu_torch.solvers import _reuse
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)


@pytest.fixture(autouse=True)
def _fresh_counts():
    graphs.reset_counts()
    yield
    graphs.reset_counts()


def _factor(n, block, dtype, device="cpu", seed=0):
    """A P = 1 factor of the SPD ``G G^T / n + I`` (condition about 5)."""
    g = torch.Generator(device=device).manual_seed(seed)
    G = torch.randn((n, n), generator=g, dtype=dtype, device=device)
    A = G @ G.T / n
    A.diagonal().add_(1.0)
    return cholesky.cholesky_blockcyclic(A, tpt.parallel.make_mesh(1, device=device), block=block)


def _rhs(n, k, dtype, device="cpu"):
    return torch.randn((n, k), generator=torch.Generator(device=device).manual_seed(1),
                       dtype=dtype, device=device)


def _library(fac, V, trans):
    Vp = torch.zeros((fac.n_pad, V.shape[1]), dtype=V.dtype, device=V.device)
    Vp[: V.shape[0]] = V
    L = fac.matrix
    return torch.linalg.solve_triangular(L.mT if trans else L, Vp, upper=trans)


# -- on the CPU -----------------------------------------------------------------


@pytest.mark.parametrize("dtype,limit", [(torch.float32, 2e-6), (torch.float64, 1e-13)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("n,block", [(700, 256), (1000, 512)])
@pytest.mark.parametrize("k", [1, 61, 64])
@pytest.mark.parametrize("trans", [False, True], ids=["forward", "transposed"])
def test_plain_matches_solve_triangular(dtype, limit, n, block, k, trans):
    """The blocked row-block solve against the substitution, on a factor
    whose size is not a multiple of 256 (identity padding rows), with its
    refined diagonal-block inverses: max|plain - library| / max|library| a
    few units of the dtype's rounding (the factor's condition is about 2, a
    refined inverse's residual about eps, the sums run in another order)."""
    fac = _factor(n, block, dtype)
    V = _rhs(n, k, dtype)
    got = tr.trsm_rowblock_plain(fac.matrix, fac.diag_inv, V, trans)
    ref = _library(fac, V, trans)
    assert got.shape == (fac.n_pad, k)
    assert float((got - ref).abs().max() / ref.abs().max()) <= limit
    assert torch.equal(got[n:], torch.zeros_like(got[n:]))


def test_the_wrapper_takes_the_plain_version_for_cpu_tensors():
    fac = _factor(300, 256, torch.float64)
    V = _rhs(300, 5, torch.float64)
    before = tr.LAUNCHES
    for trans in (False, True):
        assert torch.equal(tr.trsm_rowblock(fac.matrix, fac.diag_inv, V, trans),
                           tr.trsm_rowblock_plain(fac.matrix, fac.diag_inv, V, trans))
    assert tr.LAUNCHES == before


@pytest.mark.parametrize("case", ["ragged_n_pad", "small_block", "diag_inv_past_L", "too_many_rows"])
def test_the_wrapper_rejects_shapes_it_cannot_take(case):
    fac = _factor(300, 256, torch.float64)
    L, W, V = fac.matrix, fac.diag_inv, _rhs(300, 3, torch.float64)
    if case == "ragged_n_pad":
        L = L[:500, :500]
    elif case == "small_block":
        W = W.reshape(-1, 128, 256)[:, :, :128]
    elif case == "diag_inv_past_L":
        W = torch.zeros((1, 768, 768), dtype=W.dtype)
    else:
        V = _rhs(600, 3, torch.float64)
    with pytest.raises(ValueError):
        tr.trsm_rowblock(L, W, V)


CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.mark.parametrize("device,dtype,P,k,block,route", [
    (CUDA, torch.float32, 1, 61, 512, "kernel"),
    (CUDA, torch.float32, 1, 1, 512, "kernel"),
    (CUDA, torch.float32, 1, 64, 256, "kernel"),
    (CUDA, torch.float32, 1, 65, 512, "library"),     # wider than the kernel's panels
    (CUDA, torch.float32, 1, 768, 512, "library"),    # the deflation projection
    (CUDA, torch.float32, 1, 20000, 512, "library"),  # Burgers' 'normal' state
    (CUDA, torch.float64, 1, 61, 512, "library"),
    (CPU, torch.float32, 1, 61, 512, "library"),
    (CPU, torch.float64, 1, 1, 512, "library"),
    (CUDA, torch.float32, 2, 61, 512, "library"),     # across ranks: the panel loops
    (CUDA, torch.float32, 1, 61, 16, "library"),      # blocks smaller than a step
    (CUDA, torch.float32, 1, 61, 384, "library"),     # blocks of no whole number of steps
])
def test_the_route_rule(device, dtype, P, k, block, route):
    assert cholesky.trsm_route(device, dtype, P, k, block) == route


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_diag_inverses_are_row_major(dtype):
    """The inverses a factor gets from ``diag_inverses`` are laid out as the
    fused factorization writes them and the kernel reads them, row-major,
    and they are the inverses of the diagonal blocks."""
    fac = _factor(700, 256, dtype)
    W = fac.diag_inv
    assert W.is_contiguous() and W.shape == (3, 256, 256)
    blocks = torch.stack([fac.matrix[i * 256 : (i + 1) * 256, i * 256 : (i + 1) * 256]
                          for i in range(3)])
    eye = torch.eye(256, dtype=dtype)
    assert float((W @ blocks - eye).abs().max()) <= 64 * torch.finfo(dtype).eps


def test_a_cpu_mesh_solve_counts_its_solves_as_library():
    """Every P = 1 triangular solve of a CPU mesh solve (Darcy, 'woodbury')
    goes to the library and is counted; nothing is launched."""
    w = tpt.workloads.darcy_past_wall(device="cpu", n_domain=120)
    before = tr.LAUNCHES
    res = tpt.GPSolver(w.problem, nugget=w.nugget, mesh=tpt.parallel.make_mesh(1, device="cpu"),
                       mesh_block=256).solve(max_iter=1, step_solver="woodbury")
    assert bool(torch.isfinite(res.z).all()) and int(res.state.cg_iters[0]) > 0
    assert graphs.TRSM_ROUTES["kernel"] == 0 and graphs.TRSM_ROUTES["library"] > 0
    assert tr.LAUNCHES == before
    n = graphs.TRSM_ROUTES["library"]
    fac = res.posterior.fp.factors["u"]
    cholesky.kernel_solve_blockcyclic(fac, torch.ones(fac.n, dtype=torch.float64))
    assert graphs.TRSM_ROUTES == {"kernel": 0, "library": n + 2}
    graphs.reset_counts()
    assert graphs.TRSM_ROUTES == {"kernel": 0, "library": 0}


# -- on a card -------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the row-block kernel has no CPU mode")
    return torch.device("cuda")


SHAPES = {"darcy_u": (12750, 61), "darcy_phi": (9000, 61), "burgers": (21000, 1)}
_FACTORS = {}


def _card_factor(name, device):
    """The factor of the cell's shape."""
    if name not in _FACTORS:
        _FACTORS.clear()
        _FACTORS[name] = _factor(SHAPES[name][0], 512, torch.float32, device)
    return _FACTORS[name]


@pytest.mark.cuda
@pytest.mark.parametrize("trans", [False, True], ids=["forward", "transposed"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_matches_plain_and_cublas(cuda, name, trans):
    """The kernel at the cells' shapes (block 512) against a float64 solve.
    All three sum the same products in float32 in other orders (the kernel
    and the plain version through the refined inverses, whose residual adds
    a few roundings; cuBLAS by substitution), on a factor of condition about
    2: the kernel's error at most 4 times the larger of the other two and
    under 50 float32 epsilons of the solution's scale, and within 1e-5 of
    that scale of each of them."""
    fac = _card_factor(name, cuda)
    n, k = SHAPES[name]
    V = _rhs(n, k, torch.float32, cuda)
    before = tr.LAUNCHES
    got = tr.trsm_rowblock(fac.matrix, fac.diag_inv, V, trans)
    torch.cuda.synchronize()
    assert tr.LAUNCHES == before + 1 and got.shape == (fac.n_pad, k)
    plain = tr.trsm_rowblock_plain(fac.matrix, fac.diag_inv, V, trans)
    lib = _library(fac, V, trans)
    L64 = fac.matrix.double()
    Vp = torch.zeros((fac.n_pad, k), dtype=torch.float64, device=cuda)
    Vp[:n] = V.double()
    truth = torch.linalg.solve_triangular(L64.mT if trans else L64, Vp, upper=trans)
    scale = truth.abs().max()

    def err(x):
        return float((x.double() - truth).abs().max() / scale)

    assert err(got) <= min(4 * max(err(lib), err(plain)), 50 * torch.finfo(torch.float32).eps)
    assert float((got - plain).abs().max()) <= 1e-5 * float(scale)
    assert float((got - lib).abs().max()) <= 1e-5 * float(scale)


_DARCY = {}


def _darcy_factors(device):
    """The fused factorization's P = 1 factors of the full-size Darcy
    problem past the dense wall (3,000 domain points: u 12,750 rows, a
    9,000, 512-row blocks), as ``darcy-nd3000-fresh`` solves it."""
    if not _DARCY:
        w = tpt.workloads.darcy_past_wall(device=device)
        solver = tpt.GPSolver(w.problem, nugget=w.nugget,
                              mesh=tpt.parallel.make_mesh(1, device=device))
        _DARCY.update(solver.fp.factors)
    return _DARCY


@pytest.mark.cuda
@pytest.mark.parametrize("trans", [False, True], ids=["forward", "transposed"])
@pytest.mark.parametrize("block", ["u", "a"])
def test_kernel_on_darcys_own_factors_is_as_accurate_as_cublas(cuda, block, trans):
    """On the Darcy factors the fused factorization makes (its inverses
    taken from the superblock inverses, not from the stored float32 blocks),
    61 columns as in a Woodbury CG iteration: the kernel's error against a
    float64 solve of the stored factor at most 1.5 times cuBLAS's. Read on an
    NVIDIA H100 80GB HBM3: u transposed 9.6e-5 against cuBLAS's 2.6e-4, a
    transposed 8.5e-5 against 1.3e-4, forward 1.1-1.4e-5 against 3.7-4.6e-5.
    A kernel that summed each work item's 4,096 products in one running
    total read 5.0e-4 on both transposed solves (1.9 and 3.8 times cuBLAS)
    and diverged one fresh Darcy draw; the synthetic factors of the tests
    above, of condition about 5, do not show it."""
    fac = _darcy_factors(cuda)[block]
    assert fac.block == 512 and fac.diag_inv.is_contiguous()
    V = torch.randn((fac.n, 61), generator=torch.Generator(device=cuda).manual_seed(5),
                    device=cuda)
    got = tr.trsm_rowblock(fac.matrix, fac.diag_inv, V, trans)
    lib = _library(fac, V, trans)
    L64 = fac.matrix.double()
    Vp = torch.zeros((fac.n_pad, 61), dtype=torch.float64, device=cuda)
    Vp[: fac.n] = V.double()
    truth = torch.linalg.solve_triangular(L64.mT if trans else L64, Vp, upper=trans)
    del L64
    scale = truth.abs().max()

    def err(x):
        return float((x.double() - truth).abs().max() / scale)

    assert err(got) <= 1.5 * err(lib), (err(got), err(lib))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["darcy_u", "burgers"])
def test_two_launches_and_a_graph_replay_are_bitwise(cuda, name):
    """Two launches on the same inputs give the same bits, and so does a
    launch recorded in a CUDA graph and replayed (its counters zeroed by a
    recorded memset); a replay adds no launch to the count."""
    fac = _card_factor(name, cuda)
    n, k = SHAPES[name]
    V = _rhs(n, k, torch.float32, cuda)
    for trans in (False, True):
        first = tr.trsm_rowblock(fac.matrix, fac.diag_inv, V, trans)
        second = tr.trsm_rowblock(fac.matrix, fac.diag_inv, V, trans)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            with torch.cuda.graph(graph, stream=stream):
                recorded = tr.trsm_rowblock(fac.matrix, fac.diag_inv, V, trans)
        launches = tr.LAUNCHES
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(recorded, first)
        assert tr.LAUNCHES == launches
        assert torch.equal(first, second)
        del graph


@pytest.mark.cuda
def test_the_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    fac = _card_factor("darcy_phi", cuda)
    L, W = fac.matrix, fac.diag_inv
    with pytest.raises(TypeError):
        tr.trsm_rowblock(L, W, _rhs(9000, 3, torch.float64, cuda))
    with pytest.raises(ValueError):
        tr.trsm_rowblock(L, W, _rhs(9000, 65, torch.float32, cuda))
    with pytest.raises(ValueError):
        tr.trsm_rowblock(L, W.transpose(1, 2), _rhs(9000, 3, torch.float32, cuda))


@pytest.mark.cuda
def test_the_recorded_darcy_loop_replays_its_eager_run_with_the_kernel(cuda):
    """New solvers of a Darcy problem (cut to 600 points: its gates are the
    full size's, not tested here) on a one-card mesh with the 'woodbury'
    step, each result held until the next: the CG iterations' triangular
    solves take the kernel (counted, launched), and the replayed loop is
    bitwise a solve that shares nothing with any entry and runs eagerly."""
    tpt.clear_graph_cache()
    mesh = tpt.parallel.make_mesh(1, device=cuda)

    w = tpt.workloads.darcy_past_wall(device=cuda, n_domain=600)

    def solve():
        return tpt.GPSolver(w.problem, nugget=w.nugget, mesh=mesh).solve(
            max_iter=8, step_solver="woodbury")

    held = None
    for _ in range(4):
        held = solve()
    graphs.reset_counts()
    before = tr.LAUNCHES
    res = held = solve()
    torch.cuda.synchronize()
    assert graphs.CAPTURES == 0 and int(sum(res.state.cg_iters.tolist())) > 0
    with graphs.uncaptured(), _reuse._unshared():
        ref = tpt.GPSolver(w.problem, nugget=w.nugget, mesh=mesh).solve(
            max_iter=8, step_solver="woodbury")
    torch.cuda.synchronize()
    assert graphs.TRSM_ROUTES["kernel"] > 0 and tr.LAUNCHES > before
    assert torch.equal(res.z, ref.z) and torch.equal(res.state.losses, ref.state.losses)
    assert bool(torch.isfinite(res.z).all())
    del held, res, ref
    tpt.clear_graph_cache()
