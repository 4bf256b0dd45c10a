"""The equilibrated normal matrix of the ``'normal'`` step
(``ops/normal_matrix.py``, ``csrc/normal_matrix.cu``).

On the CPU, in float64: the plain version against the einsum assembly of
``_normal_delta`` equilibrated as ``spd_solve`` does it on a card, its exact
symmetry and floored diagonal, the step the kernel route's glue gives
against the present step on Burgers and Darcy problems, and the route a CPU
solve takes (``ops/graphs.py::NORMAL_ASSEMBLIES``). On a card: the kernel
against the plain version at Burgers' shapes and at ragged ones, bitwise
across launches and a graph replay. On two gloo ranks, on the CPU and on
a card: a ``'normal'`` solve whose state does not divide evenly between
the ranks.

The file imports nothing of JAX: on a machine with a card,
``python -m pytest --noconftest -q tests/test_torch_normal_matrix.py``.
"""

import pytest
import torch

import nonlinpdes_gpsolver_tpu_torch as tpt
from nonlinpdes_gpsolver_tpu_torch.ops import graphs
from nonlinpdes_gpsolver_tpu_torch.ops import normal_matrix as nm
from nonlinpdes_gpsolver_tpu_torch.ops.linalg import equilibrate_floored
from nonlinpdes_gpsolver_tpu_torch.solvers import distributed as tdist
from test_torch_normal_route import _burgers, _darcy, _mesh
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_time_limit import time_limit  # noqa: F401  (autouse fixture)


@pytest.fixture(autouse=True)
def _fresh_counts():
    graphs.reset_counts()
    yield
    graphs.reset_counts()


def _blocks(s, Ss, N, seed=0, dtype=torch.float64, device="cpu", misfits=0):
    """Blocks ``(A, Dl)`` of one ``s`` and ``N``, one per entry of ``Ss``: ``A``
    symmetric positive definite (``G G^T / k + I/2``), ``Dl`` Gaussian; and
    ``misfits`` rows of a misfit Jacobian (``(misfits, s N)``)."""
    g = torch.Generator(device=device).manual_seed(seed)
    pairs = []
    for S in Ss:
        G = torch.randn((S * N, 24), generator=g, dtype=dtype, device=device)
        A = G @ G.T / 24
        A.diagonal().add_(0.5)
        pairs.append((A.reshape(S, N, S, N), torch.randn((s, S, N), generator=g, dtype=dtype,
                                                         device=device)))
    Jm = torch.randn((misfits, s * N), generator=g, dtype=dtype, device=device)
    return pairs, Jm


def _by_hand(pairs, Jm, jitter):
    """The einsum assembly of the present step and ``spd_solve``'s
    equilibration on a card: ``(Hs, sc)``."""
    H = nm.einsum_normal_matrix(pairs, [Jm] if Jm.shape[0] else [], Jm)
    if jitter:
        H = H + jitter * torch.eye(H.shape[0], dtype=H.dtype)
    return equilibrate_floored(H)


def _plain(pairs, Jm, jitter):
    """The kernel route's arithmetic on the CPU: scales from the inverse
    blocks' diagonal, the misfits' scaled product, the plain version."""
    d = nm.normal_diagonal(pairs) + jitter + (Jm * Jm).sum(dim=0)
    sc = torch.rsqrt(torch.clamp(d, min=torch.finfo(d.dtype).tiny))
    out = (Jm * sc).T @ (Jm * sc) if Jm.shape[0] else None
    return nm.normal_matrix(pairs, sc, out=out), sc


# (s, S of each block, N, jitter, misfit rows): Burgers' 3 slices on 4
# segments; N = 37 and 45 not multiples of the kernel's 32-wide tile (nor of
# 4), 64 two whole tiles; Darcy's two blocks of 3 and 4 segments at 6
# slices, with misfits; one slice on two segments (the elliptic structure)
CASES = [(3, (4,), 48, 0.0, 0), (3, (4,), 37, 1e-3, 0), (3, (4,), 64, 0.0, 0),
         (6, (3, 4), 45, 0.0, 7), (6, (3, 4), 32, 1e-4, 7), (1, (2,), 33, 0.0, 0),
         (2, (1,), 20, 1e-2, 3)]
IDS = [f"s{c[0]}-S{'+'.join(map(str, c[1]))}-N{c[2]}-j{c[3]:g}-m{c[4]}" for c in CASES]


@pytest.mark.parametrize("s,Ss,N,jitter,misfits", CASES, ids=IDS)
def test_plain_matches_the_einsum_assembly(s, Ss, N, jitter, misfits):
    """The plain version, with its scales from the inverse blocks' diagonal,
    equals the present einsum assembly equilibrated by hand to 1e-12, and
    the diagonal it reads equals ``diag(H)``."""
    pairs, Jm = _blocks(s, Ss, N, seed=N, misfits=misfits)
    ref, sc_ref = _by_hand(pairs, Jm, jitter)
    got, sc = _plain(pairs, Jm, jitter)
    assert got.shape == ref.shape == (s * N, s * N) and got.dtype == torch.float64
    assert float((sc - sc_ref).abs().max()) <= 1e-12 * float(sc_ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-12


@pytest.mark.parametrize("s,Ss,N,jitter,misfits", CASES, ids=IDS)
def test_plain_is_exactly_symmetric_with_the_floored_diagonal(s, Ss, N, jitter, misfits):
    """Every entry is written once and mirrored: the result equals its
    transpose bitwise, its diagonal is ``1 + 32 eps``; a given ``out``
    receives it."""
    pairs, Jm = _blocks(s, Ss, N, seed=N + 1, misfits=misfits)
    got, sc = _plain(pairs, Jm, jitter)
    assert torch.equal(got, got.mT)
    assert torch.equal(got.diagonal(), torch.full((s * N,), nm.floor_value(torch.float64),
                                                  dtype=torch.float64))
    blocks_only = nm.normal_matrix(pairs, sc)
    out = torch.full((s * N, s * N), 2.0, dtype=torch.float64)
    again = nm.normal_matrix(pairs, sc, out=out)
    assert again.data_ptr() == out.data_ptr() and torch.equal(again, again.mT)
    off = ~torch.eye(s * N, dtype=torch.bool)
    assert float((again - 2.0 - blocks_only)[off].abs().max()) <= 1e-12
    assert torch.equal(again.diagonal(), got.diagonal())


def _state(prob, nugget, block):
    fp = tdist.factorize_distributed(prob, _mesh(), nugget=nugget, block=block)
    structure = tdist._slice_structure(prob)
    return fp, structure, tdist._normal_state(fp, structure)


# (problem, nugget, mesh_block, hessian_jitter): Darcy has two blocks and a misfit
STEP_CASES = [("burgers", 1e-5, 32, 0.0), ("burgers", 1e-5, 16, 1e-6), ("darcy", 1e-4, 32, 0.0),
              ("darcy", 1e-4, 32, 1e-5)]


@pytest.mark.parametrize("name,nugget,block,jitter", STEP_CASES,
                         ids=[f"{c[0]}-b{c[2]}-j{c[3]:g}" for c in STEP_CASES])
def test_the_kernel_route_gives_the_present_step(name, nugget, block, jitter):
    """The kernel route's glue (scales, the misfits' product, floor,
    factorization), with the plain version on the CPU, gives the present
    step's ``delta`` to 1e-9 of its scale at the start and at a later
    iterate, in float64."""
    prob = _burgers() if name == "burgers" else _darcy()
    fp, structure, ainvs = _state(prob, nugget, block)
    z0 = torch.zeros(prob.latent_dim, dtype=torch.float64)
    z1 = tdist.gn_solve_distributed(fp, max_iter=2, step_solver="normal").z
    for z in (z0, z1):
        ref = tdist._normal_delta_einsum(fp, z, structure, ainvs, jitter)
        got = tdist._normal_delta_kernel(fp, z, structure, ainvs, jitter)
        scale = float(ref.abs().max())
        assert scale > 0.0 and torch.isfinite(got).all()
        assert float((got - ref).abs().max()) <= 1e-9 * scale


def test_a_cpu_solve_assembles_by_einsum():
    """On the CPU every ``'normal'`` step takes the einsum route, counted once
    for each step issued; other steps count nothing; the count resets."""
    s = tpt.GPSolver(_burgers(6), nugget=1e-5, mesh=_mesh(), mesh_block=32)
    res = s.solve(max_iter=3, step_solver="normal")
    assert res.state.step_solver == "normal"
    assert graphs.NORMAL_ASSEMBLIES == {"kernel": 0, "einsum": 3}
    s.solve(max_iter=2, step_solver="structured")
    assert graphs.NORMAL_ASSEMBLIES == {"kernel": 0, "einsum": 3}
    assert nm.LAUNCHES == 0
    graphs.reset_counts()
    assert graphs.NORMAL_ASSEMBLIES == {"kernel": 0, "einsum": 0}


def _two_ranks(rank, world, port, device, out_dir):
    """One of two gloo ranks (sharing the card where ``device`` is one):
    Darcy on 47 interior points, whose three-segment block is 141 wide, so
    the two ranks' columns of its state do not divide evenly. Saves the
    state's layout, a 3-step ``'normal'`` solve at P = 2 and at P = 1 (run
    eagerly, its counts), and the gap of the route's equilibrated matrix to
    the einsum assembly's at the start and at the solve's end."""
    import os

    import torch.distributed as dist

    from nonlinpdes_gpsolver_tpu_torch.parallel import initialize_distributed, make_mesh

    torch.set_num_threads(1)
    assert initialize_distributed(f"tcp://127.0.0.1:{port}", world, rank, backend="gloo")
    try:
        mesh = make_mesh(world, device=device)
        dtype = torch.float32 if mesh.device.type == "cuda" else torch.float64
        prob = _darcy(n_dom=47, device=mesh.device, dtype=dtype)
        structure = tdist._slice_structure(prob)
        out = {}
        for m in (mesh, make_mesh(1, device=mesh.device)):
            fp = tdist.factorize_distributed(prob, m, nugget=1e-4, block=16)
            ainvs = tdist._normal_state(fp, structure)
            graphs.reset_counts()
            launches = nm.LAUNCHES
            with graphs.uncaptured():
                st = tdist.gn_solve_distributed(fp, max_iter=3, step_solver="normal")
            tag = f"P{m.size}"
            out[f"assemblies_{tag}"] = dict(graphs.NORMAL_ASSEMBLIES)
            out[f"launches_{tag}"] = nm.LAUNCHES - launches
            out[f"z_{tag}"], out[f"losses_{tag}"] = st.z.cpu(), st.losses.tolist()
            out[f"layout_{tag}"] = [(A.shape[0] * A.shape[1], A.is_contiguous(), bool(torch.equal(
                A.flatten(0, 1).flatten(1), A.flatten(0, 1).flatten(1).mT))) for A in ainvs]
            out[f"gaps_{tag}"] = []
            for z in (torch.zeros_like(st.z), st.z):
                pairs = list(zip(ainvs, tdist._live_diagonals(prob, z, structure)))
                ref, _ = equilibrate_floored(nm.einsum_normal_matrix(
                    pairs, tdist._misfit_jacobians(prob, z), z))
                got, _ = tdist._equilibrated_normal_matrix(prob, z, pairs, 0.0)
                out[f"gaps_{tag}"].append(float((got - ref).abs().max() / ref.abs().max()))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# (device, float32 limit of the matrix gap, of the P = 2 z to P = 1): on the
# CPU in float64 the plain version; on a card in float32 the kernel, whose
# sums round otherwise than the einsums' (3.8e-6 of the largest entry in
# float32 on this problem against float64) and whose z the P = 2 state's
# rounding moves through a matrix at its 32 eps floor
RANK_CASES = [pytest.param("cpu", 1e-12, 1e-9, id="cpu"),
              pytest.param("cuda:0", 1e-4, 5e-2, id="cuda", marks=pytest.mark.cuda)]


@pytest.mark.parametrize("device,matrix_lim,z_lim", RANK_CASES)
def test_normal_solve_on_two_ranks_with_a_ragged_state(device, matrix_lim, z_lim, tmp_path):
    """A ``'normal'`` solve on two gloo ranks where the state's width is odd:
    every block's state contiguous and exactly symmetric; on a card every
    assembly routed to the kernel, one launch a block, on the CPU to the
    einsums; the route's equilibrated matrix within ``matrix_lim`` of the
    einsum assembly's; the same z on both ranks, within ``z_lim`` of its
    scale of the solve on one device."""
    import socket

    import torch.multiprocessing as mp

    if device.startswith("cuda"):
        _cuda()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    mp.spawn(_two_ranks, args=(2, port, device, str(tmp_path)), nprocs=2, join=True)
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    card = device.startswith("cuda")
    assert any(w % 2 for w, _, _ in got[0]["layout_P2"]), got[0]["layout_P2"]
    for g in got:
        for P in (2, 1):
            assert all(c and sym for _, c, sym in g[f"layout_P{P}"]), (P, g[f"layout_P{P}"])
            steps = g[f"assemblies_P{P}"]["kernel" if card else "einsum"]
            assert steps >= 1 and sum(g[f"assemblies_P{P}"].values()) == steps
            assert g[f"launches_P{P}"] == (2 * steps if card else 0)
            assert max(g[f"gaps_P{P}"]) <= matrix_lim, (P, g[f"gaps_P{P}"])
    assert torch.equal(got[0]["z_P2"], got[1]["z_P2"])
    z1 = got[0]["z_P1"]
    gap = float((got[0]["z_P2"] - z1).abs().max() / z1.abs().max())
    assert gap <= z_lim, (gap, got[0]["losses_P2"], got[0]["losses_P1"])


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# Burgers' shapes at the cell's size; ragged ones (N not a multiple of 4 takes
# the kernel's scalar loads); Darcy's two blocks at 6 slices with misfits
CARD_CASES = [(3, (4,), 5000, 0), (3, (4,), 1001, 0), (6, (3, 4), 250, 5), (1, (2,), 66, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,Ss,N,misfits", CARD_CASES,
                         ids=[f"s{c[0]}-S{'+'.join(map(str, c[1]))}-N{c[2]}" for c in CARD_CASES])
def test_kernel_matches_plain_on_a_card(s, Ss, N, misfits):
    """float32 kernel against the plain version of the same float32 inputs
    in float64: within 2e-5 of the largest entry (the entries of an
    equilibrated matrix are at most about 1); exactly symmetric, the floored
    diagonal, one launch a block."""
    cuda = _cuda()
    pairs, Jm = _blocks(s, Ss, N, seed=N, dtype=torch.float32, device=cuda, misfits=misfits)
    d = nm.normal_diagonal(pairs) + (Jm * Jm).sum(dim=0)
    sc = torch.rsqrt(d)
    out = (Jm * sc).T @ (Jm * sc) if misfits else None
    ref = nm.normal_matrix_plain([(A.double(), Dl.double()) for A, Dl in pairs], sc.double(),
                                 out=None if out is None else out.double())
    before = nm.LAUNCHES
    got = nm.normal_matrix(pairs, sc, out=out)
    torch.cuda.synchronize()
    assert nm.LAUNCHES - before == len(pairs)
    assert torch.equal(got, got.mT)
    assert torch.equal(got.diagonal(), torch.full((s * N,), nm.floor_value(torch.float32),
                                                  device=cuda))
    gap = float((got.double() - ref).abs().max() / ref.abs().max())
    assert gap <= 2e-5, gap


@pytest.mark.cuda
def test_kernel_is_bitwise_across_launches_and_a_graph_replay():
    """Burgers' shapes: two launches and a recorded graph's replay give the
    same bits."""
    cuda = _cuda()
    pairs, _ = _blocks(3, (4,), 5000, seed=3, dtype=torch.float32, device=cuda)
    sc = torch.rsqrt(nm.normal_diagonal(pairs))
    first = nm.normal_matrix(pairs, sc)
    second = nm.normal_matrix(pairs, sc)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        nm.normal_matrix(pairs, sc)  # warm on the capture stream
        with torch.cuda.graph(graph, stream=stream):
            recorded = nm.normal_matrix(pairs, sc)
    torch.cuda.current_stream().wait_stream(stream)
    recorded.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, recorded)
