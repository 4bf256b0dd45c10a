"""Worker of ``tests/test_torch_ranks.py``: the port's mesh path on P gloo ranks.

    python tests/torch_rank_worker.py DIR 2,4 [GROUP]

for each mesh size P in turn, reads ``DIR/inputs.npz`` (numpy arrays:
matrices and right-hand sides from numpy seeds, the points and data of the
JAX package's draws), spawns P ranks on the CPU with ``torch.multiprocessing``, joined by gloo over
``tcp://127.0.0.1``, and on every rank runs each case of :data:`CASES` in
``GROUP`` (default ``mesh``, ``tests/test_torch_ranks.py``'s; ``checkpoint``
is ``tests/test_torch_checkpoint.py``'s) marked for P, in f64 with one
torch thread. A case may read and write files in ``DIR`` (``c.dir``). Rank r
writes ``DIR/out_P{P}_rank{r}.npz``, one key per case and result. The
worker imports torch and the port only: ``jax`` and the JAX package are
blocked from its import system, and it fails if either was imported. Any
rank's failure makes the command exit non-zero.
"""

import importlib.abc
import os
import socket
import sys
import traceback

BLOCKED = ("jax", "jaxlib", "nonlinpdes_gpsolver_tpu")


class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked in the rank worker: " + name)


def _block_jax():
    """Keep jax and the JAX package out of this process (the test that
    imports this module for its case lists does not call it)."""
    if not any(isinstance(f, _Block) for f in sys.meta_path):
        sys.meta_path.insert(0, _Block())


sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

CASES = {}


def case(*sizes, group="mesh"):
    """Register a case of ``group`` for the mesh sizes ``sizes`` (default: P = 2)."""
    def put(fn):
        CASES[fn.__name__] = (fn, sizes or (2,), group)
        return fn
    return put


class Ctx:
    def __init__(self, mesh, one, inp, directory):
        self.mesh, self.one, self.inp, self.dir = mesh, one, inp, directory
        self.rank, self.P = mesh.rank, mesh.size

    def t(self, key):
        return torch.as_tensor(self.inp[key])


def np_(x):
    return x.detach().cpu().numpy()


# -- parallel/cholesky.py: the twins of tests/test_parallel.py -----------------------

CHOL = [(96, 16), (200, 16), (256, 32), (130, 32)]
MULTICHUNK = [(192, 8, 16), (200, 8, 8), (256, 16, 48)]


@case()
def cholesky_dense(c):
    from nonlinpdes_gpsolver_tpu_torch.parallel import cholesky_blockcyclic

    out = {}
    for n, B in CHOL:
        fac = cholesky_blockcyclic(c.t(f"spd{n}"), c.mesh, block=B)
        out[f"L{n}_{B}"] = np_(fac.dense())
        out[f"winvs{n}_{B}"] = np_(fac.diag_inv)
    return out


@case()
def cholesky_multichunk(c):
    from nonlinpdes_gpsolver_tpu_torch.parallel import cholesky_blockcyclic

    out = {}
    for n, B, cc in MULTICHUNK:
        A = c.t(f"spd_mc{n}")
        out[f"L{n}_{B}_{cc}"] = np_(cholesky_blockcyclic(A, c.mesh, block=B, chunk_cols=cc).dense())
        out[f"ref{n}_{B}_{cc}"] = np_(cholesky_blockcyclic(A, c.mesh, block=B,
                                                           chunk_cols=1 << 20).dense())
    return out


@case(4)
def cholesky_nondivisible(c):
    from nonlinpdes_gpsolver_tpu_torch.parallel import cholesky_blockcyclic

    fac = cholesky_blockcyclic(c.t("spd100"), c.mesh, block=16)
    return {"L": np_(fac.dense()), "local_shape": np.asarray(fac.local.shape)}


@case()
def trsm(c):
    from nonlinpdes_gpsolver_tpu_torch.parallel import (
        cholesky_blockcyclic, kernel_solve_blockcyclic, trsm_blockcyclic,
    )

    out = {}
    fac = cholesky_blockcyclic(c.t("spd160"), c.mesh, block=16)
    for m in (1, 7, 64):
        out[f"Y{m}"] = np_(trsm_blockcyclic(fac, c.t("V160")[:, :m]))
    out["y_vec"] = np_(trsm_blockcyclic(cholesky_blockcyclic(c.t("spd96"), c.mesh, block=16),
                                        c.t("v96")))
    fac144 = cholesky_blockcyclic(c.t("spd144"), c.mesh, block=16)
    out["Y_trans"] = np_(trsm_blockcyclic(fac144, c.t("V144"), trans=True))
    out["w_kernel"] = np_(kernel_solve_blockcyclic(
        cholesky_blockcyclic(c.t("spd128"), c.mesh, block=16), c.t("v128")))
    for m in (5, 16, 24):  # this rank's columns: rank, rank + P, ...
        V = c.t(f"Vcols{m}")[:, c.rank :: c.P]
        for trans in (False, True):
            out[f"cols{m}_{int(trans)}"] = np_(trsm_blockcyclic(fac144, V, trans=trans,
                                                                shard_cols=True))
    return out


@case()
def matvec(c):
    from nonlinpdes_gpsolver_tpu_torch.parallel import (
        cholesky_blockcyclic, matvec_blockcyclic, shard_rows_blockcyclic,
    )

    A, v = c.t("spd_mv100"), c.t("v100")
    Ash = shard_rows_blockcyclic(A, c.mesh, "p", 8)
    fac = cholesky_blockcyclic(A, c.mesh, block=8)
    return {"Av": np_(matvec_blockcyclic(Ash, c.mesh, "p", 8, v, n=100)),
            "Ltv": np_(matvec_blockcyclic(fac.local, c.mesh, "p", 8, v, trans=True, n=100)),
            "shard_rows": np.asarray(Ash.shape)}


# -- the mesh path: assembly, fused factor, Gauss-Newton, posterior ------------------


def elliptic(c, prefix):
    import nonlinpdes_gpsolver_tpu_torch as tpt

    i = c.inp
    return tpt.interop.problem_from_numpy(i[prefix + "Xd"], i[prefix + "Xb"], i[prefix + "f"],
                                          i[prefix + "g"], i[prefix + "z0"], i[prefix + "inv_sq"],
                                          device="cpu")


def darcy(c):
    import nonlinpdes_gpsolver_tpu_torch as tpt

    i = c.inp
    return tpt.interop.darcy_from_numpy(i["dXd"], i["dXb"], i["df"], i["dg"], i["dobs"], i["dz0"],
                                        i["dinv_sq"], noise_level=1e-2, device="cpu")


FUSED_KW = dict(block=16, nugget=1e-6, superblock_cols=48, chunk_cols=32)


@case(2, 4)
def assembly_and_fused(c):
    """The two-pass assembly (gathered) of the 340-row elliptic fixture at
    nugget 1e-9, and its fused factor (gathered, and this rank's diag_inv)
    at nugget 1e-6, at P and at 1."""
    from nonlinpdes_gpsolver_tpu_torch.parallel import (
        assemble_factor_fused, assemble_gram_sharded, unshard_rows_blockcyclic,
    )

    prob = elliptic(c, "e")
    b = prob.blocks[0]
    arranged, d = assemble_gram_sharded(b.kernel, b.observables, prob.points, c.mesh, block=16,
                                        nugget=1e-9)
    n_pad = arranged.shape[2]
    full = unshard_rows_blockcyclic(arranged, c.mesh, "p", 16, n_pad)
    res = assemble_factor_fused(b.kernel, b.observables, prob.points, c.mesh, **FUSED_KW)
    one = assemble_factor_fused(b.kernel, b.observables, prob.points, c.one, **FUSED_KW)
    return {"gram": np_(full), "d": np_(d), "L": np_(res.factor.dense()),
            "winvs": np_(res.factor.diag_inv), "L1": np_(one.factor.dense()),
            "winvs1": np_(one.factor.diag_inv), "attempts": np.asarray(res.attempts),
            "local_shape": np.asarray(res.factor.local.shape)}


SOLVERS = {"elliptic": ("structured", "direct", "cg", "normal"),
           "darcy": ("structured", "direct", "cg", "woodbury", "normal")}
STEP_KW = {
    ("darcy", "cg"): dict(cg_tol=1e-9, cg_maxiter=2000, deflation_rank=72),
    ("darcy", "woodbury"): dict(cg_tol=1e-9, cg_maxiter=2000),
}
NUGGET = {"elliptic": 1e-8, "darcy": 1e-4}
FACTOR_KW = dict(block=32, superblock_cols=64)  # several superblocks, few steps a solve


def step_problem(c, name):
    return elliptic(c, "s") if name == "elliptic" else darcy(c)


def _steps(c, name, solvers):
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs
    from nonlinpdes_gpsolver_tpu_torch.solvers import distributed as td

    prob = step_problem(c, name)
    fps = {m.size: td.factorize_distributed(prob, m, nugget=NUGGET[name], **FACTOR_KW)
           for m in (c.mesh, c.one)}
    out = {"rungs": np.asarray(fps[c.P].rungs[prob.blocks[0].name])}
    for solver in solvers:
        kw = STEP_KW.get((name, solver), {})
        for P, fp in fps.items():
            before = dict(graphs.NORMAL_STATES)
            st = td.gn_solve_distributed(fp, max_iter=3, step_solver=solver, **kw)
            tag = f"{solver}_P{P}"
            out[f"states_{tag}"] = np.asarray([graphs.NORMAL_STATES[r] - before[r]
                                               for r in ("potri", "solves")])
            out[f"z_{tag}"], out[f"losses_{tag}"] = np_(st.z), np_(st.losses)
            out[f"iters_{tag}"] = np_(st.cg_iters)
            out[f"finite_{tag}"] = np.asarray(bool(st.converged_finite))
    return out


@case()
def steps_elliptic(c):
    return _steps(c, "elliptic", SOLVERS["elliptic"])


@case()
def steps_darcy(c):
    return _steps(c, "darcy", SOLVERS["darcy"])


@case(4)
def steps_elliptic_4(c):
    return _steps(c, "elliptic", ("structured", "cg"))


@case()
def posterior(c):
    """Weights, extension and variance at the JAX package's z*, at P and at 1."""
    from nonlinpdes_gpsolver_tpu_torch.solvers import distributed as td

    prob = elliptic(c, "s")
    z = c.t("post_z")
    Xt = c.t("post_Xt")
    out = {}
    for m in (c.mesh, c.one):
        post = td.DistributedPosterior(
            td.factorize_distributed(prob, m, nugget=NUGGET["elliptic"], **FACTOR_KW), z)
        out[f"w_P{m.size}"] = np_(post.weights("u"))
        out[f"ext_P{m.size}"] = np_(post.extend(Xt))
        out[f"var_P{m.size}"] = np_(post.variance(Xt))
    return out


ESCALATIONS = ("superblock", "probe", "two_pass")


@case()
def escalation(c):
    """The escalation ladder across ranks, on duplicated points (tests/
    test_torch_fused.py's fixture, nugget 1e-6, which the f64 Cholesky
    factors at the first scale): each failure is made on rank 1 alone, once
    (a superblock diagonal's Cholesky, the sampled rows of the probe, a
    diagonal block of the two-pass Cholesky), and every rank must take the
    same rung. Beside each, the factorization started at that rung."""
    import nonlinpdes_gpsolver_tpu_torch as tpt
    from nonlinpdes_gpsolver_tpu_torch.parallel import cholesky, fused
    from nonlinpdes_gpsolver_tpu_torch.solvers import distributed as td

    prob = elliptic(c, "q")
    out = {}
    for failure in ESCALATIONS:
        kw = dict(nugget=1e-6, block=16, superblock_cols=64, fused=failure != "two_pass")
        want = td.factorize_distributed(prob, c.mesh, start_scales={"u": 10.0}, **kw)
        mod, name = {"superblock": (fused, "cholesky_f64"),
                     "probe": (fused, "_sampled_rows_matvec"),
                     "two_pass": (cholesky, "cholesky_f64")}[failure]
        real, calls = getattr(mod, name), []

        def once(*a, _real=real, _failure=failure, **k):
            got = _real(*a, **k)
            calls.append(1)
            if c.rank != 1 or len(calls) > 1:
                return got
            if _failure == "probe":
                return got[0], got[1] * float("nan")
            return got[0], False

        setattr(mod, name, once)
        try:
            fp = td.factorize_distributed(prob, c.mesh, **kw)
        finally:
            setattr(mod, name, real)
        out[f"{failure}/scale"] = np.asarray(fp.nugget_scales["u"])
        out[f"{failure}/rungs"] = np.asarray(fp.rungs["u"])
        out[f"{failure}/attempts"] = np.asarray(fp.stats["u"]["attempts"])
        out[f"{failure}/L"] = np_(fp.factors["u"].dense())
        out[f"{failure}/want"] = np_(want.factors["u"].dense())
        out[f"{failure}/finite"] = np.asarray(
            bool(torch.isfinite(fp.whitened_residual(prob.init_latent())).all()))
    return out


@case()
def facade(c):
    """GPSolver with the P-rank mesh, end to end, beside the one-device mesh."""
    import nonlinpdes_gpsolver_tpu_torch as tpt

    prob = elliptic(c, "e")
    Xt = c.t("post_Xt")
    out = {}
    for m in (c.mesh, c.one):
        res = tpt.GPSolver(prob, nugget=1e-10, mesh=m, mesh_block=16).solve(max_iter=4)
        out[f"z_P{m.size}"] = np_(res.z)
        out[f"ext_P{m.size}"] = np_(res.posterior.extend(Xt))
        out[f"posterior_P{m.size}"] = np.asarray(type(res.posterior).__name__)
    return out


@case()
def two_process_solve(c):
    """The JAX package's two-process test program: 96/32 points, nugget
    1e-9, 16-row blocks, 2 structured steps."""
    from nonlinpdes_gpsolver_tpu_torch.solvers import distributed as td

    prob = elliptic(c, "t")
    out = {}
    for m in (c.mesh, c.one):
        st = td.gn_solve_distributed(td.factorize_distributed(prob, m, nugget=1e-9, block=16),
                                     max_iter=2, step_solver="structured")
        out[f"z_P{m.size}"], out[f"losses_P{m.size}"] = np_(st.z), np_(st.losses)
    return out


@case()
def interop(c):
    """The JAX package's P-device factor dealt to the ranks: the whitened
    residual at a fixed z."""
    import nonlinpdes_gpsolver_tpu_torch as tpt
    from nonlinpdes_gpsolver_tpu_torch.solvers import distributed as td

    i = c.inp
    prob = elliptic(c, "s")
    fac, d = tpt.interop.factor_from_numpy(i["jf_local"], i["jf_diag_inv"], FACTOR_KW["block"],
                                           int(i["jf_n"]),
                                           int(i["jf_n_pad"]), i["jf_d"], n_devices=2,
                                           mesh=c.mesh)
    fp = td.DistributedFactoredProblem(prob, {"u": fac}, {"u": d}, {"u": 1.0}, {"u": 0},
                                       {"u": 0.0}, {"u": {}})
    return {"r": np_(fp.whitened_residual(c.t("jf_z"))), "local": np_(fac.local)}


@case()
def shared_loop(c):
    """The mesh loop across ranks (the elliptic step problem, f scaled per
    problem so that each is a new problem of one layout): the host
    agreements of a solve of 1 and of 3 steps (``'structured'`` and
    ``'cg'``); a second problem after the first is gone, its binds, its
    solution and the same problem solved unshared; then a third problem
    whose factor rank 1 alone still holds a piece of, and the binds of the
    fourth problem that follows it."""
    import nonlinpdes_gpsolver_tpu_torch as tpt
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs
    from nonlinpdes_gpsolver_tpu_torch.parallel import comm
    from nonlinpdes_gpsolver_tpu_torch.solvers import _reuse
    from nonlinpdes_gpsolver_tpu_torch.solvers import distributed as td

    i = c.inp

    def factor(scale):
        prob = tpt.interop.problem_from_numpy(i["sXd"], i["sXb"], scale * i["sf"], i["sg"],
                                              i["sz0"], i["sinv_sq"], device="cpu")
        return td.factorize_distributed(prob, c.mesh, nugget=NUGGET["elliptic"], **FACTOR_KW)

    def solve(fp):
        return td.gn_solve_distributed(fp, max_iter=3, step_solver="cg")

    _reuse.clear_graph_cache()
    out = {}
    fp = factor(1.0)
    for solver in ("structured", "cg"):
        for steps in (1, 3):
            comm.reset_counts()
            td.gn_solve_distributed(fp, max_iter=steps, step_solver=solver)
            out[f"agreements_{solver}_{steps}"] = np.asarray(comm.AGREEMENTS)
    solve(fp)
    del fp
    graphs.reset_counts()
    fp = factor(1.1)
    out["second/binds"] = np.asarray([graphs.ENTRIES, graphs.REBINDS, graphs.UNSHARED])
    out["second/in_entry"] = np.asarray(_reuse._in_entry(fp.factors["u"].local))
    st = solve(fp)
    out["second/z"], out["second/losses"] = np_(st.z), np_(st.losses)
    del fp
    with _reuse._unshared():
        st = solve(factor(1.1))
    out["unshared/z"], out["unshared/losses"] = np_(st.z), np_(st.losses)
    fp = factor(1.2)
    held = fp.factors["u"].local[:1] if c.rank == 1 else None
    del fp
    graphs.reset_counts()
    fp = factor(1.3)
    out["held/binds"] = np.asarray([graphs.ENTRIES, graphs.REBINDS, graphs.UNSHARED])
    del fp, held
    return out


@case()
def sweep(c):
    """Three live mesh problems of one layout (the elliptic step problem, f
    scaled per problem), every one kept: the binds, guest loads and the
    solve's host agreements of each; the third one's solution and losses,
    and again after the first one's solve; and the same problem solved
    unshared."""
    import nonlinpdes_gpsolver_tpu_torch as tpt
    from nonlinpdes_gpsolver_tpu_torch.ops import graphs
    from nonlinpdes_gpsolver_tpu_torch.parallel import comm
    from nonlinpdes_gpsolver_tpu_torch.solvers import _reuse
    from nonlinpdes_gpsolver_tpu_torch.solvers import distributed as td

    i = c.inp

    def factor(scale):
        prob = tpt.interop.problem_from_numpy(i["sXd"], i["sXb"], scale * i["sf"], i["sg"],
                                              i["sz0"], i["sinv_sq"], device="cpu")
        return td.factorize_distributed(prob, c.mesh, nugget=NUGGET["elliptic"], **FACTOR_KW)

    def solve(fp):
        return td.gn_solve_distributed(fp, max_iter=3, step_solver="cg")

    _reuse.clear_graph_cache()
    out, live = {}, []
    for k, scale in enumerate((1.0, 1.1, 1.2)):
        graphs.reset_counts()
        live.append(factor(scale))
        out[f"binds{k}"] = np.asarray([graphs.ENTRIES, graphs.REBINDS, graphs.UNSHARED,
                                       graphs.GUESTS])
        comm.reset_counts()
        st = solve(live[-1])
        out[f"loads{k}"] = np.asarray(graphs.GUEST_LOADS)
        out[f"agreements{k}"] = np.asarray(comm.AGREEMENTS)
    guest = live[2]
    out["guest/bound"] = np.asarray(_reuse.bound_entry(guest) is not None)
    out["guest/in_entry"] = np.asarray(_reuse._in_entry(guest.factors["u"].local))
    out["guest/z"], out["guest/losses"] = np_(st.z), np_(st.losses)
    graphs.reset_counts()
    solve(live[0])
    st = solve(guest)  # the guest entry holds it still: no copy
    out["again/loads"] = np.asarray(graphs.GUEST_LOADS)
    out["again/z"] = np_(st.z)
    with _reuse._unshared():
        st = solve(factor(1.2))
    out["unshared/z"], out["unshared/losses"] = np_(st.z), np_(st.losses)
    out["entries"] = np.asarray(len(_reuse.entries()))
    del live, guest, st
    # the sweep gone, rank 0 keeps the released guest entry and rank 1 none:
    # the next guest's ranks disagree on it, and both make a new one
    if c.rank == 1:
        _reuse.clear_graph_cache()
    live = [factor(s) for s in (1.3, 1.4)]
    guest = factor(1.5)
    out["disagree/kept"] = np.asarray([e.hosting for e in _reuse.entries()].count(True))
    st = solve(guest)
    host = _reuse.serving(guest)
    out["disagree/new"] = np.asarray(host in _reuse.entries() and host.generation == 1)
    out["disagree/hosting"] = np.asarray([e.hosting for e in _reuse.entries()].count(True))
    out["disagree/z"] = np_(st.z)
    del live, guest, host
    with _reuse._unshared():
        out["disagree/unshared_z"] = np_(solve(factor(1.5)).z)
    return out


# -- utils/checkpoint.py across ranks: tests/test_torch_checkpoint.py -----------------

@case(4, group="checkpoint")
def checkpoint_save(c):
    """The mesh path at P = 4 (nugget 1e-9, 8-row blocks, 2 GN steps) saved
    to ``DIR/port_P4.npz``."""
    from nonlinpdes_gpsolver_tpu_torch.solvers import distributed as td
    from nonlinpdes_gpsolver_tpu_torch.utils.checkpoint import save_distributed_state

    dfp = td.factorize_distributed(elliptic(c, "k"), c.mesh, nugget=1e-9, block=8)
    st = td.gn_solve_distributed(dfp, max_iter=2)
    save_distributed_state(os.path.join(c.dir, "port_P4.npz"), dfp, st)
    return {"z": np_(st.z), "r": np_(dfp.whitened_residual(st.z)),
            "local": np_(dfp.factors["u"].local), "diag_inv": np_(dfp.factors["u"].diag_inv)}


@case(2, group="checkpoint")
def checkpoint_load(c):
    """The P = 4 file and the JAX package's 8-device file (``DIR/jax_P8.npz``)
    reloaded at P = 2: z, the whitened residual at it, this rank's shard and
    the rebuilt diagonal-block inverses; one more GN step from the P = 4 state."""
    from nonlinpdes_gpsolver_tpu_torch.solvers import distributed as td
    from nonlinpdes_gpsolver_tpu_torch.utils.checkpoint import load_distributed_state

    prob = elliptic(c, "k")
    out = {}
    for name in ("port_P4", "jax_P8"):
        dfp, st = load_distributed_state(os.path.join(c.dir, f"{name}.npz"), prob, c.mesh)
        out.update({f"{name}/z": np_(st.z), f"{name}/r": np_(dfp.whitened_residual(st.z)),
                    f"{name}/local": np_(dfp.factors["u"].local),
                    f"{name}/diag_inv": np_(dfp.factors["u"].diag_inv)})
        if name == "port_P4":
            out["resume/losses"] = np_(td.gn_solve_distributed(dfp, z0=st.z, max_iter=1).losses)
    return out


# -- the ranks ---------------------------------------------------------------------


def rank_main(rank, P, port, directory, group):
    _block_jax()
    torch.set_num_threads(1)
    from nonlinpdes_gpsolver_tpu_torch.parallel import initialize_distributed, make_mesh

    assert initialize_distributed(f"tcp://127.0.0.1:{port}", P, rank, backend="gloo")
    try:
        mesh, one = make_mesh(P, device="cpu"), make_mesh(1, device="cpu")
        assert (mesh.size, mesh.rank, mesh.backend) == (P, rank, "gloo")
        with np.load(os.path.join(directory, "inputs.npz")) as npz:
            inp = {k: npz[k] for k in npz.files}
        c = Ctx(mesh, one, inp, directory)
        out = {}
        for name, (fn, sizes, in_group) in CASES.items():
            if P in sizes and in_group == group:
                out.update({f"{name}/{k}": v for k, v in fn(c).items()})
        leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        if leaked:
            raise RuntimeError(f"the rank worker imported {leaked}")
        np.savez(os.path.join(directory, f"out_P{P}_rank{rank}.npz"), **out)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def main(directory, sizes, group="mesh"):
    _block_jax()
    for P in sizes:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        mp.spawn(rank_main, args=(P, port, directory, group), nprocs=P, join=True)


if __name__ == "__main__":
    main(sys.argv[1], [int(P) for P in sys.argv[2].split(",")], *sys.argv[3:4])
