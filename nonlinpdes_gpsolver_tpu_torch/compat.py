"""The reference's ``solver_GP`` API over the port's :class:`~.api.GPSolver`.

Counterpart of ``nonlinpdes_gpsolver_tpu/compat.py``: a driver script written
for the reference (``src/solver.py:41-206`` upstream: string PDE types, an
argparse-style config namespace, ``set_equation`` / ``auto_sample`` /
``solve`` / ``test`` / error printers) runs on the port with an import change:

    from nonlinpdes_gpsolver_tpu_torch.compat import solver_GP

The methods, attributes and errors are the JAX facade's. Here:

* the solve runs on ``cfg.device`` (default: the CUDA card; ``"cpu"`` on the
  CPU), in that device's dtype (f32 on the card, f64 on the CPU); points,
  solutions and test predictions are tensors there;
* boundary and right-hand-side callables are torch functions of either
  ``(x1, x2)`` scalars (the reference's convention) or one 2-vector; they may
  return a Python number for a constant;
* ``auto_sample`` draws from the port's sampler with
  ``torch.Generator(...).manual_seed(cfg.randomseed)`` (not the JAX draw);
  observation noise comes from ``numpy.random.default_rng(cfg.randomseed)``;
* an integer ``cfg.mesh`` n > 0 solves on the mesh path over
  ``parallel.make_mesh(n)``: n > 1 needs a running process group of n
  ranks and raises ``ValueError`` without one;
* the ``show_*`` figures go through :mod:`.utils.plotting` (matplotlib is
  imported at the first figure).
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Optional

import numpy as np
import torch

from .ops.backend import default_dtype, resolve_device

PDE_TYPES = ("Nonlinear_elliptic", "Burgers", "Eikonal", "Darcy_flow2d")


def _as_vec_fn(fn: Optional[Callable]):
    """Accept f(x1, x2) (reference style) or f(x) with x a 2-vector; a
    Python-number result becomes a tensor, so that ``vmap`` takes it."""
    if fn is None:
        return None
    try:
        n_params = len(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        n_params = 2
    f = (lambda x: fn(x[0], x[1])) if n_params >= 2 else fn

    def vec(x):
        out = f(x)
        return out if isinstance(out, torch.Tensor) else torch.full_like(x[0], float(out))

    return vec


class solver_GP:
    """Reference-API facade over :class:`..api.GPSolver`."""

    def __init__(self, cfg: Any, PDE_type: str = "Nonlinear_elliptic"):
        self.config = cfg
        self.PDE_type = PDE_type
        if PDE_type not in PDE_TYPES:
            raise ValueError(f"unknown PDE type {PDE_type!r}")
        self._device = resolve_device(getattr(cfg, "device", None))
        self._dtype = default_dtype(self._device)
        self._bdy = None
        self._rhs = None
        self._domain = ((0.0, 1.0), (0.0, 1.0))
        self._X_domain = None
        self._X_boundary = None
        self._data_u = None
        self._noise_level = None
        self._result = None
        self._prob = None

    def _tensor(self, a) -> torch.Tensor:
        """``a`` (an array, a tensor or a number) on the solve's device, in its dtype."""
        if isinstance(a, torch.Tensor):
            return a.to(device=self._device, dtype=self._dtype)
        return torch.as_tensor(np.array(a, dtype=np.float64), dtype=self._dtype,
                               device=self._device)

    # -- kernel ----------------------------------------------------------
    def _kernel(self):
        from .ops.kernels import SquaredExponential

        name = getattr(self.config, "kernel", "Gaussian").lower()
        param = getattr(self.config, "kernel_parameter", 0.2)
        if "anisotropic" in name:
            # Both upstream sigma conventions are honored: 'lengthscale'
            # (src/kernels.py:96-98 divides by sigma - the CLI default) and
            # 'precision' (the Burgers notebook multiplies, set_sigma=[3,20]).
            conv = getattr(self.config, "aniso_convention", "lengthscale")
            return SquaredExponential.anisotropic(list(np.atleast_1d(param)), conv)
        return SquaredExponential.gaussian(float(np.atleast_1d(param)[0]))

    def _seed(self) -> int:
        return int(getattr(self.config, "randomseed", 0) or 0)

    # -- reference API ---------------------------------------------------
    def set_equation(self, bdy=None, rhs=None, domain=None):
        self._bdy = _as_vec_fn(bdy)
        self._rhs = _as_vec_fn(rhs)
        if domain is not None:
            d = np.asarray(domain, dtype=float)
            self._domain = ((d[0, 0], d[0, 1]), (d[1, 0], d[1, 1]))

    def auto_sample(self, N_domain, N_boundary, sampled_type="random"):
        from .utils.sampling import sample_grid, sample_random

        td = self.PDE_type == "Burgers"
        if sampled_type == "grid":
            Xd, Xb = sample_grid(N_domain, N_boundary, self._domain, td,
                                 device=self._device, dtype=self._dtype)
        else:
            gen = torch.Generator(device=self._device).manual_seed(self._seed())
            Xd, Xb = sample_random(gen, N_domain, N_boundary, self._domain, td, dtype=self._dtype)
        self.get_sample(Xd, Xb)

    def get_sample(self, X_domain, X_boundary):
        self._X_domain = self._tensor(X_domain)
        self._X_boundary = self._tensor(X_boundary)

    def auto_sample_IP(self, N_domain, N_boundary, N_data, sampled_type="random"):
        self.auto_sample(N_domain, N_boundary, sampled_type)
        self._N_data = int(N_data)
        self.X_data = self._X_domain[: self._N_data]

    def get_sample_IP(self, X_domain, X_boundary, X_data):
        self.get_sample(X_domain, X_boundary)
        self._N_data = X_data.shape[0]
        self.X_data = self._tensor(X_data)

    def get_observed_data(self, data_u, noise_level=0.0):
        rng = np.random.default_rng(self._seed())
        data_u = np.asarray(data_u).reshape(-1)
        self._data_u = data_u + noise_level * rng.standard_normal(data_u.shape[0])
        self._noise_level = max(noise_level, 1e-12)

    def _build_problem(self, method, pen_lambda):
        from . import models

        cfg = self.config
        kernel = self._kernel()
        initial = getattr(cfg, "initial_sol", "rdm")
        init = "zero" if initial == "zero" else "random"
        seed = self._seed()
        if self.PDE_type == "Nonlinear_elliptic":
            alpha = float(getattr(cfg, "alpha", 1.0))
            m = int(getattr(cfg, "m", 3))
            if method == "relaxation":
                return models.nonlinear_elliptic_relaxed(
                    kernel, self._X_domain, self._X_boundary, self._rhs,
                    self._bdy, alpha=alpha, m=m, pen_lambda=pen_lambda,
                    init=init, seed=seed,
                )
            return models.nonlinear_elliptic(
                kernel, self._X_domain, self._X_boundary, self._rhs,
                self._bdy, alpha=alpha, m=m, init=init, seed=seed,
            )
        if self.PDE_type == "Burgers":
            return models.burgers(
                kernel, self._X_domain, self._X_boundary, self._bdy,
                rhs_f=self._rhs, alpha=float(getattr(cfg, "alpha", 1.0)),
                nu=float(getattr(cfg, "nu", 0.02)), init=init, seed=seed,
            )
        if self.PDE_type == "Eikonal":
            return models.eikonal(
                kernel, self._X_domain, self._X_boundary, self._rhs,
                bdy_g=self._bdy, eps=float(getattr(cfg, "eps", 0.1)),
                init=init, seed=seed,
            )
        # Darcy_flow2d
        if self._data_u is None:
            raise RuntimeError("call get_observed_data before solve()")
        return models.darcy_flow(
            kernel, kernel, self._X_domain, self._X_boundary, self._tensor(self._data_u),
            rhs_f=self._rhs, bdy_g=self._bdy, noise_level=self._noise_level,
            init=init, seed=seed,
        )

    def solve(self, method="elimination", pen_lambda=None):
        from .api import GPSolver

        cfg = self.config
        if pen_lambda is None:
            pen_lambda = float(getattr(cfg, "pen_lambda", 1e-10))
        if method == "relaxation" and self.PDE_type != "Nonlinear_elliptic":
            raise ValueError(
                "relaxation is implemented for Nonlinear_elliptic only "
                "(matches the reference)"
            )
        self._prob = self._build_problem(method, pen_lambda)
        # cfg.mesh opens the mesh path to reference-style drivers: an int is
        # a rank count (0/None = dense), anything else a ready-made
        # parallel.Mesh.
        mesh = getattr(cfg, "mesh", None)
        if isinstance(mesh, (int, np.integer)):
            if mesh:
                from .parallel.mesh import make_mesh

                mesh = make_mesh(int(mesh), device=self._device)
            else:
                mesh = None
        solver = GPSolver(
            self._prob,
            nugget=float(getattr(cfg, "nugget", 1e-10)),
            nugget_type=getattr(cfg, "nugget_type", "adaptive"),
            mesh=mesh,
            mesh_block=int(getattr(cfg, "mesh_block", 512)),
        )
        self._result = solver.solve(
            max_iter=int(getattr(cfg, "GNsteps", 8)),
            step_size=float(getattr(cfg, "step_size", 1.0)),
            tol=getattr(cfg, "tol", None),
            step_solver=getattr(cfg, "step_solver", "auto"),
        )
        self.loss_hist = list(self._result.losses)
        if getattr(cfg, "print_hist", True):
            for i, l in enumerate(self.loss_hist, 1):
                print(f"iter = {i}  Loss = {l}")
        return self._result

    # -- solution accessors ---------------------------------------------
    @property
    def sol_on_collocation_pts(self) -> torch.Tensor:
        """u at interior collocation points (reference: eqn.sol_sampled_pts)."""
        z = self._result.z
        N_d = self._X_domain.shape[0]
        if self.PDE_type == "Nonlinear_elliptic":
            return z[-N_d:] if z.shape[0] == 2 * N_d else z  # relaxed: w part
        if self.PDE_type in ("Burgers", "Eikonal"):
            return z[:N_d]  # v0
        return z[3 * N_d : 4 * N_d]  # Darcy: v0

    def test(self, X_test):
        X_test = self._tensor(X_test)
        if self.PDE_type == "Darcy_flow2d":
            self.extended_sol_u = self._result.posterior.extend(X_test, block="u")
            self.extended_sol_a = self._result.posterior.extend(X_test, block="a")
            self.extended_sol = self.extended_sol_u
        else:
            self.extended_sol = self._result.posterior.extend(X_test)
        return self.extended_sol

    def collocation_pts_err(self, truth, print_option=True):
        from .utils.metrics import error_stats

        stats = error_stats(self.sol_on_collocation_pts, self._tensor(truth))
        self.pts_max_err, self.pts_L2_err = stats.max, stats.l2
        if print_option:
            print(f"[Collocation point error] Max error {stats.max}")
            print(f"[Collocation point error] L2 error {stats.l2}")
        return stats

    def get_test_error(self, truth, print_option=True):
        from .utils.metrics import error_stats

        self.truth_holder = self._tensor(truth)
        stats = error_stats(self.extended_sol, self.truth_holder)
        self.test_max_err, self.test_L2_err = stats.max, stats.l2
        if print_option:
            print(f"[Test error] Max error {stats.max}")
            print(f"[Test error] L2 error {stats.l2}")
        return stats

    # -- plotting (lazy) -------------------------------------------------
    def show_loss_hist(self):
        from .utils.plotting import loss_history

        return loss_history(self.loss_hist)

    def show_sample(self):
        from .utils.plotting import sample_scatter

        return sample_scatter(self._X_domain, self._X_boundary)

    show_sample_IP = show_sample

    def show_IP_result(self, X_test, truth_a=None, truth_u=None):
        """Darcy 2x2 panels: true vs recovered ``a`` and ``u`` at X_test
        (the figure the reference driver builds inline,
        ``main_DarcyFlow2d.py:139-172`` upstream). Call after ``test()``."""
        from .utils.plotting import field_panels

        if self.PDE_type != "Darcy_flow2d":
            raise ValueError("show_IP_result is the Darcy inverse-problem plot")
        fields, titles = [], []
        if truth_a is not None:
            fields.append(truth_a)
            titles.append("true $a$")
        fields.append(torch.exp(self.extended_sol_a))
        titles.append("recovered $a$")
        if truth_u is not None:
            fields.append(truth_u)
            titles.append("true $u$")
        fields.append(self.extended_sol_u)
        titles.append("recovered $u$")
        return field_panels(X_test, fields, titles, ncols=2)

    def contour_of_test_err(self, XX=None, YY=None):
        from .utils.plotting import contour_error

        if XX is None:
            raise ValueError("pass the test meshgrid XX, YY")
        X_test = np.stack([np.ravel(XX), np.ravel(YY)], axis=1)
        return contour_error(X_test, self.extended_sol, self.truth_holder)
