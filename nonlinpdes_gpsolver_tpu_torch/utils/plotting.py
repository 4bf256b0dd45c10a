"""Optional matplotlib figures (matplotlib imported at first use only).

A copy of ``nonlinpdes_gpsolver_tpu/utils/plotting.py``: loss history,
sample scatter, error contours and the Darcy 2x2 panels, without the
reference's import-time LaTeX rcParams. Every function takes data (numpy
arrays, or tensors on any device), creates a figure and returns it; callers
decide whether to ``show`` or ``savefig``. Importing this module, or the
package, does not import matplotlib: the card's machine may have none.
"""

from __future__ import annotations

import numpy as np


def _np(a) -> np.ndarray:
    """A numpy array of ``a`` (a tensor is detached and brought to the host)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _plt():
    import matplotlib

    matplotlib.use(matplotlib.get_backend())  # respect caller's backend
    import matplotlib.pyplot as plt

    return plt


def loss_history(losses, title="Gauss-Newton loss history"):
    plt = _plt()
    fig, ax = plt.subplots()
    losses = _np(losses)
    ax.plot(np.arange(len(losses)), losses)
    ax.set_yscale("log")
    ax.set_xlabel("GN step")
    ax.set_ylabel("loss")
    ax.set_title(title)
    return fig


def sample_scatter(X_domain, X_boundary, title="collocation points"):
    plt = _plt()
    fig, ax = plt.subplots()
    ax.scatter(*_np(X_domain).T, s=4, label="interior")
    ax.scatter(*_np(X_boundary).T, s=4, label="boundary")
    ax.legend()
    ax.set_title(title)
    return fig


def contour_error(X_test, pred, truth, title="test error"):
    """X_test must be a flattened tensor grid (n0*n1, 2)."""
    plt = _plt()
    X = _np(X_test)
    err = np.abs(_np(pred) - _np(truth))
    fig, ax = plt.subplots()
    c = ax.tricontourf(X[:, 0], X[:, 1], err, 50, cmap="coolwarm")
    fig.colorbar(c)
    ax.set_xlabel("$x_1$")
    ax.set_ylabel("$x_2$")
    ax.set_title(title)
    return fig


def field_panels(X_test, fields, titles, ncols=2):
    """Grid of tricontourf panels (the Darcy truth/recovered 2x2 figure)."""
    plt = _plt()
    X = _np(X_test)
    n = len(fields)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(5 * ncols, 4 * nrows))
    for ax, f, t in zip(np.ravel(axes), fields, titles):
        c = ax.tricontourf(X[:, 0], X[:, 1], _np(f), 50, cmap="coolwarm")
        fig.colorbar(c, ax=ax)
        ax.set_title(t)
    return fig
