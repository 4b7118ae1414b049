"""Fixed-step ODE samplers for flow-matching inference (counterpart of
``sampling/__init__.py``): the euler, midpoint and heun updates over the
reference grid linspace(T_rev, t_eps, N).

PyTorch runs eagerly, so the sampler is a Python loop over the N steps.  An
explicit prior ``x0`` (x_T) may replace the draw from the generator, so that
tests can hand both packages the same prior.  The adaptive scipy RK45
sampler (``get_black_box_solver``) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["ODE_SOLVERS", "get_white_box_solver", "sample_flow"]


def _euler(vf_fn, x, t, y, stepsize):
    dt = -stepsize
    return x + vf_fn(x, t, y) * dt


def _midpoint(vf_fn, x, t, y, stepsize):
    dt = -stepsize
    return x + dt * vf_fn(x + dt / 2.0 * vf_fn(x, t, y), t + dt / 2.0, y)


def _heun(vf_fn, x, t, y, stepsize):
    dt = -stepsize
    v = vf_fn(x, t, y)
    x_next = x + dt * v
    return x + dt / 2.0 * (v + vf_fn(x_next, t + dt, y))


ODE_SOLVERS = {"euler": _euler, "midpoint": _midpoint, "heun": _heun}
_EVALS = {"euler": 1, "midpoint": 2, "heun": 2}


def _timegrid(T_rev: float, t_eps: float, N: int):
    """Reference grid: linspace(T_rev, t_eps, N) in float32; step i uses
    stepsize t_i - t_{i+1}, the last step t_{N-1}."""
    ts = np.linspace(T_rev, t_eps, N, dtype=np.float32)
    steps = np.empty_like(ts)
    steps[:-1] = ts[:-1] - ts[1:]
    steps[-1] = ts[-1]
    return ts, steps


def sample_flow(vf_fn: Callable, ode, y: torch.Tensor, solver: str = "euler", N: int = 15,
                T_rev: float = 1.0, t_eps: float = 0.03,
                generator: Optional[torch.Generator] = None,
                x0: Optional[torch.Tensor] = None):
    """Integrate the reverse flow from the prior at T_rev down to t_eps.

    vf_fn(x, t, y) with t of shape (B,); y: (B, T, F) complex conditioning;
    ``x0``: the prior x_T (else drawn with ``ode.prior_sampling``).
    Returns (sample, nfe)."""
    update = ODE_SOLVERS[solver]
    ts, steps = _timegrid(T_rev, t_eps, N)
    x = ode.prior_sampling(y, generator)[0] if x0 is None else x0
    B = y.shape[0]
    for t, step in zip(ts.tolist(), steps.tolist()):
        vec_t = torch.full((B,), t, dtype=torch.float32, device=y.device)
        x = update(vf_fn, x, vec_t, y, step)
    return x, N * _EVALS[solver]


def get_white_box_solver(solver_name: str, ode, vf_fn, Y, T_rev: float = 1.0,
                         t_eps: float = 0.03, N: int = 30):
    """Reference-signature factory: returns run(generator=None, x0=None)
    producing (sample, n_steps)."""

    def run(generator: Optional[torch.Generator] = None, x0: Optional[torch.Tensor] = None):
        x, _ = sample_flow(vf_fn, ode, Y, solver=solver_name, N=N, T_rev=T_rev, t_eps=t_eps,
                           generator=generator, x0=x0)
        return x, N

    return run
