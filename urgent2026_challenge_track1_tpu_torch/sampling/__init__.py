"""ODE samplers for flow-matching inference (counterpart of
``sampling/__init__.py``): the fixed-step euler, midpoint and heun updates
over the reference grid linspace(T_rev, t_eps, N), and the adaptive scipy
``solve_ivp`` sampler (RK45 by default, ``get_black_box_solver``).

PyTorch runs eagerly, so the fixed-step sampler is a Python loop over the N
steps; the adaptive one hands scipy a float64 copy of the state and makes
one model call on the model's device per function evaluation.  In both an
explicit prior ``x0`` (x_T) may replace the draw from the generator, so that
tests can hand both packages the same prior.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from urgent2026_challenge_track1_tpu_torch import tracing

__all__ = ["ODE_SOLVERS", "get_white_box_solver", "get_black_box_solver", "sample_flow"]


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
        with tracing.span(tracing.FLOW_STEP):
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


def get_black_box_solver(ode, vf_fn, y: torch.Tensor, rtol: float = 1e-5, atol: float = 1e-5,
                         T_rev: float = 1.0, t_eps: float = 0.03, method: str = "RK45",
                         **kwargs):
    """Adaptive scipy ``solve_ivp`` sampler (reference sampling/__init__.py:67-117).

    scipy integrates the flattened float64 (real, imaginary) state from
    T_rev down to t_eps; each evaluation is one ``vf_fn(x, t, y)`` call with
    x complex64 on y's device and t (B,) float32.  Returns a callable
    run(generator=None, x0=None) producing (sample, nfev); ``x0`` replaces
    the prior drawn with ``ode.prior_sampling``."""
    from scipy import integrate

    shape, B = y.shape, y.shape[0]

    def to_flat(x: torch.Tensor) -> np.ndarray:
        x = x.detach().cpu().numpy()
        return np.concatenate([x.real.reshape(-1), x.imag.reshape(-1)]).astype(np.float64)

    def from_flat(v: np.ndarray) -> torch.Tensor:
        half = v.shape[0] // 2
        x = (v[:half] + 1j * v[half:]).reshape(shape).astype(np.complex64)
        return torch.from_numpy(x).to(y.device)

    def run(generator: Optional[torch.Generator] = None, x0: Optional[torch.Tensor] = None):
        x_T = ode.prior_sampling(y, generator)[0] if x0 is None else x0

        def ode_func(t, v):
            vec_t = torch.full((B,), t, dtype=torch.float32, device=y.device)
            with torch.no_grad():
                return to_flat(vf_fn(from_flat(v), vec_t, y))

        sol = integrate.solve_ivp(ode_func, (T_rev, t_eps), to_flat(x_T), rtol=rtol, atol=atol,
                                  method=method, **kwargs)
        return from_flat(sol.y[:, -1]), sol.nfev

    return run
