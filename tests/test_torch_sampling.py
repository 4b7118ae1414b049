"""The port's adaptive RK45 flow sampler (``get_black_box_solver``) against
the JAX package's on the CPU, from the same prior.

The JAX solver draws its prior from ``ode.prior_sampling``; it takes the
shared prior through a small ode object whose ``prior_sampling`` returns
it, and the port takes it as ``x0``.  scipy then integrates the same
float64 state with the same controls (rtol = atol = 1e-5, the JAX
defaults, never loosened here).

Tolerances: on a vector field that both packages compute with the same
float32 operations (a linear field), the samples are bitwise equal and nfev
is equal.  On the conditional BSRNN (16 channels x 2 layers, float32) the
two vector fields differ by ~1e-6 (other summation orders), which can in
principle flip one accept/reject decision of the step control near rtol;
nfev is required equal all the same, and the samples agree within 2e-4
absolute, the flow tests' forward tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from urgent2026_challenge_track1_tpu.models import bsrnn_flowse as jflow
from urgent2026_challenge_track1_tpu.sampling import get_black_box_solver as jsolver
from urgent2026_challenge_track1_tpu_torch.models import bsrnn_flowse as tflow
from urgent2026_challenge_track1_tpu_torch.sampling import get_black_box_solver
from urgent2026_challenge_track1_tpu_torch.utils.params import from_jax_params

torch.set_num_threads(1)
FWD_ATOL = 2e-4
FS = 16000
JCFG = jflow.FlowSEConfig(n_fft=960, hop_length=480, bsrnn_hidden=16, num_layer=2)
TCFG = tflow.FlowSEConfig(n_fft=960, hop_length=480, bsrnn_hidden=16, num_layer=2)


class _GivenPrior:
    """The JAX solver's ``ode``: its prior is the one handed to the port."""

    def __init__(self, x0):
        self.x0 = jnp.asarray(x0)

    def prior_sampling(self, key, y):
        return self.x0, None


def _spec(seed, shape=(1, 9, 161)):
    rng = np.random.default_rng(seed)
    return (0.3 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(
        np.complex64)


def test_rk45_on_a_linear_field_equals_jax_bitwise():
    y, x0 = _spec(0, (2, 5, 7)), _spec(1, (2, 5, 7))
    a = np.float32(1.7)

    def jvf(x, t, y_):
        return a * (x - y_) + t[:, None, None] * y_

    def tvf(x, t, y_):
        return a * (x - y_) + t[:, None, None] * y_

    ref, jnfev = jsolver(_GivenPrior(x0), jvf, jnp.asarray(y))()
    got, nfev = get_black_box_solver(None, tvf, torch.from_numpy(y))(x0=torch.from_numpy(x0))
    assert nfev == jnfev > 6
    assert got.dtype == torch.complex64 and got.shape == y.shape
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_rk45_on_the_flow_network_matches_jax():
    params = jax.tree.map(np.asarray, jflow.init_flowse(jax.random.PRNGKey(0), JCFG))
    model = from_jax_params(params)
    y = _spec(2)
    x0 = np.array(JCFG.ode.prior_sampling(jax.random.PRNGKey(3), jnp.asarray(y))[0])
    jvf = jax.jit(lambda x, t, y_: jflow.vector_field(params, JCFG, x, t, y_, FS))
    ref, jnfev = jsolver(_GivenPrior(x0), jvf, jnp.asarray(y), T_rev=JCFG.T_rev,
                         t_eps=JCFG.t_eps)()
    calls = []

    def tvf(x, t, y_):
        calls.append(x.shape)
        return tflow.vector_field(model, x, t, y_, FS)

    got, nfev = get_black_box_solver(TCFG.ode, tvf, torch.from_numpy(y), T_rev=TCFG.T_rev,
                                     t_eps=TCFG.t_eps)(x0=torch.from_numpy(x0))
    assert nfev == jnfev == len(calls)
    assert np.abs(got.numpy() - np.asarray(ref)).max() < FWD_ATOL
    # without x0 the prior comes from the ode and the generator
    again, _ = get_black_box_solver(TCFG.ode, tvf, torch.from_numpy(y))(
        generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(torch.view_as_real(again)).all()


@pytest.mark.parametrize("method", ["RK23", "DOP853"])
def test_other_solve_ivp_methods_pass_through(method):
    y, x0 = _spec(4, (1, 3, 5)), _spec(5, (1, 3, 5))

    def vf(x, t, y_):
        return 0.5 * (x - y_)

    ref, jnfev = jsolver(_GivenPrior(x0), vf, jnp.asarray(y), method=method)()
    got, nfev = get_black_box_solver(None, vf, torch.from_numpy(y), method=method)(
        x0=torch.from_numpy(x0))
    assert nfev == jnfev and np.array_equal(got.numpy(), np.asarray(ref))
