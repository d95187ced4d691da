"""The port's tiny dense linear algebra against the JAX package's.

Both sides run the same unrolled entry-by-entry recursion for n <= 24, so in
fp64 they agree to roundoff; above that limit both call their library's
Cholesky and triangular solve, which order the arithmetic differently.  On
well-conditioned SPD inputs (eigenvalues in [2, ~10]) either way is a few
ulps of fp64, so the bar is 1e-12 relative.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sip_optimal_control_tpu.ops import linalg as JL
from sip_optimal_control_tpu_torch.ops import linalg as PL

_TOL = 1e-12


def _spd(rng, lead, n):
    s = rng.standard_normal(lead + (n, n)) / np.sqrt(n)
    return s @ np.swapaxes(s, -1, -2) + 2.0 * np.eye(n)


@pytest.mark.parametrize("n", [1, 4, 30])      # 30 > the unroll limit
def test_factor_and_solves_match_jax(n):
    rng = np.random.default_rng(n)
    a = _spd(rng, (3, 2), n)
    b_vec = rng.standard_normal((3, 2, n))
    b_mat = rng.standard_normal((3, 2, n, 3))

    l_j, ok_j = JL.cholesky_with_ok(jnp.asarray(a))
    l_p, ok_p = PL.cholesky_with_ok(torch.as_tensor(a))
    assert bool(np.all(np.asarray(ok_j))) and bool(ok_p.all())
    np.testing.assert_allclose(l_p.numpy(), np.asarray(l_j), rtol=_TOL,
                               atol=_TOL)
    for b in (b_vec, b_mat):
        for transpose in (False, True):
            np.testing.assert_allclose(
                PL.tri_solve(l_p, torch.as_tensor(b), transpose).numpy(),
                np.asarray(JL.tri_solve(l_j, jnp.asarray(b), transpose)),
                rtol=_TOL, atol=_TOL)
        x = PL.cho_solve(l_p, torch.as_tensor(b)).numpy()
        np.testing.assert_allclose(
            x, np.asarray(JL.cho_solve(l_j, jnp.asarray(b))), rtol=_TOL,
            atol=_TOL)
        ax = a @ (x if b.ndim == a.ndim else x[..., None])
        np.testing.assert_allclose(ax.reshape(b.shape), b, rtol=1e-10,
                                   atol=1e-10)
    np.testing.assert_allclose(PL.sym(torch.as_tensor(a + b_mat[..., :1])
                                      ).numpy(),
                               np.asarray(JL.sym(jnp.asarray(
                                   a + b_mat[..., :1]))), rtol=0, atol=0)


def test_non_pd_flagged_per_matrix():
    """Failure is data: only the indefinite matrix of the batch is not ok."""
    rng = np.random.default_rng(7)
    a = _spd(rng, (4,), 4)
    a[2, 3, 3] = -5.0
    _, ok_j = JL.cholesky_with_ok(jnp.asarray(a))
    _, ok_p = PL.cholesky_with_ok(torch.as_tensor(a))
    assert ok_p.tolist() == [True, True, False, True]
    assert ok_p.tolist() == np.asarray(ok_j).tolist()
