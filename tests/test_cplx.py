"""Complex-as-real arithmetic core, incl. closed-form small solves."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ofdm_lte_tpu import cplx
from ofdm_lte_tpu.cplx import C


def test_basic_arithmetic(rng):
    a = rng.standard_normal(16) + 1j * rng.standard_normal(16)
    b = rng.standard_normal(16) + 1j * rng.standard_normal(16)
    ca, cb = cplx.from_numpy(a), cplx.from_numpy(b)
    np.testing.assert_allclose((ca * cb).to_numpy(), a * b, atol=1e-6)
    np.testing.assert_allclose((ca / cb).to_numpy(), a / b, atol=1e-5)
    np.testing.assert_allclose((ca - cb).to_numpy(), a - b, atol=1e-6)
    np.testing.assert_allclose(ca.conj().to_numpy(), np.conj(a), atol=1e-6)
    np.testing.assert_allclose(np.asarray(ca.abs2()), np.abs(a) ** 2,
                               atol=1e-5)
    np.testing.assert_allclose(cplx.expi(jnp.asarray(a.real)).to_numpy(),
                               np.exp(1j * a.real), atol=1e-6)


def test_matmul(rng):
    a = rng.standard_normal((8, 16)) + 1j * rng.standard_normal((8, 16))
    b = rng.standard_normal((16, 4)) + 1j * rng.standard_normal((16, 4))
    got = cplx.matmul(cplx.from_numpy(a), cplx.from_numpy(b)).to_numpy()
    np.testing.assert_allclose(got, a @ b, atol=1e-4)


def test_matmul_small_matches_matmul(rng):
    """Elementwise broadcast-FMA form vs dot_general, incl. broadcast leading dims."""
    a = rng.standard_normal((5, 7, 2, 3)) + 1j * rng.standard_normal((5, 7, 2, 3))
    b = rng.standard_normal((5, 7, 3, 4)) + 1j * rng.standard_normal((5, 7, 3, 4))
    got = cplx.matmul_small(cplx.from_numpy(a), cplx.from_numpy(b)).to_numpy()
    np.testing.assert_allclose(got, a @ b, atol=1e-5)
    # unbatched rhs broadcasting against a batched lhs (the W-precoder case)
    w = rng.standard_normal((3, 2)) + 1j * rng.standard_normal((3, 2))
    got2 = cplx.matmul_small(cplx.from_numpy(a), cplx.from_numpy(w)).to_numpy()
    np.testing.assert_allclose(got2, a @ w, atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6])
def test_solve_matches_numpy(n, rng):
    """Closed-form (n≤4) and block-embedded (n>4) complex solves."""
    batch = 7
    a = rng.standard_normal((batch, n, n)) + 1j * rng.standard_normal((batch, n, n))
    a = a + n * np.eye(n)   # well conditioned
    b = rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))
    got = cplx.solve(cplx.from_numpy(a), cplx.from_numpy(b)).to_numpy()
    ref = np.linalg.solve(a, b[..., None])[..., 0]
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_take_along(rng):
    x = rng.standard_normal((5, 4)) + 1j * rng.standard_normal((5, 4))
    idx = np.array([0, 3, 1, 2, 0])
    got = cplx.take_along(cplx.from_numpy(x), jnp.asarray(idx)).to_numpy()
    np.testing.assert_allclose(got, x[np.arange(5), idx], atol=1e-6)


def test_pytree_compatible():
    import jax
    c = cplx.cones((4,))
    doubled = jax.jit(lambda x: x * 2.0)(c)
    assert isinstance(doubled, C)
    np.testing.assert_allclose(doubled.to_numpy(), np.full(4, 2.0 + 0j))


def test_matmul_gauss_matches_4mult(rng):
    """3-multiply Gauss form vs the 4-multiply expansion (cplx.matmul)."""
    a = C(jnp.asarray(rng.standard_normal((128, 300)), jnp.float32),
          jnp.asarray(rng.standard_normal((128, 300)), jnp.float32))
    b = C(jnp.asarray(rng.standard_normal((300, 96)), jnp.float32),
          jnp.asarray(rng.standard_normal((300, 96)), jnp.float32))
    ref = cplx.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    out = cplx.matmul_gauss(a, b, precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(np.asarray(out.re), np.asarray(ref.re),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(np.asarray(out.im), np.asarray(ref.im),
                               rtol=1e-5, atol=1e-3)
