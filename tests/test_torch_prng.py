"""The port's threefry generator (``repro_torch.core.prng``) against
``jax.random`` with partitionable threefry (the installed ``jax``'s
default; set explicitly so the pinned 0.4.37 agrees): keys, splits,
fold-ins, bits and uniforms bit-exact; normals within ``NORMAL_RTOL`` /
``NORMAL_ATOL``, because the port evaluates XLA's float32 erfinv
polynomial with torch's ``log1p`` and one rounding per operation, where
XLA uses its own ``log1p`` and fused multiply-adds (last-bit
differences, at most 2.4e-7 relative over 1360 x 1360 draws)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

SEEDS = [0, 1, 42, 2**31 + 7, 123456789]
SHAPES = [(7,), (4, 6), (3, 5, 7), (1, 129)]


def _key(seed):
    return jax.random.key(seed)


def _data(key):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(key)))


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


@pytest.mark.parametrize('seed', SEEDS)
def test_prngkey_matches_reference(seed):
    assert prng.PRNGKey(seed) == _data(_key(seed))
    raw = np.asarray(jax.random.PRNGKey(seed))
    assert prng.PRNGKey(seed) == tuple(int(v) for v in raw)


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('data', [0, 1, 7, 999, 2**31 + 3, 2**32 - 1])
def test_fold_in_matches_reference(seed, data):
    want = _data(jax.random.fold_in(_key(seed), np.uint32(data)))
    assert prng.fold_in(prng.PRNGKey(seed), data) == want


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('num', [1, 2, 3, 5])
def test_split_matches_reference(seed, num):
    want = [_data(k) for k in jax.random.split(_key(seed), num)]
    assert list(prng.split(prng.PRNGKey(seed), num)) == want


def test_chained_derivation_matches_reference():
    """The engine's key chain: fold_in(PRNGKey(s), tick), then the
    timestep, the branch, a projection counter, and split into three."""
    jk, tk = _key(3), prng.PRNGKey(3)
    for d in (17, 981, 1, 4):
        jk, tk = jax.random.fold_in(jk, d), prng.fold_in(tk, d)
    want = [_data(k) for k in jax.random.split(jk, 3)]
    assert list(prng.split(tk, 3)) == want


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('shape', SHAPES)
def test_random_bits_bit_exact(seed, shape):
    want = np.asarray(jax.random.bits(_key(seed), shape, jnp.uint32))
    got = prng.random_bits(prng.PRNGKey(seed), shape, device='cpu')
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('lo,hi', [(0.0, 1.0), (-1.0, 1.0), (-3.5, 0.25)])
def test_uniform_bit_exact(shape, lo, hi):
    want = np.asarray(jax.random.uniform(_key(11), shape, minval=lo,
                                         maxval=hi))
    got = prng.uniform(prng.PRNGKey(11), shape, lo, hi, device='cpu')
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('seed', SEEDS)
@pytest.mark.parametrize('shape', SHAPES + [(136, 1360)])
def test_normal_within_stated_tolerance(seed, shape):
    want = np.asarray(jax.random.normal(_key(seed), shape))
    got = prng.normal(prng.PRNGKey(seed), shape, device='cpu').numpy()
    np.testing.assert_allclose(got, want, rtol=prng.NORMAL_RTOL,
                               atol=prng.NORMAL_ATOL)
    # most draws are bit-equal: the gap is last-bit rounding, not drift
    assert np.mean(got == want) > 0.8


def test_erfinv_edges_and_tail_branch():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.999999, -0.9999, 0.5],
                     dtype=torch.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    got = prng.erfinv(x).numpy()
    assert got[0] == -np.inf and got[1] == np.inf and got[2] == 0.0
    np.testing.assert_allclose(got, want, rtol=prng.NORMAL_RTOL)


def test_int_and_tensor_threefry_agree():
    key = prng.fold_in(prng.PRNGKey(5), 9)
    x1 = torch.tensor([0, 3, 2**32 - 1], dtype=torch.int64)
    x2 = torch.tensor([7, 0, 12345], dtype=torch.int64)
    y1, y2 = prng.threefry2x32(key, x1, x2)
    for i in range(3):
        assert prng.threefry2x32_int(key, int(x1[i]), int(x2[i])) == (
            int(y1[i]), int(y2[i]))


@pytest.mark.parametrize('draw', [prng.random_bits, prng.uniform, prng.normal])
def test_draws_name_their_device(draw):
    """A draw runs where its caller says, never on a default device: a
    weight-sized draw on the host would be a silent copy per evaluation."""
    with pytest.raises(TypeError):
        draw(prng.PRNGKey(0), (3,))
    assert draw(prng.PRNGKey(0), (3,), device='cpu').device.type == 'cpu'
