"""Port layers vs the reference on the same numpy inputs: GroupNorm,
convolutions (SAME padding, stride 2), the transposed-conv dataflows,
``linear`` at fp32, w8a8 and w8a8+noise, the LSE softmax, the timestep embedding, the
schedule and the DDIM step.

Tolerances: 1e-5 where both sides compute the same float32 arithmetic in
a different summation order (convolutions, matmuls, reductions); exact
where the arithmetic is integer (w8a8 products) or elementwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lse_softmax as jlse
from repro.core import sparse_dataflow as jsd
from repro.diffusion import samplers as jsamp
from repro.diffusion import schedule as jsched
from repro.models import layers as JL
from repro.models import unet as ju
from repro_torch.core import lse_softmax as tlse
from repro_torch.core import sparse_dataflow as tsd
from repro_torch.diffusion import samplers as tsamp
from repro_torch.diffusion import schedule as tsched
from repro_torch.models import layers as TL
from repro_torch.models import unet as tu


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _oihw(w_hwio):
    return _t(np.ascontiguousarray(np.transpose(w_hwio, (3, 2, 0, 1))))


@pytest.mark.parametrize('C,groups', [(96, 32), (100, 32), (64, 8)])
def test_groupnorm_population_variance_and_fallback(C, groups):
    x = _np((2, 5, 6, C), 0, scale=3.0) + 1.0
    sc, bi = _np((C,), 1), _np((C,), 2)
    want = JL.groupnorm({'scale': jnp.asarray(sc), 'bias': jnp.asarray(bi)},
                        jnp.asarray(x), groups)
    got = TL.groupnorm(_t(x), _t(sc), _t(bi), groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize('k,stride,H', [(3, 1, 8), (3, 2, 8), (1, 1, 5),
                                        (3, 2, 7)])
def test_conv2d_same_padding(k, stride, H):
    x = _np((2, H, H, 6), 3)
    w, b = _np((k, k, 6, 5), 4), _np((5,), 5)
    want = JL.conv2d({'w': jnp.asarray(w), 'b': jnp.asarray(b)},
                     jnp.asarray(x), stride=stride)
    got = TL.conv2d(_t(x), _oihw(w), _t(b), stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize('k,stride', [(4, 2), (3, 2), (2, 2), (3, 1)])
def test_conv_transpose_dataflows_match_reference(k, stride):
    x = _np((2, 5, 4, 6), 6)
    w = _np((k, k, 6, 7), 7)
    want = np.asarray(jsd.conv_transpose_dense(jnp.asarray(x),
                                               jnp.asarray(w), stride))
    sparse = tsd.conv_transpose_sparse(_t(x), _oihw(w), stride)
    dense = tsd.conv_transpose_dense(_t(x), _oihw(w), stride)
    assert sparse.shape == want.shape == (2, 5 * stride, 4 * stride, 7)
    np.testing.assert_allclose(sparse.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(dense.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(
        sparse.numpy(), np.asarray(jsd.conv_transpose_sparse(
            jnp.asarray(x), jnp.asarray(w), stride)), atol=1e-5)


@pytest.mark.parametrize('policy', ['fp32', 'w8a8'])
def test_linear_per_policy(policy):
    from repro.core.precision import PrecisionPolicy as JP
    x = _np((2, 7, 24), 8)
    w, b = _np((24, 16), 9), _np((16,), 10)
    want = np.asarray(JL.linear({'w': jnp.asarray(w), 'b': jnp.asarray(b)},
                                jnp.asarray(x), policy=JP.from_name(policy)))
    got = TL.linear(_t(x), _t(w), _t(b), policy=policy).numpy()
    if policy == 'w8a8':
        np.testing.assert_array_equal(got, want)     # integer product
    else:
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_linear_refuses_noisy_policy():
    """A noise model needs the w8a8 backend: an fp32 policy carrying one is
    refused.  On the w8a8 backend the noisy policy is served; without a
    key it draws from the policy's seed anchor, as the reference's
    ``linear`` does (the same noise; a float32 product summed in another
    order, so 1e-5 of the largest output)."""
    import jax
    from repro.core.precision import PrecisionPolicy as JP
    from repro_torch.core import prng
    from repro_torch.core.photonic.noise import NoiseModel, noisy_w8a8_matmul
    from repro_torch.core.precision import PrecisionPolicy as TP
    with pytest.raises(ValueError, match='requires the w8a8 backend'):
        TP(noise=NoiseModel())
    x, w, b = _np((2, 7, 24), 12), _np((24, 16), 13), _np((16,), 14)
    got = TL.linear(_t(x), _t(w), _t(b), policy='w8a8+noise')
    want = noisy_w8a8_matmul(prng.PRNGKey(0), _t(x), _t(w)) + _t(b)
    assert torch.equal(got, want)
    with jax.threefry_partitionable(True):
        ref = np.asarray(JL.linear({'w': jnp.asarray(w), 'b': jnp.asarray(b)},
                                   jnp.asarray(x), policy=JP.w8a8_noise()))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max())
    assert not torch.allclose(got, TL.linear(_t(x), _t(w), _t(b), 'w8a8'))


def test_lse_softmax_and_timestep_embedding():
    s = _np((3, 4, 9), 11, scale=5.0)
    np.testing.assert_allclose(tlse.lse_softmax(_t(s)).numpy(),
                               np.asarray(jlse.lse_softmax(jnp.asarray(s))),
                               atol=1e-6)
    t = np.array([0, 1, 499, 999], np.int32)
    np.testing.assert_allclose(
        tu.timestep_embedding(_t(t), 32).numpy(),
        np.asarray(ju.timestep_embedding(jnp.asarray(t), 32)), atol=1e-5)


def test_linear_schedule_and_ddim_step():
    js, ts = jsched.linear_schedule(32), tsched.linear_schedule(32)
    np.testing.assert_allclose(ts.alpha_bars.numpy(),
                               np.asarray(js.alpha_bars), rtol=1e-6)
    x, eps = _np((3, 4, 4, 2), 12), _np((3, 4, 4, 2), 13)
    t = np.array([30, 17, 2], np.int32)
    t_prev = np.array([17, 2, -1], np.int32)
    want, want_x0 = jsamp.ddim_step(js, jnp.asarray(eps), jnp.asarray(x),
                                    jnp.asarray(t), jnp.asarray(t_prev),
                                    return_x0=True)
    got, got_x0 = tsamp.ddim_step(ts, _t(eps), _t(x), _t(t), _t(t_prev),
                                  return_x0=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got_x0.numpy(), np.asarray(want_x0), atol=1e-5)
    np.testing.assert_array_equal(tsamp.ddim_timesteps(ts, 5),
                                  jsamp.ddim_timesteps(js, 5))
