"""The port's DDPM path against the reference, in one process, at
``tests/test_diffusion.py``'s TINY size (with an 8-wide context, so
cross-attention runs too): ``randint``, ``cosine_schedule``,
``q_sample``, ``ddpm_loss`` and its UNet gradient through the
bridge-loaded parameters, ``ddpm_step`` and ``ddpm_sample``,
``generate(sampler='ddpm')`` and ``generate_deepcache``.  The reference
tests ``test_ddpm_training_reduces_loss``, ``test_ddpm_step_variance``
and ``test_generate_deepcache_interval1_matches_generate`` are mirrored
on the port.  ``image_batch`` and the VAE encoder are in
``test_torch_image_vae.py``, the GroupNorm+swish gradient in
``test_torch_core_helpers.py``.

Tolerances:
- ``randint`` and the ``t`` that ``ddpm_loss`` draws: exact (integer
  arithmetic).
- ``linear``/``cosine_schedule`` 1e-6: XLA's float32 ``cos`` and
  ``cumprod`` against torch's, a few ulps of values <= 1.
- ``q_sample`` 1e-6: two float32 products of values of order 1.
- ``ddpm_loss`` and each gradient ``FP32_ATOL`` = 1e-4 (the fp32
  tolerance of ``test_torch_unet.py``): float32 convolutions summed in
  another order (~1e-6 a layer) over a whole network and its backward,
  and the loss's noise within ``prng.NORMAL_RTOL``.
- ``ddpm_step``, ``ddpm_sample`` and ``generate`` at T = 16, fp32 and
  DeepCache: 1e-4 as above, carried over the steps; ``w8a8`` 1e-3 (a
  ~1e-7 difference can move one int8 rounding at a tie, one LSB).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.diffusion import samplers as jsamp
from repro.diffusion import schedule as jsched
from repro.diffusion.pipeline import DiffusionPipeline as JPipe
from repro.models import unet as ju
from repro_torch.bridge import load_jax_params
from repro_torch.core import prng
from repro_torch.diffusion import samplers as tsamp
from repro_torch.diffusion import schedule as tsched
from repro_torch.diffusion.pipeline import DiffusionPipeline as TPipe
from repro_torch.launch.steps import train_params
from repro_torch.models import unet as tu

JCFG = ju.UNetConfig('tiny', img_size=16, in_ch=3, base_ch=32,
                     ch_mults=(1, 2), n_res_blocks=1, attn_resolutions=(8,),
                     n_heads=4, timesteps=16, context_dim=8)
TCFG = tu.UNetConfig(**vars(JCFG))
FP32_ATOL = 1e-4
W8A8_ATOL = 1e-3
SCHED_ATOL = 1e-6


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _partitionable():
    with jax.threefry_partitionable(True):
        yield


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope='module')
def jpipe():
    params = jax.jit(lambda k: ju.init_unet(k, JCFG))(jax.random.PRNGKey(0))
    return JPipe(JCFG, params, jsched.linear_schedule(JCFG.timesteps))


@pytest.fixture(scope='module')
def tpipe(jpipe):
    pipe = TPipe.init(0, TCFG, device='cpu')
    load_jax_params(pipe.unet, _numpy_tree(jpipe.unet_params))
    return pipe


def _japply(params, x, t, ctx):
    return ju.unet_apply(params, JCFG, x, t, ctx)


def _tapply(unet, x, t, ctx):
    return unet(x, t, ctx)


# --- prng.randint --------------------------------------------------------

@pytest.mark.parametrize('seed', [0, 7, 2 ** 31 - 1])
@pytest.mark.parametrize('shape,lo,hi', [
    ((33,), 0, 1), ((8, 5), 0, 16), ((64,), 0, 1000), ((17,), -5, 3),
    ((9,), 10, 10), ((9,), 10, 3), ((100,), 0, 1 << 20),
    ((40,), -2 ** 31, 2 ** 31 - 1)])
def test_randint_is_bit_exact(seed, shape, lo, hi):
    """Span 1, a power of two, 1000, a negative minval, ``maxval <=
    minval`` and the whole int32 range (where the multiplier's square
    wraps at 2**32)."""
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape,
                                         lo, hi))
    got = prng.randint(prng.PRNGKey(seed), shape, lo, hi, device='cpu')
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_randint_refuses_bounds_outside_int32():
    with pytest.raises(ValueError, match='int32'):
        prng.randint(prng.PRNGKey(0), (4,), 0, 2 ** 31, device='cpu')


# --- schedules and the forward process ------------------------------------

@pytest.mark.parametrize('T', [16, 100, 1000])
def test_schedules_match_reference(T):
    for jf, tf in ((jsched.linear_schedule, tsched.linear_schedule),
                   (jsched.cosine_schedule, tsched.cosine_schedule)):
        js, ts = jf(T), tf(T)
        assert ts.T == T
        for name in ('betas', 'alphas', 'alpha_bars'):
            np.testing.assert_allclose(getattr(ts, name).numpy(),
                                       np.asarray(getattr(js, name)),
                                       atol=SCHED_ATOL, err_msg=name)
    c = tsched.cosine_schedule(T).betas
    assert bool((c >= 0).all()) and bool((c <= 0.999).all())


def test_q_sample_matches_reference_and_decays_to_noise():
    """Eq. 1 on the same inputs; at t = T-1 of the linear schedule the
    sample is essentially the noise (the reference's SNR test)."""
    js, ts = jsched.linear_schedule(1000), tsched.linear_schedule(1000)
    x0, noise = _np((3, 4, 4, 2), 1), _np((3, 4, 4, 2), 2)
    t = np.array([0, 500, 999], np.int32)
    want = jsched.q_sample(js, jnp.asarray(x0), jnp.asarray(t),
                           jnp.asarray(noise))
    got = tsched.q_sample(ts, torch.from_numpy(x0), torch.from_numpy(t),
                          torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SCHED_ATOL)
    late = tsched.q_sample(ts, torch.ones(2, 4, 4, 1),
                           torch.tensor([999, 999]),
                           torch.from_numpy(_np((2, 4, 4, 1), 3)))
    corr = np.corrcoef(late.numpy().ravel(), _np((2, 4, 4, 1), 3).ravel())
    assert corr[0, 1] > 0.98


# --- ddpm_loss and its gradient ------------------------------------------

@pytest.mark.parametrize('with_context', [True, False])
def test_ddpm_loss_and_unet_gradient_match_reference(jpipe, with_context):
    """The same key draws the same t bit for bit (checked through the
    reference's own key chain) and the loss and every UNet parameter's
    gradient agree: the reference's gradient tree loaded through the
    bridge into a second UNet, then compared name by name."""
    x0 = _np((4, 16, 16, 3), 4) * 0.5
    ctx = _np((4, 5, 8), 5) if with_context else None
    key = 11
    kt, _ = jax.random.split(jax.random.PRNGKey(key))
    want_t = np.asarray(jax.random.randint(kt, (4,), 0, JCFG.timesteps))
    tkt, _ = prng.split(prng.PRNGKey(key))
    np.testing.assert_array_equal(
        prng.randint(tkt, (4,), 0, TCFG.timesteps, device='cpu').numpy(),
        want_t)

    js = jsched.linear_schedule(JCFG.timesteps)
    jctx = None if ctx is None else jnp.asarray(ctx)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jsched.ddpm_loss(_japply, js, p, jnp.asarray(x0),
                                   jax.random.PRNGKey(key), jctx)))(
        jpipe.unet_params)
    unet = load_jax_params(tu.UNet(TCFG), _numpy_tree(jpipe.unet_params))
    params = train_params(unet)
    loss = tsched.ddpm_loss(_tapply, tsched.linear_schedule(TCFG.timesteps),
                            unet, torch.from_numpy(x0), prng.PRNGKey(key),
                            None if ctx is None else torch.from_numpy(ctx))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=FP32_ATOL)
    want = load_jax_params(tu.UNet(TCFG), _numpy_tree(jgrad)).state_dict()
    assert set(want) == set(params)
    for name, p in params.items():
        # without a context the cross-attention weights get no gradient
        # (the reference's: zeros)
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=FP32_ATOL, err_msg=name)
        if name.endswith(('gn1.scale', 'gn2.scale', 'gn_out.bias')):
            assert g.abs().max() > 0, name


def test_ddpm_training_reduces_loss():
    """The reference's test on the port: 25 plain gradient steps at lr
    3e-3 lower ``ddpm_loss`` at a fixed evaluation key."""
    pipe = TPipe.init(0, tu.UNetConfig(**{**vars(TCFG),
                                          'context_dim': None}),
                      device='cpu')
    unet, sched = pipe.unet, pipe.sched
    params = list(train_params(unet).values())
    x0 = torch.from_numpy(_np((4, 16, 16, 3), 1) * 0.5)

    def loss(key):
        return tsched.ddpm_loss(_tapply, sched, unet, x0, key)
    eval_key = prng.PRNGKey(123)
    with torch.no_grad():
        before = loss(eval_key).item()
    key = prng.PRNGKey(2)
    for _ in range(25):
        key, k = prng.split(key)
        grads = torch.autograd.grad(loss(k), params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(3e-3 * g)
    with torch.no_grad():
        after = loss(eval_key).item()
    assert after < before, (before, after)


# --- DDPM sampling ---------------------------------------------------------

def test_ddpm_step_matches_reference_and_adds_no_noise_at_t0(jpipe, tpipe):
    js, ts = jpipe.sched, tpipe.sched
    x = _np((2, 16, 16, 3), 6)
    ctx = _np((2, 5, 8), 7)
    jeps = jpipe._eps_fn(jnp.asarray(ctx))
    teps = tpipe._eps_fn(torch.from_numpy(ctx))
    for t in (9, 0):
        want = jax.jit(lambda xx, k: jsamp.ddpm_step(js, jeps, xx, t, k))(
            jnp.asarray(x), jax.random.PRNGKey(3))
        with torch.no_grad():
            got = tsamp.ddpm_step(ts, teps, torch.from_numpy(x), t,
                                  prng.PRNGKey(3))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=FP32_ATOL)
    # the reference's test_ddpm_step_variance on the port
    zero = lambda xx, tt: torch.zeros_like(xx)      # noqa: E731
    xs = torch.from_numpy(_np((2, 8, 8, 1), 0))
    a = tsamp.ddpm_step(tsched.linear_schedule(16), zero, xs, 0,
                        prng.PRNGKey(1))
    b = tsamp.ddpm_step(tsched.linear_schedule(16), zero, xs, 0,
                        prng.PRNGKey(2))
    c = tsamp.ddpm_step(tsched.linear_schedule(16), zero, xs, 1,
                        prng.PRNGKey(1))
    d = tsamp.ddpm_step(tsched.linear_schedule(16), zero, xs, 1,
                        prng.PRNGKey(2))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    assert not torch.allclose(c, d)


def test_ddpm_sample_matches_reference(jpipe, tpipe):
    """T = 16 ancestral steps from the same key, through the samplers."""
    jeps = jpipe._eps_fn()
    want = jax.jit(lambda k: jsamp.ddpm_sample(jpipe.sched, jeps,
                                               (2, 16, 16, 3), k))(
        jax.random.PRNGKey(4))
    with torch.no_grad():
        got = tsamp.ddpm_sample(tpipe.sched, tpipe._eps_fn(), (2, 16, 16, 3),
                                prng.PRNGKey(4), device='cpu')
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL)


@pytest.mark.parametrize('policy,guidance,atol', [('fp32', 2.5, FP32_ATOL),
                                                  ('w8a8', 0.0, W8A8_ATOL)])
def test_generate_ddpm_matches_reference(jpipe, tpipe, policy, guidance,
                                         atol):
    """``generate(seed, sampler='ddpm')`` against the reference's
    ``generate(PRNGKey(seed), sampler='ddpm')``, fp32 guided and w8a8."""
    from repro.core.precision import PrecisionPolicy as JP
    ctx = _np((2, 5, 8), 8)
    want = jax.jit(lambda c: jpipe.generate(
        jax.random.PRNGKey(5), batch=2, sampler='ddpm', context=c,
        guidance=guidance, policy=JP.from_name(policy)))(jnp.asarray(ctx))
    got = tpipe.generate(5, batch=2, sampler='ddpm',
                         context=torch.from_numpy(ctx), guidance=guidance,
                         policy=policy)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


@pytest.mark.parametrize('interval', [1, 2])
def test_generate_deepcache_matches_reference(jpipe, tpipe, interval):
    ctx = _np((2, 5, 8), 9)
    want = jpipe.generate_deepcache(jax.random.PRNGKey(6), batch=2, steps=4,
                                    interval=interval,
                                    context=jnp.asarray(ctx))
    got = tpipe.generate_deepcache(6, batch=2, steps=4, interval=interval,
                                   context=torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL)


def test_generate_deepcache_interval1_matches_generate(tpipe):
    """The reference's test on the port: at interval 1 every step is a
    refresh, which is the full UNet pass, so the trajectory is
    ``generate``'s (here bit for bit); at interval 2 it stays near."""
    a = tpipe.generate(5, batch=2, steps=4)
    b = tpipe.generate_deepcache(5, batch=2, steps=4, interval=1)
    np.testing.assert_array_equal(b.numpy(), a.numpy())
    c = tpipe.generate_deepcache(5, batch=2, steps=4, interval=2)
    assert float((c - a).norm() / a.norm()) < 0.5
