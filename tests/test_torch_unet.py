"""Port model vs the reference: the same reference parameters (loaded
through ``repro_torch.bridge``) and the same numpy inputs through
``unet_apply``, ``vae_decode`` and a DDIM trajectory of
``denoise_step`` in both packages.

Tolerances: fp32 1e-4, for float32 convolutions and matmuls summed in
another order over a whole network (each layer agrees to ~1e-6); w8a8
1e-3, because a ~1e-7 difference in an activation can move one int8
rounding at a tie, worth about one LSB of the 8-bit datapath."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.precision import PrecisionPolicy as JP
from repro.diffusion.pipeline import DiffusionPipeline as JPipe
from repro.diffusion.schedule import linear_schedule
from repro.models import autoencoder as jae
from repro.models import unet as ju
from repro_torch.bridge import load_jax_params
from repro_torch.configs import diffusion as tconfigs
from repro_torch.diffusion.pipeline import DiffusionPipeline as TPipe
from repro_torch.models import autoencoder as tae
from repro_torch.models import unet as tu

JCFG = ju.UNetConfig('tiny-sdm', img_size=16, in_ch=3, base_ch=32,
                     ch_mults=(1, 2), n_res_blocks=1, attn_resolutions=(8,),
                     n_heads=4, timesteps=16, context_dim=8)
TCFG = tu.UNetConfig(**vars(JCFG))


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope='module')
def jpipe():
    # jitted initialiser: the same values as JPipe.init, compiled once
    params = jax.jit(lambda k: ju.init_unet(k, JCFG))(jax.random.PRNGKey(0))
    return JPipe(JCFG, params, linear_schedule(JCFG.timesteps))


def _japply(params, x, t, ctx, policy):
    fn = jax.jit(lambda p, xx, tt, cc: ju.unet_apply(p, JCFG, xx, tt, cc,
                                                     policy=policy))
    return np.asarray(fn(params, jnp.asarray(x), jnp.asarray(t),
                         None if ctx is None else jnp.asarray(ctx)))


@pytest.fixture(scope='module')
def tpipe(jpipe):
    pipe = TPipe.init(0, TCFG, device='cpu')
    load_jax_params(pipe.unet, _numpy_tree(jpipe.unet_params))
    return pipe


@pytest.mark.parametrize('policy,atol', [('fp32', 1e-4), ('w8a8', 1e-3)])
@pytest.mark.parametrize('with_context', [True, False])
def test_unet_apply_matches_reference(jpipe, tpipe, policy, atol,
                                      with_context):
    x = _np((2, 16, 16, 3), 1)
    t = np.array([3, 11], np.int32)
    ctx = _np((2, 5, 8), 2) if with_context else None
    want = _japply(jpipe.unet_params, x, t, ctx, JP.from_name(policy))
    with torch.no_grad():
        got = tu.unet_apply(tpipe.unet, torch.from_numpy(x),
                            torch.from_numpy(t),
                            None if ctx is None else torch.from_numpy(ctx),
                            policy=policy)
    np.testing.assert_allclose(got.numpy(), want, atol=atol)


def test_prequantized_params_load_and_match(jpipe):
    """QTensor leaves of the reference's prequantized tree load through
    the bridge into quantized Linear weights and serve the same w8a8."""
    jq = jpipe.prequantize()
    port = tu.UNet(TCFG)
    load_jax_params(port, _numpy_tree(jq.unet_params))
    assert 'mid.attn.xk.w.q' in port.state_dict()
    x, ctx = _np((1, 16, 16, 3), 3), _np((1, 5, 8), 4)
    t = np.array([7], np.int32)
    want = _japply(jq.unet_params, x, t, ctx, jq.policy)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t),
                   torch.from_numpy(ctx), 'w8a8')
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_port_prequantize_matches_dynamic_w8a8(tpipe):
    """Pre-quantized projection weights carry exactly the scales the
    dynamic path computes, so the two w8a8 calibrations agree."""
    pq = tpipe.prequantize()
    assert pq.policy.calibration == 'prequant'
    ctx = torch.from_numpy(_np((1, 5, 8), 5))
    a = pq.generate(3, steps=3, context=ctx)
    b = tpipe.generate(3, steps=3, context=ctx, policy='w8a8')
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_vae_decode_matches_reference():
    jcfg = jae.VAEConfig(img_size=16, in_ch=3, z_ch=4, base_ch=16,
                         ch_mults=(1, 2), groups=8)
    jp = jax.jit(lambda k: jae.init_vae(k, jcfg))(jax.random.PRNGKey(1))
    dec = {k: v for k, v in _numpy_tree(jp).items() if k.startswith('dec')}
    vae = load_jax_params(tae.VAEDecoder(tae.VAEConfig(**vars(jcfg))), dec)
    z = _np((2, 8, 8, 4), 6)
    want = jax.jit(lambda p, zz: jae.vae_decode(p, jcfg, zz))(
        jp, jnp.asarray(z))
    with torch.no_grad():
        got = tae.vae_decode(vae, torch.from_numpy(z))
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_sd_v1_4_parameter_count_matches_reference():
    """Full-width SD v1.4 built on the meta device (no memory) has the
    reference's parameter count, taken from an abstract evaluation of
    the reference initialiser."""
    from repro.configs.diffusion import SD_V1_4
    shapes = jax.eval_shape(lambda k: ju.init_unet(k, SD_V1_4),
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes))
    port = tu.UNet(tconfigs.SD_V1_4, device='meta')
    got = sum(p.numel() for p in port.parameters())
    assert got == want == 861_968_004


@pytest.mark.parametrize('guidance', [0.0, 2.5])
def test_ddim_trajectory_of_denoise_step(jpipe, tpipe, guidance):
    """Three DDIM steps from the same numpy x_T, guided and not."""
    x = _np((2, 16, 16, 3), 7)
    ctx = _np((2, 5, 8), 8)
    ts = [15, 10, 5, -1]
    jstep = jax.jit(lambda xx, tt, tp, cc: jpipe.denoise_step(
        xx, tt, tp, context=cc, guidance=guidance))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for t, t_prev in zip(ts, ts[1:]):
        tt = np.array([t, t], np.int32)
        tp = np.array([t_prev, t_prev], np.int32)
        jx = jstep(jx, jnp.asarray(tt), jnp.asarray(tp), jnp.asarray(ctx))
        tx = tpipe.denoise_step(tx, torch.from_numpy(tt), torch.from_numpy(tp),
                                context=torch.from_numpy(ctx),
                                guidance=guidance)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4)


def test_state_dict_keys_are_reference_key_paths(jpipe):
    paths = {'.'.join(str(getattr(k, 'key', getattr(k, 'idx', k)))
                      for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(
                 jpipe.unet_params)[0]}
    assert set(tu.UNet(TCFG, device='meta').state_dict()) == paths
