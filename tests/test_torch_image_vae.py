"""The port's ``image_batch`` and VAE against the reference, in one
process: the synthetic image fields (their numpy low-resolution draw bit
for bit, then ``jax.image.resize``'s bicubic rule, whose per-axis weight
matrices are also checked alone), the whole-VAE strict load, and
``vae_encode`` (mean and with a key) and ``vae_decode`` of the loaded
``VAE``.

Tolerances: the low-resolution field exact (the reference's numpy draw);
the bicubic weights 1e-7 (float32 arithmetic in the same order);
``image_batch`` 2e-6 (the two contractions summed in another order,
measured 7.7e-7 at 17 px); ``vae_encode`` 1e-5 (float32 convolutions in
another order, measured 5.9e-7; the draw within ``prng.NORMAL_RTOL``);
``vae_decode`` 1e-4, ``test_torch_unet.py``'s fp32 tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jdata
from repro.models import autoencoder as jae
from repro_torch.bridge import load_jax_params
from repro_torch.core import prng
from repro_torch.data import pipeline as tdata
from repro_torch.models import autoencoder as tae

IMAGE_ATOL = 2e-6
WEIGHT_ATOL = 1e-7
VAE_ATOL = 1e-5
DECODE_ATOL = 1e-4


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


# --- image_batch ----------------------------------------------------------

@pytest.mark.parametrize('size,ch,batch,shard', [
    (16, 3, 4, (0, 1)), (32, 3, 4, (1, 2)), (17, 1, 3, (0, 1)),
    (64, 4, 2, (0, 1)), (3, 2, 2, (0, 1))])
def test_image_batch_matches_reference(size, ch, batch, shard):
    """Upsampling at even and odd sizes, a shard, and a 3-px target
    (downsampling, where the antialiased kernel stretches)."""
    jc = jdata.ImagePipelineConfig(size, ch, batch, seed=3)
    tc = tdata.ImagePipelineConfig(size, ch, batch, seed=3)
    want = np.asarray(jdata.image_batch(jc, 5, shard))
    low = tdata.image_low(tc, 5, shard)
    # the reference's image is the bicubic resize of exactly this field
    np.testing.assert_array_equal(
        np.asarray(jnp.tanh(jax.image.resize(jnp.asarray(low), want.shape,
                                             'bicubic'))), want)
    got = tdata.image_batch(tc, 5, shard)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=IMAGE_ATOL)


@pytest.mark.parametrize('n_in,n_out', [(4, 16), (4, 512), (4, 3), (7, 5)])
def test_resize_weights_are_jax_bicubic(n_in, n_out):
    from jax._src.image import scale as jscale
    want = jscale.compute_weight_mat(n_in, n_out, jnp.float32(n_out / n_in),
                                     jnp.float32(0.0),
                                     jscale._fill_keys_cubic_kernel, True)
    np.testing.assert_allclose(tdata.resize_weights(n_in, n_out).numpy(),
                               np.asarray(want), atol=WEIGHT_ATOL)


# --- the VAE ---------------------------------------------------------------

VAE_JCFG = jae.VAEConfig(img_size=16, in_ch=3, z_ch=4, base_ch=16,
                         ch_mults=(1, 2), groups=8)


@pytest.fixture(scope='module')
def vae_pair():
    jp = jax.jit(lambda k: jae.init_vae(k, VAE_JCFG))(jax.random.PRNGKey(1))
    vae = load_jax_params(tae.VAE(tae.VAEConfig(**vars(VAE_JCFG))),
                          _numpy_tree(jp))
    return jp, vae


def test_whole_vae_loads_strictly(vae_pair):
    """``VAE``'s state-dict keys are the whole reference tree's: the load
    is strict with no filtering, and a missing leaf raises."""
    jp, vae = vae_pair
    assert any(k.startswith('enc.') for k in vae.state_dict())
    assert any(k.startswith('dec.') for k in vae.state_dict())
    tree = _numpy_tree(jp)
    del tree['enc_out']
    with pytest.raises(RuntimeError, match='enc_out'):
        load_jax_params(tae.VAE(tae.VAEConfig(**vars(VAE_JCFG))), tree)


@pytest.mark.parametrize('key', [None, 5])
def test_vae_encode_matches_reference(vae_pair, key):
    jp, vae = vae_pair
    x = _np((2, 16, 16, 3), 10)
    want = jae.vae_encode(jp, VAE_JCFG, jnp.asarray(x),
                          None if key is None else jax.random.PRNGKey(key))
    enc = load_jax_params(
        tae.VAEEncoder(vae.cfg),
        {k: v for k, v in _numpy_tree(jp).items() if k.startswith('enc')})
    with torch.no_grad():
        for m in (vae, enc):
            got = tae.vae_encode(m, torch.from_numpy(x),
                                 None if key is None else prng.PRNGKey(key))
            assert got.shape == (2, 8, 8, 4)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=VAE_ATOL)


def test_vae_decode_of_the_whole_vae_matches_reference(vae_pair):
    jp, vae = vae_pair
    z = _np((2, 8, 8, 4), 11)
    want = jae.vae_decode(jp, VAE_JCFG, jnp.asarray(z))
    with torch.no_grad():
        got = tae.vae_decode(vae, torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DECODE_ATOL)
