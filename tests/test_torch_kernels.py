"""Port kernels vs the reference: the plain PyTorch version behind each
wrapper (what a CPU tensor runs) against the JAX wrapper with its Pallas
kernel in interpret mode, on the same numpy inputs; the quantizer bit
for bit.  The CUDA kernels themselves are held against the plain
versions on the card by ``test_torch_kernels_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import quantization as tq
from repro_torch.kernels import fused_gn_swish as tgn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import w8a8_matmul as tmm


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale + shift).astype(np.float32)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shape,axis', [
    ((16, 40), (1,)),          # per row (activations)
    ((40, 24), (0,)),          # per output channel (weights)
    ((3, 5, 7), None),         # per tensor
])
def test_quantize_bit_identical(shape, axis):
    x = _np(shape, 0, scale=3.0)
    a = jq.quantize(jnp.asarray(x), axis=axis)
    b = tq.quantize(torch.from_numpy(x), axis=axis)
    np.testing.assert_array_equal(np.asarray(a.q), b.q.numpy())
    np.testing.assert_array_equal(np.asarray(a.scale), b.scale.numpy())


def test_quantize_rounds_half_to_even_and_clamps_scale():
    # scale = 127/127 = 1 exactly, so every x/scale below is a tie
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]], np.float32)
    b = tq.quantize(torch.from_numpy(x), axis=(1,))
    np.testing.assert_array_equal(b.q.numpy(), [[127, 0, 2, 2, 0, -2]])
    zero = tq.quantize(torch.zeros(2, 3), axis=(1,))
    np.testing.assert_array_equal(
        zero.scale.numpy(),
        np.full((2, 1), np.float32(1e-8) / np.float32(127)))
    assert int(zero.q.abs().max()) == 0


# ---------------------------------------------------------------------------
# W8A8 matmul: exact (integer accumulation, same epilogue order)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('M,K,N', [
    (8, 64, 32), (64, 200, 96), (1, 300, 7), (257, 129, 65), (77, 48, 40),
])
def test_w8a8_plain_matches_reference_exactly(M, K, N):
    x, w = _np((M, K), 1), _np((K, N), 2)
    want = np.asarray(jops.w8a8_matmul(jnp.asarray(x), jnp.asarray(w),
                                       mode='interpret'))
    got = tops.w8a8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)


def test_w8a8_prequantized_weight_and_leading_dims():
    x, w = _np((2, 3, 96), 3), _np((96, 48), 4)
    jw = jq.quantize_per_channel(jnp.asarray(w))
    want = np.asarray(jops.w8a8_matmul(jnp.asarray(x), jw, mode='interpret'))
    tw = tq.QTensor(torch.from_numpy(np.array(jw.q)),
                    torch.from_numpy(np.array(jw.scale)))
    got = tops.w8a8_matmul(torch.from_numpy(x), tw)
    assert got.shape == (2, 3, 48)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)


def test_w8a8_plain_matches_reference_oracle_on_int_operands():
    rng = np.random.default_rng(5)
    xq = rng.integers(-127, 128, size=(33, 70), dtype=np.int8)
    wq = rng.integers(-127, 128, size=(70, 21), dtype=np.int8)
    xs = rng.uniform(0.01, 0.1, size=(33, 1)).astype(np.float32)
    ws = rng.uniform(0.01, 0.1, size=(1, 21)).astype(np.float32)
    want = np.asarray(jref.w8a8_matmul_ref(jnp.asarray(xq), jnp.asarray(xs),
                                           jnp.asarray(wq), jnp.asarray(ws)))
    got = tmm.w8a8_matmul_plain(*(torch.from_numpy(a)
                                  for a in (xq, xs, wq, ws)))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# fused GroupNorm + swish; atol 1e-5 as the reference's own kernel test
# (float32 statistics summed in different orders)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('N,H,W,C,groups', [
    (2, 8, 8, 64, 8),
    (1, 16, 16, 32, 32),
    (3, 4, 4, 96, 6),
    (2, 8, 8, 340, 32),     # fallback to g = 20: cg = 17, not a power of 2
    (1, 4, 4, 1020, 32),    # fallback to g = 30: cg = 34
    (2, 4, 4, 100, 32),     # fallback to g = 25
])
def test_gn_swish_plain_matches_reference(N, H, W, C, groups):
    x = _np((N, H, W, C), 6, scale=2.0, shift=0.5)
    sc, bi = _np((C,), 7), _np((C,), 8)
    want = np.asarray(jops.fused_gn_swish(
        jnp.asarray(x), jnp.asarray(sc), jnp.asarray(bi), groups=groups,
        mode='interpret'))
    got = tops.fused_gn_swish(torch.from_numpy(x), torch.from_numpy(sc),
                              torch.from_numpy(bi), groups=groups)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty((1, 2, 2, 4), device='meta')
    with pytest.raises(ValueError, match='no kernel'):
        tops.fused_gn_swish(x, torch.empty(4, device='meta'),
                            torch.empty(4, device='meta'), groups=2)
    with pytest.raises(ValueError, match='needs a CUDA tensor'):
        tgn.fused_gn_swish_kernel(torch.zeros(1, 2, 2, 4), torch.ones(4),
                                  torch.zeros(4), 2)
    with pytest.raises(ValueError, match='needs CUDA tensors'):
        tmm.w8a8_matmul_kernel(torch.zeros(2, 3, dtype=torch.int8),
                               torch.ones(2, 1),
                               torch.zeros(3, 4, dtype=torch.int8),
                               torch.ones(1, 4))


def test_cpu_tensors_take_the_plain_path_and_count_no_launch():
    tops.reset_launches()
    tops.fused_gn_swish(torch.randn(1, 4, 4, 8), torch.ones(8),
                        torch.zeros(8), groups=4)
    tops.w8a8_matmul(torch.randn(3, 8), torch.randn(8, 5))
    q = torch.randn(1, 2, 5, 16)
    tops.flash_attention(q, q, q, causal=True)
    assert tops.launch_counts() == {'fused_gn_swish': 0, 'w8a8_matmul': 0,
                                    'flash_attention': 0}
