"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports neither ``jax`` nor the JAX package, so it runs on the GPU
machine: ``python -m pytest -m gpu tests/test_torch_kernels_gpu.py``.
Every test skips where there is no CUDA device."""
import pytest
import torch

from repro_torch.core import quantization as tq
from repro_torch.kernels import fused_gn_swish as tgn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import w8a8_matmul as tmm

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    return torch.device('cuda')


@pytest.mark.parametrize('N,H,W,C,g', [(4, 64, 64, 340, 20),
                                       (4, 8, 8, 2720, 32), (3, 5, 7, 96, 6)])
def test_gn_swish_kernel_on_card(cuda, N, H, W, C, g):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((N, H, W, C), device=cuda, generator=gen) * 3 + 1
    sc = torch.randn(C, device=cuda, generator=gen)
    bi = torch.randn(C, device=cuda, generator=gen)
    before = tops.launch_counts()['fused_gn_swish']
    out = tops.fused_gn_swish(x, sc, bi, groups=g)
    torch.cuda.synchronize()
    assert tops.launch_counts()['fused_gn_swish'] == before + 1
    ref = tgn.gn_swish_plain(x, sc, bi, g)
    assert (out - ref).abs().max().item() <= 1e-5


@pytest.mark.parametrize('M,K,N', [(4096, 680, 680), (308, 768, 1360),
                                   (257, 129, 65), (1, 300, 7)])
def test_w8a8_kernel_on_card_is_exact(cuda, M, K, N):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((M, K), device=cuda, generator=gen)
    w = torch.randn((K, N), device=cuda, generator=gen)
    out = tops.w8a8_matmul(x, w)
    torch.cuda.synchronize()
    xq, wq = tq.quantize(x, axis=(1,)), tq.quantize_per_channel(w)
    ref = tmm.w8a8_matmul_plain(xq.q, xq.scale, wq.q, wq.scale.reshape(1, N))
    assert torch.equal(out, ref)


def test_kernel_wrappers_check_their_inputs_on_card(cuda):
    x = torch.randn((2, 4, 4, 8), device=cuda)
    with pytest.raises(ValueError, match='contiguous'):
        tgn.fused_gn_swish_kernel(x.transpose(1, 2),
                                  torch.ones(8, device=cuda),
                                  torch.zeros(8, device=cuda), 4)
    with pytest.raises(ValueError, match='float32'):
        tgn.fused_gn_swish_kernel(x.double(), torch.ones(8, device=cuda),
                                  torch.zeros(8, device=cuda), 4)
    q = torch.zeros((3, 8), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match='bad operand shapes'):
        tmm.w8a8_matmul_kernel(q, torch.ones(3, 1, device=cuda), q,
                               torch.ones(1, 8, device=cuda))
