"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports neither ``jax`` nor the JAX package, so it runs on the GPU
machine: ``python -m pytest -m gpu tests/test_torch_kernels_gpu.py``.
Every test skips where there is no CUDA device."""
import pytest
import torch

from repro_torch.core import quantization as tq
from repro_torch.core import sparse_dataflow as tsd
from repro_torch.kernels import conv2d as tcv
from repro_torch.kernels import flash_attention as tfa
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
                                       (4, 64, 64, 1020, 30),
                                       (4, 16, 16, 1360, 20),
                                       (4, 8, 8, 2720, 32), (3, 5, 7, 96, 6),
                                       (1, 128, 128, 256, 8)])
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
                                   (4000, 2048, 8192), (4, 8192, 2048),
                                   (4, 2048, 2048), (12, 2048, 2048),
                                   (20, 768, 680), (40, 680, 1360),
                                   (257, 129, 65), (1, 300, 7)])
def test_w8a8_kernel_on_card_is_exact(cuda, M, K, N):
    """Bit-exact at the large-M tiles, the small-M split-K path (M < 64)
    and ragged M, N, K."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((M, K), device=cuda, generator=gen)
    w = torch.randn((K, N), device=cuda, generator=gen)
    before = tops.launch_counts()['w8a8_matmul']
    out = tops.w8a8_matmul(x, w)
    torch.cuda.synchronize()
    assert tops.launch_counts()['w8a8_matmul'] == before + 1
    xq, wq = tq.quantize(x, axis=(1,)), tq.quantize_per_channel(w)
    ref = tmm.w8a8_matmul_plain(xq.q, xq.scale, wq.q, wq.scale.reshape(1, N))
    assert torch.equal(out, ref)


# every (K, N) of the Granite-MoE, DeepSeek-V2-Lite and Mamba2 w8a8
# forwards: N = 64 (w_kpe) and 80 (in_dt) below one 128-wide tile, K =
# 2816 (the shared experts' down projection) and 5120 (out_proj)
LM_FAMILY_KN = [(1024, 1024), (2048, 3072), (2048, 512), (2048, 64),
                (2048, 2048), (2048, 2816), (2816, 2048), (2560, 5120),
                (2560, 5376), (2560, 80), (5120, 2560)]


@pytest.mark.parametrize('M', [4000, 4])
@pytest.mark.parametrize('K,N', LM_FAMILY_KN)
def test_w8a8_kernel_at_lm_family_shapes(cuda, M, K, N):
    """Bit-exact at the prefill's M (4 x 1000) and a decode step's (4,
    the small-M split-K path)."""
    gen = torch.Generator(device=cuda).manual_seed(K + N)
    x = torch.randn((M, K), device=cuda, generator=gen)
    w = torch.randn((K, N), device=cuda, generator=gen)
    out = tops.w8a8_matmul(x, w)
    xq, wq = tq.quantize(x, axis=(1,)), tq.quantize_per_channel(w)
    ref = tmm.w8a8_matmul_plain(xq.q, xq.scale, wq.q, wq.scale.reshape(1, N))
    assert torch.equal(out, ref)


def test_w8a8_prequantized_qtensor_on_card(cuda):
    """A pre-quantized Linear weight reaches the kernel through its
    K-major copy, built once, and matches the dynamic path exactly."""
    from repro_torch.models.layers import Linear
    gen = torch.Generator(device=cuda).manual_seed(1)
    lin = Linear(680, 1360, device=cuda)
    lin.w.data = torch.randn((680, 1360), device=cuda, generator=gen)
    x = torch.randn((2, 77, 680), device=cuda, generator=gen)
    want = tops.w8a8_matmul(x, lin.w.data)
    lin.quantize_()
    qt = lin.weight
    assert qt.q.shape == (680, 1360) and qt.kmajor.shape == (1360, 688)
    assert lin.weight.kmajor is qt.kmajor          # built once
    before = tops.launch_counts()['w8a8_matmul']
    got = tops.w8a8_matmul(x, qt)
    torch.cuda.synchronize()
    assert tops.launch_counts()['w8a8_matmul'] == before + 1
    assert got.shape == (2, 77, 1360) and torch.equal(got, want)


def test_kernel_wrappers_check_their_inputs_on_card(cuda):
    x = torch.randn((2, 4, 4, 8), device=cuda)
    with pytest.raises(ValueError, match='contiguous'):
        tgn.fused_gn_swish_kernel(x.transpose(1, 2),
                                  torch.ones(8, device=cuda),
                                  torch.zeros(8, device=cuda), 4)
    with pytest.raises(ValueError, match='float32'):
        tgn.fused_gn_swish_kernel(x.double(), torch.ones(8, device=cuda),
                                  torch.zeros(8, device=cuda), 4)
    q = torch.zeros((3, 16), dtype=torch.int8, device=cuda)
    w = torch.zeros((8, 32), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match='bad operand shapes'):
        tmm.w8a8_matmul_kernel(q, torch.ones(3, 1, device=cuda), w,
                               torch.ones(1, 8, device=cuda))
    q = torch.zeros((3, 8), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match='not padded'):
        tmm.w8a8_matmul_kernel(q, torch.ones(3, 1, device=cuda), q,
                               torch.ones(1, 3, device=cuda))
    q = torch.zeros(3 * 16 + 1, dtype=torch.int8, device=cuda)[1:]
    with pytest.raises(ValueError, match='16-byte aligned'):
        tmm.w8a8_matmul_kernel(q.view(3, 16), torch.ones(3, 1, device=cuda),
                               w[:, :16].contiguous(),
                               torch.ones(1, 8, device=cuda))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16', 'mixed'])
@pytest.mark.parametrize('S,T,causal', [(1000, 1000, True), (100, 100, True),
                                        (128, 384, False), (77, 200, False),
                                        (200, 77, False), (1, 1, True)])
@pytest.mark.parametrize('d', [16, 32, 64, 128])
def test_flash_attention_kernel_on_card(cuda, d, S, T, causal, dtype):
    """Ragged S and T are masked in the kernel.  float32: within 2e-5 of
    the plain version (the reference kernel test's tolerance); bf16 out:
    within one bf16 ulp of each element (both round a float32 result)
    plus 1e-5 for the float32 difference underneath.  'mixed' is a float32
    q against a bf16 KV cache, as the prefill reads it."""
    gen = torch.Generator(device=cuda).manual_seed(d + S + T)
    q, k, v = (torch.randn(shape, device=cuda, generator=gen)
               for shape in ((6, S, d), (6, T, d), (6, T, d)))
    if dtype != 'float32':
        k, v = k.bfloat16(), v.bfloat16()
        if dtype == 'bfloat16':
            q = q.bfloat16()
    out = tfa.flash_attention_kernel(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = tfa.flash_attention_plain(q, k, v, causal=causal)
    assert out.dtype == q.dtype and out.shape == q.shape
    err = (out.float() - ref.float()).abs()
    if q.dtype == torch.float32:
        assert err.max().item() <= 2e-5
    else:
        assert bool((err <= 2.0 ** -7 * ref.float().abs() + 1e-5).all())


def test_flash_attention_wrapper_launches_once_per_call(cuda):
    q = torch.randn((2, 3, 50, 64), device=cuda)
    before = tops.launch_counts()['flash_attention']
    out = tops.flash_attention(q, q, q, causal=True)
    torch.cuda.synchronize()
    assert tops.launch_counts()['flash_attention'] == before + 1
    ref = tfa.flash_attention_plain(q.reshape(6, 50, 64), q.reshape(6, 50, 64),
                                    q.reshape(6, 50, 64), causal=True)
    assert (out.reshape(6, 50, 64) - ref).abs().max().item() <= 2e-5


def test_flash_attention_kernel_checks_its_inputs(cuda):
    x = torch.randn((2, 8, 48), device=cuda)
    with pytest.raises(ValueError, match='head dim'):
        tfa.flash_attention_kernel(x, x, x)
    x = torch.randn((2, 8, 64), device=cuda)
    with pytest.raises(ValueError, match='dtypes'):
        tfa.flash_attention_kernel(x.bfloat16(), x, x)
    with pytest.raises(ValueError, match='contiguous'):
        y = torch.randn((2, 64, 8), device=cuda).transpose(1, 2)
        tfa.flash_attention_kernel(x, y, y)
    with pytest.raises(ValueError, match='bad shapes'):
        tfa.flash_attention_kernel(x, x[:1], x[:1])


def _flash_check(out, ref, q_dtype):
    """float32 out: within 2e-5 of the plain version; bf16 out: one bf16
    ulp of each element plus 1e-5 (both round a float32 result)."""
    err = (out.float() - ref.float()).abs()
    if q_dtype == torch.float32:
        assert err.max().item() <= 2e-5
    else:
        assert bool((err <= 2.0 ** -7 * ref.float().abs() + 1e-5).all())


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16', 'mixed'])
@pytest.mark.parametrize('S,causal', [(100, True), (77, False), (1, True)])
@pytest.mark.parametrize('d', [16, 32, 64, 128])
def test_flash_attention_bshd_reads_a_grouped_cache_slice(cuda, d, S, causal,
                                                          dtype):
    """q (B, S, H, d) against k/v = cache[:, :S] of a (B, T_max, G, d)
    cache with H / G = 2, passed as the non-contiguous slices they are."""
    B, H, G, t_max = 2, 4, 2, 130
    gen = torch.Generator(device=cuda).manual_seed(d + S)
    q = torch.randn((B, S, H, d), device=cuda, generator=gen)
    ck, cv = (torch.randn((B, t_max, G, d), device=cuda, generator=gen)
              for _ in range(2))
    if dtype != 'float32':
        ck, cv = ck.bfloat16(), cv.bfloat16()
        if dtype == 'bfloat16':
            q = q.bfloat16()
    k, v = ck[:, :S], cv[:, :S]
    assert not k.is_contiguous()
    before = tops.launch_counts()['flash_attention']
    out = tops.flash_attention_bshd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tops.launch_counts()['flash_attention'] == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    assert out.is_contiguous()
    ref = tfa.flash_attention_bshd_plain(q, k, v, causal=causal)
    _flash_check(out, ref, q.dtype)


@pytest.mark.parametrize('causal', [True, False])
@pytest.mark.parametrize('d', [16, 128])
def test_flash_attention_kernel_keeps_the_low_mantissa_bits(cuda, d, causal):
    """Inputs whose 13 low mantissa bits (the ones TF32 drops) are all set:
    a split that loses them, or plain TF32, misses 2e-5 here."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (torch.randn((4, 256, d), device=cuda, generator=gen) * 2
               for _ in range(3))
    q, k, v = ((t.view(torch.int32) | 0x1fff).view(torch.float32)
               for t in (q, k, v))
    out = tfa.flash_attention_kernel(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = tfa.flash_attention_plain(q, k, v, causal=causal)
    assert (out - ref).abs().max().item() <= 2e-5


def test_flash_attention_bshd_kernel_checks_its_inputs(cuda):
    q = torch.randn((2, 8, 4, 64), device=cuda)
    k = torch.randn((2, 8, 3, 64), device=cuda)
    with pytest.raises(ValueError, match='H % G'):
        tfa.flash_attention_bshd_kernel(q, k, k)
    k = torch.randn((2, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError, match='bad shapes'):
        tfa.flash_attention_bshd_kernel(q, k[:1], k[:1])
    with pytest.raises(ValueError, match='head dim'):
        tfa.flash_attention_bshd_kernel(q[..., :48], k[..., :48], k[..., :48])
    with pytest.raises(ValueError, match='contiguous'):
        kt = torch.randn((2, 8, 64, 2), device=cuda).transpose(2, 3)
        tfa.flash_attention_bshd_kernel(q, kt, kt)
    with pytest.raises(ValueError, match='multiples of 8'):
        kp = torch.randn((2, 8, 2, 68), device=cuda)[..., :64]
        tfa.flash_attention_bshd_kernel(q, kp, kp)
    with pytest.raises(ValueError, match='dtypes'):
        tfa.flash_attention_bshd_kernel(q.bfloat16(), k, k)


def test_flash_attention_bshd_at_the_granite_prefill(cuda):
    """Granite-MoE's prefill layout: q (4, 1000, 16, 64) against the rows
    just written into a (4, 1001, 16, 64) float32 cache (8 KV heads
    times ``kv_repeat`` 2), within the float32 tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(64)
    q = torch.randn((4, 1000, 16, 64), device=cuda, generator=gen)
    ck, cv = (torch.randn((4, 1001, 16, 64), device=cuda, generator=gen)
              for _ in range(2))
    k, v = ck[:, :1000], cv[:, :1000]
    out = tops.flash_attention_bshd(q, k, v, causal=True)
    ref = tfa.flash_attention_bshd_plain(q, k, v, causal=True)
    _flash_check(out, ref, q.dtype)


@pytest.fixture
def last_card():
    """The last of two or more cards, or a skip."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip('needs two CUDA GPUs')
    return torch.device('cuda', torch.cuda.device_count() - 1)


def test_kernels_launch_on_the_tensors_card(last_card):
    """With cuda:0 current, each kernel called on tensors on the last card
    launches there (its shared-memory limit raised on that card, not only
    on the first) and matches its plain version on the same inputs."""
    dev = last_card
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.cuda.device(0):
        assert torch.cuda.current_device() == 0
        before = tops.launch_counts()
        x = torch.randn((4, 64, 64, 340), device=dev, generator=gen)
        sc = torch.randn(340, device=dev, generator=gen)
        bi = torch.randn(340, device=dev, generator=gen)
        gn = tops.fused_gn_swish(x, sc, bi, groups=20)
        a = torch.randn((4096, 680), device=dev, generator=gen)
        w = torch.randn((680, 680), device=dev, generator=gen)
        mm = tops.w8a8_matmul(a, w)
        small = tops.w8a8_matmul(a[:4], w)          # the split-K path
        q, k, v = (torch.randn((6, 1000, 128), device=dev, generator=gen)
                   for _ in range(3))
        fa = tfa.flash_attention_kernel(q, k, v, causal=True)
        cw = torch.randn((340, 340, 3, 3), device=dev, generator=gen) / 60
        cv = tops.conv2d(x, cw, (1, 1), (1, 1))
        torch.cuda.synchronize(dev)
        assert torch.cuda.current_device() == 0
    after = tops.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        'fused_gn_swish': 1, 'w8a8_matmul': 2, 'flash_attention': 1,
        'conv2d_nhwc': 1}
    assert all(t.device == dev for t in (gn, mm, small, fa, cv))
    ref = tcv.conv2d_plain(x.double(), cw.double(), (1, 1), (1, 1))
    assert (cv - ref).abs().max().item() <= CONV_RTOL * ref.abs().max().item()
    assert (gn - tgn.gn_swish_plain(x, sc, bi, 20)).abs().max().item() <= 1e-5
    aq, wq = tq.quantize(a, axis=(1,)), tq.quantize_per_channel(w)
    ref = tmm.w8a8_matmul_plain(aq.q, aq.scale, wq.q, wq.scale.reshape(1, 680))
    assert torch.equal(mm, ref) and torch.equal(small, ref[:4])
    ref = tfa.flash_attention_plain(q, k, v, causal=True)
    assert (fa - ref).abs().max().item() <= 2e-5


# The convolution kernel (3xTF32, each stage's products summed in float32)
# against the plain version in float64, relative to the largest output:
# float32's own rounding over K up to 2720 x 9 terms (F.conv2d in float32
# read up to 3.4e-6 on the card, the kernel 6.4e-7); one-pass TF32 reads
# ~2e-4.
CONV_RTOL = 1e-5


def _conv_case(cuda, N, H, W, cin, cout, k, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((N, H, W, cin), device=cuda, generator=gen)
    w = torch.randn((cout, cin, k, k), device=cuda, generator=gen) * (
        cin * k * k) ** -0.5
    return gen, x, w


def _close(got, want):
    want = want.double()
    return (got.double() - want).abs().max().item() <= \
        CONV_RTOL * want.abs().max().item()


# (N, H, W, cin, cout, k, stride, pad_h, pad_w): SD v1.4's channel counts
# and ends, stride 2 with XLA's SAME pads, a phase's asymmetric and
# negative pads, 1x1, ragged widths and tiles of 128 and 64 pixels
@pytest.mark.parametrize('N,H,W,cin,cout,k,stride,pad_h,pad_w', [
    (4, 64, 64, 340, 340, 3, 1, (1, 1), (1, 1)),
    (4, 64, 64, 4, 340, 3, 1, (1, 1), (1, 1)),
    (4, 64, 64, 340, 4, 3, 1, (1, 1), (1, 1)),
    (2, 16, 16, 2040, 1360, 1, 1, (0, 0), (0, 0)),
    (2, 8, 8, 2720, 1360, 3, 1, (1, 1), (1, 1)),
    (4, 33, 33, 680, 680, 3, 2, (0, 1), (0, 1)),
    (3, 17, 13, 40, 130, 3, 2, (1, 1), (0, 1)),
    (2, 9, 9, 680, 680, 2, 1, (0, -1), (-1, 0)),
    (1, 20, 200, 3, 3, 3, 1, (1, 1), (1, 1)),
    (1, 128, 128, 128, 128, 3, 1, (1, 1), (1, 1)),
])
def test_conv2d_kernel_on_card(cuda, N, H, W, cin, cout, k, stride, pad_h,
                               pad_w):
    gen, x, w = _conv_case(cuda, N, H, W, cin, cout, k)
    Ho = tcv.out_size(H, k, pad_h, stride)
    Wo = tcv.out_size(W, k, pad_w, stride)
    b = torch.randn(cout, device=cuda, generator=gen)
    row = torch.randn((N, cout), device=cuda, generator=gen)
    res = torch.randn((N, Ho, Wo, cout), device=cuda, generator=gen)
    for kw in ({}, {'bias': b}, {'bias': b, 'row': row},
               {'bias': b, 'residual': res}):
        before = tops.launch_counts()['conv2d_nhwc']
        out = tops.conv2d(x, w, pad_h, pad_w, stride, **kw)
        torch.cuda.synchronize()
        assert tops.launch_counts()['conv2d_nhwc'] == before + 1
        ref = tcv.conv2d_plain(x.double(), w.double(), pad_h, pad_w, stride,
                               **{n: t.double() for n, t in kw.items()})
        assert out.shape == ref.shape and _close(out, ref), kw


def test_conv2d_phases_write_through_output_strides_on_card(cuda):
    """The sparse transposed convolution's four phases written in place by
    the kernel, against the dense transposed convolution in float64."""
    gen, x, w = _conv_case(cuda, 2, 16, 16, 340, 340, 4)
    b = torch.randn(340, device=cuda, generator=gen)
    before = tops.launch_counts()['conv2d_nhwc']
    out = tsd.conv_transpose_sparse(x, w, 2, b)
    torch.cuda.synchronize()
    assert tops.launch_counts()['conv2d_nhwc'] == before + 4
    ref = tsd.conv_transpose_dense(x.double().cpu(), w.double().cpu(), 2) \
        + b.double().cpu()
    assert _close(out.cpu(), ref)


def test_conv2d_weight_split_is_remade_after_an_update_on_card(cuda):
    _, x, w = _conv_case(cuda, 2, 8, 8, 64, 64, 3)
    w = torch.nn.Parameter(w, requires_grad=False)
    first = tops.conv2d(x, w, (1, 1), (1, 1))
    with torch.no_grad():
        w.mul_(-2.0)
    second = tops.conv2d(x, w, (1, 1), (1, 1))
    torch.cuda.synchronize()
    assert _close(second, -2.0 * first.double())


def test_conv2d_gradient_on_card(no_tf32):
    """``Conv2d`` (kernel forward, plain backward) against autograd through
    ``conv2d_plain`` on the same card inputs, a phase's taps included;
    both backwards are cuDNN's float32, so only the forwards differ."""
    gen, x, w = _conv_case(no_tf32, 2, 12, 12, 68, 36, 4)
    b = torch.randn(36, device=no_tf32, generator=gen)
    row = torch.randn((2, 36), device=no_tf32, generator=gen)
    for taps, pads, stride, res_hw in ((None, ((1, 2), (1, 2)), 2, 6),
                                       (([1, 3], [0, 2]), ((1, 0), (0, 1)),
                                        1, 12)):
        res = torch.randn((2, res_hw, res_hw, 36), device=no_tf32,
                          generator=gen)
        ins = [x, w, b, row, res]
        a = [t.clone().requires_grad_() for t in ins]
        c = [t.clone().requires_grad_() for t in ins]
        y = tops.conv2d(a[0], a[1], *pads, stride, bias=a[2], row=a[3],
                        residual=a[4], taps=taps)
        dout = torch.randn(y.shape, device=no_tf32, generator=gen)
        y.backward(dout)
        tcv.conv2d_plain(c[0], tcv.tap_grid(c[1], taps), *pads, stride,
                         *c[2:]).backward(dout)
        for ta, tc in zip(a, c):
            scale = tc.grad.abs().max().item()
            assert (ta.grad - tc.grad).abs().max().item() <= 1e-5 * scale


# The GroupNorm+swish gradient: ``GNSwish`` (kernel forward, plain
# backward) against autograd through ``gn_swish_plain`` on the same card
# inputs, within 1e-4 of the largest gradient: both backwards are float32
# sums over up to 69,632 elements a group and 16,384 positions a channel,
# in other orders, from forwards ~3e-6 apart.
GN_GRAD_RTOL = 1e-4


@pytest.fixture
def no_tf32(cuda):
    """cuDNN convolutions in full float32 (its TF32 default would move a
    card-vs-CPU comparison by ~1e-3)."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cudnn.allow_tf32 = old


@pytest.mark.parametrize('N,H,W,C,g', [(4, 64, 64, 340, 20),
                                       (4, 16, 16, 1360, 20),
                                       (3, 5, 7, 96, 6), (2, 8, 8, 64, 32)])
def test_gn_swish_gradient_on_card(cuda, N, H, W, C, g):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((N, H, W, C), device=cuda, generator=gen) * 3 + 1
    sc = torch.randn(C, device=cuda, generator=gen)
    bi = torch.randn(C, device=cuda, generator=gen)
    dout = torch.randn((N, H, W, C), device=cuda, generator=gen)
    a = [t.clone().requires_grad_() for t in (x, sc, bi)]
    b = [t.clone().requires_grad_() for t in (x, sc, bi)]
    before = tops.launch_counts()['fused_gn_swish']
    out = tops.fused_gn_swish(*a, groups=g)
    assert out.grad_fn is not None
    out.backward(dout)
    tgn.gn_swish_plain(*b, g).backward(dout)
    torch.cuda.synchronize()
    assert tops.launch_counts()['fused_gn_swish'] == before + 1
    for name, ta, tb in zip(('dx', 'dscale', 'dbias'), a, b):
        tol = GN_GRAD_RTOL * tb.grad.abs().max().item()
        assert (ta.grad - tb.grad).abs().max().item() <= tol, name


def test_gn_swish_without_grad_launches_the_kernel_directly(cuda):
    x = torch.randn((2, 8, 8, 64), device=cuda)
    sc = torch.ones(64, device=cuda, requires_grad=True)
    bi = torch.zeros(64, device=cuda, requires_grad=True)
    with torch.no_grad():
        assert tops.fused_gn_swish(x, sc, bi, groups=32).grad_fn is None
    assert tops.fused_gn_swish(x, sc.detach(), bi.detach(),
                               groups=32).grad_fn is None


def test_ddpm_loss_backward_on_card_reaches_every_groupnorm(no_tf32):
    """A tiny SD-shaped UNet's ``ddpm_loss`` on the card: its GroupNorm+
    swish calls launch the kernel under the gradient, every GroupNorm
    parameter they take gets a non-zero gradient, and every gradient
    matches the CPU's from the same weights (1e-4, the fp32 card-vs-CPU
    tolerance)."""
    import copy
    from repro_torch.core import prng
    from repro_torch.diffusion.pipeline import DiffusionPipeline
    from repro_torch.diffusion.schedule import ddpm_loss
    from repro_torch.launch.steps import train_params
    from repro_torch.models.unet import UNetConfig
    cfg = UNetConfig('tiny-sdm', img_size=16, in_ch=4, base_ch=32,
                     ch_mults=(1, 2), n_res_blocks=1, attn_resolutions=(8,),
                     n_heads=4, timesteps=16, context_dim=8)
    cpu = DiffusionPipeline.init(0, cfg, device='cpu')
    gen = torch.Generator().manual_seed(1)
    x0 = torch.randn((2, 16, 16, 4), generator=gen) * 0.5
    ctx = torch.randn((2, 5, 8), generator=gen)
    grads, losses = {}, {}
    for dev in ('cpu', no_tf32):
        unet = copy.deepcopy(cpu.unet).to(dev)
        params = train_params(unet)
        sched = cpu.to(dev).sched
        before = tops.launch_counts()['fused_gn_swish']
        loss = ddpm_loss(lambda m, x, t, c: m(x, t, c), sched, unet,
                         x0.to(dev), prng.PRNGKey(3), ctx.to(dev))
        loss.backward()
        launched = tops.launch_counts()['fused_gn_swish'] - before
        assert launched == (17 if dev != 'cpu' else 0)
        losses[str(dev)] = loss.item()
        grads[str(dev)] = {n: p.grad.cpu() for n, p in params.items()}
    gpu = str(no_tf32)
    gn = [n for n in grads[gpu] if n.endswith(('gn1.scale', 'gn1.bias',
                                               'gn2.scale', 'gn2.bias'))
          or n.startswith('gn_out.')]
    assert len(gn) == 4 * 8 + 2
    for n in gn:
        assert grads[gpu][n].abs().max() > 0, n
    assert abs(losses[gpu] - losses['cpu']) <= 1e-4
    for n, g in grads['cpu'].items():
        assert (grads[gpu][n] - g).abs().max().item() <= 1e-4, n


def test_kernels_without_backward_refuse_a_gradient(cuda):
    """The W8A8 and flash kernels have no backward: under a wanted
    gradient their wrappers raise instead of returning an output autograd
    cannot trace; under ``no_grad`` they launch as before."""
    x = torch.randn((8, 64), device=cuda, requires_grad=True)
    w = torch.randn((64, 32), device=cuda)
    with pytest.raises(RuntimeError, match='no backward'):
        tops.w8a8_matmul(x, w)
    with pytest.raises(RuntimeError, match='no backward'):
        tops.w8a8_matmul(x.detach(), w.requires_grad_())
    q = torch.randn((1, 2, 64, 32), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match='no backward'):
        tops.flash_attention(q, q.detach(), q.detach(), causal=True)
    qb = torch.randn((1, 64, 2, 32), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match='no backward'):
        tops.flash_attention_bshd(qb, qb.detach(), qb.detach(), causal=True)
    before = tops.launch_counts()
    with torch.no_grad():
        tops.w8a8_matmul(x, w)
        tops.flash_attention(q, q, q, causal=True)
        tops.flash_attention_bshd(qb, qb, qb, causal=True)
    torch.cuda.synchronize()
    after = tops.launch_counts()
    assert after['w8a8_matmul'] == before['w8a8_matmul'] + 1
    assert after['flash_attention'] == before['flash_attention'] + 2
