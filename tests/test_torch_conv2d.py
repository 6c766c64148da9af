"""The convolution kernel's wrapper (``kernels/conv2d.py``) on the CPU: its
plain path, which the CPU runs, against the unfused sequence the port ran
before it (``F.conv2d`` on the channels-last view, padding first where it
is unequal or negative, then ``+ bias``, ``+ row``, ``residual +``), bit
for bit; the transposed convolution's phases written in place through the
output's strides, bit for bit against assigning each phase; the fused
ResBlocks of the UNet and the VAE against their unfused formulas; the
weight the CUDA kernel reads (layout, TF32 halves, cache); the tile plan;
``meta`` tensors; and the ``Conv2d`` Function's plumbing with a stand-in
kernel.  No JAX: the layers' agreement with the reference is
``test_torch_layers.py``'s.

Tolerances: bit for bit throughout (the same operations in the same
order), except hi + lo against the weight, 2^-22 relative (lo is rounded
to TF32 too, so it keeps 11 of the 24 bits of x - hi), and the Function's
gradients against autograd through the plain version, 1e-5 (autograd's
own chain either way, the same formula).
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import sparse_dataflow as tsd
from repro_torch.kernels import conv2d as tcv
from repro_torch.kernels import ops as tops
from repro_torch.models import autoencoder as TAE
from repro_torch.models import layers as TL
from repro_torch.models import unet as TU


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Small tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unfused(x, w, pad_h, pad_w, stride, bias=None, row=None, residual=None):
    """The sequence the port ran before the kernel: ``conv_nhwc`` (the
    correlation on the channels-last view, padding first where it is
    unequal or negative), then its callers' adds."""
    xc = x.permute(0, 3, 1, 2)
    if pad_h[0] == pad_h[1] >= 0 and pad_w[0] == pad_w[1] >= 0:
        y = F.conv2d(xc, w, stride=stride, padding=(pad_h[0], pad_w[0]))
    else:
        xc = F.pad(xc, (pad_w[0], pad_w[1], pad_h[0], pad_h[1]))
        y = F.conv2d(xc, w, stride=stride)
    y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias
    if row is not None:
        y = y + row[:, None, None, :]
    if residual is not None:
        y = residual + y
    return y


def _operands(N, H, W, cin, cout, k, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((N, H, W, cin), generator=g)
    w = torch.randn((cout, cin, k, k), generator=g) * (cin * k * k) ** -0.5
    return g, x, w


# (cin, cout, k, stride, pad_h, pad_w, H): SAME at stride 1 and 2, the
# stride-2 SAME pads (0, 1), a phase's asymmetric and negative pads, and
# 1x1 kernels; channel counts of the VAE's and UNet's ends and middles
CASES = [
    (3, 4, 3, 1, (1, 1), (1, 1), 6),
    (4, 3, 3, 1, (1, 1), (1, 1), 6),
    (4, 340, 3, 1, (1, 1), (1, 1), 5),
    (340, 4, 3, 1, (1, 1), (1, 1), 5),
    (340, 340, 3, 2, (0, 1), (0, 1), 6),
    (3, 340, 3, 2, (1, 1), (0, 1), 7),
    (2040, 4, 1, 1, (0, 0), (0, 0), 3),
    (4, 2040, 1, 1, (0, 0), (0, 0), 3),
    (2040, 340, 3, 1, (1, 1), (1, 1), 2),
    (340, 3, 2, 1, (0, -1), (-1, 0), 5),
    (4, 340, 2, 1, (1, 0), (0, 1), 4),
    (3, 4, 2, 2, (0, -1), (1, 0), 6),
]


@pytest.mark.parametrize('cin,cout,k,stride,pad_h,pad_w,H', CASES)
def test_plain_path_matches_the_unfused_sequence(cin, cout, k, stride, pad_h,
                                                  pad_w, H):
    _, x, w = _operands(2, H, H + 1, cin, cout, k)
    want = _unfused(x, w, pad_h, pad_w, stride)
    assert torch.equal(tops.conv2d(x, w, pad_h, pad_w, stride), want)
    assert torch.equal(tcv.conv2d_plain(x, w, pad_h, pad_w, stride), want)


@pytest.mark.parametrize('operands', ['bias', 'row', 'residual', 'bias+row',
                                      'bias+residual', 'bias+row+residual'])
@pytest.mark.parametrize('stride', [1, 2])
def test_epilogue_operands_add_in_the_unfused_order(operands, stride):
    g, x, w = _operands(3, 8, 8, 68, 36, 3, seed=1)
    Ho = tcv.out_size(8, 3, (0, 1) if stride == 2 else (1, 1), stride)
    pads = (0, 1) if stride == 2 else (1, 1)
    kw = {'bias': torch.randn(36, generator=g),
          'row': torch.randn((3, 36), generator=g),
          'residual': torch.randn((3, Ho, Ho, 36), generator=g)}
    kw = {k: v for k, v in kw.items() if k in operands.split('+')}
    want = _unfused(x, w, pads, pads, stride, **kw)
    got = tops.conv2d(x, w, pads, pads, stride, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize('cin,cout,H', [(8, 8, 3), (340, 4, 4), (4, 340, 5),
                                        (3, 16, 2)])
def test_phases_write_in_place_through_output_strides(cin, cout, H):
    """Each phase of the sparse transposed convolution into
    ``out[:, py::2, px::2, :]`` by ``ops.conv2d(..., out=)``, against the
    assignment of the phase's own result; and the whole transposed
    convolution with its bias against the phases assigned, then the bias
    added (the code before the epilogue took the bias)."""
    g, x, w = _operands(2, H, H, cin, cout, 4, seed=2)
    b = torch.randn(cout, generator=g)
    s, pt = 2, tsd._pad_a(4, 2)
    got = torch.zeros(2, 2 * H, 2 * H, cout)
    want = torch.zeros(2, 2 * H, 2 * H, cout)
    for py in range(s):
        for px in range(s):
            (rows, oy0, oy1), (cols, ox0, ox1) = (
                tsd._phase_grid(4, s, py, pt), tsd._phase_grid(4, s, px, pt))
            view = got[:, py::s, px::s, :]
            back = tops.conv2d(x, w, (-oy0, oy1), (-ox0, ox1),
                               taps=(rows, cols), out=view)
            assert back.data_ptr() == view.data_ptr()
            want[:, py::s, px::s, :] = _unfused(
                x, w[:, :, rows][:, :, :, cols], (-oy0, oy1), (-ox0, ox1), 1)
    assert torch.equal(got, want)
    assert torch.equal(tsd.conv_transpose_sparse(x, w, 2, b), want + b)
    assert torch.equal(TL.conv_transpose2d(x, w, b, 2), want + b)


def test_unet_resblock_fused_matches_the_unfused_formula():
    g = torch.Generator().manual_seed(3)
    blk = TU.ResBlock(16, 24, 12)
    TL.init_params(blk, g)
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.1)
    x = torch.randn((2, 6, 6, 16), generator=g)
    t_emb = torch.randn((2, 12), generator=g)
    with torch.no_grad():
        h = tops.fused_gn_swish(x, blk.gn1.scale, blk.gn1.bias, groups=8)
        h = _unfused(h, blk.conv1.w, (1, 1), (1, 1), 1, blk.conv1.b)
        h = h + blk.t_proj(TL.swish(t_emb))[:, None, None, :]
        h = tops.fused_gn_swish(h, blk.gn2.scale, blk.gn2.bias, groups=8)
        h = _unfused(h, blk.conv2.w, (1, 1), (1, 1), 1, blk.conv2.b)
        want = _unfused(x, blk.skip.w, (0, 0), (0, 0), 1, blk.skip.b) + h
        assert torch.equal(blk(x, t_emb, 8), want)


def test_vae_resblock_fused_matches_the_unfused_formula():
    g = torch.Generator().manual_seed(4)
    blk = TAE._Res(8, 12, None)
    TL.init_params(blk, g)
    x = torch.randn((1, 5, 5, 8), generator=g)
    with torch.no_grad():
        h = blk.conv1(TL.swish(blk.gn1(x, 4)))
        h = blk.conv2(TL.swish(blk.gn2(h, 4)))
        want = blk.skip(x) + h
        assert torch.equal(blk(x, 4), want)


# ---------------------------------------------------------------------------
# the weight the kernel reads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('cin', [3, 4, 340])
def test_kernel_weight_layout_is_cout_kh_kw_cin(cin):
    _, _, w = _operands(1, 1, 1, cin, 5, 3, seed=5)
    hi, lo = tcv.kernel_weight(w)
    cp = -(-cin // tcv.C_ALIGN) * tcv.C_ALIGN
    assert hi.shape == lo.shape == (5, 3, 3, cp)
    assert hi.is_contiguous() and lo.is_contiguous()
    whole = (hi + lo)[..., :cin]
    for co, ky, kx, ci in ((0, 0, 0, 0), (4, 2, 1, cin - 1),
                           (2, 1, 2, cin // 2)):
        assert abs(whole[co, ky, kx, ci] - w[co, ci, ky, kx]) <= \
            2.0 ** -22 * abs(w[co, ci, ky, kx])
    assert not hi[..., cin:].any() and not lo[..., cin:].any()


@pytest.mark.parametrize('scale', [1.0, 1e-20, 3e30])
def test_kernel_weight_halves_are_tf32_and_sum_to_the_weight(scale):
    g = torch.Generator().manual_seed(6)
    w = torch.randn((64, 40, 3, 3), generator=g) * scale
    # values whose 13 low bits are all set, where truncating would fail
    w.view(torch.int32)[0, :8] |= 0x1FFF
    hi, lo = tcv.kernel_weight(w)
    for half in (hi, lo):
        assert not (half.view(torch.int32) & 0x1FFF).any()
    wt = w.permute(0, 2, 3, 1)
    rel = ((hi.double() + lo.double() - wt.double()).abs()
           / wt.double().abs().clamp_min(1e-300))
    assert rel.max().item() <= 2.0 ** -22
    # hi alone is plain TF32: far coarser
    assert ((hi.double() - wt.double()).abs()
            / wt.double().abs()).max().item() > 2.0 ** -14


def test_kernel_weight_is_cached_until_the_weight_changes():
    w = torch.nn.Parameter(torch.randn(6, 4, 2, 2), requires_grad=False)
    hi, lo = tcv.kernel_weight(w)
    again = tcv.kernel_weight(w)
    assert again[0] is hi and again[1] is lo
    sub = tcv.kernel_weight(w, ([0], [1]))
    assert sub[0].shape == (6, 1, 1, 4)
    assert torch.equal(sub[0][:, 0, 0], hi[:, 0, 1])
    assert tcv.kernel_weight(w, ([0], [1]))[0] is sub[0]
    with torch.no_grad():
        w.mul_(2.0)                        # bumps w._version
    hi2, lo2 = tcv.kernel_weight(w)
    assert hi2 is not hi and torch.equal(hi2, 2 * hi)
    assert tcv.kernel_weight(w, ([0], [1]))[0] is not sub[0]


@pytest.mark.parametrize('stride', [1, 2])
def test_meta_tensors_give_shapes_and_launch_nothing(stride):
    tops.reset_launches()
    x = torch.empty((2, 9, 7, 340), device='meta')
    w = torch.empty((680, 340, 3, 3), device='meta')
    pads = (1, 1) if stride == 1 else (0, 1)
    y = tops.conv2d(x, w, pads, pads, stride,
                    bias=torch.empty(680, device='meta'))
    Ho, Wo = tcv.out_size(9, 3, pads, stride), tcv.out_size(7, 3, pads, stride)
    assert y.device.type == 'meta' and y.shape == (2, Ho, Wo, 680)
    assert TL.conv2d(x, w, None, stride).shape == (2, -(-9 // stride),
                                                   -(-7 // stride), 680)
    assert tops.launch_counts()['conv2d_nhwc'] == 0


def test_fake_cuda_tensors_trace_through_the_plain_path():
    from torch._subclasses.fake_tensor import FakeTensorMode
    tops.reset_launches()
    with FakeTensorMode(allow_non_fake_inputs=False) as mode:
        x = mode.from_tensor(torch.empty((2, 8, 8, 16), device='meta'))
        w = mode.from_tensor(torch.empty((32, 16, 3, 3), device='meta'))
        y = tops.conv2d(x, w, (1, 1), (1, 1))
    assert y.shape == (2, 8, 8, 32)
    assert tops.launch_counts()['conv2d_nhwc'] == 0


def test_kernel_entry_refuses_cpu_tensors():
    with pytest.raises(ValueError, match='needs a CUDA tensor'):
        tcv.conv2d_kernel(torch.zeros(1, 4, 4, 4), torch.zeros(4, 4, 3, 3),
                          (1, 1), (1, 1))


# ---------------------------------------------------------------------------
# the tile plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('N,H,cout', [
    (48, 64, 340), (16, 64, 340), (48, 8, 1360), (16, 8, 1360),
    (48, 32, 680), (1, 512, 3), (1, 512, 128), (2, 20, 4), (3, 7, 70)])
def test_conv_plan_tiles_cover_the_output(N, H, cout):
    plan = tcv.conv_plan(N, H, H, cout)
    bw, bh, bn = plan.box
    assert plan.rows in tcv.TILE_ROWS and bw * bh * bn <= plan.rows
    assert plan.cols == next((c for c in tcv.TILE_COLS if cout <= c), 128)
    assert bn == 1 or bh == H                   # images only when whole
    tiles = -(-H // bw) * -(-H // bh) * -(-N // bn) * -(-cout // plan.cols)
    assert plan.blocks == tiles
    # 64-pixel tiles only where 128-pixel ones leave SMs idle
    if plan.rows == 64:
        big = tcv._box(N, H, H, 128)
        assert (-(-H // big[0]) * -(-H // big[1]) * -(-N // big[2])
                * -(-cout // plan.cols)) < tcv.SMS


def test_conv_plan_picks_by_what_it_sees():
    # SD v1.4's 8x8 level: 48 rows fill the card with 128-pixel tiles,
    # 16 rows (the Poisson cell's) do not
    assert tcv.conv_plan(48, 8, 8, 1360).rows == 128
    assert tcv.conv_plan(16, 8, 8, 1360).rows == 64
    assert tcv.conv_plan(16, 8, 8, 1360).cols == 128
    assert tcv.conv_plan(48, 64, 64, 340).box == (64, 2, 1)
    assert tcv.conv_plan(48, 8, 8, 1360).box == (8, 8, 2)
    assert tcv.conv_plan(1, 512, 512, 3).cols == 16


# ---------------------------------------------------------------------------
# the gradient
# ---------------------------------------------------------------------------

def test_conv2d_function_runs_kernel_forward_and_plain_backward(monkeypatch):
    """``Conv2d`` on the CPU with the kernel entry replaced by the plain
    forward (the CUDA kernel cannot run here): one call of the kernel
    entry per forward, and the gradients of autograd through
    ``conv2d_plain`` for every input that wants one, a phase's taps
    included."""
    calls = []

    def fake_kernel(x, w, pad_h, pad_w, stride=1, bias=None, row=None,
                    residual=None, *, taps=None, out=None):
        calls.append(tuple(x.shape))
        with torch.no_grad():
            return tcv.conv2d_plain(x, tcv.tap_grid(w, taps), pad_h, pad_w,
                                    stride, bias, row, residual)
    monkeypatch.setattr(tcv, 'conv2d_kernel', fake_kernel)
    g, x, w = _operands(2, 6, 6, 8, 12, 3, seed=7)
    ops = [x, w, torch.randn(12, generator=g),
           torch.randn((2, 12), generator=g),
           torch.randn((2, 3, 3, 12), generator=g)]
    dout = torch.randn((2, 3, 3, 12), generator=g)
    for need, taps in (((True,) * 5, None), ((False, True, False, True, False),
                                             ([0, 2], [1, 2]))):
        pads = ((0, 1), (0, 1)) if taps is None else ((0, 0), (0, 0))
        stride = 2
        a = [t.clone().requires_grad_(n) for t, n in zip(ops, need)]
        b = [t.clone().requires_grad_(n) for t, n in zip(ops, need)]
        tcv.Conv2d.apply(*a, *pads, stride, taps).backward(dout)
        tcv.conv2d_plain(b[0], tcv.tap_grid(b[1], taps), *pads, stride,
                         *b[2:]).backward(dout)
        for ta, tb, n in zip(a, b, need):
            if not n:
                assert ta.grad is None
                continue
            torch.testing.assert_close(ta.grad, tb.grad, atol=1e-5, rtol=1e-5)
    assert calls == [(2, 6, 6, 8)] * 2
