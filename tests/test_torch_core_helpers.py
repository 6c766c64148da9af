"""The port's remaining ``core`` helpers and the GroupNorm+swish kernel's
gradient against the reference, in one process, from numpy inputs made
from a seed: ``fake_quantize``, ``quantization_error`` and
``quantize_params`` (the reference's quantized tree loaded through the
bridge equals the port's quantized module, conv kernels and the smoke
LMs' MoE experts included, and the quantized LMs give the
reference's logits), ``zero_mac_fraction``, the paper's Eq. 6
(``core/attention_decomp.py``), and ``gn_swish_backward_plain`` against
``jax.vjp`` of ``repro/kernels/ref.py::gn_swish_ref``, with the
``GNSwish`` Function's plumbing on the CPU.

Tolerances: the quantizers exact (the same float32 absmax and round half
to even); ``quantization_error`` 1e-6 relative (two float32 norms summed
in another order); the quantized LMs' logits 1e-3, ``test_torch_lm.py``'s
w8a8 tolerance (a ~1e-7 difference can move one int8 rounding at a
tie); Eq. 6 1e-5 of the largest score (float32 einsums in another
order); the plain backward 1e-5 of the largest gradient (group
statistics in float32 over up to 2048 elements, summed in another
order); the Function against autograd through ``gn_swish_plain`` 1e-5
(the same formula by hand against autograd's chain)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import attention_decomp as jad
from repro.core import quantization as jq
from repro.core import sparse_dataflow as jsd
from repro.kernels import ref as jref
from repro.launch import steps as JS
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.core import attention_decomp as tad
from repro_torch.core import quantization as tq
from repro_torch.core import sparse_dataflow as tsd
from repro_torch.kernels import fused_gn_swish as tgn
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

ERR_RTOL = 1e-6
LM_W8A8_ATOL = 1e-3
DECOMP_RTOL = 1e-5
GN_BWD_RTOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _numpy_tree(tree):
    """A reference tree as numpy, a ``QTensor`` leaf as an object with
    numpy ``q`` and ``scale`` (what the bridge reads)."""
    def leaf(x):
        if isinstance(x, jq.QTensor):
            return types.SimpleNamespace(q=np.asarray(x.q),
                                         scale=np.asarray(x.scale))
        return np.asarray(x)
    return jax.tree_util.tree_map(
        leaf, tree, is_leaf=lambda x: isinstance(x, jq.QTensor))


# --- quantization helpers ---------------------------------------------------

@pytest.mark.parametrize('shape,axis', [((32, 40), None), ((32, 40), (0,)),
                                        ((6, 5, 7), (2,))])
def test_fake_quantize_and_error_match_reference(shape, axis):
    w = _np(shape, 1) * (10.0 ** np.random.default_rng(2).uniform(
        -2, 2, size=shape[-1:])).astype(np.float32)
    want = jq.fake_quantize(jnp.asarray(w), axis=axis)
    got = tq.fake_quantize(torch.from_numpy(w), axis=axis)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    e_want = float(jq.quantization_error(jnp.asarray(w), axis=axis))
    e_got = tq.quantization_error(torch.from_numpy(w), axis=axis)
    assert e_got.dim() == 0
    np.testing.assert_allclose(e_got.item(), e_want, rtol=ERR_RTOL)


def test_per_channel_error_beats_per_tensor_on_the_port():
    """The reference's ``test_per_channel_better_or_equal`` on the port:
    with heterogeneous channel scales, per-channel scales lose less."""
    for n in (4, 17, 64):
        rng = np.random.default_rng(n)
        w = torch.from_numpy((rng.normal(size=(32, n)) * 10.0 ** rng.uniform(
            -2, 2, size=(1, n))).astype(np.float32))
        e_tensor = float(tq.quantization_error(w))
        e_chan = float(tq.quantization_error(w, axis=(0,)))
        assert e_chan <= e_tensor * 1.001


def test_quantize_params_structure_and_accuracy():
    """The reference's test on the port: a Linear's weight becomes a
    ``QWeight``, its bias and a norm's scale stay float, and the quantized
    Linear stays within 3% of the float one; the input is not touched."""
    m = torch.nn.Module()
    m.wq = TL.Linear(128, 64, bias=True)
    m.norm = TL.RMSNorm(128)
    TL.init_params(m, torch.Generator().manual_seed(0))
    pq = tq.quantize_params(m, min_size=16)
    assert isinstance(pq.wq.w, TL.QWeight)
    assert isinstance(m.wq.w, torch.nn.Parameter)
    assert pq.wq.b.dtype == torch.float32
    assert pq.norm.scale.dtype == torch.float32
    x = torch.from_numpy(_np((4, 128), 0))
    with torch.no_grad():
        a, b = m.wq(x), pq.wq(x)
    assert float((a - b).norm() / a.norm()) < 0.03
    assert not isinstance(tq.quantize_params(m, min_size=1 << 14).wq.w,
                          TL.QWeight)


def _assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_quantize_params_of_convs_and_linears_matches_the_reference():
    """The reference quantizes every float weight named ``w`` of at least
    ``min_size`` elements, conv kernels (HWIO) included: the port's
    module (OIHW) holds the same int8 values and scales.  The reference
    quantizes eagerly here: under ``jit`` XLA rewrites the scale's
    division, and the scales move by an ulp."""
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    jp = {'conv': JL.init_conv(keys[0], 3, 3, 16, 32),
          'up': JL.init_conv(keys[1], 4, 4, 8, 8),
          'proj': JL.init_linear(keys[2], 32, 24),
          'small': JL.init_linear(keys[3], 4, 4),
          'norm': JL.init_rmsnorm(32)}
    port = torch.nn.Module()
    port.conv, port.up = TL.Conv(3, 3, 16, 32), TL.Conv(4, 4, 8, 8)
    port.proj, port.small = TL.Linear(32, 24), TL.Linear(4, 4)
    port.norm = TL.RMSNorm(32)
    port = tq.quantize_params(bridge.load_jax_params(port, _numpy_tree(jp)),
                              min_size=64)
    ref = bridge.load_jax_params(
        tq.quantize_params(port, min_size=1 << 30),
        _numpy_tree(jq.quantize_params(jp, min_size=64)))
    for name in ('conv', 'up', 'proj'):
        assert isinstance(getattr(port, name).w, TL.QWeight), name
    assert isinstance(port.small.w, torch.nn.Parameter)
    assert port.conv.w.scale.shape == (32, 1, 3, 3)
    _assert_same_state(port, ref)


@pytest.mark.parametrize('arch', ['granite-moe-1b-a400m', 'internlm2-1.8b'])
def test_quantize_params_of_an_lm_matches_the_reference(arch):
    """The smoke LMs (Granite-MoE's experts as ``w_gate`` / ``w_up`` /
    ``w_down``): the reference's quantized tree loads through the bridge
    into the port's quantized module exactly, and both give the same
    logits."""
    jcfg, tcfg = jreg.smoke_config(arch), treg.smoke_config(arch)
    jp = JS.init_params(jax.random.PRNGKey(0), jcfg)
    jqp = jq.quantize_params(jp, min_size=16)
    port = tq.quantize_params(
        bridge.load_jax_lm_params(TT.LM(tcfg, 'cpu'), _numpy_tree(jp)),
        min_size=16)
    ref = bridge.load_jax_lm_params(TT.LM(tcfg, 'cpu'), _numpy_tree(jqp))
    _assert_same_state(port, ref)
    if arch.startswith('granite'):
        moe = [m for m in port.modules() if hasattr(m, 'w_gate')]
        assert moe and all(isinstance(m.w_gate, TL.QWeight) for m in moe)
    tok = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 8)).astype(
        np.int32)
    want = JT.lm_apply(jqp, jcfg, jnp.asarray(tok))
    with torch.no_grad():
        got = TT.lm_apply(port, tcfg, torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LM_W8A8_ATOL)


# --- the sparse dataflow's saving ------------------------------------------

@pytest.mark.parametrize('kh,kw,s', [(4, 4, 2), (3, 3, 2), (6, 6, 3),
                                     (8, 4, 2), (5, 5, 1), (2, 2, 4)])
def test_zero_mac_fraction_matches_reference(kh, kw, s):
    assert tsd.zero_mac_fraction(kh, kw, s) == jsd.zero_mac_fraction(kh, kw, s)
    if kh == kw and kh % s == 0:
        assert abs(tsd.zero_mac_fraction(kh, kw, s) - (1 - 1 / s ** 2)) < 1e-9


# --- Eq. 6 -----------------------------------------------------------------

@pytest.mark.parametrize('S,T,d,d_k', [(4, 77, 64, 16), (64, 64, 32, 32),
                                       (1, 300, 48, 8)])
def test_attention_decomposition_matches_reference(S, T, d, d_k):
    q = _np((2, 3, S, d_k), 1)
    x = _np((2, 3, T, d), 2)
    w_k = _np((d, d_k), 3)
    w_q = _np((d, d_k), 4)
    np.testing.assert_array_equal(
        tad.fold_scale_into_wq(torch.from_numpy(w_q), d_k).numpy(),
        np.asarray(jad.fold_scale_into_wq(jnp.asarray(w_q), d_k)))
    assert tad.decomp_flops(S, T, d, d_k) == jad.decomp_flops(S, T, d, d_k)
    tq_, tx, tw = (torch.from_numpy(a) for a in (q, x, w_k))
    std = tad.scores_standard(tq_, tx, tw)
    tol = DECOMP_RTOL * float(std.abs().max())
    for tf, jf in ((tad.scores_standard, jad.scores_standard),
                   (tad.scores_reordered, jad.scores_reordered),
                   (tad.scores_auto, jad.scores_auto)):
        got = tf(tq_, tx, tw)
        assert got.shape == (2, 3, S, T)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jf(jnp.asarray(q), jnp.asarray(x),
                                       jnp.asarray(w_k))), atol=tol)
    # the two orders compute the same scores; auto takes the cheaper one
    np.testing.assert_allclose(tad.scores_reordered(tq_, tx, tw).numpy(),
                               std.numpy(), atol=tol)


# --- the GroupNorm+swish gradient -------------------------------------------

@pytest.mark.parametrize('N,H,W,C,g', [(2, 8, 8, 64, 32), (3, 5, 7, 96, 6),
                                       (1, 16, 16, 32, 32), (2, 4, 4, 40, 8)])
def test_gn_swish_backward_plain_matches_jax_vjp(N, H, W, C, g):
    rng = np.random.default_rng(N * C + g)
    x = (rng.normal(size=(N, H, W, C)) * 3 + 1).astype(np.float32)
    sc = rng.normal(size=(C,)).astype(np.float32)
    bi = rng.normal(size=(C,)).astype(np.float32)
    dout = rng.normal(size=(N, H, W, C)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jref.gn_swish_ref(a, b, c, groups=g),
                     jnp.asarray(x), jnp.asarray(sc), jnp.asarray(bi))
    want = vjp(jnp.asarray(dout))
    got = tgn.gn_swish_backward_plain(
        torch.from_numpy(x), torch.from_numpy(sc), torch.from_numpy(bi), g,
        torch.from_numpy(dout))
    for name, a, b in zip(('dx', 'dscale', 'dbias'), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b,
                                   atol=GN_BWD_RTOL * np.abs(b).max(),
                                   err_msg=name)


def test_gn_swish_function_runs_kernel_forward_and_plain_backward(
        monkeypatch):
    """``GNSwish`` on the CPU with the kernel entry replaced by the plain
    forward (the CUDA kernel cannot run here): one call of the kernel
    entry per forward, and the gradients of autograd through
    ``gn_swish_plain``, for every input that wants one."""
    calls = []

    def fake_kernel(x, scale, bias, groups, eps=1e-5):
        calls.append(tuple(x.shape))
        with torch.no_grad():
            return tgn.gn_swish_plain(x, scale, bias, groups, eps)
    monkeypatch.setattr(tgn, 'fused_gn_swish_kernel', fake_kernel)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 6, 6, 64), generator=gen)
    sc = torch.randn(64, generator=gen)
    bi = torch.randn(64, generator=gen)
    dout = torch.randn((2, 6, 6, 64), generator=gen)
    for need in ((True, True, True), (False, True, False)):
        a = [t.clone().requires_grad_(n) for t, n in zip((x, sc, bi), need)]
        b = [t.clone().requires_grad_(n) for t, n in zip((x, sc, bi), need)]
        tgn.GNSwish.apply(*a, 16, 1e-5).backward(dout)
        tgn.gn_swish_plain(*b, 16).backward(dout)
        for ta, tb, n in zip(a, b, need):
            if not n:
                assert ta.grad is None
                continue
            torch.testing.assert_close(ta.grad, tb.grad, atol=1e-5,
                                       rtol=1e-5)
    assert calls == [(2, 6, 6, 64)] * 2
