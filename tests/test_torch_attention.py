"""Port attention vs the reference on the same numpy inputs: the flash
wrapper (the plain streaming version a CPU tensor runs) against the
reference wrapper with its Pallas kernel in interpret mode, the streaming
LSE softmax, RoPE, ``gqa_core``, and the attention layer without a cache
(``impl`` 'xla' and 'pallas'), as a prefill into a cache and as decode
steps against it; M-RoPE, cross-attention into a memory and explicit
positions.

Tolerances: 2e-5 for attention outputs, the reference kernel test's own
(float32 sums in another order: tiles of 128 against einsums); 1e-5 for
RoPE and the layer's projections, which differ only in summation order
and in the last bit of cos/sin."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.core import lse_softmax as jlse
from repro.kernels import ops as jops
from repro.models import attention as JA
from repro_torch.bridge import load_jax_params
from repro_torch.configs import registry as treg
from repro_torch.core import lse_softmax as tlse
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as TA

ATOL = 2e-5


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


# ---------------------------------------------------------------------------
# flash attention and the streaming softmax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('S,T,d,causal', [
    (128, 128, 64, False), (128, 128, 64, True),
    (256, 256, 32, True), (128, 384, 64, False),
    (100, 128, 64, True),       # ragged q
])
def test_flash_attention_matches_reference_kernel(S, T, d, causal):
    B, H = 2, 3
    q, k, v = (_np((B, H, S, d), 1), _np((B, H, T, d), 2),
               _np((B, H, T, d), 3))
    if causal and S != T:
        k, v = k[:, :, :S], v[:, :, :S]
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                mode='interpret')
    got = tops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize('T,causal,block', [
    (256, False, 64), (200, False, 128), (200, True, 128), (77, False, 32),
])
def test_streaming_attention_matches_reference(T, causal, block):
    """Ragged T pads to the block and masks the padded keys."""
    S = T if causal else 96
    q, k, v = _np((2, 2, S, 32), 4), _np((2, 2, T, 32), 5), \
        _np((2, 2, T, 32), 6)
    want = jlse.streaming_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), block=block,
                                        causal=causal)
    got = tlse.streaming_attention_ref(_t(q), _t(k), _t(v), block=block,
                                       causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_stream_update_broadcasts_values_over_query_dims():
    """Scores (..., B) with value rows (..., B, d): one query per row."""
    s1, s2, v1, v2 = (_np((3, 16), 7), _np((3, 16), 8), _np((3, 16, 8), 9),
                      _np((3, 16, 8), 10))
    js = jlse.stream_init((3,), 8)
    ts = tlse.stream_init((3,), 8)
    for s, v in ((s1, v1), (s2, v2)):
        js = jlse.stream_update(js, jnp.asarray(s), jnp.asarray(v))
        ts = tlse.stream_update(ts, _t(s), _t(v))
    np.testing.assert_allclose(tlse.stream_finalize(ts).numpy(),
                               np.asarray(jlse.stream_finalize(js)),
                               atol=ATOL)


def test_flash_attention_keeps_bf16_and_takes_scale():
    q, k, v = (_np((1, 2, 40, 16), 11), _np((1, 2, 40, 16), 12),
               _np((1, 2, 40, 16), 13))
    out = tops.flash_attention(_t(q).bfloat16(), _t(k).bfloat16(),
                               _t(v).bfloat16(), causal=True, scale=0.3)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 2, 40, 16)
    want = jops.flash_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), causal=True, scale=0.3,
        mode='interpret')
    # both round a float32 result to bf16: at most one bf16 ulp apart
    want = np.asarray(want.astype(jnp.float32))
    assert (np.abs(out.float().numpy() - want)
            <= 2.0 ** -7 * np.abs(want) + 1e-6).all()


def test_flash_attention_refuses_other_devices():
    x = torch.zeros((1, 1, 4, 16), device='meta')
    with pytest.raises(ValueError, match='no kernel for device'):
        tops.flash_attention(x, x, x)
    with pytest.raises(ValueError, match='no kernel for device'):
        tops.flash_attention_bshd(x, x, x)


def test_flash_kernel_entries_need_cuda_tensors():
    """The kernel entries never run the plain version themselves: a CPU
    tensor reaches the plain version only through ``ops``."""
    x = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match='needs CUDA tensors'):
        tfa.flash_attention_bshd_kernel(x, x[:, :, :1], x[:, :, :1])
    with pytest.raises(ValueError, match='needs CUDA tensors'):
        tfa.flash_attention_kernel(x[0], x[0], x[0])


@pytest.mark.parametrize('S,t_max,causal', [
    (40, 64, True), (100, 128, True),      # ragged S, a longer cache
    (40, 64, False), (77, 100, False),
])
def test_flash_attention_bshd_matches_reference_flash_core(monkeypatch, S,
                                                           t_max, causal):
    """The grouped entry on q (B, S, H, d) against cache[:, :S] of a
    (B, t_max, G, d) cache with H / G = 2, passed as the non-contiguous
    slices they are, against the reference's ``flash_core`` with its Pallas
    kernel in interpret mode (as the reference's kernel tests run it) on
    the same values.  Tolerance 2e-5, the reference kernel test's."""
    monkeypatch.setenv('REPRO_KERNELS', 'interpret')
    B, H, G, d = 2, 4, 2, 32
    q = _np((B, S, H, d), 30)
    ck, cv = _np((B, t_max, G, d), 31), _np((B, t_max, G, d), 32)
    want = JA.flash_core(jnp.asarray(q), jnp.asarray(ck[:, :S]),
                         jnp.asarray(cv[:, :S]), causal=causal)
    k, v = _t(ck)[:, :S], _t(cv)[:, :S]
    assert not k.is_contiguous()
    got = tops.flash_attention_bshd(_t(q), k, v, causal=causal)
    assert got.shape == (B, S, H, d) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_flash_core_hands_the_cache_over_where_it_lies(monkeypatch):
    """The prefill's ``flash_core`` passes q and the cache rows it wrote
    to the grouped entry as they are: no repeated heads, no copies."""
    _, tcfg, _, tp = _layer('internlm2-1.8b')
    B, S = 2, 9
    cache = TA.init_attention_cache(tcfg, B, S + 4, torch.float32)
    seen = []
    entry = tops.flash_attention_bshd

    def record(q, k, v, **kw):
        seen.append((q, k, v))
        return entry(q, k, v, **kw)

    monkeypatch.setattr(tops, 'flash_attention_bshd', record)
    TA.attention(tp, tcfg, _t(_np((B, S, tcfg.d_model), 33)), cache=cache,
                 cache_pos=0)
    (q, k, v), = seen
    assert q.shape == (B, S, tcfg.n_heads, tcfg.hd) and q.is_contiguous()
    for got, full in ((k, cache['k']), (v, cache['v'])):
        assert got.shape == (B, S, tcfg.n_kv_heads, tcfg.hd)
        assert got.data_ptr() == full.data_ptr()
        assert got.stride() == full.stride()


# ---------------------------------------------------------------------------
# the kernel's split arithmetic (3xTF32), emulated
# ---------------------------------------------------------------------------

FLASH_ATOL = 2e-5      # chip_smoke.py's tolerance for the float32 kernel


def _tf32_round(x):
    """The kernel's rounding to TF32: add half a TF32 ulp to the bits and
    clear the 13 low mantissa bits."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(
        np.float32)


def _split(x):
    hi = _tf32_round(x)
    return hi, _tf32_round(np.float32(x) - hi)


def _tc_product(pairs, a_rows, b_rows):
    """sum_k a[:, k] b[:, k] as the tensor core runs it: each TF32 product
    exact (float64), summed into a float32 accumulator, pass by pass."""
    acc = np.zeros((a_rows[0].shape[0], b_rows[0].shape[0]), np.float32)
    for ia, ib in pairs:
        a, b = a_rows[ia].astype(np.float64), b_rows[ib].astype(np.float64)
        for kk in range(a.shape[1]):
            acc = (acc + np.outer(a[:, kk], b[:, kk]).astype(np.float32)
                   ).astype(np.float32)
    return acc


def _emulated_attention(q, k, v, passes):
    """Causal attention with both products emulated: ``passes`` 3 is
    hi hi + hi lo + lo hi (small ones first), 2 drops hi lo (K and V
    exact in TF32), 1 is plain TF32 (hi hi)."""
    pairs = {3: [(0, 1), (1, 0), (0, 0)], 2: [(1, 0), (0, 0)],
             1: [(0, 0)]}[passes]
    d = q.shape[1]
    qs = (q * np.float32(d ** -0.5)).astype(np.float32)
    s = _tc_product(pairs, _split(qs), _split(k))
    s = np.where(np.tril(np.ones(s.shape, bool)), s, np.float32(-1e30))
    p = np.exp(s - s.max(axis=1, keepdims=True)).astype(np.float32)
    l = p.sum(axis=1, keepdims=True, dtype=np.float32)
    o = _tc_product(pairs, _split(p), _split(v.T))
    return o / l


@pytest.mark.parametrize('kv', ['float32', 'bfloat16'])
def test_three_tf32_passes_keep_flash_within_its_tolerance(kv):
    """At d = 128, S = T = 256, causal: the split products (three passes,
    two for a bf16 K/V) stay within FLASH_ATOL of float64 attention, and
    one plain TF32 pass does not, which is why the kernel compensates."""
    q, k, v = (_np((256, 128), 34 + i) for i in range(3))
    if kv == 'bfloat16':
        k, v = (torch.from_numpy(x).bfloat16().float().numpy() for x in (k, v))
        assert all((_split(x)[1] == 0).all() for x in (k, v))
    q64, k64, v64 = (x.astype(np.float64) for x in (q, k, v))
    s = (q64 * 128 ** -0.5) @ k64.T
    s = np.where(np.tril(np.ones(s.shape, bool)), s, -np.inf)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    want = (p / p.sum(axis=1, keepdims=True)) @ v64
    passes = 3 if kv == 'float32' else 2
    err = np.abs(_emulated_attention(q, k, v, passes) - want).max()
    assert err <= FLASH_ATOL / 4
    err1 = np.abs(_emulated_attention(q, k, v, 1) - want).max()
    assert err1 > FLASH_ATOL


def test_tf32_split_keeps_22_bits():
    """hi + lo is x to within 2^-22 of |x|, hi alone only to 2^-11, and
    hi and lo are TF32 values (13 low bits clear)."""
    x = _np((4096,), 37) * np.float32(1e3)
    x[:4] = [1.0, -0.0, 1.9999999, -3.0000002]
    hi, lo = _split(x)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1fff)).any()
    x64 = x.astype(np.float64)
    rel = np.abs(hi.astype(np.float64) + lo - x64) / np.maximum(
        np.abs(x64), 1e-30)
    assert rel.max() <= 2.0 ** -22
    assert (np.abs(hi - x64) / np.maximum(np.abs(x64), 1e-30)).max() \
        > 2.0 ** -14


# ---------------------------------------------------------------------------
# RoPE and the attention cores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('hd,theta', [(16, 1e4), (128, 1e4), (32, 1e5)])
def test_rope_matches_reference(hd, theta):
    x = _np((2, 9, 3, hd), 14)
    pos = np.stack([np.arange(9), np.arange(30, 39)]).astype(np.int32)
    want = JA.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TA.rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_apply_rope_none_passes_through_and_mrope_waits():
    """``rope='none'`` returns its input; under M-RoPE a 2-D ``pos`` is
    text, three equal streams, and M-RoPE is then RoPE."""
    x = torch.ones(1, 2, 1, 4)
    cfg = treg.smoke_config('whisper-base')          # rope = 'none'
    assert TA.apply_rope(cfg, x, torch.zeros(1, 2)) is x
    cfg = treg.smoke_config('qwen2-vl-7b')           # sections (2, 3, 3)
    x = _t(_np((2, 9, 3, cfg.hd), 13))
    pos = _t(np.stack([np.arange(9), np.arange(30, 39)]).astype(np.int32))
    got = TA.apply_rope(cfg, x, pos)
    np.testing.assert_allclose(got.numpy(),
                               TA.rope(x, pos, cfg.rope_theta).numpy(),
                               rtol=0, atol=0)


def _pos3(B, S, seed):
    """(B, S, 3) M-RoPE position ids whose t, h and w streams differ."""
    rng = np.random.default_rng(seed)
    t = np.arange(S)[None, :] + rng.integers(0, 40, (B, 1))
    return np.stack([t, rng.integers(0, 64, (B, S)),
                     rng.integers(0, 64, (B, S))], -1).astype(np.int32)


MROPE_CASES = [(16, 1e6, (2, 3, 3)), (128, 1e6, (16, 24, 24))]


@pytest.mark.parametrize('hd,theta,sections', MROPE_CASES)
def test_mrope_matches_reference(hd, theta, sections):
    x, pos3 = _np((2, 9, 3, hd), 40), _pos3(2, 9, 41)
    want = JA.mrope(jnp.asarray(x), jnp.asarray(pos3), theta, sections)
    got = TA.mrope(_t(x), _t(pos3), theta, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize('hd,theta,sections', MROPE_CASES)
def test_mrope_with_swapped_sections_misses_the_tolerance(hd, theta,
                                                          sections):
    """The tolerance above can see which stream rotates which channels:
    the sections in reverse order (the w stream first) miss it."""
    x, pos3 = _np((2, 9, 3, hd), 40), _pos3(2, 9, 41)
    want = np.asarray(JA.mrope(jnp.asarray(x), jnp.asarray(pos3), theta,
                               sections))
    got = TA.mrope(_t(x), _t(pos3), theta, sections[::-1]).numpy()
    assert np.abs(got - want).max() > 100 * 1e-5


def test_mrope_refuses_sections_that_miss_the_channels():
    with pytest.raises(ValueError, match='sections'):
        TA.mrope(torch.zeros(1, 2, 1, 16), torch.zeros(1, 2, 3), 1e4,
                 (2, 3, 4))


@pytest.mark.parametrize('S,T,causal,q_offset,kv_len', [
    (7, 7, True, 0, None),       # plain causal self-attention
    (5, 9, False, 0, None),      # cross-attention shape
    (7, 12, True, 0, 7),         # prefill into a longer cache
    (1, 12, True, 7, 8),         # one decode step
    (3, 12, True, 4, 7),         # several new rows against the cache
])
def test_gqa_core_matches_reference(S, T, causal, q_offset, kv_len):
    q, k, v = _np((2, S, 4, 16), 15), _np((2, T, 2, 16), 16), \
        _np((2, T, 2, 16), 17)
    want = JA.gqa_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, q_offset=q_offset, kv_len=kv_len)
    got = TA.gqa_core(_t(q), _t(k), _t(v), causal=causal, q_offset=q_offset,
                      kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_flash_core_equals_gqa_core_on_grouped_heads():
    q, k, v = _np((2, 11, 4, 16), 18), _np((2, 11, 2, 16), 19), \
        _np((2, 11, 2, 16), 20)
    a = TA.flash_core(_t(q), _t(k), _t(v), causal=True)
    b = TA.gqa_core(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


# ---------------------------------------------------------------------------
# the attention layer in its three modes
# ---------------------------------------------------------------------------

def _layer(arch, kv_repeat=1):
    import jax
    jcfg = jreg.smoke_config(arch).scaled(kv_repeat=kv_repeat)
    tcfg = treg.smoke_config(arch).scaled(kv_repeat=kv_repeat)
    jp = JA.init_attention(jax.random.PRNGKey(3), jcfg)
    if jcfg.attn_bias:       # the reference initialises biases to zero
        jp = {k: dict(w, b=jnp.asarray(_np(w['b'].shape, 21, 0.1)))
              for k, w in jp.items()}
    tp = load_jax_params(TA.Attention(tcfg), jax.tree_util.tree_map(
        np.asarray, jp))
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize('arch', ['internlm2-1.8b', 'starcoder2-7b'])
@pytest.mark.parametrize('impl', ['xla', 'pallas'])
def test_attention_without_cache_matches_reference(arch, impl):
    jcfg, tcfg, jp, tp = _layer(arch)
    x = _np((2, 10, jcfg.d_model), 22)
    want, _ = JA.attention(jp, jcfg, jnp.asarray(x), impl=impl)
    got, cache = TA.attention(tp, tcfg, _t(x), impl=impl)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize('arch,kv_repeat', [('internlm2-1.8b', 1),
                                            ('internlm2-1.8b', 2),
                                            ('starcoder2-7b', 1)])
def test_attention_prefill_and_decode_match_reference(arch, kv_repeat):
    jcfg, tcfg, jp, tp = _layer(arch, kv_repeat)
    S, steps, B = 9, 3, 2
    jc = JA.init_attention_cache(jcfg, B, S + steps, jnp.float32)
    tc = TA.init_attention_cache(tcfg, B, S + steps, torch.float32)
    x = _np((B, S, jcfg.d_model), 23)
    want, jc = JA.attention(jp, jcfg, jnp.asarray(x), cache=jc, cache_pos=0)
    got, tc = TA.attention(tp, tcfg, _t(x), cache=tc, cache_pos=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for i in range(steps):
        x1 = _np((B, 1, jcfg.d_model), 24 + i)
        want, jc = JA.attention(jp, jcfg, jnp.asarray(x1), cache=jc,
                                cache_pos=S + i)
        got, tc = TA.attention(tp, tcfg, _t(x1), cache=tc, cache_pos=S + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for name in ('k', 'v'):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-5)


@pytest.mark.parametrize('arch', ['whisper-base', 'qwen2-vl-7b'])
def test_cross_attention_matches_reference(arch):
    """``memory`` switches to cross-attention: K/V from the memory, not
    rotated (q is, under Qwen's M-RoPE), no mask, the cache passed
    through."""
    jcfg, tcfg, jp, tp = _layer(arch)
    x, mem = _np((2, 5, jcfg.d_model), 26), _np((2, 13, jcfg.d_model), 27)
    want, _ = JA.attention(jp, jcfg, jnp.asarray(x), memory=jnp.asarray(mem))
    cache = TA.init_attention_cache(tcfg, 2, 8, torch.float32)
    got, out_cache = TA.attention(tp, tcfg, _t(x), memory=_t(mem),
                                  cache=cache)
    assert out_cache is cache and not cache['k'].any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize('arch,streams', [('internlm2-1.8b', 1),
                                          ('qwen2-vl-7b', 1),
                                          ('qwen2-vl-7b', 3)])
def test_attention_with_explicit_pos_matches_reference(arch, streams):
    """An explicit ``pos`` (2-D, offset per row; or three distinct M-RoPE
    streams) without a cache and as a prefill into one."""
    jcfg, tcfg, jp, tp = _layer(arch)
    B, S = 2, 9
    pos = _pos3(B, S, 28)
    if streams == 1:
        pos = pos[..., 0]
    x = _np((B, S, jcfg.d_model), 29)
    want, _ = JA.attention(jp, jcfg, jnp.asarray(x), pos=jnp.asarray(pos))
    got, _ = TA.attention(tp, tcfg, _t(x), pos=_t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    jc = JA.init_attention_cache(jcfg, B, S + 2, jnp.float32)
    tc = TA.init_attention_cache(tcfg, B, S + 2, torch.float32)
    want, jc = JA.attention(jp, jcfg, jnp.asarray(x), pos=jnp.asarray(pos),
                            cache=jc, cache_pos=0)
    got, tc = TA.attention(tp, tcfg, _t(x), pos=_t(pos), cache=tc,
                           cache_pos=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(tc['k'].numpy(), np.asarray(jc['k']),
                               atol=1e-5)


def test_prefill_reads_the_cache_in_its_dtype():
    """Into a bf16 cache, the prefill's flash path is the reference's
    cache branch: gqa_core over the rounded cache rows."""
    _, tcfg, _, tp = _layer('internlm2-1.8b')
    B, S = 2, 9
    x = _t(_np((B, S, tcfg.d_model), 25))
    cache = TA.init_attention_cache(tcfg, B, S + 4, torch.bfloat16)
    got, cache = TA.attention(tp, tcfg, x, cache=cache, cache_pos=0)
    pos = torch.arange(S)[None].expand(B, S)
    q = TA.apply_rope(tcfg, tp.wq(x).reshape(B, S, tcfg.n_heads, tcfg.hd),
                      pos)
    out = TA.gqa_core(q, cache['k'], cache['v'], causal=True, kv_len=S)
    want = tp.wo(out.reshape(B, S, -1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    k_f32, _ = TA._project_kv(tp, tcfg, x, pos)
    assert torch.equal(cache['k'][:, :S], k_f32.bfloat16())


def test_attention_rejects_unknown_impl():
    _, tcfg, _, tp = _layer('internlm2-1.8b')
    with pytest.raises(ValueError, match='impl'):
        TA.attention(tp, tcfg, torch.zeros(1, 2, tcfg.d_model), impl='tpu')


# ---------------------------------------------------------------------------
# MLA: the decompressed path (no cache) and the absorbed one (cache)
# ---------------------------------------------------------------------------

def _mla_layer(quantize=()):
    """The smoke DeepSeek-V2-Lite MLA layer from the reference's params;
    the projections in ``quantize`` become serve-time QTensors in the
    reference tree, loaded as the port's QWeights."""
    import jax
    from repro.core.quantization import quantize_per_channel
    jcfg = jreg.smoke_config('deepseek-v2-lite-16b')
    tcfg = treg.smoke_config('deepseek-v2-lite-16b')
    jp = JA.init_mla(jax.random.PRNGKey(5), jcfg)
    for name in quantize:
        jp[name] = {'w': quantize_per_channel(jp[name]['w'])}
    tp = load_jax_params(TA.MLA(tcfg), jax.tree_util.tree_map(
        np.asarray, jp))
    return jcfg, tcfg, jp, tp


def test_mla_without_cache_matches_reference():
    jcfg, tcfg, jp, tp = _mla_layer()
    x = _np((2, 10, jcfg.d_model), 30)
    want, _ = JA.mla_attention(jp, jcfg, jnp.asarray(x))
    got, cache = TA.mla_attention(tp, tcfg, _t(x))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize('quantize', [(), ('w_uk', 'w_uv')])
def test_mla_prefill_and_decode_match_reference(quantize):
    """A prefill into the compressed cache (the reference takes the
    absorbed path there too, its ``cache_pos`` being 0), then decode
    steps; with serve-time quantized ``w_uk``/``w_uv`` the absorbed path
    dequantizes them (``_raw``)."""
    jcfg, tcfg, jp, tp = _mla_layer(quantize)
    S, steps, B = 9, 3, 2
    jc = JA.init_mla_cache(jcfg, B, S + steps, jnp.float32)
    tc = TA.init_mla_cache(tcfg, B, S + steps, torch.float32)
    x = _np((B, S, jcfg.d_model), 31)
    want, jc = JA.mla_attention(jp, jcfg, jnp.asarray(x), cache=jc,
                                cache_pos=jnp.int32(0))
    got, tc = TA.mla_attention(tp, tcfg, _t(x), cache=tc, cache_pos=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for i in range(steps):
        x1 = _np((B, 1, jcfg.d_model), 32 + i)
        want, jc = JA.mla_attention(jp, jcfg, jnp.asarray(x1), cache=jc,
                                    cache_pos=jnp.int32(S + i))
        got, tc = TA.mla_attention(tp, tcfg, _t(x1), cache=tc,
                                   cache_pos=S + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for name in ('c_kv', 'k_pe'):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-5)


def test_mla_with_explicit_pos_matches_reference():
    jcfg, tcfg, jp, tp = _mla_layer()
    x = _np((2, 10, jcfg.d_model), 36)
    pos = _pos3(2, 10, 37)[..., 0]
    want, _ = JA.mla_attention(jp, jcfg, jnp.asarray(x), pos=jnp.asarray(pos))
    got, _ = TA.mla_attention(tp, tcfg, _t(x), pos=_t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_mla_absorbed_path_equals_the_decompressed_one():
    """The two paths compute one function: a prefill through the cache
    equals the plain forward on the same input."""
    _, tcfg, _, tp = _mla_layer()
    x = _t(_np((2, 11, tcfg.d_model), 35))
    plain, _ = TA.mla_attention(tp, tcfg, x)
    cache = TA.init_mla_cache(tcfg, 2, 16, torch.float32)
    absorbed, _ = TA.mla_attention(tp, tcfg, x, cache=cache, cache_pos=0)
    np.testing.assert_allclose(absorbed.numpy(), plain.numpy(), atol=1e-5)
