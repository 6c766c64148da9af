"""Port Mamba2 mixer vs the reference (``repro/models/ssm.py``) on the
same numpy inputs and the same reference parameters: the causal
convolution with and without its state, the chunked SSD with S not a
multiple of the chunk and with an initial state, and the layer as a
prefill into a cache followed by decode steps (the recurrence), and
without a cache; the cache stays float32.

Tolerance 1e-5: float32 products and cumulative sums in another order
(the reference contracts three operands at once, the port in two
pairwise steps); each agrees to ~1e-7 relative.  Under w8a8 1e-3, as
the other W8A8 parity tests: a ~1e-7 difference in an activation can
move one int8 rounding at a tie."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import ssm as JS
from repro_torch.bridge import load_jax_params
from repro_torch.configs import registry as treg
from repro_torch.models import ssm as TS

ATOL = 1e-5
W8A8_ATOL = 1e-3


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


@pytest.mark.parametrize('with_state', [False, True])
@pytest.mark.parametrize('S', [1, 7])
def test_causal_conv_matches_reference(with_state, S):
    x, w, b = _np((2, S, 12), 1), _np((4, 12), 2, 0.3), _np((12,), 3)
    state = _np((2, 3, 12), 4) if with_state else None
    want, want_s = JS._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if state is None else jnp.asarray(state))
    got, got_s = TS._causal_conv(_t(x), _t(w), _t(b),
                                 None if state is None else _t(state))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=0)


@pytest.mark.parametrize('S,chunk,with_state', [
    (37, 16, False),     # 37 pads to 48: three chunks, the last ragged
    (37, 16, True),
    (16, 16, True),      # one full chunk
    (5, 16, False),      # shorter than a chunk: Q = S
])
def test_ssd_chunked_matches_reference(S, chunk, with_state):
    B, H, P, G, N = 2, 4, 3, 2, 5
    x = _np((B, S, H, P), 5)
    dt = np.log1p(np.exp(_np((B, S, H), 6)))            # softplus > 0
    A = -np.exp(_np((H,), 7, 0.5))
    Bm, Cm = _np((B, S, G, N), 8), _np((B, S, G, N), 9)
    init = _np((B, H, P, N), 10) if with_state else None
    want, want_s = JS._ssd_chunked(
        *(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk,
        None if init is None else jnp.asarray(init))
    got, got_s = TS._ssd_chunked(*(_t(a) for a in (x, dt, A, Bm, Cm)),
                                 chunk, None if init is None else _t(init))
    assert got.shape == (B, S, H, P) and got_s.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=ATOL)


def _layer(arch='mamba2-2.7b', seed=0):
    jcfg, tcfg = jreg.smoke_config(arch), treg.smoke_config(arch)
    jp = JS.init_mamba(jax.random.PRNGKey(seed), jcfg)
    tp = load_jax_params(TS.Mamba(tcfg), jax.tree_util.tree_map(np.asarray,
                                                                jp))
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize('arch', ['mamba2-2.7b', 'jamba-1.5-large-398b'])
def test_mamba_without_cache_matches_reference(arch):
    """Mamba2's smoke mixer has one B/C group, Jamba's two."""
    jcfg, tcfg, jp, tp = _layer(arch)
    x = _np((2, 21, jcfg.d_model), 11)
    want, _ = JS.mamba(jp, jcfg, jnp.asarray(x))
    got, cache = TS.mamba(tp, tcfg, _t(x))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize('arch,quant', [('mamba2-2.7b', False),
                                        ('jamba-1.5-large-398b', False),
                                        ('mamba2-2.7b', True)])
def test_mamba_prefill_and_decode_match_reference(arch, quant):
    """A 21-token prefill (two chunks of 16, the second ragged) into a
    cache, then 4 decode steps through the recurrence: outputs and the
    float32 cache step for step."""
    jcfg, tcfg, jp, tp = _layer(arch)
    B, S, steps = 2, 21, 4
    jc = JS.init_mamba_cache(jcfg, B)
    tc = TS.init_mamba_cache(tcfg, B)
    tol = W8A8_ATOL if quant else ATOL
    for i in range(steps + 1):
        x = _np((B, S if i == 0 else 1, jcfg.d_model), 12 + i)
        want, jc = JS.mamba(jp, jcfg, jnp.asarray(x), cache=jc, quant=quant)
        got, tc = TS.mamba(tp, tcfg, _t(x), cache=tc, quant=quant)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)
        for name in ('conv', 'state'):
            assert tc[name].dtype == torch.float32
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), atol=tol)


def test_mamba_cache_is_float32_whatever_the_activations():
    """bf16 activations write a float32 cache, as the reference's."""
    _, tcfg, _, tp = _layer()
    cache = TS.init_mamba_cache(tcfg, 1)
    x = _t(_np((1, 5, tcfg.d_model), 20)).bfloat16()
    out, cache = TS.mamba(tp, tcfg, x, cache=cache)
    assert out.dtype == torch.bfloat16
    assert cache['state'].dtype == cache['conv'].dtype == torch.float32
    assert float(cache['state'].abs().max()) > 0
