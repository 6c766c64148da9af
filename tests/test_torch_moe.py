"""Port MoE vs the reference (``repro/models/moe.py``) on the same numpy
inputs and the same reference parameters: the dispatch indices integer
for integer (overflow included), the top-k order on ties, and
``moe_ffn`` at smoke width without shared experts (Granite-MoE), with
them (DeepSeek-V2-Lite), and at a capacity factor low enough that tokens
are dropped, where the port must drop the same ones.

Tolerances: float32 outputs 1e-5 (router softmax, expert products and
the combine summed in another order; each agrees to ~1e-7 relative);
under w8a8 the shared experts' MLP 1e-3, since a ~1e-7 difference in an
activation can move one int8 rounding at a tie, worth about one LSB."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import moe as JM
from repro_torch.bridge import load_jax_params
from repro_torch.configs import registry as treg
from repro_torch.models import moe as TM

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


def _cfgs(arch, capacity_factor=None):
    jcfg, tcfg = jreg.smoke_config(arch), treg.smoke_config(arch)
    if capacity_factor is not None:
        jcfg = jcfg.scaled(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        tcfg = tcfg.scaled(moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity_factor))
    return jcfg, tcfg


def _layer(jcfg, tcfg, seed=0):
    jp = JM.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp = load_jax_params(TM.MoE(tcfg), jax.tree_util.tree_map(np.asarray,
                                                              jp))
    return jp, tp


@pytest.mark.parametrize('T,k,E,C', [
    (37, 3, 5, 100),     # nothing dropped
    (37, 3, 5, 8),       # some experts overflow
    (64, 2, 4, 1),       # nearly everything dropped
    (16, 1, 16, 8),      # one token per expert on average
])
def test_dispatch_indices_match_reference(T, k, E, C):
    ids = np.random.default_rng(T * k + C).integers(0, E, (T, k))
    want = np.asarray(JM._dispatch_indices(jnp.asarray(ids), E, C))
    got = TM._dispatch_indices(torch.from_numpy(ids), E, C)
    np.testing.assert_array_equal(got.numpy(), want)
    dropped = int((want == E * C).sum())
    counts = np.bincount(ids.reshape(-1), minlength=E)
    assert dropped == int(np.maximum(counts - C, 0).sum())


def test_dispatch_indices_batched_over_groups():
    """The port dispatches the groups batched; each group equals the
    reference's (which runs under vmap)."""
    ids = np.random.default_rng(5).integers(0, 6, (3, 20, 2))
    want = np.asarray(jax.vmap(lambda e: JM._dispatch_indices(e, 6, 8))(
        jnp.asarray(ids)))
    got = TM._dispatch_indices(torch.from_numpy(ids), 6, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 48).any()


def test_top_k_puts_the_lower_index_first_on_ties():
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.1],
                      [0.25, 0.25, 0.25, 0.25, 0.0],
                      [0.0, 0.5, 0.0, 0.5, 0.0]], np.float32)
    want_p, want_e = jax.lax.top_k(jnp.asarray(probs), 3)
    got_p, got_e = TM._top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


@pytest.mark.parametrize('arch,capacity_factor,quant', [
    ('granite-moe-1b-a400m', None, False),
    ('deepseek-v2-lite-16b', None, False),
    ('granite-moe-1b-a400m', 0.25, False),
    ('deepseek-v2-lite-16b', 0.25, False),
    ('deepseek-v2-lite-16b', None, True),
])
def test_moe_ffn_matches_reference(arch, capacity_factor, quant):
    jcfg, tcfg = _cfgs(arch, capacity_factor)
    jp, tp = _layer(jcfg, tcfg)
    assert (tp.shared is None) == (jcfg.moe.n_shared == 0)
    x = _np((4, 32, jcfg.d_model), 1)
    want = JM.moe_ffn(jp, jcfg, jnp.asarray(x), quant=quant)
    got = TM.moe_ffn(tp, tcfg, torch.from_numpy(x), quant=quant)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=W8A8_ATOL if quant else ATOL)


@pytest.mark.parametrize('arch', ['granite-moe-1b-a400m',
                                  'deepseek-v2-lite-16b'])
def test_low_capacity_drops_the_same_tokens(arch):
    """At capacity factor 0.25 (C = 8 slots per expert against ~32
    assignments per expert and group), tokens are dropped, and the port
    drops exactly the reference's: the same slots, so the same tokens
    lose the same experts, and the same outputs."""
    jcfg, tcfg = _cfgs(arch, 0.25)
    jp, tp = _layer(jcfg, tcfg)
    m = jcfg.moe
    x = _np((4, 32, jcfg.d_model), 2)
    G = jcfg.moe_groups
    Tg = x.shape[0] * x.shape[1] // G
    C = -(-max(1, int(Tg * m.top_k * m.capacity_factor / m.n_experts))
          // 8) * 8
    xg = x.reshape(G, Tg, -1)
    jbuf, jslot, jtop = jax.vmap(lambda t: JM._dispatch(t, jp, m, C))(
        jnp.asarray(xg))
    tbuf, tslot, ttop = TM._dispatch(torch.from_numpy(xg), tp, m, C)
    jslot = np.asarray(jslot)
    dropped = jslot == m.n_experts * C
    assert dropped.sum() > 0.25 * dropped.size
    np.testing.assert_array_equal(tslot.numpy(), jslot)
    np.testing.assert_allclose(ttop.numpy(), np.asarray(jtop), atol=1e-6)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    # a dropped assignment contributes nothing to its token
    y = TM._combine(torch.ones_like(tbuf), tslot, torch.ones_like(ttop),
                    torch.float32)
    np.testing.assert_array_equal(
        y[..., 0].numpy(), (~dropped).sum(-1).astype(np.float32))


def test_expert_weights_are_not_copied_in_float32():
    _, tcfg = _cfgs('granite-moe-1b-a400m')
    tp = TM.MoE(tcfg)
    assert TM._wt(tp.w_gate, torch.float32) is tp.w_gate
    assert TM._wt(tp.w_gate, torch.bfloat16).dtype == torch.bfloat16
