"""Port encoder-decoder (Whisper-base at smoke width: 2 encoder and 2
decoder layers, d_model 64) vs the reference: the same reference
parameters (loaded through ``repro_torch.bridge.load_jax_encdec_params``)
and the same numpy inputs through ``_sinusoid``, ``encode``,
``decode_train``, ``encdec_prefill`` followed by ``encdec_decode`` steps,
and ``serve_lm``; the loader's strictness; the serving CLI.

Tolerances: the sinusoid table 1.2e-7, one float32 ulp at 1 (XLA's and
torch's CPU ``pow``/``sin``/``cos`` are not correctly rounded alike, and
the positions here stay below 300); memory and logits 1e-4, float32
matmuls and softmaxes summed in another order over a few layers (each
layer agrees to ~1e-6); caches 1e-5, one projection of those
activations."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import serve as jserve
from repro.models import encdec as JE
from repro_torch.bridge import load_jax_encdec_params
from repro_torch.configs import registry as treg
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import encdec as TE

ARCH = 'whisper-base'
FP32_ATOL = 1e-4
CACHE_ATOL = 1e-5
SINUSOID_ATOL = 1.2e-7


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(seed=0):
    """The reference smoke Whisper from ``PRNGKey(seed)`` and the port's
    holding the same parameters."""
    jcfg, tcfg = jreg.smoke_config(ARCH), treg.smoke_config(ARCH)
    jp = JE.init_encdec(jax.random.PRNGKey(seed), jcfg)
    tp = load_jax_encdec_params(TE.EncDec(tcfg, 'cpu'),
                                jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _inputs(cfg, B, T_enc, S, seed):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, T_enc, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return frames, tokens


@pytest.mark.parametrize('T,d,start', [(20, 64, 0), (300, 512, 0),
                                       (7, 16, 0), (1, 64, 13)])
def test_sinusoid_matches_reference(T, d, start):
    want = np.asarray(JE._sinusoid(start + T, d))[start:]
    got = TE._sinusoid(T, d, start=start)
    assert got.dtype == torch.float32 and got.shape == (T, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=SINUSOID_ATOL)


def test_encode_and_decode_train_match_reference():
    jcfg, tcfg, jp, tp = _models()
    frames, tokens = _inputs(jcfg, 2, 11, 7, 1)
    want = JE.encode(jp, jcfg, jnp.asarray(frames))
    got = TE.encode(tp, tcfg, torch.from_numpy(frames))
    assert got.shape == (2, 11, jcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FP32_ATOL)
    want = JE.decode_train(jp, jcfg, jnp.asarray(frames),
                           jnp.asarray(tokens))
    got = TE.decode_train(tp, tcfg, torch.from_numpy(frames),
                          torch.from_numpy(tokens))
    assert got.shape == (2, 7, jcfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FP32_ATOL)


def test_prefill_and_decode_match_reference():
    """A prefill then 4 decode steps, each fed the reference's greedy
    token: logits step by step, the memory, and every decoder layer's
    k/v cache; and the prefill's last logits equal ``decode_train``'s at
    the last position."""
    jcfg, tcfg, jp, tp = _models()
    B, S, steps = 2, 9, 4
    frames, tokens = _inputs(jcfg, B, 12, S, 2)
    jc = JE.init_dec_cache(jcfg, B, S + steps, jnp.float32)
    tc = TE.init_dec_cache(tcfg, B, S + steps, torch.float32)
    want, jc, jmem = JE.encdec_prefill(jp, jcfg, jnp.asarray(frames),
                                       jnp.asarray(tokens), jc,
                                       dtype=jnp.float32)
    got, tc, tmem = TE.encdec_prefill(tp, tcfg, torch.from_numpy(frames),
                                      torch.from_numpy(tokens), tc,
                                      dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FP32_ATOL)
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem),
                               atol=CACHE_ATOL)
    full = TE.decode_train(tp, tcfg, torch.from_numpy(frames),
                           torch.from_numpy(tokens))
    np.testing.assert_allclose(got[:, 0].numpy(), full[:, -1].numpy(),
                               atol=FP32_ATOL)
    for i in range(steps):
        nxt = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)
        want, jc = JE.encdec_decode(jp, jcfg, jnp.asarray(nxt), jc,
                                    jnp.int32(S + i), jmem,
                                    dtype=jnp.float32)
        got, tc = TE.encdec_decode(tp, tcfg, torch.from_numpy(nxt), tc,
                                   S + i, tmem, dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=FP32_ATOL)
    assert len(tc) == jcfg.n_layers
    for layer, cache in enumerate(tc):
        assert cache.keys() == jc.keys()
        for name, got_c in cache.items():
            assert got_c.dtype == torch.float32
            np.testing.assert_allclose(got_c.numpy(),
                                       np.asarray(jc[name][layer]),
                                       atol=CACHE_ATOL)


@pytest.mark.parametrize('quant', [False, True])
def test_serve_lm_tokens_match_reference(quant):
    """The reference's ``serve_lm`` (parameters from ``PRNGKey(0)``, the
    frames drawn after the tokens) and the port's with those parameters
    give the same greedy tokens; both ignore ``quant`` for the
    encoder-decoder, so the port's tokens are the same at either."""
    jcfg, tcfg, _, tp = _models()
    want = jserve.serve_lm(jcfg, contextlib.nullcontext(), 2, 8, 5,
                           quant=quant)
    got, timing = tserve.serve_lm(tcfg, 2, 8, 5, quant=quant, device='cpu',
                                  params=tp)
    assert got.dtype == torch.int32 and got.shape == (2, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    other, _ = tserve.serve_lm(tcfg, 2, 8, 5, quant=not quant,
                               device='cpu', params=tp)
    assert torch.equal(got, other)
    assert timing['prefill_s'] > 0 and timing['decode_tok_s'] > 0


def test_serve_state_holds_the_memory():
    cfg = treg.smoke_config(ARCH)
    state = tsteps.init_serve_state(cfg, 2, 13, torch.float32, 'cpu')
    assert state['memory'].shape == (2, 13, cfg.d_model)
    assert len(state['cache']) == cfg.n_layers
    assert state['cache'][0]['k'].shape == (2, 13, cfg.n_kv_heads, cfg.hd)
    model = tsteps.init_params(torch.Generator().manual_seed(0), cfg, 'cpu')
    assert isinstance(model, TE.EncDec)
    assert len(model.enc_blocks) == cfg.n_enc_layers
    assert len(model.dec_blocks) == cfg.n_layers


def test_encdec_loader_is_strict():
    jcfg, tcfg, jp, _ = _models()
    tree = jax.tree_util.tree_map(np.asarray, jp)
    with pytest.raises(ValueError, match='dec_blocks'):
        load_jax_encdec_params(TE.EncDec(tcfg.scaled(n_layers=3)), tree)
    with pytest.raises(ValueError, match='enc_blocks'):
        load_jax_encdec_params(TE.EncDec(tcfg.scaled(n_enc_layers=3)), tree)
    del tree['dec_norm']
    with pytest.raises(RuntimeError, match='dec_norm'):
        load_jax_encdec_params(TE.EncDec(tcfg), tree)


def test_init_follows_reference_distributions():
    cfg = treg.smoke_config(ARCH).scaled(d_model=256, d_ff=512)
    m = TE.init_encdec(torch.Generator().manual_seed(1), cfg)
    assert abs(float(m.embed.table.std()) - 0.02) < 1e-3
    blk = m.dec_blocks[1]
    assert float(blk.xattn.wk.w.abs().max()) <= 256 ** -0.5
    assert float(blk.mlp.down.w.abs().max()) <= 512 ** -0.5
    assert blk.mlp.gate is None
    assert torch.all(blk.xattn.wq.b == 0) and torch.all(blk.mlp.up.b == 0)
    assert torch.all(blk.xattn_norm.scale == 1)
    assert torch.all(m.enc_blocks[0].attn_norm.bias == 0)


def test_serve_main_serves_whisper_on_cpu(capsys):
    tserve.main(['--arch', ARCH, '--preset', 'smoke', '--device', 'cpu',
                 '--prompt', '6', '--tokens', '3', '--w8a8'])
    out = capsys.readouterr().out
    assert '[serve] prefill 6 toks x2' in out and 'sample token ids' in out
