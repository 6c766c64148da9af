"""Port LM vs the reference: the same reference parameters (loaded
through ``repro_torch.bridge.load_jax_lm_params``) and the same token ids
through ``lm_apply``, ``lm_prefill`` followed by ``lm_decode`` steps, and
``serve_lm``, for the smoke InternLM2 (RMSNorm, gated swish, GQA rep 2,
no biases), StarCoder2 (LayerNorm, biases, tanh-gelu, GQA rep 2),
Granite-MoE (MoE, top-2 of 4 experts, tied embeddings), DeepSeek-V2-Lite
(MLA + MoE with shared experts), Mamba2 (SSD), Jamba (one hybrid unit
of 8 sub-layers: Mamba and attention, dense and MoE FFNs) and Qwen2-VL
(M-RoPE with sections (2, 3, 3), biased GQA rep 2; also through
``lm_apply``'s ``inputs_embeds`` with three distinct position streams);
the config copies field for field; the loader on a hybrid tree; the SSM
constants.  The encoder-decoder family has its own file,
``test_torch_encdec.py``.

Tolerances: fp32 logits 1e-4, float32 matmuls and softmaxes summed in
another order over two layers (each layer agrees to ~1e-6); w8a8 1e-3,
because a ~1e-7 difference in an activation can move one int8 rounding
at a tie, worth about one LSB of the 8-bit datapath."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro_torch.bridge import load_jax_lm_params
from repro_torch.configs import registry as treg
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as TT
from repro_torch.models.ssm import ssm_constants as SSM_CONSTANTS

ARCHS = ['internlm2-1.8b', 'starcoder2-7b', 'granite-moe-1b-a400m',
         'deepseek-v2-lite-16b', 'mamba2-2.7b', 'jamba-1.5-large-398b',
         'qwen2-vl-7b']
NEW_ARCHS = ARCHS[2:]
FP32_ATOL = 1e-4
W8A8_ATOL = 1e-3


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch, seed=0):
    """The reference smoke LM from ``PRNGKey(seed)`` and the port LM
    holding the same parameters."""
    jcfg, tcfg = jreg.smoke_config(arch), treg.smoke_config(arch)
    jp = JT.init_lm(jax.random.PRNGKey(seed), jcfg)
    tp = load_jax_lm_params(TT.LM(tcfg, 'cpu'),
                            jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape
                                                ).astype(np.int32)


@pytest.mark.parametrize('arch', sorted(jreg.ARCHS))
def test_config_copies_match_reference(arch):
    assert dataclasses.asdict(treg.get(arch)) == \
        dataclasses.asdict(jreg.get(arch))
    assert dataclasses.asdict(treg.smoke_config(arch)) == \
        dataclasses.asdict(jreg.smoke_config(arch))


@pytest.mark.parametrize('arch,quant', [('internlm2-1.8b', False),
                                        ('starcoder2-7b', False),
                                        ('internlm2-1.8b', True)]
                         + [(a, q) for a in NEW_ARCHS for q in (False, True)])
def test_lm_apply_matches_reference(arch, quant):
    jcfg, tcfg, jp, tp = _models(arch)
    tok = _tokens(jcfg, (2, 12), 1)
    want = JT.lm_apply(jp, jcfg, jnp.asarray(tok), quant=quant)
    got = TT.lm_apply(tp, tcfg, torch.from_numpy(tok), quant=quant)
    assert got.shape == (2, 12, jcfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=W8A8_ATOL if quant else FP32_ATOL)


def test_tied_readout_matches_reference():
    """A dense LM with tied embeddings reads out through the table."""
    jcfg = jreg.smoke_config('internlm2-1.8b').scaled(tie_embeddings=True)
    tcfg = treg.smoke_config('internlm2-1.8b').scaled(tie_embeddings=True)
    jp = JT.init_lm(jax.random.PRNGKey(1), jcfg)
    tp = load_jax_lm_params(TT.LM(tcfg), jax.tree_util.tree_map(np.asarray,
                                                                jp))
    assert tp.lm_head is None
    tok = _tokens(jcfg, (2, 7), 5)
    want = JT.lm_apply(jp, jcfg, jnp.asarray(tok))
    got = TT.lm_apply(tp, tcfg, torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FP32_ATOL)


@pytest.mark.parametrize('arch', ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """A prefill then 4 decode steps, each fed the reference's greedy
    token, against the reference step for step: logits and every cache
    tensor of every unit (GQA k/v, MLA c_kv/k_pe, Mamba conv/state)."""
    jcfg, tcfg, jp, tp = _models(arch)
    B, S, steps = 2, 10, 4
    jc = JT.init_lm_cache(jcfg, B, S + steps, jnp.float32)
    tc = TT.init_lm_cache(tcfg, B, S + steps, torch.float32)
    tok = _tokens(jcfg, (B, S), 2)
    want, jc = JT.lm_prefill(jp, jcfg, jnp.asarray(tok), jc,
                             dtype=jnp.float32)
    got, tc = TT.lm_prefill(tp, tcfg, torch.from_numpy(tok), tc,
                            dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FP32_ATOL)
    for i in range(steps):
        nxt = np.asarray(jnp.argmax(want, axis=-1)).astype(np.int32)
        want, jc = JT.lm_decode(jp, jcfg, jnp.asarray(nxt), jc,
                                jnp.int32(S + i), dtype=jnp.float32)
        got, tc = TT.lm_decode(tp, tcfg, torch.from_numpy(nxt), tc, S + i,
                               dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=FP32_ATOL)
    assert len(tc) == JT.n_scan_steps(jcfg)
    for unit, blk in enumerate(tc):
        assert blk.keys() == jc.keys()
        for sub, names in blk.items():
            assert names.keys() == jc[sub].keys()
            for name, got_c in names.items():
                want_c = np.asarray(jc[sub][name][unit])
                assert got_c.dtype == torch.float32
                np.testing.assert_allclose(got_c.numpy(), want_c, atol=1e-5)


@pytest.mark.parametrize('arch,quant', [('internlm2-1.8b', False),
                                        ('starcoder2-7b', False),
                                        ('internlm2-1.8b', True)]
                         + [(a, q) for a in NEW_ARCHS for q in (False, True)])
def test_serve_lm_tokens_match_reference(arch, quant):
    """The reference's own ``serve_lm`` (its parameters from
    ``PRNGKey(0)``) and the port's with those parameters loaded give the
    same greedy tokens.  The reference runs under a null context in place
    of its 1x1 mesh, whose context fails under the installed jax (ROADMAP
    Queue 3)."""
    jcfg, tcfg, _, tp = _models(arch)
    want = jserve.serve_lm(jcfg, contextlib.nullcontext(), 2, 8, 5,
                           quant=quant)
    got, timing = tserve.serve_lm(tcfg, 2, 8, 5, quant=quant, device='cpu',
                                  params=tp)
    assert got.dtype == torch.int32 and got.shape == (2, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert timing['prefill_s'] > 0 and timing['decode_tok_s'] > 0


def test_serve_lm_default_params_come_from_seed_0():
    cfg = treg.smoke_config('internlm2-1.8b')
    a, _ = tserve.serve_lm(cfg, 1, 6, 3, device='cpu')
    lm = tsteps.init_params(torch.Generator().manual_seed(0), cfg, 'cpu')
    b, _ = tserve.serve_lm(cfg, 1, 6, 3, device='cpu', params=lm)
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab


def test_init_follows_reference_distributions():
    cfg = treg.smoke_config('starcoder2-7b').scaled(d_model=256, d_ff=512)
    lm = TT.init_lm(torch.Generator().manual_seed(1), cfg)
    assert abs(float(lm.embed.table.std()) - 0.02) < 1e-3
    assert abs(float(lm.lm_head.w.std()) - 0.02) < 1e-3
    sub = lm.blocks[1].sub0
    bound = 256 ** -0.5
    assert float(sub.attn.wq.w.abs().max()) <= bound
    assert float(sub.attn.wq.w.abs().max()) > 0.9 * bound
    assert float(sub.mlp.down.w.abs().max()) <= 512 ** -0.5
    assert torch.all(sub.attn.wq.b == 0) and torch.all(sub.mlp.up.b == 0)
    assert torch.all(sub.mix_norm.scale == 1)
    assert torch.all(sub.mix_norm.bias == 0)


@pytest.mark.parametrize('quant', [False, True])
def test_lm_apply_with_inputs_embeds_and_mrope_streams(quant):
    """The VLM's frontend stub: ``inputs_embeds`` in place of the token
    lookup and (B, S, 3) M-RoPE positions whose t, h and w streams
    differ, against the reference's ``lm_apply`` with the same."""
    jcfg, tcfg, jp, tp = _models('qwen2-vl-7b')
    rng = np.random.default_rng(7)
    B, S = 2, 11
    embeds = (rng.normal(size=(B, S, jcfg.d_model)) * 0.5).astype(np.float32)
    t = np.arange(S)[None, :] + rng.integers(0, 30, (B, 1))
    pos3 = np.stack([t, rng.integers(0, 20, (B, S)),
                     rng.integers(0, 20, (B, S))], -1).astype(np.int32)
    want = JT.lm_apply(jp, jcfg, None, pos=jnp.asarray(pos3),
                       inputs_embeds=jnp.asarray(embeds), quant=quant)
    got = TT.lm_apply(tp, tcfg, None, pos=torch.from_numpy(pos3),
                      inputs_embeds=torch.from_numpy(embeds), quant=quant)
    tol = W8A8_ATOL if quant else FP32_ATOL
    assert got.shape == (B, S, jcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)
    # the tolerance sees the streams: text positions (the t stream alone)
    # move the logits beyond it
    text = TT.lm_apply(tp, tcfg, None, pos=torch.from_numpy(pos3[..., 0]),
                       inputs_embeds=torch.from_numpy(embeds), quant=quant)
    assert (text - got).abs().max() > 2 * tol


def test_serve_main_serves_the_vlm_on_cpu(capsys):
    tserve.main(['--arch', 'qwen2-vl-7b', '--preset', 'smoke', '--device',
                 'cpu', '--prompt', '5', '--tokens', '3', '--w8a8'])
    out = capsys.readouterr().out
    assert '[serve] prefill 5 toks x2' in out and 'sample token ids' in out


def test_lm_loader_is_strict():
    jcfg, tcfg, jp, _ = _models('internlm2-1.8b')
    tree = jax.tree_util.tree_map(np.asarray, jp)
    with pytest.raises(ValueError, match='layers'):
        load_jax_lm_params(TT.LM(tcfg.scaled(n_layers=3)), tree)
    del tree['final_norm']
    with pytest.raises(RuntimeError, match='final_norm'):
        load_jax_lm_params(TT.LM(tcfg), tree)


def test_lm_loader_on_a_hybrid_tree():
    """Jamba with two hybrid units: the leading axis of the reference's
    tree is the 2 units, not the 16 layers; each unit's 8 sub-layers load
    under ``blocks.{i}.sub{j}``, the 3-D expert weights and the 2-D conv
    kernels unchanged; a module of another unit count is refused; and the
    loaded LM computes the reference's logits."""
    jcfg = jreg.smoke_config('jamba-1.5-large-398b').scaled(n_layers=16)
    tcfg = treg.smoke_config('jamba-1.5-large-398b').scaled(n_layers=16)
    jp = JT.init_lm(jax.random.PRNGKey(4), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = load_jax_lm_params(TT.LM(tcfg), tree)
    assert len(tp.blocks) == JT.n_scan_steps(jcfg) == 2
    assert len(list(tp.blocks[0].children())) == 8
    for unit in range(2):
        moe = tp.blocks[unit].sub1.moe
        assert moe.w_gate.shape == (4, 64, 32)
        assert np.array_equal(moe.w_gate.numpy(),
                              tree['blocks']['sub1']['moe']['w_gate'][unit])
        assert np.array_equal(moe.w_down.numpy(),
                              tree['blocks']['sub1']['moe']['w_down'][unit])
        assert np.array_equal(
            tp.blocks[unit].sub0.mamba.conv_w.numpy(),
            tree['blocks']['sub0']['mamba']['conv_w'][unit])
        assert np.array_equal(tp.blocks[unit].sub3.attn.wq.w.numpy(),
                              tree['blocks']['sub3']['attn']['wq']['w'][unit])
    with pytest.raises(ValueError, match='scanned units'):
        load_jax_lm_params(TT.LM(tcfg.scaled(n_layers=8)), tree)
    tok = _tokens(jcfg, (2, 9), 6)
    want = JT.lm_apply(jp, jcfg, jnp.asarray(tok))
    got = TT.lm_apply(tp, tcfg, torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=FP32_ATOL)


@pytest.mark.parametrize('heads', [16, 80, 256])
def test_ssm_constants_match_reference(heads):
    """The deterministic Mamba parameters at the smoke, Mamba2-2.7B and
    Jamba head counts.  ``conv_b`` (zero) and ``D`` (one) equal the
    reference's bit for bit.  ``A_log`` and ``dt_bias`` are the float64
    values rounded once to float32; the reference's are XLA's float32
    linspace, log and expm1 on the CPU, which are not correctly rounded,
    so bit equality cannot be had: they differ by at most 4.8e-7
    (measured for every H from 2 to 299), against entries of order 1."""
    from repro.configs.base import SSMConfig as JSSMConfig
    from repro.models import ssm as JS
    from repro_torch.configs.base import SSMConfig
    # d_inner = 2 d_model heads of width 1: H heads at a tiny size
    dims = dict(d_state=4, headdim=1, expand=2, n_groups=1, d_conv=4,
                chunk=16)
    jcfg = jreg.smoke_config('mamba2-2.7b').scaled(
        d_model=heads // 2, ssm=JSSMConfig(**dims))
    tcfg = treg.smoke_config('mamba2-2.7b').scaled(
        d_model=heads // 2, ssm=SSMConfig(**dims))
    want = jax.tree_util.tree_map(
        np.asarray, JS.init_mamba(jax.random.PRNGKey(0), jcfg))
    lm = TT.init_lm(torch.Generator().manual_seed(0), tcfg)
    got = lm.blocks[0].sub0.mamba
    assert got.A_log.shape == (heads,)
    assert np.array_equal(got.conv_b.numpy(), want['conv_b'])
    assert np.array_equal(got.D.numpy(), want['D'])
    for name in ('A_log', 'dt_bias'):
        np.testing.assert_allclose(getattr(got, name).numpy(), want[name],
                                   rtol=0, atol=4.8e-7)
    # the same bits on every device: what the port sets is its constants
    for name, value in SSM_CONSTANTS(heads).items():
        assert np.array_equal(getattr(got, name).numpy(), value)


def test_init_follows_reference_distributions_moe_and_ssm():
    """Expert weights and the Mamba convolution draw normal with stddev
    0.02, as the reference's ``normal_init``; the router too; the shared
    experts' MLP fan-in uniform."""
    cfg = treg.smoke_config('deepseek-v2-lite-16b').scaled(d_model=256)
    moe = TT.init_lm(torch.Generator().manual_seed(2), cfg).blocks[0].sub0.moe
    for w in (moe.w_gate, moe.w_up, moe.w_down, moe.router.w):
        assert abs(float(w.std()) - 0.02) < 2e-3 and abs(float(w.mean())) \
            < 2e-3
    assert float(moe.shared.up.w.abs().max()) <= 256 ** -0.5
    cfg = treg.smoke_config('mamba2-2.7b').scaled(d_model=256)
    mb = TT.init_lm(torch.Generator().manual_seed(3), cfg).blocks[0].sub0.mamba
    assert abs(float(mb.conv_w.std()) - 0.02) < 2e-3
    assert torch.all(mb.conv_b == 0) and torch.all(mb.D == 1)
    assert float(mb.in_xbc.w.abs().max()) <= 256 ** -0.5


def test_serve_main_runs_on_cpu_and_refuses_diffusion(capsys, tmp_path):
    """Both branches of ``main`` serve on the CPU, the diffusion branch
    sharded too (the reference's mesh flags, served since ROADMAP item
    6b's serving half), and with the reference's compile-cache flags
    (the port's cache of kernel libraries)."""
    tserve.main(['--arch', 'internlm2-1.8b', '--preset', 'smoke',
                 '--device', 'cpu', '--prompt', '5', '--tokens', '3'])
    out = capsys.readouterr().out
    assert '[serve] prefill 5 toks x2' in out and 'sample token ids' in out
    tserve.main(['--diffusion', '--device', 'cpu', '--requests', '2',
                 '--rate', '50', '--slots', '2', '--steps', '2'])
    out = capsys.readouterr().out
    assert '[serve] 2 done in' in out and '[frontier] fp32:' in out
    tserve.main(['--diffusion', '--device', 'cpu', '--requests', '2',
                 '--rate', '50', '--steps', '2', '--devices', '2',
                 '--resize-to', '1', '--resize-after', '1'])
    out = capsys.readouterr().out
    assert '[mesh] slot axis sharded over 2 devices' in out
    assert '[elastic] 1 done -> resizing 2 -> 1 devices' in out
    assert '[serve] 2 done in' in out
    from repro_torch.serving import disable_persistent_cache
    try:
        tserve.main(['--diffusion', '--device', 'cpu', '--requests', '2',
                     '--rate', '50', '--slots', '2', '--steps', '2',
                     '--cache-dir', str(tmp_path), '--cache-max-mb', '2'])
    finally:
        disable_persistent_cache()
    out = capsys.readouterr().out
    assert '[coldstart] warmup' in out and '[serve] 2 done in' in out


def test_serve_main_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip('checks the refusal where there is no GPU')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        tserve.main(['--arch', 'internlm2-1.8b', '--preset', 'smoke'])
