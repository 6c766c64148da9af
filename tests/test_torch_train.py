"""The port's training path against the reference: the same reference
parameters (loaded through ``repro_torch.bridge``) and the same numpy
batches through the losses (``lm_loss`` with a padded vocabulary and
labels of -1, ``encdec_loss``, ``router_aux_loss``), one train step of
every registry family's smoke config (loss, grad norm, every gradient,
the updated moments, read back through ``bridge.load_jax_adamw_state``),
``adamw_update`` on identical gradients and state, ``lr_schedule``,
gradient accumulation, ``token_batch``, and ``Trainer.run``'s losses
against a loop of the reference's jitted train step.  Remat
(``'full'``, ``'dots'``) against ``'none'`` is held within the port.

Tolerances: losses and grad norms 1e-5 relative, gradients 1e-5 of the
largest (float32 matmuls and softmaxes summed in another order over a
few layers; measured up to 1.6e-6, Jamba's); moments 2e-5 of their
largest (they carry the gradients' relative error, doubled in ``v`` by
the square; measured up to 2.1e-6); ``adamw_update`` on identical
inputs 1e-6 (the same elementwise float32 formula; the moments in
bfloat16 equal bit for bit); a multi-step run by loss only, 1e-5
relative (measured 9e-8 over 4 steps): Adam's first step turns a
gradient ~1e-9 from zero into +-lr, whose sign the two packages' ~1e-9
apart gradients may disagree on, so the parameters are not compared
after a step (the reference's own runs on two machines would differ
the same way)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as jreg
from repro.data import pipeline as JD
from repro.launch import steps as JS
from repro.models import encdec as JE
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.optim import accumulation as JACC
from repro.optim import adamw as JA
from repro_torch import bridge
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as TD
from repro_torch.launch import steps as TS
from repro_torch.launch.train import Trainer
from repro_torch.models import encdec as TE
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.optim import accumulation as TACC
from repro_torch.optim import adamw as TA

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5        # of the largest gradient of the model
MOMENT_RTOL = 2e-5      # of the largest moment of the model
UPDATE_ATOL = 1e-6
RUN_RTOL = 1e-5
REAL_VOCAB = 200        # the smoke vocabulary is 211: 11 padded rows


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """Tiny tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(arch, seed=0, **scaled):
    """The reference smoke model from ``PRNGKey(seed)`` and the port's
    holding the same parameters."""
    jcfg = jreg.smoke_config(arch).scaled(**scaled)
    tcfg = treg.smoke_config(arch).scaled(**scaled)
    jp = JS.init_params(jax.random.PRNGKey(seed), jcfg)
    if jcfg.family == 'encdec':
        tp = bridge.load_jax_encdec_params(TE.EncDec(tcfg, 'cpu'), _np(jp))
    else:
        tp = bridge.load_jax_lm_params(TT.LM(tcfg, 'cpu'), _np(jp))
    return jcfg, tcfg, jp, tp


def _batch(cfg, B=2, S=16, seed=0):
    """Tokens, labels in [-1, REAL_VOCAB) (-1 ignored) and, for the
    encoder-decoder, frames; numpy."""
    rng = np.random.default_rng(seed)
    b = {'tokens': rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         'labels': rng.integers(-1, REAL_VOCAB, (B, S)).astype(np.int32)}
    if cfg.family == 'encdec':
        b['frames'] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    return b


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _flat_grads(tp, jgrads):
    """The reference's gradient tree as the port's list, through the
    moment loader (gradients have the parameters' tree)."""
    z = jax.tree_util.tree_map(np.zeros_like, jgrads)
    return bridge.load_jax_adamw_state(
        tp, JA.AdamWState(np.int32(0), jgrads, z)).m


def _assert_lists_close(got, want, rtol, what):
    scale = max(w.abs().max().item() for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, i)
        err = (g - w).abs().max().item()
        assert err <= rtol * scale, f'{what} {i}: {err} > {rtol} * {scale}'


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('real_vocab', [None, REAL_VOCAB])
def test_lm_loss_matches_reference(real_vocab):
    jcfg, tcfg, jp, tp = _models('internlm2-1.8b')
    b = _batch(jcfg, B=3, S=9, seed=1)
    b['labels'][0, :4] = -1
    b['labels'][1, 2] = REAL_VOCAB + 5      # a padded row as the gold one
    want = JT.lm_loss(jp, jcfg, jnp.asarray(b['tokens']),
                      jnp.asarray(b['labels']), real_vocab=real_vocab)
    got = TT.lm_loss(tp, tcfg, torch.from_numpy(b['tokens']),
                     torch.from_numpy(b['labels']), real_vocab=real_vocab)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)


def test_lm_loss_with_every_label_ignored_is_zero():
    jcfg, tcfg, jp, tp = _models('internlm2-1.8b')
    tok = np.zeros((2, 5), np.int32)
    lab = -np.ones((2, 5), np.int32)
    want = JT.lm_loss(jp, jcfg, jnp.asarray(tok), jnp.asarray(lab))
    got = TT.lm_loss(tp, tcfg, torch.from_numpy(tok), torch.from_numpy(lab))
    assert float(want) == got.item() == 0.0


@pytest.mark.parametrize('real_vocab', [None, REAL_VOCAB])
def test_encdec_loss_matches_reference(real_vocab):
    jcfg, tcfg, jp, tp = _models('whisper-base')
    b = _batch(jcfg, B=2, S=11, seed=2)
    want = JE.encdec_loss(jp, jcfg, jnp.asarray(b['frames']),
                          jnp.asarray(b['tokens']), jnp.asarray(b['labels']),
                          real_vocab=real_vocab)
    got = TE.encdec_loss(tp, tcfg, *(torch.from_numpy(b[k]) for k in
                                     ('frames', 'tokens', 'labels')),
                         real_vocab=real_vocab)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)


@pytest.mark.parametrize('arch', ['granite-moe-1b-a400m',
                                  'deepseek-v2-lite-16b'])
def test_router_aux_loss_matches_reference(arch):
    jcfg, tcfg, jp, tp = _models(arch)
    x = np.random.default_rng(3).normal(size=(2, 13, jcfg.d_model)
                                        ).astype(np.float32)
    jmoe = jax.tree_util.tree_map(lambda a: a[0], jp['blocks']['sub0']['moe'])
    want = JM.router_aux_loss(jmoe, jcfg, jnp.asarray(x))
    got = TM.router_aux_loss(tp.blocks[0].sub0.moe, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# one train step, every family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('arch', sorted(jreg.ARCHS))
def test_train_step_matches_reference(arch):
    """Loss, grad norm and every gradient of one step, then the moments
    the update wrote; the reference's gradients from its loss under
    ``jax.value_and_grad`` and its update from its ``adamw_update`` (the
    two parts of its ``build_train_step``), under one jit."""
    jcfg, tcfg, jp, tp = _models(arch)
    b = _batch(jcfg)
    oc = JA.AdamWConfig(warmup_steps=1, total_steps=10)
    toc = TA.AdamWConfig(**dataclasses.asdict(oc))

    def jloss(p):
        if jcfg.family == 'encdec':
            return JE.encdec_loss(p, jcfg, *(jnp.asarray(b[k]) for k in
                                             ('frames', 'tokens', 'labels')),
                                  real_vocab=REAL_VOCAB)
        return JT.lm_loss(p, jcfg, jnp.asarray(b['tokens']),
                          jnp.asarray(b['labels']), real_vocab=REAL_VOCAB)

    def jstep(p):
        loss, grads = jax.value_and_grad(jloss)(p)
        _, opt, norm = JA.adamw_update(oc, grads, JA.init_adamw(p), p)
        return loss, grads, opt, norm

    jl, jg, jopt, jnorm = jax.jit(jstep)(jp)

    params = list(TS.train_params(tp).values())
    tgrads = torch.autograd.grad(TS.train_loss(
        tp, tcfg, _t(b), torch.float32, REAL_VOCAB), params)
    _assert_lists_close(tgrads, _flat_grads(tp, _np(jg)), GRAD_RTOL,
                        f'{arch} gradient')
    step = TS.build_train_step(tcfg, toc, REAL_VOCAB, dtype=torch.float32)
    opt = TA.init_adamw(list(TS.train_params(tp).values()))
    _, opt, metrics = step(tp, opt, _t(b))
    np.testing.assert_allclose(metrics['loss'].item(), float(jl),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics['grad_norm'].item(), float(jnorm),
                               rtol=LOSS_RTOL)
    want = bridge.load_jax_adamw_state(tp, _np(jopt))
    assert opt.step.item() == want.step.item() == 1
    _assert_lists_close(opt.m, want.m, MOMENT_RTOL, f'{arch} m')
    _assert_lists_close(opt.v, want.v, MOMENT_RTOL, f'{arch} v')


def test_train_params_skip_quantized_weights_and_serving_needs_no_grad():
    tcfg = treg.smoke_config('internlm2-1.8b')
    lm = TS.init_params(torch.Generator().manual_seed(0), tcfg, 'cpu')
    assert not any(p.requires_grad for p in lm.parameters())
    lm.blocks[0].sub0.attn.wq.quantize_()
    params = TS.train_params(lm)
    assert 'blocks.0.sub0.attn.wq.w' not in params
    assert all(p.requires_grad and p.is_floating_point()
               for p in params.values())
    assert not any(b.requires_grad for b in lm.buffers())
    assert list(params) == [n for n, _ in lm.named_parameters()]


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('moment_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('grad_clip', [0.0, 1.0])
def test_adamw_update_matches_reference(moment_dtype, grad_clip):
    """Identical parameters, gradients and state (step 3, moments drawn
    in ``moment_dtype``) through both updates."""
    rng = np.random.default_rng(4)
    shapes = [(5, 7), (7,), (3, 4, 2)]
    draw = lambda scale: [(scale * rng.normal(size=s)).astype(np.float32)
                          for s in shapes]
    p, g = draw(1.0), draw(3.0)
    m, v = draw(0.1), [np.abs(a) for a in draw(0.01)]
    jdt = jnp.dtype(moment_dtype)
    oc = JA.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20,
                        grad_clip=grad_clip, moment_dtype=moment_dtype)
    jm, jv = ([jnp.asarray(a).astype(jdt) for a in t] for t in (m, v))
    jp2, jopt, jnorm = JA.adamw_update(
        oc, [jnp.asarray(a) for a in g], JA.AdamWState(jnp.int32(3), jm, jv),
        [jnp.asarray(a) for a in p])
    tdt = getattr(torch, moment_dtype)
    tp = [torch.from_numpy(a.copy()) for a in p]
    state = TA.AdamWState(torch.tensor(3, dtype=torch.int32),
                          [torch.from_numpy(a).to(tdt) for a in m],
                          [torch.from_numpy(a).to(tdt) for a in v])
    tp2, opt, tnorm = TA.adamw_update(
        TA.AdamWConfig(**dataclasses.asdict(oc)),
        [torch.from_numpy(a) for a in g], state, tp)
    assert tp2 is tp and opt.step.item() == 4
    np.testing.assert_allclose(tnorm.item(), float(jnorm), rtol=1e-6)
    for got, want in zip(tp, jp2):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=UPDATE_ATOL, rtol=0)
    for got_t, want_t in ((opt.m, jopt.m), (opt.v, jopt.v)):
        for got, want in zip(got_t, want_t):
            assert got.dtype == tdt
            np.testing.assert_allclose(
                got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                atol=UPDATE_ATOL if moment_dtype == 'float32' else 0, rtol=0)


@pytest.mark.parametrize('max_norm', [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(6)
    g = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (5,))]
    want, jnorm = JA.clip_by_global_norm([jnp.asarray(a) for a in g],
                                         max_norm)
    got, tnorm = TA.clip_by_global_norm([torch.from_numpy(a) for a in g],
                                        max_norm)
    np.testing.assert_allclose(tnorm.item(), float(jnorm), rtol=1e-6)
    np.testing.assert_allclose(
        TA.global_norm(got).item(), min(max_norm, float(jnorm)), rtol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_bfloat16_moments_from_float32_state():
    """The reference's trainer starts float32 moments whatever the
    config says; the first bfloat16 update replaces them."""
    cfg = TA.AdamWConfig(moment_dtype='bfloat16')
    params = [torch.ones(3, 2)]
    state = TA.init_adamw(params)
    _, state, _ = TA.adamw_update(cfg, [torch.full((3, 2), 0.5)], state,
                                  params)
    assert state.m[0].dtype == state.v[0].dtype == torch.bfloat16


@pytest.mark.parametrize('warmup,total', [(10, 50), (0, 5), (3, 3)])
def test_lr_schedule_matches_reference(warmup, total):
    oc = JA.AdamWConfig(lr=3e-3, warmup_steps=warmup, total_steps=total)
    toc = TA.AdamWConfig(**dataclasses.asdict(oc))
    for step in (0, 1, 2, 3, 5, 9, 10, 11, 25, 49, 50, 51, 400):
        want = JA.lr_schedule(oc, jnp.int32(step))
        got = TA.lr_schedule(toc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                                   atol=1e-12, err_msg=str(step))


# ---------------------------------------------------------------------------
# accumulation, remat, data, the trainer
# ---------------------------------------------------------------------------

def test_accum_step_matches_full_batch_and_reference():
    """Two microbatches against the full batch (the reference test's
    bounds: loss 1e-5, parameters 1e-4 after the step) and against the
    reference's accumulation step (loss, grad norm, moments)."""
    jcfg, tcfg, jp, tp = _models('internlm2-1.8b')
    b = _batch(jcfg, B=4, S=16, seed=5)
    oc = JA.AdamWConfig(warmup_steps=1, total_steps=10)
    toc = TA.AdamWConfig(**dataclasses.asdict(oc))
    _, jopt, jm = jax.jit(JACC.build_accum_train_step(
        jcfg, oc, 2, dtype=jnp.float32))(jp, JA.init_adamw(jp), _j(b))
    full = TS.init_params(torch.Generator().manual_seed(0), tcfg, 'cpu')
    full.load_state_dict(tp.state_dict())
    fparams = list(TS.train_params(full).values())
    _, _, fm = TS.build_train_step(tcfg, toc, dtype=torch.float32)(
        full, TA.init_adamw(fparams), _t(b))
    aparams = list(TS.train_params(tp).values())
    _, opt, am = TACC.build_accum_train_step(tcfg, toc, 2,
                                             dtype=torch.float32)(
        tp, TA.init_adamw(aparams), _t(b))
    assert abs(am['loss'].item() - fm['loss'].item()) < 1e-5
    assert max((a - f).abs().max().item()
               for a, f in zip(aparams, fparams)) < 1e-4
    np.testing.assert_allclose(am['loss'].item(), float(jm['loss']),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(am['grad_norm'].item(),
                               float(jm['grad_norm']), rtol=LOSS_RTOL)
    want = bridge.load_jax_adamw_state(tp, _np(jopt))
    _assert_lists_close(opt.m, want.m, MOMENT_RTOL, 'accumulated m')


def test_accum_step_refuses_an_uneven_batch():
    tcfg = treg.smoke_config('internlm2-1.8b')
    lm = TS.init_params(torch.Generator().manual_seed(0), tcfg, 'cpu')
    step = TACC.build_accum_train_step(tcfg, TA.AdamWConfig(), 2)
    b = _t(_batch(tcfg, B=3))
    with pytest.raises(ValueError, match='microbatches'):
        step(lm, TA.init_adamw(list(TS.train_params(lm).values())), b)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                    torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize('arch', ['internlm2-1.8b', 'jamba-1.5-large-398b',
                                  'whisper-base'])
def test_remat_changes_no_value(arch):
    """Loss and every gradient under ``'full'`` and ``'dots'`` equal
    those under ``'none'`` (the same float32 ops, recomputed); the
    backward pass recomputes the forward's products under ``'full'`` and
    none of them under ``'dots'``, which saved them."""
    results, backward_mm = {}, {}
    for remat in ('none', 'full', 'dots'):
        _, tcfg, _, tp = _models(arch, remat=remat)
        params = list(TS.train_params(tp).values())
        loss = TS.train_loss(tp, tcfg, _t(_batch(tcfg)), torch.float32)
        with _CountMM() as count:
            grads = torch.autograd.grad(loss, params)
        results[remat] = [loss.detach()] + list(grads)
        backward_mm[remat] = count.mm
    for remat in ('full', 'dots'):
        for got, want in zip(results[remat], results['none']):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    if arch == 'whisper-base':      # the reference's encoder-decoder
        assert backward_mm['dots'] == backward_mm['full']   # takes 'full'
    else:
        assert backward_mm['dots'] == backward_mm['none']
    assert backward_mm['full'] > backward_mm['none']


@pytest.mark.parametrize('seed,step,shard', [(0, 0, (0, 1)), (0, 7, (0, 1)),
                                             (3, 2, (1, 4)), (5, 11, (3, 4))])
def test_token_batch_bit_equal(seed, step, shard):
    cfg = JD.TokenPipelineConfig(vocab=211, seq_len=33, global_batch=8,
                                 seed=seed)
    want = JD.token_batch(cfg, step, shard)
    got = TD.token_batch(TD.TokenPipelineConfig(**dataclasses.asdict(cfg)),
                         step, shard)
    for k in ('tokens', 'labels'):
        assert got[k].dtype == torch.int32 and got[k].is_contiguous()
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_trainer_run_matches_reference_loop():
    """``Trainer.run`` (4 steps, the smoke InternLM2 holding the
    reference's initial parameters) against a loop of the reference's
    jitted ``build_train_step`` over its ``token_batch``: what the
    reference's ``Trainer.run`` computes, without its mesh."""
    jcfg, tcfg, jp, _ = _models('internlm2-1.8b')
    oc = JA.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    dcfg = JD.TokenPipelineConfig(vocab=jcfg.vocab, seq_len=16,
                                  global_batch=4)
    step = jax.jit(JS.build_train_step(jcfg, oc, dtype=jnp.float32))
    p, opt, want = jp, JA.init_adamw(jp), []
    for s in range(4):
        p, opt, m = step(p, opt, JD.token_batch(dcfg, s))
        want.append(float(m['loss']))
    tr = Trainer(tcfg, TA.AdamWConfig(**dataclasses.asdict(oc)),
                 device='cpu')
    bridge.load_jax_lm_params(tr.params, _np(jp))
    got = tr.run(TD.TokenPipelineConfig(**dataclasses.asdict(dcfg)), 4)
    assert want[-1] < want[0]
    np.testing.assert_allclose(got, want, rtol=RUN_RTOL)
