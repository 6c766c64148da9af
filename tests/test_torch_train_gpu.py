"""The training path on the card against the CPU: three train steps of
the smoke InternLM2 and Granite-MoE from the same parameters and
``token_batch`` batches (losses and grad norms within 1e-4 relative:
float32 sums in another order, which Adam's first step can turn into
+-lr on parameters whose gradient is ~1e-9 from zero), with no kernel of
``kernels/`` launched; remat ``'full'`` against ``'none'`` on the card
(gradients within 1e-6 of the largest: the same kernels recomputed).

Imports neither ``jax`` nor the JAX package, so it runs on the GPU
machine: ``python -m pytest -m gpu tests/test_torch_train_gpu.py``.
Every test skips where there is no CUDA device."""
import copy

import pytest
import torch

from repro_torch.configs.registry import smoke_config
from repro_torch.data.pipeline import TokenPipelineConfig, token_batch
from repro_torch.kernels import ops
from repro_torch.launch import steps as ST
from repro_torch.optim.adamw import AdamWConfig, init_adamw

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    return torch.device('cuda')


@pytest.mark.parametrize('arch', ['internlm2-1.8b', 'granite-moe-1b-a400m'])
def test_train_steps_on_card_match_cpu(cuda, arch):
    cfg = smoke_config(arch)
    models = {'cpu': ST.init_params(torch.Generator().manual_seed(0), cfg,
                                    'cpu')}
    models['cuda'] = copy.deepcopy(models['cpu']).to(cuda)
    step = ST.build_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                                total_steps=3),
                               dtype=torch.float32)
    data = TokenPipelineConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    opts = {d: init_adamw(list(ST.train_params(m).values()))
            for d, m in models.items()}
    ops.reset_launches()
    for s in range(3):
        out = {}
        for d in models:
            models[d], opts[d], out[d] = step(models[d], opts[d],
                                              token_batch(data, s, device=d))
        for k in ('loss', 'grad_norm'):
            torch.testing.assert_close(out['cuda'][k].cpu(), out['cpu'][k],
                                       rtol=1e-4, atol=0)
    assert sum(ops.launch_counts().values()) == 0


def test_remat_on_card_changes_no_gradient(cuda):
    grads = {}
    for remat in ('none', 'full'):
        cfg = smoke_config('internlm2-1.8b').scaled(remat=remat)
        lm = ST.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                            cuda)
        params = list(ST.train_params(lm).values())
        batch = token_batch(TokenPipelineConfig(cfg.vocab, 32, 4), 0,
                            device=cuda)
        grads[remat] = torch.autograd.grad(
            ST.train_loss(lm, cfg, batch, torch.float32), params)
    scale = max(g.abs().max().item() for g in grads['none'])
    for a, b in zip(grads['full'], grads['none']):
        assert (a - b).abs().max().item() <= 1e-6 * scale
