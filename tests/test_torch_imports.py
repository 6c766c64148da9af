"""Import hygiene of the port: ``repro_torch`` (its training modules
included), ``chip_smoke.py``, the port's profiling scripts, its serving
example and its jax-free test files never import ``jax`` or anything of
the JAX package ``repro``, and
``chip_smoke.py`` refuses to run where it has no GPU or no repository."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / 'src' / 'repro_torch'
SOURCES = sorted(str(p.relative_to(ROOT)) for p in PORT.rglob('*.py')) + [
    'chip_smoke.py', 'scripts/torch_profile_step.py',
    'scripts/torch_lm_gap.py', 'examples/serve_diffusion_torch.py',
    # the test files that run on the GPU machine, which has no JAX
    'tests/test_torch_kernels_gpu.py', 'tests/test_torch_serving_gpu.py',
    'tests/test_torch_train_gpu.py', 'tests/test_torch_checkpoint.py']

# the serving features' modules (threefry generator, photonic model,
# DeepCache): the hygiene tests below must reach each of them
SERVING_FEATURE_MODULES = [
    'src/repro_torch/core/prng.py',
    'src/repro_torch/core/photonic/__init__.py',
    'src/repro_torch/core/photonic/devices.py',
    'src/repro_torch/core/photonic/arch.py',
    'src/repro_torch/core/photonic/workload.py',
    'src/repro_torch/core/photonic/simulator.py',
    'src/repro_torch/core/photonic/baselines.py',
    'src/repro_torch/core/photonic/noise.py',
    'src/repro_torch/diffusion/deepcache.py',
]
# the serving CLI's modules: the copied observability package, the engine
# and the entry point
SERVING_CLI_MODULES = [
    'src/repro_torch/obs/__init__.py',
    'src/repro_torch/obs/tracer.py',
    'src/repro_torch/obs/export.py',
    'src/repro_torch/obs/prom.py',
    'src/repro_torch/serving/engine.py',
    'src/repro_torch/launch/serve.py',
    'examples/serve_diffusion_torch.py',
]

# the LM families' modules: the encoder-decoder and the M-RoPE attention,
# the LM and the steps that dispatch between them
LM_FAMILY_MODULES = [
    'src/repro_torch/models/encdec.py',
    'src/repro_torch/models/attention.py',
    'src/repro_torch/models/transformer.py',
    'src/repro_torch/launch/steps.py',
    'src/repro_torch/bridge.py',
]

# the training path's modules: the optimizer, the data pipeline, the
# checkpoint manager, the fault-tolerance runtime and the trainer
TRAINING_MODULES = [
    'src/repro_torch/optim/__init__.py',
    'src/repro_torch/optim/adamw.py',
    'src/repro_torch/optim/accumulation.py',
    'src/repro_torch/data/__init__.py',
    'src/repro_torch/data/pipeline.py',
    'src/repro_torch/checkpoint/__init__.py',
    'src/repro_torch/checkpoint/manager.py',
    'src/repro_torch/distributed/__init__.py',
    'src/repro_torch/distributed/fault_tolerance.py',
    'src/repro_torch/launch/train.py',
]

# the sharded serving path's modules: the serving mesh, the bucket router
# and the resize ledger
MESH_SERVING_MODULES = [
    'src/repro_torch/launch/mesh.py',
    'src/repro_torch/serving/batcher.py',
    'src/repro_torch/serving/metrics.py',
]

# the sharded trainer's modules: the sharding rules, the training meshes,
# gradient compression, and the modules that now take DTensors
SHARDED_TRAINING_MODULES = [
    'src/repro_torch/distributed/sharding.py',
    'src/repro_torch/distributed/compression.py',
    'src/repro_torch/launch/mesh.py',
    'src/repro_torch/launch/train.py',
    'src/repro_torch/launch/steps.py',
    'src/repro_torch/optim/adamw.py',
    'src/repro_torch/checkpoint/manager.py',
    'src/repro_torch/models/layers.py',
    'src/repro_torch/models/attention.py',
    'src/repro_torch/models/moe.py',
    'src/repro_torch/models/ssm.py',
    'src/repro_torch/models/transformer.py',
]


# the DDPM path and the rest of the diffusion side: the schedules and the
# loss, the samplers, the pipeline's DDPM and DeepCache entries, the image
# pipeline, the VAE encoder, the GroupNorm+swish gradient and the core
# helpers (quantization, the sparse dataflow's saving, Eq. 6)
DDPM_MODULES = [
    'src/repro_torch/diffusion/schedule.py',
    'src/repro_torch/diffusion/samplers.py',
    'src/repro_torch/diffusion/pipeline.py',
    'src/repro_torch/data/pipeline.py',
    'src/repro_torch/models/autoencoder.py',
    'src/repro_torch/kernels/fused_gn_swish.py',
    'src/repro_torch/kernels/ops.py',
    'src/repro_torch/core/quantization.py',
    'src/repro_torch/core/sparse_dataflow.py',
    'src/repro_torch/core/attention_decomp.py',
]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize('source', SOURCES)
def test_source_never_imports_jax_or_the_reference(source):
    for mod in _imported_modules(ROOT / source):
        top = mod.split('.')[0]
        assert top not in ('jax', 'jaxlib', 'repro'), f'{source} imports {mod}'


@pytest.mark.parametrize('source', SERVING_FEATURE_MODULES
                         + SERVING_CLI_MODULES + LM_FAMILY_MODULES
                         + TRAINING_MODULES + MESH_SERVING_MODULES
                         + DDPM_MODULES + SHARDED_TRAINING_MODULES)
def test_serving_feature_modules_are_covered(source):
    assert source in SOURCES
    mods = {m.split('.')[0] for m in _imported_modules(ROOT / source)}
    assert not mods & {'jax', 'jaxlib', 'repro'}, source


def test_obs_imports_only_the_standard_library():
    for path in (PORT / 'obs').glob('*.py'):
        for mod in _imported_modules(path):
            top = mod.split('.')[0]
            assert top in sys.stdlib_module_names or \
                mod.startswith('repro_torch.obs'), f'{path.name}: {mod}'


def test_every_module_imports_with_jax_and_repro_blocked():
    modules = sorted(
        'repro_torch.' + '.'.join(p.relative_to(PORT).with_suffix('').parts)
        for p in PORT.rglob('*.py'))
    assert 'repro_torch.launch.mesh' in modules
    assert 'repro_torch.core.attention_decomp' in modules
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "assert 'jax' not in {k.split('.')[0] for k, v in sys.modules.items()"
        " if v is not None}\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith('ok')


@pytest.mark.parametrize('where', ['checkout', 'alone'])
def test_chip_smoke_fails_without_gpu_or_repository(tmp_path, where):
    """With no GPU visible the script must exit non-zero with no result
    line; copied alone into an empty directory it must do the same."""
    script, env = ROOT / 'chip_smoke.py', dict(os.environ)
    if where == 'alone':
        script = Path(shutil.copy(script, tmp_path / 'chip_smoke.py'))
    else:
        env['CUDA_VISIBLE_DEVICES'] = ''
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=120, cwd=script.parent, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
