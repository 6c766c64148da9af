"""End-to-end diffusion pipeline, port of ``repro/diffusion/pipeline.py``:
noise -> DDIM or DDPM denoising with the UNet (or DDIM with DeepCache,
``generate_deepcache``) -> VAE decode for latent models.

The pipeline carries a default ``PrecisionPolicy`` and every entry point
takes a per-call ``policy=`` override, so one pipeline serves requests at
different precisions.  Weights live on ``device`` (the GPU unless the
caller asks for the CPU).  A request's initial noise is the reference's
(``normal(split(PRNGKey(seed))[0], shape)``, ``core/prng``), drawn on the
CPU and moved to the device, so the image a seed gives does not depend
on the device that serves it.  Under a noisy policy every UNet
evaluation draws its analog noise from a key that folds in the first
row's timestep and the guidance branch, as the reference's does.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence, Union

import torch

from repro_torch.core import prng
from repro_torch.core.precision import PrecisionPolicy, resolve
from repro_torch.diffusion import samplers
from repro_torch.diffusion.deepcache import unet_apply_cached
from repro_torch.diffusion.schedule import Schedule, linear_schedule
from repro_torch.models import layers as L
from repro_torch.models.autoencoder import VAEConfig, VAEDecoder
from repro_torch.models.unet import UNet, UNetConfig

_PROJECTIONS = ('wq', 'wk', 'wv', 'wo', 'xq', 'xk', 'xv', 'xo')


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device asked for; raises when it is a GPU this machine lacks."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA is not available; pass device="cpu" to run '
                           'the plain PyTorch path on the CPU')
    return dev


def initial_noise(seed: int, shape: Sequence[int],
                  device: Union[str, torch.device]) -> torch.Tensor:
    """The reference's initial noise for ``seed`` (``ddim_sample``'s
    ``normal(split(PRNGKey(seed))[0], shape)``), drawn on the CPU and
    moved to ``device``."""
    k0, _ = prng.split(prng.PRNGKey(seed))
    return prng.normal(k0, tuple(shape), device='cpu').to(device)


@dataclasses.dataclass
class DiffusionPipeline:
    unet_cfg: UNetConfig
    unet: UNet
    sched: Schedule
    vae_cfg: Optional[VAEConfig] = None
    vae: Optional[VAEDecoder] = None
    policy: PrecisionPolicy = PrecisionPolicy.fp32()

    @classmethod
    def init(cls, seed: int, unet_cfg: UNetConfig,
             vae_cfg: Optional[VAEConfig] = None, *,
             timesteps: Optional[int] = None,
             policy: Union[PrecisionPolicy, str, None] = None,
             device: Union[str, torch.device] = 'cuda') -> 'DiffusionPipeline':
        """Freshly initialised weights drawn on the CPU from ``seed`` (so
        they are the same on every device), then moved to ``device``."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        unet = UNet(unet_cfg)
        L.init_params(unet, gen)
        vae = None
        if vae_cfg is not None:
            vae = VAEDecoder(vae_cfg)
            L.init_params(vae, gen)
            vae = vae.to(dev).eval()
        sched = linear_schedule(timesteps or unet_cfg.timesteps, device=dev)
        return cls(unet_cfg, unet.to(dev).eval(), sched, vae_cfg, vae,
                   resolve(policy))

    @property
    def device(self) -> torch.device:
        return self.sched.betas.device

    def to(self, device) -> 'DiffusionPipeline':
        """A copy of this pipeline with every weight on ``device``."""
        dev = resolve_device(device)
        s = self.sched
        return dataclasses.replace(
            self, unet=copy.deepcopy(self.unet).to(dev),
            vae=None if self.vae is None else copy.deepcopy(self.vae).to(dev),
            sched=Schedule(s.betas.to(dev), s.alphas.to(dev),
                           s.alpha_bars.to(dev)))

    def prequantize(self) -> 'DiffusionPipeline':
        """Serve-time calibration: a copy whose attention projection
        weights are per-output-channel QTensors (the weights the dynamic
        w8a8 path quantizes on the fly, with the same scale rule), with the
        policy's calibration pinned to 'prequant'."""
        unet = copy.deepcopy(self.unet)
        for name, m in unet.named_modules():
            if isinstance(m, L.Linear) and name.rsplit('.', 1)[-1] in \
                    _PROJECTIONS:
                m.quantize_()
        pol = self.policy if self.policy.quantized else PrecisionPolicy.w8a8()
        return dataclasses.replace(
            self, unet=unet,
            policy=dataclasses.replace(pol, calibration='prequant'))

    def _eps_fn(self, context=None, guidance: float = 0.0, policy=None,
                noise_key: Optional[prng.Key] = None, first_sample: int = 0):
        """Noise-prediction closure at a given precision, with
        classifier-free guidance when ``guidance > 0`` and a context is
        given: ``e_unc + guidance * (e_cond - e_unc)``.  Under a noisy
        policy the evaluation's key is ``fold_in(fold_in(base, t[0]),
        branch)`` (branch 0 conditional, 1 unconditional), ``base`` being
        ``noise_key`` or the policy's seed anchor.  ``eps(x, t, t_first)``
        takes ``t[0]`` from a caller that holds it on the host, which
        spares the device sync of reading it; a shard of the engine's slot
        axis passes global slot 0's.  ``first_sample``: x's first sample
        in that larger batch, whose draws the evaluation takes
        (``UNet.forward``)."""
        pol = resolve(policy) if policy is not None else self.policy
        base = None
        if pol.noisy:
            base = noise_key if noise_key is not None else \
                prng.PRNGKey(pol.noise_seed)

        def keyed(t0, branch):
            if base is None:
                return None
            return prng.fold_in(prng.fold_in(base, t0), branch)

        def eps(x, t, t_first: Optional[int] = None):
            t0 = None
            if base is not None:
                t0 = int(t.reshape(-1)[0]) if t_first is None else t_first
            e = self.unet(x, t, context, pol, keyed(t0, 0), first_sample)
            if guidance > 0.0 and context is not None:
                e_unc = self.unet(x, t, None, pol, keyed(t0, 1),
                                  first_sample)
                e = e_unc + guidance * (e - e_unc)
            return e
        return eps

    def sample_shape(self, batch: int):
        c = self.unet_cfg
        return (batch, c.img_size, c.img_size, c.in_ch)

    @torch.no_grad()
    def denoise_step(self, x: torch.Tensor, t, t_prev, context=None,
                     guidance: float = 0.0, policy=None,
                     noise_key: Optional[prng.Key] = None) -> torch.Tensor:
        """One mixed-timestep DDIM step; ``t`` / ``t_prev`` are per-sample
        (B,) vectors or scalars.  ``noise_key`` re-anchors a noisy
        policy's draws (the engine threads a per-tick key)."""
        tt = torch.as_tensor(t, dtype=torch.long, device=x.device).expand(
            x.shape[0])
        eps = self._eps_fn(context, guidance, policy, noise_key)(x, tt)
        return samplers.ddim_step(self.sched, eps, x, t, t_prev)

    @torch.no_grad()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents to images for latent models (identity otherwise)."""
        return z if self.vae is None else self.vae(z)

    @torch.no_grad()
    def generate(self, seed: int, batch: int = 1, steps: int = 50,
                 sampler: str = 'ddim', context=None, guidance: float = 0.0,
                 policy=None) -> torch.Tensor:
        """Serve one batch of requests with DDIM over ``steps`` steps, or
        with ``sampler='ddpm'`` ancestral sampling over all T steps of the
        schedule (``steps`` unused), from ``PRNGKey(seed)``'s chain;
        returns images (or latents when there is no VAE), NHWC."""
        eps = self._eps_fn(context, guidance, policy)
        shape = self.sample_shape(batch)
        if sampler == 'ddpm':
            z = samplers.ddpm_sample(self.sched, eps, shape,
                                     prng.PRNGKey(seed), device=self.device)
        else:
            z = samplers.ddim_sample(self.sched, eps,
                                     initial_noise(seed, shape, self.device),
                                     steps)
        return self.decode(z)

    @torch.no_grad()
    def generate_deepcache(self, seed: int, batch: int = 1, steps: int = 50,
                           interval: int = 5, context=None,
                           policy=None) -> torch.Tensor:
        """DDIM with the DeepCache baseline: a full UNet pass every
        ``interval`` steps refreshes the cache of deep features, the
        passes between recompute only the shallow layers
        (``deepcache.unet_apply_cached``).  With ``interval=1`` every step
        refreshes, so the output is ``generate``'s.  ``policy`` overrides
        the pipeline's precision for this call."""
        pol = resolve(policy) if policy is not None else self.policy
        ts = samplers.ddim_timesteps(self.sched, steps)
        x = initial_noise(seed, self.sample_shape(batch), self.device)
        cache = None
        for i, t in enumerate(ts):
            tb = torch.full((batch,), int(t), dtype=torch.long,
                            device=self.device)
            refresh = i % interval == 0 or cache is None
            eps, cache = unet_apply_cached(self.unet, self.unet_cfg, x, tb,
                                           cache, refresh, context, pol)
            t_prev = int(ts[i + 1]) if i + 1 < steps else -1
            x = samplers.ddim_step(self.sched, eps, x, int(t), t_prev)
        return self.decode(x)
