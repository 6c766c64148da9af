"""The paper's evaluated models (Table I), copied from
``repro/configs/diffusion.py``.  Of the four UNets only ``SD_V1_4``
builds in the reference at full width: ``DDPM_CIFAR10`` and
``LDM_CHURCHES`` have an odd ``base_ch`` (the timestep embedding comes
out one feature short of ``t_mlp1``) and ``LDM_BEDS`` has 666 channels,
which do not split into 8 heads."""
from __future__ import annotations

from repro_torch.models.autoencoder import VAEConfig
from repro_torch.models.unet import UNetConfig

DDPM_CIFAR10 = UNetConfig(
    name='ddpm_cifar10', img_size=32, in_ch=3, base_ch=165,
    ch_mults=(1, 2, 2, 2), n_res_blocks=2, attn_resolutions=(16,),
    n_heads=8, timesteps=1000)

LDM_CHURCHES = UNetConfig(
    name='ldm_churches', img_size=32, in_ch=4, base_ch=207,
    ch_mults=(1, 2, 2, 4, 4), n_res_blocks=2, attn_resolutions=(16, 8),
    n_heads=8, timesteps=1000, latent=True)

LDM_BEDS = UNetConfig(
    name='ldm_beds', img_size=64, in_ch=3, base_ch=222,
    ch_mults=(1, 2, 3, 4), n_res_blocks=2, attn_resolutions=(16, 8),
    n_heads=8, timesteps=1000, latent=True)

SD_V1_4 = UNetConfig(
    name='sd_v1_4', img_size=64, in_ch=4, base_ch=340,
    ch_mults=(1, 2, 4, 4), n_res_blocks=2, attn_resolutions=(32, 16, 8),
    n_heads=8, context_dim=768, timesteps=1000, latent=True)

VAE_256 = VAEConfig(img_size=256, in_ch=3, z_ch=4, base_ch=128,
                    ch_mults=(1, 2, 4, 4))
VAE_512 = VAEConfig(img_size=512, in_ch=3, z_ch=4, base_ch=128,
                    ch_mults=(1, 2, 4, 4))

PAPER_MODELS = {
    'ddpm_cifar10': DDPM_CIFAR10,
    'ldm_churches': LDM_CHURCHES,
    'ldm_beds': LDM_BEDS,
    'sd_v1_4': SD_V1_4,
}

PAPER_PARAM_COUNTS = {          # Table I, millions
    'ddpm_cifar10': 61.9,
    'ldm_churches': 294.96,
    'ldm_beds': 274.05,
    'sd_v1_4': 859.52,
}

# Table I: IS reduction after 8-bit quantization (%)
PAPER_IS_REDUCTION = {
    'ddpm_cifar10': 0.44,
    'ldm_churches': 0.43,
    'ldm_beds': 5.26,
    'sd_v1_4': 6.66,
}
