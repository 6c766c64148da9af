"""Plain reference of the diffusion cells: the latent-diffusion UNet of
the paper's Table I (SD v1.4 as the reproduction builds it), its VAE
decoder, DDIM with classifier-free guidance, and DeepCache's skip passes.

Written from the model's description, in plain torch over a dict of
weights, NHWC activations, ``(in, out)`` linear weights and OIHW conv
kernels (the layout of the benchmark's weight file, ``param_spec``):

* ResBlock: GroupNorm (largest group count <= 32 dividing C, population
  variance, eps 1e-5) + swish, 3x3 conv, + the projected swish(time
  embedding), GroupNorm + swish, 3x3 conv, + the input (1x1 conv when
  the width changes);
* attention block: GroupNorm, self-attention over the H*W tokens (8
  heads, softmax in float32), then cross-attention into the 77x768
  context when there is one; every projection on the W8A8 rule when the
  request is quantized (``numerics.Numerics.w8a8``);
* down levels end in a 3x3 stride-2 conv (XLA's SAME padding), up levels
  in a 4x4 stride-2 transposed conv with ``jax.lax.conv_transpose``'s
  SAME semantics, computed here densely (zeros inserted, one conv);
* DeepCache: a skip pass recomputes the time embedding, ``conv_in``, the
  outermost down level's blocks and the last up level, and takes the
  activation entering that level from the last full pass;
* the VAE decoder: ResBlocks without time embedding, transposed-conv
  upsampling, GroupNorm + swish, 3x3 conv, tanh.

Imports torch and numpy only: no kernel, cache or engine of the program.
"""
from __future__ import annotations

import collections
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .noise import Draws, Stream, bases
from .numerics import Numerics
from .prng import initial_noise

P = Dict[str, torch.Tensor]
#: uniform half-width of biases and of norm scales around 1 (nonzero, so
#: the comparison reaches every bias add)
SMALL = 0.1


# ---------------------------------------------------------------------------
# the weight file's layout
# ---------------------------------------------------------------------------

def _lin(spec, name, din, dout, bias=True):
    spec.append((f'{name}.w', (din, dout), din ** -0.5, 0.0))
    if bias:
        spec.append((f'{name}.b', (dout,), SMALL, 0.0))


def _conv(spec, name, k, cin, cout):
    spec.append((f'{name}.w', (cout, cin, k, k), (cin * k * k) ** -0.5, 0.0))
    spec.append((f'{name}.b', (cout,), SMALL, 0.0))


def _gn(spec, name, c):
    spec.append((f'{name}.scale', (c,), SMALL, 1.0))
    spec.append((f'{name}.bias', (c,), SMALL, 0.0))


def _res(spec, name, cin, cout, t_dim=None):
    _gn(spec, f'{name}.gn1', cin)
    _conv(spec, f'{name}.conv1', 3, cin, cout)
    if t_dim is not None:
        _lin(spec, f'{name}.t_proj', t_dim, cout)
    _gn(spec, f'{name}.gn2', cout)
    _conv(spec, f'{name}.conv2', 3, cout, cout)
    if cin != cout:
        _conv(spec, f'{name}.skip', 1, cin, cout)


def _attn(spec, name, ch, ctx_dim):
    _gn(spec, f'{name}.gn', ch)
    for p in ('wq', 'wk', 'wv'):
        _lin(spec, f'{name}.{p}', ch, ch, bias=False)
    _lin(spec, f'{name}.wo', ch, ch)
    if ctx_dim is not None:
        _lin(spec, f'{name}.xq', ch, ch, bias=False)
        _lin(spec, f'{name}.xk', ctx_dim, ch, bias=False)
        _lin(spec, f'{name}.xv', ctx_dim, ch, bias=False)
        _lin(spec, f'{name}.xo', ch, ch)


def unet_spec(c: dict) -> list:
    """(name, shape, bound, center) of every UNet weight."""
    spec: list = []
    base, mults, nres = c['base_ch'], c['ch_mults'], c['n_res_blocks']
    t_dim, ctx = base * 4, c.get('context_dim')
    _lin(spec, 't_mlp1', base, t_dim)
    _lin(spec, 't_mlp2', t_dim, t_dim)
    _conv(spec, 'conv_in', 3, c['in_ch'], base)
    chs, ch = [base], base
    for lvl, m in enumerate(mults):
        for j in range(nres):
            _res(spec, f'down.{lvl}.blocks.{j}.res', ch, base * m, t_dim)
            ch = base * m
            if _attn_at(c, lvl):
                _attn(spec, f'down.{lvl}.blocks.{j}.attn', ch, ctx)
            chs.append(ch)
        if lvl < len(mults) - 1:
            _conv(spec, f'down.{lvl}.down', 3, ch, ch)
            chs.append(ch)
    _res(spec, 'mid.res1', ch, ch, t_dim)
    _attn(spec, 'mid.attn', ch, ctx)
    _res(spec, 'mid.res2', ch, ch, t_dim)
    for i, lvl in enumerate(reversed(range(len(mults)))):
        for j in range(nres + 1):
            _res(spec, f'up.{i}.blocks.{j}.res', ch + chs.pop(),
                 base * mults[lvl], t_dim)
            ch = base * mults[lvl]
            if _attn_at(c, lvl):
                _attn(spec, f'up.{i}.blocks.{j}.attn', ch, ctx)
        if lvl > 0:
            _conv(spec, f'up.{i}.upconv', 4, ch, ch)
    _gn(spec, 'gn_out', ch)
    _conv(spec, 'conv_out', 3, ch, c['in_ch'])
    return spec


def vae_decoder_spec(v: dict) -> list:
    spec: list = []
    mults = v['ch_mults']
    ch = v['base_ch'] * mults[-1]
    _conv(spec, 'dec_in', 3, v['z_ch'], ch)
    for i, lvl in enumerate(reversed(range(len(mults)))):
        out = v['base_ch'] * mults[lvl]
        _res(spec, f'dec.{i}.res', ch, out)
        ch = out
        if lvl > 0:
            _conv(spec, f'dec.{i}.up', 4, ch, ch)
    _gn(spec, 'dec_gn', ch)
    _conv(spec, 'dec_out', 3, ch, v['in_ch'])
    return spec


def _attn_at(c: dict, lvl: int) -> bool:
    return (c['img_size'] >> lvl) in c['attn_resolutions']


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def groupnorm(x, scale, bias, groups: int = 32, eps: float = 1e-5):
    N, H, W, C = x.shape
    g = min(groups, C)
    while C % g:
        g -= 1
    xf = x.float().reshape(N, H * W, g, C // g)
    mu = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=(1, 3), keepdim=True)
    return ((xf - mu) / torch.sqrt(var + eps)).reshape(N, H, W, C) * scale \
        + bias


def swish(x):
    return x * torch.sigmoid(x)


def _same(size: int, k: int, s: int):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(num: Numerics, p: P, name: str, x, stride: int = 1):
    w = p[f'{name}.w']
    k = w.shape[2]
    ph, pw = _same(x.shape[1], k, stride), _same(x.shape[2], k, stride)
    return num.conv(x, w, p.get(f'{name}.b'), ph + pw, stride)


def conv_transpose(num: Numerics, p: P, name: str, x, s: int = 2):
    """``jax.lax.conv_transpose(x, k, (s, s), 'SAME')`` without a kernel
    flip: ``s - 1`` zeros between input pixels, then one correlation."""
    N, H, W, C = x.shape
    w = p[f'{name}.w']
    k = w.shape[2]
    xd = x.new_zeros(N, (H - 1) * s + 1, (W - 1) * s + 1, C)
    xd[:, ::s, ::s] = x
    pa = k - 1 if s > k - 1 else -(-(k + s - 2) // 2)
    pads = (pa, k + s - 2 - pa) * 2
    return num.conv(xd, w, p.get(f'{name}.b'), pads)


def res_block(num, p, name, x, g, temb=None):
    h = conv(num, p, f'{name}.conv1',
             swish(groupnorm(x, p[f'{name}.gn1.scale'], p[f'{name}.gn1.bias'],
                             g)))
    if temb is not None:
        h = h + num.linear(swish(temb), p[f'{name}.t_proj.w'],
                           p[f'{name}.t_proj.b'])[:, None, None, :]
    h = conv(num, p, f'{name}.conv2',
             swish(groupnorm(h, p[f'{name}.gn2.scale'], p[f'{name}.gn2.bias'],
                             g)))
    skip = conv(num, p, f'{name}.skip', x) if f'{name}.skip.w' in p else x
    return skip + h


def mha(num, q, k, v, heads: int):
    B, S, C = q.shape
    T, hd = k.shape[1], C // heads
    qh = q.reshape(B, S, heads, hd) * hd ** -0.5
    s = num.einsum('bshd,bthd->bhst', qh, k.reshape(B, T, heads, hd))
    a = torch.softmax(s, dim=-1)
    o = num.einsum('bhst,bthd->bshd', a, v.reshape(B, T, heads, hd))
    return o.reshape(B, S, C)


def attn_block(num, p, name, x, g, heads, context, quant, noise=None):
    B, H, W, C = x.shape

    def lin(proj, v):
        w, b = p[f'{name}.{proj}.w'], p.get(f'{name}.{proj}.b')
        if noise is not None:
            return noise.linear(num, v, w, b)
        return num.linear(v, w, b, quant)

    t = groupnorm(x, p[f'{name}.gn.scale'], p[f'{name}.gn.bias'],
                  g).reshape(B, H * W, C)
    t = t + lin('wo', mha(num, lin('wq', t), lin('wk', t), lin('wv', t),
                          heads))
    if context is not None and f'{name}.xq.w' in p:
        t = t + lin('xo', mha(num, lin('xq', t), lin('xk', context),
                              lin('xv', context), heads))
    return x + t.reshape(B, H, W, C)


def timestep_embedding(t, dim: int):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    ang = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


# ---------------------------------------------------------------------------
# the networks
# ---------------------------------------------------------------------------

def unet(num: Numerics, p: P, c: dict, x, t, context, quant: bool,
         deep: Optional[torch.Tensor] = None,
         noise: Optional[Stream] = None):
    """Predicted noise of x (B, H, W, C) at timesteps t (B,), and the
    activation entering the last up level.  ``deep`` given: a DeepCache
    skip pass that takes it instead of computing it.  ``noise`` given:
    every attention projection perturbed, its keys from that stream."""
    g, heads, nres = c['groups'], c['n_heads'], c['n_res_blocks']
    L = len(c['ch_mults'])
    temb = timestep_embedding(t, c['base_ch'])
    temb = num.linear(swish(num.linear(temb, p['t_mlp1.w'], p['t_mlp1.b'])),
                      p['t_mlp2.w'], p['t_mlp2.b'])
    h = conv(num, p, 'conv_in', x)
    hs: List[torch.Tensor] = [h]

    def down_level(lvl, h):
        for j in range(nres):
            h = res_block(num, p, f'down.{lvl}.blocks.{j}.res', h, g, temb)
            if _attn_at(c, lvl):
                h = attn_block(num, p, f'down.{lvl}.blocks.{j}.attn', h, g,
                               heads, context, quant, noise)
            hs.append(h)
        return h

    def up_level(i, h):
        lvl = L - 1 - i
        for j in range(nres + 1):
            h = torch.cat([h, hs.pop()], dim=-1)
            h = res_block(num, p, f'up.{i}.blocks.{j}.res', h, g, temb)
            if _attn_at(c, lvl):
                h = attn_block(num, p, f'up.{i}.blocks.{j}.attn', h, g,
                               heads, context, quant, noise)
        if lvl > 0:
            h = conv_transpose(num, p, f'up.{i}.upconv', h)
        return h

    h = down_level(0, h)
    if deep is None:
        for lvl in range(L):
            if lvl > 0:
                h = down_level(lvl, h)
            if lvl < L - 1:
                h = conv(num, p, f'down.{lvl}.down', h, stride=2)
                hs.append(h)
        h = res_block(num, p, 'mid.res1', h, g, temb)
        h = attn_block(num, p, 'mid.attn', h, g, heads, context, quant,
                       noise)
        h = res_block(num, p, 'mid.res2', h, g, temb)
        for i in range(L - 1):
            h = up_level(i, h)
        deep = h
    h = up_level(L - 1, deep)
    h = swish(groupnorm(h, p['gn_out.scale'], p['gn_out.bias'], g))
    return conv(num, p, 'conv_out', h), deep


def vae_decode(num: Numerics, p: P, v: dict, z):
    g = v['groups']
    h = conv(num, p, 'dec_in', z)
    for i, lvl in enumerate(reversed(range(len(v['ch_mults'])))):
        h = res_block(num, p, f'dec.{i}.res', h, g)
        if lvl > 0:
            h = conv_transpose(num, p, f'dec.{i}.up', h)
    h = swish(groupnorm(h, p['dec_gn.scale'], p['dec_gn.bias'], g))
    return torch.tanh(conv(num, p, 'dec_out', h))


def alpha_bars(T: int, device) -> torch.Tensor:
    """The linear schedule's cumulative products (betas 1e-4 ... 0.02)."""
    betas = torch.linspace(1e-4, 0.02, T, dtype=torch.float32, device=device)
    return torch.cumprod(1.0 - betas, dim=0)


def ddim_timesteps(T: int, steps: int) -> np.ndarray:
    return np.linspace(T - 1, 0, steps).astype(np.int32)


def ddim_update(ab, x, eps, t: int, t_prev: int):
    """Deterministic DDIM (eta 0) from t to t_prev (-1: to x0)."""
    a_t = ab[t]
    a_p = ab[t_prev] if t_prev >= 0 else torch.ones((), device=x.device)
    x0 = (x - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
    return torch.sqrt(a_p) * x0 + torch.sqrt(torch.clamp(1 - a_p, min=0.0)) \
        * eps


#: rows the VAE decoder takes at once
DECODE_ROWS = 8


@torch.no_grad()
def generate(num: Numerics, unet_p: P, vae_p: P, cfg: dict,
             seeds: Sequence[int], context: Optional[torch.Tensor],
             steps: int, guidance: float, quant: bool,
             cache_interval: int = 1,
             draws: Optional[Sequence[Draws]] = None) -> torch.Tensor:
    """Images (B, 512, 512, 3) of requests ``seeds`` (one context row
    each, (B, 77, 768), or None): DDIM over ``steps`` steps from each
    seed's initial noise, guided when ``guidance > 0``, with a full pass
    every ``cache_interval`` steps and DeepCache skip passes between.
    ``draws`` given (one per request): the requests are noisy, and each
    step runs at its request's engine tick, with the requests of that
    tick, its projections perturbed as ``noise`` states (unless
    ``num.analog`` is off: then on the W8A8 rule alone)."""
    c, v = cfg['unet'], cfg['vae']
    dev = context.device if context is not None else unet_p['conv_in.w'].device
    shape = (c['img_size'], c['img_size'], c['in_ch'])
    x = torch.stack([initial_noise(s, (1,) + shape)[0] for s in seeds]).to(dev)
    ab = alpha_bars(c['timesteps'], dev)
    ts = ddim_timesteps(c['timesteps'], steps)
    if draws is not None and num.analog:
        x = _by_tick(num, unet_p, c, x, context, ts, ab, guidance,
                     cache_interval, draws)
    else:
        deep_c = deep_u = None
        for i, t in enumerate(ts):
            full = cache_interval <= 1 or i % cache_interval == 0
            tb = torch.full((len(seeds),), int(t), dtype=torch.long,
                            device=dev)
            eps, deep_c = unet(num, unet_p, c, x, tb, context, quant,
                               None if full else deep_c)
            if guidance > 0.0:
                eps_u, deep_u = unet(num, unet_p, c, x, tb, None, quant,
                                     None if full else deep_u)
                eps = eps_u + guidance * (eps - eps_u)
            t_prev = int(ts[i + 1]) if i + 1 < len(ts) else -1
            x = ddim_update(ab, x, eps, int(t), t_prev)
    return torch.cat([vae_decode(num, vae_p, v, x[i:i + DECODE_ROWS])
                      for i in range(0, len(x), DECODE_ROWS)])


def _by_tick(num: Numerics, p: P, c: dict, x, context, ts, ab,
             guidance: float, cache_interval: int, draws: Sequence[Draws]):
    """The noisy requests' DDIM, tick by tick: at each engine tick the
    requests that stepped there step together, each at its own step
    index, the refresh and skip passes apart, on that tick's keys."""
    at: Dict[int, List] = collections.defaultdict(list)
    for j, d in enumerate(draws):
        for i, k in enumerate(d.ticks):
            at[k].append((j, i))
    cached = cache_interval > 1
    deep_c: Dict[int, torch.Tensor] = {}
    deep_u: Dict[int, torch.Tensor] = {}
    x = x.clone()
    for k in sorted(at):
        step0 = draws[at[k][0][0]].slot0_step.get(k)
        t0 = int(ts[step0]) if step0 is not None else 0
        kc, ku = bases(draws[0].seed, k, t0, cached, num.tick_shift)
        full = [(j, i) for j, i in at[k] if not cached
                or i % cache_interval == 0]
        skip = [(j, i) for j, i in at[k] if (j, i) not in full]
        for part, refresh in ((full, True), (skip, False)):
            if not part:
                continue
            rows = [j for j, _ in part]
            slots = [draws[j].slot for j in rows]
            xr = x[rows]
            tb = torch.tensor([int(ts[i]) for _, i in part],
                              dtype=torch.long, device=x.device)
            ctx = context[rows] if context is not None else None
            dc = None if refresh else torch.stack([deep_c[j] for j in rows])
            eps, dc = unet(num, p, c, xr, tb, ctx, True, dc,
                           Stream(kc, slots))
            if guidance > 0.0:
                du = None if refresh else torch.stack([deep_u[j]
                                                       for j in rows])
                eps_u, du = unet(num, p, c, xr, tb, None, True, du,
                                 Stream(ku, slots))
                eps = eps_u + guidance * (eps - eps_u)
            for r, (j, i) in enumerate(part):
                if refresh and cached:
                    deep_c[j] = dc[r]
                    if guidance > 0.0:
                        deep_u[j] = du[r]
                t_prev = int(ts[i + 1]) if i + 1 < len(ts) else -1
                x[j] = ddim_update(ab, xr[r:r + 1], eps[r:r + 1], int(ts[i]),
                                   t_prev)[0]
    return x


def context_rows(seed: int, rows: int, tokens: int, dim: int,
                 device) -> torch.Tensor:
    """The seeded stand-in for the text encoder's output: (rows, tokens,
    dim) standard normals from the seed, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 7919 + 17) % (1 << 63))
    return torch.randn(rows, tokens, dim, generator=gen, device=device)


def image_errors(served: torch.Tensor, ref: torch.Tensor):
    """(relative RMS, max abs) distance of a served image from the
    reference's."""
    d = served.double() - ref.double()
    rel = float(torch.sqrt((d ** 2).mean() / (ref.double() ** 2).mean()))
    return rel, float(d.abs().max())

