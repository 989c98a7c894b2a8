"""
A plain float32 UNet (neurite `models.unet`): its layer list, its weights
from a seed, its forward pass, and its operation count.

Nothing here imports the program. The layer list follows neurite's
`unet` (reference `neurite/tf/models.py:88-246`, `conv_enc:1309-1442`,
`conv_dec:1445-1617`): per encoder level `nb_conv_per_level` SAME convs
with ELU, a 2x max pool between levels; per decoder level a 2x nearest
upsample, the concat [skip, up], the convs; a final 1x1 'likelihood' conv
and the prediction activation. Parameter names are those of the program's
module tree, so one weight dict loads into both.

Tensors are channels-last [B, *spatial, C] at the boundary, as in the
program; inside, channels-first for `F.conv3d`.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F


def level_feats(cfg, level):
    """Feature counts of one level's convs (neurite's `_level_feats`
    without the `layer_nb_feats` override)."""
    nf = cfg['nb_features']
    per = cfg['nb_conv_per_level']
    if isinstance(nf, list):
        return [int(nf[level])] * per
    return [int(np.round(nf * cfg['feat_mult'] ** level))] * per


def nb_levels(cfg):
    nf = cfg['nb_features']
    return len(nf) if isinstance(nf, list) else int(cfg['nb_levels'])


def layers(cfg, prefix=''):
    """[(name, kind, c_in, c_out, level)] in forward order; kind is 'conv'
    (k^3 SAME) or 'dense' (the 1x1 likelihood); level is the resolution
    level the layer runs at (0 = full)."""
    n = nb_levels(cfg)
    out, ch, skips = [], int(cfg['in_channels']), []
    for level in range(n):
        for c, f in enumerate(level_feats(cfg, level)):
            out.append((f'{prefix}enc.conv_downarm_{level}_{c}', 'conv', ch,
                        f, level))
            ch = f
        skips.append(ch)
    for dl in range(n - 1):
        lindex = n - 2 - dl
        ch = skips[lindex] + ch
        for c, f in enumerate(level_feats(cfg, lindex)):
            out.append((f'{prefix}dec.conv_uparm_{n + dl}_{c}', 'conv', ch, f,
                        lindex))
            ch = f
    out.append((f'{prefix}dec.likelihood', 'dense', ch,
                int(cfg['nb_labels']), 0))
    return out


def param_shapes(cfg, prefix=''):
    """{name: (shape, fan_in)} of every parameter, in forward order."""
    k = int(cfg['conv_size'])
    shapes = {}
    for name, kind, cin, cout, _ in layers(cfg, prefix):
        if kind == 'conv':
            shapes[f'{name}.weight'] = ((cout, cin, k, k, k), cin * k ** 3)
        else:
            shapes[f'{name}.weight'] = ((cin, cout), cin)
        shapes[f'{name}.bias'] = ((cout,), None)
    return shapes


def make_weights(cfg, seed, device, prefix=''):
    """{name: float32 tensor} drawn on `device` from one generator seeded by
    `seed`, in one call: kernels normal with variance 1 / fan_in, clipped
    at two SDs (lecun normal, truncated by clipping); biases normal with SD
    0.01, so that the bias path is exercised."""
    shapes = param_shapes(cfg, prefix)
    total = sum(math.prod(s) for s, _ in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device).clamp_(-2., 2.)
    out, at = {}, 0
    for name, (shape, fan_in) in shapes.items():
        n = math.prod(shape)
        sd = 0.01 if fan_in is None else math.sqrt(1. / fan_in)
        out[name] = (flat[at:at + n] * sd).reshape(shape)
        at += n
    return out


def conv_flops(cfg, shape):
    """Operations of one forward pass at spatial `shape`: 2 k^3 C_in C_out
    per output voxel of each conv, 2 C_in C_out per voxel of the 1x1."""
    k = int(cfg['conv_size'])
    vox = math.prod(shape)
    total = 0
    for _, kind, cin, cout, level in layers(cfg):
        v = vox // 8 ** level
        total += 2 * (k ** 3 if kind == 'conv' else 1) * cin * cout * v
    return total


def fake_fp8(t):
    """t rounded to float8 e4m3 with a per-tensor scale (amax to 448), as
    an fp8 conv would see it; the gradient passes straight through."""
    amax = t.detach().abs().amax().clamp_min(1e-12)
    scale = 448. / amax
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (q - t.detach())


def _operands(x, w, precision):
    if precision == 'fp8':
        return fake_fp8(x), fake_fp8(w)
    if precision == 'bf16':
        return x.to(torch.bfloat16), w.to(torch.bfloat16)
    return x, w


def conv(x, w, b, precision='f32'):
    """SAME conv of channels-first x; `precision` 'f32', 'bf16' or 'fp8'
    (the operands rounded, the sums in float32 or bfloat16)."""
    xo, wo = _operands(x, w, precision)
    y = F.conv3d(xo, wo, None, padding=w.shape[-1] // 2).to(torch.float32)
    return y + b.reshape(1, -1, 1, 1, 1)


def dense(x, w, b, precision='f32'):
    """The 1x1 conv of channels-first x: x . W over the channels."""
    xo, wo = _operands(x, w, precision)
    y = torch.einsum('bc...,cf->bf...', xo, wo).to(torch.float32)
    return y + b.reshape(1, -1, 1, 1, 1)


def forward(cfg, weights, x, precision='f32', prefix=''):
    """The prediction [B, *spatial, nb_labels] of x [B, *spatial, C]."""
    n = nb_levels(cfg)
    h = x.to(torch.float32).permute(0, 4, 1, 2, 3)
    skips = []
    table = layers(cfg, prefix)
    per = cfg['nb_conv_per_level']
    i = 0
    for level in range(n):
        for _ in range(per):
            name = table[i][0]
            h = F.elu(conv(h, weights[f'{name}.weight'],
                           weights[f'{name}.bias'], precision))
            i += 1
        skips.append(h)
        if level < n - 1:
            h = F.max_pool3d(h, 2)
    for dl in range(n - 1):
        lindex = n - 2 - dl
        for d in (2, 3, 4):
            h = h.repeat_interleave(2, dim=d)
        h = torch.cat([skips[lindex], h], dim=1)
        for _ in range(per):
            name = table[i][0]
            h = F.elu(conv(h, weights[f'{name}.weight'],
                           weights[f'{name}.bias'], precision))
            i += 1
    name = table[i][0]
    h = dense(h, weights[f'{name}.weight'], weights[f'{name}.bias'],
              precision)
    if cfg.get('final_activation', 'softmax') == 'softmax':
        h = torch.softmax(h, dim=1)
    return h.permute(0, 2, 3, 4, 1)
