"""
SynthStrip's image synthesis (neurite `labels_to_image`, reference
`neurite/tf/models.py:649-917`) from given random draws, in plain float32
PyTorch.

The draws are the raw random tensors of one call, keyed as the program's
`LabelsToImageV1.draw` keys them: 'warp' and 'bias' (per batch item, a
list of (SD, normal field) per Perlin scale), 'mean' and 'std'
[B, 1, L], 'noise' [B, *shape, 1], 'background' and 'gamma'
[B, 1, 1, 1, 1], 'blur' (three 0-d SDs). The stages, in order: the
Perlin fields (each scale's SD times its field, resized to the target
with corner-aligned linear interpolation, summed); the velocity field at
half resolution integrated by 5 squarings (linear interpolation, edge
values outside); the displacement doubled and resized x2; the label map
warped by it (nearest, half to even; 0 where a point falls outside);
per-label normal intensities; the background zeroed where the draw says;
a separable Gaussian blur of 7 taps with zero padding; the bias field
(exp); a clip to [0, 255]; min-max normalisation; a log-normal gamma; and
the brain map, labels 1-11 of 0-15 as 1, the rest 0.
"""

import itertools

import torch
import torch.nn.functional as F


def resize_to(field, shape):
    """field [*s, C] resized to [*shape, C] by corner-aligned linear
    interpolation (the grid linspace(0, n - 1, new) on each axis)."""
    if tuple(field.shape[:-1]) == tuple(shape):
        return field
    x = field.permute(3, 0, 1, 2)[None]
    y = F.interpolate(x, size=tuple(shape), mode='trilinear',
                      align_corners=True)
    return y[0].permute(1, 2, 3, 0)


def perlin(scales, shape):
    """The Perlin field [*shape, C] of one item's scales."""
    return sum(resize_to(sd * noise, shape) for sd, noise in scales)


def grid(shape, device):
    axes = [torch.arange(n, dtype=torch.float32, device=device)
            for n in shape]
    return torch.stack(torch.meshgrid(*axes, indexing='ij'), -1)


def linear_at(vol, loc):
    """vol [*s, C] at the points loc [*t, 3], trilinear; coordinates
    outside are moved to the nearest edge."""
    hi = torch.tensor([n - 1 for n in vol.shape[:3]], device=vol.device,
                      dtype=loc.dtype)
    loc = torch.minimum(torch.maximum(loc, torch.zeros_like(hi)), hi)
    lo = torch.floor(loc)
    up = torch.minimum(lo + 1, hi)
    w_up = loc - lo
    out = 0
    for corner in itertools.product((0, 1), repeat=3):
        idx, wt = [], 1
        for d, c in enumerate(corner):
            idx.append((up if c else lo)[..., d].long())
            wt = wt * (w_up[..., d] if c else 1 - w_up[..., d])
        out = out + wt[..., None] * vol[idx[0], idx[1], idx[2]]
    return out


def nearest_at(vol, loc, fill):
    """vol [*s, C] at the points loc [*t, 3], nearest (half to even);
    `fill` where a point lies outside [0, n - 1] on some axis."""
    hi = [n - 1 for n in vol.shape[:3]]
    r = torch.round(loc).long()
    idx = [r[..., d].clamp(0, hi[d]) for d in range(3)]
    out = vol[idx[0], idx[1], idx[2]]
    outside = torch.zeros(loc.shape[:-1], dtype=torch.bool,
                          device=loc.device)
    for d in range(3):
        outside |= (loc[..., d] < 0) | (loc[..., d] > hi[d])
    return torch.where(outside[..., None], torch.full_like(out, fill), out)


def gaussian_taps(sigma, width):
    """The normalised 1-D Gaussian of SD `sigma` (0-d tensor) on `width`
    taps centred on the middle one."""
    i = torch.arange(width, dtype=torch.float32, device=sigma.device)
    k = torch.exp(-0.5 * (i - (width - 1) / 2) ** 2 / sigma ** 2)
    return k / k.sum()


def blur(image, sigmas, width=7):
    """Separable SAME blur of image [*s] with zero padding."""
    x = image[None, None]
    for axis, sigma in enumerate(sigmas):
        shape = [1, 1, 1, 1, 1]
        shape[2 + axis] = width
        pad = [0] * 6
        pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = width // 2
        x = F.conv3d(F.pad(x, pad), gaussian_taps(sigma, width).reshape(shape))
    return x[0, 0]


def synthesize(labels, draws, labels_in=16, brain=range(1, 12),
               zero_background=0.2, gamma_std=0.25, blur_width=7):
    """(image [B, *s, 1], brain map [B, *s, 1] float32) of integer labels
    [B, *s, 1] in 0..labels_in - 1, from `draws`."""
    images, maps = [], []
    for b in range(labels.shape[0]):
        lab = labels[b, ..., 0].long()
        shape = lab.shape
        dev = lab.device
        half = tuple(n // 2 for n in shape)
        vel = perlin(draws['warp'][b], half)                 # [*half, 3]
        vec = vel / 2. ** 5
        g_half = grid(half, dev)
        for _ in range(5):
            vec = vec + linear_at(vec, g_half + vec)
        disp = resize_to(vec * 2, shape)                     # [*s, 3]
        warped = nearest_at(lab[..., None].to(torch.float32),
                            grid(shape, dev) + disp, 0.)[..., 0].long()
        mean = draws['mean'][b, 0][warped.clamp(0, labels_in - 1)]
        std = draws['std'][b, 0][warped.clamp(0, labels_in - 1)]
        image = draws['noise'][b, ..., 0] * std + mean
        if zero_background > 0:
            off = (warped == 0) & (draws['background'][b].reshape(())
                                   < zero_background)
            image = image * (1. - off.to(image.dtype))
        image = blur(image, draws['blur'], blur_width)
        image = image * torch.exp(perlin(draws['bias'][b], shape)[..., 0])
        image = image.clamp(0, 255)
        lo, hi = image.min(), image.max()
        image = torch.where(hi == lo, torch.zeros_like(image),
                            (image - lo) / torch.where(hi == lo,
                                                       torch.ones_like(hi),
                                                       hi - lo))
        image = image ** torch.exp(gamma_std * draws['gamma'][b].reshape(()))
        table = torch.zeros(labels_in, device=dev)
        table[list(brain)] = 1.
        images.append(image[..., None])
        maps.append(table[warped.clamp(0, labels_in - 1)][..., None])
    return torch.stack(images), torch.stack(maps)
