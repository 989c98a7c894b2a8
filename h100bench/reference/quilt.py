"""
Whole-volume prediction by overlapping patches, averaged: the plain form
of patch-based inference (neurite `utils/seg.py:138-227`, aggregation
'mean').
"""

import itertools

import torch


def patch_starts(n, p, stride):
    """Start indices of patches of size p at `stride` along an axis of n
    voxels, the last one flush with the end."""
    starts = list(range(0, max(n - p, 0) + 1, stride))
    if starts[-1] + p < n:
        starts.append(n - p)
    return starts


def predict(fn, vol, patch, stride):
    """The float32 mean of fn over every patch of vol [*spatial, C];
    fn maps [1, *patch, C] to [1, *patch, L]."""
    shape = vol.shape[:-1]
    acc = cnt = None
    for starts in itertools.product(*(patch_starts(n, p, stride)
                                      for n, p in zip(shape, patch))):
        sl = tuple(slice(s, s + p) for s, p in zip(starts, patch))
        pred = fn(vol[sl][None])[0].to(torch.float32)
        if acc is None:
            acc = torch.zeros((*shape, pred.shape[-1]), device=pred.device)
            cnt = torch.zeros(shape, device=pred.device)
        acc[sl] += pred
        cnt[sl] += 1
    return acc / cnt[..., None]
