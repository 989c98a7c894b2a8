"""
Whole-volume, patch-based segmentation inference (the "serve" path).

Counterpart of `neurite_tpu/utils/seg.py` (reference
`neurite/tf/utils/seg.py`, file:line cites per function). Two forms:

- host-driven (`predict_volumes`): a generator yields patch batches, each
  goes to the model's device, its prediction comes back to numpy, and the
  host quilts the label patches with the reference's nan-median;
- on the device (`predict_volume_device`): the volume stays on its device,
  each patch is sliced, run and added into an overlap-mean quilt there,
  with no host read until the caller reads the result.

`apply_fn` maps a batch tensor [B, *patch, C_in] to [B, *patch, C_out]: a
closure over a model, or the model itself. A model (a `torch.nn.Module`)
runs in eval mode (BatchNorm's running statistics, no dropout) and is put
back in its former mode afterwards; every prediction runs under
`torch.inference_mode()`.
"""

import contextlib
import itertools

import numpy as np
import torch

from neurite_tpu_torch import backend
from neurite_tpu_torch.io import tiling


@contextlib.contextmanager
def _inference(apply_fn):
    """Eval mode for a module apply_fn (restored after) and inference mode."""
    module = apply_fn if isinstance(apply_fn, torch.nn.Module) else None
    was_training = module is not None and module.training
    if module is not None:
        module.eval()
    try:
        with torch.inference_mode():
            yield
    finally:
        if was_training:
            module.train()


def _predict(apply_fn, x, device):
    """apply_fn on batch x moved to `device`, as numpy."""
    with _inference(apply_fn):
        return backend.to_numpy(apply_fn(torch.as_tensor(x, device=device)))


def predict_volume_stack(apply_fn, data_generator, batch_size, nb_patches,
                         verbose=False, device=None):
    """
    Pull `nb_patches` worth of (input, output) patch batches from
    `data_generator`, run `apply_fn` on each input batch on `device` (the
    card by default), and return stacked numpy arrays (vol, true, pred) —
    reference `predict_volume_stack` (`seg.py:138-227`). Generator items
    may be (input, output) pairs or bare inputs, numpy or tensors; true is
    None for bare inputs.
    """
    device = backend.resolve_device(device)
    vols, trues, preds = [], [], []
    done = 0
    while done < nb_patches:
        batch = next(data_generator)
        if isinstance(batch, (tuple, list)):
            x, y = batch[0], batch[1]
        else:
            x, y = batch, None
        preds.append(_predict(apply_fn, x, device))
        vols.append(backend.to_numpy(x))
        if y is not None:
            trues.append(backend.to_numpy(y))
        done += vols[-1].shape[0]
        if verbose:
            print(f'predict_volume_stack: {done}/{nb_patches} patches')
    vol = np.concatenate(vols, 0)[:nb_patches]
    pred = np.concatenate(preds, 0)[:nb_patches]
    true = np.concatenate(trues, 0)[:nb_patches] if trues else None
    return vol, true, pred


def predict_volumes(apply_fn, data_generator, batch_size, patch_size,
                    patch_stride, vol_shape, nan_func='nanmedian',
                    do_extra_vol=False, do_prob_of_true=False,
                    verbose=False, device=None):
    """
    Whole-volume prediction by patches: run `apply_fn` over all patches of
    one volume (`predict_volume_stack`), argmax to labels, and quilt them
    on the host with overlap aggregation — reference `predict_volumes`
    (`seg.py:41-135`).

    Returns (vol_label_pred, vol_label_true[, vol_input, prob_of_true_pred,
    prob_of_true_true if do_extra_vol/do_prob_of_true]); vol_label_true is
    None when the generator yields bare inputs.
    """
    gsize = tiling.grid_size(vol_shape, patch_size, patch_stride)
    nb_patches = int(np.prod(gsize))
    vol, true, pred = predict_volume_stack(
        apply_fn, data_generator, batch_size, nb_patches, verbose=verbose,
        device=device)

    outs = [_quilt(pred_to_label(pred), patch_size, vol_shape, patch_stride,
                   nan_func)]
    if true is not None:
        outs.append(_quilt(pred_to_label(true), patch_size, vol_shape,
                           patch_stride, nan_func))
    else:
        outs.append(None)

    if do_extra_vol:
        vol_in = vol[..., 0] if vol.ndim == len(patch_size) + 2 else vol
        outs.append(_quilt(vol_in, patch_size, vol_shape, patch_stride,
                           nan_func))
        if do_prob_of_true and true is not None:
            true_label = pred_to_label(true)
            outs.append(_quilt(prob_of_label(pred, true_label), patch_size,
                               vol_shape, patch_stride, nan_func))
            outs.append(_quilt(prob_of_label(true, true_label), patch_size,
                               vol_shape, patch_stride, nan_func))
    return tuple(outs)


def pred_to_label(pred):
    """Argmax over the trailing label axis (ref `seg.py:296-300`)."""
    return np.argmax(backend.to_numpy(pred), axis=-1)


def prob_of_label(vol, labelvol):
    """
    Probability each voxel assigns to a given label map: vol [..., L] indexed
    by labelvol [...] (ref `prob_of_label`, `seg.py:230-260`).
    """
    vol, labelvol = backend.to_numpy(vol), backend.to_numpy(labelvol)
    return np.take_along_axis(vol, labelvol[..., None], axis=-1)[..., 0]


def next_label(apply_fn, data_generator, device=None):
    """(true label, pred label) for the next generator batch
    (ref `next_label`, `seg.py:271-279`)."""
    x, y = next(data_generator)[:2]
    pred = _predict(apply_fn, x, backend.resolve_device(device))
    return pred_to_label(y), pred_to_label(pred)


def next_pred_label(apply_fn, data_generator, device=None):
    """(sample, true label, pred label) (ref `seg.py:263-269`)."""
    x, y = next(data_generator)[:2]
    pred = _predict(apply_fn, x, backend.resolve_device(device))
    return x, pred_to_label(y), pred_to_label(pred)


def sample_to_label(sample):
    """Label map of a probabilistic sample (ref `seg.py:282-293`)."""
    return pred_to_label(sample)


def next_vol_pred(apply_fn, data_generator, device=None):
    """(vol, prediction, output, prior) for the next batch, prior None
    unless the input is a (vol, prior) pair (ref `next_vol_pred`,
    `seg.py:302-319`)."""
    batch = next(data_generator)
    if isinstance(batch[0], (tuple, list)):   # (vol, prior) input pairing
        x, prior = batch[0]
    else:
        x, prior = batch[0], None
    pred = _predict(apply_fn, x, backend.resolve_device(device))
    return x, pred, batch[1], prior


def recode(seg, mapping, device=None):
    """
    Remap segmentation labels through a lookup table (ref `recode`,
    `seg.py:322-356`): `mapping` is a dict {old: new} or a sequence where
    position i holds the new label for old label i. One index into the
    table on the label map's device (the card for array input unless
    `device` says otherwise); labels outside the table clip to its ends
    (JAX's `jnp.take(mode='clip')`). Returns int32.
    """
    if not torch.is_tensor(seg) or device is not None:
        seg = torch.as_tensor(seg, device=backend.resolve_device(device))
    if isinstance(mapping, dict):
        lut = np.zeros(max(int(k) for k in mapping) + 1, np.int32)
        for k, v in mapping.items():
            lut[int(k)] = int(v)
    else:
        lut = np.asarray(mapping, np.int32)
    table = torch.as_tensor(lut, device=seg.device)
    return table[seg.long().clamp(0, len(lut) - 1)]


def _quilt(patches, patch_size, vol_shape, stride, nan_func='nanmedian'):
    """Reassemble a flat patch stack into a volume on the host, in float64
    (ref `_quilt`, `seg.py:363-374`), by `tiling.quilt`."""
    agg = nan_func if nan_func in ('nanmean', 'nanmedian', 'mean') \
        else 'nanmedian'
    return tiling.quilt(np.asarray(patches, np.float64), patch_size,
                        tuple(vol_shape), stride, agg=agg)


def predict_volume_device(apply_fn, vol, patch_size, stride=None, agg='mean',
                          device=None):
    """
    Whole-volume patch inference on the device: each patch of `vol` is
    sliced there, run through `apply_fn` and added into an accumulator
    [*vol_shape, C_out] in the prediction's dtype (as JAX's, so a bfloat16
    model accumulates in bfloat16) beside a float32 hit count; no host
    read per patch (JAX's `lax.scan` form of the reference's host loop,
    `seg.py:138-227`).

    apply_fn: [1, *patch_size, C_in] -> [1, *patch_size, C_out].
    vol: [*vol_shape, C_in], a tensor (it stays on its device) or an array
        (moved to `device`, the card by default).
    agg: 'mean' (overlap average) or 'sum'. Returns [*vol_shape, C_out].
    """
    if agg not in ('mean', 'sum'):
        raise ValueError(f"agg must be 'mean' or 'sum', got {agg!r}")
    if not torch.is_tensor(vol) or device is not None:
        vol = torch.as_tensor(vol, device=backend.resolve_device(device))
    ndims = len(patch_size)
    if vol.ndim != ndims + 1:
        raise ValueError(f'vol {tuple(vol.shape)} is not [*vol_shape, C] for '
                         f'patch size {tuple(patch_size)}')
    vol_shape = tuple(vol.shape[:-1])
    axis_starts, psize = tiling.patch_starts(vol_shape, patch_size, stride)
    acc = cnt = None
    with _inference(apply_fn):
        for starts in itertools.product(*axis_starts):
            sl = tuple(slice(s, s + p) for s, p in zip(starts, psize))
            pred = apply_fn(vol[sl][None])[0]
            if acc is None:
                acc = pred.new_zeros((*vol_shape, pred.shape[-1]))
                cnt = torch.zeros(vol_shape, dtype=torch.float32,
                                  device=pred.device)
            acc[sl] += pred
            cnt[sl] += 1
        if agg == 'mean':
            acc = acc / cnt[..., None].to(acc.dtype)
    return acc
