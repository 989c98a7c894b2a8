"""
Offline volume preprocessing utilities (host-side numpy/scipy).

Counterpart of `neurite_tpu/dataproc.py`; capability parity with reference
`neurite/py/dataproc.py` (cites per function). Medical IO goes through
`neurite_tpu_torch.io` (nibabel-free).
"""

import os
import shutil
import sys

import numpy as np

from neurite_tpu_torch import io as neio


def volcrop(vol, crop=None):
    """
    Symmetric N-D crop: `crop` is per-axis voxels to remove (scalar, or list
    of scalars / (lo, hi) pairs). Equivalent of pystrum `nd.volcrop` used at
    reference `dataproc.py:205`.
    """
    vol = np.asarray(vol)
    if crop is None:
        return vol
    if np.isscalar(crop):
        crop = [crop] * vol.ndim
    slices = []
    for d, c in enumerate(crop):
        if c is None:
            slices.append(slice(None))
        elif np.isscalar(c):
            slices.append(slice(c, vol.shape[d] - c if c > 0 else None))
        else:
            lo, hi = c
            slices.append(slice(lo, vol.shape[d] - hi if hi > 0 else None))
    return vol[tuple(slices)]


def vol_proc(vol_data, crop=None, resize_shape=None, interp_order=None,
             rescale=None, rescale_prctle=None, resize_slices=None,
             resize_slices_dim=None, offset=None, clip=None, extract_nd=None,
             force_binary=None, permute=None):
    """
    Offline volume pipeline: offset -> rescale (const or percentile) ->
    resize (scipy zoom) -> crop -> clip -> extract -> binarize.

    Parity: reference `neurite/py/dataproc.py:156-225` (incl. the clip
    postcondition asserts).
    """
    import scipy.ndimage

    if offset is not None:
        vol_data = vol_data + offset

    if rescale is not None:
        vol_data = np.multiply(vol_data, rescale)

    if rescale_prctle is not None:
        rescale = np.percentile(vol_data.flat, rescale_prctle)
        vol_data = np.multiply(vol_data.astype(float), 1 / rescale)

    if resize_slices is not None:
        resize_slices = [*resize_slices]
        assert resize_shape is None, \
            'if resize_slices is given, resize_shape has to be None'
        resize_shape = resize_slices
        if resize_slices_dim is None:
            resize_slices_dim = np.where([f is None for f in resize_slices])[0]
            assert len(resize_slices_dim) == 1, \
                'Could not find dimension or slice resize'
            resize_slices_dim = resize_slices_dim[0]
        resize_shape[resize_slices_dim] = vol_data.shape[resize_slices_dim]

    if resize_shape is not None and tuple(resize_shape) != vol_data.shape:
        resize_shape = [*resize_shape]
        if resize_shape[-1] is None:
            resize_ratio = np.divide(resize_shape[0], vol_data.shape[0])
            resize_shape[-1] = np.round(
                resize_ratio * vol_data.shape[-1]).astype('int')
        resize_ratio = np.divide(resize_shape, vol_data.shape)
        vol_data = scipy.ndimage.zoom(vol_data, resize_ratio,
                                      order=interp_order)

    if crop is not None:
        vol_data = volcrop(vol_data, crop=crop)

    if clip is not None:
        vol_data = np.clip(vol_data, clip[0], clip[1])

    if extract_nd is not None:
        vol_data = vol_data[np.ix_(*extract_nd)]

    if force_binary:
        vol_data = (vol_data > 0).astype(float)

    if clip is not None:
        assert np.max(vol_data) <= clip[1], 'clip failed'
        assert np.min(vol_data) >= clip[0], 'clip failed'
    return vol_data


def proc_mgh_vols(inpath, outpath, ext='.mgz', label_idx=None, **kwargs):
    """
    Convert a directory of mgz/nii volumes to processed npz files.

    Parity: reference `neurite/py/dataproc.py:26-73`.
    """
    files = [f for f in sorted(os.listdir(inpath)) if f.endswith(ext)]
    skipped = []
    for fname in files:
        vol_data = np.asarray(neio.load_volfile(os.path.join(inpath, fname)),
                              float)
        if vol_data.ndim > 3 and vol_data.shape[3] > 1:
            vol_data = vol_data[:, :, :, -1]
        try:
            vol_data = vol_proc(vol_data, **kwargs)
        except Exception as e:
            skipped.append(fname)
            print(f'Skipping {fname}\nError: {e}', file=sys.stderr)
            continue
        if label_idx is not None:
            vol_data = (vol_data == label_idx).astype(int)
        outname = os.path.splitext(os.path.join(outpath, fname))[0] + '.npz'
        np.savez_compressed(outname, vol_data=vol_data)
    for f in skipped:
        print(f'Skipped: {f}', file=sys.stderr)


def scans_to_slices(inpath, outpath, slice_nrs, ext='.mgz', label_idx=None,
                    dim_idx=2, out_ext='.png', slice_pad=0,
                    vol_inner_pad_for_slice_nrs=0, **kwargs):
    """
    Extract 2D slices from a directory of volumes to png or nii.gz.

    Parity: reference `neurite/py/dataproc.py:76-153`.
    """
    files = [f for f in sorted(os.listdir(inpath)) if f.endswith(ext)]
    skipped = []
    for fname in files:
        vol_data = np.asarray(neio.load_volfile(os.path.join(inpath, fname)),
                              float)
        if vol_data.ndim > 3 and vol_data.shape[3] > 1:
            vol_data = vol_data[:, :, :, -1]
        if slice_pad > 0:
            assert out_ext != '.png', 'slice pad can only be used with volumes'
        try:
            vol_data = vol_proc(vol_data, **kwargs)
        except Exception as e:
            skipped.append(fname)
            print(f'Skipping {fname}\nError: {e}', file=sys.stderr)
            continue

        mult_fact = 255
        if label_idx is not None:
            vol_data = (vol_data == label_idx).astype(int)
            mult_fact = 1

        if slice_nrs is None:
            lo = vol_inner_pad_for_slice_nrs + slice_pad
            hi = vol_data.shape[dim_idx] - slice_pad - \
                vol_inner_pad_for_slice_nrs
            slice_nrs_sel = range(lo, hi)
        else:
            slice_nrs_sel = slice_nrs

        for slice_nr in slice_nrs_sel:
            sel = range(slice_nr - slice_pad, slice_nr + slice_pad + 1)
            vol_img = np.squeeze(np.take(vol_data, list(sel), axis=dim_idx))
            base = os.path.splitext(os.path.join(outpath, fname))[0]
            if out_ext == '.png':
                from PIL import Image
                img = (vol_img * mult_fact).astype('uint8')
                Image.fromarray(img).convert('RGB').save(
                    base + f'_slice{slice_nr}.png')
            else:
                if slice_pad == 0:
                    assert vol_img.ndim == 2
                    vol_img = np.expand_dims(vol_img, dim_idx)
                neio.save_nii(base + f'_slice{slice_nr}.nii.gz', vol_img)
    for f in skipped:
        print(f'Skipped: {f}', file=sys.stderr)


def prior_to_weights(prior_filename, nargout=1, min_freq=0,
                     force_binary=False, verbose=False):
    """
    Inverse-frequency class weights from a (3/4)-D prior, with a minimum-
    frequency floor.

    Parity: reference `neurite/py/dataproc.py:228-280`.
    """
    if isinstance(prior_filename, str):
        prior = np.load(prior_filename)['prior']
    else:
        prior = np.asarray(prior_filename)

    assert prior.ndim in (3, 4), 'prior is the wrong number of dimensions'
    prior_flat = np.reshape(prior, (-1, prior.shape[-1]))

    if force_binary:
        nb_labels = prior_flat.shape[-1]
        prior_flat = prior_flat.copy()
        prior_flat[:, 1] = np.sum(prior_flat[:, 1:nb_labels], 1)
        prior_flat = np.delete(prior_flat, range(2, nb_labels), 1)

    class_count = np.sum(prior_flat, 0)
    class_prior = class_count / np.sum(class_count)
    class_prior[class_prior < min_freq] = min_freq
    class_prior = class_prior / np.sum(class_prior)

    if np.any(class_prior == 0):
        print('Warning, found a label with 0 support. '
              'Setting its weight to 0!', file=sys.stderr)
        class_prior[class_prior == 0] = np.inf

    weights = 1 / class_prior
    weights = weights / np.sum(weights)

    if verbose:
        import matplotlib.pyplot as plt
        f, (ax1, ax2, ax3) = plt.subplots(1, 3)
        ax1.bar(range(class_prior.size), np.log(class_prior + 1e-12))
        ax1.set_title('log class freq')
        ax2.bar(range(weights.size), weights)
        ax2.set_title('weights')
        ax3.bar(range(weights.size),
                np.log(weights) - np.min(np.log(weights)))
        ax3.set_title('log(weights)-minlog')
        f.set_size_inches(12, 3)
        plt.show()

    return weights if nargout == 1 else (weights, prior)


def filestruct_change(directory, subject_out_regexp='*', fileout_regexp='*',
                      dirstruct_in='subject_first', dst=None, copy=True):
    """
    Restructure a dataset directory between subject-first and file-first
    layouts.

    Parity: reference `neurite/py/dataproc.py:283-...` (directory shuffling
    with shutil; simplified to the copy/move core).
    """
    import glob
    assert dirstruct_in in ('subject_first', 'file_first')
    assert dst is not None, 'need destination directory'
    os.makedirs(dst, exist_ok=True)
    op = shutil.copy2 if copy else shutil.move

    subjects = sorted(glob.glob(os.path.join(directory, subject_out_regexp)))
    for subj in subjects:
        if not os.path.isdir(subj):
            continue
        name = os.path.basename(subj)
        for f in sorted(glob.glob(os.path.join(subj, fileout_regexp))):
            base = os.path.basename(f)
            if dirstruct_in == 'subject_first':
                outdir = os.path.join(dst, os.path.splitext(base)[0])
                os.makedirs(outdir, exist_ok=True)
                op(f, os.path.join(outdir, name + os.path.splitext(base)[1]))
            else:
                outdir = os.path.join(dst, name)
                os.makedirs(outdir, exist_ok=True)
                op(f, os.path.join(outdir, base))


def ml_split(src, dst=None, ratios=(0.7, 0.15, 0.15),
             names=('train', 'validate', 'test'), seed=None, copy=True):
    """
    Split a directory of files into train/validate/test subdirectories.

    Parity: reference `neurite/py/dataproc.py` ml_split.
    """
    assert len(ratios) == len(names)
    assert abs(sum(ratios) - 1) < 1e-6, 'ratios must sum to 1'
    dst = dst or src
    files = sorted(f for f in os.listdir(src)
                   if os.path.isfile(os.path.join(src, f)))
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(files))
    op = shutil.copy2 if copy else shutil.move

    bounds = np.floor(np.cumsum(ratios) * len(files)).astype(int)
    start = 0
    for name, end in zip(names, bounds):
        outdir = os.path.join(dst, name)
        os.makedirs(outdir, exist_ok=True)
        for i in order[start:end]:
            op(os.path.join(src, files[i]), os.path.join(outdir, files[i]))
        start = end
