"""
Host-side data generators over directories of medical volumes.

Counterpart of `neurite_tpu/generators.py`: the same arrays, dtypes and
tuple nesting for the same files and seeds, as host numpy. Capability
parity with reference `neurite/tf/generators.py` (cites per function), with
two additions of the JAX package:

- `VolumeDataset`: a deterministic, index-based sampler (checkpointable
  state) as the preferred alternative to stateful infinite generators;
- `prefetch_to_device`: a background thread puts host batches on the card
  (pinned memory, a copy stream) so the feed overlaps the train step (the
  reference has no prefetch at all). It is the one part of this module
  that moves data to a device.

File IO uses `neurite_tpu_torch.io` (nibabel-free), tiling uses
`neurite_tpu_torch.io.tiling` (pystrum-free), one-hot and relabel the
native host ops (`neurite_tpu_torch.io.native`).
"""

import os
import sys
import threading
import queue as queue_mod
import zipfile

import numpy as np

import torch

from neurite_tpu_torch import backend
from neurite_tpu_torch import io as neio
from neurite_tpu_torch.io import native, tiling


###############################################################################
# primitive generators (reference API)
###############################################################################

def vol(volpath, ext='.npz', batch_size=1, expected_nb_files=-1,
        expected_files=None, data_proc_fn=None, relabel=None,
        nb_labels_reshape=0, keep_vol_size=False, name='single_vol',
        nb_restart_cycle=None, patch_size=None, patch_stride=1,
        collapse_2d=None, extract_slice=None, force_binary=False, nb_feats=1,
        patch_rand=False, patch_rand_seed=None, vol_rand_seed=None,
        binary=False, yield_incomplete_final_batch=True, verbose=False):
    """
    Infinite generator of volume (or volume-patch) batches from a directory.

    Parity: reference `neurite/tf/generators.py:81-262` — circular file
    order (optionally seeded-permuted), per-volume processing fn, relabel,
    patch split, one-hot reshape, nan/inf asserts, multi-feature concat, and
    incomplete-final-batch yielding.
    """
    volfiles = _get_file_list(volpath, ext, vol_rand_seed)
    nb_files = len(volfiles)
    assert nb_files > 0, \
        f'Could not find any files at {volpath} with extension {ext}'

    if expected_nb_files >= 0:
        assert nb_files == expected_nb_files, \
            f'number of files do not match: {nb_files}, {expected_nb_files}'
    if expected_files is not None and volfiles != list(expected_files):
        print('file lists did not match. You should probably stop execution.',
              file=sys.stderr)

    if nb_restart_cycle is None:
        nb_restart_cycle = nb_files

    fileidx = -1
    feat_idx = 0
    batch = []
    vol_data_feats = None
    while True:
        fileidx = (fileidx + 1) % nb_restart_cycle
        vol_data = _load_medical_volume(
            os.path.join(volpath, volfiles[fileidx]), ext, verbose)

        if data_proc_fn is not None:
            vol_data = data_proc_fn(vol_data)
        if relabel is not None:
            vol_data = _relabel(vol_data, relabel)

        assert not np.any(np.isnan(vol_data)), \
            f'Found a nan for {volfiles[fileidx]}'
        assert np.all(np.isfinite(vol_data)), \
            f'Found a inf for {volfiles[fileidx]}'

        this_patch_size = vol_data.shape if patch_size is None else \
            [vol_data.shape[i] if p is None else p
             for i, p in enumerate(patch_size)]
        this_stride = [1] * len(this_patch_size) if patch_size is None else \
            (patch_stride if isinstance(patch_stride, (list, tuple))
             else [patch_stride] * len(this_patch_size))

        pgen = patch(vol_data, list(this_patch_size),
                     patch_stride=list(this_stride),
                     nb_labels_reshape=nb_labels_reshape, batch_size=1,
                     infinite=False, collapse_2d=collapse_2d,
                     patch_rand=patch_rand, patch_rand_seed=patch_rand_seed,
                     keep_vol_size=keep_vol_size)

        patches = list(pgen)
        assert patches, f'Patch generator was empty for file {volfiles[fileidx]}'
        for patch_idx, lpatch in enumerate(patches):
            if feat_idx % nb_feats == 0:
                vol_data_feats = lpatch
            else:
                vol_data_feats = np.concatenate(
                    [vol_data_feats, lpatch], lpatch.ndim - 1)
            feat_idx += 1
            if feat_idx % nb_feats != 0:
                continue

            if binary:
                vol_data_feats = vol_data_feats.astype(bool)
            batch.append(vol_data_feats)

            files_done = (fileidx + 1) % nb_restart_cycle == 0
            final = (yield_incomplete_final_batch and files_done and
                     patch_idx == len(patches) - 1)
            if len(batch) == batch_size or final:
                yield np.vstack(batch)
                batch = []


def patch(vol_data, patch_size, patch_stride=1, nb_labels_reshape=1,
          keep_vol_size=False, batch_size=1, collapse_2d=None,
          patch_rand=False, patch_rand_seed=None, variable_batch_size=False,
          infinite=False):
    """
    Generate patch batches from one volume; supports `.send(batch_size)` for
    variable batches (as used by `add_prior`).

    Parity: reference `neurite/tf/generators.py:265-341`.
    """
    assert batch_size >= 1, 'batch_size should be at least 1'
    vol_data = np.asarray(vol_data)
    if patch_size is None:
        patch_size = list(vol_data.shape)
    patch_size = [vol_data.shape[i] if p is None else p
                  for i, p in enumerate(patch_size)]
    if not isinstance(patch_stride, (list, tuple)):
        patch_stride = [patch_stride] * len(patch_size)

    if variable_batch_size:
        batch_size = yield

    while True:
        gen = tiling.patch_gen(vol_data, patch_size, stride=patch_stride)
        if patch_rand:
            allp = list(gen)
            rng = np.random.default_rng(patch_rand_seed)
            gen = iter([allp[i] for i in rng.permutation(len(allp))])

        stack = []
        empty = True
        for lpatch in gen:
            empty = False
            lpatch = _categorical_prep(lpatch, nb_labels_reshape,
                                       keep_vol_size, patch_size)
            if collapse_2d is not None:
                lpatch = np.squeeze(lpatch, collapse_2d + 1)
            stack.append(lpatch)
            if len(stack) == batch_size:
                out = np.vstack(stack) if batch_size > 1 else stack[0]
                stack = []
                sent = yield out
                if variable_batch_size and sent is not None:
                    batch_size = sent
        assert not empty, \
            f'generator was empty. vol size was {vol_data.shape}'

        if not infinite:
            if stack:
                yield np.vstack(stack)
            break


def vol_seg(volpath, segpath, proc_vol_fn=None, proc_seg_fn=None,
            verbose=False, name='vol_seg', ext='.npz', nb_restart_cycle=None,
            nb_labels_reshape=-1, collapse_2d=None, force_binary=False,
            nb_input_feats=1, relabel=None, vol_rand_seed=None,
            seg_binary=False, vol_subname='norm', seg_subname='aseg',
            **kwargs):
    """
    Paired (volume, segmentation) batches; seg filenames are derived by
    substring replacement (vol_subname -> seg_subname).

    Parity: reference `neurite/tf/generators.py:344-397` (incl. float16
    casts at `:392-393`).
    """
    vol_gen = vol(volpath, **kwargs, ext=ext,
                  nb_restart_cycle=nb_restart_cycle, collapse_2d=collapse_2d,
                  force_binary=False, relabel=None, data_proc_fn=proc_vol_fn,
                  nb_labels_reshape=1, name=name + ' vol', verbose=verbose,
                  nb_feats=nb_input_feats, vol_rand_seed=vol_rand_seed)

    vol_files = [f.replace(vol_subname, seg_subname)
                 for f in _get_file_list(volpath, ext, vol_rand_seed)]
    seg_gen = vol(segpath, **kwargs, ext=ext,
                  nb_restart_cycle=nb_restart_cycle, collapse_2d=collapse_2d,
                  force_binary=force_binary, relabel=relabel,
                  vol_rand_seed=vol_rand_seed, data_proc_fn=proc_seg_fn,
                  nb_labels_reshape=nb_labels_reshape, keep_vol_size=True,
                  expected_files=vol_files, name=name + ' seg',
                  binary=seg_binary, verbose=False)

    while True:
        input_vol = next(vol_gen).astype('float16')
        output_vol = next(seg_gen).astype('float16')
        yield (input_vol, output_vol)


def vol_cat(volpaths, crop=None, resize_shape=None, rescale=None,
            verbose=False, name='vol_cat', ext='.npz', nb_labels_reshape=-1,
            vol_rand_seed=None, **kwargs):
    """
    (volume, one-hot binary category) pairs from two folders, shuffled order.

    Parity: reference `neurite/tf/generators.py:399-459`.
    """
    from neurite_tpu_torch import dataproc as nrn_proc

    folders = sorted(os.listdir(volpaths))
    proc_vol_fn = lambda x: nrn_proc.vol_proc(
        x, crop=crop, resize_shape=resize_shape, interp_order=2,
        rescale=rescale)

    gens, gen_lens = [], []
    for folder in folders:
        gens.append(vol(os.path.join(volpaths, folder), **kwargs, ext=ext,
                        vol_rand_seed=vol_rand_seed, data_proc_fn=proc_vol_fn,
                        nb_labels_reshape=1, name=folder, verbose=False))
        gen_lens.append(len(_get_file_list(os.path.join(volpaths, folder),
                                           ext)))

    rng = np.random.default_rng(vol_rand_seed)
    while True:
        order = np.concatenate([np.full(n, i) for i, n in enumerate(gen_lens)])
        rng.shuffle(order)
        for idx in order:
            z = np.zeros([1, len(gens)])
            z[0, idx] = 1
            data = next(gens[idx]).astype('float32')
            yield (data, z)


def add_prior(gen, proc_vol_fn=None, proc_seg_fn=None, prior_type='location',
              prior_file=None, prior_feed='input', patch_stride=1,
              patch_size=None, batch_size=1, collapse_2d=None,
              extract_slice=None, force_binary=False, verbose=False,
              patch_rand=False, patch_rand_seed=None, vol_size=None):
    """
    Append a matched prior batch to an existing generator's samples.

    Parity: reference `neurite/tf/generators.py:462-540`. NOTE: the reference
    location-prior path references an undefined `vol_size` (`generators.py:
    485` — a latent bug); here it is an explicit argument.
    """
    if prior_type == 'location':
        assert vol_size is not None, \
            'location priors require vol_size (undefined in the reference!)'
        grids = np.meshgrid(*[np.arange(s) for s in vol_size], indexing='ij')
        prior_vol = np.stack(grids, -1).astype('float16')  # [x, y, z, N]
    elif prior_type == 'file':
        data = np.load(prior_file)
        prior_vol = data['prior'].astype('float16')
    else:
        prior_vol = np.asarray(prior_file).astype('float16')

    if force_binary:
        nb_labels = prior_vol.shape[-1]
        prior_vol[..., 1] = np.sum(prior_vol[..., 1:nb_labels], -1)
        prior_vol = np.delete(prior_vol, range(2, nb_labels), -1)

    nb_channels = prior_vol.shape[-1]

    if extract_slice is not None:
        if isinstance(extract_slice, int):
            prior_vol = prior_vol[:, :, extract_slice, np.newaxis, :]
        else:
            prior_vol = prior_vol[:, :, extract_slice, :]

    assert prior_vol.ndim in (3, 4), 'prior is the wrong size'

    if patch_size is None:
        patch_size = prior_vol.shape[0:3]
    if not isinstance(patch_stride, (list, tuple)):
        patch_stride = [patch_stride] * len(patch_size)
    prior_gen = patch(prior_vol, [*patch_size, nb_channels],
                      patch_stride=[*patch_stride, nb_channels],
                      batch_size=batch_size, collapse_2d=collapse_2d,
                      keep_vol_size=True, infinite=True,
                      patch_rand=patch_rand, patch_rand_seed=patch_rand_seed,
                      variable_batch_size=True, nb_labels_reshape=0)
    assert next(prior_gen) is None, 'bad prior gen setup'

    while True:
        gen_sample = next(gen)
        gs_sample = _get_shape(gen_sample)
        prior_batch = prior_gen.send(gs_sample)
        yield (gen_sample, prior_batch)


def _with_prior(base_gen, prior_feed, **prior_kwargs):
    pgen = add_prior(base_gen, **prior_kwargs)
    while True:
        gen_sample, prior_batch = next(pgen)
        input_vol, output_vol = gen_sample
        if prior_feed == 'input':
            yield ([input_vol, prior_batch], output_vol)
        else:
            assert prior_feed == 'output'
            yield (input_vol, [output_vol, prior_batch])


def vol_prior(*args, proc_vol_fn=None, proc_seg_fn=None,
              prior_type='location', prior_file=None, prior_feed='input',
              patch_stride=1, patch_size=None, batch_size=1, collapse_2d=None,
              extract_slice=None, force_binary=False, nb_input_feats=1,
              verbose=False, vol_rand_seed=None, patch_rand=False,
              vol_size=None, **kwargs):
    """
    Volume batches with priors attached (ref `generators.py:543-620`).
    The base generator yields (vol, vol) pairs like an autoencoder feed.
    """
    patch_rand_seed = np.random.random() if patch_rand else None
    base = vol(*args, **kwargs, collapse_2d=collapse_2d, force_binary=False,
               verbose=verbose, patch_size=patch_size,
               patch_stride=patch_stride, batch_size=batch_size,
               vol_rand_seed=vol_rand_seed, patch_rand=patch_rand,
               patch_rand_seed=patch_rand_seed, nb_feats=nb_input_feats,
               nb_labels_reshape=1)
    paired = ((v, v) for v in base)
    yield from _with_prior(paired, prior_feed, proc_vol_fn=proc_vol_fn,
                           proc_seg_fn=proc_seg_fn, prior_type=prior_type,
                           prior_file=prior_file, patch_stride=patch_stride,
                           patch_size=patch_size, batch_size=batch_size,
                           collapse_2d=collapse_2d,
                           extract_slice=extract_slice,
                           force_binary=force_binary, verbose=verbose,
                           patch_rand=patch_rand,
                           patch_rand_seed=patch_rand_seed,
                           vol_size=vol_size)


def vol_seg_prior(*args, proc_vol_fn=None, proc_seg_fn=None,
                  prior_type='location', prior_file=None, prior_feed='input',
                  patch_stride=1, patch_size=None, batch_size=1,
                  collapse_2d=None, extract_slice=None, force_binary=False,
                  nb_input_feats=1, verbose=False, vol_rand_seed=None,
                  patch_rand=None, vol_size=None, **kwargs):
    """(vol, seg) batches with priors attached (ref `generators.py:623-691`)."""
    patch_rand_seed = np.random.random() if patch_rand else None
    base = vol_seg(*args, **kwargs, proc_vol_fn=proc_vol_fn,
                   proc_seg_fn=proc_seg_fn, collapse_2d=collapse_2d,
                   force_binary=force_binary, verbose=verbose,
                   patch_size=patch_size, patch_stride=patch_stride,
                   batch_size=batch_size, vol_rand_seed=vol_rand_seed,
                   patch_rand=patch_rand, patch_rand_seed=patch_rand_seed,
                   nb_input_feats=nb_input_feats)
    yield from _with_prior(base, prior_feed, prior_type=prior_type,
                           prior_file=prior_file, patch_stride=patch_stride,
                           patch_size=patch_size, batch_size=batch_size,
                           collapse_2d=collapse_2d,
                           extract_slice=extract_slice,
                           force_binary=force_binary, verbose=verbose,
                           patch_rand=patch_rand,
                           patch_rand_seed=patch_rand_seed,
                           vol_size=vol_size)


def vol_seg_hack(volpath, segpath=None, proc_vol_fn=None, proc_seg_fn=None,
                 verbose=False, name='vol_seg', ext='.npz',
                 nb_restart_cycle=None, nb_labels_reshape=-1,
                 collapse_2d=None, force_binary=False, nb_input_feats=1,
                 relabel=None, vol_rand_seed=None, seg_binary=False,
                 vol_subname='norm', seg_subname='aseg', **kwargs):
    """
    Reference `vol_seg_hack` (`generators.py:797-834`): despite the name it
    yields ONLY the input volume (float16) — an autoencoder-style feed
    (`segpath`/seg args are accepted for signature parity and unused, as in
    the reference). Distinct from `vol_seg`, which yields (vol, seg) pairs.
    """
    vol_gen = vol(volpath, **kwargs, ext=ext,
                  nb_restart_cycle=nb_restart_cycle, collapse_2d=collapse_2d,
                  force_binary=False, relabel=None, data_proc_fn=proc_vol_fn,
                  nb_labels_reshape=1, name=name + ' vol', verbose=verbose,
                  nb_feats=nb_input_feats, vol_rand_seed=vol_rand_seed)
    while True:
        yield next(vol_gen).astype('float16')


def vol_prior_hack(*args, proc_vol_fn=None, proc_seg_fn=None,
                   prior_type='location', prior_file=None,
                   prior_feed='input', patch_stride=1, patch_size=None,
                   batch_size=1, collapse_2d=None, extract_slice=None,
                   force_binary=False, nb_input_feats=1, verbose=False,
                   vol_rand_seed=None, vol_size=None, **kwargs):
    """
    Reference `vol_prior_hack` (`generators.py:694-791`): autoencoding
    batches with an inline (non-send) prior —
    yields ([input_vol, prior_batch], input_vol) for prior_feed='input' or
    (input_vol, [input_vol, prior_batch]) for 'output'. NOTE the target is
    the INPUT volume (not a segmentation), unlike `vol_prior`'s wiring of a
    paired generator. The reference's undefined `vol_size` in the
    location-prior path (`generators.py:729`) is an explicit argument here.
    """
    gen = vol_seg_hack(*args, **kwargs, proc_vol_fn=proc_vol_fn,
                       proc_seg_fn=proc_seg_fn, collapse_2d=collapse_2d,
                       extract_slice=extract_slice,
                       force_binary=force_binary, verbose=verbose,
                       patch_size=patch_size, patch_stride=patch_stride,
                       batch_size=batch_size, vol_rand_seed=vol_rand_seed,
                       nb_input_feats=nb_input_feats)

    if prior_type == 'location':
        assert vol_size is not None, \
            'location priors require vol_size (undefined in the reference!)'
        grids = np.meshgrid(*[np.arange(s) for s in vol_size], indexing='ij')
        prior_vol = np.stack(grids, -1).astype('float16')
    elif prior_type == 'file':
        prior_vol = np.load(prior_file)['prior'].astype('float16')
    else:
        prior_vol = np.asarray(prior_file)
        if prior_vol.dtype != np.float16:
            prior_vol = prior_vol.astype('float16')

    if force_binary:
        nb_labels = prior_vol.shape[-1]
        prior_vol[..., 1] = np.sum(prior_vol[..., 1:nb_labels], -1)
        prior_vol = np.delete(prior_vol, range(2, nb_labels), -1)
    nb_channels = prior_vol.shape[-1]

    if extract_slice is not None:
        if isinstance(extract_slice, int):
            prior_vol = prior_vol[:, :, extract_slice, np.newaxis, :]
        else:
            prior_vol = prior_vol[:, :, extract_slice, :]
    assert prior_vol.ndim in (3, 4), 'prior is the wrong size'

    if patch_size is None:
        patch_size = prior_vol.shape[0:3]
    if not isinstance(patch_stride, (list, tuple)):
        patch_stride = [patch_stride] * len(patch_size)
    # inline (non-send) prior batches: plain next() on an infinite patch gen
    prior_gen = patch(prior_vol, [*patch_size, nb_channels],
                      patch_stride=[*patch_stride, nb_channels],
                      batch_size=batch_size, collapse_2d=collapse_2d,
                      keep_vol_size=True, infinite=True, nb_labels_reshape=0)

    while True:
        input_vol = next(gen)
        prior_batch = next(prior_gen)
        if prior_feed == 'input':
            yield ([input_vol, prior_batch], input_vol)
        else:
            assert prior_feed == 'output'
            yield (input_vol, [input_vol, prior_batch])


def vol_sr_slices(volpath, nb_input_slices, nb_slice_spacing, batch_size=1,
                  ext='.npz', vol_rand_seed=None, nb_restart_cycle=None,
                  name='vol_sr_slices', rand_slices=True,
                  simulate_whole_sparse_vol=False, verbose=False):
    """
    Slice-wise super-resolution pairs: thick-slice inputs (every
    nb_slice_spacing+1-th slice) vs dense outputs.

    Parity: reference `neurite/tf/generators.py:837-929` (three modes:
    simulated sparse volume / random starts / sequential).
    """
    volfiles = _get_file_list(volpath, ext, vol_rand_seed)
    nb_files = len(volfiles)
    if nb_restart_cycle is None:
        nb_restart_cycle = nb_files
    nb_slices_in_subvol = (nb_input_slices - 1) * (nb_slice_spacing + 1) + 1
    rng = np.random.default_rng(vol_rand_seed)

    def indices_to_batch(vol_data, start_indices):
        ins, outs = [], []
        for idx in start_indices:
            outs.append(vol_data[:, :, idx:idx + nb_slices_in_subvol])
            ins.append(vol_data[:, :, idx:idx + nb_slices_in_subvol:
                                (nb_slice_spacing + 1)])
        input_batch = np.stack(ins)
        output_batch = np.stack(outs).reshape(len(start_indices), -1,
                                              outs[0].shape[-1])
        return input_batch, output_batch

    fileidx = -1
    while True:
        fileidx = (fileidx + 1) % nb_restart_cycle
        vol_data = _load_medical_volume(
            os.path.join(volpath, volfiles[fileidx]), ext, verbose)
        nb_slices = vol_data.shape[2]
        nb_start_slices = nb_slices - nb_slices_in_subvol + 1

        if simulate_whole_sparse_vol:
            init_slice = int(rng.integers(0, nb_start_slices - 1)) \
                if rand_slices else 0
            all_starts = list(range(init_slice, nb_start_slices,
                                    nb_slice_spacing + 1))
            for bs in range(0, len(all_starts) - batch_size + 1, batch_size):
                yield indices_to_batch(vol_data, all_starts[bs:bs + batch_size])
        elif rand_slices:
            starts = rng.choice(nb_start_slices, size=batch_size,
                                replace=False)
            yield indices_to_batch(vol_data, list(starts))
        else:
            for bs in range(0, nb_start_slices - batch_size + 1, batch_size):
                yield indices_to_batch(vol_data,
                                       list(range(bs, bs + batch_size)))


def img_seg(volpath, segpath, batch_size=1, verbose=False,
            nb_restart_cycle=None, name='img_seg', ext='.png',
            vol_rand_seed=None, **kwargs):
    """
    2D (image/255, one-hot binary seg) batches from png directories.

    Parity: reference `neurite/tf/generators.py:932-972` (modern imageio via
    PIL instead of the ancient scipy.misc.imread).
    """
    from PIL import Image

    def imggen(path, ext, cycle=None):
        files = _get_file_list(path, ext, vol_rand_seed)
        if cycle is None:
            cycle = len(files)
        idx = -1
        while True:
            idx = (idx + 1) % cycle
            im = np.asarray(Image.open(os.path.join(path, files[idx])))
            if im.ndim == 3:
                im = im[:, :, 0]
            yield im.reshape((1,) + im.shape)

    img_gen = imggen(volpath, ext, nb_restart_cycle)
    seg_gen = imggen(segpath, ext)

    while True:
        input_vol = np.vstack([next(img_gen).astype('float16') / 255
                               for _ in range(batch_size)])
        input_vol = np.expand_dims(input_vol, axis=-1)
        output_vols = [_to_categorical(next(seg_gen).astype('int8'),
                                       num_classes=2)
                       for _ in range(batch_size)]
        output_vol = np.vstack([np.expand_dims(f, axis=0)
                                for f in output_vols])
        yield (input_vol, output_vol)


###############################################################################
# index-based dataset + device prefetch
###############################################################################

class VolumeDataset:
    """
    Deterministic, index-based volume dataset: files x patches addressable by
    a single integer index, shuffled per epoch from a seed — the state
    (epoch, position, seed) is trivially checkpointable, unlike stateful
    infinite generators (SURVEY.md §5.4).
    """

    def __init__(self, volpath, ext='.npz', data_proc_fn=None, relabel=None,
                 patch_size=None, patch_stride=None, nb_labels_reshape=0,
                 seed=0):
        self.volpath = volpath
        self.ext = ext
        self.files = _get_file_list(volpath, ext)
        assert self.files, f'no files at {volpath} with extension {ext}'
        self.data_proc_fn = data_proc_fn
        self.relabel = relabel
        self.nb_labels_reshape = nb_labels_reshape
        self.seed = seed

        first = self._load(0)
        self.vol_shape = first.shape
        self.patch_size = tuple(patch_size) if patch_size else None
        self.patch_stride = patch_stride
        if self.patch_size:
            self.grid = tiling.grid_size(first.shape[:len(self.patch_size)],
                                         self.patch_size, patch_stride)
            self.patches_per_vol = int(np.prod(self.grid))
        else:
            self.patches_per_vol = 1

    def __len__(self):
        return len(self.files) * self.patches_per_vol

    def _load(self, file_idx):
        data = _load_medical_volume(
            os.path.join(self.volpath, self.files[file_idx]), self.ext)
        if self.data_proc_fn is not None:
            data = self.data_proc_fn(data)
        if self.relabel is not None:
            data = _relabel(data, self.relabel)
        return data

    def __getitem__(self, index):
        file_idx, patch_idx = divmod(index, self.patches_per_vol)
        data = self._load(file_idx)
        if self.patch_size:
            starts, psize = tiling.patch_starts(
                data.shape[:len(self.patch_size)], self.patch_size,
                self.patch_stride)
            coords = np.unravel_index(patch_idx, self.grid)
            sl = tuple(slice(s[c], s[c] + p)
                       for s, c, p in zip(starts, coords, psize))
            data = data[sl]
        lpatch = _categorical_prep(data, self.nb_labels_reshape, True,
                                   self.patch_size)
        return lpatch[0]

    def epoch_order(self, epoch):
        rng = np.random.default_rng((self.seed, epoch))
        return rng.permutation(len(self))

    def batches(self, batch_size, start_step=0, epochs=None, num_workers=0):
        """Infinite (or bounded) deterministic batch iterator, resumable from
        a global step. With `num_workers` > 0 the per-item loads (disk IO +
        preprocessing, the reference's single-threaded hot path — SURVEY
        §3.2) run on a thread pool; determinism is unchanged since items are
        assembled in index order."""
        per_epoch = max(1, len(self) // batch_size)
        pool = None
        if num_workers:
            from concurrent.futures import ThreadPoolExecutor
            pool = ThreadPoolExecutor(max_workers=num_workers)
        try:
            step = start_step
            while epochs is None or step < epochs * per_epoch:
                epoch, pos = divmod(step, per_epoch)
                order = self.epoch_order(epoch)
                idx = order[pos * batch_size:(pos + 1) * batch_size]
                if pool is not None:
                    items = list(pool.map(self.__getitem__, idx))
                else:
                    items = [self[i] for i in idx]
                yield np.stack(items)
                step += 1
        finally:
            if pool is not None:
                pool.shutdown(wait=False)


def _tree_map(fn, tree):
    """fn over the leaves of nested tuples, lists and dicts, keeping their
    types (namedtuples too), as `jax.tree_util.tree_map` maps a batch."""
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    out = []
    _tree_map(out.append, tree)
    return out


def _host_array(a):
    """A numpy array for an array-like leaf of a batch, None for a leaf
    that is not one (a string, None), which the puts pass through."""
    if not isinstance(a, (np.ndarray, np.generic, bool, int, float)):
        return None
    a = np.asarray(a)
    # torch takes native byte order only (MGH volumes load big-endian)
    return a if a.dtype.isnative else a.astype(a.dtype.newbyteorder('='))


def _cpu_put(a):
    if torch.is_tensor(a):
        return a.cpu()
    h = _host_array(a)
    if h is None:
        return a
    return torch.from_numpy(h if h.flags.writeable else h.copy())


def to_device(batch, device, stream=None):
    """
    Put a host batch on CUDA `device` through pinned memory: each numpy
    array (a leaf of nested tuples, lists and dicts) is copied into a pinned
    host buffer, then to the device with `non_blocking=True` on `stream`
    (the device's current stream when None), where its device tensor is
    allocated too. Tensor leaves are copied the same way; other leaves are
    kept. Returns (device batch, pinned buffers, event): the event is
    recorded on `stream` after the copies, and a pinned buffer must stay
    unwritten until it has completed.
    """
    device = torch.device(device)
    stream = stream or torch.cuda.current_stream(device)
    pinned = []

    def put(a):
        if torch.is_tensor(a):
            h = a.detach().cpu()
        else:
            arr = _host_array(a)
            if arr is None:
                return a
            h = torch.from_numpy(np.ascontiguousarray(arr))
        p = torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
        p.copy_(h)
        pinned.append(p)
        return torch.empty(p.shape, dtype=p.dtype, device=device).copy_(
            p, non_blocking=True)

    with torch.cuda.device(device), torch.cuda.stream(stream):
        out = _tree_map(put, batch)
        event = torch.cuda.Event()
        event.record(stream)
    return out, pinned, event


class _Raised:
    """The producer's exception, for the consumer to raise."""

    def __init__(self, exc):
        self.exc = exc


_END = object()


def prefetch_to_device(iterator, size=2, devices_put=None, device=None):
    """
    Background-thread prefetch of host batches onto a device, `size`
    batches ahead (double buffering by default). Returns a generator of the
    device batches, in order.

    device: None (the card: `backend.default_device()`, which raises where
        there is none) or a device. On a CUDA device each batch goes through
        `to_device` on a copy stream of its own: numpy arrays into pinned
        buffers, then non-blocking copies; the producer thread waits for its
        copies before it lets go of their pinned buffers. The consumer makes
        its current stream wait on the copy's event before it yields a batch
        and calls `record_stream` on each of the batch's device tensors, so
        the caching allocator cannot hand their memory to a later copy while
        a step still reads them. On the CPU it yields CPU tensors and uses
        no stream.
    devices_put: when given, maps a host batch to what is yielded, in place
        of the default put (as in JAX; pass a sharding put under a mesh).

    Two repairs of the JAX version: an exception of the iterator (or of the
    put) is raised at the consumer's next `next()`, where JAX ends the
    stream silently; closing the generator (or dropping it after a
    `break`) stops the producer thread and frees the batches it queued,
    where JAX's thread blocks on a full queue for good.
    """
    device = backend.resolve_device(device)
    cuda = device.type == 'cuda' and devices_put is None
    if cuda:
        copy_stream = torch.cuda.Stream(device)

        def put(batch):
            out, _, event = to_device(batch, device, copy_stream)
            event.synchronize()     # the pinned buffers may go
            return out, event
    elif devices_put is None:
        def put(batch):
            return _tree_map(_cpu_put, batch), None
    else:
        def put(batch):
            return devices_put(batch), None
    return _prefetch(iterator, size, put, device if cuda else None)


def _prefetch(iterator, size, put, cuda_device):
    q = queue_mod.Queue(maxsize=size)
    stop = threading.Event()

    def offer(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return
            except queue_mod.Full:
                pass

    def producer():
        end = _END
        try:
            it = iter(iterator)
            while not stop.is_set():
                try:
                    batch = next(it)
                except StopIteration:
                    break
                offer(put(batch))
        except BaseException as e:  # noqa: BLE001  (the consumer raises it)
            end = _Raised(e)
        offer(end)

    thread = threading.Thread(target=producer, name='prefetch_to_device',
                              daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, _Raised):
                raise item.exc
            batch, event = item
            if event is not None:
                stream = torch.cuda.current_stream(cuda_device)
                stream.wait_event(event)
                for t in _leaves(batch):
                    if torch.is_tensor(t) and t.is_cuda:
                        t.record_stream(stream)
            yield batch
    finally:
        stop.set()
        thread.join()
        while not q.empty():
            q.get_nowait()

###############################################################################
# internal helpers (reference `generators.py:977-1097`)
###############################################################################

def _get_file_list(volpath, ext=None, vol_rand_seed=None):
    """Sorted (optionally seed-permuted) file list (ref `:977-985`)."""
    files = [f for f in sorted(os.listdir(volpath))
             if ext is None or f.endswith(ext)]
    if vol_rand_seed is not None:
        rng = np.random.RandomState(vol_rand_seed)
        files = rng.permutation(files).tolist()
    return files


def _load_medical_volume(filename, ext, verbose=False):
    """Load npz/npy/nii/mgz volume (ref `:988-1004`, nibabel-free)."""
    return neio.load_volfile(filename)


def _categorical_prep(vol_data, nb_labels_reshape, keep_vol_size, patch_size):
    """One-hot / channel prep + batch dim (ref `:1007-1021`)."""
    if nb_labels_reshape > 1:
        lpatch = _to_categorical(vol_data, nb_labels_reshape,
                                 reshape=keep_vol_size or True)
    elif nb_labels_reshape == 1:
        lpatch = np.expand_dims(vol_data, axis=-1)
    else:
        assert nb_labels_reshape == 0
        lpatch = vol_data
    return np.expand_dims(lpatch, axis=0)


def _to_categorical(y, num_classes=None, reshape=True):
    """One-hot as a boolean matrix (ref `:1024-1051`); multithreaded native
    expansion via io/native.py."""
    oshape = y.shape
    y = np.array(y, dtype='int').ravel()
    if not num_classes:
        num_classes = np.max(y) + 1
    categorical = native.one_hot(y, int(num_classes), dtype=bool)
    if reshape:
        categorical = np.reshape(categorical, [*oshape, num_classes])
    return categorical


def _relabel(vol_data, labels, forcecheck=False):
    """Map label values to their index in `labels` (ref `:1054-1066`)."""
    if forcecheck:
        vd = np.unique(vol_data.flat)
        assert len(vd) == len(labels), \
            'number of given labels does not match number of actual labels'
    if np.asarray(vol_data).dtype.kind in 'iu':
        return native.relabel(vol_data, labels)
    new_vol_data = np.zeros(vol_data.shape, vol_data.dtype)
    for idx, val in np.ndenumerate(np.asarray(labels)):
        new_vol_data[vol_data == val] = idx[0] if len(idx) else idx
    return new_vol_data


def _npz_headers(npz, namelist=None):
    """Peek (name, shape, dtype) of arrays in an npz without loading
    (ref `:1069-1090`)."""
    with zipfile.ZipFile(npz) as archive:
        if namelist is None:
            namelist = archive.namelist()
        for name in namelist:
            if not name.endswith('.npy'):
                continue
            npy = archive.open(name)
            version = np.lib.format.read_magic(npy)
            shape, fortran, dtype = np.lib.format._read_array_header(npy,
                                                                     version)
            yield name[:-4], shape, dtype


def _get_shape(x):
    """Leading batch size of a (possibly nested) sample (ref `:1093-1097`)."""
    if isinstance(x, (list, tuple)):
        return _get_shape(x[0])
    return x.shape[0]


# reference `generators.py:45-78` defines a `Vol` class that is dead code
# (undefined names); the working equivalent is the deterministic
# `VolumeDataset`. `Vol` aliases it for API parity.
Vol = VolumeDataset
