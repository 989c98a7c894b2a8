"""
Spatial transforms: dense warps, affine fields, vector-field integration.
Counterpart of `neurite_tpu/utils/spatial.py` (the voxelmorph layers the
reference imports, `neurite/tf/models.py:760,1058`).

The warps run `core.interpn`, so a 3-D warp of a CUDA tensor is one launch
of K4 (`ops.warp`), batch and channels included. The `impl`, `max_disp`
and `guard` arguments pick among the JAX package's TPU engines and have no
effect here: every engine computes the same exact warp. Matrix functions
take an optional leading batch axis (the JAX package vmaps them).
"""

import itertools

import numpy as np
import torch

from neurite_tpu_torch import backend
from neurite_tpu_torch.utils import core

__all__ = [
    'transform', 'batch_transform', 'affine_to_dense_shift', 'integrate_vec',
    'compose_transforms', 'rescale_transform', 'rescale_dense_transform',
    'params_to_affine_matrix', 'draw_affine_params', 'angles_to_rotation_matrix',
    'is_affine_shape', 'make_square_affine', 'draw_flip_matrix',
    'draw_swap_matrix', 'batch_integrate_vec', 'compose_affine_dense',
]


def transform(vol, loc_shift, interp_method='linear', fill_value=None,
              shift_center=True, impl='auto', max_disp=8.0, guard='runtime'):
    """
    Warp one (unbatched) volume by a dense displacement field:
    out(x) = vol(x + shift(x)). vol: [*vol_shape] or [*vol_shape, C];
    loc_shift: [*out_shape, N]. (`shift_center` is unused, as in the JAX
    package.)
    """
    del shift_center, impl, max_disp, guard
    loc = core.grid_points(loc_shift.shape[:-1], loc_shift.device,
                           loc_shift.dtype) + loc_shift
    return core.interpn(vol, loc, interp_method=interp_method,
                        fill_value=fill_value)


def batch_transform(vol, loc_shift, impl='auto', max_disp=8.0,
                    interp_method='linear', fill_value=None,
                    shift_center=True, guard='runtime'):
    """`transform` over a leading batch axis of both arguments; a 3-D warp
    is one call of the warp engine for the whole batch."""
    del impl, max_disp, shift_center, guard
    loc = core.grid_points(loc_shift.shape[1:-1], loc_shift.device,
                           loc_shift.dtype) + loc_shift
    if loc.shape[-1] == 3:
        from neurite_tpu_torch.ops import warp
        return warp.interpn_batch(vol, loc, interp_method, fill_value)
    return core.interpn_plain(vol, loc, interp_method, fill_value,
                              batched=True)


def is_affine_shape(shape):
    """True for (N, N+1) or (N+1, N+1) matrix shapes with 1<=N<=3."""
    if len(shape) == 2:
        rows, cols = shape
        return cols in (rows, rows + 1) and 2 <= cols <= 4
    return False


def make_square_affine(mat):
    """Append the [0 ... 0 1] row to (a batch of) (N, N+1) affine matrices."""
    if mat.shape[-2] == mat.shape[-1]:
        return mat
    bottom = torch.zeros((*mat.shape[:-2], 1, mat.shape[-1]), dtype=mat.dtype,
                         device=mat.device)
    bottom[..., -1] = 1.
    return torch.cat([mat, bottom], dim=-2)


def affine_to_dense_shift(matrix, shape, shift_center=True, warp_right=None):
    """
    An (N, N+1) or (N+1, N+1) affine as a dense displacement field
    [*shape, N]: shift(x) = A x - x, on centred coordinates with
    shift_center, optionally composed on the right with the field
    `warp_right` (voxelmorph AffineToDenseShift, ref `models.py:1131`).
    """
    matrix = matrix.to(torch.float32)
    ndims = len(shape)
    if matrix.shape[-1] != ndims + 1:
        raise ValueError(f'affine matrix must be of shape (N, {ndims + 1}), '
                         f'got {tuple(matrix.shape)}')
    matrix = make_square_affine(matrix)
    mesh = [m.to(torch.float32) for m in core.volshape_to_ndgrid(
        shape, device=matrix.device)]
    if shift_center:
        mesh = [mesh[d] - (shape[d] - 1) / 2 for d in range(ndims)]
    grid = torch.stack([core.flatten(m) for m in mesh], 0)       # N x V
    grid_in = grid
    if warp_right is not None:
        grid_in = grid + warp_right.to(torch.float32).reshape(-1, ndims).T
    ones = torch.ones((1, grid.shape[1]), device=grid.device)
    moved = (matrix @ torch.cat([grid_in, ones], 0))[:ndims]
    return (moved - grid).T.reshape(*shape, ndims)


def integrate_vec(vec, nb_steps=7, impl='auto', max_disp=8.0):
    """Integrate a stationary velocity field [*shape, N] by scaling and
    squaring with `nb_steps` squarings (voxelmorph VecInt, ref
    `models.py:1149`)."""
    del impl, max_disp
    vec = vec / (2.0 ** nb_steps)
    for _ in range(nb_steps):
        vec = vec + transform(vec, vec)
    return vec


def batch_integrate_vec(vec, nb_steps=7, impl='auto', max_disp=8.0):
    """`integrate_vec` over a leading batch axis: one warp per squaring."""
    del impl, max_disp
    vec = vec / (2.0 ** nb_steps)
    for _ in range(nb_steps):
        vec = vec + batch_transform(vec, vec)
    return vec


def compose_affine_dense(matrix, dense, shape, clip=True):
    """
    Closed form of `compose_transforms([affine_to_dense_shift(A), d])`:
    composed(x) = d(x) + A p - p with p = clip(x + d(x)) (multilinear
    interpolation reproduces the affine field exactly, so no warp is needed).

    matrix: (N, N+1) or (N+1, N+1) in voxel coordinates (no centre shift), or
    a batch of them [B, ., N+1] with dense [B, *shape, N].
    """
    matrix = make_square_affine(matrix.to(torch.float32))
    ndims = len(shape)
    loc = core.grid_points(shape, dense.device) + dense
    if clip:
        maxl = core.device_constant(np.asarray(shape, np.float32) - 1,
                                    dense.device)
        loc = torch.minimum(torch.maximum(loc, torch.zeros_like(maxl)), maxl)
    lin = matrix[..., :ndims, :ndims]
    shift = matrix[..., :ndims, -1]
    if matrix.ndim == 3:
        flat = loc.reshape(loc.shape[0], -1, ndims)
        aff = torch.einsum('bij,bvj->bvi', lin, flat).reshape(loc.shape)
        aff = aff + shift.reshape(shift.shape[0], *[1] * ndims, ndims)
    else:
        aff = torch.einsum('ij,vj->vi', lin,
                           loc.reshape(-1, ndims)).reshape(loc.shape) + shift
    return dense + (aff - loc)


def rescale_dense_transform(field, factor, interp_method='linear'):
    """Resize a dense transform [*shape, N] by `factor` and scale its
    vectors by it (voxelmorph RescaleTransform, ref `models.py:1152`)."""
    if factor == 1:
        return field
    ndims = field.shape[-1]
    return core.resize(field, [factor] * ndims,
                       interp_method=interp_method) * factor


def rescale_transform(trf, factor, interp_method='linear'):
    """Rescale an affine (zoom its translation) or a dense transform."""
    if is_affine_shape(tuple(trf.shape)):
        mat = make_square_affine(trf)
        s = torch.tensor([factor] * (mat.shape[-1] - 1) + [1.0],
                         dtype=mat.dtype, device=mat.device)
        return mat * (s[:, None] / s[None, :])
    return rescale_dense_transform(trf, factor, interp_method=interp_method)


def compose_transforms(transforms, shape=None, shift_center=True,
                       impl='auto', max_disp=8.0):
    """
    Compose affine matrices and/or dense shift fields into one dense shift
    field over `shape`, applied right to left (the last acts first), as
    voxelmorph ComposeTransform (ref `models.py:1154`).
    """
    del impl, max_disp
    if not transforms:
        raise ValueError('no transforms to compose')
    if shape is None:
        for t in transforms:
            if not is_affine_shape(tuple(t.shape)):
                shape = tuple(t.shape[:-1])
                break
    if shape is None:
        raise ValueError('need a dense transform or an explicit shape')

    def as_dense(t):
        if is_affine_shape(tuple(t.shape)):
            return affine_to_dense_shift(t, shape, shift_center=shift_center)
        return t

    cur = as_dense(transforms[-1])
    for t in transforms[-2::-1]:
        if is_affine_shape(tuple(t.shape)):
            cur = affine_to_dense_shift(t, shape, shift_center=shift_center,
                                        warp_right=cur)
        else:
            cur = cur + transform(t, cur)
    return cur


def _stack_matrix(rows):
    """[..., R, C] from nested lists of equal-shape tensors."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def angles_to_rotation_matrix(angles, ndims=3, deg=True):
    """N-D rotation matrix (or a batch of them) from 1 (2-D) or 3 (3-D)
    angles in the last axis."""
    angles = torch.as_tensor(angles, dtype=torch.float32)
    if angles.ndim == 0:
        angles = angles[None]
    if deg:
        angles = angles * (np.pi / 180.0)
    one = torch.ones_like(angles[..., 0])
    zero = torch.zeros_like(one)
    if ndims == 2:
        c, s = torch.cos(angles[..., 0]), torch.sin(angles[..., 0])
        return _stack_matrix([[c, -s], [s, c]])
    if ndims != 3:
        raise ValueError(f'ndims must be 2 or 3, got {ndims}')
    cx, sx = torch.cos(angles[..., 0]), torch.sin(angles[..., 0])
    cy, sy = torch.cos(angles[..., 1]), torch.sin(angles[..., 1])
    cz, sz = torch.cos(angles[..., 2]), torch.sin(angles[..., 2])
    mx = _stack_matrix([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    my = _stack_matrix([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    mz = _stack_matrix([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    return mx @ my @ mz


def params_to_affine_matrix(par=None, rotation=None, translation=None,
                            scaling=None, shear=None, ndims=3, deg=True,
                            shift_scale=False, last_row=False):
    """
    An (N, N+1) affine T @ R @ SHEAR @ SCALE from its parameters
    (voxelmorph ParamsToAffineMatrix, ref `models.py:1103`). `par` packs
    [translation, rotation, scaling, shear] in its last axis, which may
    follow batch axes; the result then has them too.
    """
    if ndims not in (2, 3):
        raise ValueError(f'ndims must be 2 or 3, got {ndims}')
    n_rot = 1 if ndims == 2 else 3
    device = next((t.device for t in (par, rotation, translation, scaling,
                                      shear) if torch.is_tensor(t)),
                  torch.device('cpu'))
    batch = ()
    if par is not None:
        par = torch.as_tensor(par, dtype=torch.float32, device=device)
        batch = tuple(par.shape[:-1])
        sizes = (ndims, n_rot, ndims, n_rot)
        translation, rotation, scaling, shear = torch.split(
            par[..., :sum(sizes)], sizes, dim=-1)

    def conform(v, n, default):
        if v is None:
            return torch.full((*batch, n), default, device=device)
        v = torch.as_tensor(v, dtype=torch.float32, device=device)
        v = v.reshape(*v.shape[:len(batch)], -1) if batch else v.reshape(-1)
        if v.shape[-1] not in (1, n):
            raise ValueError(f'expected 1 or {n} parameters, got '
                             f'{v.shape[-1]}')
        return v.expand(*v.shape[:-1], n)

    rotation = conform(rotation, n_rot, 0.)
    translation = conform(translation, ndims, 0.)
    scaling = conform(scaling, ndims, 1.)
    shear = conform(shear, n_rot, 0.)
    if shift_scale:
        scaling = scaling + 1.0

    rot = angles_to_rotation_matrix(rotation, ndims=ndims, deg=deg)
    scale_mat = torch.diag_embed(scaling)
    one = torch.ones_like(shear[..., 0])
    zero = torch.zeros_like(one)
    if ndims == 2:
        shear_mat = _stack_matrix([[one, shear[..., 0]], [zero, one]])
    else:
        shear_mat = _stack_matrix([[one, shear[..., 0], shear[..., 1]],
                                   [zero, one, shear[..., 2]],
                                   [zero, zero, one]])
    lin = rot @ shear_mat @ scale_mat
    mat = torch.cat([lin, translation[..., None]], dim=-1)
    return make_square_affine(mat) if last_row else mat


def draw_affine_params(seed, shift=None, rot=None, scale=None, shear=None,
                       normal_shift=False, normal_rot=False,
                       normal_scale=False, normal_shear=False,
                       shift_scale=False, ndims=3, concat=True, device=None):
    """
    Draw uniform (or truncated-normal) affine parameters: a bound b means
    [-b, b] about 0 (about 1 for scale); a truncated normal in [-2, 2] is
    scaled to b / 2 (voxelmorph DrawAffineParams, ref `models.py:1090`).
    Returns (translation, rotation, scaling, shear) or their concatenation.
    """
    device = backend.resolve_device(device)
    gen = core.as_generator(seed, device)
    n_rot = 1 if ndims == 2 else 3
    specs = [(shift, ndims, 0., normal_shift), (rot, n_rot, 0., normal_rot),
             (scale, ndims, 1., normal_scale), (shear, n_rot, 0., normal_shear)]
    out = []
    for bound, n, center, use_normal in specs:
        if bound is None:
            out.append(torch.full((n,), center, device=device))
            continue
        b = core.device_constant(np.broadcast_to(
            np.ravel(np.asarray(bound, np.float32)), (n,)), device)
        if use_normal:
            out.append(center + truncated_normal(gen, (n,), device) * (b / 2))
        else:
            out.append(center + core.uniform(gen, (n,), -1., 1., device) * b)
    shift_v, rot_v, scale_v, shear_v = out
    if shift_scale:
        scale_v = scale_v - 1.0
    if concat:
        return torch.cat([shift_v, rot_v, scale_v, shear_v])
    return shift_v, rot_v, scale_v, shear_v


def truncated_normal(generator, shape, device, low=-2., high=2.):
    """Standard normal truncated to [low, high] (jax.random.truncated_normal):
    inverse CDF of a uniform draw between the bounds' CDF values."""
    sq2 = np.sqrt(2.)
    a, b = float(torch.special.erf(torch.tensor(low / sq2))), \
        float(torch.special.erf(torch.tensor(high / sq2)))
    u = core.uniform(generator, shape, a, b, device)
    return torch.clamp(sq2 * torch.special.erfinv(u), low, high)


def draw_flip_matrix(seed, shape, shift_center=False, ndims=None,
                     device=None):
    """
    Random axis-flip homogeneous matrix in index coordinates: each axis
    flipped with p = 0.5; without shift_center, x -> (S - 1) - x on a
    flipped axis (voxelmorph draw_flip_matrix, ref `models.py:1120-1123`).
    """
    device = backend.resolve_device(device)
    gen = core.as_generator(seed, device)
    shape = np.asarray(shape)
    ndims = len(shape) if ndims is None else ndims
    flips = torch.rand(ndims, generator=gen, device=device) < 0.5
    diag = torch.where(flips, -1., 1.)
    mat = torch.diag_embed(torch.cat([diag, torch.ones(1, device=device)]))
    if not shift_center:
        size = core.device_constant((shape - 1).astype(np.float32), device)
        mat[:ndims, ndims] = torch.where(flips, size, 0.)
    return mat


def draw_swap_matrix(seed, ndims, device=None):
    """Random axis-permutation homogeneous matrix, one of the ndims!
    permutations (voxelmorph draw_swap_matrix, ref `models.py:1125-1128`)."""
    device = backend.resolve_device(device)
    gen = core.as_generator(seed, device)
    perms = list(itertools.permutations(range(ndims)))
    mats = np.zeros((len(perms), ndims + 1, ndims + 1), np.float32)
    for k, p in enumerate(perms):
        for i, j in enumerate(p):
            mats[k, i, j] = 1.
        mats[k, ndims, ndims] = 1.
    idx = torch.randint(0, len(perms), (), generator=gen, device=device)
    return core.device_constant(mats, device)[idx]
