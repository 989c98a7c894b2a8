"""
Pure-numpy medical-image IO: NIfTI-1 (.nii/.nii.gz), FreeSurfer MGH/MGZ
(.mgz/.mgh), and npz/npy volumes.

Counterpart of `neurite_tpu/io/medio.py`, the same readers and writers
byte for byte: a file either package writes loads in the other to the same
array, dtype and affine. The reference loads volumes via nibabel
(`neurite/tf/generators.py:988-1004`); the formats are implemented here
instead, zero-dependency readers/writers sufficient for volume data +
affine.
"""

import gzip

import numpy as np

_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 32: np.complex64,
    64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32,
    1024: np.int64, 1280: np.uint64,
}
_NIFTI_CODES = {np.dtype(v): k for k, v in _NIFTI_DTYPES.items()}

_MGH_DTYPES = {0: np.uint8, 1: np.int32, 3: np.float32, 4: np.int16}
_MGH_CODES = {np.dtype(v): k for k, v in _MGH_DTYPES.items()}


class Volume:
    """A loaded volume: data + affine (+ header dict)."""

    def __init__(self, data, affine=None, header=None):
        self.data = data
        self.affine = np.eye(4) if affine is None else affine
        self.header = header or {}

    def get_fdata(self):  # nibabel-compatible accessor
        return np.asarray(self.data, np.float64)

    @property
    def shape(self):
        return self.data.shape


def _open_maybe_gz(path, mode='rb'):
    if str(path).endswith('.gz') or str(path).endswith('.mgz'):
        return gzip.open(path, mode)
    return open(path, mode)


def load_nii(path):
    """Read a NIfTI-1 volume (optionally gzipped). Returns Volume."""
    with _open_maybe_gz(path) as f:
        raw = f.read()
    hdr = raw[:348]
    sizeof_hdr = np.frombuffer(hdr, np.int32, 1, 0)[0]
    bo = '<'
    if sizeof_hdr != 348:
        bo = '>'
        sizeof_hdr = np.frombuffer(hdr, np.dtype('>i4'), 1, 0)[0]
        if sizeof_hdr != 348:
            raise ValueError(f'not a NIfTI-1 file: {path}')

    def rd(dtype, count, offset):
        return np.frombuffer(hdr, np.dtype(bo + dtype), count, offset)

    dim = rd('i2', 8, 40)
    ndim = int(dim[0])
    shape = tuple(int(d) for d in dim[1:1 + ndim])
    datatype = int(rd('i2', 1, 70)[0])
    vox_offset = int(rd('f4', 1, 108)[0])
    scl_slope = float(rd('f4', 1, 112)[0])
    scl_inter = float(rd('f4', 1, 116)[0])
    pixdim = rd('f4', 8, 76)
    sform_code = int(rd('i2', 1, 254)[0])
    srow = np.stack([rd('f4', 4, 280), rd('f4', 4, 296), rd('f4', 4, 312)])
    magic = hdr[344:348]
    if magic[:2] not in (b'n+', b'ni'):
        raise ValueError(f'bad NIfTI magic in {path}')

    dtype = _NIFTI_DTYPES.get(datatype)
    if dtype is None:
        raise ValueError(f'unsupported NIfTI datatype {datatype}')
    count = int(np.prod(shape))
    data = np.frombuffer(raw, np.dtype(bo + np.dtype(dtype).str[1:]), count,
                         vox_offset)
    data = data.reshape(shape, order='F').copy()

    if scl_slope not in (0.0,) and not np.isnan(scl_slope) and \
            (scl_slope != 1.0 or scl_inter not in (0.0,)):
        data = data * scl_slope + scl_inter

    affine = np.eye(4)
    if sform_code > 0:
        affine[:3] = srow
    else:
        affine[0, 0] = pixdim[1]
        affine[1, 1] = pixdim[2]
        affine[2, 2] = pixdim[3]

    header = dict(pixdim=np.asarray(pixdim), datatype=datatype,
                  sform_code=sform_code)
    return Volume(data, affine, header)


def save_nii(path, data, affine=None):
    """Write a NIfTI-1 volume (gzipped when path ends in .gz)."""
    data = np.asarray(data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if data.dtype not in _NIFTI_CODES:
        data = data.astype(np.float32)
    affine = np.eye(4) if affine is None else np.asarray(affine, np.float64)

    hdr = bytearray(348)
    def wr(val, dtype, offset):
        b = np.asarray(val, dtype).tobytes()
        hdr[offset:offset + len(b)] = b

    wr(348, '<i4', 0)
    dim = np.ones(8, np.int16)
    dim[0] = data.ndim
    dim[1:1 + data.ndim] = data.shape
    wr(dim, '<i2', 40)
    wr(_NIFTI_CODES[data.dtype], '<i2', 70)
    wr(data.dtype.itemsize * 8, '<i2', 72)
    pixdim = np.zeros(8, np.float32)
    pixdim[1:4] = np.linalg.norm(affine[:3, :3], axis=0)[:3] if data.ndim >= 3 \
        else 1.0
    wr(pixdim, '<f4', 76)
    wr(352.0, '<f4', 108)  # vox_offset
    wr(1.0, '<f4', 112)    # scl_slope
    wr(0.0, '<f4', 116)    # scl_inter
    wr(1, '<i2', 252)      # qform_code
    wr(1, '<i2', 254)      # sform_code
    wr(affine[0].astype(np.float32), '<f4', 280)
    wr(affine[1].astype(np.float32), '<f4', 296)
    wr(affine[2].astype(np.float32), '<f4', 312)
    hdr[344:348] = b'n+1\x00'

    payload = bytes(hdr) + b'\x00' * 4 + data.tobytes(order='F')
    with _open_maybe_gz(path, 'wb') as f:
        f.write(payload)


def load_mgh(path):
    """Read a FreeSurfer MGH/MGZ volume. Returns Volume."""
    with _open_maybe_gz(path) as f:
        raw = f.read()

    def rd(dtype, count, offset):
        return np.frombuffer(raw, np.dtype('>' + dtype), count, offset)

    version = int(rd('i4', 1, 0)[0])
    if version != 1:
        raise ValueError(f'unsupported MGH version {version}')
    width, height, depth, nframes = (int(v) for v in rd('i4', 4, 4))
    dtype_code = int(rd('i4', 1, 20)[0])
    good_ras = int(rd('i2', 1, 28)[0])

    affine = np.eye(4)
    if good_ras > 0:
        spacing = rd('f4', 3, 30)
        mdc = rd('f4', 9, 42).reshape(3, 3, order='F')
        pxyz_c = rd('f4', 3, 78)
        affine[:3, :3] = mdc * spacing
        shape3 = np.asarray([width, height, depth], np.float64)
        affine[:3, 3] = pxyz_c - affine[:3, :3] @ (shape3 / 2)

    dtype = _MGH_DTYPES.get(dtype_code)
    if dtype is None:
        raise ValueError(f'unsupported MGH type {dtype_code}')
    shape = (width, height, depth, nframes)
    count = int(np.prod(shape))
    data = np.frombuffer(raw, np.dtype('>' + np.dtype(dtype).str[1:]),
                         count, 284)
    data = data.reshape(shape, order='F').copy()
    if nframes == 1:
        data = data[..., 0]
    return Volume(data, affine, dict(version=version, type=dtype_code))


def save_mgh(path, data, affine=None):
    """Write a FreeSurfer MGH/MGZ volume (gzipped when path ends in .mgz)."""
    data = np.asarray(data)
    if data.dtype not in _MGH_CODES:
        data = data.astype(np.float32)
    while data.ndim < 4:
        data = data[..., None]
    affine = np.eye(4) if affine is None else np.asarray(affine, np.float64)

    hdr = bytearray(284)
    def wr(val, dtype, offset):
        b = np.asarray(val, dtype).tobytes()
        hdr[offset:offset + len(b)] = b

    wr(1, '>i4', 0)
    wr(np.asarray(data.shape, np.int32), '>i4', 4)
    wr(_MGH_CODES[np.dtype(data.dtype)], '>i4', 20)
    wr(0, '>i4', 24)  # dof
    wr(1, '>i2', 28)  # goodRASFlag
    spacing = np.linalg.norm(affine[:3, :3], axis=0)
    spacing = np.where(spacing == 0, 1.0, spacing)
    mdc = affine[:3, :3] / spacing
    shape3 = np.asarray(data.shape[:3], np.float64)
    pxyz_c = affine[:3, :3] @ (shape3 / 2) + affine[:3, 3]
    wr(spacing.astype(np.float32), '>f4', 30)
    wr(mdc.astype(np.float32).flatten(order='F'), '>f4', 42)
    wr(pxyz_c.astype(np.float32), '>f4', 78)

    with _open_maybe_gz(path, 'wb') as f:
        big = data.astype(data.dtype.newbyteorder('>'), copy=False)
        f.write(bytes(hdr) + big.tobytes(order='F'))


def load_volfile(path, npz_var='vol_data'):
    """
    Load a volume from npz/npy/nii/nii.gz/mgz/mgh, returning a numpy array.

    Parity: reference `_load_medical_volume` (`generators.py:988-1004`),
    without nibabel.
    """
    path = str(path)
    if path.endswith('.npz'):
        with np.load(path) as f:
            if npz_var not in f and len(f.files) == 1:
                return f[f.files[0]]
            return f[npz_var]
    if path.endswith('.npy'):
        return np.load(path)
    if path.endswith(('.nii', '.nii.gz', '.img')):
        return load_nii(path).data
    if path.endswith(('.mgz', '.mgh')):
        return load_mgh(path).data
    raise ValueError(f'unknown filetype for {path}')


def save_volfile(path, data, affine=None, npz_var='vol_data'):
    """Save a volume in the format implied by the extension."""
    path = str(path)
    if path.endswith('.npz'):
        np.savez_compressed(path, **{npz_var: np.asarray(data)})
    elif path.endswith('.npy'):
        np.save(path, np.asarray(data))
    elif path.endswith(('.nii', '.nii.gz')):
        save_nii(path, data, affine)
    elif path.endswith(('.mgz', '.mgh')):
        save_mgh(path, data, affine)
    else:
        raise ValueError(f'unknown filetype for {path}')
