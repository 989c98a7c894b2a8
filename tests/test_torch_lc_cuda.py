"""
K7, K8 and K9 (`ops/csrc/lc.cu`: the locally-connected forward, kernel
gradient and input gradient) on the card against the port's plain
versions: equal bits, in both weight layouts, in float32 and bfloat16, by
each body the choosers `lc_cuda.fwd_body`, `dk_body` and `dx_body` pick
(16-byte rows of voxels a thread, counted in `launches['lc_*_row']`; the
keras layout's row bodies, counted in `launches['lc_*_keras_row']`; one
voxel a thread), each keras row body also against the one-voxel body; at
small, ragged and batched shapes, at config #3's head (x [1, 160^3, 4],
weights [1, 108, 160^3]) and through `lc3d_pallas` there. At the head the
keras row bodies must take less time than the one-voxel bodies, which is
why the choosers pick them. Imports no JAX, so that it runs on the machine
with the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_lc_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

from neurite_tpu_torch.ops import _build, lc_cuda, lc_tap  # noqa: E402

KERNELS = ('lc_fwd', 'lc_dk', 'lc_dx')
HEAD = (1, 160, 160, 160, 4)

# (B, spatial, C, O, kernel_size, padding): every value of each knob
CASES = [
    (1, (5, 6, 7), 1, 1, (3, 3, 3), 'same'),
    (3, (5, 6, 7), 3, 2, (3, 3, 3), 'valid'),
    (1, (6, 5, 4), 3, 1, (3, 1, 3), 'valid'),
    (3, (4, 6, 5), 1, 2, (3, 1, 3), 'same'),
    (1, (5, 5, 6), 3, 2, (3, 3, 3), 'same'),
    (3, (6, 4, 5), 1, 1, (3, 3, 3), 'valid'),
]


def _inputs(seed, B, sp, C, O, ks, padding, bf16=False,
            out_shape=lc_tap._out_shape):
    """(x, k, g) of a case; `out_shape` gives the output's spatial shape
    (a reference's own, where the port is held to one)."""
    rng = np.random.default_rng(seed)
    out = out_shape(sp, ks, padding)
    x = rng.normal(size=(B, *sp, C)).astype(np.float32)
    k = rng.normal(size=(O, int(np.prod(ks)) * C, int(np.prod(out))))
    k = k.astype(np.float32)
    g = rng.normal(size=(B, *out, O)).astype(np.float32)
    if bf16:  # values that bfloat16 holds exactly
        x, k = (torch.from_numpy(a).bfloat16().float().numpy()
                for a in (x, k))
    return x, k, g


DK_BODIES = {   # name: (x_shape, O, dtype, keras, padding, ks,
                #        the bodies of K8, K7 and K9)
    # the config #3 head: Wo = 160, a multiple of 8 bf16 or 4 f32 voxels
    'head_bf16': (HEAD, 1, torch.bfloat16, False, 'same',
                  (3, 3, 3), ('row', 'row', 'row')),
    'head_f32': (HEAD, 1, torch.float32, False, 'same',
                 (3, 3, 3), ('row', 'row', 'row')),
    'row_o2_bf16': ((1, 5, 6, 16, 4), 2, torch.bfloat16, False, 'same',
                    (3, 3, 3), ('row', 'row', 'row')),
    # 'valid': Wo = 12, 4 f32 voxels fit a row, 8 bf16 ones do not; K9's
    # row body takes 'same' only
    'row_valid_f32': ((1, 5, 6, 14, 4), 1, torch.float32, False, 'valid',
                      (3, 3, 3), ('row', 'row', 'voxel')),
    'row_valid_bf16': ((1, 5, 6, 14, 4), 1, torch.bfloat16, False, 'valid',
                       (3, 3, 3), ('voxel', 'voxel', 'voxel')),
    'b3_o2_bf16': ((3, 32, 32, 32, 4), 2, torch.bfloat16, False, 'same',
                   (3, 3, 3), ('voxel', 'voxel', 'voxel')),
    'b3_o2_f32': ((3, 32, 32, 32, 4), 2, torch.float32, False, 'same',
                  (3, 3, 3), ('voxel', 'voxel', 'voxel')),
    # the keras layout: K8, K7 and K9 by their keras row bodies at the
    # head's B = 1, C = 4, O = 1 and ky, kx <= 3 (K9 'same' only), else by
    # their one-voxel bodies
    'keras_head': (HEAD, 1, torch.bfloat16, True, 'same',
                   (3, 3, 3), ('keras_row', 'keras_row', 'keras_row')),
    'keras_valid_f32': ((1, 6, 7, 9, 4), 1, torch.float32, True, 'valid',
                        (3, 3, 3), ('keras_row', 'keras_row', 'voxel')),
    'keras_b3_o2': ((3, 32, 32, 32, 4), 2, torch.float32, True, 'same',
                    (3, 3, 3), ('voxel', 'voxel', 'voxel')),
    'keras_o2': ((1, 6, 7, 9, 4), 2, torch.bfloat16, True, 'same',
                 (3, 3, 3), ('voxel', 'voxel', 'voxel')),
    'keras_c3': ((1, 6, 7, 9, 3), 1, torch.bfloat16, True, 'same',
                 (3, 3, 3), ('voxel', 'voxel', 'voxel')),
    'keras_kx5': ((1, 6, 6, 16, 4), 1, torch.bfloat16, True, 'same',
                  (3, 3, 5), ('voxel', 'voxel', 'voxel')),
    'keras_c16_o4': ((1, 4, 4, 8, 16), 4, torch.float32, True, 'same',
                     (3, 3, 3), ('voxel', 'voxel', 'voxel')),
    # 32 voxels of TC = 396 float32 weights pass 48 KB of shared memory;
    # bfloat16 ones fit; K9 stages one tz at a time, whatever kz
    'keras_big_tile_f32': ((1, 12, 4, 8, 4), 1, torch.float32, True,
                           'same', (11, 3, 3), ('voxel', 'voxel', 'keras_row')),
    'keras_kz11_bf16': ((1, 12, 4, 8, 4), 1, torch.bfloat16, True, 'same',
                        (11, 3, 3), ('keras_row', 'keras_row', 'keras_row')),
    # TC = 360 float32: 32 voxels' tiles fit, 45 KB
    'keras_kz10_f32': ((1, 11, 4, 8, 4), 1, torch.float32, True, 'same',
                       (10, 3, 3), ('keras_row', 'keras_row', 'keras_row')),
    # a z-plane of H W TC = 4096^2 x 396 weights passes 32-bit offsets
    'keras_big_plane': ((1, 2, 4096, 4096, 4), 1, torch.bfloat16, True,
                        'same', (11, 3, 3), ('keras_row', 'keras_row',
                                             'voxel')),
    # Wo = 19: a thread's voxels would cross rows
    'ragged_bf16': ((1, 15, 17, 19, 4), 1, torch.bfloat16, False, 'same',
                    (3, 3, 3), ('voxel', 'voxel', 'voxel')),
    'ragged_f32': ((1, 15, 17, 19, 4), 1, torch.float32, False, 'same',
                   (3, 3, 3), ('voxel', 'voxel', 'voxel')),
    'c3_bf16': ((1, 16, 17, 16, 3), 1, torch.bfloat16, False, 'same',
                (3, 3, 3), ('voxel', 'voxel', 'voxel')),
    'kx5_bf16': ((1, 6, 6, 16, 4), 1, torch.bfloat16, False, 'same',
                 (3, 3, 5), ('voxel', 'voxel', 'voxel')),
}

# (x_shape, O, padding, K7's and K9's bodies) in the transposed layout
ROW_CASES = {
    'head': (HEAD, 1, 'same', 'row', 'row'),
    # V = 6528: a ragged last block, and warps that span two rows
    'ragged_block': ((1, 16, 17, 24, 4), 1, 'same', 'row', 'row'),
    'o2_32': ((1, 32, 32, 32, 4), 2, 'same', 'row', 'row'),
    'valid': ((1, 16, 17, 18, 4), 1, 'valid', 'row', 'voxel'),
    'w19': ((1, 15, 17, 19, 4), 1, 'same', 'voxel', 'voxel'),
    'b3': ((3, 16, 17, 24, 4), 1, 'same', 'voxel', 'voxel'),
}

# K8 on the card: DK_BODIES' transposed cases, and K7's and K9's row cases,
# where K8 takes K7's body
DK_CARD = {name: DK_BODIES[name] for name in (
    'head_bf16', 'head_f32', 'row_o2_bf16', 'row_valid_f32',
    'row_valid_bf16', 'b3_o2_bf16', 'b3_o2_f32', 'ragged_bf16',
    'ragged_f32', 'c3_bf16', 'kx5_bf16')}
DK_CARD.update({
    f'{name}_{dt}': (x_shape, O, getattr(torch, dt), False, padding,
                     (3, 3, 3), (fwd, fwd, dx))
    for name, (x_shape, O, padding, fwd, dx) in ROW_CASES.items()
    if name in ('ragged_block', 'o2_32', 'valid')
    for dt in ('bfloat16', 'float32')})

KERAS_CASES = {   # name: (x_shape, O, dtype, padding, ks, K8's body)
    # the head's B = 1, C = 4 and O = 1 (one load and store a tap); V = 378:
    # a ragged tail
    'quad_bf16': ((1, 6, 7, 9, 4), 1, torch.bfloat16, 'same', (3, 3, 3),
                  'keras_row'),
    'quad_f32': ((1, 6, 7, 9, 4), 1, torch.float32, 'same', (3, 3, 3),
                 'keras_row'),
    'valid_bf16': ((1, 6, 7, 9, 4), 1, torch.bfloat16, 'valid', (3, 3, 3),
                   'keras_row'),
    'kz5_ky2_f32': ((1, 7, 6, 9, 4), 1, torch.float32, 'same', (5, 2, 3),
                    'keras_row'),
    # the one-voxel body in the keras layout
    'b3_o2_f32': ((3, 5, 6, 7, 4), 2, torch.float32, 'same', (3, 3, 3),
                  'voxel'),
    'b2_bf16': ((2, 5, 6, 7, 4), 1, torch.bfloat16, 'same', (3, 3, 3),
                'voxel'),
    'c3_valid_bf16': ((1, 6, 7, 9, 3), 1, torch.bfloat16, 'valid',
                      (3, 3, 3), 'voxel'),
    'kx5_f32': ((1, 6, 6, 16, 4), 1, torch.float32, 'same', (3, 3, 5),
                'voxel'),
}
# and at the transposed layout's row cases: the keras row body at one
# filter, 'valid' too, the one-voxel body at two
KERAS_CASES.update({
    f'{name}_{dt}': (x_shape, O, getattr(torch, dt), padding, (3, 3, 3),
                     'keras_row' if O == 1 else 'voxel')
    for name, (x_shape, O, padding, _, _) in ROW_CASES.items()
    if name in ('w19', 'ragged_block', 'valid', 'o2_32')
    for dt in ('bfloat16', 'float32')})

KERAS_FWD_DX_CASES = {   # name: (x_shape, O, padding, ks, K7's and K9's
                         #        bodies in bf16, in f32)
    # V = 378 (K7: 3 blocks of 128 output voxels, the last ragged)
    'ragged': ((1, 6, 7, 9, 4), 1, 'same', (3, 3, 3),
               ('keras_row', 'keras_row'), ('keras_row', 'keras_row')),
    # V = 990: H and W not multiples of K9's 8 x 16 tiles
    'ragged_990': ((1, 9, 10, 11, 4), 1, 'same', (3, 3, 3),
                   ('keras_row', 'keras_row'), ('keras_row', 'keras_row')),
    'valid': ((1, 6, 7, 9, 4), 1, 'valid', (3, 3, 3),
              ('keras_row', 'voxel'), ('keras_row', 'voxel')),
    # kx = 2: a halo of one voxel along W
    'kx2': ((1, 6, 7, 9, 4), 1, 'same', (3, 3, 2),
            ('keras_row', 'keras_row'), ('keras_row', 'keras_row')),
    # an even kernel: low 'same' padding 0 along H
    'kz5_ky2': ((1, 7, 6, 9, 4), 1, 'same', (5, 2, 3),
                ('keras_row', 'keras_row'), ('keras_row', 'keras_row')),
    # TC = 396: K7's 32-voxel blocks in bf16, float32 past 48 KB; K9
    # stages one tz at a time
    'kz11': ((1, 12, 4, 8, 4), 1, 'same', (11, 3, 3),
             ('keras_row', 'keras_row'), ('voxel', 'keras_row')),
}


def _keras_fwd_dx_bodies(O, padding):
    """K7's and K9's bodies in the keras layout at B = 1, C = 4 and a 3^3
    kernel: the keras row bodies at one filter (K9's at 'same' only), the
    one-voxel bodies at two."""
    return ('keras_row' if O == 1 else 'voxel',
            'keras_row' if O == 1 and padding == 'same' else 'voxel')


# and at the transposed layout's row cases
KERAS_FWD_DX_CASES.update({
    f'row_{name}': (x_shape, O, padding, (3, 3, 3),
                    _keras_fwd_dx_bodies(O, padding),
                    _keras_fwd_dx_bodies(O, padding))
    for name, (x_shape, O, padding, _, _) in ROW_CASES.items()
    if name in ('w19', 'ragged_block', 'valid', 'o2_32')})


def _normal(rng, *shapes):
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to('cuda')
            for s in shapes]


def _same_bits(a, b):
    ity = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(ity), b.view(ity)))


def _bodies_ran():
    return {f'{n}_{b}': _build.launches[f'{n}_{b}'] for n in KERNELS
            for b in ('row', 'keras_row')}


def _head_keras(seed):
    """Config #3's head in the keras layout, bfloat16: x [1, 160^3, 4],
    the weights [160^3, 108] and their [1, 108, 160^3] view, a float32
    cotangent [1, 160^3, 1]."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    V = 160 ** 3
    x = torch.randn(HEAD, generator=gen, device='cuda').bfloat16()
    k2 = torch.randn((V, 108), generator=gen, device='cuda').bfloat16()
    g = torch.randn((*HEAD[:4], 1), generator=gen, device='cuda')
    return x, k2, lc_cuda._weight_view(k2, True), g


def _event_ms(fn, reps=10, warmup=2):
    """Device ms of one fn() call: CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('case', CASES[:3] + [
    (3, (32, 32, 32), 4, 2, (3, 3, 3), 'same')], ids=str)
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_kernels_equal_plain_on_card(cuda, case, dtype):
    """K7, K8 and K9 against their plain versions on the card: equal, each
    by its one-voxel body (a batch, C = 1 or 3, or 2 filters)."""
    B, sp, C, O, ks, padding = case
    x, k, g = (torch.from_numpy(a).to(cuda) for a in _inputs(6, *case))
    x, k = x.to(dtype), k.to(dtype)
    _build.launches.clear()
    for keras in (False, True):
        kern = k.permute(2, 1, 0).contiguous() if keras else k
        kv = lc_cuda._weight_view(kern, keras)
        pairs = [
            (lc_cuda.fwd_cuda(x, kv, ks, padding),
             lc_cuda.fwd_plain(x, kv, ks, padding)),
            (lc_cuda.dk_cuda(g, x, ks, padding, dtype, keras),
             lc_cuda.dk_plain(g, x, ks, padding, dtype, keras)),
            (lc_cuda.dx_cuda(g, kv, ks, padding, tuple(x.shape), dtype,
                             keras),
             lc_cuda.dx_plain(g, kv, ks, padding, tuple(x.shape), dtype,
                              keras)),
        ]
        torch.cuda.synchronize()
        for a, b in pairs:
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)
    assert not any(_bodies_ran().values())


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(DK_CARD))
def test_dk_bodies_equal_plain_on_card(cuda, case):
    """Each K8 body against dk_plain on the card: equal, and the launch
    counts show which body ran."""
    x_shape, O, dtype, keras, padding, ks, (body, _, _) = DK_CARD[case]
    out = lc_tap._out_shape(x_shape[1:4], ks, padding)
    rng = np.random.default_rng(7)
    x, g = _normal(rng, x_shape, (x_shape[0], *out, O))
    x = x.to(dtype)
    _build.launches.clear()
    got = lc_cuda.dk_cuda(g, x, ks, padding, dtype)
    want = lc_cuda.dk_plain(g, x, ks, padding, dtype)
    torch.cuda.synchronize()
    assert _build.launches['lc_dk'] == 1
    assert _build.launches['lc_dk_row'] == (body == 'row')
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(KERAS_CASES))
def test_dk_keras_row_equals_plain_on_card(cuda, case):
    """K8 in the keras layout, by the body `dk_body` picks, against
    dk_plain(keras=True) and against K8's one-voxel body on the card: equal
    bits, and the launch counts show which body ran."""
    x_shape, O, dtype, padding, ks, body = KERAS_CASES[case]
    out = lc_tap._out_shape(x_shape[1:4], ks, padding)
    rng = np.random.default_rng(8)
    x, g = _normal(rng, x_shape, (x_shape[0], *out, O))
    x = x.to(dtype)
    _build.launches.clear()
    got = lc_cuda.dk_cuda(g, x, ks, padding, dtype, keras=True)
    assert _build.launches['lc_dk_keras_row'] == (body == 'keras_row')
    want = lc_cuda.dk_plain(g, x, ks, padding, dtype, keras=True)
    voxel = torch.empty_like(got)
    lc_cuda._dk_launch(g, x, lc_cuda._weight_view(voxel, True), ks, padding,
                       'voxel')
    torch.cuda.synchronize()
    assert _same_bits(got, want)
    assert _same_bits(got, voxel)


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(ROW_CASES))
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_fwd_dx_bodies_equal_plain_on_card(cuda, case, dtype):
    """K7 and K9 against fwd_plain and dx_plain on the card, each body (and
    K9's rounded products, round_q): equal, and the launch counts show
    which body ran."""
    x_shape, O, padding, fwd_want, dx_want = ROW_CASES[case]
    ks = (3, 3, 3)
    out = lc_tap._out_shape(x_shape[1:4], ks, padding)
    rng = np.random.default_rng(8)
    x, k, g = _normal(rng, x_shape, (O, 108, int(np.prod(out))),
                      (x_shape[0], *out, O))
    x, k = x.to(dtype), k.to(dtype)
    _build.launches.clear()
    got = lc_cuda.fwd_cuda(x, k, ks, padding)
    want = lc_cuda.fwd_plain(x, k, ks, padding)
    torch.cuda.synchronize()
    assert _build.launches['lc_fwd_row'] == (fwd_want == 'row')
    assert torch.equal(got, want)
    for round_q in (False, True):
        _build.launches.clear()
        got = lc_cuda.dx_cuda(g, k, ks, padding, x_shape, dtype, round_q)
        want = lc_cuda.dx_plain(g, k, ks, padding, x_shape, dtype, round_q)
        torch.cuda.synchronize()
        assert _build.launches['lc_dx_row'] == (dx_want == 'row')
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(KERAS_FWD_DX_CASES))
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_fwd_dx_keras_row_equal_plain_on_card(cuda, case, dtype):
    """K7 and K9 in the keras layout, by the bodies `fwd_body` and
    `dx_body` pick, against fwd_plain and dx_plain (with and without
    round_q) and against their one-voxel bodies on the card: equal bits,
    and the launch counts show which body ran."""
    x_shape, O, padding, ks, bf16_bodies, f32_bodies = \
        KERAS_FWD_DX_CASES[case]
    fwd_want, dx_want = bf16_bodies if dtype == torch.bfloat16 else f32_bodies
    out = lc_tap._out_shape(x_shape[1:4], ks, padding)
    rng = np.random.default_rng(9)
    x, k, g = _normal(rng, x_shape, (int(np.prod(out)), int(np.prod(ks)) * 4,
                                     O), (1, *out, O))
    x, k = x.to(dtype), k.to(dtype)
    kv = lc_cuda._weight_view(k, True)
    _build.launches.clear()
    got = lc_cuda.fwd_cuda(x, kv, ks, padding)
    assert _build.launches['lc_fwd_keras_row'] == (fwd_want == 'keras_row')
    voxel = torch.empty_like(got)
    lc_cuda._fwd_launch(x, kv, voxel, ks, padding, 'voxel')
    want = lc_cuda.fwd_plain(x, kv, ks, padding)
    torch.cuda.synchronize()
    assert _same_bits(got, want) and _same_bits(got, voxel)
    for round_q in (False, True):
        _build.launches.clear()
        got = lc_cuda.dx_cuda(g, kv, ks, padding, x_shape, dtype, round_q)
        assert _build.launches['lc_dx_keras_row'] == (dx_want == 'keras_row')
        voxel = torch.empty_like(got)
        lc_cuda._dx_launch(g, kv, voxel, ks, padding, round_q, 'voxel')
        want = lc_cuda.dx_plain(g, kv, ks, padding, x_shape, dtype, round_q)
        torch.cuda.synchronize()
        assert _same_bits(got, want) and _same_bits(got, voxel)


@pytest.mark.cuda
def test_lc3d_pallas_at_the_head_on_card(cuda):
    """The keras-layout entry point (the v1 semantics: dx rounds each
    product to bfloat16) through autograd at config #3's head, bfloat16:
    the forward, dk and dx each by its keras row body once and no row
    body, each equal to its plain version and to its one-voxel body."""
    ks, sp, V = (3, 3, 3), HEAD[1:4], 160 ** 3
    x5, k2, kv, g5 = _head_keras(10)
    xr, kr = x5.reshape(V, 4).clone().requires_grad_(), \
        k2.clone().requires_grad_()
    _build.launches.clear()
    y = lc_cuda.lc3d_pallas(xr, kr, sp, ks)
    dx, dk = torch.autograd.grad(y, (xr, kr), g5.reshape(V, 1))
    assert _bodies_ran() == {f'{n}_{b}': int(b == 'keras_row')
                             for n in KERNELS for b in ('row', 'keras_row')}
    y, dx = y.detach().reshape(*HEAD[:4], 1), dx.reshape(HEAD)
    want = (lc_cuda.fwd_plain(x5, kv, ks, 'same'),
            lc_cuda.dk_plain(g5, x5, ks, 'same', torch.bfloat16, True),
            lc_cuda.dx_plain(g5, kv, ks, 'same', HEAD, torch.bfloat16, True))
    y1, dk1, dx1 = (torch.empty_like(t) for t in (y, dk, dx))
    lc_cuda._fwd_launch(x5, kv, y1, ks, 'same', 'voxel')
    lc_cuda._dk_launch(g5, x5, lc_cuda._weight_view(dk1, True), ks, 'same',
                       'voxel')
    lc_cuda._dx_launch(g5, kv, dx1, ks, 'same', True, 'voxel')
    torch.cuda.synchronize()
    for name, got, plain, voxel in zip(KERNELS, (y, dk, dx), want,
                                       (y1, dk1, dx1)):
        assert _same_bits(got, plain.reshape(got.shape)), name
        assert _same_bits(got, voxel), name


@pytest.mark.cuda
def test_keras_row_bodies_beat_the_one_voxel_bodies_at_the_head_on_card(
        cuda):
    """What the choosers rest on: at config #3's head in the keras layout
    (bfloat16) each of K7, K8 and K9 takes less device time by the body its
    chooser picks ('keras_row') than by its one-voxel body (about 7, 25
    and 2.3 times less on an NVIDIA H100 80GB HBM3 at 700 W)."""
    ks = (3, 3, 3)
    x5, k2, kv, g5 = _head_keras(11)
    y, dk, dx = (torch.empty((*HEAD[:4], 1), device='cuda'),
                 torch.empty_like(k2), torch.empty_like(x5))
    dkv = lc_cuda._weight_view(dk, True)
    launches = {
        'lc_fwd': (lc_cuda.fwd_body(x5, kv, ks, 'same'),
                   lambda b: lc_cuda._fwd_launch(x5, kv, y, ks, 'same', b)),
        'lc_dk': (lc_cuda.dk_body(x5, dkv, ks, 'same'),
                  lambda b: lc_cuda._dk_launch(g5, x5, dkv, ks, 'same', b)),
        'lc_dx': (lc_cuda.dx_body(HEAD, kv, ks, 'same'),
                  lambda b: lc_cuda._dx_launch(g5, kv, dx, ks, 'same', True,
                                               b)),
    }
    for name, (body, launch) in launches.items():
        assert body == 'keras_row', name
        ms = {b: _event_ms(lambda: launch(b)) for b in (body, 'voxel')}
        assert ms[body] < ms['voxel'], (name, ms)
