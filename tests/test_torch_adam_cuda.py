"""
K11 (`ops/csrc/adam.cu`) on the card against the port's plain Adam on the
CPU, from the same parameters and gradients: a float32 and a bfloat16
group in one optimizer over three steps, each group holding aligned
tensors, a ragged length, an unaligned view and (float32) a channels-last
parameter, several tensors a launch; a group past the table's 64 rows,
its moments replaced before a fourth step; a float32 tensor past 2^31
bytes; and the leaves of config #3, the flagship and SynthStrip against
the plain version on the card. Imports no JAX, so that it runs on the
machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_adam_cuda.py
"""
import pytest

torch = pytest.importorskip('torch')

import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch.ops import _build, adam  # noqa: E402

LR = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _leaf(n, dtype, device, gen, offset=0):
    """A parameter of n elements drawn on the CPU, on `device`; with
    `offset`, a view that starts `offset` elements into a buffer."""
    x = torch.randn(n, generator=gen).to(dtype)
    buf = torch.empty(n + offset, dtype=dtype, device=device)
    leaf = buf[offset:]
    leaf.copy_(x)
    return leaf.requires_grad_()


def _ulps_apart(a, b):
    """|a - b| in units of the last place of bfloat16 at the larger
    magnitude."""
    a, b = a.float(), b.float()
    big = torch.maximum(a.abs(), b.abs()).clamp_min(2. ** -126)
    return (a - b).abs() / torch.exp2(torch.floor(torch.log2(big)) - 7)


def _agree(card, host, dtype):
    """(ok, detail) of K11's tensor against the plain version's after one
    step from the same state. float32: rtol 1e-6 (a few float32 ulps: the
    card fuses multiply-adds and multiplies by 1 / sqrt(1 - b2^t) where
    the CPU divides) and atol 1e-7 (m cancels towards 0 and carries its
    terms' error); bfloat16: the same float32 values rounded once, so on
    at most 1e-3 of the elements, those where the two float32 values
    straddle a rounding boundary, one ulp apart, or, where m cancels
    towards 0, far under a bfloat16 ulp of its terms: 1e-6."""
    card = card.detach().to(host.device).float()
    host = host.detach().float()
    if dtype == torch.float32:
        err = float((card - host).abs().max())
        return (torch.allclose(card, host, rtol=1e-6, atol=1e-7),
                f'max abs err {err:.3g}')
    apart = _ulps_apart(card, host)
    near = (apart <= 1) | ((card - host).abs() <= 1e-6)
    share = float((card != host).float().mean())
    return (bool(near.all()) and share <= 1e-3,
            f'most ulps apart {float(apart.max()):g}, share apart {share:.3g}')


def _permuted(device, gen):
    """A dense float32 parameter [4, 8, 3, 3, 3] laid out channels-last, as
    the convs' weights are (strides (216, 1, 72, 24, 8))."""
    x = torch.randn(4, 3, 3, 3, 8, generator=gen).to(device)
    return x.permute(0, 4, 1, 2, 3).requires_grad_()


@pytest.mark.cuda
def test_kernel_matches_plain_step_by_step(cuda):
    """Three steps; before each, the plain version's copy takes the card's
    parameters and moments, so each comparison is one step's."""
    gen = torch.Generator().manual_seed(0)
    # (n, offset, body): aligned multiples of the vector's width, a ragged
    # length, an unaligned view, one of many chunks; a channels-last
    # parameter (n None) whose contiguous gradient the wrapper lays out
    leaves = {torch.float32: [(4096, 0, 'vec'), (1000, 0, 'vec'),
                              (1001, 0, 'scalar'), (4096, 1, 'scalar'),
                              (3 * 2 ** 20 + 4, 0, 'vec'), (None, 0, 'vec')],
              torch.bfloat16: [(8192, 0, 'vec'), (1003, 0, 'scalar'),
                               (8192, 1, 'scalar'), (2 ** 22, 0, 'vec')]}
    card, host, bodies = [], [], []
    for dtype, spec in leaves.items():
        for n, offset, body in spec:
            leaf = (_permuted(cuda, gen) if n is None
                    else _leaf(n, dtype, cuda, gen, offset))
            card.append(leaf)
            host.append(leaf.detach().cpu().requires_grad_())
            bodies.append((dtype, n, offset, body))
    opt, ref = adam.Adam(card, lr=LR), adam.Adam(host, lr=LR)
    before = dict(_build.launches)
    for step in range(1, 4):
        for c, h in zip(card, host):
            h.data.copy_(c.detach().cpu())
            if c in opt.state:
                for k in ('exp_avg', 'exp_avg_sq'):
                    ref.state[h][k].copy_(opt.state[c][k].cpu())
            g = torch.randn(c.shape, generator=gen).to(c.dtype)
            c.grad, h.grad = g.to(cuda), g
        opt.step()
        ref.step()
        torch.cuda.synchronize()
        for c, h, (dtype, n, offset, body) in zip(card, host, bodies):
            s = opt.state[c]
            ptrs = (c.data_ptr(), c.grad.data_ptr(), s['exp_avg'].data_ptr(),
                    s['exp_avg_sq'].data_ptr())
            if n is not None:
                assert adam.plan(ptrs, n, c.element_size()) == body, (n, offset)
            for name, a, b in (('p', c, h),
                               ('exp_avg', s['exp_avg'], ref.state[h]['exp_avg']),
                               ('exp_avg_sq', s['exp_avg_sq'],
                                ref.state[h]['exp_avg_sq'])):
                assert a.dtype == dtype
                ok, detail = _agree(a, b, dtype)
                assert ok, (step, dtype, n, offset, name, detail)
            assert float(s['step']) == step
    ran = {k: _build.launches[k] - before.get(k, 0)
           for k in ('adam', 'adam_vec', 'adam_scalar')}
    # one launch a dtype group a step, each with a scalar-body tensor
    assert ran == {'adam': 6, 'adam_vec': 0, 'adam_scalar': 6}


@pytest.mark.cuda
def test_vec_group_past_the_table_takes_two_launches(cuda):
    """70 aligned float32 tensors: two launches a step (64 rows and 6),
    each by the 'vec' body, equal to the plain version; before the fourth
    step every moment is replaced by a copy, which the step must update
    in its place."""
    gen = torch.Generator().manual_seed(1)
    card = [_leaf(4 * (i + 1), torch.float32, cuda, gen) for i in range(70)]
    host = [c.detach().cpu().requires_grad_() for c in card]
    opt, ref = adam.Adam(card, lr=LR), adam.Adam(host, lr=LR)
    before = dict(_build.launches)
    for step in range(4):
        if step == 3:
            for s in opt.state.values():
                for k in ('exp_avg', 'exp_avg_sq'):
                    s[k] = s[k].clone()
        for c, h in zip(card, host):
            g = torch.randn(c.shape, generator=gen)
            c.grad, h.grad = g.to(cuda), g
        opt.step()
        ref.step()
    torch.cuda.synchronize()
    ran = {k: _build.launches[k] - before.get(k, 0)
           for k in ('adam', 'adam_vec', 'adam_scalar')}
    assert ran == {'adam': 8, 'adam_vec': 8, 'adam_scalar': 0}
    for c, h in zip(card, host):
        for a, b in ((c, h), (opt.state[c]['exp_avg'],
                              ref.state[h]['exp_avg'])):
            ok, detail = _agree(a, b, torch.float32)
            assert ok, detail


@pytest.mark.cuda
def test_tensor_past_2_31_bytes(cuda):
    """A float32 tensor of 2^29 + 4 elements (2^31 + 16 bytes a stream) by
    the 'vec' body, against the plain version run on the card: the
    elements past 2^31 bytes are updated as the first ones."""
    n = 2 ** 29 + 4
    gen = torch.Generator(device=cuda).manual_seed(2)
    p = torch.randn(n, generator=gen, device=cuda).requires_grad_()
    want = p.detach().clone()
    p.grad = torch.randn(n, generator=gen, device=cuda)
    opt = adam.Adam([p], lr=LR)
    opt.step()
    m, v = torch.zeros_like(want), torch.zeros_like(want)
    adam._adam_plain(want, p.grad, m, v, 1., LR, 0.9, 0.999, 1e-8)
    torch.cuda.synchronize()
    for got, ref in ((p.detach(), want), (opt.state[p]['exp_avg'], m),
                     (opt.state[p]['exp_avg_sq'], v)):
        assert torch.allclose(got, ref, rtol=1e-6, atol=1e-7)


def _path_leaves(path):
    """(shape, dtype) of each parameter of a path's model: config #3 at
    160^3 (a float32 trunk, a bfloat16 head of 446M parameters), the
    flagship UNet at 128^3 (float32), SynthStrip at 128^3 (54 float32
    leaves, one bias of 1 element)."""
    if path == 'config3':
        model = nt.models.unet_lc(input_shape=(160,) * 3 + (1,),
                                  dtype=torch.bfloat16,
                                  param_dtype=torch.bfloat16, device='cpu')
    elif path == 'flagship':
        model = nt.models.unet(
            nb_features=16, input_shape=(128,) * 3 + (1,), nb_levels=4,
            conv_size=3, nb_labels=4, feat_mult=2, nb_conv_per_level=2,
            device='cpu')
    else:
        model = nt.models.SynthStrip(
            inshape=(128,) * 3, labels_in=range(16),
            labels_out={lab: 1 for lab in range(1, 12)},
            nb_unet_features=[16, 32, 64, 64, 64, 64, 64],
            nb_unet_conv_per_level=2, device='cpu')
    return [(p.shape, p.dtype) for p in model.parameters()]


@pytest.mark.cuda
@pytest.mark.parametrize('path,want', [
    # the trunk's float32 group and the head's bfloat16 one
    ('config3', {'adam': 2, 'adam_vec': 2, 'adam_scalar': 0}),
    ('flagship', {'adam': 1, 'adam_vec': 1, 'adam_scalar': 0}),
    # one launch with a 1-element bias: the 'scalar' body beside the 'vec'
    ('synthstrip', {'adam': 1, 'adam_vec': 0, 'adam_scalar': 1}),
])
def test_kernel_matches_plain_at_path_leaves(cuda, path, want):
    """Leaves of a path's shapes and dtypes drawn on the card with their
    gradients: three steps at lr 1e-3, each against the plain version on
    the card from K11's state; K11's launches a step and their bodies
    exactly those."""
    lr = 1e-3
    gen = torch.Generator(device=cuda).manual_seed(11)
    leaves = []
    for shape, dtype in _path_leaves(path):
        leaf = torch.randn(shape, generator=gen,
                           device=cuda).to(dtype).requires_grad_()
        leaf.grad = torch.randn(shape, generator=gen, device=cuda).to(dtype)
        leaves.append(leaf)
    opt = adam.Adam(leaves, lr=lr)
    twins = [(p.detach().clone(), torch.zeros_like(p), torch.zeros_like(p))
             for p in leaves]
    before = dict(_build.launches)
    for step in range(1, 4):
        for p, (q, m, v) in zip(leaves, twins):
            q.copy_(p.detach())
            if step > 1:
                m.copy_(opt.state[p]['exp_avg'])
                v.copy_(opt.state[p]['exp_avg_sq'])
        opt.step()
        for p, (q, m, v) in zip(leaves, twins):
            adam._adam_plain(q, p.grad, m, v, float(step), lr, 0.9, 0.999,
                             1e-8)
            s = opt.state[p]
            for name, a, b in (('p', p, q), ('exp_avg', s['exp_avg'], m),
                               ('exp_avg_sq', s['exp_avg_sq'], v)):
                ok, detail = _agree(a, b, p.dtype)
                assert ok, (path, step, tuple(p.shape), name, detail)
    torch.cuda.synchronize()
    ran = {k: _build.launches[k] - before.get(k, 0) for k in want}
    assert ran == {k: 3 * n for k, n in want.items()}
