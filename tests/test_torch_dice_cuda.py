"""
K3 (`ops/csrc/dice_red.cu`, the Dice sums) on the card against the port's
plain sums: each sum within rtol 1e-5 (another summation order), two calls
bit-equal, by the body `dice_red.plan` picks ('vec', one device launch a
call, counted in `launches['dice_sums_vec']`; 'scalar'), at small and
ragged shapes, the flagship's [1, 128^3, 4], config #5's [1, 128^3, 16]
and a misaligned view of the flagship's. Imports no JAX, so that it runs
on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_dice_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

from neurite_tpu_torch.ops import _build, dice_red  # noqa: E402
from test_torch_pool_cuda import _misaligned  # noqa: E402


def _maps(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    y = rng.random(shape).astype(np.float32)
    return x, y


def _device_events(fn):
    """The device events (kernels, copies, sets) torch.profiler records in
    one fn() call; None where it records none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if str(getattr(e, 'device_type', '')).endswith('CUDA')
            and not getattr(e, 'is_user_annotation', False))
    return n or None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('shape,misaligned', [
    ((2, 1000, 3), False), ((1, 4096, 4), False), ((3, 17, 300), False),
    ((3, 17, 299), False), ((1, 64 ** 3, 16), False), ((2, 1000, 8), False),
    ((2, 100000, 8), False), ((3, 50, 12), False),
    ((1, 128 ** 3, 4), False),    # the flagship's
    ((1, 128 ** 3, 16), False),   # config #5's
    ((1, 128 ** 3, 4), True),     # the scalar body on views
])
def test_dice_kernel_matches_plain_on_card(cuda, shape, misaligned):
    x, y = (torch.from_numpy(a).to(cuda) for a in _maps(4, shape))
    if misaligned:
        x, y = _misaligned(x), _misaligned(y)
    vec = shape[2] % 4 == 0 and not misaligned
    assert dice_red.plan(*shape, (x.data_ptr(), y.data_ptr())).body == (
        'vec' if vec else 'scalar')
    before = _build.launches['dice_sums_vec']
    k = dice_red.dice_sums_cuda(x, y)
    assert _build.launches['dice_sums_vec'] == before + vec
    p = dice_red._dice_sums_plain(x, y)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        # rtol 1e-5: another summation order
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0.)
    # a fixed order of additions: the same bits on the next call
    for a, b in zip(k, dice_red.dice_sums_cuda(x, y)):
        assert torch.equal(a, b)
    if vec:
        # one device launch a call (a count the profiler did not record
        # is not held against it)
        assert _device_events(lambda: dice_red.dice_sums_cuda(x, y)) in (
            1, None)
