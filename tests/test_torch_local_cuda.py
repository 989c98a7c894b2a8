"""
The config #3 step (`nt.models.unet_lc`: a UNet trunk feeding a
LocallyConnected3D head, MSE, the port's Adam) on the card at 16^3 in
bfloat16: finite losses, and each step launches K7, K8 and K9
(`ops/csrc/lc.cu`) once and K1 (`ops/csrc/pool.cu`) at the trunk's two
pools. Imports no JAX, so that it runs on the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_local_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip('torch')

import neurite_tpu_torch as nt  # noqa: E402
from neurite_tpu_torch import training  # noqa: E402
from neurite_tpu_torch.ops import _build  # noqa: E402


def EncDecLC(size, dtype, param_dtype, device):
    """The port's config #3 model, `nt.models.unet_lc`, at size^3:
    attribute names follow the flax tree (`ne.models.unet` drops its name,
    so flax calls the trunk UNet_0)."""
    return nt.models.unet_lc(input_shape=(size,) * 3 + (1,), dtype=dtype,
                             param_dtype=param_dtype, device=device)


def _tmse(yt, yp):
    return torch.mean((yt - yp.float()) ** 2)


def _config3_batch(size):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(1, size, size, size, 1)).astype(np.float32),
            rng.normal(size=(1, size, size, size, 1)).astype(np.float32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
def test_cuda_step_launches_each_lc_kernel_once(cuda):
    x, y = (torch.from_numpy(a).to(cuda) for a in _config3_batch(16))
    tm = EncDecLC(16, torch.bfloat16, torch.bfloat16, cuda)
    state = training.create_train_state(tm, training.adam(1e-4))
    step = training.make_train_step(_tmse)
    _build.launches.clear()
    for _ in range(2):
        state, m = step(state, (x, y))
    torch.cuda.synchronize()
    assert np.isfinite(float(m['loss']))
    for name in ('lc_fwd', 'lc_dk', 'lc_dx'):
        assert _build.launches[name] == 2, name
    assert _build.launches['pool2_fwd'] == 4
