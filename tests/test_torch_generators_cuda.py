"""
`generators.prefetch_to_device` onto the card: batches copied from pinned
buffers on a copy stream arrive bit-equal to their host arrays, and closing
the generator ends its producer thread. Imports no JAX, so that it runs on
the machine with the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_generators_cuda.py
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from neurite_tpu_torch import generators as tg  # noqa: E402


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == 'prefetch_to_device']


@pytest.mark.cuda
def test_prefetch_cuda_pinned_copies_are_bit_equal():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    host = [(np.random.default_rng(i).normal(size=(1, 64, 64, 64, 1))
             .astype(np.float16),
             np.random.default_rng(i).random((1, 64, 64, 64, 4)) > .5)
            for i in range(5)]
    gen = tg.prefetch_to_device(iter(host), size=2)
    for h, (x, y) in zip(host, gen):
        assert x.is_cuda and y.is_cuda
        torch.cuda.synchronize()
        np.testing.assert_array_equal(x.cpu().numpy(), h[0])
        np.testing.assert_array_equal(y.cpu().numpy(), h[1])
    gen.close()
    assert not _prefetch_threads()
