"""
The import rule of the PyTorch port: `neurite_tpu_torch` and every one of
its modules import with JAX, flax, optax, orbax, the JAX package,
matplotlib, PIL, tensorflow and nibabel blocked, as on the machine with the
card, which has none of them (the data modules import PIL, tensorflow and
matplotlib inside the functions that need them). Run in a fresh
interpreter, where none of them is loaded yet.
"""
import os
import pkgutil
import subprocess
import sys

import pytest

pytest.importorskip('torch')

BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'neurite_tpu',
           'matplotlib', 'PIL', 'tensorflow', 'nibabel')
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None          # `import name` raises ImportError
import neurite_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(
    neurite_tpu_torch.__path__, 'neurite_tpu_torch.'))
for m in mods:
    importlib.import_module(m)
print(len(mods), ' '.join(mods))
"""


def _port_modules():
    import neurite_tpu_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        neurite_tpu_torch.__path__, 'neurite_tpu_torch.'))


def test_port_imports_without_jax_flax_optax_orbax_or_matplotlib():
    out = subprocess.run([sys.executable, '-c', SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    n, names = out.stdout.split(maxsplit=1)
    want = _port_modules()
    assert names.split() == want and int(n) == len(want)
    for m in ('neurite_tpu_torch.io.tiling', 'neurite_tpu_torch.utils.seg',
              'neurite_tpu_torch.layers.stream',
              'neurite_tpu_torch.layers.hyper',
              'neurite_tpu_torch.models.classify',
              'neurite_tpu_torch.modelio', 'neurite_tpu_torch.utils.model',
              'neurite_tpu_torch.py.plot', 'neurite_tpu_torch.callbacks',
              'neurite_tpu_torch.io.medio', 'neurite_tpu_torch.io.native',
              'neurite_tpu_torch.generators', 'neurite_tpu_torch.dataproc',
              'neurite_tpu_torch.data', 'neurite_tpu_torch.py.data',
              'neurite_tpu_torch.ops.conv', 'neurite_tpu_torch.parallel',
              'neurite_tpu_torch.parallel.mesh',
              'neurite_tpu_torch.parallel.halo'):
        assert m in want
