"""Nothing the benchmark runs imports JAX or the JAX package: a cell's
set-up path, run on the CPU in a fresh process, leaves none of them in
`sys.modules`, and no file of the harness imports one (top-level names
compared whole: the port's name begins with the JAX package's)."""

import ast
import glob
import os
import subprocess
import sys

from h100bench import harness

DRY = r'''
import sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import SMALL
from h100bench import harness
for w in ('flagship-train-mem', 'flagship-serve-256'):
    harness.run(w, 3, 0.2, 0, 'cpu', time.time(), overrides=SMALL[w],
                log=lambda s: None)
print(','.join(harness.forbidden_modules()) or 'none')
print(','.join(sorted(m for m in sys.modules
                      if m.split('.')[0] == 'neurite_tpu_torch'))[:200])
'''


def test_set_up_path_loads_no_jax(tmp_path):
    code = DRY.format(root=harness.ROOT, tests=os.path.dirname(__file__))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == 'none'
    assert 'neurite_tpu_torch' in lines[-1]


def test_no_file_imports_jax():
    found = []
    for path in glob.glob(os.path.join(harness.HERE, '**', '*.py'),
                          recursive=True):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and not node.level:
                names = [node.module]
            found += [(path, n) for n in names
                      if n.split('.')[0] in harness.FORBIDDEN]
    assert not found


def test_forbidden_names_are_whole():
    assert 'neurite_tpu_torch' not in harness.FORBIDDEN
    sys.modules.setdefault('neurite_tpu_torch_like', sys)
    try:
        assert 'neurite_tpu_torch_like' not in harness.forbidden_modules()
    finally:
        del sys.modules['neurite_tpu_torch_like']
