"""
The PyTorch port's example scripts (`examples_torch/`), each run in-process
on the CPU at the JAX script's sizes, step counts and seeds: `main('cpu')`
must return its headline values, which are held to the same value checks
as `tests/test_examples.py` holds the JAX scripts' (a value oracle, not
just "did not crash"). `multichip_training.py` runs over 4 gloo ranks in
`tests/test_torch_spatial.py`, against its one-process run.
"""
import math
import os
import runpy

import pytest

torch = pytest.importorskip('torch')
torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'examples_torch')
JAX_EXAMPLES = os.path.join(os.path.dirname(EXAMPLES), 'examples')

# tests/test_examples.py's checks, script by script
CHECKS = {
    'train_unet_2d.py': lambda r: r['final_loss'] < -0.5,
    'deformable_registration.py':
        lambda r: r['mi_after'] > r['mi_before'] + 0.05,
    'synthesis_pipeline.py': lambda r: math.isfinite(r['loss']),
    'synthstrip_training.py': lambda r: math.isfinite(r['loss']),
    'anatomical_priors_vae.py':
        lambda r: math.isfinite(r['loss']) and len(r['recon_shape']) >= 2,
}


def test_every_jax_example_is_ported():
    scripts = {f for f in os.listdir(EXAMPLES) if f.endswith('.py')}
    jax_scripts = {f for f in os.listdir(JAX_EXAMPLES) if f.endswith('.py')}
    assert scripts == jax_scripts
    assert scripts - set(CHECKS) == {'multichip_training.py'}


@pytest.mark.parametrize('script', sorted(CHECKS))
def test_example_runs(script, capsys):
    mod = runpy.run_path(os.path.join(EXAMPLES, script))
    result = mod['main']('cpu')
    out = capsys.readouterr().out
    assert 'nan' not in out.lower(), f'{script} printed NaNs:\n{out}'
    assert result is not None, f'{script} main() must return its results'
    assert CHECKS[script](result), f'{script} value check failed: {result}'
