"""
Public-API parity of the PyTorch port: every name of the reference API
(`REFERENCE_API`, pinned in `tests/test_api_parity.py`) is present on
`neurite_tpu_torch`, or listed below as not yet ported. A second test holds
the list to names that really are absent, so it can only shrink.
"""
import pytest

pytest.importorskip('torch')

from test_api_parity import REFERENCE_API  # noqa: E402

import neurite_tpu_torch as nt  # noqa: E402

# module -> the names still to port (ROADMAP.md, Queue 1)
NOT_YET_PORTED = {
    'dataproc': ['proc_mgh_vols', 'scans_to_slices', 'vol_proc',
                 'prior_to_weights', 'filestruct_change', 'ml_split'],
    'generators': ['Vol', 'vol', 'patch', 'vol_seg', 'vol_cat', 'add_prior',
                   'vol_prior', 'vol_seg_prior', 'vol_sr_slices', 'img_seg'],
}


def _module(name):
    """The port's module for a REFERENCE_API key, or None where the port
    has no such module yet."""
    obj = nt
    for part in name.split('.'):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


@pytest.mark.parametrize('module', sorted(REFERENCE_API))
def test_reference_names_present_or_listed(module):
    obj = _module(module)
    todo = set(NOT_YET_PORTED.get(module, ()))
    missing = [n for n in REFERENCE_API[module]
               if n not in todo and (obj is None or not hasattr(obj, n))]
    assert not missing, f'{module} missing: {missing}'


@pytest.mark.parametrize('module', sorted(NOT_YET_PORTED))
def test_listed_names_are_absent(module):
    assert module in REFERENCE_API
    assert set(NOT_YET_PORTED[module]) <= set(REFERENCE_API[module])
    obj = _module(module)
    present = [n for n in NOT_YET_PORTED[module]
               if obj is not None and hasattr(obj, n)]
    assert not present, f'{module} lists ported names: {present}'


def test_counts():
    """168 reference names; 16 of them not yet ported (63 before the serve
    path's modules, the stream, hyper and classify modules, modelio,
    utils.model, callbacks and py)."""
    assert sum(len(v) for v in REFERENCE_API.values()) == 168
    assert sum(len(v) for v in NOT_YET_PORTED.values()) == 16
    assert set(NOT_YET_PORTED) == {'dataproc', 'generators'}
