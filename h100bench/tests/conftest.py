"""The harness's CPU tests: the repository's root on the import path, and
the small shapes every test runs the cells at."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL_UNET = {"in_channels": 1, "nb_features": [4, 8, 8], "nb_levels": 3,
              "feat_mult": 1, "nb_conv_per_level": 2, "conv_size": 3,
              "nb_labels": 1}
# each cell small enough for the CPU: 16^3 (the serve cell's volumes at
# 32^3 in 16^3 patches at stride 8)
SMALL = {
    'flagship-train-mem': {'config': {'shape': [16, 16, 16]}},
    'synthstrip-train': {'config': {'shape': [16, 16, 16],
                                    'unet': SMALL_UNET}},
    'flagship-serve-256': {'config': {'shape': [16, 16, 16]},
                           'traffic': {'size': [32, 32, 32], 'stride': 8}},
}

# the controls' sizes: the smallest at which the float8 control of the
# flagship reads on the CPU as it reads at 128^3 on the card (grad_gap
# 0.03-0.04 at 64^3, 0.02-0.03 at 32^3)
CONTROL = dict(SMALL)
CONTROL['flagship-train-mem'] = {'config': {'shape': [64, 64, 64]}}


@pytest.fixture
def control_sizes():
    return CONTROL


@pytest.fixture
def small():
    return SMALL
