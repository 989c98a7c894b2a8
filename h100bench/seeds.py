"""Seeds for each purpose of a run, from the run's seed."""

import numpy as np


def sub_seed(seed, *tags):
    """A 63-bit seed for one purpose, from the run's seed and tags."""
    return int(np.random.SeedSequence([int(seed), *tags]).generate_state(
        2, np.uint64)[0] >> np.uint64(1))
