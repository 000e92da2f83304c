"""Reproducibility utilities.

Port of the JAX package's ``utils/rand.py``: the same fixed pool of 100
seeds and a one-call global seeding function. Where the JAX package
returns a ``jax.random`` key, the port seeds torch's generators (the
CPU's and every CUDA card's) instead.
"""

from __future__ import annotations

import os
import random
from typing import List

import numpy as np
import torch

# A fixed pool of 100 seeds for repeatable experiment sweeps (the JAX
# package's values).
SEEDS: List[int] = [
    int(seed)
    for seed in np.random.default_rng(20260816).integers(
        0, 2**30, size=100
    )
]


def set_random_seed(seed: int) -> torch.Generator:
    """Seeds every random source (``PYTHONHASHSEED``, ``random``, NumPy
    and torch) and returns torch's default CPU generator."""
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    return torch.manual_seed(seed)
