"""Seeded CL006: default_rng() without a seed draws from OS entropy."""
import numpy as np


def jitter_ms():
    rng = np.random.default_rng()   # CL006
    return float(rng.random())
