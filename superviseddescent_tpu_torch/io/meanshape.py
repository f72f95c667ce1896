"""Mean-shape CSV loader.

The port's own copy of ``superviseddescent_tpu/io/meanshape.py``
(reference: rcr-train's load_mean, rcr-train.cpp:97-117): one line of
comma-separated floats, all x coordinates then all y coordinates, in
[-0.5, 0.5]^2 facebox space.
"""

from __future__ import annotations

import numpy as np


def load_mean(filename) -> np.ndarray:
    with open(filename, "r") as f:
        line = f.readline()
    values = [np.float32(v) for v in line.strip().split(",") if v.strip()]
    return np.asarray(values, np.float32)
