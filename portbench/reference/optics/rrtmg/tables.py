"""Load the RRTMG-IFS coefficient tables (numpy only).

The reference reads the same table file as the port,
ecrad_tpu/data/rrtmg_tables.npz at the root of the checkout: data, not
code. Keys are 'lw{band}_{name}' / 'sw{band}_{name}' plus the global
maps (g -> band, reference profiles, Planck LUT).
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

DEFAULT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            *[".."] * 4, "ecrad_tpu", "data",
                            "rrtmg_tables.npz")


def load_tables(path: str = DEFAULT_PATH) -> Dict[str, np.ndarray]:
    with np.load(os.path.abspath(path)) as z:
        return {k: np.asarray(z[k]) for k in z.files}
