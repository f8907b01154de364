"""SCHP semantic palette (host-side numpy): the part of
``relightableavatar_tpu/utils/semantics.py`` the dataset uses (reference
``lib/utils/sem_utils.py``): color-coded maps to one-hot class maps."""
from __future__ import annotations

from functools import lru_cache

import numpy as np

SEMANTIC_LIST = [
    'background', 'hat', 'hair', 'glove', 'sunglasses', 'upper_cloth',
    'dress', 'coat', 'sock', 'pant', 'jumpsuit', 'scarf', 'skirt', 'face',
    'left_leg', 'right_leg', 'left_arm', 'right_arm', 'left_shoe',
    'right_shoe',
]
SEMANTIC_DIM = len(SEMANTIC_LIST)


@lru_cache
def schp_palette(num_cls: int = 256) -> np.ndarray:
    """(num_cls, 3) uint8: SCHP's VOC-style bit-spread colormap
    (sem_utils.py:73-99)."""
    pal = np.zeros((num_cls, 3), np.uint8)
    for j in range(num_cls):
        lab, i = j, 0
        r = g = b = 0
        while lab:
            r |= ((lab >> 0) & 1) << (7 - i)
            g |= ((lab >> 1) & 1) << (7 - i)
            b |= ((lab >> 2) & 1) << (7 - i)
            i += 1
            lab >>= 3
        pal[j] = (r, g, b)
    return pal


def color_to_index(sem_rgb: np.ndarray, num_cls: int = SEMANTIC_DIM) -> np.ndarray:
    """Color-coded map (..., 3) -> class indices (...,) uint8; unknown
    colors map to 0 (background)."""
    pal = schp_palette(num_cls)
    flat = sem_rgb.reshape(-1, 3).astype(np.int16)
    out = np.zeros(flat.shape[0], np.uint8)
    for i in range(1, num_cls):
        out[(flat == pal[i].astype(np.int16)).all(-1)] = i
    return out.reshape(sem_rgb.shape[:-1])


def color_to_onehot(sem_rgb: np.ndarray, num_cls: int = SEMANTIC_DIM) -> np.ndarray:
    return np.eye(num_cls, dtype=np.float32)[color_to_index(sem_rgb, num_cls).astype(np.int64)]
