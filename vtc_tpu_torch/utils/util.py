"""Small helpers of the reference's ``utils/util.py``, the port's own copy
of ``vtc_tpu/utils/util.py``'s ``inf_loop`` and ``is_image_like_batch``."""

from __future__ import annotations

from itertools import repeat


def is_image_like_batch(obj) -> bool:
    """True if ``obj`` looks like a batch of RGB images ([b, 3, h, w] or
    [b, h, w, 3]). Mirrors ``utils/util.py:10-12``."""
    shape = getattr(obj, "shape", None)
    if shape is None or len(shape) != 4:
        return False
    return shape[1] == 3 or shape[-1] == 3


def inf_loop(data_loader):
    """Endless data loader wrapper (``utils/util.py:72-75``)."""
    for loader in repeat(data_loader):
        yield from loader
