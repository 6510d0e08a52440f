"""``torch.load`` with ``weights_only=True`` for files that may hold numpy values.

The reference's ``.pth`` row lists, ``seq2pat_data.pth`` and ``.ckpt`` files
are ``torch.save`` pickles that can hold numpy scalars and arrays besides
Python containers and tensors. ``weights_only=True`` refuses those unless
their classes are allow-listed; :func:`load_with_numpy` allows exactly the
ones numpy's pickles name (``numpy.dtype`` and its concrete dtype classes,
``ndarray``, ``multiarray.scalar`` and ``multiarray._reconstruct``), and no
other code.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch


def numpy_safe_globals() -> List[Any]:
    """The allow-list: numpy >= 2 keeps ``multiarray`` under ``numpy._core``,
    older numpy under ``numpy.core``. A file written by numpy 1 names the
    ``numpy.core`` path, so under numpy 2 those names are allowed too."""
    core = getattr(np, "_core", None) or np.core
    multiarray = core.multiarray
    allowed: List[Any] = [np.dtype, np.ndarray, multiarray.scalar, multiarray._reconstruct]
    allowed += sorted({type(np.dtype(code)) for code in np.typecodes["All"]}, key=str)
    if multiarray.__name__ != "numpy.core.multiarray":
        allowed += [(multiarray.scalar, "numpy.core.multiarray.scalar"),
                    (multiarray._reconstruct, "numpy.core.multiarray._reconstruct")]
    return allowed


def load_with_numpy(path: str, **kwargs) -> Any:
    """``torch.load(path, weights_only=True, **kwargs)`` with numpy's pickled
    classes allowed."""
    with torch.serialization.safe_globals(numpy_safe_globals()):
        return torch.load(path, weights_only=True, **kwargs)
