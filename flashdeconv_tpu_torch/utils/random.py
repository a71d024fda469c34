"""Random-state handling for the port's host stages.

The port's own copy of :func:`flashdeconv_tpu.utils.random.check_random_state`:
the sketch operator is drawn with ``numpy.random.RandomState`` (MT19937), so
an integer seed gives the same buckets, signs and amplitudes as the JAX
package and the reference.
"""

from __future__ import annotations

from typing import Union

import numpy as np

RandomStateLike = Union[None, int, np.random.RandomState]


def check_random_state(seed: RandomStateLike) -> np.random.RandomState:
    """Coerce ``seed`` into a ``numpy.random.RandomState`` (sklearn convention).

    Parameters
    ----------
    seed : None, int, or numpy.random.RandomState
        ``None`` returns the global numpy RandomState singleton; an int seeds a
        fresh ``RandomState``; an existing ``RandomState`` passes through.

    Returns
    -------
    numpy.random.RandomState
    """
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, (int, np.integer)):
        return np.random.RandomState(int(seed))
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(
        f"{seed!r} cannot be used to seed a numpy.random.RandomState instance. "
        f"Expected None, int, or np.random.RandomState, got {type(seed)}."
    )
