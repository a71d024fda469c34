"""Random-state handling for the port's host stages.

The port's own copy of :func:`flashdeconv_tpu.utils.random.check_random_state`:
the sketch operator is drawn with ``numpy.random.RandomState`` (MT19937), so
an integer seed gives the same buckets, signs and amplitudes as the JAX
package and the reference. :func:`as_torch_generator` is the torch
counterpart of the JAX package's key bridge, for on-device randomness (none
is needed in the core pipeline today).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

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


def as_torch_generator(seed: RandomStateLike, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from a host seed
    specification, as the JAX package's ``as_jax_key`` derives a key: an
    int seeds it directly; for ``None`` or a ``RandomState`` a fresh 32-bit
    seed is drawn from the host RNG (non-reproducible for ``None``,
    stream-consistent for a ``RandomState``)."""
    if isinstance(seed, (int, np.integer)):
        value = int(seed)
    else:
        value = int(check_random_state(seed).randint(0, 2**31 - 1))
    return torch.Generator(device=device).manual_seed(value)
