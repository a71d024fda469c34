"""flashdeconv_tpu_torch: the FlashDeconv solve on PyTorch and CUDA.

A port of :mod:`flashdeconv_tpu` to one NVIDIA H100 (Hopper, ``sm_90a``):
the single-device fit on a banded (grid) spatial graph, with each BCD sweep
one launch of a hand-written CUDA kernel. The host stages (gene selection,
normalisation, CountSketch, the spatial graph) are the JAX package's own
numpy/scipy/C++ modules, imported; none of them imports JAX.

Quick start::

    from flashdeconv_tpu_torch import FlashDeconv
    proportions = FlashDeconv(sketch_dim=512).fit_transform(Y, X, coords)
"""

import os as _os

# The reused host modules live in flashdeconv_tpu, whose package init turns
# on JAX's compilation cache (importing jax) unless this variable is set.
# The port never uses JAX, and its card's machine has none.
_os.environ.setdefault("FLASHDECONV_NO_COMPILE_CACHE", "1")

from flashdeconv_tpu_torch.core.deconv import FlashDeconv  # noqa: E402

__all__ = ["FlashDeconv"]
