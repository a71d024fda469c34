"""flashdeconv_tpu_torch: the FlashDeconv pipeline on PyTorch and CUDA.

A port of :mod:`flashdeconv_tpu` to NVIDIA Hopper cards (``sm_90a``): the
single-device fit on any spatial graph and the spot-sharded fit over a
mesh of torch devices. At f32 with up to 256 cell types each BCD sweep is
one launch of a hand-written CUDA kernel — the fused banded sweep on
banded grids, the coordinate-descent pass after plain-PyTorch neighbour
sums on every other graph; an f64 solve, or one of more than 256 types,
runs the JAX package's XLA coordinate-descent tier in plain PyTorch, as
the JAX package does. Dense counts are sketched by a CUDA CountSketch
kernel. On the card the fit keeps beta there and fetches only the
proportions (in ``fetch_dtype``) or the dominant type; ``FlashDeconv``
also has warm starts, ``fit_lambda_path`` and ``save`` / ``load``,
``tl.deconvolve`` runs it on AnnData and ``pl`` plots its results. The
host stages (gene selection, normalisation, CountSketch, the spatial
graph, the AnnData layer, the plots) are the port's own copies of the JAX
package's numpy/scipy/C++/matplotlib modules; the port imports
nothing of JAX or of the JAX package.

Quick start (array API)::

    from flashdeconv_tpu_torch import FlashDeconv
    proportions = FlashDeconv(sketch_dim=512).fit_transform(Y, X, coords)

Quick start (scanpy-style API)::

    import flashdeconv_tpu_torch as fdt
    fdt.tl.deconvolve(adata_st, adata_ref, cell_type_key="cell_type")
    adata_st.obsm["flashdeconv"]                       # proportions
"""

__version__ = "0.5.0"

from flashdeconv_tpu_torch.core.deconv import FlashDeconv
from flashdeconv_tpu_torch import pl, tl

__all__ = ["FlashDeconv", "tl", "pl", "__version__"]
