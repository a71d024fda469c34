"""AnnData IO adapters of the port (anndata / pandas are optional
dependencies): copies of :mod:`flashdeconv_tpu.io`."""

from flashdeconv_tpu_torch.io.loader import (
    align_genes,
    load_reference,
    load_spatial_data,
    prepare_data,
    result_to_anndata,
)

__all__ = [
    "load_spatial_data",
    "load_reference",
    "align_genes",
    "result_to_anndata",
    "prepare_data",
]
