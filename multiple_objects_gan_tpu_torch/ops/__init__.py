"""The port's STN ops under the names the JAX package's ``ops`` exports
(``multiple_objects_gan_tpu/ops/__init__.py``). As there, ``ops.stn`` is
the general STN function; the module is
``importlib.import_module("multiple_objects_gan_tpu_torch.ops.stn")``.

Importing the package registers the operators ``mog::stn_place_multi`` and
``mog::stn_place_multi_grad`` (``ops/stn_place_cuda.py``), which a program
saved by ``torch.export`` (``tools/export_model.py``) needs when it is
loaded."""

from multiple_objects_gan_tpu_torch.ops.stn import (
    affine_grid,
    grid_sample,
    stn,
    stn_extract,
    stn_extract_multi,
    stn_place,
    stn_place_const_multi,
    stn_place_multi,
    stn_separable,
    transformation_matrix,
    transformation_matrix_inverse,
)
from multiple_objects_gan_tpu_torch.ops import stn_place_cuda  # noqa: F401

__all__ = [
    "affine_grid",
    "grid_sample",
    "stn",
    "stn_extract",
    "stn_extract_multi",
    "stn_place",
    "stn_place_const_multi",
    "stn_place_multi",
    "stn_separable",
    "transformation_matrix",
    "transformation_matrix_inverse",
]
