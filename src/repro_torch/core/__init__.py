"""Host-side core of the PyTorch port: the finite field and the numpy
planning layer (point sets, structured GRS codes, the round simulator the
schedule modules are written against, and the Table-I cost model).

Every module here except `field` is a copy of its counterpart in the JAX
package, kept so that this package imports nothing of it.  `field` adds the
torch int64 `fermat_*` functions the kernels' plain versions use.
"""
from . import cost_model
from .cauchy import StructuredGRS as StructuredGRSCode, cost_cauchy
from .dft_a2a import cost_dft
from .draw_loose import cost_draw_loose
from .field import FERMAT, FERMAT_Q, Field
from .matrices import (
    StructuredPoints,
    SystematicGRS,
    dft_matrix,
    gauss_inverse,
    lagrange_matrix,
    permuted_dft_matrix,
    vandermonde,
)
from .prepare_shoot import cost_universal
from .simulator import Msg, RoundNetwork, run_lockstep

__all__ = [
    "FERMAT", "FERMAT_Q", "Field", "Msg", "RoundNetwork", "run_lockstep",
    "cost_universal", "cost_dft", "cost_draw_loose", "cost_cauchy",
    "StructuredPoints", "SystematicGRS", "StructuredGRSCode",
    "dft_matrix", "permuted_dft_matrix", "vandermonde", "gauss_inverse",
    "lagrange_matrix", "cost_model",
]
