"""Host-side core of the PyTorch port: the finite field and the numpy
planning layer (point sets, structured GRS codes, the round simulator, the
schedule IR every plan's round program lowers from, the Sec. III framework
generators, and the Table-I cost model).

Every module here except `field`, `shardmap_exec` and `parity` is a copy of
its counterpart in the JAX package, kept so that this package imports
nothing of it.  `field` adds the torch int64 `fermat_*` functions the
kernels' plain versions use; `shardmap_exec` and `parity` copy the JAX
package's numpy table builders and run the mesh bodies on a processor
mesh of torch ranks (`shardmap_exec.ProcMesh`).
"""
from . import cost_model, schedule
from .cauchy import StructuredGRS as StructuredGRSCode, cost_cauchy
from .dft_a2a import cost_dft
from .draw_loose import cost_draw_loose
from .field import FERMAT, FERMAT_Q, Field
from .framework import decentralized_encode, nonsystematic_encode
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
from .schedule import (
    RoundIR,
    ScheduleValidationError,
    build_decode_ir,
    build_encode_ir,
    build_universal_a2a_ir,
)
from .schedule import execute as execute_schedule
from .simulator import (
    FailedProcessorError,
    FaultInjector,
    Msg,
    PartialRunError,
    PortViolationError,
    RoundNetwork,
    run_lockstep,
)

__all__ = [
    "FERMAT", "FERMAT_Q", "Field", "Msg", "RoundNetwork", "run_lockstep",
    "FailedProcessorError", "FaultInjector", "PartialRunError",
    "PortViolationError",
    "schedule", "RoundIR", "ScheduleValidationError",
    "build_encode_ir", "build_decode_ir", "build_universal_a2a_ir",
    "execute_schedule", "decentralized_encode", "nonsystematic_encode",
    "cost_universal", "cost_dft", "cost_draw_loose", "cost_cauchy",
    "StructuredPoints", "SystematicGRS", "StructuredGRSCode",
    "dft_matrix", "permuted_dft_matrix", "vandermonde", "gauss_inverse",
    "lagrange_matrix", "cost_model",
]
