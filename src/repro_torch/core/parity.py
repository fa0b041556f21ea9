"""Any-K-of-N reconstruction of a structured GRS codeword (`reconstruct`).

The counterpart of the JAX package's `core/parity.py` holds its host half
only.  Its mesh half — `ParityTables`, `build_parity_tables`,
`build_encode_tables` and `mesh_parity_encode`, the Sec. III-A parity
encode across a device axis — comes with the port's mesh backend, which
is still to be ported (ROADMAP queue 1 item 7).
"""
from __future__ import annotations

import numpy as np

from .cauchy import StructuredGRS
from .field import FERMAT_Q, Field
from .matrices import gauss_inverse


def reconstruct(field: Field, sgrs: StructuredGRS, kept: np.ndarray,
                vals: np.ndarray, *, device=None) -> np.ndarray:
    """Any-K-of-N decode: kept (K,) codeword indices, vals (K, W) symbols
    -> the (K, W) data as numpy int64.

    For the Fermat field the solve runs on `kernels.gf_solve` on `device`
    (None means "cuda"; exact Gauss-Jordan inverse, then the `gf_matmul`
    kernel); other fields keep the exact numpy host path and touch no
    device.  Both are exact mod q, so the result is bitwise identical
    either way.
    """
    K = sgrs.K
    A = sgrs.grs.A_direct()
    G = np.concatenate([np.eye(K, dtype=np.int64), A], axis=1)
    sub = G[:, kept]  # K x K
    if field.q == FERMAT_Q:
        from ..kernels.gf_solve import gf_solve

        x = gf_solve(sub.T % FERMAT_Q, field.arr(vals), device=device)
        return x.cpu().numpy().astype(np.int64)
    return field.matmul(gauss_inverse(field, sub.T), field.arr(vals))
