"""Payloads that the port's session must reduce mod q exactly as NumPy's
`%` does, wherever it takes the residues: negatives, values >= q, int64's
extremes, int32 rows, and arrays that are not C-contiguous.  Shared by the
CPU tests and the card's tests (imports neither JAX nor the JAX package)."""
import numpy as np

Q = 65537
I64, I32 = np.iinfo(np.int64), np.iinfo(np.int32)

KINDS = ["negatives", "above_q", "int64_extremes", "int32", "column_stride",
         "row_slice", "reversed_rows", "fortran"]


def payload(kind: str, rows: int, cols: int, seed: int) -> np.ndarray:
    """A (rows, cols) payload of `kind`, from `seed`."""
    rng = np.random.default_rng(seed)
    if kind == "negatives":
        return rng.integers(-3 * Q, 3 * Q, (rows, cols))
    if kind == "above_q":
        return rng.integers(Q, 1 << 40, (rows, cols))
    if kind == "int64_extremes":
        x = rng.integers(I64.min, I64.max, (rows, cols), endpoint=True)
        x.flat[:6] = [I64.min, I64.max, -1, -Q, Q, I64.min + 1][:x.size]
        return x
    if kind == "int32":
        x = rng.integers(I32.min, I32.max, (rows, cols), np.int32,
                         endpoint=True)
        x.flat[:4] = [I32.min, I32.max, -1, -Q][:x.size]
        return x
    wide = rng.integers(-2 * Q, 2 * Q, (rows + 3, 3 * cols + 5))
    if kind == "column_stride":
        return wide[:rows, ::3][:, :cols]
    if kind == "row_slice":
        return wide[2:2 + rows, 5:5 + cols]
    if kind == "reversed_rows":
        return wide[:rows, :cols][::-1]
    if kind == "fortran":
        return np.asfortranarray(wide[:rows, :cols])
    raise ValueError(kind)
