"""Byte counts of the coding ops, functions of their shapes alone.

Frozen with the benchmark: the rooflines and the whole-op share divide these
by the card's bandwidth (`peaks.py`), so they read the same work whatever
implements it.  The program holds a field symbol as int32 on the device
(4 bytes); a user's data symbol is 16 bits (2 bytes).

- user data of any op on a stripe: K * W * 2;
- encode: the K data rows read once and the R parity rows written once;
- degraded read: the K survivor rows read, the erased data rows written;
- rebuild: the K survivor rows read, every erased row written.
"""
from __future__ import annotations

DEVICE_SYMBOL_BYTES = 4
USER_SYMBOL_BYTES = 2


def user_bytes(K: int, W: int) -> int:
    return K * W * USER_SYMBOL_BYTES


def encode_bytes(K: int, R: int, W: int) -> int:
    return (K + R) * W * DEVICE_SYMBOL_BYTES


def read_bytes(K: int, W: int, erased_data: int) -> int:
    return (K + erased_data) * W * DEVICE_SYMBOL_BYTES


def rebuild_bytes(K: int, W: int, erased: int) -> int:
    return (K + erased) * W * DEVICE_SYMBOL_BYTES
