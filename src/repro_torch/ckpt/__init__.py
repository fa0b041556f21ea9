"""Coded checkpoints of the port: `CodedCheckpointer` writes the JAX
package's checkpoint files byte for byte, with parity and repair on the
card."""
from .checkpoint import CodedCheckpointer, bytes_to_tree, tree_to_bytes

__all__ = ["CodedCheckpointer", "tree_to_bytes", "bytes_to_tree"]
