"""Launch-layer components of the port: the coalescing `CodingQueue`
behind `CodedSystem.submit` (`launch.coding_queue`)."""
from .coding_queue import CodingQueue, QueueStats

__all__ = ["CodingQueue", "QueueStats"]
