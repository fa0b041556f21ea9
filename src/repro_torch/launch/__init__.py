"""Launch-layer components of the port: the coalescing `CodingQueue`
behind `CodedSystem.submit` (`launch.coding_queue`), and the multi-tenant
`CodedService` over pooled sessions (`launch.service`) with its admission
control (`launch.tenancy`)."""
from .coding_queue import CodingQueue, QueueStats
from .service import CodedService, QueueFullError, ServiceStats, TenantQuota

__all__ = ["CodingQueue", "QueueStats", "CodedService", "QueueFullError",
           "ServiceStats", "TenantQuota"]
