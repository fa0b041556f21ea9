"""Production meshes; the port of `repro/launch/mesh.py`.

Defined as FUNCTIONS (never module-level values): a `DeviceMesh` is built
over the default process group, which the caller initialises first (the
dry-run: a fake group of 256 or 512 ranks).  `device_type` is the mesh's
device type, "cuda" by default: the dry-run's fake ranks touch no device,
and a "cpu" mesh would fall back to all-gathers for all-to-alls.

Hardware models for the rooflines (data-sheet figures, not measurements):
  * the JAX package's, kept so the port's roofline can be checked against
    JAX's: a TPU v5e-class chip, 197 TFLOP/s bf16, 819 GB/s HBM,
    ~50 GB/s a link of ICI;
  * the port's card: an NVIDIA H100 SXM5, 989 TFLOP/s dense bf16,
    3.35 TB/s HBM3, 450 GB/s NVLink 4 each direction.
"""
from __future__ import annotations

TPU_V5E_PEAK_FLOPS = 197e12  # bf16 per chip
TPU_V5E_HBM_BW = 819e9       # bytes/s per chip
TPU_V5E_ICI_BW = 50e9        # bytes/s per link

H100_PEAK_FLOPS = 989e12     # dense bf16, SXM5 data sheet
H100_HBM_BW = 3.35e12        # bytes/s, data sheet
H100_NVLINK_BW = 450e9       # bytes/s each direction, NVLink 4 data sheet


def _mesh(shape: tuple, axes: tuple, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_host_mesh(data: int = 4, model: int = 2, device_type: str = "cuda"):
    """Small mesh for multi-rank tests (a fake group of data x model ranks)."""
    return _mesh((data, model), ("data", "model"), device_type)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    sizes.setdefault("pod", 1)
    return sizes
