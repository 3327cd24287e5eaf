"""The card's published peaks and the least time of a piece of work.

NVIDIA H100 SXM5 data sheet, dense rates at the 700 W limit: 3.35 TB/s of
HBM3, 67 TFLOP/s float32 outside the tensor cores, and PCIe Gen5 x16 at
64 GB/s each way (128 GB/s both ways). A run states the card's power limit
beside every share of these (``nvidia-smi``).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
PCIE_BYTES_PER_S = 64e9


def least_seconds(work: dict) -> float:
    """The least time of ``work`` (``bytes`` moved through device memory,
    ``flops`` float32 operations, ``pcie_bytes`` across the host link): the
    slowest of the three resources, each at its peak."""
    return max(
        work.get("bytes", 0.0) / HBM_BYTES_PER_S,
        work.get("flops", 0.0) / F32_FLOPS_PER_S,
        work.get("pcie_bytes", 0.0) / PCIE_BYTES_PER_S,
    )


def bound_by(work: dict) -> str:
    """Which resource sets :func:`least_seconds`."""
    times = {
        "bytes": work.get("bytes", 0.0) / HBM_BYTES_PER_S,
        "operations": work.get("flops", 0.0) / F32_FLOPS_PER_S,
        "pcie": work.get("pcie_bytes", 0.0) / PCIE_BYTES_PER_S,
    }
    return max(times, key=times.get)
