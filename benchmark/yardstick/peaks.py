"""The card's published peaks (NVIDIA's H100 data sheet, dense rates without
sparsity), frozen with the benchmark. They assume the card's full power
limit of 700 W; a run prints the limit it found beside its numbers."""

from __future__ import annotations

from typing import Optional

# dense bf16 tensor-core FLOP/s by `torch.cuda.get_device_name()`: the SXM
# part names itself "NVIDIA H100 80GB HBM3"
BF16_FLOPS = (
    ("h100 nvl", 835e12),
    ("h100 pcie", 756e12),
    ("h100 80gb hbm3", 989.4e12),
)
# the SXM part's float32 rate outside the tensor cores and its HBM3 bandwidth
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bf16_peak(device_name: str) -> Optional[float]:
    """The card's dense bf16 peak, or None for a card not in the table."""
    name = device_name.lower()
    return next((peak for sub, peak in BF16_FLOPS if sub in name), None)
