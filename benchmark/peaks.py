"""Published peaks of the chips the benchmark runs on, by the name
torch.cuda.get_device_name() gives.  NVIDIA's H100 data sheet, SXM part,
dense rates at the full 700 W: a card set below it (nvidia-smi's
power.limit, which every run reports) runs slower under load."""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "int8_ops_per_s": 1979e12,
        "fp32_flops_per_s": 67e12,
    },
}


def peak(kind: str, what: str) -> float:
    """One peak of the card `kind`; the H100's for an unlisted card name
    of the same part (KeyError for any other)."""
    if kind not in PEAKS and kind.startswith("NVIDIA H100"):
        kind = "NVIDIA H100 80GB HBM3"
    return PEAKS[kind][what]
