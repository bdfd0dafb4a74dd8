"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name()`` gives (NVIDIA's data sheets; SXM parts,
at their full power limit)."""

from __future__ import annotations

# name prefix -> HBM bytes/s
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_bytes_per_s(device_name: str) -> float | None:
    for prefix, bw in HBM_BYTES_PER_S.items():
        if device_name.startswith(prefix):
            return bw
    return None
