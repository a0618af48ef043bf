"""Peaks of one NVIDIA H100 SXM (80 GB HBM3), the card the cells run on.

Each share of a peak in this benchmark is stated against these published
numbers, with the card's power limit beside it (``card_state``): a card set
below its 700 W limit runs slower under load.
"""

from __future__ import annotations

import subprocess

# HBM3 bandwidth, NVIDIA H100 SXM data sheet
HBM_BYTES_PER_S = 3.35e12
# non-tensor float32 rate, NVIDIA H100 SXM data sheet; taken for the int32
# compares the range joins issue on the same CUDA cores (an optimistic rate,
# so the bound stays a lower bound), as the port's kernel table does
COMPARES_PER_S = 67e12
# device memory, NVIDIA H100 SXM data sheet
MEMORY_BYTES = 80e9
# the power limit the published rates assume, NVIDIA H100 SXM data sheet
PUBLISHED_POWER_W = 700.0


def card_state() -> dict:
    """The card's name, power limit and SM clock as ``nvidia-smi`` reads them
    (empty where it cannot run)."""
    fields = ("name", "power.limit", "clocks.sm", "clocks.max.sm")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(fields)}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {}
    return dict(zip(fields, (v.strip() for v in out.split(","))))
