"""Published peaks of the card the cells run on (NVIDIA H100 SXM data
sheet, dense, at the 700 W limit)."""

HBM_BYTES_S = 3.35e12
