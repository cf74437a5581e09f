"""Published peaks of one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet, dense,
at the full 700 W power limit). A share of a roofline is stated against
these, with the card's power limit printed beside it."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
