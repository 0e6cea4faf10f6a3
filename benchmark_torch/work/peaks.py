"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit). A run writes the card's power limit beside
every share of them."""

FP32_FLOPS_PER_S = 67e12     # fp32 outside the tensor cores: what TF32-off fp32 runs on
HBM_BYTES_PER_S = 3.35e12
