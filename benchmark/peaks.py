"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the full
700 W power limit; a card set lower runs slower under load)."""
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
