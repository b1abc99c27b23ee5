"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense, no
sparsity, at the 700 W limit): what a roofline share or an MFU is taken
against. A card set below 700 W reaches less; the run prints its limit."""

BF16_FLOPS = 989e12       # tensor cores, bf16 dense
HBM_BYTES_PER_S = 3.35e12
