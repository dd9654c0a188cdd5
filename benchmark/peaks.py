"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit), by the tower's
product dtype."""

FLOPS_PER_S = {
    "bfloat16": 989e12,
    "int8": 1979e12,
}
HBM_BYTES_PER_S = 3.35e12
