"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit), frozen here from
`chip_smoke.py` (`HBM_BPS`, `PEAK_FLOPS`) so that a change to the program
cannot move the yardstick."""

#: HBM3 bytes per second
HBM_BPS = 3.35e12
#: dense bf16 tensor-core operations per second
BF16_FLOPS = 989e12
