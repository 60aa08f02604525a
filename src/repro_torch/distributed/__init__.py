"""Tensor-parallel serving over `torch.distributed` (DESIGN §12)."""
