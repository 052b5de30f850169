"""Data-parallel sync algorithms over ``torch.distributed``."""
