"""Meshes of ranks and multi-process runs on ``torch.distributed``."""
