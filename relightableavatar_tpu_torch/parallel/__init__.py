"""Multi-GPU helpers: the ray mesh over a ``torch.distributed`` process group."""
