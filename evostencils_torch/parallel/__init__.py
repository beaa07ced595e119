"""Population dispatch: evaluate a generation's individuals in threads of
one process or split across torch.distributed processes."""
