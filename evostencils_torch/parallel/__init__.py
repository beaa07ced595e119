"""Population dispatch (dispatch.py: threads of one process, or
torch.distributed processes splitting a generation) and grids split by rows
over a (dp, sp) device mesh (mesh.py)."""
