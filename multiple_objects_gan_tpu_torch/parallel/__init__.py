"""Multi-process data parallelism over ``torch.distributed``: the process
group from the environment (``multihost.py``) and the collectives of the
data-parallel step (``mesh.py``)."""
