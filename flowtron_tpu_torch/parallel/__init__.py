"""Data-parallel training over ``torch.distributed`` (``mesh.py``) and a
launcher of ranks on one host (``launch.py``)."""
