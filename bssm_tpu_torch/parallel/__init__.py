"""Chain- and draw-parallel runs over ``torch.distributed`` (``mesh.py``)
and the multi-process bootstrap (``distributed.py``)."""
