"""Multi-device rendering on ``torch.distributed``: one process (rank) per
mesh position (``mesh.py``), the dp/sp/tp sharded renderer (``shard.py``,
``scene_shard.py``, ``ring.py``), the bounce pipeline (``pp.py``) and
windowed, checkpointed renders (``multihost.py``)."""
