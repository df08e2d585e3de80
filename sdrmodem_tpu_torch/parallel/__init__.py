"""Sharding over a device mesh: channels (``channels.py``), time
(``time_shard.py``), and the mesh with its collectives (``mesh.py``)."""
