"""Distributed training support, PyTorch port of ``src/repro/distributed/``:
logical-axis sharding rules on a ``DeviceMesh`` (``mesh.py``), int8
cross-pod gradient compression (``compression.py``), multipath
resharding (``resharding.py``) and the fault-tolerant step loop
(``fault.py``, an own copy)."""
