"""Distributed training support: the fault-tolerant step loop
(``fault.py``).  The mesh, compression and resharding modules of the
JAX package are not ported yet (ROADMAP.md §1)."""
