"""Placement policy and SPMD seam of the port (mirrors ``repro/parallel``).

``rules.py`` holds the divisible-or-replicate policy that decides which
logical axes shard over which mesh axes, and places tensors by it on a
``DeviceMesh`` as ``DTensor``s (``sharding_for``, ``use_rules_mesh``,
``constrain``).  ``compat.py`` is the SPMD seam of every sharded body:
``shard_map``, ``all_gather``, ``axis_index`` and the ambient mesh, over
``torch.distributed`` ranks (``launch/mesh.py`` makes the mesh and starts
the ranks).  ``staged.py`` builds and registers the collective backend of
ranks that share one card.
"""
