"""Placement policy and SPMD seam of the port (mirrors ``repro/parallel``).

``rules.py`` holds the divisible-or-replicate policy that decides which
logical axes shard over which mesh axes.  ``compat.py`` is the SPMD seam
of every sharded body: ``shard_map``, ``all_gather``, ``axis_index`` and
the ambient mesh, over ``torch.distributed`` ranks (``launch/mesh.py``
makes the mesh and starts the ranks).  The parts of ``rules.py`` that
place tensors on a device mesh (``sharding_for``, ``use_rules_mesh``,
``constrain``) need ``DTensor`` and are not ported: ROADMAP.md list 1b
item 7.
"""
