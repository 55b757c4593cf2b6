"""Placement policy of the port (mirrors ``repro/parallel``).

``rules.py`` holds the divisible-or-replicate policy that decides which
logical axes shard over which mesh axes.  The parts that place tensors on
a device mesh (``sharding_for``, ``use_rules_mesh``, ``constrain``) need
more than one card and are not ported: ROADMAP.md list 1b item 7.
"""
