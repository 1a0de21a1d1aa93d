"""Aggregation-tree topologies: the ``tree:`` grammar.

Counterpart of ``aggregathor_tpu/topology`` for its spec alone
(:mod:`~aggregathor_tpu_torch.topology.spec`, ``TreeSpec``), which the
``tree`` GAR (``gars/tree.py``) parses its arguments with.  The host
protocol (``topology/tree.py``, ``TreeAggregator``) is not ported.
"""

from .spec import TreeSpec, parse_topology_spec  # noqa: F401
