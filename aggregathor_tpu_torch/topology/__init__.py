"""Aggregation-tree topologies beyond the parameter-server star.

Counterpart of ``aggregathor_tpu/topology``, two planes over one spec:

- :mod:`~aggregathor_tpu_torch.topology.spec`: the ``tree:`` grammar and
  its parse-time budget arithmetic (``TreeSpec``), which the ``tree`` GAR
  (``gars/tree.py``, the in-step numerics) parses its arguments with;
- :mod:`~aggregathor_tpu_torch.topology.tree`: the host protocol
  (``TreeAggregator``: per-level bounded wait, chained custody, redundant
  reconstruction), driven once a round by ``parallel/bounded.py`` under the
  runner's ``--topology``.
"""

from .spec import TreeSpec, parse_topology_spec  # noqa: F401
from .tree import TreeAggregator  # noqa: F401
