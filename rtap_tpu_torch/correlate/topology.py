"""Node/service topology for incident correlation.

The port's copy of the JAX package's ``correlate/topology.py``.

The correlator groups per-stream alerts by WHERE they happened: streams
belong to nodes (``node03.cpu`` -> ``node03``), nodes belong to services,
and services may be linked (a dependency edge — a database brown-out
pages its web tier too). Two nodes are ADJACENT when their services are
the same or linked; the correlator folds alerts per connected component
of that adjacency graph (the blast-radius unit).

Two construction paths, one class:

- :meth:`TopologyMap.from_spec` — an operator-authored JSON spec::

      {"services": {"web": ["node00", "node01"], "db": ["node02"]},
       "links": [["web", "db"]]}

  Every node name is a stream-id prefix (the part before the last
  ``.``); unknown nodes fall into the ``"?"`` catch-all service so a
  stream outside the spec degrades to per-node correlation instead of
  crashing the serve loop.

- :meth:`TopologyMap.infer` — zero-config inference from stream-name
  prefixes: node = prefix before the last ``.``, service = the node
  name with its trailing digits (and separator) stripped, so
  ``web-01.cpu``/``web-02.mem`` share service ``web`` and
  ``node00003.net`` lands in ``node``. No links. This is the
  ``serve --topology infer`` path and matches both synthetic-generator
  naming families (``node{i:05d}.{metric}``, ``{svc}-{i:02d}.{metric}``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

__all__ = ["TopologyMap"]

#: catch-all service for nodes a spec does not name: they still correlate
#: (with each other per node), never crash the loop
UNKNOWN_SERVICE = "?"


def node_of_stream(stream_id: str) -> str:
    """Stream id -> node name: the prefix before the LAST dot (the
    repo-wide ``<node>.<metric>`` naming); a dotless id is its own node."""
    node, sep, _metric = stream_id.rpartition(".")
    return node if sep else stream_id


def service_of_node(node: str) -> str:
    """Inference rule: strip trailing digits and one trailing separator,
    so ``web-01`` -> ``web``, ``node00003`` -> ``node``, ``db2`` -> ``db``.
    An all-digit node keeps its full name (its own service)."""
    base = node.rstrip("0123456789")
    base = base.rstrip("-_.")
    return base if base else node


@dataclass
class TopologyMap:
    """node -> service assignment + service adjacency -> connected
    components (the correlation clusters)."""

    #: node name -> service name
    services: dict[str, str] = field(default_factory=dict)
    #: undirected service-dependency edges
    links: list[tuple[str, str]] = field(default_factory=list)
    #: True = nodes absent from `services` infer their service by prefix
    #: (the zero-config mode); False = they fold into UNKNOWN_SERVICE
    infer_unknown: bool = False

    def __post_init__(self) -> None:
        self._component: dict[str, str] = {}
        self._rebuild_components()

    # ---- construction ----
    @classmethod
    def from_spec(cls, spec: dict | str) -> "TopologyMap":
        """Build from a spec dict, a JSON string, or a file path."""
        if isinstance(spec, str):
            if spec.lstrip().startswith("{"):
                spec = json.loads(spec)
            else:
                with open(spec) as f:
                    spec = json.load(f)
        if not isinstance(spec, dict) or "services" not in spec:
            raise ValueError(
                'topology spec must be an object with a "services" map '
                '({"services": {"svc": ["node", ...]}, "links": [...]})')
        services: dict[str, str] = {}
        for svc, nodes in spec["services"].items():
            if not isinstance(nodes, (list, tuple)):
                raise ValueError(
                    f'topology spec: services[{svc!r}] must be a node list')
            for node in nodes:
                if node in services:
                    raise ValueError(
                        f"topology spec: node {node!r} appears in services "
                        f"{services[node]!r} and {svc!r}")
                services[str(node)] = str(svc)
        links = []
        for pair in spec.get("links", []):
            if not (isinstance(pair, (list, tuple)) and len(pair) == 2):
                raise ValueError(
                    f"topology spec: links entries are [svcA, svcB] pairs; "
                    f"got {pair!r}")
            links.append((str(pair[0]), str(pair[1])))
        known = set(spec["services"])
        for a, b in links:
            missing = {a, b} - known
            if missing:
                raise ValueError(
                    f"topology spec: link {(a, b)} names undeclared "
                    f"service(s) {sorted(missing)}")
        return cls(services=services, links=links)

    @classmethod
    def infer(cls) -> "TopologyMap":
        """Zero-config topology: every node's service is its stripped
        name prefix (see :func:`service_of_node`), no links."""
        return cls(infer_unknown=True)

    # ---- queries ----
    def service_of(self, node: str) -> str:
        svc = self.services.get(node)
        if svc is not None:
            return svc
        return service_of_node(node) if self.infer_unknown else UNKNOWN_SERVICE

    def node_of(self, stream_id: str) -> str:
        return node_of_stream(stream_id)

    def cluster_of(self, stream_id: str) -> str:
        """Stream id -> correlation-cluster key: the connected component
        (over service links) of the stream's node's service. Services
        never declared and never linked are their own component."""
        return self._component_of(self.service_of(self.node_of(stream_id)))

    def adjacent(self, node_a: str, node_b: str) -> bool:
        """Blast-radius adjacency: same service, or linked services
        (transitively — components are the correlation unit)."""
        return self._component_of(self.service_of(node_a)) \
            == self._component_of(self.service_of(node_b))

    # ---- internals ----
    def _rebuild_components(self) -> None:
        parent: dict[str, str] = {}

        def find(x: str) -> str:
            parent.setdefault(x, x)
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for svc in sorted(set(self.services.values())):
            find(svc)
        for a, b in self.links:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb
        # canonical component name: lexicographically smallest member, so
        # cluster keys are deterministic across processes/restarts
        members: dict[str, list[str]] = {}
        for svc in parent:
            members.setdefault(find(svc), []).append(svc)
        self._component = {
            svc: min(group)
            for root, group in members.items() for svc in group
        }

    def _component_of(self, svc: str) -> str:
        got = self._component.get(svc)
        if got is not None:
            return got
        # an inferred/unknown service unseen at build time is its own
        # component; cache so repeated lookups stay O(1)
        self._component[svc] = svc
        return svc

    def stats(self) -> dict:
        return {
            "declared_nodes": len(self.services),
            "services": len(set(self.services.values())),
            "links": len(self.links),
            "inferring": self.infer_unknown,
        }
