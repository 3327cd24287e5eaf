"""HostGraph — cross-instance discovery, identity and topology.

The port's own copy of :mod:`signalizer_tpu.stream.host_graph` (behaviour
unchanged), with a class-level registry of its own: nodes of the two
packages never see each other. Host-side equivalent of the reference's HostGraph
(ref: Source/Common/HostGraph.{h,cpp}): an in-process registry of all live
analysis nodes, 16-byte UUID identities (SerializedHandle,
HostGraph.h:61-107), a persistent directed-port-pair edge set that
*outlives peers* (edges to missing nodes are kept and re-bound when a
matching instance reappears — tryRebuildTopology, HostGraph.cpp:644-663),
alias chains when a preset clones an identity (changeIdentity cases,
HostGraph.cpp:171-227; resurrectNextAlias :229-246), and serialization
policy control (Full / IgnoreSession / IgnoreAlways, HostGraph.h:194-263).

Known reference bugs avoided by construction (reference
Source/Notes/Bugs.txt): (1) alias self-connection after graph reload is
rejected in ``connect``; (2) edges validate channel counts against the
*source's actual* channel count at mix time, not an assumed stereo pair.
"""

from __future__ import annotations

import enum
import threading
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from signalizer_tpu_torch.state.serialize import Archive


class SerializationControl(enum.IntEnum):
    """ref: HostGraph.h:194-263."""

    FULL = 0
    IGNORE_SESSION = 1  # don't restore session topology
    IGNORE_ALWAYS = 2  # never serialize topology


@dataclass(frozen=True, order=True)
class PortPair:
    """Directed channel mapping: source channel -> destination channel
    (ref: DirectedPortPair)."""

    source: int
    destination: int


@dataclass
class GraphModel:
    """Snapshot for UIs (ref: HostGraph::getModel, HostGraph.cpp:289-367)."""

    nodes: List[dict] = field(default_factory=list)
    # (source_id_hex, dest_id_hex, PortPair); missing sources keep edges
    edges: List[Tuple[str, str, PortPair]] = field(default_factory=list)
    missing: List[str] = field(default_factory=list)


class HostGraph:
    """One node in the in-process graph.

    The class-level registry mirrors the reference's staticMutex/staticSet
    (HostGraph.cpp:36-37). Each node carries its own persistent topology:
    the set of (source identity -> port pairs) it mixes from.
    """

    _registry_lock = threading.Lock()
    _registry: Dict[bytes, "HostGraph"] = {}
    _alias_chains: Dict[bytes, List["HostGraph"]] = {}

    def __init__(self, name: str = "", channels: int = 2):
        self.node_id: bytes = uuid.uuid4().bytes  # 16-byte identity
        self.name = name or f"node-{self.node_id.hex()[:8]}"
        self.channels = channels
        self.serialization_control = SerializationControl.FULL
        # identity -> set of port pairs; survives peer death
        self.topology: Dict[bytes, Set[PortPair]] = {}
        self._lock = threading.Lock()
        self._topology_listeners: List[Callable[[], None]] = []
        self._alive = True
        with HostGraph._registry_lock:
            HostGraph._registry[self.node_id] = self
        self._broadcast_created()

    # --- registry ------------------------------------------------------------
    @classmethod
    def live_nodes(cls) -> List["HostGraph"]:
        with cls._registry_lock:
            return list(cls._registry.values())

    @classmethod
    def find(cls, node_id: bytes) -> Optional["HostGraph"]:
        with cls._registry_lock:
            return cls._registry.get(node_id)

    def _broadcast_created(self) -> None:
        """ref: broadcastCreate -> every node retries rebinding missing
        edges (onNodeCreated -> tryRebuildTopology, HostGraph.cpp:736-749)."""
        for node in HostGraph.live_nodes():
            node._notify_topology()

    def close(self) -> None:
        """Node destruction: unregister, resurrect next alias if any
        (ref: resurrectNextAlias, HostGraph.cpp:229-246)."""
        if not self._alive:
            return
        self._alive = False
        with HostGraph._registry_lock:
            HostGraph._registry.pop(self.node_id, None)
            # leave every alias chain we joined: a dead node must never be
            # promotable into the registry (the chains then hold only live
            # nodes by invariant)
            for key in list(HostGraph._alias_chains):
                ch = HostGraph._alias_chains[key]
                if self in ch:
                    ch.remove(self)
                if not ch:
                    HostGraph._alias_chains.pop(key, None)
            chain = HostGraph._alias_chains.get(self.node_id)
            if chain:
                # promote the next alias to the canonical identity
                nxt = chain.pop(0)
                if not chain:
                    HostGraph._alias_chains.pop(self.node_id, None)
                nxt_old = nxt.node_id
                nxt.node_id = self.node_id
                HostGraph._registry.pop(nxt_old, None)
                HostGraph._registry[self.node_id] = nxt
                # identity bookkeeping (Bugs.txt #1): the promoted node's
                # self-edges follow its identity; its edges to the *dead
                # holder* of this identity would now alias to itself —
                # drop them instead of creating a self-loop on reload
                with nxt._lock:
                    self_pairs = nxt.topology.pop(nxt_old, None)
                    nxt.topology.pop(self.node_id, None)
                    if self_pairs:
                        nxt.topology[self.node_id] = self_pairs
        for node in HostGraph.live_nodes():
            node._notify_topology()

    # --- listeners ----------------------------------------------------------
    def add_topology_listener(self, fn: Callable[[], None]) -> None:
        self._topology_listeners.append(fn)

    def remove_topology_listener(self, fn: Callable[[], None]) -> None:
        """Unregister a topology listener (a closed MixGraph must stop
        receiving — and being kept alive by — topology callbacks)."""
        try:
            self._topology_listeners.remove(fn)
        except ValueError:
            pass

    def _notify_topology(self) -> None:
        for fn in list(self._topology_listeners):
            fn()

    # --- topology edits --------------------------------------------------------
    def connect(self, source_id: bytes, pair: PortPair) -> bool:
        """Add an edge mixing source's channel into ours
        (ref: HostGraph::connect, HostGraph.cpp:382)."""
        # (Bugs.txt #1 — alias self-loops — is defended where identities
        # actually change: close()-promotion and assume_identity_of remap
        # or drop edges that would alias to self; by the registry
        # invariant find(id).node_id == id, source_id here can only
        # resolve to self when it IS self, which is a legitimate
        # self-monitor layout)
        if pair.destination >= self.channels or pair.source < 0 or pair.destination < 0:
            return False
        with self._lock:
            self.topology.setdefault(source_id, set()).add(pair)
        self._notify_topology()
        return True

    def topology_snapshot(self) -> Dict[bytes, Set[PortPair]]:
        """Consistent copy of the edge map for lock-free iteration (the
        delivery-path rebuild reads topology while UI/host threads edit
        it under our lock — iterating the live dict can raise
        mid-mutation)."""
        with self._lock:
            return {src: set(pairs) for src, pairs in self.topology.items()}

    def disconnect(self, source_id: bytes, pair: PortPair) -> bool:
        with self._lock:
            pairs = self.topology.get(source_id)
            if not pairs or pair not in pairs:
                return False
            pairs.discard(pair)
            if not pairs:
                self.topology.pop(source_id)
        self._notify_topology()
        return True

    def toggle_set(self, source_id: bytes) -> bool:
        """Quick-connect: if any edges from source exist remove them all,
        else connect default layout i->i (ref: toggleSet
        HostGraph.cpp:423-496 + applyDefaultLayoutFromRuntime :541-563)."""
        # resolve the source BEFORE taking our node lock: find() takes the
        # registry lock, and close()/assume_identity_of take registry ->
        # node — taking node -> registry here would be an ABBA inversion
        src = HostGraph.find(source_id)
        with self._lock:
            if source_id in self.topology:
                self.topology.pop(source_id)
                result = False
            else:
                n = min(self.channels, src.channels if src else 2)
                self.topology[source_id] = {PortPair(i, i) for i in range(n)}
                result = True
        self._notify_topology()
        return result

    # --- model -------------------------------------------------------------
    def get_model(self) -> GraphModel:
        model = GraphModel()
        live = {n.node_id: n for n in HostGraph.live_nodes()}
        for node in live.values():
            model.nodes.append(
                dict(id=node.node_id.hex(), name=node.name, channels=node.channels)
            )
        with self._lock:
            for src_id, pairs in self.topology.items():
                if src_id not in live:
                    model.missing.append(src_id.hex())
                for p in sorted(pairs):
                    model.edges.append((src_id.hex(), self.node_id.hex(), p))
        return model

    def expected_nodes_to_resurrect(self) -> int:
        live = {n.node_id for n in HostGraph.live_nodes()}
        with self._lock:
            return sum(1 for s in self.topology if s not in live)

    # --- serialization ----------------------------------------------------------
    VERSION = 1

    def serialize(self, archive: Archive) -> None:
        """ref: HostGraph::serialize, HostGraph.cpp:63-97."""
        archive.version = self.VERSION
        archive["name"] = self.name
        archive["control"] = int(self.serialization_control)
        archive["node_id"] = self.node_id
        if self.serialization_control == SerializationControl.IGNORE_ALWAYS:
            return
        edges = archive.child("edges")
        with self._lock:
            for i, (src, pairs) in enumerate(sorted(self.topology.items())):
                e = edges.child(str(i))
                e["source"] = src
                e["pairs"] = [[p.source, p.destination] for p in sorted(pairs)]

    def deserialize(self, archive: Archive) -> None:
        """Restore identity + topology; aliasing when our identity is
        already live (ref: changeIdentity, HostGraph.cpp:171-227)."""
        self.name = archive.get("name", self.name)
        self.serialization_control = SerializationControl(archive.get("control", 0))
        new_id = archive.get("node_id")
        if new_id is not None:
            new_id = bytes(new_id)
            with HostGraph._registry_lock:
                holder = HostGraph._registry.get(new_id)
                if holder is not None and holder is not self:
                    # identity collision: we become an alias candidate.
                    # Hosts re-send state routinely — dedupe, or close()
                    # (which removes ONE occurrence) could leave a dead
                    # node promotable
                    ch = HostGraph._alias_chains.setdefault(new_id, [])
                    if self not in ch:
                        ch.append(self)
                else:
                    HostGraph._registry.pop(self.node_id, None)
                    self.node_id = new_id
                    HostGraph._registry[new_id] = self
        if self.serialization_control == SerializationControl.IGNORE_SESSION:
            self._notify_topology()
            return
        edges = archive.find_child("edges")
        new_topology: Dict[bytes, Set[PortPair]] = {}
        if edges is not None:
            for _, e in edges.children():
                src = bytes(e["source"])
                pairs = {PortPair(int(a), int(b)) for a, b in e.get("pairs", [])}
                if src == self.node_id:
                    # legitimate self-monitor edges: validate the channel
                    # bounds (alias self-loops are defended at the
                    # identity-change sites, not here)
                    pairs = {p for p in pairs if p.source < self.channels}
                new_topology[src] = pairs
        with self._lock:
            self.topology = new_topology
        for node in HostGraph.live_nodes():
            node._notify_topology()

    def assume_identity_of(self, other_id: bytes) -> bool:
        """Alias takeover button (ref: GraphEditor "assume identity",
        GraphEditor.cpp:639-643)."""
        with HostGraph._registry_lock:
            chain = HostGraph._alias_chains.get(other_id, [])
            if not (self in chain and other_id not in HostGraph._registry):
                return False
            chain.remove(self)
            if not chain:
                HostGraph._alias_chains.pop(other_id, None)
            old_id = self.node_id
            HostGraph._registry.pop(old_id, None)
            self.node_id = other_id
            HostGraph._registry[other_id] = self
            with self._lock:
                # self-edges follow the identity; edges to the previous
                # (dead) holder of other_id would self-loop — drop them
                # (Bugs.txt #1)
                self_pairs = self.topology.pop(old_id, None)
                self.topology.pop(other_id, None)
                if self_pairs:
                    self.topology[other_id] = self_pairs
        # peers with edges to other_id must learn it is live again
        for node in HostGraph.live_nodes():
            node._notify_topology()
        return True
