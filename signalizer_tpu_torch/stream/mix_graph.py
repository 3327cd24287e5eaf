"""MixGraph — multi-source clock-aligned mixing into one presentation stream.

The port's own copy of :mod:`signalizer_tpu.stream.mix_graph` (behaviour
unchanged; tests hold the two equal under ragged pushes, clock offsets and
stalled sources). Equivalent of the reference's MixGraphListener
(ref: Source/Common/MixGraphListener.{h,cpp}): ingests audio from every
connected instance, aligns sources on the sample clock, bounds staleness by
``maximumLatency = max(128, 2 * block size)`` (MixGraphListener.cpp:107),
repairs drift, gathers connected ports into one multichannel matrix and
emits it into the presentation stream each time the *self* stream delivers
(deliver, :247-334). Functionally an all-gather with clock synchronization
and flow control (SURVEY.md §5.8).

Re-specification (the reference's version is known-buggy,
Source/Notes/Bugs.txt): alignment is expressed as, per source, a single
*clock offset* mapping source sample clocks onto the self clock, estimated
at connection time and re-estimated whenever the source strays outside the
latency window (covers both discontinuities and persistent drift — the
reference's separate drop/insert-silence paths). Port reads validate
against the source's actual channel count (Bugs.txt #2) and emit silence
for out-of-range ports instead of indexing out of bounds. All topology
edits are applied on the delivery path via a command queue exactly like
the reference (updateTopologyCommands, :482-537), so listener callbacks
never race structural changes.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from signalizer_tpu_torch.core.config import MAX_INPUT_CHANNELS
from signalizer_tpu_torch.stream.audio_stream import (
    AudioStream,
    AudioStreamInfo,
    AudioStreamOutput,
    Playhead,
)
from signalizer_tpu_torch.stream.host_graph import HostGraph, PortPair
from signalizer_tpu_torch.stream.ring_buffer import make_ring_buffer


@dataclass
class MixPerf:
    """Latency & sync reporting (ref: MixGraphListener.cpp:185-193)."""

    latency_samples: int = 0
    synchronized: bool = True
    discontinuities: int = 0
    silence_inserted: int = 0
    samples_dropped: int = 0


class _SourceState:
    """Per-source alignment state (ref: MixGraphListener::State)."""

    def __init__(self, output: AudioStreamOutput, pairs: Set[PortPair], capacity: int):
        self.output = output
        self.pairs = set(pairs)
        self.channels = output.info.channels
        self.ring = make_ring_buffer(self.channels, capacity)
        self.clock = 0  # source-side sample clock at ring head
        self.offset: Optional[int] = None  # source clock -> self clock
        self.listener = None


class MixGraph:
    """Owns the presentation stream; mixes per the host graph's topology.

    Usage::

        graph = HostGraph("me", channels=2)
        graph.stream_output = my_realtime_output   # publish for peers
        mix = MixGraph(graph, my_realtime_output)
        mix.presentation_output.add_listener(my_view_listener)
    """

    def __init__(
        self,
        host_graph: HostGraph,
        realtime_output: AudioStreamOutput,
        *,
        capacity: int = 65536,
        threaded_presentation: bool = False,
    ):
        self.graph = host_graph
        self.realtime = realtime_output
        self.capacity = capacity
        self.maximum_latency = 128  # ref: max(128, 2*blocksize)
        # perf counters are mutated on the mix thread and snapshotted from
        # others: writers hold _perf_lock; readers get an immutable copy —
        # this layer replaces known-racy reference code and must itself be
        # race-free
        self._perf = MixPerf()
        self._perf_lock = threading.Lock()
        self._sources: Dict[bytes, _SourceState] = {}
        self._pending_commands: List[Tuple[str, object]] = []
        self._cmd_lock = threading.Lock()
        self._emitted_up_to = 0  # self-clock position of last emitted sample
        self._self_clock = 0
        # reusable mix scratch (ref: cpl ChannelMatrix softBufferResize —
        # the delivery path must not allocate per block)
        self._scratch = np.zeros((0, 0), np.float32)
        self._mix_temp = None  # per-source routed-row gather scratch

        # presentation stream (what views listen to)
        info = AudioStreamInfo(
            channels=min(host_graph.channels, MAX_INPUT_CHANNELS),
            sample_rate=realtime_output.info.sample_rate,
            audio_history_capacity=realtime_output.info.audio_history_capacity,
        )
        self.presentation_input, self.presentation_output = AudioStream.create(
            threaded_presentation, info
        )

        host_graph.add_topology_listener(self._on_topology_changed)
        # default self layout i->i applies ONCE at stream bring-up when the
        # topology is empty (ref: applyDefaultLayoutFromRuntime gated by
        # hasAnyLayoutBeenApplied in prepareToPlay,
        # PluginProcessor.cpp:152-156 + HostGraph.cpp:541-563) — the edges
        # become explicit topology entries so later peer connects ADD to
        # them instead of displacing the self stream
        if not host_graph.topology:
            for i in range(min(realtime_output.info.channels, host_graph.channels)):
                host_graph.connect(host_graph.node_id, PortPair(i, i))
        # subscribe to the self stream
        self._self_listener = _Forwarder(self, None, is_self=True)
        realtime_output.add_listener(self._self_listener)
        self._on_topology_changed()

    # --- topology ------------------------------------------------------------
    def _on_topology_changed(self) -> None:
        with self._cmd_lock:
            self._pending_commands.append(("rebuild", None))

    def _apply_commands(self) -> None:
        """Applied on the delivery path (ref: updateTopologyCommands)."""
        with self._cmd_lock:
            cmds = self._pending_commands
            self._pending_commands = []
        for op, _ in cmds:
            if op == "rebuild":
                self._rebuild_sources()

    def _rebuild_sources(self) -> None:
        # snapshot under the graph lock: UI/host threads edit topology
        # concurrently and iterating the live dict can raise mid-mutation
        wanted: Dict[bytes, Tuple[Set[PortPair], object]] = {}
        for src_id, pairs in self.graph.topology_snapshot().items():
            output = None
            if src_id == self.graph.node_id:
                output = self.realtime
            else:
                node = HostGraph.find(src_id)
                if node is not None:
                    output = getattr(node, "stream_output", None)
            if output is not None and pairs:
                # carry the resolved output: re-resolving in the second
                # pass raced a concurrent close()
                wanted[src_id] = (set(pairs), output)

        # drop removed
        for src_id in list(self._sources):
            if src_id not in wanted:
                st = self._sources.pop(src_id)
                if st.listener is not None and st.output is not self.realtime:
                    st.output.remove_listener(st.listener)
        # add new / update pairs
        for src_id, (pairs, output) in wanted.items():
            st = self._sources.get(src_id)
            if st is None:
                st = _SourceState(output, pairs, self.capacity)
                if output is not self.realtime:
                    st.listener = _Forwarder(self, st, is_self=False)
                    output.add_listener(st.listener)
                self._sources[src_id] = st
            else:
                st.pairs = set(pairs)
        self._update_channel_names()

    def _update_channel_names(self) -> None:
        """Propagate port names into the presentation stream
        (ref: enqueueChannelName, MixGraphListener.cpp:210,236)."""
        for src_id, st in self._sources.items():
            node = HostGraph.find(src_id)
            name = node.name if node else src_id.hex()[:8]
            for p in sorted(st.pairs):
                if p.destination < self.presentation_input._stream.info.channels:
                    self.presentation_input.enqueue_channel_name(
                        p.destination, f"{name}:{p.source}"
                    )

    # --- ingest ------------------------------------------------------------
    @staticmethod
    def _ingest_aligned(st: _SourceState, block: np.ndarray, start_clock: int) -> None:
        """Write a block at its steady-clock position: the ring's monotonic
        clock IS the source's steady clock (gaps zero-filled, overlapped
        prefixes dropped), so all alignment math lives in one coordinate
        system."""
        if block.shape[0] != st.ring.channels:
            # the source reconfigured its channel count mid-stream
            # (initialize_info on a peer): rebuild the ring in the new
            # geometry instead of raising into the peer's delivery thread.
            # Alignment restarts — the offset re-estimates on the next self
            # block — and st.channels keeps the Bugs.txt-#2 pair validation
            # honest against the REAL channel count.
            st.ring = make_ring_buffer(block.shape[0], st.ring.capacity)
            st.channels = block.shape[0]
            st.clock = 0
            st.offset = None
        cur = st.ring.sample_clock
        if start_clock > cur:
            st.ring.seek_to(start_clock)
        elif start_clock < cur:
            overlap = int(cur - start_clock)
            if overlap >= block.shape[1]:
                return
            block = block[:, overlap:]
        st.ring.write(np.ascontiguousarray(block))
        st.clock = st.ring.sample_clock

    def _on_source_audio(self, st: _SourceState, block: np.ndarray, playhead: Playhead) -> None:
        self._ingest_aligned(st, block, playhead.steady_clock)

    def _on_self_audio(self, block: np.ndarray, playhead: Playhead) -> None:
        n = block.shape[1]
        self.maximum_latency = max(128, 2 * n)
        self._apply_commands()
        self._self_clock = playhead.steady_clock + n

        if self.graph.node_id in self.graph.topology and self.graph.node_id not in self._sources:
            self._rebuild_sources()

        self_state = self._sources.get(self.graph.node_id)
        if self_state is not None:
            # the forwarder for self doesn't write (we do it here, once)
            self._ingest_aligned(self_state, block, playhead.steady_clock)
            if self_state.offset is None:
                self_state.offset = 0

        # establish / repair offsets and find the emittable range
        emit_target = self._self_clock
        emit_end = emit_target
        synced = True
        for st in self._sources.values():
            if st.clock == 0:
                # nothing delivered yet: don't estimate an offset from a
                # phantom head, don't gate the mix on this source
                st.offset = None
                continue
            if st.offset is None:
                # first real contact: align the source's head to "now"
                st.offset = self._self_clock - st.clock
            aligned_head = st.clock + st.offset
            lag = emit_target - aligned_head
            # re-anchor on staleness in EITHER direction: persistent lag
            # (source starved / discontinuity) or a stale-ahead offset
            # (estimated before the source's clock was meaningful)
            if lag > self.maximum_latency or -lag > 8 * self.maximum_latency:
                st.offset = self._self_clock - st.clock
                with self._perf_lock:
                    self._perf.discontinuities += 1
                    if lag > 0:
                        self._perf.silence_inserted += int(lag)
                synced = False
                aligned_head = st.clock + st.offset
            emit_end = min(emit_end, aligned_head)

        emit_start = max(self._emitted_up_to, emit_target - self.maximum_latency)
        dropped = 0
        if emit_start > self._emitted_up_to and self._emitted_up_to > 0:
            # bounded-latency flow control skipped old audio
            dropped = int(emit_start - self._emitted_up_to)
        if emit_end <= emit_start:
            with self._perf_lock:
                self._perf.samples_dropped += dropped
                self._perf.synchronized = False
            return
        count = int(emit_end - emit_start)
        with self._perf_lock:
            self._perf.samples_dropped += dropped
            self._perf.latency_samples = int(emit_target - emit_end)
            self._perf.synchronized = synced

        channels = self.presentation_input._stream.info.channels
        if self._scratch.shape[0] != channels or self._scratch.shape[1] < count:
            self._scratch = np.zeros((channels, max(count, 2 * self._scratch.shape[1] or count)), np.float32)
        matrix = self._scratch[:, :count]
        matrix[:] = 0.0
        for st in self._sources.values():
            if st.offset is None:
                continue  # never delivered: contributes silence
            src_end = emit_end - st.offset
            # native rings fuse the aligned gather + accumulate in C++
            # (sz_mix_accumulate), touching only the *routed* channels
            # instead of read_at's full [channels, count] copy. The gather
            # lands in zeroed temp rows first and is only added to the
            # presentation matrix when every pair succeeded — a writer
            # overrunning the ring mid-loop must contribute the whole
            # source or clean silence, never a half-mixed source (same
            # contract as the read_at path below).
            if hasattr(st.ring, "mix_accumulate"):
                valid = [
                    p for p in st.pairs
                    # Bugs.txt #2: validate against the source's REAL channels
                    if p.source < st.channels and p.destination < channels
                ]
                temp = self._mix_temp
                if temp is None or temp.shape[0] < len(valid) or temp.shape[1] < count:
                    temp = self._mix_temp = np.zeros(
                        (max(len(valid), 4), max(count, 4096)), np.float32
                    )
                ok = True
                for row, p in enumerate(valid):
                    temp[row, :count] = 0.0
                    if not st.ring.mix_accumulate(
                        int(src_end), p.source, temp[row, :count]
                    ):
                        ok = False
                        break
                if ok:
                    for row, p in enumerate(valid):
                        matrix[p.destination] += temp[row, :count]
                else:
                    with self._perf_lock:
                        self._perf.silence_inserted += count
                continue
            try:
                data = st.ring.read_at(int(src_end), count)
            except ValueError:
                with self._perf_lock:
                    self._perf.silence_inserted += count
                continue
            for p in st.pairs:
                # Bugs.txt #2: validate against the source's REAL channels
                if p.source < st.channels and p.destination < channels:
                    matrix[p.destination] += data[p.source]

        self._emitted_up_to = emit_end
        # the emitted block covers the self-clock range [emit_start,
        # emit_end), not the raw input block: shift the playhead so
        # clock-aligned consumers of the presentation stream (e.g. a
        # chained MixGraph's _ingest_aligned) place it correctly
        emit_ph = playhead.advanced(int(emit_start) - playhead.steady_clock)
        self.presentation_input.process_incoming_audio(matrix, emit_ph)

    @property
    def perf(self) -> MixPerf:
        """Immutable snapshot of the perf counters (thread-safe)."""
        with self._perf_lock:
            return replace(self._perf)

    def close(self) -> None:
        # unregister from the host graph FIRST: a leaked topology
        # listener keeps the closed MixGraph (and its rings) alive and
        # accumulates rebuild commands forever
        self.graph.remove_topology_listener(self._on_topology_changed)
        for st in self._sources.values():
            if st.listener is not None and st.output is not self.realtime:
                st.output.remove_listener(st.listener)
        self.realtime.remove_listener(self._self_listener)
        self.presentation_input._stream.close()


class _Forwarder:
    """Listener adapter routing stream callbacks into the mix graph."""

    def __init__(self, mix: MixGraph, state: Optional[_SourceState], is_self: bool):
        self.mix = mix
        self.state = state
        self.is_self = is_self

    def on_stream_audio(self, ctx, block) -> None:
        if self.is_self:
            self.mix._on_self_audio(block, ctx.playhead)
        else:
            self.mix._on_source_audio(self.state, block, ctx.playhead)

    def on_stream_properties_changed(self, ctx, before) -> None:
        pass

    def on_stream_died(self, ctx) -> None:
        pass
