"""In-process pub/sub node graph with latest-wins queues (a copy of
`redtail_tpu/runtime/graph.py`).

Replaces the reference's ROS transport layer: each DNN/controller process
there was a ROS node with a queue-size-1 subscriber keeping only the
newest frame (`caffe_ros/include/caffe_ros/caffe_ros.h:30-35`,
`caffe_ros.cpp:102-126` rate-limited spin). Here the stages share one
process and one card, each in its own thread, and the "transport" is a
mutex-guarded latest-wins slot per topic.

Components:
- ``Topic``: latest-wins mailbox (single-slot by default; optional bounded
  history so microbatch result bursts stay fully observable) with
  monotonically increasing sequence numbers and timestamps.
- ``Node``: a rate-limited worker thread pulling its subscribed topics and
  publishing results (the `spin()` loop of each reference node).
- ``ApproxTimeSync``: pairs messages from two topics whose timestamps
  differ by at most a slop — the `message_filters::ApproximateTime` policy
  used by `stereo_dnn_ros` (`stereo_dnn_ros_node.cpp:351-357`).
- ``NodeGraph``: owns topics and nodes, start/stop lifecycle.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclass
class Message:
    data: Any
    stamp: float
    seq: int


@dataclass
class Stamped:
    """Stage result carrying its own source timestamp.

    Overlapped (frames-in-flight) stages return the *previous* frame's
    result; publishing it under the current frame's stamp would
    under-report camera->output latency, so such stages wrap results in
    ``Stamped`` and ``Node`` honours the carried stamp (the ROS analogue:
    the reference stamped outputs with the source image's header stamp,
    `caffe_ros.cpp:128-201`)."""
    data: Any
    stamp: float


class Topic:
    """Latest-wins mailbox (ROS queue_size=1 semantics by default).

    ``history > 1`` keeps a bounded ring of the most recent messages so
    a burst — e.g. a microbatched stage publishing M results
    back-to-back — stays fully observable: latest-wins consumers
    (``take``) behave exactly as before, while a consumer that needs
    every frame (a recorder, an evaluation sink) drains the ring with
    ``take_since``."""

    def __init__(self, name: str, history: int = 1):
        self.name = name
        self._lock = threading.Lock()
        self._msgs: "collections.deque[Message]" = \
            collections.deque(maxlen=max(1, int(history)))
        self._seq = 0
        self._event = threading.Event()

    def set_history(self, history: int) -> None:
        """Grow (never shrink) the retained-message ring."""
        with self._lock:
            if int(history) > (self._msgs.maxlen or 1):
                self._msgs = collections.deque(
                    self._msgs, maxlen=int(history))

    def publish(self, data: Any, stamp: Optional[float] = None) -> Message:
        with self._lock:
            self._seq += 1
            msg = Message(data, time.monotonic() if stamp is None else stamp,
                          self._seq)
            self._msgs.append(msg)
        self._event.set()
        return msg

    def latest(self) -> Optional[Message]:
        with self._lock:
            return self._msgs[-1] if self._msgs else None

    @property
    def count(self) -> int:
        """Total messages ever published (the honest throughput counter
        for overlapped stages, whose calls can return None)."""
        with self._lock:
            return self._seq

    def take(self, last_seq: int = 0) -> Optional[Message]:
        """Return the latest message if newer than ``last_seq``."""
        with self._lock:
            if self._msgs and self._msgs[-1].seq > last_seq:
                return self._msgs[-1]
            return None

    def take_since(self, last_seq: int = 0) -> List[Message]:
        """Every retained message newer than ``last_seq``, oldest first
        (at most ``history`` are retained — a slow consumer observes the
        drop as a seq gap)."""
        with self._lock:
            return [m for m in self._msgs if m.seq > last_seq]

    def wait(self, timeout: Optional[float] = None) -> bool:
        ok = self._event.wait(timeout)
        self._event.clear()
        return ok


class ApproxTimeSync:
    """Group the freshest messages of N topics within a time slop —
    the message_filters ApproximateTime analogue. The reference used a
    2-way sync for the stereo pair (`stereo_dnn_ros_node.cpp:351-357`)
    and a 3-way one for the viz node
    (`stereo_dnn_ros_viz_node.cpp:202-204`)."""

    def __init__(self, *topics: Topic, slop: float = 0.05):
        if len(topics) < 2:
            raise ValueError("ApproxTimeSync needs at least two topics")
        self.topics = topics
        self.slop = slop
        self._last_group: Tuple[int, ...] = (0,) * len(self.topics)

    def take(self) -> Optional[Tuple[Message, ...]]:
        msgs = [t.latest() for t in self.topics]
        if any(m is None for m in msgs):
            return None
        stamps = [m.stamp for m in msgs]
        if max(stamps) - min(stamps) > self.slop:
            return None
        group = tuple(m.seq for m in msgs)
        if group == self._last_group:
            return None
        self._last_group = group
        return tuple(msgs)


class Node:
    """Rate-limited worker: pulls newest inputs, runs ``step``, publishes.

    Subclass or pass ``fn(msgs) -> result``. Mirrors the reference node
    loop: sleep to max_rate_hz, process only the latest frame, stamp the
    output with the source timestamp
    (`caffe_ros.cpp:102-126`, `:128-201`).
    """

    def __init__(self, name: str, fn: Callable, inputs: List[Topic],
                 output: Optional[Topic] = None,
                 max_rate_hz: float = 30.0,
                 sync: Optional[ApproxTimeSync] = None):
        self.name = name
        self.fn = fn
        self.inputs = inputs
        self.output = output
        self.max_rate_hz = max_rate_hz
        self.sync = sync
        self._last_seqs = [0] * len(inputs)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.processed = 0
        self.errors = 0
        self.last_error: Optional[BaseException] = None
        self.last_heartbeat = time.monotonic()

    # one scheduling quantum; factored out so tests can drive it directly
    def step_once(self) -> bool:
        if self.sync is not None:
            pair = self.sync.take()
            if pair is None:
                return False
            msgs = list(pair)
        else:
            msgs = []
            for i, topic in enumerate(self.inputs):
                m = topic.take(self._last_seqs[i])
                if m is None:
                    return False
                msgs.append(m)
            for i, m in enumerate(msgs):
                self._last_seqs[i] = m.seq
        try:
            if getattr(self.fn, "needs_stamp", False):
                result = self.fn(*[m.data for m in msgs],
                                 stamp=msgs[0].stamp)
            else:
                result = self.fn(*[m.data for m in msgs])
        except Exception as e:  # node must keep spinning on stage errors,
            # but KeyboardInterrupt/SystemExit must propagate out of the
            # worker thread rather than be swallowed
            self.errors += 1
            self.last_error = e
            return False
        self.processed += 1
        if self.output is not None and result is not None:
            # A microbatched stage returns a LIST of Stamped results;
            # each publishes under its own source stamp. Only a list
            # whose every element is Stamped is treated that way — a
            # stage whose natural payload is a plain list publishes it
            # as one message, not exploded per element.
            if (isinstance(result, list) and result
                    and all(isinstance(r, Stamped) for r in result)):
                for r in result:
                    self.output.publish(r.data, stamp=r.stamp)
            elif isinstance(result, Stamped):
                self.output.publish(result.data, stamp=result.stamp)
            else:
                self.output.publish(result, stamp=msgs[0].stamp)
        return True

    def _run(self, stop: threading.Event):
        # `stop` is captured at thread start: a restart may swap
        # ``self._stop`` for a fresh event, and a wedged old thread must
        # keep observing its own (set) event so it can never loop again.
        period = 1.0 / self.max_rate_hz if self.max_rate_hz > 0 else 0.0
        while not stop.is_set():
            t0 = time.monotonic()
            self.last_heartbeat = t0
            did = self.step_once()
            dt = time.monotonic() - t0
            sleep = period - dt if did else min(period, 0.002)
            if sleep > 0:
                stop.wait(sleep)

    def start(self):
        self._thread = threading.Thread(target=self._run, name=self.name,
                                        args=(self._stop,), daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 2.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)


class NodeGraph:
    """Owns topics and nodes; composition root replacing roslaunch XML."""

    def __init__(self):
        self.topics: Dict[str, Topic] = {}
        self.nodes: Dict[str, Node] = {}

    def topic(self, name: str, history: int = 1) -> Topic:
        if name not in self.topics:
            self.topics[name] = Topic(name, history)
        elif history > 1:
            self.topics[name].set_history(history)
        return self.topics[name]

    def add_node(self, name: str, fn: Callable, inputs: List[str],
                 output: Optional[str] = None, *, max_rate_hz: float = 30.0,
                 sync_slop: Optional[float] = None) -> Node:
        in_topics = [self.topic(t) for t in inputs]
        sync = None
        if sync_slop is not None:
            if len(in_topics) < 2:
                raise ValueError("ApproxTimeSync requires >= 2 inputs")
            sync = ApproxTimeSync(*in_topics, slop=sync_slop)
        node = Node(name, fn, in_topics,
                    self.topic(output) if output else None,
                    max_rate_hz=max_rate_hz, sync=sync)
        self.nodes[name] = node
        return node

    def start(self):
        for node in self.nodes.values():
            node.start()

    def stop(self):
        for node in self.nodes.values():
            node.stop()

    def spin_until(self, predicate: Callable[[], bool],
                   timeout: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if predicate():
                return True
            time.sleep(0.005)
        return False

    def stalled_nodes(self, max_silence_sec: float = 2.0) -> List[str]:
        """Failure detection: nodes whose loop has not ticked recently
        (a stage wedged inside its callable). The reference's closest
        analogue was ROS_FATAL-and-shutdown (`tensor_net.cpp:127-129`);
        here supervision is a queryable health probe so the composition
        root can restart or degrade instead of dying."""
        now = time.monotonic()
        return [name for name, node in self.nodes.items()
                if node._thread is not None and node._thread.is_alive()
                and now - node.last_heartbeat > max_silence_sec]

    def restart_node(self, name: str, timeout: float = 2.0) -> bool:
        """Recovery: stop, join, and restart a node's thread.

        If the old thread is wedged inside its callable and does not join
        within ``timeout``, the restart still proceeds — the old thread
        holds its own (set) stop event (see ``Node._run``) so it exits the
        moment it unwedges and can never re-enter the loop; at worst it
        completes the in-flight step (one stale latest-wins publish).
        Returns True if the old thread joined cleanly.
        """
        node = self.nodes[name]
        node.stop(timeout)
        joined = node._thread is None or not node._thread.is_alive()
        node._stop = threading.Event()
        node.start()
        return joined
