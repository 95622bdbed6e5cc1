"""Frame sources: the `image_pub` node equivalent
(`ros/packages/image_pub/src/image_pub_node.cpp`): video file / image file /
synthetic frames published to a topic at a fixed rate, with repeat and
start-offset controls."""

from __future__ import annotations

import itertools
import threading
import time
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np

from redtail_tpu_torch.runtime.graph import Topic


class FrameSource:
    """Publishes frames from an iterator factory to a topic at ``rate_hz``.

    ``frame_iter_factory`` is re-invoked when ``repeat`` and the stream is
    exhausted (image_pub's `img_repeat`, `image_pub_node.cpp:28-101`).
    """

    def __init__(self, topic: Topic, frame_iter_factory: Callable[[], Iterator],
                 rate_hz: float = 30.0, repeat: bool = False):
        self.topic = topic
        self.factory = frame_iter_factory
        self.rate_hz = rate_hz
        self.repeat = repeat
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.published = 0

    def _run(self):
        period = 1.0 / self.rate_hz if self.rate_hz > 0 else 0.0
        it = self.factory()
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                frame = next(it)
            except StopIteration:
                if not self.repeat:
                    return
                it = self.factory()
                continue
            self.topic.publish(frame)
            self.published += 1
            dt = time.monotonic() - t0
            if period > dt:
                self._stop.wait(period - dt)

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 2.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)


class ImageFileSource(FrameSource):
    """Single image (or list of images) published repeatedly as BGR uint8."""

    def __init__(self, topic: Topic, paths, rate_hz: float = 30.0,
                 repeat: bool = True):
        paths = [Path(p) for p in (
            paths if isinstance(paths, (list, tuple)) else [paths])]
        missing = [p for p in paths if not p.is_file()]
        if missing:
            raise FileNotFoundError(f"image file(s) not found: {missing}")

        def factory():
            import cv2
            frames = []
            for p in paths:
                img = cv2.imread(str(p))
                if img is None:
                    raise RuntimeError(f"could not decode image {p}")
                frames.append(img)
            return iter(frames)

        super().__init__(topic, factory, rate_hz=rate_hz, repeat=repeat)


class VideoFileSource(FrameSource):
    """Video file decoded with OpenCV, with start-frame offset."""

    def __init__(self, topic: Topic, path, rate_hz: float = 30.0,
                 repeat: bool = False, start_frame: int = 0):
        if not Path(path).is_file():
            raise FileNotFoundError(f"video file not found: {path}")

        def factory():
            import cv2
            cap = cv2.VideoCapture(str(path))
            if not cap.isOpened():
                raise RuntimeError(f"could not open video {path}")
            if start_frame:
                cap.set(cv2.CAP_PROP_POS_FRAMES, start_frame)

            def frames():
                while True:
                    ok, frame = cap.read()
                    if not ok:
                        cap.release()
                        return
                    yield frame
            return frames()

        super().__init__(topic, factory, rate_hz=rate_hz, repeat=repeat)


class StereoVideoSource:
    """Synced L/R camera pair — the role `zed.launch` + the ZED camera node
    played for the reference's stereo node
    (`stereo_dnn_ros/launch/zed.launch`,
    `stereo_dnn_ros_node.cpp:351-357` ApproximateTime-synced L/R).

    Two formats:
    - ``sbs_path``: one video whose frames are side-by-side L|R (the
      common stereo-rig recording format) — each frame is split in half;
    - ``left_path`` + ``right_path``: two files iterated in lockstep.

    Both halves are published with the SAME timestamp, so a downstream
    `ApproxTimeSync` always pairs them."""

    def __init__(self, topic_left: Topic, topic_right: Topic, *,
                 sbs_path=None, left_path=None, right_path=None,
                 rate_hz: float = 30.0, repeat: bool = False,
                 start_frame: int = 0):
        if sbs_path is not None:
            if left_path or right_path:
                raise ValueError("pass sbs_path OR left/right paths")
            paths = [sbs_path]
        else:
            if not (left_path and right_path):
                raise ValueError("need sbs_path or both left/right paths")
            paths = [left_path, right_path]
        missing = [p for p in paths if not Path(p).is_file()]
        if missing:
            raise FileNotFoundError(f"video file(s) not found: {missing}")
        self._paths = paths
        self._sbs = sbs_path is not None
        self.topic_left = topic_left
        self.topic_right = topic_right
        self.rate_hz = rate_hz
        self.repeat = repeat
        self.start_frame = start_frame
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.published = 0

    def _open(self):
        import cv2
        caps = []
        for p in self._paths:
            cap = cv2.VideoCapture(str(p))
            if not cap.isOpened():
                raise RuntimeError(f"could not open video {p}")
            if self.start_frame:
                cap.set(cv2.CAP_PROP_POS_FRAMES, self.start_frame)
            caps.append(cap)
        return caps

    def _next_pair(self, caps):
        frames = []
        for cap in caps:
            ok, frame = cap.read()
            if not ok:
                return None
            frames.append(frame)
        if self._sbs:
            # COPY the halves: publishing views of the decoder's frame
            # shares a buffer OpenCV may reuse/free while consumer
            # threads still read it (observed as heap corruption).
            f = frames[0]
            half = f.shape[1] // 2
            return (np.ascontiguousarray(f[:, :half]),
                    np.ascontiguousarray(f[:, half:]))
        return frames[0], frames[1]

    def _run(self):
        period = 1.0 / self.rate_hz if self.rate_hz > 0 else 0.0
        caps = self._open()
        try:
            while not self._stop.is_set():
                t0 = time.monotonic()
                pair = self._next_pair(caps)
                if pair is None:
                    for c in caps:
                        c.release()
                    if not self.repeat:
                        return
                    caps = self._open()
                    continue
                stamp = time.monotonic()
                self.topic_left.publish(pair[0], stamp=stamp)
                self.topic_right.publish(pair[1], stamp=stamp)
                self.published += 1
                dt = time.monotonic() - t0
                if period > dt:
                    self._stop.wait(period - dt)
        finally:
            for c in caps:
                c.release()

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 2.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)


class SyntheticSource(FrameSource):
    """Deterministic random frames for tests and soak runs."""

    def __init__(self, topic: Topic, shape=(180, 320, 3),
                 rate_hz: float = 30.0, seed: int = 0, count: int = 0):
        def factory():
            rs = np.random.RandomState(seed)
            it = itertools.count() if count == 0 else range(count)
            return (rs.randint(0, 256, shape, dtype=np.uint8) for _ in it)

        super().__init__(topic, factory, rate_hz=rate_hz,
                         repeat=(count == 0))
