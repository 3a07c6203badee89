"""The OBJ sink of the serving cells: every OBJ path the program writes
is a named pipe (FIFO) that the harness made, and one harness thread
drains the pipes in the order the program writes them. It counts and
hashes the bytes and keeps those of a few subjects, drawn from the seed
by reservoir sampling, for the output check; no OBJ text reaches the
disk. The program's writer opens the path with ``fopen("wb")`` and only
calls ``fwrite``, so it writes to a pipe as to a file: the formatting is
timed and the page-cache write is not.
"""

from __future__ import annotations

import fcntl
import os
import queue
import threading
import time
import zlib
from typing import Dict, List, Optional

import numpy as np

CHUNK = 1 << 22
SUFFIXES = ("_HR.obj", "_LR.obj")
F_SETPIPE_SZ = 1031          # fcntl.F_SETPIPE_SZ on Linux
PIPE_BYTES = 1 << 20         # the most an unprivileged process may set


class ObjSink:
    """``plan(name)`` before the program is handed subject ``name``:
    its OBJ pair's pipes are made in ``directory`` and queued for the
    drain thread. ``keep`` subjects of those planned with ``sample=True``
    are kept (``kept``: name -> (hr bytes, lr bytes)), drawn by ``rng``."""

    def __init__(self, directory: str, keep: int = 0,
                 rng: Optional[np.random.Generator] = None):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.keep = keep
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.kept: Dict[str, List[bytes]] = {}
        # name -> host clock when its pair's last byte was drained
        self.done_at: Dict[str, float] = {}
        self.slots: List[Optional[str]] = [None] * keep
        self.seen = 0
        self.bytes = 0
        self.crc = 0
        self.files = 0
        self.error: Optional[OSError] = None
        self._lock = threading.Lock()
        self._q: "queue.Queue" = queue.Queue()
        self._pending: Optional[str] = None
        self._buf = bytearray(CHUNK)
        self._view = memoryview(self._buf)
        self._thread = threading.Thread(target=self._drain, daemon=True,
                                        name="obj-sink")
        self._thread.start()

    def plan(self, name: str, sample: bool = True) -> None:
        keep = False
        if sample and self.keep:
            i = self.seen
            self.seen += 1
            slot = i if i < self.keep else int(self.rng.integers(0, i + 1))
            if slot < self.keep:
                with self._lock:
                    old = self.slots[slot]
                    if old is not None:
                        self.kept.pop(old, None)
                    self.slots[slot] = name
                keep = True
        for suffix in SUFFIXES:
            path = os.path.join(self.dir, name + suffix)
            os.mkfifo(path)
            self._q.put((name, path, keep))

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            name, path, keep = item
            self._pending = path
            try:
                parts = []
                with open(path, "rb", buffering=0) as f:
                    try:
                        # a larger pipe: the writer blocks less often
                        fcntl.fcntl(f.fileno(), F_SETPIPE_SZ, PIPE_BYTES)
                    except OSError:
                        pass
                    while True:
                        n = f.readinto(self._buf)
                        if not n:
                            break
                        view = self._view[:n]
                        self.bytes += n
                        self.crc = zlib.crc32(view, self.crc)
                        if keep:
                            parts.append(bytes(view))
                self.files += 1
                if path.endswith(SUFFIXES[-1]):
                    self.done_at[name] = time.perf_counter()
                with self._lock:
                    if keep and name in self.slots:
                        self.kept.setdefault(name, []).append(
                            b"".join(parts))
            except OSError as err:
                self.error = err
            finally:
                self._pending = None
                try:
                    os.unlink(path)
                except OSError:
                    pass
                self._q.task_done()

    def wait(self) -> None:
        """Until every planned pipe is drained."""
        self._q.join()
        if self.error is not None:
            raise RuntimeError(f"OBJ sink failed: {self.error!r}")

    def close(self) -> None:
        """Stop the thread; a pipe the program never opened is opened
        for writing once, so the blocked reader sees its end."""
        while True:
            try:
                _, path, _ = self._q.get_nowait()
                os.unlink(path)
                self._q.task_done()
            except queue.Empty:
                break
            except OSError:
                self._q.task_done()
        self._q.put(None)
        pending = self._pending
        if pending is not None:
            try:
                fd = os.open(pending, os.O_WRONLY | os.O_NONBLOCK)
                os.close(fd)
            except OSError:
                pass
        self._thread.join(timeout=30)
