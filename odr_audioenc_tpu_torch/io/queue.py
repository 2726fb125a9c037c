"""Threaded producer/consumer sample queue (src/SampleQueue.h:60-280).

The single hand-off point between input threads and the encode loop.  Two
push disciplines, selected by configure():

  push_block=True  - the producer blocks (in 100 ms waits) until space frees
                     up: used by callback/thread inputs without drift
                     compensation (JACK, VLC, GST).
  push_block=False - full queue counts an overrun and drops the chunk: used
                     with drift compensation, where pop() zero-fills and the
                     consumer paces itself to the wall clock.

pop() (SampleQueue.h:217-276) returns exactly `length` bytes, zero-filling
when the queue runs short (the caller detects the underrun from the returned
valid-byte count).  pop_wait() (SampleQueue.h:145-197) blocks up to
timeout_ms for the full amount and may return short on timeout - the caller
treats that as an input fault (odr-audioenc.cpp:958-985).
"""
import threading
import time


class SampleQueue:
    def __init__(self, bytes_per_sample=2):
        self._bps = bytes_per_sample
        self._buf = bytearray()
        self._lock = threading.Lock()
        self._push_notify = threading.Condition(self._lock)
        self._pop_notify = threading.Condition(self._lock)
        self._max_size = 1 << 30
        self._push_block = False
        self._channels = 1
        self._overruns = 0

    def configure(self, max_size, push_block, channels):
        """SampleQueue.h:69-74."""
        self._max_size = max_size
        self._push_block = push_block
        self._channels = channels

    def __len__(self):
        with self._lock:
            return len(self._buf)

    def push(self, data):
        """Append `data`; returns the queue size after the push
        (SampleQueue.h:81-129)."""
        data = bytes(data)
        assert len(data) % (self._channels * self._bps) == 0
        with self._lock:
            if self._push_block:
                off = 0
                while off < len(data):
                    avail = self._max_size - len(self._buf)
                    ncopy = min(avail, len(data) - off)
                    if ncopy > 0:
                        self._buf += data[off:off + ncopy]
                        off += ncopy
                    else:
                        self._pop_notify.wait(timeout=0.1)
            else:
                if len(self._buf) < self._max_size:
                    self._buf += data
                else:
                    self._overruns += 1
            size = len(self._buf)
            self._push_notify.notify_all()
        return size

    def pop(self, length):
        """Take up to `length` bytes, zero-filling the remainder.  Returns
        (buf of exactly `length` bytes, valid_bytes, overruns)."""
        assert length % (self._channels * self._bps) == 0
        with self._lock:
            overruns, self._overruns = self._overruns, 0
            valid = min(len(self._buf), length)
            out = bytes(self._buf[:valid]) + bytes(length - valid)
            if valid == len(self._buf):
                self._buf.clear()
            else:
                del self._buf[:valid]
            self._pop_notify.notify_all()
        return out, valid, overruns

    def pop_wait(self, length, timeout_ms):
        """Block (in 10 ms waits) until `length` bytes are available or the
        timeout elapses; may return short.  Returns (buf, overruns)."""
        assert length % (self._channels * self._bps) == 0
        deadline = time.monotonic() + timeout_ms / 1000.0
        with self._lock:
            overruns, self._overruns = self._overruns, 0
            while len(self._buf) < length:
                self._push_notify.wait(timeout=0.01)
                if time.monotonic() > deadline:
                    break
            n = min(len(self._buf), length)
            out = bytes(self._buf[:n])
            del self._buf[:n]
            self._pop_notify.notify_all()
        return out, overruns

    def clear(self):
        with self._lock:
            self._buf.clear()
            self._pop_notify.notify_all()
