"""Input layer.

Mirrors the reference contract (src/InputInterface.h:28-53): every input
pushes raw S16LE interleaved bytes into a shared SampleQueue and the encode
loop pops frames from it.  FileInput reads synchronously on the main thread
(src/FileInput.cpp:90-129); live inputs run a producer thread.

Live capture in the reference binds to libasound/libjack/libvlc/gstreamer.
None of those libraries exist in this environment, so the live inputs here
are built on a single library-free mechanism instead: SubprocessInput spawns
an external decoder (ffmpeg by default) that emits s16le PCM on stdout, with
a reader thread pushing into the SampleQueue and ICY metadata parsed from the
decoder's stderr.  VLCInput/GSTInput/AlsaInput are thin configurations of it
(URI ingest / custom pipeline / capture device), preserving the reference's
fault-detection and restart semantics (odr-audioenc.cpp:875-902).  JackInput
stays gated: JACK requires the client library by design.
"""
import re
import shutil
import subprocess
import sys
import threading

from .wav import WavReader


class InputInterface:
    """src/InputInterface.h:28-53."""

    def prepare(self):
        raise NotImplementedError

    def fault_detected(self):
        return False

    def read_source(self, size_bytes):
        """Returns False on EOF."""
        raise NotImplementedError

    def close(self):
        pass


class FileInput(InputInterface):
    """WAV/raw file or stdin (src/FileInput.cpp:41-129).  read_source reads
    synchronously and pushes into the SampleQueue."""

    def __init__(self, queue, filename, raw_input, sample_rate, channels,
                 continue_after_eof=False):
        self.queue = queue
        self.filename = filename
        self.raw = raw_input
        self.rate = sample_rate
        self.channels = channels
        self.continue_after_eof = continue_after_eof
        self.eof = False
        self.wav = None
        self.f = None

    def prepare(self):
        if self.filename == "-":
            self.f = sys.stdin.buffer
        else:
            self.f = open(self.filename, "rb")
        if not self.raw:
            self.wav = WavReader(self.f)
            if self.wav.rate != self.rate:
                raise RuntimeError(
                    f"WAV sample rate {self.wav.rate} != configured {self.rate}")
            if self.wav.channels != self.channels:
                raise RuntimeError(
                    f"WAV channels {self.wav.channels} != configured {self.channels}")

    def read_source(self, size_bytes):
        src = self.wav if self.wav else self.f
        buf = src.read(size_bytes)
        if not buf:
            if self.continue_after_eof:
                self.queue.push(bytes(size_bytes))  # --fifo-silence
                return True
            self.eof = True
            return False
        if len(buf) < size_bytes and not self.continue_after_eof:
            # partial final read: zero-pad to keep frame alignment
            buf += bytes(size_bytes - len(buf))
        align = 2 * self.channels
        if len(buf) % align:
            buf += bytes(align - len(buf) % align)
        self.queue.push(buf)
        return True

    def close(self):
        if self.f is not None and self.f is not sys.stdin.buffer:
            self.f.close()


# "Metadata update for StreamTitle: x" (ffmpeg http/icy demuxer log line)
# or raw "StreamTitle='x';" fragments
_ICY_PATTERNS = [
    re.compile(rb"Metadata update for StreamTitle:\s*(.+)"),
    re.compile(rb"StreamTitle='([^']*)'"),
]


class SubprocessInput(InputInterface):
    """Threaded live ingest through an external decoder process.

    The stand-in for the reference's VLC smem pipeline (VLCInput.cpp:139-268):
    the child emits s16le interleaved PCM at the configured rate/channels on
    stdout; a reader thread pushes chunks into the SampleQueue (the thread
    boundary of SURVEY section 2.5.1); a second thread scans stderr for ICY
    StreamTitle updates (VLCInput.cpp:352-434's metadata path).  A dead or
    EOF'd child raises the fault flag, which the encode loop polls each frame
    exactly like the reference (odr-audioenc.cpp:875).
    """

    # 10 ms of audio per push, comparable to NUM_SAMPLES_PER_CALL granularity
    CHUNK_MS = 10

    def __init__(self, queue, command, sample_rate, channels):
        self.queue = queue
        self.command = command
        self.rate = sample_rate
        self.channels = channels
        self.proc = None
        self._fault = False
        self._stop = False
        self._threads = []
        self._icy_lock = threading.Lock()
        self._icy_text = ""

    def prepare(self):
        try:
            self.proc = subprocess.Popen(
                self.command, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                stdin=subprocess.DEVNULL)
        except OSError as e:
            raise RuntimeError(f"cannot spawn input decoder "
                               f"{self.command[0]!r}: {e}") from e
        t = threading.Thread(target=self._read_loop, daemon=True)
        t.start()
        m = threading.Thread(target=self._stderr_loop, daemon=True)
        m.start()
        self._threads = [t, m]

    def _read_loop(self):
        chunk = max(2 * self.channels,
                    self.rate * self.CHUNK_MS // 1000 * 2 * self.channels)
        partial = b""
        try:
            while not self._stop:
                buf = self.proc.stdout.read(chunk)
                if not buf:
                    break
                buf = partial + buf
                align = 2 * self.channels
                keep = len(buf) // align * align
                partial = buf[keep:]
                if keep:
                    self.queue.push(buf[:keep])
        except Exception:
            pass
        if not self._stop:
            self._fault = True

    def _stderr_loop(self):
        try:
            for line in self.proc.stderr:
                for pat in _ICY_PATTERNS:
                    mm = pat.search(line)
                    if mm:
                        text = mm.group(1).strip().decode("utf-8", "replace")
                        with self._icy_lock:
                            self._icy_text = text
        except Exception:
            pass

    def get_icy_text(self):
        with self._icy_lock:
            return self._icy_text

    def fault_detected(self):
        return self._fault or (self.proc is not None
                               and self.proc.poll() is not None)

    def read_source(self, size_bytes):
        # reading is done in the producer thread (VLCInput.cpp:270-274)
        return True

    def close(self):
        self._stop = True
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=2)
            except subprocess.TimeoutExpired:
                self.proc.kill()


def _ffmpeg_or_die():
    exe = shutil.which("ffmpeg")
    if exe is None:
        raise RuntimeError(
            "ffmpeg not found: URI/device ingest needs an external decoder "
            "(the reference builds against libvlc/gstreamer, which are not "
            "available in this environment either)")
    return exe


class VLCInput(SubprocessInput):
    """Any-URI ingest (reference: src/VLCInput.cpp, libVLC smem transcode to
    fl32 -> S16).  Here: ffmpeg URI -> s16le pipe, ICY text from stderr."""

    def __init__(self, queue, uri, sample_rate, channels, cache_ms=0):
        cmd = [_ffmpeg_or_die(), "-hide_banner", "-nostdin", "-loglevel",
               "verbose", "-i", uri, "-vn",
               "-f", "s16le", "-ar", str(sample_rate), "-ac", str(channels),
               "-"]
        super().__init__(queue, cmd, sample_rate, channels)


class GSTInput(SubprocessInput):
    """GStreamer-equivalent ingest (reference: src/GSTInput.cpp:111-299,
    uridecodebin -> audioconvert -> audioresample -> S16 appsink, or a user
    pipeline via gst_parse_bin_from_description).  Here: a URI through
    ffmpeg, or a user-supplied shell pipeline that must emit s16le on
    stdout."""

    def __init__(self, queue, uri, sample_rate, channels, pipeline=None):
        if pipeline:
            cmd = ["/bin/sh", "-c", pipeline]
        else:
            cmd = [_ffmpeg_or_die(), "-hide_banner", "-nostdin", "-loglevel",
                   "verbose", "-i", uri, "-vn", "-f", "s16le",
                   "-ar", str(sample_rate), "-ac", str(channels), "-"]
        super().__init__(queue, cmd, sample_rate, channels)


class AlsaInput(SubprocessInput):
    """Sound-card capture (reference: src/AlsaInput.cpp:49-194, S16LE
    interleaved).  Here: arecord (alsa-utils) or ffmpeg's alsa demuxer."""

    def __init__(self, queue, device, sample_rate, channels):
        arecord = shutil.which("arecord")
        if arecord:
            cmd = [arecord, "-D", device, "-f", "S16_LE", "-r",
                   str(sample_rate), "-c", str(channels), "-t", "raw", "-q"]
        else:
            cmd = [_ffmpeg_or_die(), "-hide_banner", "-nostdin",
                   "-f", "alsa", "-i", device, "-f", "s16le",
                   "-ar", str(sample_rate), "-ac", str(channels), "-"]
        super().__init__(queue, cmd, sample_rate, channels)


def make_unavailable(name, flag):
    class Unavailable(InputInterface):
        def __init__(self, *a, **k):
            raise RuntimeError(
                f"{name} input requires {flag}, which is not available in "
                f"this environment (matches the reference's compile-time gate)")
    return Unavailable


# JACK: a real ctypes client of libjack (io/jack_in.py); when the library
# is absent at runtime its prepare() raises the same gate error the
# reference's compile-time HAVE_JACK would.  Lazy to avoid a circular
# import (jack_in subclasses InputInterface).
def JackInput(*args, **kwargs):
    from .jack_in import JackInput as _JackInput
    return _JackInput(*args, **kwargs)
