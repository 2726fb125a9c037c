"""Sidecar services: PAD interface, stats publisher, VU meter, ICY text.

PadInterface: UNIX DGRAM pair with ODR-PadEnc (src/PadInterface.cpp:30-150,
message types 1=request 2=pad_data).
StatsPublisher: JSON over UNIX DGRAM (src/StatsPublish.cpp).
level(): sox-style VU string (src/utils.cpp:13-35).
"""
import json
import os
import socket

MESSAGE_REQUEST = 1
MESSAGE_PAD_DATA = 2


class PadInterface:
    def __init__(self):
        self.ident = None
        self.sock = None
        self.reachable = True

    def open(self, pad_ident):
        self.ident = pad_ident
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        self.sock.setblocking(False)
        path = f"/tmp/{pad_ident}.audioenc"
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        self.sock.bind(path)

    def close(self):
        if self.sock is not None:
            self.sock.close()
            self.sock = None
            try:
                os.unlink(f"/tmp/{self.ident}.audioenc")
            except OSError:
                pass

    def request(self, padlen):
        """Returns PAD bytes (padlen+1 long: X-PAD..F-PAD + used-length byte)
        or b'' when ODR-PadEnc is absent."""
        if not self.ident:
            raise RuntimeError("uninitialised PadInterface.request()")
        try:
            self.sock.sendto(bytes([MESSAGE_REQUEST, padlen]),
                             f"/tmp/{self.ident}.padenc")
            if not self.reachable:
                self.reachable = True
        except (ConnectionRefusedError, FileNotFoundError, BlockingIOError):
            if self.reachable:
                self.reachable = False
        while True:
            try:
                buf = self.sock.recv(2048)
            except BlockingIOError:
                return b""
            if buf and buf[0] == MESSAGE_PAD_DATA:
                return buf[1:]


class StatsPublisher:
    """src/StatsPublish.cpp: levels + under/overrun counters as JSON DGRAMs."""

    VERSION = "odr-audioenc-tpu 0.1.0"

    def __init__(self, socket_path):
        self.path = socket_path
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        self.sock.setblocking(False)
        try:
            self.sock.bind(f"/tmp/odr-audioenc.{os.getpid()}")
        except OSError:
            pass
        self.left = self.right = 0
        self.underruns = self.overruns = 0

    def update_audio_levels(self, left, right):
        self.left, self.right = int(left), int(right)

    def notify_underrun(self):
        self.underruns += 1

    def notify_overrun(self):
        self.overruns += 1

    def send_stats(self):
        msg = ("{ " + f"\"program\": \"odr-audioenc\", \"version\": \"{self.VERSION}\", "
               f"\"audiolevels\": {{ \"left\": {self.left}, \"right\": {self.right}}}, "
               f"\"driftcompensation\": {{ \"underruns\": {self.underruns}, "
               f"\"overruns\": {self.overruns}}} " + "}")
        try:
            self.sock.sendto(msg.encode(), self.path)
        except OSError:
            pass


_LEVEL_TEXT = [
    ("", ""), ("-", "-"), ("=", "="), ("-=", "=-"),
    ("==", "=="), ("-==", "==-"), ("===", "==="), ("-===", "===-"),
    ("====", "===="), ("-====", "====-"), ("=====", "====="),
    ("-=====", "=====-"), ("======", "======"),
    ("!=====", "=====!"),
]


def level(channel, peak):
    """sox-style VU meter string (src/utils.cpp:13-35, bug-compatible)."""
    import math
    red, white = 1, len(_LEVEL_TEXT) - 1
    linear = peak / 32767.0
    vu_db = int(math.floor(2 * white + red + 20 * math.log10(linear))) if linear else 0
    index = max(vu_db // 2, 0) if vu_db < 2 * white else min(vu_db - white, red + white - 1)
    return _LEVEL_TEXT[index][channel]


def write_icy_to_file(text, filename, dl_plus, artist="", title=""):
    """src/utils.cpp:50-96: ICY text with optional DL_PLUS parameters."""
    def ulen(s):
        return len(s)  # python strings are already code points
    try:
        with open(filename, "w", encoding="utf-8") as f:
            at_used = bool(artist) and bool(title)
            if dl_plus:
                f.write("##### parameters { #####\n")
                f.write("DL_PLUS=1\n")
                if at_used:
                    f.write(f"DL_PLUS_TAG=4 0 {ulen(artist) - 1}\n")
                    f.write(f"DL_PLUS_TAG=1 {ulen(artist) + 3} {ulen(title) - 1}\n")
                elif text:
                    f.write(f"DL_PLUS_TAG=33 0 {ulen(text) - 1}\n")
                f.write("##### parameters } #####\n")
            f.write(f"{artist} - {title}" if at_used else text)
        return True
    except OSError:
        return False
