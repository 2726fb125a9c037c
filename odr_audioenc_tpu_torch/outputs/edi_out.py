"""EDI output: TAG items/packet, AF packetisation, PFT protection &
fragmentation, and the UDP/TCP sender with time-spreading.

Byte-faithful re-implementation of contrib/edioutput/ (TagItems.cpp,
TagPacket.cpp, AFPacket.cpp:47-93, PFT.cpp:75-319, Transport.cpp) as host
Python: the wire format must match exactly because ODR-DabMux is the consumer.
"""
import socket
import struct
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ..fec.rs import ReedSolomon
from .base import Output


def crc16_genibus(data):
    """crc16(0xffff, ...) ^ 0xffff with the CCITT 0x1021 table (contrib/crc.c)."""
    crc = 0xFFFF
    for byte in data:
        crc ^= byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc ^ 0xFFFF


# ---------------- TAG items (TagItems.cpp) ----------------

def tag_star_ptr(protocol=b"DSTI"):
    """*ptr (TagItems.cpp:46-70)."""
    assert len(protocol) == 4
    return b"*ptr" + bytes([0, 0, 0, 0x40]) + protocol + b"\x00\x00\x00\x00"


class TagDSTI:
    """dsti with dlfc counter state (TagItems.cpp:141-196)."""

    def __init__(self):
        self.dlfc = 0
        self.stihf = False
        self.atstf = False
        self.rfadf = False
        self.utco = 0
        self.seconds = 0
        self.tsta = 0xFFFFFF

    def set_edi_time(self, t_posix, tai_utc_offset):
        """(TagItems.h:169-180): utco = offset - 32; seconds since 2000-01-01
        00:00:00 UTC + utco."""
        self.utco = tai_utc_offset - 32
        posix_timestamp_1_jan_2000 = 946684800
        self.seconds = t_posix - posix_timestamp_1_jan_2000 + self.utco

    def assemble(self):
        body = bytearray()
        dfctl = self.dlfc % 250
        dfcth = self.dlfc // 250
        hdr = dfctl | (dfcth << 8) | (int(self.rfadf) << 13) | \
            (int(self.atstf) << 14) | (int(self.stihf) << 15)
        body += struct.pack(">H", hdr)
        if self.atstf:
            body.append(self.utco & 0xFF)
            body += struct.pack(">I", self.seconds & 0xFFFFFFFF)
            body += bytes([(self.tsta >> 16) & 0xFF, (self.tsta >> 8) & 0xFF,
                           self.tsta & 0xFF])
        self.dlfc = (self.dlfc + 1) % 5000
        return b"dsti" + struct.pack(">I", len(body) * 8) + bytes(body)


def tag_ssm(istd, stid=0, tid=0, tidext=0, rfa=0, crcstf=False, sstc_id=1):
    """ssNNN payload tag (TagItems.cpp:197+, TagItems.h:197-217)."""
    istc = (rfa << 19) | (tid << 16) | (tidext << 13) | (int(crcstf) << 12) | stid
    body = bytes([(istc >> 16) & 0xFF, (istc >> 8) & 0xFF, istc & 0xFF]) + bytes(istd)
    return b"ss" + struct.pack(">H", sstc_id) + struct.pack(">I", len(body) * 8) + body


def tag_odr_audio_levels(left, right):
    return b"ODRa" + struct.pack(">I", 32) + struct.pack(">hh", left, right)


def tag_odr_version(version, uptime):
    body = version.encode() + struct.pack(">I", uptime)
    return b"ODRv" + struct.pack(">I", len(body) * 8) + body


def tag_star_dmy(length):
    return b"*dmy" + struct.pack(">I", length * 8) + bytes(length)


def tag_packet(tags, alignment=8):
    """Concatenate + pad (TagPacket.cpp:42-76)."""
    packet = b"".join(tags)
    if alignment == 8:
        while len(packet) % 8:
            packet += b"\x00"
    elif alignment > 8:
        packet += tag_star_dmy(alignment - 8)
    return packet


# ---------------- AF / PFT ----------------

class AFPacketiser:
    """AFPacket.cpp:47-93."""

    def __init__(self, have_crc=True):
        self.seq = 0
        self.have_crc = have_crc

    def assemble(self, payload):
        pkt = bytearray(b"AF")
        pkt += struct.pack(">I", len(payload))
        pkt += struct.pack(">H", self.seq)
        self.seq = (self.seq + 1) & 0xFFFF
        pkt.append((0x80 if self.have_crc else 0) | 0x10)  # CF | MAJ=1 MIN=0
        pkt.append(ord("T"))
        pkt += payload
        pkt += struct.pack(">H", crc16_genibus(pkt))
        return bytes(pkt)


_PARITY = 48
_rs_pft = None


def _pft_rs():
    global _rs_pft
    if _rs_pft is None:
        _rs_pft = ReedSolomon(nroots=_PARITY, kk=207, poly=0x11D, fcr=1, prim=1)
    return _rs_pft


class PFT:
    """PFT.cpp:75-319.  m = number of recoverable fragments (RS enabled when
    m > 0)."""

    def __init__(self, m=2, dest_port=0, transport_header=False):
        self.m = m
        self.pseq = 0
        self.transport_header = transport_header
        self.dest_port = dest_port
        self.addr_source = 0

    def _protect(self, af):
        num_chunks = -(-len(af) // 207)
        chunk_len = -(-len(af) // num_chunks)
        assert chunk_len <= 207
        zero_pad = num_chunks * chunk_len - len(af)
        data = np.frombuffer(af + b"\x00" * zero_pad, np.uint8).reshape(
            num_chunks, chunk_len)
        padded = np.zeros((num_chunks, 207), np.uint8)
        padded[:, :chunk_len] = data
        parity = _pft_rs().encode(padded)
        out = np.concatenate([data, parity], axis=1)
        return out.reshape(-1), num_chunks, chunk_len, zero_pad

    def assemble(self, af):
        if self.m > 0:
            rs_block, num_chunks, chunk_len, zero_pad = self._protect(af)
            max_payload = (num_chunks * _PARITY) // (self.m + 1)
            num_frag = -(-len(rs_block) // max_payload)
            frag_size = -(-len(rs_block) // num_frag)
            padded = np.zeros(num_frag * frag_size, np.uint8)
            padded[:len(rs_block)] = rs_block
            # interleave: fragment i byte j = rs_block[j*num_frag + i]
            frags = [bytes(padded.reshape(frag_size, num_frag)[:, i])
                     for i in range(num_frag)]
        else:
            max_payload = 1400
            num_frag = -(-len(af) // max_payload)
            frag_size = -(-len(af) // num_frag)
            frags = [af[i * frag_size:(i + 1) * frag_size] for i in range(num_frag)]
            num_chunks = chunk_len = zero_pad = 0

        out = []
        for findex, frag in enumerate(frags):
            pkt = bytearray(b"PF")
            pkt += struct.pack(">H", self.pseq)
            pkt += bytes([(findex >> 16) & 0xFF, (findex >> 8) & 0xFF, findex & 0xFF])
            pkt += bytes([(num_frag >> 16) & 0xFF, (num_frag >> 8) & 0xFF,
                          num_frag & 0xFF])
            plen = len(frag)
            if self.m > 0:
                plen |= 0x8000
            if self.transport_header:
                plen |= 0x4000
            pkt += struct.pack(">H", plen)
            if self.m > 0:
                pkt += bytes([chunk_len, zero_pad])
            if self.transport_header:
                pkt += struct.pack(">HH", self.addr_source, self.dest_port)
            pkt += struct.pack(">H", crc16_genibus(pkt))
            pkt += frag
            out.append(bytes(pkt))
        self.pseq = (self.pseq + 1) & 0xFFFF
        return out


# ---------------- Transport / Sender ----------------

@dataclass
class EdiDestination:
    proto: str = "udp"         # udp | tcp | tcp-server
    dest_addr: str = "127.0.0.1"
    dest_port: int = 12000
    source_addr: str = ""
    source_port: int = 0
    ttl: int = 10
    max_frames_queued: int = 1024
    preroll_buffers: int = 0


class TcpDispatcher:
    """TCP server fan-out with per-connection queues and optional preroll
    (contrib/Socket.h TCPDataDispatcher + ThreadsafeQueue equivalent)."""

    def __init__(self, port, max_queued=1024, preroll=0):
        import queue as _q
        self._q = _q
        self.max_queued = max_queued
        self.preroll = preroll
        self.preroll_buf = []
        self.conns = []
        self.lock = threading.Lock()
        self.srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind(("0.0.0.0", port))
        self.port = self.srv.getsockname()[1]
        self.srv.listen(8)
        self.running = True
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self):
        while self.running:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return
            q = self._q.Queue(self.max_queued)
            with self.lock:
                for b in self.preroll_buf[-self.preroll:] if self.preroll else []:
                    q.put_nowait(b)
                self.conns.append((conn, q))
            threading.Thread(target=self._send_loop, args=(conn, q),
                             daemon=True).start()

    def _send_loop(self, conn, q):
        while self.running:
            data = q.get()
            if data is None:
                break
            try:
                conn.sendall(data)
            except OSError:
                break
        try:
            conn.close()
        except OSError:
            pass
        with self.lock:
            self.conns = [(c, cq) for c, cq in self.conns if c is not conn]

    def write(self, data):
        with self.lock:
            if self.preroll:
                self.preroll_buf.append(data)
                self.preroll_buf = self.preroll_buf[-self.preroll:]
            for _, q in self.conns:
                try:
                    q.put_nowait(data)
                except self._q.Full:
                    pass

    def close(self):
        self.running = False
        try:
            self.srv.close()
        except OSError:
            pass
        with self.lock:
            for _, q in self.conns:
                q.put(None)


@dataclass
class EdiConfig:
    enabled: bool = True
    enable_pft: bool = False
    fec: int = 2               # recoverable fragments m
    chunk_len: int = 207
    fragment_spreading_factor: float = 0.95
    dump: bool = False
    verbose: bool = False
    tagpacket_alignment: int = 8
    destinations: list = field(default_factory=list)


class EdiSender:
    """edi::Sender (Transport.cpp): AF assembly, optional PFT with fragments
    time-spread over 95% of the 24 ms frame interval via a sender thread."""

    def __init__(self, conf: EdiConfig):
        self.conf = conf
        self.af = AFPacketiser()
        self.pft = PFT(conf.fec) if conf.enable_pft else None
        self.socks = []
        for d in conf.destinations:
            if d.proto == "udp":
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                if d.ttl:
                    s.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, d.ttl)
                if d.source_addr:
                    s.bind((d.source_addr, d.source_port))
                self.socks.append(("udp", s, (d.dest_addr, d.dest_port)))
            elif d.proto == "tcp":
                s = socket.create_connection((d.dest_addr, d.dest_port), timeout=5.0)
                self.socks.append(("tcp", s, None))
            elif d.proto == "tcp-server":
                disp = TcpDispatcher(d.dest_port, d.max_frames_queued,
                                     d.preroll_buffers)
                self.socks.append(("tcp-server", disp, None))
            else:
                raise ValueError(f"unknown EDI proto {d.proto}")
        self._queue = []
        self._lock = threading.Condition()
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def write(self, tagpacket_bytes):
        af = self.af.assemble(tagpacket_bytes)
        if self.pft is not None:
            frags = self.pft.assemble(af)
            interval = 0.024 * self.conf.fragment_spreading_factor
            now = time.monotonic()
            with self._lock:
                for i, f in enumerate(frags):
                    self._queue.append((now + interval * i / max(len(frags), 1), f))
                self._lock.notify()
        else:
            self._send(af)

    def _send(self, data):
        for proto, s, addr in self.socks:
            try:
                if proto == "udp":
                    s.sendto(data, addr)
                elif proto == "tcp-server":
                    s.write(data)
                else:
                    s.sendall(data)
            except OSError:
                pass

    def _run(self):
        while self._running:
            with self._lock:
                if not self._queue:
                    self._lock.wait(timeout=0.1)
                    continue
                self._queue.sort(key=lambda x: x[0])
                when, data = self._queue[0]
                now = time.monotonic()
                if when > now:
                    self._lock.wait(timeout=when - now)
                    continue
                self._queue.pop(0)
            self._send(data)

    def close(self):
        self._running = False
        with self._lock:
            self._lock.notify()
        self._thread.join(timeout=1.0)
        for _, s, _ in self.socks:
            s.close()


class EdiOutput(Output):
    """EDI output (src/Outputs.cpp:140-261): one 24 ms frame per write_frame,
    wrapped in *ptr/dsti/ss0/ODRa (+ODRv every 10 s) tags."""

    VERSION = "odr-audioenc-tpu-0.1.0"

    def __init__(self, conf: EdiConfig, tist=False, delay_ms=0, tai_offset=None):
        super().__init__()
        from ..host.clocktai import ClockTAI
        self.conf = conf
        self.sender = None
        self.tist = tist
        self.delay_ms = delay_ms
        self._clock_tai = ClockTAI() if tai_offset is None else None
        self.tai_offset = tai_offset
        self.tag_dsti = TagDSTI()
        self.timestamp = 0
        self.edi_time = 0
        self.send_version_at = 0
        self.num_seconds_sent = 0

    def write_frame(self, buf):
        if self.sender is None:
            self.sender = EdiSender(self.conf)
        if self.edi_time == 0:
            self.edi_time = int(time.time()) + self.delay_ms // 1000
            self.send_version_at = self.edi_time
            sub_ms = self.delay_ms % 1000
            while sub_ms > 0:
                self.timestamp += 24 << 14
                sub_ms -= 24

        self.tag_dsti.stihf = False
        self.tag_dsti.atstf = self.tist
        self.timestamp += 24 << 14
        if self.timestamp > 0xF9FFFF:
            self.timestamp -= 0xFA0000
            self.edi_time += 1
            self.num_seconds_sent += 1
        offset = self.tai_offset if self.tai_offset is not None \
            else self._clock_tai.get_offset()
        self.tag_dsti.set_edi_time(self.edi_time, offset)
        self.tag_dsti.tsta = self.timestamp & 0xFFFFFF

        tags = [tag_star_ptr(b"DSTI"), self.tag_dsti.assemble(),
                tag_ssm(buf), tag_odr_audio_levels(self.audio_left, self.audio_right)]
        if self.send_version_at < self.edi_time:
            self.send_version_at += 10
            tags.append(tag_odr_version(self.VERSION, self.num_seconds_sent))
        self.sender.write(tag_packet(tags, self.conf.tagpacket_alignment))
        return True

    def close(self):
        if self.sender:
            self.sender.close()
