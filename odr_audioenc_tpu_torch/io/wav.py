"""Minimal RIFF WAV reader/writer (src/wavfile.cpp equivalent): 16-bit PCM
only, tolerant chunk scan, streamable from pipes."""
import struct


class WavReader:
    def __init__(self, f):
        self.f = f
        hdr = f.read(12)
        if len(hdr) < 12 or hdr[:4] != b"RIFF" or hdr[8:12] != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        self.rate = None
        self.channels = None
        self.bits = None
        self.data_left = None
        while True:
            ch = f.read(8)
            if len(ch) < 8:
                raise ValueError("no data chunk found")
            tag, size = ch[:4], struct.unpack("<I", ch[4:])[0]
            if tag == b"fmt ":
                fmt = f.read(size)
                (audio_fmt, self.channels, self.rate, _, _, self.bits) = \
                    struct.unpack("<HHIIHH", fmt[:16])
                if audio_fmt != 1 or self.bits != 16:
                    raise ValueError("only 16-bit PCM WAV supported")
            elif tag == b"data":
                self.data_left = size if size != 0xFFFFFFFF else None
                break
            else:
                f.read(size + (size & 1))

    def read(self, nbytes):
        if self.data_left is not None:
            nbytes = min(nbytes, self.data_left)
        buf = self.f.read(nbytes)
        if self.data_left is not None:
            self.data_left -= len(buf)
        return buf


class WavWriter:
    """wavfile.h:31-44 analogue; header patched on close."""

    def __init__(self, filename, rate, channels):
        self.f = open(filename, "wb")
        self.rate, self.channels = rate, channels
        self.data_bytes = 0
        self._write_header()

    def _write_header(self):
        f = self.f
        f.seek(0)
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + self.data_bytes))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, self.channels, self.rate,
                            self.rate * self.channels * 2, self.channels * 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", self.data_bytes))

    def write(self, data):
        self.f.write(data)
        self.data_bytes += len(data)

    def close(self):
        self._write_header()
        self.f.close()
