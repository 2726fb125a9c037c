"""MSB-first bit writer (host side).

Replaces the reference's top-down buffer + reversal (bitstream.c) with a plain
forward writer; the observable byte stream is identical."""


class BitWriter:
    __slots__ = ("buf", "acc", "nbits")

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, val, n):
        self.acc = (self.acc << n) | (int(val) & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def bytes(self):
        assert self.nbits == 0, "frame not byte aligned"
        return bytes(self.buf)
