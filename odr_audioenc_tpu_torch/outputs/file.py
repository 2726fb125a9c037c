"""File/pipe output (src/Outputs.cpp:38-61 equivalent)."""
import sys

from .base import Output


class FileOutput(Output):
    def __init__(self, filename):
        super().__init__()
        if filename == "-":
            self.f = sys.stdout.buffer
        else:
            self.f = open(filename, "wb")

    def write_frame(self, buf):
        try:
            self.f.write(buf)
            self.f.flush()
            return True
        except OSError:
            return False

    def close(self):
        if self.f is not sys.stdout.buffer:
            self.f.close()
