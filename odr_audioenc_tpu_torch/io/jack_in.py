"""JACK capture input: a ctypes client of libjack.

Functional equivalent of the reference's JackInput (src/JackInput.cpp:
40-152): open a client, register one float input port per channel
("input0", "input1", ...), verify the server's sample rate, and convert
each process() callback's float buffers to interleaved S16LE pushed into
the SampleQueue.  The conversion saturates correctly (the reference's
saturation branches at JackInput.cpp:136-142 map +-1.0 overshoot to the
OPPOSITE rail - an obvious sign slip we do not reproduce).

libjack is loaded at runtime (ODR_JACK_LIB overrides the soname - used by
the test suite's fake server, tools/fake_jack.c); when absent, prepare()
raises the same gate error the reference's compile-time HAVE_JACK gives.
"""
import ctypes as C
import os

import numpy as np

from .inputs import InputInterface

JACK_DEFAULT_AUDIO_TYPE = b"32 bit float mono audio"
JackPortIsInput = 0x1
JackServerStarted = 0x10
JackNameNotUnique = 0x20

_PROCESS_CB = C.CFUNCTYPE(C.c_int, C.c_uint32, C.c_void_p)
_SHUTDOWN_CB = C.CFUNCTYPE(None, C.c_void_p)


def _load_libjack():
    path = os.environ.get("ODR_JACK_LIB", "libjack.so.0")
    try:
        lib = C.CDLL(path)
    except OSError:
        raise RuntimeError(
            "JACK input requires libjack, which is not available in this "
            "environment (matches the reference's compile-time gate)")
    lib.jack_client_open.restype = C.c_void_p
    lib.jack_client_open.argtypes = [C.c_char_p, C.c_int,
                                     C.POINTER(C.c_long)]
    lib.jack_get_sample_rate.restype = C.c_uint32
    lib.jack_get_sample_rate.argtypes = [C.c_void_p]
    lib.jack_set_process_callback.argtypes = [C.c_void_p, _PROCESS_CB,
                                              C.c_void_p]
    lib.jack_on_shutdown.argtypes = [C.c_void_p, _SHUTDOWN_CB, C.c_void_p]
    lib.jack_port_register.restype = C.c_void_p
    lib.jack_port_register.argtypes = [C.c_void_p, C.c_char_p, C.c_char_p,
                                       C.c_ulong, C.c_ulong]
    lib.jack_port_get_buffer.restype = C.POINTER(C.c_float)
    lib.jack_port_get_buffer.argtypes = [C.c_void_p, C.c_uint32]
    lib.jack_activate.argtypes = [C.c_void_p]
    lib.jack_client_close.argtypes = [C.c_void_p]
    return lib


class JackInput(InputInterface):
    """Live JACK capture (reference: src/JackInput.cpp)."""

    def __init__(self, queue, name, rate, channels):
        self.queue = queue
        self.name = name
        self.rate = rate
        self.channels = channels
        self.lib = None
        self.client = None
        self.ports = []
        self.fault = False
        # keep callback objects referenced for the client's lifetime
        self._cbs = []

    def prepare(self):
        lib = self.lib = _load_libjack()
        status = C.c_long(0)
        client = lib.jack_client_open(self.name.encode(), 0,
                                      C.byref(status))
        if not client:
            raise RuntimeError(
                f"JACK: could not connect to server (status 0x{status.value:x})")
        self.client = client
        if status.value & JackNameNotUnique:
            raise RuntimeError(f"JACK name '{self.name}' not unique!")

        proc = _PROCESS_CB(self._process)
        down = _SHUTDOWN_CB(self._shutdown)
        self._cbs += [proc, down]
        lib.jack_set_process_callback(client, proc, None)
        lib.jack_on_shutdown(client, down, None)

        srate = lib.jack_get_sample_rate(client)
        if srate != self.rate:
            raise RuntimeError(
                f"JACK uses different sample_rate {srate} than requested "
                f"({self.rate})!")
        for i in range(self.channels):
            port = lib.jack_port_register(client, f"input{i}".encode(),
                                          JACK_DEFAULT_AUDIO_TYPE,
                                          JackPortIsInput, 0)
            if not port:
                raise RuntimeError("no more JACK ports available")
            self.ports.append(port)
        if lib.jack_activate(client):
            raise RuntimeError("JACK: cannot activate client")

    def _process(self, nframes, _arg):
        try:
            buf = np.empty((nframes, self.channels), np.int16)
            for c, port in enumerate(self.ports):
                src = self.lib.jack_port_get_buffer(port, nframes)
                x = np.ctypeslib.as_array(src, shape=(nframes,))
                buf[:, c] = np.clip(np.rint(x * 32768.0), -32768, 32767)
            self.queue.push(buf.tobytes())
            return 0
        except Exception:
            self.fault = True
            return 1

    def _shutdown(self, _arg):
        self.fault = True

    def fault_detected(self):
        return self.fault

    def read_source(self, size_bytes):
        # reading happens on the JACK thread; no termination condition
        return True

    def close(self):
        if self.client is not None and self.lib is not None:
            self.lib.jack_client_close(self.client)
            self.client = None
