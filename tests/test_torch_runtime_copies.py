"""The runtime's host modules copied into the port (`io/`, `outputs/`,
`host/{sidecars,log,clocktai,aacparse}.py`) against the JAX package's
originals: each copy's source is the original's, and on the same inputs
each gives the original's bytes and behaviour (WAV, the sample queue, drift
compensation, the live inputs, JACK, EDI TAG/AF/PFT packets, CURVE, the ZMQ
framing, the sidecars, the log backends, ClockTAI and the AU parser).
Every comparison is exact: bytes, integers and strings are equal."""
import importlib
import json
import os
import re
import socket
import struct
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from signals import music_like
from torch_cpu import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
COPIES = ("io/__init__.py", "io/wav.py", "io/queue.py", "io/drift.py", "io/inputs.py",
          "io/jack_in.py", "outputs/__init__.py", "outputs/base.py", "outputs/file.py",
          "outputs/curve.py", "outputs/zmq_out.py", "outputs/edi_out.py",
          "host/sidecars.py", "host/log.py", "host/clocktai.py", "host/aacparse.py")


def both(name):
    """(the JAX package's module, the port's) for a dotted module name."""
    return (importlib.import_module(f"odr_audioenc_tpu.{name}"),
            importlib.import_module(f"odr_audioenc_tpu_torch.{name}"))


@pytest.mark.parametrize("rel", COPIES)
def test_copy_source_is_the_original(rel):
    """The copies are verbatim: their sibling imports are relative, and the
    port has every sibling they name (`fec/rs.py`, `dabplus/tables.py`), so
    not even an import differs."""
    orig = (ROOT / "odr_audioenc_tpu" / rel).read_text()
    assert (ROOT / "odr_audioenc_tpu_torch" / rel).read_text() == orig
    mod = importlib.import_module("odr_audioenc_tpu_torch." + rel[:-3].replace("/", ".")
                                  .removesuffix(".__init__"))
    assert mod.__name__.startswith("odr_audioenc_tpu_torch")


# ---- io -------------------------------------------------------------------------


def test_wav_round_trip(tmp_path):
    """WavWriter writes the original's bytes; each WavReader reads the
    other's file back to the same header and samples."""
    sig = music_like(3, seed=4)
    pcm = sig.T.astype("<i2").tobytes()
    files = []
    for i, W in enumerate(both("io.wav")):
        w = W.WavWriter(str(tmp_path / f"{i}.wav"), 48000, 2)
        w.write(pcm[:1000])
        w.write(pcm[1000:])
        w.close()
        files.append((tmp_path / f"{i}.wav").read_bytes())
    assert files[0] == files[1]
    for i, W in enumerate(both("io.wav")):
        with open(tmp_path / f"{1 - i}.wav", "rb") as f:
            r = W.WavReader(f)
            assert (r.rate, r.channels) == (48000, 2)
            assert r.read(len(pcm) + 100) == pcm


def _queue_trace(Q):
    """The behaviours of tests/test_inputs.py:19-83 on SampleQueue class Q,
    as a list of observations."""
    seen = []
    q = Q()
    q.configure(1 << 16, push_block=False, channels=2)
    q.push(b"\x01\x02\x03\x04" * 10)
    seen.append(q.pop(64))                              # zero fill
    q = Q()
    q.configure(16, push_block=False, channels=1)
    for n in (16, 4, 4):                                # the last two overrun
        q.push(b"\x00" * n)
    seen += [q.pop(16), q.pop(4)]
    q = Q()
    q.configure(1 << 16, push_block=False, channels=1)
    q.push(b"\x00" * 6)
    t0 = time.monotonic()
    seen.append(q.pop_wait(100, timeout_ms=200))        # short after the timeout
    seen.append(time.monotonic() - t0 >= 0.15)
    q = Q()
    q.configure(1 << 16, push_block=False, channels=1)

    def producer():
        for _ in range(4):
            time.sleep(0.02)
            q.push(b"\xaa" * 32)
    t = threading.Thread(target=producer)
    t.start()
    seen.append(q.pop_wait(128, timeout_ms=2000))
    t.join()
    q = Q()
    q.configure(64, push_block=True, channels=1)
    done = []
    t = threading.Thread(target=lambda: (q.push(b"\x00" * 128), done.append(True)))
    t.start()
    time.sleep(0.05)
    seen.append((list(done), len(q)))                   # blocked at the bound
    q.pop(64)
    t.join(timeout=2)
    seen.append((list(done), len(q)))
    return seen


def test_sample_queue_behaves_as_the_original():
    """Zero-filling pop, overrun counts reset by pop, pop_wait's short
    return at its timeout and its wait for a producer thread, and the
    blocking push bounded by the queue size: the same observations from
    both queues, and the ones tests/test_inputs.py asserts."""
    jq, tq = (m.SampleQueue for m in both("io.queue"))
    want = _queue_trace(jq)
    got = _queue_trace(tq)
    assert got == want
    assert got[0] == (b"\x01\x02\x03\x04" * 10 + bytes(24), 40, 0)
    assert got[1][2] == 2 and got[2][2] == 0
    assert got[3] == (bytes(6), 0) and got[4] is True
    assert got[5] == (b"\xaa" * 128, 0)
    assert got[6] == ([], 64) and got[7] == ([True], 64)


@pytest.mark.parametrize("channels", [1, 2])
def test_expand_missing_samples_equals_original(channels):
    """Drift compensation on random buffers: duplication under 10% missing,
    zero fill above it and with nothing valid; the bytes are the
    original's."""
    rng = np.random.default_rng(channels)
    jd, td = (m.expand_missing_samples for m in both("io.drift"))
    n = 1152
    for missing in (0, 1, 7, 100, 115, 116, 600, n - 1, n):
        base = bytearray(rng.integers(0, 256, n * 2 * channels, dtype=np.uint8).tobytes())
        valid = (n - missing) * 2 * channels
        if valid == len(base):
            continue
        a, b = bytearray(base), bytearray(base)
        jd(a, channels, valid)
        td(b, channels, valid)
        assert a == b, missing


def _subprocess_trace(inputs, tmp_path):
    """Run a subprocess input to its child's end: the child has exited and
    both of the input's reader threads have read its pipes to EOF, so its
    PCM is in the queue and its ICY line is parsed.  The stdout reader can
    finish before the stderr reader, so the child's exit and a full queue
    alone are not enough.  A 60 s guard fails a hang."""
    q = importlib.import_module(inputs.__name__.rsplit(".", 1)[0] + ".queue").SampleQueue()
    q.configure(1 << 20, push_block=False, channels=1)
    inp = inputs.SubprocessInput(q, ["/bin/sh", "-c",
                                     "echo \"Metadata update for StreamTitle: Test Song\" >&2; "
                                     f"head -c 9600 {tmp_path / 'pcm.raw'}"], 48000, 1)
    inp.prepare()
    try:
        inp.proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        inp.close()
        pytest.fail("the input's child ran on for 60 s")
    for t in inp._threads:
        t.join(timeout=60)
        assert not t.is_alive(), "a reader of the child's pipes ran on for 60 s"
    text, fault = inp.get_icy_text(), inp.fault_detected()
    inp.close()
    return q.pop(9600)[0], text, fault


def test_live_inputs_equal_original(tmp_path):
    """A subprocess input (the live inputs' common base): its PCM lands in
    the queue, the ICY title is parsed from its stderr, and its exit is a
    fault; the same for the original.  The file input reads a WAV in the
    same chunks, zero-padding the last."""
    (tmp_path / "pcm.raw").write_bytes(np.arange(4800, dtype="<i2").tobytes())
    ji, ti = both("io.inputs")
    got, want = _subprocess_trace(ti, tmp_path), _subprocess_trace(ji, tmp_path)
    assert got == want
    assert got[0] == (tmp_path / "pcm.raw").read_bytes() and got[1] == "Test Song" and got[2]
    wav = tmp_path / "in.wav"
    w = both("io.wav")[1].WavWriter(str(wav), 48000, 2)
    w.write(music_like(2, seed=3).T.astype("<i2").tobytes())
    w.close()
    reads = []
    for inputs in (ji, ti):
        q = importlib.import_module(inputs.__name__.rsplit(".", 1)[0] + ".queue").SampleQueue()
        q.configure(1 << 20, push_block=False, channels=2)
        inp = inputs.FileInput(q, str(wav), False, 48000, 2)
        inp.prepare()
        oks = [inp.read_source(4000) for _ in range(4)]
        reads.append((oks, q.pop(len(q) // 4 * 4)[0]))
        inp.close()
    assert reads[0] == reads[1] and reads[1][0] == [True, True, True, False]


@pytest.fixture(scope="module")
def fake_jack(tmp_path_factory):
    """tools/fake_jack.c (a libjack stand-in that feeds sines, then shuts
    down), built into this module's own directory; two copies, since the
    fake server's sine phase is a global of the loaded library."""
    d = tmp_path_factory.mktemp("jack")
    subprocess.check_call(["g++", "-shared", "-fPIC", "-O2", "-o", str(d / "a.so"),
                           str(ROOT / "tools" / "fake_jack.c"), "-lpthread"])
    (d / "b.so").write_bytes((d / "a.so").read_bytes())
    return d / "a.so", d / "b.so"


def test_jack_capture_and_gate_equal_original(fake_jack, monkeypatch):
    """JACK through the fake server: the same captured PCM and the fault at
    its shutdown; without libjack both raise the reference's gate error."""
    caught = []
    for jack_in, queue, lib in zip(both("io.jack_in"), both("io.queue"), fake_jack):
        monkeypatch.setenv("ODR_JACK_LIB", str(lib))
        q = queue.SampleQueue()
        q.configure(1 << 20, push_block=False, channels=2)
        inp = jack_in.JackInput(q, "test", 48000, 2)
        inp.prepare()
        deadline = time.time() + 5.0
        while not inp.fault_detected() and time.time() < deadline:
            time.sleep(0.02)
        assert inp.fault_detected()
        inp.close()
        caught.append(q.pop(20 * 256 * 4)[:2])
        monkeypatch.setenv("ODR_JACK_LIB", "/nonexistent/libjack.so.0")
        with pytest.raises(RuntimeError, match="libjack"):
            jack_in.JackInput(q, "x", 48000, 2).prepare()
    assert caught[0] == caught[1] and caught[1][1] == 20 * 256 * 4
    with pytest.raises(RuntimeError, match="libjack"):
        both("io.inputs")[1].JackInput(None, "x", 48000, 2).prepare()


# ---- outputs: EDI ------------------------------------------------------------------


def test_edi_tag_and_af_packets_equal_original():
    """TAG items (*ptr, DSTI with TIST, ss, ODRa, ODRv, *dmy), the TAG
    packet at two alignments and AF packets with sequence numbers: the
    original's bytes (tests/test_edi.py:26-55 builds them against the
    reference's edioutput)."""
    payload = bytes(np.random.default_rng(1).integers(0, 256, 264).astype(np.uint8))
    packets = []
    for E in both("outputs.edi_out"):
        dsti = E.TagDSTI()
        dsti.stihf = False
        dsti.atstf = True
        dsti.set_edi_time(1_700_000_000, 37)
        dsti.tsta = 0x00C000
        dsti.dlfc = 3
        tags = [E.tag_star_ptr(b"DSTI"), dsti.assemble(), E.tag_ssm(payload),
                E.tag_odr_audio_levels(-900, -800), E.tag_odr_version("v", 12),
                E.tag_star_dmy(7)]
        af = E.AFPacketiser()
        af.seq = 0xFFFE
        pk = [E.tag_packet(tags, a) for a in (8, 16)]
        pk += [af.assemble(pk[0]), af.assemble(payload), af.assemble(b"")]
        pk.append(E.crc16_genibus(payload).to_bytes(2, "big"))
        packets.append(pk)
    assert packets[0] == packets[1]
    assert packets[1][2][:2] == b"AF" and packets[1][3][6:8] == b"\xff\xff"
    assert packets[1][4][6:8] == b"\x00\x00"


@pytest.mark.parametrize("aflen,m,header", [(500, 2, False), (1340, 3, False),
                                            (207 * 3 + 5, 1, True), (3000, 0, False)])
def test_pft_fragments_equal_original(aflen, m, header):
    """PFT fragments with RS FEC (m recoverable fragments; m=0: no FEC) and
    the optional transport header, over two packets: the original's bytes
    (tests/test_edi.py:58-75 holds those against the reference)."""
    af = bytes(np.random.default_rng(aflen).integers(0, 256, aflen).astype(np.uint8))
    frags = []
    for E in both("outputs.edi_out"):
        pft = E.PFT(m=m, dest_port=12002, transport_header=header)
        pft.pseq = 7
        frags.append(pft.assemble(af) + pft.assemble(af[::-1]))
    assert frags[0] == frags[1] and len(frags[1]) >= 2


def _edi_capture(E, frames, fec):
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 20)
    rx.settimeout(1.0)
    conf = E.EdiConfig(enable_pft=fec > 0, fec=fec,
                       destinations=[E.EdiDestination("udp", "127.0.0.1",
                                                      rx.getsockname()[1])])
    out = E.EdiOutput(conf, tist=True, delay_ms=1500, tai_offset=37)
    for i, f in enumerate(frames):
        out.update_audio_levels(100 * i, -100 * i)
        assert out.write_frame(f)
    # PFT fragments go out from the sender's thread, spread over 24 ms each
    deadline = time.monotonic() + 10
    while fec and out.sender._queue and time.monotonic() < deadline:
        time.sleep(0.01)
    out.close()
    pkts = []
    try:
        while True:
            pkts.append(rx.recv(65536))
    except socket.timeout:
        pass
    rx.close()
    return pkts


@pytest.mark.parametrize("fec", [0, 2])
def test_edi_output_sends_the_original_packets(fec, monkeypatch):
    """EdiOutput end to end over UDP with TIST and a fixed clock: 50 frames
    of 24 ms (the seconds roll over, the ODRv tag comes every 10 s of EDI
    time) give the original's AF or PF packets, byte for byte (the PF
    fragments of different frames interleave by the sender thread's
    timing, so those are compared as sorted lists)."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    rng = np.random.default_rng(fec)
    frames = [rng.integers(0, 256, 288).astype(np.uint8).tobytes() for _ in range(50)]
    want, got = (_edi_capture(E, frames, fec) for E in both("outputs.edi_out"))
    if fec:
        got, want = sorted(got), sorted(want)
    assert got == want and len(got) >= 50
    assert all(p[:2] == (b"PF" if fec else b"AF") for p in got)


# ---- outputs: CURVE and ZMQ --------------------------------------------------------


def test_curve_vectors():
    """The port's CURVE primitives on the vectors of tests/test_curve.py:
    RFC 7748 X25519, the NaCl crypto_box vector, RFC 8439 Poly1305, Z85."""
    C = both("outputs.curve")[1]
    k = bytes.fromhex("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4")
    u = bytes.fromhex("e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c")
    assert C.x25519(k, u).hex() == \
        "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"
    a = bytes.fromhex("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a")
    assert C.x25519_base(a).hex() == \
        "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a"
    bobpk = bytes.fromhex("de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f")
    nonce = bytes.fromhex("69696ee955b62b73cd62bda875fc73d68219e0036b7a0b37")
    m = bytes.fromhex(
        "be075fc53c81f2d5cf141316ebeb0c7b5228c52a4c62cbd44b66849b64244ffc"
        "e5ecbaaf33bd751a1ac728d45e6c61296cdc3c01233561f41db66cce314adb31"
        "0e3be8250c46f06dceea3a7fa1348057e2f6556ad6b1318a024a838f21af1fde"
        "048977eb48f59ffd4924ca1c60902e52f0a089bc76897040e082f93776384864"
        "5e0705")
    boxed = C.box_afternm(m, nonce, C.box_beforenm(bobpk, a))
    assert boxed.hex() == (
        "f3ffc7703f9400e52a7dfb4b3d3305d98e993b9f48681273c29650ba32fc76ce"
        "48332ea7164d96a4476fb8c531a1186ac0dfc17c98dce87b4da7f011ec48c972"
        "71d2c20f9b928fe2270d6fb863d51738b48eeee314a7cc8ab932164548e526ae"
        "90224368517acfeabd6bb3732bc0e9da99832b61ca01b6de56244a9e88d5f9b3"
        "7973f622a43d14a6599b1f654cb45a74e355a5")
    assert C.box_open_afternm(boxed, nonce, C.box_beforenm(bobpk, a)) == m
    key = bytes.fromhex("85d6be7857556d337f4452fe42d506a80103808afb0db2fd4abff6af4149f51b")
    assert C.poly1305(b"Cryptographic Forum Research Group", key).hex() == \
        "a8061dc1305136c6c22b8baf0c0127a9"
    hello = bytes([0x86, 0x4F, 0xD2, 0x6F, 0xB5, 0x59, 0xF7, 0x5B])
    assert C.z85_encode(hello) == "HelloWorld" and C.z85_decode("HelloWorld") == hello


@pytest.mark.parametrize("server_side", ["port", "jax"])
def test_curve_handshake_across_the_copies(server_side):
    """The spec:25 handshake and MESSAGEs both ways between a server of one
    copy and a client of the other; the public keys of the same secrets are
    equal, and a server with another key is refused."""
    J, T = both("outputs.curve")
    Srv, Cli = (T, J) if server_side == "port" else (J, T)
    spub, ssec = Srv.keypair()
    assert Cli.x25519_base(ssec) == spub
    srv, cli = Srv.CurveServerSession(ssec), Cli.CurveClientSession(spub)
    cli.welcome(srv.hello(cli.hello()))
    assert b"Socket-Type" in cli.ready(srv.initiate(cli.initiate()))
    for i in range(3):
        payload = os.urandom(100 + i)
        assert cli.decrypt(srv.encrypt(payload)) == (0, payload)
        assert srv.decrypt(cli.encrypt(payload[::-1], flags=1)) == (1, payload[::-1])
    with pytest.raises(ValueError):
        Srv.CurveServerSession(Srv.keypair()[1]).hello(Cli.CurveClientSession(spub).hello())


def test_zmtp_framing_equals_original():
    """The ZMTP 3.0 greeting, metadata, command and message framing (short
    and long forms) of the ZMQ output: the original's bytes."""
    out = []
    for Z in both("outputs.zmq_out"):
        out.append([Z._greeting(m, s) for m in ("NULL", "CURVE") for s in (False, True)]
                   + [Z._metadata({"Socket-Type": "PUB", "Identity": ""})]
                   + [Z._command("READY", b"x" * n) for n in (3, 300)]
                   + [Z._message(b"y" * n) for n in (0, 255, 254, 4000)]
                   + [(Z.ZMQ_ENCODER_AACPLUS, Z.ZMQ_ENCODER_MPEG_L2)])
    assert out[0] == out[1]


def _sub_once(n_msgs, got):
    """A ZMTP NULL SUB peer (the ODR-DabMux role): accept one PUB
    connection and keep the first n_msgs message payloads."""
    Z = both("outputs.zmq_out")[1]
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)

    def recv_exact(s, n):
        buf = b""
        while len(buf) < n:
            c = s.recv(n - len(buf))
            if not c:
                raise ConnectionError("peer closed")
            buf += c
        return buf

    def frame(s):
        flags = recv_exact(s, 1)[0]
        size = struct.unpack(">Q", recv_exact(s, 8))[0] if flags & 2 else recv_exact(s, 1)[0]
        return flags, recv_exact(s, size)

    def run():
        s, _ = lsock.accept()
        s.settimeout(10.0)
        s.sendall(Z._greeting("NULL", False))
        recv_exact(s, 64)
        s.sendall(Z._command("READY", Z._metadata({"Socket-Type": "SUB"})))
        frame(s)
        while len(got) < n_msgs:
            flags, payload = frame(s)
            if not flags & 0x04:
                got.append(payload)
        s.close()
        lsock.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return lsock.getsockname()[1], t


def test_zmq_output_header_and_payload_equal_original():
    """ZmqOutput to a SUB peer: each message is the ODR header (version 1,
    the encoder type, the payload size, the levels) and the frame; the
    original's messages are the same bytes."""
    frames = [os.urandom(300), os.urandom(3000)]
    msgs = []
    for Z in both("outputs.zmq_out"):
        got = []
        port, t = _sub_once(2 * len(frames), got)
        out = Z.ZmqOutput(f"tcp://127.0.0.1:{port}")
        for is_dab in (True, False):
            out.set_encoder_type(is_dab)
            for i, f in enumerate(frames):
                out.update_audio_levels(1000 + i, -2000 - i)
                assert out.write_frame(f)
        t.join(timeout=10)
        msgs.append(got)
    assert msgs[0] == msgs[1] and len(msgs[1]) == 4
    for j, m in enumerate(msgs[1]):
        f = frames[j % 2]
        assert struct.unpack("<HHIhh", m[:12]) == (1, 1 if j < 2 else 2, len(f),
                                                   1000 + j % 2, -2000 - j % 2)
        assert m[12:] == f


# ---- host sidecars, log, ClockTAI -------------------------------------------------


def test_level_equals_original():
    """The VU meter string for every 16th peak and both channels."""
    J, T = both("host.sidecars")
    for peak in list(range(0, 32768, 16)) + [32767]:
        for ch in (0, 1):
            assert T.level(ch, peak) == J.level(ch, peak)
    assert T.level(0, 0) == "" and T.level(0, 32767) in ("!=====", "======")


@pytest.mark.parametrize("dl_plus", [False, True])
def test_icy_file_and_stats_equal_original(tmp_path, dl_plus):
    """write_icy_to_file (plain text, artist/title DL Plus tags) and the
    stats datagram (levels, under/overrun counts) are the original's."""
    J, T = both("host.sidecars")
    for text, artist, title in (("Now playing: Ünïcode", "", ""), ("x", "Artist", "Title")):
        files = []
        for i, S in enumerate((J, T)):
            path = tmp_path / f"icy{i}.txt"
            assert S.write_icy_to_file(text, str(path), dl_plus, artist, title)
            files.append(path.read_text(encoding="utf-8"))
        assert files[0] == files[1]
    msgs = []
    for i, S in enumerate((J, T)):
        rx = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        rx.bind(str(tmp_path / f"s{i}.sock"))
        rx.settimeout(2.0)
        pub = S.StatsPublisher(str(tmp_path / f"s{i}.sock"))
        pub.update_audio_levels(1234, 4321)
        pub.notify_underrun()
        for _ in range(2):
            pub.notify_overrun()
        pub.send_stats()
        msgs.append(rx.recv(4096))
        rx.close()
    assert msgs[0] == msgs[1]
    assert json.loads(msgs[1])["audiolevels"] == {"left": 1234, "right": 4321}


def test_pad_interface_equals_original():
    """PadInterface against an ODR-PadEnc stand-in: the request datagram and
    the PAD bytes handed back are the original's."""
    results = []
    for S in both("host.sidecars"):
        ident = f"torch_copies_pad_{os.getpid()}"
        srv_path = f"/tmp/{ident}.padenc"
        if os.path.exists(srv_path):
            os.unlink(srv_path)
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        srv.bind(srv_path)
        srv.settimeout(2.0)
        pad = S.PadInterface()
        pad.open(ident)
        first = pad.request(16)                         # nothing answered yet
        req = srv.recv(64)
        srv.sendto(bytes([2]) + bytes(range(3, 19)) + bytes([9]), f"/tmp/{ident}.audioenc")
        time.sleep(0.05)
        results.append((first, req, pad.request(16)))
        pad.close()
        srv.close()
        os.unlink(srv_path)
    assert results[0] == results[1]
    assert results[1] == (b"", bytes([1, 16]), bytes(range(3, 19)) + bytes([9]))


def test_log_backends_equal_original(tmp_path):
    """Logger with the file and tracer backends: the same file lines, and
    the same tracer records with the microsecond stamps masked."""
    outs = []
    for i, L in enumerate(both("host.log")):
        lg = L.Logger()
        lg.register_backend(L.LogToFile(str(tmp_path / f"log{i}")))
        lg.register_backend(L.LogTracer(str(tmp_path / f"trace{i}")))
        lg.level("warn")("queue underrun")
        lg.level("info")("hello")
        lg.log(L.TRACE, "frame,1")
        lg.log("discard", "nothing")
        lg.level("error")("send failed")
        outs.append(((tmp_path / f"log{i}").read_text(),
                     re.sub(r"^\d+,", "#,", (tmp_path / f"trace{i}").read_text(), flags=re.M)))
    assert outs[0] == outs[1]
    assert "WARN: queue underrun" in outs[1][0] and "frame,1" not in outs[1][0]
    assert outs[1][1] == "#,TRACER,startup\n#,frame,1\n"


def test_clocktai_equals_original(tmp_path):
    """ClockTAI from its built-in table and from a cached IETF bulletin that
    has not expired (so nothing is downloaded): the same offsets."""
    J, T = both("host.clocktai")
    times = [1_100_000_000, 1_400_000_000, 1_440_000_000, 1_700_000_000, 2_000_000_000]
    a, b = J.ClockTAI("/nonexistent/leap"), T.ClockTAI("/nonexistent/leap")
    assert [b.get_offset(t) for t in times] == [a.get_offset(t) for t in times] == \
        [33, 35, 36, 37, 37]
    ntp = 2208988800
    bulletin = (f"#@ {4_000_000_000 + ntp}\n# comment\n{1_000_000_000 + ntp} 30\n"
                f"{1_500_000_000 + ntp} 38 # later\n")
    (tmp_path / "leap").write_text(bulletin)
    a, b = J.ClockTAI(str(tmp_path / "leap")), T.ClockTAI(str(tmp_path / "leap"))
    assert (b.entries, b.expires) == (a.entries, a.expires)
    assert [b.get_offset(t) for t in times] == [a.get_offset(t) for t in times] == \
        [30, 30, 30, 38, 38]
    assert T._parse_bulletin(bulletin) == J._parse_bulletin(bulletin)


# ---- host/aacparse on the port's own AUs ------------------------------------------


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_aacparse_equals_original_on_port_aus():
    """parse_au of the copy and of the original agree on every AU of two
    LC superframes of the port's encoder (48 kHz stereo 96k, f64, CPU):
    window sequences, section data, scalefactors and spectra."""
    from odr_audioenc_tpu_torch.dabplus import model
    from odr_audioenc_tpu_torch.host import dabplus_parse
    J, T = both("host.aacparse")
    enc = model.DabPlusEncoder(model.DabPlusConfig(48000, 12, 2), 1, dtype=torch.float64,
                               device="cpu")
    sig = music_like(12, seed=9)
    state, n = enc.init_state(), 0
    for t in range(2):
        state, frames = enc.encode_superframes(state, sig[None, :, t * 5760:(t + 1) * 5760])
        for au in dabplus_parse.parse_superframe(frames[0][:12 * 110])["aus"]:
            _same(T.parse_au(au, 48000), J.parse_au(au, 48000))
            n += 1
    assert n == 12
