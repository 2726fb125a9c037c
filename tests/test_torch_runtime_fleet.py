"""The port's run_fleet on the CPU, on one thread (as dryrun_multichip
compares: with more, float reductions split by batch size): a 7-station
mixed fleet (3 MP2 stations at three rates and modes, two DAB+ LC, one
HE-AAC, one HE-AAC v2) writes for every station the bytes of the port's
encoders driven directly in the same grouping, chunked or not; a miniature
of tests/test_cli.py's 64-station sinks test (EDI AF and PF, ZMQ, PAD,
stats); and, slow, the JAX package's run_fleet against the port's.  Every
comparison is exact unless a share is stated."""
import json
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from odr_audioenc_tpu_torch import convert, fleet
from odr_audioenc_tpu_torch.dabplus import model as dmodel
from odr_audioenc_tpu_torch.fec.rs import superframe_check_rs
from odr_audioenc_tpu_torch.host import dabplus_parse, mp2parse
from odr_audioenc_tpu_torch.host.aacpack import firecode_crc
from odr_audioenc_tpu_torch.host.mp2pack import Mp2Packer
from odr_audioenc_tpu_torch.io.wav import WavWriter
from odr_audioenc_tpu_torch.mp2 import model
from odr_audioenc_tpu_torch.outputs.edi_out import crc16_genibus
from odr_audioenc_tpu_torch.outputs.zmq_out import _command, _greeting, _metadata

from signals import music_like
from torch_cpu import one_torch_thread  # noqa: F401

MIXED = [{"codec": "mp2", "bitrate": 128, "mode": "j"},
         {"codec": "mp2", "bitrate": 192, "mode": "s"},
         {"codec": "mp2", "bitrate": 96, "mode": "m", "channels": 1},
         {"codec": "dabplus", "bitrate": 96, "channels": 2},
         {"codec": "dabplus", "bitrate": 96, "channels": 2},
         {"codec": "dabplus", "bitrate": 48, "channels": 1},     # auto: HE-AAC
         {"codec": "dabplus", "bitrate": 32, "channels": 2}]     # auto: HE-AAC v2
# the grouping run_fleet makes of MIXED: MP2 by rate; DAB+ by (rate,
# bitrate, channels, pad_len, aot)
GROUPS = [("mp2", [0, 1, 2], None), ("dabplus", [3, 4], dmodel.DabPlusConfig(48000, 12, 2)),
          ("dabplus", [5], dmodel.DabPlusConfig(48000, 6, 1, aot="sbr")),
          ("dabplus", [6], dmodel.DabPlusConfig(48000, 4, 2, aot="ps"))]
N_SAMPLES = 30 * 1152                    # 0.72 s per station
CHUNK_S = 0.24                           # k = 10 MP2 frames, 2 DAB+ superframes


def write_wav(path, sig, rate=48000):
    w = WavWriter(str(path), rate, sig.shape[0])
    w.write(np.ascontiguousarray(sig.T).astype("<i2").tobytes())
    w.close()
    return str(path)


def superframe_ok(f):
    return (superframe_check_rs(np.frombuffer(f, np.uint8))
            and firecode_crc(f[2:11]) == (f[0] << 8 | f[1])
            and dabplus_parse.validate_superframe(f)[0])


def _signals():
    return [music_like(30, seed=100 + i)[:s.get("channels", 2)] for i, s in enumerate(MIXED)]


def _run_mixed(d, chunk_s, stats_path=None):
    """run_fleet over MIXED with inputs and outputs in d; returns the
    stations' output bytes."""
    streams = []
    for i, (spec, sig) in enumerate(zip(MIXED, _signals())):
        streams.append({**spec, "rate": 48000, "input": write_wav(d / f"in{i}.wav", sig),
                        "output": str(d / f"out{i}_{chunk_s}.bin"),
                        **({"stats": stats_path} if stats_path and i == 0 else {})})
    fleet.run_fleet({"streams": streams, "chunk_seconds": chunk_s}, device="cpu")
    return [(d / f"out{i}_{chunk_s}.bin").read_bytes() for i in range(len(MIXED))]


@pytest.fixture(scope="module")
def chunked(tmp_path_factory):
    """The chunked run (k = 10 / 2) and the stats datagrams it sent."""
    d = tmp_path_factory.mktemp("fleet")
    rx = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
    rx.bind(str(d / "stats.sock"))
    rx.settimeout(1.0)
    outs = _run_mixed(d, CHUNK_S, str(d / "stats.sock"))
    msgs = []
    try:
        while True:
            msgs.append(rx.recv(4096))
    except socket.timeout:
        pass
    rx.close()
    return d, outs, msgs, dict(fleet.last_run)


def _direct(steps_of):
    """Each group's encoder driven directly (f32, CPU; MP2 frame pack
    through Mp2Packer.emit, which the fleet never finishes; DAB+ with the
    device pack) over its stations' PCM, zero-padded to the fleet's step
    count: steps_of(frame samples) -> steps.  Returns bytes per station."""
    sigs = _signals()
    out = [b""] * len(MIXED)
    for kind, idx, dcfg in GROUPS:
        if kind == "mp2":
            n = steps_of(1152)
            cfg = model.make_config([{"rate": 48000, "bitrate": MIXED[i]["bitrate"],
                                      "mode": MIXED[i]["mode"]} for i in idx])
            enc = model.Mp2Encoder(cfg, psy_model=1, dtype=torch.float32, device="cpu",
                                   pack_on_device="frame")
            packer = Mp2Packer(cfg)
            pcm = np.zeros((len(idx), 2, n * 1152), np.int16)
            for j, i in enumerate(idx):
                pcm[j, :, :N_SAMPLES] = sigs[i]          # mono: the channel twice
            state = enc.init_state()
            for t in range(n):
                state, o = enc.encode_step(state, pcm[..., t * 1152:(t + 1) * 1152])
                for j, b in enumerate(packer.emit(convert.to_numpy(o))):
                    out[idx[j]] += b
        else:
            spf = dcfg.num_aus * dcfg.au_samples
            n = steps_of(spf)
            enc = dmodel.DabPlusEncoder(dcfg, len(idx), dtype=torch.float32, device="cpu",
                                        pack_on_device=True)
            pcm = np.zeros((len(idx), dcfg.channels, n * spf), np.int16)
            for j, i in enumerate(idx):
                pcm[j, :, :N_SAMPLES] = sigs[i]
            state = enc.init_state()
            for t in range(n):
                state, frames = enc.encode_superframes(state, pcm[..., t * spf:(t + 1) * spf])
                for j, f in enumerate(frames):
                    out[idx[j]] += f
    return out


def _fleet_steps(frame, chunk_s):
    """Steps of a group: ceil(N / chunk) reads, then the pass that meets
    EOF (its chunk zero-filled), k frames each."""
    k = max(1, int(round(chunk_s * 48000 / frame)))
    return (-(-N_SAMPLES // (k * frame)) + 1) * k


def test_fleet_equals_direct_encoders(chunked):
    """Every station's file is the bytes of its group's encoder driven
    directly; DAB+ superframes pass RS, the firecode and the AU CRCs, MP2
    frames their CRCs; the stats datagrams arrive as JSON."""
    _, outs, msgs, run = chunked
    want = _direct(lambda frame: _fleet_steps(frame, CHUNK_S))
    for i, (a, b) in enumerate(zip(outs, want)):
        assert len(a) > 0 and a == b, f"station {i}"
    for i, spec in enumerate(MIXED):
        if spec["codec"] == "dabplus":
            n = 120 * spec["bitrate"] // 8
            assert len(outs[i]) % n == 0
            assert all(superframe_ok(outs[i][j:j + n]) for j in range(0, len(outs[i]), n))
        else:
            frames = mp2parse.split_frames(outs[i])
            assert frames and all(mp2parse.parse_frame(f)["crc_ok"] for f in frames)
    assert [g["k"] for g in run["groups"]] == [10, 2, 2, 2] and run["device"] == "cpu"
    assert msgs and "audiolevels" in json.loads(msgs[0].decode())


def test_fleet_chunked_equals_unchunked(chunked, tmp_path):
    """chunk_seconds 0 (k = 1: one device step per pass) writes the chunked
    run's bytes, up to the chunked run's zero-filled tail (its last pass
    encodes a whole chunk of silence)."""
    _, outs, _, _ = chunked
    flat = _run_mixed(tmp_path, 0.0)
    assert [g["k"] for g in fleet.last_run["groups"]] == [1, 1, 1, 1]
    for i, (a, b) in enumerate(zip(outs, flat)):
        assert len(b) > 0 and len(a) >= len(b) and a[:len(b)] == b, f"station {i}"


# ---- the sinks: a miniature of tests/test_cli.py::test_fleet_edi_zmq_pad_64 ----------


def _zmtp_sub_listener(got):
    """A ZMTP 3.0 NULL SUB peer (the ODR-DabMux role): accept one PUB
    connection and collect the message payloads."""
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

    def read_frame(s):
        flags = recv_exact(s, 1)[0]
        size = struct.unpack(">Q", recv_exact(s, 8))[0] if flags & 2 else recv_exact(s, 1)[0]
        return flags, recv_exact(s, size)

    def run():
        s, _ = lsock.accept()
        s.settimeout(60.0)
        s.sendall(_greeting("NULL", False))
        recv_exact(s, 64)
        s.sendall(_command("READY", _metadata({"Socket-Type": "SUB"})))
        read_frame(s)
        try:
            while True:
                flags, payload = read_frame(s)
                if not flags & 0x04:
                    got.append(payload)
        except (socket.timeout, ConnectionError, OSError):
            pass
        lsock.close()

    threading.Thread(target=run, daemon=True).start()
    return lsock.getsockname()[1]


def _pad_server(ident, payload):
    """ODR-PadEnc stand-in: answer each MESSAGE_REQUEST on
    /tmp/{ident}.padenc with MESSAGE_PAD_DATA."""
    path = f"/tmp/{ident}.padenc"
    if os.path.exists(path):
        os.unlink(path)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
    srv.bind(path)
    srv.settimeout(30.0)

    def run():
        while True:
            try:
                buf = srv.recvfrom(64)[0]
            except (socket.timeout, OSError):
                return
            if buf and buf[0] == 1:
                try:
                    srv.sendto(bytes([2]) + payload[:buf[1]] + bytes([14]),
                               f"/tmp/{ident}.audioenc")
                except OSError:
                    pass

    threading.Thread(target=run, daemon=True).start()
    return srv, path


def test_fleet_sinks_miniature(tmp_path):
    """8 stations (4 MP2 128k joint stereo, 4 DAB+ LC 96k), each with a file
    sink: every other one an EDI destination (AF, or PFT with FEC on every
    4th), one ZMQ subscriber and one PAD-fed station per codec.  EDI AF and
    PF header CRCs are valid and each plain-AF DAB+ station sends 5 AF
    packets per superframe; the ZMQ messages carry the ODR header; the
    PAD-fed stations' frames are valid."""
    n_mp2, n = 4, 8
    wav_mp2 = write_wav(tmp_path / "mp2.wav", music_like(12, seed=42))
    wav_dab = write_wav(tmp_path / "dab.wav", music_like(15, seed=43))
    streams, edi_rx, zmq_got, pads = [], {}, {}, []
    for i in range(n):
        spec = ({"codec": "dabplus", "bitrate": 96, "channels": 2, "input": wav_dab}
                if i >= n_mp2 else {"codec": "mp2", "bitrate": 128, "mode": "j",
                                    "input": wav_mp2})
        spec.update(rate=48000, output=str(tmp_path / f"out{i}.bin"))
        if i % 2 == 0:
            rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            rx.bind(("127.0.0.1", 0))
            rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 20)
            edi_rx[i] = rx
            spec.update(edi=[f"udp://127.0.0.1:{rx.getsockname()[1]}"], edi_tai_offset=37)
            if i % 4 == 0:
                spec["edi_fec"] = 2
        streams.append(spec)
    for i in (1, n_mp2 + 1):
        zmq_got[i] = []
        streams[i]["zmq"] = f"tcp://127.0.0.1:{_zmtp_sub_listener(zmq_got[i])}"
    payload = bytes(range(2, 16)) + bytes([0, 0])
    for i in (2, n_mp2 + 2):
        ident = f"torchfleetpad_{i}_{os.getpid()}"
        pads.append(_pad_server(ident, payload))
        streams[i].update(pad=ident, pad_len=16)
    conf = tmp_path / "fleet.json"
    conf.write_text(json.dumps({"streams": streams, "chunk_seconds": CHUNK_S}))
    from odr_audioenc_tpu_torch.cli import main
    assert main(["--streams", str(conf), "--compute-device", "cpu"]) == 0
    assert [(g["key"][0], g["streams"], g["k"]) for g in fleet.last_run["groups"]] == \
        [("mp2", 4, 1), ("dabplus", 3, 2), ("dabplus", 1, 1)]

    n_sf = {}
    for i in range(n):
        data = (tmp_path / f"out{i}.bin").read_bytes()
        if i >= n_mp2:
            assert len(data) % 1440 == 0 and len(data) >= 3 * 1440
            assert all(superframe_ok(data[j:j + 1440]) for j in range(0, len(data), 1440))
            n_sf[i] = len(data) // 1440
        else:
            frames = mp2parse.split_frames(data)
            assert len(frames) >= 11 and all(mp2parse.parse_frame(f)["crc_ok"] for f in frames)
    for i, rx in edi_rx.items():
        rx.settimeout(1.0)
        pkts = []
        try:
            while True:
                pkts.append(rx.recv(4096))
        except socket.timeout:
            pass
        rx.close()
        assert pkts, f"station {i}: no EDI packets"
        n_af = 0
        for p in pkts:
            if p[:2] == b"PF":
                assert crc16_genibus(p[:14]) == int.from_bytes(p[14:16], "big")
            else:
                assert p[:2] == b"AF"
                taglen = int.from_bytes(p[2:6], "big")
                assert crc16_genibus(p[:10 + taglen]) == \
                    int.from_bytes(p[10 + taglen:12 + taglen], "big")
                n_af += 1
        if i >= n_mp2 and i % 4 != 0:
            assert n_af == 5 * n_sf[i]
    for _ in range(50):
        if all(zmq_got.values()):
            break
        time.sleep(0.1)
    for i, got in zmq_got.items():
        assert got, f"station {i}: no ZMQ messages"
        ver, enc_t, size, _, _ = struct.unpack("<HHIhh", got[0][:12])
        assert (ver, enc_t, size) == (1, 1 if i >= n_mp2 else 2, len(got[0]) - 12)
    for srv, path in pads:
        srv.close()
        os.unlink(path)


@pytest.mark.slow
def test_fleet_equals_jax_fleet(tmp_path):
    """The JAX package's run_fleet and the port's over an MP2 + LC fleet
    (4 MP2 stations at 128/192/96/160k, 2 DAB+ LC 96k; 2 s): the same file
    sizes, >= 90% of the MP2 frames that carry the input's audio byte-equal
    and >= 90% of DAB+ AUs equal (both are f32 paths, with other
    transcendentals and summation orders).  The zero-filled chunk after the
    input's end is only checked for valid CRCs: on digital silence the two
    SMRs differ in their last bits, and at 160k stereo the allocator's
    near-ties there go the other way in one subband on every frame."""
    from odr_audioenc_tpu.fleet import run_fleet as jax_run_fleet
    sig = np.tile(music_like(40, seed=7), (1, 3))[:, :96000]
    wav = write_wav(tmp_path / "in.wav", sig)
    specs = [{"codec": "mp2", "bitrate": b, "mode": "js"[i % 2]}
             for i, b in enumerate((128, 192, 96, 160))]
    specs += [{"codec": "dabplus", "bitrate": 96, "channels": 2}] * 2
    outs = []
    for name, run in (("jax", jax_run_fleet),
                      ("port", lambda c: fleet.run_fleet(c, device="cpu"))):
        run({"streams": [{**s, "rate": 48000, "input": wav,
                          "output": str(tmp_path / f"{name}{i}.bin")}
                         for i, s in enumerate(specs)]})
        outs.append([(tmp_path / f"{name}{i}.bin").read_bytes() for i in range(len(specs))])
    same = total = 0
    audio_frames = -(-sig.shape[1] // 1152)
    for i, (a, b) in enumerate(zip(*outs)):
        assert len(a) == len(b) > 0, f"station {i}"
        if i < 4:
            fa, fb = mp2parse.split_frames(a), mp2parse.split_frames(b)
            assert all(mp2parse.parse_frame(f)["crc_ok"] for f in fb)
            same += sum(x == y for x, y in zip(fa[:audio_frames], fb[:audio_frames]))
            total += audio_frames
    assert same >= 0.9 * total, f"MP2: {same}/{total} frames equal"
    same = total = 0
    for a, b in zip(*(o[4:] for o in outs)):
        for j in range(0, len(a), 1440):
            ja = dabplus_parse.parse_superframe(a[j:j + 1320])["aus"]
            ta = dabplus_parse.parse_superframe(b[j:j + 1320])["aus"]
            same += sum(x == y for x, y in zip(ja, ta))
            total += len(ja)
    assert same >= 0.9 * total, f"DAB+: {same}/{total} AUs equal"
