"""The port's CLIs on the CPU (`--compute-device cpu`): odr-audioenc's
single-stream modes (MP2 on the f64 exact path against a golden, DAB+ LC
against the port's encoder driven directly), its exit codes (EOF 0,
silence 2, input fault 5 and the -R restart count), --decode's structural
check and --profile's trace, and aacenc's ASC and LOAS against the JAX
package's writers.  The comparisons with the JAX CLI are slow (its
compiles).  Every comparison is exact unless a share is stated."""
import json

import numpy as np
import pytest
import torch

from odr_audioenc_tpu import aacenc_cli as jaacenc
from odr_audioenc_tpu_torch import aacenc_cli, cli
from odr_audioenc_tpu_torch.dabplus import model as dmodel
from odr_audioenc_tpu_torch.fec.rs import superframe_check_rs
from odr_audioenc_tpu_torch.host import dabplus_parse, mp2parse
from odr_audioenc_tpu_torch.host.aacpack import firecode_crc
from odr_audioenc_tpu_torch.io.wav import WavWriter

import gen_golden
from signals import music_like

CPU = ["--compute-device", "cpu"]
SF = 5760                     # samples per 48 kHz DAB+ superframe (LC: 6 x 960)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module on one torch thread: the suite runs several workers at once,
    and torch's default of a thread per core makes the encoders' many small
    ops wait on each other (a DAB+ superframe took 100x its time alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_wav(path, sig, rate=48000):
    w = WavWriter(str(path), rate, sig.shape[0])
    w.write(np.ascontiguousarray(sig.T).astype("<i2").tobytes())
    w.close()
    return str(path)


def superframe_ok(f):
    """RS, the firecode and validate_superframe (the AU CRCs)."""
    return (superframe_check_rs(np.frombuffer(f, np.uint8))
            and firecode_crc(f[2:11]) == (f[0] << 8 | f[1])
            and dabplus_parse.validate_superframe(f)[0])


def test_cli_mp2_matches_golden(tmp_path):
    """-a -b 128 -c 2 --dabmode j (MP2 psy 1, the f64 exact path) on the
    first 12 frames of the golden's input: the golden's bytes on the
    overlap (11 frames: the last waits for the next frame's ScF-CRC)."""
    wav = write_wav(tmp_path / "in.wav", music_like(40)[:, :12 * 1152])
    out = tmp_path / "out.mp2"
    assert cli.main(["-a", "-i", wav, "-b", "128", "-c", "2", "-r", "48000",
                     "--dabmode", "j", "-o", str(out)] + CPU) == 0
    got = out.read_bytes()
    want = (gen_golden.GOLDEN / "music_48s_128_j_psy1.mp2").read_bytes()
    assert len(got) == 11 * 384 and got == want[:len(got)]
    assert all(mp2parse.parse_frame(f)["crc_ok"] for f in mp2parse.split_frames(got))


def test_cli_dabplus_equals_encoder(tmp_path):
    """DAB+ LC 48 kHz stereo 96k over 6 superframes: every superframe
    passes RS, the firecode and validate_superframe, and the bytes are the
    port's DabPlusEncoder (f32, CPU, native host pack) driven directly on
    the same PCM."""
    sig = music_like(30, seed=3)[:, :6 * SF]
    wav = write_wav(tmp_path / "in.wav", sig)
    out = tmp_path / "out.dabp"
    assert cli.main(["-i", wav, "-b", "96", "-c", "2", "-r", "48000", "-o", str(out)]
                    + CPU) == 0
    data = out.read_bytes()
    enc = dmodel.DabPlusEncoder(dmodel.DabPlusConfig(48000, 12, 2), 1, dtype=torch.float32,
                                device="cpu")
    state, want = enc.init_state(), b""
    for t in range(6):
        state, frames = enc.encode_superframes(state, sig[None, :, t * SF:(t + 1) * SF])
        want += frames[0]
    assert data == want and len(data) == 6 * 1440
    assert all(superframe_ok(data[i:i + 1440]) for i in range(0, len(data), 1440))


@pytest.mark.parametrize("codec", ["mp2", "dabplus"])
def test_cli_silence_exit_code(tmp_path, codec):
    """-s 1 on digital silence: exit code 2 once a second of it has passed."""
    wav = write_wav(tmp_path / "in.wav", np.zeros((2, 1152 * 60), np.int16))
    args = (["-a", "-b", "128"] if codec == "mp2" else ["-b", "96"])
    assert cli.main(args + ["-i", wav, "-o", str(tmp_path / "o.bin"), "-s", "1"] + CPU) == 2


def test_cli_input_fault_exit5(tmp_path):
    """A pipeline input that emits 0.2 s of audio and dies is an input
    fault: exit code 5."""
    assert cli.main(["--gst-pipeline", "head -c 38400 /dev/zero", "-r", "48000", "-c", "2",
                     "-b", "96", "-o", str(tmp_path / "o.dabp")] + CPU) == 5


def test_cli_restart_on_fault_counts(tmp_path):
    """-R re-initialises the input after each fault; after
    MAX_FAULTS_ALLOWED spawns the encoder gives up with exit code 5."""
    marker = tmp_path / "spawns"
    assert cli.main(["--gst-pipeline", f"echo x >> {marker}; head -c 23040 /dev/zero", "-R",
                     "-r", "48000", "-c", "2", "-b", "96",
                     "-o", str(tmp_path / "o.dabp")] + CPU) == 5
    assert marker.read_text().count("x") == cli.MAX_FAULTS_ALLOWED


def test_cli_decode_validates_and_profile_traces(tmp_path):
    """--decode checks every superframe's structure (and decodes only where
    the reference decoder can be built); --profile DIR writes a Chrome
    trace of the run (here of two MP2 frames)."""
    sig = music_like(10, seed=5)
    wav = write_wav(tmp_path / "in.wav", sig[:, :2 * SF])
    out = tmp_path / "o.dabp"
    assert cli.main(["-i", wav, "-b", "96", "-o", str(out), "--decode",
                     str(tmp_path / "loop.wav")] + CPU) == 0
    data = out.read_bytes()
    assert len(data) == 2 * 1440 and all(superframe_ok(data[i:i + 1440]) for i in (0, 1440))
    wav = write_wav(tmp_path / "in2.wav", sig[:, :2 * 1152])
    assert cli.main(["-a", "-i", wav, "-o", str(tmp_path / "o.mp2"), "--profile",
                     str(tmp_path / "prof")] + CPU) == 0
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


_AUS = {}


def _port_aus(sig):
    """The AUs of the port's DabPlusEncoder (AAC-LC 48 kHz stereo 96k, f32,
    CPU) over sig, as aacenc_cli makes them."""
    if "aus" not in _AUS:
        enc = dmodel.DabPlusEncoder(dmodel.DabPlusConfig(48000, 12, 2), 1,
                                    dtype=torch.float32, device="cpu")
        state, aus = enc.init_state(), []
        for t in range(sig.shape[1] // SF):
            state, frames = enc.encode_superframes(state, sig[None, :, t * SF:(t + 1) * SF],
                                                   add_rs=False)
            aus += dabplus_parse.parse_superframe(frames[0])["aus"]
        _AUS["aus"] = aus
    return _AUS["aus"]


@pytest.mark.parametrize("raw", [False, True])
def test_aacenc_cli_equals_jax_writers(tmp_path, raw):
    """aacenc WAV -> LOAS (or --raw AUs and the .asc sidecar): the JAX
    package's loas_frame and audio_specific_config over the port encoder's
    AUs, byte for byte."""
    sig = music_like(30, seed=8)[:, :4 * SF]
    wav = write_wav(tmp_path / "in.wav", sig)
    out = tmp_path / "out.aac"
    assert aacenc_cli.main(["-r", "96000"] + (["--raw"] if raw else []) + CPU
                           + [wav, str(out)]) == 0
    aus = _port_aus(sig)
    assert len(aus) == 24
    if raw:
        assert out.read_bytes() == b"".join(aus)
        assert (tmp_path / "out.aac.asc").read_bytes() == \
            jaacenc.audio_specific_config(48000, 2)
    else:
        assert out.read_bytes() == b"".join(jaacenc.loas_frame(au, 48000, 2, first=i == 0)
                                            for i, au in enumerate(aus))
    assert aacenc_cli.audio_specific_config(32000, 1) == jaacenc.audio_specific_config(32000, 1)


@pytest.mark.slow
@pytest.mark.parametrize("codec", ["mp2", "dabplus"])
def test_cli_equals_jax_cli(tmp_path, codec):
    """The JAX CLI and the port's on the same WAV (2 s): MP2 (f64 exact
    path) byte-equal; DAB+ LC in f32: the same superframe count and length,
    and >= 90% of AUs equal (the two f32 paths sum in different orders)."""
    from odr_audioenc_tpu.cli import main as jax_main
    sig = np.tile(music_like(40, seed=6), (1, 3))[:, :96000]
    wav = write_wav(tmp_path / "in.wav", sig)
    args = ["-a", "-b", "128", "--dabmode", "j"] if codec == "mp2" else ["-b", "96"]
    assert jax_main(args + ["-i", wav, "-o", str(tmp_path / "jax.bin")]) == 0
    assert cli.main(args + ["-i", wav, "-o", str(tmp_path / "port.bin")] + CPU) == 0
    a, b = (tmp_path / "jax.bin").read_bytes(), (tmp_path / "port.bin").read_bytes()
    if codec == "mp2":
        assert a == b and len(a) > 0
        return
    assert len(a) == len(b) and len(a) % 1440 == 0 and len(a) > 0
    same = total = 0
    for i in range(0, len(a), 1440):
        ja = dabplus_parse.parse_superframe(a[i:i + 1320])["aus"]
        ta = dabplus_parse.parse_superframe(b[i:i + 1320])["aus"]
        assert len(ja) == len(ta) == 6
        same += sum(x == y for x, y in zip(ja, ta))
        total += 6
    assert same >= 0.9 * total, f"{same}/{total} AUs equal"
