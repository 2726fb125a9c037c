"""The plain reference emits toolame-dab's own bytes from the programme
(MP2), and agrees with the port, at a tiny size on the CPU: the port's
exact float64 path, driven through the timed path's own packing (device
frame pack and Mp2Packer.emit; the DAB+ device pack and slicing), emits
the bytes the reference computes from the same audio."""
import pytest
import torch

from benchmark import registry
from benchmark.traffic.programme import Programme


def cell(name, S):
    wl, cfg = registry.cell(name)
    wl = dict(wl, stations=S, programme=dict(wl["programme"], seconds=1.0))
    prog = Programme(wl, cfg["channels"], cfg["samples_per_step"], 2**31 + 99,
                     registry.module("traffic", "music").make, cfg["sample_rate"])
    return wl, cfg, prog, registry.module("reference", cfg["reference"])


# toolame-dab's streams (psy 1, 48 kHz, no X-PAD) of the frozen programme
# from its seed 1234: frames, bitrate, mode
TOOLAME = {"music_48s_128_j_psy1": (40, 128, "j"), "music_48s_192_s_psy1": (30, 192, "s")}


@pytest.mark.parametrize("name", TOOLAME)
def test_the_mp2_reference_emits_toolames_bytes(name):
    """What anchors the reference outside the port: the encoder that the
    configuration's source names, byte for byte, at two of its bitrates."""
    from benchmark.reference.convert import to_numpy
    from benchmark.reference.host.mp2pack import Mp2Packer
    from benchmark.reference.mp2.model import Mp2Encoder, make_config
    n, bitrate, mode = TOOLAME[name]
    pcm = registry.module("traffic", "music").make(n * 1152, 2, 1234)
    cfg = make_config([{"rate": 48000, "bitrate": bitrate, "mode": mode}])
    enc, packer = Mp2Encoder(cfg), Mp2Packer(cfg)
    state, chunks = enc.init_state(), []
    for f in pcm.reshape(2, n, 1152).transpose(1, 0, 2):
        state, out = enc.encode_step(state, f[None])
        chunks += packer.emit(to_numpy(out))
    chunks += packer.finish()
    want = (registry.ROOT / "reference" / "data" / f"toolame_{name}.mp2").read_bytes()
    assert b"".join(chunks) == want


@pytest.mark.parametrize("name", ["mp2_48k.music128", "mp2_48k.mux_mix"])
def test_mp2_reference_is_the_port_in_float64(name):
    from odr_audioenc_tpu_torch.host.mp2pack import Mp2Packer
    from odr_audioenc_tpu_torch.mp2.model import Mp2Encoder, make_config
    from benchmark.stations import station_specs
    S, steps = 6, 7
    wl, cfg, prog, ref = cell(name, S)
    mcfg = make_config(station_specs(cfg, wl))
    enc = Mp2Encoder(mcfg, psy_model=1, dtype=torch.float64, device="cpu",
                     pack_on_device="frame")
    packer, state = Mp2Packer(mcfg), enc.init_state()
    got = {}
    for k in range(steps):
        state, out = enc._encode_step(state, torch.as_tensor(prog.batch(k)[0]),
                                      torch.zeros(S, dtype=torch.int64))
        got.update(((k, i), b) for i, b in enumerate(packer.emit({"wire": out["wire"].numpy()})))
    keys = [(k, i) for k in range(2, steps) for i in range(S)]
    want = ref.expected(cfg, wl, prog, keys, torch.device("cpu"))
    assert all(len(want[key]) == int(mcfg.lg_frame[key[1]]) for key in keys)
    assert [key for key in keys if got[key] != want[key]] == []


def test_dabplus_reference_is_the_port_in_float64():
    from odr_audioenc_tpu_torch.dabplus.model import DabPlusConfig, DabPlusEncoder
    S, steps = 3, 4
    wl, cfg, prog, ref = cell("dabplus_lc96.music", S)
    enc = DabPlusEncoder(DabPlusConfig(48000, 12, 2, aot="lc"), n_streams=S,
                         dtype=torch.float64, device="cpu", pack_on_device=True)
    state, got = enc.init_state(), {}
    for k in range(steps):
        state, out = enc.encode_superframes(state, prog.batch(k)[0], pack=False)
        got.update(((k, i), b) for i, b in enumerate(enc.pack_superframes(out, add_rs=True)))
    keys = [(k, i) for k in (1, 3) for i in (0, 2)]
    want = ref.expected(cfg, wl, prog, keys, torch.device("cpu"))
    assert all(len(want[key]) == 12 * 120 for key in keys)
    assert [key for key in keys if got[key] != want[key]] == []


def test_the_reference_imports_nothing_of_the_port():
    import subprocess
    import sys
    code = ("import sys, benchmark.reference.mp2_stream, benchmark.reference.dabplus_stream; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'odr_audioenc_tpu_torch', 'odr_audioenc_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT.parent,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"
