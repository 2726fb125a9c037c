"""The port's DAB+ AAC-LC encoder against the JAX encoder in the other
configurations: 32 kHz (4 AUs per superframe), mono (an SCE), and 48 kHz
stereo with X-PAD room, a bandwidth override and the afterburner off (-A).
The f64 cases are byte-equal to JAX's through the host packer, with every
superframe valid and counted = written + 10 on every AU (see
test_torch_dabplus.py); the f32 cases agree with JAX's f32 in >= 90% of AUs
(slow: another JAX compile each)."""
import numpy as np
import pytest

from test_torch_dabplus import run_f32_case, run_f64_case

CONFIGS = {
    "32k_stereo_96": {"sample_rate": 32000, "subch": 12, "channels": 2},
    "48k_mono_64": {"sample_rate": 48000, "subch": 8, "channels": 1},
    "48k_stereo_96_pad_bw_noab": {"sample_rate": 48000, "subch": 12, "channels": 2,
                                  "pad_len": 16, "bandwidth": 10000, "afterburner": False},
}


@pytest.mark.parametrize("name", ["music", "tones"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_f64_byte_equal_to_jax(config, name):
    outs = run_f64_case(CONFIGS[config], name)
    seqs = np.concatenate([o["wseq"][0] for o in outs])
    assert 2 in seqs, "the first superframe from silence switches to short blocks"


@pytest.mark.slow
@pytest.mark.parametrize("config", list(CONFIGS))
def test_f32_agrees_with_jax(config):
    run_f32_case(CONFIGS[config])
