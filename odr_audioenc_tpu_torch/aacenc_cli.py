"""Standalone AAC encoder CLI - the fdk-aac `aac-enc` demo equivalent
(fdk-aac/aac-enc.c:36-233) on the PyTorch port (port of
odr_audioenc_tpu/aacenc_cli.py).

WAV in -> AAC out.  The reference demo emits ADTS with 1024-sample frames;
this encoder's core is the DAB-flavoured 960-sample transform, which ADTS
cannot signal (the implied ASC has no frameLengthFlag), so the default
output is a LOAS/LATM Audio Sync Stream whose inline AudioSpecificConfig
carries frameLengthFlag=1 (960 frames) - self-describing and decodable by
standard decoders (fdk aacDecoder TT_MP4_LOAS; validated in
tests/test_misc.py).  `--raw` instead writes back-to-back raw AUs plus a
sidecar `<out>.asc` with the 2-byte AudioSpecificConfig.

Usage: python -m odr_audioenc_tpu_torch.aacenc_cli [-r bitrate] [-a 0|1]
           [--compute-device DEV] in.wav out.aac
(aot is AAC-LC; bitrate 8000..192000 rounds to the nearest DAB subchannel
multiple of 8 kbps, like the reference CLI's -b).  The encoder runs on the
card unless --compute-device names another torch device; without a card and
without that option the CLI raises.
"""
import argparse
import sys
import wave

import numpy as np
import torch

from .host.bitwriter import BitWriter

_SF_IDX = {96000: 0, 88200: 1, 64000: 2, 48000: 3, 44100: 4, 32000: 5,
           24000: 6, 22050: 7, 16000: 8, 12000: 9, 11025: 10, 8000: 11}


def audio_specific_config(rate, channels):
    """2-byte AAC-LC ASC with frameLengthFlag=1 (960 frames)."""
    bw = BitWriter()
    bw.put(2, 5)                    # audioObjectType AAC-LC
    bw.put(_SF_IDX[rate], 4)
    bw.put(channels, 4)             # channelConfiguration
    bw.put(1, 1)                    # GASpecificConfig: frameLengthFlag=960
    bw.put(0, 1)                    # dependsOnCoreCoder
    bw.put(0, 1)                    # extensionFlag
    if bw.nbits:
        bw.put(0, 8 - bw.nbits)     # byte-align
    return bw.bytes()


def _stream_mux_config(bw, rate, channels):
    bw.put(0, 1)                    # audioMuxVersion
    bw.put(1, 1)                    # allStreamsSameTimeFraming
    bw.put(0, 6)                    # numSubFrames
    bw.put(0, 4)                    # numProgram
    bw.put(0, 3)                    # numLayer
    # inline AudioSpecificConfig
    bw.put(2, 5)
    bw.put(_SF_IDX[rate], 4)
    bw.put(channels, 4)
    bw.put(1, 1)
    bw.put(0, 1)
    bw.put(0, 1)
    bw.put(0, 3)                    # frameLengthType 0 (payload length info)
    bw.put(0xFF, 8)                 # latmBufferFullness
    bw.put(0, 1)                    # otherDataPresent
    bw.put(0, 1)                    # crcCheckPresent


def loas_frame(au, rate, channels, first):
    """One LOAS AudioSyncStream frame wrapping one AU."""
    mux = BitWriter()
    mux.put(0 if first else 1, 1)   # useSameStreamMux
    if first:
        _stream_mux_config(mux, rate, channels)
    n = len(au)
    while n >= 255:                 # PayloadLengthInfo
        mux.put(255, 8)
        n -= 255
    mux.put(n, 8)
    for b in au:                    # PayloadMux
        mux.put(b, 8)
    if mux.nbits:
        mux.put(0, 8 - mux.nbits)   # byte-align the AudioMuxElement
    payload = mux.bytes()
    out = BitWriter()
    out.put(0x2B7, 11)              # syncword
    out.put(len(payload), 13)
    for b in payload:
        out.put(b, 8)
    # 11+13 header bits + payload bytes: align the sync stream
    if out.nbits:
        out.put(0, 8 - out.nbits)
    return out.bytes()


def main(argv=None):
    p = argparse.ArgumentParser(prog="aacenc",
                                description=__doc__.splitlines()[0])
    p.add_argument("-r", "--bitrate", type=int, default=64000)
    p.add_argument("-a", "--afterburner", type=int, default=1)
    p.add_argument("--raw", action="store_true",
                   help="raw AUs + .asc sidecar instead of LOAS")
    p.add_argument("--compute-device", default=None, metavar="DEV",
                   help="torch device of the encoder (default: the CUDA card; "
                        "'cpu' runs it on the CPU)")
    p.add_argument("infile")
    p.add_argument("outfile")
    args = p.parse_args(argv)
    from .cli import compute_device
    device = compute_device(args.compute_device)

    with wave.open(args.infile, "rb") as w:
        if w.getsampwidth() != 2:
            sys.exit(f"Unsupported WAV sample depth {8 * w.getsampwidth()}")
        channels = w.getnchannels()
        rate = w.getframerate()
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    if channels not in (1, 2):
        sys.exit(f"Unsupported WAV channels {channels}")
    if rate not in (32000, 48000):
        sys.exit(f"Unsupported sample rate {rate} (DAB+ core: 32000/48000)")
    pcm = pcm.reshape(-1, channels).T

    from .dabplus.model import DabPlusEncoder, DabPlusConfig
    from .host import dabplus_parse
    subch = max(1, min(24, round(args.bitrate / 8000)))
    cfg = DabPlusConfig(rate, subch, channels, aot="lc",
                        afterburner=bool(args.afterburner))
    enc = DabPlusEncoder(cfg, 1, dtype=torch.float32, device=device)
    state = enc.init_state()
    spf = cfg.num_aus * cfg.au_samples
    n_sf = pcm.shape[1] // spf
    aus = []
    for i in range(n_sf):
        state, frames = enc.encode_superframes(
            state, pcm[None, :, i * spf:(i + 1) * spf], add_rs=False)
        aus.extend(dabplus_parse.parse_superframe(frames[0])["aus"])

    with open(args.outfile, "wb") as f:
        if args.raw:
            for au in aus:
                f.write(au)
            with open(args.outfile + ".asc", "wb") as fa:
                fa.write(audio_specific_config(rate, channels))
        else:
            for i, au in enumerate(aus):
                f.write(loas_frame(au, rate, channels, first=(i == 0)))
    print(f"{len(aus)} AUs ({n_sf} superframes) -> {args.outfile}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
