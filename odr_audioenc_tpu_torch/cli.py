"""odr-audioenc-compatible CLI on the PyTorch port's batched encoders (port
of odr_audioenc_tpu/cli.py).

Single-stream mode mirrors the reference tool's options (odr-audioenc.cpp:
1379-1642) and exit codes (0=EOF, 1=error, 2=silence, 3=encoder, 4=send,
5=input fault).  The additional --streams mode runs a whole fleet of stations
as one device batch (the framework's north-star operating point).

The encoders run on the card unless --compute-device names another torch
device (`cpu` for the tests); without a card and without that option the
CLI raises.  (-d/--device is the ALSA capture device, as in the reference.)

Inputs follow the reference's selection priority (initialise_input,
odr-audioenc.cpp:1338-1377): file/stdin, JACK (gated: needs libjack), VLC-
style URI ingest, GStreamer-style pipeline, ALSA capture — the live ones
via an external-decoder subprocess (io/inputs.py).  All push into a
SampleQueue; the loop pops with drift compensation (pop + sample expansion)
or blocking pop_wait with a 10 s fault timeout (odr-audioenc.cpp:860-985).
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# reference: "Due to memory leaks in the VLC input, we don't want to
# restart it endlessly." (odr-audioenc.cpp:94-96)
MAX_FAULTS_ALLOWED = 5


def make_argparser():
    p = argparse.ArgumentParser(prog="odr-audioenc-tpu", add_help=True)
    p.add_argument("-i", "--input", default=None)
    p.add_argument("-f", "--format", choices=["wav", "raw"], default="wav")
    p.add_argument("--fifo-silence", action="store_true")
    p.add_argument("-d", "--device", default=None,
                   help="ALSA input device (capture via arecord/ffmpeg)")
    p.add_argument("-j", "--jack", default=None,
                   help="JACK input client name (needs libjack; gated)")
    p.add_argument("-v", "--vlc-uri", default=None,
                   help="any-URI live ingest (reference: libVLC; here ffmpeg)")
    p.add_argument("-C", "--vlc-cache", type=int, default=0,
                   help="network cache length in ms")
    p.add_argument("-L", "--vlc-opt", action="append", default=[],
                   help="additional decoder option (can be given repeatedly)")
    p.add_argument("-G", "--gst-uri", default=None)
    p.add_argument("--gst-pipeline", default=None,
                   help="shell pipeline emitting s16le PCM on stdout")
    p.add_argument("-w", "--write-icy-text", default=None, metavar="FILE")
    p.add_argument("-W", "--write-icy-text-dl-plus", action="store_true")
    p.add_argument("-a", "--dab", action="store_true", help="encode DAB MP2")
    p.add_argument("--aaclc", action="store_true")
    p.add_argument("--sbr", action="store_true")
    p.add_argument("--ps", action="store_true")
    p.add_argument("-A", "--no-afterburner", action="store_true")
    p.add_argument("-b", "--bitrate", type=int, default=96)
    p.add_argument("-B", "--bandwidth", type=int, default=0)
    p.add_argument("-c", "--channels", type=int, default=2)
    p.add_argument("-r", "--rate", type=int, default=48000)
    p.add_argument("--dabmode", choices=["s", "d", "j", "m"], default="j")
    p.add_argument("--dabpsy", type=int, default=1)
    p.add_argument("-o", "--output", action="append", default=[])
    p.add_argument("-e", "--edi", action="append", default=[])
    p.add_argument("--fec", type=int, default=0)
    p.add_argument("-T", "--timestamp-delay", type=int, default=None)
    p.add_argument("-k", "--secret-key", default=None)
    p.add_argument("-p", "--pad", type=int, default=128)
    p.add_argument("-P", "--pad-socket", default="")
    p.add_argument("-s", "--silence", type=int, default=0)
    p.add_argument("-S", "--stats", default=None)
    p.add_argument("-g", "--audio-gain", type=float, default=0.0)
    # v3 backward-compat alias (odr-audioenc.cpp:1385,1554: deprecation
    # warning, then the same dB gain)
    p.add_argument("--vlc-gain", type=float, default=None)
    p.add_argument("--edi-verbose", action="store_true")
    p.add_argument("-D", "--drift-comp", action="store_true")
    p.add_argument("-l", "--level", action="store_true")
    p.add_argument("-R", "--restart-on-fault", action="store_true")
    p.add_argument("--startup-check", default="")
    p.add_argument("--decode", default=None)
    p.add_argument("--identifier", default="")
    p.add_argument("-V", "--verbose", action="count", default=0)
    p.add_argument("--streams", default=None,
                   help="JSON config for batched multi-stream operation")
    p.add_argument("--syslog", action="store_true",
                   help="log to syslog (LogToSyslog backend)")
    p.add_argument("--logfile", default=None,
                   help="append log lines to a file (LogToFile backend)")
    p.add_argument("--tracefile", default=None,
                   help="microsecond event trace output (LogTracer backend)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the encode loop "
                        "into DIR/trace.json (Chrome trace format)")
    p.add_argument("--compute-device", default=None, metavar="DEV",
                   help="torch device of the encoders (default: the CUDA card; "
                        "'cpu' runs them on the CPU)")
    return p


def compute_device(name):
    """The encoders' torch device: `name`, or the card (raises where there
    is none)."""
    if name is not None:
        return torch.device(name)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --compute-device cpu to run the "
                           "encoders on the CPU")
    return torch.device("cuda")


def initialise_input(args, queue):
    """Build + prepare the selected input (odr-audioenc.cpp:1338-1377,
    same priority order).  Raises RuntimeError on failure so the caller's
    restart-on-fault logic can count it."""
    from .io import inputs as I
    if args.input is not None:
        inp = I.FileInput(queue, args.input, args.format == "raw", args.rate,
                          args.channels, args.fifo_silence)
    elif args.jack is not None:
        inp = I.JackInput(queue, args.jack, args.rate, args.channels)
    elif args.vlc_uri is not None:
        inp = I.VLCInput(queue, args.vlc_uri, args.rate, args.channels,
                         cache_ms=args.vlc_cache)
    elif args.gst_uri is not None or args.gst_pipeline is not None:
        inp = I.GSTInput(queue, args.gst_uri, args.rate, args.channels,
                         pipeline=args.gst_pipeline)
    elif args.device is not None:
        inp = I.AlsaInput(queue, args.device, args.rate, args.channels)
    else:
        inp = I.FileInput(queue, "-", args.format == "raw", args.rate,
                          args.channels, args.fifo_silence)
    inp.prepare()
    return inp


def build_outputs(args, is_dabplus):
    from .outputs import FileOutput, ZmqOutput, EdiOutput
    from .outputs.edi_out import EdiConfig, EdiDestination
    file_out, zmq_out, edi_out = None, None, None
    for uri in args.output:
        if uri.startswith(("tcp://", "ipc://", "pgm://", "epgm://")):
            if zmq_out is None:
                zmq_out = ZmqOutput(uri, args.secret_key)
                zmq_out.set_encoder_type(is_dabplus)
        else:
            if file_out is not None:
                raise SystemExit("You can't write to more than one file!")
            file_out = FileOutput(uri)
    if args.edi:
        dests = []
        for uri in args.edi:
            proto, rest = uri.split("://", 1)
            host, port = rest.rsplit(":", 1)
            dests.append(EdiDestination(proto, host, int(port)))
        conf = EdiConfig(enable_pft=args.fec > 0, fec=args.fec,
                         destinations=dests,
                         verbose=getattr(args, "edi_verbose", False))
        edi_out = EdiOutput(conf, tist=args.timestamp_delay is not None,
                            delay_ms=args.timestamp_delay or 0)
    if not (file_out or zmq_out or edi_out):
        raise SystemExit("No output defined")
    return file_out, zmq_out, edi_out


def send_frame(outs, buf, peak_l, peak_r, is_dabplus):
    file_out, zmq_out, edi_out = outs
    ok = True
    if file_out:
        file_out.update_audio_levels(peak_l, peak_r)
        return file_out.write_frame(buf)
    if zmq_out:
        zmq_out.update_audio_levels(peak_l, peak_r)
        ok &= zmq_out.write_frame(buf)
    if edi_out:
        edi_out.update_audio_levels(peak_l, peak_r)
        if is_dabplus:
            assert len(buf) % 5 == 0
            bs = len(buf) // 5
            for i in range(5):
                ok &= edi_out.write_frame(buf[i * bs:(i + 1) * bs])
        else:
            ok &= edi_out.write_frame(buf)
    return ok


def run_single(args, device):
    from . import convert
    from .io.queue import SampleQueue
    from .io.drift import expand_missing_samples
    from .host.sidecars import (PadInterface, StatsPublisher, level,
                                write_icy_to_file)

    is_dabplus = not args.dab
    channels = args.channels

    if is_dabplus:
        if args.rate not in (32000, 48000):
            raise SystemExit("Invalid sample rate. Possible values are: 32000, 48000.")
        if not 8 <= args.bitrate <= 192 or args.bitrate % 8:
            raise SystemExit("Invalid bitrate for DAB+ (8..192, multiple of 8)")
        from .dabplus.model import DabPlusEncoder, DabPlusConfig
        subch = args.bitrate // 8
        # AOT auto-selection by bitrate (prepare_aac_encoder,
        # odr-audioenc.cpp:249-261)
        if args.aaclc:
            aot = "lc"
        elif args.ps:
            aot = "ps"
        elif args.sbr:
            aot = "sbr"
        elif channels == 2 and subch <= 6:
            aot = "ps"
        elif (channels == 1 and subch <= 8) or (channels == 2 and subch <= 10):
            aot = "sbr"
        else:
            aot = "lc"
        cfg = DabPlusConfig(args.rate, subch, channels, aot=aot,
                            pad_len=args.pad if args.pad_socket else 0,
                            bandwidth=args.bandwidth,
                            afterburner=not args.no_afterburner)
        enc = DabPlusEncoder(cfg, 1, dtype=torch.float32, device=device)
        frame_samples = cfg.num_aus * cfg.au_samples  # 120 ms at full rate
        frame_dur = frame_samples / args.rate
    else:
        if args.rate not in (24000, 48000):
            raise SystemExit("Invalid sample rate. Possible values are: 24000, 48000.")
        from .mp2.model import Mp2Encoder, make_config
        from .host.mp2pack import Mp2Packer
        mode = args.dabmode if channels == 2 else "m"
        padlen = args.pad if args.pad_socket else 0
        cfg = make_config([{"rate": args.rate, "bitrate": args.bitrate,
                            "mode": mode, "pad_len": padlen}])
        enc = Mp2Encoder(cfg, psy_model=args.dabpsy, dtype=torch.float64, device=device)
        packer = Mp2Packer(cfg)
        frame_samples = 1152
        frame_dur = 1152 / args.rate

    outs = build_outputs(args, is_dabplus)
    pad_intf = PadInterface()
    padlen = args.pad if args.pad_socket else 0
    if padlen:
        pad_intf.open(args.pad_socket)
        print("PAD socket opened", file=sys.stderr)
    stats = StatsPublisher(args.stats) if args.stats else None

    decoder = None
    wav_out = None
    if args.decode:
        if not is_dabplus:
            raise SystemExit("--decode is only supported for DAB+")
        from .host.dabplus_parse import validate_superframe
        # loopback decode via the reference-decoder oracle when available;
        # structural validation (firecode/AU-CRC/RS) always runs
        try:
            import importlib.util as ilu
            from pathlib import Path
            spec = ilu.spec_from_file_location(
                "fdk_ref", Path(__file__).resolve().parent.parent / "tools" / "fdk_ref.py")
            fdk_ref = ilu.module_from_spec(spec)
            spec.loader.exec_module(fdk_ref)
            decoder = fdk_ref.FdkDecoder()
        except Exception as e:  # noqa: BLE001
            print(f"--decode: full decode unavailable ({e}); structural "
                  f"validation only", file=sys.stderr)

    state = enc.init_state()
    if args.vlc_gain is not None:
        print("WARNING: the --vlc-gain option has been deprecated in "
              "favour of --audio-gain", file=sys.stderr)
        args.audio_gain = args.vlc_gain
    gain = 10.0 ** (args.audio_gain / 20.0)
    frame_bytes = frame_samples * channels * 2

    # the single hand-off point between input thread(s) and this loop
    # (SampleQueue.configure, odr-audioenc.cpp:761-766)
    queue = SampleQueue()
    queue.configure(32 * frame_bytes + 20 * channels,
                    push_block=not args.drift_comp, channels=channels)
    inp = initialise_input(args, queue)
    fault_counter = 0
    previous_icy = None
    t_comp = time.monotonic()          # drift_compensation_delay accumulator
    t_last_sample = time.monotonic()   # 60 s underrun abort clock

    mp2_fifo = b""
    silence_ms = 0
    send_errors = 0

    num_aus = getattr(enc, "cfg", None).num_aus if is_dabplus else 1

    while True:
        xpad = b""
        calculated_padlen = 0
        dab_pads = []
        if padlen:
            # the reference requests PAD once per encoder call:
            # num_aus times per DAB+ superframe, once per MP2 frame
            for _ in range(num_aus):
                pad_data = pad_intf.request(padlen)
                if len(pad_data) == padlen + 1:
                    calculated_padlen = pad_data[padlen]
                    if calculated_padlen < 2:
                        raise SystemExit(1)
                    xpad = pad_data[:padlen]
                    # AAC: skip PAD if only zero F-PAD (TS 102 563 5.4.3)
                    if is_dabplus and calculated_padlen == 2 and \
                            xpad[padlen - 2] == 0 and xpad[padlen - 1] == 0:
                        calculated_padlen = 0
                    dab_pads.append(xpad[padlen - calculated_padlen:]
                                    if calculated_padlen else b"")
                else:
                    dab_pads.append(b"")
                    calculated_padlen = 0

        # ------- fault poll + restart (odr-audioenc.cpp:875-902)
        if inp.fault_detected():
            print("Detected fault in input!", file=sys.stderr)
            if args.restart_on_fault:
                fault_counter += 1
                if fault_counter >= MAX_FAULTS_ALLOWED:
                    print("Maximum number of input faults reached, aborting",
                          file=sys.stderr)
                    retval = 5
                    break
                try:
                    inp.close()
                    inp = initialise_input(args, queue)
                except RuntimeError as e:
                    print(f"Initialising input triggered exception: {e}",
                          file=sys.stderr)
                    retval = 5
                    break
                continue
            retval = 5
            break

        if not inp.read_source(frame_bytes):
            print("End of input reached", file=sys.stderr)
            retval = 0
            break

        # ------- queue pop: drift-compensated or blocking
        # (odr-audioenc.cpp:904-985)
        if args.drift_comp:
            buf, valid_bytes, overruns = queue.pop(frame_bytes)
            if valid_bytes != frame_bytes:
                b = bytearray(buf)
                expand_missing_samples(b, channels, valid_bytes)
                buf = bytes(b)
            # throttle to nominal encode rate (drift_compensation_delay,
            # odr-audioenc.cpp:378-396)
            t_comp += frame_dur
            now = time.monotonic()
            if now < t_comp:
                time.sleep(t_comp - now)
            if valid_bytes != frame_bytes:
                if stats:
                    stats.notify_underrun()
                if time.monotonic() - t_last_sample > 60:
                    print("Underruns for 60s, aborting!", file=sys.stderr)
                    return 1
            else:
                t_last_sample = time.monotonic()
            if overruns and stats:
                stats.notify_overrun()
        else:
            buf, overruns = queue.pop_wait(frame_bytes, 10000)
            if len(buf) < frame_bytes:
                # queue timeout (odr-audioenc.cpp:958-985)
                print("Detected fault in input! No data in time.",
                      file=sys.stderr)
                if args.restart_on_fault:
                    fault_counter += 1
                    if fault_counter >= MAX_FAULTS_ALLOWED:
                        print("Maximum number of input faults reached, "
                              "aborting", file=sys.stderr)
                        retval = 5
                        break
                    try:
                        inp.close()
                        inp = initialise_input(args, queue)
                    except RuntimeError as e:
                        print(f"Initialising input triggered exception: {e}",
                              file=sys.stderr)
                        return 1
                    continue
                retval = 5
                break

        # ------- ICY metadata → file for ODR-PadEnc
        # (odr-audioenc.cpp:995-1020)
        if args.write_icy_text and hasattr(inp, "get_icy_text"):
            text = inp.get_icy_text()
            if text != previous_icy:
                if not write_icy_to_file(text, args.write_icy_text,
                                         args.write_icy_text_dl_plus):
                    print("Failed to write ICY Text", file=sys.stderr)
            previous_icy = text

        pcm = np.frombuffer(buf, np.int16).reshape(-1, channels).T
        if gain != 1.0:
            pcm = np.clip(pcm.astype(np.float64) * gain, -32768, 32767).astype(np.int16)
        peak_l = int(pcm[0].max(initial=0))
        peak_r = int(pcm[1].max(initial=0)) if channels == 2 else peak_l
        if stats:
            stats.update_audio_levels(peak_l, peak_r)

        if args.silence and max(peak_l, peak_r) == 0:
            silence_ms += frame_dur * 1000
            if silence_ms > 1000 * args.silence:
                print(f"Silence detected for {args.silence} seconds, aborting.",
                      file=sys.stderr)
                retval = 2
                break
        else:
            silence_ms = 0

        if is_dabplus:
            pcm2 = pcm if channels == 2 else pcm
            pads = [dab_pads] if padlen and any(dab_pads) else None
            state, frames = enc.encode_superframes(state, pcm2[None], pads=pads)
            out_bytes = frames[0]
            if args.decode:
                from .host.dabplus_parse import validate_superframe
                ok_sf, _ = validate_superframe(out_bytes)
                if not ok_sf:
                    raise SystemExit("Decoding failed: superframe invalid")
                if decoder is not None:
                    dec_pcm = decoder.decode_superframe(
                        out_bytes[: len(out_bytes) // 120 * 110])
                    if wav_out is None:
                        from .io.wav import WavWriter
                        wav_out = WavWriter(args.decode, decoder.sample_rate,
                                            decoder.channels)
                    inter = np.empty(dec_pcm.size, np.int16)
                    for c in range(dec_pcm.shape[0]):
                        inter[c::dec_pcm.shape[0]] = dec_pcm[c]
                    wav_out.write(inter.tobytes())
            ok = send_frame(outs, out_bytes, peak_l, peak_r, True)
            if not ok:
                send_errors += 1
        else:
            pcm2 = np.zeros((2, 1152), np.int16)
            pcm2[:channels] = pcm
            if channels == 1:
                pcm2[1] = pcm[0]
            xl = np.array([calculated_padlen], np.int32)
            state, dev_out = enc.encode_step(state, pcm2[None], xl)
            out_np = convert.to_numpy(dev_out)
            xp = [(xpad, calculated_padlen)] if calculated_padlen else None
            for chunk in packer.emit(out_np, xp):
                mp2_fifo += chunk
            fl = 3 * args.bitrate
            while len(mp2_fifo) >= fl:
                if not send_frame(outs, mp2_fifo[:fl], peak_l, peak_r, False):
                    send_errors += 1
                mp2_fifo = mp2_fifo[fl:]

        if send_errors > 10:
            print("Send failed ten times, aborting!", file=sys.stderr)
            retval = 4
            break

        if args.level:
            if channels == 2:
                print(f"\rIn: [{level(0, peak_l):>6s}|{level(1, peak_r):<6s}]",
                      end="", file=sys.stderr)
            else:
                print(f"\rIn: [{level(1, max(peak_l, peak_r)):<6s}]",
                      end="", file=sys.stderr)
        if stats:
            stats.send_stats()

    print("", file=sys.stderr)
    inp.close()
    if wav_out is not None:
        wav_out.close()
    for o in outs:
        if o:
            o.close()
    return retval


def run_streams(args, device):
    """Batched multi-stream mode: JSON config with a list of stations."""
    from .fleet import run_fleet
    with open(args.streams) as f:
        conf = json.load(f)
    run_fleet(conf, verbose=args.verbose, device=device)
    return 0


def _setup_logging(args):
    from .host.log import eti_log, LogToSyslog, LogToFile, LogTracer
    if args.syslog:
        eti_log.register_backend(LogToSyslog())
    if args.logfile:
        eti_log.register_backend(LogToFile(args.logfile))
    if args.tracefile:
        eti_log.register_backend(LogTracer(args.tracefile))
    return eti_log


def _profiler(args, device):
    """torch.profiler over the run when --profile DIR is given (its Chrome
    trace goes to DIR/trace.json), else a null context."""
    if not args.profile:
        return contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(args.profile, exist_ok=True)
    trace = os.path.join(args.profile, "trace.json")
    return torch.profiler.profile(activities=acts,
                                  on_trace_ready=lambda p: p.export_chrome_trace(trace))


def main(argv=None):
    args = make_argparser().parse_args(argv)
    device = compute_device(args.compute_device)
    _setup_logging(args)
    with _profiler(args, device):
        if args.startup_check:
            r = subprocess.run(args.startup_check, shell=True)
            if r.returncode != 0:
                print(f"Startup check failed, returned {r.returncode}", file=sys.stderr)
                return 1
            print("Startup check ok", file=sys.stderr)
        if args.streams:
            return run_streams(args, device)
        return run_single(args, device)


if __name__ == "__main__":
    sys.exit(main())
