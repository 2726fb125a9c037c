"""Batched multi-station runtime: the framework's north-star operating mode
(port of odr_audioenc_tpu/fleet.py).

Takes a JSON config listing stations and runs them as device batches - MP2
streams with mixed bitrates/modes share one encode step per sample rate;
DAB+ streams are grouped by (rate, bitrate, channels, pad_len, aot).  Each
station has its own input file and outputs/stats, mirroring what N
reference processes would do.

Config:
{
  "realtime": false,
  "streams": [
    {"codec": "mp2", "input": "a.wav", "format": "wav", "rate": 48000,
     "bitrate": 128, "mode": "j", "output": "a.mp2", "stats": "/tmp/a.stats"},
    {"codec": "dabplus", "input": "b.wav", "rate": 48000, "bitrate": 96,
     "channels": 2, "output": "b.dabp",
     "edi": ["udp://127.0.0.1:12002"], "edi_fec": 2,
     "zmq": "tcp://*:9001", "secret_key": null,
     "pad": "/tmp/b.pad", "pad_len": 58}
  ]
}

Per-station sinks mirror the single-encoder CLI (odr-audioenc.cpp
send path, src/odr-audioenc.cpp:1282-1322): "output" file, "zmq" PUB
(optionally CURVE-encrypted with "secret_key"), "edi" destination list
("edi_fec" enables PFT), and a "pad"/"pad_len" ODR-PadEnc socket polled
once per MP2 frame / DAB+ AU.

Each group's device work for one pass is a chunk of k frames (MP2) or k
superframes (DAB+): a Python loop over the encoder's step that carries the
state.  Its outputs come back through pinned host buffers owned by the
group's runner (non_blocking copies, then a CUDA event that the drain waits
on), double-buffered because the drain runs one pass behind the step.
"""
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from .device import default_device

# figures of the last run_fleet call (read by chip_smoke.py and shown with
# verbose): "device", "rate" (streams x realtime), "stations",
# "audio_seconds", "wall_s" (timed passes) and per group "groups": [{"key",
# "streams", "k", "chunks", "step_s", "drain_s"}]: the chunks of k steps
# the group ran, and the host seconds per pass of the group's dispatch
# (input read, H2D, the k steps, D2H enqueue) and of its drain (wait,
# pack, send)
last_run = {}


class _Station:
    def __init__(self, conf):
        from .io.inputs import FileInput
        from .outputs import FileOutput, ZmqOutput, EdiOutput
        from .outputs.edi_out import EdiConfig, EdiDestination
        from .host.sidecars import StatsPublisher, PadInterface
        self.conf = conf
        self.codec = conf.get("codec", "dabplus")
        self.rate = conf.get("rate", 48000)
        self.bitrate = conf.get("bitrate", 96 if self.codec == "dabplus" else 128)
        self.mode = conf.get("mode", "j")
        self.channels = conf.get("channels", 1 if self.mode == "m" else 2)
        if self.codec == "mp2" and self.channels == 1:
            self.mode = "m"
        # AOT auto-selection by bitrate/channels (prepare_aac_encoder,
        # odr-audioenc.cpp:249-261), overridable with an "aot" key
        subch = self.bitrate // 8
        if self.codec == "dabplus":
            if self.channels == 2 and subch <= 6:
                auto = "ps"
            elif (self.channels == 1 and subch <= 8) or \
                    (self.channels == 2 and subch <= 10):
                auto = "sbr"
            else:
                auto = "lc"
            self.aot = conf.get("aot", auto)
        else:
            self.aot = None
        from .io.queue import SampleQueue
        self.queue = SampleQueue()
        self.queue.configure(1 << 24, push_block=False, channels=self.channels)
        self.input = FileInput(self.queue, conf["input"],
                               conf.get("format", "wav") == "raw",
                               self.rate, self.channels,
                               conf.get("fifo_silence", False))
        self.input.prepare()
        self.output = FileOutput(conf["output"]) if "output" in conf else None
        # per-station ZMQ PUB (Outputs.cpp ZMQ path; one encoder = one PUB)
        self.zmq = None
        if conf.get("zmq"):
            self.zmq = ZmqOutput(conf["zmq"], conf.get("secret_key"))
            self.zmq.set_encoder_type(self.codec == "dabplus")
        # per-station EDI sender (odr-audioenc.cpp:1282-1322 send path)
        self.edi = None
        if conf.get("edi"):
            uris = conf["edi"]
            if isinstance(uris, str):
                uris = [uris]
            dests = []
            for uri in uris:
                proto, rest = uri.split("://", 1)
                host, port = rest.rsplit(":", 1)
                dests.append(EdiDestination(proto, host, int(port)))
            fec = int(conf.get("edi_fec", 0))
            self.edi = EdiOutput(
                EdiConfig(enable_pft=fec > 0, fec=fec, destinations=dests),
                tist=bool(conf.get("edi_tist", False)),
                delay_ms=int(conf.get("edi_delay_ms", 0)),
                tai_offset=conf.get("edi_tai_offset"))
        # per-station PAD socket (PadInterface; one request per MP2 frame /
        # per DAB+ AU, mirroring the CLI loop)
        self.pad_len = int(conf.get("pad_len", 0)) if conf.get("pad") else 0
        self.pad = None
        if self.pad_len:
            self.pad = PadInterface()
            self.pad.open(conf["pad"])
        self.stats = StatsPublisher(conf["stats"]) if conf.get("stats") else None
        self.eof = False
        self.mp2_fifo = b""
        self.frames_done = 0

    def request_pads(self, n):
        """n PAD requests.  DAB+: list of n trimmed X-PAD byte strings
        (possibly empty).  MP2: list of n (full_buffer, used_len) tuples
        as Mp2Packer.emit expects."""
        out = []
        for _ in range(n):
            data = self.pad.request(self.pad_len)
            cl = 0
            xpad = b""
            if len(data) == self.pad_len + 1 and data[self.pad_len] >= 2:
                cl = data[self.pad_len]
                xpad = data[:self.pad_len]
                # AAC: skip PAD if only zero F-PAD (TS 102 563 5.4.3)
                if self.codec == "dabplus" and cl == 2 and \
                        xpad[-2] == 0 and xpad[-1] == 0:
                    cl = 0
            if self.codec == "dabplus":
                out.append(xpad[self.pad_len - cl:] if cl else b"")
            else:
                out.append((xpad, cl) if cl else (b"", 0))
        return out

    def send(self, buf, peak):
        """Route one coded frame to every configured sink."""
        if self.output:
            self.output.write_frame(buf)
        if self.zmq:
            self.zmq.update_audio_levels(peak, peak)
            self.zmq.write_frame(buf)
        if self.edi:
            self.edi.update_audio_levels(peak, peak)
            if self.codec == "dabplus":
                bs = len(buf) // 5   # 5 x 24 ms EDI frames per superframe
                for i in range(5):
                    self.edi.write_frame(buf[i * bs:(i + 1) * bs])
            else:
                self.edi.write_frame(buf)

    def close(self):
        for o in (self.output, self.zmq, self.edi):
            if o is not None:
                o.close()
        if self.pad:
            self.pad.close()

    def read_frame(self, nsamples):
        nbytes = nsamples * self.channels * 2
        if not self.eof and not self.input.read_source(nbytes):
            self.eof = True
        buf, _, _ = self.queue.pop(nbytes)  # zero-fills past EOF
        pcm = np.frombuffer(buf, np.int16).reshape(-1, self.channels).T
        return pcm

    def publish(self, peak_l, peak_r):
        if self.stats:
            self.stats.update_audio_levels(peak_l, peak_r)
            self.stats.send_stats()


class _Transfers:
    """One runner's host<->device traffic.  On CUDA: the PCM goes up from a
    pinned staging buffer and the step's outputs come down into pinned
    buffers, both with non_blocking copies (a non_blocking copy from or into
    pageable memory is synchronous), and an event recorded after the
    download is what `wait` blocks on.  Two slots alternate: the drain of
    pass t-1 runs after pass t's copies are enqueued, and it waits for the
    event of pass t-1, which follows that pass's upload, so slot (t+1) % 2
    is free again when pass t+1 fills it.  On the CPU the tensors are the
    host arrays and nothing is copied."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.slots = [{}, {}]
        self.turn = 0

    def _pinned(self, name, shape, dtype):
        slot = self.slots[self.turn]
        buf = slot.get(name)
        if buf is None or tuple(buf.shape) != tuple(shape) or buf.dtype != dtype:
            buf = slot[name] = torch.empty(shape, dtype=dtype, pin_memory=True)
        return buf

    def upload(self, pcm):
        """pcm: numpy [k, S, ch, n] int16 -> the tensor on the device."""
        host = torch.from_numpy(pcm)
        if not self.cuda:
            return host
        buf = self._pinned("pcm", host.shape, host.dtype)
        buf.copy_(host)
        return buf.to(self.device, non_blocking=True)

    def download(self, out):
        """Enqueue the copies of the step's outputs; returns the handle
        that `wait` takes, and flips the slot."""
        if not self.cuda:
            return out, None
        host = {}
        for k, v in out.items():
            host[k] = self._pinned("out_" + k, v.shape, v.dtype)
            host[k].copy_(v, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self.turn ^= 1
        return host, event

    @staticmethod
    def wait(handle):
        """numpy copies of a download's outputs, once its copies are done
        (copies: the packers keep a frame past this drain, and the pinned
        slot is refilled two passes later)."""
        host, event = handle
        if event is not None:
            event.synchronize()
        return {k: v.numpy().copy() for k, v in host.items()}


def _chunk(step, state, pcm):
    """k steps of a group's encoder, carrying the state (the JAX fleet's
    jitted lax.scan over k frames): pcm [k, S, ...] on the device; the
    outputs stacked [k, S, ...]."""
    outs = []
    for p in pcm:
        state, out = step(state, p)
        outs.append(out)
    return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def run_fleet(conf, verbose=0, device=None):
    """Run the stations of `conf` to the end of their inputs; returns the
    streams x realtime of the passes after the two warm ones.  device: the
    card by default (raises where there is none); the CPU takes
    device="cpu"."""
    device = torch.device(device) if device is not None else default_device()
    from .mp2.model import Mp2Encoder, make_config
    from .host.mp2pack import Mp2Packer
    from .dabplus.model import DabPlusEncoder, DabPlusConfig

    stations = [_Station(s) for s in conf["streams"]]
    realtime = conf.get("realtime", False)
    # seconds of audio per device chunk (throughput/latency knob)
    chunk_s = 0.0 if realtime else float(conf.get("chunk_seconds", 0.96))
    # stats cadence: per-frame (reference behavior) vs per-chunk max-peak
    stats_per_frame = bool(conf.get("stats_per_frame", False))
    groups = defaultdict(list)
    for st in stations:
        if st.codec == "mp2":
            groups[("mp2", st.rate)].append(st)
        else:
            groups[("dabplus", st.rate, st.bitrate, st.channels,
                    st.pad_len, st.aot)].append(st)

    runners = []
    for key, members in groups.items():
        if key[0] == "mp2":
            cfg = make_config([{"rate": m.rate, "bitrate": m.bitrate,
                                "mode": m.mode, "pad_len": m.pad_len}
                               for m in members])
            enc = Mp2Encoder(cfg, psy_model=1, dtype=torch.float32, device=device,
                             pack_on_device="frame")
            packer = Mp2Packer(cfg)
            # chunking needs a pad-free, integer-slot config (X-PAD bytes
            # and the 44.1k fractional-padding host state are per-frame)
            k = 1
            if not any(m.pad for m in members) and \
                    not (cfg.slots_frac != 0).any():
                k = max(1, int(round(chunk_s * members[0].rate / 1152.0)))
        else:
            _, rate, bitrate, ch, pad_len, aot = key
            dcfg = DabPlusConfig(rate, bitrate // 8, ch, pad_len=pad_len,
                                 aot=aot)
            enc = DabPlusEncoder(dcfg, n_streams=len(members), dtype=torch.float32,
                                 device=device, pack_on_device=True)
            packer = None
            k = 1
            sf_sec = dcfg.num_aus * dcfg.au_samples / rate
            if not any(m.pad for m in members):
                k = max(1, int(round(chunk_s / sf_sec)))
        runners.append({"kind": key[0], "key": key, "members": members, "enc": enc,
                        "packer": packer, "state": enc.init_state(), "k": k,
                        "io": _Transfers(device), "chunks": 0, "step_s": [],
                        "drain_s": []})

    t0 = time.perf_counter()
    audio_seconds = 0.0
    # the first pass runs every runner's first step (allocator growth,
    # cuBLAS handles, kernel builds); the second performs the first drains
    # (native packer load, per-station buffers), so the steady-state clock
    # starts at pass 3
    warm_passes = 2
    # one-step-deep host<->device pipeline: the device computes pass t
    # while the host drains (waits for, bit-packs and sends) pass t-1, which
    # runs AFTER pass t has been submitted
    pending = [None] * len(runners)

    def drain(ri):
        r = runners[ri]
        if pending[ri] is None:
            return
        t_d = time.perf_counter()
        handle, peaks, xp = pending[ri]    # peaks: [k, S] int
        pending[ri] = None
        members, k = r["members"], r["k"]
        out_np = _Transfers.wait(handle)
        if r["kind"] == "mp2":
            for f in range(k):
                chunks = r["packer"].emit({kk: v[f] for kk, v in out_np.items()}, xp)
                for i, m in enumerate(members):
                    m.mp2_fifo += chunks[i]
                    fl = 3 * m.bitrate
                    peak = int(peaks[f, i])
                    while len(m.mp2_fifo) >= fl:
                        m.send(m.mp2_fifo[:fl], peak)
                        m.mp2_fifo = m.mp2_fifo[fl:]
                    m.frames_done += 1
        else:
            for f in range(k):
                frames = r["enc"].pack_superframes({kk: v[f] for kk, v in out_np.items()})
                for i, m in enumerate(members):
                    m.send(frames[i], int(peaks[f, i]))
                    m.frames_done += 1
        if stats_per_frame and k > 1:
            # reference cadence: one stats datagram per coded frame
            for f in range(k):
                for i, m in enumerate(members):
                    m.publish(int(peaks[f, i]), int(peaks[f, i]))
        else:
            # chunked default: one datagram per device chunk carrying the
            # chunk's max peak (cadence = chunk_seconds, not per-frame -
            # set "stats_per_frame": true to restore the reference cadence
            # at a per-frame host cost)
            pk = peaks.max(0)
            for i, m in enumerate(members):
                m.publish(int(pk[i]), int(pk[i]))
        r["drain_s"][-1] += time.perf_counter() - t_d

    while True:
        if all(m.eof for r in runners for m in r["members"]):
            break
        for ri, r in enumerate(runners):
            members, enc, k = r["members"], r["enc"], r["k"]
            r["drain_s"].append(0.0)
            if all(m.eof for m in members):
                r["step_s"].append(0.0)
                drain(ri)
                continue
            t_s = time.perf_counter()
            S = len(members)
            if r["kind"] == "mp2":
                pcm = np.zeros((k, S, 2, 1152), np.int16)
                xp = [None] * S
                xl = np.zeros((S,), np.int32)
                for i, m in enumerate(members):
                    # one queue read covers the whole chunk (k frames)
                    p = m.read_frame(1152 * k)
                    pk = p.reshape(m.channels, k, 1152).swapaxes(0, 1)
                    pcm[:, i, :m.channels] = pk
                    if m.channels == 1:
                        pcm[:, i, 1] = pk[:, 0]
                    if m.pad:  # k == 1 when any station has a PAD socket
                        xp[i] = m.request_pads(1)[0]
                        xl[i] = xp[i][1]
                have_pads = any(x is not None for x in xp)
                xbuf = None
                if have_pads:
                    # frame mode packs X-PAD on device: [S, pad_max] buffers
                    xbuf = np.zeros((S, enc.pad_max), np.int32)
                    for i, x in enumerate(xp):
                        if x is not None and x[0]:
                            b = np.frombuffer(x[0], np.uint8)
                            xbuf[i, :len(b)] = b
                pcm_dev = r["io"].upload(pcm)
                if k > 1:
                    xl0 = torch.zeros((S,), dtype=torch.int64, device=device)
                    r["state"], out = _chunk(lambda st, p: enc._encode_step(st, p, xl0),
                                             r["state"], pcm_dev)
                else:
                    r["state"], out = enc.encode_step(
                        r["state"], pcm_dev[0], xl if have_pads else None,
                        xpad_buf=xbuf)
                    out = {kk: v[None] for kk, v in out.items()}
                audio_seconds += k * S * 1152 / members[0].rate
                step_xp = xp if have_pads else None
            else:
                nau = enc.cfg.num_aus
                # SBR/PS AUs cover 1920 full-rate samples (au_samples), LC 960
                nsamp = nau * enc.cfg.au_samples
                pcm = np.zeros((k, S, enc.cfg.channels, nsamp), np.int16)
                pads = []
                for i, m in enumerate(members):
                    p = m.read_frame(nsamp * k)[:enc.cfg.channels]
                    pcm[:, i] = p.reshape(enc.cfg.channels, k,
                                          nsamp).swapaxes(0, 1)
                    pads.append(m.request_pads(nau) if m.pad
                                else [b""] * nau)
                have_pads = any(m.pad for m in members)
                pcm_dev = r["io"].upload(pcm)
                if k > 1:
                    r["state"], out = _chunk(enc._superframe_step, r["state"], pcm_dev)
                else:
                    r["state"], out = enc.encode_superframes(
                        r["state"], pcm_dev[0], pack=False,
                        pads=pads if have_pads else None)
                    out = {kk: v[None] for kk, v in out.items()}
                audio_seconds += k * S * nsamp / members[0].rate
                step_xp = None
            r["chunks"] += 1
            peaks = np.abs(pcm.astype(np.int32)).max(axis=(-2, -1))  # [k, S]
            # start the device->host copies now, so they overlap the other
            # runners' dispatches and this runner's drain of the last pass
            prev = pending[ri]
            pending[ri] = (r["io"].download(out), peaks, step_xp)
            r["step_s"].append(time.perf_counter() - t_s)
            if prev is not None:
                pending[ri], keep = prev, pending[ri]
                drain(ri)
                pending[ri] = keep
        if warm_passes:
            warm_passes -= 1
            t0 = time.perf_counter()
            audio_seconds = 0.0
        if realtime:
            time.sleep(0.001)
    for ri, r in enumerate(runners):
        r["drain_s"].append(0.0)
        drain(ri)

    dt = time.perf_counter() - t0
    for st in stations:
        st.close()
    rate = audio_seconds / dt if dt > 0 else 0.0
    last_run.clear()
    last_run.update(device=str(device), rate=rate, stations=len(stations), audio_seconds=audio_seconds,
                    wall_s=dt, groups=[{"key": r["key"], "streams": len(r["members"]),
                                        "k": r["k"], "chunks": r["chunks"],
                                        "step_s": r["step_s"],
                                        "drain_s": r["drain_s"]} for r in runners])
    print(f"fleet: {len(stations)} stations, {audio_seconds:.1f} audio-s "
          f"in {dt:.2f} s wall = {rate:.1f} streams*realtime",
          file=sys.stderr)
    if verbose:
        for g in last_run["groups"]:
            timed = [a + b for a, b in zip(g["step_s"][2:], g["drain_s"][2:])]
            print(f"fleet: group {g['key']}: S={g['streams']} k={g['k']}, "
                  f"{sum(timed):.3f} s over {len(timed)} timed passes", file=sys.stderr)
    return rate
