"""ctypes bindings for the native host library (odr_audioenc_tpu_torch/native/).

The C++ packers are the production path (the reference's equivalent code is
C/C++: libtoolame-dab/bitstream.c, encode_new.c write_*); the pure-Python
implementations in mp2pack.py and aacpack.py stay as the validation twins,
equivalence-tested against the native ones, and are chosen explicitly
(`use_native=False`), never as a fallback.

The library is built from the sources in the checkout at first use, with
`g++ -O2 -fPIC -shared -fopenmp`, into the git-ignored
`odr_audioenc_tpu_torch/kernels/build/libodrhost-<hash>.so`.  The hash is that
of every source and header in native/ and of the compiler and its flags, so
an edited source is rebuilt and an unchanged one is loaded as it is.  A
failed build raises with the compiler's output.
"""
import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "native"
BUILD_DIR = _PKG / "kernels" / "build"
CXX = "g++"
FLAGS = ["-O2", "-fPIC", "-shared", "-fopenmp"]
SOURCES = ("mp2pack.cpp", "dabpack.cpp")
HEADERS = ("mp2_tables.h", "aac_tables.h")

_LOADED = {}


def library_path():
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode() + b"\0" + (SRC_DIR / name).read_bytes())
    h.update(" ".join([CXX, *FLAGS]).encode())
    return BUILD_DIR / f"libodrhost-{h.hexdigest()[:16]}.so"


def get_lib():
    """The native library, built if needed; raises if it cannot be built."""
    so = library_path()
    lib = _LOADED.get(so)
    if lib is not None:
        return lib
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [CXX, *FLAGS, "-o", str(tmp), *(str(SRC_DIR / f) for f in SOURCES)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"native host library: cannot run {CXX!r}: {e}") from e
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native host library: {' '.join(cmd)} failed with code "
                               f"{res.returncode}:\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.mp2_pack_batch.restype = ctypes.c_int
    lib.dabplus_pack_batch.restype = ctypes.c_int
    _LOADED[so] = lib
    return lib


def _p(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def mp2_pack_batch(cfg_cols, out_np, xpads, max_frame):
    """Batch-pack S MP2 frames.  cfg_cols: [S, 9] int32 config columns;
    out_np: device outputs as numpy; xpads: None or list of per-stream
    (buf, used_len).  Returns (frames u8 [S, max_frame], lens [S],
    scf_offs [S], scf_vals [S, 4])."""
    lib = get_lib()
    S = cfg_cols.shape[0]
    ba = np.ascontiguousarray(out_np["bit_alloc"], np.uint8)
    sc = np.ascontiguousarray(out_np["scfsi"], np.uint8)
    sf = np.ascontiguousarray(out_np["sf_index"], np.uint8)
    if "payload" in out_np:
        # device-packed sample section: sbband is not transferred at all
        sb = np.zeros(1, np.uint32)
        pay = np.ascontiguousarray(out_np["payload"], np.uint8)
        pbits = np.ascontiguousarray(out_np["payload_bits"], np.int32)
        pay_p = _p(pay, ctypes.c_uint8)
        pbits_p = _p(pbits, ctypes.c_int32)
        pay_stride = pay.shape[1]
    else:
        sb = np.ascontiguousarray(out_np["sbband"], np.uint32)
        pay_p = pbits_p = None
        pay_stride = 0
    mode = np.ascontiguousarray(out_np["mode"], np.int32)
    mext = np.ascontiguousarray(out_np["mode_ext"], np.int32)
    jsb = np.ascontiguousarray(out_np["jsbound"], np.int32)
    adbl = np.ascontiguousarray(out_np["adb_left"], np.int32)
    if "extra" in out_np:
        extra = np.ascontiguousarray(out_np["extra"], np.int32)
        extra_p = _p(extra, ctypes.c_int32)
    else:
        extra_p = None
    if xpads is not None:
        stride = max(len(b) for b, _ in xpads) if xpads else 1
        stride = max(stride, 1)
        xbuf = np.zeros((S, stride), np.uint8)
        xlen = np.zeros(S, np.int32)
        for i, (b, ln) in enumerate(xpads):
            if len(b):
                xbuf[i, :len(b)] = np.frombuffer(bytes(b), np.uint8)
            xlen[i] = ln
        xb_p, xl_p = _p(xbuf, ctypes.c_uint8), _p(xlen, ctypes.c_int32)
    else:
        stride = 1
        xb_p, xl_p = None, None

    out = np.zeros((S, max_frame), np.uint8)
    out_len = np.zeros(S, np.int32)
    scf_off = np.zeros(S, np.int32)
    scf_vals = np.zeros((S, 4), np.uint8)
    rc = lib.mp2_pack_batch(
        ctypes.c_int(S),
        _p(ba, ctypes.c_uint8), _p(sc, ctypes.c_uint8), _p(sf, ctypes.c_uint8),
        _p(sb, ctypes.c_uint32), _p(mode, ctypes.c_int32),
        _p(mext, ctypes.c_int32), _p(jsb, ctypes.c_int32),
        _p(adbl, ctypes.c_int32), extra_p,
        _p(np.ascontiguousarray(cfg_cols, np.int32), ctypes.c_int32),
        xb_p, xl_p, ctypes.c_int(stride),
        _p(out, ctypes.c_uint8), ctypes.c_int(max_frame),
        _p(out_len, ctypes.c_int32), _p(scf_off, ctypes.c_int32),
        _p(scf_vals, ctypes.c_uint8),
        pay_p, pbits_p, ctypes.c_int(pay_stride))
    if rc != 0:
        raise RuntimeError("native mp2_pack_batch failed (budget overrun or "
                           "frame length mismatch)")
    return out, out_len, scf_off, scf_vals


def dabplus_pack_batch(enc, out_np, pads, add_rs):
    """Batch-pack S DAB+ superframes via the native library.
    enc: DabPlusEncoder (static config source)."""
    lib = get_lib()
    S = out_np["q"].shape[0]
    nau = enc.cfg.num_aus
    ch = enc.core_channels
    nb = out_np["books"].shape[-1]
    q = np.ascontiguousarray(out_np["q"], np.int32)
    gains = np.ascontiguousarray(out_np["gains"], np.int32)
    books = np.ascontiguousarray(out_np["books"], np.int32)
    ms = np.ascontiguousarray(out_np["ms_used"], np.uint8) \
        if "ms_used" in out_np else None
    tns_en = np.ascontiguousarray(out_np["tns_en"], np.uint8)
    tns_order = np.ascontiguousarray(out_np["tns_order"], np.int32)
    tns_idx = np.ascontiguousarray(out_np["tns_idx"], np.int32)
    tlc = enc.tns_cfg["length_code"] if enc.tns_cfg else 0
    tns_len = np.ascontiguousarray(out_np["tns_len"], np.int32) \
        if "tns_len" in out_np else None
    tns_en_lo = np.ascontiguousarray(out_np["tns_en_lo"], np.uint8) \
        if "tns_en_lo" in out_np else None
    tns_order_lo = np.ascontiguousarray(out_np["tns_order_lo"], np.int32) \
        if "tns_order_lo" in out_np else None
    tns_idx_lo = np.ascontiguousarray(out_np["tns_idx_lo"], np.int32) \
        if "tns_idx_lo" in out_np else None
    tlc_lo = enc.tns_cfg.get("length_code_lo", 0) if enc.tns_cfg else 0
    sfb_off = np.ascontiguousarray(enc.sfb_off, np.int32)
    wseq = np.ascontiguousarray(out_np["wseq"], np.int32) \
        if "wseq" in out_np else None
    sfb_off_s = np.ascontiguousarray(enc.sfb_off_short, np.int32)
    shortp = np.asarray([enc.nsfb_short, enc.max_sfb_short], np.int32)

    if enc.is_sbr:
        p = enc.sbr_params
        env = np.ascontiguousarray(out_np["sbr_env"], np.int32)  # [S,nau,ch,n_lo]
        env2 = np.ascontiguousarray(out_np["sbr_env2"], np.int32)
        trans = np.ascontiguousarray(out_np["sbr_transient"], np.uint8)
        env_ch = env.shape[2]
        sbrp = np.asarray([p.bs_start_freq, p.bs_stop_freq, p.bs_xover_band,
                           p.bs_freq_scale, p.bs_alter_scale, p.bs_noise_bands,
                           p.n_q, p.n_lo, 12, env_ch, p.n_hi,
                           getattr(enc, "ps_nenv", 0)], np.int32)
        env_p = _p(env, ctypes.c_int32)
        env2_p = _p(env2, ctypes.c_int32)
        trans_p = _p(trans, ctypes.c_uint8)
        nq = np.ascontiguousarray(out_np["sbr_noise_q"], np.int32)
        invf = np.ascontiguousarray(out_np["sbr_invf"], np.int32)
        addh = np.ascontiguousarray(out_np["sbr_addharm"], np.uint8)
        tgrid = np.ascontiguousarray(out_np["sbr_tgrid"], np.int32)
        nq_p = _p(nq, ctypes.c_int32)
        invf_p = _p(invf, ctypes.c_int32)
        addh_p = _p(addh, ctypes.c_uint8)
        tgrid_p = _p(tgrid, ctypes.c_int32)
        cpl_p = None
        if "sbr_cpl" in out_np:
            cpl = np.ascontiguousarray(out_np["sbr_cpl"], np.uint8)
            cpl_p = _p(cpl, ctypes.c_uint8)
    else:
        sbrp = np.asarray([0] * 8 + [12, 1, 0, 0], np.int32)
        env_p = env2_p = trans_p = None
        nq_p = invf_p = addh_p = tgrid_p = cpl_p = None
    if enc.is_ps and "ps_iid" in out_np:
        iid = np.ascontiguousarray(out_np["ps_iid"], np.int32)
        iid_p = _p(iid, ctypes.c_int32)
        iidf = np.ascontiguousarray(out_np["ps_iid_fine"], np.int32)
        iidf_p = _p(iidf, ctypes.c_int32)
        psf = np.ascontiguousarray(out_np["ps_fine"], np.uint8)
        psf_p = _p(psf, ctypes.c_uint8)
        icc = np.ascontiguousarray(out_np["ps_icc"], np.int32)
        icc_p = _p(icc, ctypes.c_int32)
    else:
        iid_p = icc_p = iidf_p = psf_p = None

    if pads is not None:
        stride = max(1, max((len(pads[s][a]) if pads[s][a] else 0)
                            for s in range(S) for a in range(nau)))
        pbuf = np.zeros((S, nau, stride), np.uint8)
        plen = np.zeros((S, nau), np.int32)
        for s in range(S):
            for a in range(nau):
                b = pads[s][a]
                if b:
                    pbuf[s, a, :len(b)] = np.frombuffer(bytes(b), np.uint8)
                    plen[s, a] = len(b)
        pb_p, pl_p = _p(pbuf, ctypes.c_uint8), _p(plen, ctypes.c_int32)
    else:
        stride = 1
        pb_p, pl_p = None, None

    pk = enc.packer
    sfp = np.asarray([pk.subch, pk.dac_rate, pk.sbr, pk.ps, pk.ch_mode,
                      1 if add_rs else 0], np.int32)
    out_stride = pk.subch * (120 if add_rs else 110)
    out = np.zeros((S, out_stride), np.uint8)
    out_len = np.zeros(S, np.int32)
    rc = lib.dabplus_pack_batch(
        ctypes.c_int(S), ctypes.c_int(nau), ctypes.c_int(ch),
        ctypes.c_int(enc.max_sfb), ctypes.c_int(nb),
        _p(sfb_off, ctypes.c_int32),
        _p(wseq, ctypes.c_int32) if wseq is not None else None,
        _p(sfb_off_s, ctypes.c_int32), _p(shortp, ctypes.c_int32),
        _p(q, ctypes.c_int32), _p(gains, ctypes.c_int32),
        _p(books, ctypes.c_int32),
        _p(ms, ctypes.c_uint8) if ms is not None else None,
        _p(tns_en, ctypes.c_uint8), _p(tns_order, ctypes.c_int32),
        _p(tns_idx, ctypes.c_int32), ctypes.c_int(tlc),
        _p(tns_len, ctypes.c_int32) if tns_len is not None else None,
        _p(tns_en_lo, ctypes.c_uint8) if tns_en_lo is not None else None,
        _p(tns_order_lo, ctypes.c_int32) if tns_order_lo is not None else None,
        _p(tns_idx_lo, ctypes.c_int32) if tns_idx_lo is not None else None,
        ctypes.c_int(tlc_lo),
        env_p, env2_p, trans_p, nq_p, invf_p, addh_p, tgrid_p, cpl_p,
        iid_p, iidf_p, psf_p, icc_p, pb_p, pl_p, ctypes.c_int(stride),
        _p(sbrp, ctypes.c_int32), _p(sfp, ctypes.c_int32),
        _p(out, ctypes.c_uint8), ctypes.c_int(out_stride),
        _p(out_len, ctypes.c_int32))
    if rc != 0:
        raise RuntimeError("native dabplus_pack_batch failed (overflow)")
    return [out[s, :out_len[s]].tobytes() for s in range(S)]
