"""Incremental (chunked) audio decode: O(window) host memory for long files.

Behavioural spec: reference src/source/file/streamed.rs:522-567 — a decoder
thread incrementally feeds a 128 Ki-sample ring so arbitrarily long files
play with bounded host memory — and src/source/file/decoder.rs (packet
loop + seek).  This formulation replaces the thread+ring with a chunked
random-access reader: `read(start, count)` decodes only the frames a render
block's window needs, and `CachedReader` keeps a bounded LRU of decoded
chunks so loop playback does not re-decode every pass.  Total resident
decode memory is `chunk_frames * max_chunks * channels * 4` bytes no matter
how long the file is.

Formats: WAV (PCM 8/16/24/32, float32/64, IMA/MS ADPCM) and AIFF seek
straight to the data bytes; mp3 (libmpg123) and ogg/vorbis (libvorbisfile)
seek via their libraries' sample-accurate seek; FLAC decodes sequentially
from the last position and restarts on backward jumps (the LRU absorbs loop
jumps); m4a/ALAC fetches + decodes exactly the packets covering a request
via the MP4 sample tables.  `open_chunked` sniffs like io/decoder.py and
falls back to a full-decode reader for registered plugin formats.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Optional

import numpy as np

from ..errors import MediaFileError, UnsupportedFormatError
from . import wav as wav_io


class ChunkedReader:
    """Random-access decoded-audio reader protocol.

    Attributes: sample_rate, channels, frames, loops (list of
    wav_io.LoopInfo).  ``read(start, count)`` returns float32
    [channels, count], zero-padded outside [0, frames)."""

    sample_rate: int
    channels: int
    frames: int
    loops: list

    def read(self, start: int, count: int) -> np.ndarray:
        raise NotImplementedError

    def close(self):
        pass

    def _padded(self, start: int, count: int, body_fn) -> np.ndarray:
        """Clamp [start, start+count) to the valid range, decode the valid
        span with ``body_fn(lo, n)`` and zero-pad the rest."""
        out = np.zeros((self.channels, count), np.float32)
        lo = max(start, 0)
        hi = min(start + count, self.frames)
        if hi > lo:
            out[:, lo - start:hi - start] = body_fn(lo, hi - lo)
        return out


class BufferReader(ChunkedReader):
    """In-memory planar array as a reader (preloaded buffers, test data)."""

    def __init__(self, data: np.ndarray, sample_rate: int, loops=None):
        self._data = np.asarray(data, np.float32)
        self.sample_rate = int(sample_rate)
        self.channels = self._data.shape[0]
        self.frames = self._data.shape[1]
        self.loops = loops or []

    def read(self, start, count):
        return self._padded(start, count,
                            lambda lo, n: self._data[:, lo:lo + n])


class WavChunkedReader(ChunkedReader):
    """Seekable WAV: PCM/float reads slice the data chunk directly; ADPCM
    decodes only the blocks covering the request (reference decode:
    src/source/file/decoder.rs:67-131 via symphonia)."""

    def __init__(self, path):
        self._path = Path(path)
        self._f = open(self._path, "rb")
        self._lock = threading.Lock()
        head = self._f.read(12)
        if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise MediaFileError(f"{path}: not a RIFF/WAVE file")
        self._fmt = None
        self._data_off = None
        self._data_len = 0
        fact_frames = None
        self.loops = []
        while True:
            hdr = self._f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            pos = self._f.tell()
            if cid == b"fmt ":
                body = self._f.read(min(size, 64))
                tag, ch, sr, _br, balign, bits = struct.unpack_from(
                    "<HHIIHH", body)
                if tag == wav_io.WAVE_FORMAT_EXTENSIBLE and size >= 40:
                    (tag,) = struct.unpack_from("<H", body, 24)
                self._fmt = (tag, ch, sr, bits, balign)
            elif cid == b"fact" and size >= 4:
                (fact_frames,) = struct.unpack("<I", self._f.read(4))
            elif cid == b"data":
                self._data_off = pos
                # streaming encoders write size 0 / 0xFFFFFFFF: fall back
                # to the file length
                end = self._file_size()
                self._data_len = min(size, end - pos) if size not in (
                    0, 0xFFFFFFFF) else end - pos
            elif cid == b"smpl" and size >= 36:
                body = self._f.read(size)
                (n_loops,) = struct.unpack_from("<I", body, 28)
                for i in range(n_loops):
                    base = 36 + i * 24
                    if base + 24 > size:
                        break
                    _i, mode, s, e, _f2, _c = struct.unpack_from(
                        "<IIIIII", body, base)
                    self.loops.append(wav_io.LoopInfo(mode=mode, start=s, end=e))
            self._f.seek(pos + size + (size & 1))
        if self._fmt is None or self._data_off is None:
            raise MediaFileError(f"{path}: missing fmt/data chunk")
        tag, ch, sr, bits, balign = self._fmt
        self.sample_rate = sr
        self.channels = ch
        self._adpcm = tag in (wav_io.WAVE_FORMAT_IMA_ADPCM,
                              wav_io.WAVE_FORMAT_MS_ADPCM)
        if self._adpcm:
            if tag == wav_io.WAVE_FORMAT_IMA_ADPCM:
                self._spb = ((balign - 4 * ch) // (4 * ch)) * 8 + 1
                self._adpcm_dec = wav_io._decode_ima_adpcm
            else:
                self._spb = (balign - 7 * ch) * 2 // ch + 2
                self._adpcm_dec = wav_io._decode_ms_adpcm
            nblocks = self._data_len // balign if balign else 0
            self.frames = nblocks * self._spb
            if fact_frames is not None:
                self.frames = min(self.frames, fact_frames)
        else:
            self._bpf = balign if balign else ch * (bits // 8)
            self.frames = self._data_len // self._bpf if self._bpf else 0

    def _file_size(self) -> int:
        cur = self._f.tell()
        self._f.seek(0, 2)
        end = self._f.tell()
        self._f.seek(cur)
        return end

    def read(self, start, count):
        return self._padded(start, count, self._read_valid)

    def _read_valid(self, lo, n):
        tag, ch, sr, bits, balign = self._fmt
        with self._lock:
            if self._adpcm:
                b0 = lo // self._spb
                b1 = (lo + n - 1) // self._spb + 1
                self._f.seek(self._data_off + b0 * balign)
                raw = self._f.read((b1 - b0) * balign)
                inter = self._adpcm_dec(raw, ch, balign)
                off = lo - b0 * self._spb
                x = inter[off * ch:(off + n) * ch]
                out = np.zeros((ch, n), np.float32)
                got = len(x) // ch
                out[:, :got] = x[:got * ch].reshape(got, ch).T
                return out
            self._f.seek(self._data_off + lo * self._bpf)
            raw = np.frombuffer(self._f.read(n * self._bpf), np.uint8)
        got = len(raw) // self._bpf
        x = wav_io.decode_pcm_samples(raw[:got * self._bpf], tag, bits)
        out = np.zeros((ch, n), np.float32)
        out[:, :got] = x.reshape(got, ch).T
        return out

    def close(self):
        self._f.close()


class AiffChunkedReader(ChunkedReader):
    """Seekable AIFF PCM (big-endian)."""

    def __init__(self, path):
        self._path = Path(path)
        self._f = open(self._path, "rb")
        self._lock = threading.Lock()
        head = self._f.read(12)
        if head[:4] != b"FORM":
            raise MediaFileError(f"{path}: not an AIFF file")
        self.loops = []
        self._bits = 0
        self._data_off = None
        self._data_len = 0
        while True:
            hdr = self._f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack(">I", hdr[4:])[0]
            pos = self._f.tell()
            if cid == b"COMM":
                body = self._f.read(size)
                ch, frames, bits = struct.unpack_from(">hIh", body)
                from .decoder import _read_f80
                self.sample_rate = int(round(_read_f80(body[8:18])))
                self.channels = ch
                self._bits = bits
            elif cid == b"SSND":
                off, _blk = struct.unpack(">II", self._f.read(8))
                self._data_off = pos + 8 + off
                self._data_len = size - 8 - off
            self._f.seek(pos + size + (size & 1))
        if self._data_off is None or self._bits == 0:
            raise MediaFileError(f"{path}: missing SSND/COMM chunk")
        self._bpf = self.channels * (self._bits // 8)
        self.frames = self._data_len // self._bpf

    def read(self, start, count):
        return self._padded(start, count, self._read_valid)

    def _read_valid(self, lo, n):
        with self._lock:
            self._f.seek(self._data_off + lo * self._bpf)
            raw = self._f.read(n * self._bpf)
        got = len(raw) // self._bpf
        bits = self._bits
        if bits == 16:
            x = np.frombuffer(raw[:got * self._bpf], ">i2").astype(
                np.float32) / 32768.0
        elif bits == 8:
            x = np.frombuffer(raw[:got * self._bpf], "i1").astype(
                np.float32) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw[:got * self._bpf], np.uint8).reshape(-1, 3)
            vals = ((b[:, 0].astype(np.uint32) << 16)
                    | (b[:, 1].astype(np.uint32) << 8)
                    | b[:, 2].astype(np.uint32)).astype(np.int32)
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(raw[:got * self._bpf], ">i4").astype(
                np.float32) / float(1 << 31)
        else:
            raise UnsupportedFormatError(
                f"{self._path}: unsupported AIFF bit depth {bits}")
        out = np.zeros((self.channels, n), np.float32)
        out[:, :got] = x.reshape(got, self.channels).T
        return out

    def close(self):
        self._f.close()


class FlacChunkedReader(ChunkedReader):
    """Sequential FLAC decode with a forward cursor; a backward request
    restarts from the stream head (the CachedReader LRU absorbs loop
    jumps so each loop pass decodes its region once)."""

    def __init__(self, path):
        from .flac import FlacStream
        self._path = Path(path)
        self._lock = threading.Lock()
        self._stream = FlacStream(self._path)
        self.sample_rate = self._stream.sample_rate
        self.channels = self._stream.channels
        self.frames = self._stream.total_frames
        self.loops = []

    def read(self, start, count):
        return self._padded(start, count, self._read_valid)

    def _read_valid(self, lo, n):
        with self._lock:
            if lo < self._stream.position_of_pending():
                self._stream.seek_back(lo)
            return self._stream.read_at(lo, n)

    def close(self):
        self._stream.close()


class Mpg123ChunkedReader(ChunkedReader):
    """libmpg123 handle kept open; mpg123_seek gives sample-accurate
    random access (mp3 frame overlap handled by the library)."""

    def __init__(self, path):
        from . import mp3 as mp3_io
        lib = mp3_io._load()
        if lib is None:
            raise UnsupportedFormatError(
                f"{path}: no libmpg123 on this host ({mp3_io._lib_err})")
        # off_t bindings for length/seek (not needed by the one-shot reader)
        if not hasattr(lib, "_chunked_bound"):
            lib.mpg123_length.restype = ctypes.c_long
            lib.mpg123_length.argtypes = [ctypes.c_void_p]
            lib.mpg123_seek.restype = ctypes.c_long
            lib.mpg123_seek.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                        ctypes.c_int]
            lib.mpg123_scan.restype = ctypes.c_int
            lib.mpg123_scan.argtypes = [ctypes.c_void_p]
            lib._chunked_bound = True
        self._lib = lib
        self._lock = threading.Lock()
        err = ctypes.c_int(0)
        self._h = lib.mpg123_new(None, ctypes.byref(err))
        if not self._h:
            raise MediaFileError(f"mpg123_new failed (code {err.value})")
        lib.mpg123_format_none(self._h)
        rates = ctypes.POINTER(ctypes.c_long)()
        n_rates = ctypes.c_size_t(0)
        lib.mpg123_rates(ctypes.byref(rates), ctypes.byref(n_rates))
        for i in range(n_rates.value):
            lib.mpg123_format(self._h, rates[i], 3, mp3_io.MPG123_ENC_FLOAT_32)
        if lib.mpg123_open(self._h, str(path).encode()) != mp3_io.MPG123_OK:
            raise MediaFileError(
                f"cannot open {path}: {lib.mpg123_strerror(self._h).decode()}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        lib.mpg123_getformat(self._h, ctypes.byref(rate),
                             ctypes.byref(channels), ctypes.byref(enc))
        lib.mpg123_scan(self._h)  # exact sample count for VBR streams
        self.sample_rate = int(rate.value)
        self.channels = max(channels.value, 1)
        self.frames = max(int(lib.mpg123_length(self._h)), 0)
        self.loops = []

    def read(self, start, count):
        return self._padded(start, count, self._read_valid)

    def _read_valid(self, lo, n):
        lib = self._lib
        ch = self.channels
        with self._lock:
            if lib.mpg123_seek(self._h, lo, 0) < 0:
                return np.zeros((ch, n), np.float32)
            want = n * ch * 4
            buf = (ctypes.c_byte * want)()
            total = 0
            done = ctypes.c_size_t(0)
            while total < want:
                rc = lib.mpg123_read(
                    self._h, ctypes.byref(buf, total), want - total,
                    ctypes.byref(done))
                total += done.value
                if rc not in (0, -11):  # OK / NEW_FORMAT
                    break
        x = np.frombuffer(bytes(bytearray(buf))[:total], np.float32)
        got = len(x) // ch
        out = np.zeros((ch, n), np.float32)
        out[:, :got] = x[:got * ch].reshape(got, ch).T
        return out

    def close(self):
        with self._lock:
            self._lib.mpg123_close(self._h)
            self._lib.mpg123_delete(self._h)


class VorbisChunkedReader(ChunkedReader):
    """libvorbisfile handle kept open; ov_pcm_seek gives sample-accurate
    random access."""

    def __init__(self, path):
        from . import vorbis as vorbis_io
        lib = vorbis_io._load()
        if lib is None:
            raise UnsupportedFormatError(
                f"{path}: no libvorbisfile on this host ({vorbis_io._lib_err})")
        if not hasattr(lib, "_chunked_bound"):
            lib.ov_pcm_seek.restype = ctypes.c_int
            lib.ov_pcm_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib._chunked_bound = True
        self._lib = lib
        self._lock = threading.Lock()
        self._vf = (ctypes.c_byte * vorbis_io._OVF_SIZE)()
        rc = lib.ov_fopen(str(path).encode(), self._vf)
        if rc != 0:
            raise MediaFileError(f"cannot open {path}: ov_fopen error {rc}")
        info = lib.ov_info(self._vf, -1)
        self.channels = info.contents.channels
        self.sample_rate = int(info.contents.rate)
        self.frames = max(int(lib.ov_pcm_total(self._vf, -1)), 0)
        self.loops = []

    def read(self, start, count):
        return self._padded(start, count, self._read_valid)

    def _read_valid(self, lo, n):
        lib = self._lib
        ch = self.channels
        out = np.zeros((ch, n), np.float32)
        with self._lock:
            if lib.ov_pcm_seek(self._vf, lo) != 0:
                return out
            pcm = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))()
            bitstream = ctypes.c_int(0)
            got = 0
            while got < n:
                r = lib.ov_read_float(self._vf, ctypes.byref(pcm), n - got,
                                      ctypes.byref(bitstream))
                if r <= 0:
                    break
                for c in range(ch):
                    out[c, got:got + r] = np.ctypeslib.as_array(
                        pcm[c], shape=(r,))
                got += r
        return out

    def close(self):
        with self._lock:
            self._lib.ov_clear(self._vf)


class AlacChunkedReader(ChunkedReader):
    """Seekable m4a/ALAC: the MP4 sample tables (stsz/stsc/stco) give the
    byte offset of every packet and each ALAC packet decodes independently
    (no inter-frame prediction), so random access = fetch + decode only the
    packets covering the request.  Only the packet index stays resident;
    packet bytes are re-read from the open file on demand (reference decode
    path: src/source/file/decoder.rs via symphonia's alac + isomp4)."""

    def __init__(self, path):
        import mmap

        from .alac import AlacCookie, decode_packet, parse_m4a_index
        self._path = Path(path)
        self._decode = decode_packet
        self._f = open(self._path, "rb")
        # mmap for the box walk: parsing touches only moov/sample-table
        # pages (OS page cache), never faulting in the mdat audio payload —
        # RSS stays O(tables) even for multi-GB files
        try:
            data = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):  # zero-length or exotic fs
            data = self._path.read_bytes()
        self._cookie, self._index = parse_m4a_index(data)
        if hasattr(data, "close"):
            data.close()
        if not self._index:
            raise MediaFileError(f"{path}: no ALAC packets")
        self._lock = threading.Lock()
        c = self._cookie
        self.sample_rate = int(c.sample_rate)
        self.channels = int(c.num_channels)
        self.loops = []
        self._fl = max(int(c.frame_length), 1)
        self._scale = np.float32(1.0 / (1 << (c.bit_depth - 1)))
        # packets run frame_length samples except the (possibly short) last
        last = self._decode_at(len(self._index) - 1)
        self._last_n = last.shape[1]
        self.frames = (len(self._index) - 1) * self._fl + self._last_n

    def _decode_at(self, pi: int) -> np.ndarray:
        off, size = self._index[pi]
        with self._lock:
            self._f.seek(off)
            raw = self._f.read(size)
        return self._decode(self._cookie, raw)

    def read(self, start, count):
        return self._padded(start, count, self._read_valid)

    def _read_valid(self, lo, n):
        out = np.zeros((self.channels, n), np.float32)
        p0 = lo // self._fl
        p1 = min((lo + n - 1) // self._fl, len(self._index) - 1)
        for pi in range(p0, p1 + 1):
            x = self._decode_at(pi)
            pstart = pi * self._fl
            a = max(lo, pstart)
            b = min(lo + n, pstart + x.shape[1])
            if b > a:
                out[:, a - lo:b - lo] = \
                    x[:, a - pstart:b - pstart].astype(np.float32) * self._scale
        return out

    def close(self):
        self._f.close()


class FullDecodeReader(BufferReader):
    """Fallback for plugin formats without a chunked path: decodes the whole
    file once (the pre-round-3 behavior, O(file) host memory)."""

    def __init__(self, path):
        from .decoder import decode_file
        data, info = decode_file(path)
        super().__init__(data, info.sample_rate, info.loops)


class CachedReader(ChunkedReader):
    """Bounded LRU of decoded chunks over any ChunkedReader + vectorized
    ``gather`` for the streamed source's arbitrary (loop-folded) index
    windows.  Resident decode memory <= chunk_frames * max_chunks * ch * 4
    bytes (the analog of the reference's fixed 128 Ki-sample ring,
    streamed.rs:522-524)."""

    def __init__(self, inner: ChunkedReader, chunk_frames: int = 65536,
                 max_chunks: int = 16):
        self.inner = inner
        self.sample_rate = inner.sample_rate
        self.channels = inner.channels
        self.frames = inner.frames
        self.loops = inner.loops
        self.chunk_frames = int(chunk_frames)
        self.max_chunks = max(int(max_chunks), 2)
        self._chunks: OrderedDict[int, np.ndarray] = OrderedDict()
        self._lock = threading.Lock()
        self.decoded_chunk_fetches = 0  # observability / tests

    @property
    def resident_frames(self) -> int:
        return len(self._chunks) * self.chunk_frames

    def _chunk(self, cid: int) -> np.ndarray:
        with self._lock:
            c = self._chunks.get(cid)
            if c is not None:
                self._chunks.move_to_end(cid)
                return c
        data = self.inner.read(cid * self.chunk_frames, self.chunk_frames)
        with self._lock:
            self.decoded_chunk_fetches += 1
            self._chunks[cid] = data
            self._chunks.move_to_end(cid)
            while len(self._chunks) > self.max_chunks:
                self._chunks.popitem(last=False)
        return data

    def read(self, start, count):
        out = np.zeros((self.channels, count), np.float32)
        lo = max(start, 0)
        hi = min(start + count, self.frames)
        pos = lo
        while pos < hi:
            cid = pos // self.chunk_frames
            coff = pos - cid * self.chunk_frames
            n = min(self.chunk_frames - coff, hi - pos)
            out[:, pos - start:pos - start + n] = \
                self._chunk(cid)[:, coff:coff + n]
            pos += n
        return out

    def gather(self, idx: np.ndarray) -> np.ndarray:
        """Decoded samples at arbitrary frame indices (int array); out-of-
        range indices give zeros.  Groups by chunk so a loop-folded window
        costs one cache lookup per touched chunk."""
        idx = np.asarray(idx, np.int64)
        out = np.zeros((self.channels, idx.shape[0]), np.float32)
        valid = (idx >= 0) & (idx < self.frames)
        if not valid.any():
            return out
        cids = np.where(valid, idx // self.chunk_frames, -1)
        for cid in np.unique(cids[valid]):
            m = cids == cid
            out[:, m] = self._chunk(int(cid))[:, idx[m] - cid * self.chunk_frames]
        return out

    def close(self):
        self.inner.close()


def open_chunked(path, chunk_frames: int = 65536,
                 max_chunks: int = 16) -> CachedReader:
    """Open any supported file for incremental decode (sniffing like
    io/decoder.decode_file)."""
    from .decoder import _sniff_format, _DECODERS
    p = Path(path)
    fmt = _sniff_format(p)
    if fmt in _DECODERS:
        inner = FullDecodeReader(p)
    elif fmt == "wav":
        inner = WavChunkedReader(p)
    elif fmt == "aiff":
        inner = AiffChunkedReader(p)
    elif fmt == "flac":
        inner = FlacChunkedReader(p)
    elif fmt == "mp3":
        inner = Mpg123ChunkedReader(p)
    elif fmt == "ogg":
        inner = VorbisChunkedReader(p)
    elif fmt == "m4a":
        inner = AlacChunkedReader(p)
    else:
        raise UnsupportedFormatError(
            f"{p}: format '{fmt}' has no built-in decoder; register one "
            f"with phonic_tpu.io.register_decoder({fmt!r}, fn)")
    return CachedReader(inner, chunk_frames, max_chunks)
