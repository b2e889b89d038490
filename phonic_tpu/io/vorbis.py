"""Ogg/Vorbis decode via the system's libvorbisfile (ctypes, no pip dep).

Behavioural spec: reference src/source/file/decoder.rs — phonic delegates
Vorbis to symphonia (Cargo.toml:46-56); this package delegates to
the host's vorbisfile library (see io/mp3.py for the pattern and rationale).

Output: planar float32 [channels, frames] straight from ov_read_float — no
int16 round trip.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import glob
import os
from pathlib import Path

import numpy as np

from ..errors import MediaFileError, UnsupportedFormatError

# sizeof(OggVorbis_File) is ~944 on LP64 builds; over-allocate generously
_OVF_SIZE = 4096

_lib = None
_lib_err = None


class _VorbisInfo(ctypes.Structure):
    # vorbis_info header (codec.h): only the leading fields are needed
    _fields_ = [
        ("version", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("rate", ctypes.c_long),
        ("bitrate_upper", ctypes.c_long),
        ("bitrate_nominal", ctypes.c_long),
        ("bitrate_lower", ctypes.c_long),
        ("bitrate_window", ctypes.c_long),
        ("codec_setup", ctypes.c_void_p),
    ]


def _candidate_names():
    yield "libvorbisfile.so.3"
    yield "libvorbisfile.so"
    found = ctypes.util.find_library("vorbisfile")
    if found:
        yield found
    for pat in ("/opt/venv/lib/python3.12/site-packages/pygame.libs/libvorbisfile*.so*",):
        for p in sorted(glob.glob(pat)):
            yield p


def _load():
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    last = None
    for name in _candidate_names():
        try:
            lib = ctypes.CDLL(name)
        except OSError as e:
            last = e
            continue
        try:
            lib.ov_fopen.restype = ctypes.c_int
            lib.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
            lib.ov_clear.argtypes = [ctypes.c_void_p]
            lib.ov_info.restype = ctypes.POINTER(_VorbisInfo)
            lib.ov_info.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.ov_pcm_total.restype = ctypes.c_int64
            lib.ov_pcm_total.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.ov_read_float.restype = ctypes.c_long
            lib.ov_read_float.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.POINTER(ctypes.c_float))),
                ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        except AttributeError as e:
            last = e
            continue
        _lib = lib
        return lib
    _lib_err = last or OSError("no libvorbisfile candidates")
    return None


def vorbis_available() -> bool:
    return _load() is not None


def read_vorbis(path) -> tuple[np.ndarray, int]:
    """Decode an Ogg/Vorbis file to (float32 [channels, frames], rate)."""
    lib = _load()
    if lib is None:
        raise UnsupportedFormatError(
            f"{path}: no libvorbisfile found on this host ({_lib_err}); "
            "install libvorbis or register a decoder with "
            "register_decoder('ogg', fn)")
    vf = (ctypes.c_byte * _OVF_SIZE)()
    rc = lib.ov_fopen(str(path).encode(), vf)
    if rc != 0:
        raise MediaFileError(f"cannot open {path}: ov_fopen error {rc} "
                             "(not an Ogg/Vorbis stream?)")
    try:
        info = lib.ov_info(vf, -1)
        if not info:
            raise MediaFileError(f"{path}: ov_info failed")
        channels = info.contents.channels
        rate = int(info.contents.rate)
        if channels <= 0 or rate <= 0:
            raise MediaFileError(f"{path}: invalid stream specs "
                                 f"({channels} ch, {rate} Hz)")
        pcm = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))()
        bitstream = ctypes.c_int(0)
        chunks = []
        while True:
            got = lib.ov_read_float(vf, ctypes.byref(pcm), 4096,
                                    ctypes.byref(bitstream))
            if got == 0:
                break
            if got < 0:  # hole/bad data: skip, like most players
                continue
            block = np.empty((channels, got), np.float32)
            for c in range(channels):
                block[c] = np.ctypeslib.as_array(pcm[c], shape=(got,))
            chunks.append(block)
        if not chunks:
            raise MediaFileError(f"{path}: no audio frames decoded")
        return np.concatenate(chunks, axis=1), rate
    finally:
        lib.ov_clear(vf)
