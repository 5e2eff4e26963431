"""In-process mp3 decode through libmpg123 (ctypes), with no ffmpeg.

Port of the decode half of ``birdsoundclassif_tpu/audio/mp3.py``. The
reference reads mp3 with librosa.load, which hands it to audioread and
ffmpeg (reference: nbm_datasets/prepare_dataset.py:160-184); this binds the
system's libmpg123 directly, so ``.mp3`` recordings go through the same
``load_audio_raw`` as ``.wav`` with no subprocess and no temporary file.
audio/wavio.py falls back to ffmpeg when the library is missing.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Tuple

import numpy as np

# mpg123.h constants
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_ENC_SIGNED_16 = 0xD0

_mpg123_lib = None


def _load_mpg123():
    global _mpg123_lib
    if _mpg123_lib is None:
        name = ctypes.util.find_library("mpg123") or "libmpg123.so.0"
        lib = ctypes.CDLL(name)
        lib.mpg123_init()
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.mpg123_getformat.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
        lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                                      ctypes.c_int]
        lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_size_t)]
        lib.mpg123_close.argtypes = [ctypes.c_void_p]
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        lib.mpg123_strerror.restype = ctypes.c_char_p
        lib.mpg123_strerror.argtypes = [ctypes.c_void_p]
        _mpg123_lib = lib
    return _mpg123_lib


def mpg123_available() -> bool:
    try:
        _load_mpg123()
        return True
    except OSError:
        return False


def decode_mp3(path: str) -> Tuple[np.ndarray, int]:
    """Decode an mp3 file to (float32 samples (n, channels), sample_rate).

    The output is pinned to the stream's own rate and channels as signed
    16-bit (mp3 carries no more than 16 bits), scaled to [-1, 1) as the wav
    PCM16 path scales it (audio/wavio.py). Raises RuntimeError on input it
    cannot decode.
    """
    lib = _load_mpg123()
    err = ctypes.c_int(0)
    mh = lib.mpg123_new(None, ctypes.byref(err))
    if not mh:
        raise RuntimeError(f"mpg123_new failed (err={err.value})")
    try:
        if lib.mpg123_open(mh, path.encode()) != _MPG123_OK:
            raise RuntimeError(f"mpg123_open: {lib.mpg123_strerror(mh).decode()}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        if lib.mpg123_getformat(mh, ctypes.byref(rate), ctypes.byref(channels),
                                ctypes.byref(encoding)) != _MPG123_OK:
            raise RuntimeError(f"mpg123_getformat: {lib.mpg123_strerror(mh).decode()}")
        # pin the output format so that a format change mid-stream cannot
        # tear the sample buffer
        lib.mpg123_format_none(mh)
        if lib.mpg123_format(mh, rate.value, channels.value,
                             _MPG123_ENC_SIGNED_16) != _MPG123_OK:
            raise RuntimeError(f"mpg123_format: {lib.mpg123_strerror(mh).decode()}")
        chunks = []
        buf = ctypes.create_string_buffer(1 << 18)
        done = ctypes.c_size_t(0)
        while True:
            rc = lib.mpg123_read(mh, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(buf.raw[: done.value])
            if rc == _MPG123_DONE:
                break
            if rc != _MPG123_OK:
                raise RuntimeError(f"mpg123_read: {lib.mpg123_strerror(mh).decode()}")
        if not chunks:
            raise RuntimeError(f"no audio decoded from {path}")
        raw = np.frombuffer(b"".join(chunks), "<i2")
        n = (len(raw) // channels.value) * channels.value
        x = raw[:n].astype(np.float32).reshape(-1, channels.value) / 32768.0
        return x, int(rate.value)
    finally:
        lib.mpg123_close(mh)
        lib.mpg123_delete(mh)
