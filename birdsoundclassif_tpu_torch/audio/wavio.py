"""Host-side audio decode: dependency-free RIFF/WAV parser, mp3 and
ffmpeg decode, resampling.

Port of ``birdsoundclassif_tpu/audio/wavio.py``, which replaces the
reference's librosa.load + ffmpeg pair (reference:
prepare_dataset.py:160-184). PCM 8/16/24/32 and IEEE float wavs are parsed
in Python, ``.mp3`` is decoded in-process by libmpg123 (audio/mp3.py) or
else by an ffmpeg subprocess, every other extension by ffmpeg. Channels
are averaged to mono as librosa.to_mono does, and off-rate files are
resampled with scipy.signal.resample_poly. Mono PCM16 at the target rate
stays int16 and is scaled by 1/32768 in the front-end. The JAX package's
optional C++ wav reader (native/wav.py) is not ported.
"""

from __future__ import annotations

import math
import os
import shutil
import struct
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np


class AudioDecodeError(RuntimeError):
    pass


def _chunks(data: bytes):
    """(fmt tuple or None, raw data bytes or None) of a RIFF/WAVE file."""
    pos = 12
    fmt = raw = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    return fmt, raw


def _parse_wav(data: bytes) -> Tuple[np.ndarray, int]:
    """bytes -> (float32 samples (n, channels), sample_rate)."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise AudioDecodeError("not a RIFF/WAVE file")
    fmt, raw = _chunks(data)
    if fmt is None or raw is None:
        raise AudioDecodeError("missing fmt/data chunk")
    audio_format, channels, sr, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = 1 if bits in (8, 16, 24, 32) else 3
    if audio_format == 1:  # integer PCM
        if bits == 8:
            x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            i = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            i = np.where(i >= 1 << 23, i - (1 << 24), i)
            x = i.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(raw, "<i4").astype(np.float32) / float(1 << 31)
        else:
            raise AudioDecodeError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(raw, "<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(raw, "<f8").astype(np.float32)
        else:
            raise AudioDecodeError(f"unsupported float bit depth {bits}")
    else:
        raise AudioDecodeError(f"unsupported WAV format tag {audio_format}")
    n = (len(x) // channels) * channels
    return x[:n].reshape(-1, channels), sr


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """(mono float32, native sample rate); multi-channel is mean-downmixed."""
    with open(path, "rb") as f:
        x, sr = _parse_wav(f.read())
    mono = x.mean(axis=1) if x.shape[1] > 1 else x[:, 0]
    return np.ascontiguousarray(mono, dtype=np.float32), sr


def resample(x: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling to target_sr."""
    if sr == target_sr:
        return x
    from scipy.signal import resample_poly

    g = math.gcd(sr, target_sr)
    return resample_poly(x, target_sr // g, sr // g).astype(np.float32)


def _decode_via_ffmpeg(path: str, target_sr: int) -> Tuple[np.ndarray, int]:
    """(mono float32, target_sr) through ffmpeg to a temporary PCM16 wav."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise AudioDecodeError(f"cannot decode {path}: ffmpeg not available")
    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as tmp:
        tmp_path = tmp.name
    try:
        subprocess.run(
            [ffmpeg, "-y", "-i", path, "-async", "1", "-ac", "1", "-vn",
             "-acodec", "pcm_s16le", "-ar", str(target_sr), tmp_path],
            check=True, capture_output=True,
        )
        return read_wav(tmp_path)
    finally:
        os.unlink(tmp_path)


def read_wav_int16(path: str) -> Optional[Tuple[np.ndarray, int]]:
    """(int16 mono, sr) when the file is mono PCM16, else None."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        return None
    fmt, raw = _chunks(data)
    if fmt is None or raw is None:
        return None
    audio_format, channels, sr, _, _, bits = fmt
    if audio_format != 1 or bits != 16 or channels != 1:
        return None
    return np.frombuffer(raw, "<i2"), int(sr)


def load_audio_raw(path: str, target_sr: int = 44_100) -> Optional[np.ndarray]:
    """Mono samples at target_sr: int16 for mono PCM16 wav at the target
    rate, else float32. ``.wav`` is parsed here; ``.mp3`` goes to libmpg123
    first and to ffmpeg when the library is missing; anything else to
    ffmpeg. Returns None when the file cannot be decoded (the reference
    prints and skips unreadable files: prepare_dataset.py:160-165)."""
    try:
        if path.lower().endswith(".wav"):
            i16 = read_wav_int16(path)
            if i16 is not None and i16[1] == target_sr:
                return i16[0]
            x, sr = read_wav(path)
        elif path.lower().endswith(".mp3"):
            from .mp3 import decode_mp3, mpg123_available

            if mpg123_available():
                stereo, sr = decode_mp3(path)
                x = stereo.mean(axis=1) if stereo.shape[1] > 1 else stereo[:, 0]
            else:
                x, sr = _decode_via_ffmpeg(path, target_sr)
        else:
            x, sr = _decode_via_ffmpeg(path, target_sr)
        return resample(x, sr, target_sr)
    except (OSError, ValueError, ArithmeticError, IndexError, struct.error, RuntimeError,
            subprocess.SubprocessError) as e:
        print(f"File loading failed: {path}: {e}")
        return None
