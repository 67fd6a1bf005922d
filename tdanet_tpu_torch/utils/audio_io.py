"""WAV I/O on scipy alone (counterpart of ``tdanet_tpu/utils/audio_io.py``,
which cannot be imported where JAX is absent). Reads PCM16/24/32 and
float32 as float32 in [-1, 1]."""

from __future__ import annotations

import os

import numpy as np
from scipy.io import wavfile as _wavfile

_PCM_SCALE = {np.dtype(np.int16): 1 << 15,
              np.dtype(np.int32): 1 << 31,
              np.dtype(np.uint8): 1 << 7}


def read_wav(path, start=0, stop=None, dtype="float32"):
    """Returns (data[T] or [T, C] float32 in [-1, 1], sample_rate)."""
    sr, data = _wavfile.read(path)
    if data.dtype in _PCM_SCALE:
        scale = _PCM_SCALE[data.dtype]
        if data.dtype == np.uint8:
            data = data.astype(np.float32) - 128.0
        data = np.asarray(data, np.float32) / scale
    else:
        data = np.asarray(data, np.float32)
    data = data[start:stop]
    return data.astype(dtype, copy=False), sr


def wav_frames(path) -> int:
    """Number of frames, from the header where the ``wave`` module reads
    it (PCM), else by decoding the file (float WAV)."""
    import wave
    try:
        with wave.open(path, "rb") as w:
            return w.getnframes()
    except (wave.Error, EOFError):
        return read_wav(path)[0].shape[0]


def write_wav(path, data, sample_rate, subtype="float32"):
    """Write mono/stereo float32 (or int16 when subtype='pcm16')."""
    data = np.asarray(data)
    if data.ndim == 2 and data.shape[0] < data.shape[1]:
        data = data.T  # (C, T) -> (T, C)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if subtype == "pcm16":
        data = (np.clip(data, -1.0, 1.0) * 32767.0).astype(np.int16)
    else:
        data = data.astype(np.float32)
    _wavfile.write(path, sample_rate, data)
