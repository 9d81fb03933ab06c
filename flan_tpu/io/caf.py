"""Apple Core Audio Format (.caf) codec for linear PCM (pure Python).

The reference reads and writes every libsndfile format
(reference: src/flan/Audio/AudioBuffer.cpp:86-117); SURVEY.md blesses a
host-side codec boundary of the library. CAF is a 64-bit chunked
container: a "caff" file header, then chunks of (big-endian 4cc,
int64 size). The 'desc' chunk is an AudioStreamBasicDescription
(float64 sample rate, 4cc format id, format flags, packet/frame/channel
layout, bits per channel); the 'data' chunk is a 4-byte edit count
followed by the sound bytes, with size -1 meaning "to end of file"
(the streaming-write convention).

Only format id 'lpcm' is handled: integer PCM 8/16/24/32 and IEEE
float32/64, either endianness (flag bit0 = float, bit1 = little-endian).
Scaling conventions match flan_tpu/io/wav.py (2^(bits-1) full scale;
CAF integer PCM is signed at every depth, including 8-bit).
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_FLAG_FLOAT = 1 << 0
_FLAG_LITTLE_ENDIAN = 1 << 1


def _decode_lpcm(raw: bytes, bits: int, nch: int, is_float: bool,
                 little: bool) -> np.ndarray:
    order = "<" if little else ">"
    if is_float:
        if bits == 32:
            x = np.frombuffer(raw, dtype=order + "f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(raw, dtype=order + "f8").astype(np.float32)
        else:
            raise ValueError(f"Unsupported CAF float depth: {bits}")
    elif bits == 8:
        x = np.frombuffer(raw, dtype=np.int8).astype(np.float32) / 128.0
    elif bits == 16:
        x = np.frombuffer(raw, dtype=order + "i2").astype(
            np.float32) / 32768.0
    elif bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8)
        n = len(b) // 3
        b = b[: n * 3].reshape(n, 3)
        if little:
            b = b[:, ::-1]
        vals = ((b[:, 0].astype(np.int32) << 16)
                | (b[:, 1].astype(np.int32) << 8)
                | b[:, 2].astype(np.int32))
        vals = np.where(vals >= (1 << 23), vals - (1 << 24), vals)
        x = vals.astype(np.float32) / float(1 << 23)
    elif bits == 32:
        x = np.frombuffer(raw, dtype=order + "i4").astype(
            np.float32) / float(1 << 31)
    else:
        raise ValueError(f"Unsupported CAF bit depth: {bits}")
    num_frames = len(x) // nch
    x = x[: num_frames * nch].reshape(num_frames, nch)
    return np.ascontiguousarray(x.T)


def read_caf(path: str) -> Tuple[np.ndarray, float]:
    """.caf file -> (float32 [channels, frames], sample_rate)."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 8 or blob[:4] != b"caff":
        raise ValueError(f"{path}: not a CAF file")
    pos = 8                               # caff + version/flags
    desc = None
    data = None
    while pos + 12 <= len(blob):
        cid = blob[pos:pos + 4]
        size = struct.unpack(">q", blob[pos + 4:pos + 12])[0]
        body_start = pos + 12
        if size == -1:                    # streaming write: to EOF
            body = blob[body_start:]
            pos = len(blob)
        elif size < 0:                    # malformed: would loop forever
            raise ValueError(f"{path}: malformed CAF chunk size {size}")
        else:
            body = blob[body_start:body_start + size]
            pos = body_start + size
        if cid == b"desc":
            sr, fmt, flags, _bpp, _fpp, nch, bits = struct.unpack(
                ">d4sIIIII", body[:32])
            desc = (sr, fmt, flags, nch, bits)
        elif cid == b"data":
            data = body[4:]               # skip the edit-count field
    if desc is None or data is None:
        raise ValueError(f"{path}: missing desc or data chunk")
    sr, fmt, flags, nch, bits = desc
    if fmt != b"lpcm":
        raise ValueError(f"{path}: unsupported CAF format {fmt!r}")
    x = _decode_lpcm(data, bits, max(nch, 1), bool(flags & _FLAG_FLOAT),
                     bool(flags & _FLAG_LITTLE_ENDIAN))
    return x, float(sr)


def write_caf(path: str, data: np.ndarray, sample_rate: float,
              bits: int = 0) -> None:
    """float32 [channels, frames] -> .caf 'lpcm'.

    bits: 0 (default) writes lossless little-endian float32, mirroring
    save_to_file's float32-WAV default; 16/24/32 write little-endian
    integer PCM with the WAV codec's scale/clamp conventions.
    """
    data = np.asarray(data, np.float32)
    nch, _ = data.shape
    interleaved = np.ascontiguousarray(data.T)
    if bits == 0:
        flags = _FLAG_FLOAT | _FLAG_LITTLE_ENDIAN
        depth = 32
        body = interleaved.astype("<f4").tobytes()
    else:
        flags = _FLAG_LITTLE_ENDIAN
        depth = bits
        clipped = np.clip(interleaved, -1.0, 1.0)
        if bits == 16:
            body = np.clip(np.round(clipped * 32768.0), -32768,
                           32767).astype("<i2").tobytes()
        elif bits == 24:
            q = np.clip(np.round(clipped * float(1 << 23)), -(1 << 23),
                        (1 << 23) - 1).astype(np.int32).reshape(-1)
            out = np.empty((q.size, 3), np.uint8)
            out[:, 0] = q & 0xFF
            out[:, 1] = (q >> 8) & 0xFF
            out[:, 2] = (q >> 16) & 0xFF
            body = out.tobytes()
        elif bits == 32:
            # float64 clamp: 2^31-1 is unrepresentable in float32 (see
            # io/wav.py's documented full-scale sign-flip pitfall)
            body = np.clip(np.round(clipped.astype(np.float64)
                                    * float(1 << 31)),
                           -(2.0 ** 31), (1 << 31) - 1).astype(
                "<i4").tobytes()
        else:
            raise ValueError(f"Unsupported CAF write bit depth: {bits}")
    bytes_per_frame = nch * depth // 8
    desc = struct.pack(">d4sIIIII", float(sample_rate), b"lpcm", flags,
                       bytes_per_frame, 1, nch, depth)
    with open(path, "wb") as f:
        f.write(b"caff" + struct.pack(">HH", 1, 0))
        f.write(b"desc" + struct.pack(">q", len(desc)) + desc)
        f.write(b"data" + struct.pack(">q", 4 + len(body))
                + struct.pack(">I", 0) + body)
