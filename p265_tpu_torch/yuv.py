"""Planar YUV 4:2:0 file IO + MD5 checksums (SURVEY.md 2: YUV writer/MD5)."""
from __future__ import annotations

import hashlib

import numpy as np


def write_yuv(path: str, frames: list[list[np.ndarray]]) -> None:
    """frames: list of [y, cb, cr] int arrays -> 8-bit planar 4:2:0 file."""
    with open(path, "wb") as f:
        for planes in frames:
            for p in planes:
                f.write(np.asarray(p, dtype=np.uint8).tobytes())


def read_yuv(path: str, w: int, h: int) -> list[list[np.ndarray]]:
    frame_bytes = w * h * 3 // 2
    frames = []
    with open(path, "rb") as f:
        data = f.read()
    n = len(data) // frame_bytes
    for i in range(n):
        off = i * frame_bytes
        y = np.frombuffer(data, np.uint8, w * h, off).reshape(h, w)
        cb = np.frombuffer(data, np.uint8, w * h // 4, off + w * h
                           ).reshape(h // 2, w // 2)
        cr = np.frombuffer(data, np.uint8, w * h // 4, off + w * h * 5 // 4
                           ).reshape(h // 2, w // 2)
        frames.append([y.astype(np.int32), cb.astype(np.int32),
                       cr.astype(np.int32)])
    return frames


def frame_md5(planes: list[np.ndarray]) -> str:
    m = hashlib.md5()
    for p in planes:
        m.update(np.asarray(p, dtype=np.uint8).tobytes())
    return m.hexdigest()


def sequence_md5(frames: list[list[np.ndarray]]) -> str:
    m = hashlib.md5()
    for planes in frames:
        for p in planes:
            m.update(np.asarray(p, dtype=np.uint8).tobytes())
    return m.hexdigest()
