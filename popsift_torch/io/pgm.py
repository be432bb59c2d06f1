"""PGM/PPM image reading and writing, a copy of popsift_tpu.io.pgm.

Parity with the reference's loader (pgmread.{h,cpp}): P2/P5 PGM and P3/P6
PPM, comments in the header, 16-bit samples shifted down by 8, and
RGB->grey conversion with the OpenCV integer coefficients
(4899*R + 9617*G + 1868*B) >> 14 (pgmread.cpp:33-47).  The JAX package
also has a native reader; this copy is its numpy path.
"""

from __future__ import annotations

import numpy as np

RATE_R = 4899
RATE_G = 9617
RATE_B = 1868
RATE_SHIFT = 14


def rgb_to_grey(rgb: np.ndarray) -> np.ndarray:
    """OpenCV integer grey conversion (pgmread.cpp:33-47)."""
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)
    return ((RATE_R * r + RATE_G * g + RATE_B * b) >> RATE_SHIFT).astype(
        np.uint8)


def _read_tokens(data: bytes, count: int, pos: int):
    """Read whitespace/comment-separated ASCII tokens from a PNM header."""
    tokens = []
    n = len(data)
    while len(tokens) < count:
        while pos < n and data[pos:pos + 1].isspace():
            pos += 1
        if pos < n and data[pos:pos + 1] == b"#":
            while pos < n and data[pos:pos + 1] != b"\n":
                pos += 1
            continue
        start = pos
        while pos < n and not data[pos:pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError("truncated PNM header")
        tokens.append(data[start:pos])
    return tokens, pos


def read_pgm(path: str) -> np.ndarray:
    """Read a P2/P5 PGM or P3/P6 PPM into a (H, W) uint8 grey array."""
    with open(path, "rb") as f:
        data = f.read()
    magic = data[:2]
    if magic not in (b"P2", b"P3", b"P5", b"P6"):
        raise ValueError(f"{path}: not a supported PNM file ({magic!r})")
    toks, pos = _read_tokens(data, 3, 2)
    w, h, maxval = (int(t) for t in toks)
    if maxval <= 0 or maxval > 65535:
        raise ValueError(f"{path}: bad maxval {maxval}")
    channels = 3 if magic in (b"P3", b"P6") else 1
    count = w * h * channels

    if magic in (b"P5", b"P6"):
        pos += 1  # single whitespace after maxval
        if maxval < 256:
            arr = np.frombuffer(data, np.uint8, count, pos)
        else:
            arr = (np.frombuffer(data, ">u2", count, pos) >> 8).astype(
                np.uint8)
    else:
        toks, _ = _read_tokens(data, count, pos)
        arr = np.array([int(t) for t in toks], dtype=np.int32)
        if maxval >= 256:
            arr >>= 8
        arr = arr.astype(np.uint8)

    if channels == 3:
        return rgb_to_grey(arr.reshape(h, w, 3))
    return arr.reshape(h, w)


def write_pgm(path: str, img: np.ndarray) -> None:
    """Write a (H, W) uint8 array as binary P5 PGM."""
    img = np.asarray(img, dtype=np.uint8)
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())
