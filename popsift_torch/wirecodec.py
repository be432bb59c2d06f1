"""Lossless image wire codec: host-side numpy encode, PyTorch decode on the
buffer's device.

The codec was made for a deployment whose accelerator sits behind a slow
remote link (25-35 MB/s), where a 1080p u8 frame costs more wire time than
its whole extraction (popsift_tpu/wirecodec.py:1-10).  On a card over PCIe
the raw upload of a frame is cheaper than the numpy encode, and the codec
is lossless, so :class:`popsift_torch.PopSift` uploads raw and does not
call this module; it is here for a caller whose frames cross such a link.

Scheme (E2v2/E2v3, popsift_tpu/wirecodec.py:10-41): the residual is the
mod-256 second difference
d2[y,x] = img[y,x] - img[y,x-1] - img[y-1,x] + img[y-1,x-1] (zeros outside
the image), so decoding is two mod-256 cumulative sums.  One of three
schemes is chosen per image, whichever gives the fewest bytes:

* ``bits`` = 2: codes {0, +1, -1, escape} for every pixel, escapes append
  the raw residual byte to an escape stream;
* ``bits`` = 4: zigzagged residuals 0..14 inline, 15 = escape;
* ``bits`` = 1: a 1-bit nonzero bitmap (LSB first within each byte), then
  2-bit codes {+1, -1, escape} for the nonzero residuals only.

Wire layout: a 16-byte header (magic, escape count, scheme) | payload |
escape bytes | zero pad to a 64 KiB bucket.  The encoder returns None when
no scheme beats the raw byte count (high-entropy content): the caller
uploads raw.

The JAX package encodes through a native extension where it is built
(``encode_e2v2`` in cpp/host_native.cpp).  That encoder is not ported:
on some of the 1080p benchmark scenes (seeds 0-3) its buffers decode to
images with up to 1.8M of the 2,073,600 pixels wrong, from the first row
of one of its 68-row chunks on, and which scenes it spoils changes from
one process to the next.  This module encodes with its own copy of the
JAX package's numpy encoder only.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

_HEADER_BYTES = 16
# the JAX decoder is compiled per bucketed length; the bucket is kept so
# that the port's buffers are the JAX package's byte for byte
_BUCKET = 64 * 1024
_MAGIC = 0x50C0DEC2
_ESC4 = 15
# images with fewer pixels are uploaded raw
_MIN_CODEC_PIXELS = 64 * 1024


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _residual2(img: np.ndarray) -> np.ndarray:
    """Mod-256 second difference (uint8 wraparound arithmetic)."""
    dy = img.copy()
    dy[1:] -= img[:-1]
    d2 = dy.copy()
    d2[:, 1:] -= dy[:, :-1]
    return d2


def encode_u8(img: np.ndarray) -> np.ndarray | None:
    """Encode a (h, w) u8 image into one u8 wire buffer
    (popsift_tpu/wirecodec.py:79-87, numpy only).

    Returns None when no scheme would beat the raw upload (high-entropy
    content): callers should then upload raw."""
    return _encode_u8_numpy(img)


def encode_u8_digest(img: np.ndarray) -> tuple[np.ndarray | None, bytes]:
    """:func:`encode_u8` and a 16-byte content digest of the image,
    blake2b of its bytes (popsift_tpu/wirecodec.py:90-100, the numpy
    branch)."""
    return (_encode_u8_numpy(img),
            hashlib.blake2b(img.tobytes(), digest_size=16).digest())


def _encode_u8_numpy(img: np.ndarray) -> np.ndarray | None:
    """The encoder (popsift_tpu/wirecodec.py:103-163): the same bytes as
    the JAX package's ``_encode_u8_numpy`` for every input."""
    h, w = img.shape
    total = h * w
    d2 = _residual2(img).reshape(-1)

    # choose the scheme with the smaller payload
    esc2_mask = (d2 > 1) & (d2 < 255)
    n_esc2 = int(esc2_mask.sum())
    s = d2.view(np.int8).astype(np.int16)
    zig = ((s << 1) ^ (s >> 15)).astype(np.uint8)
    esc4_mask = zig >= _ESC4
    n_esc4 = int(esc4_mask.sum())
    nz_mask = d2 != 0
    n_nz = int(nz_mask.sum())

    pay2 = _HEADER_BYTES + _ceil_to(total, 4) // 4 + n_esc2
    pay4 = _HEADER_BYTES + _ceil_to(total, 2) // 2 + n_esc4
    pay3 = (_HEADER_BYTES + _ceil_to(total, 8) // 8
            + _ceil_to(max(n_nz, 1), 4) // 4 + n_esc2)
    if min(pay2, pay4, pay3) >= total:
        return None

    if pay3 <= min(pay2, pay4):
        bits, n_esc = 1, n_esc2
        bm = np.packbits(nz_mask.view(np.uint8), bitorder="little")
        dnz = d2[nz_mask]
        # nonzero codes: +1 -> 1, -1 -> 2, escape -> 3 (code 0 unused)
        cnz = np.where(dnz == 1, 1,
                       np.where(dnz == 255, 2, 3)).astype(np.uint8)
        e_bytes = d2[esc2_mask]
        c = np.pad(cnz, (0, _ceil_to(max(n_nz, 1), 4) - n_nz))
        stream = np.concatenate([
            bm,
            (c[0::4] | (c[1::4] << 2) | (c[2::4] << 4)
             | (c[3::4] << 6)).astype(np.uint8)])
    elif pay2 <= pay4:
        bits, n_esc = 2, n_esc2
        # codes: 0 -> 0, +1 -> 1, -1 -> 2, escape -> 3
        codes = np.where(d2 == 0, 0,
                         np.where(d2 == 1, 1,
                                  np.where(d2 == 255, 2, 3))) \
            .astype(np.uint8)
        e_bytes = d2[esc2_mask]
        c = np.pad(codes, (0, _ceil_to(total, 4) - total))
        stream = (c[0::4] | (c[1::4] << 2) | (c[2::4] << 4)
                  | (c[3::4] << 6)).astype(np.uint8)
    else:
        bits, n_esc = 4, n_esc4
        nib = np.where(esc4_mask, np.uint8(_ESC4), zig)
        e_bytes = d2[esc4_mask]
        c = np.pad(nib, (0, _ceil_to(total, 2) - total))
        stream = (c[0::2] | (c[1::2] << 4)).astype(np.uint8)

    header = np.zeros(_HEADER_BYTES // 4, np.uint32)
    header[0] = _MAGIC
    header[1] = n_esc
    header[2] = bits
    buf = np.concatenate([header.view(np.uint8), stream, e_bytes])
    out = np.zeros(_ceil_to(buf.size, _BUCKET), np.uint8)
    out[:buf.size] = buf
    return out


def _gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` with every index clamped into ``src``, as the JAX
    decoder clips each gather (jnp.clip(..., 0, len - 1))."""
    return src[idx.clamp(0, src.shape[0] - 1).long()]


def _cumsum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    # int32 as in JAX; torch.cumsum of an integer tensor is int64 otherwise
    return torch.cumsum(x, dim, dtype=torch.int32)


def decode_u8(buf: torch.Tensor, h: int, w: int, bits: int) -> torch.Tensor:
    """Decode a u8 wire buffer to a (h, w) u8 image on the buffer's device
    (popsift_tpu/wirecodec.py:166-239), bit for bit as the JAX decoder
    does, also on a corrupt buffer: every gather index is clamped into the
    buffer, and for 2 and 4 bits the escape pool is zero-padded to
    max(total // 2, len - offset) bytes.  The nonzero count stays on the
    device.  ``bits`` other than 1, 2 and 4 raises ValueError."""
    if bits not in (1, 2, 4):
        raise ValueError(f"wire codec scheme bits={bits}: not 1, 2 or 4")
    total = h * w
    b = buf.to(torch.int32)           # widened before any shift
    dev = b.device

    if bits == 1:
        # bitmap of nonzeros, then 2-bit codes of the nonzeros; the code
        # stream's length depends on the nonzero count, so the escapes
        # are gathered at offsets computed on the device
        code_off = _HEADER_BYTES + _ceil_to(total, 8) // 8
        bm = b[_HEADER_BYTES:code_off]
        shifts = torch.arange(8, dtype=torch.int32, device=dev)
        b8 = ((bm[:, None] >> shifts) & 1).reshape(-1)[:total]
        csum = _cumsum(b8)
        r = csum - 1                                  # rank among nonzeros
        nz = csum[-1]
        code = (_gather(b, code_off + (r >> 2)) >> (2 * (r & 3))) & 3
        inline = torch.where(code == 2, 255, code)    # +1 -> 1, -1 -> 255
        esc = (b8 == 1) & (code == 3)
        e_off = code_off + torch.div(nz + 3, 4, rounding_mode="floor")
        evals = _gather(b, e_off + _cumsum(esc) - 1)
        d2 = torch.where(b8 == 0, 0, torch.where(esc, evals, inline))
    else:
        per_byte = 8 // bits
        e_off = _HEADER_BYTES + _ceil_to(total, per_byte) // per_byte
        e_cap = max(total // 2, b.shape[0] - e_off)
        # zero pad so the full-capacity escape pool is in range
        bp = torch.nn.functional.pad(
            b, (0, max(0, e_off + e_cap - b.shape[0])))
        stream = bp[_HEADER_BYTES:e_off]
        if bits == 2:
            shifts = torch.arange(0, 8, 2, dtype=torch.int32, device=dev)
            codes = ((stream[:, None] >> shifts) & 3).reshape(-1)[:total]
            esc = codes == 3
            # inline values: 0 -> 0, 1 -> +1, 2 -> -1 (mod 256: 255)
            inline = torch.where(codes == 2, 255, codes)
        else:
            nib = torch.stack([stream & 15, stream >> 4], -1) \
                .reshape(-1)[:total]
            esc = nib == _ESC4
            # un-zigzag, signed until the final mod 256
            inline = torch.where((nib & 1) == 1, -((nib + 1) >> 1),
                                 nib >> 1) & 255
        # escape bytes in scan order: rank among escapes
        evals = _gather(bp[e_off:e_off + e_cap], _cumsum(esc) - 1)
        d2 = torch.where(esc, evals, inline)

    # invert the second-difference prediction: two mod-256 cumsums
    dy = _cumsum(d2.reshape(h, w), 1) & 255
    return (_cumsum(dy, 0) & 255).to(torch.uint8)


def upload_image_u8(img: np.ndarray, device="cuda") -> torch.Tensor:
    """The (h, w) image on ``device`` (popsift_tpu/wirecodec.py:242-255):
    through the codec (host encode, copy of the buffer, decode on
    ``device``) when the image is u8 of at least 64 Ki pixels and the
    encoder gives a buffer; uploaded raw otherwise."""
    if img.dtype != np.uint8 or img.size < _MIN_CODEC_PIXELS:
        return torch.as_tensor(np.ascontiguousarray(img)).to(device)
    buf = encode_u8(img)
    if buf is None:
        return torch.as_tensor(np.ascontiguousarray(img)).to(device)
    h, w = img.shape
    bits = int(buf[:_HEADER_BYTES].view(np.uint32)[2])
    return decode_u8(torch.from_numpy(buf).to(device), h, w, bits)


__all__ = ["encode_u8", "encode_u8_digest", "decode_u8", "upload_image_u8"]
