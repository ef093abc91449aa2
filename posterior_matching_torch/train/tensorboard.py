"""TensorBoard event files, written without tensorboard or tensorboardX.

The JAX package logs through tensorboardX's ``SummaryWriter``
(``posterior_matching_tpu/train/callbacks.py:44-65``); the port writes the
same files by hand, with only the standard library and numpy:

- a file ``events.out.tfevents.<unix time>.<host>`` in the log directory,
  opened with the ``file_version: "brain.Event:2"`` event that starts every
  event file;
- each event framed as a TFRecord: the data's length as a little-endian
  uint64, the masked CRC32C of those 8 bytes, the data, the masked CRC32C
  of the data (CRC32C, the Castagnoli polynomial, from a table);
- the data an ``Event`` protobuf (``wall_time`` = 1, ``step`` = 2,
  ``file_version`` = 3, ``summary`` = 5) encoded by hand; a ``Summary``
  holds ``Value``s (``tag`` = 1, ``simple_value`` = 2, ``image`` = 4), an
  ``Image`` its ``height`` = 1, ``width`` = 2, ``colorspace`` = 3 and the
  PNG bytes, ``encoded_image_string`` = 4;
- an image batch (``[N, H, W, C]`` in [0, 1]) laid out as tensorboardX's
  ``add_images(..., dataformats="NHWC")`` lays it out: grey to RGB, up to 8
  images a row on a zero canvas, times 255 truncated to uint8, one 8-bit RGB
  PNG (``zlib`` and ``struct``).
"""
from __future__ import annotations

import os
import socket
import struct
import time
import zlib
from typing import Optional

import numpy as np


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    crc, table = 0xFFFFFFFF, _CRC32C_TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """The TFRecord checksum: CRC32C rotated right by 15 bits plus a
    constant."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def record(data: bytes) -> bytes:
    """``data`` framed as one TFRecord."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


# -- protobuf, the wire format of the few fields written here ----------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        low, n = n & 0x7F, n >> 7
        if n:
            out.append(low | 0x80)
        else:
            out.append(low)
            return bytes(out)


def _field_varint(number: int, value: int) -> bytes:
    return _varint(number << 3) + _varint(value)


def _field_bytes(number: int, value: bytes) -> bytes:
    return _varint(number << 3 | 2) + _varint(len(value)) + value


def event(wall_time: float, step: int = 0, summary: Optional[bytes] = None,
          file_version: Optional[str] = None) -> bytes:
    """An encoded ``Event``."""
    out = _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
    if step:
        out += _field_varint(2, int(step))
    if file_version is not None:
        out += _field_bytes(3, file_version.encode())
    if summary is not None:
        out += _field_bytes(5, summary)
    return out


def scalar_value(tag: str, value: float) -> bytes:
    """An encoded ``Summary.Value`` holding ``simple_value``."""
    return _field_bytes(1, tag.encode()) + _varint(2 << 3 | 5) + struct.pack("<f", value)


def image_value(tag: str, images: np.ndarray) -> bytes:
    """An encoded ``Summary.Value`` holding an ``[N, H, W, C]`` batch in [0,
    1] as one PNG grid (tensorboardX's ``add_images``)."""
    grid = image_grid(images)
    height, width, channels = grid.shape
    image = (_field_varint(1, height) + _field_varint(2, width) + _field_varint(3, channels)
             + _field_bytes(4, png(grid)))
    return _field_bytes(1, tag.encode()) + _field_bytes(4, image)


def image_grid(images: np.ndarray, ncols: int = 8) -> np.ndarray:
    """``[N, H, W, C]`` (C 1 or 3) in [0, 1] -> the ``[rows H, cols W, 3]``
    uint8 grid tensorboardX's ``make_grid`` and ``image`` make: grey
    repeated to RGB, ``min(N, ncols)`` images a row, the rest of the canvas
    zero, values times 255 truncated to uint8."""
    x = np.asarray(images, np.float32)
    if x.ndim != 4 or x.shape[-1] not in (1, 3):
        raise ValueError(f"images of shape {x.shape}: expected [N, H, W, 1 or 3]")
    if x.shape[-1] == 1:
        x = np.concatenate([x, x, x], -1)
    n, h, w, c = x.shape
    cols = min(n, ncols)
    rows = -(-n // cols)
    canvas = np.zeros((rows * h, cols * w, c), np.float32)
    for i in range(n):
        y, xx = divmod(i, cols)
        canvas[y * h:(y + 1) * h, xx * w:(xx + 1) * w] = x[i]
    return (canvas * 255.0).astype(np.uint8)


def png(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of ``[H, W, 3]`` uint8, no filter on any row."""
    h, w, _ = rgb.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], 1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


class EventFileWriter:
    """Appends events to a new event file in ``logdir`` (made if missing),
    flushed after each :meth:`add`."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(now):010d}.{socket.gethostname()}")
        with open(self.path, "ab") as fp:
            fp.write(record(event(now, file_version="brain.Event:2")))

    def add(self, step: int, value: bytes) -> None:
        """One event at ``step`` whose summary holds the encoded ``value``
        (tensorboardX writes one a value too)."""
        summary = _field_bytes(1, value)
        with open(self.path, "ab") as fp:
            fp.write(record(event(time.time(), step, summary=summary)))
