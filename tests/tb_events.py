"""Reads back the TensorBoard event files that the port writes
(``posterior_matching_torch/train/tensorboard.py``), with the standard
library only: the card's machine has no tensorboard. The tests and
``chip_smoke.py`` use it."""
import struct

from posterior_matching_torch.train.tensorboard import masked_crc32c


def _fields(data: bytes):
    """``(number, value)`` of each field of an encoded message: an int for a
    varint, the bytes of a length-delimited field or of a fixed one."""
    i = 0

    def varint():
        nonlocal i
        n = shift = 0
        while True:
            byte = data[i]
            i += 1
            n |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                return n

    while i < len(data):
        key = varint()
        wire = key & 7
        if wire == 0:
            value = varint()
        elif wire == 2:
            n = varint()
            value, i = data[i:i + n], i + n
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            value, i = data[i:i + n], i + n
        else:
            raise ValueError(f"protobuf wire type {wire} is not read here")
        yield key >> 3, value


def read_events(path: str):
    """The summary values of an event file, checksums checked: ``(step,
    tag, value)`` with a scalar's float, or an image's ``(height, width)``
    (the file's ``file_version`` event is skipped)."""
    with open(path, "rb") as fp:
        raw = fp.read()
    out, i = [], 0
    while i < len(raw):
        (n,) = struct.unpack("<Q", raw[i:i + 8])
        data = raw[i + 12:i + 12 + n]
        if (struct.unpack("<I", raw[i + 8:i + 12])[0] != masked_crc32c(raw[i:i + 8])
                or struct.unpack("<I", raw[i + 12 + n:i + 16 + n])[0] != masked_crc32c(data)):
            raise ValueError(f"{path}: a record's checksum is wrong at byte {i}")
        i += 16 + n
        event = dict(_fields(data))
        for _, value in _fields(event.get(5, b"")):
            fields = dict(_fields(value))
            tag = fields[1].decode()
            if 2 in fields:
                out.append((event.get(2, 0), tag, struct.unpack("<f", fields[2])[0]))
            else:
                image = dict(_fields(fields[4]))
                out.append((event.get(2, 0), tag, (image[1], image[2])))
    return out
