"""RecordIO: binary record files (counterpart of `mxnet_tpu/recordio.py`;
reference: python/mxnet/recordio.py over dmlc-core's recordio format).

The on-disk format is the reference's, byte for byte, so a file written by
either package (or by the reference's tools/im2rec) reads in the other:

* a record is the magic ``0xced7230a``, a little-endian word holding the
  payload length in its low 29 bits (the top 3 are the continuation flag,
  always 0 here), the payload, and zero padding to a multiple of 4 bytes;
* an ``.idx`` file holds one ``key<TAB>offset`` line a record;
* an image record's payload is an `IRHeader` (``<IfQQ``: flag, label, id,
  id2), then ``flag`` float32 labels when ``flag > 0``, then the encoded
  image.

The reader and writer are pure Python. The JAX package's native reader
(``mxnet_tpu/lib/native``) is not ported (ROADMAP queue 1 item 13).
"""
from __future__ import annotations

import collections
import os
import struct

import numpy as _np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_CFLAG_BITS = 29
_LEN_MASK = (1 << _CFLAG_BITS) - 1


class MXRecordIO:
    """Sequential record reader (``flag="r"``) or writer (``"w"``)
    (reference: recordio.py:36)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.pid = None
        self.is_open = False
        self.handle = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.writable = True
            self.handle = open(self.uri, "wb")
        elif self.flag == "r":
            self.writable = False
            try:
                self.handle = open(self.uri, "rb")
            except FileNotFoundError:
                raise MXNetError("record file %s not found" % self.uri) \
                    from None
        else:
            raise MXNetError("Invalid flag %s" % self.flag)
        self.pid = os.getpid()
        self.is_open = True

    def close(self):
        if self.is_open:
            self.handle.close()
            self.handle = None
            self.is_open = False
            self.pid = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("handle", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.open()

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        return self.handle.tell()

    def write(self, buf):
        assert self.writable
        lrec = len(buf) & _LEN_MASK
        self.handle.write(struct.pack("<II", _MAGIC, lrec))
        self.handle.write(buf)
        pad = (-len(buf)) % 4
        if pad:
            self.handle.write(b"\x00" * pad)

    def read(self):
        """The next record's payload, or None at the end of the file."""
        assert not self.writable
        head = self.handle.read(8)
        if len(head) < 8:
            return None
        magic, lrec = struct.unpack("<II", head)
        if magic != _MAGIC:
            raise MXNetError("invalid record magic 0x%x at offset %d"
                             % (magic, self.handle.tell() - 8))
        length = lrec & _LEN_MASK
        buf = self.handle.read(length)
        pad = (-length) % 4
        if pad:
            self.handle.read(pad)
        return buf


class MXIndexedRecordIO(MXRecordIO):
    """Random access by key through an ``.idx`` file (reference:
    recordio.py:92). The writer writes the index at `close`."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if self.is_open and self.writable:
            with open(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write("%s\t%d\n" % (str(k), self.idx[k]))
        super().close()

    def seek(self, idx):
        assert not self.writable
        self.handle.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


IRHeader = collections.namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """An `IRHeader` and a payload as one record (reference: recordio.py
    pack). A list or array label is stored as ``flag`` float32 values after
    the fixed header."""
    header = IRHeader(*header)
    if isinstance(header.label, (list, tuple, _np.ndarray)):
        label = _np.asarray(header.label, dtype=_np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, header.flag, float(header.label),
                       header.id, header.id2) + s


def unpack(s):
    """A record as ``(IRHeader, payload)`` (reference: recordio.py
    unpack); a multi-label header's ``label`` is a float32 array."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = _np.frombuffer(s[:header.flag * 4], dtype=_np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an HWC uint8 image and pack it (reference: recordio.py
    pack_img). ``img_fmt=".png"`` needs nothing beyond numpy; ".jpg" needs
    Pillow (`image.imencode`)."""
    from . import image

    buf = image.imencode(img, quality=quality, fmt=img_fmt)
    return pack(header, buf)


def unpack_img(s, iscolor=-1):
    """Unpack and decode an image record: ``(IRHeader, HWC uint8 numpy
    array)`` (reference: recordio.py unpack_img)."""
    from . import image

    header, buf = unpack(s)
    img = image.imdecode(buf, flag=1 if iscolor != 0 else 0,
                         to_ndarray=False)
    return header, img
