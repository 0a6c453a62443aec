"""Torch7 ``torch.save`` files in pure Python (the port's copy of the JAX
package's ``io/torchfile.py``: the same reader, writer and
``load_val_captions``).

The reference's StackGAN eval loads ``val_captions.t7`` via the
``torchfile`` package (code/coco/stackgan/trainer.py:300-302) and uses two
fields: ``raw_txt`` (a Lua table of caption strings) and ``fea_txt`` (a
table of 2-D FloatTensors of char-CNN-RNN embeddings). This module reads
the Torch7 serialization format directly — numbers, booleans, strings,
tables, and ``torch.*Tensor`` / ``torch.*Storage`` objects — so those
files load without a torch-lua dependency.

Format (little-endian):
  object  := int32 tag, payload
  tag 0   : nil
  tag 1   : number        -> float64
  tag 2   : string        -> int32 size + bytes
  tag 3   : table         -> int32 ref-index, int32 size, size * (key, value)
  tag 4   : torch object  -> int32 ref-index, version string, classname,
                             class payload
  tag 5   : boolean       -> int32
  Tensor payload  : int32 ndim, int64[ndim] sizes, int64[ndim] strides
                    (in elements), int64 storage offset (1-based), storage
                    object
  Storage payload : int64 size, raw elements
Tables and torch objects are memoized by their ref-index (shared/cyclic
structures deserialize to shared Python objects).
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO

import numpy as np

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5

_STORAGE_DTYPES = {
    b"torch.DoubleStorage": np.float64,
    b"torch.FloatStorage": np.float32,
    b"torch.HalfStorage": np.float16,
    b"torch.LongStorage": np.int64,
    b"torch.IntStorage": np.int32,
    b"torch.ShortStorage": np.int16,
    b"torch.CharStorage": np.int8,
    b"torch.ByteStorage": np.uint8,
}
_TENSOR_CLASSES = {
    b"torch." + name + b"Tensor"
    for name in (b"Double", b"Float", b"Half", b"Long", b"Int", b"Short",
                 b"Char", b"Byte")
}


class _Reader:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.memo: dict[int, Any] = {}

    def _int(self) -> int:
        return struct.unpack("<i", self.f.read(4))[0]

    def _long(self) -> int:
        return struct.unpack("<q", self.f.read(8))[0]

    def _longs(self, n: int) -> np.ndarray:
        return np.frombuffer(self.f.read(8 * n), dtype="<i8")

    def _string(self) -> bytes:
        return self.f.read(self._int())

    def read_object(self) -> Any:
        tag = self._int()
        if tag == TYPE_NIL:
            return None
        if tag == TYPE_NUMBER:
            return struct.unpack("<d", self.f.read(8))[0]
        if tag == TYPE_BOOLEAN:
            return self._int() == 1
        if tag == TYPE_STRING:
            return self._string()
        if tag == TYPE_TABLE:
            return self._read_table()
        if tag == TYPE_TORCH:
            return self._read_torch()
        raise ValueError(f"unsupported Torch7 object tag {tag}")

    def _read_table(self) -> Any:
        idx = self._int()
        if idx in self.memo:
            return self.memo[idx]
        table: dict = {}
        self.memo[idx] = table
        for _ in range(self._int()):
            k = self.read_object()
            table[k] = self.read_object()
        # Lua list: consecutive 1..n numeric keys -> Python list (shared
        # refs keep pointing at the dict, so only convert the return)
        n = len(table)
        if n and all(float(i) in table for i in range(1, n + 1)):
            lst = [table[float(i)] for i in range(1, n + 1)]
            self.memo[idx] = lst
            return lst
        return table

    def _read_torch(self) -> Any:
        idx = self._int()
        if idx in self.memo:
            return self.memo[idx]
        version = self._string()
        classname = self._string() if version.startswith(b"V ") else version

        if classname in _STORAGE_DTYPES:
            dtype = np.dtype(_STORAGE_DTYPES[classname]).newbyteorder("<")
            size = self._long()
            data = np.frombuffer(self.f.read(size * dtype.itemsize),
                                 dtype=dtype)
            self.memo[idx] = data
            return data

        if classname in _TENSOR_CLASSES:
            ndim = self._int()
            sizes = self._longs(ndim)
            strides = self._longs(ndim)
            offset = self._long() - 1  # 1-based in the file
            storage = self.read_object()
            if ndim == 0 or storage is None or storage.size == 0:
                arr = np.empty(tuple(int(s) for s in sizes),
                               dtype=storage.dtype if storage is not None
                               else np.float32)
            else:
                arr = np.lib.stride_tricks.as_strided(
                    storage[offset:],
                    shape=tuple(int(s) for s in sizes),
                    strides=tuple(int(s) * storage.itemsize
                                  for s in strides)).copy()
            self.memo[idx] = arr
            return arr

        raise ValueError(
            f"unsupported Torch7 class {classname!r} (only tensors, "
            "storages, and plain tables are needed for val_captions.t7)")


def load(path: str) -> Any:
    """Load a Torch7 ``torch.save`` file (binary format)."""
    with open(path, "rb") as f:
        return _Reader(f).read_object()


class _Writer:
    """Minimal Torch7 writer (the subset ``load`` reads): used by the
    synthetic-data writers to emit a real ``val_captions.t7`` so the
    reference eval path can be exercised without the original file."""

    def __init__(self, f: BinaryIO):
        self.f = f
        self.next_idx = 1

    def _int(self, v: int) -> None:
        self.f.write(struct.pack("<i", v))

    def _long(self, v: int) -> None:
        self.f.write(struct.pack("<q", v))

    def _string(self, b: bytes) -> None:
        self._int(len(b))
        self.f.write(b)

    def write_object(self, obj: Any) -> None:
        if obj is None:
            self._int(TYPE_NIL)
        elif isinstance(obj, bool):
            self._int(TYPE_BOOLEAN)
            self._int(1 if obj else 0)
        elif isinstance(obj, (int, float)):
            self._int(TYPE_NUMBER)
            self.f.write(struct.pack("<d", float(obj)))
        elif isinstance(obj, str):
            self.write_object(obj.encode("utf-8"))
        elif isinstance(obj, bytes):
            self._int(TYPE_STRING)
            self._string(obj)
        elif isinstance(obj, (list, tuple)):
            self.write_object(
                {float(i + 1): v for i, v in enumerate(obj)})
        elif isinstance(obj, dict):
            self._int(TYPE_TABLE)
            self._int(self.next_idx)
            self.next_idx += 1
            self._int(len(obj))
            for k, v in obj.items():
                self.write_object(k)
                self.write_object(v)
        elif isinstance(obj, np.ndarray):
            arr = np.ascontiguousarray(obj)
            if arr.dtype == np.float64:
                cls = b"torch.DoubleTensor"
            else:
                arr = arr.astype(np.float32)
                cls = b"torch.FloatTensor"
            self._int(TYPE_TORCH)
            self._int(self.next_idx)
            self.next_idx += 1
            self._string(b"V 1")
            self._string(cls)
            self._int(arr.ndim)
            for s in arr.shape:
                self._long(s)
            strides = [st // arr.itemsize for st in arr.strides]
            for s in strides:
                self._long(s)
            self._long(1)  # storage offset, 1-based
            # the storage object
            self._int(TYPE_TORCH)
            self._int(self.next_idx)
            self.next_idx += 1
            self._string(b"V 1")
            self._string(cls.replace(b"Tensor", b"Storage"))
            self._long(arr.size)
            self.f.write(arr.tobytes())
        else:
            raise TypeError(f"cannot serialize {type(obj)} to Torch7")


def save(path: str, obj: Any) -> None:
    """Write ``obj`` in Torch7 ``torch.save`` binary format (the subset
    :func:`load` supports; round-trip tested)."""
    with open(path, "wb") as f:
        _Writer(f).write_object(obj)


def load_val_captions(path: str) -> tuple[list[str], np.ndarray]:
    """Load the reference's ``val_captions.t7``.

    Returns (captions, embeddings): caption strings and the concatenated
    ``fea_txt`` embedding matrix, exactly like the reference's
    ``captions_list = t_file.raw_txt`` /
    ``embeddings = np.concatenate(t_file.fea_txt, axis=0)``
    (code/coco/stackgan/trainer.py:300-302).
    """
    t = load(path)
    raw = t[b"raw_txt"]
    fea = t[b"fea_txt"]
    captions = [c.decode("utf-8", "replace") if isinstance(c, bytes)
                else str(c) for c in raw]
    embeddings = np.concatenate([np.asarray(x, np.float32) for x in fea],
                                axis=0)
    return captions, embeddings
