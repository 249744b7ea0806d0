"""The on-disk form of host-built block-sparse plans.

A plan file holds a JSON header and numpy arrays, no pickle: the magic
bytes, the header's length as a little-endian u64, the header (UTF-8 JSON,
keys sorted, padded with spaces to a multiple of 64 bytes), then the
arrays.  The arrays come in records, one a plan; a record's arrays lie
contiguous, each at an offset that is a multiple of 64, so that a reader
reads one record without the rest.  Integer arrays whose values fit in
int32 are stored as int32 (index maps are positions into data vectors far
below 2^31), which halves the bytes; :func:`tensor.device_index` widens
them to int64 on the device they are copied to.  The same plans give the
same bytes, whichever process writes them.

Charges are stored as their ``(dim, num_symmetries)`` int64 array beside
the names of their charge types (``U1ChargeType``, ``Z<n>ChargeType``).
"""
from __future__ import annotations

import json
import os
import struct
from typing import List, Sequence, Tuple

import numpy as np

from tensornetwork_tpu_torch.blocksparse.charge import (BaseCharge,
                                                        U1ChargeType, zn_type)

FORMAT = 1
MAGIC = b"TNPLAN\x00\x01"
_ALIGN = 64
_INT32 = np.iinfo(np.int32)


def charge_spec(c: BaseCharge) -> Tuple[np.ndarray, List[str]]:
    """(charge array, charge type names) of ``c``: picklable, and what a
    plan file stores."""
    return c.charges, [t.__name__ for t in c.charge_types]


def charge_type(name: str):
    if name == U1ChargeType.__name__:
        return U1ChargeType
    if name.startswith("Z") and name.endswith("ChargeType") \
            and name[1:-10].isdigit():
        return zn_type(int(name[1:-10]))
    raise ValueError(f"unknown charge type {name!r}")


def charge_from_spec(charges: np.ndarray, types: Sequence[str]
                     ) -> BaseCharge:
    return BaseCharge(np.asarray(charges, dtype=np.int64).reshape(
        -1, len(types)), [charge_type(t) for t in types])


def _stored_dtype(a: np.ndarray) -> np.dtype:
    if a.dtype == np.int64 and (a.size == 0 or (
            a.min() >= _INT32.min and a.max() <= _INT32.max)):
        return np.dtype(np.int32)
    return a.dtype


def _pad(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def write(fname: str, header: dict, records: Sequence[Sequence[np.ndarray]]
          ) -> int:
    """Write ``header`` (JSON-able) and ``records`` (lists of arrays) to
    ``fname`` through a temporary name and ``os.replace``; the header gains
    the table ``"records"``.  Returns the bytes written."""
    table, blobs, pos = [], [], 0
    for arrays in records:
        start, entries = pos, []
        for a in arrays:
            dt = _stored_dtype(a)
            entries.append([pos - start, dt.str, list(a.shape)])
            blobs.append((pos, a, dt))
            pos = _pad(pos + a.size * dt.itemsize)
        table.append([start, pos, entries])
    head = json.dumps(dict(header, records=table), sort_keys=True,
                      separators=(",", ":")).encode()
    head += b" " * (_pad(len(head) + 16) - len(head) - 16)
    base = 16 + len(head)
    tmp = f"{fname}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC + struct.pack("<Q", len(head)) + head)
        at = 0
        for off, a, dt in blobs:
            if off > at:
                f.write(b"\0" * (off - at))
            # converted one at a time: a program's int32 copies held
            # together would cost as much memory again
            a = np.ascontiguousarray(a, dtype=dt)
            f.write(a.data)
            at = off + a.nbytes
        if pos > at:
            f.write(b"\0" * (pos - at))
    os.replace(tmp, fname)
    return base + pos


class PlanFile:
    """A plan file's header, and its records read one at a time."""

    def __init__(self, fname: str):
        self.fname = fname
        with open(fname, "rb") as f:
            magic = f.read(8)
            if magic != MAGIC:
                raise ValueError(f"{fname} is not a plan file")
            n, = struct.unpack("<Q", f.read(8))
            self.header = json.loads(f.read(n))
        self._base = 16 + n

    def record(self, i: int) -> List[np.ndarray]:
        """The arrays of record ``i``, views of one buffer read from the
        file."""
        start, end, entries = self.header["records"][i]
        buf = np.empty(end - start, dtype=np.uint8)
        with open(self.fname, "rb") as f:
            f.seek(self._base + start)
            if f.readinto(memoryview(buf)) != buf.size:
                raise ValueError(f"{self.fname}: record {i} is cut short")
        out = []
        for off, dtype, shape in entries:
            dt = np.dtype(dtype)
            count = int(np.prod(shape, dtype=np.int64))
            out.append(np.frombuffer(buf, dt, count, off).reshape(shape))
        return out
