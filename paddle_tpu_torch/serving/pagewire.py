"""Wire format for KV page migration and the host tier (counterpart:
``paddle_tpu/serving/pagewire.py``), byte for byte.

A payload is a fixed magic, a little-endian length-prefixed JSON header
(``meta``, the optional continuation ``request``, every array's shape
and dtype name, ``n_layers_k`` and the ``crc32`` of the array bytes),
then the raw bytes of every K array and then every V array, in header
order. Both packages write the same header JSON and the same bytes, so
a payload crosses between them either way.

The arrays here are CPU torch tensors. bfloat16 goes on the wire as its
16 raw bits under the dtype name ``"bfloat16"`` and is read back by a
``view`` into ``torch.bfloat16`` (numpy holds no bfloat16 without
``ml_dtypes``). Deserialization is strict: magic, header shape, each
declared shape and dtype against the byte count, no trailing bytes, and
the CRC where the header has one (the serializer always writes it; at
rest in the host tier, the CRC turns corrupted bytes into a
:class:`WireFormatError`).
"""
from __future__ import annotations

import json
import struct
import warnings
import zlib

import numpy as np
import torch

from ..device import dtype_name, resolve_dtype

__all__ = ["MAGIC", "MAX_PAYLOAD_BYTES", "serialize_pages",
           "deserialize_pages", "WireFormatError"]

MAGIC = b"PTKV1\n"
_LEN = struct.Struct("<Q")
# a page payload is bounded by the source cache size; anything past this
# is a protocol error, not a transfer
MAX_PAYLOAD_BYTES = 1 << 31


class WireFormatError(ValueError):
    """The byte stream is not a valid page-migration payload."""


def _raw(a):
    """``(uint8 numpy view of the bytes, dtype name)`` of a CPU tensor
    (bfloat16 by its raw bits) or a numpy array."""
    if isinstance(a, torch.Tensor):
        t = a.contiguous().reshape(-1)
        return t.view(torch.uint8).numpy(), dtype_name(a.dtype)
    a = np.ascontiguousarray(a)
    return a.reshape(-1).view(np.uint8), str(a.dtype)


def serialize_pages(meta, k_arrays, v_arrays, request=None):
    """Pack ``(meta, k, v)`` (the export result: CPU tensors, or numpy
    arrays) plus an optional ``request`` continuation dict into one
    ``bytes`` payload."""
    arrays = list(k_arrays) + list(v_arrays)
    raw = [_raw(a) for a in arrays]
    body = [b for b, _ in raw]
    crc = 0
    for b in body:
        crc = zlib.crc32(b, crc)
    header = {
        "meta": dict(meta),
        "request": dict(request) if request is not None else None,
        "arrays": [{"shape": list(a.shape), "dtype": name}
                   for a, (_, name) in zip(arrays, raw)],
        "n_layers_k": len(k_arrays),
        "crc32": crc,
    }
    hdr = json.dumps(header).encode()
    return b"".join([MAGIC, _LEN.pack(len(hdr)), hdr] + body)


def deserialize_pages(buf):
    """Unpack a payload into ``(meta, k_arrays, v_arrays, request)``, the
    arrays CPU tensors viewing ``buf``. Raises :class:`WireFormatError`
    on any structural mismatch."""
    if not buf.startswith(MAGIC):
        raise WireFormatError("bad magic: not a KV page payload")
    off = len(MAGIC)
    if len(buf) < off + _LEN.size:
        raise WireFormatError("truncated header length")
    (hlen,) = _LEN.unpack_from(buf, off)
    off += _LEN.size
    if hlen > MAX_PAYLOAD_BYTES or len(buf) < off + hlen:
        raise WireFormatError("truncated header")
    try:
        header = json.loads(buf[off:off + hlen])
    except ValueError as e:
        raise WireFormatError(f"header is not JSON: {e}") from e
    off += hlen
    try:
        meta = dict(header["meta"])
        specs = header["arrays"]
        n_k = int(header["n_layers_k"])
        request = header.get("request")
        crc = header.get("crc32")
    except (KeyError, TypeError, ValueError) as e:
        raise WireFormatError(f"malformed header: {e}") from e
    data_start = off
    if not 0 <= n_k <= len(specs):
        raise WireFormatError(
            f"n_layers_k={n_k} outside the {len(specs)} declared arrays")
    arrays = []
    for spec in specs:
        try:
            shape = tuple(int(d) for d in spec["shape"])
            dtype = resolve_dtype(spec["dtype"])
        except (KeyError, TypeError, ValueError) as e:
            raise WireFormatError(f"malformed array spec: {e}") from e
        count = int(np.prod(shape, dtype=np.int64))
        nbytes = count * dtype.itemsize
        if count < 0 or len(buf) < off + nbytes:
            raise WireFormatError(
                f"truncated array payload: declared {shape} "
                f"{spec['dtype']} needs {nbytes} byte(s), "
                f"{len(buf) - off} left")
        if nbytes:
            with warnings.catch_warnings():
                # a read-only buffer: the importers only read the arrays
                warnings.simplefilter("ignore", UserWarning)
                raw = torch.frombuffer(buf, dtype=torch.uint8,
                                       count=nbytes, offset=off)
            arrays.append(raw.view(dtype).reshape(shape))
        else:
            arrays.append(torch.empty(shape, dtype=dtype))
        off += nbytes
    if off != len(buf):
        raise WireFormatError(
            f"{len(buf) - off} trailing byte(s) after the declared "
            "arrays")
    if crc is not None and zlib.crc32(
            memoryview(buf)[data_start:]) != int(crc):
        raise WireFormatError("payload CRC mismatch: corrupt page bytes")
    return meta, arrays[:n_k], arrays[n_k:], request
