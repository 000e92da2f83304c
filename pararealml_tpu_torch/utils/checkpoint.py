"""Model parameter persistence in flax's msgpack format.

Port of the JAX package's ``utils/checkpoint.py``, which writes a pytree
of arrays with ``flax.serialization.to_bytes``. The port reads and writes
the same bytes without flax or the ``msgpack`` package: a small pure
Python codec covers the subset of msgpack that flax writes for a tree of
dictionaries, lists and arrays:

- maps (fixmap, map16, map32), strings (fixstr, str8/16/32), arrays
  (fixarray, array16, array32), non-negative integers (positive fixint,
  uint8/16/32/64), binary blobs (bin8/16/32), nil, true and false;
- extension values with type code 1 (fixext, ext8/16/32), which hold one
  ndarray as the msgpack array ``[shape, dtype name, raw C-order
  bytes]``.

Arrays come back as numpy arrays. Anything outside the subset raises.
Dictionary keys are written sorted, as flax's pytree flattening orders
them, and lists as dictionaries keyed by their indices, as flax's state
dictionaries hold them, so a tree saved here is byte for byte what flax
writes for it.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Tuple

import numpy as np

_NDARRAY_EXT = 1


class _Reader:
    def __init__(self, data: bytes):
        self._data = memoryview(data)
        self.position = 0

    def take(self, count: int) -> memoryview:
        end = self.position + count
        if end > len(self._data):
            raise ValueError("truncated msgpack data")
        chunk = self._data[self.position: end]
        self.position = end
        return chunk

    def unsigned(self, size: int) -> int:
        return int.from_bytes(self.take(size), "big")


def _decode(reader: _Reader) -> Any:
    head = reader.unsigned(1)
    if head <= 0x7F:
        return head
    if 0x80 <= head <= 0x8F:
        return _decode_map(reader, head & 0x0F)
    if 0x90 <= head <= 0x9F:
        return _decode_array(reader, head & 0x0F)
    if 0xA0 <= head <= 0xBF:
        return _decode_str(reader, head & 0x1F)
    if head == 0xC0:
        return None
    if head == 0xC2:
        return False
    if head == 0xC3:
        return True
    if head in (0xC4, 0xC5, 0xC6):
        size = reader.unsigned(1 << (head - 0xC4))
        return bytes(reader.take(size))
    if head in (0xC7, 0xC8, 0xC9):
        return _decode_ext(reader, reader.unsigned(1 << (head - 0xC7)))
    if head in (0xCC, 0xCD, 0xCE, 0xCF):
        return reader.unsigned(1 << (head - 0xCC))
    if head in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
        return _decode_ext(reader, 1 << (head - 0xD4))
    if head in (0xD9, 0xDA, 0xDB):
        return _decode_str(reader, reader.unsigned(1 << (head - 0xD9)))
    if head in (0xDC, 0xDD):
        return _decode_array(reader, reader.unsigned(2 << (head - 0xDC)))
    if head in (0xDE, 0xDF):
        return _decode_map(reader, reader.unsigned(2 << (head - 0xDE)))
    raise ValueError(
        f"msgpack type byte 0x{head:02x} is outside the subset flax writes"
    )


def _decode_str(reader: _Reader, size: int) -> str:
    return bytes(reader.take(size)).decode("utf-8")


def _decode_array(reader: _Reader, count: int) -> list:
    return [_decode(reader) for _ in range(count)]


def _decode_map(reader: _Reader, count: int) -> dict:
    out = {}
    for _ in range(count):
        key = _decode(reader)
        out[key] = _decode(reader)
    return out


def _decode_ext(reader: _Reader, size: int) -> np.ndarray:
    code = struct.unpack(">b", reader.take(1))[0]
    payload = bytes(reader.take(size))
    if code != _NDARRAY_EXT:
        raise ValueError(
            f"msgpack extension type {code} is not an ndarray (type "
            f"{_NDARRAY_EXT})"
        )
    inner = _Reader(payload)
    value = _decode(inner)
    if inner.position != len(payload) or not (
        isinstance(value, list)
        and len(value) == 3
        and isinstance(value[0], list)
        and isinstance(value[1], str)
        and isinstance(value[2], bytes)
    ):
        raise ValueError("malformed ndarray extension value")
    shape, dtype_name, buffer = value
    dtype = np.dtype(dtype_name)
    return np.frombuffer(buffer, dtype).reshape(shape).copy()


def decode(data: bytes) -> Any:
    """Decodes one msgpack value (of the subset flax writes)."""
    reader = _Reader(data)
    value = _decode(reader)
    if reader.position != len(data):
        raise ValueError("trailing bytes after the msgpack value")
    return value


def _sized(out: bytearray, size: int, small: Tuple[int, int], heads):
    """Appends the header of a sized value: the fix form when ``size``
    is below ``small[1]`` (head ``small[0] | size``), else the first of
    ``heads`` (8/16/32-bit length forms, by byte width) that holds it."""
    fix_head, fix_limit = small
    if fix_head is not None and size < fix_limit:
        out.append(fix_head | size)
        return
    for head, width in heads:
        if size < 1 << (8 * width):
            out.append(head)
            out += size.to_bytes(width, "big")
            return
    raise ValueError(f"value of {size} entries is too large for msgpack")


def _encode(value: Any, out: bytearray):
    if value is None:
        out.append(0xC0)
    elif value is True:
        out.append(0xC3)
    elif value is False:
        out.append(0xC2)
    elif isinstance(value, int):
        if value < 0:
            raise ValueError("negative integers are outside the subset")
        if value <= 0x7F:
            out.append(value)
        else:
            for head, width in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
                if value < 1 << (8 * width):
                    out.append(head)
                    out += value.to_bytes(width, "big")
                    return
            raise ValueError(f"integer {value} is too large for msgpack")
    elif isinstance(value, str):
        raw = value.encode("utf-8")
        _sized(out, len(raw), (0xA0, 32), ((0xD9, 1), (0xDA, 2), (0xDB, 4)))
        out += raw
    elif isinstance(value, (bytes, bytearray)):
        _sized(out, len(value), (None, 0), ((0xC4, 1), (0xC5, 2), (0xC6, 4)))
        out += value
    elif isinstance(value, (list, tuple)):
        _sized(out, len(value), (0x90, 16), ((0xDC, 2), (0xDD, 4)))
        for item in value:
            _encode(item, out)
    elif isinstance(value, dict):
        _sized(out, len(value), (0x80, 16), ((0xDE, 2), (0xDF, 4)))
        for key in sorted(value, key=str):
            _encode(str(key), out)
            _encode(value[key], out)
    elif isinstance(value, np.ndarray):
        # (np.ascontiguousarray would turn a 0-d array into a 1-d one)
        array = value if value.flags.c_contiguous else value.copy("C")
        if array.dtype.hasobject or array.dtype.isalignedstruct:
            raise ValueError("object and structured arrays are not supported")
        payload = bytearray()
        _encode(
            [list(array.shape), array.dtype.name, array.tobytes("C")],
            payload,
        )
        size = len(payload)
        if size in (1, 2, 4, 8, 16):
            out.append(0xD4 + size.bit_length() - 1)
        else:
            _sized(out, size, (None, 0), ((0xC7, 1), (0xC8, 2), (0xC9, 4)))
        out.append(_NDARRAY_EXT)
        out += payload
    else:
        raise TypeError(
            f"{type(value).__name__} is outside the msgpack subset (dicts, "
            "lists, strings, non-negative ints, bytes and ndarrays)"
        )


def encode(value: Any) -> bytes:
    """Encodes a tree of dicts, lists, strings, non-negative ints,
    bytes, booleans, None and numpy arrays as msgpack."""
    out = bytearray()
    _encode(value, out)
    return bytes(out)


def _state_dict(tree: Any) -> Any:
    """The tree as flax's state dict: string keys, lists and tuples as
    dictionaries keyed by their indices, tensors as numpy arrays."""
    if isinstance(tree, dict):
        return {str(key): _state_dict(value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(value) for i, value in enumerate(tree)}
    if hasattr(tree, "detach") and hasattr(tree, "cpu"):  # a torch tensor
        return tree.detach().cpu().numpy()
    if isinstance(tree, np.generic):
        raise TypeError("numpy scalars are outside the msgpack subset")
    return tree


def save_pytree(path: str, tree: Dict[str, Any]) -> None:
    """Serializes a tree of arrays (numpy arrays or tensors) to ``path``
    in flax's msgpack format: lists and tuples are stored as
    dictionaries keyed by their indices, as flax stores them."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode(_state_dict(tree)))


def load_pytree(path: str, like=None):
    """Restores a tree saved with :func:`save_pytree` (or by the JAX
    package's flax-based one). ``like``, a template tree, is optional:
    when given, the saved dictionaries must have its keys, the result
    follows its key order, and its lists and tuples come back as
    lists."""
    with open(path, "rb") as f:
        tree = decode(f.read())
    if like is None:
        return tree
    return _restore_like(like, tree)


def _restore_like(like, tree):
    if isinstance(like, (dict, list, tuple)):
        keys = like if isinstance(like, dict) else range(len(like))
        if not isinstance(tree, dict) or set(map(str, keys)) != set(tree):
            saved = sorted(tree) if isinstance(tree, dict) else tree
            raise ValueError(
                f"saved keys {saved!r} do not match the template's "
                f"{sorted(map(str, keys))}"
            )
        restored = {
            key: _restore_like(like[key], tree[str(key)]) for key in keys
        }
        return restored if isinstance(like, dict) else list(restored.values())
    return tree
