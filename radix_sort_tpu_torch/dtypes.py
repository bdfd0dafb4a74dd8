"""Key-type registry and order-preserving bit transforms, on torch tensors.

Port of ``radix_sort_tpu/dtypes.py``.  Every key travels as the bit pattern
of a *signed* container (int32 for 2- and 4-byte keys, int64 for 8-byte
keys): torch has no ``>>`` and no ``index_put_`` for uint32 on the CPU, so
the unsigned containers of the JAX package never appear inside the port.
The "sortable" image of a key is the bit pattern whose UNSIGNED order
equals the key's order (the reference's OFFSET bias,
``src/RadixSortGPU.cpp:436``):

- unsigned ints: the bits themselves;
- signed ints: the sign bit flipped;
- floats: all bits flipped for negatives, the sign bit for the rest.

A 16-bit key's image is its 16-bit pattern (bit 15 flipped for int16)
zero-extended into int32, so its sort needs 16 bits of digits only.

A radix digit ``(x >> s) & (R - 1)`` of the signed container is exact: the
mask drops every bit an arithmetic shift fills in.  Callers' uint32/uint64
tensors are viewed as int32/int64 on the way in and viewed back on the way
out (a view costs nothing on any device).
"""

from __future__ import annotations

import numpy as np
import torch

# Canonical names, as the JAX package's registry (the reference's
# TypeNameString<T>, Common/CLTypeInformation.h:8-46): CSV labels and ids.
_REGISTRY = {
    np.dtype(np.uint32): ("uint32_t", "u32"),
    np.dtype(np.int32): ("int32_t", "i32"),
    np.dtype(np.uint64): ("uint64_t", "u64"),
    np.dtype(np.int64): ("int64_t", "i64"),
    np.dtype(np.uint16): ("uint16_t", "u16"),
    np.dtype(np.int16): ("int16_t", "i16"),
    np.dtype(np.float32): ("float", "f32"),
    np.dtype(np.float64): ("double", "f64"),
}

SUPPORTED_KEY_DTYPES = tuple(_REGISTRY)

_TORCH_TO_NP = {
    torch.uint32: np.dtype(np.uint32), torch.int32: np.dtype(np.int32),
    torch.uint64: np.dtype(np.uint64), torch.int64: np.dtype(np.int64),
    torch.float32: np.dtype(np.float32), torch.float64: np.dtype(np.float64),
    torch.int16: np.dtype(np.int16), torch.uint16: np.dtype(np.uint16),
    torch.int8: np.dtype(np.int8), torch.uint8: np.dtype(np.uint8),
    torch.bool: np.dtype(np.bool_),
}
_NP_TO_TORCH = {v: k for k, v in _TORCH_TO_NP.items()}
_SIGNED_CONTAINER = {2: torch.int32, 4: torch.int32, 8: torch.int64}
_BIT15 = 1 << 15


def type_name(dtype) -> str:
    """Short canonical label (u32/i64/...) used in CSV rows and test ids."""
    return _REGISTRY[np_dtype(dtype)][1]


def c_name(dtype) -> str:
    """stdint-style name, parity with TypeNameString<T>::stdint_name."""
    return _REGISTRY[np_dtype(dtype)][0]


def np_dtype(dtype) -> np.dtype:
    """numpy dtype of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return _TORCH_TO_NP[dtype]
    return np.dtype(dtype)


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NP_TO_TORCH[np.dtype(dtype)]


def key_bits(dtype) -> int:
    return np_dtype(dtype).itemsize * 8


def unsigned_container(dtype) -> np.dtype:
    """The unsigned numpy dtype whose bit pattern carries the sort order."""
    return np.dtype(f"u{np_dtype(dtype).itemsize}")


def signed_container(dtype) -> torch.dtype:
    """The signed torch dtype that carries the sortable image of keys of
    ``dtype`` (int32/int64)."""
    return _SIGNED_CONTAINER[np_dtype(dtype).itemsize]


def is_unsigned(dtype) -> bool:
    return np_dtype(dtype).kind == "u"


def sign_bit(bits: int) -> int:
    """The sign bit of a ``bits``-wide signed container, as a python int."""
    return -(1 << (bits - 1))


def as_container(x: torch.Tensor) -> torch.Tensor:
    """View uint32/uint64 tensors as int32/int64; other dtypes unchanged."""
    if x.dtype in (torch.uint32, torch.uint64):
        return x.view(signed_container(x.dtype))
    return x


def from_container(x: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`as_container` for a tensor of logical ``dtype``."""
    dtype = torch_dtype(dtype)
    if dtype in (torch.uint32, torch.uint64):
        return x.view(dtype)
    return x


def to_sortable(keys: torch.Tensor) -> torch.Tensor:
    """Keys → signed-container bits whose unsigned order is the key order."""
    d = np_dtype(keys.dtype)
    if d not in SUPPORTED_KEY_DTYPES:
        raise TypeError(f"unsupported key dtype {d}")
    if d.itemsize == 2:
        bits = keys.to(torch.int32) & 0xFFFF
        return bits ^ _BIT15 if d.kind == "i" else bits
    bits = keys.view(signed_container(d))
    sign = sign_bit(key_bits(d))
    if d.kind == "u":
        return bits
    if d.kind == "i":
        return bits ^ sign
    # floats: negatives (the arithmetic shift gives -1) flip every bit,
    # the rest flip the sign bit only
    return bits ^ ((bits >> (key_bits(d) - 1)) | sign)


def from_sortable(bits: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`to_sortable`: bits back to the caller's dtype."""
    d = np_dtype(dtype)
    if d.itemsize == 2:
        # int32 -> int16 wraps, so the flipped pattern narrows exactly
        return (bits ^ _BIT15 if d.kind == "i" else bits).to(torch_dtype(d))
    sign = sign_bit(key_bits(d))
    if d.kind == "u":
        return from_container(bits, d)
    if d.kind == "i":
        return bits ^ sign
    return (bits ^ (~(bits >> (key_bits(d) - 1)) | sign)).view(torch_dtype(d))


# Padding sentinel: the maximum UNSIGNED container value, every bit set,
# which is -1 in the signed container.  Stable sorts keep real keys equal
# to it ahead of the padding rows that carry it.
SENTINEL_BITS = -1


def complement(bits: torch.Tensor, total_bits: int) -> torch.Tensor:
    """Reverse the unsigned order of ``total_bits``-wide sortable bits (a
    descending key), keeping a 16-bit image inside its 16 bits, where a
    bare ``~`` would set the container's upper bits too."""
    if total_bits == 8 * bits.element_size():
        return ~bits
    return bits ^ ((1 << total_bits) - 1)


def signed_order(bits: torch.Tensor) -> torch.Tensor:
    """Sortable bits → a tensor whose SIGNED order is their unsigned order
    (flip the sign bit), for torch's signed comparisons and sorts."""
    return bits ^ sign_bit(bits.element_size() * 8)


# NumPy twins for the golden model ------------------------------------------


def np_to_sortable_unsigned(keys: np.ndarray) -> np.ndarray:
    d = keys.dtype
    u = unsigned_container(d)
    if d.kind == "u":
        return keys
    if d.kind == "i":
        return keys.view(u) ^ u.type(1 << (key_bits(d) - 1))
    if d.kind == "f":
        bits = keys.view(u)
        sign = u.type(1 << (key_bits(d) - 1))
        mask = np.where((bits & sign) != 0, u.type(~u.type(0)), sign)
        return bits ^ mask
    raise TypeError(f"unsupported key dtype {d}")


def np_from_sortable_unsigned(ukeys: np.ndarray, dtype) -> np.ndarray:
    d = np.dtype(dtype)
    u = unsigned_container(d)
    if d.kind == "u":
        return ukeys.astype(d)
    if d.kind == "i":
        return (ukeys ^ u.type(1 << (key_bits(d) - 1))).view(d)
    if d.kind == "f":
        sign = u.type(1 << (key_bits(d) - 1))
        mask = np.where((ukeys & sign) != 0, sign, u.type(~u.type(0)))
        return (ukeys ^ mask).view(d)
    raise TypeError(f"unsupported key dtype {d}")


def tensor_from_numpy(a: np.ndarray, device="cuda") -> torch.Tensor:
    """numpy array → tensor on ``device`` (the card unless the caller asks
    for the CPU); uint32/uint64 cross as their signed containers and are
    viewed back on the device."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch.from_numpy wants a writable buffer
        a = a.copy()
    if a.dtype.kind == "u" and a.dtype.itemsize in (4, 8):
        t = torch.from_numpy(a.view(f"i{a.dtype.itemsize}")).to(device)
        return from_container(t, a.dtype)
    return torch.from_numpy(a).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor → numpy array of the same logical dtype."""
    d = np_dtype(t.dtype)
    return as_container(t).detach().cpu().numpy().view(d)
