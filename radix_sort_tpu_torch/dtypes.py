"""Key-type registry and order-preserving bit transforms, on torch tensors.

Port of ``radix_sort_tpu/dtypes.py``.  Every key travels as the bit pattern
of a *signed* container (int32 for 1-, 2- and 4-byte keys, int64 for 8-byte
keys): torch has no ``>>`` and no ``index_put_`` for uint32 on the CPU, so
the unsigned containers of the JAX package never appear inside the port.
The "sortable" image of a key is the bit pattern whose UNSIGNED order
equals the key's order (the reference's OFFSET bias,
``src/RadixSortGPU.cpp:436``):

- unsigned ints: the bits themselves;
- signed ints: the sign bit flipped;
- floats: all bits flipped for negatives, the sign bit for the rest.

A 1- or 2-byte key's image is its own-width image zero-extended into
int32, so its sort needs 8 or 16 bits of digits only.

Keys are accepted by kind and width, as the JAX ``to_sortable_unsigned``
accepts them: unsigned, signed and float keys of 1, 2, 4 or 8 bytes
(``uint8`` and ``float16`` included); any other dtype (``bool``,
``bfloat16``, complex) raises ``TypeError``.  The registry below names
the harness's key types only, as the JAX package's does.

A radix digit ``(x >> s) & (R - 1)`` of the signed container is exact: the
mask drops every bit an arithmetic shift fills in.  Callers'
uint16/uint32/uint64 tensors are viewed as int16/int32/int64 on the way in
and viewed back on the way out (a view costs nothing on any device).
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
    torch.float16: np.dtype(np.float16), torch.bool: np.dtype(np.bool_),
}
_NP_TO_TORCH = {v: k for k, v in _TORCH_TO_NP.items()}
_SIGNED_CONTAINER = {1: torch.int32, 2: torch.int32, 4: torch.int32,
                     8: torch.int64}
# same-width ints that 1- and 2-byte keys are bit-viewed as
_NARROW_INT = {1: torch.int8, 2: torch.int16}
_NARROW_UINT = {1: torch.uint8, 2: torch.uint16}


def type_name(dtype) -> str:
    """Short canonical label (u32/i64/...) used in CSV rows and test ids."""
    return _REGISTRY[np_dtype(dtype)][1]


def c_name(dtype) -> str:
    """stdint-style name, parity with TypeNameString<T>::stdint_name."""
    return _REGISTRY[np_dtype(dtype)][0]


def np_dtype(dtype) -> np.dtype:
    """numpy dtype of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _TORCH_TO_NP:
            raise TypeError(f"no numpy dtype for {dtype}")
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


# unsigned dtypes that torch's CPU kernels lack most ops for (ordered
# comparisons, index_select, index_add_, ...) travel as same-width signed
# views
_SIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                torch.uint64: torch.int64}


def container_dtype(dtype) -> torch.dtype:
    """The dtype :func:`as_container` gives tensors of ``dtype``."""
    dtype = torch_dtype(dtype)
    return _SIGNED_VIEW.get(dtype, dtype)


def as_container(x: torch.Tensor) -> torch.Tensor:
    """View uint16/uint32/uint64 tensors as int16/int32/int64; other dtypes
    unchanged."""
    if x.dtype in _SIGNED_VIEW:
        return x.view(_SIGNED_VIEW[x.dtype])
    return x


def from_container(x: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`as_container` for a tensor of logical ``dtype``."""
    dtype = torch_dtype(dtype)
    if dtype in _SIGNED_VIEW:
        return x.view(dtype)
    return x


def key_dtype(dtype) -> np.dtype:
    """numpy dtype of a key dtype the sort accepts: unsigned, signed or
    float of 1, 2, 4 or 8 bytes, as the JAX ``to_sortable_unsigned``
    accepts them by kind; ``TypeError`` for any other."""
    d = np_dtype(dtype)
    if d.kind not in "uif" or d.itemsize not in _SIGNED_CONTAINER:
        raise TypeError(f"unsupported key dtype {d}")
    return d


def _image(bits: torch.Tensor, kind: str, width: int) -> torch.Tensor:
    """The sortable image of ``width``-bit keys bit-viewed as the signed
    int of that width: the sign bit flipped for ints, and for floats every
    bit of a negative (the arithmetic shift gives -1), the sign bit of the
    rest."""
    sign = sign_bit(width)
    if kind == "u":
        return bits
    if kind == "i":
        return bits ^ sign
    return bits ^ ((bits >> (width - 1)) | sign)


def _unimage(bits: torch.Tensor, kind: str, width: int) -> torch.Tensor:
    """Inverse of :func:`_image` on the same signed int."""
    sign = sign_bit(width)
    if kind == "u":
        return bits
    if kind == "i":
        return bits ^ sign
    return bits ^ (~(bits >> (width - 1)) | sign)


def narrow_image(bits: torch.Tensor, kind: str) -> torch.Tensor:
    """The sortable image of 1- or 2-byte keys of ``kind`` ("u", "i" or
    "f") given by their bits (a tensor of any dtype of that width, viewed,
    never converted), zero-extended into int32."""
    w = bits.element_size()
    img = _image(bits.view(_NARROW_INT[w]), kind, 8 * w)
    return img.view(_NARROW_UINT[w]).to(torch.int32)


def to_sortable(keys: torch.Tensor) -> torch.Tensor:
    """Keys → signed-container bits whose unsigned order is the key order.
    A 1- or 2-byte key takes its image at its own width (a float is
    bit-viewed, never converted), then zero-extends into int32."""
    d = key_dtype(keys.dtype)
    if d.itemsize < 4:
        return narrow_image(keys, d.kind)
    return _image(keys.view(signed_container(d)), d.kind, key_bits(d))


def from_sortable(bits: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`to_sortable`: bits back to the caller's dtype (a
    1- or 2-byte key narrows first: int32 → int8/int16 keeps the low
    bits)."""
    d = key_dtype(dtype)
    if d.itemsize < 4:
        bits = bits.to(_NARROW_INT[d.itemsize])
    return _unimage(bits, d.kind, key_bits(d)).view(torch_dtype(d))


# Padding sentinel: the maximum UNSIGNED container value, every bit set,
# which is -1 in the signed container.  Stable sorts keep real keys equal
# to it ahead of the padding rows that carry it.
SENTINEL_BITS = -1


def complement(bits: torch.Tensor, total_bits: int) -> torch.Tensor:
    """Reverse the unsigned order of ``total_bits``-wide sortable bits (a
    descending key), keeping an 8- or 16-bit image inside its width, where a
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
    d = key_dtype(keys.dtype)
    u = unsigned_container(d)
    if d.kind == "u":
        return keys
    if d.kind == "i":
        return keys.view(u) ^ u.type(1 << (key_bits(d) - 1))
    bits = keys.view(u)
    sign = u.type(1 << (key_bits(d) - 1))
    mask = np.where((bits & sign) != 0, u.type(~u.type(0)), sign)
    return bits ^ mask


def np_from_sortable_unsigned(ukeys: np.ndarray, dtype) -> np.ndarray:
    d = key_dtype(dtype)
    u = unsigned_container(d)
    if d.kind == "u":
        return ukeys.astype(d)
    if d.kind == "i":
        return (ukeys ^ u.type(1 << (key_bits(d) - 1))).view(d)
    sign = u.type(1 << (key_bits(d) - 1))
    mask = np.where((ukeys & sign) != 0, sign, u.type(~u.type(0)))
    return (ukeys ^ mask).view(d)


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
