"""The plain reference of a stable sort, in plain PyTorch.

The answer is the stable sort of the input: keys in ascending order and,
for a key-value sort, every payload row moved with its key, rows of equal
keys in input order.  ``expected`` takes ``torch.sort(stable=True)`` of
an int64 image of the keys whose signed order is the keys' order (written
here, not taken from the program); ``compare`` counts the rows whose key
bits or payload differ from it.  Both limits are 0: the sort is exact.

The control breaks the exact order: a stable sort by the key's image with
its low 8 bits dropped, as a sort on a 24-bit (float32) image of a 32-bit
key would order it."""

from __future__ import annotations

import torch

LIMITS = {"keys_wrong": 0, "values_wrong": 0}
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def _bits(keys: torch.Tensor) -> torch.Tensor:
    """The keys' bits in the signed int of their width."""
    if keys.dtype == torch.uint8:
        return keys.view(torch.int8)
    return keys.view(_SIGNED[keys.element_size()])


def order_image(keys: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the order of ``keys`` (unsigned or
    signed ints, or IEEE floats with -0.0 below +0.0)."""
    width = 8 * keys.element_size()
    b = _bits(keys).to(torch.int64)
    if keys.dtype.is_floating_point:
        # negatives: all bits but the sign flipped, so larger magnitudes
        # order lower
        return torch.where(b < 0, b ^ ((1 << (width - 1)) - 1), b)
    if keys.dtype in _UNSIGNED:
        if width == 64:
            return b ^ (-(1 << 63))
        return b & ((1 << width) - 1)
    return b


def _stable(image: torch.Tensor) -> torch.Tensor:
    return torch.sort(image, stable=True).indices


def _answer(inputs: dict, perm: torch.Tensor) -> dict:
    """The rows of ``inputs`` in the order ``perm``; keys gathered as bits
    (torch gathers no uint32), then viewed back as the keys' dtype."""
    keys = inputs["keys"]
    out = {"keys": _bits(keys)[perm].view(keys.dtype)}
    if "values" in inputs:
        out["values"] = inputs["values"][perm]
    return out


def expected(cell, inputs: dict) -> dict:
    return _answer(inputs, _stable(order_image(inputs["keys"])))


def compare(cell, inputs: dict, expected: dict, answer: dict) -> dict:
    n = expected["keys"].shape[0]
    if any(answer.get(k) is None or answer[k].shape != v.shape
           for k, v in expected.items()):
        return {"keys_wrong": n, "values_wrong": n}
    keys_wrong = int((_bits(answer["keys"]) != _bits(expected["keys"]))
                     .sum())
    values_wrong = 0
    if "values" in expected:
        values_wrong = int((answer["values"] != expected["values"]).sum())
    return {"keys_wrong": keys_wrong, "values_wrong": values_wrong}


def control(cell, inputs: dict) -> dict:
    return _answer(inputs, _stable(order_image(inputs["keys"]) >> 8))
