"""The merge-sort kernels: CUDA launches with their plain torch versions.

Port of ``radix_sort_tpu/ops/pallas_merge.py``.  The CUDA C++ is in
``csrc/merge.cu``, built by ``_build.py`` at first use.  As in
``cuda_radix.py``, each public function checks its inputs and dispatches on
the device of the tensor it was given: a CUDA tensor launches the kernel or
raises, a CPU tensor runs the plain version (``*_plain``), which is also
what ``chip_smoke.py`` and the card tests compare the kernels with.  Each
wrapper counts its launches in ``launches``.

The kernels work on the sign-flipped int32 domain of ``pallas_merge.py``
(``dtypes.signed_order`` of the sortable bits), whose signed order is the
keys' unsigned order; the padding sentinel is INT32_MAX.  Key-only sorts are
value-exact: a sentinel can only displace a real key of the same value.
"""

from __future__ import annotations

import functools

import torch

from .. import _build, dtypes
from ..status import EngineError, OperationStatus
from . import cuda_radix as cr

TILE = 16384  # elements a CTA sorts; the JAX engine's 128 x 128 tile
SENTINEL = 2**31 - 1


def _check_tiles(x: torch.Tensor, what: str) -> int:
    cr._check_plane(x, what)
    if x.numel() == 0 or x.numel() % TILE:
        raise ValueError(f"{what}: {x.numel()} elements is not a positive "
                         f"multiple of the tile {TILE}")
    return x.numel() // TILE


@functools.cache
def _lib():
    """The kernel library, once checked to be built for this TILE."""
    lib = _build.lib()
    if lib.rst_merge_tile() != TILE:
        raise EngineError(OperationStatus.INITIALIZATION_FAILED,
                          f"merge.cu sorts tiles of {lib.rst_merge_tile()} "
                          f"keys, cuda_merge.TILE is {TILE}")
    return lib


# ------------------------------------------------------------------ K5

def tile_sort_plain(x: torch.Tensor) -> torch.Tensor:
    return x.view(-1, TILE).sort(dim=1).values.reshape(-1)


def tile_sort(x: torch.Tensor) -> torch.Tensor:
    """Sort each TILE-element block of a (tiles * TILE,) int32 tensor
    ascending (the JAX ``tile_sort`` contract)."""
    _check_tiles(x, "tile_sort input")
    if not cr._on_cuda(x):
        return tile_sort_plain(x)
    out = torch.empty_like(x)
    _build.check(_lib().rst_tile_sort(
        x.data_ptr(), x.numel(), out.data_ptr(), cr._stream(x)), "tile_sort")
    tile_sort.launches += 1
    return out


tile_sort.launches = 0


# ------------------------------------------------------------------ K6

def level_splits_plain(x: torch.Tensor, level: int):
    """Per-output-tile merge-path splits of one level: ``_merge_splits`` +
    ``_level_splits`` of ``pallas_merge.py``, vectorised.  Returns int32
    (ia, ib, la): output tile t takes A's window [ia, ia + la) and B's
    [ib, ib + TILE - la)."""
    num_tiles = x.numel() // TILE
    run = TILE << level
    per_pair = 2 << level
    t = torch.arange(num_tiles, dtype=torch.int64, device=x.device)
    in_pair = t % per_pair
    base = t // per_pair * 2 * run
    g = in_pair * TILE
    lo = (g - run).clamp(min=0)
    hi = g.clamp(max=run)
    nmax = x.numel() - 1
    for _ in range(run.bit_length() + 1):  # log2(run) + 2, as the JAX loop
        mid = (lo + hi) // 2
        j = g - mid - 1
        a_v = x[(base + mid).clamp(0, nmax)]
        b_v = x[(base + run + j).clamp(0, nmax)]
        # "split too small" iff A[mid] sorts before-or-with B[j] (ties pull
        # from A), with the run edges of pallas_merge.py:216-224
        too_small = (mid < run) & (j >= 0) & ((j >= run) | (a_v <= b_v))
        lo = torch.where(too_small, mid + 1, lo)
        hi = torch.where(too_small, hi, mid)
    nxt = torch.cat([lo[1:], lo[-1:]])
    # the last tile of a pair consumes whatever remains of A
    ia_next = torch.where(in_pair == per_pair - 1, run, nxt)
    return ((base + lo).to(torch.int32), (base + run + g - lo).to(torch.int32),
            (ia_next - lo).to(torch.int32))


def merge_level_plain(x: torch.Tensor, ia, ib, la) -> torch.Tensor:
    """One merge level from given splits: gather both windows, mask their
    tails with the sentinel, sort each row and keep its first TILE."""
    col = torch.arange(TILE, dtype=torch.int64, device=x.device)
    nmax = x.numel() - 1

    def window(start, length):
        idx = (start.to(torch.int64)[:, None] + col).clamp(max=nmax)
        return torch.where(col < length.to(torch.int64)[:, None], x[idx],
                           SENTINEL)

    rows = torch.cat([window(ia, la), window(ib, TILE - la)], dim=1)
    return rows.sort(dim=1).values[:, :TILE].reshape(-1)


def merge_level(x: torch.Tensor, level: int, with_splits: bool = False):
    """Merge the sorted runs of 2^level tiles of ``x`` pairwise.

    On the card one launch does the level: its CTAs find their own splits
    (a producer warp a window buffer), so no per-level torch glue or split
    launch surrounds it.  The kernel copies the windows with 16-byte bulk
    copies, so a CUDA ``x`` must start on a 16-byte boundary (a fresh
    tensor does; a view such as ``buf[1:]`` raises ValueError).  Returns
    (merged, splits), splits the int32 (ia, ib, la) the merge used when
    ``with_splits`` (``level_splits_plain``'s contract), else None."""
    num_tiles = _check_tiles(x, "merge_level input")
    if level < 0 or num_tiles % (2 << level):
        raise ValueError(f"merge_level: {num_tiles} tiles cannot be merged "
                         f"in pairs of runs of 2^{level} tiles")
    if not cr._on_cuda(x):
        splits = level_splits_plain(x, level)
        return merge_level_plain(x, *splits), (splits if with_splits
                                               else None)
    if x.data_ptr() % 16:
        raise ValueError("merge_level input on the card must start on a "
                         "16-byte boundary (the kernel's bulk copies)")
    out = torch.empty_like(x)
    splits = torch.empty((3, num_tiles), dtype=torch.int32, device=x.device)
    _build.check(_lib().rst_merge_level(
        x.data_ptr(), x.numel(), level, splits[0].data_ptr(),
        splits[1].data_ptr(), splits[2].data_ptr(), out.data_ptr(),
        cr._stream(x)), "merge_level")
    merge_level.launches += 1
    return out, (tuple(splits) if with_splits else None)


merge_level.launches = 0


# ------------------------------------------------------------ the sort

def merge_sort_bits(keys_bits: torch.Tensor) -> torch.Tensor:
    """Key-only ascending sort of sortable 32-bit key bits (an int32
    tensor whose UNSIGNED order is the key order; ``dtypes.to_sortable``).

    Pads to a power-of-two number of tiles with the sentinel (the merge
    pairs runs), so n just above a power of two takes twice its memory;
    then K5 once and K6 once per level (one launch each), as
    ``_merge_sort_i32``."""
    if keys_bits.dtype != torch.int32 or keys_bits.ndim != 1:
        raise ValueError(f"merge_sort_bits takes 1-D int32 bits, got "
                         f"{keys_bits.dtype} {tuple(keys_bits.shape)}")
    n = keys_bits.numel()
    if n == 0:
        return keys_bits.clone()
    num_tiles = 1 << (-(-n // TILE) - 1).bit_length()
    x = torch.full((num_tiles * TILE,), SENTINEL, dtype=torch.int32,
                   device=keys_bits.device)
    torch.bitwise_xor(keys_bits, dtypes.sign_bit(32), out=x[:n])
    x = tile_sort(x)
    for level in range(num_tiles.bit_length() - 1):
        x, _ = merge_level(x, level)
    return dtypes.signed_order(x[:n])


def launch_counts() -> dict:
    """Launch counters of the two kernels, by kernel name."""
    return {"tile_sort": tile_sort.launches,
            "merge_level": merge_level.launches}


def reset_launch_counts() -> None:
    tile_sort.launches = 0
    merge_level.launches = 0
