"""The radix-pass kernels: CUDA launches with their plain torch versions.

Port of ``radix_sort_tpu/ops/pallas_radix.py``.  The CUDA C++ is in
``csrc/radix.cu``, built by ``_build.py`` at first use.  Each public
function checks its inputs, then dispatches on the device of the tensors
it was given:

- a CUDA tensor launches the kernel, or raises if the build or the launch
  fails; nothing gives way to the plain version;
- a CPU tensor runs the plain version (``*_plain``), which is also what
  ``chip_smoke.py`` and the card tests compare the kernels with.

Each wrapper carries ``launches``, a plain int that counts the kernel
launches it made, so a run can show that its path went through the kernel.

All kernels take int32 planes: keys of every width travel as int32 word
planes (ops/stream.py), so one set of kernels serves every key type.
Element counts stay below 2^31 because destinations are int32.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..config import DEFAULT_CONFIG, SortConfig
from ..status import EngineError, OperationStatus
from . import ranking

MAX_ELEMS = (1 << 31) - 1


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise EngineError(OperationStatus.CALCULATION_FAILED,
                      f"unsupported device {t.device}")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check_plane(x: torch.Tensor, what: str, device=None) -> None:
    if x.dtype != torch.int32 or x.ndim != 1 or not x.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 1-D int32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.numel() > MAX_ELEMS:
        raise EngineError(OperationStatus.HOST_BUFFERS_FAILED,
                          f"{what}: {x.numel()} elements; int32 destinations "
                          f"need fewer than 2^31")
    if device is not None and x.device != device:
        raise ValueError(f"{what} is on {x.device}, expected {device}")


def _check_radix(radix: int) -> None:
    if radix < 2 or radix > 256 or radix & (radix - 1):
        raise ValueError(f"radix must be a power of two in [2, 256], got "
                         f"{radix}")


def _digits(x: torch.Tensor, radix: int, shift: int) -> torch.Tensor:
    # Exact on the signed container: the mask drops every bit that the
    # arithmetic shift fills in.
    return (x >> shift) & (radix - 1)


# ------------------------------------------------------------------ K1
#
# Replaces pallas_radix.digit_histogram (_hist_kernel_narrow/_wide).  The
# kernel reads the plane once and extracts the digit itself, so no digit
# plane is written and read back between passes.

def digit_histogram_plain(x: torch.Tensor, radix: int, tile: int,
                          shift: int = 0) -> torch.Tensor:
    n = x.shape[0]
    B = -(-n // tile)
    blk = torch.arange(n, device=x.device, dtype=torch.int64) // tile
    key = blk * radix + _digits(x, radix, shift).to(torch.int64)
    return torch.bincount(key, minlength=B * radix).view(B, radix).to(
        torch.int32)


def digit_histogram(x: torch.Tensor, radix: int, tile: int, shift: int = 0,
                    threads: int = DEFAULT_CONFIG.threads_per_cta
                    ) -> torch.Tensor:
    """Per-tile digit counts: (n,) int32 plane → (B, R) int32, B =
    ceil(n / tile), counting the digit ``(x >> shift) & (R - 1)``.  A plane
    of digits in [0, R) with ``shift=0`` meets the JAX kernel's contract.

    On CUDA the result is the transposed view of a contiguous (R, B)
    tensor: the digit-major layout that ``_stitch_block_base`` scans."""
    _check_plane(x, "digit_histogram input")
    _check_radix(radix)
    if not _on_cuda(x):
        return digit_histogram_plain(x, radix, tile, shift)
    n = x.numel()
    B = -(-n // tile)
    out = torch.empty((radix, B), dtype=torch.int32, device=x.device)
    if n:
        _build.check(_build.lib().rst_digit_histogram(
            x.data_ptr(), n, tile, threads, shift, radix, out.data_ptr(),
            1, B, _stream(x)), "digit_histogram")
        digit_histogram.launches += 1
    return out.T


digit_histogram.launches = 0


# ------------------------------------------------------------------ K2
#
# Replaces pallas_radix.exclusive_scan (_scan_kernel).  One single-pass
# launch with decoupled look-back; its scratch (a tile-id counter and one
# status word a tile) is allocated here for each call and zeroed by the C
# entry point on the same stream, so calls on two streams share nothing.

def exclusive_scan_plain(x: torch.Tensor) -> torch.Tensor:
    # dtype= keeps the int32 wraparound (torch.cumsum would give int64).
    return torch.cumsum(x, 0, dtype=torch.int32) - x


def exclusive_scan(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of a 1-D int32 tensor (wrapping like int32).
    A view may start anywhere (``x[1:]``); the output is a new tensor."""
    _check_plane(x, "exclusive_scan input")
    if not _on_cuda(x):
        return exclusive_scan_plain(x)
    n = x.numel()
    out = torch.empty_like(x)
    if n:
        lib = _build.lib()
        nbytes = lib.rst_scan_scratch_bytes(n)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
        _build.check(lib.rst_exclusive_scan(
            x.data_ptr(), n, out.data_ptr(), scratch.data_ptr(), nbytes,
            _stream(x)), "exclusive_scan")
        exclusive_scan.launches += 1
    return out


exclusive_scan.launches = 0


# --------------------------------------------------------------- K3 + K4
#
# Replaces pallas_radix.rank_pass (_rank_kernel) and the XLA scatter of
# ranking.apply_destinations after it, and pallas_stream._radix_pass
# (_pass_kernel) with its _boundary_fixup epilogue: one launch ranks a tile
# and moves every plane.  Bound by bytes: each plane is read and written
# once a pass; the kernel stages each tile in digit order in shared memory
# so its writes land in runs of consecutive addresses.  One kernel, two
# modes: ``rank_scatter`` takes the (B, R) base table of
# ``_stitch_block_base``; ``onesweep_pass`` finds each tile's base by
# decoupled look-back from the pass's (R,) digit totals, so a pass is one
# launch.

def _stitch_block_base_plain(counts: torch.Tensor) -> torch.Tensor:
    B, R = counts.shape
    return exclusive_scan_plain(counts.T.reshape(-1)).view(R, B).T


def rank_scatter_plain(digit_src: torch.Tensor, planes, base: torch.Tensor,
                       radix: int, tile: int, shift: int = 0,
                       with_dest: bool = False):
    d = _digits(digit_src, radix, shift).to(torch.int64)
    _, rank = ranking.tile_ranks(d, radix, tile)
    blk = torch.arange(d.shape[0], device=d.device, dtype=torch.int64) // tile
    dest = base.to(torch.int64)[blk, d] + rank
    outs = ranking.apply_destinations(dest, planes)
    return outs, (dest.to(torch.int32) if with_dest else None)


def _check_pass(digit_src: torch.Tensor, planes, radix: int, what: str):
    planes = tuple(planes)
    _check_plane(digit_src, f"{what} digit plane")
    n = digit_src.numel()
    for p in planes:
        _check_plane(p, f"{what} plane", digit_src.device)
        if p.numel() != n:
            raise ValueError("every plane must have the digit plane's length")
    _check_radix(radix)
    return planes


def _launch_groups(lib, planes, outs):
    """(ins, outs, count) ctypes arrays for each launch: at most
    rst_max_planes() planes a launch, and one launch with no plane."""
    step = lib.rst_max_planes()
    for lo in range(0, max(len(planes), 1), step):
        grp = range(lo, min(lo + step, len(planes)))
        yield ((ctypes.c_void_p * step)(*(planes[i].data_ptr() for i in grp)),
               (ctypes.c_void_p * step)(*(outs[i].data_ptr() for i in grp)),
               len(grp))


def rank_scatter(digit_src: torch.Tensor, planes, base: torch.Tensor,
                 radix: int, tile: int, shift: int = 0,
                 with_dest: bool = False,
                 threads: int = DEFAULT_CONFIG.threads_per_cta):
    """One stable radix pass: every plane of ``planes`` moves to the stable
    destination of its element's digit ``(digit_src >> shift) & (R-1)``.

    ``base`` is the (B, R) global offset table of ``_stitch_block_base``
    for the same digits and tile.  ``digit_src`` may be one of ``planes``.
    Returns (planes_out, dest) where dest is the (n,) int32 destination
    table when ``with_dest`` (the JAX ``rank_pass`` contract), else None."""
    planes = _check_pass(digit_src, planes, radix, "rank_scatter")
    dev = digit_src.device
    n = digit_src.numel()
    B = -(-n // tile)
    if tuple(base.shape) != (B, radix) or base.dtype != torch.int32:
        raise ValueError(f"base must be ({B}, {radix}) int32, got "
                         f"{base.dtype} {tuple(base.shape)}")
    if not _on_cuda(digit_src):
        return rank_scatter_plain(digit_src, planes, base, radix, tile, shift,
                                  with_dest)
    if base.device != dev:
        raise ValueError(f"base is on {base.device}, expected {dev}")
    outs = tuple(torch.empty_like(p) for p in planes)
    dest = torch.empty_like(digit_src) if with_dest else None
    if n == 0:
        return outs, dest
    base_rb = base.T.contiguous()  # digit-major (R, B); free from the stitch
    lib = _build.lib()
    # more planes than one launch takes: further launches re-rank the tile
    for g, (ins, outp, k) in enumerate(_launch_groups(lib, planes, outs)):
        _build.check(lib.rst_rank_scatter(
            digit_src.data_ptr(), n, tile, threads, shift, radix,
            base_rb.data_ptr(), ins, outp, k,
            dest.data_ptr() if (dest is not None and g == 0) else None,
            _stream(digit_src)), "rank_scatter")
        rank_scatter.launches += 1
    return outs, dest


rank_scatter.launches = 0


def rank_pass(digits: torch.Tensor, block_base: torch.Tensor, radix: int,
              tile: int, threads: int = DEFAULT_CONFIG.threads_per_cta
              ) -> torch.Tensor:
    """Stable destinations for one radix pass (the JAX ``rank_pass``
    contract): digits (n,) int32 in [0, R), block_base (B, R) int32 →
    (n,) int32.  Runs the rank_scatter kernel with no plane to move."""
    return rank_scatter(digits, (), block_base, radix, tile,
                        with_dest=True, threads=threads)[1]


def _stitch_block_base(counts: torch.Tensor) -> torch.Tensor:
    """(B, R) per-tile counts → (B, R) global exclusive offsets, scanned
    digit-major (RadixSort.cl:69): the transposed (R, B) flat histogram is
    scanned and transposed back, so every digit-d element of an earlier
    tile precedes the digit-d elements of a later one — the stability of
    the scatter rests on this layout."""
    B, R = counts.shape
    scanned = exclusive_scan(counts.T.reshape(-1))
    return scanned.view(R, B).T


# ------------------------------------------------- K1 family, every pass
#
# The onesweep sort's histogram: the digit counts of every pass from one
# read of each key word plane, in place of a digit_histogram launch (and a
# scan) a pass.  Plane w carries passes[w] digits, pass j's being
# ``(x >> j * bits) & (R - 1)``.

MAX_HIST_PLANES = 2


def pass_histograms_plain(planes, passes, radix: int) -> torch.Tensor:
    bits = radix.bit_length() - 1
    rows = [torch.bincount(_digits(x, radix, j * bits).to(torch.int64),
                           minlength=radix)
            for x, np_ in zip(planes, passes) for j in range(np_)]
    return torch.stack(rows).to(torch.int32)


def pass_histograms(planes, passes, radix: int) -> torch.Tensor:
    """(P, R) int32 digit counts of every pass, P = sum(passes): the first
    plane's passes[0] rows, then the second plane's; pass j of a plane
    counts the digit ``(x >> j * log2(R)) & (R - 1)``.  One launch (and one
    memset of the table) for up to two planes."""
    planes, passes = tuple(planes), tuple(int(p) for p in passes)
    _check_radix(radix)
    bits = radix.bit_length() - 1
    if not 1 <= len(planes) <= MAX_HIST_PLANES or len(passes) != len(planes):
        raise ValueError(f"pass_histograms takes 1 to {MAX_HIST_PLANES} "
                         f"planes and a pass count for each")
    if any(p < 1 or (p - 1) * bits > 31 for p in passes):
        raise ValueError(f"pass counts {passes} do not fit 32-bit planes of "
                         f"{bits}-bit digits")
    n = planes[0].numel()
    for x in planes:
        _check_plane(x, "pass_histograms plane", planes[0].device)
        if x.numel() != n:
            raise ValueError("every plane must have the same length")
    if not _on_cuda(planes[0]):
        return pass_histograms_plain(planes, passes, radix)
    out = torch.empty((sum(passes), radix), dtype=torch.int32,
                      device=planes[0].device)
    if n == 0:
        return out.zero_()
    x1 = planes[1] if len(planes) > 1 else planes[0]
    _build.check(_build.lib().rst_pass_histograms(
        planes[0].data_ptr(), passes[0], x1.data_ptr(),
        passes[1] if len(planes) > 1 else 0, n, radix, out.data_ptr(),
        _stream(planes[0])), "pass_histograms")
    pass_histograms.launches += 1
    return out


pass_histograms.launches = 0


def onesweep_scratch(n: int, radix: int, tile: int, passes: int,
                     device) -> torch.Tensor:
    """Look-back scratch for ``passes`` passes over n elements on a card:
    (passes, bytes) uint8, row i for the i-th pass that runs, all zeroed by
    one memset on the current stream."""
    lib = _build.lib()
    per = lib.rst_onesweep_scratch_bytes(n, tile, radix)
    scratch = torch.empty((passes, per), dtype=torch.uint8, device=device)
    if scratch.numel():
        _build.check(lib.rst_zero(scratch.data_ptr(), scratch.numel(),
                                  _stream(scratch)), "onesweep scratch")
    return scratch


def onesweep_pass_plain(digit_src: torch.Tensor, planes, radix: int,
                        tile: int, shift: int = 0, with_dest: bool = False):
    base = _stitch_block_base_plain(
        digit_histogram_plain(digit_src, radix, tile, shift))
    return rank_scatter_plain(digit_src, planes, base, radix, tile, shift,
                              with_dest)


def onesweep_pass(digit_src: torch.Tensor, planes, counts: torch.Tensor,
                  radix: int, tile: int, shift: int = 0, *,
                  scratch: torch.Tensor | None = None, outs=None,
                  with_dest: bool = False,
                  threads: int = DEFAULT_CONFIG.threads_per_cta):
    """One stable radix pass as a single launch: the planes move as
    ``rank_scatter`` moves them, each tile's offsets found by look-back.

    ``counts`` is the (R,) int32 digit total of this pass (a row of
    ``pass_histograms``).  ``scratch`` is a zeroed row of
    ``onesweep_scratch``, used once; None allocates and zeroes one.
    ``outs`` are tensors like ``planes`` to write into (None allocates).
    Returns (planes_out, dest), dest as in ``rank_scatter``."""
    planes = _check_pass(digit_src, planes, radix, "onesweep_pass")
    dev = digit_src.device
    n = digit_src.numel()
    if tuple(counts.shape) != (radix,) or counts.dtype != torch.int32:
        raise ValueError(f"counts must be ({radix},) int32, got "
                         f"{counts.dtype} {tuple(counts.shape)}")
    if outs is not None:
        outs = tuple(outs)
        if len(outs) != len(planes) or any(
                o.shape != p.shape or o.dtype != p.dtype or o.device != dev
                or not o.is_contiguous() for o, p in zip(outs, planes)):
            raise ValueError("outs must match planes")
    if not _on_cuda(digit_src):
        res, dest = onesweep_pass_plain(digit_src, planes, radix, tile,
                                        shift, with_dest)
        if outs is None:
            return res, dest
        for o, r in zip(outs, res):
            o.copy_(r)
        return outs, dest
    if counts.device != dev:
        raise ValueError(f"counts is on {counts.device}, expected {dev}")
    if outs is None:
        outs = tuple(torch.empty_like(p) for p in planes)
    dest = torch.empty_like(digit_src) if with_dest else None
    if n == 0:
        return outs, dest
    lib = _build.lib()
    if scratch is None:
        scratch = onesweep_scratch(n, radix, tile, 1, dev)[0]
    if (scratch.device != dev or not scratch.is_contiguous()
            or scratch.nbytes < lib.rst_onesweep_scratch_bytes(n, tile,
                                                               radix)):
        raise ValueError("scratch is not a row of onesweep_scratch for "
                         "this pass")
    groups = list(_launch_groups(lib, planes, outs))
    B = -(-n // tile)
    # later plane groups run in base-table mode from the first's tile bases
    base_rb = (torch.empty((radix, B), dtype=torch.int32, device=dev)
               if len(groups) > 1 else None)
    stream = _stream(digit_src)
    ins, outp, k = groups[0]
    _build.check(lib.rst_onesweep_pass(
        digit_src.data_ptr(), n, tile, threads, shift, radix,
        counts.data_ptr(), scratch.data_ptr(), scratch.nbytes, ins, outp, k,
        dest.data_ptr() if dest is not None else None,
        base_rb.data_ptr() if base_rb is not None else None, stream),
        "onesweep_pass")
    onesweep_pass.launches += 1
    for ins, outp, k in groups[1:]:
        _build.check(lib.rst_rank_scatter(
            digit_src.data_ptr(), n, tile, threads, shift, radix,
            base_rb.data_ptr(), ins, outp, k, None, stream), "rank_scatter")
        rank_scatter.launches += 1
    return outs, dest


onesweep_pass.launches = 0


def sort_biased(keys_bits: torch.Tensor, payloads,
                config: SortConfig = DEFAULT_CONFIG,
                total_bits: int | None = None):
    """Stable LSD radix sort of sortable key bits (int32/int64 containers,
    unsigned order; dtypes.to_sortable) with a tuple of payload tensors that
    ride the same permutation: one pass_histograms launch, then one
    onesweep_pass a pass that one digit does not fill, over int32 planes
    (ops/stream.py); ``total_bits`` (default: the container's width) sets
    the passes."""
    from . import stream

    planes, specs = stream.payloads_to_planes(payloads)
    keys_out, planes_out = stream.sort_planes(
        keys_bits, planes, radix=config.radix, tile=config.tile_elems,
        threads=config.threads_per_cta, total_bits=total_bits)
    return keys_out, stream.planes_to_payloads(planes_out, specs)


_COUNTED = (digit_histogram, exclusive_scan, rank_scatter, pass_histograms,
            onesweep_pass)


def launch_counts() -> dict:
    """Launch counters of the radix kernels, by wrapper name
    (``rank_scatter`` counts base-table launches, ``onesweep_pass``
    look-back launches)."""
    return {f.__name__: f.launches for f in _COUNTED}


def reset_launch_counts() -> None:
    for f in _COUNTED:
        f.launches = 0
