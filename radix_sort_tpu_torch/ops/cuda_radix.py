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

Payload planes are int32, or int64: an 8-byte column's bits as they are,
moved at 8 bytes an element by the pass kernel's wide instance.  The key
(digit) plane of ``pass_histograms``,
``rank_scatter`` and ``onesweep_pass`` is an int32 word plane (4- and
8-byte keys travel as word planes, ops/stream.py), whose digit is taken
from its bits as they are, or the caller's own 1- or 2-byte keys (uint8,
int8; int16, uint16, float16) with their kind (``"u"``, ``"i"`` or
``"f"``): the kernels take the digit from the key's sortable image in
registers and move the key's bits at their own width.  Element counts
stay below 2^31 because destinations are int32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build, dtypes
from ..config import DEFAULT_CONFIG
from ..status import EngineError, OperationStatus
from ..utils import profiling
from . import ranking

MAX_ELEMS = (1 << 31) - 1


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise EngineError(OperationStatus.CALCULATION_FAILED,
                      f"unsupported device {t.device}")


def _stream(t: torch.Tensor) -> int:
    """The current stream of ``t``'s card as a raw pointer: the accessor
    torch's generated kernel launchers use, where ``current_stream()``
    builds a Stream object (a fifth of a small sort's host time)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _check_plane(x: torch.Tensor, what: str, device=None,
                 dtypes_ok=(torch.int32,)) -> None:
    if x.dtype not in dtypes_ok or x.ndim != 1 or not x.is_contiguous():
        names = "/".join(str(d).removeprefix("torch.") for d in dtypes_ok)
        raise ValueError(f"{what} must be a contiguous 1-D {names} tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.numel() > MAX_ELEMS:
        raise EngineError(OperationStatus.HOST_BUFFERS_FAILED,
                          f"{what}: {x.numel()} elements; int32 destinations "
                          f"need fewer than 2^31")
    if device is not None and x.device != device:
        raise ValueError(f"{what} is on {x.device}, expected {device}")


# dtypes of a narrow key plane, and the kinds of key it may hold
NARROW_KEY_DTYPES = (torch.uint8, torch.int8, torch.int16, torch.uint16,
                     torch.float16)
_KEY_PLANE_DTYPES = (torch.int32,) + NARROW_KEY_DTYPES
# dtypes of a payload plane: an 8-byte one moves as int64 bits
PLANE_DTYPES = (torch.int32, torch.int64)
_KINDS = {"u": 0, "i": 1, "f": 2}


def _check_key_plane(x: torch.Tensor, kind: str, what: str,
                     device=None) -> None:
    """An int32 word plane, whose bits are the digits' source (kind "u"),
    or a narrow key plane of NARROW_KEY_DTYPES with its kind."""
    _check_plane(x, what, device, _KEY_PLANE_DTYPES)
    if kind not in _KINDS or (x.dtype == torch.int32 and kind != "u"):
        raise ValueError(f"{what}: kind {kind!r} for a {x.dtype} plane; an "
                         f"int32 word plane takes 'u', a narrow key plane "
                         f"one of {tuple(_KINDS)}")


def _check_radix(radix: int) -> None:
    if radix < 2 or radix > 256 or radix & (radix - 1):
        raise ValueError(f"radix must be a power of two in [2, 256], got "
                         f"{radix}")


def _digits(x: torch.Tensor, radix: int, shift: int,
            kind: str = "u") -> torch.Tensor:
    # A narrow key's digits are its image's.  Exact on the signed
    # container: the mask drops every bit that the arithmetic shift fills
    # in.
    if x.element_size() < 4:
        x = dtypes.narrow_image(x, kind)
    return (x >> shift) & (radix - 1)


# ------------------------------------------------------------------ K1
#
# Replaces pallas_radix.digit_histogram (_hist_kernel_narrow/_wide).  The
# kernel reads the plane once and extracts the digit itself, so no digit
# plane is written and read back between passes.

def digit_histogram_plain(x: torch.Tensor, radix: int, tile: int,
                          shift: int = 0, kind: str = "u") -> torch.Tensor:
    n = x.shape[0]
    B = -(-n // tile)
    blk = torch.arange(n, device=x.device, dtype=torch.int64) // tile
    key = blk * radix + _digits(x, radix, shift, kind).to(torch.int64)
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
# launch.  A sort launches every pass with a ``PassPlan``: each launch
# decides on the card from the sort's pass table whether its pass runs and
# which buffer set it reads and writes, so the host reads nothing back.

def _stitch_block_base_plain(counts: torch.Tensor) -> torch.Tensor:
    B, R = counts.shape
    return exclusive_scan_plain(counts.T.reshape(-1)).view(R, B).T


def rank_scatter_plain(digit_src: torch.Tensor, planes, base: torch.Tensor,
                       radix: int, tile: int, shift: int = 0,
                       with_dest: bool = False, kind: str = "u"):
    d = _digits(digit_src, radix, shift, kind).to(torch.int64)
    _, rank = ranking.tile_ranks(d, radix, tile)
    blk = torch.arange(d.shape[0], device=d.device, dtype=torch.int64) // tile
    dest = base.to(torch.int64)[blk, d] + rank
    outs = ranking.apply_destinations(dest, planes)
    return outs, (dest.to(torch.int32) if with_dest else None)


def _check_pass(digit_src: torch.Tensor, planes, radix: int, shift: int,
                kind: str, what: str):
    """The planes of one pass: int32 or int64 planes, and a narrow digit
    plane among them only as the key plane itself."""
    planes = tuple(planes)
    _check_key_plane(digit_src, kind, f"{what} digit plane")
    n = digit_src.numel()
    if not 0 <= shift < 8 * digit_src.element_size():
        raise ValueError(f"shift {shift} outside a {digit_src.dtype} key")
    narrow = digit_src.dtype != torch.int32
    for p in planes:
        if narrow and p.dtype == digit_src.dtype:
            if n and p.data_ptr() != digit_src.data_ptr():
                raise ValueError(f"{what}: a {p.dtype} plane must be the "
                                 f"narrow key plane itself")
        else:
            _check_plane(p, f"{what} plane", digit_src.device, PLANE_DTYPES)
            if (narrow and n and p.dtype == torch.int32
                    and p.data_ptr() == digit_src.data_ptr()):
                raise ValueError(f"{what}: an int32 plane aliases the "
                                 f"narrow key plane")
        if p.numel() != n:
            raise ValueError("every plane must have the digit plane's length")
    _check_radix(radix)
    return planes


def _key_args(digit_src: torch.Tensor, kind: str):
    """The key plane's (bytes a key, kind) arguments of the C entries."""
    return digit_src.element_size(), _KINDS[kind]


def _ptrs(tensors):
    """A ctypes array of the tensors' device pointers (None for None)."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def _plane_bytes(planes):
    """The C entries' ``plane_bytes``: a ctypes array of each plane's bytes
    an element, or None where no plane is 8 bytes (the 4-byte instance)."""
    sizes = [p.element_size() for p in planes]
    return (ctypes.c_int * len(sizes))(*sizes) if 8 in sizes else None


def _wide(planes) -> int:
    """The planes of 8 bytes an element."""
    return sum(p.element_size() == 8 for p in planes)


def _wide_groups(planes) -> int:
    """The launch groups of ``planes`` (``_launch_groups``) that hold an
    8-byte plane: each launch of one runs the pass kernel's wide instance."""
    step = _build.max_planes()
    return sum(_wide(planes[lo:lo + step]) > 0
               for lo in range(0, len(planes), step))


def _launch_groups(planes, outs, tmps=None):
    """(ins, outs, tmps, count, plane_bytes) ctypes arrays for each launch
    (tmps None where ``tmps`` is): at most rst_max_planes() planes a
    launch, and one launch with no plane."""
    step = _build.max_planes()
    for lo in range(0, max(len(planes), 1), step):
        hi = lo + step
        yield (_ptrs(planes[lo:hi]), _ptrs(outs[lo:hi]),
               None if tmps is None else _ptrs(tmps[lo:hi]),
               min(step, len(planes) - lo), _plane_bytes(planes[lo:hi]))


def rank_scatter(digit_src: torch.Tensor, planes, base: torch.Tensor,
                 radix: int, tile: int, shift: int = 0,
                 with_dest: bool = False,
                 threads: int = DEFAULT_CONFIG.threads_per_cta,
                 kind: str = "u"):
    """One stable radix pass: every plane of ``planes`` moves to the stable
    destination of its element's digit ``(digit_src >> shift) & (R-1)``
    (of a narrow key plane's image, by ``kind``).

    ``base`` is the (B, R) global offset table of ``_stitch_block_base``
    for the same digits and tile.  ``digit_src`` may be one of ``planes``.
    Returns (planes_out, dest) where dest is the (n,) int32 destination
    table when ``with_dest`` (the JAX ``rank_pass`` contract), else None."""
    planes = _check_pass(digit_src, planes, radix, shift, kind,
                         "rank_scatter")
    dev = digit_src.device
    n = digit_src.numel()
    B = -(-n // tile)
    if tuple(base.shape) != (B, radix) or base.dtype != torch.int32:
        raise ValueError(f"base must be ({B}, {radix}) int32, got "
                         f"{base.dtype} {tuple(base.shape)}")
    if not _on_cuda(digit_src):
        return rank_scatter_plain(digit_src, planes, base, radix, tile, shift,
                                  with_dest, kind)
    if base.device != dev:
        raise ValueError(f"base is on {base.device}, expected {dev}")
    outs = tuple(torch.empty_like(p) for p in planes)
    dest = torch.empty(n, dtype=torch.int32, device=dev) if with_dest else None
    if n == 0:
        return outs, dest
    base_rb = base.T.contiguous()  # digit-major (R, B); free from the stitch
    lib = _build.lib()
    # more planes than one launch takes: further launches re-rank the tile
    for g, (ins, outp, _, k, nb) in enumerate(_launch_groups(planes, outs)):
        _build.check(lib.rst_rank_scatter(
            _ptrs((digit_src, None, None)), n, tile, threads, shift, radix,
            *_key_args(digit_src, kind), base_rb.data_ptr(), ins, outp, None,
            k, nb, dest.data_ptr() if (dest is not None and g == 0) else None,
            *_NO_PLAN, _stream(digit_src)), "rank_scatter")
        rank_scatter.launches += 1
        onesweep_pass.wide_launches += nb is not None
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
# read of each key plane, in place of a digit_histogram launch (and a scan)
# a pass.  Plane w carries passes[w] digits, pass j's being
# ``(x >> j * bits) & (R - 1)`` (of a narrow key plane's image).

MAX_HIST_PLANES = 2


def pass_histograms_plain(planes, passes, radix: int,
                          kind: str = "u") -> torch.Tensor:
    bits = radix.bit_length() - 1
    rows = [torch.bincount(_digits(x, radix, j * bits, kind).to(torch.int64),
                           minlength=radix)
            for x, np_ in zip(planes, passes) for j in range(np_)]
    return torch.stack(rows).to(torch.int32)


def pass_histograms(planes, passes, radix: int,
                    kind: str = "u") -> torch.Tensor:
    """(P, R) int32 digit counts of every pass, P = sum(passes): the first
    plane's passes[0] rows, then the second plane's; pass j of a plane
    counts the digit ``(x >> j * log2(R)) & (R - 1)``.  One launch (and one
    memset of the table) for up to two int32 word planes, or for one
    narrow key plane of ``kind``, whose digits are its image's."""
    planes, passes = tuple(planes), tuple(int(p) for p in passes)
    _check_radix(radix)
    bits = radix.bit_length() - 1
    if not 1 <= len(planes) <= MAX_HIST_PLANES or len(passes) != len(planes):
        raise ValueError(f"pass_histograms takes 1 to {MAX_HIST_PLANES} "
                         f"planes and a pass count for each")
    _check_key_plane(planes[0], kind, "pass_histograms plane")
    width = 8 * planes[0].element_size()
    if width < 32 and len(planes) > 1:
        raise ValueError("a narrow key plane goes to pass_histograms alone")
    if any(p < 1 or (p - 1) * bits >= width for p in passes):
        raise ValueError(f"pass counts {passes} do not fit {width}-bit "
                         f"planes of {bits}-bit digits")
    n = planes[0].numel()
    for x in planes[1:]:
        _check_plane(x, "pass_histograms plane", planes[0].device)
        if x.numel() != n:
            raise ValueError("every plane must have the same length")
    if not _on_cuda(planes[0]):
        return pass_histograms_plain(planes, passes, radix, kind)
    out = torch.empty((sum(passes), radix), dtype=torch.int32,
                      device=planes[0].device)
    if n == 0:
        return out.zero_()
    x1 = planes[1] if len(planes) > 1 else planes[0]
    _build.check(_build.lib().rst_pass_histograms(
        planes[0].data_ptr(), passes[0], x1.data_ptr(),
        passes[1] if len(planes) > 1 else 0, n, radix,
        *_key_args(planes[0], kind), out.data_ptr(), _stream(planes[0])),
        "pass_histograms")
    _count(pass_histograms, width)
    return out


pass_histograms.launches = 0
# launches with a narrow key plane, by its bits (counted in launches too)
pass_histograms.narrow_launches = {8: 0, 16: 0}


def onesweep_scratch(n: int, radix: int, tile: int, passes: int,
                     device) -> torch.Tensor:
    """Look-back scratch for ``passes`` passes over n elements on a card:
    (passes, bytes) uint8, row p for pass p of a sort, all zeroed by one
    memset on the current stream."""
    lib = _build.lib()
    per = lib.rst_onesweep_scratch_bytes(n, tile, radix)
    scratch = torch.empty((passes, per), dtype=torch.uint8, device=device)
    if scratch.numel():
        _build.check(lib.rst_zero(scratch.data_ptr(), scratch.numel(),
                                  _stream(scratch)), "onesweep scratch")
    return scratch


class PassPlan(NamedTuple):
    """What each launch of a sort's passes derives its plan from, on the
    card (``csrc/radix.cu``, ``Plan``): whether its pass runs, and which
    buffer set it reads and writes.  The sets are IN (the planes the sort
    was given, never written), OUT (the result) and TMP.

    ``table`` is the sort's (P, R) ``pass_histograms``, ``index`` this
    pass's row, ``keys`` the sort's key planes in IN (one, or a 64-bit
    key's lo and hi words; element 0 gives each pass's digit), ``passes0``
    the rows of ``keys[0]`` (the rest are ``keys[1]``'s), and ``tmp`` the
    TMP set, tensors like the planes (None for a sort of one pass, which
    never writes it)."""
    table: torch.Tensor
    index: int
    keys: tuple
    passes0: int
    tmp: tuple | None = None


MAX_PLAN_PASSES = 64  # a 64-bit key at radix 2
_NO_PLAN = (None, 0, 0, 0, None)  # the C entries' plan arguments: none


def plan_runs(table: torch.Tensor, keys, passes0: int, radix: int,
              kind: str = "u") -> list:
    """Which passes of a sort run, the plain version of every CTA's
    prologue: pass q runs unless one digit holds every key, i.e. unless
    ``table[q][digit_q(key 0)] == n`` (the JAX engine's ``max(totals) ==
    padded``).  A narrow ``keys[0]`` of ``kind`` gives its image's digits.
    Reads the table: on a CPU tensor that is no read of the card."""
    bits = radix.bit_length() - 1
    P = table.shape[0]
    digits = [_digits(keys[1][:1], radix, (q - passes0) * bits)
              if q >= passes0 else
              _digits(keys[0][:1], radix, q * bits, kind)
              for q in range(P)]
    d = torch.cat(digits).to(device=table.device, dtype=torch.int64)
    rows = torch.arange(P, device=table.device)
    return (table[rows, d] != keys[0].numel()).tolist()


def pass_role(runs, index: int):
    """(mode, src, dst) of pass ``index`` of a sort whose passes run as
    ``runs`` says: mode "run", "copy" (no pass runs: the last copies IN to
    OUT) or "skip"; src and dst 0 (IN), 1 (OUT) or 2 (TMP).  Of the m
    passes that run, the k-th reads IN (k = 0) or what the one before it
    wrote, and writes OUT when m - 1 - k is even, so the last writes OUT."""
    m, k = sum(runs), sum(runs[:index])

    def dst(j):
        return 2 if (m - 1 - j) % 2 else 1

    if runs[index]:
        return "run", (0 if k == 0 else dst(k - 1)), dst(k)
    if m == 0 and index == len(runs) - 1:
        return "copy", 0, 1
    return "skip", 0, 0


def _buffer_sets(planes, outs, tmp):
    return (tuple(planes), tuple(outs),
            tuple(outs) if tmp is None else tuple(tmp))


def _digit_sets(digit_src: torch.Tensor, planes, sets):
    """The digit plane in IN, OUT and TMP: the key plane's counterparts
    where it is one of ``planes`` (it moves), else ``digit_src`` in all
    three (a partition's ids).  An 8-byte plane is never the key's."""
    for i, p in enumerate(planes):
        if (p.numel() and p.dtype == digit_src.dtype
                and p.data_ptr() == digit_src.data_ptr()):
            return tuple(s[i] for s in sets)
    return (digit_src,) * 3


def _check_plan(plan: PassPlan, digit_src: torch.Tensor, planes,
                counts: torch.Tensor, radix: int, kind: str):
    table, keys = plan.table, tuple(plan.keys)
    P = table.shape[0] if table.ndim == 2 else 0
    if (table.dtype != torch.int32 or tuple(table.shape) != (P, radix)
            or not table.is_contiguous() or table.device != digit_src.device
            or not 1 <= P <= MAX_PLAN_PASSES):
        raise ValueError(f"plan.table must be a contiguous (P, {radix}) "
                         f"int32 tensor on {digit_src.device}, 1 <= P <= "
                         f"{MAX_PLAN_PASSES}")
    if not 0 <= plan.index < P or not 1 <= plan.passes0 <= P:
        raise ValueError(f"plan index {plan.index} / passes0 "
                         f"{plan.passes0} outside the table's {P} rows")
    if len(keys) != (1 if plan.passes0 == P else 2):
        raise ValueError("plan.keys: one key plane, or two where passes0 < P")
    for i, k in enumerate(keys):  # the pass's own planes are checked
        if k is digit_src or any(k is p for p in planes):
            continue
        if i == 0:
            _check_key_plane(k, kind, "plan key plane", digit_src.device)
        else:
            _check_plane(k, "plan key plane", digit_src.device)
        if k.numel() != digit_src.numel():
            raise ValueError("plan key planes must have the digit plane's "
                             "length")
    if counts.data_ptr() != table.data_ptr() + 4 * radix * plan.index:
        raise ValueError("counts must be plan.table[plan.index]")
    if plan.tmp is not None:
        _check_like(plan.tmp, planes, "plan.tmp")


def _check_like(bufs, planes, what: str):
    bufs = tuple(bufs)
    if len(bufs) != len(planes) or any(
            o.shape != p.shape or o.dtype != p.dtype or o.device != p.device
            or not o.is_contiguous() for o, p in zip(bufs, planes)):
        raise ValueError(f"{what} must match planes")
    return bufs


def _pass_plain(digit_src, planes, radix, tile, shift, with_dest, kind):
    base = _stitch_block_base_plain(
        digit_histogram_plain(digit_src, radix, tile, shift, kind))
    return rank_scatter_plain(digit_src, planes, base, radix, tile, shift,
                              with_dest, kind)


def onesweep_pass_plain(digit_src: torch.Tensor, planes, radix: int,
                        tile: int, shift: int = 0, with_dest: bool = False,
                        kind: str = "u", *, plan: PassPlan | None = None,
                        outs=None):
    """The plain version of ``onesweep_pass``; with a ``plan`` it does what
    the kernel's launch does: reads the set the plan says, writes ``outs``
    or ``plan.tmp``, copies IN to ``outs`` when no pass runs, or nothing,
    and returns (outs, None)."""
    if plan is None:
        return _pass_plain(digit_src, planes, radix, tile, shift, with_dest,
                           kind)
    sets = _buffer_sets(planes, outs, plan.tmp)
    mode, src, dst = pass_role(
        plan_runs(plan.table, plan.keys, plan.passes0, radix, kind),
        plan.index)
    if mode == "run":
        res, _ = _pass_plain(_digit_sets(digit_src, planes, sets)[src],
                             sets[src], radix, tile, shift, False, kind)
        for o, r in zip(sets[dst], res):
            o.copy_(r)
    elif mode == "copy":
        for o, i in zip(sets[1], sets[0]):
            o.copy_(i)
    return sets[1], None


def onesweep_pass(digit_src: torch.Tensor, planes, counts: torch.Tensor,
                  radix: int, tile: int, shift: int = 0, *,
                  scratch: torch.Tensor | None = None, outs=None,
                  with_dest: bool = False,
                  threads: int = DEFAULT_CONFIG.threads_per_cta,
                  kind: str = "u", plan: PassPlan | None = None):
    """One stable radix pass as a single launch: the planes (int32, or
    int64 moved at 8 bytes) move as ``rank_scatter`` moves them, each
    tile's offsets found by look-back.

    ``counts`` is the (R,) int32 digit total of this pass (a row of
    ``pass_histograms``).  ``scratch`` is a zeroed row of
    ``onesweep_scratch``, used once; None allocates and zeroes one.
    ``outs`` are tensors like ``planes`` to write into (None allocates).
    A narrow ``digit_src`` of ``kind`` is the key plane as in
    ``rank_scatter``.  Returns (planes_out, dest), dest as in
    ``rank_scatter``.

    With a ``plan`` (``PassPlan``; ``counts`` its table's row) the launch
    is one pass of a sort whose every pass the caller launches, with
    ``planes`` the sort's IN set and ``outs`` its OUT set: the kernel
    decides on the card whether the pass runs and which set it reads and
    writes, so the host reads nothing.  Returns (outs, None): OUT holds
    the sort's result once its last pass has been launched."""
    planes = _check_pass(digit_src, planes, radix, shift, kind,
                         "onesweep_pass")
    dev = digit_src.device
    n = digit_src.numel()
    if tuple(counts.shape) != (radix,) or counts.dtype != torch.int32:
        raise ValueError(f"counts must be ({radix},) int32, got "
                         f"{counts.dtype} {tuple(counts.shape)}")
    if outs is not None:
        outs = _check_like(outs, planes, "outs")
    if plan is not None:
        if outs is None or with_dest:
            raise ValueError("a planned pass writes into outs and gives no "
                             "dest")
        _check_plan(plan, digit_src, planes, counts, radix, kind)
    if not _on_cuda(digit_src):
        if plan is not None:
            return onesweep_pass_plain(digit_src, planes, radix, tile, shift,
                                       kind=kind, plan=plan, outs=outs)
        res, dest = onesweep_pass_plain(digit_src, planes, radix, tile,
                                        shift, with_dest, kind)
        if outs is None:
            return res, dest
        for o, r in zip(outs, res):
            o.copy_(r)
        return outs, dest
    if counts.device != dev:
        raise ValueError(f"counts is on {counts.device}, expected {dev}")
    if outs is None:
        outs = tuple(torch.empty_like(p) for p in planes)
    dest = torch.empty(n, dtype=torch.int32, device=dev) if with_dest else None
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
    tmp = None if plan is None else plan.tmp
    digits = _ptrs(_digit_sets(digit_src, planes,
                               _buffer_sets(planes, outs, tmp)))
    plan_args = _NO_PLAN if plan is None else (
        plan.table.data_ptr(), plan.table.shape[0], plan.passes0, plan.index,
        _ptrs(tuple(plan.keys) + (None,) * (2 - len(plan.keys))))
    groups = list(_launch_groups(planes, outs, tmp))
    B = -(-n // tile)
    # later plane groups run in base-table mode from the first's tile bases
    base_rb = (torch.empty((radix, B), dtype=torch.int32, device=dev)
               if len(groups) > 1 else None)
    stream = _stream(digit_src)
    key = _key_args(digit_src, kind)
    ins, outp, tmpp, k, nb = groups[0]
    _build.check(lib.rst_onesweep_pass(
        digits, n, tile, threads, shift, radix, *key, counts.data_ptr(),
        scratch.data_ptr(), scratch.nbytes, ins, outp, tmpp, k, nb,
        dest.data_ptr() if dest is not None else None,
        base_rb.data_ptr() if base_rb is not None else None, *plan_args,
        stream), "onesweep_pass")
    _count(onesweep_pass, 8 * digit_src.element_size())
    onesweep_pass.wide_launches += nb is not None
    for ins, outp, tmpp, k, nb in groups[1:]:
        _build.check(lib.rst_rank_scatter(
            digits, n, tile, threads, shift, radix, *key, base_rb.data_ptr(),
            ins, outp, tmpp, k, nb, None, *plan_args, stream),
            "rank_scatter")
        rank_scatter.launches += 1
        onesweep_pass.wide_launches += nb is not None
    return outs, dest


onesweep_pass.launches = 0
onesweep_pass.narrow_launches = {8: 0, 16: 0}
# planes of 8 bytes an element that sorts moved on a card, once a sort
# (sort_passes and sort_passes_plain count them alike)
onesweep_pass.wide_planes = 0
# launches of the pass kernel's wide instance (a launch group with an 8-byte
# plane), in look-back and base-table mode, as enqueued on a card
onesweep_pass.wide_launches = 0


# ------------------------------------------------------ a whole sort, K1-K4
#
# Every launch of a sort or a partition from one call into the library
# (``rst_sort_planes``): the memset of one workspace (the pass table and
# every pass's look-back scratch), the ``pass_histograms`` launch and each
# pass's ``onesweep_pass`` launch (and its base-table launches past
# rst_max_planes() planes), each pass deciding on the card from the table
# whether it runs.  Nothing of that depends on the data, so the host
# checks the planes once and makes one ctypes call, where the loop of
# ``sort_passes_plain`` checks them and builds its arrays at every launch.

def _sort_sets(key_planes, passes, planes, radix: int, kind: str, digit):
    """The sort's key planes and its IN set, checked once: (keys, ins,
    passes, moves)."""
    passes = tuple(int(p) for p in passes)
    if digit is None:
        keys = tuple(key_planes)
        ins = keys + tuple(planes)
    else:
        if tuple(key_planes):
            raise ValueError("a digit plane takes the key planes' place")
        keys, ins = (digit,), tuple(planes)
    _check_radix(radix)
    bits = radix.bit_length() - 1
    if not 1 <= len(keys) <= MAX_HIST_PLANES or len(passes) != len(keys):
        raise ValueError(f"a sort takes 1 to {MAX_HIST_PLANES} key planes "
                         f"and a pass count for each")
    key = keys[0]
    _check_key_plane(key, kind, "sort key plane")
    if digit is not None and key.dtype != torch.int32:
        raise ValueError("a digit plane that does not move is int32")
    moving = len(keys) if digit is None else 0  # ins[:moving]: key planes
    width = 8 * key.element_size()
    if width < 32 and len(keys) > 1:
        raise ValueError("a narrow key plane is the sort's only key plane")
    if (any(p < 1 or (p - 1) * bits >= width for p in passes)
            or sum(passes) > MAX_PLAN_PASSES):
        raise ValueError(f"pass counts {passes} do not fit {width}-bit "
                         f"planes of {bits}-bit digits")
    n, dev = key.numel(), key.device
    narrow = width < 32 and n > 0
    for i, p in enumerate(ins):
        if i or digit is not None:
            _check_plane(p, "sort plane", dev,
                         PLANE_DTYPES if i >= moving else (torch.int32,))
            if (narrow and p.dtype == torch.int32
                    and p.data_ptr() == key.data_ptr()):
                raise ValueError("an int32 plane aliases the narrow key "
                                 "plane")
        if p.numel() != n:
            raise ValueError("every plane must have the key plane's length")
    return keys, ins, passes, digit is None


def sort_passes_plain(key_planes, passes, planes, radix: int, tile: int,
                      threads: int = DEFAULT_CONFIG.threads_per_cta,
                      kind: str = "u", digit: torch.Tensor | None = None, *,
                      torch_only: bool = False):
    """The plain version of ``sort_passes``: one ``pass_histograms``, then
    one ``onesweep_pass`` a pass with its ``PassPlan``, each through this
    module's attribute, so it is the plain torch version on a CPU tensor
    and the per-pass launches on a card.  ``torch_only`` calls
    ``pass_histograms_plain`` and ``onesweep_pass_plain`` themselves: plain
    torch on the card too."""
    keys, ins, passes, _ = _sort_sets(key_planes, passes, planes, radix,
                                      kind, digit)
    if _on_cuda(keys[0]) and keys[0].numel() and not torch_only:
        onesweep_pass.wide_planes += _wide(ins)
    return _per_pass(keys, ins, passes, radix, tile, threads, kind,
                     torch_only)


def _per_pass(keys, ins, passes, radix, tile, threads, kind, torch_only):
    key = keys[0]
    if key.numel() == 0:
        return _empty_sort(ins, passes, radix, key.device)
    hist = pass_histograms_plain if torch_only else pass_histograms
    table = hist(keys, passes, radix, kind)
    P = sum(passes)
    bits = radix.bit_length() - 1
    scratch = (onesweep_scratch(key.numel(), radix, tile, P, key.device)
               if _on_cuda(key) and not torch_only else [None] * P)
    outs = tuple(torch.empty_like(p) for p in ins)
    tmp = tuple(torch.empty_like(p) for p in ins) if P > 1 else None
    for p in range(P):
        w = int(p >= passes[0])
        shift = (p - w * passes[0]) * bits
        plan = PassPlan(table, p, keys, passes[0], tmp)
        if torch_only:
            onesweep_pass_plain(keys[w], ins, radix, tile, shift, kind=kind,
                                plan=plan, outs=outs)
        else:
            onesweep_pass(keys[w], ins, table[p], radix, tile, shift,
                          scratch=scratch[p], outs=outs, threads=threads,
                          kind=kind, plan=plan)
    return outs, table


def _empty_sort(ins, passes, radix: int, device):
    return (tuple(torch.empty_like(p) for p in ins),
            torch.zeros((sum(passes), radix), dtype=torch.int32,
                        device=device))


def sort_passes(key_planes, passes, planes, radix: int, tile: int,
                threads: int = DEFAULT_CONFIG.threads_per_cta,
                kind: str = "u", digit: torch.Tensor | None = None):
    """A stable LSD sort of planes by the digits of its key planes: key
    plane w (one, or a 64-bit key's lo and hi words) carries passes[w]
    digits, pass j's at shift j * log2(radix), and moves with ``planes``
    (int32, or int64: an 8-byte column moved at its own width).  A narrow
    key plane of ``kind`` gives its image's digits.
    ``digit`` (int32 ids) in place of key planes is a partition's: its one
    pass count of digits orders ``planes`` and it does not move.

    Returns (OUT, table): the key planes and ``planes`` sorted, in storage
    of their own, and the (P, R) int32 pass table (``pass_histograms``; on
    a card a view into the call's workspace).

    On a card: one call of ``rst_sort_planes``, which enqueues every launch
    of the sort with no host read, and the allocations (OUT, TMP where P >
    1, one workspace); the launch counters advance as the per-pass
    launches advance them, and ``onesweep_pass.wide_planes`` by the 8-byte
    planes.  On the CPU: ``sort_passes_plain``.  One span
    ``radix.sort_passes`` (attributes ``planes``, and ``wide``: the 8-byte
    planes)."""
    planes = tuple(planes)
    wide = _wide(planes)
    with profiling.span("radix.sort_passes", planes=len(planes), wide=wide):
        return _sort_passes(key_planes, passes, planes, radix, tile, threads,
                            kind, digit, wide)


def _sort_passes(key_planes, passes, planes, radix, tile, threads, kind,
                 digit, wide):
    keys, ins, passes, moves = _sort_sets(key_planes, passes, planes, radix,
                                          kind, digit)
    key = keys[0]
    if not _on_cuda(key):
        return _per_pass(keys, ins, passes, radix, tile, threads, kind,
                         False)
    n, dev = key.numel(), key.device
    if n == 0:
        return _empty_sort(ins, passes, radix, dev)
    onesweep_pass.wide_planes += wide
    P = sum(passes)
    lib = _build.lib()
    nbytes = lib.rst_sort_workspace_bytes(n, tile, radix, P, len(ins))
    # int32 words (nbytes is a multiple of 16): the table is a view of it
    ws = torch.empty(nbytes // 4, dtype=torch.int32, device=dev)
    outs = tuple(torch.empty_like(p) for p in ins)
    tmp = tuple(torch.empty_like(p) for p in ins) if P > 1 else None
    launches = (ctypes.c_int * 3)()
    _build.check(lib.rst_sort_planes(
        n, radix, tile, threads, *_key_args(key, kind),
        _ptrs(keys + (None,) * (2 - len(keys))), passes[0],
        passes[1] if len(passes) > 1 else 0, _ptrs(ins), _ptrs(outs),
        None if tmp is None else _ptrs(tmp), len(ins),
        _plane_bytes(ins) if wide else None, int(moves), ws.data_ptr(),
        nbytes, _stream(key), launches), "sort_passes")
    width = 8 * key.element_size()
    hist, looked, based = launches
    _count(pass_histograms, width, hist)
    _count(onesweep_pass, width, looked)
    rank_scatter.launches += based
    # every launch group once a pass: the look-back one, then base-table
    onesweep_pass.wide_launches += looked * _wide_groups(ins)
    return outs, ws[:P * radix].view(P, radix)


_COUNTED = (digit_histogram, exclusive_scan, rank_scatter, pass_histograms,
            onesweep_pass)


def _count(fn, key_bits: int, launches: int = 1) -> None:
    fn.launches += launches
    if key_bits < 32:
        fn.narrow_launches[key_bits] += launches


def launch_counts() -> dict:
    """Launch counters of the radix kernels, by wrapper name
    (``rank_scatter`` counts base-table launches, ``onesweep_pass``
    look-back launches), ``wide_planes``: the 8-byte planes the sorts
    moved, once a sort, and ``wide_launches``: the launches of the pass
    kernel's wide instance (counted in ``onesweep_pass`` and
    ``rank_scatter`` too)."""
    return {**{f.__name__: f.launches for f in _COUNTED},
            "wide_planes": onesweep_pass.wide_planes,
            "wide_launches": onesweep_pass.wide_launches}


def narrow_launch_counts() -> dict:
    """The launches of ``pass_histograms`` and ``onesweep_pass`` with an 8-
    or 16-bit key plane (``pass_histograms_8bit`` and so on), which
    ``launch_counts`` counts in their totals too."""
    return {f"{f.__name__}_{bits}bit": c
            for f in (pass_histograms, onesweep_pass)
            for bits, c in f.narrow_launches.items()}


def reset_launch_counts() -> None:
    for f in _COUNTED:
        f.launches = 0
    for f in (pass_histograms, onesweep_pass):
        for bits in f.narrow_launches:
            f.narrow_launches[bits] = 0
    onesweep_pass.wide_planes = 0
    onesweep_pass.wide_launches = 0
