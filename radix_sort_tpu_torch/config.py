"""Algorithm configuration, shaped for Hopper.

Port of ``radix_sort_tpu/config.py``.  ``bits_per_pass`` and ``radix`` keep
their meaning.  The TPU's ``block_elems`` (a multiple of the 8x128 vector
tile) becomes ``tile_elems``, the elements one CTA of ``threads_per_cta``
threads ranks and scatters; the histogram and the rank-scatter kernels
must use the same tile, and both take it from here.
"""

from __future__ import annotations

import dataclasses

from . import dtypes

# (tile_elems, threads_per_cta) pairs that csrc/radix.cu instantiates.  The
# default, 8192 x 256, took 1.32 device-ms for a u32 KV pass at 2^27 where
# 4096 x 256 took 1.48 (scripts/onesweep_probe.py on an H100 80GB HBM3 at
# 700 W; PERF.md).
KERNEL_SHAPES = ((4096, 256), (2048, 256), (4096, 128), (2048, 128),
                 (8192, 256))


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """Tuning parameters for the multi-pass LSD radix sort.

    - ``bits_per_pass``   — digit width; radix = 2**bits_per_pass <= 256
      (the kernels keep one shared-memory counter row per digit).
    - ``tile_elems``      — elements per CTA in every radix kernel.
    - ``threads_per_cta`` — threads per CTA.
    - ``max_input_elems`` — the harness's size guard (the reference's
      ``_NUM_MAX_INPUT_ELEMS``), as in the JAX package.
    - ``engine``          — "auto" (= "radix"), "radix", "merge",
      "torch_sort" or "chunked", or a JAX engine name mapped onto them;
      see ops/sort.py.
    """

    bits_per_pass: int = 8
    tile_elems: int = 8192
    threads_per_cta: int = 256
    max_input_elems: int = 1 << 27
    engine: str = "auto"

    def __post_init__(self):
        if self.bits_per_pass not in (1, 2, 4, 8):
            raise ValueError(
                f"bits_per_pass must divide the key width and be one of "
                f"(1,2,4,8); got {self.bits_per_pass}")
        if (self.tile_elems, self.threads_per_cta) not in KERNEL_SHAPES:
            raise ValueError(
                f"(tile_elems, threads_per_cta) = "
                f"{(self.tile_elems, self.threads_per_cta)} is not one of "
                f"the compiled kernel shapes {KERNEL_SHAPES}")
        if self.max_input_elems <= 0:
            raise ValueError("max_input_elems must be positive")

    @property
    def radix(self) -> int:
        """Number of buckets per pass."""
        return 1 << self.bits_per_pass

    def num_passes(self, dtype) -> int:
        """Passes needed for keys of ``dtype``."""
        total_bits = dtypes.key_bits(dtype)
        if total_bits % self.bits_per_pass != 0:
            raise ValueError(
                f"key width {total_bits} not divisible by bits_per_pass "
                f"{self.bits_per_pass}")
        return total_bits // self.bits_per_pass


DEFAULT_CONFIG = SortConfig()
