"""The slice end to end at 2^14 rows: chip_smoke.py's pipeline through the
port (on this CPU, its kernels' plain versions) and through the JAX
package, on the same numpy data, plus chip_smoke.py's own checks."""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import radix_sort_tpu as rst
import radix_sort_tpu_torch as rtt
from radix_sort_tpu.ops import aggregate as jagg, filter as jfilt
from radix_sort_tpu.ops import join as jjoin
from radix_sort_tpu.table import Table as JTable
from radix_sort_tpu_torch import convert, dtypes as tdt
from radix_sort_tpu_torch.ops import aggregate, cuda_radix, filter as filt
from radix_sort_tpu_torch.ops import join

N = 1 << 14
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cases():
    cases = [(ds, True) for ds in rtt.datasets.make_datasets(np.uint32, 0)]
    return cases + [(rtt.datasets.RandomDistributed(np.uint64, seed=0), True),
                    (rtt.datasets.RandomDistributed(np.uint32, seed=0), False)]


@pytest.mark.parametrize("case", range(7))
def test_sort_phase_matches_jax(case):
    ds, kv = _cases()[case]
    host = ds.generate(N)
    keys = tdt.tensor_from_numpy(host)
    if kv:
        iota = np.arange(N, dtype=np.int32)
        ko, perm = rtt.sort_kv(keys, torch.from_numpy(iota))
        jk, jperm = jax.jit(rst.sort_kv)(jnp.asarray(host), jnp.asarray(iota))
        np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    else:
        ko, perm = rtt.sort(keys), None
        jk = jax.jit(rst.sort)(jnp.asarray(host))
    np.testing.assert_array_equal(tdt.tensor_to_numpy(ko), np.asarray(jk))
    # the smoke test's own validation accepts the result (its 2^20 prefix
    # covers the whole array here) ...
    chip_smoke.check_sorted_kv(rtt, keys, ko, perm, host, ds.name)
    # ... and rejects a result that is not stable
    if kv and ds.name == "Zeros":
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.check_sorted_kv(rtt, keys, ko, perm.flip(0), host,
                                       ds.name)


def test_config3_filter_aggregate_matches_jax():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1000, N).astype(np.uint32)
    vals = rng.integers(0, 100, N).astype(np.int32)
    cols = {"k": keys, "x": vals}
    aggs = {"n": ("count", None), "s": ("sum", "x")}

    def jquery(t):
        return jagg.hash_aggregate(jfilt.filter_expr(t, "k", "lt", 500), "k",
                                   aggs)

    want = jax.jit(jquery)(JTable.from_numpy(cols)).to_numpy()
    t = convert.table_from_numpy(cols)
    got = aggregate.hash_aggregate(filt.filter_expr(t, "k", "lt", 500), "k",
                                   aggs).to_numpy()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    mask = keys < 500
    np.testing.assert_array_equal(got["k"], np.arange(500, dtype=np.uint32))
    np.testing.assert_array_equal(got["n"],
                                  np.bincount(keys[mask], minlength=500))


def test_config4_join_matches_jax():
    n_probe, n_build = N, N >> 2
    rng = np.random.default_rng(4)
    pk = rng.integers(0, n_probe >> 1, n_probe).astype(np.uint32)
    bk = rng.permutation(n_probe >> 1)[:n_build].astype(np.uint32)
    probe = {"k": pk, "pv": np.arange(n_probe, dtype=np.int32)}
    build = {"k": bk, "bv": (bk * 3).astype(np.int32)}
    jres, jstats = jax.jit(lambda p, b: jjoin.hash_join(p, b, "k"))(
        JTable.from_numpy(probe), JTable.from_numpy(build))
    res, stats = join.hash_join(convert.table_from_numpy(probe),
                                convert.table_from_numpy(build), "k")
    cnt = int(stats["match_count"])
    assert cnt == int(jstats["match_count"]) == int(np.isin(pk, bk).sum())
    assert not bool(stats["overflow"])
    got, want = res.to_numpy(), jres.to_numpy()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["bv"], (got["k"] * 3).astype(np.int32))


def test_cpu_slice_launches_no_kernel():
    cuda_radix.reset_launch_counts()
    k = torch.from_numpy(np.arange(N, dtype=np.int32)[::-1].copy())
    rtt.sort_kv(k, k)
    assert set(cuda_radix.launch_counts().values()) == {0}


def test_xor_reduce():
    x = torch.tensor([3, 5, 6, 1, 8], dtype=torch.int32)
    assert chip_smoke.xor_reduce(x) == 3 ^ 5 ^ 6 ^ 1 ^ 8


def test_smoke_alone_fails_without_printing_a_result(tmp_path):
    """chip_smoke.py in a directory that holds nothing else of the repo must
    exit non-zero, and must never print its result line there."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ""})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
