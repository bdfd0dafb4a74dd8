"""The port's examples as subprocesses on the CPU (``--device cpu``), like
tests/test_examples.py for the JAX ones: each prints ``validation: OK``, or
writes its PNG."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, timeout=240):
    return subprocess.run([sys.executable] + args, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("n", ["20000", "33554432"])
def test_torch_basic_sort_example(n):
    """20000 keys, and the default 2^25 that the example cuts to 2^20."""
    r = _run(["examples/torch_basic_sort.py", "--num-elements", n,
              "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.splitlines()[0] == "cpu"
    assert "validation: OK" in r.stdout
    assert f"sorted {min(int(n), 1 << 20)} u32" in r.stdout


def test_torch_query_pipeline_example():
    r = _run(["examples/torch_query_pipeline.py", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "validation: OK" in r.stdout


def test_torch_visualize_example(tmp_path):
    pytest.importorskip("matplotlib")
    out = str(tmp_path / "viz.png")
    r = _run(["examples/torch_visualize.py", out, "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out) and os.path.getsize(out) > 10000


def test_torch_visualize_example_without_matplotlib(tmp_path):
    """Where matplotlib is not installed (the card's machine) the example
    draws its panels with numpy and still writes a PNG."""
    out = str(tmp_path / "viz.png")
    code = ("import runpy, sys\n"
            "sys.modules['matplotlib'] = None  # import matplotlib fails\n"
            f"sys.argv = ['torch_visualize.py', {out!r}, '--device', 'cpu']\n"
            "runpy.run_path('examples/torch_visualize.py', "
            "run_name='__main__')\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "drawn with numpy" in r.stdout
    with open(out, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 10000
    try:
        import matplotlib.image as mpimg
    except ImportError:
        return
    img = mpimg.imread(out)
    assert img.shape == (660, 1100, 3) and (img < 1).any()


def test_torch_examples_import_no_jax():
    """The port's examples run where JAX is absent."""
    for name in ("torch_basic_sort", "torch_query_pipeline",
                 "torch_visualize"):
        with open(os.path.join(REPO, "examples", name + ".py")) as f:
            src = f.read()
        assert "import jax" not in src and "radix_sort_tpu." not in src \
            and "from radix_sort_tpu import" not in src, name
