"""Sort visualization on the PyTorch/CUDA port — the same program as
examples/visualize.py (the reference's `visualize` example,
examples/visualize/visualize.cpp: sort + point-cloud render, unsorted on
top / sorted below, heat-map colours, sort-time overlay, and a
click-to-regenerate live loop at visualize.cpp:801-854):

- default: headless PNG render (Agg backend; where matplotlib is not
  installed, the same two panels drawn with numpy, titles on stdout);
- ``--interactive``: a live matplotlib window — **click** (or press ``r``)
  to regenerate fresh keys and re-sort on the device, press ``d`` to
  cycle the dataset distribution, ``q`` to quit.

The keys are sorted on ``--device`` (the card by default); the time shown
is the upload, the sort and the download.

Run: python examples/torch_visualize.py [out.png] [--interactive]
                                        [--device cuda|cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np

N = 4096  # the reference visualizes 4096 u32 keys


def _setup(device):
    from radix_sort_tpu_torch import dtypes, sort

    def fn(keys):
        return dtypes.tensor_to_numpy(sort(dtypes.tensor_from_numpy(keys,
                                                                    device)))

    fn(np.zeros(N, np.uint32))  # builds the kernels once, on a card
    return fn


def _make_keys(dist_idx: int, seed: int):
    from radix_sort_tpu_torch import datasets

    dists = datasets.make_datasets(np.uint32, seed=seed)
    d = dists[dist_idx % len(dists)]
    return d.name, d.generate(N)


def _sort_timed(fn, keys):
    t0 = time.perf_counter()
    out = fn(keys)
    return out, (time.perf_counter() - t0) * 1e3


def _draw(fig, axes, name, keys, sorted_keys, ms):
    x = np.arange(N)
    for ax, ys, title in ((axes[0], keys, f"unsorted — {name}"),
                          (axes[1], sorted_keys, f"sorted ({ms:.2f} ms)")):
        ax.clear()
        ax.scatter(x, ys, c=ys, cmap="inferno", s=2)
        ax.set_title(title)
        ax.set_ylim(0, 2**32)
    fig.suptitle(f"radix_sort_tpu_torch — {N} u32 keys"
                 "  [click/r: regenerate, d: distribution, q: quit]")


# anchor colours of matplotlib's "inferno" map, low to high
_INFERNO = np.array([[0, 0, 4], [87, 16, 110], [188, 55, 84],
                     [249, 142, 9], [252, 255, 164]], np.float64)


def _png_bytes(img: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 image as PNG bytes (8-bit RGB, no filter)."""
    import struct
    import zlib

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                          axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def _render_numpy(out_path, keys, sorted_keys):
    """The same two panels (unsorted above, sorted below, points coloured
    by value on the inferno ramp) drawn with numpy, for a machine without
    matplotlib; the titles go to stdout instead."""
    width, height, margin = 1100, 660, 30
    img = np.full((height, width, 3), 255, np.uint8)
    ph = (height - 3 * margin) // 2
    x = margin + np.arange(N) * (width - 2 * margin - 2) // (N - 1)
    for panel, ys in enumerate((keys, sorted_keys)):
        v = ys.astype(np.float64) / 2**32
        y = margin + panel * (ph + margin) + ((1 - v) * (ph - 2)).astype(int)
        t = v * (len(_INFERNO) - 1)
        i = np.minimum(t.astype(int), len(_INFERNO) - 2)
        rgb = (_INFERNO[i] + (t - i)[:, None] * (_INFERNO[i + 1]
                                                  - _INFERNO[i]))
        for dy in (0, 1):
            for dx in (0, 1):
                img[y + dy, x + dx] = rgb.astype(np.uint8)
    with open(out_path, "wb") as f:
        f.write(_png_bytes(img))


def main_headless(out_path: str = "visualize.png", device="cuda"):
    fn = _setup(device)
    name, keys = _make_keys(1, seed=int(time.time()) % 2**31)
    sorted_keys, ms = _sort_timed(fn, keys)
    try:
        import matplotlib
    except ImportError:
        _render_numpy(out_path, keys, sorted_keys)
        print(f"unsorted — {name} | sorted ({ms:.2f} ms) | matplotlib is "
              f"not installed: panels drawn with numpy")
        print(f"wrote {out_path} (sort time {ms:.2f} ms)")
        return

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 1, figsize=(10, 6), sharex=True)
    _draw(fig, axes, name, keys, sorted_keys, ms)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    print(f"wrote {out_path} (sort time {ms:.2f} ms)")


def main_interactive(device="cuda"):
    import matplotlib
    import matplotlib.pyplot as plt

    if matplotlib.get_backend().lower() == "agg":
        print("no GUI backend available — falling back to headless PNG "
              "(set MPLBACKEND to a GUI backend for the live loop)")
        return main_headless(device=device)

    fn = _setup(device)
    state = {"dist": 1, "seed": int(time.time()) % 2**31}
    fig, axes = plt.subplots(2, 1, figsize=(10, 6), sharex=True)

    def regen():
        state["seed"] += 1
        name, keys = _make_keys(state["dist"], state["seed"])
        sorted_keys, ms = _sort_timed(fn, keys)
        _draw(fig, axes, name, keys, sorted_keys, ms)
        fig.canvas.draw_idle()

    def on_click(event):
        if event.inaxes is not None:
            regen()

    def on_key(event):
        if event.key == "r":
            regen()
        elif event.key == "d":
            state["dist"] += 1
            regen()
        elif event.key == "q":
            plt.close(fig)

    fig.canvas.mpl_connect("button_press_event", on_click)
    fig.canvas.mpl_connect("key_press_event", on_key)
    regen()
    plt.show()


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out", nargs="?", default="visualize.png")
    p.add_argument("--interactive", action="store_true")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    if a.interactive:
        main_interactive(a.device)
    else:
        main_headless(a.out, a.device)
