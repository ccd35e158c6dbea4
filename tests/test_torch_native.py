"""The port's native polygon fill (objgan_tpu_torch/native/rasterize.cc)
against its numpy plain version (data/pipeline.py::_numpy_polygon_fill) and
the JAX package's native fill (objgan_tpu/native), bit for bit, on seeded
polygons at the feed's mask sizes, degenerate ones included; the batched
entry against the one-polygon one; and a build by two processes at once.

Two cases are pinned by name, where the three fills cannot all agree:
* a polygon of two points: both native fills return an empty mask (the C++
  fill needs three points), while the numpy fill marks the pixels between
  the two intercepts of its two coincident edges, which round apart;
* a vertex on a pixel centre at an exact tie: the port's fill is built with
  ``-ffp-contract=off`` and rounds as numpy does on every host, while the
  JAX package's library is built with ``-march=native``, so on a CPU with
  FMA it may fuse ``x1 + t * (x2 - x1)`` and put a tied intercept on the
  other side of a pixel centre.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from objgan_tpu.native import rasterize_polygon as jax_fill
from objgan_tpu_torch import native
from objgan_tpu_torch.data.pipeline import (_numpy_polygon_fill,
                                            polygon_to_box_mask)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (16, 24, 64)


def _polygons(seed=0, n=200):
    """(name, polygon) pairs: random polygons of 3-12 points spilling over
    the box, and degenerate ones (fewer than 3 points, zero area)."""
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(r.integers(3, 13))
        out.append((f"random{i}", r.random((k, 2)) * 1.4 - 0.2))
    out += [("empty", np.zeros((0, 2))), ("one_point", np.array([[0.4, 0.6]])),
            ("collinear", np.array([[0.1, 0.1], [0.5, 0.5], [0.9, 0.9]])),
            ("repeated_point", np.full((4, 2), 0.3)),
            ("horizontal", np.array([[0.1, 0.5], [0.9, 0.5], [0.5, 0.5]])),
            ("vertical", np.array([[0.5, 0.1], [0.5, 0.9], [0.5, 0.4]]))]
    return out


@pytest.mark.parametrize("size", SIZES)
def test_native_fill_matches_numpy_and_jax(size):
    for name, poly in _polygons():
        got = native.rasterize_polygon(poly, size)
        assert got.dtype == np.float32 and got.shape == (size, size)
        np.testing.assert_array_equal(got, _numpy_polygon_fill(poly, size),
                                      err_msg=name)
        if len(poly):  # the JAX package's entry does not take 0 points
            np.testing.assert_array_equal(got, jax_fill(poly, size),
                                          err_msg=name)


@pytest.mark.parametrize("size", SIZES)
def test_vertices_on_pixel_centres_match_numpy(size):
    """Vertices on pixel centres and edges (exact ties at the scanline
    test): the port's fill equals numpy's on every one; JAX's fill equals
    both wherever its build's fused multiply-add does not break a tie."""
    r = np.random.default_rng(1)
    agree = 0
    for i in range(200):
        k = int(r.integers(3, 9))
        poly = np.round((r.random((k, 2)) * 1.4 - 0.2) * 2 * size) / (2 * size)
        got = native.rasterize_polygon(poly, size)
        np.testing.assert_array_equal(got, _numpy_polygon_fill(poly, size),
                                      err_msg=f"centres{i}")
        diff = got != jax_fill(poly, size)
        for row, col in zip(*np.nonzero(diff)):
            assert _nearest_intercept(poly, row, col, size) < 1e-12, (
                f"centres{i}: pixel ({row}, {col}) is no tie")
        agree += not diff.any()
    assert agree >= 150


def _nearest_intercept(poly, row, col, size):
    """Distance from pixel (row, col)'s centre to the nearest intercept of
    an edge with its scanline."""
    y, x = (row + 0.5) / size, (col + 0.5) / size
    x1, y1 = poly[:, 0], poly[:, 1]
    x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
    cross = (y1 <= y) != (y2 <= y)
    t = (y - y1[cross]) / (y2[cross] - y1[cross])
    xi = x1[cross] + t * (x2[cross] - x1[cross])
    return float(np.abs(xi - x).min()) if xi.size else np.inf


def test_two_point_polygon_is_empty_as_in_jax_native():
    poly = np.array([[0.1, 0.2], [0.9, 0.7]])
    for size in SIZES:
        got = native.rasterize_polygon(poly, size)
        np.testing.assert_array_equal(got, jax_fill(poly, size))
        assert not got.any()
    # the numpy fill marks pixels between the rounded-apart intercepts of
    # its two coincident edges on at least one of these polygons
    r = np.random.default_rng(2)
    stray = sum(_numpy_polygon_fill(np.round(r.random((2, 2)) * 48) / 48,
                                    24).any() for _ in range(400))
    assert stray > 0


def test_batched_fill_equals_per_polygon_fill():
    polys = [p for _, p in _polygons(seed=3, n=30)]
    for size in (16, 64):
        batched = native.rasterize_polygons(polys, size)
        assert batched.shape == (len(polys), size, size)
        for i, p in enumerate(polys):
            np.testing.assert_array_equal(batched[i],
                                          native.rasterize_polygon(p, size))
    assert native.rasterize_polygons([], 8).shape == (0, 8, 8)


def test_polygon_to_box_mask_uses_the_native_fill():
    poly = np.array([[0.2, 0.2], [0.6, 0.25], [0.5, 0.7], [0.25, 0.6]])
    box = np.array([0.15, 0.1, 0.5, 0.7], np.float32)
    x0, y0, w, h = (float(v) for v in box)
    local = (poly - [x0, y0]) / [w, h]
    for size in SIZES:
        got = polygon_to_box_mask(poly, box, size)
        np.testing.assert_array_equal(got, native.rasterize_polygon(local,
                                                                    size))
        np.testing.assert_array_equal(got, _numpy_polygon_fill(local, size))


def test_library_is_named_by_source_and_flags():
    path = native.library_path()
    assert path.parent == native.BUILD
    assert path.name.startswith("libobjgan_native-")
    assert native.build() == path and path.exists()


def test_two_processes_build_at_once(tmp_path):
    """Two processes build into one empty directory together: each writes
    under its own temporary name and renames into place, and both fill."""
    code = (
        "import sys, pathlib, numpy as np\n"
        "from objgan_tpu_torch import native\n"
        "from objgan_tpu_torch.data.pipeline import _numpy_polygon_fill\n"
        "native.BUILD = pathlib.Path(sys.argv[1])\n"
        "poly = np.array([[0.1, 0.1], [0.9, 0.2], [0.4, 0.8]])\n"
        "assert np.array_equal(native.rasterize_polygon(poly, 24),\n"
        "                      _numpy_polygon_fill(poly, 24))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, env=env, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
    built = sorted(f.name for f in tmp_path.iterdir())
    assert built == [native.library_path().name], built


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "rasterize.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on rasterize.cc"):
        native.build()
    assert not any((tmp_path / "build").iterdir())
