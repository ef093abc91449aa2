"""The port's native host batch gather (``posterior_matching_torch/native``)
against numpy's, on the CPU.

- ``gather_rows`` equals ``src[indices]`` bit for bit over uint8, int64,
  float32 and float64 fields, rows of several widths (a scalar a row up to
  a CelebA image), batches with fewer rows than threads and with more
  (indices repeated); ``gather_u8_to_f32`` equals ``src[indices].astype(
  np.float32) * np.float32(scale)`` and ``gather_f32`` the float32 gather;
- arguments the entry points cannot take (an index out of range, another
  dtype, an object array, a strided array) are refused before any pointer
  is passed;
- a failed build raises with the compiler's output, and ``ArrayDataset``
  then raises too: nothing falls back to numpy by itself;
- four processes building the library into one empty directory at once
  all load a whole library and gather right, and leave one library and no
  temporary file.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from posterior_matching_torch import native
from posterior_matching_torch.data.datasets import ArrayDataset
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
ROW_SHAPES = [(), (7,), (64, 64, 3)]


def _src(dtype, row_shape, n=50, seed=0):
    rng = np.random.RandomState(seed)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return rng.randint(info.min, info.max, (n, *row_shape), dtype=dtype)
    return rng.randn(n, *row_shape).astype(dtype)


@pytest.mark.parametrize("row_shape", ROW_SHAPES, ids=lambda s: "x".join(map(str, s)) or "scalar")
@pytest.mark.parametrize("dtype", [np.uint8, np.int64, np.float32, np.float64],
                         ids=lambda d: np.dtype(d).name)
def test_gather_rows_is_numpys(dtype, row_shape):
    src = _src(dtype, row_shape)
    rng = np.random.RandomState(1)
    # fewer rows than threads, then more, with repeats, then none
    for idx in (np.array([49, 0, 7]), rng.randint(0, 50, 70), np.zeros(0, np.int64)):
        got = native.gather_rows(src, idx)
        assert got.dtype == src.dtype and got.shape == (len(idx), *row_shape)
        np.testing.assert_array_equal(got, src[idx])


@pytest.mark.parametrize("row_shape", [(28, 28, 1), (64, 64, 3)])
def test_gather_u8_to_f32_is_the_float32_product(row_shape):
    src = _src(np.uint8, row_shape)
    for idx in (np.array([3, 3]), np.random.RandomState(2).permutation(50)):
        for scale in (1.0 / 255.0, 0.5):
            got = native.gather_u8_to_f32(src, idx, scale)
            want = src[idx].astype(np.float32) * np.float32(scale)
            assert got.dtype == np.float32
            assert got.tobytes() == want.tobytes()


def test_gather_f32_is_numpys():
    src = _src(np.float32, (8,))
    idx = np.random.RandomState(3).randint(0, 50, 128)
    assert native.gather_f32(src, idx).tobytes() == src[idx].tobytes()


def test_arguments_are_checked_before_any_pointer():
    src = _src(np.float32, (4,))
    with pytest.raises(IndexError):
        native.gather_rows(src, [0, 50])
    with pytest.raises(IndexError):
        native.gather_rows(src, [-1])
    with pytest.raises(TypeError):
        native.gather_u8_to_f32(src, [0], 1.0)
    with pytest.raises(TypeError):
        native.gather_f32(src.astype(np.float64), [0])
    with pytest.raises(TypeError):
        native.gather_rows(np.array([object()] * 3), [0])
    with pytest.raises(ValueError):
        native.gather_rows(src[:, ::2], [0])


def test_a_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    bad = tmp_path / "pm_data.cc"
    bad.write_text("extern \"C\" void pm_gather_rows( { this is not C++ }\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ exit") as err:
        native.load()
    assert "error" in str(err.value)   # the compiler's own message
    assert not list((tmp_path / "_build").iterdir())   # no library, no temporary file
    ds = ArrayDataset({"x": np.arange(8.0).reshape(4, 2)}, 2)
    with pytest.raises(RuntimeError, match="building pm_data.cc failed"):
        next(iter(ds))


def test_processes_building_at_once_all_load(tmp_path):
    build_dir, go = tmp_path / "_build", tmp_path / "go"
    script = textwrap.dedent(f"""
        import os, sys, time
        from pathlib import Path
        import numpy as np
        from posterior_matching_torch import native
        native.BUILD_DIR = Path({str(build_dir)!r})
        while not os.path.exists({str(go)!r}):
            time.sleep(0.01)
        src = np.arange(600, dtype=np.uint8).reshape(100, 6)
        idx = np.arange(99, -1, -1)
        assert native.gather_rows(src, idx).tobytes() == src[idx].tobytes()
        print(native.library_path().name)
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", script], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    go.touch()
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        finally:
            p.kill()
        assert p.returncode == 0, err
        outs.append(out.strip())
    assert len(set(outs)) == 1
    assert [f.name for f in build_dir.iterdir()] == [outs[0]]
