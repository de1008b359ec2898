"""The port's forcing file and native reader (``landhydrology_tpu_torch/runtime/forcing.py``)
against the JAX package's (``landhydrology_tpu/runtime/forcing.py``).

- a file either package writes reads identically through both readers,
  and the two writers produce the same bytes;
- ``stream_windows`` yields the same windows (a tail window included) and
  its prefetch serves reads;
- ``read_into`` fills a caller's host tensor; the reader refuses bad
  buffers, ranges and files with errors that name the cause;
- the reader library is built once behind its lock, and a failed build
  raises with the compiler's output.
"""

from tests import torch_cpu  # noqa: F401  (one intra-op thread: see tests/torch_cpu.py)
import threading

import numpy as np
import pytest
import torch

from landhydrology_tpu.runtime import forcing as jrf
from landhydrology_tpu_torch.runtime import forcing as rf


def _fields(n_times, n_cols, dtype, seed):
    rng = np.random.default_rng(seed)
    return {
        "u_atm": rng.random((n_times, n_cols)).astype(dtype),
        "theta_atm": (280 + 10 * rng.random((n_times, n_cols))).astype(dtype),
        "precipitation": (rng.random((n_times, n_cols)) * 1e-6).astype(dtype),
    }


def _windows(reader, window):
    return [(i0, {k: v.copy() for k, v in w.items()}) for i0, w in
            (rf.stream_windows if isinstance(reader, rf.ForcingReader) else jrf.stream_windows)(reader, window)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_files_cross_read_and_match_bytes(tmp_path, dtype):
    times = np.arange(48, dtype=np.float64) * 60.0
    fields = _fields(48, 6, dtype, seed=1)
    jpath, ppath = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
    jrf.write_forcing(jpath, times, fields)
    rf.write_forcing(ppath, times, fields)
    assert open(jpath, "rb").read() == open(ppath, "rb").read()
    for path in (jpath, ppath):
        with rf.ForcingReader(path) as port, jrf.ForcingReader(path) as ref:
            assert port.is_native
            assert (port.n_times, port.n_cols, port.dtype) == (ref.n_times, ref.n_cols, ref.dtype) == (48, 6, dtype)
            assert port.field_names == ref.field_names == sorted(fields)
            np.testing.assert_array_equal(port.times, ref.times)
            for i0, nt in ((0, 48), (10, 8), (47, 1)):
                got, want = port.window(i0, nt), ref.window(i0, nt)
                for k in fields:
                    np.testing.assert_array_equal(got[k], want[k])
                    np.testing.assert_array_equal(got[k], fields[k][i0:i0 + nt])


def test_stream_windows_match_jax_with_a_tail(tmp_path):
    path = str(tmp_path / "f.bin")
    fields = _fields(40, 5, np.float32, seed=2)
    rf.write_forcing(path, np.arange(40.0), fields)
    with rf.ForcingReader(path) as port, jrf.ForcingReader(path) as ref:
        got, want = _windows(port, 16), _windows(ref, 16)
        assert [i0 for i0, _ in got] == [i0 for i0, _ in want] == [0, 16, 32]
        assert got[-1][1]["u_atm"].shape == (8, 5)  # the tail window
        for (_, g), (_, w) in zip(got, want):
            for k in fields:
                np.testing.assert_array_equal(g[k], w[k])
        assert port.prefetch_hits == 3  # every window came from the prefetch
        assert list(rf.stream_windows(port, 16, start=40)) == []


def test_read_into_a_host_tensor_and_prefetch_hits(tmp_path):
    path = str(tmp_path / "f.bin")
    fields = _fields(24, 4, np.float32, seed=3)
    rf.write_forcing(path, np.arange(24.0), fields)
    with rf.ForcingReader(path) as r:
        assert r.prefetch_hits == 0
        buf = torch.empty((8, 3, 4), dtype=torch.float32)
        r.prefetch(4, 8)
        r.read_into(4, 8, buf)
        assert r.prefetch_hits == 1
        for i, k in enumerate(r.field_names):
            np.testing.assert_array_equal(buf[:, i].numpy(), fields[k][4:12])
        r.read_into(0, 8, buf)  # not the staged window: read from the map
        assert r.prefetch_hits == 1
        np.testing.assert_array_equal(buf[:, 0].numpy(), fields[r.field_names[0]][:8])
        for bad in (torch.empty((8, 3, 4), dtype=torch.float64), torch.empty((8, 3, 5)),
                    torch.empty((8, 3, 8))[:, :, ::2], np.empty((8, 3, 4), dtype=np.float64)):
            with pytest.raises(ValueError, match="contiguous host buffer"):
                r.read_into(0, 8, bad)
        with pytest.raises(IndexError):
            r.window(20, 8)
        with pytest.raises(IndexError):
            r.prefetch(-1, 2)
    with pytest.raises(ValueError, match="closed"):
        r.prefetch_hits  # noqa: B018


def test_open_errors_name_the_cause(tmp_path):
    with pytest.raises(FileNotFoundError, match="no such forcing file"):
        rf.ForcingReader(str(tmp_path / "missing.bin"))
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"not a forcing file at all, just bytes" * 4)
    with pytest.raises(ValueError, match="bad magic"):
        rf.ForcingReader(str(bad))
    good = tmp_path / "good.bin"
    rf.write_forcing(str(good), np.arange(10.0), _fields(10, 3, np.float64, seed=4))
    cut = tmp_path / "cut.bin"
    cut.write_bytes(good.read_bytes()[:-8])
    with pytest.raises(ValueError, match="truncated"):
        rf.ForcingReader(str(cut))


def test_writer_validation():
    with pytest.raises(ValueError, match="at least one"):
        rf.write_forcing("unused.bin", np.arange(3.0), {})
    with pytest.raises(TypeError, match="unsupported"):
        rf.write_forcing("unused.bin", np.arange(3.0), {"u_atm": np.zeros((3, 2), dtype=np.int32)})
    with pytest.raises(TypeError, match="dtype"):
        rf.write_forcing("unused.bin", np.arange(3.0), {"a": np.zeros((3, 2), np.float32), "b": np.zeros((3, 2))})
    with pytest.raises(ValueError, match="shape"):
        rf.write_forcing("unused.bin", np.arange(3.0), {"a": np.zeros((3, 2)), "b": np.zeros((3, 3))})


def test_library_builds_once_behind_its_lock(tmp_path, monkeypatch):
    """Eight threads asking for the library at once (each holding its own
    lock file handle, as concurrent test workers do) get one build."""
    monkeypatch.setattr(rf, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def build():
        try:
            paths.append(rf.build_library())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(set(paths)) == 1 and paths[0].parent == tmp_path and paths[0].exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["forcingreader.lock", paths[0].name]


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(rf, "SOURCE", src)
    monkeypatch.setattr(rf, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        rf.build_library()
    monkeypatch.setattr(rf, "SOURCE", tmp_path / "absent.cpp")
    with pytest.raises(FileNotFoundError, match="source is missing"):
        rf.build_library()
