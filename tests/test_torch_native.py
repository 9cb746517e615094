"""The port's host runtime library (rabitq_tpu_torch.native) against the
JAX package's (rabitq_tpu.native), and its build.

The JAX library is compiled here from its own source into a private
temporary directory and loaded through the JAX bindings, so these tests
never write the JAX package's in-place build. Both caches get the same
calls (misses, hits, LRU evictions, updates, short blocks) and must answer
alike; both parsers get the same buffers and must return equal matrices or
raise the same errors. Two processes that build the port's library at
once must both load a whole library (the build writes a temporary file
and renames it).
"""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import rabitq_tpu.native as jnative
import rabitq_tpu_torch.native as tnative

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_lib_path(tmp_path_factory):
    """A private build of the JAX package's library source."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the JAX library with")
    lib = tmp_path_factory.mktemp("jax_native") / "librabitq_native.so"
    subprocess.run(
        [cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-o", str(lib),
         str(Path(jnative.__file__).parent / "block_cache.cpp")],
        check=True, capture_output=True, timeout=120,
    )
    return lib


@pytest.fixture
def jax_native(jax_lib_path, monkeypatch):
    """The JAX bindings over the private build."""
    monkeypatch.setattr(jnative, "_LIB_PATH", jax_lib_path)
    monkeypatch.setattr(jnative, "_lib", None)
    return jnative


def test_block_cache_matches_jax(jax_native):
    rng = np.random.default_rng(0)
    caches = [mod.NativeBlockCache(max_blocks=3, floats_per_block=12,
                                   row_dim=4) for mod in (jax_native, tnative)]
    blocks = {i: rng.standard_normal((1 + i % 3, 4)).astype(np.float32)
              for i in range(8)}
    ops = [("get", 0), ("put", 0), ("put", 1), ("get", 0), ("put", 2),
           ("put", 3),  # evicts 1, the least recent
           ("get", 1), ("get", 0), ("get", 2), ("put", 4),  # evicts 3
           ("get", 3), ("put", 0), ("len", None),  # update, no eviction
           ("get", 0), ("put", 5), ("put", 6), ("get", 4), ("len", None)]
    for step, (op, i) in enumerate(ops):
        if op == "put":
            block = blocks[i] * (1 + step)
            for c in caches:
                c.put(i, block)
            continue
        got = [len(c) if op == "len" else c.get(i) for c in caches]
        if op == "len" or got[0] is None:
            assert got[1] == got[0], (step, op, i)
        else:
            assert got[1] is not None, (step, op, i)
            np.testing.assert_array_equal(got[1], got[0])
    with pytest.raises(ValueError):
        caches[1].put(9, np.zeros((2, 3), np.float32))


def _fvecs_bytes(mat):
    out = np.empty((mat.shape[0], mat.shape[1] + 1), np.uint32)
    out[:, 0] = mat.shape[1]
    out[:, 1:] = mat.view(np.uint32)
    return out.tobytes()


RAGGED = ((2).to_bytes(4, "little") + b"\x00" * 8
          + (3).to_bytes(4, "little") + b"\x00" * 12)


PARSE_CASES = {
    "matrix": _fvecs_bytes(
        np.random.default_rng(1).standard_normal((13, 7)).astype(np.float32)),
    "one_row": _fvecs_bytes(np.arange(5, dtype=np.float32)[None, :]),
    "empty": b"",
    "short": b"\x01\x00",
    "ragged": RAGGED,
    "zero_dim": (0).to_bytes(4, "little") * 3,
    "truncated": _fvecs_bytes(np.ones((3, 4), np.float32))[:-4],
}


@pytest.mark.parametrize("name", list(PARSE_CASES))
def test_parse_vecs_matrix_matches_jax(jax_native, name):
    raw = PARSE_CASES[name]
    outs = []
    for mod in (jax_native, tnative):
        try:
            outs.append(mod.parse_vecs_matrix(raw))
        except Exception as e:
            outs.append(e)
    want, got = outs
    if isinstance(want, Exception):
        assert type(got) is type(want), (name, got)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


_BUILD_SCRIPT = textwrap.dedent("""
    import sys, time
    from pathlib import Path
    import numpy as np
    import rabitq_tpu_torch.native as n

    n.BUILD_DIR = Path(sys.argv[1])
    ready = n.BUILD_DIR.parent / f"ready-{sys.argv[2]}"
    ready.touch()
    deadline = time.time() + 60
    while len(list(n.BUILD_DIR.parent.glob("ready-*"))) < 2:
        assert time.time() < deadline, "the other build never started"
        time.sleep(0.005)
    cache = n.NativeBlockCache(2, 8, 4)
    block = np.arange(8, dtype=np.float32).reshape(2, 4)
    cache.put(5, block)
    assert (cache.get(5) == block).all() and len(cache) == 1
    assert n.parse_vecs_matrix(
        np.array([1, 7], np.uint32).tobytes()).tolist() == [[7]]
    print("loaded", n.library_path().name)
""")


def test_concurrent_builds_both_load_a_whole_library(tmp_path):
    """Two processes build the library into one empty directory at the
    same moment; both load it and use it; only the final library stays."""
    build = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _BUILD_SCRIPT, str(build), str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=tmp_path)
        for i in range(2)
    ]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.startswith("loaded librabitq_native-")
    assert [f.name for f in build.iterdir()] == [out.split()[1]]


def test_library_path_tracks_the_source(monkeypatch, tmp_path):
    """The library's name carries a hash of the source and the flags."""
    a = tnative.library_path()
    src = tmp_path / "block_cache.cpp"
    src.write_text(tnative.SOURCE.read_text() + "\n// edited\n")
    monkeypatch.setattr(tnative, "SOURCE", src)
    assert tnative.library_path() != a
    assert a.parent == REPO / "build"
