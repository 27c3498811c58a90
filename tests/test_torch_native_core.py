"""The port's native host core against euler_tpu's, and the port alone.

The port builds its own copy of the native core,
``euler_tpu_torch/csrc/euler_core.cc``, never the repository's
``csrc/``. These tests hold that: the source lies inside the package; a
copy of the package with nothing else of the repository beside it builds
the core and loads a graph and an edge list on the native path; the
port's CSR, alias-table and edge-list builders equal the reference's bit
for bit on seeded inputs; a missing source raises, a failed build falls
back; and a library's name changes with a quoted include beside its
source.

The native CSR build scatters 32,768 edges or more from several threads,
which leaves the order of duplicate (src, type, dst) edges open, so the
CSR cases past that size have no duplicate edges.
"""
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from euler_tpu.native import loader as jax_native
from euler_tpu_torch import _build
from euler_tpu_torch.datasets import random_graph
from euler_tpu_torch.graph import stream_convert
from euler_tpu_torch.native import loader as native
from tests.test_torch_convert import assert_dirs_equal

PACKAGE_DIR = _build.PACKAGE_DIR
_CMD = native._CMD


def assert_bits_equal(got, want, what=""):
    """Equal dtype, shape and bytes (NaNs and signed zeros included)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, what
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                  err_msg=what)


def assert_results_equal(got, want):
    assert got is not None and want is not None
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert_bits_equal(a, b, f"output {i}")


# ------------------------------------------------------------ the source --

def test_source_lies_in_the_package():
    assert os.path.isfile(native.SRC)
    assert os.path.commonpath([native.SRC, PACKAGE_DIR]) == PACKAGE_DIR
    assert native.SRC == os.path.join(PACKAGE_DIR, "csrc", "euler_core.cc")
    assert native.available()
    assert os.path.dirname(native.get_lib()._name) == _build.BUILD_DIR


def test_missing_source_raises(tmp_path, monkeypatch):
    missing = str(tmp_path / "csrc" / "euler_core.cc")
    monkeypatch.setattr(native, "SRC", missing)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    with pytest.raises(FileNotFoundError, match=missing):
        native.get_lib()
    with pytest.raises(FileNotFoundError, match=missing):
        native.available()


def test_failed_build_falls_back(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_CMD", ["g++", "-fno-such-flag"])
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.get_lib() is None
    assert not native.available()
    src = np.array([0, 1], np.int32)
    assert native.build_csr_native(2, 1, src, src[::-1].copy(), src * 0,
                                   np.ones(2, np.float32)) is None
    assert native.build_alias_native(np.ones(3, np.float32)) is None
    assert native.parse_edge_list_native(b"0 1\n") is None


# ------------------------------------------------- the package on its own --

_ALONE = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    root, el = sys.argv[1], sys.argv[2]
    import euler_tpu_torch
    from euler_tpu_torch.native import loader
    calls = {}

    def counted(name):
        fn = getattr(loader, name)

        def wrapped(*a, **k):
            res = fn(*a, **k)
            calls[name] = calls.get(name, 0) + (res is not None)
            calls[name + ":none"] = calls.get(name + ":none", 0) + (
                res is None)
            return res
        setattr(loader, name, wrapped)

    for name in ("build_csr_native", "build_alias_native",
                 "build_group_alias_native", "parse_edge_list_native"):
        counted(name)
    from euler_tpu_torch.datasets import random_graph
    from euler_tpu_torch.graph import stream_convert
    from euler_tpu_torch.graph.store import load_graph
    g = random_graph(2000, 25, seed=0, device="cpu")
    out = os.path.join(root, "el_graph")
    os.makedirs(out)
    meta = stream_convert.convert_edge_list(el, out, 2, chunk_size=7)
    lg = load_graph(out, device="cpu")
    np.savez(os.path.join(root, "graph.npz"),
             group_ptr=g.tensors.group_ptr.numpy(),
             adj_dst=g.tensors.adj_dst.numpy())
    print(json.dumps(dict(
        package=os.path.dirname(euler_tpu_torch.__file__),
        src=loader.SRC, available=loader.available(),
        lib=loader.get_lib()._name, calls=calls,
        modules=sorted(m for m in sys.modules
                       if m.split(".")[0] in ("euler_tpu", "tests", "jax")),
        n_edges=g.meta.n_edges, el_edges=meta.n_edges,
        el_loaded=lg.meta.n_edges)))
""")


def edge_list_text(rng, n_lines, n_nodes=50):
    """Edge-list text: tab, space and comma separators, weights written
    out or left off, comments, blank, malformed and negative-id lines,
    CRLF endings and no newline at the end."""
    lines = []
    for i in range(n_lines):
        a, b = rng.integers(0, n_nodes, 2)
        kind = i % 11
        if kind == 0:
            lines.append(f"# comment {a}")
        elif kind == 1:
            lines.append("")
        elif kind == 2:
            lines.append(f"{a}\tnot-an-id")
        elif kind == 3:
            lines.append(f"-{a + 1} {b} 1.5")
        elif kind == 4:
            lines.append(f"{a},{b},{rng.random():.7g}\r")
        elif kind == 5:
            lines.append(f"  {a} {b}")
        elif kind == 6:
            lines.append(f"{a}\t{b}\t{rng.random() * 10:.9g}")
        else:
            lines.append(f"{a} {b} {rng.integers(1, 5)}")
    return "\n".join(lines)


def test_package_alone_builds_and_loads_natively(tmp_path):
    root = tmp_path / "alone"
    shutil.copytree(PACKAGE_DIR, root / "euler_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    assert sorted(os.listdir(root)) == ["euler_tpu_torch"]
    el = tmp_path / "edges.txt"
    el.write_text(edge_list_text(np.random.default_rng(7), 500))
    env = dict(os.environ, PYTHONPATH=str(root))
    run = subprocess.run(
        [sys.executable, "-c", _ALONE, str(root), str(el)], cwd=root,
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    copy = str(root / "euler_tpu_torch")
    assert got["package"] == copy
    assert got["src"] == os.path.join(copy, "csrc", "euler_core.cc")
    assert got["available"] is True
    assert os.path.dirname(got["lib"]) == str(root / "build"
                                              / "euler_tpu_torch")
    assert got["modules"] == []
    calls = got["calls"]
    for name in ("build_csr_native", "build_group_alias_native",
                 "parse_edge_list_native"):
        assert calls.get(name, 0) > 0, (name, calls)
        assert calls.get(name + ":none", 0) == 0, (name, calls)
    assert got["n_edges"] == 2000 * 25
    # the copy's graph and conversion equal the repository's: the CSR
    # groups and their sorted destinations do not depend on tie order
    g = random_graph(2000, 25, seed=0, device="cpu")
    with np.load(root / "graph.npz") as arrays:
        assert_bits_equal(arrays["group_ptr"], g.tensors.group_ptr.numpy())
        assert_bits_equal(arrays["adj_dst"], g.tensors.adj_dst.numpy())
    want = tmp_path / "repo_el_graph"
    os.makedirs(want)
    meta = stream_convert.convert_edge_list(str(el), str(want), 2,
                                            chunk_size=7)
    assert got["el_edges"] == got["el_loaded"] == meta.n_edges > 0
    assert_dirs_equal(str(root / "el_graph"), str(want))


# ------------------------------------------ bit for bit with the reference --

def csr_inputs(case):
    rng = np.random.default_rng(["dups", "unique", "eid"].index(case))
    if case == "dups":       # one thread: duplicate edges in a fixed order
        n, n_et, m = 300, 2, 6000
        src = rng.integers(0, n, m)
        dst = rng.integers(0, n, m)
        etype = rng.integers(0, n_et, m)
    else:                    # several threads: no two edges alike
        n, n_et, m = 2000, 3, 40_000
        key = rng.choice(n * n_et * n, m, replace=False)
        src, rest = np.divmod(key, n_et * n)
        etype, dst = np.divmod(rest, n)
    w = rng.random(m).astype(np.float32) + 0.1
    w[rng.random(m) < 0.05] = 0.0
    eid = rng.permutation(m).astype(np.int32) if case == "eid" else None
    return (n, n_et, src.astype(np.int32), dst.astype(np.int32),
            etype.astype(np.int32), w, eid)


@pytest.mark.parametrize("case", ["dups", "unique", "eid"])
def test_csr_equals_reference(case):
    args = csr_inputs(case)
    got = native.build_csr_native(*args)
    assert_results_equal(got, jax_native.build_csr_native(*args))
    assert got[0][-1] == len(args[2])


def alias_weights(case):
    rng = np.random.default_rng(len(case))
    if case == "one":
        return np.array([0.25], np.float32)
    if case == "all_zero":
        return np.zeros(50, np.float32)
    w = rng.random({"random": 5000, "zeros": 300,
                    "nonfinite": 40}[case]).astype(np.float32)
    if case == "zeros":
        w[rng.random(len(w)) < 0.5] = 0.0
    if case == "nonfinite":
        w[3] = np.inf
    return w


@pytest.mark.parametrize("case",
                         ["random", "zeros", "all_zero", "one", "nonfinite"])
def test_alias_equals_reference(case):
    w = alias_weights(case)
    got = native.build_alias_native(w)
    assert_results_equal(got, jax_native.build_alias_native(w))


@pytest.mark.parametrize("n_groups", [500, 40_000])
def test_group_alias_equals_reference(n_groups):
    rng = np.random.default_rng(n_groups)
    deg = rng.integers(0, 9, n_groups)
    deg[rng.random(n_groups) < 0.1] = 0
    group_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    w = rng.random(int(group_ptr[-1])).astype(np.float32)
    w[rng.random(len(w)) < 0.1] = 0.0
    got = native.build_group_alias_native(group_ptr, w)
    assert_results_equal(got,
                         jax_native.build_group_alias_native(group_ptr, w))


@pytest.mark.parametrize("n_lines", [300, 120_000])
def test_parse_edge_list_equals_reference(n_lines):
    # 120,000 lines pass 1 MiB, where the parse takes several threads
    buf = edge_list_text(np.random.default_rng(n_lines), n_lines).encode()
    assert (len(buf) >= 1 << 20) == (n_lines > 300)
    got = native.parse_edge_list_native(buf)
    assert_results_equal(got, jax_native.parse_edge_list_native(buf))
    assert 0 < len(got[0]) < n_lines


# --------------------------------------------------------- the build hash --

def old_digest(src, cmd):
    """The library name's hash before quoted includes were hashed."""
    with open(src, "rb") as f:
        return hashlib.sha256(
            f.read() + "\0".join(cmd).encode()).hexdigest()[:16]


@pytest.mark.parametrize("name", ["fan_draw.cu", "euler_core.cc"])
def test_sources_without_quoted_includes_keep_their_name(name):
    src = os.path.join(PACKAGE_DIR, "csrc", name)
    cmd = _CMD if name.endswith(".cc") else [_build.nvcc()] + \
        _build.NVCC_FLAGS
    assert _build.source_digest(src, cmd) == old_digest(src, cmd)


@pytest.mark.parametrize("name,headers", [
    ("gather_rows.cu", ("resident_blocks.cuh",)),
    ("ell_agg.cu", ("bf16_words.cuh", "resident_blocks.cuh")),
    ("ell_attn.cu", ("resident_blocks.cuh",)),
    ("rel_agg.cu", ("bf16_words.cuh", "resident_blocks.cuh")),
    ("sigmoid_xent.cu", ("bf16_words.cuh", "resident_blocks.cuh"))],
    ids=["gather_rows.cu", "ell_agg.cu", "ell_attn.cu", "rel_agg.cu",
         "sigmoid_xent.cu"])
def test_kernels_hash_their_shared_header(name, headers):
    # each sizes its grids with csrc/resident_blocks.cuh (ell_agg.cu,
    # rel_agg.cu and sigmoid_xent.cu share csrc/bf16_words.cuh too): a
    # change of a header renames (rebuilds) every library whose source
    # includes it
    src = os.path.join(PACKAGE_DIR, "csrc", name)
    cmd = [_build.nvcc()] + _build.NVCC_FLAGS
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read() + "\0".join(cmd).encode())
    for header in headers:
        with open(os.path.join(PACKAGE_DIR, "csrc", header), "rb") as f:
            h.update(b"\0" + header.encode() + b"\0" + f.read())
    assert _build.source_digest(src, cmd) == h.hexdigest()[:16]
    assert _build.source_digest(src, cmd) != old_digest(src, cmd)


def test_quoted_include_changes_library_name(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src = csrc / "probe.cc"
    src.write_text('#include <cstdint>\n#include "probe.h"\n'
                   'extern "C" int probe() { return value(); }\n')
    header = csrc / "probe.h"

    def build(value):
        header.write_text(f"inline int value() {{ return {value}; }}\n")
        return _build.build_shared_library(str(src), "probe", _CMD)

    first = build(1)
    second = build(2)
    assert first != second
    assert ctypes.CDLL(first).probe() == 1
    assert ctypes.CDLL(second).probe() == 2
    assert build(1) == first              # an unchanged tree is reused
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        os.path.basename(p) for p in (first, second))
