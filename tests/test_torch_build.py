"""The kernel build helper's host logic, on the CPU: library names hash the
source and flags, every missing library is built by one compiler process
per source, a failed build raises with the compiler's output, and a
missing toolkit raises instead of falling back. A stand-in script plays
nvcc; the real build runs on the card (chip_smoke.py phase 1)."""
import os
import stat

import pytest
import torch

from repro_torch.kernels import _build

torch.set_num_threads(1)


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    return csrc, out, tmp_path


def _fake_nvcc(path, body):
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_library_name_tracks_the_source(tree):
    csrc, _, _ = tree
    first = _build._target(csrc / "a.cu")
    assert first == _build._target(csrc / "a.cu")
    (csrc / "a.cu").write_text("// a, edited\n")
    assert _build._target(csrc / "a.cu") != first
    assert first.name.startswith("a.") and first.suffix == ".so"


def test_library_names_track_the_headers(tree):
    """The sources include csrc/*.cuh: an edited header renames every
    library, so no library built against the old header is loaded."""
    csrc, _, _ = tree
    (csrc / "common.cuh").write_text("// v1\n")
    first = {n: _build._target(csrc / n) for n in ("a.cu", "b.cu")}
    assert first == {n: _build._target(csrc / n) for n in ("a.cu", "b.cu")}
    (csrc / "common.cuh").write_text("// v2\n")
    for n in ("a.cu", "b.cu"):
        assert _build._target(csrc / n) != first[n]


def test_build_all_compiles_each_missing_source_once(tree, monkeypatch):
    csrc, out, tmp = tree
    log = tmp / "calls"
    # writes the file named after -o and records the source it was given
    nvcc = _fake_nvcc(tmp / "nvcc", f'''
while [ "$#" -gt 1 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo "$1" >> {log}
echo "ptxas info    : Used 1 registers" > "$out"
echo "ptxas info    : Used 1 registers"
''')
    monkeypatch.setattr(_build, "find_nvcc", lambda: nvcc)
    targets = _build.build_all()
    assert sorted(targets) == ["a", "b"]
    assert all(p.exists() and p.parent == out for p in targets.values())
    assert sorted(log.read_text().split()) == sorted(
        str(csrc / n) for n in ("a.cu", "b.cu"))
    assert "registers" in _build.BUILD_LOG["a"]
    assert not [p for p in out.iterdir() if ".tmp" in p.name]
    _build.build_all()                      # nothing missing: no new call
    assert len(log.read_text().split()) == 2


def test_failed_build_raises_with_compiler_output(tree, monkeypatch):
    _, _, tmp = tree
    nvcc = _fake_nvcc(tmp / "nvcc", 'echo "error: bad kernel"; exit 3\n')
    monkeypatch.setattr(_build, "find_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build_all()


def test_missing_toolkit_raises(tree, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", os.fspath(tree[2] / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


_ENTRIES = [  # (source stem, entry point, wrapper module, getter args)
    ("swat_decode", "swat_decode_fused", "swat_decode",
     ("swat_decode_fused", 12)),
    ("swat_decode", "swat_decode_plain", "swat_decode",
     ("swat_decode_plain", 13, 5)),
    ("swat_attention_fwd", "swat_attention_fwd", "swat_attention", ()),
    ("swat_attention_fwd", "swat_attention_fwd_tc", "swat_attention",
     ("swat_attention_fwd_tc",)),
    ("swat_attention_bwd", "swat_attention_dq", "swat_backward",
     ("swat_attention_dq", 9)),
    ("swat_attention_bwd", "swat_attention_dq_tc", "swat_backward",
     ("swat_attention_dq_tc", 9)),
    ("swat_attention_bwd", "swat_attention_dkv", "swat_backward",
     ("swat_attention_dkv", 10)),
    ("swat_attention_bwd", "swat_attention_dkv_tc", "swat_backward",
     ("swat_attention_dkv_tc", 13)),
    ("swat_attention_bwd", "swat_attention_dkv_combine", "swat_backward",
     None),           # its own getter, _combine_kernel()
]


@pytest.mark.parametrize("stem,entry,module,args", _ENTRIES,
                         ids=[e[1] for e in _ENTRIES])
def test_ctypes_signatures_match_the_sources(stem, entry, module, args,
                                             monkeypatch):
    """Each wrapper's argtypes follow the `extern "C"` signature in its
    source, argument by argument: a pointer, int or float passed as another
    type is cut or misread without any error."""
    import ctypes
    import importlib
    import re

    class _Fn:
        argtypes = None

    class _Lib:
        def __getattr__(self, name):
            fn = _Fn()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "load", lambda stem: _Lib())
    src = (_build.CSRC / f"{stem}.cu").read_text()
    sig = re.search(r'extern "C" int ' + entry + r"\((.*?)\)", src, re.S)
    want = [ctypes.c_void_p if "*" in a else
            ctypes.c_float if a.split()[0] == "float" else ctypes.c_int
            for a in sig.group(1).split(",")]
    wrapper = importlib.import_module(f"repro_torch.kernels.{module}")
    fn = (wrapper._combine_kernel() if args is None
          else wrapper._kernel(*args))
    assert fn.argtypes == want
