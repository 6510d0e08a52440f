"""The port's kernel build (``dr4sr_tpu_torch/ops/_build.py``) on the CPU.

The CUDA kernels are built by ``nvcc`` on the machine with the card; here we
check what decides a build: the cached library's name covers the source,
every header of ``csrc/`` and the flags; importing the package starts no
``nvcc``; and ``KERNELS`` names every kernel source.
"""

import glob
import os
import subprocess
import sys
import textwrap

import pytest

from dr4sr_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A temporary ``csrc/`` with one kernel source and two headers."""
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "k.cu").write_text('#include "frag.cuh"\nextern "C" int k() { return 0; }\n')
    (d / "frag.cuh").write_text("// fragment helpers\n")
    (d / "util.h").write_text("// plain helpers\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(d))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    return d


@pytest.mark.parametrize("edit", ["source", "cuh_header", "h_header", "new_header", "flags"])
def test_library_path_follows_sources_headers_and_flags(csrc, monkeypatch, edit):
    before = _build.library_path("k")
    assert _build.library_path("k") == before  # unchanged inputs: the same library
    assert os.path.dirname(before) == _build.BUILD_DIR
    if edit == "source":
        (csrc / "k.cu").write_text((csrc / "k.cu").read_text() + "// edited\n")
    elif edit == "cuh_header":
        (csrc / "frag.cuh").write_text("// fragment helpers, edited\n")
    elif edit == "h_header":
        (csrc / "util.h").write_text("// plain helpers, edited\n")
    elif edit == "new_header":
        (csrc / "more.cuh").write_text("// another header\n")
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("k") != before


def test_unrelated_files_leave_the_library_path(csrc):
    before = _build.library_path("k")
    (csrc / "notes.txt").write_text("not a header\n")
    assert _build.library_path("k") == before


def test_kernels_names_every_source():
    sources = sorted(os.path.basename(p)[: -len(".cu")]
                     for p in glob.glob(os.path.join(_build.CSRC_DIR, "*.cu")))
    assert sorted(_build.KERNELS) == sources
    assert all(os.path.exists(_build.source_path(name)) for name in _build.KERNELS)


def _run_with_fake_nvcc(tmp_path, code):
    """Run ``code`` in a fresh interpreter whose only ``nvcc`` (on PATH and
    under $CUDA_HOME/bin) is a stub that records each call in a file."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    calls = tmp_path / "nvcc_calls"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(f'#!/bin/sh\necho "$@" >> "{calls}"\nexit 1\n')
    nvcc.chmod(0o755)
    env = {**os.environ, "PATH": f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}",
           "CUDA_HOME": str(tmp_path / "cuda"), "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return calls.read_text().splitlines() if calls.exists() else []


def test_import_starts_no_nvcc(tmp_path):
    calls = _run_with_fake_nvcc(tmp_path, """
        import torch
        import dr4sr_tpu_torch
        import dr4sr_tpu_torch.ops.attention as attention
        x = torch.zeros(1, 1, 4, 32)
        attention.multihead_attention(x, x, x)  # the CPU route
        try:
            attention.flash_attention_fwd(x, x, x)  # refuses a CPU tensor before any build
        except ValueError:
            pass
    """)
    assert calls == []


@pytest.fixture
def miner_copy(tmp_path, monkeypatch):
    """The port's miner with its source copied to a temporary file and its
    build directory moved to a temporary one."""
    from dr4sr_tpu_torch.regen import miner

    src = tmp_path / "seqminer.cpp"
    src.write_text(open(miner.SOURCE).read())
    monkeypatch.setattr(miner, "SOURCE", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    return miner, src


@pytest.mark.parametrize("edit", ["source", "flags"])
def test_miner_library_path_follows_source_and_flags(miner_copy, monkeypatch, edit):
    miner, src = miner_copy
    before = miner.library_path()
    assert miner.library_path() == before
    assert os.path.dirname(before) == _build.BUILD_DIR
    assert os.path.basename(before).startswith("seqminer-") and before.endswith(".so")
    if edit == "source":
        src.write_text(src.read_text() + "// edited\n")
    else:
        monkeypatch.setattr(miner, "GXX_FLAGS", miner.GXX_FLAGS + ("-g",))
    assert miner.library_path() != before


def test_the_port_builds_its_own_miner_copy(miner_copy, monkeypatch):
    """The build compiles the port's own source with the JAX package's
    flags and writes only into the build directory; the library works."""
    miner, src = miner_copy
    calls = []
    real_run = subprocess.run

    def recording_run(cmd, *args, **kwargs):
        calls.append(list(cmd))
        return real_run(cmd, *args, **kwargs)

    monkeypatch.setattr(miner.subprocess, "run", recording_run)
    path = miner.build()
    assert path == miner.library_path() and os.path.exists(path)
    assert os.listdir(_build.BUILD_DIR) == [os.path.basename(path)]
    assert len(calls) == 1
    cmd = calls[0]
    assert cmd[:6] == ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]
    assert cmd[6] == str(src) and cmd[7] == "-o"
    assert os.path.dirname(cmd[8]) == _build.BUILD_DIR
    assert miner.build() == path and len(calls) == 1  # cached: no second compile


def test_the_miner_source_is_the_ports_own():
    from dr4sr_tpu_torch.regen import miner

    port_pkg = os.path.join(REPO, "dr4sr_tpu_torch")
    assert os.path.commonpath([miner.SOURCE, port_pkg]) == port_pkg
    assert os.path.commonpath([_build.BUILD_DIR, port_pkg]) == port_pkg
    jax_src = os.path.join(REPO, "dr4sr_tpu", "cpp", "seqminer.cpp")
    code = [open(p).read().split('extern "C" {', 1)[1] for p in (miner.SOURCE, jax_src)]
    assert code[0] == code[1]  # the same C API and code; only the header comment differs


def test_importing_the_regen_modules_builds_nothing(tmp_path):
    """No ``g++`` (nor ``nvcc``) at import: a stub compiler on PATH records calls."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    calls = tmp_path / "calls"
    for tool in ("g++", "nvcc"):
        (bin_dir / tool).write_text(f'#!/bin/sh\necho {tool} "$@" >> "{calls}"\nexit 1\n')
        (bin_dir / tool).chmod(0o755)
    env = {**os.environ, "PATH": f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}",
           "PYTHONPATH": REPO}
    code = ("import dr4sr_tpu_torch.regen.pipeline, dr4sr_tpu_torch.scripts.hybrid_inference, "
            "dr4sr_tpu_torch.scripts.fused_pipeline")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert not calls.exists()


def test_the_stub_sees_a_build(tmp_path):
    """The control for the test above: a build does reach the stub."""
    calls = _run_with_fake_nvcc(tmp_path, f"""
        from dr4sr_tpu_torch.ops import _build
        _build.BUILD_DIR = {str(tmp_path / "build")!r}
        try:
            _build.build("flash_attention_fwd")
        except RuntimeError as e:
            assert "nvcc failed" in str(e)
        else:
            raise AssertionError("the stub nvcc exits 1, so the build must fail")
    """)
    assert len(calls) == 1 and "sm_90a" in calls[0] and calls[0].endswith("flash_attention_fwd.cu")
