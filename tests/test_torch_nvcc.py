"""The kernel library's name (``ops/nvcc.py``) on the CPU, the compiler
stubbed.

A library is named by its sources and by the toolchain: the compiler's
flags, ``nvcc --version`` (read once per process), ``torch.version.cuda``
and the card's compute capability. A change to any of them gives another
library path, so a stale ``.so`` is never loaded; nothing changed gives
the same path, and a second build loads the first one's library without
running the compiler again.
"""

import subprocess

import pytest
import torch

from stable_diffusion_webui_distributed_tpu_torch.ops import nvcc

SOURCE = nvcc.CSRC / "flash_attention.cu"
RELEASE_12_4 = "Cuda compilation tools, release 12.4, V12.4.131"


class FakeNvcc:
    """``subprocess.run`` for nvcc: ``--version`` prints ``version``; a
    compile writes its ``-o`` file."""

    def __init__(self, version=RELEASE_12_4):
        self.version = version
        self.calls = []

    def __call__(self, args, **kwargs):
        self.calls.append(list(args))
        if "--version" in args:
            return subprocess.CompletedProcess(args, 0, self.version, "")
        out = args[args.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"\x7fELF")
        return subprocess.CompletedProcess(args, 0, "ptxas info", "")


@pytest.fixture
def fake(monkeypatch, tmp_path):
    stub = FakeNvcc()
    monkeypatch.setattr(nvcc.subprocess, "run", stub)
    monkeypatch.setattr(nvcc, "_NVCC_VERSION", None)
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path)
    return stub


def fresh_path(monkeypatch):
    monkeypatch.setattr(nvcc, "_NVCC_VERSION", None)
    return nvcc.library_path(SOURCE)


def test_unchanged_toolchain_gives_the_same_path(fake, monkeypatch):
    assert fresh_path(monkeypatch) == fresh_path(monkeypatch)
    assert nvcc.library_path(SOURCE).name.startswith("flash_attention-")


def test_a_changed_flag_gives_another_path(fake, monkeypatch):
    before = fresh_path(monkeypatch)
    monkeypatch.setattr(nvcc, "_NVCC_FLAGS", nvcc._NVCC_FLAGS + ("-G",))
    assert fresh_path(monkeypatch) != before


def test_a_changed_nvcc_version_gives_another_path(fake, monkeypatch):
    before = fresh_path(monkeypatch)
    fake.version = "Cuda compilation tools, release 12.8, V12.8.93"
    assert fresh_path(monkeypatch) != before
    fake.version = RELEASE_12_4
    assert fresh_path(monkeypatch) == before


def test_cuda_runtime_and_capability_name_the_library(fake, monkeypatch):
    before = fresh_path(monkeypatch)
    monkeypatch.setattr(torch.version, "cuda", "99.9")
    runtime = fresh_path(monkeypatch)
    assert runtime != before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda *a: (9, 0))
    hopper = fresh_path(monkeypatch)
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda *a: (8, 0))
    assert len({runtime, hopper, fresh_path(monkeypatch)}) == 3


def test_build_reads_the_version_once_and_reuses_the_library(fake):
    lib, log = nvcc.build(SOURCE)
    assert lib.exists() and log == "ptxas info"
    again, _ = nvcc.build(SOURCE)
    assert again == lib
    versions = [c for c in fake.calls if "--version" in c]
    compiles = [c for c in fake.calls if "-o" in c]
    assert len(versions) == 1 and len(compiles) == 1
    assert all(flag in compiles[0] for flag in nvcc._NVCC_FLAGS)
