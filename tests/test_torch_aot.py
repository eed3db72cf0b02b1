"""The port's kernel-library artifact store (``serving/aot.py``,
``ops/nvcc.py``) on the CPU, held against the JAX package's ``AotStore``.

Both stores run with an explicit fingerprint and byte blobs (the JAX
store's ``AotFunction``, which deserializes XLA executables, is not used):
the same cell ids; the same outcomes for a miss, a hit in a new instance,
a truncated, bit-flipped or missing artifact and a fingerprint mismatch;
the same manifest but for ``created_at`` and the artifact suffix; the same
``verify()`` divergence and orphans, and the same tallies. Two repairs are
the port's own: a damaged artifact is removed with its cell, and a
rebuild's save removes the file of the cell it replaces (the JAX store
leaves both behind as orphans).

``KernelLibrary`` then goes through the store with nvcc replaced by a stub
that writes known bytes and ``ctypes.CDLL`` by one that loads only those:
a miss builds and saves, a new library loads the store's file without a
compile (``aot_loads``, ``sdtpu_aot_total``, ``sdtpu_aot_load_seconds``),
a truncated artifact and a changed fingerprint are rebuilt and journaled
``aot_fallback``, a library that fails its load after a hit is rebuilt once
and a second failure raises; with the gate off ``_build/`` is used as
before (and gets the same rebuild-once repair) and the store's directory
is never made. The warmup report's ``aot`` block lists the store's view.
"""

import hashlib
import json
import os
import subprocess
import types

import pytest

from stable_diffusion_webui_distributed_tpu.serving import aot as j_aot
from stable_diffusion_webui_distributed_tpu_torch.obs import journal
from stable_diffusion_webui_distributed_tpu_torch.obs import (
    prometheus as prom,
)
from stable_diffusion_webui_distributed_tpu_torch.ops import nvcc
from stable_diffusion_webui_distributed_tpu_torch.serving import aot
from stable_diffusion_webui_distributed_tpu_torch.serving import warmup
from stable_diffusion_webui_distributed_tpu_torch.serving.bucketer import (
    ShapeBucketer,
)
from stable_diffusion_webui_distributed_tpu_torch.serving.metrics import (
    METRICS,
)

FP = {"torch": "2.x", "torch_cuda": "12.4", "toolchain": "nvcc 12.4",
      "device_name": "NVIDIA H100 80GB HBM3", "capability": "9.0",
      "device_count": "1"}
OTHER_FP = {**FP, "device_name": "NVIDIA A100-SXM4-80GB",
            "capability": "8.0"}
CELLS = [("flash_attention:0123", "sm90 toolchain a"),
         ("ragged_attention:4567", "sm90 toolchain a"),
         ("flash_attention:0123", "sm90 toolchain b")]
BLOBS = [b"library one" * 50, b"library two" * 70, b"library one" * 50]


def stores(root, fp=FP):
    """A JAX store and a port store over sibling directories."""
    return (j_aot.AotStore(str(root / "jax"), fingerprint=fp),
            aot.AotStore(str(root / "port"), fingerprint=fp))


def filled(root):
    pair = stores(root)
    for s in pair:
        for (key, sig), blob in zip(CELLS, BLOBS):
            assert s.save(key, sig, key.split(":")[0], blob)
    return pair


def comparable(manifest, suffix):
    """The manifest without ``created_at``, files named by their sha."""
    cells = {}
    for cid, cell in manifest["cells"].items():
        cell = dict(cell)
        cell.pop("created_at")
        assert cell["file"] == cell["sha256"] + suffix
        cell["file"] = cell["sha256"]
        cells[cid] = cell
    return {"schema": manifest["schema"], "cells": cells}


def same_verify(a, b):
    for key in ("fingerprint", "fingerprint_id", "cells", "divergent", "ok"):
        assert a[key] == b[key], key
    assert [o[:-len(j_aot.ARTIFACT_SUFFIX)] for o in a["orphans"]] == \
        [o[:-len(aot.ARTIFACT_SUFFIX)] for o in b["orphans"]]


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for name in ("SDTPU_AOT", "SDTPU_AOT_DIR", "SDTPU_JOURNAL"):
        monkeypatch.delenv(name, raising=False)
    METRICS.clear()
    prom.clear_histograms()
    journal.JOURNAL.clear()
    aot._STORES.clear()
    yield
    METRICS.clear()
    prom.clear_histograms()
    journal.JOURNAL.clear()
    aot._STORES.clear()


def test_cell_ids_and_fingerprint_ids_match():
    for key, sig in CELLS + [("", ""), ("k" * 300, "s\n" * 40)]:
        assert aot.AotStore.cell_id(key, sig) == \
            j_aot.AotStore.cell_id(key, sig)
    for fp in (FP, OTHER_FP, {}):
        assert aot.fingerprint_id(fp) == j_aot.fingerprint_id(fp)


def test_miss_save_hit_and_manifest_match(tmp_path):
    for s in stores(tmp_path):
        assert [s.load(k, g)[0] for k, g in CELLS] == ["miss"] * 3
    jax_s, port_s = filled(tmp_path)
    again = stores(tmp_path)  # new instances read the manifest from disk
    for s in again:
        assert [s.load(k, g) for k, g in CELLS] == \
            [("hit", b) for b in BLOBS]
    assert comparable(jax_s.manifest(), j_aot.ARTIFACT_SUFFIX) == \
        comparable(port_s.manifest(), aot.ARTIFACT_SUFFIX)
    assert jax_s.stats_snapshot() == port_s.stats_snapshot() == {
        "hit": 0, "miss": 0, "saved": 3, "fallback": 0}
    # one content, one file: the two cells of equal bytes share it
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        [hashlib.sha256(b).hexdigest() + ".so" for b in set(BLOBS)]
        + ["manifest.json"])
    same_verify(jax_s.verify(), port_s.verify())
    assert port_s.verify()["ok"]
    doc = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert doc["schema"] == 1 and len(doc["cells"]) == 3


def test_fingerprint_mismatch_matches(tmp_path):
    filled(tmp_path)
    for s in stores(tmp_path, OTHER_FP):
        assert [s.load(k, g) for k, g in CELLS] == \
            [("fingerprint_mismatch", None)] * 3


def truncate(path):
    path.write_bytes(path.read_bytes()[:3])


def flip(path):
    data = bytearray(path.read_bytes())
    data[3] ^= 0x40
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("damage", [truncate, flip, os.remove])
def test_damaged_artifact_matches(tmp_path, damage):
    filled(tmp_path)
    sha = hashlib.sha256(BLOBS[1]).hexdigest()
    damage(tmp_path / "jax" / (sha + j_aot.ARTIFACT_SUFFIX))
    damage(tmp_path / "port" / (sha + aot.ARTIFACT_SUFFIX))
    jax_s, port_s = stores(tmp_path)
    same_verify(jax_s.verify(), port_s.verify())
    bad = port_s.verify()
    assert bad["divergent"] == [aot.AotStore.cell_id(*CELLS[1])]
    assert bad["cells"][[c["cell"] for c in bad["cells"]].index(
        bad["divergent"][0])]["status"] in ("sha_mismatch", "missing")
    assert [s.load(*CELLS[1]) for s in (jax_s, port_s)] == \
        [("corrupt", None)] * 2
    assert comparable(jax_s.manifest(), j_aot.ARTIFACT_SUFFIX) == \
        comparable(port_s.manifest(), aot.ARTIFACT_SUFFIX)
    # the port removes the damaged file; the JAX store keeps it (orphan)
    assert port_s.verify()["ok"] and port_s.verify()["orphans"] == []
    assert jax_s.verify()["orphans"] == (
        [] if damage is os.remove else [sha + j_aot.ARTIFACT_SUFFIX])
    # a rebuild of the same bytes back-fills a sound file
    for s in (jax_s, port_s):
        assert s.save(CELLS[1][0], CELLS[1][1], "ragged_attention",
                      BLOBS[1])
    assert port_s.load(*CELLS[1]) == ("hit", BLOBS[1])
    assert port_s.verify()["ok"]


def test_mismatch_rebuild_of_other_bytes_leaves_no_orphan(tmp_path):
    filled(tmp_path)
    others = stores(tmp_path, OTHER_FP)
    for s in others:
        assert s.load(*CELLS[1]) == ("fingerprint_mismatch", None)
        assert s.save(CELLS[1][0], CELLS[1][1], "ragged_attention",
                      b"another build" * 60)
    jax_s, port_s = others
    assert comparable(jax_s.manifest(), j_aot.ARTIFACT_SUFFIX) == \
        comparable(port_s.manifest(), aot.ARTIFACT_SUFFIX)
    # the replaced build's file goes with its cell; the JAX store keeps it
    assert port_s.verify()["ok"]
    sha = hashlib.sha256(BLOBS[1]).hexdigest()
    assert jax_s.verify()["orphans"] == [sha + j_aot.ARTIFACT_SUFFIX]
    # a file another cell still claims stays
    assert port_s.save(CELLS[2][0], CELLS[2][1], "flash_attention",
                       b"third build" * 60)
    assert port_s.verify()["ok"]
    assert port_s.load(*CELLS[0]) == ("fingerprint_mismatch", None)
    assert (tmp_path / "port" / (hashlib.sha256(BLOBS[0]).hexdigest()
                                 + ".so")).exists()


def test_orphans_and_garbage_manifest_match(tmp_path):
    jax_s, port_s = filled(tmp_path)
    (tmp_path / "jax" / ("f" * 64 + j_aot.ARTIFACT_SUFFIX)).write_bytes(b"x")
    (tmp_path / "port" / ("f" * 64 + aot.ARTIFACT_SUFFIX)).write_bytes(b"x")
    same_verify(jax_s.verify(), port_s.verify())
    assert port_s.verify()["orphans"] == ["f" * 64 + ".so"]
    for name in ("jax", "port"):
        (tmp_path / name / "manifest.json").write_text('{"schema": 2}')
    for s in stores(tmp_path):
        assert s.load(*CELLS[0]) == ("miss", None)


# -- KernelLibrary through the store ------------------------------------------


class FakeNvcc:
    """``subprocess.run`` for nvcc: ``--version`` answers, a compile writes
    ``GOOD`` and the source's name to its ``-o`` file (the same bytes on
    every build, as nvcc gives)."""

    def __init__(self):
        self.compiles = 0

    def __call__(self, args, **kwargs):
        if "--version" in args:
            return subprocess.CompletedProcess(args, 0, "release 12.4", "")
        self.compiles += 1
        with open(args[args.index("-o") + 1], "wb") as f:
            f.write(b"GOOD " + os.path.basename(args[-1]).encode())
        return subprocess.CompletedProcess(args, 0, "ptxas info", "")


class FakeCDLL:
    """``ctypes.CDLL``: loads a file that starts ``GOOD``; ``refuse`` more
    loads fail as a damaged library does."""

    refuse = 0
    loads = []

    def __init__(self, path):
        with open(path, "rb") as f:
            good = f.read().startswith(b"GOOD")
        if not good or FakeCDLL.refuse:
            FakeCDLL.refuse = max(0, FakeCDLL.refuse - 1)
            raise OSError(f"{path}: invalid ELF header")
        FakeCDLL.loads.append(path)
        self.sdt_entry = types.SimpleNamespace()


@pytest.fixture
def fake(monkeypatch, tmp_path):
    stub = FakeNvcc()
    monkeypatch.setattr(nvcc.subprocess, "run", stub)
    monkeypatch.setattr(nvcc, "_NVCC_VERSION", None)
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(nvcc.ctypes, "CDLL", FakeCDLL)
    monkeypatch.setattr(FakeCDLL, "refuse", 0)
    monkeypatch.setattr(FakeCDLL, "loads", [])
    monkeypatch.setenv("SDTPU_AOT_DIR", str(tmp_path / "store"))
    monkeypatch.setenv("SDTPU_JOURNAL", "1")
    return stub


def library(source="flash_attention.cu"):
    return nvcc.KernelLibrary(source, "sdt_entry", [])


def exposition():
    return {line for line in prom.render().splitlines()
            if line.startswith("sdtpu_aot")}


def fallbacks():
    return [e for e in journal.JOURNAL.snapshot()["events"]
            if e["event"] == "aot_fallback"]


def test_store_miss_then_hit_in_a_new_library(fake, tmp_path, monkeypatch):
    monkeypatch.setenv("SDTPU_AOT", "1")
    first = library()
    first.function()
    assert first.outcome == "miss" and fake.compiles == 1
    store = aot.get_store()
    assert store.stats_snapshot() == {"hit": 0, "miss": 1, "saved": 1,
                                      "fallback": 0}
    (cell,) = store.manifest()["cells"].values()
    assert cell["kind"] == "flash_attention"
    assert cell["key"] == nvcc.source_digest(first.source)
    assert cell["sig"] == nvcc.toolchain()
    assert cell["fingerprint"] == aot.runtime_fingerprint()
    assert not (tmp_path / "_build").exists()
    assert FakeCDLL.loads == [str(tmp_path / "store" / cell["file"])]

    second = library()
    second.function()
    assert second.outcome == "hit" and fake.compiles == 1
    assert FakeCDLL.loads[-1] == FakeCDLL.loads[0]  # nothing copied
    assert METRICS.summary()["aot_loads"] == {"flash_attention": 1}
    lines = exposition()
    assert {'sdtpu_aot_total{outcome="miss"} 1',
            'sdtpu_aot_total{outcome="saved"} 1',
            'sdtpu_aot_total{outcome="hit"} 1',
            'sdtpu_aot_load_seconds_count{kind="flash_attention"} 1'} <= lines
    del first  # one library of a kind, as the process has
    assert nvcc.store_outcomes()["flash_attention"] == "hit"
    assert store.verify()["ok"] and fallbacks() == []


def test_store_build_then_function_loads_that_build(fake, monkeypatch):
    monkeypatch.setenv("SDTPU_AOT", "1")
    lib = library()
    path, log = lib.build()  # nvcc alone, as a parallel build runs it
    assert log == "ptxas info" and lib.outcome == "miss"
    lib.function()  # loads the build: no second lookup, no hit
    assert FakeCDLL.loads == [str(path)] and fake.compiles == 1
    assert aot.get_store().stats_snapshot() == {
        "hit": 0, "miss": 1, "saved": 1, "fallback": 0}
    assert METRICS.summary()["aot_loads"] == {}


@pytest.mark.parametrize("damage", ["truncate", "mismatch"])
def test_store_damage_rebuilds(fake, tmp_path, monkeypatch, damage):
    monkeypatch.setenv("SDTPU_AOT", "1")
    library("ragged_attention.cu").function()
    store_dir = tmp_path / "store"
    manifest = store_dir / "manifest.json"
    doc = json.loads(manifest.read_text())
    (cid, cell), = doc["cells"].items()
    if damage == "truncate":
        truncate(store_dir / cell["file"])
    else:
        cell["fingerprint_id"] = "0" * 16
        manifest.write_text(json.dumps(doc))
    aot._STORES.clear()  # a new process
    lib = library("ragged_attention.cu")
    lib.function()
    want = "corrupt" if damage == "truncate" else "fingerprint_mismatch"
    assert lib.outcome == want and fake.compiles == 2
    store = aot.get_store()
    assert store.stats_snapshot() == {"hit": 0, "miss": 0, "saved": 1,
                                      "fallback": 1}
    assert store.verify()["ok"] and len(store.manifest()["cells"]) == 1
    (event,) = fallbacks()
    assert event["attrs"]["reason"] == want \
        and event["request_id"] == "aot-ragged_attention"
    assert METRICS.summary()["aot_loads"] == {}
    assert 'sdtpu_aot_total{outcome="fallback"} 1' in exposition()


def test_store_load_failure_rebuilds_once_then_raises(fake, monkeypatch):
    monkeypatch.setenv("SDTPU_AOT", "1")
    library().function()
    FakeCDLL.refuse = 1  # the stored library fails its load once
    lib = library()
    lib.function()
    assert lib.outcome == "corrupt" and fake.compiles == 2
    assert fallbacks()[-1]["attrs"]["reason"] == "corrupt"
    assert aot.get_store().verify()["ok"]
    FakeCDLL.refuse = 2  # and now every time
    with pytest.raises(OSError):
        library().function()
    assert fake.compiles == 3  # one rebuild, then the raise


def test_gate_off_uses_build_dir_and_never_the_store(fake, tmp_path):
    lib = library()
    lib.function()
    assert lib.outcome is None and fake.compiles == 1
    assert FakeCDLL.loads == [str(nvcc.library_path(lib.source))]
    truncate(nvcc.library_path(lib.source))
    library().function()  # the damaged library rebuilt once
    assert fake.compiles == 2
    FakeCDLL.refuse = 2  # every load fails: one rebuild, then the raise
    with pytest.raises(OSError):
        library().function()
    assert fake.compiles == 3
    assert not (tmp_path / "store").exists()
    assert exposition() == set()  # no sample, no histogram
    assert METRICS.summary()["aot_loads"] == {}


class Stub:
    """The engine surface the warmup sweep calls."""

    def __init__(self):
        self.state = types.SimpleNamespace(begin_request=lambda: None)
        self._warmup_lora = self._traced_lora = None

    def generate_range(self, payload, start, count, job):
        return None


def test_warmup_report_aot_block(fake, tmp_path, monkeypatch):
    bucketer = ShapeBucketer(shapes=[(64, 64)], batches=[1])
    assert "aot" not in warmup.warmup_engine(Stub(), bucketer, steps=1)
    monkeypatch.setenv("SDTPU_AOT", "1")
    libraries = [library(), library()]
    for lib in libraries:
        lib.function()
    report = warmup.warmup_engine(Stub(), bucketer, steps=1)
    block = report["aot"]
    assert set(block) >= {"enabled", "dir", "hydrated", "hit_rate"}
    assert block["enabled"] is True
    assert block["dir"] == str(tmp_path / "store")
    assert block["stats"] == {"hit": 1, "miss": 1, "saved": 1,
                              "fallback": 0}
    assert block["libraries"]["flash_attention"] in ("hit", "miss")
    assert block["hydrated"] == {}  # nothing loaded during the sweep
