"""``cli generate`` on every rank of a group of two processes, on TINY on
the CPU.

Two ranks (``tests/torch_multihost_rank.py``) run ``cli.main(["generate",
...])`` with the same arguments under ``SDTPU_COORDINATOR``, each with
four ``cpu`` entries as its visible cards and ``--mesh dp=4,tp=2``: the
random ``--image-seed`` is rank 0's on both, both write the same PNG
files, and they are the bytes ``cli generate`` writes in one process over
eight ``cpu`` entries at that seed; each rank leaves the group. With one
``cpu`` entry a rank and ``--mesh tp=2`` the one replica's two shards lie
on the two ranks: both write the PNGs ``cli generate`` writes in one
process over two entries.
"""

import os

from stable_diffusion_webui_distributed_tpu_torch import cli
from stable_diffusion_webui_distributed_tpu_torch.runtime import (
    mesh as mesh_mod,
)
from test_torch_multihost_mesh import SPEC, master_config, run_ranks
from test_torch_parallel import gates_off  # noqa: F401 — fixture


def generate_argv(outdir, cfg, seed, spec=SPEC):
    return ["generate", "--prompt", "a red barn", "--negative", "blurry",
            "--family", "tiny", "--device", "cpu", "--size", "32x32",
            "--steps", "3", "-n", "4", "--image-seed", str(seed),
            "--mesh", spec, "--model-dir", os.path.join(outdir, "none"),
            "--distributed-config", cfg, "--outdir", outdir]


def pngs(outdir):
    names = sorted(n for n in os.listdir(outdir) if n.endswith(".png"))
    return {n: open(os.path.join(outdir, n), "rb").read() for n in names}


def test_cli_generate_on_every_rank_writes_the_one_process_pngs(
        tmp_path, monkeypatch):
    dirs = [str(tmp_path / f"rank{r}") for r in range(2)]
    outs = run_ranks(tmp_path, "cli", per_rank={"argv": [
        generate_argv(d, master_config(tmp_path / f"cfg{r}.json"), -1)
        for r, d in enumerate(dirs)]})
    for out in outs:
        assert out == {"rc": 0, "group_left": True}
    got = [pngs(d) for d in dirs]
    assert len(got[0]) == 4 and got[0] == got[1]
    seed = int(next(iter(got[0])).split("-")[0])
    # one process over eight "cards"
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("SDTPU_COORDINATOR", raising=False)
    monkeypatch.setattr(mesh_mod, "_visible_devices", lambda: ["cpu"] * 8)
    one = str(tmp_path / "one")
    assert cli.main(generate_argv(
        one, master_config(tmp_path / "cfg.json"), seed)) == 0
    assert pngs(one) == got[0]



def test_cli_generate_on_tp2_across_the_ranks_writes_the_one_process_pngs(
        tmp_path, monkeypatch):
    # one cpu entry a rank: the one replica's two shards on two ranks
    dirs = [str(tmp_path / f"rank{r}") for r in range(2)]
    outs = run_ranks(tmp_path, "cli", local=1, per_rank={"argv": [
        generate_argv(d, master_config(tmp_path / f"cfg{r}.json"), 7,
                      "tp=2") for r, d in enumerate(dirs)]})
    for out in outs:
        assert out == {"rc": 0, "group_left": True}
    got = [pngs(d) for d in dirs]
    assert len(got[0]) == 4 and got[0] == got[1]
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("SDTPU_COORDINATOR", raising=False)
    monkeypatch.setattr(mesh_mod, "_visible_devices", lambda: ["cpu"] * 2)
    one = str(tmp_path / "one")
    assert cli.main(generate_argv(
        one, master_config(tmp_path / "cfg.json"), 7, "tp=2")) == 0
    assert pngs(one) == got[0]
