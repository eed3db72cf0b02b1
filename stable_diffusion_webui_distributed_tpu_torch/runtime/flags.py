"""The fleet's command-line flags, as the JAX package's ``runtime/flags.py``
names them: ``--mesh`` places the local engine over a device mesh
(``runtime/mesh.py``), and ``--model-dir`` names the model directory the
checkpoint registry serves. ``add_flags`` also works on a host
application's parser."""

from __future__ import annotations

import argparse


def add_flags(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group("distributed")
    group.add_argument(
        "--distributed-config", type=str, default=None,
        help="path of the distributed config file (default: $SDTPU_CONFIG "
        "or distributed-config.json)")
    group.add_argument(
        "--distributed-debug", action="store_true",
        help="verbose logging")
    group.add_argument(
        "--distributed-skip-verify-remotes", action="store_true",
        help="disable TLS certificate verification for remote workers")
    group.add_argument(
        "--thin-client", action="store_true",
        help="exclude the local engine from planning: coordinate remotes "
        "only")
    group.add_argument(
        "--mesh", type=str, default=None,
        help='mesh axis spec over every visible card, e.g. "dp=4,tp=2" '
        "(default: the config file's mesh_axes, else no mesh)")
    group.add_argument(
        "--model-dir", type=str, default=None,
        help="model directory: LoRA adapters under Lora/ or lora/ "
        "(default: the config file's model_dir)")
    group.add_argument("--listen", type=str, default="127.0.0.1",
                       help="API bind host")
    group.add_argument("--port", type=int, default=7860, help="API bind port")
    return parser
