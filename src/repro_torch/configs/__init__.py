"""Assigned-architecture registry (port of ``repro.configs``): ``--arch
<id>`` resolves here.

Every arch of the reference is listed and ported (``PORTED`` is all of
``ARCHS``): each has a module here defining ``CONFIG`` (the exact
published shape) and ``SMOKE`` (a reduced same-family config that runs
on the CPU), exactly as the reference defines them.
"""
from __future__ import annotations

import importlib

ARCHS: dict[str, str] = {
    "internvl2-1b": "internvl2_1b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "zamba2-2.7b": "zamba2_2p7b",
    "seamless-m4t-large-v2": "seamless_m4t_v2",
    "starcoder2-7b": "starcoder2_7b",
    "gemma3-27b": "gemma3_27b",
    "yi-6b": "yi_6b",
    "gemma2-2b": "gemma2_2b",
}

PORTED = frozenset(ARCHS)


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke(arch: str):
    return _module(arch).SMOKE


def all_archs() -> tuple[str, ...]:
    return tuple(ARCHS)
