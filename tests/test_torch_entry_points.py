"""The port's console scripts (pyproject.toml [project.scripts]): each of
its five CLIs under its own name, resolving to a callable of
bath_tpu_torch, beside bath_tpu's five, which stay as they are."""

import importlib
import tomllib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CLIS = ("bathsearch", "bathbuild", "bathconvert", "bathfetch", "bathstat")


def scripts() -> dict:
    with open(ROOT / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


def resolve(target: str):
    module, attr = target.split(":")
    return module, getattr(importlib.import_module(module), attr)


@pytest.mark.parametrize("cli", CLIS)
def test_port_cli_resolves_to_a_callable_of_the_port(cli):
    module, fn = resolve(scripts()[f"{cli}-torch"])
    assert module == f"bath_tpu_torch.cli.{cli}"
    assert callable(fn)


def test_every_cli_has_its_port_twin_and_keeps_its_own():
    s = scripts()
    assert {k for k in s if k.endswith("-torch")} == \
        {f"{c}-torch" for c in CLIS}
    for cli in CLIS:
        assert s[cli].startswith(f"bath_tpu.cli.{cli}:")
