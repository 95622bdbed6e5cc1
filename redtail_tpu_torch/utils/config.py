"""Typed configuration (`redtail_tpu/utils/config.py`): one schema shared
by nodes, apps and tools.

The reference layered ROS parameter-server lookups, roslaunch `<arg>`
XML and raw argv parsing (SURVEY.md §5 "config/flag system"); here every
component already takes a frozen dataclass (e.g.
`control.ControllerConfig`) and this module provides the generic
dataclass <-> CLI bridge plus the startup "config echo" the reference
nodes printed (`caffe_ros.cpp:61-78`, `px4_controller.cpp:448-458`).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Sequence, Type, TypeVar

T = TypeVar("T")


def add_config_args(parser: argparse.ArgumentParser, cls: Type,
                    prefix: str = "") -> None:
    """Register every field of a dataclass as `--<prefix><field>`."""
    for f in dataclasses.fields(cls):
        if not f.init:
            continue
        name = f"--{prefix}{f.name.replace('_', '-')}"
        default = f.default if f.default is not dataclasses.MISSING else None
        if f.type in (bool, "bool"):
            parser.add_argument(name, type=lambda s: s.lower() in
                                ("1", "true", "yes"), default=default)
        elif f.type in (int, "int"):
            parser.add_argument(name, type=int, default=default)
        elif f.type in (float, "float"):
            parser.add_argument(name, type=float, default=default)
        else:
            parser.add_argument(name, type=str, default=default)


def config_from_args(cls: Type[T], args: argparse.Namespace,
                     prefix: str = "") -> T:
    """Build the dataclass from parsed args (unset -> field default)."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if not f.init:
            continue
        v = getattr(args, f"{prefix}{f.name}", None)
        if v is not None:
            kwargs[f.name] = v
    return cls(**kwargs)


def config_echo(cfg: Any, title: str = "") -> str:
    """Render a config the way the reference nodes echoed theirs."""
    lines = [f"=== {title or type(cfg).__name__} ==="]
    for f in dataclasses.fields(cfg):
        lines.append(f"{f.name:<30}: {getattr(cfg, f.name)}")
    return "\n".join(lines)
