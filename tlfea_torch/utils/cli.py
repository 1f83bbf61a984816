"""Typed `--key=value` command-line registry with defaults and help (port
of `tlfea/utils/cli.py`, the reference's `Cli` helper)."""

from __future__ import annotations

import sys

__all__ = ["Cli"]


class Cli:
    def __init__(self, description: str = ""):
        self.description = description
        self._opts: dict[str, tuple[type, object, str]] = {}

    def add(self, name: str, default, help: str = ""):
        self._opts[name] = (type(default), default, help)
        return self

    def parse(self, argv=None) -> dict:
        argv = sys.argv[1:] if argv is None else argv
        out = {k: v for k, (_, v, _) in self._opts.items()}
        for arg in argv:
            if arg in ("-h", "--help"):
                self.print_help()
                sys.exit(0)
            if not arg.startswith("--") or "=" not in arg:
                raise SystemExit(f"bad argument {arg!r}; use --key=value (see --help)")
            key, val = arg[2:].split("=", 1)
            if key not in self._opts:
                raise SystemExit(f"unknown option --{key} (see --help)")
            ty = self._opts[key][0]
            if ty is bool:
                out[key] = val.lower() in ("1", "true", "yes", "on")
            else:
                out[key] = ty(val)
        return out

    def print_help(self):
        print(self.description)
        for name, (ty, default, help_) in self._opts.items():
            print(f"  --{name}={default!r:<12} ({ty.__name__})  {help_}")
