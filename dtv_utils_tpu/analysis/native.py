"""Build + invoke the native (C++) analyzer tools under native/.

The stream analyzers in the reference are inherently sequential bit parsers
(/root/reference/xport.c, flags264.c, l1dump.c, h264_parse/) — the wrong
shape for an accelerator — so, like the reference, they are native code here
(SURVEY.md §7 step 8).  This module lazily builds them with make on first
use and exposes subprocess runners for the CLI and tests.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = NATIVE_DIR / "build"

_built = False


def ensure_built() -> pathlib.Path:
    """Run make once per process; returns the build directory."""
    global _built
    if not _built:
        proc = subprocess.run(["make", "-s", "-C", str(NATIVE_DIR)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native build failed:\n{proc.stdout}\n{proc.stderr}")
        _built = True
    return BUILD_DIR


def tool_path(name: str) -> pathlib.Path:
    path = ensure_built() / name
    if not path.exists():
        raise FileNotFoundError(f"native tool not built: {name}")
    return path


def run(name: str, args: list[str], **kwargs) -> subprocess.CompletedProcess:
    return subprocess.run([str(tool_path(name))] + args, **kwargs)


def cli(name: str, argv: list[str]) -> int:
    """CLI passthrough: stdout/stderr inherit the parent terminal."""
    try:
        proc = run(name, argv)
    except (RuntimeError, FileNotFoundError) as e:
        print(e, file=sys.stderr)
        return 255
    return proc.returncode & 0xFF
