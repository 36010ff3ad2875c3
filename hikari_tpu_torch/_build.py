"""Build native shared libraries at first use.

Sources are compiled into ``hikari_tpu_torch/build/`` (listed in
``.gitignore``) under a name that carries a hash of the source, of the
headers beside it and of the compiler command, so an edited source or
header is rebuilt and a stale library is never loaded. The output is
written to a temporary name and renamed into place, so concurrent first
uses do not see a half-written file.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "build"


def source_digest(source: Path, command: list[str]) -> str:
    """Hash of `source`, of every header (``*.cuh``) in its directory, which
    it may include, and of the compiler command."""
    h = hashlib.sha256()
    for path in [source, *sorted(source.parent.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(command).encode())
    return h.hexdigest()[:12]


def build_shared_library(name: str, source: Path, command: list[str],
                         timeout: float = 600.0) -> Path:
    """Compile `source` with `command` (compiler and flags, without the
    output and input paths) into lib<name>_<hash>.so; return its path.
    Raises subprocess.CalledProcessError (with the compiler's output in
    .stderr), OSError or subprocess.TimeoutExpired on failure."""
    digest = source_digest(source, command)
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([*command, "-o", str(tmp), str(source)], check=True,
                       capture_output=True, text=True, timeout=timeout)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out
