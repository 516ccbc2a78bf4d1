"""Atomic JSON artifact writing for validation/bench evidence files.

An evidence file was once committed as a 0-byte file while documents cited
it.  Every artifact writer goes through :func:`write_json_artifact`, which
serializes first,
refuses empty payloads, writes to a temp file in the same directory, fsyncs,
and renames into place — an interrupted run can no longer leave a truncated
or empty artifact behind.
"""
from __future__ import annotations

import json
import os
import tempfile


def write_json_artifact(path: str | os.PathLike, obj, indent: int = 1) -> str:
    """Serialize ``obj`` to JSON and atomically write it at ``path``.

    Raises ``ValueError`` on payloads that would serialize to nothing
    (None / empty dict / empty list / empty string) instead of committing
    an evidence-free file.  Returns the serialized text."""
    if obj is None or obj == {} or obj == [] or obj == "":
        raise ValueError(
            f"refusing to write empty artifact {os.fspath(path)!r}: "
            f"payload is {obj!r}"
        )
    text = json.dumps(obj, indent=indent)
    if not text.strip():
        raise ValueError(f"refusing to write blank artifact {os.fspath(path)!r}")
    path = os.fspath(path)
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".artifact_", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            fh.write(text + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return text
