"""The program's front doors, one module each, found by the mix's `door`.

A door builds the program, has the configuration's family load its
weights into it (`family.load`, `asrbench/families/`), and serves
requests: `call(req, pcm)` for a closed loop (-> the output), or
`submit(req, pcm)` -> a Future and `result(req, value)` -> the output for
an open loop. `counters()` reads the program's counters, `close()` frees
the program. Its `kind` ("asr" or "align") says how the reference judges
the outputs: an ASR output is the list of served token ids, an
alignment's the classes the aligner produced at every real prompt row.

This module also makes the byte vocabulary the families hand the program.
"""

from __future__ import annotations

import importlib
import re

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load(name: str):
    """The door module asrbench/doors/<name>.py."""
    if not _NAME.match(name) or "." in name:
        raise ValueError(f"bad door name {name!r}")
    return importlib.import_module(f"asrbench.doors.{name}")


def byte_vocab(size: int) -> list[str]:
    """A vocabulary of `size` entries: the 256 bytes in GPT-2's printable
    byte alphabet (entry b is byte b), then fillers "[PADi]"."""
    keep = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    table, extra = {}, 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + extra)
            extra += 1
    return [table[b] for b in range(256)] + [f"[PAD{i}]" for i in range(256, size)]
