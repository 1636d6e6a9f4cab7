"""Yardstick sources: forms of a kernel that an A/B times beside the
package's own and that the package does not ship, each kept as a patch of
its ``csrc/`` file (text anchors and their replacements), so that a
checkout can rebuild every reading ``PERF.md`` cites. A patch's anchors
must each occur exactly once in the file; the CPU tests hold them to the
current source.

An A/B takes one as ``NAME=yardstick:<module>`` (say
``lead=yardstick:vote_lead`` for ``experiments/tpu_micro.py``).
"""

from __future__ import annotations

import importlib
import pkgutil
from typing import List, Optional

from tpu_pathtracer_torch.ops import _build

PREFIX = "yardstick:"


def names(file: Optional[str] = None) -> List[str]:
    """The yardsticks, by module name; with ``file``, those that patch
    ``csrc/<file>``."""
    out = sorted(m.name for m in pkgutil.iter_modules(__path__))
    return [n for n in out if file is None or patched_file(n) == file]


def patched_file(name: str) -> str:
    """The ``csrc/`` file the yardstick ``name`` patches."""
    return importlib.import_module(f"{__name__}.{name}").FILE


def patch(text: str, patches) -> str:
    """``text`` with each (anchor, replacement) of ``patches`` applied;
    raises unless each anchor occurs exactly once."""
    for old, new in patches:
        n = text.count(old)
        if n != 1:
            raise ValueError(f"a yardstick anchor occurs {n} times, not "
                             f"once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def source(name: str) -> str:
    """The yardstick ``name``'s source: its ``csrc/`` file patched."""
    mod = importlib.import_module(f"{__name__}.{name}")
    return patch((_build.CSRC_DIR / mod.FILE).read_text(), mod.PATCHES)
