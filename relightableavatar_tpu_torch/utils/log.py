"""Colored logging with caller-module prefixes: a copy of
``relightableavatar_tpu/utils/log.py`` for the port (reference
``lib/utils/log_utils.py:87-97``), in plain ANSI."""
from __future__ import annotations

import inspect
import os
import sys
import time
from contextlib import contextmanager

_COLORS = {
    "red": "\033[31m",
    "green": "\033[32m",
    "yellow": "\033[33m",
    "blue": "\033[34m",
    "magenta": "\033[35m",
    "cyan": "\033[36m",
    "reset": "\033[0m",
}

_QUIET = os.environ.get("RA_TPU_QUIET", "0") == "1"


def _caller_prefix() -> str:
    frame = inspect.currentframe()
    # walk out of this module's frames
    for _ in range(2):
        if frame is not None:
            frame = frame.f_back
    if frame is None:
        return ""
    mod = frame.f_globals.get("__name__", "?").split(".")[-1]
    fn = frame.f_code.co_name
    return f"{mod}.{fn}"


def _other_rank() -> bool:
    """True in a process of a multi-GPU launch other than rank 0."""
    dist = sys.modules.get("torch.distributed")
    return (dist is not None and dist.is_available() and dist.is_initialized()
            and dist.get_rank() != 0)


def log(*args, color: str = "blue", **kwargs) -> None:
    """Print to stderr with a colored caller prefix (a last positional
    argument that names a color sets the color).  Under a multi-GPU launch
    only rank 0 prints."""
    if _QUIET or _other_rank():
        return
    args = list(args)
    if len(args) >= 2 and isinstance(args[-1], str) and args[-1] in _COLORS:
        color = args.pop()
    c = _COLORS.get(color, _COLORS["blue"])
    r = _COLORS["reset"]
    prefix = f"{c}{_caller_prefix()}{r}"
    print(f"{prefix}:", *args, **kwargs, file=sys.stderr)


class Timer:
    """Context-manager wall-clock probe."""

    def __init__(self, name: str = "", verbose: bool = False):
        self.name = name
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        if self.verbose:
            log(f"{self.name}: {self.elapsed:.4f}s", color="cyan")
        return False


@contextmanager
def post_mortem_on_crash():
    """Drop into pdb post-mortem on an uncaught exception when attached to a
    terminal (reference run.py:93-98 / train.py:62-66).  Non-interactive
    runs print the traceback and re-raise.  ``RA_TPU_NO_PDB=1`` turns the
    debugger off."""
    try:
        yield
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception:
        import traceback
        traceback.print_exc()
        if sys.stdin.isatty() and os.environ.get('RA_TPU_NO_PDB', '0') != '1':
            import pdb
            pdb.post_mortem()
        raise
