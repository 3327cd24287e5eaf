"""Exception log + protected calls.

The port's own copy of :mod:`signalizer_tpu.utils.exception_log` (behaviour
unchanged, the same log file and ``SIGNALIZER_TPU_LOG_DIR``; tests hold it
equal to the original). Equivalent of cpl's exception-logging surface
(ref: SURVEY.md §2.9/§4 — ``cpl::LogException``,
``GetExceptionLogFilePath``, ``CheckPruneExceptionLogFile``
(MainEditor.cpp:176), and ``cpl/Protected.h``'s SEH/signal-wrapped DSP
calls (PluginProcessor.cpp:33)): a size-pruned, append-only text log of
caught faults, and a wrapper that turns exceptions in embedded DSP/render
paths into logged non-fatal events instead of crashes.

The reference wraps native code in hardware exception handlers; the
python host layer's fault surface is exceptions, so
:func:`protected_call` catches those (and logs device-side RuntimeErrors
like OOMs or compile failures), mirrors them into the assumption
machinery, and returns a fallback.
"""

from __future__ import annotations

import datetime
import os
import threading
import traceback
from pathlib import Path
from typing import Callable, Optional, TypeVar

from signalizer_tpu_torch.utils.diagnostics import logger

T = TypeVar("T")

# ref: CheckPruneExceptionLogFile — bounded log file
MAX_LOG_BYTES = 512 * 1024

_log_path: Optional[Path] = None
_log_lock = threading.Lock()


def get_exception_log_path() -> Path:
    """ref: cpl::GetExceptionLogFilePath. Defaults beside the user's
    presets (override with SIGNALIZER_TPU_LOG_DIR)."""
    global _log_path
    if _log_path is None:
        base = os.environ.get("SIGNALIZER_TPU_LOG_DIR")
        directory = Path(base) if base else Path.home() / ".signalizer_tpu"
        directory.mkdir(parents=True, exist_ok=True)
        _log_path = directory / "exceptions.log"
    return _log_path


def set_exception_log_path(path) -> None:
    global _log_path
    _log_path = Path(path)
    _log_path.parent.mkdir(parents=True, exist_ok=True)


def check_prune_log(max_bytes: int = MAX_LOG_BYTES) -> bool:
    """Halve the log when it outgrows ``max_bytes`` (keep the newest half;
    ref: CheckPruneExceptionLogFile). Returns True when pruned."""
    path = get_exception_log_path()
    try:
        if not path.exists() or path.stat().st_size <= max_bytes:
            return False
        data = path.read_bytes()
        keep = data[-max_bytes // 2 :]  # newest half of the budget
        nl = keep.find(b"\n")
        if nl >= 0:
            keep = keep[nl + 1 :]
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(b"[log pruned]\n" + keep)
        os.replace(tmp, path)
        return True
    except OSError:
        return False


def log_exception(message: str, exc: Optional[BaseException] = None) -> None:
    """ref: cpl::LogException — timestamped append, concurrent-safe
    (the reference's 0.4.2/0.4.3 changelogs fixed concurrent log writes;
    we serialize via a process lock + atomic append)."""
    stamp = datetime.datetime.now().isoformat(timespec="seconds")
    lines = [f"[{stamp}] {message}"]
    if exc is not None:
        lines.append(
            "".join(
                traceback.format_exception(type(exc), exc, exc.__traceback__)
            ).rstrip()
        )
    text = "\n".join(lines) + "\n"
    with _log_lock:
        try:
            with open(get_exception_log_path(), "a", encoding="utf-8") as fh:
                fh.write(text)
            check_prune_log()
        except OSError:
            pass
    logger.error("%s", lines[0])


def protected_call(
    fn: Callable[[], T],
    *,
    fallback: Optional[T] = None,
    context: str = "dsp",
) -> T:
    """Run ``fn``; on any exception, log it (once per distinct message via
    the assumption dedup) and return ``fallback`` instead of crashing the
    host (ref: cpl/Protected.h wrapped processBlock,
    PluginProcessor.cpp:163-174 early-outs)."""
    from signalizer_tpu_torch.utils.diagnostics import assumption

    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — the whole point is containment
        message = f"protected {context} call failed: {type(e).__name__}: {e}"
        log_exception(message, e)
        assumption(False, message)
        return fallback
