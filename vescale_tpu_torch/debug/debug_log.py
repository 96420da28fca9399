"""DebugLogger (reference legacy/vescale/debug/debug_log.py:40): per-rank
operation and communication logging gated by ``VESCALE_DEBUG_MODE``.

The port's copy of ``vescale_tpu/debug/debug_log.py``."""

from __future__ import annotations

import sys
import time
from typing import Any, Optional

__all__ = ["DebugLogger"]


class DebugLogger:
    """Env-gated structured logger.  ``VESCALE_DEBUG_MODE=1`` logs every
    record; ``VESCALE_DEBUG_MODE=rank0,rank1,...`` restricts ranks."""

    rank: int = 0
    _enabled: Optional[bool] = None
    _ranks: Optional[set] = None
    _stream = sys.stderr

    @classmethod
    def enabled(cls) -> bool:
        if cls._enabled is None:
            from .. import config

            v = config.get_str("VESCALE_DEBUG_MODE") or ""
            if not v or v == "0":
                cls._enabled, cls._ranks = False, None
            elif v == "1":
                cls._enabled, cls._ranks = True, None
            else:
                cls._enabled = True
                cls._ranks = {int(x) for x in v.replace("rank", "").split(",")
                              if x.strip().isdigit()}
        return cls._enabled

    @classmethod
    def update_vescale_debug_mode_from_env(cls) -> None:
        cls._enabled = None

    @classmethod
    def log(cls, category: str, *parts: Any) -> None:
        if not cls.enabled():
            return
        if cls._ranks is not None and cls.rank not in cls._ranks:
            return
        msg = " ".join(str(p) for p in parts)
        print(f"[vescale_tpu_torch:{category}:r{cls.rank}:{time.time():.3f}] {msg}",
              file=cls._stream)

    @classmethod
    def log_communication(cls, op: str, *detail: Any) -> None:
        """(reference _CommunicationLogger:141)"""
        cls.log("comm", op, *detail)

    @classmethod
    def log_operator(cls, op: str, *detail: Any) -> None:
        """(reference _OperatorLogger:231)"""
        cls.log("op", op, *detail)
