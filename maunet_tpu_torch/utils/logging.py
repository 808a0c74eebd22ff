"""Stdlib logging with a ``success`` level.

The port's copy of ``maunet_tpu/utils/logging.py`` (the reference logs
through loguru, whose vocabulary has SUCCESS).  ``get_logger`` names every
logger under ``maunet_tpu_torch`` and gives it a ``success`` method.  It
installs no handler and leaves propagation on: where the messages go is the
entry point's choice (``cli.main`` calls ``logging.basicConfig``), so the
port's loggers behave as its other ``logging.getLogger(__name__)`` ones do.
"""

from __future__ import annotations

import logging

SUCCESS = 25
logging.addLevelName(SUCCESS, "SUCCESS")


class _Logger(logging.Logger):
    def success(self, msg, *args, **kwargs):
        if self.isEnabledFor(SUCCESS):
            self._log(SUCCESS, msg, args, **kwargs)


def get_logger(name: str) -> _Logger:
    if not name.startswith("maunet_tpu_torch"):
        name = f"maunet_tpu_torch.{name}"
    logger = logging.getLogger(name)
    if not hasattr(logger, "success"):
        # Made by another logger class: the subclass adds a method, no state.
        logger.__class__ = _Logger
    return logger
