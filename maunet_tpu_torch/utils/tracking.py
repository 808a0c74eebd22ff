"""Optional experiment-tracker sinks.

A copy of ``maunet_tpu/utils/tracking.py`` (reference src/train.py:111-153),
carried because ``maunet_tpu`` imports JAX.  Tracking is a pluggable sink
protocol: the CSV step log is always on (``train.metrics``), and W&B attaches
only where the package is installed.
"""

from __future__ import annotations

import logging
from typing import Any, Protocol

log = logging.getLogger(__name__)


class Tracker(Protocol):
    def log(self, row: dict[str, Any], step: int | None = None) -> None: ...
    def log_image(self, key: str, image_path: str,
                  step: int | None = None) -> None: ...
    def log_table(self, key: str, dataframe: Any,
                  step: int | None = None) -> None: ...
    def finish(self) -> None: ...


class NullTracker:
    def log(self, row, step=None):
        pass

    def log_image(self, key, image_path, step=None):
        pass

    def log_table(self, key, dataframe, step=None):
        pass

    def finish(self):
        pass


class WandbTracker:
    """W&B sink (reference run naming and tags, src/train.py:142-153; images,
    src/train.py:266-280; tables, test/evaluate.py:314-359).  A no-op where
    wandb is not installed."""

    def __init__(self, project: str | None = None, group: str | None = None,
                 name: str | None = None, config: dict | None = None,
                 tags: list[str] | None = None):
        try:
            import wandb
        except ImportError:
            log.warning("wandb not installed: tracking disabled.")
            self._run = None
            return
        self._run = wandb.init(project=project, group=group, name=name,
                               config=config, tags=tags, reinit=True)

    def log(self, row, step=None):
        if self._run is not None:
            self._run.log(row, step=step)

    def log_image(self, key, image_path, step=None):
        if self._run is not None:
            import wandb

            self._run.log({key: wandb.Image(image_path)}, step=step)

    def log_table(self, key, dataframe, step=None):
        if self._run is not None:
            import wandb

            self._run.log({key: wandb.Table(dataframe=dataframe)}, step=step)

    def finish(self):
        if self._run is not None:
            self._run.finish()


def make_emb_tag(temporal: bool, metadata: bool) -> str:
    """Study-name embedding suffix (reference src/train.py:79-87)."""
    if temporal and metadata:
        return "emb"
    if temporal:
        return "tempemb"
    if metadata:
        return "metaemb"
    return "noemb"
