"""Weights & Biases glue: a lazy import, so wandb stays an optional dependency.

Copy of ``dmlcloud_tpu/utils/wandb.py``: a module proxy that imports wandb at
the first attribute access, the startup-timeout knob, and the imported and
initialized probes.
"""

from __future__ import annotations

import os
import sys


class WandbModuleWrapper:
    """Proxy object that imports wandb on first attribute access."""

    def _module(self):
        import wandb as _wandb  # deferred: may not be installed

        return _wandb

    def __getattr__(self, name: str):
        return getattr(self._module(), name)

    def __setattr__(self, name: str, value) -> None:
        setattr(self._module(), name, value)


wandb = WandbModuleWrapper()


def wandb_set_startup_timeout(seconds: int) -> None:
    """Raise the wandb service wait (``WANDB__SERVICE_WAIT``): slow shared
    filesystems on clusters routinely exceed the default."""
    if not isinstance(seconds, int) or seconds <= 0:
        raise ValueError("seconds must be a positive int")
    os.environ["WANDB__SERVICE_WAIT"] = str(seconds)


def wandb_is_imported() -> bool:
    return "wandb" in sys.modules


def wandb_is_initialized() -> bool:
    if not wandb_is_imported():
        return False
    import wandb as _wandb

    return _wandb.run is not None
