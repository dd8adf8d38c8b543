"""Training hook registry: a fixed set of named lifecycle hooks that
loggers and user code register actions on.

The port's own copy of ``desenet_tpu/utils/callbacks.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, List

HOOKS = (
    "on_pretrain_routine_start",
    "on_pretrain_routine_end",
    "on_train_start",
    "on_train_epoch_start",
    "on_train_batch_start",
    "optimizer_step",
    "on_before_zero_grad",
    "on_train_batch_end",
    "on_train_epoch_end",
    "on_val_start",
    "on_val_batch_start",
    "on_val_image_end",
    "on_val_batch_end",
    "on_val_end",
    "on_fit_epoch_end",
    "on_model_save",
    "on_train_end",
    "teardown",
)


def _known(hook: str, actions: dict) -> None:
    if hook not in actions:
        raise KeyError(f"hook '{hook}' not in {list(actions)}")


class Callbacks:
    def __init__(self):
        self._actions: Dict[str, List[dict]] = {h: [] for h in HOOKS}

    def register_action(self, hook: str, name: str = "",
                        callback: Callable = None):
        _known(hook, self._actions)
        if not callable(callback):
            raise TypeError("callback must be callable")
        self._actions[hook].append({"name": name, "callback": callback})

    def get_registered_actions(self, hook: str = None):
        return self._actions[hook] if hook else self._actions

    def run(self, hook: str, *args, **kwargs):
        _known(hook, self._actions)
        for action in self._actions[hook]:
            action["callback"](*args, **kwargs)

    def auto_register(self, obj):
        """Register every method of obj whose name matches a hook."""
        for h in HOOKS:
            fn = getattr(obj, h, None)
            if callable(fn):
                self.register_action(h, name=type(obj).__name__, callback=fn)
