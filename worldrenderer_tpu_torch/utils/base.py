"""Config-driven base classes with recursive update-step hooks (PyTorch
counterpart of ``worldrenderer_tpu/utils/base.py``): ``Configurable``,
``Updateable`` and ``BaseObject``. A ``BaseObject`` keeps its learnable
state in ``self.params`` (a dict of arrays or tensors), which the
``weights:`` config entry restores from the npz checkpoint format of
:func:`.misc.save_checkpoint`; an ``nn.Module`` loads the same checkpoints
through :func:`.misc.load_module_weights`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from .config import parse_structured
from .misc import load_module_weights

__all__ = [
    "Configurable",
    "Updateable",
    "BaseObject",
    "update_if_possible",
    "update_end_if_possible",
]


class Configurable:
    @dataclass
    class Config:
        pass

    def __init__(self, cfg: Optional[dict] = None) -> None:
        super().__init__()
        self.cfg = parse_structured(self.Config, cfg)


class Updateable:
    """Recursive per-step update hooks: children first, then self, public
    attributes only.

    Child discovery walks the *instance* dict (``vars``) rather than the
    full attribute surface: in this framework components are always plain
    instance attributes (there is no nn.Module registry populating class
    attributes), so ``vars`` finds exactly the same children without
    triggering property getters. Subclasses with exotic storage can
    override :meth:`updateable_children`.
    """

    def updateable_children(self):
        children = vars(self) if hasattr(self, "__dict__") else {}
        return [
            child
            for name, child in children.items()
            if not name.startswith("_") and isinstance(child, Updateable)
        ]

    def do_update_step(
        self, epoch: int, global_step: int, on_load_weights: bool = False
    ):
        for child in self.updateable_children():
            child.do_update_step(epoch, global_step, on_load_weights=on_load_weights)
        self.update_step(epoch, global_step, on_load_weights=on_load_weights)

    def do_update_step_end(self, epoch: int, global_step: int):
        for child in self.updateable_children():
            child.do_update_step_end(epoch, global_step)
        self.update_step_end(epoch, global_step)

    def update_step(self, epoch: int, global_step: int, on_load_weights: bool = False):
        pass

    def update_step_end(self, epoch: int, global_step: int):
        pass


def update_if_possible(module: Any, epoch: int, global_step: int) -> None:
    if isinstance(module, Updateable):
        module.do_update_step(epoch, global_step)


def update_end_if_possible(module: Any, epoch: int, global_step: int) -> None:
    if isinstance(module, Updateable):
        module.do_update_step_end(epoch, global_step)


class BaseObject(Updateable):
    """Config-parsed object with optional auto weight loading; its state
    is the explicit ``params`` dict."""

    @dataclass
    class Config:
        weights: Optional[str] = None

    cfg: Config

    def __init__(self, cfg: Optional[dict] = None, *args, **kwargs) -> None:
        super().__init__()
        self.cfg = parse_structured(self.Config, cfg)
        self.params: dict = {}
        self.configure(*args, **kwargs)
        weights = getattr(self.cfg, "weights", None)
        if weights is not None:
            # format: path/to/checkpoint.npz:module_name
            if ":" in weights:
                weights_path, module_name = weights.rsplit(":", 1)
            else:
                weights_path, module_name = weights, None
            state, epoch, global_step = load_module_weights(
                weights_path, module_name=module_name
            )
            self.load_state_dict(state)
            self.do_update_step(epoch, global_step, on_load_weights=True)

    def configure(self, *args, **kwargs) -> None:
        pass

    def load_state_dict(self, state: dict) -> None:
        self.params.update(state)

    def state_dict(self) -> dict:
        return dict(self.params)
