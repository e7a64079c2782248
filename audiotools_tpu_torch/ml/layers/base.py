"""BaseModel: save and load a model with its constructor arguments and,
optionally, the source of its defining module.

Counterpart of ``audiotools_tpu/ml/layers/base.py``. A ``torch.nn.Module``
has no dataclass fields, so the arguments a subclass was constructed with
are recorded when it is constructed (every argument of its ``__init__``,
defaults included). The blob is a ``torch.save`` pickle of the class name
and module, the metadata (with the constructor kwargs), the weights as a
``state_dict`` on the host and, with ``package=True``, the source of the
defining module, from which ``load`` re-materializes the class where its
import path does not exist.
"""
import importlib
import inspect
import sys
import types
import typing
from pathlib import Path

import torch
from torch import nn

from ...core import util

__all__ = ["BaseModel"]


def _host(obj):
    """``obj`` with every tensor inside dicts, lists and tuples on the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


class _RecordsKwargs(type(nn.Module)):
    """Records the arguments of the outermost constructor call as
    ``model._init_kwargs``."""

    def __call__(cls, *args, **kwargs):
        model = super().__call__(*args, **kwargs)
        bound = inspect.signature(cls.__init__).bind(model, *args, **kwargs)
        bound.apply_defaults()
        params = inspect.signature(cls.__init__).parameters
        recorded = {}
        for name, value in list(bound.arguments.items())[1:]:
            kind = params[name].kind
            if kind == inspect.Parameter.VAR_KEYWORD:
                recorded.update(value)
            elif kind != inspect.Parameter.VAR_POSITIONAL:
                recorded[name] = value
        model._init_kwargs = recorded
        return model


class BaseModel(nn.Module, metaclass=_RecordsKwargs):
    """An ``nn.Module`` with portable save and load.

    >>> class Model(BaseModel):
    ...     def __init__(self, hidden: int = 8):
    ...         super().__init__()
    ...         self.layer = nn.Linear(5, hidden)
    >>> model = Model(hidden=3)
    >>> model.save("model.pth")
    >>> model2 = Model.load("model.pth", device="cpu")
    """

    def save(self, path, metadata: dict = None, package: bool = True):
        """Save the constructor kwargs and weights (and, with ``package``,
        the defining module's source) to ``path``."""
        metadata = {} if metadata is None else dict(metadata)
        metadata["kwargs"] = dict(getattr(self, "_init_kwargs", {}))
        blob = {
            "class_name": type(self).__name__,
            "class_module": type(self).__module__,
            "metadata": metadata,
            "state_dict": _host(self.state_dict()),
        }
        if package:
            try:
                blob["source"] = inspect.getsource(sys.modules[type(self).__module__])
            except (OSError, TypeError, KeyError):
                blob["source"] = None
        torch.save(blob, path)
        return path

    @classmethod
    def load(cls, location, *args, package_name: str = None, strict: bool = False,
             device=None, **kwargs):
        """The model saved at ``location``, on ``device`` (the card unless
        told ``"cpu"``). Saved kwargs are updated by ``kwargs`` and filtered
        to the constructor's signature. If the class cannot be found on the
        import path and source was packaged, the source is executed to
        re-materialize it. ``package_name`` is accepted for the JAX
        package's signature and unused, as there."""
        blob = torch.load(location, map_location="cpu", weights_only=False)
        metadata = blob["metadata"]
        metadata["kwargs"].update(kwargs)

        model_cls = cls
        if cls is BaseModel or cls.__name__ != blob["class_name"]:
            model_cls = _resolve_class(blob) or cls

        valid = inspect.signature(model_cls.__init__).parameters
        ctor_kwargs = {k: v for k, v in metadata["kwargs"].items() if k in valid}
        model = model_cls(*args, **ctor_kwargs)
        model.load_state_dict(blob["state_dict"], strict=strict)
        model.metadata = metadata
        return model.to(util.default_device() if device is None else device)

    @property
    def device(self) -> torch.device:
        """Device of the first parameter (or buffer); the card when the
        model holds neither."""
        for tensor in (*self.parameters(), *self.buffers()):
            return tensor.device
        return util.default_device()

    def save_to_folder(self, folder: typing.Union[str, Path], extra_data: dict = None,
                       package: bool = True):
        """Save the model as ``package.pth`` (with ``package``) and
        ``weights.pth`` under ``folder/<classname>/``, and each entry of
        ``extra_data`` as its own file there."""
        target_base = Path(folder) / type(self).__name__.lower()
        target_base.mkdir(exist_ok=True, parents=True)
        if package:
            self.save(target_base / "package.pth", package=True)
        self.save(target_base / "weights.pth", package=False)
        for path, obj in (extra_data or {}).items():
            torch.save(_host(obj), target_base / path)
        return target_base

    @classmethod
    def load_from_folder(cls, folder: typing.Union[str, Path], package: bool = True,
                         strict: bool = False, device=None, **kwargs):
        """``(model, extra_data)`` from a :meth:`save_to_folder` layout."""
        folder = Path(folder) / cls.__name__.lower()
        model = cls.load(folder / ("package.pth" if package else "weights.pth"),
                         strict=strict, device=device, **kwargs)
        reserved = {"package.pth", "weights.pth"}
        extra_data = {}
        for item in sorted(folder.glob("*")):
            if item.is_file() and item.name not in reserved:
                extra_data[item.name] = torch.load(item, map_location="cpu", weights_only=False)
        return model, extra_data


def _resolve_class(blob):
    """The model class: its import path first, then the packaged source
    (run as a module of the original package, so relative imports of
    modules that still exist resolve)."""
    try:
        return getattr(importlib.import_module(blob["class_module"]), blob["class_name"])
    except (ImportError, AttributeError):
        pass
    source = blob.get("source")
    if source is None:
        return None
    mod = types.ModuleType(f"_audiotools_tpu_torch_packaged_{blob['class_name']}")
    mod.__package__ = blob["class_module"].rpartition(".")[0]
    exec(compile(source, mod.__name__, "exec"), mod.__dict__)
    return getattr(mod, blob["class_name"], None)
