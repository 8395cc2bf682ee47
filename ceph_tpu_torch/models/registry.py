"""Plugin registry — port of ``ceph_tpu/models/registry.py``
(``ErasureCodePluginRegistry``, src/erasure-code/ErasureCodePlugin.{h,cc}).

A plugin is a module that must

- expose ``__erasure_code_version__`` matching :data:`PLUGIN_VERSION`
  (version check at the reference's ErasureCodePlugin.cc:144),
- expose ``__erasure_code_init__(name, registry)`` (entry-point lookup at
  :151) which must call ``registry.add(name, plugin)``.

Built-in plugins resolve to ``ceph_tpu_torch.models.<name>`` (the
reference's external plugin directories are not ported). The loader's
failure modes (unknown plugin, missing entry point, version mismatch, init
failure, init-forgets-to-register) raise :class:`PluginLoadError`.

``factory`` takes the torch ``device`` the codec's matvec runs on.
"""

from __future__ import annotations

import importlib
import threading
from abc import ABC, abstractmethod

from ceph_tpu_torch.models.interface import (
    ErasureCodeError,
    ErasureCodeInterface,
)

#: bumped when the plugin ABI changes
PLUGIN_VERSION = "ceph-tpu-torch-plugin-1"

#: built-in plugin name -> module
_BUILTIN_MODULES = {
    "jerasure": "ceph_tpu_torch.models.jerasure",
    "isa": "ceph_tpu_torch.models.isa",
}


class PluginLoadError(ErasureCodeError):
    pass


class ErasureCodePlugin(ABC):
    """A factory for codec instances (reference: ErasureCodePlugin.h:31-43)."""

    @abstractmethod
    def factory(self, profile: dict, device) -> ErasureCodeInterface:
        """Instantiate and init() a codec for the profile on ``device``."""


class ErasureCodePluginRegistry:
    """Singleton name -> plugin map with lazy loading
    (reference: ErasureCodePlugin.h:45-79)."""

    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._plugins: dict[str, ErasureCodePlugin] = {}

    @classmethod
    def instance(cls) -> "ErasureCodePluginRegistry":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def add(self, name: str, plugin: ErasureCodePlugin) -> None:
        with self._lock:
            if name in self._plugins:
                raise PluginLoadError(f"plugin {name!r} already registered",
                                      errno_=17)
            self._plugins[name] = plugin

    def load(self, name: str) -> ErasureCodePlugin:
        """Load plugin ``name``; mirrors ErasureCodePlugin.cc:126-184."""
        with self._lock:
            if name in self._plugins:
                return self._plugins[name]
            module = self._import_plugin_module(name)
            version = getattr(module, "__erasure_code_version__", None)
            if version is None:
                raise PluginLoadError(
                    f"plugin {name!r} has no __erasure_code_version__")
            if version != PLUGIN_VERSION:
                raise PluginLoadError(
                    f"plugin {name!r} version {version!r} != expected "
                    f"{PLUGIN_VERSION!r}", errno_=95)
            init = getattr(module, "__erasure_code_init__", None)
            if init is None:
                raise PluginLoadError(
                    f"plugin {name!r} has no __erasure_code_init__ entry point")
            try:
                init(name, self)
            except PluginLoadError:
                raise
            except Exception as exc:
                raise PluginLoadError(
                    f"plugin {name!r} init failed: {exc!r}") from exc
            if name not in self._plugins:
                raise PluginLoadError(
                    f"plugin {name!r} init() did not register itself",
                    errno_=98)
            return self._plugins[name]

    @staticmethod
    def _import_plugin_module(name: str):
        modname = _BUILTIN_MODULES.get(name)
        if modname is None:
            raise PluginLoadError(f"unknown plugin {name!r}", errno_=2)
        try:
            return importlib.import_module(modname)
        except ImportError as exc:
            raise PluginLoadError(
                f"plugin module {modname} failed to import: {exc!r}") from exc

    def factory(self, plugin_name: str, profile: dict,
                device="cuda") -> ErasureCodeInterface:
        """Resolve plugin, instantiate codec on ``device``, init with
        profile (reference: ErasureCodePlugin.cc:92-120)."""
        plugin = self.load(plugin_name)
        return plugin.factory(dict(profile), device)


def instance() -> ErasureCodePluginRegistry:
    return ErasureCodePluginRegistry.instance()
