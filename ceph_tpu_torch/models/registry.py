"""Plugin registry — port of ``ceph_tpu/models/registry.py``
(``ErasureCodePluginRegistry``, src/erasure-code/ErasureCodePlugin.{h,cc}).

A plugin is a module that must

- expose ``__erasure_code_version__`` matching :data:`PLUGIN_VERSION`
  (version check at the reference's ErasureCodePlugin.cc:144),
- expose ``__erasure_code_init__(name, registry)`` (entry-point lookup at
  :151) which must call ``registry.add(name, plugin)``.

Built-in plugins resolve to ``ceph_tpu_torch.models.<name>``; external
plugin directories (the reference's ``erasure_code_dir``) are searched for
``ec_<name>.py`` files loaded through importlib. The loader's failure modes
(unknown plugin or missing file, missing entry point, version mismatch,
init failure, init-forgets-to-register) raise :class:`PluginLoadError`.
:meth:`ErasureCodePluginRegistry.preload` loads the plugins named by
``osd_erasure_code_plugins`` at daemon start.

``factory`` takes the torch ``device`` the codec's matvec runs on.
"""

from __future__ import annotations

import importlib
import importlib.util
import threading
from abc import ABC, abstractmethod
from pathlib import Path

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
    "shec": "ceph_tpu_torch.models.shec",
    "clay": "ceph_tpu_torch.models.clay",
    "example": "ceph_tpu_torch.models.example_xor",
    "lrc": "ceph_tpu_torch.models.lrc",
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

    def get(self, name: str) -> ErasureCodePlugin | None:
        with self._lock:
            return self._plugins.get(name)

    def load(self, name: str, directory: str | None = None
             ) -> ErasureCodePlugin:
        """Load plugin ``name``, from ``directory``'s ``ec_<name>.py`` when
        given; mirrors ErasureCodePlugin.cc:126-184."""
        with self._lock:
            if name in self._plugins:
                return self._plugins[name]
            module = self._import_plugin_module(name, directory)
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
    def _import_plugin_module(name: str, directory: str | None = None):
        if directory:
            path = Path(directory) / f"ec_{name}.py"
            if not path.exists():
                raise PluginLoadError(
                    f"no plugin file {path} for {name!r}", errno_=2)
            spec = importlib.util.spec_from_file_location(
                f"ceph_tpu_torch_ext_plugin_{name}", path)
            module = importlib.util.module_from_spec(spec)
            try:
                spec.loader.exec_module(module)
            except Exception as exc:
                raise PluginLoadError(
                    f"plugin file {path} failed to import: {exc!r}") from exc
            return module
        modname = _BUILTIN_MODULES.get(name)
        if modname is None:
            raise PluginLoadError(f"unknown plugin {name!r}", errno_=2)
        try:
            return importlib.import_module(modname)
        except ImportError as exc:
            raise PluginLoadError(
                f"plugin module {modname} failed to import: {exc!r}") from exc

    def factory(self, plugin_name: str, profile: dict,
                device="cuda", directory: str | None = None
                ) -> ErasureCodeInterface:
        """Resolve plugin, instantiate codec on ``device``, init with
        profile (reference: ErasureCodePlugin.cc:92-120)."""
        plugin = self.load(plugin_name, directory)
        return plugin.factory(dict(profile), device)

    def preload(self, names: list[str] | None = None,
                directory: str | None = None) -> None:
        """Preload plugins at daemon start (reference: config
        osd_erasure_code_plugins, ErasureCodePlugin.cc:186-202).
        ``names`` defaults to the ``osd_erasure_code_plugins``
        option, whitespace-separated as in the reference."""
        if names is None:
            from ceph_tpu_torch.utils.config import g_conf
            names = g_conf()["osd_erasure_code_plugins"].split()
        for name in names:
            self.load(name, directory)


def instance() -> ErasureCodePluginRegistry:
    return ErasureCodePluginRegistry.instance()
