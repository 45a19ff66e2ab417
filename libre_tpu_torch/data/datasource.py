"""DataSource facade and plugin registry.

Reference: livre/core/data/DataSource.{h,cpp} (pimpl facade over a DSO
plugin factory selected by ``handles(uri)``) and DataSourcePlugin.{h,cpp}.
Here plugins are plain Python classes registered by module import — the
TPU-native framework keeps the same URI-scheme dispatch
(``mem://``, ``raw://``, ``lod://``) without dynamic shared objects.

Brick array convention: ``get_data`` returns the *padded* brick (interior
block + 2×overlap ghost voxels per axis) as a numpy array of shape
``(Z, Y, X)`` — x fastest-varying, matching raw-file and GL texture layout
(TextureObject.cpp glTexSubImage3D upload order).
"""

from __future__ import annotations

import threading
import urllib.parse
from typing import Callable, Dict, List, Optional, Tuple, Type

import numpy as np

from libre_tpu_torch.core.lodnode import LODNode, regular_lod_node
from libre_tpu_torch.core.nodeid import NodeId
from libre_tpu_torch.core.volume_info import VolumeInformation

_REGISTRY: List[Type["DataSourcePlugin"]] = []


def register_datasource(cls: Type["DataSourcePlugin"]) -> Type["DataSourcePlugin"]:
    """Class decorator: register a plugin (PluginRegisterer equivalent,
    livre/core/util/PluginRegisterer.h)."""
    _REGISTRY.append(cls)
    return cls


class ParsedURI:
    """Minimal URI splitter: scheme://path?query#fragment."""

    def __init__(self, uri: str):
        self.raw = uri
        parsed = urllib.parse.urlparse(uri)
        self.scheme = parsed.scheme
        # For scheme://host/path URIs keep host+path as a filesystem path.
        path = parsed.path
        if parsed.netloc:
            path = parsed.netloc + path
        self.path = path
        self.fragment = parsed.fragment
        self.query: Dict[str, str] = dict(urllib.parse.parse_qsl(parsed.query))
        # Accept query parameters that trail the fragment
        # ("mem://#64,64,64,32?datatype=float").
        if "?" in self.fragment:
            self.fragment, _, frag_query = self.fragment.partition("?")
            self.query.update(dict(urllib.parse.parse_qsl(frag_query)))


class DataSourcePlugin:
    """Plugin base (livre/core/data/DataSourcePlugin.h).

    Subclasses set ``self.volume_info`` in ``__init__`` and implement
    ``get_data(lod_node)``.  ``get_node`` memoizes NodeId→LODNode placement
    (DataSourcePlugin.cpp:29-48), defaulting to the regular-grid layout.
    """

    def __init__(self):
        self.volume_info = VolumeInformation()
        self._node_cache: Dict[int, LODNode] = {}
        self._node_lock = threading.Lock()

    @staticmethod
    def handles(uri: ParsedURI) -> bool:
        raise NotImplementedError

    def get_node(self, node_id: NodeId) -> LODNode:
        key = node_id.id
        node = self._node_cache.get(key)
        if node is None:
            with self._node_lock:
                node = self._node_cache.get(key)
                if node is None:
                    node = self.internal_node_to_lod_node(node_id)
                    self._node_cache[key] = node
        return node

    def internal_node_to_lod_node(self, node_id: NodeId) -> LODNode:
        return regular_lod_node(node_id, self.volume_info)

    def get_data(self, lod_node: LODNode) -> np.ndarray:
        """Return the padded brick, shape (Z, Y, X), native dtype."""
        raise NotImplementedError

    def get_data_batch(self, lod_nodes: List[LODNode]) -> List[np.ndarray]:
        """Batch brick fetch; plugins with fast parallel IO (native
        brickio) override this — the default is serial ``get_data``."""
        return [self.get_data(n) for n in lod_nodes]

    def update(self) -> bool:
        """Streaming sources may refresh metadata; returns True on change."""
        return False

    def finish(self) -> None:
        pass


class DataSource:
    """Facade dispatching a URI to the handling plugin (DataSource.h:38-93)."""

    def __init__(self, uri: str, **kwargs):
        parsed = ParsedURI(uri)
        for plugin_cls in _REGISTRY:
            if plugin_cls.handles(parsed):
                self._plugin = plugin_cls(parsed, **kwargs)
                break
        else:
            raise ValueError(
                f"no datasource plugin handles {uri!r} "
                f"(registered schemes: {[c.__name__ for c in _REGISTRY]})"
            )
        self.uri = uri

    @property
    def volume_info(self) -> VolumeInformation:
        return self._plugin.volume_info

    def get_node(self, node_id: NodeId) -> LODNode:
        return self._plugin.get_node(node_id)

    def get_data(self, node: NodeId | LODNode) -> np.ndarray:
        if isinstance(node, NodeId):
            node = self.get_node(node)
        return self._plugin.get_data(node)

    def get_data_batch(self, nodes) -> List[np.ndarray]:
        lod_nodes = [
            self.get_node(n) if isinstance(n, NodeId) else n for n in nodes
        ]
        return self._plugin.get_data_batch(lod_nodes)

    def update(self) -> bool:
        return self._plugin.update()

    def finish(self) -> None:
        self._plugin.finish()


def load_plugins() -> None:
    """Import all built-in plugins (DataSource::loadPlugins equivalent)."""
    from libre_tpu_torch.data import memory, raw, lod_store, uvf  # noqa: F401
