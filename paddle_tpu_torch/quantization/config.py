"""QuantConfig: which layers are quantized and with what quanters
(counterpart: ``paddle_tpu/quantization/config.py``). ``add_layer_config``
(by instance), ``add_name_config`` (by qualified name),
``add_type_config`` (by class) and a global default; a layer's config
resolves instance > name > type > global."""
from __future__ import annotations

__all__ = ["QuantConfig"]


class _SingleConfig:
    def __init__(self, activation=None, weight=None):
        self.activation = activation
        self.weight = weight


class QuantConfig:
    def __init__(self, activation=None, weight=None):
        self._global = _SingleConfig(activation, weight)
        self._by_layer = {}    # id(layer) -> _SingleConfig
        self._by_name = {}     # qualified layer name -> _SingleConfig
        self._by_type = {}     # class -> _SingleConfig

    def add_layer_config(self, layer, activation=None, weight=None):
        layers = layer if isinstance(layer, (list, tuple)) else [layer]
        for lay in layers:
            self._by_layer[id(lay)] = _SingleConfig(activation, weight)

    def add_name_config(self, name, activation=None, weight=None):
        names = name if isinstance(name, (list, tuple)) else [name]
        for n in names:
            self._by_name[n] = _SingleConfig(activation, weight)

    def add_type_config(self, layer_type, activation=None, weight=None):
        types = (layer_type if isinstance(layer_type, (list, tuple))
                 else [layer_type])
        for t in types:
            self._by_type[t] = _SingleConfig(activation, weight)

    def _get_config_by_layer(self, layer, name=""):
        if id(layer) in self._by_layer:
            return self._by_layer[id(layer)]
        if name and name in self._by_name:
            return self._by_name[name]
        for t, cfg in self._by_type.items():
            if isinstance(layer, t):
                return cfg
        if self._global.activation or self._global.weight:
            return self._global
        return None
