"""Yaml config factory for Compressor (ref: contrib/slim/core/config.py).

Same file schema as the reference: named instances under the plugin
sections (pruners/quantizers/distillers/strategies/controllers), each
with a ``class`` key plus constructor kwargs; a ``compressor`` section
with epoch / strategies / optional init_model, checkpoint_path,
eval_epoch; ``include`` pulls in other yaml files. String values naming
another instance are resolved to that instance.

Port of paddle_tpu/fluid/contrib/slim/core/config.py. PyYAML is imported
when a ConfigFactory parses a file, not when the package is imported:
torch does not need it, and a host without it can still build the same
strategies through ``Compressor._add_strategy``.
"""
import collections
import inspect

__all__ = ["ConfigFactory"]

PLUGINS = ("pruners", "quantizers", "distillers", "strategies",
           "controllers")


def _registry():
    """Classes instantiable from config, by name (ref resolves via
    globals() after star-imports; an explicit registry is greppable)."""
    from ..distillation import (
        DistillationStrategy, L2Distiller, SoftLabelDistiller,
    )
    from ..nas import LightNASStrategy
    from ..prune import (
        PruneStrategy, StructurePruner, UniformPruneStrategy,
    )
    from ..quantization import QuantizationStrategy
    from ..searcher import SAController

    classes = {
        c.__name__: c for c in (
            L2Distiller, SoftLabelDistiller, DistillationStrategy,
            StructurePruner, PruneStrategy, UniformPruneStrategy,
            QuantizationStrategy, SAController, LightNASStrategy,
        )
    }
    classes["LightNasStrategy"] = LightNASStrategy  # pre-round-5 spelling
    return classes


class ConfigFactory:
    def __init__(self, config):
        self.instances = {}
        self.compressor = {}
        self.version = None
        self._classes = _registry()
        self._parse_config(config)

    def instance(self, name):
        return self.instances.get(name)

    def _new_instance(self, name, attrs):
        if name in self.instances:
            return self.instances[name]
        cls_name = attrs["class"]
        if cls_name not in self._classes:
            raise ValueError(
                "config class %r unknown (have %s)"
                % (cls_name, sorted(self._classes))
            )
        cls = self._classes[cls_name]
        sig = inspect.signature(cls.__init__)
        keys = set(attrs) & {
            p.name for p in sig.parameters.values()
            if p.kind == p.POSITIONAL_OR_KEYWORD
        }
        kwargs = {}
        for key in keys:
            value = attrs[key]
            if isinstance(value, str) and value.lower() == "none":
                value = None
            if isinstance(value, str) and value in self.instances:
                value = self.instances[value]
            if isinstance(value, list):
                value = [
                    self.instances.get(v, v) if isinstance(v, str) else v
                    for v in value
                ]
            kwargs[key] = value
        self.instances[name] = cls(**kwargs)
        return self.instances[name]

    def _parse_config(self, config):
        import yaml

        with open(config) as f:
            key_values = yaml.load(f, Loader=_ordered_loader(yaml))
        for key, val in key_values.items():
            if key == "version":
                if self.version is None:
                    self.version = int(val)
                elif self.version != int(val):
                    raise ValueError("conflicting config versions")
            elif key in PLUGINS:
                for name, attrs in val.items():
                    self._new_instance(name, attrs)
            elif key == "compressor":
                self.compressor["strategies"] = []
                self.compressor["epoch"] = int(val["epoch"])
                for opt in ("init_model", "checkpoint_path", "eval_epoch"):
                    if opt in val:
                        self.compressor[opt] = val[opt]
                for name in val.get("strategies") or []:
                    strategy = self.instance(name)
                    if strategy is None:
                        raise ValueError(
                            "compressor strategy %r is not defined" % name)
                    self.compressor["strategies"].append(strategy)
            elif key == "include":
                for sub in val:
                    self._parse_config(sub.strip())


def _ordered_loader(yaml):
    """A SafeLoader that keeps each mapping's key order."""
    class _OrderedLoader(yaml.SafeLoader):
        pass

    _OrderedLoader.add_constructor(
        yaml.resolver.BaseResolver.DEFAULT_MAPPING_TAG,
        lambda loader, node: collections.OrderedDict(
            loader.construct_pairs(node)),
    )
    return _OrderedLoader
