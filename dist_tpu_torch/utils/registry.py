"""String -> object registry (reference utils/registry.py:6-66).

Used for models / backbones / heads / stems / branches / datasets /
losses / transforms so that YAML configs can name implementations.
"""


class Registry:
    def __init__(self, name):
        self._name = name
        self._obj_map = {}

    def _do_register(self, name, obj):
        if name in self._obj_map:
            raise KeyError(
                f"An object named '{name}' was already registered in "
                f"'{self._name}' registry!"
            )
        self._obj_map[name] = obj

    def register(self, obj=None, name=None):
        """Decorator (``@REG.register()``) or function-call registration."""
        if obj is None:
            def deco(func_or_class):
                self._do_register(name or func_or_class.__name__, func_or_class)
                return func_or_class
            return deco
        self._do_register(name or obj.__name__, obj)
        return obj

    def get(self, name):
        """Returns None for missing names (the reference's builders use the
        None return to fall back to default assemblies,
        models/base/builder.py:30-32)."""
        return self._obj_map.get(name)

    def get_strict(self, name):
        ret = self._obj_map.get(name)
        if ret is None:
            raise KeyError(f"No object named '{name}' in '{self._name}' registry "
                           f"(have: {sorted(self._obj_map)})")
        return ret

    def keys(self):
        return list(self._obj_map.keys())

    def __contains__(self, name):
        return name in self._obj_map
