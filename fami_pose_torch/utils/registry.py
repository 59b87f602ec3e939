"""Name -> class registry (reference: ``utils/utils_registry.py:14-74``)."""

from typing import Any, Callable, Dict, Iterator, Optional, Tuple


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    def register(self, obj: Optional[Any] = None, name: Optional[str] = None) -> Callable:
        if obj is None:
            # used as a decorator
            def deco(cls_or_fn: Any) -> Any:
                self._do_register(name or cls_or_fn.__name__, cls_or_fn)
                return cls_or_fn

            return deco
        self._do_register(name or obj.__name__, obj)
        return obj

    def _do_register(self, name: str, obj: Any) -> None:
        if name in self._obj_map:
            raise KeyError(f"{name!r} already registered in {self._name} registry")
        self._obj_map[name] = obj

    def get(self, name: str) -> Any:
        if name not in self._obj_map:
            raise KeyError(
                f"{name!r} not found in {self._name} registry. "
                f"Available: {sorted(self._obj_map)}"
            )
        return self._obj_map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def __iter__(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._obj_map.items())

    def keys(self):
        return self._obj_map.keys()


# Global registries (reference: engine/defaults/constant.py:9-11)
MODEL_REGISTRY = Registry("MODEL")
DATASET_REGISTRY = Registry("DATASET")
CORE_FUNCTION_REGISTRY = Registry("CORE_FUNCTION")

TRAIN_PHASE = "train"
VAL_PHASE = "validate"
TEST_PHASE = "test"
INFERENCE_PHASE = "inference"
