"""Estimator parameter mixin (counterpart of horovod_tpu/spark/params.py).

Reference: horovod/spark/common/params.py — EstimatorParams/ModelParams
define ~30 pyspark.ml Params with get/set pairs. pyspark.ml's Param
machinery exists to ride Spark's ParamGridBuilder; the estimator here
must work without pyspark installed (the backend is pluggable), so the
same camelCase getter/setter surface is generated over a plain dict.
"""

from __future__ import annotations

from typing import Any, Dict


def _accessor_suffix(name: str) -> str:
    return name[0].upper() + name[1:]


class _ParamBag:
    """get<Name>/set<Name> accessors over a plain dict, preserving the
    pyspark.ml-style API of the reference (params.py get_from_dicts /
    _CamelGetterSetter convention)."""

    _defaults: Dict[str, Any] = {}

    def __init__(self, **kwargs):
        import copy as _copy

        # deepcopy: list defaults (metrics, callbacks) must not alias the
        # class-level dict or one instance's mutation leaks to all.
        self._params: Dict[str, Any] = _copy.deepcopy(self._defaults)
        unknown = set(kwargs) - set(self._defaults)
        if unknown:
            raise ValueError(f"unknown estimator params: {sorted(unknown)}; "
                             f"valid: {sorted(self._defaults)}")
        self._params.update(kwargs)

    def __getattr__(self, attr: str):
        # Only called when normal lookup fails: synthesize accessors.
        if attr.startswith(("get", "set")) and len(attr) > 3:
            name = attr[3].lower() + attr[4:]
            params = object.__getattribute__(self, "_params")
            if name not in params:
                # snake_case params keep pythonic names (num_proc) while
                # accessors stay camel (getNumProc), like the reference.
                import re

                snake = re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()
                if snake in params:
                    name = snake
            if name in params:
                if attr.startswith("get"):
                    return lambda: params[name]

                def setter(value, _name=name):
                    params[_name] = value
                    return self
                return setter
        raise AttributeError(attr)

    def param_dict(self) -> Dict[str, Any]:
        return dict(self._params)

    def copy(self, overrides: Dict[str, Any] = None) -> "_ParamBag":
        import copy as _copy

        new = _copy.copy(self)  # keeps subclass state (e.g. history)
        new._params = dict(self._params)
        if overrides:
            unknown = set(overrides) - set(new._params)
            if unknown:
                raise ValueError(
                    f"unknown params in override: {sorted(unknown)}; "
                    f"valid: {sorted(new._params)}")
            new._params.update(overrides)
        return new


class EstimatorParams(_ParamBag):
    """Reference: params.py EstimatorParams — the training-side knobs."""

    _defaults: Dict[str, Any] = {
        "num_proc": None,
        "backend": None,
        "store": None,
        "model": None,
        "optimizer": None,
        "loss": None,
        "metrics": [],
        "featureCols": None,
        "labelCols": None,
        "sampleWeightCol": None,
        "validation": None,          # float fraction or bool column name
        "batchSize": 32,
        "valBatchSize": None,
        "epochs": 1,
        "trainStepsPerEpoch": None,
        "validationStepsPerEpoch": None,
        "shufflingSeed": None,
        "shuffle": True,
        "callbacks": [],
        "runId": None,
        "verbose": 1,
        "randomSeed": 0,
        "compression": None,
        "gradientPredivideFactor": 1.0,
        "backwardPassesPerStep": 1,
        "useAdasum": False,
    }


class ModelParams(_ParamBag):
    """Reference: params.py ModelParams — the inference-side knobs."""

    _defaults: Dict[str, Any] = {
        "model": None,
        "featureCols": None,
        "labelCols": None,
        "outputCols": None,
        "runId": None,
        "metadata": None,
        "batchSize": 1024,
    }
