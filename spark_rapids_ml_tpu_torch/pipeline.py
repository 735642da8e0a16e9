#
# Pipeline / PipelineModel: the pyspark.ml.Pipeline contract for chaining
# this package's estimators and transformers without a Spark session. The
# port's own copy of spark_rapids_ml_tpu/pipeline.py: fit chains stage by
# stage, transformers pass through, the fitted PipelineModel transforms in
# sequence and persists like CrossValidatorModel (a composite directory
# restored by class dispatch, `core.load_instance`).
#
from __future__ import annotations

from typing import Any, List, Optional

from .params import Params


def _is_estimator(stage: Any) -> bool:
    return hasattr(stage, "fit")


class Pipeline(Params):
    """Chain of stages; estimators are fit on the running transform of the
    input, transformers (fitted models) are applied as-is (pyspark.ml
    semantics: a transformer stage transforms the data seen by later
    stages).

    >>> model = Pipeline(stages=[pca, lr]).fit(df)
    >>> out = model.transform(df)
    """

    def __init__(self, stages: Optional[List[Any]] = None) -> None:
        super().__init__()
        self._stages: List[Any] = list(stages or [])

    def getStages(self) -> List[Any]:
        return self._stages

    def setStages(self, value: List[Any]) -> "Pipeline":
        self._stages = list(value)
        return self

    def copy(self, extra: Optional[dict] = None) -> "Pipeline":
        """Copy with `extra` param overrides routed to the stage that owns
        each param — this is what lets CrossValidator / TrainValidationSplit
        sweep a stage's params through the fallback fit-per-model path.

        Param objects here are per-NAME singletons (mixin class attributes),
        so a name carried by MORE THAN ONE stage cannot identify its target:
        that case raises instead of silently re-tuning every matching stage
        (pyspark disambiguates via per-instance parent uids; this framework
        keeps the simpler Param model and makes the ambiguity loud)."""
        extra = dict(extra or {})
        routable = [
            s if (hasattr(s, "copy") and hasattr(s, "hasParam")) else None
            for s in self._stages
        ]
        per_stage: List[dict] = [{} for _ in self._stages]
        for p, v in extra.items():
            name = getattr(p, "name", str(p))
            owners = [i for i, s in enumerate(routable) if s is not None and s.hasParam(name)]
            if not owners:
                # silently dropping a no-owner param would let a typo'd key in
                # a CV/TVS grid train identical models — as loud as the
                # ambiguous-owner case below
                raise ValueError(
                    f"param {name!r} is carried by no stage of this Pipeline — "
                    "a typo'd or wrong-estimator key in a tuning grid would "
                    "otherwise be silently ignored"
                )
            if len(owners) > 1:
                raise ValueError(
                    f"param {name!r} is carried by stages {owners}; tuning it through "
                    "a Pipeline is ambiguous — set it on the intended stage directly"
                )
            per_stage[owners[0]][p] = v
        return Pipeline(
            stages=[
                s.copy(per_stage[i]) if routable[i] is not None else s
                for i, s in enumerate(self._stages)
            ]
        )

    def fit(self, dataset: Any) -> "PipelineModel":
        if not self._stages:
            raise ValueError("Pipeline has no stages")
        for i, stage in enumerate(self._stages):
            if not (_is_estimator(stage) or hasattr(stage, "transform")):
                raise TypeError(
                    f"stage {i} ({type(stage).__name__}) is neither estimator nor transformer"
                )
        # pyspark semantics: transform only feeds LATER ESTIMATORS — stop
        # running the data forward past the last estimator stage
        last_est = max(
            (i for i, s in enumerate(self._stages) if _is_estimator(s)), default=-1
        )
        df = dataset
        fitted: List[Any] = []
        for i, stage in enumerate(self._stages):
            model = stage.fit(df) if _is_estimator(stage) else stage
            fitted.append(model)
            if i < last_est:
                df = model.transform(df)
        return PipelineModel(stages=fitted)


class PipelineModel(Params):
    def __init__(self, stages: Optional[List[Any]] = None) -> None:
        super().__init__()
        self.stages: List[Any] = list(stages or [])

    def transform(self, dataset: Any):
        df = dataset
        for stage in self.stages:
            df = stage.transform(df)
        return df

    # persistence: composite directory, one sub-save per stage (the shared
    # CompositeWriter protocol), restored by class dispatch
    def write(self):
        from .core import CompositeWriter

        if not self.stages:
            raise ValueError("PipelineModel has no stages to save")
        return CompositeWriter(
            self,
            build_meta=lambda inst: {"numStages": len(inst.stages)},
            iter_children=lambda inst: (
                (f"stage{i}", s) for i, s in enumerate(inst.stages)
            ),
        )

    def save(self, path: str) -> None:
        self.write().save(path)

    @classmethod
    def load(cls, path: str) -> "PipelineModel":
        import json
        import os

        from .core import load_instance

        with open(os.path.join(path, "metadata.json")) as f:
            meta = json.load(f)
        stages = [
            load_instance(os.path.join(path, f"stage{i}"))
            for i in range(meta["numStages"])
        ]
        return cls(stages=stages)
