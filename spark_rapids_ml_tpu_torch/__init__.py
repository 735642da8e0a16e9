#
# spark_rapids_ml_tpu_torch: the PyTorch / CUDA port of spark_rapids_ml_tpu
# for one NVIDIA H100, beside the JAX package, which stays the reference.
#
# Same PySpark-ML-style API: KMeans().setFeaturesCol("features").fit(data),
# model.transform(data), model.write().overwrite().save(path),
# KMeansModel.load(path); NearestNeighbors(k=...).setInputCol("features")
# .fit(items).kneighbors(queries);
# ApproximateNearestNeighbors(k=..., algorithm="ivfflat" | "ivfpq" | "cagra",
# algoParams={...}).setInputCol("features").fit(items).kneighbors(queries);
# PCA(k=...).setInputCol("features");
# LinearRegression(regParam=...).fit({"features": X, "label": y});
# LogisticRegression(regParam=...).fit({"features": X, "label": y});
# RandomForestClassifier(numTrees=..., maxDepth=...) and
# RandomForestRegressor(...).fit({"features": X, "label": y});
# DBSCAN(eps=..., min_samples=...).setFeaturesCol("features").fit(data)
# .transform(data) (the label column, noise -1);
# UMAP(n_neighbors=..., n_components=...).setFeaturesCol("features").fit(data)
# and model.transform(rows) (the embedding column);
# ModelRegistry().load("name", model) and
# ScoringEngine(registry).score("name", rows) to serve fitted models;
# est.fitMultiple(data, maps), CrossValidator(estimator=..., estimatorParamMaps=
# ParamGridBuilder()...build(), evaluator=RegressionEvaluator()).fit(data),
# TrainValidationSplit(...) and Pipeline(stages=[...]) to tune and chain
# them; FitScheduler().submit(est, data, tenant=..., priority=...) to share
# the card's memory among tenants' fits (a future: job.result()). Entry
# points run on the CUDA card; call
# set_devices("cpu") to run the plain PyTorch versions on the CPU instead.
# This package imports neither jax nor anything of spark_rapids_ml_tpu.
#
from .errors import PreemptedError, SchedulerSaturatedError
from .evaluation import BinaryClassificationEvaluator, MulticlassClassificationEvaluator, RegressionEvaluator
from .linalg import Vectors
from .models.classification import (
    LogisticRegression,
    LogisticRegressionModel,
    RandomForestClassificationModel,
    RandomForestClassifier,
)
from .models.clustering import DBSCAN, DBSCANModel, KMeans, KMeansModel
from .models.feature import PCA, PCAModel
from .models.knn import (
    ApproximateNearestNeighbors,
    ApproximateNearestNeighborsModel,
    NearestNeighbors,
    NearestNeighborsModel,
)
from .models.regression import (
    LinearRegression,
    LinearRegressionModel,
    RandomForestRegressionModel,
    RandomForestRegressor,
)
from .models.umap import UMAP, UMAPModel
from .parallel import set_devices
from .pipeline import Pipeline, PipelineModel
from .scheduler import FitScheduler
from .serving import ModelRegistry, OverloadController, ResidentModel, ScoreFuture, ScoringEngine
from .tuning import (
    CrossValidator,
    CrossValidatorModel,
    ParamGridBuilder,
    TrainValidationSplit,
    TrainValidationSplitModel,
)

__all__ = [
    "KMeans", "KMeansModel", "NearestNeighbors", "NearestNeighborsModel", "ApproximateNearestNeighbors",
    "ApproximateNearestNeighborsModel", "PCA", "PCAModel",
    "LinearRegression", "LinearRegressionModel", "LogisticRegression", "LogisticRegressionModel",
    "RandomForestClassifier", "RandomForestClassificationModel", "RandomForestRegressor",
    "RandomForestRegressionModel", "DBSCAN", "DBSCANModel", "UMAP", "UMAPModel",
    "Vectors", "set_devices",
    "ModelRegistry", "OverloadController", "ResidentModel", "ScoreFuture", "ScoringEngine",
    "CrossValidator", "CrossValidatorModel", "ParamGridBuilder", "TrainValidationSplit",
    "TrainValidationSplitModel", "RegressionEvaluator", "MulticlassClassificationEvaluator",
    "BinaryClassificationEvaluator", "Pipeline", "PipelineModel", "FitScheduler", "PreemptedError",
    "SchedulerSaturatedError",
]
