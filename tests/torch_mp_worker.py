#
# One rank of the port's multi-process tests (launched as a fresh
# interpreter by tests/test_torch_multiprocess.py; the name keeps pytest
# from collecting it). It imports the port and numpy only, never JAX.
#
# argv: mode rank nranks rdv_dir out_dir run_id [mode's own]
#
#   fit     the rank holds its ragged block of the JAX multi-process test's
#           dataset (tests/mp_worker.py), fits KMeans, PCA,
#           LinearRegression, LogisticRegression and NearestNeighbors under
#           TpuContext over a FileRendezvous (gloo on the CPU), records the
#           KMeans init, checks that the estimators outside the slice refuse
#           naming A10 and that an over-budget fit gets the typed refusal,
#           and writes rank<r>.npz and rank<r>.json;
#   estimators  the fits after the headline five (`estimators_main`):
#           forests, DBSCAN, UMAP, the ANN indexes, sparse fits and the
#           sparse kNN, to rank<r>.npz (argv: dtype);
#   sketch  a forest over 115,000 rows, both ranks above the sketch's cap;
#   nan     ROADMAP fault C8: a NaN item row on the rank that holds fewer
#           rows, and a NaN query row there (`nan_main`);
#   fail    rank 1 fails inside its LogisticRegression solve (argv: how:
#           "raise" an exception, "kill" its process with SIGKILL, or
#           "stall" past the collective deadline); every rank writes
#           result_rank<r>.json with the error it saw and when;
#   rounds  control-plane rounds only (argv: rounds heartbeat_s timeout_s)
#           through a ChaosRendezvous(FileRendezvous) under the plan of
#           SRML_FAULT_PLAN: a timestamp mark before each round, then
#           result_rank<r>.json (rounds done, the typed error, the rank it
#           blamed, when), as the JAX package's tests/chaos_worker.py;
#   sweep   the JAX package's tests/sweep_worker.py sweep on its data and
#           ragged layout (CrossValidator over LinearRegression through the
#           engine), then a TrainValidationSplit, a sparse CrossValidator
#           (the fused per-fold path), a forest CrossValidator (the
#           per-model path) and the held-out gather on known blocks
#           (`sweep_main`), to rank<r>.npz and rank<r>.json;
#   even    the `fit` mode's dataset over the even ceil-div blocks of
#           `parallel.shard_row_ranges` (the blocks one process driving
#           nranks chips gives them): KMeans and LogisticRegression, float64,
#           to rank<r>.npz (`even_main`);
#   fleet   two KMeans fits and a CrossValidator over LinearRegression with
#           telemetry on and `fleet_ops_round_seconds` 0, so every
#           top-level fit's trace round carries an ops round
#           (`fleet_main`); the last cluster view, the fleet counters and
#           the top-level trace ids to result_rank<r>.json;
#   recover a real KMeans fit, checkpointed every 2 iterations inside a
#           device_dataset_scope, whose rank `victim` (argv) SIGKILLs itself
#           once its iteration-2 checkpoint has landed; the survivors reform,
#           reopen the process group and resume (`recover_main`), and write
#           result_rank<r>.json with the centers they resumed from.
#
import json
import os
import signal
import sys
import time


def _frame(X, y_log, y_lin, lo, hi):
    import numpy as np
    import pandas as pd

    return pd.DataFrame({
        "features": list(X[lo:hi]), "label": y_log[lo:hi], "target": y_lin[lo:hi],
        "id": np.arange(lo, hi, dtype=np.int64),
    })


def _refusals(df):
    """Every path outside the slice refuses under the context, naming A10:
    {name: message}."""
    from spark_rapids_ml_tpu_torch import FitScheduler, LinearRegression, NearestNeighbors

    lin = LinearRegression().setLabelCol("target")
    cases = {
        "scheduler": lambda: FitScheduler().submit(lin, df),
        "join": lambda: NearestNeighbors(k=2).setInputCol("features").fit(df).exactNearestNeighborsJoin(df.iloc[:2]),
    }
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = "no error"
        except NotImplementedError as e:
            out[name] = str(e)
        except Exception as e:  # noqa: BLE001 - reported to the parent test
            out[name] = f"{type(e).__name__}: {e}"
    return out


def fit_main(rank, nranks, rdv_dir, out_dir, run_id, dtype):
    import numpy as np
    import scipy.sparse as sp

    from mp_worker import make_dataset, split_bounds
    from spark_rapids_ml_tpu_torch import (
        PCA, KMeans, LinearRegression, LogisticRegression, NearestNeighbors, set_devices, telemetry,
    )
    from spark_rapids_ml_tpu_torch.core import config, device_dataset_scope
    from spark_rapids_ml_tpu_torch.errors import HbmBudgetError
    from spark_rapids_ml_tpu_torch.ops import kmeans as km_ops
    from spark_rapids_ml_tpu_torch.parallel import FileRendezvous, TpuContext

    set_devices("cpu")
    telemetry.enable()
    f32 = dtype == "float32"
    X, y_log, y_lin = make_dataset()
    bounds = split_bounds(len(X), nranks)
    lo, hi = bounds[rank], bounds[rank + 1]
    df = _frame(X, y_log, y_lin, lo, hi)
    inits = []
    real_fit = km_ops.kmeans_fit

    def recording_fit(X_, w_, init_centers, **kw):
        inits.append(np.array(init_centers, dtype=np.float64))
        return real_fit(X_, w_, init_centers, **kw)

    km_ops.kmeans_fit = recording_fit
    rdv = FileRendezvous(rank, nranks, rdv_dir, timeout_s=60.0, run_id=run_id, heartbeat_interval_s=0.5)
    out, info = {}, {}
    with TpuContext(rank, nranks, rdv) as ctx:
        info["backend"] = ctx.backend
        with device_dataset_scope():  # the second fit reuses the placement after one agreement round
            km = KMeans(k=4, maxIter=15, seed=3, float32_inputs=f32).setFeaturesCol("features").fit(df)
            km_pp = KMeans(k=4, maxIter=15, seed=3, initMode="k-means||", float32_inputs=f32).setFeaturesCol(
                "features").fit(df)
        km_rand = KMeans(k=4, maxIter=2, seed=5, initMode="random", float32_inputs=f32).setFeaturesCol(
            "features").fit(df)
        pca = PCA(k=3, inputCol="features", float32_inputs=f32).fit(df)
        lin = LinearRegression(regParam=0.0, float32_inputs=f32, labelCol="target").setFeaturesCol("features").fit(df)
        lr = LogisticRegression(maxIter=100, regParam=0.1, tol=1e-10, float32_inputs=f32).setFeaturesCol(
            "features").fit(df)
        info["spmd_metrics"] = lr._fit_metrics.get("spmd")
        gnn = NearestNeighbors(k=3, float32_inputs=f32).setInputCol("features").setIdCol("id").fit(df)
        _, _, knn = gnn.kneighbors(df.iloc[:5])
        # no idCol: row-number ids offset by the lower ranks' rows; rank 0
        # adds a NaN query row, so the query blocks are ragged too
        plain = df.drop(columns=["id"])
        queries = plain.iloc[:5].copy()
        if rank == 0:
            queries.loc[len(queries)] = [np.full(X.shape[1], np.nan), 0.0, 0.0]
        _, q_out, knn2 = NearestNeighbors(k=3, float32_inputs=f32).setInputCol("features").fit(plain).kneighbors(
            queries)
        info["refusals"] = _refusals(df)
        saved = dict(config)
        config.update(hbm_budget_bytes=3_000)
        sparse = {"features": sp.csr_matrix(X[lo:hi]), "label": y_lin[lo:hi]}
        for name, fit in (
            ("demoted", lambda: KMeans(k=4, maxIter=3, float32_inputs=f32).setFeaturesCol("features").fit(df)),
            ("demoted_sparse", lambda: LinearRegression(float32_inputs=f32).fit(sparse)),
        ):
            try:
                fit()
                info[name] = "no error"
            except HbmBudgetError as e:
                info[name] = str(e)
        config.clear()
        config.update(saved)
        info["counters"] = {k: v for k, v in telemetry.registry().snapshot()["counters"].items()
                            if k.startswith(("collective.", "rendezvous.", "fit.device_dataset"))}
    rdv.close()
    out.update(
        km_centers=km.cluster_centers_, km_inertia=np.asarray(km.inertia_), km_iter=np.asarray(km.n_iter_),
        km_pp_centers=km_pp.cluster_centers_, km_rand_centers=km_rand.cluster_centers_,
        km_init_pp=inits[1], km_init_rand=inits[2],
        pca_components=pca.components_, pca_mean=pca.mean_, pca_var_ratio=pca.explained_variance_ratio_,
        lin_coef=lin.coef_, lin_intercept=np.asarray(lin.intercept_),
        lr_coef=lr.coef_, lr_intercept=np.asarray(lr.intercept_), lr_classes=lr.classes_,
        lr_iter=np.asarray(lr.n_iter_), lr_objective=np.asarray(lr.objective_),
        knn_query_ids=knn["query_id"].to_numpy(), knn_indices=np.stack(knn["indices"].to_numpy()),
        knn_distances=np.stack(knn["distances"].to_numpy()),
        knn2_query_ids=knn2["query_id"].to_numpy(), knn2_indices=np.stack(knn2["indices"].to_numpy()),
        knn2_distances=np.stack(knn2["distances"].to_numpy()),
        knn2_query_frame_ids=q_out["unique_id"].to_numpy(),
    )
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)


def nan_items():
    """ROADMAP fault C8's inputs: 64 x 6 float64 items from
    default_rng(3), row 61 all NaN, and the next 6 x 6 draws as queries."""
    import numpy as np

    rng = np.random.default_rng(3)
    items = rng.normal(size=(64, 6))
    items[61] = np.nan
    return items, rng.normal(size=(6, 6))


def nan_main(rank, nranks, rdv_dir, out_dir, run_id):
    """Two ranks: rank 0 holds items [0, 60) and queries [0, 3), rank 1
    items [60, 64) (the NaN row 61 among them) and queries [3, 6) plus an
    all-NaN query row; NearestNeighbors(k=4) and (k=5, more than rank 1's
    items), no idCol."""
    import numpy as np
    import pandas as pd

    from spark_rapids_ml_tpu_torch import NearestNeighbors, set_devices
    from spark_rapids_ml_tpu_torch.parallel import FileRendezvous, TpuContext

    set_devices("cpu")
    items, queries = nan_items()
    lo, hi = (0, 60) if rank == 0 else (60, 64)
    q = queries[:3] if rank == 0 else np.concatenate([queries[3:], np.full((1, 6), np.nan)])
    rdv = FileRendezvous(rank, nranks, rdv_dir, timeout_s=60.0, run_id=run_id, heartbeat_interval_s=0.5)
    out = {}
    with TpuContext(rank, nranks, rdv):
        for k in (4, 5):
            model = NearestNeighbors(k=k, float32_inputs=False).setInputCol("features").fit(
                pd.DataFrame({"features": list(items[lo:hi])}))
            _, _, knn = model.kneighbors(pd.DataFrame({"features": list(q)}))
            out[f"k{k}_query_ids"] = knn["query_id"].to_numpy()
            out[f"k{k}_indices"] = np.stack(knn["indices"].to_numpy())
            out[f"k{k}_distances"] = np.stack(knn["distances"].to_numpy())
    rdv.close()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


# the forests of the `estimators` mode: name -> (classifier, params); the
# regressors fit integer labels (`int_target`), so both packages' node
# statistics are exact sums
FORESTS = {
    "rfc_even": (True, {"numTrees": 6, "featureSubsetStrategy": "sqrt"}),
    "rfc_odd": (True, {"numTrees": 7, "featureSubsetStrategy": "sqrt", "subsamplingRate": 0.7,
                       "impurity": "entropy"}),
    "rfr_one": (False, {"numTrees": 1, "featureSubsetStrategy": "onethird", "subsamplingRate": 0.6}),
}
FOREST_COMMON = {"maxDepth": 3, "maxBins": 16, "seed": 7, "bootstrap": False}
ANN = {
    "ivfflat_all": ("ivfflat", {"nlist": 4, "nprobe": 4}),
    "ivfpq": ("ivfpq", {"nlist": 4, "nprobe": 2, "M": 2, "n_bits": 4}),
    "cagra": ("cagra", {"graph_degree": 8, "intermediate_graph_degree": 12, "cluster_reps": 2,
                        "fast_score": False}),
}


def int_target(y_lin):
    import numpy as np

    return np.round(2.0 * y_lin)


def sparse_rows(X):
    """The dataset's rows with the entries below 0.8 in magnitude zeroed:
    CSR rows of uneven width, so the ranks' widest rows differ."""
    import numpy as np

    return np.where(np.abs(X) < 0.8, 0.0, X)


def _forest_arrays(model):
    return {"feature": model.feature, "threshold": model.threshold, "node_stats": model.node_stats,
            "classes": model.classes_}


def estimators_main(rank, nranks, rdv_dir, out_dir, run_id, dtype):
    """The fits of the JAX package's multi-process worker after its
    headline five (tests/mp_worker.py): the forests, DBSCAN, UMAP, the three
    ANN indexes, sparse LinearRegression and LogisticRegression, and the
    sparse kNN, on this rank's ragged block; every model to rank<r>.npz."""
    import numpy as np
    import pandas as pd
    import scipy.sparse as sp

    from mp_worker import make_dataset, split_bounds
    from spark_rapids_ml_tpu_torch import (
        DBSCAN, UMAP, ApproximateNearestNeighbors, LinearRegression, LogisticRegression, NearestNeighbors,
        RandomForestClassifier, RandomForestRegressor, set_devices,
    )
    from spark_rapids_ml_tpu_torch.parallel import FileRendezvous, TpuContext

    set_devices("cpu")
    f32 = dtype == "float32"
    X, y_log, y_lin = make_dataset()
    bounds = split_bounds(len(X), nranks)
    lo, hi = bounds[rank], bounds[rank + 1]
    df = _frame(X, y_log, y_lin, lo, hi)
    df["target_int"] = int_target(y_lin[lo:hi])
    plain = df.drop(columns=["id"])
    xs = sp.csr_matrix(sparse_rows(X)[lo:hi])
    out = {}
    rdv = FileRendezvous(rank, nranks, rdv_dir, timeout_s=60.0, run_id=run_id, heartbeat_interval_s=0.5)
    with TpuContext(rank, nranks, rdv):
        for name, (clf, params) in FORESTS.items():
            cls = RandomForestClassifier if clf else RandomForestRegressor
            est = cls(float32_inputs=f32, labelCol="label" if clf else "target_int", **FOREST_COMMON, **params)
            for key, v in _forest_arrays(est.setFeaturesCol("features").fit(df)).items():
                out[f"{name}_{key}"] = v
        # the bootstrap: the JAX worker's forest, fitted twice
        boot = [RandomForestRegressor(numTrees=8, maxDepth=4, seed=1, labelCol="target", float32_inputs=f32)
                .setFeaturesCol("features").fit(df) for _ in range(2)]
        out["boot_pred"] = boot[0].transform(df)["prediction"].to_numpy()
        out["boot_pred_again"] = boot[1].transform(df)["prediction"].to_numpy()
        out["boot_threshold"] = boot[0].threshold
        # DBSCAN: the default tile (one) and 64-row tiles (two, split)
        for name, mb in (("db", None), ("db_tiles", 1e-6)):
            model = DBSCAN(eps=1.5, min_samples=3, max_mbytes_per_batch=mb).setFeaturesCol("features").fit(df)
            out[f"{name}_labels"] = model.transform(df)["prediction"].to_numpy()
            out[f"{name}_core"] = model.core_sample_indices_
        # UMAP: the JAX worker's fit, a short one, a sampled one
        for name, kw in (("um", {"n_epochs": 30}), ("um5", {"n_epochs": 5}),
                         ("um_frac", {"n_epochs": 5, "sample_fraction": 0.7})):
            um = UMAP(n_components=2, n_neighbors=5.0, random_state=3, init="random", **kw) \
                .setFeaturesCol("features").fit(df)
            out[f"{name}_emb"] = um.embedding_
            out[f"{name}_raw"] = um.raw_data_
            if name == "um5":  # each rank embeds its own rows
                out["transform5"] = np.stack(um.transform(df.iloc[:4])["embedding"].to_numpy())
        # the ANN: each rank's index over its own rows, no idCol
        for name, (algo, ap) in ANN.items():
            model = ApproximateNearestNeighbors(k=3, algorithm=algo, algoParams=ap, float32_inputs=f32) \
                .setInputCol("features").fit(plain)
            _, q_out, knn = model.kneighbors(plain.iloc[:5])
            out[f"{name}_indices"] = np.stack(knn["indices"].to_numpy())
            out[f"{name}_distances"] = np.stack(knn["distances"].to_numpy())
            out[f"{name}_query_ids"] = knn["query_id"].to_numpy()
        # sparse: the CSR rows of uneven width
        sparse = {"features": xs, "label": y_log[lo:hi], "target": y_lin[lo:hi]}
        lin = LinearRegression(regParam=0.0, float32_inputs=f32, labelCol="target").fit(sparse)
        lr = LogisticRegression(maxIter=100, regParam=0.1, tol=1e-10, float32_inputs=f32).fit(sparse)
        out.update(sp_lin_coef=lin.coef_, sp_lin_intercept=np.asarray(lin.intercept_), sp_lr_coef=lr.coef_,
                   sp_lr_intercept=np.asarray(lr.intercept_), sp_lr_objective=np.asarray(lr.objective_),
                   sp_lr_classes=lr.classes_)
        nn = NearestNeighbors(k=3, float32_inputs=f32).setInputCol("features").setIdCol("id").fit(
            {"features": xs, "id": np.arange(lo, hi, dtype=np.int64)})
        _, _, knn = nn.kneighbors({"features": sparse_rows(X)[lo:lo + 5], "id": np.arange(lo, lo + 5)})
        out["sp_knn_indices"] = np.stack(knn["indices"].to_numpy())
        out["sp_knn_distances"] = np.stack(knn["distances"].to_numpy())
    rdv.close()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


# the `sketch` mode's forest: bootstrap off, a subsample drawn over the
# longer block
SKETCH_FOREST = {"numTrees": 3, "maxDepth": 3, "maxBins": 16, "seed": 5, "bootstrap": False,
                 "subsamplingRate": 0.5, "featureSubsetStrategy": "all"}


def sketch_data():
    """115,000 x 3 float32 rows and 0/1 labels, split 60,000 / 55,000: both
    ranks above the sketch's cap of 100,000 // 2 rows."""
    import numpy as np

    rng = np.random.default_rng(11)
    x = rng.normal(size=(115_000, 3)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.normal(size=len(x)) > 0).astype(np.float64)
    return x, y, [0, 60_000, 115_000]


def sketch_main(rank, nranks, rdv_dir, out_dir, run_id):
    """A RandomForestClassifier over `sketch_data`'s block of this rank."""
    import numpy as np

    from spark_rapids_ml_tpu_torch import RandomForestClassifier, set_devices
    from spark_rapids_ml_tpu_torch.parallel import FileRendezvous, TpuContext

    set_devices("cpu")
    x, y, bounds = sketch_data()
    lo, hi = bounds[rank], bounds[rank + 1]
    rdv = FileRendezvous(rank, nranks, rdv_dir, timeout_s=60.0, run_id=run_id, heartbeat_interval_s=0.5)
    with TpuContext(rank, nranks, rdv):
        model = RandomForestClassifier(**SKETCH_FOREST).fit({"features": x[lo:hi], "label": y[lo:hi]})
    rdv.close()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **_forest_arrays(model))


def fail_main(rank, nranks, rdv_dir, out_dir, run_id, how):
    from mp_worker import make_dataset, split_bounds
    from spark_rapids_ml_tpu_torch import LogisticRegression, set_devices
    from spark_rapids_ml_tpu_torch.core import config
    from spark_rapids_ml_tpu_torch.ops import logistic
    from spark_rapids_ml_tpu_torch.parallel import FileRendezvous, TpuContext

    set_devices("cpu")
    # no recovery epoch: the peer's failure must reach rank 0 typed (a
    # reformable rendezvous would otherwise let rank 0 finish alone)
    config.update(fit_max_retries=0, recovery_max_rank_losses=0, rendezvous_timeout_s=3.0 if how == "stall" else 60.0)
    X, y_log, y_lin = make_dataset()
    bounds = split_bounds(len(X), nranks)
    df = _frame(X, y_log, y_lin, bounds[rank], bounds[rank + 1])
    if rank == 1:
        real_pick, calls = logistic.armijo_pick, [0]

        def failing_pick(*a, **kw):
            calls[0] += 1
            if calls[0] == 3:
                with open(os.path.join(out_dir, "failed_at.json"), "w") as f:
                    json.dump({"t": time.time()}, f)
                if how == "kill":
                    os.kill(os.getpid(), signal.SIGKILL)
                if how == "stall":
                    time.sleep(8.0)  # past the peer's 3 s collective deadline
                raise RuntimeError("injected failure in the line search")
            return real_pick(*a, **kw)

        logistic.armijo_pick = failing_pick
    rdv = FileRendezvous(rank, nranks, rdv_dir, run_id=run_id, heartbeat_interval_s=0.5)
    res = {"rank": rank, "error": None, "failed_rank": None, "reason": None, "t": None}
    try:
        with TpuContext(rank, nranks, rdv):
            LogisticRegression(maxIter=50, regParam=0.1, tol=1e-12, float32_inputs=False).fit(df)
    except Exception as e:  # noqa: BLE001 - reported to the parent test
        res.update(error=type(e).__name__, failed_rank=getattr(e, "failed_rank", None),
                   reason=str(e)[:300], t=time.time())
    rdv.close()
    with open(os.path.join(out_dir, f"result_rank{rank}.json"), "w") as f:
        json.dump(res, f)


def rounds_main(rank, nranks, rdv_dir, out_dir, run_id, rounds, heartbeat_s, timeout_s):
    from spark_rapids_ml_tpu_torch.errors import RankFailedError, RendezvousTimeoutError
    from spark_rapids_ml_tpu_torch.parallel import ChaosRendezvous, FileRendezvous

    os.environ["SRML_RANK"] = str(rank)  # no TpuContext: the plan's rank= reads this
    rdv = ChaosRendezvous(FileRendezvous(
        rank, nranks, rdv_dir, timeout_s=timeout_s, run_id=run_id, heartbeat_interval_s=heartbeat_s,
    ))
    res = {"rank": rank, "rounds_done": 0, "error": None, "failed_rank": None, "reason": None,
           "detected_at": None}
    marks = []
    try:
        for i in range(rounds):
            # the mark goes first: a kill fires on entry to the round
            marks.append({"round": i, "t": time.time()})
            with open(os.path.join(out_dir, f"marks_rank{rank}.json"), "w") as f:
                json.dump(marks, f)
            rdv.allgather(f"{rank}:{i}")
            res["rounds_done"] = i + 1
    except (RankFailedError, RendezvousTimeoutError, RuntimeError) as e:
        res.update(error=type(e).__name__, failed_rank=getattr(e, "failed_rank", None), reason=str(e),
                   detected_at=time.time())
    finally:
        rdv.close()
    with open(os.path.join(out_dir, f"result_rank{rank}.json"), "w") as f:
        json.dump(res, f)


def sweep_main(rank, nranks, rdv_dir, out_dir, run_id):
    """The JAX package's tests/sweep_worker.py sweep (its data, its ragged
    split, CrossValidator over LinearRegression, rmse, 3 folds, seed 1),
    then TrainValidationSplit over it, CrossValidator over a sparse
    LogisticRegression and over a forest, and `_gather_validation` of known
    blocks; the metrics, winners and models to rank<r>.npz, the counters to
    rank<r>.json. For the forest sweep each rank also scores the winner on
    its own held-out rows of fold 0, as the JAX package's per-model path
    scores them."""
    import numpy as np
    import pandas as pd
    import scipy.sparse as sp

    from sweep_worker import make_dataset, split_bounds
    from spark_rapids_ml_tpu_torch import (
        CrossValidator, LinearRegression, LogisticRegression, MulticlassClassificationEvaluator, ParamGridBuilder,
        RandomForestClassifier, RegressionEvaluator, TrainValidationSplit, set_devices, telemetry,
    )
    from spark_rapids_ml_tpu_torch import tuning
    from spark_rapids_ml_tpu_torch.parallel import FileRendezvous, TpuContext

    set_devices("cpu")
    X, y = make_dataset()
    bounds = split_bounds(len(X), nranks)
    lo, hi = bounds[rank], bounds[rank + 1]
    df = pd.DataFrame({"features": list(X[lo:hi]), "label": y[lo:hi]})
    telemetry.enable()
    telemetry.registry().reset()
    out, info = {}, {}
    rdv = FileRendezvous(rank, nranks, rdv_dir, timeout_s=120.0, run_id=run_id, heartbeat_interval_s=0.5)
    with TpuContext(rank, nranks, rdv):
        lr = LinearRegression(float32_inputs=False).setFeaturesCol("features")
        grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.0, 0.1, 1.0]).build()
        cv = CrossValidator(estimator=lr, estimatorParamMaps=grid, evaluator=RegressionEvaluator(metricName="rmse"),
                            numFolds=3, seed=1)
        model = cv.fit(df)
        snap = telemetry.registry().snapshot()
        info["cv_counters"] = {k: v for k, v in snap["counters"].items()
                               if k.startswith(("ingest.", "fit.device_dataset", "sweep."))}
        info["cv_layouts"] = snap["histograms"].get("device_wait.layout_s", {}).get("count", 0)
        out.update(cv_avg=np.asarray(model.avgMetrics), cv_std=np.asarray(model.stdMetrics),
                   cv_best_reg=np.asarray(float(model.bestModel.getOrDefault("regParam"))),
                   cv_best_coef=np.asarray(model.bestModel.coef_))
        tvs = TrainValidationSplit(estimator=lr, estimatorParamMaps=grid,
                                   evaluator=RegressionEvaluator(metricName="rmse"), trainRatio=0.7, seed=2).fit(df)
        out.update(tvs_metrics=np.asarray(tvs.validationMetrics), tvs_best_coef=np.asarray(tvs.bestModel.coef_))
        # a sparse sweep: the fused per-fold path (fitMultiple, gathered rows)
        xs = sp.csr_matrix(np.where(np.abs(X[lo:hi]) < 0.7, 0.0, X[lo:hi]))
        yl = (y[lo:hi] > np.median(y)).astype(np.float64)
        slr = LogisticRegression(maxIter=30, tol=1e-10, float32_inputs=False)
        sgrid = ParamGridBuilder().addGrid(slr.getParam("regParam"), [1e-3, 0.1]).build()
        info["sparse_engine"] = tuning._engine_eligible(slr, {"features": xs, "label": yl})
        scv = CrossValidator(estimator=slr, estimatorParamMaps=sgrid,
                             evaluator=MulticlassClassificationEvaluator(metricName="accuracy"), numFolds=2, seed=3)
        sm = scv.fit({"features": xs, "label": yl})
        out.update(sparse_avg=np.asarray(sm.avgMetrics), sparse_best_coef=np.asarray(sm.bestModel.coef_))
        # a forest: the per-model path (fit, transform, evaluate per map)
        rf = RandomForestClassifier(numTrees=3, maxDepth=3, maxBins=8, seed=5, bootstrap=False,
                                    float32_inputs=False)
        rgrid = ParamGridBuilder().addGrid(rf.getParam("maxDepth"), [2, 4]).build()
        fdf = df.assign(label=(df["label"] > np.median(y)).astype(np.float64))
        eva = MulticlassClassificationEvaluator(metricName="accuracy")
        fm = CrossValidator(estimator=rf, estimatorParamMaps=rgrid, evaluator=eva, numFolds=2, seed=4).fit(fdf)
        out.update(forest_avg=np.asarray(fm.avgMetrics), forest_best_threshold=np.asarray(fm.bestModel.threshold))
        # the winner scored on this rank's own held-out rows of fold 0 alone
        folds = CrossValidator(numFolds=2, seed=4)._kfold_indices(len(fdf), fdf)
        local = fdf.iloc[folds[0][1]].reset_index(drop=True)
        out["forest_local_metric"] = np.asarray(eva.evaluate(fm.bestModel.transform(local)))
        # the engine's gather of known blocks: rank r holds r + 1 rows of r
        feats = np.full((rank + 1, 2), float(rank))
        g_feats, g_labels = tuning._gather_validation(feats, np.arange(rank + 1, dtype=np.float64))
        out.update(gather_feats=g_feats, gather_labels=g_labels)
        rows = tuning._gather_rows({"features": sp.csr_matrix(feats), "label": np.full(rank + 1, float(rank))})
        out.update(gather_rows_csr=rows["features"].toarray(), gather_rows_label=rows["label"])
        info["sweep_counters"] = {k: v for k, v in telemetry.registry().snapshot()["counters"].items()
                                  if k.startswith("sweep.")}
    rdv.close()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)


# the `recover` mode's fit: k-means on rows made from a seed, split
# raggedly over three ranks
RECOVER_BOUNDS = (0, 1300, 2200, 3000)
RECOVER_KMEANS = {"k": 6, "maxIter": 6, "tol": 0.0, "initMode": "random", "seed": 1, "float32_inputs": False}


def recover_rows():
    """3000 x 5 float64 rows around 4 overlapping Gaussian centers."""
    import numpy as np

    rng = np.random.default_rng(29)
    centers = rng.normal(scale=1.5, size=(4, 5))
    return centers[rng.integers(0, 4, size=3000)] + rng.normal(size=(3000, 5))


def recover_main(rank, nranks, rdv_dir, out_dir, run_id, victim):
    """A KMeans fit whose rank `victim` SIGKILLs itself right after its
    iteration-2 checkpoint landed; the survivors' result_rank<r>.json holds
    their centers, the centers they resumed from, the membership and the
    recovery counters."""
    import numpy as np

    from spark_rapids_ml_tpu_torch import KMeans, set_devices, telemetry
    from spark_rapids_ml_tpu_torch import checkpoint as ckpt
    from spark_rapids_ml_tpu_torch.core import config, device_dataset_scope
    from spark_rapids_ml_tpu_torch.parallel import FileRendezvous, TpuContext

    set_devices("cpu")
    telemetry.enable()
    config.update(checkpoint_every_iters=2, recovery_max_rank_losses=1)
    X = recover_rows()
    lo, hi = RECOVER_BOUNDS[rank], RECOVER_BOUNDS[rank + 1]
    resumed = []
    real_save, real_load = ckpt.CheckpointStore.save, ckpt.CheckpointStore.load

    def save(store, key, c):
        real_save(store, key, c)
        if rank == victim and c.solver == "kmeans" and c.iteration == 2:
            os.kill(os.getpid(), signal.SIGKILL)

    def load(store, key):
        c = real_load(store, key)
        if c is not None and c.solver == "kmeans":
            resumed.append({"iteration": int(c.iteration), "centers": np.asarray(c.state["centers"]).tolist()})
        return c

    ckpt.CheckpointStore.save, ckpt.CheckpointStore.load = save, load
    res = {"rank": rank, "error": None}
    rdv = FileRendezvous(rank, nranks, rdv_dir, timeout_s=60.0, run_id=run_id, heartbeat_interval_s=2.0)
    try:
        with TpuContext(rank, nranks, rdv) as ctx:
            with device_dataset_scope():
                t0 = time.perf_counter()
                model = KMeans(**RECOVER_KMEANS).setFeaturesCol("features").fit({"features": X[lo:hi]})
                res["fit_s"] = time.perf_counter() - t0
            res.update(
                centers=np.asarray(model.cluster_centers_).tolist(), n_iter=int(model.n_iter_),
                spmd=model._fit_metrics.get("spmd"), live=ctx.live_ranks_hint(), rank_now=ctx.rank,
                nranks_now=ctx.nranks, generation=ctx.recovery_generation, backend=ctx.backend,
                reform_s=ctx.group.reform_s,
            )
    except Exception as e:  # noqa: BLE001 - reported to the parent test
        res.update(error=type(e).__name__, detail=str(e)[:400])
    rdv.close()
    counters = telemetry.registry().snapshot()["counters"]
    res["counters"] = {k: counters.get(k) for k in (
        "fit.recoveries", "recovery.epochs", "recovery.rank_losses", "rendezvous.reforms", "checkpoint.restores",
        "recovery.replacements", "recovery.rows_replaced", "ingest.datasets", "fit.device_dataset_builds")}
    res["resumed"] = resumed
    with open(os.path.join(out_dir, f"result_rank{rank}.json"), "w") as f:
        json.dump(res, f)


def even_main(rank, nranks, rdv_dir, out_dir, run_id):
    import numpy as np

    from mp_worker import make_dataset
    from spark_rapids_ml_tpu_torch import KMeans, LogisticRegression, set_devices
    from spark_rapids_ml_tpu_torch.parallel import FileRendezvous, TpuContext, shard_row_ranges

    set_devices("cpu")
    X, y_log, _ = make_dataset()
    lo, hi = shard_row_ranges(len(X), nranks)[rank]
    data = {"features": X[lo:hi], "label": y_log[lo:hi]}
    rdv = FileRendezvous(rank, nranks, rdv_dir, timeout_s=60.0, run_id=run_id, heartbeat_interval_s=0.5)
    with TpuContext(rank, nranks, rdv):
        km = KMeans(k=4, maxIter=15, seed=3, float32_inputs=False).fit({"features": data["features"]})
        lr = LogisticRegression(maxIter=100, regParam=0.1, tol=1e-10, float32_inputs=False).fit(data)
    rdv.close()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), km_centers=km.cluster_centers_,
             lr_coef=lr.coef_, lr_intercept=np.asarray(lr.intercept_), lr_iter=np.asarray(lr.n_iter_))


def fleet_main(rank, nranks, rdv_dir, out_dir, run_id):
    """The fleet plane over real processes: each top-level trace scope is
    counted as it opens (a sweep's inner fits adopt its trace and are not),
    and after the fits the rank's cluster view is written out."""
    import contextlib

    from mp_worker import make_dataset, split_bounds
    from spark_rapids_ml_tpu_torch import (
        CrossValidator, KMeans, LinearRegression, ParamGridBuilder, RegressionEvaluator, diagnostics, set_devices,
        telemetry,
    )
    from spark_rapids_ml_tpu_torch.core import config
    from spark_rapids_ml_tpu_torch.ops_plane import fleet
    from spark_rapids_ml_tpu_torch.parallel import FileRendezvous, TpuContext

    set_devices("cpu")
    telemetry.enable()
    config["fleet_ops_round_seconds"] = 0
    X, _, y_lin = make_dataset()
    bounds = split_bounds(len(X), nranks)
    lo, hi = bounds[rank], bounds[rank + 1]
    data = {"features": X[lo:hi], "label": y_lin[lo:hi]}
    trace_ids = []
    real_scope = diagnostics.trace_scope

    @contextlib.contextmanager
    def counting_scope(label, ctx=None):
        top = diagnostics.current_trace() is None
        with real_scope(label, ctx) as tags:
            if top:
                trace_ids.append(tags["trace_id"])
            yield tags

    diagnostics.trace_scope = counting_scope
    rdv = FileRendezvous(rank, nranks, rdv_dir, timeout_s=60.0, run_id=run_id, heartbeat_interval_s=0.5)
    with TpuContext(rank, nranks, rdv):
        KMeans(k=4, maxIter=5, seed=3, float32_inputs=False).fit({"features": data["features"]})
        KMeans(k=3, maxIter=5, seed=1, float32_inputs=False).fit({"features": data["features"]})
        lr = LinearRegression(float32_inputs=False)
        grid = ParamGridBuilder().addGrid(lr.getParam("regParam"), [0.0, 0.1]).build()
        CrossValidator(estimator=lr, estimatorParamMaps=grid, evaluator=RegressionEvaluator(), numFolds=2,
                       seed=1).fit(data)
        view = fleet.cluster_view()
    rdv.close()
    counters = telemetry.registry().snapshot()["counters"]
    res = {"view": view, "trace_ids": trace_ids, "top_level_scopes": len(trace_ids),
           "ops_rounds": counters.get("fleet.ops_rounds", 0),
           "ops_rounds_failed": counters.get("fleet.ops_rounds_failed", 0)}
    with open(os.path.join(out_dir, f"result_rank{rank}.json"), "w") as f:
        json.dump(res, f, default=str)


def main() -> None:
    mode, rank, nranks, rdv_dir, out_dir, run_id = sys.argv[1:7]
    rank, nranks = int(rank), int(nranks)
    if mode == "fit":
        fit_main(rank, nranks, rdv_dir, out_dir, run_id, sys.argv[7])
    elif mode == "estimators":
        estimators_main(rank, nranks, rdv_dir, out_dir, run_id, sys.argv[7])
    elif mode == "sketch":
        sketch_main(rank, nranks, rdv_dir, out_dir, run_id)
    elif mode == "nan":
        nan_main(rank, nranks, rdv_dir, out_dir, run_id)
    elif mode == "fail":
        fail_main(rank, nranks, rdv_dir, out_dir, run_id, sys.argv[7])
    elif mode == "sweep":
        sweep_main(rank, nranks, rdv_dir, out_dir, run_id)
    elif mode == "even":
        even_main(rank, nranks, rdv_dir, out_dir, run_id)
    elif mode == "fleet":
        fleet_main(rank, nranks, rdv_dir, out_dir, run_id)
    elif mode == "recover":
        recover_main(rank, nranks, rdv_dir, out_dir, run_id, int(sys.argv[7]))
    elif mode == "rounds":
        rounds_main(rank, nranks, rdv_dir, out_dir, run_id, int(sys.argv[7]), float(sys.argv[8]), float(sys.argv[9]))
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main()
