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
#   fail    rank 1 fails inside its LogisticRegression solve (argv: how:
#           "raise" an exception, "kill" its process with SIGKILL, or
#           "stall" past the collective deadline); every rank writes
#           result_rank<r>.json with the error it saw and when;
#   rounds  control-plane rounds only (argv: rounds heartbeat_s timeout_s)
#           through a ChaosRendezvous(FileRendezvous) under the plan of
#           SRML_FAULT_PLAN: a timestamp mark before each round, then
#           result_rank<r>.json (rounds done, the typed error, the rank it
#           blamed, when), as the JAX package's tests/chaos_worker.py.
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
    import numpy as np
    import scipy.sparse as sp

    from spark_rapids_ml_tpu_torch import (
        DBSCAN, UMAP, ApproximateNearestNeighbors, CrossValidator, FitScheduler, LinearRegression,
        NearestNeighbors, ParamGridBuilder, RandomForestClassifier, RegressionEvaluator,
    )

    x = np.stack(df["features"].to_numpy())
    data = {"features": x, "label": df["label"].to_numpy()}
    lin = LinearRegression().setLabelCol("target")
    cases = {
        "forest": lambda: RandomForestClassifier(numTrees=2, maxDepth=2).fit(data),
        "dbscan": lambda: DBSCAN(eps=1.0).setFeaturesCol("features").fit(df).transform(df),
        "umap": lambda: UMAP(n_epochs=2).setFeaturesCol("features").fit(df),
        "ann": lambda: ApproximateNearestNeighbors(k=2, algoParams={"nlist": 2}).setInputCol("features").fit(df),
        "cv": lambda: CrossValidator(
            estimator=lin, estimatorParamMaps=ParamGridBuilder().addGrid(lin.getParam("regParam"), [0.0]).build(),
            evaluator=RegressionEvaluator(labelCol="target"), numFolds=2,
        ).fit(df),
        "scheduler": lambda: FitScheduler().submit(lin, df),
        "sparse_fit": lambda: LinearRegression().fit({"features": sp.csr_matrix(x), "label": data["label"]}),
        "sparse_knn": lambda: NearestNeighbors(k=2).setInputCol("features").fit(
            {"features": sp.csr_matrix(x)}).kneighbors({"features": x[:2]}),
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
        try:
            KMeans(k=4, maxIter=3, float32_inputs=f32).setFeaturesCol("features").fit(df)
            info["demoted"] = "no error"
        except HbmBudgetError as e:
            info["demoted"] = str(e)
        finally:
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


def fail_main(rank, nranks, rdv_dir, out_dir, run_id, how):
    from mp_worker import make_dataset, split_bounds
    from spark_rapids_ml_tpu_torch import LogisticRegression, set_devices
    from spark_rapids_ml_tpu_torch.core import config
    from spark_rapids_ml_tpu_torch.ops import logistic
    from spark_rapids_ml_tpu_torch.parallel import FileRendezvous, TpuContext

    set_devices("cpu")
    config.update(fit_max_retries=0, rendezvous_timeout_s=3.0 if how == "stall" else 60.0)
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


def main() -> None:
    mode, rank, nranks, rdv_dir, out_dir, run_id = sys.argv[1:7]
    rank, nranks = int(rank), int(nranks)
    if mode == "fit":
        fit_main(rank, nranks, rdv_dir, out_dir, run_id, sys.argv[7])
    elif mode == "fail":
        fail_main(rank, nranks, rdv_dir, out_dir, run_id, sys.argv[7])
    elif mode == "rounds":
        rounds_main(rank, nranks, rdv_dir, out_dir, run_id, int(sys.argv[7]), float(sys.argv[8]), float(sys.argv[9]))
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main()
