#
# The PyTorch port's opt-in ingest validation (spark_rapids_ml_tpu_torch/
# data.py: `validate_extracted`, `run_deferred_validation`,
# config["validate_ingest"]) after tests/test_ingest.py's dense cases, each
# against the JAX package's on the same numpy inputs: the same error class
# contract (an IngestValidationError that is a ValueError), the same column
# and the same absolute first bad row.
#
import numpy as np
import pandas as pd
import pytest

from spark_rapids_ml_tpu import core as jcore
from spark_rapids_ml_tpu.data import extract_dataset as jextract
from spark_rapids_ml_tpu.errors import IngestValidationError as JaxIngestValidationError
from spark_rapids_ml_tpu_torch import KMeans, NearestNeighbors, set_devices
from spark_rapids_ml_tpu_torch.core import config
from spark_rapids_ml_tpu_torch.data import extract_dataset, validate_extracted
from spark_rapids_ml_tpu_torch.errors import IngestValidationError

_KEYS = ("validate_ingest", "ingest_chunk_bytes")


@pytest.fixture
def validate_on():
    saved = {k: config[k] for k in _KEYS}
    jsaved = {k: jcore.config[k] for k in _KEYS}
    for cfg in (config, jcore.config):
        cfg["validate_ingest"] = True
    yield
    config.update(saved)
    jcore.config.update(jsaved)


def _both(data, **kw):
    """(port error, JAX error) of extracting `data` with validation on."""
    out = []
    for fn, cls in ((extract_dataset, IngestValidationError), (jextract, JaxIngestValidationError)):
        with pytest.raises(cls) as ei:
            fn(data, **kw)
        out.append(ei.value)
    return out


@pytest.mark.parametrize("chunk_bytes", [256, 128 << 20], ids=["tiny-chunks", "default-chunks"])
def test_validate_ingest_names_the_feature_column(validate_on, chunk_bytes):
    for cfg in (config, jcore.config):
        cfg["ingest_chunk_bytes"] = chunk_bytes
    x = np.arange(400, dtype=np.float64).reshape(100, 4)
    x[37, 2] = np.nan  # several 256-byte chunks in
    err, jerr = _both({"feat": x}, input_col="feat")
    assert isinstance(err, ValueError)
    assert (err.column, err.row) == (jerr.column, jerr.row) == ("feat", 37)
    assert str(err) == str(jerr)


def test_validate_ingest_names_the_exact_multi_col(validate_on):
    df = pd.DataFrame({"a": np.ones(50), "b": np.ones(50), "c": np.ones(50), "label": np.zeros(50)})
    df.loc[11, "b"] = np.inf
    err, jerr = _both(df, input_cols=["a", "b", "c"], label_col="label")
    assert (err.column, err.row) == (jerr.column, jerr.row) == ("b", 11)


def test_validate_ingest_checks_label_and_weight(validate_on):
    x = np.ones((20, 3))
    lab = np.zeros(20)
    lab[4] = np.nan
    err, jerr = _both({"f": x, "y": lab}, input_col="f", label_col="y")
    assert (err.column, err.row) == (jerr.column, jerr.row) == ("y", 4)
    w = np.ones(20)
    w[9] = -np.inf
    err, jerr = _both({"f": x, "y": np.zeros(20), "w": w}, input_col="f", label_col="y", weight_col="w")
    assert (err.column, err.row) == (jerr.column, jerr.row) == ("w", 9)


def test_validate_ingest_vector_cells_name_their_column(validate_on):
    x = np.random.default_rng(0).normal(size=(30, 3))
    x[21, 1] = np.nan
    err, jerr = _both(pd.DataFrame({"features": list(x)}), input_col="features")
    assert (err.column, err.row) == (jerr.column, jerr.row) == ("features", 21)


def test_validate_ingest_off_by_default_and_clean_data_passes(validate_on):
    x = np.ones((10, 2))
    assert extract_dataset({"f": x}, input_col="f").n_rows == 10
    config["validate_ingest"] = False
    x_bad = x.copy()
    x_bad[0, 0] = np.nan
    assert extract_dataset({"f": x_bad}, input_col="f").n_rows == 10  # no scan, no raise


def test_a_row_range_scan_reports_the_absolute_row(validate_on):
    x = np.zeros((100, 2))
    x[70, 1] = np.nan
    ex = extract_dataset({"f": x}, input_col="f", validate=False)  # deferred
    validate_extracted(ex, lo=0, hi=64)  # the bad row lies outside
    with pytest.raises(IngestValidationError) as ei:
        validate_extracted(ex, lo=64, hi=100)
    assert ei.value.row == 70


def test_transform_and_bound_item_sets_scan_eagerly(validate_on):
    set_devices("cpu")
    try:
        x = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
        model = KMeans(k=2, maxIter=2, seed=1).fit({"features": x})
        bad = x.copy()
        bad[13, 0] = np.nan
        with pytest.raises(IngestValidationError, match="row 13"):
            model.transform({"features": bad})
        with pytest.raises(IngestValidationError, match="row 13"):
            NearestNeighbors(k=2).setInputCol("features").fit({"features": bad})
    finally:
        set_devices(None)
