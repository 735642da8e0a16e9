#
# The PyTorch port's forest operations (spark_rapids_ml_tpu_torch/ops/
# prng.py and ops/trees.py) against the JAX package's (jax.random and
# spark_rapids_ml_tpu/ops/trees.py) on the same inputs, made with numpy
# from a seed. The port runs on the CPU; the JAX side on its CPU devices,
# float64 enabled (tests/conftest.py), its forest on a one-device mesh. No
# Pallas kernel is on this path in the JAX package.
#
# Tolerances, and why:
#   * ops/prng.py: bit for bit. It is the same integer hash (threefry-2x32,
#     20 rounds) on the same counters, and the same bit layout of a float;
#   * quantile_bins and bin_features: exactly equal. The sketch is the same
#     numpy code on the same sample; binning compares values with edges,
#     and a comparison has one answer (±inf and NaN included: NaN lands
#     past the last edge on both sides);
#   * _split_gains on integer histograms: rtol 1e-6 of the node
#     impurities (a gain is the parent's impurity less its children's, so
#     its rounding is theirs), with the −inf pattern (invalid splits) and
#     the node totals exactly equal. The formulas are the same, op by op,
#     but XLA may fuse them and evaluates log2 with its own approximation
#     (entropy), so the last bits may differ; 1e-6 is eight float32 ulps;
#   * _feature_subset_ids, one _tree_level, forest_fit without the
#     bootstrap: exactly equal. The subsets come from the same uniform bits
#     and a stable sort; the histograms of integer statistics are exact on
#     both sides (below 2^24), so the gains are computed from the same
#     numbers and the first argmax agrees;
#   * the bootstrap draw: the port's formula holds exactly on JAX's own
#     uniform; its draws agree with jax.random.choice's on at least 99% of
#     draws (they part only where the float32 cumulative sum of the
#     probabilities moves a boundary past u; observed: none of 5000); the
#     counts sum to n_draws, vanish on rows of zero weight, and average 1
#     per valid row with the multinomial's variance (1 − 1/V) and share of
#     empty rows (≈ e⁻¹) within 5 standard errors;
#   * forest_raw_predict: rtol 1e-6 against jnp.mean over the trees (the
#     port sums in tree order, XLA in its own), exactly with one tree
#     (the descent itself has one answer), and bit for bit against itself
#     on any batch of the same rows;
#   * the fixed-point histograms: integer statistics exact; real ones
#     within the bound `_fixed_point` states; node chunks and row tiles
#     change nothing, bit for bit.
#
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from spark_rapids_ml_tpu.models.tree import resolve_max_features as jax_resolve_max_features
from spark_rapids_ml_tpu.ops import trees as jtrees
from spark_rapids_ml_tpu.parallel.mesh import ROWS_AXIS, get_mesh, shard_map
from spark_rapids_ml_tpu_torch.models.tree import resolve_max_features
from spark_rapids_ml_tpu_torch.ops import prng
from spark_rapids_ml_tpu_torch.ops import trees as ttrees

SEEDS = [0, 1, 2**31 - 1, 2**40]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _words(key):
    return np.asarray(key).astype(np.int64)


def _keys(seed, *folds):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for f in folds:
        jk, tk = jax.random.fold_in(jk, f), prng.fold_in(tk, f)
    return jk, tk


# ------------------------------------------------------------- ops/prng ----


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_and_split_match_jax(seed):
    jk, tk = _keys(seed)
    np.testing.assert_array_equal(tk.numpy(), _words(jk))
    for data in (0, 1, 7919, 7919 + 12, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(tk, data).numpy(), _words(jax.random.fold_in(jk, data)))
    for num in (2, 5):
        np.testing.assert_array_equal(prng.split(tk, num).numpy(), _words(jax.random.split(jk, num)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_matches_jax_bit_for_bit(seed, dtype):
    jk, tk = _keys(seed, 3)
    for shape in ((1,), (7,), (64, 33), (3, 5, 4)):
        want = np.asarray(jax.random.uniform(jk, shape, dtype=getattr(jnp, dtype)))
        got = prng.uniform(tk, shape, getattr(torch, dtype)).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
        assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_and_permutation_match_jax(seed):
    jk, tk = _keys(seed, 11)
    want32 = np.asarray(jax.random.bits(jk, (100,), dtype=jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(prng.random_bits(tk, 32, (100,)).numpy(), want32)
    want64 = np.asarray(jax.random.bits(jk, (100,), dtype=jnp.uint64))
    np.testing.assert_array_equal(prng.random_bits(tk, 64, (100,)).numpy().view(np.uint64), want64)
    # 1625 is the last size of one sort round (n^3 < 2^32); 1700 takes two
    for n in (1, 2, 100, 1625, 1700):
        np.testing.assert_array_equal(prng.permutation(tk, n).numpy(), np.asarray(jax.random.permutation(jk, n)))
    with pytest.raises(ValueError, match="bit_width"):
        prng.random_bits(tk, 16, (3,))


# ---------------------------------------------------------------- binning ----


@pytest.mark.parametrize("n,cap,d", [(500, 100_000, 7), (3000, 1000, 7), (2000, 1500, 61)],
                         ids=["all-rows", "sampled", "wide"])
def test_quantile_bins_match_jax(n, cap, d):
    # the port takes the columns in runs on several cores; JAX's one call
    x = np.random.default_rng(1).normal(size=(n, d)).astype(np.float32)
    x[::17, 2] = 0.5  # ties
    x[5, 3] = np.nan
    for max_bins in (2, 16, 64):
        np.testing.assert_array_equal(ttrees.quantile_bins(x, max_bins, sample_cap=cap, seed=3),
                                      jtrees.quantile_bins(x, max_bins, sample_cap=cap, seed=3))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("max_bins", [16, 300], ids=["uint8", "int32"])
def test_bin_features_match_jax_on_edges_inf_and_nan(dtype, max_bins, monkeypatch):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(600, 6))
    edges = jtrees.quantile_bins(x, max_bins).astype(np.float32)
    probe = np.concatenate([
        x, edges.T, np.nextafter(edges.T, np.float32(np.inf)), np.nextafter(edges.T, np.float32(-np.inf)),
        np.full((5, 6), [[np.inf], [-np.inf], [np.nan], [0.0], [-0.0]]),
    ]).astype(dtype)
    want = np.asarray(jtrees.bin_features(jnp.asarray(probe), jnp.asarray(edges)))
    got = ttrees.bin_features(_t(probe), _t(edges))
    assert got.dtype == (torch.uint8 if max_bins <= 256 else torch.int32)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want.astype(np.int64))
    assert (got.numpy()[-3] == edges.shape[1]).all()  # NaN past the last edge
    # row tiles of one row each: the same ids
    monkeypatch.setattr(ttrees, "BIN_TILE_BYTES", 1)
    np.testing.assert_array_equal(ttrees.bin_features(_t(probe), _t(edges)).numpy(), got.numpy())


# ----------------------------------------------------------- split gains ----


def _hist(rng, impurity, S, C, d, B, rows=400):
    """An integer histogram [S, C, d, B] from integer rows: class counts, or
    (w, wy, wyy) of integer labels; node 0 empty."""
    node = rng.integers(1, C, size=rows)
    bins = rng.integers(0, B, size=(rows, d))
    if impurity == "variance":
        y = rng.integers(-4, 5, size=rows).astype(np.float64)
        stats = np.stack([np.ones(rows), y, y * y], axis=1)
    else:
        stats = np.eye(S)[rng.integers(0, S, size=rows)]
    hist = np.zeros((S, C, d, B))
    for f in range(d):
        np.add.at(hist, (slice(None), node, f, bins[:, f]), stats.T)
    return hist


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("min_instances", [1.0, 6.0])
@pytest.mark.parametrize("impurity,S", [("gini", 2), ("gini", 3), ("entropy", 3), ("variance", 3)])
def test_split_gains_match_jax(impurity, S, min_instances, dtype):
    hist = _hist(np.random.default_rng(S + int(min_instances)), impurity, S, 5, 4, 12).astype(dtype)
    jg, jtot = (np.asarray(a) for a in jtrees._split_gains(jnp.asarray(hist), impurity, min_instances))
    tg, ttot = (a.numpy() for a in ttrees._split_gains(_t(hist), impurity, min_instances))
    assert tg.dtype == jg.dtype == dtype
    np.testing.assert_array_equal(ttot, jtot)
    np.testing.assert_array_equal(np.isneginf(tg), np.isneginf(jg))
    finite = np.isfinite(jg)
    assert finite.any() and np.isfinite(tg[finite]).all()
    # a gain is the parent's impurity less its children's: its rounding is
    # that of the impurities, the operands of the last subtraction
    tot = jtot.astype(np.float64)
    if impurity == "variance":
        w = np.maximum(tot[:, 0], 1e-30)
        node_imp = (tot[:, 2] - tot[:, 1] ** 2 / w) / w
    else:
        p = tot / np.maximum(tot.sum(axis=1, keepdims=True), 1e-30)
        node_imp = 1 - (p * p).sum(axis=1) if impurity == "gini" else -(p * np.log2(np.where(p > 0, p, 1))).sum(axis=1)
    scale = max(np.abs(jg[finite]).max(), np.abs(node_imp).max())
    np.testing.assert_allclose(tg[finite], jg[finite], rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("n_nodes,d,m", [(1, 5, 2), (8, 12, 3), (16, 40, 6), (4, 7, 7), (4, 7, 9)])
@pytest.mark.parametrize("seed", [0, 2**40])
def test_feature_subset_ids_match_jax(n_nodes, d, m, seed):
    jk, tk = _keys(seed, 1, 7919 + 2)
    want = np.asarray(jtrees._feature_subset_ids(jk, n_nodes, d, m))
    got = ttrees._feature_subset_ids(tk, n_nodes, d, m).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("strategy", ["auto", "all", "sqrt", "log2", "onethird", "0.5", "1.0", "1", "3", "99"])
@pytest.mark.parametrize("is_classification", [True, False])
def test_resolve_max_features_matches_jax(strategy, is_classification):
    for d in (1, 7, 3000):
        assert resolve_max_features(strategy, d, is_classification) == \
            jax_resolve_max_features(strategy, d, is_classification)
    with pytest.raises(ValueError, match="featureSubsetStrategy"):
        resolve_max_features("half", 10, is_classification)


# ----------------------------------------------------------- fixed point ----


def test_fixed_point_is_exact_on_integers_and_bounded_on_reals():
    rng = np.random.default_rng(4)
    counts = rng.integers(0, 9, size=(1000, 3)).astype(np.float32)
    ints, scale = ttrees._fixed_point(_t(counts))
    np.testing.assert_array_equal(ints.numpy() * scale.numpy(), counts)
    assert (scale.numpy() <= 1.0).all()
    y = rng.normal(size=1000) * 1e3
    reals = np.stack([np.ones(1000), y, y * y], axis=1)
    ints, scale = ttrees._fixed_point(_t(reals))
    for s in range(3):
        col = ints.numpy()[:, s].astype(object)
        # every partial sum fits in 62 bits, and the sum is within the
        # rounding of each value (half a unit of 2^q)
        assert np.abs(np.cumsum(col)).max() < 2**62
        got = float(sum(col)) * float(scale[s])
        assert abs(got - math.fsum(reals[:, s])) <= 1000 * 0.5 * float(scale[s])
    with pytest.raises(ValueError, match="finite"):
        ttrees._fixed_point(_t(np.array([[1.0, np.nan]])))


# ------------------------------------------------------------ one level ----


def _jax_level(key, xb, stats, node_id, active, feature, split_bin, node_stats, params, depth):
    """The JAX package's `_tree_level` on a one-device mesh, as forest_fit
    runs it (the tree arrays with a leading device axis)."""
    mesh = get_mesh(1)

    def fn(xb_l, st_l, nid_l, act_l, f_b, b_b, s_b):
        nid, act, f, b, s = jtrees._tree_level(key, xb_l, st_l, nid_l, act_l, f_b[0], b_b[0], s_b[0], params, depth)
        return nid, act, f[None], b[None], s[None]

    rows = P(ROWS_AXIS)
    step = jax.jit(shard_map(
        fn, mesh=mesh,
        in_specs=(P(ROWS_AXIS, None), P(ROWS_AXIS, None), rows, rows, P(ROWS_AXIS, None), P(ROWS_AXIS, None),
                  P(ROWS_AXIS, None, None)),
        out_specs=(rows, rows, P(ROWS_AXIS, None), P(ROWS_AXIS, None), P(ROWS_AXIS, None, None)),
    ))
    out = step(jnp.asarray(xb), jnp.asarray(stats), jnp.asarray(node_id), jnp.asarray(active), jnp.asarray(feature[None]),
               jnp.asarray(split_bin[None]), jnp.asarray(node_stats[None]))
    nid, act, f, b, s = (np.asarray(a) for a in out)
    return nid, act, f[0], b[0], s[0]


@pytest.mark.parametrize("impurity", ["gini", "entropy", "variance"])
def test_one_tree_level_matches_jax(impurity, monkeypatch):
    rng = np.random.default_rng(5)
    n, d, B, depth = 500, 10, 16, 2
    xb = rng.integers(0, B, size=(n, d)).astype(np.uint8)
    if impurity == "variance":
        y = rng.integers(-3, 4, size=n).astype(np.float32)
        stats = np.stack([np.ones(n), y, y * y], axis=1).astype(np.float32)
    else:
        stats = np.eye(3, dtype=np.float32)[rng.integers(0, 3, size=n)]
    stats[rng.random(n) < 0.1] = 0.0  # rows drawn 0 times
    M = 2 ** (depth + 2) - 1
    node_id = rng.integers(3, 7, size=n).astype(np.int32)
    active = rng.random(n) < 0.8
    feature = np.full(M, -1, np.int32)
    feature[:3] = [0, 1, 2]
    split_bin = np.zeros(M, np.int32)
    node_stats = np.zeros((M, 3), np.float32)
    params = {"max_bins": B, "node_chunk": 2, "max_features": 4, "impurity": impurity,
              "min_instances": 2.0, "min_info_gain": 0.0}
    jk, tk = _keys(9, 0, 7919 + depth)
    jn, ja, jf, jb, js = _jax_level(jk, xb, stats, node_id, active, feature, split_bin, node_stats, params, depth)
    for budget in (ttrees.HIST_BUDGET, 4 * B * 3):  # one chunk; chunks of one node
        monkeypatch.setattr(ttrees, "HIST_BUDGET", budget)
        keep = np.nonzero(active & (stats != 0).any(axis=1))[0]
        vals, scale = ttrees._fixed_point(_t(stats[keep]))
        f, b, s = _t(feature.astype(np.int64)), _t(split_bin.astype(np.int64)), _t(node_stats)
        rows, nid, _ = ttrees._tree_level(tk, _t(xb), _t(keep), _t(node_id[keep].astype(np.int64)), vals, scale,
                                          f, b, s, params, depth)
        np.testing.assert_array_equal(f.numpy(), jf)
        np.testing.assert_array_equal(b.numpy(), jb)
        np.testing.assert_array_equal(s.numpy(), js)
        # the rows sent on (in node order where the nodes were chunked) are
        # JAX's active rows with statistics, at JAX's nodes
        np.testing.assert_array_equal(np.sort(rows.numpy()), np.nonzero(ja & (stats != 0).any(axis=1))[0])
        np.testing.assert_array_equal(nid.numpy(), jn[rows.numpy()])
    assert (jf[3:7] >= 0).any()


# ------------------------------------------------------------- the forest ----


def _forest_inputs(impurity, n=600, d=12, B=16, seed=6):
    rng = np.random.default_rng(seed)
    xb = rng.integers(0, B, size=(n, d)).astype(np.uint8)
    # labels that depend on the bins, so trees have splits worth taking
    score = xb[:, 0].astype(np.int64) + xb[:, 1] // 2 + rng.integers(0, 6, size=n)
    if impurity == "variance":
        y = (score // 3).astype(np.float32)
        stats = np.stack([np.ones(n), y, y * y], axis=1).astype(np.float32)
    else:
        stats = np.eye(3, dtype=np.float32)[score % 3]
    w = np.ones(n, np.float32)
    w[::11] = 0.0
    return xb, stats * w[:, None], w


def _jax_forest(xb, stats, w, seed, **kw):
    mesh = get_mesh(1)
    dev = mesh.devices.flatten()[0]
    out = jtrees.forest_fit(jax.device_put(xb, dev), jax.device_put(stats, dev), jax.device_put(w, dev), seed,
                            mesh=mesh, **kw)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("strategy,impurity,rate", [
    ("all", "gini", 1.0), ("auto", "entropy", 1.0), ("sqrt", "variance", 1.0), ("onethird", "variance", 1.0),
    ("0.5", "gini", 1.0), ("3", "entropy", 1.0), ("auto", "gini", 0.6),
])
def test_forest_fit_without_bootstrap_matches_jax(strategy, impurity, rate):
    xb, stats, w = _forest_inputs(impurity)
    kw = dict(n_trees=2, max_depth=3, max_bins=16, impurity=impurity, bootstrap=False, subsample_rate=rate,
              max_features=resolve_max_features(strategy, xb.shape[1], impurity != "variance"))
    want = _jax_forest(xb, stats, w, 3, **kw)
    got = ttrees.forest_fit(_t(xb), _t(stats), _t(w), 3, **kw)
    for k in ("feature", "split_bin", "node_stats"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["feature"][:, 0] >= 0).all()


def test_forest_does_not_depend_on_node_chunks_or_row_tiles(monkeypatch):
    xb, stats, w = _forest_inputs("variance", n=800)
    stats = stats * np.random.default_rng(7).uniform(0.5, 2.0, size=(800, 1)).astype(np.float32)  # real-valued
    kw = dict(n_trees=2, max_depth=4, max_bins=16, max_features=5, impurity="variance", bootstrap=True,
              min_instances=1.0)
    whole = ttrees.forest_fit(_t(xb), _t(stats), _t(w), 8, **kw)
    monkeypatch.setattr(ttrees, "HIST_BUDGET", 2 * 5 * 16 * 3)
    monkeypatch.setattr(ttrees, "PAIR_BUDGET", 37)
    pieces = ttrees.forest_fit(_t(xb), _t(stats), _t(w), 8, **kw)
    for k in whole:
        np.testing.assert_array_equal(pieces[k], whole[k], err_msg=k)


# ------------------------------------------------------ the bootstrap draw ----


def _boot_case(n=5000, seed=12):
    w = np.ones(n, np.float32)
    w[-5:] = 0.0  # the last rows carry no weight
    w[::97] = 0.0
    jk, tk = _keys(seed, 4)
    return w, jk, tk


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bootstrap_draw_is_the_formula_on_jax_uniform(dtype):
    w, jk, tk = _boot_case()
    n = len(w)
    valid = np.nonzero(w > 0)[0]
    u = np.asarray(jax.random.uniform(jax.random.split(jk)[0], (n,), dtype=getattr(jnp, dtype)))
    rank = np.clip(np.ceil((1.0 - u).astype(np.float64) * len(valid)).astype(np.int64), 1, len(valid))
    want = np.bincount(valid[rank - 1], minlength=n)
    got = ttrees.tree_weights(tk, _t(w), getattr(torch, dtype), bootstrap=True, subsample_rate=1.0)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def test_bootstrap_draws_agree_with_jax_choice_and_follow_the_law():
    w, jk, tk = _boot_case()
    n = len(w)
    valid = np.nonzero(w > 0)[0]
    V = len(valid)
    p = (w > 0).astype(np.float32) / np.float32(V)
    k1 = jax.random.split(jk)[0]
    jax_draws = np.asarray(jax.random.choice(k1, n, (n,), replace=True, p=jnp.asarray(p)))
    u = np.asarray(jax.random.uniform(k1, (n,), dtype=jnp.float32))
    port_draws = valid[np.clip(np.ceil((1.0 - u).astype(np.float64) * V).astype(np.int64), 1, V) - 1]
    assert np.mean(port_draws == jax_draws) >= 0.99
    counts = ttrees.tree_weights(tk, _t(w), torch.float32, bootstrap=True, subsample_rate=1.0).numpy()
    np.testing.assert_array_equal(counts, np.bincount(port_draws, minlength=n))
    assert counts.sum() == n and (counts[w == 0] == 0).all()
    c = counts[valid]
    # multinomial(n, 1/V) per row: mean n/V, variance n/V·(1 − 1/V), P(0) =
    # (1 − 1/V)^n; 5 standard errors of each estimate
    mean, var, empty = n / V, n / V * (1 - 1 / V), (1 - 1 / V) ** n
    assert abs(c.mean() - mean) < 1e-12
    assert abs(c.var() - var) < 5 * math.sqrt(2.0 / V) * var + 5 * math.sqrt(1.0 / V)
    assert abs(np.mean(c == 0) - empty) < 5 * math.sqrt(empty * (1 - empty) / V)


def test_subsample_without_bootstrap_is_jax_permutation():
    w, jk, tk = _boot_case(n=3000)
    n_draws = int(round(0.3 * len(w)))
    got = ttrees.tree_weights(tk, _t(w), torch.float32, bootstrap=False, subsample_rate=0.3).numpy()
    want_rows = np.asarray(jax.random.choice(jax.random.split(jk)[0], len(w), (n_draws,), replace=False))
    assert got.sum() == n_draws and set(np.nonzero(got)[0]) == set(want_rows.tolist())
    assert ttrees.tree_weights(tk, _t(w), torch.float32, bootstrap=False, subsample_rate=1.0).numpy().min() == 1.0


# ----------------------------------------------------------- prediction ----


def _random_forest(rng, T, depth, d, S, x):
    M = 2 ** (depth + 1) - 1
    feature = rng.integers(0, d, size=(T, M)).astype(np.int32)
    feature[:, 2 ** depth - 1:] = -1
    feature[rng.random((T, M)) < 0.15] = -1
    threshold = np.quantile(x, rng.uniform(0.1, 0.9, size=(T, M)), axis=0)  # [T, M, d]
    threshold = np.take_along_axis(threshold, np.maximum(feature, 0)[..., None], axis=2)[..., 0]
    threshold = np.where(feature >= 0, threshold, np.inf).astype(x.dtype)
    leaves = rng.random((T, M, S)).astype(x.dtype)
    return feature, threshold, leaves


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_forest_raw_predict_matches_jax_and_is_batch_independent(dtype):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(700, 8)).astype(dtype)
    feature, threshold, leaves = _random_forest(rng, 5, 4, 8, 3, x)
    x[:40, feature[0, 0]] = threshold[0, 0]  # rows on a threshold go left
    args = (feature, threshold, leaves)
    want = np.asarray(jtrees.forest_raw_predict(jnp.asarray(x), *map(jnp.asarray, args), max_depth=4))
    got = ttrees.forest_raw_predict(_t(x), _t(feature.astype(np.int64)), _t(threshold), _t(leaves), max_depth=4)
    assert got.dtype == _t(x).dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    one = [a[:1] for a in args]
    np.testing.assert_array_equal(
        ttrees.forest_raw_predict(_t(x), _t(one[0].astype(np.int64)), _t(one[1]), _t(one[2]), max_depth=4).numpy(),
        np.asarray(jtrees.forest_raw_predict(jnp.asarray(x), *map(jnp.asarray, one), max_depth=4)))
    for lo, n in ((0, 1), (5, 7), (130, 257), (0, 700)):
        part = ttrees.forest_raw_predict(_t(x[lo:lo + n]), _t(feature.astype(np.int64)), _t(threshold), _t(leaves),
                                         max_depth=4)
        np.testing.assert_array_equal(part.numpy(), got.numpy()[lo:lo + n])


def test_split_bins_to_thresholds_matches_jax():
    rng = np.random.default_rng(9)
    edges = np.sort(rng.normal(size=(6, 15)), axis=1)
    feature = rng.integers(-1, 6, size=(3, 31)).astype(np.int32)
    split_bin = rng.integers(0, 16, size=(3, 31)).astype(np.int32)
    np.testing.assert_array_equal(ttrees.split_bins_to_thresholds(feature, split_bin, edges),
                                  jtrees.split_bins_to_thresholds(feature, split_bin, edges))
