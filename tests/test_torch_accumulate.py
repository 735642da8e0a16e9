#
# The PyTorch port's assign_accumulate kernel (csrc/assign_accumulate.cu
# through spark_rapids_ml_tpu_torch/ops/_kernels.py), in the parts a CPU can
# run:
#
#   * the kernel's decomposition, written here in torch: rows stable-sorted
#     by center, each center's segment cut into pieces of at most R rows
#     (an empty center is one empty piece), one in-order sum per piece
#     (zero weights skipped), the partials of a center of several pieces
#     folded in piece order; against the JAX package's real `_pl_accumulate`
#     run by the Pallas interpreter and against `accumulate_plain`, on a
#     balanced assignment, one center owning every row, empty centers, zero
#     weights, assignments outside [0, k) and a d that is not a multiple of
#     4: exact on integer data (f32, f64 and `fast`), rtol 1e-5 (f32 and
#     `fast`) and 1e-9 (f64) of the scale on Gaussian data;
#   * the counting sort of the index preparation, pass by pass in Python,
#     against the stable sort of the rows inside [0, k);
#   * the bounds the wrapper sizes the plan and the scratch by, the load
#     width it picks, its refusals and its check of the library's
#     constants.
#
# The `cuda`-marked tests at the end hold the kernel itself against the
# plain version (skewed and multi-piece assignments too), to determinism,
# and, for centers of one piece, to a sequential ascending sum bit for bit;
# they need the card and skip here.
#
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.ops import distance as jdist
from spark_rapids_ml_tpu_torch.ops import _kernels
from spark_rapids_ml_tpu_torch.ops import distance as tdist

R = _kernels.PIECE_ROWS


@pytest.fixture
def card():
    """A CUDA device for the kernel tests; skips on a machine without one."""
    if not torch.cuda.is_available():
        pytest.skip(
            "needs an NVIDIA GPU: the CUDA kernels have no CPU form "
            "(their decomposition is held against JAX above)"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# ------------------------------------------------------------- the data -----

# name -> (rows, centers, features)
CASES = {
    "balanced": (40, 5, 6),
    "one center": (300, 3, 5),  # 3 pieces of R = 128, 75 of R = 4
    "empty centers": (40, 9, 6),
    "zero weights": (40, 5, 6),
    "outside [0, k)": (40, 5, 6),
    "d not a multiple of 4": (37, 4, 7),
}


def _case(name, dtype, integer, seed=0):
    n, k, d = CASES[name]
    rng = np.random.default_rng(seed + n + k + d)
    if integer:  # |v| <= 4, w in 1..3: exact in bf16, every sum exact
        X = rng.integers(-4, 5, size=(n, d)).astype(dtype)
        w = rng.integers(1, 4, size=n).astype(dtype)
    else:
        X = rng.normal(size=(n, d)).astype(dtype)
        w = rng.uniform(0.5, 2.0, size=n).astype(dtype)
    a = rng.integers(0, k, size=n)
    if name == "one center":
        a[:] = 1
    elif name == "empty centers":
        a = rng.choice([0, 4, 8], size=n)
    elif name == "zero weights":
        w[rng.random(n) < 0.35] = 0
    elif name == "outside [0, k)":
        a = rng.integers(-2, k + 2, size=n)
    return X, w, a.astype(np.int32), k


# ------------------------------------------- the kernel's decomposition -----


def piece_table(assign, k, rows):
    """The plan pass in Python: [(center, first, end, alone)] over the
    stable-sorted order, every center's segment in pieces of at most `rows`
    (an empty center is one empty piece), and the sorted order itself."""
    order = torch.sort(assign, stable=True).indices
    sa = assign[order]
    table = []
    for j in range(k):
        lo = int(torch.searchsorted(sa, torch.tensor(j, dtype=sa.dtype)))
        hi = int(torch.searchsorted(sa, torch.tensor(j + 1, dtype=sa.dtype)))
        c = max(1, -(-(hi - lo) // rows))
        table += [(j, lo + q * rows, min(hi, lo + (q + 1) * rows), c == 1) for q in range(c)]
    return table, order


def pieces_accumulate(x, w, assign, k, rows, fast):
    """What the kernel computes, in torch: one running sum from 0 per piece
    over its rows in ascending order (w * x, zero weights skipped; bf16
    operands and float32 sums for `fast`), the count the ascending sum of
    w; a center of one piece takes its sums, a center of several the sum of
    its partials in piece order."""
    S = torch.float32 if fast else x.dtype
    xs, ws = (tdist._bf16(x), tdist._bf16(w)) if fast else (x, w)
    table, order = piece_table(assign, k, rows)
    sums = torch.zeros((k, x.shape[1]), dtype=S)
    counts = torch.zeros((k,), dtype=x.dtype)
    for j, lo, hi, alone in table:
        s = torch.zeros((x.shape[1],), dtype=S)
        c = torch.zeros((), dtype=x.dtype)
        for r in order[lo:hi].tolist():
            if ws[r] != 0:
                s = s + ws[r] * xs[r]
            c = c + w[r]
        if alone:
            sums[j], counts[j] = s, c
        else:
            sums[j] += s
            counts[j] += c
    return sums.to(x.dtype), counts


@functools.lru_cache(maxsize=None)
def _pallas_reference(name, dtype, integer, fast):
    """The JAX package's `_pl_accumulate` through the Pallas interpreter:
    rows padded with zero weights to its 8-row block, centers to its
    4-center block, the padding sliced away."""
    X, w, a, k = _case(name, dtype, integer)
    n, d = X.shape
    pad = -n % 8
    kp = -(-k // 4) * 4
    xp = np.concatenate([X, np.zeros((pad, d), dtype)])
    wp = np.concatenate([w, np.zeros(pad, dtype)])
    ap = np.concatenate([a, np.zeros(pad, np.int32)])
    js, jc = jdist._pl_accumulate(
        jnp.asarray(xp), jnp.asarray(wp), jnp.asarray(ap), kp,
        block_rows=8, block_k=4, fast=fast, interpret=True,
    )
    return np.asarray(js)[:k], np.asarray(jc)[:k]


def _assert_close(got, want, dtype, integer, fast):
    got, want = np.asarray(got), np.asarray(want)
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        rtol = 1e-9 if dtype == np.float64 and not fast else 1e-5
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("integer", [True, False])
def test_piece_decomposition_matches_pallas_kernel_and_plain(name, dtype, fast, integer):
    X, w, a, k = _case(name, dtype, integer)
    tx, tw, ta = torch.from_numpy(X), torch.from_numpy(w), torch.from_numpy(a)
    js, jc = _pallas_reference(name, dtype, integer, fast)
    valid = (ta >= 0) & (ta < k)
    ps, pc = tdist.accumulate_plain(tx[valid], tw[valid], ta[valid], k, fast)
    for rows in (4, R):  # several pieces per center at small shapes, and the kernel's own
        ss, cc = pieces_accumulate(tx, tw, ta, k, rows, fast)
        assert ss.dtype == tx.dtype and cc.dtype == tx.dtype
        for ref_s, ref_c in ((js, jc), (ps.numpy(), pc.numpy())):
            _assert_close(ss.numpy(), ref_s, dtype, integer, fast)
            _assert_close(cc.numpy(), ref_c, dtype, integer, False)
    if name == "empty centers":
        assert not ss[[1, 2, 3, 5, 6, 7]].any() and not cc[[1, 2, 3, 5, 6, 7]].any()


def test_decomposition_cuts_a_large_center_into_pieces():
    a = torch.tensor([1] * 300 + [0] * 5 + [2] * 128, dtype=torch.int32)
    a = a[torch.randperm(433, generator=torch.Generator().manual_seed(0))]
    table, order = piece_table(a, 4, R)
    assert [(j, hi - lo, alone) for j, lo, hi, alone in table] == [
        (0, 5, True), (1, 128, False), (1, 128, False), (1, 44, False), (2, 128, True), (3, 0, True)]
    # each piece lists its rows in ascending row order
    for _, lo, hi, _ in table:
        rows = order[lo:hi]
        assert torch.equal(rows, torch.sort(rows).values)


# --------------------------------------------- the wrapper's sizing -----


@pytest.mark.parametrize("B,k", [(1, 1), (128, 1), (129, 1), (32768, 1000), (1000, 7), (257, 3), (0, 5)])
@pytest.mark.parametrize("kind", ["balanced", "one center", "two large"])
def test_plan_bounds_hold_every_piece_table(B, k, kind):
    rng = np.random.default_rng(B + k)
    a = rng.integers(-1, k + 1, size=B)
    if kind == "one center":
        a[:] = k - 1
    elif kind == "two large":
        a[: B // 2] = 0
    table, _ = piece_table(torch.from_numpy(a.astype(np.int32)), k, R)
    n_pieces, n_multi = _kernels.plan_bounds(B, k)
    assert len(table) <= n_pieces == k + -(-B // R)
    assert len({j for j, _, _, alone in table if not alone}) <= n_multi == B // (R + 1)


@pytest.mark.parametrize("B,k,counting", [(32768, 1000, True), (5, 3, True), (0, 4, True), (300, 20000, False)])
def test_plan_buffer_views(B, k, counting):
    n_pieces, n_multi = _kernels.plan_bounds(B, k)
    plan, hist = _kernels._plan_buffer(B, k, "cpu", counting)
    assert plan.pieces.shape == (n_pieces, 4) and plan.pieces.data_ptr() % 16 == 0
    assert plan.first.shape == (k + 1,) and plan.multi.shape == (n_multi,)
    assert plan.totals.shape == (2,) and plan.order.shape == (B,)
    chunks = -(-B // _kernels.COUNT_ROWS) if counting else 0
    assert hist.shape == (chunks * k,)
    assert all(t.dtype == torch.int32 for t in (*plan, hist))
    assert (k <= _kernels.COUNT_CENTERS) == counting  # the route the wrapper takes


def counting_order(assign, k, chunk):
    """The counting sort in Python, pass by pass: per chunk of rows each
    center's count; each center's rows after all earlier centers' and, in
    it, each chunk's after the earlier chunks'; each chunk's rows placed in
    ascending order, 32 at a time with ranks among equal centers."""
    a = assign.tolist()
    chunks = [a[c:c + chunk] for c in range(0, len(a), chunk)]
    hist = [[sum(1 for j in part if j == c) for c in range(k)] for part in chunks]
    pos, start = [[0] * k for _ in chunks], 0
    for j in range(k):
        for c in range(len(chunks)):
            pos[c][j], start = start, start + hist[c][j]
    order = [None] * start
    for c, part in enumerate(chunks):
        for g in range(0, len(part), 32):
            group = part[g:g + 32]
            for lane, j in enumerate(group):
                if 0 <= j < k:
                    rank = sum(1 for i in group[:lane] if i == j)
                    order[pos[c][j] + rank] = c * chunk + g + lane
            for j in set(group):
                if 0 <= j < k:
                    pos[c][j] += group.count(j)
    return torch.tensor(order, dtype=torch.int64)


@pytest.mark.parametrize("name", ["balanced", "one center", "outside [0, k)"])
def test_counting_sort_is_the_stable_sort_of_rows_in_range(name):
    _, _, a, k = _case(name, np.float32, True)
    ta = torch.from_numpy(a)
    valid = torch.nonzero((ta >= 0) & (ta < k)).flatten()
    want = valid[torch.sort(ta[valid], stable=True).indices]
    for chunk in (64, _kernels.COUNT_ROWS):
        assert torch.equal(counting_order(ta, k, chunk), want)


def test_load_width_is_chosen_by_alignment_never_assumed():
    assert _kernels._accumulate_vec(torch.zeros((4, 3000)))
    assert _kernels._accumulate_vec(torch.zeros((4, 3000), dtype=torch.float64))
    assert _kernels._accumulate_vec(torch.zeros((8, 3000))[3:])  # a row tile of X
    assert not _kernels._accumulate_vec(torch.zeros((4, 77)))
    assert not _kernels._accumulate_vec(torch.zeros((4, 2)))  # 8-byte rows
    assert not _kernels._accumulate_vec(torch.zeros(65)[1:].view(4, 16))  # base 4 bytes past 16


def test_wrapper_refusals_count_no_launch():
    x = torch.zeros((4, 3))
    w = torch.ones(4)
    a = torch.zeros(4, dtype=torch.int32)
    before = _kernels.launch_total("assign_accumulate")
    cases = [
        ((x, w.double(), a, 2), "w must have x's dtype"),
        ((x, w, a.long(), 2), "assign must be int32"),
        ((x.half(), w.half(), a, 2), "float32 or float64"),
        ((x[0], w, a, 2), r"x \[B,d\], w \[B\], assign \[B\]"),
        ((x, w[:3], a, 2), "disagree on rows"),
        ((x, w, a, 0), "needs k > 0"),
        ((x, w, a, 2), "CUDA tensor"),
    ]
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            _kernels.assign_accumulate(*args)
        with pytest.raises(ValueError, match=match):
            _kernels.assign_accumulate(*args, fast=True)
    # rows past the pieces' int32 bounds
    xb = torch.empty((2**31 - 64, 1), device="meta")
    with pytest.raises(ValueError, match="fit int32"):
        _kernels.assign_accumulate(xb, torch.empty(2**31 - 64, device="meta"),
                                   torch.empty(2**31 - 64, dtype=torch.int32, device="meta"), 3)
    assert _kernels.launch_total("assign_accumulate") == before


def test_library_constants_must_match_the_wrapper():
    good = [R, _kernels.COUNT_CENTERS, _kernels.COUNT_ROWS]
    _kernels._check_accumulate_config(lambda i: good[i])
    for i in range(3):
        bad = list(good)
        bad[i] *= 2
        with pytest.raises(RuntimeError, match="disagree"):
            _kernels._check_accumulate_config(lambda j, bad=bad: bad[j])


# ------------------------------------------- the CUDA kernel, on the card ----


def _card_case(kind, n, k, d, dtype, integer, seed):
    rng = np.random.default_rng(seed)
    if integer:
        X = rng.integers(-4, 5, size=(n, d)).astype(dtype)
        w = rng.integers(1, 4, size=n).astype(dtype)
    else:
        X = rng.normal(size=(n, d)).astype(dtype)
        w = rng.uniform(0.5, 2.0, size=n).astype(dtype)
    if kind == "one center":
        a = np.full(n, k // 2)
    elif kind == "zipf":
        p = np.arange(1, k + 1, dtype=np.float64) ** -1.1
        a = rng.permutation(k)[rng.choice(k, size=n, p=p / p.sum())]
    else:  # edges: empty centers, zero weights, assignments outside [0, k)
        a = rng.integers(0, k, size=n)
        a[(a >= k // 3) & (a < k // 2)] = 0
        out = rng.random(n) < 0.125
        a[out] = rng.choice([-7, -1, k, k + 3], size=int(out.sum()))
        w[rng.random(n) < 0.125] = 0
    return X, w, a.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["f32", "f32-fast", "f64", "f64-fast"])
@pytest.mark.parametrize("kind", ["one center", "zipf", "edges"])
@pytest.mark.parametrize("n,k,d", [(4096, 100, 300), (1000, 7, 77), (333, 64, 130)])
def test_kernel_matches_plain_version_on_card(card, variant, kind, n, k, d):
    dtype = np.float64 if variant.startswith("f64") else np.float32
    fast = variant.endswith("fast")
    X, w, a = _card_case(kind, n, k, d, dtype, True, n + k + d)
    x, wt, at = (torch.from_numpy(v).to(card) for v in (X, w, a))
    before = _kernels.launches[f"assign_accumulate/{variant}"]
    s1, n1 = _kernels.assign_accumulate(x, wt, at, k, fast=fast)
    s2, n2 = _kernels.assign_accumulate(x, wt, at, k, fast=fast)
    assert _kernels.launches[f"assign_accumulate/{variant}"] == before + 2  # one count per call
    assert torch.equal(s1, s2) and torch.equal(n1, n2)  # deterministic
    valid = (at >= 0) & (at < k)
    s0, n0 = tdist.accumulate_plain(x[valid], wt[valid], at[valid], k, fast)
    assert torch.equal(s1, s0) and torch.equal(n1, n0)  # integer data: exact


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["f32", "f32-fast", "f64-fast"])
def test_one_piece_centers_sum_in_ascending_order_on_card(card, variant):
    # every center has fewer than R rows, so each is one piece: its sums are
    # one running sum from 0 in ascending row order, s = fma(w, x, s). For
    # `fast` the bf16 products are exact in float32, so a float32 s + w*x is
    # that fma; for f32 the fma is formed in float64 (the product is exact
    # there) and rounded once to float32
    dtype = np.float64 if variant.startswith("f64") else np.float32
    fast = variant.endswith("fast")
    rng = np.random.default_rng(12)
    n, k, d = 3000, 60, 260
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(dtype)).to(card)
    w = torch.from_numpy(rng.uniform(0.5, 2.0, size=n).astype(dtype)).to(card)
    a = torch.from_numpy(rng.integers(0, k, size=n).astype(np.int32)).to(card)
    assert int(torch.bincount(a.long()).max()) < R
    sums, counts = _kernels.assign_accumulate(x, w, a, k, fast=fast)
    xs, ws = (tdist._bf16(x), tdist._bf16(w)) if fast else (x, w)
    order = torch.sort(a, stable=True).indices
    seg = torch.searchsorted(a[order], torch.arange(k + 1, dtype=torch.int32, device=card))
    want = torch.zeros((k, d), dtype=xs.dtype, device=card)
    cnt = torch.zeros((k,), dtype=x.dtype, device=card)
    for t in range(int((seg[1:] - seg[:-1]).max())):
        has = seg[:-1] + t < seg[1:]
        j = torch.nonzero(has).flatten()
        r = order[seg[:-1][j] + t]
        if variant == "f32":
            want[j] = (want[j].double() + ws[r, None].double() * xs[r].double()).float()
        else:
            want[j] = want[j] + ws[r, None] * xs[r]
        cnt[j] = cnt[j] + w[r]
    assert torch.equal(sums, want.to(x.dtype)) and torch.equal(counts, cnt)
