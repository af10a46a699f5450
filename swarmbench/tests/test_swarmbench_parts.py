"""The benchmark's parts on the CPU: generator, text, operation count,
trace arithmetic, reference against the program, imports."""

import ast
import importlib.util
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import REPO, SCORING, small_traffic
from swarmbench import check, corpus, text, trace
from swarmbench.generators import reads
from swarmbench.harness import Run, metric_reader
from swarmbench.references import d2 as reference

BENCH = REPO / "swarmbench"
CONFIG = {"d": 2, "scoring": SCORING, "outputs": ["-o", "-s", "-i", "-w"]}


def np_edit(v, op, pos_u, shift, base, min_len):
    """corpus._edit's rule, one row (numpy)."""
    p = int(pos_u * len(v))
    if op == 0:
        v = v.copy()
        v[p] = (v[p] + shift) % 4
        return v
    if op == 1 and len(v) > min_len:
        return np.delete(v, p)
    return np.insert(v, p, base)


def test_edit_matches_row_rule():
    g = torch.Generator().manual_seed(4)
    N, W = 400, 40
    lens = torch.randint(8, 30, (N,), generator=g)
    rows = torch.randint(0, 4, (N, W), generator=g).to(torch.uint8)
    op = torch.randint(0, 3, (N,), generator=g)
    pos_u = torch.rand(N, generator=g)
    shift = torch.randint(1, 4, (N,), generator=g).to(torch.uint8)
    base = torch.randint(0, 4, (N,), generator=g).to(torch.uint8)
    active = torch.rand(N, generator=g) < 0.8
    out, out_lens = corpus._edit(rows, lens, op, pos_u, shift, base,
                                 active, 10)
    for i in range(N):
        v = rows[i, :lens[i]].numpy()
        want = np_edit(v, int(op[i]), float(pos_u[i]), int(shift[i]),
                       int(base[i]), 10) if active[i] else v
        assert int(out_lens[i]) == len(want)
        assert np.array_equal(out[i, :len(want)].numpy(), want)


def test_log_series_and_error_counts_follow_their_laws():
    from math import exp, factorial, log

    g = torch.Generator().manual_seed(8)
    x = 0.999
    draws = reads.log_series(400_000, x, g, "cpu")
    for k in (1, 2, 3, 10):
        want = -x ** k / (k * log(1 - x))
        assert float((draws == k).double().mean()) == pytest.approx(
            want, rel=0.05)
    lam = torch.full((400_000,), 0.25, dtype=torch.float64)
    count = reads.error_counts(lam, 6, g)
    for k in (1, 2, 3):
        want = exp(-0.25) * 0.25 ** k / factorial(k) / (1 - exp(-0.25))
        assert float((count == k).double().mean()) == pytest.approx(
            want, rel=0.05)
    assert int(count.min()) == 1 and int(count.max()) <= 6


def test_dereplicate_sums_counts_in_row_order():
    rows = torch.tensor([[1, 2, 0], [1, 2, 3], [1, 2, 0], [0, 0, 0],
                         [1, 2, 3]], dtype=torch.uint8)
    lens = torch.tensor([2, 3, 2, 3, 3])
    first, ab = corpus.dereplicate(rows, lens, torch.tensor([4, 1, 1, 2, 1]))
    assert first.tolist() == [0, 1, 3]
    assert ab.tolist() == [5, 2, 2]


@pytest.mark.parametrize("traffic", ["reads-150nt-500k", "reads-253nt-300k",
                                     "reads-150nt-1m"])
def test_corpus_seeded_dereplicated_shaped(traffic):
    params = small_traffic(traffic, 3000)
    a = reads.make_corpus(params, 2 ** 33 + 7)
    b = reads.make_corpus(params, 2 ** 33 + 7)
    c = reads.make_corpus(params, 2 ** 33 + 8)
    assert a.n == 3000
    assert torch.equal(a.codes, b.codes) and torch.equal(a.labels, b.labels)
    assert torch.equal(a.abundances, b.abundances)
    assert not torch.equal(a.codes[:50], c.codes[:50])
    rows = {bytes(a.codes[i, :a.lengths[i]].numpy()) for i in range(a.n)}
    assert len(rows) == a.n  # dereplicated
    assert sorted(a.labels.tolist()) == list(range(a.n))
    lo, hi = params["true_length"]
    most = params["errors"]["most"]
    assert int(a.lengths.min()) >= lo - most
    assert int(a.lengths.max()) <= hi + most
    # abundances dominated by ones; each read once (1) beside a more
    # abundant amplicon a few edits away, the centre of its cloud
    single = a.abundances == 1
    assert 0.6 < float(single.double().mean()) < 0.97
    assert int(a.abundances.max()) > 100
    pa, pb = reference.candidate_pairs(a.codes, a.lengths, 3)
    ed = reference.edit_distance(a.codes, a.lengths, pa, pb, 3)
    pa, pb = pa[ed <= 3], pb[ed <= 3]
    ab = a.abundances
    has_centre = torch.zeros(a.n, dtype=torch.bool)
    has_centre[pa[ab[pb] > ab[pa]]] = True
    has_centre[pb[ab[pa] > ab[pb]]] = True
    # (a sample of the drawn amplicons: some centres are not in it)
    assert float(has_centre[single].double().mean()) > 0.7


def test_traffic_shapes_from_data_alone():
    """Fixed-length reads and mixed markers are parameters, not code."""
    params = small_traffic("reads-150nt-500k", 2000)
    cut = reads.make_corpus(dict(params, truncate=140), 5)
    assert int(cut.lengths.min()) == int(cut.lengths.max()) == 140
    mixed = reads.make_corpus(dict(params, true_length=[
        [142, 158, 0.5], [380, 420, 0.5]]), 5)
    long = mixed.lengths > 300
    assert 0.3 < float(long.double().mean()) < 0.7
    assert int(mixed.lengths[~long].max()) <= 158 + 6


def test_fasta_runs_differ_in_bytes(tmp_path):
    corp = reads.make_corpus(small_traffic("reads-150nt-500k", 500), 3)
    paths = [tmp_path / f"in{k}.fasta" for k in range(3)]
    tags = [corp.write(p, k) for k, p in enumerate(paths)]
    data = [p.read_bytes() for p in paths]
    assert data[0] != data[1] != data[2] != data[0]
    assert data[1].replace(tags[1], tags[0]) == data[0]
    lines = data[0].decode().split("\n")
    assert len(lines) == 2 * corp.n + 1
    for k in range(corp.n):
        head, seq = lines[2 * k], lines[2 * k + 1]
        label, ab = head[1 + corpus.TAG_WIDTH:].rsplit("_", 1)
        assert head.startswith(">r0000_b")
        assert int(ab) == int(corp.abundances[k])
        assert label == f"b{int(corp.labels[k])}"
        assert len(seq) == int(corp.lengths[k])


def test_decimal_and_join():
    vals = torch.tensor([0, 7, 10, 99, 12345, 2 ** 62])
    chars, lens = text.decimal(vals)
    buf, offsets, _ = text.join([b"<", (chars, lens), b">"], len(vals),
                                "cpu")
    assert bytes(buf.numpy()) == b"".join(
        b"<%d>" % v for v in vals.tolist())
    assert offsets[-1] == len(buf)


def test_screen_operation_count_is_brute_force():
    spec = importlib.util.spec_from_file_location(
        "roof", BENCH / "metrics" / "d2_screen.roofline_pct.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    g = torch.Generator().manual_seed(11)
    for d in (1, 2, 3):
        lengths = torch.randint(140, 160, (300,), generator=g)
        brute = sum(1 for i, j in itertools.combinations(range(300), 2)
                    if abs(int(lengths[i]) - int(lengths[j])) <= d)
        assert mod.pairs_within(lengths, d) == brute


def _ctx(events, window):
    return {"events": events, "window": window, "runs": [Run()],
            "corpus": None, "d": 2, "peaks": {}, "offset_us": None}


def test_idle_arithmetic_on_synthetic_trace():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.RUN,
         "ts": 0, "dur": 700},
        {"ph": "X", "cat": "user_annotation", "name": trace.RUN,
         "ts": 800, "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 100, "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 250, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 600,
         "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "k3", "ts": 720, "dur": 50},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "x", "ts": 0,
         "dur": 1000},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0,
         "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 990, "dur": 100},
    ]
    runs = trace.runs_of(ev)
    assert runs == [(0.0, 700.0), (800.0, 1000.0)]
    assert trace.span_seconds(runs) == pytest.approx(900e-6)
    ops = trace.device_intervals(ev, runs)
    merged = trace.union(ops)  # k3 lies between the runs: left out
    assert merged == [[100.0, 350.0], [600.0, 650.0], [990.0, 1000.0]]
    assert trace.busy_seconds(merged) == pytest.approx(310e-6)
    idle = metric_reader("device.idle_pct")(_ctx(ev, runs))
    assert idle == pytest.approx(100 * (1 - 310 / 900))
    gaps = trace.gaps(merged, runs)
    assert gaps == [(0.0, 100.0), (350.0, 600.0), (650.0, 700.0),
                    (800.0, 990.0)]
    named = trace.name_gaps(gaps, [("read", 0, 500), ("read", 800, 850)])
    assert named == pytest.approx({"read": 300e-6,
                                   "run, no span": 290e-6})
    kernel_ms = metric_reader("d2_diffs.kernel_ms")(_ctx(
        [dict(e, name="void d2_diffs_kernel<3, 7>") if e["name"] == "k2"
         else e for e in ev], runs))
    assert kernel_ms == pytest.approx(0.1)


@pytest.mark.parametrize("d,traffic", [(2, "reads-150nt-500k"),
                                       (3, "reads-253nt-300k")])
def test_scored_band_equals_full_matrix(d, traffic):
    """Reference step 4 (the band, and the gapless rule for rows of one
    length) against search_diffs-style full matrices, written out here
    cell by cell for pairs of one length and of two."""
    corp = reads.make_corpus(small_traffic(traffic, 400), 21)
    mm, go, ge = reference.cost_model(SCORING)
    codes, lens = corp.codes, corp.lengths
    pa, pb = reference.candidate_pairs(codes, lens, d)
    one = lens[pa] == lens[pb]
    assert one.sum() >= 60 and (~one).sum() >= 60
    pa = torch.cat([pa[one][:60], pa[~one][:60]])
    pb = torch.cat([pb[one][:60], pb[~one][:60]])
    got, ok = reference.scored_diffs(codes, lens, pa, pb, d, mm, go, ge)
    for i in range(len(pa)):
        q = codes[pa[i], :lens[pa[i]]].tolist()
        t = codes[pb[i], :lens[pb[i]]].tolist()
        score, diff = full_matrix(q, t, mm, go, ge)
        want = score <= d * max(mm, go + ge) and diff <= d
        assert bool(ok[i]) == want
        if want:
            assert int(got[i]) == diff


def full_matrix(q, t, mm, go, ge):
    """(score, diffs) of search8's cost DP and backtrack, plain Python."""
    Q, R = go + ge, ge
    n, m = len(q), len(t)
    H = [Q + i * R for i in range(n)]
    E = [2 * Q + i * R for i in range(n)]
    dirs = []
    for j in range(m):
        row = [0] * n
        F = 2 * go + (j + 2) * ge
        Hn = [0] * n
        for i in range(n):
            diag = (0 if j == 0 else go + j * ge) if i == 0 else H[i - 1]
            diag += 0 if q[i] == t[j] else mm
            bits = 0
            if diag <= F:
                bits |= 1
            if E[i] <= min(diag, F):
                bits |= 2
            h = min(diag, E[i], F)
            if h + Q <= F + R:
                bits |= 4
            if h + Q <= E[i] + R:
                bits |= 8
            row[i] = bits
            E[i] = min(h + Q, E[i] + R)
            F = min(h + Q, F + R)
            Hn[i] = h
        H = Hn
        dirs.append(row)
    score = H[n - 1]
    col, r, aligned, matches, op = n - 1, m - 1, 0, 0, 0
    while col >= 0 and r >= 0:
        aligned += 1
        cell = dirs[r][col]
        if op == 1 and not cell & 8:
            r -= 1
        elif op == 2 and not cell & 4:
            col -= 1
        elif cell & 2:
            r, op = r - 1, 1
        elif not cell & 1:
            col, op = col - 1, 2
        else:
            matches += q[col] == t[r]
            col, r, op = col - 1, r - 1, 3
    aligned += col + 1 + r + 1
    return score, aligned - matches


def test_candidates_hold_every_pair_within_d():
    corp = reads.make_corpus(small_traffic("reads-150nt-500k", 300), 9)
    codes, lens = corp.codes, corp.lengths
    pa, pb = reference.candidate_pairs(codes, lens, 2)
    found = set(zip(pa.tolist(), pb.tolist()))
    ia, ib = torch.triu_indices(300, 300, 1)
    near = (lens[ia] - lens[ib]).abs() <= 2
    ia, ib = ia[near], ib[near]
    ed = reference.edit_distance(codes, lens, ia, ib, 2)
    within = {(int(a), int(b)) for a, b, e in zip(ia, ib, ed) if e <= 2}
    assert within and within <= found


def test_control_fails_the_comparison():
    """The control (unit edit distance as the differences) against the
    reference, at a size a test holds, on three seeds."""
    params = small_traffic("reads-150nt-500k", 3000)
    for seed in (1, 2, 3):
        corp = reads.make_corpus(params, seed)
        ref = reference.cluster(corp, CONFIG, "cpu")
        ctl = reference.cluster(corp, CONFIG, "cpu", control=True)
        run = Run(edges=ctl.edges, streams={
            k: bytes(v.numpy()) for k, v in ctl.streams.items()})
        correct, table = check.verdict(check.compare(ref, [run], corp.n))
        assert not correct
        assert table["edges_extra"]["value"] > 0


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_no_jax_and_an_independent_reference():
    for path in BENCH.rglob("*.py"):
        top = set(_imports(path))
        assert not top & {"jax", "jaxlib", "flax", "swarm_tpu"}, path
    parts = [BENCH / name for name in ("check.py", "text.py", "corpus.py")]
    parts += list((BENCH / "references").glob("*.py"))
    parts += list((BENCH / "generators").glob("*.py"))
    for path in parts:
        assert "swarm_tpu_torch" not in set(_imports(path)), path
