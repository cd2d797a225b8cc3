"""The generator at a tiny scale: seeds, taxonomy, divergence, spans and
the share of exact copies."""

import json

import numpy as np
import pytest

from portbench import generator as g
from portbench.tests.tiny import COI, REPO, SSU, TRAFFIC


def traffic(name, n=200):
    return dict(TRAFFIC[name], file_queries=n, warmup_queries=8,
                check_queries=16)


def test_same_seed_same_records_other_seed_other_records():
    a, b, c = (g.make_world(COI, s) for s in (2**31 + 3, 2**31 + 3, 2**31 + 4))
    assert np.array_equal(a.codes4, b.codes4) and a.lineages == b.lineages
    assert not np.array_equal(a.codes4, c.codes4)
    fa = g.Traffic(a, traffic("known"), 5).file(1)
    fb = g.Traffic(b, traffic("known"), 5).file(1)
    fc = g.Traffic(a, traffic("known"), 6).file(1)
    assert np.array_equal(fa.rows, fb.rows) and fa.labels == fb.labels
    assert not np.array_equal(fa.rows, fc.rows)


def test_every_seed_gets_the_same_sizes():
    a, b = g.make_world(SSU, 1), g.make_world(SSU, 2)
    sa = np.bincount(a.species_of)
    sb = np.bincount(b.species_of)
    assert sorted(sa) == sorted(sb) and not np.array_equal(sa, sb)
    assert sorted(a.lengths) == sorted(b.lengths)
    # children per parent: one multiset at every rank, assigned by the seed
    moved = False
    for r in range(1, len(SSU["ranks"])):
        ca, cb = np.bincount(a.parent[r]), np.bincount(b.parent[r])
        assert sorted(ca) == sorted(cb)
        moved |= not np.array_equal(ca, cb)
    assert moved


@pytest.mark.parametrize("name", ["coi5p_1m", "ssu138_510k"])
def test_children_per_parent_are_heavy_tailed(name):
    """Every parent has a child, no parent more than its cap, and the
    largest parent holds many times the mean, as genus sizes do."""
    conf = json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())
    ranks, taxa, law = conf["ranks"], conf["taxa"], conf["children"]
    for r in range(1, len(ranks)):
        counts = np.bincount(g.parents(np.random.default_rng(0), taxa[ranks[r - 1]],
                                       taxa[ranks[r]], law, ranks[r]))
        assert counts.size == taxa[ranks[r - 1]] and counts.min() >= 1
        assert counts.sum() == taxa[ranks[r]]
        assert counts.max() <= law["cap"][ranks[r]]
        if counts.size >= 100:
            assert counts.max() >= 5 * counts.mean(), ranks[r]
            assert (counts == 1).any(), ranks[r]


@pytest.mark.parametrize("conf", [COI, SSU], ids=["coi", "ssu"])
def test_ranks_and_taxon_counts_match_the_file(conf):
    w = g.make_world(conf, 11)
    assert len(w.lineages) == conf["records"]
    levels = [l.split(",") for l in w.lineages]
    assert {len(lv) for lv in levels} == {len(conf["ranks"])}
    for d, rank in enumerate(conf["ranks"]):
        labels = {lv[d] for lv in levels}
        assert all(x.startswith(rank + ":") for x in labels)
        assert len(labels) == conf["taxa"][rank], rank
    # a taxon sits under exactly one parent
    for d in range(1, len(conf["ranks"])):
        parents = {}
        for lv in levels:
            parents.setdefault(lv[d], set()).add(lv[d - 1])
        assert all(len(p) == 1 for p in parents.values())


@pytest.mark.parametrize("name", ["coi5p_1m", "ssu138_510k"])
def test_real_configs_size_their_species(name):
    conf = json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())
    law = conf["species_records"]
    sizes = g.species_sizes(conf["taxa"][conf["ranks"][-1]], conf["records"],
                            law["exponent"], law["min"], law["cap"])
    assert sizes.sum() == conf["records"]
    assert sizes.min() == law["min"] and sizes.max() == law["cap"]
    assert set(conf["assumed"]) <= set(conf)


@pytest.mark.parametrize("conf", [COI, SSU], ids=["coi", "ssu"])
def test_divergence_at_each_level_is_its_share(conf):
    w = g.make_world(conf, 17)
    ranks = conf["ranks"]
    var = w.var_pos
    for r in range(ranks.index(conf["consensus_rank"]) + 1, len(ranks)):
        child = w.consensus[ranks[r]]
        parent = w.parent[r]
        diff = (child != w.consensus[ranks[r - 1]][parent]).sum(axis=1)
        want = g.substitutions(conf["divergence"][ranks[r]], var.size)
        assert (diff == want).all(), ranks[r]
        # conserved positions never change
        cons = np.setdiff1d(np.arange(w.alignment_length), var)
        assert (child[:, cons] == w.consensus[ranks[r - 1]][parent][:, cons]).all()
    species = g.ENC4[w.consensus[ranks[-1]][w.species_of]]
    diff = (w.codes4 != species).sum(axis=1)
    assert (diff == g.substitutions(conf["divergence"]["record"], var.size)).all()


def test_record_lengths_and_trims():
    w = g.make_world(SSU, 5)
    lo, hi = SSU["record_length"]
    assert w.lengths.min() >= lo and w.lengths.max() <= hi
    assert (w.starts >= 0).all() and (w.starts + w.lengths <= 200).all()
    a, b = SSU["regions"]["v4"]
    assert ((w.starts <= a) & (w.starts + w.lengths >= b)).all()
    assert not w.fixed_length() and isinstance(w.port_sequences(), list)
    assert g.make_world(COI, 5).fixed_length()


def test_v4_queries_are_the_v4_window():
    w = g.make_world(SSU, 8)
    f = g.Traffic(w, traffic("v4"), 8).file(0)
    a, b = SSU["regions"]["v4"]
    assert (f.lengths == b - a).all() and f.rows.shape[1] == b - a
    # each query is the window of some species' consensus, changed at no
    # more positions than the divergence gives the window's variable ones
    var = ((w.var_pos >= a) & (w.var_pos < b)).sum()
    n_sub = g.substitutions(TRAFFIC["v4"]["divergence"][0], var)
    cons = g.ENC4[w.consensus["s"][:, a:b]]
    for i in range(len(f)):
        best = (cons != f.sequence(i)).sum(axis=1).min()
        assert best <= n_sub


def test_the_real_v4_window_is_253_bp():
    conf = json.loads((REPO / "portbench/configs/ssu138_510k.json").read_text())
    a, b = conf["regions"]["v4"]
    assert b - a == 253
    lo, hi = conf["record_length"]
    assert a >= conf["alignment_length"] - lo and b <= lo


def test_a_fifth_of_known_queries_copy_a_record():
    w = g.make_world(COI, 21)
    t = g.Traffic(w, traffic("known", n=500), 21)
    copied = []
    for k in range(3):
        f = t.file(k)
        n_copy = (f.copied >= 0).sum()
        assert n_copy == 100
        for i in np.nonzero(f.copied >= 0)[0]:
            assert np.array_equal(f.sequence(i), w.record(f.copied[i]))
        copied += f.copied[f.copied >= 0].tolist()
    assert len(set(copied)) == len(copied)  # no record copied twice a run
    labels = [l for k in range(3) for l in t.file(k).labels]
    assert len(set(labels)) == len(labels)


def test_fulllength_queries_are_trimmed_like_records():
    w = g.make_world(SSU, 4)
    f = g.Traffic(w, traffic("fulllength"), 4).file(0)
    lo, hi = SSU["record_length"]
    assert f.lengths.min() >= lo and f.lengths.max() <= hi
    warm = g.Traffic(w, traffic("fulllength"), 4).warmup()
    assert warm.lengths[0] == hi


@pytest.mark.parametrize("name", ["known", "fulllength", "v4"])
def test_fasta_written_reads_back_the_same(tmp_path, name):
    w = g.make_world(SSU if name != "known" else COI, 6)
    files = g.Traffic(w, traffic(name, n=50), 6).write_files(tmp_path, 2)
    for f, wf in enumerate(files):
        want = g.Traffic(w, traffic(name, n=50), 6).file(f)
        got = g.read_fasta(wf.path)
        assert got.labels == want.labels and len(wf) == 50
        assert np.array_equal(got.lengths, want.lengths)
        assert np.array_equal(wf.lengths, want.lengths)
        for i in range(len(got)):
            assert np.array_equal(got.sequence(i), want.sequence(i))
        text = wf.path.read_bytes().split(b"\n")
        assert text[0] == b">" + want.labels[0].encode()
        assert set(b"".join(text[1::2])) <= set(b"ACGT")
