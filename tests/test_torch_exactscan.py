"""K5 and the exact descent: the port against the JAX package's exact scan
(its CPU path) and numpy's sequential cumsum. Tolerance 0 on f64 bit
patterns."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raxtax_tpu.ops.exactf64 import join64_np, split64_np
from raxtax_tpu.ops.exactscan import (
    cum_pairs_bn,
    exact_cumsum_pairs,
    max_descent_exact as jax_descent,
    probs_pairs_scan_layout,
)
from raxtax_tpu_torch.ops.exactscan import (
    exact_cumsum,
    max_descent_exact,
    node_conf_exact,
)
from raxtax_tpu_torch.ops.nodeconf import (
    SIG_THRESHOLD,
    compact_eval_nodes,
    compact_unit_wide,
)


def _probs(rng, b, n):
    """Probability-like rows with zeros and tie-dense repeats."""
    p = rng.random((b, n)) * 10.0 ** rng.integers(-9, 0, (b, n))
    p[rng.random((b, n)) < 0.25] = 0.0
    rep = rng.random(b)[:, None] * np.ones((b, n)) * 1e-3
    mask = rng.random((b, n)) < 0.3
    p[mask] = rep[mask]
    return p


def _np_cum(p):
    z = np.zeros((p.shape[0], 1))
    return np.concatenate([z, np.cumsum(p, axis=1)], axis=1)


def _jax_cum(p):
    b, n = p.shape
    # the JAX scan takes whole blocks of 8 tips: zero tips past the end
    # leave every earlier sum's bits as they are
    p = np.pad(p, ((0, 0), (0, (-n) % 8)))
    ph, plo = split64_np(p.reshape(-1))
    gh, gl = probs_pairs_scan_layout(ph.reshape(b, -1), plo.reshape(b, -1))
    ch, cl = exact_cumsum_pairs(gh, gl, interpret=True)
    bh, bl = cum_pairs_bn(ch, cl, b, n)
    return join64_np(
        np.asarray(bh).reshape(-1), np.asarray(bl).reshape(-1)
    ).reshape(b, n + 1), (bh, bl)


@pytest.mark.parametrize("b,n", [(4, 256), (7, 1024), (1, 1), (3, 257)])
def test_cumsum_bits_equal_jax_and_numpy(b, n):
    rng = np.random.default_rng(b * 1000 + n)
    p = _probs(rng, b, n)
    got = exact_cumsum(torch.from_numpy(p)).numpy()
    assert got.shape == (b, n + 1) and (got[:, 0] == 0).all()
    want_jax, _ = _jax_cum(p)
    np.testing.assert_array_equal(got.view(np.uint64), want_jax.view(np.uint64))
    np.testing.assert_array_equal(got.view(np.uint64), _np_cum(p).view(np.uint64))


def test_cumsum_handles_subnormals():
    """Hardware f64 adds subnormals exactly like the host: the table gate
    the software adder needs has no counterpart."""
    rng = np.random.default_rng(3)
    p = _probs(rng, 3, 512)
    p[:, ::7] = 5e-324 * rng.integers(1, 1000, size=p[:, ::7].shape)
    p[1, :64] = 2.2250738585072014e-308 / 4
    got = exact_cumsum(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), _np_cum(p).view(np.uint64))


def test_cumsum_rejects_other_dtypes():
    with pytest.raises(TypeError):
        exact_cumsum(torch.zeros((2, 4), dtype=torch.float32))


def test_node_conf_exact_is_the_prefix_difference():
    rng = np.random.default_rng(5)
    b, n = 8, 512
    p = _probs(rng, b, n)
    cum = exact_cumsum(torch.from_numpy(p))
    s = np.sort(rng.integers(0, n, 40))
    e = np.minimum(s + rng.integers(1, 64, 40), n)
    got = node_conf_exact(cum, torch.from_numpy(s), torch.from_numpy(e)).numpy()
    want = _np_cum(p)[:, e] - _np_cum(p)[:, s]
    np.testing.assert_array_equal(got, want)
    s2 = torch.from_numpy(np.tile(s, (b, 1)))
    e2 = torch.from_numpy(np.tile(e, (b, 1)))
    np.testing.assert_array_equal(node_conf_exact(cum, s2, e2).numpy(), want)


def _tie_tree(n=384):
    """root -> 8 inner nodes of 48 tips -> 8 sub-nodes of 6 tips -> tip
    leaves; many equal subtree sums by construction."""
    nodes = []

    def add(s, e, inner):
        nodes.append((s, e, inner))
        return len(nodes) - 1

    root = add(0, n, True)
    lvl1 = [add(i * 48, (i + 1) * 48, True) for i in range(8)]
    lvl2 = [
        [add(i * 48 + j * 6, i * 48 + (j + 1) * 6, True) for j in range(8)]
        for i in range(8)
    ]
    tips = [add(t, t + 1, False) for t in range(n)]
    children = {root: lvl1}
    for i, l1 in enumerate(lvl1):
        children[l1] = lvl2[i]
        for j, l2 in enumerate(lvl2[i]):
            children[l2] = tips[i * 48 + j * 6 : i * 48 + (j + 1) * 6]
    rs = np.array([s for s, _, _ in nodes], np.int32)
    re = np.array([e for _, e, _ in nodes], np.int32)
    inner = np.array([i for _, _, i in nodes], bool)
    ptr = np.zeros(len(nodes) + 1, np.int32)
    ids = []
    for nd in range(len(nodes)):
        ids.extend(children.get(nd, []))
        ptr[nd + 1] = len(ids)
    return root, rs, re, ptr, np.array(ids, np.int32), inner


def _ref_descend(cum_row, node, rs, re, ptr, ids, inner):
    """Literal reference recursion: last max child wins exact f64 ties."""
    while inner[node]:
        best, best_id = None, node
        for cid in ids[ptr[node] : ptr[node + 1]]:
            v = cum_row[re[cid]] - cum_row[rs[cid]]
            if best is None or v >= best:
                best, best_id = v, cid
        node = int(best_id)
    return node


def test_descent_equals_jax_and_reference_on_ties():
    rng = np.random.default_rng(17)
    n, b = 384, 6
    root, rs, re, ptr, ids, inner = _tie_tree(n)
    p = np.zeros((b, n))
    for i in range(b):
        p[i, :] = rng.random() * 1e-3
        hot = rng.integers(0, 8)
        p[i, hot * 48 : (hot + 1) * 48] = rng.random() * 1e-2
    cum = exact_cumsum(torch.from_numpy(p))
    # sites: every query from the root, and from two level-1 nodes
    b_idx = np.concatenate([np.arange(b), np.arange(b), np.arange(b)])
    starts = np.concatenate(
        [np.full(b, root), np.full(b, 1), np.full(b, 8)]
    ).astype(np.int32)
    got = max_descent_exact(
        cum, torch.from_numpy(b_idx), torch.from_numpy(starts),
        torch.from_numpy(rs), torch.from_numpy(re), torch.from_numpy(ptr),
        torch.from_numpy(ids), torch.from_numpy(inner),
    ).numpy()
    _, (bh, bl) = _jax_cum(p)
    ids_pad = np.concatenate([ids, np.zeros(256, np.int32)])
    want_jax = np.asarray(
        jax_descent(
            bh, bl, jnp.asarray(b_idx.astype(np.int32)), jnp.asarray(starts),
            jnp.asarray(rs), jnp.asarray(re), jnp.asarray(ptr),
            jnp.asarray(ids_pad), jnp.asarray(inner), chunk=8,
        )
    )
    np.testing.assert_array_equal(got, want_jax)
    cum_np = _np_cum(p)
    for i in range(len(starts)):
        want = _ref_descend(cum_np[b_idx[i]], int(starts[i]), rs, re, ptr, ids, inner)
        assert got[i] == want
    # a start that is no inner node is its own answer
    leaf = len(rs) - 1
    one = max_descent_exact(
        cum, torch.tensor([0]), torch.tensor([leaf]),
        torch.from_numpy(rs), torch.from_numpy(re), torch.from_numpy(ptr),
        torch.from_numpy(ids), torch.from_numpy(inner),
    )
    assert int(one[0]) == leaf


@pytest.mark.parametrize("split", [True, False])
def test_compaction_returns_every_node_at_or_above_threshold(split):
    rng = np.random.default_rng(23)
    b, n = 5, 256
    p = rng.random((b, n)) * 1e-4
    p[:, 40:44] = 0.02
    p[2, 100] = 0.3
    p /= p.sum(axis=1, keepdims=True)
    cum = exact_cumsum(torch.from_numpy(p))
    cum_np = _np_cum(p)
    starts = np.array([0, 0, 32, 40, 41, 100, 128, 255])
    ends = np.array([256, 32, 64, 41, 42, 101, 256, 256])
    if split:
        wide = (ends - starts) > 1
        has_unit = np.zeros(n, bool)
        has_unit[starts[~wide]] = True
        sig = compact_unit_wide(
            cum, torch.from_numpy(starts[wide]), torch.from_numpy(ends[wide]),
            torch.from_numpy(np.nonzero(wide)[0]), torch.from_numpy(has_unit), n,
        )
    else:
        sig = compact_eval_nodes(cum, torch.from_numpy(starts), torch.from_numpy(ends))
    off, idx, conf = sig.pull()
    assert off[0] == 0 and off[-1] == idx.size == conf.size
    for q in range(b):
        got = {}
        for i, v in zip(idx[off[q] : off[q + 1]], conf[off[q] : off[q + 1]]):
            if i < -1:  # unit tip code -> its eval positions
                tip = -int(i) - 2
                for j in np.nonzero((starts == tip) & (ends == tip + 1))[0]:
                    got[int(j)] = v
            else:
                got[int(i)] = v
        want = {
            j: cum_np[q, ends[j]] - cum_np[q, starts[j]]
            for j in range(len(starts))
            if cum_np[q, ends[j]] - cum_np[q, starts[j]] >= SIG_THRESHOLD
        }
        assert got == want
