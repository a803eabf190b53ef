"""B6's plain version (``xivo_tpu_torch/ops/hamming.py``) against the JAX
package, on the CPU: the Pallas kernel ``hamming_nn`` in interpret mode
and the jnp path the reference's mapper runs (``brief.hamming_matrix`` +
masked min/argmin, ``map/mapper.py:106-110``). ``tests/test_ops.py``'s
sizes (M = 3000, F = 30) with planted exact copies, plus duplicate map
rows (ties), an invalid tail, an all-invalid sequence, an odd M and a
batch of 2. Distances and indices must be equal exactly. With a
query-row mask (every row, none, a random share with an exact copy of a
map entry masked, a whole sequence masked), the unmasked rows equal the
reference's exactly and the masked ones are (10000, 0). The comparison
tool's cuts (``tools/hamming_breakdown.py``) still match the kernel's
source.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xivo_tpu.frontend import brief
from xivo_tpu.ops.hamming_pallas import hamming_nn as pallas_hamming_nn
from xivo_tpu_torch.ops import hamming as th

torch.set_num_threads(2)


def case(seed, M, F, n_valid, dup=False):
    """(queries (F, 8), map (M, 8), valid (M,)) uint32/bool; the first 5
    queries copy map rows 1000-1004 (or their equivalents for small M);
    with dup, a block of map rows repeats an earlier block."""
    rng = np.random.default_rng(seed)
    md = rng.integers(0, 2 ** 32, (M, 8), dtype=np.uint32)
    qd = rng.integers(0, 2 ** 32, (F, 8), dtype=np.uint32)
    src = min(1000, M // 3)
    if dup:
        md[2 * M // 3:2 * M // 3 + 40] = md[src:src + 40]
    qd[:5] = md[src:src + 5]
    qd[5] = md[src + 7]
    qd[5, 0] ^= np.uint32(1)                  # one bit away
    valid = np.zeros(M, bool)
    valid[:n_valid] = True
    return qd, md, valid


def reference_jnp(qd, md, valid):
    D = brief.hamming_matrix(jnp.asarray(qd), jnp.asarray(md))
    D = jnp.where(jnp.asarray(valid)[None, :], D, 10_000)
    return np.asarray(jnp.min(D, axis=1)), np.asarray(jnp.argmin(D, axis=1))


def port(qd, md, valid):
    d, i = th.hamming_nn(torch.from_numpy(qd.astype(np.int64))[None],
                         torch.from_numpy(md.astype(np.int64))[None],
                         torch.from_numpy(valid)[None])
    assert d.dtype == i.dtype == torch.int64
    return d[0].numpy(), i[0].numpy()


CASES = {
    "test_ops_sizes": dict(seed=0, M=3000, F=30, n_valid=2000),
    "ties": dict(seed=1, M=3000, F=30, n_valid=3000, dup=True),
    "odd_m_invalid_tail": dict(seed=2, M=1237, F=30, n_valid=1001),
    "all_invalid": dict(seed=3, M=777, F=30, n_valid=0),
    "wide_queries": dict(seed=4, M=2049, F=256, n_valid=1500, dup=True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jnp_path_and_pallas_kernel(name):
    qd, md, valid = case(**CASES[name])
    d, i = port(qd, md, valid)
    rd, ri = reference_jnp(qd, md, valid)
    np.testing.assert_array_equal(d, rd)
    np.testing.assert_array_equal(i, ri)
    pd, pi = pallas_hamming_nn(jnp.asarray(qd), jnp.asarray(md),
                               jnp.asarray(valid), interpret=True)
    np.testing.assert_array_equal(d, np.asarray(pd))
    np.testing.assert_array_equal(i, np.asarray(pi))
    if valid.any():
        assert (d[:5] == 0).all() and d[5] == 1
    else:
        assert (d == th.NO_MATCH).all() and (i == 0).all()


def test_ties_go_to_the_lowest_index():
    qd, md, valid = case(**CASES["ties"])
    M = md.shape[0]
    d, i = port(qd, md, valid)
    # the copied rows exist twice; the earlier copy wins
    assert (i[:5] == np.arange(1000, 1005)).all()
    assert (md[2 * M // 3:2 * M // 3 + 5] == md[1000:1005]).all()


def test_batch_of_two_and_small_chunks(monkeypatch):
    """Two sequences at once, and the plain version's chunking over M
    (forced to 7 entries a step) gives the same answer as one step."""
    a = case(seed=5, M=901, F=30, n_valid=850, dup=True)
    b = case(seed=6, M=901, F=30, n_valid=0)
    q = torch.from_numpy(np.stack([a[0], b[0]]).astype(np.int64))
    m = torch.from_numpy(np.stack([a[1], b[1]]).astype(np.int64))
    v = torch.from_numpy(np.stack([a[2], b[2]]))
    d, i = th.hamming_nn(q, m, v)
    for k, c in enumerate((a, b)):
        rd, ri = reference_jnp(*c)
        np.testing.assert_array_equal(d[k].numpy(), rd)
        np.testing.assert_array_equal(i[k].numpy(), ri)
    monkeypatch.setattr(th, "_PLAIN_BUDGET", 2 * 30 * 7)
    d7, i7 = th.hamming_nn(q, m, v)
    assert torch.equal(d7, d) and torch.equal(i7, i)


def test_cpu_tensors_launch_nothing():
    qd, md, valid = case(**CASES["odd_m_invalid_tail"])
    n = th.HAMMING.launches
    port(qd, md, valid)
    assert th.HAMMING.launches == n


@pytest.fixture(scope="module")
def two_sequences():
    """A batch of two sequences with the reference's answers for each:
    [(queries, map, valid, (jnp dist, idx), (Pallas dist, idx))]."""
    out = []
    for c in (case(seed=7, M=1237, F=30, n_valid=1001, dup=True),
              case(seed=8, M=1237, F=30, n_valid=600)):
        pd, pi = pallas_hamming_nn(jnp.asarray(c[0]), jnp.asarray(c[1]),
                                   jnp.asarray(c[2]), interpret=True)
        out.append(c + (reference_jnp(*c), (np.asarray(pd), np.asarray(pi))))
    return out


def query_mask(kind):
    """(2, 30) bool; "random" masks row 0, an exact copy of a map entry,
    and keeps row 1, another."""
    qm = np.ones((2, 30), bool)
    if kind == "none":
        qm[:] = False
    elif kind == "random":
        qm = np.random.default_rng(9).random((2, 30)) < 0.4
        qm[:, 0], qm[:, 1] = False, True
    elif kind == "one_sequence":
        qm[1] = False
    return qm


@pytest.mark.parametrize("kind", ["all", "none", "random", "one_sequence"])
def test_query_mask_keeps_the_reference_on_unmasked_rows(two_sequences,
                                                         kind):
    qm = query_mask(kind)
    q, m, v = (torch.from_numpy(np.stack([c[k] for c in two_sequences])
                                .astype(np.int64 if k < 2 else bool))
               for k in range(3))
    d, i = th.hamming_nn(q, m, v, qmask=torch.from_numpy(qm))
    assert d.dtype == i.dtype == torch.int64
    for k, (_, _, _, ref, pal) in enumerate(two_sequences):
        on = qm[k]
        for rd, ri in (ref, pal):
            np.testing.assert_array_equal(d[k].numpy()[on], rd[on])
            np.testing.assert_array_equal(i[k].numpy()[on], ri[on])
        assert (d[k].numpy()[~on] == th.NO_MATCH).all()
        assert (i[k].numpy()[~on] == 0).all()
    if kind == "random":
        # row 0 copies a map entry exactly, but is masked; row 1 is not
        assert ref[0][0] == 0 and d[0, 0] == th.NO_MATCH and i[0, 0] == 0
        assert d[0, 1] == 0


@pytest.mark.parametrize("build", ["scan", "stage", "score", "fold", "all",
                                   "cluster8", "flat", "one_cta",
                                   "one_group"])
def test_breakdown_cuts_match_the_kernel_source(build):
    """Each cut (and each variant) replaces code that stands once in
    ``csrc/hamming.cu``, and nothing else; ``all`` makes every cut."""
    from xivo_tpu_torch.tools import hamming_breakdown as hb
    full = hb.variant_source("full")
    subs = (sum(hb.CUTS.values(), []) if build == "all" else
            hb.CUTS.get(build) or hb.VARIANTS[build])
    src = hb.variant_source(build)
    assert len(full) - len(src) == sum(len(a) - len(b) for a, b in subs)
    for old, new in subs:
        assert full.count(old) == 1 and (new == "" or new in src)
    assert "hamming_nn_kernel(const long long* __restrict__ q" in src
