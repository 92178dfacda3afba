"""Every traffic mix gives two seeds the same lengths, counts and order
of work, and different token ids or bytes."""
import pytest
import torch

import _testkit as K
import drivers
import traffic as T

CPU = torch.device("cpu")
A, B = K.SEEDS


@pytest.mark.parametrize("mix", ["prefill"])
def test_prefill_cycle_is_the_seeds_alike_and_tokens_differ(mix):
    m = T.load(mix)
    cycle = T.prefill_batches(m)
    assert [L * n for L, n in cycle] == [m["tokens_per_batch"]] * len(cycle)
    assert [L for L, _ in cycle] == m["lengths"]
    for i, (L, n) in enumerate(cycle):
        ta = T.tokens(A, i, (n // 8, L), 122753, CPU)
        tb = T.tokens(B, i, (n // 8, L), 122753, CPU)
        assert ta.shape == tb.shape == (n // 8, L)
        assert not torch.equal(ta, tb)
        assert torch.equal(ta, T.tokens(A, i, (n // 8, L), 122753, CPU))


def test_decode_prompt_shape_is_the_seeds_alike_and_tokens_differ():
    m = T.load("decode")
    shape = (m["batch"], m["prompt_len"])
    ta, tb = (T.tokens(s, 0, shape, 122753, CPU) for s in (A, B))
    assert ta.shape == tb.shape == shape and not torch.equal(ta, tb)
    assert m["cache_len"] > m["prompt_len"]


def test_swap_order_and_sizes_are_the_seeds_alike_and_bytes_differ():
    m = T.load("swap")
    order = [T.swap_tenant(m, n) for n in range(10)]
    assert order == [n % m["tenants"] for n in range(10)]
    pa = [T.payload(A, t, 4096, CPU) for t in range(m["tenants"])]
    pb = [T.payload(B, t, 4096, CPU) for t in range(m["tenants"])]
    assert [p.numel() for p in pa] == [p.numel() for p in pb]
    assert not torch.equal(pa[0], pb[0]) and not torch.equal(pa[0], pa[1])


@pytest.mark.parametrize("workload", [c["name"] for c in K.cells()])
def test_two_seeds_run_the_same_work(workload):
    """A whole run of each cell, small, on two seeds: the same items in
    the same order, each of the same size."""
    def plan(out):
        recs = out.records
        if "batches" in recs:
            return [(b["L"], b["B"]) for b in recs["batches"]]
        if "reloads" in recs:
            return [(r["tenant"], r["bytes"]) for r in recs["reloads"]]
        return [recs["batch"]] * recs["steps"]
    pa, pb = (plan(K.run(workload, seed=s, seconds=2.0)) for s in K.SEEDS)
    n = min(len(pa), len(pb))
    assert n >= 2 and pa[:n] == pb[:n]


def test_stream_seeds_take_seeds_past_32_bits():
    s = T.stream_seed(2 ** 31 + 5, T.STREAM_TOKENS, 3)
    assert 0 <= s < 2 ** 63
    assert s != T.stream_seed(2 ** 31 + 6, T.STREAM_TOKENS, 3)


@pytest.mark.parametrize("workload", [c["name"] for c in K.cells()
                                      if c["traffic"] == "prefill"])
def test_prefill_cell_compares_the_rows_its_rule_names(workload):
    """The rows a prefill cell compares: of a model whose experts couple
    a batch's rows, every row of the mix's count of batches of each
    length, alike for two seeds; else the mix's count of rows of a batch
    of the longest length and of one of another."""
    c = K.ctx(workload)
    mix = T.load("prefill")
    for k in ("compare_rows_dense", "compare_batches_moe"):
        c.traffic[k] = mix[k]
    cycle = T.prefill_batches(mix)
    batches = [{"i": i, "L": L, "B": B,
                "tokens": torch.zeros(B, L, dtype=torch.long),
                "served": torch.zeros(B, dtype=torch.long)}
               for i, (L, B) in enumerate(cycle * 3)]

    def shape(seed):
        c.seed = seed
        return [(toks.shape, tuple(pos)) for toks, pos, _ in
                drivers.prefill_sample(c, batches)]
    rows = dict((L, min(B, mix["compare_rows_dense"])) for L, B in cycle)
    for seed in (A, B):
        got = shape(seed)
        if c.arch.get("n_experts"):
            assert got == [((n, L), (L - 1,)) for L, n in sorted(cycle)
                           for _ in range(mix["compare_batches_moe"])]
        else:
            assert len(got) == 2 and got[0][0][1] == max(rows)
            assert got[1][0][1] != max(rows)
            assert all(s == (rows[s[1]], s[1]) and p == (s[1] - 1,)
                       for s, p in got)
