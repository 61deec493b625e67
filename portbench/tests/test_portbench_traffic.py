"""The traffic generator: seeded, the same pool for every seed in another
order, and the sizes and lengths the mixes state."""

from __future__ import annotations

from portbench import traffic


def _stream(name, seed, k):
    f = traffic.Families(traffic.load_mix(name), seed)
    return f.warm(), [f.next() for _ in range(k)]


def test_same_seed_same_families_other_seed_same_pool_in_another_order():
    assert _stream("trna", 2**31 + 5, 30) == _stream("trna", 2**31 + 5, 30)
    k = 11 * traffic.load_mix("trna").blocks
    warm1, a = _stream("trna", 1, k)
    warm2, b = _stream("trna", 2, k)
    assert warm1 == warm2 and a != b
    assert sorted(map(str, a)) == sorted(map(str, b))


def test_a_pass_ends_after_each_pool_length():
    f = traffic.Families(traffic.load_mix("trna50"), 2**33 + 1)
    ends = []
    for _ in range(12):
        f.next()
        ends.append(f.at_pass_end)
    assert ends == [False] * 5 + [True] + [False] * 5 + [True]


def test_trna_pool_has_each_size_blocks_times_and_rfam_lengths():
    blocks = traffic.load_mix("trna").blocks
    k = 11 * blocks
    warm, fams = _stream("trna", 987654321012, 3 * k)
    assert len(warm) == 15
    sizes = [len(f) for f in fams]
    for c in range(3):
        assert sorted(sizes[k * c: k * c + k]) == sorted(list(range(5, 16)) * blocks)
    assert len({str(f) for f in fams[:k]}) == k
    lens = [len(s) for f in fams for _, s in f]
    # RF00005's members are 71-75 nt; 1 % indels move a few bases
    assert 60 <= min(lens) and max(lens) <= 90


def test_trna50_pool():
    warm, fams = _stream("trna50", 3, 6)
    assert len(warm) == 50 and all(len(f) == 50 for f in fams)
    assert len({str(f) for f in fams}) == 6


def test_mutation_rule_is_dryruns():
    import numpy as np

    from dafs_tpu_torch.parallel import dryrun

    seqs = [s for _, s in traffic.read_fasta(traffic.HERE + "/data/RF00005_0.fa")]
    mix = traffic.load_mix("trna")
    rng = np.random.default_rng(7)
    mine = [traffic.mutate(seqs[i % len(seqs)], mix, rng) for i in range(20)]
    assert mine == dryrun.mutated_family(seqs, n=20, seed=7)
