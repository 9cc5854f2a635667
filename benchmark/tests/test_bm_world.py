"""The benchmark's frozen world generators, bit for bit against the
port's functions at a small size (the test may import the port; the
benchmark's world and reference never do)."""
import numpy as np

from benchmark import rates, world
from quilt_tpu_torch.bench.common import fast_packed_panel, packed_truth_mosaic
from quilt_tpu_torch.io.simulate import simulate_sample_reads
from quilt_tpu_torch.out.metrics import r2_simple
from quilt_tpu_torch.panel.prepare import assign_positions_to_grid


def test_panel_and_truth_equal_the_ports():
    for seed in (1, 2 ** 31 + 7):
        a = world.fast_packed_panel(np.random.default_rng(seed), 300, 24, n_founders=9)
        b = fast_packed_panel(np.random.default_rng(seed), 300, 24, n_founders=9)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        ta = world.packed_truth_mosaic(np.random.default_rng(seed), a, 24 * 32)
        tb = packed_truth_mosaic(np.random.default_rng(seed), b, 24 * 32)
        assert np.array_equal(ta, tb)


def test_reads_equal_the_ports():
    rng = np.random.default_rng(3)
    panel = world.fast_packed_panel(rng, 50, 16)
    truth = world.packed_truth_mosaic(rng, panel, 512)
    pos = 1000 + np.arange(512, dtype=np.int64) * 60
    grid, _, _ = assign_positions_to_grid(pos)
    for cov, rl, ph in ((1.0, 600, 25), (0.1, 600, 25), (2.0, 150, 20)):
        mine = world.simulate_reads(np.random.default_rng(11), truth, pos, cov, rl, ph)
        port, _ = simulate_sample_reads(np.random.default_rng(11), truth, pos, grid,
                                        coverage=cov, read_length_bp=rl, phred=ph)
        assert np.array_equal(mine.u, port.u) and np.array_equal(mine.bq, port.bq)
        assert np.array_equal(mine.offsets, port.offsets)
        assert np.array_equal(mine.grid, port.wif0)


def test_r2_equals_the_ports():
    rng = np.random.default_rng(4)
    t = rng.integers(0, 3, 500).astype(float)
    d = np.clip(t + rng.normal(0, 0.4, 500), 0, 2)
    assert rates.r2_simple(t, d) == r2_simple(t, d)


def test_the_same_seed_gives_the_same_world():
    cfg = {"K": 40, "nSNPs": 256, "first_pos": 100, "snp_spacing_bp": 60,
           "truth_switch_rate": 0.002,
           "panel": {"n_founders": 8, "switch": 0.02, "mutation_per_bit": 0.008}}
    tr = {"sample_batch": 3, "pool_batches": 2, "coverage": 1.0, "read_length_bp": 600,
          "phred": 25, "layout_seed": 9}
    a, b = world.make_world(2 ** 33 + 5, cfg, tr), world.make_world(2 ** 33 + 5, cfg, tr)
    assert np.array_equal(a.rhb, b.rhb) and len(a.reads) == 6
    assert a.batches == [[0, 1, 2], [3, 4, 5]]
    assert all(np.array_equal(x.u, y.u) and np.array_equal(x.bq, y.bq)
               for x, y in zip(a.reads, b.reads))


def test_every_seed_has_the_same_sizes_in_another_order():
    cfg = {"K": 40, "nSNPs": 256, "first_pos": 100, "snp_spacing_bp": 60,
           "truth_switch_rate": 0.002,
           "panel": {"n_founders": 8, "switch": 0.02, "mutation_per_bit": 0.008}}
    tr = {"sample_batch": 4, "pool_batches": 2, "coverage": 1.0, "read_length_bp": 600,
          "phred": 25, "layout_seed": 9}
    worlds = [world.make_world(s, cfg, tr) for s in (1, 2, 3)]
    for b in worlds[0].batches:
        sizes = [sorted(tuple(np.bincount(w.reads[i].grid, minlength=8)) for i in b)
                 for w in worlds]
        assert sizes[0] == sizes[1] == sizes[2]
    assert not np.array_equal(worlds[0].reads[0].bq, worlds[1].reads[0].bq)
