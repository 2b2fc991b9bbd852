"""The port's synthetic generators of the paper tasks against the
reference's: ``jsc_plf`` (the default cloud, and 16 particles x 8 features)
and ``tgc_muon``, every split equal bit for bit in value and dtype; ``jsc_hlf``
and ``cepc_waveform`` as well, beside them."""

import numpy as np
import pytest

from repro.data import synthetic as ref
from repro_torch.data import synthetic as port

SPLITS = ("train", "val", "test")


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("seed,n,kw", [(0, 257, {}),
                                       (3, 64, dict(n_particles=16, n_features=8)),
                                       (1, 33, dict(n_particles=5, n_features=2))])
def test_jsc_plf_equals_reference(seed, n, kw, split):
    got = port.jsc_plf(seed, n, split=split, **kw)
    _same(got, ref.jsc_plf(seed, n, split=split, **kw))
    x, y = got
    n_particles = kw.get("n_particles", 32)
    assert x.shape == (n, n_particles, kw.get("n_features", 16))
    assert x.dtype == np.float32 and y.dtype == np.int32
    # padded slots are zero and come last
    real = np.any(x != 0, axis=-1)
    assert not np.any(real[:, 1:] & ~real[:, :-1])


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("seed,n", [(0, 200), (7, 17)])
def test_tgc_muon_equals_reference(seed, n, split):
    got = port.tgc_muon(seed, n, split=split)
    _same(got, ref.tgc_muon(seed, n, split=split))
    hits, angle = got
    assert hits.shape == (n, 350) and set(np.unique(hits)) <= {0.0, 1.0}
    assert np.all(np.abs(angle) <= 30.0)


@pytest.mark.parametrize("split", SPLITS)
def test_splits_and_seeds_differ(split):
    for fn in (port.jsc_plf, port.tgc_muon):
        a = fn(0, 32, split=split)[0]
        assert not np.array_equal(a, fn(1, 32, split=split)[0])
        other = SPLITS[(SPLITS.index(split) + 1) % 3]
        assert not np.array_equal(a, fn(0, 32, split=other)[0])


@pytest.mark.parametrize("split", SPLITS)
def test_existing_generators_still_equal(split):
    _same(port.jsc_hlf(2, 100, split), ref.jsc_hlf(2, 100, split))
    _same(port.cepc_waveform(2, 3, length=400, split=split),
          ref.cepc_waveform(2, 3, length=400, split=split))


def test_generators_reject_an_unknown_split():
    for fn in (port.jsc_plf, port.tgc_muon):
        with pytest.raises(KeyError):
            fn(0, 4, split="dev")
