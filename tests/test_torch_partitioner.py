"""The port's Partitioner against the JAX package's, on the cases of
``tests/test_partitioner.py`` (native and NumPy grouping paths)."""

import numpy as np
import pytest
from numpy.testing import assert_array_equal

import cvmatrix_tpu as J
import cvmatrix_tpu_torch as T
from cvmatrix_tpu_torch.native import loader as port_loader

CASES = {
    "float_labels": np.random.default_rng(0).choice([5, 2, 9, 2.5], 1000),
    "int_labels": np.random.default_rng(1).integers(0, 7, 500),
    "strings": ["a", "b", "a", "c", "b", "a"],
    "unequal": np.array([0] * 3 + [1] * 3 + [2] * 5),
    "mask": np.array([0] * 2 + [1] * 4 + [2] * 3),
    "loocv": np.arange(50),
    "nan_labels": np.array([0.0, np.nan, 1.0, np.nan]),
    "objects": np.array(["a", 1, "a", 1], dtype=object),
}


def assert_same_partition(t, j):
    assert t.num_folds == j.num_folds
    tk, jk = list(t.folds_dict), list(j.folds_dict)
    assert len(tk) == len(jk)
    for a, b in zip(tk, jk):
        assert a == b or (a != a and b != b)  # NaN keys compare unequal
        assert_array_equal(t.folds_dict[a], j.folds_dict[b])
        assert t.folds_dict[a].dtype == j.folds_dict[b].dtype
    tb, jb = t.size_buckets(), j.size_buckets()
    assert len(tb) == len(jb)
    for (tks, tbatch), (jks, jbatch) in zip(tb, jb):
        assert len(tks) == len(jks)
        assert_array_equal(tbatch, jbatch)
    if not any(k != k for k in tk):
        tkeys, tidx, tmask = t.padded_batches()
        jkeys, jidx, jmask = j.padded_batches()
        assert tkeys == jkeys
        assert_array_equal(tidx, jidx)
        assert (tmask is None) == (jmask is None)
        if tmask is not None:
            assert_array_equal(tmask, jmask)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_partition_matches_jax(case, native, monkeypatch):
    if not native:  # the NumPy path taken when the g++ build fails
        monkeypatch.setattr(port_loader, "_get_lib", lambda: None)
    folds = CASES[case]
    assert_same_partition(T.Partitioner(folds), J.Partitioner(folds))


def test_unknown_fold_and_pad_to_errors_match():
    t, j = T.Partitioner(CASES["mask"]), J.Partitioner(CASES["mask"])
    for p in (t, j):
        with pytest.raises(ValueError, match="Fold 7 not found."):
            p.get_validation_indices(7)
        with pytest.raises(ValueError, match="pad_to"):
            p.padded_batches(pad_to=3)
    assert_array_equal(t.padded_batches(pad_to=6)[1],
                       j.padded_batches(pad_to=6)[1])


@pytest.mark.parametrize("kw,w,msg", [
    (dict(needs_stats=True, ddof=0), np.r_[np.ones(5), np.zeros(5)],
     "greater than zero"),
    (dict(needs_std=True, ddof=1), np.r_[np.ones(5), np.zeros(4), 1.0],
     "greater than `ddof`"),
    (dict(needs_stats=True, needs_std=True, ddof=1), np.ones(10), None),
])
def test_validate_matches_jax(kw, w, msg):
    folds = np.array([0] * 5 + [1] * 5)
    for P in (T.Partitioner, J.Partitioner):
        if msg is None:
            P(folds).validate(10, w, **kw)
        else:
            with pytest.raises(ValueError, match=msg):
                P(folds).validate(10, w, **kw)


def test_validate_rejects_out_of_range():
    for P in (T.Partitioner, J.Partitioner):
        bad = P(np.arange(4))
        bad.folds_dict[0][:] = 99
        with pytest.raises(ValueError, match="outside"):
            bad.validate(4)


def test_native_partition_builds():
    """The port builds the repository's csrc/fastpartition.cpp itself."""
    if port_loader._build() is None:
        pytest.skip("g++ build of csrc/fastpartition.cpp unavailable here")
    keys, groups = port_loader.partition_int64(np.array([3, 1, 3, 2]))
    assert_array_equal(keys, [3, 1, 2])
    assert_array_equal(groups[0], [0, 2])
