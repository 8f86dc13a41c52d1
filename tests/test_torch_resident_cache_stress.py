"""Randomized stress test of the port's resident-corpus cache as a whole.

The twin of tests/test_resident_cache_stress.py. The cache combines
LRU-before-budget eviction, pinning, a shared budget, the weakly
referenced failure watermark and keys that carry the baked arguments;
tests/test_torch_resident.py checks each alone. This test interleaves
104 seeded operations (fits, predicts, a predict of another split during a
fit, changes of the baked arguments, pickling) across seven datasplits,
under a budget tight enough to refuse builds and an LRU cap tight enough
to evict, and asserts after every operation:

  * resident against streaming: each operation's output (epoch stats,
    predictions) equals, bit for bit, a streaming twin's started from the
    same parameters;
  * the live resident bytes stay within the budget and the entries within
    the LRU cap;
  * a split pinned by a running fit survives evictions during the fit,
    and the fit's cached corpus is pinned;
  * no pin outlives its fit;
  * every key matches its stored datasplit, and every watermark's
    referent is its key's split or dead.
"""

import pickle

import numpy as np

from action_segmentation_torch.data.synthetic import SyntheticDatasplit
from action_segmentation_torch.models import base as tbase
from action_segmentation_torch.models.semimarkov import RESIDENT_LRU, SemiMarkovModel
from tests.conftest import make_sm_args

N_OPS = 104
STAT_KEYS = ("train_loss", "train_nll_frame_avg", "train_kl_vid_avg", "train_recon_bound")


def _collect_fit(model, split, callback=None):
    stats = []

    def cb(e, s):
        if s:
            stats.append([s[k] for k in STAT_KEYS])
        if callback is not None:
            callback(e, s)

    model.fit(split, use_labels=True, callback_fn=cb)
    return stats


def _sync_params(src, dst):
    """Start `dst` from `src`'s parameters, so each operation is compared
    from the same state."""
    dst.module.load_state_dict(src.module.state_dict())


def _check_invariants(model, budget_mb, during_fit_key=None):
    cache = getattr(model, "_resident_cache", None)
    if cache is None:
        return
    assert len(cache) <= RESIDENT_LRU, len(cache)
    total = sum(r.nbytes for (_, r) in cache.values() if r is not None)
    assert total <= budget_mb * (1 << 20), (total, budget_mb)
    for key, (ds, _r) in cache.items():
        assert key[0] == id(ds), "cache key detached from its datasplit"
    for key, (ref, mark) in model._resident_failed.items():
        obj = ref()
        assert obj is None or id(obj) == key[0], key
        assert np.isfinite(mark)
    if during_fit_key is None:
        assert not model._resident_pins, model._resident_pins
    else:
        if during_fit_key in model._resident_pins:
            assert during_fit_key in cache, "pinned corpus evicted mid-fit"
        if during_fit_key in cache:
            assert during_fit_key in model._resident_pins, (
                "fit's cached training corpus is not pinned")


def test_resident_cache_randomized_stress():
    rng = np.random.RandomState(20260818)

    # six small splits and one over the budget (it always streams, so the
    # failure watermark and the fallback are exercised)
    splits = [
        SyntheticDatasplit(num_videos=int(rng.randint(8, 13)), n_classes=3, max_len=32,
                           min_len=8, span_k=4, feature_dim=8, shift=1.5, seed=i)
        for i in range(6)
    ]
    big = SyntheticDatasplit(num_videos=64, n_classes=3, max_len=32, min_len=8, span_k=4,
                             feature_dim=8, shift=1.5, seed=99)
    splits.append(big)

    # a budget of 4.05x the largest small corpus: any four fit (so the LRU
    # cap, not the budget, evicts for a fifth key) and the big one never
    probe = SemiMarkovModel.from_args(
        make_sm_args(sm_device_resident_mb=1 << 12, sm_max_span_length=6), splits[0],
        device="cpu")
    max_small = max(probe._get_resident(s, False).nbytes for s in splits[:6])
    big_nbytes = probe._get_resident(big, False).nbytes
    budget_mb = 4.05 * max_small / float(1 << 20)
    assert big_nbytes > budget_mb * (1 << 20)

    def fresh(budget):
        return SemiMarkovModel.from_args(
            make_sm_args(sm_device_resident_mb=budget, sm_max_span_length=6,
                         sm_supervised_method="gradient-based", epochs=1, lr=1e-2,
                         batch_size=5),
            splits[0], device="cpu")

    m_res = fresh(budget_mb)
    m_str = fresh(0)

    saw = {"evict": False, "budget_fail": False, "fit_eval": False, "pickle": False}
    seen_keys = set()

    def op_fit(split):
        _sync_params(m_res, m_str)
        assert _collect_fit(m_res, split) == _collect_fit(m_str, split)

    def op_fit_with_eval(split, eval_split):
        saw["fit_eval"] = True
        key = m_res._resident_key(split, False)

        def cb(e, s):
            if e != 0:
                return
            # a decode of another split while this fit's corpus is pinned
            m_res.predict(eval_split)
            if key not in m_res._resident_failed:
                assert key in m_res._resident_pins, "fit is not pinning its resident corpus"
            _check_invariants(m_res, budget_mb, during_fit_key=key)

        _sync_params(m_res, m_str)
        assert _collect_fit(m_res, split, callback=cb) == _collect_fit(m_str, split)

    def op_predict(split):
        _sync_params(m_res, m_str)
        p_a, p_b = m_res.predict(split), m_str.predict(split)
        assert list(p_a) == list(p_b)
        for name in p_a:
            np.testing.assert_array_equal(p_a[name], p_b[name])

    def op_mutate_bucket():
        new = int(rng.choice([1, 2, 5]))
        m_res.args.sm_class_shape_bucket = new
        m_str.args.sm_class_shape_bucket = new

    def op_mutate_narration_weight():
        # narration is off for every key here, so the weight must not
        # invalidate a cached entry (it keys narration builds only)
        before = dict(getattr(m_res, "_resident_cache", {}))
        w = float(rng.uniform(-2e4, -1e2))
        m_res.args.sm_constrain_narration_weight = w
        m_str.args.sm_constrain_narration_weight = w
        for key, (_, r) in before.items():
            if r is not None and key in m_res._resident_cache:
                assert m_res._resident_cache[key][1] is r

    def op_pickle_roundtrip():
        saw["pickle"] = True
        nonlocal m_res
        with tbase.unpickle_device("cpu"):
            m_res = pickle.loads(pickle.dumps(m_res))
        # the cache does not travel; the parameters do
        assert not hasattr(m_res, "_resident_cache")
        op_predict(splits[int(rng.randint(0, 6))])

    # op 0: break the symmetric initialization
    op_fit(splits[0])
    _check_invariants(m_res, budget_mb)

    for _ in range(1, N_OPS):
        prev_keys = set(getattr(m_res, "_resident_cache", {}))
        r = rng.rand()
        split = splits[int(rng.randint(0, len(splits)))]
        if r < 0.40:
            kind = "predict"
            op_predict(split)
        elif r < 0.62:
            kind = "fit"
            op_fit(split)
        elif r < 0.72:
            kind = "fit_eval"
            op_fit_with_eval(split, splits[int(rng.randint(0, 6))])
        elif r < 0.84:
            kind = "mutate_bucket"
            op_mutate_bucket()
        elif r < 0.92:
            kind = "mutate_weight"
            op_mutate_narration_weight()
        else:
            kind = "pickle"
            op_pickle_roundtrip()

        _check_invariants(m_res, budget_mb)
        cache = getattr(m_res, "_resident_cache", {})
        for key, (_ds, r_) in cache.items():
            if r_ is not None:
                seen_keys.add(key)
        if kind != "pickle" and (prev_keys - set(cache)):
            saw["evict"] = True
        if getattr(m_res, "_resident_failed", None):
            saw["budget_fail"] = True

    # the sequence exercised the machinery, not only streaming
    assert saw["budget_fail"], "budget-failure watermark never hit"
    assert saw["evict"], "LRU eviction never happened"
    assert saw["fit_eval"] and saw["pickle"]
    assert len(seen_keys) > RESIDENT_LRU, "never built more keys than the cap"
