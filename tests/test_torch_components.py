"""seldon_tpu_torch.components against seldon_tpu.components: the bandit
routers and the outlier detectors, twin against twin on the same seeded
inputs — routes, scores, metrics, tags and pickled state bit-equal."""

import pickle

import numpy as np
import pytest

from seldon_tpu.components import outliers as j_out
from seldon_tpu.components import routers as j_rt
from seldon_tpu_torch import components as t_comp
from seldon_tpu_torch.components import outliers as t_out
from seldon_tpu_torch.components import routers as t_rt


def _state(obj):
    """The pickled state as plain data (the numpy arrays as bytes)."""
    d = obj.__getstate__()
    out = {}
    for k, v in d.items():
        if k == "_rng":
            out[k] = v.bit_generator.state
        elif isinstance(v, np.ndarray):
            out[k] = (v.dtype.str, v.shape, v.tobytes())
        else:
            out[k] = v
    return out


def test_components_exports():
    from seldon_tpu import components as j_comp

    # Since the learned detectors and the explainers are ported, the
    # package exports what the JAX package's does, in its order.
    assert t_comp.__all__ == j_comp.__all__
    assert t_comp.EpsilonGreedy is t_rt.EpsilonGreedy
    assert t_comp.ZScoreDetector is t_out.ZScoreDetector


@pytest.mark.parametrize("kind,kw", [
    ("EpsilonGreedy", dict(n_branches=3, epsilon=0.3, seed=11)),
    ("ThompsonSampling", dict(n_branches=3, alpha=1.0, beta=2.0, seed=5)),
])
def test_router_twins_route_and_learn_alike(kind, kw):
    """The same feedback script drives both routers: every route, metric,
    tag and the pickled state agree, before and after a pickle round
    trip."""
    jr, tr = getattr(j_rt, kind)(**kw), getattr(t_rt, kind)(**kw)
    rng = np.random.default_rng(3)
    X = np.zeros((1, 2))
    for step in range(60):
        bj, bt = jr.route(X, []), tr.route(X, [])
        assert bj == bt, step
        reward = float(rng.random() < (0.2, 0.5, 0.9)[bj])
        jr.send_feedback(X, [], reward, None, routing=bj)
        tr.send_feedback(X, [], reward, None, routing=bt)
        if step == 30:
            jr = pickle.loads(pickle.dumps(jr))
            tr = pickle.loads(pickle.dumps(tr))
    assert jr.metrics() == tr.metrics()
    assert jr.tags() == tr.tags()
    assert _state(jr) == _state(tr)
    # Out-of-range and missing routings are ignored by both.
    for r in (None, -1, 3):
        jr.send_feedback(X, [], 1.0, None, routing=r)
        tr.send_feedback(X, [], 1.0, None, routing=r)
    assert _state(jr) == _state(tr)


def test_router_rejects_no_branches():
    for cls in (t_rt.EpsilonGreedy, t_rt.ThompsonSampling):
        with pytest.raises(ValueError):
            cls(n_branches=0)


@pytest.mark.parametrize("kind,kw", [
    ("MahalanobisDetector", dict(threshold=2.5, start_clip=10)),
    ("ZScoreDetector", dict(threshold=3.0, start_clip=5)),
])
def test_detector_twins_score_tag_and_pickle_alike(kind, kw):
    jd, td = getattr(j_out, kind)(**kw), getattr(t_out, kind)(**kw)
    rng = np.random.default_rng(7)
    assert jd.tags() == td.tags() == {} and td.metrics() == []
    for step in range(8):
        X = rng.normal(0.0, 1.0, (5, 4))
        if step == 6:
            X[2] += 25.0  # an outlier row
        sj, st = jd.predict(X, []), td.predict(X, [])
        assert sj.tobytes() == st.tobytes(), step
        assert jd.tags() == td.tags()
        assert jd.metrics() == td.metrics()
        if step == 4:
            jd = pickle.loads(pickle.dumps(jd))
            td = pickle.loads(pickle.dumps(td))
    X = rng.normal(0.0, 1.0, (3, 4))
    np.testing.assert_array_equal(td.transform_input(X, []), X)
    jd.transform_input(X, [])
    assert jd.tags() == td.tags() and jd.metrics() == td.metrics()
    assert _state(jd) == _state(td)


def test_detector_flags_an_outlier():
    det = t_out.ZScoreDetector(threshold=4.0, start_clip=10)
    rng = np.random.default_rng(0)
    det.predict(rng.normal(0.0, 1.0, (50, 3)), [])
    det.predict(np.array([[0.0, 0.0, 40.0]]), [])
    assert det.tags() == {"outlier": True, "outlier_count": 1}
    keys = [m["key"] for m in det.metrics()]
    assert keys == ["outlier_score_max", "outlier_score_mean",
                    "outlier_threshold", "outliers_total"]


def test_detector_verdicts_are_per_thread():
    """predict() and tags() of one request run on one worker thread; a
    concurrent request on another thread never sees its verdict."""
    import threading

    det = t_out.ZScoreDetector(threshold=1.0, start_clip=1)
    det.predict(np.zeros((4, 2)), [])
    seen = {}

    def other():
        seen["tags"] = det.tags()

    det.predict(np.array([[100.0, 100.0]]), [])
    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert seen["tags"] == {}
    assert det.tags()["outlier"] is True
