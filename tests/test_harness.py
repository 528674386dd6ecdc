"""Benchmark harness unit tests."""
import numpy as np

from altro_mpc.bench.harness import (benchmark_fn, boxplot_stats,
                                     load_results, save_results)


def test_boxplot_stats_quartiles():
    x = np.arange(1, 101, dtype=float)
    s = boxplot_stats(x)
    assert abs(s["median"] - 50.5) < 1e-9
    assert s["q1"] < s["median"] < s["q3"]
    assert s["lower_whisker"] <= s["q1"]
    assert s["upper_whisker"] >= s["q3"]
    assert s["outliers"] == []


def test_boxplot_outlier_filter():
    x = np.concatenate([np.random.default_rng(0).normal(0, 1, 200), [50.0]])
    s = boxplot_stats(x, outlier_sigmas=3.0)
    assert 50.0 in s["outliers"]
    assert s["upper_whisker"] < 50.0


def test_benchmark_fn_and_persistence(tmp_path):
    import jax.numpy as jnp

    res = benchmark_fn(lambda: jnp.ones(4) * 2, samples=2, evals=2,
                       name="toy", extra="meta")
    assert res.median_ms > 0
    assert res.meta["extra"] == "meta"

    path = str(tmp_path / "r.json")
    save_results(path, {"toy": res, "arr": jnp.arange(3)})
    loaded = load_results(path)
    assert loaded["toy"]["name"] == "toy"
    assert loaded["arr"] == [0, 1, 2]
