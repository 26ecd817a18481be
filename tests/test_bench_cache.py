"""Large-bench hierarchy-cache invalidation key: the key must change on any
source or config change, and be stable otherwise, so the bench can never run
on a stale hierarchy."""

import sys
import os

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _load_bench():
    import importlib.util
    p = os.path.join(os.path.dirname(__file__), "..", "bench.py")
    spec = importlib.util.spec_from_file_location("bench_mod", p)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def test_cache_key_source_and_config_sensitivity(tmp_path):
    bench = _load_bench()
    from mfmg_tpu.config import Config, SmootherConfig

    root = tmp_path / "src"
    root.mkdir()
    (root / "a.py").write_text("x = 1\n")
    cfg1 = Config(max_levels=3)
    k1 = bench.bench_cache_key(cfg1, root=str(root))
    assert k1 == bench.bench_cache_key(cfg1, root=str(root))  # stable
    # source change invalidates
    (root / "a.py").write_text("x = 2\n")
    assert bench.bench_cache_key(cfg1, root=str(root)) != k1
    # config change invalidates
    (root / "a.py").write_text("x = 1\n")
    cfg2 = Config(max_levels=3, smoother=SmootherConfig(degree=3))
    assert bench.bench_cache_key(cfg2, root=str(root)) != k1
    # non-source files don't count
    (root / "notes.txt").write_text("irrelevant")
    assert bench.bench_cache_key(cfg1, root=str(root)) == k1
