"""The paper-scale harness of the port: the offline replay of the paper's
experiments (``common.run_policy``), the paced ``PoolServer`` drive over
``SimEngine``s (``common.drive_pool_stream``), the baselines table
(``baselines.run``), the RouterBench scorecard
(``routerbench.run_algorithm``) and GreenCache's workload and drive
(``cache.make_workload``, ``cache.drive``).  It mirrors the JAX package's
``benchmarks/common.py``, ``bench_baselines.py``, ``bench_routerbench.py``
and ``bench_cache.py``, whose modules import the JAX package and so
cannot serve the port."""
